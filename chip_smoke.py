#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kpgnn_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run loudly:
  1. build  — compile every CUDA kernel of the main path from this
     checkout's sources (csrc/, nvcc for sm_90a); print the card, its power
     limit, each source's build hash and the build seconds.  Then the
     native prep: build ``prep/_native/khop_native.cpp`` with g++ (fails
     if it does not build), print its source hash and build seconds, and
     prep the flagship fixture's train split through ``common.prepare``
     twice (the second call must be a cache hit returning equal graphs)
     and once on the numpy path (equal graphs), with the three times;
  2. check  — hold each kernel variant against its plain PyTorch version on
     the card, forward and autograd backward.  The gather: flagship plans
     (64 ZINC-shaped molecules, K=8, D=104, every hop prefix k=1..8) and
     edge cases (empty rows with null senders, a 10k-edge hub row, a
     rectangular table at D=64, D=13, bf16 input, an x whose data_ptr is
     not 16-byte aligned).  The fused gather + edge-embedding term at every
     hop prefix k=1..8, with autograd grads of x and both tables, and at
     k=8 in bf16, misaligned and D=13.  Together these take the 16-byte and
     the scalar variant in each direction.  Then three repeated launches of
     every variant on one input must be bit-identical (the gather over the
     backward CSR, the fused form over the forward one, as the main path
     runs them).  Then the CARD_TESTS files in a pytest process of their
     own (``kernel_tests``: the JAX package's heavy-row, hub,
     multi-window and graph-sorted cases, gather and fused, f32 and bf16,
     forward and backward, against the plain version and bit for bit on
     a repeat; ``segment_sum``'s sums, the same in every run and the
     CPU's where they are exact; and the BiLSTM kernel against its plain
     version at every (T, H) its source lists): exit 0 with more than 0
     passed.  Then [lstm] (``lstm_phase``): the BiLSTM recurrence kernel
     (csrc/bilstm.cu, built in phase 1 beside the gather) at the main
     path's shapes (the flagship's, QM9's and KPGINPrime K=16's attention
     combine and the flagship with JK attention), f32 and bf16, forward
     and backward against the plain version and float64, a repeat bit
     for bit, an unsupported hidden size raising, and its times beside
     its byte bound (the bytes the function needs; the saved activations
     apart, with the eval forward's time that saves none), the plain
     version's and cuDNN's (``torch._VF.lstm``, the one call of cuDNN's
     LSTM left, held against the kernel plus the matmuls it leaves to
     ``torch.matmul``);
  3. train  — write a ZINC-format fixture (tools/make_zinc_fixture.py) and
     run ``kpgnn_tpu_torch.scripts.train_zinc.main`` at the flagship's
     full width (KPGINPlus K=8 L=8 H=104, attention combine, JK concat,
     residual, --backend pallas) for one epoch; require finite losses,
     exactly 2*L kernel launches per train step (L fused forward, L
     gather backward) plus L per eval step, and a first-step loss equal to
     the same step on the CPU and to the same step on --backend coo on the
     card.  Then ``--bf16`` on the same run: finite losses, exactly 2*L
     launches per train step and L per eval step, all on the kernel's
     bf16 16-byte variants, a first-step loss within rtol BF16_RTOL of
     the same bf16 step on the CPU and on --backend coo --bf16 on the
     card and within 5e-2 of the f32 run's, and f32 parameters and norm
     statistics after it; in one bf16 train step every linear map and
     LSTM of the K-hop layers returns bf16, the BiLSTM kernel's bf16
     variants launch once a BiLSTM forward and backward, and its profile
     shows them, no cuDNN RNN kernel, and a bf16 GEMM.  Every script run
     launches the BiLSTM kernel (csrc/bilstm.cu) once a BiLSTM forward
     and once a backward.  Before ``--bf16``,
     [api] (``api_phase``): the flagship at full width through the
     package's top-level names only (kt.KHopConfig / kt.extract_khop ->
     kt.GraphLoader(mode="pallas") -> kt.make_model(kt.ModelConfig) ->
     kt.Trainer) for one epoch on the run's first 128 molecules: prep
     equal to the script's, ``kt.train.count_parameters`` the JAX count
     (FLAGSHIP_PARAMS), 2L fused + 2L gather launches, the first-step loss
     the run's (rtol 1e-4), and the step on the card's clock; and
     [determinism] (``determinism_phase``): DET_STEPS steps twice from
     one seed under default algorithms must repeat bit for bit, one line
     a backend: the flagship on pallas and on coo, banded on the polymer
     batch with halo 0 (its spill non-empty) and KPGCN on the CSL kernel
     plan (its weighted histograms); the last three must launch the
     sorted segment sum (every edge -> node float sum on the card: the
     gather kernel with identity senders, ``ops/segment.py``).  Then the
     pallas steps twice in a process under
     ``torch.use_deterministic_algorithms(True, warn_only=True)`` with
     CUBLAS_WORKSPACE_CONFIG=:4096:8, reported: the first differing step,
     the largest loss and parameter differences, and the ops that warn of
     no deterministic implementation.  Then [op_gap] (``op_gap_phase``,
     reports, gates nothing): the flagship's first batch on the kernel
     plan and one set of weights on the card and on the CPU, every
     module's output (``utils/parity.capture_activations``, an eval and a
     train forward) as max |card - CPU| over its scale, one line a module
     in the order they return, beside the CPU's own gap between the COO
     backend and the kernel plan; it names the first module, and the
     first parameter's gradient in the order the backward finishes
     them, whose card gap exceeds OP_GAP_FACTOR times that backend gap;
     then each attention combine's steps (BiLSTM, logits, softmax,
     weighted sum) against float64, each from a float64 input and
     chained, with the BiLSTM also as a plain f32 cell.  Then [prefetch]
     (``prefetch_phase``): the flagship's per-batch ``Trainer.fit``
     on its plain ``b.to(device)`` train stream and with that stream
     through ``train/loop.device_prefetch``, in turns: step losses bit
     for bit equal, host ms a step of each.  Then resident epochs,
     one epoch each under default algorithms: ``--backend coo``
     (``--resident auto``: the log shows the rule's decision, which must be
     ``resident_rule``'s), ``--resident off`` and ``--resident on``;
     ``--dense`` (auto, resident) and ``--dense --resident off`` twice.
     The resident run's step losses equal the per-batch run's within rtol
     1e-4 over every step where the batches are the same (dense) and the
     per-batch run repeats itself bit for bit, else over the first step;
     COO's slot layout sums its graph-level sums in another order, so its
     first batch gathered from the store is held against the collated one
     by loss and every
     graph's prediction (rtol 1e-5) and by every gradient under the
     gradient gate (below), the collated steps replaying the gathered
     step's ReLU branches on the real nodes; the COO control (4 steps
     from weights moved by an ulp against unmoved); each epoch's seconds,
     and one step's time, launches and idle share resident against per
     batch on each store, and on coo per batch the device ms of the
     sorted sums;
  4. csl    — run ``kpgnn_tpu_torch.scripts.train_csl.main`` at the
     reference width (KPGIN on GNN, K=4 L=4 H=48, batch 64, --backend
     pallas, fold 0 of the 10-fold split, 2 epochs): finite losses,
     exactly 2*L launches per train step and L per eval step, and a
     first-step loss equal to the CPU's and to --backend coo's on the
     card.  The kernel is also checked at the CSL shapes (D=12 over the
     k=4 plan, D=48 over its hop-1 slice, the GINE layers');
  5. families — one AdamW step of KPGCN, KPGraphSAGE (mean) and
     KPGINPrime (one K-hop layer, then GINE) at CSL width on a CSL batch,
     through the kernel: loss and every parameter gradient against the
     same step on the CPU, and each family's launches per variant (KPGCN:
     the plain gather after its sender pre-scale, L forward + L backward;
     the others L fused forward + L gather backward);
  6. qm9    — write a qm9_v3.pt-format fixture (tools/make_qm9_fixture.py,
     640 molecules, seed 7) and run ``kpgnn_tpu_torch.scripts.train_qm9
     .main`` at the canonical width (KPGINPlus K=8 L=8 H=128, batch 128,
     attention combine and pooling, --virtual_node --use_rd, task 0,
     --backend pallas, 2 epochs): finite losses, exactly 2*L launches per
     train step and L per eval step, and a first-step loss equal to the
     CPU's, to --backend coo's on the card and to --backend dense's on the
     card; then one Adam step of the same config against the CPU under
     the gradient gate (below).  The kernel is checked at its QM9 shapes
     (D=128 over the k=8 plan; D=8 over the k=16 plan and D=128 over its
     hop-1 slice, the sweep's KPGINPrime K=16 L=16);
  7. dense  — ``train_qm9.main --dense`` on the card for the same 2 epochs:
     finite losses, no kernel launch, and the pallas run's first-step
     loss; then one Adam step of the sweep's second config (KPGINPrime
     K=16 L=16 --residual --use_rd, the one main path whose K-hop layer
     launches at the kernel's 16 hops) against the CPU under the
     gradient gate, with its launches per width;
  8. generated — run each generated-data script's ``main`` at its
     canonical width for 2 epochs on --backend pallas: ``train_counting``
     (KPGINPlus K=3 L=3 H=96, batch 64, 1000 graphs, task 0),
     ``train_node_property`` (KPGINPlus K=6 L=6 H=128, batch 128, node
     regression head, --data_scale 0.1, task 0), ``train_graph_property``
     (K=6 L=6 H=96, batch 128, --data_scale 0.1, task 1) and ``train_tu``
     (KPGIN on GNN, K=2 L=3 H=32, batch 32, fold 0 of a generated
     MUTAG-scale GIN-format fixture, ``write_gin_fixture``; dropout 0,
     since the CPU's and the card's generators draw different masks):
     finite losses, exactly 2*L launches per train step and L per eval
     step, and a first-step loss equal to the CPU's, to --backend coo's
     and to --backend dense's on the card; then one Adam step of the
     node-property config against the CPU under the gradient gate (the
     node head and the node-level loss).  The kernel is checked at their
     shapes (K=3 D=96, K=6 D=128, K=6 D=96, K=2 D=16, each over its
     first batch's plan) in phase 2.  TU's fold with --dense takes the
     resident path and is gated against the same fold with --resident
     off as the flagship's dense runs are;
  9. time   — on the flagship k=8 plan (CUDA events, after warm-up,
     rotating distinct inputs), each beside the least time the card could
     take: every kernel variant on the CSR where the main path launches it
     (the gather over the backward CSR, the fused form over the forward
     one), its plain version and, for the gather, one ``torch.sparse.mm``
     call; the gather over the forward CSR likewise; the unfused
     composition the fused forward replaces (kernel + k ``counts @ table``
     GEMMs + stack + add); and the flagship train step, with its device
     time by kernel from torch.profiler.  Then the same kernel times at
     the CSL shapes, KPGCN's whole aggregation (sender pre-scale, gather,
     weighted histograms, K GEMMs, receiver scale) at D=12, the host's
     collate time per CSL batch, and the CSL train step with its profile;
     the kernel times at the QM9 shapes, and the QM9 train step on pallas
     and on dense, each with its profile (the pallas step must spend
     under 1 ms in ``indexing_backward_kernel``: the virtual node's
     broadcast no longer serialises); the kernel times at the four
     generated-data shapes, and the node-property train step with its
     profile; and the kernel times at the expressiveness and large shapes.
 10. expressiveness, checkpoints and profiling — run between 8 and 9:
     [exp] ``train_exp`` at its defaults' width (KPGIN K=3 L=3 H=48, batch
     128) on a 1,200-graph EXP pickle the smoke writes
     (``write_exp_fixture``), --folds 2 --num_epochs 2, and on the same
     graphs in CEXP's text format for one epoch, through
     ``script_phase``; [sr25] ``train_sr`` (K=4 L=4 H=48, batch 15, 3
     epochs) on 15 SRG(25,12,5,6) graphs in graph6
     (``write_sr25_fixture``, the smoke's own encoder; hops 3-4 carry no
     edge): launches and first step as above, its first evaluation
     (batch-statistics norms) against the same weights evaluated on the
     CPU and on a fresh card model (rtol 1e-4, the same accuracy, running
     statistics unchanged), one step under the gradient gate;
     [sim] ``run_simulation`` at its defaults (forward only: L fused
     launches a forward, no gather) against the same run on the CPU (the
     1e-8 collision threshold is below f32 rounding: a pair that collides
     on one device only must be equal within 1e-5 of the largest |value|
     on both), and --sweep --graphs 2 (its JSON table; one fused launch a
     forward at each K's width, D=21 on the scalar variant); [search]
     ``run_search --preset sr_search --limit 1``; [ckpt] the flagship
     with --save_checkpoints for 2 epochs: best.pt equal to its epoch's
     model, restored on the card, on the CPU and card -> CPU -> card bit
     for bit (Adam's step counts on the CPU, the moments beside their
     parameters), then a --load_path warm start whose first step equals
     the CPU's warm start (rtol 1e-4); [profile] the flagship with
     --profile_dir for 2 epochs: ``trace_summary`` finds the trace of
     epoch 1, whose device events name the fused and the gather variant
     as often as the launch counter counted them in that epoch, then
     ``profile_step.main(["--stages", "resident,bf16,large"])`` exits 0
     (its stage times and top device ops logged).  Phase 2 checks the
     kernel at these shapes: EXP D=16 over the k=3 plan, SR25 D=12 over
     the k=4 plan, the simulation's D=32 and the sweep's D=64/32/21/16,
     and profile_step's large plan (D=34, scalar, 16,384 nodes; f32 sums
     under the hub row's tolerance).
 11. banded and device prep — run after 10: [banded] the flagship through
     the banded plan (``--backend banded``: per batch, resident auto, and
     ``--bf16``, one epoch each): no kernel launch, first steps equal to
     the CPU's on banded, to coo's and to the pallas run's (rtol 1e-4;
     bf16 within BF16_RTOL of the CPU's bf16 banded step and of the
     pallas --bf16 run's), one Adam step of the first batch against the
     same step on pallas and on coo on the card under the gradient gate
     (``card_gate``) and each of the three against the CPU under the
     gradient gate, the logged resident decision and store bytes
     against ``resident_rule`` and ``banded_store_nbytes``, the first
     batch gathered from the BandedStore against the collated one (loss
     and predictions, rtol 1e-5), the bf16 window product a GEMM kernel
     of its own; KPGCN at CSL width on its gcn_norm plan under the
     gradient gate against the CPU and equal to its pallas step, a plain
     plan refused; halo-0 plans of the flagship and polymer batches
     (every cross-tile edge spills, unpadded and padded) against coo on
     the card, forward and x / table gradients, at every hop prefix;
     ``profile_step.main(["--stages", "large,banded"])`` and
     ``tune_banded.main(["--tiles", "128,256,512"])`` exit 0;
     [device_prep] ``device_khop_dense`` on 64 flagship molecules, spd
     and gd, equal to the host prep's ``collate_dense`` exactly.  The
     time section then times the banded aggregation at the flagship
     (per batch and from the store) and polymer shapes beside the kernel
     path and the bound, eager and from a CUDA graph, with the step's
     launches against pallas and coo, and prints a ``[banded]`` JSON
     line.
 12. multi-rank training — run after 11: P ranks spawned on the one
     card over gloo (NCCL takes one rank a card; gloo stages every
     collective through the host, so no time of these legs stands for
     NCCL's), each computing on cuda:0 (``_parallel_rank``).  [dp] the
     flagship at full width, P=2, 64 molecules a rank, three steps on the
     trainer's first six batches: the first step's loss sum equal to the
     sum of the one-device card steps on each rank's batch within
     1e-6 * max(1, |sum|) (the JAX dryrun's bound), its all-reduced
     gradients against the count-weighted sum of the one-device
     gradients under the gradient gate (the one-device steps replay
     each rank's ReLU branches, ``relu_branches``), L fused + L gather
     launches a rank; then a data-parallel resident epoch over a dense
     store of the train split (the first step held the same way, on its
     mean loss); every rank's parameters bit for bit rank 0's after each
     leg.  [node] the flagship's first 64 molecules at P=2 on the kernel
     plan (n_pad tight, so both halves hold real nodes; GNNPlus slices
     the rectangular plan to its hop windows), and profile_step's large
     polymers (KPGIN K=3 L=3 H=102, two 8,192-node graphs, n_pad a
     multiple of P*256) at P=2 and P=4 on the kernel plan and on banded:
     the loss sum within 1e-5 * max(1, |loss|) of the unpartitioned
     one-device card step, the gradients under the gate (the reference
     replays the ranks' ReLU branches, concatenated along the node
     axis), 2L launches a rank on the kernel plans (none on banded), and
     the halo B, boundary_total, comm bytes a layer against the
     full-table psum's and the step ms.  [dcn] four ranks as a 2 x 2
     (dcn, data) mesh with ``host_shard_loader``: the first group's loss
     sum within 1e-6 of the one-device sums.  [parallel scripts]
     ``train_zinc --parallel data`` and ``--parallel node --backend
     pallas`` for one epoch on a one-rank NCCL group in this process,
     through ``script_phase``, first steps equal to the run without
     --parallel (rtol 1e-4).  Phase 2 holds the kernel against its plain
     version on each node leg's rank-0 rectangular plan (forward
     K*n_local rows over K*n_ext sender rows, backward the transpose,
     whose rows_per_hop is n_ext; gather and fused, and the flagship
     shard's first hop window), and the time section times them.
 13. tools — run after 12: [tools] ``tune_pallas.main`` at its defaults
     (K=8 D=104, 64 synthetic molecules) and at TU's width (--K 2
     --hidden_size 16): a JSON row per point (the gather and the fused
     form on the one batch) with positive rates, and the best;
     ``scaling_estimate.main(["--mode", "both", "--ranks", "1,2,4"])``
     (the JAX script's 1,2,4,8 cut for the smoke's time): every weak row
     names its backend (NCCL at P=1, gloo ranks sharing cuda:0 above) and
     the card, and the link projection's halo, boundary, union-edge, comm
     and psum numbers equal a direct ``partition_adj`` of the same
     65,536-node polymer; ``make_parity_golden --all`` on the card (under
     default algorithms: the bundles aggregate on COO, whose sums add in
     one order) and on the CPU: each card bundle
     replays on the card within 1e-6, holds the
     CPU bundle's parameters bit for bit and its activations within atol
     1e-5 / rtol 1e-4.  The launch counts, set to 0 before each script
     and read after it, must show the gather and the fused form at each
     tune_pallas width and in the ici mode at D=104.  Phase 2 holds the
     kernel against its plain version on those three plans, and the time
     section times them.
The last lines are the card's name and power limit, a ``kernels`` JSON
line, and ``{"ok": true, "device": {...}}``.  The ``kernels`` line has one
entry per kernel variant, timed on the flagship plan, with the launches
of every run at every width; then one entry per variant and main-path
shape (the flagship's D=104, CSL's D=12 over the k=4 plan, GINE's D=48
over its hop-1 slice, QM9's D=128 over the k=8 plan, KPGINPrime-QM9's D=8
over the k=16 plan and D=128 over its hop-1 slice, counting's D=96 over
the k=3 plan, node property's D=128 and graph property's D=96 over
their k=6 plans, TU's D=16 over the k=2 plan, EXP's D=16, SR25's D=12,
the simulation's fused forward at D=32 and at each sweep width, and
profile_step's large plan at D=34), each with the launches of the run
that takes that shape, its error, times and bound; the node legs'
rectangular plans (the flagship shard at D=104, the polymer shards at
P=2 and P=4 at D=34) with the launches of their kernel-plan legs summed
over the ranks; and the bf16 variants on the flagship plan with the
--bf16 run's launches; the same for the [api] run's launches; then the
fused form and the gather (both over the forward CSR) on each plan of
[tools], with the launches of the script that takes it (tune_pallas at
D=104 and D=16, scaling_estimate's ici mode at D=104), counted apart
from every other entry; then the same kernel as the sorted segment sum
(``sorted_segment_sum[...]``, identity senders, its launches counted
apart in ``segment.sorted_segment_sum``) at each (variant, width) of
each [determinism] leg's first batch (coo at D = k*104 for the hop
windows k = 1..8, the polymer spill at D=34, KPGCN's histograms at
D=1) and of the [bf16] COO first step (the bf16 variant at those
widths), with the launches of one run of that leg, its error against
the plain version on the CPU copy of inputs of the variant's dtype,
a bound of its own (rows, indptr and sums, no sender bytes) and, as
the library call, the ``index_add_`` the path ran before
(``sorted_sum_times``).  The
first entries' launches also count the multi-rank legs and the
--parallel runs.

Tolerances: f32 gather vs plain version atol 1e-5, except the hub row,
whose 10k-term sums may differ in summation order by up to 1e-6 of the
row's sum of |x| (plus 1e-5); the fused forward likewise 1e-5 plus 1e-6
of its sum of |terms| (the kernel adds x and table rows edge by edge,
the plain version per edge pair); the table gradients, sums over the n
rows of the counts (a matmul against an atomic scatter in varying
order), 1e-5 plus 2*sqrt(n)*2**-24 of their sum of |terms|, the
probabilistic bound of f32 summation error; bf16 input vs the plain
version on the same bf16 values, both summed in f32, rtol 1e-3 (its
backward gathers the gradient in bf16, as the --bf16 path does); first
train-step loss GPU vs CPU, and kernel vs COO backend on the card, rtol
1e-4 (the backends sum in other orders: the kernel plan's fused hops
against the COO messages' sorted sum);
gradient gate (the family steps, the QM9 step, KPGINPrime K=16 L=16,
the node-property step),
one step on the card against the same step on the CPU: the loss rtol
1e-4; every parameter gradient, against the CPU step that takes the
card's ReLU branches, rtol 1e-4 and an atol of 1e-4 of that parameter's
largest gradient, plus 8 times its f32 rounding, measured as how far its
CPU gradient moves when every weight moves by an ulp (w * (1 +- 2**-23)),
plus 1e-7 of the model's largest gradient.  A gradient that is 0 in
exact arithmetic (a bias ahead of a batch norm) is all rounding, and a
sum that cancels (a scalar gate) carries more than 1e-4 of itself; the
measured term admits both without widening any other parameter's bound.
ReLU is the gated models' one branch point.  An input the card computes
within its rounding of 0 can land on the other side (in the two QM9
steps 10 or 11 of 9-17M inputs, within ~6e-5 of 0; PERF.md §6), and
every gradient below it then differs by far more than rounding; so the
card's ReLU inputs are recorded and the CPU steps (the ulp-moved one
too) replay their branches (``relu_branches``), and every input whose
branch differs must lie within 1e-4 of its call's largest |input| of 0.
"""
import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
K, L, H, BATCH = 8, 8, 104, 64
N_TRAIN, N_VAL, N_TEST = 1024, 128, 128
SEED = 234
CSL_K, CSL_L, CSL_H, CSL_BATCH, CSL_EPOCHS = 4, 4, 48, 64, 2
QM9_K, QM9_L, QM9_H, QM9_BATCH, QM9_EPOCHS = 8, 8, 128, 128, 2
QM9_MOLECULES, QM9_FIXTURE_SEED = 640, 7
PRIME_K = PRIME_L = 16          # the QM9 sweep's KPGINPrime config
GEN_EPOCHS = 2
# the generated-data scripts at their canonical widths (their defaults):
# label -> (script, data-size arguments, loss, node-level target).  TU
# trains without dropout here: the CPU's and the card's generators draw
# different masks, and the first step is compared across devices
GENERATED = {
    "counting": ("train_counting", ("--n_graphs", "1000", "--task", "0"),
                 "l1", False),
    "nprop": ("train_node_property", ("--data_scale", "0.1", "--task", "0"),
              "mse", True),
    "gprop": ("train_graph_property", ("--data_scale", "0.1", "--task",
                                       "1"), "mse", False),
    "tu": ("train_tu", ("--folds", "1", "--drop_prob", "0"),
           "cross_entropy", False),
}
# first-step loss, --bf16 on the card against the same bf16 step on the
# CPU and on --backend coo on the card: bf16 keeps 8 mantissa bits and
# each side rounds after its own summation order
BF16_RTOL = 1e-2
# the flagship's parameter count: the JAX package's count_parameters of
# its flax tree (tests/test_torch_api.py holds the port's equal to it)
FLAGSHIP_PARAMS = 529675
DET_STEPS = 5                  # [determinism]: the flagship's first steps
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # H100 SXM data sheet, f32 outside the MMA
KERNEL = dict(route="cuda",
              source="kpgnn_tpu_torch/csrc/gather_segment_sum.cu",
              replaces="kpgnn_tpu/ops/pallas_spmm.py:159")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def card_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def write_fixture(root):
    """ZINC-format raw bundle from tools/make_zinc_fixture.py's molecule
    generator (numpy + torch), at N_TRAIN/N_VAL/N_TEST molecules."""
    path = os.path.join(ROOT, "tools", "make_zinc_fixture.py")
    spec = importlib.util.spec_from_file_location("make_zinc_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    import numpy as np
    rng = np.random.default_rng(11)
    raw = os.path.join(root, "ZINC", "raw")
    os.makedirs(raw, exist_ok=True)
    for split, n in (("train", N_TRAIN), ("val", N_VAL), ("test", N_TEST)):
        with open(os.path.join(raw, f"{split}.pickle"), "wb") as f:
            pickle.dump([mod.make_mol(rng) for _ in range(n)], f)
        with open(os.path.join(raw, f"{split}.index"), "w") as f:
            f.write(",".join(str(i) for i in range(n)) + ",")


def run_tool(name, *argv):
    """Runs tools/<name>.py's main() in this process with ``argv`` as its
    command line."""
    path = os.path.join(ROOT, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = sys.argv
    sys.argv = [path, *map(str, argv)]
    try:
        mod.main()
    finally:
        sys.argv = saved


def write_gin_fixture(root, name="MUTAG", n_graphs=188, seed=5):
    """A GIN-format TU dataset at MUTAG's scale under <root>/<name>: 188
    graphs (class 1 a third of them) of 10..28 nodes, a random tree plus
    one extra edge (four for class 1), 7 node tags; and 10-fold index
    files stratified by class (folds split by index modulo 10 can hold
    one class only)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    d = os.path.join(root, name)
    os.makedirs(os.path.join(d, "10fold_idx"))
    labels = (np.arange(n_graphs) % 3 == 0).astype(np.int64)
    rng.shuffle(labels)
    lines = [str(n_graphs)]
    for label in labels:
        n = int(rng.integers(10, 29))
        adj = [set() for _ in range(n)]
        edges = [(u, int(rng.integers(0, u))) for u in range(1, n)]
        edges += [tuple(map(int, rng.integers(0, n, 2)))
                  for _ in range(1 + 3 * label)]
        for u, v in edges:
            if u != v:
                adj[u].add(v)
                adj[v].add(u)
        tags = rng.integers(0, 7, n)
        lines.append(f"{n} {label}")
        lines += [f"{tags[u]} {len(adj[u])} "
                  + " ".join(map(str, sorted(adj[u]))) for u in range(n)]
    with open(os.path.join(d, f"{name}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    fold_of = np.zeros(n_graphs, np.int64)
    for c in (0, 1):
        idx = np.flatnonzero(labels == c)
        fold_of[idx] = np.arange(len(idx)) % 10
    for f in range(10):
        for split, idx in (("train", np.flatnonzero(fold_of != f)),
                           ("test", np.flatnonzero(fold_of == f))):
            with open(os.path.join(d, "10fold_idx",
                                   f"{split}_idx-{f + 1}.txt"), "w") as fh:
                fh.write("\n".join(map(str, idx)) + "\n")


def write_exp_fixture(root, n_pairs=600, seed=3, txt=False):
    """An EXP-format dataset of ``n_pairs`` consecutive pairs: a random
    3-regular graph on n nodes (label 1) and two disjoint random 3-regular
    graphs on n/2 nodes each (label 0), in random order within the pair,
    n a multiple of 4 in 32..72 (EXP's node counts), every node feature
    0.  Both graphs of a pair are 3-regular, so 1-WL gives every node one
    colour in both.  Written as <root>/EXP/raw/GRAPHSAT.pkl, a pickle of
    objects of a class whose module reads ``torch_geometric.data.data``
    (registered only while dumping), with torch tensors ``x``,
    ``edge_index`` and ``y``; or, ``txt``, as the CEXP text format
    <root>/CEXP/GRAPHSAT.txt."""
    import random
    import types

    import numpy as np
    import torch

    from kpgnn_tpu_torch.data.generation import random_regular_graph
    rng = random.Random(seed)
    graphs = []
    for _ in range(n_pairs):
        n = 4 * rng.randint(8, 18)
        one = random_regular_graph(3, n, rng)
        h = n // 2
        two = random_regular_graph(3, h, rng) + [
            (u + h, v + h) for u, v in random_regular_graph(3, h, rng)]
        pair = [(n, one, 1), (n, two, 0)]
        rng.shuffle(pair)
        graphs += pair
    if txt:
        d = os.path.join(root, "CEXP")
        os.makedirs(d, exist_ok=True)
        lines = [str(len(graphs))]
        for n, edges, label in graphs:
            adj = [[] for _ in range(n)]
            for u, v in edges:
                adj[u].append(v)
                adj[v].append(u)
            lines.append(f"{n} {label}")
            lines += [f"0 {len(a)} " + " ".join(map(str, sorted(a)))
                      for a in adj]
        with open(os.path.join(d, "GRAPHSAT.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        return graphs
    mod_names = ("torch_geometric", "torch_geometric.data",
                 "torch_geometric.data.data")
    check(not any(m in sys.modules for m in mod_names),
          "a torch_geometric module is already imported")
    Data = type("Data", (), {"__module__": "torch_geometric.data.data"})
    for m in mod_names:
        sys.modules[m] = types.ModuleType(m)
    sys.modules["torch_geometric.data.data"].Data = Data
    try:
        objs = []
        for n, edges, label in graphs:
            d = Data()
            both = edges + [(v, u) for u, v in edges]
            d.edge_index = torch.tensor(np.array(sorted(both)).T,
                                        dtype=torch.long)
            d.x = torch.zeros(n, 1, dtype=torch.long)
            d.y = torch.tensor([label], dtype=torch.long)
            objs.append(d)
        d = os.path.join(root, "EXP", "raw")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "GRAPHSAT.pkl"), "wb") as f:
            pickle.dump(objs, f)
    finally:
        for m in mod_names:
            del sys.modules[m]
    return graphs


def to_graph6(n, edges, header=False):
    """One graph as a graph6 line: N(n) (n <= 62 here), then the upper
    triangle column by column, 6 bits a byte, each byte + 63."""
    check(n <= 62, f"to_graph6: n={n} > 62")
    adj = {(min(u, v), max(u, v)) for u, v in edges}
    bits = [int((i, j) in adj) for j in range(1, n) for i in range(j)]
    bits += [0] * (-len(bits) % 6)
    body = bytes(63 + int("".join(map(str, bits[k:k + 6])), 2)
                 for k in range(0, len(bits), 6))
    return (b">>graph6<<" if header else b"") + bytes([63 + n]) + body + b"\n"


def srg_parameters(n, edges):
    """(v, k, lambda, mu) of a strongly regular graph, or None."""
    import numpy as np
    a = np.zeros((n, n), np.int64)
    for u, v in edges:
        a[u, v] = a[v, u] = 1
    deg = a.sum(1)
    common = a @ a
    off = ~np.eye(n, dtype=bool)
    lam = {int(x) for x in common[(a == 1) & off]}
    mu = {int(x) for x in common[(a == 0) & off]}
    if len(set(deg.tolist())) != 1 or len(lam) != 1 or len(mu) != 1:
        return None
    return n, int(deg[0]), lam.pop(), mu.pop()


def sr25_graphs(seed=7):
    """15 strongly regular (25,12,5,6) graphs: the Paley graph on GF(25)
    (GF(5)[t] / (t^2 - 2)), the Latin-square graphs of the cyclic order-5
    Latin square and of one outside its main class, and the complements of
    those two (three isomorphism classes among the five: the Paley graph,
    the cyclic square's graph and its complement are one); then relabelled
    copies of these five (random node permutations) to make up 15.
    Returns [(25, edges)]."""
    import itertools
    import random
    rng = random.Random(seed)
    elems = list(itertools.product(range(5), repeat=2))      # a + b t

    def mul(x, y):
        a, b = x
        c, d = y
        return ((a * c + 2 * b * d) % 5, (a * d + b * c) % 5)
    squares = {mul(x, x) for x in elems if x != (0, 0)}
    paley = [(i, j) for i, j in itertools.combinations(range(25), 2)
             if ((elems[i][0] - elems[j][0]) % 5,
                 (elems[i][1] - elems[j][1]) % 5) in squares]

    def latin(square):
        cells = [(r, c) for r in range(5) for c in range(5)]
        return [(i, j) for i, j in itertools.combinations(range(25), 2)
                if cells[i][0] == cells[j][0] or cells[i][1] == cells[j][1]
                or square[cells[i][0]][cells[i][1]]
                == square[cells[j][0]][cells[j][1]]]
    cyclic = [[(r + c) % 5 for c in range(5)] for r in range(5)]
    other = [[0, 1, 2, 3, 4], [1, 0, 3, 4, 2], [2, 3, 4, 0, 1],
             [3, 4, 1, 2, 0], [4, 2, 0, 1, 3]]

    def complement(edges):
        e = set(edges)
        return [p for p in itertools.combinations(range(25), 2) if p not in e]
    base = [paley, latin(cyclic), latin(other), complement(latin(cyclic)),
            complement(latin(other))]
    out = [(25, e) for e in base]
    while len(out) < 15:
        perm = list(range(25))
        rng.shuffle(perm)
        e = base[len(out) % len(base)]
        out.append((25, sorted(tuple(sorted((perm[u], perm[v])))
                               for u, v in e)))
    return out


def write_sr25_fixture(root):
    """``sr25_graphs`` as <root>/sr25/raw/sr251256.g6 (graph6 with the
    header); returns the graphs."""
    graphs = sr25_graphs()
    d = os.path.join(root, "sr25", "raw")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "sr251256.g6"), "wb") as f:
        for i, (n, edges) in enumerate(graphs):
            f.write(to_graph6(n, edges, header=i == 0))
    return graphs


def qm9_argv(dataset_dir, save_dir, device, backend, extra=()):
    """train_qm9 at the canonical width; ``extra`` picks the sweep's
    config (its first: --virtual_node --use_rd)."""
    return ["--dataset_dir", dataset_dir, "--save_dir", save_dir,
            "--device", device, "--backend", backend, "--K", str(QM9_K),
            "--num_layer", str(QM9_L), "--hidden_size", str(QM9_H),
            "--batch_size", str(QM9_BATCH), "--num_epochs", str(QM9_EPOCHS),
            "--task", "0", "--seed", str(SEED), *extra]


def generated_argv(label, work, device, backend):
    """The GENERATED script ``label`` for GEN_EPOCHS epochs, one run."""
    return ["--save_dir", os.path.join(work, label), "--device", device,
            "--backend", backend, "--dataset_dir", work, "--num_epochs",
            str(GEN_EPOCHS), "--runs", "1", "--seed", str(SEED),
            *GENERATED[label][1]]


QM9_VN_RD = ("--virtual_node", "--use_rd")
QM9_PRIME = ("--model_name", "KPGINPrime", "--K", str(PRIME_K),
             "--num_layer", str(PRIME_L), "--residual", "--use_rd")


def train_argv(dataset_dir, save_dir, device):
    return ["--dataset_dir", dataset_dir, "--save_dir", save_dir,
            "--device", device, "--backend", "pallas", "--model_name",
            "KPGINPlus", "--K", str(K), "--num_layer", str(L),
            "--hidden_size", str(H), "--JK", "concat", "--residual",
            "--combine", "attention", "--batch_size", str(BATCH),
            "--num_epochs", "1", "--runs", "1", "--seed", str(SEED)]


def csl_argv(save_dir, device, backend, model_name="KPGIN", extra=()):
    return ["--save_dir", save_dir, "--device", device, "--backend", backend,
            "--model_name", model_name, "--K", str(CSL_K), "--num_layer",
            str(CSL_L), "--hidden_size", str(CSL_H), "--batch_size",
            str(CSL_BATCH), "--num_epochs", str(CSL_EPOCHS), "--folds", "1",
            "--seed", str(SEED), *extra]


def first_batches(loader, n):
    """The first ``n`` batches a (shuffled) loader yields, leaving its
    shuffle where it was: every call gives the batches the loader's next
    epoch starts with."""
    state = loader.rng.bit_generator.state
    it = iter(loader)
    batches = [next(it) for _ in range(n)]
    it.close()
    loader.rng.bit_generator.state = state
    return batches


def first_batch(loader):
    """The first batch of ``first_batches``."""
    return first_batches(loader, 1)[0]


def same_graphs(a, b):
    """Whether two lists of prepped graphs hold equal fields (arrays of
    equal dtype and values)."""
    import dataclasses
    import numpy as np
    if len(a) != len(b):
        return False
    for ga, gb in zip(a, b):
        for f in dataclasses.fields(ga):
            x, y = getattr(ga, f.name), getattr(gb, f.name)
            if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                if not (isinstance(x, np.ndarray) and isinstance(y, np.ndarray)
                        and x.dtype == y.dtype and np.array_equal(x, y)):
                    return False
            elif x != y:
                return False
    return True


def run_log(save_base):
    """The log of the newest run under ``save_base`` (a script's
    ``--save_dir``; each run logs to <save_base>/train/<name>-NN/)."""
    import glob
    logs = glob.glob(os.path.join(save_base, "train", "*", "log.txt"))
    check(bool(logs), f"no run log under {save_base}")
    with open(max(logs, key=os.path.getmtime)) as f:
        return f.read()


def kernel_bound_ms(csr, D, x_bytes, fused=False):
    """Least time for one launch on this CSR's data: the rows of x that
    some edge gathers read once, indptr and senders read once (and, fused,
    the codes and the table rows some edge reads), the f32 output written
    once, over the HBM rate; the adds (one per gathered element, two
    fused) over the f32 rate.  Returns (ms, by)."""
    import torch
    n_rows, n_edges = csr.n_rows, csr.senders.shape[0]
    s = csr.senders
    n_read = int(torch.unique(s[(s >= 0) & (s < csr.n_cols)]).numel())
    nbytes = n_read * D * x_bytes + (n_rows + 1) * 4 + n_edges * 4 \
        + n_rows * D * 4
    adds = n_edges * D
    if fused:
        rows = torch.repeat_interleave(
            torch.arange(n_rows, device=s.device),
            (csr.indptr[1:] - csr.indptr[:-1]).long(), output_size=n_edges)
        c = csr.codes.long()
        hop_k = (rows >= csr.rows_per_hop).long()
        n_tab = int(torch.unique((c * 2 + hop_k)[c > 0]).numel())
        nbytes += n_edges * 4 + n_tab * D * 4
        adds *= 2
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = adds / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sorted_sum_bound_ms(n, rows, D, x_bytes):
    """Least time for one sorted segment sum of ``rows`` rows of width D
    into n segments: the rows read once, the (n + 1) int32 indptr read
    once and the f32 (n, D) sums written once, over the HBM rate; one
    add per element over the f32 rate.  No sender bytes: a sorted sum
    reads its rows in order (the kernel's identity senders are a detail
    of its reuse).  Returns (ms, by)."""
    t_bytes = (rows * D * x_bytes + (n + 1) * 4 + n * D * 4) \
        / HBM_BYTES_PER_S
    t_ops = rows * D / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def misalign(t):
    """A contiguous copy of t whose data_ptr is one element past a 16-byte
    boundary (the kernel's scalar variant)."""
    import torch
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def launched(spmm, fn):
    """fn()'s result and the kernel variants it launched, with counts."""
    before = Counter(spmm.gather_segment_sum.variant_launches)
    out = fn()
    after = Counter(spmm.gather_segment_sum.variant_launches)
    after.subtract(before)
    return out, {k: v for k, v in after.items() if v}


@contextlib.contextmanager
def relu_branches(torch, inputs, replay, layouts=None):
    """Within the block, every ``F.relu`` call of the model records its
    input on the host into ``inputs`` (``replay`` False), or (``replay``
    True) takes the branch that the input of the same call in ``inputs``
    took: relu(x) becomes where(inputs[i] > 0, x, 0), gradient included.
    ReLU is the one branch point of the gated models.  ``layouts`` (the
    recorded run's node mask, this run's node mask) replays a run that
    lays the same real nodes out in other rows, in the same order: each
    call's real rows take the recorded branches, its padded rows keep
    their own.  Yields, per call replayed, (inputs whose own sign differs
    from the recorded one, largest |x| or recorded |x| among them,
    largest |x| of the call)."""
    F = torch.nn.functional
    relu = F.relu
    flips = []
    if layouts is not None:
        src, dst = (torch.nonzero(m)[:, 0] for m in layouts)
        check(len(src) == len(dst), f"the layouts hold {len(src)} and "
              f"{len(dst)} real nodes")

    def recording(x, inplace=False):
        inputs.append(x.detach().float().cpu())
        return relu(x, inplace)

    def replaying(x, inplace=False):
        i = len(flips)
        xd = x.detach().float()
        rec = inputs[i] if i < len(inputs) else None
        if layouts is None:
            check(rec is not None and rec.shape == x.shape,
                  f"ReLU call {i} {tuple(x.shape)} is not the recorded step's")
            ref = rec.to(x.device)
        else:
            check(rec is not None and rec.shape[1:] == x.shape[1:]
                  and rec.shape[0] == len(layouts[0])
                  and x.shape[0] == len(layouts[1]),
                  f"ReLU call {i} {tuple(x.shape)} is not a node-level call "
                  f"of the recorded step's")
            ref = xd.clone()
            ref[dst.to(x.device)] = rec[src].to(x.device)
        keep = ref > 0
        other = keep != (xd > 0)
        mag = torch.maximum(xd.abs(), ref.abs())[other]
        flips.append((int(other.sum()),
                      float(mag.max()) if mag.numel() else 0.0,
                      float(xd.abs().max())))
        return torch.where(keep, x, torch.zeros_like(x))
    F.relu = replaying if replay else recording
    try:
        yield flips
    finally:
        F.relu = relu
    check(not replay or len(flips) == len(inputs),
          f"{len(flips)} ReLU calls replayed, {len(inputs)} recorded")


def flip_text(flips, inputs):
    """(the replayed ReLU calls' flips as a log phrase, the largest
    flipped |input| over its call's largest)."""
    flip_rel = max((f[1] / max(f[2], 1e-30) for f in flips), default=0.0)
    return (f"ReLU: {sum(f[0] for f in flips)} of "
            f"{sum(t.numel() for t in inputs)} inputs in "
            f"{sum(f[0] > 0 for f in flips)} of {len(flips)} calls took "
            f"the other branch, the largest |input| among them "
            f"{max((f[1] for f in flips), default=0.0):.2e}, "
            f"{flip_rel:.2e} of its call's largest"), flip_rel


def ulp_moved(torch, model):
    """model with every weight moved by an ulp, w * (1 +- 2**-23)."""
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            sign = torch.randint(0, 2, p.shape, generator=g) * 2 - 1
            p.mul_(1.0 + sign.to(p.dtype) * 2.0 ** -23)
    return model


def grad_leaves(got, ref, base, moved, label):
    """(err / leaf scale, err / tol, name, |err|, leaf scale, ulp move) of
    each gradient of ``got`` against ``ref``'s ({name: host tensor or
    None}).  ``base`` and ``moved`` are the gated reference step's
    gradients and the same step's with every weight moved by an ulp: a
    leaf's scale is its largest |base|, its ulp move the largest change,
    and tol = 1e-4 |ref| + 1e-4 of the leaf's scale + 8x its ulp move +
    1e-7 of the model's largest gradient (the module docstring's gate)."""
    check(set(got) == set(ref), f"{label}: the steps' parameters differ")
    gscale = max(float(g.abs().max()) for g in base.values()
                 if g is not None)
    out = []
    for n, want in ref.items():
        check((got[n] is None) == (want is None),
              f"{label}: {n} has a gradient in one step only")
        if want is None:
            continue
        scale = float(base[n].abs().max())
        ulp = float((moved[n] - base[n]).abs().max())
        atol = 1e-4 * scale + 8 * ulp + 1e-7 * gscale
        err = (got[n] - want).abs()
        out.append((float(err.max()) / max(scale, 1e-30),
                    float((err / (atol + 1e-4 * want.abs())).max()),
                    n, float(err.max()), scale, ulp))
    return out


def leaf_text(t):
    """One ``grad_leaves`` entry as a log phrase."""
    return (f"{t[2]} (|err| {t[3]:.2e}, leaf max {t[4]:.2e}, "
            f"ulp-moved {t[5]:.2e}, err/tol {t[1]:.2f})")


def time_ms(torch, fn, inputs, iters=200, warmup=20):
    """Device time per call with CUDA events.  A sleep kernel queued
    ahead keeps the device busy while the host enqueues every timed call,
    so host launch overhead does not open gaps between them."""
    t0 = time.perf_counter()
    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    host_per_call = (time.perf_counter() - t0) / warmup
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # ~2 GHz: cycles for 1.5x the host's enqueue time of the timed loop
    torch.cuda._sleep(int(min(1.5 * iters * host_per_call, 2.0) * 2e9))
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_step_ms(torch, step, warmup=3, steps=10):
    """Host ms per step over ``steps`` steps that end in a synchronize,
    after ``warmup`` steps."""
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def rnn_kernels(names):
    """(the port's BiLSTM kernels, every other RNN or LSTM kernel: cuDNN's)
    among the profiler's kernel ``names``."""
    names = list(names)
    ours = [k for k in names if "bilstm_" in k]
    other = [k for k in names if k not in ours
             and ("rnn" in k.lower() or "lstm" in k.lower())]
    return ours, other


def profile_step(torch, step, step_ms, label, steps=3):
    """Device time per train step by kernel (torch.profiler), the
    device's idle share against the unprofiled step time, and the time of
    ``indexing_backward_kernel`` (the serialising backward of a gather
    into a small table, PERF.md).  Returns (device busy ms, launches,
    idle share, indexing_backward ms, kernel names, {kernel name:
    launches}, {kernel name: device ms}) per step, or None where the
    profiler recorded no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    if busy_ms == 0.0:
        log(f"[profile] {label} train step: device time not measured (the "
            "profiler recorded no kernel)")
        return None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    ib = [e for e in kernels if "indexing_backward" in e.key]
    log(f"[profile] {label} train step: indexing_backward_kernel "
        + (", ".join(f"{e.self_device_time_total / 1e3 / steps:.3f} ms/step "
                     f"(x{e.count // steps})" for e in ib) if ib else "none"))
    ours, other = rnn_kernels(e.key for e in kernels)
    log(f"[profile] {label} train step: LSTM kernels: the port's "
        f"{sorted({k[:60] for k in ours}) or 'none'}, any other RNN or LSTM "
        f"kernel (cuDNN's) {sorted({k[:60] for k in other}) or 'none'}")
    log(f"[profile] {label} train step: device busy {busy_ms:.3f} ms of "
        f"{step_ms:.2f} ms (idle share {1 - busy_ms / step_ms:.3f}), "
        f"{launches:.0f} kernel launches; top kernels by device ms/step: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / steps:.3f}"
                    f" (x{e.count // steps})" for e in top))
    return (busy_ms, launches, 1 - busy_ms / step_ms,
            sum(e.self_device_time_total for e in ib) / 1e3 / steps,
            [e.key for e in kernels],
            {e.key: e.count / steps for e in kernels},
            {e.key: e.self_device_time_total / 1e3 / steps for e in kernels})


EXP_EPOCHS, EXP_FOLDS, SR_EPOCHS = 2, 2, 3
SIM_SWEEP_GRAPHS = 2


def exp_argv(work, device, backend, name="EXP", epochs=EXP_EPOCHS):
    """train_exp at its defaults' width (KPGIN K=3 L=3 H=48, batch 128)
    on the EXP or CEXP fixture, EXP_FOLDS folds."""
    return ["--dataset_name", name, "--dataset_dir", work, "--save_dir",
            os.path.join(work, name.lower()), "--device", device,
            "--backend", backend, "--folds", str(EXP_FOLDS), "--num_epochs",
            str(epochs), "--seed", str(SEED)]


def sr_argv(work, device, backend):
    """train_sr at its defaults' width (KPGIN K=4 L=4 H=48, batch 15)."""
    return ["--dataset_dir", work, "--save_dir", os.path.join(work, "sr25"),
            "--device", device, "--backend", backend, "--num_epochs",
            str(SR_EPOCHS), "--seed", str(SEED)]


def expressiveness_slices(torch, dev, work):
    """The EXP, CEXP and SR25 runs' data (fixtures written here) and
    configs, each with its run-0 (EXP: fold-0) train split in each
    backend's loader (same seed), so each plan has its main path's
    shapes: {label: SimpleNamespace as the generated-data slices}."""
    import math
    from kpgnn_tpu_torch.scripts import common, train_exp, train_sr
    from kpgnn_tpu_torch.train.loader import GraphLoader

    write_exp_fixture(work)
    write_exp_fixture(work, txt=True)
    srgs = [srg_parameters(n, e) for n, e in write_sr25_fixture(work)]
    out = {}
    for label, name, epochs in (("exp", "EXP", EXP_EPOCHS),
                                ("cexp", "CEXP", 1)):
        argv = exp_argv(work, "cuda", "pallas", name, epochs)
        a = train_exp.parser().parse_args(argv)
        graphs = common.prepare(train_exp.load_raw(a), a, a.dataset_name)
        cfg = common.model_config(a, ("embedding", 2),
                                  "graph_classification", 2)
        folds = train_exp.splits(len(graphs), a.folds)
        sizes = {tuple(len(s) for s in f) for f in folds}
        check(len(sizes) == 1, f"{name}: folds of sizes {sizes}")
        tr, va, te = folds[0]
        B = a.batch_size
        loaders = {m: GraphLoader([graphs[i] for i in tr], B, shuffle=True,
                                  seed=SEED, **dict(common.loader_kwargs(
                                      a, cfg), mode=m))
                   for m in ("pallas", "coo")}
        out[label] = SimpleNamespace(
            main=train_exp.main, argv=argv, cfg=cfg, loss="cross_entropy",
            node_level=False, L=a.num_layer, D=a.hidden_size // a.K,
            epochs=a.folds * epochs, train_steps=math.ceil(len(tr) / B),
            val_steps=math.ceil(len(va) / B),
            test_steps=math.ceil(len(te) / B), loaders=loaders, args=a,
            graphs=len(graphs))
    argv = sr_argv(work, "cuda", "pallas")
    a = train_sr.parser().parse_args(argv)
    graphs = common.prepare(train_sr.load_raw(a), a, "sr25")
    cfg = common.model_config(a, ("embedding", 2), "graph_classification", 15)
    lk = common.loader_kwargs(a, cfg)
    loaders = {m: GraphLoader(graphs, a.batch_size, shuffle=True, seed=SEED,
                              **dict(lk, mode=m)) for m in ("pallas", "coo")}
    out["sr25"] = SimpleNamespace(
        main=train_sr.main, argv=argv, cfg=cfg, loss="cross_entropy",
        node_level=False, L=a.num_layer, D=a.hidden_size // a.K,
        epochs=SR_EPOCHS, train_steps=1, val_steps=1, test_steps=1,
        loaders=loaders, args=a, graphs=len(graphs), srgs=srgs,
        eval_loader=GraphLoader(graphs, a.batch_size, **lk))
    for sl in out.values():
        sl.batch = sl.loaders["pallas"].example()
        sl.plan = sl.batch.adj.to(dev)
    return out


def hop_k_rows(plan):
    """The hop-k table's rows of a plan (1 for a one-hop plan, which has
    no hop-k table)."""
    return 1 if plan.countsk_hm is None else plan.countsk_hm.shape[2]


def simulation_plans(dev):
    """The plans of run_simulation's first forward: the main run's (n=50,
    K=2, D=32) and, per K of the sweep, its first graph's (n=20, D =
    (64 // K * K) / K): {label: (plan, K, D)}."""
    from kpgnn_tpu_torch.prep.khop import extract_khop
    from kpgnn_tpu_torch.scripts import run_simulation as sim
    from kpgnn_tpu_torch.train.loader import GraphLoader

    args = sim.parser().parse_args(["--seed", str(SEED)])
    out = {}
    for label, n, K in [("sim", args.n, args.K)] + [
            (f"sim sweep K={k}", sim.SWEEP_NS[0], k) for k in sim.SWEEP_KS]:
        g = sim.generate_k_regular(n, args.r, 1, SEED)[0]
        graph = extract_khop(g["num_nodes"], g["edge_index"], None,
                             sim.khop_config(K), x=g["x"], y=g["y"])
        h = args.hidden_size if label == "sim" else args.hidden_size // K * K
        lk = {"mode": "pallas", "v1": 3, "vk": 12}
        plan = GraphLoader([graph], 1, **lk).example().adj.to(dev)
        out[label] = (plan, K, h // K)
    return out


def exp_phase(ctx):
    """[exp]: train_exp on the EXP fixture (EXP_FOLDS folds x EXP_EPOCHS
    epochs) and on the CEXP one (1 epoch) through ``script_phase``.
    Returns the EXP and the CEXP run's launches per (variant, D)."""
    w = ctx.script_phase("exp", ctx.expr["exp"], ("coo",))[3]
    wc = ctx.script_phase("cexp", ctx.expr["cexp"], ())[3]
    return w, wc


def sr25_phase(ctx):
    """[sr25]: train_sr through ``script_phase``; its first evaluation
    (after the first train step, batch-statistics norms) against the same
    evaluation on the CPU of the card's weights after that step, and a
    fresh card model on those weights: the same loss (rtol 1e-4) and
    accuracy, every running statistic as it was before the evaluation;
    and one Adam step under the gradient gate.  The CPU's own first step
    is a witness, not gated: SR25's nodes all look alike, many gradients
    are rounding noise, and Adam's first update moves each weight by
    about lr whatever the size of its gradient, so the two devices' steps
    part in the sign of those updates.  Returns the run's and the gated
    step's launches per (variant, D)."""
    torch = ctx.torch
    from kpgnn_tpu_torch.models.factory import make_model
    from kpgnn_tpu_torch.nn.inits import init_parameters
    from kpgnn_tpu_torch.train.loop import evaluate, train_step
    from kpgnn_tpu_torch.train.state import make_optimizer

    sl = ctx.expr["sr25"]
    fwd = sl.plan.fwd
    per_hop = [int(fwd.indptr[(k + 1) * fwd.rows_per_hop]
                   - fwd.indptr[k * fwd.rows_per_hop]) for k in range(sl.cfg.K)]
    log(f"[sr25] {sl.graphs} graphs, (v, k, lambda, mu) "
        f"{sorted(set(sl.srgs), key=str)}; the plan's hop edges per hop "
        f"{per_hop}, rows up to the last live one per hop {fwd.hop_live}")
    check(len(sl.srgs) == sl.graphs == 15
          and set(sl.srgs) == {(25, 12, 5, 6)},
          f"sr25: the fixture's graphs are not 15 SRG(25,12,5,6): {sl.srgs}")
    check(per_hop[2:] == [0] * (sl.cfg.K - 2) and min(per_hop[:2]) > 0,
          f"sr25: hops 3.. carry {per_hop[2:]} edges (diameter 2: none)")
    after = {}
    sl.on_epoch = lambda e, m, row: after.setdefault(e, {
        k: t.detach().cpu().clone() for k, t in m.state_dict().items()})
    rows, _, _, w = ctx.script_phase("sr25", sl, ("coo",))
    a = sl.args
    got = rows[0]
    evals = {}
    for name, device in (("CPU", torch.device("cpu")), ("card", ctx.dev)):
        model = make_model(sl.cfg).to(device)
        model.load_state_dict(after[0])
        before = {k: v.clone() for k, v in model.named_buffers()}
        evals[name] = evaluate(model, [b.to(device) for b in sl.eval_loader],
                               sl.loss, bn_train_mode=True)
        check(all(torch.equal(v, before[k])
                  for k, v in model.named_buffers()),
              f"sr25: the {name} eval moved a running statistic")
    init = init_parameters(make_model(sl.cfg), SEED)
    own = init_parameters(make_model(sl.cfg), SEED)
    train_step(own, make_optimizer(own.parameters(), a.lr, a.l2_wd),
               first_batch(sl.loaders["pallas"]), sl.loss)
    own_eval = evaluate(own, list(sl.eval_loader), sl.loss,
                        bn_train_mode=True)
    flipped = total = 0
    for k, p in init.named_parameters():
        up_card = after[0][k] - p.detach()
        up_cpu = own.state_dict()[k] - p.detach()
        flipped += int((torch.sign(up_card) != torch.sign(up_cpu)).sum())
        total += p.numel()
    rel = {n: abs(got["val_loss"] - e["loss"]) / abs(e["loss"])
           for n, e in evals.items()}
    log(f"[sr25] first eval (batch-statistics norms) after the card's first "
        f"step: loss {got['val_loss']:.7f} accuracy {got['val_accuracy']:.4f}"
        + "".join(f"; the same weights on the {n}: {e['loss']:.7f} / "
                  f"{e['accuracy']:.4f} (rel diff {rel[n]:.2e})"
                  for n, e in evals.items())
        + f"; running statistics unchanged by each; witness, the CPU's own "
        f"first step: eval loss {own_eval['loss']:.7f} / "
        f"{own_eval['accuracy']:.4f}, its update's sign differs from the "
        f"card's in {flipped} of {total} weights; accuracy per epoch "
        f"{[r['val_accuracy'] for r in rows]}")
    check(all(x <= 1e-4 for x in rel.values())
          and all(e["accuracy"] == got["val_accuracy"]
                  for e in evals.values()),
          f"sr25: the first eval differs from the same weights' ({rel})")
    gate = ctx.gradient_gate(
        "sr25", f"KPGIN K={sl.cfg.K} L={sl.L} SR25", sl.cfg,
        sl.loaders["pallas"], (a.lr, a.l2_wd), sl.loss,
        {ctx.fused_v: sl.L, ctx.gather_v: sl.L})
    return w, gate


def sim_embeddings(torch, device, n_graphs):
    """run_simulation's node embeddings of its first ``n_graphs`` graphs
    at its defaults, on ``device`` (plain version on the CPU)."""
    from kpgnn_tpu_torch.models.factory import make_model
    from kpgnn_tpu_torch.nn.inits import init_parameters
    from kpgnn_tpu_torch.prep.khop import extract_khop
    from kpgnn_tpu_torch.scripts import run_simulation as sim

    args = sim.parser().parse_args(["--seed", str(SEED), "--backend",
                                    "pallas"])
    mcfg = sim.model_config(args.K, args.hidden_size)
    lk = {"mode": "pallas", "v1": 3, "vk": 12}
    out = []
    for i, g in enumerate(sim.generate_k_regular(args.n, args.r, n_graphs,
                                                 SEED)):
        graph = extract_khop(g["num_nodes"], g["edge_index"], None,
                             sim.khop_config(args.K), x=g["x"], y=g["y"])
        model = init_parameters(make_model(mcfg), SEED + i).to(device)
        out.append(sim.node_embeddings(model, graph, lk, device))
    return out


def sim_phase(ctx):
    """[sim]: run_simulation at its defaults (n=50 r=3, 10 graphs, K=2
    H=64) on the card: exactly L fused launches a forward, no gather; the
    collision rate against the same run on the CPU.  The rate's 1e-8
    threshold is below f32 rounding, so a pair may collide on one device
    only where the two sum in another order: any such pair must lie
    within rounding (1e-5 of the largest |value|) on both.  Then --sweep
    --graphs SIM_SWEEP_GRAPHS: its JSON table written, K x n rates in
    [0, 1], and one fused launch a forward at each K's width.  Returns the
    main run's and the sweep's launches per (variant, D)."""
    import numpy as np
    torch, spmm = ctx.torch, ctx.spmm
    from kpgnn_tpu_torch.scripts import run_simulation as sim

    base = ["--backend", "pallas", "--seed", str(SEED)]
    args = sim.parser().parse_args(base)
    spmm.reset_launch_counts()
    rate = sim.main(base + ["--device", "cuda"])
    torch.cuda.synchronize()
    v = dict(spmm.gather_segment_sum.variant_launches)
    w = +Counter(spmm.gather_segment_sum.width_launches)
    D = args.hidden_size // args.K
    expect = {ctx.fused_v: args.graphs * args.num_layer}
    rate_cpu = sim.main(base + ["--device", "cpu"])
    log(f"[sim] n={args.n} r={args.r} K={args.K} H={args.hidden_size}, "
        f"{args.graphs} graphs: collision rate GPU {rate:.6f}, CPU "
        f"{rate_cpu:.6f}; kernel launches {v} (expected {expect}), by "
        f"width {dict(w)}")
    check(v == expect and dict(w) == {(ctx.fused_v, D): expect[ctx.fused_v]},
          f"sim: launches {v} {dict(w)} != {expect} at D={D} (forward only: "
          f"L fused a forward, no gather)")
    check(0.0 < rate < 1.0, f"sim: collision rate {rate}")
    if rate != rate_cpu:
        one_side = 0
        for eg, ec in zip(sim_embeddings(torch, ctx.dev, args.graphs),
                          sim_embeddings(torch, torch.device("cpu"),
                                         args.graphs)):
            tol = 1e-5 * float(np.abs(ec).max())
            iu = np.triu_indices(len(ec), 1)
            dg = np.linalg.norm(eg[:, None] - eg[None], axis=-1)[iu]
            dc = np.linalg.norm(ec[:, None] - ec[None], axis=-1)[iu]
            diff = (dg < 1e-8) != (dc < 1e-8)
            one_side += int(diff.sum())
            check(bool(((dg < tol) == (dc < tol)).all()
                       and (dg[diff] < tol).all() and (dc[diff] < tol).all()),
                  "sim: a pair that collides on one device only is not "
                  "equal within rounding on both")
        log(f"[sim] the rates differ: {one_side} pairs collide on one "
            f"device only, each equal within rounding on both")
    spmm.reset_launch_counts()
    plot = os.path.join(ctx.work, "sim", "simulation.png")
    sweep = ["--sweep", "--graphs", str(SIM_SWEEP_GRAPHS)]
    table = sim.main(base + sweep + ["--device", "cuda", "--plot_path", plot])
    torch.cuda.synchronize()
    ws = +Counter(spmm.gather_segment_sum.width_launches)
    per = len(sim.SWEEP_NS) * SIM_SWEEP_GRAPHS
    expect_w = Counter()
    for K in sim.SWEEP_KS:
        Dk = args.hidden_size // K
        expect_w[spmm.variant_name(torch.float32, Dk * 4 % 16 == 0, True),
                 Dk] += per
    with open(table["json"]) as f:
        saved = json.load(f)
    cpu_table = sim.main(base + sweep + ["--device", "cpu", "--plot_path",
                                         os.path.join(ctx.work, "sim_cpu",
                                                      "simulation.png")])
    log(f"[sim] sweep: {table['json']} written (plot "
        f"{'drawn' if table['plot'] else 'not drawn: no matplotlib'}); "
        f"rates by K over n={saved['n']}: GPU {saved['rates']}, CPU "
        f"{ {k: v for k, v in cpu_table['rates'].items()} }; launches by "
        f"width {dict(ws)} (expected {dict(expect_w)})")
    check(sorted(saved["rates"]) == [str(k) for k in sim.SWEEP_KS]
          and all(len(r) == len(sim.SWEEP_NS) and all(0.0 <= x <= 1.0
                                                      for x in r)
                  for r in saved["rates"].values()),
          f"sim: sweep table {saved['rates']}")
    check(ws == expect_w, f"sim: sweep launches {dict(ws)} != "
          f"{dict(expect_w)}")
    return w, ws


def search_phase(ctx):
    """[search]: run_search's sr_search preset, its first config, for one
    epoch on the SR25 fixture through the kernel: one finite result.
    Returns its launches per (variant, D)."""
    import math
    from kpgnn_tpu_torch.scripts import run_search
    ctx.spmm.reset_launch_counts()
    res = run_search.main([
        "--preset", "sr_search", "--limit", "1", "--base",
        f"--device cuda --backend pallas --num_epochs 1 --seed {SEED} "
        f"--dataset_dir {ctx.work} --save_dir "
        f"{os.path.join(ctx.work, 'search')}"])
    w = +Counter(ctx.spmm.gather_segment_sum.width_launches)
    log(f"[search] sr_search, first config: {res}; launches by width "
        f"{dict(w)}")
    check(len(res) == 1 and res[0]["script"] == "sr"
          and math.isfinite(res[0]["metric"]),
          f"search: {res}")
    return w


def ckpt_phase(ctx):
    """[ckpt]: the flagship with --save_checkpoints for 2 epochs
    (``script_phase``); best.pt equal to the model of its epoch; loaded
    into a fresh model and optimizer on the card and on the CPU, and
    card -> CPU -> card, every parameter, buffer and optimizer-state tensor
    bit for bit; then a 1-epoch --load_path warm start whose first step
    equals the CPU's warm start.  Returns the runs' launches per (variant,
    D)."""
    import glob
    torch = ctx.torch
    from kpgnn_tpu_torch.models.factory import make_model
    from kpgnn_tpu_torch.nn.inits import init_parameters
    from kpgnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                  read_checkpoint,
                                                  save_checkpoint)
    from kpgnn_tpu_torch.train.state import make_optimizer

    states = {}
    save = os.path.join(ctx.work, "ckpt")
    run = SimpleNamespace(**dict(
        vars(ctx.zinc), epochs=2,
        argv=train_argv(ctx.work, save, "cuda") + ["--num_epochs", "2",
                                                   "--save_checkpoints"],
        on_epoch=lambda e, m, row: states.__setitem__(e, {
            k: t.detach().cpu().clone() for k, t in m.state_dict().items()})))
    w = ctx.script_phase("ckpt", run, ())[3]
    dirs = glob.glob(os.path.join(save, "train", "*", "checkpoints"))
    check(len(dirs) == 1, f"ckpt: checkpoint dirs {dirs}")
    files = sorted(os.listdir(dirs[0]))
    best = os.path.join(dirs[0], "best.pt")
    ref = read_checkpoint(best)
    epoch = ref["meta"]["step"]
    check("best.pt" in files and f"step_{epoch}.pt" in files,
          f"ckpt: files {files}")
    check(all(torch.equal(ref["model"][k], t)
              for k, t in states[epoch].items()),
          f"ckpt: best.pt is not the model of epoch {epoch}")

    def restored(device, path):
        model = init_parameters(make_model(ctx.mcfg), SEED + 1).to(device)
        opt = make_optimizer(model.parameters(), ctx.args.lr,
                             ctx.args.l2_wd)
        load_checkpoint(path, model, opt)
        return model, opt

    def same(model, opt, label):
        """Every tensor against best.pt's; each optimizer state tensor
        where a fresh optimizer keeps it (Adam's step counts on the CPU,
        the moments beside their parameter)."""
        sd, od = model.state_dict(), opt.state_dict()
        check(sd.keys() == ref["model"].keys()
              and all(torch.equal(sd[k].cpu(), ref["model"][k]) for k in sd),
              f"ckpt: {label}: a parameter or buffer differs")
        ro = ref["opt"]
        check(od["param_groups"] == ro["param_groups"]
              and od["state"].keys() == ro["state"].keys(),
              f"ckpt: {label}: optimizer groups or state keys differ")
        params = [p for g in opt.param_groups for p in g["params"]]
        n = 0
        for i, st in ro["state"].items():
            for k, t in st.items():
                got = od["state"][i][k]
                where = (torch.device("cpu") if k == "step"
                         else params[i].device)
                check(got.dtype == t.dtype and got.device == where
                      and torch.equal(got.cpu(), t),
                      f"ckpt: {label}: optimizer state {i}/{k} differs or "
                      f"lies on {got.device}, not {where}")
                n += 1
        return n
    card = same(*restored(ctx.dev, best), "restored on the card")
    model_c, opt_c = restored(torch.device("cpu"), best)
    same(model_c, opt_c, "restored on the CPU")
    trip = os.path.join(ctx.work, "ckpt_cpu.pt")
    save_checkpoint(trip, model_c, opt_c, ref["meta"])
    same(*restored(ctx.dev, trip), "card -> CPU -> card")
    log(f"[ckpt] best.pt (epoch {epoch} of 2, files {files}): "
        f"{len(ref['model'])} parameters and buffers and {card} optimizer "
        f"tensors bit-identical restored on the card, on the CPU and card "
        f"-> CPU -> card; Adam's step counts on the CPU, the moments beside "
        f"their parameters")
    warm = SimpleNamespace(**dict(
        vars(ctx.zinc), load=best,
        argv=train_argv(ctx.work, os.path.join(ctx.work, "ckpt_warm"),
                        "cuda") + ["--load_path", best]))
    ww = ctx.script_phase("ckpt warm start", warm, ())[3]
    return w + ww


TRACE_KERNEL = re.compile(r"gather_segment_sum_kernel<(\w+), (true|false), "
                          r"(true|false)")


def trace_variants(torch, spmm, names):
    """{kernel variant: events} of the gather kernel's events in a trace
    (``names``: {event name: count})."""
    out = Counter()
    for name, n in names.items():
        m = TRACE_KERNEL.search(name)
        if m:
            dtype = torch.float32 if m.group(1) == "float" else torch.bfloat16
            out[spmm.variant_name(dtype, m.group(2) == "true",
                                  m.group(3) == "true")] += n
    return out


def profile_phase(ctx):
    """[profile]: the flagship with --profile_dir for 2 epochs
    (``script_phase``): trace_summary finds the trace of epoch 1, whose
    device events hold the kernel's fused and gather variants exactly as
    often as the launch counter counted them in that epoch (2L a train
    step).  Then profile_step's resident, bf16 and large stages: exit 0,
    each stage's time and top device ops.  Returns the flagship run's
    launches and profile_step's (the large stage: D=34, scalar) per
    (variant, D)."""
    import io
    torch, spmm = ctx.torch, ctx.spmm
    from kpgnn_tpu_torch.scripts import profile_step
    from kpgnn_tpu_torch.utils import profiling, trace_summary

    prof = os.path.join(ctx.work, "prof")
    traced = Counter()
    plain_trace = profiling.trace

    @contextlib.contextmanager
    def counting_trace(*a, **kw):
        before = Counter(spmm.gather_segment_sum.variant_launches)
        with plain_trace(*a, **kw) as p:
            yield p
        after = Counter(spmm.gather_segment_sum.variant_launches)
        after.subtract(before)
        traced.update(+after)
    run = SimpleNamespace(**dict(
        vars(ctx.zinc), epochs=2,
        argv=train_argv(ctx.work, os.path.join(ctx.work, "profsave"), "cuda")
        + ["--num_epochs", "2", "--profile_dir", prof]))
    profiling.trace = counting_trace
    try:
        w = ctx.script_phase("profile", run, ())[3]
    finally:
        profiling.trace = plain_trace
    text = trace_summary.report(prof, 8)
    tracks = trace_summary.summarize(trace_summary.load_events(
        trace_summary.find_trace(prof)))
    names = Counter()
    for name, t in tracks.items():
        if not name.startswith("/host"):
            names.update(t["counts"])
    in_trace = trace_variants(torch, spmm, names)
    expect = {ctx.fused_v: ctx.zinc.train_steps * L,
              ctx.gather_v: ctx.zinc.train_steps * L}
    log(f"[profile] trace of epoch 1: {len(names)} device op names, kernel "
        f"variants in the trace {dict(in_trace)}, launch counter over the "
        f"traced epoch {dict(traced)} (expected {expect}); summary:\n"
        + "\n".join(f"[profile]   {x}" for x in text.splitlines()))
    check(bool(names), "profile: the trace has no device event")
    check(in_trace == traced == Counter(expect),
          f"profile: trace {dict(in_trace)}, counter {dict(traced)}, "
          f"expected {expect}")
    spmm.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            res = profile_step.main(["--stages", "resident,bf16,large",
                                     "--out_dir",
                                     os.path.join(ctx.work, "profile_step")])
    except SystemExit as e:
        log(buf.getvalue())
        raise SmokeFailure(f"profile_step exited with {e.code}")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    wp = +Counter(spmm.gather_segment_sum.width_launches)
    keep, top = [], 0
    for x in buf.getvalue().splitlines():
        if x.startswith(("resident epoch", "dense ", "large-graph", "[stage",
                         "device:", "top ops")):
            keep.append(x)
            top = 5 if x.startswith("top ops") else 0
        elif top:
            keep.append(x)
            top -= 1
    log(f"[profile] profile_step --stages resident,bf16,large: exit 0 in "
        f"{secs:.1f} s; launches by width {dict(wp)}; stage times and top "
        "device ops:\n" + "\n".join(f"[profile_step] {x}" for x in keep))
    check(set(res) == {"resident", "bf16", "large"},
          f"profile_step returned {sorted(res)}")
    D = profile_step.LARGE_HIDDEN // profile_step.LARGE_K
    check(set(wp) <= {(spmm.variant_name(torch.float32, False, f), D)
                      for f in (True, False)},
          f"profile_step launched {dict(wp)} (the large stage: D={D}, "
          f"scalar variants)")
    return w, wp, res


def graph_ms(torch, fn, x, iters=50):
    """Device time per call of ``fn(x)`` replayed from a CUDA graph (CUDA
    events over ``iters`` replays): the op's kernels back to back, without
    the host's launch cost between them.  None where the capture fails."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn(x)
    except RuntimeError as e:
        log(f"[time] CUDA graph capture failed: {str(e).splitlines()[0]}")
        return None
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(torch, fn, calls=5):
    """The kernels that ``calls`` calls of ``fn`` launch (torch.profiler,
    after one call outside the profile), as key_averages' CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def kernel_times(torch, fn, calls=5):
    """``fn``'s device time per call by kernel (``device_kernels``), as a
    log phrase: the total, then the top kernels with their ms and
    launches per call."""
    ks = device_kernels(torch, fn, calls)
    if not ks:
        return "not measured (the profiler recorded no kernel)"
    total = sum(e.self_device_time_total for e in ks) / 1e3 / calls
    top = sorted(ks, key=lambda e: -e.self_device_time_total)[:6]
    return (f"{total:.4f} ms in {sum(e.count for e in ks) / calls:.0f} "
            "launches; " + "; ".join(
                f"{e.key[:50]} {e.self_device_time_total / 1e3 / calls:.4f}"
                f" (x{e.count / calls:g})" for e in top))


def banded_vk(adj):
    """The hop-k table's rows of a banded plan (1 for a one-hop plan)."""
    return 1 if adj.countsk is None else adj.countsk.shape[2]


def plan_text(b):
    """A banded batch's plan as a log phrase."""
    a = b.adj
    spill = 0 if a.spill_senders is None else a.spill_senders.shape[0]
    return (f"tile {a.tile}, halo {a.halo}, win {a.tile + 2 * a.halo}, "
            f"n_pad {b.n_pad}, spill {spill}, mask "
            f"{tuple(a.live.shape)} {str(a.live.dtype)[6:]}")


def card_gate(ctx, label, name, cfg, batches, hp, loss):
    """One step of ``cfg``'s model (initialized from SEED) on the card on
    ``batches["banded"]`` against the same step on the card on each other
    backend's batch of the same graphs in the same node layout, under the
    gradient gate's bound (``grad_leaves``): each reference step replays
    the banded step's ReLU branches, and its twin with every weight moved
    by an ulp, also on the card, measures its f32 rounding.  Every other
    op of the step runs the same kernels on both sides, so the comparison
    isolates the aggregation.  The loss within rtol 1e-4, every gradient
    inside the bound, every flipped ReLU input within 1e-4 of its call's
    largest; no kernel launch on banded."""
    torch = ctx.torch
    from kpgnn_tpu_torch.models.factory import make_model
    from kpgnn_tpu_torch.nn.inits import init_parameters

    def fresh():
        return init_parameters(make_model(cfg), SEED)

    def step(batch, moved=False):
        model = ulp_moved(torch, fresh()) if moved else fresh()
        return ctx.step_grads(model.to(ctx.dev), batch.to(ctx.dev), *hp,
                              loss)
    rec = []
    with relu_branches(torch, rec, replay=False):
        loss_b, grads_b, v = step(batches["banded"])
    check(not v, f"{name}: the banded step launched {v}")
    for ref, batch in batches.items():
        if ref == "banded":
            continue
        with relu_branches(torch, rec, replay=True) as flips:
            loss_r, grads_r, _ = step(batch)
        with relu_branches(torch, rec, replay=True):
            _, grads_u, _ = step(batch, moved=True)
        leaves = grad_leaves(grads_b, grads_r, grads_r, grads_u, name)
        over = [t for t in leaves if t[1] > 1.0]
        rel = abs(loss_b - loss_r) / abs(loss_r)
        flips_line, flip_rel = flip_text(flips, rec)
        log(f"[{label}] {name}: banded against {ref}, both on the card: "
            f"loss {loss_b:.7f} / {loss_r:.7f} (rel diff {rel:.2e}); "
            f"{flips_line} in the {ref} step; {len(leaves)} gradients under "
            f"the gate, worst by |err| / leaf max: {leaf_text(max(leaves))}; "
            f"worst by |err| / tol: "
            f"{leaf_text(max(leaves, key=lambda t: t[1]))}")
        if over:
            log(f"[{label}] {name}: {len(over)} gradients outside the gate "
                "against " + ref + ": "
                + "; ".join(leaf_text(t) for t in over))
        check(not over and rel <= 1e-4 and flip_rel <= 1e-4,
              f"{name}: banded against {ref} on the card: loss {rel:.2e}, "
              f"{len(over)} gradients outside the gate, a flipped ReLU "
              f"input {flip_rel:.2e} of its call's largest")


def banded_train_phase(ctx):
    """[banded]: the flagship at full width through the banded plan,
    per batch (``--backend banded --resident off``), one epoch through
    ``script_phase``: finite losses, no kernel launch, a first step equal
    to the CPU's on banded and to --backend coo's on the card (rtol
    1e-4), and to the card's pallas run's ([train]).  Then one Adam step
    of the first batch on the card against the same step on pallas and
    on coo on the card, under the gradient gate (``card_gate``); and each
    of the three against the CPU under the gradient gate.  The CPU
    comparison was a witness while cuDNN's LSTM put the card's flagship
    step at 0.8-1.2 of the gate's bound on every backend; on the BiLSTM
    kernel it sits at 0.16-0.31 (PERF.md §6) and gates again.  Returns
    the run's rows."""
    sl = SimpleNamespace(**dict(
        vars(ctx.zinc), L=0, cpu_mode="banded",
        argv=train_argv(ctx.work, os.path.join(ctx.work, "banded"), "cuda")
        + ["--backend", "banded", "--resident", "off"],
        loaders={"banded": ctx.banded_tl, "coo": ctx.zinc.loaders["coo"]}))
    log(f"[banded] flagship plan: {plan_text(ctx.banded_tl.example())}; "
        f"the loader's pins: halo {ctx.banded_tl.banded_halo}, spill pad "
        f"{ctx.banded_tl.banded_spill_pad}")
    rows, losses, _, _ = ctx.script_phase("banded", sl, ("coo",))
    rel = abs(losses[0] - ctx.zlosses[0]) / abs(ctx.zlosses[0])
    log(f"[banded] first-step loss {losses[0]:.7f}, the card's pallas run's "
        f"{ctx.zlosses[0]:.7f} (rel diff {rel:.2e})")
    check(rel <= 1e-4, f"banded: first-step loss differs from the pallas "
          f"run's by {rel:.2e} > 1e-4")
    hp = (ctx.args.lr, ctx.args.l2_wd)
    loaders = {"banded": ctx.banded_tl, "pallas": ctx.zinc.loaders["pallas"],
               "coo": ctx.zinc.loaders["coo"]}
    batches = {k: l.example() for k, l in loaders.items()}
    check(len({b.n_pad for b in batches.values()}) == 1,
          f"banded: the backends' first batches have n_pad "
          f"{ {k: b.n_pad for k, b in batches.items()} }")
    card_gate(ctx, "banded", f"KPGINPlus K={K} L={L}", ctx.mcfg, batches, hp,
              "l1")
    worst = {}
    for name, loader in loaders.items():
        expect = ({ctx.fused_v: L, ctx.gather_v: L} if name == "pallas"
                  else {})
        ctx.gradient_gate("banded", f"KPGINPlus K={K} L={L} {name}, card "
                          "against the CPU", ctx.mcfg, loader, hp, "l1",
                          expect)
        worst[name] = ctx.gradient_gate.worst
    log("[banded] the flagship step on the card against the CPU, worst "
        "|err| / tol by backend: "
        + ", ".join(f"{k} {v:.2f}" for k, v in worst.items()))
    return rows


def banded_resident_phase(ctx, per_batch_rows):
    """[banded] resident: the same run with --resident auto: the logged
    decision equal to ``resident_rule``'s, the store's bytes equal to
    ``banded_store_nbytes`` at the shapes planned over every split; the
    first batch gathered from the BandedStore against the same graphs
    collated (loss and every graph's prediction, rtol 1e-5); each epoch's
    seconds and one step's time, resident against per batch, and the
    per-batch step's profile (``ctx.step_profiles``).  Returns the store
    and its gathered first batch."""
    torch = ctx.torch
    from kpgnn_tpu_torch.models.factory import make_model
    from kpgnn_tpu_torch.nn.inits import init_parameters
    from kpgnn_tpu_torch.scripts import common
    from kpgnn_tpu_torch.train.loop import (_masked_loss, resident_rule,
                                            train_step)
    from kpgnn_tpu_torch.train.resident import (banded_store_nbytes,
                                                build_banded_store,
                                                gather_any,
                                                plan_banded_store_shapes)
    from kpgnn_tpu_torch.train.state import make_optimizer

    go, why = resident_rule("auto", ctx.banded_tl)
    save = os.path.join(ctx.work, "banded_resident")
    sl = SimpleNamespace(**dict(
        vars(ctx.zinc), L=0, cpu_mode="banded",
        argv=train_argv(ctx.work, save, "cuda") + ["--backend", "banded"],
        loaders={"banded": ctx.banded_tl}))
    rows = ctx.script_phase("banded resident", sl, ())[0]
    text = run_log(save)
    line = [x.split("] ", 1)[-1] for x in text.splitlines()
            if "resident store:" in x or "per-batch epochs" in x]
    others = [common.prepare(ctx.splits[k], ctx.args, f"ZINC_{k}")
              for k in ("val", "test")]
    shapes = plan_banded_store_shapes(
        list(ctx.zinc_train) + [g for gs in others for g in gs])
    nbytes = banded_store_nbytes(ctx.zinc_train, shapes[2], shapes[0],
                                 shapes[1], shapes[3], ctx.lk["v1"],
                                 ctx.lk["vk"])
    log(f"[banded] resident auto decides: {why}; the run logged: "
        f"{line[0] if line else 'no decision'}; store shapes over every "
        f"split (tile, halo, n_slot, spill) {shapes}, banded_store_nbytes "
        f"{nbytes} B; train epoch {rows[0]['seconds']:.3f} s resident, "
        f"{per_batch_rows[0]['seconds']:.3f} s per batch")
    check(bool(line) and line[0].startswith(
        "resident store:" if go else "per-batch epochs")
        and why in line[0], f"banded resident: the run logged {line}, the "
        f"rule decides {go} ({why})")
    check(not go or f" {nbytes} B," in line[0],
          f"banded resident: the store's bytes in {line[0]} are not "
          f"banded_store_nbytes's {nbytes}")
    store = build_banded_store(ctx.zinc_train, ctx.lk["v1"], ctx.lk["vk"],
                               shapes=shapes, device=ctx.dev)
    check(store.nbytes() == nbytes, f"banded store {store.nbytes()} B != "
          f"banded_store_nbytes {nbytes} B")
    idx = torch.arange(BATCH, device=ctx.dev)
    gathered = gather_any(store, idx)
    collated = ctx.banded_tl._collate(ctx.zinc_train[:BATCH]).to(ctx.dev)

    def first(batch):
        model = init_parameters(make_model(ctx.mcfg), SEED).to(ctx.dev)
        with torch.no_grad():
            pred = model(batch, train=True)
            lsum, cnt = _masked_loss(pred, batch.y, batch.graph_mask, "l1")
        return float(lsum / cnt), pred[:BATCH]
    (loss_r, pred_r), (loss_p, pred_p) = first(gathered), first(collated)
    pred_err = float((pred_r - pred_p).abs().max())
    pscale = float(pred_p.abs().max())
    log(f"[banded] the first batch gathered from the store ({gathered.n_pad}"
        f" rows, {plan_text(gathered)}) against collated ({collated.n_pad} "
        f"rows): loss {loss_r:.7f} / {loss_p:.7f} (rel diff "
        f"{abs(loss_r - loss_p) / abs(loss_p):.2e}); {BATCH} predictions, "
        f"max |err| {pred_err:.2e} of max {pscale:.2e}")
    check(abs(loss_r - loss_p) <= 1e-5 * abs(loss_p)
          and pred_err <= 1e-5 * max(pscale, 1.0),
          f"banded: the gathered batch's first step differs from the "
          f"collated one's (loss {loss_r} / {loss_p}, predictions "
          f"{pred_err:.2e})")
    model = init_parameters(make_model(ctx.mcfg), SEED).to(ctx.dev)
    opt = make_optimizer(model.parameters(), 1e-3)
    host_batch = ctx.banded_tl._collate(ctx.zinc_train[:BATCH])
    for how, step in (
            ("resident", lambda: train_step(model, opt,
                                            gather_any(store, idx))),
            ("per-batch", lambda: train_step(model, opt,
                                             host_batch.to(ctx.dev)))):
        ms = host_step_ms(torch, step)
        log(f"[time] banded {how} train step {ms:.2f} ms")
        if how == "per-batch":
            ctx.step_profiles["banded per-batch"] = profile_step(
                torch, step, ms, f"banded {how}")
    return store, gathered


def banded_bf16_phase(ctx):
    """[banded] --bf16: one epoch per batch: finite losses, no kernel
    launch, a first step within BF16_RTOL of the CPU's bf16 banded step
    and of the card's --backend pallas --bf16 run's ([bf16]); the window
    product of the bf16 aggregation runs as a GEMM kernel that the f32
    aggregation does not run (its profile)."""
    torch = ctx.torch
    from kpgnn_tpu_torch.ops.banded import banded_khop_aggregate

    sl = SimpleNamespace(**dict(
        vars(ctx.zinc), L=0, cpu_mode="banded", cfg=ctx.bmcfg,
        rtol=BF16_RTOL,
        argv=train_argv(ctx.work, os.path.join(ctx.work, "banded_bf16"),
                        "cuda")
        + ["--backend", "banded", "--resident", "off", "--bf16"],
        loaders={"banded": ctx.banded_tl}))
    _, losses, _, _ = ctx.script_phase("banded bf16", sl, ())
    rel = abs(losses[0] - ctx.blosses[0]) / abs(ctx.blosses[0])
    log(f"[banded] bf16 first-step loss {losses[0]:.7f}, the card's pallas "
        f"--bf16 run's {ctx.blosses[0]:.7f} (rel diff {rel:.2e}, bound "
        f"{BF16_RTOL:g})")
    check(rel <= BF16_RTOL, f"banded bf16: first-step loss differs from the "
          f"pallas --bf16 run's by {rel:.2e}")
    adj = ctx.banded_tl.example().adj.to(ctx.dev)
    n = adj.n_nodes
    gen = torch.Generator(device=ctx.dev).manual_seed(3)
    t1 = torch.randn(adj.counts1.shape[1], H, device=ctx.dev, generator=gen)
    tk = torch.randn(adj.countsk.shape[2], H, device=ctx.dev, generator=gen)
    x = torch.randn(K, n, H, device=ctx.dev, generator=gen)
    names = {}
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        out = banded_khop_aggregate(xd, t1, tk, adj, hop_major=True)
        check(out.dtype == dtype, f"banded: a {dtype} aggregation returned "
              f"{out.dtype}")
        names[dtype] = {e.key for e in device_kernels(
            torch, lambda: banded_khop_aggregate(xd, t1, tk, adj,
                                                 hop_major=True))}

    def gemms(keys):
        return sorted(k[:80] for k in keys if any(
            w in k.lower() for w in ("gemm", "nvjet", "xmma", "cutlass")))
    own16 = names[torch.bfloat16] - names[torch.float32]
    log(f"[banded] the f32 aggregation's GEMM kernels "
        f"{gemms(names[torch.float32])}; the bf16 one's "
        f"{gemms(names[torch.bfloat16])}, of them not in the f32 one's "
        f"{gemms(own16)}")
    if not names[torch.float32]:
        log("[banded] the profiler recorded no kernel: the bf16 GEMM not "
            "measured")
    else:
        check(gemms(own16), "banded bf16: the window product ran no GEMM "
              "kernel of its own in bf16")


def banded_kpgcn_phase(ctx):
    """[banded] KPGCN: one AdamW step of KPGCN at CSL width on a CSL batch
    through ``collate_banded(gcn_norm=True)`` under the gradient gate
    against the CPU, no kernel launch; its loss equal to the card's
    pallas step's (rtol 1e-4); a plain plan must raise the ValueError."""
    torch = ctx.torch
    from kpgnn_tpu_torch.models.factory import make_model
    from kpgnn_tpu_torch.nn.inits import init_parameters
    from kpgnn_tpu_torch.scripts import common, train_csl
    from kpgnn_tpu_torch.train.loader import GraphLoader

    fargs = train_csl.parser().parse_args(csl_argv(
        os.path.join(ctx.work, "csl"), "cuda", "banded", "KPGCN"))
    fcfg = common.model_config(fargs, input_encoder=("linear", 1),
                               task="graph_classification", output_size=10)
    lk = common.loader_kwargs(fargs, fcfg)
    check(lk.get("banded_gcn_norm") is True,
          f"banded: KPGCN's loader kwargs {lk}")
    bl = GraphLoader(ctx.ctrain, CSL_BATCH, shuffle=True, seed=SEED, **lk)
    b = bl.example()
    check(b.adj.sender_scaled, "banded: KPGCN's plan is not sender-scaled")
    log(f"[banded] KPGCN CSL batch: {plan_text(b)}")
    hp = (fargs.lr, fargs.l2_wd)
    ctx.gradient_gate("banded", f"KPGCN K={CSL_K} L={CSL_L} banded gcn_norm",
                      fcfg, bl, hp, "cross_entropy", {})

    def card_loss(batch):
        model = init_parameters(make_model(fcfg), SEED).to(ctx.dev)
        return ctx.step_grads(model, batch.to(ctx.dev), *hp,
                              "cross_entropy")[0]
    lb, lp = card_loss(b), card_loss(ctx.ctl.example())
    rel = abs(lb - lp) / abs(lp)
    log(f"[banded] KPGCN step loss on the card: banded {lb:.7f}, pallas "
        f"{lp:.7f} (rel diff {rel:.2e})")
    check(rel <= 1e-4, f"banded KPGCN: loss differs from pallas by {rel:.2e}")
    plain = GraphLoader(ctx.ctrain, CSL_BATCH, **dict(
        lk, banded_gcn_norm=False)).example().to(ctx.dev)
    model = init_parameters(make_model(fcfg), SEED).to(ctx.dev)
    try:
        model(plain, train=False)
    except ValueError as e:
        check("gcn_norm" in str(e), f"banded KPGCN: plain plan raised {e}")
        log(f"[banded] KPGCN on a plain plan raises: {e}")
    else:
        raise SmokeFailure("banded: KPGCN ran on a plain plan")


def polymer_graphs():
    """profile_step's large-stage graphs: 2 x 8,192-node polymers."""
    from kpgnn_tpu_torch.data.synthetic import synthetic_polymers
    from kpgnn_tpu_torch.scripts import profile_step as ps
    return synthetic_polymers(ps.LARGE_GRAPHS, ps.LARGE_NODES,
                              K=ps.LARGE_K, seed=0)


def banded_spill_phase(ctx):
    """[banded] spill: on the flagship first batch and the polymer batch,
    plans with halo=0 (every cross-tile edge spills), unpadded and padded
    to a loader-style spill_pad: the aggregation's forward and its x and
    table gradients on the card against the COO backend's
    (``ops/segment.khop_aggregate``) on the card, at every hop prefix
    k=1..K on the padded plan (rows of hops >= k and the pads' sentinel
    rows must drop).  Tolerances as phase 2's: 1e-5 plus, for the
    forward and dx, 1e-6 of the largest sum of |terms| and, for the
    table gradients, 2 sqrt(E) 2^-24 of it (E terms summed)."""
    torch = ctx.torch
    from kpgnn_tpu_torch.graph.batch import collate, collate_banded
    from kpgnn_tpu_torch.ops.adjacency import khop_aggregate_adj
    from kpgnn_tpu_torch.scripts import profile_step as ps

    gen = torch.Generator(device=ctx.dev).manual_seed(5)

    def hold(label, badj, cadj, k, D):
        n = cadj.n_nodes
        v1, vk = badj.counts1.shape[1], banded_vk(badj)
        x = torch.randn(n, k, D, device=ctx.dev, generator=gen)
        t1 = torch.randn(v1, D, device=ctx.dev, generator=gen)
        tk = torch.randn(vk, D, device=ctx.dev, generator=gen)
        w = torch.randn(n, k, D, device=ctx.dev, generator=gen)

        def run(adj, xx, a1, ak, ww):
            xx, a1, ak = (v.clone().requires_grad_(True)
                          for v in (xx, a1, ak))
            out = khop_aggregate_adj(adj, xx, a1, ak if k > 1 else None)
            (out * ww).sum().backward()
            return out.detach(), xx.grad, a1.grad, (ak.grad if k > 1
                                                    else None)
        got = run(badj, x, t1, tk, w)
        want = run(cadj, x, t1, tk, w)
        absum = run(cadj, x.abs(), t1.abs(), tk.abs(), w.abs())
        n_terms = int(cadj.edge_mask.sum()) * k
        rel = (1e-6, 1e-6, 2 * math.sqrt(n_terms) * 2.0 ** -24,
               2 * math.sqrt(n_terms) * 2.0 ** -24)
        msg = []
        for what, g_, w_, a_, r in zip(("fwd", "dx", "d table1", "d tablek"),
                                       got, want, absum, rel):
            if w_ is None:
                continue
            tol = 1e-5 + r * float(a_.max())
            err = float((g_ - w_).abs().max())
            msg.append(f"{what} {err:.2e} (tol {tol:.1e})")
            check(err <= tol, f"banded spill {label} k={k} {what}: max "
                  f"|err| {err:.3e} > {tol:.3e}")
        return ", ".join(msg)

    cases = [("flagship", ctx.zinc_train[:BATCH], K, H, ctx.lk["v1"],
              ctx.lk["vk"]),
             ("polymer", polymer_graphs(), ps.LARGE_K,
              ps.LARGE_HIDDEN // ps.LARGE_K, 5, 32)]
    for label, graphs, kk, D, v1, vk in cases:
        b = collate_banded(graphs, v1=v1, vk=vk, halo=0)
        n_spill = b.adj.spill_senders.shape[0]
        pad = -(-n_spill // 1024) * 1024 + 1024
        bp = collate_banded(graphs, v1=v1, vk=vk, halo=0, n_pad=b.n_pad,
                            spill_pad=pad)
        coo = collate(graphs, n_pad=b.n_pad).adj.to(ctx.dev)
        badj, padj = b.adj.to(ctx.dev), bp.adj.to(ctx.dev)
        log(f"[banded] spill {label}: halo 0, {plan_text(b)} of "
            f"{int(coo.edge_mask.sum())} union edges x {kk} hops; padded "
            f"to {pad} (sentinel row {kk * b.n_pad})")
        log(f"[banded] spill {label} k={kk} unpadded: "
            + hold(label, badj, coo, kk, D))
        for k in range(1, kk + 1):
            log(f"[banded] spill {label} k={k} padded: "
                + hold(f"{label} padded", padj.slice_hops(k),
                       coo.slice_hops(k), k, D))


def banded_large_phase(ctx):
    """[banded] large: ``profile_step.main(["--stages", "large,banded"])``
    exits 0; both stages' step times and top device ops, the same model
    on the same polymers, kernel plan against banded plan."""
    import io
    torch = ctx.torch
    from kpgnn_tpu_torch.scripts import profile_step

    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            res = profile_step.main(["--stages", "large,banded", "--out_dir",
                                     os.path.join(ctx.work, "banded_prof")])
    except SystemExit as e:
        log(buf.getvalue())
        raise SmokeFailure(f"profile_step large,banded exited with {e.code}")
    torch.cuda.synchronize()
    keep, top = [], 0
    for x in buf.getvalue().splitlines():
        if x.startswith(("large-graph", "banded", "[stage", "top ops")):
            keep.append(x)
            top = 6 if x.startswith("top ops") else 0
        elif top:
            keep.append(x)
            top -= 1
    log(f"[banded] profile_step --stages large,banded: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s; stage times and top device ops:"
        "\n" + "\n".join(f"[profile_step] {x}" for x in keep))
    check(set(res) == {"large", "banded"}, f"profile_step returned {res}")
    return res


def banded_tune_phase(ctx):
    """[banded] tune: ``tune_banded.main(["--tiles", "128,256,512"])`` at
    its defaults (2 x 8,192 nodes, K=3, D=102): three rows and a
    best_tile."""
    import io
    from kpgnn_tpu_torch.scripts import tune_banded

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = tune_banded.main(["--tiles", "128,256,512"])
    rows = [json.loads(x) for x in buf.getvalue().splitlines()
            if x.startswith("{")]
    log("[banded] tune_banded --tiles 128,256,512:\n"
        + "\n".join(f"[tune_banded] {json.dumps(r)}" for r in rows))
    check(len(rows) == 4 and set(res) == {"128", "256", "512"}
          and rows[-1].get("best_tile") in (128, 256, 512),
          f"tune_banded printed {rows}")


def device_prep_phase(ctx):
    """[device_prep]: 64 of the flagship fixture's molecules padded to
    the dense loader's n_slot, kernel spd and gd: ``device_khop_dense``
    on the card gives the host prep's ``collate_dense`` hop_attr, counts1
    and countsk exactly (integer codes and counts; TF32 is off); its ms
    (CUDA events) beside the host prep's seconds for the same graphs."""
    import dataclasses
    import numpy as np
    torch = ctx.torch
    from kpgnn_tpu_torch.graph.batch import collate_dense
    from kpgnn_tpu_torch.prep.device import device_khop_dense
    from kpgnn_tpu_torch.prep.khop import extract_graphs
    from kpgnn_tpu_torch.scripts import common
    from kpgnn_tpu_torch.train.loader import GraphLoader

    check(not torch.backends.cuda.matmul.allow_tf32,
          "device_prep: TF32 is on")
    raw = ctx.splits["train"][:BATCH]
    v1, vk = ctx.lk["v1"], ctx.lk["vk"]
    n_slot = GraphLoader(ctx.zinc_train, BATCH, mode="dense", v1=v1,
                         vk=vk).n_slot
    A = np.zeros((BATCH, n_slot, n_slot), np.float32)
    At = np.zeros((BATCH, n_slot, n_slot), np.int32)
    for b, g in enumerate(raw):
        u, v = np.asarray(g["edge_index"])
        A[b, u, v] = 1.0
        At[b, u, v] = np.asarray(g["edge_attr"]).reshape(-1)
    a = torch.from_numpy(A).to(ctx.dev)
    attr = torch.from_numpy(np.ascontiguousarray(At.transpose(0, 2, 1))
                            ).to(ctx.dev)
    for kernel in ("spd", "gd"):
        cfg = dataclasses.replace(common.khop_config(ctx.args), kernel=kernel)
        t0 = time.perf_counter()
        graphs = extract_graphs(raw, cfg)
        host_s = time.perf_counter() - t0
        host = collate_dense(graphs, n_slot=n_slot, v1=v1, vk=vk,
                             g_pad=BATCH).adj
        kw = dict(K=cfg.K, max_edge_attr_num=cfg.max_edge_attr_num,
                  kernel=kernel, v1=v1, vk=vk)
        dev_adj, pe = device_khop_dense(a, attr, **kw)
        torch.cuda.synchronize()
        same = {f: torch.equal(getattr(dev_adj, f).cpu(), getattr(host, f))
                for f in ("hop_attr", "counts1", "countsk")}
        ms = time_ms(torch, lambda x: device_khop_dense(x, attr, **kw), [a],
                     iters=20, warmup=3)
        log(f"[device_prep] {kernel}: {BATCH} molecules in n_slot {n_slot}, "
            f"K={cfg.K}: device_khop_dense {ms:.3f} ms on the card, the host "
            f"prep (extract_graphs) {host_s:.3f} s; equal to collate_dense's "
            f"{same}; pe {tuple(pe.shape)}")
        check(all(same.values()), f"device_prep {kernel}: differs from the "
              f"host prep in {[f for f, ok in same.items() if not ok]}")


def banded_times(ctx, gathered):
    """[banded] times (CUDA events, rotating inputs): the hop-major banded
    aggregation, forward and forward + backward (x and both tables), on
    the flagship first batch (K=8, D=104; per batch and as gathered from
    the store) and the polymer batch (K=3, D=34), each beside the kernel
    path's ``khop_spmm`` on the same graphs and D and beside its bound:
    the larger of 2·K·T·tile·win·D FLOPs at F32_FLOPS and the f32 mask,
    the windows and the output at HBM_BYTES_PER_S (forward + backward:
    twice both).  Each op is timed as phase 9 times the kernel, and also
    replayed from a CUDA graph (``graph_ms``): the banded op launches ~20
    kernels a forward, and without the graph the host's launch cost sets
    its time.  Then the flagship train step's launches on banded
    against pallas and coo, by kernel name, and the aggregation's device
    time by kernel.  Prints the [banded] JSON line."""
    torch, spmm = ctx.torch, ctx.spmm
    from kpgnn_tpu_torch.graph.batch import collate_banded
    from kpgnn_tpu_torch.ops.banded import banded_khop_aggregate
    from kpgnn_tpu_torch.scripts import profile_step as ps

    gen = torch.Generator(device=ctx.dev).manual_seed(7)
    flag = ctx.banded_tl.example()
    poly = collate_banded(polymer_graphs(), v1=5, vk=32)
    LD = ps.LARGE_HIDDEN // ps.LARGE_K
    shapes = [("flagship per batch", flag.adj.to(ctx.dev), ctx.plan, K, H),
              ("flagship from the store", gathered.adj, None, K, H),
              ("polymer", poly.adj.to(ctx.dev), ctx.lplan, ps.LARGE_K, LD)]
    entries = []
    for label, adj, plan, kk, D in shapes:
        n = adj.n_nodes
        t1 = torch.randn(adj.counts1.shape[1], D, device=ctx.dev,
                         generator=gen).requires_grad_(True)
        tk = torch.randn(banded_vk(adj), D, device=ctx.dev,
                         generator=gen).requires_grad_(True)
        ops = {"banded": (n, lambda x: banded_khop_aggregate(
            x, t1, tk, adj, hop_major=True))}
        if plan is not None:
            ops["kernel"] = (plan.counts1.shape[0], lambda x: spmm.khop_spmm(
                x, t1, tk, plan, hop_major=True))
        ms = {}
        for name, (rows, agg) in ops.items():
            xs = [torch.randn(kk, rows, D, device=ctx.dev, generator=gen
                              ).requires_grad_(True) for _ in range(4)]
            g = torch.randn(kk, rows, D, device=ctx.dev, generator=gen)

            def fwd(x):
                with torch.no_grad():
                    return agg(x)

            def fwdbwd(x):
                return torch.autograd.grad(agg(x), (x, t1, tk), g)
            ms[name] = (time_ms(torch, fwd, xs), time_ms(torch, fwdbwd, xs),
                        graph_ms(torch, fwd, xs[0]),
                        graph_ms(torch, fwdbwd, xs[0]))
        T, tile, win = adj.live.shape[1:]
        flops = 2 * kk * T * tile * win * D
        nbytes = 4 * (kk * T * tile * win + kk * T * win * D + kk * n * D)
        t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES_PER_S
        bound = max(t_ops, t_bytes) * 1e3
        by = "operations" if t_ops >= t_bytes else "bytes"
        spill = 0 if adj.spill_senders is None else adj.spill_senders.shape[0]
        kernel = ms.get("kernel", (None,) * 4)
        e = dict(shape=label, K=kk, D=D, n_pad=n, tile=tile,
                 halo=adj.halo, win=win, spill=spill,
                 ms=ms["banded"][0], fwdbwd_ms=ms["banded"][1],
                 graph_ms=ms["banded"][2], graph_fwdbwd_ms=ms["banded"][3],
                 bound_ms=bound, fwdbwd_bound_ms=2 * bound, bound_by=by,
                 kernel_ms=kernel[0], kernel_fwdbwd_ms=kernel[1],
                 kernel_graph_ms=kernel[2], kernel_graph_fwdbwd_ms=kernel[3])
        entries.append(e)

        def pair(t):
            return " / ".join("not measured" if v is None else f"{v:.4f}"
                              for v in t)
        log(f"[time] banded {label} K={kk} D={D}: forward / +backward "
            f"{pair(ms['banded'][:2])} ms, replayed from a CUDA graph "
            f"{pair(ms['banded'][2:])} ms (bound {bound:.4f} / "
            f"{2 * bound:.4f} by {by}); the kernel path's khop_spmm "
            + (f"{pair(kernel[:2])} ms, from a CUDA graph "
               f"{pair(kernel[2:])} ms" if plan is not None
               else "not timed (no plan of this layout)"))
    # the flagship train step's launches, banded against pallas and coo
    # per batch on the same 64 graphs (profiles of [time], [resident])
    prof = {k: ctx.step_profiles.get(f"{k} per-batch")
            for k in ("banded", "pallas", "coo")}
    if all(p is not None for p in prof.values()):
        for other in ("pallas", "coo"):
            diff = Counter(prof["banded"][5])
            diff.subtract(prof[other][5])
            top = sorted(((v, k) for k, v in diff.items() if v),
                         key=lambda t: -abs(t[0]))[:8]
            log(f"[banded] flagship train step launches: banded "
                f"{prof['banded'][1]:.0f}, {other} {prof[other][1]:.0f}; "
                f"by kernel, banded minus {other}: "
                + "; ".join(f"{k[:60]} {v:+.0f}" for v, k in top))
    # where the aggregation's device time goes, by kernel
    adj, kk, D = shapes[0][1], shapes[0][3], shapes[0][4]
    x = torch.randn(kk, adj.n_nodes, D, device=ctx.dev, generator=gen,
                    requires_grad=True)
    t1 = torch.randn(adj.counts1.shape[1], D, device=ctx.dev,
                     generator=gen, requires_grad=True)
    tk = torch.randn(banded_vk(adj), D, device=ctx.dev, generator=gen,
                     requires_grad=True)
    g = torch.randn_like(x)
    for what, fn in (
            ("forward", lambda: banded_khop_aggregate(
                x.detach(), t1.detach(), tk.detach(), adj, hop_major=True)),
            ("forward + backward", lambda: torch.autograd.grad(
                banded_khop_aggregate(x, t1, tk, adj, hop_major=True),
                (x, t1, tk), g))):
        log(f"[banded] flagship per batch, {what}, device ms by kernel: "
            + kernel_times(torch, fn))
    log("[banded] " + json.dumps({"card": card_line(), "times": entries}))
    return entries


PAR_STEPS = 3                   # [dp] steps before the ranks' parameters
PAR_TIMED = 3                   # steps timed after each leg's gated step
PAR_TIMEOUT = 900               # seconds a spawned group may take


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _par_mesh(kind, dev):
    from kpgnn_tpu_torch.parallel.mesh import make_mesh
    from kpgnn_tpu_torch.parallel.multihost import dcn_mesh
    if kind == "dcn":
        return dcn_mesh(n_hosts=2, device=dev)
    return make_mesh(("node",) if kind == "node" else ("data",), device=dev)


def _parallel_rank(rank, world, jobs, device):
    """One rank of the multi-rank legs ([dp], [node], [dcn]): every rank
    computes on ``device`` (the one card) and the group is gloo (NCCL
    takes one rank a card).  Per job: the model initialized from SEED, its first (gated)
    step with its ReLU inputs recorded, the loss sum and count over the
    group, the all-reduced gradients, the kernel launches of that step
    (the counters set to 0 just before it), then the job's further steps
    and PAR_TIMED timed ones; the parameters after the job's steps."""
    import torch
    from kpgnn_tpu_torch.models.factory import make_model
    from kpgnn_tpu_torch.nn.inits import init_parameters
    from kpgnn_tpu_torch.ops import spmm
    from kpgnn_tpu_torch.parallel.dp import make_parallel_train_step
    from kpgnn_tpu_torch.parallel.multihost import (host_shard_loader,
                                                    lockstep_group_count)
    from kpgnn_tpu_torch.parallel.partition import (make_sharded_train_step,
                                                    partition_batch)
    from kpgnn_tpu_torch.scripts import common
    from kpgnn_tpu_torch.train.resident import (
        build_dense_store, make_parallel_resident_train_epoch,
        parallel_epoch_index_chunks)
    from kpgnn_tpu_torch.train.state import make_optimizer

    common.set_full_f32()
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    meshes, out = {}, {}
    for job in jobs:
        kind = job["kind"]
        key = "node" if kind == "node" else ("dcn" if kind == "dcn"
                                             else "data")
        if key not in meshes:
            meshes[key] = _par_mesh(kind, dev)
        mesh = meshes[key]
        model = init_parameters(make_model(job["cfg"]), SEED).to(dev)
        opt = make_optimizer(model.parameters(), *job["hp"])
        res = {}
        relu = []
        if kind == "node":
            t0 = time.perf_counter()
            shard = partition_batch(job["batch"], world, rank,
                                    mesh.group("node"), False,
                                    **job["plans"])
            res["partition_s"] = time.perf_counter() - t0
            a = shard.adj
            res.update(halo=a.halo, boundary=a.boundary_total(),
                       n_local=a.n_local, n_ext=a.n_ext,
                       comm=a.comm_elems_per_layer(job["K"], job["D"]) * 4,
                       psum=a.psum_elems_per_layer(job["K"], job["D"]) * 4)
            step = make_sharded_train_step(mesh)
            batches = [shard.to(dev)]
        elif kind == "dcn":
            n_groups = lockstep_group_count(job["n_graphs"], job["B"], mesh)
            batches = [b.to(dev) for b in host_shard_loader(
                job["hosts"][mesh.axis_index("dcn")], mesh, n_groups)]
            step = make_parallel_train_step(mesh)
        elif kind == "dp":
            batches = [s[rank].to(dev) for s in job["steps"]]
            step = make_parallel_train_step(mesh)
        else:                               # dp resident, a dense store
            store = build_dense_store(job["graphs"], job["n_slot"],
                                      job["v1"], job["vk"], device=dev)
            chunks = parallel_epoch_index_chunks(
                job["order"], job["B"], world, store.num_graphs)
            epoch = make_parallel_resident_train_epoch(
                model, opt, mesh, job["loss"])
            spmm.reset_launch_counts()
            with relu_branches(torch, relu, replay=False):
                first, _ = epoch(store, chunks[:1])
            _sync(torch, dev)
            res.update(loss=first, relu=relu, grads={
                n: p.grad.cpu() for n, p in model.named_parameters()
                if p.grad is not None},
                launches=dict(spmm.gather_segment_sum.variant_launches),
                steps=len(chunks))
            epoch(store, chunks[1:])
            res["params"] = {n: p.detach().cpu()
                             for n, p in model.named_parameters()}
            out[job["label"]] = res
            continue
        spmm.reset_launch_counts()
        with relu_branches(torch, relu, replay=False):
            lsum, cnt = step(model, opt, batches[0], job["loss"])
        _sync(torch, dev)
        res.update(loss_sum=float(lsum), count=float(cnt), relu=relu,
                   grads={n: p.grad.cpu()
                          for n, p in model.named_parameters()
                          if p.grad is not None},
                   launches=dict(spmm.gather_segment_sum.variant_launches),
                   widths=dict(spmm.gather_segment_sum.width_launches))
        for b in batches[1:]:
            step(model, opt, b, job["loss"])
        _sync(torch, dev)
        res["params"] = {n: p.detach().cpu()
                         for n, p in model.named_parameters()}
        t0 = time.perf_counter()
        for _ in range(PAR_TIMED):
            step(model, opt, batches[-1], job["loss"])
        _sync(torch, dev)
        res["step_ms"] = (time.perf_counter() - t0) / PAR_TIMED * 1e3
        out[job["label"]] = res
    return out


def _combine_relu(torch, per_rank, n_local):
    """The node-sharded step's recorded ReLU inputs, rank by rank, as the
    unpartitioned step's: a call with a node axis (an axis of n_local
    rows) is the ranks' shards concatenated along it; a replicated
    (per-graph) call is rank 0's."""
    out = []
    for calls in zip(*per_rank):
        axes = [a for a, s in enumerate(calls[0].shape) if s == n_local]
        out.append(torch.cat(calls, dim=axes[0]) if axes else calls[0])
    return out


def _single_step(torch, cfg, batch, hp, loss, dev, relu=None, moved=False):
    """One optimizer step of ``cfg``'s model (from SEED) on ``batch`` on the
    card: (loss sum, count, {parameter: grad of loss sum / count}, ReLU
    flips), replaying ``relu``'s branches where given."""
    from kpgnn_tpu_torch.models.factory import make_model
    from kpgnn_tpu_torch.nn.inits import init_parameters
    from kpgnn_tpu_torch.train.loop import train_step
    from kpgnn_tpu_torch.train.state import make_optimizer

    model = init_parameters(make_model(cfg), SEED)
    model = (ulp_moved(torch, model) if moved else model).to(dev)
    opt = make_optimizer(model.parameters(), *hp)
    ctx = (relu_branches(torch, relu, replay=True) if relu is not None
           else contextlib.nullcontext([]))
    with ctx as flips:
        lsum, cnt = train_step(model, opt, batch.to(dev), loss)
    return (float(lsum), float(cnt),
            {n: p.grad.cpu() for n, p in model.named_parameters()
             if p.grad is not None}, flips)


def _count_weighted(steps):
    """The data-parallel gradient from one-device steps (``_single_step``
    results, one per rank): each rank's gradient of its mean loss
    weighted by its count over the total, i.e. the gradient of the summed
    loss over the summed count."""
    total = sum(x[1] for x in steps)
    return {n: sum(x[2][n] * (x[1] / total) for x in steps)
            for n in steps[0][2]}


def _gate(label, name, got_loss, want_loss, tol, got, ref, moved, flips,
          relu):
    """The parity bound on the loss sum (tol · max(1, |want|), the
    dryrun's), and the gradient gate (``grad_leaves``) on ``got`` against
    the replayed reference ``ref``; logs both, fails past either."""
    delta = abs(got_loss - want_loss)
    bound = tol * max(1.0, abs(want_loss))
    leaves = grad_leaves(got, ref, ref, moved, name)
    over = [t for t in leaves if t[1] > 1.0]
    flips_line, flip_rel = flip_text(flips, relu)
    log(f"[{label}] {name}: loss sum {got_loss:.7f}, one device "
        f"{want_loss:.7f}: |diff| {delta:.3e} (bound {bound:.1e}); "
        f"{flips_line} in the one-device step; {len(leaves)} gradients "
        f"under the gate, worst by |err| / tol: "
        f"{leaf_text(max(leaves, key=lambda t: t[1]))}")
    if over:
        log(f"[{label}] {name}: {len(over)} gradients outside the gate: "
            + "; ".join(leaf_text(t) for t in over))
    check(delta <= bound and not over and flip_rel <= 1e-4,
          f"{name}: loss |diff| {delta:.3e} > {bound:.1e}, or "
          f"{len(over)} gradients outside the gate, or a flipped ReLU "
          f"input {flip_rel:.2e} of its call's largest")


def _same_params(results, label):
    """Every rank's parameters bit for bit rank 0's."""
    ref = results[0][label]["params"]
    for r, res in enumerate(results[1:], 1):
        bad = [n for n, p in res[label]["params"].items()
               if not bool((p == ref[n]).all())]
        check(not bad, f"{label}: rank {r}'s parameters differ from rank "
              f"0's in {bad[:5]}")


def parallel_data(torch, zinc_train, lk, mcfg, lcfg):
    """The multi-rank legs' batches, on the host: the flagship loader's
    first 64 molecules collated COO (the node leg partitions it) beside
    the same graphs on the kernel plan (its unpartitioned reference), at
    an n_pad that puts real nodes in both halves, and the
    polymers collated COO and on the kernel plan at an n_pad that is a
    multiple of P·256 (whole banded tiles in every shard) for P = 2 and
    4; each node leg's rank-0 rectangular plan, for the kernel checks."""
    from kpgnn_tpu_torch.graph.batch import (BucketSpec, collate,
                                             collate_pallas)
    from kpgnn_tpu_torch.parallel.partition import partition_batch

    v = {"v1": lk["v1"], "vk": lk["vk"]}

    def pads(graphs, multiple):
        n = sum(g.num_nodes for g in graphs) + 1
        _, e_pad = BucketSpec().pad_sizes(n - 1, sum(g.num_edges
                                                     for g in graphs))
        return dict(n_pad=-(-n // multiple) * multiple, e_pad=e_pad,
                    g_pad=len(graphs) + 1)
    # the loader's n_pad (4,096 for 1,375 nodes) would leave rank 1 only
    # padding: the tightest n_pad whose halves hold real nodes instead
    fg = zinc_train[:BATCH]
    coo = collate(fg, **pads(fg, 128))
    pal = collate_pallas(fg, **pads(fg, 128), **v)
    polys = polymer_graphs()
    lv = {"v1": lcfg.num_hop1_edge + 2, "vk": lcfg.max_pe_num + 2}
    poly = {P: (collate(polys, **pads(polys, P * 256)),
                collate_pallas(polys, **pads(polys, P * 256), **lv))
            for P in (2, 4)}
    shard_plans = {
        "shard flagship P=2": (partition_batch(
            coo, 2, 0, pallas=v).adj.plan, H),
        "shard polymers P=2": (partition_batch(
            poly[2][0], 2, 0, pallas=lv).adj.plan, lcfg.hidden_size
            // lcfg.K),
        "shard polymers P=4": (partition_batch(
            poly[4][0], 4, 0, pallas=lv).adj.plan, lcfg.hidden_size
            // lcfg.K)}
    return SimpleNamespace(v=v, lv=lv, coo=coo, pal=pal, poly=poly,
                           shard_plans=shard_plans)


def parallel_phase(ctx):
    """[dp], [node], [dcn]: the multi-rank legs, P gloo ranks spawned on
    the one card (parallel/mesh.spawn), against one-device card steps on
    the same weights and batches (module docstring, phase 12).  Returns
    {leg label: rank-summed kernel launches by (variant, D)}."""
    import numpy as np
    from kpgnn_tpu_torch.graph.batch import _round_up
    from kpgnn_tpu_torch.parallel.mesh import spawn
    from kpgnn_tpu_torch.parallel.multihost import host_shard
    from kpgnn_tpu_torch.train.loader import GraphLoader
    from kpgnn_tpu_torch.train.resident import (build_dense_store,
                                                gather_any,
                                                parallel_epoch_index_chunks)

    torch, dev, par = ctx.torch, ctx.dev, ctx.par
    hp = (ctx.args.lr, ctx.args.l2_wd)
    lhp = (1e-3, 0.0)
    L = ctx.mcfg.num_layer
    LL = ctx.lcfg.num_layer
    LD = ctx.lcfg.hidden_size // ctx.lcfg.K
    flag = dict(cfg=ctx.mcfg, hp=hp, loss="l1")
    large = dict(cfg=ctx.lcfg, hp=lhp, loss="l1", K=ctx.lcfg.K, D=LD)
    fb = first_batches(ctx.tl, 2 * PAR_STEPS)
    n_slot = _round_up(max(g.num_nodes for g in ctx.zinc_train), 8)
    order = np.random.default_rng(SEED).permutation(len(ctx.zinc_train))
    dcn_graphs = ctx.zinc_train[:4 * BATCH]
    hosts = [list(GraphLoader(host_shard(dcn_graphs, h, 2), BATCH,
                              **ctx.lk)) for h in range(2)]
    legs = {2: [dict(flag, kind="dp", label="dp flagship P=2",
                     steps=[fb[2 * s:2 * s + 2] for s in range(PAR_STEPS)]),
                dict(flag, kind="dp resident", label="dp resident P=2",
                     graphs=ctx.zinc_train, n_slot=n_slot, v1=par.v["v1"],
                     vk=par.v["vk"], order=order, B=BATCH),
                dict(flag, kind="node", label="node flagship P=2",
                     batch=par.coo, plans={"pallas": par.v}, K=K, D=H)],
            4: [dict(flag, kind="dcn", label="dcn 2x2", hosts=hosts,
                     n_graphs=len(dcn_graphs), B=BATCH)]}
    for P in (2, 4):
        for b in ("pallas", "banded"):
            legs[P].append(dict(
                large, kind="node", plans={b: par.lv}, batch=par.poly[P][0],
                label=f"node polymers P={P} "
                      f"{'kernel plan' if b == 'pallas' else 'banded'}"))
    launches = {}
    for P, jobs in legs.items():
        t0 = time.perf_counter()
        results = spawn(_parallel_rank, P, "gloo", args=(jobs, str(dev)),
                        devices=[dev] * P, timeout=PAR_TIMEOUT)
        log(f"[parallel] {P} gloo ranks on one card ({card_line()}): "
            f"{len(jobs)} legs in {time.perf_counter() - t0:.1f} s, spawn "
            "included")
        for job in jobs:
            label = job["label"]
            _same_params(results, label)
            res = [r[label] for r in results]
            w = Counter()
            for r in res:
                w.update(r.get("widths", {}))
            launches[label] = w
            kind = job["kind"]
            if kind == "dp":
                refs = [_single_step(torch, ctx.mcfg, job["steps"][0][r],
                                     hp, "l1", dev, res[r]["relu"])
                        for r in range(P)]
                moved = [_single_step(torch, ctx.mcfg, job["steps"][0][r],
                                      hp, "l1", dev, res[r]["relu"], True)
                         for r in range(P)]
                C = sum(x[1] for x in refs)
                check(res[0]["count"] == C,
                      f"{label}: count {res[0]['count']} != {C}")
                _gate("dp", f"{label} first step", res[0]["loss_sum"],
                      sum(x[0] for x in refs), 1e-6, res[0]["grads"],
                      _count_weighted(refs), _count_weighted(moved),
                      sum((x[3] for x in refs), []),
                      sum((r["relu"] for r in res), []))
                check(res[0]["launches"] == {ctx.fused_v: L,
                                             ctx.gather_v: L},
                      f"{label}: launches {res[0]['launches']}")
                log(f"[dp] {label}: {PAR_STEPS} steps, parameters bitwise "
                    f"equal on every rank; rank 0's launches in the gated "
                    f"step {res[0]['launches']}; step {res[0]['step_ms']:.2f}"
                    f" ms (gloo, {P} ranks on one H100)")
            elif kind == "dp resident":
                store = build_dense_store(job["graphs"], n_slot, job["v1"],
                                          job["vk"], device=dev)
                chunks = parallel_epoch_index_chunks(order, BATCH, P,
                                                     store.num_graphs)
                bs = [gather_any(store, torch.as_tensor(
                    chunks[0, r], dtype=torch.long, device=dev))
                    for r in range(P)]
                refs = [_single_step(torch, ctx.mcfg, bs[r], hp, "l1", dev,
                                     res[r]["relu"]) for r in range(P)]
                moved = [_single_step(torch, ctx.mcfg, bs[r], hp, "l1", dev,
                                      res[r]["relu"], True)
                         for r in range(P)]
                C = sum(x[1] for x in refs)
                # the resident epoch reports the step's loss over its count
                _gate("dp", f"{label} first step (mean loss)",
                      res[0]["loss"], sum(x[0] for x in refs) / C, 1e-6,
                      res[0]["grads"], _count_weighted(refs),
                      _count_weighted(moved),
                      sum((x[3] for x in refs), []),
                      sum((r["relu"] for r in res), []))
                check(not res[0]["launches"],
                      f"{label}: the dense store launched "
                      f"{res[0]['launches']}")
                del store
                log(f"[dp] {label}: one epoch, {res[0]['steps']} steps of "
                    f"{P} x {BATCH} graphs gathered from a dense store, "
                    "parameters bitwise equal on every rank")
            elif kind == "dcn":
                want = sum(_single_step(torch, ctx.mcfg, b, hp, "l1", dev)[0]
                           for h in hosts for b in h)
                delta = abs(res[0]["loss_sum"] - want)
                bound = 1e-6 * max(1.0, abs(want))
                log(f"[dcn] {label} (dcn, data) mesh, host_shard_loader: "
                    f"first group's loss sum {res[0]['loss_sum']:.7f}, the "
                    f"one-device steps' {want:.7f}: |diff| {delta:.3e} "
                    f"(bound {bound:.1e}); parameters bitwise equal on "
                    f"every rank; step {res[0]['step_ms']:.2f} ms (gloo, "
                    f"{P} ranks on one H100)")
                check(delta <= bound, f"{label}: loss sum |diff| "
                      f"{delta:.3e} > {bound:.1e}")
            else:
                big = par.pal if "flagship" in label else par.poly[P][1]
                cfg = job["cfg"]
                n_local = res[0]["n_local"]
                relu = _combine_relu(torch, [r["relu"] for r in res],
                                     n_local)
                ref = _single_step(torch, cfg, big, job["hp"], "l1", dev,
                                   relu)
                moved = _single_step(torch, cfg, big, job["hp"], "l1", dev,
                                     relu, True)
                _gate("node", label, res[0]["loss_sum"], ref[0], 1e-5,
                      res[0]["grads"], ref[2], moved[2], ref[3], relu)
                kernel = "banded" not in label
                nl = L if "flagship" in label else LL
                want = ({ctx.fused_v: nl, ctx.gather_v: nl} if kernel
                        and job["D"] * 4 % 16 == 0 else None)
                got = [r["launches"] for r in res]
                if kernel:
                    check(all(sum(g.values()) == 2 * nl for g in got)
                          and (want is None or all(g == want for g in got)),
                          f"{label}: per-rank launches {got}, expected "
                          f"{nl} fused + {nl} gather on each")
                else:
                    check(not any(got), f"{label}: launched {got}")
                log(f"[node] {label}: halo B {res[0]['halo']}, "
                    f"boundary_total {res[0]['boundary']}, n_local "
                    f"{n_local}, n_ext {res[0]['n_ext']}; comm bytes per "
                    f"layer {res[0]['comm']} against the full-table psum's "
                    f"{res[0]['psum']}; partition + plan on the host "
                    f"{res[0]['partition_s']:.3f} s; launches per rank "
                    f"{got}; step {res[0]['step_ms']:.2f} ms (gloo, {P} "
                    "ranks on one H100)")
    return launches


def parallel_scripts_phase(ctx):
    """[parallel scripts]: train_zinc --parallel data, then --parallel
    node --backend pallas, one epoch each, a group of one on NCCL in this
    process: ``script_phase``'s gates, and a first-step loss equal to the
    run without --parallel (rtol 1e-4)."""
    import torch.distributed as dist

    out = {}
    try:
        for label, extra in (("data", ["--parallel", "data"]),
                             ("node", ["--parallel", "node", "--backend",
                                       "pallas"])):
            sl = SimpleNamespace(**vars(ctx.zinc))
            sl.argv = ctx.zinc.argv + extra + ["--save_dir", os.path.join(
                ctx.work, f"par_{label}")]
            _, losses, _, w = ctx.script_phase(f"parallel scripts {label}",
                                               sl, ())
            check(dist.is_initialized() and dist.get_backend() == "nccl"
                  and dist.get_world_size() == 1,
                  f"--parallel {label} did not run on a one-rank NCCL group")
            rel = abs(losses[0] - ctx.zlosses[0]) / abs(ctx.zlosses[0])
            log(f"[parallel scripts] --parallel {label}: first-step loss "
                f"{losses[0]:.7f}, without --parallel {ctx.zlosses[0]:.7f} "
                f"(rel diff {rel:.2e}); NCCL, world size 1")
            check(rel <= 1e-4, f"--parallel {label}: first-step loss rel "
                  f"diff {rel:.2e} > 1e-4")
            out[label] = w
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


# tune_pallas runs of [tools]: the JAX tuner's defaults (K=8 D=104, the
# flagship's widths) and TU-narrow, each at its default points (the gather
# and the fused form on one 64-molecule batch)
TUNE_RUNS = {"defaults": [], "tu": ["--K", "2", "--hidden_size", "16"]}
SCALING_RANKS = "1,2,4"     # the JAX script's 1,2,4,8, cut for the time


def tool_plans(dev):
    """The kernel plans [tools] launches on, each with its row width D:
    tune_pallas's batch at each TUNE_RUNS width (its 64 synthetic
    molecules at K hops) and scaling_estimate's ici-mode polymer (the
    1/8-size polymer of its link projection, D=104).  Returns {label:
    (plan on dev, D)}."""
    from kpgnn_tpu_torch.data.synthetic import (synthetic_molecules,
                                                synthetic_polymers)
    from kpgnn_tpu_torch.graph.batch import collate_pallas
    from kpgnn_tpu_torch.prep.khop import KHopConfig
    from kpgnn_tpu_torch.scripts import scaling_estimate as se
    from kpgnn_tpu_torch.scripts import tune_pallas as tp

    out = {}
    for label, argv in TUNE_RUNS.items():
        a = dict(zip(argv[::2], argv[1::2]))
        K, D = int(a.get("--K", 8)), int(a.get("--hidden_size", 104))
        graphs = synthetic_molecules(64, KHopConfig(
            K=K, kernel="spd", max_edge_attr_num=30, max_hop_num=6,
            max_edge_type=3, max_edge_count=20, max_distance_count=30),
            seed=0)
        out[f"tune_pallas {label}"] = (collate_pallas(
            graphs, v1=tp.V1, vk=tp.VK).adj.to(dev), D)
    poly = synthetic_polymers(1, 65536 // 8, K=3, seed=0)
    out["scaling_estimate ici"] = (collate_pallas(
        poly, v1=se.V1, vk=se.VK).adj.to(dev), 104)
    return out


def tune_phase(ctx):
    """[tools] tune_pallas: ``tune_pallas.main`` at its defaults (K=8
    D=104) and at TU's width (--K 2 --hidden_size 16): a row per point
    (the gather and the fused form on the 64-molecule batch) with
    positive rates, and the best.  Returns {label: rows}."""
    from kpgnn_tpu_torch.scripts import tune_pallas

    out = {}
    for label, argv in TUNE_RUNS.items():
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rows = tune_pallas.main(argv)
        check(list(rows) == ["gather/64", "fused/64"] and all(
            r["fwd_edges_per_s"] > 0 and r["fwdbwd_edges_per_s"] > 0
            for r in rows.values()), f"tune_pallas {argv}: {rows}")
        out[label] = rows
        log(f"[tools] tune_pallas {' '.join(argv) or '(defaults)'} "
            f"({ctx.card}) in {time.perf_counter() - t0:.1f} s:\n"
            + "\n".join(f"[tune_pallas] {x}"
                        for x in buf.getvalue().splitlines()))
    return out


def scaling_phase(ctx):
    """[tools] scaling_estimate: ``main(["--mode", "both", "--ranks",
    SCALING_RANKS])``: every weak row names its backend (NCCL at P=1, the
    card machine's one card; gloo ranks sharing cuda:0 above) and the
    card, with a positive overhead factor; the link projection's halo,
    boundary, union-edge, comm and psum numbers equal a direct
    ``partition_adj`` of the same polymer here."""
    import numpy as np
    from kpgnn_tpu_torch.data.synthetic import synthetic_polymers
    from kpgnn_tpu_torch.graph.batch import collate
    from kpgnn_tpu_torch.parallel.partition import partition_adj
    from kpgnn_tpu_torch.scripts import scaling_estimate as se

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = se.main(["--mode", "both", "--ranks", SCALING_RANKS])
    secs = time.perf_counter() - t0
    kind = ctx.torch.cuda.get_device_name(0)
    for mode in ("data_parallel", "node_sharded"):
        for P in SCALING_RANKS.split(","):
            row = out[mode][P]
            want = "nccl" if int(P) <= ctx.torch.cuda.device_count() \
                else "gloo"
            check(row["backend"] == want and row["device"] == kind
                  and row["overhead_factor"] > 0,
                  f"scaling_estimate {mode} P={P}: {row}")
    link = out["ici_projection"]
    coo = collate(synthetic_polymers(1, 65536, K=3, seed=0))
    sh = partition_adj(coo.adj, 8, 0)
    want = {"union_edges": int(np.asarray(coo.adj.edge_mask).sum()),
            "halo_rows": sh.halo, "boundary_rows": sh.boundary_total(),
            "comm_bytes_per_device_per_layer":
                sh.comm_elems_per_layer(3, 104) * 4,
            "full_table_psum_bytes_would_be":
                sh.psum_elems_per_layer(3, 104) * 4}
    got = {k: link[k] for k in want}
    check(got == want, f"scaling_estimate link numbers {got} != the "
          f"partition's {want}")
    check(link["device"] == kind, f"link projection on {link['device']}")
    log(f"[tools] scaling_estimate --mode both --ranks {SCALING_RANKS} "
        f"({ctx.card}) in {secs:.1f} s; link numbers equal partition_adj's "
        f"{want}:\n[scaling_estimate] " + json.dumps(out))
    return out


def parity_golden_phase(ctx):
    """[tools] make_parity_golden: ``--all`` on the card and with
    ``--device cpu`` into the scratch dir.  Each card bundle replays on
    the card within 1e-6 (``replay_bundle``), holds the CPU bundle's keys,
    its parameters bit for bit and its activations within atol 1e-5 /
    rtol 1e-4.  The card's builds and replays run under default
    algorithms: the bundles' COO aggregation adds through the sorted
    segment sum, in one order, and a replay checks that the bundle is
    reproducible."""
    import numpy as np
    from kpgnn_tpu_torch.scripts import make_parity_golden as mpg

    dirs = {d: os.path.join(ctx.work, f"golden_{d}") for d in ("cuda", "cpu")}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        card = mpg.main(["--all", "--out_dir", dirs["cuda"]])
        replays = [mpg.replay_bundle(pc, device=ctx.dev) for pc in card]
        cpu = mpg.main(["--all", "--out_dir", dirs["cpu"], "--device",
                        "cpu"])
    check(len(card) == len(cpu) == len(mpg.CONFIGS),
          f"make_parity_golden wrote {card} and {cpu}")
    notes = []
    for pc, pp, replay in zip(card, cpu, replays):
        name = os.path.basename(pc)[:-4]
        gc, gp = np.load(pc), np.load(pp)
        check(set(gc.files) == set(gp.files),
              f"golden {name}: card and CPU bundles hold other keys")
        worst = 0.0
        for k in gc.files:
            a, b = gc[k], gp[k]
            if k.startswith("act/") and np.issubdtype(b.dtype, np.floating):
                np.testing.assert_allclose(
                    a, b, atol=1e-5, rtol=1e-4,
                    err_msg=f"golden {name} {k}: card against CPU")
                worst = max(worst, float(np.abs(a - b).max()))
            else:       # parameters, raw graph, meta, node mask: exact
                check(a.dtype == b.dtype and np.array_equal(a, b),
                      f"golden {name} {k}: card and CPU differ")
        notes.append(f"{name} replay {replay:.1e} card-CPU {worst:.1e}")
    log(f"[tools] make_parity_golden --all on the card (default "
        f"algorithms) and the CPU: {len(card)} bundles, parameters bitwise "
        f"equal; max |diff| " + "; ".join(notes))
    return card


def tools_phase(ctx):
    """13. [tools]: the three tool scripts on the card, the counts set to
    0 before each and read after it.  tune_pallas must launch the gather
    and the fused form at each of its widths, scaling_estimate's ici mode
    both at D=104.  Returns {script: launches by (variant, D)}."""
    spmm = ctx.spmm
    out = {}
    for name, phase in (("tune_pallas", tune_phase),
                        ("scaling_estimate", scaling_phase),
                        ("make_parity_golden", parity_golden_phase)):
        spmm.reset_launch_counts()
        phase(ctx)
        out[name] = +Counter(spmm.gather_segment_sum.width_launches)
        ctx.mark(f"tools {name}")
    for label, (_, D) in ctx.tool_plans.items():
        w = out[label.split()[0]]
        check(w[ctx.fused_v, D] > 0 and w[ctx.gather_v, D] > 0,
              f"[tools] {label} launched no {ctx.fused_v} or "
              f"{ctx.gather_v} at D={D}: {dict(w)}")
    log("[tools] launches by (variant, D): " + "; ".join(
        f"{name} " + (", ".join(f"{v} D={d}: {n}" for (v, d), n in
                                sorted(w.items())) or "none")
        for name, w in out.items()))
    return out


CARD_TESTS = ("tests/test_torch_kernel_cuda.py",
              "tests/test_torch_segment_cuda.py",
              "tests/test_torch_lstm_cuda.py")


def kernel_tests():
    """The CARD_TESTS files in a pytest process of their own (without the
    JAX package's conftest and the xdist options): its exit code, passed
    count, summary line and output."""
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "--noconftest", "-o", "addopts=", *CARD_TESTS],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    summary = lines[-1] if lines else ""
    m = re.search(r"(\d+) passed", summary)
    return (proc.returncode, int(m.group(1)) if m else 0, summary,
            proc.stdout[-3000:] + proc.stderr[-2000:])


def det_steps(torch, mcfg, batches, dev, loss="l1"):
    """``len(batches)`` Adam steps of the model ``mcfg`` from SEED on
    ``dev`` (dropout from a generator seeded with SEED): the losses and
    the parameters after them (flat, on the CPU)."""
    from kpgnn_tpu_torch.models.factory import make_model
    from kpgnn_tpu_torch.nn.inits import init_parameters
    from kpgnn_tpu_torch.train.loop import train_step
    from kpgnn_tpu_torch.train.state import make_optimizer

    model = init_parameters(make_model(mcfg), SEED).to(dev)
    opt = make_optimizer(model.parameters(), 1e-3)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    losses = []
    for b in batches:
        lsum, cnt = train_step(model, opt, b.to(dev), loss, gen)
        losses.append(float(lsum / cnt))
    return losses, torch.cat([p.detach().flatten().cpu()
                              for p in model.parameters()])


def det_compare(runs):
    """(the first step whose losses differ, 1-based, or None; |loss
    difference| per step; the largest |parameter difference| after the
    steps) of two ``det_steps`` runs."""
    (la, pa), (lb, pb) = runs
    diffs = [abs(a - b) for a, b in zip(la, lb)]
    first = next((i + 1 for i, d in enumerate(diffs) if d), None)
    return first, diffs, float((pa - pb).abs().max())


def det_text(first, diffs, dparam):
    return (f"first differing step {first or 'none'}, |loss diff| per "
            f"step " + ", ".join(f"{d:.3e}" for d in diffs)
            + f", max |param diff| after them {dparam:.3e}")


def determinism_child(path):
    """The [determinism] steps of the batches pickled at ``path`` (with
    the model config and the device), twice under
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` (run with
    CUBLAS_WORKSPACE_CONFIG set); prints one JSON line: the comparison
    and the ops that warn of no deterministic implementation."""
    import torch
    from kpgnn_tpu_torch.scripts.common import set_full_f32

    with open(path, "rb") as f:
        mcfg, batches, dev = pickle.load(f)
    set_full_f32()
    dev = torch.device(dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        det = det_compare([det_steps(torch, mcfg, batches, dev)
                           for _ in range(2)])
    torch.use_deterministic_algorithms(False)
    warned = sorted({str(w.message).split(" does not have")[0]
                     for w in caught if "deterministic" in str(w.message)})
    print(json.dumps(dict(deterministic=det, warned=warned)))


def api_phase(ctx):
    """[api]: the flagship at full width through the top-level names only
    (kt.KHopConfig / kt.extract_khop -> kt.GraphLoader -> kt.make_model(
    kt.ModelConfig) -> kt.Trainer), one epoch on the [train] run's first
    two batches: the prep equal to the script's, the config the
    flagship's, count_parameters the JAX count, 2L fused + 2L gather
    launches, the first-step loss [train]'s (rtol 1e-4), and the train
    step on the card's clock.  Returns its launches by (variant, D)."""
    import numpy as np
    import kpgnn_tpu_torch as kt
    from kpgnn_tpu_torch.train.loop import train_step
    from kpgnn_tpu_torch.train.state import make_optimizer

    torch, spmm, args, tl = ctx.torch, ctx.spmm, ctx.args, ctx.tl
    fused_v, gather_v = ctx.fused_v, ctx.gather_v
    order = np.arange(len(ctx.zinc_train))
    np.random.default_rng(SEED).shuffle(order)      # the run's first epoch
    idx = order[:2 * BATCH]
    khop = kt.KHopConfig(
        K=K, kernel="spd", max_edge_attr_num=args.max_pe_num,
        max_hop_num=args.max_hop_num, max_edge_type=args.max_edge_type,
        max_edge_count=args.max_edge_count,
        max_distance_count=args.max_distance_count)
    graphs = [kt.extract_khop(r["num_nodes"], r["edge_index"],
                              r["edge_attr"], khop, x=r["x"], y=r["y"])
              for r in (ctx.splits["train"][i] for i in idx)]
    check(same_graphs(graphs, [ctx.zinc_train[i] for i in idx]),
          "api: kt.extract_khop differs from the script's prep")
    cfg = kt.ModelConfig(
        model_name="KPGINPlus", hidden_size=H, num_layer=L, K=K,
        combine="attention", aggr="add", JK="concat", residual=True,
        num_hop1_edge=args.num_hop1_edge, max_pe_num=args.max_pe_num,
        max_edge_type=args.max_edge_type, max_edge_count=args.max_edge_count,
        max_hop_num=args.max_hop_num,
        max_distance_count=args.max_distance_count,
        input_encoder=("embedding", 21), task="graph_regression")
    check(cfg == ctx.mcfg, f"api: {cfg} is not the flagship's {ctx.mcfg}")
    loader = kt.GraphLoader(graphs, BATCH, mode="pallas",
                            v1=cfg.num_hop1_edge + 2, vk=cfg.max_pe_num + 2,
                            n_pad=tl.n_pad, e_pad=tl.e_pad)
    model = kt.make_model(cfg)
    n_params = kt.train.count_parameters(model)
    check(n_params == FLAGSHIP_PARAMS, f"api: count_parameters {n_params} "
          f"!= the flagship's {FLAGSHIP_PARAMS}")
    rows = []
    spmm.reset_launch_counts()
    model, _ = kt.Trainer(
        model, kt.TrainConfig(lr=args.lr, num_epochs=1, batch_size=BATCH,
                              seed=SEED),
        loss="l1", device=str(ctx.dev)).fit(
            loader, seed=SEED,
            epoch_callback=lambda e, m, row: rows.append(row))
    torch.cuda.synchronize()
    v = dict(spmm.gather_segment_sum.variant_launches)
    w = +Counter(spmm.gather_segment_sum.width_launches)
    losses = rows[0]["step_losses"]
    expect = {fused_v: 2 * L, gather_v: 2 * L}
    rel = abs(losses[0] - ctx.zloss) / abs(ctx.zloss)
    # the step on the card's clock: CUDA events over 10 steps on the first
    # batch, after 3
    opt = make_optimizer(model.parameters(), args.lr)
    batch = first_batch(loader).to(ctx.dev)
    for _ in range(3):
        train_step(model, opt, batch)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(10):
        train_step(model, opt, batch)
    ev[1].record()
    torch.cuda.synchronize()
    step_ms = ev[0].elapsed_time(ev[1]) / 10
    log(f"[api] kt.extract_khop -> kt.GraphLoader(mode='pallas') -> "
        f"kt.make_model(kt.ModelConfig) -> kt.Trainer: {len(idx)} "
        f"molecules, {len(losses)} steps, losses "
        + ", ".join(f"{x:.7f}" for x in losses)
        + f"; first-step loss {losses[0]:.7f}, [train]'s {ctx.zloss:.7f} "
        f"(rel diff {rel:.2e}); count_parameters {n_params}; kernel "
        f"launches {v} (expected {expect}); train step {step_ms:.3f} ms "
        f"(CUDA events, 10 steps)")
    check(v == expect and set(w) <= {(fused_v, H), (gather_v, H)},
          f"api: kernel launches {v} {dict(w)} != {expect}")
    check(np.isfinite(losses).all() and rel <= 1e-4,
          f"api: first-step loss {rel:.2e} from [train]'s > 1e-4")
    return w


def det_legs(ctx):
    """The [determinism] legs beyond the flagship on pallas, each an
    edge -> node sum that adds through ``sorted_segment_sum`` on the
    card: (label, model config, batches, loss).  The flagship on
    ``--backend coo`` (its first DET_STEPS batches); banded on the
    polymer batch with halo 0, so that every cross-tile edge spills (the
    auto halo leaves it no spill); KPGCN on the CSL kernel plan (the
    weighted histograms of its sender scale)."""
    from kpgnn_tpu_torch.graph.batch import collate_banded
    from kpgnn_tpu_torch.scripts import common, train_csl
    from kpgnn_tpu_torch.scripts import profile_step as ps
    from kpgnn_tpu_torch.train.loader import GraphLoader

    coo = GraphLoader(ctx.tl.graphs, BATCH, shuffle=True, seed=SEED,
                      mode="coo")
    lcfg = ps.large_config()
    poly = collate_banded(polymer_graphs(), v1=lcfg.num_hop1_edge + 2,
                          vk=lcfg.max_pe_num + 2, halo=0)
    fargs = train_csl.parser().parse_args(csl_argv(
        os.path.join(ctx.work, "csl"), "cuda", "pallas", "KPGCN"))
    fcfg = common.model_config(fargs, input_encoder=("linear", 1),
                               task="graph_classification", output_size=10)
    # CSL's fold-0 train split fills 2 batches: they take turns
    csl = first_batches(ctx.ctl, min(DET_STEPS, len(ctx.ctl)))
    return [("coo", ctx.mcfg, first_batches(coo, DET_STEPS), "l1"),
            ("banded spill", lcfg, [poly] * DET_STEPS, "l1"),
            ("KPGCN plan", fcfg, [csl[i % len(csl)]
                                  for i in range(DET_STEPS)],
             "cross_entropy")]


def sorted_sum_uses(torch, legs):
    """The sorted segment sum's inputs on each leg's first batch, as its
    path gives them: (label, ids, segments, indptr, rows E, {(variant,
    D): launches a run}).  The COO messages (E, k, H) of each hop window,
    summed as (E, k*H) rows into the nodes (the [determinism] coo leg in
    f32, the [bf16] COO step in bf16); the banded spill's rows into the
    K*N hop-major rows; KPGCN's sender scales into the plan's (receiver
    row, attr code) bins (``KHopPlan.hist_bins``)."""
    out = []
    for label, (batch, w) in legs.items():
        adj = batch.adj
        if label.startswith("coo"):
            ids, n, indptr = adj.receivers, adj.n_nodes, adj.indptr
        elif label == "banded spill":
            ids, n = adj.spill_rows, adj.n_hops * adj.n_nodes
            indptr = adj.spill_indptr
        else:
            h = adj.hist_bins()
            ids, indptr, n = h.seg, h.indptr, h.row.shape[0]
        out.append((label, ids, n, indptr, ids.shape[0], dict(sorted(
            w.items(), key=lambda kv: (kv[0][1], kv[0][0])))))
    return out


def sorted_sum_times(ctx, legs):
    """The sorted segment sum at each use of ``sorted_sum_uses``, on
    random rows of each (variant, width) its leg launched, in the
    variant's dtype: the card against the plain version
    (``sorted_segment_sum_reference``) on the CPU copy of the same inputs
    (max |err|; tolerance 1e-5 plus 1e-6 of the largest segment's sum of
    |terms|, and for bf16 one bf16 ulp, 2**-7, of the largest |sum|;
    whether bit for bit), its time, the plain version's on the card
    (``index_add_`` of the CSR's rows, accumulated in f32 as the sum
    does), the library call's (the ``index_add_`` the path ran before:
    every row, the ids past the last segment into one trash row) and
    the bound (``sorted_sum_bound_ms``).  Returns the ``kernels``
    entries."""
    from kpgnn_tpu_torch.ops import spmm
    from kpgnn_tpu_torch.ops.segment import (sorted_segment_sum,
                                             sorted_segment_sum_reference)

    torch = ctx.torch
    gen = torch.Generator(device=ctx.dev).manual_seed(9)
    entries = []
    for label, ids, n, indptr, E, widths in sorted_sum_uses(torch, legs):
        lo, hi = int(indptr[0]), int(indptr[-1])
        live = ids[lo:hi].long()
        trash = ids.long().clamp(0, n)
        for (variant, D), launches in widths.items():
            dt = torch.bfloat16 if "bf16" in variant else torch.float32
            xs = [torch.randn(E, D, device=ctx.dev, generator=gen).to(dt)
                  for _ in range(3)]
            got = sorted_segment_sum(xs[0], ids, n, indptr).cpu().float()
            want = sorted_segment_sum_reference(xs[0].cpu(), ids.cpu(), n,
                                                indptr.cpu()).float()
            absum = sorted_segment_sum_reference(
                xs[0].abs().cpu().float(), ids.cpu(), n, indptr.cpu())
            err = float((got - want).abs().max())
            tol = 1e-5 + 1e-6 * float(absum.max())
            if dt == torch.bfloat16:
                tol += 2.0 ** -7 * float(want.abs().max())
            ms = time_ms(torch, lambda x: sorted_segment_sum(
                x, ids, n, indptr), xs)
            plain = time_ms(torch, lambda x: torch.zeros(
                n, D, device=ctx.dev).index_add_(0, live, x[lo:hi].float()
                                                  ).to(dt), xs)
            lib = time_ms(torch, lambda x: torch.zeros(
                n + 1, D, device=ctx.dev).index_add_(0, trash, x.float()
                                                      ).to(dt), xs)
            bound, by = sorted_sum_bound_ms(n, hi - lo, D,
                                            xs[0].element_size())
            # the same kernel variant, named for this use
            name = variant.replace("gather_segment_sum", "sorted_segment_sum")
            log(f"[time] {name} {label} D={D} ({E} rows, "
                f"{hi - lo} in the CSR, {n} segments; {launches} launches "
                f"a run): {ms:.4f} ms, plain {plain:.4f} ms, index_add_ "
                f"{lib:.4f} ms, bound {bound:.5f} ms ({by}); max |err| "
                f"against the CPU's plain version {err:.2e} (tol "
                f"{tol:.1e}){', bit for bit' if err == 0 else ''}")
            check(err <= tol, f"sorted_segment_sum {label} D={D}: max "
                  f"|err| {err:.3e} > {tol:.3e}")
            entries.append(dict(
                name=f"{name} D={D} {label}", variant=variant,
                **KERNEL, shape=f"{label}: {E} rows into {n} segments, "
                f"D={D}", launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib))
    return entries


LSTM_ITERS = 100       # [lstm]: timed calls a variant and shape
LSTM = dict(route="cuda", source="kpgnn_tpu_torch/csrc/bilstm.cu",
            # no TPU kernel: the JAX package's lax.scan, and cuDNN here
            replaces="kpgnn_tpu/ops/lstm.py:100")


def lstm_bound_ms(T, B, H, nbytes, kind):
    """(the least time of one BiLSTM kernel launch on the card in ms, what
    bounds it): the bytes the function needs to move (each input read
    once, each output written once), given that the forward keeps y and c
    for the backward, over HBM_BYTES_PER_S against its f32 operations over
    F32_FLOPS.  Forward ("fwd"): reads xg (T, B, 8H), W_hh and b_hh,
    writes y and c (T, B, 2H each); 8H^2 + 21H operations a sequence,
    direction and step (the gate products, sums, nonlinearities and the
    cell).  Backward ("bwd"): reads dy, y and c (T, B, 2H each), xg (to
    recompute the gates) and W_hh, writes dxg (T, B, 8H) and dW_hh and
    db_hh in f32; 16H^2 + 24H operations (dh, dW_hh, the gate
    gradients).  On either side the kernel's own choices are not counted:
    the forward's saved activations (``lstm_saved_bytes``, which the
    backward reads in place of xg, the same bytes) and the backward's
    per-block partials."""
    tb = T * B
    if kind == "fwd":
        moved = (tb * 8 * H + 2 * tb * 2 * H + 8 * H * (H + 1)) * nbytes
        ops = 2 * tb * (8 * H * H + 21 * H)
    else:
        moved = ((3 * tb * 2 * H + 2 * tb * 8 * H + 8 * H * H) * nbytes
                 + 2 * (4 * H * H + 4 * H) * 4)
        ops = 2 * tb * (16 * H * H + 24 * H)
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def lstm_saved_bytes(T, B, H, nbytes):
    """Bytes of the activations (i, f, g, o a step, (T, B, 8H)) that the
    kernel's forward saves for its backward beyond y and c."""
    return T * B * 8 * H * nbytes


def lstm_phase(ctx):
    """[lstm]: the BiLSTM kernel (csrc/bilstm.cu) against its plain version
    on the card, at the main path's shapes: for each of ``ctx.lstm_cases``
    ({label: (model config, batch)}) one train step of the model
    (initialized from SEED) on the card, its BiLSTMs' inputs recorded, and
    the call with the longest sequence taken: its recurrence input xg
    (``input_projection`` of the recorded input with the module's
    weights) and a random dy, in f32 and in bf16.  The kernel's y, dxg,
    dW_hh and db_hh (``recurrence`` under autograd) against the plain
    version in the same dtype and in float64 on the same values: the
    kernel's largest error from float64 at most twice the plain
    version's own plus one ulp of the dtype at the output's scale (the
    two sum the gate products in other orders; the kernel rounds where
    the plain cell's ops round, and its bf16 backward computes in f32);
    a second run equal bit for bit.  Times on CUDA events (LSTM_ITERS
    calls): the forward launch (saving the backward's inputs, and an eval
    forward that saves nothing) and the backward launch (with the sum of
    its partials), beside their byte bound, the plain version's
    (``recurrence_reference``, ``bilstm_backward_reference``) and cuDNN's
    (``torch._VF.lstm`` on the same sequence and weights: its forward in
    train mode, and its backward through autograd).  cuDNN's calls also
    do the products the kernel leaves to ``torch.matmul`` (forward: the
    input projection; backward: dx, dW_ih and db_ih), timed apart as
    ``projection_ms``.  Then a hidden size of 17 must raise.  Returns
    ({(label, dtype name, "fwd" | "bwd"): kernels-line entry without its
    launches}, {label: BiLSTM kernel launches by (variant, T, H) of the
    train step})."""
    torch, dev = ctx.torch, ctx.dev
    from kpgnn_tpu_torch.models.factory import make_model
    from kpgnn_tpu_torch.nn.inits import init_parameters
    from kpgnn_tpu_torch.ops import lstm
    from kpgnn_tpu_torch.train.loop import train_step
    from kpgnn_tpu_torch.train.state import make_optimizer

    def run(fn, xg, w_hh, b_hh, dy):
        leaves = [t.detach().clone().requires_grad_() for t in
                  (xg, w_hh, b_hh)]
        y = fn(*leaves)
        y.backward(dy.to(y.dtype))
        return [y.detach()] + [t.grad for t in leaves]

    gen = torch.Generator(device=dev).manual_seed(SEED)
    ulp = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -8}
    entries, step_launches = {}, {}
    for label, (cfg, batch) in ctx.lstm_cases.items():
        model = init_parameters(make_model(cfg), SEED).to(dev)
        calls = []

        def record(mod, args, kwargs):
            tm = kwargs.get("time_major", args[1] if len(args) > 1
                            else False)
            calls.append((mod, args[0].detach().float(), tm))
        hooks = [m.register_forward_pre_hook(record, with_kwargs=True)
                 for m in model.modules() if isinstance(m, lstm.BiLSTM)]
        lstm.reset_launch_counts()
        try:
            train_step(model, make_optimizer(model.parameters(), 1e-3),
                       batch.to(dev))
        finally:
            for h in hooks:
                h.remove()
        torch.cuda.synchronize()
        step_launches[label] = +Counter(lstm.launches)
        per_variant = Counter()
        for (vname, _, _), n in step_launches[label].items():
            per_variant[vname] += n
        check(dict(per_variant) == {
            lstm.variant_name("fwd", torch.float32): len(calls),
            lstm.variant_name("bwd", torch.float32): len(calls)},
            f"lstm {label}: the train step launched {dict(per_variant)} "
            f"for {len(calls)} BiLSTM calls")
        mod, x, tm = max(calls, key=lambda c: c[1].shape[0 if c[2] else 1])
        seq = x if tm else x.transpose(0, 1)
        for dt in (torch.float32, torch.bfloat16):
            dname = "f32" if dt == torch.float32 else "bf16"
            w_ih, w_hh, b_ih, b_hh = (t.detach() for t in mod.weights(dt))
            with torch.no_grad():
                xg = lstm.input_projection(seq.to(dt), w_ih, b_ih
                                           ).contiguous()
            T, B, _ = xg.shape
            H = w_hh.shape[2]
            dy = torch.randn(T, B, 2 * H, device=dev, generator=gen).to(dt)
            exact = run(lstm.recurrence_reference,
                        *(t.double() for t in (xg, w_hh, b_hh, dy)))
            plain = run(lstm.recurrence_reference, xg, w_hh, b_hh, dy)
            got = run(lstm.recurrence, xg, w_hh, b_hh, dy)
            again = run(lstm.recurrence, xg, w_hh, b_hh, dy)
            torch.cuda.synchronize()
            notes, worst = [], {"fwd": 0.0, "bwd": 0.0}
            for name, g, p, e, a in zip(("y", "dxg", "dW_hh", "db_hh"), got,
                                        plain, exact, again):
                err = float((g.double() - e).abs().max())
                own = float((p.double() - e).abs().max())
                diff = float((g.double() - p.double()).abs().max())
                tol = 2 * own + ulp[dt] * float(e.abs().max())
                kind = "fwd" if name == "y" else "bwd"
                worst[kind] = max(worst[kind], diff)
                notes.append(f"{name} kernel {err:.2e}, plain {own:.2e} "
                             f"from float64 (tol {tol:.2e}), kernel - plain "
                             f"{diff:.2e}")
                check(err <= tol, f"lstm {label} {dname} {name}: the "
                      f"kernel errs {err:.3e} from float64, the plain "
                      f"version {own:.3e} (tol {tol:.3e})")
                check(torch.equal(g, a), f"lstm {label} {dname} {name}: a "
                      f"second run differs")
            sx = seq.to(dt)
            with torch.no_grad():
                y, act, cst = lstm.launch_forward(xg, w_hh, b_hh, save=True)
                eval_ms = time_ms(torch, lambda _: lstm.launch_forward(
                    xg, w_hh, b_hh, save=False), [None], iters=LSTM_ITERS)
                # the products outside the kernel; act stands in for dxg
                # (the same shape and dtype) in the backward's
                proj_ms = {
                    "fwd": time_ms(torch, lambda _: lstm.input_projection(
                        sx, w_ih, b_ih), [None], iters=LSTM_ITERS),
                    "bwd": time_ms(torch, lambda _: (
                        act @ w_ih, act.flatten(0, 1).T @ sx.flatten(0, 1),
                        act.sum((0, 1))), [None], iters=LSTM_ITERS)}
                ms = {"fwd": time_ms(torch, lambda _: lstm.launch_forward(
                    xg, w_hh, b_hh, save=True), [None], iters=LSTM_ITERS),
                    "bwd": time_ms(torch, lambda _: lstm.launch_backward(
                        dy, y, act, cst, w_hh), [None], iters=LSTM_ITERS)}
                plain_ms = {
                    "fwd": time_ms(torch, lambda _: lstm.recurrence_reference(
                        xg, w_hh, b_hh), [None], iters=LSTM_ITERS),
                    "bwd": time_ms(torch, lambda _:
                                   lstm.bilstm_backward_reference(
                                       xg, w_hh, b_hh, dy), [None],
                                   iters=LSTM_ITERS)}
            flat = [p.detach().to(dt).requires_grad_()
                    for p in mod.lstm._flat_weights]
            sq = seq.to(dt).detach().requires_grad_()
            h0 = sq.new_zeros(2, B, H)

            def cudnn(_=None):
                return torch._VF.lstm(sq, (h0, h0), flat, True, 1, 0.0,
                                      True, True, False)[0]
            yc = cudnn()
            lib_ms = {"fwd": time_ms(torch, cudnn, [None], iters=LSTM_ITERS),
                      "bwd": time_ms(torch, lambda _: torch.autograd.grad(
                          yc, [sq] + flat, dy, retain_graph=True), [None],
                          iters=LSTM_ITERS)}
            times = []
            for kind in ("fwd", "bwd"):
                bound, by = lstm_bound_ms(T, B, H, xg.element_size(), kind)
                vname = lstm.variant_name(kind, dt)
                entries[label, dname, kind] = dict(
                    name=f"{vname} T={T} H={H} {label}", variant=vname,
                    **LSTM, shape=f"{label}: T={T}, B={B}, F={seq.shape[2]}, "
                    f"H={H}", max_abs_err=worst[kind], ms=ms[kind],
                    plain_ms=plain_ms[kind], bound_ms=bound, bound_by=by,
                    library_ms=lib_ms[kind], projection_ms=proj_ms[kind],
                    T=T, H=H)
                extra = ""
                if kind == "fwd":
                    saved = lstm_saved_bytes(T, B, H, xg.element_size())
                    extra = (f"; eval forward, nothing saved, {eval_ms:.4f} "
                             f"ms; the saved activations {saved / 1e6:.2f} "
                             f"MB, {saved / HBM_BYTES_PER_S * 1e3:.4f} ms "
                             f"at the memory rate")
                times.append(f"{kind} {ms[kind]:.4f} ms (bound "
                             f"{bound:.4f} by {by}{extra}, plain "
                             f"{plain_ms[kind]:.4f}, cuDNN "
                             f"{lib_ms[kind]:.4f} against kernel + "
                             f"matmuls {ms[kind] + proj_ms[kind]:.4f})")
            log(f"[lstm] {label} {dname}: T={T} B={B} F={seq.shape[2]} "
                f"H={H} ({'time' if tm else 'batch'}-major); "
                + "; ".join(notes) + "; a repeat bit for bit; times: "
                + ", ".join(times))
    xg17 = torch.zeros(2, 3, 8 * 17, device=dev)
    try:
        lstm.recurrence(xg17, torch.zeros(2, 68, 17, device=dev),
                        torch.zeros(2, 68, device=dev))
        raised = None
    except ValueError as e:
        raised = str(e)
    check(raised is not None, "lstm: a hidden size of 17 did not raise")
    log(f"[lstm] hidden size 17 raises: {raised}")
    return entries, step_launches


OP_GAP_FACTOR = 10     # [op_gap]: a card gap this many times the CPU's own
F32_ULP = 2.0 ** -23   # floor of a backend gap, one f32 ulp of the scale


def combine_steps(comb, x, hop_major, feed=None):
    """``nn/combine.AttentionCombine.forward`` a step at a time: each
    step's output.  With ``feed`` (another run's outputs) each step reads
    the previous step's output from ``feed`` instead of its own."""
    import torch
    ax = 0 if hop_major else 1

    def read(k, own):
        return own if feed is None else feed[k].to(own.device, own.dtype)
    out = {"lstm": comb.attention_lstm(x, time_major=hop_major)}
    out["logits"] = read("lstm", out["lstm"]).sum(-1)
    out["softmax"] = torch.softmax(read("logits", out["logits"]), dim=ax)
    out["weighted sum"] = (x * read("softmax", out["softmax"])[..., None]
                           ).sum(dim=ax)
    return out


def combine_step_errors(ctx, model, batch, real):
    """{combine: {step: (card error, CPU error)}}: each attention combine
    of the CPU's train forward of ``batch``, its input captured, its steps
    run on the card and on the CPU in f32, each step from the float64
    result of the step before it ("from float64": the step's own
    rounding) and from the same device's own previous step ("chained":
    what it carries on), and the BiLSTM again as a plain cell
    (``ops/lstm.plain_bilstm``, outside the kernel), each against the
    float64 chain, as max |error| over the largest |value| of the real
    rows; and whether the split steps, chained, give
    the module's own output bit for bit on each device ("split =
    forward")."""
    torch, dev = ctx.torch, ctx.dev
    import copy

    import numpy as np
    from kpgnn_tpu_torch.nn.combine import AttentionCombine
    from kpgnn_tpu_torch.ops.lstm import plain_bilstm
    m = copy.deepcopy(model)
    inputs = {}

    def record(name):
        def pre(module, args, kwargs):
            inputs[name] = (args[0].detach().clone(),
                            kwargs["hop_major"] if "hop_major" in kwargs
                            else args[1])
        return pre
    combs = {n: c for n, c in m.named_modules()
             if isinstance(c, AttentionCombine)}
    hooks = [c.register_forward_pre_hook(record(n), with_kwargs=True)
             for n, c in combs.items()]
    with torch.no_grad():
        m(batch.to("cpu"), train=True)
    for h in hooks:
        h.remove()
    out = {}
    for name, (x, hm) in inputs.items():
        with torch.no_grad():
            ref = combine_steps(copy.deepcopy(combs[name]).double(),
                                x.double(), hm)
            errs = {}
            for where in (dev, "cpu"):
                comb = copy.deepcopy(combs[name]).to(where)
                xd = x.to(where)
                chained = combine_steps(comb, xd, hm)
                errs.setdefault("split = forward", []).append(torch.equal(
                    chained["weighted sum"], comb(xd, hm)))
                plain = {"lstm": plain_bilstm(comb.attention_lstm, xd, hm)}
                for how, steps in (("from float64", combine_steps(
                        comb, xd, hm, feed=ref)), ("chained", chained),
                        ("plain cell", plain)):
                    for k, v in steps.items():
                        if how == "chained" and k == "lstm":
                            continue        # the same as from float64
                        want = real(batch, ref[k].numpy())
                        got = real(batch, v.double().cpu().numpy())
                        scale = float(np.abs(want).max()) or 1.0
                        errs.setdefault(f"{k} {how}", []).append(
                            float(np.abs(got - want).max()) / scale)
        out[name] = {k: tuple(v) for k, v in errs.items()}
    return out


def op_gap_phase(ctx):
    """[op_gap]: where the card's flagship step first parts from the CPU's.
    One full-width flagship f32 batch (the run's first, the kernel plan)
    and one set of weights (``init_parameters`` from SEED) on the card and
    on the CPU: ``utils/parity.capture_activations`` of an eval forward
    (running statistics) and of a train forward (batch statistics, what
    the step differentiates), and each module's max |card - CPU| over the
    CPU output's largest |value| (real rows where a dimension is the
    batch's nodes or graphs), in the order the modules return.  Beside it
    the CPU's own backend gap: the same graphs on the COO backend against
    the kernel plan, both on the CPU, floored at one f32 ulp.  Names the
    first module whose card gap exceeds OP_GAP_FACTOR times its backend
    gap, then the same for the parameters' gradients of the step, in the
    order the backward finishes them (the last layer's first: an earlier
    layer's gradient carries every later layer's gap) and the five
    furthest apart.  Then each attention combine's steps (its BiLSTM, the
    logits, the softmax, the weighted sum; ``combine_step_errors``) from
    the combine's input in the CPU's train forward, on the card and on
    the CPU in f32, against float64: each step from the float64 result
    of the step before it, so its own rounding shows apart from what
    reaches it, and chained; the BiLSTM also as a plain cell.  Reports
    and does not gate."""
    torch, dev = ctx.torch, ctx.dev
    import copy

    import numpy as np
    from kpgnn_tpu_torch.models.factory import make_model
    from kpgnn_tpu_torch.nn.inits import init_parameters
    from kpgnn_tpu_torch.train.loader import GraphLoader
    from kpgnn_tpu_torch.train.loop import _masked_loss
    from kpgnn_tpu_torch.utils.parity import capture_activations

    class TrainForward(torch.nn.Module):
        """capture_activations runs ``model(batch, train=False)``; this
        wrapper's forward is its model's train-mode forward."""

        def __init__(self, model):
            super().__init__()
            self.m = model

        def forward(self, batch, train=False):
            return self.m(batch, train=True)

    t0 = time.perf_counter()
    pb = ctx.tl.example()
    cb = GraphLoader(ctx.tl.graphs, BATCH, mode="coo").example()
    model = init_parameters(make_model(ctx.mcfg), SEED)

    def real(batch, a):
        """``a`` with its node and graph axes cut to the real rows."""
        for ax, n in enumerate(a.shape):
            for size, mask in ((batch.n_pad, batch.node_mask),
                               (batch.graph_mask.shape[0], batch.graph_mask)):
                if n == size:
                    a = np.compress(mask.cpu().numpy(), a, axis=ax)
                    break
        return a

    def e(x):
        return "n/a" if x is None else f"{x:.2e}"

    def gap(a, b):
        if a is None or b is None or a.shape != b.shape:
            return None
        scale = float(np.abs(b).max()) if b.size else 0.0
        return float(np.abs(a - b).max()) / scale if scale > 0 else 0.0

    def capture(train, batch, device):
        m = copy.deepcopy(model).to(device)
        acts = capture_activations(TrainForward(m) if train else m,
                                   batch.to(device))
        return {k[2:] if train else k: real(batch, v)
                for k, v in acts.items() if k != "__call__" or not train}

    lines, named = [], {}
    for mode in ("eval", "train"):
        train = mode == "train"
        card = capture(train, pb, dev)
        cpu = capture(train, pb, "cpu")
        coo = capture(train, cb, "cpu")
        first = None
        for k, v in cpu.items():
            g, b = gap(card.get(k), v), gap(coo.get(k), v)
            floor = max(b or 0.0, F32_ULP)
            lines.append(f"[op_gap] {mode} {k}: card {e(g)}, cpu backends "
                         f"{e(b)}")
            if first is None and g is not None and g > OP_GAP_FACTOR * floor:
                first = (k, g, b)
        named[mode] = first

    def grads(batch, device):
        """The step's gradients, in the order the backward finishes
        them."""
        m = copy.deepcopy(model).to(device)
        b = batch.to(device)
        done = []
        hooks = [p.register_post_accumulate_grad_hook(
            lambda p, n=n: done.append(n)) for n, p in m.named_parameters()]
        lsum, cnt = _masked_loss(m(b, train=True), b.y, b.graph_mask, "l1")
        (lsum / cnt).backward()
        for h in hooks:
            h.remove()
        params = dict(m.named_parameters())
        return {n: params[n].grad.detach().cpu().numpy() for n in done}
    gcard, gcpu, gcoo = grads(pb, dev), grads(pb, "cpu"), grads(cb, "cpu")
    gaps = {n: (gap(gcard[n], g), gap(gcoo.get(n), g))
            for n, g in gcpu.items()}
    steps = combine_step_errors(ctx, model, pb, real)
    gfirst = next(((n, g, b) for n, (g, b) in gaps.items()
                   if g > OP_GAP_FACTOR * max(b or 0.0, F32_ULP)), None)
    for line in lines:
        log(line)
    for mode, first in named.items():
        log(f"[op_gap] {mode} forward: first module past {OP_GAP_FACTOR}x "
            "the CPU's backend gap: " + (
                "none" if first is None else
                f"{first[0]} (card {e(first[1])}, cpu backends "
                f"{e(first[2])})"))
    top = sorted(gaps.items(), key=lambda kv: -kv[1][0])[:5]
    for name, errs in steps.items():
        log(f"[op_gap] {name} steps, error against float64 (card / cpu): "
            + ", ".join(
                f"{k} {c} / {u}" if isinstance(c, bool) else
                f"{k} {e(c)} / {e(u)}" for k, (c, u) in errs.items()))
    log(f"[op_gap] gradients in backward order: first past {OP_GAP_FACTOR}x"
        " the CPU's backend gap: " + ("none" if gfirst is None else
                                 f"{gfirst[0]} (card {e(gfirst[1])}, cpu "
                                 f"backends {e(gfirst[2])})")
        + "; furthest apart: " + ", ".join(
            f"{n} card {e(g)} / cpu backends {e(b)}" for n, (g, b) in top)
        + f"; {time.perf_counter() - t0:.1f} s")


def prefetch_phase(ctx):
    """[prefetch]: the Trainer's per-batch train stream as it runs
    (``b.to(device)`` on the dispatch thread) against the same stream
    through ``train/loop.device_prefetch`` (a helper thread runs the
    copies, PREFETCH_DEPTH batches ahead), the flagship on the kernel
    plan, resident off: a warm-up fit, then fits of 2 epochs without
    evaluation in the order plain, prefetch, prefetch, plain, twice.
    Every fit's step losses must equal the warm-up's bit for bit; each
    leg's host ms a step is its second epoch's seconds over its steps
    (the epoch ends in a sync)."""
    torch = ctx.torch
    import numpy as np
    from kpgnn_tpu_torch.models.factory import make_model
    from kpgnn_tpu_torch.train import loop
    from kpgnn_tpu_torch.train.config import TrainConfig
    from kpgnn_tpu_torch.train.loader import GraphLoader

    real = loop.train_epoch

    def prefetched(model, opt, batches, *args, **kw):
        return real(model, opt, loop.device_prefetch(batches, ctx.dev),
                    *args, **kw)

    def fit(epoch_fn):
        loop.train_epoch = epoch_fn
        try:
            tl = GraphLoader(ctx.zinc_train, BATCH, shuffle=True, seed=SEED,
                             **ctx.lk)
            cfg = TrainConfig(lr=ctx.args.lr, num_epochs=2,
                              batch_size=BATCH, seed=SEED, patience=100)
            hist = loop.Trainer(make_model(ctx.mcfg), cfg, loss="l1",
                                device=str(ctx.dev), resident="off").fit(
                                    tl)[1]["history"]
        finally:
            loop.train_epoch = real
        return (np.concatenate([r["step_losses"] for r in hist]),
                hist[1]["seconds"] / len(hist[1]["step_losses"]) * 1e3)

    want, _ = fit(real)
    ms = {"plain": [], "prefetch": []}
    for leg in ("plain", "prefetch", "prefetch", "plain") * 2:
        losses, step_ms = fit(real if leg == "plain" else prefetched)
        check(np.array_equal(losses, want), f"prefetch: the {leg} leg's "
              f"step losses differ from the warm-up fit's")
        ms[leg].append(step_ms)
    ratios = sorted(p / q for p, q in zip(ms["prefetch"], ms["plain"]))
    log(f"[prefetch] flagship per-batch Trainer.fit, {len(want)} steps a "
        f"fit, every leg's step losses bit for bit the same; host ms a "
        f"step (second epoch): plain b.to(device) "
        + ", ".join(f"{x:.3f}" for x in ms["plain"]) + "; device_prefetch "
        + ", ".join(f"{x:.3f}" for x in ms["prefetch"])
        + "; prefetch / plain, the i-th leg of each, sorted: "
        + ", ".join(f"{r:.4f}" for r in ratios))


def determinism_phase(ctx):
    """[determinism]: DET_STEPS steps twice from one seed under default
    algorithms, which must repeat bit for bit, one line a backend: the
    flagship on pallas, and the ``det_legs`` (coo, banded with a spill,
    KPGCN's plan), each of which must launch the sorted segment sum;
    then, reported, the flagship's pallas steps twice under
    deterministic algorithms in a process of its own
    (``determinism_child``).  Returns {leg: (its first batch on the
    card, the sorted sums' launches of one run by (variant, D))}."""
    from kpgnn_tpu_torch.ops import segment

    torch = ctx.torch
    batches = first_batches(ctx.tl, DET_STEPS)
    default = det_compare(
        [det_steps(torch, ctx.mcfg, batches, ctx.dev) for _ in range(2)])
    log(f"[determinism] pallas: {DET_STEPS} flagship steps twice from seed "
        f"{SEED} (f32, TF32 off), default algorithms: {det_text(*default)}")
    check(default[0] is None and default[2] == 0.0,
          f"determinism: two runs of the same pallas steps differ: "
          f"{det_text(*default)}")
    legs = {}
    for label, cfg, lb, loss in det_legs(ctx):
        segment.reset_launch_counts()
        runs = [det_steps(torch, cfg, lb, ctx.dev, loss) for _ in range(2)]
        torch.cuda.synchronize()
        w = Counter({k: n // 2 for k, n in
                     segment.sorted_segment_sum.width_launches.items()})
        res = det_compare(runs)
        log(f"[determinism] {label}: {DET_STEPS} {cfg.model_name} K={cfg.K} "
            f"H={cfg.hidden_size} steps twice from seed {SEED}, default "
            f"algorithms: {det_text(*res)}; sorted segment sums a run by "
            f"(variant, D): {dict(w)}")
        check(res[0] is None and res[2] == 0.0,
              f"determinism: two runs of the same {label} steps differ: "
              f"{det_text(*res)}")
        check(w, f"determinism: the {label} steps launched no sorted "
              f"segment sum")
        legs[label] = (lb[0].to(ctx.dev), w)
    path = os.path.join(ctx.work, "det_batches.pkl")
    with open(path, "wb") as f:
        pickle.dump((ctx.mcfg, batches, str(ctx.dev)), f)
    proc = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {ROOT!r}); "
         f"import chip_smoke; chip_smoke.determinism_child({path!r})"],
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"),
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"determinism: the deterministic run "
          f"failed:\n{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    det = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"[determinism] pallas, reported: in a process of its own, under "
        f"use_deterministic_algorithms (CUBLAS_WORKSPACE_CONFIG=:4096:8): "
        f"{det_text(*det['deterministic'])}, ops that warn of no "
        f"deterministic implementation: {det['warned'] or 'none'}")
    return legs


def main():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke "
                           "run needs an NVIDIA GPU")
    check(os.path.isdir(os.path.join(ROOT, "kpgnn_tpu_torch")),
          f"no kpgnn_tpu_torch package beside {__file__}: run this script "
          f"from a checkout of the repo")
    sys.path.insert(0, ROOT)
    import kpgnn_tpu_torch
    check(os.path.dirname(os.path.abspath(kpgnn_tpu_torch.__file__))
          == os.path.join(ROOT, "kpgnn_tpu_torch"),
          "kpgnn_tpu_torch was not imported from this checkout")
    import numpy as np
    from kpgnn_tpu_torch.data.expressiveness import generate_csl
    from kpgnn_tpu_torch.data.molecules import load_zinc
    from kpgnn_tpu_torch.models.factory import make_model
    from kpgnn_tpu_torch.nn.basic import TorchLinear
    from kpgnn_tpu_torch.nn.inits import init_parameters
    from kpgnn_tpu_torch.ops import cuda_lib, segment, spmm
    from kpgnn_tpu_torch.ops import lstm as lstm_ops
    from kpgnn_tpu_torch.ops.lstm import BiLSTM
    from kpgnn_tpu_torch.prep import native
    from kpgnn_tpu_torch.prep.khop import extract_graphs
    from kpgnn_tpu_torch.scripts import common, train_csl, train_qm9, train_zinc
    from kpgnn_tpu_torch.train.loader import GraphLoader
    from kpgnn_tpu_torch.train.loop import (_batch_target_mask, _masked_loss,
                                            resident_rule, train_step)
    from kpgnn_tpu_torch.train.checkpoint import load_checkpoint
    from kpgnn_tpu_torch.train.resident import (build_coo_store,
                                                build_dense_store, gather_any)
    from kpgnn_tpu_torch.train.state import make_optimizer
    from kpgnn_tpu_torch.scripts import profile_step as profile_script

    common.set_full_f32()
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    marks = [("start", time.perf_counter())]
    # train-step profiles by "<backend> <resident|per-batch>", for the
    # banded step's launches against the others'
    step_profiles = {}

    def mark(name):
        """Ends the phase ``name``: its seconds go on the [phases] line."""
        marks.append((name, time.perf_counter()))

    # ---- 1. build ----
    secs = cuda_lib.build_all([spmm.KERNEL_SOURCE, lstm_ops.KERNEL_SOURCE])
    hashes = {s: cuda_lib.source_hash(s) for s in secs}
    log(f"[build] {kind} ({card}); source hash {json.dumps(hashes)}; nvcc "
        f"seconds: {json.dumps(secs)}")
    # the rtol 1e-4 gates against the CPU hold only in full f32
    check(not (torch.backends.cuda.matmul.allow_tf32
               or torch.backends.cudnn.allow_tf32),
          "TF32 is on for cuBLAS or cuDNN after common.set_full_f32()")

    work = tempfile.mkdtemp(prefix="kpgnn_smoke_")
    # every script's prep cache (--cache_dir's default) in the scratch dir
    os.environ["KPGNN_CACHE_DIR"] = cache_dir = os.path.join(work, "cache")
    try:
        write_fixture(work)
        args = train_zinc.parser().parse_args(
            train_argv(work, os.path.join(work, "save"), "cuda"))
        splits = load_zinc(os.path.join(work, "ZINC"))

        # ---- the native prep and the prep cache ----
        check(native.available(),
              f"the native prep did not build: {native.BUILD_ERROR}")
        log(f"[prep] native prep built from "
            f"{os.path.relpath(native.SOURCE, ROOT)} with g++ (source hash "
            f"{native.source_hash()}) in {native.BUILD_SECONDS:.2f} s")

        def prep_s(fn):
            t0 = time.perf_counter()
            out = fn()
            return out, time.perf_counter() - t0
        zinc_train, miss_s = prep_s(lambda: common.prepare(
            splits["train"], args, "ZINC_train"))
        hit, hit_s = prep_s(lambda: common.prepare(
            splits["train"], args, "ZINC_train"))
        available = native.available
        native.available = lambda: False            # the numpy path
        try:
            plain_graphs, plain_s = prep_s(lambda: extract_graphs(
                splits["train"], common.khop_config(args)))
        finally:
            native.available = available
        check(same_graphs(hit, zinc_train),
              "prep: the cache hit differs from the fresh prep")
        check(same_graphs(plain_graphs, zinc_train),
              "prep: the native path differs from the numpy path")
        log(f"[prep] flagship train split, {len(zinc_train)} graphs at K={K}: "
            f"native prep + cache write {miss_s:.3f} s, cache hit "
            f"{hit_s:.3f} s (equal graphs), numpy path {plain_s:.3f} s "
            f"(equal graphs); cache {sorted(os.listdir(cache_dir))}")
        mark("build and prep")
        mcfg = common.model_config(args, input_encoder=("embedding", 21),
                                   task="graph_regression", output_size=1)
        lk = common.loader_kwargs(args, mcfg)
        # the trainer's own loader (same seed), so the flagship plan has the
        # main path's shapes: the loader's worst-case n_pad over the split
        tl = GraphLoader(zinc_train, BATCH, shuffle=True, seed=SEED, **lk)
        fb = tl.example()
        plan = fb.adj.to(dev)
        union_edges = sum(g.num_edges for g in tl.graphs[:BATCH])
        deg = plan.fwd.indptr[1:] - plan.fwd.indptr[:-1]
        codes = torch.unique(plan.fwd.codes).tolist()
        log(f"[plan] flagship batch: {int(fb.node_mask.sum())} nodes, "
            f"n_pad {fb.n_pad}, {union_edges} union edges, K*n_pad = "
            f"{plan.fwd.n_rows} rows, {int((deg > 0).sum())} of them with "
            f"an edge, at most {int(deg.max())} edges a row, "
            f"{plan.fwd.senders.shape[0]} live hop edges with {len(codes)} "
            f"attr codes {codes}; rows up to the last live one per hop "
            f"{plan.fwd.hop_live}")

        # the CSL slice's data: the trainer's fold-0 train loader (same
        # seed), so the CSL plan has the main path's shapes
        cargs = train_csl.parser().parse_args(
            csl_argv(os.path.join(work, "csl"), "cuda", "pallas"))
        raw = generate_csl()
        for g in raw:
            g["x"] = np.ones((g["num_nodes"], 1), dtype=np.float32)
        cgraphs = common.prepare(raw, cargs, "CSL")
        tr, va, te = train_csl.splits([int(g.y[0]) for g in cgraphs], 1,
                                      SEED)[0]
        ctrain = [cgraphs[i] for i in tr]
        cmcfg = common.model_config(cargs, input_encoder=("linear", 1),
                                    task="graph_classification",
                                    output_size=10)
        clk = common.loader_kwargs(cargs, cmcfg)
        ctl = GraphLoader(ctrain, CSL_BATCH, shuffle=True, seed=SEED, **clk)
        cfb = ctl.example()
        cplan = cfb.adj.to(dev)
        cdeg = cplan.fwd.indptr[1:] - cplan.fwd.indptr[:-1]
        ck = cplan.countsk_hm
        log(f"[plan] csl batch: {int(cfb.node_mask.sum())} nodes, n_pad "
            f"{cfb.n_pad}, {sum(g.num_edges for g in ctrain[:CSL_BATCH])} "
            f"union edges, K*n_pad = {cplan.fwd.n_rows} rows, "
            f"{int((cdeg > 0).sum())} of them with an edge, at most "
            f"{int(cdeg.max())} edges a row, {cplan.fwd.senders.shape[0]} "
            f"live hop edges with {len(torch.unique(cplan.fwd.codes))} attr "
            f"codes; rows up to the last live one per hop "
            f"{cplan.fwd.hop_live}; countsk_hm {tuple(ck.shape)} "
            f"({ck.numel() * 4 / 1e6:.1f} MB); split {len(tr)} / {len(va)} "
            f"/ {len(te)} graphs")
        coo_tl = GraphLoader(ctrain, CSL_BATCH, shuffle=True, seed=SEED,
                             mode="coo")

        # the QM9 slice's data: the trainer's train split in each backend's
        # loader (same seed), so the QM9 plan has the main path's shapes;
        # and the sweep's KPGINPrime K=16 config on the same split
        run_tool("make_qm9_fixture", "--out", work, "--n", QM9_MOLECULES,
                 "--seed", QM9_FIXTURE_SEED)

        def qm9_data(extra, backend):
            a = train_qm9.parser().parse_args(qm9_argv(
                work, os.path.join(work, "qm9"), "cuda", backend, extra))
            (train, _, _), _ = train_qm9.task_splits(
                common.prepare(train_qm9.load(a), a, "QM9"), a)
            cfg = common.model_config(a, input_encoder=("qm9", 0),
                                      task="graph_regression", output_size=1)
            return a, train, cfg
        qargs, qtrain, qmcfg = qm9_data(QM9_VN_RD, "pallas")
        qlk = common.loader_kwargs(qargs, qmcfg)
        qloaders = {mode: GraphLoader(qtrain, QM9_BATCH, shuffle=True,
                                      seed=SEED, **dict(qlk, mode=mode))
                    for mode in ("pallas", "coo", "dense")}
        qfb = qloaders["pallas"].example()
        qplan = qfb.adj.to(dev)
        qvk = qplan.countsk_hm.shape[2]
        pargs, ptrain, pmcfg = qm9_data(QM9_PRIME, "pallas")
        ptl = GraphLoader(ptrain, QM9_BATCH,
                          **common.loader_kwargs(pargs, pmcfg))
        pfb = ptl.example()
        pplan = pfb.adj.to(dev)
        pvk = pplan.countsk_hm.shape[2]
        for label, b, p in (("qm9", qfb, qplan),
                            (f"qm9 KPGINPrime k={PRIME_K}", pfb, pplan)):
            d = p.fwd.indptr[1:] - p.fwd.indptr[:-1]
            log(f"[plan] {label} batch: {int(b.node_mask.sum())} nodes, "
                f"n_pad {b.n_pad}, K*n_pad = {p.fwd.n_rows} rows, "
                f"{int((d > 0).sum())} of them with an edge, at most "
                f"{int(d.max())} edges a row, {p.fwd.senders.shape[0]} live "
                f"hop edges; rows up to the last live one per hop "
                f"{p.fwd.hop_live}")
        qdb = qloaders["dense"].example()
        log(f"[plan] qm9 dense batch: n_slot {qloaders['dense'].n_slot}, "
            f"hop_attr {tuple(qdb.adj.hop_attr.shape)}; split "
            f"{len(qtrain)} train graphs")

        # the generated-data slices: each script's own data and model
        # config, and its run-0 (TU: fold-0) train split in each backend's
        # loader (same seed), so each plan has its main path's shapes
        write_gin_fixture(work)
        slices = {}
        for label, (name, _, loss, node_level) in GENERATED.items():
            mod = importlib.import_module(f"kpgnn_tpu_torch.scripts.{name}")
            argv = generated_argv(label, work, "cuda", "pallas")
            ga = mod.parser().parse_args(argv)
            if name == "train_tu":
                graphs, folds, n_tag, n_cls = mod.load(ga)
                gcfg = mod.config(ga, n_tag, n_cls)
                g_tr, g_te = folds[0]
                g_split = ([graphs[i] for i in g_tr], [], g_te)
            else:
                gsplits = mod.datasets(ga)
                gcfg = mod.config(ga)
                g_split = tuple(gsplits[k] for k in ("train", "val", "test"))
            gB = ga.batch_size
            g_lk = common.loader_kwargs(ga, gcfg)
            g_loaders = {m: GraphLoader(g_split[0], gB, shuffle=True,
                                        seed=SEED, y_is_node_level=node_level,
                                        **dict(g_lk, mode=m))
                         for m in ("pallas", "coo", "dense")}
            gb = g_loaders["pallas"].example()
            sl = slices[label] = SimpleNamespace(
                main=mod.main, argv=argv, cfg=gcfg, loss=loss,
                node_level=node_level, L=ga.num_layer,
                D=ga.hidden_size // (1 if ga.model_name == "KPGINPlus"
                                     else ga.K),
                epochs=GEN_EPOCHS, train_steps=len(g_loaders["pallas"]),
                val_steps=math.ceil(len(g_split[1]) / gB),
                test_steps=math.ceil(len(g_split[2]) / gB),
                loaders=g_loaders, batch=gb, plan=gb.adj.to(dev), args=ga,
                union=sum(g.num_edges for g in g_split[0][:gB]))
            gd = sl.plan.fwd.indptr[1:] - sl.plan.fwd.indptr[:-1]
            log(f"[plan] {label} batch ({ga.model_name} K={ga.K} L="
                f"{ga.num_layer} H={ga.hidden_size}, batch {gB}, kernel D="
                f"{sl.D}): {int(gb.node_mask.sum())} nodes, n_pad "
                f"{gb.n_pad}, {sl.union} union edges, K*n_pad = "
                f"{sl.plan.fwd.n_rows} rows, {int((gd > 0).sum())} of them "
                f"with an edge, at most {int(gd.max())} edges a row, "
                f"{sl.plan.fwd.senders.shape[0]} live hop edges; rows up to "
                f"the last live one per hop {sl.plan.fwd.hop_live}; split "
                + " / ".join(str(len(x)) for x in g_split) + " graphs")

        # the expressiveness runs' data: EXP, CEXP and SR25 on fixtures
        # written here, their first batches' plans; the simulation's first
        # forward per run; profile_step's large-graph plan
        expr = expressiveness_slices(torch, dev, work)
        for label, sl in expr.items():
            d = sl.plan.fwd.indptr[1:] - sl.plan.fwd.indptr[:-1]
            log(f"[plan] {label} batch (KPGIN K={sl.cfg.K} L={sl.L} H="
                f"{sl.args.hidden_size}, batch {sl.args.batch_size}, kernel "
                f"D={sl.D}): {int(sl.batch.node_mask.sum())} nodes, n_pad "
                f"{sl.batch.n_pad}, K*n_pad = {sl.plan.fwd.n_rows} rows, "
                f"{int((d > 0).sum())} of them with an edge, at most "
                f"{int(d.max())} edges a row, {sl.plan.fwd.senders.shape[0]} "
                f"live hop edges; rows up to the last live one per hop "
                f"{sl.plan.fwd.hop_live}; {sl.graphs} graphs")
        sim_plans = simulation_plans(dev)
        for label, (p, k, d) in sim_plans.items():
            log(f"[plan] {label} graph (KPGIN K={k}, kernel D={d}): "
                f"{p.fwd.n_rows} rows, {p.fwd.senders.shape[0]} live hop "
                f"edges; rows up to the last live one per hop {p.fwd.hop_live}")
        large_cfg, large_batch, large_collate_s = profile_script.large_batch()
        lplan = large_batch.adj.to(dev)
        LD = large_cfg.hidden_size // large_cfg.K
        ld = lplan.fwd.indptr[1:] - lplan.fwd.indptr[:-1]
        log(f"[plan] profile_step large batch (KPGIN K={large_cfg.K} H="
            f"{large_cfg.hidden_size}, kernel D={LD}): "
            f"{profile_script.LARGE_GRAPHS} x {profile_script.LARGE_NODES}-"
            f"node polymers, n_pad {large_batch.n_pad}, K*n_pad = "
            f"{lplan.fwd.n_rows} rows, at most {int(ld.max())} edges a row, "
            f"{lplan.fwd.senders.shape[0]} live hop edges; collate_pallas on "
            f"the host {large_collate_s:.3f} s")
        # the multi-rank legs' batches and each node leg's rank-0
        # rectangular kernel plan (K·n_local rows over K·n_ext senders)
        par = parallel_data(torch, zinc_train, lk, mcfg, large_cfg)
        par.shard_plans = {k: (sp.to(dev), d)
                           for k, (sp, d) in par.shard_plans.items()}
        for label, (sp, d) in par.shard_plans.items():
            log(f"[plan] {label} rank 0 (D={d}): fwd {sp.fwd.n_rows} rows "
                f"over {sp.fwd.n_cols} sender rows ({sp.K} hops of "
                f"{sp.fwd.rows_per_hop} / {sp.bwd.rows_per_hop}), "
                f"{sp.fwd.senders.shape[0]} live hop edges; rows up to the "
                f"last live one per hop {sp.fwd.hop_live}")
        # the plans [tools] launches on: tune_pallas's batches and
        # scaling_estimate's ici-mode polymer
        tplans = tool_plans(dev)
        for label, (tp, d) in tplans.items():
            log(f"[plan] {label} (K={tp.K}, D={d}): {tp.fwd.n_rows} rows, "
                f"{tp.fwd.senders.shape[0]} live hop edges; rows up to the "
                f"last live one per hop {tp.fwd.hop_live}")

        def collate_ms(loader):
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                loader.example()
                ts.append((time.perf_counter() - t0) * 1e3)
            return min(ts)
        log(f"[host] csl {CSL_BATCH}-graph batch collate (min of 5): "
            f"pallas plan {collate_ms(ctl):.1f} ms, coo "
            f"{collate_ms(coo_tl):.1f} ms")

        mark("data")
        # ---- 2. kernels against their plain versions ----
        gen = torch.Generator(device=dev).manual_seed(0)
        errs = Counter()            # variant -> max |err| over its checks
        errs_w = Counter()          # (variant, shape) -> the same there
        f32_tol = dict(rtol=0.0, atol=1e-5)

        def note(variants, err, shape):
            for v in variants:
                errs[v] = max(errs[v], err)
                errs_w[v, shape] = max(errs_w[v, shape], err)

        def compare(name, fwd, bwd, D, dtype=torch.float32, hub=False,
                    mis=False, shape=None):
            x = torch.randn(fwd.n_cols, D, device=dev, generator=gen
                            ).to(dtype)
            w = torch.randn(fwd.n_rows, D, device=dev, generator=gen)
            if mis:
                w = misalign(w)
            # kernel: forward over fwd, autograd backward over bwd
            xk = (misalign(x) if mis else x.clone()).requires_grad_(True)
            out, v_f = launched(
                spmm, lambda: spmm._GatherSegment.apply(xk, fwd, bwd))
            _, v_b = launched(spmm, lambda: (out * w).sum().backward())
            out = out.detach()
            # the backward gathers the gradient in x's dtype (a bf16 x
            # takes the bf16 variant over bwd, as the main path's --bf16)
            wg = w if dtype == torch.float32 else w.to(dtype)
            grad_k, v_g = launched(spmm, lambda: bwd.gather(wg))
            check(xk.grad.dtype == dtype
                  and torch.equal(xk.grad, grad_k.to(dtype)),
                  f"{name}: autograd backward is not the kernel over bwd")
            vec = D * x.element_size() % 16 == 0
            expect_f = spmm.variant_name(dtype, vec and not mis, False)
            # autograd's gradient is a fresh (aligned) tensor
            expect_b = spmm.variant_name(dtype, vec, False)
            expect_g = spmm.variant_name(
                dtype, vec and wg.data_ptr() % 16 == 0, False)
            check(v_f == {expect_f: 1} and v_b == {expect_b: 1}
                  and v_g == {expect_g: 1},
                  f"{name}: launched {v_f} forward, {v_b} autograd "
                  f"backward, {v_g} backward; expected {expect_f}, "
                  f"{expect_b}, {expect_g}")
            # plain version: forward on the same values, the gradient in
            # f32 of the values the kernel gathers
            ref = spmm.gather_segment_sum_reference(
                x, fwd.indptr, fwd.senders, fwd.n_rows)
            xr = x.float().clone().requires_grad_(True)
            (spmm.gather_segment_sum_reference(
                xr, fwd.indptr, fwd.senders, fwd.n_rows)
             * wg.float()).sum().backward()
            torch.cuda.synchronize()
            check(out.dtype == torch.float32 and out.shape == ref.shape,
                  f"{name}: output {out.dtype} {tuple(out.shape)}")
            tol_f = (dict(rtol=1e-3, atol=1e-5) if dtype == torch.bfloat16
                     else f32_tol)
            tol_b = f32_tol         # the gradient is f32 either way
            if hub:     # summation-order bound of 10k-term f32 sums
                absx = spmm.gather_segment_sum_reference(
                    x.abs(), fwd.indptr, fwd.senders, fwd.n_rows)
                tol_f = dict(rtol=0.0, atol=1e-5 + 1e-6 * float(absx.max()))
                absw = spmm.gather_segment_sum_reference(
                    w.abs(), bwd.indptr, bwd.senders, bwd.n_rows)
                tol_b = dict(rtol=0.0, atol=1e-5 + 1e-6 * float(absw.max()))
            ef = float((out - ref).abs().max())
            eb = float((grad_k - xr.grad).abs().max())
            torch.testing.assert_close(out, ref, **tol_f,
                                       msg=lambda m: f"{name} fwd: {m}")
            torch.testing.assert_close(grad_k, xr.grad, **tol_b,
                                       msg=lambda m: f"{name} bwd: {m}")
            if not hub or shape is not None:
                note(v_f, ef, D if shape is None else shape)
                note(set(v_b) | set(v_g), eb, D if shape is None else shape)
            log(f"[check] {name}: rows {fwd.n_rows} cols {fwd.n_cols} "
                f"edges {fwd.senders.shape[0]} D {D} {str(dtype)[6:]}: "
                f"max |err| fwd {ef:.3e} ({expect_f}) bwd {eb:.3e} "
                f"({expect_g})")

        for k in range(1, K + 1):
            sub = plan.slice_hops(k)
            compare(f"flagship k={k}", sub.fwd, sub.bwd, H)
        compare(f"flagship k={K} bf16", plan.fwd, plan.bwd, H,
                dtype=torch.bfloat16)
        compare(f"flagship k={K} misaligned", plan.fwd, plan.bwd, H,
                mis=True)
        compare(f"flagship k={K} bf16 misaligned", plan.fwd, plan.bwd, H,
                dtype=torch.bfloat16, mis=True)

        def csr_pair(recv, send, n_rows, n_cols):
            """fwd CSR over all edges, bwd over the non-null ones."""
            fwd, _ = spmm.build_csr(recv, send, n_rows, n_cols)
            ok = send < n_cols
            bwd, _ = spmm.build_csr(send[ok], recv[ok], n_cols, n_rows)
            return fwd.to(dev), bwd.to(dev)

        rng = np.random.default_rng(1)
        # empty rows (only even rows below 2048 receive) + null senders
        e = 5000
        recv = 2 * rng.integers(0, 1024, e)
        send = rng.integers(0, 4096 + 100, e)
        compare("empty rows + null senders", *csr_pair(recv, send, 4096,
                                                       4096), H)
        recv = np.concatenate([np.full(10000, 7), rng.integers(0, 2048,
                                                               2000)])
        send = rng.integers(0, 2048, 12000)
        compare("10k-edge hub", *csr_pair(recv, send, 2048, 2048), H,
                hub=True)
        compare("rectangular", *csr_pair(rng.integers(0, 1000, 8000),
                                         rng.integers(0, 3000, 8000),
                                         1000, 3000), 64)
        compare("D=13", *csr_pair(rng.integers(0, 2048, 10000),
                                  rng.integers(0, 2048, 10000), 2048,
                                  2048), 13)
        compare("D=13 bf16", *csr_pair(rng.integers(0, 2048, 10000),
                                       rng.integers(0, 2048, 10000), 2048,
                                       2048), 13, dtype=torch.bfloat16)

        V1, VK = plan.counts1.shape[1], plan.countsk_hm.shape[2]

        def compare_fused(name, sub, D, dtype=torch.float32, mis=False,
                          VK=VK, shape=None):
            """The fused forward (gather + edge-embedding term) and its
            autograd grads of x and both tables against the plain version's
            autograd; VK is the hop-k table's rows (the full plan's)."""
            k, f, n = sub.K, sub.fwd, sub.counts1.shape[0]
            V1 = sub.counts1.shape[1]
            x = torch.randn(f.n_cols, D, device=dev, generator=gen).to(dtype)
            t1 = torch.randn(V1, D, device=dev, generator=gen)
            tk = torch.randn(VK, D, device=dev, generator=gen)
            w = torch.randn(f.n_rows, D, device=dev, generator=gen)
            xk = (misalign(x) if mis else x.clone()).requires_grad_(True)
            t1k, tkk = (t.clone().requires_grad_(True) for t in (t1, tk))
            out, v_f = launched(
                spmm, lambda: spmm._FusedKHop.apply(xk, t1k, tkk, sub))
            _, v_b = launched(spmm, lambda: (out * w).sum().backward())
            out = out.detach()
            # dx gathers the gradient in x's dtype; the table gradients
            # take it in f32
            wg = w.to(dtype)
            grad_k = sub.bwd.gather(wg)
            check(torch.equal(xk.grad, grad_k.to(dtype)),
                  f"{name}: dx is not the gather kernel over bwd")
            expect_f = spmm.variant_name(
                dtype, D * x.element_size() % 16 == 0 and not mis, True)
            expect_b = spmm.variant_name(
                dtype, D * wg.element_size() % 16 == 0, False)
            check(v_f == {expect_f: 1} and v_b == {expect_b: 1},
                  f"{name}: launched {v_f} forward, {v_b} backward; "
                  f"expected {expect_f}, {expect_b}")
            xr = x.float().clone().requires_grad_(True)
            t1r, tkr = (t.clone().requires_grad_(True) for t in (t1, tk))
            ref = spmm.gather_segment_sum_reference(
                xr, f.indptr, f.senders, f.n_rows, f.codes, t1r,
                None if k == 1 else tkr, n)
            (ref * w).sum().backward()
            ref = ref.detach()
            # summation-order bounds (module docstring): a relative factor
            # of the sum of |terms|, + 1e-5
            absf = spmm.gather_segment_sum_reference(
                x.float().abs(), f.indptr, f.senders, f.n_rows, f.codes,
                t1.abs(), None if k == 1 else tk.abs(), n)

            def rows_bound(n_rows):
                return 2 * math.sqrt(n_rows) * 2.0 ** -24
            dx_ref = (xr.grad if dtype == torch.float32 else
                      spmm.gather_segment_sum_reference(
                          wg.float(), sub.bwd.indptr, sub.bwd.senders,
                          sub.bwd.n_rows))
            grads = [("fwd", out, ref, absf, 1e-6),
                     ("dx", grad_k, dx_ref, None, 0.0),
                     ("d table1", t1k.grad, t1r.grad,
                      sub.counts1.t() @ w[:n].abs(), rows_bound(n))]
            if k > 1:
                ck = sub.countsk_hm.reshape(-1, VK)
                grads.append(("d tablek", tkk.grad, tkr.grad,
                              ck.t() @ w[n:].abs(), rows_bound(ck.shape[0])))
                check(bool((tkk.grad[0] == 0).all()),
                      f"{name}: d tablek row 0 is not 0")
            else:
                check(tkk.grad is None, f"{name}: k=1 gave a tablek grad")
            check(bool((t1k.grad[0] == 0).all()),
                  f"{name}: d table1 row 0 is not 0")
            torch.cuda.synchronize()
            msg = []
            for what, got, want, absum, rel in grads:
                tol = 1e-5 + (0.0 if absum is None
                              else rel * float(absum.max()))
                err = float((got - want).abs().max())
                torch.testing.assert_close(
                    got, want, rtol=0.0, atol=tol,
                    msg=lambda m: f"{name} {what}: {m}")
                msg.append(f"{what} {err:.3e} (tol {tol:.1e})")
                note(v_f if what == "fwd" else
                     (v_b if what == "dx" else ()), err,
                     D if shape is None else shape)
            log(f"[check] fused {name}: D {D} {str(dtype)[6:]}: max |err| "
                + ", ".join(msg) + f"; {expect_f} + {expect_b}")

        for k in range(1, K + 1):
            compare_fused(f"flagship k={k}", plan.slice_hops(k), H)
        compare_fused(f"flagship k={K} bf16", plan, H, dtype=torch.bfloat16)
        compare_fused(f"flagship k={K} misaligned", plan, H, mis=True)
        compare_fused(f"flagship k={K} bf16 misaligned", plan, H,
                      dtype=torch.bfloat16, mis=True)
        compare_fused(f"flagship k={K} D=13", plan, 13)
        # the CSL shapes: KPGIN/KPGCN/SAGE at D = H/K = 12 over the k=4
        # plan, GINE at D = H = 48 over its hop-1 slice
        cvk = cplan.countsk_hm.shape[2]
        compare(f"csl k={CSL_K}", cplan.fwd, cplan.bwd, CSL_H // CSL_K)
        compare_fused(f"csl k={CSL_K}", cplan, CSL_H // CSL_K, VK=cvk)
        c1 = cplan.slice_hops(1)
        compare("csl k=1 (GINE)", c1.fwd, c1.bwd, CSL_H)
        compare_fused("csl k=1 (GINE)", c1, CSL_H, VK=cvk)
        # the QM9 shapes: KPGINPlus at D = H = 128 over the k=8 plan (its
        # hop prefixes as the flagship's); KPGINPrime K=16 at D = H/K = 8
        # over the k=16 plan (the kernel's 16 hops) and its GINE layers at
        # D = H over the hop-1 slice
        compare(f"qm9 k={QM9_K}", qplan.fwd, qplan.bwd, QM9_H, shape="qm9")
        compare_fused(f"qm9 k={QM9_K}", qplan, QM9_H, VK=qvk, shape="qm9")
        compare(f"qm9 KPGINPrime k={PRIME_K}", pplan.fwd, pplan.bwd,
                QM9_H // PRIME_K, shape="prime")
        compare_fused(f"qm9 KPGINPrime k={PRIME_K}", pplan, QM9_H // PRIME_K,
                      VK=pvk, shape="prime")
        p1 = pplan.slice_hops(1)
        compare("qm9 KPGINPrime k=1 (GINE)", p1.fwd, p1.bwd, QM9_H,
                shape="prime gine")
        compare_fused("qm9 KPGINPrime k=1 (GINE)", p1, QM9_H, VK=pvk,
                      shape="prime gine")

        # the generated-data shapes: KPGINPlus at D = H (counting K=3
        # D=96, node property K=6 D=128, graph property K=6 D=96), KPGIN
        # at D = H/K (TU K=2 D=16)
        for label, sl in slices.items():
            compare(f"{label} k={sl.cfg.K}", sl.plan.fwd, sl.plan.bwd, sl.D,
                    shape=label)
            compare_fused(f"{label} k={sl.cfg.K}", sl.plan, sl.D,
                          VK=sl.plan.countsk_hm.shape[2], shape=label)

        # the expressiveness shapes: EXP/CEXP KPGIN K=3 D=16, SR25 K=4
        # D=12 (hops 3-4 empty), the simulation's forward at K=2 D=32 and
        # its sweep's K=1..4 (D=64/32/21/16; 21 takes the scalar variant),
        # profile_step's large plan at D=34 (scalar) over 16,384 nodes, its
        # f32 sums under the hub rule's tolerance
        for label, sl in expr.items():
            compare(f"{label} k={sl.cfg.K}", sl.plan.fwd, sl.plan.bwd, sl.D,
                    shape=label)
            compare_fused(f"{label} k={sl.cfg.K}", sl.plan, sl.D,
                          VK=sl.plan.countsk_hm.shape[2], shape=label)
        for label, (p, k, d) in sim_plans.items():
            compare_fused(f"{label} k={k}", p, d, VK=hop_k_rows(p),
                          shape=label)
        compare(f"large k={large_cfg.K}", lplan.fwd, lplan.bwd, LD, hub=True,
                shape="large")
        compare_fused(f"large k={large_cfg.K}", lplan, LD,
                      VK=lplan.countsk_hm.shape[2], shape="large")
        # the node legs' rectangular plans (rank 0's): forward K·n_local
        # rows over K·n_ext sender rows, backward the transpose
        # (rows_per_hop = n_ext); the flagship's first hop window too
        for label, (sp, d) in par.shard_plans.items():
            poly = "polymers" in label
            compare(label, sp.fwd, sp.bwd, d, hub=poly, shape=label)
            compare_fused(label, sp, d, VK=sp.countsk_hm.shape[2],
                          shape=label)
        sp1 = par.shard_plans["shard flagship P=2"][0].slice_hops(1)
        compare("shard flagship P=2 k=1", sp1.fwd, sp1.bwd, H,
                shape="shard flagship P=2")
        compare_fused("shard flagship P=2 k=1", sp1, H, VK=VK,
                      shape="shard flagship P=2")
        for label, (tp, d) in tplans.items():
            compare(label, tp.fwd, tp.bwd, d, shape=label)
            compare_fused(label, tp, d, VK=hop_k_rows(tp), shape=label)

        # determinism: three launches of every variant on one input, each
        # on the CSR where the main path launches it
        fwd, bwd = plan.fwd, plan.bwd
        t1 = torch.randn(V1, H, device=dev, generator=gen)
        tk = torch.randn(VK, H, device=dev, generator=gen)
        tabs = dict(codes=fwd.codes, table1=t1, tablek=tk)
        variants = {}               # variant -> (csr, timed inputs, tables)
        for fused in (False, True):
            csr = fwd if fused else bwd
            x32 = [torch.randn(csr.n_cols, H, device=dev, generator=gen)
                   for _ in range(8)]
            for dtype in (torch.float32, torch.bfloat16):
                for mis in (False, True):
                    inputs = [v.to(dtype) for v in x32]
                    if mis:
                        inputs = [misalign(v) for v in inputs]
                    variants[spmm.variant_name(dtype, not mis, fused)] = (
                        csr, inputs, tabs if fused else {})
        for vname, (csr, inputs, kw) in variants.items():
            outs, v = launched(spmm, lambda: [csr.gather(inputs[0], **kw)
                                              for _ in range(3)])
            check(v == {vname: 3}, f"determinism: {vname} launched {v}")
            check(all(torch.equal(outs[0], o) for o in outs[1:]),
                  f"{vname}: three launches on one input differ")
        log(f"[check] determinism: 3 launches bit-identical for each of "
            f"{len(variants)} variants")

        mark("check")
        # ---- 2b. the kernel's pytest cases, in a process of their own ----
        t0 = time.perf_counter()
        rc, passed, summary, out = kernel_tests()
        log(f"[kernel tests] {' '.join(CARD_TESTS)}: {summary} "
            f"(exit {rc}) in {time.perf_counter() - t0:.1f} s")
        check(rc == 0 and passed > 0,
              f"kernel tests: exit {rc}, {passed} passed:\n{out}")
        mark("kernel tests")
        # ---- 2c. the BiLSTM kernel at the main path's shapes ----
        lstm_entries, lstm_steps = lstm_phase(SimpleNamespace(
            torch=torch, dev=dev, lstm_cases={
                "flagship combine": (mcfg, fb),
                "qm9 combine": (qmcfg, qfb),
                f"qm9 KPGINPrime K={PRIME_K} combine": (pmcfg, pfb),
                "flagship JK attention": (dataclasses.replace(
                    mcfg, JK="attention"), fb)}))
        mark("lstm")
        fused_v = spmm.variant_name(torch.float32, True, True)
        gather_v = spmm.variant_name(torch.float32, True, False)

        def first_step_loss(sl, batch, device):
            """The trainer's first-step loss before its update: the model
            initialized from SEED on the CPU (or from the checkpoint
            ``sl.load``, a warm start), moved to ``device``; this launches
            no kernel (the CPU takes the plain version, COO and dense have
            no kernel)."""
            model = init_parameters(make_model(sl.cfg), SEED)
            if getattr(sl, "load", None):
                load_checkpoint(sl.load, model)
            model = model.to(device)
            b = batch.to(device)
            with torch.no_grad():
                (lsum, cnt), v = launched(spmm, lambda: _masked_loss(
                    model(b, train=True), b.y,
                    _batch_target_mask(b, sl.node_level), sl.loss))
            check(not v, f"a first step on {device} launched {v}")
            return float(lsum / cnt)

        def script_phase(label, sl, backends=("coo", "dense")):
            """``sl.main(sl.argv)`` on the card: its epochs, finite losses
            and metrics, per train step L fused forward + L gather backward
            launches at width sl.D and per eval step L fused (none at
            L = 0: the coo and dense backends), and its first-step loss
            equal to the same step on the CPU (plain version) and on the
            card on each of ``backends`` (rtol ``sl.rtol``, default 1e-4);
            the CPU's batch comes from ``sl.loaders[sl.cpu_mode]``
            (default "pallas").
            ``sl.variants`` names the (fused, gather) variants, f32 by
            default.  Records the dtypes of the model's parameters and
            norm statistics after the run in ``sl.dtypes``, and each card
            backend's first step (its batch on the card, its sorted
            segment sums by (variant, D), counted from 0 just before it)
            in ``sl.sorted_sums``.  Returns (rows, step losses, launches
            per variant, per (variant, D))."""
            fv, gv = getattr(sl, "variants", (fused_v, gather_v))
            rtol = getattr(sl, "rtol", 1e-4)
            rows = []
            sl.dtypes = set()

            def on_epoch(epoch, model, row):
                rows.append(row)
                sl.dtypes = {t.dtype for t in model.parameters()} | {
                    t.dtype for n, t in model.named_buffers()
                    if "running" in n}
                if getattr(sl, "on_epoch", None):
                    sl.on_epoch(epoch, model, row)
            spmm.reset_launch_counts()
            lstm_ops.reset_launch_counts()
            t0 = time.perf_counter()
            result = sl.main(sl.argv, epoch_callback=on_epoch)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            v = dict(spmm.gather_segment_sum.variant_launches)
            w = +Counter(spmm.gather_segment_sum.width_launches)
            sl.lstm_w = +Counter(lstm_ops.launches)
            losses = np.concatenate([r["step_losses"] for r in rows])
            n_tr = sl.epochs * sl.train_steps
            n_ev = sl.epochs * sl.val_steps + sl.test_steps * sum(
                any(k.startswith("test_") for k in r) for r in rows)
            expect = ({fv: (n_tr + n_ev) * sl.L, gv: n_tr * sl.L}
                      if sl.L else {})
            log(f"[{label}] {len(rows)} epochs in {secs:.1f} s: {n_tr} train "
                f"steps, {n_ev} eval steps, train_loss "
                + ", ".join(f"{r['train_loss']:.5f}" for r in rows) + "; "
                + ", ".join(f"{k} {x:.5f}" for k, x in rows[-1].items()
                            if k.startswith(("val_", "test_"))
                            and isinstance(x, float))
                + f"; returns {result:.5f}; kernel launches {v} (expected "
                f"{expect}), by width {dict(w)}")
            check(len(rows) == sl.epochs and len(losses) == n_tr,
                  f"{label}: {len(rows)} epochs, {len(losses)} train steps")
            check(math.isfinite(result) and np.isfinite(losses).all()
                  and all(math.isfinite(x) for r in rows for x in r.values()
                          if isinstance(x, float)),
                  f"{label}: non-finite loss or metric")
            check(v == expect and set(w) <= {(fv, sl.D), (gv, sl.D)},
                  f"{label}: kernel launches {v} {dict(w)} != {expect} at "
                  f"D={sl.D} (per train step L fused forward + L gather "
                  f"backward, per eval step L fused forward)")
            # the BiLSTM kernel: each of the model's BiLSTMs (an attention
            # combine a K-hop layer, JK attention) once a forward, once a
            # backward, whatever the backend
            n_bi = sum(isinstance(m, BiLSTM)
                       for m in make_model(sl.cfg).modules())
            ldt = getattr(torch, sl.cfg.compute_dtype)
            lexp = ({lstm_ops.variant_name("fwd", ldt): (n_tr + n_ev) * n_bi,
                     lstm_ops.variant_name("bwd", ldt): n_tr * n_bi}
                    if n_bi else {})
            lv = Counter()
            for (vname, _, _), n in sl.lstm_w.items():
                lv[vname] += n
            log(f"[{label}] BiLSTM kernel launches {dict(lv)} (expected "
                f"{lexp}), by (variant, T, H) {dict(sl.lstm_w)}")
            check(dict(lv) == lexp, f"{label}: BiLSTM kernel launches "
                  f"{dict(lv)} != {lexp} ({n_bi} BiLSTMs a forward)")
            refs = {"CPU": first_step_loss(sl, first_batch(
                sl.loaders[getattr(sl, "cpu_mode", "pallas")]), "cpu")}
            sl.sorted_sums = {}
            for name in backends:
                fb_ = first_batch(sl.loaders[name])
                segment.reset_launch_counts()
                refs[f"--backend {name} on the card"] = first_step_loss(
                    sl, fb_, dev)
                torch.cuda.synchronize()
                sl.sorted_sums[name] = (fb_.to(dev), +Counter(
                    segment.sorted_segment_sum.width_launches))
            got = float(losses[0])
            rel = {k: abs(got - x) / abs(x) for k, x in refs.items()}
            log(f"[{label}] first-step loss GPU {got:.7f}, " + ", ".join(
                f"{k} {x:.7f} (rel diff {rel[k]:.2e})"
                for k, x in refs.items()))
            check(max(rel.values()) <= rtol,
                  f"{label}: first-step loss differs by "
                  + ", ".join(f"{x:.2e} ({k})" for k, x in rel.items())
                  + f" > {rtol:g}")
            return rows, losses, v, w

        # ---- 3. the main path: train_zinc at full width ----
        zinc = SimpleNamespace(
            main=train_zinc.main,
            argv=train_argv(work, os.path.join(work, "save"), "cuda"),
            cfg=mcfg, loss="l1", node_level=False, L=L, D=H, epochs=1,
            train_steps=math.ceil(N_TRAIN / BATCH),
            val_steps=math.ceil(N_VAL / BATCH),
            test_steps=math.ceil(N_TEST / BATCH),
            loaders={"pallas": tl, "coo": GraphLoader(
                tl.graphs, BATCH, shuffle=True, seed=SEED, mode="coo")})
        _, zlosses, _, path_w = script_phase("train", zinc, ("coo",))

        mark("train")
        # ---- 3a. the public API; 3b. the steps repeat on the card ----
        ctx = SimpleNamespace(
            torch=torch, spmm=spmm, dev=dev, work=work, args=args,
            splits=splits, zinc_train=zinc_train, tl=tl, mcfg=mcfg,
            zloss=float(zlosses[0]), fused_v=fused_v, gather_v=gather_v,
            ctl=ctl, lk=lk)
        api_w = api_phase(ctx)
        mark("api")
        det_runs = determinism_phase(ctx)
        mark("determinism")
        op_gap_phase(ctx)
        mark("op_gap")
        prefetch_phase(ctx)
        mark("prefetch")
        # ---- 3b. --bf16 on the main path: the kernel's bf16 variants ----
        fused_b = spmm.variant_name(torch.bfloat16, True, True)
        gather_b = spmm.variant_name(torch.bfloat16, True, False)
        bargv = zinc.argv + ["--bf16"]
        bmcfg = common.model_config(
            train_zinc.parser().parse_args(bargv),
            input_encoder=("embedding", 21), task="graph_regression",
            output_size=1)
        check(bmcfg.compute_dtype == "bfloat16", "--bf16 gave "
              f"compute_dtype {bmcfg.compute_dtype}")
        zinc_bf16 = SimpleNamespace(**dict(
            vars(zinc), argv=bargv, cfg=bmcfg, variants=(fused_b, gather_b),
            rtol=BF16_RTOL))
        _, blosses, _, bf16_w = script_phase("bf16", zinc_bf16, ("coo",))
        # the bf16 COO step's sorted sums: the sum's bf16 variant at the
        # flagship's widths, timed and checked beside the [determinism]
        # legs'
        coo_bf16 = zinc_bf16.sorted_sums["coo"]
        log(f"[bf16] the COO first step's sorted segment sums by (variant, "
            f"D): {dict(coo_bf16[1])}")
        check(any("bf16" in v for v, _ in coo_bf16[1]),
              "bf16: the COO step launched no bf16 sorted segment sum")
        det_runs["coo bf16"] = coo_bf16
        rel = abs(blosses[0] - zlosses[0]) / abs(zlosses[0])
        log(f"[bf16] first-step loss {blosses[0]:.7f}, the f32 run's "
            f"{zlosses[0]:.7f} (rel diff {rel:.2e}, bound 5e-2); parameters "
            f"and norm statistics after the run: {sorted(map(str, zinc_bf16.dtypes))}")
        check(rel <= 5e-2, f"bf16: first-step loss {rel:.2e} from the f32 "
              f"run's > 5e-2")
        check(zinc_bf16.dtypes == {torch.float32},
              f"bf16: parameters or norm statistics in {zinc_bf16.dtypes}")
        # the bf16 train step on one fixed batch; its profile names the
        # LSTM kernels the bf16 combine runs on (the port's bf16 BiLSTM
        # kernel, no cuDNN RNN kernel)
        bmodel = init_parameters(make_model(bmcfg), SEED).to(dev)
        bopt = make_optimizer(bmodel.parameters(), 1e-3)
        bbatch = fb.to(dev)

        def bf16_step():
            return train_step(bmodel, bopt, bbatch)
        # the activations run in bf16, not only the loss bounds' outputs:
        # every linear map and LSTM of the K-hop layers returns bf16 on
        # the card, the step launches the BiLSTM kernel's bf16 variants
        # (once a BiLSTM forward and backward) and its profile shows them
        # and a bf16
        # GEMM (a model that computed in f32 and cast its output would
        # meet the loss bounds above)
        out_dtypes = {}
        hooks = [m.register_forward_hook(
            lambda mod, args, out, n=n: out_dtypes.__setitem__(n, out.dtype))
            for n, m in bmodel.named_modules()
            if isinstance(m, (TorchLinear, BiLSTM))]
        lstm_ops.reset_launch_counts()
        try:
            _, v = launched(spmm, bf16_step)
        finally:
            for h in hooks:
                h.remove()
        check(v == {fused_b: L, gather_b: L},
              f"the bf16 train step launched {v}")
        blv = Counter()
        for (vname, _, _), n in lstm_ops.launches.items():
            blv[vname] += n
        n_bi = sum(isinstance(m, BiLSTM) for m in bmodel.modules())
        bl_expect = {lstm_ops.variant_name("fwd", torch.bfloat16): n_bi,
                     lstm_ops.variant_name("bwd", torch.bfloat16): n_bi}
        log(f"[bf16] the step's BiLSTM kernel launches {dict(blv)}")
        check(dict(blv) == bl_expect, f"bf16: the step's BiLSTM kernel "
              f"launches {dict(blv)} != {bl_expect}")
        layer_out = {n: d for n, d in out_dtypes.items() if n.startswith(
            ("embedding_model.gnn", "embedding_model.output_proj"))}
        f32_out = sorted(n for n, d in out_dtypes.items()
                         if d != torch.bfloat16)
        log(f"[bf16] linear and LSTM outputs of the step: "
            f"{len(out_dtypes) - len(f32_out)} of {len(out_dtypes)} bf16, "
            f"all {len(layer_out)} of the K-hop layers' and the output "
            f"projection's among them; f32: {f32_out}")
        check(layer_out and set(layer_out.values()) == {torch.bfloat16},
              f"bf16: a K-hop layer's linear map or LSTM returned "
              f"{sorted(map(str, set(layer_out.values())))}")
        bstep_ms = host_step_ms(torch, bf16_step)
        log(f"[time] flagship bf16 train step {bstep_ms:.2f} ms")
        bprof = profile_step(torch, bf16_step, bstep_ms, "flagship bf16")
        if bprof is not None:
            ours, other = rnn_kernels(bprof[4])
            gemm16 = [k[:60] for k in bprof[4]
                      if "gemm" in k.lower() and "bf16" in k.lower()]
            log(f"[bf16] the step's bf16 GEMMs: {gemm16}")
            check(ours and not other
                  and all("__nv_bfloat16" in k for k in ours),
                  f"bf16: the step's LSTM ran {[k[:60] for k in ours]} "
                  f"and {[k[:60] for k in other]}")
            check(gemm16, "bf16: the step ran no bf16 GEMM")

        mark("bf16")
        # ---- 3c. resident epochs against per-batch ones ----
        def resident_runs(label, base, argv, runs):
            """The runs ``runs`` ({name: (extra argv, resident expected)})
            of ``base``'s script with ``argv(save_dir) + extra``, under
            default algorithms (every sum of every backend adds in one
            order on the card, so two runs of one mode repeat:
            ``resident_gate``).  Each run's log must show the expected
            decision.  Returns {name: (step losses, train epoch
            seconds)}."""
            out = {}
            for name, (extra, resident) in runs.items():
                save = os.path.join(work, "resident",
                                    f"{label}_{name}".replace(" ", "_"))
                rsl = SimpleNamespace(**dict(
                    vars(base), L=0, argv=argv(save) + list(extra)))
                rows, losses, _, _ = script_phase(
                    f"resident {label} {name}", rsl, ())
                text = run_log(save)
                went = ("resident store:" in text
                        or "resident stores" in text)
                line = [x.split("] ", 1)[-1] for x in text.splitlines()
                        if "resident store" in x or "per-batch epochs" in x]
                log(f"[resident] {label} {name}: "
                    f"{line[0] if line else 'no decision logged'}; "
                    f"train epoch {rows[0]['seconds']:.3f} s")
                check(went == resident, f"resident {label} {name}: went "
                      f"resident {went}, expected {resident}")
                out[name] = (losses, rows[0]["seconds"])
            return out

        def resident_gate(label, out, resident, per, per2, same_batches):
            """The resident run's step losses against the per-batch run's
            within rtol 1e-4: every step where the batches are the same
            (dense) and the per-batch run repeats itself bit for bit;
            else the first step only.  Two runs that sum in another order
            (COO's slot layout against collate's packing: the one-hot
            graph-level sums) drift apart from the second step on: Adam's
            first updates
            move each weight by about lr * sign(g), and rounding flips
            the sign of gradients near 0 (PERF.md §6).  Logs both runs'
            drift."""
            r, p, p2 = out[resident][0], out[per][0], out[per2][0]
            check(len(r) == len(p) == len(p2),
                  f"{label}: {len(r)}, {len(p)}, {len(p2)} steps")
            rel, self_rel = np.abs(r - p) / np.abs(p), np.abs(p2 - p) / np.abs(p)
            repeats = bool(np.array_equal(p, p2))
            n = len(r) if same_batches and repeats else 1
            log(f"[resident] {label}: {resident} against {per}, rel diff per "
                f"step {np.array2string(rel, precision=2, separator=',')}; "
                f"{per2} against {per}: largest {self_rel.max():.2e}"
                f"{' (bit-identical)' if repeats else ''}; gated: steps 1.."
                f"{n} (rtol 1e-4); train epoch {out[resident][1]:.3f} s "
                f"resident, {out[per][1]:.3f} / {out[per2][1]:.3f} s per "
                f"batch")
            check(rel[:n].max() <= 1e-4, f"{label}: {resident}'s step losses "
                  f"differ from {per}'s by {rel[:n].max():.2e} > 1e-4 in "
                  f"steps 1..{n}")
            return rel

        zinc_argv = lambda save: train_argv(work, save, "cuda")  # noqa: E731
        coo_rule = resident_rule("auto", zinc.loaders["coo"])
        log(f"[resident] coo auto decides: {coo_rule[1]}")
        coo_off = ("--backend", "coo", "--resident", "off")
        runs = {"auto": (("--backend", "coo"), coo_rule[0]),
                "off": (coo_off, False),
                "on": (("--backend", "coo", "--resident", "on"), True)}
        if coo_rule[0]:         # auto went resident: a second per-batch run
            runs["off again"] = (coo_off, False)
        out = resident_runs("coo", zinc, zinc_argv, runs)
        coo_rel = resident_gate("coo", out, "on", "off",
                                "off again" if coo_rule[0] else "auto",
                                False)

        # the COO store's slot layout against collate's packing of the
        # same 64 graphs, before any update: the loss, every graph's
        # prediction and every gradient under the gradient gate.  The
        # collated steps (the ulp-moved one too) replay the gathered
        # step's ReLU branches on the real nodes, which both layouts hold
        # in the same order (every ReLU of the model is node-level)
        def first_step(batch, moved=False):
            model = init_parameters(make_model(mcfg), SEED)
            model = (ulp_moved(torch, model) if moved else model).to(dev)
            pred = model(batch, train=True)
            lsum, cnt = _masked_loss(pred, batch.y, batch.graph_mask, "l1")
            (lsum / cnt).backward()
            return (float((lsum / cnt).detach()), pred.detach()[:BATCH],
                    {n: p.grad.cpu() for n, p in model.named_parameters()
                     if p.grad is not None})
        gathered = gather_any(build_coo_store(zinc_train, device=dev),
                              torch.arange(BATCH, device=dev))
        collated = zinc.loaders["coo"]._collate(zinc_train[:BATCH]).to(dev)
        layouts = (gathered.node_mask.cpu(), collated.node_mask.cpu())
        gathered_relu = []
        with relu_branches(torch, gathered_relu, replay=False):
            loss_r, pred_r, grads_r = first_step(gathered)
        with relu_branches(torch, gathered_relu, replay=True,
                           layouts=layouts) as flips:
            loss_p, pred_p, grads_p = first_step(collated)
        with relu_branches(torch, gathered_relu, replay=True,
                           layouts=layouts):
            _, _, grads_u = first_step(collated, moved=True)
        leaves = grad_leaves(grads_r, grads_p, grads_p, grads_u,
                             "coo: the gathered batch")
        over = [t for t in leaves if t[1] > 1.0]
        # a leaf whose ulp move reaches a quarter of its largest gradient
        # is rounding noise (a bias ahead of a batch norm: 0 in exact
        # arithmetic); the 8x ulp term admits it, and it is named here
        noise = sorted(t[2] for t in leaves if t[5] >= 0.25 * t[4])
        flips_line, flip_rel = flip_text(flips, gathered_relu)
        pred_err = float((pred_r - pred_p).abs().max())
        pscale = float(pred_p.abs().max())
        log(f"[resident] coo: the first batch gathered from the store "
            f"against collated: loss {loss_r:.7f} / {loss_p:.7f} (rel diff "
            f"{abs(loss_r - loss_p) / abs(loss_p):.2e}); {BATCH} "
            f"predictions, max |err| {pred_err:.2e} of max {pscale:.2e}; "
            f"{flips_line} in the collated layout; {len(leaves)} gradients "
            f"under the gradient gate, worst by |err| / leaf max: "
            f"{leaf_text(max(leaves))}; worst by |err| / tol: "
            f"{leaf_text(max(leaves, key=lambda t: t[1]))}; rounding-noise "
            f"leaves (ulp move >= 1/4 of the leaf max): {len(noise)} "
            f"{noise}")
        if over:
            log(f"[resident] coo: {len(over)} gradients outside the gate: "
                + "; ".join(leaf_text(t) for t in over))
        check(abs(loss_r - loss_p) <= 1e-5 * abs(loss_p)
              and pred_err <= 1e-5 * max(pscale, 1.0),
              f"coo: the gathered batch's first step differs from the "
              f"collated one's (loss {loss_r} / {loss_p}, predictions "
              f"{pred_err:.2e})")
        check(not over, f"coo: the gathered batch's first step has "
              f"{len(over)} gradients outside the gate")
        check(flip_rel <= 1e-4, f"coo: a ReLU input {flip_rel:.2e} of its "
              f"call's largest from 0 took another branch in the gathered "
              f"layout")
        # the control for the drift above: rounding alone.  The per-batch
        # run's first 4 steps again, from its weights and from the same
        # weights moved by an ulp, under default algorithms (the steps
        # repeat); the parameters whose entries end furthest apart, by
        # the share of entries more than lr apart
        def coo_steps(batches, moved):
            model = init_parameters(make_model(mcfg), SEED)
            model = (ulp_moved(torch, model) if moved else model).to(dev)
            opt = make_optimizer(model.parameters(), args.lr, args.l2_wd)
            losses = [float(torch.div(*train_step(model, opt, b.to(dev))))
                      for b in batches]
            return (np.array(losses), {n: p.detach().cpu()
                                       for n, p in model.named_parameters()})
        control = first_batches(zinc.loaders["coo"], 4)
        (base, pb), (moved, pm) = (coo_steps(control, m)
                                   for m in (False, True))
        apart = sorted(((float(((pm[n] - p).abs() > args.lr).float().mean()),
                         n) for n, p in pb.items()), reverse=True)

        def steps(a):
            return np.array2string(a, precision=2, separator=",")
        log(f"[resident] coo: control, the per-batch steps from weights "
            f"moved by an ulp against unmoved, rel diff per step "
            f"{steps(np.abs(moved - base) / np.abs(base))} (resident against "
            f"per batch: {steps(coo_rel[:4])}); "
            f"step 1 loss {base[0]:.7f}, the per-batch run's "
            f"{out['off'][0][0]:.7f}; most entries more than lr apart after "
            f"4 steps: " + ", ".join(f"{n} {x:.2f}" for x, n in apart[:6]))
        out = resident_runs("dense", zinc, zinc_argv, {
            "auto": (("--dense",), True),
            "off": (("--dense", "--resident", "off"), False),
            "off again": (("--dense", "--resident", "off"), False)})
        resident_gate("dense", out, "auto", "off", "off again", True)
        # one step's host time, launches and idle share, resident (the
        # batch gathered from the store on the card) against per-batch
        # (the host-collated batch copied to the card)
        for mode in ("dense", "coo"):
            loader = GraphLoader(zinc_train, BATCH, shuffle=True, seed=SEED,
                                 **dict(lk, mode=mode))
            store = (build_dense_store(zinc_train, loader.n_slot, loader.v1,
                                       loader.vk, device=dev)
                     if mode == "dense" else build_coo_store(
                         zinc_train, device=dev))
            idx = torch.arange(BATCH, device=dev)
            host_batch = loader._collate(zinc_train[:BATCH])
            rmodel = init_parameters(make_model(mcfg), SEED).to(dev)
            ropt = make_optimizer(rmodel.parameters(), 1e-3)
            for how, step in (
                    ("resident", lambda: train_step(
                        rmodel, ropt, gather_any(store, idx))),
                    ("per-batch", lambda: train_step(
                        rmodel, ropt, host_batch.to(dev)))):
                rms = host_step_ms(torch, step)
                log(f"[time] {mode} {how} train step {rms:.2f} ms")
                prof = step_profiles[f"{mode} {how}"] = profile_step(
                    torch, step, rms, f"{mode} {how}")
                if mode == "coo" and prof is not None:
                    # the edge -> node sums: the sorted sum's kernel (and
                    # the CSR it may build), and any index_add_ left
                    sums = [k for k in prof[6] if any(
                        w in k for w in ("gather_segment_sum", "indexFunc",
                                         "searchsorted"))]
                    log(f"[profile] {mode} {how} train step: the edge -> "
                        f"node sums by kernel (device ms / launches a "
                        f"step): " + ("; ".join(
                            f"{k[:70]} {prof[6][k]:.4f} / {prof[5][k]:g}"
                            for k in sums) or "none"))

        mark("resident")
        # ---- 4. the CSL slice: train_csl at the reference width ----
        csl = SimpleNamespace(
            main=train_csl.main,
            argv=csl_argv(os.path.join(work, "csl"), "cuda", "pallas"),
            cfg=cmcfg, loss="cross_entropy", node_level=False, L=CSL_L,
            D=CSL_H // CSL_K, epochs=CSL_EPOCHS,
            train_steps=math.ceil(len(tr) / CSL_BATCH),
            val_steps=math.ceil(len(va) / CSL_BATCH),
            test_steps=math.ceil(len(te) / CSL_BATCH),
            loaders={"pallas": ctl, "coo": coo_tl})
        csl_w = script_phase("csl", csl, ("coo",))[3]

        mark("csl")
        # ---- 5. the other families, one step at CSL width ----
        cb = cfb.to(dev)

        def step_grads(model, batch, lr, wd, loss, node_level=False):
            """(loss, {parameter: grad on the host}, launches) of one
            optimizer step."""
            (lsum, cnt), v = launched(spmm, lambda: train_step(
                model, make_optimizer(model.parameters(), lr, wd), batch,
                loss, node_level=node_level))
            return (float(lsum / cnt),
                    {n: None if p.grad is None else p.grad.cpu()
                     for n, p in model.named_parameters()}, v)

        def gradient_gate(label, name, cfg, loader, hp, loss, expect,
                          node_level=False):
            """One step of ``cfg``'s model, initialized from SEED, on the
            card against the same step on the CPU, on ``loader.example()``:
            the loss, every parameter gradient against the CPU step that
            takes the card's ReLU branches (the module docstring's gate),
            each ReLU input whose branch differs within 1e-4 of its call's
            largest |input| of 0, and the card's launches per variant
            against ``expect``.  Returns the launches per (variant, D); the
            worst |err| / tol goes to ``gradient_gate.worst``."""
            batch = loader.example()

            def fresh():
                return init_parameters(make_model(cfg), SEED)
            card_relu = []
            w0 = Counter(spmm.gather_segment_sum.width_launches)
            with relu_branches(torch, card_relu, replay=False):
                loss_g, grads_g, v_g = step_grads(
                    fresh().to(dev), batch.to(dev), *hp, loss, node_level)
            torch.cuda.synchronize()
            w = Counter(spmm.gather_segment_sum.width_launches)
            w.subtract(w0)
            loss_c, grads_own, v_c = step_grads(fresh(), batch, *hp, loss,
                                                node_level)
            with relu_branches(torch, card_relu, replay=True) as flips:
                _, grads, v_r = step_grads(fresh(), batch, *hp, loss,
                                           node_level)
            with relu_branches(torch, card_relu, replay=True):
                _, grads_u, _ = step_grads(ulp_moved(torch, fresh()), batch,
                                           *hp, loss, node_level)
            rel = abs(loss_g - loss_c) / abs(loss_c)
            gscale = max(float(g.abs().max()) for g in grads.values()
                         if g is not None)
            gated_leaves = grad_leaves(grads_g, grads, grads, grads_u, name)
            own = grad_leaves(grads_g, grads_own, grads, grads_u, name)
            over = [t for t in gated_leaves if t[1] > 1.0]
            flips_line, flip_rel = flip_text(flips, card_relu)
            log(f"[{label}] {name}: loss GPU {loss_g:.7f} CPU {loss_c:.7f} "
                f"(rel diff {rel:.2e}); {flips_line} on the card; "
                f"{len(gated_leaves)} gradients against the CPU "
                f"step on the card's branches, largest {gscale:.2e}; worst "
                f"by |err| / leaf max: {leaf_text(max(gated_leaves))}; worst "
                f"by |err| / tol: "
                f"{leaf_text(max(gated_leaves, key=lambda t: t[1]))}; "
                f"against the CPU step on its own branches, "
                f"{sum(t[1] > 1.0 for t in own)} outside the gate, worst "
                f"{leaf_text(max(own, key=lambda t: t[1]))}; kernel launches "
                f"{v_g} (expected {expect}), by width {dict(+w)}")
            if over:
                log(f"[{label}] {name}: {len(over)} gradients outside the "
                    "gate: " + "; ".join(leaf_text(t) for t in over))
            check(not v_c and not v_r,
                  f"{name}: a CPU step launched {v_c or v_r}")
            check(v_g == expect, f"{name}: launches {v_g} != {expect}")
            gradient_gate.worst = max(t[1] for t in gated_leaves)
            check(not over, f"{name}: {len(over)} gradients outside the gate")
            check(flip_rel <= 1e-4, f"{name}: a ReLU input {flip_rel:.2e} of "
                  f"its call's largest from 0 took another branch on the card")
            check(rel <= 1e-4, f"{name}: loss differs by {rel:.2e} > 1e-4")
            return +w

        fam_w = Counter()
        for name, extra, expect in (
                ("KPGCN", (), {gather_v: 2 * CSL_L}),
                ("KPGraphSAGE", ("--aggr", "mean"),
                 {fused_v: CSL_L, gather_v: CSL_L}),
                ("KPGINPrime", ("--num_l1_layer", "1"),
                 {fused_v: CSL_L, gather_v: CSL_L})):
            fargs = train_csl.parser().parse_args(csl_argv(
                os.path.join(work, "csl"), "cuda", "pallas", name, extra))
            fcfg = common.model_config(fargs, input_encoder=("linear", 1),
                                       task="graph_classification",
                                       output_size=10)
            fam_w.update(gradient_gate(
                "families", name, fcfg, ctl, (fargs.lr, fargs.l2_wd),
                "cross_entropy", expect))

        mark("families")
        # ---- 6. the QM9 slice: train_qm9 at the canonical width ----
        n_qeval = math.ceil(QM9_MOLECULES // 10 / QM9_BATCH)   # val or test
        qm9 = SimpleNamespace(
            main=train_qm9.main,
            argv=qm9_argv(work, os.path.join(work, "qm9"), "cuda", "pallas",
                          QM9_VN_RD),
            cfg=qmcfg, loss="mse", node_level=False, L=QM9_L, D=QM9_H,
            epochs=QM9_EPOCHS,
            train_steps=math.ceil(len(qtrain) / QM9_BATCH),
            val_steps=n_qeval, test_steps=n_qeval, loaders=qloaders)
        _, qlosses, _, qm9_w = script_phase("qm9", qm9)
        qm9_w.update(gradient_gate(
            "qm9", f"KPGINPlus K={QM9_K} L={QM9_L} vn+rd", qmcfg,
            qloaders["pallas"], (qargs.lr, qargs.l2_wd), "mse",
            {fused_v: QM9_L, gather_v: QM9_L}))

        mark("qm9")
        # ---- 7. the dense backend end to end, and KPGINPrime at K=16 ----
        qm9_dense = SimpleNamespace(**dict(vars(qm9), L=0, argv=qm9_argv(
            work, os.path.join(work, "qm9"), "cuda", "coo",
            QM9_VN_RD + ("--dense",))))
        _, dlosses, _, _ = script_phase("dense", qm9_dense, ())
        rel = abs(dlosses[0] - qlosses[0]) / abs(qlosses[0])
        log(f"[dense] first-step loss {dlosses[0]:.7f}, the pallas run's "
            f"{qlosses[0]:.7f} (rel diff {rel:.2e})")
        check(rel <= 1e-4, f"dense: first-step loss differs by {rel:.2e} "
              f"from the pallas run's > 1e-4")
        pd = QM9_H // PRIME_K
        lstm_ops.reset_launch_counts()
        prime_w = gradient_gate(
            "qm9", f"KPGINPrime K={PRIME_K} L={PRIME_L}", pmcfg, ptl,
            (pargs.lr, pargs.l2_wd), "mse",
            {fused_v: PRIME_L, gather_v: PRIME_L})
        expect_pw = {(fused_v, pd): 1, (gather_v, pd): 1,
                     (fused_v, QM9_H): PRIME_L - 1,
                     (gather_v, QM9_H): PRIME_L - 1}
        check(dict(prime_w) == expect_pw,
              f"KPGINPrime launches by width {dict(prime_w)} != {expect_pw} "
              f"(one K-hop layer at D={pd}, then GINE at D={QM9_H})")
        prime_lstm_w = +Counter(lstm_ops.launches)
        log(f"[qm9] KPGINPrime K={PRIME_K} gated step: BiLSTM kernel "
            f"launches by (variant, T, H) {dict(prime_lstm_w)}")

        mark("dense and KPGINPrime")
        # ---- 8. the generated-data scripts at their canonical widths ----
        gen_w = {}
        for label, sl in slices.items():
            gen_w[label] = script_phase(label, sl)[3]
        # TU's --dense fold takes the resident path (the JAX script's
        # rule): its step losses against the same fold per batch
        out = resident_runs("tu", slices["tu"], lambda save: generated_argv(
            "tu", work, "cuda", "pallas") + ["--save_dir", save], {
            "dense": (("--dense",), True),
            "dense off": (("--dense", "--resident", "off"), False),
            "dense off again": (("--dense", "--resident", "off"), False)})
        resident_gate("tu", out, "dense", "dense off", "dense off again",
                      True)
        sl = slices["nprop"]
        gen_w["nprop"].update(gradient_gate(
            "nprop", f"KPGINPlus K={sl.cfg.K} L={sl.L} node regression",
            sl.cfg, sl.loaders["pallas"], (sl.args.lr, sl.args.l2_wd),
            sl.loss, {fused_v: sl.L, gather_v: sl.L}, node_level=True))

        mark("generated")
        # ---- 10. the expressiveness scripts, checkpoints and profiling ----
        ctx = SimpleNamespace(
            torch=torch, spmm=spmm, dev=dev, work=work, expr=expr,
            script_phase=script_phase, gradient_gate=gradient_gate,
            fused_v=fused_v, gather_v=gather_v, zinc=zinc, mcfg=mcfg,
            args=args, lk=lk, splits=splits, zinc_train=zinc_train,
            zlosses=zlosses, blosses=blosses, bmcfg=bmcfg, ctrain=ctrain,
            ctl=ctl, step_grads=step_grads, plan=plan, lplan=lplan, fb=fb,
            step_profiles=step_profiles,
            banded_tl=GraphLoader(zinc_train, BATCH, shuffle=True,
                                  seed=SEED, **dict(lk, mode="banded")))
        exp_w, cexp_w = exp_phase(ctx)
        mark("exp")
        sr_w, sr_gate_w = sr25_phase(ctx)
        mark("sr25")
        sim_w, sweep_w = sim_phase(ctx)
        mark("sim")
        search_w = search_phase(ctx)
        mark("search")
        ckpt_w = ckpt_phase(ctx)
        mark("ckpt")
        prof_w, large_w, _ = profile_phase(ctx)
        mark("profile")
        # ---- 11. the banded backend and the device prep ----
        banded_rows = banded_train_phase(ctx)
        mark("banded")
        _, gathered = banded_resident_phase(ctx, banded_rows)
        mark("banded resident")
        banded_bf16_phase(ctx)
        mark("banded bf16")
        banded_kpgcn_phase(ctx)
        mark("banded KPGCN")
        banded_spill_phase(ctx)
        mark("banded spill")
        banded_large_phase(ctx)
        mark("banded large")
        banded_tune_phase(ctx)
        mark("banded tune")
        device_prep_phase(ctx)
        mark("device_prep")
        # ---- 12. multi-rank training: data-parallel, node-sharded, dcn ----
        ctx.par, ctx.tl, ctx.lcfg = par, tl, large_cfg
        par_w = parallel_phase(ctx)
        mark("parallel")
        pscript_w = parallel_scripts_phase(ctx)
        mark("parallel scripts")
        # ---- 13. the tool scripts: tune_pallas, scaling_estimate,
        # make_parity_golden ----
        ctx.mark, ctx.card, ctx.tool_plans = mark, card, tplans
        tools_w = tools_phase(ctx)
        # ---- 9. times, on the flagship k=8 plan ----
        def sparse(c, dtype):
            n_e = c.senders.shape[0]
            return torch.sparse_csr_tensor(
                c.indptr.long(), c.senders.long(),
                torch.ones(n_e, device=dev, dtype=dtype),
                size=(c.n_rows, c.n_cols), check_invariants=False)

        def library_ms(c, inputs):
            """One torch.sparse.mm call on the same inputs; None where
            PyTorch has none for this type."""
            a = sparse(c, inputs[0].dtype)
            try:
                torch.sparse.mm(a, inputs[0])
            except RuntimeError as err:
                log(f"[time] torch.sparse.mm {inputs[0].dtype}: not "
                    f"timed ({str(err).splitlines()[0][:100]})")
                return None
            return time_ms(torch, lambda x: torch.sparse.mm(a, x), inputs)

        n = plan.counts1.shape[0]

        def timed(csr, inputs, kw):
            """(ms, plain ms, library ms, bound ms, bound by) of the kernel
            over csr."""
            ms = time_ms(torch, lambda x: csr.gather(x, **kw), inputs)
            kw_ref = dict(kw, rows_per_hop=csr.rows_per_hop) if kw else {}
            plain = time_ms(torch, lambda x: spmm.gather_segment_sum_reference(
                x, csr.indptr, csr.senders, csr.n_rows, **kw_ref), inputs)
            lib = None if kw else library_ms(csr, inputs)
            bound, by = kernel_bound_ms(csr, inputs[0].shape[1],
                                        inputs[0].element_size(), bool(kw))
            return ms, plain, lib, bound, by

        def show(t):
            ms, plain, lib, bound, by = t
            return (f"{ms:.4f} ms (plain {plain:.4f}, torch.sparse.mm "
                    f"{'none' if lib is None else format(lib, '.4f')}, bound "
                    f"{bound:.4f} by {by})")

        times = {}
        for vname, (csr, inputs, kw) in variants.items():
            times[vname], v = launched(spmm, lambda: timed(csr, inputs, kw))
            check(set(v) == {vname}, f"timing {vname} launched {v}")
            log(f"[time] {vname} over {'fwd' if kw else 'bwd'} "
                f"{show(times[vname])}")
        xs = variants[fused_v][1]       # f32 inputs with fwd.n_cols rows
        gather_f = timed(fwd, xs, {})
        n_e = fwd.senders.shape[0]
        log(f"[time] {gather_v} over fwd {show(gather_f)}; flagship "
            f"k={K} plan {fwd.n_rows} rows x D {H}, {n_e} edges; "
            f"{n_e / gather_f[0] / 1e3:.1f}M hop-edges/s")

        # the unfused composition the fused forward replaces: the gather,
        # then k counts @ table GEMMs on zero-row-0 tables, stack, add
        countsk_nm = plan.countsk.contiguous()         # (N, K-1, Vk)

        def unfused(x):
            out = fwd.gather(x).reshape(K, n, H)
            t1z = torch.cat([torch.zeros_like(t1[:1]), t1[1:]])
            tkz = torch.cat([torch.zeros_like(tk[:1]), tk[1:]])
            parts = [plan.counts1 @ t1z] + [countsk_nm[:, k - 1] @ tkz
                                            for k in range(1, K)]
            return out + torch.stack(parts, dim=0)
        got, want = unfused(xs[0]).reshape(-1, H), fwd.gather(xs[0], **tabs)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4,
                                   msg=lambda m: f"unfused vs fused: {m}")
        ms_unf = time_ms(torch, unfused, xs)
        log(f"[time] fused forward {times[fused_v][0]:.4f} ms vs the "
            f"unfused composition it replaces {ms_unf:.4f} ms (gather + {K} "
            f"GEMMs + stack + add; bound {times[fused_v][3]:.4f}); gather "
            f"alone {gather_f[0]:.4f} ms")

        # flagship train step on one fixed batch
        model = init_parameters(make_model(mcfg), SEED).to(dev)
        opt = make_optimizer(model.parameters(), 1e-3)
        batch = fb.to(dev)
        step_ms = host_step_ms(torch, lambda: train_step(model, opt, batch))
        log(f"[time] flagship train step {step_ms:.2f} ms, "
            f"{union_edges / step_ms / 1e3:.3f}M union edges/s "
            f"({union_edges} union edges, batch {BATCH})")
        step_profiles["pallas per-batch"] = fprof = profile_step(
            torch, lambda: train_step(model, opt, batch), step_ms,
            "flagship")
        if fprof is not None:
            ours, other = rnn_kernels(fprof[4])
            check(ours and not other, f"the flagship step's LSTM kernels: "
                  f"{ours} and {other}")

        mark("time flagship")
        # ---- the same times at the CSL shapes ----
        def shape_times(sub, D, label, vk):
            """The f32 variants where the main path launches them over this
            plan (the fused form over fwd, the gather over bwd; the 16-byte
            variants, or the scalar ones where D * 4 % 16 != 0) and the
            gather over fwd beside torch.sparse.mm; ``vk`` is the hop-k
            table's rows.  Returns the fused form's inputs and times."""
            vec = D * 4 % 16 == 0
            fv = spmm.variant_name(torch.float32, vec, True)
            gv = spmm.variant_name(torch.float32, vec, False)
            t1c = torch.randn(sub.counts1.shape[1], D, device=dev,
                              generator=gen)
            tkc = (torch.randn(vk, D, device=dev, generator=gen)
                   if sub.K > 1 else None)
            kw = dict(codes=sub.fwd.codes, table1=t1c, tablek=tkc)
            xf = [torch.randn(sub.fwd.n_cols, D, device=dev, generator=gen)
                  for _ in range(8)]
            xb = [torch.randn(sub.bwd.n_cols, D, device=dev, generator=gen)
                  for _ in range(8)]
            out = {}
            for what, csr, xs, k, vname in (
                    ("fwd", sub.fwd, xf, kw, fv),
                    ("bwd", sub.bwd, xb, {}, gv),
                    ("fwd", sub.fwd, xf, {}, gv)):
                t, v = launched(spmm, lambda: timed(csr, xs, k))
                check(set(v) == {vname}, f"timing {label} {vname} launched "
                      f"{v}")
                out[vname, what] = t
                log(f"[time] {label} D={D} {vname} over {what} {show(t)}; "
                    f"{csr.n_rows} rows, {csr.senders.shape[0]} edges")
            return xf, kw, out

        _, _, gt = shape_times(c1, CSL_H, "csl k=1 (GINE)", cvk)
        xf, kw, ct = shape_times(cplan, CSL_H // CSL_K, f"csl k={CSL_K}",
                                 cvk)
        # KPGCN's aggregation, the composition a scale/mean epilogue would
        # replace: sender pre-scale, the gather, the sender-weighted
        # histograms, K GEMMs, the receiver scale
        dis = torch.rsqrt(cplan.hop_deg + 1.0)
        cn = cplan.counts1.shape[0]

        def gcn(x):
            return spmm.khop_spmm(
                x.reshape(CSL_K, cn, -1), kw["table1"], kw["tablek"], cplan,
                scale=dis, sender_scale=dis, hop_major=True)
        with torch.no_grad():
            _, v = launched(spmm, lambda: gcn(xf[0]))
            check(v == {gather_v: 1}, f"the KPGCN aggregation launched {v}")
            ms_gcn = time_ms(torch, gcn, xf)
        log(f"[time] csl k={CSL_K} D={CSL_H // CSL_K}: KPGCN aggregation "
            f"(pre-scale + gather + weighted histograms + {CSL_K} GEMMs + "
            f"receiver scale) {ms_gcn:.4f} ms; the fused form alone "
            f"{ct[fused_v, 'fwd'][0]:.4f} ms (bound "
            f"{ct[fused_v, 'fwd'][3]:.4f}), the gather alone "
            f"{ct[gather_v, 'fwd'][0]:.4f} ms")

        # the CSL train step on one fixed batch
        cmodel = init_parameters(make_model(cmcfg), SEED).to(dev)
        copt = make_optimizer(cmodel.parameters(), cargs.lr, cargs.l2_wd)

        def csl_step():
            return train_step(cmodel, copt, cb, "cross_entropy")
        _, v = launched(spmm, csl_step)
        check(v == {fused_v: CSL_L, gather_v: CSL_L},
              f"the CSL train step launched {v}")
        cstep_ms = host_step_ms(torch, csl_step)
        c_union = sum(g.num_edges for g in ctrain[:CSL_BATCH])
        log(f"[time] csl train step {cstep_ms:.2f} ms, "
            f"{c_union / cstep_ms / 1e3:.3f}M union edges/s ({c_union} "
            f"union edges, batch {CSL_BATCH})")
        profile_step(torch, csl_step, cstep_ms, "csl")

        mark("time csl")
        # ---- the same times at the QM9 shapes ----
        _, _, qt = shape_times(qplan, QM9_H, f"qm9 k={QM9_K}", qvk)
        _, _, pt = shape_times(pplan, pd, f"qm9 KPGINPrime k={PRIME_K}", pvk)
        _, _, pgt = shape_times(pplan.slice_hops(1), QM9_H,
                                "qm9 KPGINPrime k=1 (GINE)", pvk)
        # the QM9 train step on one fixed batch, on the kernel and on dense
        q_union = sum(g.num_edges for g in qtrain[:QM9_BATCH])
        for label, b, expect in (
                ("qm9 pallas", qfb, {fused_v: QM9_L, gather_v: QM9_L}),
                ("qm9 dense", qdb, {})):
            qmodel = init_parameters(make_model(qmcfg), SEED).to(dev)
            qopt = make_optimizer(qmodel.parameters(), qargs.lr)
            qb = b.to(dev)

            def qm9_step():
                return train_step(qmodel, qopt, qb, "mse")
            _, v = launched(spmm, qm9_step)
            check(v == expect, f"the {label} train step launched {v}")
            qstep_ms = host_step_ms(torch, qm9_step)
            log(f"[time] {label} train step {qstep_ms:.2f} ms, "
                f"{q_union / qstep_ms / 1e3:.3f}M union edges/s ({q_union} "
                f"union edges, batch {QM9_BATCH})")
            prof = profile_step(torch, qm9_step, qstep_ms, label)
            # the virtual node's broadcast backward no longer serialises
            # on the pad graph's id (it took ~10 ms of ~32 before)
            if prof is not None:
                check(prof[3] < 1.0, f"{label}: indexing_backward_kernel "
                      f"{prof[3]:.3f} ms per step")
                ours, other = rnn_kernels(prof[4])
                check(ours and not other, f"the {label} step's LSTM "
                      f"kernels: {ours} and {other}")
        mark("time qm9")
        # ---- the same times at the generated-data shapes ----
        gen_t = {label: shape_times(sl.plan, sl.D, f"{label} k={sl.cfg.K}",
                                    sl.plan.countsk_hm.shape[2])[2]
                 for label, sl in slices.items()}
        # the node-property train step on one fixed batch
        sl = slices["nprop"]
        nmodel = init_parameters(make_model(sl.cfg), SEED).to(dev)
        nopt = make_optimizer(nmodel.parameters(), sl.args.lr,
                              sl.args.l2_wd)
        nb = sl.batch.to(dev)

        def nprop_step():
            return train_step(nmodel, nopt, nb, "mse", node_level=True)
        _, v = launched(spmm, nprop_step)
        check(v == {fused_v: sl.L, gather_v: sl.L},
              f"the node-property train step launched {v}")
        nstep_ms = host_step_ms(torch, nprop_step)
        log(f"[time] nprop train step {nstep_ms:.2f} ms, "
            f"{sl.union / nstep_ms / 1e3:.3f}M union edges/s ({sl.union} "
            f"union edges, {int(sl.batch.node_mask.sum())} nodes, batch "
            f"{sl.args.batch_size})")
        profile_step(torch, nprop_step, nstep_ms, "nprop")
        mark("time generated")
        # ---- the same times at the expressiveness and large shapes ----
        new_t = {label: shape_times(sl.plan, sl.D, f"{label} k={sl.cfg.K}",
                                    sl.plan.countsk_hm.shape[2])[2]
                 for label, sl in expr.items() if label != "cexp"}
        for label, (p, k, d) in sim_plans.items():
            new_t[label] = shape_times(p, d, f"{label} k={k}",
                                       hop_k_rows(p))[2]
        new_t["large"] = shape_times(lplan, LD, f"large k={large_cfg.K}",
                                     lplan.countsk_hm.shape[2])[2]
        mark("time expressiveness")
        shard_t = {label: shape_times(sp, d, label, sp.countsk_hm.shape[2])[2]
                   for label, (sp, d) in par.shard_plans.items()}
        mark("time shard plans")
        # ---- the banded aggregation beside the kernel path ----
        banded_times(ctx, gathered)
        mark("time banded")
        # ---- the plans of [tools] ----
        tool_t = {label: shape_times(tp, d, label, hop_k_rows(tp))[2]
                  for label, (tp, d) in tplans.items()}
        mark("time tool plans")
        # ---- the sorted segment sum at the [determinism] legs' shapes ----
        sorted_entries = sorted_sum_times(ctx, det_runs)
        mark("time sorted sums")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    check(set(errs) == set(variants),
          f"variants checked {sorted(errs)} != {sorted(variants)}")
    # launches by (variant, D) of the flagship, CSL and family runs, whose
    # widths are all distinct, and of the QM9 run and KPGINPrime step
    zinc_csl_w = path_w + csl_w + fam_w
    all_launches = Counter()
    new_runs = (exp_w + cexp_w + sr_w + sr_gate_w + sim_w + sweep_w
                + search_w + ckpt_w + prof_w + large_w)
    for (vname, _), n in sum(gen_w.values(), zinc_csl_w + qm9_w + prime_w
                             + bf16_w + new_runs).items():
        all_launches[vname] += n
    # the multi-rank legs (summed over their ranks) and the --parallel runs
    for (vname, _), n in sum(list(par_w.values()) + list(pscript_w.values()),
                             Counter()).items():
        all_launches[vname] += n
    # the main path's shapes, each timed on the CSR where it launches:
    # (name suffix, label, D, error key, fused times, gather times,
    # launches by (variant, D) of the run that takes that shape)
    shapes = [("", f"flagship k={K} plan", H, H, times[fused_v],
               times[gather_v], zinc_csl_w),
              ("", f"csl k={CSL_K} plan", CSL_H // CSL_K, CSL_H // CSL_K,
               ct[fused_v, "fwd"], ct[gather_v, "bwd"], zinc_csl_w),
              ("", "csl k=1 slice (GINE)", CSL_H, CSL_H, gt[fused_v, "fwd"],
               gt[gather_v, "bwd"], zinc_csl_w),
              (" qm9", f"qm9 k={QM9_K} plan", QM9_H, "qm9",
               qt[fused_v, "fwd"], qt[gather_v, "bwd"], qm9_w),
              (" qm9 KPGINPrime", f"qm9 KPGINPrime k={PRIME_K} plan", pd,
               "prime", pt[fused_v, "fwd"], pt[gather_v, "bwd"], prime_w),
              (" qm9 KPGINPrime GINE", "qm9 KPGINPrime k=1 slice (GINE)",
               QM9_H, "prime gine", pgt[fused_v, "fwd"],
               pgt[gather_v, "bwd"], prime_w)]
    shapes += [(f" {label}", f"{label} k={sl.cfg.K} plan", sl.D, label,
                gen_t[label][fused_v, "fwd"], gen_t[label][gather_v, "bwd"],
                gen_w[label]) for label, sl in slices.items()]
    check(set(zinc_csl_w) <= {(v, s[2]) for s in shapes[:3]
                              for v in (fused_v, gather_v)},
          f"the paths launched {dict(zinc_csl_w)}, outside the timed widths")
    entries = [dict(name=vname, **KERNEL, launches=all_launches.get(vname, 0),
                    max_abs_err=errs[vname], ms=ms, plain_ms=plain,
                    bound_ms=bound, bound_by=by, library_ms=lib)
               for vname, (ms, plain, lib, bound, by) in times.items()]
    for suffix, label, D, key, t_fused, t_gather, w in shapes:
        for vname, (ms, plain, lib, bound, by) in ((fused_v, t_fused),
                                                   (gather_v, t_gather)):
            entries.append(dict(
                name=f"{vname} D={D}{suffix}", **KERNEL,
                shape=f"{label}, D={D}", launches=w[vname, D],
                max_abs_err=errs_w[vname, key], ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=lib))
    # the expressiveness shapes, each with the launches of the run that
    # takes it: EXP (the EXP run), SR25 (the run and its gated step), the
    # simulation's forward-only fused launches (the main run at K=2, the
    # sweep at each K), and profile_step's large stage (scalar variants)
    def new_entry(vname, D, label, key, t, w):
        ms, plain, lib, bound, by = t
        return dict(name=f"{vname} D={D} {key}", **KERNEL,
                    shape=f"{label}, D={D}", launches=w[vname, D],
                    max_abs_err=errs_w[vname, key], ms=ms, plain_ms=plain,
                    bound_ms=bound, bound_by=by, library_ms=lib)
    for key, sl, w in (("exp", expr["exp"], exp_w),
                       ("sr25", expr["sr25"], sr_w + sr_gate_w)):
        for vname, what in ((fused_v, "fwd"), (gather_v, "bwd")):
            entries.append(new_entry(vname, sl.D, f"{key} k={sl.cfg.K} plan",
                                     key, new_t[key][vname, what], w))
    for key, (p, k, d) in sim_plans.items():
        fv = spmm.variant_name(torch.float32, d * 4 % 16 == 0, True)
        entries.append(new_entry(fv, d, f"{key} k={k} plan (forward only)",
                                 key, new_t[key][fv, "fwd"],
                                 sim_w if key == "sim" else sweep_w))
    for fused in (True, False):
        vname = spmm.variant_name(torch.float32, LD * 4 % 16 == 0, fused)
        entries.append(new_entry(
            vname, LD, f"profile_step large k={large_cfg.K} plan", "large",
            new_t["large"][vname, "fwd" if fused else "bwd"], large_w))
    # the node legs' rectangular plans (rank 0's), each with the launches
    # of its kernel-plan leg summed over the ranks
    shard_runs = {"shard flagship P=2": "node flagship P=2",
                  "shard polymers P=2": "node polymers P=2 kernel plan",
                  "shard polymers P=4": "node polymers P=4 kernel plan"}
    for label, (sp, d) in par.shard_plans.items():
        for fused in (True, False):
            vname = spmm.variant_name(torch.float32, d * 4 % 16 == 0, fused)
            entries.append(new_entry(
                vname, d, f"{label} rank 0 plan ({sp.fwd.n_rows} x "
                f"{sp.fwd.n_cols} forward)", label,
                shard_t[label][vname, "fwd" if fused else "bwd"],
                par_w[shard_runs[label]]))
    # --bf16 on the flagship: the bf16 variants where its path launches
    # them (the byte bound at 2-byte x; torch.sparse.mm on bf16 where
    # PyTorch takes it)
    check(set(bf16_w) <= {(fused_b, H), (gather_b, H)},
          f"the --bf16 run launched {dict(bf16_w)}")
    for vname in (fused_b, gather_b):
        ms, plain, lib, bound, by = times[vname]
        entries.append(dict(
            name=f"{vname} D={H} bf16", **KERNEL,
            shape=f"flagship k={K} plan, D={H}, --bf16", launches=bf16_w[
                vname, H], max_abs_err=errs_w[vname, H], ms=ms,
            plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib))
    # [api]: the flagship through the top-level names, its launches
    # counted apart from the main path's entries
    for vname in (fused_v, gather_v):
        ms, plain, lib, bound, by = times[vname]
        entries.append(dict(
            name=f"{vname} D={H} api", **KERNEL,
            shape=f"flagship k={K} plan, D={H}, through kt.Trainer",
            launches=api_w[vname, H], max_abs_err=errs_w[vname, H], ms=ms,
            plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib))
    # the plans of [tools], each with the launches of the script that
    # takes it (kept out of the entries above): the fused form over fwd,
    # the gather over fwd (tune_pallas's bare kernel; both scripts also
    # launch it over bwd, in their backward)
    for label, (tp, d) in tplans.items():
        w = tools_w[label.split()[0]]
        for vname, what in ((fused_v, "fwd"), (gather_v, "fwd")):
            entries.append(new_entry(
                vname, d, f"{label} k={tp.K} plan, timed over {what}", label,
                tool_t[label][vname, what], w))
    # the sorted segment sum (the same kernel, identity senders) at the
    # [determinism] legs' shapes, each with the launches of one run of
    # its leg
    entries += sorted_entries
    # the BiLSTM kernel at each [lstm] shape (the longest sequence), with
    # its launches at that (T, H) in the run that takes the shape: the
    # flagship's [train] and [bf16] runs and the QM9 run (every layer's
    # combine: T = H = min(l + 1, K) from 2 to K), the KPGINPrime gated
    # step, and [lstm]'s JK-attention train step (JK's own T = L + 1 and
    # H = L; its combines are the flagship's)
    jk = "flagship JK attention"
    lstm_runs = {("flagship combine", "f32"): zinc.lstm_w,
                 ("flagship combine", "bf16"): zinc_bf16.lstm_w,
                 ("qm9 combine", "f32"): qm9.lstm_w,
                 (f"qm9 KPGINPrime K={PRIME_K} combine", "f32"): prime_lstm_w,
                 (jk, "f32"): lstm_steps[jk]}
    for (label, dname, _), e in lstm_entries.items():
        run_w = lstm_runs.get((label, dname))
        if run_w is None:       # the bf16 checks and times stay in the log
            continue
        e = dict(e)
        shape_th = e.pop("T"), e.pop("H")
        n = sum(c for (v, t, h), c in run_w.items() if v == e["variant"]
                and (t, h) == shape_th)
        check(n > 0, f"{e['name']}: its run launched it {n} times")
        entries.append(dict(e, launches=n))
    log("[phases] seconds: " + ", ".join(
        f"{name} {t - t0:.1f}" for (_, t0), (name, t) in zip(marks, marks[1:]))
        + f"; total {marks[-1][1] - marks[0][1]:.1f}")
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
