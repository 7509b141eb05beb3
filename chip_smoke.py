"""Build the PyTorch port's CUDA kernels and drive its search, corpus-
encoding, question-answering and training paths (the retriever, reader
and single-hop trainers, the grid launcher, checkpoint export), its
single-hop bulk retrieval and offline-eval CLIs, its quickstart, its
row-sharded serving, data-parallel encoding and pod runner, its data- and
tensor-parallel training, and its trained-weight measurement scripts on
one GPU.
Run from the repository root:  python3 chip_smoke.py

Phases (each prints a line and flushes; any failure exits non-zero):
  1. build   — nvcc compiles every kernel from ops/csrc (one process each).
  2. kernels — each of the eleven kernels against its plain PyTorch version
               at its path's shapes (every kernel on its tensor-core
               template, int8 for 1, 4 and 7, which each record names and
               must have taken): kernels 1-4 at B=192, D=768,
               N=1,048,576, R=128, kc=8 (kernel 1 at k = 1, 2 and 4;
               kernel 4 also at leg d's hop 2, B=384, kc=20, 2048-row
               chunks; kernel 2 also at the FEVER
               CLI's hop 1, B=100 over 262,144 rows, k=2, and kernel 3 at
               its hop 2, B=200 over 262,144 rows); kernel 7 at B=384, 2048-row
               chunks of that int8 index; kernels 6 and 5 at B=200 over a
               262,144-row bf16 index (2048-row chunks, kc=20; kernel 5
               also at 512-row chunks, kc=16); kernel 8 (fused attention,
               12 heads of 64) at the corpus leg's (B, Wq, W) = (256, 300,
               300) and (256, 1, 300), the engine's (192, 40, 40) and
               (192, 350, 350) in bf16 and (8, 128, 128) in fp32, ragged
               masks and a fully masked row.  int8 results bit-equal,
               bf16/fp32 MIPS within 1e-3 (kernel 2 also rtol 1e-5), kernel
               8 as attention_error
               says; kernels 9-11 (the encoder layer's elementwise
               chains) at mhop.beam5.b100's shapes, 9 bit-equal, 10 and
               11 within 1 bf16 ulp; times by CUDA events beside the
               plain version, a library yardstick where one exists, the
               card's bound and the share of it reached (bound / time).
  3. main paths — roberta-base shape (12 layers, 768 wide) with seeded
               random weights; the questions' or claims' own vectors are
               planted as index rows, and hop 1 must return them.  Each
               path's launch counts are zeroed just before it and read
               just after it, and each must launch its kernels; kernels 1,
               2, 3, 4, 5 and 7 must have taken their tensor-core templates
               on every path that launches them (a, b, c1, c2, d, f, g1,
               g2, h0-h6).
               a. int8: a 1,048,576-row int8 DenseIndex with a PCA
                  prefilter (R=128, 512-row chunks) and a 300-wide token
                  store; BeamSearcher at beam 1 / batch 192 / bf16 scores
                  / 5-tile buckets serves 50 timed batches (kernels 1, 3,
                  4).  One more batch is held against exact plain scans
                  on its own query vectors: hop 1 bit-equal, certified
                  hop-2 queries equal to the exact top-1.  One more runs
                  under torch.profiler: device time per search step and
                  per kernel, the idle share, peak memory (the full table
                  goes to --profile-out PATH when given).
               d. int8 two-phase: the same index at beam 2 / 20, top 20,
                  5 timed batches: hop 2 (B=384, k=20) through kernels 7
                  + 4, bit-equal to the exact int8 scan.
               f. fused serving: leg a's engine and weights with
                  attention_impl="fused", 5 timed batches: kernel 8 once
                  a layer for hop 1 and for each hop-2 tile, beside
                  kernels 1, 3, 4; one more batch held as in leg a, one
                  profiled.
               b. bf16: an engine over a 65,536-row bf16 index without
                  prefilter serves 5 batches (kernel 2), whose hop-1 and
                  hop-2 queries are then held against the plain scan (rtol
                  1e-5; the worst relative difference is printed).
               c. FEVER: cli/eval_mhop_fever.main over an index directory
                  (262,144 bf16 rows + PCA, token store, id2doc.json) with
                  200 claims, beam 2 / 20, batch 100, run twice: c1 exact
                  (hop 2 through kernels 6 + 5), c2 --pca (kernels 3 + 5).
                  Every MIPS call is held against the plain exact scan
                  (rtol 1e-5; hop 1's worst relative difference printed);
                  c2 must certify some hop-2 queries.  Each run's batches
                  are timed and its last batch profiled.
               e. corpus encoding: 8,192 wiki-like passages (JSONL,
                  20-300 words), max_c_len 300, batch 256, length sort.
                  e1: index.build.build_index with a fused retriever
                  (int8, PCA R=128): kernel 8 once a layer for every
                  batch.  e2: cli/encode_corpus.main at its default
                  attention (no kernel 8) into a directory that must load
                  back.  docs/s of each; on the widest batch the fused
                  encoder is held to its plain twin, and compared with
                  the xla encoder by cosine.
               g. question answering over e2's index directory and
                  retriever checkpoint, with the ELECTRA-large reader (24
                  x 1024, seeded random weights made on the card, bf16
                  with bf16 attention scores) at the serving defaults
                  (beam 5, top 5, max_seq_len 512, --rank-topm 0) and
                  --pca.  g1: cli/serve's server on 127.0.0.1 (port 0,
                  --max-batch 16) answers 64 concurrent /answer (micro-
                  batched, reader scores finite) and 16 /retrieve, takes
                  an /add_doc that grows the index (the new document's
                  vector is then the exact hop-1 top-1 at its id) and a
                  /delete_doc (ids stay below n_docs); answers/s, median
                  retrieval_s and reading_s, reader chains/s, and one
                  profiled micro-batch (kernels 3, 4: pca_hops="auto"
                  filters both hops without hop-2 buckets).  g2:
                  cli/end2end.main over 64 questions at batch 16 (exact
                  scans: kernel 1) prints its metrics line.
               h. beam-4 serving: leg a's index, token store and weights
                  (kept in memory) at beam 4 / 4, top 4, batch 192, the
                  6-tile hop-2 split, seven engines: h0 unpruned, h1 / h2
                  hop2_prune_margin auto / auto:0.9, h3 a UnifiedRetriever
                  (leg a's weights, a seeded stop head) without the
                  cascade, h4 / h5 the stop-skip cascade at ~30% / ~60%
                  stops (quantiles of h3's top-1 stop probabilities), h6
                  h5 with auto:0.9.  Each: 8 timed batches (kernels 1, 3,
                  4, each on its mma template), one held to the exact
                  scans on its own vectors and to the beam-4 rules (the
                  margin on its own d1, stopped questions' chains through
                  their top-1 candidate, skipped rows' stop probability
                  0.5), one profiled; q/s, stop rate, pruned share, chain
                  agreement with h0 / h3; kernel 4 timed at h3's and h5's
                  hop 2 (zero vectors of skipped rows select the same
                  chunks).
               i. the HNSW host tier: cli/eval_mhop_retrieval --hnsw over
                  e2's directory, twice: the first builds index.hnsw
                  with the port's binding (M 32, ef_construction 200;
                  build rows/s), the second loads it (the CLI's q/s);
                  hop-1 recall@4 against kernel 1's exact scan >= 0.85;
                  the library outside native/.
               j. retriever training (no kernel on its path: the counts
                  must stay 0).  j0: one train step on the card and one
                  on the CPU from the same weights and batch (2 layers at
                  roberta-base width, fp32, B=4 ragged at 70/350/300):
                  losses within 1e-5 relative, gradients within 1e-6 +
                  1e-4 of each tensor's largest, parameters within
                  adam_bound.  j1: roberta-base (bf16 compute, fp32
                  master weights and Adam) at batch 16 and the reference
                  widths, the optimizer of RetrieverTrainConfig's
                  defaults: examples/s and ms/step (CUDA events, the
                  median of 6 steps after 3), peak allocated memory,
                  one profiled step; every loss finite.  j2: j1 with
                  --remat at batch 64.  j3: cli/train_retriever for one
                  epoch of 256 synthetic rows (synth_doc_lens passages,
                  hash tokenizer), then cli/train_momentum from its
                  checkpoint_best.pt with the 76,800 x 768 queue over 64
                  rows; the momentum checkpoint served through
                  cli/common.init_retriever gives the trained encoder_q's
                  vectors bit for bit.
               k. the rest of training (no kernel either: the counts must
                  stay 0).  k0: one reader train step on the card and one
                  on the CPU from the same weights and batch (2 layers at
                  ELECTRA-large width, fp32, B=6 ragged up to 512, sp on),
                  held as j0.  k1: the ELECTRA-large reader (24 x 1024,
                  bf16 compute, fp32 master weights and Adam) at the JAX
                  CLI's defaults (batch 8, 512 tokens, 10 answer slots, 40
                  sentences, sp on), without and with --remat:
                  examples/s, ms/step beside its FLOP bound, peak memory,
                  one profiled step split into matmuls and the rest.  k2:
                  cli/train_qa for one epoch of 64 synthetic questions
                  (mini preset), then --do-predict from its
                  checkpoint_best.pt; the checkpoint served through
                  cli/common.init_reader gives the trained rank scores bit
                  for bit, and cli/export_ckpt --arch reader of it
                  strict-loads back bit for bit.  k3: cli/train_single at
                  roberta-base and widths 50/300, batch 32 (the CLI's 128
                  does not fit without remat), shared, then --momentum
                  from its checkpoint; examples/s of each trainer's step.
                  k4: cli/launch, a 2-point lr grid at the tiny preset over
                  j3's rows, run twice (the second skips both points);
                  cli/export_ckpt --arch mhop of j3's stage-1 checkpoint
                  serves its vectors bit for bit.
               l. single-hop bulk retrieval: cli/eval_retrieval.main at
                  its defaults (batch 256, top 100, max_q_len 50), 512
                  questions whose own vectors (twice over) are planted
                  with DenseIndex.replace over 512 documents whose
                  titles are the gold answers and SP titles: recall@k
                  1.0 at every k.  l1 over leg c's directory (262,144
                  bf16 rows): exact (kernels 6 + 5: 2048-row chunks, kc
                  = 100) and --pca (3 + 5); l2 over leg e2's (8,192 int8
                  rows): exact (7 + 4: 4 chunks, every query on every
                  chunk) and --pca (3 + 4); l3 --topk 5 over both
                  (kernels 2, 1).  Each run's launch counts, its q/s,
                  every kernel on its tensor-core template, and every
                  MIPS call the CLI made (the names it imported) held to
                  the plain exact scan (int8 in the search's epilogue
                  order: values and ids bit-equal; bf16 rtol 1e-5; a
                  --pca call's certified queries: the exact top 100).
                  l2 again under utils/profiling.device_trace: the trace
                  names the launched kernels.  Kernels 4-7 timed at
                  these k = 100 shapes against their twins, bounds and
                  library calls.  cli/eval_reranked over leg g2's saved
                  predictions (every question, finite metrics) and
                  cli/prep's three subcommands (host only).
               m. examples/quickstart_torch.py on the card: the seven
                  steps at the tiny preset; 8 questions answered, the
                  exported .pt loads back; its seconds.
               n. row-sharded serving (core/mesh.py, ops/mips.py's
                  sharded searches; every mesh device cuda:0, repeated,
                  or the cards in turn where the host shows more).  n1:
                  leg a's index re-sharded into 4 row blocks behind
                  BeamSearcher(mesh=): 20 timed batches (kernels 1, 3, 4
                  once per shard per MIPS call), one batch held to leg
                  a's engine (hop 1 bit-equal; where leg a certifies,
                  hop 2's top-1 = leg a's = the exact scan's), to the
                  exact scans, and each shard's kernels 3 and 4 to their
                  plain versions; leg d's beam 2 / 20 over the
                  shards (kernels 7 + 4 on each), bit-equal to leg d; a
                  search whose last two shards hold padding only; one
                  add_docs (growing each shard's block) and one delete_doc.
                  n2: cli/eval_mhop_retrieval.load_searcher(mesh=4
                  shards) over leg c's directory at leg c's configs,
                  exact (kernels 2, 6, 5 per shard) and --pca (2, 3, 5),
                  chains held to the unsharded engine's (bf16 rtol 1e-5
                  apart from near-ties); on a host with N >= 2 cards also
                  eval_mhop_fever --index-shards N.  n3:
                  index/build.py::encode_corpus over 8,192 of leg e's
                  passages with the fused encoder on a 2-device data mesh
                  (kernel 8 on each half of every batch) against the
                  single-device encode.  n4: cli/pod in 2 processes on
                  the card (gloo): encode_corpus (rank 0 merges; equal to
                  a single-process 2-slice encode + --merge-only) and
                  eval_mhop_retrieval --index-shards 2 (equal to the
                  single-process 2-shard run); first a probe of which
                  gloo collectives take CUDA tensors.
               o. data- and tensor-parallel training (train/trainer.py's
                  DataParallel, parallel/sharding.py; no kernel: the counts
                  must stay 0; every mesh the card twice, and cuda:0 +
                  cuda:1 too where the host shows two cards).  o1: a
                  data-2 step of j0's model (2 x 768, fp32, B=16 ragged at
                  the reference widths) against the single-device card
                  step by j0's criteria; j1's model (roberta-base, bf16)
                  against it in units of its bf16-vs-fp32 gradient noise n
                  (loss within O_LOSS_TOL, gradients within 2 n), and the
                  negative control (local in-batch negatives, averaged
                  gradients), which must fail both; ms/step and
                  examples/s of the single-device (j1's config), data-2
                  and tensor-parallel steps in turns, each card's peak
                  memory.  o2: the momentum step (j3's 76,800 x 768 queue,
                  j0's model) by j0's criteria, the enqueued rows and the
                  pointer; the token-queue step of train_single --momentum
                  at k3's shapes, its queue bit-equal.  o3: the
                  tensor-parallel step (index 2: 6 heads and 1,536 FFN
                  columns a shard) as o1, and by tests/test_parallel.py's
                  criteria.  o4: cli/train_retriever, train_momentum and
                  train_single with --data-parallel 2, 32 rows each at
                  roberta-base; each checkpoint strict-loads back.  o5:
                  o1's bf16 step in 2 processes through run_processes (one
                  entry each: gloo on the shared card, NCCL on two),
                  held to o1's single-process data-2 step.  o6: o3's
                  tensor-parallel step in 2 processes through
                  run_processes, one index shard each (the row-parallel
                  sums and the column input's gradient gathered over the
                  index group: gloo on the shared card, NCCL on two),
                  held to o3's single-process index-2 steps: j0's fp32
                  model by j0's criteria, roberta-base bf16 in units of
                  n; ms a step of the bf16 step at j1's batch.  o5 and
                  o6 share one pod of 2 processes (its seconds printed).
               p. trained weights (scripts_dev/prune_sweep_torch.py and
                  fidelity_trained_torch.py; each sub-leg prints its
                  seconds per stage; p1 and p3 run in processes of their
                  own, started once leg o's throughput runs are done,
                  beside the rest of leg o and p2, each with its own launch
                  counts, and kernels 1, 3 and 4 are timed after both
                  have ended).  p1: the prune sweep at its
                  defaults (make_data's 65,536 docs, 1,024 key docs, 512
                  questions; the mini retriever trained 8 epochs through
                  cli/train_retriever; a bf16 index; beam 4, batch 16):
                  every margin's pruned_frac, chain_agreement, p_em, pr
                  and gold_hop1_expanded beside docs/prune_sweep_r5.json;
                  kernel 2 at both hops, every launch held to the plain
                  scan.  p2 (the full-width main path): the same data, a
                  roberta-base retriever (bf16) trained through
                  cli/train_retriever (P_EPOCHS epochs at P_LR: the JAX
                  recipe's 1e-3 does not train it), an int8 index with
                  a 128-dim PCA prefilter from cli/encode_corpus; the
                  512 questions at batch 192 and beam 4 (768 hop-2
                  queries a batch: kernel 1 at hop 1, kernels 3 + 4 at
                  hop 2), unpruned, at auto and auto:0.9, and over 4 row
                  shards on the card: certified shares, pruned shares and
                  chain agreement, kernels 1, 3 and 4 timed on the
                  trained launches (the median of 20) beside their bounds
                  and kernel 4's chunk skew; every hop held to the exact
                  scans, every kernel 3 / 4 launch to its plain version,
                  hop 1 over the shards bit-equal to the unsharded
                  engine.  p3: the fidelity script at its defaults (mini
                  reader, offsets 64-448; no MIPS kernel) but P3_EPOCHS
                  epochs and P3_NQ_EVAL eval questions an offset (24 of
                  its 40): the matrix and bf16
                  agreement beside docs/fidelity_r5.json.
  4. result  — one JSON line of kernel records, the card's name and power
               limit, and the final {"ok": true, ...} line.
Exits with code 2 and no result when CUDA is not available.
"""

import argparse
import concurrent.futures
import contextlib
import dataclasses
import importlib
import importlib.util
import io
import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12}

B, D, N, R, CAND, KC = 192, 768, 1 << 20, 128, 512, 8
VOCAB, TEXT_LEN, Q_LEN, QSP_LEN = 50265, 300, 40, 350
# two-phase shapes: the FEVER CLI leg (hop 2 of batch 100 x beam 2 over a
# bf16 index, 2048-row chunks, top 20; its --pca run rescans 16 chunks of
# 512 rows) and the int8 engine leg (hop 2 of batch 192 x beam 2)
FEVER_BATCH = 100
B_F, N_F, C_F, K_F, KC_PCA_F = 2 * FEVER_BATCH, 1 << 18, 2048, 20, 16
N_CLAIMS, CLAIM_LEN = 200, 45
B_I8, C_I8 = 2 * B, 2048
# kernel 8 (fused attention): roberta-base's 12 heads of 64; the corpus
# encoding leg (e) encodes N_DOCS wiki-like passages in batches of C_BATCH
# at widths up to C_LEN
NH = 12
N_DOCS, C_BATCH, C_LEN = 8192, 256, 300
# leg g (question answering): the server's micro-batch cap, the concurrent
# /answer and /retrieve requests
QA_BATCH, N_ANSWERS, N_RETRIEVE = 16, 64, 16
# leg h (beam-4 serving): beam 4 / 4, top 4, timed batches per engine;
# the engines: (name, retriever, hop2_prune_margin, target stop rate in %)
B4, H_ITERS = 4, 3
H_ENGINES = (("h0", "mhop", 0.0, None), ("h1", "mhop", -0.5, None),
             ("h2", "mhop", -0.9, None), ("h3", "unified", 0.0, None),
             ("h4", "unified", 0.0, 30), ("h5", "unified", 0.0, 60),
             ("h6", "unified", -0.9, 60))
# leg i (the HNSW host tier): questions, graph parameters
N_HNSW_Q, HNSW_M, HNSW_EF_C = 2 * B, 32, 200
# leg j (retriever training): the reference's widths (q, q_sp, passages),
# the train-step batches without and with remat (bench.py::_train_bench's
# B=16), warm-up and timed steps, the CLIs' rows (stage 1, its dev file,
# the momentum stage) and the momentum queue
J_WIDTHS = (("q", 70), ("q_sp", 350), ("c1", 300), ("c2", 300),
            ("neg1", 300), ("neg2", 300))
J_B, J_REMAT_B, J_WARM, J_ITERS = 16, 64, 1, 3
J_ROWS, J_DEV_ROWS, J_MOM_ROWS, J_QUEUE = 128, 64, 64, 76800
# leg k (the rest of training): the reader trainer's JAX CLI defaults
# (batch, max_seq_len, answer slots, sentences), the timed reader steps;
# cli/train_qa's questions (4 chains each) and dev questions; the
# single-hop trainer's batch (the CLI's 128 cut to 32: without remat 128 x
# 650 tokens would not fit in 80 GB) and rows
K_B, K_LEN, K_SLOTS, K_SENTS = 8, 512, 10, 40
K_WARM, K_ITERS = 1, 3
K_QA_ROWS, K_QA_DEV = 64, 16
K3_B, K3_ROWS = 32, 128
# leg o (data- and tensor-parallel training): warm-up and timed steps of
# each throughput run (two windows of half), the CLIs' rows; the relative
# loss tolerance of a bf16 step against the single-device one
O_WARM, O_ITERS, O_ROWS, O_LOSS_TOL = 1, 4, 32, 5e-3
# o6 (the tensor-parallel step across 2 processes): its timed steps (its
# two checked steps before them warm it up)
O6_ITERS = 1
# leg p (trained weights): scripts_dev/prune_sweep_torch.py's defaults (p1:
# docs, key docs, questions); p2's roberta-base training (epochs, learning
# rate), its batch (h3's 768 hop-2 queries at beam 4), its row shards, and
# the CUDA-event launches timed per kernel (p2's epochs cut from 3 to 2
# for time); p3's reader epochs (the
# script's FIDELITY_EPOCHS, default 6: whether a reader clears the
# script's EM 0.5 by then depends on the run's start, in either package,
# PERF.md §6; at 12 the seed-42 reader cleared it in every run on the card)
# and its eval questions an offset (the script's 40, cut to 24 for time)
P_DOCS, P_KEYS, P_Q, P3_EPOCHS, P3_NQ_EVAL = 65536, 1024, 512, 12, 24
P_EPOCHS, P_LR, P_BATCH, P_SHARDS, P_TIMED = 2, "2e-5", 192, 4, 20
# leg l (single-hop bulk retrieval): questions, and cli/eval_retrieval's
# defaults (batch, top k, query width)
N_BULK_Q, BULK_BATCH, BULK_K, BULK_Q_LEN = 512, 256, 100, 50
# the int8 rows of the k = 100 kernel records (their first size, kept so
# that the records stay comparable)
L_K100_ROWS = 32768
# leg n (row-sharded serving): index shards and timed batches of n1, n3's
# passages, n4's questions and its processes' time limit
N_SHARDS, N_ITERS, N3_DOCS, N4_Q, POD_TIMEOUT = 4, 10, 8192, 192, 300
# (what, B, Wq, W, dtype) of the kernel-8 checks; the first is the record
ATTN_CASES = (("corpus square", C_BATCH, C_LEN, C_LEN, torch.bfloat16),
              ("corpus cls layer", C_BATCH, 1, C_LEN, torch.bfloat16),
              ("hop 1", B, Q_LEN, Q_LEN, torch.bfloat16),
              ("widest hop-2 bucket", B, QSP_LEN, QSP_LEN, torch.bfloat16),
              ("fp32", 8, 128, 128, torch.float32))


def say(*a):
    print(*a, flush=True)


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# a sleep on the card long enough to hold every call device_ms queues
# behind it (2e8 cycles: about 0.1 s at the H100's clocks)
SLEEP_CYCLES = 200_000_000


def device_ms(fn, iters):
    """(device ms, host us) a call of ``fn``: the calls are queued behind
    a sleep on the card, so the events time the card alone where
    ``cuda_ms`` times the host's launches too (a kernel shorter than its
    launch); the host's microseconds a call come from the same loop.
    Asserts the sleep outlasted the queueing."""
    fn()
    torch.cuda.synchronize()
    slept = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    slept.record()
    t0 = time.perf_counter()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    assert host_ms < slept.elapsed_time(start), \
        f"the sleep ({slept.elapsed_time(start):.1f} ms) did not outlast " \
        f"the queueing ({host_ms:.1f} ms)"
    return start.elapsed_time(end) / iters, host_ms * 1e3 / (iters + 1)


def bound_ms(n_bytes, n_ops, kind):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# the templates the planned wrappers took since the launch counts were last
# reset: while such a wrapper runs, its plan function is wrapped to note
# the route it returns (track_routes)
ROUTES = {}
# the launches of each variant of kernels 10 and 11 since the same reset
# (track_routes): the softmax by its score dtype, which picks its template,
# and the LayerNorm by its width and eps
VARIANTS = {}
VARIANT_OF = {
    "masked_softmax": lambda a: ("bf16" if a[3] == "bfloat16" else "fp32")
    + "_scores",
    "add_layer_norm": lambda a: f"{a[0].shape[-1]}_eps{a[3].eps:g}"}
ENCODER_KERNELS = ("bias_gelu", "masked_softmax", "add_layer_norm")
PLANNED = (("mips_scan_int8", "scan_plan"), ("mips_scan", "scan_plan"),
           ("chunk_max", "chunk_max_plan"), ("pca_chunk_max", "chunk_max_plan"),
           ("chunk_max_int8", "chunk_max_plan"),
           ("pca_rescan_int8", "rescan_plan"), ("rescan", "rescan_plan"))


def search_kernels(mips):
    """The kernels a search or training leg guards, kernels 1-8: kernels
    9-11 run wherever an encoder runs with gradients off (every encode;
    the trainers' momentum encoder, queue re-encode and eval passes)."""
    return tuple(k for k in mips.LAUNCHES if k not in ENCODER_KERNELS)


def track_routes(mips, fa):
    def planned(mod, name, plan_name):
        wrapper, plan = getattr(mod, name), getattr(mod, plan_name)

        def noted(*a, **kw):
            out = plan(*a, **kw)
            ROUTES.setdefault(name, set()).add(out["route"])
            return out

        def call(*a, **kw):
            setattr(mod, plan_name, noted)
            try:
                return wrapper(*a, **kw)
            finally:
                setattr(mod, plan_name, plan)

        setattr(mod, name, call)

    for name, plan_name in PLANNED:
        planned(mips, name, plan_name)
    planned(fa, "fused_attention", "attention_plan")
    ef = importlib.import_module(
        "multihop_dense_retrieval_tpu_torch.ops.encoder_fused")
    enc = importlib.import_module(
        "multihop_dense_retrieval_tpu_torch.models.encoder")
    for name, variant in VARIANT_OF.items():
        varied(ef, enc, name, variant)
    reset = mips.reset_launch_counts

    def reset_all():
        reset()
        ROUTES.clear()
        VARIANTS.clear()

    mips.reset_launch_counts = reset_all


def varied(ef, enc, name, variant):
    """Wrap kernel ``name`` of ``ops/encoder_fused.py`` (and the encoder's
    reference to it) to note, for each launch, its variant: ``name`` and
    ``variant(args)`` joined by a dot, in ``ROUTES`` and ``VARIANTS``."""
    fn = getattr(ef, name)

    def noted(*a, **kw):
        out = fn(*a, **kw)
        if out.is_cuda:
            key = f"{name}.{variant(a)}"
            ROUTES.setdefault(name, set()).add(key)
            VARIANTS[key] = VARIANTS.get(key, 0) + 1
        return out

    setattr(ef, name, noted)
    setattr(enc, name, noted)


def template(name):
    """The one template `name` took since its routes were last read or
    dropped (each check drops them just before its call)."""
    taken = ROUTES.pop(name, set())
    assert len(taken) == 1, f"{name} took templates {sorted(taken)}"
    return next(iter(taken))


def leg_counts(mips):
    """Launches of each kernel since the last reset, the templates the
    planned wrappers took, and the launches of each variant of kernels 10
    and 11."""
    return dict(mips.LAUNCHES, routes={k: sorted(v) for k, v in ROUTES.items()},
                variants=dict(VARIANTS))


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ---- phase 2: kernels against their plain versions ------------------------


def _library(fn):
    """Time one PyTorch yardstick call (never called by the port)."""
    return cuda_ms(fn, 5)


def check_kernels(mips, dev, gen):
    recs = {}
    q32 = torch.randn(B, D, device=dev, generator=gen)
    n_valid = N - 1000

    # kernel 1: int8 scan + top-1 (leg a's hop 1, the record), top-2 (leg
    # d's) and a k=4 case for the merge
    idx8 = torch.randint(-127, 128, (N, D), device=dev, generator=gen,
                         dtype=torch.int8)
    dsc = torch.rand(N, device=dev, generator=gen) * 0.02 + 1e-3
    idx8[777] = idx8[5]                        # exact tie: lower id wins
    dsc[777] = dsc[5]
    qi, qs = mips.quantize_rows(q32)
    ROUTES.clear()
    for k in (1, 2, 4):
        kv, ki = mips.mips_scan_int8(qi, qs, idx8, dsc, k, n_valid)
        pv, pi = mips.mips_scan_int8_plain(qi, qs, idx8, dsc, k, n_valid)
        torch.cuda.synchronize()
        assert torch.equal(kv, pv) and torch.equal(ki, pi), \
            f"kernel 1 (k={k}) disagrees with its plain version"
    tmpl = template("mips_scan_int8")
    assert tmpl == "mma", f"kernel 1 took the {tmpl} template"
    ms = cuda_ms(lambda: mips.mips_scan_int8(qi, qs, idx8, dsc, 1, n_valid), 20)
    plain = cuda_ms(
        lambda: mips.mips_scan_int8_plain(qi, qs, idx8, dsc, 1, n_valid), 2)
    lib = _library(lambda: torch.topk(
        torch._int_mm(qi, idx8.t()).float() * qs[:, None] * dsc[None, :], 1))
    bnd = bound_ms(N * D + N * 4 + B * D + B * 4 + B * 8, 2 * B * N * D, "int8")
    say(f"  kernel 1 record (B={B}, N={N}, k=1, {tmpl}): {ms:.4f} ms (plain "
        f"{plain:.4f} ms, _int_mm + topk {lib:.4f} ms, bound {bnd[0]:.4f} ms "
        f"by {bnd[1]}, {bnd[0] / ms:.3f} of it); k = 1, 2, 4 bit-equal")
    recs["mips_scan_int8"] = dict(err=0.0, ms=ms, plain_ms=plain, bound=bnd,
                                  library_ms=lib, template=tmpl)

    # kernel 7: two-phase chunk maxima over the int8 index (leg d's shape)
    q8, _ = mips.quantize_rows(torch.randn(B_I8, D, device=dev, generator=gen))
    recs["chunk_max_int8"] = check_chunk_max(mips, q8, idx8, dsc, C_I8,
                                             n_valid, "record")
    del idx8, q8

    # kernel 2: bf16 scan + top-1 (the record), and the FEVER CLI's hop 1
    idxb = torch.randn(N, D, device=dev, generator=gen).to(torch.bfloat16)
    recs["mips_scan"] = check_scan(mips, q32, idxb, 1, n_valid, "record")
    check_scan(mips, q32[:FEVER_BATCH], idxb[:N_F], 2, N_F - 1000,
               "the FEVER CLI's hop 1")
    del idxb

    # kernel 3: PCA phase 1 chunk maxima (the record), and leg c2's hop 2
    proj = torch.randn(N, R, device=dev, generator=gen).to(torch.bfloat16)
    qp = torch.randn(B_F, R, device=dev, generator=gen).to(torch.bfloat16)
    recs["pca_chunk_max"] = check_pca_chunk_max(mips, qp[:B], proj, n_valid,
                                                "record")
    check_pca_chunk_max(mips, qp, proj[:N_F], N_F - 1000, "leg c2's hop 2")
    del proj

    # kernel 4: int8 rescan of 8 selected chunks per query (leg a's hop 2,
    # the record), and of 20 chunks of 2048 rows at B=384 (leg d's)
    idx8 = torch.randint(-127, 128, (N, D), device=dev, generator=gen,
                         dtype=torch.int8)
    q8, _ = mips.quantize_rows(torch.randn(B_I8, D, device=dev, generator=gen))
    for q, cand, kc in ((qi, CAND, KC), (q8, C_I8, K_F)):
        rec = check_rescan(mips, q, idx8, dsc, cand, kc, n_valid, gen)
        recs.setdefault("pca_rescan_int8", rec)
    del idx8, q8
    check_float_two_phase(mips, dev, gen, recs)
    check_attention(dev, gen, recs)
    check_encoder_chains(dev, gen, recs)
    return recs


def check_rescan(mips, q, index, dsc, cand, kc, n_valid, gen):
    """Kernel 4 (``dsc`` given, int8: bit-equal) or 5 (bf16: within 1e-3 at
    D=768 on N(0,1) data; fp32 sums in the tensor cores' order) over kc
    distinct chunks of ``cand`` rows a query, the pad rows' chunk among
    query 0's, on its tensor-core template; timed beside its plain twin
    and a library yardstick over every chunk (``_int_mm`` with the scales,
    or a bf16 ``mm``, then a ``gather`` of the selected chunks' columns)."""
    b, n = q.shape[0], index.shape[0]
    name = "pca_rescan_int8" if dsc is not None else "rescan"
    ids = torch.stack([torch.randperm(n // cand, device=q.device,
                                      generator=gen)[:kc]
                       for _ in range(b)]).to(torch.int32)
    ids[0, 0] = n // cand - 1                      # the chunk with pad rows
    cols = (ids.long()[:, :, None] * cand
            + torch.arange(cand, device=q.device)[None, None, :]).view(b, -1)
    if dsc is not None:
        def kernel():
            return mips.pca_rescan_int8(ids, q, index, dsc, cand, n_valid)

        def library():
            return torch.gather(torch._int_mm(q, index.t()).float()
                                * dsc[None, :], 1, cols)
    else:
        def kernel():
            return mips.rescan(ids, q, index, cand, n_valid)

        def library():
            return torch.gather(q @ index.t(), 1, cols).float()
    ROUTES.pop(name, None)
    kout = kernel()
    pout = mips.rescan_plain(ids, q, index, dsc, cand, n_valid)
    torch.cuda.synchronize()
    tmpl = template(name)
    assert tmpl == "mma", f"{name} took the {tmpl} template"
    err = (kout - pout).abs().max().item()
    if dsc is not None:
        assert torch.equal(kout, pout), \
            f"kernel 4 (C={cand}, kc={kc}) disagrees with its plain version"
    else:
        assert err <= 1e-3, f"kernel 5 (C={cand}, kc={kc}) off by {err}"
    ms = cuda_ms(kernel, 20)
    plain = cuda_ms(lambda: mips.rescan_plain(ids, q, index, dsc, cand,
                                              n_valid), 2)
    lib = _library(library)
    uniq = int(torch.unique(ids).numel())          # chunks this data reads
    row_bytes = index.shape[1] * index.element_size() + (4 if dsc is not None
                                                         else 0)
    bnd = bound_ms(uniq * cand * row_bytes + q.numel() * q.element_size()
                   + b * kc * 4 + b * kc * cand * 4,
                   2 * b * kc * cand * index.shape[1],
                   "int8" if dsc is not None else "bf16")
    say(f"  kernel {4 if dsc is not None else 5} at B={b}, C={cand}, kc={kc} "
        f"({tmpl}): {ms:.4f} ms (plain {plain:.4f} ms, "
        f"{'_int_mm' if dsc is not None else 'mm'} + gather {lib:.4f} ms, "
        f"bound {bnd[0]:.4f} ms by {bnd[1]}, {bnd[0] / ms:.3f} of it, "
        f"{uniq} distinct chunks); "
        + ("bit-equal" if dsc is not None else f"max abs err {err:.3g}"))
    return dict(err=err, ms=ms, plain_ms=plain, bound=bnd, library_ms=lib,
                template=tmpl)


def check_chunk_max(mips, q, index, dsc, chunk, n_valid, what):
    """Kernel 6 (bf16) or 7 (int8, ``dsc`` given: bit-equal) against its
    plain twin on its tensor-core template (kernel 6 within 1e-3 at D=768
    on N(0,1) data), timed beside the twin, a library yardstick (``mm`` or
    ``_int_mm`` with the scales, then ``amax``) and the bound."""
    b, n = q.shape[0], index.shape[0]
    int8 = dsc is not None
    name = "chunk_max_int8" if int8 else "chunk_max"

    def kernel():
        return (mips.chunk_max_int8(q, index, dsc, chunk, n_valid) if int8
                else mips.chunk_max(q, index, chunk, n_valid))

    def library():
        s = (torch._int_mm(q, index.t()).float() * dsc[None, :] if int8
             else q @ index.t())
        return s.view(b, -1, chunk).amax(-1)

    ROUTES.pop(name, None)
    kout = kernel()
    pout = mips.chunk_max_plain(q, index, chunk, n_valid, dsc)
    torch.cuda.synchronize()
    tmpl = template(name)
    assert tmpl == "mma", f"{name} took the {tmpl} template at {what}"
    err = (kout - pout).abs().max().item()
    assert torch.equal(kout, pout) if int8 else err <= 1e-3, \
        f"{name} off by {err} at {what}"
    ms = cuda_ms(kernel, 10)
    plain = cuda_ms(lambda: mips.chunk_max_plain(q, index, chunk, n_valid,
                                                 dsc), 2)
    lib = _library(library)
    bnd = bound_ms(n * index.shape[1] * index.element_size()
                   + (n * 4 if int8 else 0) + q.numel() * q.element_size()
                   + b * (n // chunk) * 4, 2 * b * n * index.shape[1],
                   "int8" if int8 else "bf16")
    say(f"  kernel {7 if int8 else 6} at {what} (B={b}, N={n}, C={chunk}, "
        f"{tmpl}): {ms:.4f} ms (plain {plain:.4f} ms, "
        f"{'_int_mm' if int8 else 'mm'} + amax {lib:.4f} ms, bound "
        f"{bnd[0]:.4f} ms by {bnd[1]}, {bnd[0] / ms:.3f} of it); "
        + ("bit-equal" if int8 else f"max abs err {err:.3g}"))
    return dict(err=err, ms=ms, plain_ms=plain, bound=bnd, library_ms=lib,
                template=tmpl)


def check_scan(mips, q32, idxb, k, n_valid, what):
    """Kernel 2 at one shape against its plain version: values within 1e-3
    absolute and rtol 1e-5 (the kept rows rescored in fp32: fp32 sums of
    exact bf16 products in another order), ids equal apart from near-ties
    (a differing id's plain score within that tolerance of the plain score
    at its rank); the tensor-core template taken; times beside the plain
    version, bf16 mm + topk, and the bound."""
    b, n = q32.shape[0], idxb.shape[0]
    qb = q32.to(torch.bfloat16)
    ROUTES.pop("mips_scan", None)
    kv, ki = mips.mips_scan(q32, idxb, k, n_valid)
    pv, pi = mips.mips_scan_plain(q32, idxb, k, n_valid)
    torch.cuda.synchronize()
    tmpl = template("mips_scan")
    err = (kv - pv).abs().max().item()
    rel = ((kv - pv).abs() / pv.abs()).max().item()
    alt = (qb.float()[:, None, :] * idxb[ki.long()].float()).sum(-1)
    tie_ok = (ki == pi) | ((alt - pv).abs() <= 1e-5 * pv.abs())
    ms = cuda_ms(lambda: mips.mips_scan(qb, idxb, k, n_valid), 10)
    plain = cuda_ms(lambda: mips.mips_scan_plain(qb, idxb, k, n_valid), 2)
    lib = _library(lambda: torch.topk(qb @ idxb.t(), k))
    bnd = bound_ms(n * D * 2 + b * D * 2 + b * k * 8, 2 * b * n * D, "bf16")
    say(f"  kernel 2 {what} (B={b}, N={n}, k={k}, {tmpl}): {ms:.4f} ms "
        f"(plain {plain:.4f} ms, mm + topk {lib:.4f} ms, bound {bnd[0]:.4f} "
        f"ms by {bnd[1]}, {bnd[0] / ms:.3f} of it); max abs err {err:.3g}, "
        f"max relative {rel:.3g}")
    assert tmpl == "mma", f"kernel 2 took the {tmpl} template at {what}"
    assert bool(tie_ok.all()), f"kernel 2 ids disagree beyond near-ties"
    assert err <= 1e-3 and rel <= 1e-5, \
        f"kernel 2 values off by {err} ({rel} relative)"
    return dict(err=err, ms=ms, plain_ms=plain, bound=bnd, library_ms=lib,
                template=tmpl)


def check_pca_chunk_max(mips, qp, proj, n_valid, what):
    """Kernel 3 at one shape against its plain version (within 1e-3: fp32
    sums of exact bf16 products in another order); the tensor-core template
    taken; times beside the plain version, bf16 mm + amax, and the bound."""
    b, n = qp.shape[0], proj.shape[0]
    ROUTES.pop("pca_chunk_max", None)
    kout = mips.pca_chunk_max(qp, proj, CAND, n_valid)
    pout = mips.chunk_max_plain(qp, proj, CAND, n_valid)
    torch.cuda.synchronize()
    tmpl = template("pca_chunk_max")
    err = (kout - pout).abs().max().item()
    ms = cuda_ms(lambda: mips.pca_chunk_max(qp, proj, CAND, n_valid), 20)
    plain = cuda_ms(lambda: mips.chunk_max_plain(qp, proj, CAND, n_valid), 3)
    lib = _library(lambda: (qp @ proj.t()).view(b, -1, CAND).amax(-1))
    bnd = bound_ms(n * R * 2 + b * R * 2 + b * (n // CAND) * 4,
                   2 * b * n * R, "bf16")
    say(f"  kernel 3 {what} (B={b}, N={n}, R={R}, {tmpl}): {ms:.4f} ms "
        f"(plain {plain:.4f} ms, mm + amax {lib:.4f} ms, bound {bnd[0]:.4f} "
        f"ms by {bnd[1]}, {bnd[0] / ms:.3f} of it); max abs err {err:.3g}")
    assert tmpl == "mma", f"kernel 3 took the {tmpl} template at {what}"
    assert err <= 1e-3, f"kernel 3 off by {err} (tolerance 1e-3)"
    return dict(err=err, ms=ms, plain_ms=plain, bound=bnd, library_ms=lib,
                template=tmpl)


def check_float_two_phase(mips, dev, gen, recs):
    """Kernels 6 and 5 at the FEVER CLI leg's shapes over a bf16 index:
    values within kernel 2's tolerance (1e-3 absolute at D=768 on N(0,1)
    data; fp32 sums of exact bf16 products in another order)."""
    n_valid = N_F - 1000
    idxb = torch.randn(N_F, D, device=dev, generator=gen).to(torch.bfloat16)
    qb = torch.randn(B_F, D, device=dev, generator=gen).to(torch.bfloat16)
    recs["chunk_max"] = check_chunk_max(mips, qb, idxb, None, C_F, n_valid,
                                        "the FEVER shape")

    # kernel 5 at its two shapes: two-phase phase 2 (20 chunks of 2048
    # rows, the record in the kernels line) and the PCA rescan (16 chunks
    # of 512, printed on its own line)
    rescans = [check_rescan(mips, qb, idxb, None, cand, kc, n_valid, gen)
               for cand, kc in ((C_F, K_F), (CAND, KC_PCA_F))]
    recs["rescan"] = dict(rescans[0], err=max(r["err"] for r in rescans))


def attention_inputs(dev, gen, b, wq, w, dtype):
    """N(0,1) q, k, v of width D; ragged masks and a fully masked last row."""
    q, k, v = (torch.randn(b, n, D, device=dev, generator=gen).to(dtype)
               for n in (wq, w, w))
    lens = torch.randint(1, w + 1, (b,), device=dev, generator=gen)
    mask = (torch.arange(w, device=dev)[None] < lens[:, None]).to(torch.int32)
    mask[-1] = 0
    return q, k, v, mask


def bf16_ulp(x):
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def attention_error(fa, got, exp, q, k, v, mask):
    """Kernel 8 against its plain version: (max abs error, max error in
    bf16 ulps of the plain value, share beyond 2 ulps).  fp32 must be
    within atol/rtol 1e-5 (sums in another order).  bf16 must be within 2
    ulps of the plain value plus 2^-7 * sum_j p_j |v_j|: both round p to
    bf16 from fp32 values whose sums differ in order, and a p_j rounded
    the other way moves o by one ulp of p_j (<= 2^-7 p_j) times |v_j|."""
    assert got.dtype == exp.dtype == q.dtype and got.shape == exp.shape
    got_f, exp_f = got.float(), exp.float()
    assert bool(torch.isfinite(got_f).all()), "kernel 8: non-finite output"
    diff = (got_f - exp_f).abs()
    ulps = diff / bf16_ulp(exp_f)
    if q.dtype == torch.float32:
        torch.testing.assert_close(got_f, exp_f, atol=1e-5, rtol=1e-5)
    else:
        env = fa.fused_attention_plain(q, k, v.abs(), mask, NH).float()
        tol = 2 * bf16_ulp(exp_f) + 2.0 ** -7 * env * (1 + 2.0 ** -7)
        assert bool((diff <= tol).all()), \
            f"kernel 8 beyond its bf16 envelope by {(diff - tol).max()}"
    return diff.max().item(), ulps.max().item(), (ulps > 2).float().mean().item()


def check_attention(dev, gen, recs):
    """Kernel 8 at the shapes of its paths (the corpus leg's square and
    cls layers, the engine's hop 1 and widest hop-2 bucket, an fp32 case),
    each against its plain version, with CUDA-event times beside the plain
    version, the bound, and the library yardstick:
    scaled_dot_product_attention with the same fp32 bias as a float mask,
    on (B, nh, W, d) inputs transposed beforehand (the transposes are not
    timed).  The port never calls it.  At the corpus shape it also times
    the encoder's attention step (the three projections, attention and the
    head layout) with attention_impl "fused" and "xla"."""
    import torch.nn.functional as F

    fa = importlib.import_module(
        "multihop_dense_retrieval_tpu_torch.ops.fused_attention")
    dh = D // NH
    for i, (what, b, wq, w, dt) in enumerate(ATTN_CASES):
        q, k, v, mask = attention_inputs(dev, gen, b, wq, w, dt)
        ROUTES.pop("fused_attention", None)
        got = fa.fused_attention(q, k, v, mask, NH)
        exp = fa.fused_attention_plain(q, k, v, mask, NH)
        torch.cuda.synchronize()
        tmpl = template("fused_attention")
        err, ulps, beyond = attention_error(fa, got, exp, q, k, v, mask)
        del got, exp
        ms = cuda_ms(lambda: fa.fused_attention(q, k, v, mask, NH), 10)
        plain = cuda_ms(lambda: fa.fused_attention_plain(q, k, v, mask, NH),
                        2)
        qt, kt, vt = (x.view(b, -1, NH, dh).transpose(1, 2).contiguous()
                      for x in (q, k, v))
        bias = torch.where(mask.bool(), 0.0, -1e9).to(dt)[:, None, None, :]
        lib = _library(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bias))
        bnd = bound_ms((2 * b * wq * D + 2 * b * w * D) * q.element_size()
                       + 4 * b * w, 4 * b * NH * wq * w * dh,
                       "bf16" if dt == torch.bfloat16 else "fp32")
        say(f"  kernel 8 {what} (B={b}, Wq={wq}, W={w}, {str(dt)[6:]}): "
            f"{ms:.4f} ms (plain {plain:.4f} ms, SDPA {lib:.4f} ms, bound "
            f"{bnd[0]:.4f} ms by {bnd[1]}, {bnd[0] / ms:.3f} of it); max abs "
            f"err {err:.3g}, max "
            f"{ulps:.3g} bf16 ulps, {beyond:.3g} of outputs beyond 2 ulps")
        if i == 0:
            recs["fused_attention"] = dict(err=err, ms=ms, plain_ms=plain,
                                           bound=bnd, library_ms=lib,
                                           template=tmpl)
            time_attention_step(dev, gen, mask)
        del q, k, v, qt, kt, vt


# kernels 9-11 at mhop.beam5.b100's shapes: its FFN over every token a
# batch runs (hop 1, 100 x 70, and the five hop-2 tiles: 97,922 tokens),
# and its hop-2 tile 5 (63 rows at 350) for the softmax and the LayerNorm
ENC_FFN_TOKENS, ENC_TILE = 97922, (63, 350)
# the bf16-score softmax (the main path's retriever and the reader): the
# reader's 32 x 512 rows of 16 heads (the record), the main path's hop 1
# (B x Q_LEN) and a hop-2 tile at QSP_LEN; (B, nh, L)
ROUND_CASES = ((32, 16, 512), (B, NH, Q_LEN), (63, NH, QSP_LEN))
# the reader's LayerNorm: 32 x 512 rows of 1024, eps 1e-12
READER_LN = (32, 512, 1024, 1e-12)


def check_encoder_chains(dev, gen, recs):
    """Kernels 9-11 against their plain twins, each variant that a leg
    launches under its own name (``VARIANT_OF``): kernel 9 at
    mhop.beam5.b100's FFN, bit for bit; kernel 10 with fp32 scores (the
    benchmark's retriever, its tile 5) within 1 bf16 ulp, and with bf16
    scores (the main path's retriever, the reader) each row exactly the
    twin's e / s for s the twin's bf16 row sum or its bf16 neighbour (the
    fp32 sums in another order may round the other way); kernel 11 at 768
    wide, eps 1e-5 (tile 5) and at 1024, eps 1e-12 (the reader) within 1
    bf16 ulp.  Each with the share of outputs (or rows) off, the card's
    time (``device_ms``: the host's launches left out) and the host's
    microseconds a call, beside the twin's time, the bound (bytes: each
    input read once, the output written once) and a library yardstick the
    port never calls:
    ``F.gelu`` of the biased input (without the bias add),
    ``torch.softmax`` of the scores (without scale and mask),
    ``F.layer_norm`` of the summed input (without the two adds)."""
    import math

    import torch.nn.functional as F

    ef = importlib.import_module(
        "multihop_dense_retrieval_tpu_torch.ops.encoder_fused")
    bf = torch.bfloat16

    def ulps(got, exp):
        e = exp.float().abs().clamp(min=2.0 ** -8)
        _, ex = torch.frexp(e)
        off = (got.float() - exp.float()).abs().detach() / torch.ldexp(
            torch.ones_like(e), ex - 8)
        return float(off.max()), float((off > 0).float().mean())

    def rows_off(got, exp, raw, attn_bias, scale):
        """bf16 scores: (largest ulps, share of rows off) where every row
        is the twin's e / s for s its bf16 row sum or a neighbour."""
        s = raw / scale + attn_bias.to(raw.dtype)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        bits = e.sum(-1, keepdim=True).view(torch.int16)     # sums >= 1
        same = (got == exp).all(-1)
        near = [(e / (bits + k).view(raw.dtype) == got).all(-1)
                for k in (1, -1)]
        assert bool((same | near[0] | near[1]).all()), \
            "masked_softmax (bf16 scores): a row is not e / s"
        return ulps(got, exp)[0], float((~same).float().mean())

    def record(name, what, got, exp, fn, plain, lib, n_bytes, lib_what,
               err=None, of="outputs"):
        torch.cuda.synchronize()
        kernel = name.split(".")[0]
        taken = template(kernel) if kernel in VARIANT_OF else "one pass"
        assert taken in (name, "one pass"), f"{name} took {taken}"
        if kernel == "bias_gelu":
            assert torch.equal(got, exp), "kernel 9 is not bit-equal"
            err = (0.0, 0.0)
        elif err is None:
            err = ulps(got, exp)
        # rows of bf16 scores move by 1-2 ulps where their sum rounds the
        # other way: rows_off has held them to e / s
        assert err[1] <= 1e-3 and (of == "rows" or err[0] <= 1.0), \
            f"{name} {what}: max {err[0]} ulps, {err[1]} of {of} off"
        ms, host_us = device_ms(fn, 20)
        plain_ms = device_ms(plain, 3)[0]
        lib_ms = device_ms(lib, 5)[0] if lib else None
        ROUTES.pop(kernel, None)             # the timed calls' variants
        bnd = bound_ms(n_bytes, 0, "bf16")
        lib_note = f", {lib_what} {lib_ms:.4f} ms" if lib else ""
        say(f"  {name} {what}: {ms:.4f} ms on the card, {host_us:.1f} us "
            f"of host a call (plain {plain_ms:.4f} ms{lib_note}, bound "
            f"{bnd[0]:.4f} ms by {bnd[1]}, {bnd[0] / ms:.3f} of it); max "
            f"{err[0]:.3g} bf16 ulps, {err[1]:.3g} of {of} off")
        if name not in recs:
            recs[name] = dict(err=err[0], ms=ms, plain_ms=plain_ms,
                              bound=bnd, library_ms=lib_ms, template=taken,
                              kernel=kernel)

    inter = 4 * D
    y = (3 * torch.randn(ENC_FFN_TOKENS, inter, device=dev, generator=gen)
         ).to(bf)
    bias = torch.randn(inter, device=dev, generator=gen).to(bf)
    record("bias_gelu", f"(FFN, {ENC_FFN_TOKENS} x {inter})",
           ef.bias_gelu(y, bias), ef.bias_gelu_plain(y, bias),
           lambda: ef.bias_gelu(y, bias), lambda: ef.bias_gelu_plain(y, bias),
           lambda: F.gelu(y), 4 * y.numel() + 2 * inter, "F.gelu")
    del y

    def scores(b, nh, w, d):
        raw = (3 * math.sqrt(d) * torch.randn(b, nh, w, w, device=dev,
                                              generator=gen)).to(bf)
        lens = torch.randint(8, w + 1, (b,), device=dev, generator=gen)
        mask = torch.arange(w, device=dev)[None] < lens[:, None]
        attn_bias = torch.where(mask[:, None, None, :], 0.0, -1e9).to(
            torch.float32)
        scale = torch.tensor(math.sqrt(d), dtype=torch.float32).to(bf)
        return raw, attn_bias, scale

    dh = D // NH
    b, w = ENC_TILE
    raw, attn_bias, scale = scores(b, NH, w, dh)
    args = (raw, attn_bias, scale, "float32")
    record("masked_softmax.fp32_scores", f"(tile, {b} x {NH} x {w} x {w})",
           ef.masked_softmax(*args), ef.masked_softmax_plain(*args),
           lambda: ef.masked_softmax(*args),
           lambda: ef.masked_softmax_plain(*args),
           lambda: torch.softmax(raw, -1), 4 * raw.numel() + 4 * b * w,
           "torch.softmax")
    del raw
    for i, (b, nh, w) in enumerate(ROUND_CASES):
        raw, attn_bias, scale = scores(b, nh, w, 64)
        args = (raw, attn_bias, scale, "bfloat16")
        got, exp = ef.masked_softmax(*args), ef.masked_softmax_plain(*args)
        torch.cuda.synchronize()
        record("masked_softmax.bf16_scores",
               f"({'reader' if i == 0 else 'main path'}, {b} x {nh} x {w} "
               f"x {w})", got, exp,
               lambda: ef.masked_softmax(*args),
               lambda: ef.masked_softmax_plain(*args),
               (lambda: torch.softmax(raw, -1)) if i == 0 else None,
               4 * raw.numel() + 4 * b * w, "torch.softmax",
               err=rows_off(got, exp, raw, attn_bias, scale), of="rows")
        del raw, got, exp

    def layer_norm_case(name, what, rows, n, eps):
        x = torch.randn(rows, n, device=dev, generator=gen).to(bf)
        y = torch.randn(rows, n, device=dev, generator=gen).to(bf)
        bias = (0.1 * torch.randn(n, device=dev, generator=gen)).to(bf)
        ln = torch.nn.LayerNorm(n, eps=eps).to(dev)
        with torch.no_grad():
            ln.weight.copy_(1 + 0.1 * torch.randn(n, device=dev,
                                                   generator=gen))
            ln.bias.copy_(0.1 * torch.randn(n, device=dev, generator=gen))
        args = (y, bias, x, ln)
        record(name, what, ef.add_layer_norm(*args),
               ef.add_layer_norm_plain(*args),
               lambda: ef.add_layer_norm(*args),
               lambda: ef.add_layer_norm_plain(*args),
               lambda: F.layer_norm(x, (n,), ln.weight.to(bf),
                                    ln.bias.to(bf)),
               6 * x.numel() + 2 * n + 8 * n, "F.layer_norm")

    b, w = ENC_TILE
    layer_norm_case("add_layer_norm.768_eps1e-05", f"(tile, {b * w} x {D})",
                    b * w, D, 1e-5)
    b, w, n, eps = READER_LN
    layer_norm_case(f"add_layer_norm.{n}_eps{eps:g}",
                    f"(reader, {b * w} x {n})", b * w, n, eps)


def time_attention_step(dev, gen, mask):
    """The encoder's attention step at the shape of ``mask`` (the corpus
    shape, B=256, L=300; bf16, roberta-base width) under each
    attention_impl, with one set of weights: CUDA events over 10 calls."""
    from multihop_dense_retrieval_tpu_torch.core.config import EncoderConfig
    from multihop_dense_retrieval_tpu_torch.models.encoder import Attention

    b, w = mask.shape
    x = torch.randn(b, w, D, device=dev, generator=gen).to(torch.bfloat16)
    bias = torch.where(mask[:, None, None, :].bool(), 0.0, -1e9
                       ).to(torch.float32)
    torch.manual_seed(3)
    att = Attention(EncoderConfig.roberta_base()).to(dev, torch.bfloat16)
    times = {}
    for impl, scores in (("fused", "float32"), ("xla", "float32"),
                         ("xla", "bfloat16")):
        att.c = EncoderConfig.roberta_base(attention_impl=impl,
                                           attention_scores_dtype=scores)
        with torch.inference_mode():
            times[f"{impl}/{scores} scores"] = cuda_ms(
                lambda: att.context(x, bias, mask), 10)
    say(f"  encoder attention step at B={b}, L={w} (projections "
        f"included), ms: {json.dumps(times)}")


# ---- phase 3: the serving engine ------------------------------------------


def synth_doc_lens(rng, n, lo=20, hi=300):
    """Wiki-abstract-like token lengths: lognormal, mean ~100, clipped."""
    lens = np.exp(rng.normal(np.log(95.0), 0.55, size=n))
    return np.clip(lens, lo, hi).astype(np.int32)


def make_questions(rng, spec):
    lens = rng.randint(6, Q_LEN - 2, size=B)
    raw = np.full((B, Q_LEN - 2), spec.pad_id, np.int32)
    ids = np.full((B, Q_LEN), spec.pad_id, np.int32)
    mask = np.zeros((B, Q_LEN), np.int32)
    for i, n in enumerate(lens):
        toks = rng.randint(10, VOCAB - 10, size=n)
        raw[i, :n] = toks
        ids[i, :n + 2] = [spec.cls_id, *toks, spec.sep_id]
        mask[i, :n + 2] = 1
    return {"input_ids": ids, "attention_mask": mask}, raw, lens.astype(np.int32)


def make_rows(n, gen, dev):
    """Low-rank rows (64 directions, decaying spectrum) + small isotropic
    noise, of norm ~sqrt(D)/2: half a question vector's (a LayerNorm
    output), so a planted question row stays its question's clear top-1."""
    basis = torch.linalg.qr(torch.randn(D, 64, device=dev, generator=gen))[0]
    spread = torch.linspace(3.0, 0.8, 64, device=dev)
    spread = spread * (D / 4 / float((spread ** 2).sum())) ** 0.5
    out = np.empty((n, D), np.float32)
    for s in range(0, n, 1 << 18):
        e = min(s + (1 << 18), n)
        z = torch.randn(e - s, 64, device=dev, generator=gen) * spread
        x = z @ basis.t() + 0.05 * torch.randn(e - s, D, device=dev,
                                               generator=gen)
        out[s:e] = x.cpu().numpy()
    return out


def make_token_store(n, gen, dev):
    """(n, 300) 16-bit token ids on the device (int16 bit patterns)."""
    ids = torch.randint(10, VOCAB - 10, (n, TEXT_LEN), device=dev,
                        generator=gen, dtype=torch.int32)
    ids = torch.where(ids >= 32768, ids - 65536, ids).to(torch.int16)
    lens = torch.from_numpy(synth_doc_lens(np.random.RandomState(17), n))
    return ids, lens.to(dev), torch.zeros(n, dtype=torch.bool, device=dev)


def record_queries(engine, outputs=False):
    """Keep the query vectors each MIPS call of `engine` is given (the
    hop-1 and hop-2 vectors of the last batch), so the hops can be held
    against the plain scans on exactly those vectors; with `outputs`,
    (queries, k, (vals, doc ids, certificates)) of each call."""
    seen = []
    hop_mips = engine._mips

    def _mips(queries, k, pca=True):
        res = hop_mips(queries, k, pca)
        seen.append((queries, k, res) if outputs else queries)
        return res

    engine._mips = _mips
    return seen


@contextlib.contextmanager
def recorded_engines(cls):
    """Within the block, (index, queries, k, (vals, doc ids, certificates))
    of every MIPS call of every engine of class ``cls``: for a CLI that
    builds its own engine."""
    seen = []
    hop_mips = cls._mips

    def _mips(self, queries, k, pca=True):
        res = hop_mips(self, queries, k, pca)
        seen.append((self.index, queries, k, res))
        return res

    cls._mips = _mips
    try:
        yield seen
    finally:
        cls._mips = hop_mips


def record_launches(mips, names):
    """Keep (name, arguments, result) of every call of the kernel wrappers
    ``names`` of ``mips``: (that list, a function that puts the wrappers
    back)."""
    seen = []
    own = {name: getattr(mips, name) for name in names}

    def recorded(name):
        def call(*a):
            res = own[name](*a)
            seen.append((name, a, res))
            return res
        return call

    def restore():
        for name, fn in own.items():
            setattr(mips, name, fn)

    for name in names:
        setattr(mips, name, recorded(name))
    return seen, restore


def check_recorded_launches(seen, mips):
    """Hold recorded launches of kernels 3 and 4 against their plain
    versions on the same arguments.  Kernel 4 bit-equal.  Kernel 3 within
    the fp32 summation bound of its R exact bf16 products: each side's sum
    lies within R * 2^-23 times the sum of |products| of the exact one
    (an ulp an add, truncated or rounded), so the two within R * 2^-22
    times the chunk's largest sum of |products|, or within phase 2's 1e-3
    where that is smaller.  The serving path's projected scores reach the
    hundreds, where the tensor cores' sums lie more than 1e-3 from the
    plain version's.  Clears them; returns (launches, kernel 3's largest
    error, its largest share of the bound)."""
    worst = share = 0.0
    n = len(seen)
    for name, a, res in seen:
        if name == "pca_chunk_max":
            qp, proj, cand, n_valid = a
            err = (res - mips.chunk_max_plain(*a)).abs()
            mag = mips.chunk_max_plain(qp.abs(), proj.abs(), cand, n_valid)
            tol = (qp.shape[1] * 2.0 ** -22 * mag).clamp(min=1e-3)
            assert bool((err <= tol).all()), \
                f"kernel 3 (B={qp.shape[0]}) off by {err.max().item()}"
            worst = max(worst, err.max().item())
            share = max(share, (err / tol).max().item())
        else:
            assert torch.equal(res, mips.rescan_plain(*a)), \
                f"kernel 4 (B={a[1].shape[0]}) disagrees with its plain version"
    seen.clear()
    return n, worst, share


def scan_order_scores(q32, index, rows, mips, rescan_order):
    """fp32 score of row rows[i] for query i, on the host, in one of the
    two int8 epilogues: the scan's (raw * q_scale) * d_scale or the
    rescan's (raw * d_scale) * q_scale."""
    qi, qs = mips.quantize_rows(q32)
    qi, qs = qi.cpu().numpy().astype(np.int64), qs.cpu().numpy()
    x = index.vectors[torch.from_numpy(rows).to(index.vectors.device).long()]
    raw = (qi * x.cpu().numpy().astype(np.int64)).sum(1).astype(np.float32)
    dsc = index.scales.cpu().numpy()[rows]
    if rescan_order:
        return (raw * dsc) * qs
    return (raw * qs) * dsc


def check_int8_path(out, seen, index, mips, n_valid):
    """Hold one int8-engine batch against exact plain scans on the same
    query vectors.  Hop 1 (kernel 1): ids and scores bit-equal.  Hop 2
    (kernels 3 + 4 in mips_topk_pca): every returned score is bit-equal to
    its row's rescan-order product (the chunk-to-row gather and the
    q_scale order), it is never above the exact top-1 in the scan's order,
    and a certified query returns the exact top-1 row.  Chain scores are
    the fp32 sum of the two hops.  Returns the certified fraction."""
    q1, q2 = seen[-2], seen[-1]
    for q, hop in ((q1, 1), (q2, 2)):
        assert q.shape == (B, D) and bool(torch.isfinite(q).all()), hop
    vecs, dsc = index.vectors, index.scales
    qi, qs = mips.quantize_rows(q1)
    v1, i1 = mips.mips_scan_int8_plain(qi, qs, vecs, dsc, 1, n_valid)
    assert np.array_equal(out["hop1_ids"][:, 0], i1[:, 0].cpu().numpy()), \
        "hop-1 ids differ from the exact plain scan"
    assert np.array_equal(out["hop1_cand_scores"][:, 0],
                          v1[:, 0].cpu().numpy()), \
        "hop-1 scores differ from the exact plain scan"
    qi, qs = mips.quantize_rows(q2)
    v2, i2 = mips.mips_scan_int8_plain(qi, qs, vecs, dsc, 1, n_valid)
    v2, i2 = v2[:, 0].cpu().numpy(), i2[:, 0].cpu().numpy()
    got = out["hop2_ids"][:, 0]
    d2 = scan_order_scores(q2, index, got, mips, rescan_order=True)
    assert np.array_equal(out["path_scores"][:, 0],
                          out["hop1_cand_scores"][:, 0] + d2), \
        "hop-2 scores are not the rescan-order products of their rows"
    assert (scan_order_scores(q2, index, got, mips, rescan_order=False)
            <= v2).all(), "hop 2 returned a row above the exact top-1"
    cert = out["pca_cert2"][:, 0]
    assert np.array_equal(got[cert], i2[cert]), \
        "a certified hop-2 query differs from the exact top-1"
    return float(cert.mean())


def check_recorded_hops(seen, index, mips):
    """Hold recorded MIPS calls (queries, k, (vals, doc ids, certificates))
    of an int8 engine against the plain scans over ``index`` as it stood when they
    ran.  A scan hop (kernel 1): ids and scores bit-equal to the plain scan
    at the call's k.  A PCA hop (kernels 3 + 4): no id at or past n_docs,
    every returned score bit-equal to its row's rescan-order product, the
    top row's scan-order score never above the exact top-1, and a certified
    query's top row the exact top-1.  Returns (scan rows, PCA rows,
    certified PCA rows)."""
    n_valid = index.n_docs
    n_scan = n_pca = n_cert = 0
    for q, k, (vals, docs, cert) in seen:
        assert bool(torch.isfinite(q).all()), "non-finite query vectors"
        qi, qs = mips.quantize_rows(q)
        if cert is None:
            ev, ei = mips.mips_scan_int8_plain(qi, qs, index.vectors,
                                               index.scales, k, n_valid)
            assert torch.equal(vals, ev) and torch.equal(docs, ei.long()), \
                f"kernel 1 (B={q.shape[0]}, k={k}) differs from the plain scan"
            n_scan += q.shape[0]
            continue
        ev, ei = mips.mips_scan_int8_plain(qi, qs, index.vectors,
                                           index.scales, 1, n_valid)
        d, v = docs.cpu().numpy(), vals.cpu().numpy()
        assert (d < n_valid).all(), f"a PCA hop returned an id >= {n_valid}"
        for j in range(k):
            assert np.array_equal(v[:, j], scan_order_scores(
                q, index, d[:, j], mips, rescan_order=True)), \
                f"PCA hop (B={q.shape[0]}) score {j} is not its row's product"
        assert (scan_order_scores(q, index, d[:, 0], mips, rescan_order=False)
                <= ev[:, 0].cpu().numpy()).all(), \
            f"PCA hop (B={q.shape[0]}) returned a row above the exact top-1"
        c = cert.cpu().numpy()
        assert np.array_equal(d[c, 0], ei[:, 0].cpu().numpy()[c]), \
            f"a certified PCA query (B={q.shape[0]}) missed the exact top-1"
        n_pca += q.shape[0]
        n_cert += int(c.sum())
    return n_scan, n_pca, n_cert


def check_bf16_path(out, seen, index, mips):
    """Kernel 2 at the bf16 engine's own shapes: both hops' fp32 query
    vectors against the plain scan over its rows.  Ids equal apart from
    near-ties; scores within rtol 1e-5 (fp32 sums of 768 bf16 products in
    another order); the engine returned the kernel's ids.  Returns the
    largest relative score difference."""
    worst = 0.0
    for q, key in zip(seen[-2:], ("hop1_ids", "hop2_ids")):
        kv, ki = mips.mips_scan(q, index.vectors, 1)
        pv, pi = mips.mips_scan_plain(q, index.vectors, 1)
        rel = ((kv - pv).abs() / pv.abs().clamp(min=1e-30)).max().item()
        say(f"  bf16 path {key}: kernel 2 vs plain, max relative score "
            f"difference {rel:.3g}")
        assert rel <= 1e-5, f"kernel 2 ({key}) off by {rel} relative"
        qb = q.to(torch.bfloat16).float()
        alt = (qb * index.vectors[ki[:, 0].long()].float()).sum(1)
        tie_ok = (ki[:, 0] == pi[:, 0]) | \
            ((alt - pv[:, 0]).abs() <= 1e-5 * pv[:, 0].abs())
        assert bool(tie_ok.all()), f"kernel 2 ({key}) ids beyond near-ties"
        assert np.array_equal(out[key][:, 0], ki[:, 0].cpu().numpy()), \
            f"bf16 engine {key} differ from the kernel's"
        worst = max(worst, rel)
    return worst


def timed_batches(engine, q_inputs, q_raw, q_lens, iters):
    """Host-clock seconds of each of `iters` batches (search() returns
    numpy arrays, so each batch ends after its device work and copies)."""
    secs = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = engine.search(dict(q_inputs), q_raw, q_lens)
        secs.append(time.perf_counter() - t0)
    return out, np.array(secs)


def leg_clock():
    """``lap(leg)`` prints the seconds since the last lap (or this call)
    under the leg's name: where the script's time goes."""
    last = [time.perf_counter()]

    def lap(leg):
        now = time.perf_counter()
        say(f"  [leg {leg}: {now - last[0]:.1f} s]")
        last[0] = now

    return lap


def run_main_path(port, mips, dev, gen, smi, table_path=None, iters=50):
    cfgmod, data, index_mod, models, search = port
    cfg = cfgmod.EncoderConfig.roberta_base(dtype="bfloat16",
                                            attention_scores_dtype="bfloat16")
    torch.manual_seed(0)
    model = models.MhopRetriever(cfg, cls_only=True)
    # PyTorch's default init leaves the CLS vectors of random questions
    # nearly parallel (cosine > 0.99), too close for a planted self-retrieval
    # check under int8 rounding; a wider init spreads them (cosine ~0.95)
    for mod in model.modules():
        if isinstance(mod, torch.nn.Linear):
            torch.nn.init.normal_(mod.weight, std=0.05)
    model = model.to(dev).eval()
    lap = leg_clock()
    spec = data.TokenizerSpec(cls_id=0, sep_id=2, pad_id=1, vocab_size=VOCAB)
    rng = np.random.RandomState(0)
    q_inputs, q_raw, q_lens = make_questions(rng, spec)
    with torch.inference_mode():
        q_vec = model.encode_seq(torch.from_numpy(q_inputs["input_ids"]).to(dev),
                                 torch.from_numpy(q_inputs["attention_mask"]
                                                  ).to(dev)).cpu().numpy()
    cos = q_vec @ q_vec.T / np.outer(*[np.linalg.norm(q_vec, axis=1)] * 2)
    say(f"  question vectors: norm {np.linalg.norm(q_vec, axis=1).mean():.2f}, "
        f"max off-diagonal cosine {(cos - 2 * np.eye(B)).max():.4f}")

    t0 = time.perf_counter()
    emb = make_rows(N, gen, dev)
    n_small = min(1 << 16, N)
    emb_small = emb[:n_small].copy()          # the bf16 engine's rows
    # the planted rows share one 512-row chunk: the prefilter can then
    # prove hop 2 (spread over 192 chunks, each with a large PCA residual,
    # no query certifies)
    base = CAND * rng.randint(N // CAND)
    planted = base + np.arange(B)
    emb[planted] = q_vec
    index = index_mod.DenseIndex.build(emb, chunk_rows=4096, dtype="int8",
                                       pca_dims=R, pca_cand_rows=CAND,
                                       device=dev)
    text_ids, text_lens, empty = make_token_store(N, gen, dev)
    say(f"  set-up: {N}x{D} int8 index + PCA R={R} + {N}x{TEXT_LEN} token "
        f"store in {time.perf_counter() - t0:.1f} s")
    scfg = cfgmod.SearchConfig(
        beam_size_1=1, beam_size_2=1, topk=1, batch_size=B, max_q_len=Q_LEN,
        max_q_sp_len=QSP_LEN, hop2_buckets=cfgmod.HOP2_BUCKETS_5TILE,
        hop2_tile_fracs=cfgmod.HOP2_TILE_FRACS_5TILE, use_pca=True,
        pca_k_chunks=KC)
    engine = search.BeamSearcher(
        encode_fn=model.encode_seq, index=index, text_ids=text_ids,
        text_lens=text_lens, empty=empty, spec=spec, config=scfg, device=dev)
    del emb

    # path 1: the int8 engine (kernels 1, 3, 4)
    engine.search(dict(q_inputs), q_raw, q_lens)          # warm-up
    torch.cuda.synchronize()
    mips.reset_launch_counts()
    out, secs = timed_batches(engine, q_inputs, q_raw, q_lens, iters)
    launches = {"int8": leg_counts(mips)}
    seen = record_queries(engine)
    checked = engine.search(dict(q_inputs), q_raw, q_lens)
    for key, val in out.items():
        assert val.shape[0] == B, (key, val.shape)
        assert np.array_equal(val, checked[key]), f"{key} differs by batch"
    assert np.isfinite(out["path_scores"]).all(), "non-finite chain scores"
    hit = (out["hop1_ids"][:, 0] == planted).mean()
    assert hit == 1.0, f"planted self-retrieval failed: hit rate {hit}"
    n_valid = index.n_docs if index.n_docs < index.vectors.shape[0] else None
    cert = check_int8_path(checked, seen, index, mips, n_valid)
    assert cert > 0, "no hop-2 query certified: the certificate went untested"
    med = float(np.median(secs))
    say(f"  int8 path: median {med * 1e3:.2f} ms/batch (min "
        f"{secs.min() * 1e3:.2f}, max {secs.max() * 1e3:.2f}) over {iters} "
        f"batches of {B}: {B / med:.1f} q/s at the median, "
        f"{B * iters / secs.sum():.1f} q/s over the window (host clock incl. "
        f"transfers); planted hop-1 hit rate {hit:.3f}; hop 1 = exact scan "
        f"(bit-equal); hop-2 certified fraction {cert:.4f}, certified = "
        f"exact top-1 [{smi}]")
    say(f"  int8 path launches over {iters} batches: "
        f"{json.dumps(launches['int8'])}")
    missing = [k for k in ("mips_scan_int8", "pca_chunk_max", "pca_rescan_int8")
               if launches["int8"][k] == 0]
    assert not missing, f"kernels not launched on the int8 path: {missing}"
    assert launches["int8"]["mips_scan"] == 0, "bf16 scan ran on the int8 path"
    profile_batch(engine, q_inputs, q_raw, q_lens, med * 1e3, smi, table_path)
    lap("a")
    launches["int8_two_phase"] = run_int8_two_phase(
        engine, scfg, q_inputs, q_raw, q_lens, mips, search, n_valid, smi)
    lap("d")
    launches["fused_serving"] = run_fused_serving(
        engine, model, models, search, q_inputs, q_raw, q_lens, planted, mips,
        n_valid, smi)
    lap("f")
    launches.update(run_beam4_serving(
        engine, model, port, q_inputs, q_raw, q_lens, mips, smi))
    lap("h")
    launches.update(run_sharded_serving(
        engine, scfg, q_inputs, q_raw, q_lens, planted, mips, search,
        B / med, smi))
    lap("n1")
    del engine, index

    # path 2: a bf16 index engine without prefilter (kernel 2)
    planted_small = rng.choice(n_small, B, replace=False)
    emb_small[planted_small] = q_vec
    bf16_index = index_mod.DenseIndex.build(emb_small, chunk_rows=4096,
                                            dtype="bfloat16", device=dev)
    bf16_engine = search.BeamSearcher(
        encode_fn=model.encode_seq, index=bf16_index,
        text_ids=text_ids[:n_small], text_lens=text_lens[:n_small],
        empty=empty[:n_small], spec=spec,
        config=dataclasses.replace(scfg, use_pca=False), device=dev)
    bf16_engine.search(dict(q_inputs), q_raw, q_lens)     # warm-up
    torch.cuda.synchronize()
    seen = record_queries(bf16_engine)
    mips.reset_launch_counts()
    out_bf16, secs = timed_batches(bf16_engine, q_inputs, q_raw, q_lens, 5)
    launches["bf16"] = leg_counts(mips)
    hit_bf16 = (out_bf16["hop1_ids"][:, 0] == planted_small).mean()
    assert hit_bf16 == 1.0, f"bf16 engine self-retrieval: hit rate {hit_bf16}"
    rel = check_bf16_path(out_bf16, seen, bf16_index, mips)
    med = float(np.median(secs))
    say(f"  bf16 path ({n_small} rows): median {med * 1e3:.2f} ms/batch over "
        f"5 batches; planted hop-1 hit rate {hit_bf16:.3f}; kernel 2 vs plain "
        f"at both hops: max relative score difference {rel:.3g} [{smi}]")
    say(f"  bf16 path launches over 5 batches: {json.dumps(launches['bf16'])}")
    assert launches["bf16"]["mips_scan"] > 0, "bf16 scan not launched"
    assert sum(launches["bf16"][k] for k in search_kernels(mips)) == \
        launches["bf16"]["mips_scan"], "int8 kernels ran on the bf16 path"
    del bf16_engine, bf16_index, text_ids, text_lens, empty
    lap("b")

    # leg l searches leg c's directory (in ftmp) and leg e2's, and scores
    # leg g2's predictions; leg g serves from e2's directory and checkpoint
    with tempfile.TemporaryDirectory() as ftmp:
        fever_configs = {}
        launches.update(run_fever_cli(port, model, mips, dev, gen, smi, ftmp,
                                      fever_configs))
        lap("c")
        launches.update(run_sharded_fever(mips, dev, smi, ftmp,
                                          fever_configs, launches))
        lap("n2")
        with tempfile.TemporaryDirectory() as tmp:
            launches.update(run_corpus_encoding(port, model.state_dict(),
                                                mips, dev, smi, tmp))
            lap("e")
            launches.update(run_data_parallel_encoding(
                port, model.state_dict(), mips, dev, smi, tmp))
            lap("n3")
            run_pod_runner(smi, tmp)
            lap("n4")
            launches.update(run_qa_serving(mips, dev, smi, tmp))
            lap("g")
            launches.update(run_hnsw_tier(port, mips, dev, smi, tmp))
            lap("i")
            launches.update(run_bulk_retrieval(mips, dev, gen, smi, ftmp,
                                               tmp))
            lap("l")
    # leg k exports leg j's stage-1 checkpoint and reuses its rows; leg p's
    # processes start inside leg o, once its throughput runs are done
    subs = {}
    with tempfile.TemporaryDirectory() as tmp, \
            tempfile.TemporaryDirectory() as ptmp:
        try:
            launches.update(run_training(port, mips, dev, smi, tmp))
            lap("j")
            launches.update(run_reader_training(port, mips, dev, smi, tmp))
            lap("k")
            launches.update(run_parallel_training(
                port, mips, dev, smi, tmp,
                then=lambda: subs.update(start_p_sub_legs(smi, ptmp))))
            lap("o")
            launches.update(run_trained_weights(mips, dev, smi, ptmp, subs))
            lap("p")
        finally:
            stop_processes(subs)
    launches.update(run_quickstart(mips, dev, smi))
    lap("m")
    return launches


def run_fused_serving(engine, model, models, search, q_inputs, q_raw, q_lens,
                      planted, mips, n_valid, smi):
    """Leg (f): the int8 path's engine with the same weights under
    attention_impl="fused": 5 timed batches with their own launch counts
    (kernel 8 once a layer for hop 1 and for each hop-2 tile, beside
    kernels 1, 3, 4); one more batch held to the exact scans on its own
    query vectors (check_int8_path), and one profiled.  The planted rows
    are the "xla" encoder's vectors, so the hit rate is reported, not
    held."""
    cfg = dataclasses.replace(model.config, attention_impl="fused")
    fused = models.MhopRetriever(cfg, cls_only=True)
    fused.load_state_dict(model.state_dict())
    fused = fused.to(engine.device).eval()
    eng = search.BeamSearcher(
        encode_fn=fused.encode_seq, index=engine.index,
        text_ids=engine.text_ids, text_lens=engine.text_lens,
        empty=engine.empty, spec=engine.spec, config=engine.config,
        device=engine.device)
    eng.search(dict(q_inputs), q_raw, q_lens)              # warm-up
    torch.cuda.synchronize()
    mips.reset_launch_counts()
    out, secs = timed_batches(eng, q_inputs, q_raw, q_lens, 5)
    launches = leg_counts(mips)
    seen = record_queries(eng)
    checked = eng.search(dict(q_inputs), q_raw, q_lens)
    for key, val in out.items():
        assert np.array_equal(val, checked[key]), f"{key} differs by batch"
    cert = check_int8_path(checked, seen, eng.index, mips, n_valid)
    hit = (out["hop1_ids"][:, 0] == planted).mean()
    med = float(np.median(secs))
    tiles = len(engine.config.hop2_buckets)
    say(f"  fused serving leg (attention_impl=fused): median "
        f"{med * 1e3:.2f} ms/batch over 5 batches of {B} ({B / med:.1f} q/s)"
        f"; hop 1 = exact scan (bit-equal); hop-2 certified fraction "
        f"{cert:.4f}, certified = exact top-1; planted hop-1 hit rate {hit:.3f}"
        f" (planted rows are the xla encoder's) [{smi}]")
    say(f"  fused serving launches over 5 batches: {json.dumps(launches)}")
    want = 5 * model.config.num_layers * (1 + tiles)
    assert launches["fused_attention"] == want, \
        f"kernel 8 launched {launches['fused_attention']} times, not {want}"
    for name in ("mips_scan_int8", "pca_chunk_max", "pca_rescan_int8"):
        assert launches[name] > 0, f"{name} not launched on leg (f)"
    kernels = profile_batch(eng, q_inputs, q_raw, q_lens, med * 1e3, smi)
    attn = {n.split("(")[0].replace("void ", ""): round(t, 3)
            for t, n in kernels if "mdrt_attn" in n}     # kernel 8's templates
    say(f"  leg f kernel 8 in the profiled batch: {sum(attn.values()):.3f} "
        f"device ms (the SIMT kernel's: 25.91 ms): {json.dumps(attn)}")
    assert attn, "no kernel-8 time in leg f's profile"
    del eng, fused
    return launches


def record_pass2(engine):
    """Keep (row lengths, active rows) of the cascade's pass-2 encode (the
    front-sorted call of ``_encode_hop2``) of each search of ``engine``."""
    calls = []
    encode = engine._encode_hop2

    def recorded(qsp, **kw):
        if kw.get("inactive_sort") == "front":
            calls.append((qsp["attention_mask"].sum(1).cpu().numpy(),
                          kw["active"].cpu().numpy()))
        return encode(qsp, **kw)

    engine._encode_hop2 = recorded
    return calls


def skipped_rows(lens, active, fracs, top_slot):
    """The (question, slot) rows, flat, of the cascade's pass-2 tiles with
    no active row, on the host: pass 2 holds each question's non-top slots
    in slot order, sorts them stably by length with inactive rows first
    (key -1) and cuts the configured tiles."""
    n = len(lens)
    keys = np.where(active, lens, -1)
    order = np.argsort(keys, kind="stable")
    sizes = [int(round(f * n)) for f in fracs]
    sizes[-1] = n - sum(sizes[:-1])
    bounds = np.cumsum([0] + sizes)
    skipped = np.concatenate(
        [order[a:b] for a, b in zip(bounds[:-1], bounds[1:])
         if not active[order[a:b]].any()] or [np.zeros(0, np.int64)])
    nt = np.array([[q * B4 + j for j in range(B4) if j != t]
                   for q, t in enumerate(top_slot)]).reshape(-1)
    return nt[skipped]


def check_beam4_semantics(out, margin, thr, pass2, fracs, neg_inf,
                          n_real=None):
    """Hold one leg-h batch to the beam-4 rules on its own outputs: every
    finite chain's hop-1 candidate meets the margin rule on the engine's
    d1 (the auto:Q margin at the JAX engine's static index into the sorted
    gaps), the top-1 candidate is always kept; a stopped question keeps
    exactly beam2 finite chains, all through its top-1 candidate; every
    row of a skipped pass-2 tile has stop probability exactly 0.5.
    Returns (pruned share of the first ``n_real`` questions, all by
    default; stop rate, skipped rows)."""
    d1 = out["hop1_cand_scores"]
    bsz = d1.shape[0]
    top1 = d1.max(1, keepdims=True)
    top_slot = d1.argmax(1)
    kept = d1 > neg_inf / 2
    if margin != 0:
        if margin > 0:
            m = np.float32(margin)
        else:
            gaps = np.sort((top1 - d1).reshape(-1))
            m = gaps[bsz + int((gaps.size - bsz - 1) * min(-margin, 1.0))]
        kept &= d1 >= top1 - m
    assert kept[np.arange(bsz), top_slot].all(), "a top-1 candidate was pruned"
    live = out["path_scores"] > neg_inf / 2
    slot = (out["hop1_ids"][:, :, None]
            == out["hop1_cand_ids"][:, None, :]).argmax(2)
    assert kept[np.arange(bsz)[:, None], slot][live].all(), \
        "a finite chain runs through a pruned candidate"
    stop_rate, n_skipped = 0.0, 0
    if thr > 0:
        stopped = out["stop_probs"][np.arange(bsz), top_slot] >= thr
        stop_rate = float(stopped.mean())
        top_id = out["hop1_cand_ids"][np.arange(bsz), top_slot]
        for q in np.flatnonzero(stopped):
            assert live[q].sum() == B4, f"stopped question {q}: {live[q]}"
            assert (out["hop1_ids"][q] == top_id[q]).all(), \
                f"stopped question {q} kept another candidate's chains"
        assert len(pass2) == 1, "no single pass-2 encode was recorded"
        rows = skipped_rows(*pass2[0], fracs, top_slot)
        assert (out["stop_probs"].reshape(-1)[rows] == 0.5).all(), \
            "a skipped row's stop probability is not 0.5"
        n_skipped = len(rows)
    return 1.0 - float(kept[:n_real].mean()), stop_rate, n_skipped


def profile_steps(engine, q_inputs, q_raw, q_lens, batch_ms):
    """One profiled batch: (device ms per search step, busy ms, idle share
    of the unprofiled batch time)."""
    _, events, kernels = device_kernels(
        lambda: engine.search(dict(q_inputs), q_raw, q_lens))
    busy = sum(t for t, _ in kernels)
    steps = {e.key: round(dev_ms(e), 3) for e in events if e.key in RANGES}
    return steps, busy, idle_share(busy, batch_ms)


def run_beam4_serving(engine, model, port, q_inputs, q_raw, q_lens, mips,
                      smi):
    """Leg (h): beam-4 serving at full width over leg a's index and token
    store (kept in memory): beam 4 / 4, top 4, batch 192, max_q_sp_len 350,
    the 6-tile hop-2 split.  Seven engines (H_ENGINES): h0 unpruned, h1 and
    h2 pruned at auto (q 0.5) and auto:0.9, h3 the UnifiedRetriever (leg
    a's weights and a seeded stop head) without the cascade, h4 and h5 the
    stop-skip cascade at the thresholds that stop ~30% and ~60% of the
    questions (quantiles of h3's own top-1 stop probabilities), h6 = h5
    with auto:0.9.  Each: a warm-up, H_ITERS timed batches with their own
    launch counts (kernels 1, 3, 4, nothing else), one batch held to the
    exact scans on its own query vectors (check_recorded_hops), its kernel
    3 and 4 launches to their plain versions, and to the beam-4 rules
    (check_beam4_semantics), and one profiled.  Kernel 4 is timed again
    on h3's and h5's hop-2 launches: the zero vectors of skipped rows all
    select the same chunks."""
    cfgmod, _, _, models, search = port
    cfg = dataclasses.replace(
        engine.config, beam_size_1=B4, beam_size_2=B4, topk=B4,
        hop2_buckets=cfgmod.HOP2_BUCKETS_6TILE,
        hop2_tile_fracs=cfgmod.HOP2_TILE_FRACS_6TILE)
    torch.manual_seed(21)
    unified = models.UnifiedRetriever(model.config, cls_only=True)
    torch.nn.init.normal_(unified.stop_head.weight, std=0.05)  # as leg a's
    missing, unexpected = unified.load_state_dict(model.state_dict(),
                                                  strict=False)
    assert sorted(missing) == ["stop_head.bias", "stop_head.weight"] \
        and not unexpected, (missing, unexpected)
    unified = unified.to(engine.device).eval()
    out, results, k4 = {}, {}, {}
    p_top = None
    for name, kind, margin, rate in H_ENGINES:
        thr = 0.0 if rate is None else float(np.quantile(p_top, 1 - rate / 100))
        enc = unified if kind == "unified" else model
        eng = search.BeamSearcher(
            encode_fn=enc.encode_seq,
            encode_qsp_fn=unified.encode_qsp if kind == "unified" else None,
            index=engine.index, text_ids=engine.text_ids,
            text_lens=engine.text_lens, empty=engine.empty, spec=engine.spec,
            config=dataclasses.replace(cfg, hop2_prune_margin=margin,
                                       stop_skip_threshold=thr),
            device=engine.device)
        eng.search(dict(q_inputs), q_raw, q_lens)             # warm-up
        torch.cuda.synchronize()
        mips.reset_launch_counts()
        res, secs = timed_batches(eng, q_inputs, q_raw, q_lens, H_ITERS)
        leg = f"beam4_{name}"
        out[leg] = leg_counts(mips)
        seen = record_queries(eng, outputs=True)
        pass2 = record_pass2(eng)
        launched, restore = record_launches(
            mips, ("pca_chunk_max", "pca_rescan_int8"))
        try:
            checked = eng.search(dict(q_inputs), q_raw, q_lens)
            torch.cuda.synchronize()
        finally:
            restore()
        for key, val in res.items():
            assert np.array_equal(val, checked[key]), f"{name}: {key} by batch"
        n_scan, n_pca, n_cert = check_recorded_hops(seen, eng.index, mips)
        assert n_scan == B and n_pca == B * B4, (name, n_scan, n_pca)
        k4[name] = [a for n_, a, _ in launched if n_ == "pca_rescan_int8"]
        n_k, k3_err, k3_share = check_recorded_launches(launched, mips)
        pruned, stop_rate, n_skipped = check_beam4_semantics(
            checked, margin, thr, pass2, cfg.hop2_tile_fracs, mips.NEG_INF)
        if kind == "unified" and rate is None:
            p_top = checked["stop_probs"][
                np.arange(B), checked["hop1_cand_scores"].argmax(1)]
        results[name] = checked
        ref = results["h3" if rate is not None else "h0"]
        same = ((checked["hop1_ids"] == ref["hop1_ids"])
                & (checked["hop2_ids"] == ref["hop2_ids"]))
        agree = float(same.mean())
        cascade = ""
        if rate is not None:
            # pass 1 encodes the top pairs in a tiling of its own: compare
            # their stop probabilities with h3's (one tiling for all rows),
            # and the unstopped questions' chains with h3's
            assert np.array_equal(checked["hop1_cand_ids"],
                                  ref["hop1_cand_ids"]), f"{name}: hop 1"
            top = np.arange(B), checked["hop1_cand_scores"].argmax(1)
            p_c, p_3 = checked["stop_probs"][top], ref["stop_probs"][top]
            unstopped = p_c < thr
            cascade = (f"; pass-1 top-pair stop probabilities bit-equal to "
                       f"h3's for {int((p_c == p_3).sum())} of {B} (max "
                       f"abs diff {float(np.abs(p_c - p_3).max()):.3g}); "
                       f"unstopped questions' chains equal to h3's "
                       f"{float(same[unstopped].mean()):.4f}")
        med = float(np.median(secs))
        steps, busy, idle = profile_steps(eng, q_inputs, q_raw, q_lens,
                                          med * 1e3)
        say(f"  leg h {name} ({kind}, margin {margin}, stop threshold "
            f"{thr:.4f}): {B / med:.1f} q/s at the median of {H_ITERS} "
            f"batches ({med * 1e3:.2f} ms, host clock); stop rate "
            f"{stop_rate:.3f}, rows pruned {pruned:.3f}, skipped rows "
            f"{n_skipped}; chains equal to {'h3' if rate is not None else 'h0'}"
            f"'s {agree:.4f}{cascade}; hop 1 = exact scan ({n_scan} queries, "
            f"bit-equal), hop 2 {n_pca} queries = rescan-order products, "
            f"{n_cert} certified = exact top-1; kernels 3/4 held to plain "
            f"over {n_k} launches (kernel 3 max err {k3_err:.3g}, "
            f"{k3_share:.3f} of its bound) [{smi}]")
        say(f"    device busy {busy:.2f} ms, idle share {idle:.3f}; ms per "
            f"step {json.dumps(steps)}; launches {json.dumps(out[leg])}")
        for kname in ("mips_scan_int8", "pca_chunk_max", "pca_rescan_int8"):
            assert out[leg][kname] > 0, f"{kname} not launched on leg {name}"
        others = set(search_kernels(mips)) - {
            "mips_scan_int8", "pca_chunk_max", "pca_rescan_int8"}
        assert not any(out[leg][k] for k in others), \
            f"other kernels ran on leg {name}: {out[leg]}"
        if rate is not None:
            assert abs(stop_rate - rate / 100) <= 0.1, \
                f"{name}: stop rate {stop_rate} for a target of {rate}%"
            assert n_skipped > 0 or rate < 50, f"{name}: no tile skipped"
        if margin != 0:
            assert 0 < pruned < 1, f"{name}: pruned share {pruned}"
        del eng, seen, launched
    for name in ("h3", "h5"):
        (a,) = k4[name]
        ids, q, index, cand = a[0], a[1], a[2], a[4]
        per_chunk = torch.bincount(ids.reshape(-1).long())
        uniq = int((per_chunk > 0).sum())
        ms = cuda_ms(lambda: mips.pca_rescan_int8(*a), 20)
        b, kc = ids.shape
        bnd = bound_ms(uniq * cand * (index.shape[1] + 4) + q.numel()
                       + b * kc * 4 + b * kc * cand * 4,
                       2 * b * kc * cand * index.shape[1], "int8")
        say(f"  leg h kernel 4 at {name}'s hop 2 (B={b}, kc={kc}): "
            f"{ms:.4f} ms, bound {bnd[0]:.4f} ms by {bnd[1]} ({bnd[0] / ms:.3f}"
            f" of it); {uniq} distinct chunks, at most "
            f"{int(per_chunk.max())} slots on one [{smi}]")
    return out


def run_hnsw_tier(port, mips, dev, smi, tmp):
    """Leg (i): cli/eval_mhop_retrieval --hnsw over leg e2's index
    directory (N_DOCS passages, int8) with its checkpoint: the encoder on
    the card, the graph on the host.  The first run builds
    <dir>/index.hnsw with the port's binding (M 32, ef_construction 200,
    the int8 rows dequantized with their scales); the second loads it.
    Reports the build rate, each run's q/s line, and hop-1 recall@beam
    against kernel 1's exact scan on the same query vectors (>= 0.85, as
    tests/test_hnsw.py holds the graph); the library must lie outside
    native/ and native/libhnsw.so must be left as it was."""
    from multihop_dense_retrieval_tpu_torch.cli import eval_mhop_retrieval \
        as cli
    from multihop_dense_retrieval_tpu_torch.index import hnsw

    index_mod = port[2]
    native = Path(__file__).resolve().parent / "native" / "libhnsw.so"
    state = native.stat().st_mtime_ns if native.exists() else None
    rng = np.random.RandomState(23)
    with open(f"{tmp}/hnsw_qas.jsonl", "w") as f:
        for i, (q, _) in enumerate(qa_questions(tmp, rng, N_HNSW_Q)):
            f.write(json.dumps({"_id": str(i), "question": q}) + "\n")
    builds, vectors, results = [], [], []
    add, encode, search = (hnsw.HNSWIndex.add, cli.HnswBeamSearcher._vectors,
                           cli.HnswBeamSearcher.search)

    def timed_add(self, v):
        t = time.perf_counter()
        add(self, v)
        builds.append((len(v), time.perf_counter() - t))

    def kept_vectors(self, inputs):
        res = encode(self, inputs)
        vectors.append(res)
        return res

    def kept_search(self, *a):
        res = search(self, *a)
        results.append(res)
        return res

    args = [f"{tmp}/hnsw_qas.jsonl", f"{tmp}/e2", "--tokenizer", "hash",
            "--model-name", "roberta-base", "--checkpoint", f"{tmp}/model.pt",
            "--beam-size", str(B4), "--topk", str(B4), "--batch-size", str(B),
            "--hnsw", "--save-path", f"{tmp}/hnsw_chains.jsonl"]
    lines = _Lines()
    logger = logging.getLogger("mdr_torch")
    logger.addHandler(lines)
    hnsw.HNSWIndex.add = timed_add
    cli.HnswBeamSearcher._vectors = kept_vectors
    cli.HnswBeamSearcher.search = kept_search
    try:
        for run in ("build", "load"):
            _, rows = cli.main(args)
            assert len(rows) == N_HNSW_Q and all(
                len(r["candidate_chains"]) == B4 for r in rows), run
    finally:
        hnsw.HNSWIndex.add = add
        cli.HnswBeamSearcher._vectors = encode
        cli.HnswBeamSearcher.search = search
        logger.removeHandler(lines)
    assert len(builds) == 1 and builds[0][0] == N_DOCS, builds
    lib = hnsw.library_path()
    assert native.parent not in lib.parents, lib
    assert (native.stat().st_mtime_ns if native.exists() else None) == state
    index = index_mod.DenseIndex.load(f"{tmp}/e2/index.npz", device=dev)
    per_batch = N_HNSW_Q // B
    recall = []
    for v, res in zip(vectors[0:2 * per_batch:2], results[:per_batch]):
        q = torch.from_numpy(v).to(dev)
        _, exact = mips.mips_topk(index.vectors, q, B4,
                                  doc_scales=index.scales)
        exact = exact.cpu().numpy()
        recall += [len(set(a) & set(b)) / B4
                   for a, b in zip(res["hop1_cand_ids"], exact)]
    recall = float(np.mean(recall))
    qps = [x for x in lines.lines if "q/s" in x]
    omp = hnsw.openmp_info()
    say(f"  leg i HNSW tier: graph of {N_DOCS} rows (M {HNSW_M}, "
        f"ef_construction {HNSW_EF_C}) built at {N_DOCS / builds[0][1]:.1f} "
        f"rows/s ({builds[0][1]:.2f} s, OpenMP {omp[0]}, {omp[1]} threads); "
        f"CLI building: \"{qps[0]}\"; CLI loading: \"{qps[1]}\"; hop-1 "
        f"recall@{B4} vs kernel 1's exact scan {recall:.4f} over "
        f"{N_HNSW_Q} questions; library {lib.relative_to(lib.parents[3])} "
        f"[{smi}]")
    assert recall >= 0.85, f"HNSW hop-1 recall@{B4} {recall} < 0.85"
    return {}


# ---- leg l: single-hop bulk retrieval ------------------------------------------


def bulk_questions(rng, first_doc):
    """N_BULK_Q questions of 4-40 words (each fits --max-q-len 50 under the
    hash tokenizer, a trailing "?" the CLI strips); question i's gold
    answer and SP title are document first_doc + i's title, "doc <id>"
    (a bare-string answer for every third question)."""
    rows = []
    for i in range(N_BULK_Q):
        title = f"doc {first_doc + i}"
        words = " ".join(f"l{w}" for w in rng.randint(
            10 ** 6, size=rng.randint(4, 41)))
        rows.append({"question": words + "?", "sp": [title],
                     "answer": title if i % 3 == 0 else [title]})
    return rows


def plant_questions(index_dir, ckpt, rows, first_doc, dev):
    """Encode the questions as cli/eval_retrieval does (hash tokenizer,
    "?" stripped, --max-q-len 50, batches of 256) with the retriever at
    ``ckpt``, and write twice each question's vector over document
    first_doc + i of ``index_dir`` with DenseIndex.replace (the stored row,
    its int8 scale, PCA projection and bounds follow), then save the index
    back.  At twice its norm the planted row is its question's exact top-1
    whatever the norms of the other rows (e2's are the same encoder's
    passage vectors)."""
    from multihop_dense_retrieval_tpu_torch.cli import common
    from multihop_dense_retrieval_tpu_torch.index import DenseIndex

    tok = common.resolve_tokenizer("hash")
    model = common.init_retriever(common.resolve_encoder_config(
        "roberta-base"), checkpoint=ckpt, device=dev)
    qs = [r["question"][:-1] for r in rows]
    vecs = []
    with torch.inference_mode():
        for s in range(0, len(qs), BULK_BATCH):
            enc = tok.encode_batch_one(qs[s:s + BULK_BATCH], BULK_Q_LEN)
            vecs.append(model.encode_seq(
                torch.from_numpy(enc["input_ids"]).to(dev),
                torch.from_numpy(enc["attention_mask"]).to(dev)
            ).float().cpu().numpy())
    vecs = 2 * np.concatenate(vecs)
    index = DenseIndex.load(f"{index_dir}/index.npz", device=dev)
    for i, v in enumerate(vecs):
        index = index.replace(first_doc + i, v[None])
    index.save(f"{index_dir}/index.npz")
    with open(f"{index_dir}/bulk_qas.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    del model, index


def run_retrieval_cli(cli, argv, mips):
    """cli/eval_retrieval.main(argv) with its own launch counts; every call
    of the MIPS functions the CLI module imported (mips_topk,
    mips_topk_pca) is recorded as (name, args, kwargs, result).  Returns
    (metrics, counts, calls, the CLI's q/s log line)."""
    names = ("mips_topk", "mips_topk_pca")
    orig = {n: getattr(cli, n) for n in names}
    calls = []

    def recorded(name):
        def call(*a, **kw):
            res = orig[name](*a, **kw)
            calls.append((name, a, kw, res))
            return res
        return call

    lines = _Lines()
    logger = logging.getLogger("mdr_torch")
    logger.addHandler(lines)
    for n in names:
        setattr(cli, n, recorded(n))
    torch.cuda.synchronize()
    mips.reset_launch_counts()
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            out = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        for n in names:
            setattr(cli, n, orig[n])
        logger.removeHandler(lines)
    counts = leg_counts(mips)
    line = json.loads(printed.getvalue().strip().splitlines()[-1])
    assert line == out, (line, out)
    return out, counts, calls, [x for x in lines.lines if "q/s" in x][-1]


def hold_int8_to_exact_scan(q, vals, docs, vecs, dsc, n_valid, mips,
                            rescan_order, rows=None):
    """One int8 search against the exact scan on its own fp32 query
    vectors, in the search's epilogue order (as leg d does): the rescans
    of the two-phase and PCA searches scale (raw * d_scale) * q_scale,
    kernel 1 (raw * q_scale) * d_scale.  Values bit-equal, ids equal apart
    from exact ties.  `rows` limits the check to those queries.  Returns
    the queries held."""
    qi, qs = mips.quantize_rows(q)
    qf = qi.float()

    def epilogue(raw, d):
        return raw * d * qs[:, None] if rescan_order else \
            raw * qs[:, None] * d

    ev, ei = mips._scan_topk_plain(
        lambda s, e: epilogue(qf @ vecs[s:e].float().t(), dsc[s:e][None, :]),
        vecs.shape[0], q.shape[0], vals.shape[1], n_valid, vecs.device)
    own = epilogue((qf[:, None, :] * vecs[docs.long()].float()).sum(-1),
                   dsc[docs.long()])
    if rows is not None:
        vals, docs, ev, ei, own = (t[rows] for t in (vals, docs, ev, ei, own))
    assert torch.equal(vals, ev), "int8 values differ from the exact scan"
    assert bool(((docs == ei) | (own == ev)).all()), \
        "int8 ids differ from the exact scan beyond exact ties"
    return int(vals.shape[0])


def hold_bulk_calls(calls, mips):
    """Every recorded MIPS call of a run held to the plain exact scan on its
    own query vectors (a --pca call: its certified queries).  Returns
    (queries held, certified, PCA queries)."""
    held = cert_n = pca_n = 0
    for name, a, kw, res in calls:
        if name == "mips_topk":
            vecs, q, k = a[:3]
            vals, docs = res
            cert = None
            two_phase = mips.two_phase_chunk(*vecs.shape, q.shape[0], 1, k,
                                             kw["chunk_rows"])
        else:
            vecs, q = a[0], a[4]
            vals, docs, cert = res
            cert_n += int(cert.sum())
            pca_n += cert.numel()
            two_phase = True
        assert bool(torch.isfinite(vals).all())
        dsc, n_valid = kw["doc_scales"], kw["n_valid"]
        if dsc is not None:
            held += hold_int8_to_exact_scan(q, vals, docs, vecs, dsc,
                                            n_valid, mips, bool(two_phase),
                                            cert)
        else:
            held += hold_to_exact_scan(q, vals, docs, vecs, mips, cert)[0]
    return held, cert_n, pca_n


def time_top100_kernels(mips, dev, gen, smi):
    """Kernels 4-7 at leg l's k = 100 shapes, on random rows (N(0,1) bf16,
    full-range int8) of its directories' sizes, each against its twin:
    l2 (B = 256 over 32,768 int8 rows, 16 chunks of 2048, every query on
    every chunk) kernels 7 and 4; l1 (B = 256 over 262,144 bf16 rows, 128
    chunks of 2048, kc = 100) kernels 6 and 5."""
    recs = {}
    n8, nb = L_K100_ROWS, N_F
    # the chunk mips_topk takes at these shapes (2048 rows for both)
    c8 = mips.two_phase_chunk(n8, BULK_BATCH, D, 1, BULK_K)
    cb = mips.two_phase_chunk(nb, BULK_BATCH, D, 2, BULK_K)
    idx8 = torch.randint(-127, 128, (n8, D), device=dev, generator=gen,
                         dtype=torch.int8)
    dsc = torch.rand(n8, device=dev, generator=gen) * 0.02 + 1e-3
    q8, _ = mips.quantize_rows(torch.randn(BULK_BATCH, D, device=dev,
                                           generator=gen))
    recs["chunk_max_int8"] = check_chunk_max(mips, q8, idx8, dsc, c8,
                                             n8 - 300, "leg l2, k=100")
    recs["pca_rescan_int8"] = check_rescan(mips, q8, idx8, dsc, c8,
                                           n8 // c8, n8 - 300, gen)
    del idx8, dsc
    idxb = torch.randn(nb, D, device=dev, generator=gen).to(torch.bfloat16)
    qb = torch.randn(BULK_BATCH, D, device=dev, generator=gen
                     ).to(torch.bfloat16)
    recs["chunk_max"] = check_chunk_max(mips, qb, idxb, None, cb, nb - 1000,
                                        "leg l1, k=100")
    recs["rescan"] = check_rescan(mips, qb, idxb, None, cb, BULK_K,
                                  nb - 1000, gen)
    say("leg l kernels at k=100: " + json.dumps(
        {k: {"ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
             "library_ms": r["library_ms"], "max_abs_err": r["err"]}
         for k, r in recs.items()}) + f" [{smi}]")


# kernel -> a substring of its CUDA kernels' names in a profiler trace
TRACE_NAMES = {"mips_scan_int8": "mips_scan_i8_kernel",
               "mips_scan": "mips_scan_mma_kernel",
               "pca_chunk_max": "chunk_max_", "chunk_max": "chunk_max_",
               "chunk_max_int8": "chunk_max_i8_kernel",
               "pca_rescan_int8": "rescan_mma_kernel",
               "rescan": "rescan_mma_kernel",
               "bias_gelu": "bias_gelu_kernel",
               "masked_softmax": "masked_softmax_kernel",
               "add_layer_norm": "add_layer_norm_kernel"}


def run_prep_and_reranked(tmp, smi):
    """Leg l's host-only CLIs.  cli/eval_reranked over leg g2's
    predictions (cli/end2end --save-path) and its questions: every question
    scored, finite metrics.  cli/prep's three subcommands on a synthetic
    raw HotpotQA file of 8 questions, a chain dump of those questions (in
    another order) and e2's id2doc.json."""
    from multihop_dense_retrieval_tpu_torch.cli import eval_reranked, prep

    with contextlib.redirect_stdout(io.StringIO()):
        res = eval_reranked.main([f"{tmp}/g2_preds.jsonl", f"{tmp}/qas.jsonl"])
    assert res["all"]["n"] == N_ANSWERS, res
    assert all(np.isfinite(v) for d in res.values() for v in d.values())
    say(f"  l cli/eval_reranked over g2's {N_ANSWERS} predictions: "
        f"{json.dumps(res['overall'])}")
    raw, retrieved = [], []
    for i in range(8):
        t = [f"P{i}a", f"P{i}b", f"P{i}c"]
        raw.append({"_id": f"r{i}", "question": f"which {i}?",
                    "answer": f"ans{i}", "type": ["bridge", "comparison"][i % 2],
                    "context": [[t[0], [f"ans{i} here.", "more."]],
                                [t[1], ["second hop."]], [t[2], ["noise."]]],
                    "supporting_facts": [[t[0], 0], [t[1], 0]]})
        retrieved.append({"question": f"which {i}?", "candidate_chains": [
            [{"title": t[0], "text": ""}, {"title": t[2], "text": ""}]]})
    with open(f"{tmp}/raw_hotpot.json", "w") as f:
        json.dump(raw, f)
    with open(f"{tmp}/chains.jsonl", "w") as f:
        for r in retrieved[::-1]:
            f.write(json.dumps(r) + "\n")
    with contextlib.redirect_stdout(io.StringIO()):
        prep.main(["add-sp-label", f"{tmp}/raw_hotpot.json",
                   f"{tmp}/chains.jsonl", f"{tmp}/with_sp.jsonl"])
        prep.main(["hotpot-to-mhop", f"{tmp}/raw_hotpot.json",
                   f"{tmp}/mhop.jsonl"])
        prep.main(["index-id-map", f"{tmp}/e2/id2doc.json",
                   f"{tmp}/idmap.json"])
    with_sp = [json.loads(l) for l in open(f"{tmp}/with_sp.jsonl")]
    mhop = [json.loads(l) for l in open(f"{tmp}/mhop.jsonl")]
    assert [r["question"] for r in with_sp] == \
        [r["question"] for r in retrieved[::-1]]
    assert all(len(r["sp"]) == 2 and r["sp"][0]["sp_sent_ids"] == [0]
               for r in with_sp)
    assert len(mhop) == 8 and all(r["bridge"] == r["sp"][0] for r in
                                  mhop if r["type"] == "bridge")
    with open(f"{tmp}/idmap.json") as f:
        assert len(json.load(f)) == N_DOCS
    say(f"  l cli/prep: add-sp-label {len(with_sp)} rows, hotpot-to-mhop "
        f"{len(mhop)} rows, index-id-map {N_DOCS} ids")


def run_bulk_retrieval(mips, dev, gen, smi, ftmp, tmp):
    """Leg (l): cli/eval_retrieval.main, the single-hop bulk entry point, at
    roberta-base width with the legs' seeded weights, over N_BULK_Q
    questions at the CLI's defaults (batch 256, top 100, max_q_len 50).
    The questions' own vectors (twice over) are planted over N_BULK_Q
    documents of each directory (plant_questions), whose titles are their
    gold answers and SP titles, so recall@k must be 1.0 at every k.
    l1: leg c's directory (262,144 bf16 rows, PCA R=128) in ``ftmp``,
    exact (kernels 6 + 5: 128 chunks of 2048 rows, kc = 100) and --pca
    (kernels 3 + 5).  l2: leg e2's directory (8,192 int8 rows, PCA) in
    ``tmp``, exact (kernels 7 + 4: 4 chunks of 2048, every query on every
    chunk) and --pca (kernels 3 + 4).  l3: --topk 5 over both (kernels 2
    and 1).  Each run has its own launch counts and every kernel its
    tensor-core template; every MIPS call is held to the plain exact scan
    (int8: ids bit-equal; bf16: hold_to_exact_scan's rtol 1e-5), a --pca
    call's certified queries included.  l2's exact run is repeated inside
    utils/profiling.device_trace, whose trace must name the kernels it
    launched.  Then kernels 4-7 at these k = 100 shapes
    (time_top100_kernels), cli/eval_reranked and cli/prep
    (run_prep_and_reranked)."""
    from multihop_dense_retrieval_tpu_torch.cli import eval_retrieval as cli
    from multihop_dense_retrieval_tpu_torch.utils import profiling

    out = {}
    t0 = time.perf_counter()
    rng = np.random.RandomState(31)
    # (directory, first planted document, the retriever it was encoded by)
    dirs = {"l1": (ftmp, N_F // 8, f"{ftmp}/model.pt"),
            "l2": (f"{tmp}/e2", N_DOCS // 2, f"{tmp}/model.pt")}
    for d, first, ckpt in dirs.values():
        plant_questions(d, ckpt, bulk_questions(rng, first), first, dev)
    say(f"  leg l set-up: {N_BULK_Q} questions planted in each directory in "
        f"{time.perf_counter() - t0:.1f} s")
    runs = (("bulk_l1_exact", "l1", [], ("chunk_max", "rescan")),
            ("bulk_l1_pca", "l1", ["--pca"], ("pca_chunk_max", "rescan")),
            ("bulk_l2_exact", "l2", [], ("chunk_max_int8", "pca_rescan_int8")),
            ("bulk_l2_pca", "l2", ["--pca"],
             ("pca_chunk_max", "pca_rescan_int8")),
            ("bulk_l3_bf16", "l1", ["--topk", "5"], ("mips_scan",)),
            ("bulk_l3_int8", "l2", ["--topk", "5"], ("mips_scan_int8",)))
    for name, leg, extra, want in runs:
        d, _, ckpt = dirs[leg]
        argv = [f"{d}/bulk_qas.jsonl", d, "--tokenizer", "hash",
                "--model-name", "roberta-base", "--checkpoint", ckpt,
                "--save-path", f"{d}/{name}.jsonl"] + extra
        t1 = time.perf_counter()
        res, counts, calls, qps = run_retrieval_cli(cli, argv, mips)
        secs = time.perf_counter() - t1
        out[name] = counts
        k = BULK_K if "--topk" not in extra else 5
        ks = [x for x in (1, 5, 10, 20, 50, 100) if x <= k]
        for x in ks:
            assert res[f"answer_recall@{x}"] == res[f"sp_recall@{x}"] == 1.0, \
                (name, res)
        dump = [json.loads(l) for l in open(f"{d}/{name}.jsonl")]
        assert len(dump) == N_BULK_Q and all(
            len(r["retrieved"]) == k for r in dump)
        assert len(calls) == N_BULK_Q // BULK_BATCH and all(
            c[1][1 if c[0] == "mips_topk" else 4].shape[0] == BULK_BATCH
            for c in calls), len(calls)
        held, cert, n_pca = hold_bulk_calls(calls, mips)
        missing = [n for n in want if counts[n] == 0]
        assert not missing, f"kernels not launched on {name}: {missing}"
        others = [n for n in search_kernels(mips)
                  if n not in want and counts[n]]
        assert not others, f"other kernels ran on {name}: {others}"
        note = ""
        if n_pca:
            note = (f"; certified {cert} of {n_pca} ({cert / n_pca:.4f}), "
                    f"each = the exact top {k}")
        say(f"  {name} ({' '.join(extra) or 'exact'}, top {k}): "
            f"{res['qps']:.1f} q/s (the CLI's qps; \"{qps}\"; {secs:.2f} s "
            f"with set-up); recall@{ks} 1.0; {held} queries held to the "
            f"exact scan{note} [{smi}]")
        say(f"  {name} launches: {json.dumps(counts)}")
        del calls

    # one run again inside the port's device_trace
    d, _, ckpt = dirs["l2"]
    log_dir = f"{tmp}/l_trace"
    with profiling.device_trace(log_dir):
        _, counts, calls, _ = run_retrieval_cli(cli, [
            f"{d}/bulk_qas.jsonl", d, "--tokenizer", "hash", "--model-name",
            "roberta-base", "--checkpoint", ckpt], mips)
    del calls
    traces = list(Path(log_dir).glob("*.pt.trace.json"))
    assert len(traces) == 1, traces
    with open(traces[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    launched = [n for n in mips.LAUNCHES if counts[n]]
    absent = [n for n in launched
              if not any(TRACE_NAMES[n] in x for x in names)]
    assert launched and not absent, f"trace lacks kernels {absent}"
    say(f"  l2 under utils/profiling.device_trace: {traces[0].name} "
        f"({traces[0].stat().st_size} bytes) names the launched kernels "
        f"{launched}: " + ", ".join(sorted(
            {x.split('<')[0].split('(')[0].replace('void ', '')
             for x in names if any(v in x for v in TRACE_NAMES.values())})))
    time_top100_kernels(mips, dev, gen, smi)
    run_prep_and_reranked(tmp, smi)
    say(f"  leg l: {time.perf_counter() - t0:.1f} s")
    return out


# ---- leg m: the port's quickstart ----------------------------------------------


def run_quickstart(mips, dev, smi):
    """Leg (m): examples/quickstart_torch.main(["--workdir", tmp]) on the
    card (its default device): the seven steps at the tiny preset.  It must
    answer all 8 questions, and the exported .pt must strict-load into the
    tiny retriever through cli/common.init_retriever."""
    import importlib.util

    from multihop_dense_retrieval_tpu_torch.cli import common

    path = Path(__file__).resolve().parent / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        mips.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            summary = mod.main(["--workdir", tmp])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = leg_counts(mips)
        assert summary["end2end_n"] == 8, summary
        assert summary["answer_em"] is not None
        assert np.isfinite(summary["momentum_final_loss"])
        model = common.init_retriever(common.resolve_encoder_config("tiny"),
                                      checkpoint=summary["exported_pt"],
                                      device=dev)
        assert next(model.parameters()).device.type == dev.type
    say(f"  leg m examples/quickstart_torch.py: {secs:.1f} s for the seven "
        f"steps; end2end_n {summary['end2end_n']}, answer_em "
        f"{summary['answer_em']}, momentum_final_loss "
        f"{summary['momentum_final_loss']:.4f}; the exported .pt loads back "
        f"[{smi}]")
    say(f"  leg m launches: {json.dumps(counts)}")
    return {"quickstart": counts}


# ---- leg j: retriever training ------------------------------------------------


def train_batch(rng, b, full=True):
    """A training batch at the reference widths (q 70, q_sp 350, c 300):
    random ids in [5, VOCAB - 5), full masks as bench.py::_train_bench
    makes them, or ragged lengths (at least 8 tokens, padded with 1)."""
    out = {}
    for name, width in J_WIDTHS:
        lens = (np.full(b, width) if full
                else rng.randint(8, width + 1, size=b))
        mask = (np.arange(width)[None] < lens[:, None]).astype(np.int32)
        ids = rng.randint(5, VOCAB - 5, size=(b, width))
        out[f"{name}_input_ids"] = np.where(mask > 0, ids, 1).astype(np.int32)
        out[f"{name}_mask"] = mask
    return out


def adam_bound(g, delta, p, lr, eps, tight=1e-3, steps=1):
    """|Δparam| / lr allowed between two Adam runs of ``steps`` steps from
    the same parameters ``p``, whose first clipped gradients ``g`` agree
    to ``delta``: the first update g / (|g| + eps) moves by
    2·eps·δ / (|g| + eps)², capped at 2.5 a step (a sign flip), plus
    ``tight``, plus two fp32 ulps of ``p`` (the sum p + Δ rounds there:
    0.012 lr for an N(0, 1) embedding at lr 2e-5).  numpy arrays or torch
    tensors; the CPU parity tests and the card test hold the port to it
    too."""
    ulp = float(np.finfo(np.float32).eps) * abs(p) / lr
    return (tight + 2 * eps * delta / (abs(g) + eps) ** 2).clip(
        max=2.5 * steps) + 2 * ulp


def joined_grads(model):
    """The gradients of ``model``'s parameters on the CPU, under their
    unsharded names: a tensor-parallel linear's blocks joined (across
    processes gathered over the index group: every process of it calls
    this)."""
    from multihop_dense_retrieval_tpu_torch.parallel.sharding import \
        ShardedLinear

    from multihop_dense_retrieval_tpu_torch.core.mesh import all_gather

    out = {n: p.grad.detach().cpu().clone()
           for n, p in model.named_parameters() if p.grad is not None}
    for name, mod in model.named_modules():
        if not isinstance(mod, ShardedLinear):
            continue
        for what, blocks, dim in (("weight", mod.weight, mod.dim),
                                  ("bias", mod.bias, 0)):
            if isinstance(blocks, torch.nn.ParameterList):
                joined = torch.cat([out.pop(f"{name}.{what}.{s}") for s in
                                    range(len(blocks))], dim)
                # across processes: the other blocks are the index group's
                out[f"{name}.{what}"] = joined if mod.group is None else \
                    all_gather(joined, dim, mod.group)
    return out


def run_step(T, base, make_step, batch, tcfg, dev, prepare=None,
             state_of=None):
    """One train step of a copy of ``base`` on ``dev`` (``prepare(model)``
    first, e.g. a tensor-parallel layout; ``state_of(model, tx)`` makes
    the state, default a TrainState): (loss, the gradients the update
    consumed, the parameters in the reference layout, both on the CPU,
    seconds, the state)."""
    import copy

    model = copy.deepcopy(base).to(dev)
    if prepare is not None:
        prepare(model)
    state = (state_of or T.TrainState.create)(model,
                                              T.make_optimizer(tcfg, 10))
    grads = {}
    update = state.opt.update

    def kept():
        grads.update(joined_grads(state.model))
        return update()

    state.opt.update = kept
    t = time.perf_counter()
    state, loss = make_step()(state, T.to_device(batch, dev))
    loss = float(loss)
    return (loss, grads, {k: v.cpu() for k, v in
                          T.reference_state_dict(state.model).items()},
            time.perf_counter() - t, state)


def hold_step(T, ref, got, tcfg):
    """``got``'s step (``run_step``'s result) held to ``ref``'s: the loss
    within 1e-5 relative, the gradients within 1e-6 + 1e-4 of each
    tensor's largest, the parameters within ``adam_bound`` in units of
    lr.  Returns the readings."""
    (lc, gc, pc, tc, _), (lg, gg, pg, tg, _) = ref, got
    assert abs(lg - lc) <= 1e-5 * abs(lc), (lg, lc)
    lr, n_loose = tcfg.learning_rate, 0
    # the worst share of each tolerance used, with its tensor
    worst_g, worst_p = (0.0, ""), (0.0, "")
    # Adam steps on the clipped gradients: its sensitivity is theirs
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in gc.values()))
    clip = min(1.0, tcfg.max_grad_norm / norm.item())
    assert set(gg) == set(gc) and set(pg) == set(pc)
    for name, g in gc.items():
        tol = 1e-6 + 1e-4 * g.abs().max().item()
        err = (gg[name] - g).abs().max().item()
        assert err <= tol, (name, err, tol)
        worst_g = max(worst_g, (err / tol, name))
        diff = (pg[name] - pc[name]).abs() / lr
        bound = adam_bound(g * clip, tol * clip, pc[name], lr,
                           tcfg.adam_eps)
        assert (diff <= bound).all(), (name, (diff - bound).max().item())
        worst_p = max(worst_p, ((diff / bound).max().item(), name))
        n_loose += int((diff > 1e-3).sum())
    return {"loss": (lg, lc), "norm": norm.item(), "clip": clip,
            "worst_g": worst_g, "worst_p": worst_p, "n_loose": n_loose,
            "n": sum(v.numel() for v in pc.values()), "secs": (tc, tg)}


def card_vs_cpu_step(T, base, make_step, batch, tcfg, dev):
    """One train step of ``base``'s architecture and weights on the CPU and
    one on the card (``make_step()`` over a TrainState of each, the same
    numpy ``batch``), as ``hold_step`` holds them.  Returns the
    readings."""
    return hold_step(T, run_step(T, base, make_step, batch, tcfg,
                                 torch.device("cpu")),
                     run_step(T, base, make_step, batch, tcfg, dev), tcfg)


def check_train_step_on_card(T, models, cfgmod, dev, smi):
    """j0: one train step on the card and one on the CPU from the same
    weights and batch (2 layers at roberta-base width, fp32 compute, TF32
    off), as ``card_vs_cpu_step`` holds them."""
    torch.manual_seed(0)
    base = models.MhopRetriever(
        cfgmod.EncoderConfig.roberta_base(num_layers=2, dtype="float32"),
        cls_only=True, fp32_params=True)
    r = card_vs_cpu_step(T, base, T.make_train_step,
                         train_batch(np.random.RandomState(31), 4, full=False),
                         cfgmod.RetrieverTrainConfig(warmup_ratio=0.0), dev)
    c = base.config
    widths = "/".join(str(w) for _, w in J_WIDTHS)
    say(f"  leg j0 card vs CPU train step ({c.num_layers} x {c.hidden_size}, "
        f"B=4 ragged at {widths}, fp32): loss {r['loss'][0]:.6f} vs "
        f"{r['loss'][1]:.6f}; gradient norm {r['norm']:.4g} (clip "
        f"x{r['clip']:.4g}); worst gradient error {r['worst_g'][0]:.3f} of "
        f"its tolerance ({r['worst_g'][1]}); worst parameter "
        f"{r['worst_p'][0]:.3f} of its Adam bound ({r['worst_p'][1]}); "
        f"{r['n_loose']} of {r['n']} elements beyond 1e-3 lr; CPU "
        f"{r['secs'][0]:.2f} s, card {r['secs'][1]:.2f} s (first call) "
        f"[{smi}]")


def time_train_steps(T, models, cfgmod, dev, smi, what, b, remat):
    """j1 / j2: roberta-base (12 x 768, bf16 compute, fp32 master weights
    and Adam), B rows at the reference widths, Adam with the clip and the
    warmup of RetrieverTrainConfig's defaults; CUDA events around each
    step, the median of J_ITERS after J_WARM."""
    torch.manual_seed(11)
    model = models.MhopRetriever(cfgmod.EncoderConfig.roberta_base(),
                                 cls_only=True, fp32_params=True,
                                 remat=remat).to(dev)
    state = T.TrainState.create(model, T.make_optimizer(
        cfgmod.RetrieverTrainConfig(batch_size=b), 1000))
    batch = T.to_device(train_batch(np.random.RandomState(11), b), dev)
    step = T.make_train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seen, events = [], []
    for i in range(J_WARM + J_ITERS):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        state, loss = step(state, batch)
        ev[1].record()
        seen.append(loss)
        if i >= J_WARM:
            events.append(ev)
    torch.cuda.synchronize()
    ms = np.array([a.elapsed_time(e) for a, e in events])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _, _, kernels = device_kernels(lambda: step(state, batch))
    losses = torch.stack(seen).float().cpu().numpy()
    assert np.isfinite(losses).all(), f"{what}: non-finite losses {losses}"
    med = float(np.median(ms))
    busy = sum(t for t, _ in kernels)
    gemm = sum(t for t, k in kernels if any(
        m in k.lower() for m in ("gemm", "xmma", "cutlass", "nvjet")))
    say(f"  leg {what} train step (roberta-base, bf16 compute, fp32 master "
        f"weights, B={b}, remat={int(remat)}): {b / med * 1e3:.1f} "
        f"examples/s, median {med:.2f} ms/step (min {ms.min():.2f}, max "
        f"{ms.max():.2f}) over {J_ITERS} steps after {J_WARM}; peak "
        f"allocated {peak:.2f} GiB; losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; one profiled step: device busy {busy:.2f} ms "
        f"(matmuls {gemm:.2f}), idle share {idle_share(busy, med):.3f}, "
        f"top kernels {[(round(t, 2), k[:48]) for t, k in kernels[:4]]} "
        f"[{smi}]")
    return {"examples_per_s": b / med * 1e3, "ms": med, "peak_gib": peak}


def write_train_rows(path, rng, n):
    """n multi-hop rows in data/mhop_dataset.py's format: a 6-20 word
    question, bridge or comparison, two positives and four negatives, each
    passage a two-word title and synth_doc_lens words (20-300)."""
    vocab = np.array([f"w{i}" for i in range(1 << 16)])

    def para():
        words = vocab[rng.randint(len(vocab), size=synth_doc_lens(rng, 1)[0])]
        return {"title": f"doc {rng.randint(1 << 30)}",
                "text": " ".join(words)}

    with open(path, "w") as f:
        for i in range(n):
            pos = [para(), para()]
            q = " ".join(vocab[rng.randint(len(vocab),
                                           size=rng.randint(6, 21))])
            f.write(json.dumps({
                "_id": f"q{i}", "question": q + "?",
                "type": "bridge" if i % 2 else "comparison",
                "pos_paras": pos, "neg_paras": [para() for _ in range(4)],
                "bridge": pos[1]["title"]}) + "\n")


def run_training_clis(cfgmod, dev, smi, tmp):
    """j3: cli/train_retriever for one epoch of J_ROWS rows at roberta-base
    (batch J_B, the reference widths, the defaults' lr, warmup and clip),
    then cli/train_momentum from its checkpoint_best.pt with the reference
    queue of J_QUEUE x 768 for one epoch of J_MOM_ROWS rows; the momentum
    checkpoint, loaded through cli/common.init_retriever (bf16 serving
    weights), must give the trainer's final encoder_q's vectors bit for
    bit."""
    from multihop_dense_retrieval_tpu_torch.cli import (common,
                                                        train_momentum,
                                                        train_retriever)

    rng = np.random.RandomState(41)
    for name, n in (("train", J_ROWS), ("dev", J_DEV_ROWS),
                    ("momentum", J_MOM_ROWS)):
        write_train_rows(f"{tmp}/{name}.jsonl", rng, n)
    common_args = ["--tokenizer", "hash", "--model-name", "roberta-base",
                   "--train-batch-size", str(J_B),
                   "--predict-batch-size", str(J_DEV_ROWS),
                   "--num-epochs", "1", "--predict-file", f"{tmp}/dev.jsonl"]
    lines = _Lines()
    logger = logging.getLogger("mdr_torch")
    logger.addHandler(lines)
    secs = []
    try:
        t = time.perf_counter()
        res1, stage1 = train_retriever.main(common_args + [
            "--train-file", f"{tmp}/train.jsonl", "--output-dir",
            f"{tmp}/stage1"])
        secs.append(time.perf_counter() - t)
        t = time.perf_counter()
        res2, stage2 = train_momentum.main(common_args + [
            "--train-file", f"{tmp}/momentum.jsonl", "--output-dir",
            f"{tmp}/stage2", "--init-checkpoint",
            f"{tmp}/stage1/checkpoint_best.pt", "--queue-size",
            str(J_QUEUE)])
        secs.append(time.perf_counter() - t)
    finally:
        logger.removeHandler(lines)
    assert stage1.state.step == J_ROWS // J_B
    assert stage2.state.step == J_MOM_ROWS // J_B
    assert stage2.state.queue.shape == (J_QUEUE, D)
    assert stage2.state.queue_ptr == 2 * J_B * stage2.state.step
    for res in (res1, res2):
        assert np.isfinite(res["final_loss"]) and res["best_mrr"] > 0, res
    served = common.init_retriever(
        cfgmod.EncoderConfig.roberta_base(),
        checkpoint=f"{tmp}/stage2/checkpoint_last.pt", device=dev)
    assert all(p.dtype == torch.bfloat16 for n, p in
               served.encoder.named_parameters() if "dense" in n
               or n.endswith(("query.weight", "key.weight", "value.weight")))
    trained = stage2.state.model.eval()
    rows = train_batch(np.random.RandomState(43), 8, full=False)
    with torch.inference_mode():
        for view in ("q", "q_sp", "c1"):
            ids = torch.from_numpy(rows[f"{view}_input_ids"]).to(dev)
            mask = torch.from_numpy(rows[f"{view}_mask"]).to(dev)
            a = trained.encode_seq(ids, mask)
            b = served.encode_seq(ids, mask)
            assert torch.equal(a, b), \
                f"{view}: served vectors differ by {(a - b).abs().max()}"
    epochs = [x for x in lines.lines if x.startswith("epoch 0")]
    say(f"  leg j3 training CLIs (roberta-base, hash tokenizer, widths "
        f"70/350/300, batch {J_B}): train_retriever {J_ROWS} rows in "
        f"{secs[0]:.1f} s (\"{epochs[0]}\"), train_momentum from its "
        f"checkpoint_best.pt with a {J_QUEUE} x {D} queue, {J_MOM_ROWS} rows "
        f"in {secs[1]:.1f} s (\"{epochs[1]}\"); the momentum checkpoint "
        f"served by init_retriever equals the trained encoder_q bit for "
        f"bit on 3 x 8 rows [{smi}]")
    return secs


def assert_no_launches(mips, leg):
    """None of kernels 1-8 (``search_kernels``) ran on the leg; kernels
    9-11 run there wherever an encoder runs with gradients off."""
    counts = leg_counts(mips)
    launched = {k: counts[k] for k in search_kernels(mips) if counts[k]}
    assert not launched, f"kernels launched on leg {leg}: {launched}"
    say(f"  leg {leg} launches: {json.dumps(counts)}")
    return counts


def run_training(port, mips, dev, smi, tmp):
    """Leg (j): retriever training, which launches none of kernels 1-8
    (the encoder trains on attention_impl="xla"; the loss is plain
    matrix products).  The CLIs write into ``tmp``, where leg k finds the
    stage-1 checkpoint and the rows."""
    from multihop_dense_retrieval_tpu_torch.train import trainer as T

    cfgmod, models = port[0], port[3]
    torch.cuda.empty_cache()
    mips.reset_launch_counts()
    check_train_step_on_card(T, models, cfgmod, dev, smi)
    time_train_steps(T, models, cfgmod, dev, smi, "j1", J_B, remat=False)
    torch.cuda.empty_cache()
    time_train_steps(T, models, cfgmod, dev, smi, "j2", J_REMAT_B,
                     remat=True)
    torch.cuda.empty_cache()
    run_training_clis(cfgmod, dev, smi, tmp)
    return {"training": assert_no_launches(mips, "j")}


def reader_batch(rng, b, width=K_LEN, full=True, vocab=30522):
    """A reader training batch as data/qa_dataset.py collates it: [CLS]
    question [SEP] context [SEP] (segment 1 on the context), the paragraph
    mask over the context, up to K_SENTS sentence markers in it with their
    labels, up to K_SLOTS answer slots (-1 padded; the last row covers no
    answer), gold and negative chains; rows of ``width`` tokens (``full``)
    or of ragged lengths from width / 4."""
    lens = (np.full(b, width) if full
            else rng.randint(width // 4, width + 1, size=b))
    out = {k: np.zeros((b, width), np.int32) for k in (
        "input_ids", "attention_mask", "token_type_ids", "paragraph_mask")}
    for k in ("sent_offsets", "sent_mask", "sent_labels"):
        out[k] = np.zeros((b, K_SENTS), np.int32)
    out["starts"] = np.full((b, K_SLOTS), -1, np.int32)
    out["ends"] = np.full((b, K_SLOTS), -1, np.int32)
    out["label"] = (np.arange(b) % 2 == 0).astype(np.int32)
    for i, n in enumerate(lens):
        q = rng.randint(8, 64)
        out["input_ids"][i, :n] = rng.randint(5, vocab - 5, size=n)
        out["attention_mask"][i, :n] = 1
        out["token_type_ids"][i, q:n] = 1
        out["paragraph_mask"][i, q:n - 1] = 1
        ns = min(K_SENTS, (n - 1 - q) // 4)
        out["sent_offsets"][i, :ns] = np.sort(rng.choice(
            np.arange(q, n - 1), ns, replace=False))
        out["sent_mask"][i, :ns] = 1
        out["sent_labels"][i, :ns] = rng.randint(0, 2, size=ns)
        if i < b - 1:
            na = rng.randint(1, K_SLOTS + 1)
            st = rng.randint(q, n - 9, size=na)
            out["starts"][i, :na] = st
            out["ends"][i, :na] = st + rng.randint(0, 8, size=na)
    return out


def check_reader_step_on_card(T, TQA, models, cfgmod, dev, smi, layers=2,
                              b=6):
    """k0: one reader train step on the card and one on the CPU from the
    same weights and batch (``layers`` layers at ELECTRA-large width: 1024
    wide, 16 heads, 4096 intermediate; fp32, TF32 off; B=``b`` ragged up to
    K_LEN, sp on), as ``card_vs_cpu_step`` holds them.  Returns the
    readings."""
    torch.manual_seed(0)
    base = models.QAReader(
        cfgmod.EncoderConfig.electra_large(num_layers=layers,
                                           dtype="float32"),
        sp_pred=True, fp32_params=True)
    r = card_vs_cpu_step(T, base, TQA.make_qa_train_step,
                         reader_batch(np.random.RandomState(51), b,
                                      full=False),
                         cfgmod.RetrieverTrainConfig(warmup_ratio=0.0), dev)
    c = base.config
    say(f"  leg k0 card vs CPU reader train step ({c.num_layers} x "
        f"{c.hidden_size}, {c.num_heads} heads, B={b} ragged up to {K_LEN}, "
        f"sp on, fp32): loss {r['loss'][0]:.6f} vs {r['loss'][1]:.6f}; "
        f"gradient norm {r['norm']:.4g} (clip x{r['clip']:.4g}); worst "
        f"gradient error {r['worst_g'][0]:.3f} of its tolerance "
        f"({r['worst_g'][1]}); worst parameter {r['worst_p'][0]:.3f} of its "
        f"Adam bound ({r['worst_p'][1]}); {r['n_loose']} of {r['n']} "
        f"elements beyond 1e-3 lr; CPU {r['secs'][0]:.2f} s, card "
        f"{r['secs'][1]:.2f} s (first call) [{smi}]")
    return r


def reader_step_bound_ms(c, b, width):
    """The least time of one reader train step on the card: 6 FLOPs per
    non-embedding parameter per token (forward and backward) plus the
    attention products (4·B·L²·H forward, three times that with the
    backward) at the bf16 dense peak; the step's bytes move far faster."""
    h, f = c.hidden_size, c.intermediate_size
    per_layer = 4 * h * h + 2 * h * f + 9 * h
    ops = (6 * c.num_layers * per_layer * b * width
           + 12 * c.num_layers * b * width * width * h)
    return ops / PEAK_OPS["bf16"] * 1e3, ops


def time_reader_steps(T, TQA, models, cfgmod, dev, smi, what, remat):
    """k1: the ELECTRA-large reader (24 x 1024, bf16 compute, fp32 master
    weights and Adam) at the JAX CLI's defaults (batch K_B, K_LEN tokens,
    K_SLOTS answer slots, K_SENTS sentences, sp on, lr 5e-5 with warmup
    0.1); CUDA events around each step, the median of K_ITERS after
    K_WARM; peak allocated memory; one profiled step split into matmuls
    and the rest."""
    cfg = cfgmod.EncoderConfig.electra_large()
    torch.manual_seed(13)
    with dev:
        model = models.QAReader(cfg, sp_pred=True, fp32_params=True,
                                remat=remat)
    n_params = sum(p.numel() for p in model.parameters())
    state = T.TrainState.create(model, T.make_optimizer(
        cfgmod.RetrieverTrainConfig(learning_rate=5e-5, warmup_ratio=0.1),
        1000))
    batch = T.to_device(reader_batch(np.random.RandomState(13), K_B), dev)
    step = TQA.make_qa_train_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seen, events = [], []
    for i in range(K_WARM + K_ITERS):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        state, loss = step(state, batch)
        ev[1].record()
        seen.append(loss)
        if i >= K_WARM:
            events.append(ev)
    torch.cuda.synchronize()
    ms = np.array([a.elapsed_time(e) for a, e in events])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _, _, kernels = device_kernels(lambda: step(state, batch))
    losses = torch.stack(seen).float().cpu().numpy()
    assert np.isfinite(losses).all(), f"{what}: non-finite losses {losses}"
    med = float(np.median(ms))
    busy = sum(t for t, _ in kernels)
    gemm = sum(t for t, k in kernels if any(
        m in k.lower() for m in ("gemm", "xmma", "cutlass", "nvjet")))
    bound, ops = reader_step_bound_ms(cfg, K_B, K_LEN)
    say(f"  leg {what} reader train step (electra-large {cfg.num_layers} x "
        f"{cfg.hidden_size}, {n_params / 1e6:.1f}M parameters, bf16 compute, "
        f"fp32 master weights and Adam, B={K_B} x {K_LEN}, {K_SLOTS} answer "
        f"slots, {K_SENTS} sentences, sp on, remat={int(remat)}): "
        f"{K_B / med * 1e3:.2f} examples/s, median {med:.2f} ms/step (min "
        f"{ms.min():.2f}, max {ms.max():.2f}) over {K_ITERS} steps after "
        f"{K_WARM}; FLOP bound {bound:.2f} ms ({ops / 1e12:.2f} TFLOP at the "
        f"bf16 peak; {bound / med:.3f} of it reached); peak allocated "
        f"{peak:.2f} GiB; losses {losses[0]:.4f} -> {losses[-1]:.4f}; one "
        f"profiled step: device busy {busy:.2f} ms (matmuls {gemm:.2f}, the "
        f"rest {busy - gemm:.2f}), idle share {idle_share(busy, med):.3f}, "
        f"top kernels {[(round(t, 2), k[:48]) for t, k in kernels[:4]]} "
        f"[{smi}]")
    del state, model, batch
    torch.cuda.empty_cache()
    return {"ms": med, "examples_per_s": K_B / med * 1e3, "peak_gib": peak,
            "busy_ms": busy, "matmul_ms": gemm}


def write_qa_rows(path, rng, n):
    """n reader training rows in data/qa_dataset.py's format, made as
    tests/test_e2e.py::_qa_rows makes them but with varied text: a gold
    chain of two passages (the answer word in the first passage's first
    sentence, its supporting fact) and three negative chains of two
    passages, each passage 2-4 sentences of 5-15 words."""
    vocab = np.array([f"w{i}" for i in range(4096)])

    def sents(k):
        return [" ".join(vocab[rng.randint(len(vocab),
                                           size=rng.randint(5, 16))]) + " ."
                for _ in range(k)]

    with open(path, "w") as f:
        for i in range(n):
            ans = f"answer{i}"
            s0 = sents(rng.randint(2, 5))
            s0[0] = f"the thing is {ans} . {s0[0]}"
            sp = [{"title": f"G{i}a", "sents": s0, "sp_sent_ids": [0]},
                  {"title": f"G{i}b", "sents": sents(rng.randint(2, 5)),
                   "sp_sent_ids": [1]}]
            negs = [[{"title": f"N{i}{j}{k}",
                      "sents": sents(rng.randint(2, 5))} for k in "ab"]
                    for j in range(3)]
            q = " ".join(vocab[rng.randint(len(vocab),
                                           size=rng.randint(6, 16))])
            f.write(json.dumps({"question": q + "?", "_id": f"q{i}",
                                "answer": [ans], "type": "bridge", "sp": sp,
                                "candidate_chains": [sp] + negs}) + "\n")


def run_reader_cli(models, dev, smi, tmp):
    """k2: cli/train_qa for one epoch of K_QA_ROWS questions (the mini
    preset, the CLI's defaults otherwise: batch 8, max_seq_len 512, 5
    negatives, sp on) and --do-predict from its checkpoint_best.pt; the
    checkpoint served through cli/common.init_reader gives the trained
    model's rank scores bit for bit, and cli/export_ckpt --arch reader of
    it strict-loads back with the trained parameters bit for bit."""
    from multihop_dense_retrieval_tpu_torch.cli import (common, export_ckpt,
                                                        train_qa)
    from multihop_dense_retrieval_tpu_torch.data import qa_dataset

    rng = np.random.RandomState(61)
    write_qa_rows(f"{tmp}/qa_train.jsonl", rng, K_QA_ROWS)
    write_qa_rows(f"{tmp}/qa_dev.jsonl", rng, K_QA_DEV)
    base = ["--tokenizer", "hash", "--model-name", "mini",
            "--predict-file", f"{tmp}/qa_dev.jsonl"]
    t = time.perf_counter()
    res, state = train_qa.main(base + [
        "--train-file", f"{tmp}/qa_train.jsonl", "--output-dir",
        f"{tmp}/qa", "--num-epochs", "1"])
    train_s = time.perf_counter() - t
    assert state.step == K_QA_ROWS * 4 // 8, state.step
    assert res["n_questions"] == K_QA_DEV, res["n_questions"]
    best = f"{tmp}/qa/checkpoint_best.pt"
    t = time.perf_counter()
    pred, _ = train_qa.main(base + ["--do-predict", "--checkpoint", best])
    predict_s = time.perf_counter() - t
    assert pred["chain_em"] == res["chain_em"], (pred["chain_em"],
                                                 res["chain_em"])
    cfg, served = common.init_reader("mini", best, device=dev)
    trained = state.model.eval()
    ds = qa_dataset.QADataset(common.resolve_reader_tokenizer("hash", cfg),
                              f"{tmp}/qa_dev.jsonl", train=False)
    net = qa_dataset.qa_collate([ds[i] for i in range(16)])["net_inputs"]
    with torch.inference_mode():
        rank = [m({k: torch.from_numpy(v).to(dev)
                   for k, v in net.items()})["rank_score"]
                for m in (trained, served)]
    assert torch.equal(rank[0], rank[1]), \
        f"served rank scores differ by {(rank[0] - rank[1]).abs().max()}"
    export_ckpt.main(["--checkpoint", best, "--arch", "reader", "--out",
                      f"{tmp}/qa/reader.pt"])
    back = models.QAReader(cfg)
    back.load_state_dict(torch.load(f"{tmp}/qa/reader.pt",
                                    weights_only=True))
    want = trained.state_dict()
    for k, v in back.state_dict().items():
        assert torch.equal(v, want[k].cpu()), f"exported {k} differs"
    say(f"  leg k2 cli/train_qa (mini preset, hash tokenizer, "
        f"{K_QA_ROWS} questions x 4 chains, batch 8, max_seq_len 512): "
        f"{state.step} steps + predict in {train_s:.1f} s, chain_em "
        f"{res['chain_em']:.3f}; --do-predict from checkpoint_best.pt in "
        f"{predict_s:.1f} s, the same chain_em; served rank scores = the "
        f"trained model's bit for bit; export_ckpt --arch reader "
        f"strict-loads back bit for bit [{smi}]")


def write_sp_rows(path, rng, n):
    """n single-hop rows in data/sp_datasets.py's format: a 6-20 word
    question, one positive and 1-2 negative passages of synth_doc_lens
    words."""
    vocab = np.array([f"w{i}" for i in range(1 << 16)])

    def para():
        words = vocab[rng.randint(len(vocab), size=synth_doc_lens(rng, 1)[0])]
        return {"title": f"doc {rng.randint(1 << 30)}",
                "text": " ".join(words)}

    with open(path, "w") as f:
        for _ in range(n):
            q = " ".join(vocab[rng.randint(len(vocab),
                                           size=rng.randint(6, 21))])
            f.write(json.dumps({
                "question": q + "?", "pos_paras": [para()],
                "neg_paras": [para() for _ in range(rng.randint(1, 3))]})
                + "\n")


def time_cli_steps(T, trainer, dev, iters=5):
    """Examples/s of a CLI trainer's own step at its end: CUDA events
    around ``iters`` steps on one of its loader's batches, the median."""
    batch = next(iter(trainer.train_loader))
    batch.pop("valid", None)
    batch = T.to_device(batch, dev)
    ms = []
    for _ in range(iters):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        trainer.state, loss = trainer.train_step(trainer.state, batch)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        assert torch.isfinite(loss).all()
    med = float(np.median(ms))
    return trainer.train_loader.bs / med * 1e3, med


def run_single_cli(T, dev, smi, tmp):
    """k3: cli/train_single at roberta-base and the reference widths
    (max_q_len 50, max_c_len 300), batch K3_B, one epoch of K3_ROWS rows
    shared, then one with --momentum (the default 256-row token queue)
    from its checkpoint_best.pt; examples/s of each trainer's own step."""
    from multihop_dense_retrieval_tpu_torch.cli import train_single

    rng = np.random.RandomState(71)
    write_sp_rows(f"{tmp}/sp_train.jsonl", rng, K3_ROWS)
    write_sp_rows(f"{tmp}/sp_dev.jsonl", rng, K3_B)
    base = ["--tokenizer", "hash", "--model-name", "roberta-base",
            "--train-file", f"{tmp}/sp_train.jsonl", "--predict-file",
            f"{tmp}/sp_dev.jsonl", "--train-batch-size", str(K3_B),
            "--predict-batch-size", str(K3_B), "--num-epochs", "1"]
    out = {}
    for name, extra in (
            ("shared", ["--output-dir", f"{tmp}/single"]),
            ("momentum", ["--momentum", "--init-checkpoint",
                          f"{tmp}/single/checkpoint_best.pt"])):
        t = time.perf_counter()
        res, trainer = train_single.main(base + extra)
        secs = time.perf_counter() - t
        assert trainer.state.step == K3_ROWS // K3_B, trainer.state.step
        assert np.isfinite(res["final_loss"]) and res["best_mrr"] > 0, res
        eps, ms = time_cli_steps(T, trainer, dev)
        out[name] = eps
        say(f"  leg k3 cli/train_single {name} (roberta-base, widths 50/300, "
            f"batch {K3_B}): {K3_ROWS} rows in {secs:.1f} s (loss "
            f"{res['final_loss']:.4f}, mrr {res['best_mrr']:.4f}); its step "
            f"{ms:.2f} ms, {eps:.1f} examples/s [{smi}]")
        del trainer
        torch.cuda.empty_cache()
    return out


def run_launch_and_export(cfgmod, dev, smi, tmp):
    """k4: cli/launch over leg j3's rows, a 2-point lr grid at the tiny
    preset (2 layers), then the same launch again, which must skip both
    points; cli/export_ckpt --arch mhop of leg j3's stage-1 checkpoint,
    whose vectors, served through cli/common.init_retriever, equal the
    stage-1 checkpoint's bit for bit."""
    from multihop_dense_retrieval_tpu_torch.cli import (common, export_ckpt,
                                                        launch)

    argv = ["--grid-lr", "2e-5,1e-4", "--grid-warmup", "0.1",
            "--train-file", f"{tmp}/train.jsonl", "--predict-file",
            f"{tmp}/dev.jsonl", "--output-dir", f"{tmp}/sweep",
            "--tokenizer", "hash", "--model-name", "tiny",
            "--train-batch-size", str(J_B), "--predict-batch-size",
            str(J_DEV_ROWS), "--num-epochs", "1"]
    secs = []
    for _ in range(2):
        t = time.perf_counter()
        best = launch.main(argv)
        secs.append(time.perf_counter() - t)
        with open(f"{tmp}/sweep/sweep_results.jsonl") as f:
            lines = [json.loads(x) for x in f]
        assert [r["lr"] for r in lines] == [2e-5, 1e-4], lines
        assert best == max(lines, key=lambda r: r["best_mrr"]), best
    out = f"{tmp}/q_encoder.pt"
    sd = export_ckpt.main(["--checkpoint", f"{tmp}/stage1/checkpoint_best.pt",
                           "--arch", "mhop", "--out", out])
    assert not sd["encoder.pooler.dense.weight"].any()
    cfg = cfgmod.EncoderConfig.roberta_base()
    served = [common.init_retriever(cfg, checkpoint=c, device=dev)
              for c in (f"{tmp}/stage1/checkpoint_best.pt", out)]
    rows = train_batch(np.random.RandomState(47), 8, full=False)
    with torch.inference_mode():
        for view in ("q", "q_sp", "c1"):
            ids = torch.from_numpy(rows[f"{view}_input_ids"]).to(dev)
            mask = torch.from_numpy(rows[f"{view}_mask"]).to(dev)
            a, b = (m.encode_seq(ids, mask) for m in served)
            assert torch.equal(a, b), \
                f"{view}: exported vectors differ by {(a - b).abs().max()}"
    say(f"  leg k4 cli/launch (tiny preset, 2 x 1 x 1 grid over {J_ROWS} "
        f"rows): {secs[0]:.1f} s, best {json.dumps(best)}; the requeued "
        f"launch skipped both points in {secs[1]:.2f} s; export_ckpt --arch "
        f"mhop of j3's stage-1 checkpoint ({len(sd)} tensors, zero pooler) "
        f"serves its vectors bit for bit on 3 x 8 rows [{smi}]")


def run_reader_training(port, mips, dev, smi, tmp):
    """Leg (k): the rest of training, which launches none of the eight
    kernels either: the reader's train step on the card against the CPU's
    (k0), ELECTRA-large at the JAX CLI's defaults with and without remat
    (k1), cli/train_qa (k2), cli/train_single (k3), cli/launch and
    cli/export_ckpt (k4, over leg j's files in ``tmp``)."""
    from multihop_dense_retrieval_tpu_torch.train import qa as TQA
    from multihop_dense_retrieval_tpu_torch.train import trainer as T

    cfgmod, models = port[0], port[3]
    torch.cuda.empty_cache()
    mips.reset_launch_counts()
    check_reader_step_on_card(T, TQA, models, cfgmod, dev, smi)
    for what, remat in (("k1", False), ("k1 remat", True)):
        time_reader_steps(T, TQA, models, cfgmod, dev, smi, what, remat)
    run_reader_cli(models, dev, smi, tmp)
    run_single_cli(T, dev, smi, tmp)
    run_launch_and_export(cfgmod, dev, smi, tmp)
    return {"reader_training": assert_no_launches(mips, "k")}


# ---- leg o: data- and tensor-parallel training ----------------------------


def o_meshes(M, dev, data, index):
    """(name, mesh) of leg o: a (data, index) mesh of two entries over the
    card twice, and over cuda:0 and cuda:1 where the host shows two
    cards."""
    out = [(f"{dev} x2", M.make_mesh(data=data, index=index,
                                     devices=[dev] * 2))]
    if torch.cuda.device_count() > 1:
        out.append(("cuda:0 + cuda:1", M.make_mesh(
            data=data, index=index,
            devices=[torch.device("cuda", i) for i in (0, 1)])))
    return out


def rel_dist(a, b):
    """||a - b|| / ||b|| over the tensors of two dicts with b's keys."""
    num = sum(((a[k].double() - b[k].double()) ** 2).sum() for k in b)
    return float(torch.sqrt(num / sum((b[k].double() ** 2).sum()
                                      for k in b)))


def jax_tp_criteria(got, ref, lr, grads, clip):
    """tests/test_parallel.py's parameter criteria, rtol 2e-3 and atol
    2e-4, with its atol 2.5·lr where Adam's first update lr·g / (|g| +
    eps) may flip sign: the attention key biases (zero true gradient),
    and, since the card's tensor-parallel sums round otherwise, every
    element whose clipped gradient (``grads`` times ``clip``) lies within
    its tolerance (1e-6 + 1e-4 of its tensor's largest) of zero but not
    zero (a zero gradient leaves its element put in both steps).  Returns
    how many elements took the looser bound."""
    n_flip = 0
    for name, r in ref.items():
        g = grads[name]
        tol = (1e-6 + 1e-4 * g.abs().max().item()) * clip
        flip = (((g * clip).abs() <= tol) & (g != 0)) | (".key.bias" in name)
        atol = torch.where(flip, 2.5 * lr, 2e-4)
        assert ((got[name] - r).abs() <= atol + 2e-3 * r.abs()).all(), name
        n_flip += int(flip.sum())
    return n_flip


def o_fp32_base(models, cfgmod):
    """j0's model: 2 layers at roberta-base width, fp32 compute."""
    torch.manual_seed(0)
    return models.MhopRetriever(
        cfgmod.EncoderConfig.roberta_base(num_layers=2, dtype="float32"),
        cls_only=True, fp32_params=True)


def o_bf16_setup(models, cfgmod):
    """o1's step: j1's model (roberta-base, bf16 compute, fp32 master
    weights; its seed), a ragged batch of J_B rows at the reference
    widths, Adam at lr 1e-3 without warmup."""
    torch.manual_seed(11)
    base = models.MhopRetriever(cfgmod.EncoderConfig.roberta_base(),
                                cls_only=True, fp32_params=True)
    return (base, train_batch(np.random.RandomState(63), J_B, full=False),
            cfgmod.RetrieverTrainConfig(warmup_ratio=0.0,
                                        learning_rate=1e-3))


def check_parallel_fp32(T, models, cfgmod, dev, smi, leg, mesh, name, tp):
    """o1 / o3 at fp32: j0's model, B=J_B ragged at the reference widths,
    one step over ``mesh`` (``tp``: laid out over its index shards)
    against the single-device card step, by j0's criteria
    (``hold_step``), and for ``tp`` also tests/test_parallel.py's.
    Returns the mesh step (``run_step``'s result without its state)."""
    from multihop_dense_retrieval_tpu_torch.parallel import shard_params

    base = o_fp32_base(models, cfgmod)
    batch = train_batch(np.random.RandomState(61), J_B, full=False)
    tcfg = cfgmod.RetrieverTrainConfig(warmup_ratio=0.0, learning_rate=1e-3)
    ref = run_step(T, base, T.make_train_step, batch, tcfg, dev)
    got = run_step(T, base, lambda: T.make_train_step(
        mesh=mesh, tensor_parallel=tp), batch, tcfg, dev,
        prepare=(lambda m: shard_params(m, mesh)) if tp else None)
    r = hold_step(T, ref, got, tcfg)
    extra = ""
    if tp:
        flips = jax_tp_criteria(got[2], ref[2], tcfg.learning_rate, ref[1],
                                r["clip"])
        extra = (f"; tests/test_parallel.py's criteria hold, {flips} of "
                 f"{r['n']} elements (the key biases, and gradients within "
                 f"their tolerance of 0) at 2.5 lr")
    say(f"  leg {leg} {'TP' if tp else 'DP'} step over {name} (mesh "
        f"{dict(mesh.shape)}; {base.config.num_layers} x "
        f"{base.config.hidden_size}, fp32, B={J_B} ragged) vs the "
        f"single-device card step: loss {r['loss'][0]:.7f} vs "
        f"{r['loss'][1]:.7f}; worst gradient error {r['worst_g'][0]:.3f} of "
        f"its tolerance ({r['worst_g'][1]}); worst parameter "
        f"{r['worst_p'][0]:.3f} of its Adam bound ({r['worst_p'][1]})"
        f"{extra} [{smi}]")
    return got[:4] + (None,)


def local_negatives_step(T, losses, base, batch, tcfg, dev, n=2):
    """The negative control: each of ``n`` entries scores its own slice's
    in-batch negatives only, and the entries' gradients are averaged (what
    DDP does to a separable loss).  (loss, gradients)."""
    import copy

    model = copy.deepcopy(base).to(dev)
    tb = T.to_device(batch, dev)
    rows = J_B // n
    loss = sum(losses.mhop_loss(model({k: v[j * rows:(j + 1) * rows]
                                       for k, v in tb.items()}))
               for j in range(n)) / n
    loss.backward()
    return float(loss), joined_grads(model)


def check_bf16_spread(T, losses, models, cfgmod, dev, smi, runs):
    """o1 / o3 at the leg's width: roberta-base in bf16, one step of each
    of ``runs`` ((leg, name, make_step, prepare)) against the
    single-device bf16 step, in units of the bf16 noise n = the distance
    of the single-device step's gradients at bf16 from those at fp32 (the
    same weights).  A run's slices (or shards' partial sums) round
    otherwise than the whole batch's products, as leg h found for the
    encoder's shapes: two independent bf16 roundings lie up to ~1.4 n
    apart.  Held: the loss within O_LOSS_TOL relative (its scores,
    products of vectors of norm ~8 through bf16 hidden states, move by
    ~1e-3 of the loss between two such roundings: 1.5e-3 for the tensor-
    parallel step in the CPU rehearsal at 64 wide), the gradients within
    2 n.  The negative control (local in-batch negatives, averaged
    gradients) must fail both.  Returns the noise, the control's readings
    and each run's (loss, gradients, parameters) by its name."""
    base, batch, tcfg = o_bf16_setup(models, cfgmod)
    ref = run_step(T, base, T.make_train_step, batch, tcfg, dev)[:3]
    wide = models.MhopRetriever(cfgmod.EncoderConfig.roberta_base(
        dtype="float32"), cls_only=True, fp32_params=True)
    wide.load_state_dict(base.state_dict())
    l32, g32 = run_step(T, wide, T.make_train_step, batch, tcfg, dev)[:2]
    del wide
    noise = rel_dist(ref[1], g32)
    lc, gc = local_negatives_step(T, losses, base, batch, tcfg, dev)
    control = (abs(lc - ref[0]) / abs(ref[0]), rel_dist(gc, ref[1]) / noise)
    assert control[0] > O_LOSS_TOL and control[1] > 2.0, \
        f"the local-negatives control passes the bf16 criteria: {control}"
    say(f"  leg o1 bf16 noise (roberta-base, B={J_B} ragged, single-device "
        f"step at bf16 vs fp32): gradients {noise:.4g} apart = 1 n, losses "
        f"{ref[0]:.6f} vs {l32:.6f} (rel {abs(ref[0] - l32) / abs(l32):.3g}); "
        f"the "
        f"negative control (local in-batch negatives over 2 halves, "
        f"averaged gradients) reads loss rel {control[0]:.4g} (bound "
        f"{O_LOSS_TOL:g}), gradients {control[1]:.2f} n (bound 2 n): it fails, as "
        f"it must [{smi}]")
    steps = {}
    for leg, name, make_step, prepare in runs:
        got = run_step(T, base, make_step, batch, tcfg, dev, prepare=prepare)
        steps[name] = got[:3]
        lr_ = abs(got[0] - ref[0]) / abs(ref[0])
        gn = rel_dist(got[1], ref[1]) / noise
        say(f"  leg {leg} bf16 {name} vs the single-device step "
            f"(roberta-base, B={J_B} ragged): loss {got[0]:.6f} vs "
            f"{ref[0]:.6f} (rel {lr_:.3g}, bound {O_LOSS_TOL:g}; against "
            f"the fp32 step's rel {abs(got[0] - l32) / abs(l32):.3g}); "
            f"gradients {gn:.3f} n apart (bound 2 n), "
            f"{rel_dist(got[1], g32) / noise:.3f} n from the fp32 step's "
            f"[{smi}]")
        assert lr_ <= O_LOSS_TOL and gn <= 2.0, (leg, name, lr_, gn)
    return {"noise": noise, "control": control, "steps": steps}


def time_parallel_steps(T, models, cfgmod, dev, smi, runs):
    """o1 / o3 throughput: j1's model and batch (roberta-base, bf16, B=J_B
    at the reference widths, full masks), each of ``runs`` ((name,
    make_step, prepare, devices)) on its own model, O_ITERS steps timed by
    CUDA events after O_WARM, in turns (the runs, then the runs reversed:
    the median of both windows), with each run's peak allocated memory
    on each of its cards.  Returns {name: (ms, examples/s)}."""
    import copy

    base, _, tcfg = o_bf16_setup(models, cfgmod)
    tcfg = cfgmod.RetrieverTrainConfig(batch_size=J_B)
    batch = T.to_device(train_batch(np.random.RandomState(11), J_B), dev)
    made = {}
    for name, make_step, prepare, cards in runs:
        model = copy.deepcopy(base).to(dev)
        if prepare is not None:
            prepare(model)
        made[name] = [T.TrainState.create(model, T.make_optimizer(tcfg,
                                                                  1000)),
                      make_step(), [], {}, cards]
    del base
    order = [r[0] for r in runs]
    for names in (order, order[::-1]):
        for name in names:
            state, step, ms, peak, cards = made[name]
            for d in cards:
                torch.cuda.reset_peak_memory_stats(d)
            for i in range(O_WARM + O_ITERS // 2):
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                state, loss = step(state, batch)
                ev[1].record()
                torch.cuda.synchronize()
                assert torch.isfinite(loss).all(), (name, float(loss))
                if i >= O_WARM:
                    ms.append(ev[0].elapsed_time(ev[1]))
            for d in cards:
                peak[str(d)] = max(peak.get(str(d), 0.0),
                                   torch.cuda.max_memory_allocated(d) / 2**30)
    out = {}
    for name in order:
        _, _, ms, peak, _ = made[name]
        med = float(np.median(ms))
        out[name] = (med, J_B / med * 1e3)
        say(f"  leg o throughput {name} (roberta-base, bf16 compute, fp32 "
            f"master weights, B={J_B} at the reference widths): "
            f"{J_B / med * 1e3:.1f} examples/s, median {med:.2f} ms/step "
            f"(min {min(ms):.2f}, max {max(ms):.2f}) over {len(ms)} steps in "
            f"two windows; peak allocated "
            f"{', '.join(f'{d} {g:.2f} GiB' for d, g in peak.items())} "
            f"[{smi}]")
    return out


def check_parallel_momentum(T, models, cfgmod, dev, smi, mesh, name):
    """o2: the momentum step (j0's model, fp32, B=J_B ragged, j3's queue of
    J_QUEUE x 768) over ``mesh`` against the single-device card step:
    the loss, gradients and parameters by j0's criteria, the enqueued
    rows (the global batch's c1 and c2 key vectors, in global order)
    within 1e-5 and the rest of the queue untouched, the pointer
    equal."""
    base = o_fp32_base(models, cfgmod)
    batch = train_batch(np.random.RandomState(65), J_B, full=False)
    tcfg = cfgmod.RetrieverTrainConfig(warmup_ratio=0.0, learning_rate=1e-3)

    def state_of(m, tx):
        return T.MomentumTrainState.create(m, tx, queue_size=J_QUEUE,
                                           hidden=D, seed=5)

    ref = run_step(T, base, T.make_momentum_train_step, batch, tcfg, dev,
                   state_of=state_of)
    got = run_step(T, base, lambda: T.make_momentum_train_step(mesh=mesh),
                   batch, tcfg, dev, state_of=state_of)
    r = hold_step(T, ref, got, tcfg)
    qa, qb = ref[4].queue, got[4].queue
    assert got[4].queue_ptr == ref[4].queue_ptr == 2 * J_B
    err = (qa[:2 * J_B] - qb[:2 * J_B]).abs().max().item()
    assert err <= 1e-5 and torch.equal(qa[2 * J_B:], qb[2 * J_B:]), err
    say(f"  leg o2 momentum step over {name} ({J_QUEUE} x {D} queue, "
        f"{base.config.num_layers} x {base.config.hidden_size} fp32, "
        f"B={J_B} ragged) vs single-device: loss "
        f"{r['loss'][0]:.7f} vs {r['loss'][1]:.7f}; worst gradient error "
        f"{r['worst_g'][0]:.3f} of its tolerance; worst parameter "
        f"{r['worst_p'][0]:.3f} of its Adam bound; enqueued rows within "
        f"{err:.3g}, pointer {got[4].queue_ptr} = {ref[4].queue_ptr} "
        f"[{smi}]")


def sp_batch(rng, b):
    """A single-hop train batch at k3's widths (question 50, passages
    300), ragged, random ids."""
    out = {}
    for name, width in (("q", 50), ("c", 300), ("neg", 300)):
        lens = rng.randint(8, width + 1, size=b)
        mask = (np.arange(width)[None] < lens[:, None]).astype(np.int32)
        ids = rng.randint(5, VOCAB - 5, size=(b, width))
        out[f"{name}_input_ids"] = np.where(mask > 0, ids, 1).astype(np.int32)
        out[f"{name}_mask"] = mask
    return out


def check_parallel_token_queue(T, models, cfgmod, dev, smi, mesh, name):
    """o2: one step of cli/train_single --momentum's token-queue step at
    k3's shapes (roberta-base, bf16, B=K3_B, widths 50/300, the CLI's
    256-row queue) over ``mesh`` against the single-device step: the
    queue's token rows bit-equal, the pointer equal, the loss within
    o1's bf16 tolerance (O_LOSS_TOL relative)."""
    torch.manual_seed(17)
    base = models.SingleRetriever(cfgmod.EncoderConfig.roberta_base(),
                                  fp32_params=True)
    batch = sp_batch(np.random.RandomState(67), K3_B)
    tcfg = cfgmod.RetrieverTrainConfig(warmup_ratio=0.0)

    def state_of(m, tx):
        return T.TokenQueueTrainState.create(m, tx, queue_size=256,
                                             max_c_len=300, cls_id=0,
                                             sep_id=2)

    ref = run_step(T, base, T.make_single_momentum_train_step, batch, tcfg,
                   dev, state_of=state_of)
    got = run_step(T, base, lambda: T.make_single_momentum_train_step(
        mesh=mesh), batch, tcfg, dev, state_of=state_of)
    rel = abs(got[0] - ref[0]) / abs(ref[0])
    assert rel <= O_LOSS_TOL, rel
    for q in ("queue_ids", "queue_mask", "queue_type"):
        assert torch.equal(getattr(got[4], q), getattr(ref[4], q)), q
    assert got[4].queue_ptr == ref[4].queue_ptr == K3_B
    say(f"  leg o2 token-queue step over {name} (roberta-base, bf16, "
        f"B={K3_B}, widths 50/300, 256-row queue) vs single-device: loss "
        f"{got[0]:.6f} vs {ref[0]:.6f} (rel {rel:.3g}); queue token rows "
        f"bit-equal, pointer {got[4].queue_ptr} [{smi}]")


def run_parallel_clis(cfgmod, dev, smi, tmp):
    """o4: cli/train_retriever, cli/train_momentum (from its
    checkpoint_best.pt, j3's queue) and cli/train_single (k3's shapes)
    with --data-parallel 2 (the card twice as --device cuda:0; the bare
    cuda over two cards where the host shows them), O_ROWS rows each at
    roberta-base: their steps run on the 2-entry mesh, the losses are
    finite, and each checkpoint strict-loads back through
    cli/common.init_retriever."""
    from multihop_dense_retrieval_tpu_torch.cli import (common,
                                                        train_momentum,
                                                        train_retriever,
                                                        train_single)

    rng = np.random.RandomState(69)
    write_train_rows(f"{tmp}/o_train.jsonl", rng, O_ROWS)
    write_train_rows(f"{tmp}/o_dev.jsonl", rng, J_B)
    write_sp_rows(f"{tmp}/o_sp.jsonl", rng, O_ROWS)
    card = "cuda" if torch.cuda.device_count() > 1 else str(dev)
    dp = ["--device", card, "--data-parallel", "2", "--tokenizer", "hash",
          "--model-name", "roberta-base", "--num-epochs", "1"]
    mhop = dp + ["--train-file", f"{tmp}/o_train.jsonl", "--predict-file",
                 f"{tmp}/o_dev.jsonl", "--train-batch-size", str(J_B),
                 "--predict-batch-size", str(J_B)]
    runs = [
        ("train_retriever", train_retriever.main,
         mhop + ["--output-dir", f"{tmp}/o_stage1"], J_B, "o_stage1"),
        ("train_momentum", train_momentum.main,
         mhop + ["--output-dir", f"{tmp}/o_stage2", "--init-checkpoint",
                 f"{tmp}/o_stage1/checkpoint_best.pt", "--queue-size",
                 str(J_QUEUE)], J_B, "o_stage2"),
        ("train_single", train_single.main,
         dp + ["--train-file", f"{tmp}/o_sp.jsonl", "--predict-file",
               f"{tmp}/o_sp.jsonl", "--train-batch-size", str(K3_B),
               "--predict-batch-size", str(K3_B), "--output-dir",
               f"{tmp}/o_single"], K3_B, "o_single")]
    cfg = cfgmod.EncoderConfig.roberta_base()
    for name, main, argv, b, out in runs:
        t = time.perf_counter()
        res, trainer = main(argv)
        secs = time.perf_counter() - t
        assert trainer.mesh.shape == {"data": 2, "index": 1}, trainer.mesh
        assert trainer.state.step == O_ROWS // b, trainer.state.step
        assert np.isfinite(res["final_loss"]) and res["best_mrr"] > 0, res
        common.init_retriever(cfg, checkpoint=f"{tmp}/{out}/"
                              "checkpoint_last.pt", device=dev)
        say(f"  leg o4 cli/{name} --device {card} --data-parallel 2 "
            f"(roberta-base, batch {b}, {O_ROWS} rows, mesh {trainer.mesh}): "
            f"{secs:.1f} s, loss {res['final_loss']:.4f}, mrr "
            f"{res['best_mrr']:.4f}; its checkpoint strict-loads back "
            f"[{smi}]")
        del trainer
        torch.cuda.empty_cache()


# one process of o5 and o6: joins the pod, runs o1's data-parallel step on
# its half of the batch (o5), then lays o3's steps out over an index-2 mesh
# of one shard a process (o6); rank 0 saves what they consumed and made
POD_STEP = r"""
import sys
import chip_smoke
chip_smoke.pod_step_worker(*sys.argv[1:])
"""


def pod_step_worker(init, rank, out, device, card):
    """o5's and o6's process ``rank`` of 2 on ``device``: a card shared by
    the two (``card`` "shared"), or its own (``card`` "own": the only one
    it then sees, so that init_pod takes NCCL).  o5: a data-2 mesh of one
    entry a process, its half of o1's batch (host_local_batch_to_global),
    the replicated state (replicate_to_global), one step.  o6: an index-2
    mesh of one shard a process, so every layer's row-parallel sums and
    its column input's gradient cross the processes; o3's two steps from
    the replicated weights, each laid out first (parallel.shard_params);
    then O6_ITERS bf16 steps at j1's batch (full masks), timed by CUDA
    events.  Rank 0 saves each step's loss, the gradients its update
    consumed and its parameters (o6's gathered over the index group), and
    o6's step times, to ``out``."""
    import copy
    import os

    rank = int(rank)
    if card == "own":
        os.environ["CUDA_VISIBLE_DEVICES"] = str(rank)
    from multihop_dense_retrieval_tpu_torch import models
    from multihop_dense_retrieval_tpu_torch.core import config as cfgmod
    from multihop_dense_retrieval_tpu_torch.core import mesh as M
    from multihop_dense_retrieval_tpu_torch.parallel import shard_params
    from multihop_dense_retrieval_tpu_torch.train import trainer as T

    dev = torch.device(device)
    res = {"backend": M.init_pod(init, 2, rank)}
    # o5
    mesh = M.make_mesh(data=2, index=1, devices=M.pod_devices([dev]))
    bf16 = o_bf16_setup(models, cfgmod)
    base, batch, tcfg = bf16
    half = J_B // 2
    local = {k: v[rank * half:(rank + 1) * half] for k, v in batch.items()}
    state = M.replicate_to_global(T.TrainState.create(
        copy.deepcopy(base), T.make_optimizer(tcfg, 10)), mesh)
    grads = {}
    update = state.opt.update

    def kept():
        grads.update(joined_grads(state.model))
        return update()

    state.opt.update = kept
    state, loss = T.make_train_step(mesh=mesh)(
        state, M.host_local_batch_to_global(local, mesh))
    res["o5"] = (float(loss), grads, {k: v.cpu() for k, v in
                                      state.model.state_dict().items()})
    del state
    # o6: j0's model at fp32 (check_parallel_fp32's batch), o1's bf16 step
    mesh = M.make_mesh(data=1, index=2, devices=M.pod_devices([dev]))
    assert mesh.spans_processes and mesh.ranks == ((0, 1),), mesh

    def make():
        return T.make_train_step(mesh=mesh, tensor_parallel=True)

    fp32 = (o_fp32_base(models, cfgmod),
            train_batch(np.random.RandomState(61), J_B, full=False),
            cfgmod.RetrieverTrainConfig(warmup_ratio=0.0, learning_rate=1e-3))
    for name, (base, batch, tcfg) in (("fp32", fp32), ("bf16", bf16)):
        res[name] = run_step(T, base, make, batch, tcfg, dev,
                             prepare=lambda m: shard_params(m, mesh))[:4]
    model = copy.deepcopy(bf16[0]).to(dev)
    shard_params(model, mesh)
    state = T.TrainState.create(model, T.make_optimizer(
        cfgmod.RetrieverTrainConfig(batch_size=J_B), 1000))
    step = make()
    batch = T.to_device(train_batch(np.random.RandomState(11), J_B), dev)
    ms = []
    for _ in range(O6_ITERS):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        state, loss = step(state, batch)
        ev[1].record()
        torch.cuda.synchronize()
        assert torch.isfinite(loss).all(), float(loss)
        ms.append(ev[0].elapsed_time(ev[1]))
    res["ms"] = ms
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    if rank == 0:
        torch.save(res, out)
    M.close_pod()
    print(f"POD STEP OK {res['backend']}", flush=True)


def run_pod_steps(T, cfgmod, dev, smi, tmp, spread, refs, tp_ms):
    """o5 and o6 in one pod of 2 processes through ``run_processes``
    (pod_step_worker): on one card they share it and go over gloo, on two
    each takes its own and NCCL.  o5,
    o1's data-parallel step, is held to o1's single-process data-2 step
    on the card twice (``spread``'s): the loss within 1e-6 relative, the
    gradients and parameters by j0's criteria (the processes sum the two
    halves' gradients in another grouping than one process does).  o6,
    o3's tensor-parallel steps, are held to o3's single-process index-2
    steps ``refs`` (over the card twice, or cuda:0 + cuda:1 where there
    are two): the fp32 step by j0's criteria, the bf16 step's loss within
    O_LOSS_TOL relative and its gradients within 2 n of the bf16 noise n
    (o1).  Prints the pod's seconds and o6's bf16 ms a step beside o3's
    one-process ``tp_ms``."""
    own = torch.cuda.device_count() > 1
    out = f"{tmp}/o56.pt"
    torch.cuda.empty_cache()
    t = time.perf_counter()
    outs = run_processes([["-c", POD_STEP, "tcp://localhost:{port}",
                           "{rank}", out, "cuda:0" if own else str(dev),
                           "own" if own else "shared"]] * 2)
    secs = time.perf_counter() - t
    assert all("POD STEP OK" in o for o, _ in outs), outs
    got = torch.load(out, weights_only=True)
    backend = got["backend"]
    assert backend == ("nccl" if own else "gloo"), backend
    tcfg = cfgmod.RetrieverTrainConfig(warmup_ratio=0.0, learning_rate=1e-3)
    ref = spread["steps"][f"DP over {dev} x2"]
    mine = got["o5"]
    assert abs(mine[0] - ref[0]) <= 1e-6 * abs(ref[0]), (mine[0], ref[0])
    r = hold_step(T, ref + (None, None), mine + (None, None), tcfg)
    say(f"  leg o5 two processes ({backend}, data-2 mesh of one entry each, "
        f"roberta-base bf16, B={J_B}) vs o1's single-process data-2 step "
        f"on {dev} x2: loss {mine[0]:.7f} vs {ref[0]:.7f}; worst gradient "
        f"error {r['worst_g'][0]:.3f} of its tolerance; worst parameter "
        f"{r['worst_p'][0]:.3f} of its Adam bound [{smi}]")
    mine, ref = got["fp32"] + (None,), refs["fp32"]
    r = hold_step(T, ref, mine, tcfg)
    (lb, gb), (rl, rg) = got["bf16"][:2], refs["bf16"][:2]
    lr_, gn = abs(lb - rl) / abs(rl), rel_dist(gb, rg) / spread["noise"]
    assert lr_ <= O_LOSS_TOL and gn <= 2.0, (lr_, gn)
    say(f"  leg o6 tensor parallelism across 2 processes ({backend}, "
        f"index-2 mesh of one shard each, "
        f"{'two cards' if own else 'the card shared'}) vs o3's "
        f"single-process index-2 step: fp32 (2 x 768, B={J_B} ragged) loss "
        f"{mine[0]:.7f} vs {ref[0]:.7f}; worst gradient error "
        f"{r['worst_g'][0]:.3f} of its tolerance; worst parameter "
        f"{r['worst_p'][0]:.3f} of its Adam bound; roberta-base bf16 loss "
        f"{lb:.6f} vs {rl:.6f} (rel {lr_:.3g}, bound {O_LOSS_TOL:g}); "
        f"gradients {gn:.4f} n apart (bound 2 n) [{smi}]")
    med = float(np.median(got["ms"]))
    say(f"  leg o5 + o6 pod: {secs:.1f} s; o6's bf16 step at j1's batch "
        f"{med:.2f} ms/step (min {min(got['ms']):.2f}, max "
        f"{max(got['ms']):.2f}; {len(got['ms'])} timed after the two "
        f"checked ones), {J_B / med * 1e3:.1f} examples/s, rank 0's peak "
        f"allocated {got['peak_gib']:.2f} GiB; in one process (o3) "
        f"{tp_ms:.2f} ms [{smi}]")


def run_parallel_training(port, mips, dev, smi, tmp, then=lambda: None):
    """Leg (o): data- and tensor-parallel training, which launches none of
    kernels 1-8 (the counts must stay 0): o1 the data-parallel step
    (fp32 by j0's criteria, bf16 at roberta-base against the bf16 noise,
    the negative control, throughput beside j1's), o3 the tensor-parallel
    step (as o1; each card's peak memory), o5 and o6 the data- and
    tensor-parallel steps in two processes, o2 the momentum and
    token-queue steps, o4 the trainer CLIs with --data-parallel 2.
    ``then()`` runs once the throughput runs are done: leg p starts its
    processes there, beside o5 and o6's pod, o2 and o4."""
    from multihop_dense_retrieval_tpu_torch.core import mesh as M
    from multihop_dense_retrieval_tpu_torch.parallel import shard_params
    from multihop_dense_retrieval_tpu_torch.train import losses
    from multihop_dense_retrieval_tpu_torch.train import trainer as T

    cfgmod, models = port[0], port[3]
    torch.cuda.empty_cache()
    mips.reset_launch_counts()
    t0 = time.perf_counter()
    dps = o_meshes(M, dev, 2, 1)
    tps = o_meshes(M, dev, 1, 2)
    for name, mesh in dps:
        check_parallel_fp32(T, models, cfgmod, dev, smi, "o1", mesh, name,
                            False)
    # o3's steps, by mesh: o6 is held to them
    tp_refs = {name: {"fp32": check_parallel_fp32(
        T, models, cfgmod, dev, smi, "o3", mesh, name, True)}
        for name, mesh in tps}
    runs = [("o1", f"DP over {n}", lambda m=m: T.make_train_step(mesh=m),
             None) for n, m in dps]
    runs += [("o3", f"TP over {n}", lambda m=m: T.make_train_step(
        mesh=m, tensor_parallel=True), lambda x, m=m: shard_params(x, m))
        for n, m in tps]
    spread = check_bf16_spread(T, losses, models, cfgmod, dev, smi, runs)
    for name, _ in tps:
        tp_refs[name]["bf16"] = spread["steps"][f"TP over {name}"]
    torch.cuda.empty_cache()
    def cards(m):
        return sorted({d for row in m.devices for d in row}, key=str)

    timed = [("single device (j1's config)", T.make_train_step, None,
              [dev])]
    timed += [(f"DP over {n}", lambda m=m: T.make_train_step(mesh=m), None,
               cards(m)) for n, m in dps]
    timed += [(f"TP over {n}", lambda m=m: T.make_train_step(
        mesh=m, tensor_parallel=True), lambda x, m=m: shard_params(x, m),
        cards(m)) for n, m in tps]
    tp_ms = time_parallel_steps(T, models, cfgmod, dev, smi, timed)
    then()
    # o6 runs on two cards where the host shows them (tps' last mesh)
    pick = tps[-1][0]
    run_pod_steps(T, cfgmod, dev, smi, tmp, spread, tp_refs[pick],
                  tp_ms[f"TP over {pick}"][0])
    del spread, tp_refs
    torch.cuda.empty_cache()
    for name, mesh in dps:
        check_parallel_momentum(T, models, cfgmod, dev, smi, mesh, name)
    check_parallel_token_queue(T, models, cfgmod, dev, smi, dps[0][1],
                               dps[0][0])
    torch.cuda.empty_cache()
    run_parallel_clis(cfgmod, dev, smi, tmp)
    say(f"  leg o: {time.perf_counter() - t0:.1f} s [{smi}]")
    return {"parallel_training": assert_no_launches(mips, "o")}


# ---- leg p: trained weights ------------------------------------------------


def load_script(name):
    """A script of scripts_dev/ as a module (they are not a package)."""
    path = Path(__file__).resolve().parent / "scripts_dev" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_record(name):
    """A result the JAX package's script of the same name wrote (docs/)."""
    with open(Path(__file__).resolve().parent / "docs" / name) as f:
        return json.load(f)


@contextlib.contextmanager
def scoped_env(**kw):
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def hold_scan_launches(seen, mips):
    """Hold recorded kernel-2 launches (name, (queries, index, k, n_valid),
    (vals, ids)) against the plain exact scan, as leg b does: values
    within rtol 1e-5 (the kept rows rescored in fp32), ids equal apart
    from near-ties.  Clears them; returns (launches, the largest relative
    difference)."""
    worst, n = 0.0, len(seen)
    for _, (q, index, k, n_valid), (kv, ki) in seen:
        pv, pi = mips.mips_scan_plain(q, index, k, n_valid)
        rel = ((kv - pv).abs() / pv.abs().clamp(min=1e-30)).max().item()
        assert rel <= 1e-5, f"kernel 2 (B={q.shape[0]}) off by {rel} relative"
        qb = q.to(index.dtype).float()
        alt = (qb[:, None, :] * index[ki.long()].float()).sum(-1)
        tie_ok = (ki == pi) | ((alt - pv).abs() <= 1e-5 * pv.abs())
        assert bool(tie_ok.all()), "kernel 2 ids disagree beyond near-ties"
        worst = max(worst, rel)
    seen.clear()
    return n, worst


def median_ms(fn, n):
    """The median of ``n`` launches of ``fn``, each timed by CUDA events."""
    fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def run_prune_sweep(ps, mips, dev, smi, work):
    """Leg (p1): prune_sweep_torch at its defaults (the mini retriever, 8
    epochs over 512 questions, 65,536 docs, a bf16 index, beam 4, batch
    16), stage by stage as its main() runs them: every margin beside
    docs/prune_sweep_r5.json's, every kernel-2 launch of the sweep held
    to the plain exact scan.  Returns the launch counts."""
    mips.reset_launch_counts()
    paths, docs, rows = ps.make_data(work, np.random.RandomState(0),
                                     n_docs=P_DOCS, n_train=P_Q,
                                     n_key_docs=P_KEYS)
    stage1, index_dir = f"{work}/stage1", f"{work}/index"
    trained = ps._train_and_encode(work, paths, stage1, index_dir, P_DOCS,
                                   dev)
    launched, restore = record_launches(mips, ("mips_scan",))
    t0 = time.perf_counter()
    try:
        with scoped_env(PRUNE_OUT=f"{work}/p1.json", PRUNE_DEVICE=str(dev)):
            res = ps._sweep(work, paths, docs, rows, stage1, index_dir,
                            min(4096, P_DOCS), P_DOCS, P_KEYS, P_Q)
    finally:
        restore()
    t_sweep = time.perf_counter() - t0
    counts = leg_counts(mips)
    n_held, rel = hold_scan_launches(launched, mips)
    assert counts["mips_scan"] == n_held > 0, (counts, n_held)
    others = {k: counts[k] for k in search_kernels(mips) if k != "mips_scan"}
    assert not any(others.values()), f"other kernels ran on leg p1: {others}"
    say(f"  p1 prune_sweep_torch (mini, {P_DOCS} docs, {P_Q} questions): "
        f"train {trained['train_s']:.1f} s (best MRR "
        f"{trained['best_mrr']:.4f}), encode {trained['encode_s']:.1f} s, "
        f"sweep {t_sweep:.1f} s; kernel 2 launched {n_held} times, each "
        f"held to the plain scan (max relative difference {rel:.3g}); "
        f"launches {json.dumps(counts)} [{smi}]")
    ref = jax_record("prune_sweep_r5.json")

    def short(name):
        return name.rsplit("_", 1)[0] if name.startswith("margin_p") else name

    jax_by = {short(k): v for k, v in ref.items() if k.startswith("margin_")}
    for name, got in res.items():
        if name.startswith("margin_"):
            jax = jax_by.get(short(name), {})
            say(f"    {name}: " + ", ".join(
                f"{k} {got.get(k, '-')} (JAX, TPU record: {jax.get(k, '-')})"
                for k in ("pruned_frac", "chain_agreement", "p_em", "pr",
                          "gold_hop1_expanded")))
    return counts


def trained_batches(engine, tok, questions, index, mips, margin=0.0):
    """Search ``questions`` with ``engine`` in batches of P_BATCH (the
    last padded with its last question).  Every MIPS call is held to the
    exact scans over ``index`` (check_recorded_hops: hop 1 bit-equal,
    hop-2 scores bit-equal to their rows' rescan-order products,
    certified queries the exact top-1), every kernel 3 and 4 launch to
    its plain version, and each batch to the beam-4 margin rule.  Returns
    (the real rows' outputs, concatenated; their certified hop-2 queries
    and hop-2 queries; the pruned share of their hop-1 candidates; the
    first batch's kernel 1, 3 and 4 launches)."""
    rows, first = {}, None
    n_cert = n_pca = n_pruned = 0
    seen = record_queries(engine, outputs=True)
    for s in range(0, len(questions), P_BATCH):
        qs = questions[s:s + P_BATCH]
        qs_p = qs + [qs[-1]] * (P_BATCH - len(qs))
        raw = [tok.raw_ids_padded(q, 76) for q in qs_p]
        launched, restore = record_launches(
            mips, ("mips_scan_int8", "pca_chunk_max", "pca_rescan_int8"))
        try:
            out = engine.search(tok.encode_batch_one(qs_p, 24),
                                np.stack([r[0] for r in raw]),
                                np.array([r[1] for r in raw]))
            torch.cuda.synchronize()
        finally:
            restore()
        check_recorded_hops(seen, index, mips)
        seen.clear()
        first = first or list(launched)
        check_recorded_launches([x for x in launched
                                 if x[0] != "mips_scan_int8"], mips)
        pruned, _, _ = check_beam4_semantics(out, margin, 0.0, [], (),
                                             mips.NEG_INF, n_real=len(qs))
        n_pruned += pruned * len(qs) * B4
        n_cert += int(out["pca_cert2"][:len(qs)].sum())
        n_pca += len(qs) * B4
        for key, val in out.items():
            rows.setdefault(key, []).append(val[:len(qs)])
    return ({k: np.concatenate(v) for k, v in rows.items()}, n_cert, n_pca,
            n_pruned / n_pca, first)


def chains(out, neg_inf):
    """Each question's chains (hop-1 id, hop-2 id) with a finite score."""
    return [tuple((int(a), int(b)) for a, b, s in zip(h1, h2, sc)
                  if s > neg_inf / 2)
            for h1, h2, sc in zip(out["hop1_ids"], out["hop2_ids"],
                                  out["path_scores"])]


def time_trained_kernels(launched, mips, smi):
    """Kernels 1, 3 and 4 on the first full batch's own launches: the
    median of P_TIMED CUDA-event launches each, beside its bound; kernel
    4's chunk skew.  Returns {kernel: (ms, bound_ms, bound_by)}."""
    args = {name: a for name, a, _ in launched}
    out = {}
    qi, qs, idx8, dsc, k, n_valid = args["mips_scan_int8"]
    b, n = qi.shape[0], idx8.shape[0]
    out["mips_scan_int8"] = (
        median_ms(lambda: mips.mips_scan_int8(*args["mips_scan_int8"]),
                  P_TIMED),
        bound_ms(n * D + n * 4 + b * D + b * 4 + b * k * 8, 2 * b * n * D,
                 "int8"), f"B={b}, N={n}, k={k}")
    qp, proj, cand, n_valid = args["pca_chunk_max"]
    b3, r = qp.shape
    out["pca_chunk_max"] = (
        median_ms(lambda: mips.pca_chunk_max(*args["pca_chunk_max"]),
                  P_TIMED),
        bound_ms(n * r * 2 + b3 * r * 2 + b3 * (n // cand) * 4,
                 2 * b3 * n * r, "bf16"), f"B={b3}, N={n}, R={r}")
    a = args["pca_rescan_int8"]
    ids, q, index, cand = a[0], a[1], a[2], a[4]
    b4, kc = ids.shape
    # each query selects kc distinct chunks: a chunk's count is the
    # queries that selected it
    per_chunk = torch.bincount(ids.reshape(-1).long())
    uniq = int((per_chunk > 0).sum())
    out["pca_rescan_int8"] = (
        median_ms(lambda: mips.pca_rescan_int8(*a), P_TIMED),
        bound_ms(uniq * cand * (index.shape[1] + 4) + q.numel()
                 + b4 * kc * 4 + b4 * kc * cand * 4,
                 2 * b4 * kc * cand * index.shape[1], "int8"),
        f"B={b4}, kc={kc}: {uniq} distinct chunks, at most "
        f"{int(per_chunk.max())} queries on one (h3: 768 on one; kernel 4 "
        f"there 0.2306 ms against a 0.0134 ms bound)")
    for name, (ms, bnd, what) in out.items():
        say(f"    {name} on p2's trained launches ({what}): {ms:.4f} ms "
            f"(median of {P_TIMED}), bound {bnd[0]:.4f} ms by {bnd[1]} "
            f"({bnd[0] / ms:.3f} of it) [{smi}]")
    return {name: (ms, bnd[0], bnd[1]) for name, (ms, bnd, _) in out.items()}


def train_p2_retriever(paths, stage1, lr, epochs, dev):
    """p1's stage-1 recipe (batch 8, widths 24 / 80 / 64) at roberta-base
    width through cli/train_retriever: its result dict."""
    from multihop_dense_retrieval_tpu_torch.cli import train_retriever

    trained, _ = train_retriever.main([
        "--train-file", paths["mhop"], "--predict-file", paths["eval"],
        "--output-dir", stage1, "--train-batch-size", "8",
        "--predict-batch-size", "8", "--num-epochs", str(epochs),
        "--learning-rate", str(lr), "--tokenizer", "hash",
        "--model-name", "roberta-base", "--max-q-len", "24",
        "--max-q-sp-len", "80", "--max-c-len", "64", "--device", str(dev)])
    return trained


def run_trained_full_width(mips, dev, smi, work, data):
    """Leg (p2), the slice's main path at full width: p1's corpus and
    questions, a roberta-base retriever (bf16, fp32 master weights)
    trained through cli/train_retriever (P_EPOCHS epochs at learning rate
    P_LR), the corpus encoded by cli/encode_corpus into an int8 index with
    a 128-dim PCA prefilter, then the 512 questions at batch P_BATCH and
    beam 4 (768 hop-2 queries a batch): hop 1 through kernel 1, hop 2
    through kernels 3 + 4 (pca_hops="auto").  Unpruned, at auto and
    auto:0.9 (pruned share, chain agreement with the unpruned engine),
    and over P_SHARDS row shards on the card (the merged certificate is
    the AND over shards; hop 1 bit-equal to the unsharded engine).
    Every batch held as trained_batches says.  Returns (launch counts, the
    first unsharded batch's kernel 1, 3 and 4 launches)."""
    from multihop_dense_retrieval_tpu_torch.cli import common, encode_corpus
    from multihop_dense_retrieval_tpu_torch.cli.eval_mhop_retrieval import \
        load_searcher
    from multihop_dense_retrieval_tpu_torch.core.config import SearchConfig
    from multihop_dense_retrieval_tpu_torch.core.mesh import make_mesh

    paths, _, rows = data
    stage1, index_dir = f"{work}/p2_stage1", f"{work}/p2_index"
    ckpt = f"{stage1}/checkpoint_best.pt"
    mips.reset_launch_counts()
    t0 = time.perf_counter()
    trained = train_p2_retriever(paths, stage1, P_LR, P_EPOCHS, dev)
    t1 = time.perf_counter()
    torch.cuda.empty_cache()
    encode_corpus.main([paths["corpus"], index_dir, "--checkpoint", ckpt,
                        "--tokenizer", "hash", "--model-name", "roberta-base",
                        "--batch-size", "256", "--chunk-rows", "4096",
                        "--max-c-len", "64", "--index-dtype", "int8",
                        "--pca-dims", "128", "--device", str(dev)])
    t2 = time.perf_counter()
    assert_no_launches(mips, "p2 training and encoding")
    say(f"  p2 roberta-base retriever: train {t1 - t0:.1f} s ({P_EPOCHS} "
        f"epochs, lr {P_LR}: best train MRR {trained['best_mrr']:.4f}, final "
        f"loss {trained['final_loss']:.4f}), encode {t2 - t1:.1f} s "
        f"({P_DOCS} docs, int8 + PCA 128) [{smi}]")

    tok = common.resolve_tokenizer("hash")
    model = common.init_retriever(common.resolve_encoder_config(
        "roberta-base"), checkpoint=ckpt, device=dev)
    questions = [r["question"][:-1] if r["question"].endswith("?")
                 else r["question"] for r in rows]
    cfg = SearchConfig(beam_size_1=B4, beam_size_2=B4, topk=B4,
                       batch_size=P_BATCH, max_q_len=24, max_q_sp_len=80,
                       chunk_rows=4096, hop2_buckets=(32, 48, 64, 80),
                       hop2_tile_fracs=(0.25, 0.375, 0.25, 0.125),
                       use_pca=True, pca_hops="auto")
    engine = load_searcher(index_dir, tok, model, cfg, dev)
    index = engine.index
    counts = {}
    t3 = time.perf_counter()
    mips.reset_launch_counts()
    base, cert, n_pca, _, first = trained_batches(engine, tok, questions,
                                                  index, mips)
    counts["trained_p2"] = leg_counts(mips)
    launched = {k: counts["trained_p2"][k] for k in search_kernels(mips)}
    assert all(launched[k] > 0 for k in ("mips_scan_int8", "pca_chunk_max",
                                         "pca_rescan_int8")) and not any(
        n for k, n in launched.items() if k not in (
            "mips_scan_int8", "pca_chunk_max", "pca_rescan_int8")), launched
    say(f"  p2 unpruned: {n_pca} hop-2 queries of {len(questions)} "
        f"questions, {cert} certified ({cert / n_pca:.4f}); hop 1 = exact "
        f"scan, hop-2 scores = "
        f"rescan-order products, certified = exact top-1, kernels 3/4 = "
        f"plain; {time.perf_counter() - t3:.1f} s; launches "
        f"{json.dumps(counts['trained_p2'])} [{smi}]")
    ref = jax_record("prune_sweep_r5.json")
    base_chains = chains(base, mips.NEG_INF)
    for name, margin in (("auto", -0.5), ("auto:0.9", -0.9)):
        eng = load_searcher(index_dir, tok, model, dataclasses.replace(
            cfg, hop2_prune_margin=margin), dev)
        out, _, _, pruned, _ = trained_batches(eng, tok, questions, index,
                                               mips, margin)
        agree = float(np.mean([a == b for a, b in zip(
            chains(out, mips.NEG_INF), base_chains)]))
        jax = ref[f"margin_auto_injit_q{-margin}"]
        say(f"  p2 {name}: pruned share {pruned:.4f}, chain agreement with "
            f"the unpruned engine {agree:.4f} (JAX mini on TPU: "
            f"{jax['pruned_frac']} / {jax['chain_agreement']}) [{smi}]")
        del eng

    mesh = make_mesh(index=P_SHARDS, devices=shard_devices(dev, P_SHARDS))
    sharded = load_searcher(index_dir, tok, model, cfg, dev, mesh=mesh)
    mips.reset_launch_counts()
    got, cert_s, n_s, _, _ = trained_batches(sharded, tok, questions, index,
                                             mips)
    counts["trained_p2_shards"] = leg_counts(mips)
    # hop 1 is the beam's candidates; a chain's hop-1 id follows hop 2,
    # whose uncertified rows may differ over shards
    for key in ("hop1_cand_ids", "hop1_cand_scores"):
        assert np.array_equal(got[key], base[key]), \
            f"p2 over {P_SHARDS} shards: {key} differ from the unsharded"
    say(f"  p2 over {P_SHARDS} row shards on {dev}: hop 1 bit-equal to the "
        f"unsharded engine; {cert_s} of {n_s} hop-2 queries certified "
        f"({cert_s / n_s:.4f}; unsharded {cert / n_pca:.4f}; random weights "
        f"n1: 0 of 192); launches {json.dumps(counts['trained_p2_shards'])} "
        f"[{smi}]")
    return counts, first


def run_fidelity(mips, dev, smi, work):
    """Leg (p3): fidelity_trained_torch at its defaults (the mini reader,
    offsets 64-448) but P3_EPOCHS epochs and P3_NQ_EVAL eval questions an
    offset: the
    one-stage read, the (rank width x offset) matrix and bf16-vs-fp32
    agreement beside docs/fidelity_r5.json.  No MIPS kernel runs (the
    reader reads on the xla attention)."""
    fs = load_script("fidelity_trained_torch")
    mips.reset_launch_counts()
    t0 = time.perf_counter()
    with scoped_env(FIDELITY_OUT=f"{work}/p3.json", FIDELITY_DEVICE=str(dev),
                    FIDELITY_EPOCHS=str(P3_EPOCHS),
                    FIDELITY_NQ_EVAL=str(P3_NQ_EVAL)):
        res = fs.main()
    counts = assert_no_launches(mips, "p3")
    ref = jax_record("fidelity_r5.json")
    say(f"  p3 fidelity_trained_torch: {time.perf_counter() - t0:.1f} s; "
        f"{res['n_questions']} questions [{smi}]")
    offs = [str(o) for o in res["offsets"]]
    say("    one-stage chain_em / em: " + ", ".join(
        f"{o}: {res['one_stage'][o]['chain_em']:.3f}/"
        f"{res['one_stage'][o]['em']:.3f} (JAX "
        f"{ref['one_stage'][o]['chain_em']}/{ref['one_stage'][o]['em']})"
        for o in offs))
    for tag, row in res["matrix"].items():
        say(f"    {tag} agreement: " + ", ".join(
            f"{o}: {row[o]['agreement']:.3f} (JAX "
            f"{ref['matrix'][tag][o]['agreement']})" for o in offs))
    say("    bf16 scores agreement: " + ", ".join(
        f"{o}: {res['bf16_scores'][o]} (JAX {ref['bf16_scores'][o]})"
        for o in offs))
    return counts


# p1 and p3 run in processes of their own beside p2, whose host work they
# overlap: each writes its lines to a log, which the parent echoes, and
# ends with "P_RESULT <its launch counts as JSON>"
P_CHILD = r"""
import importlib, json, sys
import torch
import chip_smoke as cs
from multihop_dense_retrieval_tpu_torch.ops import mips
cs.track_routes(mips, importlib.import_module(
    "multihop_dense_retrieval_tpu_torch.ops.fused_attention"))
name, work, smi = sys.argv[1:4]
out = getattr(cs, name)(mips, torch.device("cuda", 0), smi, work)
print("P_RESULT " + json.dumps(out), flush=True)
"""
P_SUB_TIMEOUT = 900


def p1_sub_leg(mips, dev, smi, work):
    os.makedirs(f"{work}/p1")
    return {"trained_p1": run_prune_sweep(load_script("prune_sweep_torch"),
                                          mips, dev, smi, f"{work}/p1")}


def p3_sub_leg(mips, dev, smi, work):
    return {"trained_p3": run_fidelity(mips, dev, smi, work)}


def start_sub_leg(name, smi, work):
    """Start the sub-leg function ``name`` in a process of its own; its
    output goes to work/<name>.log."""
    with open(f"{work}/{name}.log", "w") as log:
        return subprocess.Popen(
            [sys.executable, "-c", P_CHILD, name, work, smi],
            cwd=Path(__file__).resolve().parent, stdout=log,
            stderr=subprocess.STDOUT, text=True)


def join_sub_leg(proc, name, work):
    """Wait for a sub-leg's process, echo its own lines (the indented ones
    and the scripts' stage seconds); fail with its log's tail if it
    failed.  Returns its launch counts."""
    proc.wait(timeout=P_SUB_TIMEOUT)
    lines = Path(f"{work}/{name}.log").read_text().splitlines()
    assert proc.returncode == 0, \
        f"{name} exited {proc.returncode}:\n" + "\n".join(lines[-40:])
    for line in lines:
        if line.startswith(("  ", "== trained", "== encoded", "== measured")):
            say(line[:2000])
    (res,) = [x for x in lines if x.startswith("P_RESULT ")]
    return json.loads(res[len("P_RESULT "):])


def start_p_sub_legs(smi, tmp):
    """Start p1 and p3 in processes of their own (``start_sub_leg``)."""
    return {name: start_sub_leg(name, smi, tmp)
            for name in ("p1_sub_leg", "p3_sub_leg")}


def stop_processes(procs):
    """Kill whichever of ``procs`` (name -> process) still run."""
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def run_trained_weights(mips, dev, smi, tmp, subs):
    """Leg (p): the trained-weight measurements (p1 the JAX script's own
    scale, p2 the full-width main path, p3 the reader's fidelity).  p1
    and p3 run in processes of their own, ``subs``, started before this
    (``start_p_sub_legs``, in ``tmp``), beside leg o's last steps;
    p2 runs here; kernels 1, 3 and 4 are timed on p2's launches once all
    have ended.  Returns each sub-leg's launch counts."""
    t0 = time.perf_counter()
    ps = load_script("prune_sweep_torch")
    os.makedirs(f"{tmp}/p2")
    data = ps.make_data(f"{tmp}/p2", np.random.RandomState(0), n_docs=P_DOCS,
                        n_train=P_Q, n_key_docs=P_KEYS)
    out, launched = run_trained_full_width(mips, dev, smi, f"{tmp}/p2", data)
    for name, proc in subs.items():
        out.update(join_sub_leg(proc, name, tmp))
    times = time_trained_kernels(launched, mips, smi)
    say("  leg p kernels: " + json.dumps({
        leg: {k: c[k] for k in mips.LAUNCHES if c[k]}
        for leg, c in out.items()} | {"p2_times_ms": {
            k: {"ms": ms, "bound_ms": b, "bound_by": by}
            for k, (ms, b, by) in times.items()}}))
    say(f"  leg p: {time.perf_counter() - t0:.1f} s [{smi}]")
    return out


def write_corpus(path, rng):
    """N_DOCS passages as JSONL: a two-word title and a text of
    synth_doc_lens words (20-300); the hash tokenizer maps each word to
    one id, so the assembled passages span widths up to C_LEN."""
    vocab = np.array([f"w{i}" for i in range(1 << 16)])
    lens = synth_doc_lens(rng, N_DOCS)
    words = vocab[rng.randint(len(vocab), size=int(lens.sum()))]
    with open(path, "w") as f:
        s = 0
        for i, n in enumerate(lens):
            f.write(json.dumps({"title": f"doc {i}",
                                "text": " ".join(words[s:s + n])}) + "\n")
            s += n


def widest_batch(tc, spec, dev):
    """The C_BATCH longest passages, assembled at width C_LEN as the corpus
    encoder assembles them."""
    from multihop_dense_retrieval_tpu_torch.search.beam import \
        assemble_pair_inputs

    total = np.minimum(tc.title_lens, C_LEN) + np.minimum(tc.text_lens, C_LEN)
    idx = np.argsort(total, kind="stable")[-C_BATCH:]
    ids = [torch.from_numpy(np.ascontiguousarray(a[idx], np.int32)).to(dev)
           for a in (tc.title_ids, tc.title_lens, tc.text_ids, tc.text_lens)]
    return assemble_pair_inputs(*ids, C_LEN, spec)


def run_corpus_encoding(port, state, mips, dev, smi, tmp):
    """Leg (e): corpus encoding at roberta-base width over N_DOCS wiki-like
    passages (max_c_len 300, batch 256, length sort on), same weights as
    the other legs.  e1: index.build.build_index on a cls_only retriever
    with attention_impl="fused" (int8, PCA R=128, chunk_rows 4096): kernel
    8 once a layer for every batch.  e2: cli/encode_corpus.main at its
    default ("xla") attention, --index-dtype int8 --pca-dims 128, into a
    temp dir that must load back with N_DOCS docs: no kernel-8 launch.
    On the widest batch the fused encoder is held to the same encoder with
    fused_attention_plain swapped in: in fp32 (the same weights) within
    1e-3 (fp32 sums in another order, through 12 layers); in bf16, whose
    one-ulp roundings of p and o the 12 random layers amplify, every
    vector's cosine >= 0.999 and no entry off by more than 0.1 (entries
    are ~1).  The fused and xla vectors are compared by cosine (reported:
    the xla encoder rounds its scores to bf16, the kernel keeps fp32).  Both
    write into ``tmp``, which leg (g) reads after: e2's index directory and
    the retriever checkpoint ``model.pt``."""
    from multihop_dense_retrieval_tpu_torch.cli import common
    from multihop_dense_retrieval_tpu_torch.cli import encode_corpus as cli
    from multihop_dense_retrieval_tpu_torch.index import build

    enc = importlib.import_module(
        "multihop_dense_retrieval_tpu_torch.models.encoder")
    fa = importlib.import_module(
        "multihop_dense_retrieval_tpu_torch.ops.fused_attention")
    cfgmod, data, index_mod, models, _ = port
    out = {}
    t0 = time.perf_counter()
    write_corpus(f"{tmp}/corpus.jsonl", np.random.RandomState(11))
    torch.save(state, f"{tmp}/model.pt")
    tok = common.resolve_tokenizer("hash")
    tc = data.TokenizedCorpus.build(
        data.Corpus.from_jsonl(f"{tmp}/corpus.jsonl"), tok,
        max_text_len=C_LEN)
    say(f"  corpus set-up: {N_DOCS} docs written and tokenized in "
        f"{time.perf_counter() - t0:.1f} s; text lengths mean "
        f"{tc.text_lens.mean():.1f}, max {tc.text_lens.max()}")
    fused = models.MhopRetriever(cfgmod.EncoderConfig.roberta_base(
        attention_impl="fused"), cls_only=True)
    fused.load_state_dict(state)
    fused = fused.to(dev).eval()

    # e1: build_index with the fused encoder; the encode timed alone
    enc_secs, encode = [], build.encode_corpus

    def timed_encode(*a, **kw):
        t = time.perf_counter()
        res = encode(*a, **kw)          # host array: the device is done
        enc_secs.append(time.perf_counter() - t)
        return res

    build.encode_corpus = timed_encode
    torch.cuda.synchronize()
    mips.reset_launch_counts()
    t1 = time.perf_counter()
    try:
        index = build.build_index(
            fused.encode_seq, tc, tok.spec, max_c_len=C_LEN,
            batch_size=C_BATCH, chunk_rows=4096, dtype="int8",
            pca_dims=R, pca_cand_rows=CAND, device=dev)
        torch.cuda.synchronize()
    finally:
        build.encode_corpus = encode
    e1 = time.perf_counter() - t1
    out["corpus_e1"] = leg_counts(mips)
    n_batches = -(-N_DOCS // C_BATCH)
    assert index.n_docs == N_DOCS and index.vectors.dtype == torch.int8
    assert bool(torch.isfinite(index.scales).all())
    say(f"  e1 build_index (fused): encode {N_DOCS / enc_secs[0]:.1f} "
        f"docs/s ({enc_secs[0]:.2f} s), build_index {N_DOCS / e1:.1f} "
        f"docs/s ({e1:.2f} s), {n_batches} batches [{smi}]")
    say(f"  e1 launches: {json.dumps(out['corpus_e1'])}")
    assert out["corpus_e1"]["fused_attention"] == \
        fused.config.num_layers * n_batches, \
        "kernel 8 did not run once a layer for every batch"
    del index

    # e2: the CLI at its default attention
    torch.cuda.synchronize()
    mips.reset_launch_counts()
    t2 = time.perf_counter()
    cli.main([f"{tmp}/corpus.jsonl", f"{tmp}/e2", "--tokenizer", "hash",
              "--model-name", "roberta-base", "--checkpoint",
              f"{tmp}/model.pt", "--index-dtype", "int8", "--pca-dims",
              str(R)])
    torch.cuda.synchronize()
    e2 = time.perf_counter() - t2
    out["corpus_e2"] = leg_counts(mips)
    index = index_mod.DenseIndex.load(f"{tmp}/e2/index.npz", device=dev)
    tc2 = data.TokenizedCorpus.load(f"{tmp}/e2/tokens.npz")
    with open(f"{tmp}/e2/id2doc.json") as f:
        n_id2doc = len(json.load(f))
    assert index.n_docs == tc2.text_ids.shape[0] == n_id2doc == N_DOCS
    assert index.pca_proj is not None and index.vectors.dtype == torch.int8
    say(f"  e2 cli/encode_corpus (xla): {N_DOCS / e2:.1f} docs/s for the "
        f"whole CLI ({e2:.2f} s: tokenize, encode, int8 + PCA build, "
        f"save); the directory loads with {index.n_docs} docs [{smi}]")
    say(f"  e2 launches: {json.dumps(out['corpus_e2'])}")
    assert out["corpus_e2"]["fused_attention"] == 0, \
        "kernel 8 ran under the default attention"
    del index

    # the widest batch: kernel against plain inside the encoder (bf16,
    # and fp32 with the same weights); fused against xla
    inputs = widest_batch(tc, tok.spec, dev)
    ids, am = inputs["input_ids"], inputs["attention_mask"]
    kernel = enc.fused_attention
    cosine = torch.nn.functional.cosine_similarity

    def twin_gap(model):
        with torch.inference_mode():
            got = model.encode_seq(ids, am)
            enc.fused_attention = fa.fused_attention_plain
            try:
                twin = model.encode_seq(ids, am)
            finally:
                enc.fused_attention = kernel
        assert bool(torch.isfinite(got).all())
        return (got, (got - twin).abs().max().item(),
                cosine(got, twin).min().item())

    v_fused, gap16, cos16 = twin_gap(fused)
    fused32 = models.MhopRetriever(cfgmod.EncoderConfig.roberta_base(
        attention_impl="fused", dtype="float32"), cls_only=True)
    fused32.load_state_dict(state)
    _, gap32, cos32 = twin_gap(fused32.to(dev).eval())
    xla = common.init_retriever(common.resolve_encoder_config(
        "roberta-base"), checkpoint=f"{tmp}/model.pt", device=dev)
    with torch.inference_mode():
        cos_xla = cosine(v_fused, xla.encode_seq(ids, am))
    say(f"  widest batch ({C_BATCH} x {C_LEN}), fused encoder vs its "
        f"plain twin: bf16 max abs {gap16:.4g}, min cosine {cos16:.6f}; "
        f"fp32 max abs {gap32:.4g}, min cosine {cos32:.8f}; fused vs xla "
        f"(bf16) cosine min {cos_xla.min().item():.6f}, median "
        f"{cos_xla.median().item():.6f}")
    assert gap32 <= 1e-3, f"fp32 fused encoder off its twin by {gap32}"
    assert cos16 >= 0.999 and gap16 <= 0.1, \
        f"bf16 fused encoder off its twin: {gap16}, cosine {cos16}"
    return out


def _http(url, payload=None):
    """One request to the leg-g server: (status, JSON reply)."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _fire(url, payloads):
    """All ``payloads`` at once, one thread each; the replies in order."""
    with concurrent.futures.ThreadPoolExecutor(len(payloads)) as pool:
        return list(pool.map(lambda p: _http(url, p), payloads))


def qa_questions(tmp, rng, n):
    """Questions cut from the corpus texts: 6-16 words of a random
    passage, and a word of it as the gold answer."""
    with open(f"{tmp}/corpus.jsonl") as f:
        texts = [json.loads(l)["text"].split() for l in f]
    out = []
    for i in rng.randint(len(texts), size=n):
        words = texts[i]
        n_w = rng.randint(6, 17)
        s = rng.randint(max(1, len(words) - n_w))
        out.append((" ".join(words[s:s + n_w]) + "?", words[s]))
    return out


def run_qa_serving(mips, dev, smi, tmp):
    """Leg (g): question answering with the ELECTRA-large reader (24 x
    1024, seeded random weights made on the card, bf16 with bf16 attention
    scores) over leg e2's index directory (N_DOCS passages, int8 + PCA
    R=128) and retriever checkpoint, at the serving CLIs' defaults (beam 5,
    top 5 chains, max_seq_len 512, --rank-topm 0) with --pca and hash
    tokenizers (the reader's at its vocabulary of 30,522).
    g1, the server (cli/serve.py's parse_args, DemoPipeline and make_server
    on 127.0.0.1, port 0, --max-batch 16, in a thread): /healthz; 64
    concurrent /answer (each 5 chains of 2 titles and an answer string,
    micro-batched; the reader's rank and span scores finite); 16 /retrieve;
    /add_doc (8,192 rows fill their chunks: the index grows), whose own
    vector, encoded as the pipeline encodes it, is the plain scan's top-1
    at its new id; 16 /retrieve over the grown index (n_docs inside a
    chunk); /delete_doc of a middle document (the last moves in: id table
    and n_docs agree, no later search returns an id >= n_docs); 16
    /retrieve.  Every hop of those requests is held to the plain scans over
    the index as it stood (check_recorded_hops), and every launch of
    kernels 3 and 4 to its plain version (check_recorded_launches).
    Kernels 3 and 4 serve
    both hops: with 80 hop-2 rows there are no hop-2 buckets, so
    pca_hops="auto" filters hop 1 too.  After the counted requests, the
    added document's vector, now at the middle id, through the engine's
    exact hop-1 search (kernel 1 over the grown index) is bit-equal to the
    plain scan, and the PCA tier is held to that id when certified; one
    micro-batch is profiled (device ms of retrieval and of the reader,
    idle share, peak memory).
    g2, the CLI: cli/end2end.main over 64 questions at batch 16 (no --pca:
    exact scans, kernel 1 at both hops) exits 0 and prints its metrics;
    every hop it ran is bit-equal to the plain scan."""
    from multihop_dense_retrieval_tpu_torch.cli import demo, end2end, serve
    from multihop_dense_retrieval_tpu_torch.core.config import EncoderConfig
    from multihop_dense_retrieval_tpu_torch.search.beam import BeamSearcher

    out = {}
    rng = np.random.RandomState(21)
    qs = qa_questions(tmp, rng, N_ANSWERS + N_RETRIEVE)
    t0 = time.perf_counter()
    args = serve.parse_args([
        f"{tmp}/e2", "--tokenizer", "hash", "--retriever-model",
        "roberta-base", "--retriever-checkpoint", f"{tmp}/model.pt",
        "--reader-model", "electra-large", "--pca", "--port", "0",
        "--max-batch", str(QA_BATCH)])
    pipe = demo.DemoPipeline(args)
    rc = pipe.reader.config
    assert rc == EncoderConfig.electra_large(
        attention_scores_dtype="bfloat16"), rc
    assert next(pipe.reader.parameters()).device.type == dev.type
    assert pipe.q_tok.spec.vocab_size == rc.vocab_size
    cfg = pipe.searcher.config
    assert (cfg.beam_size_1, cfg.topk, args.max_seq_len, args.rank_topm,
            cfg.use_pca, cfg.hop2_buckets) == (5, 5, 512, 0, True, ())
    n_params = sum(p.numel() for p in pipe.reader.parameters())
    srv = serve.make_server(pipe, args.host, args.port,
                            max_batch=args.max_batch,
                            batch_wait_ms=args.batch_wait_ms)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_port}"
    say(f"  g1 set-up: DemoPipeline (roberta-base retriever, {N_DOCS}-doc "
        f"int8 + PCA index, electra-large reader: {rc.num_layers} x "
        f"{rc.hidden_size}, {n_params / 1e6:.1f}M parameters made on the "
        f"card) and server in {time.perf_counter() - t0:.1f} s")

    # what the worker ran: per micro-batch its size and times, the reader's
    # scores, and every search's ids
    batches, scores, searched = [], [], []
    answer_batch, pred_step = pipe.answer_batch, pipe.pred_step
    search = pipe.searcher.search

    def recorded_batch(questions, pad_to=None):
        res = answer_batch(questions, pad_to)
        batches.append((len(questions), res[0]["retrieval_s"],
                        res[0]["reading_s"]))
        return res

    def recorded_step(batch):
        res = pred_step(batch)
        scores.append((res["rank_score"], res["span_score"]))
        return res

    def recorded_search(*a):
        res = search(*a)
        searched.append((res["hop1_ids"], res["hop2_ids"]))
        return res

    pipe.answer_batch, pipe.pred_step = recorded_batch, recorded_step
    pipe.searcher.search = recorded_search
    launched, restore_launches = record_launches(
        mips, ("pca_chunk_max", "pca_rescan_int8"))
    try:
        code, health = _http(f"{url}/healthz")
        assert code == 200 and health["n_docs"] == N_DOCS, health
        code, warm = _http(f"{url}/answer", {"question": qs[0][0]})
        assert code == 200, warm
        torch.cuda.synchronize()
        say(f"  g1 /healthz ok ({health['n_docs']} docs); warm-up /answer "
            f"in {warm['retrieval_s'] + warm['reading_s']:.2f} s")
        batches.clear()
        scores.clear()

        def held(stage, seen):
            """Hold a stage's recorded hops against the plain scans over
            the index as it now stands, and clear them."""
            n_scan, n_pca, n_cert = check_recorded_hops(
                seen, pipe.searcher.index, mips)
            n_launch, err3, share3 = check_recorded_launches(launched, mips)
            assert n_pca and n_launch, f"no PCA hop on {stage}"
            say(f"  g1 {stage}: {len(seen)} hops over n_docs "
                f"{pipe.searcher.index.n_docs} held to the plain scans "
                f"({n_pca} PCA rows, {n_cert} certified; {n_scan} scan "
                f"rows); {n_launch} launches of kernels 3 and 4 held to "
                f"their plain versions (kernel 3 max abs err {err3:.3g}, "
                f"{share3:.3f} of its bound; kernel 4 bit-equal)")
            seen.clear()

        seen = record_queries(pipe.searcher, outputs=True)
        launched.clear()
        mips.reset_launch_counts()
        before = _http(f"{url}/healthz")[1]
        t1 = time.perf_counter()
        replies = _fire(f"{url}/answer",
                        [{"question": q} for q, _ in qs[:N_ANSWERS]])
        wall = time.perf_counter() - t1
        after = _http(f"{url}/healthz")[1]
        for code, r in replies:
            assert code == 200, r
            assert isinstance(r["answer"], str), r
            assert len(r["chains"]) == 5 and all(
                len(c) == 2 for c in r["chains"]), r["chains"]
        n_batches = after["batches_run"] - before["batches_run"]
        assert after["questions_run"] - before["questions_run"] == N_ANSWERS
        assert n_batches < N_ANSWERS, "the worker did not micro-batch"
        for rank, span in scores:
            assert bool(torch.isfinite(rank).all()) and \
                bool(torch.isfinite(span).all()), "non-finite reader scores"
        n_chains = 5 * sum(b[0] for b in batches)
        read_s = sum(b[2] for b in batches)
        sizes = [b[0] for b in batches]
        say(f"  g1 {N_ANSWERS} concurrent /answer: {N_ANSWERS / wall:.2f} "
            f"answers/s ({wall:.2f} s, host clock), {n_batches} micro-"
            f"batches of {sizes}; median retrieval_s "
            f"{np.median([r['retrieval_s'] for _, r in replies]):.3f}, "
            f"median reading_s "
            f"{np.median([r['reading_s'] for _, r in replies]):.3f}; reader "
            f"{n_chains / read_s:.1f} chains/s over {n_chains} chains; "
            f"{len(scores)} reader batches, rank and span scores finite; "
            f"e.g. answer {replies[0][1]['answer'][:40]!r} [{smi}]")
        held("/answer", seen)

        def retrieve(stage):
            replies = _fire(f"{url}/retrieve",
                            [{"question": q} for q, _ in qs[N_ANSWERS:]])
            for code, r in replies:
                assert code == 200 and len(r["chains"]) == 5, r
            say(f"  g1 {N_RETRIEVE} concurrent /retrieve {stage}: ok, median "
                f"retrieval_s "
                f"{np.median([r['retrieval_s'] for _, r in replies]):.3f}")
            held(f"/retrieve {stage}", seen)

        retrieve("before the updates")

        title = "added doc"
        text = " ".join(f"w{i}" for i in rng.randint(1 << 16, size=120))
        code, added = _http(f"{url}/add_doc", {"title": title, "text": text})
        assert code == 200 and added == {"doc_id": N_DOCS,
                                         "n_docs": N_DOCS + 1}, added
        index = pipe.searcher.index
        assert index.vectors.shape[0] == N_DOCS + 4096, index.vectors.shape
        # the added document's own vector, encoded as the pipeline encodes
        # it, is the exact top-1 at its new id (plain scan: no launch)
        vec = torch.from_numpy(pipe.encode_passage(title, text)).to(dev)
        qi, qsc = mips.quantize_rows(vec)
        ev, ei = mips.mips_scan_int8_plain(qi, qsc, index.vectors,
                                           index.scales, 1, index.n_docs)
        assert int(ei[0, 0]) == N_DOCS, ei
        say(f"  g1 /add_doc: id {added['doc_id']}, index grown to "
            f"{index.vectors.shape[0]} rows; its own vector's exact top-1 "
            f"is id {int(ei[0, 0])}")
        retrieve("after /add_doc (n_valid inside a chunk)")

        searched.clear()
        middle = N_DOCS // 2
        code, deleted = _http(f"{url}/delete_doc", {"doc_id": middle})
        assert code == 200 and deleted == {"moved_doc_id": N_DOCS,
                                           "n_docs": N_DOCS}, deleted
        assert pipe.corpus.docs[middle]["title"] == title
        assert len(pipe.corpus.docs) == pipe.searcher.index.n_docs == N_DOCS
        retrieve("after /delete_doc")
        top = max(int(max(h1.max(), h2.max())) for h1, h2 in searched)
        assert searched and top < N_DOCS, top
        torch.cuda.synchronize()
        out["qa_serving"] = leg_counts(mips)
        say(f"  g1 /delete_doc {middle}: moved {deleted['moved_doc_id']}, "
            f"n_docs {deleted['n_docs']} = id table; {len(searched)} later "
            f"searches, largest id returned {top}")
        say(f"  g1 launches: {json.dumps(out['qa_serving'])}")
        for name in ("pca_chunk_max", "pca_rescan_int8"):
            assert out["qa_serving"][name] > 0, f"{name} not launched on g1"

        # check launches (not counted): the added document, now at id
        # `middle`, through the engine's exact hop-1 search (kernel 1 over
        # the grown index) against the plain scan, and through its PCA tier
        index = pipe.searcher.index
        vals, docs, _ = pipe.searcher._mips(vec, 1, pca=False)
        ev, ei = mips.mips_scan_int8_plain(qi, qsc, index.vectors,
                                           index.scales, 1, index.n_docs)
        assert int(docs[0, 0]) == int(ei[0, 0]) == middle, (docs, ei)
        assert torch.equal(vals, ev), (vals, ev)
        pv, pd, cert = pipe.searcher._mips(vec, 1, pca=True)
        assert not bool(cert[0]) or int(pd[0, 0]) == middle, (pd, cert)
        held("the added document's PCA tier", seen)
        say(f"  g1 the added document at id {middle}: its own vector is the "
            f"exact hop-1 top-1 through kernel 1, score "
            f"{float(vals[0, 0]):.4f}, bit-equal to the plain scan; the PCA "
            f"tier returns id {int(pd[0, 0])} (certified: {bool(cert[0])})")

        # one micro-batch, unprofiled and then under the profiler
        mb = [q for q, _ in qs[:QA_BATCH]]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        recorded_batch(mb, QA_BATCH)
        batch_ms = (time.perf_counter() - t2) * 1e3
        profile_qa_batch(pipe, mb, batch_ms, smi)
    finally:
        pipe.answer_batch, pipe.pred_step = answer_batch, pred_step
        pipe.searcher.search = search
        pipe.searcher.__dict__.pop("_mips", None)
        restore_launches()
        srv.shutdown()
        srv.server_close()
        srv.engine_worker.stop()
        thread.join(timeout=60)
    assert not thread.is_alive() and not srv.engine_worker.is_alive()
    del pipe, srv
    torch.cuda.empty_cache()

    # g2: the end2end CLI
    with open(f"{tmp}/qas.jsonl", "w") as f:
        for i, (q, a) in enumerate(qs[:N_ANSWERS]):
            f.write(json.dumps({"_id": f"g{i}", "question": q,
                                "answer": [a]}) + "\n")
    torch.cuda.synchronize()
    mips.reset_launch_counts()
    printed = io.StringIO()
    t3 = time.perf_counter()
    with contextlib.redirect_stdout(printed), \
            recorded_engines(BeamSearcher) as seen:
        res = end2end.main([
            f"{tmp}/qas.jsonl", f"{tmp}/e2", "--tokenizer", "hash",
            "--retriever-model", "roberta-base", "--retriever-checkpoint",
            f"{tmp}/model.pt", "--reader-model", "electra-large",
            "--batch-size", str(QA_BATCH), "--save-path",
            f"{tmp}/g2_preds.jsonl"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t3
    out["qa_end2end"] = leg_counts(mips)
    line = json.loads(printed.getvalue().strip().splitlines()[-1])
    assert line == res and res["n"] == N_ANSWERS, line
    assert res["answer_em"] is not None and np.isfinite(res["answer_f1"])
    say(f"  g2 cli/end2end.main over {N_ANSWERS} questions at batch "
        f"{QA_BATCH}: {secs:.1f} s; metrics line {json.dumps(res)} [{smi}]")
    say(f"  g2 launches: {json.dumps(out['qa_end2end'])}")
    assert out["qa_end2end"]["mips_scan_int8"] > 0, "kernel 1 not launched"
    index = seen[0][0]
    assert all(r[0] is index for r in seen)
    shapes = sorted({(r[1].shape[0], r[2]) for r in seen})
    n_scan, n_pca, _ = check_recorded_hops([r[1:] for r in seen], index, mips)
    assert n_scan and not n_pca, (n_scan, n_pca)
    say(f"  g2 {len(seen)} hops (B, k in {shapes}) through kernel 1: ids "
        f"and scores bit-equal to the plain scan")
    return out


def profile_qa_batch(pipe, questions, batch_ms, smi):
    """One micro-batch of answer_batch in two profiled windows: its 2-hop
    retrieval, then its reading over those chains (the same calls that
    answer_batch makes).  Device ms of each (the sum of its kernels and
    copies), the device's idle share of the unprofiled ``batch_ms``, peak
    memory, and the largest kernels of each window."""
    torch.cuda.reset_peak_memory_stats()
    chains, _, retr_k = device_kernels(
        lambda: pipe._chains(questions, QA_BATCH))
    own = pipe._chains
    pipe._chains = lambda qs, pad_to: chains
    try:
        _, _, read_k = device_kernels(
            lambda: pipe.answer_batch(questions, QA_BATCH))
    finally:
        pipe._chains = own
    retr_ms = sum(t for t, _ in retr_k)
    read_ms = sum(t for t, _ in read_k)
    busy = retr_ms + read_ms
    say(f"  g1 profile of one micro-batch of {len(questions)} questions "
        f"({5 * len(questions)} chains): device ms retrieval {retr_ms:.2f}, "
        f"reader {read_ms:.2f} ({read_ms / busy:.3f} of the device time); "
        f"idle share {idle_share(busy, batch_ms):.3f} of the unprofiled "
        f"{batch_ms:.2f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")
    for what, kernels in (("retrieval", retr_k), ("reader", read_k)):
        for t, name in kernels[:5]:
            say(f"    {what} {t:9.3f} ms  {name[:90]}")
    assert read_ms > 0 and retr_ms > 0, "no device time in a window"


def run_int8_two_phase(engine, scfg, q_inputs, q_raw, q_lens, mips, search,
                       n_valid, smi):
    """Leg (d): the int8 index at beam 2 / 20, top 20: hop 1 (B=192, k=2)
    through kernel 1, hop 2 (B=384, k=20) through the two-phase search
    (kernels 7 + 4).  Five timed batches with their own launch counts;
    hop 2 of the last is held against the exact int8 scan on its own query
    vectors, in the two-phase search's epilogue order ((raw * d_scale) *
    q_scale): values bit-equal, ids equal apart from exact ties."""
    cfg = dataclasses.replace(scfg, use_pca=False, beam_size_1=2,
                              beam_size_2=K_F, topk=K_F, chunk_rows=4096)
    eng = search.BeamSearcher(
        encode_fn=engine.encode_fn, index=engine.index,
        text_ids=engine.text_ids, text_lens=engine.text_lens,
        empty=engine.empty, spec=engine.spec, config=cfg,
        device=engine.device)
    eng.search(dict(q_inputs), q_raw, q_lens)              # warm-up
    torch.cuda.synchronize()
    seen = record_queries(eng, outputs=True)
    mips.reset_launch_counts()
    out, secs = timed_batches(eng, q_inputs, q_raw, q_lens, 5)
    launches = leg_counts(mips)
    q2, k, (vals, docs, _) = seen[-1]
    assert q2.shape == (B_I8, D) and k == K_F, (q2.shape, k)
    hold_int8_to_exact_scan(q2, vals, docs, eng.index.vectors,
                            eng.index.scales, eng.index.vectors.shape[0]
                            if n_valid is None else n_valid, mips, True)
    assert np.isfinite(out["path_scores"]).all()
    med = float(np.median(secs))
    say(f"  int8 two-phase leg (beam 2 / {K_F}, top {K_F}): median "
        f"{med * 1e3:.2f} ms/batch over 5 batches of {B} ({B / med:.1f} q/s); "
        f"hop 2 (B={B_I8}, k={K_F}) = exact int8 scan, values bit-equal, ids "
        f"equal [{smi}]")
    say(f"  int8 two-phase launches over 5 batches: {json.dumps(launches)}")
    for name in ("mips_scan_int8", "chunk_max_int8", "pca_rescan_int8"):
        assert launches[name] > 0, f"{name} not launched on leg (d)"
    for name in ("mips_scan", "chunk_max", "rescan", "pca_chunk_max"):
        assert launches[name] == 0, f"{name} ran on leg (d)"
    return launches


def make_claims(rng):
    """Synthetic FEVER claims, 4-40 words (the hash tokenizer maps each
    word to one id, so every claim fits --max-q-len 45)."""
    return [{"id": i, "claim": " ".join(f"c{w}" for w in rng.randint(
        10 ** 6, size=rng.randint(4, CLAIM_LEN - 4)))}
        for i in range(N_CLAIMS)]


def write_fever_index(port, claims, out_dir, gen, dev):
    """An index directory as cli/encode_corpus writes it: index.npz (bf16
    rows of make_rows, PCA R=128 over 512-row chunks), tokens.npz (a
    300-wide synthetic token store) and id2doc.json.  The claims' own
    vectors, encoded as the CLI will (its model from out_dir/model.pt,
    hash tokenizer, --max-q-len 45, batches of 100), are planted as
    N_CLAIMS contiguous rows of one 512-aligned block, so hop 1 must find
    them and hop 2 can certify.  Returns the planted rows."""
    from multihop_dense_retrieval_tpu_torch.cli import common

    cfgmod, data, index_mod, models, search = port
    tok = common.resolve_tokenizer("hash")
    model = common.init_retriever(common.resolve_encoder_config(
        "roberta-base"), checkpoint=f"{out_dir}/model.pt", device=dev)
    vecs = []
    with torch.inference_mode():
        for s in range(0, N_CLAIMS, FEVER_BATCH):
            enc = tok.encode_batch_one(
                [c["claim"] for c in claims[s:s + FEVER_BATCH]], CLAIM_LEN)
            vecs.append(model.encode_seq(
                torch.from_numpy(enc["input_ids"]).to(dev),
                torch.from_numpy(enc["attention_mask"]).to(dev)).cpu())
    emb = make_rows(N_F, gen, dev)
    base = 8 * CAND
    planted = base + np.arange(N_CLAIMS)
    emb[planted] = torch.cat(vecs).numpy()
    del model
    index = index_mod.DenseIndex.build(emb, chunk_rows=4096, dtype="bfloat16",
                                       pca_dims=R, pca_cand_rows=CAND,
                                       device=dev)
    index.save(f"{out_dir}/index.npz")
    del index, emb
    ids, lens, _ = make_token_store(N_F, gen, dev)
    ids = ids.cpu().numpy().view(np.uint16)
    data.TokenizedCorpus(ids, lens.cpu().numpy(), ids[:, :8],
                         np.full(N_F, 8, np.int32), np.zeros(N_F, bool)
                         ).save(f"{out_dir}/tokens.npz")
    data.Corpus([{"title": f"doc {i}", "text": f"text of doc {i}"}
                 for i in range(N_F)]).save_id2doc(f"{out_dir}/id2doc.json")
    with open(f"{out_dir}/claims.jsonl", "w") as f:
        for c in claims:
            f.write(json.dumps(c) + "\n")
    return planted


def hold_to_exact_scan(q, vals, docs, vecs, mips, rows=None):
    """One hop of a bf16 run against the plain exact scan on its own query
    vectors: values within rtol 1e-5 (fp32 sums of exact bf16 products in
    another order), ids equal apart from near-ties (a differing id's plain
    score is within that tolerance of the plain score at its rank).
    `rows` limits the check to those queries.  Returns (queries held, the
    largest relative value difference)."""
    k = vals.shape[1]
    pv, pi = mips.mips_scan_plain(q, vecs, k)
    if rows is not None:
        q, vals, docs, pv, pi = (t[rows] for t in (q, vals, docs, pv, pi))
    tol = 1e-5 * pv.abs().clamp(min=1e-30)
    rel = ((vals - pv).abs() / pv.abs().clamp(min=1e-30)).max().item() \
        if vals.numel() else 0.0
    assert bool(((vals - pv).abs() <= tol).all()), \
        f"values beyond rtol 1e-5: {rel}"
    alt = (q.to(vecs.dtype).float()[:, None, :]
           * vecs[docs.long()].float()).sum(-1)
    assert bool(((docs == pi.long()) | ((alt - pv).abs() <= tol)).all()), \
        "ids differ from the exact scan beyond near-ties"
    return int(q.shape[0]), rel


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def run_fever_cli(port, model, mips, dev, gen, smi, tmp, configs):
    """Leg (c): cli/eval_mhop_fever.main, the normal entry point, over an
    index directory it writes into ``tmp`` (legs l and n2 search it after),
    twice: c1 exact (hop 1 kernel 2; hop 2 B=200, k=20
    through the two-phase kernels 6 + 5) and c2 with --pca (hop 2 through
    kernels 3 + 5).  Each run has its own launch counts; every MIPS call's
    query vectors and results are recorded (the engine's _mips, patched
    on the class) and held against the plain exact scan.  Each run's
    SearchConfig goes into ``configs`` (leg n2 serves with it)."""
    from multihop_dense_retrieval_tpu_torch.cli import eval_mhop_fever

    search = port[4]
    rng = np.random.RandomState(5)
    claims = make_claims(rng)
    out = {}
    t0 = time.perf_counter()
    torch.save(model.state_dict(), f"{tmp}/model.pt")
    planted = write_fever_index(port, claims, tmp, gen, dev)
    say(f"  FEVER set-up: {N_F}x{D} bf16 index + PCA R={R} + {N_F}x"
        f"{TEXT_LEN} token store + id2doc written in "
        f"{time.perf_counter() - t0:.1f} s; {N_CLAIMS} claims")
    base = [f"{tmp}/claims.jsonl", tmp, "--checkpoint", f"{tmp}/model.pt",
            "--tokenizer", "hash", "--model-name", "roberta-base",
            "--beam-size-1", "2", "--beam-size-2", str(K_F), "--topk",
            str(K_F), "--batch-size", str(FEVER_BATCH)]
    logger = logging.getLogger("mdr_torch")
    for leg, extra in (("fever_c1", []), ("fever_c2", ["--pca"])):
        calls, batches = [], []
        orig, orig_search = search.BeamSearcher._mips, \
            search.BeamSearcher.search

        def _mips(self, queries, k, pca=True):
            res = orig(self, queries, k, pca)
            calls.append((self.index.vectors, queries, k, res))
            return res

        def _search(self, *a):
            # search() returns host arrays, so it ends after the device
            t1 = time.perf_counter()
            res = orig_search(self, *a)
            batches.append((time.perf_counter() - t1, self, a))
            return res

        lines = _Lines()
        logger.addHandler(lines)
        search.BeamSearcher._mips = _mips
        search.BeamSearcher.search = _search
        torch.cuda.synchronize()
        mips.reset_launch_counts()
        try:
            rows = eval_mhop_fever.main(
                base + extra + ["--save-path", f"{tmp}/{leg}.jsonl"])
            torch.cuda.synchronize()
        finally:
            search.BeamSearcher._mips = orig
            search.BeamSearcher.search = orig_search
            logger.removeHandler(lines)
        out[leg] = leg_counts(mips)
        configs[leg] = batches[-1][1].config
        assert len(rows) == N_CLAIMS and all(
            len(r["candidate_chains"]) == K_F for r in rows)
        hop1 = [c for c in calls if c[2] == 2]
        hop2 = [c for c in calls if c[2] == K_F]
        assert len(hop1) == len(hop2) == N_CLAIMS // FEVER_BATCH, \
            len(calls)
        cand = torch.cat([c[3][1] for c in hop1]).cpu().numpy()
        hit = (cand == planted[:, None]).any(1).mean()
        assert hit == 1.0, f"{leg}: planted hop-1 hit rate {hit}"
        checked, cert, rel = 0, [], {1: 0.0, 2: 0.0}
        for hop, (vecs, q, k, (vals, docs, c)) in \
                [(1, x) for x in hop1] + [(2, x) for x in hop2]:
            assert bool(torch.isfinite(vals).all()), leg
            if c is not None:
                cert.append(c)
            n_q, r = hold_to_exact_scan(q, vals, docs, vecs, mips,
                                        None if c is None else c)
            checked += n_q
            rel[hop] = max(rel[hop], r)
        qps = [x for x in lines.lines if "q/s" in x]
        note = "every hop-2 query = exact scan"
        if extra:
            frac = torch.cat(cert).float().mean().item()
            assert frac > 0, f"{leg}: no hop-2 query certified"
            note = (f"hop-2 certified fraction {frac:.4f}, certified = "
                    f"exact scan")
        say(f"  {leg} ({' '.join(extra) or 'exact'}): CLI says "
            f"\"{qps[-1]}\"; planted hop-1 hit rate {hit:.3f}; {note}; "
            f"{checked} MIPS queries held to the exact scan, max relative "
            f"difference hop 1 (kernel 2) {rel[1]:.3g}, hop 2 {rel[2]:.3g} "
            f"[{smi}]")
        say(f"  {leg} launches: {json.dumps(out[leg])}")
        for name in ("mips_scan_int8", "chunk_max_int8",
                     "pca_rescan_int8"):
            assert out[leg][name] == 0, f"{name} ran on {leg}"
        want = ("pca_chunk_max", "rescan") if extra else \
            ("chunk_max", "rescan", "mips_scan")
        missing = [n for n in want if out[leg][n] == 0]
        assert not missing, f"kernels not launched on {leg}: {missing}"
        secs = np.array([b[0] for b in batches])
        say(f"  {leg} search() per batch of {FEVER_BATCH}, host clock: "
            f"{json.dumps([round(x * 1e3, 2) for x in secs])} ms; its "
            f"last batch profiled:")
        profile_batch(batches[-1][1], *batches[-1][2],
                      float(np.median(secs)) * 1e3, smi)
        del calls, hop1, hop2, batches
    return out


# ---- leg n: row-sharded serving, data-parallel encoding, the pod runner ------


def shard_devices(dev, n):
    """n mesh devices: ``dev`` repeated on a one-card host; the cards in
    turn where the host shows more."""
    cards = torch.cuda.device_count()
    if cards > 1:
        return [torch.device("cuda", i % cards) for i in range(n)]
    return [dev] * n


def run_sharded_serving(engine, scfg, q_inputs, q_raw, q_lens, planted, mips,
                        search, qps_a, smi):
    """Leg (n1): leg a's index (kept in memory) re-sharded into N_SHARDS
    row blocks of a mesh (``core.mesh.make_mesh``; on one card every block
    is a view of leg a's rows) behind ``BeamSearcher(mesh=)``, at leg a's
    beam 1 / batch 192 / buckets: N_ITERS timed batches, each MIPS call
    launching kernels 1 (hop 1), 3 and 4 (hop 2) once per shard.  One batch
    is held against leg a's unsharded engine on the same questions (hop 1
    ids and scores bit-equal; where leg a certifies, hop 2's top-1 equal
    to leg a's and to the exact scan's), to the exact scans
    (check_recorded_hops: certified = exact top-1), and each shard's
    kernel 3 and 4 launches to their plain versions; one more profiled.  Then leg
    d's beam 2 / 20 over the same shards (hop 2, B=384, k=20, through
    kernels 7 + 4 on each shard), 5 timed batches bit-equal to leg d's
    unsharded engine; a search with the last two shards all padding
    (n_valid = N/2 - 777) bit-equal to the plain scan; and one add_docs
    (growing the index by lcm(4096, chunk_rows) x N_SHARDS rows) and one
    delete_doc, each followed by a search that finds the updated rows."""
    from multihop_dense_retrieval_tpu_torch.core.mesh import make_mesh

    index, out = engine.index, {}
    mesh = make_mesh(index=N_SHARDS, devices=shard_devices(engine.device,
                                                           N_SHARDS))
    say(f"  n1 mesh: {mesh}; {N_SHARDS} shards of {N // N_SHARDS} rows")

    eng_index = index.shard(mesh)

    def sharded_engine(cfg):
        return search.BeamSearcher(
            encode_fn=engine.encode_fn, index=eng_index,
            text_ids=engine.text_ids, text_lens=engine.text_lens,
            empty=engine.empty, spec=engine.spec, config=cfg, mesh=mesh,
            device=engine.device)

    eng = sharded_engine(scfg)
    eng.search(dict(q_inputs), q_raw, q_lens)             # warm-up
    torch.cuda.synchronize()
    mips.reset_launch_counts()
    _, secs = timed_batches(eng, q_inputs, q_raw, q_lens, N_ITERS)
    out["sharded_int8"] = leg_counts(mips)
    for name in ("mips_scan_int8", "pca_chunk_max", "pca_rescan_int8"):
        assert out["sharded_int8"][name] == N_SHARDS * N_ITERS, \
            f"{name}: {out['sharded_int8'][name]} launches, not one a shard"
    seen = record_queries(eng, outputs=True)
    launched, restore = record_launches(
        mips, ("pca_chunk_max", "pca_rescan_int8"))
    try:
        got = eng.search(dict(q_inputs), q_raw, q_lens)
        torch.cuda.synchronize()
    finally:
        restore()
    ref = engine.search(dict(q_inputs), q_raw, q_lens)
    for key in ("hop1_ids", "hop1_cand_ids", "hop1_cand_scores"):
        assert np.array_equal(got[key], ref[key]), f"n1 {key} differ"
    # Where leg a's engine certifies, the exact top-1 row lies in one of
    # its top k_chunks chunks, so in one of its shard's local top
    # k_chunks, which that shard rescans: the sharded top-1 is the exact
    # one, whatever the sharded certificate (an AND over the shards) says.
    held = ref["pca_cert2"][:, 0]
    assert held.any(), "leg a's engine certified no hop-2 query"
    q2, _, (_, d2, _) = seen[-1]
    qi, qs = mips.quantize_rows(q2)
    _, e2 = mips.mips_scan_int8_plain(qi, qs, index.vectors, index.scales,
                                      1, index.n_docs)
    assert np.array_equal(d2[:, 0].cpu().numpy()[held],
                          e2[:, 0].cpu().numpy()[held]), \
        "n1 hop 2 missed the exact top-1 where leg a's engine certifies"
    for key in ("hop2_ids", "path_scores"):
        assert np.array_equal(got[key][held], ref[key][held]), \
            f"n1 {key} differ where leg a's engine certifies"
    k3 = [a for n_, a, _ in launched if n_ == "pca_chunk_max"]
    assert len(k3) == N_SHARDS and all(
        a[1].shape[0] == N // N_SHARDS for a in k3), \
        "kernel 3 did not run once on each shard's rows"
    n_k, k3_err, k3_share = check_recorded_launches(launched, mips)
    n_scan, n_pca, n_cert = check_recorded_hops(seen, index, mips)
    hit = (got["hop1_ids"][:, 0] == planted).mean()
    assert hit == 1.0, f"n1 planted hit rate {hit}"
    med = float(np.median(secs))
    say(f"  n1 sharded int8 path: median {med * 1e3:.2f} ms/batch over "
        f"{N_ITERS} batches of {B}: {B / med:.1f} q/s (leg a, unsharded: "
        f"{qps_a:.1f} q/s); hop 1 = leg a's (bit-equal); hop 2 certified "
        f"{int(got['pca_cert2'].sum())} of {B}; where leg a's engine "
        f"certifies ({int(held.sum())} of {B}) the sharded top-1 = leg a's "
        f"= exact scan's; {n_scan} scan rows and {n_pca} PCA rows held to "
        f"the exact scans, {n_cert} certified = exact top-1; kernels 3/4 "
        f"held to plain on each shard ({n_k} launches, kernel 3 max abs "
        f"err {k3_err:.3g}, {k3_share:.3g} of its bound) [{smi}]")
    say(f"  n1 launches over {N_ITERS} batches: "
        f"{json.dumps(out['sharded_int8'])}")
    profile_batch(eng, q_inputs, q_raw, q_lens, med * 1e3, smi)

    # leg d's beam 2 / 20 over the shards: kernels 7 + 4 on each
    cfg_d = dataclasses.replace(scfg, use_pca=False, beam_size_1=2,
                                beam_size_2=K_F, topk=K_F, chunk_rows=4096)
    eng_d = sharded_engine(cfg_d)
    ref_d = search.BeamSearcher(
        encode_fn=engine.encode_fn, index=index, text_ids=engine.text_ids,
        text_lens=engine.text_lens, empty=engine.empty, spec=engine.spec,
        config=cfg_d, device=engine.device)
    eng_d.search(dict(q_inputs), q_raw, q_lens)            # warm-up
    torch.cuda.synchronize()
    mips.reset_launch_counts()
    got_d, secs_d = timed_batches(eng_d, q_inputs, q_raw, q_lens, 5)
    out["sharded_two_phase"] = leg_counts(mips)
    for name in ("mips_scan_int8", "chunk_max_int8", "pca_rescan_int8"):
        assert out["sharded_two_phase"][name] == N_SHARDS * 5, \
            f"{name}: {out['sharded_two_phase'][name]} launches on n1 d"
    exp_d = ref_d.search(dict(q_inputs), q_raw, q_lens)
    for key, val in exp_d.items():
        assert np.array_equal(got_d[key], val), f"n1 two-phase {key} differ"
    med_d = float(np.median(secs_d))
    say(f"  n1 two-phase (beam 2 / {K_F} over {N_SHARDS} shards): median "
        f"{med_d * 1e3:.2f} ms/batch ({B / med_d:.1f} q/s); every output "
        f"bit-equal to leg d's unsharded engine [{smi}]")
    say(f"  n1 two-phase launches over 5 batches: "
        f"{json.dumps(out['sharded_two_phase'])}")

    # shards of padding only: kernel 1 at n_valid = 0 on shards 2 and 3
    q1 = seen[0][0]
    n_valid = N // 2 - 777
    v, i = mips.sharded_mips_topk(eng_index.vectors, q1, 4, mesh,
                                  n_valid=n_valid, doc_scales=eng_index.scales)
    qi, qs = mips.quantize_rows(q1)
    ev, ei = mips.mips_scan_int8_plain(qi, qs, index.vectors, index.scales,
                                       4, n_valid)
    assert torch.equal(v, ev) and torch.equal(i, ei), \
        "a search with all-padding shards differs from the plain scan"

    # live updates on the sharded engine
    new = (2 * q1[:1]).cpu().numpy()
    ids = eng.add_docs(new, np.full((1, 8), 11, np.int64),
                       np.array([8], np.int32))
    grown = eng.index.vectors.shape[0]
    assert ids == [N] and grown > N and grown % N_SHARDS == 0
    after = eng.search(dict(q_inputs), q_raw, q_lens)
    assert after["hop1_ids"][0, 0] == N, "the added row is not question 0's"
    moved = eng.delete_doc(int(planted[1]))
    assert moved == N and eng.index.n_docs == N
    after = eng.search(dict(q_inputs), q_raw, q_lens)
    assert after["hop1_ids"][0, 0] == planted[1], "the moved row is lost"
    for key in ("hop1_ids", "hop2_ids"):
        assert (after[key] < N).all(), f"a deleted row came back in {key}"
    say(f"  n1 updates: add_docs grew {N} rows to {grown} (each shard's "
        f"block rebuilt on its device) and question 0 found the new row; "
        f"delete_doc({planted[1]}) moved it into the freed slot, where "
        f"question 0 found it; search with shards 2-3 all padding = plain "
        f"scan [{smi}]")
    return out


def hold_chains(got, exp):
    """Two bf16 engines' chains: path scores within rtol 1e-5 (fp32 sums of
    exact bf16 products in another order), ids equal apart from near-ties
    (a differing chain's score within 2e-5 of a neighbour's).  Returns the
    chains that differ."""
    ps = exp["path_scores"]
    assert np.allclose(got["path_scores"], ps, rtol=1e-5, atol=0), \
        "chain scores beyond rtol 1e-5"
    diff = (got["hop1_ids"] != exp["hop1_ids"]) | \
        (got["hop2_ids"] != exp["hop2_ids"])
    close = np.abs(np.diff(ps, axis=1)) <= 2e-5 * np.abs(ps[:, 1:])
    near = np.zeros_like(diff)
    near[:, 1:] |= close
    near[:, :-1] |= close
    assert not (diff & ~near).any(), "chains differ beyond near-ties"
    return int(diff.sum())


def run_sharded_fever(mips, dev, smi, tmp, configs, leg_c):
    """Leg (n2): cli/eval_mhop_retrieval.load_searcher, the eval CLIs'
    library path, with a mesh of N_SHARDS shards over leg c's directory
    (262,144 bf16 rows + PCA) and leg c's own SearchConfigs (beam 2 / 20,
    batch 100): exact (hop 1 kernel 2, hop 2 kernels 6 + 5 on each shard)
    and --pca (hop 2 kernels 3 + 5 on each shard), over the 500 claims.
    Each run's launch counts, every kernel N_SHARDS times leg c's count
    (``leg_c``); every MIPS call held to the plain exact scan
    (certified queries for --pca); every batch's chains held to the
    unsharded engine's (hold_chains), whose batches are timed alike.  On a host with N >= 2 cards, also
    cli/eval_mhop_fever --index-shards N (the shards over its cards)."""
    from multihop_dense_retrieval_tpu_torch.cli import common
    from multihop_dense_retrieval_tpu_torch.cli import eval_mhop_fever
    from multihop_dense_retrieval_tpu_torch.cli import \
        eval_mhop_retrieval as emr
    from multihop_dense_retrieval_tpu_torch.core.mesh import make_mesh

    tok = common.resolve_tokenizer("hash")
    model = common.init_retriever(common.resolve_encoder_config(
        "roberta-base"), checkpoint=f"{tmp}/model.pt", device=dev)
    with open(f"{tmp}/claims.jsonl") as f:
        claims = [json.loads(l)["claim"] for l in f]
    mesh = make_mesh(index=N_SHARDS, devices=shard_devices(dev, N_SHARDS))
    say(f"  n2 mesh: {mesh}")
    out = {}
    for leg, key in (("sharded_c1", "fever_c1"), ("sharded_c2", "fever_c2")):
        cfg = configs[key]
        plain = emr.load_searcher(tmp, tok, model, cfg, dev)
        sharded = emr.load_searcher(tmp, tok, model, cfg, dev, mesh=mesh)
        assert sharded.index.mesh == mesh
        seen, secs = record_queries(sharded, outputs=True), []
        sharded.search = _timed(sharded.search, secs)
        torch.cuda.synchronize()
        mips.reset_launch_counts()
        got = [res for _, res in emr.search_batches(
            sharded, tok, claims, FEVER_BATCH, cfg.max_q_len,
            cfg.max_q_sp_len)]
        torch.cuda.synchronize()
        out[leg] = leg_counts(mips)
        n_batches = len(got)
        for name in MMA_KERNELS:
            assert out[leg][name] == N_SHARDS * leg_c[key][name], \
                f"{name}: {out[leg][name]} launches on {leg}, " \
                f"{leg_c[key][name]} on {key}"
        want = ("pca_chunk_max", "rescan") if cfg.use_pca \
            else ("mips_scan", "chunk_max", "rescan")
        assert all(out[leg][name] for name in want), out[leg]
        plain_secs = []
        plain.search = _timed(plain.search, plain_secs)
        exp = [res for _, res in emr.search_batches(
            plain, tok, claims, FEVER_BATCH, cfg.max_q_len,
            cfg.max_q_sp_len)]
        differ = sum(hold_chains(g, e) for g, e in zip(got, exp))
        held, cert = 0, []
        for q, k, (vals, docs, c) in seen:
            if c is not None:
                cert.append(c)
            held += hold_to_exact_scan(q, vals, docs, plain.index.vectors,
                                       mips, c)[0]
        note = "every hop-2 query = exact scan"
        if cfg.use_pca:
            # the AND over shards: a shard of random rows alone seldom
            # certifies its local top-k, so this may be 0 (leg c2: > 0)
            frac = torch.cat(cert).float().mean().item()
            note = f"certified fraction {frac:.4f}, certified = exact"
        med, plain_med = float(np.median(secs)), float(np.median(plain_secs))
        say(f"  {leg} ({'--pca' if cfg.use_pca else 'exact'}, "
            f"{N_SHARDS} shards): {FEVER_BATCH / med:.1f} q/s at the median "
            f"of {n_batches} batches ({med * 1e3:.2f} ms; unsharded "
            f"{FEVER_BATCH / plain_med:.1f} q/s, {plain_med * 1e3:.2f} ms, "
            f"after it); {note}; {held} "
            f"MIPS queries held to the exact scan; chains = the unsharded "
            f"engine's, {differ} of {n_batches * FEVER_BATCH * K_F} apart "
            f"by near-ties [{smi}]")
        say(f"  {leg} launches: {json.dumps(out[leg])}")
        del plain, sharded, seen, got, exp
    cards = torch.cuda.device_count()
    if cards >= 2:
        rows = eval_mhop_fever.main([
            f"{tmp}/claims.jsonl", tmp, "--checkpoint", f"{tmp}/model.pt",
            "--tokenizer", "hash", "--model-name", "roberta-base",
            "--beam-size-1", "2", "--beam-size-2", str(K_F), "--topk",
            str(K_F), "--batch-size", str(FEVER_BATCH), "--index-shards",
            str(cards)])
        planted = 8 * CAND + np.arange(N_CLAIMS)
        hit = np.mean([r["candidate_chains"][0][0][0] == f"doc {p}"
                       for r, p in zip(rows, planted)])
        assert hit == 1.0, f"--index-shards {cards}: hop-1 hit rate {hit}"
        say(f"  n2 cli/eval_mhop_fever --index-shards {cards} over {cards} "
            f"cards: {len(rows)} claims, planted hop-1 hit rate {hit:.3f}")
    return out


def _timed(fn, secs):
    def call(*a):
        t = time.perf_counter()
        res = fn(*a)                  # host arrays: the device is done
        secs.append(time.perf_counter() - t)
        return res
    return call


def run_data_parallel_encoding(port, state, mips, dev, smi, tmp):
    """Leg (n3): index/build.py::encode_corpus over the first N3_DOCS of leg
    e's passages (max_c_len 300, batch 256, length sort) with leg e1's
    fused encoder (kernel 8 once a layer), on one device and then on a
    data mesh of 2 devices (``dev`` twice on one card), each batch split
    in halves: kernel 8 on each data shard, twice the launches.  The rows
    must equal the single-device encode within the encoder's bf16
    tolerance (leg e: cosine >= 0.999, entries within 0.1); how many rows
    are bit-equal and the largest difference are printed.  Writes the
    passages to ``tmp/n3.jsonl`` for leg n4."""
    from multihop_dense_retrieval_tpu_torch.cli import common
    from multihop_dense_retrieval_tpu_torch.core.mesh import make_mesh
    from multihop_dense_retrieval_tpu_torch.index import build

    cfgmod, data, _, models, _ = port
    with open(f"{tmp}/corpus.jsonl") as f, open(f"{tmp}/n3.jsonl", "w") as g:
        for _ in range(N3_DOCS):
            g.write(next(f))
    tok = common.resolve_tokenizer("hash")
    tc = data.TokenizedCorpus.build(data.Corpus.from_jsonl(
        f"{tmp}/n3.jsonl"), tok, max_text_len=C_LEN)
    fused = models.MhopRetriever(cfgmod.EncoderConfig.roberta_base(
        attention_impl="fused"), cls_only=True)
    fused.load_state_dict(state)
    fused = fused.to(dev).eval()
    mesh = make_mesh(data=2, index=1, devices=shard_devices(dev, 2))
    n_batches = -(-N3_DOCS // C_BATCH)
    kw = dict(max_c_len=C_LEN, batch_size=C_BATCH)
    out, embs, secs = {}, {}, {}
    # the encoder calls kernel 8 by the name it imported: point that name at
    # the tracked wrapper (track_routes), so that the template is seen
    enc = importlib.import_module(
        "multihop_dense_retrieval_tpu_torch.models.encoder")
    fa = importlib.import_module(
        "multihop_dense_retrieval_tpu_torch.ops.fused_attention")
    imported, enc.fused_attention = enc.fused_attention, fa.fused_attention
    try:
        for leg, extra in (("encode_one", dict(device=dev)),
                           ("encode_data2", dict(mesh=mesh))):
            torch.cuda.synchronize()
            mips.reset_launch_counts()
            t0 = time.perf_counter()
            embs[leg] = build.encode_corpus(fused.encode_seq, tc, tok.spec,
                                            **kw, **extra)
            secs[leg] = time.perf_counter() - t0
            out[leg] = leg_counts(mips)
    finally:
        enc.fused_attention = imported
    for leg in out:
        shards = 1 if leg == "encode_one" else 2
        assert out[leg]["fused_attention"] == \
            fused.config.num_layers * n_batches * shards, \
            f"{leg}: kernel 8 not once a layer on every data shard"
        taken = out[leg]["routes"].get("fused_attention", [])
        assert taken and set(taken) <= {"mma", "row"}, \
            f"{leg}: kernel 8 took {taken}"
    one, two = (torch.from_numpy(embs[k]) for k in ("encode_one",
                                                    "encode_data2"))
    gap = (two - one).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(two, one).min().item()
    same = (two == one).all(dim=1).float().mean().item()
    assert cos >= 0.999 and gap <= 0.1, \
        f"data-parallel rows off the single-device ones: {gap}, {cos}"
    say(f"  n3 data-parallel encode ({N3_DOCS} passages, mesh {mesh}): "
        f"{N3_DOCS / secs['encode_data2']:.1f} docs/s against "
        f"{N3_DOCS / secs['encode_one']:.1f} on one device; rows bit-equal "
        f"to the single-device encode: {same:.4f} of them, max abs "
        f"difference {gap:.4g}, min cosine {cos:.6f} (bf16 matmuls of 128 "
        f"rows against 256); kernel 8's templates "
        f"{out['encode_data2']['routes']['fused_attention']} [{smi}]")
    say(f"  n3 launches: {json.dumps(out['encode_data2'])} (one device: "
        f"{out['encode_one']['fused_attention']} kernel-8 launches)")
    return {"data_parallel_n3": out["encode_data2"]}


POD = "multihop_dense_retrieval_tpu_torch.cli.pod"

# which collectives gloo carries for CUDA tensors, between 2 processes on
# the card (observation only: the port's backend choice is core.mesh's)
GLOO_PROBE = r"""
import datetime, json, sys, torch
import torch.distributed as dist
dist.init_process_group("gloo", init_method=sys.argv[1], world_size=2,
                        rank=int(sys.argv[2]),
                        timeout=datetime.timedelta(seconds=10))
x = torch.arange(4, dtype=torch.float32, device="cuda") + dist.get_rank()
ops = {
    "all_reduce": lambda: dist.all_reduce(x.clone()),
    "broadcast": lambda: dist.broadcast(x.clone(), 0),
    "all_gather": lambda: dist.all_gather(
        [torch.empty_like(x) for _ in range(2)], x),
    "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
        torch.empty(8, device="cuda"), x),
    "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
        torch.empty(2, device="cuda"), x),
    "all_to_all_single": lambda: dist.all_to_all_single(
        torch.empty_like(x), x),
}
res = {}
for name, fn in ops.items():
    try:
        fn()
        torch.cuda.synchronize()
        res[name] = "ok"
    except Exception as e:
        res[name] = (type(e).__name__ + ": "
                     + (str(e).splitlines() or [""])[0][:100])
print(json.dumps(res), flush=True)
dist.destroy_process_group()
"""


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_processes(argvs, timeout=POD_TIMEOUT):
    """Run one process per argv (each given its rank as {rank} and a free
    rendezvous port as {port}) to completion, each with its own timeout;
    kill the rest on a failure.  Returns their (stdout, stderr)."""
    port = _free_port()
    root = Path(__file__).resolve().parent
    procs = [subprocess.Popen(
        [sys.executable] + [a.replace("{rank}", str(r)).replace(
            "{port}", str(port)) for a in argv],
        cwd=root, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r, argv in enumerate(argvs)]
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            assert p.returncode == 0, \
                f"process exited {p.returncode}:\n{o[-2000:]}\n{e[-3000:]}"
            outs.append((o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return outs


def pod(argv):
    """2 cli/pod processes: on a host with more cards, each on its own
    card (--local-device-ids), so that init_pod takes NCCL."""
    own = ["--local-device-ids", "{rank}"] \
        if torch.cuda.device_count() > 1 else []
    return [["-m", POD, "--coordinator", "localhost:{port}",
             "--num-processes", "2", "--process-id", "{rank}"] + own
            + argv] * 2


def run_pod_runner(smi, tmp):
    """Leg (n4): ``python -m ...cli.pod`` in 2 processes that share the
    card (so core.mesh.init_pod keeps CUDA tensors on gloo; on a host with
    more cards each process takes its own and NCCL), twice.
    encode_corpus over n3's passages (each process one slice, a barrier,
    rank 0 merges): the merged index must equal a single-process
    ``--num-shards 2`` encode + ``--merge-only``, bit for bit.
    eval_mhop_retrieval --index-shards 2 --device cuda:0 over that index
    (one shard a process, the candidates gathered over gloo): its chains
    must equal the single-process 2-shard run's (both shards on cuda:0).
    First, which collectives gloo carries for CUDA tensors (a 2-process
    probe, printed)."""
    from multihop_dense_retrieval_tpu_torch.cli import encode_corpus
    from multihop_dense_retrieval_tpu_torch.cli import \
        eval_mhop_retrieval as emr
    from multihop_dense_retrieval_tpu_torch.index.store import DenseIndex

    t0 = time.perf_counter()
    try:
        outs = run_processes([["-c", GLOO_PROBE, "tcp://localhost:{port}",
                               "{rank}"]] * 2, timeout=150)
        found = outs[0][0].strip().splitlines()[-1]
    except (AssertionError, subprocess.TimeoutExpired) as e:
        # an observation, not a phase: its failure is what it found
        found = f"the probe failed: {str(e)[-300:]}"
    say(f"  n4 gloo with CUDA tensors, 2 processes on the card: {found}")

    model = ["--tokenizer", "hash", "--model-name", "roberta-base",
             "--checkpoint", f"{tmp}/model.pt"]
    enc = [f"{tmp}/n3.jsonl"]
    # one data device in every run, so the pod's and the single process's
    # encodes split no batch differently
    flags = model + ["--index-dtype", "int8", "--data-parallel", "1"]
    t1 = time.perf_counter()
    outs = run_processes(pod(["encode_corpus", *enc, f"{tmp}/n4_pod"] +
                             flags))
    t_pod = time.perf_counter() - t1
    notes = {line.split("# pod: ")[1] for _, e in outs
             for line in e.splitlines() if "# pod: " in line}
    backend = "nccl" if torch.cuda.device_count() > 1 else "gloo"
    assert all(f"over {backend}" in n for n in notes), notes
    for sid in ("0", "1"):
        encode_corpus.main([*enc, f"{tmp}/n4_one", "--num-shards", "2",
                            "--shard-id", sid] + flags)
    encode_corpus.main([*enc, f"{tmp}/n4_one", "--merge-only"] + flags)
    a = DenseIndex.load(f"{tmp}/n4_pod/index.npz", device="cpu")
    b = DenseIndex.load(f"{tmp}/n4_one/index.npz", device="cpu")
    assert a.n_docs == b.n_docs == N3_DOCS
    assert torch.equal(a.vectors, b.vectors) and \
        torch.equal(a.scales, b.scales), \
        "the pod's merged index differs from the single-process merge"
    say(f"  n4 cli.pod encode_corpus (2 processes: {sorted(notes)}): "
        f"{t_pod:.1f} s; the rank-0 merge = the single-process 2-slice "
        f"encode + --merge-only, bit for bit [{smi}]")

    rng = np.random.RandomState(13)
    with open(f"{tmp}/n4_q.jsonl", "w") as f:
        for i in range(N4_Q):
            words = rng.randint(1 << 16, size=rng.randint(4, 30))
            f.write(json.dumps({"_id": str(i), "question": " ".join(
                f"w{w}" for w in words) + "?"}) + "\n")
    args = [f"{tmp}/n4_q.jsonl", f"{tmp}/n4_pod", *model, "--device",
            "cuda:0", "--index-shards", "2"]
    t2 = time.perf_counter()
    run_processes(pod(["eval_mhop_retrieval", *args, "--save-path",
                       f"{tmp}/n4_pod.jsonl"]))
    t_search = time.perf_counter() - t2
    emr.main(args + ["--save-path", f"{tmp}/n4_one.jsonl"])
    with open(f"{tmp}/n4_pod.jsonl") as f, open(f"{tmp}/n4_one.jsonl") as g:
        pod_rows, one_rows = f.read(), g.read()
    assert pod_rows == one_rows and len(pod_rows.splitlines()) == N4_Q, \
        "the pod's chains differ from the single-process 2-shard run's"
    say(f"  n4 cli.pod eval_mhop_retrieval --index-shards 2 (2 processes, "
        f"a shard each): {t_search:.1f} s for {N4_Q} questions; chains = "
        f"the single-process 2-shard run's; leg n4 {time.perf_counter() - t0:.1f} "
        f"s [{smi}]")


RANGES = ("hop1_encode", "hop1_mips", "hop2_assemble", "hop2_encode",
          "hop2_mips", "chain_topk")


def dev_ms(event):
    return getattr(event, "device_time_total", 0.0) / 1e3


def device_kernels(fn):
    """fn() under torch.profiler: (its result, the profiler's events, and
    (device ms, name) of every kernel and copy, largest first: the
    device-side events other than the search step ranges)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # ranges (the search steps, the optimizer's own annotation) hold the
    # kernels listed beside them: counting them too would count twice
    kernels = sorted(((dev_ms(e), e.key) for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.key not in RANGES
                      and not getattr(e, "is_user_annotation", False)
                      and not e.key.startswith("Optimizer.")), reverse=True)
    return out, events, kernels


def idle_share(busy_ms, batch_ms):
    """1 minus the device's busy ms over the unprofiled batch time (the
    profiler slows the host's launches, so its own wall time would
    overstate the idle share)."""
    return 1 - busy_ms / batch_ms


def profile_batch(engine, q_inputs, q_raw, q_lens, batch_ms, smi,
                  table_path=None):
    """Where one batch's time goes: device time per search step and
    per kernel (torch.profiler), peak memory, and the idle share of
    `batch_ms`.  The full table goes to `table_path`.  Returns (device ms,
    name) of every kernel and copy, largest first."""
    def timed():
        t0 = time.perf_counter()
        engine.search(dict(q_inputs), q_raw, q_lens)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    torch.cuda.reset_peak_memory_stats()
    wall_ms, events, kernels = device_kernels(timed)
    busy = sum(t for t, _ in kernels)
    steps = {e.key: round(dev_ms(e), 3) for e in events if e.key in RANGES}
    say(f"  profile of one batch: device busy {busy:.2f} ms, idle share "
        f"{idle_share(busy, batch_ms):.3f} of the unprofiled {batch_ms:.2f} "
        f"ms (wall under the profiler {wall_ms:.2f} ms), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")
    say(f"  device ms per step: {json.dumps(steps)}")
    for t, name in kernels[:8]:
        say(f"    {t:9.3f} ms  {name[:100]}")
    if table_path:
        with open(table_path, "w") as f:
            f.write(events.table(sort_by="self_device_time_total",
                                 row_limit=60))
    return kernels


CU = "multihop_dense_retrieval_tpu_torch/ops/csrc/"
TPU = "multihop_dense_retrieval_tpu/ops/mips.py:"
# kernel: (source, TPU kernel it replaces, main path whose counts it reports)
REPLACES = {
    "mips_scan_int8": (CU + "mips_scan_i8.cu", TPU + "316", "int8"),
    "mips_scan": (CU + "mips_scan_mma.cu", TPU + "220", "bf16"),
    "pca_chunk_max": (CU + "chunk_max_mma.cu", TPU + "868", "int8"),
    "pca_rescan_int8": (CU + "rescan_mma.cu", TPU + "554", "int8"),
    "rescan": (CU + "rescan_mma.cu", TPU + "532", "fever_c1"),
    "chunk_max": (CU + "chunk_max_mma.cu", TPU + "489", "fever_c1"),
    "chunk_max_int8": (CU + "chunk_max_i8.cu", TPU + "506", "int8_two_phase"),
    "fused_attention": (CU + "fused_attention.cu",
                        "multihop_dense_retrieval_tpu/ops/fused_attention.py:61",
                        "corpus_e1"),
}
# kernels 10 and 11 report, for each variant, the first leg that launched
# it (its path None here)
for _name in ENCODER_KERNELS:
    REPLACES[_name] = (CU + "encoder_fused.cu",
                       "none (XLA fused the chain in the JAX package)",
                       None if _name in VARIANT_OF else "int8")


# sources of the tensor-core templates (every kernel), whose ptxas lines are
# printed under their kernels' names
TENSOR_CORE_SOURCES = ("mips_scan_mma", "mips_scan_i8", "chunk_max_mma",
                       "chunk_max_i8", "rescan_mma", "fused_attention")
# the legs that launch kernels 1, 2, 3, 4, 5 and 7, and those kernels, which
# must take the tensor cores wherever they run
MMA_LEGS = ("int8", "int8_two_phase", "fused_serving", "bf16", "fever_c1",
            "fever_c2", "qa_serving", "qa_end2end", "bulk_l1_exact",
            "bulk_l1_pca", "bulk_l2_exact", "bulk_l2_pca", "bulk_l3_bf16",
            "bulk_l3_int8", "sharded_int8", "sharded_two_phase",
            "sharded_c1", "sharded_c2", "trained_p1", "trained_p2",
            "trained_p2_shards") + tuple(
                f"beam4_{name}" for name, *_ in H_ENGINES)
MMA_KERNELS = ("mips_scan_int8", "mips_scan", "pca_chunk_max",
               "chunk_max_int8", "pca_rescan_int8", "rescan")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile-out", default=None,
                        help="write the profiled batch's full table here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    from multihop_dense_retrieval_tpu_torch import core, data, index, models
    from multihop_dense_retrieval_tpu_torch import search
    from multihop_dense_retrieval_tpu_torch.ops import _build, mips

    track_routes(mips, importlib.import_module(
        "multihop_dense_retrieval_tpu_torch.ops.fused_attention"))
    smi = nvidia_smi()
    dev = torch.device("cuda", 0)
    say(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = _build.build_all()
    say(f"build: {secs:.1f} s (wall {time.perf_counter() - t0:.1f} s)")
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  {name}: {line.strip()}")
            elif "entry function" in line and name in TENSOR_CORE_SOURCES:
                # the new templates' ptxas lines, each under its kernel
                fn = line.split("'")[1] if "'" in line else line.strip()
                say(f"  {name}: {fn[:72]}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    recs = check_kernels(mips, dev, gen)
    say("kernels: " + json.dumps({k: {"ok": True, "template": r["template"],
                                      "max_abs_err": r["err"],
                                      "ms": r["ms"], "plain_ms": r["plain_ms"],
                                      "library_ms": r["library_ms"],
                                      "bound_ms": r["bound"][0],
                                      "bound_share": r["bound"][0] / r["ms"]}
                                  for k, r in recs.items()}) + f" [{smi}]")

    launches = run_main_path(
        (core.config, data, index, models, search), mips, dev, gen, smi,
        args.profile_out)
    for leg in MMA_LEGS:
        for name in MMA_KERNELS:
            taken = launches[leg]["routes"].get(name, [])
            assert launches[leg][name] == 0 or taken == ["mma"], \
                f"{name} took {taken} on leg {leg}"
    say(f"main path: ok [{smi}]")

    kernels = []
    for name, r in recs.items():
        kernel = r.get("kernel", name)
        src, rep, path = REPLACES[kernel]
        if path is None:
            path = next((leg for leg, c in launches.items()
                         if c.get("variants", {}).get(name)), None)
            n = launches[path]["variants"][name] if path else 0
        else:
            n = launches[path][kernel]
        kernels.append({
            "name": name, "kernel": kernel, "route": "cuda",
            "template": r["template"], "source": src, "replaces": rep,
            "path": path, "launches": n,
            "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    assert not idle, f"kernels not launched on their paths: {idle}"
    say(f"chip_smoke: {time.perf_counter() - t0:.1f} s from the build on")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
