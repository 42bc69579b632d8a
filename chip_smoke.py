#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a host with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero):

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (``hier_agg.cu``, ``flash_attention.cu``, ``wkv6.cu``) with nvcc for
   sm_90a (one nvcc per source, all at once), and count each
   ``flash_attention`` instantiation's tensor-core instructions in its
   SASS (``cuobjdump``): the bf16 tile path (``flash_wgmma_kernel``) must
   have some at each head dim, 64, 112 and 128;
2. hold each kernel against its plain PyTorch version on the card, on the
   same tensors, at the main path's shapes (MNIST and CIFAR banks, Eq. 1
   with 5 edges and Eq. 2 with 1, and the async flushes: one segment over
   K = 3 CIFAR or K = 2 MNIST updates) in f32 and with a bf16 bank, plus
   a ragged case with an empty segment, and at the LLM train step's
   largest edge mean (4 x 352,321,536 f32, 2 edges), phase 3k's
   per-rank partial of it (2 x 352,321,536, ``segment_sum_partial``),
   phase 3l's tp rank's edge mean (4 x 88,080,384, 2 edges) and
   whisper-base's largest whole leaf (4 x 26,554,880, phase 3g (f)) and
   largest fsdp block (4 x 3,145,728, phase 3n):
   ``segment_agg`` and the partial within atol = rtol
   = 1e-5 (the kernel sums rows in order with fmaf, the plain version
   with ``index_add_``; the orders differ), ``segment_broadcast``
   bitwise, and two runs of each kernel bitwise equal;
3. a small cloud round on the card against the same round on the CPU
   (plain versions), then the main path: ``HFLEnv`` in real mode at the
   paper's CIFAR defaults (50 devices, 5 edges, 1000 samples each,
   batch 32, gamma_max 8) -- reset, two ``step_raw(2, 2)`` and one
   ``step`` with a seeded random action -- with the launch counts of
   both kernels read around it and held to what the round's loop
   implies; then the same at the MNIST defaults;
3c. the agent and the schemes (``repro_torch.core.sync``,
   ``core.agent``): (a) one PPO update on the card against the same
   update on the CPU (same seed, so the same init; a seeded 40-step
   rollout at the CIFAR state shape (6, 9), 10 actions; the same
   shuffle seed) within atol 1e-4, and its wall; (b) ``HFLEnv`` real
   mode at the paper's CIFAR width with T cut to 300 s:
   ``sync.train_agent`` for 2 episodes, then ``run_scheme("arena")``;
   (c) at the MNIST defaults with T cut to 50 s: every synchronous
   scheme (vanilla-fl, vanilla-hfl, var-freq-a, var-freq-b, favor,
   hwamei trained for one episode then run, share), and
   ``async-fedavg`` raising ``TypeError`` on ``HFLEnv``; each run with
   the launch counts set to 0 before it and held after it to what its
   rounds' (gamma1, gamma2) imply, a finite history and a synced bank,
   and its per-round walls printed; (d) ``hfl.make_fedavg_round`` on a
   50 x 456,906 CIFAR bank with every other device participating:
   exactly one ``segment_agg`` launch, every row the global model, and
   with no local epoch the global model within 1e-5 of the plain mean;
3d. the asynchronous runtime (``repro_torch.runtime``,
   ``hfl.make_edge_round``, ``sim.AsyncHFLEnv``): (a) deterministic mode:
   two CIFAR-width warmup rounds from one seed bitwise equal, walls with
   and without the mode; (b) ``make_edge_round`` at CIFAR width
   (gamma1 [2, 1, 3, 2, 1], gamma2 [1, 2, 2, 1, 2]) in both modes: in
   deterministic mode each edge's vector bitwise row j of one cloud
   round (every epoch trains fixed chunks of each edge's rows; ROADMAP
   fault 2),
   the other rows bitwise untouched, 1 + gamma2 ``segment_agg`` and gamma2
   ``segment_broadcast`` launches each, and the zero-decay K = 5 flush
   bitwise the cloud round's global model; plain mode's gap and the
   walls of both modes printed; (c) ``AsyncHFLEnv`` real at
   the paper's CIFAR width (buffer_k 3, poly decay, 30 s flush deadline)
   with drops, transient retries, an outage and a leave + join of edge 4,
   20 events: every applied flush within 1e-5 of the numpy oracle on its
   buffered vectors, the joined edge's rows the global model and the
   others bitwise, launches as the events imply (per landed upload
   1 + gamma2 and gamma2, per applied flush one ``segment_agg``, per
   join one ``segment_broadcast``), per-event walls; (d) at the MNIST
   defaults with T cut to 40 s: ``async-fedavg`` (buffer_k 2, 5
   events), then ``train_agent`` for one episode on the ``AsyncHFLEnv`` and
   ``async-arena``, each with its launches held;
3e. checkpoints, telemetry, health and the ledger
   (``repro_torch.checkpoint.store``, ``repro_torch.telemetry``) at the
   paper's CIFAR width in deterministic mode with ``_obs_env``'s faults
   (phase 3d (c)'s rates; the outage and churn at 150-320 s):
   (a) 8 events at action (1, 1) with telemetry, health and ``ktime``
   off, then on: every event's (reward, acc, edge, flushed), the global
   vector and the bank bitwise equal, ``ktime``'s call counts equal to
   the launch counts, the per-event walls of both and ``ktime``'s
   median readings (printed beside phase 4's graph-timed CIFAR Eq. 1
   times); (b) ``save_runtime`` at event 4 of the on-run,
   ``load_runtime`` into a fresh env on the card, 4 more events bitwise
   the on-run's (trace included), the snapshot's size and the save and
   load seconds; (c) at the MNIST defaults with T cut to 40 s,
   deterministic: ``run_scheme("async-fedavg", g1=1, g2=1,
   ledger=RunLedger(tmpdir))`` for 5 events, its rows read back with
   ``load_run``, ``final_acc`` bitwise the same run's without a ledger;
3f. the row-sharded bank over ``torch.distributed``
   (``repro_torch.launch.mesh``, ``hfl.AggContext.for_mesh``,
   ``ops.segment_agg_sharded``), on a 90 s budget: (a) NCCL, one rank in
   this process: the paper's CIFAR ``HFLEnv`` (5 edges of 10 contiguous
   devices) in deterministic mode, its warmup cloud round at (2, 2)
   under ``make_bank_context(1)`` bitwise the one-device round, launches
   as the round implies; (b) gloo, 2 ranks spawned on the one card
   (NCCL refuses two ranks on one device; the 5-rank world went when
   phase 3k came): CIFAR Eq. 1 (50 x 456,906) through
   ``segment_agg_sharded`` on each rank's rows, edge 2 spanning the
   ranks and held within 1e-5, the others bitwise the single launch on
   the whole bank; every rank within 1e-5 of the plain version
   (``ref.segment_agg_sharded_ref``) with one launch;
   ``ops.segment_agg_ordered`` (the ranks chained in row order) bitwise
   the single launch; the shard-local ``masked_resync`` of one alive
   edge bitwise the one-device resync and the plain gather
   (``ref.segment_broadcast_ref``) at 25 rows; the deterministic CIFAR
   warmup round (edge 2 and so its training call spanning ranks 0 and
   1) bitwise (a)'s one-device round (ROADMAP fault 3, closed), each
   rank holding N/2 bank rows. It prints the per-rank graph-timed
   ``segment_sum_partial`` at 25 rows beside its bound and the gloo
   ``all_reduce`` time: ranks sharing one card, which says nothing of
   multi-GPU scaling;
2b. hold ``flash_attention`` and ``wkv6`` against their plain versions
   on the card, in bf16 and f32, at the serving path's shapes (qwen3-1.7b
   prefill and decode, rwkv6-1.6b prefill; phase 3h's olmoe-1b-7b
   prefill and decode, qwen3's windowed prefill of 8704 tokens under a
   window of 8192 and its ring decode, non-causal over 8192 slots; phase
   3i's zamba2-7b prefill and decode at head dim 112; phase 3j's
   whisper-base encoder (non-causal over 1500 frames), cross-attention
   prefill and decode (224 and 1 rows over 1500) and self decode, and
   qwen2-vl-7b prefill and decode at GQA rep 7) plus ragged (also
   at head dim 112 and at rep 7), windowed, MHA,
   non-causal (also with Sq != Skv) and hard-decay cases, and for
   ``flash_attention``'s split-KV decode path GQA groups of 1, 4, 7
   (also at Sq = 2: 14 packed rows) and 8, Skv 1, 65 and 4097, a
   causal end and an empty split inside the range, and both sides of the
   16-packed-row routing edge; each with its stated tolerance, and two
   runs of each kernel bitwise equal;
3g. the hierarchical LLM train step (``repro_torch.launch.train``), on a
   180 s budget: (a) reduced qwen3, rwkv6 and olmoe (f32 activations,
   vocab 128) one (2, 2) round on replicas (1, 2, 2) on the card against
   the CPU within 1e-4, TF32 off, launches held to (g2 + 1) per leaf;
   (b) full-width qwen3-1.7b (f32 weights from seed 0, bf16
   activations) on replicas (1, 2, 2), the reference
   main's settings (batch 8 x seq 128, lr 3e-3, 2 minibatches per epoch,
   remat, KV chunks of 128): one static ``FULL_G`` = (1, 1) round, the
   ``segment_agg`` and ``segment_broadcast`` launches held to (g2 + 1)
   per leaf, every leaf bitwise equal across the replicas, replica 0's
   loss before and after, seconds per round and per SGD step, peak
   memory beside the 45 GB reckoning; (b') the same round with KV
   chunks of 64, another summation order: replica 0's loss and per-leaf
   sums against (b)'s, the bf16 round's own response to a reordering,
   which bounds phase 3l's loss; (c) in deterministic mode a
   dynamic round at g1e = g2e = 1 bitwise the static (1, 1) round, then
   a dynamic round with the reference main's seeded draws, launches
   held; (d) one (1, 1) round at seq 4096 (train_4k), one sequence per
   replica; (e) full-width rwkv6-1.6b (f32 weights from seed 0, bf16
   activations), one static (1, 1) round on replicas (1, 2, 2) at the
   reference main's settings through ``wkv_chunked``: launches held,
   replicas bitwise equal, replica 0's loss and per-leaf sums kept for
   phase 3m; (e') the same round through ``wkv_scan``, another summation
   order: its loss and per-leaf sums against (e)'s, the bf16 round's own
   response to a reordering, which bounds phase 3m's loss; (f)
   full-width whisper-base (f32 weights from seed 0, bf16 activations),
   one static (1, 1) round on replicas (1, 2, 2) at the reference
   main's settings, the batch with ``enc_embed`` (8, 1500, 512) from
   ``serve.stub_extras``: launches held, replicas bitwise equal, replica
   0's loss and per-leaf sums kept for phase 3n; (f') the same round with
   the whisper blocks' KV chunks of 512 instead of min(1024, S), another
   summation order: the bf16 round's own response to a reordering,
   which bounds phase 3n's bf16 round; (f32) the round with f32
   activations;
3k. the replica plane over ``torch.distributed`` (``checkpoint.store`` on
   a sharded env, ``sync.share_topology``, the multi-rank ``HFLMesh`` of
   ``launch.mesh`` and ``launch.train``), on a 120 s budget, gloo ranks
   spawned on the one card (2; 4 for (c)'s reduced round until phase 3m
   came) against one-device references
   computed in this process first: (a) phase 3e's faulty CIFAR
   ``AsyncHFLEnv`` in deterministic mode at action (1, 1) on 2 ranks,
   ``save_runtime`` after 5 events, ``load_runtime`` into a fresh
   sharded env, events 6-10 bitwise the uninterrupted 2-rank run and
   the one-device run (events, global vector, bank), the sharded
   snapshot's arrays bitwise the one-device snapshot's, its MB and save
   and load seconds; (b) ``share_topology`` at the MNIST defaults on 2
   ranks equal to the one-device assignment and the deterministic round
   after it bitwise the one-device round; (c) reduced qwen3 (f32
   activations, vocab 128) on replicas (1, 2, 2) over rank grid (1, 1,
   2) at 2 ranks, one deterministic (2, 2) round
   bitwise the one-device card round with (g2 + 1) launches of each
   kernel per leaf on every rank; then full-width qwen3-1.7b (f32
   weights from seed 0, bf16 activations) at phase 3g (b)'s settings on
   2 ranks of 2 replicas each, so both Eq. 1 and Eq. 2 cross the ranks:
   one static (1, 1) round, launches held, every replica bitwise rank
   0's replica (0, 0, 0), replica 0's loss, per-leaf sums of squares and
   sums within 1e-4 of 3g (b)'s round, seconds per round and per SGD
   step, the gloo ``all_reduce`` milliseconds of one Eq. 1 and one
   Eq. 2, each rank's peak memory within ``REPLICA_MEM_GB``; then, in
   the same 2-rank world, phase 3n's rounds; it prints its wall;
3n. the fsdp axis (``launch.mesh``'s ``HFLMesh`` with F > 1, the FFN and
   vocabulary over a replica's ft group, ``models.tp``): full-width
   whisper-base at its published (8, 16, 2, 1), replicas (1, 2, 2) on
   each of phase 3k's 2 gloo ranks, each replica split over both as F =
   2 (T = 1), the seed-0 replica drawn one rank at a time: one static
   (1, 1) round at phase 3g (f)'s settings with bf16 activations, then
   with f32; the leaves split (the encoder's and decoder's MLP ``w_up``,
   ``b_up``, ``w_down``) halved on each rank and the rest whole (the
   guard keeps the vocabulary of 51,865 whole), (g2 + 1) launches of
   each kernel per leaf on each rank, every replica and every leaf no
   spec splits bitwise equal across the ranks, replica (0, 0, 0)
   gathered whole on rank 0: the bf16 round's loss and per-leaf sums of
   squares and sums within the larger of ``REPLICA_REL`` and 3g (f')'s
   response of 3g (f)'s, the f32 round's within ``REPLICA_REL`` of 3g
   (f32)'s; the rounds' walls, the gloo calls and seconds over the ft
   group and each rank's peak memory within ``FSDP_MEM_GB``;
3l. the tensor plane (``models.tp``, the tp axis of ``launch.mesh``'s
   ``HFLMesh``, the train step over it): full-width qwen3-1.7b (f32
   weights from seed 0, bf16 activations), each of replicas (1, 2, 2)
   split over 4 gloo tp ranks spawned on the one card (the published
   topology's T = 4; NCCL cannot put several ranks on one card), each
   rank drawing the seed-0 replica on the card in turn and keeping its
   tp blocks: one static (1, 1) round at phase 3g (b)'s settings,
   (g2 + 1) launches of each kernel per leaf on every rank (Eq. 1 and
   Eq. 2 on the rank's blocks of its 4 replicas), every replica and
   every replicated leaf (norms, ``q_norm``, ``k_norm``) bitwise equal
   across the ranks, replica (0, 0, 0) gathered whole on rank 0, its
   per-leaf sums of squares and sums within ``REPLICA_REL`` of 3g (b)'s
   round (or 3g (b')'s largest per-leaf response, were it larger) and
   its loss no farther from 3g (b)'s than 3g (b')'s (a split product
   sums in another order, and a bf16 round's loss moves with any
   summation order); the round's wall, the gloo ``all_reduce`` seconds
   over the tp group and each rank's peak memory within ``TP_MEM_GB``;
3m. the tensor plane of the ssm family (``models.rwkv`` under ``tp=``):
   phase 3l's setup for full-width rwkv6-1.6b at its published T = 4
   (f32 weights from seed 0, bf16 activations; replicas (1, 2, 2) on
   every one of 4 gloo tp ranks sharing the card, the seed-0 replica
   drawn one rank at a time): one static (1, 1) round at phase 3g (e)'s
   settings through ``wkv_chunked``, (g2 + 1) launches of each kernel
   per leaf on every rank, every replica and every leaf no spec splits
   (``mu_*``, the low-rank lerp and decay leaves, the group norm's,
   ``ln1``/``ln2``, ``final_norm``) bitwise equal across the ranks,
   replica (0, 0, 0) gathered whole: its loss no farther from 3g (e)'s
   round than 3g (e')'s, its per-leaf sums of squares and sums within
   the larger of ``REPLICA_REL`` and 3g (e')'s largest per-leaf response
   (rwkv6's round is ill-conditioned: its zero-initialised group-norm
   bias ``ln_b`` moves by tens of percent under any summation order),
   the leaf at each largest printed; the round's wall, the gloo
   ``all_reduce`` and ``all_gather`` calls and seconds over the tp group
   and each rank's peak memory within ``TP_RWKV_MEM_GB``;
3o. mesh serving (``launch.serve``'s steps over a
   ``launch.mesh.ServeMesh``), on phase 3l's 4 gloo ranks after its
   round: (a) full-width qwen3-1.7b (f32 weights from seed 0, bf16
   activations) over the serve mesh (1, 1, 4), its published T = 4,
   each rank drawing the seed-0 model on the card in turn and keeping
   its serve blocks (4 of 16 query heads over 2 of 8 kv heads, a quarter
   of the FFN and of the vocabulary): phase 3b's prompt (4 x 1024) and
   32 decode steps fed 3b's greedy tokens through ``greedy_serve(mesh=,
   forced=)``, ``flash_attention`` held to 28 ``wgmma`` + 896
   ``split_kv`` calls on every rank, every step's logits bitwise equal
   on the 4 ranks and within ``SERVE_REL`` (bf16) of 3b's one-device
   logits, the first step whose own greedy token differs printed; the
   prefill seconds, decode tokens/s, gloo calls and seconds per prefill
   and per decode step and each rank's peak memory (within
   ``SERVE_TP_MEM_GB``); (b) reduced qwen3 (f32 activations) over (1,
   2, 2), batch 4 split over the two batch groups, within
   ``SMALL_SERVE_TOL`` of the one-device serve;
3b. the LLM serving path: a reduced qwen3, rwkv6, olmoe, zamba2,
   whisper and qwen2-vl (f32 activations; the last two with their stub
   inputs) served on the card against the CPU; then the main path,
   the full-width
   qwen3-1.7b and rwkv6-1.6b (random weights from seed 0) through
   ``repro_torch.launch.serve.greedy_serve``: a (4, 1024) prompt, 32
   greedy decode steps, the kernel launch counts held to what the loop
   implies (for qwen3 also the ``flash_attention`` path: prefill on the
   tensor-core tile kernel, decode on split-KV), and every step's logits
   held against ``Model.logits`` over the whole sequence;
3h. the MoE family and ring-buffer serving (``models.moe``, the
   ``window`` of ``greedy_serve``), on a 120 s budget: (a) olmoe-1b-7b at
   full width (64 experts top-8, 6.92 B f32 params from seed 0, bf16
   activations): a (4, 1024) prompt and 32 greedy steps, ``flash_attention``
   launches held to 16 wgmma + 16 x 32 split-KV calls, the prefill
   logits against ``Model.logits`` over the prompt within relative L2
   1e-2, then the dropless copy (capacity factor 8 = E / k) served the
   same way in bf16 and f32 activations, the routing of each decode step
   compared with the full forward's token by token: each sequence is held
   against ``Model.logits`` by relative L2 0.1 (bf16) / 1e-3 (f32) at
   every step before its first routing flip (a top-8 boundary closer
   than the two paths' router-logit difference), at least half of all
   (step, sequence) pairs in f32, and each flip printed with its margin;
   prefill seconds, decode tokens/s, peak memory and one profiled decode
   step printed; (b)
   qwen3-1.7b from a ring buffer of its sliding window (8192 slots): a
   (1, 8704) prompt and 32 steps, launches held to 28 + 28 x 32, the
   ring's positions checked slot by slot, and every step held against
   ``Model.logits(window=8192)`` over 8736 tokens;
3i. the hybrid family (``models.ssm``, the shared-attention stack), on a
   120 s budget: zamba2-7b at full width (81 Mamba2 layers, d_model
   3584, one shared attention block applied 14 times; 6.60 B bf16
   params from seed 0, bf16 activations): a (4, 1024) prompt and 32
   greedy steps, ``flash_attention`` launches held to 14 wgmma + 14 x 32
   split-KV calls (head dim 112), prefill seconds, decode tokens/s and
   peak memory; the prefill and every decode step held against
   ``Model.logits`` over the whole sequence by relative L2
   (``SERVE_REL``), peak memory within ``HYBRID_MEM_GB``; one profiled
   decode step;
3j. the audio and vlm families (the whisper encoder-decoder with
   cross-attention, qwen2-vl's M-RoPE and vision stub) at full width,
   f32 weights from seed 0, bf16 activations, batch 4, the stub inputs
   from numpy seed 0: (a) whisper-base (6 encoder + 6 decoder layers,
   d_model 512) with ``enc_embed`` (4, 1500, 512), a 224-token decoder
   prompt and 32 greedy steps, ``flash_attention`` held to 18 wgmma
   calls (6 encoder, 6 self, 6 cross) and 32 x 12 split-KV calls;
   (b) qwen2-vl-7b (28 layers, d_model 3584, 28 heads over 4) with
   ``vision_embed`` (4, 256, 3584) before a 1024-token prompt and 32
   greedy steps, 28 wgmma + 28 x 32 split-KV calls; for each the calls
   per site (``_flash_sites``), prefill seconds, decode tokens/s, peak
   memory within ``SERVE_3J``'s bound, the prefill and every step
   against ``Model.logits`` over the whole sequence (with the same stub
   inputs; a vlm's logits past its vision positions) within
   ``SERVE_REL``, and one profiled decode step;
4. kernel times at the main path's shapes (CIFAR and MNIST, Eq. 1 with
   its resync and Eq. 2, and the flushes with ``torch.mv`` as the
   library call; the JSON line has CIFAR and MNIST Eq. 1 rows and the
   CIFAR flush row for ``segment_agg``, and phase 3f's sharded Eq. 1
   row), at phase 3g's LLM edge mean, phase 3l's tp rank's (4 x
   88,080,384 -> 2), whisper's largest whole leaf and its fsdp block
   (both kernels, ``torch.mean`` over the replica axis
   and a ``copy_`` of the expanded means as the library calls, CUDA
   events around 10 calls) and at phase 3k's per-rank partial of the
   full-width Eq. 1 (2 x 352,321,536 -> 2, ``torch.sum`` over each
   edge's rows as the library call): device time per launch from CUDA
   events around a CUDA-graph replay, beside the plain version's, one
   PyTorch library call's, the bound (bytes over 3.35 TB/s), and the
   eager wrapper's
   time per call as the round pays it (host dispatch included);
4b. the same for ``flash_attention`` (qwen3 prefill and decode, olmoe
   prefill and decode, qwen3's windowed prefill and ring decode, zamba2's
   prefill and decode at head dim 112, whisper's encoder, cross prefill,
   cross decode and self decode, qwen2-vl's prefill and decode, phase
   3o's tp rank's prefill and decode (their launches summed over the 4
   ranks), one JSON row each, with
   ``scaled_dot_product_attention`` as the library
   yardstick, a boolean mask for the window) and
   ``wkv6`` (rwkv6 prefill; no single library call computes it), with
   the bound the larger of bytes over 3.35 TB/s and the operations the
   function needs over the card's peak rate for them: for attention the
   products at the bf16 rate and one exponential per visible score at
   the SFU rate, for the WKV recurrence its multiply-adds at the f32
   rate.

It prints the card's name and power limit, then one JSON line of the
kernels, and last ``{"ok": true, "device": {...}}``. Without a CUDA
device, or outside a checkout, it exits non-zero and prints no result.

    python3 chip_smoke.py --serve-only [--root DIR]

serves only the two full-width models (the timed part of phase 3b: prefill
seconds, decode tokens/s, one profiled decode step; ``--arch zamba2-7b``,
``whisper-base`` or ``qwen2-vl-7b``, repeatable, serves phase 3i's or
3j's model, with its checks, instead) with the package under
``DIR/src`` (default: this checkout), and prints one JSON line of those
numbers. Run it for two trees in turns in one call to compare them on
one card and host.
"""
import argparse
import contextlib
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
CSRC = "src/repro_torch/kernels/csrc/"
KERNEL_SRC = {"segment_agg": CSRC + "hier_agg.cu",
              "segment_broadcast": CSRC + "hier_agg.cu",
              "flash_attention": CSRC + "flash_attention.cu",
              "wkv6": CSRC + "wkv6.cu"}
REPLACES = {"segment_agg": "src/repro/kernels/hier_agg.py:84",
            "segment_broadcast": "src/repro/kernels/hier_agg.py:194",
            "flash_attention": "src/repro/kernels/flash_attention.py:24",
            "wkv6": "src/repro/kernels/wkv6.py:29"}
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
# exponentials: 16 per clock per SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0) x 132 SMs x
# the H100 SXM's 1.98 GHz boost clock
EXP_PER_S = 16 * 132 * 1.98e9
AGG_TOL = 1e-5                  # segment_agg vs plain: summation order
# flash_attention vs plain: both compute in f32 (online vs one-pass
# softmax, other summation orders): 1e-5 in f32; in bf16 both round that
# f32 result to bf16, so they may differ by one bf16 ulp (2^-8 relative)
FLASH_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# wkv6 vs plain: the kernel's 16-token steps with running decay products
# against the plain chunked log-space version, sums of O(10) terms in other
# orders: the reference's own wkv6 kernel tolerance; 1e-3 for hard decays,
# as in the reference's hard-decay test
WKV_TOL = 2e-4
WKV_HARD_TOL = 1e-3
# the served model: logits of prefill + decode against Model.logits over
# the whole sequence, relative L2 error per step. With the configs' bf16
# activations the two paths round at other places (GEMMs of 4 rows and of
# 4224 rows pick other cuBLAS kernels, and the decode runs the one-token
# RWKV update where the forward runs wkv6), and random weights amplify
# the differences through 24-28 layers: 0.1 (measured: 1.4e-2 for qwen3,
# 5.2e-2 for rwkv6, NVIDIA H100, chip_smoke.py). The same weights with
# f32 activations hold the two paths to summation order: 1e-3.
SERVE_REL = {"bfloat16": 0.1, "float32": 1e-3}
# a reduced model on the card (kernels) vs the CPU (plain versions), f32
# activations, TF32 off: the f32 parity tolerance of the CPU tests
SMALL_SERVE_TOL = 1e-4


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def sync_time(torch):
    torch.cuda.synchronize()
    return time.perf_counter()


def event_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Milliseconds per call from CUDA events around ``iters``
    back-to-back eager calls, after ``warmup`` calls. For a short kernel
    this is the host's dispatch time, not the device's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(torch, fn, iters: int = 50) -> float:
    """Device milliseconds per call: ``iters`` calls captured in one CUDA
    graph, timed with CUDA events around a replay, so no host dispatch
    sits between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

CASES = [("mnist-eq1", 50, 21840, 5), ("mnist-eq2", 5, 21840, 1),
         ("cifar-eq1", 50, 456906, 5), ("cifar-eq2", 5, 456906, 1),
         ("ragged-empty", 9, 997, 4),
         # the async flushes of phase 3d: K = 3 (CIFAR), K = 2 (MNIST)
         ("cifar-flush", 3, 456906, 1), ("mnist-flush", 2, 21840, 1)]


def kernel_checks(torch, ops, ref, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    err = {"segment_agg": {}, "segment_broadcast": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for name, n, p, e in CASES:
            bank = torch.randn((n, p), generator=gen, device=dev).to(dtype)
            w = torch.rand((n,), generator=gen, device=dev) * 2.9 + 0.1
            seg = torch.randint(0, e, (n,), generator=gen, device=dev,
                                dtype=torch.int32)
            if name.startswith("ragged"):
                seg[seg == 2] = 0                  # segment 2 is empty
            got = ops.segment_agg(bank, w, seg, e)
            want = ref.segment_agg_ref(bank, w, seg, e)
            d = float((got - want).abs().max())
            check(torch.allclose(got, want, atol=AGG_TOL, rtol=AGG_TOL),
                  f"segment_agg {name} {dtype}: max abs err {d}")
            check(torch.equal(got, ops.segment_agg(bank, w, seg, e)),
                  f"segment_agg {name} {dtype}: two runs differ")
            if name.startswith("ragged"):
                check(int(torch.count_nonzero(got[2])) == 0,
                      "segment_agg: empty segment is not zero")
            sums, wsum = ops.segment_sum_partial(bank, w, seg, e)
            want_w = ref.segment_weight_sums(w, seg, e)
            want_s = ref.segment_scaled_sum_ref(bank, w, seg,
                                                torch.ones_like(wsum), e)
            check(torch.allclose(sums, want_s, atol=AGG_TOL, rtol=AGG_TOL)
                  and torch.allclose(wsum, want_w, atol=AGG_TOL,
                                     rtol=AGG_TOL),
                  f"segment_sum_partial {name} {dtype}")
            err["segment_agg"][name] = max(err["segment_agg"].get(name, 0.0),
                                           d)

            models = torch.randn((e, p), generator=gen, device=dev)
            out = ops.segment_broadcast(models, seg, out_dtype=dtype)
            want_b = ref.segment_broadcast_ref(models, seg, dtype)
            check(out.dtype == dtype and torch.equal(out, want_b),
                  f"segment_broadcast {name} {dtype}: not bitwise equal")
            again = ops.segment_broadcast(models, seg, out_dtype=dtype)
            check(torch.equal(out, again),
                  f"segment_broadcast {name} {dtype}: two runs differ")
            print(f"  {name:13s} {str(dtype):15s} N={n:3d} P={p:7d} E={e}"
                  f"  segment_agg max|err| {d:.3e}  broadcast bitwise")
    return err


# the LLM train step's edge mean (phase 3g) at its largest leaf: qwen3-1.7b's
# layers/mlp/w_gate (28 x 2048 x 6144 elements) over replicas (1, 2, 2),
# viewed as a (4, P) f32 bank with 2 segments (the edges), weights 1
LLM_AGG = ("llm-edge-mean", 4, 28 * 2048 * 6144, 2)
# phase 3k's full-width Eq. 1 on 2 ranks: a rank's partial launch
# (segment_sum_partial) over its 2 replicas of that leaf, one per edge
LLM_PARTIAL = ("llm-eq1-partial-k2", 2, 28 * 2048 * 6144, 2)
# phase 3l's Eq. 1 on a tp rank: its quarter of that leaf (w_gate's
# columns split over 4 tp ranks) over the 4 replicas it holds; also phase
# 3m's largest block, rwkv6-1.6b's cmix w_k (24 x 2048 x 7168 / 4, the
# same 88,080,384 elements)
LLM_TP = ("llm-edge-mean-tp4", 4, 28 * 2048 * 6144 // 4, 2)
# phase 3g (f)'s and 3n's Eq. 1 at whisper-base's largest whole leaf (its
# embed, 51,865 x 512, also unembed's size; whole on both fsdp ranks) and
# at its largest ft block (a rank's half of the MLP's w_up, 6 x 512 x 2048
# / 2) over the 4 replicas a rank holds
WHISPER_AGG = ("whisper-whole-leaf", 4, 51865 * 512, 2)
WHISPER_FT = ("whisper-ft-block", 4, 6 * 512 * 2048 // 2, 2)


def _edge_mean_check(torch, ops, ref, dev, shape, seed: int) -> float:
    """``segment_agg`` within AGG_TOL of its plain version and
    ``segment_broadcast`` bitwise at an LLM edge-mean ``shape``, two runs
    of each bitwise equal; returns the max abs error."""
    name, n, p, e = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    bank = torch.randn((n, p), generator=gen, device=dev)
    w = torch.ones((n,), device=dev)
    seg = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device=dev)
    got = ops.segment_agg(bank, w, seg, e)
    want = ref.segment_agg_ref(bank, w, seg, e)
    d = float((got - want).abs().max())
    check(torch.allclose(got, want, atol=AGG_TOL, rtol=AGG_TOL),
          f"segment_agg {name}: max abs err {d}")
    del want
    check(torch.equal(got, ops.segment_agg(bank, w, seg, e)),
          f"segment_agg {name}: two runs differ")
    out = ops.segment_broadcast(got, seg, out=bank)
    check(torch.equal(out, ref.segment_broadcast_ref(got, seg)),
          f"segment_broadcast {name}: not bitwise equal")
    check(torch.equal(out, ops.segment_broadcast(got, seg)),
          f"segment_broadcast {name}: two runs differ")
    print(f"  {name:13s} torch.float32  N={n:3d} P={p:,} E={e}  segment_agg "
          f"max|err| {d:.3e}  broadcast bitwise")
    return d


def llm_agg_check(torch, ops, ref, dev) -> dict:
    """Phase 2 at the LLM shapes: the edge means of phases 3g, 3l and 3n
    (``_edge_mean_check``: qwen3's largest leaf and tp block, whisper's
    largest whole leaf and ft block) and phase 3k's partial, within
    AGG_TOL of its plain version; returns the max abs errors keyed
    (kernel, shape)."""
    err = {}
    for shape, seed in ((LLM_AGG, 5), (LLM_TP, 7), (WHISPER_AGG, 9),
                        (WHISPER_FT, 11)):
        err[("segment_agg", shape[0])] = _edge_mean_check(
            torch, ops, ref, dev, shape, seed)
        err[("segment_broadcast", shape[0])] = 0.0
        torch.cuda.empty_cache()
    name, n, p, e = LLM_PARTIAL
    gen = torch.Generator(device=dev).manual_seed(5)
    part = torch.randn((n, p), generator=gen, device=dev)
    pw = torch.ones((n,), device=dev)
    pseg = torch.arange(e, dtype=torch.int32, device=dev)
    sums, wsum = ops.segment_sum_partial(part, pw, pseg, e)
    want = ref.segment_scaled_sum_ref(part, pw, pseg,
                                      torch.ones(e, device=dev), e)
    dp = float((sums - want).abs().max())
    check(torch.allclose(sums, want, atol=AGG_TOL, rtol=AGG_TOL)
          and torch.equal(wsum, ref.segment_weight_sums(pw, pseg, e)),
          f"segment_sum_partial {name}: max abs err {dp}")
    print(f"  {name:13s} torch.float32  N={n:3d} P={p:,} E={e}  "
          f"segment_sum_partial max|err| {dp:.3e}, weight sums bitwise")
    del part, sums, want
    torch.cuda.empty_cache()
    err[("segment_sum_partial", name)] = dp
    return err


# ---------------------------------------------------------------------------
# phase 3: a small round against the CPU, then the main path
# ---------------------------------------------------------------------------

def small_round_check(torch, hfl, model, dev) -> None:
    """One cloud round of the MNIST CNN (6 devices, 2 edges, 64 samples)
    on the card and on the CPU from the same bank, data and shuffles."""
    n, m, n_local = 6, 2, 64
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(n, n_local, 28, 28, 1)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (n, n_local)).astype(np.int32))
    perms = torch.from_numpy(np.stack([
        np.stack([np.stack([rng.permutation(n_local) for _ in range(n)])
                  for _ in range(2)]) for _ in range(2)]))
    ea = torch.tensor([0, 1, 0, 1, 1, 0], dtype=torch.int32)
    g1, g2 = np.array([2, 1]), np.array([1, 2])
    loss = lambda p, b: model.cnn_loss(model.mnist_cnn_apply, p, b)
    rnd = hfl.make_cloud_round(loss, 0.05, 32, m, 2, 2)
    outs = []
    for d in ("cpu", dev):
        bank = hfl.init_bank(model.mnist_cnn_init,
                             torch.Generator().manual_seed(7), n,
                             device="cpu")
        bank = {k: v.to(d) for k, v in bank.items()}
        sizes = torch.full((n,), float(n_local), device=d)
        outs.append(rnd(bank, x.to(d), y.to(d), sizes, ea.to(d), g1, g2,
                        perms.to(d)))
    errs = []
    for cpu_part, gpu_part in zip(*outs):
        for k in cpu_part:
            a, b = cpu_part[k], gpu_part[k].cpu()
            errs.append(float((a - b).abs().max()))
            check(torch.allclose(b, a, rtol=1e-4, atol=1e-5),
                  f"small round: {k} differs between CPU and GPU")
    print(f"  small MNIST round (6 dev, 2 edges): GPU vs CPU max|err| "
          f"{max(errs):.3e} (tolerance rtol 1e-4, atol 1e-5)")


def expected_launches(rounds, gamma_max: int) -> dict:
    """Launches the cloud round's loop implies: per round one
    segment_agg for the starting edge models, one segment_agg and one
    segment_broadcast per executed t2 step, one segment_agg for Eq. 2;
    no LLM kernel."""
    agg = bcast = 0
    for _, g2 in rounds:
        steps = min(gamma_max, int(np.max(g2)))
        agg += 2 + steps
        bcast += steps
    return {"segment_agg": agg, "segment_broadcast": bcast,
            "flash_attention": 0, "wkv6": 0}


def main_path(torch, ops, env_mod, task: str, dev) -> dict:
    cfg = env_mod.EnvConfig(task=task, mode="real")
    t0 = time.perf_counter()
    env = env_mod.HFLEnv(cfg)
    t_setup = sync_time(torch) - t0
    c = env.cfg
    check(env.fed.x.is_cuda and env.device.type == "cuda",
          "the env's data is not on the card")
    m, gmax = c.n_edges, c.gamma_max
    rounds = [(np.full(m, 2), np.full(m, 2))]          # reset's warmup
    print(f"  {task}: {c.n_devices} devices, {m} edges, n_local "
          f"{c.n_local}, batch {c.batch_size}, gamma_max {gmax}, lr {c.lr};"
          f" setup {t_setup:.2f} s")
    ops.reset_launches()
    t0 = time.perf_counter()
    state = env.reset()
    t1 = sync_time(torch)
    print(f"    reset     acc {env.acc:.4f}  wall {t1 - t0:.3f} s")
    results = []
    for i in range(2):
        g = np.full(m, 2)
        rounds.append((g, g))
        t0 = time.perf_counter()
        state, r, _, info = env.step_raw(g, g)
        t1 = sync_time(torch)
        results.append((info, r, t1 - t0))
        print(f"    step_raw  acc {info['acc']:.4f}  reward {r:+.4f}  "
              f"energy {info['energy']:.2f}  wall {t1 - t0:.3f} s")
    action = np.random.default_rng(0).uniform(1, gmax, size=2 * m)
    a = np.clip(np.round(action), 1, gmax).astype(np.int64)
    rounds.append((a[:m], a[m:]))
    t0 = time.perf_counter()
    state, r, _, info = env.step(action)
    t1 = sync_time(torch)
    results.append((info, r, t1 - t0))
    print(f"    step      acc {info['acc']:.4f}  reward {r:+.4f}  energy "
          f"{info['energy']:.2f}  wall {t1 - t0:.3f} s  g1 {a[:m]} "
          f"g2 {a[m:]}")
    counts = dict(ops.LAUNCHES)
    want = expected_launches(rounds, gmax)
    print(f"    launches {counts} (expected {want})")
    check(counts == want, f"{task}: launch counts {counts} != {want}")
    check(counts["segment_agg"] > 0 and counts["segment_broadcast"] > 0,
          f"{task}: a kernel was not launched on the main path")
    check(state.shape == env.state_shape and np.isfinite(state).all(),
          f"{task}: bad state {state.shape}")
    for info, r, _ in results:
        check(0.0 <= info["acc"] <= 1.0 and np.isfinite(r)
              and np.isfinite(info["energy"]), f"{task}: bad step {info}")
    for k, v in env.bank.items():
        check(v.is_cuda and bool(torch.isfinite(v).all()),
              f"{task}: bank leaf {k} not finite on the card")
        check(torch.equal(v, env.global_model[k].expand_as(v)),
              f"{task}: bank rows not synced to the global model")
    return {"counts": counts, "rounds": len(rounds)}


# ---------------------------------------------------------------------------
# phase 3c: the agent and the schemes
# ---------------------------------------------------------------------------

# the agent's update on the card vs the same update on the CPU, TF32 off:
# f32 gradients in other summation orders (cuDNN's conv backward is not
# bitwise) through 6 Adam steps
AGENT_TOL = 1e-4
# the paper's CIFAR schedule, passed explicitly: EnvConfig.fixup applies
# it only at the default T. T is cut from 12000 s (about 55 rounds) and
# MNIST's from 3000 s so an episode of the fixed schemes is 1-3 rounds
# after reset (CIFAR: reset about 60 s, a (5, 4) round about 240 s;
# MNIST: about 20 s and 70 s); MNIST's 50 s (160 s until the whole
# script passed 800 s on a slower host, 100 s until phase 3o came)
# still gives every scheme a round after its reset, and CIFAR's 300 s
# (500 s until phase 3k came) the agent's episodes theirs
CIFAR_ARENA = dict(task="cifar", mode="real", n_local=1000, lr=0.01,
                   epsilon=0.004, threshold_time=300.0)
MNIST_SCHEMES = dict(task="mnist", mode="real", threshold_time=50.0)
STATIC_SCHEMES = ("vanilla-fl", "vanilla-hfl", "var-freq-a", "var-freq-b",
                  "favor", "share")


def agent_update_check(torch, ppo, ops, dev) -> None:
    """(a) One PPO update on the card against the same update on the
    CPU: the same seed (so the same init), a seeded 40-step rollout at
    the CIFAR state shape (6, 9) with action dim 10, the same shuffle
    seed; then a second update on the card, timed."""
    shape, adim, n = (6, 9), 10, 40
    rng = np.random.default_rng(3)
    roll = [(rng.normal(size=shape).astype(np.float32),
             rng.normal(size=adim).astype(np.float32), float(rng.normal()),
             float(rng.normal()), float(rng.normal()), t == n - 1)
            for t in range(n)]
    agents = [ppo.PPOAgent(0, shape, adim, device=d,
                           shuffle_seed_source=lambda: 1234)
              for d in ("cpu", dev)]
    for k, v in agents[0].params.items():
        check(torch.equal(v, agents[1].params[k].cpu()),
              f"agent: init {k} differs between CPU and card")
    ops.reset_launches()
    walls = []
    for agent in agents:
        for r in roll:
            agent.remember(*r)
        t0 = sync_time(torch)
        agent.update()
        walls.append(sync_time(torch) - t0)
    err = max(float((agents[0].params[k] - v.cpu()).abs().max())
              for k, v in agents[1].params.items())
    check(err <= AGENT_TOL, f"agent update: card vs CPU max|err| {err:.3e}"
          f" > {AGENT_TOL}")
    check(all(v.device == dev for v in agents[1].params.values()),
          "agent params not on the card")
    card = agents[1]
    for r in roll:
        card.remember(*r)
    t0 = sync_time(torch)
    card.update()
    t_update = sync_time(torch) - t0
    check(all(c == 0 for c in ops.LAUNCHES.values()),
          f"the agent launched a kernel: {ops.LAUNCHES}")
    print(f"  (a) PPO update, 40-step rollout, state (6, 9), 10 actions: "
          f"card vs CPU max|err| {err:.3e} (tolerance {AGENT_TOL}); "
          f"update wall CPU {walls[0]:.3f} s, card first {walls[1]:.3f} s, "
          f"second {t_update:.3f} s")


class RoundLog:
    """Records, for one env, each round's (g1, g2) (the reset's warmup
    round at 2, 2; ``step``'s from its ``info``; ``step_raw``'s from its
    arguments) and its host wall, synchronised: it wraps the instance's
    ``reset``, ``step`` and ``step_raw``."""

    def __init__(self, torch, env):
        self.rounds, self.walls = [], []
        reset, step, step_raw = env.reset, env.step, env.step_raw
        warm = np.full(env.cfg.n_edges, 2)

        def timed(fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            self.walls.append(sync_time(torch) - t0)
            return out

        def reset_():
            self.rounds.append((warm, warm))
            return timed(reset)

        def step_(action):
            out = timed(step, action)
            self.rounds.append((out[3]["g1"], out[3]["g2"]))
            return out

        def step_raw_(g1, g2, participate=None):
            self.rounds.append((np.asarray(g1), np.asarray(g2)))
            return timed(step_raw, g1, g2, participate)

        env.reset, env.step, env.step_raw = reset_, step_, step_raw_

    def take(self):
        out = (self.rounds, self.walls)
        self.rounds, self.walls = [], []
        return out


def drive(torch, ops, env, log, label: str, fn):
    """Run ``fn()`` on ``env`` with the launch counts set to 0 just before
    and read just after; hold them to what the rounds' (g1, g2) imply,
    check what came out and print the run's walls. Returns fn's
    result."""
    ops.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    wall = sync_time(torch) - t0
    counts = dict(ops.LAUNCHES)
    rounds, walls = log.take()
    want = expected_launches(rounds, env.cfg.gamma_max)
    check(counts == want, f"{label}: launch counts {counts} != {want}")
    check(counts["segment_agg"] > 0 and counts["segment_broadcast"] > 0,
          f"{label}: a kernel was not launched")
    acc = np.asarray(env.acc_hist)
    check(len(acc) > 0 and np.isfinite(acc).all() and (acc >= 0).all()
          and (acc <= 1).all() and np.isfinite(env.energy_hist).all(),
          f"{label}: bad history {env.acc_hist}")
    for k, v in env.bank.items():
        check(v.device == env.device and bool(torch.isfinite(v).all())
              and torch.equal(v, env.global_model[k].expand_as(v)),
              f"{label}: bank leaf {k} not finite or not synced")
    w = np.asarray(walls)
    print(f"    {label:13s} {len(rounds):3d} rounds (resets included), "
          f"final acc {env.acc:.4f}, wall {wall:.2f} s; per round "
          f"min/median/max {w.min():.3f}/{np.median(w):.3f}/{w.max():.3f}"
          f" s; launches {counts}")
    return out


def fedavg_check(torch, hfl, model, ops, ref, env, dev) -> None:
    """(d) ``make_fedavg_round`` at CIFAR width: a 50 x 456,906 bank of
    distinct rows, every other device participating. One local epoch:
    exactly one ``segment_agg`` launch and every row equal to the global
    model. No local epoch: the global model within AGG_TOL of the plain
    weighted mean of the participating rows."""
    n = env.cfg.n_devices
    loss = lambda p, b: model.cnn_loss(model.cifar_cnn_apply, p, b)
    rnd = hfl.make_fedavg_round(loss, env.cfg.lr, env.cfg.batch_size, 1)
    gen = torch.Generator(device=dev).manual_seed(5)
    part = np.arange(n) % 2 == 0
    sizes = env.fed.device_sizes()
    perms = torch.rand((1, n, env.fed.n_local), generator=gen,
                       device=dev).argsort(dim=-1)
    for g1 in (1, 0):
        bank = hfl.init_bank(model.cifar_cnn_init, gen, n, device=dev)
        mat = hfl.flatbank.bank_spec(bank).flatten(bank)
        mat.add_(0.01 * torch.randn(mat.shape, generator=gen, device=dev))
        before = mat.clone()
        ops.reset_launches()
        t0 = time.perf_counter()
        bank, glob = rnd(bank, env.fed.x, env.fed.y, sizes, part, g1,
                         perms)
        wall = sync_time(torch) - t0
        counts = dict(ops.LAUNCHES)
        want = {"segment_agg": 1, "segment_broadcast": 0,
                "flash_attention": 0, "wkv6": 0}
        check(counts == want, f"fedavg round: launches {counts} != {want}")
        for k, v in bank.items():
            check(bool(torch.isfinite(v).all())
                  and torch.equal(v, glob[k].expand_as(v)),
                  f"fedavg round: bank leaf {k} not the global model")
        msg = ""
        if g1 == 0:
            w = sizes * torch.as_tensor(part, device=dev)
            seg = torch.zeros((n,), dtype=torch.int32, device=dev)
            plain = ref.segment_agg_ref(before, w, seg, 1)[0]
            got = hfl.flatbank.model_spec(glob).flatten_model(glob)
            err = float((got - plain).abs().max())
            check(torch.allclose(got, plain, atol=AGG_TOL, rtol=AGG_TOL),
                  f"fedavg round: global model vs plain mean {err:.3e}")
            msg = f", global vs plain mean max|err| {err:.3e}"
        print(f"  (d) make_fedavg_round, CIFAR {n} x {mat.shape[1]}, "
              f"{int(part.sum())} participating, gamma1 {g1}: wall "
              f"{wall:.3f} s, launches {counts}{msg}")


def agents_and_schemes(torch, ops, ref, env_mod, sync, ppo, hfl, model,
                       dev) -> None:
    """Phase 3c: (a) the agent's update card vs CPU; (b) the Arena path
    at the paper's CIFAR width; (c) every synchronous scheme at the
    MNIST defaults; (d) ``make_fedavg_round`` at CIFAR width."""
    agent_update_check(torch, ppo, ops, dev)

    t0 = time.perf_counter()
    env = env_mod.HFLEnv(env_mod.EnvConfig(**CIFAR_ARENA))
    check(env.device == dev, "the env's data is not on the card")
    c = env.cfg
    check((c.n_devices, c.n_edges, c.n_local, c.batch_size, c.gamma_max,
           c.lr, c.epsilon) == (50, 5, 1000, 32, 8, 0.01, 0.004),
          f"the CIFAR configuration is not the paper's: {c}")
    print(f"  (b) Arena, CIFAR: {c.n_devices} devices, {c.n_edges} edges, "
          f"n_local {c.n_local}, batch {c.batch_size}, gamma_max "
          f"{c.gamma_max}, lr {c.lr}, epsilon {c.epsilon}, T "
          f"{c.threshold_time} s; setup {sync_time(torch) - t0:.2f} s")
    log = RoundLog(torch, env)
    agent, tlog = drive(
        torch, ops, env, log, "train_agent",
        lambda: sync.train_agent(env, episodes=2))
    check(len(tlog.episode_acc) == 2
          and np.isfinite(tlog.episode_rewards).all(),
          f"train_agent: bad log {tlog}")
    check(all(v.device == dev and bool(torch.isfinite(v).all())
              for v in agent.params.values()),
          "the agent's params are not finite on the card")
    print(f"      episode rewards {np.round(tlog.episode_rewards, 4)}, "
          f"acc {np.round(tlog.episode_acc, 4)}")
    drive(torch, ops, env, log, "arena",
          lambda: sync.run_scheme("arena", env, agent=agent))
    fedavg_check(torch, hfl, model, ops, ref, env, dev)
    del env, log, agent

    t0 = time.perf_counter()
    env = env_mod.HFLEnv(env_mod.EnvConfig(**MNIST_SCHEMES))
    check(env.device == dev, "the env's data is not on the card")
    c = env.cfg
    print(f"  (c) the schemes, MNIST: {c.n_devices} devices, {c.n_edges} "
          f"edges, n_local {c.n_local}, batch {c.batch_size}, gamma_max "
          f"{c.gamma_max}, lr {c.lr}, T {c.threshold_time} s; setup "
          f"{sync_time(torch) - t0:.2f} s")
    log = RoundLog(torch, env)
    for name in STATIC_SCHEMES[:-1]:
        drive(torch, ops, env, log, name,
              lambda: sync.run_scheme(name, env))
    hw, _ = drive(
        torch, ops, env, log, "train hwamei",
        lambda: sync.train_agent(env, episodes=1, enhancements=False))
    drive(torch, ops, env, log, "hwamei",
          lambda: sync.run_scheme("hwamei", env, agent=hw))
    drive(torch, ops, env, log, "share",
          lambda: sync.run_scheme("share", env))
    try:
        sync.run_scheme("async-fedavg", env)
    except TypeError as e:
        print(f"    async-fedavg on HFLEnv raises TypeError: {e}")
    else:
        fail("async-fedavg ran on a synchronous HFLEnv")


# ---------------------------------------------------------------------------
# phase 3d: the asynchronous runtime
# ---------------------------------------------------------------------------

# a flush (the segment_agg kernel) against the numpy oracle on the same
# buffered vectors
FLUSH_TOL = 1e-5
# an edge round at CIFAR width in deterministic mode is bitwise its row of
# the cloud round, and the zero-decay K = 5 flush bitwise the cloud
# round's global model: in that mode every vmap(grad) call trains one
# fixed chunk of an edge's global rows (its 10 rows at the paper's
# width, hfl.train_calls), so a row's result depends on nothing but
# its own parameters and batch (ROADMAP section 3, faults 2 and 3). Plain
# mode trains the active rows only; its gap is printed, not held
EDGE_G1, EDGE_G2 = np.array([2, 1, 3, 2, 1]), np.array([1, 2, 2, 1, 2])
# phase 3d (c): the paper's CIFAR width in real mode; the fault windows
# and the deadline fall inside the first 20 events (simulated 102-284 s):
# an outage of edge 1 (start, length) and edge 4 leaving and rejoining.
# Until the whole script passed 900 s (phase 3l) it ran 40 events with
# the outage at [150, 230) s and the churn at 200 and 320 s; the
# compressed schedule keeps its degraded flushes, drops, retries and join
ASYNC_FAULTS = dict(drop_prob=0.1, transient_prob=0.2, seed=0)
ASYNC_EVENTS = 20
ASYNC_OUTAGE = (110.0, 60.0)
ASYNC_CHURN = (130.0, 200.0)
# phase 3d (d): T cut to 40 s (phase 3c: 50 s; paper 3000 s; 80 s
# until the whole script passed 800 s on a slower host: the agent's
# episode is then about 12 events, not 54) and async-fedavg to 5 events,
# so phase 3d stays within its 120 s
MNIST_ASYNC = dict(task="mnist", mode="real", threshold_time=40.0)
FEDAVG_EVENTS = 5


def _rounds_walls(torch, rounds) -> list:
    """Host walls of the (label, fn) pairs, synchronised, in order."""
    walls = []
    for _, fn in rounds:
        t0 = time.perf_counter()
        fn()
        walls.append(sync_time(torch) - t0)
    return walls


def deterministic_check(torch, hfl, flatbank, env) -> None:
    """(a) Two CIFAR-width warmup rounds (50 x 456,906, gamma (2, 2)) from
    one seeded bank and one set of shuffles in deterministic mode: the
    banks bitwise equal. Walls in turns: plain, deterministic,
    deterministic, plain."""
    c = env.cfg
    rounds = {det: hfl.make_cloud_round(
        env._loss_fn, c.lr, c.batch_size, c.n_edges, c.gamma_max,
        c.gamma_max, deterministic=det) for det in (False, True)}
    perms = env._draw_perms()
    g = np.full(c.n_edges, 2)
    banks = {}

    def run(det, i):
        bank = hfl.init_bank(env._init_fn, torch.Generator(
            device=env.device).manual_seed(11), c.n_devices,
            device=env.device)
        out = rounds[det](bank, env.fed.x, env.fed.y, env.fed.device_sizes(),
                          env._edge_assign_t, g, g, perms)
        banks[(det, i)] = flatbank.bank_spec(out[0]).flatten(out[0])

    order = [(False, 0), (True, 0), (True, 1), (False, 1)]
    walls = _rounds_walls(torch, [(k, lambda k=k: run(*k)) for k in order])
    same = torch.equal(banks[(True, 0)], banks[(True, 1)])
    plain_same = torch.equal(banks[(False, 0)], banks[(False, 1)])
    plain_d = float((banks[(False, 0)] - banks[(False, 1)]).abs().max())
    check(same, "deterministic mode: two warmup rounds differ")
    check(not torch.are_deterministic_algorithms_enabled(),
          "deterministic mode leaked out of the round")
    print(f"  (a) deterministic mode, CIFAR warmup round (2, 2), "
          f"{c.n_devices} x {banks[(True, 0)].shape[1]}: two runs bitwise "
          f"equal {same}; without the mode bitwise equal {plain_same} "
          f"(max|diff| {plain_d:.3e}); walls plain {walls[0]:.3f} / "
          f"{walls[3]:.3f} s, deterministic {walls[1]:.3f} / "
          f"{walls[2]:.3f} s")


def edge_round_check(torch, hfl, flatbank, ops, ref, runtime, env) -> None:
    """(b) ``make_edge_round`` at CIFAR width: a 50 x 456,906 bank of
    distinct rows, gamma1 [2, 1, 3, 2, 1], gamma2 [1, 2, 2, 1, 2]. Each
    edge's round from the snapshot w against row j of one cloud round
    started at w with the same shuffles, in plain mode (the gap printed)
    and in deterministic mode (bitwise); the other rows untouched
    bitwise; 1 + gamma2 ``segment_agg`` and gamma2 ``segment_broadcast``
    launches per edge round; the deterministic zero-decay K = 5 flush of
    the five bitwise the cloud round's global model and Eq. 2 of its
    inputs. Walls of every round in both modes."""
    c = env.cfg
    m, n = c.n_edges, c.n_devices
    mg1, mg2 = int(EDGE_G1.max()), int(EDGE_G2.max())
    gen = torch.Generator(device=env.device).manual_seed(12)
    start = hfl.init_bank(env._init_fn, gen, n, device=env.device)
    spec = flatbank.bank_spec(start)
    mat0 = spec.flatten(start)
    mat0.add_(0.01 * torch.randn(mat0.shape, generator=gen,
                                 device=env.device))
    gvec = mat0[0].clone()
    perms = torch.rand((mg2, mg1, n, c.n_local), generator=gen,
                       device=env.device).argsort(dim=-1)
    sizes, ea = env.fed.device_sizes(), env._edge_assign_t
    t_cloud, glob, em = {}, {}, {}
    for det in (False, True):
        cloud = hfl.make_cloud_round(env._loss_fn, c.lr, c.batch_size, m,
                                     mg1, mg2, deterministic=det)
        t0 = time.perf_counter()
        _, glob[det], em[det] = cloud(
            hfl.broadcast_model(spec.unflatten_model(gvec), n), env.fed.x,
            env.fed.y, sizes, ea, EDGE_G1, EDGE_G2, perms)
        t_cloud[det] = sync_time(torch) - t0
        em[det] = spec.flatten(em[det])
    edge_w = ref.segment_weight_sums(sizes, ea, m)
    buf = runtime.StalenessBuffer(m, decay="none", device=env.device)
    plain_d, walls, vecs = [], {False: [], True: []}, []
    for j in range(m):
        for det in (False, True):
            er = hfl.make_edge_round(env._loss_fn, c.lr, c.batch_size, m,
                                     mg1, mg2, deterministic=det)
            bank = spec.unflatten(mat0.clone())
            ops.reset_launches()
            t0 = time.perf_counter()
            bank, vec = er(bank, env.fed.x, env.fed.y, sizes, ea, j,
                           EDGE_G1[j], EDGE_G2[j], gvec, perms)
            walls[det].append(sync_time(torch) - t0)
            want = {"segment_agg": 1 + int(EDGE_G2[j]),
                    "segment_broadcast": int(EDGE_G2[j]),
                    "flash_attention": 0, "wkv6": 0}
            check(dict(ops.LAUNCHES) == want, f"edge round {j}: launches "
                  f"{dict(ops.LAUNCHES)} != {want}")
            after = spec.flatten(bank)
            other = ea != j
            check(torch.equal(after[other], mat0[other]),
                  f"edge round {j}: another edge's rows moved")
            if not det:
                plain_d.append(float((vec - em[False][j]).abs().max()))
                continue
            d = float((vec - em[True][j]).abs().max())
            check(torch.equal(vec, em[True][j]), f"deterministic edge round "
                  f"{j} is not bitwise row {j} of the cloud round "
                  f"(max|diff| {d:.3e})")
            buf.push(j, vec, float(edge_w[j]), version=0)
            vecs.append(vec)
    flush, _ = buf.flush(version=0)
    stack = torch.stack(vecs)
    eq2 = ops.segment_agg(stack, edge_w, torch.zeros(
        m, dtype=torch.int32, device=env.device), 1)[0]
    check(torch.equal(flush, eq2), "K = 5 flush is not Eq. 2 of its inputs")
    want = spec.flatten_model(glob[True])
    d_glob = float((flush - want).abs().max())
    check(torch.equal(flush, want), f"deterministic zero-decay K = 5 flush "
          f"is not bitwise the cloud round's global model ({d_glob:.3e})")
    print(f"  (b) make_edge_round, CIFAR {n} x {spec.width}, gamma1 "
          f"{EDGE_G1.tolist()}, gamma2 {EDGE_G2.tolist()}: deterministic "
          f"edge vectors bitwise their cloud-round rows, the K = 5 flush "
          f"bitwise the cloud global, other rows bitwise untouched; plain "
          f"mode max|edge vec - cloud row| per edge "
          f"{[f'{x:.3e}' for x in plain_d]}")
    ea_h = env.edge_assign
    chunks = [sum(int(np.all(ea_h[c] == j)) for c in hfl.train_calls(ea_h))
              for j in range(m)]
    blocks = [len(set((np.flatnonzero(ea_h == j) // 10).tolist()))
              for j in range(m)]
    print(f"      deterministic calls per epoch of each edge round "
          f"{chunks} (its chunks, hfl.train_calls); blocks of 10 "
          f"consecutive rows its rows span {blocks}")
    print(f"      walls, cloud round plain {t_cloud[False]:.3f} s, "
          f"deterministic {t_cloud[True]:.3f} s; edge rounds plain "
          f"{[round(w, 3) for w in walls[False]]} s (sum "
          f"{sum(walls[False]):.3f}), deterministic "
          f"{[round(w, 3) for w in walls[True]]} s (sum "
          f"{sum(walls[True]):.3f})")


class AsyncLog:
    """Wraps one ``AsyncHFLEnv``'s methods to count what launches a
    kernel -- warmup rounds (``reset``), landed uploads with their
    gamma2 (``_process_upload``), applied flushes (``_flush``), joins
    that resync (``_handle_join``) -- and to time each ``step``."""

    def __init__(self, torch, env):
        self.env = env
        self.clear()
        reset, step = env.reset, env.step
        process, flush, join = env._process_upload, env._flush, \
            env._handle_join

        def reset_():
            self.warmups += 1
            self.written = set()
            return reset()

        def step_(action):
            t0 = time.perf_counter()
            out = step(action)
            self.walls.append(sync_time(torch) - t0)
            return out

        def process_():
            ev = process()
            if ev is not None and not env._last_upload_lost:
                self.g2s.append(min(int(ev.payload["g2"]),
                                    env.cfg.gamma_max))
                self.written.add(ev.edge)
            return ev

        def flush_(degraded=False):
            flush(degraded)
            self.flushes += int(env._flushed)
            self.degraded += int(env._flushed and degraded)

        def join_(j):
            resync = not env._injector.alive[j]
            join(j)
            self.joins += int(resync)
            if resync:
                self.written.add(j)

        env.reset, env.step = reset_, step_
        env._process_upload, env._flush, env._handle_join = \
            process_, flush_, join_

    def clear(self) -> None:
        self.warmups, self.g2s, self.walls = 0, [], []
        self.flushes = self.joins = self.degraded = 0
        self.written = set()        # edges whose rows a round or join set

    def expected(self) -> dict:
        """Per warmup the cloud round's launches at (2, 2); per landed
        upload 1 + gamma2 ``segment_agg`` and gamma2
        ``segment_broadcast``; per applied flush one ``segment_agg``;
        per join one ``segment_broadcast``."""
        gmax = self.env.cfg.gamma_max
        warm = np.full(self.env.cfg.n_edges, 2)
        want = expected_launches([(warm, warm)] * self.warmups, gmax)
        want["segment_agg"] += sum(1 + g for g in self.g2s) + self.flushes
        want["segment_broadcast"] += sum(self.g2s) + self.joins
        return want


def async_drive(torch, ops, env, log, label: str, fn):
    """Run ``fn()`` with the launch counts set to 0 just before and read
    just after; hold them to what the events imply, check the history
    and the bank (finite on the card; every edge whose rows a landed
    round or a join set since the last reset has them equal to its edge
    model), and print the walls."""
    ops.reset_launches()
    log.clear()
    t0 = time.perf_counter()
    out = fn()
    wall = sync_time(torch) - t0
    counts, want = dict(ops.LAUNCHES), log.expected()
    check(counts == want, f"{label}: launch counts {counts} != {want}")
    check(counts["segment_agg"] > 0 and counts["segment_broadcast"] > 0,
          f"{label}: a kernel was not launched")
    acc = np.asarray(env.acc_hist)
    check(len(acc) > 0 and np.isfinite(acc).all() and (acc >= 0).all()
          and (acc <= 1).all() and np.isfinite(env.energy_hist).all(),
          f"{label}: bad history {env.acc_hist}")
    mat = env._spec.flatten(env.bank)
    check(mat.device == env.device and bool(torch.isfinite(mat).all())
          and bool(torch.isfinite(env._global_vec).all()),
          f"{label}: the bank or the global model is not finite")
    check(log.written, f"{label}: no edge round landed")
    for j in log.written:
        rows = mat[env._edge_assign_t == j]
        check(torch.equal(rows, env._edge_mat[j].to(mat.dtype).expand_as(
            rows)), f"{label}: edge {j}'s rows are not its edge model")
    w = np.asarray(log.walls) if log.walls else np.zeros(1)
    print(f"    {label:13s} {len(log.walls):3d} events, {log.warmups} "
          f"warmup(s), {len(log.g2s)} landed, {log.flushes} flushes "
          f"({log.degraded} degraded), {log.joins} joins, version "
          f"{env.version}, final acc {env.acc:.4f}, wall {wall:.2f} s; "
          f"per event min/median/max {w.min():.3f}/{np.median(w):.3f}/"
          f"{w.max():.3f} s; launches {counts}")
    return out


def faulty_cifar_run(torch, ops, ref, runtime, env_mod, cfg) -> dict:
    """(c) ``AsyncHFLEnv`` real at the paper's CIFAR width (buffer_k 3,
    poly decay, a 30 s flush deadline) with faults: drop 0.1, transient
    0.2, an outage of edge 1 (``ASYNC_OUTAGE``), edge 4 leaving and
    rejoining (``ASYNC_CHURN``); ``ASYNC_EVENTS`` events at action (2,
    2). Every applied
    flush within FLUSH_TOL of the numpy oracle on its buffered vectors;
    at the join, edge 4's rows become the global model and every other
    row stays bitwise; launches as the events imply."""
    spec = runtime.FaultSpec(
        outages=(runtime.Outage(1, *ASYNC_OUTAGE),),
        churn=(runtime.ChurnEvent(ASYNC_CHURN[0], 4, "leave"),
               runtime.ChurnEvent(ASYNC_CHURN[1], 4, "join")),
        **ASYNC_FAULTS)
    t0 = time.perf_counter()
    env = env_mod.AsyncHFLEnv(
        cfg, runtime.AsyncConfig(buffer_k=3, decay="poly",
                                 flush_deadline=30.0), faults=spec)
    c = env.cfg
    print(f"  (c) AsyncHFLEnv, CIFAR: {c.n_devices} devices, {c.n_edges} "
          f"edges, n_local {c.n_local}, buffer_k 3, poly decay, deadline "
          f"30 s, faults {ASYNC_FAULTS}, outage edge 1 [{ASYNC_OUTAGE[0]:g}, "
          f"{sum(ASYNC_OUTAGE):g}) s, edge 4 leaves {ASYNC_CHURN[0]:g} s, "
          f"joins {ASYNC_CHURN[1]:g} s; {ASYNC_EVENTS} events; setup "
          f"{sync_time(torch) - t0:.2f} s")
    flush_errs, joins = [], []
    flush = runtime.StalenessBuffer.flush

    def checked_flush(buf, version, max_staleness=0, anchor=None,
                      anchor_weight=0.0):
        slots = sorted(buf._slots, key=lambda s: (s.edge, s.arrival))
        glob, info = flush(buf, version, max_staleness, anchor,
                           anchor_weight)
        if glob is not None:
            u = np.stack([s.vec.cpu().numpy() for s in slots])
            w = np.float32([s.weight for s in slots])
            tau = [version - s.version for s in slots]
            want = (ref.coverage_aggregate_ref(
                u, w, tau, anchor.cpu().numpy(), anchor_weight)
                if anchor is not None and anchor_weight > 0 else
                ref.staleness_aggregate_ref(u, w, tau))
            err = float(np.abs(glob.cpu().numpy() - want).max())
            check(np.allclose(glob.cpu().numpy(), want, atol=FLUSH_TOL,
                              rtol=FLUSH_TOL), f"flush vs oracle {err}")
            flush_errs.append(err)
        return glob, info

    log = AsyncLog(torch, env)
    join = env._handle_join

    def checked_join(j):
        alive = env._injector.alive[j]
        before = env._spec.flatten(env.bank).clone()
        join(j)
        if alive:
            return
        after = env._spec.flatten(env.bank)
        rows = env._edge_assign_t == j
        check(torch.equal(after[~rows], before[~rows]),
              "join: another edge's rows moved")
        check(torch.equal(after[rows], env._global_vec.expand_as(
            after[rows])), "join: the joining rows are not the global model")
        joins.append(j)

    env._handle_join = checked_join

    def run():
        env.reset()
        for _ in range(ASYNC_EVENTS):
            if env.step(np.array([2.0, 2.0]))[2]:
                break

    runtime.StalenessBuffer.flush = checked_flush
    try:
        async_drive(torch, ops, env, log, "cifar faults", run)
    finally:
        runtime.StalenessBuffer.flush = flush
    fi = env._injector
    check(log.degraded > 0, "no degraded flush happened")
    check(joins == [4], f"edge 4 did not rejoin: {joins}")
    check(fi.n_dropped.sum() > 0 and fi.n_retries.sum() > 0,
          "no upload was dropped or retried")
    print(f"      flushes vs oracle max|err| {max(flush_errs):.3e} over "
          f"{len(flush_errs)} (tolerance {FLUSH_TOL}); dropped "
          f"{fi.n_dropped.tolist()}, retries {fi.n_retries.tolist()}; "
          f"per-event walls {[round(w, 3) for w in log.walls]}")
    return {"counts": dict(ops.LAUNCHES)}


def async_runtime(torch, ops, ref, env_mod, sync, hfl, flatbank,
                  runtime) -> dict:
    """Phase 3d: (a) deterministic mode; (b) the edge round against the
    cloud round at CIFAR width; (c) the faulty CIFAR run; (d) the async
    schemes at the MNIST defaults."""
    cifar = env_mod.EnvConfig(task="cifar", mode="real")
    t0 = time.perf_counter()
    env = env_mod.HFLEnv(cifar)
    c = env.cfg
    check((c.n_devices, c.n_edges, c.n_local, c.batch_size, c.lr)
          == (50, 5, 1000, 32, 0.01) and env.device.type == "cuda",
          f"not the paper's CIFAR on the card: {c}")
    print(f"  CIFAR env set up in {sync_time(torch) - t0:.2f} s")
    deterministic_check(torch, hfl, flatbank, env)
    edge_round_check(torch, hfl, flatbank, ops, ref, runtime, env)
    del env
    run = faulty_cifar_run(torch, ops, ref, runtime, env_mod, cifar)

    t0 = time.perf_counter()
    env = env_mod.AsyncHFLEnv(env_mod.EnvConfig(**MNIST_ASYNC),
                              runtime.AsyncConfig(buffer_k=2))
    c = env.cfg
    print(f"  (d) the async schemes, MNIST: {c.n_devices} devices, "
          f"{c.n_edges} edges, n_local {c.n_local}, buffer_k 2, T "
          f"{c.threshold_time} s; setup {sync_time(torch) - t0:.2f} s")
    log = AsyncLog(torch, env)
    async_drive(torch, ops, env, log, "async-fedavg",
                lambda: sync.run_scheme("async-fedavg", env,
                                        max_events=FEDAVG_EVENTS))
    agent, tlog = async_drive(torch, ops, env, log, "train_agent",
                              lambda: sync.train_agent(env, episodes=1))
    check(len(tlog.episode_acc) == 1
          and np.isfinite(tlog.episode_rewards).all(),
          f"train_agent on AsyncHFLEnv: bad log {tlog}")
    async_drive(torch, ops, env, log, "async-arena",
                lambda: sync.run_scheme("async-arena", env, agent=agent))
    return run


# ---------------------------------------------------------------------------
# phase 3e: checkpoints, telemetry, health and the ledger
# ---------------------------------------------------------------------------

# events of the no-perturbation and resume runs (save at half of them),
# at action (1, 1): in deterministic mode a landed upload trains its
# edge's 10-row call for gamma1 gamma2 epochs; the phase prints its wall
# against its 90 s budget. 16 until phase 3m came (the first cut that
# made room for it)
OBS_EVENTS = 8
OBS_ACTION = np.array([1.0, 1.0])


def _obs_env(torch, env_mod, runtime, cfg, on: bool):
    """The paper's CIFAR ``AsyncHFLEnv`` in deterministic mode with phase
    3d (c)'s fault rates, an outage of edge 1 over [150, 230) s and edge
    4 leaving at 200 s and rejoining at 320 s, telemetry and health on or
    off."""
    spec = runtime.FaultSpec(
        outages=(runtime.Outage(1, 150.0, 80.0),),
        churn=(runtime.ChurnEvent(200.0, 4, "leave"),
               runtime.ChurnEvent(320.0, 4, "join")), **ASYNC_FAULTS)
    c = dataclasses.replace(cfg, deterministic=True, telemetry=on,
                            health=on)
    return env_mod.AsyncHFLEnv(c, runtime.AsyncConfig(
        buffer_k=3, decay="poly", flush_deadline=30.0), faults=spec)


def _obs_steps(torch, env, n: int, walls: list) -> list:
    """``n`` events at OBS_ACTION: per event (reward, acc, edge,
    flushed), each event's host wall (synchronised) into ``walls``."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        _, r, done, info = env.step(OBS_ACTION)
        walls.append(sync_time(torch) - t0)
        out.append((float(r), float(info["acc"]), int(info["edge"]),
                    bool(info["flushed"])))
        check(not done, "phase 3e: the episode ended early")
    return out


def _same_model(torch, a, b) -> bool:
    return (torch.equal(a._global_vec, b._global_vec)
            and torch.equal(a._spec.flatten(a.bank), b._spec.flatten(b.bank)))


def observability(torch, ops, env_mod, runtime, sync, telemetry, store,
                  cfg) -> dict:
    """Phase 3e at the paper's CIFAR width, deterministic mode, phase 3d
    (c)'s faults: (a) OBS_EVENTS events at OBS_ACTION with telemetry,
    health and ``ktime`` off, then on: every event's (reward, acc, edge, flushed),
    the final global vector and the bank bitwise equal, ``ktime``'s call
    counts equal to the ``LAUNCHES`` deltas; (b) ``save_runtime`` at half
    the events of the on-run, ``load_runtime`` into a fresh env on the
    card, the rest bitwise the on-run's (trace too); (c) ``run_scheme(
    "async-fedavg", g1=1, g2=1, ledger=RunLedger(tmpdir))`` at MNIST
    width (T 40 s, FEDAVG_EVENTS events, deterministic, where an epoch
    trains the calls of 12-13 rows that hold an active device; (1, 1)
    keeps it short): rows written and read back,
    ``final_acc`` bitwise the same run's without a ledger. Returns the
    ``ktime`` medians (us) per kernel."""
    t_phase = time.perf_counter()
    walls = {False: [], True: []}
    envs, traj = {}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_3e_")
    ckpt = os.path.join(tmp, "rt")
    half = OBS_EVENTS // 2
    try:
        reg = telemetry.MetricsRegistry()
        for on in (False, True):
            env = envs[on] = _obs_env(torch, env_mod, runtime, cfg, on)
            ops.reset_launches()
            with (telemetry.kernel_timing(reg) if on
                  else contextlib.nullcontext()):
                env.reset()
                traj[on] = _obs_steps(torch, env, half, walls[on])
                if on:
                    t0 = time.perf_counter()
                    store.save_runtime(env, ckpt)
                    t_save = time.perf_counter() - t0
                traj[on] += _obs_steps(torch, env, OBS_EVENTS - half,
                                       walls[on])
            launches = dict(ops.LAUNCHES)
        check(traj[True] == traj[False], f"phase 3e (a): telemetry on "
              f"changed the events: {traj[True]} != {traj[False]}")
        check(_same_model(torch, envs[True], envs[False]),
              "phase 3e (a): telemetry on changed the model")
        for k in ("segment_agg", "segment_broadcast"):
            got = reg.counters.get(f"kernel/{k}_calls", 0)
            check(got == launches[k] > 0, f"phase 3e (a): ktime counted "
                  f"{got} {k} calls, LAUNCHES {launches[k]}")
        tm = envs[True].telemetry
        check(len(tm.recorder) > 0 and tm.metrics.counters["flushes"] > 0,
              "phase 3e (a): telemetry recorded nothing")
        med = {k: float(np.median(reg.hists[f"kernel/{k}_us"]))
               for k in ("segment_agg", "segment_broadcast")}
        w_off, w_on = np.asarray(walls[False]), np.asarray(walls[True])
        print(f"  (a) {OBS_EVENTS} events at {OBS_ACTION.tolist()}, CIFAR, "
              f"deterministic, faults: "
              f"telemetry + health + ktime on vs off bitwise equal (events,"
              f" global vector, bank); ktime calls = LAUNCHES "
              f"{launches['segment_agg']} / {launches['segment_broadcast']}"
              f"; {len(tm.recorder)} trace events, "
              f"{tm.metrics.counters['flushes']} flushes, health events "
              f"{len(envs[True].health.events)}")
        print(f"      per-event wall median / sum off {np.median(w_off):.3f}"
              f" / {w_off.sum():.3f} s, on {np.median(w_on):.3f} / "
              f"{w_on.sum():.3f} s; ktime median segment_agg "
              f"{med['segment_agg']:.1f} us over "
              f"{len(reg.hists['kernel/segment_agg_us'])} calls, "
              f"segment_broadcast {med['segment_broadcast']:.1f} us over "
              f"{len(reg.hists['kernel/segment_broadcast_us'])} calls")
        # (b) resume from the on-run's snapshot in a fresh env
        size_mb = (os.path.getsize(ckpt + ".npz")
                   + os.path.getsize(ckpt + ".json")) / 1e6
        env = _obs_env(torch, env_mod, runtime, cfg, True)
        t0 = time.perf_counter()
        store.load_runtime(env, ckpt)
        t_load = sync_time(torch) - t0
        check(env._global_vec.device == env.device
              and env._spec.flatten(env.bank).device == env.device,
              "phase 3e (b): the restored model is not on the card")
        tail = _obs_steps(torch, env, OBS_EVENTS - half, [])
        check(tail == traj[True][half:], f"phase 3e (b): the resumed events"
              f" differ: {tail} != {traj[True][half:]}")
        check(_same_model(torch, env, envs[True]),
              "phase 3e (b): the resumed model differs")
        check(env.telemetry.recorder.events == tm.recorder.events,
              "phase 3e (b): the resumed trace differs")
        print(f"  (b) save_runtime at event {half}, load_runtime into a "
              f"fresh env on the card, {OBS_EVENTS - half} more events: "
              f"bitwise the uninterrupted run (events, global vector, bank,"
              f" trace); snapshot {size_mb:.1f} MB, save {t_save:.3f} s, "
              f"load {t_load:.3f} s (its warmup round included)")
        del envs, env
        # (c) the ledger at MNIST width
        finals = {}
        for use in (False, True):
            env = env_mod.AsyncHFLEnv(
                env_mod.EnvConfig(**MNIST_ASYNC, deterministic=True),
                runtime.AsyncConfig(buffer_k=2))
            lg = telemetry.RunLedger(os.path.join(tmp, "ledger"))
            t0 = time.perf_counter()
            h = sync.run_scheme("async-fedavg", env, g1=1, g2=1,
                                max_events=FEDAVG_EVENTS,
                                ledger=lg if use else False)
            wall = sync_time(torch) - t0
            finals[use] = h["final_acc"]
        run = telemetry.ledger.load_run(lg.path(h["ledger_run_id"]))
        ep = run["episodes"]
        check(len(ep) == 1 and ep[0]["final_acc"] == h["final_acc"]
              and ep[0]["rounds"] == h["rounds"]
              and run["header"]["scheme"] == "async-fedavg",
              f"phase 3e (c): ledger rows {run}")
        check(finals[True] == finals[False], f"phase 3e (c): final_acc "
              f"with the ledger {finals[True]} != without {finals[False]}")
        print(f"  (c) run_scheme('async-fedavg', g1=1, g2=1, ledger="
              f"RunLedger), MNIST, T {MNIST_ASYNC['threshold_time']} s, "
              f"{FEDAVG_EVENTS} events, deterministic: run {h['ledger_run_id']}, header + "
              f"{len(ep)} episode row ({ep[0]['rounds']} rounds) read back;"
              f" final_acc {finals[True]} bitwise without the ledger; wall "
              f"{wall:.2f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase 3e took {time.perf_counter() - t_phase:.1f} s "
          f"(budget 90 s)")
    return med


# ---------------------------------------------------------------------------
# phase 3f: the sharded bank
# ---------------------------------------------------------------------------

# an edge whose rows span ranks splits its chain of sums at the
# all_reduce of segment_agg_sharded: f32 summation order
# (segment_agg_ordered, which the deterministic rounds use, chains the
# ranks in row order and is held bitwise)
SHARD_SPAN_TOL = 1e-5
SHARD_EDGES = 5                 # the CIFAR default: 5 edges of 10 devices
SHARD_WORLD = 2                 # edge 2 (rows 20-29) spans ranks 0 and 1
SHARD_BUDGET_S = 90.0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cifar_shard_env(env_mod, ctx):
    """The paper's CIFAR ``HFLEnv`` in deterministic mode under ``ctx``
    (None: one device), its 50 devices on 5 edges of 10 contiguous
    rows."""
    env = env_mod.HFLEnv(env_mod.EnvConfig(task="cifar", mode="real",
                                           deterministic=True, agg=ctx))
    n = env.cfg.n_devices
    env.set_topology(np.repeat(np.arange(SHARD_EDGES), n // SHARD_EDGES))
    return env


def _shard_reset(torch, ops, flatbank, env) -> dict:
    """``env.reset()`` (its warmup cloud round at (2, 2)) with the launch
    counts set to 0 just before and read just after, held to what the
    round implies; returns the global vector, this rank's bank rows and
    the wall."""
    ops.reset_launches()
    t0 = time.perf_counter()
    env.reset()
    wall = sync_time(torch) - t0
    counts = dict(ops.LAUNCHES)
    g = np.full(SHARD_EDGES, 2)
    want = expected_launches([(g, g)], env.cfg.gamma_max)
    check(counts == want, f"phase 3f: launch counts {counts} != {want}")
    spec = flatbank.model_spec(env.global_model)
    return {"gvec": spec.flatten_model(env.global_model).clone(),
            "bank": flatbank.bank_spec(env.bank).flatten(env.bank).clone(),
            "acc": env.acc, "wall": wall, "counts": counts,
            "rows": sorted({int(v.shape[0]) for v in env.bank.values()})}


def _shard_aggregation(torch, dist, hfl, hier_agg, ops, ref, ctx,
                       world: int) -> dict:
    """On every rank of a gloo group sharing the card: CIFAR Eq. 1 (50 x
    456,906, 5 contiguous edges, random weights) through
    ``segment_agg_sharded`` on this rank's rows against the single launch
    on the whole bank (edge 2, spanning the ranks, within SHARD_SPAN_TOL
    and the others bitwise) and against the plain version,
    one launch per call; the shard-local ``masked_resync`` with one alive
    edge bitwise the one-device resync and the plain gather
    (``ref.segment_broadcast_ref``) at this rank's rows; rank 0 graph-times the partial
    launch at this rank's shape while the others wait; every rank times
    the (5, P) ``all_reduce``."""
    dev, rank = ctx.mesh.device, ctx.mesh.rank
    gen = torch.Generator(device=dev).manual_seed(7)
    n, p, e = 50, 456906, SHARD_EDGES
    bank = torch.randn((n, p), generator=gen, device=dev)
    w = torch.rand((n,), generator=gen, device=dev) * 2 + 0.5
    seg = torch.repeat_interleave(torch.arange(e, device=dev),
                                  n // e).to(torch.int32)
    single = hier_agg._launch_segment_agg(bank, w, seg, e, normalize=True)[0]
    lb, lw, ls = ctx.place_rows(bank), ctx.place_rows(w), ctx.place_rows(seg)
    ops.reset_launches()
    got = ops.segment_agg_sharded(lb, lw, ls, e, ctx.mesh.group)
    launches = ops.LAUNCHES["segment_agg"]
    check(launches == 1, f"phase 3f: segment_agg_sharded made {launches} "
          f"launches")
    plain = ref.segment_agg_sharded_ref(lb, lw, ls, e, ctx.mesh.group)
    err = float((got - plain).abs().max())
    check(torch.allclose(got, plain, atol=AGG_TOL, rtol=AGG_TOL),
          f"phase 3f: {world} ranks, kernel vs plain max|err| {err:.3e}")
    gap = float((got - single).abs().max())
    span = 2                        # rows 20-29 on ranks 0 and 1 of 2
    keep = [j for j in range(e) if j != span]
    check(torch.equal(got[keep], single[keep]), "phase 3f: an edge on "
          "one rank is not bitwise the single launch")
    check(torch.allclose(got[span], single[span], atol=SHARD_SPAN_TOL,
                         rtol=SHARD_SPAN_TOL), f"phase 3f: the spanning "
          f"edge is {gap:.3e} off the single launch")
    ops.reset_launches()
    ordered = ops.segment_agg_ordered(lb, lw, ls, e, ctx.mesh.group)
    check(ops.LAUNCHES["segment_agg"] == 1, "phase 3f: segment_agg_ordered "
          "made more than one launch")
    check(torch.equal(ordered, single), f"phase 3f: {world} ranks, ordered "
          f"Eq. 1 is not bitwise the single launch "
          f"({float((ordered - single).abs().max()):.3e})")
    edge_mat = torch.randn((e, p), generator=gen, device=dev)
    alive = np.arange(e) == 2
    want = hfl.masked_resync(edge_mat, bank, seg, alive)[
        ctx.check_rows(n) * rank:ctx.check_rows(n) * (rank + 1)]
    resync = hfl.masked_resync(edge_mat, lb, ls, alive, ctx=ctx)
    check(torch.equal(resync, want), "phase 3f: the shard-local resync "
          "differs from the one-device resync")
    keep = torch.as_tensor(alive, device=dev)[ls.long()]
    check(torch.equal(resync, torch.where(
        keep[:, None], ref.segment_broadcast_ref(edge_mat, ls, lb.dtype),
        lb)), f"phase 3f: the shard-local resync ({lb.shape[0]} rows) "
          f"differs from the plain gather")
    del bank, single
    out = {"err": err, "gap": gap, "rows": int(lb.shape[0])}
    dist.barrier()
    if rank == 0:
        ones = torch.ones((e,), device=dev)
        onehot = (ls[None, :].long() == torch.arange(e, device=dev)[:, None])
        a_mat = onehot.float() * lw[None, :]
        out["ms"] = min(graph_ms(torch, lambda: hier_agg._launch_segment_agg(
            lb, lw, ls, e, normalize=False, with_wsum=True)) for _ in range(2))
        out["plain_ms"] = graph_ms(torch, lambda: (
            ref.segment_weight_sums(lw, ls, e),
            ref.segment_scaled_sum_ref(lb, lw, ls, ones, e)))
        out["library_ms"] = graph_ms(torch, lambda: torch.mm(a_mat, lb))
        nbytes = 4 * (lb.numel() + 2 * lb.shape[0] + e * p + e)
        out["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        out["mb"] = nbytes / 1e6
    dist.barrier()
    buf = torch.zeros((e, p), device=dev)
    walls = []
    for _ in range(6):
        t0 = sync_time(torch)
        dist.all_reduce(buf, group=ctx.mesh.group)
        walls.append(sync_time(torch) - t0)
    out["allreduce_ms"] = float(np.median(walls[1:]) * 1e3)
    return out


def _shard_rank(rank: int, world: int, port: int, outdir: str) -> None:
    """One rank of phase 3f (b), a ``torch.multiprocessing.spawn``
    target: a gloo group of ``world`` ranks on the one card; writes its
    results to ``outdir/rank<r>.pt``."""
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    from repro_torch.core import flatbank, hfl
    from repro_torch.kernels import hier_agg, ops, ref
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.sim import env as env_mod
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        ctx = mesh_lib.make_bank_context(world)
        res = _shard_aggregation(torch, dist, hfl, hier_agg, ops, ref, ctx,
                                 world)
        res["env"] = _shard_reset(torch, ops, flatbank,
                                  _cifar_shard_env(env_mod, ctx))
        torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def sharded_bank(torch, ops, env_mod, flatbank, mesh_lib) -> dict:
    """Phase 3f: (a) NCCL, one rank, in this process; (b) gloo, 2 ranks
    spawned on the one card. The ranks share the card with this
    process, so it runs before the LLM phases (3b, 3g), returns its
    cached blocks to the driver first and prints the card's free memory.
    Returns the JSON row's numbers."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        single = _shard_reset(torch, ops, flatbank,
                              _cifar_shard_env(env_mod, None))
        nccl = _shard_reset(torch, ops, flatbank, _cifar_shard_env(
            env_mod, mesh_lib.make_bank_context(1)))
    finally:
        dist.destroy_process_group()
    same = (torch.equal(nccl["gvec"], single["gvec"])
            and torch.equal(nccl["bank"], single["bank"])
            and nccl["acc"] == single["acc"])
    check(same, "phase 3f (a): the NCCL one-rank round is not bitwise the "
          "one-device round")
    print(f"  (a) NCCL, one rank: CIFAR deterministic warmup round (2, 2), "
          f"50 x 456,906, bitwise the one-device round (acc "
          f"{single['acc']:.4f}); walls one device {single['wall']:.3f} s, "
          f"one rank {nccl['wall']:.3f} s; launches {nccl['counts']}")
    ranks = {}
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"  card memory free before spawning {free / 2**30:.1f} of "
          f"{total / 2**30:.1f} GiB (this process holds "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB)")
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        for world in (SHARD_WORLD,):
            t0 = time.perf_counter()
            mp.spawn(_shard_rank, args=(world, _free_port(), d),
                     nprocs=world, join=True)
            ranks[world] = [torch.load(os.path.join(d, f"rank{r}.pt"))
                            for r in range(world)]
            print(f"  (b) gloo, {world} ranks sharing the card: spawned and "
                  f"ran in {time.perf_counter() - t0:.1f} s")
    for world, res in ranks.items():
        r0 = res[0]
        held = f"edge 2 within {SHARD_SPAN_TOL}, the others bitwise"
        print(f"    {world} ranks: Eq. 1 sharded vs single launch max|diff| "
              f"{max(r['gap'] for r in res):.3e} ({held}), vs plain "
              f"{max(r['err'] for r in res):.3e}; per-rank "
              f"segment_sum_partial ({r0['rows']} x 456,906 -> 5): "
              f"{r0['ms']:.4f} ms graph-timed, bound "
              f"{r0['bound_ms'] * 1e3:.2f} us ({r0['mb']:.1f} MB, "
              f"{r0['bound_ms'] / r0['ms'] * 100:.1f}% of bound), plain "
              f"{r0['plain_ms']:.4f} ms, torch.mm "
              f"{r0['library_ms']:.4f} ms; all_reduce of (5, 456,906) f32 "
              f"over gloo median {r0['allreduce_ms']:.3f} ms")
    for world, res in ranks.items():
        envs = [r["env"] for r in res]
        rows = 50 // world
        check(all(e["rows"] == [rows] for e in envs), f"phase 3f (b): a rank "
              f"holds more than N/{world} bank rows")
        gvecs = [e["gvec"] for e in envs]
        check(all(torch.equal(g, gvecs[0]) for g in gvecs),
              f"phase 3f (b): the {world} ranks' global models differ")
        bank = torch.cat([e["bank"] for e in envs]).to(single["bank"].device)
        gvec = gvecs[0].to(single["gvec"].device)
        gap = max(float((gvec - single["gvec"]).abs().max()),
                  float((bank - single["bank"]).abs().max()))
        print(f"    {world} ranks ({rows} rows each"
              f"{', edge 2 spanning ranks 0 and 1' if world == 2 else ''}):"
              f" CIFAR deterministic warmup round (2, 2) vs one process: "
              f"max|diff| {gap:.3e} (acc {envs[0]['acc']:.4f} vs "
              f"{single['acc']:.4f}); wall per rank "
              f"{np.median([e['wall'] for e in envs]):.3f} s (median), "
              f"launches per rank {envs[0]['counts']}")
        check(torch.equal(gvec, single["gvec"]) and torch.equal(
            bank, single["bank"]) and envs[0]["acc"] == single["acc"],
              f"phase 3f (b): the {world}-rank round is {gap:.3e} off the "
              f"one-process round, not bitwise (ROADMAP section 3, fault 3)")
    wall = time.perf_counter() - t_phase
    print(f"  phase 3f took {wall:.1f} s (budget {SHARD_BUDGET_S:.0f} s); "
          f"ranks sharing one card say nothing of multi-GPU scaling")
    r0 = ranks[SHARD_WORLD][0]
    return {"launches": sum(r["env"]["counts"]["segment_agg"]
                            for r in ranks[SHARD_WORLD]),
            "max_abs_err": max(r["err"] for r in ranks[SHARD_WORLD]),
            "ms": r0["ms"], "plain_ms": r0["plain_ms"],
            "bound_ms": r0["bound_ms"], "bound_by": "bytes",
            "library_ms": r0["library_ms"]}


# ---------------------------------------------------------------------------
# phase 3g: the hierarchical LLM train step
# ---------------------------------------------------------------------------

# (a) a reduced round on the card against the same round on the CPU, f32
# activations, TF32 off: the f32 parity tolerance of the CPU tests. rwkv6
# takes its two sequences per replica in one minibatch: its reduced round
# is ill-conditioned over 8 SGD steps (tests/_torch_train_ref.py)
TRAIN_TOL = 1e-4
TRAIN_MB = {"qwen3-1.7b": 2, "rwkv6-1.6b": 1, "olmoe-1b-7b": 2}
# the reference main's settings at full width: lr 3e-3, batch 8 x seq 128
# over replicas (1, 2, 2), 2 minibatches of one sequence per epoch, remat
TRAIN_KW = dict(lr=3e-3, mb_per_epoch=2, remat=True)
TRAIN_REPS = (1, 2, 2)
# (g1, g2) of the full-width qwen3-1.7b rounds of phases 3g (b)-(c), 3k (c)
# and 3l: (1, 1), 8 SGD steps a round on one device or a tp rank, 4 on
# each of 3k's 2 ranks. They ran the reference main's (2, 2) until phase
# 3m came: the depth cut that made room for it (PERF.md section 5)
FULL_G = 1
# four f32 replicas of qwen3-1.7b (32.5 GB), one replica's gradients
# (8.1 GB) and the largest per-leaf aggregation transient (2.8 GB)
TRAIN_MEM_GB = 45.0
TRAIN_BUDGET_S = 180.0


def _replicas_equal(torch, train, params) -> bool:
    r = int(np.prod(TRAIN_REPS))
    for leaf in train._leaves(params):
        v = leaf.view(r, -1)
        if not all(torch.equal(v[i], v[0]) for i in range(1, r)):
            return False
    return True


def _agg_launches(n_leaves: int, g2: int) -> dict:
    """A static round's launches: g2 edge means and one cloud mean, each
    one segment_agg and one segment_broadcast per leaf."""
    return {"segment_agg": (g2 + 1) * n_leaves,
            "segment_broadcast": (g2 + 1) * n_leaves, "flash_attention": 0,
            "wkv6": 0}


def small_train_check(torch, ops, configs, model_mod, train, mesh_lib,
                      token_batch, dev) -> None:
    """(a) Reduced qwen3, rwkv6 and olmoe (its loss carries the MoE aux
    loss), f32 activations, vocab 128: one (2, 2) round on replicas (1,
    2, 2), batch 8 x seq 32, KV chunks of 16, on the card and on the CPU
    from the same weights; every leaf within TRAIN_TOL, launches as the
    round implies on the card."""
    import dataclasses
    for arch in TRAIN_MB:
        cfg = dataclasses.replace(configs.get_config(arch).reduce(),
                                  activ_dtype="float32", vocab=128)
        p0 = model_mod.build_model(cfg).init(torch.Generator().manual_seed(0),
                                             "cpu")
        outs, counts = [], None
        for d in ("cpu", dev):
            hm = mesh_lib.make_hfl_mesh(TRAIN_REPS, device=d)
            step, _, _ = train.make_hfl_train_step(
                cfg, hm, lr=3e-3, mb_per_epoch=TRAIN_MB[arch], remat=False,
                g1=2, g2=2, attn_chunk=16)
            params = train.lift_params(_tree_to(p0, d), *TRAIN_REPS)
            ops.reset_launches()
            out = step(params, token_batch(0, 8, 32, cfg.vocab, device=d))
            counts = dict(ops.LAUNCHES)
            check(_replicas_equal(torch, train, out), f"phase 3g (a) {arch}: "
                  f"replicas differ after the round on {d}")
            outs.append(train._leaves(out))
        n = len(outs[0])
        check(counts == _agg_launches(n, 2), f"phase 3g (a) {arch}: "
              f"launches {counts} != {_agg_launches(n, 2)}")
        err = max(float((a - b.cpu()).abs().max())
                  for a, b in zip(*outs))
        check(err <= TRAIN_TOL, f"phase 3g (a) {arch}: card vs CPU max|err| "
              f"{err:.3e} > {TRAIN_TOL}")
        print(f"  (a) reduced {arch} (f32 activations), (2, 2) round on "
              f"(1, 2, 2): card vs CPU max|err| {err:.3e} (tolerance "
              f"{TRAIN_TOL}), launches {counts}")


def _full_round(torch, ops, train, step, params, batch, args=()):
    """One train-step call with the launch counts set to 0 just before and
    read just after; returns (params, wall s, launches)."""
    ops.reset_launches()
    t0 = sync_time(torch)
    params = step(params, batch, *args)
    return params, sync_time(torch) - t0, dict(ops.LAUNCHES)


def llm_train(torch, ops, configs, model_mod, train, mesh_lib, device_mod,
              dev) -> dict:
    """Phase 3g: (a) reduced rounds card vs CPU; (b) full-width
    qwen3-1.7b, one static ``FULL_G`` round on replicas (1, 2, 2); (c)
    dynamic = static bitwise in deterministic mode, then a dynamic round
    with the reference main's draws; (d) one round at train_4k's length;
    (e) full-width rwkv6-1.6b, one (1, 1) round through ``wkv_chunked``.
    Returns the JSON rows' launches."""
    from repro_torch.data.synthetic import token_batch
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    small_train_check(torch, ops, configs, model_mod, train, mesh_lib,
                      token_batch, dev)
    cfg = configs.get_config("qwen3-1.7b")
    model = model_mod.build_model(cfg)
    hm = mesh_lib.make_hfl_mesh(TRAIN_REPS, device=dev)
    reps = int(np.prod(TRAIN_REPS))

    def init():
        """Seed-0 weights lifted to the replicas (one copy at a time)."""
        p1 = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        out = train.lift_params(p1, *TRAIN_REPS)
        del p1
        return out

    def loss_of(params, batch) -> float:
        with torch.no_grad():
            return float(model.loss(train._map(lambda a: a[0, 0, 0], params),
                                    batch))

    batch = token_batch(0, 8, 128, cfg.vocab, device=dev)
    evalb = token_batch(9999, 8, 128, cfg.vocab, device=dev)
    kw = dict(TRAIN_KW, attn_chunk=128)

    # (b) one static round at full width
    params = init()
    n_leaves = len(train._leaves(params))
    loss0 = loss_of(params, evalb)
    step, specs, _ = train.make_hfl_train_step(cfg, hm, g1=FULL_G,
                                               g2=FULL_G, **kw)
    torch.cuda.reset_peak_memory_stats(dev)
    params, wall, counts = _full_round(torch, ops, train, step, params, batch)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    want = _agg_launches(n_leaves, FULL_G)
    check(counts == want, f"phase 3g (b): launches {counts} != {want}")
    check(_replicas_equal(torch, train, params), "phase 3g (b): replicas "
          "differ after the cloud round")
    loss1 = loss_of(params, evalb)
    check(np.isfinite(loss0) and np.isfinite(loss1),
          f"phase 3g (b): loss {loss0} -> {loss1}")
    # phase 3k's full-width round on 2 ranks is held against these
    full = {"loss": loss1, "names": list(_flat(params)),
            "stats": [_leaf_stats(torch, a[0, 0, 0])
                      for a in train._leaves(params)]}
    n_sgd = FULL_G ** 2 * reps * TRAIN_KW["mb_per_epoch"]
    print(f"  (b) qwen3-1.7b full width ({cfg.n_params():,} parameters, f32 "
          f"weights, bf16 activations), replicas {TRAIN_REPS}, batch 8 x "
          f"seq 128, (g1, g2) = ({FULL_G}, {FULL_G}), remat, KV chunks of "
          f"128: round "
          f"{wall:.3f} s, {n_sgd} SGD steps, {wall / n_sgd:.4f} s per step "
          f"(aggregations included); replica 0's loss on token_batch(9999) "
          f"{loss0:.4f} -> {loss1:.4f}; peak memory {peak:.2f} GB "
          f"(reckoned {TRAIN_MEM_GB:.0f} GB); launches {counts} = (g2 + 1) "
          f"x {n_leaves} leaves; replicas bitwise equal; embed spec "
          f"{specs['embed']}")
    del params

    # (b') the same round with KV chunks of 64: another summation order,
    # the round's own response to it, which bounds phase 3l's loss
    ctl, _, _ = train.make_hfl_train_step(cfg, hm, g1=FULL_G, g2=FULL_G,
                                          **dict(kw, attn_chunk=64))
    params, w_ctl, _ = _full_round(torch, ops, train, ctl, init(), batch)
    ctl_loss = loss_of(params, evalb)
    full["reorder_rel"] = _replica_rel(
        {"loss": ctl_loss, "stats": [_leaf_stats(torch, a[0, 0, 0])
                                     for a in train._leaves(params)]}, full)
    del params
    print(f"  (b') the same round with KV chunks of 64 ({w_ctl:.3f} s): loss "
          f"{ctl_loss:.6f}; its response to that summation order: loss "
          f"{full['reorder_rel'][0]:.3e}, per-leaf sums of squares "
          f"{full['reorder_rel'][1]:.3e}, sums over L1 "
          f"{full['reorder_rel'][2]:.3e} (relative to (b))")

    # (c) dynamic = static bitwise, deterministic mode
    dyn, _, _ = train.make_hfl_train_step(cfg, hm, dynamic=True, max_g1=3,
                                          max_g2=3, **kw)
    with device_mod.deterministic_algorithms():
        params, w_static, c_static = _full_round(torch, ops, train, step,
                                                 init(), batch)
        ref0 = [leaf[0, 0, 0].cpu() for leaf in train._leaves(params)]
        del params
        g = np.full(TRAIN_REPS[1], FULL_G)
        params, w_dyn, c_dyn = _full_round(torch, ops, train, dyn, init(),
                                           batch, (g, g))
    same = c_dyn == c_static and all(
        torch.equal(leaf[0, 0, 0].cpu(), r)
        for leaf, r in zip(train._leaves(params), ref0))
    check(same and _replicas_equal(torch, train, params), f"phase 3g (c): "
          f"the dynamic round at g1e = g2e = {FULL_G} is not bitwise the "
          f"static ({FULL_G}, {FULL_G}) round")
    del ref0
    print(f"  (c) deterministic mode: dynamic round (g1e = g2e = {FULL_G}, "
          f"bounds (3, 3)) bitwise the static ({FULL_G}, {FULL_G}) round, "
          f"launches equal; walls "
          f"static {w_static:.3f} s, dynamic {w_dyn:.3f} s")
    rng = np.random.default_rng(0)        # the reference main's draws
    g1e, g2e = rng.integers(1, 3, 2), rng.integers(1, 3, 2)
    main_dyn, _, _ = train.make_hfl_train_step(cfg, hm, dynamic=True,
                                               max_g1=4, max_g2=4, **kw)
    params, w_main, c_main = _full_round(torch, ops, train, main_dyn, params,
                                         batch, (g1e, g2e))
    t2s = int(g2e.max())
    bcast = sum(1 if (t2 < g2e).all() else int((t2 < g2e).sum())
                for t2 in range(t2s)) + 1
    want = {"segment_agg": (t2s + 1) * n_leaves,
            "segment_broadcast": bcast * n_leaves, "flash_attention": 0,
            "wkv6": 0}
    check(c_main == want, f"phase 3g (c): launches {c_main} != {want}")
    loss2 = loss_of(params, evalb)
    check(np.isfinite(loss2), f"phase 3g (c): loss {loss2}")
    print(f"  (c) dynamic round with the reference main's draws g1e "
          f"{g1e.tolist()}, g2e {g2e.tolist()} (bounds (4, 4)): "
          f"{w_main:.3f} s, launches {c_main}, loss {loss2:.4f}")
    del params

    # (d) train_4k's length: one sequence of 4096 per replica
    params = init()
    step4k, _, _ = train.make_hfl_train_step(
        cfg, hm, g1=1, g2=1, lr=3e-3, mb_per_epoch=1, remat=True,
        attn_chunk=1024)
    torch.cuda.reset_peak_memory_stats(dev)
    params, w4k, c4k = _full_round(torch, ops, train, step4k, params,
                                   token_batch(1, reps, 4096, cfg.vocab,
                                               device=dev))
    peak4k = torch.cuda.max_memory_allocated(dev) / 1e9
    check(c4k == _agg_launches(n_leaves, 1), f"phase 3g (d): launches {c4k}")
    loss4k = loss_of(params, token_batch(9999, 1, 4096, cfg.vocab,
                                         device=dev))
    check(np.isfinite(loss4k), f"phase 3g (d): loss {loss4k}")
    print(f"  (d) seq 4096 (train_4k), one sequence per replica, (1, 1), "
          f"KV chunks of 1024 (4 per attention), xent in 8 chunks: round "
          f"{w4k:.3f} s ({w4k / reps:.3f} s per SGD step), peak memory "
          f"{peak4k:.2f} GB, loss {loss4k:.4f}")
    del params
    torch.cuda.empty_cache()

    # (e), (e') rwkv6-1.6b at full width
    rwkv = rwkv_rounds(torch, ops, configs, model_mod, train, mesh_lib,
                       token_batch, dev)
    # (f), (f'), (f32) whisper-base at full width
    whisper = whisper_rounds(torch, ops, configs, model_mod, train,
                             mesh_lib, dev)
    wall = time.perf_counter() - t_phase
    print(f"  phase 3g took {wall:.1f} s (budget {TRAIN_BUDGET_S:.0f} s)")
    return {"launches": counts, "full": full, "rwkv": rwkv,
            "whisper": whisper}


def rwkv_rounds(torch, ops, configs, model_mod, train, mesh_lib,
                token_batch, dev) -> dict:
    """Phase 3g (e): full-width rwkv6-1.6b (f32 weights from seed 0, bf16
    activations), one static (1, 1) round of replicas (1, 2, 2) at the
    reference main's settings (batch 8 x seq 128) through
    ``wkv_chunked``; (e') the same round through ``wkv_scan`` (the
    reference's ``use_chunked=False``; without remat, which changes no
    value): only a summation order changes,
    so (e')'s distance from (e) is the bf16 round's own response to one,
    which bounds phase 3m's loss. Returns (e)'s replica 0 loss and
    per-leaf stats (``_leaf_stats``) and (e')'s response
    (``_replica_rel``)."""
    cfg = configs.get_config("rwkv6-1.6b")
    model = model_mod.build_model(cfg)
    hm = mesh_lib.make_hfl_mesh(TRAIN_REPS, device=dev)
    batch = token_batch(0, 8, 128, cfg.vocab, device=dev)
    evalb = token_batch(9999, 8, 128, cfg.vocab, device=dev)
    n_sgd = int(np.prod(TRAIN_REPS)) * TRAIN_KW["mb_per_epoch"]
    out = {}
    for label, chunked in (("e", True), ("e'", False)):
        p1 = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        params = train.lift_params(p1, *TRAIN_REPS)
        del p1
        # (e') without remat: a recomputed layer gives the same values, so
        # only the WKV route changes, and the 128 sequential token steps
        # of wkv_scan run once forward instead of twice
        step, _, _ = train.make_hfl_train_step(
            cfg, hm, g1=1, g2=1, wkv_chunked=chunked,
            **dict(TRAIN_KW, attn_chunk=128, remat=chunked))
        n = len(train._leaves(params))
        n_params = sum(a[0, 0, 0].numel() for a in train._leaves(params))
        params, wall, counts = _full_round(torch, ops, train, step, params,
                                           batch)
        check(counts == _agg_launches(n, 1),
              f"phase 3g ({label}): launches {counts}")
        check(_replicas_equal(torch, train, params),
              f"phase 3g ({label}): replicas differ")
        with torch.no_grad():
            loss = float(model.loss(train._map(lambda a: a[0, 0, 0], params),
                                    evalb, wkv_chunked=True))
        check(np.isfinite(loss), f"phase 3g ({label}): loss {loss}")
        res = {"loss": loss, "names": list(_flat(params)),
               "stats": [_leaf_stats(torch, a[0, 0, 0])
                         for a in train._leaves(params)]}
        del params
        torch.cuda.empty_cache()
        route = "wkv_chunked" if chunked else "wkv_scan"
        if chunked:
            out = res
            print(f"  (e) rwkv6-1.6b full width ({n_params:,} "
                  f"parameters, f32 weights, bf16 activations), (1, 1) "
                  f"round, batch 8 x seq 128, remat, {route}: {wall:.3f} s "
                  f"({wall / n_sgd:.4f} s per SGD step), launches {counts}, "
                  f"replica 0's loss on token_batch(9999) {loss:.6f}")
            continue
        out["reorder_rel"] = _replica_rel(res, out)
        worst = _worst_leaves(res, out)
        print(f"  (e') the same round through {route} ({wall:.3f} s): loss "
              f"{loss:.6f}; its response to that summation order: loss "
              f"{out['reorder_rel'][0]:.3e}, per-leaf sums of squares "
              f"{out['reorder_rel'][1]:.3e} ({worst[0]}), sums over L1 "
              f"{out['reorder_rel'][2]:.3e} ({worst[1]}) (relative to (e))")
    return out


# phase 3g (f'): the whisper blocks' own KV chunk, min(1024, S), cut to
# 512: the encoder's self-attention and the decoder's cross-attention
# over 1500 frames then sum their online softmax over chunks of 512,
# 512 and 476 instead of 1024 and 476, another summation order (the
# decoder's 128 tokens stay one chunk), as 3g (b') cuts qwen3's
WHISPER_REORDER_CHUNK = 512


@contextlib.contextmanager
def _whisper_kv_chunks(n: int):
    """The whisper blocks' training route in KV chunks of ``n``
    (``transformer._whisper_chunk``), inside the context."""
    from repro_torch.models import transformer
    saved = transformer._whisper_chunk
    transformer._whisper_chunk = lambda attn_chunk, s: (
        None if attn_chunk is None else min(n, s))
    try:
        yield
    finally:
        transformer._whisper_chunk = saved


def whisper_batch(cfg, seed: int, dev) -> dict:
    """whisper-base's batch at the reference main's shape (8 x 128
    tokens, ``token_batch(seed)``) with ``enc_embed`` (8, 1500, 512) from
    ``serve.stub_extras(seed)``."""
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch.serve import stub_extras
    return {**token_batch(seed, 8, 128, cfg.vocab, device=dev),
            **stub_extras(cfg, 8, seed, dev)}


def whisper_rounds(torch, ops, configs, model_mod, train, mesh_lib,
                   dev) -> dict:
    """Phase 3g (f): full-width whisper-base (f32 weights from seed 0,
    bf16 activations), one static (1, 1) round on replicas (1, 2, 2) at
    the reference main's settings (batch 8 x seq 128 with ``enc_embed``,
    lr 3e-3, 2 minibatches per epoch, remat): launches held, replicas
    bitwise equal, replica 0's loss and per-leaf stats kept for phase
    3n; (f') the same round in KV chunks of ``WHISPER_REORDER_CHUNK``,
    another summation order: its response, which bounds phase 3n's bf16
    round; (f32) the round with f32 activations, which phase 3n's f32
    round is held to at ``REPLICA_REL`` outright. Returns (f)'s results
    with (f')'s response (``reorder_rel``) and (f32)'s under "f32"."""
    base = configs.get_config("whisper-base")
    hm = mesh_lib.make_hfl_mesh(TRAIN_REPS, device=dev)
    n_sgd = int(np.prod(TRAIN_REPS)) * TRAIN_KW["mb_per_epoch"]
    out = {}
    for label, act, chunk in (("f", "bfloat16", None),
                              ("f'", "bfloat16", WHISPER_REORDER_CHUNK),
                              ("f32", "float32", None)):
        cfg = dataclasses.replace(base, activ_dtype=act)
        model = model_mod.build_model(cfg)
        p1 = model.init(torch.Generator(device=dev).manual_seed(0), dev)
        params = train.lift_params(p1, *TRAIN_REPS)
        del p1
        n = len(train._leaves(params))
        n_params = sum(a[0, 0, 0].numel() for a in train._leaves(params))
        step, _, _ = train.make_hfl_train_step(
            cfg, hm, g1=1, g2=1, **dict(TRAIN_KW, attn_chunk=128))
        torch.cuda.reset_peak_memory_stats(dev)
        with _whisper_kv_chunks(chunk) if chunk else \
                contextlib.nullcontext():
            params, wall, counts = _full_round(
                torch, ops, train, step, params,
                whisper_batch(cfg, 0, dev))
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        check(counts == _agg_launches(n, 1),
              f"phase 3g ({label}): launches {counts}")
        check(_replicas_equal(torch, train, params),
              f"phase 3g ({label}): replicas differ")
        with torch.no_grad():
            loss = float(model.loss(train._map(lambda a: a[0, 0, 0], params),
                                    whisper_batch(cfg, 9999, dev)))
        check(np.isfinite(loss), f"phase 3g ({label}): loss {loss}")
        res = {"loss": loss, "names": list(_flat(params)),
               "stats": [_leaf_stats(torch, a[0, 0, 0])
                         for a in train._leaves(params)],
               "counts": counts}
        del params
        torch.cuda.empty_cache()
        if label == "f":
            out = res
            print(f"  (f) whisper-base full width ({n_params:,} parameters, "
                  f"f32 weights, bf16 activations), (1, 1) round, batch 8 x "
                  f"seq 128 with enc_embed (8, 1500, 512), remat: {wall:.3f}"
                  f" s ({wall / n_sgd:.4f} s per SGD step), peak memory "
                  f"{peak:.2f} GB, launches {counts}, replica 0's loss on "
                  f"the seed-9999 batch {loss:.6f}")
        elif label == "f'":
            out["reorder_rel"] = _replica_rel(res, out)
            worst = _worst_leaves(res, out)
            print(f"  (f') the same round in KV chunks of {chunk} "
                  f"({wall:.3f} s): loss {loss:.6f}; its response to that "
                  f"summation order: loss {out['reorder_rel'][0]:.3e}, "
                  f"per-leaf sums of squares {out['reorder_rel'][1]:.3e} "
                  f"({worst[0]}), sums over L1 {out['reorder_rel'][2]:.3e} "
                  f"({worst[1]}) (relative to (f))")
        else:
            out["f32"] = res
            print(f"  (f32) the round with f32 activations ({wall:.3f} s, "
                  f"peak {peak:.2f} GB): loss {loss:.6f}")
    return out


# ---------------------------------------------------------------------------
# phase 3k: the replica plane over gloo ranks on the one card
# ---------------------------------------------------------------------------

# (a) phase 3e's faulty CIFAR AsyncHFLEnv in deterministic mode at phase
# 3e's action (1, 1) (an event trains its edge's rows for one epoch, a
# quarter of 3d's (2, 2)), saved after SNAP_EVENTS of REPLICA_EVENTS (40
# and 20 until phase 3l came; 20 and 10 until phase 3n came, the cut that
# made room for it)
REPLICA_EVENTS = 10
SNAP_EVENTS = 5
# (c) the reduced round's rank grid at 2 ranks (mesh.rank_grid), and the
# full-width round's: replicas (1, 2, 2) as blocks of (1, 2, 1), so both
# Eq. 1 and Eq. 2 cross the ranks. A 4-rank world ran the reduced round
# too until phase 3m came (the second cut that made room for it; tests/
# test_torch_cuda.py's multi-rank card test keeps 4 ranks)
REPLICA_WORLDS = (2,)
# full width against phase 3g (b)'s one-device round: replica 0's loss, and
# per leaf the f64 sum of squares relative to itself and the f64 sum
# relative to the leaf's L1 norm (a sum near 0 has no relative scale of
# its own); 3g's card-vs-CPU bound
REPLICA_REL = 1e-4
# per rank at full width: two f32 replicas of qwen3-1.7b (16.2 GB), one
# replica's gradients (8.1 GB), remat's activations and bf16 casts (2-4 GB),
# and Eq. 1's partial sums and means of the largest leaf (2 x 2.8 GB)
REPLICA_MEM_GB = 32.0
REPLICA_BUDGET_S = 120.0


def _replica_round(torch, ops, train, cfg, hm, kw, init, batch,
                   deterministic: bool, g: int = 2):
    """One static (g, g) round of ``cfg`` on ``hm`` from ``init()`` (one
    replica's tree), the launch counts set to 0 just before and read
    just after; returns (this rank's params, wall s, launches)."""
    from repro_torch import device as device_mod
    step, _, _ = train.make_hfl_train_step(cfg, hm, g1=g, g2=g, **kw)
    p1 = init()
    params = train.lift_params(p1, *hm.block)
    del p1
    mode = device_mod.deterministic_algorithms() if deterministic else \
        contextlib.nullcontext()
    ops.reset_launches()
    t0 = sync_time(torch)
    with mode:
        params = step(params, batch)
    return params, sync_time(torch) - t0, dict(ops.LAUNCHES)


def _small_train_setup(torch, configs, model_mod, token_batch, dev):
    """Phase 3g (a)'s reduced qwen3 (f32 activations, vocab 128), its
    seed-0 weights moved to ``dev``, batch and step settings."""
    cfg = dataclasses.replace(configs.get_config("qwen3-1.7b").reduce(),
                              activ_dtype="float32", vocab=128)
    init = lambda: _tree_to(model_mod.build_model(cfg).init(
        torch.Generator().manual_seed(0), "cpu"), dev)
    kw = dict(lr=3e-3, mb_per_epoch=TRAIN_MB["qwen3-1.7b"], remat=False,
              attn_chunk=16)
    return cfg, init, token_batch(0, 8, 32, cfg.vocab, device=dev), kw


class _AllReduceTimer:
    """Wraps the ``torch.distributed`` collectives ``names`` (default:
    ``all_reduce``) while on: each call synchronised and timed, its
    milliseconds listed by its group (None: the world) in ``ms``,
    counted by (name, group) in ``calls`` and listed in call order with
    its (name, group) in ``order``."""

    def __init__(self, torch, dist, names=("all_reduce",)):
        self.torch, self.dist, self.names = torch, dist, names
        self.ms, self.calls, self.order = {}, {}, []

    def _timed(self, name, fn):
        def timed(*args, group=None, **kw):
            t0 = sync_time(self.torch)
            out = fn(*args, group=group, **kw)
            ms = (sync_time(self.torch) - t0) * 1e3
            self.ms.setdefault(group, []).append(ms)
            key = (name, group)
            self.calls[key] = self.calls.get(key, 0) + 1
            self.order.append((key, ms))
            return out
        return timed

    def __enter__(self):
        self.saved = {n: getattr(self.dist, n) for n in self.names}
        for n, fn in self.saved.items():
            setattr(self.dist, n, self._timed(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.dist, n, fn)


def _replica_full(torch, dist, ops, configs, model_mod, train, mesh_lib,
                  token_batch, hm) -> dict:
    """(c) full width on this rank: qwen3-1.7b (f32 weights from seed 0,
    bf16 activations) at phase 3g (b)'s settings, one static ``FULL_G``
    round of this rank's block; its wall, peak memory, launches, the
    all_reduce milliseconds of Eq. 1 (the fl group) and Eq. 2 (the
    world), whether every leaf of every replica equals rank 0's replica
    (0, 0, 0) bitwise (broadcast leaf by leaf), and on rank 0 replica 0's
    loss and per-leaf f64 sum, L1 norm and sum of squares."""
    dev = hm.device
    cfg = configs.get_config("qwen3-1.7b")
    model = model_mod.build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    init = lambda: model.init(torch.Generator(device=dev).manual_seed(0), dev)
    with _AllReduceTimer(torch, dist) as timer:
        params, wall, counts = _replica_round(
            torch, ops, train, cfg, hm, dict(TRAIN_KW, attn_chunk=128), init,
            token_batch(0, 8, 128, cfg.vocab, device=dev), False, FULL_G)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    leaves = train._leaves(params)
    same = True
    for leaf in leaves:
        r0 = leaf[0, 0, 0].contiguous() if hm.rank == 0 else \
            torch.empty_like(leaf[0, 0, 0])
        dist.broadcast(r0, src=0)
        rows = leaf.view((-1,) + tuple(leaf.shape[3:]))
        same = same and all(torch.equal(r, r0) for r in rows)
        del r0
    out = {"wall": wall, "peak": peak, "counts": counts, "same": same,
           "n_leaves": len(leaves), "block": hm.block,
           "eq1_ms": float(np.sum(timer.ms.get(hm.fl_group, [0.0])))
           / FULL_G,
           "eq2_ms": float(np.sum(timer.ms.get(None, [0.0])))}
    if hm.rank == 0:
        with torch.no_grad():
            out["loss"] = float(model.loss(
                train._map(lambda a: a[0, 0, 0], params),
                token_batch(9999, 8, 128, cfg.vocab, device=dev)))
        out["stats"] = [_leaf_stats(torch, a[0, 0, 0]) for a in leaves]
    del params, leaves
    torch.cuda.empty_cache()
    return out


def _leaf_stats(torch, a) -> tuple:
    """(sum, L1 norm, sum of squares) of one leaf, in f64."""
    d = a.double()
    return float(d.sum()), float(d.abs().sum()), float((d * d).sum())


def _replica_rel(got: dict, ref: dict) -> tuple:
    """A round's replica 0 against a reference round's ({"loss", "stats"}
    each): the loss relative to the reference's, and the largest per-leaf
    sum of squares relative to itself and sum relative to the leaf's L1
    norm."""
    return (abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
            max(abs(a[2] - b[2]) / b[2]
                for a, b in zip(got["stats"], ref["stats"])),
            max(abs(a[0] - b[0]) / b[1]
                for a, b in zip(got["stats"], ref["stats"])))


def _worst_leaves(got: dict, ref: dict) -> tuple:
    """The leaves (by ``ref["names"]``) at ``_replica_rel``'s largest
    per-leaf sum of squares and largest sum over L1."""
    sq = [abs(a[2] - b[2]) / b[2] for a, b in zip(got["stats"], ref["stats"])]
    sm = [abs(a[0] - b[0]) / b[1] for a, b in zip(got["stats"], ref["stats"])]
    return ref["names"][int(np.argmax(sq))], ref["names"][int(np.argmax(sm))]


def _replica_rank(rank: int, world: int, port: int, outdir: str) -> None:
    """One rank of phase 3k, a ``torch.multiprocessing.spawn`` target: a
    gloo group of ``world`` ranks on the one card. At 2 ranks (a), (b),
    (c)'s reduced round and the full-width round, then phase 3n's
    rounds (``_fsdp_rounds``) in the same world; at any other world
    (c)'s reduced round alone. Writes its results to
    ``outdir/rank<r>-<world>.pt``."""
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    from repro_torch import configs, runtime
    from repro_torch.checkpoint import store
    from repro_torch.core import flatbank, sync
    from repro_torch.data.synthetic import token_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    from repro_torch.models import model as model_mod
    from repro_torch.sim import env as env_mod
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        res = {}
        if world == 2:
            ctx = mesh_lib.make_bank_context(2)
            # (a) snapshots
            env = _obs_env(torch, env_mod, runtime, env_mod.EnvConfig(
                task="cifar", mode="real", agg=ctx), False)
            env.reset()
            head = _obs_steps(torch, env, SNAP_EVENTS, [])
            path = os.path.join(outdir, "snap-k2")
            t0 = sync_time(torch)
            store.save_runtime(env, path)
            t_save = sync_time(torch) - t0
            tail = _obs_steps(torch, env, REPLICA_EVENTS - SNAP_EVENTS, [])
            whole = (env._global_vec.cpu(),
                     env._spec.flatten(env.bank).cpu())
            del env
            env = _obs_env(torch, env_mod, runtime, env_mod.EnvConfig(
                task="cifar", mode="real", agg=ctx), False)
            t0 = sync_time(torch)
            store.load_runtime(env, path)
            t_load = sync_time(torch) - t0
            resumed = _obs_steps(torch, env, REPLICA_EVENTS - SNAP_EVENTS,
                                 [])
            res["snap"] = {
                "traj": head + tail, "resumed": resumed, "gvec": whole[0],
                "bank": whole[1], "save_s": t_save, "load_s": t_load,
                "resumed_gvec": env._global_vec.cpu(),
                "resumed_bank": env._spec.flatten(env.bank).cpu(),
                "rows": sorted({int(v.shape[0]) for v in env.bank.values()})}
            del env
            # (b) share
            env = env_mod.HFLEnv(env_mod.EnvConfig(
                task="mnist", mode="real", deterministic=True, agg=ctx))
            assign = sync.share_topology(env)
            env.set_topology(assign)
            env.reset()
            spec = flatbank.model_spec(env.global_model)
            res["share"] = {"assign": assign, "acc": env.acc,
                            "gvec": spec.flatten_model(
                                env.global_model).cpu(),
                            "bank": flatbank.bank_spec(env.bank).flatten(
                                env.bank).cpu()}
            del env
        # (c) the reduced round in deterministic mode
        grid = mesh_lib.rank_grid(TRAIN_REPS, world)
        hm = mesh_lib.make_hfl_mesh(TRAIN_REPS, ranks=grid)
        cfg, init, batch, kw = _small_train_setup(torch, configs, model_mod,
                                                  token_batch, hm.device)
        params, wall, counts = _replica_round(torch, ops, train, cfg, hm, kw,
                                              init, batch, True)
        whole = mesh_lib.gather_params(params, hm)
        res["small"] = {"grid": grid, "wall": wall, "counts": counts,
                        "n_leaves": len(train._leaves(params)),
                        "round": [a.cpu() for a in train._leaves(whole)]
                        if rank == 0 else None}
        del params, whole
        if world == 2:
            res["full"] = _replica_full(torch, dist, ops, configs, model_mod,
                                        train, mesh_lib, token_batch, hm)
            res["fsdp"] = _fsdp_rounds(torch, dist, ops, configs, model_mod,
                                       train, mesh_lib)
        torch.save(res, os.path.join(outdir, f"rank{rank}-{world}.pt"))
    finally:
        dist.destroy_process_group()


def replica_plane(torch, ops, env_mod, runtime, sync, flatbank, store,
                  configs, model_mod, train, mesh_lib, trained, dev) -> dict:
    """Phase 3k: gloo ranks spawned on the one card, each world of
    ``REPLICA_WORLDS`` (2: all of (a)-(c), the full-width round last),
    all at once; meanwhile, in this process, the one-device
    references: (a)'s deterministic faulty CIFAR run with its snapshot
    at SNAP_EVENTS, (b)'s ``share_topology`` and round at the MNIST
    defaults, (c)'s reduced round on the card in deterministic mode.
    Then each world is held against its reference. Returns the JSON
    rows' launches of the full-width round."""
    from repro_torch.data.synthetic import token_batch
    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_3k_", dir=os.path.join(
        ROOT, "build"))
    try:
        torch.cuda.empty_cache()
        worlds = {world: mp.spawn(_replica_rank, args=(
            world, _free_port(), tmp), nprocs=world, join=False)
            for world in REPLICA_WORLDS}
        env = _obs_env(torch, env_mod, runtime, env_mod.EnvConfig(
            task="cifar", mode="real"), False)
        env.reset()
        traj = _obs_steps(torch, env, SNAP_EVENTS, [])
        store.save_runtime(env, os.path.join(tmp, "snap-one"))
        traj += _obs_steps(torch, env, REPLICA_EVENTS - SNAP_EVENTS, [])
        one = {"gvec": env._global_vec.cpu(),
               "bank": env._spec.flatten(env.bank).cpu()}
        del env
        env = env_mod.HFLEnv(env_mod.EnvConfig(task="mnist", mode="real",
                                               deterministic=True))
        assign = sync.share_topology(env)
        env.set_topology(assign)
        env.reset()
        share = {"assign": assign, "acc": env.acc,
                 "gvec": flatbank.model_spec(env.global_model).flatten_model(
                     env.global_model).cpu(),
                 "bank": flatbank.bank_spec(env.bank).flatten(
                     env.bank).cpu()}
        del env
        hm = mesh_lib.make_hfl_mesh(TRAIN_REPS, device=dev)
        cfg, init, batch, kw = _small_train_setup(torch, configs, model_mod,
                                                  token_batch, dev)
        params, _, _ = _replica_round(torch, ops, train, cfg, hm, kw, init,
                                      batch, True)
        small = [a.cpu() for a in train._leaves(params)]
        del params
        torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t_phase
        ranks = {}
        for world, spawned in worlds.items():
            while not spawned.join():
                pass
            ranks[world] = [torch.load(os.path.join(
                tmp, f"rank{r}-{world}.pt"), weights_only=False)
                for r in range(world)]
            print(f"  gloo, {world} ranks sharing the card: done "
                  f"{time.perf_counter() - t_phase:.1f} s into the phase")
        print(f"  the one-device references in this process, beside the "
              f"ranks, took {t_ref:.1f} s")
        # (a)
        res = [r["snap"] for r in ranks[2]]
        for r in res:
            check(r["traj"] == traj and r["resumed"] == traj[SNAP_EVENTS:],
                  "phase 3k (a): the 2-rank events differ from one device")
            check(torch.equal(r["gvec"], one["gvec"]) and torch.equal(
                r["resumed_gvec"], one["gvec"]), "phase 3k (a): the "
                "global model differs")
            check(r["rows"] == [25], f"phase 3k (a): rows {r['rows']}")
        for key in ("bank", "resumed_bank"):
            check(torch.equal(torch.cat([r[key] for r in res]), one["bank"]),
                  f"phase 3k (a): the 2-rank {key} differs from one device")
        with np.load(os.path.join(tmp, "snap-one.npz")) as a, \
                np.load(os.path.join(tmp, "snap-k2.npz")) as b:
            check(a.files == b.files and all(
                a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                for k in a.files), "phase 3k (a): the sharded snapshot's "
                "arrays are not the one-device snapshot's")
        size_mb = sum(os.path.getsize(os.path.join(tmp, f"snap-k2.{x}"))
                      for x in ("npz", "json")) / 1e6
        print(f"  (a) CIFAR AsyncHFLEnv, phase 3e's faults, "
              f"deterministic, action {OBS_ACTION.tolist()}, 2 ranks of 25 "
              f"rows: save_runtime after {SNAP_EVENTS} events, "
              f"load_runtime into a fresh sharded env, events "
              f"{SNAP_EVENTS + 1}-{REPLICA_EVENTS} bitwise the uninterrupted"
              f" 2-rank run and the one-device run (events, global vector, "
              f"bank); the snapshot's arrays bitwise the one-device "
              f"snapshot's; {size_mb:.1f} MB, save {res[0]['save_s']:.3f} s"
              f" (the gather included), load {res[0]['load_s']:.3f} s (its "
              f"warmup round included)")
        # (b)
        for r in ranks[2]:
            sh = r["share"]
            check(np.array_equal(sh["assign"], share["assign"]),
                  "phase 3k (b): the 2-rank share assignment differs")
            check(sh["acc"] == share["acc"] and torch.equal(
                sh["gvec"], share["gvec"]), "phase 3k (b): the round after "
                "share differs from one device")
        check(torch.equal(torch.cat([r["share"]["bank"] for r in ranks[2]]),
                          share["bank"]), "phase 3k (b): the bank differs")
        print(f"  (b) share_topology at the MNIST defaults on 2 ranks: the "
              f"one-device assignment ({np.bincount(share['assign']).tolist()}"
              f" devices per edge); the deterministic (2, 2) round after it "
              f"bitwise the one-device round (acc {share['acc']:.4f})")
        # (c) reduced
        for world in REPLICA_WORLDS:
            res = [r["small"] for r in ranks[world]]
            want = _agg_launches(res[0]["n_leaves"], 2)
            for r in res:
                got = {k: r["counts"][k] for k in want}
                check(got == want, f"phase 3k (c) {world} ranks: launches "
                      f"{got} != {want}")
            check(all(torch.equal(a, b) for a, b in zip(res[0]["round"],
                                                        small)),
                  f"phase 3k (c): the {world}-rank reduced round is not "
                  f"bitwise the one-device card round")
            print(f"  (c) reduced qwen3 (f32 activations), replicas "
                  f"{TRAIN_REPS} over rank grid {res[0]['grid']} on {world} "
                  f"ranks, deterministic (2, 2) round: bitwise the one-device"
                  f" card round; launches per rank {res[0]['counts']}; wall "
                  f"{max(r['wall'] for r in res):.3f} s")
        # (c) full width
        full = [r["full"] for r in ranks[2]]
        ref = trained["full"]
        n = full[0]["n_leaves"]
        want = _agg_launches(n, FULL_G)
        for r in full:
            got = {k: r["counts"][k] for k in want}
            check(got == want, f"phase 3k (c) full width: launches {got} "
                  f"!= {want}")
            check(r["same"], "phase 3k (c) full width: a replica differs "
                  "from rank 0's replica (0, 0, 0)")
        rel_loss, rel_sq, rel_sum = _replica_rel(full[0], ref)
        check(max(rel_loss, rel_sq, rel_sum) <= REPLICA_REL,
              f"phase 3k (c) full width: vs 3g (b) loss {rel_loss:.3e}, sum "
              f"of squares {rel_sq:.3e}, sum {rel_sum:.3e} > {REPLICA_REL}")
        wall = max(r["wall"] for r in full)
        n_sgd = FULL_G ** 2 * int(np.prod(full[0]["block"])) * TRAIN_KW[
            "mb_per_epoch"]
        print(f"  (c) qwen3-1.7b full width (f32 weights, bf16 activations),"
              f" replicas {TRAIN_REPS} as blocks of {full[0]['block']} on 2 "
              f"ranks, batch 8 x seq 128, ({FULL_G}, {FULL_G}), remat, KV "
              f"chunks of 128, plain mode: round {wall:.3f} s, {n_sgd} SGD "
              f"steps per rank "
              f"({wall / n_sgd:.4f} s per step, the ranks sharing the card); "
              f"gloo all_reduce per Eq. 1 {full[0]['eq1_ms']:.1f} / "
              f"{full[1]['eq1_ms']:.1f} ms, per Eq. 2 "
              f"{full[0]['eq2_ms']:.1f} / {full[1]['eq2_ms']:.1f} ms (rank 0"
              f" / 1); peak memory {full[0]['peak']:.2f} / "
              f"{full[1]['peak']:.2f} GB (reckoned {REPLICA_MEM_GB:.0f} GB); "
              f"launches per rank {full[0]['counts']}; every replica "
              f"bitwise rank 0's replica (0, 0, 0); vs 3g (b)'s one-device "
              f"round: loss {full[0]['loss']:.6f} vs {ref['loss']:.6f} "
              f"(relative {rel_loss:.3e}), per leaf sum of squares "
              f"{rel_sq:.3e}, sum over L1 {rel_sum:.3e} (bound "
              f"{REPLICA_REL})")
        check(max(r["peak"] for r in full) <= REPLICA_MEM_GB,
              f"phase 3k (c): peak memory over {REPLICA_MEM_GB} GB")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    print(f"  phase 3k took {wall:.1f} s (budget {REPLICA_BUDGET_S:.0f} s, "
          f"phase 3n's rounds included); ranks sharing one card say nothing "
          f"of multi-GPU scaling")
    return {"launches": {k: sum(r["counts"][k] for r in full)
                         for k in ("segment_agg", "segment_broadcast")},
            "fsdp": [r["fsdp"] for r in ranks[2]], "wall": wall}


# ---------------------------------------------------------------------------
# phase 3n: the fsdp axis, each whisper-base replica over 2 gloo fsdp ranks
# ---------------------------------------------------------------------------

# whisper-base's published topology (8, 16, 2, 1) splits each replica over
# F = 2 fsdp ranks (T = 1): here replicas (1, 2, 2), all on each of phase
# 3k's 2 ranks, one rank per fsdp coordinate. The reference's specs split
# the MLPs' w_up, b_up and w_down over ("fsdp", "tp"); the guard keeps the
# embedding and unembedding (vocab 51,865, odd) whole, and attention,
# dec_pos, the norms and b_down are whole
FSDP_WORLD = 2
FSDP_SPLIT = sorted(f"{stack}/mlp/{leaf}" for stack in ("enc_layers",
                                                         "layers")
                    for leaf in ("w_up", "b_up", "w_down"))
# per rank: four f32 replicas' blocks (101.4 M of whisper-base's 114.0 M
# parameters a replica: the MLPs, 25.2 M, halved), 1.62 GB; one
# replica's gradients (0.41 GB); remat's activations over 1500 frames,
# the (128, 51,865) logits in bf16 and f32 and Eq. 1's means (< 1 GB)
FSDP_MEM_GB = 4.0
FSDP_BUDGET_S = 60.0


def _fsdp_rounds(torch, dist, ops, configs, model_mod, train,
                 mesh_lib) -> dict:
    """Phase 3n on this rank of phase 3k's 2-rank world: replicas (1, 2,
    2) of full-width whisper-base, each split over the world's 2 ranks
    as fsdp (``make_hfl_mesh(fsdp=2)``), one static (1, 1) round at
    phase 3g (f)'s settings (``_split_round`` over the ft group) with
    bf16 activations, then with f32. Returns both, keyed by the
    activation dtype."""
    t0 = time.perf_counter()
    hm = mesh_lib.make_hfl_mesh(TRAIN_REPS, fsdp=FSDP_WORLD)
    out = {}
    for act in ("bfloat16", "float32"):
        cfg = dataclasses.replace(configs.get_config("whisper-base"),
                                  activ_dtype=act)
        out[act] = _split_round(
            torch, dist, ops, train, mesh_lib, model_mod, cfg, hm,
            dict(TRAIN_KW, attn_chunk=128), 1,
            whisper_batch(cfg, 0, hm.device),
            whisper_batch(cfg, 9999, hm.device), {}, hm.ft_group)
    out["wall_s"] = time.perf_counter() - t0
    return out


def fsdp_plane(torch, res: list, trained: dict, wall_3k: float) -> dict:
    """Phase 3n's checks on the ranks' ``_fsdp_rounds`` results ``res``:
    the leaves split are ``FSDP_SPLIT``, halved on each rank; the bf16
    round held by ``_hold_split`` against phase 3g (f) (bounded by the
    larger of ``REPLICA_REL`` and 3g (f')'s response), the f32 round
    against 3g (f32) at ``REPLICA_REL`` outright. Returns the bf16
    round's launches summed over the ranks."""
    for act in ("bfloat16", "float32"):
        rounds = [r[act] for r in res]
        for r in rounds:
            check(r["split"] == FSDP_SPLIT, f"phase 3n: the leaves split "
                  f"are {r['split']}, not {FSDP_SPLIT}")
        ref = trained["whisper"] if act == "bfloat16" else \
            trained["whisper"]["f32"]
        _hold_split(rounds, ref, f"3n ({act})", 1,
                    "3g (f)" if act == "bfloat16" else "3g (f32)",
                    f"3g (f')'s KV chunks of {WHISPER_REORDER_CHUNK}"
                    if act == "bfloat16" else None, FSDP_MEM_GB,
                    f"whisper-base full width (f32 weights, {act} "
                    f"activations), replicas {TRAIN_REPS} on each rank, "
                    f"each split over {FSDP_WORLD} gloo fsdp ranks sharing "
                    f"the card (the published (8, 16, 2, 1)), batch 8 x "
                    f"seq 128 with enc_embed, (1, 1), remat, plain mode",
                    "ft")
    shapes = res[0]["bfloat16"]["shapes"]
    print(f"  split leaves, a rank's block each: " + ", ".join(
        f"{k} {shapes[k]}" for k in FSDP_SPLIT) + f"; embed {shapes['embed']}"
          f" and unembed {shapes['unembed']} whole (the guard: 51,865 is "
          f"odd)")
    print(f"  phase 3n took {max(r['wall_s'] for r in res):.1f} s on the "
          f"ranks (budget {FSDP_BUDGET_S:.0f} s), inside phase 3k's 2-rank "
          f"world ({wall_3k:.1f} s with it)")
    return {k: sum(r["bfloat16"]["counts"][k] for r in res)
            for k in ("segment_agg", "segment_broadcast")}


# ---------------------------------------------------------------------------
# phase 3l: the tensor plane, each replica over 4 gloo tp ranks on the card
# ---------------------------------------------------------------------------

# qwen3-1.7b's and rwkv6-1.6b's published topology (8, 8, 1, 4) splits
# each replica over T = 4 tp ranks; here replicas (1, 2, 2), all on every
# rank (rank grid (1, 1, 1)), one rank per tp coordinate
TP_WORLD = 4
# per phase: the model, its (g, g) round at phase 3g's settings (3l:
# 3g (b)'s; 3m: 3g (e)'s, through wkv_chunked), the loss's own options
# and the key of its one-device reference in phase 3g's results. The
# reference's train step is the reference main's (batch 8 x seq 128, lr
# 3e-3, 2 minibatches per epoch, remat)
TP_RUNS = {
    "3l": dict(arch="qwen3-1.7b", g=FULL_G,
               kw=dict(TRAIN_KW, attn_chunk=128),
               loss_kw={}, ref="full", ref_name="3g (b)",
               reorder="3g (b')'s KV chunks of 64", serve=True),
    "3m": dict(arch="rwkv6-1.6b", g=1,
               kw=dict(TRAIN_KW, attn_chunk=128, wkv_chunked=True),
               loss_kw=dict(wkv_chunked=True), ref="rwkv", ref_name="3g (e)",
               reorder="3g (e')'s wkv_scan")}
# per rank. 3l: its quarter of four f32 replicas of qwen3-1.7b (8.1 GB),
# of one replica's gradients (2.0 GB), remat's activations and bf16 casts
# (< 1 GB) and Eq. 1's means of the largest leaf's block (0.7 GB). 3m:
# rwkv6-1.6b's tree holds 1,599,768,576 parameters (6.40 GB f32; the
# config's analytic n_params, 1,980,104,704, also counts attention
# projections an RWKV block does not have), a rank's blocks 416,937,984
# of them (the leaves no spec splits, 22.7 M, whole on every rank): four
# replicas' blocks 6.67 GB, one's gradients 1.67 GB, Eq. 1's means of
# the largest block (4 x 88,080,384 -> 2, 0.7 GB) and remat's
# activations and casts (< 1 GB). The staggered draw of one whole replica
# comes before the round
TP_MEM_GB = {"3l": 14.0, "3m": 12.0}
TP_BUDGET_S = {"3l": 150.0, "3m": 120.0}


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _one_leaf(path: str, leaf) -> dict:
    """A tree holding only ``leaf`` at ``path``."""
    for key in reversed(path.split("/")):
        leaf = {key: leaf}
    return leaf


def _split_round(torch, dist, ops, train, mesh_lib, model_mod, cfg, hm, kw,
                 g: int, batch, evalb, loss_kw, group) -> dict:
    """One static (g, g) round of ``cfg``'s full-width replicas (1, 2,
    2), each split over ``hm``'s tensor ranks (gloo ranks sharing the
    card, ``group`` the one its layers' collectives cross, tp or ft):
    draws the seed-0 replica on the card one rank at a time and keeps
    its tensor blocks, runs the round with the launch counts set to 0
    just before and the collectives timed, holds every leaf no spec
    splits against rank 0's (bitwise, broadcast leaf by leaf), then
    gathers replica (0, 0, 0) whole on rank 0 leaf by leaf and takes
    its loss on ``evalb`` (``loss_kw``) and per-leaf stats there."""
    dev, rank = hm.device, dist.get_rank()
    model = model_mod.build_model(cfg)
    t0 = time.perf_counter()
    for r in range(dist.get_world_size()):     # one whole replica at a time
        if r == rank:
            p1 = model.init(torch.Generator(device=dev).manual_seed(0), dev)
            blocks = mesh_lib.tp_blocks(p1, hm)
            del p1
            torch.cuda.empty_cache()
        dist.barrier()
    params = train.lift_params(blocks, *hm.block)
    del blocks
    t_init = time.perf_counter() - t0
    step, specs, _ = train.make_hfl_train_step(cfg, hm, g1=g, g2=g, **kw)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with _AllReduceTimer(torch, dist, ("all_reduce", "all_gather")) as timer:
        ops.reset_launches()
        t0 = sync_time(torch)
        params = step(params, batch)
        wall = sync_time(torch) - t0
        counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    flat = _flat(params)
    split = {k: mesh_lib.tensor_cut(spec, hm) is not None
             for k, spec in _flat(specs).items()}
    same_rep = True
    for k in (k for k, cut in split.items() if not cut):
        r0 = flat[k].clone()
        dist.broadcast(r0, src=0)
        same_rep = same_rep and torch.equal(r0, flat[k])
    ms = timer.ms.get(group, [])
    out = {"wall": wall, "peak": peak, "counts": counts,
           "init_s": t_init, "n_leaves": len(flat),
           "replicas_equal": _replicas_equal(torch, train, params),
           "replicated_equal": same_rep, "block": hm.block,
           "n_whole": sum(not c for c in split.values()),
           "split": sorted(k for k, c in split.items() if c),
           "shapes": {k: tuple(a.shape[3:]) for k, a in flat.items()},
           "tp_rank": hm.tp_rank, "ft_rank": hm.ft_rank,
           "gloo_s": float(np.sum(ms)) / 1e3, "gloo_calls": len(ms),
           "gathers": timer.calls.get(("all_gather", group), 0),
           "shard_gb": sum(a.numel() * a.element_size()
                           for a in flat.values()) / 1e9}
    whole = {}
    t0 = time.perf_counter()
    for k, a in flat.items():
        leaf = _flat(mesh_lib.gather_replica(_one_leaf(k, a[0, 0, 0]),
                                             hm, specs))[k]
        if rank == 0:
            whole[k] = leaf.clone()
        del leaf
    del params, flat
    torch.cuda.empty_cache()
    out["gather_s"] = time.perf_counter() - t0
    if rank == 0:
        one = {}
        for k, a in whole.items():
            d = one
            *head, last = k.split("/")
            for part in head:
                d = d.setdefault(part, {})
            d[last] = a
        with torch.no_grad():
            out["loss"] = float(model.loss(one, evalb, **loss_kw))
        # in the tree's order, as phase 3g takes them
        out["stats"] = [_leaf_stats(torch, a) for a in whole.values()]
        out["names"] = list(whole)
        del one, whole
    torch.cuda.empty_cache()
    return out


def _tp_rank(rank: int, world: int, port: int, outdir: str,
             phase: str) -> None:
    """One rank of phase 3l or 3m (``TP_RUNS[phase]``), a
    ``torch.multiprocessing.spawn`` target: a gloo group of ``world`` tp
    ranks on the one card, one static round of replicas (1, 2, 2)
    (``_split_round``, over the tp group). Writes its results to
    ``outdir/rank<r>.pt``."""
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.data.synthetic import token_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    from repro_torch.models import model as model_mod
    run = TP_RUNS[phase]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        hm = mesh_lib.make_hfl_mesh(TRAIN_REPS, tp=world)
        cfg = configs.get_config(run["arch"])
        out = _split_round(
            torch, dist, ops, train, mesh_lib, model_mod, cfg, hm, run["kw"],
            run["g"],
            token_batch(0, 8, 128, cfg.vocab, device=hm.device),
            token_batch(9999, 8, 128, cfg.vocab, device=hm.device),
            run["loss_kw"], hm.tp_group)
        if run.get("serve"):
            del hm
            torch.cuda.empty_cache()
            out["serve"] = _serve_tp(torch, dist, configs, model_mod,
                                     token_batch, outdir)
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def tensor_plane(torch, trained, phase: str, serve_ref=None) -> dict:
    """Phase 3l (full-width qwen3-1.7b, one static ``FULL_G`` round at
    phase 3g (b)'s settings) or 3m (full-width rwkv6-1.6b, one static (1,
    1) round at 3g (e)'s): each of replicas (1, 2, 2) split over
    ``TP_WORLD`` gloo tp ranks spawned on the one card (``_tp_rank``),
    held by ``_hold_split`` against phase 3g's one-device round and each
    rank's peak by ``TP_MEM_GB``; after 3l's round the same ranks run
    phase 3o against ``serve_ref`` (phase 3b's qwen3-1.7b serve), held
    by ``_hold_serve``. Returns the launches summed over the ranks (and
    3o's flash_attention calls by path under "serve_paths")."""
    import torch.multiprocessing as mp
    run = TP_RUNS[phase]
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{phase}_", dir=os.path.join(
        ROOT, "build"))
    try:
        if run.get("serve"):
            torch.save(serve_ref, os.path.join(tmp, SERVE_TP_REF))
        torch.cuda.empty_cache()
        mp.spawn(_tp_rank, args=(TP_WORLD, _free_port(), tmp, phase),
                 nprocs=TP_WORLD, join=True)
        res = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                          weights_only=False) for r in range(TP_WORLD)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    chunks = ", wkv_chunked" if run["kw"].get("wkv_chunked") else \
        f", KV chunks of {run['kw']['attn_chunk']}"
    _hold_split(res, trained[run["ref"]], phase, run["g"], run["ref_name"],
                run["reorder"], TP_MEM_GB[phase],
                f"{run['arch']} full width (f32 weights, bf16 activations), "
                f"replicas {TRAIN_REPS} on every rank, each split over "
                f"{TP_WORLD} gloo tp ranks sharing the card, batch 8 x seq "
                f"128, ({run['g']}, {run['g']}), remat{chunks}, plain mode",
                "tp")
    out = {k: sum(r["counts"][k] for r in res)
           for k in ("segment_agg", "segment_broadcast")}
    wall_3o = 0.0
    if run.get("serve"):
        print(f"phase 3o: mesh serving, full-width qwen3-1.7b over the "
              f"serve mesh (1, 1, {TP_WORLD}) of phase 3l's ranks")
        out["serve_paths"] = _hold_serve([r["serve"] for r in res],
                                         serve_ref)
        wall_3o = max(r["serve"]["wall"] for r in res)
    print(f"  phase {phase} took {time.perf_counter() - t_phase:.1f} s "
          f"(budget {TP_BUDGET_S[phase]:.0f} s"
          + (f", phase 3o's {wall_3o:.1f} s of it on the ranks, budget "
             f"{SERVE_TP_BUDGET_S:.0f} s" if run.get("serve") else "")
          + "); ranks sharing one card say nothing of multi-GPU scaling")
    return out


def _hold_split(res: list, ref: dict, phase: str, g: int, ref_name: str,
                reorder, mem_gb: float, what: str, group: str) -> None:
    """Holds every rank's ``_split_round`` result ``res``: (g2 + 1)
    launches of each kernel per leaf, every replica and every leaf no
    spec splits bitwise equal across the ranks, replica (0, 0, 0)
    gathered whole against the one-device round ``ref`` (phase 3g's):
    the loss by the larger of ``REPLICA_REL`` and ``ref``'s own response
    to another summation order (``reorder`` names it; None: no
    allowance), the per-leaf sums by the larger of ``REPLICA_REL`` and
    ``ref``'s largest per-leaf response, and each rank's peak by
    ``mem_gb``; prints the round's wall, the gloo calls and seconds over
    the ``group`` group and the peaks."""
    want = _agg_launches(res[0]["n_leaves"], g)
    for r in res:
        got = {k: r["counts"][k] for k in want}
        check(got == want, f"phase {phase}: rank {r['ft_rank']} launches "
              f"{got} != {want}")
        check(r["replicas_equal"], f"phase {phase}: a rank's replicas "
              f"differ after the cloud round")
        check(r["replicated_equal"], f"phase {phase}: a leaf no spec "
              f"splits differs from rank 0's")
    got = res[0]
    check(got["names"] == ref["names"], f"phase {phase}: the gathered "
          f"replica's leaves differ from {ref_name}'s")
    rel_loss, rel_sq, rel_sum = _replica_rel(got, ref)
    worst = _worst_leaves(got, ref)
    # the reference round's own response to a reordering bounds what no
    # split summation order can hold at REPLICA_REL: its loss the loss,
    # its largest per-leaf response the per-leaf sums
    resp = ref["reorder_rel"] if reorder else (0.0, 0.0, 0.0)
    loss_bound = max(REPLICA_REL, resp[0])
    sums_bound = max(REPLICA_REL, *resp[1:])
    wall = max(r["wall"] for r in res)
    n_sgd = g ** 2 * int(np.prod(TRAIN_REPS)) * TRAIN_KW["mb_per_epoch"]

    def per_rank(key, spec):
        return ", ".join(format(r[key], spec) for r in res)

    why = f"the response to {reorder}" if reorder else \
        "no reordering's allowance"
    print(f"  {what}: round {wall:.3f} s (ranks {per_rank('wall', '.3f')}),"
          f" {n_sgd} SGD steps per rank ({wall / n_sgd:.4f} s per step); "
          f"gloo over the {group} group {res[0]['gloo_calls']} calls a rank "
          f"({res[0]['gathers']} of them all_gather, the rest all_reduce), "
          f"{per_rank('gloo_s', '.3f')} s per rank; blocks "
          f"{res[0]['shard_gb']:.2f} GB a rank; draw and split "
          f"{res[0]['init_s']:.1f} s (one rank at a time), replica 0 "
          f"gathered in {res[0]['gather_s']:.1f} s; peak memory "
          f"{per_rank('peak', '.2f')} GB (reckoned {mem_gb:.0f} GB); "
          f"launches per rank {res[0]['counts']}; every replica bitwise "
          f"equal, every one of the {res[0]['n_whole']} leaves no spec "
          f"splits bitwise rank 0's; replica (0, 0, 0) gathered vs "
          f"{ref_name}'s one-device round: loss {got['loss']:.6f} vs "
          f"{ref['loss']:.6f} (relative {rel_loss:.3e}, bound "
          f"{loss_bound:.3e}: {why}), per leaf sum of squares "
          f"{rel_sq:.3e} ({worst[0]}), sum over L1 {rel_sum:.3e} "
          f"({worst[1]}) (bound {sums_bound:.3e}: the larger of "
          f"{REPLICA_REL} and {why}, its largest per leaf)")
    check(max(rel_sq, rel_sum) <= sums_bound and rel_loss <= loss_bound,
          f"phase {phase}: vs {ref_name} loss {rel_loss:.3e} (bound "
          f"{loss_bound:.3e}), sum of squares {rel_sq:.3e}, sum "
          f"{rel_sum:.3e} (bound {sums_bound:.3e})")
    check(max(r["peak"] for r in res) <= mem_gb,
          f"phase {phase}: peak memory over {mem_gb} GB")


# ---------------------------------------------------------------------------
# phase 3o: mesh serving over phase 3l's gloo ranks on the card
# ---------------------------------------------------------------------------

# qwen3-1.7b served at its published T = 4 (the reference's dry run
# decodes at tp = hfl_topology[3]) over the serve mesh (1, 1, 4) of phase
# 3l's 4 ranks: phase 3b's serve (batch 4, prompt 1024, 32 steps), fed
# 3b's greedy tokens, every step's logits held against 3b's one-device
# logits of the same seed-0 weights within SERVE_REL (bf16)
SERVE_TP_REF = "serve_ref.pt"
SERVE_TP = dict(batch=4, prompt=1024, new=32)
# (1, 2, 2) on the same ranks: reduced qwen3 with f32 activations, batch 4
# split over the 2 batch groups, against the one-device serve
SERVE_TP_SMALL = dict(batch=4, prompt=32, new=4)
# per rank: a quarter of qwen3-1.7b's 8.13 GB of f32 weights (every
# matrix and the vocabulary split over tp; the norms, 0.2 MB, whole),
# the rank's cache (28 x 4 x 1056 x 2 x 128 bf16 k and v, 0.12 GB), the
# prefill's f32 partial sums (4 x 1024 x 2048, 34 MB) and bf16 casts of
# a layer's blocks, and the gathered logits (4 x 151,936)
SERVE_TP_MEM_GB = 3.0
SERVE_TP_BUDGET_S = 60.0


def _hold_serve(res: list, ref: dict) -> dict:
    """Holds every rank's ``_serve_tp`` result: ``flash_attention``
    launched 28 times on the tensor-core tile path (the prefill) and 28
    x 32 on split-KV (the decode) on each rank and nothing else, every
    step's logits bitwise rank 0's, within ``SERVE_REL`` (bf16) of phase
    3b's, the reduced f32 serve at (1, 2, 2) within ``SMALL_SERVE_TOL``
    of the one-device serve, each rank's peak within
    ``SERVE_TP_MEM_GB``; prints the walls, the gloo calls and seconds
    per prefill and per decode step and the errors. Returns the flash
    calls by path summed over the ranks."""
    new, layers = SERVE_TP["new"], 28
    want = {"segment_agg": 0, "segment_broadcast": 0,
            "flash_attention": layers * (1 + new), "wkv6": 0}
    want_paths = {"split_kv": layers * new, "wgmma": layers, "f32_tile": 0}
    for i, r in enumerate(res):
        check(r["counts"] == want, f"phase 3o: rank {i} launches "
              f"{r['counts']} != {want}")
        check(r["paths"] == want_paths, f"phase 3o: rank {i} flash paths "
              f"{r['paths']} != {want_paths}")
        check(r["finite"], f"phase 3o: rank {i}'s logits are not finite "
              f"or not of 3b's shape")
        check(r["steps_equal"], f"phase 3o: rank {i}'s {r['n_calls']} "
              f"collectives do not split into {new + 1} equal steps")
        check(r["same"], f"phase 3o: rank {i}'s logits are not bitwise "
              f"rank 0's")
        check(r["errs"] == res[0]["errs"], "phase 3o: the ranks' errors "
              "differ")
    r0 = res[0]
    errs, tol = r0["errs"], SERVE_REL["bfloat16"]
    small = max(r["small_err"] for r in res)
    b, s = SERVE_TP["batch"], SERVE_TP["prompt"]

    def per_rank(key, spec):
        return ", ".join(format(r[key], spec) for r in res)

    print(f"  (a) qwen3-1.7b full width (f32 weights from seed 0, bf16 "
          f"activations) over the serve mesh (1, 1, {TP_WORLD}), each rank "
          f"4 of 16 query heads over 2 of 8 kv heads, a quarter of the FFN "
          f"and of the vocabulary (draw and take {r0['init_s']:.1f} s, one "
          f"rank at a time): prefill {s} tokens x{b} "
          f"{per_rank('prefill_s', '.4f')} s, {new} decode steps fed 3b's "
          f"greedy tokens {per_rank('decode_s', '.4f')} s "
          f"({per_rank('tok_per_s', '.1f')} tok/s; 3b on one device: "
          f"prefill {ref['prefill_s']:.4f} s, {ref['tok_per_s']:.1f} "
          f"tok/s); gloo {r0['calls_per_step']} calls a step and rank "
          f"({r0['calls']} in all): over the tp group a prefill "
          f"{per_rank('prefill_tp_s', '.4f')} s, a decode step "
          f"{per_rank('decode_tp_s', '.4f')} s; the logits' all_gather over "
          f"the world a prefill {per_rank('prefill_world_s', '.4f')} s, a "
          f"decode step {per_rank('decode_world_s', '.4f')} s; peak "
          f"memory {per_rank('peak', '.2f')} GB (reckoned "
          f"{SERVE_TP_MEM_GB:.0f} GB); launches per rank {r0['counts']}, "
          f"flash paths {r0['paths']}; every step's logits bitwise equal "
          f"on the {len(res)} ranks")
    print(f"    vs phase 3b's one-device logits (same weights, prompt and "
          f"fed tokens): relative L2 prefill {errs[0]:.3e}, decode max "
          f"{max(errs[1:]):.3e}, mean {sum(errs[1:]) / new:.3e}, largest "
          f"{max(errs):.3e} (tolerance {tol}); first step whose own greedy "
          f"token differs from 3b's: "
          f"{'none' if r0['first_flip'] is None else r0['first_flip']}")
    print(f"  (b) reduced qwen3 (f32 activations) over the serve mesh (1, 2,"
          f" 2), batch {SERVE_TP_SMALL['batch']} split over 2 batch groups, "
          f"prefill {SERVE_TP_SMALL['prompt']} + {SERVE_TP_SMALL['new']} "
          f"steps vs the one-device serve: max|err| {small:.3e} (tolerance "
          f"{SMALL_SERVE_TOL})")
    check(max(errs) <= tol, f"phase 3o: logits {max(errs):.3e} from 3b's")
    check(small <= SMALL_SERVE_TOL, f"phase 3o (b): {small:.3e} from the "
          f"one-device serve")
    check(max(r["peak"] for r in res) <= SERVE_TP_MEM_GB,
          f"phase 3o: peak memory over {SERVE_TP_MEM_GB} GB")
    return {k: sum(r["paths"][k] for r in res) for k in want_paths}


def _serve_tp_small(torch, dist, configs, model_mod, serve, mesh_lib,
                    token_batch) -> float:
    """Phase 3o (b): reduced qwen3 (f32 activations, seed-3 weights drawn
    on the card) served over the serve mesh (1, 2, 2) of the 4 ranks and
    on one device in this process, the mesh fed the one-device serve's
    greedy tokens; returns the largest abs difference of any step's
    logits (held by ``SMALL_SERVE_TOL``)."""
    cfg = dataclasses.replace(configs.get_config("qwen3-1.7b").reduce(),
                              activ_dtype="float32")
    mesh = mesh_lib.make_serve_mesh(2, ranks=(1, 2))
    dev = mesh.device
    b, s, new = (SERVE_TP_SMALL[k] for k in ("batch", "prompt", "new"))
    params = model_mod.build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(3), dev)
    toks = token_batch(2, b, s, cfg.vocab, device=dev)["tokens"]
    one = serve.greedy_serve(cfg, params, toks, new)
    _, param_sh, _, _ = serve.make_prefill_step(cfg, mesh, batch=b, seq=s,
                                                max_new=new)
    split = serve.greedy_serve(cfg, serve.take(params, param_sh), toks, new,
                               mesh=mesh, forced=one["tokens"])
    return max(float((a - c).abs().max())
               for a, c in zip(split["logits"], one["logits"]))


def _serve_tp(torch, dist, configs, model_mod, token_batch,
              outdir: str) -> dict:
    """Phase 3o on one of phase 3l's ranks: (a) full-width qwen3-1.7b
    (f32 weights from seed 0, bf16 activations) over the serve mesh (1,
    1, 4): each rank draws the seed-0 model on the card in turn and keeps
    its serve blocks (``serve.take`` of the prefill step's
    ``param_sh``); a warm-up serve, then ``greedy_serve(mesh=)`` of 3b's
    prompt fed 3b's greedy tokens (``forced``), the launch counts and
    flash paths set to 0 just before and read just after, the gloo
    collectives timed in call order, the peak memory; each step's
    relative L2 error against 3b's logits, the first step whose own
    argmax differs from 3b's token, and whether every step's logits are
    bitwise rank 0's (broadcast as bytes); (b) ``_serve_tp_small``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = configs.get_config("qwen3-1.7b")
    b, s, new = (SERVE_TP[k] for k in ("batch", "prompt", "new"))
    mesh = mesh_lib.make_serve_mesh(world)
    dev = mesh.device
    _, param_sh, _, _ = serve.make_prefill_step(cfg, mesh, batch=b, seq=s,
                                                max_new=new)
    t0 = time.perf_counter()
    for r in range(world):                   # one whole model at a time
        if r == rank:
            p1 = model_mod.build_model(cfg).init(
                torch.Generator(device=dev).manual_seed(0), dev)
            blocks = serve.take(p1, param_sh)
            del p1
            torch.cuda.empty_cache()
        dist.barrier()
    t_init = time.perf_counter() - t0
    ref = torch.load(os.path.join(outdir, SERVE_TP_REF), weights_only=False)
    toks = token_batch(0, b, s, cfg.vocab, device=dev)["tokens"]
    serve.greedy_serve(cfg, blocks, toks[:, :64], 2, mesh=mesh)  # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    with _AllReduceTimer(torch, dist, ("all_reduce", "all_gather")) as timer:
        ops.reset_launches()
        fa.reset_paths()
        res = serve.greedy_serve(cfg, blocks, toks, new, mesh=mesh,
                                 forced=ref["tokens"].to(dev))
        counts, paths = dict(ops.LAUNCHES), dict(fa.PATH_CALLS)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    # held by _hold_serve in the main process: a rank that raised here
    # would leave the others waiting in a collective
    errs, first_flip, same, finite = [], None, True, True
    for i, lg in enumerate(res["logits"]):
        want = ref["logits"][i].to(dev)
        finite = finite and lg.shape == want.shape and bool(
            torch.isfinite(lg.float()).all())
        errs.append(rel_err(torch, lg, want))
        if i < new and first_flip is None and not torch.equal(
                lg.argmax(-1).cpu(), ref["tokens"][:, i].long()):
            first_flip = i
        r0 = lg.contiguous().view(torch.uint8).clone()
        dist.broadcast(r0, src=0)
        same = same and torch.equal(r0, lg.contiguous().view(torch.uint8))
    # every step makes the same collectives: the first of new + 1 equal
    # runs of the call order are the prefill's
    k, rem = divmod(len(timer.order), new + 1)
    keys = [key for key, _ in timer.order]
    steps_equal = rem == 0 and all(keys[i * k:(i + 1) * k] == keys[:k]
                                   for i in range(new + 1))
    # seconds per prefill and per decode step over the tp group (the row
    # products' and the lookup's all_reduce) and the world (the logits'
    # all_gather)
    gloo = {}
    for part, calls in (("prefill", timer.order[:k]),
                        ("decode", timer.order[k:])):
        per = 1 if part == "prefill" else new
        for where, tp_group in (("tp", True), ("world", False)):
            gloo[f"{part}_{where}_s"] = sum(
                m for (_, g), m in calls if (g is not None) == tp_group
            ) / 1e3 / per
    times = {k_: res[k_] for k_ in ("prefill_s", "decode_s", "tok_per_s")}
    del blocks, res
    torch.cuda.empty_cache()
    small = _serve_tp_small(torch, dist, configs, model_mod, serve,
                            mesh_lib, token_batch)
    return {"counts": counts, "paths": paths, "peak": peak,
            "init_s": t_init, "errs": errs, "first_flip": first_flip,
            "same": same, "finite": finite, "steps_equal": steps_equal,
            "n_calls": len(timer.order), "calls_per_step": k,
            "calls": {f"{n}/{'tp' if g is not None else 'world'}": c
                      for (n, g), c in timer.calls.items()},
            "small_err": small, "wall": time.perf_counter() - t_phase,
            **gloo, **times}


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------

# shapes the main path gives the kernels: Eq. 1 (and the resync) at
# (N, E) = (50, 5), Eq. 2 at (5, 1); the JSON line reports CIFAR Eq. 1
# (both kernels) and MNIST Eq. 1 (segment_agg)
TIMED = [("cifar-eq1", 50, 456906, 5), ("cifar-eq2", 5, 456906, 1),
         ("mnist-eq1", 50, 21840, 5), ("mnist-eq2", 5, 21840, 1)]
# the async flushes of phase 3d (one segment over K buffered updates),
# with torch.mv as the library yardstick
TIMED_FLUSH = [("cifar-flush", 3, 456906), ("mnist-flush", 2, 21840)]


def time_shape(torch, hier_agg, ops, ref, dev, n: int, p: int,
               e: int, mv: bool = False) -> dict:
    """Times of each kernel at one shape: kernel, plain version and one
    PyTorch library call computing the same function, plus the bound.
    The resync runs only where devices sync from edges (E > 1). With
    ``mv`` (a flush, E = 1) the library call is ``torch.mv(stack.T, w)``,
    which leaves out the normalisation."""
    gen = torch.Generator(device=dev).manual_seed(1)
    bank = torch.randn((n, p), generator=gen, device=dev)
    w = torch.full((n,), 1000.0, device=dev)
    seg = (torch.arange(n, device=dev) % e).to(torch.int32)
    inv = 1.0 / ref.segment_weight_sums(w, seg, e).clamp_min(1e-9)
    # the library yardstick multiplies the bank by the normalised one-hot
    # matrix, made here once: unlike the kernel, its time excludes the
    # weight sums and their reciprocals
    onehot = (seg[None, :].long() == torch.arange(e, device=dev)[:, None])
    a_mat = onehot.float() * w[None, :] * inv[:, None]      # (E, N)
    models = torch.randn((e, p), generator=gen, device=dev)
    out = torch.empty((n, p), device=dev)
    seg64 = seg.long()

    def agg_kernel():
        return hier_agg._launch_segment_agg(bank, w, seg, e,
                                            normalize=True)[0]

    check(torch.allclose(torch.mm(a_mat, bank), agg_kernel(), atol=AGG_TOL,
                         rtol=AGG_TOL), "library yardstick disagrees")
    lib = ((lambda: torch.mv(bank.t(), w)) if mv
           else (lambda: torch.mm(a_mat, bank)))
    if mv:
        check(torch.allclose(lib() * inv[0], agg_kernel()[0], atol=AGG_TOL,
                             rtol=AGG_TOL), "torch.mv yardstick disagrees")
    cases = [("segment_agg", agg_kernel,
              lambda: ops.segment_agg(bank, w, seg, e),
              lambda: ref.segment_agg_ref(bank, w, seg, e), lib,
              4 * (n * p + e * p + 2 * n), 2 * n * p)]
    if e > 1:
        bcast = lambda: ops.segment_broadcast(models, seg, out=out)
        cases.append(("segment_broadcast", bcast, bcast,
                      lambda: ref.segment_broadcast_ref(models, seg),
                      lambda: torch.index_select(models, 0, seg64),
                      4 * (e * p + n * p + n), 0))
    res = {}
    before = dict(hier_agg.LAUNCHES)
    for name, kern, call, plain, lib, nbytes, flops in cases:
        t_call = event_ms(torch, call)
        t_plain1 = graph_ms(torch, plain)
        t_k1 = graph_ms(torch, kern)
        t_k2 = graph_ms(torch, kern)
        t_plain2 = graph_ms(torch, plain)
        t_lib = graph_ms(torch, lib)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        ms = min(t_k1, t_k2)
        res[name] = {"ms": ms, "plain_ms": min(t_plain1, t_plain2),
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "library_ms": t_lib,
                     "call_ms": t_call}
        print(f"  {name:17s} N={n:2d} E={e} P={p:6d}: kernel {t_k1:.4f}/"
              f"{t_k2:.4f} ms, plain {t_plain1:.4f}/{t_plain2:.4f} ms, "
              f"library {t_lib:.4f} ms, eager wrapper call {t_call:.4f} "
              f"ms, {nbytes / 1e6:.2f} MB, bound "
              f"{res[name]['bound_ms'] * 1e3:.2f} us "
              f"({res[name]['bound_ms'] / ms * 100:.1f}% of bound)")
    hier_agg.LAUNCHES.update(before)         # timing launches do not count
    return res


def timings(torch, hier_agg, ops, ref, dev, runs: dict, err: dict):
    """Time every main-path shape; returns the JSON rows: CIFAR Eq. 1 for
    both kernels, MNIST Eq. 1 for segment_agg, each with the launches of
    its task's main-path run, and the CIFAR flush (K = 3) for
    segment_agg with the launches of phase 3d's CIFAR run."""
    per_shape = {name: time_shape(torch, hier_agg, ops, ref, dev, n, p, e)
                 for name, n, p, e in TIMED}
    per_shape.update({name: time_shape(torch, hier_agg, ops, ref, dev, k,
                                       p, 1, mv=True)
                      for name, k, p in TIMED_FLUSH})
    rows = []
    for k, shape, run in (("segment_agg", "cifar-eq1", "cifar"),
                          ("segment_agg", "mnist-eq1", "mnist"),
                          ("segment_broadcast", "cifar-eq1", "cifar"),
                          ("segment_agg", "cifar-flush", "cifar-async")):
        t = dict(per_shape[shape][k])
        t.pop("call_ms")
        max_err = err[k][shape] if k == "segment_agg" else err[k]
        rows.append(dict(name=k, route="cuda", source=KERNEL_SRC[k],
                         replaces=REPLACES[k],
                         launches=runs[run]["counts"][k],
                         max_abs_err=max_err, shape=shape, **t))
    return rows


def time_llm_agg(torch, hier_agg, ops, ref, dev) -> dict:
    """Phase 4 at the LLM edge-mean shapes (phase 3g's and 3l's, and
    whisper's of 3g (f) and 3n):
    each kernel, its plain version and the library call (``torch.mean``
    over the replica axis; a ``copy_`` of the expanded means), and at
    phase 3k's partial (``torch.sum`` over each edge's rows), CUDA events
    around 10 back-to-back calls (each moves GBs, so dispatch is noise),
    kernel and plain twice in turns; the bound is the bytes over 3.35
    TB/s. Returns the times keyed (kernel, shape)."""
    res = {}
    before = dict(hier_agg.LAUNCHES)
    ms = lambda fn: event_ms(torch, fn, iters=10, warmup=2)

    def timed(k, shape, kern, plain, lib, nbytes):
        name, n, p, e = shape
        t_k1, t_p1, t_k2, t_p2 = ms(kern), ms(plain), ms(kern), ms(plain)
        t_lib = ms(lib)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        res[(k, name)] = {"ms": min(t_k1, t_k2),
                          "plain_ms": min(t_p1, t_p2), "bound_ms": bound,
                          "bound_by": "bytes", "library_ms": t_lib}
        print(f"  {k:17s} {name} N={n} E={e} P={p:,}: kernel {t_k1:.4f}/"
              f"{t_k2:.4f} ms, plain {t_p1:.4f}/{t_p2:.4f} ms, library "
              f"{t_lib:.4f} ms, {nbytes / 1e9:.3f} GB, bound {bound:.4f} ms "
              f"({bound / res[(k, name)]['ms'] * 100:.1f}% of bound)")

    for shape, seed in ((LLM_AGG, 6), (LLM_TP, 8), (WHISPER_AGG, 10),
                        (WHISPER_FT, 12)):
        _, n, p, e = shape
        gen = torch.Generator(device=dev).manual_seed(seed)
        bank = torch.randn((n, p), generator=gen, device=dev)
        w = torch.ones((n,), device=dev)
        seg = torch.tensor([0, 0, 1, 1], dtype=torch.int32, device=dev)
        models = torch.randn((e, p), generator=gen, device=dev)
        out = torch.empty((n, p), device=dev)
        agg = lambda: hier_agg._launch_segment_agg(bank, w, seg, e,
                                                   normalize=True)[0]
        mean = lambda: bank.view(e, n // e, p).mean(dim=1)
        check(torch.allclose(mean(), agg(), atol=AGG_TOL, rtol=AGG_TOL),
              f"{shape[0]}: torch.mean disagrees")
        timed("segment_agg", shape, agg,
              lambda: ref.segment_agg_ref(bank, w, seg, e), mean,
              4 * (n * p + e * p + 2 * n))
        timed("segment_broadcast", shape,
              lambda: ops.segment_broadcast(models, seg, out=out),
              lambda: ref.segment_broadcast_ref(models, seg),
              lambda: out.view(e, n // e, p).copy_(
                  models[:, None].expand(e, n // e, p)),
              4 * (e * p + n * p + n))
        if shape is LLM_AGG:
            # phase 3k's per-rank partial: the first 2 rows, one per edge
            _, n2, _, e2 = LLM_PARTIAL
            part, pseg = bank[:n2], torch.arange(e2, dtype=torch.int32,
                                                 device=dev)
            ones2 = torch.ones((e2,), device=dev)
            timed("segment_sum_partial", LLM_PARTIAL,
                  lambda: hier_agg._launch_segment_agg(
                      part, w[:n2], pseg, e2, normalize=False,
                      with_wsum=True),
                  lambda: (ref.segment_weight_sums(w[:n2], pseg, e2),
                           ref.segment_scaled_sum_ref(part, w[:n2], pseg,
                                                      ones2, e2)),
                  lambda: part.view(e2, n2 // e2, p).sum(dim=1),
                  4 * (n2 * p + e2 * p + 2 * n2 + e2))
            del part
        del bank, models, out
        torch.cuda.empty_cache()
    hier_agg.LAUNCHES.update(before)         # timing launches do not count
    return res


# ---------------------------------------------------------------------------
# phase 2b: the LLM kernels against their plain versions
# ---------------------------------------------------------------------------

# (name, B, H, Hkv, Sq, Skv, D, causal, window, q_offset)
FLASH_CASES = [("qwen3-prefill", 4, 16, 8, 1024, 1024, 128, True, 0, 0),
               ("qwen3-decode", 4, 16, 8, 1, 1056, 128, True, 0, 1055),
               ("ragged", 2, 16, 8, 1000, 1000, 128, True, 0, 0),
               ("window-64", 1, 4, 2, 256, 256, 64, True, 64, 0),
               ("window-128", 1, 4, 2, 256, 256, 64, True, 128, 0),
               ("mha", 2, 8, 8, 512, 512, 128, True, 0, 0),
               ("non-causal", 2, 4, 4, 200, 200, 64, False, 0, 0),
               ("decode-rep1", 2, 8, 8, 1, 300, 128, True, 0, 299),
               ("decode-rep4", 2, 16, 4, 1, 1056, 128, True, 0, 1055),
               ("decode-rep8", 1, 32, 4, 1, 500, 64, True, 0, 499),
               ("skv-1", 2, 4, 2, 1, 1, 64, True, 0, 0),
               ("skv-65", 1, 8, 4, 1, 65, 128, True, 0, 64),
               ("skv-4097", 1, 16, 8, 1, 4097, 128, True, 0, 4096),
               ("mid-split", 4, 16, 8, 1, 1056, 128, True, 0, 700),
               ("split-emptied", 1, 8, 4, 2, 65, 128, True, 0, 63),
               ("decode-window", 1, 8, 2, 1, 300, 64, True, 64, 299),
               ("prefill-d64", 2, 8, 4, 512, 512, 64, True, 0, 0),
               ("rows-16-edge", 2, 16, 8, 8, 300, 128, True, 0, 292),
               ("continuation-40", 2, 16, 8, 40, 1064, 128, True, 0, 1024),
               # phase 3h: olmoe-1b-7b (MHA) prefill and decode, qwen3's
               # windowed prefill past the window and its ring decode
               # (non-causal over the full ring, attention.decode_attention)
               ("olmoe-prefill", 4, 16, 16, 1024, 1024, 128, True, 0, 0),
               ("olmoe-decode", 4, 16, 16, 1, 1056, 128, True, 0, 1055),
               ("window-prefill", 1, 16, 8, 8704, 8704, 128, True, 8192, 0),
               ("ring-decode", 1, 16, 8, 1, 8192, 128, False, 0, 0),
               # phase 3i: zamba2-7b (MHA, head dim 112) prefill and decode,
               # and a ragged tile case at head dim 112
               ("zamba2-prefill", 4, 32, 32, 1024, 1024, 112, True, 0, 0),
               ("zamba2-decode", 4, 32, 32, 1, 1056, 112, True, 0, 1055),
               ("ragged-d112", 2, 8, 8, 1000, 1000, 112, True, 0, 0),
               # phase 3j: whisper-base's encoder (non-causal, 1500 frames,
               # ragged against the 64-row kv tile), cross-attention
               # prefill (224 decoder rows over 1500) and decode, and the
               # decoder's last self-attention decode step; qwen2-vl-7b
               # (GQA rep 7) prefill over 256 vision + 1024 text positions
               # and its last decode step (rep 7 packed into 8 rows), a
               # ragged rep-7 prefill, a non-causal Sq != Skv tile case and
               # a 14-row rep-7 split-KV decode
               ("whisper-encoder", 4, 8, 8, 1500, 1500, 64, False, 0, 0),
               ("whisper-cross-prefill", 4, 8, 8, 224, 1500, 64, False, 0,
                0),
               ("whisper-cross-decode", 4, 8, 8, 1, 1500, 64, False, 0, 0),
               ("whisper-self-decode", 4, 8, 8, 1, 256, 64, True, 0, 255),
               ("qwen2vl-prefill", 4, 28, 4, 1280, 1280, 128, True, 0, 0),
               ("qwen2vl-decode", 4, 28, 4, 1, 1312, 128, True, 0, 1311),
               ("ragged-rep7", 2, 28, 4, 300, 300, 128, True, 0, 0),
               ("non-causal-40x300", 2, 8, 8, 40, 300, 64, False, 0, 0),
               ("split-rep7-sq2", 2, 28, 4, 2, 300, 128, True, 0, 298),
               # phase 3o: a tp rank of qwen3-1.7b at T = 4, its 4 query
               # heads over 2 kv heads, prefill and decode
               ("qwen3-tp4-prefill", 4, 4, 2, 1024, 1024, 128, True, 0, 0),
               ("qwen3-tp4-decode", 4, 4, 2, 1, 1056, 128, True, 0, 1055)]
# (name, B, S, nh, chunk, decay range)
WKV_CASES = [("rwkv6-prefill", 4, 1024, 32, 64, (0.3, 0.999)),
             ("ragged", 2, 1000, 8, 64, (0.3, 0.999)),
             ("hard-decay", 1, 256, 4, 32, (1e-4, 0.1))]
# the serving shapes timed in phase 4b, each with the serve (and its
# flash path) whose launches its JSON row reports: all of the path's
# calls in that serve, or where the serve calls the path from several
# sites (phase 3j), the calls of the row's site (``_flash_sites``)
MAIN_FLASH = {"qwen3-prefill": ("qwen3-1.7b", "wgmma", None),
              "qwen3-decode": ("qwen3-1.7b", "split_kv", None),
              "olmoe-prefill": ("olmoe-1b-7b", "wgmma", None),
              "olmoe-decode": ("olmoe-1b-7b", "split_kv", None),
              "window-prefill": ("qwen3-1.7b-window", "wgmma", None),
              "ring-decode": ("qwen3-1.7b-window", "split_kv", None),
              "zamba2-prefill": ("zamba2-7b", "wgmma", None),
              "zamba2-decode": ("zamba2-7b", "split_kv", None),
              "whisper-encoder": ("whisper-base", "wgmma", "encoder"),
              "whisper-cross-prefill": ("whisper-base", "wgmma",
                                        "cross-prefill"),
              "whisper-cross-decode": ("whisper-base", "split_kv",
                                       "cross-decode"),
              "whisper-self-decode": ("whisper-base", "split_kv", "decode"),
              "qwen2vl-prefill": ("qwen2-vl-7b", "wgmma", "prefill"),
              "qwen2vl-decode": ("qwen2-vl-7b", "split_kv", "decode"),
              # phase 3o's calls summed over its 4 ranks
              "qwen3-tp4-prefill": ("qwen3-1.7b-tp4", "wgmma", None),
              "qwen3-tp4-decode": ("qwen3-1.7b-tp4", "split_kv", None)}


def flash_inputs(torch, dev, b, h, hkv, sq, skv, d, dtype, seed=0):
    """q, k, v as the model passes them: (B, S, H, D) projections seen as
    (B, H, S, D) transposed views."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda s_, n: torch.randn((b, s_, n, d), generator=gen,
                                   device=dev).to(dtype).transpose(1, 2)
    return mk(sq, h), mk(skv, hkv), mk(skv, hkv)


def wkv_inputs(torch, dev, b, s, nh, lohi, rkv_dtype, seed=0):
    """r, k, v in the model's activation dtype, the decay w in f32 (as
    ``time_mix_forward`` passes them), and u."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rkv = [torch.randn((b, s, nh, 64), generator=gen, device=dev).to(
        rkv_dtype) for _ in range(3)]
    lo, hi = lohi
    w = torch.rand((b, s, nh, 64), generator=gen, device=dev) * (hi - lo) + lo
    u = torch.randn((nh, 64), generator=gen, device=dev)
    return (*rkv, w, u)


def llm_kernel_checks(torch, ops, ref, fa, dev) -> dict:
    """Each LLM kernel against its plain version on the same tensors;
    returns the max abs error at the serving path's own shapes (bf16),
    per flash shape."""
    err = {"flash_attention": {}, "wkv6": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        tol = FLASH_TOL[str(dtype).split(".")[-1]]
        for name, b, h, hkv, sq, skv, d, causal, win, off in FLASH_CASES:
            q, k, v = flash_inputs(torch, dev, b, h, hkv, sq, skv, d, dtype)
            kw = dict(causal=causal, window=win, q_offset=off)
            path = fa.plan(b, h, hkv, sq, skv, dtype, **kw)["path"]
            want_path = ("split_kv" if h // hkv * sq <= fa.MAX_PACKED_ROWS
                         else "wgmma" if dtype == torch.bfloat16
                         else "f32_tile")
            check(path == want_path, f"flash_attention {name} {dtype}: "
                  f"routed to {path}, expected {want_path}")
            got = ops.flash_attention(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            e = float((got.float() - want.float()).abs().max())
            check(got.dtype == dtype and got.shape == (b, h, sq, d),
                  f"flash_attention {name}: {got.dtype} {tuple(got.shape)}")
            check(torch.allclose(got.float(), want.float(), atol=tol,
                                 rtol=tol),
                  f"flash_attention {name} {dtype}: max abs err {e}")
            check(torch.equal(got, ops.flash_attention(q, k, v, **kw)),
                  f"flash_attention {name} {dtype}: two runs differ")
            if dtype == torch.bfloat16 and name in MAIN_FLASH:
                err["flash_attention"][name] = e
            print(f"  flash_attention {name:15s} {str(dtype):14s} "
                  f"q {(b, h, sq, d)} kv {(b, hkv, skv, d)} causal "
                  f"{causal} window {win} q_offset {off} [{path}]: "
                  f"max|err| {e:.3e}")
    for dtype in (torch.bfloat16, torch.float32):
        for name, b, s, nh, chunk, lohi in WKV_CASES:
            r, k, v, w, u = wkv_inputs(torch, dev, b, s, nh, lohi, dtype)
            y, st = ops.wkv6(r, k, v, w, u, chunk=chunk)
            yw, stw = ref.wkv6_ref(r, k, v, w, u, chunk=chunk)
            tol = WKV_HARD_TOL if name == "hard-decay" else WKV_TOL
            e = float((y - yw).abs().max())
            es = float((st - stw).abs().max())
            check(bool(torch.isfinite(y).all() and torch.isfinite(st).all()),
                  f"wkv6 {name}: not finite")
            check(torch.allclose(y, yw, atol=tol, rtol=tol)
                  and torch.allclose(st, stw, atol=tol, rtol=tol),
                  f"wkv6 {name} {dtype}: max abs err y {e}, state {es}")
            y2, st2 = ops.wkv6(r, k, v, w, u, chunk=chunk)
            check(torch.equal(y, y2) and torch.equal(st, st2),
                  f"wkv6 {name} {dtype}: two runs differ")
            if dtype == torch.bfloat16 and name == "rwkv6-prefill":
                err["wkv6"] = max(e, es)
            print(f"  wkv6 {name:13s} r/k/v {str(dtype):14s} (B, S, nh, hd)"
                  f" {(b, s, nh, 64)} chunk {chunk}: max|err| y {e:.3e}, "
                  f"state {es:.3e}")
    return err


# ---------------------------------------------------------------------------
# phase 3b: the LLM serving path
# ---------------------------------------------------------------------------

def rel_err(torch, got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def small_serve_check(torch, configs, model_mod, dev) -> None:
    """Reduced qwen3, rwkv6, olmoe, zamba2, whisper and qwen2-vl (the
    last two with their stub inputs) with f32 activations, the same
    weights and tokens, prefill(16, max_new 4) + 4 teacher-forced decode
    steps on the card (kernels) and on the CPU (plain versions)."""
    import dataclasses
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch.serve import stub_extras
    for arch in ("qwen3-1.7b", "rwkv6-1.6b", "olmoe-1b-7b", "zamba2-7b",
                 "whisper-base", "qwen2-vl-7b"):
        cfg = dataclasses.replace(configs.get_config(arch).reduce(),
                                  activ_dtype="float32")
        model = model_mod.build_model(cfg)
        params = model.init(torch.Generator().manual_seed(3), "cpu")
        toks = token_batch(2, 2, 20, cfg.vocab, "cpu")["tokens"]
        extras = stub_extras(cfg, 2, 3, "cpu")
        outs = []
        for d in ("cpu", dev):
            p = _tree_to(params, d)
            t = toks.to(d)
            lg, cache = model.prefill(
                p, t[:, :16], extras={k: v.to(d) for k, v in extras.items()},
                max_new=4)
            steps = [lg]
            for i in range(16, 20):
                lg, cache = model.decode_step(p, cache, t[:, i:i + 1])
                steps.append(lg)
            outs.append((steps, cache))
        errs = []
        for a, b in zip(outs[0][0], outs[1][0]):
            errs.append(float((a - b.cpu()).abs().max()))
            check(torch.allclose(b.cpu(), a, atol=SMALL_SERVE_TOL,
                                 rtol=SMALL_SERVE_TOL),
                  f"small serve {arch}: logits differ between CPU and GPU")
        check(all(outs[1][1].get(k) == outs[0][1].get(k)
                  for k in ("t", "dpos")), f"small serve {arch}: t/dpos")
        for k, a in outs[0][1].items():
            if k not in ("t", "dpos"):
                b = outs[1][1][k].cpu()
                errs.append(float((a.float() - b.float()).abs().max()))
                check(torch.allclose(b.float(), a.float(),
                                     atol=SMALL_SERVE_TOL,
                                     rtol=SMALL_SERVE_TOL),
                      f"small serve {arch}: cache {k} differs")
        print(f"  reduced {arch} (f32 activations), prefill 16 + 4 decode "
              f"steps: GPU vs CPU max|err| {max(errs):.3e} (tolerance "
              f"{SMALL_SERVE_TOL})")


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def serve_path(torch, ops, fa, configs, model_mod, serve, arch, dev,
               timed_only=False) -> dict:
    """The full-width model through ``greedy_serve``: a (4, 1024) prompt,
    32 greedy decode steps, launch counts held to what the loop implies;
    then ``Model.logits`` over prompt + fed tokens, held against every
    step's logits; then the same weights served with f32 activations and
    held the same way."""
    import dataclasses
    from repro_torch.data.synthetic import token_batch
    batch, prompt, new = 4, 1024, 32
    cfg = configs.get_config(arch)
    model = model_mod.build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    t_init = sync_time(torch) - t0
    n_par = sum(int(t.numel()) for t in _leaves(params))
    toks = token_batch(0, batch, prompt, cfg.vocab, dev)["tokens"]
    print(f"  {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}, {n_par / 1e9:.3f} B f32 params "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated), "
          f"init {t_init:.2f} s")
    serve.greedy_serve(cfg, params, toks[:1, :64], 2)        # warm-up
    ops.reset_launches()
    paths = getattr(fa, "PATH_CALLS", None)    # absent in older trees
    if paths is not None:
        fa.reset_paths()
    res = serve.greedy_serve(cfg, params, toks, new)
    counts = dict(ops.LAUNCHES)
    want = {"segment_agg": 0, "segment_broadcast": 0,
            "flash_attention": 0, "wkv6": 0}
    want_paths = {"split_kv": 0, "wgmma": 0, "f32_tile": 0}
    if cfg.family == "dense":
        want["flash_attention"] = cfg.n_layers * (1 + new)
        want_paths.update(wgmma=cfg.n_layers, split_kv=cfg.n_layers * new)
    else:
        want["wkv6"] = cfg.n_layers
    print(f"    prefill {prompt} tokens x{batch}: {res['prefill_s']:.4f} s; "
          f"{new} decode steps x{batch}: {res['decode_s']:.4f} s "
          f"({res['tok_per_s']:.1f} tok/s)")
    print(f"    greedy tokens (first sequence): {res['tokens'][0].tolist()}")
    print(f"    launches {counts} (expected {want})")
    check(counts == want, f"{arch}: launch counts {counts} != {want}")
    out = {"counts": counts, "prefill_s": res["prefill_s"],
           "decode_s": res["decode_s"], "tok_per_s": res["tok_per_s"]}
    if paths is not None:
        out["paths"] = dict(paths)
        print(f"    flash_attention calls by path {out['paths']} (expected "
              f"{want_paths})")
        check(out["paths"] == want_paths,
              f"{arch}: flash_attention paths {out['paths']}")
    if not timed_only:
        out["rel_err"] = logits_check(torch, ops, model, cfg, params, toks,
                                      res)
        if cfg.family == "dense":      # phase 3o's reference
            out["ref"] = {"logits": [lg.cpu() for lg in res["logits"]],
                          "tokens": res["tokens"].cpu(),
                          "prefill_s": res["prefill_s"],
                          "tok_per_s": res["tok_per_s"]}
    del res
    out.update(profile_decode(torch, serve, cfg, params, toks))
    if timed_only:
        del params
        torch.cuda.empty_cache()
        return out
    cfg32 = dataclasses.replace(cfg, activ_dtype="float32")
    res32 = serve.greedy_serve(cfg32, params, toks, new)
    print(f"    f32 activations: prefill {res32['prefill_s']:.4f} s, "
          f"{res32['tok_per_s']:.1f} tok/s")
    logits_check(torch, ops, model_mod.build_model(cfg32), cfg32, params,
                 toks, res32)
    del params, res32
    torch.cuda.empty_cache()
    return out


def attn_apps(cfg) -> int:
    """Attention (or WKV) calls of one forward: one per layer, or in a
    hybrid model one per application of its shared attention block (one
    per group of ``attn_every`` layers), or in whisper one per encoder
    layer and two per decoder layer (self and cross)."""
    if cfg.family == "hybrid":
        return -(-cfg.n_layers // cfg.attn_every)
    if cfg.family == "audio":
        return cfg.enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def step_apps(cfg) -> int:
    """Attention calls of one decode step: ``attn_apps`` without
    whisper's encoder."""
    return attn_apps(cfg) - cfg.enc_layers


def logits_check(torch, ops, model, cfg, params, toks, res,
                 window: int = 0, extras=None) -> float:
    """``Model.logits`` over prompt + fed tokens (one launch of the
    path's kernel per layer or attention application; ``window`` its
    sliding window; ``extras`` the stub front ends' inputs, a vlm's
    vision positions coming first in the logits) against every step's
    logits, within ``SERVE_REL`` of the activation dtype; returns the
    largest per-step relative L2 error."""
    extras = extras or {}
    prompt = toks.shape[1]
    vis = extras["vision_embed"].shape[1] if "vision_embed" in extras else 0
    seq = torch.cat([toks, res["tokens"]], dim=1)
    ops.reset_launches()
    with torch.no_grad():
        full = model.logits(params, {"tokens": seq, **extras},
                            window=window)[:, vis:]
    counts = dict(ops.LAUNCHES)
    kern = "wkv6" if cfg.family == "ssm" else "flash_attention"
    check(counts[kern] == attn_apps(cfg),
          f"{cfg.name}: Model.logits launched {counts}")
    errs, maxabs = [], 0.0
    for i, lg in enumerate(res["logits"]):
        ref_lg = full[:, prompt - 1 + i]
        check(lg.shape == ref_lg.shape
              and bool(torch.isfinite(lg.float()).all()),
              f"{cfg.name}: step {i} logits {tuple(lg.shape)} not finite")
        errs.append(rel_err(torch, lg, ref_lg))
        maxabs = max(maxabs, float((lg.float() - ref_lg.float()).abs().max()))
    # greedy tokens the full forward would pick at the same positions
    agree = float((full[:, prompt - 1:-1].argmax(-1) == res["tokens"]
                   ).float().mean())
    tol = SERVE_REL[cfg.activ_dtype]
    top = float(full.abs().max())
    del full
    print(f"    Model.logits ({cfg.activ_dtype}) over {seq.shape[1]} tokens"
          f"{f' after {vis} vision tokens' if vis else ''} "
          f"({counts[kern]} {kern} launches"
          f"{f', window {window}' if window else ''}): per-step relative L2 "
          f"error prefill {errs[0]:.3e}, decode max {max(errs[1:]):.3e}, mean "
          f"{sum(errs[1:]) / len(errs[1:]):.3e} (tolerance {tol}); max abs "
          f"err {maxabs:.3e}, logits max abs {top:.3f}; greedy tokens the "
          f"full forward also picks: {agree:.4f}")
    check(max(errs) <= tol, f"{cfg.name}: decode logits differ from "
          f"Model.logits by {max(errs)} ({cfg.activ_dtype})")
    return max(errs)


def profile_decode(torch, serve, cfg, params, toks, extras=None) -> dict:
    """Decode steps after a 1024-token prefill: the wall of an unprofiled
    step (mean of 4), the same with Python's garbage collector off, one
    step under torch.profiler for the device time by kernel and the
    number of kernels launched, and the unprofiled wall again after it.
    The device's busy share is that device time over the first
    unprofiled wall: the profiler's own cost per launch inflates the wall
    of the step it traces. The collector, the threads alive and the
    profiler's after-effects are the host's state that earlier phases
    leave behind. Returns those numbers (and the flash kernels' share of
    the device time)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        _, cache = serve.make_prefill_step(cfg, max_new=14)(
            params, {"tokens": toks, **(extras or {})})
        nxt = toks[:, -1:]
        step = serve.make_decode_step(cfg)
        step(params, cache, nxt)                              # warm-up

        def wall_of_4():
            t0 = sync_time(torch)
            for _ in range(4):
                step(params, cache, nxt)
            return (sync_time(torch) - t0) / 4
        wall = wall_of_4()
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            wall_nogc = wall_of_4()
        finally:
            if gc_was_on:
                gc.enable()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(params, cache, nxt)
            wall_prof = sync_time(torch) - t0
        wall_after = wall_of_4()
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")]
    if not rows:
        rows = [e for e in prof.key_averages()
                if getattr(e, "self_device_time_total", 0) > 0]
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
    n_kern = sum(e.count for e in rows)
    flash_ms = sum(e.self_device_time_total for e in rows
                   if "flash" in e.key) / 1e3
    print(f"    one decode step: unprofiled wall {wall * 1e3:.2f} ms (mean "
          f"of 4), device busy {dev_ms:.2f} ms under torch.profiler "
          f"({dev_ms / (wall * 1e3) * 100:.1f}% of the unprofiled wall; "
          f"the profiled step's wall {wall_prof * 1e3:.2f} ms), {n_kern} "
          f"kernel launches; unprofiled wall with the garbage collector "
          f"off {wall_nogc * 1e3:.2f} ms, after the profiled step "
          f"{wall_after * 1e3:.2f} ms (means of 4); "
          f"{threading.active_count()} threads alive, "
          f"{len(gc.get_objects())} objects tracked by the collector; top "
          f"device time:")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"      {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:4d}"
              f"  {e.key[:90]}")
    del cache
    return {"step_wall_ms": wall * 1e3, "step_wall_nogc_ms": wall_nogc * 1e3,
            "step_wall_after_ms": wall_after * 1e3, "step_device_ms": dev_ms,
            "step_flash_ms": flash_ms, "step_launches": n_kern}


# ---------------------------------------------------------------------------
# phase 3h: the MoE family and ring-buffer (sliding-window) serving
# ---------------------------------------------------------------------------

# (a) olmoe's prefill logits against Model.logits over the prompt: the
# same T, so the same capacity and, up to the last GEMM's shape, the same
# ops; a few bf16 ulps of the logits
MOE_PREFILL_REL = 1e-2
# 27.7 GB of f32 weights, one layer's bf16 expert copies (0.8 GB), the
# cache and activations
MOE_MEM_GB = 30.0
# with f32 activations the two paths' router logits differ by ~1e-5, and
# a top-8 boundary that close is rare: most (step, sequence) pairs come
# before any routing flip, and at least half must
MOE_F32_HELD = 0.5
# (b) the reference's long_500k ring (cfg.sliding_window) and a prompt
# past it, so the ring is full and wraps
WINDOW_PROMPT = 8704
SERVE_BUDGET_S = 120.0


def _flash_want(cfg, new: int) -> tuple:
    """A greedy serve's launches and flash paths: one wgmma prefill call
    and ``new`` split-KV decode calls per layer (per attention
    application in a hybrid model)."""
    n, k = attn_apps(cfg), step_apps(cfg)
    want = {"segment_agg": 0, "segment_broadcast": 0,
            "flash_attention": n + k * new, "wkv6": 0}
    return want, {"split_kv": k * new, "wgmma": n, "f32_tile": 0}


def _counted_serve(torch, ops, fa, serve, cfg, params, toks, new, label,
                   window=0, extras=None):
    """``greedy_serve`` with the launch and path counts set to 0 just
    before and held just after; prints its walls."""
    ops.reset_launches()
    fa.reset_paths()
    res = serve.greedy_serve(cfg, params, toks, new, window=window,
                             **({"extras": extras} if extras else {}))
    counts, paths = dict(ops.LAUNCHES), dict(fa.PATH_CALLS)
    want, want_paths = _flash_want(cfg, new)
    b, s = toks.shape
    print(f"    {label}: prefill {s} tokens x{b}: {res['prefill_s']:.4f} s; "
          f"{new} decode steps x{b}: {res['decode_s']:.4f} s "
          f"({res['tok_per_s']:.1f} tok/s); launches {counts}, flash paths "
          f"{paths}")
    check(counts == want, f"{label}: launch counts {counts} != {want}")
    check(paths == want_paths, f"{label}: flash paths {paths} != "
          f"{want_paths}")
    return res, {"counts": counts, "paths": paths,
                 "prefill_s": res["prefill_s"],
                 "tok_per_s": res["tok_per_s"]}


@contextlib.contextmanager
def _routes(moe_mod):
    """Records every ``moe._route`` call as (f32 router logits (T, E),
    experts (T, k)), in call order; the call's own results are returned
    unchanged."""
    rec, route = [], moe_mod._route

    def recorded(params, x_flat, n_experts, top_k):
        out = route(params, x_flat, n_experts, top_k)
        rec.append((x_flat.float() @ params["router"].float(), out[1]))
        return out

    moe_mod._route = recorded
    try:
        yield rec
    finally:
        moe_mod._route = route


def routed_logits_check(torch, moe_mod, model, cfg, params, toks, res,
                        dec_rec, min_held: float = 0.0) -> float:
    """A dropless serve against ``Model.logits`` over the whole sequence,
    with the routing of both paths compared token by token.

    A decode step's hidden states differ from the forward's by roundings
    (other attention kernels and GEMM shapes), and where a token's k-th
    and (k+1)-th router logits lie closer than that, the two paths pick
    different experts (a flip). The random weights' experts are large
    (the reference's init takes E as the fan-in of the (E, d, f) stacks),
    so one flip moves a token's output far and its sequence then
    diverges. So each sequence is held to SERVE_REL at every step before
    its first flip, and at least ``min_held`` of all (step, sequence)
    pairs must be held; flips are printed with their margins beside the
    router-logit difference between the paths at that token."""
    b, prompt = toks.shape
    n_layers, k, new = cfg.n_layers, cfg.moe.top_k, len(res["logits"]) - 1
    seq = torch.cat([toks, res["tokens"]], dim=1)
    with _routes(moe_mod) as fwd_rec, torch.no_grad():
        full = model.logits(params, {"tokens": seq})
    s_all = seq.shape[1]
    flips, first = [], [new] * b
    for i in range(new):                 # step i feeds position prompt + i
        rows = torch.arange(b, device=seq.device) * s_all + prompt + i
        for layer in range(n_layers):
            lg_d, e_d = dec_rec[n_layers * (1 + i) + layer]
            lg_f, e_f = (t[rows] for t in fwd_rec[layer])
            for j in range(b):
                if set(e_d[j].tolist()) == set(e_f[j].tolist()):
                    continue
                top = lg_f[j].sort(descending=True).values
                flips.append((i, layer, j, float(top[k - 1] - top[k]),
                              float((lg_d[j] - lg_f[j]).abs().max())))
                first[j] = min(first[j], i)
    tol = SERVE_REL[cfg.activ_dtype]
    held, errs = 0, []
    for i, lg in enumerate(res["logits"]):
        ref_lg = full[:, prompt - 1 + i]
        check(bool(torch.isfinite(lg.float()).all()),
              f"{cfg.name}: step {i} logits not finite")
        errs.append(rel_err(torch, lg, ref_lg))
        for j in range(b):
            if i == 0 or i - 1 < first[j]:         # before any flip
                e = rel_err(torch, lg[j], ref_lg[j])
                check(e <= tol, f"{cfg.name}: step {i}, sequence {j}, no "
                      f"routing flip before it, relative L2 {e} > {tol}")
                held += 1
    del full
    n_pairs = (new + 1) * b
    check(held >= min_held * n_pairs, f"{cfg.name} ({cfg.activ_dtype}): "
          f"only {held} of {n_pairs} (step, sequence) pairs precede their "
          f"sequence's first routing flip (at least {min_held:.0%} asked)")
    margins = sorted(f[3] for f in flips)
    print(f"    Model.logits ({cfg.activ_dtype}) over {s_all} tokens: "
          f"per-step relative L2 error prefill {errs[0]:.3e}, decode max "
          f"{max(errs[1:]):.3e}, mean {sum(errs[1:]) / new:.3e}; routing "
          f"flips between decode and forward: {len(flips)} of "
          f"{new * n_layers * b} (step, layer, token) routes, first flip per "
          f"sequence at step {first}; {held} of {n_pairs} (step, "
          f"sequence) pairs before their sequence's first flip held within "
          f"{tol}")
    for f in flips[:8]:
        print(f"      flip at step {f[0]}, layer {f[1]}, sequence {f[2]}: "
              f"margin of the top-{k} boundary {f[3]:.3e}, router logits "
              f"of the two paths differ by up to {f[4]:.3e}")
    if flips:
        print(f"      flip margins: min {margins[0]:.3e}, median "
              f"{margins[len(margins) // 2]:.3e}, max {margins[-1]:.3e}")
    return max(errs)


def serve_moe_and_ring(torch, ops, fa, configs, model_mod, serve,
                       dev) -> dict:
    """Phase 3h. (a) olmoe-1b-7b at full width (random f32 weights from
    seed 0, bf16 activations) through ``greedy_serve``: a (4, 1024)
    prompt and 32 greedy steps, launches held; the prefill logits against
    ``Model.logits`` over the prompt; then the dropless copy
    (capacity_factor = E / k, capacity T at any T) served the same way
    in bf16 and in f32 activations, every step held against
    ``Model.logits`` over the sequence per sequence up to its first
    routing flip (``routed_logits_check``); one profiled decode step of
    the published config. (b) qwen3-1.7b from a ring of its sliding
    window (8192): a (1, 8704)
    prompt and 32 steps, the ring checked slot by slot and every step
    held against ``Model.logits(window=8192)``. Returns each serve's
    counts for the JSON rows."""
    import dataclasses
    from repro_torch.data.synthetic import token_batch
    from repro_torch.models import moe as moe_mod
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = {}
    batch, prompt, new = 4, 1024, 32
    cfg = configs.get_config("olmoe-1b-7b")
    model = model_mod.build_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    t_init = sync_time(torch) - t0
    n_par = sum(int(t.numel()) for t in _leaves(params))
    toks = token_batch(0, batch, prompt, cfg.vocab, dev)["tokens"]
    mc = cfg.moe
    print(f"  (a) {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{mc.n_experts} experts top-{mc.top_k}, d_ff {cfg.d_ff}, "
          f"{n_par / 1e9:.3f} B f32 params "
          f"({torch.cuda.memory_allocated(dev) / 1e9:.2f} GB), init "
          f"{t_init:.2f} s; capacity per expert: prefill "
          f"{moe_mod.capacity(batch * prompt, mc)}, decode "
          f"{moe_mod.capacity(batch, mc)} (capacity factor "
          f"{mc.capacity_factor})")
    serve.greedy_serve(cfg, params, toks[:1, :64], 2)        # warm-up
    res, out[cfg.name] = _counted_serve(torch, ops, fa, serve, cfg, params,
                                        toks, new, "published config")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    with torch.no_grad():
        full = model.logits(params, {"tokens": toks})
    e = rel_err(torch, res["logits"][0], full[:, -1])
    same = float((res["logits"][0].argmax(-1) == full[:, -1].argmax(-1)
                  ).float().mean())
    del full, res
    print(f"    prefill logits vs Model.logits over the prompt: relative L2 "
          f"{e:.3e} (tolerance {MOE_PREFILL_REL}), same argmax {same:.2f}; "
          f"peak memory {peak:.2f} GB (reckoned {MOE_MEM_GB:.0f} GB)")
    check(e <= MOE_PREFILL_REL, f"olmoe prefill logits differ from "
          f"Model.logits by {e}")
    dl = dataclasses.replace(cfg, moe=dataclasses.replace(
        mc, capacity_factor=mc.n_experts / mc.top_k))
    with _routes(moe_mod) as dec_rec:
        res, _ = _counted_serve(torch, ops, fa, serve, dl, params, toks, new,
                                f"dropless copy (capacity factor "
                                f"{dl.moe.capacity_factor})")
    out[cfg.name]["rel_err"] = routed_logits_check(
        torch, moe_mod, model_mod.build_model(dl), dl, params, toks, res,
        dec_rec)
    del res, dec_rec
    dl32 = dataclasses.replace(dl, activ_dtype="float32")
    with _routes(moe_mod) as dec_rec:
        res = serve.greedy_serve(dl32, params, toks, new)
    print(f"    dropless copy, f32 activations: prefill "
          f"{res['prefill_s']:.4f} s, {res['tok_per_s']:.1f} tok/s")
    out[cfg.name]["rel_err_f32"] = routed_logits_check(
        torch, moe_mod, model_mod.build_model(dl32), dl32, params, toks,
        res, dec_rec, min_held=MOE_F32_HELD)
    out[cfg.name]["peak_gb"] = peak
    del res
    out[cfg.name].update(profile_decode(torch, serve, cfg, params, toks))
    del params
    torch.cuda.empty_cache()

    cfg = configs.get_config("qwen3-1.7b")
    win = cfg.sliding_window
    model = model_mod.build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    toks = token_batch(1, 1, WINDOW_PROMPT, cfg.vocab, dev)["tokens"]
    print(f"  (b) {cfg.name}, window {win}, prompt {WINDOW_PROMPT}")
    torch.cuda.reset_peak_memory_stats(dev)
    res, out[cfg.name + "-window"] = _counted_serve(
        torch, ops, fa, serve, cfg, params, toks, new, "ring buffer",
        window=win)
    cache, t = res["cache"], WINDOW_PROMPT + new
    ring = torch.roll(torch.arange(t - win, t, dtype=torch.int32,
                                   device=dev), t % win)
    check(cache["t"] == t and cache["k"].shape[2] == win
          and bool((cache["pos"] == ring).all()),
          f"ring buffer: t {cache['t']}, {cache['k'].shape[2]} slots, "
          f"positions not p at slot p % {win}")
    print(f"    ring of {win} slots holds positions {t - win}..{t - 1}, "
          f"position p at slot p % {win}; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    del cache
    out[cfg.name + "-window"]["rel_err"] = logits_check(
        torch, ops, model, cfg, params, toks, res, window=win)
    del params, res
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"  phase 3h took {wall:.1f} s (budget {SERVE_BUDGET_S:.0f} s)")
    return out


# ---------------------------------------------------------------------------
# phase 3i: the hybrid family (zamba2-7b)
# ---------------------------------------------------------------------------

# the peak's bound: 13.2 GB of bf16 weights, the cache (Mamba2 states
# 0.59 GB, 14 k/v caches 0.85 GB) and the chunked SSD's f32 transients
# (0.24 GB each); a copy of the weights or the cache would cross it
HYBRID_MEM_GB = 18.0


def serve_hybrid(torch, ops, fa, configs, model_mod, serve, dev) -> dict:
    """Phase 3i: zamba2-7b at full width (bf16 weights from seed 0, bf16
    activations) through ``greedy_serve``: a (4, 1024) prompt and 32
    greedy steps, the flash launches and paths held (14 wgmma, 14 x 32
    split-KV), the prefill and every step against ``Model.logits`` over
    the sequence within SERVE_REL, peak memory within HYBRID_MEM_GB, one
    profiled decode step. Returns the
    serve's counts and readings for the JSON rows."""
    from repro_torch.data.synthetic import token_batch
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    batch, prompt, new = 4, 1024, 32
    cfg = configs.get_config("zamba2-7b")
    model = model_mod.build_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    t_init = sync_time(torch) - t0
    n_par = sum(int(t.numel()) for t in _leaves(params))
    toks = token_batch(0, batch, prompt, cfg.vocab, dev)["tokens"]
    print(f"  {cfg.name}: {cfg.n_layers} Mamba2 layers, d_model "
          f"{cfg.d_model}, shared attention ({cfg.n_heads} heads of "
          f"{cfg.head_dim}) applied {attn_apps(cfg)} times, "
          f"{n_par / 1e9:.3f} B {cfg.param_dtype} params "
          f"({torch.cuda.memory_allocated(dev) / 1e9:.2f} GB), init "
          f"{t_init:.2f} s")
    serve.greedy_serve(cfg, params, toks[:1, :64], 2)        # warm-up
    res, out = _counted_serve(torch, ops, fa, serve, cfg, params, toks, new,
                              "zamba2-7b")
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"    peak memory {out['peak_gb']:.2f} GB (bound "
          f"{HYBRID_MEM_GB:.0f} GB)")
    check(out["peak_gb"] <= HYBRID_MEM_GB,
          f"{cfg.name}: peak memory {out['peak_gb']:.2f} GB")
    out["rel_err"] = logits_check(torch, ops, model, cfg, params, toks, res)
    del res
    out.update(profile_decode(torch, serve, cfg, params, toks))
    del params
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"  phase 3i took {wall:.1f} s (budget {SERVE_BUDGET_S:.0f} s)")
    return out


# ---------------------------------------------------------------------------
# phase 3j: the audio and vlm families (whisper-base, qwen2-vl-7b)
# ---------------------------------------------------------------------------

# the peaks' bounds. whisper-base: 0.46 GB of f32 weights (114 M params,
# the 32768 x 512 learned positions included), the cache (0.09 GB, most
# of it the cross k/v of 1500 frames per layer) and the encoder's
# activations; qwen2-vl-7b:
# 30.5 GB of f32 weights, the bf16 copy of the 152064 x 3584 unembedding
# made at each logits call (1.1 GB), the cache (0.15 GB) and the prefill's
# MLP transients (< 1 GB). A bf16 copy of all the weights would cross it.
WHISPER_MEM_GB = 2.0
VLM_MEM_GB = 36.0
# (decoder prompt, memory bound): whisper's prompt is the previous-text
# half of its 448-token context; qwen2-vl's 1024 text tokens follow its
# 256 vision tokens
SERVE_3J = {"whisper-base": (224, WHISPER_MEM_GB),
            "qwen2-vl-7b": (1024, VLM_MEM_GB)}


@contextlib.contextmanager
def _flash_sites(ops):
    """Tallies ``ops.flash_attention`` calls by site: "encoder"
    (non-causal, Sq = Skv), "cross-prefill" / "cross-decode" (non-causal,
    Sq != Skv; decode: one row), "prefill" / "decode" (causal). The
    call's own result is returned unchanged."""
    rec, fn = {}, ops.flash_attention

    def counted(q, k, v, *, causal=True, window=0, q_offset=0):
        one = q.shape[2] == 1
        site = (("decode" if one else "prefill") if causal else
                "cross-decode" if one else
                "encoder" if q.shape[2] == k.shape[2] else "cross-prefill")
        rec[site] = rec.get(site, 0) + 1
        return fn(q, k, v, causal=causal, window=window, q_offset=q_offset)

    ops.flash_attention = counted
    try:
        yield rec
    finally:
        ops.flash_attention = fn


def serve_audio_vlm(torch, ops, fa, configs, model_mod, serve, dev,
                    arch: str) -> dict:
    """Phase 3j for one model at full width (f32 weights from seed 0, bf16
    activations, batch 4, stub inputs from numpy seed 0): whisper-base
    with ``enc_embed`` (4, 1500, 512) and a 224-token decoder prompt, or
    qwen2-vl-7b with ``vision_embed`` (4, 256, 3584) before a 1024-token
    prompt; 32 greedy steps through ``greedy_serve``, the flash launches,
    paths and call sites held, peak memory within its bound, the prefill
    and every step against ``Model.logits`` over the whole sequence
    within SERVE_REL, one profiled decode step. Returns the serve's
    counts and readings for the JSON rows."""
    from repro_torch.data.synthetic import token_batch
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    batch, new = 4, 32
    prompt, mem_gb = SERVE_3J[arch]
    cfg = configs.get_config(arch)
    model = model_mod.build_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    t_init = sync_time(torch) - t0
    n_par = sum(int(t.numel()) for t in _leaves(params))
    toks = token_batch(0, batch, prompt, cfg.vocab, dev)["tokens"]
    extras = serve.stub_extras(cfg, batch, 0, dev)
    (name, x), = extras.items()
    enc = f"{cfg.enc_layers} encoder + " if cfg.enc_layers else ""
    print(f"  {cfg.name}: {enc}{cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} "
          f"heads over {cfg.n_kv_heads} of {cfg.head_dim}, vocab "
          f"{cfg.vocab}, {n_par / 1e9:.3f} B {cfg.param_dtype} params "
          f"({torch.cuda.memory_allocated(dev) / 1e9:.2f} GB), init "
          f"{t_init:.2f} s; {name} {tuple(x.shape)}, prompt {prompt}")
    serve.greedy_serve(cfg, params, toks[:1, :64], 2,
                       extras={name: x[:1]})                # warm-up
    with _flash_sites(ops) as sites:
        res, out = _counted_serve(torch, ops, fa, serve, cfg, params, toks,
                                  new, cfg.name, extras=extras)
    n = cfg.n_layers
    want = ({"encoder": cfg.enc_layers, "prefill": n, "cross-prefill": n,
             "decode": n * new, "cross-decode": n * new}
            if cfg.family == "audio" else {"prefill": n, "decode": n * new})
    out["sites"] = dict(sites)
    print(f"    flash calls by site {out['sites']}")
    check(out["sites"] == want, f"{cfg.name}: flash sites {out['sites']} "
          f"!= {want}")
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"    peak memory {out['peak_gb']:.2f} GB (bound {mem_gb:.0f} GB)")
    check(out["peak_gb"] <= mem_gb,
          f"{cfg.name}: peak memory {out['peak_gb']:.2f} GB")
    out["rel_err"] = logits_check(torch, ops, model, cfg, params, toks, res,
                                  extras=extras)
    del res
    out.update(profile_decode(torch, serve, cfg, params, toks, extras))
    del params
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"  phase 3j {cfg.name} took {wall:.1f} s")
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# phase 4b: times of the LLM kernels
# ---------------------------------------------------------------------------

def visible_pairs(sq, skv, causal, window, q_offset) -> int:
    """(query, key) pairs the masks leave visible: the work the
    attention's data needs."""
    qpos = q_offset + np.arange(sq)
    hi = np.minimum(skv, qpos + 1) if causal else np.full(sq, skv)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(sq)
    return int(np.maximum(hi - lo, 0).sum())


def bound(nbytes, flops, flops_per_s, exps):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / flops_per_s, exps / EXP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_llm(torch, ops, ref, dev) -> dict:
    import torch.nn.functional as F
    res = {}
    before = dict(ops.LAUNCHES)
    for name in MAIN_FLASH:
        _, b, h, hkv, sq, skv, d, causal, win, off = next(
            c for c in FLASH_CASES if c[0] == name)
        q, k, v = flash_inputs(torch, dev, b, h, hkv, sq, skv, d,
                               torch.bfloat16, seed=1)
        kw = dict(causal=causal, window=win, q_offset=off)
        # the yardstick: with q_offset = Skv - 1 a one-row decode sees
        # every key, so SDPA without a mask computes the same function; a
        # window takes an explicit boolean mask
        lib_causal = causal and sq > 1 and not win
        mask = None
        if win:
            qpos = off + torch.arange(sq, device=dev)[:, None]
            kpos = torch.arange(skv, device=dev)[None, :]
            mask = (kpos <= qpos) & (kpos > qpos - win)
        lib = lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=lib_causal, enable_gqa=True)
        check(torch.allclose(lib().float(), ops.flash_attention(
            q, k, v, **kw).float(), atol=2e-2, rtol=2e-2),
            f"SDPA yardstick disagrees at {name}")
        pairs = b * h * visible_pairs(sq, skv, causal, win, off)
        nbytes = 2 * (2 * b * h * sq * d + 2 * b * hkv * skv * d)
        t_b, by = bound(nbytes, 4 * d * pairs, BF16_FLOPS_PER_S, pairs)
        res[(name, "flash_attention")] = _times(
            torch, lambda: ops.flash_attention(q, k, v, **kw),
            lambda: ref.flash_attention_ref(q, k, v, **kw), lib, t_b, by,
            f"flash_attention {name} bf16", nbytes)
    _, b, s, nh, chunk, lohi = WKV_CASES[0]
    r, k, v, w, u = wkv_inputs(torch, dev, b, s, nh, lohi, torch.bfloat16,
                               seed=1)
    hd = 64
    nbytes = 3 * 2 * b * s * nh * hd + 4 * b * s * nh * hd + 4 * nh * hd \
        + 4 * b * s * nh * hd + 4 * b * nh * hd * hd
    # what the recurrence needs, not what this kernel's algorithm spends:
    # per token and head a multiply-add per state element for S += k v^T
    # (the decay's scaling amortised over a step) and one for y = r . S,
    # 4 hd^2 flops in f32; no exponentials
    t_b, by = bound(nbytes, 4 * hd * hd * b * s * nh, F32_FLOPS_PER_S, 0)
    res[("rwkv6-prefill", "wkv6")] = _times(
        torch, lambda: ops.wkv6(r, k, v, w, u, chunk=chunk),
        lambda: ref.wkv6_ref(r, k, v, w, u, chunk=chunk), None, t_b, by,
        "wkv6 rwkv6-prefill r/k/v bf16, w f32", nbytes)
    ops.LAUNCHES.update(before)           # timing launches do not count
    return res


def _times(torch, kern, plain, lib, t_bound, by, label, nbytes) -> dict:
    """kernel and plain in turns (plain, kernel, kernel, plain), the
    library call, and the eager wrapper."""
    t_call = event_ms(torch, kern, iters=20)
    t_p1 = graph_ms(torch, plain, iters=5)
    t_k1 = graph_ms(torch, kern, iters=20)
    t_k2 = graph_ms(torch, kern, iters=20)
    t_p2 = graph_ms(torch, plain, iters=5)
    t_lib = graph_ms(torch, lib, iters=20) if lib is not None else None
    ms = min(t_k1, t_k2)
    lib_txt = f"{t_lib:.4f} ms" if t_lib is not None else "none"
    print(f"  {label}: kernel {t_k1:.4f}/{t_k2:.4f} ms, plain {t_p1:.4f}/"
          f"{t_p2:.4f} ms, library {lib_txt}, eager wrapper call "
          f"{t_call:.4f} ms, {nbytes / 1e6:.2f} MB, bound "
          f"{t_bound * 1e3:.2f} us by {by} ({t_bound / ms * 100:.1f}% of "
          f"bound)")
    return {"ms": ms, "plain_ms": min(t_p1, t_p2), "bound_ms": t_bound,
            "bound_by": by, "library_ms": t_lib, "call_ms": t_call}


def tensor_core_check(_build) -> None:
    """Each flash_attention instantiation's tensor-core instructions in
    its SASS; the bf16 tile path (flash_wgmma_kernel) must have some."""
    counts = _build.tensor_core_ops("flash_attention")
    for k, n in sorted(counts.items()):
        print(f"  SASS {k}: {n} tensor-core instructions (HMMA/HGMMA)")
    tile = {k: n for k, n in counts.items()
            if k.startswith("flash_wgmma_kernel")}
    check(len(tile) == 3 and all(n > 0 for n in tile.values()),
          f"the bf16 tile path has no tensor-core instructions: {counts}")


def serve_only(torch, root: str, archs) -> int:
    """The timed part of phase 3b for the package under ``root``/src, or
    phase 3i for zamba2-7b, or phase 3j for whisper-base and qwen2-vl-7b,
    each model in ``archs`` in turn."""
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch import configs
    from repro_torch.device import disable_tf32
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch import device as device_mod
    from repro_torch.launch import serve, train
    from repro_torch.models import model
    check(os.path.dirname(os.path.abspath(fa.__file__)).startswith(
        os.path.abspath(root)), f"repro_torch not imported from {root}")
    dev = torch.device("cuda", 0)
    print(f"serve-only: {os.path.abspath(root)}, device "
          f"{torch.cuda.get_device_name(0)}")
    print(f"  kernels built in {_build.build_all():.2f} s")
    disable_tf32()
    res = {arch: serve_hybrid(torch, ops, fa, configs, model, serve, dev)
           if arch == "zamba2-7b" else
           serve_audio_vlm(torch, ops, fa, configs, model, serve, dev, arch)
           if arch in SERVE_3J else
           serve_path(torch, ops, fa, configs, model, serve, arch, dev,
                      timed_only=True)
           for arch in archs}
    print(json.dumps({"serve": {a: {k: v for k, v in r.items()
                                    if k not in ("counts", "paths",
                                                 "sites")}
                                for a, r in res.items()},
                      "root": os.path.abspath(root)}))
    return 0


def main() -> int:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--serve-only", action="store_true",
                        help="serve the full-width models only")
    parser.add_argument("--arch", action="append",
                        choices=("qwen3-1.7b", "rwkv6-1.6b", "zamba2-7b",
                                 "whisper-base", "qwen2-vl-7b"),
                        help="with --serve-only: the model to serve, "
                        "repeatable (default: qwen3-1.7b and rwkv6-1.6b)")
    parser.add_argument("--root", default=ROOT,
                        help="with --serve-only: the checkout whose src/ "
                        "is imported (default: this one)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    root = args.root if args.serve_only else ROOT
    src = os.path.join(root, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found; run this script "
              f"from a checkout of the repository", file=sys.stderr)
        return 1
    if args.serve_only:
        return serve_only(torch, root,
                          args.arch or ("qwen3-1.7b", "rwkv6-1.6b"))
    sys.path.insert(0, SRC)
    from repro_torch import configs, runtime, telemetry
    from repro_torch.checkpoint import store
    from repro_torch.core import flatbank, hfl, sync
    from repro_torch.core.agent import ppo
    from repro_torch.device import disable_tf32
    from repro_torch.kernels import _build, flash_attention, hier_agg, ops
    from repro_torch.kernels import ref, wkv6
    from repro_torch import device as device_mod
    from repro_torch.launch import serve, train
    from repro_torch.models import model
    from repro_torch.sim import env as env_mod

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    print("phase 1: build")
    t_build = _build.build_all()
    for name, log in sorted(_build.BUILD_LOGS.items()):
        print(f"  nvcc {name}.cu:\n    " + "\n    ".join(
            ln for ln in log.strip().splitlines() if ln.strip()))
    lib_t0 = time.perf_counter()
    for mod in (hier_agg, flash_attention, wkv6):
        mod._lib()
    print(f"  built in {t_build:.2f} s, loaded in "
          f"{time.perf_counter() - lib_t0:.3f} s")
    tensor_core_check(_build)

    print("phase 2: kernels against their plain versions (atol=rtol=1e-5 "
          "for segment_agg, bitwise for segment_broadcast)")
    err = kernel_checks(torch, ops, ref, dev)
    llm_err = llm_agg_check(torch, ops, ref, dev)
    print("phase 2b: LLM kernels against their plain versions (flash: "
          f"atol=rtol {FLASH_TOL}; wkv6: atol=rtol {WKV_TOL}, hard decay "
          f"{WKV_HARD_TOL})")
    err.update(llm_kernel_checks(torch, ops, ref, flash_attention, dev))

    print("phase 3: the main path")
    small_round_check(torch, hfl, model, dev)
    runs = {task: main_path(torch, ops, env_mod, task, dev)
            for task in ("cifar", "mnist")}

    print(f"phase 3c: the agent and the schemes ({smi})")
    t0 = time.perf_counter()
    agents_and_schemes(torch, ops, ref, env_mod, sync, ppo, hfl, model, dev)
    print(f"  phase 3c took {time.perf_counter() - t0:.1f} s")

    print(f"phase 3d: the asynchronous runtime ({smi})")
    t0 = time.perf_counter()
    runs["cifar-async"] = async_runtime(torch, ops, ref, env_mod, sync, hfl,
                                        flatbank, runtime)
    print(f"  phase 3d took {time.perf_counter() - t0:.1f} s")

    print(f"phase 3e: checkpoints, telemetry, health and the ledger ({smi})")
    ktime_us = observability(torch, ops, env_mod, runtime, sync, telemetry,
                             store, env_mod.EnvConfig(task="cifar",
                                                      mode="real"))

    print(f"phase 3f: the sharded bank over torch.distributed ({smi})")
    from repro_torch.launch import mesh as mesh_lib
    sharded = sharded_bank(torch, ops, env_mod, flatbank, mesh_lib)

    print("phase 3b: the LLM serving path")
    disable_tf32()
    small_serve_check(torch, configs, model, dev)
    served = {arch: serve_path(torch, ops, flash_attention, configs, model,
                               serve, arch, dev)
              for arch in ("qwen3-1.7b", "rwkv6-1.6b")}

    print(f"phase 3g: the hierarchical LLM train step ({smi})")
    trained = llm_train(torch, ops, configs, model, train, mesh_lib,
                        device_mod, dev)

    print(f"phase 3k: the replica plane over gloo ranks on the one card "
          f"({smi})")
    replicas = replica_plane(torch, ops, env_mod, runtime, sync, flatbank,
                             store, configs, model, train, mesh_lib, trained,
                             dev)

    print(f"phase 3n: the fsdp axis, each whisper-base replica over "
          f"{FSDP_WORLD} gloo fsdp ranks on the one card, run in phase 3k's "
          f"world ({smi})")
    fsdp = fsdp_plane(torch, replicas["fsdp"], trained, replicas["wall"])

    print(f"phase 3l: the tensor plane, each replica over {TP_WORLD} gloo tp "
          f"ranks on the one card, then phase 3o on its ranks ({smi})")
    tensor = tensor_plane(torch, trained, "3l",
                          served["qwen3-1.7b"].pop("ref"))
    served["qwen3-1.7b-tp4"] = {"paths": tensor.pop("serve_paths")}

    print(f"phase 3m: the tensor plane of the ssm family, each rwkv6-1.6b "
          f"replica over {TP_WORLD} gloo tp ranks on the one card ({smi})")
    tensor_rwkv = tensor_plane(torch, trained, "3m")

    print(f"phase 3h: MoE and ring-buffer serving ({smi})")
    served.update(serve_moe_and_ring(torch, ops, flash_attention, configs,
                                     model, serve, dev))

    print(f"phase 3i: the hybrid family, zamba2-7b at full width ({smi})")
    served["zamba2-7b"] = serve_hybrid(torch, ops, flash_attention, configs,
                                       model, serve, dev)

    print(f"phase 3j: the audio and vlm families, whisper-base and "
          f"qwen2-vl-7b at full width ({smi})")
    for arch in SERVE_3J:
        served[arch] = serve_audio_vlm(torch, ops, flash_attention, configs,
                                       model, serve, dev, arch)

    print("phase 4: times per call, CUDA events around a CUDA-graph "
          "replay of 50 calls (kernel and plain each twice, in turns); "
          "the eager wrapper call is 50 back-to-back calls")
    rows = timings(torch, hier_agg, ops, ref, dev, runs, err)
    # the sharded Eq. 1: one rank's partial launch (25 of 50 rows) in
    # phase 3f (b), its launches those of the 2 ranks' warmup rounds
    rows.append(dict(name="segment_agg", route="cuda",
                     source=KERNEL_SRC["segment_agg"],
                     replaces=REPLACES["segment_agg"],
                     shape="cifar-eq1-sharded-k2", **sharded))
    # the LLM edge mean: the largest leaf of phase 3g (b)'s round, its
    # launches those of that round (every leaf, Eq. 1 and Eq. 2); a rank's
    # partial of phase 3k's full-width Eq. 1, its launches those of both
    # ranks' round; a tp rank's block of that leaf in phase 3l, the same
    # shape as rwkv6-1.6b's largest block (cmix w_k, 24 x 2048 x 7168 / 4)
    # in phase 3m, its launches those of both phases' rounds on 4 ranks;
    # whisper's largest whole leaf, its launches those of phase 3g (f)'s
    # round, and a fsdp rank's block of its MLP, those of phase 3n's bf16
    # round on 2 ranks
    launches = {LLM_AGG[0]: trained["launches"],
                LLM_PARTIAL[0]: replicas["launches"],
                LLM_TP[0]: {k: tensor[k] + tensor_rwkv[k] for k in tensor},
                WHISPER_AGG[0]: trained["whisper"]["counts"],
                WHISPER_FT[0]: fsdp}
    for (k, shape), t in time_llm_agg(torch, hier_agg, ops, ref,
                                      dev).items():
        kern = "segment_agg" if k == "segment_sum_partial" else k
        rows.append(dict(name=kern, route="cuda", source=KERNEL_SRC[kern],
                         replaces=REPLACES[kern],
                         launches=launches[shape][kern],
                         max_abs_err=llm_err[(k, shape)], shape=shape, **t))
    cifar_eq1 = {r["name"]: r["ms"] for r in rows
                 if r["shape"] == "cifar-eq1"}
    print(f"  phase 3e's in-program ktime medians (CUDA events around each "
          f"eager call, synchronised) beside the graph-timed CIFAR Eq. 1 "
          f"launch: segment_agg {ktime_us['segment_agg'] / 1e3:.4f} ms vs "
          f"{cifar_eq1['segment_agg']:.4f} ms, segment_broadcast "
          f"{ktime_us['segment_broadcast'] / 1e3:.4f} ms vs "
          f"{cifar_eq1['segment_broadcast']:.4f} ms")
    print("phase 4b: LLM kernel times, CUDA events around a CUDA-graph "
          "replay (20 kernel calls, 5 plain calls; kernel and plain each "
          "twice, in turns); the eager wrapper call is 20 back-to-back calls")
    llm = time_llm(torch, ops, ref, dev)
    # flash_attention: one row per serving shape, each with the calls its
    # path took in its serve (prefill: wgmma, decode: split_kv)
    for shape, (serve_name, path, site) in MAIN_FLASH.items():
        t = dict(llm[(shape, "flash_attention")])
        t.pop("call_ms")
        sv = served[serve_name]
        rows.append(dict(name="flash_attention", route="cuda",
                         source=KERNEL_SRC["flash_attention"],
                         replaces=REPLACES["flash_attention"],
                         launches=(sv["sites"][site] if site
                                   else sv["paths"][path]),
                         max_abs_err=err["flash_attention"][shape],
                         shape=shape, path=path, **t))
    t = dict(llm[("rwkv6-prefill", "wkv6")])
    t.pop("call_ms")
    rows.append(dict(name="wkv6", route="cuda", source=KERNEL_SRC["wkv6"],
                     replaces=REPLACES["wkv6"],
                     launches=served["rwkv6-1.6b"]["counts"]["wkv6"],
                     max_abs_err=err["wkv6"], **t))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
