#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order; any failure raises and exits nonzero:
  1. environment: torch / CUDA versions and the card's name and power limit;
     TF32 off for matrix products and convolutions (full f32 products);
  2. build K1/K2 (``src/repro_torch/csrc/grouped_ffn_flat.cu``), K1b
     (``src/repro_torch/csrc/grouped_ffn_flat_bwd.cu``), K3 and K3s
     (``src/repro_torch/csrc/wkv6.cu``), K3b
     (``src/repro_torch/csrc/wkv6_bwd.cu``) and K4
     (``src/repro_torch/csrc/microep_sched.cu``) with nvcc, all five
     started together;
  3. K1 against its plain PyTorch version on the card, f32 and bf16, all
     three activations: (a) bm 128, S 3, H 128, F 512, counts [100, 0, 250];
     (b) the olmoe-1b-7b decode geometry of phase 4 (bm 8, S 64, H 2048,
     F 1024, the flat buffer the path builds for the serving batch);
     (c) ragged H and F; (d) paper-mixtral-16x2b's decode geometry of phase
     18 (expert tensor parallelism 2: 32 virtual experts of H 2048, F
     4096, 4 rows a token).  Tolerances: f32 2e-5 at (a) and (c), 1e-4 at
     (b) and (d) (sums thousands long, taken in another order), bf16 2e-2;
     rows outside every group must be exact zeros.  Times K1 (the
     weight-streaming up and down kernels, one call) and the plain version
     at (b) and (d);
  4. serve olmoe-1b-7b at full width and depth (16 layers, 64 experts,
     f32 weights drawn on the card from a seeded generator) through
     ``ServingSession``: every request finishes, no overflow, and K1 and K4
     (the scheduler) ran in every MoE layer of every step (each launch
     count = (steps + warm-up) x 16) while the plain scheduler ran not
     once; then the decode step's time split into scheduler, K1 and the
     rest;
  5. the whole path on the card against the CPU on paper-gpt-32x1.3b
     smoke with identical weights: identical tokens per request;
  6. K2 (the slot-layout grouped FFN, entry point ``ops.grouped_ffn``)
     against its plain version, f32 (2e-5) and bf16 (2e-2), all three
     activations: the reference kernel test's shapes, a zero-count slot,
     and the olmoe-1b-7b decode geometry in the slot layout (S 64, C 8,
     bm 8, H 2048, F 1024, 32 routed rows); rows at or past each count must
     be exact zeros.  No model reaches K2: its path is its entry point,
     driven in the timed run at the decode geometry;
  7. K3 (the RWKV-6 recurrence, entry point ``ops.wkv6``) against its plain
     version, f32 (rtol = atol = 1e-4) and bf16 (5e-2), (BH, T, D) in
     (2, 128, 64), (1, 256, 128), (4, 128, 128), (1, 100, 64), the
     sub-chunk edges T = 1, 15, 17, D = 40, and the forward's geometry
     (256, 2048, 64) with the reference test's decays and with rwkv6-7b's;
     every output free of NaN (the reference test's decays are the
     strongest drawn); tensors whose addresses are not 16-byte aligned
     (one element past an allocation) give the same result as aligned
     ones; prints the share of each check's allowance used; times K3 and
     the plain version at the forward's geometry on rwkv6-7b's decays.
     Then K3s (K3 with state in and state out, ``ops.wkv6(..., state=)``;
     ``launch/time_k3.check_state``) against its plain version from random
     nonzero states, o and the final state, f32 (rtol = atol = 1e-4) and
     bf16 (5e-2): T in 1, 7, 15, 16, 17, 100, 2048 (both sides of the
     switch from the step-by-step to the sub-chunk kernel at 16), D 40 and
     128, and the decode geometry of phase 14 (256, 1, 64) on rwkv6-7b's
     decays; K3 over T 2048 equals K3s over its two halves with the state
     carried, and 64 chained T 1 calls equal the plain version's 64 steps;
     two calls equal bit for bit; after 512 chained decode steps K3s's
     state is at most twice as far from the plain version in float64 as
     the f32 plain version; unaligned tensors give the same result; times
     K3s at the decode geometry and at T 2048 beside the plain version and
     the byte bound;
  8. rwkv6-7b at full width and depth (32 layers, d_model 4096, 64 heads,
     f32 weights drawn on the card from a seeded generator) through
     ``make_forward_fn``: serving prefill (``last_only``) of 4 × 2048
     tokens, then an evaluation job (full logits and ``lm_loss`` with
     next-token labels) on the same batch; K3 launched 32 times a forward;
     wall time per forward, the loss and the peak device memory;
  9. the forward on the card against the CPU on rwkv6-7b smoke with
     identical weights and tokens: logits within 1e-4;
 10. K4 (the MicroEP scheduler, entry point ``ops.schedule``) against its
     plain version on the cases of ``launch/time_k4.py``: the olmoe-1b-7b
     decode geometry (E 64, G 1, R 1, counts of 4 tokens routed top-8),
     paper-mixtral-16x2b's (E 32 virtual experts, G 1, R 1), the paper's
     group (E 64 on 4 x 4 devices, 2-3 replicas an expert on a seeded
     placement) and greedy sequencing (E 16 on 2 x 4); three
     micro-batches with the warm start carried and three cold ones;
     x_int, flow and max_load equal, x within 1e-5, balance within 1e-6.
     Times K4 (mean of 20 launches queued behind a spin kernel, and paced
     by its host work) and the plain version at the olmoe and paper
     geometries;
 11. K1b (K1's backward, ``csrc/grouped_ffn_flat_bwd.cu``) against its
     plain version, f32 (2e-5), all three activations, on ragged groups
     (bm 8 with empty and one-row groups, bm 128, H 199 / F 301); dx exactly
     zero outside every group; then ``launch/time_k1b.py`` at olmoe-1b-7b's
     training geometry (one MoE layer of one micro-batch of phase 12: N
     49 664, 16 384 rows in groups, H 2048, F 1024, swiglu): K1 and K1b
     within rtol 1e-4 and an atol of 1e-5 of each output's largest
     magnitude of their plain versions, K1b twice equal bit for bit, each
     K1b output at most twice as far from the plain K1b in float64 as the
     f32 plain version (the guard against a truncating tensor-core
     accumulator), and both timed beside their bounds (K1b's: 3xTF32 on
     the tensor cores, 3 × operations ÷ 495 TFLOP/s); the same at
     paper-mixtral-16x2b's training geometry of phase 19 (2048 tokens x
     top-2 x etp 2: N 24 832, 8192 rows over 32 virtual experts, H 2048, F
     4096);
 12. train olmoe-1b-7b at full width, depth cut to 4 layers
     (``dataclasses.replace(cfg, num_layers=4)``: f32 master, gradient and
     two Adam moments take 16 B a parameter, and the 16-layer model's 6.82
     B parameters would need ~109 GB), f32 weights drawn on the card from a
     seeded generator: six steps of 8 × 512 tokens of the synthetic stream
     in 2 micro-batches through ``init_train_state`` / ``make_train_step``;
     each step's loss, gradient norm, balance and overflow; finite losses
     and gradient norms, no overflow, K1, K1b and K4 each launched 8 times a
     step (4 layers × 2 micro-batches) and no plain K1, K1b or K4; the step
     time, tokens/s and peak memory, then one more step split into K1, K1b,
     the scheduler, AdamW and the rest;
 13. one train step on the card against the CPU's plain path on the smoke
     configs of olmoe-1b-7b, paper-gpt-32x1.3b and rwkv6-7b (``launch/
     check_train.py``): loss within 2e-4, gradients within rtol 1e-4 / atol
     1e-5, Adam moments within rtol 2e-2 / atol 2e-4; K3 and K3b once an
     RWKV-6 layer and micro-batch on the card, no plain recurrence;
 14. serve rwkv6-7b at full width and depth (f32 weights drawn on the card
     from a seeded generator, built for this phase and freed after it):
     (a) teacher forcing, 2 sequences x 64 tokens one token a step against
     ``make_forward_fn(last_only=False)`` (K3s against K3): every layer
     decodes its own input in the forward from a zero state
     (``RWKVBlock.decode``), its output within ``TEACHER_TOL`` of the
     forward's largest magnitude, and the last layer's decoded output
     through the head gives the forward's logits within ``TEACHER_TOL`` of
     the largest logit magnitude.  Free-running ``decode_step`` over all 32
     layers is printed beside the forward with its input perturbed by
     1e-7, not checked: with these random weights the 32 layers amplify
     f32 rounding differences about a million-fold; (b) 4 Poisson requests
     (prompts of 16-32 tokens, 32 generated each) through
     ``ServingSession`` at 4 slots: every request finishes; (c) K3s launched
     32 x (decode steps + warm-up) times, and neither K3 nor the plain
     ``wkv6_chunk_ref`` once; (d) the decode step's wall time (mean and
     range over 10 steps), generated tokens/s and peak memory, then one step
     split by synchronised timers into K3s (32 calls), the matrix products
     and the rest, and one under ``torch.profiler``: device time by part
     and the device's idle share;
 15. the serving path on the card against the CPU on rwkv6-7b smoke with
     identical weights: two decode steps' logits within rtol = atol =
     1e-4 and states within 1e-4 of their largest magnitude, identical
     tokens per request;
 16. the scheduler core at the paper's groups, through
     ``MicroEPEngine.build(...).schedule`` on the card (K4, one launch a
     call), every schedule equal bit for bit (x, x_int, flow, max_load,
     balance) to the same engine's on the CPU (the plain version), cold
     and with the warm start carried (``launch/time_k4.scheduler_core``):
     (a) Fig. 7's group (2 x 4 devices, 32 experts, 2048 tokens a device,
     Zipf s 0, 0.8, 1.6): MicroEP with Gauss-Seidel (30 sweeps) on the
     random, latin and asymmetric placements (asymmetric from a stale
     history), Jacobi on latin, vanilla mode and the five baselines, max
     load over the ideal beside HiGHS's optimum; each Gauss-Seidel schedule
     at or below 1.01 x the optimum + 1 and at or below Megatron's;
     (b) olmoe-1b-7b's 64 experts on a 4 x 4 latin group: Gauss-Seidel,
     Jacobi, routing without locality, a heterogeneous profile (weight 2
     on half the devices), and MemFine caps from ``memory_plan`` of
     ``MemoryModel.from_arch(olmoe-1b-7b)``, each warm max load beside
     HiGHS's optimum; (c) Fig. 9's grid, (G, E) from (8, 32) to (64, 256)
     on 2-row latin groups, both solver orders, cold and warm: K4's device
     time.  K4 launched in the phase, counted from 0;
 17. dense decoders, nothing cut, which launch no hand-written kernel (their
     FFN and attention are plain products, as in the reference): (a) serve
     qwen1.5-0.5b (0.464 B parameters) and gemma-2b (2.506 B; MQA, head_dim
     256, GeGLU, vocab 256 000) with 4 Poisson requests at 4 slots, every
     request finished, no balance, no kernel launched; decode steps, tokens,
     the wall time a step; (b) two training steps of qwen1.5-0.5b, 8 × 512
     synthetic tokens in 2 micro-batches; (c) the serving path card vs CPU
     on the smoke config of each, as phase 5, and one train step of
     qwen1.5-0.5b smoke, as phase 13;
 18. serve paper-mixtral-16x2b (the paper's Table 2 Mixtral, expert tensor
     parallelism 2 as 32 virtual experts) at full width, depth cut from 32
     to 16 layers (104.7 GB of f32 weights do not fit; 16 layers take 52.5
     GB), as phase 4: K1 (S 32, H 2048, F 4096, bm 8, 4 rows a token) and
     K4 (E 32, G 1, R 1) launched in every layer of every step, the plain
     scheduler not once, the step's split; then the serving path card vs
     CPU on its smoke config with etp 2, as phase 5;
 19. train paper-mixtral-16x2b at full width, depth cut to 4 layers (3.33 B
     parameters; f32 master, gradients and two Adam moments take 53.3 GB):
     four steps of 8 × 512 tokens in 2 micro-batches, as phase 12 (K4, K1
     and K1b each 8 times a step); then one train step of its smoke config
     with etp 2 card vs CPU, as phase 13;
 20. K3b (K3's backward, ``src/repro_torch/csrc/wkv6_bwd.cu``, sub-chunks
     on the tensor cores) against its plain version
     ``ref.wkv6_bwd_subchunk_ref`` (``launch/time_k3.py --backward``): at
     rwkv6-7b's training geometry (BH 4 x 64 heads, T 512, D 64, its
     decays) and at T 1, 15, 16, 17, 100, 2048 with D 32, 64, 128, within
     rtol 1e-4 and an atol of 1e-5 of each output's largest magnitude; two
     calls equal bit for bit; each output at most twice as far from the
     float64 evaluation as the f32 step-order plain version
     ``ref.wkv6_bwd_ref``, at T 512 and 2048; K3 at the training geometry
     against its plain version; K3b and K3 timed there beside their plain
     versions and bounds (K3b's 3xTF32 bound);
 21. train rwkv6-7b at full width, depth cut to 8 of its 32 layers (7.29 B
     parameters would need 116.6 GB of f32 master, gradients and two Adam
     moments; 8 layers hold 2.024 B, 32.4 GB): (a) four steps of 8 × 512
     tokens in 2 micro-batches, as phase 12, with K3 and K3b each 16 times
     a step and no plain recurrence, the split timers, and one more step
     with every block rematerialised (K3 32 times, K3b 16; its peak
     memory); (b) one step at full width and 2 layers without and with
     remat from identical weights: every gradient equal bit for bit, K3
     launched twice as often; (c) rwkv6-7b smoke's card model saved in the
     checkpoint files and restored on the CPU: every parameter equal bit
     for bit, the loss of a fixed batch within 2e-4;
 22. expert-load telemetry, forecast replacement and replica-topology
     replication on olmoe-1b-7b, in the reference's one-device shadow mode
     (the hooks plan and record, nothing migrates): (a) serve it at full
     width and depth (phase 4's weights, 4 Poisson requests, 4 slots) with
     the replacement hook (check every 4 steps) and the trace recorder,
     once for each policy: reactive, forecast and topology; every request
     finished, no overflow, K1 and K4 16 times a decode step and no plain
     version, one [1, 64] trace row of integers a decode step summing to
     top_k x 16 layers x the rows the step routed, one decision record
     every 4 steps; then the wall time a decode step with every hook on
     against none, in turns; (b) each run's trace saved as .npz and .jsonl
     reads back bit for bit, and a fresh hook fed the trace on the CPU
     makes the card run's decision records, field for field; (c) train it
     at full width and 4 layers through ``launch/train.py``'s ``main`` with
     ``--telemetry-record --trace-out --prewarm --replication`` (4 steps of
     8 × 512 tokens in 2 micro-batches): K4, K1 and K1b 8 times a step,
     finite losses, a [4, 1, 64] trace, and after each pre-warm every
     layer's solver state on the card equal bit for bit to a fresh
     planner's ``warm_start_x(solver="jacobi")`` on the trace; (d) phase
     16 (b)'s 4 × 4 group and counts scheduled through K4 on the
     ``replicated`` placement of (a)'s mean trace row, and on every
     placement a ``TopologyController`` (check every 4, threshold 1.0, a
     migration gate of 0, 2 Monte-Carlo samples) fires on (a)'s rows,
     from that placement and from latin: card equal to the CPU bit for
     bit, cold and warm, the max load beside HiGHS's optimum, the most
     replicas an expert within K4's 32;
 23. MicroEP across a group of ranks: four processes on the one card, a 2 ×
     2 group under gloo (torch.distributed; the card machine has one card,
     and NCCL takes one rank a card), each a rank of the latin placement
     (64 experts, 2 replicas each, 32 slots a rank); K1, K1b and K4 are
     built here (phase 2) before the ranks start, so they load the built
     libraries.  First, on this process alone, the one-device references:
     olmoe-1b-7b's forward at full width and depth on (b)'s 4 × 2048
     tokens (its loss), and one training step at full width and 2 layers
     on (c)'s first batch (its loss); both freed.  Then the ranks
     (``launch/check_group.py``): (a) one MoE layer at olmoe's width, 2048
     tokens a rank: every (pipeline_stages, chunk_comm) in {1, 2, 4} x
     {ppermute, a2a} equal to the monolithic path bit for bit, and to the
     same tokens through the one-device layer bit for bit; every rank's
     flow tensor identical; no overflow at capacity factor 2; K4 once and
     K1 once a chunk a call, no plain version; (b) the forward at full
     width and depth through ``make_forward_fn`` with the runtime, one
     sequence a rank, monolithic and 4 stages: the global loss within
     2e-4 of the one-device forward's and each rank's logits within
     ``LOGITS_REL`` of its rows of the one-device logits (relative to
     their largest), K4 16 and K1 16 × stages a forward on every rank; (d) the sync gathers on one layer's expert tensors
     equal a scatter-add over the placement table (and the table's
     gather), bit for bit.  Then (c) ``launch/train.py``'s ``main`` with
     ``--data-axis 2 --model-axis 2 --backend gloo``, olmoe-1b-7b at full
     width and 2 of 16 layers (f32 master, gradients and moments of all
     16 layers would not fit four ranks on 80 GB), 4 steps of 8 × 512
     tokens in 2 micro-batches, held against the one-device run of the
     same weights, batches and schedule: step 0's CE and loss, every
     step's gradient norm (the dense all-reduce, the label-share weights,
     the canonical sync and the global norm) and steps 1-3's losses (the
     updates) within the limits stated at ``GROUP_STEPS``; every rank's
     metrics equal, finite losses, no overflow, K4, K1 and K1b 16 times
     on every rank and no plain version, the rows holding identical
     canonical experts after every step.  Each rank's peak memory and the
     times are printed; four processes time-slicing one card through host
     memory say nothing of speed.
 24. serving on the group, paid migrations and disaggregated fleets,
     olmoe-1b-7b (``launch/check_group.py``'s ``serve_references`` and
     ``serve_checks``): (c) served disaggregated on this process at full
     width and depth (4 prefill and 4 decode slots, handoff depth 2, 6
     Poisson requests at rate 0.5): every request served once with all its
     tokens, as many handoffs as requests, the buffer within its depth,
     handoff bytes ``decode_slot_bytes`` a transfer, K1 and K4 once a layer
     a fleet step and no plain version; paper-gpt-32x1.3b smoke
     disaggregated on the card and on the CPU from one set of weights:
     equal tokens and step-clock fields.  Then the one-device references
     (a decode step of 8 layers from the caches of 3 earlier steps, and
     (d)'s run at 4 layers), freed, and four ranks sharing the card under
     gloo: (a) the group session (``ServingSession(mesh=...)``, latin, 2
     replicas, capacity factor 4 so that no row of a decode step
     overflows, 8 slots, 2 a rank) at full width and 8 of 16 layers (6.4
     GB canonical, 6.4 GB working and ~1.4 GB dense a rank; 16 layers need
     ~27.7 GB a rank, ~111 GB in all) serving 4 Poisson requests at rate
     0.25 (prompts up to 12 tokens, 16 generated): the one-device step's
     logits from its states within ``SERVE_LOGITS_REL`` of their largest;
     once without and once with the reactive hook set to fire (check every
     12 steps, threshold 1.0): at least one migration paid, the tokens of
     the two runs equal bit for bit, after every migration each rank's
     working slots equal to the new table's canonical experts (row
     digests), ``migrated_bytes`` the fired tables' priced traffic, K4 and
     K1 once a layer a decode step on every rank, no plain version, each
     migration's suspension printed; (d) the disaggregated run of (c)'s
     requests at 4 layers on the group (3.2 GB canonical and 2 × 3.2 GB of
     working slots a rank): tokens and step-clock fields equal to the
     one-device run's; then (b) ``launch/train.py``'s ``main`` as phase 23
     (c) with ``--telemetry-record --trace-out --prewarm --replication``
     (check every 2, threshold 1.0, gate 0): at least one topology
     migration, every rank's trace rows and controller decisions equal,
     identical canonical rows after every step, K1, K1b and K4 16 times a
     rank, the losses and gradient norms within phase 23 (c)'s limits of
     its run without the flags.  The kernels line counts these launches in.
 25. elastic fleets and fault recovery in serving, olmoe-1b-7b
     (``launch/check_fleet.py``): (a) served at full width and depth on one
     device by a fleet of 2-3 groups of one device (64 replica slots each,
     so that the fewest groups, and the survivors of a crash, host all 64
     experts; queue-depth scaling checked every 4 steps, a drain's grace 2
     steps), a crash of the newest group at step 12 and a straggler from
     step 2 for 6 steps, 8 requests at step 0 and 3 from step 60 (prompts
     of 3-6 tokens, 8 generated): at least one admit, drain, crash and
     straggler deflate and restore; every request served once; the tokens
     of the same requests without the fleet, or each differing token a
     near tie; K1 and K4 once a MoE layer a decode step, no plain version;
     the fleet's and the faults' events, step for step, those of the same
     config on the CPU on paper-gpt-32x1.3b smoke (4 slots a device) on a
     fake clock; (b) disaggregated at full size (4 + 4 slots, depth 2)
     with every handoff of steps 1-4 failing: every request generates its
     full count, failures >= 1; (c) inside phase 24's four ranks, the
     fleet of (a) with its faults at 4 layers on the 2 × 2 group: every
     rank's ``fleet`` and ``resilience`` blocks equal to rank 0's, the
     tokens equal to one device's; (d) every placement the controller held
     in (a), with its weights (a draining device's budget zero, a
     straggler's weight deflated), scheduled by K4 on (a)'s recorded loads
     split over the devices: bit for bit the plain version, the weighted
     max load over the weighted LP's optimum; (e) ``reshard_params`` on
     the card on olmoe's expert weights at full width, 4 layers, from one
     held placement to another and back, bit for bit the direct gather,
     and one layer through a checkpoint file and ``restore_resharded``;
     (f) one MoE layer call timed at 256 tokens, written as the planner's
     rows (``build/fleet/moe_layer_rows.json``), and ``launch.fleet plan``
     and ``replay`` on (a)'s trace: the plan equal to ``plan_capacity``'s.
     The kernels line counts (a)-(c)'s launches in.
Phases 17-25 print each part's wall time, peak memory and kernel launches.
The last two lines are the kernels' JSON record and the result object.
"""
from __future__ import annotations

import contextlib
import copy
import csv
import dataclasses
import json
import pathlib
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12         # f32 outside the tensor cores (K1's FMA; K3's
                               # recurrence counted as f32 work, whatever unit)
GOLDEN_ARRIVALS = [(0, 6, 5), (0, 4, 3), (2, 5, 4), (7, 6, 6), (9, 3, 3)]
TEACHER_TOL = 1e-4   # phase 14 (a), a share of the largest magnitude


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


_TALLY: dict = {}    # each wrapper's launches before its last reset


def zero_counts(*wrappers) -> None:
    """Set the launch counts of ``wrappers`` to 0 (just before a main path,
    or after comparison launches), keeping their totals for the phase
    summaries."""
    for fn in wrappers:
        _TALLY[fn] = _TALLY.get(fn, 0) + fn.launches
        fn.launches = 0


def launch_totals() -> dict:
    """Every kernel wrapper's launches since the script began."""
    from repro_torch.kernels.grouped_matmul import (grouped_ffn_cuda,
                                                    grouped_ffn_flat_bwd_cuda,
                                                    grouped_ffn_flat_cuda)
    from repro_torch.kernels.sched import schedule_cuda
    from repro_torch.kernels.wkv6_chunk import (wkv6_bwd_cuda, wkv6_cuda,
                                                wkv6_state_cuda)
    return {name: _TALLY.get(fn, 0) + fn.launches for name, fn in (
        ("K1", grouped_ffn_flat_cuda), ("K1b", grouped_ffn_flat_bwd_cuda),
        ("K2", grouped_ffn_cuda), ("K3", wkv6_cuda), ("K3s", wkv6_state_cuda),
        ("K3b", wkv6_bwd_cuda), ("K4", schedule_cuda))}


@contextlib.contextmanager
def phase_stats(label: str):
    """Print the block's wall time, its peak device memory and the kernel
    launches made in it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = launch_totals()
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in launch_totals().items()}
    print(f"  [{label}] wall {wall:.1f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, kernel "
          f"launches " + ", ".join(f"{k} {v}" for k, v in launched.items()))


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def k_bound(nbytes: float, flops: float):
    """(bound in ms, what bounds it) against the card's data-sheet peaks."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_close(label, out, expect, tol) -> float:
    require(out.shape == expect.shape and out.dtype == expect.dtype,
            f"{label}: output {tuple(out.shape)} {out.dtype}")
    require(bool(torch.isfinite(out.float()).all()),
            f"{label}: non-finite output")
    err = (out.float() - expect.float()).abs()
    require(not bool((err > tol + tol * expect.float().abs()).any()),
            f"{label}: max abs err {err.max().item():.3e} beyond "
            f"rtol=atol={tol}")
    return err.max().item()


# ------------------------------------------------------------ phase 3: K1


def flat_layout(counts, bm: int, n: int, device):
    counts = torch.as_tensor(counts, dtype=torch.int64)
    sizes = (counts + bm - 1) // bm * bm
    start = torch.cumsum(sizes, 0) - sizes
    require(int(sizes.sum()) <= n, "layout does not fit the buffer")
    return start.to(device), (start + counts).to(device)


def check_k1(label, x, start, end, weights, activation, bm, tol) -> float:
    from repro_torch.kernels import ops, ref
    out = ops.grouped_ffn_flat(x, start, end, *weights,
                               activation=activation, bm=bm)
    torch.cuda.synchronize()
    expect = ref.grouped_ffn_flat_ref(x, start, end, *weights,
                                      activation=activation)
    e = check_close(f"K1 {label}", out, expect, tol)
    rows = torch.arange(x.shape[0], device=x.device)[None, :]
    member = ((rows >= start[:, None]) & (rows < end[:, None])).any(0)
    require(bool((out[~member] == 0).all()),
            f"K1 {label}: rows outside every group are not exact zeros")
    print(f"  K1 {label}: max abs err {e:.3e} (tol {tol}), "
          f"{int(member.sum())} rows in groups, zeros exact")
    return e


K1_ACTS = ("swiglu", "geglu", "relu_sq")
K1_DTYPES = (torch.float32, torch.bfloat16)


def k1_decode_case(g, cfg, batch: int, device, label: str) -> dict:
    """K1 at ``cfg``'s decode geometry: the flat buffer the serving path
    builds for one MoE layer of a ``batch``-token step (the E·etp virtual
    experts of moe_d_ff / etp columns under expert tensor parallelism),
    drawn from ``g``; f32 (1e-4: sums H and F long, taken in another
    order) and bf16 (2e-2), three activations, zeros exact.  Then times K1
    and its plain version, f32 swiglu (the served case).  -> its record
    (``launches`` is the caller's)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.grouped_matmul import grouped_ffn_flat_cuda
    from repro_torch.launch.time_k1 import (decode_flat_buffer, expert_shape,
                                            k1_bound, random_weights)
    x, start, end = decode_flat_buffer(g, cfg, batch, device)
    s, h, f = expert_shape(cfg)
    w = random_weights(g, s, h, f, device)
    err = None
    for dt in K1_DTYPES:
        bf = dt == torch.bfloat16
        for act in K1_ACTS:
            e = check_k1(f"{label} {dt} {act}", x.to(dt), start, end,
                         [t.to(dt) for t in w], act, 8, 2e-2 if bf else 1e-4)
            if not bf and act == "swiglu":
                err = e
    k1_ms = cuda_ms(lambda: ops.grouped_ffn_flat(
        x, start, end, *w, activation="swiglu", bm=8), 20)
    plain_ms = cuda_ms(lambda: ref.grouped_ffn_flat_ref(
        x, start, end, *w, activation="swiglu"), 3)
    counts = end - start
    n_active = int((counts > 0).sum())
    bound_ms, bound_by, _, _ = k1_bound(x, start, end, s, h, f, 8)
    print(f"  K1 {label} f32 swiglu: {k1_ms:.4f} ms, plain version "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{n_active} of {s} experts active x 3·H·F f32 (H {h}, F {f}), "
          f"{int(counts.sum())} rows read, N={x.shape[0]} rows written; "
          f"{bound_ms / k1_ms:.1%} reached)")
    zero_counts(grouped_ffn_flat_cuda)     # comparison launches do not count
    return {"name": "grouped_ffn_flat", "route": "cuda",
            "source": "src/repro_torch/csrc/grouped_ffn_flat.cu",
            "replaces": "src/repro/kernels/grouped_matmul.py:118",
            "launches": 0, "max_abs_err": err, "ms": k1_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def phase_k1(cfg, batch: int, device) -> dict:
    from repro_torch.launch.time_k1 import random_weights
    g = torch.Generator(device=device)
    g.manual_seed(1234)

    # (a) the reference kernel test's shapes
    start, end = flat_layout([100, 0, 250], 128, 384, device)
    x = torch.randn((384, 128), generator=g, device=device) * 0.5
    w = random_weights(g, 3, 128, 512, device)
    # (c) ragged H and F
    start_c, end_c = flat_layout([5, 2, 0, 7, 1], 8, 48, device)
    x_c = torch.randn((48, 200), generator=g, device=device) * 0.5
    w_c = random_weights(g, 5, 200, 300, device)
    for dt in K1_DTYPES:
        bf = dt == torch.bfloat16
        for act in K1_ACTS:
            check_k1(f"(a) {dt} {act}", x.to(dt), start, end,
                     [t.to(dt) for t in w], act, 128, 2e-2 if bf else 2e-5)
            check_k1(f"(c) {dt} {act}", x_c.to(dt), start_c, end_c,
                     [t.to(dt) for t in w_c], act, 8, 2e-2 if bf else 2e-5)
    # (b) the olmoe decode geometry, timed
    return k1_decode_case(g, cfg, batch, device, "(b)")


# ------------------------------------------------------- phase 4: serving


def sync_timed(fn, spent: dict, key: str):
    """``fn`` with the wall time of each call, bracketed by device
    synchronisations, added to ``spent[key]``."""
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        spent[key] += time.perf_counter() - t0
        return out
    return wrapper


def step_split(model, cfg, serve_cfg, device) -> dict:
    """Wall time of a full decode step, and within the same steps the time
    of the MoE layers' scheduler calls and K1 calls (each bracketed by
    device synchronisations, so the split is of host-visible wall time)."""
    from repro_torch.core.scheduler import Scheduler
    from repro_torch.kernels import ops
    from repro_torch.models import decoder as dec
    g = torch.Generator(device=device)
    g.manual_seed(7)
    b = serve_cfg.max_batch
    state = dec.init_decode_state(cfg, b, serve_cfg.max_seq, device=device)
    state["solver"] = dec.init_solver_states(cfg, 1, device=device)
    toks = torch.randint(0, cfg.vocab, (b, 1), generator=g, device=device)
    batch = {"tokens": toks, "active": torch.ones(b, dtype=torch.bool,
                                                  device=device)}
    reps = 3

    def steps():
        dec.decode_step(model, state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            dec.decode_step(model, state, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    plain_step_ms = steps()
    spent = {"scheduler": 0.0, "k1": 0.0}
    sched_call, k1_call = Scheduler.__call__, ops.grouped_ffn_flat
    Scheduler.__call__ = sync_timed(sched_call, spent, "scheduler")
    ops.grouped_ffn_flat = sync_timed(k1_call, spent, "k1")
    try:
        step_ms = steps()
    finally:
        Scheduler.__call__, ops.grouped_ffn_flat = sched_call, k1_call
    # the warm-up step inside steps() is timed too: reps + 1 steps
    sched_ms = spent["scheduler"] / (reps + 1) * 1e3
    k1_ms = spent["k1"] / (reps + 1) * 1e3
    rest = step_ms - sched_ms - k1_ms
    n_moe = dec.n_moe_layers(cfg)
    print(f"  decode step {plain_step_ms:.1f} ms; with the split timers "
          f"{step_ms:.1f} ms = scheduler {sched_ms:.1f} ms ({n_moe} "
          f"layers) + K1 {k1_ms:.2f} ms ({n_moe} calls) + rest "
          f"{rest:.1f} ms")
    return {"step_ms": plain_step_ms, "timed_step_ms": step_ms,
            "scheduler_ms": sched_ms, "k1_ms": k1_ms, "rest_ms": rest}


def phase_serve(cfg, serve_cfg, device):
    """-> (K1 launches, K4 launches) of the served run."""
    from repro_torch.core import solver
    from repro_torch.kernels import ref
    from repro_torch.kernels.grouped_matmul import grouped_ffn_flat_cuda
    from repro_torch.kernels.sched import schedule_cuda
    from repro_torch.models import decoder as dec
    from repro_torch.serve import ServingSession, poisson_trace
    t0 = time.perf_counter()
    model = dec.init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_experts} experts top-{cfg.top_k}"
          f"{f' x etp {cfg.etp}' if cfg.etp > 1 else ''}, moe_d_ff "
          f"{cfg.moe_d_ff}, {n_params / 1e9:.3f} B f32 params initialised "
          f"on the card in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated)")
    requests = poisson_trace(4, rate=0.5, vocab=cfg.vocab, prompt_len=8,
                             gen_len=8, seed=1)
    sess = ServingSession(cfg, serve_cfg, device=device, model=model)

    # the plain scheduler, counted: it must not run on the card path
    plain_calls = {"schedule_ref": 0, "water_fill": 0}
    originals = {(ref, "schedule_ref"): ref.schedule_ref,
                 (solver, "water_fill"): solver.water_fill}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            plain_calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for (mod, name), fn in originals.items():
        setattr(mod, name, counted(name, fn))
    try:
        zero_counts(grouped_ffn_flat_cuda)      # just before the main path
        zero_counts(schedule_cuda)
        rep = sess.run(requests)
        launches = grouped_ffn_flat_cuda.launches   # just after it
        k4_launches = schedule_cuda.launches
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    for line in rep.summary().splitlines():
        print("  " + line)
    n_moe = dec.n_moe_layers(cfg)
    expect = (rep.decode_steps + 1) * n_moe     # + the warm-up step
    print(f"  {rep.decode_steps} decode steps + 1 warm-up, K1 launches "
          f"{launches}, K4 launches {k4_launches} (expected {expect} each); "
          f"plain scheduler calls {plain_calls['schedule_ref']}, plain "
          f"water-fills {plain_calls['water_fill']}")
    require(len(rep.records) == len(requests) and rep.rejected == 0,
            f"served {len(rep.records)} of {len(requests)} requests")
    require(all(r.n_generated == q.max_new
                for r, q in zip(rep.records, requests)),
            "a request finished short of its generation budget")
    require(rep.overflow == 0.0, f"overflow {rep.overflow}")
    require(launches == expect,
            f"K1 launched {launches} times, expected {expect}")
    require(k4_launches == expect,
            f"K4 launched {k4_launches} times, expected {expect}")
    require(not any(plain_calls.values()),
            f"the plain scheduler ran on the card path: {plain_calls}")
    print(f"  wall time per decode step in the served run "
          f"{rep.wall_s / rep.decode_steps * 1e3:.1f} ms, "
          f"{rep.gen_tokens} tokens generated")
    step_split(model, cfg, serve_cfg, device)
    del sess, model   # frees the model before the later phases
    return launches, k4_launches


# ------------------------------------------------- phase 5: card vs CPU


def state_to(state: dict, device) -> dict:
    """A decode state (KV caches, solver warm starts) copied to ``device``."""
    def move(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return type(v)(*(move(a) for a in v))
        if isinstance(v, list):
            return [move(a) for a in v]
        return v
    return {k: move(v) for k, v in state.items()}


def phase_parity(cfg, device) -> None:
    """``cfg`` served on the card and on the CPU with identical weights:
    one decode step's logits within 1e-4, then identical tokens per
    request on the golden arrivals.  An MoE config's card run goes through
    K1 and K4; a dense one launches no hand-written kernel."""
    from repro_torch.engine import ServeConfig
    from repro_torch.models import decoder as dec
    from repro_torch.serve import ServingSession, replay_trace
    cpu_model = dec.init_params(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    sc = ServeConfig(max_batch=3, max_seq=24)

    state = dec.init_decode_state(cfg, 3, 24, device="cpu")
    if cfg.moe:
        state["solver"] = dec.init_solver_states(cfg, 1, device="cpu")
    toks = torch.tensor([[5], [77], [301]])
    logits_cpu, _ = dec.decode_step(cpu_model, state, {"tokens": toks})
    logits_gpu, _ = dec.decode_step(gpu_model, state_to(state, device),
                                    {"tokens": toks.to(device)})
    require(logits_gpu.shape == (3, 1, cfg.vocab)
            and bool(torch.isfinite(logits_gpu).all()),
            "card logits are not finite values of shape [3, 1, V]")
    diff = (logits_gpu.cpu() - logits_cpu).abs().max().item()
    print(f"  one decode step: card vs CPU logits max abs diff {diff:.3e}")
    require(diff < 1e-4, f"card and CPU logits differ by {diff:.3e}")

    before = launch_totals()
    reps = {}
    for name, dev, model in (("card", device, gpu_model),
                             ("cpu", "cpu", cpu_model)):
        reqs = replay_trace(GOLDEN_ARRIVALS, vocab=cfg.vocab, seed=11)
        reps[name] = ServingSession(cfg, sc, device=dev,
                                    model=model).run(reqs)
    launched = {k: v - before[k] for k, v in launch_totals().items()}
    if cfg.moe:
        require(launched["K1"] > 0, "the card run did not go through K1")
        require(launched["K4"] > 0, "the card run did not go through K4")
    else:
        require(not any(launched.values()),
                f"a dense decoder launched kernels: {launched}")
    tok_gpu = [r.tokens for r in reps["card"].records]
    tok_cpu = [r.tokens for r in reps["cpu"].records]
    print(f"  {cfg.name}{f' etp {cfg.etp}' if cfg.etp > 1 else ''}: "
          f"{len(tok_gpu)} requests, {sum(map(len, tok_gpu))} tokens on the "
          f"card, identical to the CPU: {tok_gpu == tok_cpu}; card "
          f"launches K1 {launched['K1']}, K4 {launched['K4']}")
    require(tok_gpu == tok_cpu, f"card tokens {tok_gpu} != CPU {tok_cpu}")


# ------------------------------------------------------------ phase 6: K2


def decode_slot_counts(g: torch.Generator, cfg, batch: int, device):
    """Rows per expert slot of one olmoe decode step in the slot layout:
    ``batch`` tokens each routed to ``top_k`` distinct experts."""
    ex = torch.cat([torch.randperm(cfg.num_experts, generator=g,
                                   device=device)[:cfg.top_k]
                    for _ in range(batch)])
    return torch.zeros(cfg.num_experts, dtype=torch.int64,
                       device=device).scatter_add_(0, ex, torch.ones_like(ex))


def phase_k2(cfg, batch: int, device) -> dict:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.grouped_matmul import grouped_ffn_cuda
    from repro_torch.launch.time_k1 import random_weights
    g = torch.Generator(device=device)
    g.manual_seed(4321)
    cases = []
    # (a) the reference kernel test's shapes, counts drawn in [0, C]
    for s, c, h, f in ((1, 128, 128, 512), (2, 256, 128, 512),
                       (4, 128, 256, 1024), (3, 384, 128, 512)):
        counts = torch.randint(0, c + 1, (s,), generator=g, device=device)
        cases.append((f"(a) S{s} C{c} H{h} F{f}", s, c, h, f, counts, 128))
    # (z) zero-count slots
    cases.append(("(z) counts [0, 64, 0]", 3, 128, 128, 512,
                  torch.tensor([0, 64, 0], device=device), 128))
    # (d) the olmoe decode geometry in the slot layout
    cnt_d = decode_slot_counts(g, cfg, batch, device)
    s_d, c_d, h_d, f_d = cfg.num_experts, 8, cfg.d_model, cfg.moe_d_ff
    cases.append((f"(d) olmoe decode S{s_d} C{c_d}", s_d, c_d, h_d, f_d,
                  cnt_d, 8))

    err_d, x_d, w_d = None, None, None
    for label, s, c, h, f, counts, bm in cases:
        x = torch.randn((s, c, h), generator=g, device=device) * 0.5
        w = random_weights(g, s, h, f, device)
        valid = torch.arange(c, device=device)[None, :] < counts[:, None]
        for dt in (torch.float32, torch.bfloat16):
            bf = dt == torch.bfloat16
            xt, wt = x.to(dt), [t.to(dt) for t in w]
            for act in ("swiglu", "geglu", "relu_sq"):
                out = ops.grouped_ffn(xt, counts, *wt, activation=act, bm=bm)
                torch.cuda.synchronize()
                expect = ref.grouped_ffn_ref(xt, counts, *wt, activation=act)
                e = check_close(f"K2 {label} {dt} {act}", out, expect,
                                2e-2 if bf else 2e-5)
                require(bool((out[~valid] == 0).all()),
                        f"K2 {label} {dt} {act}: rows past the counts are "
                        f"not exact zeros")
                if label.startswith("(d)") and not bf and act == "swiglu":
                    err_d, x_d, w_d = e, xt, wt
        shown = counts.tolist() if s <= 4 else f"{int(counts.sum())} rows"
        print(f"  K2 {label}: counts {shown}, f32/bf16 x 3 activations "
              f"within tolerance, zeros exact")

    # K2's path: its entry point (no model reaches it), in the timed run
    zero_counts(grouped_ffn_cuda)
    k2_ms = cuda_ms(lambda: ops.grouped_ffn(x_d, cnt_d, *w_d, bm=8), 20)
    launches = grouped_ffn_cuda.launches
    require(launches == 21, f"K2 launched {launches} times in its timed "
                            f"run of 21 calls")
    plain_ms = cuda_ms(lambda: ref.grouped_ffn_ref(x_d, cnt_d, *w_d), 3)
    rows, n_active = int(cnt_d.sum()), int((cnt_d > 0).sum())
    isz = x_d.element_size()
    # the valid rows of x read once, every row of out written once, each
    # active slot's three matrices read once, the counts
    nbytes = (rows * h_d * isz + s_d * c_d * h_d * isz
              + n_active * 3 * h_d * f_d * isz
              + s_d * cnt_d.element_size())
    bound_ms, bound_by = k_bound(nbytes, 2 * 3 * rows * h_d * f_d)
    print(f"  K2 (d) f32 swiglu: {k2_ms:.4f} ms, plain version "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{n_active} active slots x 3·H·F f32, {rows} rows read, "
          f"S·C={s_d * c_d} rows written); {launches} launches through "
          f"ops.grouped_ffn")
    return {"name": "grouped_ffn", "route": "cuda",
            "source": "src/repro_torch/csrc/grouped_ffn_flat.cu",
            "replaces": "src/repro/kernels/grouped_matmul.py:163",
            "launches": launches, "max_abs_err": err_d, "ms": k2_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


# ------------------------------------------------------------ phase 7: K3


def phase_k3(fwd_geom, device) -> dict:
    """``fwd_geom``: K3's (BH, T, D) in the forward of phase 8."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.wkv6_chunk import wkv6_cuda
    from repro_torch.launch.time_k3 import k3_bound, unaligned
    g = torch.Generator(device=device)
    g.manual_seed(99)
    errs_f, inputs_f = [], None
    for bh, t, d, model_decay in ((2, 128, 64, False), (1, 256, 128, False),
                                  (4, 128, 128, False), (1, 100, 64, False),
                                  (3, 1, 64, False), (3, 15, 64, False),
                                  (3, 17, 128, False), (3, 37, 40, False),
                                  (*fwd_geom, False), (*fwd_geom, True)):
        x = ref.wkv6_inputs(g, bh, t, d, device, model_decay)
        errs, used = [], []
        for dt in (torch.float32, torch.bfloat16):
            xt = [a.to(dt) for a in x]
            out = ops.wkv6(*xt)
            torch.cuda.synchronize()
            require(not bool(torch.isnan(out).any()),
                    f"K3 ({bh}, {t}, {d}) {dt}: NaN in the output")
            expect = ref.wkv6_chunk_ref(*xt[:3], torch.exp(xt[3].float()),
                                        xt[4])[0]
            tol = 5e-2 if dt == torch.bfloat16 else 1e-4
            errs.append(check_close(f"K3 ({bh}, {t}, {d}) {dt}", out, expect,
                                    tol))
            # the largest share of the allowance atol + rtol·|ref| used
            used.append(((out.float() - expect.float()).abs()
                         / (tol + tol * expect.float().abs())).max().item())
            if (t, d) in ((100, 64), (37, 40)):
                # the kernel stages unaligned tensors with narrower copies
                moved = ops.wkv6(*(unaligned(a) for a in xt))
                require(torch.equal(moved, out),
                        f"K3 ({bh}, {t}, {d}) {dt}: unaligned tensors give "
                        f"another result")
        if (bh, t, d) == fwd_geom:
            errs_f.append(errs[0])
            if model_decay:             # timed on the forward's own decays
                inputs_f = x
        print(f"  K3 (BH {bh}, T {t}, D {d}"
              f"{', model decays' if model_decay else ''}): max abs err f32 "
              f"{errs[0]:.3e} (rtol = atol = 1e-4; {used[0]:.1%} of the "
              f"allowance used), bf16 {errs[1]:.3e} (rtol = atol = 5e-2; "
              f"{used[1]:.1%}), no NaN"
              f"{'; unaligned tensors: the same output' if (t, d) in ((100, 64), (37, 40)) else ''}")

    k3_ms = cuda_ms(lambda: ops.wkv6(*inputs_f), 20)
    q, k, v, lw, u = inputs_f
    plain_ms = cuda_ms(lambda: ref.wkv6_chunk_ref(q, k, v, torch.exp(lw), u),
                       2)
    bound_ms, bound_by, nbytes, flops = k3_bound(*fwd_geom,
                                                 q.element_size())
    print(f"  K3 {fwd_geom} f32, rwkv6-7b's decays: {k3_ms:.4f} ms, plain version "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{nbytes / 1e6:.0f} MB moved, {flops / 1e9:.2f} GFLOP)")
    zero_counts(wkv6_cuda)     # comparison launches do not count
    return {"name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6_chunk.py:93",
            "launches": 0, "max_abs_err": max(errs_f), "ms": k3_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def phase_k3s(device) -> dict:
    """K3s against its plain version (``time_k3.check_state``); its record
    at the decode geometry of phase 14."""
    from repro_torch.launch import time_k3
    try:
        r = time_k3.check_state(device)
    except AssertionError as exc:
        raise SmokeFailure(str(exc)) from exc
    for line in time_k3.describe_state(r).splitlines():
        print("  " + line)
    m = r["decode"]
    bound_ms, bound_by = m["bound"][:2]
    return {"name": "wkv6_state", "route": "cuda",
            "source": "src/repro_torch/csrc/wkv6.cu",
            "replaces": "src/repro/models/layers/rwkv6.py:108",
            "launches": 0, "max_abs_err": r["err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


# ---------------------------------------------- phase 8: rwkv6-7b forward


def phase_forward(cfg, batch: int, seq: int, device) -> int:
    from repro_torch.kernels.wkv6_chunk import wkv6_cuda
    from repro_torch.launch.runtime import make_forward_fn
    from repro_torch.models import decoder as dec
    t0 = time.perf_counter()
    model = dec.init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads x {cfg.d_model // cfg.num_heads}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {n_params / 1e9:.3f} B f32 params "
          f"initialised on the card in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated)")
    g = torch.Generator(device=device)
    g.manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=g,
                           device=device)
    labels = torch.cat([tokens[:, 1:], torch.full((batch, 1), -1,
                                                  device=device)], dim=1)
    prefill = make_forward_fn(model, last_only=True)
    evaluate = make_forward_fn(model, last_only=False)
    prefill({"tokens": tokens})                 # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 2

    zero_counts(wkv6_cuda)                      # just before the main path
    t0 = time.perf_counter()
    for _ in range(reps):
        last = prefill({"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) / reps * 1e3
    t0 = time.perf_counter()
    logits = evaluate({"tokens": tokens})
    loss = dec.lm_loss(logits, labels)
    loss_v = loss.item()
    eval_ms = (time.perf_counter() - t0) * 1e3
    launches = wkv6_cuda.launches               # just after it
    peak = torch.cuda.max_memory_allocated()

    v = cfg.vocab
    require(last.shape == (batch, 1, v) and bool(torch.isfinite(last).all()),
            f"prefill logits {tuple(last.shape)} are not finite [B, 1, V]")
    require(logits.shape == (batch, seq, v)
            and bool(torch.isfinite(logits).all()),
            f"evaluation logits {tuple(logits.shape)} are not finite "
            f"[B, T, V]")
    gap = (logits[:, -1:] - last).abs().max().item()
    scale = max(1.0, last.abs().max().item())
    require(gap <= 1e-4 * scale, f"last-position logits of the two "
                                 f"forwards differ by {gap:.3e}")
    require(torch.isfinite(loss).item(), f"evaluation loss {loss_v}")
    expect = cfg.num_layers * (reps + 1)
    require(launches == expect,
            f"K3 launched {launches} times, expected {expect}")
    print(f"  prefill (last_only) of {batch} x {seq} tokens: "
          f"{prefill_ms:.1f} ms per forward ({reps} forwards after a "
          f"warm-up); evaluation forward + lm_loss: {eval_ms:.1f} ms, loss "
          f"{loss_v:.4f} (ln V = {torch.log(torch.tensor(float(v))):.4f})")
    print(f"  K3 launches {launches} over {reps + 1} forwards "
          f"({launches // (reps + 1)} per forward, expected "
          f"{cfg.num_layers}); last-position logits agree to {gap:.2e}; "
          f"peak memory {peak / 2**30:.2f} GiB")
    del model, logits, last
    return launches


# ----------------------------------------- phase 9: forward, card vs CPU


def phase_forward_parity(cfg, device) -> None:
    from repro_torch.kernels.wkv6_chunk import wkv6_cuda
    from repro_torch.launch.runtime import make_forward_fn
    from repro_torch.models import decoder as dec
    cpu_model = dec.init_params(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    g = torch.Generator()
    g.manual_seed(8)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=g)
    before = wkv6_cuda.launches
    got = make_forward_fn(gpu_model, last_only=False)({"tokens": tokens})
    torch.cuda.synchronize()
    require(wkv6_cuda.launches - before == cfg.num_layers,
            "the card forward did not run K3 once per layer")
    expect = make_forward_fn(cpu_model, last_only=False, device="cpu")(
        {"tokens": tokens})
    require(got.shape == (2, 64, cfg.vocab)
            and bool(torch.isfinite(got).all()),
            "card logits are not finite values of shape [2, 64, V]")
    diff = (got.cpu() - expect).abs().max().item()
    print(f"  {cfg.name}: card vs CPU logits over 2 x 64 tokens, max abs "
          f"diff {diff:.3e}")
    require(diff < 1e-4, f"card and CPU logits differ by {diff:.3e}")


# -------------------------------------------- phase 16: the scheduler core


def phase_sched_core() -> None:
    from repro_torch.kernels.sched import schedule_cuda
    from repro_torch.launch import time_k4
    zero_counts(schedule_cuda)
    try:
        time_k4.scheduler_core()
    except AssertionError as exc:
        raise SmokeFailure(str(exc)) from exc
    require(schedule_cuda.launches > 0, "K4 did not run in phase 16")
    print(f"  K4 launched {schedule_cuda.launches} times in the phase")


# ------------------------------------------------------------ phase 10: K4


def phase_k4(device) -> dict:
    from repro_torch.kernels.sched import schedule_cuda
    from repro_torch.launch import time_k4
    got = {}
    for name in time_k4.CASES:
        try:
            got[name] = time_k4.measure(
                name, device, timed=name in ("olmoe-decode", "paper-g16"))
        except AssertionError as exc:
            raise SmokeFailure(str(exc)) from exc
        print("  " + time_k4.describe(name, got[name]))
    zero_counts(schedule_cuda)     # comparison launches do not count
    m = got["olmoe-decode"]        # the served path's geometry
    bound_ms, bound_by, _, _ = m["bound"]
    return {"name": "microep_schedule", "route": "cuda",
            "source": "src/repro_torch/csrc/microep_sched.cu",
            "replaces": "src/repro/core/solver_jax.py:231",
            "launches": 0, "max_abs_err": max(g["err"] for g in got.values()),
            "ms": m["k4"], "plain_ms": m["plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


# ----------------------------------------------------------- phase 11: K1b


K1B_CASES = ((8, [3, 0, 9, 1, 0, 4], 200, 300), (8, [1, 1, 0, 1], 64, 30),
             (128, [100, 0, 250], 128, 512), (8, [5, 2, 0, 7, 1], 199, 301))


def phase_k1b(device):
    """-> ``training_geometry`` at olmoe-1b-7b's."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.grouped_matmul import grouped_ffn_flat_bwd_cuda
    from repro_torch.launch.time_k1 import random_weights
    g = torch.Generator(device=device)
    g.manual_seed(2468)
    for bm, counts, h, f in K1B_CASES:
        n = sum(-(-c // bm) * bm for c in counts) + bm
        start, end = flat_layout(counts, bm, n, device)
        x = torch.randn((n, h), generator=g, device=device) * 0.5
        w = random_weights(g, len(counts), h, f, device)
        dout = torch.randn((n, h), generator=g, device=device)
        rows = torch.arange(n, device=device)[None, :]
        member = ((rows >= start[:, None]) & (rows < end[:, None])).any(0)
        errs = []
        for act in ("swiglu", "geglu", "relu_sq"):
            got = grouped_ffn_flat_bwd_cuda(x, start.int(), end.int(), *w,
                                            dout, act)
            torch.cuda.synchronize()
            expect = ref.grouped_ffn_flat_bwd_ref(x, start, end, *w, dout,
                                                  act)
            errs += [check_close(f"K1b bm {bm} {counts} H {h} F {f} {act} "
                                 f"{name}", a, b, 2e-5)
                     for name, a, b in zip(("dx", "dWg", "dWu", "dWd"),
                                           got, expect)]
            require(bool((got[0][~member] == 0).all()),
                    f"K1b {counts} {act}: dx outside every group is not zero")
        print(f"  K1b bm {bm}, counts {counts}, H {h}, F {f}: dx, dWg, dWu, "
              f"dWd x 3 activations, max abs err {max(errs):.3e} (tol "
              f"2e-5), dx zero outside the groups")
    return training_geometry(device, "olmoe-1b-7b")


def training_geometry(device, arch: str):
    """``launch/time_k1b.py``'s checks and times of K1 and K1b at
    ``arch``'s training geometry.  -> (K1's record, K1b's record,
    ``time_k1b.measure``'s result); the records' launches are the
    caller's."""
    from repro_torch.kernels.grouped_matmul import (grouped_ffn_flat_bwd_cuda,
                                                    grouped_ffn_flat_cuda)
    from repro_torch.launch import time_k1b
    try:
        r = time_k1b.measure(device, arch=arch)
    except AssertionError as exc:
        raise SmokeFailure(str(exc)) from exc
    for line in time_k1b.describe(r).splitlines():
        print("  " + line)
    zero_counts(grouped_ffn_flat_cuda)      # comparison launches do not count
    zero_counts(grouped_ffn_flat_bwd_cuda)
    k1_ms, k1_by = r["k1_bound"][:2]
    k1b_ms, k1b_by = r["k1b_bound"][:2]
    k1 = {"name": f"grouped_ffn_flat ({arch} training)", "route": "cuda",
          "source": "src/repro_torch/csrc/grouped_ffn_flat.cu",
          "replaces": "src/repro/kernels/grouped_matmul.py:118",
          "launches": 0, "max_abs_err": r["k1_err"], "ms": r["k1_ms"],
          "plain_ms": r["k1_plain_ms"], "bound_ms": k1_ms,
          "bound_by": k1_by, "library_ms": None}
    k1b = {"name": "grouped_ffn_flat_bwd", "route": "cuda",
           "source": "src/repro_torch/csrc/grouped_ffn_flat_bwd.cu",
           "replaces": "src/repro/kernels/ref.py:47",
           "launches": 0, "max_abs_err": r["k1b_err"], "ms": r["k1b_ms"],
           "plain_ms": r["k1b_plain_ms"], "bound_ms": k1b_ms,
           "bound_by": k1b_by, "library_ms": None}
    return k1, k1b, r


# ---------------------------------------------- phase 12: olmoe training


def train_split(ts, step, batch) -> dict:
    """Wall time of one train step, and within it the time of the K1
    calls, the K1b calls, the scheduler calls, the K3 calls, the K3b calls
    and AdamW, each bracketed by device synchronisations."""
    from repro_torch.core.scheduler import Scheduler
    from repro_torch.kernels import grouped_matmul, ops, wkv6_chunk
    from repro_torch.train import loop
    spent = dict.fromkeys(("k1", "k1b", "scheduler", "k3", "k3b", "adamw"),
                          0.0)
    patches = [(ops, "grouped_ffn_flat", "k1"),
               (grouped_matmul.GroupedFFNFlat, "backward", "k1b"),
               (Scheduler, "__call__", "scheduler"),
               (ops, "wkv6", "k3"),
               (wkv6_chunk.WKV6, "backward", "k3b"),
               (loop, "adamw_update", "adamw")]
    originals = [obj.__dict__[name] for obj, name, _ in patches]
    for (obj, name, key), fn in zip(patches, originals):
        timed = (staticmethod(sync_timed(fn.__func__, spent, key))
                 if isinstance(fn, staticmethod)
                 else sync_timed(fn, spent, key))
        setattr(obj, name, timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, m = step(ts, batch)
        float(m["loss"])
        total = time.perf_counter() - t0
    finally:
        for (obj, name, _), fn in zip(patches, originals):
            setattr(obj, name, fn)
    out = {k: v * 1e3 for k, v in spent.items()}
    out["step"] = total * 1e3
    out["rest"] = out["step"] - sum(spent.values()) * 1e3
    return out


def phase_train(cfg, device, steps: int, k1_train: dict = None,
                remat_step: bool = False) -> dict:
    """Train ``cfg`` (depth cut by the caller where it must be) for
    ``steps`` steps of 8 × 512 synthetic tokens in 2 micro-batches: finite
    losses and gradient norms, no overflow, K1, K1b and K4 each launched
    once a MoE layer a micro-batch, K3 and K3b once an RWKV-6 layer a
    micro-batch (none for a dense decoder) and no plain version; the step
    time, tokens/s and peak memory, then (MoE or RWKV-6) one more step split
    by synchronised timers, and with ``remat_step`` one more step with
    every block rematerialised: its time, peak memory and launches.  -> the
    run's kernel launches (the steps before the split)."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels.grouped_matmul import (grouped_ffn_flat_bwd_cuda,
                                                    grouped_ffn_flat_cuda)
    from repro_torch.kernels.sched import schedule_cuda
    from repro_torch.kernels.wkv6_chunk import wkv6_bwd_cuda, wkv6_cuda
    from repro_torch.launch.check_train import (count_plain_calls,
                                                expected_launches,
                                                kernel_launches)
    from repro_torch.models import decoder as dec
    from repro_torch.train.loop import init_train_state, make_train_step
    batch, seq, n_micro = 8, 512, 2
    n_moe = dec.n_moe_layers(cfg)
    rwkv = tuple(cfg.pattern) == ("rwkv",)
    t0 = time.perf_counter()
    ts = init_train_state(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in ts.model.parameters())
    ffn = (f"{cfg.num_experts} experts top-{cfg.top_k}"
           f"{f' x etp {cfg.etp}' if cfg.etp > 1 else ''}, moe_d_ff "
           f"{cfg.moe_d_ff}" if cfg.moe else
           f"RWKV-6 time and channel mix, d_ff {cfg.d_ff}" if rwkv else
           f"dense {cfg.ffn_kind} d_ff {cfg.d_ff}")
    print(f"  {cfg.name}, {cfg.num_layers} layers: d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads x {cfg.head_dim} "
          f"({cfg.num_kv_heads} KV), {ffn}, vocab {cfg.vocab}, "
          f"{'tied embeddings' if cfg.tie_embeddings else 'untied head'}; "
          f"{n_params / 1e9:.3f} B f32 params, master + 2 Adam moments "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB, initialised on "
          f"the card in {time.perf_counter() - t0:.1f} s")
    step = make_train_step(cfg, n_micro=n_micro, device=device)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, batch=batch, seed=1)
    torch.cuda.reset_peak_memory_stats()
    times, rows = [], []
    zero_counts(grouped_ffn_flat_cuda)          # just before the main path
    zero_counts(grouped_ffn_flat_bwd_cuda)
    zero_counts(schedule_cuda)
    zero_counts(wkv6_cuda)
    zero_counts(wkv6_bwd_cuda)
    with count_plain_calls() as plain:
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, m = step(ts, data.batch_at(i))
            vals = {k: float(v) for k, v in m.items()}
            times.append((time.perf_counter() - t0) * 1e3)
            rows.append(vals)
            print(f"  step {i}: loss {vals['loss']:.4f} (ce "
                  f"{vals['ce_loss']:.4f}), grad norm "
                  f"{vals['grad_norm']:.4f}, balance {vals['balance']:.4f}, "
                  f"overflow {vals['overflow']:.0f}, {times[-1]:.1f} ms")
    launches = kernel_launches()                # just after it
    peak = torch.cuda.max_memory_allocated()
    expect = expected_launches(cfg, n_micro, steps)
    require(all(torch.isfinite(torch.tensor([r["loss"], r["grad_norm"]]))
                .all() for r in rows), "a loss or gradient norm is not finite")
    require(all(r["overflow"] == 0 for r in rows), "capacity overflow")
    require(launches == expect,
            f"launches {launches}, expected {expect}")
    require(not any(plain.values()),
            f"a plain version ran on the card path: {plain}")
    steady = times[1:]
    step_ms = sum(steady) / len(steady)
    tokens = batch * seq
    layers = (f"{cfg.num_layers} RWKV-6 layers" if rwkv
              else f"{n_moe} MoE layers")
    print(f"  launches over {steps} steps: {launches} (a step: "
          f"{ {k: v // steps for k, v in launches.items()} }, {layers} x "
          f"{n_micro} micro-batches); plain calls {plain}")
    print(f"  step time {step_ms:.1f} ms (mean of steps 1-{steps - 1}; step "
          f"0 {times[0]:.1f} ms), {tokens / step_ms * 1e3:.0f} tokens/s, "
          f"loss {rows[-1]['loss']:.4f}, grad norm {rows[-1]['grad_norm']:.4f},"
          f" peak memory {peak / 2**30:.2f} GiB")
    if k1_train is not None:
        print(f"  K1 at the training geometry (phase 11): "
              f"{k1_train['k1_ms']:.4f} ms a call against "
              f"{k1_train['k1_bound'][0]:.4f} ms; K1b "
              f"{k1_train['k1b_ms']:.4f} ms against "
              f"{k1_train['k1b_bound'][0]:.4f} ms")
    if n_moe:
        sp = train_split(ts, step, data.batch_at(steps))
        print(f"  one more step with the split timers: {sp['step']:.1f} ms "
              f"= K1 {sp['k1']:.1f} ms + K1b {sp['k1b']:.1f} ms + scheduler "
              f"{sp['scheduler']:.1f} ms ({n_moe * n_micro} calls each) + "
              f"AdamW {sp['adamw']:.1f} ms + rest {sp['rest']:.1f} ms")
    elif rwkv:
        sp = train_split(ts, step, data.batch_at(steps))
        print(f"  one more step with the split timers: {sp['step']:.1f} ms "
              f"= K3 {sp['k3']:.1f} ms + K3b {sp['k3b']:.1f} ms "
              f"({cfg.num_layers * n_micro} calls each) + AdamW "
              f"{sp['adamw']:.1f} ms + rest {sp['rest']:.1f} ms (the "
              f"matrix products, norms and the loss)")
    else:
        print("  a dense decoder: no hand-written kernel on this path (f32 "
              "cuBLAS products, attention and AdamW in plain PyTorch)")
    if remat_step:
        step = make_train_step(cfg, n_micro=n_micro, device=device,
                               remat=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = kernel_launches()
        t0 = time.perf_counter()
        ts, m = step(ts, data.batch_at(steps + 1))
        loss = float(m["loss"])
        remat_ms = (time.perf_counter() - t0) * 1e3
        launched = {k: v - before[k] for k, v in kernel_launches().items()}
        want = expected_launches(cfg, n_micro, remat=True)
        require(launched == want and bool(torch.isfinite(m["grad_norm"])),
                f"the remat step launched {launched}, expected {want}; "
                f"grad norm {float(m['grad_norm'])}")
        print(f"  one more step with every block rematerialised: "
              f"{remat_ms:.1f} ms, loss {loss:.4f}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (without "
              f"remat {peak / 2**30:.2f} GiB); launches {launched}")
    del ts, step
    return launches


# ---------------------------------------- phase 13: training, card vs CPU


def phase_train_parity(device, cases) -> None:
    """One train step of each (name, etp) smoke case, card vs CPU
    (``launch/check_train.py``)."""
    from repro_torch.launch import check_train
    for name, etp in cases:
        try:
            r = check_train.card_vs_cpu(name, device, etp=etp)
        except AssertionError as exc:
            raise SmokeFailure(str(exc)) from exc
        print("  " + check_train.describe(name, r, etp))


# -------------------------------------------- phase 14: serve rwkv6-7b


def rwkv_step_split(model, cfg, batch: int, device) -> dict:
    """The decode step's wall time over 10 steps at ``batch`` slots (mean,
    range), then one more step split by synchronised timers into K3s
    calls, matrix products (every ``@``) and the rest, then one more under
    the profiler: device time by part and the device's idle share."""
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_forward import MATMUL_MARKS, profile_device
    from repro_torch.models import decoder as dec
    g = torch.Generator(device=device)
    g.manual_seed(9)
    state = dec.init_decode_state(cfg, batch, 1, device=device)
    toks = torch.randint(0, cfg.vocab, (batch, 1), generator=g, device=device)
    _, state = dec.decode_step(model, state, {"tokens": toks})
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state = dec.decode_step(model, state, {"tokens": toks})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    spent = {"k3s": 0.0, "matmul": 0.0}
    wkv6, matmul = ops.wkv6, torch.Tensor.__matmul__
    own = torch.Tensor.__dict__.get("__matmul__")   # None: inherited
    ops.wkv6 = sync_timed(wkv6, spent, "k3s")
    torch.Tensor.__matmul__ = sync_timed(matmul, spent, "matmul")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec.decode_step(model, state, {"tokens": toks})
        torch.cuda.synchronize()
        step = (time.perf_counter() - t0) * 1e3
    finally:
        ops.wkv6 = wkv6
        if own is None:
            del torch.Tensor.__matmul__
        else:
            torch.Tensor.__matmul__ = own
    k3s, mm = spent["k3s"] * 1e3, spent["matmul"] * 1e3

    def run():
        dec.decode_step(model, state, {"tokens": toks})
        torch.cuda.synchronize()

    def part_of(kernel: str) -> str:
        if "wkv6_step_kernel" in kernel:
            return "K3s"
        if any(m in kernel.lower() for m in MATMUL_MARKS):
            return "matrix products"
        return "rest"

    profiled = profile_device(run, part_of)[0]
    return {"mean": sum(times) / len(times), "min": min(times),
            "max": max(times), "timed_step": step, "k3s": k3s, "matmul": mm,
            "rest": step - k3s - mm, "profiled": profiled}


def phase_rwkv_serve(cfg, serve_cfg, device) -> int:
    """-> K3s launches of the served run."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.wkv6_chunk import wkv6_cuda, wkv6_state_cuda
    from repro_torch.launch.runtime import make_forward_fn
    from repro_torch.models import decoder as dec
    from repro_torch.serve import ServingSession, poisson_trace
    t0 = time.perf_counter()
    model = dec.init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads x {cfg.d_model // cfg.num_heads}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {n_params / 1e9:.3f} B f32 params "
          f"initialised on the card in {time.perf_counter() - t0:.1f} s")

    # (a) teacher forcing against make_forward_fn's logits
    g = torch.Generator(device=device)
    g.manual_seed(6)
    b, t = 2, 64
    tokens = torch.randint(0, cfg.vocab, (b, t), generator=g, device=device)
    forward = make_forward_fn(model, last_only=False)
    seen = []                                  # each block's input and output
    hooks = [blk.register_forward_hook(
        lambda _, args, out: seen.append((args[0], out)))
        for blk in model.blocks]
    try:
        expect = forward({"tokens": tokens})
    finally:
        for h in hooks:
            h.remove()
    scale = expect.abs().max().item()

    def share(logits):
        return (logits - expect).abs().max().item() / scale

    def head(x):
        w_out = model.head if model.head is not None else model.embed.T
        return model.final_norm(x) @ w_out

    # every layer decodes its own forward input one token a step from a
    # zero state (K3s against K3 with each layer's real input); the last
    # layer's decoded output goes through the head
    states = dec.init_decode_state(cfg, b, t, device=device)["rwkv"]
    layer_share = []
    for blk, st, (inp, out) in zip(model.blocks, states, seen):
        ys = []
        for i in range(t):
            y, st = blk.decode(inp[:, i:i + 1], st)
            ys.append(y)
        y = torch.cat(ys, 1)
        layer_share.append((y - out).abs().max().item()
                           / out.abs().max().item())
    tf_share = share(head(y))
    # free running: decode_step over the whole model, and the forward with
    # its first block's input perturbed by 1e-7 of its largest magnitude
    state = dec.init_decode_state(cfg, b, t, device=device)
    outs = []
    for i in range(t):
        logits, state = dec.decode_step(model, state,
                                        {"tokens": tokens[:, i:i + 1]})
        outs.append(logits[:, 0])
    got = torch.stack(outs, 1)
    require(got.shape == expect.shape and bool(torch.isfinite(got).all()),
            f"decode logits {tuple(got.shape)} are not finite [B, T, V]")
    x0 = seen[0][0]
    noise = torch.randn(x0.shape, generator=g, device=device) \
        * 1e-7 * x0.abs().max()
    hook = model.blocks[0].register_forward_pre_hook(
        lambda _, args: (args[0] + noise,))
    try:
        perturbed = forward({"tokens": tokens})
    finally:
        hook.remove()
    worst = max(range(len(layer_share)), key=layer_share.__getitem__)
    print(f"  (a) teacher forcing, {b} x {t} tokens one a step, each layer "
          f"from its forward input: largest share of a layer's output "
          f"magnitude {layer_share[worst]:.2e} (layer {worst}); logits from "
          f"the last layer's decode {tf_share:.2e} of the largest logit "
          f"magnitude {scale:.3f} (tolerance {TEACHER_TOL:.0e} each)")
    print(f"  free-running decode_step over all {cfg.num_layers} layers: "
          f"{share(got):.2e} of it; the forward with its input perturbed by "
          f"1e-7: {share(perturbed):.2e} (these random weights amplify f32 "
          f"rounding across the layers; not a check)")
    require(max(layer_share) <= TEACHER_TOL and tf_share <= TEACHER_TOL,
            f"decode and forward differ: layer {worst} by "
            f"{layer_share[worst]:.2e}, logits by {tf_share:.2e} of the "
            f"largest magnitude")
    del expect, got, outs, state, seen, perturbed

    # (b, c) serving, the kernels counted
    requests = poisson_trace(4, rate=0.5, vocab=cfg.vocab, prompt_len=32,
                             gen_len=(32, 32), seed=1)
    sess = ServingSession(cfg, serve_cfg, device=device, model=model)
    plain_calls = [0]
    plain = ref.wkv6_chunk_ref

    def counted(*args, **kwargs):
        plain_calls[0] += 1
        return plain(*args, **kwargs)

    ref.wkv6_chunk_ref = counted
    torch.cuda.reset_peak_memory_stats()
    try:
        zero_counts(wkv6_cuda)                  # just before the main path
        zero_counts(wkv6_state_cuda)
        rep = sess.run(requests)
        launches = wkv6_state_cuda.launches     # just after it
        k3_launches = wkv6_cuda.launches
    finally:
        ref.wkv6_chunk_ref = plain
    peak = torch.cuda.max_memory_allocated()
    for line in rep.summary().splitlines():
        print("  " + line)
    expect_n = (rep.decode_steps + 1) * cfg.num_layers   # + the warm-up step
    print(f"  (c) {rep.decode_steps} decode steps + 1 warm-up: K3s launches "
          f"{launches} (expected {expect_n}), K3 launches {k3_launches}, "
          f"plain recurrence calls {plain_calls[0]}")
    require(len(rep.records) == len(requests) and rep.rejected == 0,
            f"served {len(rep.records)} of {len(requests)} requests")
    require(all(r.n_generated == q.max_new
                for r, q in zip(rep.records, requests)),
            "a request finished short of its generation budget")
    require(rep.mean_balance is None and rep.overflow == 0.0,
            f"balance {rep.mean_balance}, overflow {rep.overflow}")
    require(launches == expect_n,
            f"K3s launched {launches} times, expected {expect_n}")
    require(k3_launches == 0 and plain_calls[0] == 0,
            f"K3 ({k3_launches}) or the plain recurrence ({plain_calls[0]}) "
            f"ran on the decode path")

    # (d) timing and split
    sp = rwkv_step_split(model, cfg, serve_cfg.max_batch, device)
    b = serve_cfg.max_batch
    print(f"  (d) decode step at {b} slots: {sp['mean']:.2f} ms (mean of 10; "
          f"{sp['min']:.2f}-{sp['max']:.2f} ms), {b / sp['mean'] * 1e3:.1f} "
          f"tokens/s with every slot decoding; served run "
          f"{rep.gen_tokens / rep.wall_s:.1f} generated tokens/s over "
          f"{rep.wall_s:.2f} s; peak memory {peak / 2**30:.2f} GiB")
    print(f"  one more step with the split timers: {sp['timed_step']:.2f} ms "
          f"= K3s {sp['k3s']:.2f} ms ({cfg.num_layers} calls) + matrix "
          f"products {sp['matmul']:.2f} ms + rest {sp['rest']:.2f} ms")
    pr = sp["profiled"]
    print(f"  one more step under the profiler: window "
          f"{pr['window_ms']:.3f} ms, device time {pr['device_ms']:.3f} ms in "
          f"{pr['kernel_launches']} kernels (" + ", ".join(
              f"{k} {v:.3f} ms" for k, v in pr["parts_ms"].items())
          + f"), idle share {pr['idle_share']:.2%}")
    del sess, model   # frees the 29 GB model before the next phase
    return launches


# ------------------------------- phase 15: rwkv6-7b serving, card vs CPU


def phase_rwkv_parity(cfg, device) -> None:
    from repro_torch.engine import ServeConfig
    from repro_torch.kernels.wkv6_chunk import wkv6_state_cuda
    from repro_torch.models import decoder as dec
    from repro_torch.serve import ServingSession, replay_trace
    cpu_model = dec.init_params(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(device)
    toks = torch.tensor([[5], [77], [301]])
    out = {}
    for dev, model in (("cpu", cpu_model), (device, gpu_model)):
        state = dec.init_decode_state(cfg, 3, 24, device=dev)
        for _ in range(2):   # the second step starts from a carried state
            logits, state = dec.decode_step(model, state,
                                            {"tokens": toks.to(dev)})
        out[str(dev)] = logits.cpu(), [a.cpu() for st in state["rwkv"]
                                       for a in st]
    (lc, sc), (lg, sg) = out["cpu"], out[str(device)]
    require(lg.shape == (3, 1, cfg.vocab), "card logits are not [3, 1, V]")
    diff = check_close("card vs CPU logits", lg, lc, 1e-4)
    # a state entry may come out of cancellation (k_i small), so each state
    # is held to its largest magnitude, as phase 14 (a) holds a layer
    sdiff = max((a - b).abs().max().item() / b.abs().max().item()
                for a, b in zip(sg, sc))
    print(f"  two decode steps: card vs CPU logits max abs diff {diff:.3e} "
          f"(rtol = atol = 1e-4), states {sdiff:.2e} of their largest "
          f"magnitude (tolerance 1e-4)")
    require(sdiff <= 1e-4, f"card and CPU states differ by {sdiff:.2e} of "
                           f"their largest magnitude")

    sc_cfg = ServeConfig(max_batch=3, max_seq=24)
    before = wkv6_state_cuda.launches
    reps = {}
    for name, dev, model in (("card", device, gpu_model),
                             ("cpu", "cpu", cpu_model)):
        reqs = replay_trace(GOLDEN_ARRIVALS, vocab=cfg.vocab, seed=11)
        reps[name] = ServingSession(cfg, sc_cfg, device=dev,
                                    model=model).run(reqs)
    require(wkv6_state_cuda.launches > before,
            "the card run did not go through K3s")
    tok_gpu = [r.tokens for r in reps["card"].records]
    tok_cpu = [r.tokens for r in reps["cpu"].records]
    print(f"  {cfg.name}: {len(tok_gpu)} requests, "
          f"{sum(map(len, tok_gpu))} tokens on the card, identical to the "
          f"CPU: {tok_gpu == tok_cpu}")
    require(tok_gpu == tok_cpu, f"card tokens {tok_gpu} != CPU {tok_cpu}")


# ---------------------------------- phase 17: dense decoders, nothing cut


def decode_times(model, cfg, serve_cfg, device, n: int = 10) -> list:
    """Wall ms of ``n`` synchronised decode steps with every slot active
    (after one untimed step)."""
    from repro_torch.models import decoder as dec
    g = torch.Generator(device=device)
    g.manual_seed(9)
    b = serve_cfg.max_batch
    state = dec.init_decode_state(cfg, b, serve_cfg.max_seq, device=device)
    if cfg.moe:
        state["solver"] = dec.init_solver_states(cfg, 1, device=device)
    toks = torch.randint(0, cfg.vocab, (b, 1), generator=g, device=device)
    _, state = dec.decode_step(model, state, {"tokens": toks})
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state = dec.decode_step(model, state, {"tokens": toks})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def phase_serve_dense(cfg, serve_cfg, device) -> None:
    """Serve a dense decoder at full size: 4 Poisson requests, every one
    finished, no balance, no overflow, and no hand-written kernel
    launched (its products are cuBLAS's, as the reference's are XLA's)."""
    from repro_torch.models import decoder as dec
    from repro_torch.serve import ServingSession, poisson_trace
    t0 = time.perf_counter()
    model = dec.init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads x {cfg.head_dim} ({cfg.num_kv_heads} KV), "
          f"{cfg.ffn_kind} d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"{n_params / 1e9:.3f} B f32 params initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    requests = poisson_trace(4, rate=0.5, vocab=cfg.vocab, prompt_len=8,
                             gen_len=8, seed=1)
    sess = ServingSession(cfg, serve_cfg, device=device, model=model)
    before = launch_totals()
    rep = sess.run(requests)
    launched = {k: v - before[k] for k, v in launch_totals().items()}
    for line in rep.summary().splitlines():
        print("  " + line)
    require(len(rep.records) == len(requests) and rep.rejected == 0,
            f"served {len(rep.records)} of {len(requests)} requests")
    require(all(r.n_generated == q.max_new
                for r, q in zip(rep.records, requests)),
            "a request finished short of its generation budget")
    require(rep.mean_balance is None and rep.overflow == 0.0,
            f"balance {rep.mean_balance}, overflow {rep.overflow}")
    require(not any(launched.values()),
            f"the dense path launched kernels: {launched}")
    times = decode_times(model, cfg, serve_cfg, device)
    print(f"  {rep.decode_steps} decode steps + 1 warm-up, {rep.gen_tokens} "
          f"tokens generated, {rep.wall_s / rep.decode_steps * 1e3:.2f} ms "
          f"a step in the served run; a synchronised step at "
          f"{serve_cfg.max_batch} slots {sum(times) / len(times):.2f} ms "
          f"(mean of {len(times)}; {min(times):.2f}-{max(times):.2f}); no "
          f"hand-written kernel on this path (launches {launched})")
    del sess, model


# ---------------------------------------------------- phase 20: K3b


def phase_k3b(device):
    """K3b against its plain version (``time_k3.check_bwd``).  -> (K3b's
    record, K3's record at the training geometry of phase 21); their
    launches are phase 21's."""
    from repro_torch.launch import time_k3
    try:
        r = time_k3.check_bwd(device)
    except AssertionError as exc:
        raise SmokeFailure(str(exc)) from exc
    for line in time_k3.describe_bwd(r).splitlines():
        print("  " + line)
    records = []
    for key, name, source, replaces, err in (
            ("k3b", "wkv6_bwd", "src/repro_torch/csrc/wkv6_bwd.cu",
             "src/repro/kernels/ref.py:87", r["err"]),
            ("k3", "wkv6 (rwkv6-7b training)", "src/repro_torch/csrc/wkv6.cu",
             "src/repro/kernels/wkv6_chunk.py:93", r["k3_err"])):
        m = r[key]
        bound_ms, bound_by = m["bound"][:2]
        records.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": 0,
                        "max_abs_err": err, "ms": m["ms"],
                        "plain_ms": m["plain_ms"], "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None})
    return records


# ---------------------------------------------- phase 21: rwkv6-7b training


def phase_remat_equal(cfg, device) -> None:
    """One train step of ``cfg`` from identical weights without and with
    every block rematerialised: every gradient equal bit for bit, K3
    launched twice as often with remat, K3b as often."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.check_train import (expected_launches,
                                                kernel_launches)
    from repro_torch.models import decoder as dec
    from repro_torch.train.loop import init_train_state, make_train_step
    model = dec.init_params(cfg, seed=5, device=device)
    models = {False: copy.deepcopy(model), True: model}
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=512, batch=8,
                        seed=6).batch_at(0)
    out = {}
    for remat, m_ in models.items():
        ts = init_train_state(cfg, device=device, model=m_)
        step = make_train_step(cfg, n_micro=2, device=device, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = kernel_launches()
        t0 = time.perf_counter()
        ts, m = step(ts, batch)
        loss = float(m["loss"])
        ms = (time.perf_counter() - t0) * 1e3
        launched = {k: v - before[k] for k, v in kernel_launches().items()}
        want = expected_launches(cfg, 2, remat=remat)
        require(launched == want, f"remat {remat}: launches {launched}, "
                                  f"expected {want}")
        out[remat] = (loss, ms, torch.cuda.max_memory_allocated(), launched)
        del ts, step
    grads = [{n: p.grad for n, p in models[r].named_parameters()}
             for r in (False, True)]
    differ = [n for n in grads[0] if not torch.equal(grads[0][n],
                                                     grads[1][n])]
    require(not differ, f"gradients differ with remat: {differ[:5]}")
    for remat, (loss, ms, peak, launched) in out.items():
        print(f"  {cfg.num_layers} layers, {'with' if remat else 'without'} "
              f"remat: loss {loss:.6f}, {ms:.1f} ms (a first step), peak "
              f"memory {peak / 2**30:.2f} GiB (both models held), "
              f"launches K3 {launched['K3']}, K3b {launched['K3b']}")
    print(f"  every gradient ({len(grads[0])} tensors) equal bit for bit with "
          f"and without remat")


def phase_ckpt_roundtrip(cfg, device) -> None:
    """Save the card model's reference tree in the checkpoint files,
    restore it on the CPU through ``restore_checkpoint`` and
    ``load_reference_params``: every parameter equal bit for bit, and the
    loss of a fixed batch on the CPU within 2e-4 of the card's."""
    import tempfile
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import decoder as dec
    card = dec.init_params(cfg, seed=7, device=device)
    batch = {k: torch.as_tensor(v).long() for k, v in SyntheticLM(
        vocab=cfg.vocab, seq_len=16, batch=4, seed=8).batch_at(0).items()}
    with torch.no_grad():
        loss_card = float(dec.loss_fn(
            card, {k: v.to(device) for k, v in batch.items()})[0])
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        path = save_checkpoint(d, 1, dec.reference_tree(card),
                               {"arch": cfg.name})
        size = pathlib.Path(path).stat().st_size
        tree = restore_checkpoint(
            path, dec.reference_tree(dec.Decoder(cfg, device="cpu")))
    cpu = dec.load_reference_params(tree, cfg, device="cpu")
    card_params = dict(card.named_parameters())
    differ = [n for n, p in cpu.named_parameters()
              if not torch.equal(p, card_params[n].cpu())]
    require(not differ, f"restored parameters differ: {differ[:5]}")
    with torch.no_grad():
        loss_cpu = float(dec.loss_fn(cpu, batch)[0])
    require(abs(loss_cpu - loss_card) < 2e-4,
            f"loss {loss_card} on the card, {loss_cpu} after the restore")
    print(f"  {cfg.name}: saved the card model ({size / 1e6:.2f} MB, "
          f"{len(card_params)} tensors) and restored it on the CPU, every "
          f"parameter equal bit for bit; loss {loss_card:.6f} on the card, "
          f"{loss_cpu:.6f} on the CPU (|d| {abs(loss_cpu - loss_card):.2e}, "
          f"within 2e-4)")


# ------------------ phase 22: telemetry, replacement and replication


# the three trigger policies of the serving hook: (TelemetryConfig fields
# beside record=True, ReplicationConfig fields or None)
HOOK_POLICIES = {"reactive": ({}, None),
                 "forecast": ({"forecast_replacement": True}, None),
                 "topology": ({}, {"enabled": True, "check_every": 4})}


def hook_configs(policy: str):
    from repro_torch.engine import ReplicationConfig, TelemetryConfig
    tel, rep = HOOK_POLICIES[policy]
    return (TelemetryConfig(record=True, **tel),
            None if rep is None else ReplicationConfig(**rep))


@contextlib.contextmanager
def routed_rows(rows: list):
    """Append each decode step's active slot count (the rows every MoE
    layer routes, top_k times each) to ``rows`` while the block runs."""
    from repro_torch.serve import batching
    real = batching.BatchManager.next_tokens

    def spy(self):
        toks, act = real(self)
        rows.append(int(act.sum()))
        return toks, act
    batching.BatchManager.next_tokens = spy
    try:
        yield rows
    finally:
        batching.BatchManager.next_tokens = real


def check_replay(sess, policy: str, tmp: pathlib.Path) -> None:
    """(b): the session's trace saved as .npz and .jsonl reads back equal
    to the recorder's history bit for bit, and a fresh hook on the CPU fed
    the trace makes the session's decision records, field for field."""
    from repro_torch.core.placement import vanilla_placement
    from repro_torch.serve import ServeReplacement
    from repro_torch.telemetry import LoadTrace
    hist = sess.recorder.history()
    for ext in ("npz", "jsonl"):
        tr = LoadTrace.load(sess.recorder.save(str(tmp / f"{policy}.{ext}")))
        require(tr.loads.dtype == hist.dtype and bool((tr.loads == hist).all())
                and bool((tr.steps == sess.recorder.trace().steps).all()),
                f"{policy}: the .{ext} trace differs from the recorder's")
    tel, rep = hook_configs(policy)
    cfg = sess.cfg
    hook = ServeReplacement(
        vanilla_placement(1, 1, cfg.num_experts * max(cfg.etp, 1)),
        sess.serve_cfg, 3 * cfg.d_model * cfg.moe_d_ff * 4, seed=sess.seed,
        telemetry=tel, replication=rep)
    for step, row in zip(tr.steps, tr.layer_sum()):
        hook.observe(row, step=int(step))
    require(hook.events == sess.replacement.events,
            f"{policy}: the CPU replay's decision records differ from the "
            f"card run's")


def phase_hooks_serve(cfg, serve_cfg, device, tmp: pathlib.Path):
    """(a) and (b).  -> (the topology run's trace, the card's line)."""
    from repro_torch.kernels.grouped_matmul import grouped_ffn_flat_cuda
    from repro_torch.kernels.sched import schedule_cuda
    from repro_torch.launch.check_train import count_plain_calls
    from repro_torch.models import decoder as dec
    from repro_torch.serve import ServingSession, poisson_trace
    model = dec.init_params(cfg, seed=0, device=device)
    requests = poisson_trace(4, rate=0.5, vocab=cfg.vocab, prompt_len=8,
                             gen_len=8, seed=1)
    n_moe, width = dec.n_moe_layers(cfg), cfg.num_experts * max(cfg.etp, 1)
    sessions = {}
    for policy in HOOK_POLICIES:
        tel, rep = hook_configs(policy)
        sess = ServingSession(cfg, serve_cfg, device=device, model=model,
                              telemetry=tel, replication=rep)
        rows = []
        with count_plain_calls() as plain, routed_rows(rows):
            zero_counts(grouped_ffn_flat_cuda)   # just before the main path
            zero_counts(schedule_cuda)
            report = sess.run(requests)
            launched = (grouped_ffn_flat_cuda.launches,   # just after it
                        schedule_cuda.launches)
        expect = (report.decode_steps + 1) * n_moe   # + the warm-up step
        tr = sess.recorder.trace()
        sums = tr.layer_sum().sum(1)
        want = cfg.top_k * n_moe * np.asarray(rows, np.float64)
        events = sess.replacement.events
        print(f"  {policy}: {len(report.records)} requests, "
              f"{report.decode_steps} decode steps, K1 {launched[0]} and K4 "
              f"{launched[1]} launches (expected {expect} each), plain "
              f"{plain}; trace {tr.loads.shape}, row sums "
              f"{int(sums.min())}-{int(sums.max())}; {len(events)} "
              f"decisions, scores {sorted({e['score'] for e in events})}, "
              f"{report.migrations} migrations ({report.migrated_bytes} B)")
        require(len(report.records) == len(requests) and report.rejected == 0
                and report.overflow == 0.0,
                f"{policy}: served {len(report.records)} of {len(requests)}, "
                f"overflow {report.overflow}")
        require(launched == (expect, expect),
                f"{policy}: K1 and K4 launched {launched}, expected {expect}")
        require(not any(plain.values()),
                f"{policy}: a plain version ran on the card path: {plain}")
        require(tr.loads.shape == (report.decode_steps, 1, width)
                and tr.meta["layers"] == "summed"
                and bool((tr.loads == np.round(tr.loads)).all()),
                f"{policy}: trace {tr.loads.shape}, meta {tr.meta}")
        require(len(rows) == report.decode_steps
                and bool((sums == want).all()),
                f"{policy}: row sums {sums.tolist()} against top_k x "
                f"{n_moe} layers x rows {rows}")
        require(len(events) == report.decode_steps // 4
                and [e["step"] for e in events]
                == [int(s) for s in tr.steps[3::4]],
                f"{policy}: {len(events)} decision records over "
                f"{report.decode_steps} steps, not one every 4")
        require(report.migration_events == [e for e in events
                                            if e["fired"]],
                f"{policy}: the report's migration events are not the "
                f"fired decisions")
        check_replay(sess, policy, tmp)
        sessions[policy] = sess
    print("  (b) each trace saved as .npz and .jsonl reads back bit for bit;"
          " the CPU replay's decision records equal the card's")
    # the decode step with every hook on against none, in turns
    plain_sess = ServingSession(cfg, serve_cfg, device=device, model=model)
    hooked = sessions["topology"]
    per_step = {"none": [], "hooks": []}
    for name in ("none", "hooks", "hooks", "none"):
        s = plain_sess if name == "none" else hooked
        r = s.run(requests)
        per_step[name].append(r.wall_s / r.decode_steps * 1e3)
    off, on = (float(np.mean(per_step[k])) for k in ("none", "hooks"))
    card = card_line()
    print(f"  (a) decode step, wall time a step of the served run, in turns "
          f"(none, hooks, hooks, none): no hooks {off:.2f} ms "
          f"({', '.join(f'{v:.2f}' for v in per_step['none'])}), every hook "
          f"on (recorder + topology controller) {on:.2f} ms "
          f"({', '.join(f'{v:.2f}' for v in per_step['hooks'])}), "
          f"difference {on - off:+.2f} ms; {card}")
    trace = hooked.recorder.trace()
    del sessions, hooked, plain_sess, model
    return trace


def phase_hooks_train(cfg, device, tmp: pathlib.Path) -> None:
    """(c): ``launch.train.main`` with the four flags; the pre-warms it
    writes are captured and checked against a fresh planner's."""
    from repro_torch.core.placement import vanilla_placement
    from repro_torch.kernels.grouped_matmul import (grouped_ffn_flat_bwd_cuda,
                                                    grouped_ffn_flat_cuda)
    from repro_torch.kernels.sched import schedule_cuda
    from repro_torch.kernels.wkv6_chunk import wkv6_bwd_cuda, wkv6_cuda
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.check_train import (count_plain_calls,
                                                expected_launches,
                                                kernel_launches)
    from repro_torch.telemetry import LoadTrace, ReplacementPlanner
    steps, out, csv_path = 4, tmp / "train.npz", tmp / "train.csv"
    written = []
    real = train_cli.prewarm_solver_states

    def spy(states, x):
        new = real(states, x)
        written.append((x, [st.x.cpu() for st in new],
                        {st.x.device.type for st in new}))
        return new
    train_cli.prewarm_solver_states = spy
    try:
        with count_plain_calls() as plain:
            zero_counts(grouped_ffn_flat_cuda, grouped_ffn_flat_bwd_cuda,
                        schedule_cuda, wkv6_cuda,
                        wkv6_bwd_cuda)           # just before the main path
            t0 = time.perf_counter()
            rc = train_cli.main([
                "--arch", cfg.name, "--layers", str(cfg.num_layers),
                "--batch", "8", "--seq", "512", "--n-micro", "2",
                "--steps", str(steps), "--csv", str(csv_path),
                "--telemetry-record", "--trace-out", str(out), "--prewarm",
                "--replication", "--replication-check-every", "2"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = kernel_launches()         # just after it
    finally:
        train_cli.prewarm_solver_states = real
    want = expected_launches(cfg, 2, steps)
    with open(csv_path, newline="") as f:
        losses = [float(row["loss"]) for row in csv.DictReader(f)]
    tr = LoadTrace.load(str(out))
    print(f"  main returned {rc} in {wall:.1f} s; launches {launched} "
          f"(expected {want}), plain {plain}; losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; trace {tr.loads.shape}, "
          f"row sums {tr.layer_sum().sum(1).tolist()}; {len(written)} "
          f"pre-warms")
    require(rc == 0 and launched == want and not any(plain.values()),
            f"training launched {launched}, expected {want}; plain {plain}")
    require(len(losses) == steps and bool(np.isfinite(losses).all()),
            f"losses {losses}")
    width = cfg.num_experts * max(cfg.etp, 1)
    require(tr.loads.shape == (steps, 1, width),
            f"trace {tr.loads.shape}, expected ({steps}, 1, {width})")
    planner = ReplacementPlanner(vanilla_placement(1, 1, width),
                                 check_every=10 ** 9)
    require(len(written) == steps - planner.min_history + 1,
            f"{len(written)} pre-warms in {steps} steps")
    for i, row in enumerate(tr.layer_sum()):
        planner.observe(row)
        if i + 1 < planner.min_history:
            continue
        x, states, devices = written[i + 1 - planner.min_history]
        expect = planner.warm_start_x(solver="jacobi")
        require(devices == {device.type}, f"solver states on {devices}")
        require(x.dtype == np.float32 and bool((x == expect).all())
                and all(bool((st.numpy() == np.broadcast_to(
                    x, st.shape)).all()) for st in states),
                f"step {i}: the pre-warmed solver states differ from "
                f"warm_start_x(solver='jacobi')")
    print(f"  every pre-warm: each of the {cfg.num_layers} layers' solver "
          f"states on the card equals warm_start_x(solver='jacobi') "
          f"{written[-1][0].shape} bit for bit")


def phase_replicated(trace) -> None:
    """(d): the ``replicated`` placement from the trace's mean row, and the
    placements a ``TopologyController`` fires on the trace's rows, each
    scheduled on the card through K4 equal to the CPU, on phase 16 (b)'s
    group and counts."""
    from repro_torch.configs import get_config
    from repro_torch.core.placement import latin_placement
    from repro_torch.engine import PlacementSpec
    from repro_torch.kernels.sched import MAX_REPLICAS, schedule_cuda
    from repro_torch.launch import time_k4
    from repro_torch.replication import TopologyController, replica_histogram
    cfg = get_config("olmoe-1b-7b")
    n_e, grid = cfg.num_experts, time_k4.OLMOE_GRID
    g = grid[0] * grid[1]
    batches = time_k4.zipf_micro_batches(
        np.random.default_rng(0), n_e, g, time_k4.OLMOE_TOKENS,
        time_k4.OLMOE_SKEW, time_k4.MICRO_BATCHES)
    rows = trace.layer_sum()
    mean = rows.mean(axis=0)
    zero_counts(schedule_cuda)

    def check(label, placement):
        card, cpu = time_k4.engines(n_e, grid, placement=placement)
        try:
            time_k4.check_engines(card, cpu, batches, False, label)
            warm = time_k4.check_engines(card, cpu, batches, True, label)
        except AssertionError as exc:
            raise SmokeFailure(str(exc)) from exc
        rc = card.placement.replica_count()
        require(int(rc.max()) <= MAX_REPLICAS,
                f"{label}: {int(rc.max())} replicas, K4 takes "
                f"{MAX_REPLICAS}")
        print(f"    {label}: replicas {replica_histogram(card.placement)} "
              f"(most {int(rc.max())}, K4's limit {MAX_REPLICAS}); warm max "
              f"load {float(warm[-1].max_load):.1f}, HiGHS "
              f"{time_k4.lp_max_load(cpu, batches[-1]):.2f}")
        return card.placement
    print(f"  (d) olmoe-1b-7b's {n_e} experts on {grid[0]} x {grid[1]} "
          f"devices, phase 16 (b)'s counts, card = CPU bit for bit, cold "
          f"and warm:")
    seed = check("replicated (the trace's mean row)",
                 PlacementSpec("replicated", loads=tuple(mean)))
    fired = []
    for start, p0 in (("replicated", seed),
                      ("latin", latin_placement(*grid, n_e))):
        # two Monte-Carlo samples for the 'regenerate' candidate: each
        # scores Eq. 3 over the 2^16 device subsets (~1 s on the host)
        ctl = TopologyController(p0, 3 * cfg.d_model * cfg.moe_d_ff * 4,
                                 check_every=4, threshold=1.0,
                                 migration_gate=0.0, mc_samples=2, seed=0)
        for row in rows:
            new = ctl.observe(row)
            if new is not None:
                fired.append((start, len(ctl.decisions), new))
        print(f"    controller from {start}: {len(ctl.decisions)} checks, "
              f"{ctl.replacements} fired, {ctl.moved_slots} slots moved "
              f"({ctl.migrated_bytes} B)")
    require(fired, "no topology migration fired on the trace")
    for start, check_no, placement in fired:
        check(f"fired from {start} at check {check_no}", placement)
    require(schedule_cuda.launches > 0, "K4 did not run in (d)")
    print(f"  K4 launched {schedule_cuda.launches} times in (d)")


GROUP_STEPS = 4              # (c)'s training steps
GROUP_LR = 3e-3              # launch/train.py's default --lr
# (b) and (c) against one device, 3-5 times the gaps read on the card
# (PERF.md §6, PR 27): (b) each rank's logits within 1e-5 of the one-device
# rows' largest magnitude (read 2.1e-6 to 2.5e-6); (c) step 0's CE within
# 1e-4 (read 3.3e-5) and its loss within 2e-4 (read 8.7e-5: the MoE aux
# terms are per-rank means on the group, whole-batch on one device), every
# step's gradient norm within a relative 2e-4 (read 4.9e-5 at most), and
# steps 1-3's losses within 5e-4 (read 1.05e-4)
LOGITS_REL = 1e-5
STEP0_CE, STEP0_LOSS, GNORM_REL, LATER_LOSS = 1e-4, 2e-4, 2e-4, 5e-4


def group_references(cfg, device, ref_dir: pathlib.Path) -> tuple:
    """23: the one-device forward's loss on (b)'s batch, its logits saved
    row by row (a rank's sequence) into ``ref_dir``, then the one-device
    training run at 2 layers on (c)'s batches with (c)'s schedule: each
    step's metrics."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.check_group import forward_batch
    from repro_torch.launch.runtime import make_forward_fn
    from repro_torch.models import decoder as dec
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.train.loop import init_train_state, make_train_step
    with phase_stats("23 one-device forward, full width and depth"):
        model = dec.init_params(cfg, seed=0, device=device)
        batch = forward_batch(cfg, 4, 1, device)
        logits = make_forward_fn(model, last_only=False, device=device)(batch)
        fwd_loss = float(dec.lm_loss(logits, batch["labels"]))
        for r in range(logits.shape[0]):
            torch.save(logits[r:r + 1].cpu().clone(),
                       ref_dir / f"logits{r}.pt")
        del model, logits
    torch.cuda.empty_cache()
    with phase_stats(f"23 one-device training, 2 layers, {GROUP_STEPS} "
                     f"steps"):
        cfg2 = dataclasses.replace(cfg, num_layers=2)
        ts = init_train_state(cfg2, seed=0, device=device)
        step = make_train_step(
            cfg2, opt_cfg=AdamWConfig(lr=GROUP_LR), n_micro=2, device=device,
            lr_fn=lambda s: warmup_cosine(s, GROUP_LR, warmup=20,
                                          total=GROUP_STEPS))
        data = SyntheticLM(vocab=cfg.vocab, seq_len=512, batch=8, noise=0.05,
                           n_maps=4, seed=1)
        train = []
        for _, b in zip(range(GROUP_STEPS), data):
            ts, m = step(ts, b)
            train.append({k: float(v) for k, v in m.items()})
        del ts, step
    torch.cuda.empty_cache()
    print(f"  one-device forward loss {fwd_loss:.6f}; training losses "
          + ", ".join(f"{m['loss']:.6f}" for m in train)
          + f", step 0's CE {train[0]['ce_loss']:.6f} and gradient norm "
          f"{train[0]['grad_norm']:.6f}")
    return fwd_loss, train


def phase_group(cfg, device, tmp: pathlib.Path) -> list:
    """23: (a), (b), (d) on four ranks, then (c) through ``launch/train``
    -> (c)'s rank records."""
    from repro_torch.launch import check_group
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import spawn_group
    fwd_loss, train = group_references(cfg, device, tmp)
    held = torch.cuda.memory_allocated(device) / 2 ** 30
    print(f"  this process holds {held:.2f} GiB while the ranks run")
    require(held < 1.0, "the one-device references were not freed")
    t0 = time.perf_counter()
    recs = spawn_group(check_group.group_checks, (0, str(tmp)), 2, 2,
                       backend="gloo", device="cuda")
    print(f"  [23 (a), (b), (d)] four ranks in {time.perf_counter() - t0:.1f} "
          f"s")
    for r in recs:
        a, b, d = r["layer"], r["forward"], r["sync"]
        print(f"  rank {r['index']}: (a) "
              + ", ".join(f"{v} {x['ms']:.0f} ms" for v, x in
                          a["variants"].items())
              + f"; equal to G=1 {a['g1_equal']} (max {a['g1_max_abs']:.1e}),"
              f" flows identical {a['flow_identical']}, peak "
              f"{a['peak_gib']:.2f} GiB; (b) loss "
              + ", ".join(f"{s} stages {v:.6f} in {b['ms'][s]:.0f} ms, "
                          f"logits off by {b['logits_rel'][s]:.2e} of their "
                          f"largest" for s, v in b["loss"].items())
              + f", peak {b['peak_gib']:.2f} GiB; (d) {d['matchings']} "
              f"matchings, to canonical {d['to_canonical_ms']:.0f} ms, to "
              f"working {d['to_working_ms']:.0f} ms, peak "
              f"{d['peak_gib']:.2f} GiB")
        for s, v in b["loss"].items():
            require(abs(v - fwd_loss) < 2e-4,
                    f"rank {r['index']}: the group forward's loss {v:.6f} "
                    f"({s} stages) against the one-device {fwd_loss:.6f}")
            require(b["logits_rel"][s] < LOGITS_REL,
                    f"rank {r['index']}: the logits ({s} stages) are off by "
                    f"{b['logits_rel'][s]:.2e} of the one-device rows' "
                    f"largest (limit {LOGITS_REL})")
    report = tmp / "group_train"
    t0 = time.perf_counter()
    rc = train_cli.main([
        "--arch", cfg.name, "--layers", "2", "--batch", "8", "--seq", "512",
        "--n-micro", "2", "--steps", str(GROUP_STEPS), "--lr", str(GROUP_LR),
        "--data-axis", "2", "--model-axis", "2", "--backend", "gloo",
        "--report", str(report)])
    wall = time.perf_counter() - t0
    recs = [json.loads((report / f"rank{i}.json").read_text())
            for i in range(4)]
    n = 2 * 2 * GROUP_STEPS                     # layers x micro x steps
    want = {"K1": n, "K1b": n, "K4": n}
    for r in recs:
        losses = [st["loss"] for st in r["steps"]]
        print(f"  [23 (c)] rank {r['rank']}: losses "
              f"{', '.join(f'{v:.6f}' for v in losses)}; step walls "
              f"{', '.join('%.1f' % st['wall_s'] for st in r['steps'])} s; "
              f"launches {r['launches']}, plain {r['plain']}; peak "
              f"{r['peak_gib']:.2f} GiB")
        require(rc == 0 and r["launches"] == want and not any(
            r["plain"].values()), f"rank {r['rank']}: launches "
            f"{r['launches']} (expected {want}), plain {r['plain']}")
        require(bool(np.isfinite(losses).all()) and all(
            st["overflow"] == 0 and st["same_rows"] for st in r["steps"]),
            f"rank {r['rank']}: {r['steps']}")
        metrics = [{k: v for k, v in st.items()
                    if k not in ("wall_s", "digest")} for st in r["steps"]]
        require(metrics == [{k: v for k, v in st.items()
                             if k not in ("wall_s", "digest")}
                            for st in recs[0]["steps"]],
                f"rank {r['rank']}'s metrics differ from rank 0's")
    got, want_m = recs[0]["steps"], train
    gaps = {"step 0 CE": abs(got[0]["ce_loss"] - want_m[0]["ce_loss"]),
            "step 0 loss": abs(got[0]["loss"] - want_m[0]["loss"]),
            "gradient norm (relative)": max(
                abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                for g, w in zip(got, want_m)),
            "steps 1-3 loss": max(abs(g["loss"] - w["loss"]) for g, w in
                                  zip(got[1:], want_m[1:]))}
    print(f"  [23 (c)] main returned {rc} in {wall:.1f} s; against the "
          f"one-device run: "
          + ", ".join(f"{k} off by {v:.3e}" for k, v in gaps.items())
          + "; gradient norms "
          + ", ".join(f"{g['grad_norm']:.6f}/{w['grad_norm']:.6f}"
                      for g, w in zip(got, want_m)))
    for (k, v), limit in zip(gaps.items(), (STEP0_CE, STEP0_LOSS, GNORM_REL,
                                            LATER_LOSS)):
        require(v < limit, f"(c) {k} off by {v:.3e} (limit {limit})")
    return recs


# ------------ phase 24: serving on a group, paid migrations, disaggregation

# (a) against one device: each rank's logits of one decode step within
# SERVE_LOGITS_REL of the one-device rows' largest magnitude (phase 23 (b)
# read 2.1e-6 to 2.5e-6 for the forward)
SERVE_LOGITS_REL = 1e-5


def phase_disagg_one(cfg, device) -> int:
    """24 (c): ``cfg`` served disaggregated on the card -> K1's launches
    (K4's are equal)."""
    from repro_torch.engine import DisaggConfig, ServeConfig
    from repro_torch.kernels.grouped_matmul import grouped_ffn_flat_cuda
    from repro_torch.kernels.sched import schedule_cuda
    from repro_torch.launch.check_group import DISAGG, SERVE, serve_requests
    from repro_torch.launch.check_train import count_plain_calls
    from repro_torch.models import decoder as dec
    from repro_torch.serve import ServingSession
    reqs = serve_requests(cfg, disagg=True)
    sess = ServingSession(cfg, ServeConfig(**SERVE), seed=0, device=device,
                          disagg=DisaggConfig(**DISAGG))
    zero_counts(grouped_ffn_flat_cuda, schedule_cuda)   # the main path
    with count_plain_calls() as plain:
        t0 = time.perf_counter()
        rep = sess.run(reqs)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    k1, k4 = grouped_ffn_flat_cuda.launches, schedule_cuda.launches
    d = rep.disagg
    slot = dec.decode_slot_bytes(dec.init_decode_state(
        cfg, 1, SERVE["max_seq"], device=device))
    ids = [r.req_id for r in rep.records]
    print(f"  {len(ids)} requests in {rep.steps} steps ({rep.decode_steps} "
          f"ticks stepped), {wall:.2f} s; {d['transferred']} handoffs of "
          f"{slot} B, buffer peak {d['handoff_peak']}/{d['handoff_depth']}, "
          f"{d['handoff_bytes']} B staged, {d['prefill_stall_seq_steps']} "
          f"stall seq-steps; balance prefill {d['prefill_balance']}, decode "
          f"{d['decode_balance']}; K1 {k1}, K4 {k4}, plain {dict(plain)}")
    require(sorted(ids) == [r.req_id for r in reqs],
            f"requests served {sorted(ids)}, submitted "
            f"{[r.req_id for r in reqs]}")
    require(all(r.n_generated == q.max_new for r, q in zip(
        rep.records, sorted(reqs, key=lambda q: q.req_id))),
        "a request lost or gained tokens")
    require(d["transferred"] == len(reqs) and rep.rejected == 0,
            f"{d['transferred']} transfers for {len(reqs)} requests")
    require(d["handoff_peak"] <= d["handoff_depth"], "buffer past its depth")
    require(d["handoff_bytes"] == slot * d["transferred"],
            f"handoff bytes {d['handoff_bytes']} != {slot} x "
            f"{d['transferred']}")
    require(k1 == k4 > 0 and k1 % cfg.num_layers == 0
            and not any(plain.values()),
            f"launches K1 {k1}, K4 {k4}, plain {dict(plain)}")
    del sess
    return k1


def phase_disagg_parity(cfg, device) -> None:
    """24 (c): ``cfg``'s disaggregated run on the card and on the CPU from
    identical weights: equal tokens and step-clock fields."""
    from repro_torch.engine import DisaggConfig, ServeConfig
    from repro_torch.launch.check_group import step_fields
    from repro_torch.models import decoder as dec
    from repro_torch.serve import ServingSession, replay_trace
    cpu_model = dec.init_params(cfg, seed=0, device="cpu")
    models = {"card": copy.deepcopy(cpu_model).to(device), "cpu": cpu_model}
    dg = DisaggConfig(enabled=True, prefill_slots=3, decode_slots=2,
                      handoff_depth=2)
    reps = {}
    for name, model in models.items():
        reqs = replay_trace(GOLDEN_ARRIVALS, vocab=cfg.vocab, seed=11)
        reps[name] = ServingSession(
            cfg, ServeConfig(max_batch=3, max_seq=24), device=model.device,
            model=model, disagg=dg).run(reqs)
    toks = {k: [r.tokens for r in v.records] for k, v in reps.items()}
    same = step_fields(reps["card"].to_dict()) == \
        step_fields(reps["cpu"].to_dict())
    print(f"  {cfg.name}: {sum(map(len, toks['card']))} tokens, card = CPU "
          f"{toks['card'] == toks['cpu']}, step-clock fields equal {same}")
    require(toks["card"] == toks["cpu"] and same,
            f"card {toks['card']} != CPU {toks['cpu']}")


def phase_group_serve(device, tmp: pathlib.Path, plain_train: list) -> dict:
    """24 (a), (d) and 25 (c) on four ranks, after their one-device
    references; then 24 (b) through ``launch/train`` held to phase 23
    (c)'s records (``plain_train``) -> the ranks' launches: {"serve": K1's
    and K4's in 24 (a) and (d), "fleet": in 25 (c), "train": K1's, K1b's
    and K4's in 24 (b)}."""
    from repro_torch.launch import check_group
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import spawn_group
    with phase_stats("24 one-device references"):
        ref = check_group.serve_references(device, 0, tmp)
    held = torch.cuda.memory_allocated(device) / 2 ** 30
    require(held < 1.0, f"the references were not freed ({held:.2f} GiB)")
    t0 = time.perf_counter()
    recs = spawn_group(check_group.serve_checks, (0, str(tmp)), 2, 2,
                       backend="gloo", device="cuda")
    print(f"  [24 (a), (d)] four ranks in {time.perf_counter() - t0:.1f} s")
    launched = {"serve": {"K1": 0, "K4": 0}, "fleet": {"K1": 0, "K4": 0},
                "train": {"K1": 0, "K1b": 0, "K4": 0}}
    for r in recs:
        off, on, dg = r["off"], r["on"], r["disagg"]
        for run in (off, on, dg):
            for k, v in run["launches"].items():
                launched["serve"][k] += v
        walls = ", ".join(f"step {m['step']} {m['wall_s'] * 1e3:.0f} ms"
                          for m in on["migrations"])
        print(f"  rank {r['index']}: (a) logits off by {r['logits_rel']:.2e}"
              f" of the one-device rows' largest; hook off {off['wall_s']:.1f}"
              f" s for {off['decode_steps']} steps (build "
              f"{off['build_s']:.1f} s, peak {off['peak_gib']:.2f} GiB), hook "
              f"on {on['wall_s']:.1f} s, {len(on['migrations'])} migrations "
              f"paid ({walls}), {on['report']['migrated_bytes']} B priced, "
              f"peak {on['peak_gib']:.2f} GiB; launches {off['launches']} / "
              f"{on['launches']}; (d) {dg['wall_s']:.1f} s, "
              f"{dg['report']['disagg']['transferred']} handoffs, launches "
              f"{dg['launches']}, peak {dg['peak_gib']:.2f} GiB")
        require(r["logits_rel"] < SERVE_LOGITS_REL,
                f"rank {r['index']}: logits off by {r['logits_rel']:.2e} "
                f"(limit {SERVE_LOGITS_REL})")
        require(on["tokens"] == recs[0]["on"]["tokens"]
                and on["fields"] == recs[0]["on"]["fields"],
                f"rank {r['index']}'s run differs from rank 0's")
        require(dg["tokens"] == ref["tokens"]
                and dg["fields"] == ref["fields"],
                f"rank {r['index']}: the group's disaggregated run differs "
                f"from one device's: {dg['fields']} against {ref['fields']}")
        fl, fl0 = r["fleet"]["report"], recs[0]["fleet"]["report"]
        for k, v in r["fleet"]["launches"].items():
            launched["fleet"][k] += v
        print(f"  [25 (c)] rank {r['index']}: {r['fleet']['decode_steps']} "
              f"decode steps in {r['fleet']['wall_s']:.1f} s, "
              f"{fl['fleet']['admits']} admits, {fl['fleet']['drains']} "
              f"drains, {fl['resilience']['crashes']} crash, "
              f"{fl['resilience']['straggler_deflations']} deflation; "
              f"launches {r['fleet']['launches']}, peak "
              f"{r['fleet']['peak_gib']:.2f} GiB")
        require(fl["fleet"] == fl0["fleet"]
                and fl["resilience"] == fl0["resilience"],
                f"rank {r['index']}'s fleet or resilience block differs "
                f"from rank 0's")
        require(r["fleet"]["tokens"] == ref["fleet"],
                f"rank {r['index']}: the group's fleet run's tokens differ "
                f"from one device's")
    report = tmp / "group_train_hooks"
    args = ["--arch", "olmoe-1b-7b", "--layers", "2", "--batch", "8",
            "--seq", "512", "--n-micro", "2", "--steps", str(GROUP_STEPS),
            "--lr", str(GROUP_LR), "--data-axis", "2", "--model-axis", "2",
            "--backend", "gloo", "--report", str(report),
            "--telemetry-record", "--trace-out", str(tmp / "trace.npz"),
            "--prewarm", "--replication", "--replication-check-every", "2",
            "--replication-threshold", "1.0", "--migration-gate", "0"]
    t0 = time.perf_counter()
    rc = train_cli.main(args)
    wall = time.perf_counter() - t0
    hooked = [json.loads((report / f"rank{i}.json").read_text())
              for i in range(4)]
    repl = hooked[0]["replication"]
    rebuilds = ", ".join(f"step {m['step']} {m['build_s']:.2f} s"
                         for m in repl["migrations"])
    losses = ", ".join(f"{st['loss']:.6f}" for st in hooked[0]["steps"])
    print(f"  [24 (b)] main returned {rc} in {wall:.1f} s: "
          f"{len(repl['decisions'])} checks, {repl['replacements']} topology "
          f"migrations (rebuilds {rebuilds}), {repl['moved_slots']} slots "
          f"moved ({repl['migrated_bytes']} B); losses {losses}")
    n = 2 * 2 * GROUP_STEPS
    got, want = hooked[0]["steps"], plain_train[0]["steps"]
    gaps = {"step 0 CE": abs(got[0]["ce_loss"] - want[0]["ce_loss"]),
            "step 0 loss": abs(got[0]["loss"] - want[0]["loss"]),
            "gradient norm (relative)": max(
                abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                for g, w in zip(got, want)),
            "steps 1-3 loss": max(abs(g["loss"] - w["loss"]) for g, w in
                                  zip(got[1:], want[1:]))}
    print("  [24 (b)] against phase 23 (c)'s run without the flags: "
          + ", ".join(f"{k} off by {v:.3e}" for k, v in gaps.items()))
    require(rc == 0 and repl["replacements"] >= 1,
            "no topology migration fired in (b)")
    for r in hooked:
        require(r["launches"] == {"K1": n, "K1b": n, "K4": n}
                and not any(r["plain"].values()),
                f"rank {r['rank']}: launches {r['launches']}, plain "
                f"{r['plain']}")
        require(r["trace"] == hooked[0]["trace"]
                and len(r["trace"]) == GROUP_STEPS,
                f"rank {r['rank']}'s trace rows differ from rank 0's")
        require(all(st["same_rows"] and st["overflow"] == 0
                    for st in r["steps"]),
                f"rank {r['rank']}: {r['steps']}")
        require(r["replication"]["decisions"] == repl["decisions"],
                f"rank {r['rank']}'s controller decided otherwise")
        for k, v in r["launches"].items():
            launched["train"][k] += v
    for (k, v), limit in zip(gaps.items(), (STEP0_CE, STEP0_LOSS, GNORM_REL,
                                            LATER_LOSS)):
        require(v < limit, f"(b) {k} off by {v:.3e} (limit {limit})")
    return launched


# ------------------ phase 25: elastic fleets and fault recovery in serving


def phase_fleet(cfg, device, tmp: pathlib.Path) -> dict:
    """25 (a), (b), (d)-(f) on one device (``launch/check_fleet.py``; its
    checks raise) -> the launches of (a) and (b): {"K1": n, "K4": n}."""
    from repro_torch.kernels.grouped_matmul import grouped_ffn_flat_cuda
    from repro_torch.kernels.sched import schedule_cuda
    from repro_torch.launch import check_fleet as F
    from repro_torch.models import decoder as dec
    from repro_torch.telemetry import LoadTrace

    def main_path():
        zero_counts(grouped_ffn_flat_cuda, schedule_cuda)
    with phase_stats("25 (a) a fleet that admits, drains, crashes and "
                     "straggles, full size"):
        model = dec.init_params(cfg, seed=0, device=device)
        a = F.serve_fleet(model, tmp, zero_counts=main_path)
    d = a["report"]
    fl, res = d["fleet"], d["resilience"]
    deflate = [e for e in res["events"] if e["kind"] == "straggler_deflate"]
    print(f"  (a) {len(d['per_request'])} requests in {a['steps']} steps "
          f"({a['decode_steps']} decode steps) in {a['wall_s']:.2f} s "
          f"({a['wall_s'] / a['decode_steps'] * 1e3:.1f} ms a step); fleet "
          f"peak {fl['peak_groups']} groups, {fl['admits']} admits, "
          f"{fl['drains']} drains, {fl['crashes']} crash, "
          f"{fl['moved_slots']} slots moved ({fl['migration_bytes']} B), "
          f"{fl['device_steps']} device-steps; {res['requeues']} requeues, "
          f"{len(res['failed_requests'])} failed, deflations "
          f"{[(e['step'], e['group'], e['multiplier']) for e in deflate]}; "
          f"launches {a['launches']}; tokens without the fleet: "
          f"{'equal' if not a['ties'] else a['ties']}")
    events = a["events"]["fleet"] + [e for e in a["events"]["resilience"]
                                     if e["kind"] != "crash"]
    print(f"  (a) events, equal step for step to the CPU twin's: "
          + "; ".join(f"{e['step']} {e['kind']} g{e['group']}"
                      for e in sorted(events, key=lambda e: e["step"])))
    with phase_stats("25 (b) failed handoffs, full size"):
        b = F.serve_transfer(model, zero_counts=main_path)
    r, dg = b["report"]["resilience"], b["report"]["disagg"]
    print(f"  (b) {len(b['report']['per_request'])} requests in "
          f"{b['steps']} steps, {b['wall_s']:.2f} s; {r['transfer_failures']}"
          f" failed handoffs ({r['transfer_retries']} of a retried "
          f"attempt), {dg['transferred']} transferred; launches K1 "
          f"{b['K1']}, K4 {b['K4']}")
    del model
    torch.cuda.empty_cache()
    with phase_stats("25 (d) K4 on every placement the fleet held"):
        rows = F.k4_on_placements(a["held"], LoadTrace.load(str(a["trace"])),
                                  cfg.num_layers)
    for row in rows:
        print(f"  (d) from step {row['step']}: {row['devices']} devices "
              f"({row['empty_devices']} empty), weights {row['weights']}, "
              f"most replicas {row['replicas_max']}; K4 = plain on "
              f"{row['batches']} steps' loads, max load over the LP's "
              + ", ".join(f"{x:.4f}" for x in row["max_load_over_lp"]))
    torch.cuda.empty_cache()
    with phase_stats("25 (e) reshard on the card"):
        e = F.reshard_on_card(a["held"], device, tmp)
    print(f"  (e) {e['old']} -> {e['new']} and back, 3 weights x "
          f"{F.RESHARD_LAYERS} layers: bit for bit, {e['gather_s']:.3f} s "
          f"for the forward gathers; one layer through a "
          f"{e['file_bytes']} B checkpoint file in {e['file_s']:.1f} s")
    torch.cuda.empty_cache()
    with phase_stats("25 (f) a MoE layer's time; plan and replay"):
        layer = F.time_layer(device)
        f = F.plan_and_replay(a["trace"], F.ROWS)
    best = f["plan"]["best"]
    print(f"  (f) one MoE layer call at {F.LAYER_TOKENS} tokens: "
          f"{[row['us'] for row in layer['rows']]} us, "
          f"{layer['us_per_token']:.4f} us a token; plan at slo "
          f"{f['slo_ms']} ms: {best['groups']} group(s), elastic cost "
          f"{f['plan']['elastic_cost']} against static "
          f"{f['plan']['static_cost']}, schedule "
          f"{[(s['step'], s['groups']) for s in f['plan']['schedule']]}; "
          f"replay {f['replay']['admits']} admits, {f['replay']['drains']} "
          f"drains, {f['replay']['device_steps']} device-steps")
    return {"K1": a["launches"]["K1"] + b["K1"],
            "K4": a["launches"]["K4"] + b["K4"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.engine import ServeConfig
    from repro_torch.kernels import grouped_matmul, sched, wkv6_chunk
    from repro_torch.launch.profile_forward import ARCH, BATCH, SEQ

    # 1. environment
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    device = torch.device("cuda", 0)
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; TF32 off")
    print(card)
    t_all = time.perf_counter()

    # 2. build: one nvcc for each source, started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        libs = list(pool.map(lambda build: build(),
                             (grouped_matmul.build, grouped_matmul.build_bwd,
                              wkv6_chunk.build, wkv6_chunk.build_bwd,
                              sched.build)))
    print(f"[2] built {', '.join(str(p.relative_to(ROOT)) for p in libs)} "
          f"in {time.perf_counter() - t0:.1f} s")

    olmoe = get_config("olmoe-1b-7b")
    serve_cfg = ServeConfig(max_batch=4, max_seq=16)
    mixtral = get_config("paper-mixtral-16x2b")
    print("[3] K1 against its plain version")
    record = phase_k1(olmoe, serve_cfg.max_batch, device)
    g = torch.Generator(device=device)
    g.manual_seed(4321)
    k1_mix = k1_decode_case(g, mixtral, serve_cfg.max_batch, device,
                            "(d) paper-mixtral-16x2b decode, etp 2")
    k1_mix["name"] = "grouped_ffn_flat (paper-mixtral-16x2b decode)"
    torch.cuda.empty_cache()

    print("[4] serve olmoe-1b-7b, full width and depth")
    record["launches"], k4_launches = phase_serve(olmoe, serve_cfg, device)
    torch.cuda.empty_cache()

    print("[5] card vs CPU through the whole path")
    phase_parity(get_config("paper-gpt-32x1.3b").smoke(), device)
    torch.cuda.empty_cache()

    print("[6] K2 against its plain version")
    k2 = phase_k2(olmoe, serve_cfg.max_batch, device)
    torch.cuda.empty_cache()

    rwkv = get_config(ARCH)             # the geometry the profiler measures
    print("[7] K3 against its plain version")
    k3 = phase_k3((BATCH * rwkv.num_heads, SEQ, rwkv.d_model // rwkv.num_heads),
                  device)
    k3s = phase_k3s(device)
    torch.cuda.empty_cache()

    print("[8] rwkv6-7b forward, full width and depth")
    k3["launches"] = phase_forward(rwkv, BATCH, SEQ, device)
    torch.cuda.empty_cache()

    print("[9] card vs CPU through the forward")
    phase_forward_parity(rwkv.smoke(), device)
    torch.cuda.empty_cache()

    print("[10] K4 against its plain version")
    k4 = phase_k4(device)
    k4["launches"] = k4_launches
    torch.cuda.empty_cache()

    print("[11] K1b against its plain version")
    k1_olmoe_train, k1b, k1_train = phase_k1b(device)
    torch.cuda.empty_cache()
    k1_mix_train, k1b_mix, k1_train_mix = training_geometry(
        device, "paper-mixtral-16x2b")
    k1b_mix["name"] = "grouped_ffn_flat_bwd (paper-mixtral-16x2b training)"
    torch.cuda.empty_cache()

    print("[12] train olmoe-1b-7b, full width, 4 layers")
    launched = phase_train(dataclasses.replace(olmoe, num_layers=4), device,
                           steps=6, k1_train=k1_train)
    k1_olmoe_train["launches"] = launched["K1"]
    k1b["launches"] = launched["K1b"]
    torch.cuda.empty_cache()

    print("[13] one train step, card vs CPU")
    from repro_torch.launch.check_train import CONFIGS
    phase_train_parity(device, [(name, 1) for name in CONFIGS])
    torch.cuda.empty_cache()

    print("[14] serve rwkv6-7b, full width and depth")
    k3s["launches"] = phase_rwkv_serve(rwkv, ServeConfig(max_batch=4,
                                                         max_seq=64), device)
    torch.cuda.empty_cache()

    print("[15] card vs CPU through the RWKV-6 serving path")
    phase_rwkv_parity(rwkv.smoke(), device)
    torch.cuda.empty_cache()

    print("[16] the scheduler core at the paper's groups")
    phase_sched_core()
    torch.cuda.empty_cache()

    print("[17] dense decoders, nothing cut: qwen1.5-0.5b and gemma-2b "
          "(no hand-written kernel on these paths)")
    qwen = get_config("qwen1.5-0.5b")
    for cfg in (qwen, get_config("gemma-2b")):
        with phase_stats(f"17 (a) serve {cfg.name}"):
            phase_serve_dense(cfg, serve_cfg, device)
        torch.cuda.empty_cache()
    with phase_stats("17 (b) train qwen1.5-0.5b"):
        phase_train(qwen, device, steps=2)
    torch.cuda.empty_cache()
    with phase_stats("17 (c) card vs CPU"):
        for name in ("qwen1.5-0.5b", "gemma-2b"):
            phase_parity(get_config(name).smoke(), device)
        phase_train_parity(device, [("qwen1.5-0.5b", 1)])
    torch.cuda.empty_cache()

    print("[18] serve paper-mixtral-16x2b, full width, 16 of its 32 layers "
          "(etp 2: 32 virtual experts)")
    with phase_stats("18 serve"):
        # reduced: depth, 32 -> 16 layers (26.17 B parameters, 104.7 GB in
        # f32, do not fit the card; 16 layers hold 13.12 B, 52.5 GB)
        k1_mix["launches"], _ = phase_serve(
            dataclasses.replace(mixtral, num_layers=16), serve_cfg, device)
    torch.cuda.empty_cache()
    with phase_stats("18 card vs CPU"):
        phase_parity(dataclasses.replace(mixtral.smoke(), etp=2), device)
    torch.cuda.empty_cache()

    print("[19] train paper-mixtral-16x2b, full width, 4 layers (etp 2)")
    with phase_stats("19 train"):
        # reduced: depth, 32 -> 4 layers (3.33 B parameters: f32 master,
        # gradients and two Adam moments take 53.3 GB)
        launched = phase_train(dataclasses.replace(mixtral, num_layers=4),
                               device, steps=4, k1_train=k1_train_mix)
        k1_mix_train["launches"] = launched["K1"]
        k1b_mix["launches"] = launched["K1b"]
    torch.cuda.empty_cache()
    with phase_stats("19 card vs CPU"):
        phase_train_parity(device, [("paper-mixtral-16x2b", 2)])
    torch.cuda.empty_cache()

    print("[20] K3b (K3's backward) against its plain version")
    with phase_stats("20 K3b"):
        k3b, k3_train = phase_k3b(device)
    torch.cuda.empty_cache()

    print("[21] train rwkv6-7b, full width, 8 of its 32 layers")
    with phase_stats("21 (a) train"):
        # reduced: depth, 32 -> 8 layers (7.29 B parameters: f32 master,
        # gradients and two Adam moments would take 116.6 GB; 8 layers hold
        # 2.024 B, 32.4 GB)
        launched = phase_train(dataclasses.replace(rwkv, num_layers=8),
                               device, steps=4, remat_step=True)
        k3b["launches"] = launched["K3b"]
        k3_train["launches"] = launched["K3"]
    torch.cuda.empty_cache()
    with phase_stats("21 (b) remat, 2 layers"):
        phase_remat_equal(dataclasses.replace(rwkv, num_layers=2), device)
    torch.cuda.empty_cache()
    with phase_stats("21 (c) checkpoint round trip"):
        phase_ckpt_roundtrip(rwkv.smoke(), device)
    torch.cuda.empty_cache()

    print("[22] telemetry, replacement and replication on olmoe-1b-7b "
          "(shadow mode on one device)")
    hook_serve_cfg = dataclasses.replace(serve_cfg, replacement=True,
                                         repl_check_every=4)
    with tempfile.TemporaryDirectory() as tmp:
        with phase_stats("22 (a)-(b) serve, full width and depth"):
            trace = phase_hooks_serve(olmoe, hook_serve_cfg, device,
                                      pathlib.Path(tmp))
        torch.cuda.empty_cache()
        with phase_stats("22 (c) train, full width, 4 layers"):
            phase_hooks_train(dataclasses.replace(olmoe, num_layers=4),
                              device, pathlib.Path(tmp))
        torch.cuda.empty_cache()
    with phase_stats("22 (d) the replicated placement through K4"):
        phase_replicated(trace)
    torch.cuda.empty_cache()

    print("[23] MicroEP across a 2 x 2 group of ranks sharing the card "
          "(gloo): olmoe-1b-7b")
    with tempfile.TemporaryDirectory() as tmp:
        plain_train = phase_group(olmoe, device, pathlib.Path(tmp))
    torch.cuda.empty_cache()

    print("[24] serving on the group, paid migrations, disaggregated fleets: "
          "olmoe-1b-7b")
    with phase_stats("24 (c) disaggregated on one device, full size"):
        k1_disagg = phase_disagg_one(olmoe, device)
    torch.cuda.empty_cache()
    with phase_stats("24 (c) card vs CPU"):
        phase_disagg_parity(get_config("paper-gpt-32x1.3b").smoke(), device)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        launched = phase_group_serve(device, pathlib.Path(tmp), plain_train)
    # the new paths' launches counted in: the one-device disaggregated run,
    # every rank's serving runs and (b)'s training
    record["launches"] += k1_disagg + launched["serve"]["K1"]
    k4["launches"] += (k1_disagg + launched["serve"]["K4"]
                       + launched["train"]["K4"])
    k1_olmoe_train["launches"] += launched["train"]["K1"]
    k1b["launches"] += launched["train"]["K1b"]
    torch.cuda.empty_cache()

    print("[25] elastic fleets and fault recovery in serving: olmoe-1b-7b")
    with tempfile.TemporaryDirectory() as tmp:
        fleet = phase_fleet(olmoe, device, pathlib.Path(tmp))
    # (a), (b) and (c)'s ranks: K4 and K1 once a MoE layer a decode step
    record["launches"] += fleet["K1"] + launched["fleet"]["K1"]
    k4["launches"] += fleet["K4"] + launched["fleet"]["K4"]
    print(f"all phases passed in {time.perf_counter() - t_all:.1f} s")

    print(card)
    print(json.dumps({"kernels": [record, k2, k3, k4, k1b, k3s,
                                  k1_olmoe_train, k1_mix, k1_mix_train,
                                  k1b_mix, k3b, k3_train]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
