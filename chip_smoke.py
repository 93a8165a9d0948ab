#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (alphafold2_tpu_torch) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. build    — compile every kernel source under alphafold2_tpu_torch/csrc
              with nvcc (sm_90a), one process per source, and load them;
1b. gate    — the port's pre-hardware analysis layer: the Hopper build gate
              (analysis/lowering.py: every case's launch plans and ptxas
              resources within sm_90's limits, f32 and bf16, and X's
              mis-tiled negative control refused by ptxas; K3's Hopper
              kernels and their merge, K4's and K5's Hopper kernels, at head
              dim 64 without a spill, and K4's at 32 and 128; K2's split
              passes at the MSA rows' and the PLM rows' training shapes,
              their registers, spills and shared memory, no spill); X's valid
              counterpart (scale_rows) bitwise against 2 * x at (4, 512),
              timed beside torch.mul; the launch-level control, a
              2048-thread block the card must refuse with
              cudaErrorInvalidConfiguration; and the graph audit
              (analysis/audit.py) of every target on the card, clean apart
              from reasoned waivers, its backward seen on the autograd
              engine's device threads;
2. kernels  — K1's plan on its nine main-path passes and the template
              axis must name its Hopper kernel (the packed kernel
              attention_packed_kernel_sm90<64> on the two MSA column passes
              and the template axis, as axial.packed_plan mirrors it;
              attention_kernel_sm90<64> on the other seven, and
              combine_kernel<64> where the key axis splits), and K2's plan on its serving,
              training and gate shapes and on one shape of each other
              Hopper instantiation tied_row_attention_kernel_sm90<D, C>
              (head dims 32/64/128, 64 or 128 columns a block) as
              tied_row.hopper_plan gives it, R*D 1280 and unaligned
              operands attention_kernel_mma<64>; hold each forward kernel
              (K1, K2) against its plain PyTorch version on the card at the
              serving path's shapes (f32 and bf16) plus ragged tails, a
              5-key pass, fully masked rows, other head dims and a negative
              scale, each bf16 serving pass and each bf16 K2 shape the
              Hopper kernel takes launching it (the MSA column pass the
              packed kernel) and repeating bit for bit,
              K2 with a control that drops each row's last key tile; time
              the kernel (and its host time a call), the plain version and
              torch's scaled_dot_product_attention (a yardstick the port
              never calls);
3. backward — the same for K1's training forward (with the row logsumexp,
              the split pass repeating bit for bit) and K1's combine pass
              alone, and the backward kernels K3a (dq) and K3b (dk, dv) at
              the training path's shapes and the edge cases, per tensor: K3's
              plans on the five training passes must name dq_kernel_sm90<64>
              and dkv_kernel_sm90<64> with their splits (7 on the cross
              passes), each bf16 training pass must launch them, and the
              merge pass exactly where it splits; a negative control that
              drops each row's last key tile (dq) or query tile (dk, dv); on
              the split passes the merge kernel alone against its plain
              version and a merge that drops the last split, which must be
              rejected; two runs bit-identical; SDPA's backward as the
              yardstick;
3b. head dims — K1, K1 with lse, K3a and K3b at head dims 48 (zero-padded
              to 64) and 256 (as 4 rows of 64: bf16 K1 with and without
              lse on tied_row_attention_kernel_sm90, repeating bit for bit,
              with a control that drops each row's last key tile, f32 K1
              D-chunked; K3a/K3b bf16 on tied_dq_kernel_sm90 /
              tied_dkv_kernel_sm90) against their plain versions, f32 and
              bf16; the autograd route through the kernels alone, bit for
              bit the direct calls;
3c. tied    — K2's backward plans (check_k2_bwd_plans: every Hopper
              instantiation tied_dq_kernel_sm90<D, C> and
              tied_dkv_kernel_sm90<D, 64> at one shape each, as
              tied_row.hopper_bwd_plan gives it; R*D 512, unaligned operands
              and f32 on the chunked kernels); K2 with the row logsumexp and
              K2's backward (dq; dk and dv, csrc/tied_row_attention_bwd.cu)
              against their plain versions at the tied training shape
              (1x5x64x8x64, R*D 320) and JAX's gate shape (1x8x256x4x64,
              R*D 512), f32 and bf16, with ragged rows and masked columns,
              bf16 K2 with lse on tied_row_attention_kernel_sm90 and
              repeating bit for bit (out and lse), bf16 K2's backward on
              its Hopper kernels wherever the plan takes the shape (the
              training shape; R*D 512 stays chunked); a negative control
              per kernel that drops the last 64-wide feature chunk; two
              backward runs bit-identical; the autograd route through the
              kernels alone; SDPA on the folded (B, H, N, R*D) tensors as
              the yardstick, with the backend that takes that head dim
              named;
4. serve    — a small model must agree between the card and the CPU's
              plain versions; the refiner's streamed edge attention must
              agree with its dense path on the card (f32, threshold
              lowered); a ServeEngine at full model width (dim 256, depth
              6, heads 8, dim_head 64, bf16 compute, tied MSA rows, the
              default ladder 64/96/128/192/256 at batch 4, buckets 192 and
              256 streaming the refiner) warms up every bucket and serves
              twelve requests of 50-256 residues; launch counts must show
              both forward kernels on the path, every K1 and K2 launch on
              its Hopper kernel, and no plain-version call; a
              request served alone and in a batch must agree; one request
              with serve.return_distogram must bring back (3L, 3L, 37)
              logits; serve.dtype=bfloat16 (every parameter cast) serves
              the six requests of 50-128 residues with finite atom14,
              timed beside the f32-parameter figure, one request's
              distogram logits within tests/test_precision.py's 5% of the
              f32-parameter engine's; an engine built from a 2-step
              end-to-end checkpoint equals predict(checkpoint_dir=) bit for
              bit; a bucket-128 and a bucket-256 batch are profiled;
4b. serve_async — the serving plane at the serving width, depth 3
              (SERVE_DEPTH; Config()'s 6 halved for the whole pass's time
              limit; phase_serve keeps 6), its own seeded weights: the
              twelve requests through a pipelined (depth 2:
              copy stream, compute stream, pinned rings) and a serial engine
              with return_distogram, every result ok and finite, distogram
              logits and weights within 1e-5 relative of each other; each
              path timed twice in turns (residues/s) and profiled once
              (device idle share); then an open-loop Poisson burst of 32
              requests at 0.8 x the serial request rate through
              AsyncServeFrontend: four repeats (cache hits), a 128-residue
              parent and six point mutants (delta featurization), one
              compute-stage fault (retried on the next rung), one passed
              deadline; the feature ledger equal to the dispatched
              requests; p50/p95/p99 latency, counters, span totals, peak
              memory; every K1/K2 launch on its Hopper kernel, no plain
              version, in every run;
4c. serve_fleet — the multi-replica fleet: 2 replicas on the one card
              from FleetFrontend.build (replica 1 serves replica 0's
              module: the same parameter tensors); the twelve requests
              through the fleet within 1e-3 A of serve_async's atom14, both
              replicas served; one bucket-128 batch on both replicas'
              device threads at once, bit-equal to one alone with exactly
              twice its K1/K2 launches; a seeded Poisson stream of 20
              requests (2 repeats) at 1.5 x the serial request rate through
              a 1-replica and the 2-replica fleet: goodput, p50/p95/p99,
              device idle share (profiler on), peak memory, /metrics and
              /healthz scraped (the zero-seeded fleet.* counters,
              sched.depth), the SLO monitors' verdicts per replica and
              aggregated, the stream's MFU; the stream again with replica 1
              degraded by 0.05 s a dispatch, and with replica 1 killed at
              40% of the 2-replica wall (nothing unresolved, a drain, trace
              completeness >= 0.99 across the router hop); a compute-stage
              fault on bucket 64 whose flight-recorder dump holds the
              batch's dispatch_error note and a scrubbed env; the 1-replica
              run's workload log loaded, rebuilt by build_replay and
              replayed to the same statuses; a liveness watchdog with the
              CUDA probe over every stage (the replay's deadline shorter
              than its run: the probe answers alive); flops_share > 0 on
              every ok result, flops in every compile record, the card's
              count of a tiny key equal to the CPU's; every K1/K2 launch on
              its Hopper kernel, no plain version, in every run;
4a. lattice — right after serve, on its engine (every rung warmed):
              analysis/budgets.py lattice_report, each rung's peak_bytes,
              parameters, flops and verdict against 0.9 of the card's
              memory, all passing, no forward run again;
4f. long_mesh — right after the lattice: long-chain serving on a device
              mesh, one rank of a world-size-1 NCCL group in a subprocess
              started with torchrun's environment, a (1, 1, 1) grid mesh,
              model.grid_parallel: the serving configuration (depth 3,
              SERVE_DEPTH) at full width
              (ladder 64 plus the long rungs 512 and 768 at long_max_batch
              1, which phase_long_meshless measured to fit the card without
              a mesh) serves one request of 492 and one of 748 residues
              through ServeEngine(mesh=): finite atom14, every K1 and K2
              launch on its Hopper kernel and no plain call, the census of
              collectives a forward makes (every all_to_all, all_reduce and
              all_gather in place), the distogram within
              tests/test_precision.py's relative L2 bound of the same
              model's meshless forward, lattice_report passing on every
              rung; each rung's forward (median of 2, in turns with the
              meshless one), peak memory,
              mesh_mfu and launches; then the collective audit
              (analysis/hlo_audit.py --check) on the card's NCCL world,
              clean, with each target's measured peak against its budget.
              (probe_gloo_cuda, not part of the run, found gloo taking
              every collective of the grid path on CUDA tensors,
              reduce_scatter_tensor too, and aborting in batch_isend_irecv,
              the ring's: four ranks on the one card serve rung 96 on a
              1x2x2 grid; the ring is held on the CPU's gloo ranks only);
4d. kernel_policy — the kernel switchboard (ops/kernels.py): the serving
              config at bucket 128 x batch 4 under the default policy,
              the hand kernels by name, axial=stock,flash=on (SDPA) and
              axial=dense,flash=off,tied_row=dense (the plain versions), one
              engine each over one parameter set: the named spec bit-equal
              to the default, SDPA and plain within the bf16 serving bound,
              K1/K2 launches and plain calls only where asked for, the
              policy in each engine's key and compile records, regress
              refusing a cross-policy comparison; each policy's forward
              time, launches and counted flops, the span-based idle share;
              one SparseAttention pass under block_sparse=pallas/jnp/splash
              (K4 only under pallas, within 1e-4 in f32);
4e. predict_cli — predict.main in-process on 128 residues at the serving
              config (K1/K2 on their Hopper kernels, no plain call, the PDB
              read back), then python -m alphafold2_tpu_torch.predict once
              as a subprocess (rc 0, the summary line);
5. train    — distogram pretraining at the same width at depth 3
              (ENGINE_DEPTH, Config()'s 6 halved for the whole pass's time
              limit; untied MSA rows, crop 128, MSA 5x64, batch 1,
              accumulation 16): 32 steps whose
              launch counts must show K1, K3a and K3b on every attention
              (every K1 and K3 launch on its Hopper kernel, K3's merge pass
              on the split passes, 5 a step at depth 3 and 11 at depth 6)
              and no plain-version call, the
              first accumulated update at lr 0;
              12 steps on one repeated batch whose loss must fall; a small
              f32 model whose gradients must agree between the card and the
              CPU; one step under torch.profiler; then all of it again with
              model.msa_tie_row_attn=True (K2 with lse, every launch on
              tied_row_attention_kernel_sm90, and K2's backward on every
              MSA row pass, every launch on tied_dq_kernel_sm90 and
              tied_dkv_kernel_sm90);
6. sparse   — the block-sparse kernels K4 (forward, with and without the
              row logsumexp), K5a (dq) and K5b (dk, dv) against their plain
              versions per tensor at the sparse training path's pair pass
              and at a long, an unaligned, a block-128, a block-32, a
              dead-row, a disjoint-lists and a negative-scale problem, f32
              and bf16; K4's and K5's plans, and every bf16 case at head
              dim 32/64/128 launching K4's and K5's Hopper kernels
              (sparse_fwd_kernel_sm90, sparse_dq_kernel_sm90,
              sparse_dkv_kernel_sm90, which stream the union of each 64-row
              tile's lists); rows without a valid key exactly 0; a
              negative control dropping each query block's last valid
              active block (K4, K5a) or each key block's last query block
              (K5b); two forward and two backward runs bit-identical; SDPA
              with the element-level layout and key mask as the yardstick;
7. sparse train — the training phase's checks with
              model.sparse_self_attn=True: every pair axial pass through
              K4/K5a/K5b (every K4 and K5 launch on its Hopper kernel), the
              rest through K1/K3a/K3b, small-model
              gradients on the grid route (crop 48) and the flat route
              (crop 40), one step under torch.profiler;
7b. train_mesh — training on a device mesh (phase_train_mesh): one rank
              of a world-size-1 NCCL group (a subprocess with torchrun's
              environment): (a) the training smoke's width at ENGINE_DEPTH,
              dense, tied and sparse, 3 steps meshless, on a (1, 1) mesh and on a 1x1x1 grid
              in turns from one initial state (loss and every gradient
              within the bf16 bound of the meshless step's; every launch on
              Hopper, no plain version; one step's census); the reversible
              engine, untied and tied, on the (1, 1) mesh only (it refuses
              grid_parallel, as JAX's does), and a tied template pass (4
              templates, 2 template blocks) forward and backward, likewise;
              (b) crop 768,
              MSA 5x128, remat, on a 1x1x1 grid, dense and sparse, 3 steps
              after the meshless step's peak, K3a and K3b held at the long
              cross passes' own call shapes; (d) the end-to-end step at its
              CLI's width meshless and on a (1, 1) mesh, also on the
              reversible engine; then (c) four gloo ranks on the card, a
              1x2x2 grid sparse with tied rows, a 2x2 (dp, sp) mesh dense
              and one reversible tied at depth 2, crop 64, batch 2, 2 steps
              each against the world-size-1 rank's (loss within 1e-2,
              every gradient within 0.05 relative L2, parameters identical
              on every rank, every launch on Hopper);
8. end2end  — end-to-end structure training at the end-to-end CLI's width
              (dim 256, depth 1, crop 64: 192 atom tokens, 896 refiner
              atoms, 200 MDS iterations), untied then tied MSA rows: a
              small f32 model's loss and gradients on the card against the
              CPU's plain versions; 4 steps through train_end2end, every
              one finite and unskipped with gradients in the trunk and the
              refiner, K1 and K3 (and with tied rows K2 and its backward)
              launched on their Hopper kernels, no plain version; 8 steps
              on a repeated batch whose loss must fall; a checkpoint
              resumed into a fresh model equal to an uninterrupted run bit
              for bit, and predict from it equal to predict(state_dict=);
              the step alone timed, profiled, and split into trunk,
              structure (MDS), refiner and loss; the two steps in turns;
9. engines  — the trunk engines at the training smoke's width at depth
              3 (ENGINE_DEPTH, the whole pass's time budget): the
              default, remat (no policy, "dots", "dots_no_batch"), scan,
              scan+remat, reversible, tied and sparse reversible, and
              end-to-end training at its CLI's width with remat and with
              reversible: 3 steps each through train.loop.train or
              train_end2end (finite, unskipped, every launch on its
              Hopper kernel, no plain version, launches a step as each
              schedule gives them), then the step alone timed with its peak
              memory; one remat and one reversible step profiled; remat and
              scan against the default engine at full width (loss and
              gradients, bit-equal or the worst leaf); a small f32
              reversible model on the card against the CPU's plain
              versions; RevLayerPair's inversion at full width, one
              layer and six (f32 compute; bf16 on the f32 carry; bf16 on a
              bf16 carry); the reversible backward against plain autograd
              at full width, f32 and bf16; peak
              memory at depth 3 and 6 for the default, remat and
              reversible engines; serving with model.remat=True equal to
              remat=False on one bucket-128 batch;
10. telemetry — dropout, numerics and the training telemetry at the
              training smoke's width at ENGINE_DEPTH (the triage run at
              depth 6): 2 steps each through train.loop.train
              without dropout (the yardstick), with attn and ff dropout 0.1 (JAX's dense route on every
              dense attention: no K1 or K3 launch), ff dropout only (K1 18,
              K3a/K3b 17 a step), tied rows with ff dropout (K2 and its
              backward) and sparse with attn dropout (K4/K5 on the flat
              route, its output dropped): finite, unskipped, every launch
              on its Hopper kernel, launches a step as the dropout gate
              gives them, the step alone and its peak memory; one attn+ff
              dropout step profiled (device busy, host ops, launches); remat
              bit-equal to the default engine under one dropout key (both
              configurations) and the f32 reversible backward within 1e-4
              of plain autograd under one; the step alone with numerics
              "off", "norms" (train.numerics="triage") and "full", in
              turns; a run whose trunk layer 3
              turns NaN, whose NaN triage must name trunk.layer_3.pair one
              step late with the reruns launching K1 and K3 as a step does;
              a train.trace_events span trace with a train.step span a step
              and the numerics counters, and a train.profile_dir window whose Chrome trace holds the
              card's kernels. Each line carries the card's name and power
              limit;
10b. train_flops — the training step's flops and MFU: a dense, a tied and
              a sparse step at the training smoke's width (crop 128) at
              ENGINE_DEPTH, each counted on the kernels (FlopCounterMode
              over the ops and every wrapper's announced analytic tally:
              K1 with lse, K3a, K3b, K2 and its backward, K4, K5a and K5b,
              the backward's on autograd's device thread; the sparse
              step's flops over the active block pairs beside), on the plain
              versions through the same autograd Functions (what the CPU
              counts: equal within 1e-9 relative) and under the kernel
              policy's plain route (equal to the kernels' count less their
              recompute of S and dP); a sparse_self_attn serving key at
              bucket 128 under the default and the plain policy (equal);
              train.loop.train for 5 steps with a span trace and
              metrics.jsonl (step_flops at step 0, then steps_per_sec,
              model_flops_per_s and mfu, in (0, 1] and step_flops x
              steps_per_sec over 989.4e12); the losses through
              device_prefetch bit-equal to a hand loop of device_put_batch,
              the train.next_batch span beside the synchronous copy's host
              ms; python -m alphafold2_tpu_torch.observe.report on the run's
              artifacts (rc 0, mfu in its train section). (msa_rows counts
              a row-sharded step likewise: the split passes' logits and
              products tallied, equal to tied_row=dense's count.) Prints
              ``train_flops {json}``;
11. slice kernels — the kernels on the template and PLM paths' new shapes:
              K1 (without and with lse), K3a and K3b on the whole
              template-axis launch (147456 x 8 problems of 5 x 5 at head
              dim 64: crop 384, 4 templates), held against the plain
              versions on the batch's first and last 8192 rows, f32 and
              bf16, bf16 on the Hopper kernels with no split (K1 on the
              packed kernel, out and lse repeating bit for bit, a control
              without each problem's last valid key), timed beside SDPA;
              K2 with lse and its backward on the PLM grid's tied rows at
              R*D 8192 (timed beside SDPA) and 12288, the chunked kernels'
              shapes;
12. templates — a small f32 template model (with and without the SE(3)
              sidechain embedder) on the card against the CPU's plain
              versions, every gradient leaf; bench_suite.py config_4 at
              full width (dim 256, depth 2, 2 template blocks, crop 384,
              MSA 16x128, 4 templates, bf16) through Alphafold2.forward
              under a gradient, without and with the SE(3) embedder: 3
              passes from launch counts of 0 (K1 20, K3a/K3b 19, K2 2 and
              its backward 2 a pass, every K1 and K3 launch on its Hopper
              kernel), then the pass alone and its peak memory, one pass
              profiled;
13. plm       — small f32 distogram and end-to-end models on the plm
              stream against the CPU; the training smoke on the plm stream
              (crop 128, depth 3 (PLM_DEPTH, the time budget), untied and tied, the hash provider and an .npz
              the phase writes for the precomputed one, whose losses must
              equal the hash runs') for 3 steps through train.loop.train,
              and end-to-end training at its CLI's width (untied, tied) for
              2 steps through train_end2end: finite, unskipped, launches a
              step as the schedule gives them, K2 and its backward on the
              chunked kernels their plans name at R*D 8192 and 12288, the
              step alone and its peak memory, a tied step of each kind
              profiled; predict on the card with each
              of cross_attn_compress_ratio, msa_row_shard, grid_parallel and
              context_parallel bit-equal to the plain config;
14. compress  — KV compression (model.cross_attn_compress_ratio): a small
              f32 model of config_3's structure on the card against the
              CPU, every gradient leaf (kv_compress's among them); K1, K1
              with lse, K3a and K3b on the compressed pair<-MSA pass
              (262144 x 342 at head dim 64) against their plain versions,
              f32 and bf16, bf16 on the Hopper kernels, timed beside SDPA;
              scripts/bench_suite.py config_3 at full width (dim 256,
              depth 12, crop 512, MSA 8x128, block-sparse every other
              layer, compression 3, remat, bf16) for 2 steps through
              train.loop.train: finite, unskipped, launches a step as its
              schedule gives them, every K1/K3/K4/K5 launch (the compressed
              pass's among them) on its Hopper kernel, no plain version;
              the step alone, its peak memory, one step profiled;
15. data      — local data, evaluation and relaxation: synthetic
              backbones written as PDB files with the port's save_pdb,
              converted by import_pdbs; the distogram loop at the training
              smoke's width for 3 steps on data.source=npz (checkpointed),
              native over the shards and native synthetic; the native
              loader's labels against get_bucketed_distance_matrix on the
              card; each loader's batches/s; evaluate --checkpoint
              --realize over 2 batches (finite, the forward's ms); a
              predicted backbone relaxed for 200 iterations through
              refinement's run_native_relax (the energy falls, its ms).
16. tools     — the port's tools and examples: profile_step at its
              defaults (dim 256, depth 2, crop 256, MSA 16x256, tied, bf16)
              with 2 profiled steps, its top 15 device-lane rows and the
              copy rows named, every launch on Hopper; bisect_perf at its
              defaults under the hand kernels, SDPA and the plain versions;
              validate_structure_math (ALL OK); examples 01-05 at their
              full shapes in one process (runpy) under torchrun on one
              NCCL rank, each ending in ok.

``phase_k1_time`` (not part of the run) times K1 alone on its nine
main-path passes beside SDPA: ``python3 -c "import chip_smoke as c;
c.phase_build(); c.phase_k1_time()"`` (``phase_k1_device_time`` with device
times); ``phase_k1_packed_time`` K1 on its short passes (the template axis,
the MSA column passes of serving, training, config_4 and config_3) beside
SDPA, with device times and bounds; ``phase_config4_pass`` config_4's
template pass alone with its peak memory; ``phase_k3_time`` likewise times K3a
and K3b on the five training passes beside SDPA's backward, per pass and
per step; ``phase_k5_time`` K5a and K5b (and K4, with K1 with lse on the
dense problem of the same shape) on the sparse training pass and at N 512
beside SDPA with the layout mask, per pass and per sparse step;
``phase_k2_time`` K2, K2 with lse and K2's backward on the tied passes
beside SDPA, with device times; ``phase_d256_time`` K1 without and with
lse, K3a and K3b at head dim 256 beside SDPA's forward and backward;
``phase_registers`` every Hopper instantiation's registers and spills; the
template and PLM phases run alone after ``phase_build``:
``python3 -c "import chip_smoke as c; c.phase_build(); c.phase_slice_kernels();
c.phase_templates(); c.phase_plm()"``, and likewise KV compression and the
local-data phase: ``python3 -c "import chip_smoke as c; c.phase_build();
c.phase_compress(); c.phase_data()"``, and the fleet:
``python3 -c "import chip_smoke as c; c.phase_build(); c.phase_serve_fleet()"``,
and the kernel policy, CLI and lattice phases: ``python3 -c "import chip_smoke as c;
c.phase_build(); c.phase_kernel_policy(); c.phase_predict_cli(); c.phase_lattice()"``,
and the mesh phase: ``python3 -c "import chip_smoke as c; c.phase_build();
c.phase_long_mesh()"`` (``phase_long_meshless`` the serving forward without a
mesh at the long rungs, which decided the long ladder; ``probe_gloo_cuda``
whether gloo takes CUDA tensors).
``chip_compare.sh`` runs them, or any other phases, for two checkouts in
turns.

Prints the card's name and power limit, then a JSON line describing every
kernel, and last ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero without that line. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor core; f32 CUDA core

# Each case is held to bounds scaled to its own output, so a shape whose
# outputs are small (a long key axis averages them down) is held as tightly
# as one whose outputs are large: max|kernel - plain| <= MAX_REL * max|plain|
# and ||kernel - plain||_2 <= L2_REL * ||plain||_2.
# On an H100 the kernels came to rel_l2 <= 2.6e-3 and max ratio <= 5.5e-3
# in bf16, and rel_l2 <= 4.9e-6 in f32; a kernel skipping its last key tile
# comes to rel_l2 >= 2.4e-2 (the 640 x 147456 cross pass) and is rejected.
TOL = {  # (MAX_REL, L2_REL)
    "float32": (1e-4, 2e-5),  # same f32 arithmetic, other summation order
    # the kernel rounds probabilities to bf16 for P @ V (2^-9 relative),
    # both round the output to bf16 (one ulp apart is 2^-8..2^-7 relative)
    "bfloat16": (2**-6, 4e-3),
}
MAX_PLAIN_LOGITS_BYTES = 2 << 30  # the plain version runs in batch slices below this
# a small f32 model's gradients, card vs CPU: per-leaf relative L2 error
GRAD_REL_L2 = 1e-4
STEP_REPS = 6  # steps timed back to back in the training phase
TRAIN_REPEAT_STEPS = 12  # the training phase's steps on one repeated batch


class PhaseError(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


def require(cond, msg):
    if not cond:
        raise PhaseError(msg)


# --------------------------------------------------------------- timing


def cuda_ms(fn, reps=3, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------- phase 1


def phase_build():
    from alphafold2_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    paths = build.build_all()
    for name in paths:
        build.library(name)
    secs = time.perf_counter() - t0
    # each instantiation's registers, spills and shared memory: the gate phase
    log(f"[build] {len(paths)} kernels built and loaded in {secs:.1f} s")
    return secs


# --------------------------------------------------------------- phase 1b


def _log_gate(records, summary):
    from alphafold2_tpu_torch.analysis import lowering

    for rec in records:
        if rec["case"] == lowering.CONTROL_CASE:
            log(f"[gate] {rec['case']}: nvcc exit {rec['nvcc_exit']}, "
                f"{'refused' if rec['rejected'] else 'NOT REFUSED'}: "
                f"{rec.get('refusal') or rec.get('error')}")
            continue
        for ln in rec["launches"]:
            log(f"[gate] {rec['case']} {ln['role']} {ln['dtype']} {ln.get('kernel', '?')}: "
                f"blocks {ln.get('blocks')}, threads {ln.get('threads')}, registers "
                f"{ln.get('registers')}, barriers {ln.get('barriers')}, smem "
                f"{ln.get('static_smem')} static + {ln.get('dynamic_smem')} dynamic, stack "
                f"{ln.get('stack_frame')}, spills {ln.get('spill_stores')}/"
                f"{ln.get('spill_loads')} B; {'; '.join(ln['problems']) or 'ok'}")
        for w in rec.get("warning", ()):
            log(f"[gate] {rec['case']} warning: {w}")
    log(f"[gate] {json.dumps(summary)}")


def _sm90_resources(sources=("fused_attention", "fused_attention_bwd", "block_sparse_attention",
                             "block_sparse_attention_bwd", "tied_row_attention",
                             "tied_row_attention_bwd")):
    """{instantiation: (registers, spill stores, spill loads)} of every
    Hopper kernel (a name with ``_sm90``, or K2's wide route's
    ``tied_wide_``) in the build reports of ``sources``, as ptxas gave
    them."""
    from alphafold2_tpu_torch.analysis import lowering
    from alphafold2_tpu_torch.ops.cuda import build

    found = {}
    for name, (code, report, _) in build.build_sources(sources).items():
        require(code == 0, f"{name} did not build")
        for key, res in lowering.report_by_kernel(report, lowering.demangle_cufilt).items():
            if "_sm90" in key or key.startswith("tied_wide_"):
                found[key] = (res.registers, res.spill_stores, res.spill_loads)
    return dict(sorted(found.items()))


def phase_registers():
    """Log every Hopper instantiation's registers and spills (the build
    reports of K1, K2, K2's backward, K3, K4 and K5), so chip_compare.sh can
    set a parent's beside this tree's."""
    for name, (regs, stores, loads) in _sm90_resources().items():
        log(f"[registers] {name}: {regs} registers, spills {stores}/{loads} B")


SPLIT_GATE_CASES = ("split_msa_rows_320", "split_plm_rows_8192")  # 4 f32 + 5 bf16 launches


def phase_gate():
    """The analysis layer on the card: the build gate, X's counterpart and
    its launch-level control, the audit of every target. Every part runs;
    the phase then fails with all the problems found."""
    import torch

    from alphafold2_tpu_torch.analysis import audit, lowering
    from alphafold2_tpu_torch.ops.cuda import build, controls

    problems = []

    def check(cond, msg):
        if not cond:
            log(f"[gate] FAILED: {msg}")
            problems.append(msg)

    t0 = time.perf_counter()
    try:
        records, summary = lowering.run_gate()
    except (lowering.ToolMissing, RuntimeError, OSError, subprocess.SubprocessError) as e:
        traceback.print_exc()
        check(False, f"the build gate did not run: {type(e).__name__}: {e}")
    else:
        _log_gate(records, summary)
        log(f"[gate] build gate: {summary['cases']} cases in {time.perf_counter() - t0:.1f} s")
        check(not summary["failed"], f"build gate failed: {summary['failed']}")
        check(summary["control_rejected"], "the mis-tiled control was not refused by ptxas")
        # K3's Hopper kernels and their merge at the main path's head dim
        # must not spill
        spills = {ln["kernel"]: (ln.get("spill_stores"), ln.get("spill_loads"))
                  for rec in records for ln in rec.get("launches", ())
                  if ln.get("kernel") in (*K3_SM90, "grad_merge_kernel<64>")}
        check(set(spills) == {*K3_SM90, "grad_merge_kernel<64>"},
              f"the gate planned K3's Hopper kernels only as {sorted(spills)}")
        check(all(x == (0, 0) for x in spills.values()), f"K3's Hopper kernels spill: {spills}")
        # nor K5's, which run K3's consumers on gathered stages
        k5 = {ln["kernel"]: (ln.get("registers"), ln.get("spill_stores"), ln.get("spill_loads"))
              for rec in records for ln in rec.get("launches", ()) if ln.get("kernel") in K5_SM90}
        log(f"[gate] K5's Hopper kernels at head dim 64 (registers, spill stores, loads): {k5}")
        check(set(k5) == set(K5_SM90), f"the gate planned K5's Hopper kernels only as {sorted(k5)}")
        check(all(x[1:] == (0, 0) for x in k5.values()), f"K5's Hopper kernels spill: {k5}")
        # nor K2's split passes (MSA rows sharded over a mesh) at the shapes
        # the card trains
        split = {(rec["case"], ln["dtype"], ln.get("kernel")): (
            ln.get("registers"), ln.get("spill_stores"), ln.get("spill_loads"),
            ln.get("static_smem", 0) + ln.get("dynamic_smem", 0))
            for rec in records if rec["case"] in SPLIT_GATE_CASES for ln in rec.get("launches", ())}
        log("[gate] K2's split passes (registers, spill stores, spill loads, shared bytes): "
            + "; ".join(f"{c} {d} {k}: {v}" for (c, d, k), v in split.items()))
        check(len(split) == 9 * len(SPLIT_GATE_CASES),
              f"the gate planned K2's split passes only as {sorted(split)}")
        check(all(v[1:3] == (0, 0) for v in split.values()), f"K2's split passes spill: {split}")
        # nor K4's (K1's consumer pieces on K5a's gathered stages), which the
        # gate plans at head dim 64 and 128, at any head dim it is built for
        planned = {ln.get("kernel") for rec in records for ln in rec.get("launches", ())}
        check(K4_SM90 in planned, f"the gate did not plan K4's Hopper kernel {K4_SM90}")
        fwd = {name: res for name, res in _sm90_resources(("block_sparse_attention",)).items()
               if name.startswith("sparse_fwd_kernel")}
        log(f"[gate] K4's Hopper instantiations (registers, spill stores, loads): {fwd}")
        check(len(fwd) == 3 and all(res[1:] == (0, 0) for res in fwd.values()),
              f"K4's Hopper instantiations at head dim 32/64/128: {fwd}")
        # nor K1's packed kernel, which the gate plans at head dim 32, 64 and
        # 128, nor K2's walk that K1 takes past head dim 128
        packed = {name: res for name, res in _sm90_resources(("fused_attention",)).items()
                  if name.startswith("attention_packed_kernel_sm90")}
        log(f"[gate] K1's packed instantiations (registers, spill stores, loads): {packed}")
        check({f"attention_packed_kernel_sm90<{d}>" for d in (32, 64, 128)} <= planned,
              "the gate did not plan K1's packed kernel at head dim 32, 64 and 128")
        check(len(packed) == 3 and all(res[1:] == (0, 0) for res in packed.values()),
              f"K1's packed instantiations at head dim 32/64/128: {packed}")
        check("tied_row_attention_kernel_sm90<64,128>" in planned,
              "the gate did not plan K1 at head dim 256 on K2's walk")

    # X at its own shape: the path is one launch at (4, 512) f32
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(controls.X_SHAPE, device="cuda", generator=gen)
    controls.scale_rows.launches = 0
    out = controls.scale_rows(x)
    torch.cuda.synchronize()
    launches = controls.scale_rows.launches
    ref = controls.scale_rows_reference(x)
    check(launches == 1, f"scale_rows launched {launches} times")
    check(torch.equal(out.view(torch.int32), ref.view(torch.int32)),
          "scale_rows is not bitwise 2 * x")
    err = float((out - ref).abs().max())
    nbytes = 2 * x.numel() * x.element_size()  # read x once, write o once: 16 KiB
    row = {"label": "X (4, 512) f32", "kernel": "scale_rows", "dtype": "float32",
           "max_abs_err": err, **_bound(float(x.numel()), nbytes, torch.float32)}
    row["ms"] = cuda_ms(lambda: controls.scale_rows(x), reps=200, warmup=10)
    row["plain_ms"] = cuda_ms(lambda: controls.scale_rows_reference(x), reps=200, warmup=10)
    row["library_ms"] = cuda_ms(lambda: torch.mul(x, 2), reps=200, warmup=10)
    log(f"[gate] scale_rows (4, 512) f32: bitwise equal to 2 * x (max_abs_err {err}); kernel "
        f"{row['ms']:.5f} ms, plain {row['plain_ms']:.5f} ms, torch.mul {row['library_ms']:.5f} "
        f"ms, bound {row['bound_ms']:.6f} ms ({row['bound_by']}, {nbytes} bytes)")

    # the launch-level control: the same kernel with a (1, 2048)-thread block
    try:
        controls.scale_rows(torch.zeros(controls.LAUNCH_CONTROL_SHAPE, device="cuda"))
        check(False, "a 2048-thread block of scale_rows launched")
    except build.KernelLaunchError as e:
        log(f"[gate] launch control (1, 2048): refused, {e}")
        check(e.code == controls.INVALID_CONFIGURATION,
              f"the launch control failed with CUDA error {e.code}, not "
              f"cudaErrorInvalidConfiguration ({controls.INVALID_CONFIGURATION})")
    torch.cuda.synchronize()

    # the graph audit of every target, on the card
    t0 = time.perf_counter()
    reports = audit.audit(device="cuda")
    for r in reports:
        log(f"[gate] audit {r.target} on {r.device}: {r.ops} ops, {len(r.findings)} findings, "
            f"{len(r.waived)} waived; memory {r.budget['verdict']} "
            f"({r.budget.get('program_bytes')} of {r.budget.get('budget_bytes')} bytes); "
            f"autograd nodes {list(r.nodes)}")
        for f in r.findings:
            log(f"[gate] audit finding {f.format()}")
        for f in r.waived:
            log(f"[gate] audit waived {f.format()}")
    log(f"[gate] audit: {len(reports)} targets in {time.perf_counter() - t0:.1f} s")
    check(not any(r.findings for r in reports), "the audit has findings on the card")
    nodes = {r.target: set(r.nodes) for r in reports}
    check("FusedAttentionBackward" in nodes["train_grad"]
          and "BlockSparseAttentionBackward" in nodes["train_step_sparse"],
          "the audit did not see the attention backward on the card")
    require(not problems, "gate phase: " + "; ".join(problems))
    return {"launches": launches, "row": row}


# --------------------------------------------------------------- phase 2


def _sliced(fn, args, kwargs, logits_bytes_per_batch):
    """Run the plain version over batch slices small enough to hold its
    logits; concatenate along the batch."""
    import torch

    b = args[0].shape[0]
    step = max(1, int(MAX_PLAIN_LOGITS_BYTES // max(1, logits_bytes_per_batch)))
    outs = []
    for lo in range(0, b, step):
        sl = slice(lo, lo + step)
        kw = {k: (v[sl] if isinstance(v, torch.Tensor) and v.dim() and v.shape[0] == b
                  else v) for k, v in kwargs.items()}
        outs.append(fn(*(a[sl] for a in args), **kw))
    return torch.cat(outs)


def _prefix(n, lengths):
    """(len(lengths), n) bool masks valid on a prefix of each row."""
    import torch

    idx = torch.arange(n, device="cuda")
    return idx[None, :] < torch.as_tensor(lengths, device="cuda")[:, None]


def _drop_last_tile(mask):
    """``mask`` without each row's last 64 valid keys (its last valid key
    where it has 64 or fewer): the keys a kernel that skipped its last key
    tile would see."""
    import torch

    from_end = mask.flip(-1).long().cumsum(-1).flip(-1)  # valid keys at or after j
    cut = torch.where(mask.sum(-1, keepdim=True) > 64, 64, 1)
    return mask & (from_end > cut)


def _k1_operands(b, h, nq, nk, d, dtype, gen, serving):
    """q (B, H, Nq, D), k/v (B, H, Nk, D). With ``serving`` they are built
    as ops/attention.py builds them: (B, H, N, D) views of a (B, Nq, H*D)
    query projection and of the two halves of a (B, Nk, 2*H*D) key/value
    projection, so k and v have token stride 2*H*D and v starts H*D in."""
    import torch

    dev = torch.device("cuda")
    if not serving:
        return tuple(torch.randn((b, h, n, d), device=dev, generator=gen).to(dtype)
                     for n in (nq, nk, nk))
    q = torch.randn((b, nq, h * d), device=dev, generator=gen).to(dtype)
    kv = torch.randn((b, nk, 2 * h * d), device=dev, generator=gen).to(dtype)
    k, v = (t.view(b, nk, h, d).transpose(1, 2) for t in kv.chunk(2, -1))
    return q.view(b, nq, h, d).transpose(1, 2), k, v


def _host_us(fn, calls=20):
    """Host time per call of ``fn`` in microseconds: the enqueue, measured
    without synchronising inside (the card runs behind)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


K1_ROUTES = {"sm90": "attention_kernel_sm90", "packed": "attention_packed_kernel_sm90",
             "rows": "tied_row_attention_kernel_sm90 (head dim as rows of 64)"}


def _k1_route(b, h, nq, nk, d):
    """The Hopper kernel K1's plan takes for a bf16 shape whose operands TMA
    can describe: "packed" (attention_packed_kernel_sm90, short problems),
    "rows" (K2's walk past head dim 128) or "sm90"."""
    from alphafold2_tpu_torch.ops.cuda import axial

    if d > axial.HEAD_DIMS[-1]:
        return "rows"
    return "packed" if axial.packed_plan(b, h, nq, nk, d) is not None else "sm90"


def _sm90_launched(fn, what, route="sm90"):
    """Run ``fn`` once; require that K1 launched the Hopper kernel of
    ``route`` (K1_ROUTES) and no other. Returns fn's result and how many
    combine passes it launched."""
    from alphafold2_tpu_torch.ops.cuda import axial

    f = axial.fused_attention
    counts = lambda: (f.sm90_launches, f.packed_launches, f.row_launches,
                      axial.fused_attention_combine.launches)
    before = counts()
    result = fn()
    sm90, packed, rows, combine = (x - y for x, y in zip(counts(), before))
    require((sm90, packed, rows) == (1, int(route == "packed"), int(route == "rows")),
            f"{what}: K1 did not launch {K1_ROUTES[route]} (Hopper, packed, rows launches "
            f"{(sm90, packed, rows)})")
    return result, combine


def k1_case(label, b, h, nq, nk, d, dtype, q_mask=None, kv_mask=None, reps=3,
            library=False, gen=None, serving=False, sm_scale=None):
    """One fused_attention check; returns a result row. ``serving`` builds
    the operands in the serving path's strided layout and also checks that
    a kernel skipping its last key tile would fail the bound. A bf16 main
    path case (``serving``) must launch the Hopper kernel of its shape
    (``_k1_route``: attention_packed_kernel_sm90 under 64 tokens, else
    attention_kernel_sm90) and, where the key axis splits, its combine pass;
    two runs must agree bit for bit."""
    import torch
    import torch.nn.functional as F

    from alphafold2_tpu_torch.ops.cuda.axial import (
        fused_attention, fused_attention_reference, key_splits)

    dev = torch.device("cuda")
    q, k, v = _k1_operands(b, h, nq, nk, d, dtype, gen, serving)
    scale = d**-0.5 if sm_scale is None else sm_scale
    run = lambda: fused_attention(q, k, v, q_mask=q_mask, kv_mask=kv_mask, sm_scale=scale)
    if serving and dtype == torch.bfloat16:
        route = _k1_route(b, h, nq, nk, d)
        splits = key_splits(b, h, nq, nk, d) if route == "sm90" else 1
        out, combined = _sm90_launched(run, label, route)
        require(combined == (splits > 1), f"{label}: combine launches {combined}, "
                                          f"{splits} key splits")
        require(torch.equal(out, run()), f"{label}: two K1 runs differ")
        log(f"[kernels] fused_attention {label}: {K1_ROUTES[route]}, {splits} key "
            f"split(s), two runs bit-identical")
    else:
        out = run()
    torch.cuda.synchronize()
    plain = lambda: _sliced(
        fused_attention_reference, (q, k, v),
        {"q_mask": q_mask, "kv_mask": kv_mask, "sm_scale": scale},
        h * nq * nk * 4 * 3,
    )
    ref = plain()
    row = _compare(label, "fused_attention", out, ref, dtype)
    if serving:
        short = fused_attention(q, k, v, q_mask=q_mask, kv_mask=_drop_last_tile(kv_mask),
                                sm_scale=scale)
        _control(label, "fused_attention", short, ref, dtype)
        del short
    qv = q_mask.sum(1) if q_mask is not None else torch.full((b,), nq, device=dev)
    kv = kv_mask.sum(1) if kv_mask is not None else torch.full((b,), nk, device=dev)
    ops = 4.0 * h * d * float((qv * kv).sum())
    nbytes = (2 * b * h * nq * d + 2 * b * h * nk * d) * q.element_size() + (
        (b * nq if q_mask is not None else 0) + (b * nk if kv_mask is not None else 0))
    row.update(_bound(ops, nbytes, dtype))
    if reps:
        row["ms"] = cuda_ms(run, reps)
        row["host_us"] = _host_us(run)
        row["plain_ms"] = cuda_ms(plain, reps=1, warmup=0)
        if library:
            am = kv_mask[:, None, None, :] if kv_mask is not None else None
            try:
                row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=am, scale=scale), reps)
            except (RuntimeError, torch.OutOfMemoryError) as e:
                log(f"[kernels] {label}: scaled_dot_product_attention failed: {e}")
                row["library_ms"] = None
    del q, k, v, out, ref
    torch.cuda.empty_cache()
    return row


def _k2_sm90_launched(fn, what, wide=False):
    """Run ``fn`` once; require that K2 launched a Hopper kernel:
    tied_row_attention_kernel_sm90, or with ``wide`` the wide route's
    passes. Returns fn's result."""
    from alphafold2_tpu_torch.ops.cuda import tied_row

    fn_ = tied_row.tied_row_attention
    before = (fn_.sm90_launches, fn_.wide_launches)
    result = fn()
    ran = (fn_.sm90_launches - before[0], fn_.wide_launches - before[1])
    require(ran == (1, int(wide)), f"{what}: K2 ran (Hopper, wide) launches {ran}, not "
                                   f"(1, {int(wide)})")
    return result


def _k2_planned(b, r, n, h, d, dtype):
    """The Hopper K2's plan at a shape (tied_row.hopper_plan, or the wide
    route's tied_row.wide_plan, marked ``wide``), or None where another
    kernel takes it: f32, or a head dim neither takes."""
    import torch

    from alphafold2_tpu_torch.ops.cuda.tied_row import hopper_plan, wide_plan

    if dtype != torch.bfloat16:
        return None
    plan = hopper_plan(b, r, h, n, d)
    if plan is not None:
        return {**plan, "wide": False}
    plan = wide_plan(b, r, h, n, n, d)
    return None if plan is None else {**plan, "wide": True}


def _k2_bwd_planned(b, r, n, h, d, dtype):
    """K2's backward plans (dq, dk/dv) at a shape: the resident Hopper
    kernels' (tied_row.hopper_bwd_plan) or the wide route's
    (tied_row.wide_bwd_plan, marked ``wide``), None for f32 or a row width
    neither takes."""
    import torch

    from alphafold2_tpu_torch.ops.cuda.tied_row import hopper_bwd_plan, wide_bwd_plan

    if dtype != torch.bfloat16:
        return [None, None]
    wide = wide_bwd_plan(b, h, n, n, r * d, d)
    if wide is not None:
        return [{**wide, "wide": True}] * 2
    return [None if x is None else {**x, "wide": False}
            for x in (hopper_bwd_plan(w, b, h, n, n, r * d, d) for w in ("dq", "dkv"))]


def _describe(plan):
    """A K2 plan for the log: the resident kernel with its groups and
    stages, or the wide route's passes with their blocks and the splits."""
    if plan is None:
        return "the chunked kernel"
    if plan["wide"]:
        return (f"the wide route: {plan['splits']} feature split(s) of "
                f"{plan['stages_per_split']} stage(s), "
                + ", ".join(f"{x['kernel']} ({x['blocks']} blocks)" for x in plan["passes"])
                + f", workspace {plan['workspace']} bytes")
    return (f"{plan['kernel']}, {plan['groups']} column group(s) of {plan['columns']}, "
            f"{plan['stages']} stage(s), {plan['blocks']} blocks")


def k2_case(label, b, r, n, h, d, dtype, length=None, reps=3, library=False, gen=None,
            sm_scale=None):
    """One tied_row_attention check; returns a result row. A bf16 shape the
    Hopper kernel takes must launch tied_row_attention_kernel_sm90 and
    repeat bit for bit; with a mask, a kernel that skipped its last key tile
    must fail the bound."""
    import torch
    import torch.nn.functional as F

    from alphafold2_tpu_torch.ops.cuda.tied_row import (
        tied_row_attention, tied_row_attention_reference)

    dev = torch.device("cuda")
    shape = (b, r, n, h, d)
    q = torch.randn(shape, device=dev, generator=gen)
    k = torch.randn(shape, device=dev, generator=gen)
    v = torch.randn(shape, device=dev, generator=gen)
    mask = _prefix(n, length) if length is not None else None
    tie = r**-0.5
    if mask is not None:  # padded columns abstain, as ops/attention.py does
        q, k, v = (t * mask[:, None, :, None, None] for t in (q, k, v))
        n_rows = (mask.any(-1).long() * r).clamp_min(1)
        tie = n_rows.float() ** -0.5
    q, k, v = (t.to(dtype).contiguous() for t in (q, k, v))
    scale = d**-0.5 if sm_scale is None else sm_scale
    run = lambda: tied_row_attention(q, k, v, q_mask=mask, kv_mask=mask,
                                     sm_scale=scale, tie_scale=tie)
    plan = _k2_planned(b, r, n, h, d, dtype)
    if plan is not None:
        out = _k2_sm90_launched(run, label, plan["wide"])
        require(torch.equal(out, run()), f"{label}: two K2 runs differ")
        log(f"[kernels] tied_row_attention {label}: {_describe(plan)}, two runs bit-identical")
    else:
        out = run()
    torch.cuda.synchronize()
    plain = lambda: tied_row_attention_reference(q, k, v, mask, mask, scale, tie)
    ref = plain()
    row = _compare(label, "tied_row_attention", out, ref, dtype)
    if mask is not None:
        short = tied_row_attention(q, k, v, q_mask=mask, kv_mask=_drop_last_tile(mask),
                                   sm_scale=scale, tie_scale=tie)
        _control(label, "tied_row_attention", short, ref, dtype)
    nv = mask.sum(1) if mask is not None else torch.full((b,), n, device=dev)
    ops = 4.0 * h * r * d * float((nv * nv).sum())
    nbytes = 4 * b * r * n * h * d * q.element_size() + (2 * b * n if mask is not None else 0)
    row.update(_bound(ops, nbytes, dtype))
    if reps:
        row["ms"] = cuda_ms(run, reps)
        row["plain_ms"] = cuda_ms(plain, reps)
        if library:
            # the same function through SDPA: fold rows into the head dim
            def fold(t):
                return t.permute(0, 3, 2, 1, 4).reshape(b, h, n, r * d)

            tie_t = torch.as_tensor(tie, device=dev, dtype=torch.float32).reshape(-1)
            qs = (fold(q).float() * tie_t.reshape(-1, 1, 1, 1)).to(dtype)
            kf, vf = fold(k), fold(v)
            am = mask[:, None, None, :] if mask is not None else None
            row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                qs, kf, vf, attn_mask=am, scale=scale), reps)
    return row


# K2's shapes (b, r, n, h, d) by their plans: the serving tied pass, the tied
# training pass, JAX's gate case (R*D 512), one shape for each other Hopper
# instantiation (head dims 32 and 128 at 64 and 128 columns a block), and
# the wide route's (its logits pass): JAX's gate case at R*D 1280, config_4's
# MSA rows (R*D 1024), the PLM grid's tied rows (R*D 8192, end to end 12288)
# and head dims 32 and 128
WIDE_FWD = "tied_wide_logits_kernel<{},2>"
K2_PLANS = {
    "serve": ((4, 5, 128, 8, 64), "tied_row_attention_kernel_sm90<64,128>"),
    "train": ((1, 5, 64, 8, 64), "tied_row_attention_kernel_sm90<64,64>"),
    "gate": ((1, 8, 256, 4, 64), "tied_row_attention_kernel_sm90<64,64>"),
    "R*D 1280": ((1, 20, 48, 2, 64), WIDE_FWD.format(64)),
    "config_4 R*D 1024": ((1, 16, 128, 8, 64), WIDE_FWD.format(64)),
    "PLM R*D 8192": ((1, 128, 128, 8, 64), WIDE_FWD.format(64)),
    "PLM e2e R*D 12288": ((1, 192, 192, 8, 64), WIDE_FWD.format(64)),
    "d32 wide": ((1, 18, 70, 2, 32), WIDE_FWD.format(32)),
    "d128 wide": ((4, 5, 128, 8, 128), WIDE_FWD.format(128)),
    "d32, 64 columns": ((3, 8, 100, 2, 32), "tied_row_attention_kernel_sm90<32,64>"),
    "d32, 128 columns": ((16, 4, 70, 8, 32), "tied_row_attention_kernel_sm90<32,128>"),
    "d128, 64 columns": ((2, 4, 70, 2, 128), "tied_row_attention_kernel_sm90<128,64>"),
    "d128, 128 columns": ((8, 2, 128, 8, 128), "tied_row_attention_kernel_sm90<128,128>"),
}


def _wide_route_agrees(lib, route, passes, args, mirror, what):
    """The C wide route's numbers (splits, workspace bytes) and each pass's
    plan at ``args`` against the mirror's."""
    import ctypes

    from alphafold2_tpu_torch.ops.cuda import build

    splits, work = ctypes.c_int(), ctypes.c_longlong()
    code = getattr(lib, route)(*args, ctypes.byref(splits), ctypes.byref(work))
    require(code == 0 and (splits.value, work.value) == (mirror["splits"], mirror["workspace"]),
            f"{what}: the C wide route (code {code}, {splits.value} splits, {work.value} "
            f"bytes) differs from the mirror ({mirror['splits']}, {mirror['workspace']})")
    for i, want in enumerate(mirror["passes"]):
        got = build.LaunchPlan()
        code = getattr(lib, passes)(i, *args, ctypes.byref(got))
        have = (got.kernel.decode(), got.blocks, got.threads, got.dynamic_smem)
        require(code == 0 and have == (want["kernel"], want["blocks"], want["threads"],
                                       want["dynamic_smem"]),
                f"{what}: the C plan of pass {i} {have} (code {code}) differs from {want}")


def check_k2_plans():
    """K2's C plan (bf16, operands 16-byte aligned) must name the kernel
    K2_PLANS gives each shape, and agree with tied_row.hopper_plan (blocks,
    threads, shared memory) where that is the Hopper kernel, with
    tied_row.wide_plan (splits, workspace, every pass's plan) where that is
    the wide route; unaligned operands keep attention_kernel_mma and f32
    attention_kernel at every shape."""
    import ctypes

    from alphafold2_tpu_torch.ops.cuda import build, tied_row

    lib = build.library("tied_row_attention")

    def plan(shape, aligned, dtype=1):
        b, r, n, h, d = shape
        out = build.LaunchPlan()
        code = lib.af2_tied_row_attention_plan(dtype, b, r, h, n, n, d, aligned,
                                               ctypes.byref(out))
        require(code == 0, f"K2 plan at {shape}: code {code}")
        return out

    for label, (shape, kernel) in K2_PLANS.items():
        got = plan(shape, 1)
        name = got.kernel.decode()
        require(name == kernel, f"K2 plan at {label} {shape}: {name}, not {kernel}")
        b, r, n, h, d = shape
        wide = kernel.startswith(tied_row.WIDE_KERNELS["logits"])
        mirror = (tied_row.wide_plan(b, r, h, n, n, d) if wide
                  else tied_row.hopper_plan(b, r, h, n, d))
        require(mirror is not None and mirror["kernel"] == name
                and (mirror["blocks"], mirror["threads"], mirror["dynamic_smem"])
                == (got.blocks, got.threads, got.dynamic_smem),
                f"K2 plan at {label}: the C plan ({got.blocks}, {got.threads}, "
                f"{got.dynamic_smem}) differs from the mirror {mirror}")
        if wide:
            require(tied_row.hopper_plan(b, r, h, n, d) is None,
                    f"K2 plan at {label}: hopper_plan takes it, C does not")
            _wide_route_agrees(lib, "af2_tied_row_attention_wide_route",
                               "af2_tied_row_attention_wide_pass", (1, b, r, h, n, n, d, 1),
                               mirror, f"K2 plan at {label}")
        log(f"[kernels] K2 plan {label} {shape}: {name}, {got.blocks} blocks of {got.threads}, "
            f"{got.dynamic_smem} bytes of shared memory"
            + (f"; {_describe({**mirror, 'wide': True})}" if wide else ""))
    for label in ("serve", "PLM R*D 8192", "d128 wide"):
        shape = K2_PLANS[label][0]
        unaligned = plan(shape, 0).kernel.decode()
        require(unaligned == "attention_kernel_mma<64>",
                f"K2 plan at {label} with unaligned operands: {unaligned}")
        f32 = plan(shape, 1, dtype=0).kernel.decode()
        require(f32 == "attention_kernel<64>", f"K2 plan at {label} in f32: {f32}")


# K2's backward at its shapes (b, h, nq, nk, features, row width) by their
# plans, dq then dk/dv: the tied training pass, JAX's gate case (R*D 512:
# the wide route), the wide route's other shapes (config_4, the PLM grid,
# row widths 32 and 128), a serving-size grid (dq at 128 columns), K3 at
# head dims 256 and 192 as rows of 64, and one shape for each other Hopper
# instantiation (row widths 32 and 128, dq at 64 and 128 columns)
WIDE_BWD = "tied_wide_logits_kernel<{},4>"
K2_BWD_PLANS = {
    "train": ((1, 8, 64, 64, 320, 64), ("tied_dq_kernel_sm90<64,64>",
                                        "tied_dkv_kernel_sm90<64,64>")),
    "gate": ((1, 4, 256, 256, 512, 64), (WIDE_BWD.format(64), WIDE_BWD.format(64))),
    "config_4 R*D 1024": ((1, 8, 128, 128, 1024, 64), (WIDE_BWD.format(64),) * 2),
    "PLM R*D 8192": ((1, 8, 128, 128, 8192, 64), (WIDE_BWD.format(64),) * 2),
    "PLM e2e R*D 12288": ((1, 8, 192, 192, 12288, 64), (WIDE_BWD.format(64),) * 2),
    "d32 wide": ((1, 2, 70, 70, 576, 32), (WIDE_BWD.format(32),) * 2),
    "d128 wide": ((4, 8, 128, 128, 640, 128), (WIDE_BWD.format(128),) * 2),
    "serve-size grid": ((4, 8, 128, 128, 320, 64), ("tied_dq_kernel_sm90<64,128>",
                                                    "tied_dkv_kernel_sm90<64,64>")),
    "K3 head dim 256": ((2, 4, 200, 150, 256, 64), ("tied_dq_kernel_sm90<64,64>",
                                                    "tied_dkv_kernel_sm90<64,64>")),
    "K3 head dim 192": ((1, 2, 130, 130, 192, 64), ("tied_dq_kernel_sm90<64,64>",
                                                    "tied_dkv_kernel_sm90<64,64>")),
    "d32, 64 columns": ((3, 2, 100, 100, 256, 32), ("tied_dq_kernel_sm90<32,64>",
                                                    "tied_dkv_kernel_sm90<32,64>")),
    "d32, 128 columns": ((16, 8, 70, 70, 128, 32), ("tied_dq_kernel_sm90<32,128>",
                                                    "tied_dkv_kernel_sm90<32,64>")),
    "d128, 64 columns": ((2, 2, 70, 70, 256, 128), ("tied_dq_kernel_sm90<128,64>",
                                                    "tied_dkv_kernel_sm90<128,64>")),
    "d128, 128 columns": ((8, 8, 128, 128, 256, 128), ("tied_dq_kernel_sm90<128,128>",
                                                       "tied_dkv_kernel_sm90<128,64>")),
}


def check_k2_bwd_plans():
    """K2's backward C plan (bf16, operands TMA can describe) must name the
    kernels K2_BWD_PLANS gives each shape, and agree with
    tied_row.hopper_bwd_plan (blocks, threads, shared memory) where those
    are the Hopper kernels, with tied_row.wide_bwd_plan (splits, workspace,
    every pass's plan) where that is the wide route; unaligned operands and
    f32 keep the chunked kernels, at the training and PLM shapes."""
    import ctypes

    from alphafold2_tpu_torch.ops.cuda import build, tied_row

    lib = build.library("tied_row_attention_bwd")

    def plan(which, shape, dtype=1, aligned=1):
        out = build.LaunchPlan()
        code = lib.af2_tied_row_attention_bwd_plan(which, dtype, *shape, aligned,
                                                   ctypes.byref(out))
        require(code == 0, f"K2 backward plan at {shape}: code {code}")
        return out

    for label, (shape, kernels) in K2_BWD_PLANS.items():
        for which, name, kernel in ((0, "dq", kernels[0]), (1, "dkv", kernels[1])):
            got = plan(which, shape)
            taken = got.kernel.decode()
            require(taken == kernel, f"K2 {name} plan at {label} {shape}: {taken}, not {kernel}")
            mirror = tied_row.hopper_bwd_plan(name, *shape)
            if kernel.startswith(tied_row.WIDE_KERNELS["logits"]):
                wide = tied_row.wide_bwd_plan(*shape)
                require(mirror is None and wide is not None and wide["kernel"] == taken
                        and (wide["blocks"], wide["threads"], wide["dynamic_smem"])
                        == (got.blocks, got.threads, got.dynamic_smem),
                        f"K2 {name} plan at {label}: the C plan ({got.blocks}, {got.threads}, "
                        f"{got.dynamic_smem}) differs from wide_bwd_plan {wide}")
                _wide_route_agrees(lib, "af2_tied_row_attention_bwd_wide_route",
                                   "af2_tied_row_attention_bwd_wide_pass", (1, *shape, 1), wide,
                                   f"K2 {name} plan at {label}")
                log(f"[kernels] K2 {name} plan {label} {shape}: "
                    f"{_describe({**wide, 'wide': True})}")
            elif kernel.startswith(tied_row.HOPPER_BWD_KERNELS[name]):
                require(mirror is not None and mirror["kernel"] == taken
                        and (mirror["blocks"], mirror["threads"], mirror["dynamic_smem"])
                        == (got.blocks, got.threads, got.dynamic_smem),
                        f"K2 {name} plan at {label}: the C plan ({got.blocks}, {got.threads}, "
                        f"{got.dynamic_smem}) differs from hopper_bwd_plan {mirror}")
            else:
                require(mirror is None,
                        f"K2 {name} plan at {label}: hopper_bwd_plan takes it, C does not")
            log(f"[kernels] K2 {name} plan {label} {shape}: {taken}, {got.blocks} blocks of "
                f"{got.threads}, {got.dynamic_smem} bytes of shared memory")
    for label in ("train", "PLM R*D 8192"):
        shape = K2_BWD_PLANS[label][0]
        for which, kernel in ((0, "chunked_dq_kernel_mma<64>"),
                              (1, "chunked_dkv_kernel_mma<64>")):
            taken = plan(which, shape, aligned=0).kernel.decode()
            require(taken == kernel,
                    f"K2 backward plan at {label} with unaligned operands: {taken}")
        for which, kernel in ((0, "chunked_dq_kernel<64>"), (1, "chunked_dkv_kernel<64>")):
            taken = plan(which, shape, dtype=0).kernel.decode()
            require(taken == kernel, f"K2 backward plan at {label} in f32: {taken}")


def _errors(out, ref, dtype):
    """(dtype name, max abs error, its ratio to max|plain|, relative L2
    error, whether both ratios are within TOL)."""
    import torch

    name = "float32" if dtype == torch.float32 else "bfloat16"
    max_rel, l2_rel = TOL[name]
    diff = out.float() - ref.float()
    err = float(diff.abs().max())
    rel_max = err / max(float(ref.float().abs().max()), 1e-30)
    rel_l2 = float(diff.norm()) / max(float(ref.float().norm()), 1e-30)
    return name, err, rel_max, rel_l2, rel_max <= max_rel and rel_l2 <= l2_rel


def _compare(label, kernel, out, ref, dtype):
    import torch

    require(bool(torch.isfinite(out).all()), f"{label}: non-finite kernel output")
    name, err, rel_max, rel_l2, ok = _errors(out, ref, dtype)
    max_rel, l2_rel = TOL[name]
    log(f"[kernels] {kernel} {label} {name}: max_abs_err={err:.3e} "
        f"max_abs_err/max|plain|={rel_max:.3e} (tol {max_rel:g}) "
        f"rel_l2={rel_l2:.3e} (tol {l2_rel:g}) {'ok' if ok else 'FAIL'}")
    require(ok, f"{kernel} {label} {name}: disagrees with its plain version "
                f"(max_abs_err {err:.3e}, relative {rel_max:.3e}, rel_l2 {rel_l2:.3e})")
    return {"label": label, "kernel": kernel, "dtype": name, "max_abs_err": err,
            "rel_max": rel_max, "rel_l2": rel_l2}


def _control(label, kernel, short, ref, dtype, tile="key"):
    """Negative control: the kernel run without each row's last key (or
    query) tile must fail the bound its full run passes."""
    name, _, rel_max, rel_l2, ok = _errors(short, ref, dtype)
    log(f"[kernels] {kernel} {label} {name}: control without the last {tile} tile: "
        f"max_abs_err/max|plain|={rel_max:.3e} rel_l2={rel_l2:.3e} "
        f"{'passes (BAD)' if ok else 'rejected'}")
    require(not ok, f"{kernel} {label} {name}: the bound does not reject a kernel "
                    f"that skips its last {tile} tile")


def _bound(ops, nbytes, dtype):
    import torch

    name = "float32" if dtype == torch.float32 else "bfloat16"
    t_ops = ops / PEAK_OPS[name] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"ops": ops, "bytes": nbytes, "ops_ms": t_ops, "bytes_ms": t_bytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


# K1's nine main-path passes (b, h, nq, nk, d): the four serving passes at
# bucket 128 and the five training passes of TRAIN_CASES (heads 8, d 64)
K1_MAIN_PATH = {
    "serve pair axial": (1536, 8, 384, 384, 64),
    "serve pair<-MSA": (4, 8, 147456, 640, 64),
    "serve MSA<-pair": (4, 8, 640, 147456, 64),
    "serve MSA column": (512, 8, 5, 5, 64),
    "train pair axial": (128, 8, 128, 128, 64),
    "train MSA column": (64, 8, 5, 5, 64),
    "train MSA row": (5, 8, 64, 64, 64),
    "train pair<-MSA": (1, 8, 16384, 320, 64),
    "train MSA<-pair": (1, 8, 320, 16384, 64),
}
K1_SM90 = "attention_kernel_sm90<64>"
K1_PACKED = "attention_packed_kernel_sm90<64>"
# the main-path passes of fewer than 64 tokens: the packed kernel's
K1_PACKED_PASSES = ("serve MSA column", "train MSA column")


def check_k1_plans():
    """K1's plan on each main-path shape and on the template axis (bf16,
    TMA-aligned operands) must name its Hopper kernel: the packed kernel on
    the two MSA column passes and the template axis, with the launch
    axial.packed_plan mirrors; attention_kernel_sm90 on the other seven,
    and a split shape the combine pass."""
    import ctypes

    from alphafold2_tpu_torch.ops.cuda import build
    from alphafold2_tpu_torch.ops.cuda.axial import key_splits, packed_plan

    lib = build.library("fused_attention")

    b, h, n, d = TEMPLATE_AXIS
    shapes = {**K1_MAIN_PATH, TEMPLATE_AXIS_LABEL: (b, h, n, n, d)}
    for label, (b, h, nq, nk, d) in shapes.items():
        splits = key_splits(b, h, nq, nk, d)
        plan = build.LaunchPlan()
        build.check(lib, lib.af2_fused_attention_plan(1, b, h, nq, nk, d, splits, 1,
                                                      ctypes.byref(plan)), "K1 plan")
        name = plan.kernel.decode()
        line = f"{name}, {plan.blocks} blocks of {plan.threads}, {plan.dynamic_smem} B"
        packed = label in K1_PACKED_PASSES or label == TEMPLATE_AXIS_LABEL
        if packed:
            mirror = packed_plan(b, h, nq, nk, d)
            line += f"; {mirror['group']} problems a tile, {mirror['tiles']} tiles"
            require((name, plan.blocks, plan.threads, plan.dynamic_smem) ==
                    (mirror["kernel"], mirror["blocks"], mirror["threads"],
                     mirror["dynamic_smem"]),
                    f"{label}: the C plan {line} is not axial.packed_plan's {mirror}")
        elif splits > 1:
            comb = build.LaunchPlan()
            build.check(lib, lib.af2_fused_attention_combine_plan(b, h, nq, d,
                                                                  ctypes.byref(comb)),
                        "K1 combine plan")
            line += f"; {splits} key splits, then {comb.kernel.decode()} ({comb.blocks} blocks)"
            require(comb.kernel.decode() == "combine_kernel<64>",
                    f"{label}: the combine pass plans {comb.kernel.decode()}")
        log(f"[kernels] K1 plan, {label} {(b, h, nq, nk, d)}: {line}")
        want = K1_PACKED if packed else K1_SM90
        require(name == want, f"{label}: K1 plans {name}, not {want}")


SERVE_LENGTHS = [128, 110, 97, 0]  # a bucket-128 batch of 4: one dummy slot


def _serve_masks():
    """The serving path's K1 masks at bucket 128, batch 4 (one dummy slot):
    the pair axial pass (rows fold into the batch), the MSA column pass and
    the flat pair and MSA token masks of the cross passes."""
    lens = SERVE_LENGTHS
    pair_valid = _prefix(384, [3 * l for l in lens])  # (4, 384) elongated tokens
    pair_mask = pair_valid[:, :, None] & pair_valid[:, None, :]  # (4, 384, 384)
    msa_valid = _prefix(128, lens)  # (4, 128) residues
    msa_mask = msa_valid[:, None, :].expand(4, 5, 128)  # (4, 5, 128)
    return (pair_mask.reshape(4 * 384, 384), msa_mask.transpose(1, 2).reshape(4 * 128, 5),
            pair_mask.reshape(4, 384 * 384), msa_mask.reshape(4, 5 * 128))


def phase_k1_time(reps=10, device=False):
    """K1 alone on its nine main-path passes, bf16, operands laid out as
    the path lays them out: the four serving passes (no lse) and the five
    training passes (with lse), each timed beside SDPA on the same masked
    problem, with the host time of a call; with ``device`` also each one's
    device time and SDPA's under torch.profiler. No checks: phase_kernels
    and phase_backward hold K1 to its plain version. Returns {label: row}."""
    import torch
    import torch.nn.functional as F

    from alphafold2_tpu_torch.ops.cuda import axial

    gen = torch.Generator(device="cuda").manual_seed(4)
    pair_axial, msa_col, pair_flat, msa_flat = _serve_masks()
    serve = {"serve pair axial": (pair_axial, pair_axial), "serve MSA column": (msa_col, msa_col),
             "serve pair<-MSA": (pair_flat, msa_flat), "serve MSA<-pair": (msa_flat, pair_flat)}
    train = dict(zip(list(K1_MAIN_PATH)[4:], (_train_masks(t) for t in TRAIN_CASES)))
    rows = {}
    for label, (b, h, nq, nk, d) in K1_MAIN_PATH.items():
        qm, km = {**serve, **train}[label]
        with_lse = label in train
        q, k, v = _k1_operands(b, h, nq, nk, d, torch.bfloat16, gen, serving=True)
        scale = d**-0.5
        run = ((lambda: axial.fused_attention_lse(q, k, v, qm, km, scale)) if with_lse else
               (lambda: axial.fused_attention(q, k, v, q_mask=qm, kv_mask=km, sm_scale=scale)))
        am = km[:, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=scale)
        row = {"ms": cuda_ms(run, reps), "host_us": _host_us(run), "sdpa_ms": cuda_ms(sdpa, reps)}
        if device:
            row.update(device_ms=_device_ms(run), sdpa_device_ms=_device_ms(sdpa))
        rows[label] = row
        log(f"[k1 time] {label} {(b, h, nq, nk, d)}{' lse' if with_lse else ''}: K1 "
            f"{row['ms']:.4f} ms, host {row['host_us']:.1f} us a call; SDPA {row['sdpa_ms']:.4f} ms"
            + (f"; device K1 {row['device_ms']:.4f} ms, SDPA {row['sdpa_device_ms']:.4f} ms"
               if device else ""))
        del q, k, v
    layer = {"serve pair axial": 2, "serve MSA column": 1, "serve pair<-MSA": 1,
             "serve MSA<-pair": 1}
    step = {label: 6 * calls for label, (*_, calls) in zip(train, TRAIN_CASES.values())}
    for what, weights in (("serving trunk layer", layer), ("training step", step)):
        k1 = sum(w * rows[lb]["ms"] for lb, w in weights.items())
        sdpa = sum(w * rows[lb]["sdpa_ms"] for lb, w in weights.items())
        log(f"[k1 time] per {what}: K1 {k1:.3f} ms, SDPA {sdpa:.3f} ms")
    return rows


def phase_k1_device_time(reps=10):
    """phase_k1_time with device times, a name no older tree has, so that
    chip_compare.sh runs this tree's version on a parent's kernels."""
    return phase_k1_time(reps, device=True)


# K1's short passes (label: (b, h, nq, nk, d, with lse)): the packed
# kernel's shapes on the port's paths
K1_SHORT_PASSES = {
    "template axis (147456x8, 5x5)": (384 * 384, 8, 5, 5, 64, False),
    "template axis, lse (147456x8, 5x5)": (384 * 384, 8, 5, 5, 64, True),
    "serve MSA column (512x8, 5x5)": (512, 8, 5, 5, 64, False),
    "train MSA column, lse (64x8, 5x5)": (64, 8, 5, 5, 64, True),
    "config_4 MSA column, lse (128x8, 16x16)": (128, 8, 16, 16, 64, True),
    "config_3 MSA column, lse (128x8, 8x8)": (128, 8, 8, 8, 64, True),
}


def phase_k1_packed_time(reps=10):
    """K1 alone on its short passes (K1_SHORT_PASSES), bf16, operands laid
    out as the projections lay them out, with the masks of their paths (the
    template axis's _template_axis_mask, the serving MSA column's bucket-128
    mask, all-valid elsewhere), each beside SDPA's forward on the same
    masked problem: a call's time by CUDA events over ``reps`` calls, its
    device time under torch.profiler and its host time, and its bound. No
    checks (phase_kernels and phase_slice_kernels hold K1 there). Uses only
    the public wrappers, so chip_compare.sh can run it on a parent's
    kernels. Returns {label: row}."""
    import torch
    import torch.nn.functional as F

    from alphafold2_tpu_torch.ops.cuda import axial

    gen = torch.Generator(device="cuda").manual_seed(18)
    rows = {}
    for label, (b, h, nq, nk, d, with_lse) in K1_SHORT_PASSES.items():
        q, k, v = _k1_operands(b, h, nq, nk, d, torch.bfloat16, gen, serving=True)
        if label.startswith("template"):
            qm = km = _template_axis_mask(b)
        elif label.startswith("serve"):
            qm = km = _serve_masks()[1]
        else:
            qm, km = _ones(b, nq), _ones(b, nk)
        scale = d**-0.5
        run = ((lambda: axial.fused_attention_lse(q, k, v, qm, km, scale)) if with_lse else
               (lambda: axial.fused_attention(q, k, v, q_mask=qm, kv_mask=km, sm_scale=scale)))
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=km[:, None, None, :],
                                                      scale=scale)
        valid = (qm.sum(1).double() * km.sum(1).double()).sum()
        row = {"ms": cuda_ms(run, reps), "device_ms": _device_ms(run), "host_us": _host_us(run),
               "sdpa_device_ms": _device_ms(sdpa),
               **_bound(4.0 * h * d * float(valid),
                        (2 * b * h * nq * d + 2 * b * h * nk * d) * 2 + b * (nq + nk),
                        torch.bfloat16)}
        rows[label] = row
        log(f"[k1 packed time] {label} ({_card()}): K1 {row['ms']:.4f} ms, device "
            f"{row['device_ms']:.4f} ms ({row['bound_ms'] / row['device_ms']:.1%} of the "
            f"{row['bound_by']} bound {row['bound_ms']:.4f}), host {row['host_us']:.1f} us a "
            f"call; SDPA device {row['sdpa_device_ms']:.4f} ms")
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def phase_config4_pass(reps=3):
    """bench_suite.py config_4's template pass without the SE(3) embedder
    (phase_templates' model and inputs) alone over ``reps`` warm passes,
    with its peak memory: the pass that carries K1's template-axis calls.
    No checks (phase_templates holds it); chip_compare.sh runs it on a
    parent's package. Returns (ms, peak bytes)."""
    from alphafold2_tpu_torch.predict import init_params

    model = init_params(_template_model(False), 0).cuda()
    inputs = _template_inputs(TEMPLATE_CROP, TEMPLATE_MSA, TEMPLATE_T, False, "cuda")
    ms, peak = _time_step(lambda: _template_step(model, inputs), reps)
    del model, inputs
    _free()
    log(f"[config4 pass] ({_card()}): the pass alone {ms:.2f} ms over {reps}, peak device "
        f"memory {peak / 2**20:.1f} MiB")
    return ms, peak


def _device_ms(fn, calls=10):
    """Device time per call of ``fn`` in ms: every device-side event that
    torch.profiler records over ``calls`` calls, free of the host's pace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return us / calls / 1e3


def phase_k3_time(reps=10):
    """K3a and K3b alone on the five training passes, bf16, operands laid
    out as the training path lays them out, each beside SDPA's whole
    backward (dq, dk and dv in one call) on the same masked problem: a
    call's time by CUDA events over ``reps`` calls (paced by the host where
    the call is short), its device time under torch.profiler (kernels only,
    the merge pass included where it splits) and its host time; then per
    training step. No checks: phase_backward holds K3 to its plain versions.
    Uses only what every tree of the port has, so chip_compare.sh can run it
    for a parent that lacks it. Returns {label: row}."""
    import torch
    import torch.nn.functional as F

    from alphafold2_tpu_torch.ops.cuda import axial

    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = {}
    for label, (b, nq, nk, _) in TRAIN_CASES.items():
        h, d = 8, 64
        qm, km = _train_masks(label)
        q, k, v, do = _grad_operands(b, h, nq, nk, d, torch.bfloat16, gen, strided=True)
        scale = d**-0.5
        out, lse = axial.fused_attention_lse(q, k, v, qm, km, scale)
        args = (q, k, v, do, lse, axial.attention_dsum(out, do), qm, km, scale)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves, attn_mask=km[:, None, None, :], scale=scale)
        calls = {"dq": lambda: axial.fused_attention_dq(*args),
                 "dkv": lambda: axial.fused_attention_dkv(*args),
                 "sdpa": lambda: torch.autograd.grad(o, leaves, do, retain_graph=True)}
        row = {}
        for name, fn in calls.items():
            row[f"{name}_ms"] = cuda_ms(fn, reps)
            row[f"{name}_device_ms"] = _device_ms(fn)
            row[f"{name}_host_us"] = _host_us(fn)
        rows[label] = row
        splits = (tuple(axial.grad_splits(b, h, nq, nk, d, w) for w in ("dq", "dkv"))
                  if hasattr(axial, "grad_splits") else "-")
        log(f"[k3 time] {label} {(b, h, nq, nk, d)} splits {splits}: " + "; ".join(
            f"{what} {row[f'{n}_ms']:.4f} ms, device {row[f'{n}_device_ms']:.4f} ms, host "
            f"{row[f'{n}_host_us']:.1f} us a call"
            for n, what in (("dq", "K3a"), ("dkv", "K3b"), ("sdpa", "SDPA backward"))))
        del q, k, v, do, out, lse, args, leaves, o, calls
    weights = _step_weights(backward=True)
    step = {key: sum(w * rows[lb][key] for lb, w in weights.items()) for key in rows[label]}
    for kind in ("", "device_"):
        k3a, k3b = step[f"dq_{kind}ms"], step[f"dkv_{kind}ms"]
        log(f"[k3 time] per training step, {kind or 'event '}ms: K3a {k3a:.3f} + K3b {k3b:.3f} "
            f"= {k3a + k3b:.3f} ms; SDPA backward {step[f'sdpa_{kind}ms']:.3f} ms")
    return rows


# the stream lengths (64-row tiles, one split) K3a and K3b are held at
# against their plain versions, the longest a merged MSA<-pair or a
# pair<-MSA backward at crop 768 with MSA 5 x 128 would give one split
# without MAX_GRAD_SPLIT_TILES (9,216)
K3_STREAM_TILES = (1024, 2048, 4096, 9216)


def phase_k3_streams(tiles=K3_STREAM_TILES):
    """K3a's key loop and K3b's query loop streamed over ``tiles`` 64-row
    tiles in one split (``grad_splits`` forced to 1 for the call), bf16,
    head dim 64, two heads of one 64-row block, unmasked, each held against
    its plain version on the same operands and lse: the measurement that
    chose ops/cuda/axial.py MAX_GRAD_SPLIT_TILES (log tag ``[k3 streams]``).
    A stream within the cap must pass the kernel phase's bf16 bound; longer
    ones are logged. Returns {(which, tiles): (rel_max, rel_l2)}."""
    import torch

    from alphafold2_tpu_torch.ops.cuda import axial

    gen = torch.Generator(device="cuda").manual_seed(23)
    h, d, row = 2, 64, axial.GRAD_TILE
    scale = d**-0.5
    out_rows = {}
    planned = axial.grad_splits
    axial.grad_splits = lambda *a, **kw: 1
    try:
        for t in tiles:
            for which in ("dq", "dkv"):
                nq, nk = (row, t * row) if which == "dq" else (t * row, row)
                q, k, v, do = _grad_operands(1, h, nq, nk, d, torch.bfloat16, gen, strided=False)
                out, lse = axial.fused_attention_lse_reference(q, k, v, sm_scale=scale)
                args = (q, k, v, do, lse, axial.attention_dsum(out, do), None, None, scale)
                merges = axial.fused_attention_bwd_merge.launches
                if which == "dq":
                    got = (axial.fused_attention_dq(*args),)
                    ref = (axial.fused_attention_dq_reference(*args),)
                    sm90 = axial.fused_attention_dq.sm90_launches
                else:
                    got = axial.fused_attention_dkv(*args)
                    ref = axial.fused_attention_dkv_reference(*args)
                    sm90 = axial.fused_attention_dkv.sm90_launches
                require(axial.fused_attention_bwd_merge.launches == merges and sm90 > 0,
                        f"K3 {which} at {t} tiles did not run one split on its Hopper kernel")
                worst = (0.0, 0.0)
                for g, r in zip(got, ref):
                    _, _, rel_max, rel_l2, _ = _errors(g, r, torch.bfloat16)
                    worst = (max(worst[0], rel_max), max(worst[1], rel_l2))
                max_rel, l2_rel = TOL["bfloat16"]
                ok = worst[0] <= max_rel and worst[1] <= l2_rel
                out_rows[(which, t)] = worst
                log(f"[k3 streams] {'K3a' if which == 'dq' else 'K3b'} one split of {t} tiles "
                    f"(nq {nq}, nk {nk}): max_abs_err/max|plain| {worst[0]:.3e} (tol "
                    f"{max_rel:g}), rel_l2 {worst[1]:.3e} (tol {l2_rel:g}) "
                    f"{'within' if ok else 'past'} the bf16 bound")
                if t <= getattr(axial, "MAX_GRAD_SPLIT_TILES", t):
                    require(ok, f"K3 {which}: a stream of {t} tiles, within the cap, is past "
                                "the bf16 bound")
                del q, k, v, do, out, lse, args, got, ref
    finally:
        axial.grad_splits = planned
    return out_rows


def phase_kernels():
    import torch

    check_k1_plans()
    check_k2_plans()

    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    # serving path at bucket 128, batch 4 (one dummy slot), dim_head 64:
    # per trunk layer K1 runs two pair axial passes, the MSA column pass
    # and both cross-attentions; K2 the tied MSA row pass
    lens = SERVE_LENGTHS
    axial, msa_col, pair_flat, msa_flat = _serve_masks()
    main = []
    for dt in (bf16, f32):
        reps = 3 if dt == bf16 else 0
        lib = dt == bf16
        main.append(k1_case("pair axial pass (1536x8, 384x384, d64)", 4 * 384, 8, 384, 384,
                            64, dt, axial, axial, reps=reps, library=lib, gen=gen,
                            serving=True))
        main.append(k1_case("MSA column pass (512x8, 5x5, d64)", 4 * 128, 8, 5, 5, 64, dt,
                            msa_col, msa_col, reps=reps, library=lib, gen=gen,
                            serving=True))
        main.append(k1_case("pair<-MSA cross (4x8, 147456x640, d64)", 4, 8, 384 * 384, 640,
                            64, dt, pair_flat, msa_flat, reps=reps, library=lib, gen=gen,
                            serving=True))
        main.append(k1_case("MSA<-pair cross (4x8, 640x147456, d64)", 4, 8, 640, 384 * 384,
                            64, dt, msa_flat, pair_flat, reps=reps, library=lib, gen=gen,
                            serving=True))
        main.append(k2_case("tied MSA rows (4x5x128x8x64, R*D=320)", 4, 5, 128, 8, 64, dt,
                            length=lens, reps=reps, library=lib, gen=gen))
    rows += main
    # edge cases, both dtypes
    for dt in (f32, bf16):
        rows.append(k1_case("ragged tails 200x91 d32", 2, 2, 200, 91, 32, dt,
                            _prefix(200, [197, 150]), _prefix(91, [84, 91]), reps=0,
                            gen=gen))
        rows.append(k1_case("Nk=5 d64", 3, 4, 70, 5, 64, dt, _prefix(70, [70, 60, 5]),
                            _prefix(5, [5, 3, 1]), reps=0, gen=gen))
        rows.append(k1_case("fully masked batch row d16", 2, 2, 64, 64, 16, dt,
                            _prefix(64, [64, 64]), _prefix(64, [0, 64]), reps=0, gen=gen))
        rows.append(k1_case("unmasked 130x130 d128", 1, 2, 130, 130, 128, dt, reps=0,
                            gen=gen))
        # a negative scale: the Hopper kernel's softmax then tracks each
        # row's smallest raw logit
        rows.append(k1_case("negative sm_scale 150x300 d64", 2, 2, 150, 300, 64, dt,
                            _prefix(150, [150, 99]), _prefix(300, [300, 170]), reps=0,
                            gen=gen, sm_scale=-0.125))
        rows.append(k2_case("R*D=1280 (20 rows, d64)", 1, 20, 48, 2, 64, dt, length=[41],
                            reps=0, gen=gen))
        rows.append(k2_case("R*D=80 unmasked (5 rows, d16)", 2, 5, 33, 2, 16, dt, reps=0,
                            gen=gen))
        # the training and gate shapes without lse, a negative scale, and
        # each other Hopper instantiation (head dims 32 and 128)
        rows.append(k2_case("tied rows, training shape (1x5x64x8x64)", 1, 5, 64, 8, 64, dt,
                            length=[53], reps=0, gen=gen))
        rows.append(k2_case("tied rows, gate shape (1x8x256x4x64)", 1, 8, 256, 4, 64, dt,
                            length=[230], reps=0, gen=gen))
        rows.append(k2_case("negative sm_scale (2x5x150x2x64)", 2, 5, 150, 2, 64, dt,
                            length=[150, 99], reps=0, gen=gen, sm_scale=-0.125))
        for name, ((b, r, n, h, d), _) in K2_PLANS.items():
            if name.startswith("d"):
                rows.append(k2_case(f"{name} ({b}x{r}x{n}x{h}x{d})", b, r, n, h, d, dt,
                                    length=[n - 3 * i for i in range(b)], reps=0, gen=gen))
    # fully masked query rows must come out exactly 0
    from alphafold2_tpu_torch.ops.cuda.axial import fused_attention

    q = torch.randn((2, 2, 64, 16), device="cuda", generator=gen)
    none = torch.zeros((2, 64), dtype=torch.bool, device="cuda")
    out = fused_attention(q, q, q, kv_mask=none, sm_scale=0.25)
    require(bool((out == 0).all()), "rows with no valid key are not exactly 0")
    log("[kernels] rows with no valid key: exactly 0")
    return rows


# --------------------------------------------------------------- phase 3


def _ones(b, n):
    import torch

    return torch.ones((b, n), dtype=torch.bool, device="cuda")


def _grad_operands(b, h, nq, nk, d, dtype, gen, strided):
    """q/k/v as _k1_operands builds them, and the output cotangent dO: with
    ``strided`` a (B, H, Nq, D) view of a (B, Nq, H*D) buffer, the layout
    autograd hands back through ops/attention.py's head fold."""
    import torch

    q, k, v = _k1_operands(b, h, nq, nk, d, dtype, gen, strided)
    if strided:
        do = torch.randn((b, nq, h * d), device="cuda", generator=gen).to(dtype)
        do = do.view(b, nq, h, d).transpose(1, 2)
    else:
        do = torch.randn((b, h, nq, d), device="cuda", generator=gen).to(dtype)
    return q, k, v, do


def _check_lse(label, lse, ref, kernel="fused_attention (lse)"):
    import torch

    require(bool((torch.isinf(lse) == torch.isinf(ref)).all()),
            f"{label}: logsumexp rows without a valid key disagree")
    fin = torch.isfinite(ref)
    err = float((lse[fin] - ref[fin]).abs().max()) if bool(fin.any()) else 0.0
    log(f"[backward] {kernel} {label}: lse max_abs_err={err:.3e} (tol 1e-4)")
    require(err <= 1e-4, f"{label}: logsumexp disagrees with its plain version")


def _k3_sm90_launched(args, what):
    """K3a and K3b once each on ``args``; require that both ran the Hopper
    kernels. Returns ((dq, dk, dv), how many merge passes they launched)."""
    from alphafold2_tpu_torch.ops.cuda import axial

    before = (axial.fused_attention_dq.sm90_launches, axial.fused_attention_dkv.sm90_launches,
              axial.fused_attention_bwd_merge.launches)
    dq = axial.fused_attention_dq(*args)
    dk, dv = axial.fused_attention_dkv(*args)
    require(axial.fused_attention_dq.sm90_launches - before[0] == 1,
            f"{what}: K3a did not launch dq_kernel_sm90")
    require(axial.fused_attention_dkv.sm90_launches - before[1] == 1,
            f"{what}: K3b did not launch dkv_kernel_sm90")
    return (dq, dk, dv), axial.fused_attention_bwd_merge.launches - before[2]


def k3_case(label, b, h, nq, nk, d, dtype, q_mask=None, kv_mask=None, reps=3,
            library=False, gen=None, strided=False):
    """K1's training forward, K3a and K3b on one problem, each held against
    its plain version; a negative control; two backward runs bit-identical.
    Returns result rows for K1 (lse), K3a and K3b."""
    import torch
    import torch.nn.functional as F

    from alphafold2_tpu_torch.ops.cuda import axial

    q, k, v, do = _grad_operands(b, h, nq, nk, d, dtype, gen, strided)
    scale = d**-0.5
    forward = lambda: axial.fused_attention_lse(q, k, v, q_mask, kv_mask, scale)
    if strided and dtype == torch.bfloat16:  # a training main-path pass
        route = _k1_route(b, h, nq, nk, d)
        splits = axial.key_splits(b, h, nq, nk, d) if route == "sm90" else 1
        (out, lse), combined = _sm90_launched(forward, label, route)
        require(combined == (splits > 1), f"{label}: combine launches {combined}, "
                                          f"{splits} key splits")
        out2, lse2 = forward()
        require(torch.equal(out, out2) and torch.equal(lse, lse2),
                f"{label}: two K1 (lse) runs differ")
        log(f"[backward] fused_attention (lse) {label}: {K1_ROUTES[route]}, {splits} key "
            f"split(s), two runs bit-identical (out and lse)")
        del out2, lse2
    else:
        out, lse = forward()
    torch.cuda.synchronize()
    ref_out, ref_lse = axial.fused_attention_lse_reference(q, k, v, q_mask, kv_mask, scale)
    fwd = _compare(label, "fused_attention (lse)", out, ref_out, dtype)
    _check_lse(label, lse, ref_lse)
    dsum = axial.attention_dsum(out, do)
    args = (q, k, v, do, lse, dsum, q_mask, kv_mask, scale)
    if strided and dtype == torch.bfloat16:  # a training main-path pass
        (dq, dk, dv), merged = _k3_sm90_launched(args, label)
        splits = (axial.grad_splits(b, h, nq, nk, d, "dq"),
                  axial.grad_splits(b, h, nq, nk, d, "dkv"))
        require(merged == sum(s > 1 for s in splits),
                f"{label}: merge launches {merged}, splits (K3a, K3b) {splits}")
        log(f"[backward] {label}: dq_kernel_sm90 and dkv_kernel_sm90, splits (K3a, K3b) "
            f"{splits}, {merged} merge pass(es)")
    else:
        dq = axial.fused_attention_dq(*args)
        dk, dv = axial.fused_attention_dkv(*args)
    torch.cuda.synchronize()
    rq = axial.fused_attention_dq_reference(*args)
    rk, rv = axial.fused_attention_dkv_reference(*args)
    row_q = _compare(label, "fused_attention_bwd_dq", dq, rq, dtype)
    row_k = _compare(label, "fused_attention_bwd_dkv dk", dk, rk, dtype)
    row_v = _compare(label, "fused_attention_bwd_dkv dv", dv, rv, dtype)
    row_kv = dict(row_k, kernel="fused_attention_bwd_dkv",
                  max_abs_err=max(row_k["max_abs_err"], row_v["max_abs_err"]))
    row_q["kernel"] = "fused_attention_bwd_dq"
    require(torch.equal(dq, axial.fused_attention_dq(*args)), f"{label}: K3a not deterministic")
    dk2, dv2 = axial.fused_attention_dkv(*args)
    require(torch.equal(dk, dk2) and torch.equal(dv, dv2), f"{label}: K3b not deterministic")
    log(f"[backward] {label} {fwd['dtype']}: two backward runs bit-identical")
    if strided:
        # negative control: without each row's last key tile (dq), without
        # each key's last query tile (dk, dv)
        qm = q_mask if q_mask is not None else _ones(b, nq)
        km = kv_mask if kv_mask is not None else _ones(b, nk)
        short = axial.fused_attention_dq(q, k, v, do, lse, dsum, qm, _drop_last_tile(km), scale)
        _control(label, "fused_attention_bwd_dq", short, rq, dtype)
        sk, sv = axial.fused_attention_dkv(q, k, v, do, lse, dsum, _drop_last_tile(qm), km,
                                           scale)
        _control(label, "fused_attention_bwd_dkv dk", sk, rk, dtype, tile="query")
        _control(label, "fused_attention_bwd_dkv dv", sv, rv, dtype, tile="query")
        del short, sk, sv
        if dtype == torch.bfloat16:
            merge_checks(label, args, (rq, rk, rv))
    for r, bound in zip((fwd, row_q, row_kv),
                        _k3_bounds(b, h, nq, nk, d, q_mask, kv_mask, dtype)):
        r.update(bound)
    if reps:
        fwd["ms"] = cuda_ms(forward, reps)
        fwd["host_us"] = _host_us(forward)
        fwd["plain_ms"] = cuda_ms(lambda: axial.fused_attention_lse_reference(
            q, k, v, q_mask, kv_mask, scale), reps=1, warmup=0)
        row_q["ms"] = cuda_ms(lambda: axial.fused_attention_dq(*args), reps)
        row_kv["ms"] = cuda_ms(lambda: axial.fused_attention_dkv(*args), reps)
        row_q["plain_ms"] = cuda_ms(lambda: axial.fused_attention_dq_reference(*args),
                                    reps=1, warmup=0)
        row_kv["plain_ms"] = cuda_ms(lambda: axial.fused_attention_dkv_reference(*args),
                                     reps=1, warmup=0)
        if library:
            # the same masked problem through SDPA: its forward once, then
            # its backward (dq, dk and dv in one call) timed
            am = kv_mask[:, None, None, :] if kv_mask is not None else None
            try:
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                o = F.scaled_dot_product_attention(*leaves, attn_mask=am, scale=scale)
                fwd["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=am, scale=scale), reps)
                bwd = cuda_ms(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True),
                              reps)
                row_q["library_ms"] = row_kv["library_ms"] = bwd
                del o, leaves
            except (RuntimeError, torch.OutOfMemoryError) as e:
                log(f"[backward] {label}: scaled_dot_product_attention failed: {e}")
                fwd["library_ms"] = row_q["library_ms"] = row_kv["library_ms"] = None
    del q, k, v, do, out, lse, dq, dk, dv, rq, rk, rv
    torch.cuda.empty_cache()
    return [fwd, row_q, row_kv]


def _k3_bounds(b, h, nq, nk, d, q_mask, kv_mask, dtype):
    """The bounds (_bound) of K1 with lse, K3a and K3b on one problem: each
    of q, k, v, dO (and the masks) read once, each output written once."""
    import torch

    qv = q_mask.sum(1) if q_mask is not None else torch.full((b,), nq, device="cuda")
    kvn = kv_mask.sum(1) if kv_mask is not None else torch.full((b,), nk, device="cuda")
    pairs = h * float((qv * kvn).sum())
    es = torch.finfo(dtype).bits // 8
    reads = (2 * b * h * nq * d + 2 * b * h * nk * d) * es + (
        (b * nq if q_mask is not None else 0) + (b * nk if kv_mask is not None else 0))
    rows_lse = 4 * b * h * nq
    # the forward reads q, k, v and writes out (as many bytes as q, k, v, dO);
    # K3a: q.k recompute, dO.v, ds.k; K3b: q.k recompute, dO.v, p^T dO, ds^T q
    return (_bound(4.0 * d * pairs, reads + rows_lse, dtype),
            _bound(6.0 * d * pairs, reads + 2 * rows_lse + b * h * nq * d * es, dtype),
            _bound(8.0 * d * pairs, reads + 2 * rows_lse + 2 * b * h * nk * d * es, dtype))


def merge_checks(label, args, refs):
    """Where K3a or K3b splits this pass: K3's merge kernel alone on the
    plain per-split partials against the plain merge, the merged gradient
    against the plain whole one, and the negative control, a merge that
    drops the last split, which the bound must reject."""
    import torch

    from alphafold2_tpu_torch.ops.cuda import axial

    q, k, v = args[:3]
    b, h, nq, d = q.shape
    nk = k.shape[2]
    scale = args[-1]
    for which in ("dq", "dkv"):
        splits = axial.grad_splits(b, h, nq, nk, d, which)
        if splits == 1:
            continue
        if which == "dq":
            parts = {"dq": (axial.dq_partials_reference(*args, splits=splits), scale, refs[0])}
        else:
            pk, pv = axial.dkv_partials_reference(*args, splits=splits)
            parts = {"dk": (pk, scale, refs[1]), "dv": (pv, 1.0, refs[2])}
        for name, (part, sc, ref) in parts.items():
            before = axial.fused_attention_bwd_merge.launches
            merged = axial.fused_attention_bwd_merge(part, sc)
            torch.cuda.synchronize()
            require(axial.fused_attention_bwd_merge.launches == before + 1,
                    f"{label}: the merge kernel did not launch")
            plain = axial.merge_grad_partials_reference(part, sc, torch.bfloat16)
            _compare(f"{label}, {name}, {splits} splits", "fused_attention_bwd_merge", merged,
                     plain, torch.bfloat16)
            _compare(f"{label}, {name} merged", "fused_attention_bwd_merge", merged, ref,
                     torch.bfloat16)
            short = axial.fused_attention_bwd_merge(part[:-1], sc)
            _control(f"{label}, {name}", "fused_attention_bwd_merge", short, ref,
                     torch.bfloat16, tile="split")
            del part, merged, plain, short
        del parts


# training shapes: crop 128, batch 1, heads 8, dim_head 64, one synthetic
# chain of TRAIN_LEN residues (its MSA, 5 x 64, is fully valid); per trunk
# layer two pair axial passes, the MSA column and row passes, both crosses
TRAIN_LEN = 110
TRAIN_CASES = {  # label: (b, nq, nk, per-layer calls)
    "pair axial (128x8, 128x128)": (128, 128, 128, 2),
    "MSA column (64x8, 5x5)": (64, 5, 5, 1),
    "MSA row (5x8, 64x64)": (5, 64, 64, 1),
    "pair<-MSA (1x8, 16384x320)": (1, 16384, 320, 1),
    "MSA<-pair (1x8, 320x16384)": (1, 320, 16384, 1),
}


def _train_masks(label):
    res = _prefix(128, [TRAIN_LEN])  # (1, 128) residues
    pair = (res[:, :, None] & res[:, None, :])[0]  # (128, 128)
    msa = _ones(1, 5 * 64)
    return {
        "pair axial (128x8, 128x128)": (pair, pair),
        "MSA column (64x8, 5x5)": (_ones(64, 5), _ones(64, 5)),
        "MSA row (5x8, 64x64)": (_ones(5, 64), _ones(5, 64)),
        "pair<-MSA (1x8, 16384x320)": (pair.reshape(1, -1), msa),
        "MSA<-pair (1x8, 320x16384)": (msa, pair.reshape(1, -1)),
    }[label]


def combine_case(label, b, h, nq, nk, d, q_mask, kv_mask, gen):
    """K1's combine pass alone against its plain version, on the plain
    per-split partials of one problem (with the lse)."""
    import torch

    from alphafold2_tpu_torch.ops.cuda import axial

    q, k, v = _k1_operands(b, h, nq, nk, d, torch.bfloat16, gen, serving=False)
    splits = axial.key_splits(b, h, nq, nk, d)
    m, l, acc = axial.attention_partials_reference(q, k, v, kv_mask, d**-0.5, splits)
    before = axial.fused_attention_combine.launches
    out, lse = axial.fused_attention_combine(m, l, acc, q_mask, with_lse=True)
    torch.cuda.synchronize()
    require(axial.fused_attention_combine.launches == before + 1,
            f"{label}: the combine kernel did not launch")
    ref, ref_lse = axial.combine_partials_reference(m, l, acc, q_mask, with_lse=True)
    row = _compare(f"{label}, {splits} splits", "fused_attention_combine", out, ref,
                   torch.bfloat16)
    _check_lse(label, lse, ref_lse, "fused_attention_combine")
    return row


# K3's five main-path passes (the training passes of TRAIN_CASES, heads 8,
# d 64) and the split counts (K3a, K3b) of ops/cuda/axial.py grad_splits
K3_SPLITS = {
    "pair axial (128x8, 128x128)": (1, 1),
    "MSA column (64x8, 5x5)": (1, 1),
    "MSA row (5x8, 64x64)": (1, 1),
    "pair<-MSA (1x8, 16384x320)": (1, 7),
    "MSA<-pair (1x8, 320x16384)": (7, 1),
}
K3_SM90 = ("dq_kernel_sm90<64>", "dkv_kernel_sm90<64>")


def check_k3_plans():
    """K3a's and K3b's plans on each training pass (bf16, TMA-aligned
    operands) must name the Hopper kernels with the expected splits, and a
    split pass the merge kernel."""
    import ctypes

    from alphafold2_tpu_torch.ops.cuda import build
    from alphafold2_tpu_torch.ops.cuda.axial import grad_splits

    lib = build.library("fused_attention_bwd")
    for label, (b, nq, nk, _) in TRAIN_CASES.items():
        h, d = 8, 64
        for which, name, want, outs, rows in ((0, "dq", K3_SM90[0], 1, nq),
                                              (1, "dkv", K3_SM90[1], 2, nk)):
            splits = grad_splits(b, h, nq, nk, d, name)
            require(splits == K3_SPLITS[label][which],
                    f"{label}: grad_splits gives {splits} for {name}, not "
                    f"{K3_SPLITS[label][which]}")
            plan = build.LaunchPlan()
            build.check(lib, lib.af2_fused_attention_bwd_plan(which, 1, b, h, nq, nk, d, splits,
                                                              1, ctypes.byref(plan)), "K3 plan")
            kernel = plan.kernel.decode()
            line = f"{kernel}, {plan.blocks} blocks of {plan.threads}, {plan.dynamic_smem} B"
            if splits > 1:
                merge = build.LaunchPlan()
                build.check(lib, lib.af2_fused_attention_bwd_merge_plan(
                    outs, b, h, rows, d, ctypes.byref(merge)), "K3 merge plan")
                line += f"; {splits} splits, then {merge.kernel.decode()} ({merge.blocks} blocks)"
                require(merge.kernel.decode() == "grad_merge_kernel<64>",
                        f"{label}: the merge pass plans {merge.kernel.decode()}")
            log(f"[backward] K3{'ab'[which]} plan, {label}: {line}")
            require(kernel == want, f"{label}: K3{'ab'[which]} plans {kernel}, not {want}")


def unaligned_k3_case(gen):
    """bf16 operands TMA cannot describe (views one element into a buffer
    with rows of 65): the plan must take the older tile kernels, which
    launch no Hopper kernel and no merge, and agree with the plain
    versions."""
    import torch

    from alphafold2_tpu_torch.ops.cuda import axial

    b, h, nq, nk, d = 2, 2, 150, 200, 64
    q, k, v, do = (torch.randn((b, h, n, d + 1), device="cuda", generator=gen)
                   .to(torch.bfloat16)[..., 1:] for n in (nq, nk, nk, nq))
    qm, km = _prefix(nq, [150, 111]), _prefix(nk, [200, 77])
    out, lse = axial.fused_attention_lse(q, k, v, qm, km, d**-0.5)
    args = (q, k, v, do, lse, axial.attention_dsum(out, do), qm, km, d**-0.5)
    counts = lambda: (axial.fused_attention_dq.sm90_launches,
                      axial.fused_attention_dkv.sm90_launches,
                      axial.fused_attention_bwd_merge.launches)
    before = counts()
    dq = axial.fused_attention_dq(*args)
    dk, dv = axial.fused_attention_dkv(*args)
    torch.cuda.synchronize()
    require(counts() == before, "unaligned bf16 operands reached a Hopper K3 kernel")
    label = "unaligned operands 150x200 d64"
    _compare(label, "fused_attention_bwd_dq", dq, axial.fused_attention_dq_reference(*args),
             torch.bfloat16)
    for name, got, ref in zip(("dk", "dv"), (dk, dv), axial.fused_attention_dkv_reference(*args)):
        _compare(label, f"fused_attention_bwd_dkv {name}", got, ref, torch.bfloat16)
    log(f"[backward] {label}: dq_kernel_mma and dkv_kernel_mma, no merge")


def phase_backward():
    import torch

    check_k3_plans()
    gen = torch.Generator(device="cuda").manual_seed(1)
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    for dt in (bf16, f32):
        for label, (b, nq, nk, _) in TRAIN_CASES.items():
            qm, km = _train_masks(label)
            rows += k3_case(label, b, 8, nq, nk, 64, dt, qm, km, reps=3 if dt == bf16 else 0,
                            library=dt == bf16, gen=gen, strided=True)
    label = "MSA<-pair (1x8, 320x16384)"
    combine_case(label, 1, 8, 320, 16384, 64, *_train_masks(label), gen)
    for dt in (f32, bf16):
        rows += k3_case("ragged tails 200x91 d32", 2, 2, 200, 91, 32, dt,
                        _prefix(200, [197, 150]), _prefix(91, [84, 91]), reps=0, gen=gen)
        rows += k3_case("Nk=5 d64", 3, 4, 70, 5, 64, dt, _prefix(70, [70, 60, 5]),
                        _prefix(5, [5, 3, 1]), reps=0, gen=gen)
        rows += k3_case("fully masked batch row d16", 2, 2, 64, 64, 16, dt,
                        _prefix(64, [64, 64]), _prefix(64, [0, 64]), reps=0, gen=gen)
        rows += k3_case("unmasked 130x130 d128", 1, 2, 130, 130, 128, dt, reps=0, gen=gen)
    unaligned_k3_case(gen)
    # a batch row with no valid key: zero, finite gradients
    from alphafold2_tpu_torch.ops.cuda.axial import fused_attention

    q, k, v = (torch.randn((2, 2, 64, 16), device="cuda", generator=gen).requires_grad_()
               for _ in range(3))
    km = _prefix(64, [0, 64])
    fused_attention(q, k, v, kv_mask=km, sm_scale=0.25).sum().backward()
    for g in (q.grad, k.grad, v.grad):
        require(bool(torch.isfinite(g).all()) and bool((g[0] == 0).all()),
                "a row with no valid key has nonzero or non-finite gradients")
    log("[backward] rows with no valid key: gradients exactly 0, all finite")
    return rows


# --------------------------------------------------------------- phase 3b


HEAD_DIM_CASES = (48, 256)  # padded to 64; past 128 as rows of 64


def head_dim_case(d, dtype, gen):
    """K1, K1 with lse, K3a and K3b at a head dim no kernel is built for,
    each against its plain version (k1_case, k3_case); past head dim 128 in
    bf16, K1 with and without lse on K2's Hopper walk (the head dim as rows
    of 64), twice bit for bit, with a control that drops each row's last key
    tile; then the autograd route, which must launch K1 (lse), K3a and K3b
    once each, call no plain version, and give the direct calls' results bit
    for bit."""
    import torch

    from alphafold2_tpu_torch.ops.cuda import axial
    from alphafold2_tpu_torch.ops.cuda import tied_row as tr

    b, h, nq, nk = 2, 4, 200, 150
    label = f"head dim {d} (2x4, 200x150)"
    qm, km = _prefix(nq, [200, 123]), _prefix(nk, [150, 77])
    rows = k3_case(label, b, h, nq, nk, d, dtype, qm, km, reps=0, gen=gen)
    rows.append(k1_case(label, b, h, nq, nk, d, dtype, qm, km, reps=0, gen=gen))
    q, k, v, do = _grad_operands(b, h, nq, nk, d, dtype, gen, strided=True)
    scale = d**-0.5
    if d > axial.HEAD_DIMS[-1] and dtype == torch.bfloat16:
        # K1 past head dim 128 runs on K2's Hopper walk, the head dim read as
        # rows of 64: with and without lse, bit-identical reruns, a control
        # without each row's last key tile
        fwd = lambda: axial.fused_attention(q, k, v, q_mask=qm, kv_mask=km, sm_scale=scale)
        lse_fwd = lambda: axial.fused_attention_lse(q, k, v, qm, km, scale)
        out0, _ = _sm90_launched(fwd, label, "rows")
        (out1, lse1), _ = _sm90_launched(lse_fwd, label, "rows")
        again = lse_fwd()
        require(torch.equal(out0, fwd()) and torch.equal(out1, again[0])
                and torch.equal(lse1, again[1]), f"{label}: two K1 runs on the rows differ")
        ref, ref_lse = axial.fused_attention_lse_reference(q, k, v, qm, km, scale)
        _compare(label, "fused_attention (rows)", out0, ref, dtype)
        _compare(label, "fused_attention (rows, lse)", out1, ref, dtype)
        _check_lse(label, lse1, ref_lse)
        _control(label, "fused_attention (rows)",
                 axial.fused_attention(q, k, v, q_mask=qm, kv_mask=_drop_last_tile(km),
                                       sm_scale=scale), ref, dtype)
        log(f"[head dims] {label} bfloat16: K1 with and without lse on {K1_ROUTES['rows']} "
            f"({axial.row_width(d)}-wide rows), two runs bit-identical")
        del out0, out1, lse1, again, ref, ref_lse
    plain = (axial.fused_attention_reference, axial.fused_attention_lse_reference,
             axial.fused_attention_dq_reference, axial.fused_attention_dkv_reference)
    wrappers = (axial.fused_attention, axial.fused_attention_dq, axial.fused_attention_dkv)
    calls, launches = [f.calls for f in plain], [f.launches for f in wrappers]
    hopper = [f.sm90_launches for f in wrappers[1:]]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = axial.fused_attention(*leaves, q_mask=qm, kv_mask=km, sm_scale=scale)
    out.backward(do)
    torch.cuda.synchronize()
    ran = [f.launches - n for f, n in zip(wrappers, launches)]
    require(ran == [1, 1, 1], f"{label}: the autograd route launched {ran} (K1, K3a, K3b)")
    if d > axial.HEAD_DIMS[-1]:
        # past head dim 128 K3a/K3b run tied_row_attention_bwd.cu on rows of
        # 64, on its Hopper kernels wherever their plan takes the shape
        plans = [tr.hopper_bwd_plan(w, b, h, nq, nk, d, axial.row_width(d))
                 if dtype == torch.bfloat16 else None for w in ("dq", "dkv")]
        hop = [f.sm90_launches - n for f, n in zip(wrappers[1:], hopper)]
        require(hop == [int(x is not None) for x in plans],
                f"{label}: the backward ran {hop} Hopper launches, plans {plans}")
        log(f"[head dims] {label} {rows[0]['dtype']}: K3a/K3b on "
            f"{[x['kernel'] if x else 'the chunked kernels' for x in plans]}")
    require([f.calls for f in plain] == calls, f"{label}: a plain version ran on the card")
    out2, lse = axial.fused_attention_lse(q, k, v, qm, km, scale)
    args = (q, k, v, do, lse, axial.attention_dsum(out2, do), qm, km, scale)
    dk, dv = axial.fused_attention_dkv(*args)
    require(torch.equal(out.detach(), out2) and torch.equal(leaves[0].grad,
                                                            axial.fused_attention_dq(*args))
            and torch.equal(leaves[1].grad, dk) and torch.equal(leaves[2].grad, dv),
            f"{label}: the autograd route differs from the direct kernel calls")
    log(f"[head dims] {label} {rows[0]['dtype']}: through kernels only, at head dim "
        f"{axial.kernel_head_dim(d)}; autograd route bit-identical to the direct calls")
    return rows


def phase_head_dims():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for d in HEAD_DIM_CASES:
        for dt in (torch.float32, torch.bfloat16):
            rows += head_dim_case(d, dt, gen)
    return rows


# --------------------------------------------------------------- phase 3c


# K2's shapes (b, r, n, h, d) under grad: the tied training path (MSA 5 x 64,
# 8 heads, R*D 320; 6 layers, one call each a step) and JAX's gate case
# case_tied_row_bwd (R*D 512)
TIED_TRAIN_LABEL = "tied rows, training (1x5x64x8x64, R*D 320)"
TIED_CASES = {TIED_TRAIN_LABEL: (1, 5, 64, 8, 64),
              "tied rows, gate (1x8x256x4x64, R*D 512)": (1, 8, 256, 4, 64)}


def _tied_operands(b, r, n, h, d, dtype, gen, rows=None):
    """q, k, v, dO (B, R, N, H, D) and the shared mask and tie scale as
    ops/attention.py builds them from the MSA mask ``rows`` (B, R, N), by
    default: the last n/8 columns masked, row 1 ragged (half as long), a
    middle row absent (the last row keeps its data, which the feature-chunk
    controls drop); padded entries of q, k, v zeroed, the tie scale
    counting the voting rows."""
    import torch

    if rows is None:
        rows = torch.ones((b, r, n), dtype=torch.bool, device="cuda")
        rows[:, :, n - n // 8:] = False
        rows[:, 1, n // 2:] = False
        rows[:, r // 2] = False
    q, k, v, do = (torch.randn((b, r, n, h, d), device="cuda", generator=gen)
                   for _ in range(4))
    q, k, v = (t * rows[..., None, None] for t in (q, k, v))
    tie = rows.any(-1).sum(-1).clamp_min(1).float() ** -0.5
    return (*(t.to(dtype).contiguous() for t in (q, k, v, do)), rows.any(1), tie)


def _drop_last_chunk(t, chunk=64):
    """A copy of (B, R, N, H, D) ``t`` whose last ``chunk`` fused features
    (f = r*D + d) are 0: what a kernel that skipped its last feature chunk
    would read."""
    t = t.clone()
    r, d = t.shape[1], t.shape[-1]
    for row in range(r):
        lo = max(0, r * d - chunk - row * d)
        if lo < d:
            t[:, row, ..., lo:] = 0
    return t


def _sdpa_backend(fn):
    """The first SDPA backend (flash, memory-efficient, cuDNN, math) that
    runs ``fn``, or None."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                fn()
                torch.cuda.synchronize()
            return backend
        except RuntimeError:
            continue
    return None


def tied_case(label, b, r, n, h, d, dtype, gen, reps=3, library=False, rows=None):
    """K2 with lse, and K2's backward (dq; dk and dv; the three in one call,
    tied_row_attention_grads), at one tied shape (with the MSA mask
    ``rows``, else _tied_operands' own), each against its plain version; a
    negative control per kernel (the last feature chunk dropped from its
    recomputation); two forward and two backward runs bit-identical; in
    bf16 every launch on the Hopper kernels the plans name (the resident
    ones or the wide route, whose passes, splits and blocks are logged);
    the autograd route through the kernels alone. Returns result rows for
    the three kernels (the backward's ``grads_ms``: the one call)."""
    import torch
    import torch.nn.functional as F

    from alphafold2_tpu_torch.ops.cuda import tied_row as tr

    q, k, v, do, mask, tie = _tied_operands(b, r, n, h, d, dtype, gen, rows)
    scale = d**-0.5
    forward = lambda: tr.tied_row_attention_lse(q, k, v, mask, mask, scale, tie)
    plan = _k2_planned(b, r, n, h, d, dtype)
    if plan is not None:
        out, lse = _k2_sm90_launched(forward, label, plan["wide"])
        again = forward()
        require(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
                f"{label}: two K2 (lse) runs differ")
        log(f"[tied] {label}: K2 with lse on {_describe(plan)}, two runs bit-identical")
    else:
        out, lse = forward()
    torch.cuda.synchronize()
    ref_out, ref_lse = tr.tied_row_attention_lse_reference(q, k, v, mask, mask, scale, tie)
    fwd = _compare(label, "tied_row_attention (lse)", out, ref_out, dtype)
    _check_lse(label, lse, ref_lse, "tied_row_attention (lse)")
    _control(label, "tied_row_attention (lse)",
             tr.tied_row_attention_lse(_drop_last_chunk(q), k, v, mask, mask, scale, tie)[0],
             ref_out, dtype, tile="feature")
    dsum = tr.tied_row_dsum(out, do)
    args = (q, k, v, do, lse, dsum, mask, mask, scale, tie)
    bwd = (tr.tied_row_attention_dq, tr.tied_row_attention_dkv)
    plans = _k2_bwd_planned(b, r, n, h, d, dtype)
    counts = lambda: [(f.sm90_launches, f.wide_launches) for f in bwd]
    before = counts()
    dq = tr.tied_row_attention_dq(*args)
    dk, dv = tr.tied_row_attention_dkv(*args)
    torch.cuda.synchronize()
    hop = [(a - a0, w - w0) for (a, w), (a0, w0) in zip(counts(), before)]
    require(hop == [(int(x is not None), int(x is not None and x["wide"])) for x in plans],
            f"{label}: K2's backward ran (Hopper, wide) launches {hop}, plans {plans}")
    log(f"[tied] {label}: K2's backward dq on {_describe(plans[0])}; dk/dv on "
        f"{_describe(plans[1])}")
    # the three in one call: on the wide route one logits and one p, ds pass
    before = counts()
    joint = tr.tied_row_attention_grads(*args)
    require([(a - a0, w - w0) for (a, w), (a0, w0) in zip(counts(), before)] == hop,
            f"{label}: tied_row_attention_grads left the kernels of the two wrappers")
    require(all(torch.equal(x, y) for x, y in zip(joint, (dq, dk, dv))),
            f"{label}: tied_row_attention_grads differs from the two wrappers")
    log(f"[tied] {label}: tied_row_attention_grads bit-identical to dq and dk/dv")
    rq = tr.tied_row_attention_dq_reference(*args)
    rk, rv = tr.tied_row_attention_dkv_reference(*args)
    row_q = _compare(label, "tied_row_attention_bwd_dq", dq, rq, dtype)
    row_k = _compare(label, "tied_row_attention_bwd_dkv dk", dk, rk, dtype)
    row_v = _compare(label, "tied_row_attention_bwd_dkv dv", dv, rv, dtype)
    row_kv = dict(row_k, kernel="tied_row_attention_bwd_dkv",
                  max_abs_err=max(row_k["max_abs_err"], row_v["max_abs_err"]))
    require(torch.equal(dq, tr.tied_row_attention_dq(*args)), f"{label}: dq not deterministic")
    dk2, dv2 = tr.tied_row_attention_dkv(*args)
    require(torch.equal(dk, dk2) and torch.equal(dv, dv2), f"{label}: dk/dv not deterministic")
    # negative controls: q and dO feed only S and dO.V^T in the dq kernel, k
    # and v only S and dO.V^T in the dk/dv kernel
    short = tr.tied_row_attention_dq(_drop_last_chunk(q), k, v, _drop_last_chunk(do), lse,
                                     dsum, mask, mask, scale, tie)
    _control(label, "tied_row_attention_bwd_dq", short, rq, dtype, tile="feature")
    sk, sv = tr.tied_row_attention_dkv(q, _drop_last_chunk(k), _drop_last_chunk(v), do, lse,
                                       dsum, mask, mask, scale, tie)
    _control(label, "tied_row_attention_bwd_dkv dk", sk, rk, dtype, tile="feature")
    _control(label, "tied_row_attention_bwd_dkv dv", sv, rv, dtype, tile="feature")
    # the autograd route: K2 (lse), then both backward kernels, nothing else
    wrappers = (tr.tied_row_attention, tr.tied_row_attention_dq, tr.tied_row_attention_dkv)
    before = [f.launches for f in wrappers]
    hopper = counts()
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    tr.tied_row_attention(*leaves, q_mask=mask, kv_mask=mask, sm_scale=scale,
                          tie_scale=tie).backward(do)
    ran = [f.launches - n0 for f, n0 in zip(wrappers, before)]
    require(ran == [1, 1, 1], f"{label}: the autograd route launched {ran}")
    require([(a - a0, w - w0) for (a, w), (a0, w0) in zip(counts(), hopper)] == hop,
            f"{label}: the autograd route's backward left the Hopper kernels")
    require(all(torch.equal(a.grad, x) for a, x in zip(leaves, (dq, dk, dv))),
            f"{label}: the autograd route differs from the direct kernel calls")
    log(f"[tied] {label} {fwd['dtype']}: autograd route bit-identical to the direct calls")
    # bounds: each of q, k, v, dO read once, each output written once
    nv = mask.sum(1).double()
    pairs = h * float((nv * nv).sum())
    f_ = r * d
    es = q.element_size()
    operand = b * r * n * h * d * es
    stats = 4 * b * h * n
    fwd.update(_bound(4.0 * f_ * pairs, 4 * operand + stats + 2 * b * n, dtype))
    row_q.update(_bound(6.0 * f_ * pairs, 5 * operand + 2 * stats + 2 * b * n, dtype))
    row_kv.update(_bound(8.0 * f_ * pairs, 6 * operand + 2 * stats + 2 * b * n, dtype))
    if reps:
        fwd["ms"] = cuda_ms(forward, reps)
        row_q["ms"] = cuda_ms(lambda: tr.tied_row_attention_dq(*args), reps)
        row_kv["ms"] = cuda_ms(lambda: tr.tied_row_attention_dkv(*args), reps)
        row_q["grads_ms"] = cuda_ms(lambda: tr.tied_row_attention_grads(*args), reps)
        if plan is not None and plan["wide"]:  # device time by pass
            profile_device(f"K2 with lse on the wide route, {label}", forward)
            profile_device(f"K2's backward in one call on the wide route, {label}",
                           lambda: tr.tied_row_attention_grads(*args))
        fwd["plain_ms"] = cuda_ms(lambda: tr.tied_row_attention_lse_reference(
            q, k, v, mask, mask, scale, tie), reps)
        row_q["plain_ms"] = cuda_ms(lambda: tr.tied_row_attention_dq_reference(*args), reps)
        row_kv["plain_ms"] = cuda_ms(lambda: tr.tied_row_attention_dkv_reference(*args), reps)
        if library:
            # SDPA on the folded (B, H, N, R*D) tensors, the tie scale in q
            from torch.nn.attention import sdpa_kernel

            fold = lambda t: t.permute(0, 3, 2, 1, 4).reshape(b, h, n, r * d)
            qf = (fold(q).float() * tie[:, None, None, None]).to(dtype)
            leaves = [t.detach().requires_grad_() for t in (qf, fold(k), fold(v))]
            am = mask[:, None, None, :]
            sdpa = lambda *t: F.scaled_dot_product_attention(*t, attn_mask=am, scale=scale)
            backend = _sdpa_backend(lambda: sdpa(*leaves).backward(fold(do)))
            fwd["library"] = row_q["library"] = row_kv["library"] = (
                backend.name if backend is not None else None)
            if backend is None:
                fwd["library_ms"] = row_q["library_ms"] = row_kv["library_ms"] = None
            else:
                with sdpa_kernel([backend]):
                    o = sdpa(*leaves)
                    g = fold(do)
                    fwd["library_ms"] = cuda_ms(lambda: sdpa(*(t.detach() for t in leaves)),
                                                reps)
                    row_q["library_ms"] = row_kv["library_ms"] = cuda_ms(
                        lambda: torch.autograd.grad(o, leaves, g, retain_graph=True), reps)
            log(f"[tied] {label} {fwd['dtype']}: SDPA takes head dim {r * d} on its "
                f"{fwd['library']} backend")
    return [fwd, row_q, row_kv]


def phase_tied():
    """K2's backward plans (check_k2_bwd_plans), then K2 with lse and K2's
    backward at the tied training shape and the gate's shape, f32 and
    bf16."""
    import torch

    check_k2_bwd_plans()
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        for label, shape in TIED_CASES.items():
            timed = dt == torch.bfloat16 and label == TIED_TRAIN_LABEL
            rows += tied_case(label, *shape, dt, gen, reps=10 if timed else 0, library=timed)
    return rows


# --------------------------------------------------------------- phase 5


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


def _plain_versions():
    """Every kernel's plain PyTorch version (each counts its ``calls``)."""
    from alphafold2_tpu_torch.ops.cuda import axial, block_sparse, tied_row

    return (axial.fused_attention_reference, axial.fused_attention_lse_reference,
            axial.fused_attention_dq_reference, axial.fused_attention_dkv_reference,
            tied_row.tied_row_attention_reference, tied_row.tied_row_attention_lse_reference,
            tied_row.tied_row_attention_dq_reference, tied_row.tied_row_attention_dkv_reference,
            block_sparse.block_sparse_attention_reference,
            block_sparse.block_sparse_attention_lse_reference,
            block_sparse.block_sparse_attention_dq_reference,
            block_sparse.block_sparse_attention_dkv_reference, *tied_row.SPLIT_PLAIN)


def _training_kernels():
    """The wrappers a training step can launch, by kernel-line name (each
    counts its ``launches``; the Hopper ones also ``sm90_launches``)."""
    from alphafold2_tpu_torch.ops.cuda import axial, block_sparse, tied_row

    return {"fused_attention": axial.fused_attention,
            "fused_attention_combine": axial.fused_attention_combine,
            "fused_attention_bwd_dq": axial.fused_attention_dq,
            "fused_attention_bwd_dkv": axial.fused_attention_dkv,
            "fused_attention_bwd_merge": axial.fused_attention_bwd_merge,
            "tied_row_attention": tied_row.tied_row_attention,
            "tied_row_attention_bwd_dq": tied_row.tied_row_attention_dq,
            "tied_row_attention_bwd_dkv": tied_row.tied_row_attention_dkv,
            "block_sparse_attention": block_sparse.block_sparse_attention_lse,
            "block_sparse_attention (no lse)": block_sparse.block_sparse_attention,
            "block_sparse_attention_bwd_dq": block_sparse.block_sparse_attention_dq,
            "block_sparse_attention_bwd_dkv": block_sparse.block_sparse_attention_dkv,
            **{fn.__name__: fn for fn in tied_row.SPLIT_PASSES}}


def _reset_counts(kernels, plain):
    """Every launch count, Hopper launch count and plain-version call count to 0."""
    for fn in kernels.values():
        fn.launches = 0
        for count in ("sm90_launches", "wide_launches", "packed_launches", "row_launches"):
            if hasattr(fn, count):
                setattr(fn, count, 0)
    for fn in plain:
        fn.calls = 0


def phase_train(sparse=False, tied=False):
    """The training checks at the slice configuration; with ``sparse``,
    model.sparse_self_attn=True (log tag ``[sparse train]``), with ``tied``
    model.msa_tie_row_attn=True (``[tied train]``: the MSA row pass through
    K2 with lse and K2's backward)."""
    import itertools

    import numpy as np
    import torch

    from alphafold2_tpu_torch.config import Config
    from alphafold2_tpu_torch.data.pipeline import SyntheticDataset
    from alphafold2_tpu_torch.train import loop

    tag = "[sparse train]" if sparse else "[tied train]" if tied else "[train]"
    plain = _plain_versions()
    kernels = _training_kernels()

    # (a) the slice configuration at ENGINE_DEPTH: 32 steps = 2 accumulated
    # updates
    cfg = Config()
    cfg.model.depth = ENGINE_DEPTH
    cfg.model.sparse_self_attn = sparse
    cfg.model.msa_tie_row_attn = tied
    depth = cfg.model.depth
    steps = 2 * cfg.train.gradient_accumulate_every
    snap, changed, times, losses, oks = {}, [], [], [], []

    def watch(i, state, metrics):
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        if "p0" not in snap:
            snap["p0"] = _params(state.model)  # after step 0 (lr 0 or no update)
        same = all(torch.equal(a, b) for a, b in zip(snap["p0"], state.model.parameters()))
        changed.append(not same)
        losses.append(float(metrics["loss"]))
        oks.append((bool(metrics["grads_ok"]), int(metrics["skipped"])))

    _reset_counts(kernels, plain)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = loop.train(cfg, num_steps=steps, callbacks=[watch])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    sm90 = {name: kernels[name].sm90_launches
            for name in ("fused_attention", "fused_attention_bwd_dq", "fused_attention_bwd_dkv",
                         "tied_row_attention", "tied_row_attention_bwd_dq",
                         "tied_row_attention_bwd_dkv", "block_sparse_attention",
                         "block_sparse_attention (no lse)",
                         "block_sparse_attention_bwd_dq", "block_sparse_attention_bwd_dkv")}
    launches["block_sparse_attention"] += launches.pop("block_sparse_attention (no lse)")
    sm90["block_sparse_attention"] += sm90.pop("block_sparse_attention (no lse)")
    plain_calls = sum(fn.calls for fn in plain)
    peak = torch.cuda.max_memory_allocated()
    lat = np.diff(times[1:]) * 1e3  # steps 2 .. 32, warm
    log(f"{tag} {steps} steps at dim {cfg.model.dim}, depth {depth}, crop "
        f"{cfg.data.crop_len}, MSA {cfg.data.msa_depth}x{cfg.data.msa_len}, accumulation "
        f"{cfg.train.gradient_accumulate_every}: {wall:.2f} s incl. init; with per-step "
        f"norms and parameter checks, warm step latency median {np.median(lat):.2f} ms "
        f"(min {lat.min():.2f}, max {lat.max():.2f}), {1e3 / np.median(lat):.2f} steps/s; "
        f"peak device memory {peak / 2**30:.2f} GiB")
    log(f"{tag} losses: first {losses[0]:.4f}, last {losses[-1]:.4f}; all finite: "
        f"{bool(np.isfinite(losses).all())}; skipped {oks[-1][1]}")
    log(f"{tag} kernel launches: {launches}; plain-version calls: {plain_calls}")
    require(bool(np.isfinite(losses).all()), "non-finite training loss")
    require(all(ok for ok, _ in oks) and oks[-1][1] == 0, "a training step was skipped")
    # every attention's forward runs K1, or K4 for the pair axial passes of a
    # sparse model, or K2 for the tied MSA row pass; every attention whose
    # output reaches the loss runs the backward (the last layer's MSA<-pair
    # update does not)
    sparse_calls = 2 * depth if sparse else 0
    tied_calls = depth if tied else 0
    require(launches["fused_attention"] == (6 * depth - sparse_calls - tied_calls) * steps,
            "K1 launches per step")
    require(sm90["fused_attention"] == launches["fused_attention"],
            "a K1 launch of the training path did not run its Hopper kernel")
    # the MSA column pass (64 x 8 problems of 5 x 5), one a layer, on the
    # packed kernel, and no other pass
    require(kernels["fused_attention"].packed_launches == depth * steps,
            f"K1's packed launches {kernels['fused_attention'].packed_launches}, not one MSA "
            f"column pass a layer ({depth * steps})")
    # the MSA<-pair pass, one a layer, is the one that splits its key axis
    require(launches["fused_attention_combine"] == depth * steps,
            "K1 combine launches per step")
    for name in ("fused_attention_bwd_dq", "fused_attention_bwd_dkv"):
        require(launches[name] == (6 * depth - 1 - sparse_calls - tied_calls) * steps,
                f"{name} launches per step")
        require(sm90[name] == launches[name],
                f"a {name} launch of the training path did not run {name[20:]}_kernel_sm90")
    # K3b splits on each layer's pair<-MSA pass, K3a on every MSA<-pair pass
    # that runs a backward (not the last layer's)
    require(launches["fused_attention_bwd_merge"] == (2 * depth - 1) * steps,
            "K3 merge launches per step")
    for name in ("tied_row_attention", "tied_row_attention_bwd_dq",
                 "tied_row_attention_bwd_dkv"):
        require(launches[name] == tied_calls * steps, f"{name} launches per step")
    require(sm90["tied_row_attention"] == launches["tied_row_attention"],
            "a K2 launch of the tied training path did not run tied_row_attention_kernel_sm90")
    for name, kernel in (("tied_row_attention_bwd_dq", "tied_dq_kernel_sm90"),
                         ("tied_row_attention_bwd_dkv", "tied_dkv_kernel_sm90")):
        require(sm90[name] == launches[name],
                f"a {name} launch of the tied training path did not run {kernel}")
    for name in ("block_sparse_attention", "block_sparse_attention_bwd_dq",
                 "block_sparse_attention_bwd_dkv"):
        require(launches[name] == sparse_calls * steps, f"{name} launches per step")
    # every K4 and K5 launch of the (bf16, head dim 64) sparse path on its
    # Hopper kernel
    for name, kernel in (("block_sparse_attention", "sparse_fwd_kernel_sm90"),
                         ("block_sparse_attention_bwd_dq", "sparse_dq_kernel_sm90"),
                         ("block_sparse_attention_bwd_dkv", "sparse_dkv_kernel_sm90")):
        require(sm90[name] == launches[name],
                f"a {name} launch of the training path did not run {kernel}")
    require(plain_calls == 0, "a plain version ran on the training path")
    require(not any(changed[:steps - 1]),
            "parameters moved before the second accumulated update (schedule(0) must be 0)")
    require(changed[steps - 1], "parameters did not move at the second accumulated update")
    log(f"{tag} parameters unchanged through step {steps - 1}, changed after step {steps}")
    del state
    torch.cuda.empty_cache()

    # (b) no accumulation, warmup 1, one repeated batch: the loss must fall
    cfg_b = Config()
    cfg_b.model.depth = ENGINE_DEPTH
    cfg_b.model.sparse_self_attn = sparse
    cfg_b.model.msa_tie_row_attn = tied
    cfg_b.train.gradient_accumulate_every = 1
    cfg_b.train.warmup_steps = 1
    batch = next(iter(SyntheticDataset(cfg_b.data, seed=cfg_b.train.seed)))
    rep = []
    loop.train(cfg_b, num_steps=TRAIN_REPEAT_STEPS, dataset=itertools.repeat(batch),
               callbacks=[lambda i, s, m: rep.append(float(m["loss"]))])
    log(f"{tag} repeated batch, {TRAIN_REPEAT_STEPS} steps: losses "
        + " ".join(f"{x:.3f}" for x in rep))
    require(bool(np.isfinite(rep).all()) and np.mean(rep[-5:]) < np.mean(rep[:5]) and
            rep[-1] < rep[0], "the loss did not fall on a repeated batch")

    # (c) a small f32 model: the same step's gradients on the card (kernels)
    # and on the CPU (plain versions); a sparse model on the grid route
    # (crop 48, a block multiple) and the flat route (crop 40, padded to 48)
    for crop in (48, 40) if sparse else (48,):
        small = Config()
        small.model.dim, small.model.depth, small.model.heads, small.model.dim_head = (
            64, 2, 4, 16)
        small.model.bfloat16 = False
        small.model.sparse_self_attn = sparse
        small.model.msa_tie_row_attn = tied
        small.data.crop_len, small.data.msa_depth, small.data.msa_len = crop, 3, 32
        small.data.batch_size = 2
        _, worst, worst_name = _small_step_card_vs_cpu(small)
        log(f"{tag} small f32 model (crop {crop}), card vs CPU gradients: worst per-leaf "
            f"relative L2 {worst:.3e} ({worst_name}; tol {GRAD_REL_L2:g})")
        require(worst <= GRAD_REL_L2,
                "small-model gradients disagree between the card and the CPU")

    # (d) the step alone (numerics off, no callbacks, one batch on the
    # card): its rate, then one step under the profiler
    step = _step_fn(cfg, False)
    step_ms, _ = _time_step(step, STEP_REPS)
    log(f"{tag} the step alone, {STEP_REPS} steps: {step_ms:.2f} ms per step, "
        f"{1e3 / step_ms:.2f} steps/s")
    kind = "sparse " if sparse else "tied " if tied else ""
    profile_device(f"one {kind}training step", step, host=True)
    return {"launches": launches, "steps": steps, "wall_s": wall,
            "step_ms": step_ms, "peak_bytes": peak}


# --------------------------------------------------------------- phase 5b


E2E_STEPS = 4  # train_end2end steps at the CLI's full width
E2E_REPEAT_STEPS = 8  # steps on one repeated batch
E2E_TURN_REPS = 2  # steps a turn when the two steps alternate
E2E_RESUME = (2, 2)  # steps before the checkpoint, steps after the resume
E2E_PARITY_MDS_ITERS = 20  # the small f32 model's MDS iterations, card vs CPU
# a small f32 end-to-end model's gradients, card vs CPU: per-leaf relative
# L2 error (MDS amplifies small deltas, so 10x the distogram
# model's); only a leaf whose CPU gradient is itself at most 1e-6 of the
# total norm (0 by symmetry, as a bias added along the softmax axis, so
# roundoff only) is held absolutely, to 1e-6 of the total norm
E2E_GRAD_REL_L2 = 1e-3
E2E_ZERO_GRAD_ATOL = 1e-6


def _e2e_config(tied):
    """The end-to-end CLI's base config (alphafold2_tpu_torch/train_end2end.py):
    ModelConfig(dim=256, depth=1), DataConfig(crop_len=64), every other
    default (heads 8, dim_head 64, bf16, MSA 5x64, refiner depth 2, 200 MDS
    iterations)."""
    from alphafold2_tpu_torch.config import Config, DataConfig, ModelConfig

    cfg = Config(model=ModelConfig(dim=256, depth=1), data=DataConfig(crop_len=64))
    cfg.model.msa_tie_row_attn = tied
    return cfg


def _grad_norm(module):
    import torch

    grads = [p.grad.float() for p in module.parameters() if p.grad is not None]
    return float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))) if grads else 0.0


def _leaf_errors(plain, kernels):
    """Per-leaf gradient errors, card (``kernels``) against CPU (``plain``),
    both name -> CPU tensor: the worst relative L2 with its leaf, and the
    worst error over the total norm among the leaves that are 0 by
    symmetry (a bias added along a softmax axis: a CPU norm at most
    E2E_ZERO_GRAD_ATOL of the total, roundoff only). A leaf exactly 0 on
    the CPU must be exactly 0 on the card."""
    import torch

    total = float(torch.stack([g.norm() for g in plain.values()]).norm())
    worst, worst_name, sym = 0.0, "", 0.0
    for name, g_cpu in plain.items():
        g_gpu = kernels[name]
        norm, err = float(g_cpu.norm()), float((g_gpu - g_cpu).norm())
        if norm == 0.0:
            require(bool((g_gpu == 0).all()), f"{name}: zero on the CPU, nonzero on the card")
            continue
        if norm <= E2E_ZERO_GRAD_ATOL * total:
            sym = max(sym, err / total)
            continue
        if err / norm > worst:
            worst, worst_name = err / norm, name
    return worst, worst_name, sym


def _e2e_parity(tied, tag, features="msa"):
    """A small f32 end-to-end model (dim 64, depth 2, crop 16 with padded
    residues, 20 MDS iterations) on the ``features`` stream: one step on the
    card's kernels and one on the CPU's plain versions from the same
    weights, batch and MDS start; the loss and every gradient leaf
    compared."""
    import torch

    from alphafold2_tpu_torch.config import Config
    from alphafold2_tpu_torch.data.pipeline import SyntheticDataset
    from alphafold2_tpu_torch.train import end2end, loop

    small = Config()
    small.model.dim, small.model.depth, small.model.heads, small.model.dim_head = 64, 2, 4, 16
    small.model.bfloat16 = False
    small.model.msa_tie_row_attn = tied
    small.data.crop_len, small.data.msa_depth, small.data.msa_len = 16, 3, 16
    small.data.batch_size, small.data.min_len_filter = 2, 8
    small.data.features = features
    batch = next(loop.apply_features(iter(SyntheticDataset(small.data, seed=3)), small))
    n = 3 * small.data.crop_len
    loss, grads = {}, {}
    for side, dev in (("plain", "cpu"), ("kernels", "cuda")):
        model = end2end.build_end2end_model(small, mds_iters=E2E_PARITY_MDS_ITERS,
                                            num_embedds=loop.embedds_width(batch))
        st = loop.init_state(small, model, device=dev)
        st, met = end2end.make_end2end_step(st.model)(
            st, loop.batch_to_device(batch, torch.device(dev)),
            end2end.mds_start(small.train.seed + 1, 0, 2, n, dev))
        require(bool(met["grads_ok"]), f"small end-to-end step on {dev}: non-finite gradients")
        loss[side] = float(met["loss"])
        grads[side] = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
                       for k, p in st.model.named_parameters()}
    worst, worst_name, sym = _leaf_errors(grads["plain"], grads["kernels"])
    loss_rel = abs(loss["kernels"] - loss["plain"]) / abs(loss["plain"])
    log(f"{tag} small f32 model ({features}, crop 16, padded, {E2E_PARITY_MDS_ITERS} MDS "
        f"iterations), card "
        f"vs CPU: loss {loss['kernels']:.6f} vs {loss['plain']:.6f} (relative {loss_rel:.2e}; tol "
        f"1e-4), worst per-leaf gradient relative L2 {worst:.3e} ({worst_name}; tol "
        f"{E2E_GRAD_REL_L2:g}), leaves 0 by symmetry within {sym:.2e} of the total norm "
        f"(tol {E2E_ZERO_GRAD_ATOL:g})")
    require(loss_rel <= 1e-4, "small end-to-end loss disagrees between the card and the CPU")
    require(worst <= E2E_GRAD_REL_L2,
            "small end-to-end gradients disagree between the card and the CPU")
    require(sym <= E2E_ZERO_GRAD_ATOL,
            "a small end-to-end gradient that is 0 by symmetry is not 0 on the card")


def _e2e_passes(cfg):
    """The attention passes of an end-to-end trunk layer at ``cfg``'s shapes,
    with the masks of the first batch train_end2end takes: label -> (b, nq,
    nk, q_mask, kv_mask), and the MSA mask (1, R, L). Residues elongate x3
    into atom tokens, so the pair is 3L x 3L and the MSA R x L."""
    import torch

    from alphafold2_tpu_torch.data.pipeline import make_dataset
    from alphafold2_tpu_torch.train.loop import apply_features

    batch = next(apply_features(iter(make_dataset(cfg.data, seed=cfg.train.seed)), cfg))
    tok = torch.from_numpy(batch["mask"]).bool().cuda().repeat_interleave(3, dim=1)[0]
    msa3 = torch.from_numpy(batch["msa_mask"]).bool().cuda()
    pair, msa = tok[:, None] & tok[None, :], msa3[0]
    (n, _), (r, l), h = pair.shape, msa.shape, cfg.model.heads
    col = msa.T.contiguous()
    return {
        f"e2e pair axial ({n}x{h}, {n}x{n})": (n, n, n, pair, pair),
        f"e2e MSA column ({l}x{h}, {r}x{r})": (l, r, r, col, col),
        f"e2e MSA row ({r}x{h}, {l}x{l})": (r, l, l, msa, msa),
        f"e2e pair<-MSA (1x{h}, {n * n}x{r * l})": (1, n * n, r * l, pair.reshape(1, -1),
                                                    msa.reshape(1, -1)),
        f"e2e MSA<-pair (1x{h}, {r * l}x{n * n})": (1, r * l, n * n, msa.reshape(1, -1),
                                                    pair.reshape(1, -1)),
    }, msa3


def _e2e_kernel_cases(cfg, tied, tag):
    """The kernels of the end-to-end step at its own shapes, masks and
    route (bf16 at head dim 64: the Hopper kernels), each held against its
    plain version on the same inputs. Untied: K1 with lse, K3a and K3b on
    every pass (k3_case: the Hopper launches, the combine and merge passes
    where the pass splits, negative controls), and the combine pass alone
    where K1 splits. Tied: K2 and its backward on the MSA row pass with
    the batch's MSA mask (the other passes are the untied ones)."""
    import torch

    from alphafold2_tpu_torch.ops.cuda import axial

    h, d = cfg.model.heads, cfg.model.dim_head
    dtype = torch.bfloat16 if cfg.model.bfloat16 else torch.float32
    gen = torch.Generator(device="cuda").manual_seed(12)
    passes, msa3 = _e2e_passes(cfg)
    worst = {}
    for label, (b, nq, nk, qm, km) in passes.items():
        if tied and "MSA row" not in label:
            continue
        if tied:
            _, r, l = msa3.shape
            rows = tied_case(label, 1, r, l, h, d, dtype, gen, reps=0, rows=msa3)
        else:
            rows = k3_case(label, b, h, nq, nk, d, dtype, qm, km, reps=0, gen=gen,
                           strided=True)
            if axial.key_splits(b, h, nq, nk, d) > 1:
                rows.append(combine_case(label, b, h, nq, nk, d, qm, km, gen))
        for row in rows:
            worst[row["kernel"]] = max(worst.get(row["kernel"], 0.0), row["max_abs_err"])
    log(f"{tag} kernels at the step's shapes and masks ({dtype}, head dim {d}), worst "
        "max_abs_err against the plain versions: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))


def profile_end2end(what, model, fn):
    """One end-to-end step ``fn()`` under torch.profiler, split into its
    parts by zero-length marks that module and gradient hooks drop: the
    trunk (forward; backward until the token embedding's gradient is
    accumulated), the structure (softmax, centering, MDS, sidechain lift;
    forward, and backward until the logits' gradient), the refiner
    (forward; backward until its input's gradient), the loss (forward and
    backward until the refined coordinates' gradient) and the rest
    (gradient checks and the optimizer). For each part: host ms between the
    marks, host ops' own time, kernel launches, and the device time of the
    kernels that start between the marks (the step is host-bound, so a
    kernel runs close to its launch)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    labels = []

    def mark(label):
        with record_function(f"e2e_mark:{len(labels)}"):
            labels.append(label)

    def then(tensor, label):  # mark when the gradient with respect to tensor is ready
        tensor.register_hook(lambda grad: mark(label))

    def trunk_done(module, args, logits):
        mark("trunk")
        then(logits, "structure")

    def structure_done(module, args):
        mark("structure")
        then(args[1], "refiner")

    def refiner_done(module, args, refined):
        mark("refiner")
        then(refined, "loss")

    # hooks that return None leave the module's inputs and outputs as they are
    hooks = [model.af2.register_forward_hook(trunk_done),
             model.refiner.register_forward_pre_hook(structure_done),
             model.refiner.register_forward_hook(refiner_done),
             model.af2.token_emb.weight.register_post_accumulate_grad_hook(
                 lambda p: mark("trunk"))]
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            mark("start")
            fn()
            torch.cuda.synchronize()
            mark("rest")
    finally:
        for h in hooks:
            h.remove()
    events = list(prof.events())
    at = {}
    for e in events:
        if e.name.startswith("e2e_mark:"):
            at[int(e.name.split(":")[1])] = e.time_range.start
    if len(at) != len(labels):
        log(f"[profile] {what}: the profiler recorded {len(at)} of {len(labels)} marks: "
            "the split is not measured")
        return
    bounds = [at[i] for i in range(len(labels))]
    parts = {}

    def part_of(t):
        for i in range(1, len(bounds)):
            if bounds[i - 1] <= t < bounds[i]:
                return labels[i]
        return None

    launch_names = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")
    for i in range(1, len(bounds)):
        p = parts.setdefault(labels[i], {"host": 0.0, "own": 0.0, "launches": 0, "device": 0.0})
        p["host"] += (bounds[i] - bounds[i - 1]) / 1e3
    for e in events:
        part = parts.get(part_of(e.time_range.start))
        if part is None:
            continue
        if e.device_type == DeviceType.CUDA:
            part["device"] += (e.time_range.end - e.time_range.start) / 1e3
        else:
            part["own"] += e.self_cpu_time_total / 1e3
            part["launches"] += e.name in launch_names
    total_host = sum(p["host"] for p in parts.values())
    total_dev = sum(p["device"] for p in parts.values())
    log(f"[profile] {what}, split (profiler on): host {total_host:.1f} ms, device busy "
        f"{total_dev:.1f} ms ({total_dev / total_host:.1%}), "
        f"{sum(p['launches'] for p in parts.values())} kernel launches")
    for label in ("trunk", "structure", "refiner", "loss", "rest"):
        p = parts.get(label)
        if p is not None:
            log(f"[profile] {what}, {label:9s}: host {p['host']:8.2f} ms, host ops' own "
                f"{p['own']:8.2f} ms, {p['launches']:6d} launches, device busy "
                f"{p['device']:8.2f} ms")


def _e2e_run(tied):
    """phase_end2end for untied or tied MSA rows."""
    import itertools
    import shutil
    import tempfile

    import numpy as np
    import torch

    from alphafold2_tpu_torch import constants
    from alphafold2_tpu_torch.data.pipeline import SyntheticDataset
    from alphafold2_tpu_torch.predict import predict
    from alphafold2_tpu_torch.train import end2end, loop

    tag = "[end2end tied]" if tied else "[end2end]"
    plain, kernels = _plain_versions(), _training_kernels()

    # (1) a small f32 model: card against the CPU's plain versions; then the
    # kernels at full width, each against its plain version
    _e2e_parity(tied, tag)
    cfg = _e2e_config(tied)
    _e2e_kernel_cases(cfg, tied, tag)

    # (2) steps at full width through the entry point
    depth = cfg.model.depth
    times, losses, oks, norms, rmsds = [], [], [], [], []

    def watch(i, state, metrics):
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        losses.append(float(metrics["loss"]))
        rmsds.append(float(metrics["rmsd"]))
        oks.append(bool(metrics["grads_ok"]))
        norms.append((_grad_norm(state.model.af2), _grad_norm(state.model.refiner)))

    _reset_counts(kernels, plain)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = end2end.train_end2end(cfg, num_steps=E2E_STEPS, callbacks=[watch])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    sm90 = {name: fn.sm90_launches for name, fn in kernels.items() if hasattr(fn, "sm90_launches")}
    plain_calls = sum(fn.calls for fn in plain)
    peak = torch.cuda.max_memory_allocated()
    lat = np.diff(times) * 1e3  # steps 2 .. E2E_STEPS, warm
    log(f"{tag} {E2E_STEPS} train_end2end steps at dim {cfg.model.dim}, depth {depth}, crop "
        f"{cfg.data.crop_len} ({3 * cfg.data.crop_len} atom tokens, "
        f"{constants.NUM_COORDS_PER_RES * cfg.data.crop_len} refiner atoms), MSA "
        f"{cfg.data.msa_depth}x{cfg.data.msa_len}, 200 MDS iterations, accumulation "
        f"{cfg.train.gradient_accumulate_every}: {wall:.2f} s incl. init; with per-step "
        f"checks, warm step latency median {np.median(lat):.2f} ms (min {lat.min():.2f}, max "
        f"{lat.max():.2f}), {1e3 / np.median(lat):.3f} steps/s; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"{tag} losses " + " ".join(f"{x:.4f}" for x in losses) + "; rmsd "
        + " ".join(f"{x:.3f}" for x in rmsds) + f"; skipped {int(state.skipped)}")
    log(f"{tag} gradient norms (trunk, refiner) " + " ".join(f"({a:.3e}, {b:.3e})" for a, b in norms))
    log(f"{tag} kernel launches: {launches}; plain-version calls: {plain_calls}")
    require(bool(np.isfinite(losses).all()), "non-finite end-to-end loss")
    require(all(oks) and int(state.skipped) == 0, "an end-to-end step was skipped")
    require(all(a > 0 and b > 0 for a, b in norms), "no gradient in the trunk or the refiner")
    tied_calls = depth if tied else 0
    require(launches["fused_attention"] == (6 * depth - tied_calls) * E2E_STEPS,
            "K1 launches per end-to-end step")
    for name in ("fused_attention_bwd_dq", "fused_attention_bwd_dkv"):
        # the last layer's MSA<-pair update reaches no output and runs no backward
        require(launches[name] == (6 * depth - 1 - tied_calls) * E2E_STEPS,
                f"{name} launches per end-to-end step")
    for name in ("tied_row_attention", "tied_row_attention_bwd_dq", "tied_row_attention_bwd_dkv"):
        require(launches[name] == tied_calls * E2E_STEPS, f"{name} launches per end-to-end step")
    for name, count in sm90.items():
        require(count == launches[name], f"a {name} launch of the end-to-end path missed its "
                "Hopper kernel")
    require(launches["block_sparse_attention"] + launches["block_sparse_attention (no lse)"] == 0,
            "a block-sparse kernel ran on the end-to-end path")
    require(plain_calls == 0, "a plain version ran on the end-to-end path")
    del state
    torch.cuda.empty_cache()

    # (3) no accumulation, warmup 1, one repeated batch: the loss must fall
    cfg_b = _e2e_config(tied)
    cfg_b.train.gradient_accumulate_every = 1
    cfg_b.train.warmup_steps = 1
    batch = next(iter(SyntheticDataset(cfg_b.data, seed=cfg_b.train.seed)))
    fb = loop.batch_to_device(next(loop.apply_features(iter([batch]), cfg_b)),
                              torch.device("cuda"))
    start0 = end2end.mds_start(cfg_b.train.seed + 1, 0, 1, 3 * cfg_b.data.crop_len, "cuda")
    rep, fixed, lrs, gnorms, rmsd_rep = [], [], [], [], []

    def watch_rep(i, s, m):
        # the step's loss (its own MDS start, the parameters before its
        # update), the learning rate it applied, its raw gradient norm, and
        # the loss at step 0's MDS start with the updated parameters
        rep.append(float(m["loss"]))
        rmsd_rep.append(float(m["rmsd"]))
        lrs.append(s.optimizer.schedule(s.optimizer.count - 1))
        gnorms.append(float(m["grad_norm"]))
        with torch.no_grad():
            out = s.model(fb["seq"], fb["msa"], mask=fb["mask"], msa_mask=fb["msa_mask"],
                          coords0=start0)
            fixed.append(float(end2end.structure_loss(out, fb["backbone"], fb["mask"])[0]))

    end2end.train_end2end(cfg_b, num_steps=E2E_REPEAT_STEPS, dataset=itertools.repeat(batch),
                          callbacks=[watch_rep])

    def fell(xs):
        return bool(np.isfinite(xs).all()) and np.mean(xs[-5:]) < np.mean(xs[:5]) and xs[-1] < xs[0]

    falls, fixed_falls = fell(rep), fell(fixed)
    log(f"{tag} repeated batch ({int(batch['mask'].sum())} residues), {E2E_REPEAT_STEPS} steps: "
        "losses " + " ".join(f"{x:.3f}" for x in rep) + f"; falls: {falls}")
    log(f"{tag} repeated batch: rmsd " + " ".join(f"{x:.3f}" for x in rmsd_rep)
        + "; learning rate " + " ".join(f"{x:.3g}" for x in lrs) + "; gradient norm "
        + " ".join(f"{x:.3f}" for x in gnorms))
    log(f"{tag} repeated batch, loss at step 0's MDS start after each update: "
        + " ".join(f"{x:.3f}" for x in fixed) + f"; falls: {fixed_falls}")
    require(falls, "the end-to-end loss did not fall on a repeated batch")
    require(fixed_falls, "the end-to-end loss at a fixed MDS start did not fall on a repeated "
                         "batch")

    # (4) checkpoint and resume against an uninterrupted run (cfg_b: the
    # parameters move every step), then (5) predict from the checkpoint
    k, more = E2E_RESUME
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="e2e_ckpt_", dir=os.path.join(HERE, "build"))
    try:
        whole_losses, first_losses, resumed_losses = [], [], []
        whole = end2end.train_end2end(cfg_b, num_steps=k + more, callbacks=[
            lambda i, s, m: whole_losses.append(float(m["loss"]))])
        whole_params = _params(whole.model)
        del whole
        cfg_c = _e2e_config(tied)
        cfg_c.train.gradient_accumulate_every = 1
        cfg_c.train.warmup_steps = 1
        cfg_c.train.checkpoint_dir = ckpt_dir
        end2end.train_end2end(cfg_c, num_steps=k, callbacks=[
            lambda i, s, m: first_losses.append(float(m["loss"]))])
        resumed = end2end.train_end2end(cfg_c, num_steps=k + more, callbacks=[
            lambda i, s, m: resumed_losses.append(float(m["loss"]))])
        loss_diff = max(abs(a - b) for a, b in zip(first_losses + resumed_losses, whole_losses))
        param_diff = max(float((a - b).abs().max())
                         for a, b in zip(_params(resumed.model), whole_params))
        log(f"{tag} checkpoint at step {k}, fresh model resumed to step {k + more}: losses "
            + " ".join(f"{x:.6f}" for x in first_losses + resumed_losses) + " vs uninterrupted "
            + " ".join(f"{x:.6f}" for x in whole_losses) + f"; max |loss diff| {loss_diff:.3e}, "
            f"max |parameter diff| {param_diff:.3e} (bound: 0, every op of the step "
            "deterministic)")
        require(len(resumed_losses) == more and resumed.step == k + more,
                "the resumed run did not start at the checkpoint")
        require(loss_diff == 0.0 and param_diff == 0.0,
                "the resumed run differs from the uninterrupted one")
        rng = np.random.default_rng(7)
        seq = "".join(constants.AA_ALPHABET[i] for i in rng.integers(0, 20, 60))
        from_ckpt = predict(cfg_c, seq, checkpoint_dir=ckpt_dir)
        from_sd = predict(cfg_c, seq, state_dict=resumed.model.state_dict())
        diff = float(np.abs(from_ckpt.atom14 - from_sd.atom14).max())
        log(f"{tag} predict from the step-{k + more} checkpoint, {len(seq)} residues: atom14 "
            f"{from_ckpt.atom14.shape}, finite {bool(np.isfinite(from_ckpt.atom14).all())}, "
            f"max |diff| against predict(state_dict=) {diff:.3e} (bound 0)")
        require(bool(np.isfinite(from_ckpt.atom14).all()), "predict from a checkpoint: non-finite")
        require(diff == 0.0, "predict from a checkpoint differs from predict(state_dict=)")
        del resumed
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # (6) the step alone (no callbacks, one batch on the card): its rate,
    # then one step under the profiler, whole and split into its parts
    step = _step_fn(cfg, True)
    step_ms, step_peak = _time_step(step, STEP_REPS)
    log(f"{tag} the step alone, {STEP_REPS} steps: {step_ms:.2f} ms per step, "
        f"{1e3 / step_ms:.3f} steps/s; peak device memory {step_peak / 2**30:.2f} GiB")
    kind = "tied " if tied else ""
    profile_device(f"one {kind}end-to-end step", step, host=True)
    profile_end2end(f"one {kind}end-to-end step", step.model, step)
    return {"launches": launches, "steps": E2E_STEPS, "wall_s": wall, "step_ms": step_ms,
            "peak_bytes": peak, "step": step}


def phase_end2end():
    """End-to-end structure training at the CLI's full width, untied and
    then tied MSA rows (log tags ``[end2end]``, ``[end2end tied]``); then
    the two steps alone in turns (untied, tied, tied, untied), since the
    host's speed drifts within a call."""
    import torch

    t0 = time.perf_counter()
    out = {"untied": _e2e_run(False), "tied": _e2e_run(True)}
    turns = {"untied": [], "tied": []}
    for kind in ("untied", "tied", "tied", "untied"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(E2E_TURN_REPS):
            out[kind]["step"]()
        torch.cuda.synchronize()
        turns[kind].append((time.perf_counter() - t1) / E2E_TURN_REPS * 1e3)
    log("[end2end] the steps alone in turns, ms per step over " + str(E2E_TURN_REPS)
        + " steps: " + "; ".join(f"{k} " + ", ".join(f"{x:.2f}" for x in v)
                                 for k, v in turns.items()))
    log(f"[end2end] phase: {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------------- phase 9


ENGINE_STEPS = 3  # steps through the training entry point per engine
ENGINE_REPS = 3  # steps timed back to back per engine
# the engines' trunk depth: the training smoke's 6 halved, which keeps the
# whole pass inside its time limit
ENGINE_DEPTH = 3
MEMORY_DEPTHS = (ENGINE_DEPTH, 2 * ENGINE_DEPTH)  # the peak-memory sweep's depths
# the engines at the training smoke's width (Config(): dim 256, heads 8,
# dim_head 64, bf16, crop 128, MSA 5x64, batch 1) at ENGINE_DEPTH: label ->
# ModelConfig fields; "e2e ..." at the end-to-end CLI's width instead
ENGINES = {
    "default": {},
    "remat": {"remat": True},
    "remat dots": {"remat": True, "remat_policy": "dots"},
    "remat dots_no_batch": {"remat": True, "remat_policy": "dots_no_batch"},
    "scan": {"scan_layers": True},
    "scan+remat": {"scan_layers": True, "remat": True},
    "reversible": {"reversible": True},
    "tied reversible": {"reversible": True, "msa_tie_row_attn": True},
    "sparse reversible": {"reversible": True, "sparse_self_attn": True},
    "e2e remat": {"remat": True},
    "e2e reversible": {"reversible": True},
}
# card against card at full width, bf16: the engines' gradients against the
# default engine's (the same network, another schedule), per-leaf relative L2
ENGINE_GRAD_REL_L2 = 2e-2


def _engine_config(label, depth=None):
    """The configuration an ENGINES label names, at ``depth`` (by default
    ENGINE_DEPTH, the end-to-end CLI's own depth for "e2e ...")."""
    from alphafold2_tpu_torch.config import Config

    e2e = label.startswith("e2e")
    cfg = _e2e_config(False) if e2e else Config()
    for field, value in ENGINES[label].items():
        setattr(cfg.model, field, value)
    if depth is not None or not e2e:
        cfg.model.depth = depth if depth is not None else ENGINE_DEPTH
    return cfg


def _step_fn(cfg, e2e, key=None, numerics_mode="off"):
    """A fresh state at ``cfg`` on the card and its step on one synthetic
    batch (numerics ``numerics_mode``, no callbacks), as a closure whose
    ``model`` attribute is the state's model. ``e2e``: the end-to-end step,
    from step 0's MDS start; otherwise the distogram step under the dropout
    ``key`` where one is given. The batch is the first of ``cfg``'s feature
    stream (``data.features``), which also gives ``embedd_project`` its
    width under ``plm``."""
    import torch

    from alphafold2_tpu_torch.data.pipeline import SyntheticDataset
    from alphafold2_tpu_torch.train import end2end, loop

    batch = next(loop.apply_features(iter(SyntheticDataset(cfg.data, seed=cfg.train.seed)),
                                     cfg))
    width = loop.embedds_width(batch)
    model = (end2end.build_end2end_model(cfg, num_embedds=width) if e2e
             else loop.build_model(cfg, num_embedds=width))
    st = loop.init_state(cfg, model)
    batch = loop.batch_to_device(batch, torch.device("cuda"))
    if e2e:
        step = end2end.make_end2end_step(st.model)
        extra = (end2end.mds_start(cfg.train.seed + 1, 0, 1, 3 * cfg.data.crop_len, "cuda"),)
    else:
        step = loop.make_train_step(st.model, numerics_mode=numerics_mode)
        extra = (key,)

    def fn():
        return step(st, batch, *extra)

    fn.model = st.model
    return fn


def _time_step(fn, reps):
    """ms per step over ``reps`` warm steps, and the peak device memory
    allocated while they ran (parameters and optimizer state included)."""
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()  # the peak starts at what is allocated now
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, torch.cuda.max_memory_allocated()


def _free():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _expected_launches(label, depth):
    """Kernel launches a step that an engine's schedule gives, by
    _training_kernels name."""
    f = ENGINES[label]
    tied, sparse = f.get("msa_tie_row_attn", False), f.get("sparse_self_attn", False)
    dense = 6 - tied - 2 * sparse  # K1 passes a layer
    if f.get("reversible"):
        # each pass runs once without the row logsumexp (the forward, under
        # no gradient) and once with it (the re-evaluation in the backward),
        # then its backward: every pass, the last layer's MSA updates too
        out = {"fused_attention": 2 * dense * depth, "fused_attention_bwd_dq": dense * depth,
               "fused_attention_bwd_dkv": dense * depth}
        if tied:
            out.update({"tied_row_attention": 2 * depth, "tied_row_attention_bwd_dq": depth,
                        "tied_row_attention_bwd_dkv": depth})
        if sparse:
            out.update({"block_sparse_attention (no lse)": 2 * depth,
                        "block_sparse_attention": 2 * depth,
                        "block_sparse_attention_bwd_dq": 2 * depth,
                        "block_sparse_attention_bwd_dkv": 2 * depth})
        return out
    # remat recomputes each layer's forward in the backward; the last
    # layer's MSA<-pair update reaches no output and runs no backward
    runs = 2 if f.get("remat") else 1
    return {"fused_attention": runs * 6 * depth, "fused_attention_bwd_dq": 6 * depth - 1,
            "fused_attention_bwd_dkv": 6 * depth - 1}


def _entry_point_run(tag, label, cfg, e2e, steps, reps, key=None):
    """``steps`` steps of ``cfg`` through its training entry point
    (train.loop.train, or train_end2end with ``e2e``) from launch counts
    of 0: finite losses, no skipped step, every launch on its Hopper
    kernel (K2's on the resident kernels or the wide route), no plain
    version. Then
    the step alone over ``reps`` warm steps (under the dropout ``key``
    where one is given) with its peak memory. Returns the launches a step
    by _training_kernels name, the step's ms, its peak bytes and the
    losses."""
    import numpy as np
    import torch

    from alphafold2_tpu_torch.train import end2end, loop

    plain, kernels = _plain_versions(), _training_kernels()
    losses, oks = [], []
    _reset_counts(kernels, plain)
    train = end2end.train_end2end if e2e else loop.train
    state = train(cfg, num_steps=steps, callbacks=[
        lambda i, s, m: (losses.append(float(m["loss"])), oks.append(bool(m["grads_ok"])))])
    skipped = int(state.skipped)
    del state
    per_step = {name: fn.launches / steps for name, fn in kernels.items() if fn.launches}
    missed = {name: fn.launches - fn.sm90_launches for name, fn in kernels.items()
              if hasattr(fn, "sm90_launches") and fn.sm90_launches != fn.launches}
    wide = {name: fn.wide_launches / steps for name, fn in kernels.items()
            if getattr(fn, "wide_launches", 0)}
    plain_calls = sum(fn.calls for fn in plain)
    _free()
    resident = torch.cuda.memory_allocated()  # held before the model is built
    fn = _step_fn(cfg, e2e, key=key)
    step_ms, peak = _time_step(fn, reps)
    del fn
    _free()
    log(f"{tag} {label} (depth {cfg.model.depth}, crop {cfg.data.crop_len}): losses "
        + " ".join(f"{x:.4f}" for x in losses) + f", skipped {skipped}; the step alone "
        f"{step_ms:.2f} ms ({1e3 / step_ms:.3f} steps/s) over {reps} steps, peak device "
        f"memory {peak / 2**20:.1f} MiB ({resident / 2**20:.1f} MiB held before the model); "
        f"kernel launches a step {per_step}; of them on K2's wide route {wide}; launches "
        f"off their Hopper kernel {missed}; plain-version calls {plain_calls}")
    require(bool(np.isfinite(losses).all()) and all(oks) and skipped == 0,
            f"{label}: a non-finite loss or a skipped step")
    require(not missed, f"{label}: a launch missed its Hopper kernel")
    require(plain_calls == 0, f"{label}: a plain version ran")
    return {"label": label, "step_ms": step_ms, "peak_bytes": peak, "launches": per_step,
            "losses": losses}


def _engine_run(label):
    """ENGINE_STEPS steps of one engine through its training entry point,
    then the step alone (_entry_point_run); launches a step off the
    engine's schedule are logged."""
    cfg = _engine_config(label)
    run = _entry_point_run("[engines]", label, cfg, label.startswith("e2e"), ENGINE_STEPS,
                           ENGINE_REPS)
    expected = _expected_launches(label, cfg.model.depth)
    run["off_expected"] = off = {name: (run["launches"].get(name, 0), n)
                                 for name, n in expected.items()
                                 if run["launches"].get(name, 0) != n}
    if off:
        log(f"[engines] {label}: launches a step (measured, expected) {off}")
    return run


def _loss_and_grads(model, batch, key=None):
    """The distogram loss of one batch and every parameter's gradient (f32;
    zeros for a leaf that does not reach the loss), under the dropout
    ``key`` where one is given."""
    import torch

    from alphafold2_tpu_torch.train import loop
    from alphafold2_tpu_torch.utils.structure import get_bucketed_distance_matrix

    model.zero_grad(set_to_none=True)
    logits = model(batch["seq"], batch.get("msa"), mask=batch["mask"],
                   msa_mask=batch.get("msa_mask"), dropout_key=key)
    loss = loop.distogram_cross_entropy(
        logits, get_bucketed_distance_matrix(batch["coords"], batch["mask"]))
    loss.backward()
    return float(loss.detach()), {n: (p.grad if p.grad is not None else torch.zeros_like(p)).float()
                         for n, p in model.named_parameters()}


def _engines_against_default():
    """Remat under each policy and the scanned trunk (with and without
    remat) against the default engine at full width on the card: the same
    weights (the scan's stacked from the loop's layers) and batch; the loss
    and every gradient leaf, bit-equal or the worst relative L2."""
    import torch

    from alphafold2_tpu_torch.data.pipeline import SyntheticDataset
    from alphafold2_tpu_torch.predict import init_params
    from alphafold2_tpu_torch.train import loop

    cfg = _engine_config("default")
    batch = loop.batch_to_device(next(iter(SyntheticDataset(cfg.data, seed=cfg.train.seed))),
                                 torch.device("cuda"))
    base = init_params(loop.build_model(cfg), cfg.train.seed).cuda()
    sd = base.state_dict()
    ref_loss, ref = _loss_and_grads(base, batch)
    del base
    depth = cfg.model.depth
    for label in ("remat", "remat dots", "remat dots_no_batch", "scan", "scan+remat"):
        c = _engine_config(label)
        model = loop.build_model(c)
        if c.model.scan_layers:
            prefix = "trunk.scan.layer."
            model.load_state_dict({
                k: (torch.stack([sd[f"trunk.layer_{i}.{k[len(prefix):]}"] for i in range(depth)])
                    if k.startswith(prefix) else sd[k]) for k in model.state_dict()})
        else:
            model.load_state_dict(sd)
        loss, grads = _loss_and_grads(model.cuda(), batch)
        if c.model.scan_layers:  # each layer's slice of the stacked gradients
            grads = {**{k: g for k, g in grads.items() if not k.startswith(prefix)},
                     **{f"trunk.layer_{i}.{k[len(prefix):]}": g[i] for k, g in grads.items()
                        if k.startswith(prefix) for i in range(depth)}}
        require(set(grads) == set(ref), f"{label}: another parameter set than the default's")
        equal = loss == ref_loss and all(torch.equal(grads[k], ref[k]) for k in ref)
        worst, worst_name = 0.0, ""
        for k, g in ref.items():
            norm = float(g.norm())
            rel = float((grads[k] - g).norm()) / norm if norm else float((grads[k] != 0).any())
            if rel > worst:
                worst, worst_name = rel, k
        log(f"[engines] {label} against the default engine at full width (bf16): loss "
            f"{loss:.6f} vs {ref_loss:.6f}; loss and gradients bit-equal: {equal}; worst "
            f"per-leaf relative L2 {worst:.3e} ({worst_name or '-'}; tol {ENGINE_GRAD_REL_L2:g})")
        require(abs(loss - ref_loss) <= 1e-3 * abs(ref_loss) and worst <= ENGINE_GRAD_REL_L2,
                f"{label} disagrees with the default engine")
        del model, grads
        _free()


def _small_step_card_vs_cpu(small):
    """One training step of the small f32 model ``small`` describes, from
    the same weights and batch (seed 3) on the CPU's plain versions and on
    the card's kernels: both losses, and the worst per-leaf gradient
    relative L2 with its leaf (a leaf 0 on the CPU must be 0 on the card)."""
    import torch

    from alphafold2_tpu_torch.data.pipeline import SyntheticDataset
    from alphafold2_tpu_torch.train import loop

    batch = next(loop.apply_features(iter(SyntheticDataset(small.data, seed=3)), small))
    loss, grads = {}, {}
    for side, dev in (("plain", "cpu"), ("kernels", "cuda")):
        st = loop.init_state(small, loop.build_model(small, loop.embedds_width(batch)),
                             device=dev)
        st, met = loop.make_train_step(st.model)(
            st, loop.batch_to_device(batch, torch.device(dev)))
        loss[side] = float(met["loss"])
        grads[side] = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
                       for n, p in st.model.named_parameters()}
    worst, worst_name = 0.0, ""
    for name, g_cpu in grads["plain"].items():
        g_gpu = grads["kernels"][name]
        norm = float(g_cpu.norm())
        if norm == 0.0:
            require(bool((g_gpu == 0).all()), f"{name}: zero on the CPU, nonzero on the card")
            continue
        rel = float((g_gpu - g_cpu).norm()) / norm
        if rel > worst:
            worst, worst_name = rel, name
    return loss, worst, worst_name


def _reversible_parity():
    """A small f32 reversible model: one step's loss and gradients on the
    card's kernels against the CPU's plain versions, as phase_train (c)
    holds the default engine: the loss within 1e-5 relative, every leaf
    within 1e-3 relative L2 (the inversion recomputes every activation from
    the final state, so each side's roundoff enters its backward twice)."""
    from alphafold2_tpu_torch.config import Config

    small = Config()
    small.model.dim, small.model.depth, small.model.heads, small.model.dim_head = 64, 2, 4, 16
    small.model.bfloat16 = False
    small.model.reversible = True
    small.data.crop_len, small.data.msa_depth, small.data.msa_len = 48, 3, 32
    small.data.batch_size = 2
    loss, worst, worst_name = _small_step_card_vs_cpu(small)
    loss_rel = abs(loss["kernels"] - loss["plain"]) / abs(loss["plain"])
    log(f"[engines] small f32 reversible model (dim 64, depth 2, crop 48), card vs CPU: loss "
        f"{loss['kernels']:.6f} vs {loss['plain']:.6f} (relative {loss_rel:.2e}; tol 1e-5), worst "
        f"per-leaf gradient relative L2 {worst:.3e} ({worst_name}; tol 1e-3)")
    require(loss_rel <= 1e-5, "small reversible loss disagrees between the card and the CPU")
    require(worst <= 1e-3, "small reversible gradients disagree between the card and the CPU")


# bounds on the reversible inversion's relative L2 error, one layer and the
# engine's depth: f32 compute inverts at f32 roundoff; bf16 compute does not
# (on the f32 carry each re-evaluated sub-function sees inputs that differ
# from the forward's by f32 roundoff, and a bf16 rounding of its LayerNorm
# output that flips there moves its output by a bf16 ulp, so each layer
# reconstructs to about 2e-3 and the error grows through the layers above
# it); the bf16 bounds only catch a coupling that does not invert at all
INVERT_REL_L2 = {"f32": (1e-5, 1e-4), "bf16": (1e-2, 1e-1)}


def _reversible_inversion():
    """RevLayerPair.invert(forward(h)) at full width with the training
    batch's masks, one layer and the engine's depth (forward through every
    layer, then inverted back): f32 compute, bf16 compute on the f32 carry
    the engine keeps, and bf16 compute on a bf16 carry for comparison. The
    max and the relative L2 error, held to INVERT_REL_L2."""
    import torch

    from alphafold2_tpu_torch.data.pipeline import SyntheticDataset
    from alphafold2_tpu_torch.models.reversible import RevLayerPair
    from alphafold2_tpu_torch.predict import init_params

    cfg = _engine_config("default")
    m = cfg.model
    batch = next(iter(SyntheticDataset(cfg.data, seed=cfg.train.seed)))
    mask = torch.from_numpy(batch["mask"]).bool().cuda()
    pm, mm = mask[:, :, None] & mask[:, None, :], torch.from_numpy(batch["msa_mask"]).bool().cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    n, (r, l) = cfg.data.crop_len, mm.shape[1:]
    x = torch.randn((1, n, n, m.dim), generator=gen, device="cuda")
    msa = torch.randn((1, r, l, m.dim), generator=gen, device="cuda")
    out = {}
    for compute, carry, depth in ((torch.float32, torch.float32, 1),
                                  (torch.float32, torch.float32, m.depth),
                                  (torch.bfloat16, torch.float32, 1),
                                  (torch.bfloat16, torch.float32, m.depth),
                                  (torch.bfloat16, torch.bfloat16, 1)):
        what = (f"{'bf16' if compute == torch.bfloat16 else 'f32'} compute, "
                f"{'bf16' if carry == torch.bfloat16 else 'f32'} carry, {depth} layer(s)")
        layers = [init_params(RevLayerPair(m.dim, m.heads, m.dim_head, dtype=compute),
                              seed=1 + i).cuda() for i in range(depth)]
        h = tuple(t.to(carry) for t in (x, 0.5 * x, msa, 0.5 * msa))
        with torch.no_grad():
            stepped = h
            for layer in layers:
                stepped = layer(stepped, pm, mm)
            back = stepped
            for layer in reversed(layers):
                back = layer.invert(back, pm, mm)
        diff = [(a.float() - b.float()) for a, b in zip(h, back)]
        err = max(float(d.abs().max()) for d in diff)
        rel = float(torch.stack([d.norm() for d in diff]).norm()
                    / torch.stack([a.float().norm() for a in h]).norm())
        moved = max(float((a.float() - b.float()).abs().max()) for a, b in zip(h, stepped))
        scale = max(float(a.float().abs().max()) for a in h)
        out[what] = {"max": err, "rel_l2": rel}
        log(f"[engines] RevLayerPair at dim {m.dim}, crop {n}, MSA {r}x{l}, {what}: "
            f"invert(forward(h)) - h: max {err:.3e} (max |h| {scale:.3f}, the forward moved h "
            f"by up to {moved:.3f}), relative L2 {rel:.3e}")
        del layers
        if carry == torch.float32:
            bound = INVERT_REL_L2["bf16" if compute == torch.bfloat16 else "f32"][depth > 1]
            require(moved > 0.1 and rel <= bound,
                    f"the reversible coupling ({what}) does not invert within {bound:g}")
    return out


def _reversible_custom_vs_plain():
    """The reversible engine's hand-written backward against plain autograd
    through the same coupling, at full width on the card, f32 and then bf16
    compute from the same weights (the forwards take K1 without and with
    the row logsumexp): the loss within 1e-5 (f32) or 1e-3 (bf16) relative;
    the gradients' relative L2 over every leaf at once within 1e-4 (f32,
    roundoff) or 0.1 (bf16: the bf16 inversion error above enters the
    backward; a wrong backward is off by O(1)), and the worst leaf's. The
    yardstick for bf16: plain autograd in bf16 against plain autograd in
    f32, the rounding any bf16 step carries."""
    import torch

    from alphafold2_tpu_torch.data.pipeline import SyntheticDataset
    from alphafold2_tpu_torch.predict import init_params
    from alphafold2_tpu_torch.train import loop

    def rel(grads, ref):
        total = float(torch.stack([(grads[k] - g).norm() for k, g in ref.items()]).norm()
                      / torch.stack([g.norm() for g in ref.values()]).norm())
        worst = max((float((grads[k] - g).norm() / g.norm()), k)
                    for k, g in ref.items() if float(g.norm()) > 0)
        return total, worst

    out, f32_plain = {}, None
    for bf16, bound, loss_bound in ((False, 1e-4, 1e-5), (True, 1e-1, 1e-3)):
        cfg = _engine_config("reversible")
        cfg.model.bfloat16 = bf16
        batch = loop.batch_to_device(
            next(iter(SyntheticDataset(cfg.data, seed=cfg.train.seed))), torch.device("cuda"))
        model = init_params(loop.build_model(cfg), cfg.train.seed).cuda()
        custom_loss, custom = _loss_and_grads(model, batch)
        model.trunk.reversible.use_custom_vjp = False
        plain_loss, plain = _loss_and_grads(model, batch)
        total, (worst, worst_name) = rel(custom, plain)
        what = "bf16" if bf16 else "f32"
        out[what] = {"total": total, "worst": worst}
        log(f"[engines] reversible at full width, {what} compute: custom backward vs plain "
            f"autograd: loss {custom_loss:.6f} vs {plain_loss:.6f}; gradient relative L2 over "
            f"every leaf {total:.3e} (tol {bound:g}), worst leaf {worst:.3e} ({worst_name})")
        if bf16:
            for side, grads in (("plain autograd", plain), ("custom backward", custom)):
                t, (w, name) = rel(grads, f32_plain)
                out[f"bf16 {side} vs f32"] = {"total": t, "worst": w}
                log(f"[engines] reversible at full width, bf16 {side} against f32 plain "
                    f"autograd: gradient relative L2 over every leaf {t:.3e}, worst leaf "
                    f"{w:.3e} ({name})")
        else:
            f32_plain = plain
        require(abs(custom_loss - plain_loss) <= loss_bound * abs(plain_loss) and total <= bound,
                f"the reversible backward ({what}) disagrees with plain autograd")
        del model, custom, plain
        _free()
    return out


def _memory_sweep(at_base):
    """Peak device memory of one training step at MEMORY_DEPTHS (the first
    from the engine runs) for the default, remat and reversible engines,
    and each engine's slope a layer."""
    import torch

    out = {}
    for label in ("default", "remat", "reversible"):
        peaks = {MEMORY_DEPTHS[0]: at_base[label]["peak_bytes"]}
        for depth in MEMORY_DEPTHS[1:]:
            resident = torch.cuda.memory_allocated()
            fn = _step_fn(_engine_config(label, depth), False)
            _, peaks[depth] = _time_step(fn, 1)
            del fn
            _free()
            log(f"[engines] {label} at depth {depth}: {resident / 2**20:.1f} MiB held before "
                "the model")
        d0, d1 = MEMORY_DEPTHS[0], MEMORY_DEPTHS[-1]
        slope = (peaks[d1] - peaks[d0]) / (d1 - d0)
        out[label] = {"peaks": peaks, "slope_bytes": slope}
        log(f"[engines] peak device memory of one step, {label}: "
            + ", ".join(f"depth {d} {p / 2**20:.1f} MiB" for d, p in peaks.items())
            + f"; {slope / 2**20:.1f} MiB a layer")
    require(out["remat"]["slope_bytes"] < out["default"]["slope_bytes"]
            and out["reversible"]["slope_bytes"] < out["default"]["slope_bytes"],
            "remat or reversible memory grows with depth as fast as the default engine's")
    return out


def _serve_with_remat():
    """model.remat=True serves one batch of the serving smoke (bucket 128,
    full width, tied rows) with the same atom14 as remat=False."""
    import dataclasses

    import numpy as np

    from alphafold2_tpu_torch.config import Config
    from alphafold2_tpu_torch.serve.engine import ServeEngine, ServeRequest

    cfg = Config()
    cfg.model.msa_tie_row_attn = True
    cfg.serve.msa_depth = 5
    cfg_r = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=True))
    rng = np.random.default_rng(7)
    reqs = [ServeRequest("".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n)), seed=i)
            for i, n in enumerate((110, 128))]
    plain = ServeEngine(cfg)
    remat = ServeEngine(cfg_r, state_dict=plain.model.state_dict())
    require(remat.model.af2.trunk.remat, "the serving trunk did not take model.remat")
    a, b = plain.predict_many(reqs), remat.predict_many(reqs)
    require(all(r.ok for r in a + b), "a serving request failed")
    equal = all(np.array_equal(x.atom14, y.atom14) for x, y in zip(a, b))
    diff = max(float(np.abs(x.atom14 - y.atom14).max()) for x, y in zip(a, b))
    log(f"[engines] serving with model.remat=True, one bucket-{a[0].bucket} batch of "
        f"{len(reqs)}: atom14 bit-equal to remat=False: {equal} (max |diff| {diff:.3e})")
    require(equal, "serving with model.remat=True differs from remat=False")
    plain.close()
    remat.close()
    del plain, remat
    _free()


def phase_engines():
    """The trunk engines (log tag ``[engines]``): each ENGINES entry trained
    through its entry point at full width (launches a step, the step alone,
    peak memory); remat and scan held to the default engine on the card; a
    small f32 reversible model held to the CPU's plain versions; the
    reversible step inverted at full width; peak memory at MEMORY_DEPTHS;
    serving with model.remat=True."""
    t0 = time.perf_counter()
    runs = {label: _engine_run(label) for label in ENGINES}
    off = {label: r["off_expected"] for label, r in runs.items() if r["off_expected"]}
    require(not off, f"launches a step off the engines' schedules: {off}")
    for label in ("remat", "reversible"):
        fn = _step_fn(_engine_config(label), False)
        fn()  # warm
        profile_device(f"one {label} training step", fn, host=True)
        del fn
        _free()
    _engines_against_default()
    _reversible_parity()
    _reversible_inversion()
    _reversible_custom_vs_plain()
    memory = _memory_sweep(runs)
    _serve_with_remat()
    log(f"[engines] phase: {time.perf_counter() - t0:.1f} s")
    return {"runs": runs, "memory": memory}


# --------------------------------------------------------------- phase 10


TELEMETRY_STEPS = 2  # steps through train.loop.train per dropout configuration
TELEMETRY_REPS = 2  # steps timed back to back per configuration
# the dropout configurations at the training smoke's width: label ->
# ModelConfig fields
DROPOUT_RUNS = {
    "no dropout": {},
    "attn+ff dropout": {"attn_dropout": 0.1, "ff_dropout": 0.1},
    "ff dropout": {"ff_dropout": 0.1},
    "tied, ff dropout": {"ff_dropout": 0.1, "msa_tie_row_attn": True},
    "sparse, attn dropout": {"attn_dropout": 0.1, "sparse_self_attn": True},
}
TRIAGE_LAYER = 3  # the trunk layer the triage run poisons


def _dropout_config(fields):
    from alphafold2_tpu_torch.config import Config

    cfg = Config()
    cfg.model.depth = ENGINE_DEPTH
    for field, value in fields.items():
        setattr(cfg.model, field, value)
    return cfg


def _expected_dropout_launches(fields, depth):
    """Kernel launches a step under one DROPOUT_RUNS entry, by
    _training_kernels name. Active
    attention dropout takes JAX's dense route on every dense attention, as
    JAX's gate does, so K1 and K3 run only without it; the sparse pair
    passes keep K4/K5, with lse under grad; the last layer's MSA<-pair
    update runs no backward."""
    attn = fields.get("attn_dropout", 0.0) > 0
    tied, sparse = fields.get("msa_tie_row_attn", False), fields.get("sparse_self_attn", False)
    dense = 0 if attn else 6 * depth - tied * depth - 2 * sparse * depth
    out = {"fused_attention": dense, "fused_attention_bwd_dq": max(dense - 1, 0),
           "fused_attention_bwd_dkv": max(dense - 1, 0)}
    if tied and not attn:
        out.update({"tied_row_attention": depth, "tied_row_attention_bwd_dq": depth,
                    "tied_row_attention_bwd_dkv": depth})
    if sparse:
        out.update({"block_sparse_attention": 2 * depth, "block_sparse_attention_bwd_dq": 2 * depth,
                    "block_sparse_attention_bwd_dkv": 2 * depth})
    return out


def _dropout_run(label, card):
    """TELEMETRY_STEPS steps of one DROPOUT_RUNS configuration through
    train.loop.train, then the step alone under step 0's dropout key
    (_entry_point_run); the launches a step must be those the dropout gate
    gives."""
    from alphafold2_tpu_torch.ops.attention import DropoutKey

    cfg = _dropout_config(DROPOUT_RUNS[label])
    run = _entry_point_run("[telemetry]", f"{label} ({card})", cfg, False, TELEMETRY_STEPS,
                           TELEMETRY_REPS, key=DropoutKey.for_step(cfg.train.seed + 1, 0))
    expected = _expected_dropout_launches(DROPOUT_RUNS[label], cfg.model.depth)
    off = {name: (run["launches"].get(name, 0), n) for name, n in expected.items()
           if run["launches"].get(name, 0) != n}
    require(not off, f"{label}: launches a step (measured, expected) {off}")
    return run


def _dropout_engines(card):
    """Remat against the default engine under one dropout key at full width
    (attn+ff and ff-only dropout): loss and every gradient bit-equal. The
    reversible custom backward against plain autograd under one key at
    full width in f32 (attn and ff dropout 0.1): the loss within 1e-5
    relative, the gradients' relative L2 over every leaf within 1e-4, the
    bound _reversible_custom_vs_plain holds f32 to without dropout."""
    import torch

    from alphafold2_tpu_torch.data.pipeline import SyntheticDataset
    from alphafold2_tpu_torch.ops.attention import DropoutKey
    from alphafold2_tpu_torch.predict import init_params
    from alphafold2_tpu_torch.train import loop

    out = {}
    for label in ("attn+ff dropout", "ff dropout"):
        cfg = _dropout_config(DROPOUT_RUNS[label])
        key = DropoutKey.for_step(cfg.train.seed + 1, 0)
        batch = loop.batch_to_device(next(iter(SyntheticDataset(cfg.data, seed=cfg.train.seed))),
                                     torch.device("cuda"))
        base = init_params(loop.build_model(cfg), cfg.train.seed).cuda()
        ref_loss, ref = _loss_and_grads(base, batch, key)
        plain_loss, _ = _loss_and_grads(base, batch)  # no key: no dropout
        sd = base.state_dict()
        del base
        cfg.model.remat = True
        remat = loop.build_model(cfg)
        remat.load_state_dict(sd)
        loss, grads = _loss_and_grads(remat.cuda(), batch, key)
        equal = loss == ref_loss and all(torch.equal(grads[k], ref[k]) for k in ref)
        log(f"[telemetry] remat against the default engine under one dropout key, {label} "
            f"({card}): loss {loss:.6f} vs {ref_loss:.6f} (without the key {plain_loss:.6f}); "
            f"loss and every gradient bit-equal: {equal}")
        require(equal, f"remat under {label} differs from the default engine")
        require(plain_loss != ref_loss, f"{label}: the key changed nothing")
        out[f"remat, {label}"] = equal
        del remat, grads, ref
        _free()
    cfg = _dropout_config(DROPOUT_RUNS["attn+ff dropout"])
    cfg.model.reversible, cfg.model.bfloat16 = True, False
    key = DropoutKey.for_step(cfg.train.seed + 1, 0)
    batch = loop.batch_to_device(next(iter(SyntheticDataset(cfg.data, seed=cfg.train.seed))),
                                 torch.device("cuda"))
    model = init_params(loop.build_model(cfg), cfg.train.seed).cuda()
    custom_loss, custom = _loss_and_grads(model, batch, key)
    model.trunk.reversible.use_custom_vjp = False
    plain_loss, plain = _loss_and_grads(model, batch, key)
    total = float(torch.stack([(custom[k] - g).norm() for k, g in plain.items()]).norm()
                  / torch.stack([g.norm() for g in plain.values()]).norm())
    loss_rel = abs(custom_loss - plain_loss) / abs(plain_loss)
    log(f"[telemetry] reversible at full width, f32, attn and ff dropout 0.1 under one key "
        f"({card}): custom backward vs plain autograd: loss {custom_loss:.6f} vs "
        f"{plain_loss:.6f} (relative {loss_rel:.2e}; tol 1e-5), gradient relative L2 over every "
        f"leaf {total:.3e} (tol 1e-4)")
    require(loss_rel <= 1e-5 and total <= 1e-4,
            "the reversible backward under dropout disagrees with plain autograd")
    out["reversible f32 grad rel L2"] = total
    del model, custom, plain
    _free()
    return out


def _numerics_cost(card):
    """The step alone with the step's numerics modes, in turns: "off",
    "norms" (what train.numerics="triage" runs: per-group norms, the
    parameters cloned) and "full" (the norms and every tag's stats on the
    device, nothing read back)."""
    from alphafold2_tpu_torch.config import Config

    cfg = Config()
    cfg.model.depth = ENGINE_DEPTH
    times = {}
    for mode in ("off", "norms", "full", "full", "norms", "off"):
        fn = _step_fn(cfg, False, numerics_mode=mode)
        ms, _ = _time_step(fn, TELEMETRY_REPS)
        times.setdefault(mode, []).append(ms)
        del fn
        _free()
    log(f"[telemetry] the step alone by numerics mode, in turns off, norms, full, full, norms, "
        f"off ({card}): " + "; ".join(f"{mode} " + " / ".join(f"{ms:.2f}" for ms in t) + " ms"
                                       for mode, t in times.items()))
    return times


def _triage_run(card):
    """train.loop.train with numerics "triage" whose trunk layer
    TRIAGE_LAYER turns NaN after step 0: steps 1 and 2 skip, each is rerun
    fully tagged one step late, and its nan_triage must name
    trunk.layer_{TRIAGE_LAYER}.pair; the reruns launch K1 and K3 as a step
    does."""
    import contextlib
    import io

    import torch

    from alphafold2_tpu_torch.config import Config
    from alphafold2_tpu_torch.train import loop

    cfg = Config()
    cfg.train.numerics = "triage"
    prefix = f"trunk.layer_{TRIAGE_LAYER}."

    def poison(i, state, metrics):
        if i == 0:
            with torch.no_grad():
                for name, p in state.model.named_parameters():
                    if name.startswith(prefix):
                        p.fill_(float("nan"))

    plain, kernels = _plain_versions(), _training_kernels()
    _reset_counts(kernels, plain)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = loop.train(cfg, num_steps=3, callbacks=[poison])
    skipped = int(state.skipped)
    del state
    _free()
    launches = {name: fn.launches for name, fn in kernels.items()}
    notes = [line for line in out.getvalue().splitlines() if "event=nan_triage" in line]
    firsts = [line.split("first_nonfinite=")[1].split()[0] for line in notes]
    runs = 3 + len(notes)  # the steps and the reruns
    log(f"[telemetry] triage run, {prefix}* NaN after step 0 ({card}): skipped {skipped}; "
        f"nan_triage at " + ", ".join(n.split("]")[0] + "]" for n in notes)
        + f" naming {firsts}; K1 {launches['fused_attention']}, K3a "
        f"{launches['fused_attention_bwd_dq']}, K3b {launches['fused_attention_bwd_dkv']} "
        f"launches over 3 steps and {len(notes)} reruns")
    require(skipped == 2 and firsts == [f"trunk.layer_{TRIAGE_LAYER}.pair"] * 2,
            "the triage reruns did not name the poisoned layer")
    require(launches["fused_attention"] == 36 * runs
            and launches["fused_attention_bwd_dq"] == 35 * runs
            and launches["fused_attention_bwd_dkv"] == 35 * runs
            and kernels["fused_attention"].sm90_launches == launches["fused_attention"],
            "the triage reruns did not launch K1 and K3 as a step does")
    return {"first_nonfinite": firsts, "launches": launches}


def _trace_run(card):
    """train.loop.train with train.trace_events and train.profile_dir set
    and numerics "full" (3 steps, the profiler window around step 1): the
    span trace loads and holds a train.step span a step and the logged
    step's numerics counters; the profiler's Chrome trace holds the card's
    kernels."""
    import shutil

    from alphafold2_tpu_torch.config import Config
    from alphafold2_tpu_torch.observe.tracing import load_trace_events
    from alphafold2_tpu_torch.train import loop

    out_dir = os.path.join(HERE, "build", "telemetry")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = Config()
    cfg.model.depth = ENGINE_DEPTH
    cfg.train.trace_events = os.path.join(out_dir, "trace.json")
    cfg.train.profile_dir = os.path.join(out_dir, "profile")
    cfg.train.profile_steps = (1, 1)
    cfg.train.numerics = "full"
    loop.train(cfg, num_steps=3)
    _free()
    events = load_trace_events(cfg.train.trace_events)
    steps = [e for e in events if e["name"] == "train.step"]
    counters = [e for e in events if e["ph"] == "C" and e["name"].startswith("numerics/")]
    files = os.listdir(cfg.train.profile_dir)
    require(files == ["trace_steps_1_1.json"], f"the profiler window left {files}")
    path = os.path.join(cfg.train.profile_dir, files[0])
    with open(path) as f:
        trace = json.load(f)["traceEvents"]
    kernel_events = [e for e in trace if e.get("cat") == "kernel"]
    size = os.path.getsize(path)
    log(f"[telemetry] span trace ({card}): {len(events)} events, train.step spans "
        + ", ".join(f"step {e['args']['step']} {e['dur'] / 1e3:.2f} ms" for e in steps)
        + f", {len(counters)} numerics counters; profiler window {files} ({size / 2**20:.1f} MiB): {len(trace)} events, "
        f"{len(kernel_events)} device kernels, {len({e['name'] for e in kernel_events})} distinct")
    require([e["args"]["step"] for e in steps] == [0, 1, 2], "the span trace lacks train.step spans")
    require(bool(counters), "the span trace lacks the numerics counters")
    require(bool(kernel_events), "the profiler window left no trace of the card's kernels")
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"spans": len(events), "kernel_events": len(kernel_events)}


def phase_train_telemetry():
    """Dropout, numerics and the training telemetry (log tag
    ``[telemetry]``) at the training smoke's width: each DROPOUT_RUNS entry
    through train.loop.train (launches a step, the step alone, peak
    memory), and one attn+ff dropout step profiled; remat bit-equal to the default engine under one dropout key,
    and the reversible backward against plain autograd under one; a
    numerics "full" step against "off"; a poisoned-layer run whose NaN
    triage names the layer; a span trace and a profiler window. Every line
    carries the card's name and power limit."""
    from alphafold2_tpu_torch.ops.attention import DropoutKey

    t0 = time.perf_counter()
    card = _card()
    runs = {label: _dropout_run(label, card) for label in DROPOUT_RUNS}
    cfg = _dropout_config(DROPOUT_RUNS["attn+ff dropout"])
    fn = _step_fn(cfg, False, key=DropoutKey.for_step(cfg.train.seed + 1, 0))
    fn()  # warm
    profile_device(f"one attn+ff dropout training step ({card})", fn, host=True)
    del fn
    _free()
    engines = _dropout_engines(card)
    numerics_ms = _numerics_cost(card)
    triage = _triage_run(card)
    traces = _trace_run(card)
    log(f"[telemetry] phase: {time.perf_counter() - t0:.1f} s")
    return {"runs": runs, "engines": engines, "numerics_ms": numerics_ms, "triage": triage,
            "traces": traces}


# --------------------------------------------------------------- phase 11


# the template-axis pass at crop 384 with 4 templates: each of the 384^2
# pair positions attends over its 1+T = 5 tokens (x_ij, t^1_ij .. t^4_ij)
TEMPLATE_AXIS_LABEL = "template axis (147456x8, 5x5, d64)"
TEMPLATE_AXIS = (384 * 384, 8, 5, 64)  # (B*N*N, heads, 1+T, dim_head)
TEMPLATE_AXIS_SLICE = 8192  # batch rows held against the plain version at each end
# the PLM grid's tied rows: N = 128 rows of 128 at crop 128 (R*D 8192), and
# 192 of 192 in end-to-end training (crop 64 elongated x3, R*D 12288)
PLM_TIED_LABEL = "PLM tied rows, distogram (1x128x128x8x64, R*D 8192)"
PLM_TIED = (1, 128, 128, 8, 64)
PLM_E2E_TIED_LABEL = "PLM tied rows, end to end (1x192x192x8x64, R*D 12288)"
PLM_E2E_TIED = (1, 192, 192, 8, 64)
# config_4's tied MSA rows: 16 rows of 128 (R*D 1024)
CONFIG4_TIED_LABEL = "config_4 MSA rows (1x16x128x8x64, R*D 1024)"
CONFIG4_TIED = (1, 16, 128, 8, 64)
# the wide route's shapes on the port's paths
WIDE_TIED_CASES = {PLM_TIED_LABEL: PLM_TIED, PLM_E2E_TIED_LABEL: PLM_E2E_TIED,
                   CONFIG4_TIED_LABEL: CONFIG4_TIED}


def _template_axis_mask(b):
    """(B, 5) token validity: the pair token always valid; the last
    template token masked at every third pair position, the last three at
    every seventh (a template missing those residues)."""
    import torch

    mask = torch.ones((b, 5), dtype=torch.bool, device="cuda")
    mask[::3, 4] = False
    mask[1::7, 2:] = False
    return mask


def template_axis_case(dtype, gen, reps=0, library=False):
    """K1 (without and with the row logsumexp), K3a and K3b on the whole
    template-axis launch (the operands in the layout the template block's
    projections give them), each held against its plain version on a
    slice of TEMPLATE_AXIS_SLICE batch rows at each end of the batch (the
    last ones at the largest offsets); bf16 launches named on their Hopper
    kernels (K1 on attention_packed_kernel_sm90, with and without lse), two
    runs bit-identical, the key and grad splits logged; a negative control
    without each problem's last valid key, which still bites with 25
    problems packed into a tile. Returns result rows for K1, K1 (lse), K3a
    and K3b."""
    import torch
    import torch.nn.functional as F

    from alphafold2_tpu_torch.ops.cuda import axial

    label = TEMPLATE_AXIS_LABEL
    b, h, n, d = TEMPLATE_AXIS
    q, k, v, do = _grad_operands(b, h, n, n, d, dtype, gen, strided=True)
    mask = _template_axis_mask(b)
    scale = d**-0.5
    sl = torch.cat([torch.arange(TEMPLATE_AXIS_SLICE, device="cuda"),
                    torch.arange(b - TEMPLATE_AXIS_SLICE, b, device="cuda")])
    splits = (axial.key_splits(b, h, n, n, d), axial.grad_splits(b, h, n, n, d, "dq"),
              axial.grad_splits(b, h, n, n, d, "dkv"))
    log(f"[slice kernels] {label}: key splits {splits[0]}, grad splits (K3a, K3b) "
        f"{splits[1:]}")
    require(splits == (1, 1, 1), f"{label}: a 5-key pass must not split ({splits})")
    forward = lambda: axial.fused_attention(q, k, v, q_mask=mask, kv_mask=mask, sm_scale=scale)
    train_fwd = lambda: axial.fused_attention_lse(q, k, v, mask, mask, scale)
    bf16 = dtype == torch.bfloat16
    if bf16:
        out, _ = _sm90_launched(forward, label, "packed")
        (out_l, lse), _ = _sm90_launched(train_fwd, label, "packed")
        again = train_fwd()
        require(torch.equal(out, forward()) and torch.equal(out_l, again[0])
                and torch.equal(lse, again[1]), f"{label}: two K1 runs differ")
        del again
    else:
        out, (out_l, lse) = forward(), train_fwd()
    torch.cuda.synchronize()
    ref = axial.fused_attention_reference(q[sl], k[sl], v[sl], q_mask=mask[sl],
                                          kv_mask=mask[sl], sm_scale=scale)
    row = _compare(label, "fused_attention", out[sl], ref, dtype)
    _control(label, "fused_attention",
             axial.fused_attention(q, k, v, q_mask=mask, kv_mask=_drop_last_tile(mask),
                                   sm_scale=scale)[sl], ref, dtype)
    ref_out, ref_lse = axial.fused_attention_lse_reference(q[sl], k[sl], v[sl], mask[sl],
                                                           mask[sl], scale)
    fwd = _compare(label, "fused_attention (lse)", out_l[sl], ref_out, dtype)
    _check_lse(label, lse[sl], ref_lse)
    dsum = axial.attention_dsum(out_l, do)
    args = (q, k, v, do, lse, dsum, mask, mask, scale)
    if bf16:
        (dq, dk, dv), merged = _k3_sm90_launched(args, label)
        require(merged == 0, f"{label}: {merged} merge passes")
        require(torch.equal(dq, axial.fused_attention_dq(*args)), f"{label}: K3a not deterministic")
    else:
        dq = axial.fused_attention_dq(*args)
        dk, dv = axial.fused_attention_dkv(*args)
    torch.cuda.synchronize()
    sargs = (q[sl], k[sl], v[sl], do[sl], lse[sl], dsum[sl], mask[sl], mask[sl], scale)
    rq = axial.fused_attention_dq_reference(*sargs)
    rk, rv = axial.fused_attention_dkv_reference(*sargs)
    row_q = _compare(label, "fused_attention_bwd_dq", dq[sl], rq, dtype)
    row_k = _compare(label, "fused_attention_bwd_dkv dk", dk[sl], rk, dtype)
    row_v = _compare(label, "fused_attention_bwd_dkv dv", dv[sl], rv, dtype)
    row_kv = dict(row_k, kernel="fused_attention_bwd_dkv",
                  max_abs_err=max(row_k["max_abs_err"], row_v["max_abs_err"]))
    log(f"[slice kernels] {label} {row['dtype']}: the whole launch ({b} x {h} problems), "
        f"held on {2 * TEMPLATE_AXIS_SLICE} batch rows"
        + (", every launch on attention_packed_kernel_sm90 / dq_kernel_sm90 / "
           "dkv_kernel_sm90, two runs bit-identical" if bf16 else ""))
    qv = mask.sum(1).double()
    row.update(_bound(4.0 * h * d * float((qv * qv).sum()),
                      4 * b * h * n * d * q.element_size() + 2 * b * n, dtype))
    for r, bound in zip((fwd, row_q, row_kv), _k3_bounds(b, h, n, n, d, mask, mask, dtype)):
        r.update(bound)
    if reps:
        row["ms"] = cuda_ms(forward, reps)
        row["host_us"] = _host_us(forward)
        fwd["ms"] = cuda_ms(train_fwd, reps)
        row_q["ms"] = cuda_ms(lambda: axial.fused_attention_dq(*args), reps)
        row_kv["ms"] = cuda_ms(lambda: axial.fused_attention_dkv(*args), reps)
        row["plain_ms"] = cuda_ms(lambda: axial.fused_attention_reference(
            q, k, v, q_mask=mask, kv_mask=mask, sm_scale=scale), reps=1, warmup=0)
        fwd["plain_ms"] = cuda_ms(lambda: axial.fused_attention_lse_reference(
            q, k, v, mask, mask, scale), reps=1, warmup=0)
        row_q["plain_ms"] = cuda_ms(lambda: axial.fused_attention_dq_reference(*args),
                                    reps=1, warmup=0)
        row_kv["plain_ms"] = cuda_ms(lambda: axial.fused_attention_dkv_reference(*args),
                                     reps=1, warmup=0)
        if library:
            # the first SDPA backend that takes the whole launch (cuDNN's
            # graph refuses a batch this large)
            from torch.nn.attention import sdpa_kernel

            am = mask[:, None, None, :]
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            sdpa = lambda *t: F.scaled_dot_product_attention(*t, attn_mask=am, scale=scale)
            backend = _sdpa_backend(lambda: sdpa(*leaves).backward(do))
            for r in (row, fwd, row_q, row_kv):
                r["library"] = backend.name if backend is not None else None
                r["library_ms"] = None
            if backend is not None:
                with sdpa_kernel([backend]):
                    o = sdpa(*leaves)
                    row["library_ms"] = fwd["library_ms"] = cuda_ms(
                        lambda: sdpa(*(t.detach() for t in leaves)), reps)
                    row_q["library_ms"] = row_kv["library_ms"] = cuda_ms(
                        lambda: torch.autograd.grad(o, leaves, do, retain_graph=True), reps)
                del o
            log(f"[slice kernels] {label}: SDPA on its {row['library']} backend")
            del leaves
    del q, k, v, do, out, out_l, lse, dq, dk, dv
    _free()
    return [row, fwd, row_q, row_kv]


def phase_slice_kernels():
    """The kernels on the shapes the template and PLM paths give them that
    no earlier phase runs: K1 and K3a/K3b on the template-axis launch (f32
    and bf16, timed in bf16 beside SDPA); K2 with lse and its backward on
    the PLM grid's tied rows at R*D 8192 and 12288 and on config_4's MSA
    rows at R*D 1024 (f32 and bf16, timed in bf16 beside SDPA), the wide
    route's shapes (tied_row.wide_plan and wide_bwd_plan take them,
    hopper_plan and hopper_bwd_plan do not)."""
    import torch

    from alphafold2_tpu_torch.ops.cuda import tied_row as tr

    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        bf16 = dt == torch.bfloat16
        rows += template_axis_case(dt, gen, reps=10 if bf16 else 0, library=bf16)
    for label, (b, r, n, h, d) in WIDE_TIED_CASES.items():
        resident = (tr.hopper_plan(b, r, h, n, d), tr.hopper_bwd_plan("dq", b, h, n, n, r * d, d),
                    tr.hopper_bwd_plan("dkv", b, h, n, n, r * d, d))
        wide = (tr.wide_plan(b, r, h, n, n, d), tr.wide_bwd_plan(b, h, n, n, r * d, d))
        require(resident == (None, None, None) and None not in wide,
                f"{label}: R*D {r * d} must take the wide route: resident plans {resident}, "
                f"wide plans {wide}")
        for dt in (torch.bfloat16, torch.float32):
            timed = dt == torch.bfloat16
            rows += tied_case(label, b, r, n, h, d, dt, gen, reps=10 if timed else 0,
                              library=timed)
    for r in rows:
        if "ms" in r:
            log(f"[slice kernels] time {r['kernel']} {r['label']} {r['dtype']}: kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, sdpa {r.get('library_ms')} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
                f"{r['bound_ms'] / r['ms']:.1%} of the bound)"
                + (f"; dq, dk and dv in one call {r['grads_ms']:.4f} ms" if "grads_ms" in r
                   else ""))
    return rows


# --------------------------------------------------------------- phase 12


TEMPLATE_STEPS = 3  # forward and backward passes per template configuration
TEMPLATE_REPS = 3  # passes timed back to back
# bench_suite.py config_4's model and inputs: crop 384, MSA 16x128, 4 templates
TEMPLATE_CROP, TEMPLATE_MSA, TEMPLATE_T = 384, (16, 128), 4
TEMPLATE_RUNS = {"templates": False, "templates, SE(3) sidechains": True}


def _template_model(se3, dim=256, depth=2, heads=8, dim_head=64, crop=TEMPLATE_CROP,
                    template_depth=2, dtype=None):
    import torch

    from alphafold2_tpu_torch import constants
    from alphafold2_tpu_torch.models.alphafold2 import Alphafold2

    return Alphafold2(dim=dim, depth=depth, heads=heads, dim_head=dim_head,
                      max_seq_len=2 * crop, msa_tie_row_attn=True,
                      max_num_templates=constants.MAX_NUM_TEMPLATES,
                      template_attn_depth=template_depth, use_se3_template_embedder=se3,
                      dtype=torch.bfloat16 if dtype is None else dtype)


def _template_inputs(crop, msa, t, sidechains, device, seed=1):
    """config_4's inputs from a numpy seed: tokens, an MSA, templates with
    coordinates (x10 A) and, with ``sidechains``, unit sidechain vectors;
    every mask valid."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    side = rng.standard_normal((1, t, crop, 3))
    arrays = {
        "seq": rng.integers(0, 21, (1, crop)), "msa": rng.integers(0, 21, (1, *msa)),
        "mask": np.ones((1, crop), bool), "msa_mask": np.ones((1, *msa), bool),
        "templates_seq": rng.integers(0, 21, (1, t, crop)),
        "templates_coors": (rng.standard_normal((1, t, crop, 3)) * 10).astype(np.float32),
        "templates_mask": np.ones((1, t, crop), bool),
    }
    if sidechains:
        arrays["templates_sidechains"] = (side / np.linalg.norm(side, axis=-1,
                                                                keepdims=True)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def _template_step(model, inputs):
    """config_4's step: mean(logits**2), forward and backward; the loss."""
    model.zero_grad(set_to_none=True)
    loss = (model(**inputs).float() ** 2).mean()
    loss.backward()
    return loss.detach()


def _template_parity(se3):
    """A small f32 template model (dim 64, depth 1, heads 4, dim_head 16,
    crop 24, MSA 3x24, 2 templates, one template block): its loss and
    every gradient leaf on the card's kernels against the CPU's plain
    versions from the same weights and inputs."""
    import torch

    from alphafold2_tpu_torch.predict import init_params

    model = init_params(_template_model(se3, 64, 1, 4, 16, crop=24, template_depth=1,
                                        dtype=torch.float32), 2)
    loss, grads = {}, {}
    for side, dev in (("plain", "cpu"), ("kernels", "cuda")):
        m = model.to(dev)
        loss[side] = float(_template_step(m, _template_inputs(24, (3, 24), 2, se3, dev)))
        # copies: moving the model moves its .grad tensors in place
        grads[side] = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).to(
            "cpu", copy=True) for n, p in m.named_parameters()}
    # the embedder's rbf_bias.bias is 0 by symmetry, as the refiner's
    worst, worst_name, sym = _leaf_errors(grads["plain"], grads["kernels"])
    loss_rel = abs(loss["kernels"] - loss["plain"]) / abs(loss["plain"])
    log(f"[templates] small f32 model{' with SE(3) sidechains' if se3 else ''}, card vs CPU: "
        f"loss relative {loss_rel:.2e} (tol 1e-5), worst per-leaf gradient relative L2 "
        f"{worst:.3e} ({worst_name}; tol {GRAD_REL_L2:g}) over {len(grads['plain'])} leaves, "
        f"leaves 0 by symmetry within {sym:.2e} of the total norm (tol {E2E_ZERO_GRAD_ATOL:g})")
    require(loss_rel <= 1e-5 and worst <= GRAD_REL_L2 and sym <= E2E_ZERO_GRAD_ATOL,
            "the small template model disagrees between the card and the CPU")


def _template_expected(depth=2, template_depth=2):
    """Launches a config_4 step: a template block runs K1 on its pair axial
    (2), template axial (2) and template-axis (1) passes; a tied trunk
    layer on its pair axial (2), MSA column (1) and cross (2) passes and
    K2 on its MSA rows; every pass runs its backward but the last trunk
    layer's MSA<-pair update, which reaches no output."""
    k1 = 5 * template_depth + 5 * depth
    return {"fused_attention": k1, "fused_attention_bwd_dq": k1 - 1,
            "fused_attention_bwd_dkv": k1 - 1, "tied_row_attention": depth,
            "tied_row_attention_bwd_dq": depth, "tied_row_attention_bwd_dkv": depth}


def _template_run(label, se3, card, profile=False):
    """config_4 at full width (_template_model, bf16) on its inputs:
    TEMPLATE_STEPS forward and backward passes from launch counts of 0
    (finite losses and gradients, every K1 and K3 launch on its Hopper
    kernel, the two template-axis and two MSA column K1 passes on the packed
    kernel, every K2 launch and its backward on the wide route at R*D 1024,
    launches a step as _template_expected gives them, no plain version),
    then the pass alone and its peak memory; with ``profile`` one pass
    under torch.profiler."""
    import numpy as np
    import torch

    from alphafold2_tpu_torch.ops.cuda import tied_row as tr
    from alphafold2_tpu_torch.predict import init_params

    plain, kernels = _plain_versions(), _training_kernels()
    model = init_params(_template_model(se3), 0).cuda()
    inputs = _template_inputs(TEMPLATE_CROP, TEMPLATE_MSA, TEMPLATE_T, se3, "cuda")
    r, l = TEMPLATE_MSA
    require(tr.wide_plan(1, r, 8, l, l, 64) is not None
            and tr.wide_bwd_plan(1, 8, l, l, r * 64, 64) is not None,
            f"{label}: the MSA rows at R*D {r * 64} do not take the wide route")
    _reset_counts(kernels, plain)
    losses, finite = [], []
    for _ in range(TEMPLATE_STEPS):
        losses.append(float(_template_step(model, inputs)))
        finite.append(all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()
                          if p.grad is not None))
    torch.cuda.synchronize()
    per_step = {n: fn.launches / TEMPLATE_STEPS for n, fn in kernels.items() if fn.launches}
    hopper = {n: fn.sm90_launches / TEMPLATE_STEPS for n, fn in kernels.items()
              if hasattr(fn, "sm90_launches") and fn.launches}
    wide = {n: fn.wide_launches / TEMPLATE_STEPS for n, fn in kernels.items()
            if hasattr(fn, "wide_launches") and fn.launches}
    plain_calls = sum(fn.calls for fn in plain)
    packed = kernels["fused_attention"].packed_launches / TEMPLATE_STEPS
    expected = _template_expected()
    step_ms, peak = _time_step(lambda: _template_step(model, inputs), TEMPLATE_REPS)
    log(f"[templates] {label} ({card}): crop {TEMPLATE_CROP}, MSA {r}x{l}, {TEMPLATE_T} "
        f"templates, dim {model.dim}, depth 2, 2 template blocks, bf16: losses "
        + " ".join(f"{x:.5f}" for x in losses) + f"; the pass alone {step_ms:.2f} ms over "
        f"{TEMPLATE_REPS}, peak device memory {peak / 2**20:.1f} MiB; kernel launches a step "
        f"{per_step}; on a Hopper kernel {hopper}, of them on the wide route {wide}, K1 on "
        f"the packed kernel {packed}; plain-version calls {plain_calls}")
    require(bool(np.isfinite(losses).all()) and all(finite),
            f"{label}: a non-finite loss or gradient")
    require(plain_calls == 0, f"{label}: a plain version ran")
    # the template-axis pass of each template block and the MSA column pass
    # of each trunk layer on the packed kernel, and no other pass
    require(packed == 2 + 2, f"{label}: K1 on the packed kernel {packed} times a step, not 4")
    for name, n in expected.items():
        require(per_step.get(name, 0) == n, f"{label}: {name} launched {per_step.get(name, 0)} "
                                            f"times a step, expected {n}")
        require(hopper.get(name, 0) == n,
                f"{label}: {name} on a Hopper kernel {hopper.get(name, 0)} times a step")
        if name.startswith("tied"):
            require(wide.get(name, 0) == n,
                    f"{label}: {name} on the wide route {wide.get(name, 0)} times a step")
    if profile:
        profile_device(f"one config_4 pass, {label} ({card})",
                       lambda: _template_step(model, inputs), host=True)
    del model, inputs
    _free()
    return {"label": label, "step_ms": step_ms, "peak_bytes": peak, "launches": per_step,
            "losses": losses}


def phase_templates():
    """Template conditioning (log tag ``[templates]``): a small f32 model
    on the card against the CPU's plain versions, every gradient leaf, with
    and without the SE(3) sidechain embedder; then bench_suite.py
    config_4 at full width through Alphafold2.forward under a gradient,
    without and with the SE(3) embedder (_template_run; the first pass
    profiled), with the edge-attention path should_chunk picks for the
    embedder."""
    from alphafold2_tpu_torch.models.se3 import should_chunk

    t0 = time.perf_counter()
    card = _card()
    for se3 in (False, True):
        _template_parity(se3)
    streamed = should_chunk(TEMPLATE_T * 16, TEMPLATE_CROP, TEMPLATE_CROP)
    log(f"[templates] the SE(3) embedder at {TEMPLATE_T} x {TEMPLATE_CROP} residues takes the "
        f"{'streamed' if streamed else 'dense'} edge attention ({TEMPLATE_T} x 16 x "
        f"{TEMPLATE_CROP}^2 = {TEMPLATE_T * 16 * TEMPLATE_CROP**2} edge elements)")
    runs = {label: _template_run(label, se3, card, profile=not se3)
            for label, se3 in TEMPLATE_RUNS.items()}
    log(f"[templates] phase: {time.perf_counter() - t0:.1f} s")
    return {"runs": runs}


# --------------------------------------------------------------- phase 13


PLM_STEPS = 3  # distogram steps through train.loop.train per PLM configuration
PLM_E2E_STEPS = 2  # end-to-end steps through train_end2end
PLM_REPS = 2  # steps timed back to back
PLM_RUNS = {  # label: (tied, provider, end to end)
    "plm hash": (False, "hash", False),
    "plm tied hash": (True, "hash", False),
    "plm precomputed": (False, "precomputed", False),
    "plm tied precomputed": (True, "precomputed", False),
    "plm e2e": (False, "hash", True),
    "plm e2e tied": (True, "hash", True),
}
PREDICT_FLAGS = {"cross_attn_compress_ratio": 2, "msa_row_shard": True,
                 "grid_parallel": True, "context_parallel": "ring"}


PLM_DEPTH = 3  # the training smoke's 6 halved: the whole pass's time limit


def _plm_config(tied, provider, e2e, npz=None):
    """The training smoke's Config() (dim 256, crop 128, batch 1) at
    PLM_DEPTH, or the end-to-end CLI's (_e2e_config), on the plm stream."""
    from alphafold2_tpu_torch.config import Config

    cfg = _e2e_config(tied) if e2e else Config()
    if not e2e:
        cfg.model.depth = PLM_DEPTH
    cfg.model.msa_tie_row_attn = tied
    cfg.data.features, cfg.data.plm_provider, cfg.data.plm_path = "plm", provider, npz
    return cfg


def _write_plm_npz(cfg, batches, path):
    """An .npz of the hash provider's embeddings for the sequences of the
    first ``batches`` batches of ``cfg``'s source, keyed as
    PrecomputedProvider reads them: what a precomputed export of the same
    frozen model holds."""
    import numpy as np

    from alphafold2_tpu_torch.data.pipeline import make_dataset
    from alphafold2_tpu_torch.data.plm import HashProjectionProvider

    provider = HashProjectionProvider(seed=cfg.train.seed)
    it = iter(make_dataset(cfg.data, seed=cfg.train.seed))
    store = {}
    for _ in range(batches):
        seq = next(it)["seq"]
        for row, emb in zip(seq, provider(seq)):
            store["".join("ACDEFGHIKLMNPQRSTVWY"[t] if t < 20 else "X" for t in row)] = emb
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **store)
    return len(store)


def _plm_expected(cfg, e2e):
    """Launches a step on the plm stream: as the MSA stream's, the grid in
    the MSA's place (K1 on 6 passes a layer, 5 and K2 with tied rows; the
    last layer's MSA<-pair update runs no backward)."""
    depth, tied = cfg.model.depth, cfg.model.msa_tie_row_attn
    k1 = (6 - tied) * depth
    out = {"fused_attention": k1, "fused_attention_bwd_dq": k1 - 1,
           "fused_attention_bwd_dkv": k1 - 1}
    if tied:
        out.update({"tied_row_attention": depth, "tied_row_attention_bwd_dq": depth,
                    "tied_row_attention_bwd_dkv": depth})
    return out


def _predict_flags(card):
    """predict on the card with each of the four model flags JAX's predict
    runs: atom14 bit-equal to the plain config's."""
    import dataclasses

    import numpy as np

    from alphafold2_tpu_torch.predict import predict

    cfg = _e2e_config(True)
    seq = "MKVLAAGIHKACDEFGHIKLMNPQRSTVWYACDEFGHIKL"
    base = predict(cfg, seq, msa_depth=5, seed=1)
    same = {}
    for flag, value in PREDICT_FLAGS.items():
        flagged = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **{flag: value}))
        out = predict(flagged, seq, msa_depth=5, seed=1)
        same[flag] = bool(np.array_equal(out.atom14, base.atom14))
    log(f"[plm] predict on the card ({card}), {len(seq)} residues, dim 256, tied rows: atom14 "
        f"bit-equal to the plain config with each flag: {same}")
    require(all(same.values()), "a model flag changed predict's atom14 on the card")
    require(bool(np.isfinite(base.atom14).all()), "non-finite atom14")


def phase_plm():
    """The plm feature stream (log tag ``[plm]``): small f32 distogram
    models (untied, tied) and end-to-end models (untied, tied) on the plm
    stream on the card against the CPU's plain versions, every gradient
    leaf; then each PLM_RUNS configuration through train.loop.train or
    train_end2end (_entry_point_run): finite, unskipped, every K1 and K3
    launch on its Hopper kernel, every K2 launch and its backward on the
    wide route at R*D 8192 and 12288, launches a step as
    _plm_expected gives them, the step alone with its peak memory (one
    tied distogram and one tied end-to-end step profiled); the precomputed
    runs (an .npz the phase writes from the hash provider for
    the runs' sequences) bit-equal to the hash runs; predict with each of
    the four model flags bit-equal to the plain config."""
    from alphafold2_tpu_torch.config import Config

    t0 = time.perf_counter()
    card = _card()
    for tied in (False, True):
        small = Config()
        small.model.dim, small.model.depth, small.model.heads, small.model.dim_head = (
            64, 2, 4, 16)
        small.model.bfloat16, small.model.msa_tie_row_attn = False, tied
        small.data.crop_len, small.data.batch_size, small.data.features = 32, 2, "plm"
        _, worst, worst_name = _small_step_card_vs_cpu(small)
        log(f"[plm] small f32 model{' (tied)' if tied else ''}, plm stream, crop 32, card vs "
            f"CPU gradients: worst per-leaf relative L2 {worst:.3e} ({worst_name}; tol "
            f"{GRAD_REL_L2:g})")
        require(worst <= GRAD_REL_L2, "small plm gradients disagree between the card and the CPU")
        _e2e_parity(tied, "[plm]", features="plm")
    npz = os.path.join(HERE, "build", "plm_smoke", "hash_embeddings.npz")
    written = _write_plm_npz(_plm_config(False, "hash", False), PLM_STEPS, npz)
    log(f"[plm] wrote {written} sequences' hash embeddings to {os.path.relpath(npz, HERE)}")
    runs = {}
    for label, (tied, provider, e2e) in PLM_RUNS.items():
        cfg = _plm_config(tied, provider, e2e, npz if provider == "precomputed" else None)
        run = _entry_point_run(f"[plm] ({card})", label, cfg, e2e,
                               PLM_E2E_STEPS if e2e else PLM_STEPS, PLM_REPS)
        expected = _plm_expected(cfg, e2e)
        off = {n: (run["launches"].get(n, 0), x) for n, x in expected.items()
               if run["launches"].get(n, 0) != x}
        require(not off, f"{label}: launches a step (measured, expected) {off}")
        runs[label] = run
        if label in ("plm tied hash", "plm e2e tied"):
            fn = _step_fn(cfg, e2e)
            fn()  # warm
            profile_device(f"one {label} step ({card})", fn, host=True)
            del fn
            _free()
    for tied in ("", " tied"):
        a, b = runs[f"plm{tied} hash"]["losses"], runs[f"plm{tied} precomputed"]["losses"]
        log(f"[plm] plm{tied}: precomputed losses bit-equal to the hash provider's: {a == b}")
        require(a == b, f"plm{tied}: the precomputed run differs from the hash run")
    _predict_flags(card)
    log(f"[plm] phase: {time.perf_counter() - t0:.1f} s")
    return {"runs": runs}


# --------------------------------------------------------------- phase 6


# the sparse training path's pair axial pass: crop 128, 110 valid residues,
# so the pair mask leaves rows 110+ without a valid key; 2 per trunk layer
SPARSE_TRAIN_LABEL = "pair axial (128x8, 128x128, block 16)"
DISJOINT_LABEL = "disjoint lists (32x4, 256x256, block 16)"
SPARSE_GATHER_BYTES = 2 << 30  # the plain versions run in batch slices below this


def _dense_layout(layout):
    """The (nb, nb) bool layout a BlockLayout's row lists describe."""
    import numpy as np

    lay = np.zeros((layout.num_blocks, layout.num_blocks), dtype=bool)
    for i in range(layout.num_blocks):
        lay[i, layout.rows[i, :layout.row_counts[i]]] = True
    return lay


def _reached_keys(layout, kv_mask, b):
    """(B, nb) f32: the valid keys each query block's active blocks hold."""
    import torch

    nb, bs = layout.num_blocks, layout.block_size
    lay = torch.as_tensor(_dense_layout(layout), device="cuda", dtype=torch.float32)
    if kv_mask is None:
        keys = torch.full((b, nb), float(bs), device="cuda")
    else:
        keys = kv_mask.reshape(b, nb, bs).sum(-1).float()
    return keys @ lay.T


def _shortened(layout, kv_mask, rows):
    """``layout`` without each query block's last listed block that holds a
    valid key (``rows``), or without each key block's last listed query
    block: the work of a kernel that stopped one block early."""
    import numpy as np

    from alphafold2_tpu_torch.ops.cuda.block_sparse import BlockLayout

    nb, bs = layout.num_blocks, layout.block_size
    if not rows:
        return BlockLayout(layout.rows, layout.row_counts, layout.cols,
                           np.maximum(layout.col_counts - 1, 0), bs)
    has_key = (np.ones(nb, bool) if kv_mask is None
               else kv_mask.reshape(-1, nb, bs).any(-1).any(0).cpu().numpy())
    idx, cnt = np.zeros_like(layout.rows), layout.row_counts.copy()
    for i in range(nb):
        keep = list(layout.rows[i, :cnt[i]])
        valid = [j for j, blk in enumerate(keep) if has_key[blk]]
        if valid:
            del keep[valid[-1]]
        idx[i, :len(keep)], cnt[i] = keep, len(keep)
    return BlockLayout(idx, cnt, layout.cols, layout.col_counts, bs)


def _k5_sm90_counts():
    from alphafold2_tpu_torch.ops.cuda import block_sparse as bsa

    return (bsa.block_sparse_attention_dq.sm90_launches,
            bsa.block_sparse_attention_dkv.sm90_launches)


def _k4_sm90_counts():
    from alphafold2_tpu_torch.ops.cuda import block_sparse as bsa

    return (bsa.block_sparse_attention.sm90_launches,
            bsa.block_sparse_attention_lse.sm90_launches)


def _union_cost(layout):
    """The (query, key) pairs the Hopper K4/K5a and K5b stages cover,
    against the layout's active pairs: what streaming the union of each
    64-row tile's lists costs in products."""
    pairs = layout.active_pairs() * layout.block_size**2
    halves = max(layout.block_size // 64, 1)
    covered = [int(u[2].sum()) * halves * 64 * 64 for u in (layout.row_union, layout.col_union)]
    return (f"{covered[0] / pairs:.3f}x (K4, K5a) and {covered[1] / pairs:.3f}x (K5b) of the "
            f"{pairs} active pairs")


def disjoint_layout(nb=16, block=16):
    """A hand-made layout in which the query blocks of each 64-row tile
    list mostly different key blocks (each its own block, and two more
    spread over the axis): the union a Hopper K5 tile streams is wide, most
    of each stage lies outside each warp's list, and the last stage of a
    tile has empty slots."""
    import numpy as np

    from alphafold2_tpu_torch.ops.sparse import pack_layout

    lay = np.zeros((nb, nb), dtype=bool)
    for i in range(nb):
        lay[i, [i, (5 * i + 3) % nb, (11 * i + 7) % nb]] = True
    return pack_layout(lay, block)


def _plain_sliced(fn, tensors, layout, kv_mask, scale):
    """A sparse plain version over batch slices whose gathered blocks stay
    under SPARSE_GATHER_BYTES; outputs concatenated along the batch."""
    import torch

    b, h, n, d = tensors[0].shape
    per_row = 4 * 4 * h * layout.num_blocks * layout.rows.shape[1] * layout.block_size * d
    step = max(1, SPARSE_GATHER_BYTES // per_row)
    outs = []
    for lo in range(0, b, step):
        sl = slice(lo, lo + step)
        outs.append(fn(*(t[sl] for t in tensors), layout,
                       kv_mask[sl] if kv_mask is not None else None, scale))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def sparse_case(label, b, h, n, d, dtype, lengths, config, gen, reps=0, library=False,
                control=True, sm_scale=None):
    """K4 (with and without lse), K5a and K5b on one problem, each held
    against its plain version per tensor; rows without a valid key exactly
    0 (lse +inf, dq 0) and masked keys' dk, dv exactly 0; with ``control``
    the negative controls; two forward and two backward runs bit-identical;
    bf16 at head dim 32, 64 or 128 must run K4's and K5's Hopper kernels,
    anything else the older ones. ``lengths``: each batch row's valid keys
    (a prefix), or None; ``config``: a BlockSparseConfig, or a BlockLayout
    as it is; ``sm_scale`` defaults to d**-0.5. q, k, v and dO are strided
    as the grid route lays them out. Returns result rows for K4, K5a and
    K5b."""
    import torch
    import torch.nn.functional as F

    from alphafold2_tpu_torch.ops.cuda import axial
    from alphafold2_tpu_torch.ops.cuda import block_sparse as bsa
    from alphafold2_tpu_torch.ops.sparse import config_layout

    layout = config if isinstance(config, bsa.BlockLayout) else config_layout(config, n)
    q, k, v, do = _grad_operands(b, h, n, n, d, dtype, gen, strided=True)
    km = _prefix(n, lengths) if lengths is not None else None
    scale = d**-0.5 if sm_scale is None else sm_scale
    hopper = dtype == torch.bfloat16 and d in (32, 64, 128)
    before = _k4_sm90_counts()
    out_nl = bsa.block_sparse_attention(q, k, v, layout, km, scale)
    out, lse = bsa.block_sparse_attention_lse(q, k, v, layout, km, scale)
    torch.cuda.synchronize()
    sm90 = tuple(x - y for x, y in zip(_k4_sm90_counts(), before))
    require(sm90 == ((1, 1) if hopper else (0, 0)),
            f"{label}: K4 (no lse, lse) launched its Hopper kernel {sm90} times, not "
            f"{(1, 1) if hopper else (0, 0)}")
    out2, lse2 = bsa.block_sparse_attention_lse(q, k, v, layout, km, scale)
    require(torch.equal(out, out2) and torch.equal(lse, lse2)
            and torch.equal(out_nl, bsa.block_sparse_attention(q, k, v, layout, km, scale)),
            f"{label}: K4 not deterministic")
    del out2, lse2
    plain_fwd = lambda: _plain_sliced(bsa.block_sparse_attention_lse_reference, (q, k, v),
                                      layout, km, scale)
    ref_out, ref_lse = plain_fwd()
    _compare(label, "block_sparse_attention (no lse)", out_nl, ref_out, dtype)
    fwd = _compare(label, "block_sparse_attention", out, ref_out, dtype)
    _check_lse(label, lse, ref_lse, "block_sparse_attention")
    dsum = axial.attention_dsum(out, do)
    grad_in = (q, k, v, do, lse, dsum)
    args = (*grad_in, layout, km, scale)
    before = _k5_sm90_counts()
    dq = bsa.block_sparse_attention_dq(*args)
    dk, dv = bsa.block_sparse_attention_dkv(*args)
    torch.cuda.synchronize()
    sm90 = tuple(x - y for x, y in zip(_k5_sm90_counts(), before))
    require(sm90 == ((1, 1) if hopper else (0, 0)),
            f"{label}: K5a/K5b launched their Hopper kernels {sm90} times, not "
            f"{(1, 1) if hopper else (0, 0)}")
    plain_dq = lambda: _plain_sliced(bsa.block_sparse_attention_dq_reference, grad_in,
                                     layout, km, scale)
    plain_dkv = lambda: _plain_sliced(bsa.block_sparse_attention_dkv_reference, grad_in,
                                      layout, km, scale)
    rq = plain_dq()
    rk, rv = plain_dkv()
    row_q = _compare(label, "block_sparse_attention_bwd_dq", dq, rq, dtype)
    row_k = _compare(label, "block_sparse_attention_bwd_dkv dk", dk, rk, dtype)
    row_v = _compare(label, "block_sparse_attention_bwd_dkv dv", dv, rv, dtype)
    row_kv = dict(row_k, kernel="block_sparse_attention_bwd_dkv",
                  max_abs_err=max(row_k["max_abs_err"], row_v["max_abs_err"]))
    require(torch.equal(dq, bsa.block_sparse_attention_dq(*args)),
            f"{label}: K5a not deterministic")
    dk2, dv2 = bsa.block_sparse_attention_dkv(*args)
    require(torch.equal(dk, dk2) and torch.equal(dv, dv2), f"{label}: K5b not deterministic")
    # rows whose active blocks hold no valid key, and masked keys
    reached = _reached_keys(layout, km, b)  # (B, nb)
    dead = (reached == 0).repeat_interleave(layout.block_size, 1)[:, None, :]  # (B, 1, N)
    masked = (~km if km is not None else torch.zeros((b, n), dtype=torch.bool,
                                                     device="cuda"))[:, None, :]
    require(bool((out.masked_select(dead[..., None]) == 0).all())
            and bool((out_nl.masked_select(dead[..., None]) == 0).all())
            and bool(torch.isposinf(lse.masked_select(dead)).all())
            and bool((dq.masked_select(dead[..., None]) == 0).all()),
            f"{label}: a row without a valid key is not exactly 0 (out, lse +inf, dq)")
    require(bool((dk.masked_select(masked[..., None]) == 0).all())
            and bool((dv.masked_select(masked[..., None]) == 0).all()),
            f"{label}: a masked key has a nonzero dk or dv")
    log(f"[sparse] {label} {fwd['dtype']}: two forward and two backward runs bit-identical; "
        f"{int(dead.sum())} rows without a valid key exactly 0, "
        f"{int(masked.sum())} masked keys with dk = dv = 0; K4 on "
        f"{'sparse_fwd_kernel_sm90' if hopper else 'fwd_kernel'}, K5 on "
        f"{'sparse_dq/dkv_kernel_sm90' if hopper else 'dq/dkv_kernel'}")
    if control:
        rows_short = _shortened(layout, km, rows=True)
        cols_short = _shortened(layout, km, rows=False)
        short, _ = bsa.block_sparse_attention_lse(q, k, v, rows_short, km, scale)
        _control(label, "block_sparse_attention", short, ref_out, dtype,
                 tile="valid active block's")
        short = bsa.block_sparse_attention_dq(*grad_in, rows_short, km, scale)
        _control(label, "block_sparse_attention_bwd_dq", short, rq, dtype,
                 tile="valid active block's")
        sk, sv = bsa.block_sparse_attention_dkv(*grad_in, cols_short, km, scale)
        _control(label, "block_sparse_attention_bwd_dkv dk", sk, rk, dtype,
                 tile="query block's")
        _control(label, "block_sparse_attention_bwd_dkv dv", sv, rv, dtype,
                 tile="query block's")
        del short, sk, sv
    # the bound counts only the (query, key) pairs of active blocks whose
    # key is valid; every input read once and every output written once
    pairs = float(h * layout.block_size * reached.sum())
    es = q.element_size()
    tensor = b * h * n * d * es
    masks = b * n if km is not None else 0
    stats = 4 * b * h * n
    lists = 4 * (layout.rows.size + layout.row_counts.size)
    lists_t = 4 * (layout.cols.size + layout.col_counts.size)
    fwd.update(_bound(4.0 * d * pairs, 4 * tensor + masks + stats + lists, dtype))
    # K5a: q.k recompute, dO.v, ds.k; K5b: q.k recompute, dO.v, p^T dO, ds^T q
    row_q.update(_bound(6.0 * d * pairs, 5 * tensor + masks + 2 * stats + lists, dtype))
    row_kv.update(_bound(8.0 * d * pairs, 6 * tensor + masks + 2 * stats + lists_t, dtype))
    log(f"[sparse] {label}: layout {layout.num_blocks}x{layout.num_blocks} blocks of "
        f"{layout.block_size}, {layout.active_pairs()} active block pairs (density "
        f"{layout.active_pairs() / layout.num_blocks**2:.3f}); {pairs:.4e} valid "
        f"(query, key) pairs; the Hopper kernels' stages cover {_union_cost(layout)}")
    if reps:
        fwd["ms"] = cuda_ms(lambda: bsa.block_sparse_attention_lse(q, k, v, layout, km, scale),
                            reps)
        no_lse = cuda_ms(lambda: bsa.block_sparse_attention(q, k, v, layout, km, scale), reps)
        log(f"[sparse] {label}: K4 without lse {no_lse:.4f} ms")
        fwd["plain_ms"] = cuda_ms(plain_fwd, reps=1)
        row_q["ms"] = cuda_ms(lambda: bsa.block_sparse_attention_dq(*args), reps)
        row_kv["ms"] = cuda_ms(lambda: bsa.block_sparse_attention_dkv(*args), reps)
        row_q["plain_ms"] = cuda_ms(plain_dq, reps=1)
        row_kv["plain_ms"] = cuda_ms(plain_dkv, reps=1)
        if library:
            # the same function through SDPA: the element-level layout and
            # the key mask as one boolean mask; its forward, then its
            # backward (dq, dk and dv in one call)
            lay = torch.as_tensor(_dense_layout(layout), device="cuda")
            bs = layout.block_size
            am = lay.repeat_interleave(bs, 0).repeat_interleave(bs, 1)[None, None]
            if km is not None:
                am = am & km[:, None, None, :]
            try:
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                o = F.scaled_dot_product_attention(*leaves, attn_mask=am, scale=scale)
                fwd["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=am, scale=scale), reps)
                bwd = cuda_ms(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True),
                              reps)
                row_q["library_ms"] = row_kv["library_ms"] = bwd
                del o, leaves
            except (RuntimeError, torch.OutOfMemoryError) as e:
                log(f"[sparse] {label}: scaled_dot_product_attention failed: {e}")
                fwd["library_ms"] = row_q["library_ms"] = row_kv["library_ms"] = None
    del q, k, v, do, out, out_nl, lse, dq, dk, dv, rq, rk, rv, ref_out, ref_lse
    torch.cuda.empty_cache()
    return [fwd, row_q, row_kv]


K5_SM90 = ("sparse_dq_kernel_sm90<64>", "sparse_dkv_kernel_sm90<64>")
K4_SM90 = "sparse_fwd_kernel_sm90<64>"


def check_k4_plans():
    """K4's plans on the sparse training pass and at N 512: bf16 with
    TMA-aligned operands must name the Hopper kernel (a block per 64-query
    tile), unaligned bf16 and f32 the older one."""
    import ctypes

    from alphafold2_tpu_torch.ops.cuda import build

    lib = build.library("block_sparse_attention")
    for b, n in ((128, 128), (512, 512)):
        got = []
        for dtype, aligned in ((1, 1), (1, 0), (0, 1)):
            plan = build.LaunchPlan()
            build.check(lib, lib.af2_block_sparse_attention_plan(
                dtype, b, 8, n, 64, 16, aligned, ctypes.byref(plan)), "K4 plan")
            got.append((plan.kernel.decode(), plan.blocks, plan.threads, plan.dynamic_smem))
        log(f"[sparse] K4 plans ({b}x8, {n}, block 16): bf16 aligned {got[0]}, bf16 unaligned "
            f"{got[1]}, f32 {got[2]}")
        require(got[0][0] == K4_SM90 and got[0][1] == b * 8 * (n // 64),
                f"K4 plans {got[0]} for aligned bf16")
        require(got[1][0] == "fwd_kernel<__nv_bfloat16,16,64>" and
                got[2][0] == "fwd_kernel<float,16,64>",
                f"K4 plans {got[1][0]} / {got[2][0]} for unaligned bf16 / f32")


def check_k5_plans():
    """K5a's and K5b's plans on the sparse training pass and at N 512: bf16
    with TMA-aligned operands must name the Hopper kernels (a block per
    64-row tile), unaligned bf16 and f32 the older ones."""
    import ctypes

    from alphafold2_tpu_torch.ops.cuda import build

    lib = build.library("block_sparse_attention_bwd")
    for b, n in ((128, 128), (512, 512)):
        for which in (0, 1):
            got = []
            for dtype, aligned in ((1, 1), (1, 0), (0, 1)):
                plan = build.LaunchPlan()
                build.check(lib, lib.af2_block_sparse_attention_bwd_plan(
                    which, dtype, b, 8, n, 64, 16, aligned, ctypes.byref(plan)), "K5 plan")
                got.append((plan.kernel.decode(), plan.blocks, plan.threads,
                            plan.dynamic_smem))
            log(f"[sparse] K5{'ab'[which]} plans ({b}x8, {n}, block 16): bf16 aligned "
                f"{got[0]}, bf16 unaligned {got[1]}, f32 {got[2]}")
            require(got[0][0] == K5_SM90[which] and got[0][1] == b * 8 * (n // 64),
                    f"K5{'ab'[which]} plans {got[0]} for aligned bf16")
            older = ("dq_kernel" if which == 0 else "dkv_kernel")
            require(got[1][0] == f"{older}<__nv_bfloat16,16,64>" and
                    got[2][0] == f"{older}<float,16,64>",
                    f"K5{'ab'[which]} plans {got[1][0]} / {got[2][0]} for unaligned bf16 / f32")


def phase_sparse():
    import torch

    from alphafold2_tpu_torch.ops.sparse import BlockSparseConfig

    check_k4_plans()
    check_k5_plans()
    gen = torch.Generator(device="cuda").manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16
    default = BlockSparseConfig()
    rows = []
    for dt in (bf16, f32):
        # 20 launches back to back, so the card, not the host's launch
        # latency, sets the time of the short calls
        timed = dict(reps=20 if dt == bf16 else 0, library=dt == bf16, gen=gen)
        # the training path: one pair axial pass (128 grid rows fold into
        # the batch); the pair mask leaves rows 110+ without a valid key
        rows += sparse_case(SPARSE_TRAIN_LABEL, 128, 8, 128, 64, dt,
                            [TRAIN_LEN] * TRAIN_LEN + [0] * (128 - TRAIN_LEN), default,
                            **timed)
        # a length where the layout is really sparse (density 0.388)
        rows += sparse_case("pair axial (512x8, 512x512, block 16)", 512, 8, 512, 64, dt,
                            [500] * 500 + [0] * 12, default, **timed)
        # the flat route: a 100-long axis padded to 112, padding masked
        rows += sparse_case("flat route (64x8, 100 padded to 112, block 16)", 64, 8, 112,
                            64, dt, [100] * 56 + [81] * 8, default, **timed)
        rows += sparse_case("block 128 (16x4, 512x512, d128)", 16, 4, 512, 128, dt,
                            [512] * 8 + [300] * 8, BlockSparseConfig(block_size=128),
                            **timed)
        rows += sparse_case("block 32 (8x4, 256x256, d32)", 8, 4, 256, 32, dt,
                            [256, 200, 97, 256, 33, 256, 160, 1],
                            BlockSparseConfig(block_size=32, num_random_blocks=1), **timed)
        # half the batch rows without a valid key: exactly 0 (no control:
        # rows of zeros cannot tell a short kernel from a whole one)
        rows += sparse_case("dead rows (6x2, 64x64, d16)", 6, 2, 64, 16, dt,
                            [64, 0, 40, 0, 17, 0], default, control=False, **timed)
        # each 64-row tile's four blocks list mostly different blocks: most
        # of every stage lies outside each warp's list, and stages end in
        # empty slots (where ignoring the layout bits, or a non-finite
        # padding slot, would show)
        rows += sparse_case(DISJOINT_LABEL, 32, 4, 256, 64, dt, [256] * 24 + [131] * 8,
                            disjoint_layout(), **timed)
        # the same with a negative scale: a warp whose rows have no valid key
        # in a stage must neither take -inf - -inf nor +inf for its max
        rows += sparse_case("negative scale (disjoint, 32x4, 256x256)", 32, 4, 256, 64, dt,
                            [256] * 24 + [131] * 8, disjoint_layout(), sm_scale=-0.125,
                            gen=gen)
    return rows


# K5's timed passes: the sparse training path's pair axial pass (2 a trunk
# layer, 12 a step) and a length where the layout is really sparse
K5_TIME_CASES = {  # label: (b, n, valid keys of each batch row)
    SPARSE_TRAIN_LABEL: (128, 128, [TRAIN_LEN] * TRAIN_LEN + [0] * (128 - TRAIN_LEN)),
    "pair axial (512x8, 512x512, block 16)": (512, 512, [500] * 500 + [0] * 12),
}


def phase_k5_time(reps=10):
    """K5a and K5b alone on the sparse training pass and at (512x8, 512,
    block 16), bf16, operands laid out as the grid route lays them out,
    beside SDPA's whole backward (dq, dk and dv in one call) with the
    element-level layout and key mask; K4 (with lse), SDPA's forward, and K1
    with lse on the dense problem of the same shape and key mask (what the
    union costs against the dense kernel) beside those. Each: a call's time
    by CUDA events over ``reps`` calls, its device time under torch.profiler
    and its host time; then per sparse training step (12 calls of the
    training pass). No checks: phase_sparse holds the kernels to their plain
    versions. Uses only the public wrappers, so chip_compare.sh can run it
    on a parent's kernels. Returns {label: row}."""
    import torch
    import torch.nn.functional as F

    from alphafold2_tpu_torch.ops.cuda import axial
    from alphafold2_tpu_torch.ops.cuda import block_sparse as bsa
    from alphafold2_tpu_torch.ops.sparse import BlockSparseConfig, config_layout

    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = {}
    for label, (b, n, lengths) in K5_TIME_CASES.items():
        h, d = 8, 64
        layout = config_layout(BlockSparseConfig(), n)
        q, k, v, do = _grad_operands(b, h, n, n, d, torch.bfloat16, gen, strided=True)
        km = _prefix(n, lengths)
        scale = d**-0.5
        out, lse = bsa.block_sparse_attention_lse(q, k, v, layout, km, scale)
        args = (q, k, v, do, lse, axial.attention_dsum(out, do), layout, km, scale)
        lay = torch.as_tensor(_dense_layout(layout), device="cuda")
        bs = layout.block_size
        am = lay.repeat_interleave(bs, 0).repeat_interleave(bs, 1)[None, None]
        am = am & km[:, None, None, :]
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves, attn_mask=am, scale=scale)
        calls = {"dq": lambda: bsa.block_sparse_attention_dq(*args),
                 "dkv": lambda: bsa.block_sparse_attention_dkv(*args),
                 "sdpa_bwd": lambda: torch.autograd.grad(o, leaves, do, retain_graph=True),
                 "fwd": lambda: bsa.block_sparse_attention_lse(q, k, v, layout, km, scale),
                 "sdpa_fwd": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                                                     scale=scale),
                 "k1_dense": lambda: axial.fused_attention_lse(q, k, v, None, km, scale)}
        row = {}
        for name, fn in calls.items():
            row[f"{name}_ms"] = cuda_ms(fn, reps)
            row[f"{name}_device_ms"] = _device_ms(fn)
            row[f"{name}_host_us"] = _host_us(fn)
        rows[label] = row
        log(f"[k5 time] {label}: " + "; ".join(
            f"{what} {row[f'{m}_ms']:.4f} ms, device {row[f'{m}_device_ms']:.4f} ms, host "
            f"{row[f'{m}_host_us']:.1f} us a call"
            for m, what in (("dq", "K5a"), ("dkv", "K5b"), ("sdpa_bwd", "SDPA backward"),
                            ("fwd", "K4"), ("sdpa_fwd", "SDPA forward"),
                            ("k1_dense", "K1 with lse, dense"))))
        del q, k, v, do, out, lse, args, leaves, o, calls, am
        torch.cuda.empty_cache()
    step = rows[SPARSE_TRAIN_LABEL]
    for kind in ("", "device_"):
        k5a, k5b = 12 * step[f"dq_{kind}ms"], 12 * step[f"dkv_{kind}ms"]
        log(f"[k5 time] per sparse training step (12 calls), {kind or 'event '}ms: K5a "
            f"{k5a:.3f} + K5b {k5b:.3f} = {k5a + k5b:.3f} ms; SDPA backward "
            f"{12 * step[f'sdpa_bwd_{kind}ms']:.3f} ms; K4 {12 * step[f'fwd_{kind}ms']:.3f} "
            f"ms; SDPA forward {12 * step[f'sdpa_fwd_{kind}ms']:.3f} ms; K1 with lse, dense "
            f"{12 * step[f'k1_dense_{kind}ms']:.3f} ms")
    return rows


# K2's timed shapes (b, r, n, h, d): the serving tied MSA row pass (bucket
# 128 at batch 4, one a trunk layer) and the tied training pass (one a layer,
# 6 a step)
K2_TIME_CASES = {"tied MSA rows, serving (4x5x128x8x64, R*D 320)": (4, 5, 128, 8, 64),
                 TIED_TRAIN_LABEL: (1, 5, 64, 8, 64)}


def phase_k2_time(reps=10):
    """K2 (no lse) on the serving tied pass, and K2 with lse and K2's
    backward (dq; dk and dv) on the tied training pass, bf16, each beside
    SDPA on the folded (B, H, N, R*D) tensors (its forward, and its whole
    backward for K2's backward) on the backend that takes that head dim: a
    call's time by CUDA events over ``reps`` calls, its device time under
    torch.profiler and its host time; then per tied training step (6 calls).
    No checks: phase_kernels and phase_tied hold K2 to its plain versions.
    Uses only the public wrappers, so chip_compare.sh can run it on a
    parent's kernels. Returns {label: row}."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from alphafold2_tpu_torch.ops.cuda import tied_row as tr

    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = {}
    for label, (b, r, n, h, d) in K2_TIME_CASES.items():
        q, k, v, do, mask, tie = _tied_operands(b, r, n, h, d, torch.bfloat16, gen)
        scale = d**-0.5
        fold = lambda t: t.permute(0, 3, 2, 1, 4).reshape(b, h, n, r * d)
        qf = (fold(q).float() * tie[:, None, None, None]).to(torch.bfloat16)
        leaves = [t.detach().requires_grad_() for t in (qf, fold(k), fold(v))]
        am = mask[:, None, None, :]
        sdpa = lambda *t: F.scaled_dot_product_attention(*t, attn_mask=am, scale=scale)
        backend = _sdpa_backend(lambda: sdpa(*leaves).backward(fold(do)))
        require(backend is not None, f"{label}: no SDPA backend takes head dim {r * d}")
        if label == TIED_TRAIN_LABEL:
            out, lse = tr.tied_row_attention_lse(q, k, v, mask, mask, scale, tie)
            args = (q, k, v, do, lse, tr.tied_row_dsum(out, do), mask, mask, scale, tie)
            calls = {"lse": lambda: tr.tied_row_attention_lse(q, k, v, mask, mask, scale, tie),
                     "dq": lambda: tr.tied_row_attention_dq(*args),
                     "dkv": lambda: tr.tied_row_attention_dkv(*args)}
        else:
            calls = {"fwd": lambda: tr.tied_row_attention(q, k, v, q_mask=mask, kv_mask=mask,
                                                          sm_scale=scale, tie_scale=tie)}
        with sdpa_kernel([backend]):
            o = sdpa(*leaves)
            g = fold(do)
            calls["sdpa_fwd"] = lambda: sdpa(*(t.detach() for t in leaves))
            if label == TIED_TRAIN_LABEL:
                calls["sdpa_bwd"] = lambda: torch.autograd.grad(o, leaves, g, retain_graph=True)
            row = {"sdpa_backend": backend.name}
            for name, fn in calls.items():
                row[f"{name}_ms"] = cuda_ms(fn, reps)
                row[f"{name}_device_ms"] = _device_ms(fn)
                row[f"{name}_host_us"] = _host_us(fn)
        rows[label] = row
        names = {"fwd": "K2", "lse": "K2 with lse", "dq": "K2's backward dq",
                 "dkv": "K2's backward dk, dv", "sdpa_fwd": "SDPA forward",
                 "sdpa_bwd": "SDPA backward"}
        log(f"[k2 time] {label}, SDPA on {backend.name}: " + "; ".join(
            f"{names[m]} {row[f'{m}_ms']:.4f} ms, device {row[f'{m}_device_ms']:.4f} ms, host "
            f"{row[f'{m}_host_us']:.1f} us a call" for m in calls))
        del q, k, v, do, leaves, o, g, calls
        torch.cuda.empty_cache()
    step = rows[TIED_TRAIN_LABEL]
    for kind in ("", "device_"):
        log(f"[k2 time] per tied training step (6 calls), {kind or 'event '}ms: K2 with lse "
            f"{6 * step[f'lse_{kind}ms']:.3f}, SDPA forward {6 * step[f'sdpa_fwd_{kind}ms']:.3f}; "
            f"K2's backward {6 * step[f'dq_{kind}ms']:.3f} + {6 * step[f'dkv_{kind}ms']:.3f} = "
            f"{6 * (step[f'dq_{kind}ms'] + step[f'dkv_{kind}ms']):.3f}, SDPA backward "
            f"{6 * step[f'sdpa_bwd_{kind}ms']:.3f}")
    return rows



def phase_k2_wide_time(reps=10):
    """K2 with lse and K2's backward (dq; dk and dv; the three in one call
    where the tree has tied_row_attention_grads) on the wide route's shapes
    (WIDE_TIED_CASES: the PLM grid's tied rows at R*D 8192 and 12288,
    config_4's at 1024), bf16, beside SDPA's forward and whole backward on
    the folded (B, H, N, R*D) tensors where a backend takes that head dim:
    a call's time by CUDA events over ``reps`` calls and its device time
    under torch.profiler. No checks (phase_slice_kernels holds the kernels
    to their plain versions); only the public wrappers, so chip_compare.sh
    runs it on a parent's kernels. Returns {label: row}."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from alphafold2_tpu_torch.ops.cuda import tied_row as tr

    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = {}
    for label, (b, r, n, h, d) in WIDE_TIED_CASES.items():
        q, k, v, do, mask, tie = _tied_operands(b, r, n, h, d, torch.bfloat16, gen)
        scale = d**-0.5
        out, lse = tr.tied_row_attention_lse(q, k, v, mask, mask, scale, tie)
        args = (q, k, v, do, lse, tr.tied_row_dsum(out, do), mask, mask, scale, tie)
        calls = {"lse": lambda: tr.tied_row_attention_lse(q, k, v, mask, mask, scale, tie),
                 "dq": lambda: tr.tied_row_attention_dq(*args),
                 "dkv": lambda: tr.tied_row_attention_dkv(*args)}
        if hasattr(tr, "tied_row_attention_grads"):
            calls["grads"] = lambda: tr.tied_row_attention_grads(*args)
        fold = lambda t: t.permute(0, 3, 2, 1, 4).reshape(b, h, n, r * d)
        qf = (fold(q).float() * tie[:, None, None, None]).to(torch.bfloat16)
        leaves = [t.detach().requires_grad_() for t in (qf, fold(k), fold(v))]
        am = mask[:, None, None, :]
        sdpa = lambda *t: F.scaled_dot_product_attention(*t, attn_mask=am, scale=scale)
        backend = _sdpa_backend(lambda: sdpa(*leaves).backward(fold(do)))
        row = {"sdpa_backend": backend.name if backend is not None else None}
        for name, fn in calls.items():
            row[f"{name}_ms"] = cuda_ms(fn, reps)
            row[f"{name}_device_ms"] = _device_ms(fn)
        if backend is not None:
            with sdpa_kernel([backend]):
                o = sdpa(*leaves)
                g = fold(do)
                for name, fn in (("sdpa_fwd", lambda: sdpa(*(t.detach() for t in leaves))),
                                 ("sdpa_bwd", lambda: torch.autograd.grad(
                                     o, leaves, g, retain_graph=True))):
                    row[f"{name}_ms"] = cuda_ms(fn, reps)
                    row[f"{name}_device_ms"] = _device_ms(fn)
                del o, g
        rows[label] = row
        log(f"[k2 wide time] {label}, SDPA on {row['sdpa_backend']}: " + "; ".join(
            f"{m[:-3]} {x:.4f} ms" for m, x in row.items() if m.endswith("_ms")
            and not m.endswith("device_ms")) + " | device: " + "; ".join(
            f"{m[:-10]} {x:.4f} ms" for m, x in row.items() if m.endswith("device_ms")))
        del q, k, v, do, out, lse, args, leaves, calls
        _free()
    return rows


def phase_wide_steps(reps=3):
    """The training steps whose tied rows take K2's wide route, each alone
    over ``reps`` warm steps with its peak memory: the plm tied distogram
    step (R*D 8192), the plm tied end-to-end step (12288) and config_4's
    template pass without the SE(3) embedder (1024). No checks (phase_plm
    and phase_templates hold them); chip_compare.sh runs it on a parent's
    package. Returns {label: (ms, peak bytes)}."""
    out = {}
    for label, tied_e2e in (("plm tied hash", False), ("plm e2e tied", True)):
        fn = _step_fn(_plm_config(True, "hash", tied_e2e), tied_e2e)
        out[label] = _time_step(fn, reps)
        del fn
        _free()
    out["config_4 templates"] = phase_config4_pass(reps)
    for label, (ms, peak) in out.items():
        log(f"[wide steps] {label} ({_card()}): the step alone {ms:.2f} ms over {reps}, peak "
            f"device memory {peak / 2**20:.1f} MiB")
    return out


# K1 and K3 at head dim 256 (b, h, nq, nk): head_dim_case's problem, and the
# training pair axial pass with model.dim_head 256
D256_TIME_CASES = {"head dim 256 (2x4, 200x150)": (2, 4, 200, 150),
                   "pair axial at head dim 256 (128x8, 128x128)": (128, 8, 128, 128)}


def phase_d256_time(reps=10):
    """K1 without and with lse, K3a and K3b at head dim 256, bf16, operands laid out as
    the projections lay them out, beside SDPA's forward and its whole
    backward on the same masked problem: a call's time by CUDA events over
    ``reps`` calls, its device time under torch.profiler and its host time;
    each one's bound and its plain version's time. No checks:
    phase_head_dims holds them to their plain versions. Uses only the
    public wrappers, so chip_compare.sh can run it on a parent's kernels.
    Returns {label: row}."""
    import torch
    import torch.nn.functional as F

    from alphafold2_tpu_torch.ops.cuda import axial

    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = {}
    d = 256
    for label, (b, h, nq, nk) in D256_TIME_CASES.items():
        if b == 2:
            qm, km = _prefix(nq, [200, 123]), _prefix(nk, [150, 77])
        else:
            qm, km = _train_masks("pair axial (128x8, 128x128)")
        q, k, v, do = _grad_operands(b, h, nq, nk, d, torch.bfloat16, gen, strided=True)
        scale = d**-0.5
        out, lse = axial.fused_attention_lse(q, k, v, qm, km, scale)
        args = (q, k, v, do, lse, axial.attention_dsum(out, do), qm, km, scale)
        am = km[:, None, None, :]
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves, attn_mask=am, scale=scale)
        calls = {"fwd": lambda: axial.fused_attention(q, k, v, q_mask=qm, kv_mask=km,
                                                      sm_scale=scale),
                 "lse": lambda: axial.fused_attention_lse(q, k, v, qm, km, scale),
                 "dq": lambda: axial.fused_attention_dq(*args),
                 "dkv": lambda: axial.fused_attention_dkv(*args),
                 "sdpa_fwd": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                                                    scale=scale),
                 "sdpa_bwd": lambda: torch.autograd.grad(o, leaves, do, retain_graph=True)}
        row = {}
        for name, fn in calls.items():
            row[f"{name}_ms"] = cuda_ms(fn, reps)
            row[f"{name}_device_ms"] = _device_ms(fn)
            row[f"{name}_host_us"] = _host_us(fn)
        plain = (lambda: axial.fused_attention_lse_reference(q, k, v, qm, km, scale),
                 lambda: axial.fused_attention_dq_reference(*args),
                 lambda: axial.fused_attention_dkv_reference(*args))
        bounds = _k3_bounds(b, h, nq, nk, d, qm, km, torch.bfloat16)
        for name, fn, bound in zip(("lse", "dq", "dkv"), plain, bounds):
            row[f"{name}_plain_ms"] = cuda_ms(fn, reps=1)
            row[f"{name}_bound_ms"], row[f"{name}_bound_by"] = bound["bound_ms"], bound["bound_by"]
        rows[label] = row
        names = {"fwd": "K1", "lse": "K1 with lse", "dq": "K3a", "dkv": "K3b",
                 "sdpa_fwd": "SDPA forward", "sdpa_bwd": "SDPA backward"}
        log(f"[d256 time] {label}: " + "; ".join(
            f"{names[m]} {row[f'{m}_ms']:.4f} ms, device {row[f'{m}_device_ms']:.4f} ms, host "
            f"{row[f'{m}_host_us']:.1f} us a call" for m in calls))
        log(f"[d256 time] {label}, bound (plain) ms: " + "; ".join(
            f"{names[m]} {row[f'{m}_bound_ms']:.4f} ({row[f'{m}_bound_by']}; plain "
            f"{row[f'{m}_plain_ms']:.3f})" for m in ("lse", "dq", "dkv")))
        log(f"[d256 time] {label}, device ms: K3a + K3b "
            f"{row['dq_device_ms'] + row['dkv_device_ms']:.4f}, SDPA backward "
            f"{row['sdpa_bwd_device_ms']:.4f}; K1 {row['fwd_device_ms']:.4f}, K1 with lse "
            f"{row['lse_device_ms']:.4f}, SDPA forward {row['sdpa_fwd_device_ms']:.4f}")
        del q, k, v, do, out, lse, args, leaves, o, calls, plain
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------- phase 4


def _kabsch_rmsd(a, b):
    import torch

    from alphafold2_tpu_torch.utils.metrics import kabsch

    x = torch.as_tensor(a, dtype=torch.float64).reshape(-1, 3).T[None]
    y = torch.as_tensor(b, dtype=torch.float64).reshape(-1, 3).T[None]
    xa, yc = kabsch(x, y)
    return float(torch.sqrt(((xa - yc) ** 2).sum(1).mean()))


def phase_reference():
    """A small model, same weights, on the card (kernels) and on the CPU
    (plain versions), in float32."""
    import numpy as np
    import torch

    from alphafold2_tpu_torch.predict import init_params
    from alphafold2_tpu_torch.train.end2end import End2EndModel

    model = init_params(End2EndModel(dim=64, depth=2, heads=4, dim_head=16,
                                     max_seq_len=256, mds_iters=50,
                                     msa_tie_row_attn=True), seed=1).eval()
    rng = np.random.default_rng(0)
    b, l, m = 2, 24, 5
    seq = torch.from_numpy(rng.integers(0, 20, (b, l)))
    msa = torch.from_numpy(rng.integers(0, 20, (b, m, l)))
    mask = torch.ones((b, l), dtype=torch.bool)
    mask[1, 17:] = False
    msa_mask = mask[:, None].expand(b, m, l).contiguous()
    with torch.inference_mode():
        cpu = model(seq, msa, mask=mask, msa_mask=msa_mask)
        model.cuda()
        gpu = model(seq.cuda(), msa.cuda(), mask=mask.cuda(), msa_mask=msa_mask.cuda())
    m3 = mask.repeat_interleave(3, 1)
    pv = (m3[:, :, None] & m3[:, None, :])[..., None]
    err = float(((gpu["distogram"].cpu() - cpu["distogram"]).abs() * pv).max())
    log(f"[reference] small model distogram card vs cpu: max_abs_err={err:.3e} (tol 1e-3)")
    require(err <= 1e-3, "small model distogram disagrees between card and CPU")
    for i in range(b):
        L = int(mask[i].sum())
        r = _kabsch_rmsd(gpu["refined"][i, :L].cpu().numpy(), cpu["refined"][i, :L].numpy())
        log(f"[reference] small model refined coords, element {i}: Kabsch RMSD "
            f"{r:.3e} A (tol 0.5 A)")
        require(r <= 0.5, "small model structure disagrees between card and CPU")


def phase_se3_streamed():
    """The refiner's streamed edge attention against its dense path on the
    card, in f32, at the serving refiner's width (dim 64, 8 vector
    channels, 4 heads) and a bucket-128 batch of 2 (1792 atoms, padded to
    2048 in 1024-edge blocks): the threshold lowered so the same layer runs
    both paths; valid atoms held to the f32 bound."""
    import torch

    from alphafold2_tpu_torch.models import se3

    gen = torch.Generator(device="cuda").manual_seed(8)
    b, n = 2, 14 * 128
    layer = se3.EquivariantLayer(64, 8, 4).cuda()
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, device="cuda", generator=gen) * 0.2)
    s = torch.randn((b, n, 64), device="cuda", generator=gen)
    v = torch.randn((b, n, 8, 3), device="cuda", generator=gen)
    coords = torch.randn((b, n, 3), device="cuda", generator=gen) * 10
    mask = _prefix(n, [n, 14 * 97])
    threshold = se3.CHUNK_THRESHOLD
    require(not se3.should_chunk(b * layer.num_basis, n, n), "the dense path would stream")
    with torch.inference_mode():
        dense = layer(s, v, coords, mask=mask)
        se3.CHUNK_THRESHOLD = 1
        try:
            t0 = time.perf_counter()
            streamed = layer(s, v, coords, mask=mask)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            se3.CHUNK_THRESHOLD = threshold
    for name, a, r in zip(("scalars", "vectors"), streamed, dense):
        _compare(f"streamed vs dense, {b}x{n} atoms, valid atoms", f"SE(3) edge attention "
                 f"{name}", a[mask], r[mask], torch.float32)
    log(f"[se3] streamed layer ({b}x{n} atoms, {-(-n // 1024)}x{-(-n // 1024)} tiles), first "
        f"call: {secs * 1e3:.1f} ms")
    # one layer at a bucket-256 batch's size (4 x 3584 atoms, 4 x 4 tiles),
    # where serving streams it at the default threshold
    b, n = 4, 14 * 256
    s, v, coords = (torch.randn(shape, device="cuda", generator=gen)
                    for shape in ((b, n, 64), (b, n, 8, 3), (b, n, 3)))
    require(se3.should_chunk(b * layer.num_basis, n, n), "bucket 256 does not stream")
    with torch.inference_mode():
        ms = cuda_ms(lambda: layer(s, v, coords * 10, mask=_prefix(n, [n] * b)), reps=3)
    log(f"[se3] streamed layer at a bucket-256 batch ({b}x{n} atoms, 4x4 tiles, f32): "
        f"{ms:.2f} ms a layer")


SERVE_REQUEST_LENGTHS = [50, 64, 77, 96, 110, 128, 129, 150, 192, 193, 230, 256]
# phase_serve's engine runs Config()'s depth 6 (the main serving path, its
# launch counts); the serving phases after it build their own engines at
# SERVE_DEPTH, Config()'s 6 halved, for the whole pass's time limit
SERVE_MAIN_DEPTH = 6
SERVE_DEPTH = 3


def _serve_config(depth=SERVE_DEPTH, **serve):
    """The serving smoke configuration: Config() (dim 256, heads 8,
    dim_head 64, bf16 compute) at ``depth``, tied MSA rows, MSA depth 5, the
    default ladder 64-256 at batch 4 and 200 MDS iterations; ``serve``
    overrides ServeConfig fields."""
    import dataclasses

    from alphafold2_tpu_torch.config import Config

    cfg = Config()  # the default ladder: buckets 64, 96, 128, 192, 256 at batch 4
    require(cfg.model.depth == SERVE_MAIN_DEPTH, f"Config()'s depth is {cfg.model.depth}")
    cfg.model.depth = depth
    cfg.model.msa_tie_row_attn = True
    cfg.serve.msa_depth = 5
    require(cfg.serve.buckets == (64, 96, 128, 192, 256) and cfg.serve.max_batch == 4
            and cfg.serve.mds_iters == 200 and cfg.serve.pipeline_depth == 2
            and cfg.serve.feature_cache_size == 128 and cfg.serve.cache_size == 256,
            "ServeConfig's defaults changed")
    cfg.serve = dataclasses.replace(cfg.serve, **serve)
    return cfg


def _serve_requests():
    """The twelve requests of the serving phase: SERVE_REQUEST_LENGTHS residues,
    seeds 0-11, sequences from a seeded generator."""
    import numpy as np

    from alphafold2_tpu_torch.serve.engine import ServeRequest

    rng = np.random.default_rng(7)
    alphabet = "ACDEFGHIKLMNPQRSTVWY"
    return [ServeRequest(seq="".join(rng.choice(list(alphabet), n)), seed=i)
            for i, n in enumerate(SERVE_REQUEST_LENGTHS)]


def phase_serve():
    import numpy as np
    import torch

    from alphafold2_tpu_torch.serve.engine import ServeEngine

    from alphafold2_tpu_torch.constants import DISTOGRAM_BUCKETS
    from alphafold2_tpu_torch.models import se3

    cfg = _serve_config(depth=SERVE_MAIN_DEPTH)
    streamed = [bk for bk in cfg.serve.buckets
                if se3.should_chunk(cfg.serve.max_batch * 16, 14 * bk, 14 * bk)]
    require(streamed == [192, 256], f"buckets {streamed} stream the SE(3) edge attention")
    t0 = time.perf_counter()
    engine = ServeEngine(cfg)
    engine.warmup()
    torch.cuda.synchronize()
    log(f"[serve] engine built and warmed ({len(cfg.serve.buckets)} buckets "
        f"{cfg.serve.buckets}, refiner streamed at {streamed}) in "
        f"{time.perf_counter() - t0:.1f} s")

    lengths = SERVE_REQUEST_LENGTHS
    reqs = _serve_requests()

    read = _serve_counts()
    torch.cuda.reset_peak_memory_stats()
    # the six requests of 50-128 residues that earlier runs served, then the
    # six of 129-256 that only the full ladder serves, each timed alone
    results, walls = [], []
    for part in (reqs[:6], reqs[6:]):
        t0 = time.perf_counter()
        results += engine.predict_many(part)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = read()
    launches = {k: counts[k] for k in ("fused_attention", "fused_attention_combine",
                                       "tied_row_attention")}
    _require_hopper(counts, "serving")
    plain_calls = counts["plain_calls"]
    peak = torch.cuda.max_memory_allocated()

    for r in results:
        require(r.ok, f"request of {len(r.seq)} residues failed: {r.error}")
        require(r.atom14.shape == (len(r.seq), 14, 3), f"atom14 shape {r.atom14.shape}")
        require(bool(np.isfinite(r.atom14).all()), "non-finite atom14")
        log(f"[serve] {len(r.seq):4d} residues -> bucket {r.bucket}: "
            f"latency {r.latency_s * 1e3:.1f} ms (queue wait {r.queue_wait_s * 1e3:.1f} + "
            f"dispatch {r.dispatch_s * 1e3:.1f})")
    rates = []
    for what, part, wall in (("buckets 64-128", lengths[:6], walls[0]),
                             ("buckets 192-256", lengths[6:], walls[1])):
        rates.append(sum(part) / wall)
        log(f"[serve] {what}: {len(part)} requests, {sum(part)} residues in {wall:.3f} s: "
            f"{rates[-1]:.2f} residues/s")
    log(f"[serve] {len(reqs)} requests in {engine.counters.get('serve.batches')} batches "
        f"({engine.pipeline_desc}); peak device "
        f"memory {peak / 2**30:.2f} GiB")
    log(f"[serve] kernel launches on the path: {launches}; plain-version calls: "
        f"{plain_calls}")
    require(all(v > 0 for v in launches.values()), "a kernel never launched on the path")
    require(plain_calls == 0, "a plain version ran on the serving path")

    alone = engine.predict_many([reqs[4]])[0]
    diff = float(np.abs(alone.atom14 - results[4].atom14).max())
    log(f"[serve] same (sequence, seed) alone vs batched: max |d atom14| = {diff:.3e} A "
        "(tol 1e-3 A)")
    require(diff <= 1e-3, "batched and solo serving disagree")
    require(all(r.distogram is None for r in results), "a distogram came back unasked")

    # serve.return_distogram: the (3L, 3L, K) logits of each request
    cfg_d = _serve_config(depth=SERVE_MAIN_DEPTH, return_distogram=True)
    disto_engine = ServeEngine(cfg_d, state_dict=engine.model.state_dict())
    disto = disto_engine.predict_many([reqs[7]])[0]
    disto_engine.close()
    n3 = 3 * len(reqs[7].seq)
    require(disto.ok and disto.distogram is not None
            and disto.distogram.shape == (n3, n3, DISTOGRAM_BUCKETS)
            and bool(np.isfinite(disto.distogram).all()),
            f"return_distogram gave {getattr(disto.distogram, 'shape', None)}, not "
            f"{(n3, n3, DISTOGRAM_BUCKETS)}")
    log(f"[serve] return_distogram: a {len(reqs[7].seq)}-residue request came back with "
        f"finite {disto.distogram.shape} logits")

    bf16 = _serve_bf16(engine, cfg_d, reqs, rates[0], disto)
    _serve_checkpoint()

    profile_device(f"one bucket-{results[4].bucket} serving batch",
                   lambda: engine.predict_many(reqs[4:6]))
    profile_device(f"one bucket-{results[-1].bucket} serving batch (streamed refiner)",
                   lambda: engine.predict_many(reqs[9:]))
    for lo, hi in ((4, 6), (9, 12)):
        spans, total = _module_spans({"trunk and distogram head": engine.model.af2,
                                      "SE(3) refiner": engine.model.refiner},
                                     lambda: engine.predict_many(reqs[lo:hi]))
        log(f"[serve] bucket-{results[lo].bucket} batch, device timeline {total:.1f} ms: "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in spans.items())
            + f", the rest (featurization, realization, copies) {total - sum(spans.values()):.1f} ms")
    return {"launches": launches, "wall_s": walls, "residues_per_s": rates,
            "peak_bytes": peak, "bf16": bf16,
            "latency_ms": [round(r.latency_s * 1e3, 3) for r in results], "engine": engine}


# the bf16 serving engine against the f32-parameter one: the distogram
# logits' relative L2 bound of tests/test_precision.py
SERVE_BF16_LOGITS_BOUND = 0.05


def _serve_bf16(engine, cfg_d, reqs, f32_rate, f32_disto):
    """serve.dtype=bfloat16 on the serving smoke config (every parameter
    cast to bf16): the six requests of 50-128 residues served with finite
    atom14, timed beside the f32-parameter engine's figure, and one
    request's distogram logits within SERVE_BF16_LOGITS_BOUND of the
    f32-parameter engine's (which computes in bf16 too: with LayerNorm
    scales of 1 and biases of 0, which bf16 holds exactly, the two agree
    bit for bit) and of an engine computing in f32 (model.bfloat16=False:
    the drift test_precision.py bounds, which must not be 0). The atom14
    Kabsch-aligned CA RMSD is logged: the realization amplifies trunk-level
    drift, so coordinates carry no bound."""
    import dataclasses

    import numpy as np
    import torch

    from alphafold2_tpu_torch.serve.engine import ServeEngine

    cfg = dataclasses.replace(cfg_d, serve=dataclasses.replace(cfg_d.serve, dtype="bfloat16"))
    bf16 = ServeEngine(cfg, state_dict=engine.model.state_dict())
    require(all(p.dtype == torch.bfloat16 for p in bf16.model.parameters()),
            "serve.dtype=bfloat16 left a parameter in another dtype")
    bf16.warmup()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = bf16.predict_many(reqs[:6])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in out:
        require(r.ok, f"bf16 serving: a request of {len(r.seq)} residues failed: {r.error}")
        require(bool(np.isfinite(r.atom14).all()), "bf16 serving: non-finite atom14")
    rate = sum(len(r.seq) for r in out) / wall
    one = bf16.predict_many([reqs[7]])[0]
    bf16.close()
    del bf16
    _free()
    f32_model = dataclasses.replace(cfg_d, model=dataclasses.replace(cfg_d.model,
                                                                     bfloat16=False))
    f32_engine = ServeEngine(f32_model, state_dict=engine.model.state_dict())
    f32 = f32_engine.predict_many([reqs[7]])[0]
    f32_engine.close()
    _free()
    rel = lambda x, y: float(np.linalg.norm(x - y) / np.linalg.norm(y))
    same, drift = rel(one.distogram, f32_disto.distogram), rel(one.distogram, f32.distogram)
    rmsd = _kabsch_rmsd(one.atom14[:, 1], f32.atom14[:, 1])
    log(f"[serve] serve.dtype=bfloat16: 6 requests of 50-128 residues finite, "
        f"{rate:.2f} residues/s (f32 parameters: {f32_rate:.2f}); a {len(one.seq)}-residue "
        f"request's distogram logits relative L2 {same:.3e} from the f32-parameter engine's "
        f"(bf16 compute) and {drift:.3e} from an f32-compute engine's (bound "
        f"{SERVE_BF16_LOGITS_BOUND}); CA RMSD after Kabsch from the f32-compute engine's "
        f"{rmsd:.3f} A")
    require(same <= SERVE_BF16_LOGITS_BOUND and 0 < drift <= SERVE_BF16_LOGITS_BOUND,
            "bf16 serving drifts past tests/test_precision.py's logits bound")
    return {"residues_per_s": rate, "logits_rel_l2": drift, "ca_rmsd": rmsd}


def _serve_checkpoint():
    """An engine built from a 2-step end-to-end checkpoint (the end-to-end
    CLI's width) against predict(checkpoint_dir=...) on one 64-residue
    request alone in bucket 64 with one MSA row, 200 MDS iterations and
    predict's seed the engine's MDS seed: atom14 bit for bit."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from alphafold2_tpu_torch.predict import predict
    from alphafold2_tpu_torch.serve.engine import ServeEngine, ServeRequest
    from alphafold2_tpu_torch.train import end2end

    root = tempfile.mkdtemp(prefix="af2_serve_ckpt_")
    try:
        cfg = _e2e_config(False)
        cfg.train.checkpoint_dir = root
        cfg.train.numerics = "off"
        cfg.serve = dataclasses.replace(cfg.serve, buckets=(64,), max_batch=1, msa_depth=1,
                                        mds_iters=200)
        end2end.train_end2end(cfg, num_steps=2)
        seq = "".join(np.random.default_rng(11).choice(list("ACDEFGHIKLMNPQRSTVWY"), 64))
        engine = ServeEngine(cfg, checkpoint_dir=root)
        got = engine.predict_many([ServeRequest(seq=seq, seed=cfg.train.seed)])[0]
        engine.close()
        want = predict(cfg, seq, msa_depth=1, seed=cfg.train.seed, checkpoint_dir=root)
        same = got.ok and np.array_equal(got.atom14, want.atom14)
        log(f"[serve] ServeEngine(checkpoint_dir=) from a 2-step end-to-end checkpoint "
            f"against predict(checkpoint_dir=): atom14 bit-equal {same}"
            + ("" if same else f" (max |d| {np.abs(got.atom14 - want.atom14).max():.3e} A)"))
        require(same, "the checkpoint engine and predict disagree")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        _free()


# --------------------------------------------------------------- async serving

SERVE_ASYNC_BURST = 32  # requests of the open-loop burst
# the twelve requests' runs, serial and pipelined in turns
SERVE_ASYNC_TURNS = ("serial", "pipelined")
SERVE_ASYNC_LOAD = 0.8  # the burst's Poisson rate over the serial request rate
# distogram logits and weights, pipelined against serial: max |d| over max |serial|
SERVE_PIPELINE_REL = 1e-5
BURST_PARENT = 128  # residues of the burst's mutant family
BURST_MUTANTS = 6
BURST_FAULT_BUCKET = 64  # the burst's first dispatch there fails at "compute"
BURST_DEADLINE_LEN = 80  # bucket 96, which the rest of the burst leaves empty


def _serve_counts():
    """Set K1's and K2's launch counts and the plain versions' calls to 0;
    return a function that reads them."""
    from alphafold2_tpu_torch.ops.cuda.axial import (
        fused_attention, fused_attention_combine, fused_attention_reference)
    from alphafold2_tpu_torch.ops.cuda.tied_row import (
        tied_row_attention, tied_row_attention_reference)

    for fn in (fused_attention, tied_row_attention, fused_attention_combine):
        fn.launches = 0
    fused_attention.sm90_launches = tied_row_attention.sm90_launches = 0
    fused_attention.packed_launches = 0
    plain = (fused_attention_reference, tied_row_attention_reference)
    for fn in plain:
        fn.calls = 0

    def read():
        return {"fused_attention": fused_attention.launches,
                "fused_attention_combine": fused_attention_combine.launches,
                "tied_row_attention": tied_row_attention.launches,
                "fused_attention_sm90": fused_attention.sm90_launches,
                "fused_attention_packed": fused_attention.packed_launches,
                "tied_row_attention_sm90": tied_row_attention.sm90_launches,
                "plain_calls": sum(fn.calls for fn in plain)}

    return read


def _require_hopper(counts, what):
    """Every K1 and K2 launch of a run on its Hopper kernel (the MSA column
    pass, one K1 pass in five, on the packed one), none on a plain version."""
    require(counts["fused_attention"] > 0 and counts["tied_row_attention"] > 0,
            f"{what}: K1 or K2 never launched ({counts})")
    require(counts["fused_attention_sm90"] == counts["fused_attention"],
            f"{what}: {counts['fused_attention'] - counts['fused_attention_sm90']} K1 launches "
            f"off its Hopper kernel")
    require(5 * counts["fused_attention_packed"] == counts["fused_attention"],
            f"{what}: K1's packed launches {counts['fused_attention_packed']} of "
            f"{counts['fused_attention']}: not one MSA column pass in five")
    require(counts["tied_row_attention_sm90"] == counts["tied_row_attention"],
            f"{what}: {counts['tied_row_attention'] - counts['tied_row_attention_sm90']} K2 "
            f"launches off tied_row_attention_kernel_sm90")
    require(counts["plain_calls"] == 0, f"{what}: a plain version ran on the serving path")


RUNTIME_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx", "cudaLaunchKernelExC",
                 "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                 "cudaMemcpyAsync", "cudaMemcpy", "cudaStreamWaitEvent")


def _idle_share(fn):
    """``fn()`` under torch.profiler: ``{"wall_ms", "busy_ms", "idle",
    "runtime"}``. Busy is the union of the device activity intervals (CUPTI
    sees every thread's kernels and copies), idle 1 - busy / wall, None if
    the profiler recorded no device activity; ``runtime`` counts the CUDA
    runtime calls of RUNTIME_CALLS the profiler saw."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    runtime = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CPU and e.key in RUNTIME_CALLS}
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start)
    if not spans:
        return {"wall_ms": wall_ms, "busy_ms": None, "idle": None, "runtime": runtime}
    busy_us, lo, hi = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > hi:
            busy_us += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy_ms = (busy_us + hi - lo) / 1e3
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle": max(0.0, 1.0 - busy_ms / wall_ms),
            "runtime": runtime}


def _pipelined_against_serial(state_dict, reqs):
    """The twelve requests through a pipelined and a serial engine with
    ``return_distogram``: every result ok and finite, the distogram logits
    and weights within SERVE_PIPELINE_REL, every K1/K2 launch of the
    pipelined run on its Hopper kernel."""
    import numpy as np

    from alphafold2_tpu_torch.serve.engine import ServeEngine

    out = {}
    for depth in (2, 0):
        engine = ServeEngine(_serve_config(pipeline_depth=depth, return_distogram=True),
                             state_dict=state_dict)
        engine.warmup()
        read = _serve_counts()
        out[depth] = engine.predict_many(reqs)
        counts = read()
        if depth:
            _require_hopper(counts, "pipelined serving with return_distogram")
        engine.close()
        del engine
        _free()
    worst = {"distogram": 0.0, "weights": 0.0}
    bit_equal = True
    for p, s in zip(out[2], out[0]):
        for r in (p, s):
            require(r.ok, f"a request of {len(r.seq)} residues failed: {r.error}")
            require(bool(np.isfinite(r.atom14).all() and np.isfinite(r.distogram).all()),
                    f"non-finite output for a request of {len(r.seq)} residues")
        for k in worst:
            a, b = getattr(p, k), getattr(s, k)
            worst[k] = max(worst[k], float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)))
        bit_equal &= all(getattr(p, k).tobytes() == getattr(s, k).tobytes()
                         for k in ("atom14", "weights", "distogram"))
    log(f"[serve_async] pipelined (depth 2) against serial (depth 0), 12 requests with "
        f"return_distogram: largest max|d|/max|serial| distogram {worst['distogram']:.3e}, "
        f"weights {worst['weights']:.3e} (bound {SERVE_PIPELINE_REL}); atom14, weights and "
        f"distogram bit-equal: {bit_equal}")
    require(all(v <= SERVE_PIPELINE_REL for v in worst.values()),
            "pipelined and serial serving disagree")
    return {"max_rel": worst, "bit_equal": bit_equal}


def _burst(rng, lengths_pool):
    """The burst's requests in arrival order: 20 chains (lengths from
    ``lengths_pool``, the first two in BURST_FAULT_BUCKET), a 128-residue
    parent and its six point mutants (one seed, a parent hint), four exact
    repeats of earlier chains, and one 80-residue request (bucket 96, which
    nothing else uses) with a deadline of 1 ns, already passed when the
    frontend next looks. Returns (requests, kinds)."""
    from alphafold2_tpu_torch.serve.engine import ServeRequest

    alphabet = list("ACDEFGHIKLMNPQRSTVWY")
    chain = lambda n: "".join(rng.choice(alphabet, int(n)))  # noqa: E731
    lengths = [BURST_FAULT_BUCKET - 4, BURST_FAULT_BUCKET - 9] + list(rng.choice(lengths_pool, 18))
    others = [ServeRequest(chain(n), seed=1000 + i) for i, n in enumerate(lengths)]
    parent = chain(BURST_PARENT)
    positions = rng.choice(BURST_PARENT, BURST_MUTANTS, replace=False)
    mutants = []
    for p in positions:
        sub = [a for a in alphabet if a != parent[p]][int(rng.integers(0, 19))]
        mutants.append(ServeRequest(parent[:p] + sub + parent[p + 1:], seed=500,
                                    parent_id="burst-parent"))
    family = [ServeRequest(parent, seed=500, parent_id="burst-parent")] + mutants
    dup = lambda r: ServeRequest(r.seq, seed=r.seed)  # noqa: E731
    late = ServeRequest(chain(BURST_DEADLINE_LEN), seed=900, deadline_s=1e-9)
    o, m = others, family[1:]
    order = (o[:8] + [family[0], o[8], dup(o[1]), o[9], m[0], o[10], m[1], late, o[11], m[2],
                      dup(o[3]), o[12], o[13], m[3], o[14], dup(o[5]), m[4], o[15], o[16],
                      m[5], o[17], dup(o[7]), o[18], o[19]])
    kinds = (["chain"] * 8 + ["parent", "chain", "repeat", "chain", "mutant", "chain", "mutant",
                              "deadline", "chain", "mutant", "repeat", "chain", "chain",
                              "mutant", "chain", "repeat", "mutant", "chain", "chain",
                              "mutant", "chain", "repeat", "chain", "chain"])
    require(len(order) == len(kinds) == SERVE_ASYNC_BURST, "the burst's composition changed")
    return order, kinds


def phase_serve_async(engine=None):
    """The serving plane on the card (log tag ``[serve_async]``), on the
    serving configuration at SERVE_DEPTH (``engine``, pipelined and warm;
    built here from the seed when none is given): the twelve requests
    pipelined (depth 2) against serial (depth 0), outputs equal, each
    one's residues/s and device idle share; then an open-loop Poisson burst
    through AsyncServeFrontend (duplicates, a mutant family, a stage fault,
    a passed deadline) with its latency quantiles, counters, span totals
    and peak memory. Every K1/K2 launch on its Hopper kernel throughout."""
    from collections import Counter

    import numpy as np
    import torch

    from alphafold2_tpu_torch.observe import Tracer
    from alphafold2_tpu_torch.serve import AsyncServeFrontend, FaultPlan, ServeEngine

    t_phase = time.perf_counter()
    if engine is None:
        engine = ServeEngine(_serve_config())
        engine.warmup()
    require(engine.pipeline_desc == "depth2", f"the serving engine is {engine.pipeline_desc}")
    state = engine.model.state_dict()
    reqs = _serve_requests()
    equal = _pipelined_against_serial(state, reqs)

    serial = ServeEngine(_serve_config(pipeline_depth=0), state_dict=state)
    serial.warmup()
    residues = sum(SERVE_REQUEST_LENGTHS)
    runs = {}
    for label in SERVE_ASYNC_TURNS:
        eng = serial if label == "serial" else engine
        eng.tracer = Tracer(enabled=True)  # the stages' host spans of this run
        torch.cuda.synchronize()
        read = _serve_counts()
        t0 = time.perf_counter()
        out = eng.predict_many(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read()
        _require_hopper(counts, f"{label} serving")
        for r in out:
            require(r.ok and bool(np.isfinite(r.atom14).all()),
                    f"{label}: a request of {len(r.seq)} residues failed: {r.error}")
        if eng is engine:
            atom14 = [r.atom14 for r in out]
        runs.setdefault(label, []).append({
            "wall_s": wall, "residues_per_s": residues / wall, "launches": counts,
            "spans_ms": {k: round(v["total_s"] * 1e3, 3)
                         for k, v in eng.tracer.span_totals().items()}})
        eng.tracer = Tracer(enabled=False)
    profiled = {}
    for label, eng in (("serial", serial), ("pipelined", engine)):
        profiled[label] = prof = _idle_share(lambda eng=eng: eng.predict_many(reqs))
        spans = {k: round(sum(r["spans_ms"].get(k, 0.0) for r in runs[label]) / len(runs[label]), 1)
                 for k in ("serve.featurize", "serve.device_put", "serve.get_executable",
                           "serve.dispatch", "serve.device_get", "serve.unpad")}
        log(f"[serve_async] {label}: residues/s "
            + " / ".join(f"{r['residues_per_s']:.2f}" for r in runs[label])
            + f" ({residues} residues, 12 requests, 5 batches); host span ms a run (mean): "
            + json.dumps(spans) + f"; profiled: wall {prof['wall_ms']:.1f} ms, device "
            + ("busy not measured (no device activity recorded)" if prof["busy_ms"] is None
               else f"busy {prof['busy_ms']:.1f} ms, idle {prof['idle']:.1%}")
            + f"; CUDA runtime calls {json.dumps(prof['runtime'], sort_keys=True)}")
    # the pipelined forward reads nothing from the host: no stream synchronize
    # in its run (the serial path's blocking copies show as some), where the
    # profiler saw the device thread's launches at all
    launched = lambda p: sum(p["runtime"].get(k, 0) for k in RUNTIME_CALLS[:4])  # noqa: E731
    if launched(profiled["pipelined"]) >= launched(profiled["serial"]) // 2 > 0:
        require(profiled["pipelined"]["runtime"].get("cudaStreamSynchronize", 0) == 0,
                "the pipelined run synchronized a stream (a host read or a blocking copy)")
    else:
        log("[serve_async] the profiler saw no launches of the device thread: the stream "
            "synchronize check is not measured")
    for label in profiled:
        runs[label][0]["profiled"] = profiled[label]
    serial_req_per_s = 12 / max(r["wall_s"] for r in runs["serial"])
    serial.close()
    del serial
    _free()

    # the open-loop burst, on a fresh engine with a tracer
    tracer = Tracer(enabled=True)
    plan = FaultPlan(fail_bucket=BURST_FAULT_BUCKET, times=1, fail_stage="compute")
    burst_engine = ServeEngine(_serve_config(), state_dict=state, tracer=tracer, faults=plan)
    burst_engine.warmup()
    rng = np.random.default_rng(19)
    # every bucket but the deadline request's (96)
    pool = np.r_[np.arange(50, 65), np.arange(97, 257)]
    order, kinds = _burst(rng, pool)
    rate = SERVE_ASYNC_LOAD * serial_req_per_s
    arrivals = np.cumsum(rng.exponential(1.0 / rate, SERVE_ASYNC_BURST))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read = _serve_counts()
    fe = AsyncServeFrontend(burst_engine)
    t0 = time.perf_counter()
    handles = []
    try:
        for t, req in zip(arrivals, order):
            time.sleep(max(0.0, t0 + t - time.perf_counter()))
            handles.append(fe.submit(req))
        results = [h.result(600) for h in handles]
        wall = time.perf_counter() - t0
    finally:
        fe.close()
    counts = read()
    peak = torch.cuda.max_memory_allocated()
    _require_hopper(counts, "the burst")
    for r, kind in zip(results, kinds):
        want = "deadline_exceeded" if kind == "deadline" else "ok"
        require(r.status == want, f"burst {kind} of {len(r.seq)} residues: {r.status} "
                f"({r.error}), not {want}")
        if r.ok:
            require(bool(np.isfinite(r.atom14).all()), "burst: non-finite atom14")
        if kind == "repeat":
            require(r.cache_hit, "a repeated request was neither a cache hit nor deduped")
        if kind == "mutant":
            require(r.feat_reuse == "delta", f"a mutant was featurized {r.feat_reuse!r}, "
                    "not from its parent")
    retried = [r for r in results if r.retried]
    require(plan.fired and retried and all(r.ok for r in retried),
            f"the injected fault ({plan.fired}) gave no retried ok results")
    stats = burst_engine.stats()
    ledger = sum(stats.get(f"serve.feat_{k}", 0) for k in ("hits", "delta", "misses"))
    dispatched = stats.get("sched.batched_requests", 0) + stats.get("sched.retries", 0)
    require(ledger == dispatched, f"feature ledger {ledger} != dispatched requests {dispatched}")
    served = [r for r in results if r.ok and not r.cache_hit]
    rate_res = sum(len(r.seq) for r in served) / wall
    hist = burst_engine.histogram_snapshots(1e3)
    lat = hist["latency_s"]
    spans = {k: {"count": v["count"], "total_ms": round(v["total_s"] * 1e3, 3)}
             for k, v in tracer.span_totals().items() if k.startswith("serve.")}
    log(f"[serve_async] burst: {SERVE_ASYNC_BURST} requests at a Poisson rate of "
        f"{rate:.3f}/s ({SERVE_ASYNC_LOAD} x the serial {serial_req_per_s:.3f}/s) in "
        f"{wall:.3f} s: {rate_res:.2f} residues/s over {len(served)} dispatched results; "
        f"latency ms (engine histogram) p50 {lat.get('p50')} p95 {lat.get('p95')} p99 "
        f"{lat.get('p99')} (count {lat.get('count')}); peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"[serve_async] burst statuses: "
        + ", ".join(f"{s} {sum(r.status == s for r in results)}"
                    for s in sorted({r.status for r in results}))
        + f"; cache hits {sum(r.cache_hit for r in results)}, retried {len(retried)}, "
        f"feat_reuse {dict(Counter(str(r.feat_reuse) for r in results))}; fault {plan.fired}")
    log(f"[serve_async] burst counters: {json.dumps(stats, sort_keys=True)}")
    log(f"[serve_async] burst span totals: {json.dumps(spans, sort_keys=True)}")
    log(f"[serve_async] burst launches: {counts}")
    burst_engine.close()
    engine.close()
    del burst_engine
    _free()
    log(f"[serve_async] phase: {time.perf_counter() - t_phase:.1f} s")
    return {"equal": equal, "runs": runs, "burst": {
        "launches": counts, "wall_s": wall, "residues_per_s": rate_res, "latency_ms": lat,
        "peak_bytes": peak, "counters": stats, "spans": spans, "rate_per_s": rate},
        "state": state, "serial_req_per_s": serial_req_per_s, "atom14": atom14}


# ------------------------------------------------------------------ the fleet


FLEET_REPLICAS = 2
FLEET_STREAM = 20  # requests of the open-loop stream
FLEET_REPEATS = 2  # of them, exact (sequence, seed) repeats of earlier ones (10%)
FLEET_LOAD = 1.5  # the stream's Poisson rate over the serial request rate
FLEET_KILL_AT = 0.4  # the drill kills replica 1 at this share of the 2-replica run's wall
FLEET_DEGRADE_S = 0.05  # the degrade drill's delay a dispatch on replica 1
FLEET_POOL = tuple(range(50, 65)) + tuple(range(97, 257))  # the burst's pool: every bucket but 96
FLEET_BATCH_LENGTHS = (110, 128, 121, 99)  # the concurrent batch: bucket 128, 4 requests
FLEET_FAULT_LENGTHS = (60, 55, 58, 51)  # the flight recorder's faulted bucket-64 batch
FLEET_WATCH_SHORT_S = 2.0  # the replay stage's deadline, shorter than its run
FLEET_WATCH_S = 900.0  # every other stage's
FLEET_SCRAPE_S = 0.5  # /metrics and /healthz scrape period during the 2-replica run
FLEET_TRACE_BOUND = 0.99  # trace completeness across the router hop, kill included


def _fleet_stream(rate):
    """The stream's (sequence, seed) list and Poisson arrival offsets: 43
    chains from the burst's length pool (FLEET_POOL), seeds 2000+, and
    FLEET_REPEATS exact repeats of earlier entries."""
    import numpy as np

    rng = np.random.default_rng(20)
    alphabet = list("ACDEFGHIKLMNPQRSTVWY")
    spec = [("".join(rng.choice(alphabet, int(n))), 2000 + i)
            for i, n in enumerate(rng.choice(FLEET_POOL, FLEET_STREAM - FLEET_REPEATS))]
    for _ in range(FLEET_REPEATS):
        at = int(rng.integers(1, len(spec) + 1))
        spec.insert(at, spec[int(rng.integers(0, at))])
    return spec, np.cumsum(rng.exponential(1.0 / rate, FLEET_STREAM))


def _drive_fleet(fleet, spec, offsets, timeout=600.0):
    """Open loop: each (sequence, seed) submitted as a fresh ServeRequest at
    its offset. An unresolved handle is counted, not raised. Returns
    (handles, results with None where unresolved, wall_s, unresolved)."""
    from alphafold2_tpu_torch.serve import ServeRequest

    t0 = time.perf_counter()
    handles = []
    for off, (seq, seed) in zip(offsets, spec):
        time.sleep(max(0.0, t0 + off - time.perf_counter()))
        handles.append(fleet.submit(ServeRequest(seq, seed=seed)))
    results, unresolved = [], 0
    for h in handles:
        try:
            results.append(h.result(timeout=max(1.0, t0 + timeout - time.perf_counter())))
        except TimeoutError:
            unresolved += 1
            results.append(None)
    return handles, results, time.perf_counter() - t0, unresolved


def _device_busy(fn):
    """``fn()`` under torch.profiler with CUDA activity only: ``{"wall_ms",
    "busy_ms", "idle"}``, busy the union of the device's activity intervals
    (None when the profiler recorded none). Reads the profiler's raw events:
    building its event tree for a stream's 100,000+ launches takes longer
    than the stream."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA and e.end_ns() > e.start_ns())
    if not spans:
        return {"wall_ms": wall_ms, "busy_ms": None, "idle": None}
    busy_ns, lo, hi = 0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > hi:
            busy_ns += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy_ms = (busy_ns + hi - lo) / 1e6
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle": max(0.0, 1.0 - busy_ms / wall_ms)}


def _stream_numbers(results, wall):
    """Goodput (residues/s of ok results over the wall) and latency
    quantiles (ms) of a stream's ok results."""
    import numpy as np

    ok = [r for r in results if r is not None and r.ok]
    lat = np.array([r.latency_s for r in ok]) * 1e3
    q = (lambda p: round(float(np.percentile(lat, p)), 3)) if len(ok) else (lambda p: None)
    return {"wall_s": wall, "ok": len(ok), "goodput_res_s": sum(len(r.seq) for r in ok) / wall,
            "p50_ms": q(50), "p95_ms": q(95), "p99_ms": q(99),
            "statuses": {s: sum(r is not None and r.status == s for r in results)
                         for s in sorted({r.status for r in results if r is not None})}}


def _scrape(urls, stop, seen):
    """Scrape every URL each FLEET_SCRAPE_S until ``stop`` is set; keep each
    URL's last body and the scrape count."""
    from urllib.request import urlopen

    while True:
        for url in urls:
            with urlopen(url, timeout=10) as resp:
                seen[url] = (resp.status, resp.read().decode())
            seen["count"] = seen.get("count", 0) + 1
        if stop.wait(FLEET_SCRAPE_S):
            return


def _fleet_flops_config():
    """The tiny serving configuration of tests/test_torch_port_flops.py (dim
    32, depth 1, heads 2, dim_head 16, f32, tied rows, buckets 8 and 16 at
    batch 2, MSA 2, 10 MDS iterations), unpipelined."""
    from alphafold2_tpu_torch.config import Config, DataConfig, ModelConfig, ServeConfig

    return Config(model=ModelConfig(dim=32, depth=1, heads=2, dim_head=16, max_seq_len=48,
                                    bfloat16=False, msa_tie_row_attn=True),
                  data=DataConfig(msa_depth=2),
                  serve=ServeConfig(buckets=(8, 16), max_batch=2, mds_iters=10,
                                    pipeline_depth=0))


def phase_serve_fleet(state=None, serial_req_per_s=None, reference=None):
    """The multi-replica fleet on the card (log tag ``[serve_fleet]``), on
    serve_async's configuration and weights (``state``; built from the seed
    when the phase runs alone), 2 replicas sharing one parameter set on
    the one card: (a) the twelve requests through the fleet against
    serve_async's pipelined engine's atom14 (``reference``; replica 0 alone
    when the phase runs alone) within 1e-3 A, both replicas served, replica 1's parameters
    replica 0's; (b) one batch on both replicas' device threads at once,
    bit-equal to one alone with exactly twice its K1/K2 launches; (c) a
    seeded Poisson stream at FLEET_LOAD x the serial request rate through a
    1-replica and the 2-replica fleet (goodput, latency quantiles, device
    idle share with the profiler on, peak memory; /metrics and /healthz
    scraped, the SLO monitors' verdicts); (d) the stream again with replica
    1 degraded, then with replica 1 killed mid-run (nothing unresolved, a
    drain, trace completeness across the hop); (e) a flight-recorder dump
    of a faulted dispatch, the recorded stream replayed to the same
    statuses, a liveness watchdog over every stage; (f) flops shares,
    compile records, the card's count of a tiny key equal to the CPU's, the
    stream's MFU; (g) every K1/K2 launch on its Hopper kernel."""
    import tempfile
    import threading
    from collections import Counter

    import numpy as np
    import torch

    from alphafold2_tpu_torch.observe import FlightRecorder, Tracer, flightrec
    from alphafold2_tpu_torch.observe.exposition import MetricsHTTPServer
    from alphafold2_tpu_torch.observe.flops import mesh_mfu
    from alphafold2_tpu_torch.observe.slo import default_serve_slos
    from alphafold2_tpu_torch.observe.tracectx import trace_completeness
    from alphafold2_tpu_torch.observe.watchdog import LivenessWatchdog, probe_backend
    from alphafold2_tpu_torch.observe.workload import (
        WorkloadRecorder, build_replay, load_workload, replayable_reason)
    from alphafold2_tpu_torch.serve import (
        FaultPlan, FleetFaultPlan, FleetFrontend, ServeEngine, ServeRequest, bucket_for)
    from alphafold2_tpu_torch.serve.fleet import fleet_counter_zeros

    t_phase = time.perf_counter()
    laps = [t_phase]

    def lap():
        """Seconds since the last lap: each part's log line ends with its time."""
        laps.append(time.perf_counter())
        return laps[-1] - laps[-2]

    card = _card()
    stage = {"name": "serve_fleet:build"}
    probes, dead = [], []

    def probe():
        name = stage["name"]
        alive, why = probe_backend(timeout=120)
        probes.append({"stage": name, "alive": alive, "probe": why})
        return alive, why

    deadlines = {name: FLEET_WATCH_S for name in (
        "build", "parity", "concurrency", "one_replica", "two_replicas", "kill", "degrade",
        "flight_recorder", "flops")}
    deadlines["replay"] = FLEET_WATCH_SHORT_S
    watch = LivenessWatchdog(lambda: stage["name"], deadlines, on_dead=dead.append, probe=probe,
                             poll_s=0.25).start()
    work = tempfile.mkdtemp(prefix="af2_fleet_")
    cfg = _serve_config()
    slo_specs = default_serve_slos()
    out = {"card": card}
    opened = []  # every fleet and exporter, stopped again on the way out
    try:
        # ---- (a) parity: FleetFrontend.build aliases replica 0's module
        t0 = time.perf_counter()
        fleet = FleetFrontend.build(cfg, FLEET_REPLICAS, state_dict=state)
        opened.append(fleet)
        e0, e1 = (c.engine for c in fleet.cells)
        for eng in (e0, e1):
            eng.warmup()
        torch.cuda.synchronize()
        log(f"[serve_fleet] {FLEET_REPLICAS} replicas built and warmed in "
            f"{time.perf_counter() - t0:.1f} s; {card}")
        require(e1.model is e0.model and all(
            a.data_ptr() == b.data_ptr() for a, b in zip(e0.model.parameters(),
                                                        e1.model.parameters())),
                "replica 1 holds its own parameters, not replica 0's")
        stage["name"] = "serve_fleet:parity"
        reqs = _serve_requests()
        if reference is None:  # the phase alone: replica 0's engine is the reference
            reference = [r.atom14 for r in e0.predict_many(reqs)]
        if serial_req_per_s is None:
            serial = ServeEngine(_serve_config(pipeline_depth=0), model=e0.model)
            serial.warmup()
            t0 = time.perf_counter()
            serial.predict_many([ServeRequest(r.seq, seed=r.seed) for r in reqs])
            serial_req_per_s = len(reqs) / (time.perf_counter() - t0)
            serial.close()
        read = _serve_counts()
        results = [h.result(600) for h in [fleet.submit(ServeRequest(r.seq, seed=r.seed))
                                           for r in reqs]]
        _require_hopper(read(), "fleet parity")
        diff = 0.0
        for r, ref in zip(results, reference):
            require(r.ok and r.atom14.shape == ref.shape and bool(np.isfinite(r.atom14).all()),
                    f"fleet: a request of {len(r.seq)} residues failed: {r.error}")
            diff = max(diff, float(np.abs(r.atom14 - ref).max()))
        routed = [fleet.stats().get(f"fleet.replica{i}.routed", 0) for i in range(FLEET_REPLICAS)]
        log(f"[serve_fleet] parity: the twelve requests through the fleet, routed {routed}; "
            f"max |d atom14| against one engine {diff:.3e} A (tol 1e-3 A); replica 1's "
            f"{sum(1 for _ in e1.model.parameters())} parameter tensors are replica 0's "
            f"[{lap():.1f} s with the build]")
        require(diff <= 1e-3, "the fleet and one engine disagree")
        require(all(n > 0 for n in routed), f"a replica received no work ({routed})")
        fleet.close()
        out["parity"] = {"max_abs_diff": diff, "routed": routed}

        # ---- (b) one batch on both device threads at once
        stage["name"] = "serve_fleet:concurrency"
        rng = np.random.default_rng(21)
        alphabet = list("ACDEFGHIKLMNPQRSTVWY")
        seqs = ["".join(rng.choice(alphabet, n)) for n in FLEET_BATCH_LENGTHS]
        batch = lambda: [ServeRequest(q, seed=3000 + i) for i, q in enumerate(seqs)]  # noqa: E731
        bucket = bucket_for(max(FLEET_BATCH_LENGTHS), cfg.serve.buckets)
        read = _serve_counts()
        alone = e0.dispatch_batch_async(bucket, batch()).result(600)
        one = read()
        _require_hopper(one, "one replica's batch")
        spans = Tracer(enabled=True)
        e0.tracer = e1.tracer = spans
        read = _serve_counts()
        handles = [e0.dispatch_batch_async(bucket, batch()),
                   e1.dispatch_batch_async(bucket, batch())]
        both = [h.result(600) for h in handles]
        two = read()
        e0.tracer = e1.tracer = Tracer(enabled=False)
        _require_hopper(two, "the concurrent batch")
        windows = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans.events()
                         if e["name"] == "serve.dispatch" and e.get("ph") == "X")
        require(len(windows) == 2, f"{len(windows)} device-stage forwards, not 2")
        overlap_ms = (min(w[1] for w in windows) - max(w[0] for w in windows)) / 1e3
        equal = all(a.ok and b.ok and a.atom14.tobytes() == b.atom14.tobytes()
                    and a.weights.tobytes() == b.weights.tobytes()
                    for res in both for a, b in zip(res, alone))
        keys = ("fused_attention", "fused_attention_combine", "tied_row_attention",
                "fused_attention_sm90", "fused_attention_packed", "tied_row_attention_sm90")
        log(f"[serve_fleet] concurrency: one bucket-{bucket} batch of 4 on both replicas' device "
            f"threads, forwards overlapping {overlap_ms:.1f} ms; atom14 and weights bit-equal "
            f"to replica 0 alone: {equal}; launches alone {[one[k] for k in keys]}, both "
            f"{[two[k] for k in keys]} ({', '.join(keys)}) [{lap():.1f} s]")
        require(overlap_ms > 0, "the two replicas' forwards did not run at the same time")
        require(equal, "concurrent forwards differ from one alone")
        require(all(two[k] == 2 * one[k] for k in keys) and one["fused_attention"] > 0,
                "concurrent launch counts are not exactly twice one replica's")
        out["concurrency"] = {"overlap_ms": overlap_ms, "one": one, "two": two}

        # ---- (c) scaling: the stream through 1 and 2 replicas
        rate = FLEET_LOAD * serial_req_per_s
        spec, offsets = _fleet_stream(rate)
        log(f"[serve_fleet] stream: {FLEET_STREAM} requests ({FLEET_REPEATS} exact repeats) at "
            f"a Poisson rate of {rate:.3f}/s ({FLEET_LOAD} x the serial {serial_req_per_s:.3f}/s); "
            f"prediction, 2 over 1 replica goodput: 0.9-1.4x")
        runs, ok_costs = {}, []
        recorder = WorkloadRecorder(os.path.join(work, "workload.jsonl"), record_raw=True,
                                    buckets=e0.buckets, msa_depth=e0.msa_depth)
        for n, engines in ((1, [e0]), (2, [e0, e1])):
            stage["name"] = "serve_fleet:" + ("one_replica" if n == 1 else "two_replicas")
            fl = FleetFrontend(engines, tracer=Tracer(enabled=True), slo_specs=slo_specs,
                               metrics_ports=[0] * n)
            opened.append(fl)
            if n == 1:
                fl.cells[0].frontend.add_submit_observer(recorder.on_submit)
                fl.cells[0].frontend.add_observer(recorder.observe)
            exporter = MetricsHTTPServer(
                lambda fl=fl, n=n: {**fleet_counter_zeros(n), **fl.snapshot()}, port=0).start()
            opened.append(exporter)
            urls = [f"http://127.0.0.1:{exporter.port}/metrics"] + [
                f"http://127.0.0.1:{c.metrics.port}/{p}" for c in fl.cells
                for p in ("metrics", "healthz")]
            seen, stop = {}, threading.Event()
            scraper = threading.Thread(target=_scrape, args=(urls, stop, seen), daemon=True)
            flops0 = sum(e.executed_flops for e in engines)
            slots0 = [sum(e.counters.get(k) for e in engines)
                      for k in ("serve.batches", "serve.padded_slots")]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            read = _serve_counts()
            box = {}
            scraper.start()
            prof = _device_busy(lambda: box.update(zip(
                ("handles", "results", "wall", "unresolved"), _drive_fleet(fl, spec, offsets))))
            stop.set()
            scraper.join(30)
            counts = read()
            peak = torch.cuda.max_memory_allocated()
            _require_hopper(counts, f"the {n}-replica stream")
            nums = _stream_numbers(box["results"], box["wall"])
            flops = sum(e.executed_flops for e in engines) - flops0
            batches, padded = (sum(e.counters.get(k) for e in engines) - v0 for k, v0 in zip(
                ("serve.batches", "serve.padded_slots"), slots0))
            occupancy = 1.0 - padded / max(1, batches * cfg.serve.max_batch)
            mfu = mesh_mfu(flops, box["wall"])
            slo = fl.slo_summary()
            stats = fl.stats()
            exporter.stop()
            fl.close()
            require(box["unresolved"] == 0 and nums["ok"] == FLEET_STREAM,
                    f"{n}-replica stream: {nums['statuses']}, {box['unresolved']} unresolved")
            for r in box["results"]:
                require(bool(np.isfinite(r.atom14).all()), "fleet stream: non-finite atom14")
                ok_costs.append(r.cost["flops_share"])
            require(seen.get("count", 0) >= len(urls) and all(
                seen[u][0] == 200 for u in urls), f"scrapes: {seen.get('count')}")
            fleet_text = seen[urls[0]][1]
            missing = [k for k in fleet_counter_zeros(n)
                       if "af2tpu_" + k.replace(".", "_") + " " not in fleet_text]
            require(not missing, f"/metrics lacks the zero-seeded {missing}")
            require(all("af2tpu_sched_depth " in seen[u][1] for u in urls[1::2]),
                    "a replica's /metrics lacks sched.depth")
            require(all(json.loads(seen[u][1])["ok"] for u in urls[2::2]), "a /healthz said no")
            runs[n] = dict(nums, idle=prof["idle"], busy_ms=prof["busy_ms"],
                           profiled_wall_ms=prof["wall_ms"], peak_bytes=peak, launches=counts,
                           flops=flops, mfu=mfu, slo=slo["fleet"], batches=batches,
                           occupancy=occupancy, routed=[
                               stats.get(f"fleet.replica{i}.routed", 0) for i in range(n)],
                           scrapes=seen["count"])
            log(f"[serve_fleet] {n} replica(s): goodput {nums['goodput_res_s']:.2f} residues/s "
                f"({nums['ok']} ok in {box['wall']:.3f} s); latency ms p50 {nums['p50_ms']} "
                f"p95 {nums['p95_ms']} p99 {nums['p99_ms']}; device "
                + ("busy not measured" if prof["busy_ms"] is None else
                   f"busy {prof['busy_ms']:.1f} of {prof['wall_ms']:.1f} ms, idle "
                   f"{prof['idle']:.1%}") + f" (profiler on); peak memory {peak / 2**30:.2f} GiB; "
                f"routed {runs[n]['routed']}; {batches} batches at occupancy {occupancy:.3f}; "
                f"K1 {counts['fused_attention']} (packed "
                f"{counts['fused_attention_packed']}), K2 {counts['tied_row_attention']}; "
                f"{seen['count']} scrapes of {len(urls)} URLs; MFU {mfu} of {flops:.4e} flops "
                f"[{lap():.1f} s, the profiler's processing included]")
            log(f"[serve_fleet] {n} replica(s): SLO verdicts per replica "
                + json.dumps([[(v['spec'], v['fast_burn'], v['alert']) for v in rep]
                              for rep in slo["replicas"]])
                + "; fleet " + json.dumps([(v["spec"], v["fast_burn"], v["fast_events"],
                                            v["alert"]) for v in slo["fleet"]]))
        recorder.close()
        ratio = runs[2]["goodput_res_s"] / runs[1]["goodput_res_s"]
        log(f"[serve_fleet] 2 over 1 replica goodput: {ratio:.3f}x (predicted 0.9-1.4x; no "
            f"threshold); {card}")
        out.update(runs=runs, ratio=ratio, rate_per_s=rate)

        # ---- (d) a degraded replica, then the death drill
        stage["name"] = "serve_fleet:degrade"
        degrade = FleetFaultPlan(replica=1, degrade_s=FLEET_DEGRADE_S)
        fl = FleetFrontend([e0, e1], tracer=Tracer(enabled=True), fault=degrade)
        opened.append(fl)
        read = _serve_counts()
        _, results, wall, unresolved = _drive_fleet(fl, spec, offsets)
        _require_hopper(read(), "the degrade drill")
        stats = fl.stats()
        fl.close()
        e1.faults = None  # the drill's delay plan stays on the engine
        nums = _stream_numbers(results, wall)
        routed = [stats.get(f"fleet.replica{i}.routed", 0) for i in range(2)]
        log(f"[serve_fleet] degrade drill: replica 1 slowed {FLEET_DEGRADE_S} s a dispatch "
            f"from {degrade.fired}; routed {routed} (replica 0, replica 1); statuses "
            f"{nums['statuses']}; goodput {nums['goodput_res_s']:.2f} residues/s; latency ms "
            f"p50 {nums['p50_ms']} p95 {nums['p95_ms']} [{lap():.1f} s]")
        require(degrade.fired and unresolved == 0 and nums["ok"] == FLEET_STREAM,
                f"the degrade drill: {nums['statuses']}, {unresolved} unresolved")
        out["degrade"] = dict(nums, routed=routed)
        stage["name"] = "serve_fleet:kill"
        kill = FleetFaultPlan(replica=1, at_s=FLEET_KILL_AT * runs[2]["wall_s"])
        fl = FleetFrontend([e0, e1], tracer=Tracer(enabled=True), fault=kill)
        opened.append(fl)
        read = _serve_counts()
        handles, results, wall, unresolved = _drive_fleet(fl, spec, offsets)
        _require_hopper(read(), "the kill drill")
        stats = fl.stats()
        done = trace_completeness(fl.tracer.events(), [h.request.trace.trace_id for h in handles])
        fl.close()
        nums = _stream_numbers(results, wall)
        terminal = ("ok", "error", "rejected", "deadline_exceeded")
        log(f"[serve_fleet] kill drill: replica 1 killed at {kill.fired} ({FLEET_KILL_AT} of "
            f"the 2-replica wall); {unresolved} accepted requests unresolved; statuses "
            f"{nums['statuses']}; drains {stats.get('fleet.drains', 0)}, rerouted "
            f"{stats.get('fleet.rerouted', 0)}, routed "
            f"{[stats.get(f'fleet.replica{i}.routed', 0) for i in range(2)]}; trace "
            f"completeness {done['fraction']:.4f} ({done['complete']} of {done['total']}); "
            f"goodput {nums['goodput_res_s']:.2f} residues/s [{lap():.1f} s]")
        require(kill.fired and stats.get("fleet.drains", 0) >= 1, "the kill never drained")
        require(unresolved == 0 and all(r is not None and r.status in terminal
                                        for r in results), "an accepted request never resolved")
        require(not any(r.error == "stolen by fleet router" or r.error == "frontend closed"
                        for r in results), "a reroute leaked to a caller")
        require(done["fraction"] >= FLEET_TRACE_BOUND, f"trace completeness {done['fraction']}")
        out["kill"] = dict(nums, unresolved=unresolved, drains=stats.get("fleet.drains", 0),
                           rerouted=stats.get("fleet.rerouted", 0),
                           trace_fraction=done["fraction"])

        # ---- (e) the flight recorder on a faulted dispatch, then the replay
        stage["name"] = "serve_fleet:flight_recorder"
        before = flightrec.active()
        rec = flightrec.install(FlightRecorder(directory=os.path.join(work, "incidents")))
        os.environ["AF2TPU_FLEET_SMOKE_TOKEN"] = "not-for-an-incident-file"
        e0.faults = FaultPlan(fail_bucket=BURST_FAULT_BUCKET, times=1, fail_stage="compute")
        fl = FleetFrontend([e0], tracer=Tracer(enabled=True))
        opened.append(fl)
        rec.attach(fl.tracer)
        try:
            faulted = [fl.submit(ServeRequest("".join(rng.choice(alphabet, n)), seed=4000 + i))
                       for i, n in enumerate(FLEET_FAULT_LENGTHS)]
            fres = [h.result(600) for h in faulted]
        finally:
            fl.close()
            e0.faults = None
            flightrec.install(before)
            del os.environ["AF2TPU_FLEET_SMOKE_TOKEN"]
        dumps = sorted(os.listdir(os.path.join(work, "incidents")))
        require(len(dumps) == 1, f"{len(dumps)} incident files, not 1")
        with open(os.path.join(work, "incidents", dumps[0])) as f:
            doc = json.load(f)
        notes = [n for n in doc["notes"] if n["kind"] == "dispatch_error"]
        ids = sorted(h.request.trace.trace_id for h in faulted)
        log(f"[serve_fleet] flight recorder: {dumps[0]}: reason {doc['reason']}, "
            f"{len(notes)} dispatch_error note (bucket {notes[0]['bucket'] if notes else None}, "
            f"{notes[0]['error'] if notes else None}), {len(doc['events'])} events, env "
            f"{len(doc['env'])} keys scrubbed; the faulted batch retried: "
            f"{[(r.status, r.retried, r.bucket) for r in fres]} [{lap():.1f} s]")
        require(doc["reason"] == "dispatch_error" and len(notes) == 1
                and sorted(notes[0]["trace_ids"]) == ids, "the dump lacks the batch's note")
        require(doc["env"].get("AF2TPU_FLEET_SMOKE_TOKEN") == "[redacted]",
                "the dump's env is not scrubbed")
        require(all(r.ok and r.retried for r in fres), "the faulted batch was not retried ok")
        stage["name"] = "serve_fleet:replay"
        log_ = load_workload(recorder.path)
        require(replayable_reason(log_["submits"]) is None, replayable_reason(log_["submits"]))
        pairs = build_replay(log_["submits"])
        require([(r.seq, r.seed) for _, r in pairs] == spec
                and [t for t, _ in pairs] == [ev["t"] for ev in log_["submits"]],
                "build_replay did not give back the recorded requests and offsets")
        drift = float(np.abs(np.array([t for t, _ in pairs]) - (offsets - offsets[0])).max())
        recorded = {ev["trace"]: ev["status"] for ev in log_["resolves"]}
        want = [recorded.get(ev["trace"]) for ev in log_["submits"]]
        fl = FleetFrontend([e0], tracer=Tracer(enabled=True))
        opened.append(fl)
        read = _serve_counts()
        _, replayed, wall, unresolved = _drive_fleet(fl, [(r.seq, r.seed) for _, r in pairs],
                                                     [t for t, _ in pairs])
        _require_hopper(read(), "the replay")
        fl.close()
        got = [r.status if r is not None else None for r in replayed]
        log(f"[serve_fleet] workload: {len(log_['submits'])} submits and "
            f"{len(log_['resolves'])} resolves recorded; replay offsets within {drift * 1e3:.1f} "
            f"ms of the planned arrivals; replayed through 1 replica in {wall:.3f} s: statuses "
            f"equal to the recording: {got == want} ({dict(Counter(got))}) [{lap():.1f} s]")
        require(unresolved == 0 and got == want, "the replay's statuses differ from the recording")
        stage["name"] = "serve_fleet:flops"
        watch.stop()
        watch._thread.join(150)  # a probe in flight finishes; its process ends
        out["watchdog"] = {"probes": probes, "dead": dead}
        log(f"[serve_fleet] watchdog: {len(probes)} probes of the card "
            f"({[(p['stage'], p['alive']) for p in probes]}), fired dead: {bool(dead)}")
        require(not dead and watch.fired is None, f"the watchdog fired dead: {dead}")
        require(any(p["stage"] == "serve_fleet:replay" and p["alive"] for p in probes),
                "the replay stage's short deadline never probed alive")

        # ---- (f) flops
        require(ok_costs and all(c > 0 for c in ok_costs), "an ok result has no flops_share")
        for rec_ in e0.compile_records:
            require(rec_.get("flops", 0) > 0 and "flops_breakdown" in rec_,
                    f"compile record {rec_['bucket']}x{rec_['batch']} lacks its flops")
        log("[serve_fleet] compile records (flops, peak bytes): " + json.dumps(
            {f"{r['bucket']}x{r['batch']}": [r["flops"], r.get("peak_bytes")]
             for r in e0.compile_records}))
        tiny = {}
        for dev in ("cuda", "cpu"):
            eng = ServeEngine(_fleet_flops_config(), device=dev)
            eng.warmup()
            tiny[dev] = {(r["bucket"], r["batch"]): r["flops"] for r in eng.compile_records}
            eng.close()
        log(f"[serve_fleet] the tiny configuration's counted flops a key, card "
            f"{tiny['cuda']}, CPU {tiny['cpu']} [{lap():.1f} s]")
        require(tiny["cuda"] == tiny["cpu"], "the card's count differs from the CPU's")
        mfu = runs[2]["mfu"]
        require(mfu.get("mfu_basis") == "published-peak", f"MFU basis {mfu}")
        log(f"[serve_fleet] the 2-replica stream's MFU {mfu['mfu']:.4%} ({runs[2]['flops']:.4e} "
            f"flops in {runs[2]['wall_s']:.3f} s, {mfu['mfu_basis']}); {card}")
        out["tiny_flops"] = {f"{b}x{n}": f for (b, n), f in tiny["cuda"].items()}
    finally:
        watch.stop()
        for thing in opened:
            if isinstance(thing, FleetFrontend):
                thing.close()
            else:
                thing.stop()
    e0.close()
    del e0
    _free()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[serve_fleet] phase: {out['phase_s']:.1f} s")
    return out


# --------------------------------------------------------------- KV compression

COMPRESS_LABEL = "compressed pair<-MSA cross (1x8, 262144x342, d64)"
COMPRESS_SHAPE = (1, 8, 512 * 512, -(-8 * 128 // 3), 64)  # (B, H, Nq, Nk, D)
COMPRESS_STEPS = 2  # config_3 steps through train.loop.train


def _config3(small=False):
    """scripts/bench_suite.py config_3 at its full width: dim 256, depth
    12, heads 8, dim_head 64, crop 512, MSA 8x128, batch 1, block-sparse
    pair attention on every other layer (from the first), KV compression 3,
    remat, bf16 compute (numerics off, as bench_suite's step). ``small``: an
    f32 model of the same structure at dim 32, depth 2, crop 32."""
    from alphafold2_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig

    if small:
        model = ModelConfig(dim=32, depth=2, heads=2, dim_head=32, max_seq_len=32,
                            remat=True, bfloat16=False, cross_attn_compress_ratio=3)
        data = DataConfig(crop_len=32, msa_depth=3, msa_len=20, batch_size=1,
                          min_len_filter=16)
    else:
        model = ModelConfig(dim=256, depth=12, heads=8, dim_head=64, max_seq_len=512,
                            remat=True, bfloat16=True, cross_attn_compress_ratio=3)
        data = DataConfig(crop_len=512, msa_depth=8, msa_len=128, batch_size=1,
                          min_len_filter=512)
    model.sparse_self_attn = (True, False) * (model.depth // 2)
    return Config(model=model, data=data,
                  train=TrainConfig(gradient_accumulate_every=1, warmup_steps=10,
                                    numerics="off", log_every=1))


def _config3_expected(depth=12):
    """Launches a config_3 step: a dense layer runs K1 on its 6 passes, a
    sparse one on its 4 MSA and cross passes and K4 (with lse) on its 2
    pair axial passes; remat runs each layer's forward twice; every pass
    runs its backward but the last layer's MSA<-pair update."""
    k1 = 6 * (depth // 2) + 4 * (depth // 2)
    return {"fused_attention": 2 * k1, "fused_attention_bwd_dq": k1 - 1,
            "fused_attention_bwd_dkv": k1 - 1, "block_sparse_attention": 2 * depth,
            "block_sparse_attention_bwd_dq": depth, "block_sparse_attention_bwd_dkv": depth}


class _LaunchShapes:
    """Counts K1's and K3's launches by (kernel, Nq, Nk, Hopper kernel ran)
    while installed, wrapping the wrappers' launch functions."""

    def __enter__(self):
        import collections

        from alphafold2_tpu_torch.ops.cuda import axial

        self.axial, self.seen = axial, collections.Counter()
        self.saved = (axial._launch_forward, axial._launch_backward)
        fwd, bwd = self.saved

        def forward(q, k, v, *a, **kw):
            before = axial.fused_attention.sm90_launches
            out = fwd(q, k, v, *a, **kw)
            hopper = axial.fused_attention.sm90_launches - before
            self.seen[("K1", q.shape[2], k.shape[2], hopper)] += 1
            return out

        def backward(which, outs, slots, q, k, v, *a, **kw):
            hopper = bwd(which, outs, slots, q, k, v, *a, **kw)
            self.seen[("K3a" if which == "dq" else "K3b", q.shape[2], k.shape[2], hopper)] += 1
            return hopper

        axial._launch_forward, axial._launch_backward = forward, backward
        return self.seen

    def __exit__(self, *exc):
        self.axial._launch_forward, self.axial._launch_backward = self.saved


def _compress_parity():
    """A small f32 model of config_3's structure (_config3(small=True)):
    one step's loss and every gradient leaf, kv_compress's among them, on
    the card's kernels against the CPU's plain versions."""
    small = _config3(small=True)
    loss, worst, worst_name = _small_step_card_vs_cpu(small)
    rel = abs(loss["kernels"] - loss["plain"]) / abs(loss["plain"])
    log(f"[compress] small f32 model (dim 32, depth 2, crop 32, compression 3, sparse and "
        f"dense layers, remat), card vs CPU: loss relative {rel:.2e} (tol 1e-5), worst "
        f"per-leaf gradient relative L2 {worst:.3e} ({worst_name}; tol {GRAD_REL_L2:g})")
    require(rel <= 1e-5 and worst <= GRAD_REL_L2,
            "the small compressed model disagrees between the card and the CPU")


def _compress_cases():
    """K1, and K1 with lse, K3a and K3b, on config_3's compressed pass
    (COMPRESS_SHAPE, every query and key valid as in its batch) against
    their plain versions, f32 and bf16; bf16 on the Hopper kernels, timed
    beside SDPA."""
    import torch

    b, h, nq, nk, d = COMPRESS_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(16)
    ones = lambda n: torch.ones((b, n), dtype=torch.bool, device="cuda")
    rows = []
    for dtype, reps in ((torch.float32, 0), (torch.bfloat16, 3)):
        rows.append(k1_case(COMPRESS_LABEL, b, h, nq, nk, d, dtype, q_mask=ones(nq),
                            kv_mask=ones(nk), reps=reps, library=bool(reps), gen=gen,
                            serving=True))
        rows += k3_case(COMPRESS_LABEL, b, h, nq, nk, d, dtype, q_mask=ones(nq),
                        kv_mask=ones(nk), reps=reps, library=bool(reps), gen=gen, strided=True)
    for r in rows:
        if "ms" in r:
            log(f"[compress] time {r['kernel']} {r['label']}: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.3f} ms, sdpa {r.get('library_ms')} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of "
                f"the bound)")
    return rows


def phase_compress():
    """KV compression: the small model card vs CPU; K1 and K3 on the
    compressed pass; then config_3 (_config3) through train.loop.train for
    COMPRESS_STEPS steps from launch counts of 0: finite, unskipped,
    launches a step as _config3_expected gives them, every K1, K3, K4 and
    K5 launch on its Hopper kernel (K1 and K3a/K3b at 262144 x 342 among
    them), no plain version; then the step alone (host clock to a
    synchronize) with its peak memory, and one step profiled. Returns the
    result rows and the run's numbers."""
    import numpy as np
    import torch

    from alphafold2_tpu_torch.train import loop

    t_phase = time.perf_counter()
    _compress_parity()
    rows = _compress_cases()
    cfg = _config3()
    plain, kernels = _plain_versions(), _training_kernels()
    losses, oks = [], []
    _reset_counts(kernels, plain)
    t0 = time.perf_counter()
    with _LaunchShapes() as seen:
        state = loop.train(cfg, num_steps=COMPRESS_STEPS, callbacks=[
            lambda i, s, m: (losses.append(float(m["loss"])), oks.append(bool(m["grads_ok"])))])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    skipped = int(state.skipped)
    del state
    per_step = {name: fn.launches / COMPRESS_STEPS for name, fn in kernels.items()
                if fn.launches}
    missed = {name: fn.launches - fn.sm90_launches for name, fn in kernels.items()
              if hasattr(fn, "sm90_launches") and fn.sm90_launches != fn.launches}
    plain_calls = sum(fn.calls for fn in plain)
    _, _, nq, nk, _ = COMPRESS_SHAPE
    compressed = {k: seen[(k, nq, nk, 1)] for k in ("K1", "K3a", "K3b")}
    off_hopper = {key: n for key, n in seen.items() if key[3] != 1}
    expected = _config3_expected(cfg.model.depth)
    off = {name: (per_step.get(name, 0), n) for name, n in expected.items()
           if per_step.get(name, 0) != n}
    log(f"[compress] config_3 (dim 256, depth 12, crop 512, MSA 8x128, sparse every other "
        f"layer, compression 3, remat, bf16): {COMPRESS_STEPS} steps through train.loop.train "
        f"in {wall:.1f} s, losses " + " ".join(f"{x:.4f}" for x in losses)
        + f", skipped {skipped}; launches a step {per_step}; on the compressed pass "
        f"(262144 x 342) over the run {compressed}; launches off their Hopper kernel "
        f"{missed} {off_hopper}; plain-version calls {plain_calls}")
    require(bool(np.isfinite(losses).all()) and all(oks) and skipped == 0,
            "config_3: a non-finite loss or a skipped step")
    require(not missed and not off_hopper, "config_3: a launch missed its Hopper kernel")
    require(plain_calls == 0, "config_3: a plain version ran")
    require(all(n > 0 for n in compressed.values()),
            f"config_3: the compressed pass did not run K1 and K3 on the card {compressed}")
    require(not off, f"config_3: launches a step (measured, expected) {off}")
    _free()
    resident = torch.cuda.memory_allocated()
    fn = _step_fn(cfg, False)
    step_ms, peak = _time_step(fn, 2)
    log(f"[compress] config_3: the step alone {step_ms:.2f} ms ({1e3 / step_ms:.3f} steps/s, "
        f"{512 * 512 / step_ms * 1e3:.0f} pairs/s) over 2 steps, peak device memory "
        f"{peak / 2**20:.1f} MiB ({resident / 2**20:.1f} MiB held before the model)")
    profile_device("one config_3 step", fn, host=True)
    del fn
    _free()
    log(f"[compress] phase: {time.perf_counter() - t_phase:.1f} s")
    return rows, {"launches": per_step, "step_ms": step_ms, "peak_bytes": peak,
                  "losses": losses}


# --------------------------------------------------------------- local data

DATA_STEPS = 3  # distogram steps per data source
DATA_LENGTHS = (96, 121, 128, 150, 183, 230)  # the synthetic structures' residues
LOADER_BATCHES = 50  # batches timed per loader


def _write_structures(root):
    """DATA_LENGTHS synthetic backbones as PDB files, written with the
    port's save_pdb (nothing is downloaded)."""
    import numpy as np

    from alphafold2_tpu_torch.data.pipeline import _smooth_walk, _synthesize_backbone
    from alphafold2_tpu_torch.utils import pdb as pdbio

    rng = np.random.default_rng(5)
    os.makedirs(root)
    for i, n in enumerate(DATA_LENGTHS):
        bb = _synthesize_backbone(rng, _smooth_walk(rng, n)).reshape(n, 3, 3)
        seq = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n))
        pdbio.save_pdb(pdbio.backbone_to_pdb(seq, bb), os.path.join(root, f"chain{i}.pdb"))


def _data_run(label, cfg):
    """DATA_STEPS distogram steps of ``cfg`` through train.loop.train from
    launch counts of 0: finite, unskipped, every launch on its Hopper
    kernel, no plain version. Returns the launches a step."""
    import numpy as np
    import torch

    from alphafold2_tpu_torch.train import loop

    plain, kernels = _plain_versions(), _training_kernels()
    losses, oks = [], []
    _reset_counts(kernels, plain)
    t0 = time.perf_counter()
    state = loop.train(cfg, num_steps=DATA_STEPS, callbacks=[
        lambda i, s, m: (losses.append(float(m["loss"])), oks.append(bool(m["grads_ok"])))])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    skipped = int(state.skipped)
    del state
    per_step = {name: fn.launches / DATA_STEPS for name, fn in kernels.items() if fn.launches}
    missed = {name: fn.launches - fn.sm90_launches for name, fn in kernels.items()
              if hasattr(fn, "sm90_launches") and fn.sm90_launches != fn.launches}
    plain_calls = sum(fn.calls for fn in plain)
    log(f"[data] {label}: {DATA_STEPS} steps in {wall:.2f} s (model build included), losses "
        + " ".join(f"{x:.4f}" for x in losses) + f", skipped {skipped}; launches a step "
        f"{per_step}; off their Hopper kernel {missed}; plain-version calls {plain_calls}")
    require(bool(np.isfinite(losses).all()) and all(oks) and skipped == 0,
            f"{label}: a non-finite loss or a skipped step")
    require(not missed and plain_calls == 0 and per_step.get("fused_attention", 0) > 0,
            f"{label}: a launch off its Hopper kernel or a plain version")
    _free()
    return per_step


def _loader_rate(make):
    """Batches/s over LOADER_BATCHES batches of the iterator ``make()``
    gives (after its first batch), closed afterwards where it closes."""
    it = make()
    try:
        next(it)
        t0 = time.perf_counter()
        for _ in range(LOADER_BATCHES):
            next(it)
        return LOADER_BATCHES / (time.perf_counter() - t0)
    finally:
        if hasattr(it, "close"):
            it.close()


def phase_data():
    """Local real data, evaluation and relaxation on the card: PDB files of
    synthetic backbones through import_pdbs into .npz shards; the
    distogram loop at the training smoke's width (ModelConfig(), crop 128)
    on data.source=npz (checkpointed), native over the shards and native
    synthetic; the native loader's labels against the port's
    get_bucketed_distance_matrix on the card; the loaders' batches/s;
    evaluate --checkpoint --realize over 2 batches (finite metrics, the
    forward's ms); a predicted backbone relaxed through refinement's
    run_native_relax for 200 iterations (the energy must fall, its ms)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from alphafold2_tpu_torch import evaluate, import_pdbs, refinement
    from alphafold2_tpu_torch.config import Config, TrainConfig
    from alphafold2_tpu_torch.data import native
    from alphafold2_tpu_torch.data.pipeline import NpzShardDataset
    from alphafold2_tpu_torch.predict import predict
    from alphafold2_tpu_torch.utils.structure import get_bucketed_distance_matrix

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="af2_data_")
    try:
        pdbs, shards = os.path.join(root, "pdbs"), os.path.join(root, "shards")
        _write_structures(pdbs)
        require(import_pdbs.main([pdbs, shards]) == 0, "import_pdbs failed")
        require(len(os.listdir(shards)) == len(DATA_LENGTHS), "import_pdbs lost a structure")

        def config(source, data_dir, ckpt=None):
            cfg = Config(train=TrainConfig(numerics="off", log_every=1, checkpoint_dir=ckpt))
            cfg.data.source, cfg.data.data_dir = source, data_dir
            return cfg

        ckpt = os.path.join(root, "ckpt")
        npz_cfg = config("npz", shards, ckpt)
        launches = {"npz": _data_run("data.source=npz", npz_cfg),
                    "native shards": _data_run("data.source=native (shards)",
                                               config("native", shards)),
                    "native synthetic": _data_run("data.source=native (synthetic)",
                                                  config("native", None))}

        with native.NativeShardLoader(npz_cfg.data, seed=0) as loader:
            batch = next(loader)
        dev = torch.device("cuda")
        labels = get_bucketed_distance_matrix(torch.from_numpy(batch["coords"]).to(dev),
                                              torch.from_numpy(batch["mask"]).to(dev)).cpu()
        native_labels = torch.from_numpy(batch["labels"])
        differ = native_labels != labels
        worst = int((native_labels - labels)[differ].abs().max()) if differ.any() else 0
        log(f"[data] the native loader's labels against get_bucketed_distance_matrix on the "
            f"card: {int(differ.sum())} of {differ.numel()} differ (by at most {worst} bin)")
        require(float(differ.float().mean()) < 1e-3 and worst <= 1,
                "the native loader's labels disagree with the card's")

        rates = {"native shards": _loader_rate(lambda: native.NativeShardLoader(npz_cfg.data)),
                 "native synthetic": _loader_rate(
                     lambda: native.NativeSyntheticLoader(npz_cfg.data)),
                 "npz (numpy)": _loader_rate(lambda: iter(NpzShardDataset(npz_cfg.data)))}
        log(f"[data] loaders at crop 128, MSA 5x64, batch 1 (2 native workers): "
            + ", ".join(f"{k} {v:.1f} batches/s" for k, v in rates.items()))

        forward_s = []
        result = evaluate.evaluate(npz_cfg, checkpoint=ckpt, batches=2, realize=True,
                                   forward_s=forward_s)
        log(f"[data] evaluate --checkpoint --realize --batches 2: {json.dumps(result)}; "
            f"forward {', '.join(f'{t * 1e3:.2f}' for t in forward_s)} ms a batch")
        require(all(np.isfinite(v) for v in result.values()) and "structure_rmsd" in result,
                "evaluate gave a non-finite metric")

        seq = "".join(np.random.default_rng(12).choice(list("ACDEFGHIKLMNPQRSTVWY"), 128))
        pred = predict(Config(), seq)
        src, out = os.path.join(root, "pred.pdb"), os.path.join(root, "relaxed.pdb")
        from alphafold2_tpu_torch.utils.pdb import save_pdb

        save_pdb(pred.to_pdb(seq), src)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        relaxed = refinement.run_native_relax(src, out, iters=200)
        torch.cuda.synchronize()
        relax_ms = (time.perf_counter() - t0) * 1e3
        e0, e1 = float(relaxed.energy_history[0, 0]), float(relaxed.energy[0])
        log(f"[data] refinement --native on a predicted 128-residue backbone: energy "
            f"{e0:.2f} -> {e1:.2f} over 200 iterations in {relax_ms:.1f} ms")
        require(np.isfinite(e1) and e1 < e0, "relaxation did not lower the energy")
        log(f"[data] phase: {time.perf_counter() - t_phase:.1f} s")
        return {"launches": launches, "loader_batches_per_s": rates,
                "evaluate": result, "forward_ms": [t * 1e3 for t in forward_s],
                "relax_ms": relax_ms, "energy": (e0, e1)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        _free()


# ------------------------------------------------- the kernel switchboard

# the engines of phase_kernel_policy: the default policy, the hand kernels
# asked for by name (flash stays auto: K1), the library route (SDPA on every
# K1 pass; tied rows stay auto: K2) and the plain versions everywhere
POLICY_SPECS = ("", "axial=pallas,tied_row=pallas", "axial=stock,flash=on",
                "axial=dense,flash=off,tied_row=dense")
POLICY_BUCKET = 128
POLICY_LENGTHS = (128, 121, 110, 99)  # one bucket-128 batch of 4
POLICY_REPS = 3  # forwards timed a policy, each alone between events
SPARSE_BACKENDS = ("pallas", "jnp", "splash")
PREDICT_CLI_LEN = 128


def _rel_l2(a, b) -> float:
    import numpy as np

    return float(np.linalg.norm(a - b) / max(float(np.linalg.norm(b)), 1e-30))


def _sparse_policy_case():
    """One SparseAttention pass at the sparse training shape (the pair grid
    of crop 128, 110 residues valid, f32) under each block_sparse choice:
    K4 launches only under pallas, the plain gather version's calls only
    under jnp, and the three outputs within 1e-4."""
    import torch

    from alphafold2_tpu_torch.ops.cuda import block_sparse as bsk
    from alphafold2_tpu_torch.ops.kernels import KernelPolicy, use_kernel_policy
    from alphafold2_tpu_torch.ops.sparse import BlockSparseConfig, SparseAttention

    gen = torch.Generator().manual_seed(21)
    attn = SparseAttention(256, 8, 64, seq_len=128, config=BlockSparseConfig())
    with torch.no_grad():
        for prm in attn.parameters():
            prm.copy_(torch.randn(prm.shape, generator=gen) * prm.shape[-1] ** -0.5)
    attn = attn.cuda()
    x = torch.randn((1, 128, 128, 256), generator=gen).cuda()
    mask = torch.zeros((1, 128, 128), dtype=torch.bool, device="cuda")
    mask[:, :TRAIN_LEN, :TRAIN_LEN] = True
    outs, launches, calls = {}, {}, {}
    for choice in SPARSE_BACKENDS:
        bsk.block_sparse_attention.launches = 0
        bsk.block_sparse_attention_reference.calls = 0
        with torch.no_grad(), use_kernel_policy(KernelPolicy(block_sparse=choice)):
            outs[choice] = attn.grid_axial(x, mask, attend_axis=2)
        torch.cuda.synchronize()
        launches[choice] = bsk.block_sparse_attention.launches
        calls[choice] = bsk.block_sparse_attention_reference.calls
    errs = {c: float((outs[c] - outs["jnp"]).abs().max()) for c in ("pallas", "splash")}
    log(f"[kernel_policy] SparseAttention {SPARSE_TRAIN_LABEL} f32: K4 launches {launches}, "
        f"plain calls {calls}, max |out - jnp| {errs} (tol 1e-4)")
    require(launches == {"pallas": 1, "jnp": 0, "splash": 0},
            f"K4 launched outside block_sparse=pallas: {launches}")
    require(calls == {"pallas": 0, "jnp": 1, "splash": 0},
            f"the plain gather version ran outside block_sparse=jnp: {calls}")
    require(max(errs.values()) <= 1e-4, f"block_sparse routes disagree: {errs}")
    return {"launches": launches, "max_abs_err": errs}


def phase_kernel_policy():
    """The kernel switchboard on the card (log tag ``[kernel_policy]``): the
    serving configuration (one bucket-128 rung at batch 4) under each spec
    of POLICY_SPECS, one engine each over one shared parameter set, the same
    four requests through each (pipelined: the forward runs on the
    pipeline's device worker). The explicit hand-kernel spec is bit-equal
    to the default; the library and plain routes' distograms within
    SERVE_BF16_LOGITS_BOUND; K1 launches only where a K1 route was asked
    for (the default or by name), K2 likewise (tied_row auto or pallas);
    plain calls only under the dense spec; each engine's key and
    compile_records carry its policy and regress refuses to compare an auto
    record with a stock one. Each policy's forward time (CUDA events,
    POLICY_REPS forwards each alone: median and spread), its K1/K2 and
    runtime launches a forward, its counted flops, and the span-based idle
    share (device_idle_fraction) beside the profiler's. Then one
    SparseAttention pass under each block_sparse choice."""
    import statistics

    import numpy as np
    import torch

    from alphafold2_tpu_torch.observe import Tracer, device_idle_fraction
    from alphafold2_tpu_torch.observe.regress import comparable_reason
    from alphafold2_tpu_torch.serve.engine import ServeEngine, ServeRequest

    t_phase = time.perf_counter()
    rng = np.random.default_rng(21)
    alphabet = list("ACDEFGHIKLMNPQRSTVWY")
    reqs = [ServeRequest(seq="".join(rng.choice(alphabet, n)), seed=i)
            for i, n in enumerate(POLICY_LENGTHS)]
    runs, model, base = {}, None, None
    for spec in POLICY_SPECS:
        cfg = _serve_config(buckets=(POLICY_BUCKET,), kernels=spec, return_distogram=True)
        engine = ServeEngine(cfg, model=model, tracer=Tracer(enabled=True))
        model = engine.model
        try:
            engine.warmup()
            read = _serve_counts()
            results = engine.predict_many(reqs)
            torch.cuda.synchronize()
            counts = read()
            spans = device_idle_fraction(engine.tracer.events())
            items = [engine._featurize_one(POLICY_BUCKET, r)[0] for r in reqs]
            stacked = engine._to_device(engine._stack_host(POLICY_BUCKET, items, len(reqs)),
                                        POLICY_BUCKET)
            times = [cuda_ms(lambda: engine._forward(stacked), reps=1, warmup=int(i == 0))
                     for i in range(POLICY_REPS)]
            one = _serve_counts()
            prof = _idle_share(lambda: engine._forward(stacked))
            per_forward = one()
        finally:
            engine.close()
        for r in results:
            require(r.ok and np.isfinite(r.atom14).all() and np.isfinite(r.distogram).all(),
                    f"policy {spec!r}: a request failed or is not finite ({r.error})")
        desc = engine.kernels_desc
        rec = engine.compile_records[0]
        require(engine._exe_key(POLICY_BUCKET, 4)[-1] == desc,
                f"policy {spec!r}: the engine's key lacks its policy")
        require(rec.get("kernels") == (None if desc == "auto" else desc),
                f"policy {spec!r}: compile record kernels={rec.get('kernels')!r}, not {desc!r}")
        runtime = sum(prof["runtime"].get(k, 0) for k in RUNTIME_CALLS[:4])
        run = {"desc": desc, "counts": counts, "per_forward": per_forward,
               "forward_ms": {"median": statistics.median(times), "min": min(times),
                              "max": max(times)},
               "runtime_launches": runtime, "flops": rec.get("flops"),
               "peak_bytes": rec.get("peak_bytes"), "idle_profiler": prof["idle"],
               "idle_spans": spans, "record": rec,
               "distogram": [r.distogram for r in results], "atom14": [r.atom14 for r in results]}
        runs[spec] = run
        base = base or run
        d_rel = max(_rel_l2(a, b) for a, b in zip(run["distogram"], base["distogram"]))
        d_atom = max(float(np.abs(a - b).max()) for a, b in zip(run["atom14"], base["atom14"]))
        run["distogram_rel_l2"], run["atom14_max_abs"] = d_rel, d_atom
        log(f"[kernel_policy] {desc}: forward at bucket {POLICY_BUCKET} x batch 4 "
            f"{run['forward_ms']['median']:.3f} ms (min {run['forward_ms']['min']:.3f}, "
            f"max {run['forward_ms']['max']:.3f}, {POLICY_REPS} forwards); a forward: K1 "
            f"{per_forward['fused_attention']} ({per_forward['fused_attention_sm90']} Hopper, "
            f"{per_forward['fused_attention_packed']} packed), K2 "
            f"{per_forward['tied_row_attention']}, plain {per_forward['plain_calls']}, runtime "
            f"launches {runtime}; counted flops {run['flops']}; peak {run['peak_bytes']} bytes; "
            f"idle (profiler, one forward) {prof['idle']}; idle (spans, the four requests) "
            f"{spans}; vs the default: distogram rel L2 {d_rel:.3e}, max |d atom14| "
            f"{d_atom:.3e} A; serving run counts {counts}")
    auto, named, stock, dense = (runs[s] for s in POLICY_SPECS)
    require(named["atom14_max_abs"] == 0.0 and named["distogram_rel_l2"] == 0.0,
            "the hand kernels asked for by name are not bit-equal to the default policy")
    for run in (stock, dense):
        require(run["distogram_rel_l2"] <= SERVE_BF16_LOGITS_BOUND,
                f"{run['desc']}: distogram rel L2 {run['distogram_rel_l2']:.3e} over "
                f"{SERVE_BF16_LOGITS_BOUND}")
    for run in (auto, named):
        _require_hopper(run["counts"], f"policy {run['desc']}")
    for run, k1, k2 in ((stock, False, True), (dense, False, False)):
        c = run["counts"]
        require((c["fused_attention"] > 0) == k1 and (c["tied_row_attention"] > 0) == k2,
                f"{run['desc']}: K1 {c['fused_attention']} / K2 {c['tied_row_attention']} "
                f"launches where the policy asked for K1 {k1}, K2 {k2}")
    require(stock["counts"]["tied_row_attention_sm90"] == stock["counts"]["tied_row_attention"],
            f"{stock['desc']}: a K2 launch off its Hopper kernel")
    for run in (auto, named, stock):
        require(run["counts"]["plain_calls"] == 0, f"{run['desc']}: a plain version ran")
    require(dense["counts"]["plain_calls"] > 0, "the dense policy ran no plain version")
    flops = {r["desc"]: r["flops"] for r in runs.values()}
    require(len(set(flops.values())) == 1, f"counted flops differ across policies: {flops}")
    kind = torch.cuda.get_device_name(0)
    records = {r["desc"]: {"metric": "serve forward ms", "device": kind, **r["record"]}
               for r in (auto, stock)}
    why = comparable_reason(records[stock["desc"]], records["auto"])
    log(f"[kernel_policy] regress on an auto record against a {stock['desc']} one: {why}")
    require(why is not None and "kernels" in why, "regress compared records across policies")
    sparse = _sparse_policy_case()
    seconds = time.perf_counter() - t_phase
    log(f"[kernel_policy] phase took {seconds:.1f} s")
    for run in runs.values():
        for k in ("distogram", "atom14", "record"):
            run.pop(k)
    return {"runs": {r["desc"]: r for r in runs.values()}, "sparse": sparse,
            "seconds": seconds}


def phase_predict_cli():
    """The prediction CLI on the card (log tag ``[predict_cli]``): ``main``
    in-process on a PREDICT_CLI_LEN-residue sequence at the serving
    configuration (tied MSA rows), every K1 and K2 launch on its Hopper
    kernel and no plain call, the PDB it wrote read back through
    utils/pdb.py (every residue, finite coordinates); then ``python -m
    alphafold2_tpu_torch.predict`` once in a subprocess (rc 0, the summary
    line)."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch

    from alphafold2_tpu_torch import predict
    from alphafold2_tpu_torch.utils import pdb as pdbio

    t_phase = time.perf_counter()
    rng = np.random.default_rng(5)
    seq = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), PREDICT_CLI_LEN))
    root = tempfile.mkdtemp(prefix="af2_predict_", dir=os.path.join(HERE, "build"))
    try:
        out = os.path.join(root, "in_process.pdb")
        read = _serve_counts()
        t0 = time.perf_counter()
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = predict.main(["--seq", seq, "--out", out, "model.msa_tie_row_attn=true"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read()
        require(rc == 0, f"predict.main returned {rc}")
        _require_hopper(counts, "predict CLI")
        line = text.getvalue().strip()
        log(f"[predict_cli] main in-process: {line!r} in {wall:.2f} s; launches {counts}")
        s = pdbio.load_pdb(out)
        ca = s.coords[s.name == "CA"]
        require(len(np.unique(s.resseq)) == PREDICT_CLI_LEN and len(ca) == PREDICT_CLI_LEN
                and bool(np.isfinite(s.coords).all()),
                f"the PDB read back holds {len(np.unique(s.resseq))} residues, finite "
                f"{bool(np.isfinite(s.coords).all())}")
        sub = os.path.join(root, "subprocess.pdb")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "alphafold2_tpu_torch.predict", "--seq", seq, "--out", sub,
             "model.msa_tie_row_attn=true"],
            cwd=HERE, capture_output=True, text=True, timeout=600)
        sub_wall = time.perf_counter() - t0
        last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
        log(f"[predict_cli] python -m alphafold2_tpu_torch.predict: rc {proc.returncode}, "
            f"{last!r} in {sub_wall:.2f} s")
        require(proc.returncode == 0 and last.startswith(f"wrote {sub}: {PREDICT_CLI_LEN} "
                                                        "residues"),
                f"the CLI subprocess failed: rc {proc.returncode}, {proc.stderr[-2000:]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    log(f"[predict_cli] phase took {seconds:.1f} s")
    return {"launches": counts, "wall_s": wall, "subprocess_wall_s": sub_wall,
            "seconds": seconds}


def phase_lattice(engine=None):
    """``analysis/budgets.py lattice_report`` on the card (log tag
    ``[lattice]``) over the serving phase's engine, which warmed every rung
    64-256 at batch 4, so no forward runs again (built and warmed here when
    the phase runs alone): each rung's peak_bytes, parameters, flops and
    verdict against 0.9 of the card's memory; every rung must pass."""
    from alphafold2_tpu_torch.analysis.budgets import format_budget, lattice_report
    from alphafold2_tpu_torch.serve.engine import ServeEngine

    t_phase = time.perf_counter()
    own = engine is None
    if own:
        engine = ServeEngine(_serve_config())
        engine.warmup()
    try:
        before = len(engine.compile_records)
        report = lattice_report(engine)
        require(own or len(engine.compile_records) == before,
                "lattice_report ran a rung the engine had already warmed")
    finally:
        if own:
            engine.close()
    for rung in report["rungs"]:
        log(f"[lattice] bucket {rung['bucket']} x batch {rung['batch']}: peak_bytes "
            f"{rung.get('peak_bytes')}, param_bytes {rung['param_bytes']}, flops "
            f"{rung['flops']}; " + format_budget("verdict", rung["budget"]))
    seconds = time.perf_counter() - t_phase
    log(f"[lattice] verdict {report['verdict']} against {report['hbm_budget_bytes']} bytes; "
        f"phase took {seconds:.2f} s")
    require(report["verdict"] == "pass", f"lattice verdict {report['verdict']}")
    return {**report, "seconds": seconds}


LONG_BUCKETS = (512, 768)  # the long ladder's candidates, each at long_max_batch 1


def _long_request(bucket, length, seed=0):
    """A ``length``-residue request of seeded random residues, featurized at
    ``bucket`` as the engine does."""
    import numpy as np

    from alphafold2_tpu_torch.serve.engine import ServeRequest

    rng = np.random.default_rng(1000 + bucket)
    return ServeRequest(seq="".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), length)),
                        seed=seed)


def _meshless_long(engine, bucket, length, reps=3):
    """The serving model's forward at ``bucket`` x batch 1, called directly
    (the meshless engine refuses the long rungs): a ``length``-residue
    request featurized as the engine does. Returns ``{"ms" (median of
    ``reps``), "peak_bytes", "out"}``, or ``{"oom": message}`` when the card
    runs out of memory."""
    import statistics

    import torch

    item, _ = engine._featurize_one(bucket, _long_request(bucket, length))
    stacked = engine._to_device(engine._stack_host(bucket, [item], 1), bucket)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = []
    try:
        for _ in range(reps):
            t0 = time.perf_counter()
            out = engine._forward(stacked)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    except torch.cuda.OutOfMemoryError as e:
        del stacked
        torch.cuda.empty_cache()
        return {"oom": str(e).splitlines()[0]}
    return {"ms": statistics.median(times), "times_ms": times,
            "peak_bytes": torch.cuda.max_memory_allocated(), "out": out}


def phase_long_meshless(buckets=LONG_BUCKETS):
    """The serving configuration's forward without a mesh at each long
    bucket x batch 1 (log tag ``[long]``): its median ms of 3, its peak
    memory (parameters included) and the parameters' bytes, beside 0.9 of
    the card's memory. Not part of the run: it decides the long ladder the
    mesh phase serves."""
    import torch

    from alphafold2_tpu_torch.serve.engine import ServeEngine

    cfg = _serve_config(pipeline_depth=0)
    cfg.model.max_seq_len = 3 * max(buckets)
    engine = ServeEngine(cfg)
    param_bytes = sum(p.numel() * p.element_size() for p in engine.model.parameters())
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    read = _serve_counts()
    out = {}
    for bucket in buckets:
        length = bucket - 20
        run = _meshless_long(engine, bucket, length)
        run.pop("out", None)
        out[bucket] = run
        if "oom" in run:
            log(f"[long] bucket {bucket} x 1 ({length} residues), no mesh: out of memory "
                f"({run['oom']})")
            continue
        fits = run["peak_bytes"] < 0.9 * card_bytes
        log(f"[long] bucket {bucket} x 1 ({length} residues), no mesh: forward "
            f"{run['ms']:.1f} ms (median of {run['times_ms']}), peak "
            f"{run['peak_bytes'] / 1e9:.2f} GB with parameters {param_bytes / 1e9:.4f} GB; "
            f"0.9 x card {0.9 * card_bytes / 1e9:.2f} GB: {'fits' if fits else 'does not fit'}")
    log(f"[long] launches {read()}; card {_card()}")
    engine.close()
    return out


LONG_MESH_BUCKETS = (512, 768)  # the long ladder the mesh phase serves (phase_long_meshless)
LONG_MESH_TAIL = 20  # each long request is its bucket less this many residues
LONG_MESH_TIMEOUT_S = 600
LONG_MESH_TURNS = (0, 1)  # meshless (0) and mesh (1) forwards a rung, in turns
# the several-ranks sub-phase: a (1, 2, 2) grid of four ranks on the one card
# (a gloo group on CUDA tensors: NCCL takes one rank a device), serving one
# request on this long rung, which the world-size-1 rank serves too
LONG_RANKS_WORLD = 4
LONG_RANKS_BUCKET = 96
LONG_RANKS_LENGTH = 76
LONG_RANKS_TIMEOUT_S = 300
# the census of one forward on a (1, 1, 1) grid mesh of the SERVE_DEPTH-layer
# serving model: per layer the two axial passes (q, k, v and the mask
# gathered, the output scattered: 5 all_to_alls each over spr and spc) and the
# MSA<-pair merge (2 all_reduces), then the symmetrisation's transpose and the
# logits' gather; the engine's broadcast of the batch
LONG_MESH_CENSUS = {"all_to_all@spr": 5 * SERVE_DEPTH, "all_to_all@spc": 5 * SERVE_DEPTH,
                    "all_reduce@seq": 2 * SERVE_DEPTH, "all_to_all@seq": 1,
                    "all_gather@world": 1, "broadcast@world": 1}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_env(rank, world, port, local_rank=0):
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local_rank),
                MASTER_ADDR="localhost", MASTER_PORT=str(port))


def phase_long_mesh():
    """Long-chain serving on a device mesh (log tag ``[long_mesh]``).

    (a) One rank of a world-size-1 NCCL process group in a subprocess
    started with torchrun's environment (this process holds no process
    group), on a ``(1, 1, 1)`` grid mesh with ``model.grid_parallel``: the
    serving configuration at full width (ladder 64 and the long rungs
    LONG_RANKS_BUCKET and LONG_MESH_BUCKETS at ``long_max_batch`` 1) serves
    one request of bucket - 20 residues on each rung of LONG_MESH_BUCKETS
    through ``ServeEngine(mesh=)``. Each run must give finite atom14, K1
    and K2 on their Hopper routes with no plain call, the expected census
    (every collective in place), a distogram within tests/test_precision.py's
    relative L2 bound of the same model's meshless forward, K1 at each of
    the rung's call shapes against its plain version (``_long_rung_k1_checks``),
    and ``lattice_report`` passing on the long rungs; each rung's forward
    ms (median of 2, in turns beside the meshless forward's in the same process),
    peak, ``mesh_mfu`` and launches are logged and returned. The rank then
    serves a LONG_RANKS_LENGTH-residue request on the LONG_RANKS_BUCKET
    rung and keeps its distogram.

    (b) LONG_RANKS_WORLD ranks on the one card (``_long_mesh_ranks``): the
    same request on a ``(1, 2, 2)`` grid, rank 0's distogram held against
    (a)'s, K1 and K2 on their Hopper routes on every rank.

    The collective audit on the card runs beside (b)."""
    import gc
    import tempfile

    import torch

    t0 = time.perf_counter()
    if torch.cuda.is_initialized():
        # the rank is another process on the same card: hand it the blocks
        # this process's allocator caches from the earlier phases
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        log(f"[long_mesh] this process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB "
            f"({torch.cuda.memory_reserved() / 1e9:.2f} reserved); the card has "
            f"{free / 1e9:.2f} of {total / 1e9:.2f} GB free")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "long_mesh.json")
        proc = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke as c; sys.exit(c.long_mesh_rank(sys.argv[1]))",
             out], cwd=HERE, env=_rank_env(0, 1, _free_port()), timeout=LONG_MESH_TIMEOUT_S)
        require(proc.returncode == 0, f"the mesh rank exited {proc.returncode}")
        with open(out, encoding="utf-8") as fh:
            result = json.load(fh)
        audit = _start_collective_audit(tmp)  # beside (b): the audit times nothing
        try:
            result["ranks"] = _long_mesh_ranks(tmp)
            result["audit"] = _finish_collective_audit(*audit)
        finally:
            if audit[0].poll() is None:
                audit[0].kill()
                audit[0].wait()
    result["seconds"] = time.perf_counter() - t0
    log(f"[long_mesh] phase took {result['seconds']:.1f} s")
    return result


def _long_mesh_ranks(tmp):
    """Phase (b) of phase_long_mesh: LONG_RANKS_WORLD processes, each a rank
    of a gloo group on the one card (``long_mesh_gloo_rank``); returns each
    rank's record."""
    t0 = time.perf_counter()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import sys, chip_smoke as c; sys.exit(c.long_mesh_gloo_rank(sys.argv[1]))", tmp],
        cwd=HERE, env=_rank_env(r, LONG_RANKS_WORLD, port)) for r in range(LONG_RANKS_WORLD)]
    deadline = time.monotonic() + LONG_RANKS_TIMEOUT_S
    try:
        codes = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    require(codes == [0] * LONG_RANKS_WORLD, f"the {LONG_RANKS_WORLD} ranks exited {codes}")
    ranks = []
    for r in range(LONG_RANKS_WORLD):
        with open(os.path.join(tmp, f"rank{r}.json"), encoding="utf-8") as fh:
            ranks.append(json.load(fh))
    log(f"[long_mesh ranks] {LONG_RANKS_WORLD} ranks on the one card took "
        f"{time.perf_counter() - t0:.1f} s")
    return ranks


def long_mesh_gloo_rank(tmp) -> int:
    """The body of one rank of phase_long_mesh's (b) (run as its
    subprocess): a gloo group on CUDA tensors over LONG_RANKS_WORLD ranks of
    the one card, a ``(1, 2, 2)`` grid mesh, phase (a)'s configuration and
    weights; rank 0 serves the LONG_RANKS_LENGTH-residue request on the
    LONG_RANKS_BUCKET rung and holds its distogram against (a)'s
    world-size-1 one within the bf16 bound, the others follow. Every rank
    must launch K1 and K2 on their Hopper routes with no plain call, and
    make three forwards' census (the warm run, the counted run, the
    request's)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from alphafold2_tpu_torch.parallel import sharding
    from alphafold2_tpu_torch.parallel.grid_parallel import make_grid_mesh
    from alphafold2_tpu_torch.serve.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}",
                            rank=rank, world_size=world)
    try:
        mesh = make_grid_mesh(1, 2, 2)
        engine = ServeEngine(_long_mesh_config(), mesh=mesh)
        require(engine.mesh_desc == "dp1.spr2.spc2", f"mesh {engine.mesh_desc}")
        read = _serve_counts()  # every count 0 just before the main path
        before = sharding.census()
        out = {"rank": rank}
        t0 = time.perf_counter()
        if rank == 0:
            (res,) = engine.predict_many([_long_request(LONG_RANKS_BUCKET, LONG_RANKS_LENGTH)])
            out["serve_s"] = time.perf_counter() - t0
            require(res.ok and res.bucket == LONG_RANKS_BUCKET
                    and np.isfinite(res.atom14).all(), f"rank 0: {res.status} {res.error}")
            ref = np.load(os.path.join(tmp, "world1_distogram.npy")).astype(np.float64)
            got = res.distogram.astype(np.float64)
            out["rel_l2_vs_world1"] = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
            out["max_abs_vs_world1"] = float(np.abs(got - ref).max())
            out["launches"] = read()
            census = sharding.census_delta(before, sharding.census())
            engine.close()  # the followers' stop (one more broadcast, not counted)
        else:
            engine.follow()
            out["serve_s"] = time.perf_counter() - t0
            out["launches"] = read()
            census = sharding.census_delta(before, sharding.census())
        out["census"] = {k: v["count"] for k, v in census.items()}
        out["comm_bytes"] = int(sum(v["bytes"] for v in census.values()))
        log(f"[long_mesh ranks] rank {rank} of {world} (gloo, CUDA tensors, "
            f"{engine.mesh_desc}): {out['serve_s']:.1f} s; launches {out['launches']}; "
            f"census {out['census']}, {out['comm_bytes']} bytes"
            + (f"; distogram vs the world-size-1 rank rel L2 {out['rel_l2_vs_world1']:.3e}, "
               f"max abs {out['max_abs_vs_world1']:.3e}" if rank == 0 else ""))
        _require_hopper(out["launches"], f"[long_mesh ranks] rank {rank}")
        want = {k: 3 * v for k, v in LONG_MESH_CENSUS.items()
                if rank == 0 or k != "broadcast@world"}
        require(out["census"] == want, f"rank {rank}: census {out['census']}, expected {want}")
        if rank == 0:
            require(out["rel_l2_vs_world1"] <= SERVE_BF16_LOGITS_BOUND,
                    f"rank 0: distogram vs the world-size-1 rank rel L2 "
                    f"{out['rel_l2_vs_world1']:.3e}")
        with open(os.path.join(tmp, f"rank{rank}.json"), "w", encoding="utf-8") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()
    return 0


def _long_mesh_config():
    """The mesh phase's serving configuration, (a)'s and (b)'s alike (the
    same weights from the same seed): ladder 64, the long rungs
    LONG_RANKS_BUCKET and LONG_MESH_BUCKETS at batch 1, distograms
    returned, ``model.grid_parallel``."""
    cfg = _serve_config(buckets=(64,), pipeline_depth=0,
                        long_buckets=(LONG_RANKS_BUCKET,) + LONG_MESH_BUCKETS,
                        long_max_batch=1, return_distogram=True)
    cfg.model.grid_parallel = True
    cfg.model.max_seq_len = 3 * max(LONG_MESH_BUCKETS)
    return cfg


def _start_collective_audit(tmp):
    """Start ``python -m alphafold2_tpu_torch.analysis.hlo_audit --check`` on
    the card's NCCL world of one rank, its verdict to a file under ``tmp``;
    returns (the process, the file)."""
    path = os.path.join(tmp, "audit.json")
    proc = subprocess.Popen([sys.executable, "-m", "alphafold2_tpu_torch.analysis.hlo_audit",
                             "--check", "--json", path], cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, path


def _finish_collective_audit(proc, path):
    """The started audit's outcome: every audited target's census,
    AF2A108-110 clean (the committed baseline is the CPU's 4 gloo ranks, so
    the check reports a stale baseline, rc 0); each target's collectives
    and its measured per-rank peak against its budget."""
    stdout, stderr = proc.communicate(timeout=300)
    require(proc.returncode == 0, f"the collective audit exited {proc.returncode}:\n"
                                  f"{stdout[-2000:]}{stderr[-2000:]}")
    with open(path, encoding="utf-8") as fh:
        got = json.load(fh)
    for name, rec in got["doc"]["targets"].items():
        counts = {k: v["count"] for k, v in rec["collectives"].items()}
        log(f"[long_mesh] audit {name} on {rec['mesh'] or 'one device'}: collectives {counts}, "
            f"comm_bytes {rec['comm_bytes']}, peak {rec['program_bytes']} bytes, budget "
            f"{rec['budget']['verdict']}")
    log(f"[long_mesh] audit verdict {got['summary']['verdict']}, findings "
        f"{got['summary']['findings']}")
    return {"verdict": got["summary"]["verdict"],
            "targets": {n: {"collectives": r["collectives"], "program_bytes": r["program_bytes"],
                            "budget": r["budget"]} for n, r in got["doc"]["targets"].items()}}


K1_CHECK_LOGITS_BYTES = 1 << 30  # the f32 logits a slice check's plain version may hold


def _k1_slice_check(label, with_lse, q, k, v, q_mask, kv_mask, scale, got):
    """One K1 call of the main path held against K1's plain version on the
    same operands: a slice of its batch rows (the first two and the last
    two) and of their queries (all of them, or the first and the last as
    many as K1_CHECK_LOGITS_BYTES of f32 logits over every key allow),
    each over the call's whole key axis; ``got`` is the call's own result,
    ``(out, lse)`` with ``with_lse``. Fails the run on an output off by
    more than the kernel phase's bf16 tolerance, and on an lse off by more
    than 1e-4. Returns the comparison's row."""
    import torch

    from alphafold2_tpu_torch.ops.cuda import axial

    b, h, nq, d = q.shape
    nk = k.shape[2]
    bi = torch.tensor(sorted({0, 1, b - 2, b - 1} & set(range(b))), device=q.device)
    n_sl = max(2, min(nq, K1_CHECK_LOGITS_BYTES // (len(bi) * h * nk * 4)))
    qi = torch.tensor(sorted(set(range(n_sl // 2)) | set(range(nq - (n_sl - n_sl // 2), nq))),
                      device=q.device)
    rows = lambda t: t.index_select(0, bi)  # noqa: E731
    qs, ks, vs = rows(q).index_select(2, qi), rows(k), rows(v)
    qm = rows(q_mask).index_select(1, qi) if q_mask is not None else None
    km = rows(kv_mask) if kv_mask is not None else None
    route = _k1_route(b, h, nq, nk, d)
    splits = axial.key_splits(b, h, nq, nk, d) if route == "sm90" else 1
    what = (f"{label} ({b} x {h}, {nq} x {nk}, d{d}; {K1_ROUTES[route]}, {splits} key "
            f"splits): rows {bi.tolist()}, {len(qi)} queries")
    out, lse = got if with_lse else (got, None)
    ref, ref_lse = axial.fused_attention_lse_reference(qs, ks, vs, qm, km, scale)
    row = _compare(what, "fused_attention (lse)" if with_lse else "fused_attention",
                   rows(out).index_select(2, qi), ref, q.dtype)
    if with_lse:
        _check_lse(what, rows(lse).index_select(2, qi), ref_lse)
    return {**row, "lse": with_lse, "shape": [b, h, nq, nk, d], "splits": splits,
            "route": route, "rows": len(bi), "queries": len(qi)}


def _long_rung_k1_checks(engine, stacked, bucket, launches):
    """One more mesh forward of a long rung with K1's two wrappers watched
    where the model reaches them (``ops/attention.py``'s ``fused_attention``
    for the axial, MSA column and pair<-MSA passes, ``ops/cuda/axial.py``'s
    ``fused_attention_lse`` for the merged MSA<-pair pass): every call
    launches K1 as it would, and the first call of each operand signature
    (shapes, strides, masks, lse or not) is held against K1's plain version
    (``_k1_slice_check``), the key-split passes and their combine included.
    The watched calls must be every K1 launch of the forward, as many as
    a forward of the counted run; at least one with lse. Not counted as
    main-path launches (the counts were read before)."""
    import torch

    from alphafold2_tpu_torch.ops import attention as attention_mod
    from alphafold2_tpu_torch.ops.cuda import axial

    real = (attention_mod.fused_attention, axial.fused_attention_lse)
    seen, checks, calls = set(), [], [0]

    def watched(fn, with_lse):
        def call(q, k, v, q_mask=None, kv_mask=None, sm_scale=1.0):
            got = fn(q, k, v, q_mask=q_mask, kv_mask=kv_mask, sm_scale=sm_scale)
            calls[0] += 1
            sig = (with_lse, tuple(q.shape), tuple(k.shape), q.stride(), k.stride(),
                   v.stride(), q_mask is None, kv_mask is None)
            if sig not in seen:
                seen.add(sig)
                checks.append(_k1_slice_check(f"[long_mesh] bucket {bucket}", with_lse, q, k,
                                              v, q_mask, kv_mask, sm_scale, got))
            return got
        return call

    before = axial.fused_attention.launches
    attention_mod.fused_attention = watched(real[0], False)
    axial.fused_attention_lse = watched(real[1], True)
    try:
        engine._forward(stacked)
        torch.cuda.synchronize()
    finally:
        attention_mod.fused_attention, axial.fused_attention_lse = real
    ran = axial.fused_attention.launches - before
    require(calls[0] == ran and 3 * ran == launches["fused_attention"],
            f"bucket {bucket}: {calls[0]} watched K1 calls, {ran} launches, "
            f"{launches['fused_attention']} in the counted three forwards")
    require(any(c["lse"] for c in checks), f"bucket {bucket}: no K1 call with lse watched")
    torch.cuda.empty_cache()
    return checks


def long_mesh_rank(out_path) -> int:
    """The body of phase_long_mesh's rank (run as its subprocess)."""
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist

    from alphafold2_tpu_torch.analysis.budgets import format_budget, lattice_report
    from alphafold2_tpu_torch.observe.flops import mesh_mfu
    from alphafold2_tpu_torch.ops.kernels import use_kernel_policy
    from alphafold2_tpu_torch.parallel import distributed, sharding
    from alphafold2_tpu_torch.parallel.grid_parallel import make_grid_mesh
    from alphafold2_tpu_torch.serve.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    require(distributed.initialize(), "torchrun's environment initialised no process group")
    require(dist.get_world_size() == 1 and dist.get_backend() == "nccl",
            f"expected one NCCL rank, got {dist.get_world_size()} {dist.get_backend()}")
    result = {"card": _card(), "rungs": {}}
    try:
        mesh = make_grid_mesh(1, 1, 1)
        engine = ServeEngine(_long_mesh_config(), mesh=mesh)
        require(engine.mesh_desc == "dp1.spr1.spc1", f"mesh {engine.mesh_desc}")
        read = _serve_counts()
        for bucket in LONG_MESH_BUCKETS:
            length = bucket - LONG_MESH_TAIL
            req = _long_request(bucket, length)
            read = _serve_counts()  # every count 0 just before the main path
            before = sharding.census()
            t_serve = time.perf_counter()
            (res,) = engine.predict_many([req])
            serve_s = time.perf_counter() - t_serve
            launches = read()
            census = sharding.census_delta(before, sharding.census())
            require(res.ok, f"bucket {bucket}: {res.status} {res.error}")
            require(res.bucket == bucket and res.atom14.shape == (length, 14, 3)
                    and np.isfinite(res.atom14).all(), f"bucket {bucket}: atom14 not finite")
            _require_hopper(launches, f"[long_mesh] bucket {bucket}")
            # predict_many's first dispatch of a rung: the warm run, the counted
            # run and the request's forward
            want = {k: 3 * v for k, v in LONG_MESH_CENSUS.items()}
            got = {k: v["count"] for k, v in census.items()}
            require(got == want, f"bucket {bucket}: census {got}, expected {want}")
            item, _ = engine._featurize_one(bucket, req)
            stacked = engine._to_device(engine._stack_host(bucket, [item], 1), bucket)

            def meshless():  # the same model's forward as the engine's, no mesh active
                with torch.inference_mode(), use_kernel_policy(engine._policy):
                    return engine.model(stacked["seq"].long(), stacked["msa"].long(),
                                        mask=stacked["mask"], msa_mask=stacked["msa_mask"],
                                        coords0=stacked["coords0"])

            # the mesh forward and the meshless one alternate in one process
            # (LONG_MESH_TURNS); each run's peak holds the other kind's last
            # outputs
            times, flat_times, peaks, outs = [], [], [0, 0], [None, None]
            for which in LONG_MESH_TURNS:
                outs[which] = None
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                outs[which] = engine._forward(stacked) if which else meshless()
                torch.cuda.synchronize()
                (times if which else flat_times).append((time.perf_counter() - t) * 1e3)
                peaks[which] = max(peaks[which], torch.cuda.max_memory_allocated())
            flat_peak, peak = peaks
            ms, flat_ms = statistics.median(times), statistics.median(flat_times)
            disto = outs[1]["distogram"][0, :3 * length, :3 * length].float()
            ref = outs[0]["distogram"][0, :3 * length, :3 * length].float()
            rel = float(torch.linalg.vector_norm(disto - ref)
                        / torch.linalg.vector_norm(ref).clamp_min(1e-30))
            max_abs = float((disto - ref).abs().max())
            require(rel <= SERVE_BF16_LOGITS_BOUND,
                    f"bucket {bucket}: mesh vs meshless logits rel L2 {rel:.3e}")
            outs = disto = ref = None
            k1_checks = _long_rung_k1_checks(engine, stacked, bucket, launches)
            flops = engine._exe_flops.get(engine._exe_key(bucket, 1))
            mfu = mesh_mfu(flops, ms / 1e3, mesh=mesh)
            rung = {"residues": length, "ms": ms, "times_ms": times, "meshless_ms": flat_ms,
                    "meshless_times_ms": flat_times, "peak_bytes": peak,
                    "meshless_peak_bytes": flat_peak,
                    "serve_s": serve_s, "flops": flops, **mfu, "launches": launches,
                    "census": census, "rel_l2_vs_meshless": rel, "max_abs_vs_meshless": max_abs,
                    "k1_checks": k1_checks}
            result["rungs"][str(bucket)] = rung
            log(f"[long_mesh] bucket {bucket} x 1 ({length} residues) on {engine.mesh_desc}: "
                f"forward {ms:.1f} ms (median of {[round(t, 1) for t in times]}), the same "
                f"model without a mesh in this process {flat_ms:.1f} ms (median of "
                f"{[round(t, 1) for t in flat_times]}), peak {peak / 1e9:.2f} GB (meshless "
                f"{flat_peak / 1e9:.2f}), flops "
                f"{flops:.4e}, mesh_mfu {mfu.get('mfu')} ({mfu.get('mfu_basis')}); first "
                f"dispatch {serve_s:.1f} s; launches {launches}; census {got}; logits vs "
                f"meshless rel L2 {rel:.3e}, max abs {max_abs:.3e}; K1 held against its plain "
                f"version at {len(k1_checks)} call shapes of the rung")
            torch.cuda.empty_cache()
        ranks_req = _long_request(LONG_RANKS_BUCKET, LONG_RANKS_LENGTH)
        (res,) = engine.predict_many([ranks_req])
        require(res.ok and res.bucket == LONG_RANKS_BUCKET,
                f"bucket {LONG_RANKS_BUCKET}: {res.status} {res.error}")
        np.save(os.path.join(os.path.dirname(out_path), "world1_distogram.npy"), res.distogram)
        report = lattice_report(engine)
        for rung in report["rungs"]:
            log(f"[long_mesh] lattice bucket {rung['bucket']} x {rung['batch']}: "
                f"comm_bytes {rung['comm_bytes']}; " + format_budget("verdict", rung["budget"]))
        require(report["verdict"] == "pass", f"lattice verdict {report['verdict']}")
        result["lattice"] = {str(r["bucket"]): r["budget"] for r in report["rungs"]}
        engine.close()
        log(f"[long_mesh] card {result['card']}")
        with open(out_path, "w", encoding="utf-8") as fh:
            json.dump(result, fh)
    finally:
        dist.destroy_process_group()
    return 0


# ------------------------------------------------ training on a device mesh

# (a) the training smoke's width (Config(): dim 256, heads 8, dim_head 64,
# bf16, crop 128, MSA 5x64, batch 1) at ENGINE_DEPTH, accumulation 1 so every
# step updates: the steps each state takes, meshless and on each mesh, in turns
TRAIN_MESH_STEPS = 3
TRAIN_MESH_CONFIGS = {"dense": {}, "tied": {"msa_tie_row_attn": True},
                      "sparse": {"sparse_self_attn": True}}
# (a) on the (1, 1) mesh only: the reversible engine refuses grid_parallel,
# so the 1x1x1 grid, as JAX's does
TRAIN_MESH_LINE_CONFIGS = {"reversible": {"reversible": True},
                           "reversible tied": {"reversible": True, "msa_tie_row_attn": True}}
TRAIN_MESH_TEMPLATES = 4  # (a)'s template pass: 4 templates, 2 template blocks
# (b) the long crop: JAX's test_grid_sparse_768_full_train_step at full width
TRAIN_MESH_LONG = {"crop": 768, "msa_len": 128, "min_len": 728}
TRAIN_MESH_LONG_STEPS = 3
# (c) four gloo ranks on the one card at depth 2, crop 64, MSA 5x64, batch 2
TRAIN_MESH_RANKS = 4
TRAIN_MESH_RANK_RUNS = {  # label: (mesh spec, model fields)
    "1x2x2 sparse tied": ("1x2x2", {"grid_parallel": True, "sparse_self_attn": True,
                                    "msa_tie_row_attn": True}),
    "2x2 dense": ("2x2", {}),
    "2x2 reversible tied": ("2x2", {"reversible": True, "msa_tie_row_attn": True}),
}
TRAIN_MESH_RANK_STEPS = 2
TRAIN_MESH_RANK_LOSS_REL = 1e-2
TRAIN_MESH_RANK_GRAD_REL_L2 = 0.05  # PR 22's bound of four ranks against one
TRAIN_MESH_E2E_STEPS = 2  # (d) end-to-end steps at the CLI's width, in turns
TRAIN_MESH_TIMEOUT_S = 600
# K3 at the long crop's call shapes: the f32 (query x key) logits a slice
# check's plain version may hold
K3_CHECK_LOGITS_BYTES = 1 << 29


def _train_counts():
    """Every training kernel's launch and Hopper launch count and the plain
    versions' calls set to 0; returns a function reading them (K4 with and
    without lse together)."""
    kernels, plain = _training_kernels(), _plain_versions()
    _reset_counts(kernels, plain)

    def read():
        out = {"plain_calls": sum(fn.calls for fn in plain)}
        for name, fn in kernels.items():
            key = name.replace(" (no lse)", "")
            out[key] = out.get(key, 0) + fn.launches
            if hasattr(fn, "sm90_launches"):
                out[f"{key} sm90"] = out.get(f"{key} sm90", 0) + fn.sm90_launches
        return out

    return read


def _count_delta(before, after):
    return {k: after[k] - before.get(k, 0) for k in after}


def _require_training_hopper(counts, what):
    """Every launch of a training kernel with a Hopper kernel on it, K1 and
    K3 launched, no plain version."""
    require(counts["fused_attention"] > 0 and counts["fused_attention_bwd_dq"] > 0,
            f"{what}: K1 or K3 never launched ({counts})")
    for name in counts:
        if name.endswith(" sm90"):
            base = name[:-5]
            require(counts[name] == counts[base],
                    f"{what}: {counts[base] - counts[name]} {base} launches off its Hopper kernel")
    require(counts["plain_calls"] == 0, f"{what}: a plain version ran on the training path")


def _grads(model):
    import torch

    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().float().cpu()
            for n, p in model.named_parameters()}


def _differing_leaves(a, b):
    """The names of the gradient leaves of ``b`` not bit-equal to ``a``'s."""
    import torch

    return {n for n in a if not torch.equal(a[n], b[n])}


def _synthetic(cfg, n):
    """The first ``n`` numpy batches of ``cfg``'s synthetic stream."""
    import itertools

    from alphafold2_tpu_torch.data.pipeline import SyntheticDataset

    return list(itertools.islice(iter(SyntheticDataset(cfg.data, seed=cfg.train.seed)), n))


def _train_mesh_cfg(fields, **data):
    from alphafold2_tpu_torch.config import Config

    cfg = Config()
    cfg.model.depth = ENGINE_DEPTH
    for k, v in fields.items():
        setattr(cfg.model, k, v)
    for k, v in data.items():
        setattr(cfg.data, k, v)
    cfg.train.gradient_accumulate_every = 1
    cfg.train.warmup_steps = 1
    return cfg


def _timed_step(step, state, batch, *extra):
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = step(state, batch, *extra)
    torch.cuda.synchronize()
    return state, metrics, (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated()


def _in_turns(label, runs, one, unit="step"):
    """(a)'s comparison: TRAIN_MESH_STEPS rounds, each calling ``one(name,
    i) -> (loss, grads, ms, peak)`` for every run of ``runs`` in order, the
    first (meshless) the reference; each later run's loss and every
    gradient against it (the kernel phase's bf16 bound; bit-equal
    expected, the differing leaves named where not), every later run's
    launches summed and held to Hopper. Returns the record and the log's
    text from the losses on."""
    import statistics

    read = _train_counts()
    launches = {k: {} for k in list(runs)[1:]}
    rec = {k: {"ms": [], "peak": 0, "losses": []} for k in runs}
    worst, differ = 0.0, {k: set() for k in launches}
    for i in range(TRAIN_MESH_STEPS):
        ref = None
        for name in runs:
            before = read()
            loss, grads, ms, peak = one(name, i)
            require(math.isfinite(loss), f"[train_mesh] {label} {name} {unit} {i}")
            r = rec[name]
            r["losses"].append(loss)
            r["ms"].append(ms)
            r["peak"] = max(r["peak"], peak)
            if ref is None:
                ref = (loss, grads)
                continue
            for k, v in _count_delta(before, read()).items():
                launches[name][k] = launches[name].get(k, 0) + v
            require(abs(loss - ref[0]) <= TOL["bfloat16"][1] * abs(ref[0]),
                    f"[train_mesh] {label} on {name}, {unit} {i}: loss {loss} vs meshless "
                    f"{ref[0]}")
            err, leaf, _ = _leaf_errors(ref[1], grads)
            worst = max(worst, err)
            if loss != ref[0]:
                differ[name].add("loss")
            differ[name] |= _differing_leaves(ref[1], grads)
            require(err <= TOL["bfloat16"][1],
                    f"[train_mesh] {label} on {name}, {unit} {i}: gradient {leaf} rel L2 "
                    f"{err:.3e}")
    for name, counts in launches.items():
        _require_training_hopper(counts, f"[train_mesh] {label} on {name}")
    equal = not any(differ.values())
    out = {"runs": {k: {"losses": r["losses"], "ms": statistics.median(r["ms"][1:]),
                        "peak_bytes": r["peak"]} for k, r in rec.items()},
           "launches": launches, "worst_grad_rel_l2": worst, "bit_equal": equal}
    text = ("losses " + "; ".join(f"{k} {' '.join(f'{x:.6f}' for x in r['losses'])}"
                                   for k, r in rec.items())
            + f"; every gradient against meshless worst rel L2 {worst:.3e} (tol "
            f"{TOL['bfloat16'][1]}), bit-equal: {equal}"
            + ("" if equal else " (differing: " + ", ".join(
                f"{k} {sorted(v)}" for k, v in differ.items()) + ")")
            + f"; {unit} ms (median of {unit}{'es' if unit == 'pass' else 's'} "
            f"2-{TRAIN_MESH_STEPS}) "
            + ", ".join(f"{k} {v['ms']:.2f}" for k, v in out["runs"].items())
            + "; peak GiB " + ", ".join(f"{k} {v['peak_bytes'] / 2**30:.2f}"
                                         for k, v in out["runs"].items()))
    return out, text


def _train_mesh_world1(label, fields, grid=True):
    """(a): one configuration meshless, on a (1, 1) mesh and (``grid``) on
    a 1x1x1 grid, TRAIN_MESH_STEPS steps each from the same initial state
    and batches, in turns (``_in_turns``); one step's census on the last
    mesh."""
    from alphafold2_tpu_torch.parallel import sharding
    from alphafold2_tpu_torch.parallel.grid_parallel import make_grid_mesh
    from alphafold2_tpu_torch.train import loop

    cfg = _train_mesh_cfg(dict(fields, grid_parallel=True) if grid else fields)
    batches = _synthetic(cfg, TRAIN_MESH_STEPS)
    runs = {"meshless": None, "(1, 1)": sharding.make_mesh(1, 1)}
    if grid:
        runs["1x1x1"] = make_grid_mesh(1, 1, 1)
    watched = list(runs)[-1]
    states = {k: loop.init_state(cfg, loop.build_model(cfg)) for k in runs}
    steps = {k: loop.make_train_step(states[k].model, mesh) for k, mesh in runs.items()}
    census = None

    def one(name, i):
        nonlocal census
        batch = loop.device_put_batch(batches[i], "cuda", runs[name])
        if name == watched and i == 1:
            c0 = sharding.census()
        states[name], m, ms, peak = _timed_step(steps[name], states[name], batch)
        if name == watched and i == 1:
            census = {k: v["count"] for k, v in
                      sharding.census_delta(c0, sharding.census()).items()}
        require(bool(m["grads_ok"]), f"{label} {name} step {i}: gradients not finite")
        return float(m["loss"]), _grads(states[name].model), ms, peak

    out, text = _in_turns(label, runs, one)
    out["census"] = census
    log(f"[train_mesh] (a) {label}, dim {cfg.model.dim}, depth {cfg.model.depth}, crop "
        f"{cfg.data.crop_len}, {TRAIN_MESH_STEPS} steps each in turns: {text}; launches on "
        f"{watched} {out['launches'][watched]}; census of one {watched} step {census}")
    del states, steps
    _free()
    return out


def _train_mesh_templates():
    """(a) templates: the tied model at the training width with 2 template
    blocks and TRAIN_MESH_TEMPLATES templates (crop 128, MSA 5x64),
    meshless, meshless again and on a (1, 1) mesh from the same weights and
    inputs, TRAIN_MESH_STEPS forward and backward passes each in turns
    (``_template_step``, ``_in_turns``). The second meshless run shows
    what two meshless passes share bit for bit: ``template_dist_emb``'s
    gradient (65,536 lookups of 37 rows) is summed in no fixed order by
    the CUDA embedding backward."""
    import torch

    from alphafold2_tpu_torch.parallel import sharding
    from alphafold2_tpu_torch.predict import init_params

    runs = {"meshless": None, "meshless again": None, "(1, 1)": sharding.make_mesh(1, 1)}
    weights = init_params(_template_model(False, depth=ENGINE_DEPTH, crop=128), 5).state_dict()
    models = {}
    for name in runs:
        models[name] = _template_model(False, depth=ENGINE_DEPTH, crop=128)
        models[name].load_state_dict(weights)
        models[name].cuda()
    inputs = _template_inputs(128, (5, 64), TRAIN_MESH_TEMPLATES, False, "cuda")

    def one(name, i):
        mesh = runs[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with sharding.use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
            loss = float(_template_step(models[name], inputs))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return loss, _grads(models[name]), ms, torch.cuda.max_memory_allocated()

    out, text = _in_turns("templates", runs, one, unit="pass")
    log(f"[train_mesh] (a) templates ({TRAIN_MESH_TEMPLATES} templates, 2 template blocks), "
        f"dim 256, depth {ENGINE_DEPTH}, crop 128, tied, {TRAIN_MESH_STEPS} forward and "
        f"backward passes each in turns: {text}; launches on (1, 1) "
        f"{out['launches']['(1, 1)']}")
    del models
    _free()
    return out


def _k3_slice_check(label, which, args, got):
    """One K3a or K3b call of the main path held against its plain version
    on the same operands: a slice of its batch rows (the first and the
    last) and, for K3a, of its queries over every key, for K3b of its keys
    over every query, as many as K3_CHECK_LOGITS_BYTES of f32 logits
    allow. The kernel phase's bf16 tolerance."""
    import torch

    from alphafold2_tpu_torch.ops.cuda import axial

    q, k, v, do, lse, dsum, q_mask, kv_mask, scale = args
    b, h, nq, d = q.shape
    nk = k.shape[2]
    bi = torch.tensor(sorted({0, b - 1}), device=q.device)
    rows = lambda t: t.index_select(0, bi) if t is not None else None  # noqa: E731
    q, k, v, do, lse, dsum = map(rows, (q, k, v, do, lse, dsum))
    q_mask, kv_mask = rows(q_mask), rows(kv_mask)
    long_n = nk if which == "dq" else nq
    short_n = nq if which == "dq" else nk
    n_sl = max(2, min(short_n, K3_CHECK_LOGITS_BYTES // (len(bi) * h * long_n * 4)))
    idx = torch.tensor(sorted(set(range(n_sl // 2)) | set(range(short_n - (n_sl - n_sl // 2),
                                                                  short_n))), device=q.device)
    splits = axial.grad_splits(b, h, nq, nk, d, which)
    what = (f"{label} ({b} x {h}, {nq} x {nk}, d{d}; {splits} splits of at most "
            f"{-(-(-(-(nk if which == 'dq' else nq) // axial.GRAD_TILE)) // splits)} tiles): "
            f"rows {bi.tolist()}, {len(idx)} {'queries' if which == 'dq' else 'keys'}")
    if which == "dq":
        sel = lambda t: t.index_select(2, idx)  # noqa: E731
        ref = axial.fused_attention_dq_reference(
            sel(q), k, v, sel(do), lse.index_select(2, idx), dsum.index_select(2, idx),
            q_mask.index_select(1, idx) if q_mask is not None else None, kv_mask, scale)
        rows_out = [_compare(what, "fused_attention_bwd_dq", rows(got[0]).index_select(2, idx),
                             ref, q.dtype)]
    else:
        sel = lambda t: t.index_select(2, idx)  # noqa: E731
        ref = axial.fused_attention_dkv_reference(
            q, sel(k), sel(v), do, lse, dsum, q_mask,
            kv_mask.index_select(1, idx) if kv_mask is not None else None, scale)
        rows_out = [_compare(what, f"fused_attention_bwd_dkv ({n})",
                             rows(g).index_select(2, idx), r, q.dtype)
                    for n, g, r in zip(("dk", "dv"), got, ref)]
    return [{**r, "shape": [b, h, nq, nk, d], "splits": splits} for r in rows_out]


def _watch_k3(label, fn):
    """``fn()`` with K3's launches watched (``ops/cuda/axial.py``
    ``_launch_backward``, which K3a's and K3b's wrappers call): the first
    call of each operand signature whose streamed loop is the long one (at
    least 2**16 rows) is held against the plain version
    (``_k3_slice_check``) once it has written its outputs. Returns the
    checks."""
    from alphafold2_tpu_torch.ops.cuda import axial

    real = axial._launch_backward
    seen, checks = set(), []

    def call(which, outs, slots, q, k, v, dout, lse, dsum, q_mask, kv_mask, sm_scale):
        hopper = real(which, outs, slots, q, k, v, dout, lse, dsum, q_mask, kv_mask, sm_scale)
        streamed = k.shape[2] if which == "dq" else q.shape[2]
        sig = (which, tuple(q.shape), tuple(k.shape))
        if streamed >= 1 << 16 and sig not in seen:
            seen.add(sig)
            checks.extend(_k3_slice_check(
                label, which, (q, k, v, dout, lse, dsum, q_mask, kv_mask, sm_scale), outs))
        return hopper

    axial._launch_backward = call
    try:
        fn()
    finally:
        axial._launch_backward = real
    return checks


def _train_mesh_long(sparse):
    """(b): the long crop with remat on a 1x1x1 grid: the meshless step's
    peak first, then TRAIN_MESH_LONG_STEPS mesh steps (finite, not skipped;
    peak; ms), K3a and K3b held at the merged MSA<-pair and the pair<-MSA
    backward's own call shapes in the last one."""
    import statistics

    import torch

    from alphafold2_tpu_torch.parallel.grid_parallel import make_grid_mesh
    from alphafold2_tpu_torch.train import loop

    label = f"crop {TRAIN_MESH_LONG['crop']} {'sparse' if sparse else 'dense'}"
    cfg = _train_mesh_cfg({"remat": True, "grid_parallel": True, "sparse_self_attn": sparse},
                          crop_len=TRAIN_MESH_LONG["crop"], msa_len=TRAIN_MESH_LONG["msa_len"],
                          min_len_filter=TRAIN_MESH_LONG["min_len"])
    batches = _synthetic(cfg, TRAIN_MESH_LONG_STEPS)
    st = loop.init_state(cfg, loop.build_model(cfg))
    step = loop.make_train_step(st.model)
    st, m, meshless_ms, meshless_peak = _timed_step(
        step, st, loop.device_put_batch(batches[0], "cuda"))
    require(meshless_peak <= 0.9 * torch.cuda.get_device_properties(0).total_memory,
            f"{label}: the meshless step peaks at {meshless_peak / 2**30:.2f} GiB")
    meshless_loss = float(m["loss"])
    del st, step
    _free()
    mesh = make_grid_mesh(1, 1, 1)
    st = loop.init_state(cfg, loop.build_model(cfg))
    step = loop.make_train_step(st.model, mesh)
    read = _train_counts()
    times, peak, losses, checks = [], 0, [], []
    for i, batch_np in enumerate(batches):
        batch = loop.device_put_batch(batch_np, "cuda", mesh)
        holder = {}

        def run():
            holder["r"] = _timed_step(step, st, batch)

        if i == len(batches) - 1:  # the watched step: its plain checks count nowhere
            launches = read()
            checks = _watch_k3(f"[train_mesh] (b) {label}", run)
        else:
            run()
            times.append(holder["r"][2])
            peak = max(peak, holder["r"][3])
        m = holder["r"][1]
        require(math.isfinite(float(m["loss"])) and bool(m["grads_ok"])
                and int(m["skipped"]) == 0, f"{label} step {i}: {float(m['loss'])}")
        losses.append(float(m["loss"]))
    _require_training_hopper(launches, f"[train_mesh] (b) {label}")
    kinds = {(c["kernel"], tuple(c["shape"])) for c in checks}
    require(any(c["kernel"] == "fused_attention_bwd_dq" for c in checks)
            and any(c["kernel"].startswith("fused_attention_bwd_dkv") for c in checks),
            f"{label}: K3a or K3b not held at the long call shapes ({kinds})")
    out = {"meshless_ms": meshless_ms, "meshless_peak_bytes": meshless_peak,
           "meshless_loss": meshless_loss, "losses": losses,
           "ms": statistics.median(times[1:]), "peak_bytes": peak, "launches": launches,
           "k3_checks": checks}
    log(f"[train_mesh] (b) {label}, MSA 5x{TRAIN_MESH_LONG['msa_len']}, remat, depth "
        f"{cfg.model.depth}: meshless step {meshless_ms:.1f} ms, peak "
        f"{meshless_peak / 2**30:.2f} GiB, loss {meshless_loss:.6f}; 1x1x1 grid losses "
        f"{' '.join(f'{x:.6f}' for x in losses)}, step {out['ms']:.1f} ms (step 2 of "
        f"{len(batches)}, the last one watched), peak {peak / 2**30:.2f} GiB (steps 1-2); "
        f"launches of steps 1-2 {launches}")
    del st, step
    _free()
    return out


def _train_mesh_rank_reference(tmp):
    """(c)'s reference, on this world-size-1 rank: each TRAIN_MESH_RANK_RUNS
    configuration meshless on the same global batches, each step's loss and
    gradients and the parameters after each, saved under ``tmp``."""
    import torch

    from alphafold2_tpu_torch.train import loop

    for label, (_, fields) in TRAIN_MESH_RANK_RUNS.items():
        cfg = _train_mesh_cfg(fields, crop_len=64, batch_size=2)
        cfg.model.depth = 2
        st = loop.init_state(cfg, loop.build_model(cfg))
        step = loop.make_train_step(st.model)
        ref = []
        for batch_np in _synthetic(cfg, TRAIN_MESH_RANK_STEPS):
            st, m = step(st, loop.device_put_batch(batch_np, "cuda"))
            ref.append({"loss": float(m["loss"]), "grads": _grads(st.model)})
        torch.save(ref, os.path.join(tmp, f"reference {label}.pt"))
        del st, step
    _free()


def _train_mesh_e2e(reversible=False):
    """(d): the end-to-end step at the CLI's width (with ``reversible`` on
    the reversible engine) meshless and on a (1, 1) mesh,
    TRAIN_MESH_E2E_STEPS steps each from the same state, batch and MDS
    start, in turns: the structure loss and every gradient within
    E2E_GRAD_REL_L2 of the meshless step's."""
    import torch

    from alphafold2_tpu_torch.parallel import sharding
    from alphafold2_tpu_torch.train import end2end, loop

    cfg = _e2e_config(False)
    cfg.model.reversible = reversible
    tag = "(d reversible)" if reversible else "(d)"
    batch_np = _synthetic(cfg, 1)[0]
    runs = {"meshless": None, "(1, 1)": sharding.make_mesh(1, 1)}
    states = {k: loop.init_state(cfg, end2end.build_end2end_model(cfg)) for k in runs}
    steps = {k: end2end.make_end2end_step(states[k].model, mesh) for k, mesh in runs.items()}
    batch = loop.batch_to_device(batch_np, torch.device("cuda"))
    b, n = batch_np["seq"].shape
    read = _train_counts()
    worst, rec, launches = 0.0, {k: [] for k in runs}, {}
    for i in range(TRAIN_MESH_E2E_STEPS):
        coords0 = end2end.mds_start(cfg.train.seed + 1, i, b, 3 * n, "cuda")
        ref = None
        for name in runs:
            before = read()
            states[name], m = steps[name](states[name], batch, coords0)
            if name != "meshless":
                for k, v in _count_delta(before, read()).items():
                    launches[k] = launches.get(k, 0) + v
            loss = float(m["loss"])
            require(math.isfinite(loss) and bool(m["grads_ok"]), f"e2e {name} step {i}")
            rec[name].append(loss)
            grads = _grads(states[name].model)
            if ref is None:
                ref = (loss, grads)
                continue
            require(abs(loss - ref[0]) <= E2E_GRAD_REL_L2 * abs(ref[0]),
                    f"[train_mesh] {tag} step {i}: loss {loss} vs meshless {ref[0]}")
            err, leaf, sym = _leaf_errors(ref[1], grads)
            worst = max(worst, err)
            require(err <= E2E_GRAD_REL_L2 and sym <= E2E_ZERO_GRAD_ATOL,
                    f"[train_mesh] {tag} step {i}: gradient {leaf} rel L2 {err:.3e}")
    _require_training_hopper(launches, f"[train_mesh] {tag}")
    log(f"[train_mesh] {tag} end to end at dim {cfg.model.dim}, depth {cfg.model.depth}, crop "
        f"{cfg.data.crop_len}, {TRAIN_MESH_E2E_STEPS} steps each in turns: structure losses "
        + "; ".join(f"{k} {' '.join(f'{x:.6f}' for x in v)}" for k, v in rec.items())
        + f"; every gradient against meshless worst rel L2 {worst:.3e} (tol "
        f"{E2E_GRAD_REL_L2}); launches on (1, 1) {launches}")
    del states, steps
    _free()
    return {"losses": rec, "worst_grad_rel_l2": worst, "launches": launches}


def train_mesh_rank(tmp) -> int:
    """The body of phase_train_mesh's world-size-1 NCCL rank (run as its
    subprocess, with torchrun's environment): (a), (b), (c)'s reference and
    (d); the record to ``tmp``/train_mesh.json."""
    import torch
    import torch.distributed as dist

    from alphafold2_tpu_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    require(distributed.initialize(), "torchrun's environment initialised no process group")
    require(dist.get_world_size() == 1 and dist.get_backend() == "nccl",
            f"expected one NCCL rank, got {dist.get_world_size()} {dist.get_backend()}")
    try:
        out = {"a": {label: _train_mesh_world1(label, fields)
                     for label, fields in TRAIN_MESH_CONFIGS.items()}}
        out["a"].update({label: _train_mesh_world1(label, fields, grid=False)
                         for label, fields in TRAIN_MESH_LINE_CONFIGS.items()})
        out["a"]["templates"] = _train_mesh_templates()
        out["b"] = {("sparse" if sparse else "dense"): _train_mesh_long(sparse)
                    for sparse in (False, True)}
        _train_mesh_rank_reference(tmp)
        out["d"] = _train_mesh_e2e()
        out["d reversible"] = _train_mesh_e2e(reversible=True)
        with open(os.path.join(tmp, "train_mesh.json"), "w", encoding="utf-8") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()
    return 0


def train_mesh_gloo_rank(tmp) -> int:
    """The body of one rank of phase_train_mesh's (c): a gloo group on CUDA
    tensors over TRAIN_MESH_RANKS ranks of the one card; each
    TRAIN_MESH_RANK_RUNS configuration on its mesh from the seeded initial
    state, TRAIN_MESH_RANK_STEPS steps on the global batches (this rank's
    dp slice), each held against the world-size-1 rank's meshless step
    (loss, every gradient summed over the world), the parameters
    bit-identical on every rank after each step, every launch on Hopper.
    reduce_scatter_tensor is probed first on CUDA tensors."""
    import hashlib

    import torch
    import torch.distributed as dist

    from alphafold2_tpu_torch.parallel import sharding
    from alphafold2_tpu_torch.train import loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}",
                            rank=rank, world_size=world)
    out = {"rank": rank, "runs": {}}
    try:
        for label, (spec, fields) in TRAIN_MESH_RANK_RUNS.items():
            cfg = _train_mesh_cfg(fields, crop_len=64, batch_size=2)
            cfg.model.depth = 2
            mesh = sharding.parse_mesh_spec(spec)
            st = loop.init_state(cfg, loop.build_model(cfg))
            step = loop.make_train_step(st.model, mesh)
            ref = torch.load(os.path.join(tmp, f"reference {label}.pt"), weights_only=False)
            read = _train_counts()
            rec = {"losses": [], "grad_rel_l2": [], "same": [], "ms": []}
            t0 = time.perf_counter()
            c0 = sharding.census()
            for i, batch_np in enumerate(_synthetic(cfg, TRAIN_MESH_RANK_STEPS)):
                t_step = time.perf_counter()
                st, m = step(st, loop.device_put_batch(batch_np, "cuda", mesh))
                torch.cuda.synchronize()
                rec["ms"].append((time.perf_counter() - t_step) * 1e3)
                grads = loop.reduce_gradients(
                    [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in st.model.parameters()], mesh)
                got = {n: g.detach().float().cpu()
                       for (n, _), g in zip(st.model.named_parameters(), grads)}
                err, leaf, _ = _leaf_errors(ref[i]["grads"], got)
                loss = float(m["loss"])
                rec["losses"].append(loss)
                rec["grad_rel_l2"].append(err)
                flat = torch.cat([p.detach().reshape(-1) for p in st.model.parameters()])
                digest = hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()
                every = [None] * world
                dist.all_gather_object(every, digest)
                rec["same"].append(len(set(every)) == 1)
                want = ref[i]["loss"]
                require(abs(loss - want) <= TRAIN_MESH_RANK_LOSS_REL * abs(want),
                        f"rank {rank} {label} step {i}: loss {loss} vs {want}")
                require(err <= TRAIN_MESH_RANK_GRAD_REL_L2,
                        f"rank {rank} {label} step {i}: gradient {leaf} rel L2 {err:.3e}")
                require(rec["same"][-1], f"rank {rank} {label} step {i}: parameters parted")
            launches = read()
            rec["census"] = {k: v["count"] for k, v in
                             sharding.census_delta(c0, sharding.census()).items()}
            rec["launches"] = launches
            rec["seconds"] = time.perf_counter() - t0
            _require_training_hopper(launches, f"[train_mesh ranks] rank {rank} {label}")
            out["runs"][label] = rec
            log(f"[train_mesh ranks] rank {rank} of {world} (gloo, CUDA tensors, "
                f"{sharding.describe_mesh(mesh)}) {label}: losses "
                f"{' '.join(f'{x:.6f}' for x in rec['losses'])} vs world size 1 "
                f"{' '.join(f'{r['loss']:.6f}' for r in ref)}; gradients worst rel L2 "
                f"{max(rec['grad_rel_l2']):.3e} (tol {TRAIN_MESH_RANK_GRAD_REL_L2}); "
                f"parameters the same on every rank: {all(rec['same'])}; step ms "
                f"{' '.join(f'{x:.1f}' for x in rec['ms'])}; launches {launches}; "
                f"census {rec['census']}")
            del st, step
        with open(os.path.join(tmp, f"train_rank{rank}.json"), "w", encoding="utf-8") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()
    return 0


def _train_mesh_ranks(tmp):
    """(c): TRAIN_MESH_RANKS gloo processes on the one card
    (``train_mesh_gloo_rank``); returns each rank's record."""
    t0 = time.perf_counter()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import sys, chip_smoke as c; sys.exit(c.train_mesh_gloo_rank(sys.argv[1]))", tmp],
        cwd=HERE, env=_rank_env(r, TRAIN_MESH_RANKS, port)) for r in range(TRAIN_MESH_RANKS)]
    deadline = time.monotonic() + TRAIN_MESH_TIMEOUT_S
    try:
        codes = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    require(codes == [0] * TRAIN_MESH_RANKS, f"the {TRAIN_MESH_RANKS} ranks exited {codes}")
    ranks = []
    for r in range(TRAIN_MESH_RANKS):
        with open(os.path.join(tmp, f"train_rank{r}.json"), encoding="utf-8") as fh:
            ranks.append(json.load(fh))
    log(f"[train_mesh ranks] {TRAIN_MESH_RANKS} ranks on the one card took "
        f"{time.perf_counter() - t0:.1f} s")
    return ranks


def phase_train_mesh():
    """Training on a device mesh (log tags ``[train_mesh]``,
    ``[train_mesh ranks]``).

    One rank of a world-size-1 NCCL group in a subprocess started with
    torchrun's environment (``train_mesh_rank``):
    (a) the training smoke's width (dim 256, depth ENGINE_DEPTH, bf16, crop
    128, MSA 5x64), dense, tied and sparse, meshless, on a (1, 1) mesh and on a
    1x1x1 grid in turns (``_train_mesh_world1``); the reversible engine,
    untied and tied, meshless and on the (1, 1) mesh; a template pass
    (``_train_mesh_templates``); (b) crop 768 with MSA
    5x128 and remat on a 1x1x1 grid, dense and sparse, the meshless step's
    peak first, K3 held at the long passes' call shapes
    (``_train_mesh_long``); (c)'s reference steps; (d) the end-to-end step
    at the CLI's width meshless and on a (1, 1) mesh, then on the
    reversible engine (``_train_mesh_e2e``).
    Then (c): TRAIN_MESH_RANKS gloo ranks on the one card
    (``_train_mesh_ranks``), a 1x2x2 grid sparse with tied rows, a 2x2
    (dp, sp) mesh dense and one reversible with tied rows, against the
    world-size-1 rank's steps."""
    import gc
    import tempfile

    import torch

    t0 = time.perf_counter()
    if torch.cuda.is_initialized():  # the ranks are other processes on the same card
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, "-c",
             "import sys, chip_smoke as c; sys.exit(c.train_mesh_rank(sys.argv[1]))", tmp],
            cwd=HERE, env=_rank_env(0, 1, _free_port()), timeout=TRAIN_MESH_TIMEOUT_S)
        require(proc.returncode == 0, f"the training mesh rank exited {proc.returncode}")
        with open(os.path.join(tmp, "train_mesh.json"), encoding="utf-8") as fh:
            result = json.load(fh)
        result["ranks"] = _train_mesh_ranks(tmp)
    result["seconds"] = time.perf_counter() - t0
    log(f"[train_mesh] phase took {result['seconds']:.1f} s")
    return result


# ------------------------------------------- MSA rows sharded over a mesh

# (a) the serving width (Config(): dim 256, heads 8, dim_head 64, bf16; crop
# 128, MSA 5x64, batch 1) at MSA_ROWS_DEPTH, tied rows, msa_row_shard: the
# MSA stream (R*D 320) and the PLM stream (its 128 grid rows, R*D 8192)
MSA_ROWS_DEPTH = 3
MSA_ROWS_STEPS = 3  # each meshless, (1, 1) and 1x1x1 step, in turns
MSA_ROWS_STREAMS = ("MSA", "PLM")
# the split route against the fused K2 of the meshless step: the four
# training ranks' bounds (TRAIN_MESH_RANK_*), bf16 partials summed in another
# order
MSA_ROWS_LOSS_REL = 1e-2
MSA_ROWS_GRAD_REL_L2 = 0.05
# (b) each split pass against its plain version: the MSA stream's tied pass
# (all 5 rows at world size 1), 1 and 3 local rows of it, the PLM grid's
MSA_ROWS_MAIN_LABEL = "MSA rows (1x5x64x8x64, R*D 320)"
MSA_ROWS_PLM_LABEL = "PLM grid rows (1x128x128x8x64, R*D 8192)"
MSA_ROWS_KERNEL_CASES = {MSA_ROWS_MAIN_LABEL: (1, 5, 64, 8, 64),
                         "1 local row (1x1x64x8x64)": (1, 1, 64, 8, 64),
                         "3 local rows (1x3x64x8x64)": (1, 3, 64, 8, 64),
                         MSA_ROWS_PLM_LABEL: (1, 128, 128, 8, 64)}
MSA_ROWS_TIMED = (MSA_ROWS_MAIN_LABEL, MSA_ROWS_PLM_LABEL)  # each pass timed at these
# (c) four gloo ranks on the one card at depth 2, crop 64, batch 1: the PLM
# stream on a (1, 4) mesh (its 64 grid rows, 16 a rank) and the MSA stream
# with MSA 5 rows on a 1x2x2 grid (3 rows a rank, one of them padding)
MSA_ROWS_RANKS = 4
MSA_ROWS_RANK_RUNS = {"(1, 4) PLM tied": ("1x4", "PLM", 1),
                      "1x2x2 MSA 5 tied": ("1x2x2", "MSA", 1)}
MSA_ROWS_RANK_STEPS = 2
# then each rank's peak at a crop where the O(N^2) grid outweighs the
# parameters and optimizer state: both streams, depth 2, one step each on
# the (1, 4) mesh, rows sharded and replicated (msa_row_shard off)
MSA_ROWS_MEM_CROP = 256
MSA_ROWS_MEM_MESH = "1x4"
# (d) serving at bucket 128 x 4 on the world-size-1 mesh, at this depth
MSA_ROWS_SERVE_DEPTH = 2
MSA_ROWS_SERVE_LENGTHS = (100, 113, 121, 128)


def _split_wrappers():
    from alphafold2_tpu_torch.ops.cuda import tied_row

    return {fn.__name__: fn for fn in tied_row.SPLIT_PASSES}


def _msa_rows_cfg(stream, depth=MSA_ROWS_DEPTH, crop=128, row_shard=True, **model):
    from alphafold2_tpu_torch.config import Config

    cfg = Config()
    cfg.model.depth = depth
    cfg.model.msa_tie_row_attn = True
    cfg.model.msa_row_shard = row_shard
    cfg.model.grid_parallel = True
    for k, v in model.items():
        setattr(cfg.model, k, v)
    cfg.data.crop_len = crop
    cfg.data.min_len_filter = min(cfg.data.min_len_filter, crop)
    if stream == "PLM":
        cfg.data.features, cfg.data.plm_provider = "plm", "hash"
    cfg.train.gradient_accumulate_every = 1
    cfg.train.warmup_steps = 1
    return cfg


def _msa_rows_batches(cfg, n, batch_size=None):
    """The first ``n`` numpy batches of ``cfg``'s stream (the PLM stream's
    with their hash-provider ``embedds``)."""
    import itertools

    from alphafold2_tpu_torch.data.pipeline import SyntheticDataset
    from alphafold2_tpu_torch.train import loop

    if batch_size is not None:
        cfg.data.batch_size = batch_size
    it = loop.apply_features(iter(SyntheticDataset(cfg.data, seed=cfg.train.seed)), cfg)
    return list(itertools.islice(it, n))


def _msa_rows_state(cfg, batches):
    from alphafold2_tpu_torch.train import loop

    model = loop.build_model(cfg, num_embedds=loop.embedds_width(batches[0]))
    return loop.init_state(cfg, model)


def _split_expected(depth, steps):
    """Split-pass launches over ``steps`` tied steps of ``depth`` layers:
    a layer's tied pass runs logits, softmax and P V' forward, dP, the grad
    pass and three products backward."""
    return {"tied_split_logits": 2 * depth * steps, "tied_split_softmax": depth * steps,
            "tied_split_grad": depth * steps, "tied_split_product": 4 * depth * steps}


def _require_split_route(counts, depth, steps, what):
    """Every K2 launch of a row-sharded tied step on the split passes, on
    the Hopper route where it has one: no fused K2 (forward or backward)
    and no plain version."""
    for name, want in _split_expected(depth, steps).items():
        require(counts.get(name, 0) == want,
                f"{what}: {counts.get(name, 0)} {name} launches, expected {want}")
        if f"{name} sm90" in counts:
            require(counts[f"{name} sm90"] == counts[name],
                    f"{what}: {name} off its Hopper route")
    for name in ("tied_row_attention", "tied_row_attention_bwd_dq", "tied_row_attention_bwd_dkv"):
        require(counts.get(name, 0) == 0, f"{what}: the fused {name} ran on a row-sharded step")
    require(counts["plain_calls"] == 0, f"{what}: a plain version ran")


def _split_step_flops(step, state, batch_np, mesh):
    """One row-sharded tied step on a (1, 1) mesh counted on the split
    passes and under tied_row=dense (TiedRowsSharded on the passes' plain
    versions, the same Function): the two counts equal within FLOPS_REL,
    the logits and product passes tallied (the backward's on autograd's
    device thread)."""
    from alphafold2_tpu_torch.observe import flops
    from alphafold2_tpu_torch.ops import kernels as kernel_policy
    from alphafold2_tpu_torch.train import loop

    batch = loop.device_put_batch(batch_np, "cuda", mesh)
    _, kernels = flops.count_call(step, state, batch, device="cuda")
    with kernel_policy.use_kernel_policy(kernel_policy.parse_policy("tied_row=dense")):
        _, plain = flops.count_call(step, state, batch, device="cuda")
    rel = _rel(kernels.flops, plain.flops)
    log(f"[msa_rows] (a) one row-sharded MSA step counted on the split passes "
        f"{kernels.flops:.6e} flops (tallies " + ", ".join(
            f"{k} {v:.4e}" for k, v in sorted(kernels.kernel_flops.items()))
        + f"), under tied_row=dense {plain.flops:.6e} (rel {rel:.2e})")
    require(rel <= FLOPS_REL, f"[msa_rows] the split route's count {kernels.flops} is not "
            f"the plain passes' {plain.flops}")
    for name in ("tied_split_logits", "tied_split_product"):
        require(kernels.kernel_flops.get(name, 0) > 0, f"[msa_rows] no {name} tally")
    return {"flops": kernels.flops, "plain_flops": plain.flops, "rel": rel,
            "kernel_flops": kernels.kernel_flops}


def _msa_rows_world1(stream):
    """(a): one stream meshless, on a (1, 1) mesh and on a 1x1x1 grid under
    msa_row_shard, MSA_ROWS_STEPS steps each from the same initial state
    and batches, in turns; each mesh step's loss and every gradient against
    the meshless step's, step ms, peak, launches by kernel."""
    import statistics

    from alphafold2_tpu_torch.parallel import sharding
    from alphafold2_tpu_torch.parallel.grid_parallel import make_grid_mesh
    from alphafold2_tpu_torch.train import loop

    cfg = _msa_rows_cfg(stream)
    batches = _msa_rows_batches(cfg, MSA_ROWS_STEPS)
    runs = {"meshless": None, "(1, 1)": sharding.make_mesh(1, 1),
            "1x1x1": make_grid_mesh(1, 1, 1)}
    states = {k: _msa_rows_state(cfg, batches) for k in runs}
    steps = {k: loop.make_train_step(states[k].model, mesh) for k, mesh in runs.items()}
    read = _train_counts()
    launches = {k: {} for k in runs}
    rec = {k: {"ms": [], "peak": 0, "losses": []} for k in runs}
    worst = 0.0
    for i, batch_np in enumerate(batches):
        ref = None
        for name, mesh in runs.items():
            batch = loop.device_put_batch(batch_np, "cuda", mesh)
            before = read()
            states[name], m, ms, peak = _timed_step(steps[name], states[name], batch)
            for k, v in _count_delta(before, read()).items():
                launches[name][k] = launches[name].get(k, 0) + v
            loss = float(m["loss"])
            require(math.isfinite(loss) and bool(m["grads_ok"]), f"{stream} {name} step {i}")
            r = rec[name]
            r["losses"].append(loss)
            r["ms"].append(ms)
            r["peak"] = max(r["peak"], peak)
            grads = _grads(states[name].model)
            if ref is None:
                ref = (loss, grads)
                continue
            require(abs(loss - ref[0]) <= MSA_ROWS_LOSS_REL * abs(ref[0]),
                    f"[msa_rows] {stream} on {name}, step {i}: loss {loss} vs meshless {ref[0]}")
            err, leaf, _ = _leaf_errors(ref[1], grads)
            worst = max(worst, err)
            require(err <= MSA_ROWS_GRAD_REL_L2,
                    f"[msa_rows] {stream} on {name}, step {i}: gradient {leaf} rel L2 {err:.3e}")
    for name in ("(1, 1)", "1x1x1"):
        _require_split_route(launches[name], MSA_ROWS_DEPTH, MSA_ROWS_STEPS,
                             f"[msa_rows] {stream} on {name}")
    out = {"runs": {k: {"losses": r["losses"], "ms": statistics.median(r["ms"][1:]),
                        "peak_bytes": r["peak"]} for k, r in rec.items()},
           "launches": launches, "worst_grad_rel_l2": worst}
    if stream == "MSA":
        out["flops"] = _split_step_flops(steps["(1, 1)"], states["(1, 1)"], batches[0],
                                         runs["(1, 1)"])
    log(f"[msa_rows] (a) {stream} stream, msa_row_shard, tied, dim {cfg.model.dim}, depth "
        f"{cfg.model.depth}, crop {cfg.data.crop_len}, {MSA_ROWS_STEPS} steps each in turns: "
        f"losses " + "; ".join(f"{k} {' '.join(f'{x:.6f}' for x in r['losses'])}"
                              for k, r in rec.items())
        + f"; every gradient against meshless worst rel L2 {worst:.3e} (tol "
        f"{MSA_ROWS_GRAD_REL_L2}); step ms (median of steps 2-{MSA_ROWS_STEPS}) "
        + ", ".join(f"{k} {v['ms']:.2f}" for k, v in out["runs"].items())
        + "; peak GiB " + ", ".join(f"{k} {v['peak_bytes'] / 2**30:.3f}"
                                     for k, v in out["runs"].items())
        + "; launches (nonzero) " + "; ".join(
            f"{k} {({n: v for n, v in c.items() if v})}" for k, c in launches.items()))
    del states, steps
    _free()
    return out


def _split_operands(b, r, n, h, d, gen):
    import torch

    q, k, v, do = (torch.randn((b, r, n, h, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    mask = torch.ones((b, n), dtype=torch.bool, device="cuda")
    mask[:, n - n // 8:] = False  # padded columns, as the MSA's length padding
    return q, k, v, do, mask


def split_pass_case(label, shape, gen, reps=0):
    """Each split pass at one (b, r, n, h, d) shape, bf16, against its plain
    version on the same inputs (the plain forward's outputs feeding the
    next kernel, so each pass is held alone); with ``reps``, each timed
    (CUDA events) beside its plain version and the library call computing
    the same function (torch.matmul of the folded operands for the logits
    and products, torch.softmax for the softmax; the grad pass has none),
    and SDPA on the whole tied problem. Returns result rows."""
    import torch
    import torch.nn.functional as F

    from alphafold2_tpu_torch.ops.cuda import tied_row as k2

    b, r, n, h, d = shape
    q, k, v, do, mask = _split_operands(b, r, n, h, d, gen)
    scale, tie = d**-0.5, torch.full((b,), r**-0.5, device="cuda")
    f = r * d
    crop = lambda t: t[..., :n, :n]  # noqa: E731 — a padded plane's valid block
    rows = []

    def row(kernel, out, ref, fn, plain, ops, nbytes, library=None):
        res = _compare(f"{label}", kernel, out, ref, torch.bfloat16)
        if reps:
            res.update(ms=cuda_ms(fn, reps=reps), plain_ms=cuda_ms(plain, reps=1),
                       library_ms=cuda_ms(library, reps=reps) if library else None,
                       **_bound(ops, nbytes, torch.bfloat16))
        rows.append(dict(res, shape=list(shape)))

    s = k2.tied_split_logits(q, k)
    s_ref = k2.tied_split_logits_reference(q, k)
    qf, kf = k2._fold(q).to(torch.bfloat16), k2._fold(k).to(torch.bfloat16)
    plane = 4 * b * h * s.shape[2] * s.shape[3]
    row("tied_split_logits", crop(s), s_ref, lambda: k2.tied_split_logits(q, k),
        lambda: k2.tied_split_logits_reference(q, k), 2.0 * b * h * n * n * f,
        2 * 2 * b * r * n * h * d + plane, lambda: torch.matmul(qf, kf.transpose(-1, -2)))
    p, lse = k2.tied_split_softmax(s, n, n, mask, mask, scale, tie, torch.bfloat16)
    p_ref, lse_ref = k2.tied_split_softmax_reference(s_ref, n, n, mask, mask, scale, tie,
                                                     torch.bfloat16)
    live = torch.isfinite(lse_ref)
    require(bool(torch.equal(torch.isfinite(lse), live)), f"{label}: the softmax's dead rows")
    _compare(label, "tied_split_softmax (lse)", lse[live], lse_ref[live], torch.float32)
    row("tied_split_softmax", crop(p), p_ref,
        lambda: k2.tied_split_softmax(s, n, n, mask, mask, scale, tie, torch.bfloat16),
        lambda: k2.tied_split_softmax_reference(s_ref, n, n, mask, mask, scale, tie,
                                                torch.bfloat16),
        0.0, plane + 2 * b * h * s.shape[2] * s.shape[3] + 4 * b * h * n,
        lambda: torch.softmax(s * scale, dim=-1))
    out = k2.tied_split_product(p, v, n)
    vf = k2._fold(v).to(torch.bfloat16)
    a_bytes = 2 * b * h * p.shape[2] * p.shape[3]
    row("tied_split_product", out, k2.tied_split_product_reference(p_ref, v, n),
        lambda: k2.tied_split_product(p, v, n),
        lambda: k2.tied_split_product_reference(p_ref, v, n), 2.0 * b * h * n * n * f,
        a_bytes + 2 * 2 * b * r * n * h * d, lambda: torch.matmul(p, vf))
    dp = k2.tied_split_logits(do, v)
    dsum = k2.tied_row_dsum(out, do)
    grads = k2.tied_split_grad(s, dp, lse, dsum, n, n, mask, mask, scale, tie, torch.bfloat16)
    dp_ref = k2.tied_split_logits_reference(do, v)
    refs = k2.tied_split_grad_reference(s_ref, dp_ref, lse_ref, dsum, n, n, mask, mask, scale,
                                        tie, torch.bfloat16)
    for part, (g, g_ref) in zip(("dS", "dS^T", "P^T"), zip(grads, refs)):
        kernel = "tied_split_grad" if part == "dS" else f"tied_split_grad ({part})"
        if part == "dS":
            row(kernel, crop(g), g_ref,
                lambda: k2.tied_split_grad(s, dp, lse, dsum, n, n, mask, mask, scale, tie,
                                           torch.bfloat16),
                lambda: k2.tied_split_grad_reference(s_ref, dp_ref, lse_ref, dsum, n, n, mask,
                                                     mask, scale, tie, torch.bfloat16),
                0.0, 2 * plane + 3 * a_bytes + 8 * b * h * n)
        else:
            _compare(label, kernel, crop(g), g_ref, torch.bfloat16)
    for part, a, a_ref, x, sc in (("dq", grads[0], refs[0], k, (scale, tie)),
                                  ("dk", grads[1], refs[1], q, (scale, tie)),
                                  ("dv", grads[2], refs[2], do, None)):
        _compare(label, f"tied_split_product ({part})", k2.tied_split_product(a, x, n, sc),
                 k2.tied_split_product_reference(a_ref, x, n, sc), torch.bfloat16)
    if reps:  # SDPA's default scale F**-0.5 is the tied scale d**-0.5 * r**-0.5
        attn_mask = mask[:, None, None, :]
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(qf, kf, vf, attn_mask=attn_mask),
                       reps=reps)
        for rr in rows:
            rr["sdpa_whole_ms"] = sdpa
    return rows


def split_generic_case(label, shape, dtype, gen):
    """The split passes on their CUDA-core route (f32, or bf16 at a head
    dim the Hopper route does not take), composed into K2's forward and
    backward, against K2's plain forward (out, lse) and its plain dq, dk
    and dv, at the dtype's bound; the Hopper launch counts must not move."""
    import torch

    from alphafold2_tpu_torch.ops.cuda import tied_row as k2

    b, r, n, h, d = shape
    q, k, v, do = (torch.randn((b, r, n, h, d), generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    mask = torch.ones((b, n), dtype=torch.bool, device="cuda")
    mask[:, n - 5:] = False
    scale, tie = d**-0.5, torch.full((b,), r**-0.5, device="cuda")
    hopper = (k2.tied_split_logits.sm90_launches, k2.tied_split_product.sm90_launches)
    s = k2.tied_split_logits(q, k)
    p, lse = k2.tied_split_softmax(s, n, n, mask, mask, scale, tie, dtype)
    out = k2.tied_split_product(p, v, n)
    dsum = k2.tied_row_dsum(out, do)
    ds, ds_t, p_t = k2.tied_split_grad(s, k2.tied_split_logits(do, v), lse, dsum, n, n, mask,
                                       mask, scale, tie, dtype)
    got = (out, k2.tied_split_product(ds, k, n, (scale, tie)),
           k2.tied_split_product(ds_t, q, n, (scale, tie)), k2.tied_split_product(p_t, do, n))
    ref, ref_lse = k2.tied_row_attention_lse_reference(q, k, v, mask, mask, scale, tie)
    args = (q, k, v, do, ref_lse, dsum, mask, mask, scale, tie)
    want = (ref, k2.tied_row_attention_dq_reference(*args),
            *k2.tied_row_attention_dkv_reference(*args))
    require((k2.tied_split_logits.sm90_launches, k2.tied_split_product.sm90_launches) == hopper,
            f"{label}: a split pass took the Hopper route")
    return [_compare(label, f"tied_split_* ({part}, CUDA-core route)", g, w, dtype)
            for part, g, w in zip(("out", "dq", "dk", "dv"), got, want)]


def _watch_split(label, fn):
    """``fn()`` with the split passes watched: the first call of each pass
    at each operand shape is held against its plain version on the same
    inputs once it has returned. The checks run the plain versions, so the
    watched run's launches count nowhere. Returns the checks."""
    import torch

    from alphafold2_tpu_torch.ops.cuda import tied_row as k2

    real = {fn_.__name__: fn_ for fn_ in k2.SPLIT_PASSES}
    seen, checks = set(), []

    class Watched:
        """A pass wrapper's stand-in: calls go through ``call``, the count
        attributes (which the wrapper updates through its module name) to
        the wrapper itself."""

        def __init__(self, fn, call):
            object.__setattr__(self, "_fn", fn)
            object.__setattr__(self, "_call", call)

        def __call__(self, *args):
            return self._call(*args)

        def __getattr__(self, name):
            return getattr(self._fn, name)

        def __setattr__(self, name, value):
            setattr(self._fn, name, value)

    def watched(name, plain):
        def call(*args):
            out = real[name](*args)
            sig = (name, tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor)))
            if sig not in seen:
                seen.add(sig)
                ref = plain(*args)
                if name == "tied_split_softmax":
                    nq, nk = args[1], args[2]
                    checks.append(_compare(f"{label} {sig[1]}", name, out[0][..., :nq, :nk],
                                           ref[0], out[0].dtype))
                elif name == "tied_split_grad":
                    nq, nk = args[4], args[5]
                    checks.append(_compare(f"{label} {sig[1]}", name, out[0][..., :nq, :nk],
                                           ref[0], out[0].dtype))
                elif name == "tied_split_logits":
                    n_a, n_b = args[0].shape[2], args[1].shape[2]
                    checks.append(_compare(f"{label} {sig[1]}", name, out[..., :n_a, :n_b], ref,
                                           args[0].dtype))
                else:
                    checks.append(_compare(f"{label} {sig[1]}", name, out, ref, out.dtype))
            return out
        return Watched(real[name], call)

    plain = dict(zip(real, k2.SPLIT_PLAIN))
    for name in real:
        setattr(k2, name, watched(name, plain[name]))
    try:
        fn()
    finally:
        for name, f in real.items():
            setattr(k2, name, f)
    return checks


def _msa_rows_watched(stream):
    """One more row-sharded step of ``stream`` on a (1, 1) mesh with the
    split passes watched (``_watch_split``): every pass at the shapes the
    path gives it against its plain version."""
    from alphafold2_tpu_torch.parallel import sharding
    from alphafold2_tpu_torch.train import loop

    cfg = _msa_rows_cfg(stream)
    batches = _msa_rows_batches(cfg, 1)
    mesh = sharding.make_mesh(1, 1)
    st = _msa_rows_state(cfg, batches)
    step = loop.make_train_step(st.model, mesh)
    checks = _watch_split(f"[msa_rows] (b) {stream} step",
                          lambda: step(st, loop.device_put_batch(batches[0], "cuda", mesh)))
    require({c["kernel"] for c in checks} == set(_split_wrappers()),
            f"{stream}: not every split pass was held on the path")
    del st, step
    _free()
    return checks


def _msa_rows_rank_reference(tmp):
    """(c)'s reference on this world-size-1 rank: each MSA_ROWS_RANK_RUNS
    configuration meshless on the same batches, each step's loss and
    gradients, saved under ``tmp``."""
    import torch

    from alphafold2_tpu_torch.train import loop

    for label, (_, stream, batch_size) in MSA_ROWS_RANK_RUNS.items():
        cfg = _msa_rows_cfg(stream, depth=2, crop=64)
        batches = _msa_rows_batches(cfg, MSA_ROWS_RANK_STEPS, batch_size)
        require(stream == "PLM" or batches[0]["msa"].shape[1] == 5, "MSA depth is not 5")
        st = _msa_rows_state(cfg, batches)
        step = loop.make_train_step(st.model)
        ref = []
        for batch_np in batches:
            st, m = step(st, loop.device_put_batch(batch_np, "cuda"))
            ref.append({"loss": float(m["loss"]), "grads": _grads(st.model)})
        torch.save({"ref": ref, "batches": batches}, os.path.join(tmp, f"rows {label}.pt"))
        del st, step
    _free()


def _msa_rows_serving():
    """(d): on the world-size-1 mesh at bucket 128 x 4 (tied rows,
    msa_row_shard), the pipelined engine against the serial one and a
    two-replica fleet against the single engine: every result bit-equal."""
    import numpy as np

    from alphafold2_tpu_torch.parallel import sharding
    from alphafold2_tpu_torch.serve.engine import ServeEngine, ServeRequest
    from alphafold2_tpu_torch.serve.fleet import FleetFrontend

    mesh = sharding.make_mesh(1, 1)
    rng = np.random.default_rng(5)
    seqs = ["".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n)) for n in MSA_ROWS_SERVE_LENGTHS]
    reqs = [ServeRequest(s, seed=i) for i, s in enumerate(seqs)]
    out, results = {}, {}
    for depth in (0, 2):
        cfg = _serve_config(pipeline_depth=depth)
        cfg.model.depth = MSA_ROWS_SERVE_DEPTH
        cfg.model.msa_row_shard = True
        engine = ServeEngine(cfg, mesh=mesh) if depth == 0 else ServeEngine(
            cfg, mesh=mesh, model=results["model"])
        t0 = time.perf_counter()
        got = engine.predict_many(reqs)
        out[engine.pipeline_desc] = time.perf_counter() - t0
        require(all(r.ok for r in got), f"pipeline {depth}: {got}")
        results[depth] = got
        results.setdefault("model", engine.model)
        engine.close()
    same = all(np.array_equal(a.atom14, b.atom14) and np.array_equal(a.weights, b.weights)
               for a, b in zip(results[0], results[2]))
    require(same, "[msa_rows] (d) pipelined dispatch on the mesh differs from serial")
    fleet = FleetFrontend.build(cfg, 2, mesh=mesh, state_dict=results["model"].state_dict())
    try:
        t0 = time.perf_counter()
        got = [h.result(timeout=600) for h in [fleet.submit(r) for r in reqs]]
        out["fleet 2"] = time.perf_counter() - t0
        dispatched = [c.engine.counters.get("serve.batches") for c in fleet.cells]
    finally:
        fleet.close()
    fleet_same = all(r.ok and np.array_equal(r.atom14, b.atom14)
                     and np.array_equal(r.weights, b.weights)
                     for r, b in zip(got, results[0]))
    require(fleet_same, "[msa_rows] (d) the fleet on the mesh differs from one engine")
    log(f"[msa_rows] (d) serving on the world-size-1 mesh, bucket 128 x 4, depth "
        f"{MSA_ROWS_SERVE_DEPTH}, msa_row_shard: pipelined bit-equal to serial: {same}; a "
        f"two-replica fleet (dispatches {dispatched}) bit-equal to one engine: {fleet_same}; "
        f"seconds (with each rung's warm runs) " + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    _free()
    return {"seconds": out, "pipelined_equal": same, "fleet_equal": fleet_same,
            "fleet_dispatches": dispatched}


def msa_rows_rank(tmp) -> int:
    """The body of phase_msa_rows's world-size-1 NCCL rank (run as its
    subprocess, with torchrun's environment): (a), (b), (c)'s reference and
    (d); the record to ``tmp``/msa_rows.json."""
    import torch
    import torch.distributed as dist

    from alphafold2_tpu_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    require(distributed.initialize(), "torchrun's environment initialised no process group")
    require(dist.get_world_size() == 1 and dist.get_backend() == "nccl",
            f"expected one NCCL rank, got {dist.get_world_size()} {dist.get_backend()}")
    try:
        t0 = time.perf_counter()
        out = {"a": {s: _msa_rows_world1(s) for s in MSA_ROWS_STREAMS}}
        gen = torch.Generator(device="cuda").manual_seed(24)
        rows = []
        for label, shape in MSA_ROWS_KERNEL_CASES.items():
            rows += split_pass_case(label, shape, gen, reps=10 if label in MSA_ROWS_TIMED else 0)
        out["kernel_rows"] = rows
        out["generic"] = (split_generic_case("f32 (1x3x64x8x64)", (1, 3, 64, 8, 64),
                                             torch.float32, gen)
                          + split_generic_case("bf16 head dim 48 (1x3x64x8x48)",
                                               (1, 3, 64, 8, 48), torch.bfloat16, gen))
        out["b"] = {s: _msa_rows_watched(s) for s in MSA_ROWS_STREAMS}
        _msa_rows_rank_reference(tmp)
        out["d"] = _msa_rows_serving()
        out["seconds"] = time.perf_counter() - t0
        with open(os.path.join(tmp, "msa_rows.json"), "w", encoding="utf-8") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()
    return 0


def msa_rows_gloo_rank(tmp) -> int:
    """The body of one rank of phase_msa_rows's (c): a gloo group on CUDA
    tensors over MSA_ROWS_RANKS ranks of the one card; each
    MSA_ROWS_RANK_RUNS configuration under msa_row_shard on its mesh,
    MSA_ROWS_RANK_STEPS steps on the world-size-1 rank's batches, held
    against its meshless steps (loss, every gradient summed over the
    world), the parameters bit-identical on every rank after each step,
    every K2 launch on the split passes; then the PLM run's first step once
    more with the grid replicated (msa_row_shard off): each rank's peak
    beside the row-sharded one's; then both streams' peaks at
    MSA_ROWS_MEM_CROP (``_msa_rows_rank_memory``)."""
    import hashlib

    import torch
    import torch.distributed as dist

    from alphafold2_tpu_torch.parallel import sharding
    from alphafold2_tpu_torch.train import loop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}",
                            rank=rank, world_size=world)
    out = {"rank": rank, "runs": {}}
    try:
        for label, (spec, stream, _) in MSA_ROWS_RANK_RUNS.items():
            saved = torch.load(os.path.join(tmp, f"rows {label}.pt"), weights_only=False)
            ref, batches = saved["ref"], saved["batches"]
            rec = {"losses": [], "grad_rel_l2": [], "same": [], "peak_bytes": {}}
            for shard in ((True, False) if stream == "PLM" else (True,)):
                cfg = _msa_rows_cfg(stream, depth=2, crop=64, row_shard=shard)
                mesh = sharding.parse_mesh_spec(spec)
                st = _msa_rows_state(cfg, batches)
                step = loop.make_train_step(st.model, mesh)
                read = _train_counts()
                c0 = sharding.census()
                torch.cuda.reset_peak_memory_stats()
                for i, batch_np in enumerate(batches if shard else batches[:1]):
                    st, m = step(st, loop.device_put_batch(batch_np, "cuda", mesh))
                    torch.cuda.synchronize()
                    if not shard:
                        continue
                    grads = loop.reduce_gradients(
                        [p.grad if p.grad is not None else torch.zeros_like(p)
                         for p in st.model.parameters()], mesh)
                    got = {n: g.detach().float().cpu()
                           for (n, _), g in zip(st.model.named_parameters(), grads)}
                    err, leaf, _ = _leaf_errors(ref[i]["grads"], got)
                    loss = float(m["loss"])
                    rec["losses"].append(loss)
                    rec["grad_rel_l2"].append(err)
                    flat = torch.cat([p.detach().reshape(-1) for p in st.model.parameters()])
                    digest = hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()
                    every = [None] * world
                    dist.all_gather_object(every, digest)
                    rec["same"].append(len(set(every)) == 1)
                    want = ref[i]["loss"]
                    require(abs(loss - want) <= MSA_ROWS_LOSS_REL * abs(want),
                            f"rank {rank} {label} step {i}: loss {loss} vs {want}")
                    require(err <= MSA_ROWS_GRAD_REL_L2,
                            f"rank {rank} {label} step {i}: gradient {leaf} rel L2 {err:.3e}")
                    require(rec["same"][-1], f"rank {rank} {label} step {i}: parameters parted")
                rec["peak_bytes"]["rows sharded" if shard else "replicated"] = \
                    torch.cuda.max_memory_allocated()
                if shard:
                    rec["launches"] = read()
                    rec["census"] = {k: v["count"] for k, v in
                                     sharding.census_delta(c0, sharding.census()).items()}
                    _require_split_route(rec["launches"], 2, len(batches),
                                         f"[msa_rows ranks] rank {rank} {label}")
                del st, step
                _free()
            out["runs"][label] = rec
            log(f"[msa_rows ranks] rank {rank} of {world} (gloo, CUDA tensors, {spec}) {label}: "
                f"losses {' '.join(f'{x:.6f}' for x in rec['losses'])} vs world size 1 "
                f"{' '.join(f'{r['loss']:.6f}' for r in ref)}; gradients worst rel L2 "
                f"{max(rec['grad_rel_l2']):.3e} (tol {MSA_ROWS_GRAD_REL_L2}); parameters the "
                f"same on every rank: {all(rec['same'])}; peak GiB "
                + ", ".join(f"{k} {v / 2**30:.3f}" for k, v in rec["peak_bytes"].items())
                + f"; launches (nonzero) {({k: v for k, v in rec['launches'].items() if v})}; "
                f"census {rec['census']}")
        out["memory"] = _msa_rows_rank_memory(rank, world)
        with open(os.path.join(tmp, f"rows_rank{rank}.json"), "w", encoding="utf-8") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()
    return 0


def _msa_rows_rank_memory(rank, world):
    """This rank's peak over one step of each stream at MSA_ROWS_MEM_CROP on
    the MSA_ROWS_MEM_MESH mesh, rows sharded and replicated, from a fresh
    state each: {stream: {layout: {"peak_bytes", "resident_bytes"}}}, the
    resident bytes those held after the step (parameters, gradients and
    optimizer state)."""
    import torch

    from alphafold2_tpu_torch.parallel import sharding
    from alphafold2_tpu_torch.train import loop

    out = {}
    for stream in MSA_ROWS_STREAMS:
        out[stream] = {}
        for shard in (True, False):
            cfg = _msa_rows_cfg(stream, depth=2, crop=MSA_ROWS_MEM_CROP, row_shard=shard)
            batches = _msa_rows_batches(cfg, 1, 1)
            mesh = sharding.parse_mesh_spec(MSA_ROWS_MEM_MESH)
            st = _msa_rows_state(cfg, batches)
            step = loop.make_train_step(st.model, mesh)
            batch = loop.device_put_batch(batches[0], "cuda", mesh)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            st, m = step(st, batch)
            torch.cuda.synchronize()
            require(bool(m["grads_ok"]), f"rank {rank} memory {stream} {shard}: gradients not ok")
            layout = "rows sharded" if shard else "replicated"
            out[stream][layout] = {"peak_bytes": torch.cuda.max_memory_allocated(),
                                   "resident_bytes": torch.cuda.memory_allocated()}
            del st, step, batch, m
            _free()
        rec = out[stream]
        log(f"[msa_rows ranks] rank {rank} of {world} memory, {stream} stream, crop "
            f"{MSA_ROWS_MEM_CROP}, depth 2, {MSA_ROWS_MEM_MESH}, one step: peak GiB rows sharded "
            f"{rec['rows sharded']['peak_bytes'] / 2**30:.3f} vs replicated "
            f"{rec['replicated']['peak_bytes'] / 2**30:.3f} (resident after the step "
            f"{rec['rows sharded']['resident_bytes'] / 2**30:.3f} / "
            f"{rec['replicated']['resident_bytes'] / 2**30:.3f})")
    return out


def phase_msa_rows():
    """MSA rows sharded over a mesh (``model.msa_row_shard``; log tags
    ``[msa_rows]``, ``[msa_rows ranks]``).

    One rank of a world-size-1 NCCL group in a subprocess
    (``msa_rows_rank``): (a) the serving width, tied rows, the MSA stream
    and the PLM stream, meshless, on a (1, 1) mesh and on a 1x1x1 grid in
    turns (``_msa_rows_world1``): every K2 launch on the split passes;
    (b) each split pass against its plain version at the MSA stream's
    shape, 1 and 3 local rows and the PLM grid's (``split_pass_case``),
    timed at the MSA and PLM shapes, and at the shapes a step's path gives
    it (``_msa_rows_watched``); (c)'s reference; (d) pipelined dispatch and
    a two-replica fleet on the mesh (``_msa_rows_serving``). Then (c):
    MSA_ROWS_RANKS gloo ranks on the one card, the PLM stream on a (1, 4)
    mesh and MSA 5 rows on a 1x2x2 grid, against the world-size-1 steps."""
    import gc
    import tempfile

    import torch

    t0 = time.perf_counter()
    if torch.cuda.is_initialized():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, "-c",
             "import sys, chip_smoke as c; sys.exit(c.msa_rows_rank(sys.argv[1]))", tmp],
            cwd=HERE, env=_rank_env(0, 1, _free_port()), timeout=TRAIN_MESH_TIMEOUT_S)
        require(proc.returncode == 0, f"the msa_rows rank exited {proc.returncode}")
        with open(os.path.join(tmp, "msa_rows.json"), encoding="utf-8") as fh:
            result = json.load(fh)
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             "import sys, chip_smoke as c; sys.exit(c.msa_rows_gloo_rank(sys.argv[1]))", tmp],
            cwd=HERE, env=_rank_env(r, MSA_ROWS_RANKS, port)) for r in range(MSA_ROWS_RANKS)]
        deadline = time.monotonic() + TRAIN_MESH_TIMEOUT_S
        try:
            codes = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        require(codes == [0] * MSA_ROWS_RANKS, f"the {MSA_ROWS_RANKS} ranks exited {codes}")
        result["ranks"] = []
        for r in range(MSA_ROWS_RANKS):
            with open(os.path.join(tmp, f"rows_rank{r}.json"), encoding="utf-8") as fh:
                result["ranks"].append(json.load(fh))
    for r in result["kernel_rows"]:
        if "ms" in r:
            log(f"[msa_rows] time {r['kernel']} {r['label']}: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.3f} ms, library {r['library_ms']} ms, SDPA on the whole tied "
                f"problem {r['sdpa_whole_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of it)")
    result["seconds"] = time.perf_counter() - t0
    log(f"[msa_rows] phase took {result['seconds']:.1f} s")
    return result


def _split_entries(msa_rows):
    """The split passes' kernel-line entries: times at the MSA stream's tied
    pass (MSA_ROWS_MAIN_LABEL) and, in ``shapes``, at the PLM grid's;
    ``launches``: each pass's launches over (a)'s row-sharded MSA steps on
    the (1, 1) mesh; ``msa_rows_launches`` by run, the four ranks' too."""
    source = "alphafold2_tpu_torch/csrc/tied_row_attention.cu"
    replaces = {"tied_split_logits": "alphafold2_tpu/ops/pallas/tied_row.py:53",
                "tied_split_softmax": "alphafold2_tpu/ops/pallas/tied_row.py:53",
                "tied_split_grad": "alphafold2_tpu/ops/pallas/axial.py:275",
                "tied_split_product": "alphafold2_tpu/ops/pallas/tied_row.py:53"}
    rows, plm = msa_rows["kernel_rows"], MSA_ROWS_PLM_LABEL
    entries = []
    for name, rep in replaces.items():
        main = next(r for r in rows if r["kernel"] == name and r["label"] == MSA_ROWS_MAIN_LABEL)
        runs = {f"(a) {s} {mesh}": counts.get(name, 0)
                for s, a in msa_rows["a"].items() for mesh, counts in a["launches"].items()}
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": rep,
            "launches": msa_rows["a"]["MSA"]["launches"]["(1, 1)"].get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["kernel"].startswith(name)),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "sdpa_whole_ms": main["sdpa_whole_ms"],
            "shapes": {plm: {k: r.get(k) for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms", "max_abs_err")}
                       for r in rows if r["kernel"] == name and r["label"] == plm},
            "msa_rows_launches": runs,
            "msa_rows_rank_launches": {label: [rk["runs"][label]["launches"].get(name, 0)
                                               for rk in msa_rows["ranks"]]
                                       for label in MSA_ROWS_RANK_RUNS}})
    return entries


# --------------------------------------------------------------- train flops


FLOPS_REL = 1e-9  # the card's count of a step against the plain versions' (same ops)
# the kernel policy's plain route: every attention on its plain version
PLAIN_POLICY = "axial=dense,flash=off,tied_row=dense,block_sparse=jnp"
TRAIN_FLOPS_CASES = {"dense": {}, "tied": {"msa_tie_row_attn": True},
                     "sparse": {"sparse_self_attn": True}}
TRAIN_FLOPS_STEPS = 5  # train's steps in (c): the counted first, then 4 logged rates
# the wrappers tallied on a training step and on the split route (which runs
# only on a mesh: phase_msa_rows's world-size-1 rank counts it)
TALLIED = {"dense": ("fused_attention", "fused_attention_dq", "fused_attention_dkv"),
           "tied": ("tied_row_attention", "tied_row_attention_dq", "tied_row_attention_dkv"),
           "sparse": ("block_sparse_attention", "block_sparse_attention_dq",
                      "block_sparse_attention_dkv")}


@contextlib.contextmanager
def _plain_functions():
    """The kernels' autograd Functions on their plain versions on the card,
    as they run on the CPU: K1 with lse, K3a/K3b, K2 with lse and its
    backward, K4 with lse and K5a/K5b. The route the CPU counts, so a
    step's count there equals the kernels' tallies plus the same ops."""
    from alphafold2_tpu_torch.ops.cuda import axial, block_sparse, tied_row

    def grads(*args):
        return (tied_row.tied_row_attention_dq_reference(*args),
                *tied_row.tied_row_attention_dkv_reference(*args))

    swaps = [(axial, "_lse_forward", axial.fused_attention_lse_reference),
             (axial, "fused_attention_dq", axial.fused_attention_dq_reference),
             (axial, "fused_attention_dkv", axial.fused_attention_dkv_reference),
             (tied_row, "tied_row_attention_lse", tied_row.tied_row_attention_lse_reference),
             (tied_row, "tied_row_attention_grads", grads),
             (block_sparse, "block_sparse_attention_lse",
              block_sparse.block_sparse_attention_lse_reference),
             (block_sparse, "block_sparse_attention_dq",
              block_sparse.block_sparse_attention_dq_reference),
             (block_sparse, "block_sparse_attention_dkv",
              block_sparse.block_sparse_attention_dkv_reference)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, fn in swaps:
            setattr(m, n, fn)
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def _policy_expected(run, msa_len):
    """The plain policy's count of a step whose kernel run is ``run``: the
    policy's plain route differentiates the plain forwards by autograd (4
    matmuls a backward) where the kernels' backwards recompute S and dP
    (K3a, K2's dq, K5a: 6·B·H·Nq·Nk·D; K3b, K2's dk/dv, K5b: 8·...), so it
    counts K3a's and K2's dq tallies less, K5's two less autograd's 8 over
    the row lists (4/3 of K5a's), and K2's dsum einsum (2·B·H·Nq·R·D a
    backward, K2's dq tally over 3·Nk) less: every other op is the same."""
    t = run.kernel_flops
    recompute = (t.get("fused_attention_dq", 0.0) + t.get("tied_row_attention_dq", 0.0)
                 + t.get("block_sparse_attention_dq", 0.0)
                 + t.get("block_sparse_attention_dkv", 0.0)
                 - 4.0 / 3.0 * t.get("block_sparse_attention_dq", 0.0))
    dsum = t.get("tied_row_attention_dq", 0.0) / (3.0 * msa_len)
    return run.flops - recompute - dsum


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


SPARSE_WRAPPERS = {"block_sparse_attention": "fwd", "block_sparse_attention_dq": "dq",
                   "block_sparse_attention_dkv": "dkv"}


def _active_flops(run, cfg):
    """``run``'s count with K4/K5's padding slots left out (the work the
    kernels do): each block-sparse wrapper's count times the default
    layout's active share at the crop, the length of every sparse pair
    pass of a crop-long step. Requires each wrapper's count to be a whole
    number of calls at that layout."""
    from alphafold2_tpu_torch.ops.sparse import BlockSparseConfig, config_layout

    layout = config_layout(BlockSparseConfig(), cfg.data.crop_len)
    padding = 0.0
    for name, which in SPARSE_WRAPPERS.items():
        counted = run.kernel_flops.get(name, 0.0)
        one_row = layout.flops(1, cfg.model.heads, cfg.model.dim_head, which)
        require(counted % one_row == 0, f"[train_flops] {name}'s count {counted} is not whole "
                f"calls of the crop-{cfg.data.crop_len} layout")
        padding += counted * (1.0 - layout.active_flops(1, 1, 1, which)
                              / layout.flops(1, 1, 1, which))
    return run.flops - padding


def _train_flops_case(label, card):
    """(a) one step of ``label``'s configuration at ENGINE_DEPTH counted
    three times from one state: on the kernels, on the plain versions
    through the same Functions (what the CPU counts) and under the kernel
    policy's plain route."""
    import torch

    from alphafold2_tpu_torch.config import Config
    from alphafold2_tpu_torch.observe import flops
    from alphafold2_tpu_torch.ops import kernels as kernel_policy

    cfg = Config()
    cfg.model.depth = ENGINE_DEPTH
    for field, value in TRAIN_FLOPS_CASES[label].items():
        setattr(cfg.model, field, value)
    step = _step_fn(cfg, False)
    step()  # warm: every kernel built and planned
    torch.cuda.synchronize()
    read = _train_counts()
    t0 = time.perf_counter()
    _, kernels = flops.count_call(step, device="cuda")
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    launches = read()
    read = _train_counts()
    with _plain_functions():
        _, plain = flops.count_call(step, device="cuda")
    plain_launches = read()
    policy = kernel_policy.parse_policy(PLAIN_POLICY)
    with kernel_policy.use_kernel_policy(policy):
        _, routed = flops.count_call(step, device="cuda")
    torch.cuda.synchronize()
    expected = _policy_expected(kernels, cfg.data.msa_len)
    out = {"flops": kernels.flops, "op_flops": kernels.op_flops,
           "kernel_flops": kernels.kernel_flops, "plain_flops": plain.flops,
           "policy_flops": routed.flops, "policy_expected": expected,
           "rel": _rel(kernels.flops, plain.flops),
           "policy_rel": _rel(routed.flops, expected), "peak_bytes": kernels.peak_bytes,
           "counted_step_s": counted_s,
           "launches": {k: v for k, v in launches.items() if v}}
    if cfg.model.sparse_self_attn:
        out["active_flops"] = _active_flops(kernels, cfg)
        log(f"[train_flops] (a) {label} step: {out['active_flops']:.6e} flops over the layout's "
            f"active block pairs only (K4/K5 skip the padding slots the plain gather counts; "
            f"the step's flops and MFU follow the plain versions)")
    log(f"[train_flops] (a) {label} step (dim {cfg.model.dim}, depth {cfg.model.depth}, crop "
        f"{cfg.data.crop_len}, MSA {cfg.data.msa_depth}x{cfg.data.msa_len}; {card}): kernels "
        f"{kernels.flops:.6e} flops ({kernels.op_flops:.6e} ops + tallies "
        + ", ".join(f"{k} {v:.4e}" for k, v in sorted(kernels.kernel_flops.items()))
        + f"), plain versions through the same Functions {plain.flops:.6e} (rel "
        f"{out['rel']:.2e}), the plain policy {routed.flops:.6e} against "
        f"{expected:.6e} without the kernels' recompute (rel {out['policy_rel']:.2e}); the "
        f"counted step {counted_s:.3f} s, its peak {kernels.peak_bytes / 2**30:.3f} GiB")
    require(out["rel"] <= FLOPS_REL, f"[train_flops] {label}: the kernels' count "
            f"{kernels.flops} is not the plain versions' {plain.flops}")
    require(out["policy_rel"] <= FLOPS_REL, f"[train_flops] {label}: the plain policy's "
            f"count {routed.flops} is not {expected}")
    for name in TALLIED[label]:
        require(kernels.kernel_flops.get(name, 0) > 0, f"[train_flops] {label}: no {name} tally")
    require(plain.kernel_flops == {} and plain_launches["plain_calls"] > 0
            and not any(v for k, v in plain_launches.items() if k != "plain_calls"),
            f"[train_flops] {label}: the plain run launched a kernel {plain_launches}")
    require(launches["plain_calls"] == 0, f"[train_flops] {label}: a plain version ran")
    del step
    _free()
    return out


def _sparse_serving_flops(card):
    """(b) a sparse_self_attn serving key at bucket 128 x 1: its compile
    record's flops under the default policy (K1, K2 and K4, which now
    tallies) and under the plain policy."""
    from alphafold2_tpu_torch.serve.engine import ServeEngine

    counts, model = {}, None
    for spec in ("", PLAIN_POLICY):
        cfg = _serve_config(buckets=(POLICY_BUCKET,), max_batch=1, kernels=spec)
        cfg.model.sparse_self_attn = True
        engine = ServeEngine(cfg, model=model)
        model = engine.model
        try:
            engine.warmup()
        finally:
            engine.close()
        counts[spec or "auto"] = engine.compile_records[0]["flops"]
    del model
    _free()
    rel = _rel(counts["auto"], counts[PLAIN_POLICY])
    log(f"[train_flops] (b) sparse serving key {POLICY_BUCKET} x 1 ({card}): counted flops "
        f"auto {counts['auto']:.6e}, {PLAIN_POLICY} {counts[PLAIN_POLICY]:.6e} (rel {rel:.2e})")
    require(rel <= FLOPS_REL, f"[train_flops] the sparse serving key's count differs: {counts}")
    return {"flops": counts, "rel": rel}


def _prefetch_parity(cfg, batches, losses, card):
    """(d) a hand loop of device_put_batch and make_train_step over the
    same batches from the same initial state: its losses bit-equal to
    train's through device_prefetch; the synchronous copies' host ms."""
    import torch

    from alphafold2_tpu_torch.ops.attention import DropoutKey
    from alphafold2_tpu_torch.train import loop

    state = loop.init_state(cfg, loop.build_model(cfg))
    step = loop.make_train_step(state.model)
    hand, put_ms = [], []
    for i, batch_np in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = loop.device_put_batch(batch_np)
        put_ms.append((time.perf_counter() - t0) * 1e3)
        state, m = step(state, batch, DropoutKey.for_step(cfg.train.seed + 1, i))
        hand.append(float(m["loss"]))
    del state, step
    _free()
    log(f"[train_flops] (d) losses through device_prefetch {losses}, the hand loop's "
        f"{hand}; device_put_batch host ms {[round(x, 3) for x in put_ms]} ({card})")
    require(hand == losses, "[train_flops] the prefetched losses are not the hand loop's")
    return {"hand_losses": hand, "device_put_ms": put_ms}


def phase_train_flops():
    """The training step's flops, MFU, prefetch and report on the card
    (log tag ``[train_flops]``): (a) a dense, a tied and a sparse step at
    the training smoke's width (crop 128) at ENGINE_DEPTH, each counted on
    the kernels, on the plain versions through the same autograd Functions
    (what the CPU counts; equal within FLOPS_REL, the backward's tallies
    reaching the count from autograd's device thread) and under the kernel
    policy's plain route (the same less the kernels' recompute); (b) the
    same for a sparse_self_attn serving key at bucket 128; (c)
    train.loop.train for TRAIN_FLOPS_STEPS steps with a trace and
    metrics.jsonl: step_flops, steps_per_sec, model_flops_per_s and mfu,
    mfu in (0, 1] and step_flops * steps_per_sec over the card's peak; (d)
    the losses bit-equal to a hand loop of device_put_batch, and the
    train.next_batch span beside the synchronous copy; (e)
    observe.report as a program on (c)'s artifacts, rc 0, mfu in its train
    section. Prints ``train_flops {json}``."""
    import shutil

    import numpy as np

    from alphafold2_tpu_torch.config import Config
    from alphafold2_tpu_torch.data.pipeline import SyntheticDataset
    from alphafold2_tpu_torch.observe import flops
    from alphafold2_tpu_torch.observe.tracing import load_trace_events
    from alphafold2_tpu_torch.train import loop

    t_phase = time.perf_counter()
    card = _card()
    out = {"card": card, "steps": {k: _train_flops_case(k, card) for k in TRAIN_FLOPS_CASES}}
    out["serving"] = _sparse_serving_flops(card)

    # (c) train: the counted first step, then every step logged
    run_dir = os.path.join(HERE, "build", "train_flops")
    shutil.rmtree(run_dir, ignore_errors=True)
    cfg = Config()
    cfg.model.depth = ENGINE_DEPTH
    cfg.train.log_every = 1
    cfg.train.checkpoint_dir = run_dir
    cfg.train.checkpoint_every = 10**6
    cfg.train.trace_events = os.path.join(run_dir, "trace.json")
    batches = [b for _, b in zip(range(TRAIN_FLOPS_STEPS),
                                 SyntheticDataset(cfg.data, seed=cfg.train.seed))]
    losses = []
    loop.train(cfg, num_steps=TRAIN_FLOPS_STEPS, dataset=list(batches),
               callbacks=[lambda i, s, m: losses.append(float(m["loss"]))])
    _free()
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    (first,) = [r for r in records if "step_flops" in r]
    rates = [r for r in records if "steps_per_sec" in r]
    peak = flops.device_peak_flops()
    for r in rates:
        want = first["step_flops"] * r["steps_per_sec"] / peak
        # the loop logs mfu rounded to 4 places, as JAX's does
        require(0.0 < r["mfu"] <= 1.0 and abs(r["mfu"] - want) <= 5e-5 + 1e-12
                and r["model_flops_per_s"] == first["step_flops"] * r["steps_per_sec"],
                f"[train_flops] (c) step {r['step']}: mfu {r.get('mfu')} against {want}")
    require(len(rates) == TRAIN_FLOPS_STEPS - 1, f"[train_flops] (c) {len(rates)} rate logs")
    dense = out["steps"]["dense"]
    events = load_trace_events(cfg.train.trace_events)
    next_ms = [e["dur"] / 1e3 for e in events if e["name"] == "train.next_batch"]
    out["train"] = {"step_flops": first["step_flops"],
                    "steps_per_sec": [r["steps_per_sec"] for r in rates],
                    "model_flops_per_s": [r["model_flops_per_s"] for r in rates],
                    "mfu": [r["mfu"] for r in rates], "next_batch_ms": next_ms,
                    "losses": losses}
    log(f"[train_flops] (c) train, dense, depth {cfg.model.depth}, crop {cfg.data.crop_len} "
        f"({card}): step_flops {first['step_flops']:.6e} (the (a) dense count "
        f"{dense['flops']:.6e}); steps_per_sec "
        + ", ".join(f"{r['steps_per_sec']:.3f}" for r in rates) + "; model_flops_per_s "
        + ", ".join(f"{r['model_flops_per_s']:.4e}" for r in rates) + "; mfu "
        + ", ".join(str(r["mfu"]) for r in rates) + f" (peak {peak:.4e}); train.next_batch "
        f"ms {[round(x, 3) for x in next_ms]}")
    require(_rel(first["step_flops"], dense["flops"]) <= FLOPS_REL and first["step"] == 0,
            "[train_flops] (c) train's step_flops is not (a)'s dense count")
    require(bool(np.isfinite(losses).all()), "[train_flops] (c) a non-finite loss")
    out["prefetch"] = _prefetch_parity(cfg, batches, losses, card)

    # (e) the report, as a program, on (c)'s artifacts
    proc = subprocess.run(
        [sys.executable, "-m", "alphafold2_tpu_torch.observe.report", cfg.train.trace_events,
         os.path.join(run_dir, "metrics.jsonl")], cwd=HERE, capture_output=True, text=True,
        timeout=300)
    train_lines = [line for line in proc.stdout.splitlines() if "steps/sec" in line]
    log(f"[train_flops] (e) observe.report rc {proc.returncode}: " + " | ".join(
        line.strip() for line in proc.stdout.splitlines()
        if line.startswith(("-- train", "  steps/sec", "  first step", "train.step",
                            "train.next_batch"))))
    require(proc.returncode == 0, f"[train_flops] (e) the report exited {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    require(len(train_lines) == 1 and "(mfu " in train_lines[0],
            "[train_flops] (e) the report's train section shows no mfu")
    shutil.rmtree(run_dir, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[train_flops] phase took {out['seconds']:.1f} s")
    log("train_flops " + json.dumps(out))
    return out


# ----------------------------------------- the port's tools and examples

TOOLS_PROFILE_STEPS = 2  # profile_step's profiled steps (after its 3 warm ones)
TOOLS_TOP = 15  # profile_step's rows logged
EXAMPLES_TIMEOUT_S = 300
EXAMPLES = ("01_distogram_basics.py", "02_memory_scaling.py", "03_templates_and_plm.py",
            "04_structure_realization.py", "05_distributed_training.py")


def _captured(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with its standard output captured: (result,
    the lines)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, [line for line in buf.getvalue().splitlines() if line.strip()]


def _tools_profile_step():
    """profile_step at its defaults (dim 256, depth 2, crop 256, MSA 16x256,
    tied, bf16) with TOOLS_PROFILE_STEPS profiled steps: the top TOOLS_TOP
    rows of the device lanes, the copy rows named; every launch on Hopper."""
    import tempfile

    from alphafold2_tpu_torch import profile_step

    with tempfile.TemporaryDirectory() as tmp:
        read = _train_counts()
        path = profile_step.run_profiled_steps(tmp, TOOLS_PROFILE_STEPS)
        launches = read()
        rows, lines = _captured(profile_step.summarize, path, TOOLS_PROFILE_STEPS, top=TOOLS_TOP)
    _require_training_hopper(launches, "[tools] profile_step")
    for line in lines:
        log(f"[tools] profile_step {line}")
    require(any(line.startswith("device op time total") for line in lines) and rows,
            "[tools] profile_step: the trace has no device lane")
    copies = [r for r in rows if "memcpy" in r[0].lower() or "copy" in r[0].lower()
              or "memset" in r[0].lower()]
    log(f"[tools] profile_step: copy rows in the top {TOOLS_TOP}: "
        + ("; ".join(f"{name[:110]} {us:.0f} us/step ({share:.1%})"
                     for name, us, share in copies) or "none"))
    return {"rows": rows, "copies": copies, "launches": launches}


def _tools_bisect_perf():
    """bisect_perf at its defaults under the three kernel policies."""
    from alphafold2_tpu_torch import bisect_perf

    table, lines = _captured(bisect_perf.measure)
    for line in lines:
        log(f"[tools] bisect_perf {line}")
    require(list(table) == list(bisect_perf.POLICIES), f"[tools] bisect_perf ran {list(table)}")
    for label, rec in table.items():
        require(all(math.isfinite(r["ms"]) and r["ms"] > 0 and r["flops"] > 0
                    for r in rec["rows"]), f"[tools] bisect_perf under {label}: {rec['rows']}")
    return table


def _tools_validate():
    from alphafold2_tpu_torch import validate_structure_math

    code, lines = _captured(validate_structure_math.main, [])
    for line in lines:
        log(f"[tools] validate_structure_math {line}")
    require(code == 0 and lines[-1] == "ALL OK", "[tools] validate_structure_math failed")


def _tools_examples():
    """Examples 01-05 at their full shapes on the card in one process under
    torchrun on one NCCL rank (``python -m alphafold2_tpu_torch.examples``:
    runpy, so the process start is paid once; 05 trains on its (1, 1)
    mesh); each must end by printing ``ok``."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("EX_TINY", "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", "1", "-m", "alphafold2_tpu_torch.examples"],
                          cwd=HERE, env=env, text=True, capture_output=True,
                          timeout=EXAMPLES_TIMEOUT_S)
    out = {}
    for chunk in proc.stdout.split("== ")[1:]:
        lines = [line for line in chunk.splitlines() if line.strip()]
        for line in lines[1:]:
            log(f"[tools] {lines[0]} {line}")
        out[lines[0]] = lines[-1] == "ok"
    require(proc.returncode == 0 and all(out.get(n) for n in EXAMPLES),
            f"[tools] the examples under torchrun exited {proc.returncode}: {out}\n"
            f"{proc.stderr[-3000:]}")
    log(f"[tools] examples 01-05 in one process under torchrun (1 NCCL rank) took "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def phase_tools():
    """The port's tools and examples on the card (log tag ``[tools]``):
    profile_step, bisect_perf, validate_structure_math, then examples 01-05
    (``_tools_*``); each part's seconds."""
    out, seconds = {}, {}
    for name, fn in (("profile_step", _tools_profile_step), ("bisect_perf", _tools_bisect_perf),
                     ("validate_structure_math", _tools_validate),
                     ("examples", _tools_examples)):
        _free()
        t0 = time.perf_counter()
        out[name] = fn()
        seconds[name] = time.perf_counter() - t0
    log("[tools] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    out["seconds"] = seconds
    return out


def probe_gloo_cuda(world=2):
    """Whether gloo takes CUDA tensors for the collectives the mesh path
    uses (all_to_all_single even and uneven, all_reduce sum and max,
    all_gather_into_tensor, reduce_scatter_tensor (the all_gather's
    backward), broadcast_object_list through the card, and the ring's
    batch_isend_irecv), ``world`` ranks on the one card; not part of the
    run. Logs each op's outcome."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke as c; c._gloo_cuda_rank()"], cwd=HERE,
        env=_rank_env(r, world, port)) for r in range(world)]
    codes = [p.wait(timeout=300) for p in procs]
    log(f"[gloo_cuda] ranks exited {codes}")
    return codes


def _gloo_cuda_rank():
    import torch
    import torch.distributed as dist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}",
                            rank=rank, world_size=world)
    torch.cuda.set_device(0)
    x = torch.arange(4 * world, dtype=torch.float32, device="cuda") + 100 * rank
    splits = [1 + (rank + i) % 2 for i in range(world)]  # rank r sends splits[i] to i
    recv = [1 + (i + rank) % 2 for i in range(world)]
    ops = {
        "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(x), x),
        "all_to_all_single uneven": lambda: dist.all_to_all_single(
            x.new_empty(sum(recv)), x[:sum(splits)].contiguous(), output_split_sizes=recv,
            input_split_sizes=splits),
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_reduce max": lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            x.new_empty(world * x.numel()), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            x.new_empty(x.numel() // world), x),
        "broadcast_object_list": lambda: dist.broadcast_object_list(
            [{"op": "forward", "rank": rank}], src=0, device=torch.device("cuda")),
        "batch_isend_irecv": lambda: [w.wait() for w in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, (rank + 1) % world),
            dist.P2POp(dist.irecv, torch.empty_like(x), (rank - 1) % world)])],
    }
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            log(f"[gloo_cuda] rank {rank}: {name} on CUDA tensors: ok")
        except Exception as e:  # noqa: BLE001 — the probe reports what gloo refuses
            log(f"[gloo_cuda] rank {rank}: {name} on CUDA tensors refused: "
                f"{type(e).__name__}: {str(e).splitlines()[0][:200]}")
    dist.destroy_process_group()


def _module_spans(modules, fn):
    """Device-timeline ms from entry to exit of each named module over
    ``fn()`` (CUDA events recorded by forward hooks), and the whole
    ``fn()``'s."""
    import torch

    marks = {name: [] for name in modules}
    hooks = []

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    for name, mod in modules.items():
        hooks.append(mod.register_forward_pre_hook(
            lambda m, a, name=name: marks[name].append([event()])))
        hooks.append(mod.register_forward_hook(
            lambda m, a, o, name=name: marks[name][-1].append(event())))
    try:
        start = event()
        fn()
        end = event()
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    return ({name: sum(a.elapsed_time(b) for a, b in spans) for name, spans in marks.items()},
            start.elapsed_time(end))


def profile_device(what, fn, host=False):
    """Device time by kernel over ``fn()`` (torch.profiler), and the share of
    its wall time the device was busy; with ``host``, also the host ops that
    took the most time of their own and the count of kernel launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []  # device-side events only: kernels and memcpy/memset
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    if not rows:
        log(f"[profile] {what}: the profiler recorded no device time: not measured")
        return
    busy = sum(r[0] for r in rows)
    log(f"[profile] {what}: wall {wall_ms:.1f} ms (profiler on), device busy "
        f"{busy:.1f} ms ({busy / wall_ms:.1%}), idle {1 - busy / wall_ms:.1%}")
    # K1 shows as attention_kernel_sm90<64> (and combine_kernel<64> where it
    # splits the key axis), on the MSA column and template-axis passes as
    # attention_packed_kernel_sm90<64>, K2 as tied_row_attention_kernel_sm90<64,128>
    # (serving) or <64,64> (tied training), K3a/K3b as
    # dq_kernel_sm90 / dkv_kernel_sm90 (and grad_merge_kernel<64> where they
    # split), K2's backward as tied_dq_kernel_sm90<64,64> /
    # tied_dkv_kernel_sm90<64,64> (tied training); K2 and its backward on
    # the wide route (the plm grid, config_4) as tied_wide_logits_kernel,
    # tied_wide_softmax_kernel / tied_wide_grad_kernel and
    # tied_wide_product_kernel
    for ms, count, name in sorted(rows, reverse=True)[:12]:
        log(f"[profile] {ms:9.2f} ms {ms / busy:6.1%} x{count:<6d} {name[:90]}")
    if not host:
        return
    cpu = [(e.self_cpu_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
           if e.device_type == DeviceType.CPU]
    launches = sum(c for _, c, k in cpu if k in ("cudaLaunchKernel", "cuLaunchKernel",
                                                  "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    log(f"[profile] {what}, host: {sum(r[0] for r in cpu):.1f} ms of host ops' own time, "
        f"{launches} kernel launches")
    for ms, count, name in sorted(cpu, reverse=True)[:10]:
        log(f"[profile] host {ms:9.2f} ms x{count:<6d} {name[:80]}")


# --------------------------------------------------------------- main


def _entry(name, source, replaces, launches, rows, weights, dtype="bfloat16"):
    """One kernel's JSON entry: ``weights`` maps a result-row label to its
    calls; times and bounds are the weighted sums over the rows of
    ``dtype``."""
    timed = [r for r in rows if r["kernel"] == name and r["label"] in weights
             and r["dtype"] == dtype]
    w = [weights[r["label"]] for r in timed]
    lib = [r.get("library_ms") for r in timed]
    ops_ms = sum(c * r["ops_ms"] for c, r in zip(w, timed))
    bytes_ms = sum(c * r["bytes_ms"] for c, r in zip(w, timed))
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["kernel"] == name),
        "ms": sum(c * r["ms"] for c, r in zip(w, timed)),
        "plain_ms": sum(c * r["plain_ms"] for c, r in zip(w, timed)),
        "bound_ms": sum(c * r["bound_ms"] for c, r in zip(w, timed)),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": (None if any(x is None for x in lib)
                       else sum(c * x for c, x in zip(w, lib))),
    }


def _step_weights(backward, depth=6):
    """Calls per training step of each TRAIN_CASES label: every attention
    runs K1; the last layer's MSA<-pair update runs no backward."""
    weights = {label: depth * calls for label, (_, _, _, calls) in TRAIN_CASES.items()}
    if backward:
        weights["MSA<-pair (1x8, 320x16384)"] -= 1
    return weights


def _shape_entry(rows, kernel, label):
    """One bf16 result row's numbers, for a kernel entry's ``shapes``."""
    (r,) = [r for r in rows if r["kernel"] == kernel and r["label"] == label
            and r["dtype"] == "bfloat16"]
    return {k: r.get(k) for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                  "max_abs_err", "grads_ms") if k in r}


def kernel_line(rows, serve, train, tied_train, sparse_train, gate, engines, telemetry,
                templates, plm, compress, data, serve_async, serve_fleet, policy=None,
                predict_cli=None, long_mesh=None, train_mesh=None):
    """One entry per kernel. K1 sums one serving trunk layer's K1 calls at
    bucket 128 (two pair axial passes, the MSA column pass, both cross
    attentions; a call's time includes its combine pass where it splits),
    K2 its tied-row call, bf16, with the serving run's launches. K3a and
    K3b sum one training step's calls (6 layers; the last layer's MSA<-pair
    update runs no backward; a call's time includes its merge pass where it
    splits), with the training run's launches; their library_ms is SDPA's
    whole backward (dq, dk and dv in one call) on the same problems. K4 (its
    training forward, with lse), K5a and K5b sum one sparse training step's
    12 pair axial passes, with
    the sparse training run's launches; library_ms is SDPA with the
    element-level layout and key mask (its whole backward for K5a/K5b).
    K2's backward (tied_row_attention_bwd_dq and _dkv) sums one tied training
    step's six tied MSA row passes (1x5x64x8x64, R*D 320), with the tied
    training run's launches; library_ms is SDPA's whole backward on the
    folded (B, H, N, R*D) tensors. scale_rows (X's counterpart) is the gate
    phase's one launch at X's (4, 512) f32, timed alone in f32; library_ms is
    torch.mul(x, 2). Each training kernel's entry also carries
    ``engine_launches``: its launches a step under each engine of
    phase_engines (K4 with and without the row logsumexp together), and
    ``dropout_launches``: its launches a step under each dropout
    configuration of phase_train_telemetry, ``templates_launches`` and
    ``plm_launches``: its launches a step in each run of phase_templates
    and phase_plm, ``compress_launches``: its launches a config_3 step
    (phase_compress), and ``data_launches``: its launches a step on each
    data source of phase_data. K1, K3a and K3b carry in ``shapes`` their
    numbers on the template-axis launch (phase_slice_kernels) and on
    config_3's compressed pair<-MSA pass (phase_compress), K2 and its
    backward on the wide route's shapes (the PLM grid's tied rows at R*D
    8192 and 12288, config_4's at 1024), bf16, the backward's with
    ``grads_ms`` (dq, dk and dv in one call); K2 and its backward list
    ``instantiations``: their Hopper kernels on the resident and the wide
    route; K1 lists its three Hopper instantiations by route
    (attention_kernel_sm90, the packed kernel, K2's walk past head dim
    128). K1 and K2 carry ``serve_async_launches``: their launches in
    phase_serve_async's first serial and pipelined runs of the twelve
    requests and in its open-loop burst, and ``serve_fleet_launches``: their
    launches (K1's packed ones beside) in phase_serve_fleet's 1- and
    2-replica runs of its stream. K1 and K2 carry ``policy_launches``: their
    launches serving phase_kernel_policy's four requests under each kernel
    policy (by its description), and ``predict_cli_launches``: their
    launches in phase_predict_cli's in-process run; K4 carries
    ``policy_launches``: its launches in the SparseAttention pass under each
    block_sparse choice. Every entry carries ``mesh_launches``: its launches
    serving one request on each long rung of phase_long_mesh's
    world-size-1 mesh (the rung's first dispatch: the warm, counted and
    request forwards), by bucket; 0 where the mesh path does not run it;
    and ``mesh_rank_launches``: each rank's launches in the same dispatch
    on the LONG_RANKS_BUCKET rung of the four ranks' 1x2x2 grid. Every
    entry carries ``train_mesh_launches``: its launches in phase_train_mesh's
    world-size-1 mesh steps, by run ((a) each configuration on each mesh,
    its TRAIN_MESH_STEPS steps; (b) each long-crop run's steps before the
    watched one; (d) the end-to-end steps), and ``train_mesh_rank_launches``:
    each rank's launches in (c), by run."""
    serve_k1 = {"pair axial pass (1536x8, 384x384, d64)": 2,
                "MSA column pass (512x8, 5x5, d64)": 1,
                "pair<-MSA cross (4x8, 147456x640, d64)": 1,
                "MSA<-pair cross (4x8, 640x147456, d64)": 1}
    step_k3 = _step_weights(backward=True)
    step_k4 = {SPARSE_TRAIN_LABEL: 12}  # 2 pair axial passes x 6 layers
    bwd = "alphafold2_tpu_torch/csrc/fused_attention_bwd.cu"
    tied_bwd = "alphafold2_tpu_torch/csrc/tied_row_attention_bwd.cu"
    step_tied = {TIED_TRAIN_LABEL: 6}  # one tied MSA row pass a layer
    sparse_bwd = "alphafold2_tpu_torch/csrc/block_sparse_attention_bwd.cu"
    entries = [
        _entry("fused_attention", "alphafold2_tpu_torch/csrc/fused_attention.cu",
               "alphafold2_tpu/ops/pallas/axial.py:249",
               serve["launches"]["fused_attention"], rows, serve_k1),
        _entry("tied_row_attention", "alphafold2_tpu_torch/csrc/tied_row_attention.cu",
               "alphafold2_tpu/ops/pallas/tied_row.py:53",
               serve["launches"]["tied_row_attention"], rows,
               {"tied MSA rows (4x5x128x8x64, R*D=320)": 1}),
        _entry("fused_attention_bwd_dq", bwd, "alphafold2_tpu/ops/pallas/axial.py:275",
               train["launches"]["fused_attention_bwd_dq"], rows, step_k3),
        _entry("fused_attention_bwd_dkv", bwd, "alphafold2_tpu/ops/pallas/axial.py:313",
               train["launches"]["fused_attention_bwd_dkv"], rows, step_k3),
        _entry("tied_row_attention_bwd_dq", tied_bwd, "alphafold2_tpu/ops/pallas/axial.py:275",
               tied_train["launches"]["tied_row_attention_bwd_dq"], rows, step_tied),
        _entry("tied_row_attention_bwd_dkv", tied_bwd, "alphafold2_tpu/ops/pallas/axial.py:313",
               tied_train["launches"]["tied_row_attention_bwd_dkv"], rows, step_tied),
        _entry("block_sparse_attention", "alphafold2_tpu_torch/csrc/block_sparse_attention.cu",
               "alphafold2_tpu/ops/pallas/block_sparse.py:296",
               sparse_train["launches"]["block_sparse_attention"], rows, step_k4),
        _entry("block_sparse_attention_bwd_dq", sparse_bwd,
               "alphafold2_tpu/ops/pallas/block_sparse.py:339",
               sparse_train["launches"]["block_sparse_attention_bwd_dq"], rows, step_k4),
        _entry("block_sparse_attention_bwd_dkv", sparse_bwd,
               "alphafold2_tpu/ops/pallas/block_sparse.py:388",
               sparse_train["launches"]["block_sparse_attention_bwd_dkv"], rows, step_k4),
        _entry("scale_rows", "alphafold2_tpu_torch/csrc/controls/scale_rows.cu",
               "alphafold2_tpu/analysis/lowering.py:267", gate["launches"], [gate["row"]],
               {gate["row"]["label"]: 1}, dtype="float32"),
    ]
    for e in entries:
        if e["name"] in _training_kernels():
            e["engine_launches"] = {
                label: run["launches"].get(e["name"], 0)
                + (run["launches"].get("block_sparse_attention (no lse)", 0)
                   if e["name"] == "block_sparse_attention" else 0)
                for label, run in engines["runs"].items()}
            e["dropout_launches"] = {label: run["launches"].get(e["name"], 0)
                                     for label, run in telemetry["runs"].items()}
            for key, phase in (("templates_launches", templates), ("plm_launches", plm)):
                e[key] = {label: run["launches"].get(e["name"], 0)
                          for label, run in phase["runs"].items()}
            e["compress_launches"] = compress["launches"].get(e["name"], 0)
            e["data_launches"] = {label: n.get(e["name"], 0)
                                  for label, n in data["launches"].items()}
    shapes = {"fused_attention": [("fused_attention", TEMPLATE_AXIS_LABEL),
                                  ("fused_attention", COMPRESS_LABEL),
                                  ("fused_attention (lse)", COMPRESS_LABEL)],
              "fused_attention_bwd_dq": [("fused_attention_bwd_dq", TEMPLATE_AXIS_LABEL),
                                         ("fused_attention_bwd_dq", COMPRESS_LABEL)],
              "fused_attention_bwd_dkv": [("fused_attention_bwd_dkv", TEMPLATE_AXIS_LABEL),
                                          ("fused_attention_bwd_dkv", COMPRESS_LABEL)],
              "tied_row_attention": [("tied_row_attention (lse)", x) for x in WIDE_TIED_CASES],
              "tied_row_attention_bwd_dq": [("tied_row_attention_bwd_dq", x)
                                            for x in WIDE_TIED_CASES],
              "tied_row_attention_bwd_dkv": [("tied_row_attention_bwd_dkv", x)
                                             for x in WIDE_TIED_CASES]}
    for e in entries:
        for kernel, label in shapes.get(e["name"], ()):
            key = label if kernel == e["name"] else f"{label}, {kernel}"
            e.setdefault("shapes", {})[key] = _shape_entry(rows, kernel, label)
    for e in entries:
        if e["name"] in _INSTANTIATIONS:
            e["instantiations"] = _INSTANTIATIONS[e["name"]]()
        if e["name"] in ("fused_attention", "tied_row_attention"):
            e["serve_async_launches"] = {
                "serial": serve_async["runs"]["serial"][0]["launches"][e["name"]],
                "pipelined": serve_async["runs"]["pipelined"][0]["launches"][e["name"]],
                "burst": serve_async["burst"]["launches"][e["name"]]}
            e["serve_fleet_launches"] = {
                f"{n} replica(s)": {k: run["launches"][k] for k in (
                    (e["name"], "fused_attention_packed") if e["name"] == "fused_attention"
                    else (e["name"],))}
                for n, run in serve_fleet["runs"].items()}
            if policy is not None:
                e["policy_launches"] = {desc: run["counts"][e["name"]]
                                        for desc, run in policy["runs"].items()}
            if predict_cli is not None:
                e["predict_cli_launches"] = predict_cli["launches"][e["name"]]
        if e["name"] == "block_sparse_attention" and policy is not None:
            e["policy_launches"] = dict(policy["sparse"]["launches"])
        if long_mesh is not None:
            e["mesh_launches"] = {bucket: run["launches"].get(e["name"], 0)
                                  for bucket, run in long_mesh["rungs"].items()}
            e["mesh_rank_launches"] = [r["launches"].get(e["name"], 0)
                                       for r in long_mesh["ranks"]]
        if train_mesh is not None:
            runs = {f"(a) {label} {mesh}": counts
                    for label, a in train_mesh["a"].items()
                    for mesh, counts in a["launches"].items()}
            runs.update({f"(b) {label}": b["launches"] for label, b in train_mesh["b"].items()})
            runs["(d) (1, 1)"] = train_mesh["d"]["launches"]
            runs["(d reversible) (1, 1)"] = train_mesh["d reversible"]["launches"]
            e["train_mesh_launches"] = {k: v.get(e["name"], 0) for k, v in runs.items()}
            e["train_mesh_rank_launches"] = {
                label: [r["runs"][label]["launches"].get(e["name"], 0)
                        for r in train_mesh["ranks"]] for label in TRAIN_MESH_RANK_RUNS}
    return {"kernels": entries}


# the kernel line's names -> the wrappers' tally names (ops/cuda/build.py)
_TALLY_OF = {"fused_attention": "fused_attention", "fused_attention_bwd_dq": "fused_attention_dq",
             "fused_attention_bwd_dkv": "fused_attention_dkv",
             "tied_row_attention": "tied_row_attention",
             "tied_row_attention_bwd_dq": "tied_row_attention_dq",
             "tied_row_attention_bwd_dkv": "tied_row_attention_dkv",
             "block_sparse_attention": "block_sparse_attention",
             "block_sparse_attention_bwd_dq": "block_sparse_attention_dq",
             "block_sparse_attention_bwd_dkv": "block_sparse_attention_dkv",
             "tied_split_logits": "tied_split_logits",
             "tied_split_product": "tied_split_product"}


def _add_train_flops(line, train_flops):
    """Each tallying kernel's entry gains ``step_flops_tally``: its
    analytic flops in phase_train_flops's counted dense, tied and sparse
    steps (the split passes' in phase_msa_rows's row-sharded step)."""
    runs = {label: run["kernel_flops"] for label, run in train_flops["steps"].items()}
    runs["row-sharded"] = train_flops["split_route"]["kernel_flops"]
    for entry in line["kernels"]:
        name = _TALLY_OF.get(entry["name"])
        if name is not None:
            entry["step_flops_tally"] = {label: t[name] for label, t in runs.items()
                                         if t.get(name)}


def _k2_routes(which):
    """K2's Hopper instantiations by route: the resident kernel at the
    serving (forward) or tied training (backward) pass, the wide route's
    passes at the PLM grid's tied rows."""
    from alphafold2_tpu_torch.ops.cuda import tied_row as tr

    b, r, n, h, d = PLM_TIED
    if which == "fwd":
        return {"resident": tr.hopper_plan(4, 5, 8, 128, 64)["kernel"],
                "wide": [x["kernel"] for x in tr.wide_plan(b, r, h, n, n, d)["passes"]]}
    passes = tr.wide_bwd_plan(b, h, n, n, r * d, d)["passes"]
    return {"resident": tr.hopper_bwd_plan(which, 1, 8, 64, 64, 320, 64)["kernel"],
            "wide": [x["kernel"] for x in passes[:2] + [passes[2 if which == "dq" else 3]]]}


def _k1_routes():
    """K1's Hopper instantiations by route: attention_kernel_sm90 on the
    long passes, the packed kernel on the short ones (the MSA column passes,
    the template axis), K2's walk on the pair axial pass at head dim 256."""
    from alphafold2_tpu_torch.ops.cuda import axial
    from alphafold2_tpu_torch.ops.cuda import tied_row as tr

    b, h, n, d = TEMPLATE_AXIS
    return {"sm90": K1_SM90, "packed": axial.packed_plan(b, h, n, n, d)["kernel"],
            "rows": tr.hopper_plan(128, 256 // 64, 8, 128, 64)["kernel"]}


_INSTANTIATIONS = {"fused_attention": _k1_routes,
                      "tied_row_attention": lambda: _k2_routes("fwd"),
                      "tied_row_attention_bwd_dq": lambda: _k2_routes("dq"),
                      "tied_row_attention_bwd_dkv": lambda: _k2_routes("dkv")}


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi gave nothing"


def _timed(name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, logging its wall time as ``[phase]``."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"[phase] {name} took {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "alphafold2_tpu_torch")):
        log("chip_smoke.py must run from a checkout that holds alphafold2_tpu_torch/")
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py drives the port on the card only")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    log(f"[device] {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    try:
        _timed("build", phase_build)
        gate = _timed("gate", phase_gate)
        rows = (_timed("kernels", phase_kernels) + _timed("backward", phase_backward)
                + _timed("head_dims", phase_head_dims) + _timed("tied", phase_tied)
                + _timed("sparse", phase_sparse))
        for r in rows:
            if "ms" in r:
                host = f", host {r['host_us']:.1f} us a call" if "host_us" in r else ""
                log(f"[kernels] time {r['kernel']} {r['label']} {r['dtype']}: "
                    f"kernel {r['ms']:.4f} ms{host}, plain {r['plain_ms']:.3f} ms, "
                    f"sdpa {r.get('library_ms')} ms, bound {r['bound_ms']:.4f} ms "
                    f"({r['bound_by']}; {r['ops']:.3e} ops, {r['bytes']:.3e} bytes; "
                    f"{r['bound_ms'] / r['ms']:.1%} of the bound)")
        for name, weights in (("fused_attention (lse)", _step_weights(backward=False)),
                              ("fused_attention_bwd_dq", _step_weights(backward=True)),
                              ("fused_attention_bwd_dkv", _step_weights(backward=True))):
            e = _entry(name, "", "", None, rows, weights)
            log(f"[backward] per training step, {name}: kernel {e['ms']:.3f} ms, plain "
                f"{e['plain_ms']:.3f} ms, sdpa {e['library_ms']} ms, bound "
                f"{e['bound_ms']:.4f} ms ({e['bound_by']})")
        for name in ("tied_row_attention (lse)", "tied_row_attention_bwd_dq",
                     "tied_row_attention_bwd_dkv"):
            e = _entry(name, "", "", None, rows, {TIED_TRAIN_LABEL: 6})
            log(f"[tied] per tied training step, {name}: kernel {e['ms']:.4f} ms, plain "
                f"{e['plain_ms']:.3f} ms, sdpa {e['library_ms']} ms, bound "
                f"{e['bound_ms']:.4f} ms ({e['bound_by']})")
        for name in ("block_sparse_attention", "block_sparse_attention_bwd_dq",
                     "block_sparse_attention_bwd_dkv"):
            e = _entry(name, "", "", None, rows, {SPARSE_TRAIN_LABEL: 12})
            log(f"[sparse] per sparse training step, {name}: kernel {e['ms']:.4f} ms, plain "
                f"{e['plain_ms']:.3f} ms, sdpa {e['library_ms']} ms, bound "
                f"{e['bound_ms']:.4f} ms ({e['bound_by']})")
        _timed("reference", phase_reference)
        _timed("se3_streamed", phase_se3_streamed)
        serve = _timed("serve", phase_serve)
        lattice = _timed("lattice", phase_lattice, serve["engine"])
        serve.pop("engine").close()  # depth 6; the later serving phases build their own
        _free()
        long_mesh = _timed("long_mesh", phase_long_mesh)
        serve_async = _timed("serve_async", phase_serve_async)
        serve_fleet = _timed("serve_fleet", phase_serve_fleet, serve_async.pop("state"),
                             serve_async["serial_req_per_s"], serve_async.pop("atom14"))
        policy = _timed("kernel_policy", phase_kernel_policy)
        predict_cli = _timed("predict_cli", phase_predict_cli)
        train = _timed("train", phase_train)
        tied_train = _timed("tied train", phase_train, tied=True)
        sparse_train = _timed("sparse train", phase_train, sparse=True)
        train_mesh = _timed("train_mesh", phase_train_mesh)
        msa_rows = _timed("msa_rows", phase_msa_rows)
        _timed("end2end", phase_end2end)
        engines = _timed("engines", phase_engines)
        telemetry = _timed("train_telemetry", phase_train_telemetry)
        train_flops = _timed("train_flops", phase_train_flops)
        train_flops["split_route"] = msa_rows["a"]["MSA"]["flops"]
        rows += _timed("slice_kernels", phase_slice_kernels)
        templates = _timed("templates", phase_templates)
        plm = _timed("plm", phase_plm)
        compress_rows, compress = _timed("compress", phase_compress)
        rows += compress_rows
        data = _timed("data", phase_data)
        _timed("tools", phase_tools)
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        log("chip_smoke: FAILED")
        return 1
    log(card)
    line = kernel_line(rows, serve, train, tied_train, sparse_train, gate, engines, telemetry,
                       templates, plm, compress, data, serve_async, serve_fleet, policy,
                       predict_cli, long_mesh, train_mesh)
    line["kernels"] += _split_entries(msa_rows)
    _add_train_flops(line, train_flops)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
