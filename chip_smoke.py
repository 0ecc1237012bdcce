"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
(sm_90a) and the CUDA toolkit. Phases, each fatal on failure:

1. build every CUDA kernel of the port from ``src/repro_torch/csrc/``;
2. hold each kernel against its plain PyTorch version on the card, at
   the JAX package's kernel-test cases and at each path's shapes; the
   redesigned kernels (flash attention on TMA/wgmma, the split-K cluster
   de-embed, the persistent TMA/wgmma embed, the bf16 SSD on wgmma in
   split-bf16 pieces) also against the previous kernel of the same
   function, forced with ``variant=``; the flash kernel at the
   text-to-image shapes on the output's own scale (||o - ref|| / ||ref||),
   where two planted tile-map faults must read over the limit; and each
   variant (``wgmma``, ``mma``, ``f32``) at the language models' head
   width 256 and gemma2-9b's prefill shape (B=2, S=8192, H=16 over K=8:
   causal with window 4096 and softcap 50, window 0, and a ragged S);
3. serve class-conditioned DiT-XL/2 requests (28 layers, d=1152, bf16,
   random trained-like weights from a seed) through
   ``FlexiPipeline.sample`` over a budget menu with the flash kernel as
   the attention backend: counts the kernel's launches (every one on the
   TMA/wgmma variant), checks x0
   against the dense backend, and checks that repeats and budget
   switches build no runner;
4. tokenize and de-tokenize a B=8 latent with those DiT-XL/2 weights at
   each patch size through ``kernels/patch_embed/ops`` (the patch
   embed / de-embed kernels; every embed on the wgmma variant, every
   de-embed on the cluster variant), held against ``core/patch.py``;
5. run one Mamba2 layer at mamba2-130m width (d=768, 24 SSD heads x 64,
   state 128, chunk 128, bf16) through ``ssm_apply(use_kernel=True)``
   (the SSD kernel; both calls on its wgmma variant) at B=4, S=2048 and
   S=2000, held against ``use_kernel=False``;
6. time each kernel, its plain version and the PyTorch library call at
   its path's shapes (CUDA graphs, CUDA events); the redesigned kernels
   in interleaved rounds with their previous kernel and the library call
   (flash at hd 256: compiled FlexAttention with a softcap ``score_mod``
   and a causal-window ``mask_mod``; SDPA, which has no softcap, as a
   labelled reference);
7. serve the same DiT-XL/2 weights through the port's ``ServingEngine``
   (the packed mixed-mode path: requests at different budgets, modes and
   denoise steps share rows of 256 tokens, segment ids keep them apart,
   every block's attention on the flash kernel with the tile map derived
   from the ids): first the flash kernel alone at a served layout (ids
   from the engine's row planner, padding tail included) against its
   plain version; then a wave of 12 requests with 3 joining after two
   engine steps, and the same wave again. Checks every flash launch is on
   the TMA/wgmma variant and their count is 28 x the packed forwards, the
   replay builds nothing, each x0 holds against ``FlexiPipeline.sample``
   for the same request (and the same check fails every request with
   weak steps when the segment ids are planted to 0), activation-cache
   serving at ``interval=1`` equals uncached serving bit for bit,
   ``interval=2`` releases every cache slot, a short DDPM wave finishes
   finite, and ``python -m repro_torch.launch.serve --arch dit-xl-2``
   runs in-process, with ``--smoke`` and at full width. Prints served
   img/s, latency p50/p99, packing efficiency, the attention block skip
   rate and the cache hit rate beside the card's name and power limit;
8. the sampling extensions and the telemetry layer: the paper's
   text-to-image transformer (``configs/t2i_transformer.py``: 24 layers,
   d=2048, 16 heads x 128, a 128x128x8 latent = 4096 tokens at patch 2
   and 1024 at the weak patch 4, 77 text tokens, LoRA rank 64, bf16,
   random trained-like weights from a seed) sampled through
   ``FlexiPipeline.sample`` with ``flow_euler`` and ``flow_heun``,
   unguided, at budgets 0.6 and 1.0 (B=2, T=10): every self-attention on
   the flash kernel's TMA/wgmma variant (24 launches per NFE), x0 held
   against the same plan on the dense backend, and the same check must
   fail when the kernel's kv tile walk is made to stop halfway; adaptive DDIM on DiT-XL/2 (CFG 1.5, T=10): gaps, switch step and
   relative compute recomputed from them; and the phase-7 wave served
   untapped, tapped (``Telemetry(taps=True)``) and tapped with profiling:
   x0 equal bit for bit, the tapped wave adds no host synchronisation
   (``torch.cuda.set_sync_debug_mode``) and profiling adds exactly one
   per dispatch, spans cover the lifecycle, attribution conserves
   exactly, achieved GFLOP/s per step family, nothing rebuilt;
9. training at full width: DiT-XL/2 (bf16 parameters, float32 AdamW
   moments, random trained-like weights from a seed) through
   ``make_dit_train_step`` at B=32, patch modes 0 and 1 alternating (the
   shared recipe). Every train step runs captured (``runtime.graphs``:
   one CUDA graph a step object, the parameters and the AdamW state
   donated, written in place) and is held against the same step under
   ``graphs.disabled()`` from the same weights, moments and draws: after
   four steps a mode the losses and every parameter and moment leaf equal
   bit for bit, no graph captured after the first calls, and a planted
   fault (the body reading its draws from the step object, so a replay
   reuses the first call's) must differ; ms/step captured and eager (the
   eager steps interleaved with the timed replays where they fit beside
   the graphs' pools), TFLOP/s against 3 x B x ``dit_nfe_flops``, peak
   memory (a replay's: its allocated peak plus its pools), graph pool
   bytes and the bytes a replay copies in, per mode; the LoRA recipe
   (rank 8) through ``make_distill_step``, held the same way, with every
   frozen leaf and its moments unchanged bit for bit; one
   bootstrapped-MMD step at a batch sized from the measured memory; a
   learning check on one fixed batch and the same steps with the
   update's sign flipped, which must fail it; the tiny float32 config's
   train steps on the card against the CPU (loss, gradients and updated
   parameters within 1e-5 of their norms); then ``python -m
   repro_torch.launch.train --arch dit-xl-2 --flexi --recipe lora``
   in-process (captured: one graph a mode, the other steps replays), its
   checkpoint restored by ``Checkpointer`` and served through
   ``FlexiPipeline.sample`` at budget 0.6 on the flash kernel (28
   ``wgmma`` launches per forward call), x0 equal bit for bit to the
   in-memory parameters';
10. the fleet and its resilience layer (``repro_torch.fleet``,
   ``repro_torch.resilience``) on the phase-3 DiT-XL/2 weights, menu
   {0.6, 0.8, 1.0}, T=10 DDIM, CFG 1.5, on the virtual clock: a wave of 15
   requests over 3 packed replicas (all on this card) under ``cheapest``,
   then ``affinity``, each after a rehearsal that a background thread
   warms (``BackgroundCompiler``): every flash launch on ``wgmma``, 28 x
   the packed forwards summed over the replicas, no runner built after
   the warm-up, each x0 held against ``FlexiPipeline.sample`` with the
   fleet's seed at ||x0 - ref|| / ||ref|| <= 3e-3, and a planted fault (a
   request held against another request's seed) must read over it; the
   chaos run (``default_fault_plan``: crash, hang, heartbeat delay,
   partition, slowdown, NaN poison, slot corruption, allocation failures;
   4 replicas, 32 requests, rehearsed then measured): nothing lost, every
   x0 finite, the crashed and the partitioned replica dead, every
   escalated and every moved request within 3e-3 of its reference, no
   runner built; the journal replay (``build/fleet_journal.jsonl``):
   exactly once, within 3e-3; the phase-7 wave through an engine with
   ``faults=None`` and through an armed, quarantining one equal to the
   stock engine bit for bit, the armed one adding no synchronising call
   over the tapped one; ``launch/serve.py --replicas 3`` in-process at
   full width;
11. language-model serving (``repro_torch.models.lm`` through
   ``launch/steps.make_prefill_step`` / ``make_decode_step``, runners
   captured as CUDA graphs, the decode's cache donated, each built once
   a config): gemma2-9b whole (42 layers, d=3584, 16 heads over 8 x 256,
   window 4096 on alternate layers, softcaps 50 / 30, vocab 256000, bf16,
   ~9.24 B random weights drawn on the card from a seed), prefill B=2 x
   S=8192 on the flash kernel (the first call captures, a second
   replays; 42 launches a call, all on the variant ``select_variant``
   names for bf16 hd 256), each prefill's cache written into a slot of
   8192 + 16 positions (``lm.serve_slot``), the replay held against the
   same runner under ``graphs.disabled()`` bit for bit (logits and every
   cache leaf), its last-position logits held against the dense backend
   (run under ``graphs.disabled()``, as is the planted fault, the local
   layers' window 0, which must read over the limit); then 16 greedy
   decode steps from the dense cache, whose tokens are fed to the
   captured decode on the replay's slot and to the eager decode on the
   eager prefill's slot: captured == eager bit for bit (logits, every
   slot leaf), against dense within the limit, tokens equal wherever the
   top-2 gap is clear; prefill ms (first call, replay, eager), decode ms
   a step captured and eager against the weight-bytes bound (and with
   the cache read), pool bytes a key, the bytes a decode replay copies
   in, graphs captured after warm-up (0); deepseek-7b, qwen2.5-14b,
   gemma3-4b and hymba-1.5b at full width cut to 2 layers, and
   mamba2-130m whole, each the same at B=2, S=2048 and 4 decode steps;
   then ``python -m repro_torch.launch.serve --arch gemma2-9b --requests
   4 --batch-slots 2 --prompt-len 512 --max-new 16`` in-process (two
   graphs, none captured by the second batch), and the same with
   ``--mesh 1x2 --replicas 2``, which the LM path reads not (one device,
   the same requests and tokens);
12. the MoE, vision and audio language models through the same captured
   runners, each held against ``graphs.disabled()`` as in phase 11:
   deepseek-moe-16b whole (28 layers, 64 routed top-6 + 2 shared experts
   of 1408, 16.88 B random weights drawn on the card, the draw's peak
   memory printed), prefill B=2 x S=4096 on the flash kernel (28
   ``wgmma`` launches a prefill call) and on dense, logits held against dense,
   ``dropped_fraction`` at capacity factor 1.25, 16 greedy decode steps
   from each cache against the weight-bytes bound; one of its MoE layers
   at full width ([2, 512, 2048], nothing dropped) against
   ``moe_apply_dense``, where the router's columns rolled by one must read
   over the limit; grok-1-314b at full width cut to 2 layers and
   llama-3.2-vision-90b cut to 2 groups (8 self layers on the kernel, 2
   dense cross layers; gates opened, a seeded [2, 1600, 8192] image),
   prefill B=2 x S=2048 and 4 decode steps, where a cache whose vision
   keys and values are zeroed must read over the limit; whisper-small
   whole (12 non-causal encoder launches over a seeded [4, 1500, 768]
   frame input, a 64-token prompt, 16 decode steps), where the kernel run
   causal on the encoder's q/k/v must read over the limit; the flash
   kernel against its plain version at these shapes (phase 2) and timed
   against SDPA (phase 6); then the CLI in-process for deepseek-moe-16b
   and whisper-small;
13. language-model training through ``launch/steps.make_train_step``
   (dense attention, as the reference trains; no kernel has a backward):
   gemma2-9b at full width cut to 4 layers (2 local at window 4096, 2
   global) at B=1 x S=8192 with remat "block", and deepseek-moe-16b cut
   to 2 layers at B=2 x 4096, each step captured (one CUDA graph, the
   parameters and the AdamW state donated) and held against the same
   step under ``graphs.disabled()`` as in phase 9 (four steps on two
   batches of the trainer's corpus, loss and every parameter and moment
   leaf bit for bit, no graph after the first call; the planted fault
   reads its batch from the step object), then 2 more captured steps
   (ms/step captured and eager, tokens/s, TFLOP/s against the model
   FLOPs, peak memory, pool bytes, bytes a replay copies in); 1. one
   reduced float32 config per family, gradients card against CPU; 2.
   the training forward's last-position logits against ``lm.prefill``'s
   on dense and on the flash kernel; 3. every bf16 gradient leaf against
   a float32 copy's, where remat recomputing each layer with the next
   layer's window (a planted fault) must read over the limit; 4. remat
   "block" against "none"; 5. 12 steps on one batch must learn, and the
   sign-flipped update must not; 6. the trained gemma2-9b cut saved and
   restored by ``Checkpointer``, then a flash prefill and 4 decode steps
   through captured runners (as in phase 11, against
   ``graphs.disabled()``) equal bit for bit to the in-memory parameters'
   (one ``wgmma`` launch a layer a prefill call); hymba-1.5b cut,
   mamba2-130m whole,
   llama-3.2-vision-90b cut to one group (its cross layer and vision
   projection trained, the language model frozen) and whisper-small
   whole, 2 captured steps each; 7. ``python -m repro_torch.launch.train
   --arch mamba2-130m --steps 4`` and ``--arch deepseek-moe-16b --smoke``
   in-process, captured;
14. sequence-parallel sampling (``repro_torch.distributed``): the
   kernels built here before any rank starts, then groups of rank
   processes (``launch/mesh.RankGroup``: 2 and 3 ranks side by side,
   then 4), every rank on this card over Gloo, each
   building DiT-XL/2 at full width (phase 3's weights recipe, a fresh
   seed, bf16) and sampling n = 4 at CFG 1.5, T = 10 DDIM, budgets 0.6
   and 1.0 through ``FlexiPipeline(mesh=)``: Ulysses on (1 x 2), (1 x 4)
   and (2 x 2) (the batch split over 'data'), 'auto' on (1 x 3) (the
   ring: 16 heads do not divide by 3; 256 and 64 tokens pad to 258 and
   66) and the ring forced on (1 x 4). Each x0 is held against this
   process's single-device ``FlexiPipeline.sample`` with the same
   generator as ||x0 - ref|| / ||ref||: Ulysses at 3e-3 (phase 7's
   limit); the ring, whose float32 sums run in another order, at 6e-3,
   beside single-device with the kernel's keys visited in reverse order
   (the same function, other sums), and against Ulysses on (1 x 4) at
   6e-3; Ulysses runs 28 flash launches a forward on every rank, all
   ``wgmma``, the ring none; the q/k/v/o bytes sent (the ring's K/V),
   summed over ranks, equal n x ``PartitionPlan.collective_bytes``; a
   budget switch back builds no runner; FLOPs and relative compute equal
   the single-device run's; the Ulysses q/k/v sequence chunks joined in
   reversed rank order and the ring's last hop skipped (planted faults)
   must read over their limits. Per call at full width on the ranks: one
   layer's q/k/v at DiT-XL/2's shape (B 8, 256 tokens, 16 x 72; padded
   to 258 on (1 x 3)) and at the t2i shape (B 2, 4096 tokens, 16 x 128)
   through Ulysses (bf16) and the ring (float32), gathered, against
   single-device flash at the kernel's tolerance and against float32
   plain attention at 1e-5; each planted fault must move the output by
   over 0.1 (relative). Then the text-to-image transformer at full
   width (4096 tokens) by ``flow_euler`` at budget 0.6, Ulysses (1 x 4),
   against single-device under the same limit; the flash kernel at the
   Ulysses inner shapes against its plain version and timed against
   SDPA; and ``python -m repro_torch.launch.serve --arch dit-xl-2 --mesh
   1x2 --dist-backend gloo`` as a subprocess (started and checked beside
   phase 19's blocked references, where this host sits idle: it spends
   its wall starting ranks and staging Gloo collectives). Walls per
   sample are printed beside single-device's: ranks sharing one card (the (1 x 2)
   and (1 x 3) groups' five ranks at once), with Gloo staging every
   collective through the host, price the mechanism, not scaling.
15. sharded training (``runtime/placement.py``, ``runtime/sharding``'s
   placement half, ``optim/compression.py``, ``runtime/elastic.py``): this
   process's single-device steps first (their gradients written to files,
   the card's memory freed), then one group of 4 rank processes on this
   card over Gloo, a ("data", "model") mesh of (2 x 2)
   (``launch/mesh.make_debug_mesh``): DiT-XL/2 at full width cut to 14
   of its 28 layers (phase 3's weights recipe, bf16, B=32, profile
   ``fsdp2d`` forced; the cut halves the Gloo gathers and reduce-scatters
   that take most of a rank's step, so the script fits its time limit
   beside phase 19), 2 steps at mode
   1 and 2 at mode 0, the loss and every gradient leaf at both modes held
   against single-device as ||g - ref|| / ||ref|| over the whole leaf,
   the resident parameter and moment bytes a rank equal to the spec
   arithmetic; gemma2-9b at full width cut to one local and one global
   layer (``fsdp2d_sp``: sequence parallel, remat "block") and
   deepseek-moe-16b cut to 2 layers (``fsdp2d``), B=2 x S=2048, one step
   each, loss, aux losses and gradients against single-device;
   ``compressed_psum`` of 64 M float32 over the 4 ranks, equal bit for bit
   to the reference formula on the host; the DiT checkpointed after step
   1, restored by ``elastic_restore`` onto ``make_elastic_mesh(2, 2)``
   (ranks 0-1) and stepped there against the uninterrupted step 2 (as an
   update), and restored on one device and sampled through
   ``FlexiPipeline.sample`` at budget 0.6 on the flash kernel (14
   ``wgmma`` launches a forward), x0 equal bit for bit to the gathered
   in-memory parameters'; four planted faults (``global_norm`` over local
   chunks, a data-axis gradient unsummed, the sequence-parallel gather's
   backward a sum, ``load_balance`` per rank) must read over their
   limits. Walls and peak memory a rank are printed beside
   single-device's, with the same caveat as phase 14.
   ``python3 chip_smoke.py --only sharded`` runs phase 1 and this phase
   alone.
16. the dry-run planner (``launch/{specs,roofline,dryrun}.py``), on this
   card's host: DiT-XL/2 ``serve_powerful`` and phase 13's gemma2-9b cut
   (4 layers, B=1 x S=8192, one train step) planned on one card; a
   DiT-XL/2 forward at B=8, modes 0 and 1, bf16, on the flash kernel (28
   ``wgmma`` launches a forward), the FLOPs of that flash path
   (``FlopCounterMode``'s GEMMs plus the flash launches priced by
   ``kernels/attention/costing`` at their full tile maps: a consistency
   check of the flash path's count against the planner's ``meta`` count
   on the dense path, not a count the card makes) within 0.1 %; the
   forward timed (CUDA events,
   median of PLAN_REPS) and its share of the planner's compute bound
   printed beside the card's name and power limit; the planner's
   resident bytes a rank on (2 x 2) for phase 15's three configs (its
   14-layer DiT-XL/2 cut, its gemma2-9b and deepseek-moe-16b cuts)
   against the arithmetic phase 15 measures, 855,309,440 / 3,284,825,600
   / 3,988,572,160 (and against phase 15's own reading in a full run).
   ``python3 chip_smoke.py --only plan`` runs phase 1 and this phase
   alone.
17. runners captured once as CUDA graphs (``runtime.graphs``), each
   against the same run under ``graphs.disabled()``: frozen DDIM, DDPM
   and cached engines over the phase-7 wave and a budget switch,
   ``FlexiPipeline.sample`` (static, cached, adaptive), the B=8 DiT-XL/2
   forward, a warm-up thread capturing beside serving; then the LM
   serving loop (``launch/serve.lm_prefill`` / ``lm_decode``) of
   gemma2-9b and deepseek-moe-16b at full width cut to 2 layers, two
   batches each through one prefill and one decode runner: tokens,
   logits and the slot bit for bit, flash launches equal, two graphs
   captured by the first batch and none by the second.
   ``python3 chip_smoke.py --only graphs`` runs phases 1, 8 and 17
   alone; ``--only lm`` runs phases 1 and 11-13; ``--only train`` runs
   phases 1, 9 and 13.
18. the fleet over sequence-parallel rank groups (``launch/serve.py
   --mesh 2x2 --replicas 2``): two persistent groups of 2 rank processes
   (``fleet/groups.RankGroupPipeline``), all four on this card over Gloo,
   each rank holding DiT-XL/2 at full width cut to 14 of its 28 layers
   (phase 3's weights recipe, bf16; the cut for the script's time limit
   beside phase 19: every check here is exact or at a fixed rounding) on
   a (1 x 2) mesh, behind the fixed-slot fleet on a fake clock,
   budgets {0.6, 0.8, 1.0}, T=10 DDIM, CFG 1.5, Ulysses with the flash
   kernel at 8 of 16 heads: (a) 10 requests under ``cheapest``; (b) 8
   under ``rr``, one rank of replica 0's group SIGKILLed after the first
   tick and the heartbeat timeout declaring the replica dead, then a
   rejoin on a fresh group and 2 more. Each is held against the same
   scenario on single-device fixed-slot fleets on this card (``(b)``'s
   with ``inject_hang``): placements equal, every request served once,
   x0 within 1e-6 of the single-device fleet whose token GEMMs run in
   the ranks' row blocks (``rank_shaped_gemms``: the same arithmetic as
   a rank's) and within SP_RING_X0_TOL of the plain one (the same
   function summed in another order: a lone weak-mode request's GEMMs
   have 64 rows on a rank and 128 on one device, and cuBLAS may sum them
   in another order); a planted fault (x0 shipped back in bfloat16) must
   read over 1e-6 in every request; every rank's flash launches in (a) 14 x
   the forwards its group ran, all ``wgmma``; no process of the killed group
   left. (c) ``python -m repro_torch.launch.serve --mesh 2x2 --replicas
   2`` exits 0 (in the full run started and checked beside phase 19's
   blocked references, as phase 14's command line). The groups take
   turns on the card: walls price routing
   over sequence-parallel replicas, not scale. ``python3 chip_smoke.py
   --only fleet-groups`` runs phases 1 and 18 alone.
19. the paper's text-to-video DiT (``configs/video_dit.py``: 32 layers,
   d=3072, 24 heads x 128, d_ff 12288, text cross-attention over 256 x
   3072, a (32, 88, 48, 8) latent = 33,792 tokens at patch (1, 2, 2),
   16,896 at the temporal weak patch (2, 2, 2) and 8,448 at the spatial
   (1, 4, 4), LoRA rank 64, bf16, 6.91 B random trained-like weights drawn
   on the card from a seed, every zero-initialized gate filled) at full
   width and full depth: (b) the flash kernel at B=2 (the CFG rows) x
   H=24 x hd 128 for each of the three lengths, non-causal, against its
   plain version a head at a time at ||o - ref|| / ||ref|| <= 1e-2, where
   the kv tile walk stopped halfway (a planted fault) must read over the
   limit; (c) ``FlexiPipeline.sample`` with a seeded [1, 256, 3072] text
   whose mask leaves out its last 56 tokens, n = 1, CFG 1.5, DDIM, LoRA
   merged, every self-attention on the kernel: the temporal plan (T = 4,
   budget 0.6, weak mode 1: phases ((1, 3), (0, 1)), relative compute
   0.511; 4 steps, not 8, so that its blocked reference fits the script's
   time limit) and the spatial one (T = 8, budget 0.25, weak mode 2:
   ((2, 7), (0, 1)), 0.244), 32 ``wgmma`` launches a forward, each x0
   held against the same
   plan, x_T and text on the blocked backend (``blocked_gqa_attend``, the
   reference's own path for long video sequences, run eagerly) at
   VIDEO_X0_TOL, where the planted fault must read over it on both; (d)
   each plan called again after the other (the replay's x0 bit for bit,
   no runner built, no graph captured); (e) seconds a replayed NFE a mode
   (the weak modes' captured alone, mode 0's from each plan's replay less
   its weak NFEs), TFLOP/s against 2 x ``dit_nfe_flops``, the
   cross-attention's share of an NFE, seconds a sample, peak memory,
   pool bytes a plan, relative compute against the host ledger; (f) the
   kernel timed at the three shapes against its bound and SDPA in
   interleaved rounds (added to the flash entry's ``shapes``). In the full
   run phases 14's and 18's ``--mesh`` command lines run beside the
   blocked references. ``python3 chip_smoke.py --only video`` runs phases
   1 and 19 alone.

Each path resets its kernels' launch counts just before it runs and
fails unless they equal the calls it made.

The line before the last is ``{"kernels": [...]}`` (``prev_ms``: the
previous kernel of a redesigned one, timed in the same rounds; the flash
entry's ``shapes`` times the text-to-image shape too); the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a result when
there is no CUDA card or no port next to this file.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

# before torch touches the card: phase 13's training steps free and
# allocate float32 tensors of 2-8 GB in changing sizes, which fragment
# fixed segments (a first run held 29 GB reserved but unallocated when an
# 8 GB request failed)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
if not (ROOT / "src" / "repro_torch").is_dir():
    sys.exit("chip_smoke.py: run it from a checkout of the repository "
             "(src/repro_torch/ is missing)")
if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: needs a CUDA card (torch.cuda.is_available() is "
             "False)")
sys.path.insert(0, str(ROOT / "src"))

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.diffusion.schedule import linear_schedule  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.attention import ops  # noqa: E402
from repro_torch.kernels.attention.flash_attention import (  # noqa: E402
    flash_attention_cuda, select_variant, variant_of)
from repro_torch.kernels.attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.core import patch as patch_mod  # noqa: E402
from repro_torch.kernels.patch_embed import ops as pe_ops  # noqa: E402
from repro_torch.kernels.patch_embed.patch_embed import (  # noqa: E402
    deembed_plan, deembed_variant_of, embed_launch_plan, embed_plan,
    embed_variant_of, patch_deembed_cuda, patch_embed_cuda)
from repro_torch.kernels.patch_embed.ref import (  # noqa: E402
    patch_deembed_ref, patch_embed_ref)
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_chunk_ref, ssd_chunked  # noqa: E402
from repro_torch.kernels.ssd.ssd_chunk import (  # noqa: E402
    ssd_chunk_cuda, ssd_variant_of)
from repro_torch.kernels.timing import graph_ms, interleaved_ms  # noqa: E402
from repro_torch.launch import steps as lm_steps  # noqa: E402
from repro_torch.models import dit as dit_mod  # noqa: E402
from repro_torch.models import lm as lm_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.common import (init_tree, tree_leaves,  # noqa: E402
                                       tree_map)
from repro_torch.runtime import graphs  # noqa: E402
from repro_torch.runtime.padding import write_kv_slot  # noqa: E402
from repro_torch.pipeline import (AdaptiveBudget, FlexiPipeline,  # noqa: E402
                                  SamplingPlan)
from repro_torch.serving import CacheSpec, ServingEngine  # noqa: E402
from repro_torch.telemetry import Telemetry  # noqa: E402

DEV = torch.device("cuda")
SEED = 0
HBM_BYTES_PER_S = 3.35e12           # H100 SXM published peaks
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py
# patch embed: the JAX package's PE level (sums of up to 1152 products in
# another order; bf16 outputs within one rounding). SSD: the cumulative log
# decay of a 128-step chunk is summed in another order than torch.cumsum;
# at |L| ~ 150 a float32 ulp is 1.5e-5 and exp(L_q - L_k) turns a few into
# ~1e-4 relative (the JAX package holds its SSD kernel at 2e-3).
PE_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
SSD_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
BUDGETS = (0.6, 0.8, 1.0)
BATCH = 4                           # requests per batch (CFG runs 2x4 rows)
T_STEPS = 10

# the JAX package's ATTN_CASES (tests/test_kernels.py) and the main path's
# shapes: B = 2 x 4 rows under CFG, 256 tokens at patch 2, 64 at patch 4
ATTN_CASES = [
    # B, S, H, K, hd, causal, softcap, window, dtype
    (2, 128, 4, 2, 64, True, 0.0, 0, torch.float32),
    (1, 256, 4, 4, 64, True, 50.0, 0, torch.float32),
    (2, 256, 8, 2, 32, True, 0.0, 128, torch.float32),
    (1, 128, 2, 1, 128, False, 0.0, 0, torch.float32),
    (1, 256, 4, 2, 64, True, 0.0, 0, torch.bfloat16),
    (2, 384, 6, 2, 64, True, 30.0, 256, torch.float32),
    (2 * BATCH, 256, 16, 16, 72, False, 0.0, 0, torch.bfloat16),
    (2 * BATCH, 64, 16, 16, 72, False, 0.0, 0, torch.bfloat16),
]


# the JAX package's PE_CASES (N, K, M) and the DiT-XL/2 tokenizer at B=8:
# embed mode 0 / 1, de-embed mode 0 / 1 (c_out 8 x pp 4 / 16)
PE_CASES = [(512, 64, 256, torch.float32), (256, 48, 128, torch.float32),
            (1024, 128, 512, torch.bfloat16), (256, 16, 64, torch.float32)]
PE_PATH = {"patch_embed": [(2048, 16, 1152), (512, 64, 1152)],
           "patch_deembed": [(2048, 1152, 32), (512, 1152, 128)]}
# the cluster de-embed at a ragged N and at K not in whole 64-chunks (the
# last slice's box partly past K)
DEEMBED_EXTRA = [(2000, 1152, 32), (256, 1000, 64), (100, 72, 16)]
# the TMA/wgmma embed at a ragged N, K = 48 (the JAX package's case) and
# 128, M = 72 (not whole 64s), K an odd number of 8s, N at which each CTA
# walks several row tiles, and the largest K it takes (on a 2-stage ring)
EMBED_EXTRA = [(2000, 16, 1152), (256, 48, 128), (512, 128, 1152), (256, 16, 72),
               (100, 24, 40), (16384, 16, 1152), (8192, 64, 1152), (256, 544, 128)]
# the redesigned kernels: their variant on the path, and the previous one
REDESIGNED = {"patch_embed": ("wgmma", "mma"), "patch_deembed": ("cluster", "mma"),
              "ssd_chunk": ("wgmma", "simt")}
# the JAX package's SSD_CASES (B, S, H, P, N, chunk) and one mamba2-130m
# layer at B=4, S=2048
SSD_CASES = [(2, 64, 4, 16, 8, 16), (1, 96, 2, 32, 16, 32),
             (2, 48, 3, 8, 8, 16), (1, 128, 4, 16, 32, 64)]
SSD_PATH = (4, 2048, 24, 64, 128, 128)
# the bf16 wgmma SSD beyond the path (B, S, H, P, N, chunk, dt scale):
# chunk 64, P = 32, N = 64, H = 25 (a ragged last head group), B nc = 1,
# and time steps 1.6x as large (|L| reaches ~440 within a chunk)
SSD_WGMMA_EXTRA = [(2, 512, 8, 64, 128, 64, 1.0), (2, 512, 8, 32, 128, 128, 1.0),
                   (2, 256, 4, 64, 64, 128, 1.0), (2, 512, 25, 64, 128, 128, 1.0),
                   (1, 128, 4, 64, 128, 128, 1.0), (2, 1024, 8, 64, 128, 128, 1.6)]
SSM_SEQS = (2048, 2000)             # the layer path: whole chunks, then padded
# the serving phase: a wave of 12 requests over the budget menu, 3 more
# joining after two engine steps; steps_per_dispatch 8, the default
# max_tokens_per_step (4 CFG pairs of 256 tokens = 2048 tokens a step)
SERVE_WAVE, SERVE_JOIN, SERVE_K = 12, 3, 8
# x0 of a packed request against the same request sampled alone: both run
# the bf16 flash kernel, on other GEMM shapes and other tile groupings
# (four 64-token segments share a 128-row tile), and DDIM amplifies each
# rounding (PERF.md §7); held as ||x0 - ref|| / ||ref|| per request, a
# ratio that a few large entries do not set. The phase also serves the
# wave with every segment id planted to 0 (a wrong packing) and fails
# unless every request with weak steps then reads over the limit. On an
# H100 80GB HBM3 (700 W) sound requests read at most 1.1e-3 and the
# planted fault 9.2e-3 to 1.6e-2 (PERF.md §6): the limit sits between.
SERVE_X0_TOL = 3e-3
# a served layout for the kernel check at the engine's shapes: 6 mode-0
# and 7 mode-1 requests, CFG-doubled, first-fit into rows of 256 tokens:
# 12 full mode-0 rows, 3 rows of four 64-token segments, and one row of
# two segments and a 128-token padding tail (16 rows)
SERVED_GROUPS = ((256, 12), (64, 14))
# phase 8: the text-to-image transformer's self-attention at B=2 (4096
# tokens at patch 2, 1024 at the weak patch 4), 16 heads x 128
T2I_ATTN = [(2, 4096, 16, 128), (2, 1024, 16, 128)]
# the flash kernel at those shapes, held on the output's own scale: over
# ~1,500 keys of weight a typical |o| is ~0.02, as small as TOL's bf16
# level, so the check is ||o - ref|| / ||ref||. Two planted faults, the
# kernel handed a tile map that hides one 64-wide kv tile of every row
# or the second half of them, must read over the limit (PERF.md §6).
T2I_ATTN_REL_TOL = 1e-2
T2I_BATCH, T2I_BUDGETS, T2I_SOLVERS = 2, (0.6, 1.0), ("flow_euler", "flow_heun")
# x0 through the flash kernel against the same plan on the dense backend,
# held as ||x0 - dense|| / ||dense||; the planted fault (the kv tile walk
# stopping halfway) must read over the limit on every run. On an H100
# 80GB HBM3 (700 W) the sound runs read 1.9e-3 to 3.1e-3 (bf16 rounding,
# P rounded to bf16 before P.V) and the fault 7.1e-3 to 1.1e-2: with
# random weights x0 depends weakly on attention (PERF.md §6). The limit
# sits between, 1.5x from each; the readings are deterministic.
T2I_X0_TOL = 4.7e-3
# phases 9 and 13: every train step runs captured (runtime.graphs, the
# parameters and the AdamW state donated) and is held against the same
# step under graphs.disabled(): COMPARE_STEPS calls a step object each
# way from the same parameters, moments and draws, then the loss and every
# parameter and moment leaf must be equal bit for bit (0 leaves differing,
# the limit). The planted fault (the body reading its draws, or its batch,
# from the step object instead of its copied-in argument: a replay reads
# the first call's) must read over it. The check's eager calls but the
# first time the eager step (3 a step object), with one more each timed
# round but the first where an eager step fits beside the graphs' pools
COMPARE_STEPS = 4
# bytes the card keeps spare when the check holds the eager run's end
# state beside a step's peak (else the state goes to pinned host memory)
SNAPSHOT_MARGIN = 8e9
# phase 9: training at full width. The captured-vs-eager check, then
# TRAIN_K more captured steps a mode, timed (B = 32, the usual per-device
# DiT batch); eager ms/step from the check's calls a mode; LEARN_N steps
# on one fixed batch with fixed draws, the mean loss of the last
# LEARN_TAIL against the loss before any update held under LEARN_LIMIT,
# and the same steps with the update's sign flipped held over it. On an
# H100 80GB HBM3 (700 W) the sound run reads 0.230 and the sign-flipped
# one 1762 (deterministic across repeats; PERF.md §6): the limit sits
# 2.2x over the sound reading
TRAIN_BATCH, TRAIN_K, TRAIN_LR = 32, 2, 1e-4
LEARN_BATCH, LEARN_N, LEARN_TAIL, LEARN_LR = 8, 12, 3, 3e-4
LEARN_LIMIT = 0.5
# the card against the CPU on the tests' tiny float32 config (TF32 off)
CARD_CPU_TOL = 1e-5
# phase 10: the fleet. FLEET_N requests (the phase-7 wave's size) over
# FLEET_REPLICAS packed replicas on the virtual clock; the chaos run is
# resilience/chaos.default_fault_plan's (4 replicas, 32 requests, every
# fault kind); the replay abandons a 2-replica fleet of 8 requests after 2
# finish. Every x0 is held at SERVE_X0_TOL against its own reference: a
# packed request runs GEMMs of other shapes than the request alone
FLEET_N, FLEET_REPLICAS = 15, 3
FLEET_JOURNAL = ROOT / "build" / "fleet_journal.jsonl"
# the language models' head width 256 at gemma2-9b's prefill shape (B=2,
# S=8192, H=16 over K=8): the local layers (causal, window 4096, softcap
# 50), the global ones (window 0) and a ragged S, in every variant. Held
# on the output's scale, ||o - ref|| / ||ref||, as the text-to-image
# shapes: a bf16 output of |o| in [2, 4) is one ulp = 1.6e-2 from its
# float32 value, so max|err| sits at the 2e-2 level by rounding alone
# (float32 is held at TOL's max|err|)
HD256_CASES = [
    # B, S, H, K, causal, softcap, window
    (2, 8192, 16, 8, True, 50.0, 4096),
    (2, 8192, 16, 8, True, 50.0, 0),
    (2, 8000, 16, 8, True, 50.0, 4096),
]
HD256_REL_TOL = 1e-2
# phase 11: language-model serving. gemma2-9b whole (42 layers, d=3584,
# vocab 256000, bf16, random weights drawn on the card from a seed):
# prefill B=2 x S=8192 through make_prefill_step on the flash kernel, then
# LM_DECODE greedy decode steps; the other configs at full width with
# depth cut to LM_CUT_LAYERS (mamba2-130m whole), prefill B=2 x
# LM_SMALL_SEQ and LM_SMALL_DECODE steps. Logits on the flash kernel are
# held against the dense backend as ||logits - dense|| / ||dense||, a
# ratio over the whole vocabulary that a few entries do not set; the
# planted fault (the local layers' window dropped to 0) must read over it.
# On an H100 80GB HBM3 (700 W) gemma2-9b reads 1.81e-2 at prefill and at
# every decode step (bf16 rounding in other places over 42 layers: the
# kernel's unnormalised P, the products' order), the 2-layer configs 3e-3
# to 8e-3, and the planted fault 0.317 (PERF.md §6): the limit sits 3.3x
# over the sound reading and 5.3x under the fault.
LM_FULL = "gemma2-9b"
LM_BATCH, LM_SEQ, LM_DECODE = 2, 8192, 16
LM_CUT = ("deepseek-7b", "qwen2.5-14b", "gemma3-4b", "hymba-1.5b", "mamba2-130m")
LM_CUT_LAYERS = 2
LM_SMALL_SEQ, LM_SMALL_DECODE = 2048, 4
LM_LOGIT_TOL = 6e-2
LM_CLI = ["--arch", LM_FULL, "--requests", "4", "--batch-slots", "2",
          "--prompt-len", "512", "--max-new", "16"]
# phase 12: the MoE, vision and audio language models, each prefilled on
# the flash kernel and on the dense backend and decoded from both caches,
# logits held as in phase 11 (LM_LOGIT_TOL). (name, layers kept (0: the
# whole model), batch, prompt, decode steps)
FAM_RUNS = [("deepseek-moe-16b", 0, 2, 4096, 16), ("grok-1-314b", 2, 2, 2048, 4),
            ("llama-3.2-vision-90b", 10, 2, 2048, 4), ("whisper-small", 0, 4, 64, 16)]
# the flash kernel at the shapes these models give it, against its plain
# version on the output's scale (as the hd-256 shapes): deepseek-moe-16b
# and grok-1 prefill (causal, GQA group 1 and 6), llama-3.2-vision's self
# layers (group 8), whisper's encoder (non-causal, 1500 = 11 x 128 + 92
# keys: a ragged last tile of zero-filled keys that must get no weight)
FAM_ATTN = [
    # name, B, S, H, K, hd, causal
    ("deepseek-moe-16b", 2, 4096, 16, 16, 128, True),
    ("grok-1-314b", 2, 2048, 48, 8, 128, True),
    ("llama-3.2-vision-90b", 2, 2048, 64, 8, 128, True),
    ("whisper-small encoder", 4, 1500, 12, 12, 64, False),
]
FAM_ATTN_REL_TOL = 1e-2
# one deepseek-moe-16b MoE layer at full width, [2, 512, 2048] bf16, with
# capacity_factor raised to E / k so nothing drops: moe_apply_sorted
# against the dense oracle as ||y - ref|| / ||ref||; the planted fault
# (the router's columns rolled by one) must read over the limit. The
# routed experts are held without the shared ones: the reference's init
# counts the stacked expert axis in each expert matrix's fan-in, so a
# routed expert's output is ~8^3 times smaller than the shared MLP's, and
# beside it a wrong routing moves the layer's output by under 1e-3
MOE_LAYER_SHAPE = (2, 512)
MOE_LAYER_TOL = 2e-2
# the vision model's cross gates start at 0 (tanh 0 = 0 closes the cross
# path): the phase sets them to this value so the path carries weight
VLM_GATE = 1.0
FAM_CLI = [["--arch", "deepseek-moe-16b", "--requests", "4", "--batch-slots", "2",
            "--prompt-len", "512", "--max-new", "16"],
           ["--arch", "whisper-small", "--requests", "4", "--batch-slots", "2",
            "--prompt-len", "64", "--max-new", "16"]]

# phase 17: the LM serving loop's two runners at full width, depth cut to
# (name, layers kept): two batches of LM_G_BATCH x LM_G_SEQ with
# LM_G_DECODE decode steps each, captured and under graphs.disabled()
LM_GRAPHS = (("gemma2-9b", 2), ("deepseek-moe-16b", 2))
LM_G_BATCH, LM_G_SEQ, LM_G_DECODE = 2, 1024, 8

# phase 13: language-model training, bf16, random weights drawn on the
# card. (name, layers kept, batch, sequence): gemma2-9b at full width cut
# to 2 local (window 4096) and 2 global layers at one 8192-token row, so
# the window binds; deepseek-moe-16b at full width cut to 2 layers. Both
# take the captured-vs-eager check (COMPARE_STEPS calls each way, two
# batches of the trainer's corpus in turn), then LMT_K more captured steps,
# timed, through make_train_step (remat "block", their configs' default).
LMT_DENSE = ("gemma2-9b", 4, 1, 8192)
LMT_MOE = ("deepseek-moe-16b", 2, 2, 4096)
LMT_K, LMT_LR = 2, 1e-4
# check 3: each bf16 gradient leaf against a float32 copy's (TF32 off) as
# ||g - g32|| / ||g32||; the planted fault (each layer recomputed in the
# backward with the next layer's window) must read over it. Fixed before
# the first card run (PERF.md §6): bf16 rounds each activation to ~4e-3,
# and a wrong window changes the attention of every query past 4096 in
# half the recomputed layers. On an H100 80GB HBM3 (700 W) sound leaves
# read at most 1.18e-2 and the fault 0.485
LMT_GRAD_TOL = 0.1
# check 4: remat "none" at gemma2-9b's cut needs every layer's float32
# scores at once; 6144 tokens keep it under the card's memory (the window
# still binds)
LMT_REMAT_SEQ = 6144
# check 5: LMT_LEARN_N steps on one batch of the trainer's corpus
# (B x S below), mean(last LEARN_TAIL) / first loss under the limit, and
# over it with the update's sign flipped. Fixed before the first card run
# (PERF.md §6); on an H100 80GB HBM3 (700 W) the sound run reads 0.188
# and the flipped one 1.93
LMT_LEARN_B, LMT_LEARN_S, LMT_LEARN_N, LMT_LEARN_LR = 2, 1024, 12, 3e-4
LMT_LEARN_LIMIT = 0.7
# one config per remaining family, 2 steps each: (name, layers kept (0:
# whole), batch, sequence). The vision cut (one group: 4 self layers and
# the cross layer, 6.4 B parameters) trains its cross layer and vision
# projection with the language model frozen, as Llama 3.2 Vision trained
# its adapter: the moments of 6.4 B parameters (51 GB) do not fit beside
# them
LMT_FAMILIES = [("hymba-1.5b", 2, 2, 2048), ("mamba2-130m", 0, 4, 2048),
                ("llama-3.2-vision-90b", 5, 1, 2048), ("whisper-small", 0, 4, 448)]
# check 1: one reduced float32 config per family, card against CPU, at
# the tests' shapes
LMT_CPU_ARCHS = ("gemma2-9b", "hymba-1.5b", "mamba2-130m", "deepseek-moe-16b",
                 "llama-3.2-vision-90b", "whisper-small")
LMT_DECODE = 4
LMT_CLI = [["--arch", "mamba2-130m", "--steps", "4"],
           ["--arch", "deepseek-moe-16b", "--smoke"]]


def log(msg: str) -> None:
    print(msg, flush=True)


def randn(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


# ---------------------------------------------------------------------------
# Phase 1: build


def kernel_resources(log: str) -> list:
    """(kernel, registers, spill bytes) per entry function of nvcc's
    ``-Xptxas -v`` report; template arguments kept as <a,b,...>."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            short = re.search(r"\d([a-z][a-z_]*_kernel)", mangled)
            args = re.findall(r"Li(\d+)E", mangled)
            name = short.group(1) if short else mangled
            name += f"<{','.join(args)}>" if args else ""
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name, spill = None, 0
    return out


def phase_build() -> None:
    t0 = time.perf_counter()
    report = build.build_all()
    log(f"[build] {len(report)} kernel source(s) built in "
        f"{time.perf_counter() - t0:.1f}s (one nvcc each, in parallel)")
    for name, rep in report.items():
        res = kernel_resources(rep["log"])
        log(f"[build]   {name}: {rep['seconds']:.1f}s; registers (spill bytes) "
            "per kernel: " + "; ".join(f"{k} {r} ({sp})" for k, r, sp in res))


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions


# bf16 cases of the TMA/wgmma kernel beyond those: ragged S, GQA, causal
# with window, softcap, hd 64 and 128, and one long causal row past the
# 8192 tokens at which the JAX package sends every sequence to this kernel
# (src/repro/models/attention.py:41)
WGMMA_CASES = [
    # B, S, H, K, hd, causal, softcap, window
    (2, 100, 4, 4, 72, False, 0.0, 0),
    (2, 200, 4, 4, 72, True, 0.0, 0),
    (2, 300, 4, 4, 72, False, 0.0, 0),
    (2, 256, 8, 2, 64, True, 0.0, 0),
    (2, 384, 4, 2, 64, True, 0.0, 128),
    (1, 256, 4, 4, 64, True, 50.0, 0),
    (2, 256, 4, 4, 128, False, 0.0, 0),
    (1, 9000, 2, 2, 64, True, 0.0, 0),
]
MAP_BLOCKS = [(64, 64), (48, 80), (128, 128)]


def packed_case(gen: torch.Generator):
    """Three requests packed in rows of 256 tokens, padding -1, and a
    caller's block map that also hides some tiles the segments allow."""
    B, S, H, hd = 2, 256, 16, 72
    seg = torch.full((B, S), -1, dtype=torch.int32)
    seg[0, :64], seg[0, 64:192] = 0, 1
    seg[1, :150] = 0
    bmap = torch.ones((B, 2, 2), dtype=torch.int32)
    bmap[0, 0, 1] = 0
    q, k, v = (randn(gen, (B, S, H, hd), torch.bfloat16) for _ in range(3))
    return q, k, v, dict(causal=False, segment_ids=seg.to(DEV),
                         block_map=bmap.to(DEV))


def packed_map_case(gen: torch.Generator, bq: int, bk: int):
    """Packed causal rows of 200 tokens with padding and a random caller's
    map at block_q x block_k (48 x 80 straddles the kernel's tiles)."""
    B, S, H, hd = 2, 200, 4, 72
    seg = torch.full((B, S), -1, dtype=torch.int32)
    seg[0, :70], seg[0, 70:150] = 0, 1
    seg[1, :30], seg[1, 30:190] = 0, 1
    bmap = (torch.rand((B, -(-S // bq), -(-S // bk)), generator=gen,
                       device=DEV) < 0.7).to(torch.int32)
    q, k, v = (randn(gen, (B, S, H, hd), torch.bfloat16) for _ in range(3))
    return q, k, v, dict(causal=True, segment_ids=seg.to(DEV), block_map=bmap,
                         block_q=bq, block_k=bk)


def phase_kernel_checks(gen: torch.Generator, gen_new: torch.Generator) -> float:
    """Flash attention against its plain version; every bf16 case also
    against the previous (mma.sync) kernel, and every bf16 case with rows
    of whole 16-byte chunks must select the TMA/wgmma kernel. The cases
    added with the TMA/wgmma kernel draw from ``gen_new``, so the earlier
    cases and the later phases keep the inputs they had."""
    worst = 0.0
    cases = [(f"B{B} S{S} H{H} K{K} hd{hd} causal={int(c)} cap={cap} "
              f"win={w} {str(dt)[6:]}",
              [randn(gen, (B, S, h, hd), dt) for h in (H, K, K)],
              dict(causal=c, softcap=cap, window=w))
             for B, S, H, K, hd, c, cap, w, dt in ATTN_CASES]
    q, k, v, kw = packed_case(gen)
    cases.append(("packed B2 S256 3 segments + padding + block map bf16",
                  [q, k, v], kw))
    cases += [(f"B{B} S{S} H{H} K{K} hd{hd} causal={int(c)} cap={cap} "
               f"win={w} bfloat16",
               [randn(gen_new, (B, S, h, hd), torch.bfloat16) for h in (H, K, K)],
               dict(causal=c, softcap=cap, window=w))
              for B, S, H, K, hd, c, cap, w in WGMMA_CASES]
    for bq, bk in MAP_BLOCKS:
        q, k, v, kw = packed_map_case(gen_new, bq, bk)
        cases.append((f"packed B2 S200 causal, map {bq}x{bk} bf16", [q, k, v], kw))
    for name, (q, k, v), kw in cases:
        got = ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v, **kw)
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[q.dtype]
        worst = max(worst, err)
        variant = variant_of(q, k, v)
        line = f"[kernel] flash_attention ({variant}) {name}: max|err|={err:.3e}"
        if q.dtype == torch.bfloat16:
            if variant != "wgmma":
                raise AssertionError(f"{name}: selects {variant}, not wgmma")
            prev = flash_attention_cuda(q, k, v, **ops.kernel_kwargs(q, k, **kw),
                                        variant="mma")
            torch.cuda.synchronize()
            err_prev = (got.float() - prev.float()).abs().max().item()
            line += f", vs mma kernel {err_prev:.3e}"
            if not err_prev <= tol:
                raise AssertionError(f"wgmma and mma kernels disagree on {name}: "
                                     f"{err_prev} > {tol}")
        log(f"{line} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version on {name}: {err} > {tol}")
        if kw.get("segment_ids") is not None:
            seg = kw["segment_ids"]
            if not torch.all(got[seg < 0] == 0):
                raise AssertionError("padding rows must return exactly 0")
    return worst


def phase_t2i_kernel_checks(gen: torch.Generator) -> float:
    """The flash kernel at the text-to-image transformer's shapes (hd 128
    over rows of 4096 and 1024 tokens, no segment ids, no map: every CTA
    walks all kv tiles) against its plain version, before anything is
    timed, at ``T2I_ATTN_REL_TOL``; then the planted faults, which must
    read over it. On its own generator, so the earlier cases keep their
    inputs. Returns the worst max|err| of the sound runs."""
    worst = 0.0
    for B, S, H, hd in T2I_ATTN:
        q, k, v = (randn(gen, (B, S, H, hd), torch.bfloat16) for _ in range(3))
        got = ops.flash_attention(q, k, v, causal=False)
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v, causal=False).float()
        variant = variant_of(q, k, v)
        if variant != "wgmma":
            raise AssertionError(f"B{B} S{S} hd{hd}: selects {variant}, not wgmma")
        rel = lambda o: ((o.float() - want).norm() / want.norm()).item()
        err = (got.float() - want).abs().max().item()
        nk = S // 64
        faults = {}
        for fault, hidden in (("one kv tile dropped", slice(0, 1)),
                              ("tile walk stops halfway", slice(nk // 2, nk))):
            bmap = torch.ones((B, S // 128, nk), dtype=torch.int32, device=DEV)
            bmap[:, :, hidden] = 0
            faults[fault] = rel(ops.flash_attention(
                q, k, v, causal=False, block_map=bmap, block_q=128, block_k=64))
        log(f"[kernel] flash_attention ({variant}) B{B} S{S} H{H} hd{hd} bf16 "
            f"(text-to-image): ||err||/||ref||={rel(got):.3e} (tol "
            f"{T2I_ATTN_REL_TOL}), max|err|={err:.3e}, max|ref|="
            f"{want.abs().max().item():.3e}; planted faults "
            + ", ".join(f"{f} {r:.3e}" for f, r in faults.items()))
        if not rel(got) <= T2I_ATTN_REL_TOL:
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version at B{B} S{S} H{H} hd{hd}: "
                                 f"{rel(got)} > {T2I_ATTN_REL_TOL}")
        missed = [f for f, r in faults.items() if not r > T2I_ATTN_REL_TOL]
        if missed:
            raise AssertionError(f"B{B} S{S} hd{hd}: planted faults {missed} "
                                 f"read within {T2I_ATTN_REL_TOL}")
        worst = max(worst, err)
    return worst


def ssd_inputs(gen: torch.Generator, B, S, H, P, N, dtype, dt_scale=1.0):
    x = randn(gen, (B, S, H, P), dtype)
    dt = F.softplus(randn(gen, (B, S, H))) * dt_scale
    A = -torch.exp(randn(gen, (H,)) * 0.5)
    return x, dt, A, randn(gen, (B, S, N)), randn(gen, (B, S, N))


def check(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    err = (got.float() - want.float()).abs().max().item()
    log(f"[kernel] {name}: max|err|={err:.3e} (tol {tol} abs + rel)")
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    return err


def phase_new_kernel_checks(gen: torch.Generator, gen_new: torch.Generator) -> dict:
    """The patch embed / de-embed and SSD kernels against their plain
    versions: the JAX package's cases, then each path's shapes; every bf16
    case of the three redesigned kernels also against the previous kernel,
    and equal bit for bit when repeated. The cluster de-embed's, the wgmma
    embed's and then the wgmma SSD's extra shapes draw from ``gen_new``."""
    worst = {"patch_embed": 0.0, "patch_deembed": 0.0, "ssd_chunk": 0.0}
    kernels = {"patch_embed": (patch_embed_cuda, patch_embed_ref),
               "patch_deembed": (patch_deembed_cuda, patch_deembed_ref)}
    cases = [(name, N, K, M, dt) for N, K, M, dt in PE_CASES for name in kernels]
    cases += [(name, N, K, M, torch.bfloat16)
              for name, shapes in PE_PATH.items() for N, K, M in shapes]
    cases += [("patch_deembed", N, K, M, torch.bfloat16) for N, K, M in DEEMBED_EXTRA]
    n_old = len(cases) - len(DEEMBED_EXTRA)
    cases += [("patch_embed", N, K, M, torch.bfloat16) for N, K, M in EMBED_EXTRA]
    for i, (name, N, K, M, dt) in enumerate(cases):
        g = gen_new if i >= n_old else gen
        x, w, b = (randn(g, shape, dt) for shape in ((N, K), (K, M), (M,)))
        kernel, plain = kernels[name]
        got = kernel(x, w, b)
        torch.cuda.synchronize()
        label = f"{name} N{N} K{K} M{M} {str(dt)[6:]}"
        if dt == torch.bfloat16:
            new, old = REDESIGNED[name]
            if name == "patch_deembed":
                variant = deembed_variant_of(x, w)
                plan = deembed_plan(N, K, M)
                label += (f" (cluster {plan.cluster} x {plan.k_slice}-deep slices, "
                          f"{plan.ctas(N, M)} CTAs)")
            else:
                variant = embed_variant_of(x, w, b)
                ctas, stages, _ = embed_launch_plan(N, K, M)
                label += (f" ({embed_plan(N, K, M).tiles} tiles on {ctas} CTAs, "
                          f"{stages} stages)")
            if variant != new:
                raise AssertionError(f"{label}: selects {variant}, not {new}")
            prev = kernel(x, w, b, variant=old)
            again = kernel(x, w, b)
            torch.cuda.synchronize()
            check(f"{label} vs {old} kernel", got, prev, PE_TOL[dt])
            if not torch.equal(got, again):
                raise AssertionError(f"{label}: two calls differ")
        worst[name] = max(worst[name], check(label, got, plain(x, w, b), PE_TOL[dt]))
    ssd_cases = ([(c + (1.0,), torch.float32, gen) for c in SSD_CASES]
                 + [(SSD_PATH + (1.0,), torch.float32, gen),
                    (SSD_PATH + (1.0,), torch.bfloat16, gen)]
                 + [(c, torch.bfloat16, gen_new) for c in SSD_WGMMA_EXTRA])
    for case, dt, g in ssd_cases:
        B, S, H, P, N, Q, scale = case
        x, dts, A, Bm, Cm = ssd_inputs(g, B, S, H, P, N, dt, scale)
        got = ssd_chunk_cuda(x, dts, A, Bm, Cm, Q)
        torch.cuda.synchronize()
        want = ssd_chunk_ref(x, dts, A, Bm, Cm, Q)
        label = (f"ssd_chunk B{B} S{S} H{H} P{P} N{N} Q{Q} {str(dt)[6:]}"
                 f"{f' dt x{scale} (max|Ltot| {want[2].abs().max().item():.1f})' if scale != 1 else ''}")
        variant = ssd_variant_of(x, Bm, Cm, Q)
        if dt == torch.bfloat16:
            new, old = REDESIGNED["ssd_chunk"]
            if variant != new:
                raise AssertionError(f"{label}: selects {variant}, not {new}")
            prev = ssd_chunk_cuda(x, dts, A, Bm, Cm, Q, variant=old)
            again = ssd_chunk_cuda(x, dts, A, Bm, Cm, Q)
            torch.cuda.synchronize()
            for part, gp, pp, tol in zip(("y", "Sc", "Ltot"), got, prev,
                                         (SSD_TOL[dt],) + (SSD_TOL[torch.float32],) * 2):
                check(f"{label} {part} ({new}) vs {old} kernel", gp, pp, tol)
            if not all(torch.equal(u, v) for u, v in zip(got, again)):
                raise AssertionError(f"{label}: two calls differ")
        errs = [check(f"{label} y ({variant})", got[0], want[0], SSD_TOL[dt])]
        errs += [check(f"{label} {part} ({variant})", g, w, SSD_TOL[torch.float32])
                 for part, g, w in zip(("Sc", "Ltot"), got[1:], want[1:])]
        if case[:6] == SSD_PATH:
            log(f"[kernel] ssd_chunk path shape {str(dt)[6:]} ({variant}): max|err| y "
                f"{errs[0]:.3e}, Sc {errs[1]:.3e}, Ltot {errs[2]:.3e}")
        worst["ssd_chunk"] = max([worst["ssd_chunk"]] + errs)
    # S not a multiple of the chunk, with a carried state: ops.ssd pads
    B, S, H, P, N, Q = 2, 200, 4, 64, 128, 128
    x, dts, A, Bm, Cm = ssd_inputs(gen, B, S, H, P, N, torch.float32)
    h0 = randn(gen, (B, H, P, N)) * 0.1
    y, h = ssd_ops.ssd(x, dts, A, Bm, Cm, Q, h0)
    torch.cuda.synchronize()
    y_ref, h_ref = ssd_chunked(x, dts, A, Bm, Cm, Q, h0)
    worst["ssd_chunk"] = max(
        worst["ssd_chunk"],
        check(f"ssd (padded) B{B} S{S} Q{Q} + h0 y", y, y_ref, SSD_TOL[torch.float32]),
        check(f"ssd (padded) B{B} S{S} Q{Q} + h0 h", h, h_ref, SSD_TOL[torch.float32]))
    return worst


# ---------------------------------------------------------------------------
# Phase 3: the main path


def trained_like_xl(gen: torch.Generator, num_layers: int | None = None):
    """DiT-XL/2 with random weights (at full width, cut to ``num_layers``
    when given); the zero-initialized de-embedding and adaLN gates made
    non-zero so the sample depends on every block."""
    cfg = get_config("dit-xl-2")
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    params = dit_mod.init_dit(cfg, gen)
    dt = params["deembed"]["w_flex"].dtype
    for node, key, scale in [(params["deembed"], "w_flex", 0.1),
                             (params["final"]["ada"], "w", 0.05),
                             (params["blocks"]["ada"], "w", 0.05)]:
        node[key] = randn(gen, node[key].shape, dt) * scale
    return params, cfg


def forward_calls(plan: SamplingPlan, cfg) -> int:
    """Denoiser forward calls a static plan makes for one batch."""
    per_step = {True: 2, False: 1}
    calls = sum(n * per_step[plan.guidance_active and mode == 0
                             and plan.guidance_kind == "weak_cond"]
                for mode, n in plan.resolve_schedule(cfg).phases)
    return calls * (2 if plan.solver == "dpm2" else 1)


def phase_main_path(gen: torch.Generator) -> dict:
    t0 = time.perf_counter()
    params, cfg = trained_like_xl(gen)
    pipe = FlexiPipeline(params, cfg, linear_schedule(1000), device=DEV)
    del params
    torch.cuda.synchronize()
    log(f"[main] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"heads={cfg.attn.num_heads}x{cfg.attn.head_dim}, "
        f"{cfg.param_dtype}; weights in {time.perf_counter() - t0:.1f}s")
    plans = {b: SamplingPlan(T=T_STEPS, budget=b, attn_backend="pallas")
             for b in BUDGETS}
    for b, plan in plans.items():
        log(f"[main]   budget {b}: schedule {plan.resolve_schedule(cfg).phases}"
            f", relative compute {plan.relative_compute(cfg):.4f}")

    rng = np.random.default_rng(SEED)
    waves = [[(b, rng.integers(0, cfg.dit.num_classes, BATCH).tolist())
              for b in BUDGETS] for _ in range(2)]
    waves[1].reverse()          # the second wave switches budgets the other way
    expected = 0
    first_batch = None
    ops.reset_launches()
    t_serve = time.perf_counter()
    built_after_first = None
    served = 0
    for w, wave in enumerate(waves):
        for b, labels in wave:
            batch_gen = torch.Generator(device=DEV).manual_seed(1000 + served)
            t1 = time.perf_counter()
            res = pipe.sample(plans[b], BATCH, batch_gen,
                              cond=torch.tensor(labels, device=DEV))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            expected += cfg.num_layers * forward_calls(plans[b], cfg)
            if first_batch is None:
                first_batch = (b, labels, res.x0)
            shape = (BATCH,) + tuple(cfg.dit.latent_shape)
            if tuple(res.x0.shape) != shape or not torch.isfinite(res.x0).all():
                raise AssertionError(f"x0 {tuple(res.x0.shape)} not finite or "
                                     f"not {shape}")
            served += BATCH
            log(f"[serve] wave {w} budget {b}: {BATCH} requests in "
                f"{dt * 1e3:.1f} ms, x0 std {res.x0.float().std().item():.4f}")
        if w == 0:
            built_after_first = pipe.cache_stats()["compiled"]
    wall = time.perf_counter() - t_serve
    launches = ops.flash_attention.launches
    by_variant = dict(ops.flash_attention.launches_by_variant)
    stats = pipe.cache_stats()
    log(f"[serve] {served} requests in {wall:.2f}s ({served / wall:.2f} img/s, "
        f"first wave included); runners {stats}")
    if launches != expected:
        raise AssertionError(f"flash_attention launched {launches} times, "
                             f"expected {expected} (layers x forward calls)")
    if by_variant["wgmma"] != launches:
        raise AssertionError(f"flash_attention launches by variant {by_variant}: "
                             f"not all {launches} on the TMA/wgmma kernel")
    log(f"[serve] flash_attention launches {launches} == "
        f"{cfg.num_layers} layers x {expected // cfg.num_layers} forward calls, "
        f"by variant {by_variant}")
    if stats["compiled"] != built_after_first or built_after_first != len(BUDGETS):
        raise AssertionError(f"repeats / budget switches built runners: {stats}")

    # One forward at full width, each mode, flash vs dense backend, at the
    # bf16 kernel tolerance. (Both round the probabilities to bf16 before
    # P·V, as the TPU kernel does; they sum in other orders.)
    x = randn(gen, (2 * BATCH,) + tuple(cfg.dit.latent_shape))
    t = torch.full((2 * BATCH,), 500, device=DEV)
    y = torch.arange(2 * BATCH, device=DEV)
    for mode in range(1 + len(cfg.dit.flex_patch_sizes)):
        outs = [dit_mod.dit_forward(pipe.params, x, t, y, cfg, mode=mode,
                                    attn_backend=be).float()
                for be in ("pallas", "dense")]
        err = (outs[0] - outs[1]).abs().max().item()
        log(f"[serve] forward mode {mode} flash vs dense backend: "
            f"max|err|={err:.3e} (tol 2e-2 abs + rel)")
        torch.testing.assert_close(outs[0], outs[1], atol=2e-2, rtol=2e-2)

    # The same plan with the dense backend, same prior and labels. DDIM's
    # x0 prediction divides by sqrt(alpha_bar_t) (~0.006 at t=999), which
    # amplifies those bf16 differences step by step, so x0 is held on its
    # own scale: max|err| <= 2e-2 * max(1, max|x0|).
    b, labels, x0 = first_batch
    dense = pipe.sample(SamplingPlan(T=T_STEPS, budget=b, attn_backend="dense"),
                        BATCH, torch.Generator(device=DEV).manual_seed(1000),
                        cond=torch.tensor(labels, device=DEV)).x0
    err = (x0.float() - dense.float()).abs().max().item()
    scale = max(1.0, dense.float().abs().max().item())
    log(f"[serve] x0 flash vs dense backend (budget {b}): max|err|={err:.3e}, "
        f"max|x0|={scale:.3f} (tol {2e-2 * scale:.3e})")
    if not err <= 2e-2 * scale:
        raise AssertionError(f"x0 differs between backends: {err}")
    return {"launches": launches, "pipe": pipe}


# ---------------------------------------------------------------------------
# Phase 4: the tokenizer path


def phase_tokenizer(gen: torch.Generator, pipe: FlexiPipeline) -> dict:
    """Each patch size of DiT-XL/2: tokenize a B=8 latent and de-tokenize
    the tokens with the pipeline's weights through the kernels' ops entry,
    against the port's core/patch.py path (the tokenizer dit_forward runs)."""
    cfg = pipe.cfg
    dit = cfg.dit
    emb, de = pipe.params["embed"], pipe.params["deembed"]
    c_out = dit_mod.c_out_dim(cfg)
    # the biases are zero-initialized: give them values so the path adds them
    emb = dict(emb, b=randn(gen, emb["b"].shape, emb["b"].dtype) * 0.1)
    de = dict(de, b_flex=randn(gen, de["b_flex"].shape, de["b_flex"].dtype) * 0.1)
    x = randn(gen, (2 * BATCH,) + tuple(dit.latent_shape), torch.bfloat16)
    pp = dit.underlying_patch_size
    patches = (dit.patch_size,) + dit.flex_patch_sizes
    pe_ops.reset_launches()
    for p in patches:
        tok = pe_ops.embed_tokens_flex(emb["w_flex"], emb["b"], x, p, pp)
        out = pe_ops.deembed_tokens_flex(de["w_flex"], de["b_flex"], tok,
                                         dit.latent_shape, p, pp, c_out)
        torch.cuda.synchronize()
        tok_ref = patch_mod.embed_tokens_flex(emb["w_flex"], emb["b"], x, p, pp)
        out_ref = patch_mod.deembed_tokens_flex(de["w_flex"], de["b_flex"], tok,
                                                dit.latent_shape, p, pp, c_out)
        shape = (2 * BATCH,) + tuple(dit.latent_shape[:3]) + (c_out,)
        if tuple(out.shape) != shape or not torch.isfinite(out).all():
            raise AssertionError(f"de-tokenized {tuple(out.shape)} not finite "
                                 f"or not {shape}")
        n = tok.shape[1]
        log(f"[tokenizer] patch {p}: {n} tokens x {tok.shape[2]}")
        check(f"embed_tokens_flex patch {p} vs core/patch.py", tok, tok_ref, 2e-2)
        check(f"deembed_tokens_flex patch {p} vs core/patch.py", out, out_ref, 2e-2)
    launches = {"patch_embed": pe_ops.embed_tokens_flex.launches,
                "patch_deembed": pe_ops.deembed_tokens_flex.launches}
    by_variant = {"patch_embed": dict(pe_ops.embed_tokens_flex.launches_by_variant),
                  "patch_deembed": dict(pe_ops.deembed_tokens_flex.launches_by_variant)}
    if any(n != len(patches) for n in launches.values()):
        raise AssertionError(f"tokenizer launches {launches}, expected "
                             f"{len(patches)} each (one per patch size)")
    for name in launches:
        new = REDESIGNED[name][0]
        if by_variant[name][new] != len(patches):
            raise AssertionError(f"{name} launches by variant {by_variant[name]}: "
                                 f"not all {len(patches)} on the {new} kernel")
    log(f"[tokenizer] launches {launches} == {len(patches)} patch sizes; "
        f"by variant {by_variant}")
    return launches


# ---------------------------------------------------------------------------
# Phase 5: one Mamba2 layer


def phase_mamba_layer(gen: torch.Generator) -> dict:
    """One mamba2-130m layer, bf16, random weights with decay rates and
    time steps that vary across heads, through ssm_apply(use_kernel=True)
    at S=2048 and at S=2000 (padded), against use_kernel=False."""
    cfg = get_config("mamba2-130m")
    d, scfg = cfg.d_model, cfg.ssm
    params = init_tree(ssm_mod.ssm_schema(d, scfg), gen, torch.bfloat16)
    H = params["A_log"].shape[0]
    params["A_log"] = (randn(gen, (H,)) * 0.5).to(torch.bfloat16)
    params["dt_bias"] = (randn(gen, (H,)) * 0.5).to(torch.bfloat16)
    d_in, _, P = ssm_mod.ssm_dims(d, scfg)
    log(f"[mamba] {cfg.name} layer: d={d}, d_inner={d_in}, {H} SSD heads x "
        f"{P}, state {scfg.state_dim}, chunk {scfg.chunk_size}, bf16")
    B = 4
    inputs = {S: randn(gen, (B, S, d), torch.bfloat16) for S in SSM_SEQS}
    ssd_ops.reset_launches()
    outs = {}
    for S, u in inputs.items():
        t0 = time.perf_counter()
        outs[S] = ssm_mod.ssm_apply(params, u, scfg, d, use_kernel=True)
        torch.cuda.synchronize()
        log(f"[mamba] B{B} S{S}: ssm_apply(use_kernel=True) in "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms (first call of the shape)")
    launches = ssd_ops.ssd.launches
    by_variant = dict(ssd_ops.ssd.launches_by_variant)
    for S, u in inputs.items():
        out, state = outs[S]
        ref, ref_state = ssm_mod.ssm_apply(params, u, scfg, d, use_kernel=False)
        if tuple(out.shape) != (B, S, d) or not torch.isfinite(out).all():
            raise AssertionError(f"layer output {tuple(out.shape)} not finite "
                                 f"or not {(B, S, d)}")
        check(f"ssm_apply B{B} S{S} out, kernel vs plain branch", out, ref, 2e-2)
        check(f"ssm_apply B{B} S{S} state h, kernel vs plain branch",
              state["h"], ref_state["h"], SSD_TOL[torch.float32])
    if launches != len(SSM_SEQS):
        raise AssertionError(f"ssd launched {launches} times, expected "
                             f"{len(SSM_SEQS)} (one per layer call)")
    new, old = REDESIGNED["ssd_chunk"]
    if by_variant != {new: len(SSM_SEQS), old: 0}:
        raise AssertionError(f"ssd launches by variant {by_variant}: not all "
                             f"{len(SSM_SEQS)} on the {new} kernel")
    log(f"[mamba] ssd launches {launches} == {len(SSM_SEQS)} layer calls, "
        f"by variant {by_variant}")
    return {"ssd_chunk": launches}


# ---------------------------------------------------------------------------
# Phase 6: times at each path's shapes


def attention_bound_ms(B, S, H, hd, dtype) -> tuple:
    """Least time for q, k, v read once and o written once, or for the two
    products at the tensor-core peak of the dtype."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * B * S * H * hd * itemsize
    flops = 4 * B * H * S * S * hd
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def turns_line(t: dict) -> str:
    return ", ".join(f"{k} {v['ms']:.4f} ms ({v['min_ms']:.4f}-{v['max_ms']:.4f})"
                     for k, v in t.items())


def phase_timing(gen: torch.Generator) -> dict:
    """The flash kernel at both main-path shapes, in interleaved rounds
    with the previous (mma.sync) kernel and SDPA; its plain version alone."""
    out = {}
    for S in (256, 64):
        B, H, hd, dt = 2 * BATCH, 16, 72, torch.bfloat16
        q, k, v = (randn(gen, (B, S, H, hd), dt) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kw = ops.kernel_kwargs(q, k, causal=False)
        t = interleaved_ms({
            "wgmma": lambda: flash_attention_cuda(q, k, v, **kw, variant="wgmma"),
            "mma": lambda: flash_attention_cuda(q, k, v, **kw, variant="mma"),
            "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt)})
        plain = graph_ms(lambda: flash_attention_ref(q, k, v, causal=False))
        bound, by = attention_bound_ms(B, S, H, hd, dt)
        ms = t["wgmma"]["ms"]
        log(f"[time] flash_attention B{B} S{S} H{H} hd{hd} bf16, medians of "
            f"{t['wgmma']['rounds']} interleaved rounds (fastest-slowest): "
            f"{turns_line(t)}; plain {plain:.4f} ms; bound {bound:.4f} ms "
            f"({by}); {bound / ms:.1%} of the bound, {t['sdpa']['ms'] / ms:.2f}x "
            f"sdpa's speed, {t['mma']['ms'] / ms:.2f}x the mma kernel's")
        out[S] = dict(ms=ms, prev_ms=t["mma"]["ms"], plain_ms=plain,
                      library_ms=t["sdpa"]["ms"], bound_ms=bound, bound_by=by)
    # the text-to-image shape (phase 8's path): hd 128 over 4096-token rows
    B, S, H, hd = T2I_ATTN[0]
    q, k, v = (randn(gen, (B, S, H, hd), torch.bfloat16) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kw = ops.kernel_kwargs(q, k, causal=False)
    t = interleaved_ms({
        "wgmma": lambda: flash_attention_cuda(q, k, v, **kw, variant="wgmma"),
        "mma": lambda: flash_attention_cuda(q, k, v, **kw, variant="mma"),
        "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt)},
        calls=5, replays=4)
    plain = graph_ms(lambda: flash_attention_ref(q, k, v, causal=False),
                     calls=2, replays=2)
    bound, by = attention_bound_ms(B, S, H, hd, torch.bfloat16)
    ms = t["wgmma"]["ms"]
    log(f"[time] flash_attention B{B} S{S} H{H} hd{hd} bf16 (text-to-image), "
        f"medians of {t['wgmma']['rounds']} interleaved rounds "
        f"(fastest-slowest): {turns_line(t)}; plain {plain:.4f} ms; bound "
        f"{bound:.4f} ms ({by}); {bound / ms:.1%} of the bound, "
        f"{t['sdpa']['ms'] / ms:.2f}x sdpa's speed, "
        f"{t['mma']['ms'] / ms:.2f}x the mma kernel's")
    out[256]["shapes"] = {f"B{B} S{S} H{H} hd{hd}": dict(
        ms=ms, prev_ms=t["mma"]["ms"], plain_ms=plain,
        library_ms=t["sdpa"]["ms"], bound_ms=bound, bound_by=by)}
    return out[256]


def bound_ms(nbytes: float, flops: float, peak: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_new_timing(gen: torch.Generator) -> dict:
    """Each new kernel at its path's shapes, the first shape listed being
    the one the kernels line reports. The kernels' wrappers are timed
    directly: the ops entries (which count launches) are not called."""
    out = {}
    kernels = {"patch_embed": (patch_embed_cuda, patch_embed_ref),
               "patch_deembed": (patch_deembed_cuda, patch_deembed_ref)}
    for name, shapes in PE_PATH.items():
        kernel, plain = kernels[name]
        new, old = REDESIGNED[name]
        for N, K, M in shapes:
            x, w, b = (randn(gen, shape, torch.bfloat16)
                       for shape in ((N, K), (K, M), (M,)))
            bound, by = bound_ms(2 * (N * K + K * M + M + N * M), 2 * N * K * M,
                                 BF16_FLOPS)
            plain_ms = graph_ms(lambda: plain(x, w, b))
            # the redesigned kernel: interleaved with the previous one
            t = interleaved_ms({
                new: lambda: kernel(x, w, b, variant=new),
                old: lambda: kernel(x, w, b, variant=old),
                "addmm": lambda: torch.addmm(b, x, w)})
            ms, lib = t[new]["ms"], t["addmm"]["ms"]
            log(f"[time] {name} N{N} K{K} M{M} bf16, medians of "
                f"{t[new]['rounds']} interleaved rounds (fastest-slowest): "
                f"{turns_line(t)}; plain {plain_ms:.4f} ms; bound {bound:.4f} ms "
                f"({by}); {bound / ms:.1%} of the bound, {lib / ms:.2f}x addmm's "
                f"speed, {t[old]['ms'] / ms:.2f}x the {old} kernel's")
            out.setdefault(name, dict(ms=ms, prev_ms=t[old]["ms"], plain_ms=plain_ms,
                                      library_ms=lib, bound_ms=bound, bound_by=by))
    B, S, H, P, N, Q = SSD_PATH
    nc = S // Q
    new, old = REDESIGNED["ssd_chunk"]
    for dt in (torch.bfloat16, torch.float32):
        x, dts, A, Bm, Cm = ssd_inputs(gen, B, S, H, P, N, dt)
        variant = ssd_variant_of(x, Bm, Cm, Q)
        if dt == torch.bfloat16:   # the redesigned kernel: interleaved with the previous one
            t = interleaved_ms({
                new: lambda: ssd_chunk_cuda(x, dts, A, Bm, Cm, Q, variant=new),
                old: lambda: ssd_chunk_cuda(x, dts, A, Bm, Cm, Q, variant=old)})
            ms, prev, rounds = t[new]["ms"], t[old]["ms"], f"{turns_line(t)}"
        else:
            ms = graph_ms(lambda: ssd_chunk_cuda(x, dts, A, Bm, Cm, Q))
            prev, rounds = None, f"{variant} {ms:.4f} ms"
        plain_ms = graph_ms(lambda: ssd_chunk_ref(x, dts, A, Bm, Cm, Q), calls=3,
                            replays=3)
        isz = x.element_size()
        nbytes = (2 * B * S * H * P * isz + 4 * (B * S * H + H + 2 * B * S * N)
                  + 4 * (B * nc * H * P * N + B * nc * H))
        # multiply-adds the function needs: C.B and M.x over k <= q only
        tri = Q * (Q + 1) // 2
        flops = 2 * B * nc * (tri * N + H * tri * P + H * Q * P * N)
        # float32-level accuracy on the tensor cores: three bf16 passes
        bound, by = bound_ms(nbytes, 3 * flops, BF16_FLOPS)
        f32_core_ms = flops / F32_FLOPS * 1e3
        log(f"[time] ssd_chunk B{B} S{S} H{H} P{P} N{N} Q{Q} x {str(dt)[6:]}: "
            f"{rounds}; plain {plain_ms:.4f} ms; bound {bound:.4f} ms ({by}: "
            f"{nbytes / 1e6:.1f} MB at 3.35 TB/s; {flops / 1e9:.3f} GFLOP take "
            f"{3 * flops / BF16_FLOPS * 1e3:.4f} ms as three bf16 passes, "
            f"{f32_core_ms:.4f} ms on the f32 CUDA cores); {bound / ms:.1%} of "
            f"the bound" + (f", {prev / ms:.2f}x the {old} kernel's speed"
                            if prev else ""))
        out.setdefault("ssd_chunk", dict(ms=ms, prev_ms=prev, plain_ms=plain_ms,
                                         library_ms=None, bound_ms=bound, bound_by=by))
    return out


# ---------------------------------------------------------------------------
# Phase 7: the serving engine


def serve_wave(engine: ServingEngine, wave) -> list:
    """Submit the wave's first SERVE_WAVE requests, step twice, join the
    rest, drain. ``wave``: [(label, budget)]."""
    out = []
    for label, b in wave[:SERVE_WAVE]:
        engine.submit(cond=label, budget=b)
    for _ in range(2):
        out += engine.step()
    for label, b in wave[SERVE_WAVE:]:
        engine.submit(cond=label, budget=b)
    return out + engine.run()


def phase_served_attention(cfg) -> float:
    """The flash kernel at a served layout's shapes: segment ids from the
    engine's own row planner (``core/packing._pack_plan``), the tile map
    derived from them by ``kernels/attention/ops.kernel_kwargs``, held
    against the plain version; padding rows must come out exactly 0."""
    from repro_torch.core import packing
    plan = packing._pack_plan(SERVED_GROUPS, 256)
    ids = torch.from_numpy(plan.segment_ids).to(DEV)
    B, S = ids.shape
    H = cfg.attn.num_heads
    hd = cfg.d_model // H
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    q, k, v = (randn(gen, (B, S, H, hd), torch.bfloat16) for _ in range(3))
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=False, segment_ids=ids)
    torch.cuda.synchronize()
    by_variant = dict(ops.flash_attention.launches_by_variant)
    want = flash_attention_ref(q, k, v, causal=False, segment_ids=ids)
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[torch.bfloat16]
    name = (f"served layout B{B} S{S} H{H} hd{hd}, {plan.n_seg} segments "
            f"({SERVED_GROUPS}), {int((ids < 0).sum())} padding tokens")
    log(f"[engine] flash_attention {name}: max|err|={err:.3e} (tol {tol}), "
        f"launches by variant {by_variant}")
    if by_variant["wgmma"] != 1 or ops.flash_attention.launches != 1:
        raise AssertionError(f"{name}: launches {by_variant}, not one wgmma")
    if not err <= tol:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version on {name}: {err} > {tol}")
    if not torch.all(got[ids < 0] == 0):
        raise AssertionError(f"{name}: padding rows must return exactly 0")
    return err


def x0_errors(results, refs) -> dict:
    """||x0 - ref|| / ||ref|| of each served request."""
    return {r.request.id: ((r.x0.float() - refs[r.request.id]).norm()
                           / refs[r.request.id].norm()).item()
            for r in results}


def phase_serving(pipe: FlexiPipeline, smi: str) -> dict:
    cfg = pipe.cfg
    L = cfg.num_layers
    served_err = phase_served_attention(cfg)
    plans = {b: SamplingPlan(T=T_STEPS, budget=b, attn_backend="pallas")
             for b in BUDGETS}
    rng = np.random.default_rng(SEED + 7)
    wave = [(int(rng.integers(0, cfg.dit.num_classes)), BUDGETS[i % 3])
            for i in range(SERVE_WAVE + SERVE_JOIN)]
    engine = ServingEngine(pipe, plans, steps_per_dispatch=SERVE_K)
    log(f"[engine] {engine.menu.describe()}")
    t0 = time.perf_counter()
    n_pre = engine.precapture_warm_set(max_per_mode=1)
    log(f"[engine] warm set: {n_pre} small-cohort runners built and run once "
        f"in {time.perf_counter() - t0:.2f}s")
    ops.reset_launches()
    f0, p0 = engine.packed_forwards, engine.block_passes
    walls, waves = [], []
    for w in range(2):
        t1 = time.perf_counter()
        res = serve_wave(engine, wave)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        waves.append(res)
        if w == 0:
            built = engine.cache_stats()["compiled"]
    launches = ops.flash_attention.launches
    by_variant = dict(ops.flash_attention.launches_by_variant)
    forwards = engine.packed_forwards - f0
    if launches != L * forwards or engine.block_passes - p0 != launches:
        raise AssertionError(f"engine: {launches} flash launches for {forwards} "
                             f"packed forwards of {L} layers")
    if by_variant["wgmma"] != launches:
        raise AssertionError(f"engine flash launches by variant {by_variant}: "
                             f"not all on the TMA/wgmma kernel")
    stats = engine.cache_stats()
    if stats["compiled"] != built:
        raise AssertionError(f"the replayed wave built runners: {built} -> "
                             f"{stats['compiled']}")
    shape = tuple(cfg.dit.latent_shape)
    for r in waves[0] + waves[1]:
        if tuple(r.x0.shape) != shape or not torch.isfinite(r.x0).all():
            raise AssertionError(f"request {r.request.id}: x0 not finite or "
                                 f"not {shape}")
    n = SERVE_WAVE + SERVE_JOIN
    if any(len(res) != n for res in waves):
        raise AssertionError(f"waves served {[len(r) for r in waves]}, not {n}")
    m = engine.metrics.summary()
    lat = np.asarray([r.record.latency for r in waves[1]])
    p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    log(f"[engine] flash_attention launches {launches} == {L} layers x "
        f"{forwards} packed forwards, by variant {by_variant}; runners "
        f"{stats}, the replay built none")
    log(f"[engine] wave 0 (builds its layouts): {n} requests in "
        f"{walls[0]:.3f}s; wave 1 (replay): {n} in {walls[1]:.3f}s = "
        f"{n / walls[1]:.2f} img/s, latency p50 {p50:.3f}s p99 {p99:.3f}s, "
        f"{m['steps'] / 2:.0f} dispatches a wave; packing efficiency "
        f"{m['packing_efficiency']:.4f}, attention block skip rate "
        f"{m['attn_block_skip_rate']:.4f} ({smi})")

    # every served x0 against the same request sampled alone (every engine
    # here seeds request i alike, so ids 0..n-1 share these references)
    refs = {}
    for r in waves[0] + waves[1]:
        refs[r.request.id] = pipe.sample(
            plans[r.budget_served], 1,
            torch.Generator(device=DEV).manual_seed(
                engine.request_seed(r.request.id)),
            cond=torch.tensor([r.request.cond], device=DEV)).x0[0].float()
    errs = x0_errors(waves[0] + waves[1], refs)
    bad = {i: e for i, e in errs.items() if not e <= SERVE_X0_TOL}
    if bad:
        raise AssertionError(f"engine x0 differs from FlexiPipeline.sample: "
                             f"||x0 - ref|| / ||ref|| {bad} > {SERVE_X0_TOL}")
    log(f"[engine] x0 vs FlexiPipeline.sample per request ({len(errs)} "
        f"requests): ||x0 - ref|| / ||ref|| max {max(errs.values()):.3e}, "
        f"median {float(np.median(list(errs.values()))):.3e} "
        f"(tol {SERVE_X0_TOL}); sorted "
        f"{sorted(round(e, 5) for e in errs.values())}")

    # activation cache: interval=1 equals uncached serving bit for bit
    # (fresh runner caches, so both plan from the same warm set)
    x0s = []
    for cache in (None, CacheSpec(policy="interval", interval=1)):
        eng = ServingEngine(FlexiPipeline(pipe.params, cfg, pipe.sched,
                                          device=DEV), plans,
                            steps_per_dispatch=SERVE_K, cache=cache)
        x0s.append({r.request.id: r.x0 for r in serve_wave(eng, wave)})
    if sorted(x0s[0]) != sorted(x0s[1]) or not all(
            torch.equal(x0s[0][i], x0s[1][i]) for i in x0s[0]):
        raise AssertionError("interval=1 cache serving differs from uncached "
                             "serving")
    log(f"[engine] interval=1 cache serving == uncached serving bit for bit "
        f"({len(x0s[0])} requests)")
    eng = ServingEngine(pipe, plans, steps_per_dispatch=SERVE_K,
                        cache=CacheSpec(policy="interval", interval=2))
    ops.reset_launches()
    p0 = eng.block_passes
    res = serve_wave(eng, wave)
    torch.cuda.synchronize()
    cs = eng.metrics.cache_summary()
    if eng.store.n_active != 0 or len(res) != n:
        raise AssertionError(f"interval=2: {eng.store.n_active} slots held "
                             f"after the drain, {len(res)} served")
    if ops.flash_attention.launches != eng.block_passes - p0:
        raise AssertionError("interval=2: flash launches != block passes")
    log(f"[engine] interval=2 (split {eng.cache_split}/{L}): cache hit rate "
        f"{cs['hit_rate']:.4f}, refreshes {cs['refreshes']}, skips "
        f"{cs['skips']}, {eng.block_passes - p0} block passes for "
        f"{eng.packed_forwards} packed forwards, all slots released ({smi})")

    # a short DDPM wave
    ddpm = ServingEngine(pipe, {b: SamplingPlan(T=T_STEPS, budget=b,
                                                solver="ddpm",
                                                attn_backend="pallas")
                                for b in BUDGETS})
    for i, b in enumerate(BUDGETS):
        ddpm.submit(cond=i, budget=b)
    res = ddpm.run()
    if len(res) != 3 or not all(torch.isfinite(r.x0).all() for r in res):
        raise AssertionError("the DDPM wave did not finish with finite x0")
    log(f"[engine] DDPM wave: 3 requests, x0 finite, std "
        f"{torch.stack([r.x0 for r in res]).float().std().item():.4f}")

    # the serving CLI, in-process: the reduced config (f32), then DiT-XL/2
    # at full width (bf16, every block's attention on the wgmma kernel)
    from repro_torch.launch import serve as serve_mod
    for argv, want in ((["--smoke", "--requests", "6"], 12),
                       (["--requests", "3", "--T", "4"], 6)):
        ops.reset_launches()
        cli = serve_mod.main(["--arch", "dit-xl-2"] + argv)
        by_variant = dict(ops.flash_attention.launches_by_variant)
        if cli["served"] != want:
            raise AssertionError(f"serve.main {argv} served {cli['served']}, "
                                 f"not {want}")
        if "--smoke" not in argv and not (
                0 < by_variant["wgmma"] == ops.flash_attention.launches):
            raise AssertionError(f"serve.main {argv}: flash launches by "
                                 f"variant {by_variant}, not all wgmma")
        log(f"[engine] repro_torch.launch.serve --arch dit-xl-2 "
            f"{' '.join(argv)}: served {want}, flash launches by variant "
            f"{by_variant}")
    # the x0 check must see a wrong packing: every segment id planted to
    # 0, so segments that share a row attend to each other and to padding
    from repro_torch.core import packing
    sound_plan = packing._device_plan

    def planted(*args):
        plan, gather, ids, *rest = sound_plan(*args)
        return (plan, gather, torch.zeros_like(ids), *rest)

    packing._device_plan = planted
    try:
        eng = ServingEngine(FlexiPipeline(pipe.params, cfg, pipe.sched,
                                          device=DEV), plans,
                            steps_per_dispatch=SERVE_K)
        faulty = x0_errors(serve_wave(eng, wave), refs)
    finally:
        packing._device_plan = sound_plan
    weak = {r.request.id for r in waves[0]
            if any(m and n for m, n in
                   plans[r.budget_served].resolve_schedule(cfg).phases)}
    missed = sorted(i for i in weak if not faulty[i] > SERVE_X0_TOL)
    log(f"[engine] planted fault (segment ids all 0): ||x0 - ref|| / ||ref|| "
        f"of the {len(weak)} requests with weak steps: min "
        f"{min(faulty[i] for i in weak):.3e}, max "
        f"{max(faulty[i] for i in weak):.3e}; the others (mode 0 only, a "
        f"row each, out of the fault's reach): max "
        f"{max([faulty[i] for i in faulty if i not in weak] or [0.0]):.3e} "
        f"(tol {SERVE_X0_TOL})")
    if not weak or missed:
        raise AssertionError(f"the x0 check does not see a planted packing "
                             f"fault on requests {missed} of {sorted(weak)}")

    return {"launches": launches, "img_per_s": n / walls[1], "p50": p50,
            "p99": p99, "max_abs_err": served_err}


# ---------------------------------------------------------------------------
# Phase 8: the sampling extensions and the telemetry layer


def trained_like_t2i(gen: torch.Generator, name: str = "t2i-transformer"):
    """A text-conditioned DiT (the text-to-image transformer, or phase 19's
    text-to-video DiT) with random weights; every zero-initialized gate
    (de-embeddings, every new mode's de-embedding, adaLN, cross-attention
    out, LoRA ``b``, per-mode embedding) made non-zero so the sample
    depends on it."""
    cfg = get_config(name)
    params = dit_mod.init_dit(cfg, gen)
    blocks = params["blocks"]
    gates = [(params["deembed"], "w_flex", 0.1)]
    gates += [(new, "w", 0.1) for new in params["deembed_new"].values()]
    gates += [(params["final"]["ada"], "w", 0.05), (blocks["ada"], "w", 0.05),
              (blocks["xattn"], "wo", 0.05), (params, "ps_embed", 0.1)]
    gates += [(pair, "b", 0.05) for grp in blocks["lora"].values()
              for pair in grp.values()]
    for node, key, scale in gates:
        node[key] = randn(gen, node[key].shape, node[key].dtype) * scale
    return params, cfg


def _stop_tile_walk_halfway(sound):
    """A planted kernel fault of the kind long rows invite: the kv tile
    walk stops halfway (``ops.kernel_kwargs`` hands the kernel a tile map
    that hides the second half of every row's key tiles)."""
    def planted(q, k, **kw):
        out = sound(q, k, **kw)
        B, S = q.shape[:2]
        b = min(out["block_q"], S)
        n = -(-S // b)
        bmap = torch.ones((B, n, n), dtype=torch.int32, device=q.device)
        bmap[:, :, n // 2:] = 0
        return dict(out, block_map=bmap)
    return planted


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    return ((x.float() - ref.float()).norm() / ref.float().norm()).item()


def phase_t2i_flow(gen: torch.Generator, smi: str) -> dict:
    """The text-to-image transformer at full width through
    ``FlexiPipeline.sample`` with both flow solvers at two budgets."""
    t0 = time.perf_counter()
    params, cfg = trained_like_t2i(gen)
    pipe = FlexiPipeline(params, cfg, linear_schedule(1000), device=DEV)
    del params
    text = randn(gen, (T2I_BATCH, cfg.dit.text_len, cfg.dit.text_dim))
    torch.cuda.synchronize()
    log(f"[t2i] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, heads="
        f"{cfg.attn.num_heads}x{cfg.attn.head_dim}, latent "
        f"{cfg.dit.latent_shape} = {dit_mod.tokens_for_mode(cfg, 0)} tokens "
        f"(weak: {dit_mod.tokens_for_mode(cfg, 1)}), text {cfg.dit.text_len}x"
        f"{cfg.dit.text_dim}, LoRA rank {cfg.dit.lora_rank}, "
        f"{cfg.param_dtype}; weights in {time.perf_counter() - t0:.1f}s")
    launches, runs = 0, []
    for solver in T2I_SOLVERS:
        for b in T2I_BUDGETS:
            plan = SamplingPlan(T=T_STEPS, budget=b, solver=solver,
                                guidance_scale=0.0, attn_backend="pallas")
            phases = plan.resolve_schedule(cfg).phases
            nfe = T_STEPS * (2 if solver == "flow_heun" else 1)
            x_T = randn(gen, (T2I_BATCH,) + tuple(cfg.dit.latent_shape))
            ops.reset_launches()
            t1 = time.perf_counter()
            x0 = pipe.sample(plan, T2I_BATCH, None, cond=text, x_T=x_T).x0
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            n = ops.flash_attention.launches
            by_variant = dict(ops.flash_attention.launches_by_variant)
            if n != cfg.num_layers * nfe or by_variant["wgmma"] != n:
                raise AssertionError(f"t2i {solver} {b}: flash launches {n} "
                                     f"{by_variant}, expected {cfg.num_layers}"
                                     f" x {nfe} NFEs, all wgmma")
            shape = (T2I_BATCH,) + tuple(cfg.dit.latent_shape)
            if tuple(x0.shape) != shape or not torch.isfinite(x0).all():
                raise AssertionError(f"t2i {solver} {b}: x0 not finite or "
                                     f"not {shape}")
            launches += n
            # the first call ran eagerly and captured the runner: a replay
            # must give the same x0 bit for bit (phase 17)
            t1 = time.perf_counter()
            again = pipe.sample(plan, T2I_BATCH, None, cond=text, x_T=x_T).x0
            torch.cuda.synchronize()
            dt_replay = time.perf_counter() - t1
            if not torch.equal(again, x0):
                raise AssertionError(f"t2i {solver} {b}: the replayed runner's "
                                     f"x0 differs from its first (eager) call")
            dense = pipe.sample(dataclasses.replace(plan, attn_backend="dense"),
                                T2I_BATCH, None, cond=text, x_T=x_T).x0
            sound_fn = ops.kernel_kwargs
            ops.kernel_kwargs = _stop_tile_walk_halfway(sound_fn)
            try:
                # eagerly: the runner's graph holds the sound tile map
                with graphs.disabled():
                    faulty = pipe.sample(plan, T2I_BATCH, None, cond=text,
                                         x_T=x_T).x0
            finally:
                ops.kernel_kwargs = sound_fn
            err, fault = rel_err(x0, dense), rel_err(faulty, dense)
            runs.append((solver, b, err, fault))
            log(f"[t2i] {solver} budget {b} (schedule {phases}, relative "
                f"compute {plan.relative_compute(cfg):.4f}): {nfe} NFEs in "
                f"{dt:.2f}s ({T2I_BATCH / dt:.3f} img/s, first call of the "
                f"plan included; replayed in {dt_replay:.2f}s, x0 bit for "
                f"bit), flash launches {n} = {cfg.num_layers} x "
                f"{nfe}, by variant {by_variant}; ||x0 - dense|| / ||dense|| "
                f"{err:.3e}, planted fault (tile walk stops halfway) {fault:.3e} "
                f"(tol {T2I_X0_TOL}); max|x0| {x0.float().abs().max().item():.3f}"
                f" ({smi})")
    bad = [r for r in runs if not (r[2] <= T2I_X0_TOL < r[3])]
    if bad:
        raise AssertionError(f"t2i x0: sound reading over {T2I_X0_TOL} or the "
                             f"planted fault under it: {bad}")
    stats = pipe.cache_stats()
    if stats["compiled"] != 2 * len(T2I_SOLVERS) * len(T2I_BUDGETS):
        raise AssertionError(f"t2i runners {stats}: one per (plan, backend)")
    del pipe
    torch.cuda.empty_cache()
    return {"launches": launches}


def phase_adaptive(pipe: FlexiPipeline, smi: str) -> dict:
    """Adaptive DDIM on DiT-XL/2 (CFG 1.5, T=10, probe every 2 steps,
    threshold 0.35): the gaps, the switch step, launches, and relative
    compute recomputed from the switch step and the probes."""
    from repro_torch.core.scheduler import dit_nfe_flops
    cfg = pipe.cfg
    plan = SamplingPlan(T=T_STEPS, budget=AdaptiveBudget(),
                        attn_backend="pallas")
    labels = torch.tensor(np.random.default_rng(SEED + 8).integers(
        0, cfg.dit.num_classes, BATCH).tolist(), device=DEV)
    ops.reset_launches()
    t0 = time.perf_counter()
    res = pipe.sample(plan, BATCH, torch.Generator(device=DEV).manual_seed(8),
                      cond=labels)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    s, gaps = res.trace["switch_step"], res.trace["gaps"]
    n_weak = min(s + 1, T_STEPS)
    calls = n_weak + len(gaps) + (T_STEPS - s)
    n = ops.flash_attention.launches
    by_variant = dict(ops.flash_attention.launches_by_variant)
    if n != cfg.num_layers * calls or by_variant["wgmma"] != n:
        raise AssertionError(f"adaptive: flash launches {n} {by_variant}, "
                             f"expected {cfg.num_layers} x {calls}, all wgmma")
    f_w, f_p = 2 * dit_nfe_flops(cfg, 1), 2 * dit_nfe_flops(cfg, 0)
    rel = (n_weak * f_w + len(gaps) * f_p + (T_STEPS - s) * f_p) / (T_STEPS * f_p)
    shape = (BATCH,) + tuple(cfg.dit.latent_shape)
    if tuple(res.x0.shape) != shape or not torch.isfinite(res.x0).all():
        raise AssertionError(f"adaptive: x0 not finite or not {shape}")
    if not abs(rel - res.relative_compute) <= 1e-12 * rel:
        raise AssertionError(f"adaptive: relative compute {res.relative_compute}"
                             f" != {rel} recomputed from the switch step")
    if any(g > plan.budget.threshold for g in gaps[:-1]) or (
            s < T_STEPS and not gaps[-1] > plan.budget.threshold):
        raise AssertionError(f"adaptive: switch step {s} does not follow "
                             f"the gaps {gaps}")
    log(f"[adaptive] DiT-XL/2 DDIM CFG 1.5 T={T_STEPS}, threshold "
        f"{plan.budget.threshold}, probe every {plan.budget.probe_every}: "
        f"gaps {[round(g, 5) for g in gaps]}, switch step {s}, relative "
        f"compute {res.relative_compute:.4f} (recomputed {rel:.4f}); "
        f"{calls} forward calls, flash launches {n} by variant {by_variant}; "
        f"{dt:.2f}s ({smi})")
    return {"launches": n}


def count_syncs(fn, messages: list | None = None):
    """Run ``fn`` with ``torch.cuda.set_sync_debug_mode("warn")`` and count
    the synchronising calls it makes (where each was called from goes to
    ``messages``)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    if messages is not None:
        messages.extend(syncs)
    return out, len(syncs)


def phase_telemetry(pipe: FlexiPipeline, smi: str) -> dict:
    """The phase-7 wave untapped, tapped and tapped with profiling, each on
    a fresh runner cache, warmed by one wave and then measured on two
    replays: x0 bit for bit, synchronising calls (compared on the second
    replay, the steady state: in the first call the first engine's first
    replay made one more than the others), spans, attribution, taps, the
    cost report, and no runner built by the replays."""
    cfg = pipe.cfg
    L = cfg.num_layers
    plans = {b: SamplingPlan(T=T_STEPS, budget=b, attn_backend="pallas")
             for b in BUDGETS}
    rng = np.random.default_rng(SEED + 7)
    wave = [(int(rng.integers(0, cfg.dit.num_classes)), BUDGETS[i % 3])
            for i in range(SERVE_WAVE + SERVE_JOIN)]
    n = len(wave)
    out, launches = {}, 0
    for name, tel in (("untapped", None), ("tapped", Telemetry(taps=True)),
                      ("profiled", Telemetry(taps=True, profile=True))):
        eng = ServingEngine(FlexiPipeline(pipe.params, cfg, pipe.sched,
                                          device=DEV), plans,
                            steps_per_dispatch=SERVE_K, telemetry=tel)
        eng.precapture_warm_set(max_per_mode=1)
        serve_wave(eng, wave)
        built = eng.cache_stats()["compiled"]
        _, first_syncs = count_syncs(lambda: serve_wave(eng, wave))
        d0, f0 = eng.metrics.total_steps, eng.packed_forwards
        ops.reset_launches()
        t0 = time.perf_counter()
        res, syncs = count_syncs(lambda: serve_wave(eng, wave))
        wall = time.perf_counter() - t0
        dispatches = eng.metrics.total_steps - d0
        forwards = eng.packed_forwards - f0
        if ops.flash_attention.launches != L * forwards or \
                ops.flash_attention.launches_by_variant["wgmma"] \
                != ops.flash_attention.launches:
            raise AssertionError(f"{name} wave: flash launches "
                                 f"{ops.flash_attention.launches_by_variant}, "
                                 f"expected {L} x {forwards}, all wgmma")
        launches += ops.flash_attention.launches
        if eng.cache_stats()["compiled"] != built or len(res) != n:
            raise AssertionError(f"{name} wave: served {len(res)}, runners "
                                 f"{built} -> {eng.cache_stats()['compiled']}")
        out[name] = dict(eng=eng, tel=tel, syncs=syncs, dispatches=dispatches,
                         x0={r.request.id: r.x0 for r in res}, wall=wall)
        log(f"[telemetry] {name} replay waves: {n} requests, {dispatches} "
            f"dispatches each, {first_syncs} then {syncs} synchronising "
            f"calls, {n / wall:.2f} img/s under sync debug mode ({smi})")
    base = out["untapped"]
    for name in ("tapped", "profiled"):
        x0 = out[name]["x0"]
        if sorted(x0) != sorted(base["x0"]) or not all(
                torch.equal(x0[i], base["x0"][i]) for i in x0):
            raise AssertionError(f"{name} wave: x0 differs from the untapped "
                                 f"wave")
    if out["tapped"]["syncs"] != base["syncs"]:
        raise AssertionError(f"taps added host syncs: {base['syncs']} -> "
                             f"{out['tapped']['syncs']}")
    want = base["syncs"] + out["profiled"]["dispatches"]
    if out["profiled"]["syncs"] != want:
        raise AssertionError(f"profiling: {out['profiled']['syncs']} syncs, "
                             f"expected {base['syncs']} + one per dispatch "
                             f"= {want}")
    prof = out["profiled"]
    eng, tel = prof["eng"], prof["tel"]
    rec = tel.recorder
    steps = eng.metrics.total_steps
    n_req = len({e.tid for e in rec.events if e.name.startswith("req")})
    if not (len(rec.by_name("dispatch")) == len(rec.by_name("plan"))
            == len(rec.by_name("pack")) == steps) or n_req != 3 * n \
            or rec.events_dropped:
        raise AssertionError(f"spans: dispatch {len(rec.by_name('dispatch'))},"
                             f" plan {len(rec.by_name('plan'))}, pack "
                             f"{len(rec.by_name('pack'))} for {steps} "
                             f"dispatches; {n_req} request rows for {3 * n}")
    cons = tel.attribution.conservation()
    if any(cons.values()) or len(tel.attribution.finalized) != 3 * n:
        raise AssertionError(f"attribution: {cons}, "
                             f"{len(tel.attribution.finalized)} finalized")
    agg = tel.taps.aggregate()
    if agg["samples"] != steps or agg.get("nonfinite_request_steps") != 0 \
            or not agg["eps_norm"]["mean"] > 0:
        raise AssertionError(f"taps: {agg}")
    built = eng.cache_stats()["compiled"]
    t0 = time.perf_counter()
    hv = tel.profile.harvest(eng.pipe)
    t_harvest = time.perf_counter() - t0
    if eng.cache_stats()["compiled"] != built:
        raise AssertionError("the cost harvest built runners")
    rep = tel.profile.reconcile()
    rows = [r for r in rep["rows"] if "wall_ms_ewma" in r]
    if rep["n_flagged"] or not rows or not all(
            r["achieved_gflops_per_s"] > 0 for r in rows):
        raise AssertionError(f"cost report: {rep['n_flagged']} flagged, "
                             f"{len(rows)} rows with walls")
    log(f"[telemetry] x0 of the tapped and profiled waves == untapped bit for "
        f"bit ({n} requests); syncs untapped {base['syncs']}, tapped "
        f"{out['tapped']['syncs']} (+0), profiled {prof['syncs']} (+"
        f"{prof['dispatches']} dispatches); spans {rec.events_recorded} "
        f"(dispatch {len(rec.by_name('dispatch'))}, request rows {n_req}); "
        f"attribution {cons} over {len(tel.attribution.finalized)} requests; "
        f"taps eps_norm mean {agg['eps_norm']['mean']:.4g}, skip rate "
        f"{agg.get('attn_blocks', {}).get('skip_rate', 0.0):.4f}; harvest "
        f"{hv} in {t_harvest:.1f}s")
    for r in rows:
        log(f"[telemetry]   {r['label']}: {r['dispatches']} dispatches, wall "
            f"{r['wall_ms_ewma']:.2f} ms (min {r['wall_ms_min']:.2f}), "
            f"analytic {r['analytic_dispatch_gflops']:.1f} GFLOP, counted "
            f"{r['counted_gflops']:.1f} (x{r['counted_over_analytic']:.3f}), "
            f"achieved {r['achieved_gflops_per_s']:.1f} GFLOP/s ({smi})")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# Phase 10: the fleet and its resilience layer


class FleetClock:
    """The fleet's injected clock: virtual time, advanced by the replicas'
    modeled dispatch costs and by the chaos harness's ticks."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def fleet_passes(fleet) -> tuple:
    """(packed forwards, block passes) summed over a fleet's replicas."""
    return (sum(r.engine.packed_forwards for r in fleet.replicas.values()),
            sum(r.engine.block_passes for r in fleet.replicas.values()))


def check_launches(name: str, L: int, forwards: int, passes: int,
                   extra: int = 0) -> int:
    """Every flash launch since the reset on wgmma, and as many as the
    block passes (L per packed forward without a cache) plus ``extra``."""
    n = ops.flash_attention.launches
    by_variant = dict(ops.flash_attention.launches_by_variant)
    if n != passes + extra or by_variant["wgmma"] != n or n == 0:
        raise AssertionError(f"{name}: flash launches {by_variant} for "
                             f"{forwards} packed forwards, {passes} block "
                             f"passes (+{extra}), not all wgmma")
    return n


def phase_fleet(pipe: FlexiPipeline, smi: str) -> dict:
    """The fleet on the card: a wave over 3 packed replicas (cheapest, then
    affinity) after a rehearsal that a background thread warms; the chaos
    run (rehearsal, then measured); the journal replay; the disarmed and
    the armed engine; the fleet CLI."""
    from repro_torch.fleet import BackgroundCompiler, Fleet
    from repro_torch.launch import serve as serve_mod
    from repro_torch.resilience import FaultInjector, FaultPlan
    from repro_torch.resilience import chaos

    t_phase = time.perf_counter()
    cfg = pipe.cfg
    L = cfg.num_layers
    plans = {b: SamplingPlan(T=T_STEPS, budget=b, attn_backend="pallas")
             for b in BUDGETS}
    fpipe = FlexiPipeline(pipe.params, cfg, pipe.sched, device=DEV)
    kw = {"steps_per_dispatch": SERVE_K}
    rng = np.random.default_rng(SEED + 10)
    wave = [(int(rng.integers(0, cfg.dit.num_classes)), BUDGETS[i % 3])
            for i in range(FLEET_N)]

    def new_fleet(policy):
        return Fleet(fpipe, plans, FLEET_REPLICAS, router=policy,
                     clock=FleetClock(), engine_kwargs=kw)

    # 1. a fleet wave under each policy, after a rehearsal
    refs, launches, out = {}, {"fleet": 0}, {}
    for policy in ("cheapest", "affinity"):
        reh = new_fleet(policy)
        t0 = time.perf_counter()
        reh.warmers[0] = BackgroundCompiler(reh.replicas[0].engine,
                                            max_per_mode=1).start()
        for label, b in wave:
            reh.submit(cond=label, budget=b)
        reh.run()
        reh.wait_warm(timeout=600.0)
        t_reh = time.perf_counter() - t0
        built = fpipe.cache_stats()["compiled"]
        fleet = new_fleet(policy)
        ops.reset_launches()
        t0 = time.perf_counter()
        for label, b in wave:
            fleet.submit(cond=label, budget=b)
        res = fleet.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        forwards, passes = fleet_passes(fleet)
        if passes != L * forwards:
            raise AssertionError(f"fleet {policy}: {passes} block passes for "
                                 f"{forwards} packed forwards")
        n_flash = check_launches(f"fleet {policy}", L, forwards, passes)
        launches["fleet"] += n_flash
        if fpipe.cache_stats()["compiled"] != built or len(res) != FLEET_N:
            raise AssertionError(f"fleet {policy}: served {len(res)}; runners "
                                 f"{built} -> {fpipe.cache_stats()['compiled']}"
                                 f" after the warm-up")
        for r in res:
            if r.rid not in refs:
                refs[r.rid] = pipe.sample(
                    plans[r.budget_served], 1,
                    torch.Generator(device=DEV).manual_seed(
                        fleet.request_seed(r.rid)),
                    cond=torch.tensor([r.cond], device=DEV)).x0[0].float()
        errs = {r.rid: rel_err(r.x0, refs[r.rid]) for r in res}
        bad = {i: e for i, e in errs.items() if not e <= SERVE_X0_TOL}
        if bad:
            raise AssertionError(f"fleet {policy}: x0 vs FlexiPipeline.sample "
                                 f"{bad} > {SERVE_X0_TOL}")
        s = fleet.summary()
        rs = s["router"]
        out[policy] = n_img = FLEET_N / wall
        log(f"[fleet] {policy}: {FLEET_N} requests over {FLEET_REPLICAS} "
            f"replicas in {wall:.3f}s = {n_img:.2f} img/s (rehearsal with the "
            f"background warmer {t_reh:.2f}s, which built "
            f"{reh.warmers[0].captured} ladder rungs); placements "
            f"{int(rs['placements'])}, handbacks {int(rs['handbacks'])}, "
            f"hedges {int(rs['hedges'])}, affinity hit rate "
            f"{s['affinity_hit_rate']:.3f}, served by replica "
            f"{sorted(collections.Counter(r.replica for r in res).items())}; "
            f"{forwards} packed forwards, flash launches {n_flash} all "
            f"wgmma; 0 runners built; x0 "
            f"vs FlexiPipeline.sample max {max(errs.values()):.3e} (tol "
            f"{SERVE_X0_TOL}) ({smi})")
    # the planted fault: request 0 against the sample drawn with request 1's
    # seed (its own label and level) must read over the limit
    r0 = fleet.results[0]
    wrong = pipe.sample(plans[r0.budget_served], 1,
                        torch.Generator(device=DEV).manual_seed(
                            fleet.request_seed(1)),
                        cond=torch.tensor([r0.cond], device=DEV)).x0[0]
    planted = rel_err(r0.x0, wrong)
    log(f"[fleet] planted fault (request 0 held against the seed of request "
        f"1): {planted:.3e} (tol {SERVE_X0_TOL})")
    if not planted > SERVE_X0_TOL:
        raise AssertionError("the fleet's x0 check does not see a request "
                             "served with another request's seed")

    # 2. chaos: the default plan, rehearsed, then measured
    ckw = dict(kw, cache=CacheSpec(policy="interval", interval=1))
    cpipe = FlexiPipeline(pipe.params, cfg, pipe.sched, device=DEV)
    chaos.run_chaos(cpipe, plans, engine_kwargs=ckw)
    built = cpipe.cache_stats()["compiled"]
    ops.reset_launches()
    t0 = time.perf_counter()
    res = chaos.run_chaos(cpipe, plans, engine_kwargs=ckw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    forwards, passes = fleet_passes(res["fleet"])
    launches["chaos"] = check_launches("chaos", L, forwards, passes)
    states = {r: res["fleet"].membership.state(r) for r in range(4)}
    if res["requests_lost"] or res["nonfinite_outputs"] \
            or (states[1], states[3]) != ("dead", "dead") \
            or res["deaths"] != 2 or not res["escalated_rids"] \
            or cpipe.cache_stats()["compiled"] != built:
        raise AssertionError(f"chaos: lost {res['requests_lost']}, non-finite "
                             f"{res['nonfinite_outputs']}, states {states}, "
                             f"escalated {res['escalated_rids']}, runners "
                             f"{built} -> {cpipe.cache_stats()['compiled']}")
    v = chaos.verify_escalations(cpipe, plans, res, engine_kwargs=ckw)
    if not (v["escalated_max_rel"] <= SERVE_X0_TOL
            and v["moved_max_rel"] <= SERVE_X0_TOL):
        raise AssertionError(f"chaos: escalations / moved requests vs their "
                             f"references {v} over {SERVE_X0_TOL}")
    rec = res["recovery"]
    log(f"[chaos] default plan: {res['requests']} requests, "
        f"{res['replicas']} replicas, {res['ticks']} ticks in {wall:.3f}s "
        f"({res['requests'] / wall:.2f} img/s incl. recovery); lost 0, every "
        f"x0 finite; replicas {states} (crash and partition dead); faults "
        f"{res['faults']}; escalated {res['escalated_rids']} (bitwise "
        f"{v['escalated_bitwise']}, max rel {v['escalated_max_rel']:.3e}), "
        f"moved {res['moved_rids']} (max rel {v['moved_max_rel']:.3e}); "
        f"quarantined {res['quarantined']}, integrity refreshes "
        f"{res['integrity_refreshes']}, alloc failures "
        f"{res['alloc_failures']}; readmit {rec['readmit_count']:.0f} (mean "
        f"{rec['readmit_mean_s'] * 1e3:.2f} ms virtual), escalation mean "
        f"{rec['escalation_mean_s'] * 1e3:.2f} ms virtual; {forwards} packed "
        f"forwards, flash launches {launches['chaos']} all wgmma; 0 runners "
        f"built after the rehearsal ({smi})")

    # 3. the journal replay
    FLEET_JOURNAL.parent.mkdir(parents=True, exist_ok=True)
    FLEET_JOURNAL.unlink(missing_ok=True)
    ops.reset_launches()
    rep = chaos.run_replay(cpipe, plans, str(FLEET_JOURNAL),
                           engine_kwargs=ckw)
    torch.cuda.synchronize()
    fa, fb = rep["fleets"]
    forwards = passes = 0
    for f in (fa, fb):
        fw, ps = fleet_passes(f)
        forwards, passes = forwards + fw, passes + ps
    ref_calls = sum(forward_calls(plans[r.budget_served], cfg)
                    for r in fb.results.values())
    launches["replay"] = check_launches("replay", L, forwards, passes,
                                        extra=L * ref_calls)
    if rep["missing"] or rep["duplicates"] or rep["replayed"] < 1 \
            or not rep["max_readmit_rel"] <= SERVE_X0_TOL:
        raise AssertionError(f"replay: {rep}")
    log(f"[replay] {rep['requests']} requests, {rep['finished_before_crash']} "
        f"finished before the front door was abandoned, {rep['replayed']} "
        f"replayed exactly once (missing 0, duplicates 0); x0 vs the "
        f"uninterrupted reference max rel {rep['max_readmit_rel']:.3e} (tol "
        f"{SERVE_X0_TOL}); journal {rep['journal']}; flash launches "
        f"{launches['replay']} all wgmma ({L} x {forwards} packed forwards "
        f"+ {L} x {ref_calls} reference forward calls)")

    # 4. the disarmed engine and the armed one (no warmer is alive here)
    swave = [(int(rng.integers(0, cfg.dit.num_classes)), BUDGETS[i % 3])
             for i in range(SERVE_WAVE + SERVE_JOIN)]

    def engine(**ekw):
        return ServingEngine(FlexiPipeline(pipe.params, cfg, pipe.sched,
                                           device=DEV), plans, **kw, **ekw)

    x0s, syncs = {}, {}
    for name, ekw in (("stock", {}),
                      ("disarmed", dict(faults=None, quarantine=None,
                                        self_heal=True, max_retries=2,
                                        cache_integrity=False)),
                      ("tapped", dict(telemetry=Telemetry(taps=True))),
                      ("armed", dict(telemetry=Telemetry(taps=True),
                                     faults=FaultInjector(
                                         FaultPlan()).for_replica(0),
                                     quarantine=True))):
        # a wave to warm, one to reach the steady state (as in phase 8),
        # and the compared one: the same request ids, so the same seeds
        eng = engine(**ekw)
        eng.precapture_warm_set(max_per_mode=1)
        serve_wave(eng, swave)
        serve_wave(eng, swave)
        res, syncs[name] = count_syncs(lambda: serve_wave(eng, swave))
        x0s[name] = {r.request.id: r.x0 for r in res}
        if eng.metrics.total_quarantined:
            raise AssertionError(f"{name}: quarantined a sound request")
    base = x0s["stock"]
    for name in ("disarmed", "tapped", "armed"):
        if sorted(x0s[name]) != sorted(base) or not all(
                torch.equal(x0s[name][i], base[i]) for i in base):
            raise AssertionError(f"{name} engine: x0 differs from the stock "
                                 f"engine's")
    if syncs["armed"] != syncs["tapped"]:
        raise AssertionError(f"the armed, quarantining engine added host "
                             f"syncs: {syncs['tapped']} -> {syncs['armed']}")
    log(f"[resilience] the phase-7 wave ({len(swave)} requests, third "
        f"replay): faults=None == stock engine bit for bit; tapped and "
        f"armed+quarantining (taps, an armed facade, quarantine=True) == "
        f"stock bit for bit; synchronising calls stock {syncs['stock']}, "
        f"tapped {syncs['tapped']}, armed {syncs['armed']} (+0)")

    # 5. the fleet CLI in-process at full width (its warmer on a thread)
    ops.reset_launches()
    t0 = time.perf_counter()
    cli = serve_mod.main(["--arch", "dit-xl-2", "--replicas", "3",
                          "--requests", "12", "--T", "10"])
    wall = time.perf_counter() - t0
    by_variant = dict(ops.flash_attention.launches_by_variant)
    if cli["served"] != 12 or not (
            0 < by_variant["wgmma"] == ops.flash_attention.launches):
        raise AssertionError(f"fleet CLI: served {cli['served']}, flash "
                             f"launches {by_variant}")
    log(f"[fleet] repro_torch.launch.serve --arch dit-xl-2 --replicas 3 "
        f"--requests 12 --T 10: served 12 in {wall:.2f}s (weights, warm-up "
        f"thread and drain) = {cli['img_per_s']:.2f} img/s, placements "
        f"{int(cli['placements'])}, hedges {int(cli['hedges'])}; flash "
        f"launches {by_variant} ({smi})")
    log(f"[fleet] phase done in {time.perf_counter() - t_phase:.1f}s ({smi})")
    return {"launches": launches, "img_per_s": out}


# ---------------------------------------------------------------------------
# Phase 9: training


def cuda_ms(fn):
    """Run ``fn`` once between CUDA events; (its result, milliseconds)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def pinned_copy(tree):
    """A copy of a tree of device tensors in the host's pinned memory
    (copied at the link's rate, both ways)."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          pin_memory=True).copy_(t), tree)


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def write_into(tree, src) -> None:
    """``src``'s values written into ``tree``'s own tensors: a captured
    train step keys its graph by the identity of the trees it donates."""
    tree_map(lambda t, v: t.copy_(v), tree, src)


def differing(tree, ref) -> list:
    """The leaves of ``tree`` that differ in any bit from ``ref``'s (on the
    card, or in pinned host memory: compared on the card a leaf at a
    time)."""
    return [i for i, (t, r) in enumerate(zip(tree_leaves(tree), tree_leaves(ref)))
            if t.dtype != r.dtype or not torch.equal(t, r.to(t.device))]


def bypassed(step, index: int):
    """The planted fault of the captured-step checks, on a fresh step
    object: its body reads argument ``index`` (2: the batch, 3: the
    draws) from the step object, where the host side leaves each call's
    tensors, rather than from the argument the runner copies into its
    static buffers. Eagerly that is the same data; a replay reads the
    tensors the capture saw, the first call's (kept alive here)."""
    base = type(step)

    class Bypassed(base):
        def split(self, *args, **kw):
            static, body = base.split(self, *args, **kw)
            self.seen.append(body[index])
            return static, body

        def update(self, *body):
            body = list(body)
            body[index] = self.seen[-1]
            return base.update(self, *body)

    step.__class__, step.seen = Bypassed, []
    return step


def step_calls(calls, state: dict, batches: list, loss_key: str) -> list:
    """``calls`` (step objects) in order on ``state`` ({"p": parameters,
    "o": AdamW state}), the i-th on ``batches[i % len(batches)]``, all
    drawing from one generator seeded SEED: (loss, ms, peak memory) a
    call."""
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    out = []
    for i, step in enumerate(calls):
        torch.cuda.reset_peak_memory_stats()
        (_, _, m), dt = cuda_ms(lambda: step(state["p"], state["o"],
                                             batches[i % len(batches)], gen))
        out.append((float(m[loss_key]), dt, torch.cuda.max_memory_allocated()))
    return out


def captured_vs_eager(tag: str, label: str, make, state: dict, batches: list,
                      loss_key: str, k_timed: int, bypass: int, smi: str,
                      errors: list) -> dict:
    """The check of phases 9 and 13. ``make()`` builds the step objects
    (one a mode, called in turn, COMPARE_STEPS calls each). They run from
    ``state`` under ``graphs.disabled()``; the planted fault
    (:func:`bypassed` on argument ``bypass``) and then the sound steps run
    captured from the same values, written back into the same tensors,
    with the same draws: the sound run's losses and every parameter and
    moment leaf equal the eager run's bit for bit, one graph a step object
    taken by its first call; the planted run's losses and parameters must
    differ. Then ``k_timed`` rounds of one more captured call each, timed,
    none of which may capture, each round followed by one eager call each
    under ``graphs.disabled()`` where an eager step's peak fits beside the
    graphs' pools (SNAPSHOT_MARGIN spare). Eager ms: the eager calls but
    each step object's first of the check and first interleaved (each
    fills the allocator's emptied cache again); captured ms: the
    replays. Eager peak: the
    check's eager calls (allocated); captured peak: the timed replays'
    allocated peak plus what the graphs' pools hold unallocated, with the
    check's snapshot gone. Leaves ``state`` trained, every graph dropped
    with its step object; returns the readings, with ``start``, the
    state's values before any step, in pinned host memory. The eager
    run's end state is kept on the card when it fits beside the eager
    run's peak (SNAPSHOT_MARGIN spare), else in pinned host memory."""
    t0 = time.perf_counter()
    start = pinned_copy(state)
    with graphs.disabled():
        eager = step_calls(make() * COMPARE_STEPS, state, batches, loss_key)
    total = torch.cuda.get_device_properties(0).total_memory
    on_card = (max(x[2] for x in eager) + tree_bytes(state)
               <= total - SNAPSHOT_MARGIN)
    want = tree_map(torch.clone, state) if on_card else pinned_copy(state)
    write_into(state, start)
    torch.cuda.empty_cache()
    planted = [bypassed(s, bypass) for s in make()]
    fault = step_calls(planted * COMPARE_STEPS, state, batches, loss_key)
    fault_diff = differing(state["p"], want["p"])
    del planted
    torch.cuda.empty_cache()
    write_into(state, start)
    steps = make()
    n = len(steps)
    capt = step_calls(steps * COMPARE_STEPS, state, batches, loss_key)
    diff = differing(state, want)
    del want
    torch.cuda.empty_cache()
    warm = [s.captures for s in steps]
    stats = graphs.stats(steps)
    interleave = (max(x[2] for x in eager) + stats["graph_pool_bytes"]
                  <= total - SNAPSHOT_MARGIN)
    timed, e_timed = [], []
    for _ in range(k_timed):
        timed += step_calls(steps, state, batches, loss_key)
        if interleave:
            with graphs.disabled():
                e_timed += step_calls(steps, state, batches, loss_key)
    late = sum(s.captures for s in steps) - sum(warm)
    keys = [dict(pool=g.pool_bytes, copied_in=g.in_bytes, replays=g.replays)
            for s in steps for g in s.graphs()]
    pools = {tuple(g.graph.pool()) for s in steps for g in s.graphs()}
    idle = sum(seg["total_size"] - seg["allocated_size"]
               for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) in pools)
    del steps
    torch.cuda.empty_cache()
    losses_e, losses_c = [x[0] for x in eager], [x[0] for x in capt]
    per = []
    for j in range(n):
        e_ms = [x[1] for x in eager[j::n][1:] + e_timed[j::n][1:]]
        c_ms = [x[1] for x in capt[j::n][1:] + timed[j::n]]
        per.append(dict(eager_ms=float(np.median(e_ms)),
                        captured_ms=float(np.median(c_ms)),
                        first_ms=capt[j][1], captured_all=c_ms, eager_all=e_ms,
                        eager_peak=max(x[2] for x in eager[j::n]),
                        captured_peak=max(x[2] for x in timed[j::n]) + idle))
    fault_losses = [x[0] for x in fault]
    log(f"[{tag}] {label}, captured vs graphs.disabled(), {COMPARE_STEPS} "
        f"steps a step object from the same values and draws "
        f"({tree_bytes(state) / 1e9:.2f} GB of state; the eager end state "
        f"kept {'on the card' if on_card else 'in pinned host memory'}; "
        f"{time.perf_counter() - t0:.1f} s in all): losses eager "
        f"{', '.join(f'{x:.6f}' for x in losses_e)}, captured equal bit for "
        f"bit: {losses_c == losses_e}; {len(diff)} of "
        f"{len(tree_leaves(state))} parameter and moment leaves differ (limit "
        f"0); graphs {warm} taken by the first calls, {late} captured after "
        f"warm-up; planted fault ({'batch' if bypass == 2 else 'draws'} read "
        f"from the step object): losses "
        f"{', '.join(f'{x:.6f}' for x in fault_losses)}, {len(fault_diff)} of "
        f"{len(tree_leaves(state['p']))} parameter leaves differ; eager calls "
        f"{'interleaved with the timed replays' if interleave else 'from the check only (an eager step does not fit beside the pools)'} "
        f"({smi})")
    for j, r in enumerate(per):
        log(f"[{tag}] {label}, step object {j}: {r['captured_ms']:.1f} ms/step captured "
            f"(replays {', '.join(f'{x:.1f}' for x in r['captured_all'])}; the "
            f"first call, eager + capture, {r['first_ms']:.1f}) vs "
            f"{r['eager_ms']:.1f} eager (median of "
            f"{', '.join(f'{x:.1f}' for x in r['eager_all'])}); peak memory "
            f"{r['captured_peak'] / 1e9:.2f} GB captured (replays' allocated "
            f"peak + {idle / 1e9:.2f} GB the pools hold unallocated), "
            f"{r['eager_peak'] / 1e9:.2f} GB eager; graph pool "
            f"{keys[j]['pool'] / 1e9:.2f} GB, a replay copies in "
            f"{keys[j]['copied_in'] / 1e6:.3f} MB ({smi})")
    if losses_c != losses_e or diff:
        errors.append(f"{label}: captured steps differ from eager: losses "
                      f"{losses_c} vs {losses_e}, leaves {diff[:8]}")
    if warm != [1] * n or late:
        errors.append(f"{label}: graphs {warm}, {late} captured after warm-up")
    if fault_losses == losses_e or not fault_diff:
        errors.append(f"{label}: the planted fault reads as sound")
    return dict(per=per, keys=keys, stats=stats, start=start, losses=losses_e,
                differing=len(diff), fault_differing=len(fault_diff), late=late,
                interleaved=interleave,
                steps=COMPARE_STEPS + k_timed * (2 if interleave else 1))


def train_batch(cfg, n: int, seed: int) -> dict:
    """A batch of the reference's synthetic class-pattern latents."""
    from repro_torch.data import pipeline as dp
    make = dp.make_dit_batch_fn(cfg.dit.latent_shape, cfg.dit.num_classes, n)
    b = make(0, 0, 1, np.random.default_rng(seed))
    return {k: torch.from_numpy(b[k]).to(DEV) for k in ("x0", "cond")}


def flip_update(step):
    """The planted fault: the update applied with its sign flipped
    (p' = p - (p_step - p), in float32, cast back), written into the same
    tensors (the step writes ``params`` in place)."""
    def run(params, opt, batch, gen=None):
        old = tree_map(torch.clone, params)
        _, opt, m = step(params, opt, batch, gen)
        tree_map(lambda q, p: q.copy_((2.0 * p.float() - q.float()).to(q.dtype)),
                 params, old)
        return params, opt, m
    return run


def learning_check(step, params, opt, batch, n: int):
    """``n`` steps on one batch with the same draws each step; the loss
    trajectory and mean(last LEARN_TAIL) / the loss before any update."""
    losses = []
    for _ in range(n):
        params, opt, m = step(params, opt, batch,
                              torch.Generator(device=DEV).manual_seed(SEED))
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    return losses, float(np.mean(losses[-LEARN_TAIL:]) / losses[0])


def tiny_f32_cfg():
    """The tests' tiny DiT (tests/conftest.py ``tiny_dit_cfg``), float32."""
    from repro_torch.configs import AttnConfig, DiTConfig, ModelConfig
    return ModelConfig(
        name="tiny-dit", family="dit", num_layers=2, d_model=64, d_ff=256,
        vocab_size=0, attn=AttnConfig(4, 4, 16, use_rope=False),
        dit=DiTConfig(latent_shape=(1, 16, 16, 4), patch_size=(1, 2, 2),
                      flex_patch_sizes=(), underlying_patch_size=(1, 2, 2),
                      conditioning="class", num_classes=10),
        mlp_activation="gelu", norm_type="layernorm",
        param_dtype="float32", compute_dtype="float32", remat="none",
        max_seq_len=256)


def card_against_cpu(tc) -> float:
    """One train step of the tiny float32 config (flexified, modes 0 and
    1, and the MMD fine-tune) on the card and on the CPU from the same
    weights, draws and mid-run AdamW state (step 5, v non-zero, so no
    update is a bare sign): the loss, every gradient leaf and every
    updated parameter leaf within CARD_CPU_TOL (relative; a leaf against
    its norm). Returns the worst relative error."""
    from repro_torch.core import flexify
    from repro_torch.core import mmd
    from repro_torch.launch import steps as st
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(SEED)
    params, cfg = flexify(dit_mod.init_dit(tiny_f32_cfg(), g), tiny_f32_cfg(),
                          [(1, 4, 4)], generator=g)
    for node, key in [(params["deembed"], "w_flex"), (params["final"]["ada"], "w"),
                      (params["blocks"]["ada"], "w"), (params, "ps_embed")]:
        node[key] = torch.randn(node[key].shape, generator=g) * 0.05
    sched = linear_schedule(1000)
    batch = {k: v.cpu() for k, v in train_batch(cfg, 4, SEED).items()}
    state = {"m": tree_map(lambda x: torch.randn(x.shape, generator=g) * 1e-3,
                           params),
             "v": tree_map(lambda x: torch.rand(x.shape, generator=g) * 1e-6,
                           params),
             "step": torch.tensor(5, dtype=torch.int32)}
    rel = lambda a, b: float((a - b).abs().max() / b.norm().clamp_min(1e-30))
    worst = 0.0
    steps = [st.make_dit_train_step(cfg, tc, sched, mode=m) for m in (0, 1)]
    steps.append(mmd.make_mmd_finetune_step(cfg, tc, sched))
    for name, step in zip(("mode 0", "mode 1", "mmd"), steps):
        draws = step.draw(batch, torch.Generator().manual_seed(SEED + 1))
        outs = {}
        for where, dev in (("cpu", cpu), ("card", DEV)):
            to = lambda x: x.to(dev, copy=True)     # the step writes its trees
            d = {k: [to(c) for c in v] if isinstance(v, list) else to(v)
                 for k, v in draws.items()}
            p = tree_map(to, params)
            (loss, _), grads = step.loss_and_grads(
                p, tree_map(to, batch), **d)
            new, _, _ = step.with_draws(p, tree_map(to, state),
                                        tree_map(to, batch), **d)
            outs[where] = (loss.cpu(), [x.cpu() for x in tree_leaves(grads)],
                           [x.cpu() for x in tree_leaves(new)])
        (lc, gc, pc), (lg, gg, pg) = outs["cpu"], outs["card"]
        errs = [abs(float(lg - lc)) / abs(float(lc))]
        errs += [rel(a, b) for a, b in zip(gg, gc)]
        p_err = max(rel(a, b) for a, b in zip(pg, pc))
        log(f"[train] card vs CPU, tiny float32 config, {name}: loss "
            f"{float(lg):.6f} vs {float(lc):.6f}; worst loss / gradient-leaf "
            f"error {max(errs):.2e} of {len(gc)} leaves; updated parameters "
            f"{p_err:.2e} (tol {CARD_CPU_TOL})")
        if not max(errs + [p_err]) <= CARD_CPU_TOL:
            raise AssertionError(f"card and CPU train steps differ ({name}): "
                                 f"{max(errs + [p_err])}")
        worst = max(worst, max(errs), p_err)
    return worst


def phase_training(gen: torch.Generator, smi: str) -> dict:
    """DiT-XL/2 at full width through the port's training path: the
    shared recipe (modes 0 and 1 alternating), the LoRA recipe's
    distillation, one bootstrapped-MMD step, a learning check with a
    planted-fault control, the card against the CPU, the trainer's CLI,
    and the CLI's checkpoint restored and served on the flash kernel."""
    import shutil
    import tempfile

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import distill, flexify, mmd, trainable_mask
    from repro_torch.core.scheduler import dit_nfe_flops
    from repro_torch.launch import steps as st
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw

    t0 = time.perf_counter()
    params, cfg = trained_like_xl(gen)
    sched = linear_schedule(1000)
    tgen = torch.Generator(device=DEV).manual_seed(SEED)
    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=0, total_steps=1000,
                     schedule="constant")
    n_params = sum(x.numel() for x in tree_leaves(params))
    log(f"[train] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"{n_params / 1e6:.1f}M parameters in {cfg.param_dtype}, float32 "
        f"moments; weights in {time.perf_counter() - t0:.1f}s ({smi})")

    # 1. the shared recipe: modes 0 and 1 alternating, captured against
    # eager (the step writes its trees: a copy of the weights)
    batch = train_batch(cfg, TRAIN_BATCH, SEED)
    errors = []
    state = {"p": tree_map(torch.clone, params)}
    state["o"] = adamw.init_opt_state(state["p"])
    base = torch.cuda.memory_allocated()
    shared = captured_vs_eager(
        "train", "shared recipe (modes 0, 1)",
        lambda: [st.make_dit_train_step(cfg, tc, sched, mode=m)
                          for m in (0, 1)],
        state, [batch], "loss", TRAIN_K, 3, smi, errors)
    if not all(np.isfinite(shared["losses"])) or not all(
            torch.isfinite(x).all() for x in tree_leaves(state["p"])):
        raise AssertionError(f"shared-recipe steps not finite: {shared['losses']}")
    per_sample = {}
    out = {"ms": {}, "eager_ms": {}, "tflops": {}, "peak_gb": {},
           "eager_peak_gb": {}, "pool_gb": {}}
    for mode in (0, 1):
        r = shared["per"][mode]
        flop = 3 * TRAIN_BATCH * dit_nfe_flops(cfg, mode)
        out["ms"][mode], out["eager_ms"][mode] = r["captured_ms"], r["eager_ms"]
        out["peak_gb"][mode] = r["captured_peak"] / 1e9
        out["eager_peak_gb"][mode] = r["eager_peak"] / 1e9
        out["pool_gb"][mode] = shared["keys"][mode]["pool"] / 1e9
        out["tflops"][mode] = flop / r["captured_ms"] / 1e9
        per_sample[mode] = (r["eager_peak"] - base) / TRAIN_BATCH
        log(f"[train] shared recipe, mode {mode} "
            f"({dit_mod.tokens_for_mode(cfg, mode)} tokens), B={TRAIN_BATCH}: "
            f"{r['captured_ms']:.1f} ms/step captured vs {r['eager_ms']:.1f} "
            f"eager, {flop / 1e12:.2f} TFLOP a step (3 x B x dit_nfe_flops), "
            f"{out['tflops'][mode]:.1f} TFLOP/s captured, "
            f"{flop / r['eager_ms'] / 1e9:.1f} eager ({smi})")
    del state
    torch.cuda.empty_cache()

    # 2. the LoRA recipe: rank-8 adapters, the base frozen, distilled
    # (flexify copies the weights it keeps: params stays as drawn)
    lparams, lcfg = flexify(params, cfg, [(1, 4, 4)], lora_rank=8,
                            generator=gen)
    mask = trainable_mask(lparams, "lora")
    state = {"p": lparams, "o": adamw.init_opt_state(lparams)}
    lora = captured_vs_eager(
        "train", "LoRA distillation",
        lambda: [distill.make_distill_step(lcfg, tc, sched,
                                                         trainable=mask)],
        state, [batch], "distill_loss", 1, 3, smi, errors)
    flat = lambda tree: dict(enumerate(tree_leaves(tree)))
    fm, f0, f1 = flat(mask), flat(lora["start"]["p"]), flat(state["p"])
    fmo, fvo = flat(state["o"]["m"]), flat(state["o"]["v"])
    frozen = [i for i, on in fm.items() if not on]
    moved = [i for i, on in fm.items()
             if on and not torch.equal(f1[i], f0[i].to(DEV))]
    kept = all(torch.equal(f1[i], f0[i].to(DEV)) and not fmo[i].any()
               and not fvo[i].any() for i in frozen)
    dms = lora["per"][0]
    out["lora_ms"], out["lora_eager_ms"] = dms["captured_ms"], dms["eager_ms"]
    log(f"[train] LoRA recipe (rank 8, trainable_mask 'lora'): distill "
        f"{lora['losses'][-1]:.4f}, {dms['captured_ms']:.1f} ms/step captured "
        f"vs {dms['eager_ms']:.1f} eager; {len(frozen)} frozen leaves "
        f"({sum(f0[i].numel() for i in frozen) / 1e6:.1f}M) unchanged bit for "
        f"bit with zero moments: {kept}; {len(moved)} of "
        f"{len(fm) - len(frozen)} trainable leaves moved")
    if not kept or not moved or not np.isfinite(lora["losses"][-1]):
        errors.append("the LoRA recipe moved a frozen leaf, or moved nothing")
    if errors:
        raise AssertionError("training: " + "; ".join(errors))
    del state, lparams, lora, f0, f1, fmo, fvo
    torch.cuda.empty_cache()

    # 3. one bootstrapped-MMD fine-tune step (captured: its first call runs
    # eagerly, then captures), its batch sized from the measured memory:
    # the chain backpropagates through 2 weak and 2 powerful forwards plus
    # the denoising forward (~3.5 mode-0 forwards)
    free = torch.cuda.mem_get_info()[0] - 8e9
    mmd_b = int(max(2, min(16, free // (3.5 * 1.25 * per_sample[0]))))
    mstep = mmd.make_mmd_finetune_step(cfg, tc, sched)
    mp = tree_map(torch.clone, params)
    opt = adamw.init_opt_state(mp)
    torch.cuda.reset_peak_memory_stats()
    (_, _, m), dt = cuda_ms(lambda: mstep(mp, opt, train_batch(cfg, mmd_b, 1),
                                          tgen))
    mmd_loss, den = float(m["mmd_loss"]), float(m["denoise_loss"])
    log(f"[train] MMD fine-tune step (2 weak + 2 powerful chain steps), "
        f"B={mmd_b} (sized from {per_sample[0] / 1e9:.2f} GB a sample at mode "
        f"0): denoise {den:.4f}, mmd {mmd_loss:.4f}, {dt:.1f} ms with its "
        f"capture ({mstep.captures} graph), peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if not (np.isfinite(mmd_loss) and np.isfinite(den)):
        raise AssertionError(f"MMD step not finite: {m}")
    del opt, mp, mstep
    torch.cuda.empty_cache()

    # 4. the learning check, then the same with the update's sign flipped,
    # each from a copy of the weights through a step object of its own
    ltc = dataclasses.replace(tc, learning_rate=LEARN_LR)
    lbatch = train_batch(cfg, LEARN_BATCH, 2)
    ratios = {}
    for name, wrap in (("sound", lambda s: s), ("sign flipped", flip_update)):
        lp = tree_map(torch.clone, params)
        traj, ratios[name] = learning_check(
            wrap(st.make_dit_train_step(cfg, ltc, sched, mode=0)), lp,
            adamw.init_opt_state(lp), lbatch, LEARN_N)
        del lp
        log(f"[train] learning check ({name}), {LEARN_N} steps on one batch "
            f"(B={LEARN_BATCH}, lr {LEARN_LR}): loss "
            f"{', '.join(f'{x:.4f}' for x in traj)}; mean(last {LEARN_TAIL}) / "
            f"first = {ratios[name]:.4f} (limit {LEARN_LIMIT})")
        torch.cuda.empty_cache()
    if not ratios["sound"] < LEARN_LIMIT:
        raise AssertionError(f"training does not learn: {ratios['sound']}")
    if not ratios["sign flipped"] >= LEARN_LIMIT:
        raise AssertionError(f"the learning check misses a sign-flipped "
                             f"update: {ratios['sign flipped']}")

    # 5. the card against the CPU
    card_err = card_against_cpu(tc)
    del params
    torch.cuda.empty_cache()

    # 6. the trainer's CLI in-process at full width; 7. its checkpoint
    # restored and served on the flash kernel
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t1 = time.perf_counter()
        cli = train_mod.main(["--arch", "dit-xl-2", "--steps", "4", "--flexi",
                              "--recipe", "lora", "--batch", "8",
                              "--ckpt-dir", ckpt_dir])
        wall = time.perf_counter() - t1
        ck = Checkpointer(cli["ckpt_root"])
        t1 = time.perf_counter()
        tree, _ = ck.restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        nbytes = sum(f.stat().st_size for f in Path(ck.root).rglob("*.npy"))
        log(f"[train] repro_torch.launch.train --arch dit-xl-2 --steps 4 "
            f"--flexi --recipe lora --batch 8: {wall:.1f}s, losses "
            f"{cli['losses']}; its steps {cli['graphs']} (one graph a mode, "
            f"the rest replays); checkpoint steps {ck.all_steps()}, "
            f"{nbytes / 1e9:.2f} GB, restored in {restore_s:.1f}s")
        if ck.all_steps() != [4] or int(tree["opt"]["step"]) != 4:
            raise AssertionError(f"the CLI's checkpoint: {ck.all_steps()}")
        if (cli["graphs"]["captured"], cli["graphs"]["replays"]) != (2, 2):
            raise AssertionError(f"the CLI's steps did not run captured: "
                                 f"{cli['graphs']}")
        mism = [i for i, (a, b) in enumerate(zip(tree_leaves(tree["params"]),
                                                 tree_leaves(cli["params"])))
                if a.dtype != b.dtype or not torch.equal(a, b)]
        if mism:
            raise AssertionError(f"restored leaves differ: {mism}")
        fcfg = cli["cfg"]
        plan = SamplingPlan(T=T_STEPS, budget=0.6, guidance_scale=1.5,
                            attn_backend="pallas")
        labels = torch.tensor([1, 207, 360, 979], device=DEV) % fcfg.dit.num_classes
        x0 = {}
        for name, tree_p in (("restored", tree["params"]),
                             ("in memory", cli["params"])):
            pipe = FlexiPipeline(tree_p, fcfg, sched, device=DEV)
            ops.reset_launches()
            res = pipe.sample(plan, len(labels),
                              torch.Generator(device=DEV).manual_seed(7),
                              cond=labels)
            torch.cuda.synchronize()
            launches = ops.flash_attention.launches
            by_variant = dict(ops.flash_attention.launches_by_variant)
            calls = forward_calls(plan, fcfg)
            if not (launches == fcfg.num_layers * calls
                    == by_variant["wgmma"]):
                raise AssertionError(f"served {name} parameters: flash "
                                     f"launches {by_variant}, expected "
                                     f"{fcfg.num_layers} x {calls}, all wgmma")
            x0[name] = res.x0
            log(f"[train] served the {name} parameters at budget 0.6 "
                f"(schedule {plan.resolve_schedule(fcfg).phases}, CFG 1.5): "
                f"flash launches {launches} = {fcfg.num_layers} x {calls} "
                f"forward calls, by variant {by_variant}; x0 finite "
                f"{bool(torch.isfinite(res.x0).all())}")
            if name == "restored":
                serve_launches = launches
            del pipe
        same = torch.equal(x0["restored"], x0["in memory"])
        log(f"[train] x0 restored == in memory, bit for bit: {same}")
        if not same or not torch.isfinite(x0["restored"]).all():
            raise AssertionError("x0 from the restored checkpoint differs")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"[train] phase done in {time.perf_counter() - t0:.1f}s ({smi})")
    return {"launches": serve_launches, "card_err": card_err, **out,
            "learn": ratios}


# ---------------------------------------------------------------------------
# Head width 256: phase 2's checks and phase 6's times


def flash_ref_by_head(q, k, v, **kw) -> torch.Tensor:
    """The plain version one (batch row, kv head) at a time: a [G, S, S]
    float32 score tile alive instead of [B, H, S, S] (8.6 GB at the gemma2
    shape, and several of them)."""
    H, K = q.shape[2], k.shape[2]
    G = H // K
    out = torch.empty_like(q)
    for b in range(q.shape[0]):
        for kh in range(K):
            hs = slice(kh * G, (kh + 1) * G)
            out[b:b + 1, :, hs] = flash_attention_ref(
                q[b:b + 1, :, hs].contiguous(), k[b:b + 1, :, kh:kh + 1].contiguous(),
                v[b:b + 1, :, kh:kh + 1].contiguous(), **kw)
    return out


def phase_hd256_kernel_checks(gen: torch.Generator) -> float:
    """Each flash variant at hd 256 and the gemma2 shapes against the plain
    version: bf16 inputs select ``wgmma`` (``mma`` forced beside it),
    float32 inputs ``f32``. Returns the worst max|err|."""
    worst = 0.0
    for B, S, H, K, c, cap, w in HD256_CASES:
        kw = dict(causal=c, softcap=cap, window=w)
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (randn(gen, (B, S, h, 256), dt) for h in (H, K, K))
            want = flash_ref_by_head(q, k, v, **kw).float()
            selected = variant_of(q, k, v)
            if selected != ("wgmma" if dt == torch.bfloat16 else "f32"):
                raise AssertionError(f"hd 256 {dt}: selects {selected}")
            for variant in ((selected, "mma") if dt == torch.bfloat16 else (selected,)):
                got = flash_attention_cuda(q, k, v, **ops.kernel_kwargs(q, k, **kw),
                                           variant=variant)
                torch.cuda.synchronize()
                err = (got.float() - want).abs().max().item()
                rel = ((got.float() - want).norm() / want.norm()).item()
                log(f"[kernel] flash_attention ({variant}) B{B} S{S} H{H} K{K} hd256 "
                    f"causal={int(c)} cap={cap} win={w} {str(dt)[6:]} (gemma2-9b): "
                    f"max|err|={err:.3e}, ||err||/||ref||={rel:.3e}")
                ok = (rel <= HD256_REL_TOL if dt == torch.bfloat16
                      else err <= TOL[torch.float32])
                if not ok:
                    raise AssertionError(f"flash_attention {variant} at hd 256 "
                                         f"disagrees with its plain version: "
                                         f"max {err}, rel {rel}")
                worst = max(worst, err)
            del q, k, v, want
    return worst


def visible_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask allows in one S x S head."""
    q = np.arange(S)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(S, int)
    hi = q + 1 if causal else np.minimum(q + window, S) if window > 0 else np.full(S, S)
    return int((hi - lo).sum())


def phase_hd256_timing(gen: torch.Generator) -> dict:
    """The flash kernel at gemma2-9b's prefill shapes (a local layer:
    causal, window 4096, softcap 50; a global one: window 0), in
    interleaved rounds with the mma.sync kernel and the one PyTorch call
    that computes the same function, FlexAttention compiled with a softcap
    ``score_mod`` and a causal-window ``mask_mod``; SDPA (causal, no
    softcap, no window: another function) as a labelled reference only.
    The plain version (one kv head at a time) by CUDA events."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention
    B, S, H, K, hd = 2, 8192, 16, 8, 256
    cap = 50.0
    q, k, v = (randn(gen, (B, S, h, hd), torch.bfloat16) for h in (H, K, K))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    flex = torch.compile(flex_attention)
    out = {}
    def score_mod(sc, b, h, qi, ki):
        return torch.tanh(sc / cap) * cap

    def causal_window(w):
        def mask_mod(b, h, qi, ki):
            return (qi >= ki) & (qi - ki < w) if w > 0 else qi >= ki
        return mask_mod

    for w in (4096, 0):
        kw = ops.kernel_kwargs(q, k, causal=True, softcap=cap, window=w)
        bm = create_block_mask(causal_window(w), None, None, S, S, device=DEV)
        o_flex = flex(qt, kt, vt, score_mod=score_mod, block_mask=bm, enable_gqa=True)
        want = flash_ref_by_head(q, k, v, causal=True, softcap=cap, window=w).float()
        flex_rel = ((o_flex.transpose(1, 2).float() - want).norm() / want.norm()).item()
        t = interleaved_ms({
            "wgmma": lambda: flash_attention_cuda(q, k, v, **kw, variant="wgmma"),
            "mma": lambda: flash_attention_cuda(q, k, v, **kw, variant="mma"),
            "flex": lambda: flex(qt, kt, vt, score_mod=score_mod, block_mask=bm,
                                 enable_gqa=True),
            "sdpa (causal, no softcap)": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)},
            calls=5, replays=4)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        flash_ref_by_head(q, k, v, causal=True, softcap=cap, window=w)
        start.record()
        for _ in range(2):
            flash_ref_by_head(q, k, v, causal=True, softcap=cap, window=w)
        end.record()
        torch.cuda.synchronize()
        plain = start.elapsed_time(end) / 2
        pairs = visible_pairs(S, True, w)
        flops = 4 * B * H * hd * pairs
        nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * K * hd)
        bound, by = bound_ms(nbytes, flops, BF16_FLOPS)
        ms = t["wgmma"]["ms"]
        log(f"[time] flash_attention B{B} S{S} H{H} K{K} hd{hd} causal softcap "
            f"{cap} window {w} bf16 (gemma2-9b prefill), medians of "
            f"{t['wgmma']['rounds']} interleaved rounds (fastest-slowest): "
            f"{turns_line(t)}; plain {plain:.3f} ms; bound {bound:.4f} ms ({by}: "
            f"{flops / 1e12:.3f} TFLOP over {pairs} visible pairs a head, "
            f"{nbytes / 1e6:.0f} MB); {bound / ms:.1%} of the bound, "
            f"{t['flex']['ms'] / ms:.2f}x FlexAttention's speed (its "
            f"||o - ref|| / ||ref|| {flex_rel:.3e}), {t['mma']['ms'] / ms:.2f}x "
            f"the mma kernel's")
        out[f"B{B} S{S} H{H} K{K} hd{hd} causal softcap {cap:g} window {w}"] = dict(
            ms=ms, prev_ms=t["mma"]["ms"], plain_ms=plain,
            library_ms=t["flex"]["ms"], sdpa_causal_no_softcap_ms=t[
                "sdpa (causal, no softcap)"]["ms"], bound_ms=bound, bound_by=by)
        del want, o_flex
    return out


# ---------------------------------------------------------------------------
# Phase 11: language-model serving


def rel_logits(x: torch.Tensor, ref: torch.Tensor) -> float:
    return ((x.float() - ref.float()).norm() / ref.float().norm()).item()


def lm_decode(decode, params, cache, first: torch.Tensor, start: int, n: int,
              feed: torch.Tensor = None):
    """n greedy decode steps through the ``decode`` runner (one
    ``make_decode_step``, built once: its first call on a cache captures a
    graph, the later ones replay it; under ``graphs.disabled()`` it runs
    eagerly) from ``first`` ([B, 1]) on ``cache`` in place; with ``feed``
    ([B, n]) the tokens fed are those (so two caches can be held step for
    step), else each step's argmax. Returns (logits [B, n, V], the tokens
    fed [B, n], each step's wall seconds, each ending in a
    synchronisation)."""
    tok, logits_all, fed, walls = first, [], [], []
    for i in range(n):
        fed.append(tok)
        pos = torch.full((tok.shape[0],), start + i, dtype=torch.int32, device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, out = decode(params, cache, tok, pos)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if out is not cache:
            raise AssertionError("the decode step did not return the caller's cache")
        logits_all.append(logits)
        tok = (feed[:, i + 1:i + 2] if feed is not None and i + 1 < n
               else logits.argmax(-1).to(torch.int32)[:, None])
    return torch.stack(logits_all, 1), torch.cat(fed, 1), walls


def timed_call(fn):
    """``fn()`` and its wall seconds, between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def lm_serve_pair(cfg, params, inputs: dict, n_dec: int, dense_fn=None) -> dict:
    """One batch served as ``launch/serve.serve_lm`` serves it, through two
    runners built once (``make_prefill_step`` on the flash kernel,
    ``make_decode_step``): the prefill's first call (eager, then the
    capture), a replay, and the same runner under ``graphs.disabled()``;
    each prefill's cache written into a slot of its own (``lm.serve_slot``
    + ``write_kv_slot``); the dense backend's prefill (``dense_fn``, by
    default a dense runner) under ``graphs.disabled()`` (a captured dense
    prefill would keep its float32 scores in a pool); ``n_dec`` greedy
    decode steps from the dense cache (eager), whose tokens are fed to the
    captured decode on the replay's slot (its first step captures) and to
    the eager decode on the eager prefill's slot. Returns the readings:
    walls, flash launches a prefill call, whether captured equals eager
    bit for bit (logits, decode logits, every slot leaf), graphs, pool
    bytes a key, the bytes a decode replay copies in."""
    prefill = lm_steps.make_prefill_step(cfg, backend="pallas")
    decode = lm_steps.make_decode_step(cfg)
    B, S = inputs["tokens"].shape
    walls, launches, out = {}, {}, {}
    for run in ("first", "replay", "eager"):
        before = dict(ops.flash_attention.launches_by_variant)
        ctx = graphs.disabled() if run == "eager" else contextlib.nullcontext()
        with ctx:
            out[run], walls[run] = timed_call(lambda: prefill(params, inputs))
        launches[run] = {k: v - before[k] for k, v in
                         ops.flash_attention.launches_by_variant.items()}
    with graphs.disabled():
        if dense_fn is None:
            dense = lm_steps.make_prefill_step(cfg, backend="dense")
            dense_fn = lambda: dense(params, inputs)        # noqa: E731
        (logits_d, cache_d), walls["dense"] = timed_call(dense_fn)
    logits_p, cache_p = out["replay"]
    logits_e, cache_e = out["eager"]
    prefill_equal = (torch.equal(logits_p, logits_e)
                     and torch.equal(out["first"][0], logits_e)
                     and all(torch.equal(cache_p[k], cache_e[k]) for k in cache_e))
    del out
    slots = {}
    for side, cache in (("captured", cache_p), ("eager", cache_e),
                        ("dense", cache_d)):
        slots[side] = lm_mod.serve_slot(cfg, B, S + n_dec, DEV)
        write_kv_slot(slots[side], cache, S)
    del cache_p, cache_e, cache_d
    first = logits_d.argmax(-1).to(torch.int32)[:, None]
    with graphs.disabled():
        dec_d, fed, _ = lm_decode(decode, params, slots["dense"], first, S, n_dec)
    dec_p, _, walls_p = lm_decode(decode, params, slots["captured"], first, S,
                                  n_dec, feed=fed)
    with graphs.disabled():
        dec_e, _, walls_e = lm_decode(decode, params, slots["eager"], first, S,
                                      n_dec, feed=fed)
    decode_equal = torch.equal(dec_p, dec_e) and all(
        torch.equal(slots["captured"][k], slots["eager"][k]) for k in slots["eager"])
    pools = {name: graphs.stats([r])["graph_pool_bytes"]
             for name, r in (("prefill", prefill), ("decode", decode))}
    res = dict(
        walls=walls, launches=launches, logits_p=logits_p, logits_d=logits_d,
        dec_p=dec_p, dec_d=dec_d, fed=fed, first=first, slot_d=slots["dense"],
        prefill_equal=prefill_equal, decode_equal=decode_equal,
        decode_first_ms=walls_p[0] * 1e3,
        decode_ms=float(np.mean(walls_p[1:])) * 1e3 if n_dec > 1 else None,
        eager_decode_ms=float(np.mean(walls_e)) * 1e3,
        # a graph a runner is its first call's; one more is a capture after
        # warm-up (the replay, decode steps 2..n_dec)
        captured=prefill.captures + decode.captures,
        after_warm=prefill.captures + decode.captures - 2, pools=pools,
        in_bytes=decode.graphs()[0].in_bytes if decode.graphs() else None,
        cache_bytes=sum(t.numel() * t.element_size()
                        for t in slots["captured"].values()))
    del slots, prefill, decode
    return res


def pair_errors(name: str, r: dict, n_flash: int, errors: list) -> None:
    """The captured-against-eager checks of an :func:`lm_serve_pair`: bit
    for bit, two graphs (the prefill's and the decode's) and none after,
    ``n_flash`` launches a prefill call, all ``wgmma``."""
    if not (r["prefill_equal"] and r["decode_equal"]):
        errors.append(f"{name}: captured != graphs.disabled() (prefill "
                      f"{r['prefill_equal']}, decode {r['decode_equal']})")
    if r["captured"] != 2 or r["after_warm"]:
        errors.append(f"{name}: {r['captured']} graphs, {r['after_warm']} after "
                      f"warm-up (expected 2 and 0)")
    for run, got in r["launches"].items():
        if got.get("wgmma", 0) != n_flash or sum(got.values()) != n_flash:
            errors.append(f"{name} prefill ({run}): flash launches {got}, not "
                          f"{n_flash} wgmma")


def pair_line(r: dict) -> str:
    """The graphs' readings of an :func:`lm_serve_pair`, for a log line."""
    return (f"captured == graphs.disabled() bit for bit: prefill "
            f"{r['prefill_equal']}, decode {r['decode_equal']}; "
            f"{r['captured']} graphs ({r['after_warm']} after warm-up), pools "
            f"prefill {r['pools']['prefill'] / 2**20:.1f} MiB, decode "
            f"{r['pools']['decode'] / 2**20:.1f} MiB; a decode replay copies in "
            f"{r['in_bytes']} bytes")


def lm_check_decode(name: str, got: torch.Tensor, want: torch.Tensor,
                    errors: list) -> tuple:
    """Per-step relative logits error, and where the dense top-2 gap is
    clear (over twice the row's max|difference|, so no rounding can swap
    the two) the argmaxes must agree. Returns (worst rel, clear rows,
    agreeing rows)."""
    rels = [rel_logits(got[:, i], want[:, i]) for i in range(want.shape[1])]
    top2 = want.float().topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    clear = gap > 2 * (got.float() - want.float()).abs().amax(-1)
    agree = got.argmax(-1) == want.argmax(-1)
    if not bool((agree | ~clear).all()):
        errors.append(f"{name}: greedy tokens differ where the top-2 gap is clear")
    if not max(rels) <= LM_LOGIT_TOL:
        errors.append(f"{name}: decode logits {max(rels)} > {LM_LOGIT_TOL}")
    return max(rels), int(clear.sum()), int((agree & clear).sum())


def phase_lm(gen: torch.Generator, smi: str) -> dict:
    """Language-model serving through make_prefill_step / make_decode_step
    (captured runners, held against themselves under graphs.disabled())
    and the CLI. Every check reads before any limit is applied, so one
    run prints them all; then the phase fails on any miss."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.common import tree_leaves as leaves

    t0 = time.perf_counter()
    errors = []
    want_variant = select_variant(torch.bfloat16, 256, True)
    ops.reset_launches()
    expected = 0

    # gemma2-9b at full width and depth
    cfg = get_config(LM_FULL)
    params = lm_mod.init_params(cfg, gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    w_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    L = cfg.num_layers
    log(f"[lm] {cfg.name}: {L} layers, d={cfg.d_model}, {cfg.attn.num_heads} "
        f"heads over {cfg.attn.num_kv_heads} x {cfg.head_dim}, windows "
        f"{sorted(set(lm_mod.layer_windows(cfg).tolist()))}, softcap "
        f"{cfg.attn.logit_softcap} / final {cfg.final_logit_softcap}; "
        f"{n_params / 1e9:.3f} B parameters ({w_bytes / 1e9:.2f} GB) drawn on "
        f"the card in {time.perf_counter() - t0:.1f}s")
    toks = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ), device=DEV,
                         generator=gen)
    inputs = {"tokens": toks}
    r = lm_serve_pair(cfg, params, inputs, LM_DECODE)
    expected += 3 * L
    pair_errors(LM_FULL, r, L, errors)
    walls = r["walls"]
    logits_p, logits_d = r["logits_p"], r["logits_d"]
    rel = rel_logits(logits_p, logits_d)
    fault_cfg = dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn,
                                                                  sliding_window=0))
    with graphs.disabled():
        logits_f, cache_f = lm_steps.make_prefill_step(fault_cfg, backend="pallas")(
            params, inputs)
    del cache_f
    expected += L
    rel_fault = rel_logits(logits_f, logits_d)
    by_variant = dict(ops.flash_attention.launches_by_variant)
    log(f"[lm] prefill B{LM_BATCH} S{LM_SEQ} on the flash kernel: replayed "
        f"{walls['replay'] * 1e3:.1f} ms ({LM_BATCH * LM_SEQ / walls['replay']:.0f} "
        f"tokens/s), first call (eager, then the capture) "
        f"{walls['first'] * 1e3:.1f} ms, eager {walls['eager'] * 1e3:.1f} ms; "
        f"dense backend {walls['dense'] * 1e3:.1f} ms; flash launches {L} a "
        f"prefill, by variant so far {by_variant} (select_variant names "
        f"{want_variant!r} for bf16 hd 256)")
    log(f"[lm] last-position logits vs dense: ||err||/||ref|| = {rel:.3e} "
        f"(limit {LM_LOGIT_TOL}), argmax equal on "
        f"{int((logits_p.argmax(-1) == logits_d.argmax(-1)).sum())}/{LM_BATCH}; "
        f"planted fault (local layers' window 4096 -> 0): {rel_fault:.3e}")
    if not rel <= LM_LOGIT_TOL:
        errors.append(f"{LM_FULL} prefill logits {rel} > {LM_LOGIT_TOL}")
    if not rel_fault > LM_LOGIT_TOL:
        errors.append(f"the planted window fault reads {rel_fault}, within "
                      f"{LM_LOGIT_TOL}")
    if not torch.isfinite(logits_p).all():
        errors.append("prefill logits not finite")
    del logits_f

    # greedy decode from each cache: dense's own tokens fed to all three
    worst, clear, agree = lm_check_decode(LM_FULL, r["dec_p"], r["dec_d"], errors)
    decode_ms, eager_ms = r["decode_ms"], r["eager_decode_ms"]
    bound_w = w_bytes / HBM_BYTES_PER_S * 1e3
    bound_wc = (w_bytes + r["cache_bytes"]) / HBM_BYTES_PER_S * 1e3
    log(f"[lm] {LM_DECODE} greedy decode steps from each cache: captured "
        f"{decode_ms:.2f} ms a step ({LM_BATCH / decode_ms * 1e3:.0f} tokens/s; "
        f"the capturing first step {r['decode_first_ms']:.1f} ms), eager "
        f"{eager_ms:.2f} ms a step; bound {bound_w:.2f} ms a step for the "
        f"weights' {w_bytes / 1e9:.2f} GB at 3.35 TB/s ({bound_wc:.2f} ms with "
        f"the {r['cache_bytes'] / 1e9:.2f} GB cache read), {bound_w / decode_ms:.1%} "
        f"of the weight bound captured, {bound_w / eager_ms:.1%} eager; logits "
        f"vs the dense cache's: worst step ||err||/||ref|| {worst:.3e}; greedy "
        f"tokens equal on {agree}/{clear} rows with a clear top-2 gap (of "
        f"{LM_BATCH * LM_DECODE}) ({smi})")
    log(f"[lm] {LM_FULL} graphs: {pair_line(r)}")
    out = dict(prefill_ms=walls["replay"] * 1e3, prefill_first_ms=walls["first"] * 1e3,
               prefill_eager_ms=walls["eager"] * 1e3, decode_ms=decode_ms,
               decode_eager_ms=eager_ms, decode_bound_ms=bound_w,
               decode_bound_cache_ms=bound_wc, logits_rel=rel, fault_rel=rel_fault,
               pools=r["pools"])
    del params, r, logits_p, logits_d
    free_card()

    # the other configs: full width, depth cut (mamba2-130m whole)
    for name in LM_CUT:
        base = get_config(name)
        cfg = (base if name == "mamba2-130m"
               else dataclasses.replace(base, num_layers=LM_CUT_LAYERS))
        params = lm_mod.init_params(cfg, gen)
        toks = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SMALL_SEQ),
                             device=DEV, generator=gen)
        n_attn = cfg.num_layers if cfg.attn is not None else 0
        r = lm_serve_pair(cfg, params, {"tokens": toks}, LM_SMALL_DECODE)
        expected += 3 * n_attn
        want_v = select_variant(torch.bfloat16, cfg.head_dim, True) if n_attn else None
        if n_attn and want_v != "wgmma":
            errors.append(f"{name}: select_variant names {want_v}")
        pair_errors(name, r, n_attn, errors)
        rel = rel_logits(r["logits_p"], r["logits_d"])
        if not rel <= LM_LOGIT_TOL:
            errors.append(f"{name} prefill logits {rel} > {LM_LOGIT_TOL}")
        worst, clear, agree = lm_check_decode(name, r["dec_p"], r["dec_d"], errors)
        a = cfg.attn
        log(f"[lm] {name} ({cfg.family}, {cfg.num_layers} of {base.num_layers} "
            f"layers, d={cfg.d_model}"
            + (f", {a.num_heads}/{a.num_kv_heads} heads x {a.head_dim}, window "
               f"{a.sliding_window}, qkv bias {a.qkv_bias}, qk-norm {a.qk_norm}"
               if a else ", attention-free")
            + f"): prefill B{LM_BATCH} S{LM_SMALL_SEQ} flash launches "
            f"{r['launches']['replay']} a call; replayed "
            f"{r['walls']['replay'] * 1e3:.1f} ms, eager "
            f"{r['walls']['eager'] * 1e3:.1f} ms; logits vs dense {rel:.3e}; "
            f"{LM_SMALL_DECODE} decode steps captured {r['decode_ms']:.2f} ms a "
            f"step, eager {r['eager_decode_ms']:.2f}, worst {worst:.3e}, tokens "
            f"equal on {agree}/{clear} clear rows; {pair_line(r)}")
        if not torch.isfinite(r["dec_p"]).all():
            errors.append(f"{name}: decode logits not finite")
        del params, r
        free_card()

    launches = ops.flash_attention.launches
    by_variant = dict(ops.flash_attention.launches_by_variant)
    if launches != expected:
        errors.append(f"flash launches {launches}, expected {expected}")

    # the CLI, in-process, on its default (dense) prefill backend; then
    # with --mesh and --replicas, which the LM path reads not (one device)
    clis = {}
    for extra in ([], ["--mesh", "1x2", "--replicas", "2"]):
        t1 = time.perf_counter()
        cli = clis[" ".join(extra)] = serve_mod.main(LM_CLI + extra)
        log(f"[lm] repro_torch.launch.serve {' '.join(LM_CLI + extra)}: served "
            f"{cli['served']:.0f} requests, {cli['tokens']:.0f} decode tokens in "
            f"{cli['seconds']:.2f}s (prefill {cli['prefill_s'] * 1e3:.0f} ms, "
            f"decode {cli['decode_s'] * 1e3 / cli['decode_steps']:.2f} ms a step); "
            f"{cli['graphs_captured']:.0f} graphs captured, "
            f"{cli['captured_after_warmup']:.0f} by the second batch, "
            f"{cli['graph_replays']:.0f} replays, pools "
            f"{cli['graph_pool_bytes'] / 2**20:.1f} MiB; "
            f"{time.perf_counter() - t1:.1f}s with the weights' draw")
        if cli["served"] != 4 or cli["tokens"] != 4 * 15:
            errors.append(f"the LM CLI {extra} served {cli}")
        if cli["graphs_captured"] != 2 or cli["captured_after_warmup"]:
            errors.append(f"the LM CLI {extra} captured {cli['graphs_captured']} "
                          f"graphs, {cli['captured_after_warmup']} after warm-up")
        free_card()
    log(f"[lm] flash launches on the path {launches} (expected {expected}), by "
        f"variant {by_variant}; phase done in {time.perf_counter() - t0:.1f}s "
        f"({smi})")
    if errors:
        raise AssertionError("language-model serving: " + "; ".join(errors))
    out["cli_decode_ms"] = {k or "plain": v["decode_s"] * 1e3 / v["decode_steps"]
                            for k, v in clis.items()}
    return {"launches": launches, "seconds": time.perf_counter() - t0, **out}


# ---------------------------------------------------------------------------
# Phase 12: the MoE, vision and audio language models


def phase_family_kernel_checks(gen: torch.Generator) -> float:
    """The flash kernel at the shapes the MoE, vision and audio models give
    it, against its plain version (one kv head at a time), on the
    output's scale. Returns the worst max|err|."""
    worst = 0.0
    for name, B, S, H, K, hd, causal in FAM_ATTN:
        q, k, v = (randn(gen, (B, S, h, hd), torch.bfloat16) for h in (H, K, K))
        if variant_of(q, k, v) != "wgmma":
            raise AssertionError(f"{name}: selects {variant_of(q, k, v)}")
        got = flash_attention_cuda(q, k, v, **ops.kernel_kwargs(q, k, causal=causal))
        want = flash_ref_by_head(q, k, v, causal=causal).float()
        err = (got.float() - want).abs().max().item()
        rel = ((got.float() - want).norm() / want.norm()).item()
        log(f"[kernel] flash_attention (wgmma) B{B} S{S} H{H} K{K} hd{hd} "
            f"causal={int(causal)} bf16 ({name}): max|err|={err:.3e}, "
            f"||err||/||ref||={rel:.3e} (limit {FAM_ATTN_REL_TOL})")
        if not rel <= FAM_ATTN_REL_TOL:
            raise AssertionError(f"flash_attention at {name}'s shape disagrees "
                                 f"with its plain version: rel {rel}")
        worst = max(worst, err)
        del q, k, v, got, want
    return worst


def phase_family_timing(gen: torch.Generator) -> dict:
    """The flash kernel at those shapes in interleaved rounds with SDPA,
    which computes the same function there (causal or not, GQA, no
    softcap, no window); the plain version by CUDA events."""
    out = {}
    for name, B, S, H, K, hd, causal in FAM_ATTN:
        q, k, v = (randn(gen, (B, S, h, hd), torch.bfloat16) for h in (H, K, K))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kw = ops.kernel_kwargs(q, k, causal=causal)
        t = interleaved_ms({
            "wgmma": lambda: flash_attention_cuda(q, k, v, **kw, variant="wgmma"),
            "sdpa": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)},
            calls=5, replays=4)
        flash_ref_by_head(q, k, v, causal=causal)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(2):
            flash_ref_by_head(q, k, v, causal=causal)
        end.record()
        torch.cuda.synchronize()
        plain = start.elapsed_time(end) / 2
        pairs = visible_pairs(S, causal, 0)
        flops = 4 * B * H * hd * pairs
        nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * K * hd)
        bound, by = bound_ms(nbytes, flops, BF16_FLOPS)
        ms, lib = t["wgmma"]["ms"], t["sdpa"]["ms"]
        log(f"[time] flash_attention B{B} S{S} H{H} K{K} hd{hd} causal={int(causal)} "
            f"bf16 ({name}), medians of {t['wgmma']['rounds']} interleaved rounds "
            f"(fastest-slowest): {turns_line(t)}; plain {plain:.3f} ms; bound "
            f"{bound:.4f} ms ({by}: {flops / 1e12:.3f} TFLOP, {nbytes / 1e6:.0f} "
            f"MB); {bound / ms:.1%} of the bound, {lib / ms:.2f}x sdpa's speed")
        out[f"B{B} S{S} H{H} K{K} hd{hd} causal {int(causal)} ({name})"] = dict(
            ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by)
        del q, k, v, qt, kt, vt
    return out


def read_bytes_a_step(params) -> int:
    """Bytes of the weights one decode step reads: every leaf but the
    token and position tables, of which it reads a row (a tied table is
    the head and counts)."""
    skip = {"pos_embed"} | ({"embed"} if "lm_head" in params else set())
    return sum(t.numel() * t.element_size() for k, v in params.items()
               if k not in skip for t in tree_leaves({k: v}))


def moe_layer_check(cfg, params, gen, errors: list) -> dict:
    """Layer 0's routed experts at full width against the dense oracle,
    nothing dropped; the router's columns rolled by one must read over
    the limit."""
    from repro_torch.models.moe import moe_apply_dense, moe_apply_sorted
    p = {k: v[0] for k, v in params["blocks"]["moe"].items() if k != "shared"}
    m = dataclasses.replace(cfg.moe, capacity_factor=(cfg.moe.num_experts
                                                      / cfg.moe.num_experts_per_tok))
    x = randn(gen, MOE_LAYER_SHAPE + (cfg.d_model,), torch.bfloat16)
    act = cfg.mlp_activation
    y, aux = moe_apply_sorted(p, x, m, act)
    ref, _ = moe_apply_dense(p, x, m, act)
    rel = rel_err(y, ref)
    y_f, _ = moe_apply_sorted(dict(p, router=p["router"].roll(1, dims=1)), x, m, act)
    rel_f = rel_err(y_f, ref)
    dropped = float(aux["dropped_fraction"])
    log(f"[families] {cfg.name} MoE layer [{MOE_LAYER_SHAPE[0]}, "
        f"{MOE_LAYER_SHAPE[1]}, {cfg.d_model}] bf16, routed experts, capacity factor "
        f"{m.capacity_factor:.3f} (dropped {dropped}): moe_apply_sorted vs "
        f"moe_apply_dense ||y - ref||/||ref|| = {rel:.3e} (limit {MOE_LAYER_TOL}); "
        f"planted fault (router columns rolled by one): {rel_f:.3e}")
    if not rel <= MOE_LAYER_TOL or dropped != 0.0 or not torch.isfinite(y).all():
        errors.append(f"{cfg.name} MoE layer: rel {rel}, dropped {dropped}")
    if not rel_f > MOE_LAYER_TOL:
        errors.append(f"the rolled-router fault reads {rel_f}, within {MOE_LAYER_TOL}")
    return {"moe_layer_rel": rel, "moe_fault_rel": rel_f}


def encoder_fault_check(cfg, params, frames, errors: list) -> dict:
    """whisper's first encoder layer's q, k, v: the kernel (non-causal)
    against the plain version, and the kernel run causal, which must read
    over the limit against the non-causal plain version."""
    from repro_torch.models.attention import project_qkv
    from repro_torch.models.common import apply_norm
    p = tree_map(lambda t: t[0], params["enc_blocks"])
    h = apply_norm(p["ln1"], frames, cfg.norm_type)
    q, k, v = (t.contiguous() for t in project_qkv(p["attn"], h, h, cfg.attn))
    want = flash_ref_by_head(q, k, v, causal=False).float()
    rels = {}
    for causal in (False, True):
        got = flash_attention_cuda(q, k, v, **ops.kernel_kwargs(q, k, causal=causal))
        rels[causal] = rel_err(got, want)
    log(f"[families] {cfg.name} encoder layer 0 q/k/v {tuple(q.shape)}: kernel vs "
        f"plain (non-causal) {rels[False]:.3e} (limit {FAM_ATTN_REL_TOL}); planted "
        f"fault (kernel run causal): {rels[True]:.3e}")
    if not rels[False] <= FAM_ATTN_REL_TOL:
        errors.append(f"{cfg.name} encoder attention {rels[False]}")
    if not rels[True] > FAM_ATTN_REL_TOL:
        errors.append(f"the causal-encoder fault reads {rels[True]}, within "
                      f"{FAM_ATTN_REL_TOL}")
    return {"encoder_rel": rels[False], "encoder_fault_rel": rels[True]}


def family_run(name: str, keep: int, B: int, S: int, n_dec: int,
               gen: torch.Generator, smi: str, errors: list) -> dict:
    """One config: weights drawn on the card, one batch served through
    captured runners and the same runners under graphs.disabled()
    (:func:`lm_serve_pair`: prefill on the flash kernel, decode), the
    dense prefill (with the MoE aux) and decode under graphs.disabled(),
    the logits gap, the family's planted fault. Returns its readings and
    its flash launches."""
    base = get_config(name)
    cfg = dataclasses.replace(base, num_layers=keep) if keep else base
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm_mod.init_params(cfg, gen)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    if cfg.family == "vlm":                 # open the zero-initialised gates
        for g in ("gate_attn", "gate_mlp"):
            params["groups"]["cross"][g].fill_(VLM_GATE)
    n_params = sum(t.numel() for t in tree_leaves(params))
    read_b = read_bytes_a_step(params)
    log(f"[families] {name} ({cfg.family}, {cfg.num_layers} of {base.num_layers} "
        f"layers, d={cfg.d_model}, {cfg.attn.num_heads}/{cfg.attn.num_kv_heads} "
        f"heads x {cfg.head_dim}): {n_params / 1e9:.3f} B parameters drawn on the "
        f"card in {draw_s:.1f}s, peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB (now {torch.cuda.memory_allocated() / 1e9:.2f} GB)")
    inputs = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), device=DEV,
                                      generator=gen)}
    if cfg.family == "vlm":
        inputs["vision"] = randn(gen, (B, cfg.vision_tokens, cfg.d_model), torch.bfloat16)
    if cfg.family == "audio":
        inputs["frames"] = randn(gen, (B, cfg.audio_frames, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm":
        k_grp, groups = lm_mod._vlm_group(cfg)
        n_flash = groups * (k_grp - 1)
    elif cfg.family == "audio":
        n_flash = cfg.encoder_layers
    else:
        n_flash = cfg.num_layers
    aux = {}
    r = lm_serve_pair(cfg, params, inputs, n_dec, dense_fn=lambda: lm_mod.prefill(
        params, inputs["tokens"], cfg, extra=inputs, backend="dense", aux_out=aux))
    pair_errors(name, r, n_flash, errors)
    out = {"launches": sum(sum(v.values()) for v in r["launches"].values())}
    walls = r["walls"]
    logits_p, logits_d = r["logits_p"], r["logits_d"]
    rel = rel_logits(logits_p, logits_d)
    drop = (f", dropped_fraction {float(aux['dropped_fraction']) / cfg.num_layers:.4f} "
            f"a layer at capacity factor {cfg.moe.capacity_factor}" if aux else "")
    log(f"[families] {name} prefill B{B} S{S}: flash replayed {walls['replay'] * 1e3:.1f}"
        f" ms (first call, eager then the capture, {walls['first'] * 1e3:.1f} ms; "
        f"eager {walls['eager'] * 1e3:.1f} ms; {n_flash} wgmma launches a call), "
        f"dense {walls['dense'] * 1e3:.1f} ms; last-position logits vs dense "
        f"||err||/||ref|| = {rel:.3e} (limit {LM_LOGIT_TOL}), argmax equal on "
        f"{int((logits_p.argmax(-1) == logits_d.argmax(-1)).sum())}/{B}{drop}")
    if not rel <= LM_LOGIT_TOL or not torch.isfinite(logits_p).all():
        errors.append(f"{name} prefill logits {rel} > {LM_LOGIT_TOL}")
    if cfg.moe is not None and keep == 0:
        out.update(moe_layer_check(cfg, params, gen, errors))
    if cfg.family == "audio":
        out.update(encoder_fault_check(cfg, params, inputs["frames"], errors))

    worst, clear, agree = lm_check_decode(name, r["dec_p"], r["dec_d"], errors)
    decode_ms, eager_ms = r["decode_ms"], r["eager_decode_ms"]
    bound = read_b / HBM_BYTES_PER_S * 1e3
    log(f"[families] {name} {n_dec} greedy decode steps from each cache: captured "
        f"{decode_ms:.2f} ms a step (the capturing first step "
        f"{r['decode_first_ms']:.1f} ms), eager {eager_ms:.2f} ms a step; bound "
        f"{bound:.2f} ms for the {read_b / 1e9:.2f} GB of weights a step reads at "
        f"3.35 TB/s ({bound / decode_ms:.1%} of it captured, {bound / eager_ms:.1%} "
        f"eager); logits vs the dense cache's: worst step {worst:.3e}; greedy "
        f"tokens equal on {agree}/{clear} rows with a clear top-2 gap (of "
        f"{B * n_dec}) ({smi})")
    log(f"[families] {name} graphs: {pair_line(r)}")
    if not torch.isfinite(r["dec_p"]).all():
        errors.append(f"{name}: decode logits not finite")
    if cfg.family == "vlm":     # the vision keys and values zeroed
        fault = {k: (torch.zeros_like(t) if k in ("xk", "xv") else t.clone())
                 for k, t in r["slot_d"].items()}
        with graphs.disabled():
            dec_f, _, _ = lm_decode(lm_steps.make_decode_step(cfg), params, fault,
                                    r["first"], S, n_dec, feed=r["fed"])
        rel_f = max(rel_logits(dec_f[:, i], r["dec_d"][:, i]) for i in range(n_dec))
        log(f"[families] {name} planted fault (decode from a cache whose vision "
            f"keys and values are zeroed): worst step {rel_f:.3e}")
        if not rel_f > LM_LOGIT_TOL:
            errors.append(f"the zeroed vision cache reads {rel_f}, within {LM_LOGIT_TOL}")
        out["vision_fault_rel"] = rel_f
        del fault
    out.update(prefill_ms=walls["replay"] * 1e3, prefill_first_ms=walls["first"] * 1e3,
               prefill_eager_ms=walls["eager"] * 1e3, dense_prefill_ms=walls["dense"] * 1e3,
               logits_rel=rel, decode_ms=decode_ms, decode_eager_ms=eager_ms,
               decode_bound_ms=bound, decode_rel=worst, pools=r["pools"])
    if aux:
        out["dropped_fraction"] = float(aux["dropped_fraction"]) / cfg.num_layers
    return out


def phase_lm_families(gen: torch.Generator, smi: str) -> dict:
    """The MoE, vision and audio models through make_prefill_step /
    make_decode_step (captured runners, held against themselves under
    graphs.disabled()) and the CLI. Every check reads before any limit is
    applied; then the phase fails on any miss."""
    from repro_torch.launch import serve as serve_mod

    t0 = time.perf_counter()
    errors = []
    ops.reset_launches()
    launches = 0
    results = {}
    for name, keep, B, S, n_dec in FAM_RUNS:
        r = family_run(name, keep, B, S, n_dec, gen, smi, errors)
        launches += r.pop("launches")
        results[name] = r
        free_card()
    by_variant = dict(ops.flash_attention.launches_by_variant)
    if ops.flash_attention.launches != launches or by_variant.get("wgmma") != launches:
        errors.append(f"flash launches {ops.flash_attention.launches} by variant "
                      f"{by_variant}, expected {launches} wgmma")
    total = ops.flash_attention.launches
    for argv in FAM_CLI:
        t1 = time.perf_counter()
        cli = serve_mod.main(argv)
        log(f"[families] repro_torch.launch.serve {' '.join(argv)}: served "
            f"{cli['served']:.0f} requests, {cli['tokens']:.0f} decode tokens "
            f"(prefill {cli['prefill_s'] * 1e3:.0f} ms, decode "
            f"{cli['decode_s'] * 1e3 / cli['decode_steps']:.2f} ms a step); "
            f"{cli['graphs_captured']:.0f} graphs captured, "
            f"{cli['captured_after_warmup']:.0f} by the second batch, pools "
            f"{cli['graph_pool_bytes'] / 2**20:.1f} MiB; "
            f"{time.perf_counter() - t1:.1f}s with the weights' draw")
        if cli["served"] != 4 or cli["tokens"] != 4 * 15:
            errors.append(f"the CLI {argv[1]} served {cli}")
        if cli["graphs_captured"] != 2 or cli["captured_after_warmup"]:
            errors.append(f"the CLI {argv[1]} captured {cli['graphs_captured']} "
                          f"graphs, {cli['captured_after_warmup']} after warm-up")
        free_card()
    log(f"[families] flash launches on the path {total}, by variant {by_variant}; "
        f"phase done in {time.perf_counter() - t0:.1f}s ({smi})")
    if errors:
        raise AssertionError("MoE, vision and audio serving: " + "; ".join(errors))
    return {"launches": total, "seconds": time.perf_counter() - t0, **results}


# ---------------------------------------------------------------------------
# Phase 13: language-model training


def lm_cut(name: str, keep: int):
    """(the config, the config cut to ``keep`` layers (0: whole))."""
    base = get_config(name)
    return base, (dataclasses.replace(base, num_layers=keep) if keep else base)


def lm_train_batch(cfg, B: int, S: int, seed: int, gen: torch.Generator,
                   device=None) -> dict:
    """B x S tokens and targets of the trainer's corpus (the reference's
    bigram stream, make_lm_batch_fn), and a seeded image or frames (bf16
    on the card, else float32)."""
    from repro_torch.data import pipeline as dp
    device = device or DEV
    b = dp.make_lm_batch_fn(cfg.vocab_size, S, B)(0, 0, 1, np.random.default_rng(seed))
    out = {k: torch.from_numpy(b[k]).to(device) for k in ("tokens", "targets")}
    dt = torch.bfloat16 if device == DEV else torch.float32
    for key, n, fam in (("vision", cfg.vision_tokens, "vlm"),
                        ("frames", cfg.audio_frames, "audio")):
        if cfg.family == fam:
            out[key] = torch.randn((B, n, cfg.d_model), generator=gen,
                                   device=gen.device).to(device, dt)
    return out


def lm_train_flops(cfg, params, B: int, S: int) -> float:
    """Model FLOPs of a step: 6 x parameters (a MoE's active ones: the
    routed experts at k / E) x tokens, plus QK and PV over the pairs each
    layer's mask lets through, forward and backward (12 x B x H x hd x
    pairs); the remat recompute is not counted."""
    n = sum(t.numel() for t in tree_leaves(params))
    if cfg.moe is not None:
        routed = sum(t.numel() for k, t in params["blocks"]["moe"].items()
                     if k in ("w_in", "w_gate", "w_out"))
        n -= routed * (1 - cfg.moe.num_experts_per_tok / cfg.moe.num_experts)
    a = cfg.attn
    pairs = sum(visible_pairs(S, True, int(w)) for w in lm_mod.layer_windows(cfg))
    return 6 * n * B * S + 12 * B * a.num_heads * a.head_dim * pairs


def lm_grads(cfg, params, batch):
    from repro_torch.optim import adamw
    return adamw.value_and_grad(lambda p, b: lm_mod.lm_loss(p, b, cfg), params,
                                batch)


def leaf_rels(grads, ref) -> list:
    """||g - ref|| / ||ref|| per leaf, in float32."""
    return [((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
            for a, b in zip(tree_leaves(grads), tree_leaves(ref))]


class RematNextWindow:
    """The planted fault of check 3: each layer is recomputed in the
    backward with the next layer's window (what a checkpointed function
    that read the loop's window from its enclosing scope would see)."""

    def __init__(self, cfg):
        self.windows = lm_mod.layer_windows(cfg)

    def __enter__(self):
        self.orig, seen = lm_mod._train_block, {}

        def faulty(p, x, window, *rest):
            again = id(p) in seen
            i = seen.setdefault(id(p), len(seen))
            if again:
                window = int(self.windows[(i + 1) % len(self.windows)])
            return self.orig(p, x, window, *rest)

        lm_mod._train_block = faulty
        return self

    def __exit__(self, *exc):
        lm_mod._train_block = self.orig


def lm_timed_steps(step, params, opt, batch, k: int):
    """One warm step (on the card: eager, then the capture), then ``k``
    timed ones (CUDA events): (params, opt, the timed ms, peak memory over
    all, the losses)."""
    ms, peak, losses = [], 0, []
    for i in range(k + 1):
        torch.cuda.reset_peak_memory_stats()
        (params, opt, m), dt = cuda_ms(lambda: step(params, opt, batch))
        peak = max(peak, torch.cuda.max_memory_allocated())
        losses.append(m["loss"])
        if i:
            ms.append(dt)
    return params, opt, ms, peak, [float(x) for x in losses]


def lm_full_width_run(name: str, keep: int, B: int, S: int, gen, smi: str,
                      errors: list) -> dict:
    """Draw; the captured-vs-eager check and LMT_K timed captured steps;
    training forward against serving forward on dense and pallas (check
    2). Returns its readings with the drawn and the trained parameters,
    the config and the batch."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import adamw
    base, cfg = lm_cut(name, keep)
    t0 = time.perf_counter()
    state = {"p": lm_mod.init_params(cfg, gen)}
    state["o"] = adamw.init_opt_state(state["p"])
    n_params = sum(t.numel() for t in tree_leaves(state["p"]))
    batch = lm_train_batch(cfg, B, S, SEED, gen)
    batches = [batch, lm_train_batch(cfg, B, S, SEED + 1, gen)]
    tc = TrainConfig(learning_rate=LMT_LR, warmup_steps=0, schedule="constant")
    r = captured_vs_eager("lm-train", name,
                          lambda: [lm_steps.make_train_step(cfg, tc)], state,
                          batches, "loss", LMT_K, 2, smi, errors)
    trained, opt = state["p"], state["o"]
    params = tree_map(lambda h: h.to(DEV), r["start"]["p"])     # as drawn
    run = r["per"][0]
    # where a step's time goes, eagerly: the forward alone (no graph, so
    # no recompute), forward and backward, AdamW on those gradients
    step = lm_steps.make_train_step(cfg, tc)
    with torch.no_grad():
        _, fwd_ms = cuda_ms(lambda: lm_mod.lm_loss(trained, batch, cfg))
    (_, grads), grad_ms = cuda_ms(lambda: step.loss_and_grads(trained, batch))
    _, opt_ms = cuda_ms(lambda: adamw.adamw_update(trained, grads, opt, tc))
    del opt, grads, state
    torch.cuda.empty_cache()
    step_ms = run["captured_ms"]
    split = dict(forward_ms=fwd_ms, backward_ms=grad_ms - fwd_ms, adamw_ms=opt_ms)
    flops = lm_train_flops(cfg, params, B, S)
    windows = sorted(set(lm_mod.layer_windows(cfg).tolist()))
    log(f"[lm-train] {name} ({cfg.num_layers} of {base.num_layers} layers, "
        f"d={cfg.d_model}, windows {windows}, remat {cfg.remat!r}), "
        f"{n_params / 1e9:.3f} B parameters, B={B} x S={S}: {step_ms:.1f} ms/step "
        f"captured (replays {', '.join(f'{x:.1f}' for x in run['captured_all'])}) "
        f"vs {run['eager_ms']:.1f} eager, {B * S / step_ms * 1e3:.0f} tokens/s, "
        f"{flops / 1e12:.1f} TFLOP a step, {flops / step_ms / 1e9:.1f} TFLOP/s "
        f"captured, {flops / run['eager_ms'] / 1e9:.1f} eager, peak memory "
        f"{run['captured_peak'] / 1e9:.2f} GB captured, "
        f"{run['eager_peak'] / 1e9:.2f} GB eager; eager losses "
        f"{', '.join(f'{x:.4f}' for x in r['losses'])}; "
        f"{time.perf_counter() - t0:.1f}s with the draw ({smi})")
    log(f"[lm-train] {name} a step's split (CUDA events, one eager run each): "
        f"forward alone {fwd_ms:.1f} ms, forward + backward {grad_ms:.1f} ms "
        f"(backward with the remat recompute {grad_ms - fwd_ms:.1f}), "
        f"adamw_update {opt_ms:.1f} ms, the rest of an eager step "
        f"{run['eager_ms'] - grad_ms - opt_ms:.1f} ms")
    if not all(np.isfinite(r["losses"])) or not all(torch.isfinite(t).all()
                                                    for t in tree_leaves(trained)):
        errors.append(f"{name}: training not finite: {r['losses']}")

    # check 2: the training forward's last position against prefill's
    with torch.no_grad():
        logits, _ = lm_mod.forward_train(params, batch["tokens"], cfg)
        last = logits[:, -1].clone()
        del logits
        rels = {}
        for backend in ("dense", "pallas"):
            before = ops.flash_attention.launches_by_variant.get("wgmma", 0)
            with graphs.disabled():     # arithmetic checks, not a capture
                got, cache = lm_steps.make_prefill_step(cfg, backend=backend)(
                    params, {"tokens": batch["tokens"]})
            del cache
            rels[backend] = rel_logits(last, got)
            if backend == "pallas" and (ops.flash_attention.launches_by_variant
                                        .get("wgmma", 0) - before != cfg.num_layers):
                errors.append(f"{name}: the pallas prefill's flash launches")
    log(f"[lm-train] {name} check 2: forward_train's last-position logits vs "
        f"prefill's ||err||/||ref||: dense {rels['dense']:.3e}, pallas "
        f"{rels['pallas']:.3e} (limit {LM_LOGIT_TOL})")
    if not max(rels.values()) <= LM_LOGIT_TOL:
        errors.append(f"{name}: training vs serving forward {rels}")
    return dict(cfg=cfg, params=params, trained=trained, batch=batch, ms=step_ms,
                eager_ms=run["eager_ms"], tokens_s=B * S / step_ms * 1e3,
                tflops=flops / step_ms / 1e9, peak_gb=run["captured_peak"] / 1e9,
                eager_peak_gb=run["eager_peak"] / 1e9,
                pool_gb=r["keys"][0]["pool"] / 1e9, losses=r["losses"],
                flash=cfg.num_layers, forward_rel=rels, steps=r["steps"], **split)


def lm_remat_check(name: str, cfg, params, batch, errors: list) -> float:
    """Check 4: remat "block" against "none": equal loss, every gradient
    leaf within LMT_GRAD_TOL. Returns the worst leaf."""
    (l0, _), g0 = lm_grads(dataclasses.replace(cfg, remat="none"), params, batch)
    (l1, _), g1 = lm_grads(dataclasses.replace(cfg, remat="block"), params, batch)
    worst = max(leaf_rels(g1, g0))
    log(f"[lm-train] {name} check 4, remat 'block' vs 'none' at B="
        f"{batch['tokens'].shape[0]} x S={batch['tokens'].shape[1]}: loss "
        f"{float(l1):.6f} vs {float(l0):.6f} (equal: {torch.equal(l0, l1)}), "
        f"worst gradient leaf {worst:.3e} (limit {LMT_GRAD_TOL})")
    if not torch.equal(l0, l1) or not worst <= LMT_GRAD_TOL:
        errors.append(f"{name}: remat changes the step: {float(l1)} vs "
                      f"{float(l0)}, {worst}")
    return worst


def lm_precision_check(run: dict, errors: list) -> dict:
    """Check 3: each bf16 gradient leaf against a float32 copy's, sound
    and with the planted remat fault."""
    cfg, params, batch = run["cfg"], run["params"], run["batch"]
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    (l32, _), g32 = lm_grads(cfg32, p32, batch)
    del p32
    torch.cuda.empty_cache()
    (l16, _), g16 = lm_grads(cfg, params, batch)
    sound = leaf_rels(g16, g32)
    del g16
    with RematNextWindow(cfg):
        (_, _), gf = lm_grads(cfg, params, batch)
    fault = leaf_rels(gf, g32)
    del gf, g32
    torch.cuda.empty_cache()
    log(f"[lm-train] {cfg.name} check 3, bf16 vs float32 gradients (TF32 "
        f"off), {len(sound)} leaves: loss {float(l16):.6f} vs {float(l32):.6f}; "
        f"||g - g32||/||g32|| median {np.median(sound):.3e}, worst "
        f"{max(sound):.3e} (limit {LMT_GRAD_TOL}); planted fault (remat with "
        f"the next layer's window): worst {max(fault):.3e}, median "
        f"{np.median(fault):.3e}")
    if not max(sound) <= LMT_GRAD_TOL:
        errors.append(f"{cfg.name}: bf16 gradients {max(sound)} > {LMT_GRAD_TOL}")
    if not max(fault) > LMT_GRAD_TOL:
        errors.append(f"the planted remat fault reads {max(fault)}, within "
                      f"{LMT_GRAD_TOL}")
    return {"bf16_grad_rel": max(sound), "remat_fault_rel": max(fault)}


def lm_train_then_serve(run: dict, errors: list) -> int:
    """Check 6: the trained parameters through Checkpointer.save /
    restore, then a batch served from the restored and the in-memory
    parameters through captured runners (:func:`lm_serve_pair`: a pallas
    prefill and LMT_DECODE decode steps, each held against the same
    runners under graphs.disabled()), equal bit for bit; flash launches
    one a layer a prefill call, all wgmma. Returns the launches."""
    import shutil
    import tempfile

    from repro_torch.checkpoint.checkpointer import Checkpointer
    cfg, params, toks = run["cfg"], run["trained"], run["batch"]["tokens"]
    S = toks.shape[1]
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_lm_ckpt_")
    try:
        ck = Checkpointer(ckpt_dir, device=DEV)
        t1 = time.perf_counter()
        ck.save(run["steps"], {"params": params})
        ck.wait()
        save_s = time.perf_counter() - t1
        nbytes = sum(f.stat().st_size for f in Path(ck.root).rglob("*.npy"))
        t1 = time.perf_counter()
        restored = ck.restore()[0]["params"]
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    mism = [i for i, (a, b) in enumerate(zip(tree_leaves(restored), tree_leaves(params)))
            if a.dtype != b.dtype or not torch.equal(a, b)]
    out, before = {}, dict(ops.flash_attention.launches_by_variant)
    for name, p in (("in memory", params), ("restored", restored)):
        out[name] = lm_serve_pair(cfg, p, {"tokens": toks}, LMT_DECODE)
        pair_errors(f"{cfg.name} ({name})", out[name], cfg.num_layers, errors)
    got = {k: ops.flash_attention.launches_by_variant[k] - before.get(k, 0)
           for k in ops.flash_attention.launches_by_variant}
    launches = sum(got.values())
    mem, res = out["in memory"], out["restored"]
    same = all(torch.equal(mem[k], res[k]) for k in ("logits_p", "dec_p"))
    log(f"[lm-train] {cfg.name} check 6: {run['steps']} steps trained, "
        f"Checkpointer.save {nbytes / 1e9:.2f} GB in {save_s:.1f}s, restored in "
        f"{restore_s:.1f}s, leaves differing {mism}; pallas prefill of the "
        f"{S}-token batch + {LMT_DECODE} decode steps from each, captured: logits "
        f"restored == in memory bit for bit: {same}; flash launches {got} "
        f"(expected {cfg.num_layers} x 3 prefills x 2, all wgmma); restored: "
        f"{pair_line(res)}")
    if mism or not same:
        errors.append(f"{cfg.name}: restored parameters serve differently")
    if not launches == got.get("wgmma", 0) == 6 * cfg.num_layers:
        errors.append(f"{cfg.name}: train-then-serve flash launches {got}")
    if not all(torch.isfinite(res[k]).all() for k in ("logits_p", "dec_p")):
        errors.append(f"{cfg.name}: served logits not finite")
    return launches


def lm_family_run(name: str, keep: int, B: int, S: int, gen, smi: str,
                  errors: list) -> dict:
    """Two train steps of one config at full width; the vision cut trains
    its cross layer and vision projection, the language model frozen."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import adamw
    base, cfg = lm_cut(name, keep)
    params = lm_mod.init_params(cfg, gen)
    mask = None
    if cfg.family == "vlm":
        for g in ("gate_attn", "gate_mlp"):
            params["groups"]["cross"][g].fill_(VLM_GATE)
        mask = {k: tree_map(lambda _: k in ("groups", "vision_proj"), v)
                for k, v in params.items()}
        mask["groups"]["self"] = tree_map(lambda _: False, mask["groups"]["self"])
        # a frozen leaf's moments are never read: 0-d
        zero = lambda t, on: torch.zeros(t.shape if on else (), device=DEV)
        opt = {"m": tree_map(zero, params, mask), "v": tree_map(zero, params, mask),
               "step": torch.zeros((), dtype=torch.int32, device=DEV)}
    else:
        opt = adamw.init_opt_state(params)
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = lm_train_batch(cfg, B, S, SEED, gen)
    tc = TrainConfig(learning_rate=LMT_LR, warmup_steps=0, schedule="constant")
    step = lm_steps.make_train_step(cfg, tc, trainable=mask)
    # the steps write params in place: the trainable leaves as drawn
    on = tree_leaves(mask) if mask else [True] * len(tree_leaves(params))
    drawn = [t.clone() if o else None for t, o in zip(tree_leaves(params), on)]
    new, opt, ms, peak, losses = lm_timed_steps(step, params, opt, batch, 1)
    moved = sum(d is not None and not torch.equal(a, d)
                for a, d in zip(tree_leaves(new), drawn))
    del drawn
    log(f"[lm-train] {name} ({cfg.family}, {cfg.num_layers} of {base.num_layers} "
        f"layers, d={cfg.d_model}, {n_params / 1e9:.3f} B parameters"
        + (", the language model frozen" if mask else "")
        + f"), B={B} x S={S}: 2 steps ({step.captures} graph), the second (a "
        f"replay) {ms[0]:.1f} ms, peak memory "
        f"{peak / 1e9:.2f} GB; losses {', '.join(f'{x:.4f}' for x in losses)}; "
        f"{moved} of {len(tree_leaves(params))} leaves moved")
    if not all(np.isfinite(losses)) or not moved or not all(
            torch.isfinite(t).all() for t in tree_leaves(new)):
        errors.append(f"{name}: training not finite or nothing moved")
    return {"ms": ms[0], "peak_gb": peak / 1e9}


def lm_card_against_cpu(errors: list) -> float:
    """Check 1: one reduced float32 config per family, the loss and every
    gradient leaf card against CPU from the same weights and batch (every
    all-zero leaf filled), each leaf within CARD_CPU_TOL of its norm.
    Returns the worst reading."""
    worst = 0.0
    for arch in LMT_CPU_ARCHS:
        cfg = get_config(arch).reduced()
        g = torch.Generator().manual_seed(SEED)
        params = tree_map(lambda t: t if t.any() else torch.randn(
            t.shape, generator=g) * 0.1, lm_mod.init_params(cfg, g))
        batch = lm_train_batch(cfg, 2, 40, SEED, g, device=torch.device("cpu"))
        outs = {}
        for dev in ("cpu", DEV):
            to = lambda t: t.to(dev)
            (loss, _), grads = lm_grads(cfg, tree_map(to, params), tree_map(to, batch))
            outs[str(dev)] = (loss.cpu(), [t.cpu() for t in tree_leaves(grads)])
        (lc, gc), (lg, gg) = outs["cpu"], outs[str(DEV)]
        errs = [abs(float(lg - lc)) / abs(float(lc))]
        errs += [float((a - b).abs().max() / b.norm().clamp_min(1e-30))
                 for a, b in zip(gg, gc)]
        log(f"[lm-train] check 1, {arch} reduced float32, card vs CPU: loss "
            f"{float(lg):.6f} vs {float(lc):.6f}, worst loss / gradient-leaf error "
            f"{max(errs):.2e} of {len(gc)} leaves (tol {CARD_CPU_TOL})")
        if not max(errs) <= CARD_CPU_TOL:
            errors.append(f"{arch}: card vs CPU {max(errs)}")
        worst = max(worst, max(errs))
    return worst


def phase_lm_train(gen: torch.Generator, smi: str) -> dict:
    """Language-model training through make_train_step and the trainer's
    CLI: gemma2-9b and deepseek-moe-16b at full width (cut in depth),
    checks 1-7 (see the module docstring). Every check reads before any
    limit is applied, so one run prints them all; then the phase fails on
    any miss."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw

    t0 = time.perf_counter()
    errors = []
    ops.reset_launches()
    out = {}

    # gemma2-9b cut: timed steps, checks 2, 6, 3, 4, 5
    run = lm_full_width_run(*LMT_DENSE, gen, smi, errors)
    launches = run["flash"]
    launches += lm_train_then_serve(run, errors)
    run.pop("trained")
    torch.cuda.empty_cache()
    out.update(lm_precision_check(run, errors))
    cfg, params = run["cfg"], run["params"]
    short = {k: v[:, :LMT_REMAT_SEQ] for k, v in run.pop("batch").items()}
    out["remat_rel"] = lm_remat_check(cfg.name, cfg, params, short, errors)
    del short
    torch.cuda.empty_cache()
    ltc = TrainConfig(learning_rate=LMT_LEARN_LR, warmup_steps=0, schedule="constant")
    lbatch = lm_train_batch(cfg, LMT_LEARN_B, LMT_LEARN_S, SEED + 1, gen)
    ratios = {}
    for name, wrap in (("sound", lambda s: s), ("sign flipped", flip_update)):
        lp = tree_map(torch.clone, params)     # each run from the drawn weights
        traj, ratios[name] = learning_check(
            wrap(lm_steps.make_train_step(cfg, ltc)), lp,
            adamw.init_opt_state(lp), lbatch, LMT_LEARN_N)
        del lp
        log(f"[lm-train] check 5 ({name}), {LMT_LEARN_N} steps on one batch of "
            f"the trainer's corpus (B={LMT_LEARN_B} x S={LMT_LEARN_S}, lr "
            f"{LMT_LEARN_LR}): loss {', '.join(f'{x:.4f}' for x in traj)}; "
            f"mean(last {LEARN_TAIL}) / first = {ratios[name]:.4f} (limit "
            f"{LMT_LEARN_LIMIT})")
        torch.cuda.empty_cache()
    if not ratios["sound"] < LMT_LEARN_LIMIT:
        errors.append(f"LM training does not learn: {ratios['sound']}")
    if not ratios["sign flipped"] >= LMT_LEARN_LIMIT:
        errors.append(f"the learning check misses a sign-flipped update: "
                      f"{ratios['sign flipped']}")
    out["learn"] = ratios
    keep = ("ms", "eager_ms", "tokens_s", "tflops", "peak_gb", "eager_peak_gb",
            "pool_gb", "forward_rel", "forward_ms", "backward_ms", "adamw_ms")
    out[cfg.name] = {k: run[k] for k in keep}
    del run, params, lbatch
    torch.cuda.empty_cache()

    # deepseek-moe-16b cut: timed steps, checks 2 and 4
    run = lm_full_width_run(*LMT_MOE, gen, smi, errors)
    launches += run["flash"]
    run.pop("trained")
    torch.cuda.empty_cache()
    out["moe_remat_rel"] = lm_remat_check(run["cfg"].name, run["cfg"], run["params"],
                                          run["batch"], errors)
    out[run["cfg"].name] = {k: run[k] for k in keep}
    del run
    torch.cuda.empty_cache()

    # the remaining families, 2 steps each
    for spec in LMT_FAMILIES:
        out[spec[0]] = lm_family_run(*spec, gen, smi, errors)
        torch.cuda.empty_cache()

    out["card_cpu_err"] = lm_card_against_cpu(errors)

    # check 7: the trainer's CLI in-process
    import shutil
    import tempfile

    from repro_torch.checkpoint.checkpointer import Checkpointer
    for argv in LMT_CLI:
        ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_lm_cli_")
        try:
            t1 = time.perf_counter()
            cli = train_mod.main(argv + ["--ckpt-dir", ckpt_dir])
            wall = time.perf_counter() - t1
            kept = Checkpointer(cli["ckpt_root"], device=DEV).all_steps()
            nbytes = sum(f.stat().st_size for f in Path(cli["ckpt_root"]).rglob("*.npy"))
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        steps = int(argv[argv.index("--steps") + 1]) if "--steps" in argv else 100
        log(f"[lm-train] repro_torch.launch.train {' '.join(argv)}: {wall:.1f}s, "
            f"losses {cli['losses']}; its step {cli['graphs']}; checkpoints at "
            f"steps {kept}, {nbytes / 1e9:.2f} GB on disk")
        if (int(cli["opt"]["step"]) != steps or kept[-1] != steps
                or not all(np.isfinite(l) for _, l in cli["losses"])):
            errors.append(f"the CLI {' '.join(argv)}: {cli['losses']}")
        if (cli["graphs"]["captured"], cli["graphs"]["replays"]) != (1, steps - 1):
            errors.append(f"the CLI {' '.join(argv)} did not run captured: "
                          f"{cli['graphs']}")
        del cli
        torch.cuda.empty_cache()

    by_variant = dict(ops.flash_attention.launches_by_variant)
    if ops.flash_attention.launches != launches or by_variant.get("wgmma") != launches:
        errors.append(f"flash launches {by_variant}, expected {launches} wgmma")
    log(f"[lm-train] flash launches on the path {ops.flash_attention.launches} "
        f"(expected {launches}), by variant {by_variant}; phase done in "
        f"{time.perf_counter() - t0:.1f}s ({smi})")
    if errors:
        raise AssertionError("language-model training: " + "; ".join(errors))
    return {"launches": launches, "seconds": time.perf_counter() - t0, **out}


class ServeCli:
    """``python -m repro_torch.launch.serve <argv>`` from this checkout,
    started in the background, its output in temporary files; ``check``
    waits for it and fails unless it exits 0 with ``expect`` in its
    output. The --mesh command lines spend most of their wall starting
    rank processes and staging Gloo collectives through the host, so the
    full run starts them beside phase 19's blocked references, where the
    host sits idle."""

    def __init__(self, tag: str, argv: list, expect: str, timeout_s: float):
        import tempfile
        self.tag, self.argv, self.expect = tag, argv, expect
        self.timeout_s = timeout_s
        self.out, self.err = (tempfile.TemporaryFile("w+") for _ in range(2))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", *argv],
            stdout=self.out, stderr=self.err, text=True, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def check(self, smi: str) -> None:
        left = self.timeout_s - (time.perf_counter() - self.t0)
        try:
            rc = self.proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            self.stop()
            rc = None
        wall = time.perf_counter() - self.t0
        self.out.seek(0)
        self.err.seek(0)
        out, err = self.out.read(), self.err.read()
        tail = ([ln for ln in out.splitlines() if ln.startswith("[fleet]")]
                or out.strip().splitlines()[-3:])
        log(f"{self.tag} CLI {' '.join(self.argv)}: exit {rc} in {wall:.1f}s; "
            f"{tail} ({smi})")
        if rc != 0 or self.expect not in out:
            raise AssertionError(f"{self.tag} CLI {' '.join(self.argv)} "
                                 f"failed:\n{out[-2000:]}\n{err[-3000:]}")


# ---------------------------------------------------------------------------
# Phase 14: sequence-parallel sampling across rank processes


# (name, mesh, ParallelSpec.attn): every rank on this card over Gloo
SP_RUNS = [("1x2", (1, 2), "ulysses"), ("1x4", (1, 4), "ulysses"),
           ("2x2", (2, 2), "ulysses"), ("1x3", (1, 3), "auto"),
           ("1x4-ring", (1, 4), "ring")]
# Ulysses runs each head's attention on the flash kernel as single-device
# does; its runs are held at SERVE_X0_TOL. The ring computes the same
# function with its float32 sums in another order (the reference's
# streaming softmax), and with bf16 activations over 28 layers x 10 DDIM
# steps any such change moves x0 by ~3e-3: the phase prints single-device
# with the kernel's keys visited in reverse order beside it. On an H100
# 80GB HBM3 (700 W) Ulysses read 0 to 5.2e-7, the ring 3.19e-3 to 3.83e-3,
# reversed keys 3.01e-3 / 3.81e-3 and the ring with its last hop skipped
# 9.02e-3 (PERF.md §6, PR 24): the ring's limit sits between.
SP_RING_X0_TOL = 6e-3
SP_N, SP_BUDGETS, SP_LABELS = 4, (0.6, 1.0), (207, 360, 387, 974)
SP_SEED, SP_DRAW_SEED, SP_T2I_SEED = SEED + 9, 4242, SEED + 10
# the runs that also serve a planted fault, its limit and what it is
SP_PLANTS = {"1x4": (SERVE_X0_TOL, "the Ulysses q/k/v sequence chunks "
                     "joined in reversed rank order"),
             "1x4-ring": (SP_RING_X0_TOL, "the ring's last hop skipped")}
# Ulysses and the ring per call at full width, on the seq meshes: one
# layer's q/k/v at DiT-XL/2's shape (the CFG-doubled batch of 4, 256
# tokens, padded to 258 on (1 x 3)) and at the text-to-image transformer's
# (4096 tokens); each planted fault must move the output by over
# SP_CALL_PLANT_MIN (relative)
SP_DIT_CALL, SP_T2I_CALL = (2 * SP_N, 256, 16, 72), (2, 4096, 16, 128)
SP_CALLS = {(1, 2): [("ulysses", SP_DIT_CALL)],
            (1, 3): [("ring", SP_DIT_CALL)],
            (1, 4): [("ulysses", SP_DIT_CALL), ("ring", SP_DIT_CALL),
                     ("ulysses", SP_T2I_CALL), ("ring", SP_T2I_CALL)]}
SP_RING_CALL_TOL, SP_CALL_PLANT_MIN = 1e-5, 0.1
SP_TIMEOUT_S = 420.0
# the Ulysses inner attention at sp 4: DiT-XL/2 (CFG-doubled batch of 4,
# 4 of 16 heads) and the text-to-image transformer (4 of 16 heads)
SP_ATTN = [(2 * SP_N, 256, 4, 72), (2 * SP_N, 64, 4, 72), (2, 4096, 4, 128)]
SP_CLI = ["--arch", "dit-xl-2", "--mesh", "1x2", "--dist-backend", "gloo",
          "--requests", "4", "--batch-slots", "2", "--T", str(T_STEPS),
          "--budget-levels", "0.6,1.0", "--attn-backend", "pallas"]
SP_SERVE_CLI = ("[sp]", SP_CLI, "served 4 requests", SP_TIMEOUT_S)


def sp_plan(b: float, attn=None, **kw) -> SamplingPlan:
    from repro_torch.distributed import ParallelSpec
    return SamplingPlan(T=T_STEPS, budget=b, attn_backend="pallas",
                        parallel=None if attn is None else ParallelSpec(attn=attn),
                        **kw)


@contextlib.contextmanager
def reversed_keys():
    """Single-device attention with the keys (and values) handed to the
    flash kernel in reverse order: the same function, its float32 sums in
    another order (unsegmented self-attention only)."""
    sound = ops.flash_attention

    def reverse(q, k, v, **kw):
        assert kw.get("segment_ids") is None, "unsegmented attention only"
        return sound(q, k.flip(1), v.flip(1), **kw)

    ops.flash_attention = reverse
    try:
        yield
    finally:
        ops.flash_attention = sound


@contextlib.contextmanager
def planted_fault(impl: str, sp: int):
    """Ulysses: the q/k/v sequence chunks the inbound all-to-all brings
    joined in reversed rank order (so every rank gets back another rank's
    tokens' outputs). Ring: the last hop of every attention skipped (the
    previous chunk accumulated twice, the last never seen; every rank
    skips the same calls)."""
    from repro_torch.distributed import attention as dist_attn
    name = "join_seq_chunks" if impl == "ulysses" else "rotate"
    sound = getattr(dist_attn, name)
    calls = itertools.count()

    def skip_last_hop(x, group, kind):
        if next(calls) % (3 * (sp - 1)) >= 3 * (sp - 2):
            return x
        return sound(x, group, kind)

    setattr(dist_attn, name, (lambda x: sound(x.flip(0))) if impl == "ulysses"
            else skip_last_hop)
    try:
        yield
    finally:
        setattr(dist_attn, name, sound)


def sp_timed(pipe, plan, n, device, **kw) -> dict:
    """One sample with its flash launches, collective bytes, runners built
    and wall (CUDA synchronised on both ends)."""
    from repro_torch.distributed import attention as dist_attn
    built = pipe.cache_stats()["compiled"]
    ops.reset_launches()
    dist_attn.reset_comm_bytes()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    res = pipe.sample(plan, n, torch.Generator(device=device).manual_seed(
        SP_DRAW_SEED), **kw)
    torch.cuda.synchronize(device)
    return {"wall": time.perf_counter() - t0,
            "x0": res.x0.float().cpu().numpy(), "flops": res.flops,
            "relative_compute": res.relative_compute,
            "launches": ops.flash_attention.launches,
            "by_variant": dict(ops.flash_attention.launches_by_variant),
            "bytes": dict(dist_attn.comm_bytes),
            "built": pipe.cache_stats()["compiled"] - built}


def sp_calls(device: torch.device, mesh, calls) -> dict:
    """Ulysses and the ring per call on this rank: one layer's q/k/v drawn
    whole from a shared seed (padded with segment -1 to a multiple of sp),
    this rank's slice through the collective, sound and planted, against
    this rank's rows of single-device attention on the whole inputs: the
    flash kernel for Ulysses (bf16, the kernel's tolerance), float32 plain
    attention for the ring (float32 inputs, SP_RING_CALL_TOL). Returns the
    squared norms the parent sums into errors over the gathered output."""
    import torch.distributed as dist
    from repro_torch.distributed import attention as dist_attn
    group = mesh.get_group("seq")
    sp, j = dist.get_world_size(group), mesh.get_local_rank("seq")
    out = {}
    for i, (impl, (B, N, H, hd)) in enumerate(calls):
        gen = torch.Generator(device=device).manual_seed(SP_SEED + 100 + i)
        pad = -N % sp
        q, k, v = (F.pad(torch.randn((B, N, H, hd), generator=gen,
                                     device=device), (0, 0, 0, 0, 0, pad))
                   for _ in range(3))
        seg = torch.zeros((B, N + pad), dtype=torch.int32, device=device)
        seg[:, N:] = -1
        n = (N + pad) // sp
        rows, real = slice(j * n, (j + 1) * n), min(n, N - j * n)
        if impl == "ulysses":
            q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
            want = ops.flash_attention(q, k, v, causal=False,
                                       segment_ids=seg)[:, rows]
            tol = TOL[torch.bfloat16]
        else:
            s = torch.einsum("bqhd,bkhd->bhqk", q[:, rows], k[:, :N])
            want = torch.einsum("bhqk,bkhd->bqhd",
                                (s / hd ** 0.5).softmax(-1), v[:, :N])
            tol = SP_RING_CALL_TOL
            del s
        want = want[:, :real].float()
        loc = [x[:, rows].contiguous() for x in (q, k, v)]
        kw = dict(group=group, segment_ids=seg[:, rows].contiguous(),
                  attn_backend="pallas")
        fn = dist_attn.ATTN_FNS[impl]
        got = fn(*loc, **kw)[:, :real].float()
        with planted_fault(impl, sp):
            planted = fn(*loc, **kw)[:, :real].float()
        diff = (got - want).abs()
        out[f"{impl} B{B} N{N} H{H} hd{hd}"] = dict(
            tol=tol, max_abs_err=diff.max().item(),
            ok=bool((diff <= tol + tol * want.abs()).all()),
            err2=(got - want).norm().item() ** 2,
            planted2=(planted - want).norm().item() ** 2,
            ref2=want.norm().item() ** 2)
    return out


def sp_rank(rank: int, device: torch.device, state: dict, runs,
            t2i: bool) -> dict:
    """One rank of phase 14, a ``RankGroup`` call (spawned ranks import
    this file by path; ``state`` is unused: one call a group). Every
    rank builds the meshes in the same order, the same weights from the
    same seed, and samples every run."""
    from repro_torch.launch.mesh import make_inference_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    meshes = {}
    for _, shape, _ in runs:
        if shape not in meshes:
            meshes[shape] = make_inference_mesh(*shape, device=device,
                                                backend="gloo")
    params, cfg = trained_like_xl(torch.Generator(device=device)
                                  .manual_seed(SP_SEED))
    pipe = FlexiPipeline(params, cfg, linear_schedule(1000), device=device)
    del params
    cond = torch.tensor(SP_LABELS, device=device)
    out = {"runs": {}}
    for name, shape, attn in runs:
        pipe.set_mesh(meshes[shape])
        got = {b: sp_timed(pipe, sp_plan(b, attn), SP_N, device, cond=cond)
               for b in SP_BUDGETS}
        # a budget switch back on the fixed mesh, timed warm
        got["again"] = sp_timed(pipe, sp_plan(SP_BUDGETS[0], attn), SP_N,
                                device, cond=cond)
        if name in SP_PLANTS:
            with planted_fault(attn, shape[1]):
                got["planted"] = sp_timed(pipe, sp_plan(SP_BUDGETS[0], attn),
                                          SP_N, device, cond=cond)
        out["runs"][name] = got
    del pipe
    torch.cuda.empty_cache()
    out["calls"] = {shape: sp_calls(device, mesh, SP_CALLS[shape])
                    for shape, mesh in meshes.items() if shape in SP_CALLS}
    torch.cuda.empty_cache()
    if t2i:
        gen = torch.Generator(device=device).manual_seed(SP_T2I_SEED)
        params, cfg = trained_like_t2i(gen)
        text = randn(gen, (1, cfg.dit.text_len, cfg.dit.text_dim))
        x_T = randn(gen, (1,) + tuple(cfg.dit.latent_shape))
        pipe = FlexiPipeline(params, cfg, linear_schedule(1000), device=device,
                             mesh=meshes[(1, 4)])
        del params
        out["t2i"] = sp_timed(pipe, sp_plan(T2I_BUDGETS[0], "ulysses",
                                            solver="flow_euler",
                                            guidance_scale=0.0),
                              1, device, cond=text, x_T=x_T)
        del pipe
        torch.cuda.empty_cache()
    return out


def sp_kernel_shapes(gen: torch.Generator, smi: str) -> dict:
    """The flash kernel at the Ulysses inner shapes: against its plain
    version (the DiT shapes at TOL, the 4096-token one on its own scale),
    then timed in interleaved rounds with the mma kernel and SDPA."""
    out = {}
    for B, S, H, hd in SP_ATTN:
        q, k, v = (randn(gen, (B, S, H, hd), torch.bfloat16) for _ in range(3))
        seg = torch.zeros((B, S), dtype=torch.int32, device=DEV)
        kw = ops.kernel_kwargs(q, k, causal=False, segment_ids=seg)
        got = flash_attention_cuda(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        if S > 1024:
            err = rel_err(got, want)
            if not err <= T2I_ATTN_REL_TOL:
                raise AssertionError(f"flash B{B} S{S} H{H} hd{hd}: "
                                     f"||o - ref|| / ||ref|| {err:.3e}")
        else:
            err = check(f"flash B{B} S{S} H{H} hd{hd}", got, want,
                        TOL[torch.bfloat16])
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        big = S > 1024
        t = interleaved_ms({
            "wgmma": lambda: flash_attention_cuda(q, k, v, **kw, variant="wgmma"),
            "mma": lambda: flash_attention_cuda(q, k, v, **kw, variant="mma"),
            "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt)},
            **(dict(calls=5, replays=4) if big else {}))
        plain = graph_ms(lambda: flash_attention_ref(q, k, v, **kw),
                         **(dict(calls=2, replays=2) if big else {}))
        bound, by = attention_bound_ms(B, S, H, hd, torch.bfloat16)
        ms = t["wgmma"]["ms"]
        log(f"[sp-kernel] flash B{B} S{S} H{H} hd{hd} bf16 (Ulysses inner, "
            f"sp 4): vs plain {err:.3e}; {turns_line(t)}; plain {plain:.4f} "
            f"ms; bound {bound:.4f} ms ({by}); {bound / ms:.1%} of the bound, "
            f"{t['sdpa']['ms'] / ms:.2f}x sdpa's speed ({smi})")
        out[f"B{B} S{S} H{H} hd{hd}"] = dict(
            ms=ms, prev_ms=t["mma"]["ms"], plain_ms=plain,
            library_ms=t["sdpa"]["ms"], bound_ms=bound, bound_by=by,
            max_abs_err=(got.float() - want.float()).abs().max().item())
    return out


def phase_seq_parallel(smi: str) -> dict:
    from repro_torch.distributed import plan_partition
    from repro_torch.launch.mesh import RankGroup
    t0 = time.perf_counter()
    build.build_all()        # every kernel built before any rank starts
    shapes = sp_kernel_shapes(torch.Generator(device=DEV).manual_seed(SP_SEED),
                              smi)
    # the single-device references, with this process's flash kernel
    params, cfg = trained_like_xl(torch.Generator(device=DEV).manual_seed(SP_SEED))
    pipe = FlexiPipeline(params, cfg, linear_schedule(1000), device=DEV)
    del params
    cond = torch.tensor(SP_LABELS, device=DEV)
    ref = {b: sp_timed(pipe, sp_plan(b), SP_N, DEV, cond=cond)
           for b in SP_BUDGETS}
    ref_warm = sp_timed(pipe, sp_plan(SP_BUDGETS[0]), SP_N, DEV, cond=cond)
    with reversed_keys():
        rev = {b: sp_timed(pipe, sp_plan(b), SP_N, DEV, cond=cond)
               for b in SP_BUDGETS}
    for b in SP_BUDGETS:
        log(f"[sp] single-device budget {b}, the kernel's keys visited in "
            f"reverse order: ||x0 - single|| / ||single|| "
            f"{rel_err(torch.from_numpy(rev[b]['x0']), torch.from_numpy(ref[b]['x0'])):.3e}"
            f" (the same function, float32 sums in another order; {smi})")
    schedules = {b: sp_plan(b).resolve_schedule(cfg) for b in SP_BUDGETS}
    del pipe
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEV).manual_seed(SP_T2I_SEED)
    tparams, tcfg = trained_like_t2i(gen)
    text = randn(gen, (1, tcfg.dit.text_len, tcfg.dit.text_dim))
    x_T = randn(gen, (1,) + tuple(tcfg.dit.latent_shape))
    tpipe = FlexiPipeline(tparams, tcfg, linear_schedule(1000), device=DEV)
    del tparams
    t2i_plan = sp_plan(T2I_BUDGETS[0], solver="flow_euler", guidance_scale=0.0)
    t2i_ref = sp_timed(tpipe, t2i_plan, 1, DEV, cond=text, x_T=x_T)
    del tpipe
    torch.cuda.empty_cache()
    log(f"[sp] single-device references in {time.perf_counter() - t0:.1f}s "
        f"({smi})")

    # the 2- and 3-rank groups run side by side on this card, then the
    # 4-rank group alone: their checks do not depend on each other, and a
    # small group spends most of its wall starting its ranks
    groups, calls = {}, {}
    for wave in (((2, SP_RUNS[:1]), (3, SP_RUNS[3:4])),
                 ((4, [SP_RUNS[1], SP_RUNS[2], SP_RUNS[4]]),)):
        t1, started = time.perf_counter(), []
        try:
            for world, runs in wave:
                group = RankGroup(world, backend="gloo", device="cuda",
                                  timeout_s=SP_TIMEOUT_S)
                group.submit(sp_rank, runs, world == 4)
                started.append((group, world, runs))
            for group, world, runs in started:
                res = group.collect()
                log(f"[sp] {world} ranks ({', '.join(r[0] for r in runs)}) "
                    f"done in {time.perf_counter() - t1:.1f}s"
                    + (" (beside the other small group)" if len(wave) > 1
                       else "") + f" ({smi})")
                for name, *_ in runs:
                    groups[name] = [r["runs"][name] for r in res]
                for shape in res[0]["calls"]:
                    calls[shape] = [r["calls"][shape] for r in res]
                if world == 4:
                    t2i_ranks = [r["t2i"] for r in res]
        finally:
            for group, *_ in started:
                group.close()

    errors, launches = [], 0
    for name, (d_sz, s_sz), attn in SP_RUNS:
        ranks = groups[name]
        for b in SP_BUDGETS + ("again",):
            bb = SP_BUDGETS[0] if b == "again" else b
            plan = sp_plan(bb, attn)
            part = plan_partition(cfg, schedules[bb], s_sz, plan.parallel)
            impl = part.phases[0][0].impl
            tol = SERVE_X0_TOL if impl == "ulysses" else SP_RING_X0_TOL
            fwd = forward_calls(plan, cfg)
            want_bytes = SP_N * part.collective_bytes(
                cfg, cfg_scale_active=plan.guidance_active)
            kind = "qkvo" if impl == "ulysses" else "kv"
            sent = sum(r[b]["bytes"].get(kind, 0) for r in ranks)
            errs = [rel_err(torch.from_numpy(r[b]["x0"]),
                            torch.from_numpy(ref[bb]["x0"])) for r in ranks]
            per_rank = [r[b]["launches"] for r in ranks]
            want_l = cfg.num_layers * fwd if impl == "ulysses" else 0
            if not all(e <= tol for e in errs):
                errors.append(f"{name} {b}: x0 vs single-device {errs}")
            if per_rank != [want_l] * len(ranks) or any(
                    r[b]["by_variant"]["wgmma"] != want_l for r in ranks):
                errors.append(f"{name} {b}: flash launches {per_rank}, "
                              f"expected {want_l} a rank, all wgmma")
            if sent != want_bytes:
                errors.append(f"{name} {b}: {kind} bytes {sent} != ledger "
                              f"{want_bytes}")
            if any(r[b]["flops"] != ref[bb]["flops"] or r[b]["relative_compute"]
                   != ref[bb]["relative_compute"] for r in ranks):
                errors.append(f"{name} {b}: flops / relative compute differ")
            if b == "again" and any(r[b]["built"] for r in ranks):
                errors.append(f"{name}: the budget switch built runners")
            launches += sum(per_rank)
            other = {k: sum(r[b]["bytes"].get(k, 0) for r in ranks)
                     for k in ("segment_ids", "tokens", "x0")}
            wall = max(r[b]["wall"] for r in ranks)
            ref_wall = (ref_warm if b == "again" else ref[bb])["wall"]
            log(f"[sp] {name} {impl} budget {bb}{' (switch back)' if b == 'again' else ''}"
                f": pad {[p.pad for p, n in part.phases if n]}, ||x0 - "
                f"single|| / ||single|| max {max(errs):.3e} (tol {tol}); "
                f"flash launches a rank {per_rank[0]} = "
                f"{cfg.num_layers} x {fwd} forwards"
                f"{'' if want_l else ' (the ring: none)'}; {kind} bytes over ranks "
                f"{sent} == {SP_N} x ledger {want_bytes / SP_N:.0f}; beside "
                f"them {other}; built {max(r[b]['built'] for r in ranks)}; wall "
                f"{wall / SP_N * 1e3:.1f} ms a sample vs single-device "
                f"{ref_wall / SP_N * 1e3:.1f} ms ({smi}; ranks share this "
                f"card and Gloo stages every collective through the host: "
                f"the mechanism's price, not scaling)")
    ring, uly = groups["1x4-ring"], groups["1x4"]
    for b in SP_BUDGETS:
        e = max(rel_err(torch.from_numpy(r[b]["x0"]), torch.from_numpy(u[b]["x0"]))
                for r, u in zip(ring, uly))
        log(f"[sp] ring vs Ulysses on (1 x 4), budget {b}: {e:.3e} (tol "
            f"{SP_RING_X0_TOL}; {smi})")
        if not e <= SP_RING_X0_TOL:
            errors.append(f"ring vs ulysses {b}: {e}")
    for (d_sz, s_sz), ranks in calls.items():
        for key in ranks[0]:
            rs = [r[key] for r in ranks]
            ref2 = sum(r["ref2"] for r in rs)
            err = (sum(r["err2"] for r in rs) / ref2) ** 0.5
            planted = (sum(r["planted2"] for r in rs) / ref2) ** 0.5
            against = ("single-device flash" if key.startswith("ulysses")
                       else "float32 plain attention")
            log(f"[sp-call] {key} on ({d_sz} x {s_sz}), gathered against "
                f"{against}: max|err| {max(r['max_abs_err'] for r in rs):.3e}"
                f" (tol {rs[0]['tol']} abs + rel), ||o - ref|| / ||ref|| "
                f"{err:.3e}; planted fault {planted:.3e} (must exceed "
                f"{SP_CALL_PLANT_MIN}; {smi})")
            if not all(r["ok"] for r in rs):
                errors.append(f"{key} on ({d_sz} x {s_sz}) per call: "
                              f"{[r['max_abs_err'] for r in rs]}")
            if not planted > SP_CALL_PLANT_MIN:
                errors.append(f"planted {key} on ({d_sz} x {s_sz}) per call "
                              f"read {planted}")
    for name, (tol, what) in SP_PLANTS.items():
        planted = [rel_err(torch.from_numpy(r["planted"]["x0"]),
                           torch.from_numpy(ref[SP_BUDGETS[0]]["x0"]))
                   for r in groups[name]]
        log(f"[sp] planted fault on {name} ({what}): {min(planted):.3e} (must "
            f"exceed {tol}; {smi})")
        if not min(planted) > tol:
            errors.append(f"planted fault on {name} read {planted}")

    t2i_errs = [rel_err(torch.from_numpy(r["x0"]), torch.from_numpy(t2i_ref["x0"]))
                for r in t2i_ranks]
    nfe = T_STEPS
    t2i_part = plan_partition(tcfg, t2i_plan.resolve_schedule(tcfg), 4,
                              sp_plan(T2I_BUDGETS[0], "ulysses").parallel)
    t2i_bytes = sum(r["bytes"].get("qkvo", 0) for r in t2i_ranks)
    t2i_launch = [r["launches"] for r in t2i_ranks]
    log(f"[sp] t2i {tcfg.num_layers}L d={tcfg.d_model} "
        f"{dit_mod.tokens_for_mode(tcfg, 0)} tokens flow_euler budget "
        f"{T2I_BUDGETS[0]} on (1 x 4) Ulysses: ||x0 - single|| / ||single|| "
        f"max {max(t2i_errs):.3e} (tol {SERVE_X0_TOL}); flash launches a rank "
        f"{t2i_launch[0]} = {tcfg.num_layers} x {nfe} NFEs; qkvo bytes "
        f"{t2i_bytes} (ledger {t2i_part.collective_bytes(tcfg, cfg_scale_active=False):.0f});"
        f" wall {max(r['wall'] for r in t2i_ranks):.2f} s a sample vs "
        f"single-device {t2i_ref['wall']:.2f} s ({smi})")
    if not max(t2i_errs) <= SERVE_X0_TOL:
        errors.append(f"t2i x0 vs single-device {t2i_errs}")
    if t2i_launch != [tcfg.num_layers * nfe] * 4 or any(
            r["by_variant"]["wgmma"] != tcfg.num_layers * nfe for r in t2i_ranks):
        errors.append(f"t2i flash launches {t2i_launch}")
    if t2i_bytes != t2i_part.collective_bytes(tcfg, cfg_scale_active=False):
        errors.append(f"t2i bytes {t2i_bytes}")
    launches += sum(t2i_launch)

    if errors:
        raise AssertionError("phase 14: " + "; ".join(errors))
    secs = time.perf_counter() - t0
    log(f"[sp] phase 14 in {secs:.1f}s ({smi})")
    return {"launches": launches, "shapes": shapes, "seconds": secs}


# ---------------------------------------------------------------------------
# Phase 15: sharded training over a ("data", "model") mesh of rank processes


# one rank group of ST_WORLD ranks on this card over Gloo, mesh (2 x 2)
ST_WORLD, ST_MESH = 4, (2, 2)
ST_SEED, ST_DRAW_SEED, ST_PSUM_SEED = SEED + 11, 5151, SEED + 12
# DiT-XL/2 (phase 3's weights recipe, bf16) at phase 9's batch, profile
# fsdp2d forced ('auto' resolves to dp below 3e9 parameters): 2 steps at
# mode 1, then 2 at mode 0 (the elastic step 2 runs at mode 1 on 2 ranks,
# each holding all 32 rows: at mode 0 two such ranks would need ~2 x 35
# GB, phase 9's single-device peak), lr large enough that an update spans
# several bf16 ulps of a weight
ST_DIT_B, ST_DIT_LR, ST_MODES = TRAIN_BATCH, 1e-3, (1, 1, 0, 0)
# ... cut to 14 of its 28 layers: a rank's step is mostly the Gloo
# gathers and reduce-scatters of the layers' parameters, and the cut
# keeps the script within its time limit beside phase 19. The readings
# barely move with it: the worst gradient leaf 3.1e-3 at 28 layers, 3.0e-3
# at 14, against ST_GRAD_TOL; the planted DiT faults 0.41 / 0.68 and 0.40
# / 0.68 (PERF.md §6, PRs 25 and 31)
ST_DIT_LAYERS = 14
# gemma2-9b at full width cut to one local (window 4096) and one global
# layer, sequence parallel; deepseek-moe-16b at full width cut to 2
# layers; B x S tokens each, one step. The MoE batch's second row is one
# token repeated: its rank routes unlike the first's, so a load balance
# taken per rank reads as the fault it is (over ST_AUX_TOL)
ST_LMS = [("gemma2-9b", 2, "fsdp2d_sp", dict(sequence_parallel=True,
                                              remat="block")),
          ("deepseek-moe-16b", 2, "fsdp2d", {})]
ST_LM_B, ST_LM_S, ST_LM_LR = 2, 2048, 1e-4
ST_PSUM_N = 64 * 2**20
# limits, fixed before the first card run (PERF.md §6, PR 25). Both sides
# are bf16 here (phase 13's LMT_GRAD_TOL, 0.1, holds bf16 against
# float32): each data rank rounds its half of a gradient sum to bf16
# before the float32 sum over ranks, and GEMMs of half the rows may take
# other cuBLAS algorithms, so a leaf moves by a few bf16 roundings (2^-9)
ST_GRAD_TOL = 3e-2
# the MoE aux losses: a few top-1 choices near a tie may flip
ST_AUX_TOL = 1e-2
# step 2 on the (1 x 2) sub-mesh against the uninterrupted (2 x 2) step 2,
# as ||dp - dp_ref|| / ||dp_ref||: an update of ~lr per element is ~8 bf16
# ulps of a 0.03 weight, and an update that differs in its last bits
# rounds to another ulp now and then
ST_UPDATE_TOL = 0.1
ST_TIMEOUT_S = 900.0

# phase 16: the planner. Phase 15's resident parameter + moment bytes a
# rank on (2 x 2), as its ranks measure them (PERF.md §6): its DiT-XL/2
# cut to ST_DIT_LAYERS (the whole 28 layers read 1,692,272,000, PR 25)
PLAN_BYTES = {"dit": 855_309_440, "gemma2-9b": 3_284_825_600,
              "deepseek-moe-16b": 3_988_572_160}
PLAN_B, PLAN_REPS = 8, 20
# the card's count (GEMMs + flash ledger) against the planner's meta count
PLAN_FLOPS_TOL = 1e-3


def st_flat(tree, prefix: str = "") -> dict:
    """{'a__b': leaf} in the reference's key order (the checkpoint's names)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(st_flat(tree[k], f"{prefix}__{k}" if prefix else k))
    return out


def st_dit_setup(device):
    """DiT-XL/2's weights, batch and the 4 steps' draws of the whole
    batch, the same in every process (seeds on this card)."""
    from repro_torch.launch.steps import draw_t_noise
    params, cfg = trained_like_xl(torch.Generator(device=device).manual_seed(ST_SEED),
                                  ST_DIT_LAYERS)
    batch = train_batch(cfg, ST_DIT_B, SEED)
    x0 = batch["x0"].to(torch.bfloat16)
    draws = []
    for i in range(4):
        t, noise = draw_t_noise(x0, 1000, torch.Generator(device=device)
                                .manual_seed(ST_DRAW_SEED + i))
        draws.append({"t": t, "noise": noise})
    return params, cfg, batch, draws


def st_dit_steps(cfg):
    """The train steps at modes 0 and 1 (constant lr)."""
    from repro_torch.configs.base import TrainConfig
    tc = TrainConfig(learning_rate=ST_DIT_LR, warmup_steps=0, total_steps=1000,
                     schedule="constant")
    return {m: lm_steps.make_dit_train_step(cfg, tc, linear_schedule(1000),
                                            mode=m) for m in (0, 1)}


def st_lm_setup(name, keep, over, device):
    """The cut config (with ``over``), its weights and batch."""
    from repro_torch.configs.base import TrainConfig
    _, cfg = lm_cut(name, keep)
    cfg = dataclasses.replace(cfg, **over)
    gen = torch.Generator(device=device).manual_seed(ST_SEED + keep + len(name))
    params = lm_mod.init_params(cfg, gen)
    batch = lm_train_batch(cfg, ST_LM_B, ST_LM_S, SEED, gen)
    if cfg.moe is not None:
        batch["tokens"][1] = batch["tokens"][1, 0]
    tc = TrainConfig(learning_rate=ST_LM_LR, warmup_steps=0, schedule="constant")
    return cfg, params, batch, lm_steps.make_train_step(cfg, tc)


def st_references(tmp: Path) -> dict:
    """This process's single-device steps: the first DiT step's and each LM
    step's loss, metrics and gradients (the gradients to files the ranks
    read their chunks of), and the walls of 4 single-device DiT steps
    (captured: each mode's first step runs eagerly, then captures)."""
    from repro_torch.optim import adamw
    refs = {}
    params, cfg, batch, draws = st_dit_setup(DEV)
    steps = st_dit_steps(cfg)
    (loss, _), g = steps[ST_MODES[0]].grads(params, batch, **draws[0])
    torch.save({k: v.cpu() for k, v in st_flat(g).items()}, tmp / "dit.pt")
    refs["dit"] = {"loss": float(loss), "grad_norm": float(adamw.global_norm(g))}
    del g
    p, o, walls = params, adamw.init_opt_state(params), []
    for i, mode in enumerate(ST_MODES):
        (p, o, _), wall = st_timed(lambda: steps[mode].with_draws(
            p, o, batch, **draws[i]))
        walls.append(wall)
    refs["dit_walls"] = walls
    refs["dit_peak"] = torch.cuda.max_memory_allocated()
    del params, p, o, steps     # the steps' graphs and pools with them
    torch.cuda.empty_cache()
    for name, keep, _, over in ST_LMS:
        torch.cuda.reset_peak_memory_stats()
        cfg, params, batch, step = st_lm_setup(name, keep, over, DEV)
        ((loss, m), g), wall = st_timed(lambda: step.grads(params, batch))
        torch.save({k: v.cpu() for k, v in st_flat(g).items()}, tmp / f"{name}.pt")
        refs[name] = {"loss": float(loss), "wall": wall,
                      "metrics": {k: float(v) for k, v in m.items()},
                      "peak": torch.cuda.max_memory_allocated()}
        del params, g
        torch.cuda.empty_cache()
    return refs


@contextlib.contextmanager
def st_planted(name: str):
    """The planted faults of phase 15: ``norm_local`` (``global_norm`` over
    each rank's chunks only), ``unsummed`` (a data-axis gradient left
    unsummed), ``sp_sum`` (the sequence-parallel gather's backward a sum
    over 'model'), ``lb_per_rank`` (``load_balance`` from each rank's own
    means)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from repro_torch.models import moe
    from repro_torch.runtime import placement as plc
    from repro_torch.runtime import sharding as shd

    def sp_sum(g, dim, group, rank, n):
        gt = g.movedim(dim, 0).contiguous()
        out = torch.empty((gt.shape[0] // n,) + tuple(gt.shape[1:]),
                          dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, gt, group=group)
        return out.movedim(0, dim)

    def unsummed(g, p, group, n):
        if isinstance(p, Shard):
            c = g.shape[p.dim] // n
            return g.narrow(p.dim, dist.get_rank(group) * c, c)
        return g

    mod, attr, fn = {
        "norm_local": (plc, "sum_over_shards", lambda values, leaves: values),
        "unsummed": (plc, "_reduce_data", unsummed),
        "sp_sum": (shd, "_gather_grad", sp_sum),
        "lb_per_rank": (moe, "_load_balance",
                        lambda me, ce, E: shd.data_mean(E * torch.sum(me * ce)))}[name]
    sound = getattr(mod, attr)
    setattr(mod, attr, fn)
    try:
        yield
    finally:
        setattr(mod, attr, sound)


def st_grad_rels(grads, ref_path: Path, device) -> dict:
    """Each gradient leaf's ||g - ref|| / ||ref|| over the whole leaf: every
    rank sums the squares of its chunk's error and of the reference's
    chunk (read from the memory-mapped file), summed over the mesh dims
    the leaf is sharded on."""
    from repro_torch.runtime import placement as plc
    ref = torch.load(ref_path, mmap=True)
    flat = st_flat(grads)
    d2, r2 = [], []
    for k, g in flat.items():
        want = ref[k][plc.chunk_slices(g.shape, g.device_mesh, g.placements)]
        want = want.to(device).float()
        d2.append((g.to_local().float() - want).square().sum())
        r2.append(want.square().sum())
    leaves = list(flat.values())
    d2, r2 = plc.sum_over_shards(d2, leaves), plc.sum_over_shards(r2, leaves)
    return {k: (a / b.clamp_min(1e-30)).sqrt().item()
            for k, a, b in zip(flat, d2, r2)}


def st_place(cfg, params, mesh, profile):
    """``params`` placed on ``mesh`` by the profile's rules, and this
    rank's spec arithmetic: (placed, parameter bytes, moment bytes)."""
    from repro_torch.models.common import spec_tree
    from repro_torch.runtime import placement as plc
    from repro_torch.runtime import sharding as shd
    schema = (dit_mod.dit_schema(cfg) if cfg.family == "dit"
              else lm_mod.lm_schema(cfg))
    sizes = shd.axis_sizes(mesh)
    specs = spec_tree(schema, shd.rules_for(cfg, mesh, profile), sizes)
    elems = sum(int(np.prod(plc.shard_shape(s.shape, sp, sizes)))
                for s, sp in zip(tree_leaves(schema), tree_leaves(specs)))
    placed = plc.place_tree(params, shd.shard_tree(mesh, specs))
    size = tree_leaves(params)[0].element_size()
    return placed, elems * size, elems * 2 * 4     # float32 m and v


def st_timed(fn):
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t1


def st_dit_rank(rank, mesh, tmp: Path, device) -> dict:
    """DiT-XL/2 on (2 x 2): placement bytes; the first step's gradients
    against single-device, then AdamW on them; two planted faults; steps
    2-4; the checkpoint after step 1, written while the LM cases run.
    Returns its readings and what ``st_elastic_rank`` needs."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.optim import adamw
    from repro_torch.runtime import placement as plc
    params, cfg, batch, draws = st_dit_setup(device)
    steps = st_dit_steps(cfg)
    p0, want_p, want_m = st_place(cfg, params, mesh, "fsdp2d")
    del params
    o0 = adamw.init_opt_state(p0)
    out = {"bytes": (plc.resident_bytes(p0), plc.resident_bytes(
        {"m": o0["m"], "v": o0["v"]}), want_p, want_m)}
    torch.cuda.reset_peak_memory_stats()
    first = steps[ST_MODES[0]]
    ((loss, _), g), wall = st_timed(lambda: first.grads(p0, batch, **draws[0]))
    out.update(loss=float(loss), grads_wall=wall,
               rels=st_grad_rels(g, tmp / "dit.pt", device),
               grad_norm=float(adamw.global_norm(g)))
    with st_planted("norm_local"):
        out["norm_local"] = float(adamw.global_norm(g))
    # AdamW writes its trees in place: p0 stays as drawn for the planted
    # fault below
    p = tree_map(torch.clone, p0)
    (p, o, _), wall = st_timed(lambda: adamw.adamw_update(p, g, o0, first.tc))
    del g
    torch.cuda.empty_cache()     # the ranks share the card: hand back the cache
    walls = [out["grads_wall"] + wall]
    with st_planted("unsummed"):
        _, g = first.grads(p0, batch, **draws[0])
    out["unsummed"] = max(st_grad_rels(g, tmp / "dit.pt", device).values())
    del g, p0, o0
    torch.cuda.empty_cache()
    ck = Checkpointer(tmp / "ckpt", device=device)     # written while steps run
    (_, out["save_s"]) = st_timed(lambda: ck.save(1, {"params": p, "opt": o}))
    full = tree_map(plc.gather_full, p)                # every rank gathers
    mem = tree_map(lambda x: x.cpu(), full) if rank == 0 else None
    del full
    p1 = tree_map(torch.clone, p)      # step 1's: the steps below write p
    losses = [float(loss)]
    for i in range(1, 4):
        (p, o, m), wall = st_timed(lambda: steps[ST_MODES[i]].with_draws(
            p, o, batch, **draws[i]))
        walls.append(wall)
        losses.append(float(m["loss"]))
        if i == 1:       # the uninterrupted update of step 2, on rank 0's host
            d_ref = []
            for a, b in zip(tree_leaves(p), tree_leaves(p1)):
                d = plc.gather_full(a).float() - plc.gather_full(b).float()
                if rank == 0:
                    d_ref.append(d.cpu())
            del p1, d
    out.update(walls=walls, losses=losses, peak=torch.cuda.max_memory_allocated(),
               finite=all(bool(torch.isfinite(plc.local(x)).all())
                          for x in tree_leaves(p)))
    del p, o
    torch.cuda.empty_cache()
    # the elastic restore runs last (st_elastic_rank): rank 0 writes the
    # checkpoint meanwhile
    later = dict(ck=ck, cfg=cfg, step=steps[ST_MODES[1]], batch=batch,
                 draws=draws[1], d_ref=d_ref)
    return out, later, mem


def st_elastic_rank(rank, device, ck, cfg, step, batch, draws, d_ref) -> dict:
    """The checkpoint after step 1, restored by ``elastic_restore`` onto
    ``make_elastic_mesh(2, 2)`` (ranks 0-1), step 2 taken there and
    compared with the uninterrupted step 2 as an update (rank 0)."""
    import torch.distributed as dist

    from repro_torch.runtime import elastic
    from repro_torch.runtime import placement as plc
    (_, wait_s) = st_timed(ck.wait)
    sub = elastic.make_elastic_mesh(2, model_parallel=2, device=device.type)
    out = {"wait_s": wait_s}
    if sub.get_coordinate() is not None:
        (state, _), restore_s = st_timed(lambda: elastic.elastic_restore(
            ck, cfg, sub, profile="fsdp2d", device=device))
        restored = tree_map(torch.clone, state["params"])  # the step writes them
        (p2, _, _), wall = st_timed(lambda: step.with_draws(
            state["params"], state["opt"], batch, **draws))
        num = den = 0.0
        for i, (a, b) in enumerate(zip(tree_leaves(p2), tree_leaves(restored))):
            d = plc.gather_full(a).float() - plc.gather_full(b).float()
            if rank == 0:
                ref = d_ref[i].to(device)
                num += float((d - ref).square().sum())
                den += float(ref.square().sum())
        out.update(update_rel=(num / max(den, 1e-30)) ** 0.5, wall=wall,
                   restore_s=restore_s, sub=tuple(sub.mesh.shape))
    dist.barrier()       # ranks 2-3 wait for 0-1's sub-mesh
    return out


def st_lm_rank(rank, mesh, tmp: Path, device, name, keep, profile, over) -> dict:
    """One LM cut on (2 x 2): the step's gradients and metrics against
    single-device, then AdamW on them; its planted fault."""
    from repro_torch.optim import adamw
    from repro_torch.runtime import placement as plc
    from repro_torch.runtime import sharding as shd
    torch.cuda.reset_peak_memory_stats()
    cfg, params, batch, step = st_lm_setup(name, keep, over, device)
    p0, want_p, want_m = st_place(cfg, params, mesh, profile)
    del params
    torch.cuda.empty_cache()
    o0 = adamw.init_opt_state(p0)
    out = {"bytes": (plc.resident_bytes(p0), plc.resident_bytes(
        {"m": o0["m"], "v": o0["v"]}), want_p, want_m)}
    ((loss, m), g), wall = st_timed(lambda: step.grads(p0, batch))
    out.update(loss=float(loss), grads_wall=wall,
               metrics={k: float(v) for k, v in m.items()},
               rels=st_grad_rels(g, tmp / f"{name}.pt", device))
    p1 = tree_map(torch.clone, p0)   # written in place; p0 kept for the fault
    (p1, _, m), wall = st_timed(lambda: adamw.adamw_update(p1, g, o0, step.tc))
    out.update(adamw_wall=wall, finite=all(bool(torch.isfinite(plc.local(x)).all())
                                           for x in tree_leaves(p1)))
    del g, p1
    torch.cuda.empty_cache()     # the ranks share the card: hand back the cache
    if cfg.sequence_parallel:        # a gradient fault: forward and backward
        with st_planted("sp_sum"):
            _, g = step.grads(p0, batch)
        out["sp_sum"] = max(st_grad_rels(g, tmp / f"{name}.pt", device).values())
        del g
    else:                            # a loss fault: the forward alone
        with st_planted("lb_per_rank"), torch.no_grad(), shd.use_mesh(mesh):
            view = plc.gathered(tree_map(plc.local, p0), p0, step.stacked)
            _, fm = lm_mod.lm_loss(view, plc.take_rows(batch, ST_LM_B, mesh), cfg)
        out["lb_per_rank"] = float(fm["load_balance"])
    out["peak"] = torch.cuda.max_memory_allocated()
    return out


def st_psum_rank(rank, mesh, device) -> dict:
    """``compressed_psum`` of a ST_PSUM_N-element float32 gradient over the
    4 ranks, against the reference formula on the host from the gathered
    inputs (rank 0), bit for bit."""
    import hashlib

    import torch.distributed as dist
    from repro_torch.optim.compression import compressed_psum
    g = torch.randn(ST_PSUM_N, device=device, generator=torch.Generator(
        device=device).manual_seed(ST_PSUM_SEED + rank))
    got, wall = st_timed(lambda: compressed_psum(g, ("data", "model"), mesh))
    inputs = [torch.empty_like(g) for _ in range(ST_WORLD)]
    dist.all_gather(inputs, g)
    out = {"wall": wall, "sha": hashlib.sha1(got.cpu().numpy().tobytes()).hexdigest()}
    if rank == 0:
        G = np.stack([x.cpu().numpy() for x in inputs])
        scale = np.maximum(np.abs(G).max(), np.float32(1e-12)) / np.float32(127.0)
        q = np.clip(np.round(G / scale), -127, 127).astype(np.int32)
        want = (q.sum(0, dtype=np.int32).astype(np.float32) * scale).astype(np.float32)
        out["equal"] = bool(np.array_equal(got.cpu().numpy(), want))
    return out


def st_rank(rank: int, device: torch.device, tmp: str) -> dict:
    """One rank of phase 15 (spawned ranks import this file by path)."""
    from repro_torch.launch.mesh import make_debug_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = Path(tmp)
    mesh = make_debug_mesh(*ST_MESH, device=device, backend="gloo")
    dit, later, mem = st_dit_rank(rank, mesh, tmp, device)
    out = {"dit": dit}
    torch.cuda.empty_cache()
    for name, keep, profile, over in ST_LMS:
        out[name] = st_lm_rank(rank, mesh, tmp, device, name, keep, profile, over)
        torch.cuda.empty_cache()
    out["psum"] = st_psum_rank(rank, mesh, device)
    torch.cuda.empty_cache()
    dit["elastic"] = st_elastic_rank(rank, device, **later)
    if rank == 0:
        dit["serve"] = st_serve_restored(later["ck"], mem, device)
    return out


def st_serve_restored(ck, mem, device) -> dict:
    """Rank 0, after the group's work: the (2 x 2) checkpoint restored on
    this one device and the gathered in-memory parameters ``mem``, each
    sampled through FlexiPipeline.sample at budget 0.6 on the flash
    kernel (built by the parent)."""
    cfg = dataclasses.replace(get_config("dit-xl-2"), num_layers=ST_DIT_LAYERS)
    tree, _ = ck.restore(device=device)
    mem = tree_map(lambda x: x.to(device), mem)
    out = {"same_leaves": all(torch.equal(a, b) for a, b in zip(
        tree_leaves(tree["params"]), tree_leaves(mem)))}
    plan = SamplingPlan(T=T_STEPS, budget=0.6, guidance_scale=1.5,
                        attn_backend="pallas")
    labels = torch.tensor([1, 207, 360, 979], device=device) % cfg.dit.num_classes
    x0 = {}
    ops.reset_launches()
    for name, p in (("restored", tree["params"]), ("in memory", mem)):
        pipe = FlexiPipeline(p, cfg, linear_schedule(1000), device=device)
        x0[name] = pipe.sample(plan, len(labels), torch.Generator(device=device)
                               .manual_seed(7), cond=labels).x0
        del pipe
    torch.cuda.synchronize()
    out.update(launches=ops.flash_attention.launches,
               by_variant=dict(ops.flash_attention.launches_by_variant),
               want=2 * cfg.num_layers * forward_calls(plan, cfg),
               forwards=forward_calls(plan, cfg),
               same=torch.equal(x0["restored"], x0["in memory"]),
               finite=bool(torch.isfinite(x0["restored"]).all()))
    return out


def phase_sharded_train(smi: str) -> dict:
    import shutil
    import tempfile

    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    build.build_all()        # every kernel built before any rank starts
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_"))
    try:
        refs = st_references(tmp)
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        log(f"[sharded] single-device references in "
            f"{time.perf_counter() - t0:.1f}s; this process then holds "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
            f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved; the card "
            f"{free / 1e9:.2f} of {total / 1e9:.2f} GB free ({smi})")
        t1 = time.perf_counter()
        res = run_ranks(st_rank, ST_WORLD, backend="gloo", device="cuda",
                        timeout_s=ST_TIMEOUT_S, args=(str(tmp),))
        group_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    errors = []
    st_report(res, refs, group_s, smi, errors)
    if errors:
        raise AssertionError("phase 15: " + "; ".join(errors))
    secs = time.perf_counter() - t0
    log(f"[sharded] phase 15 in {secs:.1f}s ({smi})")
    return {"launches": res[0]["dit"]["serve"]["launches"], "seconds": secs,
            "bytes": {case: sum(res[0][case]["bytes"][:2])
                      for case in ["dit"] + [n for n, *_ in ST_LMS]}}


def st_rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def st_report(res, refs, group_s, smi, errors) -> None:
    """Print every reading beside its limit, then collect the misses."""
    note = ("ranks share this card and Gloo stages every collective through "
            "the host: the mechanism's price, not scaling")
    for case in ["dit"] + [n for n, *_ in ST_LMS]:
        got = [r[case]["bytes"] for r in res]
        ok = all(p + m == wp + wm for p, m, wp, wm in got)
        log(f"[sharded] {case}: resident parameter + moment bytes a rank "
            f"{[p + m for p, m, _, _ in got]} == spec arithmetic "
            f"{[wp + wm for _, _, wp, wm in got]}: {ok}")
        if not ok:
            errors.append(f"{case}: resident bytes {got}")
    r0, want = res[0]["dit"], refs["dit"]
    worst = max(r0["rels"].values())
    lrel = st_rel(r0["loss"], want["loss"])
    nrel = st_rel(r0["grad_norm"], want["grad_norm"])
    log(f"[sharded] DiT-XL/2 ({ST_DIT_LAYERS} of 28 layers) first step "
        f"(mode {ST_MODES[0]}) on (2 x 2) "
        f"fsdp2d, B={ST_DIT_B}: loss {r0['loss']:.6f} vs single-device "
        f"{want['loss']:.6f} (rel {lrel:.2e}); grad norm rel {nrel:.2e}; "
        f"gradient leaves ||g - ref|| / ||ref|| worst {worst:.3e} over "
        f"{len(r0['rels'])} leaves (limit {ST_GRAD_TOL}) ({smi})")
    if not (worst <= ST_GRAD_TOL and lrel <= ST_GRAD_TOL and nrel <= ST_GRAD_TOL):
        errors.append(f"DiT: loss {lrel}, norm {nrel}, worst leaf {worst}")
    walls = [max(r["dit"]["walls"][i] for r in res) for i in range(4)]
    log(f"[sharded] DiT-XL/2 ({ST_DIT_LAYERS} of 28 layers) steps (modes "
        f"{ST_MODES}) on (2 x 2): walls "
        f"{', '.join(f'{w:.2f}' for w in walls)} s vs single-device "
        f"{', '.join(f'{w:.3f}' for w in refs['dit_walls'])} s; losses "
        f"{', '.join(f'{x:.4f}' for x in r0['losses'])}; peak memory a rank "
        f"{[round(r['dit']['peak'] / 1e9, 2) for r in res]} GB vs single-device "
        f"{refs['dit_peak'] / 1e9:.2f} GB; checkpoint after step 1: gathered "
        f"(every rank) and copied to the host (rank 0) in {r0['save_s']:.1f} s, "
        f"written by rank 0 beside steps 2-4 and the LM cases, then waited "
        f"{r0['elastic']['wait_s']:.1f} s "
        f"({note}; {smi})")
    if not (all(np.isfinite(r0["losses"])) and all(r["dit"]["finite"] for r in res)):
        errors.append("DiT steps not finite")
    el = r0["elastic"]
    log(f"[sharded] elastic restore onto make_elastic_mesh(2, 2) = {el['sub']} "
        f"(ranks 0-1) in {el['restore_s']:.1f} s, step 2 there in "
        f"{el['wall']:.2f} s: ||dp - dp_ref|| / ||dp_ref|| against the "
        f"uninterrupted (2 x 2) step 2 {el['update_rel']:.3e} (limit "
        f"{ST_UPDATE_TOL}; {smi})")
    if not el["update_rel"] <= ST_UPDATE_TOL:
        errors.append(f"elastic step 2: {el['update_rel']}")
    sv = r0["serve"]
    log(f"[sharded] the (2 x 2) checkpoint restored on one device (rank 0): "
        f"leaves == the gathered in-memory parameters: {sv['same_leaves']}; "
        f"each sampled at budget 0.6 (CFG 1.5, T={T_STEPS}) on the flash "
        f"kernel: flash launches {sv['launches']} (2 x {ST_DIT_LAYERS} x "
        f"{sv['forwards']} "
        f"forwards), by variant {sv['by_variant']}; x0 restored == in memory "
        f"bit for bit: {sv['same']} ({smi})")
    if not (sv["same"] and sv["same_leaves"] and sv["finite"]):
        errors.append("the sharded checkpoint serves differently")
    if not sv["launches"] == sv["by_variant"].get("wgmma", 0) == sv["want"]:
        errors.append(f"sharded checkpoint served: flash {sv['by_variant']}, "
                      f"expected {sv['want']}, all wgmma")
    for name, keep, profile, over in ST_LMS:
        got, want = res[0][name], refs[name]
        worst = max(got["rels"].values())
        lrel = st_rel(got["loss"], want["loss"])
        aux = {k: st_rel(got["metrics"][k], v) for k, v in want["metrics"].items()
               if k != "loss"}
        log(f"[sharded] {name} cut to {keep} layers on (2 x 2) {profile}, "
            f"B={ST_LM_B} x S={ST_LM_S}: loss {got['loss']:.6f} vs single-device "
            f"{want['loss']:.6f} (rel {lrel:.2e}); aux rel {aux} (limit "
            f"{ST_AUX_TOL}); gradient leaves worst {worst:.3e} over "
            f"{len(got['rels'])} (limit {ST_GRAD_TOL}); a step "
            f"{max(r[name]['grads_wall'] for r in res):.2f} s of gradients + "
            f"{max(r[name]['adamw_wall'] for r in res):.2f} s of AdamW vs "
            f"single-device gradients {want['wall']:.2f} s; peak memory a rank "
            f"{[round(r[name]['peak'] / 1e9, 2) for r in res]} GB vs "
            f"single-device {want['peak'] / 1e9:.2f} GB ({note}; {smi})")
        if not (worst <= ST_GRAD_TOL and lrel <= ST_GRAD_TOL
                and all(v <= ST_AUX_TOL for v in aux.values())):
            errors.append(f"{name}: loss {lrel}, aux {aux}, worst leaf {worst}")
        if not all(r[name]["finite"] for r in res):
            errors.append(f"{name}: step not finite")
    plants = {
        "global_norm over local chunks": (st_rel(
            r0["norm_local"], refs["dit"]["grad_norm"]), ST_GRAD_TOL),
        "a data-axis gradient unsummed": (r0["unsummed"], ST_GRAD_TOL),
        "the SP gather's backward a sum": (res[0]["gemma2-9b"]["sp_sum"],
                                           ST_GRAD_TOL),
        "load_balance per rank": (st_rel(
            res[0]["deepseek-moe-16b"]["lb_per_rank"],
            refs["deepseek-moe-16b"]["metrics"]["load_balance"]), ST_AUX_TOL)}
    for what, (read, limit) in plants.items():
        log(f"[sharded] planted fault, {what}: {read:.3e} (must exceed {limit})")
        if not read > limit:
            errors.append(f"planted fault {what} read {read}")
    ps = [r["psum"] for r in res]
    log(f"[sharded] compressed_psum of {ST_PSUM_N} float32 over {ST_WORLD} "
        f"ranks: == the reference formula on the host, bit for bit: "
        f"{ps[0]['equal']}; every rank's result the same: "
        f"{len({p['sha'] for p in ps}) == 1}; wall {max(p['wall'] for p in ps):.2f}"
        f" s ({note}; {smi})")
    if not (ps[0]["equal"] and len({p["sha"] for p in ps}) == 1):
        errors.append("compressed_psum differs from the reference formula")
    log(f"[sharded] the rank group ran in {group_s:.1f} s ({smi})")


# ---------------------------------------------------------------------------
# Phase 16: the dry-run planner against the card


def plan_forward_on_card(params, cfg, mode: int, gen: torch.Generator) -> dict:
    """One DiT-XL/2 forward at PLAN_B rows on the flash kernel: the FLOPs
    of this path (``FlopCounterMode`` sees the GEMMs; each flash launch is
    priced by the kernel's ledger at its full tile map, as a forward with
    no segment ids uses), its launches, and its median time."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.attention import costing
    F_, H, W, C = cfg.dit.latent_shape
    x = randn(gen, (PLAN_B, F_, H, W, C), torch.bfloat16)
    t = torch.randint(0, 1000, (PLAN_B,), generator=gen, device=DEV).float()
    y = torch.randint(0, cfg.dit.num_classes, (PLAN_B,), generator=gen, device=DEV)

    def fwd():
        return dit_mod.dit_forward(params, x, t, y, cfg, mode=mode,
                                   attn_backend="pallas")
    with torch.inference_mode():
        fwd()
        torch.cuda.synchronize()
        n0 = ops.flash_attention.launches
        v0 = dict(ops.flash_attention.launches_by_variant)
        with FlopCounterMode(display=False) as counter:
            out = fwd()
        torch.cuda.synchronize()
        launches = ops.flash_attention.launches - n0
        by_variant = {k: n - v0.get(k, 0) for k, n in
                      ops.flash_attention.launches_by_variant.items()
                      if n - v0.get(k, 0)}
        S = dit_mod.tokens_for_mode(cfg, mode)
        ledger = launches * PLAN_B * costing.block_sparse_attention_flops(
            [S], S, cfg.d_model)
        times = sorted(cuda_ms(fwd)[1] for _ in range(PLAN_REPS))
    return {"gemm_flops": float(counter.get_total_flops()),
            "ledger_flops": float(ledger), "launches": launches,
            "by_variant": by_variant, "finite": bool(torch.isfinite(out).all()),
            "ms": times[len(times) // 2], "ms_min": times[0]}


def phase_plan(smi: str, measured_bytes: dict | None = None) -> dict:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rl
    from repro_torch.runtime.sharding import AxisLayout

    t0 = time.perf_counter()
    hw = rl.h100()
    one = AxisLayout(("data", "model"), (1, 1))
    errors = []
    # the two cells on one card
    rec = dryrun.run_cell("dit-xl-2", "serve_powerful", mesh=one)
    log(f"[plan] {dryrun.summary_line(rec)}; fits {hw.hbm_bytes / 1e9:.1f} GB: "
        f"{rec['fits_hbm']}")
    name, keep, B, S = LMT_DENSE
    _, cut = lm_cut(name, keep)
    rec = dryrun.run_cell(name, "train_8k", mesh=one, cfg=cut,
                          shape=ShapeConfig("train_8k", S, B, "train"))
    log(f"[plan] {dryrun.summary_line(rec)} (phase 13's cut, {keep} layers, "
        f"B={B} x S={S}); microbatches {rec['n_microbatches']}, temporaries "
        f"{rec['memory_analysis']['temp_size_in_bytes'] / 1e9:.1f} GB")
    if rec["status"] != "ok":
        errors.append(f"gemma2 cut plan {rec['status']}")
    # a DiT-XL/2 forward: the planner's meta count against the card's
    params, cfg = trained_like_xl(torch.Generator(device=DEV).manual_seed(SEED + 16))
    gen = torch.Generator(device=DEV).manual_seed(SEED + 17)
    forwards = {}
    ops.reset_launches()
    for mode in (0, 1):
        plan = dryrun.plan_dit_forward(cfg, PLAN_B, mode)["flops"]
        card = plan_forward_on_card(params, cfg, mode, gen)
        got = card["gemm_flops"] + card["ledger_flops"]    # the flash path
        rel = abs(got - plan) / plan
        bound_ms = plan / hw.peak_flops * 1e3
        share = bound_ms / card["ms"]
        forwards[mode] = {"ms": card["ms"], "share": share, "rel": rel}
        log(f"[plan] DiT-XL/2 forward B={PLAN_B} mode {mode}: planner (meta, "
            f"dense) {plan / 1e9:.3f} GFLOP; flash path run on the card "
            f"{got / 1e9:.3f} GFLOP (GEMMs {card['gemm_flops'] / 1e9:.3f} + "
            f"flash ledger {card['ledger_flops'] / 1e9:.3f} over "
            f"{card['launches']} launches {card['by_variant']}); "
            f"|flash - dense| / dense "
            f"{rel:.2e} (limit {PLAN_FLOPS_TOL:g}); {card['ms']:.3f} ms "
            f"median of {PLAN_REPS} (min {card['ms_min']:.3f}) against a "
            f"compute bound of {bound_ms:.3f} ms at {hw.peak_flops / 1e12:.0f} "
            f"TFLOP/s: {100 * share:.1f} % of it ({smi})")
        if rel > PLAN_FLOPS_TOL:
            errors.append(f"mode {mode} FLOPs {got} vs planned {plan}")
        if card["launches"] != cfg.num_layers or \
                card["by_variant"] != {"wgmma": cfg.num_layers}:
            errors.append(f"mode {mode} flash launches {card['by_variant']}")
        if not card["finite"]:
            errors.append(f"mode {mode} forward not finite")
    launches = ops.flash_attention.launches       # warm-up, counted, timed
    if launches != 2 * (2 + PLAN_REPS) * cfg.num_layers:
        errors.append(f"{launches} flash launches for {2 * (2 + PLAN_REPS)} "
                      f"forwards")
    del params
    torch.cuda.empty_cache()
    # resident bytes a rank on (2 x 2): the planner against phase 15
    mesh = AxisLayout(("data", "model"), ST_MESH)
    cases = [("dit", dataclasses.replace(get_config("dit-xl-2"),
                                         num_layers=ST_DIT_LAYERS), "fsdp2d")]
    for lm_name, lm_keep, profile, over in ST_LMS:
        cases.append((lm_name, dataclasses.replace(lm_cut(lm_name, lm_keep)[1],
                                                   **over), profile))
    for case, case_cfg, profile in cases:
        b = dryrun.resident_bytes(case_cfg, mesh, profile)
        got = b["param_bytes"] + b["opt_bytes"]
        seen = (measured_bytes or {}).get(case)
        log(f"[plan] {case} on (2 x 2) {profile}: planned parameter + moment "
            f"bytes a rank {got:,} == phase 15's measured "
            f"{PLAN_BYTES[case]:,}"
            + (f" (this run's phase 15: {seen:,})" if seen is not None else ""))
        if got != PLAN_BYTES[case] or (seen is not None and seen != got):
            errors.append(f"{case} bytes {got} vs {PLAN_BYTES[case]} / {seen}")
    secs = time.perf_counter() - t0
    log(f"[plan] phase 16 in {secs:.1f}s ({smi})")
    if errors:
        raise AssertionError("phase 16: " + "; ".join(errors))
    return {"launches": launches, "forwards": forwards, "seconds": secs}


# ---------------------------------------------------------------------------
# Phase 17: runners captured once as CUDA graphs (runtime.graphs)


def x0_equal(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(torch.equal(a[i], b[i]) for i in a)


def graphs_engine_pair(pipe, plans, wave, cache=None, label="",
                       rotate=False) -> dict:
    """A frozen engine (``allow_cold=False``) on a fresh runner cache whose
    runners are captured at warm-up, beside the same engine run eagerly
    (``graphs.disabled()``): x0 of each request bit for bit, flash launches
    equal, captures after warm-up, synchronising calls, walls and graph
    pool bytes over one wave (and, with ``rotate``, a budget switch: the
    wave again with every budget rotated). With ``cache`` a list of two
    CacheSpecs, the second engine (a cache-policy switch) reuses the
    first's graphs."""
    cfg = pipe.cfg
    specs = cache if cache is not None else [None]
    sides = {}
    for side in ("captured", "eager"):
        ctx = graphs.disabled() if side == "eager" else contextlib.nullcontext()
        gp = FlexiPipeline(pipe.params, cfg, pipe.sched, device=DEV)
        runs = []
        with ctx:
            for spec in specs:
                eng = ServingEngine(gp, plans, steps_per_dispatch=SERVE_K,
                                    allow_cold=False, cache=spec)
                t0 = time.perf_counter()
                n_pre = eng.precapture_warm_set(max_per_mode=1)
                warm_s = time.perf_counter() - t0
                after_warm = gp.cache_stats()
                torch.cuda.synchronize()
                ops.reset_launches()
                f0 = eng.packed_forwards
                t0 = time.perf_counter()
                msgs: list = []
                res, syncs = count_syncs(lambda: serve_wave(eng, wave), msgs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                # a budget switch: the same labels, every budget rotated
                rot = [(c, BUDGETS[(BUDGETS.index(b) + 1) % len(BUDGETS)])
                       for c, b in wave]
                res_rot = serve_wave(eng, rot) if rotate else []
                torch.cuda.synchronize()
                runs.append(dict(
                    layouts=len({k.layout for k in gp._runners}),
                    n_pre=n_pre, warm_s=warm_s, after_warm=after_warm,
                    end=gp.cache_stats(), syncs=syncs, wall=wall,
                    sync_kinds=collections.Counter(msgs),
                    forwards=eng.packed_forwards - f0,
                    launches=ops.flash_attention.launches,
                    by_variant=dict(ops.flash_attention.launches_by_variant),
                    x0={r.request.id: r.x0 for r in res},
                    x0_rot={r.request.id: r.x0 for r in res_rot},
                    cached=spec is not None))
        sides[side] = runs
    errors = []
    for i, spec in enumerate(specs):
        cap, eag = sides["captured"][i], sides["eager"][i]
        name = f"{label}{'' if spec is None else f' interval {spec.interval}'}"
        # one captured micro-step a layout (every depth k), a graph a branch
        branches = 2 if spec is not None else 1
        want_cap = cap["layouts"] * branches
        first = i == 0
        if first and cap["after_warm"]["captured"] != want_cap:
            errors.append(f"{name}: {cap['after_warm']['captured']} graphs "
                          f"after warm-up, expected {want_cap}")
        if not first and (cap["n_pre"] or cap["after_warm"]["captured"]
                          != sides["captured"][0]["end"]["captured"]):
            errors.append(f"{name}: the cache-policy switch built "
                          f"{cap['n_pre']} runners / captured "
                          f"{cap['after_warm']['captured']}")
        if cap["end"]["captured"] != cap["after_warm"]["captured"] or \
                cap["end"]["compiled"] != cap["after_warm"]["compiled"]:
            errors.append(f"{name}: captures after warm-up "
                          f"{cap['after_warm']} -> {cap['end']}")
        if eag["end"]["captured"]:
            errors.append(f"{name}: the eager side captured")
        if not (x0_equal(cap["x0"], eag["x0"])
                and x0_equal(cap["x0_rot"], eag["x0_rot"])):
            errors.append(f"{name}: captured x0 != eager x0")
        if cap["launches"] != eag["launches"] or \
                cap["by_variant"].get("wgmma") != cap["launches"] or \
                cap["forwards"] != eag["forwards"]:
            errors.append(f"{name}: flash launches {cap['by_variant']} vs "
                          f"eager {eag['by_variant']}")
        if cap["syncs"] != eag["syncs"]:
            errors.append(f"{name}: {cap['syncs']} synchronising calls "
                          f"captured vs {eag['syncs']} eager: "
                          f"{dict(cap['sync_kinds'])} vs "
                          f"{dict(eag['sync_kinds'])}")
        log(f"[graphs] engine {name}: warm set {cap['n_pre']} runners, "
            f"{cap['after_warm']['captured']} graphs captured in "
            f"{cap['warm_s']:.2f}s (eager warm-up {eag['warm_s']:.2f}s); "
            f"after the wave{' and a budget switch' if rotate else ''} "
            f"{cap['end']['captured']} graphs, {cap['end']['replays']} "
            f"replays, graph pools "
            f"{cap['end']['graph_pool_bytes'] / 2**20:.1f} MiB; steady wave "
            f"({len(cap['x0'])} requests, {cap['forwards']} packed forwards)"
            f": wall captured {cap['wall'] * 1e3:.1f} ms vs eager "
            f"{eag['wall'] * 1e3:.1f} ms; flash launches {cap['launches']} "
            f"== eager {eag['launches']} {cap['by_variant']}; synchronising "
            f"calls {cap['syncs']} == eager {eag['syncs']}; x0 bit for bit: "
            f"{x0_equal(cap['x0'], eag['x0'])}")
    return {"errors": errors, "sides": sides}


def sample_pair(pipe, plan, n, gen_seed, label, **kw) -> dict:
    """``FlexiPipeline.sample`` on a fresh captured pipeline, twice (the
    first call captures, the second replays), against a fresh pipeline
    under ``graphs.disabled()``: x0 bit for bit, launches equal."""
    out = {}
    for side in ("captured", "eager"):
        gp = FlexiPipeline(pipe.params, pipe.cfg, pipe.sched, device=DEV)
        ctx = graphs.disabled() if side == "eager" else contextlib.nullcontext()
        xs, launches = [], []
        with ctx:
            for _ in range(2 if side == "captured" else 1):
                ops.reset_launches()
                t0 = time.perf_counter()
                res = gp.sample(plan, n, torch.Generator(device=DEV)
                                .manual_seed(gen_seed), **kw)
                torch.cuda.synchronize()
                xs.append((res.x0, time.perf_counter() - t0))
                launches.append(dict(ops.flash_attention.launches_by_variant))
        out[side] = dict(x0=xs, launches=launches, stats=gp.cache_stats(),
                         pipe=gp)
    cap, eag = out["captured"], out["eager"]
    ref = eag["x0"][0][0]
    ok = all(torch.equal(x, ref) for x, _ in cap["x0"])
    same_launches = all(l == eag["launches"][0] for l in cap["launches"])
    log(f"[graphs] sample {label}: x0 captured (first call, replay) == eager "
        f"bit for bit: {ok}; flash launches {cap['launches'][1]} == eager "
        f"{eag['launches'][0]}: {same_launches}; wall first call "
        f"{cap['x0'][0][1] * 1e3:.1f} ms, replay {cap['x0'][1][1] * 1e3:.1f} "
        f"ms, eager {eag['x0'][0][1] * 1e3:.1f} ms; {cap['stats']['captured']}"
        f" graphs, pools {cap['stats']['graph_pool_bytes'] / 2**20:.1f} MiB")
    out["errors"] = ([] if ok else [f"sample {label}: captured x0 != eager"]) \
        + ([] if same_launches else [f"sample {label}: launches differ"])
    return out


def forward_replay(params, cfg, gen: torch.Generator, smi: str) -> dict:
    """Phase 16's B=8 forward captured and replayed: its wall (host clock
    to a synchronise) against the eager forward's and against the
    planner's compute bound, per mode."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rl
    F_, H, W, C = cfg.dit.latent_shape
    out = {}
    for mode in (0, 1):
        bound = dryrun.plan_dit_forward(cfg, PLAN_B, mode)["flops"] \
            / rl.h100().peak_flops * 1e3
        x = randn(gen, (PLAN_B, F_, H, W, C), torch.bfloat16)
        t = torch.randint(0, 1000, (PLAN_B,), generator=gen, device=DEV).float()
        y = torch.randint(0, cfg.dit.num_classes, (PLAN_B,), generator=gen,
                          device=DEV)
        fwd = graphs.capture(lambda p, x, t, y: dit_mod.dit_forward(
            p, x, t, y, cfg, mode=mode, attn_backend="pallas"))
        walls = {}
        with torch.inference_mode():
            eager = fwd.eager(params, x, t, y)
            fwd(params, x, t, y)                          # captures
            got = fwd(params, x, t, y)
            for name, call in (("eager", lambda: fwd.eager(params, x, t, y)),
                               ("replay", lambda: fwd(params, x, t, y))):
                times = []
                for _ in range(PLAN_REPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    call()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                times.sort()
                walls[name] = times[len(times) // 2]
        out[mode] = dict(walls, bound=bound,
                         equal=bool(torch.equal(got, eager)))
        log(f"[graphs] DiT-XL/2 forward B={PLAN_B} mode {mode}: wall median of "
            f"{PLAN_REPS} eager {walls['eager']:.3f} ms, replayed "
            f"{walls['replay']:.3f} ms; compute bound {bound:.3f} ms: "
            f"{100 * bound / walls['eager']:.1f} % of it eager, "
            f"{100 * bound / walls['replay']:.1f} % replayed; replay == eager "
            f"bit for bit: {out[mode]['equal']} ({smi})")
    return out


def lm_graphs(smi: str) -> dict:
    """The LM serving loop (``launch/serve.serve_lm``'s: ``lm_prefill``
    into the batch's slot, ``lm_decode`` on it) for each of LM_GRAPHS at
    full width, depth cut: two batches through one prefill and one decode
    runner, captured, then the same batches through the same runners under
    ``graphs.disabled()`` on a slot of their own. Returns the errors and
    the readings: tokens, logits and the slot bit for bit, flash launches
    equal, graphs captured by each batch (two by the first, none by the
    second), decode ms a step replayed and eager."""
    from repro_torch.launch import serve as serve_mod
    gen = torch.Generator(device=DEV).manual_seed(SEED + 19)
    out, errors = {}, []
    for name, keep in LM_GRAPHS:
        cfg = dataclasses.replace(get_config(name), num_layers=keep)
        params = lm_mod.init_params(cfg, gen)
        prefill = lm_steps.make_prefill_step(cfg, backend="pallas")
        decode = lm_steps.make_decode_step(cfg)
        batches = [torch.randint(0, cfg.vocab_size, (LM_G_BATCH, LM_G_SEQ),
                                 device=DEV, generator=gen) for _ in range(2)]
        sides = {}
        for side in ("captured", "eager"):
            ctx = graphs.disabled() if side == "eager" else contextlib.nullcontext()
            slot = lm_mod.serve_slot(cfg, LM_G_BATCH, LM_G_SEQ + LM_G_DECODE, DEV)
            runs = []
            with ctx, torch.inference_mode():
                for toks in batches:
                    ops.reset_launches()
                    before = prefill.captures + decode.captures
                    logits, prefill_s = timed_call(lambda: serve_mod.lm_prefill(
                        prefill, params, {"tokens": toks}, slot))
                    tok = logits.argmax(-1).to(torch.int32)[:, None]
                    (toks_out, dec), dec_s = timed_call(lambda: serve_mod.lm_decode(
                        decode, params, slot, tok, LM_G_SEQ, LM_G_DECODE))
                    runs.append(dict(
                        logits=logits, gen=toks_out, dec=dec,
                        cache={k: t.clone() for k, t in slot.items()},
                        launches=dict(ops.flash_attention.launches_by_variant),
                        captured=prefill.captures + decode.captures - before,
                        prefill_ms=prefill_s * 1e3, decode_ms=dec_s * 1e3 / LM_G_DECODE))
            sides[side] = runs
        cap, eag = sides["captured"], sides["eager"]
        equal = all(torch.equal(c[k], e[k]) for c, e in zip(cap, eag)
                    for k in ("logits", "gen", "dec")) and all(
            torch.equal(c["cache"][k], e["cache"][k]) for c, e in zip(cap, eag)
            for k in e["cache"])
        launches = [c["launches"] for c in cap]
        if not equal:
            errors.append(f"LM {name}: captured != graphs.disabled()")
        if launches != [e["launches"] for e in eag] or any(
                l["wgmma"] != keep or sum(l.values()) != keep for l in launches):
            errors.append(f"LM {name}: flash launches {launches} vs eager "
                          f"{[e['launches'] for e in eag]}")
        if [c["captured"] for c in cap] != [2, 0] or any(e["captured"] for e in eag):
            errors.append(f"LM {name}: graphs captured by batch "
                          f"{[c['captured'] for c in cap]}, eager "
                          f"{[e['captured'] for e in eag]}")
        stats = graphs.stats([prefill, decode])
        out[name] = dict(prefill_ms=cap[1]["prefill_ms"],
                         prefill_eager_ms=eag[1]["prefill_ms"],
                         decode_ms=cap[1]["decode_ms"],
                         decode_eager_ms=eag[1]["decode_ms"],
                         pool_bytes=stats["graph_pool_bytes"])
        log(f"[graphs] LM {name} ({keep} layers at full width) served twice "
            f"(B{LM_G_BATCH}, {LM_G_SEQ}-token prompts, {LM_G_DECODE} decode "
            f"steps) through one prefill and one decode runner: graphs captured "
            f"by batch {[c['captured'] for c in cap]}, then {stats['replays']} "
            f"replays, pools {stats['graph_pool_bytes'] / 2**20:.1f} MiB; second "
            f"batch: prefill {cap[1]['prefill_ms']:.1f} ms replayed vs "
            f"{eag[1]['prefill_ms']:.1f} eager, decode {cap[1]['decode_ms']:.2f} "
            f"ms a step replayed vs {eag[1]['decode_ms']:.2f} eager; flash "
            f"launches {launches} == eager; tokens, logits and slot == "
            f"graphs.disabled() bit for bit: {equal} ({smi})")
        del params, prefill, decode, sides, cap, eag
        free_card()
    return {"errors": errors, **out}


def phase_graphs(smi: str) -> dict:
    """Phase 17: every DiT runner captured once, against the same run
    eager; see the module docstring."""
    from repro_torch.fleet import BackgroundCompiler
    t0 = time.perf_counter()
    params, cfg = trained_like_xl(torch.Generator(device=DEV).manual_seed(SEED))
    pipe = FlexiPipeline(params, cfg, linear_schedule(1000), device=DEV)
    plans = {b: SamplingPlan(T=T_STEPS, budget=b, attn_backend="pallas")
             for b in BUDGETS}
    rng = np.random.default_rng(SEED + 7)
    wave = [(int(rng.integers(0, cfg.dit.num_classes)), BUDGETS[i % 3])
            for i in range(SERVE_WAVE + SERVE_JOIN)]
    errors = []
    # (a) engines: DDIM, DDPM, cached (interval 2, then 3 on its graphs)
    ddim = graphs_engine_pair(pipe, plans, wave, label="DDIM", rotate=True)
    errors += ddim["errors"]
    ddpm_plans = {b: dataclasses.replace(p, solver="ddpm")
                  for b, p in plans.items()}
    errors += graphs_engine_pair(pipe, ddpm_plans, wave, label="DDPM")["errors"]
    errors += graphs_engine_pair(
        pipe, plans, wave, label="cached",
        cache=[CacheSpec(policy="interval", interval=2),
               CacheSpec(policy="interval", interval=3)])["errors"]
    # (b) FlexiPipeline.sample, B=4
    labels = torch.tensor(np.random.default_rng(SEED + 17).integers(
        0, cfg.dit.num_classes, BATCH).tolist(), device=DEV)
    x_T = randn(torch.Generator(device=DEV).manual_seed(SEED + 18),
                (BATCH,) + tuple(cfg.dit.latent_shape))
    kw = dict(cond=labels, x_T=x_T)
    for label, plan in (
            ("static DDIM 0.6", plans[0.6]),
            ("static DDPM 0.8", dataclasses.replace(plans[0.8], solver="ddpm")),
            ("adaptive DDIM", SamplingPlan(T=T_STEPS, budget=AdaptiveBudget(),
                                           attn_backend="pallas"))):
        errors += sample_pair(pipe, plan, BATCH, 8, label, **kw)["errors"]
    c2 = sample_pair(pipe, dataclasses.replace(
        plans[1.0], cache=CacheSpec(policy="interval", interval=2)), BATCH, 8,
        "cached DDIM 1.0 interval 2", **kw)
    errors += c2["errors"]
    # the cache-policy switch on the captured pipeline: no runner, no graph
    gp = c2["captured"]["pipe"]
    before = gp.cache_stats()
    c3 = dataclasses.replace(plans[1.0], cache=CacheSpec(policy="interval",
                                                         interval=3))
    with torch.inference_mode():
        got = gp.sample(c3, BATCH, None, **kw).x0
        with graphs.disabled():
            want = c2["eager"]["pipe"].sample(c3, BATCH, None, **kw).x0
    after = gp.cache_stats()
    log(f"[graphs] sample cached interval 3 on interval 2's runner: runners "
        f"{before['compiled']} -> {after['compiled']}, graphs "
        f"{before['captured']} -> {after['captured']}; x0 == eager bit for "
        f"bit: {torch.equal(got, want)}")
    if after["compiled"] != before["compiled"] or \
            after["captured"] != before["captured"] or not torch.equal(got, want):
        errors.append("sample: the cache-policy switch captured or differs")
    # (c) phase 16's forward, replayed
    fw = forward_replay(pipe.params, cfg,
                        torch.Generator(device=DEV).manual_seed(SEED + 17), smi)
    errors += [f"forward mode {m} replay != eager" for m, r in fw.items()
               if not r["equal"]]
    # (d) a warm-up thread capturing (another engine's ladder, on its own
    # pipeline) while this thread serves the DDIM wave on captured runners
    spipe = FlexiPipeline(pipe.params, cfg, pipe.sched, device=DEV)
    eng = ServingEngine(spipe, plans, steps_per_dispatch=SERVE_K,
                        allow_cold=False)
    eng.precapture_warm_set(max_per_mode=1)
    other = ServingEngine(FlexiPipeline(pipe.params, cfg, pipe.sched,
                                        device=DEV), plans,
                          steps_per_dispatch=SERVE_K)
    warm = BackgroundCompiler(other, max_per_mode=1).start()
    res = serve_wave(eng, wave)
    # this stream only: a device-wide synchronise while the other thread
    # captures is refused (cudaErrorStreamCaptureUnsupported)
    torch.cuda.current_stream().synchronize()
    done = warm.wait(timeout=600)
    torch.cuda.synchronize()
    rungs = warm.assert_warm() if done else 0
    same = x0_equal({r.request.id: r.x0 for r in res},
                    ddim["sides"]["captured"][0]["x0"])
    log(f"[graphs] warm-up thread: {warm.captured} rungs captured on its own "
        f"stream while the serving thread replayed a wave; joined {done}, "
        f"{rungs} layouts proven warm, {other.cache_stats()['captured']} "
        f"graphs; served x0 == the sequential captured wave bit for bit: "
        f"{same}")
    if not (done and same):
        errors.append("warm-up thread: did not finish, or x0 differs")
    del pipe, spipe, eng, other
    free_card()
    # (e) the LM serving loop's two runners
    lm = lm_graphs(smi)
    errors += lm.pop("errors")
    secs = time.perf_counter() - t0
    log(f"[graphs] phase 17 in {secs:.1f}s ({smi})")
    if errors:
        raise AssertionError("phase 17: " + "; ".join(errors))
    return {"seconds": secs, "lm": lm,
            "forward_ms": {m: {k: r[k] for k in ("eager", "replay", "bound")}
                           for m, r in fw.items()}}


# ---------------------------------------------------------------------------
# Phase 18: the fleet over sequence-parallel rank groups


FG_SEED = SEED + 11
# (a) serves FG_REQUESTS; (b) serves the first FG_FIRST, loses a rank,
# rejoins and serves the rest
FG_REQUESTS, FG_FIRST = 10, 8
FG_SP = 2
# DiT-XL/2 at full width cut to 14 of its 28 layers, so the script keeps
# within its time limit beside phase 19: placements, served-once and x0
# against the rank-shaped fleet are exact at any depth, the planted bf16
# x0 reads bf16's rounding (at 28 layers: PERF.md §6, PR 30)
FG_LAYERS = 14
# x0 of the groups against the single-device fleet whose token GEMMs run
# in the ranks' row blocks: the same arithmetic, so it reads 0 on an H100
# 80GB HBM3 (700 W; PERF.md §6). The planted fault, x0 shipped back to
# the parent in bfloat16, must read over it in every request.
FG_SHAPED_X0_TOL = 1e-6
FG_HEARTBEAT_S = 5.0
FG_TIMEOUT_S = 420.0
FG_CLI = ["--arch", "dit-xl-2", "--mesh", "2x2", "--replicas", "2",
          "--dist-backend", "gloo", "--requests", "4", "--T", str(T_STEPS),
          "--budget-levels", "0.6,0.8,1.0", "--attn-backend", "pallas"]
FG_SERVE_CLI = ("[fleet-groups] (c)", FG_CLI, "[fleet] served 4 requests over 2",
                FG_TIMEOUT_S)


def fg_weights(device: torch.device):
    """Phase 18's weights, built on each rank (spawned ranks import this
    file by path): phase 3's recipe from FG_SEED."""
    return trained_like_xl(torch.Generator(device=device).manual_seed(FG_SEED),
                           FG_LAYERS)[0]


def fg_launches(rank: int, device: torch.device, state: dict,
                reset: bool) -> tuple:
    """This rank's flash launches and their variants; ``reset`` sets the
    counts to 0 after the read."""
    got = (ops.flash_attention.launches,
           dict(ops.flash_attention.launches_by_variant))
    if reset:
        ops.reset_launches()
    return got


@contextlib.contextmanager
def rank_shaped_gemms(sp: int):
    """Single-device DiT forwards whose token GEMMs run in the row blocks a
    rank of a (1 x sp) group computes: every ``_linear`` of a [B, N, d]
    input (q, k, v, o and the MLP, all inside the blocks; the embed, the
    de-embed and the adaLN of [B, d] take other paths) done on each of
    the sp token slices [B, N/sp, d] apart. The same function, each
    GEMM's rows in the ranks' blocks: cuBLAS may pick another algorithm
    (another float32 summation order) at another row count."""
    sound = dit_mod._linear

    def sliced(x, w, *a, **kw):
        if x.dim() != 3 or x.shape[1] % sp:
            return sound(x, w, *a, **kw)
        n = x.shape[1] // sp
        return torch.cat([sound(x[:, i * n:(i + 1) * n], w, *a, **kw)
                          for i in range(sp)], dim=1)

    dit_mod._linear = sliced
    try:
        yield
    finally:
        dit_mod._linear = sound


def fg_fleet(pipe, plans, clock, pipes=None, **kw):
    """A fixed-slot fleet of 2 replicas (FG_SP wide each) with its
    placements logged."""
    from repro_torch.fleet import Fleet
    f = Fleet(pipe, plans, 2, pipes=pipes, engine_kind="fixed",
              seq_parallel=FG_SP, batch_size=BATCH, clock=clock,
              seconds_per_token=1e-4, **kw)
    f.placement_log, place = [], f.router.place

    def logged(req, views, level):
        r = place(req, views, level)
        f.placement_log.append((req.rid, r, level))
        return r

    f.router.place = logged
    return f


def fg_submit(f, labels, lo: int, hi: int) -> None:
    for rid in range(lo, hi):
        if f.submit(cond=labels[rid], budget=BUDGETS[rid % 3]) != rid:
            raise AssertionError(f"fleet id {rid} out of order")


def fg_batches(f) -> list:
    """The fixed-slot batches a fleet served: (replica, level, fleet ids),
    a batch being the requests one step of one replica finished."""
    out = collections.defaultdict(list)
    for rid, r in sorted(f.results.items()):
        out[(r.replica, r.record.finish, r.budget_served)].append(rid)
    return [(rep, b, rids) for (rep, _, b), rids in sorted(out.items())]


def fg_spread(make, labels):
    """(a): FG_REQUESTS requests under ``cheapest``, timed."""
    f = make(FleetClock(), router="cheapest")
    fg_submit(f, labels, 0, FG_REQUESTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f.served = f.run()
    torch.cuda.synchronize()
    f.wall = time.perf_counter() - t0
    return f


def fg_lost(make, labels, stop):
    """(b): the first FG_FIRST requests under ``rr``; after the first tick
    ``stop`` stops replica 0 (a single-process fleet: ``inject_hang``; the
    group fleet: one rank SIGKILLed), the clock passes the heartbeat
    timeout, the rest is served elsewhere; replica 0 rejoins and the last
    requests arrive."""
    clock = FleetClock()
    f = make(clock, router="rr", heartbeat_timeout_s=FG_HEARTBEAT_S)
    fg_submit(f, labels, 0, FG_FIRST)
    f.served = f.tick()
    f.first_pipe = f.replicas[0].engine.pipe
    stop(f)
    clock.advance(FG_HEARTBEAT_S + 1.0)
    f.served += f.tick()
    f.state_after = f.membership.state(0)
    f.served += f.run()
    f.incarnation = f.rejoin_replica(0)
    fg_submit(f, labels, FG_FIRST, FG_REQUESTS)
    f.served += f.run()
    return f


def fg_sigkill(f) -> None:
    import signal
    group = f.replicas[0].engine.pipe.group
    os.kill(group.pids[1], signal.SIGKILL)
    t0 = time.perf_counter()
    while group.alive() and time.perf_counter() - t0 < 30.0:
        time.sleep(0.01)


def fg_gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def fg_record(f):
    """What a reference fleet's checks read, without its pipeline (whose
    weights and graph pools would stay on the card)."""
    import types
    return types.SimpleNamespace(
        results=f.results, served=f.served, placement_log=f.placement_log,
        wall=getattr(f, "wall", None))


def fg_x0(f, ref) -> dict:
    return {r.rid: rel_err(r.x0, ref.results[r.rid].x0) for r in f.served}


def fg_references(params, cfg, sched, plans, labels, smi: str) -> dict:
    """(a) and (b) on single-device fixed-slot fleets on this card: plain
    (captured runners), and with the ranks' GEMM row blocks
    (:func:`rank_shaped_gemms`, eager on a fresh pipeline). Prints what
    the row blocks alone move x0 by."""
    refs = {}
    for shaped in (False, True):
        pipe = FlexiPipeline(params, cfg, sched, device=DEV)
        ctx = contextlib.ExitStack()
        if shaped:
            ctx.enter_context(graphs.disabled())
            ctx.enter_context(rank_shaped_gemms(FG_SP))
        with ctx:
            make = lambda clock, **kw: fg_fleet(pipe, plans, clock, **kw)  # noqa: E731
            refs[shaped] = tuple(fg_record(f) for f in (
                fg_spread(make, labels),
                fg_lost(make, labels, lambda f: f.inject_hang(0))))
        del pipe
    plain, shaped = refs[False][0], refs[True][0]
    errs = fg_x0(shaped, plain)
    log(f"[fleet-groups] single device, the ranks' GEMM row blocks against "
        f"plain (the same function, other float32 sums): ||x0 - plain|| / "
        f"||plain|| by request {{{', '.join(f'{k}: {v:.3e}' for k, v in errs.items())}}}"
        f" over batches {fg_batches(plain)} ({smi})")
    return refs


def fg_check(name: str, f, refs, errors: list) -> str:
    """Placements equal, every request served once, x0 within
    FG_SHAPED_X0_TOL of the fleet with the ranks' GEMM row blocks and
    within SP_RING_X0_TOL of the plain fleet (the limit of the same
    function summed in another order, phase 14's ring); then the planted
    fault, the groups' x0 rounded to bfloat16, must read over
    FG_SHAPED_X0_TOL in every request."""
    plain, shaped = refs
    if f.placement_log != plain.placement_log:
        errors.append(f"{name}: placements {f.placement_log} != the single-"
                      f"process fleet's {plain.placement_log}")
    rids = sorted(r.rid for r in f.served)
    if rids != list(range(FG_REQUESTS)):
        errors.append(f"{name}: served {rids}")
    e_shaped, e_plain = fg_x0(f, shaped), fg_x0(f, plain)
    if not all(e <= FG_SHAPED_X0_TOL for e in e_shaped.values()):
        errors.append(f"{name}: x0 vs the rank-shaped single-process fleet "
                      f"{e_shaped}")
    if not all(e <= SP_RING_X0_TOL for e in e_plain.values()):
        errors.append(f"{name}: x0 vs the plain single-process fleet "
                      f"{e_plain}")
    planted = {r.rid: rel_err(r.x0.to(torch.bfloat16), shaped.results[r.rid].x0)
               for r in f.served}
    if not min(planted.values()) > FG_SHAPED_X0_TOL:
        errors.append(f"{name}: the planted fault (x0 in bfloat16) reads "
                      f"{planted}, within {FG_SHAPED_X0_TOL}")
    over = {k: f"{v:.3e}" for k, v in e_plain.items() if v > SERVE_X0_TOL}
    return (f"placements equal: {f.placement_log == plain.placement_log}; "
            f"served once each: {rids == list(range(FG_REQUESTS))}; ||x0 - "
            f"ref|| / ||ref|| against the single-process fleet with the "
            f"ranks' GEMM row blocks max {max(e_shaped.values()):.3e} (tol "
            f"{FG_SHAPED_X0_TOL}; planted fault, x0 in bfloat16, min "
            f"{min(planted.values()):.3e} max {max(planted.values()):.3e}), "
            f"against the plain one max {max(e_plain.values()):.3e} (tol "
            f"{SP_RING_X0_TOL}; over {SERVE_X0_TOL}: {over}); batches "
            f"{fg_batches(f)}")


def phase_fleet_groups(smi: str, cli: bool = True) -> dict:
    """Phase 18 (see the module docstring); ``cli=False`` leaves (c) to the
    caller (the full run starts it beside phase 19's references)."""
    from repro_torch.distributed import ParallelSpec
    from repro_torch.fleet.groups import RankGroupPipeline
    t0 = time.perf_counter()
    build.build_all()        # every kernel built before any rank starts
    cfg = dataclasses.replace(get_config("dit-xl-2"), num_layers=FG_LAYERS)
    sched = linear_schedule(1000)

    def start(rid=None, device_ids=None) -> RankGroupPipeline:
        return RankGroupPipeline(cfg, sched, fg_weights, FG_SP, device=DEV,
                                 backend="gloo", timeout_s=FG_TIMEOUT_S)

    groups = [start(), start()]        # they start while the references run
    errors = []
    try:
        plans = {b: SamplingPlan(T=T_STEPS, budget=b, attn_backend="pallas")
                 for b in BUDGETS}
        labels = np.random.default_rng(FG_SEED).integers(
            0, cfg.dit.num_classes, FG_REQUESTS).tolist()
        params, _ = trained_like_xl(torch.Generator(device=DEV)
                                    .manual_seed(FG_SEED), FG_LAYERS)
        refs = fg_references(params, cfg, sched, plans, labels, smi)
        del params
        free_card()
        t1 = time.perf_counter()
        for g in groups:
            g.wait_ready()
        log(f"[fleet-groups] 2 groups of {FG_SP} ranks up with their weights "
            f"{time.perf_counter() - t0:.1f}s into the phase ("
            f"{time.perf_counter() - t1:.1f}s waited after the references; "
            f"{smi})")
        par = {b: dataclasses.replace(p, parallel=ParallelSpec())
               for b, p in plans.items()}
        forwards = [0, 0]
        for i, g in enumerate(groups):     # the forwards each group runs
            def counted(plan, n, *a, _sample=g.sample, _i=i, **kw):
                forwards[_i] += forward_calls(plan, cfg)
                return _sample(plan, n, *a, **kw)
            g.sample = counted

        def make(clock, **kw):
            return fg_fleet(groups[0], par, clock, pipes=groups,
                            pipe_factory=start, **kw)

        # (a), every rank's flash launches counted from 0
        for g in groups:
            g.group.call(fg_launches, True)
        a = fg_spread(make, labels)
        counts = [g.group.call(fg_launches, False) for g in groups]
        line = fg_check("(a)", a, (refs[False][0], refs[True][0]), errors)
        launches = 0
        for i, ranks in enumerate(counts):
            want = cfg.num_layers * forwards[i]
            if not want or any(c != want or v["wgmma"] != want
                               for c, v in ranks):
                errors.append(f"(a) group {i}: flash launches {ranks}, "
                              f"expected {want} a rank, all wgmma")
            launches += sum(c for c, _ in ranks)
        plain_wall = refs[False][0].wall
        log(f"[fleet-groups] (a) {FG_REQUESTS} requests over 2 groups of "
            f"{FG_SP} ranks, first run, in {a.wall:.2f}s = "
            f"{FG_REQUESTS / a.wall:.2f} img/s against the single-process "
            f"fleet's first run {plain_wall:.2f}s = "
            f"{FG_REQUESTS / plain_wall:.2f} img/s (the groups take turns on "
            f"this card and Gloo stages every collective through the host: "
            f"routing's price, not scale); {line}; flash launches a rank "
            f"{[c for g in counts for c, _ in g]} = {cfg.num_layers} x "
            f"{forwards} forwards, all wgmma ({smi})")

        # (b): one rank of replica 0's group SIGKILLed after the first tick
        t1 = time.perf_counter()
        b = fg_lost(make, labels, fg_sigkill)
        try:
            old = b.first_pipe.group
            left = [pid for pid in old.pids if not fg_gone(pid)]
            line = fg_check("(b)", b, (refs[False][1], refs[True][1]), errors)
            fresh = b.replicas[0].engine.pipe
            if b.state_after != "dead" or left or fresh is b.first_pipe \
                    or not fresh.alive():
                errors.append(f"(b): replica 0 {b.state_after}, processes "
                              f"left {left}, rejoined on a fresh group "
                              f"{fresh is not b.first_pipe and fresh.alive()}")
            log(f"[fleet-groups] (b) rank 1 of replica 0's group SIGKILLed "
                f"after the first tick: replica 0 {b.state_after} after the "
                f"{FG_HEARTBEAT_S}s heartbeat timeout, "
                f"{int(b.summary()['readmit']['count'])} re-admitted, "
                f"processes of the killed group left {left}; rejoined on a "
                f"fresh group for the last {FG_REQUESTS - FG_FIRST}; {line}; "
                f"{time.perf_counter() - t1:.1f}s, the fresh group's start "
                f"included ({smi})")
        finally:
            b.close()
    finally:
        for g in groups:
            g.close()
    if errors:
        raise AssertionError("phase 18: " + "; ".join(errors))
    if cli:
        ServeCli(*FG_SERVE_CLI).check(smi)
    secs = time.perf_counter() - t0
    log(f"[fleet-groups] phase 18 in {secs:.1f}s ({smi})")
    return {"launches": launches, "seconds": secs}


# ---------------------------------------------------------------------------
# Phase 19: the paper's text-to-video DiT

VIDEO_SEED = SEED + 19
# the flash kernel at the video DiT's lengths under CFG (2 rows), 24 heads
# x 128: modes 0 / 1 / 2 (patches (1, 2, 2) / (2, 2, 2) / (1, 4, 4) over a
# (32, 88, 48, 8) latent), held at T2I_ATTN_REL_TOL
VIDEO_ATTN = [(2, 33792, 24, 128), (2, 16896, 24, 128), (2, 8448, 24, 128)]
# the two plans (DDIM, CFG 1.5, LoRA merged) with their phases and
# relative compute as the host ledger resolves them at the full config:
# the temporal weak mode at budget 0.6 and T = 4, the spatial at 0.25 and
# T = 8 (the paper's "75 % less compute"). The temporal plan runs 4 steps,
# not 8 or 6: its blocked reference takes ~26 s a mode-0 NFE on the card
# (its float32 score blocks), and at T = 6 (two of them) the whole script
# took 1177 s of its 1200 s limit on an H100 80GB HBM3 (PERF.md §6, PR 31)
VIDEO_PLANS = (("temporal", dict(T=4, budget=0.6, weak_mode=1),
                ((1, 3), (0, 1)), 0.511),
               ("spatial", dict(T=8, budget=0.25, weak_mode=2),
                ((2, 7), (0, 1)), 0.244))
# the text mask keeps the first 200 of the 256 text tokens; the null
# text's keeps its first
VIDEO_TEXT_KEEP = 200
# x0 through the flash kernel against the same plan, x_T and text on the
# blocked backend (models/attention.blocked_gqa_attend, the reference's
# own path for long video sequences), ||x0 - ref|| / ||ref||; the planted
# fault (the kv tile walk stopping halfway) must read over it on every
# run. On an H100 80GB HBM3 (700 W), with the temporal plan at T = 8, 6
# and 4, both plans read 5.5e-3 to 5.7e-3 (bf16 rounding, P rounded to
# bf16 before P.V, over 32 layers) and the fault 1.41e-2 to 1.55e-2
# (PERF.md §6, PR 31): the limit sits between, ~1.6x from each
VIDEO_X0_TOL = 9e-3


def video_kernel(gen: torch.Generator, smi: str, errors: list) -> tuple:
    """Phase 19 (b) and (f): the flash kernel at the three video lengths
    against its plain version (a head at a time), the planted fault, and
    its time against the bound and SDPA in interleaved rounds."""
    shapes, worst = {}, 0.0
    for mode, (B, S, H, hd) in enumerate(VIDEO_ATTN):
        q, k, v = (randn(gen, (B, S, H, hd), torch.bfloat16) for _ in range(3))
        variant = variant_of(q, k, v)
        got = ops.flash_attention(q, k, v, causal=False)
        want, plain_ms = cuda_ms(lambda: flash_ref_by_head(q, k, v,
                                                           causal=False))
        want = want.float()
        sound = ops.kernel_kwargs
        ops.kernel_kwargs = _stop_tile_walk_halfway(sound)
        try:
            planted = ops.flash_attention(q, k, v, causal=False)
        finally:
            ops.kernel_kwargs = sound
        rel, fault = rel_err(got, want), rel_err(planted, want)
        err = (got.float() - want).abs().max().item()
        del got, want, planted
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kw = ops.kernel_kwargs(q, k, causal=False)
        t = interleaved_ms({
            "wgmma": lambda: flash_attention_cuda(q, k, v, **kw, variant="wgmma"),
            "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt)},
            rounds=5, calls=2, replays=1)
        bound, by = attention_bound_ms(B, S, H, hd, torch.bfloat16)
        ms = t["wgmma"]["ms"]
        log(f"[video] (b) flash_attention ({variant}) B{B} S{S} H{H} hd{hd} bf16 "
            f"non-causal (mode {mode}): ||err||/||ref|| {rel:.3e} (tol "
            f"{T2I_ATTN_REL_TOL}), max|err| {err:.3e}; planted fault (tile "
            f"walk stops halfway) {fault:.3e}; (f) medians of "
            f"{t['wgmma']['rounds']} interleaved rounds (fastest-slowest): "
            f"{turns_line(t)}; plain {plain_ms:.1f} ms (one call, a head at a "
            f"time); bound {bound:.4f} ms ({by}), {bound / ms:.1%} of it, "
            f"{t['sdpa']['ms'] / ms:.2f}x sdpa's speed ({smi})")
        if variant != "wgmma":
            errors.append(f"(b) S{S}: selects {variant}, not wgmma")
        if not rel <= T2I_ATTN_REL_TOL < fault:
            errors.append(f"(b) S{S}: sound {rel:.3e} over {T2I_ATTN_REL_TOL} "
                          f"or the planted fault {fault:.3e} under it")
        worst = max(worst, err)
        shapes[f"B{B} S{S} H{H} hd{hd} (video-dit mode {mode})"] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=t["sdpa"]["ms"],
            bound_ms=bound, bound_by=by, max_abs_err=err, rel_err=rel)
        del q, k, v, qt, kt, vt
        free_card()
    return shapes, worst


def video_cross_ms(params, cfg, mode: int, masks: tuple,
                   gen: torch.Generator) -> float:
    """Phase 19 (e): one layer's text cross-attention (dense, float32
    scores over the 256 text keys) at ``mode``'s length, both CFG rows,
    timed alone (CUDA graph of 2 calls)."""
    N = dit_mod.tokens_for_mode(cfg, mode)
    xa = randn(gen, (2, N, cfg.d_model), torch.bfloat16)
    kv = randn(gen, (2, cfg.dit.text_len, cfg.d_model), torch.bfloat16)
    mask2 = torch.cat(masks)
    layer = tree_map(lambda a: a[0], params["blocks"]["xattn"])
    return graph_ms(lambda: dit_mod._cross_mha(layer, xa, kv,
                                               cfg.attn.num_heads,
                                               kv_mask=mask2),
                    calls=2, replays=2)


def video_nfe_s(params, cfg, mode: int, inputs: tuple,
                gen: torch.Generator) -> tuple:
    """Phase 19 (e): one guided NFE at a weak ``mode`` (both CFG rows in
    one forward, as the sampler runs it) captured alone; (seconds of a
    replay between CUDA events, seconds of its first call, pool bytes)."""
    from repro_torch.core.guidance import GuidanceConfig, make_eps_fn
    g = GuidanceConfig(scale=1.5, mode_cond=mode, mode_uncond=mode)

    def nfe(p, x, t, cond, null, tm, ntm):
        return make_eps_fn(p, cfg, cond, null, g, tm, ntm,
                           attn_backend="pallas")(x, t)[0]

    runner = graphs.capture(nfe)
    x = randn(gen, (1,) + tuple(cfg.dit.latent_shape))
    t = torch.full((1,), 500.0, device=DEV)
    args = (params, x, t) + inputs
    _, first_ms = cuda_ms(lambda: runner(*args))
    pool = graphs.stats([runner])["graph_pool_bytes"]
    _, ms = cuda_ms(lambda: runner(*args))
    return ms / 1e3, first_ms / 1e3, pool


def video_references(ref_pipe, plans: dict, x_T: dict, x0: dict, kw: dict,
                     smi: str) -> dict:
    """Phase 19 (c): each plan on the blocked backend and with the planted
    fault, eagerly (``graphs.disabled()``: no pool beside them); by plan,
    (||x0 - ref|| / ||ref||, the same for the fault)."""
    readings = {}
    with graphs.disabled():
        for name, plan in plans.items():
            t1 = time.perf_counter()
            ref = ref_pipe.sample(dataclasses.replace(
                plan, attn_backend="xla-blocked"), 1, None, x_T=x_T[name],
                **kw).x0
            torch.cuda.synchronize()
            ref_s = time.perf_counter() - t1
            sound = ops.kernel_kwargs
            ops.kernel_kwargs = _stop_tile_walk_halfway(sound)
            try:
                faulty = ref_pipe.sample(plan, 1, None, x_T=x_T[name], **kw).x0
            finally:
                ops.kernel_kwargs = sound
            readings[name] = (rel_err(x0[name], ref), rel_err(faulty, ref))
            log(f"[video] (c) {name}: ||x0 - blocked|| / ||blocked|| "
                f"{readings[name][0]:.3e}, planted fault (tile walk stops "
                f"halfway) {readings[name][1]:.3e} (tol {VIDEO_X0_TOL}); the "
                f"blocked reference in {ref_s:.1f}s ({smi})")
    return readings


def phase_video(smi: str, beside: tuple = ()) -> dict:
    """Phase 19 (see the module docstring). ``beside``: ``ServeCli``
    arguments of other phases' command lines, started with the blocked
    references and checked after them."""
    from repro_torch.core.flexify import merge_lora
    from repro_torch.core.scheduler import dit_nfe_flops
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(VIDEO_SEED)
    errors = []
    # (b), (f): the kernel first, while the card is empty
    shapes, worst = video_kernel(gen, smi, errors)
    # (a) the weights, the text and its masks, the priors
    t1 = time.perf_counter()
    params, cfg = trained_like_t2i(gen, "video-dit")
    n_params = sum(a.numel() for a in tree_leaves(params))
    pipe = FlexiPipeline(params, cfg, linear_schedule(1000), device=DEV)
    del params
    text = randn(gen, (1, cfg.dit.text_len, cfg.dit.text_dim))
    tmask = torch.zeros((1, cfg.dit.text_len), dtype=torch.bool, device=DEV)
    tmask[:, :VIDEO_TEXT_KEEP] = True
    null_mask = torch.zeros_like(tmask)
    null_mask[:, 0] = True
    kw = dict(cond=text, text_mask=tmask, null_text_mask=null_mask)
    plans = {name: SamplingPlan(**pk, attn_backend="pallas")
             for name, pk, _, _ in VIDEO_PLANS}
    x_T = {name: randn(gen, (1,) + tuple(cfg.dit.latent_shape))
           for name in plans}
    torch.cuda.synchronize()
    L = cfg.num_layers
    log(f"[video] (a) {cfg.name}: {L} layers, d={cfg.d_model}, heads="
        f"{cfg.attn.num_heads}x{cfg.attn.head_dim}, d_ff {cfg.d_ff}, latent "
        f"{cfg.dit.latent_shape} at patches {dit_mod.patch_sizes(cfg)} = "
        f"{[dit_mod.tokens_for_mode(cfg, m) for m in range(3)]} tokens, text "
        f"{cfg.dit.text_len}x{cfg.dit.text_dim} (mask keeps "
        f"{VIDEO_TEXT_KEEP}), LoRA rank {cfg.dit.lora_rank}, "
        f"{cfg.param_dtype}: {n_params:,} parameters "
        f"({n_params * 2 / 1e9:.2f} GB) in {time.perf_counter() - t1:.1f}s "
        f"({smi})")
    # (c), (d): each plan twice, the two alternating
    runs = {name: [] for name in plans}
    pools = {}
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    for rnd in range(2):
        for name, plan in plans.items():
            before = pipe.cache_stats()
            n0 = ops.flash_attention.launches
            w0 = ops.flash_attention.launches_by_variant["wgmma"]
            t1 = time.perf_counter()
            res = pipe.sample(plan, 1, None, x_T=x_T[name], **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            after = pipe.cache_stats()
            n = ops.flash_attention.launches - n0
            w = ops.flash_attention.launches_by_variant["wgmma"] - w0
            fwd = forward_calls(plan, cfg)
            if not n == w == L * fwd:
                errors.append(f"(c) {name}: flash launches {n} ({w} wgmma), "
                              f"expected {L} x {fwd} forwards, all wgmma")
            if rnd == 0:
                pools[name] = after["graph_pool_bytes"] - before["graph_pool_bytes"]
            elif (after["compiled"], after["captured"]) != \
                    (before["compiled"], before["captured"]):
                errors.append(f"(d) {name}: the second call built or captured: "
                              f"{before} -> {after}")
            runs[name].append(dict(x0=res.x0, wall=wall, flops=res.flops,
                                   rel=res.relative_compute))
    launches = ops.flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    stats = pipe.cache_stats()
    if (stats["compiled"], stats["captured"]) != (len(plans), len(plans)):
        errors.append(f"(d) runners {stats}: one built and captured a plan")
    shape = (1,) + tuple(cfg.dit.latent_shape)
    for name, pk, phases, rel in VIDEO_PLANS:
        plan = plans[name]
        first, again = runs[name]
        got_phases = plan.resolve_schedule(cfg).phases
        ledger = first["flops"] / dataclasses.replace(plan, budget=1.0).flops(cfg)
        if tuple(first["x0"].shape) != shape or \
                not torch.isfinite(first["x0"]).all():
            errors.append(f"(c) {name}: x0 not finite or not {shape}")
        if not torch.equal(again["x0"], first["x0"]):
            errors.append(f"(d) {name}: the replayed runner's x0 differs "
                          f"from its first call's")
        if got_phases != phases or round(first["rel"], 3) != rel or \
                abs(ledger - first["rel"]) > 1e-12:
            errors.append(f"(e) {name}: phases {got_phases}, relative "
                          f"compute {first['rel']} (ledger {ledger}), expected "
                          f"{phases} and {rel}")
        log(f"[video] (c) {name} plan {pk} (phases {got_phases}, relative "
            f"compute {first['rel']:.4f}, host ledger {ledger:.4f}): first "
            f"call (eager, then captured) {first['wall']:.2f}s, replay "
            f"{again['wall']:.2f}s a sample (x0 bit for bit: "
            f"{torch.equal(again['x0'], first['x0'])}); flash launches "
            f"{L} x {forward_calls(plan, cfg)} a call; pool "
            f"{pools[name] / 1e9:.2f} GB; max|x0| "
            f"{first['x0'].float().abs().max().item():.3f} ({smi})")
    log(f"[video] (d) runners {stats}; flash launches {launches}, by variant "
        f"{dict(ops.flash_attention.launches_by_variant)}; peak memory "
        f"{peak / 1e9:.2f} GB allocated, {peak_reserved / 1e9:.2f} GB "
        f"reserved ({smi})")
    x0 = {name: r[0]["x0"] for name, r in runs.items()}
    replay_s = {name: r[1]["wall"] for name, r in runs.items()}
    del runs, res
    # (e) a replayed NFE at each weak mode, captured alone (the plans'
    # pools go first); the mode-0 NFE from each plan's replay less its
    # weak NFEs (a mode-0 NFE alone would cost an eager call and a replay,
    # ~9 s, which the script's time limit cannot spare)
    params = pipe.params
    del pipe
    free_card()
    inputs = (text, torch.zeros_like(text), tmask, null_mask)
    nfe_s, cross = {}, {}
    for mode in (1, 2):
        p = merge_lora(params, cfg, mode)
        nfe_s[mode], first_s, pool = video_nfe_s(p, cfg, mode, inputs, gen)
        log(f"[video] (e) NFE at mode {mode} "
            f"({dit_mod.tokens_for_mode(cfg, mode)} tokens, 2 rows), captured "
            f"alone: replayed {nfe_s[mode]:.3f} s (its first call, eager and "
            f"captured, {first_s:.3f} s), pool {pool / 1e9:.2f} GB ({smi})")
        del p
        free_card()
    from_plans = {}
    for name, _, phases, _ in VIDEO_PLANS:
        n0 = dict(phases)[0]
        weak = sum(n * nfe_s[m] for m, n in phases if m)
        from_plans[name] = (replay_s[name] - weak) / n0
    nfe_s[0] = statistics.mean(from_plans.values())
    log(f"[video] (e) NFE at mode 0 ({dit_mod.tokens_for_mode(cfg, 0)} tokens, "
        f"2 rows): each plan's replay less its weak NFEs, " + ", ".join(
            f"{n} {v:.3f} s" for n, v in from_plans.items())
        + f"; mean {nfe_s[0]:.3f} s ({smi})")
    for mode in range(3):
        cross[mode] = video_cross_ms(params, cfg, mode, (tmask, null_mask), gen)
        flop = 2 * dit_nfe_flops(cfg, mode)
        log(f"[video] (e) mode {mode}: {flop / nfe_s[mode] / 1e12:.1f} TFLOP/s "
            f"against 2 x dit_nfe_flops = {flop / 1e12:.1f} TFLOP a replayed "
            f"NFE of {nfe_s[mode]:.3f} s; cross-attention {cross[mode]:.3f} ms "
            f"a layer, {cross[mode] * L / (nfe_s[mode] * 1e3):.1%} of the NFE "
            f"({smi})")
    free_card()
    # (c) the references: the same plans on the blocked backend, and the
    # planted fault, eagerly (graphs.disabled(): no pool beside them)
    ref_pipe = FlexiPipeline(params, cfg, linear_schedule(1000), device=DEV)
    del params
    clis = [ServeCli(*args) for args in beside]
    with contextlib.ExitStack() as stack:
        for cli in clis:
            stack.callback(cli.stop)
        readings = video_references(ref_pipe, plans, x_T, x0, kw,
                                    smi + (", beside the command lines"
                                           if clis else ""))
        for cli in clis:
            cli.check(smi)
    del ref_pipe
    free_card()
    bad = {n: r for n, r in readings.items()
           if not r[0] <= VIDEO_X0_TOL < r[1]}
    if bad:
        errors.append(f"(c) x0: sound reading over {VIDEO_X0_TOL} or the "
                      f"planted fault under it: {bad}")
    secs = time.perf_counter() - t0
    log(f"[video] phase 19 in {secs:.1f}s ({smi})")
    if errors:
        raise AssertionError("phase 19: " + "; ".join(errors))
    return {"launches": launches, "shapes": shapes, "max_abs_err": worst,
            "seconds": secs, "nfe_s": nfe_s}


def free_card() -> None:
    """Release what the last phase held on the card: its runners' CUDA
    graph pools go with their pipelines (a cycle among a phase's objects
    waits for the cyclic collector)."""
    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    if sys.argv[1:] == ["--only", "sharded"]:     # phase 15 alone, for work on it
        phase_build()
        got = phase_sharded_train(smi)
        print(smi)
        print(json.dumps({"only": "sharded", "ok": True, **got}), flush=True)
        return
    if sys.argv[1:] == ["--only", "graphs"]:      # phases 8 and 17 alone
        phase_build()
        phase_t2i_flow(torch.Generator(device=DEV).manual_seed(SEED + 2), smi)
        free_card()
        got = phase_graphs(smi)
        print(smi)
        print(json.dumps({"only": "graphs", "ok": True, **got}), flush=True)
        return
    if sys.argv[1:] == ["--only", "lm"]:          # phases 11-13 alone
        phase_build()
        got = {"lm": phase_lm(torch.Generator(device=DEV).manual_seed(SEED + 5), smi)}
        free_card()
        got["families"] = phase_lm_families(
            torch.Generator(device=DEV).manual_seed(SEED + 7), smi)
        free_card()
        got["lm_train"] = phase_lm_train(
            torch.Generator(device=DEV).manual_seed(SEED + 8), smi)
        log(f"[walls] phases 11 / 12 / 13: {got['lm']['seconds']:.1f} / "
            f"{got['families']['seconds']:.1f} / {got['lm_train']['seconds']:.1f} s")
        print(smi)
        print(json.dumps({"only": "lm", "ok": True, **{
            k: {kk: vv for kk, vv in v.items() if isinstance(vv, (int, float))}
            for k, v in got.items()}}), flush=True)
        return
    if sys.argv[1:] == ["--only", "train"]:       # phases 9 and 13 alone
        phase_build()
        got = {"train": phase_training(
            torch.Generator(device=DEV).manual_seed(SEED + 3), smi)}
        free_card()
        got["lm_train"] = phase_lm_train(
            torch.Generator(device=DEV).manual_seed(SEED + 8), smi)
        print(smi)
        print(json.dumps({"only": "train", "ok": True, **{
            k: {kk: vv for kk, vv in v.items() if isinstance(vv, (int, float))}
            for k, v in got.items()}}), flush=True)
        return
    if sys.argv[1:] == ["--only", "fleet-groups"]:  # phase 18 alone
        phase_build()
        got = phase_fleet_groups(smi)
        print(smi)
        print(json.dumps({"only": "fleet-groups", "ok": True, **got}),
              flush=True)
        return
    if sys.argv[1:] == ["--only", "video"]:       # phase 19 alone
        phase_build()
        got = phase_video(smi)
        print(smi)
        print(json.dumps({"only": "video", "ok": True, "seconds": got["seconds"],
                          "launches": got["launches"], "nfe_s": got["nfe_s"],
                          "shapes": got["shapes"]}), flush=True)
        return
    if sys.argv[1:] == ["--only", "plan"]:        # phase 16 alone
        phase_build()
        got = phase_plan(smi)
        print(smi)
        print(json.dumps({"only": "plan", "ok": True, **got}), flush=True)
        return
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    gen_new = torch.Generator(device=DEV).manual_seed(SEED + 1)
    gen_t2i = torch.Generator(device=DEV).manual_seed(SEED + 2)
    gen_hd256 = torch.Generator(device=DEV).manual_seed(SEED + 4)
    gen_fam = torch.Generator(device=DEV).manual_seed(SEED + 6)
    phase_build()
    worst = phase_kernel_checks(gen, gen_new)
    worst = max(worst, phase_t2i_kernel_checks(gen_t2i))
    worst = max(worst, phase_hd256_kernel_checks(gen_hd256))
    worst = max(worst, phase_family_kernel_checks(gen_fam))
    worst_new = phase_new_kernel_checks(gen, gen_new)
    main_path = phase_main_path(gen)
    pipe = main_path.pop("pipe")
    launches = phase_tokenizer(gen, pipe)
    launches.update(phase_mamba_layer(gen))
    times = phase_timing(gen)
    times["shapes"].update(phase_hd256_timing(gen_hd256))
    times["shapes"].update(phase_family_timing(gen_fam))
    free_card()
    new_times = phase_new_timing(gen)
    serving = phase_serving(pipe, smi)
    adaptive = phase_adaptive(pipe, smi)
    telemetry = phase_telemetry(pipe, smi)
    fleet = phase_fleet(pipe, smi)
    del pipe
    free_card()
    t2i = phase_t2i_flow(gen_t2i, smi)
    free_card()
    training = phase_training(torch.Generator(device=DEV).manual_seed(SEED + 3),
                              smi)
    free_card()
    lm = phase_lm(torch.Generator(device=DEV).manual_seed(SEED + 5), smi)
    free_card()
    families = phase_lm_families(torch.Generator(device=DEV).manual_seed(SEED + 7), smi)
    free_card()
    lm_train = phase_lm_train(torch.Generator(device=DEV).manual_seed(SEED + 8), smi)
    free_card()
    seq_parallel = phase_seq_parallel(smi)
    times["shapes"].update(seq_parallel["shapes"])
    free_card()
    sharded = phase_sharded_train(smi)
    free_card()
    plan = phase_plan(smi, sharded["bytes"])
    free_card()
    graphs_run = phase_graphs(smi)
    free_card()
    fleet_groups = phase_fleet_groups(smi, cli=False)
    free_card()
    # phases 14's and 18's command lines run beside phase 19's references
    video = phase_video(smi, beside=(SP_SERVE_CLI, FG_SERVE_CLI))
    times["shapes"].update(video["shapes"])
    log(f"[walls] phases 11 / 12 / 13 / 14 / 15 / 17 / 18 / 19: "
        f"{lm['seconds']:.1f} / {families['seconds']:.1f} / "
        f"{lm_train['seconds']:.1f} / {seq_parallel['seconds']:.1f} / "
        f"{sharded['seconds']:.1f} / {graphs_run['seconds']:.1f} / "
        f"{fleet_groups['seconds']:.1f} / {video['seconds']:.1f} s ({smi})")
    paths = {"pipeline": main_path["launches"], "engine": serving["launches"],
             "t2i_flow": t2i["launches"], "adaptive": adaptive["launches"],
             "telemetry_waves": telemetry["launches"],
             "train_then_serve": training["launches"], **fleet["launches"],
             "lm_serving": lm["launches"], "lm_families": families["launches"],
             "lm_train_then_serve": lm_train["launches"],
             "seq_parallel": seq_parallel["launches"],
             "sharded_train_then_serve": sharded["launches"],
             "plan": plan["launches"], "fleet_groups": fleet_groups["launches"],
             "video": video["launches"]}
    kernels = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/attention/flash_attention.py:46",
        "launches": sum(paths.values()), "launches_by_path": paths,
        "max_abs_err": max(worst, serving["max_abs_err"], video["max_abs_err"]),
        "ms": times["ms"], "prev_ms": times["prev_ms"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "library_ms": times["library_ms"], "shapes": times["shapes"]}]
    sources = {"patch_embed": ("patch_embed.cu", "patch_embed/patch_embed.py:25"),
               "patch_deembed": ("patch_embed.cu", "patch_embed/patch_embed.py:60"),
               "ssd_chunk": ("ssd_chunk.cu", "ssd/ssd_chunk.py:28")}
    for name, (src, tpu) in sources.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{src}",
                        "replaces": f"src/repro/kernels/{tpu}",
                        "launches": launches[name], "max_abs_err": worst_new[name],
                        **new_times[name]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
