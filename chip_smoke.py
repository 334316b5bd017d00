"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Runs from the repository root (it imports ``repro_torch`` from ``src/``),
builds the Hopper kernels from the sources in the checkout, and fails with
a nonzero exit code if there is no CUDA device, a kernel does not build,
launch or agree with its plain PyTorch version, or the simulation goes
wrong. Phases, one line each:

1. the card (``nvidia-smi`` name and power limit), torch version, TF32 off;
2. the kernel build and its seconds;
3. each kernel against its plain version on real Sedov 64³ pair blocks
   (C = 40, a chunk of 8,192 pairs around the blast centre), bit for bit on
   every output slot, live or dead; the same on the pair blocks of Sedov 6³
   (C = 88, the reference's conformance size); ``density_pair_cells`` (the
   density entry that gathers through the pair list as it loads) bit for bit
   the block entry on the same pairs; the pair momentum antisymmetry; and a
   padded, masked pair list contributing +0.0;
3b. the density → ghost → force chain (``engine.compute_accelerations``,
   through the pair kernels) against the port's O(N²) oracle
   (``sph.ref_nsquared``), both on the card, at a 16³ lattice (4,096
   particles) with random velocities: the engine test's tolerances;
4. kernel times (``cuda_time_ms``: calls back to back between two CUDA
   events, the card given a head start) at the full pair list
   (P = 307,328), beside the bound (the live slots' work; for the density
   the fused route's bytes) and the plain version's time; for the density
   the fused entry (the main path's), the block entry, and the old route
   (the gather, then the block entry), with the elements within reach and
   the share of the element phase its lanes spend waiting on the busiest;
5. the main path: Sedov 64³ through the hierarchical time-bin ladder
   (``build_simulation(SimulationSpec(integrator="timebin"))``, max_depth
   cut to 4, see MAIN_MAX_DEPTH) for two cycles, with the kernels' launch
   counts read around it; then the same small runs (Sedov 10³ and 6³ at
   depth 4) on the card and on the CPU, compared;
5c. (run after 6e) the main path observed: the same run with
   ``observe=True``, traced with the telemetry rows off (the fences
   alone), and untraced again; each bit for bit phase 5 with its launches;
   the trace valid, the JSONL log read back equal, the record's ledgers
   the engine's probes, cost ratios present; the traced, fences-only and
   untraced walls, what the fences and the telemetry cost, the schema-v3
   record's span count, wall by phase, dead time and device-metrics
   summary; then the trace rendered by ``repro_torch.analysis.report``;
6. the global-dt engine on the same initial conditions, 3 steps, with the
   kernels' launch counts read around it;
6b. the global × distributed quadrant (``build_simulation(SimulationSpec(
    integrator="global", backend="distributed", ranks=4))``, the ranks
    stacked on the card) at Sedov 48³ (cut from 64³: see DIST_NSIDE): the
    decomposition once (task graph, partition, plan: host seconds, each
    rank's work, cells and particles, cut edges, halo sizes and bytes),
    then 3 steps from one state with each halo scheme (``make_dist_step``
    from that plan) and through the API, each step's host seconds, device
    span and launches read around it; the schemes and the API bitwise
    equal, one launch of each pair kernel a step, and the local global-dt
    engine tracked within the reference's conformance contract;
6c. the same run twice at Sedov 16³, bitwise; 6d. the card against the
    CPU at Sedov 10³, within 1e-4 of each field's scale;
6e. the time-bin × distributed quadrant (``build_simulation(SimulationSpec(
    integrator="timebin", backend="distributed", ranks=4,
    transport="collective"))``, one extended state per rank on the card,
    activity-aware halos) at Sedov 48³ (cut as 6b), depth 4, two cycles:
    the decomposition's seconds, K, H, the cut and its rounds; per cycle
    the wall, depth, sub-steps, updates, shipped against full halo slots,
    repartitions, launches and the wire's counters; gated bit for bit
    against the local ladder, on each pair kernel's launches (once per
    rank per force sub-step), on finite state and energy drift; then the
    same spec at ``residency="device"`` (``tbdist_resident``: the ranks'
    states stacked and resident on the card for the cycle, one fused
    program a sub-step), built on the host run's decomposition: bit for
    bit the host residency's state and stats, each pair kernel launched
    once per force sub-step for all ranks, no state byte to the host
    inside a cycle; the cycle walls and, from one profiled cycle each, the
    device's idle share beside host residency's; then at Sedov 16³ the
    host wire and both collective modes bitwise equal, a run twice
    bitwise, the device residency in both modes bitwise the host
    residency and twice bitwise, and at Sedov 10³ the card against the
    CPU;
6g. the same 48³ spec at ``schedule="device"`` (``tbdist_device_schedule``,
    one line per K = 1 and 2, on the host run's decomposition): each
    segment's programs under the CUDA sync debug mode (a host read inside
    raises), bit for bit the host schedule's state and stats, each pair
    kernel launched ``nsub_static`` times a cycle (dead trips too, plus
    any replay's sub-steps) and the block entry never, no intra-segment
    byte, 0 aborts at K = 1; the walls, the aborts and the flag that
    tripped, and a profiled segment's idle share beside the host
    schedule's; then ``tbdist_segments`` at Sedov 16³, 4 cycles against
    the host schedule, bit for bit: a hot Sedov in one 4-cycle segment
    (bins deepen inside it, no abort), Kelvin–Helmholtz (a crossing
    aborts it, the replay bit for bit) and a NaN poisoned into a K = 1
    run (each later segment aborts on the sentinel and replays);
6f. ``python -m repro_torch.observability``'s default run (time-bin ×
    distributed, collective wire, host residency, 4 ranks) at Sedov 16³
    in process, untraced, traced, fences-only and untraced again: bit for
    bit, the same program signatures and launches, the CLI's checks
    (trace, rows, record against the probes, per-rank per-phase work),
    finite imbalance and dead time; then ``dump --inject-nan`` (the NaN sentinel trips, the
    bundle validates) and ``advise`` over the metrics log; then the same
    at ``--residency device``, untraced and traced (bit for bit, the CLI's
    checks, per-rank work from the in-program rows, ``cost_calibration``
    present) and the CLI itself;
7. run-twice bitwise determinism of a one-cycle Sedov 16³ run;
7b. fleet serving (``python -m repro_torch.fleet``'s serve path, traced,
    ``--assert-compiles``): 16 requests, Sedov and Kelvin-Helmholtz
    alternating (``--scenario mixed``), 32³ each, 4 steps, submitted in
    bursts of 3, 7 and 6; each shape group served as stacked lanes. Gated:
    every request done; each entry point built once, seeing one input
    signature; the trace valid with one row per ``request_id``; each pair
    kernel launched ``2·steps`` times per shape group (one stacked init,
    ``steps − 1`` re-inits, ``steps`` batched steps) against the runner's
    own record; then every request bit for bit its single run on the card,
    those runs launching each kernel ``(2·steps + 1)`` times a request.
    Prints the fleet's wall and particle-steps/s against the single runs',
    the host seconds by phase (build, re-bin and stack, steps, results),
    buckets, padding lanes, pool hits and latency p50/p95;
7c. one batched step of 8 lanes (the 64³ main path's kernel shape)
    against one lane's, CUDA events, lane 0 bit for bit;
7d. a small fleet (4 mixed requests at 10³, 3 steps) on the card and on
    the CPU, within 1e-4 of each field's scale;

and for the serving slices (``python -m repro_torch.launch.serve``),
zamba2-1.2b (Mamba-2 + shared attention), falcon-mamba-7b (Mamba-1) and
the dense-attention models granite-8b (GQA 4:1, hd 128), gemma-7b (hd 256,
GeGLU, (1 + w) norms) and gemma3-27b (5:1 local:global, window 1024,
qk-norm; depth cut, see GEMMA3_LAYERS), the enc-dec seamless-m4t-large-v2
(24 encoder layers, bidirectional; 24 decoder layers with cross-attention
to the encoder's output), the VLM internvl2-2b (256 patch embeddings
before the prompt, GQA 2:1 at hd 128) and the MoE models mixtral-8x7b and
mixtral-8x22b (8 experts, top-2 routing into capacity buffers; attention
with a window of 4,096 at GQA 32/8 and 48/8; depth cut, see MOE_LAYERS):

8. ``ssd_scan``, ``flash_attention`` and ``selective_scan`` against their
   plain versions at the serve paths' shapes (B = 4, S = 2048: zamba2's
   attention, granite's, gemma-7b's at hd 256 and gemma3's windowed local
   layers), plus a GQA + window case, ragged lengths and a soft-capped
   case at hd 256 (with an initial state for the scans), and attention
   without a mask as seamless's encoder and cross-attention take it (S = T,
   S > T, S < T) and at internvl2's causal 2,304 rows
   (``encdec_flash_cases``), and the mixtrals' windowed GQA attention
   with 32/8 and 48/8 heads and one 6,144-token sequence where the window
   bites (``moe_flash_cases``);
   each kernel run twice, bitwise equal;
9. their times beside the bound, the plain version's time and, for
   attention, ``scaled_dot_product_attention`` on the same tensors (a
   yardstick the port never calls; K and V repeated to the query heads
   outside the timed call, an explicit mask for a window); the bound of
   attention and of the SSD scan is their work at f32 accuracy on the
   tensor cores (three TF32 products each) or their bytes, with the f32
   FMA figure beside it;
10. the serve path of each model at full width (random weights from a
    seeded generator), 4 prompts of 2048 tokens, prefill then 31 greedy
    decode steps (each step timed, and the whole decode window), with
    every LM kernel's launch count set to 0 just before and read just
    after the prefill and the decode loop (a dense model launches
    ``flash_attention`` once a layer in prefill, nothing in decode); the
    rolling map and the peak memory; the full-width prefill run twice
    gives bitwise equal logits; each model's parameters are freed before
    the next phase; seamless's encoder takes frames as long as the
    prompt, internvl2's cache holds its patches; a mixtral's line holds its
    prefill's per-expert token counts and aux loss, summed over layers;
11. each model's reduced configuration (and qwen1.5-32b's, whose full
    size does not fit the card in f32) on the card and on the CPU,
    teacher-forced prefill and 8 decode steps plus greedy generation,
    compared (seamless with ``ENC_CPU_LEN`` encoder frames, not the
    prompt's length, so that cross-attention has S ≠ T; the mixtrals'
    window of 64 bites in the prompt of 100 and their caches roll);

and in bf16, the reference's default dtype (phases 8–11 stay f32):

12. each kernel's bf16 entry against its plain version on the same bf16
    inputs (``BF16_REL``, ``BF16_FLASH_RTOL``): attention at zamba2's hd
    64, granite's hd 128 GQA, gemma-7b's hd 256 with and without a
    soft-cap, gemma3's windowed local layers, qwen1.5-32b's 40/40 at B = 1,
    ragged S and T ≠ S, and the enc-dec, VLM and MoE cases of phase 8; both
    scans at the serve shapes and ragged with an initial state; bf16 out
    on both sides, each run twice bitwise; the Mamba-1 scan's bf16 entry
    also bit for bit the f32 entry on the same values widened (h, and y
    rounded once to bf16) at both falcon shapes;
13. their times beside the bf16 bound, the plain version's time, the f32
    entry's on the same shapes and ``scaled_dot_product_attention`` in
    bf16 on the same tensors; beside each attention row and both bf16 scan
    rows the registers, spill bytes and dynamic shared memory of the
    kernel that ran (the SSD's at zamba2's N = hp = 64:
    ``ssd_bf16_hopper``; the Mamba-1 scan's
    ``selective_scan_bf16_hopper``, with its CTAs an SM and the floor of
    its exponentials, one a state-step at 16 a clock an SM at the card's
    highest SM clock, and its share of that floor), and beside the SSD row
    its time at batch 1;
14. every model served in bf16 at full width (``BF16_SERVE``): zamba2
    with and without ``ssm_bf16``, falcon-mamba-7b, granite-8b, gemma-7b,
    gemma3-27b at all 62 layers, qwen1.5-32b at full size and batch 1,
    seamless-m4t-large-v2, internvl2-2b and the mixtrals (``MOE_LAYERS``);
    gated as phase 10 on each entry's launches (the bf16 flash entry once
    an attention layer, the bf16 SSD entry 38 only under ``ssm_bf16``,
    falcon's scan through the f32 entry, nothing in decode), the prefill
    twice bitwise and finite bf16 logits; beside each, phase 10's f32
    figures of the same model;
15. each reduced configuration in bf16 on the card and on the CPU,
    teacher-forced over 8 prompts, against the CPU's f32 run of the same
    parameters: at every step the card's RMS distance from the CPU's bf16
    at most twice the CPU's bf16-vs-f32 RMS distance (the mixtrals: over
    all steps at once, as tests/test_torch_lm_bf16.py holds them);

and for the training slice (``python -m repro_torch.launch.train``), f32:

16. the backward of the f32 flash entry (``flash_attention_bwd``, a
    library of its own) against the plain version's autograd on the same
    tensors: dQ, dK, dV within ``BWD_RTOL`` of each gradient's scale, the
    forward's LSE within it and +inf exactly on the rows with no live key,
    each case run twice bitwise, at granite-8b's train (8 × 256) and serve
    shapes, gemma-7b's hd 256 with and without a soft-cap, gemma3-27b's
    local window, seamless's cross-attention without a mask (S ≠ T) and
    ragged S below and above T (``bwd_cases``); beside each its route,
    its time, its bound (5 products a live pair under 3×TF32) and its
    route's (the same products in the serving kernel's arithmetic: 3×bf16
    for ``flash_bwd_hopper``), the plain backward's and f32
    ``scaled_dot_product_attention``'s backward; then the same cases in
    bf16 (``flash_attention_bwd_bf16`` after ``flash_attention_bf16`` with
    its LSE): each gradient within 2 × the plain bf16 backward's own RMS
    distance from the plain f32 backward, the output with the LSE bit for
    bit the one without it, its bound in one bf16 pass a product, bf16
    SDPA's backward beside, and what serves it (at hd 64, 128, 256
    ``flash_bwd_bf16_hopper``, one launch after D, 5 products a live pair:
    its registers, spills, shared memory, CTAs an SM, grid and the bytes
    its design moves, the dQ workspace's traffic among them);
16b. the scans' backward kernels (``selective_scan_bwd``,
    ``ssd_scan_bwd``, each a library of its own) against their plain
    versions on the same tensors, every gradient within 2e-4 of its scale,
    twice bitwise, at each scan's train shape (falcon-mamba-7b's 8 × 256 ×
    8,192 with N 16; zamba2-1.2b's 8 × 256 with 64 heads of hp = N = 64), a
    ragged S with h0 and the final state's gradient given, and the reduced
    widths; beside each its time, its bound (bytes against operations at
    the f32 peak, or 3×TF32 for ``ssd_scan_bwd``, the route's arithmetic:
    split-TF32 ``mma.sync``; and the exponentials), what bounds the design
    (its exponentials at the MUFU rate, its bytes with the scratch it
    writes and reads back), the plain backward's time, each kernel's
    registers, spills, shared memory and CTAs an SM; then the bf16 entry's
    backward (``ssd_scan_bwd`` on bf16 u, B, C and dy, the C entry
    ``ssd_scan_bwd_bf16``) at the same three cases against the plain
    backward on the same bf16 tensors: du, dB and dC (bf16, each rounded
    once) within one bf16 rounding plus 2e-4 of scale, the f32 gradients
    within 2e-4, twice bitwise, its time beside the f32 entry's on the same
    values widened, its bound with the stream tensors' bytes in bf16; at
    (N, hp) = (64, 64) the route that serves it is the Hopper pair
    (``ssd_bwd_states_bf16_hopper``, ``ssd_bwd_chunks_bf16_hopper``), its
    own bound beside (one bf16 pass for the products of two stream
    tensors, two for those with an f32 operand, at the bf16 peak), and the
    design's bytes count the scratch and the dB / dC partials;
17. granite-8b trained at full width, 16 of its 36 layers
    (``TRAIN_LAYERS``), f32, batch 8 × 256, 4 steps through
    ``init_train_state`` and ``make_train_step`` (``train_steps``), every LM
    kernel's launch count set to 0 before the run and read around each step
    (44 forward and 16 backward flash launches a step, no scan:
    ``train_expected_launches``), the last step profiled: step wall,
    tokens/s, the share of the f32 peak (the flops the step runs, each
    layer's forward counted as often as the remat runs it, over the wall;
    also ``model_flops × remat_overhead`` over the wall, the reference's
    estimate), peak memory, the card's idle share, each LM kernel entry's
    device ms and launches by the trace's kernel names, every backward
    launch of the trace ``flash_bwd_hopper``; the first step
    taken again from a fresh draw of the same state, bitwise; then
    ``FaultTolerantLoop`` at the same width cut to ``LOOP_LAYERS`` (the
    checkpoints of 16 layers, 44 GB each, do not fit a 75 GB disk twice), a crash
    injected at step 3, restored from the step-0 checkpoint and replayed:
    the repeated steps and the final parameters bitwise an uninterrupted
    run's; then the Mamba kinds the same way (``MAMBA_TRAIN``): zamba2-1.2b
    uncut (111 ``ssd_scan`` and 38 ``ssd_scan_bwd`` launches a step, its
    shared attention 18 flash forwards and 6 backwards through
    ``flash_bwd_hopper`` at hd 64) and falcon-mamba-7b at every published
    width cut to 32 of 64 layers (88 ``selective_scan``, 32
    ``selective_scan_bwd``), each scan's forward and backward device ms a
    step (``ssd_scan_bwd``'s by both of its kernels' names); then the
    mixtrals in f32 at every published width cut in depth (``MOE_TRAIN``:
    8x7b 2 of 32 layers, 8x22b 1 of 56), each step's summed expert counts
    and, after the steps, each layer's dropped share and the aux loss, the
    share of the peak with the experts' E·G·cap rows; and granite-8b in
    bf16 at 24 of 36 layers (``GRANITE_BF16_LAYERS``: bf16 weights and
    gradients, f32 moments; the bf16 flash entry and its backward), its
    share of the bf16 peak; and zamba2-1.2b uncut in bf16 under the
    reference's ``ssm_bf16`` variant (111 ``ssd_scan_bf16`` and 38
    ``ssd_scan_bwd_bf16`` launches a step, two kernels a backward call in
    the trace, beside 18 bf16 flash forwards and 6 backwards); each
    profiled step's top kernels by device time;
18. granite-8b, gemma-7b, gemma3-27b, seamless-m4t-large-v2, zamba2-1.2b,
    falcon-mamba-7b and both mixtrals reduced (hd 16 and 32: the mma.sync
    backward), and granite-8b reduced at hd 128 (``flash_bwd_hopper``), 3
    train steps on the card and on the CPU (one PyTorch thread) from the
    same parameters and batches: each loss and gradient norm, the first
    step's gradients (Adam's first moment) and the final parameters within
    1e-4 of scale, the card's steps through the kernels as phase 17 counts
    them and the flash backward's through the route of its head width;
    then every one of them in bf16, card against CPU, and in f32 on the
    CPU from the same weights widened: the card's losses, gradient norms
    and first moments within 2 × the CPU's own bf16-vs-f32 distance (the
    mixtrals' losses alone); and zamba2-1.2b reduced in bf16 under
    ``ssm_bf16`` the same way (its f32 CPU run without the variant);
19. the six examples (``examples_torch/``, the port of ``examples/``), each
    run on the card as a subprocess at a small size, all six at once: exit
    0, one line each with its wall.

All libraries are built at the start, one ``nvcc`` each, in parallel
(each wrapper's ``library()`` from its own thread, and the three
backwards' ``library_bwd()``). Every kernel time is ``cuda_time_ms``'s:
calls back to back between two CUDA events, the card given a head start
(a sleep kernel) so that a wrapper's host work does not count. Then the
``kernels`` JSON line (one row per entry: ``flash_attention`` and
``flash_attention_bf16`` and so on, and the backwards
``flash_attention_bwd``, ``flash_attention_bwd_bf16``,
``selective_scan_bwd``, ``ssd_scan_bwd`` and ``ssd_scan_bwd_bf16`` with
their launches in phase 17; ``selective_scan_bf16`` is on no
model's path, since both packages widen u before the Mamba-1 scan, so its
launches are 0 and phases 12–13 alone drive and time its kernel,
``selective_scan_bf16_hopper``), the card line, and as the last line
``{"ok": true, "device": {...}}``. Nothing is imported from JAX or from the
reference package ``repro``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.device import synchronize  # noqa: E402

# bounds: bytes over HBM3's rate against operations over the peak f32 or
# dense TF32 rate (H100 SXM data sheet, repro_torch/analysis/roofline.py)
from repro_torch.analysis.roofline import (  # noqa: E402
    HBM_BYTES_PER_S, PEAK_BF16_FLOPS, PEAK_TF32_FLOPS, Roofline)
# flash_attention and the SSD scan's chunked products (forward and
# backward) keep f32 accuracy on the tensor cores by splitting each product
# into three TF32 products
TF32_SPLIT = 3
TENSOR_CORE_KERNELS = ("flash_attention", "ssd_scan", "ssd_scan_bwd")
# f32 operations per live (i, j) element of a pair's tile, counted from
# csrc/sph_pair.cu (an FMA counts 2, sqrt and division 1 each): density
# evaluates W, dW/dr and the three sums for both directions; force adds
# the viscosity terms and the double-float contraction of both directions.
OPS_PER_ELEMENT = {"density_pair": 100, "force_pair": 240}
# parity tolerances of the CPU tests (tests/test_torch_sph_pair.py), which
# are the reference's own kernel tolerances
RTOL = {"density_pair": 2e-5, "force_pair": 5e-5}
CHUNK = 8192
NSIDE = 64
SIM_CYCLES = 2
# The main path runs the ladder at max_depth 4 (the reference's own Sedov
# conformance depth), not the default 10: at depth 10 the ladder goes
# non-finite within the first cycle on this initial condition — in the port
# (Sedov 64³, sub-step 434) and in the JAX reference (Sedov 16³, CPU).
MAIN_MAX_DEPTH = 4
# Energy drift over the two cycles: the reference's ladder itself drifts
# 7.1 % over two depth-4 cycles of Sedov 16³ (tools/timebin_drift.py, and
# the port matches it to 1e-6), so the bound is 10 %, not the 5 % of
# smaller runs.
DRIFT_BOUND = 0.10
# The global × distributed phase: Sedov 48³, not the main path's 64³. Its
# decomposition runs the partitioner, pure Python and a copy of the
# reference's, whose time grows as about the 1.4th power of the cells: ~5
# min at 64³, which would not fit the run's time limit.
DIST_NSIDE = 48
DIST_RANKS = 4
DIST_STEPS = 3
DIST_DT = 1e-5          # phase 6's

# The fleet phase (``python -m repro_torch.fleet``): 16 requests, Sedov and
# Kelvin-Helmholtz alternating, at 32³ (32,768 particles each: a 14³-cell,
# C = 40 grid, so a bucket of 8 lanes is the 64³ main path's kernel shape,
# P = 307,328), 4 steps each, submitted in bursts of 3, 7 and 6.
FLEET_NSIDE = 32
FLEET_REQUESTS = 16
FLEET_STEPS = 4
FLEET_WAVES = 3
FLEET_LANES = 8         # the batched step timed against one lane's
FLEET_REPS = 5

# The serving slices: zamba2-1.2b (ssd_scan, flash_attention) and
# falcon-mamba-7b (selective_scan).
LM_ARCH = "zamba2-1.2b"
MAMBA1_ARCH = "falcon-mamba-7b"
# The dense-attention slice at full width: granite-8b and gemma-7b uncut;
# gemma3-27b at every published width but 12 of its 62 layers, two whole
# 5:1 local:global periods (10 windowed local, 2 global). All 62 take
# ~108 GB of f32 weights, over the card's 80 GB; 12 take ~25.5 GB. Fewer
# layers make the host's share of the wall larger than at full depth.
DENSE_ARCHS = ("granite-8b", "gemma-7b", "gemma3-27b")
GEMMA3_LAYERS = 12           # published: 62
# reduced configurations only, card against CPU (phase 11): qwen1.5-32b's
# full size is ~141 GB in f32
DENSE_REDUCED_ONLY = ("qwen1.5-32b",)
# The MoE slice: mixtral-8x7b (46.7 B parameters, 1.451 B a layer) and
# mixtral-8x22b (140.6 B, 2.504 B a layer) at every published width, cut in
# depth by whole layers to what fits the card's 80 GB with room for the
# f32 draw of one expert tensor (init) and the prefill's MoE intermediates
# ((E, G·cap, d_ff) × 3 at G·cap = 2,560): f32 12 of 32 layers (~65.8 GiB
# of weights) and 6 of 56 (~57.5 GiB), bf16 24 of 32 (~65.3 GiB) and 12 of
# 56 (~56.7 GiB); their serve paths peak at 71.0, 63.3, 68.4 and 59.8 GiB
# on an H100 80GB. Their attention is GQA with a sliding window of 4,096
# (8x22b: 48/8 heads, a group of 6).
MOE_ARCHS = ("mixtral-8x7b", "mixtral-8x22b")
MOE_LAYERS = {("mixtral-8x7b", torch.float32): 12,
              ("mixtral-8x22b", torch.float32): 6,
              ("mixtral-8x7b", torch.bfloat16): 24,
              ("mixtral-8x22b", torch.bfloat16): 12}
# The enc-dec and VLM slice, both uncut in f32 and bf16 (2.03 B and 1.89 B
# parameters): seamless-m4t-large-v2's encoder runs over LM_PROMPT frames,
# as the reference's launcher draws them; internvl2-2b prefills its 256
# patches before the prompt.
ENCDEC_ARCHS = ("seamless-m4t-large-v2", "internvl2-2b")


def serve_layers(arch: str, dtype):
    """The layer cut of ``arch``'s full-width serve path in ``dtype`` (None:
    all its layers): gemma3-27b in f32 (``GEMMA3_LAYERS``), the mixtrals
    (``MOE_LAYERS``)."""
    if arch == "gemma3-27b" and dtype == torch.float32:
        return GEMMA3_LAYERS
    return MOE_LAYERS.get((arch, dtype))


# seamless's encoder frames in the card-against-CPU phases (11, 15): not the
# prompt's length, so that cross-attention runs with S ≠ T
ENC_CPU_LEN = 61
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 32
LM_SEED = 0
# kernel against plain version: the reference's kernel tolerance
# (tests/test_kernel_ssd_scan.py, test_kernel_flash_attention.py; the
# selective scan's own is tighter, 2e-5), relative to the output's scale;
# the two sum in different orders
LM_RTOL = 2e-4
# card against CPU on the reduced model: the CPU tests' pin against the JAX
# reference (tests/test_torch_lm_serve.py)
LM_CARD_CPU_RTOL = 1e-4

# The bf16 slice (phases 12–15), the reference's default dtype: every served
# model at full width (the mixtrals cut in depth, MOE_LAYERS), gemma3-27b at
# all 62 layers (50.3 GiB of bf16 weights) and qwen1.5-32b at full size
# (65.6 GiB) at batch 1: batch 4's KV cache (64 layers × 2 × 40 heads × 128
# × 2 B × 2,080 slots × 4 ≈ 10.9 GB) does not fit beside its weights on the
# card; batch 1's is ~2.7 GB.
BF16_SERVE = (("zamba2-1.2b", LM_BATCH, False), ("zamba2-1.2b", LM_BATCH, True),
              ("falcon-mamba-7b", LM_BATCH, False),
              ("granite-8b", LM_BATCH, False), ("gemma-7b", LM_BATCH, False),
              ("gemma3-27b", LM_BATCH, False), ("qwen1.5-32b", 1, False),
              ("seamless-m4t-large-v2", LM_BATCH, False),
              ("internvl2-2b", LM_BATCH, False),
              ("mixtral-8x7b", LM_BATCH, False),
              ("mixtral-8x22b", LM_BATCH, False))
# bf16 kernel against its plain version on the same bf16 inputs: the output
# within one bf16 rounding of the plain one (2^-7 of the value) plus a share
# of the scale: attention 2e-3 (the kernel rounds P to bf16 against its
# tiles' running maximum, the plain version against the row's), the scans
# LM_RTOL (f32 arithmetic from the same inputs, y rounded once)
BF16_REL = 2.0 ** -7
BF16_FLASH_RTOL = 2e-3
# card against CPU in bf16 (phase 15, the reduced configs): at each step the
# RMS of (card bf16 − CPU bf16) at most twice the RMS of (CPU bf16 − CPU
# f32), over 8 prompts (tests/test_torch_lm_bf16.py holds the CPU's bf16 to
# the reference the same way)
BF16_RATIO = 2.0
BF16_CPU_BATCH, BF16_CPU_PROMPT, BF16_CPU_STEPS = 8, 40, 8
# f32 work per live (query, key) pair beside a bf16 flash kernel's products:
# the scale, the max, the exponent's subtraction, exp2 and the sum
FLASH_F32_OPS_PER_PAIR = 5


T0 = time.perf_counter()


def say(obj: dict) -> None:
    """One JSON line, stamped with the seconds since the script started."""
    print(json.dumps(dict(obj, t_s=round(time.perf_counter() - T0, 3))),
          flush=True)


def sedov_spec(n_side: int = NSIDE, **kw):
    """The main path's Sedov spec (``alpha_visc=1.0``, ``cfl=0.15``, local
    backend); ``kw`` sets the integrator, the backend, ``max_depth``,
    ``dt`` or the distributed policy."""
    from repro_torch.sph import SimulationSpec, SPHConfig
    kw.setdefault("integrator", "timebin")
    kw.setdefault("backend", "local")
    return SimulationSpec(scenario="sedov", scenario_params={"n_side": n_side},
                          physics=SPHConfig(alpha_visc=1.0, cfl=0.15), **kw)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def sedov_setup(dev, n_side: int = NSIDE):
    """Sedov ``n_side``³ binned on the card, its full pair list, and the
    density / ghost fields the force kernel reads."""
    from repro_torch.sph import SPHConfig
    from repro_torch.sph.cellgrid import bin_particles, build_pair_list, \
        choose_grid
    from repro_torch.sph.engine import _density_pass
    from repro_torch.sph.ic import sedov_ic
    from repro_torch.sph.physics import ghost_update
    ic = sedov_ic(n_side)
    # the hot centre gets the viscosity inputs a blast has: radial motion
    d = ic["pos"] - 0.5
    ic["vel"] = (d * np.exp(-np.sum(d * d, 1) / 0.01)[:, None]).astype(
        np.float32)
    spec = choose_grid(ic["box"], float(ic["h"].max()), len(ic["pos"]),
                       capacity_margin=3.0)
    cells, _ = bin_particles(spec, ic["pos"], ic["vel"], ic["mass"],
                             ic["u"], ic["h"], device=dev)
    pairs = build_pair_list(spec, device=dev)
    cfg = SPHConfig()
    rho, drho, _ = _density_pass(cells, pairs, cfg)
    rho = torch.where(cells.mask > 0, rho, 1.0)
    drho = torch.where(cells.mask > 0, drho, 0.0)
    press, omega, cs = ghost_update(rho, drho, cells.u, cells.h)
    press = torch.where(cells.mask > 0, press, 0.0)
    return spec, cells, pairs, (rho, press, omega, cs)


def centre_chunk(spec, pairs):
    """Indices of CHUNK consecutive pairs around the blast centre's cell."""
    ns = spec.ncells_side
    c = ns // 2
    centre = (c * ns + c) * ns + c
    ci = pairs.ci.cpu().numpy()
    first = int(np.nonzero(ci == centre)[0][0])
    start = max(0, min(first - CHUNK // 2, len(ci) - CHUNK))
    return np.arange(start, start + CHUNK)


def subset(pairs, idx, ncells, dev, nlive=None):
    from repro_torch.sph.cellgrid import make_pair_list
    return make_pair_list(pairs.ci.cpu().numpy()[idx],
                          pairs.cj.cpu().numpy()[idx],
                          pairs.shift.cpu().numpy()[idx], ncells, dev,
                          nlive=nlive)


def max_err(got, want, rtol):
    """(max |got − want|, passes) under rtol with atol = rtol·max(|want|,1)."""
    err, ok = 0.0, True
    for g, w in zip(got, want):
        d = (g - w).abs()
        scale = max(float(w.abs().max()), 1.0)
        err = max(err, float(d.max()))
        ok &= bool((d <= rtol * scale + rtol * w.abs()).all())
    return err, ok


def bits_equal(got, want) -> bool:
    """Every element of every output equal as an int32 bit pattern (NaN
    for NaN, −0 for −0)."""
    return all(torch.equal(g.contiguous().view(torch.int32),
                           w.contiguous().view(torch.int32))
               for g, w in zip(got, want))


def check_force(force_in, block: str, C: int) -> float:
    """``force_pair`` against its plain version on one set of pair blocks:
    within tolerance on live slots, bit for bit on every slot, and the pair
    momentum antisymmetry. Returns the largest live-slot difference."""
    from repro_torch.kernels.sph_pair import kernel as K, ref
    worst = 0.0
    for alpha in (0.0, 1.0):
        got = K.force_pair(*force_in, alpha_visc=alpha)
        want = ref.force_pair_ref(*force_in, alpha_visc=alpha)
        mask_i, mask_j = force_in[8], force_in[17]
        masks = (mask_i[..., None], mask_i, mask_j[..., None], mask_j)
        e, ok = max_err([g * m for g, m in zip(got, masks)],
                        [w * m for w, m in zip(want, masks)],
                        RTOL["force_pair"])
        same = bits_equal(got, want)
        # Newton's third law per pair, in float64: |Σ m dv_i + Σ m dv_j|
        # against 2⁻²³ of Σ|m dv| (each dv entry is rounded once)
        wi = (force_in[7] * mask_i).double()[..., None]
        wj = (force_in[16] * mask_j).double()[..., None]
        pi = wi * got[0].double()
        pj = wj * got[2].double()
        net = (pi.sum(1) + pj.sum(1)).abs()
        scale = pi.abs().sum(1) + pj.abs().sum(1)
        ratio = float((net / scale.clamp_min(1e-300)).max())
        anti_ok = bool((net <= 2.0 ** -23 * scale + 1e-30).all())
        say({"phase": "parity", "kernel": "force_pair", "block": block,
             "alpha_visc": alpha, "pairs": int(mask_i.shape[0]), "C": C,
             "max_abs_err": e, "ok": ok, "bitwise_all_slots": same,
             "antisymmetry_max_rel": ratio, "antisymmetry_ok": anti_ok})
        assert ok, f"force_pair (alpha={alpha}) disagrees with plain version"
        assert same, f"force_pair (alpha={alpha}, {block}) is not bitwise " \
                     f"its plain version on every slot"
        assert anti_ok, "force_pair breaks pair momentum antisymmetry"
        worst = max(worst, e)
    return worst


def density_blocks(cells, pairs):
    """The density's eight (P, C[, 3]) blocks gathered through one pair
    list (what the block entry takes; the main path gathers in the
    kernel)."""
    from repro_torch.kernels.sph_pair.ref import gather_density_blocks
    return gather_density_blocks(cells.pos, cells.h, cells.mass, cells.mask,
                                 pairs.ci, pairs.cj, pairs.shift)


def check_density(cells, pairs, block: str, C: int) -> float:
    """``density_pair`` against its plain version on the blocks gathered
    through one pair list, both smoothing kernels: within tolerance and bit
    for bit on every slot; and ``density_pair_cells`` on the cell arrays and
    the list bit for bit the block entry. Returns the largest difference."""
    from repro_torch.kernels.sph_pair import kernel as K, ref
    dens_in = density_blocks(cells, pairs)
    worst = 0.0
    for kern in ("cubic", "wendland_c2"):
        got = K.density_pair(*dens_in, kernel=kern)
        want = ref.density_pair_ref(*dens_in, kernel=kern)
        fused = K.density_pair_cells(cells.pos, cells.h, cells.mass,
                                     cells.mask, pairs.ci, pairs.cj,
                                     pairs.shift, kernel=kern)
        e, ok = max_err(got, want, RTOL["density_pair"])
        same = bits_equal(got, want)
        fused_same = bits_equal(fused, got)
        say({"phase": "parity", "kernel": "density_pair", "block": block,
             "smoothing": kern, "pairs": int(pairs.ci.shape[0]), "C": C,
             "max_abs_err": e, "ok": ok, "bitwise_all_slots": same,
             "cells_entry_bitwise_block_entry": fused_same})
        assert ok, f"density_pair ({kern}) disagrees with its plain version"
        assert same, f"density_pair ({kern}, {block}) is not bitwise its " \
                     f"plain version on every slot"
        assert fused_same, f"density_pair_cells ({kern}, {block}) differs " \
                           f"from the block entry"
        worst = max(worst, e)
    return worst


def check_kernels(dev, spec, cells, pairs, thermo):
    """Phase 3: each kernel against its plain version, bit for bit on every
    slot at C = 40 and C = 88 (the density's fused entry against its block
    entry too), antisymmetry, and masked padding."""
    from repro_torch.kernels.sph_pair import ops
    idx = centre_chunk(spec, pairs)
    sub = subset(pairs, idx, spec.ncells, dev)
    force_in = ops.force_inputs(cells, sub, *thermo)
    errs = {"density_pair": check_density(cells, sub, "sedov64_centre_chunk",
                                          spec.capacity)}
    errs["force_pair"] = check_force(force_in, "sedov64_centre_chunk",
                                     spec.capacity)
    # the reference's conformance size, past the first kernels' C <= 83
    spec6, cells6, pairs6, thermo6 = sedov_setup(dev, 6)
    errs["density_pair"] = max(errs["density_pair"], check_density(
        cells6, pairs6, "sedov6_all_pairs", spec6.capacity))
    errs["force_pair"] = max(errs["force_pair"], check_force(
        ops.force_inputs(cells6, pairs6, *thermo6), "sedov6_all_pairs",
        spec6.capacity))
    # padded, masked subset (the time-bin layout) adds exactly +0.0
    live = idx[: CHUNK // 2 + 123]
    npad = 1 << int(np.ceil(np.log2(len(live))))
    padded = np.concatenate([live, np.full(npad - len(live), idx[0])])
    pm = torch.zeros(npad, dtype=torch.float32, device=dev)
    pm[: len(live)] = 1.0
    sub_live = subset(pairs, live, spec.ncells, dev)
    sub_pad = subset(pairs, padded, spec.ncells, dev, nlive=len(live))
    a = ops.density_pairs(cells, sub_live) + ops.force_pairs(
        cells, sub_live, *thermo, alpha_visc=1.0)
    b = ops.density_pairs(cells, sub_pad, pair_mask=pm) + ops.force_pairs(
        cells, sub_pad, *thermo, alpha_visc=1.0, pair_mask=pm)
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    say({"phase": "parity", "check": "padded_masked_pairs_add_zero",
         "live": len(live), "padded_to": npad, "ok": same})
    assert same, "masked padding changed the per-cell sums"
    return errs


# the head start the card gets before a timed run: a sleep kernel of this
# many clocks (~25 ms at the H100's 1.98 GHz), so that the host enqueues a
# run's calls while the card still sleeps
TIMING_HEAD_START_CYCLES = 50_000_000


def cuda_time_ms(fn, reps: int) -> float:
    """Device ms a call of ``fn``: ``reps`` calls launched back to back
    between two CUDA events, after a warm-up call. A sleep kernel first
    gives the card a head start, so the host's work in a wrapper (checks,
    allocations, the ctypes call) is done while the card sleeps and the
    events time the kernels alone, back to back; a call whose host work
    outlasts the head start (a plain version's thousands of small launches)
    is timed as the host enqueues it, which is then its cost."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(TIMING_HEAD_START_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def nbytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def force_ops_bytes(n_i, n_j, C: int):
    """Operations and bytes of ``force_pair`` as a function of the live
    slots (``n_i``, ``n_j``: each pair's live slots on either side):
    OPS_PER_ELEMENT per live (i, j) element; bytes: each live slot's inputs
    other than its mask (12 floats), every slot's mask (read to know it is
    dead) and every output slot (dv and du, both sides)."""
    P = len(n_i)
    ops = float((n_i * n_j).sum()) * OPS_PER_ELEMENT["force_pair"]
    moved = 4.0 * (12 * float((n_i + n_j).sum()) + 2 * P * C + 8 * P * C)
    return ops, moved


def density_ops_bytes(n_i, n_j, C: int, cells: int):
    """Operations and bytes of the fused ``density_pair_cells`` as a
    function of the live slots (``n_i``, ``n_j``: each pair's live slots on
    either side): OPS_PER_ELEMENT per live (i, j) element; bytes: the
    ``cells`` touched cells' slots once (pos, h, m, mask: 6 f32 a slot),
    ci, cj and shift (5 words a pair) and the six (P, C) outputs."""
    P = len(n_i)
    ops = float((n_i * n_j).sum()) * OPS_PER_ELEMENT["density_pair"]
    moved = 4.0 * (6 * cells * C + 5 * P + 6 * P * C)
    return ops, moved


def lane_waiting(hits_i, hits_j, L_i, L_j):
    """How evenly the density kernel's lanes share the elements they
    compute: ``hits_i``/``hits_j`` (P, C) each slot's elements, ``L_i``/
    ``L_j`` (P,) the live ends. Tasks go to lanes in the kernel's order
    (live rows, live columns, dead rows, dead columns), 32 a round, and a
    round lasts as long as its busiest lane. Returns (elements, the busiest
    lanes' elements summed over rounds, the share of lane slots idle)."""
    P, C = hits_i.shape
    a = torch.arange(C, device=hits_i.device)[None, :]
    li, lj = L_i.long()[:, None], L_j.long()[:, None]
    at_i = torch.where(a < li, a, lj + a)
    at_j = torch.where(a < lj, li + a, C + a)
    rounds = -(-2 * C // 32)
    tasks = hits_i.new_zeros((P, 32 * rounds))
    tasks.scatter_(1, at_i, hits_i).scatter_(1, at_j, hits_j)
    total = float(tasks.sum())
    busiest = float(tasks.view(P, rounds, 32).amax(-1).sum())
    return total, busiest, 1.0 - total / (32.0 * busiest)


def density_reach(cells, pairs, chunk: int = CHUNK) -> dict:
    """The elements the density kernel computes at this pair list: each
    slot's partners below the other side's live end within its own h (its
    superset test marks few more), and how they spread over the lanes."""
    from repro_torch.kernels.sph_pair.ref import gather_density_blocks
    from repro_torch.sph.physics import EPS, pairwise_r2, sqrt_rn
    C = cells.mask.shape[1]
    slots = torch.arange(1, C + 1, device=cells.mask.device)
    ends = torch.where(cells.mask != 0, slots, 0).amax(1)
    stats = [0.0, 0.0]
    for a in range(0, pairs.ci.shape[0], chunk):
        ci, cj = pairs.ci[a:a + chunk], pairs.cj[a:a + chunk]
        shift = pairs.shift[a:a + chunk]
        pos_i, h_i, _, _, pos_j, h_j, _, _ = gather_density_blocks(
            cells.pos, cells.h, cells.mass, cells.mask, ci, cj, shift)
        L_i, L_j = ends[ci.long()], ends[cj.long()]
        r = sqrt_rn(pairwise_r2(pos_i, pos_j) + EPS)
        below_i = slots[None, :] <= L_i[:, None]
        below_j = slots[None, :] <= L_j[:, None]
        hits_i = ((r < h_i[:, :, None]) & below_j[:, None, :]).sum(2)
        hits_j = ((r < h_j[:, None, :]) & below_i[:, :, None]).sum(1)
        total, busiest, _ = lane_waiting(hits_i.float(), hits_j.float(),
                                         L_i, L_j)
        stats[0] += total
        stats[1] += busiest
    return {"elements_within_reach": stats[0],
            "busiest_lane_elements": stats[1],
            "lane_waiting_share": 1.0 - stats[0] / (32.0 * stats[1])}


def within_reach(force_in, chunk: int = CHUNK) -> int:
    """Live (i, j) elements with r² > EPS and r < max(h_i, h_j): the only
    ones whose force terms are not all zero (the rest the kernel skips)."""
    from repro_torch.sph.physics import EPS, pairwise_r2, sqrt_rn
    n = 0
    for a in range(0, force_in[0].shape[0], chunk):
        pos_i, h_i, mask_i, pos_j, h_j, mask_j = (
            force_in[k][a:a + chunk] for k in (0, 2, 8, 9, 11, 17))
        r2 = pairwise_r2(pos_i, pos_j)
        near = sqrt_rn(r2 + EPS) < torch.maximum(h_i[:, :, None],
                                                 h_j[:, None, :])
        live = (mask_i[:, :, None] != 0) & (mask_j[:, None, :] != 0)
        n += int((live & near & (r2 > EPS)).sum())
    return n


def time_kernels(spec, cells, pairs, thermo):
    """Phase 4: kernel and plain-version times at the full pair list, with
    the bound reckoned from this run's inputs and live slots (the work each
    needs), beside the all-slot figure (every padded block read) that bound
    the first kernels. The density row is the fused entry's, which the main
    path runs, its plain version the gather and ``density_pair_ref``; the
    block entry and the old route (the gather, then the block entry) are
    timed beside it."""
    from repro_torch.kernels.sph_pair import kernel as K, ops, ref
    dens_in = density_blocks(cells, pairs)
    cell_in = (cells.pos, cells.h, cells.mass, cells.mask, pairs.ci,
               pairs.cj, pairs.shift)
    force_in = ops.force_inputs(cells, pairs, *thermo)
    occ = cells.mask.sum(1).double()
    n_i, n_j = occ[pairs.ci.long()], occ[pairs.cj.long()]
    live = float((n_i * n_j).sum())
    touched = int(torch.unique(torch.cat([pairs.ci, pairs.cj])).numel())
    rows = {}
    for name, fn, plain, args, blocks in (
            ("density_pair", K.density_pair_cells, ref.density_pair_cells_ref,
             cell_in, dens_in),
            ("force_pair", lambda *a: K.force_pair(*a, alpha_visc=1.0),
             lambda *a: ref.force_pair_ref(*a, alpha_visc=1.0), force_in,
             force_in)):
        ms = cuda_time_ms(lambda: fn(*args), reps=10)
        plain_ms = cuda_time_ms(lambda: plain(*args), reps=1)
        all_slots = nbytes(blocks) + nbytes(fn(*args))
        extra = {}
        if name == "force_pair":
            ops_n, moved = force_ops_bytes(n_i, n_j, spec.capacity)
            extra["elements_within_reach"] = within_reach(args)
        else:
            ops_n, moved = density_ops_bytes(n_i, n_j, spec.capacity,
                                             touched)
            extra["block_entry_ms"] = cuda_time_ms(
                lambda: K.density_pair(*dens_in), reps=10)
            extra["gather_then_block_entry_ms"] = cuda_time_ms(
                lambda: K.density_pair(*density_blocks(cells, pairs)),
                reps=10)
            extra.update(density_reach(cells, pairs))
        roof = Roofline(moved, ops_n)
        rows[name] = dict(ms=ms, plain_ms=plain_ms,
                          bound_ms=roof.t_bound * 1e3,
                          bound_by=roof.bottleneck,
                          bytes=moved, operations=ops_n,
                          live_slot_pairs=live,
                          all_slot_bound_ms=Roofline(
                              all_slots, ops_n).t_bound * 1e3,
                          **extra)
        say({"phase": "timing", "kernel": name, "P": int(pairs.ci.shape[0]),
             "C": spec.capacity, **rows[name],
             "share_of_bound": rows[name]["bound_ms"] / ms})
    return rows


def launch_counts(K) -> dict:
    """Each pair kernel's launches by wrapper: the density kernel has two
    entries, the fused one (the main path's) and the block one."""
    return {"density_pair_cells": K.density_pair_cells.launches,
            "density_pair": K.density_pair.launches,
            "force_pair": K.force_pair.launches}


def main_path(dev, max_depth: int = MAIN_MAX_DEPTH):
    """Phase 5: the time-bin Sedov 64³ path through the port's API."""
    from repro_torch.kernels.sph_pair import kernel as K
    from repro_torch.sph import build_simulation
    spec = sedov_spec(max_depth=max_depth)
    t0 = time.perf_counter()
    sim = build_simulation(spec, device=dev)
    synchronize(dev)
    say({"phase": "main_path_build", "particles": sim.engine.n,
         "cells": sim.engine.spec.ncells, "C": sim.engine.spec.capacity,
         "pairs": int(sim.engine.pairs.ci.shape[0]),
         "max_depth": spec.max_depth,
         "seconds": time.perf_counter() - t0})
    say({"phase": "main_path_cut", "max_depth": max_depth,
         "default_max_depth": 10,
         "reason": "the ladder goes non-finite within the first cycle at "
                   "depth 10 on this IC (port and JAX reference alike)"})
    e0, p0 = sim.diagnostics()
    K.reset_launches()
    walls = []
    for c in range(SIM_CYCLES):
        st = sim.step()
        walls.append(st["wall"])
        say({"phase": "main_path_cycle", "cycle": c, "wall_s": st["wall"],
             "depth": st["depth"], "substeps": st["substeps"],
             "force_substeps": st["force_substeps"],
             "particle_updates": st["updates"],
             "updates_per_s": st["updates"] / st["wall"],
             "pair_tasks": st["pair_tasks"], "t": st["t"]})
    launches = launch_counts(K)
    e1, p1 = sim.diagnostics()
    state = sim.state
    fields = dict(state._asdict(), **state.cells._asdict())
    finite = all(bool(torch.isfinite(v.float()).all())
                 for k, v in fields.items() if k != "cells")
    drift = abs(e1 - e0) / abs(e0)
    say({"phase": "main_path_check", "energy_drift": drift,
         "momentum": [float(x) for x in p1], "finite": finite,
         "launches": launches})
    assert finite, "non-finite state after the main path"
    assert drift < DRIFT_BOUND, f"energy drift {drift} over {DRIFT_BOUND}"
    assert launches["density_pair_cells"] > 0, launches
    assert launches["force_pair"] > 0, launches
    return {"launches": launches, "walls": walls,
            "state": [t.cpu() for t in tb_snapshot(sim)]}


def kernel_launches(counts: dict) -> dict:
    """A launch_counts() reading as the kernels line's two SPH rows."""
    return {"density_pair": counts["density_pair_cells"]
            + counts["density_pair"], "force_pair": counts["force_pair"]}


def card_matches_cpu(dev, n_side: int = 10, max_depth: int = 4):
    """Phase 5b: the same small time-bin run on the card and on the CPU
    (plain versions, which the CPU tests hold against the JAX reference)
    agrees — counts exactly, fields within the tests' trajectory tolerance
    (1e-4 of each field's scale). Sedov 10³ keeps the CPU half to seconds
    while its ladder still takes interior sub-steps; the reference's
    conformance size, 6³, bins into 2³ cells of capacity 88."""
    from repro_torch.sph import build_simulation
    from repro_torch.sph.convert import to_numpy
    spec = sedov_spec(n_side, max_depth=max_depth)
    runs = []
    for d in (dev, "cpu"):
        sim = build_simulation(spec, device=d)
        capacity = sim.engine.spec.capacity
        stats = [sim.step() for _ in range(2)]
        counts = [[st[k] for k in ("depth", "substeps", "force_substeps",
                                   "updates", "pair_tasks")] for st in stats]
        snap = to_numpy(sim.state)
        snap.update(snap.pop("cells"))
        runs.append((counts, snap))
    (ca, a), (cb, b) = runs
    worst, same = 0.0, True
    for k in a:
        same &= a[k].tobytes() == b[k].tobytes()
        x, y = a[k].astype(np.float64), b[k].astype(np.float64)
        scale = max(float(np.abs(y).max()), 1e-30)
        worst = max(worst, float(np.abs(x - y).max()) / scale)
    say({"phase": "card_vs_cpu", "n_side": n_side, "C": capacity,
         "max_depth": max_depth,
         "cycles": 2,
         "counts_equal": ca == cb, "bitwise_equal": bool(same),
         "max_rel_diff": worst})
    assert ca == cb and worst <= 1e-4, "card and CPU runs disagree"


def global_path(dev):
    """Phase 6: the global-dt engine on the same IC, 3 steps of fixed dt,
    with its own launch counts (set to 0 before the build, which runs the
    initial density and force passes)."""
    from repro_torch.kernels.sph_pair import kernel as K
    from repro_torch.sph import build_simulation
    spec = sedov_spec(integrator="global", dt=1e-5)
    K.reset_launches()
    sim = build_simulation(spec, device=dev)
    e0, _ = sim.diagnostics()
    walls = [sim.step()["wall"] for _ in range(3)]
    e1, _ = sim.diagnostics()
    launches = launch_counts(K)
    c = sim.state.cells
    finite = all(bool(torch.isfinite(t).all()) for t in c)
    say({"phase": "global_dt", "steps": 3, "dt": spec.dt, "wall_s": walls,
         "energy_drift": abs(e1 - e0) / abs(e0), "finite": finite,
         "launches": launches})
    assert finite and abs(e1 - e0) / abs(e0) < 0.05
    assert launches["density_pair_cells"] >= 3, launches
    assert launches["force_pair"] >= 3, launches


def dist_spec(n_side: int, halo: str = "allgather", ranks: int = DIST_RANKS,
              **kw):
    """The distributed phase's spec: global dt (phase 6's), ``ranks``
    ranks stacked on the card."""
    return sedov_spec(n_side, integrator="global", backend="distributed",
                      ranks=ranks, halo=halo, dt=DIST_DT, **kw)


def dist_state(cells, accel, dudt, rho) -> list:
    return list(cells) + [accel, dudt, rho]


def partition_figures(eng) -> dict:
    """The paper's numbers for one decomposition: each rank's work (the
    cell graph's node weights summed) and its load with the cut edges
    (computed on both sides), their imbalance (max / mean), cells and
    particles per rank, cut edges, the plan's sizes and the halo bytes."""
    plan, part = eng.plan, eng.decomp.partition
    nd, a = plan.ndev, plan.assignment
    node_w, edge_w = eng.taskgraph.cell_graph()
    vw = np.zeros(len(a))
    for c, w in node_w.items():
        vw[c] = w
    work = np.bincount(a, weights=vw, minlength=nd)
    occ = eng.gather_cells().mask.sum(1).cpu().numpy()
    cut = [(u, v) for (u, v) in edge_w if a[u] != a[v]]
    C = eng.dcells.mask.shape[1]
    valid = int(plan.import_valid.sum())
    # floats a slot ships: pos, h, mass, mask; then vel, ρ, P, Ω, c_s
    floats = {"positions": 6, "densities": 7}
    return {
        "rank_work": work.tolist(),
        "work_imbalance": float(work.max() / work.mean()),
        "rank_load_with_cut": part.part_loads.tolist(),
        "load_imbalance": float(part.imbalance),
        "rank_cells": np.bincount(a, minlength=nd).tolist(),
        "rank_particles": np.bincount(a, weights=occ,
                                      minlength=nd).astype(int).tolist(),
        "cut_edges": len(cut), "edges": len(edge_w),
        "cut_weight": float(part.edge_cut),
        "K": plan.K, "B": plan.B, "Bi": plan.Bi, "Pmax": plan.Pmax,
        "ring_rounds": plan.ring_rounds,
        "plan_entries": int(plan.pair_w.sum()),
        "import_slots": valid,
        # per exchange: the imported cells' rows (what must reach the
        # ranks), the reference's all_gather (every rank receives every
        # export buffer) and the ring's windows (R rounds of every buffer)
        "halo_bytes": {ex: {
            "imported": 4 * f * C * valid,
            "allgather_delivered": 4 * f * C * nd * nd * plan.B,
            "ring_windows": 4 * f * C * plan.ring_rounds * nd * plan.B}
            for ex, f in floats.items()}}


def run_dist_steps(step, cells, accel, dudt, dev, K):
    """DIST_STEPS steps of ``step`` from one state, each timed: host
    seconds until the call returns (the host's work and launches), the
    card's span between CUDA events around it, the wall until a
    synchronize; and each step's launches of the pair kernels."""
    from repro_torch.sph.engine import f32
    rows, rho = [], None
    for _ in range(DIST_STEPS):
        K.reset_launches()
        synchronize(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        cells, accel, dudt, rho = step(cells, accel, dudt, f32(DIST_DT, dev))
        host = time.perf_counter() - t0
        b.record()
        synchronize(dev)
        rows.append({"host_s": host, "wall_s": time.perf_counter() - t0,
                     "device_span_s": a.elapsed_time(b) / 1e3,
                     "launches": launch_counts(K)})
    return dist_state(cells, accel, dudt, rho), rows


def global_distributed(dev):
    """Phase 6b: the global × distributed quadrant, DIST_RANKS ranks
    stacked on the card, at Sedov DIST_NSIDE³. The decomposition (task
    graph, partition, plan) runs once, in ``build_simulation``; the step
    is built from that plan for both halo schemes and each runs
    DIST_STEPS steps from the same state, then the API's own step runs
    the same steps. Gates: the schemes and the API's run bitwise equal;
    one launch of each pair kernel a step; the local global-dt engine
    tracked within the reference's conformance contract; run-twice
    bitwise at Sedov 16³; the card equal to the CPU at Sedov 10³."""
    from repro_torch.kernels.sph_pair import kernel as K
    from repro_torch.sph import build_simulation
    from repro_torch.sph.distributed import gather_from_devices, \
        make_dist_step
    say({"phase": "dist_cut", "n_side": DIST_NSIDE, "main_path_n_side": NSIDE,
         "reason": "the partitioner (pure Python, a copy of the "
                   "reference's) takes ~5 min at 64³; 48³ keeps the run "
                   "inside its time limit"})
    t0 = time.perf_counter()
    sim = build_simulation(dist_spec(DIST_NSIDE), device=dev)
    synchronize(dev)
    eng = sim.engine
    say({"phase": "dist_decompose", "n_side": DIST_NSIDE,
         "ranks": DIST_RANKS, "cells": eng.spec.ncells,
         "C": eng.spec.capacity, "tasks": len(eng.taskgraph),
         "setup_s": eng.setup_s, "build_s": time.perf_counter() - t0,
         **partition_figures(eng)})
    cells0 = eng.dcells
    runs = {}
    for halo in ("allgather", "ring"):
        step, init = make_dist_step(eng.plan, eng.cfg, eng.spec.box,
                                    halo=halo, device=dev)
        accel, dudt, _ = init(cells0)
        state, rows = run_dist_steps(step, cells0, accel, dudt, dev, K)
        runs[halo] = state
        say({"phase": "dist_steps", "halo": halo, "steps": rows,
             "median_host_s": float(np.median([r["host_s"] for r in rows])),
             "median_device_span_s": float(np.median(
                 [r["device_span_s"] for r in rows])),
             "median_wall_s": float(np.median([r["wall_s"] for r in rows]))})
        for r in rows:
            assert (r["launches"]["density_pair_cells"],
                    r["launches"]["force_pair"],
                    r["launches"]["density_pair"]) == (1, 1, 0), r
    K.reset_launches()
    walls = [sim.step()["wall"] for _ in range(DIST_STEPS)]
    api_launches = launch_counts(K)
    api = dist_state(eng.dcells, eng.accel, eng.dudt, eng.rho)
    same = bits_equal(runs["allgather"], runs["ring"])
    api_same = bits_equal(api, runs["allgather"])
    # the local engine from the same IC and dt (no re-binning: the
    # distributed engine never re-bins), within the reference's contract
    local = build_simulation(sedov_spec(DIST_NSIDE, integrator="global",
                                        dt=DIST_DT, rebin_every=100),
                             device=dev)
    for _ in range(DIST_STEPS):
        local.step()
    e_l, p_l = local.diagnostics()
    e_d, p_d = sim.diagnostics()
    g = gather_from_devices(eng.dcells, eng.plan, eng.spec.ncells)
    lc = local.engine.state.cells
    track = {"energy_rel": abs(e_d - e_l) / abs(e_l),
             "momentum_abs": float(np.abs(p_d - p_l).max())}
    ok = track["energy_rel"] <= 1e-5 and track["momentum_abs"] <= 1e-5
    for name in ("pos", "u"):
        x, y = getattr(g, name).double(), getattr(lc, name).double()
        track[name + "_max_abs"] = float((x - y).abs().max())
        ok &= bool(((x - y).abs() <= 2e-6 + 2e-5 * y.abs()).all())
    finite = all(bool(torch.isfinite(t).all()) for t in api)
    say({"phase": "dist_check", "allgather_equals_ring_bitwise": same,
         "api_steps_bitwise_the_direct_steps": api_same,
         "api_wall_s": walls, "api_launches": api_launches,
         "finite": finite, "tracks_local_engine": ok, **track})
    assert same, "allgather and ring halos give different states"
    assert api_same, "build_simulation's steps differ from make_dist_step's"
    assert api_launches["density_pair_cells"] == DIST_STEPS, api_launches
    assert api_launches["force_pair"] == DIST_STEPS, api_launches
    assert finite and ok, f"distributed run leaves the local engine: {track}"
    del sim, eng, local, runs, api, cells0
    torch.cuda.empty_cache()
    dist_determinism(dev)
    dist_card_matches_cpu(dev)
    return DIST_STEPS


def dist_determinism(dev, n_side: int = 16):
    """Phase 6c: the distributed spec run twice on the card, bitwise."""
    from repro_torch.sph import build_simulation
    states = []
    for _ in range(2):
        sim = build_simulation(dist_spec(n_side, halo="ring"), device=dev)
        for _ in range(DIST_STEPS):
            sim.step()
        e = sim.engine
        states.append(dist_state(e.dcells, e.accel, e.dudt, e.rho))
    same = bits_equal(*states)
    say({"phase": "dist_determinism", "n_side": n_side, "ranks": DIST_RANKS,
         "steps": DIST_STEPS, "bitwise_equal": same})
    assert same, "two identical distributed runs differ"


def dist_card_matches_cpu(dev, n_side: int = 10):
    """Phase 6d: the distributed run on the card and on the CPU (the plain
    versions, which the CPU tests hold against the JAX reference) within
    1e-4 of each field's scale, as phase 5b holds the local paths."""
    from repro_torch.sph import build_simulation
    states = []
    for d in (dev, "cpu"):
        sim = build_simulation(dist_spec(n_side, halo="ring"), device=d)
        for _ in range(2):
            sim.step()
        e = sim.engine
        states.append([t.cpu() for t in dist_state(e.dcells, e.accel,
                                                   e.dudt, e.rho)])
    worst = 0.0
    for x, y in zip(*states):
        scale = max(float(y.abs().max()), 1e-30)
        worst = max(worst, float((x.double() - y.double()).abs().max())
                    / scale)
    same = bits_equal(*states)
    say({"phase": "dist_card_vs_cpu", "n_side": n_side, "ranks": DIST_RANKS,
         "steps": 2, "bitwise_equal": same, "max_rel_diff": worst})
    assert worst <= 1e-4, "card and CPU distributed runs disagree"


# ------------------------------------------- time-bin × distributed (6e)
TB_COUNTS = ("depth", "substeps", "force_substeps", "updates", "pair_tasks",
             "halo_exported_slots", "halo_full_slots")


def tb_spec(n_side: int, **kw):
    """Phase 6e's spec: the main path's ladder (``max_depth`` cut to
    MAIN_MAX_DEPTH) over DIST_RANKS ranks; ``kw`` sets the wire."""
    kw.setdefault("transport", "collective")
    return sedov_spec(n_side, backend="distributed", ranks=DIST_RANKS,
                      max_depth=MAIN_MAX_DEPTH, **kw)


def tb_snapshot(sim) -> list:
    st = sim.state
    return list(st.cells) + list(st[1:])


def tb_stats_equal(a: list, b: list) -> bool:
    return all([x[k] for k in TB_COUNTS] == [y[k] for k in TB_COUNTS]
               and np.array_equal(x["bin_hist"], y["bin_hist"])
               for x, y in zip(a, b))


def tb_run(dev, n_side: int, **kw):
    """Build and run SIM_CYCLES cycles: (stats, final state on the host,
    the pair kernels' launches in the cycles, the build's init pass
    left out)."""
    from repro_torch.kernels.sph_pair import kernel as K
    sim = build_tb(tb_spec(n_side, **kw), dev)
    K.reset_launches()
    stats = [sim.step() for _ in range(SIM_CYCLES)]
    return stats, [t.cpu() for t in tb_snapshot(sim)], launch_counts(K)


def build_tb(spec, dev, assignment=None):
    """``build_simulation(spec)``; with ``assignment``, the engine takes
    that decomposition instead of partitioning again (the partitioner is
    deterministic, so this is the same decomposition without its minute of
    host time: a hook of this script, not an option of the engine)."""
    from repro_torch.sph import build_simulation
    from repro_torch.sph.dist_timebins import DistTimeBinSimulation as D
    if assignment is None:
        return build_simulation(spec, device=dev)
    own = D._initial_assignment
    D._initial_assignment = lambda self: np.asarray(assignment).copy()
    try:
        return build_simulation(spec, device=dev)
    finally:
        D._initial_assignment = own


def profiled_cycle(sim, steps: int = 1) -> dict:
    """``steps`` more cycles under ``torch.profiler`` (CUDA activity only):
    their wall, the device time summed over every device event, and the
    idle share 1 − device time / wall ("not measured" if the profiler saw
    no device time)."""
    from torch.profiler import ProfilerActivity, profile
    synchronize(sim.engine.device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            sim.step()
        synchronize(sim.engine.device)
        wall = time.perf_counter() - t0
    busy = 0.0
    for e in prof.key_averages():
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, name):
                busy += float(getattr(e, name)) / 1e6
                break
    return {"wall_s": wall, "device_s": busy or None,
            "idle_share": 1.0 - busy / wall if busy else "not measured"}


def timebin_distributed(dev):
    """Phase 6e: the time-bin × distributed quadrant, DIST_RANKS per-rank
    states on the card, at Sedov DIST_NSIDE³ over the collective wire
    (``mode="auto"``), two cycles of the depth-4 ladder. Gates: (a) bit for
    bit the local ladder's state and counts; (b) per cycle, each pair
    kernel launched once per rank per force sub-step and the block entry
    never; (c) finite, energy drift under DRIFT_BOUND; (d) at Sedov 16³ the
    host wire and the collective wire in both modes bitwise equal, with
    equal stats; (e) the same run twice, bitwise; (f) the card against the
    CPU at Sedov 10³ within 1e-4 of each field's scale, counts exactly."""
    from repro_torch.kernels.sph_pair import kernel as K
    say({"phase": "tbdist_cut", "n_side": DIST_NSIDE,
         "main_path_n_side": NSIDE, "max_depth": MAIN_MAX_DEPTH,
         "reason": "the partitioner (pure Python, a copy of the "
                   "reference's) takes ~5 min at 64³; 48³ keeps the run "
                   "inside its time limit"})
    spec = tb_spec(DIST_NSIDE)
    t0 = time.perf_counter()
    sim = build_tb(spec, dev)
    synchronize(dev)
    eng = sim.engine
    assignment = eng._assignment.copy()
    plan = eng._get_plan()
    tstats = eng.transport_stats()
    say({"phase": "tbdist_decompose", "n_side": DIST_NSIDE,
         "ranks": DIST_RANKS, "particles": eng.n,
         "cells": eng.spec.ncells, "C": eng.spec.capacity,
         "pairs": len(eng._ci), "setup_s": eng.setup_s,
         "build_s": time.perf_counter() - t0, "K": plan.K, "H": plan.H,
         "cut_cells": len(plan.cut), "cut_slots": plan.cut_slots,
         "export_edges": plan.export_edges(),
         "rounds": eng._transport.rounds, "transport": tstats["kind"],
         "mode": tstats["mode"]})
    e0, _ = sim.diagnostics()
    cycles, launches = [], {"density_pair": 0, "force_pair": 0}
    for c in range(SIM_CYCLES):
        K.reset_launches()
        synchronize(dev)
        st = sim.step()
        got = launch_counts(K)
        tr = eng.transport_stats()
        row = {"phase": "tbdist_cycle", "cycle": c, "wall_s": st["wall"],
               **{k: st[k] for k in TB_COUNTS},
               "updates_per_s": st["updates"] / st["wall"],
               "shipped_share": st["halo_exported_slots"]
               / max(st["halo_full_slots"], 1),
               "repartitions": eng.repartitions,
               "repartition_s": eng.repartition_seconds,
               "launches": got,
               "transport": {k: tr[k] for k in (
                   "kind", "mode", "rounds", "exchanges", "shipped_rows",
                   "host_bytes", "programs")},
               # distinct input signatures: the phase programs', and
               # over the exchange programs (one per program and bucket)
               "compiles": {k: v for k, v in tr["compiles"].items()
                            if not k.startswith("program:")},
               "exchange_program_signatures": sum(
                   v for k, v in tr["compiles"].items()
                   if k.startswith("program:"))}
        say(row)
        cycles.append(st)
        n = DIST_RANKS * st["force_substeps"]
        assert (got["density_pair_cells"], got["force_pair"],
                got["density_pair"]) == (n, n, 0), (got, n)       # (b)
        launches["density_pair"] += got["density_pair_cells"]
        launches["force_pair"] += got["force_pair"]
    e1, p1 = sim.diagnostics()
    dist = [t.cpu() for t in tb_snapshot(sim)]
    finite = all(bool(torch.isfinite(t.float()).all()) for t in dist)
    drift = abs(e1 - e0) / abs(e0)
    host_profiled = profiled_cycle(sim)
    del sim, eng
    torch.cuda.empty_cache()
    resident = timebin_resident(dev, spec, assignment, cycles, dist,
                                host_profiled)
    for name, n in resident["launches"].items():
        launches[name] += n
    for name, n in timebin_device_schedule(dev, spec, assignment, resident,
                                           host_profiled).items():
        launches[name] += n
    local = build_tb(spec.with_(backend="local", ranks=None), dev)
    lstats = [local.step() for _ in range(SIM_CYCLES)]
    same = bits_equal(dist, [t.cpu() for t in tb_snapshot(local)])
    same_counts = all(
        [x[k] for k in ("depth", "substeps", "force_substeps", "updates")]
        == [y[k] for k in ("depth", "substeps", "force_substeps",
                           "updates")]
        and np.array_equal(x["bin_hist"], y["bin_hist"])
        for x, y in zip(cycles, lstats))
    del local
    torch.cuda.empty_cache()
    say({"phase": "tbdist_check", "bitwise_local_ladder": same,
         "counts_equal_local_ladder": same_counts,
         "local_wall_s": [st["wall"] for st in lstats],
         "energy_drift": drift, "momentum": [float(x) for x in p1],
         "finite": finite})
    assert same and same_counts, "the distributed ladder left the local one"
    assert finite, "non-finite state after the distributed ladder"
    assert drift < DRIFT_BOUND, f"energy drift {drift} over {DRIFT_BOUND}"
    # (d) the wires at 16³; (e) the ppermute run again
    # and the device residency in both collective modes, twice
    wire_kw = {"host": ("host", "auto", "host"),
               "ppermute": ("collective", "ppermute", "host"),
               "allgather": ("collective", "allgather", "host"),
               "ppermute_again": ("collective", "ppermute", "host"),
               "ppermute_resident": ("collective", "ppermute", "device"),
               "allgather_resident": ("collective", "allgather", "device"),
               "ppermute_resident_again": ("collective", "ppermute",
                                           "device")}
    runs = {}
    for w, (t, m, r) in wire_kw.items():
        runs[w] = tb_run(dev, 16, transport=t, transport_mode=m, residency=r)
        if r == "device":
            got = runs[w][2]
            for name, n in kernel_launches(got).items():
                launches[name] += n
            n = sum(st["force_substeps"] for st in runs[w][0])
            assert (got["density_pair_cells"], got["force_pair"],
                    got["density_pair"]) == (n, n, 0), (w, got, n)
    wires = (bits_equal(runs["host"][1], runs["ppermute"][1])
             and bits_equal(runs["host"][1], runs["allgather"][1]))
    wire_stats = (tb_stats_equal(runs["host"][0], runs["ppermute"][0])
                  and tb_stats_equal(runs["host"][0], runs["allgather"][0]))
    twice = bits_equal(runs["ppermute"][1], runs["ppermute_again"][1])
    resident = all(bits_equal(runs["host"][1], runs[w][1])
                   and tb_stats_equal(runs["host"][0], runs[w][0])
                   for w in ("ppermute_resident", "allgather_resident"))
    resident_twice = bits_equal(runs["ppermute_resident"][1],
                                runs["ppermute_resident_again"][1])
    say({"phase": "tbdist_wires", "n_side": 16, "ranks": DIST_RANKS,
         "cycles": SIM_CYCLES, "host_equals_collective_bitwise": wires,
         "stats_equal": wire_stats, "run_twice_bitwise": twice,
         "device_residency_equals_host_bitwise": resident,
         "device_residency_run_twice_bitwise": resident_twice,
         "shipped_vs_full": [[st["halo_exported_slots"],
                              st["halo_full_slots"]]
                             for st in runs["host"][0]]})
    assert wires and wire_stats, "the wires disagree"
    assert twice, "two identical distributed time-bin runs differ"
    assert resident, "device residency left host residency at 16³"
    assert resident_twice, "two identical device-resident runs differ"
    # (f) the card against the CPU
    (sa, card, _), (sb, cpu, _) = tb_run(dev, 10), tb_run("cpu", 10)
    worst = 0.0
    for x, y in zip(card, cpu):
        scale = max(float(y.double().abs().max()), 1e-30)
        worst = max(worst, float((x.double() - y.double()).abs().max())
                    / scale)
    counts = tb_stats_equal(sa, sb)
    say({"phase": "tbdist_card_vs_cpu", "n_side": 10, "ranks": DIST_RANKS,
         "cycles": SIM_CYCLES, "counts_equal": counts,
         "bitwise_equal": bits_equal(card, cpu), "max_rel_diff": worst})
    assert counts and worst <= 1e-4, "card and CPU runs disagree"
    return launches


def timebin_resident(dev, spec, assignment, host_stats, host_state,
                     host_profiled) -> dict:
    """Phase 6e's device-residency run (``tbdist_resident``): the same spec
    at ``residency="device"``, built on the host run's decomposition
    (``build_tb``'s hook), SIM_CYCLES cycles with the pair kernels'
    launches set to 0 before and read after each. Gates: bit for bit the
    host-residency run's state and per-cycle stats; each pair kernel
    launched once per force sub-step for all ranks (the closing one
    included) and the block entry never; no dynamical state byte between
    host and device inside a cycle, and only tables, flags and bins rows.
    Prints the cycle walls and, from one more profiled cycle each, the
    device's idle share beside host residency's. Returns the launches,
    the run's stats, final state and profiled cycle (phase 6g's
    oracle)."""
    from repro_torch.kernels.sph_pair import kernel as K
    t0 = time.perf_counter()
    sim = build_tb(spec.with_(residency="device"), dev, assignment)
    synchronize(dev)
    build_s = time.perf_counter() - t0
    eng = sim.engine
    stats, per_cycle = [], []
    launches = {"density_pair": 0, "force_pair": 0}
    for c in range(SIM_CYCLES):
        K.reset_launches()
        synchronize(dev)
        st = sim.step()
        got = launch_counts(K)
        stats.append(st)
        per_cycle.append(got)
        n = st["force_substeps"]
        assert (got["density_pair_cells"], got["force_pair"],
                got["density_pair"]) == (n, n, 0), (got, n)
        for name, k in kernel_launches(got).items():
            launches[name] += k
    state = [t.cpu() for t in tb_snapshot(sim)]
    same = bits_equal(state, host_state)
    same_stats = tb_stats_equal(stats, host_stats) and all(
        (x["t"], x["dt_max"]) == (y["t"], y["dt_max"])
        for x, y in zip(stats, host_stats))
    tr = eng.transfers.stats()
    intra_keys = sorted(tr["intra_bytes"])
    compiles = {k: v for k, v in eng.probe.counts().items()
                if k.startswith("program:")}
    profiled = profiled_cycle(sim)
    say({"phase": "tbdist_resident", "n_side": DIST_NSIDE,
         "ranks": DIST_RANKS, "residency": "device",
         "decomposition": "the host run's (build hook)",
         "build_s": build_s, "setup_s": eng.setup_s,
         "wall_s": [st["wall"] for st in stats],
         "host_residency_wall_s": [st["wall"] for st in host_stats],
         "force_substeps": [st["force_substeps"] for st in stats],
         "launches": per_cycle,
         "host_residency_launches_per_cycle": [
             DIST_RANKS * st["force_substeps"] for st in host_stats],
         "profiled_cycle": profiled,
         "host_residency_profiled_cycle": host_profiled,
         "bitwise_host_residency": same, "stats_equal": same_stats,
         "intra_state_bytes": tr["intra_state_bytes"],
         "intra_bytes": tr["intra_bytes"],
         "boundary_bytes": sum(tr["boundary_bytes"].values()),
         "bins_refreshes": eng.bins_refreshes,
         "fused_program_signatures": compiles,
         "program_keys": sorted(map(str, eng.program_keys))})
    assert same and same_stats, "device residency left host residency"
    assert tr["intra_state_bytes"] == 0, tr
    assert set(intra_keys) <= {"tables", "flags", "bins"}, intra_keys
    assert all(v == 1 for v in compiles.values()), compiles
    del sim, eng
    torch.cuda.empty_cache()
    return {"launches": launches, "stats": stats, "state": state,
            "profiled": profiled}


# -------------------------------- time-bin × distributed, device schedule
# Phase 6g's 16³ conformance runs: the reference's hot Sedov (e0 = 30, a
# loose CFL; tests/test_conformance.py:280-291) and Kelvin–Helmholtz shear
# (:47-60). At 16³ the hot blast's particles cross cells from the second
# cycle on at the conformance's dt_max = 0.01, so a 4-cycle segment would
# abort; at dt_max = 0.0008 none crosses inside the 4 cycles, and the
# bins still deepen inside the second (821 deepenings; the local ladder
# on the CPU). The shear crosses a cell inside its first segment.
SEG_NSIDE = 16
SEG_CYCLES = 4
SEG_SCENARIOS = {
    "hot_sedov": dict(scenario="sedov",
                      scenario_params={"n_side": SEG_NSIDE, "e0": 30.0},
                      alpha=1.0, cfl=0.3, dt_max=0.0008, max_depth=3),
    "kelvin_helmholtz": dict(scenario="kelvin_helmholtz",
                             scenario_params={"n_side": SEG_NSIDE,
                                              "v_shear": 0.5},
                             alpha=1.0, cfl=0.2, dt_max=0.01, max_depth=3),
}


def seg_spec(name: str, **kw):
    from repro_torch.sph import SimulationSpec, SPHConfig
    base = dict(SEG_SCENARIOS[name])
    phys = SPHConfig(alpha_visc=base.pop("alpha"), cfl=base.pop("cfl"))
    return SimulationSpec(physics=phys, **base, integrator="timebin",
                          backend="distributed", ranks=DIST_RANKS,
                          transport="collective", residency="device", **kw)


def tb_stats_same(a: list, b: list, K_cycles: int = 1) -> bool:
    """Per-cycle stats equal: the counts, the histogram, t and dt_max. In
    a segment of K_cycles > 1 the repartition check runs only at its end,
    so a repartition the host schedule makes inside it moves the halo
    counts (not the state): there the halo counts are left out, as the
    reference's conformance test leaves them (tests/test_conformance.py:
    332-363)."""
    keys = TB_COUNTS if K_cycles == 1 else tuple(
        k for k in TB_COUNTS if not k.startswith("halo_"))
    return all([x[k] for k in keys] == [y[k] for k in keys]
               and np.array_equal(x["bin_hist"], y["bin_hist"])
               and (x["t"], x["dt_max"]) == (y["t"], y["dt_max"])
               for x, y in zip(a, b))


def poison_vel(eng) -> None:
    """NaN one real particle's velocity component, in place."""
    vel = eng.state.cells.vel.clone()
    c, p = [int(i) for i in torch.nonzero(eng.state.cells.mask > 0)[0]]
    vel[c, p, 0] = float("nan")
    eng.state = eng.state._replace(cells=eng.state.cells._replace(vel=vel))


def segment_conformance(dev) -> dict:
    """Phase 6g's 16³ runs against the host schedule, SEG_CYCLES cycles
    each: the hot Sedov in one K = SEG_CYCLES segment (no abort, bit for
    bit), Kelvin–Helmholtz in one (an abort on a crossing, the replay bit
    for bit), and a NaN poisoned into a K = 1 run after its first cycle
    (each later segment aborts on the sentinel and replays bit for bit,
    NaNs included). Returns the rows and the pair kernels' launches."""
    from repro_torch.kernels.sph_pair import kernel as K
    from repro_torch.sph import build_simulation
    out, launches = {}, {"density_pair": 0, "force_pair": 0}

    def run(spec, poison=False):
        sim = build_simulation(spec, device=dev)
        K.reset_launches()
        stats = []
        for c in range(SEG_CYCLES):
            if poison and c == 1:
                poison_vel(sim.engine)
            stats.append(sim.step())
        for name, n in kernel_launches(launch_counts(K)).items():
            launches[name] += n
        return sim.engine, stats, [t.cpu() for t in tb_snapshot(sim)]

    for name, K_cycles, poison in (("hot_sedov", SEG_CYCLES, False),
                                   ("kelvin_helmholtz", SEG_CYCLES, False),
                                   ("hot_sedov", 1, True)):
        host, hstats, hstate = run(seg_spec(name), poison)
        eng, stats, state = run(seg_spec(name, schedule="device",
                                         segment_cycles=K_cycles), poison)
        row = {"cycles": SEG_CYCLES, "K": K_cycles,
               "bitwise_host_schedule": bits_equal(state, hstate),
               "stats_equal": tb_stats_same(stats, hstats, K_cycles),
               "repartitions": [host.repartitions, eng.repartitions],
               "segments": eng.segments, "segment_aborts": eng.segment_aborts,
               "flags_last_segment": eng.segment_flags_last,
               "replayed": [bool(s.get("replayed")) for s in stats],
               "host_bins_refreshes": host.bins_refreshes,
               "walls_s": [s["wall"] for s in stats],
               "host_schedule_walls_s": [s["wall"] for s in hstats]}
        out["nan_poison" if poison else name] = row
        del host, eng
        torch.cuda.empty_cache()
    return out, launches


def timebin_device_schedule(dev, spec, assignment, resident: dict,
                            host_profiled: dict) -> dict:
    """Phase 6g (``tbdist_device_schedule``): phase 6e's 48³ spec at
    ``residency="device", schedule="device"`` on the host run's
    decomposition (``build_tb``'s hook), each pair kernel's launches set
    to 0 just before and read just after each segment, the segments'
    programs under the CUDA sync debug mode (a host read inside a segment
    raises). K = 1 for SIM_CYCLES cycles — gates: bit for bit 6e's
    ``tbdist_resident`` run (the host schedule: state and per-cycle
    stats), one segment a cycle and no abort, each pair kernel launched
    ``nsub_static`` times a cycle (every trip of the static ladder, dead
    ones too) and the block entry never, no intra-segment byte. K = 2 for
    SIM_CYCLES cycles (one segment) — gates: bit for bit at the boundary,
    whether the segment ran or aborted and replayed; the line names the
    flag that tripped. Prints the walls and one profiled segment's idle
    share beside the host schedule's and host residency's, then the 16³
    runs of :func:`segment_conformance`."""
    from repro_torch.kernels.sph_pair import kernel as K
    launches = {"density_pair": 0, "force_pair": 0}
    for K_cycles in (1, 2):
        sim = build_tb(spec.with_(residency="device", schedule="device",
                                  segment_cycles=K_cycles), dev, assignment)
        eng = sim.engine
        eng.sync_debug = True
        stats, per_segment = [], []
        for c in range(SIM_CYCLES):
            if c % K_cycles == 0:
                synchronize(dev)
                K.reset_launches()
            stats.append(sim.step())
            if (c + 1) % K_cycles == 0:
                got = launch_counts(K)
                seg = stats[c + 1 - K_cycles:c + 1]
                # the scan's trips (nsub_static = the segment's first
                # cycle's ladder), then a replay's force sub-steps
                want = K_cycles * seg[0]["substeps"] + sum(
                    s["force_substeps"] for s in seg if s.get("replayed"))
                per_segment.append({"launches": got, "expected": want})
                assert (got["density_pair_cells"], got["force_pair"],
                        got["density_pair"]) == (want, want, 0), (got, want)
                for name, n in kernel_launches(got).items():
                    launches[name] += n
        state = [t.cpu() for t in tb_snapshot(sim)]
        same = bits_equal(state, resident["state"])
        same_stats = tb_stats_same(stats, resident["stats"], K_cycles)
        tr = eng.transfers.stats()
        segments, aborts = eng.segments, eng.segment_aborts
        flags = eng.segment_flags_last
        eng.sync_debug = False
        profiled = profiled_cycle(sim, steps=K_cycles)
        profiled.update(cycles=K_cycles,
                        aborted=eng.segment_aborts > aborts,
                        flags=eng.segment_flags_last)
        say({"phase": "tbdist_device_schedule", "n_side": DIST_NSIDE,
             "ranks": DIST_RANKS, "K": K_cycles, "cycles": SIM_CYCLES,
             "decomposition": "the host run's (build hook)",
             "sync_debug_mode": "error inside each segment",
             "wall_s": [s["wall"] for s in stats],
             "host_schedule_wall_s": [s["wall"] for s in resident["stats"]],
             "launches": per_segment, "segments": segments,
             "segment_aborts": aborts, "flags_last_segment": flags,
             "replayed": [bool(s.get("replayed")) for s in stats],
             "bitwise_host_schedule": same, "stats_equal": same_stats,
             "intra_bytes": tr["intra_bytes"],
             "boundary_bytes": tr["boundary_bytes"],
             "profiled_segment": profiled,
             "host_schedule_profiled_cycle": resident["profiled"],
             "host_residency_profiled_cycle": host_profiled,
             "program_signatures": {
                 k: v for k, v in eng.probe.counts().items()
                 if k.startswith("program:")}})
        assert same and same_stats, f"K={K_cycles}: left the host schedule"
        aborted = any(s.get("replayed") for s in stats)
        if K_cycles == 1:
            assert aborts == 0 and not aborted and segments == SIM_CYCLES
        if not aborted:
            assert tr["intra_bytes"] == {}, tr["intra_bytes"]
        del sim, eng
        torch.cuda.empty_cache()
    seg, seg_launches = segment_conformance(dev)
    say({"phase": "tbdist_segments", "n_side": SEG_NSIDE,
         "ranks": DIST_RANKS, **seg})
    for name, n in seg_launches.items():
        launches[name] += n
    hot, kh, nan = seg["hot_sedov"], seg["kelvin_helmholtz"], \
        seg["nan_poison"]
    assert all(r["bitwise_host_schedule"] and r["stats_equal"]
               for r in seg.values()), seg
    assert hot["segment_aborts"] == 0 and hot["host_bins_refreshes"] >= 1
    assert kh["segment_aborts"] >= 1 and kh["flags_last_segment"]["crossed"]
    assert nan["segment_aborts"] == SEG_CYCLES - 1
    assert nan["flags_last_segment"]["sentinels"] > 0
    return launches


# ------------------------------------------------------------ observability
# Phase 6f: the traced time-bin × distributed run at Sedov 16³, the only
# size whose decomposition fits the script's time (the partitioner, pure
# Python, takes about a minute at 48³ on the card's host).
OBS_NSIDE = 16


def quiet(fn, *args):
    """``fn(*args)`` with its standard output captured: (result, text)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


# the fences alone: tracing on, the telemetry rows off
FENCES_ONLY = {"device_metrics": False}


def observed_runs(spec, dev, runs):
    """Build and step ``spec`` once per entry of ``runs`` (its ``observe``
    value), SIM_CYCLES cycles each, with the pair kernels' launches set to
    0 just before and read just after; returns each run's simulation, its
    cycle walls, its launches and its final state on the host."""
    from repro_torch.kernels.sph_pair import kernel as K
    from repro_torch.sph import build_simulation
    out = []
    for traced in runs:
        sim = build_simulation(spec.with_(observe=traced), device=dev)
        synchronize(dev)
        K.reset_launches()
        walls = [sim.step()["wall"] for _ in range(SIM_CYCLES)]
        out.append({"sim": sim, "walls": walls,
                    "launches": launch_counts(K),
                    "state": [t.cpu() for t in tb_snapshot(sim)]})
    return out


def overhead(walls: list, base: list) -> list:
    """Per cycle: ``walls`` less the mean of the ``base`` runs' walls."""
    return [t - sum(u) / len(u) for t, u in zip(walls, zip(*base))]


def export_records(obs, out_dir: str):
    """The observer's trace and metrics log written under ``out_dir``:
    (trace document, trace path, metrics path, records read back)."""
    from repro_torch.observability import read_metrics_jsonl
    tpath = os.path.join(out_dir, "trace.json")
    mpath = os.path.join(out_dir, "metrics.jsonl")
    doc = obs.export_chrome_trace(tpath)
    obs.write_metrics_jsonl(mpath)
    return doc, tpath, mpath, read_metrics_jsonl(mpath)


def record_summary(rec: dict) -> dict:
    """What a v3 record says about where a cycle went."""
    dmx = rec.get("device_metrics") or {}
    return {"phase_wall_s": rec.get("phase_wall"),
            "phase_count": rec.get("phase_count"),
            "imbalance": rec.get("imbalance"),
            "dead_frac": rec.get("dead_frac"),
            "device_metrics": {k: dmx.get(k) for k in (
                "per_rank_work", "imbalance", "flags", "tripped")},
            "device_phase_units": rec.get("device_phase_units"),
            "cost_ratios": rec.get("cost_ratios")}


def observed_main_path(dev, phase5: dict):
    """Phase 5c: the main path of phase 5 (Sedov 64³, depth 4, two
    cycles, the same IC) with ``observe=True``, then traced with the
    telemetry rows off (the fences alone), then untraced. Gates: each
    run's state bit for bit phase 5's and the pair kernels' launches equal
    to phase 5's (fences only wait); the trace valid; the
    JSONL log read back equal to ``observer.records``; the record's byte
    and compile ledgers those of the engine's probes (the local ladder has
    none, so the record must carry none); measured-vs-modelled cost ratios
    present. Prints the traced and untraced walls, the fences' cost and the
    last record's breakdown, then renders the trace with the report."""
    import tempfile
    from repro_torch.analysis.report import trace_report
    from repro_torch.observability import validate_chrome_trace
    runs = observed_runs(sedov_spec(max_depth=MAIN_MAX_DEPTH), dev,
                         (True, FENCES_ONLY, False))
    traced, fences, untraced = runs
    sim = traced["sim"]
    obs, eng = sim.observer, sim.engine
    bitwise = all(bits_equal(r["state"], phase5["state"]) for r in runs)
    same_launches = all(r["launches"] == phase5["launches"] for r in runs)
    with tempfile.TemporaryDirectory() as tmp:
        doc, tpath, mpath, back = export_records(obs, tmp)
        report = trace_report(tpath, mpath)
    errors = validate_chrome_trace(doc)
    probes = {}
    for key, probe in (("transfers", getattr(eng, "transfers", None)),
                       ("compiles", getattr(eng, "probe", None))):
        have = [key in r for r in obs.records]
        if probe is None:
            probes[key] = "no probe on this engine" if not any(have) \
                else "record has a ledger the engine lacks"
        else:
            want = probe.stats() if key == "transfers" else probe.counts()
            probes[key] = "equal" if obs.records[-1].get(key) == want \
                else "differ"
    rec = obs.records[-1]
    header = next((ln for ln in report.splitlines()
                   if ln.lstrip().startswith("cycle ")), None)
    untraced_walls = [phase5["walls"], untraced["walls"]]
    say({"phase": "observed_main_path", "n_side": NSIDE,
         "max_depth": MAIN_MAX_DEPTH, "cycles": SIM_CYCLES,
         "traced_wall_s": traced["walls"],
         "fences_only_wall_s": fences["walls"],
         "untraced_wall_s": untraced_walls,
         "fence_overhead_s": overhead(fences["walls"], untraced_walls),
         "telemetry_overhead_s": overhead(traced["walls"],
                                          [fences["walls"]]),
         "bitwise_equal_main_path": bitwise,
         "launches": traced["launches"], "launches_equal": same_launches,
         "trace_errors": errors[:3], "jsonl_round_trip": back == obs.records,
         "probes": probes, "spans": len(obs.tracer.spans),
         "trace_events": len(doc["traceEvents"]),
         **record_summary(rec),
         "report_lines": len(report.splitlines()), "report_header": header})
    assert bitwise, "the traced main path left the untraced one"
    assert same_launches, "tracing changed the pair kernels' launches"
    assert errors == [], errors[:3]
    assert back == obs.records, "metrics.jsonl does not read back"
    assert all(v in ("equal", "no probe on this engine")
               for v in probes.values()), probes
    assert rec["cost_ratios"], "no measured-vs-modelled cost ratios"
    assert header is not None, "the report has no per-cycle table"
    return kernel_launches(traced["launches"])


def observed_timebin_distributed(dev):
    """Phase 6f: ``python -m repro_torch.observability``'s default run (the
    time-bin × distributed quadrant, collective wire, host residency,
    DIST_RANKS ranks) at Sedov OBS_NSIDE³, two cycles each: untraced,
    traced, fences-only (telemetry rows off), untraced again, in process. Gates: traced bit for bit untraced, with equal CompileProbe
    counts and pair-kernel launches; the CLI's checks (trace valid, one row
    per rank with a density and a force slice per force sub-step, record
    ledgers equal to the probes, per-rank per-phase work present and summed
    per cell, one metrics pull a cycle); imbalance and dead_frac finite.
    Then ``dump --inject-nan``: the NaN sentinel trips and the bundle
    validates; then ``advise`` over the metrics log."""
    import math
    import tempfile
    from repro_torch.observability.__main__ import (advise_main, check_run,
                                                    dump_main, run_spec)
    from repro_torch.observability.flight import validate_bundle
    with tempfile.TemporaryDirectory() as tmp:
        spec = run_spec(OBS_NSIDE, DIST_RANKS, out_dir=tmp)
        # untraced first and last, so the base walls bracket the others
        untraced, traced, fences, again = observed_runs(
            spec, dev, (False, True, FENCES_ONLY, False))
        base = [untraced["walls"], again["walls"]]
        sim = traced["sim"]
        obs = sim.observer
        doc, _, mpath, back = export_records(obs, tmp)
        failures = check_run(sim, doc, DIST_RANKS, SIM_CYCLES)
        compiles = (traced["sim"].engine.probe.counts(),
                    untraced["sim"].engine.probe.counts())
        finite = all(math.isfinite(r[k]) for r in obs.records
                     for k in ("imbalance", "dead_frac"))
        advisor = [r["advisor"] for r in obs.records]
        rc_adv, adv_text = quiet(advise_main, ["--metrics", mpath])
        say({"phase": "observed_tbdist", "n_side": OBS_NSIDE,
             "ranks": DIST_RANKS, "transport": spec.transport,
             "residency": spec.residency, "cycles": SIM_CYCLES,
             "traced_wall_s": traced["walls"],
             "fences_only_wall_s": fences["walls"],
             "untraced_wall_s": base,
             "fence_overhead_s": overhead(fences["walls"], base),
             "telemetry_overhead_s": overhead(traced["walls"],
                                              [fences["walls"]]),
             "bitwise_equal_untraced": all(
                 bits_equal(r["state"], untraced["state"])
                 for r in (traced, fences, again)),
             "compiles_equal": compiles[0] == compiles[1],
             "launches": traced["launches"],
             "launches_equal": traced["launches"] == untraced["launches"]
             == fences["launches"] == again["launches"],
             "cli_checks_failed": failures, "finite": finite,
             "jsonl_round_trip": back == obs.records,
             "spans": len(obs.tracer.spans),
             **record_summary(obs.records[-1]),
             "bin_occupancy_imbalance":
                 obs.records[-1].get("bin_occupancy_imbalance"),
             "advisor": [{k: a[k] for k in ("current_imbalance",
                                            "advised_imbalance",
                                            "accepted")} if a else None
                         for a in advisor],
             "advise_rc": rc_adv,
             "advise_lines": len(adv_text.splitlines())})
        assert all(bits_equal(r["state"], untraced["state"])
                   for r in (traced, fences, again)), \
            "the traced distributed ladder left the untraced one"
        assert compiles[0] == compiles[1], compiles
        assert traced["launches"] == untraced["launches"] \
            == fences["launches"] == again["launches"], \
            "tracing changed the pair kernels' launches"
        assert not failures, failures
        assert finite and back == obs.records
        assert rc_adv == 0 and all(a is not None for a in advisor)
        launches = kernel_launches(traced["launches"])
        del sim, obs, traced, untraced, fences, again
        for name, n in observed_resident(dev, tmp).items():
            launches[name] += n
        rc, text = quiet(dump_main, ["--inject-nan", "--n-side",
                                     str(OBS_NSIDE), "--ranks",
                                     str(DIST_RANKS), "--out-dir", tmp,
                                     "--device", str(dev)])
        dumped = json.loads(text)
        manifests = [validate_bundle(d["bundle"]) for d in dumped["dumps"]]
        say({"phase": "observed_flight_dump", "n_side": OBS_NSIDE,
             "rc": rc, "tripped": dumped["tripped"],
             "bundles": [{k: m[k] for k in ("reason", "cycle",
                                            "ring_cycles", "records")}
                         for m in manifests]})
        assert rc == 0 and dumped["tripped"], "the NaN sentinel did not trip"
        assert any(m["reason"] == "nan" for m in manifests), manifests
    torch.cuda.empty_cache()
    return launches


def observed_resident(dev, tmp: str) -> dict:
    """Phase 6f at device residency: the CLI's run with ``--residency
    device`` (OBS_NSIDE³, DIST_RANKS ranks), untraced and traced in
    process, then the CLI itself. Gates: traced bit for bit untraced, with
    the same launches (one of each pair kernel per force sub-step) and
    program signatures; the CLI's checks on the traced run (trace valid,
    one fused slice per sub-step on every rank's row, the record's ledgers
    the probes', the per-cell rows summing to the phase totals, exchange
    included, one metrics pull a cycle); the record's per-rank work the
    in-program rows' (density + force units of the pulled row);
    ``cost_calibration`` present; the CLI exits 0."""
    from repro_torch.observability import device_metrics as dm
    from repro_torch.observability.__main__ import check_run, main, run_spec
    spec = run_spec(OBS_NSIDE, DIST_RANKS, residency="device", out_dir=tmp)
    untraced, traced = observed_runs(spec, dev, (False, True))
    sim = traced["sim"]
    obs, eng = sim.observer, sim.engine
    out = os.path.join(tmp, "resident")
    os.makedirs(out, exist_ok=True)
    doc, _, _, back = export_records(obs, out)
    failures = check_run(sim, doc, DIST_RANKS, SIM_CYCLES)
    rec = obs.records[-1]
    counts, values = eng.device_metrics_last
    in_program = (values[:, dm.VALUE_INDEX["density_units"]]
                  + values[:, dm.VALUE_INDEX["force_units"]]).tolist()
    work = rec["device_metrics"]["per_rank_work"]
    nsub = sum(r["force_substeps"] for r in obs.records)
    rc, text = quiet(main, ["--residency", "device", "--n-side",
                            str(OBS_NSIDE), "--ranks", str(DIST_RANKS),
                            "--out-dir", os.path.join(tmp, "resident_cli"),
                            "--device", str(dev)])
    cli = json.loads(text)
    bitwise = bits_equal(traced["state"], untraced["state"])
    same_compiles = eng.probe.counts() \
        == untraced["sim"].engine.probe.counts()
    say({"phase": "observed_tbdist_resident", "n_side": OBS_NSIDE,
         "ranks": DIST_RANKS, "residency": "device", "cycles": SIM_CYCLES,
         "traced_wall_s": traced["walls"],
         "untraced_wall_s": untraced["walls"],
         "bitwise_equal_untraced": bitwise, "compiles_equal": same_compiles,
         "launches": traced["launches"],
         "launches_equal": traced["launches"] == untraced["launches"],
         "force_substeps": nsub, "cli_checks_failed": failures,
         "jsonl_round_trip": back == obs.records,
         "per_rank_work": work, "in_program_work": in_program,
         "cost_calibration": rec.get("cost_calibration"),
         "bucket_events": rec.get("bucket_events"),
         **record_summary(rec), "cli_rc": rc, "cli_ok": cli.get("ok"),
         "cli_spans": cli.get("spans")})
    assert bitwise, "the traced resident ladder left the untraced one"
    assert same_compiles and traced["launches"] == untraced["launches"]
    assert (traced["launches"]["density_pair_cells"],
            traced["launches"]["force_pair"],
            traced["launches"]["density_pair"]) == (nsub, nsub, 0), \
        traced["launches"]
    assert not failures, failures
    assert back == obs.records
    assert len(work) == DIST_RANKS and all(w > 0 for w in work)
    assert work == in_program, (work, in_program)
    assert rec.get("cost_calibration") is not None
    assert rc == 0 and cli.get("ok"), text[-2000:]
    launches = kernel_launches(traced["launches"])
    del sim, obs, traced, untraced
    return launches


def determinism(dev):
    """Phase 7: the same spec run twice gives bitwise-equal state."""
    from repro_torch.sph import build_simulation
    from repro_torch.sph.convert import to_numpy
    spec = sedov_spec(16, max_depth=MAIN_MAX_DEPTH)
    snaps = []
    for _ in range(2):
        sim = build_simulation(spec, device=dev)
        sim.step()
        snaps.append(to_numpy(sim.state))

    def flat(d, pre=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, pre + k + ".")
            else:
                yield pre + k, v

    a, b = dict(flat(snaps[0])), dict(flat(snaps[1]))
    same = all(a[k].tobytes() == b[k].tobytes() for k in a)
    say({"phase": "determinism", "n_side": 16, "cycles": 1,
         "fields": sorted(a), "bitwise_equal": same})
    assert same, "two identical runs differ"


# ------------------------------------------------------------- fleet slice
def fleet_argv(n_side: int, requests: int, steps: int, waves: int, *extra):
    return ["--scenario", "mixed", "--requests", str(requests), "--steps",
            str(steps), "--n-side", str(n_side), "--waves", str(waves),
            *extra]


def percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def fleet_serving(dev) -> dict:
    """Phase 7b: ``python -m repro_torch.fleet``'s serve path on the card
    (16 mixed requests at 32³, 4 steps, 3 waves, traced, entry points
    asserted), its kernels' launches read around it; then every request
    against its single run on the card (``check_parity``), their launches
    read around that. Returns the fleet run's launches."""
    import tempfile
    from repro_torch.fleet.__main__ import check_parity, serve
    from repro_torch.fleet.queue import RequestState
    from repro_torch.kernels.sph_pair import kernel as K
    from repro_torch.observability.sinks import validate_chrome_trace
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "fleet_trace.json")
        K.reset_launches()
        rc, out, runner, served = serve(
            fleet_argv(FLEET_NSIDE, FLEET_REQUESTS, FLEET_STEPS, FLEET_WAVES,
                       "--device", str(dev), "--assert-compiles",
                       "--trace-out", trace))
        launches = launch_counts(K)
        with open(trace) as f:
            doc = json.load(f)
    stats = out["stats"]
    groups = runner.groups
    passes = sum(g["passes"] + g["fell_off_passes"] for g in groups)
    counts = runner.compile_counts()
    names = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e.get("name") == "thread_name"}
    slices = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    trace_errors = validate_chrome_trace(doc)
    lat = [r.latency for r in served]
    say({"phase": "fleet", "n_side": FLEET_NSIDE,
         "requests": len(served), "steps": FLEET_STEPS,
         "particles": stats["particle_steps"] // FLEET_STEPS,
         "rc": rc, "wall_s": out["wall_s"],
         "particle_steps_per_s": out["particle_steps_per_s"],
         "host_s": stats["host_s"],
         "groups": [{k: g[k] for k in ("shape_key", "lanes", "bucket",
                                       "steps", "passes", "fell_off")}
                    for g in groups],
         "buckets": stats["buckets"], "padding_lanes": stats["padding_lanes"],
         "pool": stats["pool"], "programs": stats["programs"],
         "compile_counts": sorted(counts.values()),
         "latency_p50_s": percentile(lat, 50),
         "latency_p95_s": percentile(lat, 95),
         "trace_events": len(doc["traceEvents"]),
         "trace_errors": trace_errors, "launches": launches,
         "runner_passes": passes})
    assert rc == 0, "the fleet CLI failed (a request or --assert-compiles)"
    assert len(served) == FLEET_REQUESTS
    assert all(r.state is RequestState.DONE and r.result.batched
               for r in served)
    assert counts and all(c == 1 for c in counts.values()), counts
    assert runner.programs.builds == len(counts)
    assert trace_errors == [], trace_errors
    assert set(names.values()) == {r.request_id for r in served}, names
    assert slices and all(e["args"].get("request_id") in names.values()
                          for e in slices)
    # rebin_every=1: one stacked init, steps batched steps, steps - 1
    # stacked re-inits per shape group, whatever its lanes
    assert all(g["passes"] == 2 * g["steps"] for g in groups), groups
    assert launches["density_pair_cells"] == passes, (launches, passes)
    assert launches["force_pair"] == passes, (launches, passes)
    assert launches["density_pair"] == 0, launches

    K.reset_launches()
    parity = check_parity(served, dev)
    seq = launch_counts(K)
    want = (2 * FLEET_STEPS + 1) * FLEET_REQUESTS
    say({"phase": "fleet_parity", "mode": parity["mode"],
         "checked": parity["checked"], "mismatches": parity["mismatches"],
         "sequential_wall_s": parity["wall_s"],
         "sequential_particle_steps_per_s":
             parity["particle_steps"] / parity["wall_s"],
         "fleet_wall_s": out["wall_s"],
         "fleet_over_sequential_rate":
             out["particle_steps_per_s"]
             / (parity["particle_steps"] / parity["wall_s"]),
         "launches": seq, "expected_launches": want})
    assert parity["checked"] == FLEET_REQUESTS and not parity["mismatches"]
    assert seq["density_pair_cells"] == want and seq["force_pair"] == want
    torch.cuda.empty_cache()
    return launches


def fleet_lanes(dev, bucket: int, n_side: int = FLEET_NSIDE):
    """``bucket`` Sedov ``n_side``³ lanes (seeds 0, 1, …) stacked and
    initialised on ``dev``: (state, stacked pairs, CFL dts, step) where
    ``step()`` runs one batched step from that state."""
    from repro_torch.fleet import lanes
    from repro_torch.fleet.queue import RequestQueue
    from repro_torch.fleet.runner import _build_member
    from repro_torch.sph import SimulationSpec
    q = RequestQueue()
    ms = [_build_member(q.submit(SimulationSpec(
        scenario="sedov", scenario_params={"n_side": n_side, "seed": i,
                                           "e0": 1.0 + 0.1 * (i % 4)})))
          for i in range(bucket)]
    cfg = ms[0].req.spec.physics
    pairs = lanes.stack_pair_list(ms[0].pairs, bucket, ms[0].gspec.ncells,
                                  dev)
    st = lanes.lane_init(lanes.stack_cells([m.cells for m in ms], dev),
                         pairs, cfg, lanes.lane_times([0.0] * bucket, dev))
    dts = lanes.lane_cfl(st, cfg, bucket)
    return st, pairs, dts, lambda: lanes.lane_step(st, pairs, dts,
                                                   ms[0].box, cfg)


def fleet_step_timing(dev) -> None:
    """Phase 7c: one batched step of FLEET_LANES Sedov 32³ lanes against
    one lane's, CUDA events around each (median of FLEET_REPS after a warm
    step), from the same stacked state and dts each time; lane 0 of the
    batch bit for bit the lane stepped alone."""
    rows, outs = {}, {}
    for bucket in (FLEET_LANES, 1):
        st, pairs, _, step = fleet_lanes(dev, bucket)
        outs[bucket] = step()
        torch.cuda.synchronize()
        ms_ev, host = [], []
        for _ in range(FLEET_REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            step()
            b.record()
            torch.cuda.synchronize()
            host.append(time.perf_counter() - t0)
            ms_ev.append(a.elapsed_time(b))
        rows[bucket] = {"pairs": int(pairs.ci.shape[0]),
                        "cells": int(st.cells.mass.shape[0]),
                        "C": int(st.cells.mass.shape[1]),
                        "step_event_ms": float(np.median(ms_ev)),
                        "step_host_ms": 1e3 * float(np.median(host))}
    nc = rows[1]["cells"]
    batched, one = outs[FLEET_LANES], outs[1]
    same = all(bits_equal([a[:nc]], [b]) for a, b in
               zip(tuple(batched.cells) + (batched.accel, batched.dudt),
                   tuple(one.cells) + (one.accel, one.dudt)))
    say({"phase": "fleet_step", "lanes": FLEET_LANES, "n_side": FLEET_NSIDE,
         "batched": rows[FLEET_LANES], "one_lane": rows[1],
         "event_ms_per_lane_batched":
             rows[FLEET_LANES]["step_event_ms"] / FLEET_LANES,
         "lane0_bitwise_one_lane": same})
    assert same, "a batched lane differs from the same lane stepped alone"
    del outs, batched, one
    torch.cuda.empty_cache()


def fleet_card_matches_cpu(dev, n_side: int = 10, requests: int = 4,
                           steps: int = 3) -> None:
    """Phase 7d: a small mixed fleet through the CLI's serve path on the
    card (with --check-parity: bit for bit the single runs there) and on
    the CPU (the plain versions); each request's fields within 1e-4 of
    their scale, the batching the same."""
    from repro_torch.fleet.__main__ import serve
    runs = []
    for d, extra in ((str(dev), ("--check-parity", "--assert-compiles")),
                     ("cpu", ())):
        rc, out, _, served = serve(fleet_argv(n_side, requests, steps, 1,
                                              "--device", d, *extra))
        assert rc == 0, (d, out["parity"])
        runs.append(served)
    worst = 0.0
    layout = True
    for a, b in zip(*runs):
        layout &= (a.result.batch_size, a.result.bucket, a.result.steps) == \
            (b.result.batch_size, b.result.bucket, b.result.steps)
        for k, x in a.result.particles.items():
            y = b.result.particles[k].astype(np.float64)
            scale = max(float(np.abs(y).max()), 1e-30)
            worst = max(worst, float(np.abs(x - y).max()) / scale)
    say({"phase": "fleet_card_vs_cpu", "n_side": n_side,
         "requests": requests, "steps": steps, "same_batching": layout,
         "max_rel_diff": worst})
    assert layout and worst <= 1e-4, "card and CPU fleets disagree"


# ---------------------------------------------------------------- LM slice
def ssd_inputs(B, S, H, hp, N, dev, seed=0):
    """The inputs of tests/test_kernel_ssd_scan.py:11, made on the host from
    a seed and moved to ``dev``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, H, hp)).astype(np.float32),
            (0.05 + 0.1 * rng.random((B, S, H))).astype(np.float32),
            (-(0.1 + rng.random(H))).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.random(H).astype(np.float32)]
    return [torch.from_numpy(a).to(dev) for a in arrs]


def scan_inputs(B, S, dI, N, dev, seed=0):
    """The inputs of tests/test_kernel_mamba_scan.py:make_inputs, made on
    the host from a seed and moved to ``dev``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, dI)).astype(np.float32),
            (0.05 + 0.1 * rng.random((B, S, dI))).astype(np.float32),
            (-rng.random((dI, N)) - 0.1).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.standard_normal((B, S, N)).astype(np.float32),
            rng.random(dI).astype(np.float32)]
    return [torch.from_numpy(a).to(dev) for a in arrs]


def qkv_inputs(B, S, T, H, K, hd, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev)
            for shape in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd))]


def lm_shapes(cfg, B: int, S: int):
    """The serve path's kernel shapes: ssd (B, S, H, hp, N), flash
    (B, S, H, K, hd)."""
    return ((B, S, cfg.d_inner // cfg.ssm_headdim, cfg.ssm_headdim,
             cfg.d_state),
            (B, S, cfg.n_heads, cfg.n_kv, cfg.head_dim))


def scan_shape(cfg, B: int, S: int):
    """The Mamba-1 serve path's selective_scan shape (B, S, dI, N)."""
    return B, S, cfg.d_inner, cfg.d_state


def scan_ops_bytes(B, S, dI, N, with_h0=False):
    """Operations and bytes of the selective scan as a function: per
    (b, t, d, n) dt·A, exp, the decay multiply and the input and C FMAs (7,
    an FMA counted as 2), per (b, t, d) dt·u and D·u plus its add (3);
    bytes: u, dt, B, C, A, D (and h0) read once, y and h written once."""
    ops = B * S * dI * (7 * N + 3)
    moved = 4 * (3 * B * S * dI + 2 * B * S * N + dI * N + dI
                 + B * dI * N * (2 if with_h0 else 1))
    return float(ops), float(moved)


def ssd_chunked_ops(S, N, hp, Q):
    """Operations of one (batch, head) strip of the SSD scan in the chunked
    form at chunk length Q, the ragged last chunk at its own length L (no
    padded steps): per chunk the triangular C·Bᵀ and M·u products (s ≤ t
    only), C·h and the state update (2·L·N·hp each), and the state's decay
    (N·hp); an FMA counts 2."""
    def chunk(L):
        return L * (L + 1) * (N + hp) + 4 * L * N * hp + N * hp
    full, last = divmod(S, Q)
    return full * chunk(Q) + (chunk(last) if last else 0)


def ssd_ops_bytes(B, S, H, hp, N):
    """Operations and bytes of the SSD scan as a function, whatever chunk a
    kernel uses: the least operation count over chunk lengths, or the
    sequential recurrence's 5·N·hp per step (decay, outer-product FMA, C·h)
    where that is lower; bytes: each input read once, y and h written once."""
    per_strip = min(min(ssd_chunked_ops(S, N, hp, Q) for Q in range(1, S + 1)),
                    5 * N * hp * S)
    moved = 4 * (2 * B * S * H * hp + 2 * B * S * N + B * S * H + 2 * H
                 + B * H * N * hp)
    return float(B * H * per_strip), float(moved)


def flash_ops_bytes(B, S, T, H, K, hd, causal, window):
    """Operations and bytes of attention over the live (query, key) pairs
    of this mask: q·k and p·v, 2·hd each, an FMA counted as 2; bytes: q, k,
    v read once, o written once."""
    qpos = np.arange(S)[:, None] + (T - S)
    kpos = np.arange(T)[None, :]
    ok = np.ones((S, T), bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    ops = 4.0 * hd * float(ok.sum()) * B * H
    moved = 4.0 * (2 * B * S * H * hd + 2 * B * T * K * hd)
    return ops, moved


def lm_bound(name, ops, moved) -> dict:
    """The least time of an LM kernel's work: bytes over the memory rate
    against operations over the peak rate of the units that do them. The
    kernels on the tensor cores (``TENSOR_CORE_KERNELS``) keep f32 accuracy
    with three TF32 products each; the f32 FMA figure stands beside their
    bound as ``fma_bound_ms``."""
    fma = Roofline(moved, ops)
    if name not in TENSOR_CORE_KERNELS:
        return {"bound_ms": fma.t_bound * 1e3, "bound_by": fma.bottleneck}
    tc = Roofline(moved, TF32_SPLIT * ops, PEAK_TF32_FLOPS)
    return {"bound_ms": tc.t_bound * 1e3,
            "bound_by": "bytes" if tc.bottleneck == "bytes"
            else "operations (3×TF32)",
            "fma_bound_ms": fma.t_bound * 1e3}


def dense_flash_shapes():
    """The dense models' prefill attention: (arch, (B, S, T, H, K, hd),
    window) at B = 4, S = T = 2048; gemma3-27b's local layers (its global
    ones are granite's shape less GQA 4:1, at 32/16 heads)."""
    from repro_torch.configs import get_config
    out = []
    for arch in DENSE_ARCHS:
        cfg = get_config(arch)
        window = cfg.local_window if cfg.local_global else None
        out.append((arch + ("-local" if window else ""),
                    (LM_BATCH, LM_PROMPT, LM_PROMPT, cfg.n_heads, cfg.n_kv,
                     cfg.head_dim), window))
    return out


def encdec_flash_cases():
    """Attention as the enc-dec and VLM prefills take it: (label, (B, S, T,
    H, K, hd), causal). seamless-m4t-large-v2's encoder (S = T = 2,048, no
    mask) and its cross-attention with fewer (1,500) and more (2,048 over
    700 queries) encoder frames than decoder tokens; internvl2-2b's causal
    self-attention over its 256 patches and the prompt; a ragged GQA case
    without a mask."""
    from repro_torch.configs import get_config
    sm, iv = (get_config(a) for a in ENCDEC_ARCHS)
    heads = (sm.n_heads, sm.n_kv, sm.head_dim)
    B, S, R = LM_BATCH, LM_PROMPT, LM_PROMPT + iv.vlm_patches
    return [("seamless-enc", (B, S, S) + heads, False),
            ("seamless-cross-short", (B, S, 1500) + heads, False),
            ("seamless-cross-long", (B, 700, S) + heads, False),
            ("internvl2", (B, R, R, iv.n_heads, iv.n_kv, iv.head_dim), True),
            ("gqa-noncausal-ragged", (2, 1000, 1537, 16, 8, 128), False)]


# the enc-dec and VLM cases that phases 9 and 13 time: the prefills' shapes
ENCDEC_TIMED = ("seamless-enc", "internvl2")


def moe_flash_cases():
    """Attention as the mixtrals' prefills take it: (label, (B, S, T, H, K,
    hd), window) at B = 4, S = T = 2,048 with the window of 4,096 (GQA 4:1
    for 8x7b, a group of 6 for 8x22b's 48/8 heads), and one 6,144-token
    sequence at 8x7b's heads where the window bites: the last queries see
    only 4,096 keys and whole key tiles before them are skipped."""
    from repro_torch.configs import get_config
    out = []
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        out.append((arch, (LM_BATCH, LM_PROMPT, LM_PROMPT, cfg.n_heads,
                           cfg.n_kv, cfg.head_dim), cfg.window))
    cfg = get_config(MOE_ARCHS[0])
    S = cfg.window + LM_PROMPT
    out.append(("mixtral-window-bites", (1, S, S, cfg.n_heads, cfg.n_kv,
                                         cfg.head_dim), cfg.window))
    return out


def lm_check_kernels(dev):
    """Phase 8: each LM kernel against its plain version at the serve
    path's shapes, plus GQA + window, ragged lengths and the enc-dec and
    VLM prefills' attention (``encdec_flash_cases``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    cfg = get_config(LM_ARCH)
    (sB, sS, sH, shp, sN), (fB, fS, fH, fK, fhd) = lm_shapes(
        cfg, LM_BATCH, LM_PROMPT)
    errs = {"ssd_scan": 0.0, "flash_attention": 0.0}
    for S, with_h0 in ((sS, False), (sS - 77, True)):
        args = ssd_inputs(sB, S, sH, shp, sN, dev, seed=S)
        h0 = (torch.randn(sB, sH, sN, shp, device=dev,
                          generator=torch.Generator(dev).manual_seed(1))
              if with_h0 else None)
        got = ssd_scan(*args, h0=h0)
        same = bits_equal(got, ssd_scan(*args, h0=h0))
        want = ssd_scan_ref(*args, chunk=cfg.ssm_chunk, h0=h0)
        e, ok = max_err(got, want, LM_RTOL)
        say({"phase": "lm_parity", "kernel": "ssd_scan",
             "shape": [sB, S, sH, shp, sN], "h0": with_h0,
             "max_abs_err": e, "rtol": LM_RTOL, "ok": ok,
             "run_twice_bitwise_equal": same})
        assert ok, "ssd_scan disagrees with its plain version"
        assert same, "ssd_scan differs from run to run"
        errs["ssd_scan"] = max(errs["ssd_scan"], e)
    cases = [("zamba2", (fB, fS, fS, fH, fK, fhd), None, None, True),
             ("gqa-window", (2, 1000, 1000, fH, fH // 4, fhd), 256, None,
              True),
             ("offset-queries", (2, 333, 1000, fH, fK, fhd), None, None,
              True)]
    cases += [(label, shape, window, None, True)
              for label, shape, window in dense_flash_shapes()]
    cases.append(("hd256-cap", (2, 1000, 1000, 16, 8, 256), 300, 30.0, True))
    cases += [(label, shape, None, None, causal)
              for label, shape, causal in encdec_flash_cases()]
    cases += [(label, shape, window, None, True)
              for label, shape, window in moe_flash_cases()]
    for label, (B, S, T, H, K, hd), window, cap, causal in cases:
        q, k, v = qkv_inputs(B, S, T, H, K, hd, dev, seed=S + T + hd)
        kw = dict(causal=causal, window=window, softcap=cap)
        got = flash_attention(q, k, v, **kw)
        same = bits_equal([got], [flash_attention(q, k, v, **kw)])
        want = flash_attention_ref(q, k, v, **kw)
        e, ok = max_err([got], [want], LM_RTOL)
        say({"phase": "lm_parity", "kernel": "flash_attention",
             "case": label, "shape": [B, S, T, H, K, hd], "causal": causal,
             "window": window, "softcap": cap, "max_abs_err": e,
             "rtol": LM_RTOL, "ok": ok, "run_twice_bitwise_equal": same})
        assert ok, "flash_attention disagrees with its plain version"
        assert same, "flash_attention differs from run to run"
        errs["flash_attention"] = max(errs["flash_attention"], e)
        del q, k, v, got, want
    errs["selective_scan"] = lm_check_scan(dev)
    return errs


def lm_check_scan(dev) -> float:
    """Phase 8, selective_scan: at the falcon-mamba-7b serve shape, and
    ragged (S and dI not multiples of the kernel's tiles) with an initial
    state."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_scan import (selective_scan,
                                                selective_scan_ref)
    B, S, dI, N = scan_shape(get_config(MAMBA1_ARCH), LM_BATCH, LM_PROMPT)
    worst = 0.0
    for S_, dI_, with_h0 in ((S, dI, False), (S - 77, dI - 40, True)):
        args = scan_inputs(B, S_, dI_, N, dev, seed=S_)
        h0 = (torch.randn(B, dI_, N, device=dev,
                          generator=torch.Generator(dev).manual_seed(1))
              if with_h0 else None)
        got = selective_scan(*args, h0=h0)
        same = bits_equal(got, selective_scan(*args, h0=h0))
        want = selective_scan_ref(*args, h0=h0)
        e, ok = max_err(got, want, LM_RTOL)
        say({"phase": "lm_parity", "kernel": "selective_scan",
             "shape": [B, S_, dI_, N], "h0": with_h0, "max_abs_err": e,
             "rtol": LM_RTOL, "ok": ok, "run_twice_bitwise_equal": same})
        assert ok, "selective_scan disagrees with its plain version"
        assert same, "selective_scan differs from run to run"
        worst = max(worst, e)
    return worst


def lm_time_kernels(dev):
    """Phase 9: LM kernel times at the serve path's shapes, beside the
    bound, the plain version and (attention) the library's call; then
    attention at the dense models' shapes."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    cfg = get_config(LM_ARCH)
    (sB, sS, sH, shp, sN), (fB, fS, fH, fK, fhd) = lm_shapes(
        cfg, LM_BATCH, LM_PROMPT)
    rows = {}
    args = ssd_inputs(sB, sS, sH, shp, sN, dev)
    ops, moved = ssd_ops_bytes(sB, sS, sH, shp, sN)
    rows["ssd_scan"] = dict(
        ms=cuda_time_ms(lambda: ssd_scan(*args), reps=20),
        plain_ms=cuda_time_ms(
            lambda: ssd_scan_ref(*args, chunk=cfg.ssm_chunk), reps=3),
        library_ms=None, operations=ops, bytes=moved,
        shape=[sB, sS, sH, shp, sN])
    del args
    rows["flash_attention"] = time_flash(dev, (fB, fS, fS, fH, fK, fhd),
                                         None)
    from repro_torch.kernels.mamba_scan import (selective_scan,
                                                selective_scan_ref)
    shape = scan_shape(get_config(MAMBA1_ARCH), LM_BATCH, LM_PROMPT)
    args = scan_inputs(*shape, dev)
    ops, moved = scan_ops_bytes(*shape)
    rows["selective_scan"] = dict(
        ms=cuda_time_ms(lambda: selective_scan(*args), reps=20),
        plain_ms=cuda_time_ms(lambda: selective_scan_ref(*args), reps=3),
        library_ms=None, operations=ops, bytes=moved, shape=list(shape))
    del args
    for name, r in rows.items():
        r.update(lm_bound(name, r["operations"], r["bytes"]))
        say({"phase": "lm_timing", "kernel": name, **r,
             "share_of_bound": r["bound_ms"] / r["ms"]})
    timed = [(model, shape, window, True)
             for model, shape, window in dense_flash_shapes()]
    timed += [(label, shape, None, causal)
              for label, shape, causal in encdec_flash_cases()
              if label in ENCDEC_TIMED]
    timed += [(label, shape, window, True)
              for label, shape, window in moe_flash_cases()]
    for model, shape, window, causal in timed:
        r = time_flash(dev, shape, window, causal)
        r.update(lm_bound("flash_attention", r["operations"], r["bytes"]))
        say({"phase": "lm_timing", "kernel": "flash_attention",
             "model": model, **r, "share_of_bound": r["bound_ms"] / r["ms"]})
    torch.cuda.empty_cache()
    return rows


def time_flash(dev, shape, window, causal: bool = True) -> dict:
    """``flash_attention``'s time at ``shape`` (B, S, T, H, K, hd), causal
    or not, with ``window``, beside its plain version's and
    ``scaled_dot_product_attention``'s on the same tensors (K and V
    repeated to the query heads outside the timed call; a window as an
    explicit boolean mask)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    B, S, T, H, K, hd = shape
    q, k, v = qkv_inputs(B, S, T, H, K, hd, dev)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.repeat_interleave(H // K, dim=2).transpose(1, 2).contiguous()
              for t in (k, v))
    lib = sdpa_mask(dev, S, T, window, causal)
    ops, moved = flash_ops_bytes(B, S, T, H, K, hd, causal, window)
    kw = dict(causal=causal, window=window)
    row = dict(
        ms=cuda_time_ms(lambda: flash_attention(q, k, v, **kw), reps=20),
        plain_ms=cuda_time_ms(lambda: flash_attention_ref(q, k, v, **kw),
                              reps=3),
        library_ms=cuda_time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, **lib),
            reps=20),
        operations=ops, bytes=moved, shape=list(shape), window=window,
        causal=causal)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def sdpa_mask(dev, S, T, window, causal) -> dict:
    """``scaled_dot_product_attention``'s mask arguments for the flash
    kernel's mask (query row i at key position i + T − S): ``is_causal``
    without a window (its causal mask is aligned to the top-left, which is
    the same only for S = T, as at every timed shape), an explicit boolean
    mask with one."""
    if window is None:
        return dict(is_causal=causal)
    qpos = torch.arange(S, device=dev)[:, None] + (T - S)
    kpos = torch.arange(T, device=dev)[None, :]
    return dict(attn_mask=(kpos <= qpos) & (kpos > qpos - window))


def lm_kernel_modules():
    """The LM kernels' wrapper modules by kernel name."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.mamba_scan import kernel as MK
    from repro_torch.kernels.ssd_scan import kernel as SK
    return {"ssd_scan": (SK, SK.ssd_scan),
            "flash_attention": (FK, FK.flash_attention),
            "selective_scan": (MK, MK.selective_scan)}


def entry(name: str, dtype) -> str:
    """The kernels line's name of a kernel's entry: ``name`` for the f32
    entry, ``name + "_bf16"`` for the bf16 one."""
    return name + ("_bf16" if dtype == torch.bfloat16 else "")


LM_ENTRIES = [entry(n, d) for n in ("ssd_scan", "flash_attention",
                                    "selective_scan")
              for d in (torch.float32, torch.bfloat16)]


def lm_launches() -> dict:
    """Each LM kernel entry's launch count (``entry`` names)."""
    return {entry(name, d): n for name, (_, fn) in lm_kernel_modules().items()
            for d, n in fn.launches_by_dtype.items()}


def lm_expected_launches(cfg) -> dict:
    """Launches of each LM kernel entry in one full prefill of ``cfg``
    (attention: once a layer's self-attention, and once an encoder layer
    and a cross-attention of an enc-dec model): a
    bf16 model's attention through the bf16 flash entry, its SSD scan
    through the bf16 entry only under ``ssm_bf16`` (else the model passes
    f32, as the reference), its Mamba-1 scan through the f32 entry (the
    reference upcasts before the scan)."""
    want = dict.fromkeys(LM_ENTRIES, 0)
    flash = entry("flash_attention", cfg.dtype)
    if cfg.family in ("dense", "vlm", "moe"):   # one per attention layer
        want[flash] = cfg.n_layers
    elif cfg.family == "encdec":   # the encoder's, decoder self and cross
        want[flash] = cfg.n_enc_layers + 2 * cfg.n_layers
    elif cfg.ssm == "mamba1":
        want["selective_scan"] = cfg.n_layers
    else:
        want[entry("ssd_scan", cfg.dtype if cfg.ssm_bf16
                   else torch.float32)] = cfg.n_layers
        want[flash] = cfg.n_layers // cfg.shared_attn_every
    return want


def lm_serve_path(dev, arch: str, n_layers=None, *, dtype=torch.float32,
                  batch: int = LM_BATCH, ssm_bf16: bool = False,
                  f32_figures=None):
    """Phases 10 and 14: ``arch`` at full width through the port's serving
    entry points (``prefill``, ``greedy_decode``), as
    ``python -m repro_torch.launch.serve`` drives them, in ``dtype`` (bf16:
    the configuration's own) at ``batch`` prompts; ``n_layers`` cuts its
    depth. ``f32_figures``, phase 10's line of the same model, is printed
    beside a bf16 run's."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params, rolling_map
    from repro_torch.models.convert import leaves
    from repro_torch.launch.serve import frontend_inputs
    from repro_torch.serve.serve_step import greedy_decode, prefill
    kernels = lm_kernel_modules()

    def reset():
        for mod, _ in kernels.values():
            mod.reset_launches()

    cfg = dataclasses.replace(get_config(arch), dtype=dtype,
                              ssm_bf16=ssm_bf16)
    published_layers = cfg.n_layers
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen)
    prompts = torch.randint(0, cfg.vocab, (batch, LM_PROMPT),
                            generator=gen, device=dev)
    # seamless's encoder over as many frames as the prompt, as the launcher
    front = frontend_inputs(cfg, batch, LM_PROMPT, gen, dev)
    P = cfg.vlm_patches                  # the patches come before the prompt
    synchronize(dev)
    n_params = sum(t.numel() for t in leaves(params))
    say({"phase": "lm_setup", "arch": cfg.name, "dtype": str(dtype),
         "ssm_bf16": ssm_bf16, "params": n_params,
         "param_bytes": sum(t.numel() * t.element_size()
                            for t in leaves(params)),
         "analytic_params": cfg.n_params(), "n_layers": cfg.n_layers,
         "published_layers": published_layers,
         "seconds": time.perf_counter() - t0})
    cache_len = LM_PROMPT + LM_NEW + P
    with torch.inference_mode():
        # a first prefill (the forward in prefill mode, as ``prefill`` runs
        # it) warms the libraries; its last logits are the first of the
        # run-twice pair, and it gives the MoE layers' summed stats
        res = forward(params, cfg, prompts, mode="prefill",
                      rolling=rolling_map(cfg, cache_len), **front)
        first = res.logits[:, -1].clone()
        moe_stats = ({"expert_counts": res.expert_counts.tolist(),
                      "aux_loss": float(res.aux_loss)}
                     if cfg.n_experts else {})
        del res
        synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset()
        t0 = time.perf_counter()
        logits, caches, rolling = prefill(params, cfg, prompts,
                                          cache_len=cache_len, **front)
        synchronize(dev)
        t_prefill = time.perf_counter() - t0
        prefill_launches = lm_launches()
        same = torch.equal(first, logits)
        finite = bool(torch.isfinite(logits).all())
        reset()
        marks = [time.perf_counter()]
        step_finite = []

        def on_step(step_logits):
            step_finite.append(torch.isfinite(step_logits).all())
            synchronize(dev)
            marks.append(time.perf_counter())

        tokens = greedy_decode(params, cfg, logits, caches, LM_PROMPT + P,
                               LM_NEW, rolling=rolling, on_step=on_step)
        decode_launches = lm_launches()
    finite &= all(bool(f) for f in step_finite)
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    window_s = marks[-1] - marks[0]
    peak = torch.cuda.max_memory_allocated(dev)
    line = {"phase": "lm_serve" if dtype == torch.float32 else
            "lm_serve_bf16", "arch": cfg.name, "dtype": str(dtype),
            "ssm_bf16": ssm_bf16, "n_layers": cfg.n_layers,
            "batch": batch, "prompt_len": LM_PROMPT, "new_tokens": LM_NEW,
            "encoder_tokens": (batch * front["enc_inputs"].shape[1]
                               if "enc_inputs" in front else 0),
            "patches": batch * P, "cache_len": cache_len,
            "rolling": rolling,
            "prefill_s": t_prefill,
            "prefill_tokens_per_s": batch * LM_PROMPT / t_prefill,
            "decode_ms_per_step": float(np.median(step_ms)),
            "decode_ms_per_step_all": step_ms,
            "decode_tokens_per_s": batch * 1e3 / float(np.median(step_ms)),
            "decode_window_s": window_s,
            "decode_window_tokens_per_s": batch * len(step_ms) / window_s,
            "peak_memory_bytes": peak, "logits_finite": finite,
            "logits_dtype": str(logits.dtype),
            "prefill_launches": prefill_launches,
            "decode_launches": decode_launches,
            "prefill_twice_bitwise_equal": same,
            "sample_tokens": tokens[0, :16].tolist(), **moe_stats}
    if f32_figures is not None:
        line["f32"] = {k: f32_figures[k] for k in (
            "n_layers", "batch", "prefill_s", "prefill_tokens_per_s",
            "decode_ms_per_step", "decode_window_s", "peak_memory_bytes")}
    say(line)
    assert finite, "non-finite logits on the serve path"
    assert same, "two full-width prefills gave different logits"
    assert logits.dtype == dtype, logits.dtype
    want = lm_expected_launches(cfg)
    assert prefill_launches == want, (prefill_launches, want)
    assert not any(decode_launches.values()), decode_launches
    del params, caches, logits, first, front
    torch.cuda.empty_cache()
    return line, {k: prefill_launches[k] + decode_launches[k]
                  for k, v in want.items() if v}


def lm_run(params, cfg, tokens, prompt_len, front):
    """Teacher-forced prefill + decode over ``tokens`` (after the patches,
    with the encoder's frames, of ``front``) and greedy generation of 8
    tokens from the prompt; logits and tokens on the host."""
    from repro_torch.serve.serve_step import (decode_step, greedy_generate,
                                              prefill)
    S, P = tokens.shape[1], cfg.vlm_patches
    with torch.inference_mode():
        lg, caches, rolling = prefill(params, cfg, tokens[:, :prompt_len],
                                      cache_len=S + P, **front)
        steps = [lg.cpu().numpy()]
        for t in range(prompt_len, S):
            lg, caches = decode_step(params, cfg, tokens[:, t:t + 1], caches,
                                     t + P, rolling=rolling)
            steps.append(lg.cpu().numpy())
        greedy = greedy_generate(params, cfg, tokens[:, :prompt_len], 8,
                                 **front)
    return np.stack(steps), greedy.cpu().numpy()


def cpu_frontend(cfg, batch: int, seed: int = LM_SEED) -> dict:
    """The stub frontends' inputs for the card-against-CPU phases, drawn on
    the host from a seed: ``ENC_CPU_LEN`` encoder frames (not the prompt's
    length: cross-attention with S ≠ T), or the VLM's patches."""
    from repro_torch.launch.serve import frontend_inputs
    return frontend_inputs(cfg, batch, ENC_CPU_LEN,
                           torch.Generator().manual_seed(seed), "cpu")


def lm_card_matches_cpu(dev, arch: str, prompt_len: int = 100,
                        steps: int = 8):
    """Phase 11: ``arch``'s reduced configuration on the card and on the
    CPU (plain versions, which the CPU tests hold against the JAX
    reference): teacher-forced logits within 1e-4 of their scale, greedy
    tokens equal."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.convert import tree_map
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(LM_SEED))
    tokens = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab, (2, prompt_len + steps)))
    front = cpu_frontend(cfg, 2)
    on_card = tree_map(lambda t: t.to(dev), params)
    a, ga = lm_run(on_card, cfg, tokens.to(dev), prompt_len,
                   tree_map(lambda t: t.to(dev), front))
    b, gb = lm_run(params, cfg, tokens, prompt_len, front)
    scale = float(np.abs(b).max())
    rel = float(np.abs(a - b).max()) / scale
    same_argmax = bool((a.argmax(-1) == b.argmax(-1)).all())
    same_greedy = bool((ga == gb).all())
    say({"phase": "lm_card_vs_cpu", "arch": cfg.name,
         "prompt_len": prompt_len, "decode_steps": steps,
         "encoder_len": (ENC_CPU_LEN if cfg.is_encdec else None),
         "patches": cfg.vlm_patches,
         "max_rel_diff": rel, "rtol": LM_CARD_CPU_RTOL,
         "argmax_equal": same_argmax, "greedy_tokens_equal": same_greedy})
    assert rel <= LM_CARD_CPU_RTOL, "card and CPU logits disagree"
    assert same_argmax and same_greedy, "card and CPU tokens differ"



# ---------------------------------------------------------- the bf16 slice
def bf16_err(got, want, rtol):
    """(max |got − want|, its excess over one bf16 rounding of want as a
    share of the scale, passes): each output within 2^-7 |want| + rtol ·
    max |want| of the plain version's."""
    got, want = got.float(), want.float()
    scale = max(float(want.abs().max()), 1e-30)
    d = (got - want).abs()
    excess = float((d - BF16_REL * want.abs()).max()) / scale
    return float(d.max()), excess, excess <= rtol


def ptxas_resources(lines) -> dict:
    """{entry symbol: {"registers", "spill_stores", "spill_loads"}} from
    ``ptxas -v`` lines (a build's output, or ``build.BUILD_LOG[name]
    ["ptxas"]``)."""
    out, cur = {}, None
    for ln in lines:
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
    return out


def flash_bf16_resources(lines, hd: int, cap: bool = False,
                         kernel: str = None) -> dict:
    """The registers and spill bytes that ptxas reported for the bf16 flash
    kernel serving head width ``hd`` (``flash_bf16_hopper`` at hd 64, 128
    and 256, ``flash_kernel_bf16`` at 16 and 32, or ``kernel``; None where
    ``lines`` lack it, as for a library found built)."""
    name = kernel or ("flash_bf16_hopper" if hd >= 64 else
                      "flash_kernel_bf16")
    key = f"{name}ILi{hd}ELb{int(cap)}E"
    res = next((r for sym, r in ptxas_resources(lines).items()
                if key in sym), {})
    return {"kernel_function": name, "registers": res.get("registers"),
            "spill_bytes": (res["spill_stores"] + res["spill_loads"]
                            if "spill_stores" in res else None)}


def bf16_flash_cases():
    """Phase 12's attention cases: (label, (B, S, T, H, K, hd), window,
    soft-cap) at the serve paths' shapes (zamba2 hd 64, granite hd 128 GQA,
    gemma-7b hd 256 with and without a cap, gemma3's local layers, qwen
    40/40 at B = 1), then ragged S and T ≠ S."""
    from repro_torch.configs import get_config
    out = []
    for arch in ("zamba2-1.2b", "granite-8b", "gemma-7b", "gemma3-27b",
                 "qwen1.5-32b"):
        cfg = get_config(arch)
        window = cfg.local_window if cfg.local_global else None
        B = 1 if arch == "qwen1.5-32b" else LM_BATCH
        shape = (B, LM_PROMPT, LM_PROMPT, cfg.n_heads, cfg.n_kv, cfg.head_dim)
        out.append((arch + ("-local" if window else ""), shape, window, None))
        if arch == "gemma-7b":
            out.append((arch + "-softcap", shape, None, 50.0))
    out += [("ragged-gqa-window", (2, 1000, 1000, 32, 8, 128), 256, None),
            ("offset-queries", (2, 333, 1000, 32, 32, 64), None, None)]
    return out


def lm_check_kernels_bf16(dev) -> dict:
    """Phase 12: each kernel's bf16 entry against its plain version on the
    same bf16 inputs at the serve paths' shapes, run twice bitwise; outputs
    bf16 both sides (the scans' states f32)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.mamba_scan import (selective_scan,
                                                selective_scan_ref)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    errs = dict.fromkeys(("flash_attention_bf16", "ssd_scan_bf16",
                          "selective_scan_bf16"), 0.0)
    cases = [(label, shape, window, cap, True)
             for label, shape, window, cap in bf16_flash_cases()]
    cases += [(label, shape, None, None, causal)
              for label, shape, causal in encdec_flash_cases()]
    cases += [(label, shape, window, None, True)
              for label, shape, window in moe_flash_cases()]
    for label, (B, S, T, H, K, hd), window, cap, causal in cases:
        q, k, v = (t.bfloat16() for t in
                   qkv_inputs(B, S, T, H, K, hd, dev, seed=S + T + hd))
        kw = dict(causal=causal, window=window, softcap=cap)
        got = flash_attention(q, k, v, **kw)
        same = torch.equal(got, flash_attention(q, k, v, **kw))
        want = flash_attention_ref(q, k, v, **kw)
        e, excess, ok = bf16_err(got, want, BF16_FLASH_RTOL)
        say({"phase": "lm_parity_bf16", "kernel": "flash_attention_bf16",
             "case": label, "shape": [B, S, T, H, K, hd], "causal": causal,
             "window": window, "softcap": cap,
             "dtype": [str(got.dtype), str(want.dtype)],
             "max_abs_err": e, "excess_over_one_rounding": excess,
             "rtol": BF16_FLASH_RTOL, "ok": ok,
             "run_twice_bitwise_equal": same})
        assert got.dtype == want.dtype == torch.bfloat16
        assert ok, "flash_attention_bf16 disagrees with its plain version"
        assert same, "flash_attention_bf16 differs from run to run"
        errs["flash_attention_bf16"] = max(errs["flash_attention_bf16"], e)
        del q, k, v, got, want
        torch.cuda.empty_cache()
    cfg = get_config(LM_ARCH)
    (sB, sS, sH, shp, sN), _ = lm_shapes(cfg, LM_BATCH, LM_PROMPT)
    falcon = scan_shape(get_config(MAMBA1_ARCH), LM_BATCH, LM_PROMPT)
    scans = [("ssd_scan_bf16", ssd_scan, ssd_scan_ref, S, with_h0,
              ssd_inputs(sB, S, sH, shp, sN, dev, seed=S),
              (sB, sH, sN, shp))
             for S, with_h0 in ((sS, False), (sS - 77, True))]
    B, S, dI, N = falcon
    scans += [("selective_scan_bf16", selective_scan, selective_scan_ref,
               S_, with_h0, scan_inputs(B, S_, dI_, N, dev, seed=S_),
               (B, dI_, N))
              for S_, dI_, with_h0 in ((S, dI, False),
                                       (S - 77, dI - 40, True))]
    for name, kern, plain, S_, with_h0, args, hshape in scans:
        u, dt, A, Bm, Cm, D = args
        args = [u.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16(), D]
        h0 = (torch.randn(*hshape, device=dev,
                          generator=torch.Generator(dev).manual_seed(1))
              if with_h0 else None)
        y, h = kern(*args, h0=h0)
        y2, h2 = kern(*args, h0=h0)
        same = torch.equal(y, y2) and torch.equal(h, h2)
        y_p, h_p = plain(*args, h0=h0)
        e, excess, ok = bf16_err(y, y_p, LM_RTOL)
        eh, ok_h = max_err([h], [h_p], LM_RTOL)
        bitwise = {}
        if name == "selective_scan_bf16":
            # the f32 entry on the same values widened: h bit for bit, y
            # that entry's rounded once to bf16
            wide = [t.float() for t in args]
            y32, h32 = kern(*wide, h0=h0)
            bitwise["bitwise_f32_entry"] = (torch.equal(h, h32) and
                                            torch.equal(y, y32.bfloat16()))
            del wide, y32, h32
        say({"phase": "lm_parity_bf16", "kernel": name,
             "shape": list(u.shape) + ([N] if name.startswith("selective")
                                       else [sN]),
             "h0": with_h0, "dtype": [str(y.dtype), str(y_p.dtype),
                                      str(h.dtype)],
             "max_abs_err": e, "excess_over_one_rounding": excess,
             "state_max_abs_err": eh, "rtol": LM_RTOL, "ok": ok and ok_h,
             "run_twice_bitwise_equal": same, **bitwise})
        assert y.dtype == y_p.dtype == torch.bfloat16
        assert h.dtype == torch.float32
        assert ok and ok_h, f"{name} disagrees with its plain version"
        assert same, f"{name} differs from run to run"
        assert bitwise.get("bitwise_f32_entry", True), \
            f"{name} is not the f32 entry's arithmetic bit for bit"
        errs[name] = max(errs[name], e, eh)
        del args, y, y2, h, h2, y_p, h_p
        torch.cuda.empty_cache()
    return errs


def bf16_flash_bound(B, S, T, H, K, hd, window, causal: bool = True) -> dict:
    """The bf16 attention's bound: its bf16 bytes (q, k, v read once, o
    written once), its products at the dense bf16 rate, its f32 softmax
    work (FLASH_F32_OPS_PER_PAIR a live pair) at the f32 rate."""
    ops, moved_f32 = flash_ops_bytes(B, S, T, H, K, hd, causal, window)
    pairs = ops / (4.0 * hd)
    roof = Roofline(moved_f32 / 2, ops, PEAK_BF16_FLOPS,
                    f32_operations=FLASH_F32_OPS_PER_PAIR * pairs)
    return {"operations": ops, "f32_operations": FLASH_F32_OPS_PER_PAIR
            * pairs, "bytes": moved_f32 / 2, "bound_ms": roof.t_bound * 1e3,
            "bound_by": roof.bottleneck}


def bf16_selective_bound(B, S, dI, N) -> dict:
    """The bf16 Mamba-1 scan's bound: its bytes with u, B, C and y in bf16,
    its recurrence on the f32 pipes (``lm_bound``)."""
    ops, moved = scan_ops_bytes(B, S, dI, N)
    moved -= 2 * (2 * B * S * dI + 2 * B * S * N)
    return {"operations": ops, "bytes": float(moved),
            **lm_bound("selective_scan", ops, moved)}


def bf16_ssd_bound(B, S, H, hp, N) -> dict:
    """The bf16 SSD scan's bound: its bytes with u, B, C and y in bf16 (dt,
    A, D and h in f32), its products at the dense bf16 rate, and its f32
    work at the f32 rate: per chunk of length L the L(L+1)/2 segment-sum
    exponentials and their products with C·Bᵀ, the dt scaling of u (L·hp)
    and the state's decay (N·hp), at the chunk length with the fewest
    operations."""
    ops, moved = ssd_ops_bytes(B, S, H, hp, N)
    moved -= 2 * (2 * B * S * H * hp + 2 * B * S * N)
    Q = min(range(1, S + 1), key=lambda q: ssd_chunked_ops(S, N, hp, q))
    full, last = divmod(S, Q)
    f32 = sum(n * (L * (L + 1) + L * hp + N * hp)
              for L, n in ((Q, full), (last, int(last > 0)))) * B * H
    roof = Roofline(moved, ops, PEAK_BF16_FLOPS, f32_operations=f32)
    return {"operations": ops, "f32_operations": float(f32),
            "bytes": float(moved), "bound_ms": roof.t_bound * 1e3,
            "bound_by": roof.bottleneck}


def lm_time_kernels_bf16(dev) -> dict:
    """Phase 13: each bf16 entry's time (``cuda_time_ms``, 20 calls) at the
    serve paths' shapes, beside its bound, its plain version's time, the f32
    entry's on the same shapes and, for attention,
    ``scaled_dot_product_attention`` in bf16 on the same tensors (K and V
    repeated outside the timed call, a boolean mask for a window); beside
    each attention row the kernel's registers and spill bytes (ptxas, from
    ``build.BUILD_LOG``) and its dynamic shared memory (the library's
    ``flash_attention_bf16_smem_bytes``)."""
    import ctypes
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.mamba_scan import (selective_scan,
                                                selective_scan_ref)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    smem_bytes = FK.library().flash_attention_bf16_smem_bytes
    smem_bytes.argtypes, smem_bytes.restype = [ctypes.c_int], ctypes.c_int
    rows = {}
    timed = [(label, shape, window, True)
             for label, shape, window, cap in bf16_flash_cases()
             if cap is None and label not in ("ragged-gqa-window",
                                              "offset-queries")]
    timed += [(label, shape, None, causal)
              for label, shape, causal in encdec_flash_cases()
              if label in ENCDEC_TIMED]
    timed += [(label, shape, window, True)
              for label, shape, window in moe_flash_cases()]
    for label, (B, S, T, H, K, hd), window, causal in timed:
        q, k, v = (t.bfloat16() for t in qkv_inputs(B, S, T, H, K, hd, dev))
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.repeat_interleave(H // K, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        lib = sdpa_mask(dev, S, T, window, causal)
        kw = dict(causal=causal, window=window)
        row = dict(
            model=label, shape=[B, S, T, H, K, hd], window=window,
            causal=causal,
            ms=cuda_time_ms(lambda: flash_attention(q, k, v, **kw), reps=20),
            plain_ms=cuda_time_ms(lambda: flash_attention_ref(q, k, v, **kw),
                                  reps=3),
            library_ms=cuda_time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, **lib),
                reps=20))
        del qt, kt, vt
        qf, kf, vf = (t.float() for t in (q, k, v))
        row["f32_entry_ms"] = cuda_time_ms(
            lambda: flash_attention(qf, kf, vf, **kw), reps=20)
        del q, k, v, qf, kf, vf
        row.update(bf16_flash_bound(B, S, T, H, K, hd, window, causal))
        row.update(flash_bf16_resources(
            build.BUILD_LOG.get("flash_attention", {}).get("ptxas", []), hd))
        row["dynamic_smem_bytes"] = smem_bytes(hd)
        say({"phase": "lm_timing_bf16", "kernel": "flash_attention_bf16",
             **row, "share_of_bound": row["bound_ms"] / row["ms"]})
        rows.setdefault("flash_attention_bf16", row)   # zamba2's: the line's
        torch.cuda.empty_cache()
    cfg = get_config(LM_ARCH)
    (sB, sS, sH, shp, sN), _ = lm_shapes(cfg, LM_BATCH, LM_PROMPT)
    falcon = scan_shape(get_config(MAMBA1_ARCH), LM_BATCH, LM_PROMPT)
    for name, kern, plain, args, bound, kw in (
            ("ssd_scan_bf16", ssd_scan, ssd_scan_ref,
             ssd_inputs(sB, sS, sH, shp, sN, dev),
             bf16_ssd_bound(sB, sS, sH, shp, sN),
             dict(chunk=cfg.ssm_chunk)),
            ("selective_scan_bf16", selective_scan, selective_scan_ref,
             scan_inputs(*falcon, dev), bf16_selective_bound(*falcon), {})):
        u, dt, A, Bm, Cm, D = args
        b16 = [u.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16(), D]
        row = dict(ms=cuda_time_ms(lambda: kern(*b16), reps=20),
                   plain_ms=cuda_time_ms(lambda: plain(*b16, **kw), reps=3),
                   f32_entry_ms=cuda_time_ms(lambda: kern(*args), reps=20),
                   library_ms=None, shape=list(u.shape), **bound)
        del args, b16
        if name == "ssd_scan_bf16":
            row.update(ssd_bf16_details(dev, sS, sH, shp, sN))
        else:
            row.update(selective_bf16_details(dev, *falcon, row["ms"]))
        say({"phase": "lm_timing_bf16", "kernel": name, **row,
             "share_of_bound": row["bound_ms"] / row["ms"]})
        rows[name] = row
        torch.cuda.empty_cache()
    return rows


def ssd_bf16_details(dev, S, H, hp, N) -> dict:
    """Beside phase 13's ``ssd_scan_bf16`` row: the route that (N, hp)
    takes, the kernel's registers, spill bytes and dynamic shared memory,
    and its time at batch 1 (H CTAs for the card's 132 SMs) beside the
    bound there."""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ssd_scan
    smem = SK.library().ssd_scan_bf16_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    fn = ("ssd_bf16_hopper" if SK.hopper_route(N, hp) else
          f"ssd_scan_kernelILi{N}ELi{hp}E13__nv_bfloat16")
    res = next((r for sym, r in ptxas_resources(build.BUILD_LOG.get(
        "ssd_scan", {}).get("ptxas", [])).items() if fn in sym), {})
    u, dt, A, Bm, Cm, D = ssd_inputs(1, S, H, hp, N, dev)
    b16 = [u.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16(), D]
    return {"kernel_function": fn, "registers": res.get("registers"),
            "spill_bytes": (res["spill_stores"] + res["spill_loads"]
                            if "spill_stores" in res else None),
            "dynamic_smem_bytes": smem(N, hp),
            "ms_batch1": cuda_time_ms(lambda: ssd_scan(*b16), reps=20),
            "bound_ms_batch1": bf16_ssd_bound(1, S, H, hp, N)["bound_ms"]}


def exp_floor_ms(B, S, dI, N, sms: int, clock_hz: float) -> float:
    """The Mamba-1 scan's exponentials at the MUFU rate: one a state-step
    (B·S·dI·N) at 16 a clock an SM, ms."""
    return B * S * dI * N / (16.0 * sms * clock_hz) * 1e3


def selective_bf16_details(dev, B, S, dI, N, ms: float) -> dict:
    """Beside phase 13's ``selective_scan_bf16`` row: the kernel's
    function, registers, spill bytes, dynamic shared memory and CTAs an SM,
    and the floor of its exponentials (``exp_floor_ms`` at the card's
    highest SM clock) with the share of it that ``ms`` reaches."""
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba_scan import kernel as MK
    lib = MK.library()
    fn = f"selective_scan_bf16_hopperILi{N}E"
    res = next((r for sym, r in ptxas_resources(build.BUILD_LOG.get(
        "selective_scan", {}).get("ptxas", [])).items() if fn in sym), {})
    clock = max_sm_clock_hz()
    floor = exp_floor_ms(B, S, dI, N,
                         torch.cuda.get_device_properties(dev)
                         .multi_processor_count, clock)
    return {"kernel_function": "selective_scan_bf16_hopper",
            "registers": res.get("registers"),
            "spill_bytes": (res["spill_stores"] + res["spill_loads"]
                            if "spill_stores" in res else None),
            "dynamic_smem_bytes": lib.selective_scan_bf16_smem_bytes(N),
            "ctas_per_sm": lib.selective_scan_bf16_ctas_per_sm(N),
            "sm_clock_max_hz": clock, "exp_floor_ms": floor,
            "share_of_exp_floor": floor / ms}


def lm_card_matches_cpu_bf16(dev, arch: str, *, prompt_len=BF16_CPU_PROMPT,
                             ssm_bf16: bool = False):
    """Phase 15: ``arch``'s reduced configuration in bf16 on the card and
    on the CPU, teacher-forced over 8 prompts, against the same model in
    f32 on the CPU from the same parameters (each bf16 value widened
    exactly): at every step the RMS of (card − CPU bf16) at most
    BF16_RATIO × the RMS of (CPU bf16 − CPU f32) — for an MoE model over
    all steps at once, as tests/test_torch_lm_bf16.py holds it (a bf16
    router tie sends a token to another expert now and then, a jump that
    lands in one step of one prompt) —; the card's run launches each LM
    kernel entry as one prefill of ``cfg`` should and no other."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.convert import tree_map
    from repro_torch.serve.serve_step import decode_step, prefill
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              ssm_bf16=ssm_bf16)
    assert cfg.dtype == torch.bfloat16
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, ssm_bf16=False)
    params = init_params(cfg, torch.Generator().manual_seed(LM_SEED))
    params32 = tree_map(lambda t: t.float(), params)
    steps = BF16_CPU_STEPS
    tokens = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab, (BF16_CPU_BATCH, prompt_len + steps)))
    front = cpu_frontend(cfg, BF16_CPU_BATCH)     # f32, cast by the model
    P = cfg.vlm_patches

    def run(p, c, toks, fr):
        with torch.inference_mode():
            lg, caches, rolling = prefill(p, c, toks[:, :prompt_len],
                                          cache_len=prompt_len + steps + P,
                                          **fr)
            out = [lg.float().cpu().numpy()]
            for t in range(prompt_len, prompt_len + steps):
                lg, caches = decode_step(p, c, toks[:, t:t + 1], caches,
                                         t + P, rolling=rolling)
                out.append(lg.float().cpu().numpy())
        return np.stack(out)

    before = lm_launches()
    card = run(tree_map(lambda t: t.to(dev), params), cfg, tokens.to(dev),
               tree_map(lambda t: t.to(dev), front))
    launched = {k: n - before[k] for k, n in lm_launches().items()
                if n != before[k]}
    cpu16 = run(params, cfg, tokens, front)
    cpu32 = run(params32, cfg32, tokens, front)
    axes = None if cfg.family == "moe" else (1, 2)
    rms = lambda a: np.atleast_1d(np.sqrt(np.mean(np.square(a), axis=axes)))
    scale = rms(cpu32)
    mine = rms(card - cpu16) / scale
    own = rms(cpu16 - cpu32) / scale
    ok = bool(np.all(mine <= BF16_RATIO * own))
    want = {k: n for k, n in lm_expected_launches(cfg).items() if n}
    say({"phase": "lm_card_vs_cpu_bf16", "arch": cfg.name,
         "ssm_bf16": ssm_bf16, "batch": BF16_CPU_BATCH,
         "prompt_len": prompt_len, "decode_steps": steps,
         "encoder_len": (ENC_CPU_LEN if cfg.is_encdec else None),
         "patches": P,
         "card_vs_cpu_bf16_rms": mine.tolist(),
         "cpu_bf16_vs_f32_rms": own.tolist(),
         "ratio": (mine / own).tolist(), "ratio_limit": BF16_RATIO,
         "card_launches": launched, "expected_launches": want, "ok": ok})
    assert launched == want, f"{cfg.name}: launches {launched}, want {want}"
    assert ok, "card and CPU bf16 logits disagree beyond the bf16 bound"


# -------------------------------------------------------- the training slice
# Phase 16: the backward of the f32 flash entry (``flash_attention_bwd``)
# against the plain version's autograd, within BWD_RTOL of each gradient's
# scale (the forward's tolerance, relative to the scale as the CPU tests
# hold it), and the forward's LSE, +inf exactly on the rows with no live
# key. Its bound counts 5 products a live (query, key) pair (S = QKᵀ, dP =
# dO Vᵀ, dV += Pᵀ dO, dK += dSᵀ Q, dQ += dS K; the forward does 2) in
# 3×TF32, whatever the kernel does: the yardstick PR 29's shares were read
# against. Beside it stands the route's own bound, the same 5 products in
# the arithmetic of the kernel that serves the width (``bwd_bounds``). The
# kernel does 7 at every width (``BWD_KERNEL_PRODUCTS``: S and dP once in
# each of its two launches, dQ in one, dK and dV together in the other);
# at hd 64, 128 and 256 as ``flash_bwd_hopper`` (TMA-fed f32 tiles split
# once a tile into two bf16 pieces, three bf16 ``wgmma`` passes a product:
# 3×bf16 at the bf16 peak, half the 3×TF32 time; S and dP each formed by
# one of two warpgroups that share them), at hd 16 and 32 as the mma.sync
# kernel (3×TF32). Each case prints the route that served it, the
# products a live pair, the kernels' shared memory and their ptxas
# registers and spill bytes.
BWD_RTOL = 2e-4
BWD_PRODUCTS = 5
BWD_KERNEL_PRODUCTS = 7
# each route's passes a product, their peak rate and its name
BWD_ROUTE_ARITHMETIC = {"hopper": (3, PEAK_BF16_FLOPS, "3×bf16"),
                        "mma_sync": (TF32_SPLIT, PEAK_TF32_FLOPS, "3×TF32"),
                        "bf16": (1, PEAK_BF16_FLOPS, "bf16")}
# Phase 16's bf16 half: the bf16 entry's backward (``flash_attention_bwd``
# on bf16 tensors: ``flash_attention_bwd_bf16``, one bf16 pass a product
# on either route; at hd 64, 128 and 256 one launch of
# ``flash_bwd_bf16_hopper`` after D forms 5 products a live pair
# (``BWD_PRODUCTS``), at hd 16 and 32 the mma.sync kernel's two launches
# form ``BWD_KERNEL_PRODUCTS``) at the same cases, each of dq, dk and dv within
# BWD_BF16_RATIO × the plain bf16 backward's own RMS distance from the
# plain f32 backward on the same (widened) values (tests/
# test_torch_train_bf16.py's rule), its bound the same 5 products in one
# bf16 pass (``BWD_ROUTE_ARITHMETIC["bf16"]``) over its bf16 bytes
BWD_BF16_RATIO = 2.0
# a granite-8b train step's backward device ms before the Hopper kernel
# (PERF.md row 3c: phase 17 on an H100 80GB HBM3 at 700 W, the mma.sync
# kernel of the parent commit), printed beside this run's
BWD_DEVICE_MS_BEFORE = 10.75
# Phases 17–18: LM training, the reference's launcher defaults
# (``repro/launch/train.py``: granite-8b, batch 8, sequence 256, f32 on one
# device, AdamW 3e-4 with 10 warmup steps). granite-8b at full width (d
# 4,096, 32/8 heads of 128, d_ff 14,336, vocab 49,152) cut to 16 of its 36
# layers: 3.69 B parameters, 59 GB of f32 weights, gradients and two
# moments (all 36: ~129 GB). 4 steps through init_train_state,
# make_train_step; then FaultTolerantLoop at the same width cut to
# LOOP_LAYERS: its checkpoints hold the weights and both moments (44 GB at
# 16 layers), and the H100 host this was sized on has a 75 GB disk at
# 0.83 GB/s (measured with dd), which holds no two of them; 2 layers make
# 7.6 GB a checkpoint.
TRAIN_ARCH = "granite-8b"
TRAIN_LAYERS = 16            # published: 36
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 4
LOOP_LAYERS = 2
TRAIN_FAULT_STEP = 3
# phase 18: reduced configurations, card against CPU, 3 steps each: every
# loss and gradient norm, the first step's gradients (as Adam's first
# moment) and the final parameters within 1e-4 of scale (the CPU tests' pin
# of the port's training against the reference; the leaves initialised at
# zero by each step's first moments instead); the CPU side runs on one
# PyTorch thread, so its sums take one order whatever the host's cores.
# (arch, head width): the reduced widths (16, 32) take the mma.sync
# backward; granite-8b reduced at its published hd 128 takes
# flash_bwd_hopper, so a train step through it is held against the CPU
TRAIN_CPU_CASES = (("granite-8b", None), ("gemma-7b", None),
                   ("gemma3-27b", None), ("seamless-m4t-large-v2", None),
                   ("granite-8b", 128), ("zamba2-1.2b", None),
                   ("falcon-mamba-7b", None), ("mixtral-8x7b", None),
                   ("mixtral-8x22b", None))
# Phase 17's Mamba kinds, through the scans' f32 kernels and their backward
# kernels, at the launcher's batch 8 × 256: zamba2-1.2b uncut (38 layers,
# 1.25 B parameters: ~20 GB of f32 weights, gradients and two moments; its
# shared attention through flash_bwd_hopper at hd 64) and falcon-mamba-7b
# at every published width (d 4,096, d_inner 8,192, N 16, vocab 65,024) cut
# in depth: 16 bytes a parameter (the weight, its gradient, two moments)
# make 3.90 B parameters ~62 GB at 32 of its 64 layers, which with the
# step's activations keeps the peak under ~70 GB of the card's 80 (all 64:
# 7.26 B parameters, ~116 GB). (arch, layers or None: uncut)
FALCON_TRAIN_LAYERS = 32     # published: 64
MAMBA_TRAIN = (("zamba2-1.2b", None), ("falcon-mamba-7b", FALCON_TRAIN_LAYERS))
# Phase 17's mixtrals in f32, at every published width cut in depth: 16
# bytes a parameter. mixtral-8x7b (d 4,096, 8 experts of d_ff 14,336, GQA
# 32/8 at hd 128, vocab 32,000): a layer is 1.45 B parameters (23.2 GB of
# train state), the embedding and head 0.26 B (4.2 GB): 2 of its 32 layers
# make 3.16 B, 50.6 GB; 3 make 73.9 GB, and AdamW's f32 temporaries of the
# 1.9 GB expert leaves (a few a leaf at once) leave no room on the 80 GB
# card. mixtral-8x22b (d 6,144, d_ff 16,384, GQA 48/8, vocab 32,768): a
# layer is 2.50 B (40.1 GB), the embedding and head 0.40 B (6.4 GB): 1 of
# its 56 layers makes 2.91 B, 46.5 GB (2: 86.6 GB). (arch, layers,
# published layers)
MOE_TRAIN = (("mixtral-8x7b", 2, 32), ("mixtral-8x22b", 1, 56))
# Phase 17's bf16 step: granite-8b at full width in the reference's default
# dtype, 12 bytes a parameter (the bf16 weight and gradient, two f32
# moments): 24 of its 36 layers make 5.44 B parameters, 65.2 GB (26: 70.5
# GB, which with the step's activations and AdamW's f32 temporaries of the
# 0.8 GB a leaf embedding and head comes too near the card's 80 GB)
GRANITE_BF16_LAYERS = 24     # published: 36
TRAIN_CPU_STEPS = 3
TRAIN_CPU_RTOL = 1e-4


def bwd_cases():
    """Phase 16's cases: (label, (B, S, T, H, K, hd), causal, window,
    softcap): granite-8b's train and serve shapes, gemma-7b's hd 256
    without and with a soft-cap, gemma3-27b's windowed local layers,
    seamless's cross-attention without a mask (S ≠ T), and ragged S below
    T (causal, the T − S offset) and above it (its first 537 rows see no
    key)."""
    from repro_torch.configs import get_config
    gr, g7, g3, sm = (get_config(a) for a in (
        "granite-8b", "gemma-7b", "gemma3-27b", "seamless-m4t-large-v2"))
    heads = lambda c: (c.n_heads, c.n_kv, c.head_dim)   # noqa: E731
    return [
        ("granite-train", (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ) + heads(gr),
         True, None, None),
        ("granite-serve", (LM_BATCH, LM_PROMPT, LM_PROMPT) + heads(gr),
         True, None, None),
        ("gemma-7b-hd256", (LM_BATCH, 1024, 1024) + heads(g7), True, None,
         None),
        ("gemma-7b-hd256-cap", (LM_BATCH, 1024, 1024) + heads(g7), True,
         None, 50.0),
        ("gemma3-local", (LM_BATCH, LM_PROMPT, LM_PROMPT) + heads(g3), True,
         g3.local_window, None),
        ("seamless-cross", (LM_BATCH, 700, LM_PROMPT) + heads(sm), False,
         None, None),
        ("ragged-offset", (2, 1000, 1537, 16, 8, 128), True, None, None),
        ("ragged-dead-rows", (2, 1537, 1000, 16, 8, 128), True, None, None),
    ]


def bwd_ops_bytes(B, S, T, H, K, hd, causal, window, elem: int = 4):
    """The backward's operations (BWD_PRODUCTS products of 2·hd per live
    pair) and bytes (q, k, v, o, dO read once and dq, dk, dv written once,
    ``elem`` bytes each: 4 f32, 2 bf16; the f32 LSE read once)."""
    fwd_ops, _ = flash_ops_bytes(B, S, T, H, K, hd, causal, window)
    ops = fwd_ops / 2 * BWD_PRODUCTS           # the forward counts 2 products
    moved = (elem * (4 * B * S * H * hd + 4 * B * T * K * hd)
             + 4.0 * B * H * S)
    return ops, moved


def bwd_bounds(ops, moved, route) -> dict:
    """The backward's bounds over the same bytes: ``bound_ms`` prices its
    operations in 3×TF32 at the TF32 peak (``lm_bound``, the yardstick
    PR 29's shares were read against), ``route_bound_ms`` in the arithmetic
    of ``route`` (``BWD_ROUTE_ARITHMETIC``: flash_bwd_hopper's three bf16
    passes at the bf16 peak, the mma.sync kernel's 3×TF32)."""
    passes, peak, kind = BWD_ROUTE_ARITHMETIC[route]
    roof = Roofline(moved, passes * ops, peak)
    return {**lm_bound("flash_attention", ops, moved),
            "route_bound_ms": roof.t_bound * 1e3,
            "route_bound_by": "bytes" if roof.bottleneck == "bytes"
            else f"operations ({kind})"}


def bwd_bf16_bound(ops, moved) -> dict:
    """The bf16 backward's bound over its bf16 bytes: its operations in
    one bf16 pass a product at the bf16 peak
    (``BWD_ROUTE_ARITHMETIC["bf16"]``)."""
    passes, peak, kind = BWD_ROUTE_ARITHMETIC["bf16"]
    roof = Roofline(moved, passes * ops, peak)
    return {"bound_ms": roof.t_bound * 1e3,
            "bound_by": "bytes" if roof.bottleneck == "bytes"
            else f"operations ({kind})"}


def sdpa_train_mask(dev, S, T, causal, window) -> dict:
    """``scaled_dot_product_attention``'s mask for the flash mask (query
    row i at key position i + T − S): ``is_causal`` for S = T without a
    window, nothing without a mask, else an explicit boolean mask."""
    if not causal and window is None:
        return {}
    if causal and window is None and S == T:
        return dict(is_causal=True)
    qpos = torch.arange(S, device=dev)[:, None] + (T - S)
    kpos = torch.arange(T, device=dev)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=dev)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return dict(attn_mask=ok)


def rel_err(got, want) -> float:
    """max |got − want| over max |want|."""
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) / scale


def lm_check_backward(dev):
    """Phase 16: ``flash_attention_bwd`` against the plain version's
    autograd on the same tensors, twice bitwise, at ``bwd_cases``; its time
    beside the bound, the plain backward's and f32
    ``scaled_dot_product_attention``'s backward (K and V repeated to the
    query heads outside the timed call). Returns (max |error|, the
    granite-train case's timing row)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_lse_ref,
        flash_attention_ref)
    from repro_torch.kernels.flash_attention import kernel as FK
    lib, resources = FK.library_bwd(), FK.bwd_resources()
    worst, row_of_path = 0.0, None
    for label, (B, S, T, H, K, hd), causal, window, cap in bwd_cases():
        route = FK.bwd_route(hd)
        kern = "flash_bwd_hopper" if route == "hopper" else "flash_bwd_kernel"
        kernel_info = {
            "route": route,
            "products_per_live_pair": BWD_KERNEL_PRODUCTS,
            "smem_bytes": lib.flash_attention_bwd_smem_bytes(hd),
            "registers_spill_bytes": {
                m: resources.get(f"{kern}<{hd},{m},{'cap' if cap else 'nocap'}>",
                                 "not reported: the library was found built")
                for m in ("DQ", "DKV")}}
        n_route = FK.flash_attention_bwd.launches_by_route[route]
        q, k, v = qkv_inputs(B, S, T, H, K, hd, dev, seed=S + T + hd)
        dout = torch.randn(q.shape, device=dev,
                           generator=torch.Generator(dev).manual_seed(hd))
        kw = dict(causal=causal, window=window, softcap=cap)
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        got = flash_attention_bwd(q, k, v, out, dout, lse, **kw)
        same = bits_equal(got, flash_attention_bwd(q, k, v, out, dout, lse,
                                                   **kw))
        kernel_info["route_launches"] = \
            FK.flash_attention_bwd.launches_by_route[route] - n_route
        qr, kr, vr = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        ref_out = flash_attention_ref(qr, kr, vr, **kw)
        want = torch.autograd.grad(ref_out, (qr, kr, vr), dout,
                                   retain_graph=True)
        want_lse = flash_attention_lse_ref(q, k, **kw)
        dead = torch.isinf(want_lse)
        errs = {n: rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"),
                                                     got, want)}
        errs["lse"] = rel_err(lse[~dead], want_lse[~dead])
        lse_inf_ok = bool(torch.equal(torch.isinf(lse), dead)
                          and (lse[dead] > 0).all())
        abs_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        ops, moved = bwd_ops_bytes(B, S, T, H, K, hd, causal, window)
        qt = q.transpose(1, 2).contiguous().requires_grad_(True)
        kt, vt = (t.repeat_interleave(H // K, dim=2).transpose(1, 2)
                  .contiguous().requires_grad_(True) for t in (k, v))
        dt = dout.transpose(1, 2).contiguous()
        lib_out = F.scaled_dot_product_attention(
            qt, kt, vt, **sdpa_train_mask(dev, S, T, causal, window))
        row = dict(
            ms=cuda_time_ms(lambda: flash_attention_bwd(
                q, k, v, out, dout, lse, **kw), reps=10),
            plain_ms=cuda_time_ms(lambda: torch.autograd.grad(
                ref_out, (qr, kr, vr), dout, retain_graph=True), reps=3),
            library_ms=cuda_time_ms(lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), dt, retain_graph=True), reps=10),
            operations=ops, bytes=moved, shape=[B, S, T, H, K, hd],
            causal=causal, window=window, softcap=cap)
        row.update(bwd_bounds(ops, moved, route))
        say({"phase": "lm_backward", "kernel": "flash_attention_bwd",
             "case": label, **kernel_info, **row,
             "share_of_bound": row["bound_ms"] / row["ms"],
             "share_of_route_bound": row["route_bound_ms"] / row["ms"],
             "rel_err": errs, "max_abs_err": abs_err,
             "rtol": BWD_RTOL, "dead_rows": int(dead.sum()),
             "lse_inf_exact": lse_inf_ok, "finite": finite,
             "run_twice_bitwise_equal": same})
        assert max(errs.values()) <= BWD_RTOL, \
            "flash_attention_bwd disagrees with the plain autograd"
        assert lse_inf_ok and finite, "flash_attention: LSE or grads wrong"
        assert same, "flash_attention_bwd differs from run to run"
        assert kernel_info["route_launches"] == 2, kernel_info
        worst = max(worst, abs_err)
        if label == "granite-train":
            row_of_path = row
        del q, k, v, dout, out, lse, got, want, qr, kr, vr, ref_out
        del qt, kt, vt, dt, lib_out
        torch.cuda.empty_cache()
    return worst, row_of_path


def rms_share(got, want, scale) -> float:
    """RMS of ``got − want`` over the RMS of ``scale`` (in f64)."""
    got, want, scale = (t.double() for t in (got, want, scale))
    return float((got - want).pow(2).mean().sqrt()
                 / scale.pow(2).mean().sqrt().clamp_min(1e-30))


def bwd_bf16_kernel_info(lib, resources, route, B, S, T, H, K, hd, causal,
                         window, cap) -> dict:
    """What serves a bf16 backward case: the route, the products a live
    pair its kernels form, their shared memory, CTAs an SM and ptxas
    registers and spill bytes; for ``flash_bwd_bf16_hopper`` also its
    grid, its tiles and the bytes its design moves, the dQ workspace's
    traffic among them (``kernel.bf16_bwd_design``)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    smem = lib.flash_attention_bwd_bf16_smem_bytes(hd)
    cap_tag = "cap" if cap else "nocap"
    found = "not reported: the library was found built"
    info = {"route": route, "passes_per_product": 1, "smem_bytes": smem,
            "ctas_per_sm": lib.flash_attention_bwd_bf16_ctas_per_sm(hd)}
    if route != "hopper":
        return {**info, "kernel": "flash_bwd_kernel_bf16",
                "products_per_live_pair": BWD_KERNEL_PRODUCTS,
                "registers_spill_bytes": {
                    m: resources.get(f"flash_bwd_kernel_bf16<{hd},{m},"
                                     f"{cap_tag}>", found)
                    for m in ("DQ", "DKV")}}
    design = FK.bf16_bwd_design(B, S, T, H, K, hd, causal, window)
    return {**info, "kernel": "flash_bwd_bf16_hopper",
            "products_per_live_pair": BWD_PRODUCTS,
            "registers_spill_bytes": resources.get(
                f"flash_bwd_bf16_hopper<{hd},{cap_tag}>", found),
            "grid_ctas": design["ctas"], "tiles_queries_keys": design["tiles"],
            "iterations": sum(map(len, design["iterations"])),
            "design_bytes": design["bytes"],
            "design_workspace_bytes": design["workspace_bytes"]}


def lm_check_backward_bf16(dev):
    """Phase 16, bf16: ``flash_attention_bwd`` on bf16 tensors (the
    ``flash_attention_bwd_bf16`` entry, after ``flash_attention_bf16``
    with its LSE) at ``bwd_cases``, twice bitwise, against the plain
    version's autograd in bf16 on the same tensors: each gradient within
    ``BWD_BF16_RATIO`` × the plain bf16 backward's own RMS distance from
    the plain f32 backward on the same values widened (both printed); the
    LSE against ``flash_attention_lse_ref``, +inf exactly on the rows with
    no live key, and the output with the LSE bit for bit the output
    without it. Its time beside its bf16 bound (one pass a product), the
    plain bf16 backward's and bf16 ``scaled_dot_product_attention``'s
    backward. Returns (max |kernel − plain bf16|, the granite-train
    case's timing row)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_lse_ref,
        flash_attention_ref)
    from repro_torch.kernels.flash_attention import kernel as FK
    lib, resources = FK.library_bwd(), FK.bwd_resources()
    bf16 = torch.bfloat16
    worst, row_of_path = 0.0, None
    for label, (B, S, T, H, K, hd), causal, window, cap in bwd_cases():
        route = FK.bwd_route(hd)
        kernel_info = bwd_bf16_kernel_info(lib, resources, route, B, S, T, H,
                                           K, hd, causal, window, cap)
        n_entry = FK.flash_attention_bwd.launches_by_dtype[bf16]
        q, k, v = (t.to(bf16) for t in qkv_inputs(B, S, T, H, K, hd, dev,
                                                    seed=S + T + hd))
        dout = torch.randn(q.shape, device=dev, generator=torch.Generator(
            dev).manual_seed(hd)).to(bf16)
        kw = dict(causal=causal, window=window, softcap=cap)
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        out_same = bits_equal(out, flash_attention(q, k, v, **kw))
        got = flash_attention_bwd(q, k, v, out, dout, lse, **kw)
        same = bits_equal(got, flash_attention_bwd(q, k, v, out, dout, lse,
                                                   **kw))
        kernel_info["entry_launches"] = \
            FK.flash_attention_bwd.launches_by_dtype[bf16] - n_entry
        qr, kr, vr = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        ref_out = flash_attention_ref(qr, kr, vr, **kw)
        want = torch.autograd.grad(ref_out, (qr, kr, vr), dout,
                                   retain_graph=True)
        wide = [t.float().requires_grad_(True) for t in (q, k, v)]
        want32 = torch.autograd.grad(flash_attention_ref(*wide, **kw), wide,
                                     dout.float())
        del wide
        ratios, own = {}, {}
        for n, a, b, c in zip(("dq", "dk", "dv"), got, want, want32):
            own[n] = rms_share(b, c, c)
            ratios[n] = rms_share(a, b, c) / max(own[n], 1e-30)
        want_lse = flash_attention_lse_ref(q, k, **kw)
        dead = torch.isinf(want_lse)
        lse_err = rel_err(lse[~dead], want_lse[~dead])
        lse_inf_ok = bool(torch.equal(torch.isinf(lse), dead)
                          and (lse[dead] > 0).all())
        abs_err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, want))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        ops, moved = bwd_ops_bytes(B, S, T, H, K, hd, causal, window, elem=2)
        qt = q.transpose(1, 2).contiguous().requires_grad_(True)
        kt, vt = (t.repeat_interleave(H // K, dim=2).transpose(1, 2)
                  .contiguous().requires_grad_(True) for t in (k, v))
        dt = dout.transpose(1, 2).contiguous()
        lib_out = F.scaled_dot_product_attention(
            qt, kt, vt, **sdpa_train_mask(dev, S, T, causal, window))
        row = dict(
            ms=cuda_time_ms(lambda: flash_attention_bwd(
                q, k, v, out, dout, lse, **kw), reps=10),
            plain_ms=cuda_time_ms(lambda: torch.autograd.grad(
                ref_out, (qr, kr, vr), dout, retain_graph=True), reps=3),
            library_ms=cuda_time_ms(lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), dt, retain_graph=True), reps=10),
            operations=ops, bytes=moved, shape=[B, S, T, H, K, hd],
            causal=causal, window=window, softcap=cap,
            **bwd_bf16_bound(ops, moved))
        if "design_bytes" in kernel_info:
            kernel_info["design_bytes_ms"] = (kernel_info["design_bytes"]
                                              / HBM_BYTES_PER_S * 1e3)
        say({"phase": "lm_backward_bf16", "kernel": "flash_attention_bwd_bf16",
             "case": label, **kernel_info, **row,
             "share_of_bound": row["bound_ms"] / row["ms"],
             "ratio_to_plain_bf16_own_distance": ratios,
             "plain_bf16_vs_f32_rms_share": own,
             "ratio_limit": BWD_BF16_RATIO, "max_abs_err": abs_err,
             "lse_rel_err": lse_err, "dead_rows": int(dead.sum()),
             "lse_inf_exact": lse_inf_ok, "finite": finite,
             "output_with_lse_bitwise_without": out_same,
             "run_twice_bitwise_equal": same})
        assert max(ratios.values()) <= BWD_BF16_RATIO, \
            "flash_attention_bwd_bf16 disagrees with the plain autograd"
        assert lse_err <= BWD_RTOL and lse_inf_ok and finite, \
            "flash_attention_bf16's LSE or the bf16 gradients wrong"
        assert out_same, "asking for the LSE changed the bf16 output"
        assert same, "flash_attention_bwd_bf16 differs from run to run"
        assert kernel_info["entry_launches"] == 2, kernel_info
        worst = max(worst, abs_err)
        if label == "granite-train":
            row_of_path = row
        del q, k, v, dout, out, lse, got, want, want32, qr, kr, vr, ref_out
        del qt, kt, vt, dt, lib_out
        torch.cuda.empty_cache()
    return worst, row_of_path


# Phase 16b: the scans' backward kernels (``selective_scan_bwd``,
# ``ssd_scan_bwd``: no Pallas counterpart, the reference differentiates its
# plain scans) against their plain versions (``selective_scan_bwd_ref``,
# ``ssd_scan_bwd_ref``) on the same tensors, every gradient within
# SCAN_BWD_RTOL of its scale, twice bitwise: at each scan's train shape
# (the launcher's batch 8 × 256 at the published widths), a ragged S with
# h0 and the final state's gradient given, and the reduced widths (falcon
# dI 128, N 8; zamba2 8 heads, hp = N = 16). (label, shape, h0 and dh)
SCAN_BWD_RTOL = 2e-4


def scan_bwd_cases():
    from repro_torch.configs import get_config
    fa, fr = get_config(MAMBA1_ARCH), get_config(MAMBA1_ARCH, reduced=True)
    za, zr = get_config(LM_ARCH), get_config(LM_ARCH, reduced=True)
    heads = lambda c: (c.d_inner // c.ssm_headdim, c.ssm_headdim,   # noqa
                       c.d_state)
    return {
        "selective_scan_bwd": [
            ("falcon-train", (TRAIN_BATCH, TRAIN_SEQ, fa.d_inner, fa.d_state),
             False),
            ("ragged-h0-dh", (2, 777, fa.d_inner - 40, fa.d_state), True),
            ("reduced-h0-dh", (4, 40, fr.d_inner, fr.d_state), True)],
        "ssd_scan_bwd": [
            ("zamba2-train", (TRAIN_BATCH, TRAIN_SEQ) + heads(za), False),
            ("ragged-h0-dh", (2, 1000) + heads(za), True),
            ("reduced-h0-dh", (4, 40) + heads(zr), True)],
        # the bf16 entry's backward (zamba2 under ssm_bf16), the same cases
        "ssd_scan_bwd_bf16": [
            ("zamba2-train", (TRAIN_BATCH, TRAIN_SEQ) + heads(za), False),
            ("ragged-h0-dh", (2, 1000) + heads(za), True),
            ("reduced-h0-dh", (4, 40) + heads(zr), True)],
    }


def selective_bwd_ops_bytes(B, S, dI, N, with_h0):
    """Operations and bytes of the selective scan's gradients as a
    function: per (b, t, d, n) the states again (dt·A, its exponential,
    dt·u·B and the decay FMA: 5) and the adjoint (g = gc + C·dy, the carry
    a·g, g·B, g·(A·a·h + u·B), g·dt·a·h, g·dt·u, dy·h: 19), an FMA counted
    as 2; exponentials one an element; bytes: u, dt, dy, B, C, A, D (h0 and
    dh) read once, du, ddt, dA, dB, dC, dD (dh0) written once. The
    kernel's design (``selective_bwd_design``) adds to these."""
    el = float(B * S * dI * N)
    state = B * dI * N * (3 if with_h0 else 0)          # h0, dh, dh0
    moved = 4.0 * (5 * B * S * dI + 4 * B * S * N + 2 * (dI * N + dI)
                   + state)
    return 24.0 * el, moved, el


def selective_bwd_design(B, S, dI, N, chunk):
    """What the selective backward kernel's design itself needs beyond
    the function: two exponentials an element (the sweep that keeps each
    chunk's entering state, and the recompute, whose factors the adjoint
    reuses) and its scratch, the state every ``chunk`` steps written once
    and read back once."""
    scratch = 4.0 * B * -(-S // chunk) * dI * N
    return {"exponentials": 2.0 * B * S * dI * N, "scratch_bytes": 2 * scratch}


def ssd_bwd_design(B, S, H, hp, N, Q=64):
    """What the SSD backward kernels' design itself moves beyond the
    function: the scratch of the states entering and the adjoints leaving
    each chunk, written by the first kernel and read by the second (4
    bytes an element on either route: f32, or two bf16 pieces), and the f32
    partials of dB and dC, one a head, written for ``torch.sum``."""
    return {"scratch_bytes": 2 * 2 * 4.0 * B * H * -(-S // Q) * N * hp,
            "partial_bytes": 2 * 4.0 * B * H * S * N}


def ssd_bwd_chunked_ops(S, N, hp, Q, stream_passes=1, f32_passes=1):
    """Operations of one (batch, head) strip of the SSD scan's gradients in
    the chunked form at chunk length Q, the ragged last chunk at its own
    length L: per chunk the triangular (s ≤ t) products C·Bᵀ and dy·uᵀ
    (N + hp each), Mᵀ·dy (hp), G·B and Gᵀ·C (N each) and the masked
    products (6), five products of L·N·hp (dy·H_inᵀ, u·dHᵀ, B·dH, the
    adjoint's update and the entering state again) and the decay of the
    state and of its adjoint (N·hp each); an FMA counts 2. With passes: the
    products of two stream tensors (C·Bᵀ, dy·uᵀ) counted ``stream_passes``
    times, those with an f32 operand ``f32_passes`` times (the Hopper
    route of the bf16 entry: 1 and 2 bf16 passes)."""
    def chunk(L):
        tri = L * (L + 1) / 2
        return (tri * (stream_passes * 2 * (N + hp)
                       + f32_passes * (2 * hp + 4 * N) + 6)
                + f32_passes * 10 * L * N * hp + 2 * N * hp)
    full, last = divmod(S, Q)
    return full * chunk(Q) + (chunk(last) if last else 0)


def ssd_bwd_hopper_bound(B, S, H, hp, N, moved) -> dict:
    """The bf16 backward's Hopper route priced in its own arithmetic: the
    least count over chunk lengths (``ssd_bwd_chunked_ops``) with one bf16
    pass for the products of two stream tensors and two for those with an
    f32 operand, at the bf16 peak, against the bf16 bytes."""
    ops = B * H * min(ssd_bwd_chunked_ops(S, N, hp, q, 1, 2)
                      for q in range(1, S + 1))
    roof = Roofline(moved, ops, PEAK_BF16_FLOPS)
    return {"route_bound_ms": roof.t_bound * 1e3,
            "route_bound_by": "bytes" if roof.bottleneck == "bytes"
            else "operations (bf16 pieces: 1 pass stream x stream, 2 "
                 "with an f32 operand)",
            "route_operations": float(ops)}


def ssd_bwd_ops_bytes(B, S, H, hp, N, with_h0, Q=64, elem=4):
    """Operations and bytes of the SSD scan's gradients as a function, as
    ``ssd_ops_bytes`` counts the forward: the least operation count over
    chunk lengths (``ssd_bwd_chunked_ops``); exponentials: the triangle's W
    at the kernels' chunk Q; bytes: u, dy, dt, B, C, A, D (h0, dh) read
    once, du, ddt, dB, dC, dA, dD (dh0) written once, the stream tensors
    (u, dy, du, B, C, dB, dC) ``elem`` bytes each (4 f32, 2 bf16), the
    rest f32."""
    ops = B * H * min(ssd_bwd_chunked_ops(S, N, hp, q)
                      for q in range(1, S + 1))
    full, last = divmod(S, Q)
    exps = B * H * (full * Q * (Q + 1) / 2 + last * (last + 1) / 2)
    state = B * H * N * hp * (3 if with_h0 else 0)
    moved = (elem * (3 * B * S * H * hp + 4 * B * S * N)
             + 4.0 * (2 * B * S * H + 4 * H + state))
    return float(ops), moved, float(exps)


def max_sm_clock_hz() -> float:
    """The card's highest SM clock (``nvidia-smi clocks.max.sm``), Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0]) * 1e6


def lm_check_scan_backward(dev):
    """Phase 16b: each scan's backward kernel against its plain version at
    ``scan_bwd_cases``, twice bitwise; its time (``cuda_time_ms``) beside
    its bound (``lm_bound``: bytes at 3.35 TB/s against operations at the
    f32 peak, the larger; for ``ssd_scan_bwd``, whose chunked products its
    route takes on the tensor cores as split-TF32 ``mma.sync``,
    ``bwd_bounds`` of that route, at 3×TF32; beside it the
    exponentials at 16 a clock an SM at the card's highest SM clock), what
    bounds the design (``selective_bwd_design``, ``ssd_bwd_design``: its
    exponentials at that rate, its bytes with its scratch), the plain
    backward's time, each kernel's shared memory, CTAs an SM and ptxas
    registers and spills. Returns ({kernel: max |error|}, {kernel: the
    train-shape case's timing row})."""
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba_scan import kernel as MK
    from repro_torch.kernels.mamba_scan import selective_scan_bwd_ref
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_ref
    exp_rate = 16 * torch.cuda.get_device_properties(dev).multi_processor_count \
        * max_sm_clock_hz()
    resources = {name: build.ptxas_resources(name)
                 for name in ("selective_scan_bwd", "ssd_scan_bwd")}
    # the bf16 entry's kernels by their mangled names' element type
    # (the mma.sync kernels' bf16 instantiations, the Hopper route's
    # ssd_bwd_*_bf16_hopper)
    is_bf16 = lambda k: "bfloat16" in k or "bf16" in k   # noqa: E731
    resources["ssd_scan_bwd_bf16"] = {
        k: v for k, v in resources["ssd_scan_bwd"].items() if is_bf16(k)}
    resources["ssd_scan_bwd"] = {
        k: v for k, v in resources["ssd_scan_bwd"].items() if not is_bf16(k)}
    worst, rows = {}, {}
    for name, cases in scan_bwd_cases().items():
        bf16 = name.endswith("_bf16")
        for label, shape, extra in cases:
            g = torch.Generator(dev).manual_seed(len(label))
            f32_entry_ms = None
            if name == "selective_scan_bwd":
                B, S, dI, N = shape
                args = scan_inputs(B, S, dI, N, dev, seed=S)
                h_shape = (B, dI, N)
                kern, plain = MK.selective_scan_bwd, selective_scan_bwd_ref
                ops, moved, exps = selective_bwd_ops_bytes(*shape, extra)
                lib = MK.library_bwd()
                design = selective_bwd_design(
                    B, S, dI, N, lib.selective_scan_bwd_chunk())
                kernels = {"selective_scan_bwd_kernel": {
                    "smem_bytes": lib.selective_scan_bwd_smem_bytes(N),
                    "ctas_per_sm": lib.selective_scan_bwd_ctas_per_sm(N)}}
                bounds = lm_bound(name, ops, moved)
                kw = {}
            else:
                B, S, H, hp, N = shape
                args = ssd_inputs(B, S, H, hp, N, dev, seed=S)
                if bf16:
                    for i in (0, 3, 4):        # u, B, C
                        args[i] = args[i].bfloat16()
                h_shape = (B, H, N, hp)
                kern, plain = SK.ssd_scan_bwd, ssd_scan_bwd_ref
                ops, moved, exps = ssd_bwd_ops_bytes(*shape, extra,
                                                     elem=2 if bf16 else 4)
                lib = SK.library_bwd()
                design = ssd_bwd_design(B, S, H, hp, N)
                hopper = bf16 and SK.bwd_hopper_route(N, hp)
                ctas = (lib.ssd_scan_bwd_bf16_ctas_per_sm if bf16
                        else lib.ssd_scan_bwd_ctas_per_sm)
                smem = (lib.ssd_scan_bwd_bf16_kernel_smem_bytes if bf16
                        else lib.ssd_scan_bwd_kernel_smem_bytes)
                names = (("ssd_bwd_states_bf16_hopper",
                          "ssd_bwd_chunks_bf16_hopper") if hopper
                         else ("ssd_bwd_states", "ssd_bwd_chunks"))
                kernels = {k: {"smem_bytes": smem(N, hp, i),
                               "ctas_per_sm": ctas(N, hp, i)}
                           for i, k in enumerate(names)}
                # the route: split-TF32 mma.sync, three TF32 products each;
                # beside it, at (64, 64) in bf16, the Hopper route's own
                # arithmetic (bf16 pieces on wgmma)
                bounds = {"route": "mma_sync split-TF32",
                          **bwd_bounds(ops, moved, "mma_sync")}
                if hopper:
                    bounds.update(route="hopper TMA + wgmma, bf16 pieces",
                                  **ssd_bwd_hopper_bound(B, S, H, hp, N,
                                                         moved))
                kw = {"chunk": SK.KERNEL_CHUNK}
            dy = torch.randn(args[0].shape, device=dev, generator=g)
            if bf16:
                dy = dy.bfloat16()
            h0 = torch.randn(h_shape, device=dev, generator=g) if extra \
                else None
            dh = torch.randn(h_shape, device=dev, generator=g) if extra \
                else None
            n0 = kern.launches
            got = kern(*args, dy, h0=h0, dh=dh, **kw)
            same = bits_equal([t for t in got if t is not None],
                              [t for t in kern(*args, dy, h0=h0, dh=dh, **kw)
                               if t is not None])
            launched = kern.launches - n0
            want = plain(*args, dy, h0=h0, dh=dh, **kw)
            # bf16 outputs (du, dB, dC of the bf16 entry): the excess over
            # one bf16 rounding as a share of the scale (``bf16_err``)
            errs = {n: (bf16_err(a, b, SCAN_BWD_RTOL)[1]
                        if b.dtype == torch.bfloat16 else rel_err(a, b))
                    for n, a, b in zip(("du", "ddt", "dA", "dB", "dC", "dD",
                                        "dh0"), got, want) if b is not None}
            dtypes_ok = all(a.dtype == b.dtype for a, b in zip(got, want)
                            if b is not None)
            if bf16:
                # the f32 entry on the same values widened, in this call
                wide = [t.float() for t in (*args, dy)]
                f32_entry_ms = cuda_time_ms(
                    lambda: kern(*wide, h0=h0, dh=dh, **kw), reps=20)
                del wide
            abs_err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(got, want) if b is not None)
            finite = all(bool(torch.isfinite(t).all()) for t in got
                         if t is not None)
            row = dict(
                ms=cuda_time_ms(lambda: kern(*args, dy, h0=h0, dh=dh, **kw),
                                reps=20),
                plain_ms=cuda_time_ms(lambda: plain(*args, dy, h0=h0, dh=dh,
                                                    **kw), reps=1),
                library_ms=None, operations=ops, bytes=moved,
                exponentials=exps, shape=list(shape))
            if bf16:
                row["f32_entry_ms"] = f32_entry_ms
                row["bytes_bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
            row.update(bounds)
            row["exp_bound_ms"] = exps / exp_rate * 1e3
            # the design's own floor: its exponentials, its bytes with the
            # scratch (bytes over the memory rate)
            row["design"] = {
                **design,
                "exp_bound_ms": design.get("exponentials", exps) / exp_rate
                * 1e3,
                "bytes_bound_ms": (moved + design["scratch_bytes"]
                                   + design.get("partial_bytes", 0.0))
                / HBM_BYTES_PER_S * 1e3}
            say({"phase": "lm_backward_scans", "kernel": name, "case": label,
                 **row, "share_of_bound": row["bound_ms"] / row["ms"],
                 "h0_and_dh": extra, "kernels": kernels,
                 "registers_spill_bytes": resources[name] or
                 "not reported: the library was found built",
                 "rel_err": errs, "max_abs_err": abs_err,
                 "rtol": SCAN_BWD_RTOL, "finite": finite,
                 "launches": launched, "run_twice_bitwise_equal": same,
                 "dtypes_as_plain": dtypes_ok})
            assert max(errs.values()) <= SCAN_BWD_RTOL and dtypes_ok, \
                f"{name} disagrees with its plain version"
            assert finite and same and launched == 2, \
                f"{name}: non-finite, not bitwise run to run, or not launched"
            worst[name] = max(worst.get(name, 0.0), abs_err)
            if label.endswith("-train"):
                rows[name] = row
            del args, dy, h0, dh, got, want
            torch.cuda.empty_cache()
    return worst, rows


def train_launches() -> dict:
    """The LM kernels' launch counts (``lm_launches``) with the
    backwards'."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.mamba_scan import kernel as MK
    from repro_torch.kernels.ssd_scan import kernel as SK
    return {**lm_launches(),
            **{entry("flash_attention_bwd", d): n for d, n in
               FK.flash_attention_bwd.launches_by_dtype.items()},
            **{entry("ssd_scan_bwd", d): n for d, n in
               SK.ssd_scan_bwd.launches_by_dtype.items()},
            "selective_scan_bwd": MK.selective_scan_bwd.launches}


def reset_train_launches() -> None:
    for mod, _ in lm_kernel_modules().values():
        mod.reset_launches()


def train_expected_launches(cfg) -> dict:
    """The LM kernels' launches in one train step of ``cfg`` (its dtype)
    with both remat levels (``train_step_launches``), every other entry
    0."""
    from repro_torch.models.model import train_step_launches
    return {**dict.fromkeys(LM_ENTRIES, 0), **train_step_launches(cfg)}


# the trace's kernel names of each LM kernel (a substring of the demangled
# name; the flash backward's D kernel, flash_bwd_dsum, is its own; a call of
# ssd_scan_bwd runs its two kernels, the states, then the chunks, in either
# entry, at N = hp = 64 in bf16 the Hopper pair; the bf16 SSD entry at N =
# hp = 64 runs ssd_bf16_hopper), the entry by ``trace_entry``
TRACE_KERNELS = {"flash_attention": ("flash_kernel", "flash_bf16_hopper"),
                 "flash_attention_bwd": ("flash_bwd_hopper", "flash_bwd_kernel",
                                         "flash_bwd_bf16_hopper",
                                         "flash_bwd_dsum"),
                 "selective_scan": ("selective_scan_kernel",),
                 "selective_scan_bwd": ("selective_scan_bwd_kernel",),
                 "ssd_scan": ("ssd_scan_kernel", "ssd_bf16_hopper"),
                 "ssd_scan_bwd": ("ssd_bwd_states", "ssd_bwd_chunks",
                                  "ssd_bwd_states_bf16_hopper",
                                  "ssd_bwd_chunks_bf16_hopper")}
# kernels the trace shows a call of each entry (1 where not named)
TRACE_KERNELS_PER_CALL = {"ssd_scan_bwd": 2, "ssd_scan_bwd_bf16": 2}
# the flash backward's main kernel by (route, dtype) and its launches a
# call: the f32 Hopper route dQ, then dK and dV (two launches of
# flash_bwd_hopper); the bf16 one all three in one (flash_bwd_bf16_hopper);
# the mma.sync route two of flash_bwd_kernel (its bf16 one,
# flash_bwd_kernel_bf16, carries the name)
BWD_TRACE_KERNELS = {("hopper", torch.float32): ("flash_bwd_hopper", 2),
                     ("hopper", torch.bfloat16): ("flash_bwd_bf16_hopper", 1),
                     ("mma_sync", torch.float32): ("flash_bwd_kernel", 2),
                     ("mma_sync", torch.bfloat16): ("flash_bwd_kernel", 2)}
# a profiled step's kernels listed by device time (where the rest of the
# step's device time goes: GEMMs, the optimizer's elementwise passes)
TOP_KERNELS = 12


def trace_entry(name: str):
    """The LM kernel entry (``entry`` names) a trace's kernel name belongs
    to, or None: the bf16 entry where the name carries ``bf16`` or a bf16
    type among its template arguments (``__nv_bfloat16``, or ``unsigned
    short``: bf16's bits)."""
    for base, keys in TRACE_KERNELS.items():
        if any(k in name for k in keys):
            bf16 = any(t in name for t in ("bf16", "bfloat16",
                                           "unsigned short"))
            return entry(base, torch.bfloat16 if bf16 else torch.float32)
    return None


def profiled_step(fn, dev) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (CUDA activity): its
    wall, the device time of all its kernels, each LM kernel entry's
    device ms and launches by the trace's kernel names (``TRACE_KERNELS``;
    the flash backward's main launches also by the kernel that ran:
    ``flash_bwd_hopper``, ``flash_bwd_bf16_hopper`` or the mma.sync
    ``flash_bwd_kernel``), the
    ``TOP_KERNELS`` kernels of the most device time (name cut to 100
    characters, ms, launches), and the idle share 1 − device time /
    wall."""
    from torch.profiler import ProfilerActivity, profile
    synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        synchronize(dev)
        wall = time.perf_counter() - t0
    busy = 0.0
    bwd_kernels = dict.fromkeys({k for k, _ in BWD_TRACE_KERNELS.values()},
                                0)
    names = [entry(n, d) for n in TRACE_KERNELS
             for d in (torch.float32, torch.bfloat16)]
    ms, count = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    by_kernel = []
    for e in prof.key_averages():
        for name in bwd_kernels:
            if name in e.key:
                bwd_kernels[name] += int(e.count)
        t = 0.0
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                t = float(getattr(e, attr)) / 1e3        # ms
                break
        busy += t
        by_kernel.append((e.key[:100], t, int(e.count)))
        entry_name = trace_entry(e.key)
        if entry_name is not None:
            ms[entry_name] += t
            count[entry_name] += int(e.count)
    return {"wall_s": wall, "device_ms": busy or None,
            "flash_fwd_device_ms": ms["flash_attention"]
            + ms["flash_attention_bf16"],
            "flash_bwd_device_ms": ms["flash_attention_bwd"]
            + ms["flash_attention_bwd_bf16"],
            "flash_bwd_launches_by_kernel": bwd_kernels,
            "top_kernels_ms": sorted(by_kernel, key=lambda r: -r[1])[
                :TOP_KERNELS],
            "device_ms_by_entry": ms, "trace_launches_by_entry": count,
            "idle_share": (1.0 - busy / 1e3 / wall) if busy
            else "not measured"}


def trace_faults(prof: dict, want: dict, flash_bwd: str,
                 route: str) -> list:
    """Where a profiled train step's trace (``profiled_step``) disagrees
    with the launches counted in one step (``want``): every main launch of
    the flash backward (entry ``flash_bwd``) by ``route``'s kernel for the
    entry's dtype (``BWD_TRACE_KERNELS``), every scan and flash launch as
    counted. Each fault is (what, traced, expected); none where they
    agree."""
    dtype = torch.bfloat16 if flash_bwd.endswith("bf16") else torch.float32
    kern, per_call = BWD_TRACE_KERNELS[route, dtype]
    faults = [(name, traced, n)
              for name, traced in prof["flash_bwd_launches_by_kernel"].items()
              for n in [per_call * want[flash_bwd] if name == kern else 0]
              if traced != n]
    for k, n in prof["trace_launches_by_entry"].items():
        if k.startswith("flash_attention_bwd"):
            continue   # D and the two launches: by kernel, above
        if n != TRACE_KERNELS_PER_CALL.get(k, 1) * want.get(k, 0):
            faults.append((k, n, want.get(k, 0)))
    return faults


def train_cfg(arch: str, n_layers=None, reduced: bool = False,
              dtype=torch.float32, ssm_bf16: bool = False):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch, reduced=reduced), dtype=dtype,
                              ssm_bf16=ssm_bf16)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg


def train_tcfg():
    """The launcher's optimiser: AdamW 3e-4, 10 warmup steps, 100 steps."""
    from repro_torch.train import AdamConfig, TrainConfig
    return TrainConfig(adam=AdamConfig(lr=3e-4, warmup_steps=10,
                                       total_steps=100))


def fresh_train_state(dev, cfg, tcfg):
    """``init_train_state`` of ``cfg`` from ``LM_SEED`` on the card, and
    the seconds it took."""
    from repro_torch.train import init_train_state
    t0 = time.perf_counter()
    state = init_train_state(cfg, torch.Generator(dev).manual_seed(LM_SEED),
                             tcfg)
    synchronize(dev)
    return state, time.perf_counter() - t0


def moe_executed_rows(cfg, tokens: int) -> tuple:
    """(the rows the experts' three products run over in one MoE layer's
    forward of ``tokens`` tokens: E·G·cap, the routing's groups of
    ``moe``'s ``group_size`` and capacity ``cap`` an expert a group; the
    rows the model's useful work counts: tokens · top_k)."""
    import inspect
    from repro_torch.models.moe import moe
    g = min(inspect.signature(moe).parameters["group_size"].default, tokens)
    while tokens % g:
        g //= 2
    cap = max(int(np.ceil(cfg.top_k * g / cfg.n_experts
                          * cfg.capacity_factor)), cfg.top_k)
    return cfg.n_experts * (tokens // g) * cap, tokens * cfg.top_k


def moe_forward_stats(params, cfg, batch) -> dict:
    """A no-grad train-mode forward of ``batch``'s tokens: each MoE
    layer's dropped share of its (token, k) picks (its ``MoEStats``,
    recorded around the model's ``moe``), the summed aux loss and expert
    counts."""
    import repro_torch.models.model as M
    dropped, moe = [], M.moe

    def recorded(*a, **kw):
        y, stats = moe(*a, **kw)
        dropped.append(float(stats.dropped_fraction))
        return y, stats

    M.moe = recorded
    try:
        with torch.no_grad():
            res = M.forward(params, cfg, torch.as_tensor(
                batch["tokens"], device=params["embed"].device), mode="train")
    finally:
        M.moe = moe
    return {"dropped_share_by_layer": dropped,
            "aux_loss": float(res.aux_loss),
            "expert_counts": res.expert_counts.tolist()}


def train_steps(dev, cfg, tcfg, published_layers: int):
    """``TRAIN_STEPS`` train steps of ``cfg`` (its dtype: f32, or bf16
    weights and gradients with f32 moments) at batch 8 × 256 through
    ``init_train_state`` and ``make_train_step``, with every LM kernel's
    launch count set to 0 just before and read after each step (the last
    step profiled: device ms and launches of each kernel entry by the
    trace's kernel names); the first step taken again from a fresh draw of
    the same state, bitwise. Prints the ``lm_train`` line (a MoE model's
    also with each step's summed expert counts and, from a forward after
    the steps, the dropped share and aux loss) and checks finite losses,
    each step's launches against ``train_expected_launches`` (every flash
    backward through the route of the head width), the trace's launches
    of every scan and flash entry and of the flash backward's kernels
    (``trace_faults``; a trace that disagrees is taken once more, over one
    more step, and if that one disagrees too the steps are replayed
    unprofiled, bitwise), and the step twice bitwise. Returns (the line,
    launches of the run)."""
    from repro_torch.analysis.roofline import (PEAK_F32_FLOPS, model_flops,
                                               remat_overhead)
    from repro_torch.configs.shapes import Shape
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models.convert import leaves
    from repro_torch.models.model import KERNEL_BACKWARD
    from repro_torch.train import DataConfig, TokenStream, make_train_step
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq=TRAIN_SEQ,
                                    batch=TRAIN_BATCH))
    want = train_expected_launches(cfg)
    flash = entry("flash_attention", cfg.dtype)
    flash_bwd = entry("flash_attention_bwd", cfg.dtype)

    (params, opt), init_s = fresh_train_state(dev, cfg, tcfg)
    n_params = sum(t.numel() for t in leaves(params))
    step = make_train_step(cfg, tcfg)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_train_launches()
    steps, first, total = [], None, dict.fromkeys(want, 0)
    for s in range(TRAIN_STEPS):
        before = train_launches()
        box = {}

        def run():
            box["out"] = step(params, opt, stream.batch(s))
            box["loss"] = float(box["out"][2]["loss"])

        synchronize(dev)
        if s == TRAIN_STEPS - 1:
            prof = profiled_step(run, dev)
            wall = prof["wall_s"]
        else:
            t0 = time.perf_counter()
            run()
            synchronize(dev)
            wall = time.perf_counter() - t0
        params, opt, m = box["out"]
        after = train_launches()
        counts = {k: after[k] - before[k] for k in want}
        for k in want:
            total[k] += counts[k]
        steps.append({"step": s, "wall_s": wall, "loss": box["loss"],
                      "grad_norm": float(m["grad_norm"]),
                      "lr": float(m["lr"]), "launches": counts})
        if cfg.n_experts:
            steps[-1]["expert_counts"] = m["expert_counts"].tolist()
        if s == 0:
            first = (box["loss"], float(m["grad_norm"]),
                     [t.detach().cpu() for t in leaves(params)])
    routes = dict(FK.flash_attention_bwd.launches_by_route)
    peak = torch.cuda.max_memory_allocated(dev)
    moe_stats = (moe_forward_stats(params, cfg, stream.batch(TRAIN_STEPS))
                 if cfg.n_experts else None)
    dtypes = sorted({str(t.dtype) for t in leaves(params)})
    moment_dtypes = sorted({str(t.dtype) for t in leaves(opt.mu)})
    # the trace is a second witness of the launches, and the profiler can
    # lose a kernel's record: in 2 of 4 full runs on the H100, one of
    # mixtral-8x22b's two flash forwards was missing from its profiled
    # step's trace (both profiles of one run), while that step's loss and
    # gradient norm, and the aux loss of a forward after it, were bit for
    # bit those of the runs whose trace held both; 41 profiled steps of the
    # mixtrals and granite-8b, each model in a process of its own, lost
    # none (tools/trace_record_loss.py). A trace that disagrees is taken again
    # over one more step; if that one disagrees too, every step is replayed
    # unprofiled from a fresh draw and must give each step's loss and
    # gradient norm and the last parameters bit for bit
    route = FK.bwd_route(cfg.head_dim)
    batches = list(range(TRAIN_STEPS))
    trail = [(r["loss"], r["grad_norm"]) for r in steps]
    faults = first_faults = trace_faults(prof, want, flash_bwd, route)
    if faults:
        before = train_launches()
        batches.append(TRAIN_STEPS + 1)
        prof = profiled_step(
            lambda: box.update(out=step(params, opt, stream.batch(
                batches[-1]))), dev)
        after = train_launches()
        counts = {k: after[k] - before[k] for k in want}
        assert counts == want, (counts, want)
        for k in want:
            total[k] += counts[k]
        m = box["out"][2]
        trail.append((float(m["loss"]), float(m["grad_norm"])))
        faults = trace_faults(prof, want, flash_bwd, route)
    last = [t.detach().cpu() for t in leaves(params)] if faults else None
    del params, opt, m, box
    torch.cuda.empty_cache()

    # the first step again from a fresh draw of the same state (and, after a
    # trace that disagreed twice, every step)
    (params, opt), _ = fresh_train_state(dev, cfg, tcfg)
    params, opt, m = step(params, opt, stream.batch(0))
    twice = (float(m["loss"]) == first[0]
             and float(m["grad_norm"]) == first[1]
             and all(torch.equal(a.detach().cpu(), b)
                     for a, b in zip(leaves(params), first[2])))
    replay = None
    if faults:
        got = [(float(m["loss"]), float(m["grad_norm"]))]
        for b in batches[1:]:
            params, opt, m = step(params, opt, stream.batch(b))
            got.append((float(m["loss"]), float(m["grad_norm"])))
        replay = got == trail and all(
            torch.equal(a.detach().cpu(), b)
            for a, b in zip(leaves(params), last))
    del params, opt, m, first, last
    torch.cuda.empty_cache()

    walls = [r["wall_s"] for r in steps[1:-1]]     # warm, unprofiled
    wall = float(np.median(walls))
    shape = Shape("train", "train", TRAIN_SEQ, TRAIN_BATCH)
    # the work the step runs: each layer's forward as often as the code's
    # remat runs it (its mixer's forwards over its backwards: 3·L − L/G
    # over L, the group recompute stopping before its last block), 2·N·D a
    # forward and 4·N·D a backward; a MoE layer's experts over their
    # E·G·cap rows where the useful work counts tokens · top_k;
    # remat_overhead, the reference's estimate, counts 3 forwards
    mixer = {"mamba1": "selective_scan", "mamba2": "ssd_scan"}.get(
        cfg.ssm, "flash_attention")
    mixer_dtype = (cfg.dtype if mixer == "flash_attention"
                   or (mixer == "ssd_scan" and cfg.ssm_bf16)
                   else torch.float32)
    fwd = want[entry(mixer, mixer_dtype)] / want[
        entry(KERNEL_BACKWARD[mixer], mixer_dtype)]
    useful = model_flops(cfg, shape, chips=1)
    run_flops = useful
    moe_rows = None
    if cfg.n_experts:
        rows, counted = moe_executed_rows(cfg, TRAIN_BATCH * TRAIN_SEQ)
        moe_rows = {"executed": rows, "counted": counted}
        run_flops += 6.0 * cfg.n_layers * 3 * cfg.d_model * cfg.d_ff * (
            rows - counted)
    executed = run_flops * (2 * fwd + 4) / 6
    peak_flops, peak_name = ((PEAK_BF16_FLOPS, "bf16")
                             if cfg.dtype == torch.bfloat16
                             else (PEAK_F32_FLOPS, "f32"))
    ms = prof["device_ms_by_entry"]
    line = {"phase": "lm_train", "arch": cfg.name, "dtype": str(cfg.dtype),
            "ssm_bf16": cfg.ssm_bf16,
            "n_layers": cfg.n_layers, "published_layers": published_layers,
            "cut": (None if cfg.n_layers == published_layers else
                    f"depth: {cfg.n_layers} of {published_layers} layers, "
                    f"every published width"),
            "params": n_params, "param_dtypes": dtypes,
            "moment_dtypes": moment_dtypes, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "init_s": init_s, "steps": steps,
            "step_wall_s": wall,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / wall,
            "model_flops": useful,
            "remat_overhead": remat_overhead(cfg, shape),
            "forwards_per_layer": fwd, "executed_flops": executed,
            "moe_expert_rows_per_layer": moe_rows, "moe_forward": moe_stats,
            "peak": peak_name,
            f"share_of_{peak_name}_peak": executed / wall / peak_flops,
            f"share_of_{peak_name}_peak_by_remat_overhead": useful
            * remat_overhead(cfg, shape) / wall / peak_flops,
            "peak_memory_bytes": peak, "profiled_step": prof,
            "trace_faults_first_profile": first_faults,
            "trace_faults": faults,
            "unprofiled_replay_bitwise_equal": replay,
            "flash_device_ms_per_step": prof["flash_fwd_device_ms"]
            + prof["flash_bwd_device_ms"],
            "flash_fwd_device_ms_per_step": prof["flash_fwd_device_ms"],
            "flash_bwd_device_ms_per_step": prof["flash_bwd_device_ms"],
            "scan_device_ms_per_step": {k: ms[k] for k in (
                "selective_scan", "selective_scan_bwd", "ssd_scan",
                "ssd_scan_bwd", "ssd_scan_bf16", "ssd_scan_bwd_bf16")},
            "scan_trace_launches_per_step": {
                k: prof["trace_launches_by_entry"][k] for k in (
                    "selective_scan", "selective_scan_bwd", "ssd_scan",
                    "ssd_scan_bwd", "ssd_scan_bf16", "ssd_scan_bwd_bf16")},
            "bwd_launches_by_route": routes,
            "expected_launches_per_step": want,
            "step_twice_bitwise_equal": twice}
    say(line)
    assert all(np.isfinite(r["loss"]) for r in steps), "non-finite loss"
    for r in steps:
        assert r["launches"] == want, (r["launches"], want)
    assert routes == {r: TRAIN_STEPS * want[flash_bwd]
                      if r == route else 0 for r in routes}, routes
    assert not faults or replay, (faults, "unprofiled replay differs")
    assert twice, "one train step from the same state differs"
    return line, total


def lm_train_path(dev):
    """Phase 17: granite-8b trained at full width (``TRAIN_LAYERS`` of its
    layers) in f32 (``train_steps``); then ``FaultTolerantLoop`` at the
    same width cut to ``LOOP_LAYERS`` with checkpoints in a temporary
    directory, a crash injected at step 3, restored and replayed bitwise
    to an uninterrupted run's parameters. Returns (the timing line,
    launches of the run)."""
    import shutil
    import tempfile
    from repro_torch.models.convert import leaves
    from repro_torch.train import (Checkpointer, DataConfig,
                                   FaultTolerantLoop, LoopConfig,
                                   TokenStream, make_train_step)
    tcfg = train_tcfg()
    line, total = train_steps(dev, train_cfg(TRAIN_ARCH, TRAIN_LAYERS), tcfg,
                              36)
    # the fault-tolerant loop, at the same width cut to LOOP_LAYERS
    lcfg = train_cfg(TRAIN_ARCH, LOOP_LAYERS)
    stream = TokenStream(DataConfig(vocab=lcfg.vocab, seq=TRAIN_SEQ,
                                    batch=TRAIN_BATCH))

    lstep = make_train_step(lcfg, tcfg)
    seen = []

    def recorded(p, o, batch):
        p, o, m = lstep(p, o, batch)
        seen.append((float(m["loss"]), float(m["grad_norm"])))
        return p, o, m

    crashed = []

    def hook(s):
        if s == TRAIN_FAULT_STEP and not crashed:
            crashed.append(s)
            raise RuntimeError("injected node failure")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        (lp, lo), _ = fresh_train_state(dev, lcfg, tcfg)
        ck = Checkpointer(tmp, keep=1, async_save=True)
        loop = FaultTolerantLoop(
            train_step=recorded, params=lp, opt_state=lo, stream=stream,
            ckpt=ck, loop_cfg=LoopConfig(total_steps=TRAIN_STEPS,
                                         checkpoint_every=TRAIN_STEPS,
                                         log_every=1), fault_hook=hook)
        t0 = time.perf_counter()
        result = loop.run()
        loop_s = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(tmp) for f in fs)
        (dp, do), _ = fresh_train_state(dev, lcfg, tcfg)
        for s in range(TRAIN_STEPS):
            dp, do, _ = lstep(dp, do, stream.batch(s))
        replay_same = all(torch.equal(a, b) for a, b in
                          zip(leaves(loop.params), leaves(dp)))
        # steps 0 .. FAULT-1 ran twice from the same state: before the
        # crash and after the restore of the step-0 checkpoint
        n = TRAIN_FAULT_STEP
        repeat_same = seen[:n] == seen[n:2 * n]
        finite = all(np.isfinite(x) for x, _ in seen)
        del lp, lo, dp, do, loop
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    say({"phase": "lm_train_loop", "arch": lcfg.name,
         "n_layers": lcfg.n_layers, "steps": TRAIN_STEPS,
         "fault_at_step": TRAIN_FAULT_STEP, "restores": result["restores"],
         "final_step": result["final_step"], "calls": len(seen),
         "losses": [x for x, _ in seen], "loop_s": loop_s,
         "checkpoint_bytes_on_disk": ckpt_bytes,
         "steps_before_the_crash_replayed_bitwise": repeat_same,
         "final_params_bitwise_uninterrupted": replay_same,
         "finite": finite})
    assert result["restores"] == 1 and result["final_step"] == TRAIN_STEPS
    assert finite and repeat_same and replay_same, \
        "the loop's restore and replay is not bitwise"
    return line, total


def lm_train_card_vs_cpu(dev, arch: str, head_dim=None):
    """Phase 18: ``TRAIN_CPU_STEPS`` train steps of ``arch``'s reduced
    configuration (at ``head_dim`` where one is given) on the card and on
    the CPU (one thread) from the same
    parameters and batches (an enc-dec model's encoder frames as the
    launcher draws them, ``FrontendStream``): each loss and gradient norm,
    the first step's first moment (0.1 × its clipped gradients) and the
    final parameters within ``TRAIN_CPU_RTOL`` of scale, but for the leaves
    the model initialises at zero (``zero_leaves``): those are held by each
    step's gradients, through Adam's first moments after each step taken
    again on the card from the CPU's state before it, and their second
    moments and final values are reported; and the card's steps through
    the kernels as
    ``train_expected_launches`` says, the flash backward's through the
    route that serves the head width."""
    import dataclasses
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.train import FrontendStream
    from repro_torch.models import init_params
    from repro_torch.models.convert import leaves, tree_map, zero_leaves
    from repro_torch.train import (DataConfig, TokenStream, adam_init,
                                   make_train_step)
    cfg, tcfg = train_cfg(arch, reduced=True), train_tcfg()
    if head_dim is not None:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    stream = FrontendStream(TokenStream(DataConfig(vocab=cfg.vocab, seq=40,
                                                   batch=4)), cfg)
    base = init_params(cfg, torch.Generator().manual_seed(LM_SEED))
    runs, states, moments = {}, [], []
    threads = torch.get_num_threads()
    routes = dict(FK.flash_attention_bwd.launches_by_route)
    step = make_train_step(cfg, tcfg)
    for d in (dev, torch.device("cpu")):
        torch.set_num_threads(1 if d.type == "cpu" else threads)
        params = tree_map(lambda t: t.clone().to(d), base)
        opt = adam_init(params)
        losses, norms, counts = [], [], []
        for s in range(TRAIN_CPU_STEPS):
            if d.type == "cpu":
                states.append(tree_map(lambda t: t.detach().clone(),
                                       (params, opt)))
            before = train_launches()
            params, opt, m = step(params, opt, stream.batch(s))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            after = train_launches()
            counts.append({k: after[k] - before[k] for k in after})
            if s == 0:
                mu = [t.detach().cpu().clone() for t in leaves(opt.mu)]
            if d.type == "cpu":
                moments.append(([t.clone() for t in leaves(opt.mu)],
                                [t.clone() for t in leaves(opt.nu)]))
        runs[d.type] = (losses, norms, mu,
                        [t.detach().cpu() for t in leaves(params)], counts)
    torch.set_num_threads(threads)
    routes = {r: n - routes[r]
              for r, n in FK.flash_attention_bwd.launches_by_route.items()}
    (la, na, ma, pa, ca), (lb, nb, mb, pb, cb) = runs["cuda"], runs["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(la, lb))
    norm_rel = max(abs(a - b) / abs(b) for a, b in zip(na, nb))
    mu_rel = max(rel_err(a, b) for a, b in zip(ma, mb))
    # the leaves that start at zero (zamba2's conv and dt biases and LoRA
    # up-projections, falcon's conv biases, gemma's norm weights) sit after
    # Adam's first steps at ±lr by the sign of their gradients, so where a
    # gradient is near zero their last digits follow the order of the sums:
    # two correct CPU runs that differ only in the scans' summation order
    # land up to 1.2e-3 of such a leaf's scale apart after 3 steps, the
    # other leaves within 5.5e-6 (tools/adam_order_noise.py). They are held
    # by each step's gradients: Adam's first moments after each step taken
    # on the card from the CPU's state before it, which differ by 0.1 × that
    # step's clipped gradients alone. The second moments, squares of the
    # gradients, double a gradient's relative error and are reported
    # beside with the final values: with the plain scans in place of the
    # kernels a reduced zamba2's card step lands its zero-initialised
    # leaves' first moments 6.4e-5 and second moments 9.6e-5 of scale from
    # the CPU's (tools/card_moment_noise.py).
    zero = zero_leaves(base)
    param_rel = max(rel_err(a, b) for a, b, z in zip(pa, pb, zero) if not z)
    zero_rel = max((rel_err(a, b) for a, b, z in zip(pa, pb, zero) if z),
                   default=None)
    zero_mu_rel = zero_nu_rel = None
    if any(zero):
        zero_mu_rel = zero_nu_rel = 0.0
        for s, (state, (want_mu, want_nu)) in enumerate(zip(states,
                                                            moments)):
            o = step(*tree_map(lambda t: t.to(dev), state),
                     stream.batch(s))[1]
            zero_mu_rel = max([zero_mu_rel] + [
                rel_err(a.cpu(), b) for a, b, z in zip(
                    leaves(o.mu), want_mu, zero) if z])
            zero_nu_rel = max([zero_nu_rel] + [
                rel_err(a.cpu(), b) for a, b, z in zip(
                    leaves(o.nu), want_nu, zero) if z])
        del state, o
    want = train_expected_launches(cfg)
    say({"phase": "lm_train_card_vs_cpu", "arch": cfg.name,
         "steps": TRAIN_CPU_STEPS, "losses_card": la, "losses_cpu": lb,
         "max_loss_rel_diff": loss_rel, "max_grad_norm_rel_diff": norm_rel,
         "max_step1_moment_rel_diff": mu_rel,
         "max_param_rel_diff": param_rel,
         "zero_initialised_leaves_param_rel_diff": zero_rel,
         "zero_initialised_leaves_step_first_moments_rel_diff": zero_mu_rel,
         "zero_initialised_leaves_step_second_moments_rel_diff":
             zero_nu_rel,
         "rtol": TRAIN_CPU_RTOL,
         "cpu_threads": 1, "launches_per_step": ca[0],
         "bwd_launches_by_route": routes, "head_dim": cfg.head_dim})
    assert max(loss_rel, norm_rel, mu_rel, param_rel,
               zero_mu_rel or 0.0) <= TRAIN_CPU_RTOL, \
        "card and CPU training disagree"
    for c in ca:
        assert {k: c[k] for k in want} == want, (c, want)
    route = FK.bwd_route(cfg.head_dim)
    assert routes == {r: TRAIN_CPU_STEPS * want["flash_attention_bwd"]
                      if r == route else 0 for r in routes}, routes
    assert not any(v for c in cb for v in c.values()), "the CPU launched"



# Phase 18 in bf16: the same reduced configurations in the reference's
# default dtype, card against CPU from the same bf16 weights and batches.
# Two correct bf16 runs round at different places (the kernels against the
# plain versions, cuBLAS against the CPU's products), so each quantity is
# held, as tests/test_torch_train_bf16.py holds the port to the reference,
# within TRAIN_BF16_RATIO × the CPU's own bf16-vs-f32 distance for it (the
# f32 run from the same weights widened): the RMS over the steps of the
# losses and of the gradient norms, and over all leaves at once of the
# first step's first moments. The mixtrals by their losses alone: a bf16
# router tie moves a token to another expert between any two bf16 runs.
TRAIN_BF16_RATIO = 2.0


def lm_train_card_vs_cpu_bf16(dev, arch: str, head_dim=None,
                              ssm_bf16: bool = False):
    """Phase 18, bf16: ``TRAIN_CPU_STEPS`` bf16 train steps of ``arch``'s
    reduced configuration (with the reference's ``ssm_bf16`` variant where
    asked: the SSD scan's bf16 entry and its backward) on the card and on
    the CPU (one thread), and in f32 on the CPU from the same weights
    widened (without the variant), all on the same batches;
    the card's losses, gradient norms and first-step first moments within
    ``TRAIN_BF16_RATIO`` × the CPU's own bf16-vs-f32 distance (a MoE
    model's losses alone), every weight its dtype and every moment f32
    after the steps, each card step through the kernels as
    ``train_expected_launches`` says (the flash backward's through the
    route of the head width), the CPU's through none."""
    import dataclasses
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.train import FrontendStream
    from repro_torch.models import init_params
    from repro_torch.models.convert import leaves, tree_map
    from repro_torch.train import (DataConfig, TokenStream, adam_init,
                                   make_train_step)
    cfg, tcfg = train_cfg(arch, reduced=True, dtype=torch.bfloat16,
                          ssm_bf16=ssm_bf16), train_tcfg()
    if head_dim is not None:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, ssm_bf16=False)
    stream = FrontendStream(TokenStream(DataConfig(vocab=cfg.vocab, seq=40,
                                                   batch=4)), cfg)
    base = init_params(cfg, torch.Generator().manual_seed(LM_SEED))
    threads = torch.get_num_threads()
    routes = dict(FK.flash_attention_bwd.launches_by_route)
    runs = {}
    for name, c, d, widen in (("card", cfg, dev, False),
                              ("cpu", cfg, torch.device("cpu"), False),
                              ("cpu_f32", cfg32, torch.device("cpu"), True)):
        torch.set_num_threads(1 if d.type == "cpu" else threads)
        step = make_train_step(c, tcfg)
        params = tree_map(lambda t: (t.float() if widen else t).clone().to(d),
                          base)
        opt = adam_init(params)
        losses, norms, counts = [], [], []
        for s in range(TRAIN_CPU_STEPS):
            before = train_launches()
            params, opt, m = step(params, opt, stream.batch(s))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            after = train_launches()
            counts.append({k: after[k] - before[k] for k in after})
            if s == 0:
                mu = torch.cat([t.detach().cpu().flatten()
                                for t in leaves(opt.mu)])
        runs[name] = dict(losses=torch.tensor(losses, dtype=torch.float64),
                          norms=torch.tensor(norms, dtype=torch.float64),
                          mu=mu, counts=counts,
                          dtypes=[t.dtype for t in leaves(params)],
                          moment_dtypes={t.dtype for t in leaves(opt.mu)}
                          | {t.dtype for t in leaves(opt.nu)})
        del params, opt, m
    torch.set_num_threads(threads)
    routes = {r: n - routes[r]
              for r, n in FK.flash_attention_bwd.launches_by_route.items()}
    card, cpu, f32 = runs["card"], runs["cpu"], runs["cpu_f32"]
    ratios, own = {}, {}
    for q in ("losses", "norms", "mu"):
        own[q] = rms_share(cpu[q], f32[q], f32[q])
        ratios[q] = rms_share(card[q], cpu[q], f32[q]) / max(own[q], 1e-30)
    held = ("losses",) if cfg.n_experts else ("losses", "norms", "mu")
    want = train_expected_launches(cfg)
    say({"phase": "lm_train_card_vs_cpu_bf16", "arch": cfg.name,
         "ssm_bf16": ssm_bf16,
         "steps": TRAIN_CPU_STEPS, "losses_card": card["losses"].tolist(),
         "losses_cpu": cpu["losses"].tolist(),
         "losses_cpu_f32": f32["losses"].tolist(),
         "ratio_to_cpu_bf16_vs_f32": ratios, "cpu_bf16_vs_f32_rms_share": own,
         "held": held, "ratio_limit": TRAIN_BF16_RATIO, "cpu_threads": 1,
         "launches_per_step": card["counts"][0],
         "bwd_launches_by_route": routes, "head_dim": cfg.head_dim})
    assert all(np.isfinite(card["losses"].numpy())), "non-finite loss"
    assert all(ratios[q] <= TRAIN_BF16_RATIO for q in held), \
        "card and CPU bf16 training disagree"
    assert card["dtypes"] == [t.dtype for t in leaves(base)] \
        and torch.bfloat16 in card["dtypes"], "a weight changed its dtype"
    assert card["moment_dtypes"] == {torch.float32}, "moments not f32"
    for c in card["counts"]:
        assert {k: c[k] for k in want} == want, (c, want)
    route = FK.bwd_route(cfg.head_dim)
    assert routes == {r: TRAIN_CPU_STEPS * want["flash_attention_bwd_bf16"]
                      if r == route else 0 for r in routes}, routes
    assert not any(v for name in ("cpu", "cpu_f32")
                   for c in runs[name]["counts"] for v in c.values()), \
        "the CPU launched"


# Phase 3b: the O(N²) oracle's size, 16³ = 4,096 particles (its (N, N, 3)
# f32 offsets are 201 MB); the tolerances of tests/test_torch_engine.py's
# test_port_matches_nsquared_oracle
NSQ_NSIDE = 16
NSQ_RTOL = {"rho": 2e-4, "dv": 2e-3, "du": 2e-3}


def sph_nsquared_check(dev) -> dict:
    """Phase 3b: the card's density → ghost → force chain
    (``engine.compute_accelerations``, through the pair kernels) against the
    port's O(N²) oracle (``sph.ref_nsquared``), both on the card, at a
    uniform 16³ lattice with random velocities (the engine test's set-up at
    a larger size, viscosity on): rho within 2e-4, dv and du within 2e-3 of
    the oracle (and 2e-3 of their scale), neighbour counts exact."""
    from repro_torch.kernels.sph_pair import kernel as K
    from repro_torch.sph import SPHConfig, uniform_ic
    from repro_torch.sph.cellgrid import (bin_particles, build_pair_list,
                                          choose_grid)
    from repro_torch.sph.engine import compute_accelerations
    from repro_torch.sph.ref_nsquared import nsq_density, nsq_forces
    ic = uniform_ic(NSQ_NSIDE, seed=0)
    rng = np.random.default_rng(1)
    ic["vel"] = (ic["vel"] + 0.1 * rng.standard_normal(ic["vel"].shape)
                 ).astype(np.float32)
    pos, vel, mass, u, h, box = (ic[k] for k in
                                 ("pos", "vel", "mass", "u", "h", "box"))
    cfg = SPHConfig(alpha_visc=0.8)
    t0 = time.perf_counter()
    rho_o, drho_o, nngb_o = nsq_density(pos, mass, h, box, device=dev)
    omega_o = 1.0 + (torch.from_numpy(h).to(dev) / (3 * rho_o)) * drho_o
    dv_o, du_o = nsq_forces(pos, vel, mass, u, h, rho_o, omega_o, box,
                            alpha_visc=cfg.alpha_visc, device=dev)
    synchronize(dev)
    oracle_s = time.perf_counter() - t0
    spec = choose_grid(box, float(h.max()), len(pos))
    cells, perm = bin_particles(spec, pos, vel, mass, u, h, device=dev)
    pairs = build_pair_list(spec, device=dev)
    n0 = launch_counts(K)
    dv, du, rho, nngb = compute_accelerations(cells, pairs, cfg)
    synchronize(dev)
    launched = {k: v - n0[k] for k, v in launch_counts(K).items()}
    valid = torch.from_numpy(perm >= 0).to(dev)
    idx = torch.from_numpy(perm[perm >= 0]).to(dev)

    def flat(a):
        out = torch.zeros((len(pos),) + tuple(a.shape[2:]),
                          dtype=a.dtype, device=dev)
        out[idx] = a[valid]
        return out

    errs = {}
    for name, got, want in (("rho", flat(rho), rho_o), ("dv", flat(dv), dv_o),
                            ("du", flat(du), du_o)):
        rt = NSQ_RTOL[name]
        atol = 0.0 if name == "rho" else rt * float(want.abs().max())
        excess = float(((got - want).abs() - rt * want.abs() - atol).max())
        errs[name] = {"max_abs": float((got - want).abs().max()),
                      "within": excess <= 0.0}
    nngb_diff = int((flat(nngb) != nngb_o).sum())
    say({"phase": "sph_nsquared", "n_side": NSQ_NSIDE, "particles": len(pos),
         "C": spec.capacity, "pairs": int(pairs.ci.shape[0]),
         "pair_tensor_bytes": 4 * 3 * len(pos) ** 2,
         "oracle_s": oracle_s, "errors": errs, "rtol": NSQ_RTOL,
         "nngb_differ": nngb_diff, "launches": launched})
    assert all(e["within"] for e in errs.values()), errs
    assert nngb_diff == 0, "neighbour counts differ from the oracle's"
    assert launched["density_pair_cells"] > 0 and launched["force_pair"] > 0
    return {k: e["max_abs"] for k, e in errs.items()}


# Phase 19: the examples (``examples_torch/``, the port of ``examples/``)
# on the card, each as a subprocess at a small size: (script, arguments)
EXAMPLES = (("quickstart.py", []),
            ("sedov_blast.py", ["8", "2", "--max-depth", "6"]),
            ("sph_strong_scaling.py", ["1000", "--ranks", "1,2,4"]),
            ("fleet_serve.py", ["--trace", "{tmp}/fleet_trace.json"]),
            ("serve_lm.py", []),
            ("train_lm.py", ["--steps", "2", "--ckpt", "{tmp}/ckpt"]))


def examples_on_the_card() -> None:
    """Phase 19: every example run on the card (no ``--device``: the card
    by default) as a subprocess of its own, all six at once (each process
    spends seconds reaching the card), each in a temporary directory; each
    must exit 0. One line each with its wall (beside the others) and its
    output's last line."""
    import shutil
    import tempfile
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

    def run(example):
        script, args = example
        tmp = tempfile.mkdtemp(prefix="chip_smoke_example_")
        try:
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, os.path.join(ROOT, "examples_torch", script),
                 *(a.format(tmp=tmp) for a in args)], cwd=tmp, env=env,
                capture_output=True, text=True, timeout=300)
            return res, time.perf_counter() - t0
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(EXAMPLES)) as pool:
        results = list(pool.map(run, EXAMPLES))
    total = time.perf_counter() - t0
    for (script, args), (res, wall) in zip(EXAMPLES, results):
        lines = res.stdout.strip().splitlines()
        say({"phase": "example", "script": f"examples_torch/{script}",
             "args": args, "wall_s": wall, "all_six_wall_s": total,
             "rc": res.returncode,
             "last_line": lines[-1] if lines else None,
             "stderr_tail": res.stderr[-1500:] if res.returncode else ""})
    for (script, _), (res, _) in zip(EXAMPLES, results):
        assert res.returncode == 0, f"examples_torch/{script} failed"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels.sph_pair import kernel as K
    warnings.simplefilter("ignore", DeprecationWarning)
    t_start = time.perf_counter()
    dev = resolve_device(None)
    card = card_line()
    say({"phase": "card", "nvidia_smi": card,
         "name": torch.cuda.get_device_name(0),
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
         "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32,
         "allow_bf16_reduced_precision_reduction":
             torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction})
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction

    from repro_torch.kernels.flash_attention import kernel as FK
    builds = [mod.library for mod in
              [K] + [mod for mod, _ in lm_kernel_modules().values()]]
    from repro_torch.kernels.mamba_scan import kernel as MK
    from repro_torch.kernels.ssd_scan import kernel as SK
    builds += [FK.library_bwd, MK.library_bwd, SK.library_bwd]
    t0 = time.perf_counter()
    # each library() builds at first use; from one thread each, one nvcc
    # process each runs at once
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda build_one: build_one(), builds))
    say({"phase": "build", "seconds": time.perf_counter() - t0,
         "log": build.BUILD_LOG})

    spec, cells, pairs, thermo = sedov_setup(dev)
    errs = check_kernels(dev, spec, cells, pairs, thermo)
    sph_nsquared_check(dev)
    timing = time_kernels(spec, cells, pairs, thermo)
    del cells, pairs, thermo
    torch.cuda.empty_cache()

    phase5 = main_path(dev)
    launches = kernel_launches(phase5["launches"])
    card_matches_cpu(dev)
    card_matches_cpu(dev, n_side=6)     # the conformance size, C = 88
    global_path(dev)
    global_distributed(dev)
    for name, n in timebin_distributed(dev).items():
        launches[name] += n
    for path in (lambda: observed_main_path(dev, phase5),
                 lambda: observed_timebin_distributed(dev)):
        for name, n in path().items():
            launches[name] += n
    del phase5
    determinism(dev)
    for name, n in kernel_launches(fleet_serving(dev)).items():
        launches[name] += n
    fleet_step_timing(dev)
    fleet_card_matches_cpu(dev)

    errs.update(lm_check_kernels(dev))
    timing.update(lm_time_kernels(dev))
    serve_archs = ((LM_ARCH, MAMBA1_ARCH) + DENSE_ARCHS + ENCDEC_ARCHS
                   + MOE_ARCHS)
    f32_lines = {}
    for arch in serve_archs:
        f32_lines[arch], counts = lm_serve_path(
            dev, arch, serve_layers(arch, torch.float32))
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    for arch in ((LM_ARCH, MAMBA1_ARCH) + DENSE_ARCHS + DENSE_REDUCED_ONLY
                 + ENCDEC_ARCHS + MOE_ARCHS):
        lm_card_matches_cpu(dev, arch)

    errs.update(lm_check_kernels_bf16(dev))
    timing.update(lm_time_kernels_bf16(dev))
    for arch, batch, ssm_bf16 in BF16_SERVE:
        _, counts = lm_serve_path(dev, arch,
                                  serve_layers(arch, torch.bfloat16),
                                  dtype=torch.bfloat16, batch=batch,
                                  ssm_bf16=ssm_bf16,
                                  f32_figures=f32_lines.get(arch))
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    for arch in (DENSE_ARCHS + DENSE_REDUCED_ONLY + (LM_ARCH, MAMBA1_ARCH)
                 + ENCDEC_ARCHS + MOE_ARCHS):
        lm_card_matches_cpu_bf16(dev, arch)
    lm_card_matches_cpu_bf16(dev, "gemma3-27b", prompt_len=64)   # banded
    lm_card_matches_cpu_bf16(dev, LM_ARCH, ssm_bf16=True)

    errs["flash_attention_bwd"], timing["flash_attention_bwd"] = \
        lm_check_backward(dev)
    errs["flash_attention_bwd_bf16"], timing["flash_attention_bwd_bf16"] = \
        lm_check_backward_bf16(dev)
    _, counts = lm_train_path(dev)
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    errs_scan, timing_scan = lm_check_scan_backward(dev)
    errs.update(errs_scan)
    timing.update(timing_scan)
    from repro_torch.configs import get_config
    for arch, n_layers in MAMBA_TRAIN:
        _, counts = train_steps(dev, train_cfg(arch, n_layers), train_tcfg(),
                                get_config(arch).n_layers)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    train_runs = [(train_cfg(arch, n_layers), published)
                  for arch, n_layers, published in MOE_TRAIN]
    train_runs.append((train_cfg(TRAIN_ARCH, GRANITE_BF16_LAYERS,
                                 dtype=torch.bfloat16), 36))
    # zamba2-1.2b uncut in bf16 under ssm_bf16: the bf16 SSD entry and its
    # backward
    train_runs.append((train_cfg(LM_ARCH, dtype=torch.bfloat16,
                                 ssm_bf16=True),
                       get_config(LM_ARCH).n_layers))
    for cfg, published in train_runs:
        _, counts = train_steps(dev, cfg, train_tcfg(), published)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    for arch, head_dim in TRAIN_CPU_CASES:
        lm_train_card_vs_cpu(dev, arch, head_dim)
    for arch, head_dim in TRAIN_CPU_CASES:
        lm_train_card_vs_cpu_bf16(dev, arch, head_dim)
    lm_train_card_vs_cpu_bf16(dev, LM_ARCH, ssm_bf16=True)
    examples_on_the_card()

    sph = "src/repro_torch/kernels/sph_pair/csrc/sph_pair.cu"
    source = {"density_pair": sph, "force_pair": sph,
              "ssd_scan": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
              "flash_attention": "src/repro_torch/kernels/flash_attention/"
                                 "csrc/flash_attention.cu",
              "flash_attention_bwd": "src/repro_torch/kernels/"
                                     "flash_attention/csrc/"
                                     "flash_attention_bwd.cu",
              "selective_scan": "src/repro_torch/kernels/mamba_scan/csrc/"
                                "selective_scan.cu",
              "selective_scan_bwd": "src/repro_torch/kernels/mamba_scan/"
                                    "csrc/selective_scan_bwd.cu",
              "ssd_scan_bwd": "src/repro_torch/kernels/ssd_scan/csrc/"
                              "ssd_scan_bwd.cu"}
    replaces = {"density_pair": "src/repro/kernels/sph_pair/kernel.py:132",
                "force_pair": "src/repro/kernels/sph_pair/kernel.py:224",
                "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:82",
                "flash_attention":
                    "src/repro/kernels/flash_attention/kernel.py:80",
                # no TPU kernel: the reference differentiates plain jnp
                # attention (layers.py:_sdpa); the kernel it is the
                # backward of
                "flash_attention_bwd":
                    "src/repro/kernels/flash_attention/kernel.py:80",
                "selective_scan": "src/repro/kernels/mamba_scan/kernel.py:51",
                # no TPU kernel: the reference differentiates its plain
                # scans (models/mamba.py); the kernels they are the
                # backwards of
                "selective_scan_bwd":
                    "src/repro/kernels/mamba_scan/kernel.py:51",
                "ssd_scan_bwd": "src/repro/kernels/ssd_scan/kernel.py:82"}
    names = ["density_pair", "force_pair"] + LM_ENTRIES + [
        "flash_attention_bwd", "flash_attention_bwd_bf16",
        "selective_scan_bwd", "ssd_scan_bwd", "ssd_scan_bwd_bf16"]
    base = {name: name.replace("_bf16", "") for name in names}
    say({"kernels": [
        {"name": name, "route": "cuda", "source": source[base[name]],
         "replaces": replaces[base[name]],
         "launches": launches.get(name, 0),
         "max_abs_err": errs[name], "ms": timing[name]["ms"],
         "plain_ms": timing[name]["plain_ms"],
         "bound_ms": timing[name].get("route_bound_ms",
                                      timing[name]["bound_ms"]),
         # the kind of operations (bf16, 3×TF32) is in the phase lines
         "bound_by": timing[name].get("route_bound_by",
                                      timing[name]["bound_by"]).split()[0],
         "library_ms": timing[name].get("library_ms"),
         **({"bound_3xtf32_ms": timing[name]["bound_ms"]}
            if "route_bound_ms" in timing[name] else {})}
        for name in names]})
    say({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
