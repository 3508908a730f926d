#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

Phases (each raises on failure, and the script then exits non-zero):
  1. device  — require CUDA, print the card's name and power limit
               (``nvidia-smi``), turn TF32 off for the plain versions;
  2. build   — build the CUDA kernels from ``src/repro_torch/kernels/csrc``
               with nvcc for sm_90a, print the build seconds and each
               kernel instantiation's registers, shared memory and spill
               bytes (``-Xptxas -v``) and ptxas's notes on the wgmma
               bodies (serialized wgmmas, injected waits); any spill, and
               any note that ptxas serialized a kernel's wgmmas, fails the
               phase;
  3. serve   — the main path: full-width Mixtral-8x7B (d_model 4096,
               32/8 heads of 128, 8 experts top-2, d_ff_expert 14336,
               vocab 32000 padded to 32768) with depth cut to 2 layers,
               random weights from a seeded torch.Generator, served by
               ``build_engine`` with the default ``EngineConfig`` (paged
               KV) and the dequant-matmul kernels on a frontier point that
               has q4, q8 and bf16 experts: 4 requests of 16 prompt tokens
               x 8 new tokens, a cold pass and a warm rerun. Every serve
               pass zeroes the kernels' launch counters just before and
               reads them just after, and requires B3 (q4, q8), B4 and
               launches whose plan splits K (``SPLIT_LAUNCHES``: each
               runs its splits folded, a tile's in one block, booked in
               ``FOLDED_LAUNCHES``, or reduces them in its own epilogue;
               there is no stand-alone reduction kernel or counter);
     3b. paged == slot — the model hooks give bit-equal prefill and
               first-decode logits through pages and slot rows; a
               ``paged_kv=False`` engine serves the same greedy tokens;
     3c. overlap — ``overlap=True`` (async streaming on side streams, the
               per-layer pipeline) on a point with all three rungs and at
               least half of the experts off the card, a swap cache of two
               experts: greedy tokens equal to the non-overlap engine's on
               the same point, transfer and overlap metrics printed, no
               ``expert-xfer`` thread alive after ``close()``;
     3d. speculative — ``speculate=2`` on the default traffic: greedy
               tokens equal to plain decode's, the G = 8 int4 draft bank
               launched, the acceptance rate printed, and a per-op probe
               of whether a verify row is bit-equal to the decode row;
     3p. prefill — long prompts on the serve point (``max_slots=2,
               max_len=2064``): two of 512 tokens (bucket 512, expert
               capacity C = 160), two of 200 (bucket 256, C = 80), one of
               1024 (C = 320) and one of 2048 (C = 640), 4 new tokens each,
               a cold pass and a warm rerun: every prefill launches B3 (q4,
               q8) and B4 through the body that ``launch_plan`` names for
               its C and only through it (512, 1024, 2048 tokens: the wide
               wgmma body in one, two and four 160-token tiles; 200: the
               128-token wgmma body), every decode iteration (C = 4 rows
               on the card) through the mma.sync body only (launches
               booked per body and prompt, prefills apart from decode
               iterations, and the folded ones per bank and body);
               prefill ms per request and, warm, per prompt length; a
               ``use_kernel=False`` engine at the same plan: prefill
               logits within 2e-2 of max |logit| (7b's rule), the
               greedy tokens equal or their first divergence reported with
               its logit margins;
     3f. calibrate — ``calibrate_sensitivity`` on the full-width model
               twice with one seed: byte-identical profiles, seconds of
               each run; the card's per-rung quantize of one expert
               bit-equal to the CPU's (runs before 3e, which uses it);
     3e. qos + dynamic — one default engine under a ``QoSController``
               (window 2, dwell 4) with a ``DynamicPrecisionController``
               on the calibrated profile, 8 requests x 16 prompt tokens x
               24 new tokens: a best-effort target adopted at the serve
               point walks toward the fast end; after 12 iterations one
               direct ``apply_bits_update`` (int4 <-> int8, one placement,
               layer 0; banks equal to a fresh build) and a budget drop to
               the midpoint between the smallest footprint and the active
               point: exactly one replan, the final plan inside the
               budget, B3/B4 launched at each bank-split plan's G per
               rung; each replan's kind, reconfig_s, drain_s and peak
               memory printed; serving params, prefill and first-decode
               logits bit-equal and greedy tokens equal to a fresh engine
               at the final (point, bits); then ``apply_bits_update`` on
               an overlap engine with requests in flight, an int4 and an
               int8 expert off the card swapping rungs while one of them
               is in the swap cache and a prefetch copy is in flight:
               restaged 1, cache byte delta +-(int8 - int4 expert bytes),
               B3/B4 launched after it, bit-equal to a fresh engine, no
               ``expert-xfer`` thread alive after ``close()``;
     3g. multi-tenant — two full-width tenants (seeds 0 and 1) under one
               ``MultiTenantEngine`` sharing an ``AsyncExpertCache`` of two
               bf16 experts through ``ScopedExpertCache`` views, overlap
               on; budget 0.6x the summed bf16 footprint, then 0.45x:
               exactly one joint re-arbitration, allocations inside the
               budget, each tenant's greedy tokens equal to a standalone
               engine's at its final point, replan reports and tokens/s
               printed, no ``expert-xfer`` thread alive after ``close()``;
     3h. cli — ``repro_torch.launch.serve.main`` in process at ``--smoke``:
               ``--calibrate``, then ``--ladder 16,8,4 --profile <it>
               --dynamic-precision --temperature 0``, then a two-tenant
               ``--tenants`` spec; each prints its target and summary,
               every engine it builds runs the kernels, and the launch
               counters (zeroed before each run) show each rung bank of
               its final plans launched;
     7a. poisson — the paper's serving under load, on the serve phase's
               params: ``drive_poisson`` submits 16 requests (8-32 prompt
               tokens, 8-24 new tokens, priorities 0 and 1) on exponential
               arrival clocks with a mean gap of 0.01 s (about one warm
               decode iteration) to the default paged engine with the
               kernels on, a ``QoSController`` stepped between decode
               iterations (best effort from the serve phase's point),
               ``drain=False``; then a lower memory budget that splits
               the banks with requests in flight, then a drain: every
               request finishes with its ``max_new_tokens``, each rung
               bank of the final plan launched, each replan's kind,
               ``reconfig_s`` and ``drain_s`` printed with tokens/s, p50
               and p95 request latency and launches per bank; then the
               same traffic on a fixed plan without the controller gives
               the greedy tokens of the same prompts submitted all at
               once to a fresh engine;
  8. ep      — expert- and data-parallel serving on the serve phase's
               params, every rank on ``cuda:0`` (a repeated device list):
     8a. model — per ep, a plan whose banks split over it (ep 2: int4 4,
               int8 2, bf16 2 experts per layer; ep 4: int4 4, bf16 4):
               ``Model.prefill`` of 2 x 8 tokens + 4 greedy decode steps
               with the kernels on, logits bytes equal to ep 1; each rank
               launches each of its bank shards at G = bank / ep (3
               matrices x 2 layers x 5 forwards), and launches whose
               plan splits K (reduced in their own epilogue), booked per
               rank; ep 2's plan also prefills one 1024-token prompt
               (C = 320, the wide wgmma body) twice at ep 1 (int8 bank
               G = 2) and ep 2 (G = 1 a rank): logits bytes equal, every
               bank through that body only, the int8 bank's
               down-projections folded at ep 1 and spread at ep 2 on
               every rank (as ``fold_splits`` gives their G, booked per
               rank), the warm prefill ms of each printed beside 3p's
               1024-token prompt (int8 G = 4);
     8b. engine — default paged engines at ep 1, 2, 4: a three-rung point
               A of the ep 2 frontier, 4 requests, a replan to a point B
               of the ep 4 frontier that moves experts between the ranks
               of ep 2, 4 more requests: greedy tokens equal to ep 1's;
               then ms per decode iteration, decode tokens/s and peak GB
               per ep (readings: the ranks serialize on one card);
     8c. group + cli — ``make_dp_group(dp=2, ep=2)`` over four ``cuda:0``
               under the autoscaler, one scale-down draining a replica
               with a request in flight, every request retired with its
               tokens; the serve CLI at ``--smoke --ep 2 --dp 2 --device
               cuda:0,cuda:0,cuda:0,cuda:0``; ``--ep 2 --device cuda`` on
               a one-card host raises the devices error;
  6. train   — after the serve phases release their params (card memory
               printed before and after):
     6a. train step — the full-width 2-layer Mixtral (3.17 B params) from
               seeded params: AdamW, 2 microbatches, batches of 4 x 128
               from ``DataPipeline``; 3 steps, then the same 3 steps from
               the same seed again with params, moments and step
               bit-equal; 5 steps on one fixed batch with the nll falling;
               each step's ms, tokens/s and peak GB; the smoke model's
               float32 loss and gradients on the card against the CPU's
               (1e-5 relative, 1e-4 x max|g|); one Adafactor step; two
               int8-compressed steps (Adafactor), the codes, scales and
               residuals of one corrected gradient byte-equal to the CPU's;
     6b. ckpt -> serve — the trained params saved by
               ``CheckpointManager`` (seconds, GB/s), then
               ``repro_torch.launch.serve.main --ckpt-dir`` in process on
               the 2-layer full-width config at ``--ladder 16,8,4
               --max-ppl-x 1.04``: its restore timed and bit-equal to the
               saved params, launch counters zeroed before and each rung
               bank of its final plan launched after, and the same greedy
               tokens as the same CLI run on the in-memory params;
     6c. train cli — ``repro_torch.launch.train.main`` in process at
               ``--smoke`` (SmolLM-360M), 6 steps with a checkpoint every
               3, then a restart with ``--resume`` from step 3: equal step
               lines and a step-6 checkpoint bit-equal to the straight
               run's;
     7b. kimi  — full-width Kimi-K2 (d_model 7168, 64/8 heads of 112,
               384 experts top-8, d_ff_expert 2048, vocab 163840), depth
               cut 61 -> 1, weights drawn on the card (38.8 GB): the
               planner's point for a 16 GB budget and a quality ceiling
               (int4 bank of >= 320 experts beside int8 and bf16 banks)
               applied through ``apply_frontier_point``; 4 requests x 16
               prompt x 8 new tokens with the kernels on, each bank
               launched at its G (the folded launches logged per bank
               and body); a ``use_kernel=False`` engine at the
               same plan: logits within 2e-2 of max |logit|, the first
               token divergence (if any) with its logit margins; peak
               memory;
     7c. qwen3 — full-width Qwen3-8B (qk-norm), depth cut 36 -> 2: one
               forward and backward of ``Model.loss_fn``, finite loss,
               nonzero q/k-norm gradients; the smoke Qwen3 at float32 on
               the card against the CPU at 6a's bars (no kernel: dense);
     7d. families — RWKV6-3B, Zamba2-7B, SeamlessM4T-medium and
               PaliGemma-3B at full width and full depth in bf16, weights
               drawn on the card by ``init_params``, one model at a time:
               ``Model.prefill`` of B = 2 prompts (300 tokens for the SSM
               and the hybrid, which pads both chunk sizes; 1024 encoder
               frames + 32 tokens; 256 patches + 32 tokens), then 16
               greedy ``Model.decode_step``s: params GB, prefill ms per
               batch, ms per decode step, decode tokens/s and peak GB
               (CUDA events after one warm-up); finite logits, two
               prefills bit-equal, decode == prefill (S-1 tokens + one
               step vs S) within 5e-2 of max |logit|, each decode step
               against a prefill of its prefix (first greedy divergence
               and margins); the same at float32 with depth cut to 2
               (Zamba2 7) within 1e-3; the chunked SSM cores against their
               per-token oracles at full-width head shapes in f32 (S =
               300, with and without an initial state, 1e-4 of max |y|);
               each smoke config at float32 on the card against the CPU
               (logits 1e-5 of max |logit|; loss and gradients at 6a's
               bars). No kernel: these families' products are plain
               ``matmul``/``einsum``, as plain ``jnp`` in the reference;
     7e. families-train — ``Model.loss_fn`` forward and backward at full
               width, RWKV6 depth 32 -> 4 and Zamba2 81 -> 7, on 2 x 256
               tokens, twice: gradients bit-equal, loss within 0.5 of
               ln(vocab), nonzero gradients on ``A_log``, ``dt_bias``,
               ``conv``, ``decay_lora_a/b``, ``bonus``, ``mix`` and the
               shared attention block; ms and peak GB;
  9. mesh    — sharded training and MoE over (data, model) meshes, every
               position on ``cuda:0`` (a repeated device list), after the
               train phases release their memory:
     9a. moe   — ``mixed_moe.moe_apply`` at one full-width Mixtral layer
               (8 experts, d 4096, d_ff 14336) in each regime: token-gather
               on (2, 2) at 16 tokens, data x EP on (2, 2) at 8192 tokens
               per data rank (past the 64 MiB gate by itself, drop-free
               capacity on both sides), TP on (1, 16) at 16 tokens; the
               bf16 train layout forward and backward, then int4 | int8 |
               bf16 banks (4/2/2 experts) with the kernels on: outputs
               bytes equal to the one-device ``moe_apply`` where the regime
               does not split d_ff (data x EP), within 2e-2 of max |y|
               where it does, every kernel launch held against its plain
               version and booked per position (kernel, G, C x K x N);
     9b. train — full-width Mixtral, depth 32 -> 1, on (2, 2), the dense
               compute split over the mesh: AdamW, 2 microbatches, 3 steps
               of 4 x 128 from seeded params, twice (params and moments
               bit-equal), every shard's shape from ``param_specs``/
               ``opt_state_specs``, replicas equal after every step, each
               step's nll within 1e-2 of the one-device step's and of one
               device's at the mesh's params, the first step's grad norm
               within 1e-2 of one device's; one Adafactor and one int8 +
               Adafactor step; step ms, tokens/s, peak GB;
     9c. serve — ``build_model(cfg, mesh)`` on ``apply_precision_plan(...,
               mesh=)`` (int4 4, int8 2, bf16 2 per layer) at depth 2 on
               (2, 2) (token-gather, the dense compute split) and (1, 16)
               (TP, pure-EP serving rules: the dense compute whole): prefill
               of 2 x 8 + 4 decode steps with the kernels on, fed the
               one-device run's greedy tokens: logits within 2e-2 of max
               |logit|, greedy ids equal wherever one device's top-2 margin
               is firm; launches per position, ms per decode step, peak GB,
               and one more decode step counted by ``roofline.op_count``
               (per-position GB and FLOPs);
     9d. cli   — ``repro_torch.launch.train.main`` at ``--smoke --mesh 2,2
               --device cuda:0,cuda:0,cuda:0,cuda:0`` with a checkpoint,
               then ``--resume`` on ``--mesh 1,1``: the elastic restore's
               params bit-equal to the saved ones;
     9e. families mesh (runs after 7e) — RWKV6-3B (depth 32 -> 2),
               Zamba2-7B (81 -> 7: one group of six and the tail) and
               SeamlessM4T-medium (12 + 12 -> 2 + 2) at full width, their
               dense compute split over (2, 2) of repeated ``cuda:0``: in
               float32, prefill of 2 x 8 tokens (1024 encoder frames for
               SeamlessM4T) and 4 decode steps through ``_mesh_decode``
               against one device's run at the same params, fed its
               greedy tokens: logits within 1e-4 of max |logit|, greedy
               ids equal; the same in bf16, the gap and ms per decode step
               printed, greedy ids equal wherever one device's top-2
               margin exceeds twice the gap; one split AdamW step (bf16, 2
               microbatches of 2 x 64) twice from the same params: params
               and moments bit-equal, nll within 1e-2 of one device's at
               those params; the split Zamba2 decode step's op count on
               the card equal to ``meta``'s;
 10. roofline — full-width Mixtral-8x7B at the serve depth (2) on a (1, 1)
               mesh of ``cuda:0`` with ``use_kernel=False`` (the dry run's
               program, ``launch/dryrun.py`` ``build_cell``): a decode step
               at batch 32 over a 4096-token cache, a prefill of 4 x 2048
               tokens and an AdamW train step of 2 x 256 tokens, each
               counted by ``roofline.op_count`` on the card and on
               ``meta`` (op sequence, FLOPs, bytes and collectives must be
               equal), timed on the host (median of 3) and by the
               profiler (device busy), and held against its count's bound
               max(FLOPs / 989e12, bytes / 3.35e12): bound / device time,
               bound / wall, busy share; then the decode step on a (2, 2)
               mesh of repeated ``cuda:0``, the dense compute split,
               counted on the card and on ``meta`` (equal op sequence,
               FLOPs, bytes and collectives), with each position's FLOPs
               and GiB; ``tools/chip_phases.py dry-cell`` runs one dry-run
               cell (``run_cell``, Mixtral ``decode_32k`` on the
               256-position mesh of ``meta``) on the card's host and
               prints its ``trace_s``;
 11. engine mesh — ``build_engine`` on full-width Mixtral-8x7B (depth
               2) over a (2, 2) mesh of repeated ``cuda:0``, the dense
               compute split (each data rank's slots, heads and vocab
               slices over model, the KV pool placed per data rank), the
               kernels on: the paged, slot, overlap and ``speculate=2``
               configs serve the same 8 prompts across one bank-split
               replan A -> B; paged == slot and overlap == sync (every
               sampled logit bit-equal), speculative == plain greedy
               tokens, a warm rerun equal, the one-device engine's tokens
               equal up to near-ties (a router top-k boundary below 2**-8
               or a top-2 logit margin below twice 9c's bar, met by that
               request on the split path), B3 (q4, q8), B4 and launches
               that split K launched at every position of every
               config (counts printed per position), ms per decode
               iteration and tokens/s of a warm pass beside one device's,
               peak GB and KV pool bytes per position (the pool's over
               the data ranks); the kernel phase then times B3 and B4 at
               its launch shapes that no other row has;
  4. parity  — the smoke-size model's prefill + decode logits on the card
               (kernels) agree with the same model on the CPU (the
               kernels' plain versions);
  5. kernels — each kernel against its plain PyTorch version on the card
               at the serving bank layout (G experts per rung) and the
               shapes of ``SHAPES``: decode rows at the serve point's C =
               4 and at C = 8, up/gate (G, 4096, 14336) and down (G, 14336,
               4096), C = 16 decode, prefill at C = 128 (up and down) and
               80 (up), which the wgmma body serves, and at C = 160 (up and
               down), 320 (up and down) and 640 (up), which the wide wgmma
               body serves in ceil(C / 160) token tiles, and 256 (up), two
               128-token tiles of the wgmma body on the wide body's K
               splits; within one bf16 ulp
               of |plain| + 1e-3, and two launches bit-equal; the split-K
               epilogue at every row that splits K and every bank: ``out``
               byte-equal to ``splitk_reduce_plain`` of the partials left
               in a caller-given workspace, eager, on a second launch and
               after a CUDA-graph replay, and the same launch folded (a
               tile's splits in one block) byte-equal to it, eager and
               replayed; bit-exact checks in the three bodies (grouped ==
               per-expert, integer-friendly inputs, empty group == zeros,
               f32 dequant), the down-projection's grouped launch folded
               byte-equal to the per-expert loop spread (int8 G = 4 at C =
               128 and 320, int4 G = 3 at C = 128, both grids read from
               the launch books), row invariance on one plan (rows of a C = 12
               verify launch bit-equal to a C = 8 launch, of C = 8 to C =
               4; rows of a C = 80 launch bit-equal to a C = 128 launch, of
               a C = 160 launch to a C = 256 launch, of C = 256 to C =
               320, of C = 320 to C = 640, of C = 160 to C = 320 at the
               down-projection and on Kimi's bank of C = 160 to C = 216),
               and of a C = 128 launch to a C = 160 launch where the
               two plans split K alike, the
               G = 8 draft bank at C = 12; device times (CUDA graphs)
               beside the plain version, the bound and a library yardstick
               (``torch.bmm`` on the dequantized bf16 weights, which the
               port never calls); B3 (int4 and int8) at Kimi-K2's widths
               and G = 384, C = 8 (up: K 7168, N 2048; down: K 2048, N
               7168), and the int4 bank's up-projection at C = 108 and
               216 (the 4096- and 8192-token prefill buckets), held
               against its plain version
               on the first, a middle and the last expert of the bank; B3
               and B4 at phase
               9's shard shapes (token-gather up K 4096, N 7168 and down
               K 7168, N 4096 at G = bank / 2; TP up N 896 and down K 896
               at G = bank), C = 8.

A failed phase is reported and the phases that do not need its result
still run; the script then exits 1 and prints no result. Otherwise the
line before the last is the kernels' JSON record (an entry per kernel
and body: the mma.sync entries count the serve phase's launches, the
wgmma entries, ``<wrapper>@wgmma`` and ``<wrapper>@wgmma_wide``, phase
3p's); the last line is
``{"ok": true, "device": {...}}``. ``--out`` also writes the records to a
JSON file (default ``chiprun_out/chip_smoke.json``).
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet (dense): the bound of every kernel
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
D_MODEL, D_FF = 4096, 14336     # Mixtral-8x7B expert widths
#: decode rows per expert at the serve point (4 slots, top-2 of 8: capacity
#: rounded up to 4), which the card's kernels take unpadded
C_SERVE = 4
C_DECODE = 8          # decode rows per expert at 13-25 tokens' capacity
C_PREFILL = 128
GROUP = 64
#: (C, K, N) of every timed kernel shape: the decode up- and down-
#: projections at the serve point's C = 4 and at C = 8; decode at C = 16,
#: which is where 26-51 slots pad to under capacity factor 1.25; prefill
#: at C = 128 (up and down) and C = 80 (a 200-token prompt's bucket of
#: 256), which the wgmma body serves; and C = 160 (bucket 512, up and
#: down) and C = 320 (bucket 1024), which the wide wgmma body serves in one
#: 160-token tile and two, and C = 256, two 128-token tiles of the wgmma
#: body on the wide body's splits; then C = 320
#: down, C = 640 (bucket 2048) up and C = 640 down, appended last so that
#: every earlier row keeps its place (tools/kernel_ab.py seeds a case by
#: it)
SHAPES = {
    "decode4_up": (C_SERVE, D_MODEL, D_FF),
    "decode4_down": (C_SERVE, D_FF, D_MODEL),
    "up": (C_DECODE, D_MODEL, D_FF),
    "down": (C_DECODE, D_FF, D_MODEL),
    "decode16": (16, D_MODEL, D_FF),
    "prefill_up": (C_PREFILL, D_MODEL, D_FF),
    "prefill_down": (C_PREFILL, D_FF, D_MODEL),
    "prefill80_up": (80, D_MODEL, D_FF),
    "prefill160_up": (160, D_MODEL, D_FF),
    "prefill160_down": (160, D_FF, D_MODEL),
    "prefill320_up": (320, D_MODEL, D_FF),
    "prefill256_up": (256, D_MODEL, D_FF),
    "prefill320_down": (320, D_FF, D_MODEL),
    "prefill640_up": (640, D_MODEL, D_FF),
    "prefill640_down": (640, D_FF, D_MODEL),
}
#: the wide wgmma body's token tile
C_WIDE = 160
#: the speculative verify's drop-free capacity B * (K + 1) = 4 * 3 rows per
#: expert, at which the draft's int4 bank of all 8 experts is also timed
C_VERIFY = 12
DRAFT_G = 8
DRAFT_SHAPES = {
    "draft_up": (C_VERIFY, D_MODEL, D_FF),
    "draft_down": (C_VERIFY, D_FF, D_MODEL),
}


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# phase 1: device
# --------------------------------------------------------------------------

def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available"
                         "() is false); this script runs on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    return smi


# --------------------------------------------------------------------------
# phase 2: build
# --------------------------------------------------------------------------

def ptxas_report(build_log: str):
    """Registers, shared memory and spill bytes per kernel instantiation,
    from nvcc's ``-Xptxas -v`` lines."""
    import re
    rows, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": _demangle(m.group(1)), "registers": None,
                   "smem_bytes": 0, "spill_stores": 0, "spill_loads": 0,
                   "stack_bytes": 0}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack_bytes"], cur["spill_stores"], cur["spill_loads"] = \
                map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["smem_bytes"] = int(m.group(1))
    return rows


def _demangle(name: str) -> str:
    try:
        out = subprocess.run(["c++filt", name], capture_output=True,
                             text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return name
    return out.replace("(anonymous namespace)::", "") or name


def phase_build():
    """Build the kernels and log each instantiation's registers, static
    shared memory and spills; every kernel of the library can be on the
    main path, so any spill fails the phase."""
    import re

    from repro_torch.kernels import cuda_lib
    t0 = time.perf_counter()
    cuda_lib.build()
    secs = time.perf_counter() - t0
    log(f"build: {secs:.2f} s (nvcc {' '.join(cuda_lib.NVCC_FLAGS)})")
    rows = ptxas_report(cuda_lib.BUILD_LOG)
    if not rows:
        raise AssertionError("no ptxas report in the build log")
    for r in rows:
        log(f"  ptxas: {r['kernel']}: {r['registers']} registers, "
            f"{r['smem_bytes']} B static smem, {r['stack_bytes']} B stack, "
            f"spill {r['spill_stores']} B stores / {r['spill_loads']} B "
            "loads")
    spilled = [r["kernel"] for r in rows
               if r["spill_stores"] or r["spill_loads"]]
    if spilled:
        raise AssertionError(f"kernels spill registers: {spilled}")
    # ptxas's notes on the wgmma bodies: serialized wgmmas, injected waits
    # or an ignored setmaxnreg would each cost a body its overlap
    notes = [line.strip() for line in cuda_lib.BUILD_LOG.splitlines()
             if any(w in line for w in ("C7508", "C7510", "C7513", "C7514",
                                        "C7515", "C7517", "C7520"))]
    log(f"  ptxas wgmma notes: {len(notes)}"
        + "".join(f"\n    {n[:200]}" for n in notes))
    # the wgmma kernel's 128- and 160-token instantiations
    for tile in (128, 160):
        if not any(re.search(rf"wg_matmul_kernel<\d+, \d+, {tile}[,>]",
                             r["kernel"]) for r in rows):
            raise AssertionError(f"the wgmma body's {tile}-token tile is not "
                                 "in the build")
    serialized = [n for n in notes
                  if any(c in n for c in ("C7513", "C7514", "C7517"))]
    if serialized:
        raise AssertionError(f"ptxas serialized wgmmas: {serialized[:3]}")
    # the split-K reduction lives in the matmuls' epilogues: no kernel of
    # its own
    reduce = [r["kernel"] for r in rows if "splitk" in r["kernel"]]
    if reduce:
        raise AssertionError(f"a stand-alone split-K kernel is built: "
                             f"{reduce}")
    return secs, rows


# --------------------------------------------------------------------------
# phase 3: serve (the main path)
# --------------------------------------------------------------------------

def serving_config():
    from repro_torch.configs import get_config
    return get_config("mixtral-8x7b").replace(num_layers=2)


def pick_point(frontier, total):
    """A frontier point with q4, q8 and bf16 experts all present and some
    experts left off the card (so the expert cache streams): the most
    resident such point, then the most even rung split."""
    cand = [p for p in frontier.points
            if all(c > 0 for c in p.counts_per_rung)
            and p.resident_experts < total]
    if not cand:
        raise RuntimeError("no frontier point with all three rungs")
    return min(cand, key=lambda p: (-p.resident_experts,
                                    max(p.counts_per_rung)
                                    - min(p.counts_per_rung)))


MAX_NEW = 8                    # tokens generated per request
SERVE_CFG = dict(max_slots=4, max_len=48, use_kernel=True, ladder=(16, 8, 4))
MAIN_KERNELS = ("grouped_q4", "grouped_q8", "grouped_bf16")


def serve_pass(torch, engine, prompts):
    """Serve ``prompts`` once (``MAX_NEW`` tokens each) with the engine's
    counters and the kernels' launch counters zeroed just before and read
    just after. The first iteration admits and prefills every request;
    the launches of the iterations after it are the launches per decode
    iteration."""
    from repro_torch.kernels import ops
    from repro_torch.serving.api import ServeRequest
    engine.reset_counters()
    ops.reset_launches()
    t0 = time.perf_counter()
    rids = [engine.submit_request(ServeRequest(p, max_new_tokens=MAX_NEW))
            for p in prompts]
    engine.run_iteration()
    before, iters = dict(ops.LAUNCHES), engine.metrics["iterations"]
    split0 = split_count(ops)
    engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = max(engine.metrics["iterations"] - iters, 1)
    tokens = [engine.result(r).tokens for r in rids]
    vocab = engine.cfg.vocab_size
    for r, t in zip(rids, tokens):
        if len(t) != MAX_NEW or not all(0 <= x < vocab for x in t):
            raise AssertionError(f"request {r}: bad tokens {t}")
    m = dict(engine.metrics)
    return {"tokens": tokens, "wall_s": wall,
            "launches": dict(ops.LAUNCHES),
            "group_launches": {f"{k}@G={g}": v for (k, g), v
                               in sorted(ops.GROUP_LAUNCHES.items())},
            "body_launches": body_launches(ops.BODY_LAUNCHES),
            "split_launches": split_count(ops),
            "split_body_launches": body_launches(ops.SPLIT_LAUNCHES),
            "folded_body_launches": body_launches(ops.FOLDED_LAUNCHES),
            "launches_per_decode_iter": {
                k: (ops.LAUNCHES[k] - before[k]) / n for k in before},
            "split_launches_per_decode_iter":
            (split_count(ops) - split0) / n,
            "iterations": m["iterations"],
            "decode_ms_per_iter": m["decode_s"] / max(m["iterations"], 1)
            * 1e3,
            "tokens_per_s": engine.throughput_tokens_per_s(),
            "prefill_ms_per_request": m["prefill_s"] / len(prompts) * 1e3,
            "transfer_s": m["transfer_s"], "stage_s": m["stage_s"],
            "summary": engine.summary()}


def body_launches(counter) -> dict:
    """``cuda_lib.BODY_LAUNCHES`` (or ``SPLIT_LAUNCHES``,
    ``FOLDED_LAUNCHES``) as {"wrapper/body": n}."""
    return {f"{k}/{b}": v for (k, b), v in sorted(counter.items())}


def split_count(ops) -> int:
    """The matmul launches booked so far whose plan split K: each ran its
    splits folded (``FOLDED_LAUNCHES``) or reduced their partials in its
    own epilogue."""
    return sum(ops.SPLIT_LAUNCHES.values())


def require_split_launches(n: int, what: str) -> None:
    """A path that split K booked its launches, and no stand-alone
    reduction kernel is counted anywhere."""
    from repro_torch.kernels import ops
    if "splitk_reduce" in ops.LAUNCHES:
        raise AssertionError(f"{what}: a stand-alone splitk_reduce is still "
                             "counted")
    if n <= 0:
        raise AssertionError(f"{what}: no launch split K (the split-K "
                             "epilogue never ran): "
                             f"{dict(ops.SPLIT_LAUNCHES)}")


def require_launches(launches, what: str, names=MAIN_KERNELS):
    missing = [k for k in names if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{what}: kernels {missing} never launched: "
                             f"{launches}")


def log_pass(what: str, card: str, r) -> None:
    log(f"  {what} on {card}: {r['wall_s']:.3f} s, "
        f"{r['tokens_per_s']:.2f} tok/s over decode, "
        f"{r['decode_ms_per_iter']:.3f} ms per iteration "
        f"({r['iterations']} iterations), prefill "
        f"{r['prefill_ms_per_request']:.3f} ms per request, expert transfer "
        f"{r['transfer_s']:.3f} s, staging {r['stage_s']:.3f} s; launches "
        f"{r['launches']} ({sum(r['launches'].values())} in all), per "
        f"decode iteration {r['launches_per_decode_iter']} "
        f"({sum(r['launches_per_decode_iter'].values()):g} in all); split K "
        f"{r['split_launches']} ({r['split_launches_per_decode_iter']:g} "
        f"per decode iteration, each reduced in its epilogue)")
    log(f"    {r['summary']}")


def phase_serve(torch, np, seed: int, card: str, profile: bool = False):
    """The main path: the default ``EngineConfig`` (paged KV), cold pass
    and warm rerun. Returns the record, the bank layout and the state the
    later serve phases share (params, prompts, point, tokens)."""
    from repro_torch.models.model import init_params
    from repro_torch.serving.api import EngineConfig, build_engine
    cfg = serving_config()
    log(f"serve: {cfg.arch_id} d_model={cfg.d_model} heads="
        f"{cfg.attention.num_heads}/{cfg.attention.num_kv_heads}x"
        f"{cfg.attention.head_dim} experts={cfg.moe.num_experts} top"
        f"{cfg.moe.top_k} d_ff_expert={cfg.moe.d_ff_expert} vocab="
        f"{cfg.vocab_size}->{cfg.padded_vocab}; reduced: num_layers 32 -> "
        f"{cfg.num_layers}")
    t0 = time.perf_counter()
    params = init_params(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"  init_params: {n_bytes / 1e9:.2f} GB of bf16 master weights on "
        f"the card in {time.perf_counter() - t0:.2f} s (train-layout "
        "master copy stays on the card; _fetch_expert quantizes there)")
    engine = build_engine(cfg, params, EngineConfig(**SERVE_CFG),
                          device="cuda")
    if not engine.paged:
        raise AssertionError("the default EngineConfig is not paged")
    total = cfg.num_layers * cfg.moe.num_experts
    point = pick_point(engine.frontier, total)
    t0 = time.perf_counter()
    engine.apply_frontier_point(point)
    torch.cuda.synchronize()
    plan = engine.current_plan
    sizes = dict(zip(sorted(plan.ladder), plan.bank_sizes()))
    bank_bytes = sum(t.numel() * t.element_size() for t in
                     _leaves(engine._serve_params["layers"]["moe"]["banks"]))
    log(f"  default EngineConfig({SERVE_CFG}) -> paged KV, page_size "
        f"{engine.kv_meta.page_size}, {engine.kv_meta.num_pages} pages; "
        f"frontier point {point.summary()}; per-layer banks {sizes}; "
        f"{bank_bytes / 1e9:.2f} GB of banks built in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, size=16) for _ in range(4)]
    cold = serve_pass(torch, engine, prompts)
    require_launches(cold["launches"], "serve")
    require_split_launches(cold["split_launches"], "serve")
    log_pass("cold pass", card, cold)
    log(f"  tokens: {cold['tokens']}")
    # the same traffic again on the warm engine (host blobs and the swap
    # cache in place; the prompts repeat, so routing repeats)
    warm = serve_pass(torch, engine, prompts)
    if warm["tokens"] != cold["tokens"]:
        raise AssertionError("warm rerun gave other tokens")
    log_pass("warm rerun", card, warm)
    out = {"point": point.summary(),
           "bank_sizes": {str(k): v for k, v in sizes.items()},
           "cold": cold, "warm": warm}
    if profile:
        # one more warm pass under the profiler: device time by kernel,
        # set against the unprofiled pass's wall time
        with _profiler(torch) as prof:
            serve_pass(torch, engine, prompts)
        out["profile"] = _profile_report(prof, warm["wall_s"])
    ctx = {"cfg": cfg, "params": params, "engine": engine, "point": point,
           "prompts": prompts, "tokens": cold["tokens"]}
    return out, sizes, ctx


# --------------------------------------------------------------------------
# phase 3b-3d: the other serve paths (paged == slot, overlap, speculative)
# --------------------------------------------------------------------------

def phase_paged_slot(torch, np, ctx, card: str):
    """Paged KV against the slot cache on the same params and point: the
    model hooks give bit-equal prefill and first-decode logits, and a
    ``paged_kv=False`` engine serves the same greedy tokens."""
    from repro_torch.models.model import page_table
    from repro_torch.serving.api import EngineConfig, build_engine
    from repro_torch.serving.paged_kv import PageAllocator
    eng = ctx["engine"]
    m, p, window = eng.model, eng._serve_params, eng.window
    prompts = ctx["prompts"]
    b = len(prompts)
    cache = m.init_cache(b, eng.max_len, device="cuda")
    pool, meta = m.init_paged_cache(b, eng.max_len, device="cuda")
    alloc = PageAllocator(b, meta.chunks_per_slot, meta.num_pages,
                          meta.page_size)
    first = []
    for i, pr in enumerate(prompts):
        toks = torch.as_tensor(pr[None], device="cuda")
        pos = torch.arange(len(pr), device="cuda")[None]
        lg_s, cache = m.prefill_into_slot(p, cache, toks, pos, i,
                                          len(pr) - 1)
        alloc.ensure_prefix(i, len(pr))
        lg_p, pool = m.paged_prefill_into_slot(
            p, pool, page_table(alloc.table[i], "cuda"), toks, pos,
            len(pr) - 1, window=window)
        if not _bits_equal(torch, lg_s, lg_p):
            raise AssertionError(f"paged prefill logits differ (slot {i})")
        first.append(int(torch.argmax(lg_s[0])))
        alloc.ensure_index(i, len(pr) % window)
    toks = torch.tensor(first, device="cuda")[:, None]
    pos = torch.tensor([len(pr) for pr in prompts], device="cuda")
    lg_s, cache, ids_s = m.decode_step_routed(p, cache, toks, pos)
    lg_p, pool, ids_p = m.paged_decode_step_routed(
        p, pool, page_table(alloc.table, "cuda"), toks, pos, window=window)
    if not (_bits_equal(torch, lg_s, lg_p) and torch.equal(ids_s, ids_p)):
        raise AssertionError("paged first-decode logits or routes differ "
                             "from the slot cache's")
    del cache, pool
    slot = build_engine(ctx["cfg"], ctx["params"], EngineConfig(
        **SERVE_CFG, paged_kv=False), device="cuda")
    slot.apply_frontier_point(ctx["point"])
    r = serve_pass(torch, slot, prompts)
    slot.close()
    del slot
    torch.cuda.empty_cache()
    require_launches(r["launches"], "paged == slot")
    if r["tokens"] != ctx["tokens"]:
        raise AssertionError(f"slot-cache tokens {r['tokens']} != paged "
                             f"{ctx['tokens']}")
    log("paged == slot: prefill and first-decode logits bit-equal through "
        "the model hooks; the paged_kv=False engine serves the same greedy "
        "tokens")
    log_pass("slot-cache pass", card, r)
    return r


def _xfer_threads():
    import threading
    return [t.name for t in threading.enumerate()
            if t.name.startswith("expert-xfer") and t.is_alive()]


def phase_overlap(torch, np, ctx, card: str):
    """The async overlap pipeline (paged) on a point that keeps all three
    rungs and leaves at least half of the experts off the card, with a
    swap cache of two experts, so the LRU keeps streaming. Its greedy
    tokens equal the non-overlap engine's on the same point."""
    from repro_torch.core.precision_plan import HOST
    from repro_torch.serving.api import EngineConfig, build_engine
    cfg, prompts = ctx["cfg"], ctx["prompts"]
    total = cfg.num_layers * cfg.moe.num_experts
    probe = build_engine(cfg, ctx["params"], EngineConfig(
        **SERVE_CFG, overlap=True), device="cuda")
    cand = [pt for pt in probe.frontier.points
            if all(c > 0 for c in pt.counts_per_rung)
            and pt.resident_experts <= total // 2]
    probe.close()
    if not cand:
        raise RuntimeError("no frontier point with all three rungs and half "
                           "of the experts off the card")
    point = max(cand, key=lambda pt: pt.resident_experts)
    host_bits = set(point.plan.bits[point.plan.location == HOST].tolist())
    swap = 2 * max(cfg.expert_param_bytes(int(b)) for b in host_bits)
    engine = build_engine(cfg, ctx["params"], EngineConfig(
        **SERVE_CFG, overlap=True, swap_bytes=swap), device="cuda")
    engine.apply_frontier_point(point)
    log(f"overlap: point {point.summary()}, swap cache {swap / 1e9:.3f} GB "
        f"(two experts at the largest off-card rung), "
        f"{engine.expert_cache.__class__.__name__}")
    # the non-overlap engine on the same point gives the reference tokens
    plain = ctx["engine"]
    plain.apply_frontier_point(point)
    if not np.array_equal(plain.current_plan.bits,
                          engine.current_plan.bits):
        raise AssertionError("the two engines planned other rungs")
    want = serve_pass(torch, plain, prompts)
    log_pass("non-overlap pass on the same point", card, want)
    out = {"point": point.summary(), "swap_bytes": swap, "plain": want}
    for label in ("cold", "warm"):
        r = serve_pass(torch, engine, prompts)
        require_launches(r["launches"], f"overlap {label}")
        if r["tokens"] != want["tokens"]:
            raise AssertionError(f"overlap {label} tokens {r['tokens']} != "
                                 f"non-overlap {want['tokens']}")
        m = engine.metrics
        r.update({k: m[k] for k in (
            "transfer_s", "prefetch_s", "transfer_exposed_s",
            "transfer_overlapped_s", "expert_fetches", "expert_accesses")})
        r["measured_overlap_efficiency"] = \
            engine.measured_overlap_efficiency()
        if m["expert_fetches"] + engine.expert_cache.stats.prefetch_bytes \
                <= 0:
            raise AssertionError("the overlap pass streamed no expert")
        log_pass(f"overlap {label} pass", card, r)
        log(f"    transfer_s {m['transfer_s']:.4f} s, prefetch_s "
            f"{m['prefetch_s']:.4f} s, transfer_exposed_s "
            f"{m['transfer_exposed_s']:.4f} s, transfer_overlapped_s "
            f"{m['transfer_overlapped_s']:.4f} s, measured_overlap_"
            f"efficiency {r['measured_overlap_efficiency']}; fetches "
            f"{m['expert_fetches']} of {m['expert_accesses']} accesses")
        out[label] = r
    engine.close()
    alive = _xfer_threads()
    if alive:
        raise AssertionError(f"expert-xfer threads alive after close: "
                             f"{alive}")
    del engine
    torch.cuda.empty_cache()
    log("overlap: greedy tokens equal to the non-overlap engine's; no "
        "expert-xfer thread alive after close()")
    return out


def phase_spec(torch, np, ctx, card: str, seed: int):
    """Ladder-draft speculation (speculate=2, paged) on the default point
    and traffic: greedy tokens equal to plain decode's, the draft's int4
    bank of all 8 experts launched."""
    from repro_torch.serving.api import EngineConfig, build_engine
    cfg = ctx["cfg"]
    engine = build_engine(cfg, ctx["params"], EngineConfig(
        **SERVE_CFG, speculate=2), device="cuda")
    engine.apply_frontier_point(ctx["point"])
    out = {"row_probe": _spec_row_probe(torch, engine, seed)}
    _verify_equals_decode(torch, engine, ctx["prompts"])
    for label in ("cold", "warm"):
        r = serve_pass(torch, engine, ctx["prompts"])
        require_launches(r["launches"], f"speculative {label}")
        draft = r["group_launches"].get(f"grouped_q4@G={cfg.moe.num_experts}",
                                        0)
        if draft <= 0:
            raise AssertionError(f"the G={cfg.moe.num_experts} int4 draft "
                                 f"bank never launched: "
                                 f"{r['group_launches']}")
        m = engine.metrics
        r.update(acceptance_rate=m["acceptance_rate"],
                 spec_proposed=m["spec_proposed"],
                 spec_accepted=m["spec_accepted"])
        log_pass(f"speculative {label} pass", card, r)
        log(f"    acceptance {m['acceptance_rate']:.3f} "
            f"({m['spec_accepted']}/{m['spec_proposed']}); launches by bank "
            f"{r['group_launches']}")
        if r["tokens"] != ctx["tokens"]:
            raise AssertionError(f"speculative tokens {r['tokens']} != plain "
                                 f"{ctx['tokens']}")
        out[label] = r
    engine.close()
    del engine
    torch.cuda.empty_cache()
    log("speculative: greedy tokens equal to plain decode's")
    return out


#: 3p: long prompts whose MoE capacity passes 64 rows per expert. A
#: prompt's prefill runs at its power-of-two bucket t, capacity ceil(t *
#: top_k * 1.25 / E) rounded up to 4: bucket 512 -> C = 160 (the wide
#: body's one tile), bucket 256 -> C = 80 (the wgmma body), buckets 1024
#: and 2048 -> C = 320 and 640 (two and four wide tiles); decode stays at
#: the minimum capacity C = 4. max_len holds the longest prompt and its new
#: tokens, rounded up to the KV page (16).
PREFILL_PROMPTS = (512, 512, 200, 200, 1024, 2048)
PREFILL_NEW = 4
PREFILL_CFG = dict(SERVE_CFG, max_slots=2,
                   max_len=-(-(max(PREFILL_PROMPTS) + PREFILL_NEW) // 16)
                   * 16)
PREFILL_LOGIT_BAR = 2e-2      # of max |logit|: phase 7b's kernel-vs-plain rule


def _prefill_pass(torch, engine, prompts):
    """Serve ``prompts`` (``PREFILL_NEW`` tokens each) with the counters
    zeroed just before and read just after; each prefill is timed (card
    synchronized), its logits kept and its launches booked by body apart
    from the decode iterations'."""
    import collections
    import dataclasses
    from repro_torch.kernels import ops
    from repro_torch.serving.api import ServeRequest
    pre, pre_all = collections.Counter(), collections.Counter()
    pre_ms, logits, each, lens = [], [], [], []
    run_prefill = engine._prefill_slot
    model = engine.model
    hook = model.paged_prefill_into_slot

    def prefill(slot, req, temperature):
        before = collections.Counter(ops.BODY_LAUNCHES)
        launched = collections.Counter(ops.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rid = run_prefill(slot, req, temperature)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
        each.append(collections.Counter(ops.BODY_LAUNCHES) - before)
        lens.append(len(req.prompt))
        pre.update(each[-1])
        pre_all.update(collections.Counter(ops.LAUNCHES) - launched)
        return rid

    def paged_prefill(*a, **kw):
        lg, pool = hook(*a, **kw)
        logits.append(lg.float().clone())
        return lg, pool

    engine._prefill_slot = prefill
    engine.model = dataclasses.replace(model,
                                       paged_prefill_into_slot=paged_prefill)
    try:
        engine.reset_counters()
        ops.reset_launches()
        t0 = time.perf_counter()
        rids = [engine.submit_request(ServeRequest(p, max_new_tokens=
                                                   PREFILL_NEW))
                for p in prompts]
        engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del engine._prefill_slot
        engine.model = model
    tokens = [engine.result(r).tokens for r in rids]
    for r, t in zip(rids, tokens):
        if len(t) != PREFILL_NEW:
            raise AssertionError(f"request {r}: bad tokens {t}")
    iters = max(engine.metrics["iterations"], 1)
    dec = collections.Counter(ops.BODY_LAUNCHES) - pre
    dec_launches = {k: v - pre_all[k] for k, v in ops.LAUNCHES.items()}
    return {"tokens": tokens, "wall_s": wall, "prefill_ms": pre_ms,
            "logits": logits, "launches": dict(ops.LAUNCHES),
            "body_launches": body_launches(ops.BODY_LAUNCHES),
            "prefill_body_launches": body_launches(pre),
            "each_prefill_body_launches": [body_launches(c) for c in each],
            "each_prefill_prompt_len": lens,
            "decode_body_launches": body_launches(dec),
            "folded_body_launches": body_launches(ops.FOLDED_LAUNCHES),
            "launches_per_decode_iter": {k: v / iters
                                         for k, v in dec_launches.items()},
            "iterations": engine.metrics["iterations"],
            "decode_ms_per_iter": engine.metrics["decode_s"] / iters * 1e3}


def _rounded(by_len: dict) -> dict:
    return {n: [round(v, 3) for v in ms] for n, ms in sorted(by_len.items())}


def phase_prefill(torch, np, ctx, card: str, seed: int):
    """3p: prompts of 512, 200, 1024 and 2048 tokens on the serve phase's
    params and point (``max_slots=2``, ``max_len`` holding the longest,
    kernels on): each prefill launches, on every bank, the body that
    ``launch_plan`` names for its capacity C (512 tokens: C = 160, the
    wide wgmma body's one tile; 200: C = 80, the 128-token wgmma body;
    1024 and 2048: C = 320 and 640, two and four wide tiles) and no other
    body, and no decode iteration a wgmma body (C = 4, the mma.sync body);
    prefill ms per request, cold and warm, and warm per prompt
    length; then a
    ``use_kernel=False`` engine at the same plan: each prefill's logits
    within 2e-2 of max |logit| of the kernel engine's (phase 7b's rule),
    greedy tokens equal or the first divergence reported with its logit
    margins."""
    from repro_torch.kernels.q4_matmul import launch_plan
    from repro_torch.serving.api import EngineConfig, build_engine
    cfg = ctx["cfg"]
    rng = np.random.default_rng(seed + 7)
    prompts = [rng.integers(1, cfg.vocab_size, size=n)
               for n in PREFILL_PROMPTS]
    moe = cfg.moe
    caps = {}
    for n in sorted(set(PREFILL_PROMPTS)):
        t = 8
        while t < n:
            t *= 2
        cap = math.ceil(t * moe.top_k * moe.capacity_factor
                        / moe.num_experts)
        caps[n] = (t, -(-cap // 4) * 4)
    # the body of each prompt's banks: the plan is free of G and bits
    bodies = {n: launch_plan(c, D_MODEL, D_FF, 16).body
              for n, (_, c) in caps.items()}
    log(f"prefill: prompts {list(PREFILL_PROMPTS)} tokens -> (bucket, "
        f"capacity C) {caps}; EngineConfig({PREFILL_CFG}) at the serve "
        f"point; {PREFILL_NEW} new tokens each")
    out, runs = {}, {}
    for name, uk in (("kernel", True), ("plain", False)):
        eng = build_engine(cfg, ctx["params"], EngineConfig(
            **dict(PREFILL_CFG, use_kernel=uk)), device="cuda")
        eng.apply_frontier_point(ctx["point"])
        passes = ("cold", "warm") if uk else ("plain",)
        for label in passes:
            r = _prefill_pass(torch, eng, prompts)
            pre, dec = r["prefill_body_launches"], r["decode_body_launches"]
            r["prefill_ms_by_len"] = {}
            for n, ms in zip(r["each_prefill_prompt_len"], r["prefill_ms"]):
                r["prefill_ms_by_len"].setdefault(n, []).append(ms)
            log(f"  {label} pass on {card}: prefill ms per request "
                f"{[round(v, 3) for v in r['prefill_ms']]} (by prompt "
                f"length {_rounded(r['prefill_ms_by_len'])}), "
                f"{r['decode_ms_per_iter']:.3f} ms per decode iteration "
                f"({r['iterations']} iterations); launches by body: "
                f"prefills {pre}, decode {dec}; folded (a tile's K splits "
                f"in one block) {r['folded_body_launches']}")
            if uk:
                for i, (one, n) in enumerate(zip(
                        r["each_prefill_body_launches"],
                        r["each_prefill_prompt_len"])):
                    # the body that the bank's capacity C names, and no
                    # other body
                    body = bodies[n]
                    missing = [k for k in MAIN_KERNELS
                               if one.get(f"{k}/{body}", 0) <= 0]
                    if missing:
                        raise AssertionError(f"{label}: prefill {i} ({n} "
                                             f"tokens) never launched the "
                                             f"{body} body of {missing}: "
                                             f"{one}")
                    if any(not b.endswith(f"/{body}") and v
                           for b, v in one.items()):
                        raise AssertionError(f"{label}: prefill {i} ({n} "
                                             f"tokens) launched another "
                                             f"body than {body}: {one}")
                for k in MAIN_KERNELS:
                    if dec.get(f"{k}/mma_sync", 0) <= 0:
                        raise AssertionError(f"{label}: {k} never launched "
                                             f"on a decode iteration: {dec}")
                if any(b.endswith("/mma_sync") and v for b, v in pre.items()):
                    raise AssertionError(f"{label}: a prefill launched the "
                                         f"mma.sync body: {pre}")
                if any(b.endswith(("/wgmma", "/wgmma_wide")) and v
                       for b, v in dec.items()):
                    raise AssertionError(f"{label}: a decode iteration "
                                         f"launched a wgmma body: {dec}")
            elif sum(r["launches"].values()):
                raise AssertionError("the use_kernel=False engine launched "
                                     f"kernels: {r['launches']}")
            runs[label] = r
        if uk:
            if runs["warm"]["tokens"] != runs["cold"]["tokens"]:
                raise AssertionError("warm rerun gave other tokens")
            eng.close()
            del eng
            torch.cuda.empty_cache()
    worst = 0.0
    for a, b in zip(runs["warm"]["logits"], runs["plain"]["logits"]):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError("non-finite kernel-engine prefill logits")
        worst = max(worst, float((a - b).abs().max() / b.abs().max()))
    if worst > PREFILL_LOGIT_BAR:
        raise AssertionError(f"kernel vs plain prefill logits differ by "
                             f"{worst:.3e} of max |logit| (bar "
                             f"{PREFILL_LOGIT_BAR})")
    from repro_torch.models.model import build_model
    div = _first_divergence(
        torch, np, [(build_model(cfg, use_kernel=True), eng._serve_params),
                    (eng.model, eng._serve_params)],
        prompts, [runs["warm"]["tokens"], runs["plain"]["tokens"]])
    eng.close()
    del eng
    torch.cuda.empty_cache()
    log(f"  kernel vs plain engine: prefill logits within {worst:.3e} of "
        f"max |logit| (bar {PREFILL_LOGIT_BAR}); greedy tokens "
        + ("equal" if div is None else f"first differ at {div}"))
    for label, r in runs.items():
        r.pop("logits")
        out[label] = r
    out.update(capacities={str(k): v for k, v in caps.items()},
               logit_rel_diff=worst, first_divergence=div)
    return out


def _verify_equals_decode(torch, engine, prompts):
    """The verify forward's logits at each of its K+1 positions are
    bit-equal to plain decode's at that position, through the model
    hooks: prefill the prompts, decode K+1 greedy steps, and score the
    same K+1 tokens with one speculative step on a copy of the prefilled
    cache (DESIGN.md §17.1)."""
    m, p = engine.model, engine._serve_params
    s = engine.speculate_k + 1
    cache = m.init_cache(len(prompts), engine.max_len, device="cuda")
    tok = []
    for i, pr in enumerate(prompts):
        lg, cache = m.prefill_into_slot(
            p, cache, torch.as_tensor(pr[None], device="cuda"),
            torch.arange(len(pr), device="cuda")[None], i, len(pr) - 1)
        tok.append(int(torch.argmax(lg[0])))
    spec_cache = {k: v.clone() for k, v in cache.items()}
    pos0 = torch.tensor([len(pr) for pr in prompts], device="cuda")
    fed, plain = [torch.tensor(tok, device="cuda")], []
    for j in range(s):
        lg, cache, _ = m.decode_step_routed(p, cache, fed[-1][:, None],
                                            pos0 + j)
        plain.append(lg)
        fed.append(torch.argmax(lg, dim=-1))
    toks = torch.stack(fed[:s], dim=1)
    pos = pos0[:, None] + torch.arange(s, device="cuda")[None]
    lg, _, _ = m.spec_step_routed(p, spec_cache, toks, pos)
    for j in range(s):
        if not _bits_equal(torch, lg[:, j].contiguous(), plain[j]):
            raise AssertionError(f"verify logits at column {j} differ from "
                                 "plain decode's")
    log(f"  verify forward: logits at all {s} columns bit-equal to plain "
        "decode's at the same positions")


def _spec_row_probe(torch, engine, seed: int):
    """Row invariance of each op of the verify forward on the card: column
    0 of a (B, K+1) input against the same rows alone, (B, 1), as plain
    decode runs them. Layer 0 of the serving params; reported, not
    asserted (the token check above is the contract)."""
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import _ffn_or_moe, layer_slice
    cfg, p = engine.cfg, engine._serve_params
    lp = layer_slice(p["layers"], 0)
    b, s = engine.max_slots, engine.speculate_k + 1
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = engine.window
    a = cfg.attention
    ring = {"k": torch.randn((b, w, a.num_kv_heads, a.head_dim),
                             generator=gen, device="cuda").to(torch.bfloat16),
            "pos": torch.full((b, w), -1, dtype=torch.int32, device="cuda")}
    ring["v"] = torch.randn_like(ring["k"].float()).to(torch.bfloat16)
    ring["pos"][:, :16] = torch.arange(16, device="cuda", dtype=torch.int32)
    qpos = 16 + torch.arange(s, device="cuda")[None].expand(b, s)

    def attn(t):
        c = {k: v.clone() for k, v in ring.items()}
        return L.attention(lp["attn"], t, a, positions=qpos[:, :t.shape[1]],
                           cache=c, spec=True)[0]

    def moe(t):
        valid = torch.ones(t.shape[:2], dtype=torch.bool, device="cuda")
        cap = t.shape[0] * t.shape[1] if t.shape[1] > 1 else None
        return _ffn_or_moe(lp, t, cfg, True, token_valid=valid,
                           moe_capacity=cap)[0]

    probes = {
        "rms_norm": lambda t: L.rms_norm(t, lp["attn_norm"]["scale"]),
        "wq": lambda t: t @ lp["attn"]["wq"],
        "wk": lambda t: t @ lp["attn"]["wk"],
        "wo": lambda t: t @ lp["attn"]["wo"],
        "attention": attn,
        "moe (kernels)": moe,
        "unembed": lambda t: L.unembed(p["lm_head"]["table"], t),
    }
    out = {}
    x1 = x[:, :1].contiguous()
    for name, f in probes.items():
        full = f(x)[:, 0]
        col = f(x1)[:, 0]
        equal = _bits_equal(torch, full, col) if full.dtype != torch.float32 \
            else bool(torch.equal(full, col))
        out[name] = {"bit_equal": equal, "max_abs_diff": float(
            (full.float() - col.float()).abs().max())}
    log(f"  verify-row probe (column 0 of B x {s} against B x 1): {out}")
    return out


# --------------------------------------------------------------------------
# phase 3e-3h: the adaptive control loop (QoS walk, budget drop, dynamic
# precision, calibration, multi-tenant arbitration, the serve CLI)
# --------------------------------------------------------------------------

#: controller traffic of phase 3e: requests x new tokens, drop after this
#: many engine iterations (drain iterations of bank-split replans count)
QOS_REQUESTS, QOS_NEW, QOS_DROP_AT = 8, 24, 12


def _peak_reset(torch):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def _mem_gb(torch):
    """(allocated, peak allocated) GB on the card since the last reset."""
    torch.cuda.synchronize()
    return (torch.cuda.memory_allocated() / 1e9,
            torch.cuda.max_memory_allocated() / 1e9)


def _release(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _bank_keys(plan):
    """The (wrapper, G) launch keys a plan's serve banks give: one per
    non-empty rung bank, G its expert count per layer."""
    names = {4: "grouped_q4", 8: "grouped_q8", 16: "grouped_bf16"}
    return [(names[b], g) for b, g in zip(sorted(plan.ladder),
                                          plan.bank_sizes()) if g]


def _plan_kind(old, new) -> str:
    if old is None:
        return "first"
    same = (old.bank_sizes() == new.bank_sizes() and old.seed == new.seed)
    return "placement-only" if same else "bank-split"


class _Tracker:
    """Wraps one engine's ``run_iteration`` and ``apply_frontier_point``:
    each iteration's grouped launches are booked under the plan it ran on
    (a bank-split replan's drain iterations run on the OLD plan, inside
    the apply, and are booked to it), and each replan records its kind,
    ``reconfig_s``, ``drain_s`` and the card's peak memory during it."""

    def __init__(self, torch, engine):
        from repro_torch.kernels import ops
        self.torch, self.engine, self.ops = torch, engine, ops
        self.plans = []          # [(plan, Counter of (wrapper, G))]
        self.replans = []
        self._iterate = engine.run_iteration
        self._apply = engine.apply_frontier_point
        engine.run_iteration = self.run_iteration
        engine.apply_frontier_point = self.apply_frontier_point

    def run_iteration(self, **kw):
        import collections
        before = collections.Counter(self.ops.GROUP_LAUNCHES)
        out = self._iterate(**kw)
        delta = collections.Counter(self.ops.GROUP_LAUNCHES)
        delta.subtract(before)
        if self.plans:
            self.plans[-1][1].update(+delta)
        return out

    def apply_frontier_point(self, point):
        import collections
        eng, m = self.engine, self.engine.metrics
        old = eng.current_plan
        r0, d0, it0 = m["reconfig_s"], m["drain_s"], m["iterations"]
        alloc0, _ = _mem_gb(self.torch)
        _peak_reset(self.torch)
        t0 = time.perf_counter()
        out = self._apply(point)
        wall = time.perf_counter() - t0
        alloc1, peak = _mem_gb(self.torch)
        rec = {"kind": _plan_kind(old, eng.current_plan),
               "point": point.summary(),
               "bank_sizes": list(eng.current_plan.bank_sizes()),
               "reconfig_s": m["reconfig_s"] - r0,
               "drain_s": m["drain_s"] - d0,
               "drain_iterations": m["iterations"] - it0,
               "wall_s": wall, "alloc_before_gb": alloc0,
               "alloc_after_gb": alloc1, "peak_gb": peak}
        self.replans.append(rec)
        self.plans.append((eng.current_plan, collections.Counter()))
        log(f"    replan {len(self.replans)}: {rec['kind']} -> "
            f"{rec['point']} banks {rec['bank_sizes']}; reconfig_s "
            f"{rec['reconfig_s']:.3f}, drain_s {rec['drain_s']:.3f} "
            f"({rec['drain_iterations']} drain iterations), peak "
            f"{peak:.2f} GB (allocated {alloc0:.2f} -> {alloc1:.2f} GB)")
        return out

    def unwrap(self):
        del self.engine.run_iteration, self.engine.apply_frontier_point

    def require_bank_launches(self):
        """Every bank-split plan launched B3/B4 at its new G per rung
        while it served."""
        for (plan, launches), rec in zip(self.plans, self.replans):
            if rec["kind"] == "placement-only":
                continue
            missing = [k for k in _bank_keys(plan) if launches[k] <= 0]
            if missing:
                raise AssertionError(
                    f"plan {rec['point']} ({rec['kind']}): no launch of "
                    f"{missing} while it served: {dict(launches)}")


def _swap_pair(plan, layer: int = 0):
    """(e_lo, e_hi): an int4 and an int8 expert at the same placement in
    ``layer`` (None when the layer has no such pair)."""
    bits, loc = plan.bits[layer], plan.location[layer]
    for e_lo in range(bits.size):
        for e_hi in range(bits.size):
            if bits[e_lo] == 4 and bits[e_hi] == 8 \
                    and loc[e_lo] == loc[e_hi]:
                return e_lo, e_hi
    return None


def _params_equal(torch, a, b) -> bool:
    la, lb = list(_leaves(a)), list(_leaves(b))
    return len(la) == len(lb) and all(
        _bits_equal(torch, x, y) for x, y in zip(la, lb))


def _hook_logits(torch, engine, prompts):
    """Prefill logits of each prompt and the first decode step's logits
    through the slot-cache model hooks on the engine's serving params."""
    m, p = engine.model, engine._serve_params
    cache = m.init_cache(len(prompts), engine.max_len, device="cuda")
    out, first = [], []
    for i, pr in enumerate(prompts):
        lg, cache = m.prefill_into_slot(
            p, cache, torch.as_tensor(pr[None], device="cuda"),
            torch.arange(len(pr), device="cuda")[None], i, len(pr) - 1)
        out.append(lg)
        first.append(int(torch.argmax(lg[0])))
    lg, _, _ = m.decode_step_routed(
        p, cache, torch.tensor(first, device="cuda")[:, None],
        torch.tensor([len(pr) for pr in prompts], device="cuda"))
    out.append(lg)
    return out


def _same_as_fresh(torch, engine, point, cfg, params, prompts, what):
    """A fresh engine at the adapted engine's final (point, bits): its
    serving params are bit-equal, the prefill and first-decode logits
    through the model hooks bit-equal, and the greedy tokens equal."""
    from repro_torch.serving.api import EngineConfig, build_engine
    fresh = build_engine(cfg, params, EngineConfig(**SERVE_CFG),
                         device="cuda")
    fresh.apply_frontier_point(point)
    bits = engine.current_plan.bits
    if (fresh.current_plan.bits != bits).any():
        fresh.apply_bits_update(bits.copy())
    if not np_equal(fresh.current_plan.bits, bits):
        raise AssertionError(f"{what}: the fresh engine planned other bits")
    if not _params_equal(torch, fresh._serve_params, engine._serve_params):
        raise AssertionError(f"{what}: serving params differ from a fresh "
                             "engine's at the same (point, bits)")
    for j, (a, b) in enumerate(zip(_hook_logits(torch, engine, prompts),
                                   _hook_logits(torch, fresh, prompts))):
        if not bool(torch.equal(a, b)):
            raise AssertionError(f"{what}: logits {j} differ from a fresh "
                                 "engine's")
    got = serve_pass(torch, engine, prompts)
    want = serve_pass(torch, fresh, prompts)
    fresh.close()
    del fresh
    _release(torch)
    if got["tokens"] != want["tokens"]:
        raise AssertionError(f"{what}: tokens {got['tokens']} != fresh "
                             f"engine's {want['tokens']}")
    log(f"  {what}: serving params, prefill and first-decode logits "
        "bit-equal to a fresh engine at the final (point, bits); greedy "
        "tokens equal")
    return got


def np_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def phase_calibrate(torch, np, ctx):
    """3f: ``calibrate_sensitivity`` on the full-width model, twice with
    one seed: byte-identical ``to_json_bytes()``. Per-rung quantize runs
    on the card, so one expert's codes and scales are first checked
    bit-equal to the CPU's."""
    from repro_torch.core.quantization import quantize
    from repro_torch.core.sensitivity import calibrate_sensitivity
    cfg, params = ctx["cfg"], ctx["params"]
    ladder = SERVE_CFG["ladder"]
    moe = params["layers"]["moe"]
    for k in ("w_gate", "w_up", "w_down"):
        w = moe[k][0, 0].to(torch.float32)
        for b in (4, 8):
            dev, cpu = quantize(w, b, cfg.mop.group_size), \
                quantize(w.cpu(), b, cfg.mop.group_size)
            if not (torch.equal(dev.q.cpu(), cpu.q) and torch.equal(
                    dev.scales.cpu().view(torch.int16),
                    cpu.scales.view(torch.int16))):
                raise AssertionError(f"card quantize of layer 0 expert 0 "
                                     f"{k} at {b} bits differs from the "
                                     "CPU's")
    log("calibrate: card quantize of layer 0 expert 0 (w_gate, w_up, "
        "w_down at 4 and 8 bits) bit-equal to the CPU's")
    # what quantize guards against: on the card, a division by a Python
    # scalar multiplies by its reciprocal (reported, not asserted)
    w = moe["w_gate"][0, 0].to(torch.float32)
    wg = w.reshape(-1, cfg.mop.group_size, w.shape[-1])
    absmax = wg.abs().amax(1)
    for qmax in (7.0, 127.0):
        by_scalar = absmax / qmax
        true_div = absmax / torch.tensor(qmax, device=absmax.device)

        def codes(sc):
            inv = torch.where(sc > 0, 1.0 / sc, torch.zeros_like(sc))
            return torch.clamp(torch.round(wg * inv[:, None]), -qmax - 1,
                               qmax)

        n_f32 = int((by_scalar != true_div).sum())
        n_bf16 = int((by_scalar.bfloat16() != true_div.bfloat16()).sum())
        n_codes = int((codes(by_scalar) != codes(true_div)).sum())
        log(f"  absmax / {qmax:g} on the card, layer 0 expert 0 w_gate, a "
            "Python-scalar divisor against a tensor divisor: "
            f"{n_f32} of {absmax.numel()} f32 scales, {n_bf16} bf16 scales "
            f"and {n_codes} of {wg.numel()} codes differ")
    runs, secs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        runs.append(calibrate_sensitivity(cfg, params, seed=0,
                                          ladder=ladder))
        secs.append(time.perf_counter() - t0)
    a, b = (r.to_json_bytes() for r in runs)
    if a != b:
        raise AssertionError("two calibrations with one seed gave other "
                             "bytes")
    prof = runs[0]
    if not all(np.isfinite(s).all() for s in prof.sens.values()):
        raise AssertionError("calibrated sensitivities are not finite")
    log(f"calibrate: {cfg.num_layers}x{cfg.moe.num_experts} experts, rungs "
        f"{sorted(prof.sens)}, seed 0, 2x32 tokens: {secs[0]:.2f} s and "
        f"{secs[1]:.2f} s; profiles byte-identical ({len(a)} bytes); mean "
        + ", ".join(f"sens[{b}] {prof.sens[b].mean():.4f}"
                    for b in sorted(prof.sens)))
    ctx["profile"] = prof
    return {"seconds": secs, "bytes": len(a),
            "sens_mean": {str(b): float(s.mean())
                          for b, s in prof.sens.items()}}


def phase_qos_dynamic(torch, np, ctx, card: str, seed: int):
    """3e: a QoSController (window 2, dwell 4) with a DynamicPrecision
    controller on the calibrated profile drives one default engine:
    a best-effort target adopted at the serve phase's point walks toward
    the fast end, then the budget drops to the midpoint between the
    frontier's smallest footprint and the active point's, and the engine
    replans exactly once. Just before the drop one direct
    ``apply_bits_update`` swaps an int4 and an int8 expert of layer 0 at
    the same placement (the banks then equal a fresh build), so the drop
    replans from a swapped plan; at the end the adapted engine is
    bit-equal to a fresh engine at its final (point, bits)."""
    import math
    from repro_torch.core.dynamic_precision import DynamicPrecisionController
    from repro_torch.core.pareto import QoSTarget
    from repro_torch.kernels import ops
    from repro_torch.models.model import apply_precision_plan
    from repro_torch.serving.api import EngineConfig, ServeRequest, \
        build_engine
    from repro_torch.serving.qos import QoSController, QoSControllerConfig
    from repro_torch.serving.simulator import budget_shock
    cfg, params = ctx["cfg"], ctx["params"]
    engine = build_engine(cfg, params, EngineConfig(**SERVE_CFG),
                          device="cuda")
    fr = engine.frontier
    start = fr.points[ctx["engine"].frontier.points.index(ctx["point"])]
    if start.summary() != ctx["point"].summary():
        raise AssertionError("the engine's frontier differs from the serve "
                             "phase's")
    dyn = DynamicPrecisionController(engine, ctx["profile"])
    ctl = QoSController(engine, config=QoSControllerConfig(
        window_iterations=2, min_dwell_iterations=4), dynamic=dyn)
    track = _Tracker(torch, engine)
    target = QoSTarget(min_tokens_per_s=math.inf, mem_budget_bytes=max(
        p.qos.device_bytes for p in fr.points))
    _peak_reset(torch)
    log(f"qos+dynamic: adopt [{target.describe()}] at {start.summary()}")
    ctl.adopt(target, start)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(1, cfg.vocab_size, size=16)
               for _ in range(QOS_REQUESTS)]
    engine.reset_counters()
    ops.reset_launches()
    rids = [engine.submit_request(ServeRequest(p, max_new_tokens=QOS_NEW))
            for p in prompts]
    shock = {}
    t0 = time.perf_counter()
    while engine.has_work():
        if not shock and engine.metrics["iterations"] >= QOS_DROP_AT:
            shock.update(_bits_update_then_drop(
                torch, np, engine, ctl, params, cfg, apply_precision_plan,
                budget_shock))
        engine.run_iteration()
        ctl.step()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    iters = engine.metrics["iterations"]
    tokens = [engine.result(r).tokens for r in rids]
    if not shock:
        raise AssertionError("the traffic ended before the budget drop")
    if any(len(t) != QOS_NEW for t in tokens):
        raise AssertionError(f"bad token counts {[len(t) for t in tokens]}")
    walks = shock["replans_before"] - 1
    if walks < 1:
        raise AssertionError("no walk step before the budget drop")
    after = ctl.metrics["replans"] - shock["replans_before"]
    if after != 1:
        raise AssertionError(f"the budget drop cost {after} replans, not 1")
    if ctl.point.qos.device_bytes > shock["budget"]:
        raise AssertionError("the final plan is over the dropped budget")
    if not np_equal(engine.current_plan.location, ctl.point.plan.location):
        raise AssertionError("the engine's placement is not the "
                             "controller's point")
    _, peak = _mem_gb(torch)
    log(f"  {QOS_REQUESTS} requests x {QOS_NEW} tokens in {wall:.2f} s "
        f"({iters} iterations); controller {ctl.summary()}; "
        f"{walks} walk step(s) before the drop, 1 replan for it; dynamic "
        f"{dyn.metrics}; launches {launches}; peak over the run "
        f"{peak:.2f} GB")
    require_launches(launches, "qos+dynamic")
    final = _same_as_fresh(torch, engine, ctl.point, cfg, params,
                           ctx["prompts"], "qos+dynamic")
    track.require_bank_launches()
    track.unwrap()
    engine.close()
    del engine
    _release(torch)
    restage = _bits_update_restage(torch, np, ctx)
    return {"restage": restage, "launches": launches,
            "launches_per_decode_iter": {k: v / max(iters, 1)
                                         for k, v in launches.items()},
            "replans": track.replans,
            "bank_launches": [{f"{k}@G={g}": v for (k, g), v in c.items()}
                              for _, c in track.plans],
            "walk_steps": walks, "drop": shock,
            "controller": dict(ctl.metrics), "dynamic": dict(dyn.metrics),
            "wall_s": wall, "iterations": iters, "peak_gb": peak,
            "final_tokens": final["tokens"]}


def _bits_update_then_drop(torch, np, engine, ctl, params, cfg,
                           apply_precision_plan, budget_shock):
    """Between iterations, with requests in flight: one direct
    ``apply_bits_update`` (an int4 <-> int8 swap at one placement in
    layer 0; its serve banks must equal a fresh build of the swapped
    plan), then the budget drop."""
    plan = engine.current_plan
    pair = _swap_pair(plan)
    if pair is None:
        raise AssertionError(f"layer 0 of {plan.bank_sizes()} has no int4 "
                             "and int8 expert at one placement")
    e_lo, e_hi = pair
    bits = plan.bits.copy()
    bits[0, e_lo], bits[0, e_hi] = plan.bits[0, e_hi], plan.bits[0, e_lo]
    r0 = engine.metrics["reconfig_s"]
    _peak_reset(torch)
    report = engine.apply_bits_update(bits)
    secs = engine.metrics["reconfig_s"] - r0
    _, peak = _mem_gb(torch)
    if report["flipped"] != 2 or report["promotions"] != 1:
        raise AssertionError(f"bits update report {report}")
    rebuilt = apply_precision_plan(params, cfg, engine.current_plan)
    if not _params_equal(torch, rebuilt, engine._serve_params):
        raise AssertionError("banks after apply_bits_update differ from a "
                             "fresh build of the swapped plan")
    del rebuilt
    _release(torch)
    log(f"    apply_bits_update: layer 0 experts {e_lo} (int4) <-> {e_hi} "
        f"(int8) at {'device' if plan.location[0, e_lo] else 'host'}; "
        f"report {report}; {secs:.3f} s, peak {peak:.2f} GB; banks equal "
        "a fresh build of the swapped plan")
    smallest = min(p.qos.device_bytes for p in engine.frontier.points)
    budget = 0.5 * (smallest + ctl.point.qos.device_bytes)
    replans = ctl.metrics["replans"]
    log(f"    budget drop at iteration {engine.metrics['iterations']}: "
        f"{ctl.target.mem_budget_bytes / 1e9:.3f} -> {budget / 1e9:.3f} GB "
        f"(active point {ctl.point.qos.device_bytes / 1e9:.3f} GB, "
        f"smallest {smallest / 1e9:.3f} GB)")
    budget_shock(ctl, budget)()
    return {"budget": budget, "replans_before": replans,
            "bits_update": report, "bits_update_s": secs,
            "bits_update_peak_gb": peak}


def _host_pairs(plan):
    """Every (layer, int4 expert, int8 expert) with both experts off the
    card, layer 0 first."""
    from repro_torch.core.precision_plan import HOST
    host = plan.location == HOST
    return [(li, e_lo, e_hi) for li in range(plan.bits.shape[0])
            for e_lo in range(plan.bits.shape[1])
            for e_hi in range(plan.bits.shape[1])
            if host[li, e_lo] and host[li, e_hi]
            and plan.bits[li, e_lo] == 4 and plan.bits[li, e_hi] == 8]


def _bits_update_restage(torch, np, ctx):
    """``apply_bits_update`` on an overlap engine (async swap cache, copies
    on side streams) with requests in flight: an int4 and an int8 expert
    of one layer, both off the card, swap rungs while exactly one of them
    is in the swap cache and a prefetch of another expert is enqueued.
    The update drains the copies, re-stages the cached one at its new
    rung through ``ExpertCache.update()`` (restaged 1, a cache byte delta
    of +-(int8 - int4 expert bytes)); the engine then finishes its
    requests on the kernels and is bit-equal to a fresh engine at its
    (point, bits); no ``expert-xfer`` thread outlives ``close()``."""
    from repro_torch.core.precision_plan import HOST
    from repro_torch.kernels import ops
    from repro_torch.serving.api import EngineConfig, ServeRequest, \
        build_engine
    cfg, params, prompts = ctx["cfg"], ctx["params"], ctx["prompts"]
    swap = 2 * cfg.expert_param_bytes(16)
    engine = build_engine(cfg, params, EngineConfig(
        **SERVE_CFG, overlap=True, swap_bytes=swap), device="cuda")
    cand = [pt for pt in engine.frontier.points if _host_pairs(pt.plan)
            and (pt.plan.location == HOST).sum() >= 3]
    if not cand:
        raise AssertionError("no frontier point with an int4 and an int8 "
                             "expert and a third expert off the card")
    point = max(cand, key=lambda pt: pt.resident_experts)
    engine.apply_frontier_point(point)
    engine.reset_counters()
    ops.reset_launches()
    rids = [engine.submit_request(ServeRequest(pr, max_new_tokens=MAX_NEW))
            for pr in prompts]
    for _ in range(3):
        engine.run_iteration()
    cache = engine.expert_cache
    resident = {k[:2] for k in cache.resident_keys()}
    pairs = _host_pairs(engine.current_plan)
    one = [(li, lo, hi) for li, lo, hi in pairs
           if ((li, lo) in resident) != ((li, hi) in resident)]
    staged = not one
    li, e_lo, e_hi = one[0] if one else pairs[0]
    lo_cached = staged or (li, e_lo) in resident
    if staged:                   # the traffic cached both or neither
        cache.invalidate([(li, e_hi)])
    # the cached one is touched last in the LRU: the prefetch below (at
    # most one bf16 expert) cannot evict it from two bf16 experts' room
    cache.get((li, e_lo if lo_cached else e_hi))
    other = next((int(l), int(e)) for l, e in np.argwhere(
        engine.current_plan.location == HOST)
        if (int(l), int(e)) not in {(li, e_lo), (li, e_hi)})
    cache.invalidate([other])
    cache.prefetch([other])
    in_flight = len(cache._inflight)
    bits = engine.current_plan.bits.copy()
    bits[li, e_lo], bits[li, e_hi] = bits[li, e_hi], bits[li, e_lo]
    _peak_reset(torch)
    t0 = time.perf_counter()
    report = engine.apply_bits_update(bits)
    secs = time.perf_counter() - t0
    _, peak = _mem_gb(torch)
    step = cfg.expert_param_bytes(8) - cfg.expert_param_bytes(4)
    want = step if lo_cached else -step
    if report["restaged"] != 1 or report["cache_bytes_delta"] != want \
            or cache._inflight:
        raise AssertionError(f"bits update on the overlap engine: report "
                             f"{report}, expected restaged 1 and a cache "
                             f"byte delta of {want}; in flight after it "
                             f"{list(cache._inflight)}")
    log(f"  apply_bits_update on an overlap engine at {point.summary()} "
        f"with {len(prompts)} requests in flight: layer {li} experts "
        f"{e_lo} (int4) <-> {e_hi} (int8), both off the card, "
        f"{'int4' if lo_cached else 'int8'} one cached"
        f"{' (staged by the script)' if staged else ' by the traffic'}, "
        f"{in_flight} copy(ies) in flight at the call; report {report}; "
        f"{secs:.3f} s, peak {peak:.2f} GB")
    engine.step()
    launches = dict(ops.LAUNCHES)
    require_launches(launches, "bits update (overlap)",
                     [k for k, _ in _bank_keys(engine.current_plan)])
    tokens = [engine.result(r).tokens for r in rids]
    if any(len(t) != MAX_NEW for t in tokens):
        raise AssertionError(f"bad token counts {[len(t) for t in tokens]}")
    _same_as_fresh(torch, engine, point, cfg, params, prompts,
                   "bits update (overlap)")
    engine.close()
    alive = _xfer_threads()
    if alive:
        raise AssertionError(f"expert-xfer threads alive after close: "
                             f"{alive}")
    del engine
    _release(torch)
    return {"point": point.summary(), "pair": [li, e_lo, e_hi],
            "staged_by_script": staged, "in_flight_at_call": in_flight,
            "report": report, "expected_delta": want, "seconds": secs,
            "peak_gb": peak, "launches": launches}


def phase_multi(torch, np, ctx, card: str):
    """3g: two full-width tenants (params from seeds 0 and 1) under one
    MultiTenantEngine, sharing an AsyncExpertCache of two bf16 experts
    through ScopedExpertCache views, overlap on. Budget 0.6x the summed
    bf16 footprint, then ``set_budget`` to 0.45x: exactly one joint
    re-arbitration, allocations inside the budget, each tenant's greedy
    tokens equal to a standalone engine's at its final point, no
    ``expert-xfer`` thread alive after ``close()``."""
    import math
    from repro_torch.core.expert_cache import AsyncExpertCache
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_params
    from repro_torch.serving.api import (EngineConfig, MultiTenantEngine,
                                         QoSTarget, ServeRequest,
                                         TenantSpec, build_engine)
    from repro_torch.serving.qos import QoSControllerConfig
    cfg, prompts = ctx["cfg"], ctx["prompts"]
    total = cfg.num_layers * cfg.moe.num_experts
    full16 = cfg.non_expert_bytes() + total * cfg.expert_param_bytes(16)
    params = {"chat": ctx["params"],
              "batch": init_params(cfg, seed=1, device="cuda")}
    shared = AsyncExpertCache(capacity_bytes=2 * cfg.expert_param_bytes(16),
                              device="cuda")
    mt = MultiTenantEngine(0.6 * 2 * full16, expert_cache=shared,
                           controller_config=QoSControllerConfig(
                               min_dwell_iterations=4, window_iterations=2))
    specs = [TenantSpec("chat", QoSTarget(min_tokens_per_s=math.inf),
                        weight=2.0),
             TenantSpec("batch", QoSTarget(min_tokens_per_s=math.inf,
                                           max_quality_loss=0.0))]
    for spec in specs:
        mt.add_tenant(spec, build_engine(
            cfg, params[spec.name], EngineConfig(**SERVE_CFG, overlap=True),
            device="cuda", expert_cache=shared.scoped(spec.name)))
    ops.reset_launches()
    out = {"phases": []}
    t_all = time.perf_counter()
    for phase, frac in enumerate((0.6, 0.45)):
        if phase == 0:
            mt.arbitrate()
        else:
            arb0 = mt.metrics["arbitrations"]
            _peak_reset(torch)
            t0 = time.perf_counter()
            mt.set_budget(frac * 2 * full16)
            shift_s = time.perf_counter() - t0
            if mt.metrics["arbitrations"] != arb0 + 1:
                raise AssertionError("the budget shift did not cost exactly "
                                     "one joint re-arbitration")
            out["shift_s"] = shift_s
            out["shift_peak_gb"] = _mem_gb(torch)[1]
        alloc = sum(t.allocated_bytes for t in mt.tenants.values())
        used = sum(t.point.qos.device_bytes for t in mt.tenants.values())
        if alloc > mt.budget_bytes * (1 + 1e-9) or used > mt.budget_bytes:
            raise AssertionError(f"allocations {alloc} / footprints {used} "
                                 f"over the budget {mt.budget_bytes}")
        log(f"multi-tenant phase {phase}: budget {frac}x summed bf16 = "
            f"{mt.budget_bytes / 1e9:.3f} GB, allocated {alloc / 1e9:.3f} "
            f"GB, footprints {used / 1e9:.3f} GB, "
            f"{mt.metrics['arbitrations']:.0f} arbitrations")
        for name, t in mt.tenants.items():
            log(f"  [{name}] alloc {t.allocated_bytes / 1e9:.3f} GB -> "
                f"{t.point.summary()}")
            for pr in prompts:
                t.engine.submit_request(ServeRequest(pr, max_new_tokens=8))
        t0 = time.perf_counter()
        iters0 = {n: t.engine.metrics["iterations"]
                  for n, t in mt.tenants.items()}
        while mt.has_work():
            mt.run_iteration(temperature=0.0)
        wall = time.perf_counter() - t0
        rec = {"budget_gb": mt.budget_bytes / 1e9, "wall_s": wall,
               "tenants": {}}
        for name, t in mt.tenants.items():
            m = t.engine.metrics
            rec["tenants"][name] = {
                "point": t.point.summary(),
                "alloc_gb": t.allocated_bytes / 1e9,
                "tokens_per_s": t.engine.throughput_tokens_per_s(),
                "iterations": m["iterations"] - iters0[name],
                "transfer_s": m["transfer_s"],
                "transfer_exposed_s": m["transfer_exposed_s"],
                "expert_fetches": m["expert_fetches"]}
            log(f"  [{name}] {t.engine.summary()}")
        out["phases"].append(rec)
    wall_all = time.perf_counter() - t_all
    launches = dict(ops.LAUNCHES)
    iters = sum(t.engine.metrics["iterations"] for t in mt.tenants.values())
    for r in mt.reports:
        log(f"  {r.summary()}")
    out["reports"] = [r.__dict__ for r in mt.reports]
    out["metrics"] = dict(mt.metrics)
    require_launches(launches, "multi-tenant",
                     sorted({k for t in mt.tenants.values()
                             for k, _ in _bank_keys(t.engine.current_plan)}))
    # each tenant's greedy tokens against a standalone engine at its
    # final point (its own cache, no controller)
    for name, t in mt.tenants.items():
        got = serve_pass(torch, t.engine, prompts)
        solo = build_engine(cfg, params[name], EngineConfig(**SERVE_CFG),
                            device="cuda")
        solo.apply_frontier_point(t.point)
        if not (np_equal(solo.current_plan.bits, t.engine.current_plan.bits)
                and np_equal(solo.current_plan.location,
                             t.engine.current_plan.location)):
            raise AssertionError(f"tenant {name}: the standalone engine "
                                 "planned another placement or rungs")
        want = serve_pass(torch, solo, prompts)
        solo.close()
        del solo
        _release(torch)
        if got["tokens"] != want["tokens"]:
            raise AssertionError(f"tenant {name}: tokens {got['tokens']} != "
                                 f"standalone {want['tokens']}")
        out["phases"][-1]["tenants"][name]["verify_tokens"] = got["tokens"]
    stats = {v.owner: dict(v.stats.__dict__) for v in
             (t.cache_view for t in mt.tenants.values())}
    mt.close()
    alive = _xfer_threads()
    if alive:
        raise AssertionError(f"expert-xfer threads alive after close: "
                             f"{alive}")
    log(f"multi-tenant: {mt.summary()}; shared swap per tenant {stats}; "
        f"{wall_all:.2f} s; launches {launches}; tokens equal to standalone "
        "engines; no expert-xfer thread alive after close()")
    out.update(launches=launches, cache_views=stats,
               launches_per_decode_iter={k: v / max(iters, 1)
                                         for k, v in launches.items()})
    del mt, params
    _release(torch)
    return out


# --------------------------------------------------------------------------
# phase 8: expert- and data-parallel serving on repeated cuda:0
# --------------------------------------------------------------------------

#: 8a's plans: per-layer counts per rung (every bank a multiple of ep)
EP_PLANS = {2: ({4: 4, 8: 2}, (16, 8, 4)), 4: ({4: 4}, (16, 4))}
EP_FORWARDS = 5                 # 8a: one prefill + 4 decode steps
#: 8a's long prompt, through the plans that hold an int8 bank (ep 2's: G =
#: 2 at ep 1, G = 1 on each rank of ep 2): the 1024-token bucket, C = 320,
#: the wide wgmma body's two tiles, so that a plan rule that depends on the
#: bank's size shows in its bytes across ep and in its prefill ms beside
#: 3p's 1024-token prompt (int8 G = 4)
EP_LONG = 1024
GROUPED = {4: "grouped_q4", 8: "grouped_q8", 16: "grouped_bf16"}


class _RankLaunches:
    """Books the kernels' launches by EP rank while a model or engine
    runs: ``mixed_moe._dispatch_local`` is given each rank's index just
    before that rank's ``_expert_ffn``, so the launches an FFN call makes
    belong to the rank dispatched last. ``by_rank[r]`` counts
    ``(wrapper, G)`` and, as ``("split_k", 0)``, the launches among them
    whose plan split K; ``grids[r]`` counts those split launches by
    ``(wrapper, "folded" | "spread")``."""

    def __enter__(self):
        import collections
        from repro_torch.core import mixed_moe
        from repro_torch.kernels import ops
        self.mm, rank = mixed_moe, {"r": None}
        self.by_rank = collections.defaultdict(collections.Counter)
        self.grids = collections.defaultdict(collections.Counter)
        self._dispatch, self._ffn = mixed_moe._dispatch_local, \
            mixed_moe._expert_ffn

        def dispatch(*a, **kw):
            rank["r"] = kw["rank"]
            return self._dispatch(*a, **kw)

        def ffn(*a, **kw):
            before = collections.Counter(ops.GROUP_LAUNCHES)
            split0 = collections.Counter(ops.SPLIT_LAUNCHES)
            folded0 = collections.Counter(ops.FOLDED_LAUNCHES)
            s0 = split_count(ops)
            out = self._ffn(*a, **kw)
            delta = collections.Counter(ops.GROUP_LAUNCHES)
            delta.subtract(before)
            book = self.by_rank[rank["r"]]
            book.update(+delta)
            book[("split_k", 0)] += split_count(ops) - s0
            grids = self.grids[rank["r"]]
            for (name, body), v in ops.SPLIT_LAUNCHES.items():
                folded = ops.FOLDED_LAUNCHES[(name, body)] \
                    - folded0[(name, body)]
                spread = v - split0[(name, body)] - folded
                grids.update({(name, "folded"): folded,
                              (name, "spread"): spread})
            return out

        mixed_moe._dispatch_local, mixed_moe._expert_ffn = dispatch, ffn
        return self

    def __exit__(self, *exc):
        self.mm._dispatch_local, self.mm._expert_ffn = \
            self._dispatch, self._ffn


def _shard_keys(plan, ep: int):
    """The (wrapper, G) launch keys of one rank's bank shards."""
    return sorted((GROUPED[b], g // ep) for b, g in
                  zip(sorted(plan.ladder), plan.bank_sizes()) if g)


def _require_rank_launches(by_rank, plan, ep: int, what: str,
                           per_bank=None):
    """Every rank launched each of its bank shards at G = bank / ep (and
    nothing at another G), ``per_bank`` times where given, and split K in
    some of them (the split-K epilogue)."""
    if sorted(by_rank) != list(range(ep)):
        raise AssertionError(f"{what}: launches by rank {sorted(by_rank)}, "
                             f"want ranks 0..{ep - 1}")
    want = _shard_keys(plan, ep)
    for r in range(ep):
        book = by_rank[r]
        got = sorted(k for k, v in book.items()
                     if k[0] != "split_k" and v)
        if got != want or (per_bank is not None
                           and any(book[k] != per_bank for k in want)):
            raise AssertionError(f"{what}: rank {r} launched {dict(book)}, "
                                 f"want {want} x {per_bank}")
        require_split_launches(book[("split_k", 0)], f"{what}: rank {r}")


def _ep_decode(torch, cfg, params, mesh, tokens):
    """``Model.prefill`` of ``tokens`` (B, S) and 4 greedy
    ``decode_step``s with the kernels on: the logits' bytes."""
    from repro_torch.models.model import build_model
    model = build_model(cfg, mesh, use_kernel=True)
    cache = model.init_cache(tokens.shape[0], 24, device="cuda")
    logits, cache = model.prefill(params, {"tokens": tokens}, cache)
    chunks = [logits.float().cpu().numpy().tobytes()]
    pos = torch.full((tokens.shape[0],), tokens.shape[1], device="cuda")
    for step in range(EP_FORWARDS - 1):
        cur = logits.argmax(-1)[:, None]
        logits, cache = model.decode_step(params, cache, cur, pos + step)
        chunks.append(logits.float().cpu().numpy().tobytes())
    return b"".join(chunks)


def _ep_long_prefill(torch, cfg, params, mesh, tokens):
    """``Model.prefill`` of ``tokens`` (1, EP_LONG) with the kernels on,
    twice: the second pass's logits bytes and ms (card synchronized), and
    the launches of both passes by (wrapper, body)."""
    import collections
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    model = build_model(cfg, mesh, use_kernel=True)
    before = collections.Counter(ops.BODY_LAUNCHES)
    for _ in range(2):
        cache = model.init_cache(1, tokens.shape[1], device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = model.prefill(params, {"tokens": tokens}, cache)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    return (logits.float().cpu().numpy().tobytes(), ms,
            collections.Counter(ops.BODY_LAUNCHES) - before)


def _ep_long(torch, np, cfg, plan, ep, sp, placed, mesh, seed: int):
    """8a's long prompt (``EP_LONG`` tokens) through ``plan`` at ep 1
    (``sp``) and ep (``placed`` over ``mesh``): logits bytes equal, every
    bank launched at G = bank / ep through the body that ``launch_plan``
    names for the prompt's capacity and no other body, the int8 bank's
    down-projections on each rank on the grid that ``fold_splits`` gives
    its G (ep 1 folded, ep spread: its bytes held equal across the two);
    the body, K splits, grids and warm prefill ms per ep."""
    from repro_torch.kernels.q4_matmul import fold_splits, launch_plan
    moe = cfg.moe
    cap = math.ceil(EP_LONG * moe.top_k * moe.capacity_factor
                    / moe.num_experts)
    c = -(-cap // 4) * 4
    body = launch_plan(c, D_MODEL, D_FF, 16).body
    splits = {b: (launch_plan(c, D_MODEL, D_FF, b).splits,
                  launch_plan(c, D_FF, D_MODEL, b).splits)
              for b in sorted(plan.ladder)}
    g8 = dict(zip(sorted(plan.ladder), plan.bank_sizes())).get(8, 0)
    down = launch_plan(c, D_FF, D_MODEL, 8)
    folds = {n: fold_splits(down, g8 // n, c, D_MODEL, 8) for n in (1, ep)}
    if not (folds[1] and not folds[ep]):
        raise AssertionError(f"8a long prompt: the int8 bank's grids "
                             f"{folds} by ep, want ep=1 folded and ep={ep} "
                             "spread")
    tok = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        1, cfg.vocab_size, (1, EP_LONG))).to("cuda")
    got, ms, books, grids = {}, {}, {}, {}
    for n, params, m in ((1, sp, None), (ep, placed, mesh)):
        with _RankLaunches() as ranks:
            got[n], ms[n], bodies = _ep_long_prefill(torch, cfg, params, m,
                                                     tok)
        _require_rank_launches(ranks.by_rank, plan, n,
                               f"8a long prompt, ep={n}",
                               3 * cfg.num_layers * 2)
        grouped = {k: v for k, v in body_launches(bodies).items()
                   if k.split("/")[0] in GROUPED.values() and v}
        if not grouped or any(not k.endswith(f"/{body}") for k in grouped):
            raise AssertionError(f"8a long prompt, ep={n}: launches by body "
                                 f"{grouped}, want {body} only")
        books[n] = {r: {f"{k}@G={g}" if k != "split_k" else k: v
                        for (k, g), v in sorted(b.items())}
                    for r, b in sorted(ranks.by_rank.items())}
        # the int8 bank's down-projections: 2 passes x the layers a rank
        want = 2 * cfg.num_layers
        grids[n] = {}
        for r, b in sorted(ranks.grids.items()):
            took = {"folded": b[("grouped_q8", "folded")],
                    "spread": b[("grouped_q8", "spread")]}
            grids[n][r] = took
            if took != ({"folded": want, "spread": 0} if folds[n]
                        else {"folded": 0, "spread": want}):
                raise AssertionError(
                    f"8a long prompt, ep={n}: rank {r}'s int8 bank (G = "
                    f"{g8 // n}) took {took}, want every split launch "
                    f"{'folded' if folds[n] else 'spread'}")
    if got[ep] != got[1]:
        raise AssertionError(f"8a long prompt: ep={ep} logits bytes differ "
                             "from ep=1")
    log(f"  8a ep={ep} long prompt: 1 x {EP_LONG} tokens, C = {c}, body "
        f"{body}, K splits (up, down) by bits {splits}; int8 bank G = {g8} "
        f"at ep=1, {g8 // ep} a rank at ep={ep}; its down-projections' "
        f"grids by ep and rank {grids}; warm prefill {ms[1]:.3f} ms at "
        f"ep=1, {ms[ep]:.3f} ms at ep={ep}; logits bytes equal")
    return {"tokens": EP_LONG, "capacity": c, "body": body,
            "splits": {str(b): v for b, v in splits.items()},
            "int8_bank_G": {"1": g8, str(ep): g8 // ep},
            "int8_down_grids": {str(n): {str(r): v for r, v in g.items()}
                                for n, g in grids.items()},
            "warm_prefill_ms": {str(n): v for n, v in ms.items()},
            "launches_by_rank": {str(n): v for n, v in books.items()},
            "bytes_equal": True}


def _ep_devices(torch, ep: int, distinct: bool):
    """The mesh's device list: ``cuda:0`` repeated, or distinct cards."""
    if distinct and torch.cuda.device_count() < ep:
        raise RuntimeError(f"distinct cards: need {ep}, have "
                           f"{torch.cuda.device_count()}")
    return [f"cuda:{i}" for i in range(ep)] if distinct \
        else ["cuda:0"] * ep


def _ep_model_level(torch, np, ctx, seed: int, distinct: bool = False):
    """8a: per ep, a plan whose every bank splits over ep; prefill of
    2 x 8 tokens + 4 greedy decode steps over ``["cuda:0"] * ep`` (or
    distinct cards) give the logits bytes of one device, with each rank
    launching its bank shards at G = bank / ep (3 matrices x layers x 5
    forwards each)."""
    from repro_torch.core.precision_plan import balanced_ladder_plan
    from repro_torch.launch.mesh import make_ep_mesh
    from repro_torch.models.model import apply_precision_plan
    cfg, params = ctx["cfg"], ctx["params"]
    L, E = cfg.num_layers, cfg.moe.num_experts
    tok = torch.from_numpy(np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (2, 8))).to("cuda")
    out = {}
    for ep, (per_layer, ladder) in EP_PLANS.items():
        plan = balanced_ladder_plan(
            L, E, {b: n * L for b, n in per_layer.items()}, ladder=ladder,
            group_size=cfg.mop.group_size)
        sp = apply_precision_plan(params, cfg, plan)
        with _RankLaunches() as one:
            ref = _ep_decode(torch, cfg, sp, None, tok)
        _require_rank_launches(one.by_rank, plan, 1, f"ep {ep}: ep=1 run",
                               3 * L * EP_FORWARDS)
        mesh = make_ep_mesh(ep, devices=_ep_devices(torch, ep, distinct))
        _peak_reset(torch)
        t0 = time.perf_counter()
        placed = apply_precision_plan(params, cfg, plan, mesh=mesh)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        with _RankLaunches() as ranks:
            got = _ep_decode(torch, cfg, placed, mesh, tok)
        _, peak = _mem_gb(torch)
        long = _ep_long(torch, np, cfg, plan, ep, sp, placed, mesh, seed) \
            if 8 in per_layer else None
        del sp, placed
        if got != ref:
            raise AssertionError(f"8a: ep={ep} logits bytes differ from "
                                 "ep=1")
        _require_rank_launches(ranks.by_rank, plan, ep, f"8a ep={ep}",
                               3 * L * EP_FORWARDS)
        per_rank = {r: {f"{k}@G={g}" if k != "split_k" else k: v
                        for (k, g), v in sorted(b.items())}
                    for r, b in sorted(ranks.by_rank.items())}
        log(f"  8a ep={ep}: plan per layer {per_layer} (ladder {ladder}), "
            f"banks per layer {dict(zip(sorted(ladder), plan.bank_sizes()))}"
            f"; shards placed in {build_s:.2f} s; prefill 2x8 + 4 decode "
            f"steps, logits bytes equal to ep=1; peak {peak:.2f} GB")
        for r, book in per_rank.items():
            log(f"    rank {r} launches: {book}")
        out[str(ep)] = {"per_layer": {str(b): n for b, n in
                                      per_layer.items()},
                        "ladder": list(ladder), "bytes_equal": True,
                        "launches_by_rank": per_rank,
                        "place_s": build_s, "peak_gb": peak, "long": long}
    return out


def _ep_points(engines, total):
    """A: the serve phase's rule on the ep=2 frontier (all three rungs,
    some experts off the card); B: of the ep=4 frontier's points whose
    banks differ from A's and move experts between the ranks of ep=2, one
    with the most non-empty banks, then the most resident."""
    a = pick_point(engines[2].frontier, total)
    moves = [p for p in engines[4].frontier.points
             if p.plan.bank_sizes() != a.plan.bank_sizes()
             and (p.plan.device_assignment(2)
                  != a.plan.device_assignment(2)).any()]
    if not moves:
        raise AssertionError("no ep=4 frontier point migrates experts")
    return a, max(moves, key=lambda p: (
        sum(g > 0 for g in p.plan.bank_sizes()), p.resident_experts,
        -p.num_q_experts))


def _ep_engine_level(torch, np, ctx, card: str, seed: int,
                     distinct: bool = False):
    """8b: engines at ep = 1, 2, 4 on the serve phase's params (the
    default paged ``EngineConfig``, kernels on): point A, 4 requests,
    then a replan to point B that migrates experts between the ranks of
    ep = 2, 4 more requests; greedy tokens of ep = 2 (both passes) and
    ep = 4 (at B) equal to ep = 1's, each rank's shards launched at
    G = bank / ep. Then one warm pass each: ms per decode iteration,
    decode tokens/s and the card's peak GB (every engine of the phase is
    alive, so the peak holds all of their banks)."""
    from repro_torch.launch.mesh import make_ep_mesh
    from repro_torch.serving.api import EngineConfig, build_engine
    cfg, params = ctx["cfg"], ctx["params"]
    total = cfg.num_layers * cfg.moe.num_experts
    engines = {1: build_engine(cfg, params, EngineConfig(**SERVE_CFG),
                               device="cuda")}
    for ep in (2, 4):
        engines[ep] = build_engine(
            cfg, params, EngineConfig(**SERVE_CFG),
            mesh=make_ep_mesh(ep, devices=_ep_devices(torch, ep, distinct)))
    a, b = _ep_points(engines, total)
    rng = np.random.default_rng(seed + 8)
    second = [rng.integers(1, cfg.vocab_size, size=16) for _ in range(4)]
    passes, tokens = {}, {}
    for ep in (1, 2):
        eng = engines[ep]
        eng.apply_frontier_point(a)
        with _RankLaunches() as ra:
            passes[(ep, "A")] = serve_pass(torch, eng, ctx["prompts"])
        plan_a = eng.current_plan
        eng.apply_frontier_point(b)
        with _RankLaunches() as rb:
            passes[(ep, "B")] = serve_pass(torch, eng, second)
        _require_rank_launches(ra.by_rank, plan_a, ep, f"8b ep={ep} at A")
        _require_rank_launches(rb.by_rank, eng.current_plan, ep,
                               f"8b ep={ep} at B")
        tokens[ep] = (passes[(ep, "A")]["tokens"],
                      passes[(ep, "B")]["tokens"])
    moved = int((a.plan.device_assignment(2)
                 != engines[2].current_plan.device_assignment(2)).sum())
    if (engines[1].current_plan.bits != engines[2].current_plan.bits).any():
        raise AssertionError("8b: ep=1 and ep=2 serve other bits at B")
    if tokens[2] != tokens[1]:
        raise AssertionError(f"8b: ep=2 tokens {tokens[2]} != ep=1 "
                             f"{tokens[1]}")
    engines[4].apply_frontier_point(b)
    with _RankLaunches() as r4:
        passes[(4, "B")] = serve_pass(torch, engines[4], second)
    _require_rank_launches(r4.by_rank, engines[4].current_plan, 4,
                           "8b ep=4 at B")
    if passes[(4, "B")]["tokens"] != tokens[1][1]:
        raise AssertionError("8b: ep=4 tokens differ from ep=1 at B")
    log(f"  8b points: A {a.summary()} (banks {a.plan.bank_sizes()}), "
        f"B {b.summary()} (banks {b.plan.bank_sizes()}); the replan A -> B "
        f"moves {moved} of {total} experts to another rank of ep=2; "
        "greedy tokens of ep=2 (A and B) and ep=4 (B) equal to ep=1's")
    log(f"    tokens A {tokens[1][0]}")
    log(f"    tokens B {tokens[1][1]}")
    readings = {}
    for ep, eng in engines.items():
        _peak_reset(torch)
        r = serve_pass(torch, eng, second)
        _, peak = _mem_gb(torch)
        if r["tokens"] != tokens[1][1]:
            raise AssertionError(f"8b: warm ep={ep} pass gave other tokens")
        readings[str(ep)] = {
            "decode_ms_per_iter": r["decode_ms_per_iter"],
            "tokens_per_s": r["tokens_per_s"], "peak_gb": peak,
            "iterations": r["iterations"],
            "launches_per_decode_iter": r["launches_per_decode_iter"]}
        log(f"    ep={ep} at B on {card}: {r['decode_ms_per_iter']:.3f} ms "
            f"per decode iteration, {r['tokens_per_s']:.2f} decode tok/s, "
            f"peak {peak:.2f} GB on cuda:0; launches per decode iteration "
            f"{r['launches_per_decode_iter']}")
    for eng in engines.values():
        eng.close()
    return {"A": a.summary(), "B": b.summary(), "moved_experts": moved,
            "tokens": tokens[1], "readings": readings,
            "path": passes[(2, "A")]}


def _ep_group_and_cli(torch, np, ctx, seed: int, distinct: bool = False):
    """8c: ``make_dp_group(dp=2, ep=2)`` over four ``cuda:0`` entries
    under the autoscaler: two long and two short requests; the scale-down
    after the short ones retire drains a replica that still serves, and
    every request retires with its full token count. Then the serve CLI
    at ``--smoke`` with ``--ep 2 --dp 2 --device cuda:0,cuda:0,cuda:0,
    cuda:0`` (kernels on; its summary lines), and ``--ep 2`` with a lone
    ``cuda`` on a one-card host raising the actionable devices error."""
    import contextlib
    import io
    from repro_torch import serving
    from repro_torch.core.pareto import QoSTarget
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.serving.api import EngineConfig, ServeRequest
    from repro_torch.serving.control_plane.autoscale import \
        ReplicaAutoscaler
    from repro_torch.serving.ep import make_dp_group
    cfg, params = ctx["cfg"], ctx["params"]
    t0 = time.perf_counter()
    g = make_dp_group(cfg, params, EngineConfig(**SERVE_CFG), ep=2, dp=2,
                      devices=_ep_devices(torch, 4, distinct))
    planner = g.engines[0].planner
    full = planner.size_ne + planner.num_experts_total * planner.size_e16
    points = g.apply_target(QoSTarget(mem_budget_bytes=0.6 * full,
                                      min_tokens_per_s=math.inf))
    shard_keys = sorted({k for e in g.engines
                         for k in _shard_keys(e.current_plan, 2)})
    rng = np.random.default_rng(seed + 16)
    lengths = [12, 12, 4, 4]
    rids = [g.submit_request(ServeRequest(
        rng.integers(1, cfg.vocab_size, size=16), max_new_tokens=n))
        for n in lengths]
    auto = ReplicaAutoscaler(patience_ticks=1, cooldown_s=0.0,
                             max_replicas=2)
    ops.reset_launches()
    drained, tick, decisions = False, 0.0, []
    while g.has_work():
        g.run_iteration(temperature=0.0)
        d = g.autoscale_step(tick, auto)
        if d:
            decisions.append(d)
            drained = drained or (d == -1 and g.metrics["draining"] == 1)
        tick += 1.0
    launches, splits = dict(ops.LAUNCHES), split_count(ops)
    group_launches = {f"{k}@G={n}": ops.GROUP_LAUNCHES[(k, n)]
                      for k, n in shard_keys}
    got = [len(g.result(r).tokens) for r in rids]
    if got != lengths or not drained or len(g.engines) != 1:
        raise AssertionError(f"8c: tokens {got} (want {lengths}), drained "
                             f"with work {drained}, {len(g.engines)} "
                             f"engines left, decisions {decisions}")
    if not all(group_launches.values()):
        raise AssertionError(f"8c group: shards {shard_keys} not all "
                             f"launched: {dict(ops.GROUP_LAUNCHES)}")
    require_split_launches(splits, "8c group")
    secs = time.perf_counter() - t0
    log(f"  8c dp=2 x ep=2 over {'cuda:0-3' if distinct else 'cuda:0 x 4'}"
        f" ({secs:.2f} s): point "
        f"{points[0].summary()}; autoscaler decisions {decisions}, a "
        f"replica drained with a request in flight; {len(rids)} requests "
        f"retired with {got} tokens; shard launches {group_launches}, "
        f"split K {splits} (reduced in their epilogues)")
    g.close()
    del g
    _release(torch)
    dev = "cuda" if distinct else ",".join(["cuda:0"] * 4)
    argv = ["--ep", "2", "--dp", "2", "--device", dev, "--smoke",
            "--temperature", "0", "--requests", "4", "--max-new-tokens", "4"]
    groups = []
    make = serving.ep.make_dp_group

    def make_and_keep(*a, **kw):
        group = make(*a, **kw)
        groups.append(list(group.engines))
        return group

    buf = io.StringIO()
    serving.ep.make_dp_group = make_and_keep
    ops.reset_launches()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            serve.main(argv)
        cli_s = time.perf_counter() - t0
    finally:
        serving.ep.make_dp_group = make
    launches = dict(ops.LAUNCHES)
    text = buf.getvalue()
    for need in ("[serve] ep=2 dp=2 target[",
                 "[serve] ep=2 dp=2 16 tokens across", "tokens=["):
        if need not in text:
            raise AssertionError(f"8c cli: no {need!r} line in:\n{text}")
    if not groups or not all(e.use_kernel for e in groups[0]):
        raise AssertionError("8c cli: the group's engines run without the "
                             "kernels")
    cli_keys = sorted({k for e in groups[0]
                       for k in _shard_keys(e.current_plan, 2)})
    if not all(ops.GROUP_LAUNCHES[k] for k in cli_keys):
        raise AssertionError(f"8c cli: shards {cli_keys} not all "
                             f"launched: {dict(ops.GROUP_LAUNCHES)}")
    log(f"  8c cli ({cli_s:.2f} s): python -m repro_torch.launch.serve "
        f"{' '.join(argv)}")
    for ln in text.splitlines():
        log(f"    {ln}")
    log(f"    launches {launches}")
    refused = None
    if torch.cuda.device_count() < 2:
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                serve.main(["--ep", "2", "--device", "cuda", "--smoke",
                            "--requests", "1", "--max-new-tokens", "2"])
        except RuntimeError as e:
            refused = str(e)
        if not refused or "need 2 devices" not in refused:
            raise AssertionError(f"8c: --ep 2 --device cuda on one card "
                                 f"did not raise the devices error "
                                 f"({refused!r})")
        log(f"  8c --ep 2 --device cuda on one card: {refused}")
    return {"group_tokens": got, "decisions": decisions,
            "cli_seconds": cli_s, "cli_lines": text.splitlines(),
            "cli_launches": launches, "lone_cuda_error": refused}


def _log_long_prompts(serve, plan) -> None:
    """The warm prefill ms of an ``EP_LONG``-token prompt on the serve
    point (3p) beside 8a's on banks of fewer experts."""
    long = (((serve.get("ep") or {}).get("model") or {}).get("2")
            or {}).get("long")
    pre = serve.get("prefill")
    if not long or not pre:
        return
    g8 = dict(zip(sorted(plan.ladder), plan.bank_sizes())).get(8, 0)
    ms = pre["warm"]["prefill_ms_by_len"].get(EP_LONG, [])
    g = long["int8_bank_G"]
    log(f"long prompts: {EP_LONG} tokens (C = {long['capacity']}, "
        f"{long['body']}), warm prefill ms {[round(v, 3) for v in ms]} on "
        f"the serve point (3p, int8 bank G = {g8}); "
        f"{long['warm_prefill_ms']['1']:.3f} at int8 G = {g['1']} and "
        f"{long['warm_prefill_ms']['2']:.3f} at G = {g['2']} a rank (8a, "
        f"ep 2's plan at ep=1 and ep=2)")


def phase_ep(torch, np, ctx, card: str, seed: int, distinct: bool = False):
    """8: expert- and data-parallel serving at full width on repeated
    ``cuda:0`` (8a model level, 8b engine level, 8c group and CLI);
    ``distinct`` puts rank r on ``cuda:r`` instead (a four-card host,
    ``tools/chip_phases.py ep-cards``)."""
    t0 = time.perf_counter()
    log(f"ep: full-width serve-phase params, EP ranks on "
        f"{'distinct cards' if distinct else 'cuda:0'}")
    out = {"model": _ep_model_level(torch, np, ctx, seed, distinct)}
    _release(torch)
    out["engine"] = _ep_engine_level(torch, np, ctx, card, seed, distinct)
    _release(torch)
    out["group"] = _ep_group_and_cli(torch, np, ctx, seed, distinct)
    out["seconds"] = time.perf_counter() - t0
    log(f"  ep: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 9: sharded training and MoE over (data, model) meshes
# --------------------------------------------------------------------------

#: 9a: (mesh shape, tokens) per regime at one Mixtral layer's full width.
#: Data x EP crosses the token-gather gate by itself: 8192 tokens per data
#: rank x 2 gathered x d 4096 x 2 bytes = 128 MiB > 64 MiB.
MESH_REGIMES = {"token-gather": ((2, 2), 16), "data x EP": ((2, 2), 16384),
                "TP": ((1, 16), 16)}
#: 9a/9c's serve banks per layer (every bank splits over model = 2)
MESH_BANKS = {4: 4, 8: 2, 16: 2}
MESH_BITS = (4, 4, 8, 16, 4, 8, 16, 4)         # expert -> rung, 9a
#: a d_ff-splitting regime's outputs against one device's: partial d_ff
#: products rounded to bf16 per position, then summed in f32
MESH_BAR = 2e-2
MESH_FORWARDS = 5                              # 9c: prefill + 4 decode steps
MESH_SERVE = {"2x2": ((2, 2), "token-gather"), "1x16": ((1, 16), "TP")}
#: the phase-5 rows at phase 9's shard shapes (C, K, N): token-gather's
#: d_ff half of 14336 and TP's sixteenth (896), decode C = 8
MESH_SHAPES = {"tg_up": (C_DECODE, D_MODEL, D_FF // 2),
               "tg_down": (C_DECODE, D_FF // 2, D_MODEL),
               "tp_up": (C_DECODE, D_MODEL, D_FF // 16),
               "tp_down": (C_DECODE, D_FF // 16, D_MODEL)}
CLI_CKPT = ROOT / "build" / "chip_smoke_mesh_ckpt"     # gitignored, removed


def _mesh_devices(n: int, distinct: bool):
    """``cuda:0`` repeated, or position p on ``cuda:(p % cards)``."""
    if not distinct:
        return ["cuda:0"] * n
    import torch
    cards = torch.cuda.device_count()
    if cards < 2:
        raise RuntimeError(f"distinct cards: need several, have {cards}")
    return [f"cuda:{p % cards}" for p in range(n)]


class _PositionLaunches:
    """Books the grouped kernels' launches by mesh position while
    ``moe_apply`` runs: ``mixed_moe._local_fn`` is given each position's
    index, and the launch functions record ``(kernel, G, C, K, N)`` under
    the position whose FFN is running, plus, as ``split_k``, how many of
    them split K (reduced in their own epilogue). With
    ``check``, every launch's output is held against its plain version on
    the same inputs (those plain calls launch nothing)."""

    def __init__(self, check: bool = False):
        self.check = check

    def __enter__(self):
        import collections
        from repro_torch.core import mixed_moe
        from repro_torch.kernels import cuda_lib
        from repro_torch.kernels import grouped_matmul as gk
        self.mm, self.gk = mixed_moe, gk
        self.by_pos = collections.defaultdict(collections.Counter)
        self.checked, self.worst = 0, 0.0
        at = {"p": None}
        self._local, self._dq, self._bf = (mixed_moe._local_fn,
                                           gk.launch_dequant, gk.launch_bf16)

        def local(pos, *a, **kw):
            at["p"] = pos
            s0 = split_count(cuda_lib)
            out = self._local(pos, *a, **kw)
            self.by_pos[pos]["split_k"] += split_count(cuda_lib) - s0
            return out

        def held(key, out, want):
            import torch
            err, ok = _close(torch, out, want)
            if not ok:
                raise AssertionError(f"{key} at position {at['p']}: max "
                                     f"|diff| {err} from its plain version")
            self.checked += 1
            self.worst = max(self.worst, err)

        def dq(x, wq, scales, *, bits, group_size, n, **kw):
            out = self._dq(x, wq, scales, bits=bits, group_size=group_size,
                           n=n, **kw)
            key = (f"grouped_q{bits}", *x.shape, n)
            self.by_pos[at["p"]][key] += 1
            if self.check:
                held(key, out, gk.grouped_quantized_matmul_plain(
                    x, wq, scales, bits=bits, group_size=group_size))
            return out

        def bf(x, w, **kw):
            out = self._bf(x, w, **kw)
            key = ("grouped_bf16", *x.shape, w.shape[2])
            self.by_pos[at["p"]][key] += 1
            if self.check:
                held(key, out, gk.grouped_bf16_matmul_plain(x, w))
            return out

        mixed_moe._local_fn, gk.launch_dequant, gk.launch_bf16 = \
            local, dq, bf
        return self

    def __exit__(self, *exc):
        self.mm._local_fn = self._local
        self.gk.launch_dequant, self.gk.launch_bf16 = self._dq, self._bf

    def table(self):
        """Position -> {"kernel@G=g CxKxN": launches, "split_k": n}."""
        return {p: {(k if k == "split_k" else
                     f"{k[0]}@G={k[1]} {k[2]}x{k[3]}x{k[4]}"): v
                    for k, v in sorted(book.items(), key=str) if v}
                for p, book in sorted(self.by_pos.items())}

    def require(self, n_pos: int, banks, what: str, splits: bool):
        """Every position launched each bank's three matrices (and, where
        the plans split K, launches that did)."""
        if sorted(self.by_pos) != list(range(n_pos)):
            raise AssertionError(f"{what}: launches at positions "
                                 f"{sorted(self.by_pos)}, want 0..{n_pos - 1}")
        names = {4: "grouped_q4", 8: "grouped_q8", 16: "grouped_bf16"}
        for p, book in self.by_pos.items():
            for bits in banks:
                n = sum(v for k, v in book.items()
                        if k != "split_k" and k[0] == names[bits])
                if n < 3:
                    raise AssertionError(f"{what}: position {p} launched "
                                         f"{names[bits]} {n} times")
            if splits:
                require_split_launches(book["split_k"],
                                       f"{what}: position {p}")


def _path_record(torch, what: str, launches: dict, per_iter=None):
    """A path's launch record in the form of the serve paths'."""
    return {"what": what, "launches": dict(launches),
            "launches_per_decode_iter": per_iter or {
                k: None for k in launches}}


def _mesh_layer(torch, seed: int):
    """One full-width Mixtral MoE layer, seeded on the card: router (f32)
    and bf16 experts scaled by 1/sqrt(fan in)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    e = 8

    def w(shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                / math.sqrt(shape[-2])).to(torch.bfloat16)
    return {"router": torch.randn((D_MODEL, e), generator=gen,
                                  device="cuda") / math.sqrt(D_MODEL),
            "w_gate": w((e, D_MODEL, D_FF)), "w_up": w((e, D_MODEL, D_FF)),
            "w_down": w((e, D_FF, D_MODEL))}, gen


def _gap(torch, got, want) -> float:
    """max |got - want| over max |want|, in f32."""
    w = want.float()
    return float((got.float() - w).abs().max()) / max(
        float(w.abs().max()), 1e-30)


def _mesh_moe(torch, np, seed: int, distinct: bool):
    """9a: ``moe_apply`` at one Mixtral layer's full-width shapes in each
    regime against the port's one-device ``moe_apply`` on the same
    inputs: the bf16 train layout forward and backward, then the serve
    layout (int4 | int8 | bf16 banks) with the kernels on, every launch
    held against its plain version and booked per position."""
    from repro_torch.configs import get_config
    from repro_torch.core import mixed_moe as mm
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    moe = get_config("mixtral-8x7b").moe
    layer, gen = _mesh_layer(torch, seed)
    serve, order = mm.build_ladder_banks(layer, np.array(MESH_BITS),
                                         ladder=(16, 8, 4), group_size=GROUP)
    serve_router = layer["router"][:, torch.as_tensor(order).long().to(
        layer["router"].device)]
    out = {}
    for regime, (shape, t) in MESH_REGIMES.items():
        n = math.prod(shape)
        mesh = make_test_mesh(shape, devices=_mesh_devices(n, distinct))
        par = mm.MoEParallelism(mesh=mesh, dp_axes=("data",),
                                fsdp_axis="data")
        x = torch.randn((t, D_MODEL), generator=gen, device="cuda").to(
            torch.bfloat16)
        r = torch.randn((t, D_MODEL), generator=gen, device="cuda")
        got_regime = mm.moe_regime(mm.train_banks(layer), t, D_MODEL, moe,
                                   par)
        if got_regime != regime:
            raise AssertionError(f"9a: {t} tokens on {shape} take "
                                 f"{got_regime}, not {regime}")
        # data x EP runs drop-free on both sides (one device's capacity
        # counts all tokens, a position's only its data rank's)
        caps = (t, t // shape[0]) if regime == "data x EP" else (None, None)
        rec = {"mesh": list(shape), "tokens": t}
        # the bf16 train layout: forward and backward
        w, ids = mm.route(layer["router"], x, moe)
        runs = {}
        for name, p, cap in (("one device", None, caps[0]),
                             ("mesh", par, caps[1])):
            leaves = {k: layer[k].detach().requires_grad_(True)
                      for k in ("w_gate", "w_up", "w_down")}
            xx = x.detach().requires_grad_(True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = mm.moe_apply({"q4": None, "f16": leaves}, xx, w, ids, moe,
                             p, capacity=cap)
            (y.float() * r).sum().backward()
            torch.cuda.synchronize()
            runs[name] = (y.detach(), {k: v.grad for k, v in
                                       dict(leaves, x=xx).items()},
                          (time.perf_counter() - t0) * 1e3)
            del leaves, xx, y
            _release(torch)
        (y1, g1, ms1), (y2, g2, ms2) = runs["one device"], runs["mesh"]
        del runs
        rec["train"] = {"bytes_equal": _bits_equal(torch, y1, y2),
                        "gap": _gap(torch, y2, y1),
                        "grad_gap": max(_gap(torch, g2[k], g1[k])
                                        for k in g1),
                        "one_device_ms": ms1, "mesh_ms": ms2}
        del y1, y2, g1, g2
        _release(torch)
        # the serve layout with the kernels on
        w, ids = mm.route(serve_router, x, moe)
        y1 = mm.moe_apply(serve, x, w, ids, moe, use_kernel=True,
                          capacity=caps[0])
        placed = mm.shard_banks(serve, mesh)
        ops.reset_launches()
        with _PositionLaunches(check=True) as book:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y2 = mm.moe_apply(placed, x, w, ids, moe, par, use_kernel=True,
                              capacity=caps[1])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        launches = dict(ops.LAUNCHES)
        book.require(n, MESH_BANKS, f"9a {regime}",
                     splits=regime != "data x EP")
        rec["serve"] = {"bytes_equal": _bits_equal(torch, y1, y2),
                        "gap": _gap(torch, y2, y1), "mesh_ms": ms,
                        "launches_by_position": book.table(),
                        "launches_checked": book.checked,
                        "launch_max_abs_err": book.worst,
                        "path": _path_record(torch, f"9a {regime}",
                                             launches)}
        del y1, y2, placed
        _release(torch)
        for lay in ("train", "serve"):
            q = rec[lay]
            if regime == "data x EP":
                if not q["bytes_equal"]:
                    raise AssertionError(f"9a {regime} {lay}: bytes differ "
                                         f"from one device (gap "
                                         f"{q['gap']:.3e})")
            elif q["gap"] > MESH_BAR:
                raise AssertionError(f"9a {regime} {lay}: {q['gap']:.3e} of "
                                     f"max |y| from one device > {MESH_BAR}")
        tr, sv = rec["train"], rec["serve"]
        log(f"  9a {regime} on {shape}, {t} tokens: train layout "
            f"{'bytes equal' if tr['bytes_equal'] else 'gap %.3e' % tr['gap']}"
            f" (grads {tr['grad_gap']:.3e} of max |g|), forward + backward "
            f"{tr['mesh_ms']:.1f} ms (one device {tr['one_device_ms']:.1f} "
            f"ms); serve layout, kernels "
            f"{'bytes equal' if sv['bytes_equal'] else 'gap %.3e' % sv['gap']}"
            f", {sv['mesh_ms']:.1f} ms, {sv['launches_checked']} launches "
            f"held against their plain versions (max |diff| "
            f"{sv['launch_max_abs_err']:.2e})")
        for p, b in sv["launches_by_position"].items():
            log(f"    position {p}: {b}")
        out[regime] = rec
    del layer, serve
    return out


def _check_placement(tree, specs, what: str):
    """Each leaf's placement is its spec, and every position's shard has
    the block shape that spec gives."""
    from repro_torch.training.optimizer import tree_leaves
    want = dict(tree_leaves(specs))
    n = 0
    for path, leaf in tree_leaves(tree):
        if tuple(leaf.spec) != tuple(want[path]):
            raise AssertionError(f"{what} {'/'.join(path)}: spec {leaf.spec}"
                                 f", want {want[path]}")
        lay = leaf.layout
        for pos, idx in enumerate(lay.index):
            shape = tuple(s.stop - s.start
                          for s in lay.block(leaf.shape, idx))
            if tuple(leaf.shards[pos].shape) != shape:
                raise AssertionError(f"{what} {'/'.join(path)} at position "
                                     f"{pos}: {tuple(leaf.shards[pos].shape)}"
                                     f", want {shape}")
            n += 1
    return n


def _replicas_equal(torch, tree, what: str):
    from repro_torch.dist import sharding as SH
    from repro_torch.training.optimizer import tree_leaves
    for path, leaf in tree_leaves(tree):
        if isinstance(leaf, SH.Sharded):
            for _, group in leaf.layout.groups:
                for p in group[1:]:
                    if not _bits_equal(torch, leaf.shards[p].to(
                            leaf.shards[group[0]].device),
                            leaf.shards[group[0]]):
                        raise AssertionError(f"{what}: replicas of "
                                             f"{'/'.join(path)} differ")


def _mesh_train(torch, np, seed: int, card: str, distinct: bool):
    """9b: full-width Mixtral at depth 1 on a (2, 2) mesh: AdamW with 2
    microbatches, 3 steps from seeded params, twice (params and moments
    bit-equal), shard shapes against ``param_specs``/``opt_state_specs``,
    replicas equal after every step, the nll against one device's steps;
    one Adafactor and one int8-compressed step on the mesh."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (DataPipeline, SyntheticCorpus,
                                           SyntheticCorpusConfig)
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import build_model, init_params
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step,
                                                 opt_state_specs)
    cfg = get_config("mixtral-8x7b").replace(num_layers=1)
    pipe = DataPipeline(SyntheticCorpus(SyntheticCorpusConfig(
        vocab_size=cfg.vocab_size)), batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    batches = [pipe.next_batch() for _ in range(4)]
    tcfg = _train_config(torch)
    log(f"  9b train: {cfg.arch_id} full width, num_layers 32 -> 1, "
        f"{cfg.param_count() / 1e9:.2f} B params; AdamW, 2 microbatches, "
        f"batches {TRAIN_BATCH} x {TRAIN_SEQ}")
    params = init_params(cfg, seed, device="cuda")
    step = make_train_step(build_model(cfg).loss_fn, tcfg)
    state = init_train_state(params, tcfg)
    _peak_reset(torch)
    params, state, one = _train_steps(torch, step, params, state,
                                      batches[:3], "9b one device", card)
    del params, state
    _release(torch)
    mesh = make_test_mesh((2, 2), devices=_mesh_devices(4, distinct))
    model = build_model(cfg, mesh)
    step = make_train_step(model.loss_fn, tcfg)
    whole_loss = build_model(cfg).loss_fn
    from repro_torch.launch.train import batch_to
    runs, first, same_params = {}, None, []
    for run in (1, 2):
        _peak_reset(torch)
        params = init_params(cfg, seed, device="cuda")
        specs = SH.param_specs(cfg, mesh, params)
        sp = SH.shard_tree(params, SH.shardings(mesh, specs))
        del params
        state = init_train_state(sp, tcfg)
        n_shards = _check_placement(sp, specs, "params") + _check_placement(
            state, opt_state_specs(specs, tcfg, sp), "AdamW state")
        recs = []
        for i, b in enumerate(batches[:3]):
            if run == 2:        # one device's nll at the mesh's params,
                # over the step's microbatches (the MoE capacity counts a
                # microbatch's tokens)
                whole, n = SH.gather(sp, "cuda:0"), tcfg.num_microbatches
                with torch.no_grad():
                    nll = torch.stack([whole_loss(whole, {
                        k: v.reshape((n, -1) + v.shape[1:])[i]
                        for k, v in batch_to(b, "cuda").items()})[1]["nll"]
                        for i in range(n)]).mean()
                same_params.append(float(nll))
                del whole
                _release(torch)
            sp, state, rec = _train_steps(torch, step, sp, state, [b],
                                          f"9b mesh 2x2 run {run}", card, i)
            _replicas_equal(torch, sp, f"params after step {i}")
            _replicas_equal(torch, state, f"AdamW state after step {i}")
            recs += rec
        runs[run] = recs
        leaves = {k: [s.cpu() for s in SH.distinct(v)] for k, v in
                  _state_leaves(sp, state).items()}
        if run == 1:
            first = leaves
            del sp, state
            _release(torch)
        elif any(not all(_bits_equal(torch, a, b) for a, b in
                         zip(v, first[k])) for k, v in leaves.items()):
            raise AssertionError("9b: two identical mesh runs differ")
        del leaves
    del first
    # each step's nll within 1e-2 of one device's own run (the
    # trajectory: a wrong update on the mesh moves it), of one device's
    # at the mesh's params (the forward), and the first step's gradient
    # norm within 1e-2 of one device's (the backward)
    gaps = [abs(a["nll"] - b["nll"]) for a, b in zip(runs[2], one)]
    held = [abs(a["nll"] - b) for a, b in zip(runs[2], same_params)]
    g0 = abs(runs[2][0]["grad_norm"] - one[0]["grad_norm"]) \
        / one[0]["grad_norm"]
    if max(gaps) > 1e-2 or max(held) > 1e-2 or g0 > 1e-2:
        raise AssertionError(f"9b: mesh nll {[r['nll'] for r in runs[2]]} "
                             f"vs one device {[r['nll'] for r in one]}, "
                             f"at the mesh's params {same_params}; first "
                             f"grad norm gap {g0:.3e}")
    log(f"  9b: {n_shards} shards placed by param_specs/opt_state_specs; "
        f"replicas equal after every step; params, moments and step of the "
        f"two runs bit-equal; nll gaps to one device's own steps "
        f"{[float('%.3e' % g) for g in gaps]}, to one device at the mesh's "
        f"params {[float('%.3e' % g) for g in held]}, first grad norm "
        f"{g0:.3e} of one device's (bar 1e-2 each)")
    del state
    _release(torch)
    af = _train_config(torch, "adafactor")
    sp, _, af_recs = _train_steps(torch, make_train_step(model.loss_fn, af),
                                  sp, init_train_state(sp, af),
                                  [batches[3]], "9b mesh Adafactor", card)
    _replicas_equal(torch, sp, "params after Adafactor")
    _release(torch)
    q8 = _train_config(torch, "adafactor", "int8")
    q8_state = init_train_state(sp, q8)
    _check_placement(q8_state, opt_state_specs(specs, q8, sp),
                     "int8 + Adafactor state")
    sp, q8_state, q8_recs = _train_steps(
        torch, make_train_step(model.loss_fn, q8), sp, q8_state,
        [batches[0]], "9b mesh int8 + Adafactor", card)
    _replicas_equal(torch, q8_state, "int8 residuals")
    del sp, q8_state
    _release(torch)
    return {"one_device": one, "mesh_run1": runs[1], "mesh": runs[2],
            "nll_gaps": gaps, "nll_gaps_same_params": held,
            "grad_norm_gap": g0, "shards_checked": n_shards,
            "adafactor": af_recs, "int8": q8_recs,
            "step_ms": [r["ms"] for r in runs[2]],
            "tokens_per_s": [r["tokens_per_s"] for r in runs[2]],
            "peak_gb": max(r["peak_gb"] for r in runs[2])}


def _mesh_decode(torch, cfg, params, mesh, batch, feed=None):
    """``Model.prefill`` of ``batch`` (tokens (B, S), an enc-dec's
    ``src``) and 4 decode steps with the kernels on, fed ``feed`` (the
    one-device run's greedy tokens) or its own: the logits of each
    forward (f32, host; a split run's sharded logits gathered in rank
    order), the tokens fed, the decode steps' ms and, on a mesh, one more
    decode step counted by ``roofline.op_count`` (its per-position
    argument + peak live GB, and whether it ran split)."""
    from repro_torch.dist import sharding as SH
    from repro_torch.models.model import build_model
    from repro_torch.roofline.op_count import OpCounter

    def whole(lg):
        return lg.full() if isinstance(lg, SH.Sharded) else lg

    tokens = batch["tokens"]
    model = build_model(cfg, mesh, use_kernel=True)
    cache = model.init_cache(tokens.shape[0], 24, device="cuda")
    logits, cache = model.prefill(params, batch, cache)
    out, fed = [whole(logits).float().cpu()], []
    pos = torch.full((tokens.shape[0],), tokens.shape[1], device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(MESH_FORWARDS - 1):
        cur = whole(logits).argmax(-1)[:, None] if feed is None \
            else feed[step]
        fed.append(cur)
        logits, cache = model.decode_step(params, cache, cur, pos + step)
        out.append(whole(logits).float().cpu())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (MESH_FORWARDS - 1)
    counted = None
    if mesh is not None:
        n = len(mesh.devices)
        args = (params, cache, fed[-1], pos + MESH_FORWARDS - 1)
        with OpCounter(n) as c:
            c.place(args)
            lg, _ = model.decode_step(*args)
            torch.cuda.synchronize()
            c.outputs(lg)
        counted = {"split": isinstance(lg, SH.Sharded),
                   "per_position_gb": [g * 2**30 / 1e9 for g in
                                       c.memory()["per_position_gib"]],
                   "per_position_flops": c.cost_summary()[
                       "per_position"]["flops"],
                   "collectives": c.collective_summary()}
    return torch.stack(out), fed, ms, counted


def _mesh_serve(torch, np, seed: int, distinct: bool):
    """9c: ``build_model(cfg, mesh)`` on ``apply_precision_plan(...,
    mesh=)`` at depth 2: prefill of 2 x 8 and 4 decode steps with the
    kernels on over (2, 2) (token-gather) and (1, 16) (TP), fed the
    one-device run's greedy tokens: logits within ``MESH_BAR`` of max
    |logit| and the same greedy ids wherever one device's top-2 margin
    exceeds twice the gap; launches per position; ms per decode step."""
    from repro_torch.core import mixed_moe as mm
    from repro_torch.core.precision_plan import balanced_ladder_plan
    from repro_torch.dist import sharding as SH
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import apply_precision_plan, init_params
    from repro_torch.models.transformer import layer_slice
    cfg = serving_config()
    L, E = cfg.num_layers, cfg.moe.num_experts
    params = init_params(cfg, seed, device="cuda")
    plan = balanced_ladder_plan(
        L, E, {b: n * L for b, n in MESH_BANKS.items() if b < 16},
        ladder=(16, 8, 4), group_size=cfg.mop.group_size)
    tok = torch.from_numpy(np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (2, 8))).to("cuda")
    sp = apply_precision_plan(params, cfg, plan)
    want, feed, ms1, _ = _mesh_decode(torch, cfg, sp, None, {"tokens": tok})
    del sp
    _release(torch)
    top2 = want.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1])
    out = {"one_device_ms_per_decode_step": ms1}
    for name, (shape, regime) in MESH_SERVE.items():
        n = math.prod(shape)
        mesh = make_test_mesh(shape, devices=_mesh_devices(n, distinct))
        _peak_reset(torch)
        t0 = time.perf_counter()
        placed = apply_precision_plan(params, cfg, plan, mesh=mesh)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        par = mm.MoEParallelism(mesh, ("data",), fsdp_axis="data")
        for t in (tok.numel(), tok.shape[0]):           # prefill, decode
            got_regime = mm.moe_regime(
                layer_slice(placed["layers"]["moe"]["banks"], 0), t,
                cfg.d_model, cfg.moe, par)
            if got_regime != regime:
                raise AssertionError(f"9c {name}: {t} tokens take "
                                     f"{got_regime}, not {regime}")
        ops.reset_launches()
        with _PositionLaunches() as book:
            got, _, ms, counted = _mesh_decode(torch, cfg, placed, mesh,
                                               {"tokens": tok}, feed)
        if counted["split"] != SH.splits_dense(cfg, mesh):
            raise AssertionError(f"9c {name}: split {counted['split']}, "
                                 f"the serving rules say "
                                 f"{SH.splits_dense(cfg, mesh)}")
        launches = dict(ops.LAUNCHES)
        _, peak = _mem_gb(torch)
        del placed
        _release(torch)
        book.require(n, MESH_BANKS, f"9c {name}", splits=True)
        scale = float(want.abs().max())
        gap = float((got - want).abs().max())
        same = got.argmax(-1) == want.argmax(-1)
        firm = margin > 2 * gap
        if gap > MESH_BAR * scale or bool((firm & ~same).any()):
            raise AssertionError(f"9c {name}: logits gap {gap:.3e} (bar "
                                 f"{MESH_BAR * scale:.3e}); greedy ids "
                                 f"differ where firm: {(firm & ~same).sum()}")
        rec = {"mesh": list(shape), "regime": regime, "place_s": place_s,
               "logits_gap": gap, "max_logit": scale,
               "greedy_equal": bool(same.all()),
               "ms_per_decode_step": ms, "peak_gb": peak,
               "split": counted["split"],
               "per_position_gb": counted["per_position_gb"],
               "per_position_flops": counted["per_position_flops"],
               "launches_by_position": book.table(),
               # the prefill and each decode step launch alike, so a
               # decode iteration's launches are the run's over its
               # forwards (the counted decode step is one more)
               "path": _path_record(torch, f"9c {name}", launches, {
                   k: v / (MESH_FORWARDS + 1) for k, v in launches.items()})}
        log(f"  9c {name} ({regime}): shards placed in {place_s:.2f} s; "
            f"prefill 2x8 + 4 decode steps, logits within {gap:.3e} of one "
            f"device's (max |logit| {scale:.3f}), greedy ids "
            f"{'equal' if rec['greedy_equal'] else 'equal where firm'}; "
            f"{ms:.2f} ms per decode step (one device {ms1:.2f}); peak "
            f"{peak:.2f} GB")
        log(f"    {'split' if rec['split'] else 'whole'} dense compute; one "
            f"decode step counted on the card: per-position GB (arguments "
            f"+ peak live) {[round(g, 3) for g in rec['per_position_gb']]},"
            f" FLOPs {[f'{f:.3e}' for f in rec['per_position_flops']]}")
        for p, b in rec["launches_by_position"].items():
            log(f"    position {p}: {b}")
        out[name] = rec
    del params
    return out


def _mesh_cli(torch, card: str, distinct: bool):
    """9d: the train CLI at ``--smoke --mesh 2,2`` on four device entries
    with a checkpoint, then ``--resume`` on ``--mesh 1,1``; the elastic
    restore's params bytes equal to the saved ones."""
    import contextlib
    import io
    import shutil
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.dist import sharding as SH
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import abstract_params
    from repro_torch.training.optimizer import tree_leaves
    shutil.rmtree(CLI_CKPT, ignore_errors=True)
    devs = ",".join(_mesh_devices(4, distinct))
    common = ["--arch", "mixtral-8x7b", "--smoke", "--batch", "4", "--seq",
              "32", "--log-every", "1"]
    runs = {}
    try:
        for name, argv in (
                ("mesh 2x2", ["--mesh", "2,2", "--device", devs, "--steps",
                              "4", "--ckpt-every", "2", "--ckpt-dir",
                              str(CLI_CKPT / "a")]),
                ("resume 1x1", ["--mesh", "1,1", "--device", "cuda:0",
                                "--steps", "4", "--resume", "--ckpt-dir",
                                str(CLI_CKPT / "b")])):
            if name.startswith("resume"):
                (CLI_CKPT / "b").mkdir(parents=True)
                shutil.copytree(CLI_CKPT / "a" / "step_2",
                                CLI_CKPT / "b" / "step_2")
                (CLI_CKPT / "b" / "step_2.COMMITTED").touch()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                T.main(common + argv)
            runs[name] = {"s": time.perf_counter() - t0,
                          "lines": buf.getvalue().splitlines()}
            for line in runs[name]["lines"]:
                log(f"    cli {name}: {line}")
        if "[train] resumed from step 2" not in runs["resume 1x1"]["lines"]:
            raise AssertionError("9d: the resume did not restore step 2")
        cfg = reduce_for_smoke(get_config("mixtral-8x7b"))
        one = make_test_mesh((1, 1), devices=["cuda:0"])
        mgr = CheckpointManager(str(CLI_CKPT / "a"))
        saved, _ = mgr.restore(2)
        placed, _ = mgr.restore(2, shardings={"params": SH.param_shardings(
            cfg, one, abstract_params(cfg))})
        flat = dict(tree_leaves(saved["params"]))
        for path, leaf in tree_leaves(placed["params"]):
            if not _bits_equal(torch, leaf.full().cpu(), flat[path]):
                raise AssertionError(f"9d: {'/'.join(path)} restored on "
                                     "(1, 1) differs from the saved bytes")
        log(f"  9d cli: --mesh 2,2 on {devs} ({runs['mesh 2x2']['s']:.2f} "
            f"s), resumed on --mesh 1,1 ({runs['resume 1x1']['s']:.2f} s); "
            f"the elastic restore's {len(flat)} params bit-equal to the "
            "saved ones")
    finally:
        shutil.rmtree(CLI_CKPT, ignore_errors=True)
    return runs


def phase_mesh(torch, np, seed: int, card: str, distinct: bool = False):
    """9: sharded training and MoE over (data, model) meshes, every
    position on ``cuda:0`` (``distinct``: position p on ``cuda:(p %
    cards)``, ``tools/chip_phases.py mesh-cards``)."""
    t0 = time.perf_counter()
    log(f"mesh: (data, model) meshes, positions on "
        f"{'distinct cards' if distinct else 'cuda:0'}")
    out = {"moe": _mesh_moe(torch, np, seed, distinct)}
    _release(torch)
    out["train"] = _mesh_train(torch, np, seed, card, distinct)
    _release(torch)
    out["serve"] = _mesh_serve(torch, np, seed, distinct)
    _release(torch)
    out["cli"] = _mesh_cli(torch, card, distinct)
    out["seconds"] = time.perf_counter() - t0
    log(f"  mesh: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 11: the adaptive engine on a (data, model) mesh that splits the
# dense compute
# --------------------------------------------------------------------------

ENGINE_MESH = (2, 2)
#: the engine configs of 11, each serving the same prompts across one replan
ENGINE_MESH_CONFIGS = {"paged": {}, "slot": {"paged_kv": False},
                       "overlap": {"overlap": True},
                       "speculate": {"speculate": 2}}
#: a router near-tie: a live row's k-th minus (k+1)-th probability below
#: this, where the split's bf16 rounding may pick the other expert
ROUTER_TIE = 2 ** -8


def _pool_bytes(engine):
    """The KV pool's (or slot cache's) bytes held at each mesh position."""
    from repro_torch.dist import sharding as SH
    kv = engine.kv_pool if engine.paged else engine.cache
    n = len(engine.mesh.devices)
    return [sum(v.shards[p].numel() * v.shards[p].element_size()
                for v in kv.values() if isinstance(v, SH.Sharded))
            for p in range(n)]


def _engine_mesh_points(frontier, total):
    """A: the serve phase's rule on the ep = 2 frontier; B: a point with
    every rung and other bank sizes (a bank-split replan), the most
    resident."""
    a = pick_point(frontier, total)
    cand = [p for p in frontier.points
            if p.plan.bank_sizes() != a.plan.bank_sizes()
            and all(c > 0 for c in p.counts_per_rung)]
    if not cand:
        cand = [p for p in frontier.points
                if p.plan.bank_sizes() != a.plan.bank_sizes()]
    if not cand:
        raise AssertionError("11: no second frontier point")
    return a, max(cand, key=lambda p: (p.resident_experts,
                                       -p.num_q_experts))


def phase_engine_mesh(torch, np, seed: int, card: str,
                      distinct: bool = False):
    """11: ``build_engine`` on full-width Mixtral-8x7B (depth 2) over a
    (2, 2) mesh of repeated ``cuda:0`` (``distinct``: position p on
    ``cuda:(p % cards)``), the kernels on, serving the same prompts in
    the paged, slot, overlap and speculative (K = 2) configs across one
    replan A -> B: paged == slot and overlap == sync (every sampled
    logit bit-equal), speculative == plain greedy tokens, a rerun
    bit-equal, the one-device engine's tokens held by 9c's rule
    (``near_ties.hold_tokens``), B3, B4 and split-K launches at
    every position; ms per iteration, tokens/s, peak GB and KV bytes per
    position beside one device's."""
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import init_params
    from repro_torch.serving.api import EngineConfig, build_engine
    from repro_torch.serving.near_ties import EngineRecorder, hold_tokens
    t_phase = time.perf_counter()
    cfg = serving_config()
    total = cfg.num_layers * cfg.moe.num_experts
    n = math.prod(ENGINE_MESH)
    mesh = make_test_mesh(ENGINE_MESH, devices=_mesh_devices(n, distinct))
    if not SH.splits_dense(cfg, mesh):
        raise AssertionError("11: the mesh does not split the dense compute")
    log(f"engine mesh: {cfg.arch_id} depth {cfg.num_layers}, full width, on "
        f"{ENGINE_MESH} of {'distinct cards' if distinct else 'cuda:0'}")
    params = init_params(cfg, seed, device="cuda")
    rng = np.random.default_rng(seed + 11)
    first = [rng.integers(1, cfg.vocab_size, size=16) for _ in range(4)]
    second = [rng.integers(1, cfg.vocab_size, size=16) for _ in range(4)]
    runs, out = {}, {"mesh": list(ENGINE_MESH)}
    points = None

    def serve(name, extra, on_mesh=True, ties=False, rerun=False):
        nonlocal points
        _peak_reset(torch)
        eng = build_engine(cfg, params, EngineConfig(**SERVE_CFG, **extra),
                           **({"mesh": mesh} if on_mesh else
                              {"device": "cuda"}))
        if points is None:
            points = _engine_mesh_points(eng.frontier, total)
        a, b = points
        rec = {"config": name, "mesh": on_mesh}
        with EngineRecorder(eng, ROUTER_TIE if ties else None) as seen, \
                _PositionLaunches() as book:
            eng.apply_frontier_point(a)
            pa = serve_pass(torch, eng, first)
            eng.apply_frontier_point(b)
            pb = serve_pass(torch, eng, second)
        rec.update(tokens=(pa["tokens"], pb["tokens"]), logits=seen.calls,
                   rows=seen.rows, ties=seen.ties, book=book,
                   launches={k: pa["launches"][k] + pb["launches"][k]
                             for k in pa["launches"]},
                   split_launches=pa["split_launches"]
                   + pb["split_launches"],
                   iterations=pa["iterations"] + pb["iterations"],
                   bits=eng.current_plan.bits.copy())
        if rerun:                   # the B traffic again, warm, timed
            r = serve_pass(torch, eng, second)
            rec["warm"] = r
        _, rec["peak_gb"] = _mem_gb(torch)
        if on_mesh:
            rec["kv_bytes_per_position"] = _pool_bytes(eng)
            rec["kv_total_bytes"] = sum(
                v.numel() * v.dtype.itemsize if not isinstance(v, SH.Sharded)
                else math.prod(v.shape) * v.dtype.itemsize
                for v in (eng.kv_pool if eng.paged else eng.cache).values())
            rec["data_ranks"] = eng.kv_meta.data_ranks if eng.paged else None
        eng.close()
        del eng
        _release(torch)
        return rec

    runs["paged"] = serve("paged", {}, ties=True, rerun=True)
    for name in ("slot", "overlap", "speculate"):
        runs[name] = serve(name, ENGINE_MESH_CONFIGS[name])
    one = serve("one device", {}, on_mesh=False, rerun=True)
    a, b = points
    paged = runs["paged"]

    def bit_equal(x, y):
        return len(x) == len(y) and all(_bits_equal(torch, u, v)
                                        for u, v in zip(x, y))

    for name, other in (("slot", runs["slot"]), ("overlap",
                                                 runs["overlap"])):
        if other["tokens"] != paged["tokens"] or \
                not bit_equal(other["logits"], paged["logits"]):
            raise AssertionError(f"11: {name} differs from paged: "
                                 f"{other['tokens']} != {paged['tokens']}")
    if runs["speculate"]["tokens"] != paged["tokens"]:
        raise AssertionError(f"11: speculative tokens "
                             f"{runs['speculate']['tokens']} != plain "
                             f"{paged['tokens']}")
    if paged["warm"]["tokens"] != paged["tokens"][1] or \
            one["warm"]["tokens"] != one["tokens"][1]:
        raise AssertionError("11: a warm rerun gave other tokens")
    if (one["bits"] != paged["bits"]).any():
        raise AssertionError("11: one device serves other bits at B")
    # one device against the split by 9c's rule: over the rows both ran
    # from the same tokens, less those whose own row met a router
    # near-tie, logits within MESH_BAR of max |logit| and greedy ids
    # equal wherever one device's margin exceeds twice the gap
    held = hold_tokens(paged["tokens"][0] + paged["tokens"][1],
                       one["tokens"][0] + one["tokens"][1], paged["rows"],
                       one["rows"], bar=MESH_BAR, exempt=paged["ties"])
    faults = held.faults(min_equal=6)
    if faults:
        raise AssertionError(f"11: the split against one device: "
                             f"{'; '.join(faults)} ({held.summary()})")
    # launches: every position ran B3 (q4, q8), B4 and launches that split
    # K (reduced in their epilogues) on every path
    by_path = {}
    for name, rec in runs.items():
        rec["book"].require(n, {4: 1, 8: 1, 16: 1}, f"11 {name}",
                            splits=True)
        by_path[name] = rec["book"].table()
        require_launches(rec["launches"], f"11 {name}")
        require_split_launches(rec["split_launches"], f"11 {name}")
    shapes = sorted({k for rec in runs.values()
                     for book in rec["book"].by_pos.values() for k in book
                     if k != "split_k"}, key=str)
    kv = paged["kv_bytes_per_position"]
    if len(set(kv)) != 1 or kv[0] * ENGINE_MESH[0] != paged["kv_total_bytes"]:
        raise AssertionError(f"11: KV pool bytes per position {kv}, total "
                             f"{paged['kv_total_bytes']}")
    w, w1 = paged["warm"], one["warm"]
    log(f"  11 points: A {a.summary()} (banks {a.plan.bank_sizes()}), B "
        f"{b.summary()} (banks {b.plan.bank_sizes()}); 8 requests x 16 "
        f"prompt x {MAX_NEW} new tokens across the replan")
    log(f"  11 paged == slot and overlap == sync: {len(paged['logits'])} "
        "sampled logits bit-equal; speculative == plain greedy tokens; "
        "warm rerun equal")
    log(f"  11 one device: {held.summary()}; router near-ties at "
        f"{sorted(paged['ties'])}")
    log(f"  11 {ENGINE_MESH} on {card}: {w['decode_ms_per_iter']:.3f} ms per "
        f"decode iteration, {w['tokens_per_s']:.2f} decode tok/s (one "
        f"device {w1['decode_ms_per_iter']:.3f} ms, "
        f"{w1['tokens_per_s']:.2f} tok/s); peak {paged['peak_gb']:.2f} GB "
        f"(one device {one['peak_gb']:.2f} GB); KV pool "
        f"{kv[0] / 2**20:.3f} MiB per position of "
        f"{paged['kv_total_bytes'] / 2**20:.3f} MiB")
    for name, table in by_path.items():
        books = {}
        for p, book in table.items():
            books.setdefault(json.dumps(book, sort_keys=True), []).append(p)
        for book, where in books.items():
            log(f"    11 {name} launches at positions {where}: {book}")
    for name, rec in runs.items():
        per = {k: v / max(rec["iterations"], 1)
               for k, v in rec["launches"].items()}
        out[name] = {"tokens": rec["tokens"], "peak_gb": rec["peak_gb"],
                     "launches_by_position": by_path[name],
                     "path": _path_record(torch, f"11 {name}",
                                          rec["launches"], per)}
    out.update(points={"A": a.summary(), "B": b.summary()},
               one_device={"tokens": one["tokens"], "peak_gb": one["peak_gb"],
                           "decode_ms_per_iter": w1["decode_ms_per_iter"],
                           "tokens_per_s": w1["tokens_per_s"]},
               warm={"decode_ms_per_iter": w["decode_ms_per_iter"],
                     "tokens_per_s": w["tokens_per_s"],
                     "launches_per_decode_iter":
                     w["launches_per_decode_iter"]},
               parted=held.parted, ties=sorted(paged["ties"]),
               one_device_gap=held.gap, one_device_max_logit=held.scale,
               rows_held=held.held, rows_compared=held.compared,
               kv_bytes_per_position=kv,
               kv_total_bytes=paged["kv_total_bytes"],
               launch_shapes=[list(k) for k in shapes],
               seconds=time.perf_counter() - t_phase)
    del params
    log(f"  engine mesh: {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 10: the roofline's anchor cell, op counts of whole steps
# --------------------------------------------------------------------------

#: the anchor's steps, (seq_len, global batch, kind): one decode step at
#: batch 32 over a 4096-token cache, a prefill of 4 x 2048 tokens, and an
#: AdamW train step of 2 x 256 tokens (two microbatches of one sequence)
ROOFLINE_STEPS = {"decode": (4096, 32, "decode"),
                  "prefill": (2048, 4, "prefill"),
                  "train": (256, 2, "train")}
ROOFLINE_REPS = 3                     # timed runs of each step
DRY_CELL = ("mixtral-8x7b", "decode_32k", False)   # pod16x16


def _anchor_cell(cfg, kind: str, mesh):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import use_mesh
    seq, batch, k = ROOFLINE_STEPS[kind]
    with use_mesh(mesh):
        return D.build_cell(cfg, ShapeConfig(kind, seq, batch, k), mesh)


def _count_diff(real, meta) -> str:
    rows = []
    for name in sorted(set(real.by_op) | set(meta.by_op)):
        a, b = real.by_op.get(name), meta.by_op.get(name)
        if a != b:
            rows.append(f"    {name}: card {a} meta {b}")
    return "\n".join(rows[:20])


def _roofline_step(torch, cfg, kind: str, card: str):
    """One anchor step on a (1, 1) mesh of ``cuda:0``: its op count
    against the same step's on ``meta``, its wall and device time, and the
    share of the card its count's bound makes of them."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    mesh = make_test_mesh((1, 1), devices=["cuda:0"])
    step, args = _anchor_cell(cfg, kind, mesh)
    _peak_reset(torch)
    with use_mesh(mesh):
        out = step(*args)             # warm-up: cuBLAS handles, allocator
        torch.cuda.synchronize()
        del out
        real, count_s = D.count_step(step, args, 1)
        walls = []
        for _ in range(ROOFLINE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            del out
        prof = _profiler(torch)
        with prof:
            out = step(*args)
            torch.cuda.synchronize()
        del out
    peak = _mem_gb(torch)[1]
    del args, step
    _release(torch)
    meta_mesh = make_test_mesh((1, 1), devices=["meta"])
    m_step, m_args = _anchor_cell(cfg, kind, meta_mesh)
    with use_mesh(meta_mesh):
        meta, meta_s = D.count_step(m_step, m_args, 1)
    cost, m_cost = real.cost_summary(), meta.cost_summary()
    same = (real.digest() == meta.digest() and cost == m_cost
            and real.collective_summary() == meta.collective_summary())
    if not same:
        raise AssertionError(f"roofline {kind}: the card's op count differs "
                             f"from meta's\n{_count_diff(real, meta)}")
    wall_ms = sorted(walls)[len(walls) // 2] * 1e3
    busy_ms = _profile_report(prof, wall_ms / 1e3)["busy_ms"]
    bound_ms, bound_by = _bound_ms(cost["bytes_accessed"], cost["flops"])
    seq, batch, _ = ROOFLINE_STEPS[kind]
    rec = {"tokens": seq * batch if kind != "decode" else batch,
           "flops": cost["flops"], "bytes": cost["bytes_accessed"],
           "products": cost["dot_count"], "ops": sum(
               v[0] for v in real.by_op.values()),
           "digest": real.digest(), "meta_equal": same,
           "wall_ms": [w * 1e3 for w in walls], "wall_ms_median": wall_ms,
           "device_busy_ms": busy_ms, "bound_ms": bound_ms,
           "bound_by": bound_by,
           "bound_of_device": bound_ms / busy_ms if busy_ms else None,
           "bound_of_wall": bound_ms / wall_ms,
           "busy_share": busy_ms / wall_ms,
           "counted_s": count_s, "meta_trace_s": meta_s, "peak_gb": peak,
           "memory_meta": meta.memory()}
    log(f"  10 {kind} ({batch} x {seq}) on {card}: {cost['flops']:.4e} "
        f"FLOPs in {cost['dot_count']} products, {cost['bytes_accessed']:.4e}"
        f" bytes over {rec['ops']} ops; card == meta: op sequence, FLOPs, "
        f"bytes and collectives equal")
    shares = (f"{rec['bound_of_device']:.1%} of device time, "
              if busy_ms else "device time not measured (profiler saw none), ")
    log(f"     wall {wall_ms:.3f} ms (median of {ROOFLINE_REPS}: "
        f"{', '.join(f'{w * 1e3:.3f}' for w in walls)}), device busy "
        f"{busy_ms:.3f} ms ({rec['busy_share']:.1%} of wall); bound "
        f"{bound_ms:.3f} ms ({bound_by}): {shares}"
        f"{rec['bound_of_wall']:.1%} of wall; peak {peak:.2f} GB; host "
        f"{count_s:.2f} s counted on the card, {meta_s:.2f} s on meta")
    return rec


MESH_COUNT = (2, 2)                   # the split decode counted in 10


def _mesh_count(torch, cfg, card: str, shape=None, what: str = "10"):
    """The anchor decode step (or the dry-run cell of ``shape``, a
    ``ShapeConfig``) on a (2, 2) mesh of repeated ``cuda:0``, the dense
    compute split over it: its op count on the card against the same
    step's on a (2, 2) mesh of ``meta`` (op sequence, FLOPs, bytes and
    collectives equal), with each position's FLOPs and argument + peak
    bytes."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_test_mesh, use_mesh
    from repro_torch.models.model import abstract_params
    n = math.prod(MESH_COUNT)
    counts = {}
    for where in ("cuda:0", "meta"):
        mesh = make_test_mesh(MESH_COUNT, devices=[where] * n)
        if shape is None:
            step, args = _anchor_cell(cfg, "decode", mesh)
        else:           # the abstract tree's shapes on both sides
            with use_mesh(mesh):
                step, args = D.build_cell(cfg, shape, mesh, D._like(
                    abstract_params(cfg), mesh.devices[0]))
        with use_mesh(mesh):
            counts[where], _ = D.count_step(step, args, n)
        del step, args
        _release(torch)
    real, meta = counts["cuda:0"], counts["meta"]
    same = (real.digest() == meta.digest()
            and real.cost_summary() == meta.cost_summary()
            and real.collective_summary() == meta.collective_summary())
    if not same:
        raise AssertionError(f"{what} decode on {MESH_COUNT}: the card's "
                             f"op count differs from meta's\n"
                             f"{_count_diff(real, meta)}")
    cost, coll, mem = (real.cost_summary(), real.collective_summary(),
                       real.memory())
    flops = cost["per_position"]["flops"]
    rec = {"mesh": list(MESH_COUNT), "digest": real.digest(),
           "meta_equal": same, "per_position_flops": flops,
           "per_position_gib": mem["per_position_gib"],
           "meta_per_position_gib": meta.memory()["per_position_gib"],
           "all_reduce_count": coll["all-reduce_count"],
           "all_gather_count": coll["all-gather_count"],
           "collective_bytes": coll["total_bytes"]}
    log(f"  {what} decode on {MESH_COUNT} of cuda:0 ({card}), dense "
        f"compute split: card == meta: op sequence, FLOPs, bytes and "
        f"collectives "
        f"equal; per-position FLOPs {[f'{f:.4e}' for f in flops]}, "
        f"GiB {[round(g, 3) for g in mem['per_position_gib']]}; "
        f"{coll['all-reduce_count']} all-reduces, "
        f"{coll['all-gather_count']} all-gathers")
    return rec


def phase_roofline(torch, np, seed: int, card: str):
    """10: full-width Mixtral at the serve depth on a (1, 1) mesh of
    ``cuda:0``, ``use_kernel=False`` (the dry run's program): decode,
    prefill and train step counted by ``roofline.op_count`` on the card
    and on ``meta``, timed, and held against their count's bound."""
    from repro_torch.roofline.op_count import OpCounter
    t0 = time.perf_counter()
    cfg = serving_config()
    log(f"roofline: {cfg.arch_id} depth {cfg.num_layers}, (1, 1) mesh of "
        f"cuda:0, use_kernel=False")
    with OpCounter(1):            # the dispatch mode's one-time imports
        torch.ones(1, device="cuda:0").add(1)
    out = {kind: _roofline_step(torch, cfg, kind, card)
           for kind in ROOFLINE_STEPS}
    out["decode 2x2"] = _mesh_count(torch, cfg, card)
    out["seconds"] = time.perf_counter() - t0
    log(f"  roofline: {out['seconds']:.1f} s")
    return out


def phase_dry_cell(torch):
    """10: one dry-run cell through ``launch.dryrun.run_cell`` on the
    card's host (meta tensors, the production mesh, no device work)."""
    from repro_torch.launch import dryrun as D
    arch, shape, multi_pod = DRY_CELL
    rec = D.run_cell(arch, shape, multi_pod, save=False)
    if not rec["ok"]:
        raise AssertionError(f"dry run {arch} {shape}: {rec['error']}")
    log(f"  10 dry run {arch} {shape} {rec['mesh']}: trace_s "
        f"{rec['trace_s']} (host), build_s {rec['build_s']}, peak "
        f"{rec['memory']['peak_per_device_gib']:.2f} GiB at position "
        f"{rec['memory']['position']}, {rec['cost']['flops']:.4e} FLOPs at "
        f"the busiest position, collectives "
        f"{rec['collectives']['total_bytes']:.4e} B")
    return rec


# --------------------------------------------------------------------------
# phase 7a: the paper's serving under load (Poisson arrivals, QoS loop)
# --------------------------------------------------------------------------

POISSON_REQUESTS, POISSON_GAP_S = 16, 0.01   # ~one warm decode iteration
POISSON_CFG = dict(SERVE_CFG, max_len=64)    # 32 prompt + 24 new tokens


def _poisson_traffic(slo_cls):
    """drive_poisson's samplers: prompts of 8-32 tokens, 8-24 new
    tokens, two priorities."""
    return dict(n_requests=POISSON_REQUESTS, mean_gap_s=POISSON_GAP_S,
                prompt_len=lambda r: int(r.integers(8, 33)),
                max_new_tokens=lambda r: int(r.integers(8, 25)),
                slo=lambda r: slo_cls(priority=int(r.integers(2)),
                                      deadline_s=30.0))


def _record_submits(engine):
    """Wrap ``engine.submit``: the (rid, prompt, max_new_tokens, slo) of
    every submission, in order."""
    subs = []
    submit = engine.submit

    def spy(prompt, **kw):
        rid = submit(prompt, **kw)
        subs.append((rid, prompt, kw["max_new_tokens"], kw.get("slo")))
        return rid
    engine.submit = spy
    return subs


def _split_target(fr, target, plan):
    """The largest lower budget whose selected point splits the banks
    otherwise than ``plan``: (target, point)."""
    import dataclasses
    for b in sorted({p.qos.device_bytes for p in fr.points
                     if p.qos.device_bytes < target.mem_budget_bytes},
                    reverse=True):
        t = dataclasses.replace(target, mem_budget_bytes=b)
        p = fr.select(t)
        if p.plan.bank_sizes() != plan.bank_sizes():
            return t, p
    raise RuntimeError("no lower budget splits the banks otherwise")


def _all_finished(engine, subs, what):
    for rid, _, n, _ in subs:
        req = engine.done.get(rid)
        if req is None or len(req.out_tokens) != n:
            raise AssertionError(f"{what}: request {rid} did not finish "
                                 f"with its {n} tokens")


def phase_poisson(torch, np, ctx, card: str, seed: int):
    """7a: ``drive_poisson`` against the default paged engine with the
    kernels on and a QoSController stepped between decode iterations:
    16 open-loop requests on exponential arrival clocks, the tail left in
    flight (``drain=False``), then a lower memory budget that splits the
    banks with requests in flight, then a drain. Every submitted request
    finishes with its ``max_new_tokens``, each rung bank of the final plan
    launched, the replans' ``reconfig_s`` and ``drain_s`` recorded. Then
    a fixed-plan pass (no controller) whose greedy tokens equal those of
    the same prompts submitted all at once to a fresh engine."""
    import math
    from repro_torch.core.pareto import QoSTarget
    from repro_torch.kernels import ops
    from repro_torch.serving.api import (EngineConfig, RequestSLO,
                                         build_engine)
    from repro_torch.serving.driver import drive_poisson
    from repro_torch.serving.qos import QoSController, QoSControllerConfig
    cfg, params = ctx["cfg"], ctx["params"]
    total = cfg.num_layers * cfg.moe.num_experts
    engine = build_engine(cfg, params, EngineConfig(**POISSON_CFG),
                          device="cuda")
    fr = engine.frontier
    start = pick_point(fr, total)
    ctl = QoSController(engine, config=QoSControllerConfig(
        window_iterations=2, min_dwell_iterations=4))
    track = _Tracker(torch, engine)
    target = QoSTarget(min_tokens_per_s=math.inf,
                       mem_budget_bytes=start.qos.device_bytes)
    log(f"poisson: {POISSON_REQUESTS} requests, mean gap {POISSON_GAP_S} "
        f"s, prompts 8-32, 8-24 new tokens, priorities 0/1; "
        f"EngineConfig({POISSON_CFG}); adopt [{target.describe()}] at "
        f"{start.summary()}")
    ctl.adopt(target, start)
    subs = _record_submits(engine)
    engine.reset_counters()
    ops.reset_launches()
    rng = np.random.default_rng(seed + 2)
    traffic = _poisson_traffic(RequestSLO)
    t0 = time.perf_counter()
    rids = drive_poisson(engine, rng, **traffic, on_iteration=ctl.step,
                         drain=False)
    # the last arrivals may still wait in the queue with every slot
    # free: admit them, so that the drop finds requests in their slots
    while not engine.scheduler.num_active and engine.has_work():
        engine.run_iteration()
        ctl.step()
    in_flight = engine.scheduler.num_active
    if in_flight == 0:
        raise AssertionError("no request in flight at the budget drop")
    queued = len(engine.queue)
    drop, point = _split_target(fr, ctl.target, engine.current_plan)
    replans0 = ctl.metrics["replans"]
    ctl.set_target(drop)
    rec = track.replans[-1]
    if rec["kind"] != "bank-split" or rec["drain_s"] <= 0:
        raise AssertionError(f"the budget drop did not drain into a bank "
                             f"split: {rec}")
    log(f"  budget drop to {drop.mem_budget_bytes / 1e9:.3f} GB with "
        f"{in_flight} request(s) decoding and {queued} queued "
        f"-> {point.summary()}")
    drive_poisson(engine, rng, **dict(traffic, n_requests=0),
                  on_iteration=ctl.step, drain=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    track.unwrap()
    del engine.submit
    if [s[0] for s in subs] != rids or len(rids) != POISSON_REQUESTS:
        raise AssertionError(f"submitted {len(rids)} rids, recorded "
                             f"{len(subs)}")
    _all_finished(engine, subs, "poisson")
    if ctl.metrics["replans"] != replans0 + 1:
        raise AssertionError("the controller replanned after the drop")
    final = _bank_keys(engine.current_plan)
    served = track.plans[-1][1]
    missing = [k for k in final if served[k] <= 0]
    if missing:
        raise AssertionError(f"final plan banks {missing} never launched")
    track.require_bank_launches()
    m = engine.metrics
    lat = engine.latency_percentiles()
    out = {"wall_s": wall, "tokens": m["tokens_generated"],
           "iterations": m["iterations"],
           "tokens_per_s": engine.throughput_tokens_per_s(),
           "wall_tokens_per_s": m["tokens_generated"] / wall,
           "latency_p50_s": lat["p50"], "latency_p95_s": lat["p95"],
           "replans": track.replans, "controller": dict(ctl.metrics),
           "in_flight_at_drop": in_flight, "queued_at_drop": queued,
           "launches": dict(ops.LAUNCHES),
           "launches_per_decode_iter": {
               k: v / max(m["iterations"], 1)
               for k, v in ops.LAUNCHES.items()},
           "bank_launches": [{f"{k}@G={g}": v for (k, g), v in c.items()}
                             for _, c in track.plans]}
    log(f"  {len(rids)} requests, {m['tokens_generated']} tokens in "
        f"{wall:.2f} s ({m['iterations']} iterations): "
        f"{out['tokens_per_s']:.2f} tok/s over decode, "
        f"{out['wall_tokens_per_s']:.2f} tok/s over the wall; latency "
        f"p50 {lat['p50'] * 1e3:.1f} ms, p95 {lat['p95'] * 1e3:.1f} ms; "
        f"{ctl.metrics['replans']} replans ({len(track.replans)} applied "
        f"plans); launches by plan {out['bank_launches']}")
    fixed = ctl.point
    engine.close()
    del engine, ctl, track
    _release(torch)
    out["fixed_plan"] = _poisson_vs_all_at_once(torch, np, cfg, params,
                                                fixed, seed)
    return out


def _poisson_vs_all_at_once(torch, np, cfg, params, point, seed: int):
    """The same Poisson traffic on a fixed plan (no controller), and its
    prompts submitted all at once to a fresh engine: equal greedy
    tokens, request by request (decode rows do not depend on which other
    requests share the batch)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.api import (EngineConfig, RequestSLO,
                                         build_engine)
    from repro_torch.serving.driver import drive_poisson
    engine = build_engine(cfg, params, EngineConfig(**POISSON_CFG),
                          device="cuda")
    engine.apply_frontier_point(point)
    subs = _record_submits(engine)
    ops.reset_launches()
    t0 = time.perf_counter()
    drive_poisson(engine, np.random.default_rng(seed + 3),
                  **_poisson_traffic(RequestSLO), on_iteration=None)
    wall = time.perf_counter() - t0
    _all_finished(engine, subs, "fixed-plan poisson")
    require_launches(ops.LAUNCHES, "fixed-plan poisson",
                     [k for k, _ in _bank_keys(engine.current_plan)])
    got = [engine.done[rid].out_tokens for rid, *_ in subs]
    iters = engine.metrics["iterations"]
    engine.close()
    del engine
    _release(torch)
    batch = build_engine(cfg, params, EngineConfig(**POISSON_CFG),
                         device="cuda")
    batch.apply_frontier_point(point)
    rids = [batch.submit(p, max_new_tokens=n, slo=slo)
            for _, p, n, slo in subs]
    batch.step()
    want = [batch.result(r).tokens for r in rids]
    b_iters = batch.metrics["iterations"]
    batch.close()
    del batch
    _release(torch)
    diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if diff:
        raise AssertionError(f"fixed-plan Poisson tokens differ from the "
                             f"all-at-once run for requests {diff}: "
                             f"{[got[i] for i in diff]} vs "
                             f"{[want[i] for i in diff]}")
    log(f"  fixed plan {point.summary()}: {len(subs)} Poisson requests in "
        f"{wall:.2f} s ({iters} iterations) and the same prompts all at "
        f"once ({b_iters} iterations) give equal greedy tokens")
    return {"wall_s": wall, "iterations": iters,
            "all_at_once_iterations": b_iters, "tokens": got}


def phase_cli(torch, np, card: str):
    """3h: ``repro_torch.launch.serve.main`` in process at ``--smoke``:
    ``--calibrate``; serving with that profile, ``--ladder 16,8,4`` and
    ``--dynamic-precision``; a two-tenant ``--tenants`` spec. Each run
    returns normally and prints its target and summary lines. The
    kernels' launch counters are zeroed just before each run and read
    just after it: every engine the CLI built runs the kernels, and each
    rung bank of its final plan was launched."""
    import contextlib
    import io
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(parents=True, exist_ok=True)
    prof = out_dir / "sensitivity_profile_smoke.json"
    spec = out_dir / "tenants_smoke.json"
    spec.write_text(json.dumps({"budget_fracs": [0.6, 0.45], "tenants": [
        {"name": "chat", "min_tps": None, "weight": 2.0, "priority": 1,
         "deadline_s": 30.0, "requests": 2},
        {"name": "batch", "max_ppl_x": 1.1, "requests": 2}]}))
    dev = ["--device", "cuda"]
    runs = [
        ("calibrate", dev + ["--ladder", "16,8,4", "--calibrate",
                             "--calibrate-out", str(prof)],
         ["[serve] sensitivity profile ->"]),
        ("profile+dynamic", dev + [
            "--ladder", "16,8,4", "--profile", str(prof),
            "--dynamic-precision", "--temperature", "0", "--requests", "4",
            "--max-new-tokens", "8"],
         ["[serve] ep=1 dp=1 target[", "[serve] plan[",
          "[serve] dynamic precision:", "tokens=["]),
        ("tenants", dev + ["--tenants", str(spec), "--temperature", "0",
                           "--max-new-tokens", "4", "--overlap", "on"],
         ["[serve] phase 0", "[serve] phase 1", "[serve] multi-tenant:"]),
    ]
    out = {}
    built = []
    build_engine = serve.build_engine

    def build_and_keep(*a, **kw):
        built.append(build_engine(*a, **kw))
        return built[-1]

    serve.build_engine = build_and_keep
    try:
        for name, argv, need in runs:
            buf = io.StringIO()
            built.clear()
            ops.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                serve.main(argv)
            secs = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            text = buf.getvalue()
            missing = [n for n in need if n not in text]
            if missing:
                raise AssertionError(f"serve CLI {name}: no {missing} line "
                                     f"in:\n{text}")
            log(f"cli {name} ({secs:.2f} s): python -m "
                f"repro_torch.launch.serve {' '.join(argv)}")
            for ln in text.splitlines():
                log(f"    {ln}")
            if not all(e.use_kernel for e in built):
                raise AssertionError(f"serve CLI {name}: an engine on the "
                                     "card runs without the kernels")
            banks = sorted({k for e in built
                            for k, _ in _bank_keys(e.current_plan)})
            if built:
                require_launches(launches, f"cli {name}", banks)
            log(f"    {len(built)} engine(s), kernels on; launches "
                f"{launches}")
            out[name] = {"seconds": secs, "lines": text.splitlines(),
                         "engines": len(built), "launches": launches}
    finally:
        serve.build_engine = build_engine
    alive = _xfer_threads()
    if alive:
        raise AssertionError(f"expert-xfer threads alive after the CLI: "
                             f"{alive}")
    return out


def _profiler(torch):
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _profile_report(prof, wall_s: float):
    """Device time by kernel over the profiled pass, and its share of the
    unprofiled pass's wall time (the profiler slows the host)."""
    rows = []
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue                 # host ops: their kernels are own rows
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    log(f"  profile: device busy {busy_ms:.3f} ms of {wall_s * 1e3:.3f} ms "
        f"wall ({busy_ms / (wall_s * 1e3):.1%})")
    for key, ms, count in rows[:15]:
        log(f"    {ms:9.3f} ms  x{count:<5d} {key[:90]}")
    return {"busy_ms": busy_ms, "wall_ms": wall_s * 1e3,
            "top": [{"name": k, "ms": ms, "count": c}
                    for k, ms, c in rows[:25]]}


def _leaves(tree):
    """Tensors of a tree (QTensors as codes and scales), keys sorted."""
    from repro_torch.core.quantization import QTensor
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, QTensor):
        yield tree.q
        yield tree.scales
    elif tree is not None:
        yield tree


# --------------------------------------------------------------------------
# phase 6: training on the card, checkpoint -> serve, the train CLI
# --------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 4, 128          # 6a: batches from DataPipeline
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"   # gitignored, removed after


def _train_config(torch, optimizer="adamw", compression=None):
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import TrainConfig
    return TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=1),
                       optimizer=optimizer, num_microbatches=2,
                       grad_dtype=torch.bfloat16,
                       grad_compression=compression)


def _train_steps(torch, step_fn, params, state, batches, what, card,
                 start: int = 0):
    """Run ``step_fn`` over ``batches`` on the card (steps numbered from
    ``start``); each step's ms, tokens/s, nll and grad norm, and the peak
    memory since the reset."""
    from repro_torch.launch.train import batch_to
    recs = []
    for i, b in enumerate(batches, start):
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch_to(b, "cuda"))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rec = {"ms": dt * 1e3, "tokens_per_s": b["tokens"].size / dt,
               "nll": float(m["nll"]), "grad_norm": float(m["grad_norm"]),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if not math.isfinite(rec["nll"]):
            raise AssertionError(f"{what} step {i}: nll {rec['nll']}")
        recs.append(rec)
        log(f"  {what} step {i} on {card}: {rec['ms']:.1f} ms, "
            f"{rec['tokens_per_s']:.1f} tokens/s, nll {rec['nll']:.4f}, "
            f"grad norm {rec['grad_norm']:.3f}, peak {rec['peak_gb']:.2f} "
            "GB")
    return params, state, recs


def _state_leaves(params, state):
    from repro_torch.training.optimizer import tree_leaves
    return dict(tree_leaves({"params": params, "opt": state}))




def _grads_card_vs_cpu(torch, np, seed: int, arch: str = "mixtral-8x7b"):
    """The smoke model of ``arch`` at float32: loss and every gradient
    leaf of ``value_and_grad`` on the card against the CPU's, at the CPU
    tests' bars (loss 1e-5 relative, each leaf 1e-4 x max|g_cpu|)."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models.model import build_model, init_params
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_loop import value_and_grad
    cfg = reduce_for_smoke(get_config(arch)).replace(dtype="float32")
    params = init_params(cfg, seed, device="cpu")
    batch = _smoke_batch(torch, np, cfg, np.random.default_rng(seed), 4, 16)
    fn = build_model(cfg).loss_fn
    out = {dev: value_and_grad(fn, _to(params, torch, dev),
                               _to(batch, torch, dev))
           for dev in ("cpu", "cuda")}
    (lc, _, gc), (lg, _, gg) = out["cpu"], out["cuda"]
    rel = abs(float(lg) - float(lc)) / abs(float(lc))
    worst = 0.0
    cpu = dict(tree_leaves(gc))
    for path, g in tree_leaves(gg):
        ref = cpu[path]
        bar = 1e-4 * float(ref.abs().max())
        err = float((g.cpu() - ref).abs().max())
        if err > bar:
            raise AssertionError(f"gradient {'/'.join(path)}: card vs CPU "
                                 f"{err:.3e} > bar {bar:.3e}")
        worst = max(worst, err / max(float(ref.abs().max()), 1e-30))
    if rel > 1e-5:
        raise AssertionError(f"smoke loss card {float(lg)} vs CPU "
                             f"{float(lc)}: {rel:.2e} relative > 1e-5")
    log(f"  card vs CPU ({arch} smoke, float32): loss {float(lg):.6f} vs "
        f"{float(lc):.6f} ({rel:.2e} relative, bar 1e-5); largest "
        f"gradient leaf difference {worst:.2e} of its max|g| (bar 1e-4)")
    return {"loss_rel": rel, "grad_worst_rel": worst}


def _smoke_batch(torch, np, cfg, rng, b: int, s: int):
    """A CPU batch of ``s`` positions from ``rng``: text tokens and labels
    (after a vision frontend's ``frontend_len`` patches, which count), and
    the frontend's patches or an enc-dec ``src`` of ``frontend_len``
    frames, in the model's dtype."""
    vision = cfg.frontend == "vision"
    n_text = s - (cfg.frontend_len if vision else 0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, n_text)))
             for k in ("tokens", "labels")}
    dtype = getattr(torch, cfg.dtype)
    for key, on in (("frontend", vision), ("src", cfg.family == "encdec")):
        if on:
            batch[key] = torch.as_tensor(rng.standard_normal(
                (b, cfg.frontend_len, cfg.d_model)).astype(np.float32)).to(
                dtype)
    return batch


def _codes_card_vs_cpu(torch, grads, ef):
    """``quantize_grad`` of each leaf's corrected gradient g + ef on the
    card and on the CPU from the same f32 bytes: codes, scales and the
    residual byte-equal (a Python-scalar divisor on the card would not
    give the CPU's scale)."""
    from repro_torch.training.compression import quantize_grad
    from repro_torch.training.optimizer import tree_leaves
    ef = dict(tree_leaves(ef))
    n = 0
    for path, g in tree_leaves(grads):
        corrected = g.to(torch.float32) + ef[path]
        out = {}
        for dev, x in (("cuda", corrected), ("cpu", corrected.cpu())):
            q, s = quantize_grad(x)
            out[dev] = [q.cpu(), s.cpu(), (x - q.to(torch.float32) * s)
                        .cpu()]
        for name, a, b in zip(("codes", "scale", "residual"), out["cuda"],
                              out["cpu"]):
            if not _bits_equal(torch, a, b):
                raise AssertionError(f"int8 {name} of {'/'.join(path)} on "
                                     "the card differ from the CPU's")
        n += corrected.numel()
        del corrected, out
    log(f"  int8 compression: codes, scales and residuals of {n:,} "
        "gradient values byte-equal to the CPU's on the same f32 inputs")
    return n


def _step_split(torch, loss_fn, tcfg, params, state, batch, card):
    """Where an AdamW step's time goes: the forward and backward of one
    microbatch, and the optimizer update, each timed alone."""
    from repro_torch.launch.train import batch_to
    from repro_torch.training.optimizer import adamw_update
    from repro_torch.training.train_loop import value_and_grad
    micro = {k: v[:TRAIN_BATCH // 2] for k, v in
             batch_to(batch, "cuda").items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, grads = value_and_grad(loss_fn, params, micro)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adamw_update(params, grads, state, tcfg.opt)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = {"fwd_bwd_ms_per_microbatch": (t1 - t0) * 1e3,
           "adamw_update_ms": (t2 - t1) * 1e3}
    log(f"  step split on {card}: forward + backward of one microbatch "
        f"{out['fwd_bwd_ms_per_microbatch']:.1f} ms, AdamW update "
        f"{out['adamw_update_ms']:.1f} ms")
    return out


def phase_train(torch, np, seed: int, card: str):
    """6a: the full-width 2-layer Mixtral trains on the card: AdamW with 2
    microbatches, 3 steps from seeded params, twice (bit-equal params and
    moments), 5 more steps on one fixed batch (nll falls); smoke-size
    gradients against the CPU's; one Adafactor step; two int8-compressed
    steps with the codes held against the CPU's. Returns the record and
    the trained params (for 6b)."""
    from repro_torch.data.pipeline import (DataPipeline, SyntheticCorpus,
                                           SyntheticCorpusConfig)
    from repro_torch.launch.train import batch_to
    from repro_torch.models.model import build_model, init_params
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step,
                                                 value_and_grad)
    cfg = serving_config()
    alloc, _ = _mem_gb(torch)
    _peak_reset(torch)
    log(f"train: {cfg.arch_id} full width, num_layers 32 -> "
        f"{cfg.num_layers}, {cfg.param_count() / 1e9:.2f} B params; "
        f"AdamW, 2 microbatches, batches {TRAIN_BATCH} x {TRAIN_SEQ}; "
        f"card memory before: {alloc:.2f} GB allocated")
    pipe = DataPipeline(SyntheticCorpus(SyntheticCorpusConfig(
        vocab_size=cfg.vocab_size)), batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    batches = [pipe.next_batch() for _ in range(5)]
    loss_fn = build_model(cfg).loss_fn
    tcfg = _train_config(torch)
    step_fn = make_train_step(loss_fn, tcfg)
    recs = {}
    for run in (1, 2):
        params = init_params(cfg, seed, device="cuda")
        state = init_train_state(params, tcfg)
        params, state, recs[run] = _train_steps(
            torch, step_fn, params, state, batches[:3], f"AdamW run {run}",
            card)
        if run == 1:                  # held on the host while run 2 runs
            first = {k: v.cpu() for k, v in
                     _state_leaves(params, state).items()}
            del params, state
            _release(torch)
    diff = [k for k, v in _state_leaves(params, state).items()
            if not _bits_equal(torch, v.cpu(), first[k])]
    del first
    if diff:
        raise AssertionError(f"two identical AdamW runs differ in {diff}")
    log(f"  determinism: params, moments and step of the two runs "
        f"bit-equal ({len(_state_leaves(params, state))} leaves)")
    fixed = [batches[3]] * 5
    params, state, fixed_recs = _train_steps(
        torch, step_fn, params, state, fixed, "AdamW fixed batch", card)
    nlls = [r["nll"] for r in fixed_recs]
    if not nlls[-1] < nlls[0]:
        raise AssertionError(f"nll does not fall on a fixed batch: {nlls}")
    split = _step_split(torch, loss_fn, tcfg, params, state, batches[3],
                        card)
    del state
    _release(torch)
    grads_rec = _grads_card_vs_cpu(torch, np, seed)
    af = _train_config(torch, "adafactor")
    params, _, af_recs = _train_steps(
        torch, make_train_step(loss_fn, af), params,
        init_train_state(params, af), [batches[4]], "Adafactor", card)
    _release(torch)
    q8 = _train_config(torch, "adafactor", "int8")
    q8_state = init_train_state(params, q8)
    q8_step = make_train_step(loss_fn, q8)
    params, q8_state, q8_recs = _train_steps(
        torch, q8_step, params, q8_state, [batches[0]], "int8 + Adafactor",
        card)
    micro = {k: v[:TRAIN_BATCH // 2] for k, v in
             batch_to(batches[1], "cuda").items()}
    _, _, grads = value_and_grad(loss_fn, params, micro)
    n_codes = _codes_card_vs_cpu(torch, grads, q8_state["ef"])
    del grads
    params, q8_state, more = _train_steps(
        torch, q8_step, params, q8_state, [batches[1]], "int8 + Adafactor",
        card)
    del q8_state
    _release(torch)
    alloc, peak = _mem_gb(torch)
    log(f"  card memory after: {alloc:.2f} GB allocated (the trained "
        f"params), peak {peak:.2f} GB during the phase")
    adamw = recs[2]
    out = {"adamw": adamw, "adamw_run1": recs[1], "fixed_batch": fixed_recs,
           "adafactor": af_recs, "int8": q8_recs + more,
           "card_vs_cpu": grads_rec, "int8_values_checked": n_codes,
           "step_split": split,
           "peak_gb": peak, "card": card,
           "step_ms": [r["ms"] for r in adamw],
           "tokens_per_s": [r["tokens_per_s"] for r in adamw]}
    return out, {"cfg": cfg, "params": params, "steps": 3 + 5 + 1 + 2}


def _cli_tokens(engines):
    """Every request's tokens of the engines a CLI run built, by id."""
    return [(rid, list(e.result(rid).tokens)) for e in engines
            for rid in sorted(e.done)]


def phase_ckpt_serve(torch, np, trained, card: str):
    """6b: 6a's trained params saved by the port's ``CheckpointManager``,
    then ``repro_torch.launch.serve.main`` in process with ``--ckpt-dir``
    on the full-width 2-layer config at ``--ladder 16,8,4 --max-ppl-x
    1.04``: its restore timed and held bit-equal to the saved params, B3/
    B4 launched for each rung bank of its final plan, and the same greedy
    tokens as the same CLI run on the in-memory trained params."""
    import contextlib
    import io
    import shutil
    from repro_torch.ft.checkpoint import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg, params = trained["cfg"], trained["params"]
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    t0 = time.perf_counter()
    CheckpointManager(str(CKPT_DIR), keep=1).save(
        trained["steps"], {"params": params},
        extra={"step": trained["steps"]}, block=True)
    save_s = time.perf_counter() - t0
    size = (CKPT_DIR / f"step_{trained['steps']}" / "tree.msgpack.zst") \
        .stat().st_size
    log(f"ckpt: {nbytes / 1e9:.2f} GB of trained params -> {size / 1e9:.2f}"
        f" GB file; save {save_s:.2f} s ({nbytes / 1e9 / save_s:.3f} GB/s: "
        f"host snapshot, parallel zlib, write) on {card}")
    argv = ["--device", "cuda", "--no-smoke", "--ladder", "16,8,4",
            "--max-ppl-x", "1.04", "--temperature", "0", "--requests", "4",
            "--max-new-tokens", str(MAX_NEW)]
    built, restores = [], []
    real = (serve.get_config, serve.build_engine, serve.init_params,
            CheckpointManager.restore)

    def build_and_keep(*a, **kw):
        built.append(real[1](*a, **kw))
        return built[-1]

    def timed_restore(self, *a, **kw):
        t0 = time.perf_counter()
        tree, manifest = real[3](self, *a, **kw)
        torch.cuda.synchronize()
        restores.append(time.perf_counter() - t0)
        if not _params_equal(torch, tree["params"], params):
            raise AssertionError("restored params differ from the saved")
        return tree, manifest

    serve.get_config = lambda arch: cfg          # depth cut to 2 layers
    serve.build_engine = build_and_keep
    CheckpointManager.restore = timed_restore
    runs = {}
    try:
        for name, extra in (("--ckpt-dir", ["--ckpt-dir", str(CKPT_DIR)]),
                            ("in-memory params", [])):
            if not extra:
                serve.init_params = lambda *a, **kw: params
            buf = io.StringIO()
            built.clear()
            ops.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                serve.main(argv + extra)
            secs = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            text = buf.getvalue()
            if extra and f"[serve] restored params from {CKPT_DIR}" \
                    not in text:
                raise AssertionError(f"serve CLI did not restore: {text}")
            if not all(e.use_kernel for e in built):
                raise AssertionError("a CLI engine runs without the kernels")
            banks = sorted({k for e in built
                            for k, _ in _bank_keys(e.current_plan)})
            require_launches(launches, f"cli {name}", banks)
            runs[name] = {"seconds": secs, "launches": launches,
                          "banks": banks, "tokens": _cli_tokens(built),
                          "lines": text.splitlines()}
            log(f"  cli {name} ({secs:.2f} s): python -m "
                f"repro_torch.launch.serve {' '.join(argv + extra)}")
            for ln in text.splitlines():
                log(f"    {ln}")
            log(f"    launches {launches} (rung banks {banks})")
    finally:
        (serve.get_config, serve.build_engine, serve.init_params,
         CheckpointManager.restore) = real
        built.clear()
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    if len(restores) != 1:
        raise AssertionError(f"{len(restores)} restores, expected 1")
    restore_s = restores[0]
    rate = nbytes / 1e9 / restore_s
    log(f"  the CLI's restore: {restore_s:.2f} s ({rate:.3f} GB/s: read, "
        "one inflate thread, decode, copy to the card); restored params "
        "bit-equal to the saved ones")
    got, want = runs["--ckpt-dir"]["tokens"], \
        runs["in-memory params"]["tokens"]
    if got != want or len(got) != 4:
        raise AssertionError(f"--ckpt-dir tokens {got} != in-memory "
                             f"params' {want}")
    log("  --ckpt-dir serves the trained params: greedy tokens of all 4 "
        "requests equal to the in-memory params' run")
    return {"params_gb": nbytes / 1e9, "file_gb": size / 1e9,
            "save_s": save_s, "restore_s": restore_s,
            "save_gb_per_s": nbytes / 1e9 / save_s,
            "restore_gb_per_s": rate, "cli": runs, "card": card}


def _ckpt_trees_equal(torch, a_dir, b_dir, step):
    from repro_torch.ft.checkpoint import CheckpointManager
    a, ma = CheckpointManager(str(a_dir)).restore(step)
    b, mb = CheckpointManager(str(b_dir)).restore(step)
    return _params_equal(torch, a, b) and ma["extra"] == mb["extra"], \
        sum(1 for _ in _leaves(a))


def phase_train_cli(torch, np, card: str):
    """6c: ``repro_torch.launch.train.main`` in process on the card, 6
    steps with a checkpoint every 3; then a restart from the step-3
    checkpoint with ``--resume``: the same step lines, and the final
    params, optimizer state and pipeline cursor bit-equal to the straight
    run's."""
    import contextlib
    import io
    import re
    import shutil
    from repro_torch.launch import train
    base = CKPT_DIR / "train_cli"
    shutil.rmtree(base, ignore_errors=True)
    argv = ["--device", "cuda", "--arch", "smollm-360m", "--smoke",
            "--steps", "6", "--ckpt-every", "3", "--batch", "8", "--seq",
            "128", "--log-every", "1"]
    step_re = re.compile(r"step\s+(\d+) nll=([0-9.]+) gnorm=([0-9.]+)")
    out = {}
    try:
        for name, extra in (("straight", ["--ckpt-dir", str(base / "a")]),
                            ("resumed", ["--resume", "--ckpt-dir",
                                         str(base / "b")])):
            if name == "resumed":
                (base / "b").mkdir(parents=True)
                shutil.copytree(base / "a" / "step_3",
                                base / "b" / "step_3")
                (base / "b" / "step_3.COMMITTED").touch()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                train.main(argv + extra)
            secs = time.perf_counter() - t0
            text = buf.getvalue()
            out[name] = {"seconds": secs, "lines": text.splitlines(),
                         "steps": step_re.findall(text)}
            log(f"train cli {name} ({secs:.2f} s): python -m "
                f"repro_torch.launch.train {' '.join(argv + extra)}")
            for ln in text.splitlines():
                log(f"    {ln}")
        if "[train] resumed from step 3" not in out["resumed"]["lines"]:
            raise AssertionError("the restart did not resume from step 3")
        if out["resumed"]["steps"] != out["straight"]["steps"][3:]:
            raise AssertionError("resumed step lines differ: "
                                 f"{out['resumed']['steps']} vs "
                                 f"{out['straight']['steps'][3:]}")
        same, n = _ckpt_trees_equal(torch, base / "a", base / "b", 6)
        if not same:
            raise AssertionError("the resumed run's step-6 checkpoint "
                                 "differs from the straight run's")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    log(f"  resume: step lines 3-5 equal, step-6 params, optimizer state "
        f"and pipeline cursor bit-equal ({n} leaves), on {card}")
    return out


# --------------------------------------------------------------------------
# phase 4: parity of the card with the CPU on a small input
# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# phase 7b: Kimi-K2's 384-expert layer on B3 (G >= 320), full width
# --------------------------------------------------------------------------

KIMI_CFG = dict(max_slots=4, max_len=32, ladder=(16, 8, 4))
KIMI_BUDGET = 16e9      # all-bf16 is ~38.8 GB: the plan must mix rungs
KIMI_MAX_LOSS = 0.062   # quality ceiling: ~5/6 of the experts at int4
KIMI_LOGIT_BAR = 2e-2   # of max |logit|: f32 vs bf16-rounded dequant


def kimi_config():
    from repro_torch.configs import get_config
    return get_config("kimi-k2-1t-a32b").replace(num_layers=1)


def _kimi_point(engine):
    """The planner's point for a 16 GB budget and a quality ceiling on a
    frontier whose residency axis is all-or-nothing, so the count axes
    get a fine grid (levels every 7 experts at one layer): the fastest
    such point, which the assertions below hold to q4 >= 320 with q8 and
    bf16 banks beside it."""
    import math
    from repro_torch.core.pareto import ParetoFrontier, QoSTarget
    cfg = engine.cfg
    total = cfg.num_layers * cfg.moe.num_experts
    fr = ParetoFrontier(cfg, engine.hw, batch_size=engine.max_slots,
                        residency_step=total)
    target = QoSTarget(min_tokens_per_s=math.inf,
                       mem_budget_bytes=KIMI_BUDGET,
                       max_quality_loss=KIMI_MAX_LOSS)
    return target, fr.select(target)


def _first_divergence(torch, np, runs, prompts, toks):
    """The first (request, step) where two runs' greedy tokens differ,
    and the logit margin there under each run's (model, serving params):
    the first run's token's logit minus the second's, from one prefill of
    the prompt and the shared prefix through the slot-cache hooks (the
    prefill path, not the decode step the engines took, so a margin near
    zero under both says the step was a near-tie)."""
    for r, (a, b) in enumerate(zip(*toks)):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        seq = np.concatenate([prompts[r], a[:j]])[None]
        margins = []
        for m, p in runs:
            cache = m.init_cache(1, seq.shape[1] + 1, device="cuda")
            lg, _ = m.prefill_into_slot(
                p, cache, torch.as_tensor(seq, device="cuda"),
                torch.arange(seq.shape[1], device="cuda")[None], 0,
                seq.shape[1] - 1)
            margins.append(float(lg[0, a[j]] - lg[0, b[j]]))
        return {"request": r, "step": j, "kernel_token": int(a[j]),
                "plain_token": int(b[j]), "margins": margins}
    return None


def phase_kimi(torch, np, seed: int, card: str):
    """7b: full-width Kimi-K2 (d_model 7168, 64/8 heads of 112, 384
    experts top-8, d_ff_expert 2048, vocab 163840), depth cut 61 -> 1,
    weights drawn on the card. The default paged engine with the kernels
    on applies the planner's mixed point (B3-q4 at G >= 320 beside q8
    and bf16 banks, every expert on the card) through
    ``apply_frontier_point`` and serves 4 requests x 16 prompt x 8 new
    tokens: each bank launches its kernel at its G. Then a
    ``use_kernel=False`` engine at the same plan: prefill and first-decode
    logits (through the hooks) within 2e-2 of max |logit| of the kernel
    engine's, and where the greedy tokens differ, the first divergence is
    reported with both logit margins. Peak memory is recorded. The two
    engines run one after the other, and the bf16 masters (33.8 GB) move
    to the host once the plain engine's banks are built, so that its
    whole-bank dequantize (~33 GB of temporaries for the q4 bank) fits."""
    from repro_torch.models.model import build_model, init_params
    from repro_torch.serving.api import EngineConfig, build_engine
    cfg = kimi_config()
    a, m = cfg.attention, cfg.moe
    total = cfg.num_layers * m.num_experts
    log(f"kimi: {cfg.arch_id} d_model={cfg.d_model} heads={a.num_heads}/"
        f"{a.num_kv_heads}x{a.head_dim} experts={m.num_experts} top"
        f"{m.top_k} d_ff_expert={m.d_ff_expert} capacity {m.capacity_factor}"
        f" vocab={cfg.vocab_size}; reduced: num_layers 61 -> "
        f"{cfg.num_layers}")
    _peak_reset(torch)
    t0 = time.perf_counter()
    params = init_params(cfg, seed, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"  init_params on the card: {n_bytes / 1e9:.2f} GB in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(seed + 4)
    prompts = [rng.integers(1, cfg.vocab_size, size=16) for _ in range(4)]
    out, logits, toks = {}, {}, {}
    for name, uk in (("kernel", True), ("plain", False)):
        eng = build_engine(cfg, params, EngineConfig(**KIMI_CFG,
                                                     use_kernel=uk),
                           device="cuda")
        if name == "kernel":
            target, point = _kimi_point(eng)
        _peak_reset(torch)
        t0 = time.perf_counter()
        eng.apply_frontier_point(point)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        plan = eng.current_plan
        sizes = dict(zip(sorted(plan.ladder), plan.bank_sizes()))
        log(f"  {name} engine: [{target.describe()}] -> {point.summary()}: "
            f"banks {sizes} per layer built in {build_s:.2f} s; allocated "
            f"{_mem_gb(torch)[0]:.2f} GB, build peak {_mem_gb(torch)[1]:.2f}"
            " GB")
        if not (sizes[4] >= 320 and sizes[8] > 0 and sizes[16] > 0
                and point.resident_experts == total):
            raise AssertionError(f"planned banks {sizes}, resident "
                                 f"{point.resident_experts}: not q4 >= 320 "
                                 "beside q8 and bf16, all on the card")
        if name == "plain":
            moe = params["layers"]["moe"]
            t0 = time.perf_counter()
            for k in ("w_gate", "w_up", "w_down"):
                moe[k] = moe[k].cpu()
            _release(torch)
            log(f"  bf16 expert masters moved to the host in "
                f"{time.perf_counter() - t0:.2f} s; allocated "
                f"{_mem_gb(torch)[0]:.2f} GB")
        _peak_reset(torch)
        r = serve_pass(torch, eng, prompts)
        r.update(peak_gb=_mem_gb(torch)[1], build_s=build_s)
        toks[name] = r["tokens"]
        logits[name] = [t.float() for t in _hook_logits(torch, eng, prompts)]
        out[name] = r
        log_pass(f"{name} engine", card, r)
        log(f"    serve peak {r['peak_gb']:.2f} GB; grouped launches "
            f"{r['group_launches']}; folded by bank and body "
            f"{r['folded_body_launches']}")
        if name == "kernel":
            want = {f"{k}@G={g}" for k, g in _bank_keys(plan)}
            missing = want - set(r["group_launches"])
            if missing:
                raise AssertionError(f"banks {sorted(missing)} never "
                                     f"launched: {r['group_launches']}")
            q4 = eng._serve_params["layers"]["moe"]["banks"]["q4"]
            out["q4_bank_bytes"] = sum(
                t.numel() * t.element_size() for t in _leaves(q4))
            eng.close()
            del eng, q4
            _release(torch)
        elif sum(r["launches"].values()):
            raise AssertionError("the use_kernel=False engine launched "
                                 "kernels")
    out.update(point=point.summary(), bank_sizes={
        str(k): v for k, v in sizes.items()})
    worst = 0.0
    for a_, b_ in zip(logits["kernel"], logits["plain"]):
        if not bool(torch.isfinite(a_).all()):
            raise AssertionError("non-finite kernel-engine logits")
        worst = max(worst, float((a_ - b_).abs().max())
                    / float(b_.abs().max()))
    if worst > KIMI_LOGIT_BAR:
        raise AssertionError(f"kernel vs plain logits differ by {worst:.3e}"
                             f" of max |logit| (bar {KIMI_LOGIT_BAR})")
    runs = [(build_model(eng.cfg, use_kernel=True), eng._serve_params),
            (eng.model, eng._serve_params)]
    div = _first_divergence(torch, np, runs, prompts,
                            [toks["kernel"], toks["plain"]])
    out.update(logit_rel_diff=worst, first_divergence=div)
    log(f"  kernel vs plain engine: logits within {worst:.3e} of max "
        f"|logit| (bar {KIMI_LOGIT_BAR}); q4 bank "
        f"{out['q4_bank_bytes'] / 2**30:.2f} GiB; greedy tokens "
        + ("equal" if div is None else f"first differ at {div}"))
    eng.close()
    del eng, runs, params, moe
    _release(torch)
    return out


# --------------------------------------------------------------------------
# phase 7c: qwen3-8b (qk-norm) forward and backward on the card
# --------------------------------------------------------------------------

def phase_qwen3(torch, np, seed: int, card: str):
    """7c: full-width Qwen3-8B (d_model 4096, 32/8 heads of 128 with
    qk-norm, d_ff 12288, vocab 151936), depth cut 36 -> 2, one forward and
    backward of ``Model.loss_fn`` on 2 x 64 tokens: the loss finite and
    every q/k norm gradient nonzero and finite. Then the smoke-size
    Qwen3 at float32 on the card against the CPU at phase 6a's bars. The
    model is dense: its products are ``torch.matmul``, as they are
    einsums outside any Pallas kernel in the reference, so this phase
    launches no kernel; it runs the qk-norm attention on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model, init_params
    from repro_torch.training.train_loop import value_and_grad
    cfg = get_config("qwen3-8b").replace(num_layers=2)
    a = cfg.attention
    log(f"qwen3: {cfg.arch_id} d_model={cfg.d_model} heads={a.num_heads}/"
        f"{a.num_kv_heads}x{a.head_dim} qk_norm={a.qk_norm} d_ff={cfg.d_ff}"
        f" vocab={cfg.vocab_size}; reduced: num_layers 36 -> "
        f"{cfg.num_layers}")
    _peak_reset(torch)
    params = init_params(cfg, seed, device="cuda")
    n = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(seed + 5)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 64)),
                                device="cuda")
             for k in ("tokens", "labels")}
    t0 = time.perf_counter()
    loss, _, grads = value_and_grad(build_model(cfg).loss_fn, params, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not math.isfinite(float(loss)):
        raise AssertionError(f"qwen3 loss {float(loss)}")
    norms = {}
    for k in ("q_norm", "k_norm"):
        g = grads["layers"]["attn"][k].float()
        norms[k] = float(g.abs().max())
        if not (bool(torch.isfinite(g).all()) and norms[k] > 0):
            raise AssertionError(f"qwen3 {k} gradient {norms[k]}")
    peak = _mem_gb(torch)[1]
    log(f"  {n / 1e9:.2f} B params; forward + backward on {card}: "
        f"{ms:.1f} ms, loss {float(loss):.4f}, max |grad| q_norm "
        f"{norms['q_norm']:.3e} k_norm {norms['k_norm']:.3e}, peak "
        f"{peak:.2f} GB")
    del params, grads, batch
    _release(torch)
    smoke = _grads_card_vs_cpu(torch, np, seed, "qwen3-8b")
    return {"params": n, "loss": float(loss), "ms": ms, "peak_gb": peak,
            "norm_grad_max": norms, "smoke_card_vs_cpu": smoke}


# --------------------------------------------------------------------------
# phases 7d-7e: the SSM, hybrid, enc-dec and VLM families
# --------------------------------------------------------------------------

#: each family's traffic at full width and full depth: B = 2 prompts of
#: ``text`` tokens, behind ``src`` encoder frames (enc-dec) or ``frontend``
#: patches (VLM); 300 pads both SSM chunk sizes (32 and 128)
FAMILIES = {
    "rwkv6-3b": {"text": 300},
    "zamba2-7b": {"text": 300},
    "seamless-m4t-medium": {"text": 32},
    "paligemma-3b": {"text": 32},
}
FAM_BATCH, FAM_STEPS = 2, 16
FAM_BF16_BAR = 5e-2       # decode == prefill, of max |logit|, bf16
FAM_F32_BAR = 1e-3        # the same at float32, depth cut
FAM_F32_DEPTH = {"zamba2-7b": 7}     # one group of 6 and the tail
SSM_CORE_BAR = 1e-4       # chunked == recurrent, of max |y|, f32
SMOKE_BAR = 1e-5          # card vs CPU (6a's bars)


def family_config(arch: str):
    from repro_torch.configs import get_config
    return get_config(arch)


def _family_batch(torch, np, cfg, n_text: int, seed: int, dev):
    """``n_text`` text tokens per prompt (plus the frontend's patches or
    the encoder's source frames, ``frontend_len`` of them) on ``dev``."""
    rng = np.random.default_rng(seed)
    batch = _smoke_batch(torch, np, cfg, rng, FAM_BATCH, n_text + (
        cfg.frontend_len if cfg.frontend == "vision" else 0))
    return _to(batch, torch, dev)


def _positions(cfg, batch) -> int:
    """Positions the decoder holds after ``batch``: the text tokens plus a
    vision frontend's patches (an encoder's frames are not positions)."""
    return batch["tokens"].shape[1] + (
        cfg.frontend_len if cfg.frontend == "vision" else 0)


def _greedy(cfg, logits):
    return logits[:, :cfg.vocab_size].argmax(-1)[:, None]


def _decode_vs_prefill(torch, model, params, batch, max_len, full):
    """Prefill of S-1 text tokens plus one ``decode_step`` against
    ``full``, the prefill of all S: (gap of max |logit|, the greedy
    tokens of both, each one's top-2 logit margin)."""
    short = dict(batch, tokens=batch["tokens"][:, :-1])
    _, cache = model.prefill(params, short, model.init_cache(
        FAM_BATCH, max_len, device="cuda"))
    pos = _positions(model.cfg, batch) - 1
    step, _ = model.decode_step(params, cache, batch["tokens"][:, -1:],
                                torch.full((FAM_BATCH,), pos,
                                           device="cuda"))
    gap = float((step - full).abs().max() / full.abs().max())

    def margin(lg):
        top = lg[:, :model.cfg.vocab_size].float().topk(2, dim=-1).values
        return [round(float(v), 5) for v in top[:, 0] - top[:, 1]]

    return gap, {"decode": _greedy(model.cfg, step)[:, 0].tolist(),
                 "prefill": _greedy(model.cfg, full)[:, 0].tolist(),
                 "decode_margin": margin(step),
                 "prefill_margin": margin(full)}


def _family_serve(torch, np, arch: str, seed: int, card: str):
    """One family at full width and full depth in bf16: init on the card,
    a warm-up prefill and decode step, then a timed prefill and 16 greedy
    decode steps (CUDA events), two prefills bit-equal, decode == prefill
    within FAM_BF16_BAR of max |logit|, and each decode step's logits
    against a prefill of the same prefix (the first greedy divergence and
    its margins)."""
    from repro_torch.models.model import build_model
    cfg = family_config(arch)
    traffic = FAMILIES[arch]
    _peak_reset(torch)
    model = build_model(cfg)
    params = model.init(seed, device="cuda")
    n = sum(t.numel() for t in _leaves(params))
    gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    batch = _family_batch(torch, np, cfg, traffic["text"], seed, "cuda")
    seq = _positions(cfg, batch)
    max_len = seq + FAM_STEPS + 1

    def fresh():
        return model.init_cache(FAM_BATCH, max_len, device="cuda")

    warm, cache = model.prefill(params, batch, fresh())
    model.decode_step(params, cache, _greedy(cfg, warm),
                      torch.full((FAM_BATCH,), seq, device="cuda"))
    cache = fresh()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    full, cache = model.prefill(params, batch, cache)
    ev[1].record()
    tok = _greedy(cfg, full)
    gen, steps = [tok], []
    for i in range(FAM_STEPS):
        lg, cache = model.decode_step(
            params, cache, tok, torch.full((FAM_BATCH,), seq + i,
                                           device="cuda"))
        tok = _greedy(cfg, lg)
        gen.append(tok)
        steps.append(lg)
    ev[2].record()
    torch.cuda.synchronize()
    prefill_ms = ev[0].elapsed_time(ev[1])
    step_ms = ev[1].elapsed_time(ev[2]) / FAM_STEPS
    finite = bool(torch.isfinite(full).all()) and all(
        bool(torch.isfinite(lg).all()) for lg in steps)
    bad = []
    if not finite:
        bad.append("logits not finite")
    if not _bits_equal(torch, warm, full):
        bad.append("two prefills of one batch differ")
    gap, greedy = _decode_vs_prefill(torch, model, params, batch, max_len,
                                     full)
    if not gap <= FAM_BF16_BAR:
        bad.append(f"decode vs prefill gap {gap:.3e} of max |logit| > "
                   f"{FAM_BF16_BAR}")
    # each decode step against a prefill of its prefix (the tokens so far)
    div, worst = None, 0.0
    for j in range(1, FAM_STEPS + 1):
        ext = dict(batch, tokens=torch.cat([batch["tokens"]] + gen[:j], 1))
        ref, _ = model.prefill(params, ext, fresh())
        worst = max(worst, float((steps[j - 1] - ref).abs().max()
                                 / ref.abs().max()))
        want = _greedy(cfg, ref)
        if div is None and not torch.equal(want, gen[j]):
            r = int((want != gen[j]).nonzero()[0, 0])
            a, b = int(gen[j][r, 0]), int(want[r, 0])
            div = {"step": j, "row": r, "decode_token": a,
                   "prefill_token": b,
                   "prefill_margin": float(ref[r, b] - ref[r, a]),
                   "decode_margin": float(steps[j - 1][r, a]
                                          - steps[j - 1][r, b])}
    peak = _mem_gb(torch)[1]
    rec = {"params": n, "params_gb": gb, "seq": seq,
           "prefill_ms": prefill_ms, "ms_per_decode_step": step_ms,
           "decode_tokens_per_s": FAM_BATCH / (step_ms / 1e3),
           "peak_gb": peak, "prefill_bit_equal": _bits_equal(torch, warm,
                                                             full),
           "decode_vs_prefill_gap": gap, "greedy": greedy,
           "steps_vs_prefix_prefill_worst_gap": worst,
           "first_divergence": div}
    unit = "frames" if cfg.family == "encdec" else "patches"
    extra = f"{cfg.frontend_len} {unit} + " if cfg.frontend != "none" \
        else ""
    log(f"  {arch} on {card}: {n / 1e9:.2f} B params ({gb:.2f} GB), "
        f"depth {cfg.num_layers}; B={FAM_BATCH} x ({extra}"
        f"{traffic['text']} tokens): prefill {prefill_ms:.3f} ms per "
        f"batch, {step_ms:.3f} ms per decode step, "
        f"{rec['decode_tokens_per_s']:.1f} decode tokens/s, peak "
        f"{peak:.2f} GB; two prefills bit-equal: "
        f"{rec['prefill_bit_equal']}")
    log(f"    decode == prefill (S-1 + 1 step vs S): gap {gap:.3e} of max "
        f"|logit| (bar {FAM_BF16_BAR}); greedy {greedy}; 16 steps vs "
        f"prefills of their prefixes: worst gap {worst:.3e}, first "
        f"greedy divergence {div}")
    del params, cache, model
    _release(torch)
    rec["float32"] = _family_f32(torch, np, arch, seed)
    if bad:
        raise AssertionError(f"{arch}: {'; '.join(bad)}")
    return rec


def _family_f32(torch, np, arch: str, seed: int):
    """Decode == prefill at float32, full width, depth cut to 2 (Zamba2
    to 7: one group and the tail; SeamlessM4T's encoder to 2 as well):
    gap within FAM_F32_BAR of max |logit|."""
    from repro_torch.models.model import build_model
    depth = FAM_F32_DEPTH.get(arch, 2)
    full_cfg = family_config(arch)
    cut = {"num_layers": depth, "dtype": "float32"}
    if full_cfg.num_encoder_layers:
        cut["num_encoder_layers"] = 2
    cfg = full_cfg.replace(**cut)
    model = build_model(cfg)
    params = model.init(seed, device="cuda")
    batch = _family_batch(torch, np, cfg, FAMILIES[arch]["text"], seed,
                          "cuda")
    max_len = _positions(cfg, batch) + 1
    full, _ = model.prefill(params, batch, model.init_cache(
        FAM_BATCH, max_len, device="cuda"))
    gap, greedy = _decode_vs_prefill(torch, model, params, batch, max_len,
                                     full)
    if not (torch.isfinite(full).all() and gap <= FAM_F32_BAR):
        raise AssertionError(f"{arch} float32 depth {depth}: decode vs "
                             f"prefill gap {gap:.3e} > {FAM_F32_BAR}")
    log(f"    float32, depth {depth}: decode == prefill gap {gap:.3e} of "
        f"max |logit| (bar {FAM_F32_BAR}); greedy {greedy}")
    del params, model
    _release(torch)
    return {"depth": depth, "gap": gap, "greedy": greedy}


def _ssm_cores(torch, seed: int):
    """The chunked SSM cores against their per-token oracles at the full
    configs' head shapes, f32 on the card, S = 300 (a padded tail), with
    and without an initial state: within SSM_CORE_BAR of max |y|."""
    from repro_torch.models import ssm
    gen = torch.Generator(device="cuda").manual_seed(seed)
    s = 300

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    out = {}
    h, p, n = 112, 64, 64                        # Zamba2: 7168 / 64 heads
    u, b, c = randn(2, s, h, p), randn(2, s, n, scale=0.125), \
        randn(2, s, n, scale=0.125)
    ld = -torch.rand((2, s, h), generator=gen, device="cuda") * 0.5
    for s0 in (None, randn(2, h, p, n)):
        y, _ = ssm.ssd_chunked(u, ld, b, c, 128, s0=s0)
        ref = ssm.ssd_recurrent_ref(u, ld, b, c, s0=s0)
        out[f"ssd{'' if s0 is None else '+s0'}"] = \
            float((y - ref).abs().max() / ref.abs().max())
    h, k = 40, 64                                # RWKV6: 2560 / 64 heads
    r, kk, v = (randn(2, s, h, k, scale=0.5) for _ in range(3))
    lw = -ssm.DECAY_CLAMP * torch.rand((2, s, h, k), generator=gen,
                                       device="cuda")
    bonus = randn(h, k, scale=0.1)
    for s0 in (None, randn(2, h, k, k)):
        y, _ = ssm.rwkv_chunked(r, kk, v, lw, bonus, 32, s0=s0)
        ref = ssm.rwkv_recurrent_ref(r, kk, v, lw, bonus, s0=s0)
        out[f"rwkv{'' if s0 is None else '+s0'}"] = \
            float((y - ref).abs().max() / ref.abs().max())
    log(f"  SSM cores, f32, S={s}, chunked vs recurrent (of max |y|, bar "
        f"{SSM_CORE_BAR}): ssd H=112 P=64 N=64 chunk 128, rwkv H=40 "
        f"K=V=64 chunk 32: {out}")
    bad = {k: v for k, v in out.items() if not v <= SSM_CORE_BAR}
    if bad:
        raise AssertionError(f"chunked vs recurrent over the bar: {bad}")
    return out


def _family_smoke_card_vs_cpu(torch, np, arch: str, seed: int):
    """The smoke config at float32 on the card against the CPU: prefill
    and three decode steps' logits within SMOKE_BAR of max |logit|, and
    ``loss_fn`` and its gradients at 6a's bars."""
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.models.model import build_model, init_params
    cfg = reduce_for_smoke(family_config(arch)).replace(dtype="float32")
    model = build_model(cfg)
    params = init_params(cfg, seed, device="cpu")
    batch = _smoke_batch(torch, np, cfg, np.random.default_rng(seed),
                         FAM_BATCH, 16)
    seq = _positions(cfg, batch)
    runs, fed = [], None         # the card is fed the CPU's greedy tokens
    for dev in ("cpu", "cuda"):
        p, b = _to(params, torch, dev), _to(batch, torch, dev)
        lg, cache = model.prefill(p, b, model.init_cache(
            FAM_BATCH, seq + 4, device=dev))
        out = [lg]
        for i in range(3):
            tok = _greedy(cfg, lg).cpu() if fed is None else fed[i]
            lg, cache = model.decode_step(p, cache, tok.to(dev), torch.full(
                (FAM_BATCH,), seq + i, device=dev))
            out.append(lg)
        fed = fed or [_greedy(cfg, x).cpu() for x in out]
        runs.append(torch.stack(out).cpu())
    want, got = runs
    gap = float((got - want).abs().max() / want.abs().max())
    if gap > SMOKE_BAR:
        raise AssertionError(f"{arch} smoke: card vs CPU logits {gap:.3e} "
                             f"of max |logit| > {SMOKE_BAR}")
    log(f"  card vs CPU ({arch} smoke, float32): prefill + 3 decode steps' "
        f"logits {gap:.2e} of max |logit| (bar {SMOKE_BAR})")
    grads = _grads_card_vs_cpu(torch, np, seed, arch)
    return {"logits_gap": gap, **grads}


def phase_families(torch, np, seed: int, card: str):
    """7d: RWKV6-3B, Zamba2-7B, SeamlessM4T-medium and PaliGemma-3B at
    full width and full depth through ``Model.prefill`` and
    ``Model.decode_step`` (each model released before the next), the SSM
    cores at full-width head shapes, and each smoke config on the card
    against the CPU. None of these families reaches a kernel: their
    products are ``torch.matmul``/``einsum``, as they are plain ``jnp``
    in the reference."""
    log("families: full width, full depth, bf16, weights from "
        f"init_params on the card; B={FAM_BATCH}, {FAM_STEPS} greedy "
        "decode steps; times are CUDA events after one warm-up")
    out, failed = {}, []
    for name, fn in [(arch, lambda a=arch: _family_serve(
            torch, np, a, seed, card)) for arch in FAMILIES] + [
            ("ssm_cores", lambda: _ssm_cores(torch, seed))] + [
            (f"smoke {arch}", lambda a=arch: _family_smoke_card_vs_cpu(
                torch, np, a, seed)) for arch in FAMILIES]:
        try:                 # every model runs; a failure fails the phase
            out[name] = fn()
        except AssertionError as e:
            failed.append(str(e))
            log(f"  FAILED: {e}")
        _release(torch)
    if failed:
        raise AssertionError(f"families: {failed}")
    return out


#: 7e's depth cuts at full width (RWKV6 32 -> 4, Zamba2 81 -> 7: one
#: group of six and the tail) and its batch of B x S tokens
FAM_TRAIN = {"rwkv6-3b": 4, "zamba2-7b": 7}
FAM_TRAIN_BATCH, FAM_TRAIN_SEQ = 2, 256
#: the leaves whose gradients must be nonzero, per family (``shared``:
#: every leaf of Zamba2's one shared attention block)
FAM_TRAIN_LEAVES = {
    "rwkv6-3b": [("layers", "rwkv", k) for k in
                 ("decay_lora_a", "decay_lora_b", "bonus", "mix")],
    "zamba2-7b": [("layers", "mamba", k) for k in
                  ("A_log", "dt_bias", "conv")] + [("shared",)],
}


def phase_families_train(torch, np, seed: int, card: str):
    """7e: one forward and backward of ``Model.loss_fn`` at full width and
    cut depth for RWKV6 and Zamba2, twice: gradients bit-equal between
    the runs, a finite loss within 0.5 of ln(vocab) (random weights), and
    nonzero, finite gradients on the SSM leaves and the shared block."""
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_loop import value_and_grad
    out = {}
    for arch, depth in FAM_TRAIN.items():
        cfg = family_config(arch).replace(num_layers=depth)
        _peak_reset(torch)
        model = build_model(cfg)
        params = model.init(seed, device="cuda")
        rng = np.random.default_rng(seed)
        batch = {k: torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (FAM_TRAIN_BATCH, FAM_TRAIN_SEQ)),
            device="cuda") for k in ("tokens", "labels")}
        runs = []
        for _ in range(2):
            t0 = time.perf_counter()
            loss, _, grads = value_and_grad(model.loss_fn, params, batch)
            torch.cuda.synchronize()
            runs.append(((time.perf_counter() - t0) * 1e3, loss, grads))
        (ms0, loss, g0), (ms1, loss1, g1) = runs
        a, b = dict(tree_leaves(g0)), dict(tree_leaves(g1))
        same = _bits_equal(torch, loss, loss1) and all(
            _bits_equal(torch, a[k], b[k]) for k in a)
        if not same:
            raise AssertionError(f"{arch}: two backward passes differ")
        expect = math.log(cfg.vocab_size)
        if not (math.isfinite(float(loss))
                and abs(float(loss) - expect) < 0.5):
            raise AssertionError(f"{arch}: loss {float(loss)} vs ln(vocab) "
                                 f"{expect:.2f}")
        norms = {}
        for want in FAM_TRAIN_LEAVES[arch]:
            for path, g in a.items():
                if path[:len(want)] == want:
                    m = float(g.float().abs().max())
                    norms["/".join(path)] = m
                    if not (m > 0 and bool(torch.isfinite(g).all())):
                        raise AssertionError(f"{arch}: gradient of "
                                             f"{'/'.join(path)} is {m}")
        peak = _mem_gb(torch)[1]
        out[arch] = {"depth": depth, "loss": float(loss), "ln_vocab": expect,
                     "ms": [ms0, ms1], "peak_gb": peak,
                     "grad_max": norms}
        log(f"  {arch} (depth {cfg.num_layers}, full width) on {card}: "
            f"forward + backward of {FAM_TRAIN_BATCH} x {FAM_TRAIN_SEQ} "
            f"tokens {ms0:.1f} / {ms1:.1f} ms, loss {float(loss):.4f} "
            f"(ln vocab {expect:.2f}), peak {peak:.2f} GB; gradients of "
            "the two runs bit-equal; max |grad| "
            + ", ".join(f"{k} {v:.2e}"
                        for k, v in norms.items()))
        del params, grads, g0, g1, a, b, runs, model
        _release(torch)
    return out


#: 9e's depth cuts at full width: RWKV6 32 -> 2, Zamba2 81 -> 7 (one
#: group of six and the tail), SeamlessM4T 12 + 12 -> 2 + 2
FAM_MESH = {"rwkv6-3b": 2, "zamba2-7b": 7, "seamless-m4t-medium": 2}
FAM_MESH_F32_BAR = 1e-4       # split vs one device, of max |logit|
FAM_MESH_TRAIN = (4, 64)      # one AdamW step's batch: 2 microbatches


def _fam_mesh_config(arch: str, dtype: str):
    cut = {"num_layers": FAM_MESH[arch], "dtype": dtype}
    if family_config(arch).num_encoder_layers:
        cut["num_encoder_layers"] = 2
    return family_config(arch).replace(**cut)


def _fam_mesh_serve(torch, np, arch: str, dtype: str, mesh, seed: int):
    """Prefill of 2 x 8 tokens (an enc-dec's ``src`` of ``frontend_len``
    frames) and 4 decode steps split over ``mesh`` against one device's
    own run at the same params, fed its greedy tokens: (the logits gap of
    max |logit|, greedy equal, one device's and the mesh's ms per decode
    step)."""
    from repro_torch.dist import sharding as SH
    from repro_torch.models.model import init_params
    cfg = _fam_mesh_config(arch, dtype)
    params = init_params(cfg, seed, device="cuda")
    batch = _to(_smoke_batch(torch, np, cfg, np.random.default_rng(seed),
                             2, 8), torch, "cuda")
    batch.pop("labels")
    want, feed, ms1, _ = _mesh_decode(torch, cfg, params, None, batch)
    sp = SH.shard_tree(params, SH.param_shardings(cfg, mesh, params))
    del params
    _release(torch)
    got, _, ms, counted = _mesh_decode(torch, cfg, sp, mesh, batch, feed)
    del sp
    _release(torch)
    scale = float(want.abs().max())
    gap = float((got - want).abs().max())
    same = got.argmax(-1) == want.argmax(-1)
    top2 = want.topk(2, dim=-1).values
    firm = (top2[..., 0] - top2[..., 1]) > 2 * gap
    finite = bool(torch.isfinite(got).all()) and counted["split"]
    if dtype == "float32":
        ok = gap <= FAM_MESH_F32_BAR * scale and bool(same.all())
    else:                     # bf16: 9c's rule, the gap printed
        ok = not bool((firm & ~same).any())
    if not (finite and ok):
        raise AssertionError(f"9e {arch} {dtype}: logits gap {gap:.3e} "
                             f"(max |logit| {scale:.3f}), greedy ids "
                             f"differ where firm: {int((firm & ~same).sum())}"
                             f", finite and split {finite}")
    return {"gap": gap / scale, "max_logit": scale,
            "greedy_equal": bool(same.all()), "one_device_ms": ms1,
            "mesh_ms": ms}


def _fam_mesh_train(torch, np, arch: str, mesh, seed: int):
    """One AdamW step of the split ``loss_fn`` (bf16, 2 microbatches)
    from the same placed params, twice: stepped params and moments
    bit-equal, and the step's nll within 1e-2 of one device's at those
    params over the same microbatches."""
    from repro_torch.dist import sharding as SH
    from repro_torch.models.model import build_model, init_params
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)
    cfg = _fam_mesh_config(arch, "bfloat16")
    b, s = FAM_MESH_TRAIN
    batch = _to(_smoke_batch(torch, np, cfg, np.random.default_rng(seed), b,
                             s), torch, "cuda")
    tcfg = _train_config(torch)
    step = make_train_step(build_model(cfg, mesh).loss_fn, tcfg)
    params = init_params(cfg, seed, device="cuda")
    n = tcfg.num_microbatches
    with torch.no_grad():
        whole = build_model(cfg).loss_fn
        one = float(torch.stack([whole(params, {
            k: v.reshape((n, -1) + v.shape[1:])[i]
            for k, v in batch.items()})[1]["nll"] for i in range(n)]).mean())
    runs = []
    for _ in range(2):
        _peak_reset(torch)
        sp = SH.shard_tree(params, SH.param_shardings(cfg, mesh, params))
        state = init_train_state(sp, tcfg)
        t0 = time.perf_counter()
        sp, state, m = step(sp, state, batch)
        torch.cuda.synchronize()
        rec = {"ms": (time.perf_counter() - t0) * 1e3,
               "nll": float(m["nll"]), "grad_norm": float(m["grad_norm"]),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        _replicas_equal(torch, sp, f"9e {arch} params")
        runs.append(({k: [t.cpu() for t in SH.distinct(v)] for k, v in
                      _state_leaves(sp, state).items()}, rec))
        del sp, state
        _release(torch)
    (a, r1), (b_, r2) = runs
    same = all(_bits_equal(torch, x, y) for k in a
               for x, y in zip(a[k], b_[k]))
    gap = abs(r1["nll"] - one)
    if not (same and r1["nll"] == r2["nll"] and gap <= 1e-2
            and math.isfinite(r1["grad_norm"])):
        raise AssertionError(f"9e {arch} train: runs bit-equal {same}, nll "
                             f"{r1['nll']} / {r2['nll']} vs one device "
                             f"{one} (bar 1e-2), grad norm "
                             f"{r1['grad_norm']}")
    return {"nll": r1["nll"], "one_device_nll": one, "nll_gap": gap,
            "grad_norm": r1["grad_norm"], "ms": [r1["ms"], r2["ms"]],
            "peak_gb": r1["peak_gb"], "bit_equal": same}


def phase_families_mesh(torch, np, seed: int, card: str,
                        distinct: bool = False):
    """9e: RWKV6, Zamba2 and SeamlessM4T at full width and cut depth
    (``FAM_MESH``), their dense compute split over a (2, 2) mesh of
    repeated ``cuda:0`` (``distinct``: position p on ``cuda:(p %
    cards)``): f32 and bf16 prefill + 4 decode steps against one device
    (f32 within ``FAM_MESH_F32_BAR`` of max |logit| with equal greedy
    ids; bf16's gap printed, its greedy ids equal wherever one device's
    top-2 margin exceeds twice the gap), one split AdamW step twice
    (bit-equal, nll against one device's), and the split Zamba2 decode
    step's op count on the card against ``meta``'s."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_test_mesh
    t0 = time.perf_counter()
    mesh = make_test_mesh((2, 2), devices=_mesh_devices(4, distinct))
    out = {}
    for arch, depth in FAM_MESH.items():
        rec = {"depth": depth}
        for dtype in ("float32", "bfloat16"):
            rec[dtype] = r = _fam_mesh_serve(torch, np, arch, dtype, mesh,
                                             seed)
            log(f"  9e {arch} {dtype} (depth {depth}, full width) split "
                f"over 2x2 of {mesh.devices[0]}...: prefill 2x8 + 4 decode "
                f"steps, logits within {r['gap']:.3e} of max |logit| "
                f"{r['max_logit']:.3f} of one device's, greedy ids "
                f"{'equal' if r['greedy_equal'] else 'equal where firm'}; "
                f"{r['mesh_ms']:.2f} ms per decode step (one device "
                f"{r['one_device_ms']:.2f})")
        rec["train"] = t = _fam_mesh_train(torch, np, arch, mesh, seed)
        log(f"  9e {arch} train: one split AdamW step of "
            f"{FAM_MESH_TRAIN[0]} x {FAM_MESH_TRAIN[1]} tokens twice, "
            f"{t['ms'][0]:.1f} / {t['ms'][1]:.1f} ms, params and moments "
            f"bit-equal; nll {t['nll']:.4f}, one device at the same params "
            f"{t['one_device_nll']:.4f} (gap {t['nll_gap']:.2e}, bar 1e-2); "
            f"peak {t['peak_gb']:.2f} GB")
        out[arch] = rec
        _release(torch)
    if not distinct:
        out["zamba2 count"] = _mesh_count(
            torch, _fam_mesh_config("zamba2-7b", "bfloat16"), card,
            ShapeConfig("decode", 24, 2, "decode"), "9e zamba2-7b")
    out["seconds"] = time.perf_counter() - t0
    log(f"  9e: {out['seconds']:.1f} s")
    return out


def phase_parity(torch, np, seed: int):
    """The smoke-size model (2 layers, d_model 64) with a 3-rung plan: the
    same params on the card (CUDA kernels) and on the CPU (the kernels'
    plain versions, same arithmetic) give the same prefill and decode
    logits within 5e-2 (bf16 activations over 2 layers)."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core.precision_plan import balanced_ladder_plan
    from repro_torch.kernels import ops
    from repro_torch.models.model import (apply_precision_plan, build_model,
                                          init_params)
    cfg = reduce_for_smoke(get_config("mixtral-8x7b"))
    plan = balanced_ladder_plan(cfg.num_layers, cfg.moe.num_experts,
                                {4: 6, 8: 6}, ladder=(16, 8, 4),
                                group_size=cfg.mop.group_size, seed=seed)
    params = init_params(cfg, seed, device="cpu")
    model = build_model(cfg, use_kernel=True)
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(1, 8))
    outs, fed = {}, []
    for dev in ("cpu", "cuda"):         # the card is fed the CPU's tokens
        p = apply_precision_plan(_to(params, torch, dev), cfg, plan)
        cache = model.init_cache(2, 24, device=dev)
        t = torch.as_tensor(toks, device=dev)
        pos = torch.arange(8, device=dev)[None]
        n0 = sum(ops.LAUNCHES.values())
        lg, cache = model.prefill_into_slot(p, cache, t, pos, 0, 7)
        logits = [lg[0]]
        for step in range(4):
            if dev == "cpu":
                fed.append(int(torch.argmax(lg[0])))
            lg, cache, _ = model.decode_step_routed(
                p, cache, torch.tensor([[fed[step]], [0]], device=dev),
                torch.tensor([8 + step, -1], device=dev))
            logits.append(lg[0])
        outs[dev] = torch.stack(logits).float().cpu()
        if dev == "cuda" and sum(ops.LAUNCHES.values()) == n0:
            raise AssertionError("parity run launched no kernel")
    err = float((outs["cuda"] - outs["cpu"]).abs().max())
    if not torch.isfinite(outs["cuda"]).all() or err > 5e-2:
        raise AssertionError(f"card vs CPU logits differ by {err}")
    log(f"parity: smoke model card vs CPU logits max |diff| = {err:.3e} "
        "(bar 5e-2)")
    return err


def _to(tree, torch, dev):
    if isinstance(tree, dict):
        return {k: _to(v, torch, dev) for k, v in tree.items()}
    return tree.to(dev)


# --------------------------------------------------------------------------
# phase 5: kernels against their plain versions
# --------------------------------------------------------------------------

def _time_ms(torch, fns, reps: int, warmup: int = 2) -> float:
    """Mean CUDA-event time of one call in a loop of ``reps`` calls,
    cycling through ``fns`` (the same function on copies of its inputs
    that together exceed the L2 cache, so no launch reads its weights from
    L2). The host enqueues as the card runs, so this is the time of the
    slower of the two."""
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(torch, fns, reps: int) -> float:
    """Device time of one call: ``reps`` calls cycling through ``fns``
    captured in one CUDA graph and replayed once between CUDA events, so
    the host's Python per call is out of the reading (the kernel wrappers
    and their allocations are captured as they run)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):              # warm-up outside the capture
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def _copies(torch, nbytes: int) -> int:
    """Input copies to cycle through so that they exceed twice the L2."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    return max(1, math.ceil(2 * l2 / nbytes))


def _close(torch, got, want):
    """Within one bf16 ulp of |want| plus 1e-3 (f32 sums in another order
    may move the bf16 result by one ulp)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    tol = w.abs() * 2.0 ** -7 + 1e-3
    return float(err.max()), bool((err <= tol).all())


def _bits_equal(torch, a, b) -> bool:
    """Same dtype, shape and bytes (any dtype, 0-d included)."""
    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8)))


def _bound_ms(nbytes: float, flops: float):
    t_b = nbytes / PEAK_HBM_BYTES_PER_S
    t_f = flops / PEAK_BF16_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def _make_bank(torch, gen, g, c, k, n, bits):
    from repro_torch.core.quantization import quantize
    x = torch.randn((g, c, k), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = torch.randn((g, k, n), generator=gen, device="cuda") / math.sqrt(k)
    if bits == 16:
        return x, w.to(torch.bfloat16)
    return x, quantize(w, bits, GROUP)


#: Kimi-K2's expert bank at full width: G = 384 experts, the decode C = 8
#: (4 slots x top-8 x 1.25 / 384 rounds up to the minimum capacity 4,
#: padded to 8), up/gate (K 7168, N 2048) and down (K 2048, N 7168); the
#: int4 bank of one matrix is 2.82 GB, past 2^31 bytes in one launch
KIMI_G = 384
KIMI_SHAPES = {
    "kimi_up": (C_DECODE, 7168, 2048),
    "kimi_down": (C_DECODE, 2048, 7168),
}
#: the int4 bank's up-projection at a 4096-token prefill bucket: 4096 x
#: top-8 x 1.25 / 384 = 106.7 -> C = 108 (the wgmma body), and at the
#: 8192-token bucket: 213.3 -> C = 216 (two token tiles)
KIMI_PREFILL_SHAPES = {"kimi_prefill_up": (108, 7168, 2048),
                       "kimi_prefill216_up": (216, 7168, 2048)}


def _kimi_bank(torch, gen, g, k, n, bits):
    """A G-expert bank quantized 32 experts at a time (the f32 weights of
    the whole bank would take 22.5 GB) and its dequantized bf16 copy for
    the ``torch.bmm`` yardstick."""
    from repro_torch.core.quantization import QTensor, dequantize, quantize
    q = torch.empty((g, k // 2 if bits == 4 else k, n),
                    dtype=torch.uint8 if bits == 4 else torch.int8,
                    device="cuda")
    scales = torch.empty((g, k // GROUP, n), dtype=torch.bfloat16,
                         device="cuda")
    deq = torch.empty((g, k, n), dtype=torch.bfloat16, device="cuda")
    for e0 in range(0, g, 32):
        e1 = min(e0 + 32, g)
        w = torch.randn((e1 - e0, k, n), generator=gen, device="cuda") \
            / math.sqrt(k)
        qt = quantize(w, bits, GROUP)
        q[e0:e1].copy_(qt.q)
        scales[e0:e1].copy_(qt.scales)
        deq[e0:e1].copy_(dequantize(qt))
    return QTensor(q=q, scales=scales, bits=bits, group_size=GROUP), deq


def _grid_name(qk, plan, g, c, n, bits) -> str:
    """A launch's grid: "folded" or "spread" where its plan splits K, else
    "one"."""
    if plan.splits == 1:
        return "one"
    return "folded" if qk.fold_splits(plan, g, c, n, bits) else "spread"


def _kimi_rows(torch, gen, gk, ops, qk, reps):
    """B3 (``dequant_matmul<4|8>``) at G = 384 on Kimi's widths: held
    against its plain version on the first, a middle and the last expert
    (the last one's codes lie past 2 GiB into the bank), two launches
    bit-equal, device time in a CUDA graph beside the bound, the plain
    version on the whole bank and ``torch.bmm`` on the dequantized bank;
    the split-K partials' bytes are recorded."""
    out = {}
    for bits in (4, 8):
        shapes = dict(KIMI_SHAPES, **(KIMI_PREFILL_SHAPES if bits == 4
                                      else {}))
        for label, (c, k, n) in shapes.items():
            g = KIMI_G
            qt, deq = _kimi_bank(torch, gen, g, k, n, bits)
            x = torch.randn((g, c, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            got = ops.grouped_q_matmul(x, qt)
            again = ops.grouped_q_matmul(x, qt)
            if not bool(torch.isfinite(got.float()).all()) \
                    or not _bits_equal(torch, got, again):
                raise AssertionError(f"q{bits} {label} at G={g}: non-finite"
                                     " or differs between two launches")
            err = 0.0
            for e in (0, g // 2, g - 1):
                want = gk.grouped_quantized_matmul_plain(
                    x[e:e + 1], qt.q[e:e + 1], qt.scales[e:e + 1],
                    bits=bits, group_size=GROUP)
                e_err, ok = _close(torch, got[e:e + 1], want)
                if not ok:
                    raise AssertionError(
                        f"q{bits} {label} at G={g}, expert {e}: max |diff| "
                        f"{e_err} from its plain version")
                err = max(err, e_err)
            plan = qk.launch_plan(c, k, n, bits)
            if c > C_WIDE:
                # row invariance on Kimi's bank: the first 160 rows,
                # reversed, as a C = 160 launch (one plan's splits)
                if qk.launch_plan(C_WIDE, k, n, bits)[2:4] != plan[2:4]:
                    raise AssertionError(f"q{bits} {label}: C = {c} and "
                                         f"{C_WIDE} split K differently")
                rows = list(range(C_WIDE - 1, -1, -1))
                part = ops.grouped_q_matmul(x[:, rows].contiguous(), qt)
                if not _bits_equal(torch, got[:, rows].contiguous(), part):
                    raise AssertionError(f"q{bits} {label} at G={g}: rows "
                                         f"of a C={c} launch differ from a "
                                         f"C={C_WIDE} launch")
                log(f"  grouped_q{bits}    {label}: rows of the C={c} launch "
                    f"bit-equal to a C={C_WIDE} launch at G={g}")
                del part
            w_bytes = g * k * n * bits // 8
            sb = g * (k // GROUP) * n * 2
            row = {"G": g, "C": c, "K": k, "N": n, "copies": 1,
                   "plan": plan._asdict(),
                   "grid": _grid_name(qk, plan, g, c, n, bits),
                   "max_abs_err": err,
                   "checked_experts": [0, g // 2, g - 1],
                   "w_bytes": w_bytes,
                   "partial_bytes": (plan.splits * g * c * n * 4
                                     if _grid_name(qk, plan, g, c, n, bits)
                                     == "spread" else 0)}
            row["ms"] = _graph_ms(torch, [lambda: ops.grouped_q_matmul(
                x, qt)], reps)
            row["library_ms"] = _graph_ms(torch, [lambda: torch.bmm(x, deq)],
                                          reps)
            del deq
            torch.cuda.empty_cache()
            row["plain_ms"] = _time_ms(torch, [
                lambda: gk.grouped_quantized_matmul_plain(
                    x, qt.q, qt.scales, bits=bits, group_size=GROUP)],
                2, warmup=1)
            nbytes = g * c * k * 2 + w_bytes + sb + g * c * n * 2
            row["bound_ms"], row["bound_by"] = _bound_ms(
                nbytes, 2.0 * g * c * k * n)
            log(f"  grouped_q{bits}    {label:10s} G={g} C={c:3d} K={k:5d} "
                f"N={n:5d} splits {plan.splits} {row['grid']} (f32 partials "
                f"{row['partial_bytes'] / 1e6:.1f} MB): {row['ms']:.4f} ms "
                f"(bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
                f"{row['bound_ms'] / row['ms']:.1%} of bound), plain "
                f"{row['plain_ms']:.4f} ms, bmm {row['library_ms']:.4f} ms "
                f"({row['library_ms'] / row['ms']:.2f}x), max|err| "
                f"{err:.2e} on experts {row['checked_experts']}")
            out[(f"grouped_q{bits}", label)] = row
            del qt, x, got, again
            torch.cuda.empty_cache()
    return out


def phase_kernels(torch, np, sizes, seed: int, reps: int, more=()):
    """5: every kernel against its plain version at ``SHAPES``, the draft
    bank, Kimi-K2's widths and phase 9's shard shapes, then the launch
    shapes ``more`` ((kernel, G, C, K, N), phase 11's) whose (kernel, C,
    K, N) no row above has, each at its first G."""
    from repro_torch.core.quantization import QTensor, dequantize
    from repro_torch.kernels import grouped_matmul as gk
    from repro_torch.kernels import ops
    from repro_torch.kernels import q4_matmul as qk
    gen = torch.Generator(device="cuda").manual_seed(seed)
    records, extra = [], []

    def measure(name, cases, g, c, k, n, bits, w_bytes, scale_bytes=0):
        """``cases``: one (kernel, plain, library) tuple per input copy;
        the first copy is checked, all are cycled through when timed.
        Kernel and library times are device times (CUDA graph); the plain
        version is timed in a plain loop."""
        kernel, plain, _ = cases[0]
        got = kernel()
        again = kernel()
        want = plain()
        torch.cuda.synchronize()
        err, ok = _close(torch, got, want)
        if not ok or not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name} (G={g}, C={c}, K={k}, N={n}) "
                                 f"disagrees with its plain version: "
                                 f"max |diff| {err}")
        if not _bits_equal(torch, got, again):
            raise AssertionError(f"{name} (G={g}, C={c}, K={k}, N={n}) "
                                 "differs between two launches")
        plan = qk.launch_plan(c, k, n, bits)
        row = {"G": g, "C": c, "K": k, "N": n, "copies": len(cases),
               "plan": plan._asdict(), "grid": _grid_name(qk, plan, g, c, n, bits),
               "max_abs_err": err}
        kernels = [t[0] for t in cases]
        row["ms"] = _graph_ms(torch, kernels, reps)
        row["loop_ms"] = _time_ms(torch, kernels, reps)
        row["plain_ms"] = _time_ms(torch, [t[1] for t in cases],
                                   max(2, reps // 5), warmup=1)
        row["library_ms"] = _graph_ms(torch, [t[2] for t in cases], reps)
        nbytes = g * c * k * 2 + w_bytes + scale_bytes + g * c * n * 2
        row["bound_ms"], row["bound_by"] = _bound_ms(nbytes,
                                                     2.0 * g * c * k * n)
        return row

    def q_case(bits, g, c, k, n, grouped):
        def one():
            x, qt = _make_bank(torch, gen, g, c, k, n, bits)
            deq = dequantize(qt)                  # bf16, for bmm only
            if grouped:
                return (lambda: ops.grouped_q_matmul(x, qt),
                        lambda: gk.grouped_quantized_matmul_plain(
                            x, qt.q, qt.scales, bits=bits, group_size=GROUP),
                        lambda: torch.bmm(x, deq))
            x1, q1 = x[0], qt.map(lambda t: t[0])
            return (lambda: ops.q_matmul(x1, q1)[None],
                    lambda: qk.quantized_matmul_plain(
                        x1, q1.q, q1.scales, bits=bits,
                        group_size=GROUP)[None],
                    lambda: torch.mm(x1, deq[0])[None])
        w_bytes = g * k * n * bits // 8
        sb = g * (k // GROUP) * n * 2
        cases = [one() for _ in range(_copies(torch, w_bytes + sb))]
        return measure(f"q{bits}", cases, g, c, k, n, bits, w_bytes, sb)

    def bf16_case(g, c, k, n):
        def one():
            x, w = _make_bank(torch, gen, g, c, k, n, 16)
            return (lambda: ops.grouped_bf16_matmul(x, w),
                    lambda: gk.grouped_bf16_matmul_plain(x, w),
                    lambda: torch.bmm(x, w))
        w_bytes = g * k * n * 2
        cases = [one() for _ in range(_copies(torch, w_bytes))]
        return measure("bf16", cases, g, c, k, n, 16, w_bytes)

    specs = [
        ("q4_matmul", "cuda", "B1", "src/repro/kernels/q4_matmul.py:39",
         lambda c, k, n: q_case(4, 1, c, k, n, False)),
        ("q8_matmul", "cuda", "B2", "src/repro/kernels/q4_matmul.py:69",
         lambda c, k, n: q_case(8, 1, c, k, n, False)),
        ("grouped_q4", "cuda", "B3",
         "src/repro/kernels/grouped_matmul.py:63",
         lambda c, k, n: q_case(4, sizes[4], c, k, n, True)),
        ("grouped_q8", "cuda", "B3",
         "src/repro/kernels/grouped_matmul.py:63",
         lambda c, k, n: q_case(8, sizes[8], c, k, n, True)),
        ("grouped_bf16", "cuda", "B4",
         "src/repro/kernels/grouped_matmul.py:84",
         lambda c, k, n: bf16_case(sizes[16], c, k, n)),
    ]
    draft = {"grouped_q4": lambda c, k, n: q_case(4, DRAFT_G, c, k, n, True)}
    log(f"kernels: bank layout per rung {sizes} (experts per layer), "
        f"group {GROUP}; kernel and bmm times are device times "
        f"(CUDA graph of {reps} launches), plain times CUDA events over a "
        "loop; every timing cycles through input copies that exceed twice "
        "the L2")
    for name, route, tag, replaces, case in specs:
        rows = {}
        shapes = [(lbl, shp, case) for lbl, shp in SHAPES.items()]
        if name in draft:
            shapes += [(lbl, shp, draft[name])
                       for lbl, shp in DRAFT_SHAPES.items()]
        for label, (c, k, n), run in shapes:
            r = run(c, k, n)
            rows[label] = r
            log(f"  {name:13s} {label:10s} G={r['G']} C={r['C']:3d} "
                f"K={k:5d} N={n:5d} x{r['copies']} splits "
                f"{r['plan']['splits']} {r['grid']}: {r['ms']:.4f} ms (loop "
                f"{r['loop_ms']:.4f}; bound {r['bound_ms']:.4f} ms by "
                f"{r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} of bound), "
                f"plain {r['plain_ms']:.4f} ms, bmm {r['library_ms']:.4f} ms "
                f"({r['library_ms'] / r['ms']:.2f}x), max|err| "
                f"{r['max_abs_err']:.2e}")
            torch.cuda.empty_cache()
        # one record per body: the mma.sync body at the serve point's
        # decode up-projection, and for the grouped wrappers (the prefill
        # path's kernels) the wgmma body at prefill_up and the wide wgmma
        # body at prefill160_up
        for body, label, source in (
                ("mma_sync", "decode4_up", "dequant_matmul.cu"),
                ("wgmma", "prefill_up", "wgmma_body.cuh"),
                ("wgmma_wide", "prefill160_up", "wgmma_wide.cuh")):
            if body != "mma_sync" and not name.startswith("grouped"):
                continue
            r = rows[label]
            records.append({
                "name": name if body == "mma_sync" else f"{name}@{body}",
                "route": route,
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": replaces, "launches": None,
                "max_abs_err": max(v["max_abs_err"] for v in rows.values()
                                   if qk.launch_plan(v["C"], v["K"], v["N"],
                                                     16).body == body),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "wrapper": name,
                "body": body,
                "shape": {"G": r["G"], "C": r["C"], "K": r["K"],
                          "N": r["N"]}})
        extra.append({"name": name, "tag": tag, **{
            lbl: r for lbl, r in rows.items()}})
    # the split-K reduction has no kernel of its own (it is the matmuls'
    # epilogue), so it has no record: only its check
    extra.append({"name": "split-K epilogue", "checked":
                  _split_epilogue_check(torch, gen, qk, sizes)})
    _exact_checks(torch, gen, gk, ops, QTensor)
    _row_invariance(torch, gen, ops, sizes)
    log(f"kernels: B3 at Kimi-K2's widths, G = {KIMI_G}")
    for (name, label), row in _kimi_rows(torch, gen, gk, ops, qk,
                                         reps).items():
        next(e for e in extra if e["name"] == name)[label] = row
    log("kernels: B3 and B4 at phase 9's shard shapes (token-gather: d_ff "
        "half of a model rank's experts; TP: d_ff sixteenth of the bank)")
    for name, bits in (("grouped_q4", 4), ("grouped_q8", 8),
                       ("grouped_bf16", 16)):
        for label, (c, k, n) in MESH_SHAPES.items():
            g = MESH_BANKS[bits] // (2 if label.startswith("tg") else 1)
            r = bf16_case(g, c, k, n) if bits == 16 \
                else q_case(bits, g, c, k, n, True)
            log(f"  {name:13s} {label:10s} G={g} C={c:3d} K={k:5d} "
                f"N={n:5d} x{r['copies']} splits {r['plan']['splits']} "
                f"{r['grid']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms "
                f"by {r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} of "
                "bound), "
                f"plain {r['plain_ms']:.4f} ms, bmm {r['library_ms']:.4f} ms "
                f"({r['library_ms'] / r['ms']:.2f}x), max|err| "
                f"{r['max_abs_err']:.2e}")
            next(e for e in extra if e["name"] == name)[label] = r
            torch.cuda.empty_cache()
    timed = {(e["name"], r.get("C"), r.get("K"), r.get("N"))
             for e in extra for r in e.values() if isinstance(r, dict)}
    new = {}
    for name, g, c, k, n in more:
        new.setdefault((name, c, k, n), g)
    new = {key: g for key, g in new.items() if key not in timed}
    if new:
        log("kernels: B3 and B4 at phase 11's launch shapes not timed above "
            "(the split engine's token-gather shards)")
    for (name, c, k, n), g in sorted(new.items()):
        bits = int(name[len("grouped_q"):]) if name != "grouped_bf16" else 16
        r = bf16_case(g, c, k, n) if bits == 16 \
            else q_case(bits, g, c, k, n, True)
        label = f"11 G{g} {c}x{k}x{n}"
        log(f"  {name:13s} {label:18s} x{r['copies']} splits "
            f"{r['plan']['splits']} {r['grid']}: {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.1%} of bound), plain "
            f"{r['plain_ms']:.4f} ms, bmm {r['library_ms']:.4f} ms "
            f"({r['library_ms'] / r['ms']:.2f}x), max|err| "
            f"{r['max_abs_err']:.2e}")
        next(e for e in extra if e["name"] == name)[label] = r
        torch.cuda.empty_cache()
    return records, extra


def _row_invariance(torch, gen, ops, sizes):
    """Row r of a launch at the verify's C = 12 is bit-equal to the same
    row in a C = 8 launch (placed at another row), for every kernel at the
    up- and down-projection (and the G = 8 draft bank): a token's result
    depends neither on how many tokens share its expert nor on its place,
    so the speculative verify scores a token as plain decode does. So are
    rows of C = 8 and 4 launches (decode at the serve point), of C = 128
    and 80 launches (the wgmma body), of C = 256 and 160, of C = 320 and
    256, of C = 640 and 320 (up and down), of C = 320 and 160 (down) and
    of C = 416 and 400 (up: the wide body's n96 tail) launches (C > 128:
    one, two, three and four token tiles); every such pair
    must split K alike. Rows of C = 160 and 128 launches (the two wgmma
    bodies) are checked where their plans split K alike."""
    from repro_torch.kernels import q4_matmul as qk
    def check(what, fn, x, c_part=C_DECODE):
        full = fn(x)
        # the first c_part rows, in reverse order: a row's result depends
        # neither on the row count nor on its place in the tile
        rows = list(range(c_part - 1, -1, -1))
        part = fn(x[..., rows, :].contiguous())
        if not _bits_equal(torch, full[..., rows, :].contiguous(), part):
            raise AssertionError(f"{what}: rows of a C={x.shape[-2]} launch "
                                 f"differ from a C={c_part} launch")

    cases = [("q4_matmul", 4, 1, False), ("q8_matmul", 8, 1, False),
             ("grouped_q4", 4, sizes[4], True),
             ("grouped_q8", 8, sizes[8], True),
             ("grouped_q4 draft", 4, DRAFT_G, True),
             ("grouped_bf16", 16, sizes[16], True)]
    # the mma.sync body at the verify's C = 12 against C = 8 and at C = 8
    # against the serve point's C = 4, the wgmma body at C = 128 against C
    # = 80 (one 128-token tile, one plan), the wide body at C = 256 against
    # C = 160 and at C = 320 against C = 256 (two 128-token tiles on the
    # wide body's splits), C = 640 against 320 (four token tiles against
    # two), the down-projection's C = 320 against 160 and the up-projection's
    # C = 416 against 400 (each with an n96 tail, whose tokens run in tile 0
    # of the other launch), each pair on one set of splits; and the wide
    # body against the wgmma body where their plans split K alike
    across = []
    both = ("up", "down")
    for c_full, c_part, labels in (
            (C_VERIFY, C_DECODE, both), (C_DECODE, C_SERVE, both),
            (C_PREFILL, 80, both), (256, C_WIDE, both), (320, 256, both),
            (640, 320, both), (320, C_WIDE, ("down",)),
            (416, 400, ("up",)), (C_WIDE, C_PREFILL, both)):
        for name, bits, g, grouped in cases:
            for label in labels:
                _, k, n = SHAPES[label]
                splits = {qk.launch_plan(c, k, n, bits)[2:4]
                          for c in (c_full, c_part)}
                if (c_full, c_part) == (C_WIDE, C_PREFILL):
                    if len(splits) > 1:
                        continue
                    across.append(f"{name} {label}")
                elif len(splits) > 1:
                    raise AssertionError(f"{name} {label}: C = {c_full} and "
                                         f"{c_part} split K differently: "
                                         f"{splits}")
                x, w = _make_bank(torch, gen, g, c_full, k, n, bits)
                what = f"{name} {label}"
                if bits == 16:
                    check(what, lambda t: ops.grouped_bf16_matmul(t, w), x,
                          c_part)
                elif grouped:
                    check(what, lambda t: ops.grouped_q_matmul(t, w), x,
                          c_part)
                else:
                    w1 = w.map(lambda t: t[0])
                    check(what, lambda t: ops.q_matmul(t, w1), x[0], c_part)
                del x, w
                torch.cuda.empty_cache()
    if not across:
        raise AssertionError("no kernel's plans at C = 128 and 160 split K "
                             "alike")
    log(f"kernels: row invariance holds for every kernel (rows of C = "
        f"{C_VERIFY} launches bit-equal to C = {C_DECODE} launches and of C "
        f"= {C_DECODE} to C = {C_SERVE}, rows of C = {C_PREFILL} launches to "
        f"C = 80 launches, rows of C = 256 launches to C = {C_WIDE} "
        f"launches, of C = 320 to C = 256, of C = 640 to C = 320, at the "
        f"down-projection of C = 320 to C = {C_WIDE} and of C = 416 to C = "
        f"400), and rows of C = "
        f"{C_WIDE} "
        f"launches to C = {C_PREFILL} launches where the two bodies split K "
        f"alike: {across}")


def _split_epilogue_check(torch, gen, qk, sizes):
    """The split-K epilogue at every row of ``SHAPES`` whose plan splits K,
    for every bank (B1 and B2 at G = 1, B3 q4 and q8 and B4 at the serving
    layout's G): the spread launch on a caller-given workspace leaves the
    split partials there, and ``out`` is byte-equal to
    ``splitk_reduce_plain`` of them, eager, on a second launch, and as the
    last of two launches in a replayed CUDA graph (the workspace poisoned
    before the replay); the same launch folded (a tile's splits in one
    block, no workspace) gives the same bytes, eager and replayed.
    Returns the (bank, row) cases checked."""
    banks = (("q4_matmul", 4, 1), ("q8_matmul", 8, 1),
             ("grouped_q4", 4, sizes[4]), ("grouped_q8", 8, sizes[8]),
             ("grouped_bf16", 16, sizes[16]))
    checked = []
    for label, (c, k, n) in SHAPES.items():
        for name, bits, g in banks:
            plan = qk.launch_plan(c, k, n, bits)
            if plan.splits == 1:
                continue
            x, w = _make_bank(torch, gen, g, c, k, n, bits)
            if bits == 16:
                def run(ws, fold=False, x=x, w=w):
                    return qk.launch_bf16(x, w, ws=ws, _fold=fold)
            else:
                def run(ws, fold=False, x=x, w=w, bits=bits, name=name,
                        n=n):
                    return qk.launch_dequant(
                        x, w.q, w.scales, bits=bits, group_size=GROUP,
                        n=n, name=name, ws=ws, _fold=fold)
            ws = torch.empty((plan.splits, g, c, n), dtype=torch.float32,
                             device="cuda")
            got = run(ws)
            want = qk.splitk_reduce_plain(ws)
            again = run(ws)
            folded = run(None, True)
            what = f"{name} {label} (G={g}, {plan.splits} splits)"
            if not (_bits_equal(torch, got, want)
                    and _bits_equal(torch, again, want)):
                raise AssertionError(f"{what}: out differs from the plain "
                                     "sum of its split partials, or between "
                                     "two launches")
            if not _bits_equal(torch, folded, want):
                raise AssertionError(f"{what}: the folded launch's bytes "
                                     "differ from the spread launch's")
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                run(ws)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                run(ws)
                last = run(ws)
                last_folded = run(None, True)
            ws.fill_(float("nan"))
            graph.replay()
            torch.cuda.synchronize()
            if not (_bits_equal(torch, last, want) and _bits_equal(
                    torch, qk.splitk_reduce_plain(ws), want)
                    and _bits_equal(torch, last_folded, want)):
                raise AssertionError(f"{what}: a replayed CUDA graph's "
                                     "out differs from the eager launch's")
            del graph, last, last_folded, folded, x, w, ws
            checked.append(f"{name} {label}")
            torch.cuda.empty_cache()
    log(f"kernels: split-K epilogue byte-equal to splitk_reduce_plain of "
        f"its partials (eager, a second launch, a replayed graph), and the "
        f"folded launch byte-equal to the spread one (eager, replayed), at "
        f"{len(checked)} bank x row cases: {checked}")
    return checked


def _exact_checks(torch, gen, gk, ops, QTensor):
    """Bit-exact contracts: grouped == per-expert loop, integer-friendly
    inputs exact, W dequantized in f32 (never rounded to bf16), an empty
    group gives exact zeros."""
    from repro_torch.core.quantization import pack_int4

    def exact_case(bits, xi, codes, scale, what):
        """Kernel and plain version bit-equal to the float64 result
        rounded once to bf16 (every product and sum is exact in f32)."""
        g, k, n = codes.shape
        q = pack_int4(codes) if bits == 4 else codes
        scales = torch.full((g, k // GROUP, n), scale, device="cuda").to(
            torch.bfloat16)
        qt_i = QTensor(q=q, scales=scales, bits=bits, group_size=GROUP)
        exact = (xi.double() @ (codes.double() * scale)).to(torch.bfloat16)
        got = ops.grouped_q_matmul(xi, qt_i)
        plain = gk.grouped_quantized_matmul_plain(
            xi, q, scales, bits=bits, group_size=GROUP)
        if not (_bits_equal(torch, got, exact)
                and _bits_equal(torch, plain, exact)):
            raise AssertionError(f"{what} q{bits} not exact")

    # each contract in the three bodies: the mma.sync body (C <= 64), the
    # wgmma body (64 < C <= 128, and two tiles at C = 161-256) and the wide
    # wgmma body (C > 128; C = 400 ends in its n96 tail)
    for bits in (4, 8):
        for c in (C_SERVE, C_DECODE, C_PREFILL, C_WIDE, 256, 400):
            x, qt = _make_bank(torch, gen, 3, c, D_MODEL, D_FF, bits)
            grouped = ops.grouped_q_matmul(x, qt)
            loop = torch.stack([ops.q_matmul(x[e], qt.map(lambda t: t[e]))
                                for e in range(3)])
            if not _bits_equal(torch, grouped, loop):
                raise AssertionError(f"grouped q{bits} != per-expert loop "
                                     f"at C={c}")
            x[1] = 0
            z = ops.grouped_q_matmul(x, qt)
            if not bool((z[1].float() == 0).all()):
                raise AssertionError(f"empty group q{bits} not exactly zero "
                                     f"at C={c}")
            del x, qt, grouped, loop, z
        qmax = 7 if bits == 4 else 127
        for c_int, c_f32 in ((5, 8), (100, 72), (C_WIDE, 300),
                             (C_SERVE, 256), (400, 400)):
            # integer-friendly: small integer x, power-of-two scales, K = 256
            xi = torch.randint(-3, 4, (2, c_int, 256), generator=gen,
                               device="cuda").to(torch.bfloat16)
            codes = torch.randint(-qmax - 1, qmax + 1, (2, 256, 128),
                                  generator=gen, device="cuda").to(torch.int8)
            exact_case(bits, xi, codes, 0.125, f"integer-friendly C={c_int}")
            # f32 dequant: scale 1 + 2^-7 (a bf16) times codes near +-qmax
            # needs up to 14 significant bits, more than bf16's 8, yet with
            # x in {-1, 0, 1} and K = 64 every product and sum is exact in
            # f32. A kernel that rounded W to bf16 gets a large share of
            # these outputs wrong (tests/test_torch_kernels.py counts them).
            xi = torch.randint(-1, 2, (2, c_f32, GROUP), generator=gen,
                               device="cuda").to(torch.bfloat16)
            mag = torch.randint(qmax - 3, qmax + 1, (2, GROUP, 256),
                                generator=gen, device="cuda")
            sign = torch.randint(0, 2, (2, GROUP, 256), generator=gen,
                                 device="cuda") * 2 - 1
            exact_case(bits, xi, (mag * sign).to(torch.int8), 1 + 2 ** -7,
                       f"f32-dequant C={c_f32}")
    torch.cuda.empty_cache()
    folded_vs_spread = _fold_loop_check(torch, gen, ops)
    for c in (5, 100, C_WIDE, 300, 256, 400):
        xb = torch.randint(-3, 4, (2, c, 256), generator=gen,
                           device="cuda").to(torch.bfloat16)
        wb = (torch.randint(-8, 8, (2, 256, 128), generator=gen,
                            device="cuda") * 0.25).to(torch.bfloat16)
        exact = (xb.double() @ wb.double()).to(torch.bfloat16)
        if not _bits_equal(torch, ops.grouped_bf16_matmul(xb, wb), exact):
            raise AssertionError(f"integer-friendly bf16 not exact at C={c}")
        xb[0] = 0
        if not bool((ops.grouped_bf16_matmul(xb, wb)[0].float() == 0).all()):
            raise AssertionError(f"empty group bf16 not exactly zero at C={c}")
    log("kernels: bit-exact checks passed in the three bodies (grouped == "
        "per-expert, integer-friendly inputs, f32 dequant, empty groups; C "
        f"= {C_SERVE}, {C_DECODE}, {C_PREFILL}, {C_WIDE}, 256 and 400, 5, "
        f"100, {C_WIDE}, {C_SERVE} and 400, 8, 72, 300, 256 and 400); "
        f"grouped launch folded == per-expert loop spread at "
        f"{folded_vs_spread}")


#: (bits, G, C) of the down-projection (K = D_FF, N = D_MODEL) at which the
#: grouped launch folds and each expert's launch of one spreads: the int8
#: bank at the serving layout's G = 4 on both wgmma bodies, the int4 bank
#: at G = 3 on the 128-token tile
FOLD_LOOP_CASES = ((8, 4, C_PREFILL), (8, 4, 320), (4, 3, C_PREFILL))


def _fold_loop_check(torch, gen, ops):
    """The bit contract across grids: at each of ``FOLD_LOOP_CASES`` the
    grouped launch runs folded and the per-expert loop's launches spread
    (both read from ``FOLDED_LAUNCHES`` / ``SPLIT_LAUNCHES``), on the same
    plan, and their bytes are equal."""
    import collections
    from repro_torch.kernels import q4_matmul as qk
    done = []
    for bits, g, c in FOLD_LOOP_CASES:
        name, one = f"grouped_q{bits}", f"q{bits}_matmul"
        body = qk.launch_plan(c, D_FF, D_MODEL, bits).body
        x, qt = _make_bank(torch, gen, g, c, D_FF, D_MODEL, bits)
        split0 = collections.Counter(ops.SPLIT_LAUNCHES)
        folded0 = collections.Counter(ops.FOLDED_LAUNCHES)
        grouped = ops.grouped_q_matmul(x, qt)
        loop = torch.stack([ops.q_matmul(x[e], qt.map(lambda t: t[e]))
                            for e in range(g)])
        split = collections.Counter(ops.SPLIT_LAUNCHES)
        split.subtract(split0)
        folded = collections.Counter(ops.FOLDED_LAUNCHES)
        folded.subtract(folded0)
        want_split = {(name, body): 1, (one, body): g}
        want_folded = {(name, body): 1, (one, body): 0}
        if ({k: split[k] for k in want_split} != want_split
                or {k: folded[k] for k in want_folded} != want_folded):
            raise AssertionError(
                f"q{bits} down G={g} C={c}: split launches {dict(+split)}, "
                f"folded {dict(+folded)}; want the grouped launch folded "
                f"and the {g} per-expert launches spread on {body}")
        if not _bits_equal(torch, grouped, loop):
            raise AssertionError(f"q{bits} down G={g} C={c}: the folded "
                                 "grouped launch differs from the spread "
                                 "per-expert loop")
        done.append(f"q{bits} G={g} C={c} ({body})")
        del x, qt, grouped, loop
        torch.cuda.empty_cache()
    return done


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20,
                    help="timed launches per kernel and shape")
    ap.add_argument("--profile", action="store_true",
                    help="profile the warm serving rerun (torch.profiler)")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "chip_smoke.json"))
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (no "
              "src/repro_torch here)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    t_start = time.perf_counter()
    smi = phase_device(torch)
    failures = []

    def run(name, fn, *a):
        """Run one phase; a failure is recorded, later phases still run
        where they can, and the script then exits non-zero."""
        try:
            return fn(*a)
        except Exception:                       # noqa: BLE001 (reported)
            failures.append(name)
            log(f"PHASE FAILED: {name}\n{traceback.format_exc()}")
            return None

    built = run("build", phase_build)
    build_s, ptxas = built if built else (None, None)
    served = run("serve", phase_serve, torch, np, args.seed, smi,
                 args.profile) if built else None
    serve, sizes, ctx = served if served else (None, None, None)
    paths = {}
    if ctx is not None:
        paths["serve"] = serve["cold"]
        for name, fn, extra in (
                ("paged == slot", phase_paged_slot, ()),
                ("overlap", phase_overlap, ()),
                ("speculative", phase_spec, (args.seed,)),
                ("prefill", phase_prefill, (args.seed,))):
            r = run(name, fn, torch, np, ctx, smi, *extra)
            if r is not None:
                paths[name] = r.get("warm" if name == "prefill" else "cold",
                                    r)
            serve[name] = r
        # the control loop: 3e needs 3f's calibrated profile, so 3f runs
        # first; 3e is not run (and counts as failed) without it
        serve["calibrate"] = run("calibrate", phase_calibrate, torch, np,
                                 ctx)
        if serve["calibrate"] is not None:
            serve["qos+dynamic"] = run("qos+dynamic", phase_qos_dynamic,
                                       torch, np, ctx, smi, args.seed)
        else:
            failures.append("qos+dynamic (no calibrated profile)")
        serve["multi-tenant"] = run("multi-tenant", phase_multi, torch, np,
                                    ctx, smi)
        serve["poisson"] = run("poisson", phase_poisson, torch, np, ctx,
                               smi, args.seed)
        for name in ("qos+dynamic", "multi-tenant", "poisson"):
            if serve.get(name) is not None:
                paths[name] = serve[name]
        _release(torch)
        serve["ep"] = run("ep", phase_ep, torch, np, ctx, smi, args.seed)
        if serve["ep"] is not None:
            paths["ep"] = serve["ep"]["engine"]["path"]
        _log_long_prompts(serve, ctx["point"].plan)
        ctx["engine"].close()
        del ctx, served          # the tuple held the params and engine too
        torch.cuda.empty_cache()
    cli = run("cli", phase_cli, torch, np, smi)
    # training runs once the serve phases have released their params
    _release(torch)
    trained = run("train", phase_train, torch, np, args.seed, smi)
    train = {"train": trained[0] if trained else None}
    if trained and built:
        train["ckpt serve"] = run("ckpt serve", phase_ckpt_serve, torch,
                                  np, trained[1], smi)
    del trained
    _release(torch)
    train["train cli"] = run("train cli", phase_train_cli, torch, np, smi)
    _release(torch)
    mesh = run("mesh", phase_mesh, torch, np, args.seed, smi) \
        if built else None
    if mesh is not None:
        for regime, rec in mesh["moe"].items():
            paths[f"9a {regime}"] = rec["serve"]["path"]
        for name in MESH_SERVE:
            paths[f"9c {name}"] = mesh["serve"][name]["path"]
    _release(torch)
    engine_mesh = run("engine mesh", phase_engine_mesh, torch, np,
                      args.seed, smi) if built else None
    if engine_mesh is not None:
        for name in ENGINE_MESH_CONFIGS:
            paths[f"11 {name}"] = engine_mesh[name]["path"]
    _release(torch)
    roofline = run("roofline", phase_roofline, torch, np, args.seed, smi)
    _release(torch)
    kimi = run("kimi", phase_kimi, torch, np, args.seed, smi) \
        if built else None
    if kimi is not None:
        paths["kimi"] = kimi["kernel"]
    _release(torch)
    qwen3 = run("qwen3", phase_qwen3, torch, np, args.seed, smi)
    _release(torch)
    families = run("families", phase_families, torch, np, args.seed, smi)
    _release(torch)
    families_train = run("families-train", phase_families_train, torch,
                         np, args.seed, smi)
    _release(torch)
    families_mesh = run("families mesh", phase_families_mesh, torch, np,
                        args.seed, smi)
    _release(torch)
    parity_err = run("parity", phase_parity, torch, np, args.seed) \
        if built else None
    kern = run("kernels", phase_kernels, torch, np, sizes, args.seed,
               args.reps, [tuple(k) for k in (engine_mesh or {}).get(
                   "launch_shapes", [])]) if sizes else None
    records, extra = kern if kern else ([], [])
    for rec in records:
        if rec.get("body") in ("wgmma", "wgmma_wide"):
            # the wgmma bodies' path is 3p's prefills; every path that books
            # launches by body shows where else they ran
            key = f"{rec['wrapper']}/{rec['body']}"
            rec["launches"] = paths.get("prefill", {}).get(
                "body_launches", {}).get(key, 0)
            rec["launches_by_path"] = {
                path: r["body_launches"].get(key, 0)
                for path, r in paths.items() if "body_launches" in r}
            rec["on_main_path"] = rec["launches"] > 0
            continue
        rec["launches"] = paths["serve"]["launches"][rec["name"]]
        rec["launches_per_decode_iter"] = {
            path: r["launches_per_decode_iter"][rec["name"]]
            for path, r in paths.items()}
        rec["launches_by_path"] = {path: r["launches"][rec["name"]]
                                   for path, r in paths.items()}
        if train.get("ckpt serve"):
            for name, r in train["ckpt serve"]["cli"].items():
                rec["launches_by_path"][f"cli {name}"] = \
                    r["launches"][rec["name"]]
        rec["on_main_path"] = rec["launches"] > 0
    total_s = time.perf_counter() - t_start
    log(f"total: {total_s:.1f} s")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
        "build_s": build_s, "ptxas": ptxas, "serve": serve, "cli": cli,
        "train": train, "mesh": mesh, "engine_mesh": engine_mesh,
        "roofline": roofline, "kimi": kimi,
        "qwen3": qwen3,
        "families": families, "families_train": families_train,
        "families_mesh": families_mesh,
        "parity_max_abs_diff": parity_err, "kernels": records,
        "kernel_shapes": extra, "failures": failures,
        "total_s": total_s}, indent=1, default=str))
    if failures:
        log(f"chip_smoke: FAILED phases: {failures}")
        return 1
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
