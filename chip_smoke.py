"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--n 16777216] [--seed 0]

Phases (any failure exits non-zero before the last line is printed):

1. card identity (``torch.cuda.get_device_name``, ``nvidia-smi``);
2. build the three kernel libraries (zones pairs, block quantizer, flash
   attention) from ``src/repro_torch/kernels/*/csrc``, one ``nvcc`` each,
   started together, each with its own flags; ``ptxas -v``'s registers,
   shared memory and spills of every kernel, and a line of its own for
   each redesigned one (the count and the histogram on the register-tiled
   walk, masked and unmasked, and the bf16 and f32 flash kernels at every
   head dim; an f32 instance that spills fails the run);
3. the device engine at full width: ``run_jobs`` of Neighbor Searching at
   15", 30" and 60" plus Neighbor Statistics (edges 1..60") over one
   shuffle of a ``make_catalog(n, seed)`` sky with ``ZonePartitioner(60")``,
   for the identity, int16 and int8 codecs; every launch counter is reset
   just before and read just after, and must equal tiers x reducers for
   the masked kernels and 0 for the others;
4. the host engine at full width: the same jobs through
   ``host_shuffle_reduce`` (``run_jobs(engine="host")`` before its
   finalize, which the script applies), keeping the identity codec's
   ``ShuffledData`` for phases 5 and 23; launches must be 3 unmasked counts,
   1 unmasked hist, and for int8 one quantize and one dequantize (the
   codec's whole-payload round trip);
5. each kernel against its plain PyTorch version, exactly: the masked ones
   on sampled partitions (first 4, last 4, fullest) of every tier of every
   codec, the unmasked ones (with and without ``exclude_self``) on sampled
   partitions of the host engine's full-width shuffle, the quantizer
   bitwise on the full-width int8 payload and on edge cases (an all-zero
   block, .5 ties, bf16 input);
6. exact cross-checks: search(r) equals the Neighbor Statistics cumulative
   count at edge r on both engines; the host engine equals the device
   engine run on the host's zone keys (identity, int16; with the card's
   own keys the difference is reported); the card equals the CPU (plain
   versions) for the device engine at 1M objects and 60" and at 50k objects
   and 0.02 rad, and for the int8 host engine (``run_jobs(engine="host")``)
   at 250k objects;
   ``token_histogram`` on both engines equals ``np.bincount`` (identity,
   int16, 4M tokens); small-n search equals the brute-force count;
7. ``stream_device``: the phase-3 catalog written with
   ``MemmapCatalogSplits.write`` to a temporary file and streamed back as
   16 splits of 2^20 rows (``run_jobs_streaming``, prefetch 2: a producer
   thread copies each split to the card through pinned memory on a side
   stream), per codec: outputs equal to phase 3's, launches tiers x
   reducers for the masked kernels and 0 for the others; the stage walls,
   ``fetch_wall_s``, ``overlap_hidden_s``, ``overlap_fraction`` and the
   host clock beside phase 3's monolithic walls;
8. ``stream_lanes`` (int16, the same splits): 4 concurrent lanes, each on a
   CUDA stream of its own, then 4 lanes with a cancellable 60 s stall on
   split 0's first fetch and speculation on: both equal phase 3, with the
   sequential run's launches; the second must clone split 0, the clone
   must win, and ``elapsed_s`` must stay far under the stall;
9. ``stream_host``: the host engine streamed over the first 2^22 rows in 8
   splits (identity, int8), equal to ``run_jobs(engine="host")`` on those
   rows, with its launches (the unmasked kernels and the quantizers);
10. ``stream_wordcount``: 64M tokens (vocab 30,000, from ``--seed``) in a
   ``MemmapTokens`` file, 16 ``TokenBlockSplits`` on the device engine,
   combiner ``"auto"`` and None: both equal ``np.bincount``, and the
   combiner cuts ``shuffle_wire_bytes`` at least 2x; then ``lanes_cards``
   where there are 2 or more cards (on one card a line says it did not
   run and why): the device engine's lanes pinned over every card (lane i
   on card i % D, 2 a card, no mesh) over the 16 splits, plain and with
   phase 8's stall and speculation, equal to phase 3 with the sequential
   launches, and wordcount in combine mode over the 64M tokens, equal to
   ``np.bincount``; the card of every split printed;
11. ``stream_spill``: phase 7's splits through the external shuffle
   (``spill=SpillConfig(budget_bytes=256 MiB)``, int16 and int8, then int16
   at budget 0 over the first ``BUDGET0_SPLITS`` splits: every split
   written synchronously, up to ``max_ranges`` ranges read back through the
   pinned copier): outputs equal to phase 3's (the budget-0 run's to a
   monolithic run over its rows),
   every split spilled, masked counts 3x the masked histograms, histograms
   between ``spill_ranges`` and 3x that, every other kernel 0,
   ``spill_peak_bytes <= budget + spill_chunk_bytes``, the spill directory
   gone; the spill accounting beside ``stream_device``'s and the
   monolithic walls. Then an int16 run whose ``write_fault`` raises on the
   second chunk: the error reaches the caller and no file is left;
12. ``stream_spill_lanes``: int16 over 4 lanes at 256 MiB (each lane
   spills its own split), then with phase 8's stall and speculation: equal
   to phase 3, the clone wins, the same launch and directory checks;
13. ``trace``: the int16 ``stream_device`` run, the int16 ``stream_spill``
   run and the speculated lanes run under a ``Tracer``: no open span, the
   stage, spill and lane span names present, ``export_json`` parses; the
   summary and the walls with and without the tracer;
14. ``energy``: ``NvmlMeter`` (NVML through ctypes) must be available; 1 s
   of counter reads (its steps and the idle watts), then the int16
   monolithic device run repeated for >= 2 s under it: joules a run, by
   stage, ``rows_per_joule``; ``ModeledMeter``'s figures (modeled watts of
   the paper's node classes, not measured) for that run and for phase 4's
   host-engine int16 run;
15. ``calibrate``: the cost model's replay of the masked pair count
   (``get_cost_model(calibrate=True)``, its cache in a temporary
   directory): 7 probes from launch-bound to about a millisecond, timed with
   CUDA events; the fitted rates beside the ``DeviceSpec`` peaks (SMs from
   the device properties, clock and power limit from NVML), which none may
   exceed, and every probe after the anchor predicted within 2x;
16. ``auto_knobs``: ``codec="auto", tile="auto"`` on the device and host
   engines (the model picks identity, the one exact codec), equal to phases
   3 and 4 with their launches, the chosen tile, tiers and predicted beside
   measured walls; ``run_jobs(split_rows="auto")`` and
   ``SpillConfig(budget_bytes=256 MiB, n_ranges="auto")`` over 16 splits
   (int16), equal to phase 3 with the spill checks of phase 11;
17. ``amdahl``: the int16 device run again under the calibrated model:
   ``prediction_error``, and ``roofline(1, chip_w)`` priced at the card's
   spec with its NVML power limit, beside ``to_dict()["amdahl"]`` and
   ``balance_report``;
18. ``mr_service``: ``MRQueryService`` on the card over 2 lanes, one int16
   catalog load, then 64 closed-loop requests of ``serve_mr``'s 4-query mix
   (search at 60/30/15" plus statistics) and 64 paced at half the
   closed-loop qps: every output equal to ``run_jobs([job], xyz)``, one
   masked launch per tier and distinct job of each batch,
   ``latency_summary`` beside the per-query ``run_jobs`` wall;
19. ``mesh_device``: the data-axis mesh (``launch/mesh.py``), first as a
   world of one NCCL rank in this process (D = 1: the unsharded reduce)
   for int16 and int8, equal to phase 3 with its launches, and one NCCL
   all-reduce of a ``BUCKET_BYTES`` bucket over that rank (its
   communicator's set-up and its first call timed apart); then
   ``MESH_WORLD`` gloo ranks spawned on the one card (NCCL takes one card
   a rank; on 2 or 4 cards an NCCL world runs too), each rank's first
   full-width run timed apart (``mesh_device_cold``): ``run_jobs(...,
   mesh=)`` on a ("data",) mesh of 4, int16 and int8, each rank reducing
   its quarter of every tier's rows through the masked kernels and
   all-reducing the partials; every rank equal to phase 3 (rank 0 also
   checks all ranks with ``all_gather_object``), one masked launch per
   tier and reducer on every rank;
20. ``mesh_host``: the host engine under that mesh (int8), equal to phase
   4, its unmasked launches on each rank's rows and the codec's quantizer;
21. ``mesh_stream``: 16 splits of the catalog, then spilled at
   ``SPILL_BUDGET`` (each rank its own directory, gone after), equal to
   phase 3 with phase 11's spill checks;
   ``mesh_service``, in every world: ``MRQueryService(mesh=)`` over the
   full-width catalog (60", int16, tile 256, 2 lanes), rank 0 taking the
   clients and the other ranks following its batches: a warm batch of the
   4-query mix and a batch holding a query whose reducer raises on rank 1
   only (``RankPoison``), both through ``run_pending`` under the census,
   then 64 closed-loop requests through ``start``/``close``. Every rank's
   outputs equal phase 18's; the poison fails on every rank with rank 1's
   message and its batch-mates are served; masked launches are tiers x
   distinct jobs a batch; one all-reduce a batch (the census of the
   ``run_pending`` batches, the service's batch records of the others);
   qps, p50, p99, batch sizes and ``collective_wall_s`` per rank;
22. ``mesh_collectives``: the flat, hierarchical and int8-compressed
   all-reduce of one 256 MiB f32 bucket on (pod 2, data 2), each timed
   after one untimed call: hierarchical within rtol 1e-6 of flat, the
   compressed ones within ``md_check.py``'s 0.03 max|flat|,
   ``compressed_psum_1d`` bit for bit the port's quantizer applied rank
   by rank, through the quantize kernels. Each mesh phase prints per rank
   the host wall, the map, shuffle and reduce walls, the time in
   collectives (``collective_wall_s``), ``n_shards``,
   ``shard_padded_ratio``, the collective census (``core/op_census.py``),
   the c10d operators with their tensors' device and the launches, which
   count toward the kernel table (the census is entered once first in each
   process, since its first use imports PyTorch's dispatch machinery);
   ``example``: ``examples/torch_neighbor_search.py --n 1048576`` as a
   subprocess on the card: exit 0, and every count it prints equal to
   ``run_jobs`` here on its catalog;
23. kernel times (CUDA events, median of 5) at the main paths' full-width
   shapes, beside the plain version's time (the seconds-long pair versions:
   one call, no warm-up; the quantizer's: median of 3) and the bound; a
   pair row's time covers ``launches_per_timed_call`` launches (the masked
   ones: one per tier) and ``x_bound`` is its time over its bound;
24. ``lm_prefill``: TinyLlama-1.1B at its published widths, bf16 weights
   drawn from ``--seed``, ``make_prefill_step`` over 8 prompts of 2,048
   tokens (``max_len`` 2,080): wall, tokens/s, exactly one flash launch per
   layer (22) and no other;
25. ``lm_decode``: 32 greedy ``make_decode_step`` steps from that cache (no
   launch of any kernel): ms per step, tokens/s; the first step's logits
   against a full ``forward`` over the 2,049 tokens, relative error < 0.07
   (``tests/test_smoke_archs.py``'s check);
26. ``lm_serve``: ``python -m repro_torch.launch.serve``'s ``main`` with its
   defaults (8 requests, 4 slots, 16 new tokens, ``max_len`` 128): all 8
   finish and the engine ends closed;
27. ``flash_vs_plain``: the flash kernel against ``attention_ref`` on layer
   0's q/k/v at the prefill shape, in bf16 and in f32 (``<64>``, G = 8: the
   instance the f32 mesh phases run; layer 0's norm, projections and
   rotation run in f32, so q/k/v hold full f32 mantissas and a kernel that
   rounded them to TF32 would miss 1e-5), and over the test sweep
   (``tests/test_torch_cases.py``: f32 and bf16, and the f32 family and
   tile-edge cases), to 1e-5 / 3e-2; both prefill instances timed beside
   the plain version, the bound and ``scaled_dot_product_attention``
   (timed only, never used by the port; ``x_sdpa`` is the kernel's time
   over its time), the f32 one as the ``f32`` entry of the line and an
   instance of the row;
28-32. ``lm_olmo``, ``lm_starcoder2``, ``lm_gemma2``, ``lm_recurrentgemma``,
   ``lm_mamba2`` (``FAMILY_PHASES``): each architecture at its published
   widths, bf16 weights from ``--seed``: prefill (olmo, starcoder2 and
   mamba2 4 x 2,048, 2,048 and 2,100 tokens; gemma2 1 x 4,608 and
   recurrentgemma 2 x 2,560, past their windows), exactly one flash launch
   per attention layer and no other; 16 greedy decode steps; prefill's last
   logits and every step's held against one ``forward`` over the same
   tokens (max |diff| under ``FAMILY_REL`` of max |logit|, argmax equal on
   every row whose top-2 margin exceeds twice that diff); the flash kernel
   against its plain version on the first attention layer's q/k/v at the
   family's dtype, head dim, window and softcap (``FLASH_TOL``),
   timed beside the plain version, its bound and SDPA where SDPA computes
   the same function; then ``launch/serve.py --arch`` on 4 requests. The
   flash row of the kernel table counts these prefills' launches and
   lists each instance;
33-34. ``lm_granite_moe``, ``lm_deepseek_v3``: the mixtures of experts the
   same way. granite-moe-3b-a800m at its published widths and depth (32
   layers, 40 experts padded to 48, top-8), 4 x 2,048 tokens: two
   dispatch chunks of 4,096, ``C_exp`` 1,072 rows an expert, one flash
   launch a layer (bf16 ``<64>``, GQA 24/8). deepseek-v3-671b at its
   published widths with its depth cut from 61 to 4 layers
   (``FAMILY_LAYERS``: the 3 dense layers and one MoE layer, 256 experts
   top-8 and a shared one; 15.8e9 parameters), 2 x 2,048 tokens: no flash
   launch (MLA's q/k head dim 192 against v's 128; the kernel takes one),
   and its f32 check runs on the weights turned f32 in place (63 GB: a
   copy beside the bf16 model would not fit). For both, the first MoE
   layer on its actual prefill input against a plain per-expert version on
   the card (``moe_vs_plain``: kept assignments equal, output within
   ``MOE_REL`` of max |y|, dropped assignments per chunk and the padded
   ratio printed); prefill + decode held to one forward on the rows the two
   calls route alike (``test_torch_cases.routed_alike``: the two chunk the
   batch differently, so capacity drops differ, and a dropped token
   changes the later tokens of its sequence; the excluded rows are
   counted);
   the weight bytes a decode step reads and their floor at 3.35 TB/s
   beside the measured step. ``lm_deepseek_v3_blocked_causal``: ``attend(
   impl="blocked_causal", chunk=256)`` on the first MLA layer's q/k/v at
   the prefill shape in f32 (a call flash does not take) against
   ``impl="chunked"``, within 1e-5 of max |o|, no launch, both timed;
35-36. ``lm_musicgen``, ``lm_internvl2``: the last two architectures at
   their published widths and depth, as phases 28-32. musicgen-medium (48
   layers, d_model 1,536, 24 heads of 64, GELU, LayerNorm, sinusoidal
   positions) 4 x 1,500 tokens (30 s of EnCodec frames) with ``cond``
   [4, 64, 1,536]: 48 flash launches a prefill (bf16 ``<64>``, G = 1) and
   none for its 48 cross-attention layers (the masked formula).
   internvl2-2b (24 layers, GQA 16/8 at head dim 128) 4 x 2,048 tokens,
   the first 256 replaced by ``prefix`` patch embeddings: 24 flash
   launches a prefill (bf16 ``<128>``, G = 2). ``cond`` and ``prefix`` are
   the stub frontends' outputs, bf16 from ``--seed``
   (``model.stub_frontend``), in prefill and in every forward it is held
   to;
37. ``train_tinyllama``: TinyLlama-1.1B at its published widths and depth,
   bf16 weights from ``--seed``, the ``RunConfig`` defaults (bucketed
   AdamW, remat "full", sharded on one card) with ``TRAIN_RC``'s schedule,
   8 steps on one repeated 4 x 2,048 batch: exactly 44 flash launches a
   step (the forward and its recompute) and no other, finite metrics, the
   loss down by more than ``LOSS_DROP``, the first loss within 0.07 of
   ``loss_fn`` in f32 on the same weights; step wall, tokens/s, peak;
38. ``train_resume``: ``launch/train.py``'s ``train()`` on TinyLlama cut to
   2 layers, 4 steps, a checkpoint and 4 more against 8 under
   deterministic algorithms (rtol 1e-4), then a blocking save and restores
   (whole, and with host 0 failed) equal bit for bit; checkpoint bytes,
   save and restore walls;
39. ``train_granite_moe``: granite-moe-3b-a800m cut to 8 layers, 3 steps of
   4 x 2,048 with the aux loss (the MoE backward), 2 flash launches a
   layer a step;
40. ``train_mesh``: the replicated step's explicit sync on 4 gloo ranks on
   the card (TinyLlama cut to 2 layers, f32, 2 rows a rank): its
   first-step moments against one rank's step on the whole batch, and
   with ``compress_grads`` (int8 on the pod phase) the loss within 0.15,
   the quantize launches printed;
41. ``train_fsdp``: FSDP (``pod_param_mode`` "sharded" and "data") on 4
   gloo ranks on the card, the default mode now that it is ported:
   TinyLlama cut to 2 layers, f32, 2 rows x 512 a rank, "sharded" on (4,)
   and "data" on (2, 2), each step's loss and grad norm against one rank's
   step on the whole batch and the first step's moments within
   ``MESH_TRAIN_REL``; granite-moe cut to 2 layers, f32, held to the
   replicated step on the same mesh; per rank the state's bytes against
   the replicated state's (at most 1/F plus padding), the allocator's
   bytes after ``init_state``, the peak and wall of a step, the
   all-gathers and reduce-scatters of a step and their bytes, the flash
   launches. On 4 or more cards, granite-moe at all 32 layers, bf16,
   bucketed AdamW, 4 x 2,048, over NCCL one card a rank (a model no card
   holds with its AdamW state): finite falling losses, each card's peak,
   tokens/s; on fewer cards one line says why it did not run. The kernel
   table's launch counts take in phases 37-41;
42-43. ``moe_ep`` and ``train_ep``: the expert-parallel MoE layer at
   published widths on 4 gloo ranks against ``moe_ep_plain``, and the EP
   train step: granite cut to 2 layers on (2, 2) and (1, 4), its
   attention and vocabulary tensor parallel beside the experts, and
   deepseek-v3 at reduced widths on (2, 2), the experts over ``model``
   beside MLA's heads, its FFNs and vocabulary tensor parallel, each held
   to one rank's step, a rank's parameter bytes at most 1/(F tp) of the
   cut tensors and 1/F of the copies; on 4 cards granite at 32 layers on
   (2, 2) over NCCL (``train_ep_cards``, its step beside the
   dense-copies layout's and FSDP's);
44. ``train_tp``: tensor parallelism over the model axis on 4 gloo ranks
   (``TP_TRAIN_RUNS``: TinyLlama cut to 2 layers, f32, on (1, 4) and
   (2, 2) "sharded" and with the explicit int8 sync on (2, 2); mamba2
   cut to 2 layers (its SSD heads cut) on (1, 4) and (2, 2);
   recurrentgemma cut to one unit of 3 layers on (2, 2), its RG-LRU
   channels cut and its local attention's 10 heads 5 a rank, and on
   (1, 4), its 640 channels a rank straddling the 256-channel gate blocks
   and its attention sharding the sequence), each held to one rank's
   step, every rank's metrics equal, the parameter bytes as in 43, flash
   twice a layer a step on every rank's local heads where the ranks
   divide them (checked against its plain version at 8/1, 16/2, 12/4 and
   6/2 heads, and recurrentgemma's 5/1 at head dim 256 in f32 at the
   train and serve shapes and past its window), the census, walls, peaks;
45. ``serve_tp``: TinyLlama's ``ServeEngine`` at 22 layers in f32 on 2
   gloo ranks, (1, 2): with f32 caches the same tokens and steps as one
   rank's engine, logits within ``FAMILY_REL``; with the default bf16
   cache within bf16's bound (the near-tie rule); one flash launch a
   layer a prefill on every rank; prefill seconds and decode ms beside
   one rank's; ``serve_tp_fsdp``: TinyLlama's prefill (2 x 1,024) and 8
   decode steps at 22 layers in f32 on (2, 2) over 4 gloo ranks, its
   weights FSDP-sharded over the data ranks ("sharded", each unit
   gathered as it runs) and whole over them ("replicated"): one rank's
   tokens, one flash launch a layer a prefill on every rank, parameter
   and cache bytes, prefill seconds and decode ms under both; then
   mamba2-1.3b (48 layers), recurrentgemma-2b (26 layers, flash on 5
   heads a rank in its 8 local layers, its cache half of the head dim a
   rank) and internvl2-2b (24 layers, its cache half the positions a
   rank) the same way with f32 caches in the same world of 2 ranks
   (``SERVE_TP_FAMILIES``); ``serve_tp_cards``
   TinyLlama in bf16 on (1, 4) over NCCL on 4 cards, then recurrentgemma
   (a quarter of the head dim cached a rank) and deepseek-v3 (cut to 4
   layers, a quarter of MLA's latent a rank) the same way, deepseek on the
   rows whose tokens the ranks and one card send to the same experts;
   ``serve_fsdp_cards``: ``serve_tp_fsdp``'s run over NCCL on 4 cards, one
   a rank, TinyLlama "sharded" and "replicated", internvl2-2b (positions
   cut) and recurrentgemma-2b (head dim cut) "sharded", each held to one
   card; ``cli_cards``: ``launch/serve.py`` and ``launch/train.py`` with
   ``--mesh 2x2`` on 4 cards (NCCL), the serve CLI against one card's
   steps, the train CLI's crash and restart against its uninterrupted run
   and one card's first loss. On one card these three print one line
   each saying why they did not run.
46. ``dryrun``: ``launch/dryrun.py`` on ``DRYRUN_CELLS`` (TinyLlama's
   ``train_4k``, ``prefill_32k`` and ``decode_32k`` on 16x16, granite-moe's
   ``train_4k`` on 2x16x16 optimized, mamba2's ``long_500k``, deepseek-v3's
   ``decode_32k``, ``prefill_32k`` and ``train_4k`` and musicgen's
   ``decode_32k`` on 16x16; deepseek-v3's ``train_4k`` starts right after
   the build and its ``prefill_32k`` before phase 44), a process (one fake
   world) a
   cell, priced on this card: each ``ok`` and within the card's 80 GB, its
   argument and temp bytes a device, the dominant term and the trace
   seconds; then the dry run held to real steps on the card
   (TinyLlama cut to 2 layers, bf16, a 4 x 2,048 train step; at 22 layers
   one decode step of 4 slots at ``max_len`` 2,048; cut to 2 layers, f32,
   "sharded" on (2, 2) over 4 gloo ranks): the census on ``meta`` equals
   the card's operator by operator (FLOPs, element-wise FLOPs, bytes,
   flash launches, each collective), the argument bytes exactly, the
   predicted temp bytes within ``DRYRUN_PEAK_REL`` of the allocator's
   (1% on one card, 10% on the gloo ranks).
   Their launches count toward the kernel table.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
``nvidia-smi``'s name and power limit; the one before that the kernel table
(seven kernels; the flash row's launches also split by the kernel its
inputs' dtype chose, ``flash_fwd_kernel`` for f32 and ``flash_tc_kernel``
for bf16, from ``VARIANT_LAUNCHES``). Imports nothing of ``jax`` or
``repro``.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

SEARCH_ARCSEC = (15, 30, 60)
CODECS = ("identity", "int16", "int8")
FP32_OPS_PER_CELL = 5          # 3 FMUL + 2 FADD, no FMA (see the .cu note)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, dense tensor cores
ZP_SOURCE = "src/repro_torch/kernels/zones_pairs/csrc/zones_pairs.cu"
Q_SOURCE = "src/repro_torch/kernels/quantize/csrc/quantize.cu"
FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
REPLACES = {
    "pair_count_masked": "src/repro/kernels/zones_pairs/kernel.py:167",
    "pair_hist_masked": "src/repro/kernels/zones_pairs/kernel.py:192",
    "pair_count": "src/repro/kernels/zones_pairs/kernel.py:75",
    "pair_hist": "src/repro/kernels/zones_pairs/kernel.py:94",
    "quantize": "src/repro/kernels/quantize/kernel.py:39",
    "dequantize": "src/repro/kernels/quantize/kernel.py:58",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:77",
}
# the pair kernels on the register-tiled walk (zones_pairs.cu): the count
# and the histogram, masked (<1>) and unmasked (<0>)
REDESIGNED = ("count_tiled_kernel<1>", "count_tiled_kernel<0>",
              "hist_tiled_kernel<1>", "hist_tiled_kernel<0>")
VOCAB = 30_000                 # < 32767: the int16 token codec is lossless
STREAM_ROWS = 1 << 20          # rows per catalog split (16 at 2^24 objects)
STALL_S = 60.0                 # the speculated run's injected stall
HOST_STREAM_N = 1 << 22        # the host engine's streamed rows (8 splits)
WC_TOKENS, WC_SEQ = 1 << 26, 2048    # streamed wordcount: 64M tokens
SPILL_BUDGET = 256 << 20       # the spill phases' budget: 256 MiB
BUDGET0_SPLITS = 4             # the budget-0 spill's splits (2^22 rows)
MESH_WORLD = 4                 # gloo ranks sharing the card (mesh phases)
POISON_RANK = 1                # mesh_service's poison query fails there
EXAMPLE_N = 1 << 20            # examples/torch_neighbor_search.py's --n
STREAM_N_SPLITS = 16           # mesh_stream's splits
BUCKET_BYTES = 256 << 20       # one f32 gradient bucket: the reference's
                               # bucket_bytes (core/buckets.py:36)
ENERGY_LOOP_S = 2.0            # the metered loop of monolithic int16 runs
ENERGY_FIELDS = ("energy_j", "map_energy_j", "shuffle_energy_j",
                 "reduce_energy_j", "fetch_energy_j", "combine_energy_j",
                 "spill_energy_j")
INT8_CPU_N = 250_000           # int8 host engine card == CPU: CPU side < 1 min
LM_ARCH = "tinyllama-1.1b"
LM_BATCH, LM_PROMPT, LM_DECODE = 8, 2048, 32     # max_len = prompt + decode
# flash kernel vs plain: |got - want| <= atol + rtol |want|. The atols are
# test_flash_sweep's, whose outputs stay below 1; layer 0's outputs reach 4-8,
# where one bf16 ulp is 2^-5, so bf16 also allows 1e-2 of |want| (2.5 ulps)
FLASH_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (3e-2, 1e-2)}


T0 = time.perf_counter()


def emit(**kw) -> None:
    """One JSON line; a phase's line also carries ``t_s``, the seconds
    since the script started."""
    if "phase" in kw:
        kw["t_s"] = time.perf_counter() - T0
    print(json.dumps(kw, default=float), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def host_keyed_zones(radius: float):
    """A ``ZonePartitioner`` whose device map takes its zone keys from the
    host ``assign`` (numpy's arcsin), as the host engine does, in place of
    the device's own asin. The two arcsins differ in the last bit for a few
    points per million, which then land in the neighbouring zone."""
    from repro_torch.mapreduce import Partitioner, ZonePartitioner

    class HostKeyedZones(ZonePartitioner):
        assign_device = Partitioner.assign_device

    return HostKeyedZones(radius)


def zone_jobs(codec: str, tile: int = 256, radius=None, edges_arcsec=None,
              host_keys: bool = False):
    """Search at each radius of SEARCH_ARCSEC (or at ``radius``) plus
    statistics, batched over one ZonePartitioner (``host_keys``: one from
    ``host_keyed_zones``)."""
    from repro_torch.data.sky import ARCSEC
    from repro_torch.mapreduce import (ZonePartitioner, neighbor_search_job,
                                       neighbor_statistics_job)
    radii = ([a * ARCSEC for a in SEARCH_ARCSEC] if radius is None
             else [radius])
    part = (host_keyed_zones if host_keys else ZonePartitioner)(radii[-1])
    jobs = [neighbor_search_job(r, partitioner=part, codec=codec, tile=tile)
            for r in radii]
    jobs.append(neighbor_statistics_job(edges_arcsec, partitioner=part,
                                        codec=codec, tile=tile))
    return jobs


def outputs(results):
    return [r.output if isinstance(r.output, int) else
            np.asarray(r.output).tolist() for r in results]


# Itanium mangling's one-letter builtin types that the kernels' template
# arguments use
BUILTIN_TYPES = {"b": "bool", "i": "int", "f": "float", "d": "double"}


def kernel_name(mangled: str) -> str:
    """A kernel's mangled name -> its name and template arguments:
    '_ZN12_GLOBAL__N_115flash_tc_kernelILi64EEEv...' ->
    'flash_tc_kernel<64>', '...15quantize_kernelI13__nv_bfloat16EEv...' ->
    'quantize_kernel<__nv_bfloat16>'. Reads length-prefixed names, nested
    names (``N...E``, joined with ``::``), literals (``Li64E``, ``Lb0E``)
    and builtin types; a name it cannot read comes back as it is."""
    pos = 0

    def source_name():                  # <length><identifier>
        nonlocal pos
        digits = re.match(r"\d+", mangled[pos:])
        pos += digits.end()
        name = mangled[pos:pos + int(digits.group())]
        pos += len(name)
        return name

    def nested():                       # N <name>... [I <args> E] E
        nonlocal pos
        pos += 1
        parts = []
        while mangled[pos] != "E":
            parts.append(source_name() + template_args())
        pos += 1
        return parts

    def template_args():                # I <arg>... E, or nothing
        nonlocal pos
        if mangled[pos] != "I":
            return ""
        pos += 1
        args = []
        while mangled[pos] != "E":
            args.append(arg())
        pos += 1
        return f"<{','.join(args)}>"

    def arg():
        nonlocal pos
        c = mangled[pos]
        if c == "L":                    # L <type> <value> E
            end = mangled.index("E", pos)
            value = mangled[pos + 2:end]
            pos = end + 1
            return "-" + value[1:] if value.startswith("n") else value
        if c == "N":
            return "::".join(nested())
        if c.isdigit():
            return source_name() + template_args()
        pos += 1
        return BUILTIN_TYPES[c]

    try:
        if not mangled.startswith("_Z"):
            return mangled
        pos = 2
        if mangled[pos] == "N":
            return nested()[-1]
        return source_name() + template_args()
    except (AttributeError, IndexError, KeyError, ValueError):
        return mangled


def ptxas_summary(log: str) -> list:
    """``nvcc -Xptxas -v``'s report, one dict per kernel: its name (read
    from the mangled one), registers, shared memory, stack, spill stores and
    loads, and any performance warning that names it."""
    rows, cur = {}, None
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", ln)
        if entry:
            cur = rows.setdefault(entry.group(1), {
                "kernel": kernel_name(entry.group(1)), "warnings": []})
            continue
        warn = re.search(r"\((C\d+)\) (.*) for the function '(\w+)'", ln)
        if warn:
            rows.setdefault(warn.group(3), {
                "kernel": kernel_name(warn.group(3)), "warnings": []}
            )["warnings"].append(f"{warn.group(1)} {warn.group(2)}")
            continue
        if cur is None:
            continue
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
        if spill:
            cur.update(stack_bytes=int(spill.group(1)),
                       spill_stores=int(spill.group(2)),
                       spill_loads=int(spill.group(3)))
        used = re.search(r"Used (\d+) registers", ln)
        if used:
            smem = re.search(r"(\d+) bytes smem", ln)
            cur.update(registers=int(used.group(1)),
                       static_smem_bytes=int(smem.group(1)) if smem else 0)
    return list(rows.values())


def check_outputs(results, n_edges: int) -> None:
    *search, stats = results
    for r in search:
        if not isinstance(r.output, int):
            raise AssertionError(f"search output {r.output!r} is not an int")
    hist = np.asarray(stats.output)
    if hist.shape != (n_edges,) or hist.dtype.kind != "i":
        raise AssertionError(f"stats output {hist.shape} {hist.dtype}")
    cum = np.cumsum(hist)
    for r, arcsec in zip(search, SEARCH_ARCSEC):
        if r.output != int(cum[arcsec - 1]):
            raise AssertionError(f"search({arcsec}\") {r.output} != stats "
                                 f"cum {int(cum[arcsec - 1])}")


def launch_counts(**launched) -> dict:
    """The whole launch-count dict, every kernel's and every variant's
    (``VARIANT_LAUNCHES``): ``launched`` and 0 for every other."""
    from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES
    return {k: launched.get(k, 0) for k in (*LAUNCHES, *VARIANT_LAUNCHES)}


def flash_launches(n: int, dtype) -> dict:
    """``launch_counts`` of ``n`` flash launches on ``dtype`` inputs."""
    variant = ("flash_attention_f32" if dtype == torch.float32
               else "flash_attention_bf16")
    return launch_counts(flash_attention=n, **{variant: n})


def read_launches() -> dict:
    """Every kernel's and every variant's launch count now."""
    from repro_torch.kernels import LAUNCHES, VARIANT_LAUNCHES
    return {**LAUNCHES, **VARIANT_LAUNCHES}


def zone_launches(engine: str, codec: str, jobs, st) -> dict:
    """What one batched search+stats run must launch: per tier one masked
    kernel per reducer (device engine), or one unmasked kernel per reducer
    plus, for int8, the codec's quantize and dequantize (host engine)."""
    if engine == "device":
        return launch_counts(pair_count_masked=len(st.tiers) * (len(jobs) - 1),
                             pair_hist_masked=len(st.tiers))
    q = int(codec == "int8")
    return launch_counts(pair_count=len(jobs) - 1, pair_hist=1, quantize=q,
                         dequantize=q)


def counted(fn, launches: dict, want: dict | None = None):
    """Run ``fn`` with every launch count set to 0 just before and read just
    after, between two synchronizes, and add the counts to ``launches``;
    with ``want`` (a ``launch_counts`` dict) they must equal it.
    -> (fn's result, host-clock wall, counts)."""
    from repro_torch.kernels import reset_launch_counts
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    if want is not None and counts != want:
        raise AssertionError(f"launches {counts} != {want}")
    for k in launches:
        launches[k] += counts[k]
    return out, wall, counts


def stage_summary(st) -> dict:
    return {k: v for k, v in st.to_dict().items()
            if k.endswith(("_s", "_bytes", "_ratio", "flops"))
            or k in ("n_items", "n_partitions", "device", "tiers")}


def sample_rows(n_owned: torch.Tensor) -> torch.Tensor:
    """First 4, last 4 and the fullest partition rows."""
    Pt = n_owned.shape[0]
    idx = set(range(min(4, Pt))) | set(range(max(0, Pt - 4), Pt))
    idx.add(int(torch.argmax(n_owned)))
    return torch.tensor(sorted(idx), device=n_owned.device)


def check_equal(what: str, got, want) -> float:
    """Integers (or bit patterns) must be equal. -> max absolute error."""
    got, want = torch.as_tensor(got).cpu(), torch.as_tensor(want).cpu()
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel {got.tolist()[:8]} != plain "
                             f"{want.tolist()[:8]}")
    return 0.0


def masked_vs_plain(cat, jobs) -> float:
    """Both masked kernels against their plain versions on sampled rows of
    every tier. -> max absolute error (0)."""
    from repro_torch.kernels.zones_pairs import kernel, ref
    *search, stats = jobs
    for t, tier in enumerate(cat.sd.tiers):
        rows = sample_rows(tier.n_owned)
        a = cat.codec.decode_device(*(w[rows] for w in tier.owned_wire))
        b = cat.codec.decode_device(*(w[rows] for w in tier.bucket_wire))
        a, b = a.contiguous(), b.contiguous()
        na, nb = tier.n_owned[rows].contiguous(), tier.n_bucket[rows].contiguous()
        for j in search:
            cmin = j.reducer.cos_min()
            check_equal(f"tier {t} count r={j.reducer.radius}",
                        kernel.pair_count_masked_cuda(a, b, na, nb, cmin),
                        ref.pair_count_masked_ref(a, b, na, nb, cmin))
        edges = stats.reducer.cos_edges().to(a.device)
        check_equal(f"tier {t} hist",
                    kernel.pair_hist_masked_cuda(a, b, na, nb, edges),
                    ref.pair_hist_masked_ref(a, b, na, nb, edges))
    return 0.0


def unmasked_vs_plain(sd, jobs, device) -> float:
    """Both unmasked kernels, with and without ``exclude_self``, against
    their plain versions on sampled partitions of the host engine's
    shuffle. -> max absolute error (0)."""
    from repro_torch.kernels.zones_pairs import kernel, ref
    *search, stats = jobs
    rows = sample_rows(torch.as_tensor(sd.n_owned)).numpy()
    a = torch.as_tensor(sd.owned[rows], device=device)
    b = torch.as_tensor(sd.bucket[rows], device=device)
    edges = stats.reducer.cos_edges().to(device)
    for excl in (False, True):
        for j in search:
            cmin = j.reducer.cos_min()
            check_equal(f"unmasked count r={j.reducer.radius} excl={excl}",
                        kernel.pair_count_cuda(a, b, cmin, exclude_self=excl),
                        ref.pair_count_ref(a, b, cmin, exclude_self=excl))
        check_equal(f"unmasked hist excl={excl}",
                    kernel.pair_hist_cuda(a, b, edges, exclude_self=excl),
                    ref.pair_hist_ref(a, b, edges, exclude_self=excl))
    return 0.0


def int8_payload(xyz, device) -> torch.Tensor:
    """The int8 codec's host payload: the catalog flattened and zero-padded
    to whole 256-element blocks, as one [1, n_pad] row on the card."""
    flat = torch.as_tensor(xyz.reshape(-1), device=device)
    n_pad = -(-flat.numel() // 256) * 256
    return torch.nn.functional.pad(flat, (0, n_pad - flat.numel()))[None]


def quantize_vs_plain(payload) -> float:
    """The quantizer bitwise on the payload and on edge cases. -> max
    absolute error (0)."""
    from repro_torch.kernels.quantize import kernel, ref
    edge = torch.zeros((2, 1024), device=payload.device)
    edge[1, :5] = torch.tensor([127.0, 0.5, 1.5, 2.5, -2.5])  # scale 1: ties
    edge[1, 256:512] = payload[0, :256]
    cases = [("payload", payload), ("edges", edge),
             ("edges bf16", edge.to(torch.bfloat16)),
             ("payload bf16", payload[:, :1 << 20].to(torch.bfloat16))]
    for name, x in cases:
        q, s = kernel.quantize_cuda(x)
        wq, ws = ref.quantize_ref(x)
        check_equal(f"quantize {name} codes", q, wq)
        check_equal(f"quantize {name} scales", s.view(torch.int32),
                    ws.view(torch.int32))
        check_equal(f"dequantize {name}",
                    kernel.dequantize_cuda(q, s).view(torch.int32),
                    ref.dequantize_ref(q, s).view(torch.int32))
    q, s = kernel.quantize_cuda(edge)
    if q[1, :5].tolist() != [127, 0, 2, 2, -2] or q[0].any() \
            or s[0, 0].item() != np.float32(1e-12):
        raise AssertionError(f"edge codes {q[1, :5].tolist()}, zero-block "
                             f"scale {s[0, 0].item()}")
    return 0.0


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median over ``reps`` of one call of ``fn``, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_row(name, source, launches, max_err, ms, plain_ms, bound_ms,
               bound_by, library_ms=None, tolerance="exact", **extra) -> dict:
    """One row of the kernel table. The run has already held every output
    of the kernel against its plain version to ``tolerance`` (or raised)."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max_err, "tolerance": tolerance,
            "match_plain": True,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, **extra}


def time_kernels(cat, jobs, sd, payload, launches: dict, max_err: dict
                 ) -> list:
    """Time each kernel at its main path's full-width shapes (masked: every
    tier of the device engine, one reducer's whole reduce; unmasked: the
    host engine's one launch over all partitions; quantizer: the int8
    payload), beside its plain version and its bound."""
    from repro_torch.kernels.quantize import kernel as qk, ref as qr
    from repro_torch.kernels.zones_pairs import kernel, ref
    dev = payload.device
    tiers = []
    for tier in cat.sd.tiers:
        tiers.append((cat.codec.decode_device(*tier.owned_wire).contiguous(),
                      cat.codec.decode_device(*tier.bucket_wire).contiguous(),
                      tier.n_owned, tier.n_bucket))
    real_cells = float(sum(
        (no.double() * nb.double()).sum().item() for _, _, no, nb in tiers))
    props = torch.cuda.get_device_properties(0)
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    lanes = props.multi_processor_count * 128            # FP32 lanes per SM
    ops_rate = lanes * clock_hz

    def ops_bound(cells):
        return FP32_OPS_PER_CELL * cells / ops_rate * 1e3

    cmin = jobs[-2].reducer.cos_min()                     # 60" search
    edges = jobs[-1].reducer.cos_edges().to(dev)

    def per_tier(fn, *arg):
        return lambda: [fn(a, b, na, nb, *arg) for a, b, na, nb in tiers]

    rows = []
    for name, kern, plain, arg in (
            ("pair_count_masked", kernel.pair_count_masked_cuda,
             ref.pair_count_masked_ref, cmin),
            ("pair_hist_masked", kernel.pair_hist_masked_cuda,
             ref.pair_hist_masked_ref, edges)):
        ms, bound = cuda_ms(per_tier(kern, arg)), ops_bound(real_cells)
        rows.append(kernel_row(
            name, ZP_SOURCE, launches, max_err[name], ms,
            cuda_ms(per_tier(plain, arg), reps=1, warmup=0),
            bound, "operations", cells=real_cells, sm_clock_hz=clock_hz,
            x_bound=ms / bound, launches_per_timed_call=len(tiers)))
    a = torch.as_tensor(sd.owned, device=dev)
    b = torch.as_tensor(sd.bucket, device=dev)
    cells = float(a.shape[0]) * a.shape[1] * b.shape[1]
    for name, kern, plain, arg in (
            ("pair_count", kernel.pair_count_cuda, ref.pair_count_ref, cmin),
            ("pair_hist", kernel.pair_hist_cuda, ref.pair_hist_ref, edges)):
        ms, bound = cuda_ms(lambda: kern(a, b, arg)), ops_bound(cells)
        rows.append(kernel_row(
            name, ZP_SOURCE, launches, max_err[name], ms,
            cuda_ms(lambda: plain(a, b, arg), reps=1, warmup=0),
            bound, "operations", cells=cells,
            shape=[list(a.shape), list(b.shape)], sm_clock_hz=clock_hz,
            x_bound=ms / bound, launches_per_timed_call=1))
    del a, b
    n = payload.numel()
    q, s = qk.quantize_cuda(payload)
    byte_count = {"quantize": 4 * n + n + 4 * (n // 256),
                  "dequantize": n + 4 * (n // 256) + 4 * n}
    for name, kern, plain in (
            ("quantize", lambda: qk.quantize_cuda(payload),
             lambda: qr.quantize_ref(payload)),
            ("dequantize", lambda: qk.dequantize_cuda(q, s),
             lambda: qr.dequantize_ref(q, s))):
        rows.append(kernel_row(
            name, Q_SOURCE, launches, max_err[name], cuda_ms(kern),
            cuda_ms(plain, reps=3),
            byte_count[name] / HBM_BYTES_PER_S * 1e3, "bytes",
            bytes=byte_count[name], shape=list(payload.shape)))
    return rows


def stream_summary(st) -> dict:
    """A streamed run's walls: the stage walls, the exposed and hidden
    fetch, the overlap and, for lanes, the run's own wall."""
    keys = ("wall_s", "map_wall_s", "shuffle_wall_s", "reduce_wall_s",
            "fetch_wall_s", "combine_wall_s", "overlap_hidden_s",
            "overlap_fraction", "n_splits", "n_items", "combiner",
            "shuffle_wire_bytes", "n_lanes", "elapsed_s", "speculated",
            "clone_wins", "retries", "lane_walls", "tiers")
    d = st.to_dict()
    out = {k: d[k] for k in keys}
    out["split_median_s"] = {k: statistics.median(r[k] for r in st.splits)
                             for k in ("fetch_prep_s", "fetch_wait_s",
                                       "map_s", "wall_s")}
    return out


def same_outputs(what, res, want_outputs, n_edges: int) -> None:
    if outputs(res) != want_outputs:
        raise AssertionError(f"{what}: {outputs(res)} != {want_outputs}")
    check_outputs(res, n_edges)


def lane_cards(st) -> dict:
    """{card: the splits whose committed attempt ran there} of a lanes
    run."""
    out: dict = {}
    for r in st.splits:
        out.setdefault(r["device"], []).append(r["split"])
    return out


def lanes_cards_phase(src, tsrc, want_counts, mono: dict, launches: dict,
                      n_edges: int, seq_counts: dict) -> dict:
    """``lanes_cards``: the device engine's lanes pinned over every card
    (``executor.lane_devices``: lane i on card i % D, 2 lanes a card, no
    mesh) over ``src``'s 16 memmap splits: plain, then with split 0's
    first fetch stalled ``STALL_S`` and speculation on, both equal to
    phase 3 with the sequential run's launches (``seq_counts``); then
    wordcount in combine mode over ``tsrc``'s tokens, equal to
    ``np.bincount``. Prints the card of every split. On one card it prints
    that it did not run and why. -> {run: host wall}."""
    cards = torch.cuda.device_count()
    if cards < 2:
        emit(phase="lanes_cards", skipped="one card: lanes across cards pin "
             "lane i to card i % D, which needs 2 or more cards")
        return {}
    from repro_torch.ft import FaultySplitSource, SpeculativeConfig
    from repro_torch.mapreduce import run_jobs_streaming, token_histogram_job
    n_lanes = 2 * cards
    jobs = zone_jobs("int16")
    walls = {}
    faulty = FaultySplitSource(src, delays={0: STALL_S})
    for run, source, kw in (
            ("plain", src, {}),
            ("speculated", faulty, {"speculate": SpeculativeConfig(
                slowdown=2.0, min_finished=2, max_clones=1)})):
        res, wall, counts = counted(
            lambda: run_jobs_streaming(jobs, source, n_lanes=n_lanes, **kw),
            launches, seq_counts)
        st = res[0].stats
        same_outputs(f"lanes_cards {run}", res, mono["int16"][0], n_edges)
        by_card = lane_cards(st)
        if len(by_card) < 2:
            raise AssertionError(f"lanes_cards {run}: every split on "
                                 f"{sorted(by_card)}")
        if run == "speculated" and not (
                st.clone_wins >= 1 and st.elapsed_s < STALL_S / 6):
            raise AssertionError(f"lanes_cards speculation: clone wins "
                                 f"{st.clone_wins}, elapsed {st.elapsed_s} s")
        walls[run] = wall
        emit(phase="lanes_cards", run=run, codec="int16", cards=cards,
             n_lanes=n_lanes, host_wall_s=wall, launches=counts,
             splits_by_card=by_card, stats=stream_summary(st),
             equals="phase 3")
    res, wall, counts = counted(
        lambda: run_jobs_streaming([token_histogram_job(VOCAB)], tsrc,
                                   n_lanes=n_lanes), launches,
        launch_counts())
    if not np.array_equal(res[0].output, want_counts):
        raise AssertionError("lanes_cards wordcount != np.bincount")
    walls["wordcount"] = wall
    emit(phase="lanes_cards", run="wordcount", cards=cards, n_lanes=n_lanes,
         n_tokens=WC_TOKENS, host_wall_s=wall,
         splits_by_card=lane_cards(res[0].stats),
         stats=stream_summary(res[0].stats), equals="np.bincount")
    return walls


def stream_phases(xyz, seed: int, mono: dict, launches: dict,
                  n_edges: int) -> None:
    """Phases 7-13: the streaming executor at full width, then the spill
    and trace phases over the same memmap file. ``mono`` holds phase 3's
    (outputs, -, host wall, StageStats) per codec."""
    import tempfile
    from repro_torch.data.pipeline import (ArraySplits, MemmapCatalogSplits,
                                           MemmapTokens, TokenBlockSplits)
    from repro_torch.ft import FaultySplitSource, SpeculativeConfig
    from repro_torch.mapreduce import (run_jobs, run_jobs_streaming,
                                       token_histogram_job)

    def same(what, res, want_outputs):
        same_outputs(what, res, want_outputs, n_edges)

    stream_walls = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-stream-") as tmp:
        # 7. the catalog from a file, 16 prefetched splits, per codec
        path = str(Path(tmp) / "catalog.f32")
        t0 = time.perf_counter()
        MemmapCatalogSplits.write(path, xyz)
        write_s = time.perf_counter() - t0
        src = MemmapCatalogSplits(path, d=xyz.shape[1],
                                  rows_per_split=STREAM_ROWS)
        seq_counts = {}
        for codec in CODECS:
            jobs = zone_jobs(codec)
            res, wall, counts = counted(
                lambda: run_jobs_streaming(jobs, src, prefetch=2), launches)
            st, mst = res[0].stats, mono[codec][3]
            same(f"stream_device {codec}", res, mono[codec][0])
            want = zone_launches("device", codec, jobs, st)
            if counts != want or st.tiers != mst.tiers:
                raise AssertionError(f"stream_device {codec}: launches "
                                     f"{counts} != {want}, tiers {st.tiers} "
                                     f"vs {mst.tiers}")
            seq_counts[codec] = counts
            stream_walls[codec] = (wall, st)
            emit(phase="stream_device", codec=codec, rows_per_split=STREAM_ROWS,
                 prefetch=2, file_bytes=Path(path).stat().st_size,
                 write_s=write_s, host_wall_s=wall, launches=counts,
                 stats=stream_summary(st), mono_host_wall_s=mono[codec][2],
                 mono_stats={k: getattr(mst, k) for k in (
                     "wall_s", "map_wall_s", "shuffle_wall_s",
                     "reduce_wall_s")})

        # 8. four lanes, then four lanes with a stalled split and speculation
        jobs = zone_jobs("int16")
        faulty = FaultySplitSource(src, delays={0: STALL_S})
        for run, source, kw in (
                ("lanes", src, {}),
                ("speculated", faulty, {"speculate": SpeculativeConfig(
                    slowdown=2.0, min_finished=2, max_clones=1)})):
            res, wall, counts = counted(
                lambda: run_jobs_streaming(jobs, source, n_lanes=4, **kw),
                launches, seq_counts["int16"])
            st = res[0].stats
            same(f"stream_lanes {run}", res, mono["int16"][0])
            if run == "speculated" and not (
                    st.speculated >= 1 and st.clone_wins >= 1
                    and st.elapsed_s < STALL_S / 6):
                raise AssertionError(
                    f"speculation: speculated {st.speculated}, clone wins "
                    f"{st.clone_wins}, elapsed {st.elapsed_s} s against a "
                    f"{STALL_S} s stall")
            emit(phase="stream_lanes", run=run, codec="int16", n_lanes=4,
                 host_wall_s=wall, launches=counts, stats=stream_summary(st),
                 injected_delay_s=faulty.injected_delay_s,
                 split0=st.splits[0])

        # 9. the host engine streamed, against its own monolithic run
        sub = xyz[:HOST_STREAM_N]
        for codec in ("identity", "int8"):
            jobs = zone_jobs(codec)
            ref, ref_wall, ref_counts = counted(
                lambda: run_jobs(jobs, sub, engine="host"), launches)
            res, wall, counts = counted(
                lambda: run_jobs_streaming(jobs, ArraySplits(sub, 8),
                                           engine="host"), launches)
            want = zone_launches("host", codec, jobs, res[0].stats)
            if counts != want or ref_counts != want:
                raise AssertionError(f"stream_host {codec}: launches {counts}"
                                     f", monolithic {ref_counts} != {want}")
            same(f"stream_host {codec}", res, outputs(ref))
            emit(phase="stream_host", codec=codec, n=len(sub), n_splits=8,
                 host_wall_s=wall, launches=counts,
                 stats=stream_summary(res[0].stats), mono_host_wall_s=ref_wall,
                 mono_wall_s=ref[0].stats.wall_s)

        # 10. wordcount over a token file, combiner on and off
        t0 = time.perf_counter()
        toks = np.random.default_rng(seed).integers(0, VOCAB, WC_TOKENS,
                                                    dtype=np.int32)
        tpath = str(Path(tmp) / "tokens.i32")
        MemmapTokens.write(tpath, toks)
        want_counts = np.bincount(toks, minlength=VOCAB)
        setup_s = time.perf_counter() - t0
        del toks
        rows = WC_TOKENS // WC_SEQ
        tsrc = TokenBlockSplits(MemmapTokens(tpath, WC_SEQ), WC_SEQ,
                                rows_per_split=rows // 16, n_splits=16)
        wire = {}
        for comb in ("auto", None):
            res, wall, counts = counted(
                lambda: run_jobs_streaming([token_histogram_job(VOCAB)], tsrc,
                                           combiner=comb),
                launches, launch_counts())
            if not np.array_equal(res[0].output, want_counts):
                raise AssertionError(f"stream_wordcount combiner={comb} != "
                                     "np.bincount")
            st = res[0].stats
            wire[comb] = st.shuffle_wire_bytes
            emit(phase="stream_wordcount", combiner=comb, n_tokens=WC_TOKENS,
                 vocab=VOCAB, setup_s=setup_s, host_wall_s=wall,
                 stats=stream_summary(st))
        if not wire[None] >= 2 * wire["auto"]:
            raise AssertionError(f"combiner wire bytes {wire['auto']} vs "
                                 f"{wire[None]} without")
        emit(phase="stream_wordcount_wire", on=wire["auto"], off=wire[None],
             ratio=wire[None] / wire["auto"])

        # lanes across cards, where there are 2 or more
        lanes_cards_phase(src, tsrc, want_counts, mono, launches, n_edges,
                          seq_counts["int16"])

        # 11-13. the external shuffle, sequential and over lanes, and traces
        spill_phases(tmp, src, mono, launches, n_edges, stream_walls)


def spill_summary(st) -> dict:
    """A spilled run's walls and spill accounting."""
    out = stream_summary(st)
    for k in ("spill_bytes", "spill_ranges", "spill_wall_s",
              "spilled_splits", "spill_peak_bytes", "spill_chunk_bytes"):
        out[k] = getattr(st, k)
    out["read_back_tiers"] = len(st.tiers)
    return out


def check_spill(what: str, codec: str, st, counts: dict, jobs, budget: int,
                root: Path, n_splits: int) -> None:
    """What every spilled run must show: all splits spilled, one masked
    launch per reducer per read-back tier (each range reads 1-3 tiers; the
    three searches launch three counts a histogram), the resident-bytes
    bound, and no spill file left."""
    hist = counts["pair_hist_masked"]
    want = zone_launches("device", codec, jobs, st)
    problems = []
    if counts != want:
        problems.append(f"launches {counts} != {want}")
    if counts["pair_count_masked"] != (len(jobs) - 1) * hist:
        problems.append(f"masked counts {counts['pair_count_masked']} != "
                        f"{len(jobs) - 1} x {hist} histograms")
    if not st.spill_ranges <= hist <= 3 * st.spill_ranges:
        problems.append(f"{hist} histogram launches for {st.spill_ranges} "
                        "ranges")
    if st.spilled_splits != n_splits:
        problems.append(f"{st.spilled_splits} of {n_splits} splits spilled")
    if not st.spill_peak_bytes <= budget + st.spill_chunk_bytes:
        problems.append(f"peak {st.spill_peak_bytes} B > budget {budget} + "
                        f"chunk {st.spill_chunk_bytes}")
    if root.exists():
        problems.append(f"spill directory left behind: "
                        f"{sorted(p.name for p in root.iterdir())[:8]}")
    if problems:
        raise AssertionError(f"{what}: " + "; ".join(problems))


def spill_phases(tmp, src, mono: dict, launches: dict, n_edges: int,
                 stream_walls: dict) -> None:
    """Phases 11-13 over phase 7's memmap splits: ``stream_spill``
    (sequential), ``stream_spill_lanes`` and ``trace``."""
    from repro_torch.data.pipeline import ArraySplits
    from repro_torch.ft import FaultySplitSource, SpeculativeConfig
    from repro_torch.mapreduce import (SpillConfig, run_jobs,
                                       run_jobs_streaming)
    from repro_torch.obs import Tracer

    K = src.n_splits()
    runs = iter(range(1 << 30))

    def spill_run(what, codec, budget, source=src, tracer=None, want=None,
                  **kw):
        root = Path(tmp) / f"spill-{next(runs)}"
        jobs = zone_jobs(codec)
        cfg = SpillConfig(budget_bytes=budget, dir=str(root))

        def run():
            return run_jobs_streaming(jobs, source, spill=cfg, **kw)
        res, wall, counts = counted(
            (lambda: _traced(tracer, run)) if tracer else run, launches)
        st = res[0].stats
        same_outputs(what, res, want or mono[codec][0], n_edges)
        check_spill(what, codec, st, counts, jobs, budget, root,
                    source.n_splits())
        return st, wall, counts

    def beside(codec):
        wall, st = stream_walls[codec]
        mst = mono[codec][3]
        return {"stream_device": {"host_wall_s": wall, "wall_s": st.wall_s,
                                  "map_wall_s": st.map_wall_s,
                                  "shuffle_wall_s": st.shuffle_wall_s,
                                  "reduce_wall_s": st.reduce_wall_s},
                "monolithic": {"host_wall_s": mono[codec][2],
                               "wall_s": mst.wall_s}}

    # 11. sequential spill: 256 MiB (async chunks) per codec, then budget 0
    # (every split written synchronously, max_ranges ranges read back) over
    # the first BUDGET0_SPLITS splits: its host segment cut is O(rows x
    # ranges), 105-125 s over all 16, so it runs at a quarter of the depth,
    # held to a monolithic run over the same rows
    spilled = {}
    first = ArraySplits(np.concatenate([src.split(k) for k in
                                        range(BUDGET0_SPLITS)]),
                        BUDGET0_SPLITS)
    first_want = outputs(run_jobs(zone_jobs("int16"), np.concatenate(
        [src.split(k) for k in range(BUDGET0_SPLITS)])))
    for codec, budget in (("int16", SPILL_BUDGET), ("int8", SPILL_BUDGET),
                          ("int16", 0)):
        cut = budget == 0
        st, wall, counts = spill_run(
            f"stream_spill {codec} {budget}", codec, budget,
            source=first if cut else src, want=first_want if cut else None)
        spilled[codec, budget] = (wall, st)
        emit(phase="stream_spill", codec=codec, budget_bytes=budget,
             host_wall_s=wall, launches=counts, stats=spill_summary(st),
             n_splits=BUDGET0_SPLITS if cut else K,
             **({} if cut else beside(codec)))

    # a write fault on the second chunk: the error reaches the caller and
    # the run leaves no file behind
    tags = set()

    def fault(path):
        tags.add(path.rsplit(".staged-", 1)[-1])
        if len(tags) >= 2:
            raise OSError("injected spill write fault on the second chunk")

    root = Path(tmp) / "spill-fault"
    try:
        run_jobs_streaming(zone_jobs("int16"), src, spill=SpillConfig(
            budget_bytes=SPILL_BUDGET, dir=str(root), write_fault=fault))
    except OSError as e:
        if "second chunk" not in str(e):
            raise
        fault_error = str(e)
    else:
        raise AssertionError("stream_spill: the injected write fault did "
                             "not reach the caller")
    if root.exists():
        raise AssertionError(f"stream_spill: the faulted run left "
                             f"{sorted(p.name for p in root.iterdir())[:8]}")
    emit(phase="stream_spill_fault", error=fault_error, chunks_tagged=
         sorted(tags), dir_left=False)

    # 12. lanes spill one split at a time; then a stalled split 0, cloned
    def speculated():
        return {"source": FaultySplitSource(src, delays={0: STALL_S}),
                "speculate": SpeculativeConfig(slowdown=2.0, min_finished=2,
                                               max_clones=1)}

    for run, kw in (("lanes", {}), ("speculated", speculated())):
        st, wall, counts = spill_run(f"stream_spill_lanes {run}", "int16",
                                     SPILL_BUDGET, n_lanes=4, **kw)
        if run == "speculated" and not (
                st.speculated >= 1 and st.clone_wins >= 1
                and st.elapsed_s < STALL_S / 6):
            raise AssertionError(
                f"spill speculation: speculated {st.speculated}, clone wins "
                f"{st.clone_wins}, elapsed {st.elapsed_s} s")
        emit(phase="stream_spill_lanes", run=run, codec="int16", n_lanes=4,
             budget_bytes=SPILL_BUDGET, host_wall_s=wall, launches=counts,
             stats=spill_summary(st), split0=st.splits[0])

    # 13. the same int16 runs under a Tracer, against their untraced walls
    jobs = zone_jobs("int16")
    stages = {"job", "fetch-wait", "map", "shuffle", "reduce"}
    spill_spans = {"spill-write", "spill-read"}

    def stream_device(tr):
        res, wall, _ = counted(
            lambda: _traced(tr, lambda: run_jobs_streaming(jobs, src,
                                                           prefetch=2)),
            launches, zone_launches("device", "int16", jobs,
                                    stream_walls["int16"][1]))
        same_outputs("trace stream_device", res, mono["int16"][0], n_edges)
        return res[0].stats, wall

    traced = {}
    for run, want_names, untraced, go in (
            ("stream_device", stages | {"fetch"}, stream_walls["int16"],
             stream_device),
            ("stream_spill", stages | {"fetch"} | spill_spans,
             spilled["int16", SPILL_BUDGET],
             lambda tr: spill_run("trace stream_spill", "int16",
                                  SPILL_BUDGET, tracer=tr)[:2]),
            ("speculated_spill_lanes",
             stages | spill_spans | {"lane-exec", "clone-race", "clone-win"},
             None, lambda tr: spill_run("trace speculated", "int16",
                                        SPILL_BUDGET, tracer=tr, n_lanes=4,
                                        **speculated())[:2])):
        tr = Tracer()
        st, wall = go(tr)
        names = {e["name"] for e in json.loads(tr.export_json())[
            "traceEvents"]}
        if tr.open_spans != 0 or not want_names <= names:
            raise AssertionError(f"trace {run}: {tr.open_spans} open spans, "
                                 f"missing {sorted(want_names - names)}")
        traced[run] = names
        emit(phase="trace", run=run, host_wall_s=wall, wall_s=st.wall_s,
             untraced_host_wall_s=None if untraced is None else untraced[0],
             untraced_wall_s=None if untraced is None else untraced[1].wall_s,
             n_events=len(tr.events), span_names=sorted(names),
             summary=tr.summary().splitlines())
    emit(phase="trace_names", union=sorted(set().union(*traced.values())))


def _traced(tr, fn):
    from repro_torch.obs import use_tracer
    with use_tracer(tr):
        return fn()


def modeled_energy(st) -> dict:
    """``ModeledMeter``'s joules for one run's stage walls (the paper's
    node-class watts, ``obs/energy.py``: modeled, not measured)."""
    from repro_torch.obs import ModeledMeter
    m = dataclasses.replace(st, **dict.fromkeys(ENERGY_FIELDS, 0.0),
                            energy_source="")
    ModeledMeter().attribute(None, m)
    return {"source": m.energy_source, "rows_per_joule": m.rows_per_joule,
            **{f: getattr(m, f) for f in ENERGY_FIELDS}}


def energy_phase(xyz, mono: dict, host_int16_stats, launches: dict,
                 n_edges: int) -> None:
    """Phase 14: the card's NVML energy counter, its resolution, then the
    int16 monolithic device run metered by it for >= ENERGY_LOOP_S, beside
    the modeled figures."""
    from repro_torch.mapreduce import run_jobs
    from repro_torch.obs import NvmlMeter, use_meter

    meter = NvmlMeter(0)
    if not meter.available:
        raise AssertionError("NvmlMeter is not available on the card: "
                             "libnvidia-ml.so.1 or its energy counter is "
                             "missing")
    reads = []
    t_end = time.perf_counter() + 1.0
    while time.perf_counter() < t_end:
        reads.append((time.perf_counter(), meter.begin()))
        time.sleep(0.0005)
    steps = [(t, v) for (t, v), (_, u) in zip(reads[1:], reads) if v != u]
    gaps = [b[0] - a[0] for a, b in zip(steps, steps[1:])]
    sizes = [b[1] - a[1] for a, b in zip(steps, steps[1:])]
    idle_w = (reads[-1][1] - reads[0][1]) * 1e-3 / (reads[-1][0] - reads[0][0])
    emit(phase="energy_counter", reads=len(reads),
         distinct_values=len({v for _, v in reads}), steps=len(steps),
         step_interval_ms_median=(statistics.median(gaps) * 1e3
                                  if gaps else None),
         step_mj_median=statistics.median(sizes) if sizes else None,
         idle_w=idle_w)

    jobs = zone_jobs("int16")
    per_run = []
    tok = meter.begin()
    t0 = time.perf_counter()
    with use_meter(meter):
        while time.perf_counter() - t0 < ENERGY_LOOP_S or len(per_run) < 3:
            res, wall, _ = counted(lambda: run_jobs(jobs, xyz), launches)
            same_outputs("energy", res, mono["int16"][0], n_edges)
            per_run.append((res[0].stats, wall))
    loop_s = time.perf_counter() - t0
    loop_j = meter.read_joules(tok)
    if not loop_j > 0 or not any(st.energy_j > 0 for st, _ in per_run):
        raise AssertionError(f"NvmlMeter read {loop_j} J over {loop_s} s")
    n_items = per_run[0][0].n_items
    emit(phase="energy", codec="int16", runs=len(per_run), loop_s=loop_s,
         loop_j=loop_j, loop_w=loop_j / loop_s,
         j_per_run=loop_j / len(per_run),
         rows_per_joule=n_items * len(per_run) / loop_j,
         per_run_energy_j=[st.energy_j for st, _ in per_run],
         per_run_host_wall_s=[w for _, w in per_run],
         last_run={f: getattr(per_run[-1][0], f) for f in ENERGY_FIELDS
                   + ("energy_source", "rows_per_joule", "wall_s")})
    emit(phase="energy_modeled", label="modeled, not measured: the paper's "
         "node-class watts (ATOM_HOST, BLADE_DEVICE) x stage walls",
         device_int16=modeled_energy(per_run[-1][0]),
         host_int16=modeled_energy(host_int16_stats))


def calibrate_phase(launches: dict):
    """Phase 15: the cost model's replay of the masked pair count on the
    card (``get_cost_model(calibrate=True)``, a cache in a temporary
    directory), its fitted rates against the ``DeviceSpec`` peaks, and every
    probe after the anchor predicted within 2x. -> (model, spec)."""
    import os
    import tempfile
    from repro_torch.core import cost_model as cm
    from repro_torch.core import device_spec, get_cost_model

    spec = device_spec()
    shapes = cm.CALIBRATION_SHAPES
    with tempfile.TemporaryDirectory(prefix="chip-smoke-cost-") as tmp:
        old = os.environ.get("REPRO_CACHE_DIR")
        os.environ["REPRO_CACHE_DIR"] = tmp
        try:
            cm.reset_cost_model()
            model, wall, counts = counted(
                lambda: get_cost_model(calibrate=True), launches,
                launch_counts(pair_count_masked=7 * len(shapes)))
        finally:
            if old is None:
                del os.environ["REPRO_CACHE_DIR"]
            else:
                os.environ["REPRO_CACHE_DIR"] = old
    p = model.profile
    free = cm._fit_profile(p.fingerprint, p.probes)   # the reference's fit
    probes = []
    for (P, C1, C2, w, flops, byts) in p.probes:
        pred = model.predict_wall(cm.StageCost(flops=flops, hbm_bytes=byts))
        probes.append({"P": P, "C1": C1, "C2": C2, "cells": P * C1 * C2,
                       "measured_s": w, "predicted_s": pred,
                       "ratio": pred / w})
    emit(phase="calibrate", fingerprint=p.fingerprint, calibrated=p.calibrated,
         replay_host_wall_s=wall, launches=counts,
         flops_per_s=p.flops_per_s, bytes_per_s=p.bytes_per_s,
         dispatch_s=p.dispatch_s, peak_flops_per_s=spec.peak_flops,
         peak_bytes_per_s=spec.hbm_bw,
         flops_share_of_peak=p.flops_per_s / spec.peak_flops,
         bytes_share_of_peak=p.bytes_per_s / spec.hbm_bw,
         unbounded_fit={"flops_per_s": free.flops_per_s,
                        "bytes_per_s": free.bytes_per_s},
         probes=probes, spec=dataclasses.asdict(spec))
    if not (p.calibrated and p.flops_per_s <= spec.peak_flops
            and p.bytes_per_s <= spec.hbm_bw):
        raise AssertionError(f"calibrate: profile {p} above the peaks "
                             f"{spec.peak_flops}, {spec.hbm_bw}")
    bad = [r for r in probes[1:] if not 0.5 < r["ratio"] < 2.0]
    if bad:
        raise AssertionError(f"calibrate: probes predicted outside 2x: {bad}")
    return model, spec


def walls_beside_predictions(st) -> dict:
    return {"tiers": st.tiers, "auto_tile": st.auto_tile,
            "shuffle_wall_s": st.shuffle_wall_s,
            "predicted_shuffle_wall_s": st.predicted_shuffle_wall_s,
            "reduce_wall_s": st.reduce_wall_s,
            "predicted_reduce_wall_s": st.predicted_reduce_wall_s,
            "prediction_error": st.prediction_error}


def auto_knobs_phase(xyz, mono: dict, full_host: dict, launches: dict,
                     n_edges: int) -> None:
    """Phase 16: ``codec="auto", tile="auto"`` on the device and host
    engines, equal to phases 3 and 4 (identity, the only exact codec);
    ``run_jobs(split_rows="auto")`` and ``SpillConfig(n_ranges="auto")`` at
    256 MiB (int16), equal to phase 3."""
    import tempfile
    from repro_torch.core import get_cost_model
    from repro_torch.data.pipeline import ArraySplits
    from repro_torch.mapreduce import (SpillConfig, run_jobs,
                                       run_jobs_streaming)

    auto = [dataclasses.replace(j, codec="auto", tile="auto")
            for j in zone_jobs("identity")]
    for engine, want in (("device", mono["identity"][0]),
                         ("host", full_host["identity"])):
        res, wall, counts = counted(
            lambda: run_jobs(auto, xyz, engine=engine), launches)
        st = res[0].stats
        same_outputs(f"auto_knobs {engine}", res, want, n_edges)
        if counts != zone_launches(engine, "identity", auto, st):
            raise AssertionError(f"auto_knobs {engine}: launches {counts}")
        emit(phase="auto_knobs", engine=engine, codec=st.codec,
             host_wall_s=wall, launches=counts, wall_s=st.wall_s,
             manual_tiers=mono["identity"][3].tiers,
             manual_wall_s=mono["identity"][3].wall_s,
             **walls_beside_predictions(st))
    jobs = zone_jobs("int16")
    rows = get_cost_model().choose_split_rows(len(xyz), d=xyz.shape[1])
    res, wall, counts = counted(
        lambda: run_jobs(jobs, xyz, split_rows="auto"), launches)
    same_outputs("split_rows auto", res, mono["int16"][0], n_edges)
    st = res[0].stats
    emit(phase="auto_split_rows", codec="int16", split_rows=rows,
         n_splits=st.n_splits, host_wall_s=wall, launches=counts,
         mono_host_wall_s=mono["int16"][2], stats=stream_summary(st))
    with tempfile.TemporaryDirectory(prefix="chip-smoke-spill-") as tmp:
        root = Path(tmp) / "spill"
        cfg = SpillConfig(budget_bytes=SPILL_BUDGET, dir=str(root),
                          n_ranges="auto")
        res, wall, counts = counted(
            lambda: run_jobs_streaming(jobs, ArraySplits(xyz, n_splits=16),
                                       spill=cfg), launches)
        st = res[0].stats
        same_outputs("n_ranges auto", res, mono["int16"][0], n_edges)
        check_spill("n_ranges auto", "int16", st, counts, jobs,
                    SPILL_BUDGET, root, 16)
    emit(phase="auto_spill_ranges", codec="int16", budget_bytes=SPILL_BUDGET,
         host_wall_s=wall, launches=counts, stats=spill_summary(st))


def amdahl_phase(xyz, mono: dict, spec, launches: dict, n_edges: int):
    """Phase 17: the int16 device run under the calibrated model: its
    predicted and measured stage walls, and its Amdahl terms priced at the
    card's ``DeviceSpec`` with the NVML power limit as ``chip_w``."""
    from repro_torch.core import balance_report, suggest
    from repro_torch.mapreduce import run_jobs

    jobs = zone_jobs("int16")
    res, wall, counts = counted(lambda: run_jobs(jobs, xyz), launches)
    same_outputs("amdahl int16", res, mono["int16"][0], n_edges)
    st = res[0].stats
    if counts != zone_launches("device", "int16", jobs, st):
        raise AssertionError(f"amdahl int16: launches {counts}")
    terms = st.roofline(1, spec.chip_w)
    emit(phase="amdahl", codec="int16", host_wall_s=wall, wall_s=st.wall_s,
         chip_w=spec.chip_w, sm_count=spec.sm_count,
         sm_clock_hz=spec.sm_clock_hz, terms=terms.to_dict(),
         to_dict_amdahl=st.to_dict()["amdahl"], suggest=suggest(terms),
         launches=counts, **walls_beside_predictions(st))
    print(balance_report("int16 device run, 2^24 objects", terms),
          flush=True)


def service_mix():
    """The service phases' catalog partitioner (60") and ``serve_mr``'s
    4-query mix on it (int16, tile 256)."""
    from repro_torch.data.sky import ARCSEC
    from repro_torch.launch.serve_mr import query_mix
    from repro_torch.mapreduce import ZonePartitioner
    radius = SEARCH_ARCSEC[-1] * ARCSEC
    part = ZonePartitioner(radius)
    return part, query_mix(radius, part, "int16", 256)


@dataclasses.dataclass(frozen=True)
class RankPoison:
    """``mesh_service``'s poison query: a pair count at ``radius`` whose
    reduce raises on rank ``rank`` only. It stands in for a ``Reducer`` by
    duck typing, so this module imports nothing of the port when it is
    imported, and it pickles by reference, so the first rank can broadcast
    it."""

    radius: float
    rank: int = POISON_RANK
    pad_value: float = 0.0
    cost_basis = "pairs"

    def _count(self):
        from repro_torch.mapreduce import PairCountReducer
        return PairCountReducer(self.radius)

    def reduce_partitions(self, owned, bucket, n_owned, n_bucket):
        import torch.distributed as dist
        if dist.get_rank() == self.rank:
            raise ValueError(f"poison: this query fails on rank {self.rank}")
        return self._count().reduce_partitions(owned, bucket, n_owned,
                                               n_bucket)

    def finalize(self, total, sd):
        return self._count().finalize(total, sd)

    def flops(self, sd):
        return self._count().flops(sd)


def service_phase(xyz, launches: dict, n_edges: int) -> list:
    """Phase 18: the MapReduce query service on the card, 2 lanes: one
    catalog load (int16), 64 closed-loop requests of ``serve_mr``'s 4-query
    mix, then 64 paced at half the closed-loop qps. Every output equals
    ``run_jobs([job], xyz)``; ``latency_summary`` beside the per-query
    ``run_jobs`` wall. -> those ``run_jobs`` outputs, one a query of the
    mix."""
    from repro_torch.data.sky import ARCSEC
    from repro_torch.launch.serve_mr import offer
    from repro_torch.mapreduce import latency_summary, run_jobs
    from repro_torch.serving import MRQueryService

    part, mix = service_mix()
    singles = []
    for j in mix:
        res, wall, counts = counted(lambda: run_jobs([j], xyz), launches)
        singles.append((outputs(res)[0], wall))
    svc = MRQueryService(max_batch=16, max_wait_s=0.002, n_lanes=2)
    cat, load_wall, _ = counted(
        lambda: svc.load_catalog("sky", xyz, part, codec="int16"), launches,
        launch_counts())
    for j in mix:                          # one warm batch, not measured
        svc.submit(j, catalog="sky")
    counted(svc.run_pending, launches)
    runs = {}
    tiers = len(cat.sd.tiers)
    with svc:
        for name, qps in (("closed_loop", 0.0), ("paced", None)):
            if qps is None:
                qps = runs["closed_loop"]["summary"]["qps"] / 2
            n0, b0 = len(svc.request_stats), len(svc.batches)

            def serve():
                reqs = offer(svc, mix, 64, qps, "sky")
                for r in reqs:
                    r.result(timeout=600)
                return reqs
            reqs, wall, counts = counted(serve, launches)
            for i, r in enumerate(reqs):
                got = outputs([r])[0]
                if got != singles[i % len(mix)][0]:
                    raise AssertionError(f"mr_service {name} request {i}: "
                                         f"{got} != run_jobs "
                                         f"{singles[i % len(mix)][0]}")
            batches = svc.batches[b0:]
            unique = sum(b["n_unique"] for b in batches)
            masked = counts["pair_count_masked"] + counts["pair_hist_masked"]
            if masked != tiers * unique or not counts["pair_hist_masked"]:
                raise AssertionError(f"mr_service {name}: launches {counts} "
                                     f"for {unique} jobs over {tiers} tiers")
            runs[name] = {"offered_qps": qps, "host_wall_s": wall,
                          "launches": counts, "batches": len(batches),
                          "batch_sizes": [b["size"] for b in batches],
                          "summary": latency_summary(
                              svc.request_stats[n0:])}
    run_job_wall = statistics.mean(w for _, w in singles)
    emit(phase="mr_service", codec="int16", n_lanes=2, max_batch=16,
         max_wait_s=0.002, load_host_wall_s=load_wall,
         resident_bytes=cat.nbytes, tiers=tiers,
         run_jobs_wall_s={j.name + (f" {j.reducer.radius / ARCSEC:.0f}\""
                                    if hasattr(j.reducer, "radius") else ""):
                          w for j, (_, w) in zip(mix, singles)},
         run_jobs_mean_wall_s=run_job_wall,
         coalescing_x=run_job_wall * 64
         / runs["closed_loop"]["summary"]["span_s"], **runs)
    return [out for out, _ in singles]


def mesh_run(fn, pod: int = 0):
    """In a rank of a mesh: ``fn()`` between two synchronizes, with every
    launch count set to 0 just before and read just after, under the
    operation census (which sees this thread's collectives only). -> (fn's
    result, host wall, launch counts, the census's collective summary with
    the count of each operator, the c10d operators it saw)."""
    from repro_torch.core import op_census
    from repro_torch.kernels import reset_launch_counts
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with op_census.census(pod_size=pod) as c:
        out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ops = sorted({col.line for col in c.collectives})
    summary = op_census.collective_summary(c)
    summary["n_by_op"] = {}
    for col in c.collectives:
        summary["n_by_op"][col.op] = summary["n_by_op"].get(col.op, 0) + 1
    return out, wall, read_launches(), summary, ops


class RankPool:
    """``world`` gloo ranks of the card, spawned once and kept for the
    phases that run on that many ranks: a world spawned anew costs each
    rank its imports, its CUDA context, the process group and the census's
    warm-up, 20-30 s a world on the card's host. ``run(fn, *args)`` calls
    ``fn(rank, world, *args)`` on every rank, as
    ``launch/mesh.py::spawn_world`` does (each rank's default process group
    on gloo), and returns the results by rank; between calls each rank
    frees what the call left (``gc``, the caching allocator). A rank that
    raises or dies, or a call past ``timeout_s``, ends the pool and fails
    the call with the ranks' tracebacks. ``close`` ends it."""

    def __init__(self, world: int, timeout_s: float = 900.0):
        import tempfile
        ctx = torch.multiprocessing.get_context("spawn")
        self.world, self.timeout_s = world, timeout_s
        self.tmp = tempfile.mkdtemp(prefix="chip-smoke-ranks-")
        self.tasks = [ctx.SimpleQueue() for _ in range(world)]
        self.results = ctx.SimpleQueue()
        self.procs = [ctx.Process(target=pool_rank, daemon=True, args=(
            r, world, str(Path(self.tmp) / "store"), timeout_s,
            self.tasks[r], self.results)) for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args) -> list:
        for q in self.tasks:
            q.put((fn, args))
        got, failed = {}, []
        deadline = time.monotonic() + self.timeout_s
        while len(got) < self.world and not failed:
            if not self.results.empty():
                rank, ok, value = self.results.get()
                if ok:
                    got[rank] = value
                else:
                    failed.append(f"rank {rank} failed:\n{value}")
            elif not all(p.is_alive() for p in self.procs):
                failed.append("a rank died")
            elif time.monotonic() > deadline:
                failed.append(f"ranks still running after {self.timeout_s} "
                              f"s")
            else:
                time.sleep(0.05)
        if failed:
            self.close()
            raise RuntimeError(f"rank pool, {fn.__name__}: "
                               + "\n".join(failed))
        return [got[r] for r in range(self.world)]

    def close(self) -> None:
        import shutil
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join()
        self.procs = []
        shutil.rmtree(self.tmp, ignore_errors=True)


def pool_rank(rank: int, world: int, init_file: str, timeout_s: float,
              tasks, results) -> None:
    """One rank of a ``RankPool``: the default process group on gloo, then
    each task ``(fn, args)`` from ``tasks`` until None."""
    import datetime
    import traceback
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    while (task := tasks.get()) is not None:
        fn, args = task
        try:
            results.put((rank, True, fn(rank, world, *args)))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
            return
        gc.collect()
        torch.cuda.empty_cache()


_POOL: list = []


def rank_pool() -> RankPool:
    """The script's one ``RankPool`` of ``MESH_WORLD`` ranks, made at first
    use and ended at exit."""
    if not _POOL:
        import atexit
        _POOL.append(RankPool(MESH_WORLD))
        atexit.register(_POOL[0].close)
    return _POOL[0]


def warm_census() -> float:
    """Enter the operation census once. -> seconds it took: its first use in
    a process imports PyTorch's dispatch machinery (seconds), which would
    otherwise land in the first phase it times."""
    from repro_torch.core import op_census
    t0 = time.perf_counter()
    with op_census.census():
        torch.zeros(1)
    return time.perf_counter() - t0


def mesh_record(res, wall, counts, census, ops) -> dict:
    """A MapReduce phase's record on one rank: its outputs and launches,
    its stage walls and the time in collectives, the shard accounting and
    the census."""
    st = res[0].stats
    rec = {"outputs": outputs(res), "host_wall_s": wall, "launches": counts,
           "census": census, "c10d_ops": ops}
    for k in ("wall_s", "map_wall_s", "shuffle_wall_s", "reduce_wall_s",
              "collective_wall_s", "fetch_wall_s", "spill_wall_s",
              "n_shards", "shard_padded_ratio", "tiers", "spill_ranges",
              "spilled_splits", "spill_bytes"):
        rec[k] = getattr(st, k)
    return rec


def bucket(rank: int, seed: int) -> torch.Tensor:
    """Rank ``rank``'s f32 gradient bucket of ``BUCKET_BYTES``, drawn on the
    card from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed * 1000 + rank)
    return torch.randn(BUCKET_BYTES // 4, generator=g, device="cuda")


def compressed_rank_by_rank(seed: int, ranks, me: int) -> torch.Tensor:
    """What ``compressed_psum_1d`` must return on rank ``me`` of the group
    ``ranks``: every member's quantized rows, this rank's row of each
    summed in f32, quantized again, and gathered, through the port's own
    ``quantize_block``/``dequantize_block``."""
    from repro_torch.core.compression import dequantize_block, quantize_block
    R, n = len(ranks), BUCKET_BYTES // 4
    m = -(-n // (R * 256)) * 256
    rows = [quantize_block(torch.nn.functional.pad(
        bucket(r, seed), (0, R * m - n)).reshape(R, m))[:2] for r in ranks]
    sums = []
    for i in range(R):
        chunk = dequantize_block(torch.stack([q[i] for q, _ in rows]),
                                 torch.stack([s[i] for _, s in rows]),
                                 m).sum(dim=0)
        sums.append(quantize_block(chunk)[:2])
    del rows
    return dequantize_block(torch.stack([q for q, _ in sums]),
                            torch.stack([s for _, s in sums]),
                            m).reshape(-1)[:n]


def mesh_collectives_rank(rank: int, world: int, seed: int) -> dict:
    """The flat, hierarchical and int8-compressed all-reduce of one
    ``BUCKET_BYTES`` bucket on a (pod 2, data world/2) mesh, each run once
    untimed (NCCL sets up a group's communicator and its connections on
    first use: about a second, against milliseconds warm), then timed and
    censused; the hierarchical one held to the flat one (rtol 1e-6),
    the compressed ones within ``md_check.py``'s bound (0.03 max|flat|)
    and ``compressed_psum_1d`` bit for bit to the quantizer applied rank
    by rank."""
    import torch.distributed as dist
    from repro_torch.core.collectives import flat_psum, hierarchical_psum_1d
    from repro_torch.core.compression import axis_group, compressed_psum_1d
    from repro_torch.launch.mesh import make_mesh, pod_size
    mesh = make_mesh((2, world // 2), ("pod", "data"))
    x = bucket(rank, seed)
    runs, out = {}, {}
    launched = launch_counts()
    for name, fn in (
            ("flat", lambda: flat_psum(x, ("pod", "data"), mesh=mesh)),
            ("hierarchical", lambda: hierarchical_psum_1d(
                x, "data", "pod", mesh=mesh)),
            ("hierarchical_int8", lambda: hierarchical_psum_1d(
                x, "data", "pod", codec="int8", mesh=mesh)),
            ("compressed", lambda: compressed_psum_1d(
                x, ("pod", "data"), mesh=mesh))):
        fn()
        out[name], wall, counts, census, ops = mesh_run(fn, pod_size(mesh))
        runs[name] = {"collective_s": wall, "launches": counts,
                      "census": census, "c10d_ops": ops}
        launched = {k: launched[k] + counts[k] for k in launched}
    flat = out["flat"]
    scale = flat.abs().max().item()
    err = {k: (out[k] - flat).abs().max().item() for k in out}
    tol = {"hierarchical": 1e-6 * scale + 1e-6,
           "hierarchical_int8": 0.03 * scale, "compressed": 0.03 * scale}
    for k, bound in tol.items():
        if not err[k] <= bound:
            raise AssertionError(f"mesh_collectives {k}: max |{k} - flat| "
                                 f"{err[k]} > {bound}")
    group = dist.get_process_group_ranks(axis_group(("pod", "data"),
                                                    mesh=mesh))
    want = compressed_rank_by_rank(seed, group, group.index(rank))
    check_equal("compressed_psum_1d against the quantizer rank by rank",
                out["compressed"].view(torch.int32), want.view(torch.int32))
    for name in runs:
        runs[name]["max_abs_err_vs_flat"] = err[name]
    return {"launches": launched, "flat_max_abs": scale, "runs": runs}


def mesh_service_rank(rank: int, xyz, mesh) -> dict:
    """``mesh_service`` on one rank: ``MRQueryService(mesh=)`` over the
    full-width catalog (int16, tile 256, 2 lanes). Rank 0 takes the
    clients; every rank serves the same batches: one warm batch of the
    4-query mix and a batch holding ``RankPoison``, both through
    ``run_pending`` under the census (one all-reduce a batch), then 64
    closed-loop requests of the mix through ``start``/``close``. The
    masked launches of every batch must be tiers x its distinct jobs (on
    the poison's rank its fallback runs them again). -> this rank's
    record, its requests' outputs included (None for a failed one)."""
    from repro_torch.launch.serve_mr import offer
    from repro_torch.mapreduce import MapReduceJob, latency_summary
    from repro_torch.serving import MRQueryService
    part, mix = service_mix()
    svc = MRQueryService(mesh=mesh, max_batch=16, max_wait_s=0.002,
                         n_lanes=2)
    lead = rank == 0
    cat, load_wall, _, _, _ = mesh_run(
        lambda: svc.load_catalog("sky", xyz, part, codec="int16"))
    tiers = len(cat.sd.tiers)
    rec = {"load_host_wall_s": load_wall, "tiers": tiers,
           "resident_bytes": cat.nbytes, "n_shards": cat.sd.shard_pad.size}

    def mine(reqs, n0):
        got = reqs if lead else svc.followed[n0:]
        return ([None if r.error else outputs([r])[0] for r in got],
                [None if r.error is None else f"{type(r.error).__name__}: "
                 f"{r.error}" for r in got])

    def masked(counts):
        return counts["pair_count_masked"] + counts["pair_hist_masked"]

    def sync_batch(name, jobs):
        n0 = len(svc.followed)
        reqs = [svc.submit(j, catalog="sky") for j in jobs] if lead else None
        served, wall, counts, census, ops = mesh_run(svc.run_pending)
        b = svc.batches[-1]
        allreduces = census["n_by_op"].get("all-reduce", 0)
        if served != len(jobs) or allreduces != 1 or b["allreduces"] != 1:
            raise AssertionError(f"mesh_service {name} rank {rank}: served "
                                 f"{served}, census {census}, batch {b}")
        rerun = name == "poison" and rank == POISON_RANK   # its fallback
        if not rerun and masked(counts) != tiers * b["n_unique"]:
            raise AssertionError(f"mesh_service {name} rank {rank}: "
                                 f"launches {counts} for {b['n_unique']} "
                                 f"jobs over {tiers} tiers")
        outs, errors = mine(reqs, n0)
        rec[name] = {"host_wall_s": wall, "launches": counts,
                     "census": census, "c10d_ops": ops, "batch": b,
                     "outputs": outs, "errors": errors}

    sync_batch("warm", mix)
    poison = MapReduceJob("poison", part, RankPoison(part.radius),
                          codec="int16", tile=256)
    sync_batch("poison", [mix[0], poison, mix[3], mix[1]])

    b0, n0, s0 = len(svc.batches), len(svc.followed), len(svc.request_stats)

    def closed_loop():
        svc.start()
        reqs = offer(svc, mix, 64, 0.0, "sky") if lead else None
        for r in reqs or ():
            r.result(timeout=600)
        svc.close()
        return reqs
    reqs, wall, counts, _, _ = mesh_run(closed_loop)
    batches = svc.batches[b0:]
    unique = sum(b["n_unique"] for b in batches)
    if (masked(counts) != tiers * unique
            or any(b["allreduces"] != 1 for b in batches)):
        raise AssertionError(f"mesh_service closed_loop rank {rank}: "
                             f"launches {counts} for {unique} jobs over "
                             f"{tiers} tiers; batches {batches}")
    outs, errors = mine(reqs, n0)
    rec["closed_loop"] = {
        "host_wall_s": wall, "launches": counts, "outputs": outs,
        "errors": errors, "batches": len(batches),
        "batch_sizes": [b["size"] for b in batches],
        "allreduces": sum(b["allreduces"] for b in batches),
        "collective_wall_s": sum(b["collective_wall_s"] for b in batches),
        "report_wall_s": sum(b["report_wall_s"] for b in batches),
        "summary": latency_summary(svc.request_stats[s0:])}
    rec["launches"] = {k: sum(rec[p]["launches"][k] for p in (
        "warm", "poison", "closed_loop")) for k in counts}
    return rec


def check_mesh_service(per_rank, want: list, world: int) -> None:
    """Every rank served what ``service_phase`` served on one card: the
    mix's outputs, the poison failing on every rank (with its rank's
    message) and its batch-mates served."""
    for r, rec in enumerate(per_rank):
        for name, expect in (
                ("warm", want), ("closed_loop", [want[i % len(want)]
                                                 for i in range(64)]),
                ("poison", [want[0], None, want[3], want[1]])):
            if rec[name]["outputs"] != expect:
                raise AssertionError(f"mesh_service {name} rank {r}: "
                                     f"{rec[name]['outputs']} != {expect}")
            rec[name]["outputs"] = f"equal to service_phase ({len(expect)})"
        errors = rec["poison"]["errors"]
        if (any(e is not None for i, e in enumerate(errors) if i != 1)
                or errors[1] is None
                or f"fails on rank {POISON_RANK}" not in errors[1]):
            raise AssertionError(f"mesh_service poison rank {r}: {errors}")
        if any(e is not None for e in rec["closed_loop"].pop("errors")):
            raise AssertionError(f"mesh_service closed_loop rank {r} failed")


def mesh_rank(rank: int, world: int, n: int, seed: int, tmp: str) -> dict:
    """One rank of the mesh phases, every rank on the same arguments: the
    catalog drawn from ``seed``, then ``mesh_device`` (int16 cold, then
    int16 and int8 warm),
    ``mesh_host`` (int8), ``mesh_stream`` (16 splits, then spilled at
    ``SPILL_BUDGET``) and ``mesh_service`` on a ("data",) mesh of ``world``
    and ``mesh_collectives``. Rank 0 checks, with ``all_gather_object``,
    that every rank returned the same outputs. -> {phase: this rank's
    record}."""
    import torch.distributed as dist
    from repro_torch.data import sky
    from repro_torch.data.pipeline import ArraySplits
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.mapreduce import (SpillConfig, run_jobs,
                                       run_jobs_streaming)
    xyz = sky.make_catalog(n, seed)
    mesh = make_mesh((world,), ("data",))
    census_s = warm_census()
    recs = {}

    def phase(name, codec, engine, fn, spill_root=None):
        jobs = zone_jobs(codec)
        res, wall, counts, census, ops = mesh_run(lambda: fn(jobs))
        st = res[0].stats
        want = zone_launches(engine, codec, jobs, st)
        if spill_root is None and counts != want:
            raise AssertionError(f"{name} {codec} rank {rank}: launches "
                                 f"{counts} != {want}")
        if spill_root is not None:
            check_spill(f"{name} rank {rank}", codec, st, counts, jobs,
                        SPILL_BUDGET, spill_root, STREAM_N_SPLITS)
        check_outputs(res, len(jobs[-1].reducer.edges_rad))
        got = [None] * world
        dist.all_gather_object(got, outputs(res))
        if rank == 0 and any(g != got[0] for g in got):
            raise AssertionError(f"{name} {codec}: ranks disagree: {got}")
        recs[name, codec] = mesh_record(res, wall, counts, census, ops)

    # the rank's first full-width run loads the kernels and grows its
    # allocator's pools (every rank at once): a phase of its own, so the
    # others are timed warm, as phase 3 is
    for name, codec in (("mesh_device_cold", "int16"),
                        ("mesh_device", "int16"), ("mesh_device", "int8")):
        phase(name, codec, "device",
              lambda jobs: run_jobs(jobs, xyz, mesh=mesh))
    recs["mesh_device_cold", "int16"]["census_first_use_s"] = census_s
    phase("mesh_host", "int8", "host",
          lambda jobs: run_jobs(jobs, xyz, mesh=mesh, engine="host"))
    splits = ArraySplits(xyz, STREAM_N_SPLITS)
    phase("mesh_stream", "int16", "device",
          lambda jobs: run_jobs_streaming(jobs, splits, mesh=mesh))
    root = Path(tmp) / "spill"
    phase("mesh_stream_spill", "int16", "device",
          lambda jobs: run_jobs_streaming(
              jobs, splits, mesh=mesh, spill=SpillConfig(
                  budget_bytes=SPILL_BUDGET, dir=str(root))),
          spill_root=root / f"rank{dist.get_rank()}")
    recs["mesh_service", "int16"] = mesh_service_rank(rank, xyz, mesh)
    recs["mesh_collectives", "f32"] = mesh_collectives_rank(rank, world, seed)
    return recs


def mesh_phases(xyz, seed: int, mono: dict, full_host: dict,
                service_want: list, launches: dict, n_edges: int) -> None:
    """Phases 19-22: the data-axis mesh. ``mesh_device`` first as a world of
    one NCCL rank in this process (D = 1: the reduce is unsharded, as in
    the reference, and one NCCL all-reduce of a bucket runs), then every
    mesh phase (``mesh_rank``) on ``MESH_WORLD`` gloo ranks spawned on the
    one card (NCCL takes one card a rank), and on NCCL over 2 or 4 cards
    where there are that many. Each rank's outputs equal phase 3's (the
    device engine, streamed and spilled), phase 4's (the host engine) or
    phase 18's (``mesh_service``, ``service_want``); their launches count
    toward the kernel table."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.core.compression import psum_1d
    from repro_torch.launch.mesh import make_mesh, spawn_world
    from repro_torch.mapreduce import run_jobs

    census_s = warm_census()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1,), ("data",))
        for codec in ("int16", "int8"):
            jobs = zone_jobs(codec)
            res, wall, counts = counted(
                lambda: run_jobs(jobs, xyz, mesh=mesh), launches)
            same_outputs(f"mesh_device world 1 {codec}", res,
                         mono[codec][0], n_edges)
            want = zone_launches("device", codec, jobs, res[0].stats)
            if counts != want:
                raise AssertionError(f"mesh_device world 1 {codec}: "
                                     f"launches {counts} != {want}")
            st = res[0].stats
            emit(phase="mesh_device", world=1, backend="nccl", codec=codec,
                 host_wall_s=wall, launches=counts, n_shards=st.n_shards,
                 shard_padded_ratio=st.shard_padded_ratio,
                 stats=stage_summary(st))
        x = bucket(0, seed)
        t0 = time.perf_counter()
        psum_1d(x[:1], "data", mesh=mesh)      # NCCL's communicator, lazily
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        first = mesh_run(lambda: psum_1d(x, "data", mesh=mesh))
        y, wall, counts, census, ops = mesh_run(
            lambda: psum_1d(x, "data", mesh=mesh))
        check_equal("psum over one rank", y.view(torch.int32),
                    x.view(torch.int32))
        emit(phase="mesh_collectives", world=1, backend="nccl",
             bucket_bytes=BUCKET_BYTES, census_first_use_s=census_s,
             nccl_init_s=init_s,
             first_psum_s=first[1], psum_s=wall, census=census,
             c10d_ops=ops)
        del x, y
    finally:
        dist.destroy_process_group()

    worlds = [("gloo", MESH_WORLD, "4 gloo ranks sharing one card")]
    cards = torch.cuda.device_count()
    if cards >= 2:
        worlds.append(("nccl", 4 if cards >= 4 else 2,
                       "NCCL, one card a rank"))
    else:
        emit(phase="mesh_nccl", skipped="one card: NCCL takes one card a "
             "rank, so the multi-rank NCCL world needs 2 or more")
    torch.cuda.empty_cache()
    for backend, world, note in worlds:
        with tempfile.TemporaryDirectory(prefix="chip-smoke-mesh-") as tmp:
            t0 = time.perf_counter()
            ranks = spawn_world(mesh_rank, world, len(xyz), seed, tmp,
                                backend=backend,
                                init_file=str(Path(tmp) / "store"),
                                timeout_s=900)
            spawn_s = time.perf_counter() - t0
        for (name, codec), rec0 in ranks[0].items():
            per_rank = [r[name, codec] for r in ranks]
            if name == "mesh_service":
                check_mesh_service(per_rank, service_want, world)
            elif name != "mesh_collectives":
                want = (full_host if name == "mesh_host" else
                        {c: m[0] for c, m in mono.items()})[codec]
                for r, rec in enumerate(per_rank):
                    if rec["outputs"] != want:
                        raise AssertionError(
                            f"{name} {codec} rank {r}: {rec['outputs']} != "
                            f"{want}")
                    del rec["outputs"]
            for rec in per_rank:
                for k, v in rec["launches"].items():
                    launches[k] += v
            emit(phase=name, world=world, backend=backend, note=note,
                 codec=codec, spawn_s=spawn_s, equals={
                     "mesh_host": "phase 4", "mesh_service": "phase 18",
                     "mesh_collectives": "flat within the bounds"}.get(
                         name, "phase 3"),
                 ranks=per_rank)


def example_phase(launches: dict) -> None:
    """``example``: ``examples/torch_neighbor_search.py --n EXAMPLE_N`` as a
    subprocess on the card (every section: the radius sweep, the stage
    swaps, both apps over one shuffle, memmap streaming, the straggler with
    speculation, the service). It must exit 0, and the counts of its last
    line must equal ``run_jobs`` here on its catalog (``make_catalog(n,
    0)``): the sweep per radius (identity), the exact codecs' swaps and
    the batched search at its radius, the int16 runs (streamed,
    speculated, served) the int16 ``run_jobs``, and the batched
    histogram's cumulative count its search."""
    from repro_torch.data import sky
    from repro_torch.mapreduce import (ZonePartitioner, neighbor_search_job,
                                       run_jobs)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_neighbor_search.py"),
         "--n", str(EXAMPLE_N)], capture_output=True, text=True,
        timeout=600, cwd=ROOT)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"example exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    xyz = sky.make_catalog(EXAMPLE_N, 0)
    r = got["radius"]

    def count(radius, codec, zones=None):
        job = neighbor_search_job(radius, codec=codec, tile=256,
                                  partitioner=ZonePartitioner(zones or radius))
        res, _, _ = counted(lambda: run_jobs([job], xyz), launches)
        return res[0].output
    sweep = [[radius, count(radius, "identity")]
             for radius in (r / 2, r, 2 * r)]
    # the service's catalog is zoned at r, its r/2 query too
    at_r, int16_r, int16_half = sweep[1][1], count(r, "int16"), count(
        r / 2, "int16", zones=r)
    swaps = got["stage_swaps"]
    checks = {
        "radius_sweep": (got["radius_sweep"], sweep),
        "exact swaps": ([swaps["baseline"],
                         swaps["batched (buffering analogue)"],
                         got["batched"]["pairs"],
                         int(np.sum(got["batched"]["histogram"]))],
                        [at_r] * 4),
        "int16": ([swaps["int16 shuffle (LZO analogue)"], got["streamed"],
                   got["speculation"]["clean"],
                   got["speculation"]["straggler"]], [int16_r] * 4),
        "service": (got["service"], [int16_r, int16_half] * 4)}
    for what, (have, want) in checks.items():
        if have != want:
            raise AssertionError(f"example {what}: {have} != run_jobs {want}")
    emit(phase="example", n=EXAMPLE_N, host_wall_s=wall, counts=got,
         equals="run_jobs", stdout_lines=len(proc.stdout.splitlines()))


def lm_main_path(seed: int, dev, launches: dict):
    """Phases 24-26: TinyLlama prefill, decode and the serving CLI at full
    width. -> (the model, the prefill tokens) for phase 27."""
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.launch import serve
    from repro_torch.models import model as mdl
    from repro_torch.serving import make_decode_step, make_prefill_step

    cfg, rc = get_arch(LM_ARCH), RunConfig()
    B, S, n_dec = LM_BATCH, LM_PROMPT, LM_DECODE
    t0 = time.perf_counter()
    lm = mdl.init(cfg, seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1))
    prefill = make_prefill_step(cfg, rc, S + n_dec)
    decode = make_decode_step(cfg, rc)

    # 16. prefill (one uncounted warm-up call first: cuBLAS handles, autotune)
    prefill(lm, {"tokens": toks[:, :S]})
    torch.cuda.reset_peak_memory_stats()
    (cache, last), wall, counts = counted(
        lambda: prefill(lm, {"tokens": toks[:, :S]}), launches,
        flash_launches(cfg.n_layers, torch.bfloat16))
    if last.shape != (B, cfg.vocab_padded) or not torch.isfinite(last).all():
        raise AssertionError(f"prefill logits {tuple(last.shape)} not finite")
    emit(phase="lm_prefill", arch=LM_ARCH, batch=B, prompt=S,
         max_len=S + n_dec, dtype=str(last.dtype), init_s=init_s, wall_s=wall,
         tokens_per_s=B * S / wall, launches=counts,
         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
         param_gb=param_gb(lm))

    # 17. greedy decode from that cache, then test_smoke_archs' consistency
    def run_decode():
        tok, times, first = toks[:, S:S + 1], [], None
        for i in range(n_dec):
            t0 = time.perf_counter()
            logits, _ = decode(lm, cache, tok, S + i)
            tok = torch.argmax(logits, dim=-1, keepdim=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            first = logits if first is None else first
        return first, times
    (first, times), wall, counts = counted(run_decode, launches,
                                           launch_counts())
    with torch.inference_mode():
        full = mdl.forward(cfg, rc, lm, {"tokens": torch.as_tensor(
            toks, device=dev)})[0][:, S].float()
    rel = ((first.float() - full).abs().max()
           / torch.clamp_min(full.abs().max(), 1.0)).item()
    if not rel < 0.07:
        raise AssertionError(f"decode vs forward: relative error {rel}")
    ms = statistics.median(times) * 1e3
    emit(phase="lm_decode", steps=n_dec, batch=B, wall_s=wall,
         ms_per_step=ms, first_step_ms=times[0] * 1e3,
         tokens_per_s=B / (ms / 1e3), launches=counts,
         rel_err_vs_forward=rel)
    del cache

    # 18. the serving CLI with its defaults
    (eng, reqs, steps, _), wall, counts = counted(
        lambda: serve.main([]), launches, launch_counts())
    done = sum(r.done for r in reqs)
    if done != len(reqs) or not eng.closed:
        raise AssertionError(f"serve: {done}/{len(reqs)} finished, closed "
                             f"{eng.closed}")
    emit(phase="lm_serve", requests=len(reqs), finished=done, steps=steps,
         closed=eng.closed, wall_s=wall, steps_per_s=steps / wall,
         new_tokens=sum(len(r.out) for r in reqs), launches=counts)
    return lm, toks[:, :S]


def param_gb(module) -> float:
    return sum(p.numel() * p.element_size() for p in module.parameters()) / 1e9


def decode_read_gb(lm) -> float:
    """The weights one decode step reads: every layer's (a MoE layer's
    experts all, each holding some of the step's few tokens), the norm and
    the head; not the MTP block, nor an untied embedding, of which a step
    gathers only its tokens' rows."""
    skip = ("mtp.",) + (("embed.",) if "head" in lm else ())
    return sum(p.numel() * p.element_size() for n, p in lm.named_parameters()
               if not n.startswith(skip)) / 1e9


def flash_err(q, k, v, **kw) -> tuple:
    """The flash kernel against ``attention_ref`` within ``FLASH_TOL``
    (|got - want| <= atol + rtol |want|), or raise. -> (max abs error,
    max abs output)."""
    from repro_torch.kernels.flash_attention import kernel, ref
    got = kernel.flash_attention_cuda(q, k, v, **kw).float()
    want = ref.attention_ref(q, k, v, **kw).float()
    atol, rtol = FLASH_TOL[q.dtype]
    diff = (got - want).abs()
    if not (diff <= atol + rtol * want.abs()).all():
        raise AssertionError(f"flash {tuple(q.shape)} {q.dtype} {kw}: max "
                             f"error {diff.max().item()} beyond {atol} + "
                             f"{rtol} |want|")
    return diff.max().item(), want.abs().max().item()


def flash_vs_plain(lm, toks, dev, launches: dict) -> dict:
    """Phase 27: the flash kernel against its plain version on layer 0's
    q/k/v at the prefill shape (``flash_instance``) and over the test
    sweep. -> the kernel's row of the table."""
    from test_torch_cases import (FLASH_CASES, FLASH_EDGE_CASES,
                                  FLASH_FAMILY_CASES, flash_case)

    inst = flash_instance(lm.cfg, lm, toks, dev)
    inst32 = flash_instance(lm.cfg, lm, toks, dev, dtype=torch.float32)
    worst = {"prefill_bf16": inst["max_abs_err"],
             "prefill_float32": inst32["max_abs_err"]}
    # (dtype, S, H, Kv, dh, window, cap, scale, B, seed): the sweep in both
    # dtypes, then the f32 family cases as test_torch_cuda.py draws them
    cases = [(dtype, S, H, Kv, dh, window, cap, None, 2, 0)
             for dtype in (torch.float32, torch.bfloat16)
             for S, H, Kv, dh, window, cap in FLASH_CASES + FLASH_EDGE_CASES]
    cases += [(*c, c[1] + c[2]) for c in FLASH_FAMILY_CASES.values()
              if c[0] == torch.float32]
    for dtype, S, H, Kv, dh, window, cap, scale, B, seed in cases:
        name = str(dtype).split(".")[-1]
        qc, kc, vc = (torch.as_tensor(x).to(dtype).to(dev)
                      for x in flash_case(S, H, Kv, dh, seed=seed, B=B))
        for causal in (True, False):
            e, _ = flash_err(qc, kc, vc, causal=causal, window=window,
                             softcap=cap, scale=scale)
            worst[name] = max(worst.get(name, 0.0), e)
    emit(phase="flash_vs_plain", shape=inst["shape"], cases=len(cases),
         max_abs_err=worst, max_abs_out=inst["max_abs_out"],
         tol={str(d).split(".")[-1]: t for d, t in FLASH_TOL.items()},
         f32=inst32)
    return kernel_row(
        "flash_attention", FA_SOURCE, launches, inst["max_abs_err"],
        inst["ms"], inst["plain_ms"], inst["bound_ms"], inst["bound_by"],
        library_ms=inst["library_ms"],
        tolerance=dict(zip(("atol", "rtol"), inst["tol"])),
        shape=inst["shape"], flops=inst["flops"], bytes=inst["bytes"],
        max_abs_err_sweep=worst,
        achieved_tflops=inst["flops"] / inst["ms"] / 1e9,
        x_sdpa=inst["ms"] / inst["library_ms"],
        instances={f"{lm.cfg.name} f32": inst32})


# (phase, arch, batch, prompt): each family at its published widths, with
# prompts past gemma2's and recurrentgemma's windows (the local layers' ring
# wraps) and, for mamba2, not a multiple of the 256-step SSD chunk (the
# trailing pad runs)
FAMILY_PHASES = (
    ("lm_olmo", "olmo-1b", 4, 2048),
    ("lm_starcoder2", "starcoder2-7b", 4, 2048),
    ("lm_gemma2", "gemma2-2b", 1, 4608),
    ("lm_recurrentgemma", "recurrentgemma-2b", 2, 2560),
    ("lm_mamba2", "mamba2-1.3b", 4, 2100),
    ("lm_granite_moe", "granite-moe-3b-a800m", 4, 2048),
    ("lm_deepseek_v3", "deepseek-v3-671b", 2, 2048),
    # 30 s of audio at EnCodec's 50 Hz frame rate (arXiv:2306.05284): not a
    # multiple of the kernel's tile, so its tail block runs
    ("lm_musicgen", "musicgen-medium", 4, 1500),
    # the first 256 positions are one InternViT tile's patch embeddings
    ("lm_internvl2", "internvl2-2b", 4, 2048),
)
# depth cuts: deepseek-v3's 61 layers (671e9 parameters) do not fit one
# card; its first 4 keep the 3 dense layers and one MoE layer (start_layer
# 3), about 15.8e9 parameters, 31.6 GB in bf16
FAMILY_LAYERS = {"deepseek-v3-671b": 4}
FAMILY_DECODE = 16
# a MoE layer against its plain per-expert version (bf16): max |diff| under
# this share of max |y|, a few bf16 ulps (2^-8) of the largest output
MOE_REL = 2e-2
FP32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, FP32 outside the tensor
                               # cores
# prefill + decode against one forward: max |diff| over max |logit|. f32
# streams (gemma2's and recurrentgemma's: the reference's embedding scale
# promotes them; every bf16 family's f32 copy) differ by sums in another
# order; bf16 streams keep the reference's 0.07 (tests/test_smoke_archs.py)
# unless the bf16 forward is itself further from the f32 forward on the same
# weights (mamba2's 48 layers at full width), which then bounds them
FAMILY_REL = {torch.float32: 1e-3, torch.bfloat16: 0.07}
# blocked_causal on deepseek-v3's first MLA layer (a call flash does not
# take) against the chunked loop, in f32: max |diff| over max |o|
BLOCKED_CHUNK, BLOCKED_REL = 256, 1e-5


def first_attention_qkv(cfg, lm, toks, dev, inputs=None, dtype=None):
    """The first attention layer's rotated q and k and its v over
    ``toks`` (and the batch's ``inputs``: ``cond``, ``prefix``), from the
    stack's own activations up to that layer (layer 0 but for
    recurrentgemma, whose first attention layer is layer 2); with
    ``dtype``, that layer's norm, projections and rotation run on the
    activations cast to it. -> (layer index, q, k, v, window)."""
    inputs = inputs or {}
    from repro_torch.configs import RunConfig
    from repro_torch.models import model as mdl, transformer as tfm
    from repro_torch.models.common import apply_norm, einsum, rope
    plan = tfm.layer_plan(cfg)
    li = next(i for i, (kind, _) in enumerate(plan) if kind in ("attn",
                                                                "local"))
    with torch.inference_mode():
        tokens = torch.as_tensor(toks, device=dev)
        pos = torch.arange(toks.shape[1], device=dev)
        x = mdl._embed(cfg, lm, tokens, pos, inputs.get("prefix"))
        for i in range(li):
            x, _, _ = tfm.layer_apply(cfg, RunConfig(), lm.stack[i], x,
                                      kind=plan[i][0], ffn=plan[i][1],
                                      positions=pos, cond=inputs.get("cond"))
        p = lm.stack[li]
        h = apply_norm(cfg.norm, x if dtype is None else x.to(dtype),
                       p.get("norm1"))
        q, k, v = (einsum("bsd,dhk->bshk", h, p["attn"][w])
                   for w in ("w_q", "w_k", "w_v"))
        if cfg.pos == "rope":
            q, k = (rope(t, pos, cfg.rope_theta) for t in (q, k))
    window = cfg.window if plan[li][0] == "local" else 0
    return li, q.contiguous(), k.contiguous(), v.contiguous(), window


def attended_pairs(S: int, window: int) -> float:
    """(query, key) pairs the causal (and window) mask keeps."""
    if not window or window >= S:
        return S * (S + 1) / 2
    return window * (window + 1) / 2 + (S - window) * window


def flash_instance(cfg, lm, toks, dev, inputs=None, dtype=None) -> dict:
    """``flash_timing`` on the first attention layer's q/k/v at the prefill
    shape, dtype (or ``dtype``), head dim, window and softcap of ``cfg``."""
    li, q, k, v, window = first_attention_qkv(cfg, lm, toks, dev, inputs,
                                              dtype)
    kw = dict(causal=True, window=window, softcap=cfg.attn_logit_softcap,
              scale=cfg.query_scale or None)
    return {"layer": li, "shape": [list(q.shape), list(k.shape)],
            "dtype": str(q.dtype).split(".")[-1], "window": window,
            "softcap": cfg.attn_logit_softcap, "scale": kw["scale"],
            "group": q.shape[2] // k.shape[2], **flash_timing(q, k, v, **kw)}


def flash_timing(q, k, v, **kw) -> dict:
    """The flash kernel against its plain version (``flash_err``) on q/k/v
    with ``kw`` (causal, window, softcap, scale); then its time beside the
    plain version's, the bound and ``scaled_dot_product_attention``'s where
    SDPA computes the same function (no softcap: a window goes in as a
    boolean mask)."""
    from repro_torch.kernels.flash_attention import kernel, ref
    max_err, max_out = flash_err(q, k, v, **kw)
    B, S, H, dh = q.shape
    window, cap = kw.get("window", 0), kw.get("softcap", 0.0)
    flops = 4.0 * B * H * dh * attended_pairs(S, window)
    byte_count = 2 * q.element_size() * (q.numel() + k.numel())  # q k v o
    peak = FP32_FLOPS_PER_S if q.dtype == torch.float32 else BF16_FLOPS_PER_S
    ops_ms, bytes_ms = flops / peak * 1e3, byte_count / HBM_BYTES_PER_S * 1e3
    ms = cuda_ms(lambda: kernel.flash_attention_cuda(q, k, v, **kw))
    plain_ms = cuda_ms(lambda: ref.attention_ref(q, k, v, **kw), reps=3)
    library_ms = None
    if not cap:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        opts = dict(is_causal=True)
        if window:
            pos = torch.arange(S, device=q.device)
            rel = pos[:, None] - pos[None, :]
            opts = dict(attn_mask=(rel >= 0) & (rel < window))
        library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, enable_gqa=True,
                                          scale=kw.get("scale"), **opts))
    return {"max_abs_err": max_err, "max_abs_out": max_out,
            "tol": list(FLASH_TOL[q.dtype]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": flops, "bytes": byte_count, "library_ms": library_ms,
            "x_bound": ms / max(ops_ms, bytes_ms)}


def decode_run(decode, lm, cache, last, S: int, n: int, feed=None):
    """``n`` decode steps from a prefill's cache and last logits: greedy,
    or fed the tokens ``feed`` [B, n]. Attention layers write the cache in
    place, recurrent ones return it anew. -> (the fed tokens [B, n], the
    prefill's and every step's logits [B, n + 1, Vp], host ms a step)."""
    tok = torch.argmax(last, -1, keepdim=True) if feed is None else feed[:, :1]
    fed, steps, times = [], [last], []
    for i in range(n):
        t0 = time.perf_counter()
        logits, cache = decode(lm, cache, tok, S + i)
        fed.append(tok)
        tok = torch.argmax(logits, dim=-1, keepdim=True) if feed is None \
            else feed[:, i + 1:i + 2]
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        steps.append(logits)
    return torch.cat(fed, 1), torch.stack(steps, 1), times


def forward_logits(cfg, rc, lm, toks, fed, S: int, inputs=None):
    """One ``forward`` over the prompt and the fed tokens (with the batch's
    ``inputs``: ``cond``, ``prefix``): its logits at the prefill's last
    position and at every decoded one, f32."""
    from repro_torch.models import model as mdl
    with torch.inference_mode():
        full = torch.cat([torch.as_tensor(toks, device=fed.device), fed], 1)
        return mdl.forward(cfg, rc, lm, {"tokens": full, **(inputs or {})}
                           )[0][:, S - 1:].float()


def held_to_forward(arch: str, got, want, bound: float, rows=None,
                    need_rows: bool = True) -> dict:
    """Prefill + decode logits ``got`` against the forward's ``want``: max
    |diff| <= ``bound``, and argmax equal on every row whose top-2 margin
    in ``want`` exceeds twice that diff (narrower rows are ties at this
    precision). ``rows`` [B, n + 1] (MoE) keeps the rows the two calls
    route alike; without ``need_rows`` none may be left (bf16 MoE: near-ties
    flip from layer to layer), else one must be."""
    got, excluded = got.float(), 0
    if rows is not None:
        excluded = int((~rows).sum())
        if not rows.any():
            if need_rows:
                raise AssertionError(f"{arch}: no row routed alike by "
                                     "prefill + decode and the forward")
            return {"rows_excluded_routing": excluded, "rows_held": 0}
        got, want = got[rows], want[rows]
    max_diff = (got - want).abs().max().item()
    top2 = want.topk(2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]) > 2 * max_diff
    same = got.argmax(-1) == want.argmax(-1)
    if not max_diff <= bound or not same[decisive].all():
        raise AssertionError(f"{arch}: prefill + decode vs forward: max diff "
                             f"{max_diff} (bound {bound}); argmax differs "
                             f"at {int((~same & decisive).sum())} decisive "
                             "rows")
    return {"max_abs_diff": max_diff, "bound": bound,
            "max_abs_logit": want.abs().max().item(),
            "argmax_rows": int(same.numel()), "argmax_equal": int(same.sum()),
            "argmax_decisive": int(decisive.sum()),
            "rows_excluded_routing": excluded, "rows_held": int(same.numel())}


def blocked_vs_chunked(cfg, lm, toks, dev, launches: dict) -> dict:
    """``attend(impl="blocked_causal", chunk=BLOCKED_CHUNK)`` on the first
    MLA layer's q/k/v at the prefill shape (q/k head dim 192, v 128: flash
    takes one head dim), in f32, against ``impl="chunked"`` on the same
    inputs: max |diff| within ``BLOCKED_REL`` of max |o|, no kernel
    launched; both times (CUDA events, median of 3) and the block pairs the
    schedule computes against the chunked loop's."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import model as mdl
    from repro_torch.models.common import apply_norm
    with torch.inference_mode():
        pos = torch.arange(toks.shape[1], device=dev)
        x = mdl._embed(cfg, lm, torch.as_tensor(toks, device=dev), pos)
        p = lm.stack[0]
        h = apply_norm(cfg.norm, x, p.get("norm1"))
        q = torch.cat(attn_mod._mla_q(cfg, p["attn"], h, pos), dim=-1)
        k, v = attn_mod._mla_kv(cfg, p["attn"], *attn_mod._mla_latent(
            cfg, p["attn"], h, pos))
        q, k, v = (t.float().contiguous() for t in (q, k, v))
        m = cfg.mla
        kw = dict(causal=True, chunk=BLOCKED_CHUNK,
                  scale=1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim))
        got, _, counts = counted(
            lambda: attn_mod.attend(q, k, v, impl="blocked_causal", **kw),
            launches, launch_counts())
        want = attn_mod.attend(q, k, v, impl="chunked", **kw)
        diff = (got - want).abs().max().item()
        top = want.abs().max().item()
        if not diff <= BLOCKED_REL * top:
            raise AssertionError(f"blocked_causal vs chunked: max diff {diff}"
                                 f" beyond {BLOCKED_REL} of max |o| {top}")
        ms = cuda_ms(lambda: attn_mod.attend(q, k, v, impl="blocked_causal",
                                             **kw), reps=3)
        chunked_ms = cuda_ms(lambda: attn_mod.attend(q, k, v, impl="chunked",
                                                     **kw), reps=3)
    nb = -(-q.shape[1] // BLOCKED_CHUNK)
    return {"shape": [list(q.shape), list(k.shape), list(v.shape)],
            "dtype": "float32", "chunk": BLOCKED_CHUNK, "launches": counts,
            "max_abs_diff": diff, "max_abs_out": top, "rel_bound": BLOCKED_REL,
            "blocked_ms": ms, "chunked_ms": chunked_ms,
            "block_pairs": nb * (nb + 1) // 2, "chunked_block_pairs": nb * nb}


def first_moe_input(cfg, lm, toks, dev):
    """The first MoE layer's FFN input (after its attention and ``norm2``)
    over ``toks``, from the stack's own activations. -> (layer index, h
    [B, S, D])."""
    from repro_torch.configs import RunConfig
    from repro_torch.models import model as mdl, transformer as tfm
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.common import apply_norm
    plan, rc = tfm.layer_plan(cfg), RunConfig()
    li = next(i for i, (_, f) in enumerate(plan) if f == "moe")
    with torch.inference_mode():
        tokens = torch.as_tensor(toks, device=dev)
        pos = torch.arange(toks.shape[1], device=dev)
        x = mdl._embed(cfg, lm, tokens, pos)
        for i in range(li):
            x, _, _ = tfm.layer_apply(cfg, rc, lm.stack[i], x,
                                      kind=plan[i][0], ffn=plan[i][1],
                                      positions=pos)
        p = lm.stack[li]
        h = apply_norm(cfg.norm, x, p.get("norm1"))
        y, _ = attn_mod.gqa_or_mla_apply(
            cfg, p["attn"], h, kind=plan[li][0], positions=pos,
            impl=rc.attention_impl_for(h.shape[1]), chunk=rc.attn_chunk)
        h = apply_norm(cfg.norm, x + y, p.get("norm2"))
    return li, h


def moe_vs_plain(cfg, lm, toks, dev) -> dict:
    """The first MoE layer on its actual input at the prefill shape,
    through the port (``moe._moe_body``) and through a plain per-expert
    version on the card (``test_torch_cases.plain_moe``): the kept (token,
    k) assignments equal, exactly; the output within ``MOE_REL`` of max
    |y|; dropped assignments per chunk, the padded ratio ``E_pad C_exp /
    (n K)`` and both times."""
    from repro_torch.models import moe
    from test_torch_cases import plain_moe
    li, h = first_moe_input(cfg, lm, toks, dev)
    m, p = cfg.moe, lm.stack[li]["moe"]
    x = h.reshape(-1, h.shape[-1])
    T = x.shape[0]
    n, C_send, C_exp = moe._capacity(m, T)
    with torch.inference_mode():
        y, load, _, keep = moe._moe_body(cfg, p, x, p["bias"])
        want, want_keep = plain_moe(cfg, p, x, p["bias"])
        ms = cuda_ms(lambda: moe._moe_body(cfg, p, x, p["bias"]))
        plain_ms = cuda_ms(lambda: plain_moe(cfg, p, x, p["bias"]), reps=3)
    if not torch.equal(keep, want_keep):
        raise AssertionError(f"{cfg.name} MoE layer {li}: kept assignments "
                             f"differ at {int((keep != want_keep).sum())}")
    diff = (y.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    if not diff <= MOE_REL * top:
        raise AssertionError(f"{cfg.name} MoE layer {li}: max diff {diff} "
                             f"beyond {MOE_REL} of max |y| {top}")
    real = torch.arange(keep.shape[0], device=dev) < T
    dropped = ((~keep) & real[:, None]).view(-1, n * m.top_k).sum(1)
    return {"layer": li, "tokens": T, "chunk_tokens": n, "C_send": C_send,
            "C_exp": C_exp, "experts_padded": m.n_experts_padded,
            "padded_ratio": m.n_experts_padded * C_exp / (n * m.top_k),
            "dropped_per_chunk": dropped.tolist(),
            "load_max_over_mean": (load[:m.n_experts].max()
                                   / load[:m.n_experts].mean()).item(),
            "kept_equal": True, "max_abs_diff": diff, "max_abs_y": top,
            "rel_bound": MOE_REL, "ms": ms, "plain_ms": plain_ms,
            "dtype": str(y.dtype).split(".")[-1]}


def family_phase(phase: str, arch: str, B: int, S: int, seed: int, dev,
                 launches: dict) -> dict | None:
    """One architecture at its published widths (depth cut where
    ``FAMILY_LAYERS`` says), bf16 weights from ``seed``: prefill over B x S
    tokens (one flash launch per attention layer and no other launch; none
    for MLA, whose head dims the kernel does not take) and FAMILY_DECODE
    greedy decode steps, held to one ``forward`` over the same tokens
    (``held_to_forward``; for MoE the rows the two calls route alike,
    ``test_torch_cases.routed_alike``: they chunk the batch differently, so
    capacity drops differ, and a token dropped in one changes the later
    tokens of its sequence), the flash kernel against its plain version, a
    MoE layer against its plain version (``moe_vs_plain``), and the serving
    CLI for the arch. musicgen's ``cond`` and internvl2's ``prefix`` (the
    stub frontends' outputs, ``model.stub_frontend``, bf16 from ``seed``)
    go into prefill and into every forward it is held to; musicgen's 48
    cross-attention layers run the masked formula and launch nothing. For
    MLA, ``blocked_vs_chunked``. Where the stream is bf16 the weights then
    turn f32 in place: one f32 forward gives the bf16 forward's own error
    (the bound is the larger of ``FAMILY_REL`` x max |logit| and that
    error), and f32 prefill + decode, fed the same tokens, is held to the
    f32 forward at ``FAMILY_REL[f32]``. -> the flash instance's record
    (None without flash)."""
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.launch import serve
    from repro_torch.models import model as mdl
    from repro_torch.serving import make_decode_step, make_prefill_step
    from test_torch_cases import kept_experts, recorded_routing, routed_alike

    def alike(pd_calls, fwd_calls):
        """[B, n_dec + 1] rows routed alike (None without MoE)."""
        if cfg.moe is None:
            return None
        return routed_alike(cfg, kept_experts(cfg, pd_calls, B, S, n_dec),
                            kept_experts(cfg, fwd_calls, B, S + n_dec)
                            )[:, S - 1:]

    cfg, rc, n_dec = get_arch(arch), RunConfig(), FAMILY_DECODE
    if arch in FAMILY_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=FAMILY_LAYERS[arch])
    n_attn = sum(k in ("attn", "local") for k in cfg.layer_kinds)
    n_flash = 0 if cfg.mla is not None else n_attn
    t0 = time.perf_counter()
    lm = mdl.init(cfg, seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb, read_gb = param_gb(lm), decode_read_gb(lm)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))
    inputs = mdl.stub_frontend(cfg, B, seed, device=dev)
    batch = {"tokens": toks, **inputs}
    prefill = make_prefill_step(cfg, rc, S + n_dec)
    decode = make_decode_step(cfg, rc)

    prefill(lm, batch)                            # warm-up, uncounted
    torch.cuda.reset_peak_memory_stats()
    with recorded_routing() as pd_calls:
        (cache, last), prefill_s, counts = counted(
            lambda: prefill(lm, batch), launches)
        stream = last.dtype              # the flash kernel's input dtype
        if counts != flash_launches(n_flash, stream):
            raise AssertionError(f"{arch} prefill: launches {counts} != "
                                 f"{flash_launches(n_flash, stream)}")
        (fed, got, times), decode_s, dcounts = counted(
            lambda: decode_run(decode, lm, cache, last, S, n_dec), launches,
            launch_counts())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del cache, last
    with recorded_routing() as fwd_calls:
        want = forward_logits(cfg, rc, lm, toks, fed, S, inputs)
    rows = alike(pd_calls, fwd_calls)
    del pd_calls, fwd_calls
    bound = FAMILY_REL[stream] * max(want.abs().max().item(), 1.0)
    flash = flash_instance(cfg, lm, toks, dev, inputs) if n_flash else None
    moe_check = moe_vs_plain(cfg, lm, toks, dev) if cfg.moe else None
    blocked = blocked_vs_chunked(cfg, lm, toks, dev, launches) if cfg.mla \
        else None
    f32 = None
    if stream != torch.float32:
        # in place: deepseek-v3's f32 copy (63 GB) does not fit beside it
        lm.float()
        torch.cuda.empty_cache()
        with recorded_routing() as fwd32_calls:
            want32 = forward_logits(cfg, rc, lm, toks, fed, S, inputs)
        floor = (want - want32).abs().max().item()
        bound = max(bound, floor)
        with recorded_routing() as pd32_calls:
            cache32, last32 = prefill(lm, batch)
            _, got32, _ = decode_run(decode, lm, cache32, last32, S, n_dec,
                                     feed=fed)
        rows32 = alike(pd32_calls, fwd32_calls)
        f32 = {"bf16_forward_vs_f32_forward": floor,
               **held_to_forward(arch, got32, want32, FAMILY_REL[torch.float32]
                                 * max(want32.abs().max().item(), 1.0),
                                 rows32)}
        del cache32, last32, got32, want32, pd32_calls, fwd32_calls
    check = held_to_forward(arch, got, want, bound, rows,
                            need_rows=stream == torch.float32)
    del got, want
    emit(phase=phase, arch=arch, batch=B, prompt=S, decode_steps=n_dec,
         layers=cfg.n_layers, max_len=S + n_dec,
         stream_dtype=str(stream).split(".")[-1], param_gb=weights_gb,
         init_s=init_s, prefill_s=prefill_s,
         prefill_tokens_per_s=B * S / prefill_s,
         ms_per_decode_step=statistics.median(times),
         decode_read_gb=read_gb,
         decode_weight_floor_ms=read_gb * 1e9 / HBM_BYTES_PER_S * 1e3,
         first_step_ms=times[0], decode_wall_s=decode_s, peak_gb=peak_gb,
         prefill_launches=counts, decode_launches=dcounts,
         flash_launches_per_prefill=n_flash,
         no_flash_because=("MLA: q/k head dim "
                           f"{cfg.mla.nope_head_dim + cfg.mla.rope_head_dim}"
                           f", v {cfg.mla.v_head_dim}; the kernel takes one "
                           "head dim") if cfg.mla and n_attn else None,
         cross_attention_layers=n_attn if cfg.cross_attn else 0,
         inputs={k: list(t.shape) for k, t in inputs.items()},
         vs_forward=check, f32=f32, flash=flash, moe_vs_plain=moe_check)
    if blocked is not None:
        emit(phase=f"{phase}_blocked_causal", arch=arch, **blocked)
    del inputs, batch
    del lm
    torch.cuda.empty_cache()

    layers = ["--layers", str(cfg.n_layers)] if arch in FAMILY_LAYERS else []
    (eng, reqs, steps, _), wall, counts = counted(
        lambda: serve.main(["--arch", arch, "--requests", "4",
                            "--max-new", "4", "--max-len", "32", *layers]),
        launches, launch_counts())
    if not (eng.closed and all(r.done for r in reqs)):
        raise AssertionError(f"serve --arch {arch}: "
                             f"{sum(r.done for r in reqs)}/4 finished")
    emit(phase=f"{phase}_serve", arch=arch, requests=len(reqs), steps=steps,
         wall_s=wall, launches=counts)
    del eng, reqs
    torch.cuda.empty_cache()
    return flash


# training (phases 37-40): TinyLlama-1.1B at its published widths and depth,
# bucketed AdamW, remat "full"; the learning rate warms up over 2 steps and
# decays over TRAIN_STEPS (the defaults' 100-step warm-up would barely move
# 8 steps)
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 8
TRAIN_RC = dict(learning_rate=3e-4, warmup_steps=2, steps=TRAIN_STEPS)
# the first step's bf16 loss against loss_fn in f32 on the same weights:
# FAMILY_REL[bf16] of the f32 loss; a repeated batch must lose LOSS_DROP
LOSS_DROP = 0.5
# train_resume: TinyLlama cut to 2 layers (the checkpoint holds the 131M
# parameters of the embedding and head at any depth), 2 x 1,024 tokens,
# 4 + 4 steps against 8; deterministic algorithms for the phase (the
# embedding's backward accumulates with atomics otherwise), so the losses
# must agree to the JAX test's rtol 1e-4
RESUME_LAYERS, RESUME_BATCH, RESUME_SEQ = 2, 2, 1024
# train_granite_moe: granite-moe-3b-a800m at its published widths cut from
# 32 to 8 layers (its 32 layers' AdamW state, 55 GB, would not fit beside
# the activations), its prefill's 4 x 2,048 tokens, 3 steps
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 8, 3
# train_mesh: the explicit data-parallel sync on MESH_WORLD gloo ranks on
# the card, TinyLlama cut to 2 layers in f32, 8 x 512 tokens (2 rows a
# rank), MESH_TRAIN_STEPS steps. The first step's learning rate is 0
# (warm-up 1), so its moments are the synced gradient's: held to one rank's
# step on the whole batch within MESH_TRAIN_REL of each bucket's max (f32
# sums in another order); the second step is the first to move the
# weights, so the third step's loss is the first to see an update
MESH_TRAIN_LAYERS, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 2, 8, 512
MESH_TRAIN_STEPS, MESH_TRAIN_REL = 3, 1e-5
INT8_LOSS_GAP = 0.15           # tests/md_check.py's train check
# train_fsdp: FSDP on the same 4 gloo ranks, the same 2-layer f32 TinyLlama
# and batch, "sharded" on (4,) and "data" on (2, 2), held to one rank's
# step as train_mesh is; granite-moe cut to FSDP_MOE_LAYERS layers in f32
# held to the replicated step on the same mesh (each rank's MoE chunks its
# own tokens in both) within FSDP_MOE_RTOL. On 4 or more cards: granite at
# its 32 layers, bf16, bucketed AdamW, FSDP_CARDS_BATCH x FSDP_CARDS_SEQ
# (one row a card), over NCCL, MESH_TRAIN_STEPS steps on one batch
FSDP_MOE_LAYERS, FSDP_MOE_RTOL = 2, 1e-4
FSDP_CARDS, FSDP_CARDS_BATCH, FSDP_CARDS_SEQ = 4, 4, 2048


def train_steps(fn, state, batch, n: int, launches: dict, want: dict):
    """``n`` steps of ``fn`` from ``state`` on one batch, each counted
    (``counted``: the launches must equal ``want`` a step). -> (state,
    metrics of each step as floats, host walls)."""
    mets, walls = [], []
    for _ in range(n):
        (state, m), wall, _ = counted(lambda: fn(state, batch), launches,
                                      want)
        mets.append({k: v.item() for k, v in m.items()})
        walls.append(wall)
    return state, mets, walls


def check_finite(phase: str, mets: list) -> None:
    bad = [m for m in mets if not all(math.isfinite(v) for v in m.values())]
    if bad:
        raise AssertionError(f"{phase}: non-finite metrics {bad[0]}")


def f32_copy(cfg, lm):
    """``lm``'s weights in f32, in a new LM (the biases kept f32)."""
    from repro_torch.models import model as mdl
    lm32 = mdl.LM(cfg, device="meta")
    lm32.load_state_dict({k: v.detach().float()
                          for k, v in lm.state_dict().items()}, assign=True)
    return lm32


def train_tinyllama(seed: int, dev, launches: dict) -> None:
    """Phase 37: TinyLlama-1.1B at its published widths and depth (22
    layers), bf16 weights from ``seed``, ``RunConfig`` defaults (bucketed
    AdamW, remat "full", sharded on one card) but ``TRAIN_RC``'s schedule:
    ``TRAIN_STEPS`` steps on one repeated batch of TRAIN_BATCH x TRAIN_SEQ
    tokens. Exactly 2 flash launches a layer a step (the forward and its
    recompute) and no quantize launch; every metric finite; the loss falls
    by more than ``LOSS_DROP``; the first step's loss within
    ``FAMILY_REL[bf16]`` of ``loss_fn`` in f32 on the same weights."""
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.models import model as mdl
    from repro_torch.training import init_state, make_bucket_plan
    from repro_torch.training import make_train_step

    cfg, rc = get_arch(TRAIN_ARCH), RunConfig(**TRAIN_RC)
    t0 = time.perf_counter()
    state = init_state(cfg, rc, seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                (TRAIN_BATCH, TRAIN_SEQ))
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    lm32 = f32_copy(cfg, state["params"])
    with torch.no_grad():
        loss32 = mdl.loss_fn(cfg, rc, lm32, batch)[0].item()
    del lm32
    torch.cuda.empty_cache()
    fn = make_train_step(cfg, rc)
    torch.cuda.reset_peak_memory_stats()
    state, mets, walls = train_steps(
        fn, state, batch, TRAIN_STEPS, launches,
        flash_launches(2 * cfg.n_layers, torch.bfloat16))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_finite("train_tinyllama", mets)
    losses = [m["loss"] for m in mets]
    if not losses[-1] < losses[0] - LOSS_DROP:
        raise AssertionError(f"train_tinyllama: loss {losses} did not fall "
                             f"by {LOSS_DROP}")
    bound = FAMILY_REL[torch.bfloat16] * abs(loss32)
    if not abs(losses[0] - loss32) <= bound:
        raise AssertionError(f"train_tinyllama: first loss {losses[0]} vs "
                             f"f32 {loss32} beyond {bound}")
    plan = make_bucket_plan(cfg, rc, lm=state["params"])
    step_s = statistics.median(walls[1:])
    emit(phase="train_tinyllama", arch=TRAIN_ARCH, layers=cfg.n_layers,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
         optimizer="adamw_b", remat=rc.remat, buckets=len(plan.bucket_sizes),
         bucket_elements=list(plan.bucket_sizes), init_s=init_s,
         first_step_s=walls[0], step_s=step_s, step_walls_s=walls,
         tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s, peak_gb=peak_gb,
         param_gb=param_gb(state["params"]), losses=losses,
         grad_norms=[m["grad_norm"] for m in mets], loss_f32=loss32,
         first_loss_vs_f32=abs(losses[0] - loss32), loss_bound=bound,
         flash_launches_per_step=2 * cfg.n_layers)
    del state, fn, batch
    torch.cuda.empty_cache()


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def train_resume(seed: int, dev, launches: dict) -> None:
    """Phase 38: ``launch/train.py``'s ``train()`` on TinyLlama cut to
    ``RESUME_LAYERS`` layers: 8 steps against 4, a checkpoint (2 replicas
    over 4 simulated hosts, async), and 4 more resumed from it, under
    deterministic algorithms: the last 4 losses agree to rtol 1e-4. Then
    the resumed state saved (blocking) and restored into a fresh state,
    whole and with host 0 in ``failed_hosts``, equal bit for bit; the
    checkpoint's bytes and the save and restore walls."""
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.launch.train import train
    from repro_torch.training import init_state

    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=RESUME_LAYERS)
    rc = RunConfig(**TRAIN_RC)
    kw = dict(batch=RESUME_BATCH, seq=RESUME_SEQ, log_every=1000,
              device=dev)
    half = TRAIN_STEPS // 2

    def flash(steps):
        return flash_launches(2 * cfg.n_layers * steps, torch.bfloat16)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as tmp:
            a, b = Path(tmp) / "a", Path(tmp) / "b"
            (_, full), full_s, _ = counted(
                lambda: train(cfg, rc, steps=TRAIN_STEPS, ckpt_dir=str(a),
                              ckpt_every=100, **kw), launches,
                flash(TRAIN_STEPS))
            _, first_s, _ = counted(
                lambda: train(cfg, rc, steps=half, ckpt_dir=str(b),
                              ckpt_every=half, **kw), launches, flash(half))
            (state, resumed), resumed_s, _ = counted(
                lambda: train(cfg, rc, steps=half, ckpt_dir=str(b),
                              ckpt_every=100, **kw), launches, flash(half))
            if not np.allclose(full[half:], resumed, rtol=1e-4, atol=0):
                raise AssertionError(f"train_resume: resumed {resumed} != "
                                     f"uninterrupted {full[half:]}")
            ck = Checkpointer(str(Path(tmp) / "c"), replication=2,
                              n_hosts=4, async_io=True)
            t0 = time.perf_counter()
            ck.save(TRAIN_STEPS, state, blocking=True)
            save_s = time.perf_counter() - t0
            ckpt_bytes = dir_bytes(Path(ck.step_dir(TRAIN_STEPS)))
            restore_s = {}
            for name, failed in (("whole", None), ("host_0_failed", {0})):
                fresh = init_state(cfg, rc, seed + 1, device=dev)
                t0 = time.perf_counter()
                fresh, _ = ck.restore(fresh, failed_hosts=failed)
                torch.cuda.synchronize()
                restore_s[name] = time.perf_counter() - t0
                for (n, p), q in zip(state["params"].named_parameters(),
                                     fresh["params"].parameters()):
                    if not torch.equal(p, q):
                        raise AssertionError(f"train_resume: restored {n} "
                                             f"differs ({name})")
                for x, y in zip(state["opt"]["m"] + state["opt"]["v"],
                                fresh["opt"]["m"] + fresh["opt"]["v"]):
                    if not torch.equal(x, y):
                        raise AssertionError("train_resume: restored "
                                             f"moments differ ({name})")
                del fresh
    finally:
        torch.use_deterministic_algorithms(False)
    emit(phase="train_resume", arch=TRAIN_ARCH, layers=cfg.n_layers,
         batch=RESUME_BATCH, seq=RESUME_SEQ, losses_uninterrupted=full,
         losses_resumed=resumed,
         max_rel_diff=float(np.max(np.abs(np.subtract(full[half:], resumed))
                                   / np.abs(full[half:]))),
         wall_uninterrupted_s=full_s, wall_first_half_s=first_s,
         wall_resumed_s=resumed_s, checkpoint_bytes=ckpt_bytes,
         replication=2, save_s=save_s, restore_s=restore_s,
         deterministic=True)
    del state
    torch.cuda.empty_cache()


def train_granite_moe(seed: int, dev, launches: dict) -> None:
    """Phase 39: granite-moe-3b-a800m at its published widths cut to
    ``MOE_TRAIN_LAYERS`` layers, bf16, its prefill's 4 x 2,048 tokens,
    ``MOE_TRAIN_STEPS`` steps with the MoE aux loss in the loss (the
    backward through the one-card dispatch): 2 flash launches a layer a
    step (bf16 ``<64>``, G = 3), finite metrics, a positive aux loss."""
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.training import init_state, make_train_step

    cfg = dataclasses.replace(get_arch("granite-moe-3b-a800m"),
                              n_layers=MOE_TRAIN_LAYERS)
    rc = RunConfig(**TRAIN_RC)
    state = init_state(cfg, rc, seed, device=dev)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (4, 2048))
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    torch.cuda.reset_peak_memory_stats()
    state, mets, walls = train_steps(
        make_train_step(cfg, rc), state, batch, MOE_TRAIN_STEPS, launches,
        flash_launches(2 * cfg.n_layers, torch.bfloat16))
    check_finite("train_granite_moe", mets)
    if not all(m["moe_aux_loss"] > 0 for m in mets):
        raise AssertionError(f"train_granite_moe: aux loss {mets}")
    step_s = statistics.median(walls[1:])
    emit(phase="train_granite_moe", arch="granite-moe-3b-a800m",
         layers=cfg.n_layers, batch=4, seq=2048, steps=MOE_TRAIN_STEPS,
         param_gb=param_gb(state["params"]),
         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
         first_step_s=walls[0], step_s=step_s,
         tokens_per_s=4 * 2048 / step_s, metrics=mets,
         flash_launches_per_step=2 * cfg.n_layers)
    del state, batch
    torch.cuda.empty_cache()


def train_mesh_rank(rank: int, world: int, seed: int,
                    device_type: str = "cuda") -> dict:
    """One rank of ``train_mesh``: the replicated step with the explicit
    sync, ``MESH_TRAIN_STEPS`` steps on a ("data",) mesh of ``world`` (no
    compression) and as many on (pod 2, data world/2) with
    ``compress_grads`` (error feedback on every bucket, int8 on the
    cross-pod phase of ``hierarchical_psum_1d``), each step counted and
    censused. Rank 0 then takes one rank's steps on the whole batch and
    measures the synced run's first-step moments (lr 0: 0.1 of the synced
    gradient) against them."""
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.launch.mesh import make_mesh, pod_size
    from repro_torch.training import init_state, make_train_step

    cfg = dataclasses.replace(get_arch(TRAIN_ARCH),
                              n_layers=MESH_TRAIN_LAYERS)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (MESH_TRAIN_BATCH, MESH_TRAIN_SEQ))
    batch = {"tokens": torch.as_tensor(toks, device=device_type)}
    warm_census()
    out, first = {}, None
    for name, shape, axes, knobs in (
            ("sync", (world,), ("data",), {}),
            ("int8", (2, world // 2), ("pod", "data"),
             {"compress_grads": True})):
        mesh = make_mesh(shape, axes, device_type=device_type)
        rc = RunConfig(pod_param_mode="replicated", warmup_steps=1,
                       steps=4, learning_rate=3e-4, **knobs)
        state = init_state(cfg, rc, seed, mesh, device=device_type,
                           dtype=torch.float32)
        fn = make_train_step(cfg, rc, mesh)
        recs = []
        for i in range(MESH_TRAIN_STEPS):
            (state, m), wall, counts, census, ops = mesh_run(
                lambda: fn(state, batch), pod_size(mesh))
            recs.append({"metrics": {k: v.item() for k, v in m.items()},
                         "host_wall_s": wall, "launches": counts,
                         "census": census, "c10d_ops": ops})
            if name == "sync" and i == 0:
                first = [t.clone() for t in state["opt"]["m"]]
        out[name] = {"steps": recs, "buckets": len(state["opt"]["m"])}
        del state, fn
        torch.cuda.empty_cache()
    if rank == 0:
        rc = RunConfig(pod_param_mode="replicated", warmup_steps=1, steps=4,
                       learning_rate=3e-4)
        state = init_state(cfg, rc, seed, device=device_type,
                           dtype=torch.float32)
        fn = make_train_step(cfg, rc)
        want = []
        for i in range(MESH_TRAIN_STEPS):
            state, m = fn(state, batch)
            want.append({k: v.item() for k, v in m.items()})
            if i == 0:
                # the mesh's buckets are padded to a multiple of its ranks
                err = max(((a[:b.numel()] - b).abs().max()
                           / b.abs().max()).item()
                          for a, b in zip(first, state["opt"]["m"],
                                          strict=True))
        out["one_rank"] = {"metrics": want, "m_max_rel_err": err}
    return out


def train_mesh(seed: int, launches: dict) -> None:
    """Phase 40: ``train_mesh_rank`` on ``MESH_WORLD`` gloo ranks sharing
    the card. Every rank's metrics equal across ranks; the synced run's
    first-step moments within ``MESH_TRAIN_REL`` of one rank's step on the
    whole batch, every step's loss and grad norm within rtol 1e-5 of it
    (1e-4 after the update: an Adam step moves a weight whose gradient
    rounds to the other sign by twice the learning rate); the int8 run's
    loss after the update within ``INT8_LOSS_GAP`` of the synced run's,
    its quantize and dequantize launches printed. The launches count
    toward the kernel table."""

    t0 = time.perf_counter()
    ranks = rank_pool().run(train_mesh_rank, seed)
    spawn_s = time.perf_counter() - t0
    for name in ("sync", "int8"):
        for r, rec in enumerate(ranks):
            if [s["metrics"] for s in rec[name]["steps"]] != \
                    [s["metrics"] for s in ranks[0][name]["steps"]]:
                raise AssertionError(f"train_mesh {name}: rank {r}'s "
                                     "metrics differ from rank 0's")
            for s in rec[name]["steps"]:
                for k, v in s["launches"].items():
                    launches[k] += v
    one = ranks[0]["one_rank"]
    if not one["m_max_rel_err"] <= MESH_TRAIN_REL:
        raise AssertionError(f"train_mesh: synced moments {one} beyond "
                             f"{MESH_TRAIN_REL}")
    for i, (got, want) in enumerate(zip(ranks[0]["sync"]["steps"],
                                        one["metrics"], strict=True)):
        for k in ("loss", "grad_norm"):
            if not math.isclose(got["metrics"][k], want[k],
                                rel_tol=1e-5 if i < 2 else 1e-4):
                raise AssertionError(f"train_mesh: {k} {got['metrics'][k]} "
                                     f"!= one rank's {want[k]}")
    gap = abs(ranks[0]["int8"]["steps"][-1]["metrics"]["loss"]
              - ranks[0]["sync"]["steps"][-1]["metrics"]["loss"])
    if not gap < INT8_LOSS_GAP:
        raise AssertionError(f"train_mesh: int8 loss gap {gap}")
    q = [s["launches"]["quantize"] for s in ranks[0]["int8"]["steps"]]
    if not all(n > 0 for n in q):
        raise AssertionError(f"train_mesh: int8 step launched no quantize "
                             f"kernel {q}")
    emit(phase="train_mesh", world=MESH_WORLD, backend="gloo",
         arch=TRAIN_ARCH, layers=MESH_TRAIN_LAYERS, dtype="float32",
         batch=MESH_TRAIN_BATCH, seq=MESH_TRAIN_SEQ, spawn_s=spawn_s,
         one_rank=one, int8_loss_gap={"gap": gap, "bound": INT8_LOSS_GAP},
         quantize_per_step=q,
         dequantize_per_step=[s["launches"]["dequantize"]
                              for s in ranks[0]["int8"]["steps"]],
         ranks=[{n: r[n] for n in ("sync", "int8")} for r in ranks])


def state_bytes(state) -> int:
    """Bytes of a train state's parameters, optimizer state and residuals
    on this rank."""
    return sum(t.numel() * t.element_size() for t in state_tensors(state))


def state_tensors(state) -> list:
    """A train state's parameters, optimizer tensors and residuals."""
    ts = list(state["params"].parameters())

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            ts.append(x)
    walk(state["opt"])
    walk(state.get("ef", {}))
    return ts


def first_moments(state) -> dict:
    """The state's first moments as whole buckets in the reference's
    order (a collective under FSDP: every rank calls it)."""
    from repro_torch.training.state import checkpoint_leaves
    return {k: lf.get().clone() for k, lf in checkpoint_leaves(state).items()
            if k.startswith("opt/m/")}


def train_fsdp_rank(rank: int, world: int, seed: int) -> dict:
    """One rank of ``train_fsdp``: FSDP steps on 4 gloo ranks sharing the
    card, each counted and censused, beside the replicated state's bytes
    on the same mesh. Rank 0 then takes one rank's steps on the whole
    batch (TinyLlama) and measures the first-step moments against it."""
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.launch.mesh import make_mesh, pod_size
    from repro_torch.training import init_state, make_train_step

    tiny = dataclasses.replace(get_arch(TRAIN_ARCH),
                               n_layers=MESH_TRAIN_LAYERS)
    moe = dataclasses.replace(get_arch("granite-moe-3b-a800m"),
                              n_layers=FSDP_MOE_LAYERS)
    toks = np.random.default_rng(seed).integers(
        0, tiny.vocab, (MESH_TRAIN_BATCH, MESH_TRAIN_SEQ))
    batch = {"tokens": torch.as_tensor(toks, device="cuda")}
    warm_census()
    out, first = {}, {}
    for name, cfg, shape, axes, knobs in (
            ("sharded", tiny, (world,), ("data",), {}),
            ("data", tiny, (2, world // 2), ("pod", "data"),
             {"pod_param_mode": "data"}),
            ("granite", moe, (world,), ("data",), {}),
            ("granite_replicated", moe, (world,), ("data",),
             {"pod_param_mode": "replicated"})):
        mesh = make_mesh(shape, axes)
        rc = RunConfig(warmup_steps=1, steps=4, learning_rate=3e-4, **knobs)
        rep = RunConfig(warmup_steps=1, steps=4, learning_rate=3e-4,
                        pod_param_mode="replicated")
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        if not name.endswith("replicated"):
            whole = init_state(cfg, rep, seed, mesh, device="cuda",
                               dtype=torch.float32)
            rep_alloc = torch.cuda.memory_allocated() - base
            rep_bytes = state_bytes(whole)
            del whole
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
        state = init_state(cfg, rc, seed, mesh, device="cuda",
                           dtype=torch.float32)
        init_alloc = torch.cuda.memory_allocated() - base
        fn = make_train_step(cfg, rc, mesh)
        recs = []
        for i in range(MESH_TRAIN_STEPS):
            torch.cuda.reset_peak_memory_stats()
            (state, m), wall, counts, census, ops = mesh_run(
                lambda: fn(state, batch), pod_size(mesh))
            recs.append({"metrics": {k: v.item() for k, v in m.items()},
                         "host_wall_s": wall, "launches": counts,
                         "census": census, "c10d_ops": ops,
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
            if i == 0 and cfg is tiny:
                first[name] = first_moments(state)
        rec = {"steps": recs, "state_bytes": state_bytes(state),
               "tensors": len(state_tensors(state)),
               "alloc_after_init_bytes": init_alloc}
        if not name.endswith("replicated"):
            rec.update(replicated_state_bytes=rep_bytes,
                       replicated_alloc_after_init_bytes=rep_alloc)
        out[name] = rec
        del state, fn
        torch.cuda.empty_cache()
    if rank == 0:
        rc = RunConfig(warmup_steps=1, steps=4, learning_rate=3e-4)
        state = init_state(tiny, rc, seed, device="cuda", dtype=torch.float32)
        fn = make_train_step(tiny, rc)
        want = []
        for i in range(MESH_TRAIN_STEPS):
            state, m = fn(state, batch)
            want.append({k: v.item() for k, v in m.items()})
            if i == 0:
                one = first_moments(state)
                err = {name: max(((got[k] - b).abs().max() / b.abs().max())
                                 .item() for k, b in one.items())
                       for name, got in first.items()}
        out["one_rank"] = {"metrics": want, "m_max_rel_err": err}
        del state, fn
        torch.cuda.empty_cache()
    return out


def train_fsdp_cards_rank(rank: int, world: int, seed: int, layers: int,
                          batch_rows: int, seq: int,
                          device_type: str = "cuda", shape=None,
                          axes=("data",)) -> dict:
    """One rank of ``train_fsdp``'s multi-card run: granite-moe at
    ``layers`` layers in its schema's dtypes (bf16), bucketed AdamW,
    "sharded" over every rank (over the data ranks of ``shape``, the
    experts over its ``model`` ranks where ``axes`` has them: ``train_ep``'s
    multi-card run), ``MESH_TRAIN_STEPS`` steps on one batch.
    ``device_type`` "cpu" runs the same code on gloo ranks (reduced
    widths)."""
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import init_state, make_train_step

    cfg = get_arch("granite-moe-3b-a800m")
    cfg = dataclasses.replace(cfg if device_type == "cuda" else cfg.reduced(),
                              n_layers=layers)
    mesh = make_mesh(shape or (world,), axes, device_type=device_type)
    rc = RunConfig(warmup_steps=1, steps=4, learning_rate=3e-4)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                (batch_rows, seq))
    dev = torch.device(device_type, rank) if device_type == "cuda" else \
        torch.device("cpu")
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    t0 = time.perf_counter()
    state = init_state(cfg, rc, seed, mesh, device=dev)
    init_s = time.perf_counter() - t0
    fn = make_train_step(cfg, rc, mesh)
    cuda = device_type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    mets, walls = [], []
    for _ in range(MESH_TRAIN_STEPS):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fn(state, batch)
        mets.append({k: v.item() for k, v in m.items()})
        walls.append(time.perf_counter() - t0)
    return {"metrics": mets, "step_walls_s": walls, "init_s": init_s,
            "state_bytes": state_bytes(state),
            "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if cuda else None)}


def train_fsdp(seed: int, launches: dict) -> None:
    """Phase 41: ``train_fsdp_rank`` on ``MESH_WORLD`` gloo ranks sharing
    the card. Every rank's metrics equal across ranks; "sharded" and
    "data" within rtol 1e-5 of one rank's step on the whole batch (1e-4
    after the update) with first-step moments within ``MESH_TRAIN_REL``;
    granite within ``FSDP_MOE_RTOL`` of the replicated step; each rank's
    state bytes at most the replicated state's over F plus one
    ``pad_multiple`` of f32 elements a tensor; flash launched twice a
    layer a step. Then ``train_fsdp_cards``. The launches count toward the
    kernel table."""

    t0 = time.perf_counter()
    ranks = rank_pool().run(train_fsdp_rank, seed)
    spawn_s = time.perf_counter() - t0
    names = ("sharded", "data", "granite", "granite_replicated")
    for name in names:
        for r, rec in enumerate(ranks):
            if [s["metrics"] for s in rec[name]["steps"]] != \
                    [s["metrics"] for s in ranks[0][name]["steps"]]:
                raise AssertionError(f"train_fsdp {name}: rank {r}'s "
                                     "metrics differ from rank 0's")
            for s in rec[name]["steps"]:
                if s["launches"]["flash_attention"] != 2 * MESH_TRAIN_LAYERS:
                    raise AssertionError(f"train_fsdp {name}: launches "
                                         f"{s['launches']}")
                for k, v in s["launches"].items():
                    launches[k] += v
    one = ranks[0]["one_rank"]
    for name in ("sharded", "data"):
        if not one["m_max_rel_err"][name] <= MESH_TRAIN_REL:
            raise AssertionError(f"train_fsdp {name}: first moments "
                                 f"{one['m_max_rel_err']} beyond "
                                 f"{MESH_TRAIN_REL}")
        for i, (got, want) in enumerate(zip(ranks[0][name]["steps"],
                                            one["metrics"], strict=True)):
            for k in ("loss", "grad_norm"):
                if not math.isclose(got["metrics"][k], want[k],
                                    rel_tol=1e-5 if i < 2 else 1e-4):
                    raise AssertionError(f"train_fsdp {name}: {k} "
                                         f"{got['metrics'][k]} != one "
                                         f"rank's {want[k]}")
    for got, want in zip(ranks[0]["granite"]["steps"],
                         ranks[0]["granite_replicated"]["steps"],
                         strict=True):
        for k, v in want["metrics"].items():
            if not math.isclose(got["metrics"][k], v, rel_tol=FSDP_MOE_RTOL):
                raise AssertionError(f"train_fsdp granite: {k} "
                                     f"{got['metrics'][k]} != replicated "
                                     f"{v}")
    for name, F in (("sharded", MESH_WORLD), ("data", 2),
                    ("granite", MESH_WORLD)):
        for r, rec in enumerate(ranks):
            n = rec[name]["replicated_state_bytes"]
            pad = 4 * MESH_WORLD * rec[name]["tensors"]
            if not rec[name]["state_bytes"] <= n / F + pad:
                raise AssertionError(f"train_fsdp {name}: rank {r} holds "
                                     f"{rec[name]['state_bytes']} bytes, "
                                     f"the replicated state {n}")
    emit(phase="train_fsdp", world=MESH_WORLD, backend="gloo",
         arch=TRAIN_ARCH, moe_arch="granite-moe-3b-a800m",
         layers=MESH_TRAIN_LAYERS, moe_layers=FSDP_MOE_LAYERS,
         dtype="float32", batch=MESH_TRAIN_BATCH, seq=MESH_TRAIN_SEQ,
         spawn_s=spawn_s, one_rank=one,
         ranks=[{n: r[n] for n in names} for r in ranks])
    train_fsdp_cards(seed)


def train_fsdp_cards(seed: int) -> None:
    """``train_fsdp``'s multi-card run: ``train_fsdp_cards_rank`` over
    NCCL on ``FSDP_CARDS`` cards, one a rank; finite metrics, the loss
    down by the third step, each card's peak and the tokens/s. On fewer
    cards one line says why it did not run."""
    import tempfile
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import spawn_world

    cards = torch.cuda.device_count()
    if cards < FSDP_CARDS:
        emit(phase="train_fsdp_cards", skipped=f"{cards} card(s): granite-"
             "moe at 32 layers with its AdamW state is a model no card "
             f"holds; FSDP over NCCL, one card a rank, needs {FSDP_CARDS}")
        return
    with tempfile.TemporaryDirectory(prefix="chip-smoke-fsdp-cards-") as tmp:
        t0 = time.perf_counter()
        ranks = spawn_world(train_fsdp_cards_rank, FSDP_CARDS, seed,
                            get_arch("granite-moe-3b-a800m").n_layers,
                            FSDP_CARDS_BATCH, FSDP_CARDS_SEQ,
                            backend="nccl",
                            init_file=str(Path(tmp) / "store"),
                            timeout_s=900)
        spawn_s = time.perf_counter() - t0
    losses = [m["loss"] for m in ranks[0]["metrics"]]
    check_finite("train_fsdp_cards", ranks[0]["metrics"])
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train_fsdp_cards: loss {losses} did not fall")
    step_s = statistics.median(ranks[0]["step_walls_s"][1:])
    emit(phase="train_fsdp_cards", world=FSDP_CARDS, backend="nccl",
         arch="granite-moe-3b-a800m",
         layers=get_arch("granite-moe-3b-a800m").n_layers, dtype="bfloat16",
         batch=FSDP_CARDS_BATCH, seq=FSDP_CARDS_SEQ, spawn_s=spawn_s,
         losses=losses, step_s=step_s,
         tokens_per_s=FSDP_CARDS_BATCH * FSDP_CARDS_SEQ / step_s,
         peak_gb_by_card=[r["peak_gb"] for r in ranks],
         state_gb_by_card=[r["state_bytes"] / 1e9 for r in ranks],
         ranks=ranks)


# ---------------------------------------------------------------------------
# 42-43. experts over the model axis
# ---------------------------------------------------------------------------

# moe_ep: one MoE layer at published widths on MESH_WORLD gloo ranks on the
# card, its experts over the model axis: granite-moe (48 experts, top-8,
# chunks of 4,096) on x [4, 2,048, 1,536] over (1, 4) and (2, 2) data x
# model at capacity 1.25 and 8, the exchange in bf16 and in int8;
# deepseek-v3's MoE layer (256 experts and a shared one, sigmoid router
# with a bias from --seed, routed_scaling 2.5; 22.5 GB of experts, 5.6 GB a
# rank) on x [2, 2,048, 7,168] over (1, 4) at 1.25, bf16 and int8. Expert
# e's weights come from seed + 1 + e, so a rank draws only its own and the
# parent the whole layer for the plain version (``moe_ep_plain``), which
# runs first and is freed before the ranks start.
EP_LAYERS = (  # name, arch, x rows x seq, mesh shape, capacity, int8
    ("granite-1x4-cf1.25", "granite-moe-3b-a800m", (4, 2048), (1, 4), 1.25,
     False),
    ("granite-1x4-cf1.25-int8", "granite-moe-3b-a800m", (4, 2048), (1, 4),
     1.25, True),
    ("granite-1x4-cf8", "granite-moe-3b-a800m", (4, 2048), (1, 4), 8.0,
     False),
    ("granite-1x4-cf8-int8", "granite-moe-3b-a800m", (4, 2048), (1, 4), 8.0,
     True),
    ("granite-2x2-cf1.25", "granite-moe-3b-a800m", (4, 2048), (2, 2), 1.25,
     False),
    ("granite-2x2-cf1.25-int8", "granite-moe-3b-a800m", (4, 2048), (2, 2),
     1.25, True),
    ("granite-2x2-cf8", "granite-moe-3b-a800m", (4, 2048), (2, 2), 8.0,
     False),
    ("granite-2x2-cf8-int8", "granite-moe-3b-a800m", (4, 2048), (2, 2), 8.0,
     True),
    ("deepseek-1x4-cf1.25", "deepseek-v3-671b", (2, 2048), (1, 4), 1.25,
     False),
    ("deepseek-1x4-cf1.25-int8", "deepseek-v3-671b", (2, 2048), (1, 4), 1.25,
     True),
)
# int8 against bf16 exchange: a hop moves each element of a block by at
# most half a code step, max |block| / 254 (``parallel/ep.py::q8``), so a
# block's error relative to its RMS is at most kappa / 254, kappa its max
# over its RMS (a dispatch block holds rows of x: kappa = max |x| / rms
# x). The gated FFN is about quadratic in its input, so its output moves by
# at most twice that relative to its RMS, itself at most max |y|; the
# return hop adds one half step of its block, taken at max |y|. With the
# gates' sum (1 for granite's renormalised softmax, routed_scaling 2.5 for
# deepseek): |y_int8 - y_bf16| <= gates (2 kappa + 1) / 254 max |y_bf16|
EP_INT8_HALF_STEP = 1 / 254


def ep_layer_cfg(arch: str, cf: float):
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def ep_layer(cfg, seed: int, experts, dev) -> dict:
    """One MoE layer's bf16 parameters: the router (f32), the shared
    expert and the router bias (``randn / 20``) from ``seed``, expert e's
    ``w_gate``/``w_up``/``w_down`` from ``seed + 1 + e``, for ``experts``
    only, in order."""
    m, D = cfg.moe, cfg.d_model
    F_ = m.d_ff_expert
    g = torch.Generator(device=dev).manual_seed(seed)
    E = m.n_experts_padded
    p = {"router": torch.randn(D, E, generator=g, device=dev) / math.sqrt(D)}
    if m.n_shared:
        Fs = m.d_ff_shared * m.n_shared
        p["shared"] = {
            "w_up": (torch.randn(D, Fs, generator=g, device=dev)
                     / math.sqrt(D)).to(torch.bfloat16),
            "w_gate": (torch.randn(D, Fs, generator=g, device=dev)
                       / math.sqrt(D)).to(torch.bfloat16),
            "w_down": (torch.randn(Fs, D, generator=g, device=dev)
                       / math.sqrt(Fs)).to(torch.bfloat16)}
    bias = torch.randn(E, generator=g, device=dev) / 20
    experts = list(experts)
    for name, shape, fan in (("w_gate", (D, F_), D), ("w_up", (D, F_), D),
                             ("w_down", (F_, D), F_)):
        w = torch.empty((len(experts),) + shape, dtype=torch.bfloat16,
                        device=dev)
        for i, e in enumerate(experts):
            ge = torch.Generator(device=dev).manual_seed(
                seed + 1 + e + {"w_gate": 0, "w_up": 1 << 20,
                                "w_down": 2 << 20}[name])
            w[i] = torch.randn(shape, generator=ge, device=dev) / math.sqrt(
                fan)
        p[name] = w
    return p, bias


def ep_layer_x(cfg, rows_seq, seed: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    return torch.randn(rows_seq + (cfg.d_model,), generator=g,
                       device=dev).to(torch.bfloat16)


def moe_ep_plain_runs(seed: int, tmp: Path) -> dict:
    """The plain version of every ``EP_LAYERS`` run, in this process on the
    card, per data rank: the routed output, the keep masks and loads of
    each model rank (``moe_ep_plain``), and at capacity 8 the one-card
    body's output, each saved to ``tmp``; the whole deepseek layer is
    freed before returning. -> plain ms by name."""
    from repro_torch.models import moe
    dev = torch.device("cuda")
    plain_ms, layers = {}, {}
    for name, arch, rows_seq, shape, cf, int8 in EP_LAYERS:
        cfg = ep_layer_cfg(arch, cf)
        if arch not in layers:
            layers.clear()
            gc.collect()
            torch.cuda.empty_cache()
            layers[arch] = ep_layer(cfg, seed, range(
                cfg.moe.n_experts_padded), dev)
        p, bias = layers[arch]
        x = ep_layer_x(cfg, rows_seq, seed, dev)
        dp, tp = shape
        n = rows_seq[0] // dp
        out = []
        with torch.inference_mode():
            for d in range(dp):
                xd = x[d * n:(d + 1) * n].reshape(-1, cfg.d_model)
                ys, load, aux, keeps = moe.moe_ep_plain(
                    cfg, p, xd, bias, tp, compress_a2a=int8)
                one = (moe._moe_body(cfg, p, xd, bias)[0].cpu()
                       if cf >= 8 and not int8 else None)
                out.append({"y": [y.cpu() for y in ys[:1]] if
                            moe._ep_capacity(cfg.moe, xd.shape[0], tp)[-1]
                            else [y.cpu() for y in ys],
                            "keeps": [k.cpu() for k in keeps],
                            "load": load.cpu(), "one_card": one})
            if name in ("granite-1x4-cf1.25", "deepseek-1x4-cf1.25"):
                xd = x.reshape(-1, cfg.d_model)
                plain_ms[name] = cuda_ms(lambda: moe.moe_ep_plain(
                    cfg, p, xd, bias, tp), reps=1)
        torch.save(out, tmp / f"{name}.pt")
    del p, bias, x, xd
    layers.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return plain_ms


def moe_ep_rank(rank: int, world: int, seed: int, tmp: str) -> dict:
    """One rank of ``moe_ep``: every ``EP_LAYERS`` run on this rank's
    experts and data rows, held to the plain version saved in ``tmp``."""
    from repro_torch.core import op_census
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.parallel.ep import Ep
    from repro_torch.parallel.sharding import batch_spec
    warm_census()
    dev = torch.device("cuda")
    meshes, layers, out = {}, {}, {}
    for name, arch, rows_seq, shape, cf, int8 in EP_LAYERS:
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("data", "model"))
        mesh = meshes[shape]
        ep = Ep.of(mesh)
        cfg = ep_layer_cfg(arch, cf)
        E_loc = cfg.moe.n_experts_padded // ep.tp
        key = (arch, shape, ep.rank)
        if key not in layers:
            layers.clear()
            gc.collect()
            torch.cuda.empty_cache()
            layers[key] = ep_layer(cfg, seed, range(ep.rank * E_loc,
                                                    (ep.rank + 1) * E_loc),
                                   dev)
        p, bias = layers[key]
        x = ep_layer_x(cfg, rows_seq, seed, dev)[batch_spec(rows_seq[0],
                                                            mesh)]
        xt = x.reshape(-1, cfg.d_model)
        T = xt.shape[0]
        n, ntok, C_send, C_exp, sliced = moe._ep_capacity(cfg.moe, T, ep.tp)
        with torch.inference_mode():
            moe.moe_apply(cfg, p, x, bias, ep=ep, compress_a2a=int8)
            torch.cuda.synchronize()
            with op_census.census() as c:
                moe.moe_apply(cfg, p, x, bias, ep=ep, compress_a2a=int8)
            ms = cuda_ms(lambda: moe.moe_apply(cfg, p, x, bias, ep=ep,
                                               compress_a2a=int8), reps=3)
            y, load, _, keep = moe._ep_body(cfg, p, xt, bias, ep, int8,
                                            with_keep=True)
        want = torch.load(Path(tmp) / f"{name}.pt")[
            mesh.get_local_rank("data")]
        wy = want["y"][0 if sliced else ep.rank].to(dev).float()
        top = wy.abs().max().item()
        diff = (y.float() - wy).abs().max().item()
        rms = xt.float().pow(2).mean().sqrt().item()
        rec = {"layer_ms": ms, "C_send": C_send, "C_exp": C_exp,
               "kappa": xt.float().abs().max().item() / rms,
               "chunks": -(-T // n), "tokens_a_rank": ntok, "sliced": sliced,
               "dropped_share": 1.0 - keep.float().mean().item(),
               "max_abs_diff": diff, "max_abs_y": top,
               "keep_equal": torch.equal(keep.cpu(),
                                         want["keeps"][ep.rank]),
               "load_equal": torch.equal(load.cpu(), want["load"]),
               "all_to_alls": sum(col.op == "all-to-all"
                                  for col in c.collectives),
               "a2a_wire_bytes": sum(col.wire_bytes for col in c.collectives
                                     if col.op == "all-to-all"),
               "collectives": dict(collections.Counter(
                   col.op for col in c.collectives))}
        if want["one_card"] is not None:
            one = want["one_card"].to(dev).float()
            rec["one_card_max_abs_diff"] = (y.float() - one).abs().max().item()
            rec["one_card_max_abs_y"] = one.abs().max().item()
        if int8:
            rec["vs_bf16_max_abs_diff"] = (
                y.float() - out[name[:-5]]["_y"].float()).abs().max().item()
            rec["vs_bf16_max_abs_y"] = out[name[:-5]]["max_abs_y"]
            del out[name[:-5]]["_y"]
        else:
            rec["_y"] = y
        out[name] = rec
        del y, keep, load, x, xt
        torch.cuda.empty_cache()
    for rec in out.values():
        rec.pop("_y", None)
    return out


def moe_ep(seed: int) -> None:
    """Phase 42: ``moe_ep_rank`` on ``MESH_WORLD`` gloo ranks sharing the
    card, after the plain version (``moe_ep_plain_runs``). Every rank's
    routed output within ``MOE_REL`` of the plain version's max |y| (at
    capacity 8 also of the one-card body's), its keep masks and the loads
    equal, the int8 exchange within gates (2 kappa + 1) / 254 of max |y|
    of the bf16 one (``EP_INT8_HALF_STEP``); a rank's layer ms,
    all-to-alls and their wire bytes, C_send, C_exp and the dropped share
    printed."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip-smoke-moe-ep-") as tmp:
        t0 = time.perf_counter()
        plain_ms = moe_ep_plain_runs(seed, Path(tmp))
        plain_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = rank_pool().run(moe_ep_rank, seed, tmp)
        spawn_s = time.perf_counter() - t0
    for name, arch, rows_seq, shape, cf, int8 in EP_LAYERS:
        gates = ep_layer_cfg(arch, cf).moe.routed_scaling
        for r, rank in enumerate(ranks):
            rec = rank[name]
            if not rec["max_abs_diff"] <= MOE_REL * rec["max_abs_y"]:
                raise AssertionError(f"moe_ep {name} rank {r}: {rec}")
            if not (rec["keep_equal"] and rec["load_equal"]):
                raise AssertionError(f"moe_ep {name} rank {r}: keep or load "
                                     f"differ from the plain version")
            if "one_card_max_abs_diff" in rec and not (
                    rec["one_card_max_abs_diff"]
                    <= MOE_REL * rec["one_card_max_abs_y"]):
                raise AssertionError(f"moe_ep {name} rank {r}: one card "
                                     f"{rec}")
            bound = gates * (2 * rec["kappa"] + 1) * EP_INT8_HALF_STEP
            if int8 and not (rec["vs_bf16_max_abs_diff"]
                             <= bound * rec["vs_bf16_max_abs_y"]):
                raise AssertionError(f"moe_ep {name} rank {r}: int8 against "
                                     f"bf16 {rec}")
            if rec["all_to_alls"] != rec["chunks"] * (5 if int8 else 3):
                raise AssertionError(f"moe_ep {name} rank {r}: all-to-alls "
                                     f"{rec}")
        emit(phase="moe_ep", run=name, arch=arch, x=list(rows_seq),
             mesh=list(shape), capacity_factor=cf, int8=int8,
             ranks=[rank[name] for rank in ranks],
             plain_ms=plain_ms.get(name))
    emit(phase="moe_ep", world=MESH_WORLD, backend="gloo", plain_s=plain_s,
         spawn_s=spawn_s, int8_half_step=EP_INT8_HALF_STEP)


# train_ep: granite-moe cut to 2 layers, f32, on the same 4 gloo ranks,
# 8 x 512 tokens, MESH_TRAIN_STEPS steps on one batch: "sharded" on (2, 2)
# and per-tensor "replicated" on (1, 4) with the int8 exchange; granite's
# attention and vocabulary run tensor parallel beside the experts.
# deepseek-v3 at its reduced widths ("sharded" on (2, 2))
# runs its experts over ``model`` beside MLA's heads, its dense FFNs and
# its vocabulary cut over the same ranks. Its published
# widths do not fit: one MoE layer's f32 experts alone are 45 GB, and one
# rank's step must hold them all. At capacity 8 without the aux loss
# (chunks cut to EP_TRAIN_CHUNK tokens, so that capacity 8's buffers, 8x
# the mean load, fit four ranks on one card) the runs are held to one
# rank's step on the whole batch: the "sharded" runs' loss and grad norm
# within rtol 1e-6 (1e-4 after the first update), the int8 run's loss
# within INT8_LOSS_GAP; at the published 1.25 and chunks of 4,096 with the
# aux loss the losses are finite and fall
EP_TRAIN_CHUNK = 1024
GRANITE, DEEPSEEK = "granite-moe-3b-a800m", "deepseek-v3-671b"
EP_REPLICATED_INT8 = {"pod_param_mode": "replicated",
                      "hierarchical_sync": False, "bucketed_updates": False,
                      "compress_moe_a2a": True}
EP_TRAIN_RUNS = (  # name, arch, mesh shape, knobs, capacity 8
    ("sharded", GRANITE, (2, 2), {}, True),
    ("replicated_int8", GRANITE, (1, 4), EP_REPLICATED_INT8, True),
    ("sharded_aux", GRANITE, (2, 2), {}, False),
    ("replicated_int8_aux", GRANITE, (1, 4), EP_REPLICATED_INT8, False),
    ("deepseek_tp", DEEPSEEK, (2, 2), {}, True),
)


def ep_train_cfg(arch: str, cap8: bool):
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    cfg = cfg.reduced() if arch == DEEPSEEK else dataclasses.replace(
        cfg, n_layers=MESH_TRAIN_LAYERS)
    if not cap8:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0, aux_loss_coef=0.0,
        chunk_tokens=EP_TRAIN_CHUNK))


def split_param_bytes(lm, tp) -> dict:
    """This rank's parameter bytes: of the tensors ``tp`` cuts, and of the
    copies over ``model``."""
    from repro_torch.training.state import param_dims, param_shapes
    dims, shapes = param_dims(lm), param_shapes(lm)
    out = {"cut": 0, "copies": 0}
    for n, p in lm.named_parameters():
        cut = tp is not None and tp.cut_axis(shapes[n], dims[n]) is not None
        out["cut" if cut else "copies"] += p.numel() * p.element_size()
    return out


def mesh_train_runs(runs, seed: int) -> dict:
    """Every run of ``runs`` (name, cfg, mesh shape, knobs) on this rank
    of a (data, model) world: each step counted and censused, its walls
    and peaks, the state's bytes, the parameter bytes of the tensors the
    model axis cuts and of its copies, this rank's and the whole model's
    (``split_param_bytes``)."""
    from repro_torch.configs import RunConfig
    from repro_torch.launch.mesh import make_mesh, pod_size
    from repro_torch.models import model as mdl
    from repro_torch.parallel.tp import Tp
    from repro_torch.training import init_state, make_train_step
    out = {}
    for name, cfg, shape, knobs in runs:
        batch = {"tokens": torch.as_tensor(np.random.default_rng(
            seed).integers(0, cfg.vocab, (MESH_TRAIN_BATCH, MESH_TRAIN_SEQ)),
            device="cuda")}
        mesh = make_mesh(shape, ("data", "model"))
        rc = RunConfig(warmup_steps=1, steps=4, learning_rate=3e-4, **knobs)
        gc.collect()
        torch.cuda.empty_cache()
        state = init_state(cfg, rc, seed, mesh, device="cuda",
                           dtype=torch.float32)
        fn = make_train_step(cfg, rc, mesh)
        recs = []
        for i in range(MESH_TRAIN_STEPS):
            torch.cuda.reset_peak_memory_stats()
            (state, m), wall, counts, census, ops = mesh_run(
                lambda: fn(state, batch), pod_size(mesh))
            recs.append({"metrics": {k: v.item() for k, v in m.items()},
                         "host_wall_s": wall, "launches": counts,
                         "census": census, "c10d_ops": ops,
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        tp = Tp.of(mesh, cfg)
        out[name] = {"steps": recs, "state_bytes": state_bytes(state),
                     "tensors": len(state_tensors(state)),
                     "param_bytes": split_param_bytes(state["params"], tp),
                     "whole_param_bytes": split_param_bytes(mdl.LM(
                         cfg, device="meta", dtype=torch.float32), tp)}
        del state, fn
        torch.cuda.empty_cache()
    return out


def one_rank_steps(cfg, seed: int) -> list:
    """One rank's ``MESH_TRAIN_STEPS`` steps of ``cfg`` on the whole batch
    ``mesh_train_runs`` takes: the metrics."""
    from repro_torch.configs import RunConfig
    from repro_torch.training import init_state, make_train_step
    batch = {"tokens": torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (MESH_TRAIN_BATCH, MESH_TRAIN_SEQ)), device="cuda")}
    rc = RunConfig(warmup_steps=1, steps=4, learning_rate=3e-4)
    state = init_state(cfg, rc, seed, device="cuda", dtype=torch.float32)
    fn = make_train_step(cfg, rc)
    want = []
    for _ in range(MESH_TRAIN_STEPS):
        state, m = fn(state, batch)
        want.append({k: v.item() for k, v in m.items()})
    del state, fn
    torch.cuda.empty_cache()
    return want


def flash_layers(cfg, tp: int) -> int:
    """The layers whose attention reaches the flash kernel on ``tp`` model
    ranks: GQA self attention whose heads the ranks divide (MLA never;
    heads they do not divide shard the sequence, and a query block takes
    positions the kernel does not)."""
    if cfg.mla is not None or cfg.n_heads % tp:
        return 0
    return sum(k in ("attn", "local") for k in cfg.layer_kinds)


def held_mesh_train(phase: str, ranks, runs, one, launches: dict) -> None:
    """``mesh_train_runs``' records of ``runs`` (name, cfg, mesh shape,
    knobs, held): every rank's metrics equal rank 0's; flash twice an
    attention layer a step where the kernel takes the layer
    (``flash_layers``), the quantizers under ``compress_grads``; a rank's
    parameter bytes at most 1/(F tp) of the cut tensors and 1/F of the
    copies, plus one ``pad_multiple`` of f32 elements a tensor; finite
    metrics, held to one rank's steps ``one[name]`` where ``held``: the
    loss and grad norm at rtol 1e-6 (1e-4 after the update; AdamW's
    first step, near sign(g), turns gradients' rounding into lr-sized
    steps on their near-zero elements), under int8
    the loss within ``INT8_LOSS_GAP``; else the loss falls. The launches
    count toward the kernel table."""
    for name, cfg, shape, knobs, held in runs:
        F = shape[0] if knobs.get("pod_param_mode") != "replicated" else 1
        flash = 2 * flash_layers(cfg, shape[-1])
        for r, rec in enumerate(ranks):
            got = [s["metrics"] for s in rec[name]["steps"]]
            want = [s["metrics"] for s in ranks[0][name]["steps"]]
            if got != want:
                raise AssertionError(f"{phase} {name}: rank {r}'s metrics "
                                     f"{got} differ from rank 0's {want}")
            for s in rec[name]["steps"]:
                if s["launches"]["flash_attention"] != flash:
                    raise AssertionError(f"{phase} {name}: launches "
                                         f"{s['launches']}")
                if knobs.get("compress_grads") and not s["launches"][
                        "quantize"]:
                    raise AssertionError(f"{phase} {name}: no quantize "
                                         f"launch {s['launches']}")
                for k, v in s["launches"].items():
                    launches[k] += v
            pb, wb = rec[name]["param_bytes"], rec[name]["whole_param_bytes"]
            pad = 4 * MESH_WORLD * rec[name]["tensors"]
            if not (pb["cut"] <= wb["cut"] / (F * shape[1]) + pad
                    and pb["copies"] <= wb["copies"] / F + pad):
                raise AssertionError(f"{phase} {name}: rank {r} holds "
                                     f"{pb} of {wb} parameter bytes")
        mets = [s["metrics"] for s in ranks[0][name]["steps"]]
        check_finite(f"{phase} {name}", mets)
        if not held:
            if not mets[-1]["loss"] < mets[0]["loss"]:
                raise AssertionError(f"{phase} {name}: loss {mets} did not "
                                     "fall")
            continue
        lossy = knobs.get("compress_grads") or knobs.get("compress_moe_a2a")
        for i, (got, want) in enumerate(zip(mets, one[name], strict=True)):
            if lossy:
                if not abs(got["loss"] - want["loss"]) < INT8_LOSS_GAP:
                    raise AssertionError(f"{phase} {name}: loss {got} "
                                         f"against one rank's {want}")
                continue
            for k in ("loss", "grad_norm"):
                if not math.isclose(got[k], want[k],
                                    rel_tol=1e-6 if i < 2 else 1e-4):
                    raise AssertionError(f"{phase} {name}: {k} {got[k]} "
                                         f"!= one rank's {want[k]}")


def train_ep_rank(rank: int, world: int, seed: int) -> dict:
    """One rank of ``train_ep``: every ``EP_TRAIN_RUNS`` run
    (``mesh_train_runs``); rank 0 then takes one rank's steps on the whole
    batch of each arch at capacity 8."""
    warm_census()
    out = mesh_train_runs([(n, ep_train_cfg(a, c8), sh, kn)
                           for n, a, sh, kn, c8 in EP_TRAIN_RUNS], seed)
    if rank == 0:
        out["one_rank"] = {a: one_rank_steps(ep_train_cfg(a, True), seed)
                           for a in dict.fromkeys(
                               a for _, a, _, _, c8 in EP_TRAIN_RUNS if c8)}
    return out


def train_ep(seed: int, launches: dict) -> None:
    """Phase 43: ``train_ep_rank`` on ``MESH_WORLD`` gloo ranks sharing the
    card, held by ``held_mesh_train``: granite and deepseek tensor
    parallel beside their experts, the capacity-8 runs held to one rank's
    step, the 1.25 runs' losses finite and falling. Then
    ``train_ep_cards``."""
    t0 = time.perf_counter()
    ranks = rank_pool().run(train_ep_rank, seed)
    spawn_s = time.perf_counter() - t0
    held_mesh_train("train_ep", ranks, [
        (n, ep_train_cfg(a, c8), sh, kn, c8)
        for n, a, sh, kn, c8 in EP_TRAIN_RUNS],
        {n: ranks[0]["one_rank"][a] for n, a, _, _, c8 in EP_TRAIN_RUNS
         if c8}, launches)
    emit(phase="train_ep", world=MESH_WORLD, backend="gloo",
         runs={n: {"arch": a, "mesh": list(sh), "layers": ep_train_cfg(
             a, c8).n_layers, "reduced_widths": a == DEEPSEEK}
             for n, a, sh, _, c8 in EP_TRAIN_RUNS},
         dtype="float32", batch=MESH_TRAIN_BATCH, seq=MESH_TRAIN_SEQ,
         capacity8_chunk_tokens=EP_TRAIN_CHUNK, spawn_s=spawn_s,
         one_rank=ranks[0]["one_rank"],
         ranks=[{n[0]: r[n[0]] for n in EP_TRAIN_RUNS} for r in ranks])
    train_ep_cards(seed)


def train_ep_cards(seed: int) -> None:
    """``train_ep``'s multi-card run: ``train_fsdp_cards_rank`` on (2, 2)
    data x model over NCCL on ``FSDP_CARDS`` cards, one a rank: granite at
    32 layers, bf16, bucketed AdamW, the experts over the model ranks and
    (since tensor parallelism is ported) its attention and vocabulary
    cut over them too; finite metrics, the loss down by the third step,
    each card's state and peak, tokens/s, the step beside the same run
    with the dense layers copies over ``model`` and FSDP's on (4,). On fewer
    cards one line says why it did not run."""
    import tempfile
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import spawn_world

    cards = torch.cuda.device_count()
    if cards < FSDP_CARDS:
        emit(phase="train_ep_cards", skipped=f"{cards} card(s): granite-moe "
             "at 32 layers with its AdamW state is a model no card holds; "
             "(2, 2) data x model over NCCL, one card a rank, needs "
             f"{FSDP_CARDS}")
        return
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ep-cards-") as tmp:
        t0 = time.perf_counter()
        ranks = spawn_world(train_fsdp_cards_rank, FSDP_CARDS, seed,
                            get_arch("granite-moe-3b-a800m").n_layers,
                            FSDP_CARDS_BATCH, FSDP_CARDS_SEQ, "cuda", (2, 2),
                            ("data", "model"), backend="nccl",
                            init_file=str(Path(tmp) / "store"),
                            timeout_s=900)
        spawn_s = time.perf_counter() - t0
    losses = [m["loss"] for m in ranks[0]["metrics"]]
    check_finite("train_ep_cards", ranks[0]["metrics"])
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train_ep_cards: loss {losses} did not fall")
    step_s = statistics.median(ranks[0]["step_walls_s"][1:])
    emit(phase="train_ep_cards", world=FSDP_CARDS, backend="nccl",
         mesh=[2, 2], arch="granite-moe-3b-a800m",
         layers=get_arch("granite-moe-3b-a800m").n_layers, dtype="bfloat16",
         batch=FSDP_CARDS_BATCH, seq=FSDP_CARDS_SEQ, spawn_s=spawn_s,
         losses=losses, ranks=ranks, step_s=step_s,
         tokens_per_s=FSDP_CARDS_BATCH * FSDP_CARDS_SEQ / step_s,
         peak_gb_by_card=[r["peak_gb"] for r in ranks],
         state_gb_by_card=[r["state_bytes"] / 1e9 for r in ranks],
         ep_dense_copies=EP_COPIES_CARDS, fsdp=FSDP_CARDS_RUN,
         x_ep_dense_copies=step_s / EP_COPIES_CARDS["step_s"],
         x_fsdp=step_s / FSDP_CARDS_RUN["step_s"])


# ---------------------------------------------------------------------------
# 44-45. tensor parallelism over the model axis
# ---------------------------------------------------------------------------

# train_tp: TinyLlama cut to MESH_TRAIN_LAYERS layers in f32 on MESH_WORLD
# gloo ranks on the card, tensor parallel over ``model`` (its 32 heads and
# 4 KV heads, 5,632 hidden units and 32,000 vocabulary rows cut; 8/1 heads a
# rank on (1, 4), 16/2 on (2, 2)): "sharded" on (1, 4) and (2, 2) (FSDP over
# the 2 data ranks), and "replicated" with the explicit sync
# (``hierarchical_sync`` and ``compress_grads``: int8 with error feedback,
# ``ef_compress`` through the quantize kernels) on (2, 2). mamba2-1.3b cut
# to MESH_TRAIN_LAYERS layers (64 SSD heads, 16 a rank on (1, 4), 32 on
# (2, 2)) and recurrentgemma-2b cut to one (rglru, rglru, local) unit (its
# 2,560 RG-LRU channels 1,280 a rank on (2, 2), its 10 local heads 5; on
# (1, 4) 640 channels a rank, straddling the 256-channel gate blocks, and
# the local attention sharding the sequence), "sharded", at published
# widths. Each held to one rank's step on the whole batch: loss and grad
# norm within rtol 1e-6 (1e-4 after the update), the int8 run's loss within
# INT8_LOSS_GAP. granite's and deepseek-v3's tensor-parallel train steps
# are ``train_ep``'s.
MAMBA, RGEMMA = "mamba2-1.3b", "recurrentgemma-2b"
TP_TRAIN_RUNS = (  # name, arch, mesh shape, knobs
    ("tinyllama_1x4", TRAIN_ARCH, (1, 4), {}),
    ("tinyllama_2x2", TRAIN_ARCH, (2, 2), {}),
    ("tinyllama_2x2_explicit_int8", TRAIN_ARCH, (2, 2),
     {"pod_param_mode": "replicated", "compress_grads": True}),
    ("mamba2_1x4", MAMBA, (1, 4), {}),
    ("mamba2_2x2", MAMBA, (2, 2), {}),
    ("recurrentgemma_2x2", RGEMMA, (2, 2), {}),
    ("recurrentgemma_1x4", RGEMMA, (1, 4), {}),
)
# serve_tp: TinyLlama at its published widths and depth in f32 (every
# rank's tokens are held equal to one rank's, which bf16's partial sums
# would not promise), ServeEngine over TP_SERVE_RANKS gloo ranks of the one
# card on (1, 2): TP_SERVE_REQUESTS requests, TP_SERVE_SLOTS slots, 16 new
# tokens, max_len 128; and make_prefill_step over TP_PREFILL (B, S). On 4
# cards the same in bf16 over NCCL on (1, 4), one card a rank.
TP_SERVE_RANKS, TP_SERVE_REQUESTS, TP_SERVE_SLOTS = 2, 4, 4
TP_PREFILL = (2, 1024)
# serve_tp's other families at published widths and depths, f32 weights and
# caches, on the same (1, 2): mamba2 (64 SSD heads, 32 a rank) and
# recurrentgemma (2,560 RG-LRU channels, 1,280 a rank; its 8 local layers'
# 10 heads 5 a rank, so each prefill launches flash on them). On 4 cards
# serve_tp_cards adds recurrentgemma (its local attention sharding the
# prompt) and deepseek-v3 cut to FAMILY_LAYERS in bf16 on (1, 4).
SERVE_TP_FAMILIES = (MAMBA, RGEMMA, "internvl2-2b")
# serve_tp's weights over the data axes: TinyLlama at 22 layers in f32 on
# (2, 2) over 4 gloo ranks of the card, its weights FSDP-sharded over the 2
# data ranks ("sharded") and whole over them ("replicated"): a prefill of
# TP_PREFILL (a row a data rank) and SERVE_FSDP_DECODE greedy decode steps
SERVE_FSDP_MESH, SERVE_FSDP_DECODE = (2, 2), 8
SERVE_FSDP_MODES = ("sharded", "replicated")
# serve_fsdp_cards: the same on 4 cards over NCCL, beside internvl2-2b (24
# layers) and recurrentgemma-2b (26) at their published widths, "sharded",
# and the cache cut over model that each config takes
SERVE_FSDP_CARDS = ((LM_ARCH, SERVE_FSDP_MODES),
                    ("internvl2-2b", ("sharded",)), (RGEMMA, ("sharded",)))
SERVE_FSDP_CUTS = {LM_ARCH: "kv_heads", "internvl2-2b": "seq",
                   RGEMMA: "head_dim"}
# cli_cards: the train CLI's argv beside --mesh 2x2 (TinyLlama cut to 4
# layers at published widths, the CLI's bf16, batch 8 x 128), its crash
# step, and where the restart resumes (the last checkpoint before it); the
# restarted losses against the whole run's at PERF.md's resume bound, the
# first loss against one card's within bf16's partial-sum rounding
CLI_TRAIN = ["--layers", "4", "--steps", "6", "--ckpt-every", "2"]
CLI_FAIL_AT, CLI_RESUMED_AT = 3, 2
RESUME_ATOL, CLI_FIRST_LOSS_REL = 1e-4, 1e-2
# granite at 32 layers, bf16, on 4 x H100 (NVIDIA H100 80GB HBM3, 700 W)
# before tensor parallelism: on (2, 2) with the experts over model and the
# dense layers copies, and FSDP on (4,): step seconds, state GB a card
EP_COPIES_CARDS = {"step_s": 1.200, "state_gb": 10.46}
FSDP_CARDS_RUN = {"step_s": 0.8576, "state_gb": 9.76}


def tp_train_cfg(arch: str = TRAIN_ARCH):
    """``arch`` at published widths cut to ``MESH_TRAIN_LAYERS`` layers, or
    to one unit of its pattern where that is longer."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    return dataclasses.replace(cfg, n_layers=max(MESH_TRAIN_LAYERS,
                                                 len(cfg.pattern)))


def local_flash_checks(dev) -> list:
    """The flash kernel on the local heads the TP ranks hand it (TinyLlama
    8/1 on 4 model ranks and 16/2 on 2, granite 12/4 on 2 and 6/2 on 4,
    recurrentgemma 5/1 at head dim 256 on 2 under its local window of
    2,048: at the train phases' rows and sequence, at ``serve_tp``'s
    prefill (``TP_PREFILL``) and over 4,096 positions, past the window so
    that its mask cuts keys), f32, against ``attention_ref`` within
    ``FLASH_TOL``; uncounted."""
    from repro_torch.kernels.flash_attention import kernel as fk
    out = []
    g = torch.Generator(device=dev).manual_seed(7)
    train = (2, MESH_TRAIN_SEQ)
    for arch, (B, S), H, Kv, dh, window in (
            ("tinyllama-1.1b", train, 8, 1, 64, 0),
            ("tinyllama-1.1b", train, 16, 2, 64, 0),
            ("granite-moe-3b-a800m", train, 12, 4, 64, 0),
            ("granite-moe-3b-a800m", train, 6, 2, 64, 0),
            (RGEMMA, train, 5, 1, 256, 2048),
            (RGEMMA, TP_PREFILL, 5, 1, 256, 2048),
            (RGEMMA, (1, 4096), 5, 1, 256, 2048)):
        q = torch.randn(B, S, H, dh, generator=g, device=dev)
        k = torch.randn(B, S, Kv, dh, generator=g, device=dev)
        v = torch.randn(B, S, Kv, dh, generator=g, device=dev)
        if not fk.supports(q, k, v):
            raise AssertionError(f"flash does not take {arch}'s local heads "
                                 f"{H}/{Kv}")
        err, top = flash_err(q, k, v, causal=True, window=window)
        out.append({"arch": arch, "shape": [B, S, H, dh], "heads": H,
                    "kv_heads": Kv, "G": H // Kv, "head_dim": dh,
                    "window": window, "max_abs_err": err, "max_abs_out": top})
    return out


def train_tp_rank(rank: int, world: int, seed: int) -> dict:
    """One rank of ``train_tp``: every ``TP_TRAIN_RUNS`` run
    (``mesh_train_runs``); rank 0 then takes one rank's steps on the whole
    batch of each arch and checks the flash kernel on the local head
    counts."""
    warm_census()
    out = mesh_train_runs([(n, tp_train_cfg(a), sh, kn)
                           for n, a, sh, kn in TP_TRAIN_RUNS], seed)
    if rank == 0:
        out["one_rank"] = {a: one_rank_steps(tp_train_cfg(a), seed)
                           for a in dict.fromkeys(
                               a for _, a, _, _ in TP_TRAIN_RUNS)}
        out["local_flash"] = local_flash_checks(torch.device("cuda"))
    return out


def train_tp(seed: int, launches: dict) -> None:
    """Phase 44: ``train_tp_rank`` on ``MESH_WORLD`` gloo ranks sharing the
    card, held by ``held_mesh_train`` (the copies over ``model`` stay
    equal under int8 too; flash on every rank's local heads, the
    quantizers under ``compress_grads``)."""
    t0 = time.perf_counter()
    ranks = rank_pool().run(train_tp_rank, seed)
    spawn_s = time.perf_counter() - t0
    one = ranks[0]["one_rank"]
    held_mesh_train("train_tp", ranks, [(n, tp_train_cfg(a), sh, kn, True)
                                        for n, a, sh, kn in TP_TRAIN_RUNS],
                    {n: one[a] for n, a, _, _ in TP_TRAIN_RUNS}, launches)

    def rel(got, want):     # by step: the loss's and grad norm's larger
        return [max(abs(g[k] - w[k]) / abs(w[k]) for k in ("loss",
                                                           "grad_norm"))
                for g, w in zip(got, want)]
    by_step = {n: rel([s["metrics"] for s in ranks[0][n]["steps"]], one[a])
               for n, a, _, _ in TP_TRAIN_RUNS}
    worst = {n: max(v) for n, v in by_step.items()}
    emit(phase="train_tp", world=MESH_WORLD, backend="gloo",
         runs={n: {"arch": a, "mesh": list(sh),
                   "layers": tp_train_cfg(a).n_layers}
               for n, a, sh, _ in TP_TRAIN_RUNS},
         dtype="float32", batch=MESH_TRAIN_BATCH, seq=MESH_TRAIN_SEQ,
         spawn_s=spawn_s, one_rank=one, max_rel_vs_one_rank=worst,
         rel_vs_one_rank_by_step=by_step,
         local_flash=ranks[0]["local_flash"],
         ranks=[{n[0]: r[n[0]] for n in TP_TRAIN_RUNS} for r in ranks])


def serve_requests(cfg, n: int) -> list:
    from repro_torch.serving import Request
    rng = np.random.default_rng(11)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=int(
        rng.integers(4, 12))).tolist(), max_new=16) for i in range(n)]


def timed(fn):
    """``fn()`` between two synchronizes, every launch count set to 0 just
    before and read just after, outside the census (whose dispatch mode
    costs each operator time). -> (result, wall, launch counts)."""
    from repro_torch.kernels import reset_launch_counts
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_launches()


def serve_tp_run(cfg, lm, mesh, dev, prefill_toks, caches,
                 routes: bool = False) -> dict:
    """The serving engine and one prefill on ``mesh`` (None: one rank):
    for each cache dtype of ``caches`` (``ServeEngine``'s ``cache_dtype``;
    None: its default bf16, as the reference's) an engine's every step's
    whole logits, the tokens, decode ms a step and its launches, timed
    outside the census, under ``"engines"`` by the dtype's name; the
    prefill's wall (one uncounted warm-up first) and its launches; the
    census of one more prefill and of one decode step (at position 0,
    before the engine's run overwrites it); with ``routes`` the expert ids
    of each dispatch chunk of one more prefill, in call order
    (``prefill_routes``), and of each engine step (its ``routes``)."""
    from repro_torch.configs import RunConfig
    from repro_torch.core import op_census
    from repro_torch.serving import ServeEngine, make_prefill_step
    rc = RunConfig()
    S = prefill_toks.shape[1]
    pre = make_prefill_step(cfg, rc, S, device=dev if mesh is None else None,
                            mesh=mesh)
    pre(lm, {"tokens": prefill_toks})
    (_, last), pre_wall, pre_counts = timed(
        lambda: pre(lm, {"tokens": prefill_toks}))
    _, _, _, pre_census, _ = mesh_run(
        lambda: pre(lm, {"tokens": prefill_toks}))
    out = {"prefill_s": pre_wall, "prefill_launches": pre_counts,
           "prefill_census": pre_census,
           "prefill_last": last.float().cpu().numpy(), "engines": {}}
    if routes:
        from test_torch_cases import recorded_routing
        with recorded_routing() as calls:
            pre(lm, {"tokens": prefill_toks})
        out["prefill_routes"] = [ids.cpu().numpy() for ids in calls]
    for cache_dtype in caches:
        eng = ServeEngine(cfg, rc, lm, slots=TP_SERVE_SLOTS, max_len=128,
                          device=dev if mesh is None else None, mesh=mesh,
                          cache_dtype=cache_dtype)
        if "decode_step_census" not in out:
            with op_census.census() as c:
                eng.decode(eng.params, eng.cache,
                           np.zeros((TP_SERVE_SLOTS, 1), np.int64), 0)
            dec_census = op_census.collective_summary(c)
            dec_census["n_by_op"] = dict(collections.Counter(
                col.op for col in c.collectives))
            out["decode_step_census"] = dec_census
        logits, step_routes = [], []
        step = eng.decode

        def rec(*a, step=step, logits=logits):
            if not routes:
                o, cache = step(*a)
            else:
                from test_torch_cases import recorded_routing
                with recorded_routing() as calls:
                    o, cache = step(*a)
                step_routes.append([ids.cpu().numpy() for ids in calls])
            logits.append(o.float())
            return o, cache
        eng.decode = rec
        reqs = serve_requests(cfg, TP_SERVE_REQUESTS)
        for r in reqs:
            eng.submit(r)
        steps, wall, counts = timed(lambda: eng.run(max_steps=127))
        out["engines"][str(cache_dtype or torch.bfloat16)] = {
            "steps": steps, "outs": [r.out for r in reqs],
            "cache_gb": cache_gb(eng.cache),
            "done": sum(r.done for r in reqs),
            "logits": torch.stack(logits).cpu().numpy(),
            "decode_ms": 1e3 * wall / max(steps, 1),
            "decode_launches": counts, "routes": step_routes}
        del eng
    return out


def serve_cfg(arch: str):
    """``arch`` at published widths, deepseek-v3 cut to
    ``FAMILY_LAYERS``."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    if arch in FAMILY_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=FAMILY_LAYERS[arch])
    return cfg


def serve_tp_rank(rank: int, world: int, seed: int, dtype_name: str,
                  caches, device_type: str = "cuda",
                  arch: str = LM_ARCH, routes: bool = False) -> dict:
    """One rank of ``serve_tp``: ``arch`` (``serve_cfg``; TinyLlama by
    default) at full width, this rank's part drawn from
    ``seed``, served on (1, world) with each cache dtype of ``caches``
    (``serve_tp_run``)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as mdl
    from repro_torch.parallel.tp import Tp
    cfg = serve_cfg(arch)
    mesh = make_mesh((1, world), ("data", "model"), device_type=device_type)
    warm_census()
    dev = torch.device("cuda", torch.cuda.current_device())
    lm = mdl.init(cfg, seed, device=dev, dtype=getattr(torch, dtype_name),
                  part=Tp.of(mesh, cfg))
    toks = torch.as_tensor(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, TP_PREFILL), device=dev)
    out = serve_tp_run(cfg, lm, mesh, dev, toks, caches, routes)
    out["param_gb"] = param_gb(lm)
    out["rank"] = rank
    return out


def held_serving(what: str, got: dict, want: dict, rel: float,
                 cache: str, alike=None) -> dict:
    """``got``'s engine with the ``cache`` dtype's cache against one
    rank's ``want`` (``serve_tp_run``'s records): the same steps, the
    tokens equal (or, in bf16, equal until a step whose one-rank top-2
    margin is within twice the logits' difference there: a near tie that
    rounding may flip, after which the runs part), every step's logits up
    to there within ``rel`` of max |logit|, the prefill's last logits too.
    ``alike`` (a MoE's ``routed_alike_rows``: [steps, slots] and [B] bool)
    keeps the rows the two runs routed alike; one must be left. -> the
    figures."""
    pre_got, pre_want = got["prefill_last"], want["prefill_last"]
    got, want = got["engines"][cache], want["engines"][cache]
    n = min(len(got["logits"]), len(want["logits"]))
    lg = torch.as_tensor(got["logits"][:n])
    lw = torch.as_tensor(want["logits"][:n])
    top = lw.abs().max().item()
    by_row = (lg - lw).abs().amax(dim=-1)                 # [steps, slots]
    diff = by_row.amax(dim=-1)                            # by step
    tok_g, tok_w = lg.argmax(-1), lw.argmax(-1)
    top2 = lw.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).amin(dim=-1)
    parted = None
    for i in range(n):
        if not torch.equal(tok_g[i], tok_w[i]):
            if margin[i].item() > 2 * diff[i].item():
                raise AssertionError(f"{what}: step {i} tokens differ with "
                                     f"a margin {margin[i].item()} past "
                                     f"twice the diff {diff[i].item()}")
            parted = i
            break
    upto = n if parted is None else parted + 1
    rows = torch.ones_like(by_row[:upto], dtype=torch.bool)
    pre_rows, out = slice(None), {}
    if alike is not None:
        rows, pre_rows = torch.as_tensor(alike[0][:upto]), alike[1]
        if not rows.any() or not pre_rows.any():
            raise AssertionError(f"{what}: no row routed alike")
        out = {"rows_held": int(rows.sum()),
               "rows_excluded_routing": int((~rows).sum()),
               "prefill_rows_held": int(pre_rows.sum())}
    err = by_row[:upto][rows].max().item()
    if not err <= rel * top:
        raise AssertionError(f"{what}: logits {err} beyond {rel} of {top}")
    pre_got, pre_want = pre_got[pre_rows], pre_want[pre_rows]
    perr = float(np.abs(pre_got - pre_want).max())
    if not perr <= rel * float(np.abs(pre_want).max()):
        raise AssertionError(f"{what}: prefill logits {perr}")
    if parted is None and (got["outs"] != want["outs"]
                           or got["steps"] != want["steps"]):
        raise AssertionError(f"{what}: tokens differ from one rank's")
    return {"max_abs_logit_err": err, "max_abs_logit": top,
            "prefill_max_abs_err": perr, "parted_at_step": parted, **out}


def engine_gap(a: dict, b: dict) -> float:
    """Max |logit| difference between two engines' records
    (``serve_tp_run``'s ``engines`` entries) over the steps before their
    tokens first part: for one rank's engine with the default bf16 cache
    and with the f32 cache, what the bf16 cache's rounding alone moves."""
    a, b = torch.as_tensor(a["logits"]), torch.as_tensor(b["logits"])
    n = min(len(a), len(b))
    same = (a[:n].argmax(-1) == b[:n].argmax(-1)).all(-1)
    upto = n if bool(same.all()) else int((~same).nonzero()[0]) + 1
    return (a[:upto] - b[:upto]).abs().max().item()


def serve_tp(seed: int, launches: dict) -> None:
    """Phase 45: TinyLlama's ``ServeEngine`` at full width in f32 on
    ``TP_SERVE_RANKS`` gloo ranks of the card, (1, 2): one rank's engine
    first in this process. With f32 caches every rank's tokens and step
    count equal one rank's, its logits within ``FAMILY_REL`` (f32) of max
    |logit|, all requests done; with the engine's default bf16 cache (what
    a user gets) held as ``serve_tp_cards`` holds bf16 (the near-tie rule,
    bf16's ``FAMILY_REL``), beside what the bf16 cache alone moves one
    rank's logits (``engine_gap``). The prefill's flash launches on
    every rank (one a layer, its local 16/2 heads) and none in decode;
    prefill seconds and decode ms beside one rank's. Then
    ``serve_tp_family`` for each of ``SERVE_TP_FAMILIES``, then
    ``serve_tp_cards``, ``serve_fsdp_cards`` and ``cli_cards`` (4 cards
    each). One rank's runs of every arch go first here, then
    one world of the ranks serves them all in turn (``serve_tp_ranks``).
    The launches count toward the kernel table."""
    import tempfile
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import spawn_world
    cfg = get_arch(LM_ARCH)
    warm_census()
    ones = {arch: serve_tp_one(arch, seed, (torch.float32, None)
                               if arch == LM_ARCH else (torch.float32,))
            for arch in (LM_ARCH, *SERVE_TP_FAMILIES)}
    one = ones[LM_ARCH]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-serve-tp-") as tmp:
        t0 = time.perf_counter()
        worlds = spawn_world(serve_tp_ranks, TP_SERVE_RANKS, seed,
                             init_file=str(Path(tmp) / "store"),
                             timeout_s=900)
        spawn_s = time.perf_counter() - t0
    ranks = [w[LM_ARCH] for w in worlds]
    held = []
    for r in ranks:
        f32 = held_serving(f"serve_tp rank {r['rank']}", r, one,
                           FAMILY_REL[torch.float32], "torch.float32")
        if f32["parted_at_step"] is not None:
            raise AssertionError(f"serve_tp: rank {r['rank']}'s tokens "
                                 f"part from one rank's: {f32}")
        bf16 = held_serving(f"serve_tp rank {r['rank']} bf16 cache", r, one,
                            FAMILY_REL[torch.bfloat16], "torch.bfloat16")
        held.append({"f32_cache": f32, "bf16_cache": bf16})
        engines = r["engines"].values()
        if any(e["done"] != TP_SERVE_REQUESTS for e in engines):
            raise AssertionError("serve_tp: not every request done")
        decode = [e["decode_launches"] for e in engines]
        if r["prefill_launches"]["flash_attention"] != cfg.n_layers or any(
                v for d in decode for v in d.values()):
            raise AssertionError(f"serve_tp: launches prefill "
                                 f"{r['prefill_launches']}, decode {decode}")
        for k, v in r["prefill_launches"].items():
            launches[k] += v
    emit(phase="serve_tp", world=TP_SERVE_RANKS, backend="gloo",
         mesh=[1, TP_SERVE_RANKS], arch=LM_ARCH, layers=cfg.n_layers,
         dtype="float32", slots=TP_SERVE_SLOTS, requests=TP_SERVE_REQUESTS,
         prefill=list(TP_PREFILL), spawn_s=spawn_s,
         steps=one["engines"]["torch.float32"]["steps"],
         one_rank_bf16_cache_spread=engine_gap(*(
             one["engines"][c] for c in ("torch.bfloat16", "torch.float32"))),
         one_rank={"decode_ms": {c: e["decode_ms"] for c, e in
                                 one["engines"].items()},
                   "prefill_s": one["prefill_s"]},
         ranks=[{"decode_ms": {c: e["decode_ms"] for c, e in
                               r["engines"].items()},
                 "cache_gb": {c: e["cache_gb"] for c, e in
                              r["engines"].items()},
                 "prefill_s": r["prefill_s"], "param_gb": r["param_gb"],
                 "prefill_launches": r["prefill_launches"],
                 "prefill_census": r["prefill_census"],
                 "decode_step_census": r["decode_step_census"], **h}
                for r, h in zip(ranks, held)])
    serve_tp_fsdp(seed, launches)
    for arch in SERVE_TP_FAMILIES:
        serve_tp_family(arch, ones[arch], [w[arch] for w in worlds],
                        spawn_s, launches)
    serve_tp_cards(seed)
    serve_fsdp_cards(seed, launches)
    cli_cards(seed)


def serve_tp_one(arch: str, seed: int, caches) -> dict:
    """One rank's ``serve_tp_run`` of ``arch`` (``serve_cfg``) in f32
    here, with its parameter bytes and wall; the model freed after."""
    from repro_torch.models import model as mdl
    cfg = serve_cfg(arch)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lm = mdl.init(cfg, seed, device=dev, dtype=torch.float32)
    toks = torch.as_tensor(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, TP_PREFILL), device=dev)
    one = serve_tp_run(cfg, lm, None, dev, toks, caches)
    one["param_gb"] = param_gb(lm)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    one["wall_s"] = time.perf_counter() - t0
    return one


def serve_tp_ranks(rank: int, world: int, seed: int) -> dict:
    """One rank of ``serve_tp``'s one world of ``TP_SERVE_RANKS``:
    TinyLlama with f32 and the default bf16 cache, then each of
    ``SERVE_TP_FAMILIES`` with f32 caches (``serve_tp_rank``), by arch."""
    out = {LM_ARCH: serve_tp_rank(rank, world, seed, "float32",
                                  (torch.float32, None))}
    for arch in SERVE_TP_FAMILIES:
        gc.collect()
        torch.cuda.empty_cache()
        out[arch] = serve_tp_rank(rank, world, seed, "float32",
                                  (torch.float32,), "cuda", arch)
    return out


def cache_gb(cache) -> float:
    return sum(t.numel() * t.element_size() for layer in cache
               for d in layer.values() for t in d.values()) / 1e9


def prefill_decode_run(cfg, lm, mesh, dev, toks, rc) -> dict:
    """A prefill of ``toks`` then ``SERVE_FSDP_DECODE`` greedy decode steps
    through ``make_prefill_step``/``make_decode_step`` on ``mesh`` (None:
    one rank), after an uncounted warm-up prefill and one decode step on
    its own cache (a first step loads its kernels: hundreds of ms): the
    prefill's last logits and each step's (whole), the tokens, the
    prefill's wall and launches, decode ms a step and the steps' launches
    (``timed``), the rank's cache bytes and the collectives of one decode
    step."""
    from repro_torch.core import op_census
    from repro_torch.serving import make_decode_step, make_prefill_step
    S = toks.shape[1]
    on = dev if mesh is None else None
    pre = make_prefill_step(cfg, rc, S + SERVE_FSDP_DECODE, device=on,
                            mesh=mesh)
    dec = make_decode_step(cfg, rc, device=on, mesh=mesh)
    warm, last = pre(lm, {"tokens": toks})
    dec(lm, warm, last.argmax(-1, keepdim=True), S)
    del warm
    (cache, last), pre_s, pre_counts = timed(
        lambda: pre(lm, {"tokens": toks}))

    def steps(cache, last):
        out = [last]
        for i in range(SERVE_FSDP_DECODE):
            logits, cache = dec(lm, cache, out[-1].argmax(-1, keepdim=True),
                                S + i)
            out.append(logits)
        return out
    logits, dec_s, dec_counts = timed(lambda: steps(cache, last))
    with op_census.census() as c:
        dec(lm, cache, last.argmax(-1, keepdim=True), S)
    return {"logits": torch.stack(logits).float().cpu().numpy(),
            "tokens": [x.argmax(-1).tolist() for x in logits],
            "prefill_s": pre_s, "prefill_launches": pre_counts,
            "decode_ms": 1e3 * dec_s / SERVE_FSDP_DECODE,
            "decode_launches": dec_counts, "cache_gb": cache_gb(cache),
            "decode_collectives": dict(collections.Counter(
                x.op for x in c.collectives))}


def serve_fsdp_modes(arch: str, mesh, seed: int, modes) -> dict:
    """``arch`` (``serve_cfg``) drawn from ``seed`` in f32 in this rank's
    part under each of ``modes`` on ``mesh`` (``serving.rank_part``),
    through ``prefill_decode_run`` on this rank's card, with its parameter
    bytes, by mode; each model freed after its run."""
    from repro_torch.configs import RunConfig
    from repro_torch.models import model as mdl
    from repro_torch.serving import rank_part
    cfg = serve_cfg(arch)
    dev = torch.device("cuda", torch.cuda.current_device())
    toks = torch.as_tensor(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, TP_PREFILL), device=dev)
    out = {}
    for mode in modes:
        rc = RunConfig(pod_param_mode=mode)
        lm = mdl.init(cfg, seed, device=dev, dtype=torch.float32,
                      part=rank_part(cfg, mesh, rc))
        out[mode] = prefill_decode_run(cfg, lm, mesh, dev, toks, rc)
        out[mode]["param_gb"] = param_gb(lm)
        del lm
        gc.collect()
        torch.cuda.empty_cache()
    return out


def serve_fsdp_rank(rank: int, world: int, seed: int) -> dict:
    """One rank of ``serve_tp_fsdp``: TinyLlama under each of
    ``SERVE_FSDP_MODES`` on ``SERVE_FSDP_MESH`` (``serve_fsdp_modes``)."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(SERVE_FSDP_MESH, ("data", "model"), device_type="cuda")
    warm_census()
    return {"rank": rank, **serve_fsdp_modes(LM_ARCH, mesh, seed,
                                             SERVE_FSDP_MODES)}


def serve_fsdp_one(arch: str, seed: int) -> dict:
    """One card's ``prefill_decode_run`` of ``arch`` (``serve_cfg``) in f32
    here, with its parameter bytes; the model freed after."""
    from repro_torch.configs import RunConfig
    from repro_torch.models import model as mdl
    cfg = serve_cfg(arch)
    dev = torch.device("cuda", 0)
    lm = mdl.init(cfg, seed, device=dev, dtype=torch.float32)
    toks = torch.as_tensor(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, TP_PREFILL), device=dev)
    one = prefill_decode_run(cfg, lm, None, dev, toks, RunConfig())
    one["param_gb"] = param_gb(lm)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    return one


def held_fsdp(what: str, got: dict, one: dict, flash: int,
              launches: dict) -> dict:
    """A rank's ``prefill_decode_run`` record against one card's: the same
    tokens, whole logits within ``FAMILY_REL`` (f32) of max |logit|,
    ``flash`` launches a prefill and none in decode; its prefill launches
    count toward the kernel table. -> the figures."""
    top = float(np.abs(one["logits"]).max())
    err = float(np.abs(got["logits"] - one["logits"]).max())
    if got["tokens"] != one["tokens"]:
        raise AssertionError(f"{what}: tokens differ from one rank's")
    if not err <= FAMILY_REL[torch.float32] * top:
        raise AssertionError(f"{what}: logits {err} of {top}")
    if got["prefill_launches"]["flash_attention"] != flash \
            or any(got["decode_launches"].values()):
        raise AssertionError(f"{what}: launches prefill "
                             f"{got['prefill_launches']}, decode "
                             f"{got['decode_launches']}")
    for k, v in got["prefill_launches"].items():
        launches[k] += v
    return {"max_abs_logit_err": err, **{k: got[k] for k in (
        "param_gb", "cache_gb", "prefill_s", "decode_ms", "prefill_launches",
        "decode_collectives")}}


def serve_tp_fsdp(seed: int, launches: dict) -> None:
    """``serve_tp``'s weights over the data axes: TinyLlama at 22 layers in
    f32 on ``SERVE_FSDP_MESH`` over 4 gloo ranks of the card, under
    "sharded" (each rank a row shard of its model part over the 2 data
    ranks, each unit gathered as it runs, every decode step) and
    "replicated": every rank held to one rank's run here (``held_fsdp``);
    each rank's parameter and cache bytes, prefill seconds and decode ms
    under both modes beside one rank's. The launches count toward the
    kernel table."""
    from repro_torch.configs import get_arch
    cfg = get_arch(LM_ARCH)
    t0 = time.perf_counter()
    one = serve_fsdp_one(LM_ARCH, seed)
    t1 = time.perf_counter()
    ranks = rank_pool().run(serve_fsdp_rank, seed)
    spawn_s = time.perf_counter() - t1
    held = [{"rank": r["rank"], "mode": mode,
             **held_fsdp(f"serve_tp_fsdp {mode} rank {r['rank']}", r[mode],
                         one, cfg.n_layers, launches)}
            for r in ranks for mode in SERVE_FSDP_MODES]
    emit(phase="serve_tp_fsdp", world=math.prod(SERVE_FSDP_MESH),
         backend="gloo", mesh=list(SERVE_FSDP_MESH), arch=LM_ARCH,
         layers=cfg.n_layers, dtype="float32", prefill=list(TP_PREFILL),
         decode_steps=SERVE_FSDP_DECODE, spawn_s=spawn_s,
         wall_s=time.perf_counter() - t0,
         max_abs_logit=float(np.abs(one["logits"]).max()),
         one_rank={k: one[k] for k in ("param_gb", "cache_gb", "prefill_s",
                                      "decode_ms")},
         ranks=held)


def serve_tp_family(arch: str, one: dict, ranks: list, spawn_s: float,
                    launches: dict) -> None:
    """``arch``'s ``ServeEngine`` at its published widths and depth in f32 with f32 caches on ``TP_SERVE_RANKS``
    gloo ranks of the card, (1, 2)
    (``ranks``, from ``serve_tp``'s one world), against one rank's engine
    run first in this process (``one``; ``held_serving``: the same tokens
    and steps, logits within ``FAMILY_REL``); flash once a prefill in each
    layer it takes (``flash_layers``: recurrentgemma's local layers on 5
    of their 10 heads a rank), none in decode; prefill seconds, decode ms
    and each rank's parameter and cache bytes beside one rank's. The
    launches count toward the kernel table."""
    cfg = serve_cfg(arch)
    flash = flash_layers(cfg, TP_SERVE_RANKS)
    held = []
    for r in ranks:
        h = held_serving(f"serve_tp {arch} rank {r['rank']}", r, one,
                         FAMILY_REL[torch.float32], "torch.float32")
        if h["parted_at_step"] is not None:
            raise AssertionError(f"serve_tp {arch}: rank {r['rank']}'s "
                                 f"tokens part from one rank's: {h}")
        eng = r["engines"]["torch.float32"]
        if eng["done"] != TP_SERVE_REQUESTS:
            raise AssertionError(f"serve_tp {arch}: not every request done")
        if r["prefill_launches"]["flash_attention"] != flash or any(
                eng["decode_launches"].values()):
            raise AssertionError(f"serve_tp {arch}: launches prefill "
                                 f"{r['prefill_launches']}, decode "
                                 f"{eng['decode_launches']}")
        for k, v in r["prefill_launches"].items():
            launches[k] += v
        held.append(h)
    eng = "torch.float32"
    emit(phase=f"serve_tp_{arch.split('-')[0]}", world=TP_SERVE_RANKS,
         backend="gloo", mesh=[1, TP_SERVE_RANKS], arch=arch,
         layers=cfg.n_layers, dtype="float32", slots=TP_SERVE_SLOTS,
         requests=TP_SERVE_REQUESTS, prefill=list(TP_PREFILL),
         flash_layers=flash, spawn_s=spawn_s, one_rank_wall_s=one["wall_s"],
         steps=one["engines"][eng]["steps"],
         one_rank={"decode_ms": one["engines"][eng]["decode_ms"],
                   "prefill_s": one["prefill_s"],
                   "param_gb": one["param_gb"],
                   "cache_gb": one["engines"][eng]["cache_gb"]},
         ranks=[{"decode_ms": r["engines"][eng]["decode_ms"],
                 "prefill_s": r["prefill_s"], "param_gb": r["param_gb"],
                 "cache_gb": r["engines"][eng]["cache_gb"],
                 "prefill_launches": r["prefill_launches"],
                 "prefill_census": r["prefill_census"],
                 "decode_step_census": r["decode_step_census"], **h}
                for r, h in zip(ranks, held)])


def serve_tp_cards(seed: int) -> None:
    """``serve_tp`` on ``FSDP_CARDS`` cards: TinyLlama at 22 layers,
    recurrentgemma-2b (its local attention sharding the prompt over 4
    ranks) and deepseek-v3 cut to ``FAMILY_LAYERS``, in bf16 with the
    default bf16 cache, on (1, 4) over NCCL, one card a rank, each against
    one rank's engine here (``serve_tp_cards_arch``); prefill seconds and
    decode ms. On fewer cards one line says why it did not run."""
    cards = torch.cuda.device_count()
    if cards < FSDP_CARDS:
        emit(phase="serve_tp_cards", skipped=f"{cards} card(s): TinyLlama, "
             f"recurrentgemma and deepseek-v3 on (1, {FSDP_CARDS}) over "
             f"NCCL, one card a rank, need {FSDP_CARDS}")
        return
    for arch in (LM_ARCH, RGEMMA, DEEPSEEK):
        serve_tp_cards_arch(arch, seed)


def serve_fsdp_cards_rank(rank: int, world: int, seed: int) -> dict:
    """One rank of ``serve_fsdp_cards``: each of ``SERVE_FSDP_CARDS`` under
    its modes on ``SERVE_FSDP_MESH`` (``serve_fsdp_modes``), by arch, with
    where the model axis cuts its cache (``attention.cache_cut``)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.attention import cache_cut
    from repro_torch.parallel.tp import Tp
    mesh = make_mesh(SERVE_FSDP_MESH, ("data", "model"), device_type="cuda")
    warm_census()
    out = {"rank": rank}
    for arch, modes in SERVE_FSDP_CARDS:
        out[arch] = serve_fsdp_modes(arch, mesh, seed, modes)
        out[arch]["cache_cut"] = cache_cut(serve_cfg(arch),
                                           Tp.of(mesh, serve_cfg(arch)))
    return out


def serve_fsdp_cards(seed: int, launches: dict) -> None:
    """``serve_tp_fsdp`` on ``FSDP_CARDS`` cards over NCCL, one card a rank,
    in the reference's default serving layout: each of
    ``SERVE_FSDP_CARDS`` at its published widths and depth in f32 on
    ``SERVE_FSDP_MESH``, a row shard of each rank's model part over the 2
    data ranks ("sharded"; TinyLlama "replicated" too), its cache cut over
    ``model`` by KV heads (TinyLlama), positions (internvl2,
    ``cache_seq_shard``) or head dim (recurrentgemma's one KV head), each
    held to one card's run here (``held_fsdp``: the same tokens, logits
    within ``FAMILY_REL``, one flash launch a flash layer a prefill on
    every rank, none in decode); each rank's parameter and cache bytes,
    prefill seconds, decode ms and the collectives of one decode step
    beside one card's. The launches count toward the kernel table. On
    fewer cards one line says why it did not run."""
    import tempfile
    from repro_torch.launch.mesh import spawn_world
    cards = torch.cuda.device_count()
    if cards < FSDP_CARDS:
        emit(phase="serve_fsdp_cards", skipped=f"{cards} card(s): "
             f"TinyLlama, internvl2-2b and recurrentgemma-2b FSDP-sharded "
             f"on {SERVE_FSDP_MESH} over NCCL, one card a rank, need "
             f"{FSDP_CARDS}")
        return
    warm_census()
    t0 = time.perf_counter()
    ones = {arch: serve_fsdp_one(arch, seed) for arch, _ in SERVE_FSDP_CARDS}
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-fsdp-cards-") as tmp:
        ranks = spawn_world(serve_fsdp_cards_rank, FSDP_CARDS, seed,
                            backend="nccl",
                            init_file=str(Path(tmp) / "store"),
                            timeout_s=900)
    spawn_s = time.perf_counter() - t1
    for arch, modes in SERVE_FSDP_CARDS:
        cfg, one = serve_cfg(arch), ones[arch]
        flash = flash_layers(cfg, SERVE_FSDP_MESH[1])
        cut = ranks[0][arch]["cache_cut"]
        if cut != SERVE_FSDP_CUTS[arch]:
            raise AssertionError(f"serve_fsdp_cards {arch}: cache cut {cut}, "
                                 f"not {SERVE_FSDP_CUTS[arch]}")
        held = [{"rank": r["rank"], "mode": mode, **held_fsdp(
            f"serve_fsdp_cards {arch} {mode} rank {r['rank']}", r[arch][mode],
            one, flash, launches)} for r in ranks for mode in modes]
        emit(phase="serve_fsdp_cards" if arch == LM_ARCH else
             f"serve_fsdp_cards_{arch.split('-')[0]}", world=FSDP_CARDS,
             backend="nccl", mesh=list(SERVE_FSDP_MESH), arch=arch,
             layers=cfg.n_layers, dtype="float32", cache_cut=cut,
             prefill=list(TP_PREFILL), decode_steps=SERVE_FSDP_DECODE,
             flash_layers=flash, spawn_s=spawn_s,
             wall_s=time.perf_counter() - t0,
             max_abs_logit=float(np.abs(one["logits"]).max()),
             one_rank={k: one[k] for k in (
                 "param_gb", "cache_gb", "prefill_s", "decode_ms",
                 "decode_collectives")},
             ranks=held)


def parted_at(got: list, want: list):
    """The first new token, counted within its request, at which any of
    the requests' outputs ``got`` parts from ``want`` (None: none do)."""
    firsts = [next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                   None if len(g) == len(w) else min(len(g), len(w)))
              for g, w in zip(got, want)]
    firsts = [i for i in firsts if i is not None]
    return min(firsts) if firsts else None


def cli_cards(seed: int) -> None:
    """The two command-line entry points on ``FSDP_CARDS`` cards through
    ``main(argv)``, as a user calls them (``launch/mesh.py::run_on_mesh``
    spawns one NCCL rank a card; both must report ``nccl``):
    ``launch.serve`` with ``--mesh 2x2`` (TinyLlama, 22 layers, the CLI's
    bf16, 8 requests, 4 slots) against the same argv on one card here:
    every request done, the same decode steps; the share of tokens equal
    to one card's and the first token where a request parts are reported
    (bf16 partial sums may flip a near tie; ``serve_fsdp_cards`` holds
    the numbers in f32). ``launch.train`` with ``CLI_TRAIN`` on
    ``--mesh 2x2``, crashed at step ``CLI_FAIL_AT`` and restarted from its
    checkpoint, against the same argv uninterrupted: the losses of the
    steps both take within ``RESUME_ATOL``; the uninterrupted run's first
    loss within ``CLI_FIRST_LOSS_REL`` of one card's and its loss falling;
    the ranks' seconds and the last checkpoint's bytes. ``seed`` is the
    CLIs' own (0). On fewer cards one line says why it did not run."""
    import tempfile
    from repro_torch.launch import serve, train
    cards = torch.cuda.device_count()
    if cards < FSDP_CARDS:
        emit(phase="cli_cards", skipped=f"{cards} card(s): the serve and "
             f"train CLIs with --mesh 2x2 over NCCL, one card a rank, need "
             f"{FSDP_CARDS}")
        return
    t0 = time.perf_counter()
    backend, reqs, steps, dt = serve.main(["--mesh", "2x2"])
    mesh_s = time.perf_counter() - t0
    _, one_reqs, one_steps, one_dt = serve.main([])
    gc.collect()
    torch.cuda.empty_cache()
    got, want = [r.out for r in reqs], [r.out for r in one_reqs]
    if backend != "nccl":
        raise AssertionError(f"cli_cards: the serve CLI ran on {backend}")
    if not all(r.done for r in reqs + one_reqs) or steps != one_steps:
        raise AssertionError(f"cli_cards: serve steps {steps} against one "
                             f"card's {one_steps}, done "
                             f"{sum(r.done for r in reqs)}/{len(reqs)}")
    same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
    emit(phase="cli_cards_serve", world=FSDP_CARDS, backend=backend,
         argv=["--mesh", "2x2"], requests=len(reqs), steps=steps,
         decode_ms=1e3 * dt / steps, one_card_decode_ms=1e3 * one_dt / steps,
         cli_wall_s=mesh_s,
         tokens_equal_share=same / sum(map(len, want)),
         first_parted_token=parted_at(got, want))

    with tempfile.TemporaryDirectory(prefix="chip-smoke-cli-") as tmp:
        crashed, whole = (CLI_TRAIN + ["--ckpt", str(Path(tmp) / name)]
                          for name in ("crashed", "whole"))
        runs = {}
        for name, argv in (("crashed", crashed + ["--inject-failure-at",
                                                   str(CLI_FAIL_AT)]),
                           ("whole", whole)):
            t0 = time.perf_counter()
            runs[name] = (*train.main(["--mesh", "2x2"] + argv),
                          time.perf_counter() - t0)
        last = max((Path(tmp) / "whole").glob("step_*"))
        ckpt_bytes = dir_bytes(last)
    _, one = train.main(CLI_TRAIN)
    gc.collect()
    torch.cuda.empty_cache()
    (b1, restarted, crashed_s, crashed_wall), (b2, losses, whole_s,
                                               whole_wall) = runs.values()
    if {b1, b2} != {"nccl"}:
        raise AssertionError(f"cli_cards: the train CLI ran on {b1}, {b2}")
    # the restart runs from step CLI_RESUMED_AT on, the whole run from 0
    both = len(losses) - CLI_RESUMED_AT
    gap = max(abs(a - b) for a, b in zip(restarted[:both],
                                         losses[CLI_RESUMED_AT:]))
    first_rel = abs(losses[0] - one[0]) / abs(one[0])
    if not gap <= RESUME_ATOL:
        raise AssertionError(f"cli_cards: restarted losses {restarted} "
                             f"part from {losses} by {gap}")
    if not first_rel <= CLI_FIRST_LOSS_REL or not losses[-1] < losses[0]:
        raise AssertionError(f"cli_cards: losses {losses} against one "
                             f"card's {one}")
    emit(phase="cli_cards_train", world=FSDP_CARDS, backend=b2,
         argv=["--mesh", "2x2"] + CLI_TRAIN, fail_at=CLI_FAIL_AT,
         losses=losses, restarted_losses=restarted, one_card_losses=one,
         resumed_max_abs_gap=gap, first_loss_rel_vs_one_card=first_rel,
         main_s={"crashed": crashed_s, "whole": whole_s},
         cli_wall_s={"crashed": crashed_wall, "whole": whole_wall},
         checkpoint=last.name, checkpoint_bytes=ckpt_bytes)


def joined_routes(parts: list, want: list) -> list:
    """The model ranks' records of one pass's expert ids (``parts``, in
    rank order) as one rank's (``want``): where the ranks dispatch slices
    of a chunk (``moe._ep_capacity``), the slices joined in rank order;
    else rank 0's whole chunk."""
    return [np.concatenate([p[c] for p in parts])
            if len(parts[0][c]) < len(w) else parts[0][c]
            for c, w in enumerate(want)]


def same_experts(cfg, a: list, b: list) -> np.ndarray:
    """[MoE layers, tokens] bool: whether two records of one pass's expert
    ids (each MoE layer's dispatch chunks in order, [n, K] each) send a
    token to the same set of experts."""
    from repro_torch.models.transformer import layer_plan
    n_moe = sum(f == "moe" for _, f in layer_plan(cfg))
    a, b = (np.sort(np.concatenate(x), axis=-1).reshape(n_moe, -1,
                                                        cfg.moe.top_k)
            for x in (a, b))
    if a.shape != b.shape:
        raise AssertionError(f"routes of {a.shape} and {b.shape}")
    return (a == b).all(-1)


def routed_alike_rows(cfg, ranks: list, one: dict, cache: str) -> tuple:
    """The rows whose logits depend on no token the model ranks (their
    slices joined, ``joined_routes``) route otherwise than ``one``: in the
    engine [steps, slots], a token whose experts agree in every MoE layer;
    of the prefill [B], the sequence's last token. Where a MoE layer's
    output reaches a later layer's attention, every earlier token of the
    row must agree there too (deepseek-v3 cut to 4 layers has one MoE
    layer, the last)."""
    from repro_torch.models.transformer import layer_plan
    plan = layer_plan(cfg)
    feeds = [f == "moe" for _, f in plan[:-1]]
    runs = [r["engines"][cache]["routes"] for r in [one, *ranks]]
    rows = np.stack([same_experts(cfg, joined_routes(
        [r[i] for r in runs[1:]], runs[0][i]), runs[0][i]).all(0)
        for i in range(min(map(len, runs)))])
    want = one["prefill_routes"]
    pre = same_experts(cfg, joined_routes(
        [r["prefill_routes"] for r in ranks], want), want).all(0).reshape(
        len(one["prefill_last"]), -1)
    if any(feeds):
        rows = np.minimum.accumulate(rows, axis=0)
        return rows, pre.all(-1)
    return rows, pre[:, -1]


def routes_parted(cfg, a: list, b: list) -> float:
    """The share of the tokens whose set of experts differs, in some MoE
    layer, between two records of one prefill's expert ids."""
    return float(1.0 - same_experts(cfg, a, b).all(0).mean())


def serve_tp_cards_arch(arch: str, seed: int) -> None:
    """One arch of ``serve_tp_cards``, held by ``held_serving`` at bf16's
    ``FAMILY_REL`` and its near-tie rule. A MoE (deepseek-v3) routes each
    token to 8 of 256 experts by scores that bf16's roundings reorder, and
    a token sent to other experts takes other logits, so its rows are held
    where the ranks and one card route alike (``routed_alike_rows``).
    Beside it, what bf16 alone moves: one card's engine again with the
    weights turned f32 in place and f32 caches, its gap from the bf16
    run's logits (``engine_gap``, and the prefill's), the ranks' gap from
    it, and the share of the prefill's tokens whose experts differ between
    the ranks and one card and between one card's bf16 and f32 runs."""
    import tempfile
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.models import model as mdl
    cfg = serve_cfg(arch)
    dev = torch.device("cuda", 0)
    moe = cfg.moe is not None
    warm_census()
    t0 = time.perf_counter()
    lm = mdl.init(cfg, seed, device=dev)
    toks = torch.as_tensor(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, TP_PREFILL), device=dev)
    one = serve_tp_run(cfg, lm, None, dev, toks, (None,), routes=moe)
    one32 = None
    if moe:
        lm.float()
        torch.cuda.empty_cache()
        one32 = serve_tp_run(cfg, lm, None, dev, toks, (torch.float32,),
                             routes=True)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-serve-cards-") as tmp:
        ranks = spawn_world(serve_tp_rank, FSDP_CARDS, seed, "bfloat16",
                            (None,), "cuda", arch, moe, backend="nccl",
                            init_file=str(Path(tmp) / "store"),
                            timeout_s=900)
    eng, e32 = "torch.bfloat16", "torch.float32"
    alike, extra = None, {}
    if moe:
        def gap(a):
            return max(engine_gap(a["engines"][eng], one32["engines"][e32]),
                       float(np.abs(a["prefill_last"]
                                    - one32["prefill_last"]).max()))
        alike = routed_alike_rows(cfg, ranks, one, eng)
        want = one["prefill_routes"]
        extra = {"one_rank_bf16_vs_f32": gap(one),
                 "ranks_bf16_vs_one_rank_f32": [gap(r) for r in ranks],
                 "routes_parted_ranks_vs_one_rank": routes_parted(
                     cfg, joined_routes([r["prefill_routes"] for r in ranks],
                                        want), want),
                 "routes_parted_one_rank_bf16_vs_f32": routes_parted(
                     cfg, want, one32["prefill_routes"])}
    held = [held_serving(f"serve_tp_cards {arch} rank {r['rank']}", r, one,
                         FAMILY_REL[torch.bfloat16], eng, alike)
            for r in ranks]
    emit(phase="serve_tp_cards" if arch == LM_ARCH else
         f"serve_tp_cards_{arch.split('-')[0]}", world=FSDP_CARDS,
         backend="nccl", mesh=[1, FSDP_CARDS], arch=arch,
         layers=cfg.n_layers, wall_s=time.perf_counter() - t0,
         dtype="bfloat16", prefill=list(TP_PREFILL), **extra,
         one_rank={"decode_ms": one["engines"][eng]["decode_ms"],
                   "prefill_s": one["prefill_s"],
                   "steps": one["engines"][eng]["steps"]},
         ranks=[{"decode_ms": r["engines"][eng]["decode_ms"],
                 "prefill_s": r["prefill_s"],
                 "steps": r["engines"][eng]["steps"],
                 "param_gb": r["param_gb"],
                 "cache_gb": r["engines"][eng]["cache_gb"],
                 "prefill_census": r["prefill_census"], **h}
                for r, h in zip(ranks, held)])


# ---------------------------------------------------------------------------
# 46. the dry run: production cells on the card's spec, and held to real
# steps on the card
# ---------------------------------------------------------------------------

DRYRUN_CELLS = (  # arch, shape, mesh, mode
    ("tinyllama-1.1b", "train_4k", "single", "baseline"),
    ("tinyllama-1.1b", "prefill_32k", "single", "baseline"),
    ("tinyllama-1.1b", "decode_32k", "single", "baseline"),
    ("granite-moe-3b-a800m", "train_4k", "multi", "optimized"),
    ("mamba2-1.3b", "long_500k", "single", "baseline"),
    ("deepseek-v3-671b", "decode_32k", "single", "baseline"),
    ("musicgen-medium", "decode_32k", "single", "baseline"),
    ("deepseek-v3-671b", "prefill_32k", "single", "baseline"),
    ("deepseek-v3-671b", "train_4k", "single", "baseline"))
DRYRUN_SLOW = DRYRUN_CELLS[-1:]     # started right after the build
DRYRUN_EARLY = DRYRUN_CELLS[-2:-1]  # started before phase 44
CARD_BYTES = 80e9                   # H100 80GB HBM3
DRYRUN_TRAIN = (2, 4, 2048)         # TinyLlama layers, batch, seq (bf16)
DRYRUN_DECODE = (4, 2048)           # slots, max_len (22 layers, bf16)
DRYRUN_POS = 1024                   # the decode step's position
DRYRUN_MESH = ((2, 2), ("data", "model"))   # TinyLlama 2 layers, f32
# The tracker's peak (``op_census``: live storages, each once, and the
# card implementations' own scratch it knows of) against the caching
# allocator's ``max_memory_allocated`` less what was allocated when the
# step began (the state, the batch and, after a warm-up step, cuBLAS's
# workspace). On one card what differs is the allocator's rounding (each
# block up to 512 B) and scratch under 1 MiB an operator that the tracker
# does not model: 1%. On the gloo ranks gloo also holds a CUDA block of a
# collective's size while it completes one (the reduce-scatter's split
# and copy out, beneath the census) at moments the step's own peak may
# or may not meet: 10%, under the 20% ceiling.
DRYRUN_PEAK_REL = {"train": 0.01, "decode": 0.01, "mesh": 0.10}


def dryrun_start(cells, out: Path) -> list:
    """Start ``launch/dryrun.py`` on each cell, one process (one fake world)
    a cell, priced on this card's spec, at a lower priority than the
    phases it runs beside (their walls are measured; its are not).
    -> [(cell, process, log file)]."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for cell in cells:
        arch, shape, mesh, mode = cell
        log = open(out / f"{arch}__{shape}__{mesh}__{mode}.log", "w")
        procs.append((cell, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--mode", mode,
             "--out", str(out), "--force"], stdout=log,
            stderr=subprocess.STDOUT, cwd=ROOT, env=env,
            preexec_fn=lambda: os.nice(10)), log))
    return procs


def dryrun_stop(procs) -> None:
    """Kill what still runs of ``procs`` and close their logs."""
    for _, proc, log in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def dryrun_cells(procs, out: Path, timeout_s: float = 900) -> list:
    """Phase 46 (a): wait for each cell's process; every record must be
    ``ok`` and fit the card (argument and temp bytes a device within its
    80 GB). Prints each cell's per-device argument and temp bytes beside
    the card's, the dominant term, the step time on this card's spec and
    the trace seconds."""
    from repro_torch.launch.dryrun import MESH_NAMES
    deadline = time.perf_counter() + timeout_s
    rows = []
    for (arch, shape, mesh, mode), proc, log in procs:
        rc = proc.wait(timeout=max(deadline - time.perf_counter(), 1.0))
        log.close()
        name = f"{arch}__{shape}__{MESH_NAMES[mesh]}__{mode}"
        path = out / f"{name}.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        if rc != 0 or rec.get("status") != "ok":
            tail = Path(log.name).read_text()[-3000:]
            raise AssertionError(f"dryrun {name}: exit {rc}, status "
                                 f"{rec.get('status')} "
                                 f"{rec.get('error', '')}\n{tail}")
        m, t = rec["memory"], rec["terms"]
        held = m["argument_bytes_per_device"] + m["temp_bytes_per_device"]
        rows.append(dict(
            cell=name, devices=rec["devices"],
            argument_gb=m["argument_bytes_per_device"] / 1e9,
            temp_gb=m["temp_bytes_per_device"] / 1e9,
            card_gb=CARD_BYTES / 1e9, fits=held <= CARD_BYTES,
            dominant=t["dominant"], step_ms=t["step_time_s"] * 1e3,
            roofline_fraction=t["roofline_fraction"],
            trace_s=rec["trace_s"], spec=rec["spec"],
            flash_calls=rec["analyzer"]["ops"].get(
                "repro_torch::flash_attention_fwd", 0),
            coll_count=rec["analyzer"]["coll_count"]))
        emit(phase="dryrun_cell", **rows[-1])
        if not rows[-1]["fits"]:
            raise AssertionError(f"dryrun {name}: {held / 1e9} GB a device "
                                 f"past the card's {CARD_BYTES / 1e9}")
    return rows


def census_record(c, memory: dict) -> dict:
    """What the card check compares of a step's census (picklable)."""
    return {"ops": dict(c.ops), "flops": c.flops, "ew_flops": c.ew_flops,
            "hbm_bytes": c.hbm_bytes,
            "collectives": [(x.op, x.wire_bytes, x.group_size, x.cross_pod)
                            for x in c.collectives],
            "memory": memory}


def held_census(what: str, real: dict, dry: dict, real_temp: int) -> dict:
    """The dry run's census of a step equal to the real step's, op by op,
    with its FLOPs, element-wise FLOPs, bytes and collectives, and its
    argument bytes exactly; its temp bytes within ``DRYRUN_PEAK_REL`` of
    ``real_temp``. -> the record."""
    if real["ops"] != dry["ops"]:
        diff = {k: (real["ops"].get(k), dry["ops"].get(k))
                for k in set(real["ops"]) | set(dry["ops"])
                if real["ops"].get(k) != dry["ops"].get(k)}
        raise AssertionError(f"{what}: operators differ (card, meta): {diff}")
    for k in ("flops", "ew_flops", "hbm_bytes", "collectives"):
        if real[k] != dry[k]:
            raise AssertionError(f"{what}: {k} {real[k]} on the card, "
                                 f"{dry[k]} on meta")
    arg = "argument_bytes_per_device"
    if real["memory"][arg] != dry["memory"][arg]:
        raise AssertionError(f"{what}: argument bytes {real['memory'][arg]} "
                             f"!= the dry run's {dry['memory'][arg]}")
    pred = dry["memory"]["temp_bytes_per_device"]
    ratio = real_temp / pred
    bound = DRYRUN_PEAK_REL[what.split("_")[-1]]
    if not abs(ratio - 1.0) <= bound:
        raise AssertionError(f"{what}: the card's peak {real_temp} B is "
                             f"{ratio:.4f} of the predicted {pred} B "
                             f"(bound {bound})")
    return dict(ops=sum(real["ops"].values()), distinct_ops=len(real["ops"]),
                flops=real["flops"], ew_flops=real["ew_flops"],
                hbm_bytes=real["hbm_bytes"],
                collectives=len(real["collectives"]),
                wire_bytes=sum(x[1] for x in real["collectives"]),
                flash=real["ops"].get("repro_torch::flash_attention_fwd", 0),
                argument_bytes=real["memory"][arg], predicted_temp=pred,
                card_temp=real_temp, card_over_predicted=ratio,
                bound=bound)


def measured_step(fn, args, launches: dict, pod: int = 0):
    """One warm-up call of ``fn(*args)``, then one under the census with
    the peak reset (``launch/dryrun.py::run_step``). -> (its
    ``census_record``, the allocator's peak less what was allocated when
    it began, its launch counts)."""
    from repro_torch.launch.dryrun import run_step
    counted(lambda: fn(*args), launches)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (c, memory, _), _, counts = counted(
        lambda: run_step(fn, args, pod_size=pod), launches)
    return (census_record(c, memory),
            torch.cuda.max_memory_allocated() - base, counts)


def meta_step(fn, args, pod: int = 0) -> dict:
    """``fn(*args)`` on ``meta`` under the card routing, a warm-up call
    (as ``measured_step``'s: a step's first call builds its layout and
    caches the rotary frequencies), then one under the census. -> its
    ``census_record``."""
    from repro_torch.kernels import card_routing
    from repro_torch.launch.dryrun import run_step
    with card_routing():
        fn(*args)
        c, memory, _ = run_step(fn, args, pod_size=pod)
    return census_record(c, memory)


def dryrun_train_check(seed: int, dev, launches: dict) -> dict:
    """Phase 46 (b): TinyLlama cut to ``DRYRUN_TRAIN``'s layers, bf16,
    ``RunConfig()``, one train step on the card against the dry run of the
    same step on ``meta``; 2 flash launches a layer (forward and its
    recompute)."""
    from repro_torch.configs import RunConfig, ShapeConfig, get_arch
    from repro_torch.models import model as mdl
    from repro_torch.training import init_state, make_train_step
    from repro_torch.training.state import abstract_state
    layers, B, S = DRYRUN_TRAIN
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=layers)
    rc = RunConfig()
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)
    state = init_state(cfg, rc, seed, device=dev)
    real, temp, counts = measured_step(
        make_train_step(cfg, rc),
        (state, {"tokens": torch.as_tensor(toks, device=dev)}), launches)
    del state
    torch.cuda.empty_cache()
    dry = meta_step(make_train_step(cfg, rc), (
        abstract_state(cfg, rc),
        mdl.input_specs(cfg, ShapeConfig("check", S, B, "train"))))
    if counts["flash_attention"] != 2 * layers:
        raise AssertionError(f"dryrun_train: {counts['flash_attention']} "
                             f"flash launches, want {2 * layers}")
    return held_census("dryrun_train", real, dry, temp)


def dryrun_decode_check(seed: int, dev, launches: dict) -> dict:
    """Phase 46 (b): TinyLlama at its 22 layers, bf16, one decode step at
    ``DRYRUN_DECODE``'s slots and ``max_len`` on the card against the dry
    run's (the parameters and cache on ``meta``)."""
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.models import model as mdl
    from repro_torch.serving.engine import (init_rank_cache,
                                            make_decode_step, rank_params)
    slots, max_len = DRYRUN_DECODE
    cfg, rc = get_arch(LM_ARCH), RunConfig()
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (slots, 1),
                                                dtype=np.int32)
    lm = mdl.init(cfg, seed, device=dev).trainable(False)
    cache = mdl.init_cache(cfg, slots, max_len, device=dev)
    real, temp, _ = measured_step(
        make_decode_step(cfg, rc, device=dev),
        (lm, cache, torch.as_tensor(toks, device=dev), DRYRUN_POS), launches)
    del lm, cache
    torch.cuda.empty_cache()
    dry = meta_step(make_decode_step(cfg, rc, device="meta"), (
        rank_params(cfg), init_rank_cache(cfg, slots, max_len,
                                          device="meta"),
        torch.empty((slots, 1), dtype=torch.int32, device="meta"),
        DRYRUN_POS))
    return held_census("dryrun_decode", real, dry, temp)


def dryrun_mesh_cfg():
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(TRAIN_ARCH),
                               n_layers=MESH_TRAIN_LAYERS)


def dryrun_mesh_rank(rank: int, world: int, seed: int) -> dict:
    """One gloo rank of the mesh card check: TinyLlama cut to 2 layers,
    f32, "sharded" on ``DRYRUN_MESH``, one train step under the census."""
    from repro_torch.configs import RunConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import init_state, make_train_step
    warm_census()
    mesh = make_mesh(*DRYRUN_MESH)
    cfg, rc = dryrun_mesh_cfg(), RunConfig()
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (MESH_TRAIN_BATCH, MESH_TRAIN_SEQ), dtype=np.int32)
    state = init_state(cfg, rc, seed, mesh, dtype=torch.float32)
    launches = launch_counts()
    real, temp, counts = measured_step(
        make_train_step(cfg, rc, mesh),
        (state, {"tokens": torch.as_tensor(toks, device="cuda")}), launches)
    return {"census": real, "temp": temp, "launches": launches,
            "step_launches": counts}


def dryrun_mesh_meta(seed: int) -> dict:
    """The mesh card check's dry run: rank 0 of a fake world of the same
    shape, on ``meta``."""
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.launch.mesh import end_fake_world, fake_world
    from repro_torch.models import model as mdl
    from repro_torch.training import make_train_step
    from repro_torch.training.state import abstract_state
    mesh = fake_world(*DRYRUN_MESH)
    try:
        cfg, rc = dryrun_mesh_cfg(), RunConfig()
        return meta_step(make_train_step(cfg, rc, mesh), (
            abstract_state(cfg, rc, mesh, dtype=torch.float32),
            mdl.input_specs(cfg, ShapeConfig(
                "check", MESH_TRAIN_SEQ, MESH_TRAIN_BATCH, "train"))))
    finally:
        end_fake_world()


def dryrun_mesh_check(seed: int, launches: dict) -> dict:
    """Phase 46 (b): ``dryrun_mesh_rank`` on 4 gloo ranks sharing the card,
    rank 0's census against ``dryrun_mesh_meta`` in a process of its own
    (one fake world); every rank's launches count toward the table."""
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.launch.mesh import spawn_world
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        dry = pool.submit(dryrun_mesh_meta, seed)
        # a world of its own: the allocator's peak is held to the
        # prediction, and a kept rank's earlier phases move it
        with tempfile.TemporaryDirectory(prefix="chip-smoke-dryrun-") as tmp:
            ranks = spawn_world(dryrun_mesh_rank, math.prod(DRYRUN_MESH[0]),
                                seed, init_file=str(Path(tmp) / "store"),
                                timeout_s=600)
        dry = dry.result(timeout=600)
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] += v
    flash = ranks[0]["step_launches"]["flash_attention"]
    if flash != 2 * MESH_TRAIN_LAYERS:
        raise AssertionError(f"dryrun_mesh: rank 0 launched flash {flash} "
                             f"times, want {2 * MESH_TRAIN_LAYERS}")
    return held_census("dryrun_mesh", ranks[0]["census"], dry,
                       ranks[0]["temp"])


def dryrun(seed: int, launches: dict) -> None:
    """Phase 46 alone (``scripts/torch_phases.py dryrun``): the slowest
    cell started here, not beside the earlier phases."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip-smoke-dryrun-") as tmp:
        slow = dryrun_start(DRYRUN_SLOW, Path(tmp))
        dryrun_phase(seed, torch.device("cuda"), launches, slow, Path(tmp))


def dryrun_phase(seed: int, dev, launches: dict, slow, out: Path) -> None:
    """Phase 46: (a) the production cells (``DRYRUN_CELLS``; those already
    running, ``slow``: the slowest since the build), each ``ok``; (b) the dry
    run held to real steps on the card: a train step, a decode step and a
    train step on 4 gloo ranks."""
    t0 = time.perf_counter()
    running = {cell for cell, _, _ in slow}
    procs = slow + dryrun_start([c for c in DRYRUN_CELLS
                                 if c not in running], out)
    try:
        checks = {"train": dryrun_train_check(seed, dev, launches),
                  "decode": dryrun_decode_check(seed, dev, launches)}
        torch.cuda.empty_cache()
        checks["mesh"] = dryrun_mesh_check(seed, launches)
        cells = dryrun_cells(procs, out)
    finally:
        dryrun_stop(procs)
    emit(phase="dryrun", seconds=time.perf_counter() - t0, cells=cells,
         checks=checks, train=dict(zip(("layers", "batch", "seq"),
                                       DRYRUN_TRAIN)),
         decode=dict(zip(("slots", "max_len", "pos"),
                         DRYRUN_DECODE + (DRYRUN_POS,))),
         mesh=dict(shape=DRYRUN_MESH[0], layers=MESH_TRAIN_LAYERS,
                   batch=MESH_TRAIN_BATCH, seq=MESH_TRAIN_SEQ))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on the card", file=sys.stderr)
        return 2

    from repro_torch.data import sky
    from repro_torch.kernels import LAUNCHES, _build
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.quantize import kernel as qkernel
    from repro_torch.kernels.zones_pairs import kernel as zkernel
    from repro_torch.mapreduce import (JobResult, StageStats,
                                       host_shuffle_reduce, run_jobs,
                                       shuffle_once, token_histogram)

    # 1. card identity
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    emit(phase="device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 2. build the three libraries, one nvcc each, started together
    t0 = time.perf_counter()
    libs = (zkernel.LIBRARY, qkernel.LIBRARY, fkernel.LIBRARY)
    paths = _build.build(*libs)
    for lib in libs:
        lib.load()
    ptxas = {lib.name: ptxas_summary(lib.info["log"]) for lib in libs}
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries=[str(p) for p in paths],
         nvcc_seconds={lib.name: lib.info["seconds"] for lib in libs},
         ptxas=ptxas)
    # the redesigned kernels: registers, shared memory and spills; the f32
    # flash kernel's instances must not spill
    fa_lib = fkernel.LIBRARY.load()
    smem_of = {"flash_tc_kernel": fa_lib.fa_tc_smem_bytes,
               "flash_fwd_kernel": fa_lib.fa_f32_smem_bytes}
    for name, kernels in ptxas.items():
        for k in kernels:
            m = re.fullmatch(r"(flash_tc_kernel|flash_fwd_kernel)<(\d+)>",
                             k["kernel"])
            if m:
                k["dynamic_smem_bytes"] = smem_of[m.group(1)](
                    int(m.group(2)))
            if m or k["kernel"] in REDESIGNED:
                emit(phase="ptxas", library=name, **k)
            if m and m.group(1) == "flash_fwd_kernel" and (
                    k.get("spill_stores") or k.get("spill_loads")):
                raise AssertionError(f"{k['kernel']} spills: {k}")

    # phase 46's slowest dry-run cells (CPU only) run beside phases 3-45
    import atexit
    import shutil
    import tempfile
    dry_out = Path(tempfile.mkdtemp(prefix="chip-smoke-dryrun-"))
    atexit.register(shutil.rmtree, dry_out, True)
    slow = dryrun_start(DRYRUN_SLOW, dry_out)
    atexit.register(dryrun_stop, slow)

    t0 = time.perf_counter()
    xyz = sky.make_catalog(args.n, args.seed)
    emit(phase="catalog", n=args.n, seed=args.seed,
         seconds=time.perf_counter() - t0)
    launches = launch_counts()
    n_edges = len(zone_jobs("identity")[-1].reducer.edges_rad)

    def drive(codec, engine):
        """-> (outputs, the host engine's ShuffledData or None, host wall,
        StageStats)."""
        jobs = zone_jobs(codec)

        def run():
            if engine == "device":
                return run_jobs(jobs, xyz, engine=engine), None
            st = StageStats()
            totals, sd = host_shuffle_reduce(jobs, xyz, st)
            st.reduce_padded_ratio = sd.padded_ratio
            return [JobResult(j.reducer.finalize(t, sd), st)
                    for j, t in zip(jobs, totals)], sd

        (res, sd), wall, counts = counted(run, launches)
        st = res[0].stats
        want = zone_launches(engine, codec, jobs, st)
        if counts != want:
            raise AssertionError(f"{engine} {codec}: launches {counts} != "
                                 f"{want}")
        check_outputs(res, n_edges)
        (P, C1, C2), = st.tiers if engine == "host" else ((0, 0, 0),)
        emit(phase=f"main_path_{engine}", codec=codec, wall_s=wall,
             launches=counts, tiers=st.tiers, outputs=outputs(res),
             padded_ratio=st.reduce_padded_ratio, C1=C1, C2=C2,
             stats=stage_summary(st))
        return outputs(res), sd, wall, st

    # 3. the device engine, per codec
    mono = {codec: drive(codec, "device") for codec in CODECS}
    full = {codec: run[0] for codec, run in mono.items()}
    # 4. the host engine, per codec; phases 5 and 23 reuse identity's shuffle
    full_host, host_stats = {}, {}
    for codec in CODECS:
        full_host[codec], shuffled, _, host_stats[codec] = drive(codec, "host")
        if codec == "identity":
            sd = shuffled

    # 5. kernel == plain, exactly
    max_err = dict.fromkeys(LAUNCHES, 0.0)
    cats = {}
    for codec in CODECS:
        jobs = zone_jobs(codec)
        cat = shuffle_once(jobs[0].partitioner, xyz, codec=codec)
        err = masked_vs_plain(cat, jobs)
        for k in ("pair_count_masked", "pair_hist_masked"):
            max_err[k] = max(max_err[k], err)
        cats[codec] = (cat, jobs)
        emit(phase="masked_vs_plain", codec=codec, tiers=len(cat.sd.tiers),
             max_abs_err=err)
    jobs = zone_jobs("identity")
    err = unmasked_vs_plain(sd, jobs, dev)
    max_err["pair_count"] = max_err["pair_hist"] = err
    payload = int8_payload(xyz, dev)
    max_err["quantize"] = max_err["dequantize"] = quantize_vs_plain(payload)
    emit(phase="unmasked_and_quantize_vs_plain", shape=[list(sd.owned.shape),
         list(sd.bucket.shape)], payload=list(payload.shape),
         max_abs_err=err)

    # 6. exact cross-checks. The engines agree exactly on one zone map: the
    # device engine runs with the host's zone keys. With its own keys
    # (the card's asinf) a few boundary points change zone, and at 60" the
    # f32 threshold admits pairs beyond the replication margin, so the
    # counts may differ by the pairs those points make: reported, not held.
    part = zone_jobs("identity")[0].partitioner
    t0 = time.perf_counter()
    keys_host = part.assign(xyz)
    keys_card = part.assign_device(torch.as_tensor(xyz, device=dev))
    moved = int(np.count_nonzero(keys_host != keys_card.cpu().numpy()))
    assign_s = time.perf_counter() - t0
    own_keys_delta = {}
    for codec in ("identity", "int16"):
        same_keys = outputs(run_jobs(zone_jobs(codec, host_keys=True), xyz))
        if full_host[codec] != same_keys:
            raise AssertionError(f"{codec}: host engine {full_host[codec]} "
                                 f"!= device engine on the host's zone keys "
                                 f"{same_keys}")
        own_keys_delta[codec] = [
            (np.asarray(h) - np.asarray(d)).tolist()
            for h, d in zip(full_host[codec][:-1], full[codec][:-1])]
    emit(phase="host_equals_device", codecs=["identity", "int16"],
         zone_keys_differing=moved, host_assign_s=assign_s,
         search_delta_with_own_keys=own_keys_delta)
    for n, seed, radius, edges, engine, codec in (
            (1_000_000, 1, None, None, "device", "identity"),
            (50_000, 2, 0.02, np.linspace(0.005, 0.02, 8) / sky.ARCSEC,
             "device", "identity"),
            (INT8_CPU_N, 3, None, None, "host", "int8")):
        cpu_xyz = sky.make_catalog(n, seed)
        jobs = zone_jobs(codec, radius=radius, edges_arcsec=edges)
        t0 = time.perf_counter()
        card = outputs(run_jobs(jobs, cpu_xyz, engine=engine))
        t1 = time.perf_counter()
        host = outputs(run_jobs(jobs, cpu_xyz, engine=engine, device="cpu"))
        t2 = time.perf_counter()
        if card != host:
            raise AssertionError(f"card != cpu at n={n} {engine} {codec}: "
                                 f"{card} vs {host}")
        emit(phase="card_equals_cpu", n=n, radius=radius, engine=engine,
             codec=codec, outputs=card, card_s=t1 - t0, cpu_s=t2 - t1)
    toks = np.random.default_rng(args.seed).integers(0, VOCAB, 4_000_000)
    want = np.bincount(toks, minlength=VOCAB)
    for codec in ("identity", "int16"):
        for engine in ("device", "host"):
            t0 = time.perf_counter()
            res = token_histogram(toks, VOCAB, codec=codec, engine=engine)
            wall = time.perf_counter() - t0
            if not np.array_equal(res.output, want):
                raise AssertionError(f"token_histogram {engine} {codec} != "
                                     "np.bincount")
            emit(phase="token_histogram", engine=engine, codec=codec,
                 n_tokens=len(toks), wall_s=wall, stats=stage_summary(res.stats))
    small = sky.make_catalog(4000, 3)
    for engine in ("device", "host"):
        got = run_jobs(zone_jobs("identity", radius=0.05), small,
                       engine=engine)[0].output
        want_bf = sky.brute_force_pairs(small, 0.05)
        if got != want_bf:
            raise AssertionError(f"{engine} search {got} != brute force "
                                 f"{want_bf}")
    emit(phase="brute_force", n=4000, radius=0.05, pairs=got)

    # 7-13. the streaming executor at full width, spilled and traced
    t0 = time.perf_counter()
    stream_phases(xyz, args.seed, mono, launches, n_edges)
    emit(phase="stream_phases", seconds=time.perf_counter() - t0)

    # 14. the card's energy counter, metered runs, modeled figures beside
    t0 = time.perf_counter()
    energy_phase(xyz, mono, host_stats["int16"], launches, n_edges)
    emit(phase="energy_phases", seconds=time.perf_counter() - t0)

    # 15-18. the calibrated cost model, the auto knobs, the Amdahl terms and
    # the MapReduce query service
    t0 = time.perf_counter()
    _, spec = calibrate_phase(launches)
    auto_knobs_phase(xyz, mono, full_host, launches, n_edges)
    amdahl_phase(xyz, mono, spec, launches, n_edges)
    service_want = service_phase(xyz, launches, n_edges)
    emit(phase="planning_phases", seconds=time.perf_counter() - t0)

    # 19-22. the data-axis mesh: world 1 on NCCL here, 4 gloo ranks on the
    # card
    t0 = time.perf_counter()
    mesh_phases(xyz, args.seed, mono, full_host, service_want, launches,
                n_edges)
    emit(phase="mesh_phases", seconds=time.perf_counter() - t0)

    # the paper's workload from the command line, in a process of its own
    example_phase(launches)

    # 23. kernel times at the full-width shapes (identity codec)
    cat, jobs = cats["identity"]
    rows = time_kernels(cat, jobs, sd, payload, launches, max_err)
    del cat, jobs, cats, sd, payload
    torch.cuda.empty_cache()

    # 24-26. the LM serving path; 27. the flash kernel against its plain
    # version
    lm, toks = lm_main_path(args.seed, dev, launches)
    rows.append(flash_vs_plain(lm, toks, dev, launches))
    del lm
    torch.cuda.empty_cache()

    # 28-36. the other model families at their published widths (deepseek-v3
    # cut to 4 layers); the flash row's launches take in their prefills
    instances = {}
    for phase, arch, batch, prompt in FAMILY_PHASES:
        flash = family_phase(phase, arch, batch, prompt, args.seed, dev,
                             launches)
        if flash is not None:
            instances[arch] = flash
    rows[-1]["instances"].update(instances)

    # 37-41. training: TinyLlama at full width and depth, resume from a
    # checkpoint, granite's MoE backward, the explicit sync on 4 ranks,
    # FSDP on 4 ranks (and on 4 cards where there are); the flash and
    # quantizer rows' launches take them in
    t0 = time.perf_counter()
    train_tinyllama(args.seed, dev, launches)
    train_resume(args.seed, dev, launches)
    train_granite_moe(args.seed, dev, launches)
    train_mesh(args.seed, launches)
    train_fsdp(args.seed, launches)
    emit(phase="train_phases", seconds=time.perf_counter() - t0)

    # 42-43. experts over the model axis: one MoE layer at published widths
    # against its plain version, then the EP train step on 4 ranks (and on
    # 4 cards where there are)
    t0 = time.perf_counter()
    moe_ep(args.seed)
    train_ep(args.seed, launches)
    emit(phase="ep_phases", seconds=time.perf_counter() - t0)

    # 44-45. tensor parallelism over the model axis: training on 4 ranks,
    # serving on 2 (and both on 4 cards where there are)
    slow += dryrun_start(DRYRUN_EARLY, dry_out)
    t0 = time.perf_counter()
    train_tp(args.seed, launches)
    serve_tp(args.seed, launches)
    emit(phase="tp_phases", seconds=time.perf_counter() - t0)

    # 46. the dry run: production cells on this card's spec, and held to a
    # train step, a decode step and a mesh step on the card
    dryrun_phase(args.seed, dev, launches, slow, dry_out)
    for row in rows:
        row["launches"] = launches[row["name"]]
    # the flash row's launches by the kernel its inputs' dtype chose
    by_kernel = {"flash_fwd_kernel (f32)": launches["flash_attention_f32"],
                 "flash_tc_kernel (bf16)": launches["flash_attention_bf16"]}
    if sum(by_kernel.values()) != launches["flash_attention"]:
        raise AssertionError(f"flash launches by kernel {by_kernel} do not "
                             f"sum to {launches['flash_attention']}")
    next(row for row in rows if row["name"] == "flash_attention")[
        "launches_by_kernel"] = by_kernel
    emit(kernels=rows)
    print(nvidia_smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
