"""Drive the PyTorch/CUDA port's resident OMS main path, then its LM serve
and training paths, on one GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught into a success):
  1. environment: card, power limit, torch/CUDA/nvcc versions, triton;
     build the CUDA kernels from the sources in this checkout.
  2. hdencode kernel against its plain PyTorch version on the card, at
     dim 4096 and at 7 words, and at the bit-sliced counters' edges: a
     count of 64 (P = 64, every peak valid with one bin and level), P = 1,
     63, 100 and 2100 (the general plane path), and B = 1. Then
     hamming_matrix and hamming_mxu against the plain tile at the shapes
     the main path does not give them: W = 1 and 9, Q = 1 and 17, R = 1, 7
     and 8k + 3, row slices whose base is not 16-byte aligned (W = 7 from
     an odd row, W = 4 at a 4-byte offset), and W = 300 (hamming_mxu's
     128-word chunks of A fragments).
  3. the main path at the iPRG2012 scale of Table I: OMSPipeline ingest of
     1,160,000 spectra plus as many decoys, 16,000 queries encoded and
     searched (backend ``fused``, encode backend ``pallas``), FDR at 1%;
     both kernels' launch counts are read around this phase. Then the
     fused_search kernel against its plain version on 8 of its query
     blocks, at k = 1 and k = 4, and at 7 words (the scalar-load variant);
     both fused kernels (grouped: 8 consecutive query tiles per CTA) against
     their plain versions on two runs of 2G + 1 consecutive main-path
     blocks at k = 1, 4 and 16, with the groups' union/rk; and at the
     grouped design's edges on seeded synthetic data (tie-heavy duplicate
     rows): batches of 1, 2 and G + 1 blocks, identical starts, ranges past
     the last row, q_block 20, W = 7, 9, 12 and 256, k = 1, 4 and 16.
  4. path against path: the first 512 queries through the plain torch ops
     (vpu, word_tiled) and through the kernels (fused, pallas) against the
     full DB; a 4,096-row library slice re-encoded with word_tiled against
     the kernel-built DB; and a small dataset through the kernels on the
     card against the plain versions on the CPU.
  5. kernel times (CUDA events, median of 10 after a warm-up) beside their
     plain versions at the same shapes (fused_search's plain version on the
     whole batch, held bit for bit against the kernel there and timed as
     the median of 3) and their lower bounds; for the short kernels also
     the device time of a CUDA graph of 20 launches, which leaves out the
     wrapper's host work, and hdencode's gathered codebook bytes.
  6. the all-pairs tile kernels (hamming_matrix: binary AND-popc tensor
     cores; hamming_mxu: +-1 int8 tensor cores) against their plain
     versions on 8 main-path query blocks at W = 128, at the cascade's
     prefix widths W = 64 and 8 and at W = 7, and on 2 query blocks against
     the cascade's 4,194,304-row bucket of gathered rows at W = 128 (the
     seed pass and the rescore), where hamming_matrix and hamming_mxu are
     also timed beside their bound and beside torch._int_mm on the
     bucket's rows unpacked to +-1 int8 beforehand; the fused_search_mxu
     kernel against its plain version on 8 blocks at k = 1 and k = 4, and
     at 7 words (dim 224, the scalar-load variant).
  7. fused_search_mxu against fused_search on the whole batch at k = 1
     and k = 4: all four arrays bit-identical.
  8. the kernel backends end to end: search_encoded with kernel_vpu,
     kernel_mxu and fused_mxu on the full batch, each equal to phase 3's
     fused result (6 SearchResult arrays, both FDR results); each run's
     launch counts are set to 0 just before it and read just after.
  9. the dimension cascade, exact mode, at prefix_words 8 and 64 with
     fused, kernel_vpu and fused_mxu on the full batch, each equal to the
     full-width fused result; seed rows, survivors, buckets, stage times
     and the tile launches by shape (rows x words) are printed. Then
     margin mode (prefix_margin = half the rest), which prunes: the stage-A
     keep flags of the whole batch (thresholds from the full scan) through
     the kernel_vpu and fused_mxu tiles against the plain tile, a strict
     subset kept; and on the first 512 queries the same three backends'
     searches against a run whose tile is the plain version (row-chunked),
     all results and survivor counts equal, survivors a strict subset.
 10. times and bounds of the tile kernels and fused_search_mxu (the tiles
     at one main-path block beside torch._int_mm on pre-unpacked +-1 int8;
     fused_search_mxu on the whole batch, its plain version run once,
     compared and timed).
 11. top_k above 16: both fused kernels against their plain versions on
     the main-path check blocks at k = 17, 32 and 64, and timed on the
     whole batch at k = 16, 17, 32 and 64; the limits that were widened
     (fused_search_mxu past 256 words, the fused kernels at their widest
     W, the tile kernels past 65,535 query tiles, hamming_matrix past
     3,632 words, the grouped launch past 65,535 groups) against the plain
     versions; the limits that remain raise their stated errors.
 12. the store: OMSPipeline.ingest of the Table I library (chunks of 65,536
     rows) into a store under build/ (its free space printed first), then
     from_store(resident=True): its DB equals phase 3's in all eight
     fields and its fused search equals phase 3's result.
 13. streamed search: from_store(resident=False) at 2^18 rows a slab, at
     37 blocks (a prime) and at the whole store, with fused and fused_mxu:
     each equal to phase 3's result (6 arrays, both FDRs), one fused launch
     per streamed slab; per slab the host gather, upload and search times,
     slabs touched, rows and bytes read, and the peak device memory above
     the baseline beside the resident DB's bytes.
 14. the streamed exact dimension cascade at prefix_words 8 with fused:
     equal to the resident cascade, run beside it, and to phase 3's result.
 15. the narrow→open cascade at 1 Da with fused, resident and streamed:
     equal to each other (merged result, both FDRs, stage-1 identified,
     stage queries and results); with run_stage1 False equal to
     search_encoded; identified count, each stage's time, scanned rows
     against pure_open_scanned_rows, and bytes streamed.
 16. the launcher, ``python -m repro_torch.launch.oms`` as subprocesses
     from the repository root (free disk printed first): ``build`` of the
     Table I library, byte-identical to phase 12's store (then deleted);
     ``search`` (fused, pallas), its recall and identification lines equal
     to phase 3's, and ``search --cascade``, stage 1 identifying as many as
     the in-process cascade; ``queries`` of the 16,000 requests; ``serve
     --resident`` (no cache, traced) on all of them, every response equal
     to phase 3's row; streamed ``serve`` at 2^18 rows a slab on the first
     1,024 at 256 a batch (a scan reads the whole store), byte-identical to
     the resident lines; ``serve`` with the result cache on the first
     1,024 twice, the second copy all hits and the lines unchanged; ``serve
     --cascade`` on all, a sample of 256 responses equal to single-query
     in-process cascades; ``trace-report --json`` on both traces, span
     counts equal to the micro-batches and slabs served. Each serve mode
     runs once more in process (``oms.main``; the 16,000-request modes on
     the first 1,024) for the launch counts, under ``torch.profiler``
     (device activity only) for the device's busy share and the kernels'
     device time per micro-batch, and must answer byte for byte as the
     subprocess did; one resident micro-batch's ``hdencode`` and
     ``fused_search`` calls are replayed at their serve shapes and timed
     with CUDA events.
 17. the autotuner and the contract analyzer. Inside phase 16, before
     its hot reload grows the store: the card's float32 sqrt (the
     preprocess's) against the float64 one rounded once; ``tune`` in
     process at the main path's shapes (the tile and fused backends on one
     block of 16 queries x its scanned rows at dim 4096, k = 1; rescore on
     the cascade's real rows), every candidate held bit for bit against
     the defaults' output by the sweep, the winner table (ms, bound ms from
     ``repro_torch.utils.roofline``, fraction) with each winner against
     the default; ``search`` and resident ``serve`` (the first 1,024
     requests) in process with the winners' cache: output byte-identical
     to the untuned runs (clock readings masked) and the cache hit at
     dispatch. After phase 16: ``analyze --imports`` on the card, every
     recording under sync debug mode "error"; it exits 0; n_checks and
     each combination's allocator peak.
 18. multi-device OMS, run after phase 15 (before phase 16): S distinct
     cards where the machine has more than one (dealt round-robin), else S
     entries of the one card. ``sharded_search`` of phase 3's sorted batch
     on a ("model",) mesh at S = 2 and 4 (both pad the 567 blocks by one),
     with fused and fused_mxu at top_k 1 and 16, each bit for bit against
     the resident fused search at that top_k (the padding is appended, so
     real rows keep their numbers) and launching its kernel once a shard;
     first and warm times, one shard's search and the merge in CUDA events,
     the peak device memory. Then ``from_store(resident=False,
     stream_devices=...)`` with 2 and 4 entries on phase 12's store at 2^18
     rows a slab, bit for bit against the one-device streamed result,
     StreamStats included, with its per-slab times.
 19. the dense LM serve path, run last; it launches none of the five
     kernels. Width checks in float32 with TF32 off: llama3.2-3b,
     deepseek-7b, mistral-nemo-12b, starcoder2-15b and qwen2-vl-7b at full
     width and 2 layers, weights drawn on the card and copied to the host,
     a prefill of 2 x 64 (qwen2-vl with 4 vision embeddings and three
     position streams) and one decode step, logits on the card against the
     CPU within 1e-3 of max |ref|. Then ``python -m
     repro_torch.launch.serve --arch llama3.2-3b --batch 8 --prompt-len 512
     --gen 64`` as a subprocess (exits 0, prints its ``[serve]`` line), and
     one arch of every family at full width and depth in bf16 in process:
     llama3.2-3b, olmoe-1b-7b and deepseek-v2-lite-16b (MLA) at 8 x 512 +
     64, recurrentgemma-9b and xlstm-1.3b at 4 x 512 + 32, whisper-base at
     8 x 512 + 64 (its prefill encodes 512 frames first): parameter counts
     real and padded, the prefill (CUDA events, median of 5; tokens/s, MFU
     and share of the HBM bound against ``utils/roofline.py``), the greedy
     decode steps at context P + 1..P + G (CUDA events a step; median ms,
     the share of the HBM bound, MFU), a device profile of one prefill and
     8 steps (idle share), peak device memory, and the decode of token P +
     1 against a full forward over P + 1 tokens within 5e-2 of max |ref|
     (the MoE archs at capacity_factor = n_experts, where the sequences
     routed alike are held to it and a float32 run to 1e-3).
 20. LM training, after phase 19; it launches none of the five kernels.
     Width checks in float32 with TF32 off: llama3.2-3b and olmoe-1b-7b
     (capacity factor 1.25: copies drop, so the MoE gathers' autograd
     Functions run) at full width and 2 layers, weights drawn on the card
     and copied to the host, from ``data.tokens.synthetic_batches`` at
     2 x 64: the gradients of one batch, then two ``train_step``s (the
     schedule's lr is 0 at step 0), card against CPU: losses within 1e-4
     relative, every gradient, m and v leaf within 1e-3 of max |CPU|, the
     params within 1e-3 of max |CPU| plus the error AdamW propagates from
     rounding-level gradients. Llama-3.2-3B at full width and depth in
     bf16 with remat at 4 x 512 (2 x 512 if that does not fit): one
     warm-up step, 5 steps timed with CUDA events (median ms, MFU against
     ``utils/roofline.lm_train_roofline``), each loss and grad_norm finite,
     peak device memory, one step under torch.profiler; no full-width
     checkpoint. The llama3.2-3b smoke config in bf16 trained two steps on
     the card, saved and restored onto the card bit for bit, its manifest
     equal to the same state's saved from the host. ``python -m
     repro_torch.launch.train --arch llama3.2-3b --smoke --steps 20 --batch
     8 --seq 128 --microbatches 2 --ckpt-every 5`` as subprocesses:
     ``--fail-at 12`` exits nonzero with SimulatedFailure after committing
     step 10, the rerun resumes at 10 and logs steps 10..19 and ends at 20,
     ``--compress-grads`` from a fresh directory ends below its first loss.
 21. LM distribution, after phase 20; it launches none of the five
     kernels. (a) ``distributed.pipeline_forward``: Llama-3.2-3B blocks at
     full width (heads padded as the config pads them) cut to 8 layers, 4
     stages of 2 layers on 4 entries of the card, 8 micro-batches of 1 x
     512, float32 with TF32 off, ``transformer.apply_block`` per layer,
     against the sequential loop over the same 8 blocks within 1e-3 of
     max |ref|; both timed (CUDA events). (b) elastic: an 8 x 8 tensor on
     a (4, 2) mesh of 8 card entries, 2 entries lost, ``remesh`` to (3,
     2), ``reshard_tree``: the shard shapes the CPU test pins, bit-equal
     after ``full()``. (c) the Llama-3.2-3B bf16 train state at full width
     cut to 4 layers (params, ``m`` normal, ``v`` uniform) saved, then
     ``restore_checkpoint(shardings=...)`` onto a (data 2, model 2) mesh
     of 4 card entries by ``param_pspecs`` / ``opt_state_pspecs`` and
     ``enforce_divisibility``: every leaf bit-equal after ``full()``, the
     shards' bytes equal to ``dryrun._sharded_arg_bytes`` x 4 entries, and
     the allocator's rise in requested bytes equal to them;
     save and restore seconds and GB/s, and both scaled to the 28-layer
     state. (d) ``python -m repro_torch.launch.dryrun --all --both-meshes``
     as a subprocess: 80 records, 64 ``ok`` (each with its per-chip work
     and collectives, no null in ``per_chip`` or ``roofline``) and 16
     ``skipped``.
 22. the examples, last: ``examples/quickstart_torch.py`` on the card and
     with ``--device cpu`` (the CPU run started first, beside the others),
     their lines equal; ``oms_search_e2e_torch.py`` on the card, every
     ``[backend ...]`` line reporting the ``[serve]`` lines'
     identifications; ``serve_lm_torch.py``; ``train_lm_torch.py --steps 5``
     into a checkpoint directory under build/ (deleted after). Each must
     exit 0; their times are printed.
All five kernels go into one ``kernels`` JSON line; ``launches`` is the
main path's count (the backend's own path for the tile and fused_mxu
kernels) and ``launches_by_path`` each path's, counts set to 0 just before
the path and read just after. Phase 19's numbers go into one ``lm`` JSON
line, phase 20's into one ``train`` line, phase 21's into one ``dist`` line
and phase 22's into one ``examples`` line before it.

The last line is ``{"ok": true, "device": {...}}``. The script imports
neither jax nor the reference package.
"""
from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

SEED = 0
DEVICE = "cuda"
HDENCODE_SPECTRA = 4096
FUSED_CHECK_BLOCKS = 8
PATH_CHECK_QUERIES = 512
SLICE_ROWS = 4096
ENCODE_BATCH = 4096      # spectra per hdencode launch on the main path
CHUNK_ROWS = 1 << 16     # library rows per ingest chunk
TIMING_ITERS = 10
GRAPH_LAUNCHES = 20      # launches per captured CUDA graph (device times)

FUSED_PLAIN_ITERS = 1    # the plain search takes ~20 s per full batch
NARROW_W = 7             # a word count that takes the kernels' scalar paths
TILE_CHECK_W = (64, 8, NARROW_W)   # the prefix widths and a scalar-load width
BUCKET_CHECK_BLOCKS = 2  # query blocks held against the cascade's row bucket
PLAIN_TILE_ROWS = 1 << 16  # row chunk of the plain tile at bucket sizes
# Edge shapes of the redesigned kernels against their plain versions.
HDENCODE_EDGE_SPECTRA = 256
# P = 1: no upper counter plane; 63, 100: three and four; 2100: the general
# plane path (P >> 3 >= 256).
HDENCODE_EDGE_P = (1, 63, 100, 2100)
TILE_EDGE_ROWS = 8 * 512 + 3
# (Q, R, W, word offset of the rows): k-step tails (W = 1, 9), a partial and
# a second query tile, R = 1, 7 and 8k + 3 (odd: the scalar stores), a W = 7
# row slice from an odd row and a W = 4 one at a 4-byte offset (scalar loads
# for a row base that is not 16-byte aligned), and W = 300 (hamming_mxu
# takes its A fragments in 128-word chunks: two full and a partial one).
TILE_EDGE_SHAPES = ((16, TILE_EDGE_ROWS, 1, 0), (16, TILE_EDGE_ROWS, 9, 0),
                    (1, TILE_EDGE_ROWS, 128, 0), (17, TILE_EDGE_ROWS, 128, 0),
                    (16, 1, 128, 0), (16, 7, 128, 0), (16, TILE_EDGE_ROWS, 128, 0),
                    (16, TILE_EDGE_ROWS, 7, 7), (16, TILE_EDGE_ROWS, 4, 1),
                    (16, TILE_EDGE_ROWS, 300, 0))
# The kernel backends of phase 8 and the kernel each of them launches.
BACKEND_KERNELS = {"kernel_vpu": "hamming_matrix", "kernel_mxu": "hamming_mxu",
                   "fused_mxu": "fused_search_mxu"}
CASCADE_PREFIX_WORDS = (8, 64)
# The cascade's backends and the tile kernel each routes its stages to.
CASCADE_TILES = {"fused": "hamming_matrix", "kernel_vpu": "hamming_matrix",
                 "fused_mxu": "hamming_mxu"}
MARGIN_QUERIES = PATH_CHECK_QUERIES
PLAIN_TILE_BACKEND = "plain_tile"   # registered by phase 9 for its yardstick

# Device peaks and the kernels' work counts for the lower bounds live in
# src/repro_torch/utils/roofline.py, which the tune sweep reads too.
# Grouped fused kernels: runs of consecutive main-path query blocks (2G + 1
# with G = 8 tiles per CTA) held against the plain versions at these k.
FUSED_GROUP_RUN = 2 * 8 + 1
FUSED_GROUP_KS = (1, 4, 16)
# (what, rows, W, start rows, rk, q_block) on seeded synthetic data whose
# rows repeat 8 HVs (ties); every case at k = 1, 4 and 16, both kernels.
FUSED_EDGE_CASES = (
    ("1 block", 3000, 128, (5,), 2000, 16),
    ("2 blocks, identical starts", 3000, 128, (7, 7), 2000, 16),
    ("G + 1 blocks (a partial last group)", 12000, 128, tuple(range(0, 9 * 1100, 1100)),
     2048, 16),
    ("ranges past the last row", 3000, 8, (0,) * 9 + (2990, 2995), 64, 16),
    ("q_block 20", 4000, 128, (0, 100, 200, 300, 400), 1000, 20),
    ("W = 7", 3000, 7, (0, 8, 16, 1000, 1000, 2700, 2750), 300, 16),
    ("W = 9", 3000, 9, tuple(range(0, 90, 10)), 1024, 16),
    ("W = 12", 3000, 12, tuple(range(0, 900, 100)), 1024, 16),
    ("W = 256", 3000, 256, tuple(range(0, 90, 10)), 1024, 16),
)


# Phases 11-15: top_k above the old cap of 16, the store, the streaming
# engine and the narrow→open cascade.
TOPK_CHECK_KS = (17, 32, 64)
TOPK_TIME_KS = (16, 17, 32, 64)
STORE_DIR = HERE / "build" / "smoke_store"
# Streamed slab sizes in rows: 2^18, a prime number of blocks (37 of 4,096
# rows), the whole store.
STREAM_SLAB_ROWS = (1 << 18, 37 * 4096, 1 << 30)
STREAM_KERNELS = {"fused": "fused_search", "fused_mxu": "fused_search_mxu"}
STREAM_CASCADE_PREFIX = 8
NARROW_TOL_DA = 1.0
GRID_Y_MAX = 65535       # CUDA's grid y limit: groups of one fused launch

# Phase 16: the launcher, ``python -m repro_torch.launch.oms``, as
# subprocesses from the repository root.
CLI_STORE_DIR = HERE / "build" / "smoke_store_cli"
REQUESTS_FILE = HERE / "build" / "smoke_requests.jsonl"
SERVE_TRACE = HERE / "build" / "smoke_serve.trace.json"
STREAM_TRACE = HERE / "build" / "smoke_stream.trace.json"
# A streamed scan reads the whole 1.19 GB store (~1.2-1.5 s), so streamed
# serve takes the first 1,024 requests at 256 a micro-batch; the cache run
# sends the first 1,024 twice; the cascade responses are held against
# single-query in-process cascades on a sample of 256 ids.
STREAM_SERVE_REQUESTS = 1024
STREAM_SERVE_BATCH = 256
STREAM_SERVE_SLAB_ROWS = 1 << 18
CACHE_REQUESTS = 1024
# The in-process serve runs (launch counts, device profile) of the modes
# that serve all 16,000 requests take the first 1,024.
IN_PROCESS_REQUESTS = 1024
SERVE_PROFILE = HERE / "build" / "smoke_serve_profile.json"
# Device activity in a torch.profiler (Kineto) trace, and the serve path's
# kernels by the names of their __global__ functions.
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SERVE_KERNELS = {"hdencode": ("hdencode_kernel",),
                 "fused_search": ("fused_grouped_partial", "fused_search_merge")}
CASCADE_SAMPLE = 256
CLI_TIMEOUT_S = 300
# Hot reload: streamed serve of 256 requests, then `build --append` of
# 65,536 more library spectra (seed 1), then 256 requests drawn from them.
HOT_RELOAD_REQUESTS = 256
HOT_RELOAD_REFS = 1 << 16
HOT_RELOAD_POLL_S = 0.1
RELOAD_TRACE = HERE / "build" / "smoke_reload.trace.json"

# Phase 17: the autotuner and the contract analyzer. The sweep runs at the
# main path's shapes (one query block of 16 x its scanned rows at dim
# 4096; the fused backends at k = 1; rescore on the cascade's real rows,
# whose bucket the survivor rescore pads to), each candidate timed as the
# median of TUNE_ITERS; tuned `search` and resident `serve` (the first
# 1,024 requests) run in process with the winners' cache.
TUNE_CACHE = HERE / "build" / "smoke_tune_cache.json"
TUNE_ITERS = 20
TUNE_QUERIES = 16
ANALYZE_REPORT = HERE / "build" / "smoke_analyze.json"
SQRT_CHECK_SPECTRA = 1 << 16

# Phase 18: multi-device OMS. Sharded search at S shards (both pad the
# 567-block DB by one block) with both fused kernels at two top_k; the
# streamed search dealt over this many device entries at 2^18-row slabs.
SHARD_COUNTS = (2, 4)
SHARD_KS = (1, 16)
SHARD_KERNELS = STREAM_KERNELS
SHARD_WARM_RUNS = 5
STREAM_DEVICE_COUNTS = (2, 4)

# Phase 19: the LM serve path of every family (no OMS kernel runs on it).
# Width checks in float32 (TF32 off), each arch at full width cut to the
# layers below (whisper-base whole, 6 + 6), a prefill of B x S (qwen2-vl
# with vision embeddings and three position streams, whisper-base on S
# frames) and one decode step on the card against the CPU on the same
# weights; the MoE archs once at their default capacity factor (copies
# drop, and must drop alike) and once at capacity_factor = n_experts. Then
# `python -m repro_torch.launch.serve` at full width and depth in bf16 for
# one arch per family, one subprocess after another; one arch of every
# family in process at full width and depth in bf16 (LM_FULL_ARCHS, at
# LM_FULL_SHAPES: batch, prompt, generated tokens): prefill and decode
# timed against their bounds, decode against the full forward.
LM_WIDTH_LAYERS = {"llama3.2-3b": 2, "deepseek-7b": 2, "mistral-nemo-12b": 2,
                   "starcoder2-15b": 2, "qwen2-vl-7b": 2, "olmoe-1b-7b": 2,
                   "deepseek-v2-lite-16b": 2, "recurrentgemma-9b": 3,  # rec, rec, attn
                   "xlstm-1.3b": 8,                                    # 7 mLSTM + 1 sLSTM
                   "whisper-base": None}
LM_WIDTH_B, LM_WIDTH_S = 2, 64
LM_VISION_TOKENS = 4
LM_WIDTH_TOL = 1e-3      # max |Δ| / max |ref| of the logits, float32
LM_BATCH, LM_PROMPT, LM_GEN = 8, 512, 64
LM_SERVE_RUNS = {"llama3.2-3b": (LM_BATCH, LM_PROMPT, LM_GEN),
                 "olmoe-1b-7b": (8, 512, 64), "recurrentgemma-9b": (4, 512, 32),
                 "xlstm-1.3b": (4, 512, 32), "whisper-base": (8, 512, 64)}
LM_FULL_ARCHS = ("llama3.2-3b", "olmoe-1b-7b", "deepseek-v2-lite-16b",
                 "recurrentgemma-9b", "xlstm-1.3b", "whisper-base")
# RecurrentGemma-9B and xLSTM-1.3B at their serve runs' 4 x 512 + 32 (the
# sLSTM's loop over 512 steps is ~0.8 s a prefill); Whisper-base encodes
# as many frames as its prompt holds tokens, as the serve launcher does.
LM_FULL_SHAPES = {"llama3.2-3b": (LM_BATCH, LM_PROMPT, LM_GEN),
                  "olmoe-1b-7b": (8, 512, 64), "deepseek-v2-lite-16b": (8, 512, 64),
                  "recurrentgemma-9b": (4, 512, 32), "xlstm-1.3b": (4, 512, 32),
                  "whisper-base": (8, 512, 64)}
# A MoE arch's decode against the full forward runs at capacity_factor = E,
# where nothing drops; its (E, C, D) buffers then hold C = T * K slots an
# expert, so it runs on this many of the sequences, in bf16 and again in
# float32 (DeepSeek-V2-Lite's 15.7 B params take 63 GB in float32, so one).
LM_MOE_CHECK_BATCH = {"olmoe-1b-7b": {"bfloat16": 4, "float32": 2},
                      "deepseek-v2-lite-16b": {"bfloat16": 4, "float32": 1}}
LM_PREFILL_ITERS = 5
LM_PROFILE_STEPS = 8     # decode steps under torch.profiler (device only)
LM_PROFILE_TOP = 8       # kernels listed by device time
# Decode of token 513 from the cache against a full forward over 513
# tokens, bf16: the two take different matmul shapes (1 row against 513),
# so their bf16 roundings differ and compound over 28 layers.
LM_DECODE_TOL = 5e-2
# xLSTM-1.3B's bf16 forward is 0.90 of max |ref| from its own float32
# forward on the same weights (48 blocks, 64 tokens, on the CPU; Llama-3.2-3B
# 0.011): the rounding of each block compounds through the exponential
# gates' normalisers. Its bf16 decode and bf16 full forward, two bf16
# evaluations of one function, differ by the same noise (0.12 there, 0.37
# at 512 tokens on the card), so that difference is measured and printed
# beside the noise floor, and the decode is held against the full forward
# in float32 (the weights cast in place, TF32 off) within LM_WIDTH_TOL.
LM_DECODE_FLOAT32 = ("xlstm-1.3b",)

# Phase 20: LM training (no OMS kernel runs on it). Width checks in float32
# (TF32 off) at full width cut to TRAIN_WIDTH_LAYERS layers, OLMoE at
# capacity factor 1.25 (copies drop, so the MoE gather Functions' backwards
# run): the gradients of one batch and TRAIN_WIDTH_STEPS train steps on the
# card against the CPU from the same weights (the schedule's lr is 0 at
# step 0, so the second step is the first to move the params).
TRAIN_WIDTH_ARCHS = ("llama3.2-3b", "olmoe-1b-7b")
TRAIN_WIDTH_B, TRAIN_WIDTH_S, TRAIN_WIDTH_LAYERS, TRAIN_WIDTH_STEPS = 2, 64, 2, 2
TRAIN_MOE_CAPACITY = 1.25
TRAIN_LOSS_TOL = 1e-4    # relative
TRAIN_TOL = 1e-3         # max |Δ| / max |CPU| of a leaf (gradients, m, v)
# Full-width training: Llama-3.2-3B at full depth in bf16 with remat, one
# warm-up step, then TRAIN_STEPS timed steps (CUDA events), then one step
# under torch.profiler; at TRAIN_BATCH // 2 if TRAIN_BATCH does not fit.
TRAIN_ARCH = "llama3.2-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 5
# The launcher as subprocesses: a failure at step 12 after committing step
# 10, the resume to step 20, and a compressed run from a fresh directory.
TRAIN_CKPT_DIR = HERE / "build" / "smoke_train_ckpt"
TRAIN_CLI = ("--arch", "llama3.2-3b", "--smoke", "--steps", "20", "--batch", "8",
             "--seq", "128", "--microbatches", "2", "--ckpt-every", "5",
             "--log-every", "1")

# Phase 21: LM distribution (no OMS kernel runs on it).
DIST_ARCH = "llama3.2-3b"
PIPE_LAYERS, PIPE_STAGES, PIPE_MICRO, PIPE_MB, PIPE_SEQ = 8, 4, 8, 1, 512
PIPE_TOL = 1e-3          # max |Δ| / max |ref| of the pipeline's output, float32
PIPE_ITERS = 3
CKPT_LAYERS, CKPT_MESH, CKPT_STEP = 4, (2, 2), 7
DIST_CKPT_DIR = HERE / "build" / "smoke_dist_ckpt"
DRYRUN_DIR = HERE / "build" / "smoke_dryrun"

# Phase 22: the port's examples as subprocesses, on the card; the
# quickstart also on the CPU.
EXAMPLE_CKPT_DIR = HERE / "build" / "smoke_example_ckpt"
EXAMPLE_TRAIN_STEPS = 5
EXAMPLE_CPU_THREADS = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = TIMING_ITERS, warmup: bool = True) -> float:
    """Median milliseconds of ``fn()`` on the card over ``iters`` runs (after
    one warm-up run unless the caller has just run it), each bracketed by
    CUDA events."""
    import torch
    if warmup:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, launches: int = GRAPH_LAUNCHES) -> float:
    """Device milliseconds of one ``fn()``: ``launches`` calls captured in a
    CUDA graph, the graph's replay timed as cuda_ms times a call, divided
    by ``launches``. Around a single call, cuda_ms also counts the
    wrapper's host work whenever the kernel is shorter than it; a replay
    has none between its events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    ms = cuda_ms(graph.replay) / launches
    del graph
    return ms


def equal(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool((a == b).all())


def max_abs_err(pairs) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in pairs)


# ---------------------------------------------------------------------------
# Phase 1: environment and build
# ---------------------------------------------------------------------------


def phase_environment(torch) -> dict:
    from repro_torch.kernels import _build
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    clock = nvidia_smi("clocks.max.sm")
    try:
        nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                              text=True, timeout=60).stdout.strip().splitlines()[-1]
    except (OSError, IndexError) as e:
        fail(f"nvcc not usable: {e}")
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    log(f"[env] device: {name} (count {torch.cuda.device_count()})")
    log(f"[env] nvidia-smi name, power.limit: {smi}")
    log(f"[env] max SM clock: {clock}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} nvcc: {nvcc}")
    log(f"[env] triton: {triton_v or 'not importable'}")
    return {"name": name, "smi": smi, "clock_hz": float(clock.split()[0]) * 1e6,
            "n_sms": torch.cuda.get_device_properties(0).multi_processor_count}


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build(log=lambda s: log("\n".join(
        f"[build] {line}" for line in s.splitlines()
        if "registers" in line or "Compiling" in line or "error" in line.lower()
        or line.startswith("[nvcc"))))
    _build.library()
    log(f"[build] {len(_build.sources())} sources -> {lib.relative_to(HERE)} "
        f"in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# Phase 2: hdencode kernel against its plain version
# ---------------------------------------------------------------------------


def hdencode_inputs(torch, dev, n_bins: int, n_levels: int, B: int, P: int = 64):
    """Random spectra plus the edge rows: all-masked, 2 and 4 valid peaks
    (majority ties wherever the bound HVs differ)."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    bins = torch.randint(0, n_bins, (B, P), generator=g, device=dev, dtype=torch.int32)
    levels = torch.randint(0, n_levels, (B, P), generator=g, device=dev,
                           dtype=torch.int32)
    mask = torch.rand((B, P), generator=g, device=dev) < 0.7
    mask[0] = False
    mask[1] = False
    mask[1, :2] = True
    mask[2] = False
    mask[2, :4] = True
    return bins, levels, mask


def phase_hdencode_check(torch, cb) -> None:
    from repro_torch.kernels.hdencode import ops, ref
    dev = cb.device
    bins, levels, mask = hdencode_inputs(torch, dev, cb.id_hvs.shape[0],
                                         cb.level_hvs.shape[0], HDENCODE_SPECTRA)
    args = (bins, levels, mask, cb.id_hvs, cb.level_hvs, cb.tiebreak)
    got = ops.hdencode(*args)
    torch.cuda.synchronize()
    want = ref.hdencode(*args)
    require(equal(got, want), "hdencode kernel differs from its plain version")
    require(equal(got[0], cb.tiebreak), "all-masked spectrum is not the tiebreak HV")
    log(f"[check] hdencode kernel == plain on {tuple(bins.shape)} spectra x "
        f"peaks at dim {cb.dim} (all-masked and tie rows included): bit-identical")
    # A word count that is neither a warp nor a block multiple.
    narrow = tuple(t[..., :NARROW_W].contiguous()
                   for t in (cb.id_hvs, cb.level_hvs, cb.tiebreak))
    got = ops.hdencode(bins, levels, mask, *narrow)
    torch.cuda.synchronize()
    require(equal(got, ref.hdencode(bins, levels, mask, *narrow)),
            f"hdencode kernel differs from its plain version at W = {NARROW_W}")
    log(f"[check] hdencode kernel == plain at W = {NARROW_W} words: bit-identical")
    phase_hdencode_edges(torch, cb)


def phase_hdencode_edges(torch, cb) -> None:
    """The bit-sliced counters at their edges: a count of 64 (the top plane
    at P = 64), P from one plane to the general plane path, and B = 1."""
    from repro_torch.kernels.hdencode import ops, ref
    dev = cb.device
    n_bins, n_levels = cb.id_hvs.shape[0], cb.level_hvs.shape[0]
    B = HDENCODE_EDGE_SPECTRA
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    # one bin and one level per spectrum, repeated over all 64 peaks
    same = [torch.randint(0, n, (B, 1), generator=g, device=dev,
                          dtype=torch.int32).expand(B, 64).contiguous()
            for n in (n_bins, n_levels)]
    cases = [("P = 64, every peak valid with one bin and level (count 64)",
              (*same, torch.ones((B, 64), dtype=torch.bool, device=dev)))]
    cases += [(f"P = {P}", hdencode_inputs(torch, dev, n_bins, n_levels, B, P))
              for P in HDENCODE_EDGE_P]
    cases.append(("B = 1, P = 64", tuple(t[3:4].contiguous() for t in hdencode_inputs(
        torch, dev, n_bins, n_levels, 4))))
    for what, (bins, levels, mask) in cases:
        args = (bins, levels, mask, cb.id_hvs, cb.level_hvs, cb.tiebreak)
        got = ops.hdencode(*args)
        torch.cuda.synchronize()
        require(equal(got, ref.hdencode(*args)),
                f"hdencode kernel differs from its plain version at {what}")
        log(f"[check] hdencode kernel == plain at {what} ({tuple(bins.shape)} "
            f"spectra x peaks): bit-identical")


# ---------------------------------------------------------------------------
# Phase 3: main path
# ---------------------------------------------------------------------------


def sorted_batch(torch, pipe, hvs, q_pmz, q_charge):
    """The main path's sorted/padded query layout, its params and start rows."""
    from repro_torch.core import search
    params = pipe.search_params(q_pmz.cpu().numpy(), q_charge.cpu().numpy())
    gather, _ = search.sort_pad_plan(q_pmz, q_charge, params.q_block)
    qh, qp, qc = hvs[gather], q_pmz[gather], q_charge[gather]
    starts = search.block_start_rows(pipe.db, params, qp, qc)
    return params, qh, qp, qc, starts


def phase_main_path(torch, ds, cfg):
    import numpy as np
    from repro_torch.core.pipeline import OMSPipeline
    from repro_torch.kernels.hamming import ops as fs_ops
    from repro_torch.kernels.hdencode import ops as hd_ops

    hd_ops.launches.reset()
    fs_ops.launches.reset()
    t0 = time.perf_counter()
    pipe = OMSPipeline(cfg, ds.refs, device=DEVICE, chunk_rows=CHUNK_ROWS)
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    t0 = time.perf_counter()
    hvs, q_pmz, q_charge = pipe.encode_queries(ds.queries)
    torch.cuda.synchronize()
    t_encode = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = pipe.search_encoded(hvs, q_pmz, q_charge)
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    launches = {"hdencode": hd_ops.launches.count,
                "fused_search": fs_ops.launches.count}
    # The same search again: the first call also pays one-time costs (lazy
    # module load of the kernel library on the device, allocator growth).
    t0 = time.perf_counter()
    pipe.search_encoded(hvs, q_pmz, q_charge)
    torch.cuda.synchronize()
    t_search_warm = time.perf_counter() - t0

    Q = ds.queries.mz.shape[0]
    params = pipe.search_params(q_pmz.cpu().numpy(), q_charge.cpu().numpy())
    log(f"[main] ingested {pipe.db.n_rows} rows ({pipe.db.n_blocks} blocks of "
        f"{cfg.max_r}, {2 * pipe.n_targets} spectra) in {t_ingest:.2f}s")
    log(f"[main] encoded {Q} queries in {t_encode:.3f}s; searched in "
        f"{t_search:.3f}s (backend={cfg.backend}, encode_backend="
        f"{cfg.encode_backend}, k_blocks={params.k_blocks}, "
        f"rows/block={params.k_blocks * cfg.max_r}); searched again in "
        f"{t_search_warm:.3f}s ({Q / t_search_warm:.0f} queries/s)")
    src = ds.query_source
    mod = ds.query_modified
    open_hit = out.result.open_idx[:, 0].cpu().numpy() == src
    std_hit = out.result.std_idx[:, 0].cpu().numpy() == src
    log(f"[main] open-search recall@1:     {open_hit.mean():.3f} "
        f"(modified queries: {open_hit[mod].mean():.3f})")
    log(f"[main] standard-search recall@1: {std_hit.mean():.3f} "
        f"(modified queries: {std_hit[mod].mean():.3f})")
    n_id = pipe.identifications(out)
    log(f"[main] identifications @ {cfg.fdr_threshold:.0%} FDR: {n_id} / "
        f"{Q * cfg.top_k}")
    log(f"[main] launches: {json.dumps(launches)}")

    r = out.result
    for f in r._fields:
        t = getattr(r, f)
        require(tuple(t.shape) == (Q, cfg.top_k) and t.dtype == torch.int32,
                f"SearchResult.{f} has shape {tuple(t.shape)} {t.dtype}")
    for f in ("std_sim", "open_sim"):
        t = getattr(r, f)
        require(bool(((t >= -1) & (t <= cfg.dim)).all()), f"{f} out of range")
    for f in ("std_idx", "open_idx"):
        t = getattr(r, f)
        require(bool(((t >= -1) & (t < 2 * pipe.n_targets)).all()),
                f"{f} out of range")
    for fd in (out.open_fdr, out.std_fdr):
        require(bool(torch.isfinite(fd.q_values).all()
                     & (fd.q_values >= 0).all() & (fd.q_values <= 1).all()),
                "q-values not finite in [0, 1]")
    require(n_id > 0 and np.isfinite(open_hit.mean()), "no identifications")
    for name, n in launches.items():
        require(n > 0, f"the main path launched the {name} kernel {n} times")
    return pipe, hvs, q_pmz, q_charge, launches, out


def check_blocks(torch, pipe, hvs, q_pmz, q_charge):
    """FUSED_CHECK_BLOCKS evenly spaced query blocks of the main path: the
    search params, the fused-kernel arguments restricted to those blocks,
    and the rows each block scans."""
    import numpy as np
    params, qh, qp, qc, starts = sorted_batch(torch, pipe, hvs, q_pmz, q_charge)
    QB = params.q_block
    nqb = starts.shape[0]
    pick = np.unique(np.linspace(0, nqb - 1, FUSED_CHECK_BLOCKS).astype(np.int64))
    rows = (pick[:, None] * QB + np.arange(QB)[None, :]).reshape(-1)
    rows_t = torch.from_numpy(rows).to(qh.device)
    db = pipe.db
    args = (qh[rows_t].contiguous(), qp[rows_t].contiguous(), qc[rows_t].contiguous(),
            db.hvs, db.pmz, db.charge,
            starts[torch.from_numpy(pick).to(qh.device)].contiguous())
    return params, args, pick, params.k_blocks * db.max_r


def phase_fused_check(torch, pipe, hvs, q_pmz, q_charge) -> int:
    from repro_torch.kernels.hamming import ops, ref
    params, args, pick, rk = check_blocks(torch, pipe, hvs, q_pmz, q_charge)
    QB = params.q_block
    db = pipe.db
    for k in (1, 4):
        kw = dict(q_block=QB, rk=rk, dim=pipe.cfg.dim, k=k,
                  ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
        got = ops.fused_search(*args, **kw)
        torch.cuda.synchronize()
        want = ref.fused_search(*args, **kw)
        for name, g, w in zip(("std_sim", "std_row", "open_sim", "open_row"), got, want):
            require(equal(g, w), f"fused_search kernel differs from plain ({name}, k={k})")
        log(f"[check] fused_search kernel == plain on {len(pick)} main-path query "
            f"blocks x {rk} rows at k={k}: bit-identical "
            f"(in-window open winners: {int((want[3] >= 0).sum())})")
    # A word count that is not a multiple of 4 takes the scalar-load variant.
    narrow = (args[0][:, :NARROW_W].contiguous(), *args[1:3],
              db.hvs[:, :NARROW_W].contiguous(), *args[4:])
    kw = dict(q_block=QB, rk=rk, dim=32 * NARROW_W, k=4,
              ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
    got = ops.fused_search(*narrow, **kw)
    torch.cuda.synchronize()
    want = ref.fused_search(*narrow, **kw)
    for name, g, w in zip(("std_sim", "std_row", "open_sim", "open_row"), got, want):
        require(equal(g, w), f"fused_search kernel differs from plain ({name}, "
                f"W={NARROW_W})")
    log(f"[check] fused_search kernel == plain at W = {NARROW_W} words (scalar "
        f"loads), k=4: bit-identical")
    return len(pick)


FUSED_OUTS = ("std_sim", "std_row", "open_sim", "open_row")


def _fused_pair_check(torch, what, args, kw) -> None:
    """Both fused kernels against their plain versions at every k of
    FUSED_GROUP_KS."""
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming import ref as href
    from repro_torch.kernels.hamming_mxu import ops as mops
    from repro_torch.kernels.hamming_mxu import ref as mref
    for k in FUSED_GROUP_KS:
        kk = dict(kw, k=k)
        for name, kern, plain in (("fused_search", hops, href), ("fused_search_mxu", mops, mref)):
            got = kern.fused_search(*args, **kk)
            torch.cuda.synchronize()
            want = plain.fused_search(*args, **kk)
            for out, g, w in zip(FUSED_OUTS, got, want):
                require(equal(g, w), f"{name} kernel differs from plain ({out}, k={k}) "
                        f"on {what}")


def union_stats(starts, rk: int, n_rows: int) -> tuple[float, float]:
    """(mean, max) over the fused kernels' CTA groups of union rows / rk."""
    from repro_torch.kernels.hamming import ops as hops
    span = hops.group_spans(starts, rk, n_rows)
    u = (span[:, 1] - span[:, 0]).double() / rk
    return float(u.mean()), float(u.max())


def phase_fused_groups(torch, pipe, hvs, q_pmz, q_charge) -> None:
    """The grouped fused kernels on runs of consecutive main-path blocks:
    groups of 8 tiles form, the last group of each run is partial, and the
    second run's start rows differ (masks inside a group's union)."""
    params, qh, qp, qc, starts = sorted_batch(torch, pipe, hvs, q_pmz, q_charge)
    db, QB = pipe.db, params.q_block
    rk = params.k_blocks * db.max_r
    nqb = starts.shape[0]
    kw = dict(q_block=QB, rk=rk, dim=pipe.cfg.dim, ppm_tol=params.ppm_tol,
              open_tol_da=params.open_tol_da)
    # A run from block 0 and, after it, the first run whose start rows are
    # not all equal (a group whose union is wider than rk).
    st = starts.cpu()
    shifted = next((b for b in range(FUSED_GROUP_RUN, nqb - FUSED_GROUP_RUN + 1)
                    if st[b + FUSED_GROUP_RUN - 1] > st[b]), nqb // 2)
    for b0 in (0, shifted):
        blocks = slice(b0, min(b0 + FUSED_GROUP_RUN, nqb))
        rows = slice(blocks.start * QB, blocks.stop * QB)
        run_starts = starts[blocks].contiguous()
        args = (qh[rows].contiguous(), qp[rows].contiguous(), qc[rows].contiguous(),
                db.hvs, db.pmz, db.charge, run_starts)
        _fused_pair_check(torch, f"blocks {blocks.start}..{blocks.stop - 1}", args, kw)
        u_mean, u_max = union_stats(run_starts, rk, db.n_rows)
        log(f"[check] fused_search and fused_search_mxu kernels == plain on "
            f"{blocks.stop - blocks.start} consecutive main-path blocks "
            f"({blocks.start}..{blocks.stop - 1}) x {rk} rows at k = "
            f"{', '.join(map(str, FUSED_GROUP_KS))}: bit-identical (groups' "
            f"union/rk mean {u_mean:.4f}, max {u_max:.4f})")


def fused_edge_inputs(torch, g, n_rows: int, W: int, starts, rk: int, q_block: int):
    """Seeded synthetic fused-search arguments: rows drawn from 8 HVs (ties),
    ascending pmz with a PAD tail, queries copied from rows of their block's
    range or random, near those rows' pmz (std-window hits), one padded
    query per block."""
    pool = random_words(torch, g, 8, W)
    r = pool[torch.randint(0, 8, (n_rows,), generator=g, device=DEVICE)]
    rp = torch.sort(torch.rand(n_rows, generator=g, device=DEVICE) * 20 + 400).values
    rc = torch.randint(2, 4, (n_rows,), generator=g, device=DEVICE, dtype=torch.int32)
    rp[-6:] = float(torch.finfo(torch.float32).max)
    rc[-6:] = -1
    st = torch.tensor(starts, dtype=torch.int32, device=DEVICE)
    Q = st.shape[0] * q_block
    src = torch.clamp(st.repeat_interleave(q_block).long()
                      + torch.randint(0, rk, (Q,), generator=g, device=DEVICE), max=n_rows - 7)
    q = r[src].clone()
    q[1::3] = random_words(torch, g, q[1::3].shape[0], W)
    qp = rp[src] + (torch.rand(Q, generator=g, device=DEVICE) - 0.5) * 1.2
    qp[::4] = rp[src][::4]
    qc = rc[src].clone()
    qc[q_block - 1::q_block] = -(2 ** 30)
    return (q, qp.contiguous(), qc, r, rp, rc, st)


def phase_fused_edges(torch) -> None:
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    for what, n_rows, W, starts, rk, q_block in FUSED_EDGE_CASES:
        args = fused_edge_inputs(torch, g, n_rows, W, starts, rk, q_block)
        _fused_pair_check(torch, what, args, dict(q_block=q_block, rk=rk, dim=32 * W))
    log(f"[check] fused_search and fused_search_mxu kernels == plain at the grouped "
        f"design's edges ({'; '.join(c[0] for c in FUSED_EDGE_CASES)}) at k = "
        f"{', '.join(map(str, FUSED_GROUP_KS))}, tie-heavy rows: bit-identical")


# ---------------------------------------------------------------------------
# Phase 4: path against path
# ---------------------------------------------------------------------------


def _outputs_equal(a, b) -> bool:
    same = all(equal(getattr(a.result, f), getattr(b.result, f))
               for f in a.result._fields)
    for fa, fb in ((a.open_fdr, b.open_fdr), (a.std_fdr, b.std_fdr)):
        same = same and all(equal(getattr(fa, f), getattr(fb, f))
                            for f in fa._fields)
    return same


def phase_paths(torch, pipe, ds):
    import dataclasses

    import numpy as np
    from repro_torch.core import encode_backends
    from repro_torch.core.pipeline import OMSConfig, OMSPipeline
    from repro_torch.data.spectra import LibraryConfig, SpectraSet, make_dataset

    n = PATH_CHECK_QUERIES
    sub = SpectraSet(*(x[:n] for x in ds.queries))
    plain_pipe_cfg = dataclasses.replace(pipe.cfg, encode_backend="word_tiled")
    kern_hvs, kqp, kqc = pipe.encode_queries(sub)
    plain_hvs, pqp, pqc = encode_backends.preprocess_encode(
        sub.mz, sub.intensity, sub.pmz, sub.charge, pipe.codebooks,
        plain_pipe_cfg.preprocess_params, backend="word_tiled",
        batch=plain_pipe_cfg.encode_batch)
    require(equal(kern_hvs, plain_hvs) and equal(kqp, pqp) and equal(kqc, pqc),
            "query HVs differ between pallas and word_tiled")
    kern = pipe.search_encoded(kern_hvs, kqp, kqc, backend="fused")
    plain = pipe.search_encoded(plain_hvs, pqp, pqc, backend="vpu")
    torch.cuda.synchronize()
    require(_outputs_equal(kern, plain),
            "(fused, pallas) and (vpu, word_tiled) disagree on the full DB")
    log(f"[paths] {n} queries: (fused, pallas) == (vpu, word_tiled) against the "
        f"full DB — 6 SearchResult arrays and both FDR results identical "
        f"(open identifications {int(kern.open_fdr.n_accepted)})")

    # Re-encode a library slice with word_tiled; find the same rows in the DB.
    lib = SpectraSet(*(x[:SLICE_ROWS] for x in ds.refs))
    hv, _, _ = encode_backends.preprocess_encode(
        lib.mz, lib.intensity, lib.pmz, lib.charge, pipe.codebooks,
        pipe.cfg.preprocess_params, backend="word_tiled", batch=512)
    orig = pipe.db.orig_idx
    rows = torch.nonzero((orig >= 0) & (orig < SLICE_ROWS)).reshape(-1)
    rows = rows[torch.argsort(orig[rows])]
    require(equal(pipe.db.hvs[rows], hv),
            "library HVs built by the hdencode kernel differ from word_tiled")
    log(f"[paths] {SLICE_ROWS}-row library slice: kernel-built DB rows == "
        f"word_tiled re-encode")

    # A small dataset: kernels on the card against plain versions on the CPU.
    small = make_dataset(LibraryConfig(n_refs=1024, n_queries=64, seed=SEED + 1))
    cfg = OMSConfig(dim=1024, bin_size=0.5, max_r=256, top_k=2)
    on_card = OMSPipeline(dataclasses.replace(cfg, backend="fused",
                                              encode_backend="pallas"),
                          small.refs, device=DEVICE)
    on_cpu = OMSPipeline(cfg, small.refs, device="cpu")
    a = on_card.search(small.queries)
    b = on_cpu.search(small.queries)
    same_db = all(equal(getattr(on_card.db, f).cpu(), getattr(on_cpu.db, f))
                  for f in ("hvs", "pmz", "charge", "is_decoy", "orig_idx"))
    a_cpu = type(a)(*(type(x)(*(t.cpu() for t in x)) for x in a))
    require(same_db and _outputs_equal(a_cpu, b),
            "small dataset: card kernels disagree with CPU plain versions")
    hit = np.mean(a.result.open_idx[:, 0].cpu().numpy() == small.query_source)
    log(f"[paths] small dataset (1024 refs, 64 queries, dim 1024, top_k 2): card "
        f"(fused, pallas) == CPU (vpu, word_tiled); open recall@1 {hit:.3f}")


# ---------------------------------------------------------------------------
# Phase 5: times and bounds
# ---------------------------------------------------------------------------


def phase_times(torch, env, pipe, hvs, q_pmz, q_charge, launches, ds):
    from repro_torch.core import encode_backends
    from repro_torch.data.spectra import SpectraSet
    from repro_torch.kernels.hamming import ops as fs_ops
    from repro_torch.kernels.hamming import ref as fs_ref
    from repro_torch.kernels.hdencode import ops as hd_ops
    from repro_torch.kernels.hdencode import ref as hd_ref
    import numpy as np

    from repro_torch.utils import roofline
    card = dict(clock_hz=env["clock_hz"], n_sms=env["n_sms"])
    cb = pipe.codebooks
    W = cb.id_hvs.shape[1]

    # hdencode at its main-path launch shape: one ENCODE_BATCH of library
    # spectra, preprocessed as the ingest does.
    lib = SpectraSet(*(x[:ENCODE_BATCH] for x in ds.refs))
    pre = encode_backends._preprocess(
        *(torch.as_tensor(x, device=DEVICE) for x in lib), pipe.cfg.preprocess_params)
    hd_args = (pre.bins, pre.levels, pre.mask, cb.id_hvs, cb.level_hvs, cb.tiebreak)
    hd_out = hd_ops.hdencode(*hd_args)
    hd_plain = hd_ref.hdencode(*hd_args)
    require(equal(hd_out, hd_plain), "hdencode timing shape: kernel != plain")
    hd_ms = cuda_ms(lambda: hd_ops.hdencode(*hd_args))
    hd_device_ms = graph_ms(lambda: hd_ops.hdencode(*hd_args))
    hd_plain_ms = cuda_ms(lambda: hd_ref.hdencode(*hd_args))
    B, P = pre.bins.shape
    n_valid = int(pre.mask.sum())
    # The least work the function needs (roofline.hdencode_roofline): the
    # bind XOR and bit-sliced counter adds per valid peak word, the
    # majority compare per output word; the peaks, the codebook rows this
    # batch touches, the tiebreak and the output moved once.
    valid_bins = torch.unique(pre.bins[pre.mask]).numel()
    valid_levels = torch.unique(pre.levels[pre.mask]).numel()
    hd_roof = roofline.hdencode_roofline(B, P, W, n_valid, valid_bins + valid_levels,
                                         **card)
    hd_ops_s, hd_bytes_s = hd_roof.t_compute, hd_roof.t_memory
    hd_bound = hd_roof.t_bound * 1e3
    hd_by = hd_roof.bound_by
    # What the kernel gathers: one ID row and one level row per valid peak
    # (served by L2 and L1, not HBM: the touched codebook rows fit in L2).
    hd_gather = 2 * n_valid * W * 4

    # fused_search on the whole main-path batch, kernel and plain version.
    params, qh, qp, qc, starts = sorted_batch(torch, pipe, hvs, q_pmz, q_charge)
    db = pipe.db
    rk = params.k_blocks * db.max_r
    nqb = starts.shape[0]
    fs_args = (qh, qp, qc, db.hvs, db.pmz, db.charge, starts)
    kw = dict(q_block=params.q_block, rk=rk, dim=pipe.cfg.dim, k=params.top_k,
              ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
    fs_ms = cuda_ms(lambda: fs_ops.fused_search(*fs_args, **kw))
    # The plain version materialises a (16, rk, W) tile per block (~20 s a
    # batch): its comparison call is its warm-up, then a few timed runs.
    fs_err = max_abs_err(zip(fs_ops.fused_search(*fs_args, **kw),
                             fs_ref.fused_search(*fs_args, **kw)))
    require(fs_err == 0, "fused_search on the whole main-path batch: kernel != plain")
    fs_plain_ms = cuda_ms(lambda: fs_ref.fused_search(*fs_args, **kw),
                          iters=FUSED_PLAIN_ITERS, warmup=False)
    pairs = qh.shape[0] * rk
    # Operations: the cheapest of three routes to the same Hamming tiles
    # (roofline.hamming_routes: popc, int8 +-1 dot, binary tensor cores);
    # bytes: the rows the blocks cover, the queries, the outputs.
    routes = {name: ops / rate for name, (ops, rate) in roofline.hamming_routes(
        pairs, W, pipe.cfg.dim, **card).items()}
    u_mean, u_max = union_stats(starts, rk, db.n_rows)
    scanned = torch.unique(starts).cpu().numpy()
    covered = np.zeros(db.n_rows, bool)
    for s in scanned:
        covered[s:s + rk] = True
    fs_roof = roofline.fused_roofline(qh.shape[0], rk, int(covered.sum()), W,
                                      pipe.cfg.dim, params.top_k, nqb, **card)
    fs_bytes_s = fs_roof.t_memory
    fs_bound = fs_roof.t_bound * 1e3
    fs_by = fs_roof.bound_by
    fs_route = fs_roof.route if fs_by == "operations" else "HBM"
    log(f"[times] hdencode ({B} x {P} peaks, {n_valid} valid, {valid_bins} bins "
        f"touched, dim {cb.dim}): kernel {hd_ms:.4f} ms (device {hd_device_ms:.4f} ms "
        f"in a graph), plain {hd_plain_ms:.4f} ms, bound {hd_bound:.4f} ms "
        f"({hd_by}; ops {hd_ops_s * 1e3:.4f} ms, bytes "
        f"{hd_bytes_s * 1e3:.4f} ms); gathered ID + level rows {hd_gather / 1e6:.1f} "
        f"MB from L2/L1, {hd_gather / (hd_device_ms * 1e-3) / 1e12:.2f} TB/s of "
        f"device time")
    log(f"[times] fused_search ({qh.shape[0]} queries, {nqb} blocks x {rk} rows, "
        f"{pairs:.4e} pairs; groups' union/rk mean {u_mean:.4f}, max {u_max:.4f}): "
        f"kernel {fs_ms:.3f} ms, plain {fs_plain_ms:.1f} ms (median of "
        f"{FUSED_PLAIN_ITERS}), bound {fs_bound:.3f} ms ({fs_by}, {fs_route}; "
        + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in routes.items())
        + f", bytes {fs_bytes_s * 1e3:.3f} ms)")

    return [
        {"name": "hdencode", "route": "cuda",
         "source": "src/repro_torch/kernels/hdencode/csrc/hdencode.cu",
         "replaces": "src/repro/kernels/hdencode/hdencode.py:46",
         "tpu_kernel": "hdencode_kernel", "launches": launches["hdencode"],
         "bit_identical": True, "max_abs_err": max_abs_err([(hd_out, hd_plain)]),
         "ms": hd_ms, "device_ms": hd_device_ms, "plain_ms": hd_plain_ms,
         "bound_ms": hd_bound, "bound_by": hd_by, "library_ms": None,
         "shape": f"{B}x{P} peaks, dim {cb.dim}", "gather_bytes": hd_gather},
        {"name": "fused_search", "route": "cuda",
         "source": "src/repro_torch/kernels/hamming/csrc/fused_search.cu",
         "replaces": "src/repro/kernels/hamming/hamming.py:102",
         "tpu_kernel": "fused_search_kernel", "launches": launches["fused_search"],
         "bit_identical": True, "max_abs_err": fs_err,
         "ms": fs_ms, "plain_ms": fs_plain_ms, "bound_ms": fs_bound,
         "bound_by": fs_by, "bound_route": fs_route, "library_ms": None,
         "shape": f"{qh.shape[0]} queries x {rk} rows, k={params.top_k}",
         "route_bounds_ms": {k: max(v, fs_bytes_s) * 1e3 for k, v in routes.items()},
         "union_over_rk": {"mean": u_mean, "max": u_max}},
    ]


# ---------------------------------------------------------------------------
# Phase 6: the tile kernels and fused_search_mxu against their plain versions
# ---------------------------------------------------------------------------


def _block_pairs(pipe, params, args, rk):
    """(queries, scanned rows) of every checked main-path block."""
    QB = params.q_block
    qh, starts = args[0], args[6]
    return [(qh[b * QB:(b + 1) * QB], pipe.db.hvs[s:s + rk])
            for b, s in enumerate(starts.tolist())]


def plain_tile(q, r, dim=None):
    """The plain popc tile, row-chunked so that a bucket-sized row set fits
    (its columns are independent)."""
    import torch
    from repro_torch.kernels.hamming import ref as href
    return torch.cat([href.hamming_matrix(q, r[i:i + PLAIN_TILE_ROWS])
                      for i in range(0, r.shape[0], PLAIN_TILE_ROWS)], dim=1)


def random_words(torch, g, n: int, w: int):
    """(n, w) packed words, uniform over all 32-bit patterns."""
    return torch.randint(0, 2 ** 32, (n, w), generator=g, device=DEVICE,
                         dtype=torch.int64).to(torch.int32)


def phase_tile_edges(torch) -> None:
    """hamming_matrix and hamming_mxu (dim 32 * W) at the shapes the main
    path does not give them. The first query and reference row are all
    ones and the second row all zeros, the extremes of |q| and |r|."""
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming_mxu import ops as mops
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    for Q, R, W, off in TILE_EDGE_SHAPES:
        q = random_words(torch, g, Q, W)
        base = random_words(torch, g, R * W + off, 1).reshape(-1)
        r = base[off:].reshape(R, W)
        q[0] = -1
        r[0] = -1
        r[1:2] = 0
        require(r.is_contiguous() and (off == 0 or r.data_ptr() % 16 != 0),
                "tile edge case: the row slice is not where the case needs it")
        vpu, mxu = hops.hamming_matrix(q, r), mops.hamming_matrix(q, r, 32 * W)
        torch.cuda.synchronize()
        want = plain_tile(q, r)
        where = f"at Q = {Q}, R = {R}, W = {W}, row offset {off} words"
        require(equal(vpu, want), f"hamming_matrix kernel differs from plain {where}")
        require(equal(mxu, want), f"hamming_mxu kernel differs from plain {where}")
    log(f"[check] hamming_matrix and hamming_mxu kernels == plain at (Q, R, W, row "
        f"offset in words) {', '.join(str(c) for c in TILE_EDGE_SHAPES)}: bit-identical")


def phase_tile_check(torch, env, pipe, hvs, q_pmz, q_charge) -> dict:
    import numpy as np
    from repro_torch.core import packing, search
    from repro_torch.utils import roofline
    card = dict(clock_hz=env["clock_hz"], n_sms=env["n_sms"])
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming import ref as href
    from repro_torch.kernels.hamming_mxu import ops as mops
    from repro_torch.kernels.hamming_mxu import ref as mref
    params, args, pick, rk = check_blocks(torch, pipe, hvs, q_pmz, q_charge)
    W = pipe.db.hvs.shape[1]
    for w in (W, *TILE_CHECK_W):
        for q, r in _block_pairs(pipe, params, args, rk):
            q, r = q[:, :w].contiguous(), r[:, :w].contiguous()
            vpu, mxu = hops.hamming_matrix(q, r), mops.hamming_matrix(q, r, 32 * w)
            torch.cuda.synchronize()
            want = href.hamming_matrix(q, r)
            require(equal(vpu, want), f"hamming_matrix kernel differs from plain "
                    f"at W = {w}")
            require(equal(mxu, mref.hamming_matrix(q, r, 32 * w)) and equal(mxu, want),
                    f"hamming_mxu kernel differs from plain at W = {w}")
        log(f"[check] hamming_matrix and hamming_mxu kernels == plain on "
            f"{len(pick)} main-path query blocks ({q.shape[0]} x {r.shape[0]} at "
            f"W = {w}, dim {32 * w}): bit-identical")
    # The seed pass and the survivor rescore score each query block against
    # every real row, gathered in ascending order and padded to the bucket.
    dim = pipe.cfg.dim
    rows = np.flatnonzero(pipe.db.orig_idx.cpu().numpy() >= 0)
    r = search._gather_rows(pipe.db, rows)[0]
    require(r.shape[0] == search.row_bucket(rows.size), "bucket gather shape")
    QB = params.q_block
    for b in np.linspace(0, len(pick) - 1, BUCKET_CHECK_BLOCKS).astype(np.int64):
        q = args[0][b * QB:(b + 1) * QB].contiguous()
        vpu, mxu = hops.hamming_matrix(q, r), mops.hamming_matrix(q, r, dim)
        torch.cuda.synchronize()
        want = plain_tile(q, r)
        require(equal(vpu, want), "hamming_matrix kernel differs from plain on "
                "the row bucket")
        require(equal(mxu, want), "hamming_mxu kernel differs from plain on the "
                "row bucket")
        del vpu, mxu, want
    log(f"[check] hamming_matrix and hamming_mxu kernels == plain on "
        f"{BUCKET_CHECK_BLOCKS} main-path query blocks x the cascade's "
        f"{r.shape[0]}-row bucket ({rows.size} real rows gathered) at "
        f"W = {r.shape[1]}: bit-identical")
    # hamming_matrix at the bucket shape, as the seed pass and the survivor
    # rescore launch it; bound: the rows and queries read once, the tile
    # written once.
    Rb, Wb = r.shape
    bucket = {"ms": cuda_ms(lambda: hops.hamming_matrix(q, r)),
              "mxu_ms": cuda_ms(lambda: mops.hamming_matrix(q, r, dim)),
              "bound_ms": roofline.tile_roofline(
                  QB, Rb, Wb, dim, **card).t_bound * 1e3,
              "shape": f"{QB} x {Rb} x {Wb}"}
    # Library yardstick at the bucket shape: one torch._int_mm on +-1 int8
    # operands unpacked beforehand (not timed; B 17.2 GB, unpacked in row
    # chunks, multiplied in one call), A padded to the 32 rows its shape
    # rules want.
    a8 = torch.zeros((32, dim), dtype=torch.int8, device=DEVICE)
    a8[:QB] = packing.packed_to_pm1(q)
    b8 = torch.empty((Rb, dim), dtype=torch.int8, device=DEVICE)
    for i in range(0, Rb, PLAIN_TILE_ROWS):
        b8[i:i + PLAIN_TILE_ROWS] = packing.packed_to_pm1(r[i:i + PLAIN_TILE_ROWS])
    dot = torch._int_mm(a8, b8.t())
    require(equal((dim - dot[:QB]) // 2, mops.hamming_matrix(q, r, dim)),
            "torch._int_mm yardstick != hamming_mxu on the row bucket")
    del dot
    bucket["library_ms"] = cuda_ms(lambda: torch._int_mm(a8, b8.t()))
    del a8, b8
    log(f"[times] at the cascade's bucket shape ({bucket['shape']} words): "
        f"hamming_matrix kernel {bucket['ms']:.4f} ms, hamming_mxu kernel "
        f"{bucket['mxu_ms']:.4f} ms, bound {bucket['bound_ms']:.4f} ms (bytes), "
        f"torch._int_mm {bucket['library_ms']:.4f} ms")
    del r
    for k in (1, 4):
        kw = dict(q_block=params.q_block, rk=rk, dim=pipe.cfg.dim, k=k,
                  ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
        got = mops.fused_search(*args, **kw)
        torch.cuda.synchronize()
        want = mref.fused_search(*args, **kw)
        for name, g, w in zip(("std_sim", "std_row", "open_sim", "open_row"), got, want):
            require(equal(g, w), f"fused_search_mxu kernel differs from plain "
                    f"({name}, k={k})")
        log(f"[check] fused_search_mxu kernel == plain on {len(pick)} main-path "
            f"query blocks x {rk} rows at k={k}: bit-identical")
    # A word count that is not a multiple of 4 takes the scalar-load variant.
    db = pipe.db
    narrow = (args[0][:, :NARROW_W].contiguous(), *args[1:3],
              db.hvs[:, :NARROW_W].contiguous(), *args[4:])
    kw = dict(q_block=QB, rk=rk, dim=32 * NARROW_W, k=4,
              ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
    got = mops.fused_search(*narrow, **kw)
    torch.cuda.synchronize()
    want = mref.fused_search(*narrow, **kw)
    for name, g, w in zip(("std_sim", "std_row", "open_sim", "open_row"), got, want):
        require(equal(g, w), f"fused_search_mxu kernel differs from plain "
                f"({name}, W={NARROW_W})")
    log(f"[check] fused_search_mxu kernel == plain at W = {NARROW_W} words "
        f"(dim {32 * NARROW_W}, scalar loads), k=4: bit-identical")
    return bucket


# ---------------------------------------------------------------------------
# Phase 7: fused_search_mxu against fused_search on the whole batch
# ---------------------------------------------------------------------------


def phase_fused_mxu_batch(torch, pipe, hvs, q_pmz, q_charge) -> None:
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming_mxu import ops as mops
    params, qh, qp, qc, starts = sorted_batch(torch, pipe, hvs, q_pmz, q_charge)
    db = pipe.db
    rk = params.k_blocks * db.max_r
    args = (qh, qp, qc, db.hvs, db.pmz, db.charge, starts)
    for k in (1, 4):
        kw = dict(q_block=params.q_block, rk=rk, dim=pipe.cfg.dim, k=k,
                  ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
        popc, mxu = hops.fused_search(*args, **kw), mops.fused_search(*args, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("std_sim", "std_row", "open_sim", "open_row"), popc, mxu):
            require(equal(a, b), f"fused_mxu differs from fused on the whole "
                    f"batch ({name}, k={k})")
        log(f"[check] fused_search_mxu == fused_search on the whole batch "
            f"({starts.shape[0]} blocks x {rk} rows) at k={k}: all four "
            f"({qh.shape[0]}, {k}) arrays bit-identical")


# ---------------------------------------------------------------------------
# Phase 8: the kernel backends end to end
# ---------------------------------------------------------------------------


def _counters():
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming_mxu import ops as mops
    return {"hamming_matrix": hops.matrix_launches, "hamming_mxu": mops.matrix_launches,
            "fused_search_mxu": mops.launches, "fused_search": hops.launches}


def _counted(torch, fn):
    """Run ``fn`` with every tile/fused launch count set to 0 just before;
    returns (result, seconds to the device's end, counts read just after)."""
    counters = _counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    return out, t, {n: c.count for n, c in counters.items()}


def phase_backends(torch, pipe, hvs, q_pmz, q_charge, fused_out) -> dict:
    Q = hvs.shape[0]
    launches = {}
    for be, kernel in BACKEND_KERNELS.items():
        out, t_first, counts = _counted(
            torch, lambda: pipe.search_encoded(hvs, q_pmz, q_charge, backend=be))
        t0 = time.perf_counter()
        pipe.search_encoded(hvs, q_pmz, q_charge, backend=be)
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        require(_outputs_equal(out, fused_out), f"backend {be} differs from fused "
                f"on the full batch")
        require(counts[kernel] > 0, f"backend {be} launched {kernel} "
                f"{counts[kernel]} times")
        launches[kernel] = counts[kernel]
        log(f"[backends] {be}: 6 SearchResult arrays and both FDR results == "
            f"fused on {Q} queries; first {t_first:.3f}s, warm {t_warm:.3f}s "
            f"({Q / t_warm:.0f} queries/s); launches {json.dumps(counts)}")
    return launches


# ---------------------------------------------------------------------------
# Phase 9: the dimension cascade
# ---------------------------------------------------------------------------


def _stats_line(stats, n_real) -> str:
    return (f"seed rows {stats['seed_rows']} (bucket {stats['seed_bucket']}), "
            f"survivors {stats['survivors']} of {n_real} real rows "
            f"({stats['survivors'] / n_real:.4f}; bucket "
            f"{stats['survivor_bucket']}); stages seed {stats['seed_s']:.2f}s, "
            f"prefix {stats['prefix_s']:.2f}s, rescore {stats['rescore_s']:.2f}s")


def _tile_shapes(kernel: str, fn):
    """Run ``fn`` with the ``kernel`` tile wrapper wrapped to tally the
    (rows, words) of every call; returns (fn's result, the tally)."""
    import collections
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming_mxu import ops as mops
    mod = hops if kernel == "hamming_matrix" else mops
    orig, shapes = mod.hamming_matrix, collections.Counter()

    def tallied(q, r, *rest, **kw):
        shapes[f"{r.shape[0]} x {r.shape[1]}"] += 1
        return orig(q, r, *rest, **kw)
    mod.hamming_matrix = tallied
    try:
        return fn(), dict(shapes)
    finally:
        mod.hamming_matrix = orig


def phase_cascade(torch, pipe, hvs, q_pmz, q_charge, fused_out) -> None:
    Q = hvs.shape[0]
    n_real = int((pipe.db.orig_idx >= 0).sum())
    for P in CASCADE_PREFIX_WORDS:
        for be, kernel in CASCADE_TILES.items():
            stats = {}
            (out, t, counts), shapes = _tile_shapes(kernel, lambda: _counted(
                torch, lambda: pipe.search_encoded(hvs, q_pmz, q_charge, backend=be,
                                                   prefix_words=P, stats=stats)))
            require(_outputs_equal(out, fused_out), f"cascade prefix_words={P} "
                    f"backend={be} differs from the full-width fused search")
            require(counts[kernel] > 0, f"cascade backend {be} launched {kernel} "
                    f"{counts[kernel]} times")
            log(f"[cascade] prefix_words={P} ({32 * P} bits) backend={be}, exact: "
                f"== full-width fused on {Q} queries in {t:.2f}s; "
                f"{_stats_line(stats, n_real)}; launches {json.dumps(counts)}; "
                f"{kernel} launches by rows x words {json.dumps(shapes)}")


def phase_cascade_margin(torch, pipe, hvs, q_pmz, q_charge) -> None:
    """Margin mode prunes. First the stage-A keep flags of the whole batch,
    from the full scan's exact thresholds, through each kernel tile against
    the plain tile; then margin-mode searches, whose survivors are a strict
    subset, gathered and rescored: every kernel backend must equal a run
    whose prefix and rescore tiles are the plain version."""
    from repro_torch.core import backends, search
    from repro_torch.kernels.hamming import ops as hops
    backends.register(PLAIN_TILE_BACKEND, backends.MATRIX, plain_tile)
    params, qh, qp, qc, starts = sorted_batch(torch, pipe, hvs, q_pmz, q_charge)
    db, dim = pipe.db, pipe.cfg.dim
    n_real = int((db.orig_idx >= 0).sum())
    run = hops.fused_search(qh, qp, qc, db.hvs, db.pmz, db.charge, starts,
                            q_block=params.q_block, rk=params.k_blocks * db.max_r,
                            dim=dim, k=params.top_k, ppm_tol=params.ppm_tol,
                            open_tol_da=params.open_tol_da)
    thr_std, thr_open = search.kth_thresholds(run, params.top_k)
    for P in CASCADE_PREFIX_WORDS:
        margin = (dim - 32 * P) // 2
        flags = {}
        for be in (PLAIN_TILE_BACKEND, "kernel_vpu", "fused_mxu"):
            p = params._replace(backend=be, prefix_words=P, prefix_margin=margin)
            flags[be] = search._prefix_flags(db, pipe.prefix_hvs(P),
                                             qh[:, :P].contiguous(), qp, qc,
                                             thr_std, thr_open, params=p, dim=dim)
        kept = int(flags[PLAIN_TILE_BACKEND].sum())
        require(0 < kept < n_real, f"stage-A flags at prefix_words={P} keep "
                f"{kept} of {n_real} rows: the check needs a strict subset")
        for be in ("kernel_vpu", "fused_mxu"):
            require(equal(flags[be], flags[PLAIN_TILE_BACKEND]), f"stage-A flags "
                    f"at prefix_words={P} through {be}'s tile differ from the "
                    f"plain tile")
        log(f"[cascade] stage-A flags, prefix_words={P} margin={margin}, "
            f"{starts.shape[0]} blocks, exact thresholds: kernel_vpu and fused_mxu "
            f"tiles == plain tile; {kept} of {n_real} rows kept")
    del run, flags
    n = MARGIN_QUERIES
    sub = (hvs[:n], q_pmz[:n], q_charge[:n])
    for P in CASCADE_PREFIX_WORDS:
        margin = (pipe.cfg.dim - 32 * P) // 2
        runs = {}
        for be in (PLAIN_TILE_BACKEND, *CASCADE_TILES):
            stats = {}
            out, t, counts = _counted(torch, lambda: pipe.search_encoded(
                *sub, backend=be, prefix_words=P, prefix_margin=margin,
                stats=stats))
            runs[be] = out, stats
            head = (f"[cascade] prefix_words={P} margin={margin} backend={be} on "
                    f"{n} queries in {t:.2f}s")
            if be == PLAIN_TILE_BACKEND:
                require(stats["survivors"] < n_real, f"margin-mode cascade at "
                        f"prefix_words={P} kept every row: nothing was pruned")
                log(f"{head} (plain tile): {_stats_line(stats, n_real)}")
                continue
            want, want_stats = runs[PLAIN_TILE_BACKEND]
            require(_outputs_equal(out, want) and stats["survivors"]
                    == want_stats["survivors"], f"margin-mode cascade at "
                    f"prefix_words={P} backend={be} differs from the plain tile")
            kernel = CASCADE_TILES[be]
            require(counts[kernel] > 0, f"cascade backend {be} launched {kernel} "
                    f"{counts[kernel]} times")
            log(f"{head}: == plain tile (6 SearchResult arrays, both FDR results, "
                f"survivor count); {_stats_line(stats, n_real)}; launches "
                f"{json.dumps(counts)}")


# ---------------------------------------------------------------------------
# Phase 10: times and bounds of the tile kernels and fused_search_mxu
# ---------------------------------------------------------------------------


def phase_times_mxu(torch, env, pipe, hvs, q_pmz, q_charge, launches,
                    fused_bound, bucket):
    from repro_torch.core import packing
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming import ref as href
    from repro_torch.kernels.hamming_mxu import ops as mops
    from repro_torch.kernels.hamming_mxu import ref as mref

    from repro_torch.utils import roofline
    dim = pipe.cfg.dim
    params, args, pick, rk = check_blocks(torch, pipe, hvs, q_pmz, q_charge)
    q, r = _block_pairs(pipe, params, args, rk)[0]
    Q, W = q.shape
    R = r.shape[0]
    tile = href.hamming_matrix(q, r)
    vpu_ms = cuda_ms(lambda: hops.hamming_matrix(q, r))
    vpu_device_ms = graph_ms(lambda: hops.hamming_matrix(q, r))
    vpu_plain_ms = cuda_ms(lambda: href.hamming_matrix(q, r))
    mxu_ms = cuda_ms(lambda: mops.hamming_matrix(q, r, dim))
    mxu_device_ms = graph_ms(lambda: mops.hamming_matrix(q, r, dim))
    mxu_plain_ms = cuda_ms(lambda: mref.hamming_matrix(q, r, dim))
    # Library yardstick: one int8 GEMM on operands unpacked beforehand
    # (not timed), A padded to the 32 rows its shape rules want.
    a8 = torch.zeros((32, dim), dtype=torch.int8, device=DEVICE)
    a8[:Q] = packing.packed_to_pm1(q)
    b8 = packing.packed_to_pm1(r).t()
    dot = torch._int_mm(a8, b8)
    require(equal((dim - dot[:Q]) // 2, tile), "torch._int_mm yardstick != tile")
    lib_ms = cuda_ms(lambda: torch._int_mm(a8, b8))
    lib_device_ms = graph_ms(lambda: torch._int_mm(a8, b8))
    del a8, b8, dot
    errs = {"hamming_matrix": max_abs_err([(hops.hamming_matrix(q, r), tile)]),
            "hamming_mxu": max_abs_err([(mops.hamming_matrix(q, r, dim), tile)])}
    # The least work for the tile (roofline.tile_roofline): read the rows
    # and queries once, write the tile once; operations by the cheaper route
    # (int8 +-1 dot or popc).
    t_roof = roofline.tile_roofline(Q, R, W, dim, clock_hz=env["clock_hz"],
                                    n_sms=env["n_sms"])
    t_bytes, t_ops = t_roof.t_memory, t_roof.t_compute
    t_bound = t_roof.t_bound * 1e3
    t_by = t_roof.bound_by

    params, qh, qp, qc, starts = sorted_batch(torch, pipe, hvs, q_pmz, q_charge)
    db = pipe.db
    fargs = (qh, qp, qc, db.hvs, db.pmz, db.charge, starts)
    kw = dict(q_block=params.q_block, rk=rk, dim=dim, k=params.top_k,
              ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
    fm_ms = cuda_ms(lambda: mops.fused_search(*fargs, **kw))
    fm_out = mops.fused_search(*fargs, **kw)
    # The plain version on the whole batch runs once: timed and compared.
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fm_plain = mref.fused_search(*fargs, **kw)
    end.record()
    torch.cuda.synchronize()
    fm_plain_ms = start.elapsed_time(end)
    fm_err = max_abs_err(zip(fm_out, fm_plain))
    require(fm_err == 0, "fused_search_mxu on the whole batch: kernel != plain")
    log(f"[times] hamming_matrix ({Q} x {R} x {W} words, one main-path block): "
        f"kernel {vpu_ms:.4f} ms (device {vpu_device_ms:.4f} ms in a graph), plain "
        f"{vpu_plain_ms:.3f} ms, bound {t_bound:.4f} ms ({t_by}; bytes "
        f"{t_bytes * 1e3:.4f} ms, ops {t_ops * 1e3:.4f} ms), torch._int_mm "
        f"{lib_ms:.4f} ms (device {lib_device_ms:.4f} ms)")
    log(f"[times] hamming_mxu (same block): kernel {mxu_ms:.4f} ms (device "
        f"{mxu_device_ms:.4f} ms), plain {mxu_plain_ms:.3f} ms, bound {t_bound:.4f} ms "
        f"({t_by})")
    log(f"[times] fused_search_mxu ({qh.shape[0]} queries, {starts.shape[0]} blocks "
        f"x {rk} rows, k={params.top_k}): kernel {fm_ms:.3f} ms, plain "
        f"{fm_plain_ms:.1f} ms (one run, compared bit for bit), bound "
        f"{fused_bound['bound_ms']:.3f} ms ({fused_bound['bound_by']}, "
        f"{fused_bound['bound_route']})")
    tile_shape = f"{Q} queries x {R} rows x {W} words (one main-path block)"
    return [
        {"name": "hamming_matrix", "route": "cuda",
         "source": "src/repro_torch/kernels/hamming/csrc/hamming_matrix.cu",
         "replaces": "src/repro/kernels/hamming/hamming.py:67",
         "tpu_kernel": "hamming_matrix_kernel",
         "launches": launches["hamming_matrix"], "bit_identical": True,
         "max_abs_err": errs["hamming_matrix"], "ms": vpu_ms,
         "device_ms": vpu_device_ms, "plain_ms": vpu_plain_ms, "bound_ms": t_bound,
         "bound_by": t_by, "library_ms": lib_ms, "library_device_ms": lib_device_ms,
         "shape": tile_shape,
         "bucket_ms": bucket["ms"], "bucket_bound_ms": bucket["bound_ms"],
         "bucket_library_ms": bucket["library_ms"], "bucket_shape": bucket["shape"]},
        {"name": "hamming_mxu", "route": "cuda",
         "source": "src/repro_torch/kernels/hamming_mxu/csrc/hamming_mxu.cu",
         "replaces": "src/repro/kernels/hamming_mxu/hamming_mxu.py:60",
         "tpu_kernel": "hamming_mxu_kernel",
         "launches": launches["hamming_mxu"], "bit_identical": True,
         "max_abs_err": errs["hamming_mxu"], "ms": mxu_ms,
         "device_ms": mxu_device_ms, "plain_ms": mxu_plain_ms, "bound_ms": t_bound,
         "bound_by": t_by, "library_ms": lib_ms, "library_device_ms": lib_device_ms,
         "shape": tile_shape,
         "bucket_ms": bucket["mxu_ms"], "bucket_bound_ms": bucket["bound_ms"],
         "bucket_library_ms": bucket["library_ms"], "bucket_shape": bucket["shape"]},
        {"name": "fused_search_mxu", "route": "cuda",
         "source": "src/repro_torch/kernels/hamming_mxu/csrc/fused_search_mxu.cu",
         "replaces": "src/repro/kernels/hamming_mxu/hamming_mxu.py:99",
         "tpu_kernel": "fused_search_mxu_kernel",
         "launches": launches["fused_search_mxu"], "bit_identical": True,
         "max_abs_err": fm_err, "ms": fm_ms, "plain_ms": fm_plain_ms,
         "bound_ms": fused_bound["bound_ms"], "bound_by": fused_bound["bound_by"],
         "bound_route": fused_bound["bound_route"], "library_ms": None,
         "shape": f"{qh.shape[0]} queries x {rk} rows, k={params.top_k}"},
    ]


# ---------------------------------------------------------------------------
# Phase 11: top_k above 16, and the launch limits
# ---------------------------------------------------------------------------


def require_raises(fn, match: str, what: str) -> None:
    """``fn()`` must raise ValueError whose message contains ``match``."""
    try:
        fn()
    except ValueError as e:
        require(match in str(e), f"{what}: raised {e!r}, expected {match!r}")
        log(f"[limits] {what}: raises ValueError({str(e)!r})")
        return
    fail(f"{what}: did not raise")


def _plain_pair(torch, name, kern, plain, args, kw, what) -> None:
    got = kern.fused_search(*args, **kw)
    torch.cuda.synchronize()
    want = plain.fused_search(*args, **kw)
    for out, g, w in zip(FUSED_OUTS, got, want):
        require(equal(g, w), f"{name} kernel differs from plain ({out}) {what}")


def phase_topk(torch, pipe, hvs, q_pmz, q_charge) -> dict:
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming import ref as href
    from repro_torch.kernels.hamming_mxu import ops as mops
    from repro_torch.kernels.hamming_mxu import ref as mref
    kernels = (("fused_search", hops, href), ("fused_search_mxu", mops, mref))
    params, args, pick, rk = check_blocks(torch, pipe, hvs, q_pmz, q_charge)
    base = dict(q_block=params.q_block, rk=rk, dim=pipe.cfg.dim,
                ppm_tol=params.ppm_tol, open_tol_da=params.open_tol_da)
    for k in TOPK_CHECK_KS:
        for name, kern, plain in kernels:
            _plain_pair(torch, name, kern, plain, args, dict(base, k=k),
                        f"at k={k} on the main-path check blocks")
        log(f"[topk] fused_search and fused_search_mxu kernels == plain on "
            f"{len(pick)} main-path query blocks x {rk} rows at k={k}: bit-identical")
    # Times on the whole batch: k <= 16 is the old path; above, the lists
    # grow and G falls to 1 where a CTA's shared memory no longer fits 8.
    _, qh, qp, qc, starts = sorted_batch(torch, pipe, hvs, q_pmz, q_charge)
    db = pipe.db
    fargs = (qh, qp, qc, db.hvs, db.pmz, db.charge, starts)
    times = {}
    for name, kern, _ in kernels:
        scratch = mops.FUSED_SCRATCH_PER_TILE if kern is mops else 0
        for k in TOPK_TIME_KS:
            g = (hops.GROUP if hops.fused_smem_bytes(hops.GROUP, db.n_words, k, scratch)
                 <= hops.FUSED_SMEM_BUDGET else 1)
            ms = cuda_ms(lambda: kern.fused_search(*fargs, **dict(base, k=k)), iters=3)
            times[f"{name} k={k}"] = ms
            log(f"[topk] {name} on the whole batch ({starts.shape[0]} blocks x {rk} "
                f"rows) at k={k}: {ms:.3f} ms ({g} query tiles per CTA)")
    phase_limits(torch, kernels)
    return times


def phase_limits(torch, kernels) -> None:
    """The widened limits against the plain versions; the remaining ones
    raise their stated errors."""
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hamming import ref as href
    from repro_torch.kernels.hamming_mxu import ops as mops
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    # fused_search_mxu past its old 256 words; both at their widest W (k=1).
    for name, kern, plain, cases in (
            ("fused_search_mxu", mops, kernels[1][2], ((300, 4), (2416, 1))),
            ("fused_search", hops, kernels[0][2], ((2480, 1),))):
        for W, k in cases:
            args = fused_edge_inputs(torch, g, 600, W, (0, 40, 300), 256, 16)
            _plain_pair(torch, name, kern, plain, args,
                        dict(q_block=16, rk=256, dim=32 * W, k=k), f"at W={W}")
            log(f"[limits] {name} kernel == plain at W = {W} words, k={k} "
                f"(3 blocks x 256 rows): bit-identical")
    # Remaining limits: k > K_MAX; W past the shared-memory bound.
    args = fused_edge_inputs(torch, g, 600, 8, (0,), 256, 16)
    for name, kern, _ in kernels:
        require_raises(lambda: kern.fused_search(*args, q_block=16, rk=256, dim=256,
                                                 k=hops.K_MAX + 1),
                       f"keeps 1..{hops.K_MAX} winners", f"{name} at k={hops.K_MAX + 1}")
    for name, kern, W in (("fused_search", hops, 2496), ("fused_search_mxu", mops, 2432)):
        wide = fused_edge_inputs(torch, g, 64, W, (0,), 64, 16)
        require_raises(lambda: kern.fused_search(*wide, q_block=16, rk=64, dim=32 * W, k=1),
                       "of shared memory", f"{name} at W={W}")
    # The tile kernels past 65,535 query tiles (two launches each) and
    # hamming_matrix past its 3,632 staged words (word chunks, summed).
    for Q, R, W in ((hops.TILE_Q_CHUNK + 17, 9, 1), (16, 1000, 4000)):
        q, r = random_words(torch, g, Q, W), random_words(torch, g, R, W)
        counters = _counters()
        before = (counters["hamming_matrix"].count, counters["hamming_mxu"].count)
        vpu, mxu = hops.hamming_matrix(q, r), mops.hamming_matrix(q, r, 32 * W)
        torch.cuda.synchronize()
        want = href.hamming_matrix(q, r)
        require(equal(vpu, want), f"hamming_matrix differs from plain at Q={Q}, W={W}")
        require(equal(mxu, want), f"hamming_mxu differs from plain at Q={Q}, W={W}")
        n = (counters["hamming_matrix"].count - before[0],
             counters["hamming_mxu"].count - before[1])
        log(f"[limits] hamming_matrix and hamming_mxu == plain at Q = {Q}, R = {R}, "
            f"W = {W} (launches {n[0]} / {n[1]}): bit-identical")
        del q, r, vpu, mxu, want
    # The grouped launch past 65,535 groups of 8 tiles: kernels on the
    # whole batch, plain versions on the blocks around the launch boundary.
    nqb = GRID_Y_MAX * hops.GROUP + 17
    n_rows, rk = 2048, 256
    starts = torch.sort(torch.randint(0, n_rows - rk, (nqb,), generator=g,
                                      device=DEVICE, dtype=torch.int32)).values
    q, qp, qc, r, rp, rc, st = fused_edge_inputs(torch, g, n_rows, 1, (0,), rk, 16)
    src = torch.clamp(starts.repeat_interleave(16).long()
                      + torch.randint(0, rk, (nqb * 16,), generator=g, device=DEVICE),
                      max=n_rows - 7)
    q = r[src].contiguous()
    qp = (rp[src] + 0.3).contiguous()
    qc = rc[src].contiguous()
    kw = dict(q_block=16, rk=rk, dim=32, k=2)
    b0 = GRID_Y_MAX * hops.GROUP - 10
    sub = slice(b0 * 16, nqb * 16)
    for name, kern, plain in kernels:
        got = kern.fused_search(q, qp, qc, r, rp, rc, starts, **kw)
        torch.cuda.synchronize()
        want = plain.fused_search(q[sub], qp[sub], qc[sub], r, rp, rc,
                                  starts[b0:].contiguous(), **kw)
        for out, a, b in zip(FUSED_OUTS, got, want):
            require(equal(a[sub], b), f"{name} past {GRID_Y_MAX} groups differs from "
                    f"plain ({out})")
    log(f"[limits] fused_search and fused_search_mxu on {nqb} query blocks "
        f"({-(-nqb // hops.GROUP)} groups of {hops.GROUP} tiles) == plain on the "
        f"{nqb - b0} blocks around the launch boundary: bit-identical")


# ---------------------------------------------------------------------------
# Phase 12: the store
# ---------------------------------------------------------------------------


DB_FIELDS = ("hvs", "pmz", "charge", "is_decoy", "orig_idx", "block_min",
             "block_max", "block_charge")


def db_nbytes(db) -> int:
    return sum(getattr(db, f).numel() * getattr(db, f).element_size() for f in DB_FIELDS)


def phase_store(torch, ds, cfg, pipe, hvs, q_pmz, q_charge, out):
    from repro_torch.core.pipeline import OMSPipeline
    from repro_torch.kernels.hdencode import ops as hd_ops
    STORE_DIR.parent.mkdir(parents=True, exist_ok=True)
    need = pipe.db.n_rows * (4 * cfg.n_words + 13)
    free = shutil.disk_usage(STORE_DIR.parent).free
    log(f"[store] free space at {STORE_DIR.parent}: "
        f"{free / 1e9:.2f} GB; the store needs ~{need / 1e9:.2f} GB")
    require(free > 2 * need, f"not enough free disk for the store: {free} bytes "
            f"free, {2 * need} wanted")
    shutil.rmtree(STORE_DIR, ignore_errors=True)
    hd_ops.launches.reset()
    t0 = time.perf_counter()
    store = OMSPipeline.ingest(cfg, ds.refs, str(STORE_DIR), device=DEVICE,
                               chunk_rows=CHUNK_ROWS)
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    n_hd = hd_ops.launches.count
    require(n_hd > 0, "the store ingest launched no hdencode kernel")
    t0 = time.perf_counter()
    spipe = OMSPipeline.from_store(store, cfg, device=DEVICE)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    for f in DB_FIELDS:
        require(equal(getattr(spipe.db, f), getattr(pipe.db, f)),
                f"store-loaded DB differs from the in-memory one ({f})")
    sout, t_search, counts = _counted(torch, lambda: spipe.search_encoded(hvs, q_pmz, q_charge))
    require(_outputs_equal(sout, out), "store-loaded fused search differs from phase 3")
    require(counts["fused_search"] > 0, "store-loaded search launched no fused_search")
    log(f"[store] ingest of {store.n_targets} spectra + decoys into {len(store.shards)} "
        f"shards, {store.nbytes() / 1e9:.3f} GB, in {t_ingest:.2f}s ({n_hd} hdencode "
        f"launches); from_store(resident=True) in {t_load:.2f}s: DB == in-memory DB in "
        f"all 8 fields; fused search == phase 3 (6 arrays, both FDRs) in "
        f"{t_search:.3f}s")
    del spipe, sout
    return store, {"hdencode": n_hd, "fused_search": counts["fused_search"]}


# ---------------------------------------------------------------------------
# Phase 13: streamed search
# ---------------------------------------------------------------------------


def _slab_line(stats) -> str:
    rows = stats["slabs"]
    g = [r["gather_s"] for r in rows]
    u = [r["upload_ms"] for r in rows]
    k = [r["search_ms"] for r in rows]
    return (f"per slab: host gather mean {statistics.mean(g):.4f} s (max {max(g):.4f}, "
            f"sum {sum(g):.3f}), upload mean {statistics.mean(u):.3f} ms, search "
            f"(kernel + merge) mean {statistics.mean(k):.3f} ms (sum {sum(k) / 1e3:.3f} s)")


def phase_streamed(torch, store, cfg, pipe, hvs, q_pmz, q_charge, out):
    from repro_torch.core.pipeline import OMSPipeline
    db_bytes = db_nbytes(pipe.db)
    launches, first = [], None
    for slab_rows in STREAM_SLAB_ROWS:
        t0 = time.perf_counter()
        spipe = OMSPipeline.from_store(store, cfg, device=DEVICE, resident=False,
                                       slab_rows=slab_rows)
        t_open = time.perf_counter() - t0
        plan = spipe.engine.plan
        # Baseline before this pipeline's first search: the peaks below
        # include the slab buffers the engine keeps between searches.
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        for be, kernel in STREAM_KERNELS.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res, t_first, counts = _counted(torch, lambda: spipe.search_encoded(
                hvs, q_pmz, q_charge, backend=be))
            peak = torch.cuda.max_memory_allocated() - base
            st = spipe.engine.last_stats
            require(_outputs_equal(res, out), f"streamed {be} at {plan.slab_rows} rows a "
                    f"slab differs from the resident fused result")
            require(counts[kernel] == st.n_scanned > 0, f"streamed {be}: {counts[kernel]} "
                    f"{kernel} launches for {st.n_scanned} slabs")
            stats = {}
            t0 = time.perf_counter()
            spipe.search_encoded(hvs, q_pmz, q_charge, backend=be, stats=stats)
            torch.cuda.synchronize()
            t_warm = time.perf_counter() - t0
            launches.append((kernel, f"streamed {be}, {plan.slab_blocks} blocks a slab",
                             counts[kernel]))
            log(f"[stream] {be}, {plan.slab_rows} rows a slab ({plan.slab_blocks} blocks, "
                f"{plan.n_slabs} slabs; layout in {t_open:.2f}s): == resident fused (6 "
                f"arrays, both FDRs); slabs touched {st.n_scanned}/{st.n_slabs}, rows read "
                f"{st.scanned_rows}, bytes {st.scanned_bytes}; first {t_first:.3f}s, warm "
                f"{t_warm:.3f}s; {_slab_line(stats)}; peak device memory above the "
                f"baseline {peak / 2**30:.3f} GiB (resident DB {db_bytes / 2**30:.3f} GiB); "
                f"launches {json.dumps(counts)}")
        if first is None:
            first = spipe
        else:
            del spipe
    return first, launches


# ---------------------------------------------------------------------------
# Phases 14-15: the streamed dimension cascade; the narrow→open cascade
# ---------------------------------------------------------------------------


def phase_streamed_cascade(torch, pipe, spipe, hvs, q_pmz, q_charge, out) -> dict:
    P = STREAM_CASCADE_PREFIX
    resident, t_res, _ = _counted(torch, lambda: pipe.search_encoded(
        hvs, q_pmz, q_charge, prefix_words=P))
    res, t, counts = _counted(torch, lambda: spipe.search_encoded(
        hvs, q_pmz, q_charge, prefix_words=P))
    require(_outputs_equal(res, resident) and _outputs_equal(res, out),
            f"streamed cascade prefix_words={P} differs from the resident cascade")
    require(counts["hamming_matrix"] > 0, "streamed cascade launched no hamming_matrix")
    st = spipe.engine.last_stats
    log(f"[stream] exact cascade prefix_words={P}, fused, {spipe.engine.plan.slab_rows} "
        f"rows a slab: == resident cascade ({t_res:.2f}s) and phase 3's result (6 "
        f"arrays, both FDRs) in {t:.2f}s; slabs "
        f"{st.n_scanned}/{st.n_slabs}, rows read {st.scanned_rows}, bytes "
        f"{st.scanned_bytes}; launches {json.dumps(counts)}")
    return {"hamming_matrix": counts["hamming_matrix"]}


def _timed_stages(torch, p, fn):
    """Run ``fn`` with ``p``'s per-stage search timed (device-synced)."""
    times = []
    orig = p._run_search

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = orig(*a, **k)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return r
    p._run_search = timed
    try:
        return fn(), times
    finally:
        del p._run_search


def _cascades_equal(a, b) -> bool:
    same = all(equal(getattr(a.result, f), getattr(b.result, f)) for f in a.result._fields)
    for fa, fb in ((a.open_fdr, b.open_fdr), (a.std_fdr, b.std_fdr)):
        same = same and all(equal(getattr(fa, f), getattr(fb, f)) for f in fa._fields)
    same = same and bool((a.identified_stage1 == b.identified_stage1).all())
    for sa, sb in ((a.stage1, b.stage1), (a.stage2, b.stage2)):
        same = same and (sa is None) == (sb is None)
        if sa is not None and sb is not None:
            same = same and bool((sa.query_idx == sb.query_idx).all()) and all(
                equal(getattr(sa.result, f), getattr(sb.result, f)) for f in sa.result._fields)
    return same


def phase_narrow_cascade(torch, pipe, spipe, hvs, q_pmz, q_charge, out) -> dict:
    Q = hvs.shape[0]
    outs, launches = {}, {}
    pure = pipe.pure_open_scanned_rows(Q, q_pmz, q_charge)
    for name, p in (("resident", pipe), ("streamed", spipe)):
        (cout, t, counts), times = _timed_stages(torch, p, lambda: _counted(
            torch, lambda: p.search_cascade_encoded(hvs, q_pmz, q_charge,
                                                    narrow_tol_da=NARROW_TOL_DA)))
        require(counts["fused_search"] > 0, f"{name} cascade launched no fused_search")
        require(cout.stage1 is not None and cout.stage2 is not None
                and cout.identified_stage1.any(),
                f"{name} cascade: stage 1 identified nothing or everything")
        outs[name] = cout
        launches[f"narrow→open cascade, {name}"] = counts["fused_search"]
        n_id = int(cout.identified_stage1.sum())
        stream = ""
        if cout.scanned_bytes_total is not None:
            s1, s2 = cout.stage1.stream_stats, cout.stage2.stream_stats
            stream = (f"; bytes streamed {cout.scanned_bytes_total}, slabs stage 1 "
                      f"{s1.n_scanned}/{s1.n_slabs}, stage 2 {s2.n_scanned}/{s2.n_slabs}")
        log(f"[narrow] {name} cascade at {NARROW_TOL_DA} Da, fused, {Q} queries in "
            f"{t:.3f}s: stage 1 identified {n_id} ({times[0]:.3f}s), stage 2 on "
            f"{Q - n_id} queries ({times[1]:.3f}s); open identifications "
            f"{int(cout.open_fdr.n_accepted)}; scanned rows {cout.scanned_rows_total} "
            f"against pure open {pure} ({cout.scanned_rows_total / pure:.4f}){stream}; "
            f"launches {json.dumps(counts)}")
        c0 = p.search_cascade_encoded(hvs, q_pmz, q_charge, run_stage1=False)
        require(all(equal(getattr(c0.result, f), getattr(out.result, f))
                    for f in out.result._fields)
                and all(equal(getattr(c0.std_fdr, f), getattr(out.std_fdr, f))
                        for f in out.std_fdr._fields),
                f"{name} cascade with run_stage1=False differs from search_encoded")
    require(_cascades_equal(outs["resident"], outs["streamed"]),
            "streamed narrow→open cascade differs from the resident one")
    log("[narrow] streamed cascade == resident cascade (merged result, both FDRs, "
        "stage-1 identified, stage queries and results); run_stage1=False == "
        "search_encoded on both paths")
    return launches

# ---------------------------------------------------------------------------
# Phase 18: multi-device OMS (runs after phase 15, on phase 12's store)
# ---------------------------------------------------------------------------


def smoke_devices(torch, n: int) -> list:
    """``n`` device entries: distinct cards dealt round-robin where the
    machine has more than one, else ``n`` entries of the one card (bit-exact,
    but the entries run one after another)."""
    if DEVICE == "cpu":
        return [torch.device("cpu")] * n
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def phase_multi_device(torch, pipe, spipe, cfg, hvs, q_pmz, q_charge) -> dict:
    from repro_torch.core.blocking import shard_reference_db
    from repro_torch.core.search import _search_sorted_padded
    from repro_torch.distributed import make_mesh, place_shards, sharded_search
    from repro_torch.distributed.collectives import _merge_best
    from repro_torch.core.pipeline import OMSPipeline

    cards = torch.cuda.device_count() if DEVICE != "cpu" else 0
    log(f"[multi] {cards} CUDA device(s): " + (
        "shards and slab streams go to distinct cards, round-robin" if cards > 1 else
        "every shard and slab stream on the one card (bit-exact, no overlap; the "
        "launch guard across cards is not exercised)"))
    launches = {k: {} for k in SHARD_KERNELS.values()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params0, qh, qp, qc, _ = sorted_batch(torch, pipe, hvs, q_pmz, q_charge)
    resident = {}
    for k in SHARD_KS:
        params = params0._replace(backend="fused", top_k=k)
        resident[k] = _search_sorted_padded(pipe.db, qh, qp, qc, params=params,
                                            dim=cfg.dim)
        t0 = time.perf_counter()
        _search_sorted_padded(pipe.db, qh, qp, qc, params=params, dim=cfg.dim)
        torch.cuda.synchronize()
        log(f"[multi] resident fused top_k={k}: warm {time.perf_counter() - t0:.4f}s "
            f"({pipe.db.n_blocks} blocks, k_blocks {params.k_blocks})")
    for S in SHARD_COUNTS:
        devs = smoke_devices(torch, S)
        mesh = make_mesh((S,), ("model",), devices=devs)
        t0 = time.perf_counter()
        sdb = place_shards(shard_reference_db(pipe.db, S), devs)
        torch.cuda.synchronize()
        t_place = time.perf_counter() - t0
        log(f"[multi] S={S} on {[str(d) for d in devs]}: padded to {sdb.n_blocks} blocks "
            f"({sdb.n_blocks - pipe.db.n_blocks} pad), {sdb.blocks_per_shard} blocks = "
            f"{sdb.rows_per_shard} rows = {sdb.shards[0].hvs.numel() * 4 / 1e6:.1f} MB of "
            f"HVs a shard; padded and placed in {t_place:.3f}s")
        for be, kernel in SHARD_KERNELS.items():
            for k in SHARD_KS:
                params = params0._replace(backend=be, top_k=k)
                (outs, same), t_first, counts = _counted(torch, lambda: sharded_search(
                    sdb, qh, qp, qc, params, dim=cfg.dim, mesh=mesh))
                require(same is sdb, "sharded_search did not take the ShardedDB as it is")
                for f, a, b in zip(FUSED_OUTS, outs, resident[k]):
                    require(equal(a, b), f"sharded {be} S={S} top_k={k}: {f} differs "
                            f"from the resident fused result")
                require(counts[kernel] == S, f"sharded {be} S={S}: {counts[kernel]} "
                        f"{kernel} launches, expected one a shard")
                path = f"sharded {be}, S={S}, top_k={k}"
                launches[kernel][path] = counts[kernel]
                t_warm = statistics.median(_counted(torch, lambda: sharded_search(
                    sdb, qh, qp, qc, params, dim=cfg.dim, mesh=mesh))[1]
                    for _ in range(SHARD_WARM_RUNS))
                local = params._replace(k_blocks=min(params.k_blocks, sdb.blocks_per_shard))
                parts = [_search_sorted_padded(sh, *(x.to(sh.device) for x in (qh, qp, qc)),
                                               params=local, dim=cfg.dim)
                         for sh in sdb.shards]
                shard_ms = cuda_ms(lambda: _search_sorted_padded(
                    sdb.shards[0], qh, qp, qc, params=local, dim=cfg.dim), iters=5)
                merge_ms = cuda_ms(lambda: [_merge_best([p[i] for p in parts],
                                                        [p[i + 1] for p in parts], k,
                                                        devs[0]) for i in (0, 2)])
                log(f"[multi] {path}: == resident fused (4 arrays, global rows); "
                    f"first {t_first:.4f}s, warm {t_warm:.4f}s (median of "
                    f"{SHARD_WARM_RUNS}); one shard's search "
                    f"{shard_ms:.3f} ms, merge (2 x _merge_best over {S} x {k}) "
                    f"{merge_ms:.3f} ms (CUDA events); {kernel} launches {counts[kernel]}")
        del sdb, same, outs, parts
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    log(f"[multi] sharded search: peak memory of the current card above its "
        f"baseline {peak / 2**30:.3f} GiB (the padded DB copy, the per-shard "
        f"partials)")

    one, _, _ = _counted(torch, lambda: spipe.search_encoded(hvs, q_pmz, q_charge))
    one_stats = spipe.engine.last_stats
    slab_rows = spipe.engine.plan.slab_rows
    for n in STREAM_DEVICE_COUNTS:
        devs = smoke_devices(torch, n)
        mpipe = OMSPipeline.from_store(STORE_DIR, cfg, resident=False,
                                       slab_rows=slab_rows, stream_devices=devs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mbase = torch.cuda.memory_allocated()
        res, t_first, counts = _counted(torch, lambda: mpipe.search_encoded(
            hvs, q_pmz, q_charge))
        st = mpipe.engine.last_stats
        require(_outputs_equal(res, one), f"streamed over {n} device entries differs "
                f"from the one-device streamed result")
        require(st == one_stats, f"streamed over {n} device entries: StreamStats {st} "
                f"!= one device's {one_stats}")
        require(counts["fused_search"] == st.n_scanned > 0, f"streamed over {n} "
                f"entries: {counts['fused_search']} fused launches for "
                f"{st.n_scanned} slabs")
        stats = {}
        t0 = time.perf_counter()
        mpipe.search_encoded(hvs, q_pmz, q_charge, stats=stats)
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - mbase
        launches["fused_search"][f"streamed fused over {n} device entries"] = (
            counts["fused_search"])
        log(f"[multi] streamed fused over {n} entries {[str(d) for d in devs]}, "
            f"{slab_rows} rows a slab: == one-device streamed (6 arrays, both FDRs, "
            f"StreamStats {tuple(st)}); first {t_first:.3f}s, warm {t_warm:.3f}s; "
            f"{_slab_line(stats)}; peak memory of the current card above its "
            f"baseline {peak / 2**30:.3f} GiB; fused_search launches "
            f"{counts['fused_search']}")
        del mpipe
    return launches


# ---------------------------------------------------------------------------
# Phase 16: the launcher on the card
# ---------------------------------------------------------------------------


def oms_cli(args, what: str, *, stdin=None, stdout=None, module: str = "oms",
            expect_failure: bool = False):
    """Run ``python -m repro_torch.launch.<module> *args`` from the
    repository root (stdin / stdout from / to the given paths, else none /
    captured); fails unless it exits 0 (with ``expect_failure``, unless it
    exits nonzero). Returns (stdout text, stderr text, seconds)."""
    import os
    cmd = [sys.executable, "-m", f"repro_torch.launch.{module}", *map(str, args)]
    env = {**os.environ, "PYTHONPATH": str(HERE / "src")}
    fin = open(stdin) if stdin else None
    fout = open(stdout, "w") if stdout else None
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, cwd=HERE, env=env,
                             stdin=fin or subprocess.DEVNULL,
                             stdout=fout or subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True,
                             timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"{what}: `{module} {' '.join(cmd[3:])}` ran past {CLI_TIMEOUT_S} s")
    finally:
        for f in (fin, fout):
            if f is not None:
                f.close()
    dt = time.perf_counter() - t0
    require((res.returncode != 0) == expect_failure,
            f"{what}: `{module} {' '.join(cmd[3:])}` exited "
            f"{res.returncode}: {res.stderr[-3000:]}")
    return res.stdout or "", res.stderr, dt


class FirstRead:
    """The lines of ``lines``; ``start()`` runs just before the first is
    read, which ``serve`` does once its store is loaded."""

    def __init__(self, lines, start):
        self.lines, self.start = lines, start

    def __iter__(self):
        self.start()
        yield from self.lines


def serve_profiler(torch):
    """A torch.profiler that records device activity only (CUPTI); the
    host work of the serve threads is not instrumented."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def device_profile(prof, wall_s: float, top: int = 0) -> dict:
    """The device's busy time (the union of kernel, copy and set
    intervals) over ``wall_s``, and each serve kernel's launches and
    device milliseconds, from ``prof``'s trace; with ``top``, also the
    ``top`` kernels by device time as [name, launches, ms]."""
    prof.export_chrome_trace(str(SERVE_PROFILE))
    try:
        events = [e for e in json.loads(SERVE_PROFILE.read_text())["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_EVENT_CATS]
    finally:
        SERVE_PROFILE.unlink(missing_ok=True)
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    kernels = {k: [0, 0.0] for k in SERVE_KERNELS}
    for e in events:
        for k, names in SERVE_KERNELS.items():
            if e["cat"] == "kernel" and any(n in e["name"] for n in names):
                kernels[k][0] += 1
                kernels[k][1] += e["dur"] / 1e3
    by_name = {}
    for e in events:
        if e["cat"] == "kernel":
            n = by_name.setdefault(e["name"][:80], [0, 0.0])
            n[0] += 1
            n[1] += e["dur"] / 1e3
    out = {"wall_ms": wall_s * 1e3, "busy_ms": busy_us / 1e3,
           "idle_share": 1.0 - busy_us / 1e3 / (wall_s * 1e3),
           "copy_ms": sum(e["dur"] for e in events if e["cat"] == "gpu_memcpy") / 1e3,
           "n_events": len(events), "kernels": kernels}
    if top:
        out["top_kernels"] = [[k, *v] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1][1])[:top]]
    return out


def oms_in_process(args, stdin, *, profile=False):
    """``repro_torch.launch.oms.main(args)`` in this process reading the
    lines of ``stdin`` (a file or any iterable), stdout and stderr
    captured, every kernel's launch count set to 0 just before and read
    just after. With ``profile``, the device's activity is recorded from
    the first request read to the return (``device_profile``). Returns
    (stdout, stderr, counts, seconds, profile or None)."""
    import contextlib
    import io
    import torch
    from repro_torch.kernels.hdencode import ops as hd_ops
    from repro_torch.launch import oms
    counters = {**_counters(), "hdencode": hd_ops.launches}
    out, err = io.StringIO(), io.StringIO()
    prof, started = (serve_profiler(torch) if profile else None), []

    def start():
        torch.cuda.synchronize()
        prof.start()
        started.append(time.perf_counter())
    old = sys.stdin
    sys.stdin = FirstRead(stdin, start) if profile else stdin
    try:
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            oms.main([str(a) for a in args])
        t = time.perf_counter() - t0
        counts = {n: c.count for n, c in counters.items()}
        if started:
            torch.cuda.synchronize()
            wall = time.perf_counter() - started[0]
    finally:
        sys.stdin = old
        if started:
            prof.stop()
    return (out.getvalue(), err.getvalue(), counts, t,
            device_profile(prof, wall) if started else None)


_SERVE_STATS = (
    r"answered (?P<answered>\d+) queries in (?P<s>[\d.]+)s \((?P<qps>\d+) q/s, "
    r"(?P<batches>\d+) micro-batches, (?P<qpb>[\d.]+) q/batch .*?wait p50/p99 "
    r"(?P<wait50>[\d.]+)/(?P<wait99>[\d.]+)ms, e2e p50/p99 (?P<e2e50>[\d.]+)/"
    r"(?P<e2e99>[\d.]+)ms")


def serve_stats(err: str) -> dict:
    """The numbers of ``serve``'s closing stderr line."""
    import re
    m = re.search(_SERVE_STATS, err)
    require(m is not None, f"serve printed no summary line: {err[-2000:]}")
    st = {k: float(v) for k, v in m.groupdict().items()}
    slabs = re.search(r"scans over (\d+) slabs", err)
    st["slabs"] = int(slabs.group(1)) if slabs else 0
    cache = re.search(r"cache (\d+)/(\d+) hits", err)
    st["cache"] = (int(cache.group(1)), int(cache.group(2))) if cache else None
    return st


class GrowingStdin:
    """Request lines for ``serve --hot-reload``: ``first``, then, once all of
    them have been searched (their ``serve.batch`` spans closed), ``grow()``
    and a wait of 10 watcher polls, then ``rest``."""

    def __init__(self, first, rest, grow):
        self.first, self.rest, self.grow = first, rest, grow

    def __iter__(self):
        from repro_torch.obs import trace
        yield from self.first
        deadline = time.monotonic() + CLI_TIMEOUT_S
        while sum(e.attrs["n"] for e in trace.current().events()
                  if e.name == "serve.batch") < len(self.first):
            require(time.monotonic() < deadline, "hot reload: the first "
                    "requests were never served")
            time.sleep(0.01)
        self.grow()
        time.sleep(10 * HOT_RELOAD_POLL_S)
        yield from self.rest


def payloads_of(result) -> list[dict]:
    """Every query's response payload as ``serve`` writes it."""
    r = {f: getattr(result, f).cpu().numpy()
         for f in ("std_idx", "std_sim", "open_idx", "open_sim")}
    return [{"std": {"idx": r["std_idx"][i].tolist(), "sim": r["std_sim"][i].tolist()},
             "open": {"idx": r["open_idx"][i].tolist(), "sim": r["open_sim"][i].tolist()}}
            for i in range(r["std_idx"].shape[0])]


def same_bytes(a: Path, b: Path) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(1 << 24), fb.read(1 << 24)
            if x != y:
                return False
            if not x:
                return True


def result_lines(out, ds, cfg, Q: int) -> list[str]:
    """The recall and identification lines the launcher prints for ``out``
    (the same format strings)."""
    import numpy as np
    src, mod = ds.query_source, ds.query_modified
    o = out.result.open_idx.cpu().numpy()[:, 0] == src
    s = out.result.std_idx.cpu().numpy()[:, 0] == src
    return [f"[oms] open-search recall@1:     {np.mean(o):.3f} "
            f"(modified queries: {np.mean(o[mod]):.3f})",
            f"[oms] standard-search recall@1: {np.mean(s):.3f} "
            f"(modified queries: {np.mean(s[mod]):.3f})",
            f"[oms] identifications @ {cfg.fdr_threshold:.0%} FDR: "
            f"{int(out.open_fdr.n_accepted)} / {Q * cfg.top_k}"]


class LargestCall:
    """Wraps ``mod.<name>`` (a kernel wrapper) to keep the arguments of its
    first call with the most rows in its first argument; ``replay()``
    calls the wrapper on them again."""

    def __init__(self, mod, name: str):
        self.mod, self.name, self.orig = mod, name, getattr(mod, name)
        self.rows, self.args, self.kw = -1, None, None

    def __enter__(self):
        def kept(*a, **kw):
            if a[0].shape[0] > self.rows:
                self.rows, self.args, self.kw = a[0].shape[0], a, kw
            return self.orig(*a, **kw)
        setattr(self.mod, self.name, kept)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)

    def replay(self):
        return self.orig(*self.args, **self.kw)


def _profile_line(name: str, prof: dict, batches: int) -> str:
    if not prof["n_events"]:
        return (f"[cli] serve {name} device profile: torch.profiler recorded no "
                f"device activity (idle share and kernel times not measured)")
    ks = ", ".join(f"{k} {n} kernels {ms:.3f} ms ({ms / batches:.4f} ms a batch)"
                   for k, (n, ms) in prof["kernels"].items())
    return (f"[cli] serve {name} device profile ({batches} micro-batches in "
            f"process): device busy {prof['busy_ms']:.2f} of {prof['wall_ms']:.2f} ms "
            f"from the first request read to the return, idle share "
            f"{prof['idle_share']:.4f}; copies {prof['copy_ms']:.2f} ms; {ks}")


def _serve_line(name: str, st: dict, t: float, counts: dict) -> str:
    used = {k: v for k, v in counts.items() if v}
    return (f"[cli] serve {name}: answered {int(st['answered'])} in {st['s']:.2f}s "
            f"({int(st['qps'])} q/s; process {t:.1f}s), {int(st['batches'])} "
            f"micro-batches ({st['qpb']:.1f} q/batch), wait p50/p99 "
            f"{st['wait50']:.2f}/{st['wait99']:.2f} ms, e2e p50/p99 "
            f"{st['e2e50']:.2f}/{st['e2e99']:.2f} ms; launches (in-process run) "
            f"{json.dumps(used)}")


def phase_launcher(torch, lib_cfg, cfg, pipe, hvs, q_pmz, q_charge, out, ds,
                   before_reload=None) -> dict:
    """Phase 16: build, search, queries, serve (resident, streamed, cached,
    cascade) and trace-report through ``python -m repro_torch.launch.oms``.
    ``before_reload(search args, search stdout, serve args, resident serve
    lines, head requests file)`` runs before the hot reload grows the store
    and returns {kernel: {path: launches}} of its own. Returns {kernel:
    {path: launches}} of the in-process serve runs."""
    import os
    from repro_torch.data.spectra import LibraryConfig
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.hdencode import ops as hd_ops
    t_phase = time.perf_counter()
    Q = lib_cfg.n_queries
    require(lib_cfg == LibraryConfig(n_refs=lib_cfg.n_refs, n_queries=Q,
                                     open_tol_da=75.0, seed=SEED),
            "the launcher's --refs/--queries/--seed do not give phase 3's dataset")
    data = ["--refs", lib_cfg.n_refs, "--seed", SEED]
    dev = ["--device", DEVICE]
    names = sorted(os.listdir(STORE_DIR))
    need = sum((STORE_DIR / n).stat().st_size for n in names)
    free = shutil.disk_usage(STORE_DIR.parent).free
    log(f"[cli] free space at {STORE_DIR.parent}: {free / 1e9:.2f} GB; a second "
        f"store needs {need / 1e9:.2f} GB")
    require(free > 2 * need, f"not enough free disk for the launcher's store: "
            f"{free} bytes free, {2 * need} wanted")

    # 1. build: the same store as phase 12, byte for byte
    shutil.rmtree(CLI_STORE_DIR, ignore_errors=True)
    try:
        o, _, t = oms_cli(["build", "--store", CLI_STORE_DIR, *data,
                           "--encode-backend", "pallas", "--encode-batch",
                           ENCODE_BATCH, "--chunk-rows", CHUNK_ROWS, *dev], "build")
        require(sorted(os.listdir(CLI_STORE_DIR)) == names,
                "the launcher's store has other files than phase 12's")
        for n in names:
            require(same_bytes(STORE_DIR / n, CLI_STORE_DIR / n),
                    f"the launcher's {n} differs from phase 12's")
        log(f"[cli] build (process {t:.1f}s): {o.strip().splitlines()[-1]}; "
            f"{len(names)} files byte-identical to phase 12's store")
    finally:
        shutil.rmtree(CLI_STORE_DIR, ignore_errors=True)

    # 2. search, plain and cascade: phase 3's and phase 15's lines
    search = ["search", "--store", STORE_DIR, "--queries", Q, "--seed", SEED,
              "--backend", "fused", "--encode-backend", "pallas",
              "--encode-batch", ENCODE_BATCH, "--max-r", cfg.max_r, *dev]
    o, _, t = oms_cli(search, "search")
    search_out = o
    lines = o.splitlines()
    expect = result_lines(out, ds, cfg, Q)
    for want in expect:
        require(want in lines, f"search printed no line {want!r}:\n{o}")
    split = [x for x in lines if "stage split" in x or "searched" in x]
    log(f"[cli] search (process {t:.1f}s): recall@1 and identification lines == "
        f"phase 3's ({' | '.join(x[6:] for x in expect)}); {' | '.join(split)}")
    casc = pipe.search_cascade_encoded(hvs, q_pmz, q_charge, narrow_tol_da=NARROW_TOL_DA)
    n_id = int(casc.identified_stage1.sum())
    o, _, t = oms_cli([*search, "--cascade", "--narrow-tol-da", NARROW_TOL_DA],
                      "search --cascade")
    lines = o.splitlines()
    cl = [x for x in lines if x.startswith("[oms] cascade:")]
    require(len(cl) == 1 and f"stage1 identified {n_id}/{Q} ({NARROW_TOL_DA} Da)"
            in cl[0], f"search --cascade: stage 1 did not identify {n_id}:\n{o}")
    for want in result_lines(casc, ds, cfg, Q):
        require(want in lines, f"search --cascade printed no line {want!r}:\n{o}")
    split = [x for x in lines if "stage split" in x]
    log(f"[cli] search --cascade (process {t:.1f}s): {cl[0][6:]}; recall and "
        f"identification lines == the in-process cascade's; {' | '.join(split)}")

    # 3. queries
    _, _, t = oms_cli(["queries", "--queries", Q, *data], "queries", stdout=REQUESTS_FILE)
    reqs = REQUESTS_FILE.read_text().splitlines(keepends=True)
    require(len(reqs) == Q, f"queries wrote {len(reqs)} lines for {Q} queries")
    for i in (0, Q // 2, Q - 1):
        r = json.loads(reqs[i])
        require(r["id"] == i and r["pmz"] == float(ds.queries.pmz[i])
                and r["charge"] == int(ds.queries.charge[i]),
                f"request {i} is not phase 3's query {i}")
    log(f"[cli] queries (process {t:.1f}s): {Q} requests, "
        f"{REQUESTS_FILE.stat().st_size / 1e6:.1f} MB")
    head_file = REQUESTS_FILE.with_name("smoke_requests_head.jsonl")
    head_file.write_text("".join(reqs[:STREAM_SERVE_REQUESTS]))
    twice_file = REQUESTS_FILE.with_name("smoke_requests_twice.jsonl")
    twice_file.write_text("".join(reqs[:CACHE_REQUESTS]) * 2)
    in_process_file = REQUESTS_FILE.with_name("smoke_requests_in_process.jsonl")
    in_process_file.write_text("".join(reqs[:IN_PROCESS_REQUESTS]))

    serve = ["serve", "--store", STORE_DIR, "--backend", "fused", "--encode-backend",
             "pallas", "--max-r", cfg.max_r, *dev]
    by_path = {"hdencode": {}, "fused_search": {}}
    stats = {}

    def run_serve(name, label, args, stdin, cli_only=(), in_process=None):
        """The subprocess (with ``cli_only`` added) on ``stdin``, then the
        profiled in-process run on ``in_process`` (default: ``stdin``),
        which reads the launch counts and must answer as the subprocess
        did for the same requests."""
        o, e, t = oms_cli([*serve, *args, *cli_only], f"serve {name}", stdin=stdin)
        lines = o.splitlines(keepends=True)
        src = in_process or stdin
        with open(src) as fin:
            n_in = sum(1 for _ in fin)
        with open(src) as fin:
            o2, e2, counts, _, prof = oms_in_process([*serve, *args], fin,
                                                     profile=True)
        require(o2.splitlines(keepends=True) == lines[:n_in] and len(lines) >= n_in,
                f"serve {name}: the in-process run answered otherwise")
        st = serve_stats(e)
        stats[name] = st
        log(_serve_line(name, st, t, counts))
        log(_profile_line(name, prof, int(serve_stats(e2)["batches"])))
        for k in by_path:
            require(counts[k] > 0, f"serve {name} launched no {k}")
            by_path[k][f"serve {label} ({n_in:,} requests, in process)"] = counts[k]
        return lines, st

    # 4. resident, every request: phase 3's rows; one micro-batch's kernel
    # calls kept from the in-process run and replayed
    with LargestCall(hd_ops, "hdencode") as hd, LargestCall(hops, "fused_search") as fs:
        res_lines, st4 = run_serve(
            "resident", "resident", ["--resident", "--no-result-cache"],
            REQUESTS_FILE, cli_only=["--trace", SERVE_TRACE, "--metrics", "-"],
            in_process=in_process_file)
    hd_ms, hd_dev, fs_ms = cuda_ms(hd.replay), graph_ms(hd.replay), cuda_ms(fs.replay)
    log(f"[cli] one resident micro-batch's kernel calls replayed at their serve "
        f"shapes (CUDA events, median of {TIMING_ITERS}): hdencode "
        f"{tuple(hd.args[0].shape)} peaks {hd_ms:.4f} ms (device {hd_dev:.4f} ms in "
        f"a graph), fused_search {fs.rows} padded queries x {fs.args[6].shape[0]} "
        f"blocks x {fs.kw['rk']} rows {fs_ms:.4f} ms")
    require(len(res_lines) == Q and int(st4["answered"]) == Q,
            "serve resident did not answer every request")
    for i, (line, want) in enumerate(zip(res_lines, payloads_of(out.result))):
        if json.loads(line) != {"id": i, **want}:
            fail(f"serve resident: response {i} differs from phase 3's row: {line}")
    log(f"[cli] serve resident: all {Q} responses == phase 3's result rows")

    # 5. streamed, the first requests: byte-identical to run 4's
    head = "".join(res_lines[:STREAM_SERVE_REQUESTS])
    st_lines, st5 = run_serve(
        "streamed", f"streamed {STREAM_SERVE_SLAB_ROWS} rows a slab",
        ["--slab-rows", STREAM_SERVE_SLAB_ROWS, "--max-batch", STREAM_SERVE_BATCH,
         "--no-result-cache"], head_file, cli_only=["--trace", STREAM_TRACE])
    require("".join(st_lines) == head, "serve streamed differs from serve resident")
    log(f"[cli] serve streamed: {STREAM_SERVE_REQUESTS} responses byte-identical to "
        f"serve resident; {st5['slabs']} slabs scanned")

    # 6. the result cache: the first requests twice, the second copy all hits
    c_lines, st6 = run_serve(
        "cached", "resident cached",
        ["--resident"], twice_file)
    require("".join(c_lines) == "".join(res_lines[:CACHE_REQUESTS]) * 2,
            "serve with the result cache differs from serve without it")
    require(st6["cache"] == (CACHE_REQUESTS, 2 * CACHE_REQUESTS),
            f"result cache hits {st6['cache']}, want {CACHE_REQUESTS} of "
            f"{2 * CACHE_REQUESTS}")
    log(f"[cli] serve cached: byte-identical to the uncached lines; cache "
        f"{st6['cache'][0]}/{st6['cache'][1]} hits")

    # 7. the cascade, per query: single-query in-process cascades on a sample
    k_lines, _ = run_serve(
        "cascade", "resident cascade",
        ["--resident", "--cascade", "--narrow-tol-da", NARROW_TOL_DA,
         "--no-result-cache"], REQUESTS_FILE, in_process=in_process_file)
    require(len(k_lines) == Q, "serve --cascade did not answer every request")
    sample = sorted({int(i) for i in torch.linspace(0, Q - 1, CASCADE_SAMPLE).round()})
    for i in sample:
        c = pipe.search_cascade_encoded(hvs[i:i + 1], q_pmz[i:i + 1], q_charge[i:i + 1],
                                        narrow_tol_da=NARROW_TOL_DA,
                                        stage1_per_query=True)
        want = {"id": i, **payloads_of(c.result)[0]}
        require(json.loads(k_lines[i]) == want, f"serve --cascade response {i} "
                f"differs from a single-query cascade: {k_lines[i]} vs {want}")
    log(f"[cli] serve cascade: {len(sample)} sampled responses == single-query "
        f"in-process cascades (stage1_per_query)")

    # 8. trace-report on both serve traces
    o, _, _ = oms_cli(["trace-report", "--json", SERVE_TRACE], "trace-report")
    roll = json.loads(o)
    require(roll.get("serve.batch", {}).get("count") == int(st4["batches"]),
            f"trace: {roll.get('serve.batch')} serve.batch spans for "
            f"{int(st4['batches'])} micro-batches")
    missing = {"pipeline.encode", "pipeline.plan", "pipeline.scan",
               "pipeline.fdr"} - set(roll)
    require(not missing, f"the serve trace has no {sorted(missing)} spans")
    o, _, _ = oms_cli(["trace-report", "--json", STREAM_TRACE], "trace-report")
    roll5 = json.loads(o)
    require(roll5.get("serve.slab.search", {}).get("count") == st5["slabs"],
            f"trace: {roll5.get('serve.slab.search')} serve.slab.search spans for "
            f"{st5['slabs']} slabs scanned")
    parts = ", ".join(f"{n} {roll[n]['count']} x {roll[n]['total_us'] / roll[n]['count']:.0f} us "
                      f"(p50/p99 buckets {roll[n]['p50_us']:.0f}/{roll[n]['p99_us']:.0f})"
                      for n in ("serve.batch", "pipeline.encode", "pipeline.plan",
                                "pipeline.scan", "pipeline.fdr"))
    sparts = ", ".join(f"{n} {roll5[n]['count']} x "
                       f"{roll5[n]['total_us'] / roll5[n]['count'] / 1e3:.1f} ms"
                       for n in ("serve.batch", "serve.scan", "serve.slab.fetch",
                                 "serve.slab.search", "serve.slab.merge"))
    log(f"[cli] trace-report: resident trace validates, serve.batch == "
        f"{int(st4['batches'])} micro-batches, host span means {parts}; streamed "
        f"trace serve.slab.search == {st5['slabs']} slabs, means {sparts}")

    if before_reload is not None:
        for k, paths in before_reload(search, search_out, serve, res_lines,
                                      head_file).items():
            by_path.setdefault(k, {}).update(paths)

    # 9. hot reload: the store grows under a streamed serve (last: it
    # changes phase 12's store, which the finally deletes)
    new_file = REQUESTS_FILE.with_name("smoke_requests_new.jsonl")
    oms_cli(["queries", "--refs", HOT_RELOAD_REFS, "--seed", SEED + 1, "--queries",
             HOT_RELOAD_REQUESTS], "queries of the appended spectra", stdout=new_file)
    first = reqs[:HOT_RELOAD_REQUESTS]
    rest = new_file.read_text().splitlines(keepends=True)
    grown = []

    def grow():
        o, _, t = oms_cli(["build", "--store", STORE_DIR, "--append", "--refs",
                           HOT_RELOAD_REFS, "--seed", SEED + 1, "--encode-backend",
                           "pallas", "--encode-batch", ENCODE_BATCH, "--chunk-rows",
                           CHUNK_ROWS, *dev], "build --append")
        grown.append(f"{o.strip()} (process {t:.1f}s)")

    from repro_torch.core.pipeline import OMSPipeline
    from repro_torch.serve import QuerySpec, coalesce_queries
    o, err, counts, t, _ = oms_in_process(
        [*serve, "--slab-rows", STREAM_SERVE_SLAB_ROWS, "--max-batch",
         STREAM_SERVE_BATCH, "--no-result-cache", "--hot-reload",
         HOT_RELOAD_POLL_S, "--trace", RELOAD_TRACE], GrowingStdin(first, rest, grow))
    got = o.splitlines(keepends=True)
    require(len(grown) == 1 and "1 hot-reloads" in err,
            f"serve --hot-reload did not reload once: {err[-2000:]}")
    require(got[:len(first)] == res_lines[:len(first)],
            "hot reload: the responses before the append differ from serve resident")
    spectra = coalesce_queries([QuerySpec(
        mz=r["mz"], intensity=r["intensity"], pmz=r["pmz"], charge=r["charge"])
        for r in map(json.loads, rest)])
    cold = OMSPipeline.from_store(STORE_DIR, cfg, device=DEVICE).search(spectra)
    old_answers = pipe.search(spectra)
    want = [{"id": json.loads(r)["id"], **p} for r, p in zip(rest, payloads_of(cold.result))]
    require([json.loads(x) for x in got[len(first):]] == want,
            "hot reload: the responses after the append differ from a cold "
            "start on the grown store")
    n_new = sum(a != b for a, b in zip(payloads_of(old_answers.result),
                                       payloads_of(cold.result)))
    require(n_new > 0, "hot reload: the appended spectra changed no answer")
    st = serve_stats(err)
    log(_serve_line("streamed + hot reload", st, t, counts))
    log(f"[cli] serve --hot-reload: {grown[0]}; the first {len(first)} responses "
        f"== serve resident, the {len(rest)} after the reload == a cold start on "
        f"the grown store ({n_new} of them changed by the appended spectra); "
        f"{[x for x in err.splitlines() if 'hot-reload:' in x][0].split('] ', 1)[1]}")
    for k in ("hdencode", "fused_search"):
        require(counts[k] > 0, f"serve --hot-reload launched no {k}")
        by_path[k][f"serve streamed + hot reload ({2 * HOT_RELOAD_REQUESTS} "
                   f"requests, in process)"] = counts[k]
    log(f"[cli] phase 16 in {time.perf_counter() - t_phase:.1f}s")
    return by_path


# ---------------------------------------------------------------------------
# Phase 17: the autotuner and the contract analyzer
# ---------------------------------------------------------------------------


def _mask_times(text: str) -> str:
    """A launcher's stdout with its clock readings masked."""
    import re
    return re.sub(r"\d+(\.\d+)?( ?q/s| ?sp/s|s\b|%)", "<t>", text)


def _tune_table(table: str) -> dict:
    """{backend: [row, ...]} of a ``tune --full-table`` table, winner first;
    a row is {tiles, us, bound_us, frac}."""
    import re
    rows = {}
    for line in table.splitlines()[1:]:
        be, rest = line.split(None, 1)
        m = re.match(r"(?P<tiles>.*?)\s+(?P<us>[\d.]+)\s+(?P<bound>[\d.]+)\s+"
                     r"(?P<frac>[\d.]+)%\*?$", rest.rstrip())
        require(m is not None, f"tune table row not understood: {line!r}")
        rows.setdefault(be, []).append({
            "tiles": {k: int(v) for k, v in (x.split("=") for x in m["tiles"].split())},
            "us": float(m["us"]), "bound_us": float(m["bound"]),
            "frac": float(m["frac"]) / 100})
    return rows


def _tune_stats(err: str, tag: str) -> tuple[int, int]:
    import re
    m = re.search(rf"\[oms {tag}\] tune-cache .*: (\d+) entries, (\d+) hits / "
                  rf"(\d+) misses", err)
    require(m is not None, f"{tag} --tune-cache printed no tune-cache line: {err[-2000:]}")
    return int(m[2]), int(m[3])


def phase_tune(torch, pipe, ds, hvs, q_pmz, q_charge, search_args, search_out,
               serve_args, res_lines, head_file) -> dict:
    """Phase 17, part 1 (run inside phase 16, before the hot reload grows
    the store): the device's float32 sqrt held against the float64 one the
    CPU path stands for; ``tune`` in process at the main path's shapes,
    every candidate checked bit for bit against the defaults' output by the
    sweep, the winner table with each winner against the default; then
    ``search`` and resident ``serve`` (the first 1,024 requests) in process
    with the winners' cache: their output equals the untuned runs' and the
    cache hits. Returns {kernel: {path: launches}}."""
    import contextlib
    import io
    import numpy as np
    from repro_torch import tune
    from repro_torch.core import encoding
    from repro_torch.launch import oms
    t_phase = time.perf_counter()

    # The device path takes torch's float32 sqrt (the CPU path numpy's):
    # both must be the correctly rounded one, the float64 sqrt rounded once.
    inten = torch.as_tensor(ds.refs.intensity[:SQRT_CHECK_SPECTRA], device=DEVICE)
    rand = torch.rand(1 << 24, device=DEVICE) * 1e6
    for x in (inten, rand):
        require(equal(encoding.sqrt_f32(x), torch.sqrt(x.double()).float()),
                "the device's float32 sqrt is not the correctly rounded one")
    log(f"[tune] float32 sqrt on the card == float64 sqrt rounded once on "
        f"{inten.numel():,} library intensities and {rand.numel():,} uniform values")
    del inten, rand

    params, _, _, rk = check_blocks(torch, pipe, hvs, q_pmz, q_charge)
    n_real = int((pipe.db.orig_idx >= 0).sum())
    dim = pipe.cfg.dim
    TUNE_CACHE.unlink(missing_ok=True)
    counters = _counters()
    for c in counters.values():
        c.reset()
    tables = {}
    for backends, rows in (("kernel_vpu,kernel_mxu,fused,fused_mxu", rk),
                           ("rescore", n_real)):
        buf, ebuf = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(ebuf):
            oms.main(["tune", "--backends", backends, "--dim", str(dim), "--top-k", "1",
                      "--q", str(TUNE_QUERIES), "--rows", str(rows), "--grid", "default",
                      "--iters", str(TUNE_ITERS), "--cache", str(TUNE_CACHE),
                      "--full-table", "--device", DEVICE])
        log(f"[tune] `tune --backends {backends} --q {TUNE_QUERIES} --rows {rows} "
            f"--dim {dim}` in {time.perf_counter() - t0:.1f}s: "
            f"{ebuf.getvalue().strip().splitlines()[-1]}")
        for line in buf.getvalue().splitlines():
            log(f"[tune]   {line}")
        tables.update(_tune_table(buf.getvalue()))
    sweep_counts = {n: c.count for n, c in counters.items()}
    require(set(tables) == set(tune.SWEPT_BACKENDS), f"tune swept {sorted(tables)}")
    summary = {}
    for be, rows in sorted(tables.items()):
        default = next(r for r in rows if r["tiles"] == tune.kernel_defaults(be))
        win = rows[0]
        summary[be] = {"winner": win["tiles"], "winner_ms": win["us"] / 1e3,
                       "default_ms": default["us"] / 1e3,
                       "bound_ms": win["bound_us"] / 1e3, "fraction": win["frac"],
                       "default_fraction": default["frac"], "candidates": len(rows)}
        log(f"[tune] {be}: winner {win['tiles']} {win['us'] / 1e3:.4f} ms, default "
            f"{default['tiles']} {default['us'] / 1e3:.4f} ms "
            f"({default['us'] / win['us']:.3f}x), bound {win['bound_us'] / 1e3:.4f} ms, "
            f"fraction {win['frac']:.4f} (default {default['frac']:.4f}); "
            f"{len(rows)} candidates, each bit-identical to the defaults' output")
    log(f"[tune] winners {json.dumps(summary)}")

    # Tuned search and resident serve, in process: the same bytes, hits > 0.
    try:
        o, e, s_counts, t, _ = oms_in_process(
            [*search_args, "--tune-cache", TUNE_CACHE], [])
        require(_mask_times(o) == _mask_times(search_out),
                f"search --tune-cache printed otherwise:\n{o}\nvs\n{search_out}")
        hits, misses = _tune_stats(e, "search")
        require(hits > 0, f"search --tune-cache: no cache hit ({misses} misses)")
        log(f"[tune] search --tune-cache (in process, {t:.1f}s): stdout == the "
            f"untuned search's but for its clock readings; {hits} hits / {misses} "
            f"misses at dispatch")
        tune.reset_runtime()
        with open(head_file) as fin:
            o, e, v_counts, t, _ = oms_in_process(
                [*serve_args, "--resident", "--no-result-cache", "--tune-cache",
                 TUNE_CACHE], fin)
        n = STREAM_SERVE_REQUESTS
        require(o == "".join(res_lines[:n]),
                "serve --resident --tune-cache answered otherwise than untuned")
        hits, misses = _tune_stats(e, "serve")
        require(hits > 0, f"serve --tune-cache: no cache hit ({misses} misses)")
        log(f"[tune] serve --resident --tune-cache (in process, {t:.1f}s): {n} "
            f"responses byte-identical to the untuned serve's; {hits} hits / "
            f"{misses} misses at dispatch")
    finally:
        tune.reset_runtime()
    for k in ("hdencode", "fused_search"):
        require(s_counts[k] > 0 and v_counts[k] > 0, f"tuned search/serve launched no {k}")
    log(f"[tune] phase 17 (sweep, tuned search and serve) in "
        f"{time.perf_counter() - t_phase:.1f}s")
    by_path = {k: {} for k in (*counters, "hdencode")}
    for k, n in sweep_counts.items():
        if n:
            by_path[k]["tune sweep (in process)"] = n
    by_path["fused_search"]["search --tune-cache (in process)"] = s_counts["fused_search"]
    by_path["hdencode"]["search --tune-cache (in process)"] = s_counts["hdencode"]
    by_path["fused_search"][f"serve resident --tune-cache ({STREAM_SERVE_REQUESTS:,} "
                            f"requests, in process)"] = v_counts["fused_search"]
    by_path["hdencode"][f"serve resident --tune-cache ({STREAM_SERVE_REQUESTS:,} "
                        f"requests, in process)"] = v_counts["hdencode"]
    return by_path


def phase_analyze() -> None:
    """Phase 17, part 2: ``analyze --imports`` on the card (every recording
    under sync debug mode "error"); exits 0; n_checks and each
    combination's allocator peak."""
    from repro_torch.analysis import runner
    t0 = time.perf_counter()
    o, _, t = oms_cli(["analyze", "--imports", "--json", ANALYZE_REPORT,
                       "--device", DEVICE], "analyze")
    rep = json.loads(ANALYZE_REPORT.read_text())
    ANALYZE_REPORT.unlink()
    con = rep["contracts"]
    require(rep["imports"]["ok"] and con["ok"], f"analyze failed:\n{o[-3000:]}")
    peaks = runner.allocator_peaks(con)
    require(len(peaks) == con["n_combinations"] - 1,
            f"allocator peaks for {len(peaks)} of {con['n_combinations']} combinations")
    by_target = {}
    for c in con["combos"]:
        for r in c["contracts"]:
            if "allocator_bytes" in r:
                by_target[r["target"]] = max(by_target.get(r["target"], 0),
                                             r["allocator_bytes"])
    log(f"[analyze] `analyze --imports --device {DEVICE}` exited 0 (process {t:.1f}s): "
        f"{con['n_combinations']} combinations, n_checks {con['n_checks']}, "
        f"imports {rep['imports']['modules']} modules / {rep['imports']['edges']} edges; "
        f"{next(x for x in o.splitlines() if 'ALL CONTRACTS HOLD' in x)}")
    log(f"[analyze] allocator peak per combination (bytes, the largest rise of "
        f"torch.cuda.max_memory_allocated over one recorded call): {json.dumps(peaks)}")
    log(f"[analyze] allocator peak per target (bytes): {json.dumps(by_target)}")
    log(f"[analyze] phase 17 (analyze) in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# Phase 19: the dense LM serve path
# ---------------------------------------------------------------------------


def rel_err(a, ref) -> float:
    """max |a - ref| / max |ref|, in float32 on the host."""
    a, ref = a.float().cpu(), ref.float().cpu()
    return float((a - ref).abs().max() / ref.abs().max())


def _with_capacity(cfg, capacity_factor: float):
    import dataclasses
    return cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=capacity_factor))


def lm_width_check(torch, name: str) -> dict:
    """``name`` at full width and LM_WIDTH_LAYERS[name] layers in float32: a
    prefill and one decode step on the card and on the CPU on the same
    weights (a MoE arch at its own capacity factor and at n_experts). The
    weights are drawn on the card and copied to the host (the host's
    truncated-normal draw takes ~75 ns an element, minutes for these
    widths). Returns the logits' errors, per capacity factor for MoE."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(name).scaled(dtype="float32")
    if LM_WIDTH_LAYERS[name] is not None:
        cfg = cfg.scaled(n_layers=LM_WIDTH_LAYERS[name])
    variants = {"": cfg}
    if cfg.moe is not None:
        variants = {f"capacity_factor={cf:g}": _with_capacity(cfg, cf)
                    for cf in (cfg.moe.capacity_factor, float(cfg.moe.n_experts))}
    B, S = LM_WIDTH_B, LM_WIDTH_S
    rng = np.random.default_rng(SEED)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    step = {"token": rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = (0.1 * rng.standard_normal(
            (B, LM_VISION_TOKENS, cfg.d_model))).astype(np.float32)
        ar = np.arange(S)
        batch["positions3"] = np.ascontiguousarray(np.broadcast_to(
            np.stack([ar, ar // 2, ar % 3])[:, None], (3, B, S))).astype(np.int32)
        step["positions3"] = np.full((3, B, 1), S, np.int32)
    if cfg.family == "audio":
        batch["frame_embeds"] = (0.1 * rng.standard_normal((B, S, cfg.d_model))
                                 ).astype(np.float32)

    def run(params, dev):
        out = {}
        for what, c in variants.items():
            model = build_model(c, max_seq=S + 1, chunk=S)
            on = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            db = {k: torch.from_numpy(v).to(dev) for k, v in step.items()}
            logits, cache = model.prefill(params, on, model.init_cache(
                B, S + 1, enc_seq=S, device=dev))
            logits_d, _ = model.decode_step(params, cache, {**db, "index": S})
            out[what] = (logits.cpu(), logits_d.cpu())
        return out

    t0 = time.perf_counter()
    params = build_model(cfg, max_seq=S + 1).init_params(
        torch.Generator(DEVICE).manual_seed(SEED), DEVICE)
    n = sum(p.numel() for p in params.parameters())
    card = run(params, DEVICE)
    host = run(params.to("cpu"), "cpu")
    del params
    errs = {}
    for what in variants:
        e = {"prefill": rel_err(card[what][0], host[what][0]),
             "decode": rel_err(card[what][1], host[what][1])}
        for (step_name, err), logits in zip(e.items(), card[what]):
            require(err < LM_WIDTH_TOL and bool(torch.isfinite(logits).all()),
                    f"{name} {what} {step_name} logits: card against CPU {err:.3e} "
                    f"(max |Δ| / max |ref|, bound {LM_WIDTH_TOL}), finite "
                    f"{bool(torch.isfinite(logits).all())}")
        errs[what] = e
        log(f"[lm] {name} full width, {cfg.n_layers} layers, {n / 1e9:.3f} B params, "
            f"float32{' ' + what if what else ''}: prefill {B}x{S} logits card vs CPU "
            f"{e['prefill']:.3e}, decode {e['decode']:.3e} (bound {LM_WIDTH_TOL})")
    log(f"[lm] {name} width check {time.perf_counter() - t0:.1f}s")
    return errs if cfg.moe is not None else errs[""]


def moe_decode_check(torch, params, cfg, prompt, first, chunk: int) -> dict:
    """A MoE arch's decode of token P + 1 against its full forward over
    P + 1 at capacity_factor = n_experts (nothing drops), on the first
    LM_MOE_CHECK_BATCH[arch][dtype] sequences, in bf16 and then in float32 (the
    weights cast in place, TF32 off). Per sequence: the logits' error and
    the layers where the last token's K experts differ between the two
    (the router is discontinuous: where the K-th and (K+1)-th
    probabilities nearly tie, the 1-row and 513-row matmuls' roundings
    pick different experts). bf16 is held to LM_DECODE_TOL on the
    sequences routed alike in every layer; float32 on every sequence to
    LM_WIDTH_TOL."""
    from repro_torch.models import build_model
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    P = prompt.shape[1]
    orig, routes, out = M.route, [], {}

    def route(p, xt, c):
        r = orig(p, xt, c)
        routes.append(r[2].sort(-1).values)
        return r

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    M.route = route
    try:
        for dtype, nb in LM_MOE_CHECK_BATCH[cfg.name].items():
            if dtype == "float32":
                params.float()
            c = _with_capacity(cfg, float(cfg.moe.n_experts)).scaled(dtype=dtype)
            model = build_model(c, max_seq=P + 1, chunk=chunk)
            toks, nxt = prompt[:nb], first[:nb]
            nb = toks.shape[0]
            cache = model.init_cache(nb, P + 1, device=DEVICE)
            model.prefill(params, {"tokens": toks}, cache)
            routes.clear()
            logits_d, _ = model.decode_step(params, cache, {"token": nxt, "index": P})
            dec = list(routes)
            routes.clear()
            hid, _, _ = T.forward(params, c, torch.cat([toks, nxt], 1), chunk=chunk)
            ref = T.lm_head(params, c, hid[:, -1:])
            full = [r.reshape(nb, P + 1, -1)[:, -1] for r in routes]
            del cache, hid
            flips = [[i for i, (a, b) in enumerate(zip(dec, full)) if not torch.equal(a[q], b[q])]
                     for q in range(nb)]
            errs = [rel_err(logits_d[q], ref[q]) for q in range(nb)]
            out[dtype] = {"batch": nb, "err_per_sequence": errs, "flipped_layers": flips}
            log(f"[lm] {cfg.name} {dtype} decode of token {P + 1} against the full forward "
                f"(capacity_factor {cfg.moe.n_experts}), per sequence: errors "
                f"{', '.join(f'{e:.3e}' for e in errs)} of max |ref|; layers whose last-token "
                f"experts differ {flips}")
    finally:
        M.route = orig
        torch.backends.cuda.matmul.allow_tf32 = tf32
    alike = [e for e, f in zip(out["bfloat16"]["err_per_sequence"],
                               out["bfloat16"]["flipped_layers"]) if not f]
    out["bfloat16"].update(bound=LM_DECODE_TOL, held_on=len(alike))
    require(all(e < LM_DECODE_TOL for e in alike),
            f"{cfg.name} bf16 decode against the full forward, sequences routed alike: "
            f"{alike} of max |ref| (bound {LM_DECODE_TOL})")
    out["float32"]["bound"] = LM_WIDTH_TOL
    require(all(e < LM_WIDTH_TOL for e in out["float32"]["err_per_sequence"]),
            f"{cfg.name} float32 decode against the full forward: "
            f"{out['float32']['err_per_sequence']} of max |ref| (bound {LM_WIDTH_TOL})")
    return out


def _lm_inputs(cfg, prompt, frames) -> dict:
    """A prefill's batch: the tokens, and Whisper's frame embeddings."""
    return {"tokens": prompt, **({"frame_embeds": frames} if frames is not None else {})}


def _full_forward_logits(params, cfg, tokens, frames, chunk: int):
    """The last position's logits of a forward over ``tokens`` without a
    cache (Whisper: its encoder over ``frames``, then the decoder)."""
    from repro_torch.models import transformer as T
    from repro_torch.models import whisper as W
    if cfg.family == "audio":
        enc = W.encode(params, cfg, frames, chunk=chunk)
        hid, _ = W.decode(params, cfg, tokens, enc_out=enc, chunk=chunk)
        return W.lm_head(params, hid[:, -1:])
    hid, _, _ = T.forward(params, cfg, tokens, chunk=chunk)
    return T.lm_head(params, cfg, hid[:, -1:])


def _cache_bytes(cache) -> int:
    leaves = [t for v in cache.values() for t in (v.values() if isinstance(v, dict) else [v])]
    return sum(t.numel() * t.element_size() for t in leaves)


def _decode_vs_full(model, params, inputs, prompt, first, frames):
    """The decode of ``first`` after a prefill of ``inputs`` against the
    full forward over the prompt and ``first``: (max |Δ| / max |ref| of the
    logits, the full forward's logits)."""
    import torch
    B, P = prompt.shape
    enc = {"enc_seq": frames.shape[1]} if frames is not None else {}
    c1 = model.init_cache(B, P + 1, **enc, device=DEVICE)
    model.prefill(params, inputs, c1)
    logits_d, _ = model.decode_step(params, c1, {"token": first, "index": P})
    del c1
    ref = _full_forward_logits(params, model.cfg, torch.cat([prompt, first], 1), frames,
                               model.chunk)
    return rel_err(logits_d, ref), ref


def float32_decode_check(torch, model, params, prompt, first, frames, ref_bf16,
                         err_bf16: float) -> dict:
    """LM_DECODE_FLOAT32: the weights cast to float32 in place (TF32 off),
    the decode against the full forward held within LM_WIDTH_TOL; the bf16
    full forward's distance from the float32 one (the bf16 noise floor)
    printed beside it."""
    from repro_torch.models import build_model
    cfg = model.cfg.scaled(dtype="float32")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        params.float()
        m32 = build_model(cfg, max_seq=model.max_seq, chunk=model.chunk)
        f32 = None if frames is None else frames.float()
        err, ref = _decode_vs_full(m32, params, _lm_inputs(cfg, prompt, f32), prompt,
                                   first, f32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    floor = rel_err(ref_bf16, ref)
    log(f"[lm] {cfg.name} decode of token {prompt.shape[1] + 1} against the full forward: "
        f"bf16 {err_bf16:.3e} of max |ref| (not held: the bf16 full forward is {floor:.3e} "
        f"from the float32 one), float32 {err:.3e} (bound {LM_WIDTH_TOL})")
    require(err < LM_WIDTH_TOL, f"{cfg.name} float32 decode against the full forward: "
            f"{err:.3e} of max |ref| (bound {LM_WIDTH_TOL})")
    return {"max_abs_err_over_max_ref": err, "bound": LM_WIDTH_TOL,
            "bf16_full_vs_float32_full": floor, "batch": prompt.shape[0]}


def lm_full_model(torch, arch: str) -> dict:
    """``arch`` at full width and depth in bf16 on the card, at
    LM_FULL_SHAPES[arch] = (B, P, G): parameter counts, the prefill of B x P
    (Whisper: its encoder over P frames, then the decoder; CUDA events,
    median of LM_PREFILL_ITERS after a warm-up) and G greedy decode steps at
    index P + i (CUDA events around each step: decode_step and the argmax),
    each against its bound from ``utils/roofline.py``; then the decode of
    token P + 1 against a full forward over it (a MoE arch at
    capacity_factor = n_experts on LM_MOE_CHECK_BATCH sequences)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.utils import roofline as R
    cfg = get_config(arch)
    B, P, G = LM_FULL_SHAPES[arch]
    model = build_model(cfg, max_seq=P + G, chunk=min(512, P))
    counts = R.lm_param_counts(cfg, max_dec_seq=model.max_seq)
    bpe = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    audio = cfg.family == "audio"
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        t0 = time.perf_counter()
        params = model.init_params(torch.Generator(DEVICE).manual_seed(SEED), DEVICE)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_padded = sum(p.numel() for p in params.parameters())
        gen = torch.Generator(DEVICE).manual_seed(SEED + 1)
        prompt = torch.randint(0, cfg.vocab_size, (B, P), device=DEVICE, generator=gen)
        frames = (0.1 * torch.randn((B, P, cfg.d_model), device=DEVICE, generator=gen)
                  ).to(getattr(torch, cfg.dtype)) if audio else None
        inputs = _lm_inputs(cfg, prompt, frames)
        enc = {"enc_seq": P} if audio else {}
        cache = model.init_cache(B, P + G, **enc, device=DEVICE)
        cache_bytes = _cache_bytes(cache)

        def prefill():
            return model.prefill(params, inputs, cache)

        prefill_ms = cuda_ms(prefill, iters=LM_PREFILL_ITERS)
        logits, _ = prefill()
        token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        first = token
        events = []
        for i in range(G):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            logits, _ = model.decode_step(params, cache, {"token": token, "index": P + i})
            token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            ev[1].record()
            events.append(ev)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(logits).all()), f"{arch} decode logits are not finite")
        step_ms = [a.elapsed_time(b) for a, b in events]

        # the device's busy share: one prefill, then LM_PROFILE_STEPS steps
        prof_cache = model.init_cache(B, P + G, **enc, device=DEVICE)
        profiles = {}
        for what in ("prefill", "decode"):
            torch.cuda.synchronize()
            with serve_profiler(torch) as prof:
                t0 = time.perf_counter()
                if what == "prefill":
                    model.prefill(params, inputs, prof_cache)
                else:
                    tok = first
                    for i in range(min(LM_PROFILE_STEPS, G)):
                        lg, _ = model.decode_step(params, prof_cache,
                                                  {"token": tok, "index": P + i})
                        tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            profiles[what] = device_profile(prof, wall, top=LM_PROFILE_TOP)
            profiles[what].pop("kernels")
        del prof_cache

        # decode against the full forward over the prompt and its first token
        del cache
        if cfg.moe is None:
            decode_err, ref = _decode_vs_full(model, params, inputs, prompt, first, frames)
            check = {"max_abs_err_over_max_ref": decode_err, "bound": LM_DECODE_TOL,
                     "batch": B}
            if arch not in LM_DECODE_FLOAT32:
                require(decode_err < LM_DECODE_TOL,
                        f"{arch} bf16 decode of token {P + 1} against the full forward: "
                        f"{decode_err:.3e} of max |ref| (bound {LM_DECODE_TOL})")
        peak = torch.cuda.max_memory_allocated()
        if cfg.moe is not None:
            check = moe_decode_check(torch, params, cfg, prompt, first, model.chunk)
        elif arch in LM_DECODE_FLOAT32:
            check = {"bfloat16": {**check, "held": False},
                     "float32": float32_decode_check(torch, model, params, prompt, first,
                                                     frames, ref, decode_err)}
        del params
    torch.cuda.empty_cache()

    kw = {"enc_seq": P, "chunk": model.chunk}
    pre = R.lm_step_roofline(cfg, B, P, P, **kw)
    dec = [R.lm_step_roofline(cfg, B, 1, P + i + 1, **kw) for i in range(G)]
    med = statistics.median(step_ms)
    out = {
        "arch": arch, "dtype": cfg.dtype, "layers": cfg.n_layers,
        "params_real": counts["total"], "params_padded": n_padded,
        "param_bytes_real": counts["total"] * bpe, "param_bytes_padded": n_padded * bpe,
        "init_s": init_s, "kv_cache_bytes": cache_bytes,
        "prefill": {"batch": B, "prompt": P, "ms": prefill_ms,
                    "tokens_per_s": B * P / (prefill_ms / 1e3),
                    "flops": pre.flops, "model_flops": pre.model_flops,
                    "bound_ms": pre.t_bound * 1e3, "bound_by": pre.bound_by,
                    "hbm_bound_share": pre.t_memory * 1e3 / prefill_ms,
                    "mfu": pre.model_flops / (prefill_ms / 1e3) / R.PEAK_FLOPS_BF16},
        "decode": {"batch": B, "steps": G, "context": [P + 1, P + G],
                   "ms_median": med, "ms_mean": statistics.fmean(step_ms),
                   "ms_min": min(step_ms), "ms_max": max(step_ms),
                   "tokens_per_s": B / (med / 1e3),
                   "hbm_bound_ms_median": statistics.median(r.t_memory for r in dec) * 1e3,
                   "bound_by": dec[G // 2].bound_by,
                   "hbm_bound_share": sum(r.t_memory for r in dec) * 1e3 / sum(step_ms),
                   "mfu": (sum(r.model_flops for r in dec) / (sum(step_ms) / 1e3)
                           / R.PEAK_FLOPS_BF16)},
        "decode_vs_full": check,
        "device_profile": {"prefill": profiles["prefill"],
                           f"decode_{min(LM_PROFILE_STEPS, G)}_steps": profiles["decode"]},
        "peak_bytes": peak, "peak_bytes_above_baseline": peak - base,
    }
    if audio:
        out["prefill"]["encoder_frames"] = P
    if cfg.moe is not None:
        out["params_active"] = counts["active"]
        out["capacity_factor"] = {"prefill_and_decode": cfg.moe.capacity_factor,
                                  "decode_vs_full": float(cfg.moe.n_experts)}
    log(f"[lm] {arch} bf16, {cfg.n_layers} layers: {counts['total'] / 1e9:.3f} B params "
        f"real ({out['param_bytes_real'] / 1e9:.2f} GB), {n_padded / 1e9:.3f} B padded "
        f"({out['param_bytes_padded'] / 1e9:.2f} GB); init on the card {init_s:.2f}s")
    log(f"[lm] {arch} prefill {B}x{P}{f' ({P} encoder frames)' if audio else ''}: "
        f"{prefill_ms:.3f} ms (median of {LM_PREFILL_ITERS}), "
        f"{out['prefill']['tokens_per_s']:.0f} tok/s, {pre.flops / 1e12:.3f} TFLOP "
        f"({pre.model_flops / 1e12:.3f} useful), bound {pre.t_bound * 1e3:.3f} ms "
        f"({pre.bound_by}), MFU {out['prefill']['mfu']:.4f}, share of the HBM bound "
        f"{out['prefill']['hbm_bound_share']:.4f}")
    log(f"[lm] {arch} decode B={B}, context {P + 1}..{P + G}: {med:.3f} ms a step (median "
        f"of {G}; mean {out['decode']['ms_mean']:.3f}, min {min(step_ms):.3f}, max "
        f"{max(step_ms):.3f}), {out['decode']['tokens_per_s']:.0f} tok/s; HBM bound "
        f"{out['decode']['hbm_bound_ms_median']:.3f} ms, share "
        f"{out['decode']['hbm_bound_share']:.4f}, MFU {out['decode']['mfu']:.5f}")
    for what, pr in profiles.items():
        log(f"[lm] {arch} device profile, {what}"
            f"{f' ({min(LM_PROFILE_STEPS, G)} steps)' if what == 'decode' else ''}: busy "
            f"{pr['busy_ms']:.3f} of {pr['wall_ms']:.3f} ms wall, idle share "
            f"{pr['idle_share']:.4f}, {pr['n_events']} device events; top kernels "
            f"[name, launches, ms]: {json.dumps(pr['top_kernels'])}")
    if cfg.moe is None and arch not in LM_DECODE_FLOAT32:
        log(f"[lm] {arch} decode of token {P + 1} against the full forward over {P + 1}: "
            f"{check['max_abs_err_over_max_ref']:.3e} of max |ref| (bound {LM_DECODE_TOL})")
    log(f"[lm] {arch} peak device memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} "
        f"GiB above the phase's baseline); cache {cache_bytes / 1e9:.3f} GB")
    return out


def lm_layer_times(torch) -> dict:
    """The new families' layers alone in bf16 at the serve shapes, on one
    layer of random weights (CUDA events, median of LM_PREFILL_ITERS after
    a warm-up; host launch gaps included): OLMoE's MoE FFN whole and its
    routing + dispatch plan at the 8 x 512 prefill and an 8-token decode
    step, RecurrentGemma-9B's RG-LRU scan (gates and the log-depth scan)
    and recurrent block at 4 x 512, xLSTM-1.3B's mLSTM and sLSTM blocks at
    4 x 512 (the sLSTM's 512-step time loop) and one sLSTM decode step, and
    Whisper-base's decoder cross-attention over 512 cached frames at 8
    tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    from repro_torch.models import rglru as RG
    from repro_torch.models import whisper as W
    from repro_torch.models import xlstm as X
    dt = torch.bfloat16
    gen = torch.Generator(DEVICE).manual_seed(SEED)

    def x(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dt)

    out = {}

    def timed(name, fn, shape):
        ms = cuda_ms(fn, iters=LM_PREFILL_ITERS)
        out[name] = {"shape": list(shape), "ms": ms}
        log(f"[lm] layer {name} {list(shape)}: {ms:.3f} ms")

    with torch.inference_mode():
        cfg = get_config("olmoe-1b-7b")
        p = M.moe_init(gen, cfg, dt, DEVICE)
        for what, shape in (("prefill", (8, 512, cfg.d_model)), ("decode", (8, 1, cfg.d_model))):
            h = x(*shape)
            T = shape[0] * shape[1]
            timed(f"moe_apply {what}", lambda: M.moe_apply(p, h, cfg), shape)
            timed(f"moe route+dispatch {what}", lambda: M.dispatch(
                M.route(p, h.reshape(T, -1), cfg)[2], cfg.moe.n_experts, M.capacity(T, cfg)),
                shape)
        del p
        cfg = get_config("recurrentgemma-9b")
        p = RG.rglru_init(gen, cfg.d_model, cfg.lru_width, cfg.conv_width, dt, DEVICE)
        h = x(4, 512, cfg.lru_width)
        timed("rglru_scan prefill", lambda: RG.rglru_scan(p, h), h.shape)
        h = x(4, 512, cfg.d_model)
        timed("rec_block_apply prefill", lambda: RG.rec_block_apply(p, h), h.shape)
        del p
        cfg = get_config("xlstm-1.3b")
        p = X.mlstm_init(gen, cfg.d_model, cfg.n_heads, cfg.conv_width, dt, DEVICE)
        h = x(4, 512, cfg.d_model)
        timed("mlstm_block_apply prefill", lambda: X.mlstm_block_apply(p, h, cfg.n_heads), h.shape)
        p = X.slstm_init(gen, cfg.d_model, cfg.n_heads, dt, DEVICE)
        timed("slstm_block_apply prefill (512-step loop)",
              lambda: X.slstm_block_apply(p, h, cfg.n_heads), h.shape)
        st = {k: torch.zeros((4, cfg.d_model), device=DEVICE) for k in X.SLSTM_STATE}
        h1 = x(4, 1, cfg.d_model)
        timed("slstm_block_apply decode", lambda: X.slstm_block_apply(
            p, h1, cfg.n_heads, cache=st, decode=True), h1.shape)
        del p
        cfg = get_config("whisper-base")
        p = W._dec_block_init(gen, cfg, dt, DEVICE)["cross_attn"]
        ck, cv = W.cross_kv(p, x(8, 512, cfg.d_model))
        h = x(8, 1, cfg.d_model)
        timed("whisper cross-attention decode (512 frames)",
              lambda: W._cross_attn(p, h, ck, cv, 512), h.shape)
    return out


def phase_lm(torch, env) -> dict:
    """Phase 19: the width checks in float32 (TF32 off), ``python -m
    repro_torch.launch.serve`` for each arch of LM_SERVE_RUNS as a
    subprocess, one after another (each exits 0 and prints its ``[serve]``
    line), the full models of LM_FULL_ARCHS in process, then the new
    families' layers alone. Returns the ``lm`` JSON line's object, keyed by
    arch."""
    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        width = {name: lm_width_check(torch, name) for name in LM_WIDTH_LAYERS}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    serve = {}
    for arch, (b, plen, gen) in LM_SERVE_RUNS.items():
        args = ["--arch", arch, "--batch", b, "--prompt-len", plen, "--gen", gen]
        o, _, t = oms_cli(args, f"lm serve {arch}", module="serve")
        lines = [x for x in o.splitlines() if x.startswith("[serve] generated ")]
        require(len(lines) == 1 and f"generated {b * gen} tokens" in lines[0],
                f"`serve {' '.join(map(str, args))}` printed no [serve] line:\n{o}")
        log(f"[lm] `serve {' '.join(map(str, args))}` exited 0 (process {t:.1f}s): "
            f"{lines[0]}")
        serve[arch] = {"args": " ".join(map(str, args)), "line": lines[0], "process_s": t}
    full = {arch: lm_full_model(torch, arch) for arch in LM_FULL_ARCHS}
    layers = lm_layer_times(torch)
    dt = time.perf_counter() - t_phase
    log(f"[lm] phase 19 in {dt:.1f}s")
    return {"card": env["smi"], "width_check_float32": width, "serve_cli": serve,
            "full_model": full, "layers_bf16": layers, "phase_s": dt}


# ---------------------------------------------------------------------------
# Phase 20: LM training
# ---------------------------------------------------------------------------


def _reference_leaves(tree) -> dict:
    """A parameter-shaped module (params, a gradient list made one, m, v)
    in the reference's stacked layout, flattened to {keystr path: tensor}."""
    from repro_torch.convert import lm_params_to_reference

    def flat(d, prefix=""):
        out = {}
        for k in sorted(d):
            if isinstance(d[k], dict):
                out.update(flat(d[k], f"{prefix}[{k!r}]"))
            else:
                out[f"{prefix}[{k!r}]"] = d[k]
        return out

    return flat(lm_params_to_reference(tree))


def _leaf_errs(card: dict, host: dict) -> dict:
    """max |card - host| / max |host| per leaf (0 where both are 0)."""
    out = {}
    for k, h in host.items():
        h = h.float()
        d = float((card[k].float().cpu() - h).abs().max())
        out[k] = d / (float(h.abs().max()) or 1.0)
    return out


def _params_bound_excess(card: dict, host: dict, v: dict, lr: float, steps: int) -> tuple:
    """The params after AdamW steps: each element within TRAIN_TOL of its
    leaf's max |CPU| plus the error the optimizer propagates from the
    gradients, 4 lr ``steps`` min(1, TRAIN_TOL max(rms) / rms) (Adam divides
    each gradient element by its RMS ``sqrt(v)``, so an element whose
    gradient lies at the rounding level takes an O(lr) step of either sign
    on either device). Returns (the largest max |Δ| / max |CPU| of any leaf,
    the number of elements past TRAIN_TOL of their leaf's max, the largest
    ratio of |Δ| to its bound)."""
    worst, past, ratio = 0.0, 0, 0.0
    for k, h in host.items():
        h = h.float()
        d = (card[k].float().cpu() - h).abs()
        scale = float(h.abs().max()) or 1.0
        rms = v[k].float().sqrt()
        rel = (TRAIN_TOL * float(rms.max()) / rms.clamp(min=1e-30)).clamp(max=1.0)
        bound = TRAIN_TOL * scale + 4 * lr * steps * rel
        worst = max(worst, float(d.max()) / scale)
        past += int((d > TRAIN_TOL * scale).sum())
        ratio = max(ratio, float((d / bound).max()))
    return worst, past, ratio


def _state_on(state, device):
    """A copy of a TrainState on ``device``, every leaf in its own dtype."""
    from repro_torch.train.step import TrainState
    from repro_torch.utils.treeutil import tree_map

    def to(tree):
        return None if tree is None else tree_map(
            lambda t: t.detach().to(device).requires_grad_(t.requires_grad), tree)

    return TrainState(params=to(state.params), opt=to(state.opt), step=state.step.to(device),
                      grad_err=to(state.grad_err))


def train_width_check(torch, name: str) -> dict:
    """``name`` at full width and TRAIN_WIDTH_LAYERS layers in float32 (MoE
    at TRAIN_MOE_CAPACITY): the weights drawn on the card, the same state
    carried to the host (``convert.train_state_to_reference`` and back);
    the gradients of the first batch, then TRAIN_WIDTH_STEPS train steps
    (warmup 1) on both, the losses within TRAIN_LOSS_TOL, every gradient,
    ``m`` and ``v`` leaf within TRAIN_TOL of its max |CPU| and the params
    within the bound of ``_params_bound_excess``."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_batches
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step, value_and_grad
    from repro_torch.utils.treeutil import tree_unflatten_like
    cfg = get_config(name).scaled(dtype="float32", n_layers=TRAIN_WIDTH_LAYERS)
    if cfg.moe is not None:
        cfg = _with_capacity(cfg, TRAIN_MOE_CAPACITY)
    B, S = TRAIN_WIDTH_B, TRAIN_WIDTH_S
    model = build_model(cfg, max_seq=S, chunk=S)
    opt = AdamWConfig()
    t0 = time.perf_counter()
    card = init_train_state(model, torch.Generator(DEVICE).manual_seed(SEED), device=DEVICE)
    host = _state_on(card, "cpu")
    n = sum(p.numel() for p in card.params.parameters())
    data = synthetic_batches(cfg, batch=B, seq=S, family=cfg.family, seed=SEED, device="cpu")
    batches = [next(data) for _ in range(TRAIN_WIDTH_STEPS)]

    def on(batch, dev):
        return {k: v.to(dev) for k, v in batch.items()}

    grads = {}
    losses = {}
    for dev, st in ((DEVICE, card), ("cpu", host)):
        loss, g = value_and_grad(model, st.params, on(batches[0], dev))
        grads[dev] = _reference_leaves(tree_unflatten_like(st.params, g))
        losses[dev] = [float(loss)]
        del g
    grad_errs = _leaf_errs(grads[DEVICE], grads["cpu"])
    del grads
    step = make_train_step(model, opt, warmup=1, total_steps=10)
    step_losses = {}
    for dev, st in ((DEVICE, card), ("cpu", host)):
        step_losses[dev] = []
        for b in batches:
            st, met = step(st, on(b, dev))
            step_losses[dev].append(float(met["loss"]))
    loss_errs = [abs(a - b) / abs(b) for a, b in zip(losses[DEVICE] + step_losses[DEVICE],
                                                     losses["cpu"] + step_losses["cpu"])]
    m_errs = _leaf_errs(_reference_leaves(card.opt["m"]), _reference_leaves(host.opt["m"]))
    v_host = _reference_leaves(host.opt["v"])
    v_errs = _leaf_errs(_reference_leaves(card.opt["v"]), v_host)
    p_worst, p_past, p_ratio = _params_bound_excess(
        _reference_leaves(card.params), _reference_leaves(host.params), v_host, opt.lr,
        TRAIN_WIDTH_STEPS)
    del card, host
    out = {"layers": cfg.n_layers, "params": n, "batch": [B, S],
           "capacity_factor": cfg.moe.capacity_factor if cfg.moe is not None else None,
           "loss_rel_err": max(loss_errs), "grad_err": max(grad_errs.values()),
           "grad_worst_leaf": max(grad_errs, key=grad_errs.get),
           "m_err": max(m_errs.values()), "v_err": max(v_errs.values()),
           "params_err": p_worst, "params_elements_past_tol": p_past,
           "params_bound_ratio": p_ratio, "losses_card": step_losses[DEVICE]}
    log(f"[train] {name} full width, {cfg.n_layers} layers, {n / 1e9:.3f} B params, "
        f"float32{'' if cfg.moe is None else f' capacity_factor={cfg.moe.capacity_factor:g}'}"
        f": card vs CPU loss {max(loss_errs):.3e} (bound {TRAIN_LOSS_TOL}), gradients "
        f"{out['grad_err']:.3e} ({out['grad_worst_leaf']}), after {TRAIN_WIDTH_STEPS} "
        f"steps m {out['m_err']:.3e}, v {out['v_err']:.3e} (bound {TRAIN_TOL}), params "
        f"{p_worst:.3e} of max |CPU| ({p_past} elements past {TRAIN_TOL}, largest share "
        f"of the propagated bound {p_ratio:.3f}); {time.perf_counter() - t0:.1f}s")
    require(max(loss_errs) < TRAIN_LOSS_TOL, f"{name} train losses card vs CPU: {loss_errs}")
    for what, errs in (("gradient", grad_errs), ("m", m_errs), ("v", v_errs)):
        bad = {k: e for k, e in errs.items() if not e < TRAIN_TOL}
        require(not bad, f"{name} {what} leaves card vs CPU past {TRAIN_TOL}: {bad}")
    require(p_ratio <= 1.0, f"{name} params card vs CPU past their bound: {p_ratio:.3f}")
    return out


def train_full_model(torch, B: int) -> dict:
    """TRAIN_ARCH at full width and depth in bf16 with remat: one warm-up
    step, TRAIN_STEPS steps timed with CUDA events (and on the host clock,
    ended by the loss's read), one step under torch.profiler (device
    activity only), then the gradients and the AdamW update of one step
    timed apart; each step's loss and grad_norm finite."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_batches
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.train.step import init_train_state, make_train_step, value_and_grad
    from repro_torch.utils import roofline as R
    from repro_torch.utils.treeutil import tree_bytes
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg, max_seq=TRAIN_SEQ, chunk=TRAIN_SEQ, remat=True)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator(DEVICE).manual_seed(SEED), device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_padded = sum(p.numel() for p in state.params.parameters())
    state_bytes = {"params": tree_bytes(state.params),
                   "m_v": tree_bytes(state.opt["m"]) + tree_bytes(state.opt["v"])}
    step = make_train_step(model, AdamWConfig(), warmup=1, total_steps=TRAIN_STEPS + 2)
    data = synthetic_batches(cfg, batch=B, seq=TRAIN_SEQ, family=cfg.family, seed=SEED,
                             device=DEVICE)
    batches = [next(data) for _ in range(TRAIN_STEPS + 2)]
    losses, gnorms, ms, wall = [], [], [], []
    for batch in batches[:-1]:
        torch.cuda.synchronize()
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        ev[0].record()
        state, met = step(state, batch)
        ev[1].record()
        losses.append(float(met["loss"]))
        wall.append((time.perf_counter() - t0) * 1e3)
        gnorms.append(float(met["grad_norm"]))
        ms.append(ev[0].elapsed_time(ev[1]))
        require(math.isfinite(losses[-1]) and math.isfinite(gnorms[-1]),
                f"{TRAIN_ARCH} train step {len(losses) - 1}: loss {losses[-1]}, "
                f"grad_norm {gnorms[-1]}")
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    with serve_profiler(torch) as prof:
        t0 = time.perf_counter()
        state, met = step(state, batches[-1])
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    profile = device_profile(prof, prof_wall, top=LM_PROFILE_TOP)
    profile.pop("kernels")
    # where a step goes: the gradients (forward, recompute, backward) and
    # the AdamW update alone, each between CUDA events
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    _, grads = value_and_grad(model, state.params, batches[-1])
    ev[1].record()
    adamw_update(state.params, grads, state.opt, AdamWConfig())
    ev[2].record()
    torch.cuda.synchronize()
    split = {"grads_ms": ev[0].elapsed_time(ev[1]), "adamw_ms": ev[1].elapsed_time(ev[2])}
    # AdamW's bound: read params, grads (bf16), m, v (float32); write params, m, v
    adamw_bytes = sum(p.numel() * (3 * p.element_size() + 16)
                      for p in state.params.parameters())
    split["adamw_bound_ms"] = adamw_bytes / R.HBM_BYTES_PER_S * 1e3
    del state, met, batches, grads
    roof = R.lm_train_roofline(cfg, B, TRAIN_SEQ, remat=True)
    med = statistics.median(ms[1:])
    out = {"arch": TRAIN_ARCH, "dtype": cfg.dtype, "layers": cfg.n_layers, "remat": True,
           "batch": B, "seq": TRAIN_SEQ, "params_real": R.lm_param_counts(cfg)["total"],
           "params_padded": n_padded, "state_bytes": state_bytes, "init_s": init_s,
           "step_ms": ms[1:], "step_ms_median": med, "warmup_step_ms": ms[0],
           "step_wall_ms": wall[1:], "losses": losses, "grad_norms": gnorms,
           "tokens_per_s": B * TRAIN_SEQ / (med / 1e3),
           "flops": roof.flops, "model_flops": roof.model_flops,
           "bound_ms": roof.t_bound * 1e3, "bound_by": roof.bound_by,
           "mfu": roof.model_flops / (med / 1e3) / R.PEAK_FLOPS_BF16,
           "bound_share": roof.t_bound * 1e3 / med,
           "peak_bytes": peak, "peak_bytes_above_baseline": peak - base,
           "device_profile_one_step": profile, "split": split}
    log(f"[train] {TRAIN_ARCH} bf16, {cfg.n_layers} layers, remat: {n_padded / 1e9:.3f} B "
        f"params as padded; params {state_bytes['params'] / 1e9:.2f} GB, m + v "
        f"{state_bytes['m_v'] / 1e9:.2f} GB; init on the card {init_s:.2f}s")
    log(f"[train] step {B}x{TRAIN_SEQ}: {med:.3f} ms (median of {TRAIN_STEPS}; "
        f"{', '.join(f'{x:.2f}' for x in ms[1:])}; warm-up {ms[0]:.2f}; host clock "
        f"{statistics.median(wall[1:]):.2f}), {out['tokens_per_s']:.0f} tok/s, "
        f"{roof.model_flops / 1e12:.2f} TFLOP (6NT-style, {roof.flops / 1e12:.2f} with "
        f"the recompute), bound {roof.t_bound * 1e3:.3f} ms ({roof.bound_by}), MFU "
        f"{out['mfu']:.4f}")
    log(f"[train] losses {', '.join(f'{x:.4f}' for x in losses)}; grad_norm "
        f"{', '.join(f'{x:.4f}' for x in gnorms)}")
    log(f"[train] peak device memory {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} "
        f"GiB above the phase's baseline)")
    log(f"[train] one step's parts (CUDA events): gradients {split['grads_ms']:.3f} ms, "
        f"AdamW update {split['adamw_ms']:.3f} ms (its bound {split['adamw_bound_ms']:.3f} "
        f"ms, bytes)")
    log(f"[train] device profile of one step: busy {profile['busy_ms']:.3f} of "
        f"{profile['wall_ms']:.3f} ms wall, idle share {profile['idle_share']:.4f}, "
        f"{profile['n_events']} device events; top kernels [name, launches, ms]: "
        f"{json.dumps(profile['top_kernels'])}")
    return out


def train_launcher() -> dict:
    """``python -m repro_torch.launch.train`` (TRAIN_CLI) as subprocesses:
    ``--fail-at 12`` exits nonzero with SimulatedFailure after committing
    step 10; the same command without it resumes at 10, logs the 10 losses
    of steps 10..19 and ends at 20; ``--compress-grads`` from a fresh
    directory ends with its last loss below its first."""
    import re
    from repro_torch.checkpoint import latest_step
    fresh = TRAIN_CKPT_DIR.with_name(TRAIN_CKPT_DIR.name + "_compressed")
    for d in (TRAIN_CKPT_DIR, fresh):
        shutil.rmtree(d, ignore_errors=True)
    args = [*TRAIN_CLI, "--ckpt-dir", TRAIN_CKPT_DIR.relative_to(HERE)]
    out = {}
    try:
        _, err, t = oms_cli([*args, "--fail-at", 12], "train --fail-at 12", module="train",
                            expect_failure=True)
        committed = latest_step(str(TRAIN_CKPT_DIR))
        require("SimulatedFailure: injected failure at step 12" in err and committed == 10,
                f"train --fail-at 12: committed step {committed}; stderr:\n{err[-2000:]}")
        out["fail_at_12"] = {"process_s": t, "committed": committed}
        o, _, t = oms_cli(args, "train (resume)", module="train")
        steps = [int(x) for x in re.findall(r"^\[loop\] step (\d+) loss=", o, re.M)]
        done = [x for x in o.splitlines() if x.startswith("[train] done at step ")]
        require("[loop] resuming from checkpoint step 10" in o and steps == list(range(10, 20))
                and len(done) == 1 and done[0].startswith("[train] done at step 20;"),
                f"train resume: steps {steps}, output:\n{o[-2000:]}")
        out["resume"] = {"process_s": t, "line": done[0], "steps_logged": len(steps)}
        o, _, t = oms_cli([*TRAIN_CLI, "--ckpt-dir", fresh.relative_to(HERE),
                           "--compress-grads"], "train --compress-grads", module="train")
        m = re.search(r"^\[train\] done at step 20; loss (\S+) -> (\S+);", o, re.M)
        require(m is not None and float(m.group(2)) < float(m.group(1)),
                f"train --compress-grads: the last loss is not below the first:\n{o[-2000:]}")
        out["compress_grads"] = {"process_s": t, "line": m.group(0),
                                 "first": float(m.group(1)), "last": float(m.group(2))}
    finally:
        for d in (TRAIN_CKPT_DIR, fresh):
            shutil.rmtree(d, ignore_errors=True)
    for what, r in out.items():
        log(f"[train] launcher {what}: {json.dumps(r)}")
    return out


def train_checkpoint_on_card(torch) -> dict:
    """The llama3.2-3b smoke config in bf16 trained two steps on the card,
    saved, restored into a state of another init on the card: bit-equal;
    the same state carried to the host and saved there: manifest equal
    (names, files, shapes, dtypes, stored dtypes, shas)."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced_for_smoke
    from repro_torch.data.tokens import synthetic_batches
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.utils.treeutil import tree_leaves
    cfg = reduced_for_smoke(get_config(TRAIN_ARCH))
    model = build_model(cfg, max_seq=64, chunk=64)
    state = init_train_state(model, torch.Generator(DEVICE).manual_seed(SEED), device=DEVICE)
    step = make_train_step(model, AdamWConfig(lr=1e-2), warmup=1, total_steps=4)
    data = synthetic_batches(cfg, batch=4, seq=64, family=cfg.family, seed=SEED, device=DEVICE)
    for _ in range(2):
        state, _ = step(state, next(data))
    card_dir, host_dir = (TRAIN_CKPT_DIR.with_name(TRAIN_CKPT_DIR.name + x)
                          for x in ("_card", "_host"))
    try:
        card_path = save_checkpoint(str(card_dir), 2, state)
        host_path = save_checkpoint(str(host_dir), 2, _state_on(state, "cpu"))
        target = init_train_state(model, torch.Generator(DEVICE).manual_seed(SEED + 1),
                                  device=DEVICE)
        restore_checkpoint(str(card_dir), 2, target)
        pairs = list(zip(tree_leaves([state.params, state.opt["m"], state.opt["v"],
                                      state.opt["step"], state.step]),
                         tree_leaves([target.params, target.opt["m"], target.opt["v"],
                                      target.opt["step"], target.step])))
        equal_bits = all(a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
                         for a, b in pairs)
        manifests = [json.loads((Path(p) / "manifest.json").read_text())
                     for p in (card_path, host_path)]
    finally:
        for d in (card_dir, host_dir):
            shutil.rmtree(d, ignore_errors=True)
    out = {"leaves": len(manifests[0]["leaves"]), "restored_bit_equal": equal_bits,
           "manifest_equal_to_host": manifests[0] == manifests[1],
           "bf16_leaves": sum(x["dtype"] == "bfloat16" for x in manifests[0]["leaves"])}
    log(f"[train] checkpoint on the card: {json.dumps(out)}")
    require(equal_bits and out["manifest_equal_to_host"] and out["bf16_leaves"] > 0,
            f"checkpoint on the card: {out}")
    return out


def phase_train(torch, env) -> dict:
    """Phase 20: the width checks in float32 (TF32 off), the full-width
    training steps, the launcher's fail / resume / compressed runs and the
    checkpoint on the card. Returns the ``train`` JSON line's object."""
    import gc
    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        width = {name: train_width_check(torch, name) for name in TRAIN_WIDTH_ARCHS}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    gc.collect()
    full, why = None, None
    for B in (TRAIN_BATCH, TRAIN_BATCH // 2):
        try:
            full = train_full_model(torch, B)
            break
        except torch.cuda.OutOfMemoryError as e:
            if B != TRAIN_BATCH:
                raise
            why = f"B={B} ran out of device memory: {str(e).splitlines()[0]}"
        log(f"[train] {why}; taking B={TRAIN_BATCH // 2}")
        gc.collect()
        torch.cuda.empty_cache()
    full["smaller_batch_because"] = why
    gc.collect()
    torch.cuda.empty_cache()
    ckpt = train_checkpoint_on_card(torch)
    cli = train_launcher()
    dt = time.perf_counter() - t_phase
    log(f"[train] phase 20 in {dt:.1f}s")
    return {"card": env["smi"], "width_check_float32": width, "full_model": full,
            "launcher": cli, "checkpoint": ckpt, "phase_s": dt}


# ---------------------------------------------------------------------------
# Phase 21: LM distribution
# ---------------------------------------------------------------------------


def dist_pipeline(torch) -> dict:
    """(a) The GPipe schedule over 4 entries of the card against the
    sequential loop over the same blocks, float32, TF32 off."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg = get_config(DIST_ARCH).scaled(n_layers=PIPE_LAYERS, dtype="float32")
    dev = torch.empty(0, device=DEVICE).device      # with its index
    g = torch.Generator(DEVICE).manual_seed(SEED)
    params = build_model(cfg, max_seq=PIPE_SEQ, chunk=PIPE_SEQ).init_params(g, dev)
    blocks = list(zip(params.blocks, params.layout))
    per = PIPE_LAYERS // PIPE_STAGES
    stages = [blocks[s * per:(s + 1) * per] for s in range(PIPE_STAGES)]
    positions = torch.arange(PIPE_SEQ, device=dev)[None].expand(PIPE_MB, PIPE_SEQ)
    cos_sin = L.rope_cos_sin(cfg, positions)

    def layer_fn(stage_blocks, h):
        for p, btype in stage_blocks:
            h, _, _ = T.apply_block(p, h, btype, cfg, cos_sin, chunk=PIPE_SEQ)
        return h

    x = torch.randn((PIPE_MICRO, PIPE_MB, PIPE_SEQ, cfg.d_model), generator=g, device=dev)
    devices = [dev] * PIPE_STAGES

    def piped():
        return pipeline_forward(layer_fn, stages, x, n_stages=PIPE_STAGES,
                                n_micro=PIPE_MICRO, devices=devices)

    def sequential():
        return torch.stack([layer_fn(blocks, x[m]) for m in range(PIPE_MICRO)])

    with torch.no_grad():
        got, ref = piped(), sequential()
        torch.cuda.synchronize()
        err = rel_err(got, ref)
        out = {"shape": list(got.shape), "rel_err": err,
               "pipeline_ms": cuda_ms(piped, iters=PIPE_ITERS),
               "sequential_ms": cuda_ms(sequential, iters=PIPE_ITERS),
               "layers": PIPE_LAYERS, "stages": PIPE_STAGES, "micro": PIPE_MICRO,
               "micro_batch": [PIPE_MB, PIPE_SEQ], "d_model": cfg.d_model,
               "n_heads": cfg.n_heads}
    log(f"[dist] pipeline: {json.dumps(out)}")
    require(tuple(got.shape) == (PIPE_MICRO, PIPE_MB, PIPE_SEQ, cfg.d_model)
            and math.isfinite(err) and err <= PIPE_TOL,
            f"pipeline_forward against the sequential loop: {out}")
    return out


def dist_elastic(torch) -> dict:
    """(b) tests/test_torch_pipeline_elastic.py's elastic case on 8 entries
    of the card: the shard shapes it pins, bit-equal after ``full()``."""
    from repro_torch.distributed import elastic
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.distributed.sharding import P
    dev = torch.empty(0, device=DEVICE).device      # with its index
    mesh = make_mesh((4, 2), ("data", "model"), devices=[dev] * 8)
    x = torch.arange(64, dtype=torch.float32, device=dev).reshape(8, 8)
    specs = {"w": P("data", "model")}
    sharded = elastic.reshard_tree({"w": x}, specs, mesh)
    new_mesh = elastic.remesh(elastic.simulate_node_failure(mesh, n_lost_nodes=2),
                              model_axis_size=2)
    resharded = elastic.reshard_tree(sharded, specs, new_mesh)
    shapes = {k: sorted({tuple(t.shape) for t in v["w"].shards.flat})
              for k, v in (("initial", sharded), ("resharded", resharded))}
    on_card = all(t.device == dev for v in (sharded, resharded) for t in v["w"].shards.flat)
    out = {"new_mesh": new_mesh.shape, "shard_shapes": shapes,
           "spec_after": list(resharded["w"].spec), "on_card": on_card,
           "bit_equal": bool(torch.equal(resharded["w"].full(dev), x)
                             and torch.equal(sharded["w"].full(dev), x))}
    log(f"[dist] elastic: {json.dumps(out)}")
    require(out["bit_equal"] and on_card and new_mesh.shape == {"data": 3, "model": 2}
            and shapes == {"initial": [(2, 4)], "resharded": [(8, 4)]},
            f"elastic remesh and reshard: {out}")
    return out


def dist_checkpoint(torch) -> dict:
    """(c) The full-width bf16 train state cut to CKPT_LAYERS layers,
    saved, then restored sharded onto a (data 2, model 2) mesh of 4 card
    entries; every leaf bit-equal after ``full()``; the shards' bytes
    against ``_sharded_arg_bytes`` x 4 and the allocator's rise."""
    import gc
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as S
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.launch.dryrun import _sharded_arg_bytes
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import TrainState
    from repro_torch.utils.treeutil import tree_bytes, tree_leaves
    dev = torch.empty(0, device=DEVICE).device      # with its index
    cfg = get_config(DIST_ARCH).scaled(n_layers=CKPT_LAYERS)
    model = build_model(cfg, max_seq=PIPE_SEQ, chunk=PIPE_SEQ)
    g = torch.Generator(DEVICE).manual_seed(SEED)
    params = model.init_params(g, dev)
    opt = adamw_init(params)
    for m, v in zip(tree_leaves(opt["m"]), tree_leaves(opt["v"])):
        m.normal_(generator=g)
        v.uniform_(generator=g)
    state = TrainState(params, opt, torch.tensor(CKPT_STEP, dtype=torch.int32, device=dev))
    n_params = sum(p.numel() for p in params.parameters())
    state_bytes = tree_bytes([params, opt["m"], opt["v"]]) + 4
    full_params = sum(p.numel() for p in build_model(get_config(DIST_ARCH)).param_specs()
                      .parameters())
    full_bytes = full_params * (2 + 4 + 4) + 4
    DIST_CKPT_DIR.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(DIST_CKPT_DIR.parent).free
    log(f"[dist] checkpoint: {n_params:,} parameters, {state_bytes / 1e9:.3f} GB of state; "
        f"{free / 1e9:.1f} GB free under {DIST_CKPT_DIR.parent}")
    require(free > 1.2 * state_bytes, f"{free / 1e9:.1f} GB free for a "
            f"{state_bytes / 1e9:.3f} GB checkpoint")
    shutil.rmtree(DIST_CKPT_DIR, ignore_errors=True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(str(DIST_CKPT_DIR), CKPT_STEP, state)
        save_s = time.perf_counter() - t0
        disk = sum(f.stat().st_size for f in DIST_CKPT_DIR.rglob("*") if f.is_file())

        mesh = make_mesh(CKPT_MESH, ("data", "model"), devices=[dev] * math.prod(CKPT_MESH))
        meta = model.param_specs()
        target = TrainState(meta, adamw_init(meta),
                            torch.empty((), dtype=torch.int32, device="meta"))
        p_specs = S.enforce_divisibility(S.param_pspecs(meta), meta, mesh)
        o_specs = S.opt_state_pspecs(meta, p_specs, data_axis="data",
                                     mesh_axis_size=mesh.shape["data"])
        o_specs = S.enforce_divisibility(o_specs, target.opt, mesh)
        specs = TrainState(p_specs, o_specs, S.P(), None)
        shardings = TrainState(S.named_sharding_tree(mesh, p_specs),
                               S.named_sharding_tree(mesh, o_specs),
                               S.NamedSharding(mesh, S.P()), None)
        per_device = _sharded_arg_bytes((target,), (specs,), mesh)
        gc.collect()
        torch.cuda.synchronize()
        before = (torch.cuda.memory_allocated(), _requested_bytes(torch))
        t0 = time.perf_counter()
        restored = restore_checkpoint(str(DIST_CKPT_DIR), CKPT_STEP, target, shardings)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        rise = torch.cuda.memory_allocated() - before[0]
        requested = _requested_bytes(torch) - before[1]
    finally:
        shutil.rmtree(DIST_CKPT_DIR, ignore_errors=True)
    placed = [x for _, x in S.tree_items(restored)]
    shards = [t for x in placed for t in x.shards.flat]
    shard_bytes = sum(t.numel() * t.element_size() for t in shards)
    entries = math.prod(CKPT_MESH)
    src = [x for _, x in S.tree_items(state)]
    bit_equal = len(src) == len(placed) and all(t.device == dev for t in shards)
    for want, got in zip(src, placed):
        whole = want[:] if isinstance(want, S.Stacked) else want
        bit_equal = bit_equal and got.dtype == whole.dtype and torch.equal(got.full(dev), whole)
        del whole
    out = {"layers": CKPT_LAYERS, "parameters": n_params, "state_bytes": state_bytes,
           "disk_bytes": disk, "leaves": len(placed), "save_s": save_s,
           "save_GB_per_s": disk / save_s / 1e9, "restore_s": restore_s,
           "restore_GB_per_s": disk / restore_s / 1e9, "mesh": mesh.shape,
           "per_device_bytes": per_device, "shard_bytes": shard_bytes,
           "reckoned_x_entries": per_device * entries, "allocator_rise": rise,
           "allocator_requested_rise": requested, "bit_equal": bit_equal,
           "full_28_layer_state_bytes": full_bytes,
           "full_save_s_scaled": full_bytes / (disk / save_s),
           "full_restore_s_scaled": full_bytes / (disk / restore_s)}
    log(f"[dist] checkpoint save {save_s:.2f}s ({out['save_GB_per_s']:.3f} GB/s), sharded "
        f"restore {restore_s:.2f}s ({out['restore_GB_per_s']:.3f} GB/s) of {disk / 1e9:.3f} GB; "
        f"the 28-layer state ({full_bytes / 1e9:.2f} GB) at these rates: save "
        f"{out['full_save_s_scaled']:.1f}s, restore {out['full_restore_s_scaled']:.1f}s")
    log(f"[dist] checkpoint: {json.dumps(out)}")
    require(bit_equal, "sharded restore is not bit-equal to the saved state")
    require(shard_bytes == per_device * entries,
            f"shards hold {shard_bytes} bytes, _sharded_arg_bytes x {entries} = "
            f"{per_device * entries}")
    # memory_allocated counts the allocator's blocks (each request rounded
    # up to 512 bytes, a block not worth splitting counted whole); its
    # requested bytes count the requests themselves.
    require(requested == shard_bytes,
            f"the allocator's requested bytes rose {requested}, the shards hold {shard_bytes}")
    del restored, placed, shards, src, state, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _requested_bytes(torch) -> int:
    """The bytes the caching allocator's live blocks were requested for."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def dist_dryrun() -> dict:
    """(d) The restated dry run over every cell and both production meshes."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    try:
        o, _, t = oms_cli(["--all", "--both-meshes", "--out", DRYRUN_DIR.relative_to(HERE)],
                          "dryrun --all --both-meshes", module="dryrun")
        recs = [json.loads(f.read_text()) for f in sorted(DRYRUN_DIR.glob("*.json"))]
    finally:
        shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    status = {k: sum(r["status"] == k for r in recs) for k in ("ok", "skipped", "error")}
    nulls = [(r["arch"], r["shape"], r["mesh"]) for r in recs if r["status"] == "ok" and (
        None in r["per_chip"].values() or None in r["roofline"].values()
        or r["collectives"] is None)]
    require(not nulls, f"dryrun: records with a null work or collective field: {nulls}")
    llama = {r["mesh"]: r for r in recs if r["arch"] == DIST_ARCH and r["shape"] == "train_4k"}
    out = {"process_s": t, "records": len(recs), **status,
           "fits": sum(bool(r.get("fits")) for r in recs),
           "llama_train_4k_bytes_per_device": {m: r["arg_bytes_per_device"]
                                               for m, r in llama.items()},
           "device_memory": {r["device_memory_source"]: r["device_memory_bytes"]
                             for r in recs if r["status"] == "ok"}}
    log(f"[dist] dryrun: {len(recs)} records ({status['ok']} ok, {status['skipped']} skipped) "
        f"in {t:.1f}s; {DIST_ARCH} train_4k per-device bytes: "
        + ", ".join(f"{m} {b / 2**30:.3f} GiB ({b:.0f})"
                    for m, b in out["llama_train_4k_bytes_per_device"].items()))
    require(len(recs) == 80 and status == {"ok": 64, "skipped": 16, "error": 0}
            and set(llama) == {"16x16", "2x16x16"} and o.strip().endswith("0 failures"),
            f"dryrun: {out}")
    return out


def phase_dist(torch, env) -> dict:
    """Phase 21: the pipeline (float32, TF32 off), elastic reshard, the
    sharded checkpoint restore and the dry run. Returns the ``dist`` JSON
    line's object."""
    import gc
    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        pipe = dist_pipeline(torch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    gc.collect()
    torch.cuda.empty_cache()
    out = {"card": env["smi"], "pipeline": pipe, "elastic": dist_elastic(torch),
           "checkpoint": dist_checkpoint(torch), "dryrun": dist_dryrun()}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[dist] phase 21 in {out['phase_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# Phase 22: the examples
# ---------------------------------------------------------------------------


def _example(name: str, args=(), *, popen: bool = False):
    """``python examples/<name>.py *args`` from the repository root: the
    finished process's (stdout, seconds) once it exits 0, or with
    ``popen`` the running process, kept to EXAMPLE_CPU_THREADS torch
    threads so that it leaves cores to the card's processes beside it."""
    import os
    cmd = [sys.executable, str(HERE / "examples" / f"{name}.py"), *map(str, args)]
    env = {**os.environ, "PYTHONPATH": str(HERE / "src")}
    if popen:
        env["OMP_NUM_THREADS"] = str(EXAMPLE_CPU_THREADS)
        return subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True, text=True,
                             timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        fail(f"example {name} ran past {CLI_TIMEOUT_S} s")
    dt = time.perf_counter() - t0
    require(res.returncode == 0, f"example `{name} {' '.join(map(str, args))}` exited "
            f"{res.returncode}: {res.stderr[-3000:]}")
    log(f"[examples] {' '.join([name, *map(str, args)])}: exited 0 in {dt:.1f}s")
    return res.stdout, dt


def phase_examples(env) -> dict:
    """Phase 22: the four examples as subprocesses on the card; the
    quickstart again with ``--device cpu`` (run beside the others), its
    lines equal to the card's. Returns the ``examples`` JSON line's
    object."""
    import re
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    cpu = _example("quickstart_torch", ["--device", "cpu"], popen=True)
    try:
        out = {}
        qs, out["quickstart_s"] = _example("quickstart_torch")
        e2e, out["oms_search_e2e_s"] = _example("oms_search_e2e_torch")
        serve, out["serve_lm_s"] = _example("serve_lm_torch")
        shutil.rmtree(EXAMPLE_CKPT_DIR, ignore_errors=True)
        try:
            train, out["train_lm_s"] = _example(
                "train_lm_torch", ["--steps", EXAMPLE_TRAIN_STEPS, "--ckpt-dir",
                                   EXAMPLE_CKPT_DIR.relative_to(HERE)])
        finally:
            shutil.rmtree(EXAMPLE_CKPT_DIR, ignore_errors=True)
        try:
            cpu_out, cpu_err = cpu.communicate(timeout=CLI_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"example quickstart_torch --device cpu ran past {CLI_TIMEOUT_S} s")
    finally:
        if cpu.poll() is None:
            cpu.kill()
            cpu.wait()
    out["quickstart_cpu_s"] = time.perf_counter() - t0
    require(cpu.returncode == 0, f"example `quickstart_torch --device cpu` exited "
            f"{cpu.returncode}: {cpu_err[-3000:]}")
    log("[examples] quickstart_torch on the card:\n" + qs.rstrip())
    require(len(qs.splitlines()) == 6 and qs == cpu_out,
            f"quickstart_torch: the card's lines differ from the CPU's:\n{qs}\n---\n{cpu_out}")
    log(f"[examples] quickstart_torch --device cpu printed the same 6 lines "
        f"(process, beside the others, {out['quickstart_cpu_s']:.1f}s)")
    lines = e2e.splitlines()
    log("[examples] oms_search_e2e_torch on the card:\n" + e2e.rstrip())
    ids = {m.group(1) for x in lines if x.startswith(("[serve]", "[backend"))
           for m in [re.search(r"ids=(\d+)$", x)] if m}
    require(sum(x.startswith("[backend") for x in lines) == 7 and len(ids) == 1
            and sum(x.startswith("[serve]") for x in lines) == 3
            and lines[-1].startswith("[top-k] "),
            f"oms_search_e2e_torch: backends or batches disagree:\n{e2e}")
    require(serve.startswith("[serve] generated 64 tokens"), f"serve_lm_torch:\n{serve}")
    require(f"[train] done at step {EXAMPLE_TRAIN_STEPS};" in train, f"train_lm_torch:\n{train}")
    log(f"[examples] serve_lm_torch: {serve.strip()}")
    log(f"[examples] train_lm_torch: {train.strip().splitlines()[-1]}")
    out.update(card=env["smi"], quickstart_lines=qs.splitlines(), e2e_lines=lines,
               e2e_identifications=int(ids.pop()), phase_s=time.perf_counter() - t_phase)
    log(f"[examples] phase 22 in {out['phase_s']:.1f}s")
    return out


def main() -> int:
    if not (HERE / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a "
             "checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from repro_torch.core.pipeline import OMSConfig, _make_codebooks
    from repro_torch.data.spectra import iprg2012_config, make_dataset

    t_all = time.perf_counter()
    env = phase_environment(torch)
    phase_build()

    cfg = OMSConfig(backend="fused", encode_backend="pallas",
                    encode_batch=ENCODE_BATCH, seed=SEED)
    phase_hdencode_check(torch, _make_codebooks(cfg, torch.device(DEVICE)))
    phase_tile_edges(torch)

    t0 = time.perf_counter()
    lib_cfg = iprg2012_config(scale=1.0, seed=SEED)
    ds = make_dataset(lib_cfg)
    log(f"[data] iPRG2012 scale: {lib_cfg.n_refs} library spectra, "
        f"{lib_cfg.n_queries} queries, {lib_cfg.max_peaks} peaks "
        f"(numpy, seed {SEED}) in {time.perf_counter() - t0:.1f}s")
    pipe, hvs, q_pmz, q_charge, launches, out = phase_main_path(torch, ds, cfg)
    phase_fused_check(torch, pipe, hvs, q_pmz, q_charge)
    phase_fused_groups(torch, pipe, hvs, q_pmz, q_charge)
    phase_fused_edges(torch)
    phase_paths(torch, pipe, ds)
    kernels = phase_times(torch, env, pipe, hvs, q_pmz, q_charge, launches, ds)
    bucket = phase_tile_check(torch, env, pipe, hvs, q_pmz, q_charge)
    phase_fused_mxu_batch(torch, pipe, hvs, q_pmz, q_charge)
    launches.update(phase_backends(torch, pipe, hvs, q_pmz, q_charge, out))
    phase_cascade(torch, pipe, hvs, q_pmz, q_charge, out)
    phase_cascade_margin(torch, pipe, hvs, q_pmz, q_charge)
    kernels += phase_times_mxu(torch, env, pipe, hvs, q_pmz, q_charge, launches,
                               kernels[1], bucket)
    topk_ms = phase_topk(torch, pipe, hvs, q_pmz, q_charge)
    own_path = {"hdencode": "main path", "fused_search": "main path",
                "hamming_matrix": "backend kernel_vpu",
                "hamming_mxu": "backend kernel_mxu",
                "fused_search_mxu": "backend fused_mxu"}
    by_path = {k["name"]: {own_path[k["name"]]: k["launches"]} for k in kernels}
    try:
        store, store_launches = phase_store(torch, ds, cfg, pipe, hvs, q_pmz,
                                            q_charge, out)
        by_path["hdencode"]["store ingest"] = store_launches["hdencode"]
        by_path["fused_search"]["store-loaded search"] = store_launches["fused_search"]
        spipe, stream_launches = phase_streamed(torch, store, cfg, pipe, hvs, q_pmz,
                                                q_charge, out)
        for kernel, path, n in stream_launches:
            by_path[kernel][path] = n
        by_path["hamming_matrix"][f"streamed cascade prefix_words={STREAM_CASCADE_PREFIX}"] = (
            phase_streamed_cascade(torch, pipe, spipe, hvs, q_pmz, q_charge,
                                   out)["hamming_matrix"])
        by_path["fused_search"].update(
            phase_narrow_cascade(torch, pipe, spipe, hvs, q_pmz, q_charge, out))
        for kernel, paths in phase_multi_device(torch, pipe, spipe, cfg, hvs, q_pmz,
                                                q_charge).items():
            by_path[kernel].update(paths)
        del spipe
        for kernel, paths in phase_launcher(
                torch, lib_cfg, cfg, pipe, hvs, q_pmz, q_charge, out, ds,
                before_reload=lambda *a: phase_tune(torch, pipe, ds, hvs, q_pmz,
                                                    q_charge, *a)).items():
            by_path[kernel].update(paths)
        phase_analyze()
    finally:
        shutil.rmtree(STORE_DIR, ignore_errors=True)
        shutil.rmtree(CLI_STORE_DIR, ignore_errors=True)
        for f in (REQUESTS_FILE, SERVE_TRACE, STREAM_TRACE, RELOAD_TRACE, TUNE_CACHE,
                  ANALYZE_REPORT,
                  *(REQUESTS_FILE.with_name(f"smoke_requests_{x}.jsonl")
                    for x in ("head", "twice", "new", "in_process"))):
            f.unlink(missing_ok=True)
    lm = phase_lm(torch, env)
    train = phase_train(torch, env)
    dist = phase_dist(torch, env)
    examples = phase_examples(env)
    for k in kernels:
        k["launches_by_path"] = by_path[k["name"]]
        if k["name"] in ("fused_search", "fused_search_mxu"):
            k["topk_ms"] = {kk: v for kk, v in topk_ms.items() if kk.startswith(k["name"] + " ")}
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f}s; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps({"lm": lm}))
    print(json.dumps({"train": train}))
    print(json.dumps({"dist": dist}))
    print(json.dumps({"examples": examples}))
    print(json.dumps({"kernels": kernels}))
    print(env["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
