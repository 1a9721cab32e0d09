#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit (`nvcc`). It builds every kernel of the port's main paths
from the sources in the checkout (one nvcc per source, all at once),
then:

1. device — prints the card's name and power limit as
   `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
   them, and the `ssd_step` build;
2. kernel vs plain version — the `ssd_step` kernel on the card against
   its plain PyTorch version on the CPU, on the same inputs: the paper's
   4 policies x 2 modes on `hm_0` and `proj_0` (4096 ops plus an
   8192-op pad tail, at the paper's full width: 128 planes, 2^16 logical
   pages), in the per-op form (K = 1) and the compressed form (K = 32).
   Every carry leaf and every latency must be equal (tolerance 0: the
   port is bit-exact). The plain versions run on the CPU in worker
   processes started before the build (`PlainRuns`). Then one mixed launch of `run_streams`: every
   composition x both modes x K = 1 and K = 32, each cell its own
   length, held cell by cell to the plain version, bit for bit; and the
   latency of one dependent shared-memory load, from a one-thread
   pointer chase (`ssd_step.smem_chase`), with the card's highest SM
   clock (`nvidia-smi --query-gpu=clocks.max.sm`); and where an op's
   cycles go: clock64 cycles per op and the share spent waiting on the
   op ring. Then the kernel's wear form (cells that track endurance):
   per-op streams of `ips_raro`, `base_wl` and `ips` with wear, both
   modes, 2048 ops of hm_0 and proj_0 at small caches so that the gate,
   the fallback, the end of life and the read penalty fire, every
   `WearState` and `SimState` leaf and every latency held to the plain
   version, bit for bit, each job alone and the six in one launch;
3. the sweep paths — through `repro_torch.sweep.runner.run_sweep` on the
   card, untruncated, each grid with the kernel's launch count zeroed
   just before and read just after (each grid is ONE launch): the
   102-cell `paper` grid against the committed `BENCH_sweep_paper.json`
   of the reference package, its traces built with the port's on-disk
   trace cache cold (emptied first) and again warm (a fresh cache object
   over the same directory, under `build/`); the 24-cell `endurance`
   grid (every cell tracks wear, in the kernel's wear form) against the
   committed `BENCH_sweep_endurance.json`; the `stress`, `mixed` and
   `sensitivity` grids against the reference's uncut runs recorded in
   `tests/data/torch_reference_sweeps.json`. Counters, `wa_paper`,
   `wa_raw` and the lifetime columns exact; mean write latency and the
   two bucket means (`eff_cycles_mean`, `cycle_skew`) within rtol 1e-6
   (the reference sums float32 values in its own order). Each group's
   device ms comes from the kernel's per-block %globaltimer stamps, with
   its longest cell's ns and clock64 cycles per op; the launch's own time
   from CUDA events; each grid's bytes bound beside its chain bound (the
   longest cell's stepped ops x one dependent shared-memory load);
   Then the telemetry phase: the paper grid again through `run_sweep`
   with the probe on at 1024 ops a window (the kernel's probe form),
   ONE launch: every cell's summary equal to the probe-off run, its
   counter windows summing to its counters, its windows equal to the
   reference's recorded run (`tests/data/torch_reference_timelines.json`:
   the sha256 of `ops`, `writes`, `lat_hist`, `ctr`, `t_last`, the three
   float sums' totals and hm_0's series, the cliff dicts), the cliff
   count printed, the launch ms with the probe off and on; then
   `telemetry.profiling.profile` (torch.profiler) around the `quick`
   grid, which must start and record the kernel's device events; then
   the CLI end to end, `python -m repro_torch.sweep.cli --grid paper
   --timeline --timeline-overhead-check` into `build/cli_timeline`
   (`BENCH_torch_timeline.json`, a `BENCH_torch_history.json` record and
   the overhead ratio: interleaved off/on passes, median of 3). Then the
   host-tier phase: the `host_tier` kernel against its plain version, bit
   for bit (the `hostcache` grid's four host-cache specs x both modes on
   flush_burst cut to 4096 ops, and a 1024 x 8 cell whose state works in
   device memory, one launch), its time beside the plain version's and
   its bytes, operations and chain bounds; the 40-cell `hostcache` grid
   uncut through `run_sweep` as ONE `host_tier` launch and ONE `ssd_step`
   launch (both counts zeroed just before and read just after), every
   cell against the committed `BENCH_sweep_hostcache.json` (which live
   JAX 0.9.0 reproduces: every leaf exact but seven mean latencies, within
   1e-7), the host-tier columns and `host_dev_lat_ms` exact, and the
   report's host-tier table; where a trace op's cycles go at the grid's
   size (its four specs x both modes uncut, 131,072 ops a cell: the
   kernel's probe form, clock64 cycles of waiting on inputs, set scan,
   promotion filter, flush scan and stores) beside the launch's time and
   its chain bound; the CLI's `--traces hm_0 --hostcache
   mode=wb,flush=idle` into `build/cli_hostcache` against the reference
   CLI's recorded run (`tests/data/torch_reference_sweeps.json`); the
   search engine at the `quick` budget (`--search quick`) against the
   reference's recorded run (`tests/data/torch_reference_search.json`:
   survivors, front, rounds, scenario history; scores within rtol 1e-6),
   no new kernel specialisation after its first round. Then the
   evaluation matrix as a user calls it (phase 3d): `driver.eval_matrix`
   (66 cells: 11 traces x 2 modes x baseline, ips, ips_agc; ONE launch)
   cell for cell against the matching cells of `BENCH_sweep_paper.json`;
   `runner.bench_fleet_vs_loop` on the same 66 cells (the fleet's one
   launch, then a loop of `driver.eval_cell`, one launch a cell: 67
   launches), both walls and the speedup printed, its fleet held to the
   same cells and its loop to its fleet (`max_rel_diff` at most 1e-6);
   `scripts/bench_step_torch.py --traces hm_0,proj_0 --max-ops 32768`
   into `build/bench_step`, its document checked by the port's
   `check_step_throughput` with no speedup gate, its geomean printed.
   Phase 2
   also holds the probe form to its plain version, bit for bit: every
   per-op and K = 32 case with the probe on at 1024 ops a window (8 of
   12 boundaries among the replayed tail pads) and the wear jobs at 256
   (wear peaks), each also probe-off against the same plain run (the
   plain version runs with the probe on: it observes only); each case's
   timed launches follow an untimed one, which brings the card's clocks
   back up after the plain version's seconds on the CPU;
4. build — the serving path's three kernels (`ips_repack`,
   `tiered_decode`, `flash_fwd`): build seconds, ptxas registers and
   spills;
5. kernel vs plain version at the serving shapes, both on the card, same
   inputs: the repack (`ips_repack`) bit for bit — every bf16 bit pattern
   as x against 512 absmax values (subnormal and all-zero groups among
   them), groups 2, 6, 48, 64, 128 and 256, the in-place tier form (K and
   V in one launch, from the strided hot-tier slice into bf16-scaled
   dense tiers) at gemma-2b's and zamba2-1.2b's serving shapes, the arena
   form (one thread-block cluster a page) at 1, 5 and 128 pages of the
   TPU kernel's default 256 x 1024, its stale tail kept; its times (the
   tier form at gemma-2b's prefill fill, 73,728 x 256 bf16, per launch,
   cold and by CUDA graph; each in-place event; the arena at 128 pages,
   cold) beside their bytes bounds, and one repack event of each model
   split into the kernel's share and the hot window's roll; the tiered
   partials at gemma-2b's decode shape (B 4, Hkv 1,
   G 8, hd 256) and zamba2-1.2b's (B 4, Hkv 32, G 1, hd 64) over the
   serving dense tier, with dense_len 0, 1, one split's tokens less and
   more one, 1000 and full, in both dequantized forms, within 2e-4;
   flash in bf16 (the wgmma form, P as three bf16 terms, within 1e-2) at
   gemma-2b's prefill shape (B 4, S 2048, H 8, Hkv 1, hd 256), zamba2's
   (H 32, Hkv 32, hd 64), S 1000 and 333 (off the 128-row tile) and 17
   (below it), and
   in float32 (2e-5); the count of HGMMA instructions in the built flash
   library (`cuobjdump -sass`), which must not be 0. Each kernel's time
   at both path shapes (CUDA events around each launch; for the tiered
   kernel also a CUDA graph of the launches, its device time alone), its
   plain version's, its bound, and for flash PyTorch's
   `scaled_dot_product_attention` on the same inputs as a yardstick the
   port never calls. The latent form of the tiered decode
   (`latent_decode`, MLA's absorbed decode over the int4 latent) at
   deepseek-v2-lite's decode shape (H 16, r 512, p 64, group 64) over the
   serving tier, B 1 and 4, dense_len 0, 1, 15, 17, 255, 1536 and 2048,
   and H 1, 5 and 16, r 32 to 512, p 16, 32 and 64, groups 2 to 64, q
   bf16-exact and float32, within 2e-5 of max |output|; the count of
   HMMA instructions in the built library, which must not be 0; its time
   at B 4 and dense_len 2048 (events and graph) beside its tensor-core
   bound, under the wrapper's split plan; flash at MLA's
   prefill widths (B 4, S 2048, H = Hkv = 16, q and k 192, v 128,
   zero-padded to the 256 form) within 1e-2, its time with and without
   the padding beside SDPA's on the unpadded inputs. arctic-480b's shapes
   too: the tiered partials at B 4, Hkv 8, G 7, hd 128 (2e-4), flash at
   B 4, S 2048, H 56, Hkv 8, hd 128 (bf16, 1e-2), and the in-place repack
   at its K and V (1 slot x B 4 x Hkv 8 x hd 128) and at deepseek's
   latent (27 slots x B 4, one headless channel of 512, group 64), bit
   for bit;
6. the serving path — gemma-2b at full width, its depth cut to 9 of 18
   layers (SERVE_ARCHS; random weights
   from a seed), a batch of 4 prompts of 2048 tokens prefilled and 128
   tokens decoded greedily under each of the four cache policies, with
   the engine's tier defaults (hot window 1024, page 256, group 64).
   Each policy runs with the kernels (the counts zeroed just before and
   read just after; each launch timed by CUDA events, the path by the
   host clock), then
   teacher-forced on the same tokens with each kernel's wrapper replaced
   by its plain version: logits within 2e-2 of their range at the
   prefill and every step, or within twice the plain versions' own
   difference under another summation order (run beside them); beside
   it an rms check: rms(kernel run - plain run) over rms(floor - plain
   run) at every decode step, at most RMS_LIMIT; `dense_len`,
   `total_len` and the five traffic metrics exact, and equal to a
   closed-form count of the policy's plan; launch counts equal to what
   the path implies (flash 1 per layer a prefill, tiered 1 per layer a
   step, repack 1 per fill or repack event, K and V together). The run
   follows one event-timed prefill that is not counted (it pays the
   first use of the events around a prefill's launches), and each
   kernel's slowest launch of the counted run is printed beside its
   main-path ms, which counts every launch. Under IPS, faults planted
   in the tiered kernel's call show how far the logits checks see a
   wrong kernel: dropping 32 or 256 dense tokens must fail the rms check
   at every step;
7. the Mamba2 kernel — `ssd_intra` against its plain version on the card
   at mamba2-370m's prefill shape (Bt 4, nc 8, Q 256, nh 32, hd 64,
   N 128), zamba2-1.2b's (nh 64, N 64) and the overflow stress case
   (A = -1 at Q 256), within 2e-5 of max |output|, every output finite;
   the count of HMMA instructions in the built library, which must not
   be 0 (the products run on the tensor cores in 3xTF32); its time, its
   plain version's, its 3xTF32 bound and its float32 CUDA-core bound;
8. the Mamba2 serving paths, as phase 6 — mamba2-370m at full width,
   24 of its 48 layers (no KV cache, so one policy, IPS_AGC, the
   launcher's default: the policy changes nothing) and zamba2-1.2b at 12
   of its 38 layers (2 of its 6 macro blocks of 6 Mamba2 layers and the
   shared attention block) under the four policies, same batch, prompts
   and steps. `ssd_intra` launches once per Mamba2 layer a prefill (24;
   12), zamba2's shared block flash 2 a prefill and tiered 2 a step. The floor run's
   other summation order is the SSD scan in chunks of 128 (and zamba2's
   attention softmax in chunks of 256). The counters equal the closed
   form with each step's state bytes added after the tick, as the
   engine adds them. The path check holds every `ssd_intra` call of one
   prefill to its plain version on the path's own inputs (2e-5 of max
   |output|). For mamba2 a fault planted in the `ssd_intra` call (a
   strict causal mask: L's diagonal dropped) must be caught by the path
   check or the logits check; the script records both. Each path starts
   with one warm-up prefill, so no timed prefill pays the process's
   set-up;
9. the MoE paths, as phase 6 — deepseek-v2-lite-16b at full width, its
   depth cut from 27 to DEEPSEEK_LAYERS (the first dense; MLA over the
   int4 latent tier; 64 routed experts top-6 and 2 shared) under the
   four policies, then one
   arctic-480b layer at its published widths (128 experts top-2 and the
   dense residual; GQA 56 over 8 heads) under IPS, its weights drawn
   after deepseek's are freed. The plain, floor and fault runs replay
   the kernel run's MoE routes (`Routes`: routing is discontinuous) and
   count the (layer, token) top-k sets their own routing would have
   chosen otherwise. deepseek launches flash once a layer a prefill
   (MLA's widths, padded) and `latent_decode` once a layer a step, the
   repack once a fill or event (the latent alone; the RoPE key is a raw
   channel); arctic
   flash 1 a prefill and `tiered_decode` 1 a step. The flips are counted
   per MoE layer, with the router's gap between the k-th and (k+1)-th
   expert's probability at the flipped sets and over all sets, and the
   floor run's own routes are also held to the plain run's own: two
   honest runs that differ only in summation order. Under IPS the latent
   kernel dropping 32 dense tokens must fail the rms check at every step.
   arctic's one layer has a floor of exactly 0 at every decode step (its
   cache is projected before the prefill attention, whose softmax chunks
   are the floor's only difference): the script fails if it is not, and
   holds that path to the max-based check alone, which must catch its
   tiered call dropping 32 dense tokens at every step;
10. the encoder-decoder, as phase 6 — whisper-tiny at full size (4
   encoder and 4 decoder layers, 1500 frames drawn with the prompts)
   under the four policies: flash 4 a prefill (the decoder's causal
   self-attention; the encoder's non-causal one is plain PyTorch, as in
   the reference), `tiered_decode` 8 a step (each layer's self tier, then
   its static int4 cross tier as the dense partial over all 1500
   frames), the repack once a fill or event and once for the cross tier.
   Phase 5 holds the cross partial at (B 4, Hkv 6, G 1, hd 64,
   dense_len = S = 1500, 1499 and 77) to its plain version and times it,
   and flash at whisper's prefill (H 6, Hkv 6, hd 64). Under IPS the
   cross tier's call dropping its last 256 frames must fail the rms
   check at every step;
11. the VLM, as phase 6 — llava-next-34b (60 layers, d_model 7168, GQA
   56 over 8 heads) at full width, depth LLAVA_LAYERS, under IPS: 576
   patch embeddings and 2048 tokens prefilled (2624 positions through
   flash, which phase 5 holds to its plain version at that shape), 128
   steps through `tiered_decode` at G 7; the peak memory printed. Its
   tiered call dropping 32 dense tokens must fail the rms check at every
   step;
12. training — (a) gemma-2b at full size (18 layers, 2.506 B
   parameters), AdamW, remat, one batch of 2 x 2048 tokens from the
   port's data pipeline: the loss and every gradient from one state
   three times, with `flash_fwd` under its autograd Function (18
   launches forward, 18 more in remat's recompute), with the plain
   versions on the card, and with the plain versions under another
   summation order (attention chunks of 256, not 512): rms(kernel -
   plain) / rms(floor - plain) at most RMS_LIMIT over the whole gradient,
   over each layer's stacked leaves and over each leaf, the loss within
   LOGITS_TOL of the plain run's; a forward in which each query drops
   the 32 keys before its own and an lse raised by log 1.01 (out kept,
   so only the backward sees it) must fail that check; a forward that
   drops the sequence's last 32 keys is read only (it moves 32 of 2048
   query rows, under the floor); then one train step. (b) `launch.train.main` at gemma's
   full size, 10 steps of 2 x 2048 tokens: the loss finite and falling,
   ms a step (median of steps 3-10), tokens/s, model FLOPs and their
   share of the bf16 peak, peak GiB, `flash_fwd`'s launches and event ms
   a step, the plain flash backward's event ms a step. (c) mamba2-370m
   at full size (48 layers) as (a) with `ssd_intra` under its Function
   and a floor of SSD chunks of 128, its strict-mask fault caught; then
   3 launcher steps and `ssd_intra`'s launches a step. (d) gemma-2b
   reduced on the card: three steps against two, `save_async`,
   `restore` into a fresh state and the third step, whose loss must be
   equal to the bit. `scripts/train_phase.py` runs this phase alone;
13. distribution — ranks spawned as processes that share the card over
   gloo (`distributed.group.spawn`), each with its tensors on the card,
   the sweep kernels built before any rank starts: (a) the paper grid
   over 4 ranks (102 cells padded to 104, each rank's 26 in one
   `ssd_step` launch) cell for cell against `BENCH_sweep_paper.json`,
   and the `quick` search over 2 ranks against
   `tests/data/torch_reference_search.json`, the walls beside phase 3's;
   (b) `compressed_psum` over 4 ranks on one gemma-2b layer's gradient
   leaves at full width (bf16, with a carried float32 residual) against
   the same function in one process over the stacked ranks — the int32
   payload sum and the mean scale equal, the output and the residual
   within 1e-6 of their max — and on a 1-rank NCCL group; (c) gemma-2b's
   train state (parameters and AdamW moments, full width,
   DIST_CKPT_LAYERS deep, the embedding cut) saved by 2 ranks under
   (data 2, model 1),
   restored by one process and by 4 ranks under (data 2, model 2), every
   piece equal to the bit to its slice of the global state; (d) each of
   those ranks' device memory growth equal to the plan's per-device
   bytes (`launch.dryrun.argument_bytes`) within 512 bytes a tensor.
   Planted faults that must fail their checks: the 2-rank search again
   with its ranks' gathers handing back their two parts swapped (the
   scenario search's members then come back out of order), a
   `compressed_psum` that
   rescales with its own scale, a restore that swaps ranks 1 and 2's
   slices. `scripts/dist_phase.py` runs this phase alone.
14. the examples and dev scripts — each `examples/<name>_torch.py`'s and
   `scripts/smoke_models_torch.py`'s `main` called in this process as a
   user runs it (on the card by default; the kernels built once), every
   kernel's count zeroed just before each and read just after, each
   failing if a kernel of its path did not launch: `ssd_repro_torch.py`
   (the 88 cells of `driver.eval_matrix` in ONE `ssd_step` launch, each
   equal to `BENCH_sweep_paper.json`'s), `quickstart_torch.py`,
   `serve_ips_torch.py` (yi-6b reduced under the four policies),
   `host_cache_torch.py`, `sweep_fleet_torch.py` (into `build/examples/`,
   its artifact `BENCH_torch_example_sweep.json`) and
   `workload_zoo_torch.py --simulate` (its six simulated cells), their
   printed tables equal to the reference examples' recorded output
   (`tests/data/torch_reference_examples.json`, written by
   `scripts/record_torch_reference_examples.py`; `example_table` picks
   the lines: the simulator's tables, the serving counters, quickstart's
   SSD and KV lines, whose train line must be finite); `train_lm_torch.py`
   at the reference docstring's ~100M size (d_model 768, 12 layers, a
   32,000 vocab, 32 x 512 tokens a step) for TRAIN_LM_STEPS steps with a
   checkpoint halfway and at the end, then a second call that resumes at
   the saved step: the loss falling, ms a step, tokens/s, peak GiB,
   `flash_fwd`'s launches; `smoke_models_torch.py` over every arch,
   reduced (`flash_fwd` for every family with attention, `tiered_decode`
   for the `gqa` and `encdec_self` kinds, the latent form at the reduced
   deepseek's rank 32, `ssd_intra` for mamba2 and zamba2, each counted);
   then yi-6b and minitron-4b at full width (DENSE_ARCHS: 8 of their 32
   layers) served under IPS as phase 6 serves gemma-2b: the kernel run
   against the plain run against the floor, the planted tiered faults
   caught at every step, peak GiB printed. `scripts/examples_phase.py`
   runs this phase alone.

Each phase prints JSON lines, each with the card's name and power
limit, and any mismatch fails the run. The line
before the last is the kernel table (`{"kernels": [...]}`); the last is
`{"ok": true, "device": {...}}`. Without a CUDA device, or outside a
checkout, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM bf16 dense tensor cores
TF32_OPS_PER_S = 495e12         # H100 SXM TF32 dense tensor cores
# float32 operations one op of the per-op core does on the heaviest
# composition (coop, daily), counted in csrc/ssd_step.cu and rounded up;
# the pad ops replayed in the kernel are not counted
CORE_F32_OPS = 32
# ... and what the wear form adds to an op (the gate's sum, the read
# penalty's two sums, products and divisions, the placement's 8 FMAs and
# compares, the end-of-life check's 8 FMAs and max), rounded up
WEAR_F32_OPS = 136
WEAR_OPS = 2048                 # ops per phase-2 wear stream
SMOKE_OPS = 4096                # live ops per phase-2 trace
SMOKE_PAD = 8192                # identical tail pads per phase-2 trace
# the probe's windows in phase 2: 12 windows over 4096 ops + 8192 pads, 8
# of their boundaries among the replayed tail pads; 8 over a wear stream
PROBE_WINDOW = 1024
WEAR_PROBE_WINDOW = 256
TIMELINE_WINDOW = 1024          # the telemetry phase's (the CLI default)
EXACT = ("wa_paper", "wa_raw", "slc_writes", "tlc_writes", "reprogram_host",
         "reprogram_agc", "reprogram_trad", "migrations", "erases",
         "host_pages", "conflict_ms", "n_ops")
# the lifetime columns: exact, but the two means over buckets, which the
# port sums in float64 (rtol 1e-6, like the mean latency)
WEAR_EXACT = ("eff_cycles_max", "tbw_proj_gb", "eol_op", "pe_slc_total",
              "pe_rp_total", "pe_tlc_total", "pe_trad_total",
              "erase_events")
WEAR_CLOSE = ("eff_cycles_mean", "cycle_skew", "mean_write_latency_ms")
# the host-tier columns of a host cell: exact
HOST_EXACT = ("host_hit_rate", "host_absorbed", "host_absorbed_w",
              "host_dev_ops", "host_flush_w", "host_evict_w",
              "host_dev_write_frac", "host_dev_lat_ms")
HOST_TIER_OPS = 4096            # trace ops a host_tier cell held to the
#                                 plain version (the plain version steps
#                                 some 0.3 ms an op on the CPU)
# integer operations of one trace op of host_tier.cu beyond its set scans
# (lookup and victim: 2 a way; each flush slot: 3 a way), rounded up
TIER_BASE_OPS = 40


CARD = None     # `nvidia-smi --query-gpu=name,power.limit`, once known


def example_table(name: str, text: str) -> list:
    """The lines of an example's printed output that the port must print
    as the reference does (`examples/<name>.py` against
    `examples/<name>_torch.py`): the simulator's tables and the serving
    counters, without the sweep runner's progress lines, the path an
    artifact was written to or what depends on the weights (quickstart's
    train line)."""
    lines = text.splitlines()
    if name == "sweep_fleet":
        start = next(i for i, ln in enumerate(lines) if ln.startswith("cell"))
        return [ln for ln in lines[start:] if not ln.startswith("wrote")]
    if name == "workload_zoo":
        if "== one fleet sweep, three workload kinds ==" not in lines:
            return lines
        cut = lines.index("== one fleet sweep, three workload kinds ==")
        # a simulated cell's key holds the fixture's path as the example
        # built it from its own file: kept from tests/data/ on
        cells = [ln.split() for ln in lines[cut + 1:]
                 if " lat=" in ln and "ms wa=" in ln]
        return lines[:cut + 1] + [" ".join(
            [key[key.find("tests/data/"):] if "tests/data/" in key else key]
            + rest) for key, *rest in cells]
    if name == "quickstart":
        return [ln for ln in lines if ln.startswith(("[ssd]", "[kv]"))]
    if name == "train_lm":
        return [ln for ln in lines if ln.startswith("arch=")]
    return lines


def emit(obj, card: bool = True) -> None:
    """One JSON line; every measurement line carries the card's name and
    power limit (not the kernel table's and the contract's last line,
    whose keys are fixed)."""
    if card and CARD is not None:
        obj = {**obj, "card": CARD}
    print(json.dumps(obj, sort_keys=True), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def stream_bytes(c_cnt: int, n_ops: int, plan: bool, n_planes: int,
                 n_logical: int) -> int:
    """Bytes the kernel must move for C cells of `n_ops` scanned ops:
    each input read once, each output written once."""
    per_op = 4 + 4 + 4 + (8 if plan else 0) + 4    # ops (+ plan) + latency
    carry = 7 * 4 * n_planes + 3 * n_logical + 4 * 12
    params = 6 * 4
    return c_cnt * (n_ops * per_op + 2 * carry + params)


def bound_ms(bytes_moved: int, ops: int, ops_per_s: float = F32_OPS_PER_S):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type.
    Returns (ms, "bytes" or "operations")."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def leaves_equal(label, got, want) -> float:
    """Exact equality of (latency, SimState) pairs; returns the largest
    absolute difference over the float leaves (0.0 when equal)."""
    import torch
    lat_g, st_g = got
    lat_w, st_w = want
    pairs = [("latency", lat_g, lat_w)]

    def add(prefix, a, b):
        for f in b._fields:
            x, y = getattr(a, f), getattr(b, f)
            if (x is None) != (y is None):
                fail(f"{label}: {prefix}{f} present on one side only")
            if isinstance(y, tuple):
                add(f"{f}.", x, y)
            elif y is not None:
                pairs.append((prefix + f, x, y))

    add("", st_g, st_w)
    err = 0.0
    for name, g, w in pairs:
        g = g.cpu()
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{label}: {name} is {g.dtype}{tuple(g.shape)}, plain "
                 f"version {w.dtype}{tuple(w.shape)}")
        if g.is_floating_point():
            err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
        if not torch.equal(g, w):
            fail(f"{label}: {name} differs from the plain version")
    return err


MIXED_OPS, MIXED_STEP, MIXED_PAD = 512, 48, 1024


def mixed_jobs(cfg, n_logical):
    """Phase 2's mixed cells: every composition (the eight the kernel
    specialises) x both modes x the per-op form (K = 1, packed carry)
    and the K = 32 segment form (unpacked), one cell each, each its own
    stream length (512 ops plus 48 a cell, on hm_0 and proj_0 in turn,
    and a 1,024-op pad tail). CPU jobs and their labels."""
    import numpy as np
    import torch
    from repro_torch.core.ssd.policies.spec import PolicySpec
    from repro_torch.core.ssd.policies.state import init_state, map_state
    from repro_torch.core.ssd.sim import default_params
    from repro_torch.kernels.ssd_step import ops as ssd_step
    from repro_torch.workloads import build_ops, compress_ops, truncate_trace

    compositions = ("baseline", "ips", "ips_agc", "coop", "dyn_slc",
                    "ips_lazy",
                    PolicySpec("static", "idle_gap", "migrate", "greedy"),
                    PolicySpec("adaptive", "idle_gap", "migrate", "greedy"))
    full = {n: build_ops(n, n_logical, capacity_pages=cfg.total_pages)
            for n in ("hm_0", "proj_0")}
    jobs, labels = [], []
    for policy in compositions:
        for mode in ("daily", "bursty"):
            for form in ("K=1", "K=32"):
                n_ops = MIXED_OPS + MIXED_STEP * len(jobs)
                ops = truncate_trace(full[("hm_0", "proj_0")[len(jobs) % 2]],
                                     n_ops)
                trace = {"arrival_ms": np.concatenate(
                             [ops["arrival_ms"],
                              np.full(MIXED_PAD, ops["arrival_ms"][-1],
                                      np.float32)]),
                         "lba": np.concatenate(
                             [ops["lba"], np.zeros(MIXED_PAD, np.int32)]),
                         "is_write": np.concatenate(
                             [ops["is_write"],
                              np.full(MIXED_PAD, -1, np.int8)])}
                if form == "K=1":
                    arrays = {k: v[:n_ops].astype(
                        np.float32 if k == "arrival_ms" else np.int32)
                        .reshape(1, n_ops, 1) for k, v in trace.items()}
                    n_pad, pad_t = MIXED_PAD, trace["arrival_ms"][n_ops]
                else:
                    plan = compress_ops(trace, quantum=256)
                    arrays = {k: v[None] for k, v in plan.segs.items()}
                    n_pad, pad_t = plan.n_pad, plan.pad_t
                params = default_params(cfg, policy, 0.05, device="cpu")
                jobs.append(ssd_step.StreamJob(
                    policy, {k: torch.from_numpy(v) for k, v in
                             arrays.items()},
                    init_state(cfg, n_logical, packed=form == "K=1",
                               n_cells=1, device="cpu"),
                    mode == "bursty", map_state(lambda x: x[None], params),
                    n_pad, torch.tensor([pad_t], dtype=torch.float32)))
                labels.append(f"{getattr(policy, 'composition', policy)}/"
                              f"{mode}/{form}/{n_ops} ops")
    return jobs, labels


def mixed_launch_vs_plain(cfg, n_logical, cuda, plain) -> dict:
    """Phase 2's mixed launch: the mixed cells in ONE `run_streams`
    launch, every cell held to its own plain run on the CPU (from
    `plain`, the `PlainRuns`), bit for bit."""
    import torch
    from repro_torch.kernels.ssd_step import ops as ssd_step

    jobs, labels = mixed_jobs(cfg, n_logical)
    before = ssd_step.launches
    got = ssd_step.run_streams(cfg, [on_card(j, cuda) for j in jobs])
    torch.cuda.synchronize()
    if ssd_step.launches != before + 1:
        fail("phase 2: the mixed jobs took more than one launch")
    for i, (res, label) in enumerate(zip(got, labels)):
        leaves_equal(f"mixed launch {label}", res, plain.result("mixed", i)[0])
    return {"cells": len(jobs), "launches": 1, "equal": True,
            "compositions": len(jobs) // 4, "modes": 2,
            "forms": ["K=1", "K=32"],
            "stream_ops": [int(j.segs["lba"].numel()) for j in jobs]}


PLAIN_WORKERS = 4      # processes that run phase 2's plain versions


def phase2_cfg():
    """The SSD of phase 2 and the sweep paths: the paper's, scaled down
    128 times, and its logical pages."""
    from repro_torch.configs.ssd_paper import PAPER_SSD
    cfg = PAPER_SSD.scaled(128)
    return cfg, min(cfg.total_pages, 1 << 16)


def phase2_streams(cfg, n_logical) -> dict:
    """Phase 2's streams: hm_0 and proj_0, SMOKE_OPS live ops and
    SMOKE_PAD identical tail pads each (`traces`), in the per-op form
    (`per_op`, K = 1) and the K = 32 segment form (`seg`), and the pads'
    arrival time (`pad_t`)."""
    import numpy as np
    from repro_torch.workloads import build_ops, compress_ops, truncate_trace

    def padded(name):
        ops = truncate_trace(build_ops(name, n_logical,
                                       capacity_pages=cfg.total_pages),
                             SMOKE_OPS)
        return {"arrival_ms": np.concatenate(
                    [ops["arrival_ms"], np.full(SMOKE_PAD,
                                                ops["arrival_ms"][-1],
                                                np.float32)]),
                "lba": np.concatenate([ops["lba"],
                                       np.zeros(SMOKE_PAD, np.int32)]),
                "is_write": np.concatenate(
                    [ops["is_write"], np.full(SMOKE_PAD, -1, np.int8)])}

    traces = [padded(n) for n in ("hm_0", "proj_0")]
    plans = [compress_ops(t, quantum=1024) for t in traces]
    per_op = {k: np.stack([t[k][:SMOKE_OPS] for t in traces])
              .astype(np.float32 if k == "arrival_ms" else np.int32)
              .reshape(len(traces), SMOKE_OPS, 1) for k in traces[0]}
    seg = {k: np.stack([p.segs[k] for p in plans]) for k in plans[0].segs}
    pad_t = np.float32([t["arrival_ms"][SMOKE_OPS] for t in traces])
    assert all(p.n_pad == SMOKE_PAD and p.pad_t == pt
               for p, pt in zip(plans, pad_t))
    return {"traces": traces, "per_op": per_op, "seg": seg, "pad_t": pad_t}


def phase2_cases() -> list:
    """Phase 2's comparisons: (policy, mode, form) for every paper policy,
    both modes and both forms."""
    from repro_torch.core.ssd.policies.registry import PAPER_POLICIES
    return [(policy, mode, form) for policy in PAPER_POLICIES
            for mode in ("daily", "bursty") for form in ("K=1", "K=32")]


def phase2_run(cfg, n_logical, streams, case, dev, window):
    """One phase-2 comparison run on `dev` (the probe on with a window):
    (latency, SimState)."""
    import torch
    from repro_torch.core.ssd.policies.state import init_state, map_state
    from repro_torch.core.ssd.sim import default_params
    from repro_torch.kernels.ssd_step import ops as ssd_step

    policy, mode, form = case
    arrays = streams["per_op"] if form == "K=1" else streams["seg"]
    c_cnt = len(streams["traces"])
    params = map_state(lambda x: torch.stack([x] * c_cnt).to(dev),
                       default_params(cfg, policy, 0.05, device="cpu"))
    return ssd_step.run_stream(
        cfg, policy, {k: torch.from_numpy(v).to(dev)
                      for k, v in arrays.items()},
        init_state(cfg, n_logical, packed=True, n_cells=c_cnt, device=dev),
        closed_loop=(mode == "bursty"), params=params, n_pad=SMOKE_PAD,
        pad_t=torch.from_numpy(streams["pad_t"]).to(dev), window_ops=window)


_WORKER: dict = {}


def plain_task(kind: str, i: int):
    """One of phase 2's plain-version runs on the CPU, in a worker
    process: comparison `i` with the probe on ("case"), mixed cell `i`
    ("mixed") or wear job `i` with its probe on ("wear"), its inputs made
    here as the card's are. Returns the result as `torch.save` bytes and
    the run's seconds on one thread."""
    import io
    import torch
    from repro_torch.kernels.ssd_step import ops as ssd_step

    w = _WORKER
    if not w:
        torch.set_num_threads(1)
        w["cfg"], w["n_logical"] = phase2_cfg()
        w["streams"] = phase2_streams(w["cfg"], w["n_logical"])
    cfg, n_logical, streams = w["cfg"], w["n_logical"], w["streams"]
    if kind == "mixed" and "mixed" not in w:
        w["mixed"] = mixed_jobs(cfg, n_logical)[0]
    if kind == "wear" and "wear" not in w:
        w["wear"] = wear_jobs(cfg, n_logical, streams["traces"])[0]
    t0 = time.perf_counter()
    if kind == "case":
        res = phase2_run(cfg, n_logical, streams, phase2_cases()[i],
                         torch.device("cpu"), PROBE_WINDOW)
    elif kind == "mixed":
        res = ssd_step.run_streams(cfg, [w["mixed"][i]])[0]
    else:
        res = ssd_step.run_streams(
            cfg, [w["wear"][i]._replace(window_ops=WEAR_PROBE_WINDOW)])[0]
    s = time.perf_counter() - t0
    buf = io.BytesIO()
    torch.save(res, buf)
    return buf.getvalue(), s


class PlainRuns:
    """Phase 2's plain-version runs, each on one CPU thread in one of
    PLAIN_WORKERS spawned processes, started with the script so that they
    run beside the kernels' build. `counts` is ((kind, n), ...) in the
    order phase 2 reads them; `result(kind, i)` waits for one and returns
    (result, seconds)."""

    def __init__(self, counts):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        self.pool = ProcessPoolExecutor(
            PLAIN_WORKERS, mp_context=multiprocessing.get_context("spawn"))
        self.futures = {(kind, i): self.pool.submit(plain_task, kind, i)
                        for kind, n in counts for i in range(n)}

    def result(self, kind: str, i: int):
        import io
        import torch
        data, s = self.futures[(kind, i)].result()
        return torch.load(io.BytesIO(data), weights_only=False), s

    def close(self) -> None:
        self.pool.shutdown(cancel_futures=True)


def on_card(job, cuda):
    """A CPU `StreamJob` with every tensor moved to the card."""
    from repro_torch.core.ssd.policies.state import map_state
    return job._replace(
        segs={k: v.to(cuda) for k, v in job.segs.items()},
        state0=map_state(lambda x: x.to(cuda), job.state0),
        params=map_state(lambda x: x.to(cuda), job.params),
        pad_t=None if job.pad_t is None else job.pad_t.to(cuda))


def wear_jobs(cfg, n_logical, traces, cells_of=None):
    """Phase 2's wear streams: ips_raro, base_wl and ips x both modes,
    the per-op form of hm_0 and proj_0 (WEAR_OPS ops each, every op
    stepped), at small caches and budgets so that the gate, the
    fallback, the end of life and the read penalty all fire. CPU jobs,
    one per (policy, mode), `c_cnt` cells each."""
    import numpy as np
    import torch
    from repro_torch.core.ssd.endurance.spec import EnduranceSpec
    from repro_torch.core.ssd.policies.state import init_state, map_state
    from repro_torch.core.ssd.sim import default_params
    from repro_torch.kernels.ssd_step import ops as ssd_step

    spec = EnduranceSpec(w_rp=4.0, w_erase=1.0, cycle_budget=3.0,
                         rp_budget=0.75, read_penalty_ms=0.05,
                         rp_hysteresis=0.25)
    arrays = {k: np.stack([t[k][:WEAR_OPS] for t in traces]).astype(
        np.float32 if k == "arrival_ms" else np.int32)
        .reshape(len(traces), WEAR_OPS, 1) for k in traces[0]}
    jobs, labels = [], []
    for policy in ("ips_raro", "base_wl", "ips"):
        for mode in ("daily", "bursty"):
            p = default_params(cfg, policy, 0.05, spec, device="cpu")
            p = p._replace(cap_basic=torch.tensor(8, dtype=torch.int32),
                           cap_trad=torch.tensor(8, dtype=torch.int32))
            c_cnt = len(traces)
            jobs.append(ssd_step.StreamJob(
                policy, {k: torch.from_numpy(v) for k, v in arrays.items()},
                init_state(cfg, n_logical, packed=True, n_cells=c_cnt,
                           endurance=True, device="cpu"),
                mode == "bursty",
                map_state(lambda x: torch.stack([x] * c_cnt), p)))
            labels.append(f"{policy}/{mode}/wear")
    return jobs, labels


def wear_vs_plain(cfg, n_logical, cuda, traces, plain) -> dict:
    """The kernel's wear form against its plain version: each wear job in
    its own launch (timed by CUDA events) with the probe off and on, then
    all of them in one launch with the probe on; every leaf, the wear
    carry's and the probe's rows (wear peaks included) too, equal. The
    plain version runs once a job, with the probe on (its latencies and
    carries are the probe-off ones), in `plain`, the `PlainRuns`. (Phase
    3's sensitivity grid mixes wear and plain cells in its one launch.)"""
    import torch
    from repro_torch.kernels.ssd_step import ops as ssd_step

    jobs, labels = wear_jobs(cfg, n_logical, traces)
    jobs = [j._replace(window_ops=WEAR_PROBE_WINDOW) for j in jobs]
    kernel_ms, probe_ms, plain_s, err, fired, wants = (0.0, 0.0, 0.0, 0.0,
                                                      [], [])
    for i, (job, label) in enumerate(zip(jobs, labels)):
        # an untimed launch first: the clocks come back up from an idle
        # spell
        ssd_step.run_streams(cfg, [on_card(job._replace(window_ops=None),
                                           cuda)])
        got_off = ssd_step.run_streams(
            cfg, [on_card(job._replace(window_ops=None), cuda)])[0]
        torch.cuda.synchronize()
        start, end = ssd_step.events[-1]
        kernel_ms += start.elapsed_time(end)
        got = ssd_step.run_streams(cfg, [on_card(job, cuda)])[0]
        torch.cuda.synchronize()
        start, end = ssd_step.events[-1]
        probe_ms += start.elapsed_time(end)
        want, s = plain.result("wear", i)
        plain_s += s
        wants.append(want)
        if want[1].timeline.wear_peak is None:
            fail(f"{label}: the wear form's probe has no wear peaks")
        err = max(err, leaves_equal(f"{label} probe", got, want))
        err = max(err, leaves_equal(
            f"{label} probe off", got_off,
            (want[0], want[1]._replace(timeline=None))))
        wear = want[1].wear
        fired.append({"job": label,
                      "eol_op": [float(x) for x in wear.eol_op],
                      "pe_rp_total": float(wear.pe_rp.sum()),
                      "pe_slc_total": float(wear.pe_slc.sum())})
    if not any(f["eol_op"][0] > 0 for f in fired):
        fail("phase 2 wear: no cell reached its end of life")
    # and all of them in one launch
    before = ssd_step.launches
    got = ssd_step.run_streams(cfg, [on_card(j, cuda) for j in jobs])
    torch.cuda.synchronize()
    if ssd_step.launches != before + 1:
        fail("phase 2 wear: the wear jobs took more than one launch")
    for res, want, label in zip(got, wants, labels):
        err = max(err, leaves_equal(f"one launch {label}", res, want))
    c_cnt = len(traces)
    n_ops = len(jobs) * c_cnt * WEAR_OPS
    wear_bytes = len(jobs) * (stream_bytes(c_cnt, WEAR_OPS, False,
                                           cfg.num_planes, n_logical)
                              + c_cnt * 2 * 4 * (2 * cfg.num_planes * 8
                                                 + 4 * cfg.num_planes + 2))
    bound, by = bound_ms(wear_bytes, n_ops * (CORE_F32_OPS + WEAR_F32_OPS))
    return {"jobs": labels, "cells_per_job": c_cnt, "ops": WEAR_OPS,
            "equal": True, "max_abs_err": err, "kernel_ms": kernel_ms,
            "probe_window": WEAR_PROBE_WINDOW, "probe_kernel_ms": probe_ms,
            "plain_ms": plain_s * 1e3, "bound_ms": bound, "bound_by": by,
            "launches": 3 * len(jobs) + 1, "fired": fired}


def op_cycles(cfg, n_logical, cuda, per_op, pad_t) -> list:
    """Where an op's cycles go: phase 2's per-op streams (hm_0 and
    proj_0, 4096 ops and the 8192-op pad tail) under each paper policy
    and mode, in one launch. Per job: clock64 cycles per stepped op of
    its longest cell, and the share spent waiting on the op ring."""
    import torch
    from repro_torch.core.ssd.policies.registry import PAPER_POLICIES
    from repro_torch.core.ssd.policies.state import init_state, map_state
    from repro_torch.core.ssd.sim import default_params
    from repro_torch.kernels.ssd_step import ops as ssd_step

    c_cnt = per_op["lba"].shape[0]
    jobs, labels = [], []
    for policy in PAPER_POLICIES:
        for mode in ("daily", "bursty"):
            params = default_params(cfg, policy, 0.05, device="cpu")
            jobs.append(ssd_step.StreamJob(
                policy, {k: torch.from_numpy(v).to(cuda)
                         for k, v in per_op.items()},
                init_state(cfg, n_logical, packed=True, n_cells=c_cnt,
                           device=cuda), mode == "bursty",
                map_state(lambda x: torch.stack([x] * c_cnt).to(cuda),
                          params),
                SMOKE_PAD, torch.from_numpy(pad_t).to(cuda)))
            labels.append(f"{policy}/{mode}")
    cols = {c: i for i, c in enumerate(ssd_step.TIMER_COLUMNS)}
    timer = torch.zeros((len(jobs) * c_cnt, len(cols)), dtype=torch.int64,
                        device=cuda)
    ssd_step.run_streams(cfg, jobs, timer=timer)
    timer = timer.cpu().numpy()
    out = []
    for i, label in enumerate(labels):
        rows = timer[i * c_cnt:(i + 1) * c_cnt]
        stepped = rows[:, cols["scanned_ops"]] + rows[:, cols["pads_replayed"]]
        c = int(stepped.argmax())
        n = int(stepped[c])
        out.append({
            "job": label, "stepped_ops": n,
            "cycles_per_op": float(rows[c, cols["cycles"]]) / n,
            "wait_share": float(rows[c, cols["wait_cycles"]])
            / max(float(rows[c, cols["cycles"]]), 1.0)})
    return out


# ---------------------------------------------------------------------------
# the serving path (phases 4-6)
# ---------------------------------------------------------------------------

# the dense and Mamba2 serving paths (phases 6 and 8) at full width, their
# depth cut to keep the script near half its 1200 s: the same script ran
# 753 s on one H100 machine and 1,065 s on another, the serving paths
# host-bound and some 12 s a layer there (PERF.md §4); zamba2's 12 are
# two of its macro blocks (6 Mamba2 layers and the shared attention)
SERVE_ARCHS = (("gemma-2b", 9), ("mamba2-370m", 24), ("zamba2-1.2b", 12))
# the MoE paths (phase 9): deepseek-v2-lite at full width under the four
# policies, its depth cut from 27 to DEEPSEEK_LAYERS (the first dense,
# the rest MoE) to keep the script within its 1200 s: the phase took
# 9.3-14.5 s a layer, 250 s at 20 layers, and the script 1,068-1,093 s
# with it at 20 on one H100 and over 1,200 s on another (PERF.md §4);
# one arctic-480b layer at its published widths (35 layers, some 470 B
# parameters, need more than one card) under IPS
DEEPSEEK_LAYERS = 8
MOE_ARCHS = (("deepseek-v2-lite-16b", DEEPSEEK_LAYERS, None),
             ("arctic-480b", 1, ("IPS",)))
# the encoder-decoder and VLM paths (phases 10 and 11): whisper-tiny at
# full size under the four policies; llava-next-34b at full width under
# IPS, its depth cut from 60 to LLAVA_LAYERS: at 60 (64.05 GiB of bf16
# weights) the phase took 97.4 s, over its 90 s, and its plain and floor
# runs brought the card to 77.7 GiB in use; at 48, 77-114 s (PERF.md §4)
LLAVA_LAYERS = 32
EXTRA_ARCHS = (("whisper-tiny", None, None),
               ("llava-next-34b", LLAVA_LAYERS, ("IPS",)))
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 2048, 128
# the floor runs' other summation order: the prefill's attention softmax
# in chunks of 256 instead of 512, the SSD scan in chunks of 128, not 256
FLOOR_ATTN_CHUNK, FLOOR_SSD_CHUNK = 256, 128
SERVE_SEED = 0
GROUP = 64
TIMED = 20                      # launches per kernel timing
PLAIN_TIMED = 3                 # calls per plain-version timing
# Logits of the kernel run vs the plain run, at every step: within 2e-2
# of the logits' range (max |logit|), or within twice the floor — the
# plain versions' own difference when only the prefill's softmax chunk
# changes, run beside them. Elementwise 2e-2 holds at 2 layers
# (tests/test_torch_serve.py), not at 18: bf16 activations through 18
# random layers turn last-bit differences into some 0.1 of logit, and
# the plain versions differ from themselves by as much.
LOGITS_TOL = 2e-2
# The rms check beside it: at every decode step, rms(kernel run - plain
# run) / rms(floor run - plain run) at most RMS_LIMIT. A tiered kernel
# that drops the last 32 (or 256) dense tokens must exceed it at every
# step. Set between what an H100 read (NVIDIA H100 80GB HBM3, 700 W): the
# honest kernels at most 1.132 over the three models and four policies,
# the 32-token fault at least 1.538 at every step.
RMS_LIMIT = 1.3


def serving_libraries():
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.ips_repack import ops as repack
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.tiered_attention import ops as tiered
    return [("ips_repack", repack.LIB), ("tiered_decode", tiered.LIB),
            ("latent_decode", tiered.LATENT_LIB), ("flash_fwd", flash.LIB),
            ("ssd_intra", ssd.LIB)]


def _launchers():
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.ips_repack import ops as repack
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.tiered_attention import ops as tiered
    return {"ips_repack": repack.LAUNCHER, "tiered_decode": tiered.LAUNCHER,
            "latent_decode": tiered.LATENT_LAUNCHER,
            "flash_fwd": flash.LAUNCHER, "ssd_intra": ssd.LAUNCHER}


def time_ms(fn, n: int) -> float:
    """Mean ms of fn() over n calls after one warm-up (CUDA events around
    the run; host time between launches included)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_ms(launcher, fn, n: int = TIMED) -> float:
    """Mean ms per launch of the kernel alone: CUDA events around each
    launch on its stream, after one warm-up."""
    fn()
    launcher.reset()
    launcher.record = True
    try:
        for _ in range(n):
            fn()
        times = launcher.ms()
    finally:
        launcher.record = False
        launcher.reset()
    return sum(times) / len(times)


def graph_ms(fn, n: int = TIMED) -> float:
    """Mean device ms of fn() over n calls captured in one CUDA graph and
    replayed: the kernels' own time, without the host's launch gaps that
    the events around a single call include when the card waits on the
    host."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    ms = time_ms(graph.replay, 3) / n
    del graph
    return ms


def repack_bound(rows: int, feat: int):
    """Tier form: read rows x feat bf16, write the packed bytes and the
    bf16 scales, each once; some 7 float32 operations a value."""
    moved = rows * feat * 2 + rows * feat // 2 + rows * (feat // GROUP) * 2
    return bound_ms(moved, 7 * rows * feat)


def arena_bound(pages: int, tokens: int, feat: int):
    """Arena form: each page's tokens x feat bf16 read once, its packed
    bytes and bf16 scales written once (the stale tail untouched)."""
    return repack_bound(pages * tokens, feat)


def l2_flush(cuda):
    """A read of 512 MiB: run before a timed launch, it leaves the L2
    full of clean lines (a write would leave dirty ones, whose write-back
    the launch would pay) and keeps the card busy while the host issues
    the launch."""
    import torch
    buf = torch.ones(128 << 20, dtype=torch.float32, device=cuda)
    return lambda: buf.sum()


def cold_ms(fn, before, n: int = TIMED) -> float:
    """Mean ms of fn() by CUDA events around each call, `before()` run
    just before each call, outside the events; after one warm-up."""
    import torch
    fn()
    times = []
    for _ in range(n):
        before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in times) / n


def tiered_bound(b, hkv, g, hd, dense_len):
    """k4 and v4 bytes and bf16 scales of dense_len tokens, q in, (m, l,
    acc) out; 4 operations per (query head, token, feature)."""
    moved = (b * hkv * dense_len * (hd + 2 * (hd // GROUP) * 2)
             + b * hkv * g * hd * 4 + b * hkv * g * (hd + 2) * 4)
    return bound_ms(moved, 4 * b * hkv * g * dense_len * hd)


def latent_bound(b, h, r, p, dense_len):
    """The latent form: dense_len tokens' packed latent, bf16 scales and
    bf16 RoPE key read once, q_lat and q_rope in, (m, l, acc) out; 2 * H
    * (2r + p) operations a token (its scores against the latent and the
    RoPE key, its share of acc) on the bf16 tensor cores, as the kernel
    runs them. Returns (ms, by, the bound with the operations in float32
    on the CUDA cores)."""
    moved = (b * dense_len * (r // 2 + (r // GROUP) * 2 + p * 2)
             + b * h * (r + p) * 4 + b * h * (r + 2) * 4)
    ops = 2 * b * h * dense_len * (2 * r + p)
    return bound_ms(moved, ops, BF16_OPS_PER_S) + (bound_ms(moved, ops)[0],)


def flash_bound(b, s, h, hkv, hd, itemsize, hd_v=None):
    """q, k, v read once, out (float32) and lse written once; the causal
    half of the two products at the inputs' type (bf16 tensor cores). At
    MLA's widths q and k are hd wide, v and out hd_v (no padding
    counted)."""
    hd_v = hd if hd_v is None else hd_v
    moved = ((b * s * h * hd + b * s * hkv * (hd + hd_v)) * itemsize
             + b * h * s * hd_v * 4 + b * h * s * 4)
    ops = 2 * b * h * s * s * (hd + hd_v) // 2
    return bound_ms(moved, ops, BF16_OPS_PER_S if itemsize == 2
                    else F32_OPS_PER_S)


def ssd_intra_work(bt, nc, q, nh, hd, n):
    """(bytes, product FLOPs, element-wise operations) of one `ssd_intra`
    call: x, dt, A, B, C read once, y, states and cum written once,
    float32; the causal half of C B^T and of the score-times-x product
    and the state product; 4 operations a score (subtract, exp, two
    products) and the state product's weights."""
    tri = q * (q + 1) // 2
    moved = 4 * (2 * bt * nc * q * nh * hd + bt * nc * nh * hd * n
                 + 2 * bt * nc * q * nh + nh + 2 * bt * nc * q * n)
    products = bt * nc * (2 * tri * n + nh * tri * 2 * hd
                          + nh * q * 2 * hd * n)
    elementwise = bt * nc * (nh * tri * 4 + nh * q * (n + 4))
    return moved, products, elementwise


def ssd_intra_bound(bt, nc, q, nh, hd, n):
    """The least time at the accuracy the path check holds (3xTF32): the
    three products at 3 x their FLOPs on the TF32 tensor-core rate, the
    element-wise work on the float32 CUDA-core rate, against the bytes.
    Returns (ms, "bytes" or "operations")."""
    moved, products, elementwise = ssd_intra_work(bt, nc, q, nh, hd, n)
    t_ops = (3 * products / TF32_OPS_PER_S
             + elementwise / F32_OPS_PER_S) * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def ssd_intra_bound_f32(bt, nc, q, nh, hd, n):
    """The same work with every operation on the float32 CUDA-core rate
    (the bound PRs 13 and 14 reported)."""
    moved, products, elementwise = ssd_intra_work(bt, nc, q, nh, hd, n)
    return bound_ms(moved, products + elementwise)


def _within(label, got, want, tol) -> float:
    """|got - want| <= tol + tol*|want| everywhere; returns the largest
    absolute difference."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{label}: {got.dtype}{tuple(got.shape)} vs plain version "
             f"{want.dtype}{tuple(want.shape)}")
    diff = (got - want).abs()
    if not torch.isfinite(got).all():
        fail(f"{label}: non-finite values")
    if bool((diff > tol + tol * want.abs()).any()):
        fail(f"{label}: differs from the plain version by "
             f"{float(diff.max())} (tolerance {tol})")
    return float(diff.max()) if diff.numel() else 0.0


def _logits_close(label, got, want, floor_run):
    """The kernel run's logits `got` against the plain run's `want`:
    max |got - want| <= max(LOGITS_TOL * max |want|, 2 * floor), where
    the floor is max |floor_run - want|, the plain versions' difference
    from themselves under another summation order. Returns (error,
    floor, limit)."""
    import torch
    if not torch.isfinite(got).all():
        fail(f"{label}: non-finite logits")
    err = float((got - want).abs().max())
    floor = float((floor_run - want).abs().max())
    limit = max(LOGITS_TOL * float(want.abs().max()), 2.0 * floor)
    if err > limit:
        fail(f"{label}: logits differ from the plain run's by {err} "
             f"(limit {limit}; floor {floor})")
    return err, floor, limit


def _same_scales(got, want) -> bool:
    """Equal bit for bit, except that a NaN equals any NaN (the plain
    version's reduction may carry another NaN payload)."""
    import torch
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return False
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    return torch.equal(torch.where(nan, 0, got).view(bits),
                       torch.where(nan, 0, want).view(bits))


def repack_exhaustive(cuda, gen) -> dict:
    """Every bf16 bit pattern as x against 512 absmax values a (zero, 16
    subnormals, 7 * 2^k for k in -40..40, which make exact half-integer
    quotients, the largest finite bf16 and random finite patterns): for
    each (x, a) a group of 64 holding x, a and 62 zeros, so that its
    absmax is max(|x|, a) (x = 0 with a = 0 is an all-zero group). Through
    `quantize_into` into a bf16 scale tier and through its plain version,
    both on the card: the packed bytes equal, the scales equal bit for bit
    (NaN where the plain version has NaN)."""
    import torch
    from repro_torch.kernels.ips_repack import ops as repack
    from repro_torch.kernels.ips_repack.ref import quantize_into_ref
    patterns = torch.arange(1 << 16, dtype=torch.int32, device=cuda).to(
        torch.int16).view(torch.bfloat16)
    k = torch.arange(-40, 41, dtype=torch.float32, device=cuda)
    fixed = torch.cat([
        torch.zeros(1, device=cuda),
        torch.arange(1, 17, dtype=torch.int32, device=cuda).to(
            torch.int16).view(torch.bfloat16).float(),
        7.0 * torch.exp2(k),
        torch.tensor([0x7f7f], dtype=torch.int32, device=cuda).to(
            torch.int16).view(torch.bfloat16).float()])
    rand = torch.randint(0x0080, 0x7f80, (512 - fixed.numel(),),
                         generator=gen, device=cuda, dtype=torch.int32)
    amax = torch.cat([fixed.to(torch.bfloat16),
                      rand.to(torch.int16).view(torch.bfloat16)])
    batch, n = 16, patterns.numel()
    for i in range(0, amax.numel(), batch):
        a = amax[i:i + batch]
        vals = torch.zeros((a.numel(), n, GROUP), dtype=torch.bfloat16,
                           device=cuda)
        vals[:, :, 0] = patterns
        vals[:, :, 1] = a[:, None]
        src = vals.reshape(1, 1, a.numel() * n, GROUP)
        got = (torch.empty((1, 1, a.numel() * n, GROUP // 2),
                           dtype=torch.uint8, device=cuda),
               torch.empty((1, 1, a.numel() * n, 1), dtype=torch.bfloat16,
                           device=cuda))
        want = tuple(torch.empty_like(t) for t in got)
        repack.quantize_into([(src,) + got], 0, GROUP)
        quantize_into_ref([(src,) + want], 0, GROUP)
        if not (torch.equal(got[0], want[0])
                and _same_scales(got[1], want[1])):
            bad = (got[0] != want[0]).any(-1).reshape(-1).nonzero()
            j = int(bad[0]) if bad.numel() else -1
            fail(f"ips_repack exhaustive: x {hex(j % n)} against absmax "
                 f"{float(a[j // n]) if j >= 0 else '?'}: the kernel differs "
                 "from its plain version")
    return {"x_patterns": n, "absmax_values": int(amax.numel()),
            "groups": n * int(amax.numel()), "equal": True}


def repack_event_split(cuda, arch, slots, hkv, hd) -> dict:
    """One repack event (one page, dense_len 1024) of `arch`'s tiered
    cache at the serving sizes, `repack_pages` timed by CUDA events with
    the L2 flushed before it: the event's device ms, the kernel's share
    (its launch's events) and the roll's (the rest)."""
    import torch
    from repro_torch.core.tiercache.layout import TierSpec, gqa_layer_zeros
    from repro_torch.core.tiercache.manager import repack_pages
    from repro_torch.kernels.ips_repack import ops as repack
    spec = TierSpec(s_max=SERVE_PROMPT + SERVE_STEPS)
    layers = gqa_layer_zeros(slots, SERVE_BATCH, spec, hkv, hd, device=cuda)
    for name in ("kh", "vh"):
        layers[name].normal_()
    flush = l2_flush(cuda)
    repack_pages(layers, "gqa", spec, 1024, 1, False)
    events, kernel = [], []
    for _ in range(TIMED):
        flush()
        repack.LAUNCHER.reset()
        repack.LAUNCHER.record = True
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        repack_pages(layers, "gqa", spec, 1024, 1, False)
        end.record()
        kernel += repack.LAUNCHER.ms()
        repack.LAUNCHER.record = False
        events.append(start.elapsed_time(end))
    repack.LAUNCHER.reset()
    total, k_ms = sum(events) / TIMED, sum(kernel) / len(kernel)
    rows = 2 * slots * SERVE_BATCH * hkv * spec.page_tokens
    return {"arch": arch, "tokens": spec.page_tokens, "channels": 2,
            "event_ms": total, "kernel_ms": k_ms, "roll_ms": total - k_ms,
            "kernel_share": k_ms / total,
            "kernel_bound_ms": repack_bound(rows, hd)[0]}


def repack_vs_plain(cuda, gen, launcher) -> dict:
    """Phase 5's `ips_repack`: every bf16 pattern (`repack_exhaustive`);
    every group the reference takes; the in-place form (K and V, or
    MLA's one latent, in one launch, from the strided hot-tier slice into
    bf16-scaled dense tiers) at gemma-2b's, zamba2-1.2b's, arctic-480b's
    and deepseek-v2-lite's serving shapes; the arena form at 128
    pages of 256 x 1024 with its stale tail; each against its plain
    version on the card, bit for bit. Times: the tier form at gemma-2b's
    prefill fill (73,728 x 256 bf16, bf16 scales) per launch (events, the
    input reused, as before), cold (L2 flushed) and its device time (a
    CUDA graph); each in-place event; the arena cold. Returns the kernel
    table's row."""
    import torch
    from repro_torch.kernels.ips_repack import ops as repack
    from repro_torch.kernels.ips_repack.ref import (page_layout,
                                                    quantize_into_ref,
                                                    quantize_rows_ref,
                                                    repack_ref)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=cuda)).to(
            torch.bfloat16)

    flush = l2_flush(cuda)
    exhaustive = repack_exhaustive(cuda, gen)
    cases = [f"every bf16 x against {exhaustive['absmax_values']} absmax "
             "values"]
    for group in (2, 6, 48, 64, 128, 256):
        x = randn(333, 768, scale=4.0)
        x[::5, :group] = 0.0                            # all-zero groups
        got, want = repack.quantize_rows(x, group), quantize_rows_ref(x, group)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail(f"ips_repack group {group}: bytes or scales differ from the "
                 "plain version")
        cases.append(f"group {group}")

    # the in-place form at the serving shapes: each channel (GQA's K and
    # V; MLA's latent, with no head axis) from the hot tier's first t
    # tokens into the dense tier at the watermark, one launch
    s_dense = SERVE_PROMPT + SERVE_STEPS + 1024
    in_place = {}
    for label, (slots, heads, hd, n_chan) in (
            ("gemma-2b", (18, (1,), 256, 2)),
            ("zamba2-1.2b", (6, (32,), 64, 2)),
            ("arctic-480b", (1, (8,), 128, 2)),
            ("deepseek-v2-lite-16b", (27, (), 512, 1))):
        for t, start in ((256, 1024), (1024, 0)):
            chans, want = [], []
            for _ in range(n_chan):
                hot = randn(slots, SERVE_BATCH, 1024, *heads, hd, scale=3.0)
                pk = torch.randint(0, 256, (slots, SERVE_BATCH, s_dense,
                                            *heads, hd // 2),
                                   dtype=torch.uint8, generator=gen,
                                   device=cuda)
                sc = randn(slots, SERVE_BATCH, s_dense, *heads, hd // GROUP)
                chans.append((hot[:, :, :t], pk, sc))
                want.append((hot[:, :, :t], pk.clone(), sc.clone()))
            quantize_into_ref(want, start, GROUP)
            before = launcher.launches
            repack.quantize_into(chans, start, GROUP)
            torch.cuda.synchronize()
            if launcher.launches != before + 1:
                fail(f"ips_repack in-place form {label}: its channels took "
                     "more than one launch")
            for (_, pk, sc), (_, wpk, wsc) in zip(chans, want):
                if not (torch.equal(pk, wpk) and torch.equal(sc, wsc)):
                    fail(f"ips_repack in-place form {label} t {t}: the dense "
                         "tier differs from the plain version's")
            cases.append(f"in place {label} t {t} start {start}")
            if t == 256:
                rows = n_chan * slots * SERVE_BATCH * t * math.prod(heads)
                bnd, by = repack_bound(rows, hd)

                def call(chans=chans, start=start):
                    repack.quantize_into(chans, start, GROUP)
                what = ("K and V" if n_chan == 2 else "the latent")
                in_place[label] = {
                    "ms": kernel_ms(launcher, call),
                    "cold_ms": cold_ms(call, flush), "bound_ms": bnd,
                    "bound_by": by,
                    "timed_shape": f"{what}, {slots} slots x B "
                                   f"{SERVE_BATCH} x {t} tokens x "
                                   f"{'Hkv %d x ' % heads[0] if heads else ''}"
                                   f"F {hd}, strided hot slice"}

    # the arena form at 128 pages of the TPU default 256 x 1024, a stale
    # tail after each
    tokens, feat, pages = 256, 1024, 128
    _, packed_b, scale_b = page_layout(tokens, feat, GROUP)
    page_bytes = tokens * feat * 2 + 4096
    orig = torch.randint(0, 256, (pages, page_bytes), dtype=torch.uint8,
                         generator=gen, device=cuda)
    orig[:, :tokens * feat * 2] = randn(pages, tokens * feat,
                                        scale=2.0).view(torch.uint8)
    want = repack_ref(orig, tokens, feat, GROUP)
    for n in (1, 5, pages):
        arena = orig[:n].clone()
        ptr = arena.data_ptr()
        if repack.repack_arena(arena, tokens=tokens, feat=feat,
                               group=GROUP).data_ptr() != ptr:
            fail("ips_repack arena form: not the same storage")
        if not torch.equal(arena, want[:n]):
            fail(f"ips_repack arena form {n} pages: bytes differ from the "
                 "plain version")
        if not torch.equal(arena[:, packed_b + scale_b:],
                           orig[:n, packed_b + scale_b:]):
            fail("ips_repack arena form: the stale tail was written")
        cases.append(f"arena {n} x {tokens} x {feat}")
    arena = orig.clone()
    bnd, by = arena_bound(pages, tokens, feat)
    arena_row = {
        "cold_ms": cold_ms(lambda: repack.repack_arena(
            arena, tokens=tokens, feat=feat, group=GROUP),
            lambda: (arena.copy_(orig), flush())),
        "bound_ms": bnd, "bound_by": by,
        "timed_shape": f"{pages} pages of {tokens} x {feat} bf16, group "
                       f"{GROUP}, one cluster of CTAs a page"}
    del arena, orig, want

    # the tier form at gemma-2b's prefill fill, one channel, bf16 scales
    rows = 18 * SERVE_BATCH * 1024
    x = randn(rows, 256, scale=3.0)
    pk = torch.empty((1, 1, rows, 128), dtype=torch.uint8, device=cuda)
    sc = torch.empty((1, 1, rows, 256 // GROUP), dtype=torch.bfloat16,
                     device=cuda)

    def tier():
        repack.quantize_into([(x[None, None], pk, sc)], 0, GROUP)
    bnd, by = repack_bound(rows, 256)
    row = {"name": "ips_repack", "route": "cuda",
           "source": "src/repro_torch/kernels/ips_repack/csrc/ips_repack.cu",
           "replaces": "src/repro/kernels/ips_repack/kernel.py:28",
           "max_abs_err": 0.0, "ms": kernel_ms(launcher, tier),
           "cold_ms": cold_ms(tier, flush), "device_ms": graph_ms(tier),
           "plain_ms": time_ms(lambda: quantize_into_ref(
               [(x[None, None], pk, sc)], 0, GROUP), PLAIN_TIMED),
           "bound_ms": bnd, "bound_by": by, "library_ms": None,
           "library": "none: no PyTorch call quantizes to packed int4",
           "timed_shape": f"tier form {rows}x256 bf16, bf16 scales, group "
                          f"{GROUP}",
           "in_place": in_place, "arena": arena_row,
           "exhaustive": exhaustive,
           "event_split": [repack_event_split(cuda, "gemma-2b", 18, 1, 256),
                           repack_event_split(cuda, "zamba2-1.2b", 6, 32,
                                              64)],
           **repack.LIB.ptxas()}
    emit({"phase": "kernel_vs_plain", "kernel": "ips_repack",
          "cases": cases, "equal": True, **row})
    return row


def serve_kernels_vs_plain(cuda) -> dict:
    """Phase 5: each serving kernel against its plain version on the card,
    at the serving shapes; returns the kernel-table fields of each."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.flash_attention.ref import flash_ref
    from repro_torch.kernels.ips_repack.ref import quantize_rows_ref
    from repro_torch.kernels.tiered_attention import ops as tiered
    from repro_torch.kernels.tiered_attention.ref import (
        dense_tier_partial_ref)

    gen = torch.Generator(device=cuda)
    gen.manual_seed(SERVE_SEED + 5)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=gen, device=cuda)).to(
            dtype)

    launchers = _launchers()
    for launcher in launchers.values():
        launcher.reset()
    out = {}

    out["ips_repack"] = repack_vs_plain(cuda, gen, launchers["ips_repack"])

    # -- tiered_decode at gemma-2b's decode shape (B 4, Hkv 1, G 8, hd 256),
    #    zamba2-1.2b's shared block's (B 4, Hkv 32, G 1, hd 64) and
    #    arctic-480b's (B 4, Hkv 8, G 7, hd 128), over the serving dense
    #    tier, both dequantized forms, dense_len from the empty tier
    #    through one token and either side of one split to full
    s_dense = SERVE_PROMPT + SERVE_STEPS + 1024
    err, cases, timed = 0.0, [], {}
    for label, (b, hkv, g, hd) in (("gemma-2b", (SERVE_BATCH, 1, 8, 256)),
                                   ("zamba2-1.2b", (SERVE_BATCH, 32, 1, 64)),
                                   ("arctic-480b", (SERVE_BATCH, 8, 7, 128))):
        k4, ksc = quantize_rows_ref(randn(b * s_dense * hkv, hd, scale=2.0,
                                          dtype=torch.bfloat16), GROUP)
        v4, vsc = quantize_rows_ref(randn(b * s_dense * hkv, hd, scale=2.0,
                                          dtype=torch.bfloat16), GROUP)
        k4, v4 = (t.reshape(b, s_dense, hkv, hd // 2) for t in (k4, v4))
        ksc, vsc = (t.reshape(b, s_dense, hkv, hd // GROUP)
                    for t in (ksc, vsc))
        q = randn(b, hkv, g, hd)
        split = tiered.split_plan(SERVE_PROMPT, b, hkv, g)[0]
        for form, deq in (("float32", torch.float32),
                          ("bf16", torch.bfloat16)):
            ks, vs = ksc.to(deq), vsc.to(deq)
            for dense_len in (0, 1, split - 1, split + 1, 1000, s_dense):
                got = tiered.dense_tier_partial(q, k4, ks, v4, vs, dense_len,
                                                group=GROUP, deq_dtype=deq)
                want = dense_tier_partial_ref(q, k4, ks, v4, vs, dense_len,
                                              GROUP, deq)
                for name, a, w in zip(("m", "l", "acc"), got, want):
                    err = max(err, _within(
                        f"tiered {label} {form} dense_len {dense_len} "
                        f"{name}", a, w, 2e-4))
                if dense_len == 0 and not (bool((got[0] == -1e30).all())
                                           and bool((got[1] == 0).all())
                                           and bool((got[2] == 0).all())):
                    fail("tiered: an empty tier must give m -1e30, l 0, "
                         "acc 0")
                cases.append(f"{label} {form} dense_len {dense_len}")
        ks, vs = ksc.to(torch.bfloat16), vsc.to(torch.bfloat16)
        timed_len = SERVE_PROMPT

        def call(q=q, k4=k4, ks=ks, v4=v4, vs=vs):
            return tiered.dense_tier_partial(q, k4, ks, v4, vs, timed_len,
                                             group=GROUP,
                                             deq_dtype=torch.bfloat16)
        tokens, splits = tiered.split_plan(timed_len, b, hkv, g)
        bnd, by = tiered_bound(b, hkv, g, hd, timed_len)
        timed[label] = {
            "ms": kernel_ms(launchers["tiered_decode"], call),
            "device_ms": graph_ms(call),
            "plain_ms": time_ms(lambda: dense_tier_partial_ref(
                q, k4, ks, v4, vs, timed_len, GROUP, torch.bfloat16),
                PLAIN_TIMED),
            "bound_ms": bnd, "bound_by": by,
            "timed_shape": (f"B {b}, Hkv {hkv}, G {g}, hd {hd}, S {s_dense}, "
                            f"dense_len {timed_len}, bf16 form"),
            "split_tokens": tokens, "blocks": b * hkv * splits}
    # -- the same kernel as whisper-tiny's cross-attention: its dense
    #    partial over the whole static cross tier (B 4, Hkv 6, G 1, hd 64,
    #    dense_len = S = 1500 frames, no multiple of the page or of a
    #    split; and S 1499 and 77), both forms; timed at 1500 in bf16
    b, hkv, g, hd = SERVE_BATCH, 6, 1, 64
    for frames in (WHISPER_FRAMES, WHISPER_FRAMES - 1, 77):
        k4, ksc = quantize_rows_ref(randn(b * frames * hkv, hd, scale=2.0,
                                          dtype=torch.bfloat16), GROUP)
        v4, vsc = quantize_rows_ref(randn(b * frames * hkv, hd, scale=2.0,
                                          dtype=torch.bfloat16), GROUP)
        k4, v4 = (t.reshape(b, frames, hkv, hd // 2) for t in (k4, v4))
        ksc, vsc = (t.reshape(b, frames, hkv, hd // GROUP)
                    for t in (ksc, vsc))
        q = randn(b, hkv, g, hd)
        for form, deq in (("float32", torch.float32),
                          ("bf16", torch.bfloat16)):
            ks, vs = ksc.to(deq), vsc.to(deq)
            got = tiered.dense_tier_partial(q, k4, ks, v4, vs, frames,
                                            group=GROUP, deq_dtype=deq)
            want = dense_tier_partial_ref(q, k4, ks, v4, vs, frames, GROUP,
                                          deq)
            for name, a, w in zip(("m", "l", "acc"), got, want):
                err = max(err, _within(
                    f"tiered cross tier {form} F {frames} {name}", a, w,
                    2e-4))
            cases.append(f"whisper-tiny cross {form} F {frames}")
        if frames != WHISPER_FRAMES:
            continue
        ks, vs = ksc.to(torch.bfloat16), vsc.to(torch.bfloat16)

        def call(q=q, k4=k4, ks=ks, v4=v4, vs=vs):
            return tiered.dense_tier_partial(q, k4, ks, v4, vs,
                                             WHISPER_FRAMES, group=GROUP,
                                             deq_dtype=torch.bfloat16)
        tokens, splits = tiered.split_plan(frames, b, hkv, g)
        bnd, by = tiered_bound(b, hkv, g, hd, frames)
        timed["whisper-tiny cross"] = {
            "ms": kernel_ms(launchers["tiered_decode"], call),
            "device_ms": graph_ms(call),
            "plain_ms": time_ms(lambda: dense_tier_partial_ref(
                q, k4, ks, v4, vs, WHISPER_FRAMES, GROUP, torch.bfloat16),
                PLAIN_TIMED),
            "bound_ms": bnd, "bound_by": by,
            "timed_shape": (f"B {b}, Hkv {hkv}, G {g}, hd {hd}, S {frames}, "
                            f"dense_len {frames}, bf16 form"),
            "split_tokens": tokens, "blocks": b * hkv * splits}
    gemma = timed["gemma-2b"]
    out["tiered_decode"] = {
        "name": "tiered_decode", "route": "cuda",
        "source": ("src/repro_torch/kernels/tiered_attention/csrc/"
                   "tiered_decode.cu"),
        "replaces": "src/repro/kernels/tiered_attention/kernel.py:37",
        "max_abs_err": err, "library_ms": None, **gemma,
        "zamba2_shape": timed["zamba2-1.2b"],
        "arctic_shape": timed["arctic-480b"],
        "whisper_cross_shape": timed["whisper-tiny cross"]}
    emit({"phase": "kernel_vs_plain", "kernel": "tiered_decode",
          "cases": cases, "tolerance": 2e-4, **out["tiered_decode"]})

    out["latent_decode"] = latent_vs_plain(cuda, gen, s_dense,
                                           launchers["latent_decode"])

    # -- flash_fwd: bf16 (the tensor-core form) at gemma-2b's, zamba2's and
    #    arctic's prefill shapes, S off the 128-row tile and below it;
    #    float32
    hgmma = flash.LIB.sass_count("HGMMA")
    if hgmma == 0:
        fail("flash_fwd: the built library issues no HGMMA (wgmma)")
    err_bf16 = err_f32 = 0.0
    cases = []
    shapes = {"gemma-2b": (SERVE_BATCH, SERVE_PROMPT, 8, 1, 256),
              "zamba2-1.2b": (SERVE_BATCH, SERVE_PROMPT, 32, 32, 64),
              "arctic-480b": (SERVE_BATCH, SERVE_PROMPT, 56, 8, 128),
              # whisper-tiny's decoder prefill; llava-next-34b's 576
              # patches and 2048 tokens at arctic's heads
              "whisper-tiny": (SERVE_BATCH, SERVE_PROMPT, 6, 6, 64),
              "llava-next-34b": (SERVE_BATCH, LLAVA_PATCHES + SERVE_PROMPT,
                                 56, 8, 128)}
    for b_, s_, h_, hkv_, hd_, dt, tol in (
            shapes["gemma-2b"] + (torch.bfloat16, 1e-2),
            shapes["zamba2-1.2b"] + (torch.bfloat16, 1e-2),
            shapes["arctic-480b"] + (torch.bfloat16, 1e-2),
            shapes["whisper-tiny"] + (torch.bfloat16, 1e-2),
            shapes["llava-next-34b"] + (torch.bfloat16, 1e-2),
            (2, 1000, 8, 1, 256, torch.bfloat16, 1e-2),
            (2, 1000, 6, 2, 64, torch.bfloat16, 1e-2),
            (2, 333, 6, 2, 64, torch.bfloat16, 1e-2),
            (2, 17, 8, 1, 256, torch.bfloat16, 1e-2),
            (1, 512, 8, 1, 256, torch.float32, 2e-5),
            (2, 333, 6, 2, 64, torch.float32, 2e-5)):
        qf = randn(b_, s_, h_, hd_, dtype=dt)
        kf = randn(b_, s_, hkv_, hd_, dtype=dt)
        vf = randn(b_, s_, hkv_, hd_, dtype=dt)
        got = flash.flash_fwd(qf, kf, vf)
        want = flash_ref(qf, kf, vf, chunk=512)
        e = max(_within(f"flash {tuple(qf.shape)} {dt} {n}", a, w, tol)
                for n, a, w in zip(("out", "lse"), got, want))
        if dt == torch.bfloat16:
            err_bf16 = max(err_bf16, e)
        else:
            err_f32 = max(err_f32, e)
        cases.append(f"{dt} B{b_} S{s_} H{h_} Hkv{hkv_} hd{hd_}")
    timed = {}
    for label, (b, s, h, hkv, hd) in shapes.items():
        qf = randn(b, s, h, hd, dtype=torch.bfloat16)
        kf = randn(b, s, hkv, hd, dtype=torch.bfloat16)
        vf = randn(b, s, hkv, hd, dtype=torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2) for t in (qf, kf, vf))
        bnd, by = flash_bound(b, s, h, hkv, hd, 2)

        def call(qf=qf, kf=kf, vf=vf):
            return flash.flash_fwd(qf, kf, vf)
        timed[label] = {
            "ms": kernel_ms(launchers["flash_fwd"], call),
            "plain_ms": time_ms(lambda: flash_ref(qf, kf, vf, chunk=512),
                                PLAIN_TIMED),
            "bound_ms": bnd, "bound_by": by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), TIMED),
            "timed_shape": f"B {b}, S {s}, H {h}, Hkv {hkv}, hd {hd}, bf16"}
    mla = flash_mla_vs_plain(cuda, randn, launchers["flash_fwd"])
    err_bf16 = max(err_bf16, mla.pop("max_abs_err"))
    cases += mla.pop("cases")
    out["flash_fwd"] = {
        "name": "flash_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:28",
        "max_abs_err": err_bf16, "max_abs_err_f32": err_f32,
        **timed["gemma-2b"],
        "library": "torch.nn.functional.scaled_dot_product_attention("
                   "is_causal=True, enable_gqa=True)",
        "sass_hgmma": hgmma, "zamba2_shape": timed["zamba2-1.2b"],
        "arctic_shape": timed["arctic-480b"],
        "whisper_shape": timed["whisper-tiny"],
        "llava_shape": timed["llava-next-34b"], "mla_shape": mla}
    emit({"phase": "kernel_vs_plain", "kernel": "flash_fwd", "cases": cases,
          "tolerance": {"bf16": 1e-2, "float32": 2e-5}, **out["flash_fwd"]})
    return out


LATENT_TOL = 2e-5               # of max |output|, as for ssd_intra


def latent_vs_plain(cuda, gen, s_dense, launcher) -> dict:
    """The latent form of the tiered decode against its plain version on
    the card: deepseek-v2-lite's decode shape (H 16, r 512, p 64, group
    64) over the serving tier at B 1 and 4, dense_len from the empty tier
    through one token, either side of the 16-token k-step, to 2048; H 1,
    5 and 16, r 32, 64, 96, 128, 192, 480 and 512 (r 32 at the reduced
    deepseek's H 4, p 16, group 16), p 16, 32 and 64, groups 2, 6, 16,
    32 and 64; q bf16-exact (as the serving path forms it) and float32
    that is not (the kernel's q_lo products); within LATENT_TOL of max
    |output|. Its time at B 4, dense_len 2048 beside its bound, under the
    wrapper's split plan."""
    import torch
    from repro_torch.kernels.ips_repack.ref import quantize_rows_ref
    from repro_torch.kernels.tiered_attention import ops as tiered
    from repro_torch.kernels.tiered_attention.ref import (
        latent_tier_partial_ref)

    def tier(b, s, h, r, p, group, exact=True):
        c4, sc = quantize_rows_ref(2.0 * torch.randn(
            (b * s, r), generator=gen, device=cuda), group)

        def bf16(*shape):
            return torch.randn(shape, generator=gen, device=cuda).to(
                torch.bfloat16)

        def q(*shape):
            return (bf16(*shape).float() if exact else torch.randn(
                shape, generator=gen, device=cuda))
        return (q(b, h, r), q(b, h, p), c4.reshape(b, s, r // 2),
                sc.reshape(b, s, r // group).to(torch.bfloat16),
                bf16(b, s + SERVE_PROMPT // 2, p))

    scale = 1.0 / 192 ** 0.5
    err, rel, cases = 0.0, 0.0, []
    for b, s, h, r, p, group, exact, lens in (
            (SERVE_BATCH, s_dense, 16, 512, 64, GROUP, True,
             (0, 1, 15, 17, 255, 1536, 2048)),
            (1, s_dense, 16, 512, 64, GROUP, True, (0, 1, 255, 2048)),
            (SERVE_BATCH, s_dense, 16, 512, 64, GROUP, False, (17, 2048)),
            (2, 700, 5, 128, 32, 32, True, (0, 15, 33, 699)),
            (2, 300, 1, 64, 16, GROUP, False, (1, 17, 299)),
            (3, 100, 5, 192, 16, 6, True, (77,)),
            (1, 70, 16, 64, 64, 2, False, (70,)),
            (2, 600, 16, 512, 32, 16, False, (599,)),
            # r 32 (deepseek-v2-lite reduced: H 4, p 16, group 16): one
            # warp of latent features, 32 wide; and odd multiples of 32
            (SERVE_BATCH, s_dense, 4, 32, 16, 16, True,
             (0, 1, 63, 65, 2048)),
            (2, 300, 16, 32, 64, 32, False, (299,)),
            (2, 300, 16, 96, 32, 32, True, (257,)),
            (2, 300, 8, 480, 64, 32, False, (299,))):
        t = tier(b, s, h, r, p, group, exact)
        for dense_len in lens:
            got = tiered.latent_tier_partial(*t, dense_len, group=group,
                                             scale=scale)
            want = latent_tier_partial_ref(*t, dense_len, group, scale)
            for name, a, w in zip(("m", "l", "acc"), got, want):
                top = max(float(w.abs().max()), 1e-30)
                e = float((a - w).abs().max())
                if not torch.isfinite(a).all() or e > LATENT_TOL * top:
                    fail(f"latent_decode B {b} H {h} r {r} p {p} group "
                         f"{group} q {'bf16' if exact else 'float32'} "
                         f"dense_len {dense_len} {name}: {e} of {top} "
                         f"(tolerance {LATENT_TOL} of max |output|)")
                err, rel = max(err, e), max(rel, e / top)
            if dense_len == 0 and not (bool((got[0] == -1e30).all())
                                       and bool((got[1] == 0).all())
                                       and bool((got[2] == 0).all())):
                fail("latent_decode: an empty tier must give m -1e30, l 0, "
                     "acc 0")
            cases.append(f"B {b} H {h} r {r} p {p} group {group} q "
                         f"{'bf16' if exact else 'float32'} dense_len "
                         f"{dense_len}")
    sass_hmma = tiered.LATENT_LIB.sass_count("HMMA")
    if sass_hmma == 0:
        fail("latent_decode: the built library issues no HMMA (mma.sync)")
    t = tier(SERVE_BATCH, s_dense, 16, 512, 64, GROUP)
    timed_len = SERVE_PROMPT

    def call():
        return tiered.latent_tier_partial(*t, timed_len, group=GROUP,
                                          scale=scale)
    bnd, by, f32_bnd = latent_bound(SERVE_BATCH, 16, 512, 64, timed_len)
    tokens, splits = tiered.latent_split_plan(timed_len, SERVE_BATCH)
    line = {"name": "latent_decode", "route": "cuda",
            "source": ("src/repro_torch/kernels/tiered_attention/csrc/"
                       "latent_decode.cu"),
            "replaces": "src/repro/kernels/tiered_attention/kernel.py:37",
            "max_abs_err": err, "max_err_over_max_abs": rel,
            "ms": kernel_ms(launcher, call), "device_ms": graph_ms(call),
            "plain_ms": time_ms(lambda: latent_tier_partial_ref(
                *t, timed_len, GROUP, scale), PLAIN_TIMED),
            "bound_ms": bnd, "bound_by": by,
            "bound_ms_cuda_cores": f32_bnd, "library_ms": None,
            "timed_shape": (f"B {SERVE_BATCH}, H 16, r 512, p 64, group "
                            f"{GROUP}, S {s_dense}, dense_len {timed_len}"),
            "split_tokens": tokens, "blocks": SERVE_BATCH * splits,
            "sass_hmma": sass_hmma}
    emit({"phase": "kernel_vs_plain", "kernel": "latent_decode",
          "cases": cases, "tolerance": f"{LATENT_TOL} of max |output|",
          **line})
    return line


def flash_mla_vs_plain(cuda, randn, launcher) -> dict:
    """`flash_fwd` at MLA's prefill widths (deepseek-v2-lite: B 4, S 2048,
    H = Hkv = 16, q and k 192, v 128, scale 1/sqrt(192)), zero-padded to
    the 256 form, against its plain version (1e-2, bf16); the kernel's
    time, the wrapper's with the padding, and PyTorch's
    `scaled_dot_product_attention` on the unpadded inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.flash_attention.ref import flash_ref
    b, s, h, hd, hd_v = SERVE_BATCH, SERVE_PROMPT, 16, 192, 128
    scale = 1.0 / hd ** 0.5
    q = randn(b, s, h, hd, dtype=torch.bfloat16)
    k = randn(b, s, h, hd, dtype=torch.bfloat16)
    v = randn(b, s, h, hd_v, dtype=torch.bfloat16)
    got = flash.flash_fwd(q, k, v, scale=scale)
    want = flash_ref(q, k, v, chunk=512, scale=scale)
    err = max(_within(f"flash MLA {name}", a.contiguous(), w, 1e-2)
              for name, a, w in zip(("out", "lse"), got, want))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bnd, by = flash_bound(b, s, h, h, hd, 2, hd_v)

    def call():
        return flash.flash_fwd(q, k, v, scale=scale)
    return {"max_abs_err": err,
            "cases": [f"bf16 B{b} S{s} H{h} qk{hd} v{hd_v} padded to 256"],
            "ms": kernel_ms(launcher, call),
            "wrapper_ms": time_ms(call, TIMED),
            "plain_ms": time_ms(lambda: flash_ref(q, k, v, chunk=512,
                                                  scale=scale), PLAIN_TIMED),
            "bound_ms": bnd, "bound_by": by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=scale), TIMED),
            "timed_shape": (f"B {b}, S {s}, H {h}, Hkv {h}, qk {hd}, v "
                            f"{hd_v}, bf16 (kernel at hd 256)")}


def ssd_kernel_vs_plain(cuda) -> dict:
    """Phase 7: `ssd_intra` against its plain version on the card at the
    two models' prefill shapes and the overflow stress case; returns the
    kernel-table fields."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.ssd_scan.ref import intra_chunk_ref

    gen = torch.Generator(device=cuda)
    gen.manual_seed(SERVE_SEED + 7)

    def inputs(bt, nc, q, nh, hd, n, a):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=cuda)
        A = (torch.full((nh,), a, device=cuda) if a is not None
             else -torch.exp(0.3 * randn(nh)))          # A per head
        return (randn(bt, nc, q, nh, hd), F.softplus(randn(bt, nc, q, nh)),
                A, randn(bt, nc, q, n), randn(bt, nc, q, n))

    launcher = _launchers()["ssd_intra"]
    launcher.reset()
    b, nc, q = SERVE_BATCH, SERVE_PROMPT // 256, 256
    shapes = {"mamba2-370m": (b, nc, q, 32, 64, 128, None),
              "zamba2-1.2b": (b, nc, q, 64, 64, 64, None),
              "stress A=-1": (b, nc, q, 32, 64, 128, -1.0)}
    err, rel, cases, timed = 0.0, 0.0, [], {}
    for label, shape in shapes.items():
        ins = inputs(*shape)
        got = ssd.ssd_intra(*ins)
        want = intra_chunk_ref(*ins)
        for name, g, w in zip(("y", "states", "cum"), got, want):
            scale = float(w.abs().max())
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"ssd_intra {label} {name}: {g.dtype}{tuple(g.shape)}"
                     f" vs plain version {w.dtype}{tuple(w.shape)}")
            if not torch.isfinite(g).all():
                fail(f"ssd_intra {label} {name}: non-finite values")
            e = float((g - w).abs().max())
            if e > 2e-5 * scale:
                fail(f"ssd_intra {label} {name}: differs from the plain "
                     f"version by {e} (tolerance 2e-5 of {scale})")
            err, rel = max(err, e), max(rel, e / scale)
        cases.append(f"{label} {shape[:6]}")
        if shape[-1] is None:
            timed[label] = ins
    ms = {k: kernel_ms(launcher, lambda: ssd.ssd_intra(*v))
          for k, v in timed.items()}
    plain = {k: time_ms(lambda: intra_chunk_ref(*v), PLAIN_TIMED)
             for k, v in timed.items()}
    bounds = {k: ssd_intra_bound(*shapes[k][:6]) for k in timed}
    f32_bounds = {k: ssd_intra_bound_f32(*shapes[k][:6])[0] for k in timed}
    hmma = ssd.LIB.sass_count("HMMA")
    if hmma == 0:
        fail("ssd_intra: the built library issues no HMMA (mma.sync)")
    row = {"name": "ssd_intra", "route": "cuda",
           "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_intra.cu",
           "replaces": "src/repro/kernels/ssd_scan/kernel.py:26",
           "max_abs_err": err, "max_err_over_max_abs": rel,
           "ms": ms["mamba2-370m"], "plain_ms": plain["mamba2-370m"],
           "bound_ms": bounds["mamba2-370m"][0],
           "bound_by": bounds["mamba2-370m"][1], "library_ms": None,
           "bound": "3xTF32: 3 x the products' FLOPs on the TF32 tensor "
                    "cores, the element-wise work on the float32 rate",
           "bound_f32_cuda_cores_ms": f32_bounds["mamba2-370m"],
           "hmma_instructions": hmma, **ssd.LIB.ptxas(),
           "library": "none: no single PyTorch call computes the SSD "
                      "intra-chunk contraction",
           "timed_shape": "Bt 4, nc 8, Q 256, nh 32, hd 64, N 128 "
                          "(mamba2-370m's prefill)",
           "zamba2_shape": {"ms": ms["zamba2-1.2b"],
                            "plain_ms": plain["zamba2-1.2b"],
                            "bound_ms": bounds["zamba2-1.2b"][0],
                            "bound_by": bounds["zamba2-1.2b"][1],
                            "bound_f32_cuda_cores_ms":
                                f32_bounds["zamba2-1.2b"]}}
    emit({"phase": "kernel_vs_plain", "kernel": "ssd_intra", "cases": cases,
          "tolerance": "2e-5 of max |output|", **row})
    return row


def plan_trace(policy, spec, prompt, steps, per_tok, chans, state_bytes=0):
    """Closed-form count of a policy's plan with integers (`plan_for`):
    the dense_len each decode step attends over, the repack events, the
    final watermarks, the metrics added in float32 in the engine's order,
    and their exact integer totals. `per_tok` is the rows a token writes
    in each channel (tiered slots x batch x KV heads); `chans` the
    channels' (width, quantized): GQA's K and V, MLA's latent and its raw
    RoPE key. `state_bytes`, a hybrid model's Mamba2 state bytes, are
    added after each step's tick, as the engine adds them."""
    import numpy as np
    from repro_torch.core.tiercache.layout import split_for_prefill
    from repro_torch.core.tiercache.manager import METRICS
    from repro_torch.core.tiercache.policy import plan_for
    plan = plan_for(policy, spec.hot_window, spec.page_tokens)
    # bytes a token of every channel: bf16 in the hot tier (and a raw
    # channel's dense region), packed int4 and bf16 scales in the dense
    # tier
    hot_b = sum(per_tok * f * 2 for f, _ in chans)
    dense_b = sum(per_tok * ((f // 2 + (f // spec.group) * 2) if quant
                             else f * 2) for f, quant in chans)
    dense, _ = split_for_prefill(prompt, spec)
    fill = dense > 0
    total = prompt
    f32 = {k: np.float32(0.0) for k in METRICS}
    exact = {k: 0 for k in METRICS}
    attended, events = [], []

    def add(key, value):
        f32[key] = np.float32(f32[key] + np.float32(float(value)))
        exact[key] += value

    for _ in range(steps):
        attended.append(dense)
        for pages, staged, sync in ((plan.bg_pages, False, False),
                                    (plan.sync_pages, plan.staging_copy,
                                     True)):
            if not pages:
                continue
            t = pages * spec.page_tokens
            due = (total - dense + 1 > spec.hot_window if sync
                   else total - dense >= t + 1)
            if not due:
                continue
            events.append(t)
            add("hbm_read_bytes", t * hot_b)
            add("hbm_write_bytes", t * dense_b * (2 if staged else 1))
            add("repack_tokens", t)
            if sync:
                add("stall_events", 1)
            dense += t
        add("hbm_write_bytes", hot_b)
        add("appended_tokens", 1)
        if state_bytes:
            add("hbm_write_bytes", state_bytes)
        total += 1
    return {"attended": attended, "events": events, "fill": fill,
            "dense_len": dense, "total_len": total, "metrics": f32,
            "exact": exact}


def ssm_trace(prompt, steps, state_bytes):
    """The same count for an ssm model: no tiers, both watermarks one up
    a step, the state bytes and one appended token a step."""
    import numpy as np
    from repro_torch.core.tiercache.manager import METRICS
    f32 = {k: np.float32(0.0) for k in METRICS}
    exact = {k: 0 for k in METRICS}
    for _ in range(steps):
        for key, value in (("hbm_write_bytes", state_bytes),
                           ("appended_tokens", 1)):
            f32[key] = np.float32(f32[key] + np.float32(float(value)))
            exact[key] += value
    return {"attended": [], "events": [], "fill": False,
            "dense_len": prompt + steps, "total_len": prompt + steps,
            "metrics": f32, "exact": exact}


@contextlib.contextmanager
def _replaced(*swaps):
    """Set module attributes, (module, name, value), for the duration."""
    saved = [(module, name, getattr(module, name)) for module, name, _ in swaps]
    for module, name, value in swaps:
        setattr(module, name, value)
    try:
        yield
    finally:
        for module, name, value in saved:
            setattr(module, name, value)


def plain_versions(keep=None):
    """The serving path with each kernel's wrapper replaced by its plain
    version (`ref.py`) on the same tensors on the card: phases 6 and 8's
    comparison run. The path looks each wrapper up on its module at every
    call, so this reaches every call site. `keep` names one kernel (a key
    of `_launchers()`) whose wrapper stays in place: the diagnostic of
    `scripts/serve_kernel_isolation.py`."""
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.ips_repack import ops as repack
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.tiered_attention import ops as tiered
    swaps = {
        "flash_fwd": (flash, "flash_fwd", flash.ref.flash_ref),
        "ips_repack": (repack, "quantize_into",
                       repack.ref.quantize_into_ref),
        "tiered_decode": (tiered, "dense_tier_partial",
                          tiered.ref.dense_tier_partial_ref),
        "latent_decode": (tiered, "latent_tier_partial",
                          tiered.ref.latent_tier_partial_ref),
        "ssd_intra": (ssd, "ssd_intra", ssd.ref.intra_chunk_ref)}
    if keep is not None and keep not in swaps:
        raise ValueError(f"plain_versions: no kernel {keep!r}")
    return _replaced(*[swap for name, swap in swaps.items() if name != keep])


class Routes:
    """MoE routes teacher-forced as tokens are. `record()` keeps each
    `_routing` call's (weights, experts) of the kernel run, on the card;
    `replay()` hands them back, in order, to the runs compared with it
    (the plain run, the floor run, a planted fault), each named by `use`
    and read from its own cursor, with each run's own aux loss. Routing is
    discontinuous: a near-tie between the k-th and (k+1)-th expert that
    rounds the other way in the plain run would move its logits for no
    fault of a kernel. `flips[name]` counts the (layer, token) top-k sets
    that run's own routing would have chosen otherwise (a tensor on the
    card, read once at the end)."""

    def __init__(self, layers: int):
        self.layers = layers            # MoE layers: `_routing` calls a pass
        self.log, self.cursor, self.flips, self.sets = [], {}, {}, {}
        self.own, self.stats = {}, {}
        self.active = None

    def record(self):
        from repro_torch.models import moe
        orig = moe._routing
        for kept in (self.log, self.cursor, self.flips, self.sets,
                     self.own, self.stats):
            kept.clear()

        def route(router_w, x, m):
            out = orig(router_w, x, m)
            self.log.append(out[:2])
            return out
        return _replaced((moe, "_routing", route))

    def use(self, name):
        import torch
        self.active = name
        if name not in self.cursor:
            self.cursor[name] = 0
            self.sets[name] = 0
            self.flips[name] = torch.zeros(self.layers, dtype=torch.int64,
                                           device=self.log[0][1].device)
            # gap sums at the flipped sets and over all, the flipped sets'
            # largest gap, and the floor run's flips against the plain
            # run's own routes
            self.stats[name] = torch.zeros(4, dtype=torch.float64,
                                           device=self.log[0][1].device)
            self.own[name] = []

    def replay(self):
        import torch
        from repro_torch.models import moe
        orig = moe._routing

        def route(router_w, x, m):
            weights, experts, aux = orig(router_w, x, m)
            name = self.active
            at = self.cursor[name]
            w, e = self.log[at]
            self.cursor[name] += 1
            own = torch.sort(experts, dim=-1).values
            differ = (own != torch.sort(e, dim=-1).values).any(dim=-1)
            self.flips[name][at % self.layers] += differ.sum()
            self.sets[name] += differ.numel()
            # the router's gap p_k - p_(k+1) of this run's own softmax
            probs = torch.softmax(x.to(torch.float32) @ router_w, dim=-1)
            top = torch.topk(probs, m.top_k + 1, dim=-1).values
            gap = (top[..., -2] - top[..., -1]).double()
            st = self.stats[name]
            st[0] += (gap * differ).sum()
            st[1] += gap.sum()
            st[2] = torch.maximum(st[2], (gap * differ).max())
            if name == "plain":
                self.own[name].append(own)
            elif name == "floor" and at < len(self.own.get("plain", ())):
                st[3] += (own != self.own["plain"][at]).any(dim=-1).sum()
            return w, e, aux
        return _replaced((moe, "_routing", route))

    def counts(self):
        out = {}
        for name, flips in self.flips.items():
            per_layer = flips.tolist()
            flipped = sum(per_layer)
            st = self.stats[name].tolist()
            out[name] = {
                "flipped": flipped, "sets": self.sets[name],
                "calls": self.cursor[name],
                "flipped_per_layer": per_layer,
                "gap_mean_flipped": st[0] / flipped if flipped else None,
                "gap_max_flipped": st[2] if flipped else None,
                "gap_mean_all": st[1] / max(self.sets[name], 1)}
            if name == "floor":
                out[name]["flipped_vs_plain_own"] = int(st[3])
        return out


def planted_faults(arch):
    """Wrong forms of a kernel's call on `arch`'s path, each still
    launching the kernel, to read how far the logits checks see a wrong
    kernel: (name, context, whether the max-based check or the path
    check must catch it — True at some check, "every step" the max-based
    check at every decode step —, whether the rms check must catch it at
    every step).

    gemma-2b, the tiered call: dropping the last 256 tokens (a page) of
    the dense tier must be caught by the max-based check at some step,
    and dropping 256 or 32 by the rms check at every step. The float32
    dequantized form in place of the bf16 one is read only: on an H100 it
    stays under both limits (PERF.md §6), and phase 5 holds the kernel to
    its plain version at 2e-4. deepseek-v2-lite, the latent call:
    dropping 32 dense tokens must be caught by the rms check at every
    step. arctic's one layer, the tiered call: dropping 32 must be caught
    by the max-based check at every step (its floor is 0, so no rms
    check). whisper-tiny, the cross tier's call: dropping its last 256
    of 1500 frames must be caught by the rms check at every step.
    llava-next-34b, yi-6b and minitron-4b, the tiered call: dropping 32
    dense tokens must be caught by the rms check at every step.
    mamba2-370m, the `ssd_intra` call: a strict causal mask (the kernel's
    y less its diagonal term C_i.B_i dt_i x_i, L's diagonal being
    exp(0) = 1) must be caught."""
    import torch
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.tiered_attention import ops as tiered
    if arch == "mamba2-370m":
        intra = ssd.ssd_intra

        def strict(x, dt, A, B, C):
            y, states, cum = intra(x, dt, A, B, C)
            diag = (C * B).sum(-1)[..., None] * dt         # (Bt, nc, Q, nh)
            return y - diag[..., None] * x, states, cum

        return [("ssd_intra strict mask (L's diagonal dropped)",
                 _replaced((ssd, "ssd_intra", strict)), True, False)]

    def short(name, drop):
        kernel = getattr(tiered, name)

        def call(*args, **kw):
            args = list(args)
            args[5] = max(int(args[5]) - drop, 0)     # dense_len
            return kernel(*args, **kw)
        return _replaced((tiered, name, call))

    if arch == "deepseek-v2-lite-16b":
        return [("latent dense_len - 32",
                 short("latent_tier_partial", 32), False, True)]
    if arch == "whisper-tiny":
        # the cross tier's call (its tier is F frames long, all dense):
        # the last CROSS_DROP frames dropped, the self tier's call kept
        kernel = tiered.dense_tier_partial

        def cross_short(*args, **kw):
            args = list(args)
            if args[1].shape[1] == int(args[5]) == WHISPER_FRAMES:
                args[5] = WHISPER_FRAMES - CROSS_DROP
            return kernel(*args, **kw)
        return [(f"cross tier dense_len - {CROSS_DROP}",
                 _replaced((tiered, "dense_tier_partial", cross_short)),
                 True, True)]
    if arch == "arctic-480b":
        return [("tiered dense_len - 32",
                 short("dense_tier_partial", 32), "every step", False)]
    if arch in ("llava-next-34b", "yi-6b", "minitron-4b"):
        return [("tiered dense_len - 32",
                 short("dense_tier_partial", 32), False, True)]
    if arch != "gemma-2b":
        return []
    kernel = tiered.dense_tier_partial

    def float32_form(*args, **kw):
        return kernel(*args, **{**kw, "deq_dtype": torch.float32})

    return [(f"tiered dense_len - {drop}",
             short("dense_tier_partial", drop), drop == 256, True)
            for drop in (32, 256)] + [
            ("tiered float32 dequant",
             _replaced((tiered, "dense_tier_partial", float32_form)), False,
             False)]


WHISPER_FRAMES = 1500           # whisper-tiny's encoder frames
LLAVA_PATCHES = 576             # llava-next-34b's patch embeddings
CROSS_DROP = 256                # frames the planted cross-tier fault drops


def shadow_intra(log):
    """`ssd_intra` as the path calls it, each call held to its plain
    version on the same inputs: appends max |kernel - plain| / max
    |plain| over the three outputs per call. Wraps whatever the module
    holds when entered (the kernel, or a planted fault)."""
    from repro_torch.kernels.ssd_scan import ops as ssd
    kernel = ssd.ssd_intra

    def call(*args):
        got = kernel(*args)
        want = ssd.ref.intra_chunk_ref(*args)
        log.append(max(float((g - w).abs().max())
                       / max(float(w.abs().max()), 1e-30)
                       for g, w in zip(got, want)))
        return got

    return _replaced((ssd, "ssd_intra", call))


def _rms(x) -> float:
    return float(x.double().square().mean().sqrt())


def _decode_run(bundle, params, cache, prefill_logits, spec, policy,
                steps, inputs=None, forced=False, out=None):
    """`steps` decode steps from a prefill's cache: greedy, writing each
    step's input token into `inputs` (steps, B, 1) when it is given, or
    teacher-forced on `inputs`. Writes each step's logits into `out` when
    it is given. Returns (cache, metrics, last token)."""
    import torch
    from repro_torch.core.tiercache.manager import zero_metrics
    from repro_torch.serve.engine import make_serve_step
    step = make_serve_step(bundle, spec, policy)
    metrics = zero_metrics()
    token = torch.argmax(prefill_logits, -1).to(torch.int32)[:, None]
    for i in range(steps):
        if forced:
            token = inputs[i]
        elif inputs is not None:
            inputs[i] = token
        token, logits, cache, metrics = step(params, cache, token, metrics)
        if out is not None:
            out[i] = logits
    return cache, metrics, token


def _path_setup(cfg, b, prompt):
    """What a path implies, per policy: the tiered slots, the rows a token
    writes in each and the channels' widths, the decode kernel, the
    Mamba2 state bytes a decode step writes, and the Mamba2 layers."""
    from repro_torch.models.hybrid import hybrid_structure
    s = cfg.ssm
    setup = {"slots": 0, "hkv": cfg.num_kv_heads, "hd": cfg.head_dim,
             "mamba_layers": 0, "state_bytes": 0, "decode_kernel": None}
    if s is not None:
        d_xc = s.d_inner(cfg.d_model) + 2 * s.d_state
        nh = s.num_heads(cfg.d_model)
        per_layer = (b * (s.d_conv - 1) * d_xc * 2
                     + b * nh * s.head_dim * s.d_state * 4)
        setup["mamba_layers"] = cfg.num_layers
        setup["intra_shape"] = (b, prompt // min(s.chunk_size, prompt),
                                min(s.chunk_size, prompt), nh, s.head_dim,
                                s.d_state)
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        setup["slots"] = cfg.num_layers
    elif cfg.family == "hybrid":
        n_macro, _ = hybrid_structure(cfg)
        setup["slots"] = n_macro
        # the engine counts the macro layers' states, not the tail's
        setup["state_bytes"] = n_macro * cfg.hybrid.attn_every * per_layer
    else:
        setup["state_bytes"] = cfg.num_layers * per_layer
    if cfg.mla is not None:
        m = cfg.mla
        setup.update(decode_kernel="latent_decode",
                     per_tok=setup["slots"] * b,
                     chans=((m.kv_lora_rank, True),
                            (m.qk_rope_head_dim, False)),
                     quant_feat=m.kv_lora_rank, quant_rows=b,
                     flash_hd=(m.qk_nope_head_dim + m.qk_rope_head_dim,
                               m.v_head_dim), flash_hkv=cfg.num_heads)
    elif setup["slots"]:
        hkv, hd = cfg.num_kv_heads, cfg.head_dim
        setup.update(decode_kernel="tiered_decode",
                     per_tok=setup["slots"] * b * hkv,
                     chans=((hd, True), (hd, True)), quant_feat=hd,
                     quant_rows=2 * b * hkv, flash_hd=(hd, hd),
                     flash_hkv=hkv)
    # a VLM's patches take positions before the prompt; an
    # encoder-decoder's decoder reads its static cross tier of `frames`
    # once a layer a step (the tiered kernel's dense partial) and
    # quantizes it once at the prefill (one repack launch)
    setup["prefix"] = cfg.vlm.num_patches if cfg.vlm is not None else 0
    setup["frames"] = (cfg.encdec.encoder_seq_len if cfg.encdec is not None
                       else 0)
    return setup


def serve_main_path(cuda, arch, layers=None, policies=None,
                    keep=None) -> dict:
    """Phases 6, 8 and 9: `arch` (cut to `layers` when given) served under
    each of `policies` (names; by default every policy, or one for an ssm
    model, which has no KV cache), with the kernels and then
    teacher-forced with the plain versions (all but `keep`'s, a
    diagnostic: see `plain_versions`), a MoE model's routes too; returns
    each kernel's main-path launches, time and bound."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.tiercache.manager import METRICS, zero_metrics
    from repro_torch.core.tiercache.policy import Policy
    from repro_torch.models.model_zoo import build_model, make_train_batch
    from repro_torch.serve.engine import make_serve_step, make_tier_spec

    t_path = time.perf_counter()
    cfg = get_arch(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    b, prompt, steps = SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS
    setup = _path_setup(cfg, b, prompt)
    slots, hkv, hd = setup["slots"], setup["hkv"], setup["hd"]
    # cache positions at the prefill: a VLM's patches, then the prompt
    positions, frames = setup["prefix"] + prompt, setup["frames"]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(SERVE_SEED)
    t0 = time.perf_counter()
    model = build_model(cfg, device=cuda)
    # the floor: the plain versions under another summation order
    floor_cfg = cfg if cfg.ssm is None else dataclasses.replace(
        cfg, ssm=dataclasses.replace(cfg.ssm, chunk_size=FLOOR_SSD_CHUNK))
    floor_model = build_model(floor_cfg, attn_chunk=FLOOR_ATTN_CHUNK,
                              device=cuda)
    params = model.init(gen)
    batch = make_train_batch(cfg, b, prompt, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    launchers = _launchers()
    totals = {name: {"launches": 0, "ms": 0.0, "bound_ms": 0.0}
              for name in launchers}
    flash_b = (flash_bound(b, positions, cfg.num_heads, setup["flash_hkv"],
                           setup["flash_hd"][0], 2, setup["flash_hd"][1])[0]
               if slots else 0.0)
    intra_b = (ssd_intra_bound(*setup["intra_shape"])[0]
               if setup["mamba_layers"] else 0.0)
    inputs = torch.empty((steps, b, 1), dtype=torch.int32, device=cuda)
    logits = torch.empty((steps, b, cfg.vocab_size), dtype=torch.float32,
                         device=cuda)
    plain_logits = torch.empty_like(logits)
    faults = []
    policies = ([Policy[name] for name in policies] if policies else
                list(Policy) if slots else [Policy.IPS_AGC])
    fault_policy = Policy.IPS if slots else Policy.IPS_AGC
    routes = (Routes(cfg.num_layers - min(cfg.moe.first_k_dense,
                                          cfg.num_layers))
              if cfg.moe is not None else None)

    def replayed(name):
        """The routes of the kernel run, for the run `name`."""
        if routes is None:
            return contextlib.nullcontext()
        routes.use(name)
        return routes.replay()

    def use(name):
        if routes is not None:
            routes.use(name)
    path_check = None
    # warm-up: one prefill with the kernels (the counts are zeroed before
    # each counted run), so that no timed prefill pays the process's
    # first cuBLAS and allocator set-up
    model.prefill(params, batch, make_tier_spec(model, positions + steps,
                                                policies[0]))
    torch.cuda.synchronize()

    def run(**kw):
        cache, prefill_logits = model.prefill(params, batch, spec)
        return (prefill_logits,) + _decode_run(
            model, params, cache, prefill_logits, spec, policy, steps, **kw)

    for policy in policies:
        spec = make_tier_spec(model, positions + steps, policy)
        if slots:
            trace = plan_trace(policy, spec, positions, steps,
                               setup["per_tok"], setup["chans"],
                               setup["state_bytes"])
        else:
            trace = ssm_trace(prompt, steps, setup["state_bytes"])
        expect = {"flash_fwd": slots if cfg.family != "ssm" else 0,
                  "tiered_decode": 0, "latent_decode": 0,
                  "ips_repack": int(trace["fill"]) + len(trace["events"])
                  + int(frames > 0),
                  "ssd_intra": setup["mamba_layers"]}
        if slots:
            # the cross tier's partial beside the self tier's
            expect[setup["decode_kernel"]] = (slots * steps
                                              * (2 if frames else 1))

        # -- with the kernels, each launch timed by CUDA events, the path
        #    on the host clock; the counts zeroed just before and read just
        #    after. First one event-timed prefill and decode step, not
        #    counted, that pay whatever the first events around their
        #    launches and each kernel's first launch at the path's shapes
        #    cost (one run read 257 ms for yi-6b's first counted
        #    `tiered_decode`, four others under 1 ms); their slowest
        #    launch is recorded beside the counted run's
        for launcher in launchers.values():
            launcher.reset()
            launcher.record = True
        _decode_run(model, params, *model.prefill(params, batch, spec),
                    spec, policy, 1)
        warm_max = {n: max(v) for n, v in
                    ((n, launcher.ms()) for n, launcher in launchers.items())
                    if v}
        torch.cuda.reset_peak_memory_stats(cuda)
        for launcher in launchers.values():
            launcher.reset()
        torch.cuda.synchronize()
        with (routes.record() if routes is not None
              else contextlib.nullcontext()):
            t1 = time.perf_counter()
            cache, prefill_logits = model.prefill(params, batch, spec)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t1) * 1e3
            t1 = time.perf_counter()
            cache, metrics, token = _decode_run(
                model, params, cache, prefill_logits, spec, policy, steps,
                inputs=inputs, out=logits)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t1
        counts = {n: launcher.launches for n, launcher in launchers.items()}
        per_launch = {n: launcher.ms() for n, launcher in launchers.items()}
        for launcher in launchers.values():
            launcher.record = False
            launcher.reset()
        peak = torch.cuda.max_memory_allocated(cuda)
        if counts != expect:
            fail(f"{arch} {policy.name}: launches {counts}, the path "
                 f"implies {expect}")
        fast_metrics = metrics
        if cache["dense_len"] != trace["dense_len"] or (
                cache["total_len"] != trace["total_len"]):
            fail(f"{arch} {policy.name}: watermarks ({cache['dense_len']}, "
                 f"{cache['total_len']}), the plan's "
                 f"({trace['dense_len']}, {trace['total_len']})")
        for k in METRICS:
            if np.float32(fast_metrics[k]) != trace["metrics"][k]:
                fail(f"{arch} {policy.name}: {k} = {fast_metrics[k]!r}, the "
                     f"plan counts {trace['metrics'][k]!r}")
        del cache

        # -- teacher-forced with the plain versions (no kernel launches),
        #    beside the floor; a MoE model's routes replayed from the
        #    kernel run
        with plain_versions(keep), replayed("plain"):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cache, plain_prefill = model.prefill(params, batch, spec)
            torch.cuda.synchronize()
            plain_prefill_ms = (time.perf_counter() - t1) * 1e3
            use("floor")
            cache_f, floor_prefill = floor_model.prefill(params, batch, spec)
            err, floor, prefill_limit = _logits_close(
                f"{arch} {policy.name} prefill", prefill_logits,
                plain_prefill, floor_prefill)
            step = make_serve_step(model, spec, policy)
            step_f = make_serve_step(floor_model, spec, policy)
            metrics, metrics_f = zero_metrics(), zero_metrics()
            agree, limits, floor_rms, err_rms = 0, [], [], 0.0
            step_rms = []
            over_limit = over_floor_rms = 0.0
            for i in range(steps):
                use("plain")
                nxt, lg, cache, metrics = step(params, cache, inputs[i],
                                               metrics)
                use("floor")
                _, lg_f, cache_f, metrics_f = step_f(params, cache_f,
                                                     inputs[i], metrics_f)
                e, f, lim = _logits_close(f"{arch} {policy.name} step {i}",
                                          logits[i], lg, lg_f)
                err, floor = max(err, e), max(floor, f)
                limits.append(lim)
                floor_rms.append(_rms(lg_f - lg))
                step_rms.append(_rms(logits[i] - lg))
                err_rms = max(err_rms, step_rms[-1])
                over_limit = max(over_limit, e / lim)
                over_floor_rms = max(over_floor_rms, step_rms[-1]
                                     / max(floor_rms[-1], 1e-30))
                plain_logits[i] = lg
                chosen = inputs[i + 1] if i + 1 < steps else token
                agree += int((nxt == chosen).sum())
            torch.cuda.synchronize()
        del cache_f
        # the rms check needs a floor that reaches the decode steps: a
        # one-layer model's cache is projected before its prefill
        # attention, so the floor's other softmax chunking never reaches a
        # step, and its floor must be exactly 0 at every one of them (the
        # path is deterministic); that path is held to the max-based check
        # alone, its planted fault at every step
        zero_floor = sum(f == 0.0 for f in floor_rms)
        rms_checked = zero_floor == 0
        if not rms_checked and (cfg.num_layers > 1 or zero_floor < steps):
            fail(f"{arch} {policy.name}: the floor is 0 at {zero_floor} of "
                 f"{steps} decode steps ({cfg.num_layers} layers): the rms "
                 "check needs it nonzero at every step, a one-layer path "
                 "0 at every step")
        if not rms_checked:
            over_floor_rms = None
        elif over_floor_rms > RMS_LIMIT:
            fail(f"{arch} {policy.name}: rms of the logits' error is "
                 f"{over_floor_rms} x the floor's at some step (limit "
                 f"{RMS_LIMIT})")
        if any(launcher.launches for name, launcher in launchers.items()
               if name != keep):
            fail(f"{arch} {policy.name}: the plain run launched a kernel")
        if (cache["dense_len"], cache["total_len"]) != (
                trace["dense_len"], trace["total_len"]):
            fail(f"{arch} {policy.name}: the plain run's watermarks differ")
        for k in METRICS:
            if np.float32(metrics[k]) != np.float32(fast_metrics[k]):
                fail(f"{arch} {policy.name}: plain run's {k} differs")
        del cache

        # -- the path check: a prefill with each `ssd_intra` call held to
        #    its plain version on the path's own inputs, 2e-5 of max
        #    |output| (once: the prefill is the same under every policy)
        if setup["mamba_layers"] and path_check is None:
            log = []
            with shadow_intra(log):
                model.prefill(params, batch, spec)
            torch.cuda.synchronize()
            if len(log) != setup["mamba_layers"] or max(log) > 2e-5:
                fail(f"{arch}: ssd_intra on the path differs from its plain "
                     f"version: {len(log)} calls, worst {max(log)} of max "
                     "|output| (tolerance 2e-5)")
            path_check = {"calls": len(log),
                          "max_err_over_max_abs": max(log)}
            emit({"phase": "serve_path_check", "arch": arch,
                  "kernel": "ssd_intra", **path_check})

        # -- planted faults (gemma under IPS: a dense tier at every step;
        #    mamba2 in its one run), teacher-forced on the same tokens,
        #    against the plain run's logits: the prefill's, then each
        #    step's; an `ssd_intra` fault also meets the path check
        if policy is fault_policy:
            for name, context, must_catch, rms_must in planted_faults(arch):
                log = []
                with context, replayed(f"fault: {name}"):
                    if setup["mamba_layers"]:
                        with shadow_intra(log):
                            model.prefill(params, batch, spec)
                    fault_prefill = run(inputs=inputs, forced=True,
                                        out=logits)[0]
                path_caught = bool(log) and max(log) > 2e-5
                prefill_err = float((fault_prefill - plain_prefill).abs().max())
                errs = [float((logits[i] - plain_logits[i]).abs().max())
                        for i in range(steps)]
                rms = [_rms(logits[i] - plain_logits[i])
                       for i in range(steps)]
                steps_caught = sum(e > lim for e, lim in zip(errs, limits))
                caught = steps_caught + int(prefill_err > prefill_limit)
                rms_ratio = ([r / max(f, 1e-30) for r, f in zip(rms, floor_rms)]
                             if rms_checked else None)
                rms_caught = (sum(r > RMS_LIMIT for r in rms_ratio)
                              if rms_checked else None)
                faults.append({"fault": name, "arch": arch,
                               "policy": policy.name,
                               "logits_max_abs_err": max(errs + [prefill_err]),
                               "prefill_err_over_limit": prefill_err
                               / prefill_limit,
                               "max_err_over_limit": max(
                                   e / lim for e, lim in zip(errs, limits)),
                               "min_err_over_limit": min(
                                   e / lim for e, lim in zip(errs, limits)),
                               "logits_rms_err": max(rms),
                               "min_rms_over_floor_rms":
                                   min(rms_ratio) if rms_checked else None,
                               "rms_over_floor_rms": rms_ratio,
                               "rms_limit": RMS_LIMIT,
                               "rms_caught_steps": rms_caught,
                               "rms_must_catch": rms_must,
                               "checks_caught": caught,
                               "steps_caught": steps_caught,
                               "checks": steps + 1,
                               "path_check_err_over_max_abs":
                                   max(log) if log else None,
                               "caught_by_path_check": path_caught,
                               "must_catch": must_catch})
                emit({"phase": "serve_planted_fault", **faults[-1]})
                if rms_must and rms_caught < steps:
                    fail(f"planted fault '{name}' passed the rms check at "
                         f"{steps - rms_caught} of {steps} steps (ratios "
                         f"{min(rms_ratio)}-{max(rms_ratio)}, limit "
                         f"{RMS_LIMIT})")
                if must_catch == "every step" and steps_caught < steps:
                    fail(f"planted fault '{name}' passed the max-based "
                         f"logits check at {steps - steps_caught} of {steps}"
                         " steps")
                if must_catch and not (caught or path_caught):
                    fail(f"planted fault '{name}' passed the logits check "
                         f"(max error {max(errs + [prefill_err])}, limits "
                         f"{min(limits + [prefill_limit])}-"
                         f"{max(limits + [prefill_limit])}) and the path "
                         "check")

        # rows per repack launch (GQA's K and V together, MLA's latent):
        # the prefill fill's w0 tokens, then each event's
        per_row = slots * setup.get("quant_rows", 0)
        rows = ([per_row * trace["attended"][0]] if trace["fill"] else []
                ) + [per_row * t for t in trace["events"]]
        if frames:
            # the cross tier's K and V, every layer, in one launch
            rows.append(per_row * frames)
        g = cfg.num_heads // hkv if slots else 1
        decode_b = [
            (latent_bound(b, cfg.num_heads, cfg.mla.kv_lora_rank,
                          cfg.mla.qk_rope_head_dim, d)[0]
             if cfg.mla is not None else tiered_bound(b, hkv, g, hd, d)[0])
            for d in trace["attended"] for _ in range(slots)]
        if frames:
            decode_b += [tiered_bound(b, hkv, g, hd, frames)[0]] * (
                slots * steps)
        bounds = {"flash_fwd": [flash_b] * expect["flash_fwd"],
                  "tiered_decode": decode_b if expect["tiered_decode"]
                  else [],
                  "latent_decode": decode_b if expect["latent_decode"]
                  else [],
                  "ips_repack": [repack_bound(r, setup.get("quant_feat", 1))[0]
                                 for r in rows],
                  "ssd_intra": [intra_b] * expect["ssd_intra"]}
        for name in launchers:
            totals[name]["launches"] += counts[name]
            totals[name]["ms"] += sum(per_launch[name])
            totals[name]["bound_ms"] += sum(bounds[name])
        emit({"phase": "serve", "arch": arch, "policy": policy.name,
              "batch": b, "prompt": prompt, "prefix": setup["prefix"],
              "frames": frames, "steps": steps,
              "tier_spec": {"s_max": spec.s_max,
                            "hot_window": spec.hot_window,
                            "page_tokens": spec.page_tokens,
                            "group": spec.group},
              "prefill_ms": prefill_ms,
              "decode_ms_per_step": decode_s * 1e3 / steps,
              "decode_tok_s": b * steps / decode_s,
              "peak_memory_gib": peak / 2 ** 30,
              "launches": counts,
              "kernel_ms_per_launch": {
                  n: sum(v) / len(v) if v else None
                  for n, v in per_launch.items()},
              "kernel_bound_ms_per_launch": {
                  n: sum(v) / len(v) if v else None
                  for n, v in bounds.items()},
              "kernel_ms_total": {n: sum(v) for n, v in per_launch.items()},
              "kernel_max_launch_ms": {
                  n: max(v) if v else None for n, v in per_launch.items()},
              "warm_max_launch_ms": warm_max,
              "plain_prefill_ms": plain_prefill_ms,
              "logits_max_abs_err": err,
              "logits_floor_max_abs": floor,
              "logits_rms_err": err_rms,
              "logits_floor_rms": max(floor_rms),
              "logits_floor_rms_min": min(floor_rms),
              "logits_floor_rms_zero_steps": zero_floor,
              "logits_floor_rms_per_step": floor_rms,
              "logits_rms_err_per_step": step_rms,
              "logits_max_err_over_limit": over_limit,
              "logits_max_rms_over_floor_rms": over_floor_rms,
              "logits_rms_checked": rms_checked,
              "logits_rms_limit": RMS_LIMIT,
              "logits_limit_min": min(limits + [prefill_limit]),
              "logits_tolerance": (f"{LOGITS_TOL} of max |logit|, or twice "
                                   "the floor"),
              "argmax_agree": agree / (b * steps),
              "distinct_tokens_per_row": [
                  int(torch.unique(inputs[:, r]).numel()) for r in range(b)],
              "dense_len": trace["dense_len"],
              "total_len": trace["total_len"],
              "repack_events": len(trace["events"]),
              "metrics": {k: float(fast_metrics[k]) for k in METRICS},
              "metrics_exact_integers": trace["exact"],
              # the (layer, token) top-k sets the compared runs' own
              # routing would have chosen otherwise (their routes are the
              # kernel run's)
              "route_flips": routes.counts() if routes is not None
              else None})
    emit({"phase": "serve_summary", "arch": arch, "init_s": init_s,
          "layers": cfg.num_layers, "positions": positions,
          "wall_s": time.perf_counter() - t_path,
          "main_path": totals, "planted_faults": faults,
          "path_check": path_check})
    return {"kernels": {n: {"launches": v["launches"],
                            "main_path_ms": v["ms"],
                            "main_path_bound_ms": v["bound_ms"]}
                        for n, v in totals.items()}}


def _cells_equal(label, got: dict, ref: dict) -> float:
    """Every cell of `got` (keyed as the reference's results) against the
    reference's: the counters, WA, the lifetime and host-tier columns
    exact, the mean latency and the two bucket means within rtol 1e-6;
    returns the worst relative difference of those three."""
    import numpy as np
    worst = 0.0
    for key, cell in got.items():
        want = ref.get(key)
        if want is None:
            fail(f"{label}: {key} has no reference result")
        if set(cell) != set(want):
            fail(f"{label}: {key} reports {sorted(set(cell) ^ set(want))} "
                 "on one side only")
        for metric in EXACT + WEAR_EXACT + HOST_EXACT:
            if metric in want and cell[metric] != want[metric]:
                fail(f"{label}: {key}: {metric} = {cell[metric]!r}, "
                     f"reference {want[metric]!r}")
        for metric in WEAR_CLOSE:
            if metric not in want:
                continue
            a, b = cell[metric], want[metric]
            if not np.isfinite(a) or abs(a - b) > 1e-6 * abs(b):
                fail(f"{label}: {key}: {metric} = {a!r}, reference {b!r}")
            worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
    return worst


def sweep_path(cfg, n_logical, cuda, grid, ref, cache_dir, smem_cycles,
               max_sm_mhz) -> dict:
    """One sweep path: `grid` through `run_sweep` on the card, its traces
    through the port's trace cache at `cache_dir`, with the kernel's
    count zeroed just before and read just after (one launch); every
    cell held to `ref` (the reference's results by key)."""
    import numpy as np
    import torch
    from repro_torch.kernels.ssd_step import ops as ssd_step
    from repro_torch.sweep.grid import named_grid
    from repro_torch.sweep.report import policy_geomeans
    from repro_torch.sweep.runner import run_sweep
    from repro_torch.workloads import TraceCache

    from repro_torch.kernels.host_tier import ops as host_tier

    points = named_grid(grid)
    host_cells = sum(pt.hostcache is not None for pt in points)
    cache = TraceCache(root=cache_dir)
    timings = []
    ssd_step.reset()
    host_tier.reset()
    t1 = time.perf_counter()
    results = run_sweep(cfg, points, device=cuda, timings=timings,
                        trace_cache=cache)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = ssd_step.launches
    tier_launches = host_tier.launches
    if launches != 1:
        fail(f"{grid}: the sweep launched the kernel {launches} times for "
             f"{len(timings)} groups; a grid is one launch")
    if tier_launches != (1 if host_cells else 0):
        fail(f"{grid}: the sweep launched host_tier {tier_launches} times "
             f"for {host_cells} host cells; a grid's host cells are one "
             "launch")
    worst = _cells_equal(grid, {pt.key: results[pt] for pt in points}, ref)
    grid_ms = timings[0]["launch_ms"]
    if grid_ms is None or any(g["kernel_ms"] is None for g in timings):
        fail(f"{grid}: the launch's events or block timers are missing")
    padded_ops = sum(g["cells"] * g["t_len"] for g in timings)
    wear_cells = sum(g["cells"] for g in timings if g["endurance"])
    # a host cell's device pass steps K sub-ops a trace op
    grid_bytes = sum(stream_bytes(g["cells"], g["t_scan"] * g["k_slots"],
                                  False, cfg.num_planes, n_logical)
                     for g in timings)
    grid_bound, grid_by = bound_ms(
        grid_bytes, sum(g["cells"] * g["t_scan"] * g["k_slots"]
                        * (CORE_F32_OPS + (WEAR_F32_OPS if g["endurance"]
                                           else 0)) for g in timings))
    # the chain bound: the longest cell's stepped ops (scanned and pads
    # replayed), one dependent shared-memory load each, at the card's
    # highest SM clock
    longest = max(timings, key=lambda g: g["max_cell_ops"])
    chain_bound = longest["max_cell_ops"] * smem_cycles / (max_sm_mhz * 1e3)
    line = {
        "grid": grid, "cells": len(points), "groups": len(timings),
        "launches": launches, "wear_cells": wear_cells,
        "host_cells": host_cells, "tier_launches": tier_launches,
        "tier_ms": timings[0]["tier_ms"],
        "matches_reference": True, "close_max_rel_err": worst,
        "wall_s": wall, "ops_per_s": padded_ops / wall,
        "kernel_ms": grid_ms, "bound_ms": grid_bound, "bound_by": grid_by,
        "chain_bound_ms": chain_bound,
        "longest_cell_ops": longest["max_cell_ops"],
        "longest_cell_ns_per_op": longest["ns_per_op"],
        "longest_cell_cycles_per_op":
            longest["cycles"] / longest["max_cell_ops"],
        "trace_cache": cache.stats(),
        "group_kernel_ms": [{"group": f"{g['composition']}/{g['mode']}",
                             "endurance": g["endurance"],
                             "hostcache": g["hostcache"],
                             "cells": g["cells"], "t_len": g["t_len"],
                             "t_scan": g["t_scan"],
                             "kernel_ms": g["kernel_ms"],
                             "max_cell_ops": g["max_cell_ops"],
                             "ns_per_op": g["ns_per_op"],
                             "cycles_per_op": g["cycles"]
                             / max(g["max_cell_ops"], 1),
                             "wait_share": g["wait_cycles"]
                             / max(g["cycles"], 1)}
                            for g in timings]}
    geomeans = {f"{m}/{p}": {k: v[k] for k in ("mean_write_latency_ms",
                                               "wa_paper") if k in v}
                for (m, p), v in sorted(policy_geomeans(results).items())}
    line["geomeans"] = geomeans
    return {"line": line, "geomeans": geomeans, "results": results,
            "trace_cache": cache.stats()}


# the counters a summary reports unflushed (a daily cell's flush adds to
# `migrations` and `erases`), by summary key and counter index
SUMMARY_COUNTERS = {"host_pages": 0, "slc_writes": 1, "tlc_writes": 2,
                    "reprogram_host": 3, "reprogram_agc": 4,
                    "reprogram_trad": 5, "migrations": 6, "erases": 7,
                    "conflict_ms": 9}


def _digest(x) -> str:
    import hashlib
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(x, np.float32)).tobytes()).hexdigest()


def telemetry_path(cfg, cuda, cache_dir, off) -> dict:
    """The telemetry phase: the uncut paper grid through `run_sweep` with
    the probe on at 1024 ops a window, ONE launch (the count zeroed just
    before, read just after). Every cell's summary equal to the probe-off
    run of phase 3 (`off`); its counter windows summing exactly to its
    counters (those a summary reports unflushed); its windows equal to
    the reference's recorded run (tests/data/torch_reference_timelines.
    json): the sha256 of the exact series, the float64 totals of the
    three float sums, the cliff dict, and hm_0's float series in full."""
    import numpy as np
    import torch
    from repro_torch.kernels.ssd_step import ops as ssd_step
    from repro_torch.sweep.grid import named_grid
    from repro_torch.sweep.runner import run_sweep
    from repro_torch.telemetry import Tracer, series
    from repro_torch.workloads import TraceCache

    with open(os.path.join(ROOT, "tests", "data",
                           "torch_reference_timelines.json")) as f:
        ref = json.load(f)
    if ref["window_ops"] != TIMELINE_WINDOW:
        fail("the recorded timelines use another window size")
    points = named_grid("paper")
    timelines, timings, tracer = {}, [], Tracer()
    ssd_step.reset()
    t1 = time.perf_counter()
    with tracer.activate():
        results = run_sweep(cfg, points, device=cuda, timings=timings,
                            trace_cache=TraceCache(root=cache_dir),
                            timeline_ops=TIMELINE_WINDOW,
                            timelines=timelines)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = ssd_step.launches
    if launches != 1:
        fail(f"telemetry: the paper grid with the probe launched the "
             f"kernel {launches} times; a grid is one launch")
    float_exact, worst, cliffs = True, 0.0, 0
    for pt in points:
        key = pt.key
        if results[pt] != off[pt]:
            fail(f"telemetry: {key}'s summary with the probe on differs "
                 "from the probe-off run")
        tl = timelines[pt]
        ctr_sum = tl["ctr"].astype(np.float64).sum(axis=0).astype(
            np.float32)
        for name, i in SUMMARY_COUNTERS.items():
            if name in ("migrations", "erases") and pt.mode == "daily":
                ok = ctr_sum[i] <= results[pt][name]
            else:
                ok = float(ctr_sum[i]) == results[pt][name]
            if not ok:
                fail(f"telemetry: {key}: the windows' {name} sum "
                     f"{float(ctr_sum[i])!r}, the counter "
                     f"{results[pt][name]!r}")
        want = ref["cells"][key]
        if tl["ops"].shape[0] != want["n_windows"]:
            fail(f"telemetry: {key}: {tl['ops'].shape[0]} windows, the "
                 f"reference {want['n_windows']}")
        for name, digest in want["sha256"].items():
            if _digest(tl[name]) != digest:
                fail(f"telemetry: {key}: {name} differs from the "
                     "reference's windows")
        floats = {name: tl[name] for name in ref["floats"]}
        for name, total in want["totals"].items():
            got = float(np.sum(floats[name].astype(np.float64)))
            float_exact = float_exact and got == total
            worst = max(worst, abs(got - total) / max(abs(total), 1e-30))
            if abs(got - total) > 1e-6 * abs(total):
                fail(f"telemetry: {key}: {name} totals {got!r}, the "
                     f"reference {total!r}")
        for name, vals in want.get("series", {}).items():
            got = floats[name].astype(np.float64)
            vals = np.asarray(vals, np.float64)
            float_exact = float_exact and np.array_equal(got, vals)
            if not np.allclose(got, vals, rtol=1e-6, atol=0.0):
                fail(f"telemetry: {key}: the {name} series differs from "
                     "the reference's")
        cliff = series(tl)["cliff"]
        if cliff != want["cliff"]:
            fail(f"telemetry: {key}: cliff {cliff}, the reference "
                 f"{want['cliff']}")
        cliffs += bool(cliff["detected"])
    head_bytes = sum(g["cells"] * g["t_scan"] * 8 for g in timings)
    return {"grid": "paper", "cells": len(points), "launches": launches,
            "window_ops": TIMELINE_WINDOW, "wall_s": wall,
            "launch_ms": timings[0]["launch_ms"],
            "matches_reference": True, "float_sums_exact": float_exact,
            "float_sums_max_rel_err": worst, "cliffs": cliffs,
            "head_bytes": head_bytes,
            "cliff_cells": sorted(pt.key for pt in points
                                  if series(timelines[pt])["cliff"]
                                  ["detected"]),
            "span_totals": tracer.totals()}


def profile_path(cfg, cuda, cache_dir) -> dict:
    """`profiling.profile` around `run_sweep` on the `quick` grid (uncut,
    probe on): the capture must start (no `profile.unavailable` event)
    and its Chrome trace hold the `ssd_step` kernel's device events."""
    from repro_torch.sweep.grid import named_grid
    from repro_torch.sweep.runner import run_sweep
    from repro_torch.telemetry import Tracer, profiling
    from repro_torch.workloads import TraceCache

    trace_dir = os.path.join(ROOT, "build", "profile")
    shutil.rmtree(trace_dir, ignore_errors=True)
    tracer = Tracer()
    with tracer.activate():
        with profiling.profile(trace_dir) as running:
            run_sweep(cfg, named_grid("quick"), device=cuda,
                      trace_cache=TraceCache(root=cache_dir),
                      timeline_ops=TIMELINE_WINDOW)
        profiling.emit_device_events("profile_path")
    events = [s["name"] for s in tracer.to_json()]
    if "profile.unavailable" in events or not running:
        fail(f"profile: torch.profiler did not start: {tracer.to_json()}")
    if "profile.stop" not in events:
        fail(f"profile: the capture did not stop cleanly: {events}")
    path = os.path.join(trace_dir, profiling.TRACE_FILE)
    with open(path) as f:
        trace = json.load(f)
    kernel_events = [e for e in trace.get("traceEvents", [])
                     if "ssd_fleet_kernel" in str(e.get("name", ""))
                     and e.get("cat") == "kernel"]
    if not kernel_events:
        fail("profile: the Chrome trace holds no ssd_step kernel event")
    stats = [s["args"] for s in tracer.to_json()
             if s["name"] == "device.stats"]
    return {"trace_bytes": os.path.getsize(path),
            "kernel_events": len(kernel_events),
            "kernel_us": sum(float(e.get("dur", 0)) for e in kernel_events),
            "device_stats": stats[0] if stats else None}


def cli_timeline_run(cache_dir) -> dict:
    """The CLI end to end, as a user runs it on the card: `python -m
    repro_torch.sweep.cli --grid paper --timeline --timeline-overhead-check`
    into `build/cli_timeline`; it must write `BENCH_torch_timeline.json`,
    `BENCH_torch_sweep_paper.json` and a `BENCH_torch_history.json`
    record, and no reference artifact name."""
    out_dir = os.path.join(ROOT, "build", "cli_timeline")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_TORCH_TRACE_CACHE_DIR=cache_dir)
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.sweep.cli", "--grid", "paper",
         "--timeline", "--timeline-overhead-check", "--out-dir", out_dir],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t1
    with open(os.path.join(out_dir, "stdout.txt"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        fail(f"the CLI run exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    files = sorted(n for n in os.listdir(out_dir) if n.endswith(".json"))
    want = ["BENCH_torch_history.json", "BENCH_torch_sweep_paper.json",
            "BENCH_torch_timeline.json"]
    if files != want:
        fail(f"the CLI run wrote {files}, not {want}")
    with open(os.path.join(out_dir, "BENCH_torch_timeline.json")) as f:
        doc = json.load(f)
    with open(os.path.join(out_dir, "BENCH_torch_history.json")) as f:
        hist = json.load(f)["records"]
    cliff_line = [ln for ln in proc.stdout.splitlines()
                  if ln.strip().startswith("cliffs:")]
    if len(hist) != 1 or doc["n_cells"] != 102 or not cliff_line:
        fail("the CLI run's timeline or history record is missing")
    return {"wall_s": wall, "n_cells": doc["n_cells"],
            "n_cliffs": doc["n_cliffs"], "cliff_line": cliff_line[0].strip(),
            "overhead": doc.get("overhead"), "launches": doc["launches"],
            "history_config": hist[0]["config"],
            "history_ops_per_s": hist[0]["ops_per_s"]}


def host_tier_vs_plain(cfg, n_logical, cuda, smem_cycles,
                       max_sm_mhz) -> dict:
    """The host_tier kernel against its plain version on the same inputs:
    the hostcache grid's four host-cache specs x both modes on
    flush_burst, each cut to HOST_TIER_OPS trace ops, and one cell of a
    geometry whose state takes the device-memory path (1024 x 8), in ONE
    launch; every output (the sub-op streams, the absorbed flags, the
    host rows and the final HCState) bit for bit. The launch is timed by
    CUDA events after an untimed one, beside the plain version's time on
    the CPU and the bounds: bytes (the traces read, the sub-op streams,
    flags and rows written, the state in and out, each once), operations
    and the chain (per trace op 3 + flush_per_op dependent shared-memory
    loads at the card's highest clock)."""
    import numpy as np
    import torch
    from repro_torch.core.ssd.fleet import stack_ops
    from repro_torch.core.ssd.policies.state import map_state
    from repro_torch.hostcache.model import H_CTR, as_hc_params, init_hc
    from repro_torch.hostcache.spec import HostCacheSpec
    from repro_torch.kernels.host_tier import ops as host_tier
    from repro_torch.kernels.host_tier import ref as tier_ref
    from repro_torch.sweep.grid import named_grid
    from repro_torch.workloads import build_ops, truncate_trace

    specs = list(dict.fromkeys(pt.hostcache for pt in named_grid("hostcache")
                               if pt.hostcache is not None))
    cells = [(spec, mode) for spec in specs for mode in ("daily", "bursty")]
    cells.append((HostCacheSpec(sets=1024, ways=8, flush_per_op=4), "daily"))
    jobs = []
    for spec, mode in cells:
        tr = truncate_trace(build_ops("flush_burst", n_logical, mode=mode,
                                      capacity_pages=cfg.total_pages),
                            HOST_TIER_OPS)
        jobs.append(tier_ref.TierJob(
            spec, stack_ops([tr], device="cpu"),
            map_state(lambda x: x[None], as_hc_params(spec, "cpu")),
            init_hc(spec, 1, device="cpu"), mode == "bursty", rows=True))
    on_card = [j._replace(ops={k: v.to(cuda) for k, v in j.ops.items()},
                          params=map_state(lambda x: x.to(cuda), j.params),
                          hc0=map_state(lambda x: x.to(cuda), j.hc0))
               for j in jobs]
    if not any(host_tier._array_bytes(sp) > host_tier.SMEM_BUDGET
               for sp, _ in cells):
        fail("host_tier: no cell took the device-memory path")
    host_tier.reset()
    host_tier.tier_pass(on_card)                   # untimed: clocks up
    got = host_tier.tier_pass(on_card)
    torch.cuda.synchronize()
    start, end = host_tier.events[-1]
    ms = start.elapsed_time(end)
    if host_tier.launches != 2:
        fail(f"host_tier: {host_tier.launches} launches for two passes")
    t1 = time.perf_counter()
    want = [tier_ref.tier_pass_ref(j) for j in jobs]
    plain_ms = (time.perf_counter() - t1) * 1e3
    err = 0.0
    for (spec, mode), g, w in zip(cells, got, want):
        label = f"host_tier {spec.tag}/{mode}"
        for k in w.sub:
            if not torch.equal(g.sub[k].cpu(), w.sub[k]):
                fail(f"{label}: sub-op {k} differs from the plain version")
        if not (torch.equal(g.absorbed.cpu(), w.absorbed)
                and torch.equal(g.rows.cpu(), w.rows)):
            fail(f"{label}: absorbed flags or host rows differ")
        for f in w.hc._fields:
            x, y = getattr(g.hc, f), getattr(w.hc, f)
            if (x is None) != (y is None) or (
                    y is not None and not torch.equal(x.cpu(), y)):
                fail(f"{label}: final {f} differs from the plain version")
        err = max(err, float((g.rows.cpu() - w.rows).abs().max()))
    t_ops = sum(j.ops["lba"].numel() for j in jobs)
    moved = sum(j.ops["lba"].numel() * (12 + 1 + 12 * (2 + j.spec.flush_per_op)
                                        + 4 * (len(H_CTR) + 1))
                + 2 * 4 * host_tier.state_words(j.spec.sets, j.spec.ways)
                for j in jobs)
    ops = sum(j.ops["lba"].numel() * (
        TIER_BASE_OPS + 2 * j.spec.ways
        + 3 * j.spec.ways * j.spec.flush_per_op) for j in jobs)
    bound, by = bound_ms(moved, ops)
    chain = max(j.ops["lba"].numel() * (3 + j.spec.flush_per_op)
                for j in jobs) * smem_cycles / (max_sm_mhz * 1e3)
    fired = sum(w.hc.hctr.sum(0) for w in want)
    return {"cells": len(jobs), "ops_per_cell": HOST_TIER_OPS,
            "specs": [f"{sp.tag}/{m}" for sp, m in cells], "equal": True,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "chain_bound_ms": chain,
            "trace_ops": t_ops, "ns_per_op_longest": ms * 1e6 / HOST_TIER_OPS,
            "host_counters": dict(zip(H_CTR, fired.tolist()))}


def host_tier_split(cfg, n_logical, cuda, smem_cycles, max_sm_mhz) -> dict:
    """Where a trace op's cycles go in the `host_tier` kernel at the
    hostcache grid's size: its four host-cache specs x both modes on
    flush_burst uncut (131,072 trace ops a cell, flush_per_op 2), one
    launch timed by CUDA events after an untimed one, then one launch of
    the probe form (clock64 stamps around each part of an op: the wait on
    its inputs, the set scan with the row's update, the promotion filter,
    the flush scan, the stores). Per part the cycles an op of the cell
    with the most cycles; beside the launch, two chain bounds at the
    card's highest clock: the serial form's (per trace op 3 +
    flush_per_op dependent shared-memory loads) and the warp form's (per
    trace op one shared-memory load, whose round takes the set's and the
    flush sets' ways together, and the store the next op's load waits
    on; the ballot and min-reduce between them are not counted, so it is
    a floor)."""
    import torch
    from repro_torch.core.ssd.fleet import stack_ops
    from repro_torch.core.ssd.policies.state import map_state
    from repro_torch.hostcache.model import as_hc_params, init_hc
    from repro_torch.kernels.host_tier import ops as host_tier
    from repro_torch.kernels.host_tier import ref as tier_ref
    from repro_torch.sweep.grid import named_grid
    from repro_torch.workloads import build_ops

    specs = list(dict.fromkeys(pt.hostcache for pt in named_grid("hostcache")
                               if pt.hostcache is not None))
    jobs, labels = [], []
    for spec in specs:
        for mode in ("daily", "bursty"):
            tr = build_ops("flush_burst", n_logical, mode=mode,
                           capacity_pages=cfg.total_pages)
            jobs.append(tier_ref.TierJob(
                spec, stack_ops([tr], device=cuda),
                map_state(lambda x: x[None].to(cuda),
                          as_hc_params(spec, "cpu")),
                init_hc(spec, 1, device=cuda), mode == "bursty", rows=False))
            labels.append(f"{spec.tag}/{mode}")
    host_tier.tier_pass(jobs)                      # untimed: clocks up
    host_tier.reset()
    host_tier.tier_pass(jobs)
    torch.cuda.synchronize()
    start, end = host_tier.events[-1]
    ms = start.elapsed_time(end)
    cols = {c: i for i, c in enumerate(host_tier.PROBE_COLUMNS)}
    probe = torch.zeros((sum(j.ops["lba"].shape[0] for j in jobs),
                         len(cols)), dtype=torch.int64, device=cuda)
    host_tier.tier_pass(jobs, probe=probe)
    torch.cuda.synchronize()
    start, end = host_tier.events[-1]
    probe_ms = start.elapsed_time(end)
    rows = probe.cpu().numpy()
    c = int(rows[:, cols["cycles"]].argmax())
    n = int(rows[c, cols["ops"]])
    t_len = max(j.ops["lba"].shape[1] for j in jobs)
    f_max = max(j.spec.flush_per_op for j in jobs)
    chain = t_len * (3 + f_max) * smem_cycles / (max_sm_mhz * 1e3)
    warp_chain = t_len * 2 * smem_cycles / (max_sm_mhz * 1e3)
    return {"cells": len(jobs), "specs": labels, "ops_per_cell": t_len,
            "ms": ms, "ns_per_op": ms * 1e6 / t_len,
            "chain_bound_ms": chain, "warp_chain_bound_ms": warp_chain,
            "probe_ms": probe_ms,
            "probe_cell": labels[c],
            "cycles_per_op": float(rows[c, cols["cycles"]]) / n,
            "split_cycles_per_op": {
                part: float(rows[c, cols[part]]) / n
                for part in ("wait", "scan", "promote", "flush", "store")}}


def cli_hostcache_run(cache_dir, recorded) -> dict:
    """`python -m repro_torch.sweep.cli --traces hm_0 --hostcache
    mode=wb,flush=idle` on the card, into `build/cli_hostcache`: every
    cell of its artifact equal to the reference CLI's recorded run
    (`tests/data/torch_reference_sweeps.json`, `cli_hostcache`), the
    host-tier table written, one launch of each kernel."""
    out_dir = os.path.join(ROOT, "build", "cli_hostcache")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_TORCH_TRACE_CACHE_DIR=cache_dir)
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.sweep.cli", "--traces", "hm_0",
         "--hostcache", "mode=wb,flush=idle", "--no-history", "--out-dir",
         out_dir], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t1
    with open(os.path.join(out_dir, "stdout.txt"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        fail(f"the --hostcache CLI run exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    with open(os.path.join(out_dir, "BENCH_torch_sweep_custom.json")) as f:
        doc = json.load(f)
    want = recorded["results"]
    if set(doc["results"]) != set(want) or "hostcache" not in doc:
        fail("the --hostcache CLI run's cells or host-tier table differ "
             "from the reference's")
    worst = 0.0
    for key, w in want.items():
        g = doc["results"][key]
        for m, v in w.items():
            if m in WEAR_CLOSE:
                if abs(g[m] - v) > 1e-6 * abs(v):
                    fail(f"--hostcache CLI: {key}: {m} = {g[m]!r}, "
                         f"reference {v!r}")
                worst = max(worst, abs(g[m] - v) / max(abs(v), 1e-30))
            elif g[m] != v:
                fail(f"--hostcache CLI: {key}: {m} = {g[m]!r}, reference "
                     f"{v!r}")
    if doc["launches"] != 1:
        fail(f"the --hostcache CLI run took {doc['launches']} ssd_step "
             "launches")
    return {"wall_s": wall, "cells": len(want), "matches_reference": True,
            "close_max_rel_err": worst, "launches": doc["launches"],
            "hostcache": doc["hostcache"]}


MATRIX_CELLS = 66               # 11 traces x 2 modes x 3 policies
BENCH_STEP_ARGS = ("--traces", "hm_0,proj_0", "--max-ops", "32768")


def matrix_path(cfg, cuda, bench, cache_dir) -> dict:
    """The evaluation matrix and its benchmarks, as a user calls them:
    `driver.eval_matrix` (66 cells, the fleet's ONE `ssd_step` launch)
    cell for cell against the matching cells of `BENCH_sweep_paper.json`;
    `runner.bench_fleet_vs_loop` on the same cells (the fleet, then a loop
    of `driver.eval_cell`, one launch a cell), both walls and the
    speedup, its fleet held to the same cells and its loop to its fleet
    (`max_rel_diff` within the mean latency's bar); then
    `scripts/bench_step_torch.py` (per-op, compressed and packed paths,
    one cell at a time) into `build/bench_step`, its document checked by
    the port's `check_step_throughput` with no speedup gate (the
    reference's 3x floor was set on another machine)."""
    import torch
    from repro_torch.core.ssd.driver import eval_matrix
    from repro_torch.kernels.ssd_step import ops as ssd_step
    from repro_torch.sweep.runner import bench_fleet_vs_loop
    from repro_torch.sweep.store import check_step_throughput
    ref = bench["results"]
    os.environ["REPRO_TORCH_TRACE_CACHE_DIR"] = cache_dir

    n0 = ssd_step.launches
    t1 = time.perf_counter()
    got = eval_matrix(cfg, device=cuda)
    torch.cuda.synchronize()
    matrix_wall = time.perf_counter() - t1
    matrix_launches = ssd_step.launches - n0
    if len(got) != MATRIX_CELLS or matrix_launches != 1:
        fail(f"eval_matrix: {len(got)} cells in {matrix_launches} "
             f"launch(es), not {MATRIX_CELLS} in one")
    worst = _cells_equal("eval_matrix", got, ref)

    n0 = ssd_step.launches
    fleet_vs_loop = bench_fleet_vs_loop(cfg, device=cuda)
    bench_launches = ssd_step.launches - n0
    if bench_launches != 1 + MATRIX_CELLS:
        fail(f"bench_fleet_vs_loop launched the kernel {bench_launches} "
             f"times, not once for the fleet and once a cell")
    worst = max(worst, _cells_equal("bench_fleet_vs_loop",
                                    fleet_vs_loop["results"], ref))
    if fleet_vs_loop["max_rel_diff"] > 1e-6:
        fail(f"bench_fleet_vs_loop: the loop differs from the fleet by "
             f"{fleet_vs_loop['max_rel_diff']} (bar 1e-6)")
    print(f"bench: loop {fleet_vs_loop['loop_wall_s']:.3f} s -> fleet "
          f"{fleet_vs_loop['fleet_wall_s']:.3f} s (speedup "
          f"{fleet_vs_loop['speedup']:.2f}x, max rel diff "
          f"{fleet_vs_loop['max_rel_diff']:.2e})", flush=True)

    out_dir = os.path.join(ROOT, "build", "bench_step")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "bench_step_torch.py"),
         *BENCH_STEP_ARGS, "--out-dir", out_dir], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    step_wall = time.perf_counter() - t1
    with open(os.path.join(out_dir, "stdout.txt"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        fail(f"bench_step_torch.py exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    files = sorted(n for n in os.listdir(out_dir) if n.endswith(".json"))
    if files != ["BENCH_torch_history.json",
                 "BENCH_torch_step_throughput.json"]:
        fail(f"bench_step_torch.py wrote {files}")
    with open(os.path.join(out_dir, "BENCH_torch_step_throughput.json")) as f:
        step = check_step_throughput(json.load(f))
    gm = step["geomean_speedup"]
    print(f"bench_step: geomean speedup compressed {gm['compressed']:.2f}x, "
          f"packed {gm['packed']:.2f}x", flush=True)
    return {"eval_matrix": {"cells": len(got), "wall_s": matrix_wall,
                            "launches": matrix_launches,
                            "mean_latency_worst_rel": worst},
            "fleet_vs_loop": {k: v for k, v in fleet_vs_loop.items()
                              if k != "results"},
            "fleet_vs_loop_launches": bench_launches,
            "bench_step": {"args": list(BENCH_STEP_ARGS), "wall_s": step_wall,
                           "geomean_speedup": gm, "traces": step["traces"]},
            "launches": matrix_launches + bench_launches}


def check_search(doc, ref, launches) -> float:
    """A `--search quick` document held to the reference's recorded run:
    the survivors, the Pareto front, each round's candidates, survivors,
    cells, groups and best, the scenario search's history and flip equal,
    the scores within rtol 1e-6, no new kernel specialisation after the
    first round, one ssd_step launch a round and a scenario evaluation.
    Returns the worst relative difference of the scores."""

    def close(a, b):
        return (a is None and b is None) or (
            a is not None and b is not None and abs(a - b) <= 1e-6 * abs(b))

    if doc["survivors"] != ref["survivors"]:
        fail(f"search: survivors {doc['survivors']} != {ref['survivors']}")
    if [f["label"] for f in doc["front"]] != [f["label"]
                                              for f in ref["front"]]:
        fail("search: the Pareto front differs from the reference's")
    worst = 0.0
    for label, want in ref["scores"].items():
        got = doc["scores"].get(label)
        if got is None or got["n"] != want["n"]:
            fail(f"search: {label} scored on other cells")
        for m in ("lat", "waf", "tbw"):
            if not close(got[m], want[m]):
                fail(f"search: {label} {m} = {got[m]!r}, reference "
                     f"{want[m]!r}")
            if want[m]:
                worst = max(worst, abs(got[m] - want[m]) / abs(want[m]))
    keys = ("round", "traces", "modes", "max_ops", "candidates",
            "survivors", "cells", "groups", "best")
    if [{k: r[k] for k in keys} for r in doc["rounds"]] != \
            [{k: r[k] for k in keys} for r in ref["rounds"]]:
        fail("search: the rounds differ from the reference's")
    if any(r["compiles"] for r in doc["rounds"][1:]):
        fail("search: a later round needed new kernel specialisations")
    scen, want = doc["scenario_search"], ref["scenario_search"]
    if scen["history"] != want["history"] or \
            scen["flipped"] != want["flipped"] or \
            not close(scen["best_ratio"], want["best_ratio"]):
        fail("search: the scenario search differs from the reference's")
    from repro_torch.search import SCHEDULES
    sc_iters = SCHEDULES["quick"]["scenario"]["iters"]
    if launches != len(doc["rounds"]) + 2 + sc_iters:
        fail(f"search: {launches} ssd_step launches for "
             f"{len(doc['rounds'])} rounds and {2 + sc_iters} scenario "
             "evaluations")
    return worst


def search_path(cache_dir) -> dict:
    """The search engine at the `quick` budget on the card, through the
    CLI's entry (`--search quick`, in this process, the kernels' counts
    zeroed just before and read just after): the survivors, the Pareto
    front, each round's candidates, survivors, cells, groups and best,
    and the scenario search's history and flip equal to the reference's
    recorded run (`tests/data/torch_reference_search.json`), the scores
    within rtol 1e-6; the rounds after the first need no new kernel
    specialisation; one ssd_step launch a round and a scenario
    evaluation."""
    from repro_torch.kernels.host_tier import ops as host_tier
    from repro_torch.kernels.ssd_step import ops as ssd_step
    from repro_torch.sweep.cli import main as cli_main

    with open(os.path.join(ROOT, "tests", "data",
                           "torch_reference_search.json")) as f:
        ref = json.load(f)
    out_dir = os.path.join(ROOT, "build", "cli_search")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.environ["REPRO_TORCH_TRACE_CACHE_DIR"] = cache_dir
    ssd_step.reset()
    host_tier.reset()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = cli_main(["--search", "quick", "--no-history", "--out-dir",
                       out_dir])
    wall = time.perf_counter() - t1
    if rc != 0:
        fail(f"--search quick exited {rc}")
    launches = ssd_step.launches
    with open(os.path.join(out_dir, "BENCH_torch_search.json")) as f:
        doc = json.load(f)
    worst = check_search(doc, ref, launches)
    scen = doc["scenario_search"]
    return {"wall_s": wall, "launches": launches,
            "tier_launches": host_tier.launches,
            "rounds": [{k: r[k] for k in ("round", "candidates",
                                          "survivors", "cells", "groups",
                                          "compiles", "wall_s")}
                       for r in doc["rounds"]],
            "scenario_wall_s": scen["wall_s"],
            "front": [f["label"] for f in doc["front"]],
            "matches_reference": True, "close_max_rel_err": worst,
            "specialisations": doc["specialisations"]}


# ---------------------------------------------------------------------------
# training (phase 12)
# ---------------------------------------------------------------------------

TRAIN_ARCH, TRAIN_SSM_ARCH = "gemma-2b", "mamba2-370m"
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_STEPS, TRAIN_SSM_STEPS = 10, 3
TRAIN_SEED = 0
KEYS_DROPPED = 32               # the planted flash fault: the last keys
LSE_RAISE = math.log(1.01)      # the planted lse fault, out left as it is
CKPT_SEQ = 256                  # the checkpoint round trip (gemma reduced)


def flash_bwd_bound(b, s, h, hkv, hd, itemsize):
    """The flash backward's least time: q, k, v, out (float32), dout
    (float32) and lse read once, dq, dk, dv written once; its five
    products (the scores again, dP, dV, dQ, dK) over the causal half at
    the inputs' type."""
    moved = ((b * s * h * hd + 2 * b * s * hkv * hd) * itemsize * 2
             + 2 * b * h * s * hd * 4 + b * h * s * 4)
    ops = 5 * 2 * b * h * s * s * hd // 2
    return bound_ms(moved, ops, BF16_OPS_PER_S if itemsize == 2
                    else F32_OPS_PER_S)


def train_flops(cfg, b, s) -> dict:
    """Model FLOPs of one step: 6 N tokens (N the parameters, the tied
    unembedding's product among them) plus the causal attention's two
    products, forward and backward (3x the forward); and what remat's
    recomputed forward adds (2 N tokens plus the attention's forward)."""
    tokens = b * s
    n = cfg.param_count()
    attn_fwd = 0
    if cfg.num_heads and cfg.family != "ssm":
        attn_fwd = (cfg.num_layers * 2 * 2 * b * cfg.num_heads
                    * cfg.head_dim * s * (s + 1) // 2)
    return {"model": 6 * n * tokens + 3 * attn_fwd,
            "recompute": 2 * n * tokens + attn_fwd,
            "params": n, "tokens": tokens}


def _leaf_names(params) -> list:
    """Each leaf's "/"-joined path, in `tree_leaves` order."""
    from repro_torch.checkpoint.ckpt import flatten
    return sorted(flatten(params))


def _loss_grads(bundle, params, batch):
    import torch
    from repro_torch.optim.adamw import tree_leaves
    loss, _ = bundle.loss(params, batch)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return float(loss.detach()), grads


def _sq_diffs(a, b, names):
    """Per leaf: the sum of squares of a - b, and for the leaves stacked
    over the layers (under layers/ or first_dense/) the sums per layer
    (float64 (L,))."""
    out = []
    for x, y, name in zip(a, b, names):
        d = (x.float() - y.float()).square()
        if name.split("/")[0] in ("layers", "first_dense"):
            out.append(d.reshape(d.shape[0], -1).sum(1).double().cpu())
        else:
            out.append(d.sum().double().reshape(1).cpu())
    return out


def _ratio(err, floor):
    if floor > 0:
        return math.sqrt(err / floor)
    return 0.0 if err == 0 else math.inf


def grad_check(run, plain, floor, names) -> dict:
    """rms(g_run - g_plain) / rms(g_floor - g_plain) at most RMS_LIMIT
    over the whole gradient, over each layer's stacked leaves (every
    leaf's slice i) and over each leaf (a stacked leaf over all its
    layers); the loss within LOGITS_TOL (relative) of the plain run's.
    Beside it, read only: each leaf's error projected on the gradient,
    sum((g_run - g_plain) g_plain) / sum(g_plain^2) (a scale error shows
    there), the floor's likewise."""
    err = _sq_diffs(run[1], plain[1], names)
    fl = _sq_diffs(floor[1], plain[1], names)
    whole = _ratio(sum(float(e.sum()) for e in err),
                   sum(float(f.sum()) for f in fl))
    layer_err = sum(e for e, n in zip(err, names)
                    if n.startswith("layers/"))
    layer_fl = sum(f for f, n in zip(fl, names) if n.startswith("layers/"))
    per_layer = [_ratio(e, f) for e, f in zip(layer_err.tolist(),
                                               layer_fl.tolist())]
    per_leaf = {n: _ratio(float(e.sum()), float(f.sum()))
                for n, e, f in zip(names, err, fl)}
    worst = max(per_leaf, key=per_leaf.get)

    def proj(g, p):
        return float((g.float() - p.float()).mul(p.float()).sum()) / max(
            float(p.float().square().sum()), 1e-300)
    grad_sq = sum(float(g.float().square().sum()) for g in plain[1])
    loss_err = abs(run[0] - plain[0]) / abs(plain[0])
    return {"loss": run[0], "loss_rel_err": loss_err,
            "rms_ratio": whole, "rms_ratio_max_layer": max(per_layer),
            "rms_ratio_per_layer": per_layer,
            "rms_ratio_max_leaf": per_leaf[worst], "worst_leaf": worst,
            "rms_ratio_per_leaf": per_leaf,
            "projection_per_leaf": {n: proj(g, p) for n, g, p in zip(
                names, run[1], plain[1])},
            "floor_projection_per_leaf": {n: proj(g, p) for n, g, p in zip(
                names, floor[1], plain[1])},
            # the floor's size against the gradient's own
            "floor_rms_over_grad_rms": math.sqrt(
                sum(float(f.sum()) for f in fl) / max(grad_sq, 1e-300)),
            "passes": (whole <= RMS_LIMIT and max(per_layer) <= RMS_LIMIT
                       and per_leaf[worst] <= RMS_LIMIT
                       and loss_err <= LOGITS_TOL)}


def _masked_flash(keep):
    """A plain flash forward (float32, the causal mask and `keep`: a
    function of the (S, 1) query and (1, S) key positions giving the keys
    each query keeps) with `flash_fwd`'s signature: a planted fault."""
    import torch
    from repro_torch.kernels.flash_attention.ref import NEG_INF, expand_kv

    def forward(q, k, v, *, chunk, scale):
        s = q.shape[1]
        g = q.shape[2] // k.shape[2]
        pos = torch.arange(s, device=q.device)
        mask = (pos[None, :] <= pos[:, None]) & keep(pos[:, None],
                                                     pos[None, :])
        sc = torch.einsum("bqhd,bchd->bhqc", q.float() * scale,
                          expand_kv(k, g).float())
        sc = torch.where(mask, sc, NEG_INF)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(sc - m), 0.0)
        l = p.sum(dim=-1)
        out = torch.einsum("bhqc,bchd->bhqd", p,
                           expand_kv(v, g).float()) / l[..., None]
        return out, m[..., 0] + torch.log(l)
    return forward


def _flash_faults():
    """The planted flash faults of phase 12: (name, a replacement of
    `flash_fwd` as the flash Function calls it, whether the gradient
    check must catch it)."""
    from repro_torch.kernels.flash_attention import ops as flash
    kernel = flash.flash_fwd
    s = TRAIN_SEQ

    def raised_lse(q, k, v, **kw):
        out, lse = kernel(q, k, v, **kw)
        return out, lse + LSE_RAISE

    return [
        # every query loses the KEYS_DROPPED keys before its own (its own
        # kept), as the serving fault drops the dense tier's last tokens
        (f"forward drops each query's last {KEYS_DROPPED} keys (own kept)",
         _replaced((flash, "flash_fwd", _masked_flash(
             lambda i, j: (j < i - KEYS_DROPPED) | (j == i)))), True),
        # the sequence's last keys: only its last KEYS_DROPPED queries
        # see a change (read only: it stays under the floor)
        (f"forward drops the sequence's last {KEYS_DROPPED} keys",
         _replaced((flash, "flash_fwd", _masked_flash(
             lambda i, j: j < s - KEYS_DROPPED))), False),
        ("lse raised by log 1.01, out kept",
         _replaced((flash, "flash_fwd", raised_lse)), True)]


def train_runs(cuda, arch, floor_cfg_of, faults, expect) -> dict:
    """Phase 12 (a) and (c): `arch` at full size, one step's loss and
    gradients from one state on one batch, three times — the kernel run,
    the plain run (each kernel's plain version on the card), the floor
    run (the plain versions under another summation order) — and under
    each planted fault (name, context, whether the check must catch it).
    `expect` is the kernel's launches (launcher, count) in the kernel
    run. Then one train step from the state, with the config's
    optimizer."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_step import (make_train_state,
                                              make_train_step)

    t0 = time.perf_counter()
    cfg = get_arch(arch)
    bundle = build_model(cfg, device=cuda, remat=True)
    floor_bundle = build_model(floor_cfg_of(cfg), attn_chunk=FLOOR_ATTN_CHUNK,
                               device=cuda, remat=True)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(TRAIN_SEED)
    state = make_train_state(bundle, gen)
    batch = make_batch(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                  seed=TRAIN_SEED), 0, device=cuda)
    names = _leaf_names(state.params)
    launcher, want = expect
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    launcher.reset()
    t1 = time.perf_counter()
    kernel = _loss_grads(bundle, state.params, batch)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t1
    if launcher.launches != want:
        fail(f"phase 12 {arch}: the kernel run launched {launcher.kernel} "
             f"{launcher.launches} times, expected {want}")
    launches = launcher.launches
    with plain_versions():
        t1 = time.perf_counter()
        plain = _loss_grads(bundle, state.params, batch)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
        floor = _loss_grads(floor_bundle, state.params, batch)
    check = grad_check(kernel, plain, floor, names)
    emit({"phase": "train_check", "arch": arch, "run": "kernel", **check})
    if not check["passes"]:
        fail(f"phase 12 {arch}: the kernel run's gradients fail the check: "
             f"{check['rms_ratio']} / {check['rms_ratio_max_layer']} of "
             f"{RMS_LIMIT}, loss {check['loss_rel_err']}")
    caught = []
    for name, ctx, must_catch in faults:
        with ctx:
            bad = _loss_grads(bundle, state.params, batch)
        fc = grad_check(bad, plain, floor, names)
        del bad
        emit({"phase": "train_planted_fault", "arch": arch, "fault": name,
              "must_catch": must_catch, **fc})
        if must_catch and fc["passes"]:
            fail(f"phase 12 {arch}: the planted fault {name!r} passed the "
                 "gradient check")
        caught.append({k: fc[k] for k in (
            "rms_ratio", "rms_ratio_max_layer", "rms_ratio_max_leaf",
            "worst_leaf", "loss_rel_err", "passes")}
            | {"fault": name, "must_catch": must_catch})
    del plain, floor, kernel
    # one train step (the config's optimizer: gemma's AdamW) from the state
    _, metrics = make_train_step(bundle)(state, batch)
    gnorm = float(metrics["grad_norm"])
    if not all(math.isfinite(float(v)) for v in metrics.values()):
        fail(f"phase 12 {arch}: the train step is not finite: {metrics}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": cfg.num_layers,
            "params": cfg.param_count(), "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "init_s": init_s, "kernel_run_s": kernel_s,
            "plain_run_s": plain_s, "kernel_launches": launches,
            "check": {k: v for k, v in check.items()
                      if not k.endswith(("_per_layer", "_per_leaf"))},
            "faults_caught": caught, "grad_norm": gnorm,
            "peak_gib": peak, "wall_s": time.perf_counter() - t0}


def launcher_run(cuda, arch, steps, launcher, per_launch_bound,
                 must_fall) -> dict:
    """Phase 12 (b) and the last part of (c): `launch.train.main` at
    `arch`'s full size, `steps` steps of TRAIN_BATCH x TRAIN_SEQ tokens,
    its kernel's launches counted from 0 and event-timed, the flash
    backward's calls too; the loss finite everywhere and, with
    `must_fall`, lower at the last step than at the first."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.launch import train as launch_train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for timed in (launcher, flash.BACKWARD):
        timed.reset()
        timed.record = True
    t0 = time.perf_counter()
    try:
        out = launch_train.main([
            "--arch", arch, "--steps", str(steps), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--device", str(cuda),
            "--seed", str(TRAIN_SEED), "--log-every", "1"])
        launches = launcher.launches
        kernel_ms = launcher.ms()
        bwd_calls = flash.BACKWARD.calls
        bwd_ms = flash.BACKWARD.ms()
    finally:
        for timed in (launcher, flash.BACKWARD):
            timed.record = False
            timed.reset()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = out["losses"]
    if not all(math.isfinite(x) for x in losses):
        fail(f"phase 12 {arch}: a loss is not finite: {losses}")
    if must_fall and not losses[-1] < losses[0]:
        fail(f"phase 12 {arch}: the loss did not fall: {losses}")
    cfg = get_arch(arch)
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    timed = out["step_ms"][2:] if len(out["step_ms"]) > 2 else out["step_ms"]
    step_ms = sorted(timed)[len(timed) // 2]
    step_s = step_ms / 1e3
    torch.cuda.empty_cache()
    return {"arch": arch, "steps": steps, "losses": losses,
            "step_ms": out["step_ms"], "ms_per_step_median": step_ms,
            "tokens_per_s": flops["tokens"] / step_s,
            "model_flops_per_step": flops["model"],
            "recompute_flops_per_step": flops["recompute"],
            "model_flops_share_of_bf16_peak": flops["model"] / step_s
            / BF16_OPS_PER_S,
            "with_recompute_share_of_bf16_peak": (
                flops["model"] + flops["recompute"]) / step_s
            / BF16_OPS_PER_S,
            "peak_gib": peak, "wall_s": wall,
            "kernel": launcher.kernel, "launches": launches,
            "launches_per_step": launches / steps,
            "kernel_ms_per_step": sum(kernel_ms) / steps,
            "kernel_ms_per_launch": sum(kernel_ms) / max(len(kernel_ms), 1),
            "kernel_bound_ms_per_launch": per_launch_bound,
            "main_path_ms": sum(kernel_ms),
            "main_path_bound_ms": per_launch_bound * launches,
            "flash_bwd_calls_per_step": bwd_calls / steps,
            "flash_bwd_ms_per_step": sum(bwd_ms) / steps}


def ckpt_round_trip(cuda) -> dict:
    """Phase 12 (d): gemma-2b reduced on the card, three steps
    uninterrupted against two steps, `save_async`, `restore` into a fresh
    state (drawn from another seed) and the third step: the third loss
    must be equal to the bit."""
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.train_step import (make_train_state,
                                              make_train_step)
    cfg = get_arch(TRAIN_ARCH).reduced()
    bundle = build_model(cfg, device=cuda)
    data = DataConfig(cfg.vocab_size, CKPT_SEQ, TRAIN_BATCH, seed=TRAIN_SEED)
    batches = [make_batch(data, i, device=cuda) for i in range(3)]

    def state_of(seed):
        gen = torch.Generator(device=cuda)
        gen.manual_seed(seed)
        return make_train_state(bundle, gen)

    step = make_train_step(bundle)
    state = state_of(TRAIN_SEED)
    whole = []
    for b in batches:
        state, m = step(state, b)
        whole.append(float(m["loss"]))
    path = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(path, ignore_errors=True)
    state = state_of(TRAIN_SEED)
    cut = []
    for b in batches[:2]:
        state, m = step(state, b)
        cut.append(float(m["loss"]))
    t0 = time.perf_counter()
    ckpt.save_async(path, state, step=2).result()
    save_s = time.perf_counter() - t0
    restored, at = ckpt.restore(path, state_of(TRAIN_SEED + 1))
    equal_state = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(list(ckpt.flatten(state).values())),
        tree_leaves(list(ckpt.flatten(restored).values()))))
    restored, m = step(restored, batches[2])
    resumed = float(m["loss"])
    exact = (resumed == whole[2] and cut == whole[:2] and at == 2
             and equal_state)
    out = {"arch": f"{TRAIN_ARCH} reduced", "seq": CKPT_SEQ,
           "losses_uninterrupted": whole, "losses_before_cut": cut,
           "loss_resumed": resumed, "restored_step": at,
           "state_equal": equal_state, "exact": exact,
           "shard_bytes": os.path.getsize(
               os.path.join(path, "shard_00000.msgpack.zst")),
           "save_s": save_s}
    if not exact:
        fail(f"phase 12: the resumed loss {resumed!r} is not the "
             f"uninterrupted run's {whole[2]!r} (state equal: "
             f"{equal_state})")
    return out


def training_phase(cuda):
    """Phase 12: training on the card. Returns (the training paths'
    kernel counts, as `serve_main_path` returns a serving path's, and
    each kernel's training figures for its row of the kernel table)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.ssd_scan import ops as ssd
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # under remat each layer's kernel launches twice a step: its forward,
    # then its forward again when the backward recomputes the layer
    cfg = get_arch(TRAIN_ARCH)
    gemma = train_runs(cuda, TRAIN_ARCH, lambda cfg: cfg, _flash_faults(),
                       (flash.LAUNCHER, 2 * cfg.num_layers))
    emit({"phase": "train_gemma_check", **gemma})
    shape = (TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads, cfg.num_kv_heads,
             cfg.head_dim, 2)
    f_bound, _ = flash_bound(*shape)
    b_bound, _ = flash_bwd_bound(*shape)
    run = launcher_run(cuda, TRAIN_ARCH, TRAIN_STEPS, flash.LAUNCHER,
                       f_bound, must_fall=True)
    run["flash_bwd_bound_ms_per_call"] = b_bound
    emit({"phase": "train_gemma", **run})

    def ssd_floor(cfg):
        return dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, chunk_size=FLOOR_SSD_CHUNK))
    cfg = get_arch(TRAIN_SSM_ARCH)
    strict = planted_faults(TRAIN_SSM_ARCH)
    mamba = train_runs(cuda, TRAIN_SSM_ARCH, ssd_floor,
                       [(name, ctx, True) for name, ctx, *_ in strict],
                       (ssd.LAUNCHER, 2 * cfg.num_layers))
    emit({"phase": "train_mamba2_check", **mamba})
    m, q = cfg.ssm, cfg.ssm.chunk_size
    i_bound, _ = ssd_intra_bound(TRAIN_BATCH, TRAIN_SEQ // q, q,
                                 m.num_heads(cfg.d_model), m.head_dim,
                                 m.d_state)
    mrun = launcher_run(cuda, TRAIN_SSM_ARCH, TRAIN_SSM_STEPS, ssd.LAUNCHER,
                        i_bound, must_fall=False)
    emit({"phase": "train_mamba2", **mrun})
    ck = ckpt_round_trip(cuda)
    emit({"phase": "train_ckpt", **ck})
    wall = time.perf_counter() - t0
    emit({"phase": "train_wall", "s": wall})
    print(f"training: gemma-2b {run['ms_per_step_median']:.1f} ms a step, "
          f"{run['tokens_per_s']:.0f} tok/s, "
          f"{100 * run['model_flops_share_of_bf16_peak']:.1f}% of bf16 peak, "
          f"flash bwd {run['flash_bwd_ms_per_step']:.1f} ms a step; "
          f"phase {wall:.1f} s", flush=True)
    names = ("ips_repack", "tiered_decode", "latent_decode", "flash_fwd",
             "ssd_intra")

    def path(r):
        return {"kernels": {n: ({"launches": r["launches"],
                                 "main_path_ms": r["main_path_ms"],
                                 "main_path_bound_ms":
                                     r["main_path_bound_ms"]}
                                if n == r["kernel"] else
                                {"launches": 0, "main_path_ms": 0.0,
                                 "main_path_bound_ms": 0.0})
                            for n in names}}
    figures = {r["kernel"]: {k: r[k] for k in (
        "arch", "launches_per_step", "kernel_ms_per_step",
        "kernel_ms_per_launch", "kernel_bound_ms_per_launch",
        "ms_per_step_median", "flash_bwd_ms_per_step")} for r in (run, mrun)}
    figures["flash_fwd"]["flash_bwd_bound_ms_per_call"] = b_bound
    return ({f"train {TRAIN_ARCH}": path(run),
             f"train {TRAIN_SSM_ARCH}": path(mrun)}, figures)


# ---------------------------------------------------------------------------
# distribution (phase 13)
# ---------------------------------------------------------------------------

# ranks are spawned processes; with one card they share it over gloo
DIST_SWEEP_RANKS = 4            # the paper grid: 102 cells padded to 104
DIST_SEARCH_RANKS = 2           # the quick search
DIST_PSUM_RANKS = 4
DIST_CKPT_LAYERS = 1            # gemma-2b's depth in (c), at full width;
#                                 its 256,000 x 2048 embedding is cut from
#                                 the state: with it (6.3 GB of parameters
#                                 and AdamW moments) the phase took 228 s
#                                 of its 120 (PERF.md §6), without it the
#                                 state is 1.1 GB
DIST_SEED = 23
PSUM_RTOL = 1e-6                # of max |output|
ALLOC_ROUND = 512               # the caching allocator's rounding a tensor


def _note(rank, what, t0) -> float:
    """A rank's progress line on stderr; returns the clock."""
    now = time.perf_counter()
    print(f"phase 13 rank {rank}: {what} in {now - t0:.1f} s",
          file=sys.stderr, flush=True)
    return now


def _bits(t):
    """A tensor's bits as an integer tensor (bitwise comparisons)."""
    import torch
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    if t.dtype.is_floating_point:
        return t.contiguous().view(ints[t.element_size()])
    return t


def _dist_cfg(layers):
    import dataclasses
    from repro_torch.configs import ARCHS
    return dataclasses.replace(ARCHS[TRAIN_ARCH], num_layers=layers)


def _cut(params):
    """The parameters of phase 13's checkpoint: all but the embedding."""
    return {k: v for k, v in params.items() if k != "embed"}


def dist_state(layers, device):
    """gemma-2b's train state at full width and `layers` deep, its
    embedding cut (`_cut`), drawn from DIST_SEED on `device`: the
    parameters, and AdamW moments filled with seeded values (zeros would
    hide a misplaced slice)."""
    import torch
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import adamw_init, tree_map
    from repro_torch.train.train_step import TrainState
    gen = torch.Generator(device).manual_seed(DIST_SEED)
    params = _cut(build_model(_dist_cfg(layers), device=device).init(gen))
    opt = adamw_init(params)

    def draw(p):
        return torch.randn(p.shape, generator=gen, dtype=torch.float32,
                           device=device)
    opt = opt._replace(mu=tree_map(draw, params),
                       nu=tree_map(lambda p: draw(p).abs(), params),
                       step=torch.tensor(5, dtype=torch.int32,
                                         device=device))
    return TrainState(params, opt, torch.tensor(5, dtype=torch.int32,
                                                device=device))


def dist_specs(mesh, state):
    """The plan of a train state on `mesh`: the parameters' specs, the
    optimizer state's (`dryrun.param_specs_like`), the step replicated."""
    from repro_torch.distributed.sharding import P, param_specs
    from repro_torch.launch.dryrun import param_specs_like
    from repro_torch.train.train_step import TrainState
    return TrainState(param_specs(mesh, state.params),
                      param_specs_like(state.opt_state, state.params, mesh),
                      P())


def _meta_state(layers):
    """The train state's stand-ins on meta (`launch.specs`)."""
    import torch
    from repro_torch.launch import specs as lspecs
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_step import TrainState
    cfg = _dist_cfg(layers)
    params = _cut(lspecs.params_specs(build_model(cfg, device="meta")))
    return TrainState(params, lspecs.opt_state_specs(cfg, params),
                      lspecs.sds((), torch.int32))


def _psum_own_scale(grad, residual):
    """Planted fault: `compressed_psum` rescaling with its own scale in
    place of the group's mean (its correction term is then zero)."""
    import torch
    import torch.distributed as dist
    from repro_torch.optim.compress import compress_with_feedback
    q, scale, err = compress_with_feedback(grad, residual)
    summed = q.to(torch.int32)
    dist.all_reduce(summed)
    return summed.to(torch.float32) * scale / dist.get_world_size(), err


def _psum_leaves():
    """One gemma-2b layer's gradient shapes at full width (its stacked
    leaves without the layer axis)."""
    from repro_torch.distributed.sharding import tree_map_path
    params = _meta_state(1).params
    out = []
    tree_map_path(lambda p, x: out.append(("/".join(p), tuple(x.shape[1:])))
                  if p[0] == "layers" else None, params)
    return out


def psum_check(rank, world, device, psum, group=None) -> dict:
    """`psum` (compressed_psum or a planted fault, over `group`, of
    `world` ranks) on this rank's gradients of one gemma-2b layer (bf16)
    and a carried residual (float32), each drawn per rank from
    DIST_SEED, against the same function computed in this process over
    every rank's stacked leaves: the int32 payload sum and the mean
    scale (`reduce_parts`) equal, the output and the residual within
    PSUM_RTOL of their max |value|."""
    import torch
    from repro_torch.optim import compress
    leaves = _psum_leaves()
    worst_out, worst_res, exact_parts, n_el = 0.0, 0.0, True, 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ms = 0.0
    for li, (name, shape) in enumerate(leaves):
        grads, res = [], []
        for r in range(world):
            gen = torch.Generator(device).manual_seed(
                DIST_SEED * 1000 + li * 16 + r)
            grads.append((1e-3 * torch.randn(shape, generator=gen,
                                              device=device)).to(
                                                  torch.bfloat16))
            res.append(1e-5 * torch.randn(shape, generator=gen,
                                          device=device))
        n_el += grads[0].numel()
        torch.cuda.synchronize()
        ev[0].record()
        out, err = psum(grads[rank], res[rank])
        ev[1].record()
        torch.cuda.synchronize()
        ms += ev[0].elapsed_time(ev[1])
        q, scale, _ = compress.compress_with_feedback(grads[rank], res[rank])
        summed, mean_scale, _ = compress.reduce_parts(q, scale, group)
        # the one-process reference over the stacked ranks
        parts = [compress.compress_with_feedback(g, r0)
                 for g, r0 in zip(grads, res)]
        payload = torch.stack([p[0].to(torch.int32) for p in parts]).sum(0)
        total = parts[0][1]
        for p in parts[1:]:
            total = total + p[1]
        mean = total / world
        corr = None
        for p in parts:
            c = compress.dequantize_int8(p[0], p[1]) - p[0].to(
                torch.float32) * mean
            corr = c if corr is None else corr + c
        want = (payload.to(torch.float32) * mean + corr) / float(world)
        exact_parts &= bool(torch.equal(summed, payload)) and bool(
            torch.equal(_bits(mean_scale), _bits(mean)))
        worst_out = max(worst_out, float((out - want).abs().max())
                        / float(want.abs().max()))
        worst_res = max(worst_res, float(
            (err - parts[rank][2]).abs().max()) / max(
                float(parts[rank][2].abs().max()), 1e-30))
    return {"leaves": len(leaves), "elements": n_el,
            "parts_exact": exact_parts, "max_rel_err": worst_out,
            "residual_max_rel_err": worst_res, "psum_ms": ms,
            "ok": exact_parts and worst_out <= PSUM_RTOL
            and worst_res <= PSUM_RTOL}


def ckpt_check(rank, mesh, device_mesh, path, layers, fault=False) -> dict:
    """Restore the checkpoint at `path` onto `device_mesh` under the plan
    of `mesh`: the device memory the pieces take against the plan's
    per-device bytes (`dryrun.argument_bytes`), then every piece against
    the global state's slice at this rank's coordinate, to the bit.
    `fault` plants a restore that swaps ranks 1 and 2's slices."""
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.distributed import sharding
    from repro_torch.launch.dryrun import argument_bytes
    target = _meta_state(layers)
    specs = dist_specs(mesh, target)
    coords = mesh.coords(rank)
    real = sharding.local_slices
    if fault:
        swap = {tuple(mesh.coords(1).items()): mesh.coords(2),
                tuple(mesh.coords(2).items()): mesh.coords(1)}

        def swapped(m, spec, shape, at):
            return real(m, spec, shape, swap.get(tuple(at.items()), at))
        sharding.local_slices = swapped
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    try:
        got, step = ckpt.restore(path, target, mesh=device_mesh,
                                 specs=specs)
    finally:
        sharding.local_slices = real
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    growth = torch.cuda.memory_allocated() - before
    planned = argument_bytes(mesh, [(target, specs)])
    n_tensors = len(ckpt.flatten(target))
    want = ckpt.flatten(dist_state(layers, device_mesh.device_type))
    spec_of = ckpt.flatten(specs)
    equal = True
    for key, piece in ckpt.flatten(got).items():
        w = want[key][real(mesh, spec_of[key], tuple(want[key].shape),
                           coords)]
        equal &= bool(torch.equal(_bits(piece.to_local()), _bits(w)))
    return {"rank": rank, "coords": coords, "step": step,
            "equal": equal, "memory_growth": growth,
            "planned_bytes": planned, "tensors": n_tensors,
            "memory_ok": abs(growth - planned) <= ALLOC_ROUND * n_tensors,
            "restore_s": restore_s}


def dist_rank4(rank, world, cache_dir, ckpt_dir):
    """The 4-rank half of phase 13, one rank: (a) the paper grid through
    `run_sweep` (its slice in one launch), (b) `compressed_psum`, its
    planted fault and a 1-rank NCCL group, (c, d) the checkpoint restored
    onto (data 2, model 2) and its planted fault."""
    import functools
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.ssd_step import ops as ssd_step
    from repro_torch.launch.mesh import MeshSpec, device_mesh
    from repro_torch.optim.compress import compressed_psum
    from repro_torch.sweep.grid import named_grid
    from repro_torch.sweep.runner import run_sweep
    from repro_torch.workloads import TraceCache
    cfg, _ = phase2_cfg()
    ssd_step.reset()
    timings = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_sweep(cfg, named_grid("paper"), device="cuda",
                    timings=timings, trace_cache=TraceCache(root=cache_dir))
    torch.cuda.synchronize()
    _note(rank, "paper grid", t0)
    sweep = {"wall_s": time.perf_counter() - t0,
             "launches": ssd_step.launches,
             "cells": sum(t["cells"] for t in timings if t["rank"] == rank),
             "kernel_ms": max((t["kernel_ms"] for t in timings
                               if t["rank"] == rank), default=None),
             "launch_ms": next((t["launch_ms"] for t in timings
                                if t["rank"] == rank), None),
             "results": ({pt.key: v for pt, v in res.items()}
                         if rank == 0 else None)}
    device = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    psum = psum_check(rank, world, device, compressed_psum)
    t0 = _note(rank, "compressed_psum", t0)
    psum_fault = psum_check(rank, world, device, _psum_own_scale)
    t0 = _note(rank, "its planted fault", t0)
    # a 1-rank NCCL group (every rank takes part in making it)
    nccl = dist.new_group(ranks=[0], backend="nccl")
    one = None
    if rank == 0:
        one = {"backend": dist.get_backend(nccl),
               **psum_check(0, 1, device, functools.partial(
                   compressed_psum, group=nccl), group=nccl)}
    dist.barrier()
    t0 = _note(rank, "the 1-rank NCCL group", t0)
    mesh = MeshSpec(("data", "model"), (2, 2))
    dm = device_mesh(mesh, "cuda")
    ckpt = ckpt_check(rank, mesh, dm, ckpt_dir, DIST_CKPT_LAYERS)
    t0 = _note(rank, "restore and check", t0)
    torch.cuda.empty_cache()
    ckpt_fault = ckpt_check(rank, mesh, dm, ckpt_dir, DIST_CKPT_LAYERS,
                            fault=True)
    _note(rank, "the planted restore", t0)
    return {"sweep": sweep, "psum": psum, "psum_fault": psum_fault,
            "nccl_one_rank": one, "ckpt": ckpt, "ckpt_fault": ckpt_fault}


def _swapped_gather(fn):
    """Planted fault: `fn()` with `group.all_gather_objects` handing back
    ranks 0 and 1's parts swapped, on every rank alike (so the ranks
    stay in step). Gathers that merge results by key do not see it; the
    scenario search's, which orders its members by rank, does."""
    from repro_torch.distributed import group
    real = group.all_gather_objects

    def swapped(obj, group=None):
        parts = real(obj, group)
        parts[0], parts[1] = parts[1], parts[0]
        return parts
    group.all_gather_objects = swapped
    try:
        return fn()
    finally:
        group.all_gather_objects = real


def dist_rank2(rank, world, cache_dir, out_dir, fault_dir, ckpt_dir):
    """The 2-rank half of phase 13, one rank: the train state saved under
    (data 2, model 1), then the quick search through the CLI's entry,
    into `out_dir`, and again with the planted gather fault, into
    `fault_dir`."""
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.kernels.ssd_step import ops as ssd_step
    from repro_torch.launch.mesh import MeshSpec, device_mesh
    from repro_torch.sweep.cli import main as cli_main
    t0 = time.perf_counter()
    mesh = MeshSpec(("data", "model"), (2, 1))
    dm = device_mesh(mesh, "cuda")
    state = dist_state(DIST_CKPT_LAYERS, "cuda")
    sharded = shard_tree(state, dm, dist_specs(mesh, state))
    del state
    torch.cuda.synchronize()
    t0 = _note(rank, "state drawn and sharded", t0)
    ckpt.save(ckpt_dir, sharded, step=5, level=0)
    save_s = time.perf_counter() - t0
    _note(rank, "checkpoint saved", t0)
    del sharded
    torch.cuda.empty_cache()
    os.environ["REPRO_TORCH_TRACE_CACHE_DIR"] = cache_dir

    def search(into):
        with open(os.devnull, "w") as sink, \
                contextlib.redirect_stdout(sink):
            return cli_main(["--search", "quick", "--no-history",
                             "--out-dir", into])
    ssd_step.reset()
    t0 = time.perf_counter()
    rc = search(out_dir)
    search_s = _note(rank, "quick search", t0) - t0
    launches = ssd_step.launches
    ssd_step.reset()
    t0 = time.perf_counter()
    fault_rc = _swapped_gather(lambda: search(fault_dir))
    _note(rank, "its planted gather fault", t0)
    return {"save_s": save_s, "search_rc": rc,
            "search_wall_s": search_s, "search_launches": launches,
            "fault_rc": fault_rc, "fault_launches": ssd_step.launches,
            "shard_bytes": os.path.getsize(os.path.join(
                ckpt_dir, f"shard_{rank:05d}.msgpack.zst"))}


def distribution_phase(cuda, one_process=None) -> dict:
    """Phase 13: the port's distribution on ranks that share the card
    (gloo; ranks spawned, each with its tensors on the card). Builds the
    sweep kernels before any rank starts. `one_process`: phase 3's walls
    ({"paper_wall_s", "search_wall_s"}) to print beside the ranks'."""
    import tempfile
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.distributed import group
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.host_tier import ops as host_tier
    from repro_torch.kernels.ssd_step import ops as ssd_step
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()       # the ranks share this card
    build_all([ssd_step.LIB, host_tier.LIB])
    cache_dir = os.path.join(ROOT, "build", "trace_cache")
    out_dir = os.path.join(ROOT, "build", "dist_search")
    fault_dir = os.path.join(ROOT, "build", "dist_search_fault")
    for d in (out_dir, fault_dir):
        shutil.rmtree(d, ignore_errors=True)
    with open(os.path.join(ROOT, "BENCH_sweep_paper.json")) as f:
        bench = json.load(f)
    with open(os.path.join(ROOT, "tests", "data",
                           "torch_reference_search.json")) as f:
        search_ref = json.load(f)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build"),
                                     prefix="dist_ckpt_") as ckpt_dir:
        t0 = time.perf_counter()
        two = group.spawn(dist_rank2, DIST_SEARCH_RANKS, cache_dir, out_dir,
                          fault_dir, ckpt_dir, device="cuda")
        two_s = _note("parent", "2-rank spawn", t0) - t0
        # (c) restored by one rank: this process, no group
        torch.cuda.empty_cache()
        want = dist_state(DIST_CKPT_LAYERS, cuda)
        t0 = time.perf_counter()
        got, step = ckpt.restore(ckpt_dir, want)
        one_restore_s = _note("parent", "1-rank restore", t0) - t0
        flat_w, flat_g = ckpt.flatten(want), ckpt.flatten(got)
        one_equal = step == 5 and all(
            torch.equal(_bits(flat_g[k]), _bits(flat_w[k])) for k in flat_w)
        with open(os.path.join(ckpt_dir, "manifest.json")) as f:
            manifest = json.load(f)
        state_bytes = sum(v.numel() * v.element_size()
                          for v in flat_w.values())
        del want, got, flat_w, flat_g
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        four = group.spawn(dist_rank4, DIST_SWEEP_RANKS, cache_dir,
                           ckpt_dir, device="cuda")
        four_s = _note("parent", "4-rank spawn", t0) - t0
    one = four[0]["nccl_one_rank"]

    # (a) the sweeps over ranks
    paper = four[0]["sweep"]
    worst = _cells_equal("phase 13 paper over 4 ranks", paper["results"],
                         bench["results"])
    if len(paper["results"]) != 102:
        fail(f"phase 13: the 4-rank paper grid returned "
             f"{len(paper['results'])} cells")
    if any(r["sweep"]["launches"] != 1 for r in four):
        fail("phase 13: a rank ran its paper slice in more than one launch: "
             f"{[r['sweep']['launches'] for r in four]}")
    if [r["sweep"]["cells"] for r in four] != [26] * 4:
        fail("phase 13: the ranks' slices are not 26 cells each")
    if any(r["search_rc"] for r in two):
        fail("phase 13: --search quick exited "
             f"{[r['search_rc'] for r in two]}")
    with open(os.path.join(out_dir, "BENCH_torch_search.json")) as f:
        doc = json.load(f)
    search_worst = max(check_search(doc, search_ref, r["search_launches"])
                       for r in two)
    sweeps = {"paper_ranks": DIST_SWEEP_RANKS, "paper_cells": 102,
              "paper_padded_cells": 104, "paper_max_rel_err": worst,
              "paper_wall_s": [r["sweep"]["wall_s"] for r in four],
              "paper_kernel_ms": [r["sweep"]["kernel_ms"] for r in four],
              "paper_launch_ms": [r["sweep"]["launch_ms"] for r in four],
              "paper_launches": [r["sweep"]["launches"] for r in four],
              "search_ranks": DIST_SEARCH_RANKS,
              "search_wall_s": [r["search_wall_s"] for r in two],
              "search_launches": [r["search_launches"] for r in two],
              "search_max_rel_err": search_worst,
              "one_process": one_process}
    emit({"phase": "dist_sweeps", **sweeps})
    # (b) compressed_psum
    psum = [r["psum"] for r in four]
    if not all(p["ok"] for p in psum):
        fail(f"phase 13: compressed_psum over 4 ranks failed its check: "
             f"{psum}")
    if not one["ok"] or one["backend"] != "nccl":
        fail(f"phase 13: the 1-rank NCCL compressed_psum failed: {one}")
    faults = [{"fault": "psum_own_scale",
               "caught": not all(r["psum_fault"]["ok"] for r in four),
               "max_rel_err": max(r["psum_fault"]["max_rel_err"]
                                  for r in four)}]
    emit({"phase": "dist_psum", "ranks": DIST_PSUM_RANKS,
          "leaves": psum[0]["leaves"], "elements": psum[0]["elements"],
          "parts_exact": all(p["parts_exact"] for p in psum),
          "max_rel_err": max(p["max_rel_err"] for p in psum),
          "residual_max_rel_err": max(p["residual_max_rel_err"]
                                      for p in psum),
          "psum_ms": [p["psum_ms"] for p in psum], "nccl_one_rank": one})
    # (c, d) checkpoints
    ck = [r["ckpt"] for r in four]
    if not one_equal or manifest["num_shards"] != DIST_SEARCH_RANKS:
        fail("phase 13: the 2-rank checkpoint did not restore on one rank "
             "to the bit")
    if not all(c["equal"] and c["step"] == 5 for c in ck):
        fail(f"phase 13: a rank's restored pieces differ: {ck}")
    if not all(c["memory_ok"] for c in ck):
        fail(f"phase 13: a rank's memory growth is not the plan's bytes: "
             f"{[(c['memory_growth'], c['planned_bytes']) for c in ck]}")
    faults.append({"fault": "restore_swaps_ranks_1_2",
                   "caught": not all(r["ckpt_fault"]["equal"]
                                     for r in four),
                   "ranks_failing": [r["ckpt_fault"]["rank"] for r in four
                                     if not r["ckpt_fault"]["equal"]]})
    emit({"phase": "dist_ckpt", "layers": DIST_CKPT_LAYERS,
          "state_bytes": state_bytes, "save_ranks": DIST_SEARCH_RANKS,
          "save_s": [r["save_s"] for r in two],
          "shard_bytes": [r["shard_bytes"] for r in two],
          "one_rank_restore_s": one_restore_s, "one_rank_equal": one_equal,
          "four_rank": [{k: c[k] for k in (
              "rank", "coords", "equal", "memory_growth", "planned_bytes",
              "tensors", "restore_s")} for c in ck]})
    # the planted gather fault: the 2-rank search again, its ranks'
    # gathers handing back their two parts swapped
    if any(r["fault_rc"] for r in two):
        fail("phase 13: --search quick with the planted gather fault "
             f"exited {[r['fault_rc'] for r in two]}")
    with open(os.path.join(fault_dir, "BENCH_torch_search.json")) as f:
        fault_doc = json.load(f)
    try:
        for r in two:
            check_search(fault_doc, search_ref, r["fault_launches"])
        gather_caught = False
    except SystemExit as e:
        gather_caught = str(e)
    faults.insert(0, {"fault": "gather_swaps_ranks_0_1",
                      "caught": bool(gather_caught),
                      "failed_with": gather_caught or None})
    for f in faults:
        emit({"phase": "dist_planted_fault", **f})
        if not f["caught"]:
            fail(f"phase 13: the planted fault {f['fault']} passed its check")
    wall = time.perf_counter() - t_phase
    emit({"phase": "dist_wall", "s": wall, "two_rank_spawn_s": two_s,
          "four_rank_spawn_s": four_s})
    print(f"distribution: paper over {DIST_SWEEP_RANKS} ranks "
          f"{max(sweeps['paper_wall_s']):.2f} s"
          + (f" (one process {one_process['paper_wall_s']:.2f} s)"
             if one_process else "")
          + f", quick search over {DIST_SEARCH_RANKS} ranks "
          f"{max(sweeps['search_wall_s']):.1f} s"
          + (f" (one process {one_process['search_wall_s']:.1f} s)"
             if one_process else "")
          + f"; phase {wall:.1f} s", flush=True)
    return {"launches": sum(r["sweep"]["launches"] for r in four)
            + sum(r["search_launches"] for r in two)}


# ---- phase 14: the examples and dev scripts on the card ----
EXAMPLES_REF = os.path.join("tests", "data", "torch_reference_examples.json")
# examples/train_lm_torch.py at the reference docstring's ~100M size; its
# 300 steps cut to TRAIN_LM_STEPS (a checkpoint every TRAIN_LM_STEPS // 2:
# halfway, and one at the end) and a second call that resumes there and
# runs to TRAIN_LM_RESUME, to keep the phase within its 120 s
TRAIN_LM_BATCH, TRAIN_LM_SEQ = 32, 512
TRAIN_LM_ARGS = ("--d-model", "768", "--layers", "12", "--vocab", "32000",
                 "--batch", str(TRAIN_LM_BATCH), "--seq", str(TRAIN_LM_SEQ),
                 "--log-every", "20")
TRAIN_LM_STEPS, TRAIN_LM_RESUME = 60, 80
# the dense family beyond gemma-2b served as phase 6 serves gemma, under
# IPS, at full width: yi-6b (silu, untied embeddings, G 8 at hd 128) and
# minitron-4b (the ungated squared-ReLU FFN, a 256,000 vocab), their depth
# cut from 32 to 8 layers each to keep phase 14 within its 120 s and the
# script within 720 s (gemma-2b's 9 layers under four policies take some
# 62 s on an H100, PERF.md §5). yi-34b's widths are llava-next-34b's
# language model, which phase 11 serves.
DENSE_ARCHS = (("yi-6b", 8, ("IPS",)), ("minitron-4b", 8, ("IPS",)))
# the kernels each part of phase 14 must launch: the kernels on that
# example's path
EXAMPLE_PARTS = (
    ("ssd_repro", "examples/ssd_repro_torch.py", (), ("ssd_step",)),
    ("quickstart", "examples/quickstart_torch.py", (),
     ("ssd_step", "flash_fwd", "tiered_decode", "ips_repack")),
    ("serve_ips", "examples/serve_ips_torch.py", (),
     ("flash_fwd", "tiered_decode", "ips_repack")),
    ("host_cache", "examples/host_cache_torch.py", (),
     ("ssd_step", "host_tier")),
    ("sweep_fleet", "examples/sweep_fleet_torch.py", (), ("ssd_step",)),
    ("workload_zoo", "examples/workload_zoo_torch.py", ("--simulate",),
     ("ssd_step",)),
)


def _all_launchers() -> dict:
    from repro_torch.kernels.host_tier import ops as host_tier
    from repro_torch.kernels.ssd_step import ops as ssd_step
    return {"ssd_step": ssd_step.LAUNCHER, "host_tier": host_tier.LAUNCHER,
            **_launchers()}


def run_script_main(rel_path: str, argv, need=()) -> dict:
    """`main(argv)` of the script at `rel_path`, in this process (the
    kernels built once): its stdout captured (and kept under
    build/examples/), every kernel's launch count zeroed just before and
    read just after; fails if a kernel of `need` did not launch."""
    import contextlib
    import importlib.util
    import io

    import torch
    stem = os.path.splitext(os.path.basename(rel_path))[0]
    spec = importlib.util.spec_from_file_location(
        f"phase14_{stem}", os.path.join(ROOT, rel_path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    launchers = _all_launchers()
    for launcher in launchers.values():
        launcher.reset()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main(list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in launchers.items()}
    text = buf.getvalue()
    with open(os.path.join(ROOT, "build", "examples", f"{stem}.txt"),
              "a") as f:
        f.write(text)
    missing = [k for k in need if not launches[k]]
    if missing:
        fail(f"{rel_path}: {', '.join(missing)} never launched on its path "
             f"(launches {launches})")
    return {"text": text, "out": out, "wall_s": wall,
            "launches": {k: n for k, n in launches.items() if n}}


def _same_lines(label, got: list, want: list) -> None:
    if got != want:
        diff = [f"  port {a!r}\n  ref  {b!r}" for a, b in zip(got, want)
                if a != b][:4]
        fail(f"{label}: its table differs from the reference's "
             f"({len(got)} vs {len(want)} lines):\n" + "\n".join(diff))


def examples_phase(cuda, bench) -> dict:
    """Phase 14: the examples and dev scripts of the port, each `main`
    called in this process as a user runs it (on the card by default),
    each with every kernel's count zeroed just before and read just
    after, their printed tables held to the reference examples' recorded
    output (`tests/data/torch_reference_examples.json`, written by
    `scripts/record_torch_reference_examples.py`); then train_lm at ~100M
    with a resume, `scripts/smoke_models_torch.py` over every arch, and
    the dense archs served. Returns the phase's launches by kernel and
    the dense archs' serving paths."""
    import numpy as np
    import torch
    with open(os.path.join(ROOT, EXAMPLES_REF)) as f:
        recorded = json.load(f)["examples"]
    out_dir = os.path.join(ROOT, "build", "examples")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t_phase = time.perf_counter()
    total = {}

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    for name, rel, argv, need in EXAMPLE_PARTS:
        ref = recorded[name]
        with contextlib.chdir(out_dir):   # the sweep's artifact lands here
            run = run_script_main(rel, argv, need)
        add(run["launches"])
        want = example_table(name, ref["stdout"])
        got = example_table(name, run["text"])
        extra = {}
        if name == "workload_zoo":
            # the zoo's table is host numpy (held by the CPU test); the
            # card's part is the six simulated cells
            want = [ln for ln in want if " lat=" in ln]
            got = [ln for ln in got if " lat=" in ln]
            if len(want) != 6:
                fail("workload_zoo: the reference recorded "
                     f"{len(want)} simulated lines, not 6")
        _same_lines(f"{rel} {' '.join(argv)}".strip(), got, want)
        if name == "ssd_repro":
            if len(run["out"]) != 88 or run["launches"].get("ssd_step") != 1:
                fail(f"{rel}: {len(run['out'])} cells in "
                     f"{run['launches'].get('ssd_step')} launch(es), not "
                     "88 in one")
            extra["worst_rel"] = _cells_equal(rel, run["out"],
                                              bench["results"])
        if name == "quickstart":
            if not (math.isfinite(run["out"]["loss"])
                    and math.isfinite(run["out"]["grad_norm"])):
                fail(f"{rel}: the train step's loss or gradient norm is "
                     "not finite")
            extra["train"] = {k: run["out"][k] for k in ("loss",
                                                          "grad_norm")}
        if name == "sweep_fleet":
            art = os.path.join(out_dir, "BENCH_torch_example_sweep.json")
            with open(art) as f:
                doc = json.load(f)
            if len(doc["results"]) != 28 or os.path.exists(
                    os.path.join(out_dir, "BENCH_example_sweep.json")):
                fail(f"{rel}: its artifact holds {len(doc['results'])} "
                     "cells, not 28, or the reference's name was written")
        emit({"phase": "examples", "part": name, "argv": list(argv),
              "wall_s": run["wall_s"], "launches": run["launches"],
              "lines_equal": len(want), **extra})

    # train_lm at ~100M: TRAIN_LM_STEPS steps, then a resumed call
    ckpt = os.path.join(out_dir, "train_lm_ckpt")
    common = list(TRAIN_LM_ARGS) + ["--ckpt-dir", ckpt, "--ckpt-every",
                                    str(TRAIN_LM_STEPS // 2)]
    torch.cuda.reset_peak_memory_stats()
    first = run_script_main("examples/train_lm_torch.py", common + [
        "--steps", str(TRAIN_LM_STEPS)], ("flash_fwd",))
    peak = torch.cuda.max_memory_allocated() / 2**30
    second = run_script_main("examples/train_lm_torch.py", common + [
        "--steps", str(TRAIN_LM_RESUME)], ("flash_fwd",))
    add(first["launches"])
    add(second["launches"])
    losses = first["out"]["losses"]
    if len(losses) != TRAIN_LM_STEPS or not all(map(math.isfinite, losses)):
        fail(f"train_lm: {len(losses)} steps, or a loss not finite")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5:
        fail(f"train_lm: the loss did not fall ({losses[:5]} -> "
             f"{losses[-5:]})")
    if second["out"]["start_step"] != TRAIN_LM_STEPS or len(
            second["out"]["losses"]) != TRAIN_LM_RESUME - TRAIN_LM_STEPS:
        fail(f"train_lm: the second call started at step "
             f"{second['out']['start_step']}, not {TRAIN_LM_STEPS}")
    step_ms = float(np.median(first["out"]["step_ms"][2:]))
    emit({"phase": "examples", "part": "train_lm", "argv": common,
          "params": first["out"]["params"], "steps": TRAIN_LM_STEPS,
          "resumed_at": second["out"]["start_step"],
          "resumed_steps": len(second["out"]["losses"]),
          "cut": "the reference docstring's 300 steps cut to "
                 f"{TRAIN_LM_STEPS} and a resume to {TRAIN_LM_RESUME}, for "
                 "the phase's time",
          "loss_first": losses[0], "loss_last": losses[-1],
          "loss_resumed_last": second["out"]["losses"][-1],
          "ms_a_step": step_ms,
          "tokens_per_s": TRAIN_LM_BATCH * TRAIN_LM_SEQ / step_ms * 1e3,
          "peak_gib": peak, "wall_s": first["wall_s"] + second["wall_s"],
          "launches": first["launches"],
          "resumed_launches": second["launches"]})

    smoke = run_script_main("scripts/smoke_models_torch.py", [],
                            ("flash_fwd", "tiered_decode", "latent_decode",
                             "ssd_intra", "ips_repack"))
    add(smoke["launches"])
    if smoke["out"] != 0:
        fail("scripts/smoke_models_torch.py failed:\n" + smoke["text"][-2000:])
    emit({"phase": "examples", "part": "smoke_models",
          "archs": [ln.split()[1] for ln in smoke["text"].splitlines()
                    if ln.startswith("OK ")],
          "wall_s": smoke["wall_s"], "launches": smoke["launches"]})
    examples_s = time.perf_counter() - t_phase

    paths = {}
    for arch, layers, policies in DENSE_ARCHS:
        t_arch = time.perf_counter()
        paths[arch] = serve_main_path(cuda, arch, layers, policies)
        torch.cuda.empty_cache()
        emit({"phase": "serve_wall", "arch": arch,
              "s": time.perf_counter() - t_arch})
    wall = time.perf_counter() - t_phase
    emit({"phase": "examples_wall", "s": wall, "examples_s": examples_s,
          "dense_s": wall - examples_s, "launches": total})
    print(f"examples: {len(EXAMPLE_PARTS)} examples, train_lm, "
          f"smoke_models and {len(DENSE_ARCHS)} dense archs in {wall:.1f} s",
          flush=True)
    return {"launches": total, "paths": paths}


def _card_line() -> list:
    """Print the card's name and power limit, once, and keep them for
    every JSON line."""
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    CARD = smi[0] if smi else "nvidia-smi: no output"
    print(CARD, flush=True)
    return smi


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the card")
    # each phase's wall, from the start: the script must end within its
    # 1200 s
    t_start = time.perf_counter()
    walls = {}

    def wall(name):
        walls[name] = time.perf_counter() - t_start
    bench_path = os.path.join(ROOT, "BENCH_sweep_paper.json")
    if not os.path.exists(bench_path):
        fail(f"{bench_path} is missing: run from the root of a checkout")

    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.host_tier import ops as host_tier
    from repro_torch.kernels.ssd_step import ops as ssd_step

    # phase 2's plain versions start first, on the CPU beside the build
    cfg, n_logical = phase2_cfg()
    streams = phase2_streams(cfg, n_logical)
    cases = phase2_cases()
    plain = PlainRuns((
        ("case", len(cases)), ("mixed", len(mixed_jobs(cfg, n_logical)[0])),
        ("wear", len(wear_jobs(cfg, n_logical, streams["traces"])[0]))))

    # ---- 1. device and build ----
    smi = _card_line()
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    max_sm_mhz = float(clocks[0]) if clocks else float("nan")
    serve_libs = serving_libraries()
    t0 = time.perf_counter()
    paths = build_all([ssd_step.LIB, host_tier.LIB]
                      + [lib for _, lib in serve_libs])
    build_wall = time.perf_counter() - t0
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_wall_s": build_wall, "build_s": ssd_step.LIB.build_s,
          "library": os.path.relpath(paths[0], ROOT), "max_sm_mhz": max_sm_mhz,
          **ssd_step.LIB.ptxas(),
          "host_tier": {"build_s": host_tier.LIB.build_s,
                        "library": os.path.relpath(paths[1], ROOT),
                        **host_tier.LIB.ptxas()}})

    cuda = torch.device("cuda", 0)
    torch.set_num_threads(1)       # the plain version runs 0-d tensor ops

    wall("1 build")

    # ---- 2. kernel vs plain version, same inputs ----
    per_op, pad_t = streams["per_op"], streams["pad_t"]
    c_cnt = len(streams["traces"])
    ssd_step.reset()
    kernel_ms, probe_ms, plain_s, max_err = 0.0, 0.0, 0.0, 0.0
    for i, (policy, mode, form) in enumerate(cases):
        # on the card the probe off and on, after one untimed launch that
        # brings the card's clocks back up from an idle spell; the plain
        # version once, in a worker, with the probe on (its latencies and
        # carries are the probe-off ones: tests/test_torch_telemetry.py)
        res, card_ms = {}, {}
        for window in (None, None, PROBE_WINDOW):
            res[window] = phase2_run(cfg, n_logical, streams,
                                     (policy, mode, form), cuda, window)
            torch.cuda.synchronize()
            start, end = ssd_step.events[-1]
            card_ms[window] = start.elapsed_time(end)
        want, want_s = plain.result("case", i)
        if form == "K=1":
            kernel_ms += card_ms[None]
            probe_ms += card_ms[PROBE_WINDOW]
            plain_s += want_s
        label = f"{policy}/{mode}/{form}"
        rows = want[1].timeline
        if rows is None or rows.snap.shape[1] != -(-(
                SMOKE_OPS + SMOKE_PAD) // PROBE_WINDOW):
            fail(f"{label}: the plain version's probe rows are "
                 "missing or mis-shaped")
        max_err = max(max_err, leaves_equal(
            f"{label} probe", res[PROBE_WINDOW], want))
        max_err = max(max_err, leaves_equal(
            f"{label} probe off", res[None],
            (want[0], want[1]._replace(timeline=None))))
    mixed = mixed_launch_vs_plain(cfg, n_logical, cuda, plain)
    smoke_launches = ssd_step.launches
    if smoke_launches != 3 * len(cases) + 1:
        fail(f"phase 2 launched the kernel {smoke_launches} times for "
             f"{len(cases)} comparisons (a warm-up, probe off and on) and "
             "one mixed launch")
    wear = wear_vs_plain(cfg, n_logical, cuda, streams["traces"], plain)
    plain.close()
    emit({"phase": "wear_vs_plain", **wear})
    probe = ssd_step.smem_chase(1 << 22, cuda)
    emit({"phase": "smem_chase", **probe, "max_sm_mhz": max_sm_mhz})
    emit({"phase": "op_cycles", "smem_load_cycles": probe["cycles_per_load"],
          "jobs": op_cycles(cfg, n_logical, cuda, per_op, pad_t)})
    smoke_bytes = 8 * stream_bytes(c_cnt, SMOKE_OPS, False, cfg.num_planes,
                                   n_logical)
    smoke_bound, smoke_by = bound_ms(
        smoke_bytes, 8 * c_cnt * SMOKE_OPS * CORE_F32_OPS)
    emit({"phase": "kernel_vs_plain", "cases": len(cases),
          "cells_per_case": c_cnt, "ops": SMOKE_OPS, "pad": SMOKE_PAD,
          "forms": ["K=1", "K=32"], "equal": True, "max_abs_err": max_err,
          "probe_window": PROBE_WINDOW, "probe_equal": True,
          "launches": smoke_launches, "kernel_ms_k1": kernel_ms,
          "probe_kernel_ms_k1": probe_ms,
          "plain_ms_k1": plain_s * 1e3, "bound_ms_k1": smoke_bound,
          "mixed_launch": mixed})

    wall("2 ssd_step vs plain")

    # ---- 3. the sweep paths: every device-only grid on the card ----
    with open(bench_path) as f:
        bench = json.load(f)
    with open(os.path.join(ROOT, "BENCH_sweep_endurance.json")) as f:
        endur_ref = json.load(f)["results"]
    with open(os.path.join(ROOT, "tests", "data",
                           "torch_reference_sweeps.json")) as f:
        recorded = json.load(f)["grids"]
    cache_dir = os.path.join(ROOT, "build", "trace_cache")
    shutil.rmtree(cache_dir, ignore_errors=True)
    sweeps = {}
    for run, grid, ref in (
            ("paper_cold", "paper", bench["results"]),
            ("paper_warm", "paper", bench["results"]),
            ("endurance", "endurance", endur_ref),
            ("stress", "stress", recorded["stress"]["results"]),
            ("mixed", "mixed", recorded["mixed"]["results"]),
            ("sensitivity", "sensitivity",
             recorded["sensitivity"]["results"])):
        sweeps[run] = sweep_path(cfg, n_logical, cuda, grid, ref, cache_dir,
                                 probe["cycles_per_load"], max_sm_mhz)
        emit({"phase": "main_path", "run": run, **sweeps[run]["line"]})
        if grid == "paper":
            geomeans = sweeps[run]["geomeans"]
            for key, v in geomeans.items():
                for metric in ("mean_write_latency_ms", "wa_paper"):
                    ref_v = bench["geomeans"][key][metric]
                    if abs(v[metric] - ref_v) > 1e-6 * abs(ref_v):
                        fail(f"geomean {key}/{metric} = {v[metric]!r}, "
                             f"reference {ref_v!r}")
    if sweeps["paper_warm"]["trace_cache"]["misses"] != 0:
        fail("the warm paper run missed the trace cache")
    emit({"phase": "trace_cache",
          "paper_wall_cold_s": sweeps["paper_cold"]["line"]["wall_s"],
          "paper_wall_warm_s": sweeps["paper_warm"]["line"]["wall_s"],
          "cold": sweeps["paper_cold"]["trace_cache"],
          "warm": sweeps["paper_warm"]["trace_cache"]})
    emit({"phase": "wear_form_per_op",
          "endurance_ns_per_op":
              sweeps["endurance"]["line"]["longest_cell_ns_per_op"],
          "endurance_cycles_per_op":
              sweeps["endurance"]["line"]["longest_cell_cycles_per_op"],
          "paper_ns_per_op":
              sweeps["paper_warm"]["line"]["longest_cell_ns_per_op"],
          "paper_cycles_per_op":
              sweeps["paper_warm"]["line"]["longest_cell_cycles_per_op"]})

    # ---- 3b. telemetry: the paper grid with the probe on, one launch ----
    wall("3 sweeps")
    t_tel = time.perf_counter()
    tele = telemetry_path(cfg, cuda, cache_dir,
                          sweeps["paper_warm"]["results"])
    off_ms = sweeps["paper_warm"]["line"]["kernel_ms"]
    emit({"phase": "telemetry", **tele, "probe_off_launch_ms": off_ms,
          "probe_on_launch_ms": tele["launch_ms"],
          "launch_ratio": tele["launch_ms"] / off_ms})
    print(f"telemetry: cliffs {tele['cliffs']}/{tele['cells']} cell(s) at "
          f"{TIMELINE_WINDOW} ops a window; launch {off_ms:.2f} ms probe "
          f"off, {tele['launch_ms']:.2f} ms on", flush=True)
    emit({"phase": "profile", **profile_path(cfg, cuda, cache_dir)})
    cli_run = cli_timeline_run(cache_dir)
    emit({"phase": "cli_timeline", **cli_run})
    emit({"phase": "telemetry_wall", "s": time.perf_counter() - t_tel})

    # ---- 3c. the host tier: its kernel, the hostcache grid, the CLI's
    # --hostcache, the search engine ----
    wall("3b telemetry")
    t_host = time.perf_counter()
    tier = host_tier_vs_plain(cfg, n_logical, cuda, probe["cycles_per_load"],
                              max_sm_mhz)
    emit({"phase": "kernel_vs_plain", "kernel": "host_tier", **tier})
    split = host_tier_split(cfg, n_logical, cuda, probe["cycles_per_load"],
                            max_sm_mhz)
    emit({"phase": "host_tier_split", **split})
    with open(os.path.join(ROOT, "BENCH_sweep_hostcache.json")) as f:
        hc_bench = json.load(f)
    sweeps["hostcache"] = sweep_path(cfg, n_logical, cuda, "hostcache",
                                     hc_bench["results"], cache_dir,
                                     probe["cycles_per_load"], max_sm_mhz)
    emit({"phase": "main_path", "run": "hostcache",
          **sweeps["hostcache"]["line"]})
    from repro_torch.sweep.report import hostcache_summary
    for key, v in hostcache_summary(sweeps["hostcache"]["results"]).items():
        want = hc_bench["hostcache"]["/".join(key)]
        for metric in ("host_hit_rate", "host_dev_write_frac", "lat_vs_off",
                       "wa_vs_off"):
            if abs(v[metric] - want[metric]) > 1e-6 * abs(want[metric]):
                fail(f"hostcache {key} {metric} = {v[metric]!r}, reference "
                     f"{want[metric]!r}")
    cli_hc = cli_hostcache_run(cache_dir, recorded["cli_hostcache"])
    emit({"phase": "cli_hostcache", **cli_hc})
    search = search_path(cache_dir)
    emit({"phase": "search", **search})
    emit({"phase": "host_tier_wall", "s": time.perf_counter() - t_host})

    wall("3c host tier and search")

    # ---- 3d. the evaluation matrix, the fleet against the loop, the
    # step-throughput script ----
    t_matrix = time.perf_counter()
    matrix = matrix_path(cfg, cuda, bench, cache_dir)
    emit({"phase": "matrix", **matrix,
          "wall_s": time.perf_counter() - t_matrix})
    wall("3d matrix and benches")

    # ---- 4.-8. the serving paths ----
    emit({"phase": "serve_build",
          "libraries": {name: {"build_s": lib.build_s,
                               "library": os.path.relpath(lib.path(), ROOT),
                               **lib.ptxas()}
                        for name, lib in serve_libs}})
    kernels = serve_kernels_vs_plain(cuda)
    wall("5 serving kernels vs plain")
    arch, layers = SERVE_ARCHS[0]
    by_path = {arch: serve_main_path(cuda, arch, layers)}
    torch.cuda.empty_cache()
    wall(f"6 {arch}")
    kernels["ssd_intra"] = ssd_kernel_vs_plain(cuda)
    for arch, layers in SERVE_ARCHS[1:]:
        by_path[arch] = serve_main_path(cuda, arch, layers)
        torch.cuda.empty_cache()
        wall(f"8 {arch}")

    # ---- 9. the MoE paths: deepseek-v2-lite (MLA over the int4 latent),
    # then one arctic layer (its weights drawn after deepseek's are freed)
    t_moe = time.perf_counter()
    for arch, layers, policies in MOE_ARCHS:
        by_path[arch] = serve_main_path(cuda, arch, layers, policies)
        torch.cuda.empty_cache()
        wall(f"9 {arch}")
    emit({"phase": "moe_wall", "s": time.perf_counter() - t_moe})

    # ---- 10.-11. the encoder-decoder (whisper-tiny, full size, the four
    # policies) and the VLM (llava-next-34b under IPS, full width and
    # depth unless cut in LLAVA_LAYERS) ----
    for arch, layers, policies in EXTRA_ARCHS:
        t_arch = time.perf_counter()
        by_path[arch] = serve_main_path(cuda, arch, layers, policies)
        torch.cuda.empty_cache()
        emit({"phase": "serve_wall", "arch": arch,
              "s": time.perf_counter() - t_arch})
        wall(f"10 {arch}")

    # ---- 12. training: gemma-2b and mamba2-370m at full size, their
    # kernels under autograd, the launcher, a checkpoint round trip ----
    train_paths, train_figures = training_phase(cuda)
    by_path.update(train_paths)
    wall("12 training")

    # ---- 13. distribution: ranks sharing the card (gloo) ----
    dist = distribution_phase(cuda, {
        "paper_wall_s": sweeps["paper_warm"]["line"]["wall_s"],
        "search_wall_s": search["wall_s"]})
    wall("13 distribution")

    # ---- 14. the examples and dev scripts, and the dense family served
    examples = examples_phase(cuda, bench)
    by_path.update(examples["paths"])
    wall("14 examples")
    emit({"phase": "walls", "s_from_start": walls})

    # ---- the kernel table, then the contract's last line ----
    paper = sweeps["paper_warm"]["line"]
    ex_launches = examples["launches"]
    table = [{
        "name": "ssd_step", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_step/csrc/ssd_step.cu",
        "replaces": "src/repro/kernels/ssd_step/kernel.py:46",
        # every sweep path's one launch, each counted from 0 (the
        # telemetry phase's among them), phase 13's ranks' launches and
        # phase 14's examples'
        "launches": sum(s["line"]["launches"] for s in sweeps.values())
        + tele["launches"] + matrix["launches"] + dist["launches"]
        + ex_launches.get("ssd_step", 0),
        "distribution_launches": dist["launches"],
        "examples_launches": ex_launches.get("ssd_step", 0),
        # ms / plain_ms / bound_ms: the same work — phase 2's eight K = 1
        # launches, which the CPU plain version can also run
        "max_abs_err": max(max_err, wear["max_abs_err"]), "ms": kernel_ms,
        "plain_ms": plain_s * 1e3, "bound_ms": smoke_bound,
        "bound_by": smoke_by, "library_ms": None,
        # the paper grid's one launch (warm), beside its bytes bound and
        # the chain bound of its longest cell
        "main_path_ms": paper["kernel_ms"],
        "main_path_bound_ms": paper["bound_ms"],
        "main_path_bound_by": paper["bound_by"],
        "main_path_chain_bound_ms": paper["chain_bound_ms"],
        # the wear form: phase 2's wear launches beside their plain
        # version and bound, and the sweep paths that run wear cells
        "wear_ms": wear["kernel_ms"], "wear_plain_ms": wear["plain_ms"],
        "wear_bound_ms": wear["bound_ms"], "wear_bound_by": wear["bound_by"],
        "wear_launches": sum(s["line"]["launches"] for s in sweeps.values()
                             if s["line"]["wear_cells"]),
        "wear_main_path_ms": sweeps["endurance"]["line"]["kernel_ms"],
        "wear_ns_per_op":
            sweeps["endurance"]["line"]["longest_cell_ns_per_op"],
        "plain_form_ns_per_op": paper["longest_cell_ns_per_op"],
        "main_paths": {run: {k: s["line"][k] for k in (
            "launches", "kernel_ms", "wall_s", "bound_ms", "bound_by",
            "chain_bound_ms")} for run, s in sweeps.items()},
        # eval_matrix's one launch and bench_fleet_vs_loop's 1 + 66
        "matrix_launches": matrix["launches"],
        # the probe form: phase 2's eight K = 1 launches with the probe on,
        # the wear jobs' with it on, the paper grid's one launch with it on
        # (the telemetry phase) and the CLI's overhead check
        "probe_ms": probe_ms, "probe_wear_ms": wear["probe_kernel_ms"],
        "probe_main_path_ms": tele["launch_ms"],
        "probe_main_path_launches": tele["launches"],
        "probe_overhead": (cli_run["overhead"] or {}).get("ratio"),
        "probe_launch_ratio": (cli_run["overhead"] or {}).get(
            "launch_ratio")}]
    hc_line = sweeps["hostcache"]["line"]
    table.append({
        "name": "host_tier", "route": "cuda",
        "source": "src/repro_torch/kernels/host_tier/csrc/host_tier.cu",
        # no pallas_call: the reference runs its tier inside the composed
        # lax.scan step
        "replaces": "src/repro/hostcache/pipeline.py:55",
        "launches": hc_line["tier_launches"]
        + ex_launches.get("host_tier", 0),
        "examples_launches": ex_launches.get("host_tier", 0),
        # ms / plain_ms / bound_ms: the same work — the grid's specs x
        # both modes and a device-memory cell, HOST_TIER_OPS ops each
        "max_abs_err": tier["max_abs_err"], "ms": tier["ms"],
        "plain_ms": tier["plain_ms"], "bound_ms": tier["bound_ms"],
        "bound_by": tier["bound_by"], "library_ms": None,
        "chain_bound_ms": tier["chain_bound_ms"],
        # the hostcache grid's one tier pass beside its own chain bounds
        # (the serial form's and the warp form's floor), and
        # its one ssd_step launch; the grid's cells alone (8 of them, one
        # launch) and where an op's cycles go there
        "main_path_ms": hc_line["tier_ms"],
        "main_path_chain_bound_ms": split["chain_bound_ms"],
        "main_path_warp_chain_bound_ms": split["warp_chain_bound_ms"],
        "grid_cells_ms": split["ms"], "grid_ns_per_op": split["ns_per_op"],
        "grid_split_cycles_per_op": split["split_cycles_per_op"],
        "main_path_ssd_step_ms": hc_line["kernel_ms"],
        "search_launches": search["tier_launches"]})
    for name in ("ips_repack", "tiered_decode", "latent_decode",
                 "flash_fwd", "ssd_intra"):
        # launches and main-path times: every serving path that runs it
        paths = {arch: v["kernels"][name] for arch, v in by_path.items()
                 if v["kernels"][name]["launches"]}
        if not paths:
            fail(f"{name}: no serving path launched it")
        row = dict(kernels[name])
        for key in ("launches", "main_path_ms", "main_path_bound_ms"):
            row[key] = sum(p[key] for p in paths.values())
        # phase 14's examples and scripts (its dense archs are paths)
        row["examples_launches"] = ex_launches.get(name, 0)
        row["launches"] += row["examples_launches"]
        row["main_paths"] = paths
        if name in train_figures:
            row["training"] = train_figures[name]
        table.append(row)
    emit({"kernels": table}, card=False)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}},
         card=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
