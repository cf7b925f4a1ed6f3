#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

1. Fails (exit 1, no result) unless ``torch.cuda.is_available()``.
2. Prints the card's name and power limit, then builds every CUDA kernel
   of the serving and training paths from ``src/repro_torch/csrc`` (one nvcc
   per source, in parallel), prints the build time and the number of HGMMA
   (wgmma) instructions in each quantized-matmul library and in the flash
   attention library, and fails if there are none.
3. Kernel phase: each kernel against its plain PyTorch version on the
   card at the shapes of full-width repro-100m serving (the quantized
   matmuls also at the fused widths N1280 = wqkv and N4096 = gate_up, and
   at M4096 also per-group and packed int4, each case printing whether it
   took the tensor-core, the split-K decode or the tile kernel; a decode
   case also against its split emulation ``ref.quant_gemv_split_ref``, a
   second launch and its bf16 output, with the tile kernel's time beside
   it),
   flash attention at the prefill wave, at Sq256 Sk1024 causal and full
   and at the wave with head dim 128, through its wrapper (the
   tensor-core kernel, also held against its emulation
   ``ref.flash_attention_tc_ref``) and through the SIMT kernel; the
   split-KV decode kernels also against their split emulations;
   with its error, tolerance, device time (CUDA events, L2 flushed before
   each launch), the plain version's time, the least time the card could
   take (bound) and the time of one PyTorch library call computing the
   same function (a yardstick the port never calls). The reuse matmul's
   multiply count is held against ``reuse_mult_count``. The quantization
   kernel's codes and scales must equal its plain version's, at five
   shapes, bf16 and f32, 8 and 4 bits (each timed beside the strip
   kernel it replaced, built from
   ``src/repro_torch/baseline/quantize_strip.cu`` as a library of its
   own, and the launch floor, with its plan printed), on every route of
   its plan at 2 to 8 bits (K65536, ragged N in stacks), on columns
   holding a NaN, an inf or only zeros, and then in a deploy pass through
   ``ops.quantize_channels`` over every projection leaf of full-width
   repro-100m (84 matrices, one launch per stacked leaf), its path. The
   codebook route of the tensor-core path (NF4 and identity-8, per
   channel and per group of 128, at a prefill wave's M4096 and the
   projections' K x N) is held on both matmuls against the plain version
   and its emulation ``ref.quant_gemm_ref``, with the tile kernel it
   replaced timed beside it. The kernels of both quantized matmuls are
   timed from M1 to M4096 at N256 and N2048, int8 and NF4 (the decode
   kernels up to M16, the tensor-core ones from M16), where ``TC_MIN_M``
   and ``GEMV_MAX_M`` pick the path. At the shapes of runs h and i: both
   quantized matmuls at qwen2-moe-a2.7b's and chameleon-34b's K x N (M8
   and M4096; their untied heads at M8, held within 8 sqrt(K) f32 ulps of
   the output scale), both decode kernels at 16/16, 64/8, 32/2 (two
   query-head groups) and 4/2 heads (head dims 128 and 16; length-0 rows
   exactly 0, each against its split emulation), flash at 16/16 and 64/8
   heads (d128, both paths) and at f32 head dim 16 (SIMT). At the shapes
   of runs j and k: axllm_matmul at xlstm-1.3b's and zamba2-1.2b's
   mixers' K x N (M8 and M4096; xLSTM's gate projections also with f32
   activations: wif at N8 takes the tile kernel), reuse_matmul at
   zamba2's shared MLP, both untied heads at M8, decode attention at
   32/32 heads d64 and flash at the sub-waves' exact lengths 64, 200 and
   511. The zero-row check: both decode kernels at 16/2 heads d32, bf16
   and int8 KV, with one and with five length-0 rows, each exactly 0.
4. Small-input checks on the reduced float32 model: the dense int8 engine
   gives the same greedy tokens through the kernels as through the plain
   versions, and so does a ``paged=True, impl="reuse"`` engine against the
   dense engine through the plain versions.
5. End-to-end runs on full-width repro-100m cut to ``E2E_LAYERS`` (2) of
   its 12 layers (bf16, random weights from a seed), each with every
   launch count set to 0 just before it and read just after, and each
   checking its own kernels:
   a. dense: ``ServeEngine(quantize=True, n_slots=8, max_len=1024,
      decode_chunk=8)`` serves 16 requests (prompts 64/200/511 tokens,
      ``max_new=64``): axllm_matmul, decode_attention, flash_attention;
   b. reuse + paged: the same engine with ``impl="reuse", paged=True,
      kv_block_size=16`` serves 16 requests that share a 256-token prefix
      (tails 64/200/255 tokens): reuse_matmul, paged_decode_attention,
      and flash_attention on the wave with no prefix hit.
   c. LoRA on the reuse pipeline: the run-a engine with ``impl="reuse",
      fuse_qkv=True`` and an adapter registry of four rank-16 adapters
      (``LoRAConfig()``, A and B from numpy seeds, carried in by
      ``bridge.registry_from_numpy``) serves run a's prompts, the
      requests cycling base/a0/a1/a2/a3: reuse_matmul, decode_attention,
      flash_attention.
   d. NF4 reuse: the run-a engine with ``impl="reuse", quant_bits=4,
      quant_mode="codebook"`` (packed NF4, per channel) serves run a's
      prompts: reuse_matmul (prefill on the codebook route of its
      tensor-core path, one launch per projection and wave; decode on
      ``.gemv``, one per projection and step), decode_attention,
      flash_attention.
   e. overload + chunked prefill: the run-a engine with ``paged=True,
      kv_block_size=16, prefill_budget=1024`` and 111 usable pool blocks
      (the pager takes no pool below 514 blocks here, so the rest is held
      outside the engine for the whole run) serves 24 requests on run a's
      prompt cycle, 20 up front and 4 at priority 1 after the second step;
      request 1 streams through ``on_token``, request 4 raises
      ``StopStream`` after 10 tokens, request 19 is cancelled while
      queued. It requires every request to finish once as planned,
      preemptions for priority and for the pool with as many restores,
      each fast restore's KV bit-equal to its KV at swap-out, more
      chunks than waves with a continuation, no step above the budget,
      the pager consistent after every step and empty at the end, every
      ``axllm_matmul`` launch on ``.wgmma`` or ``.gemv``,
      ``paged_decode_attention`` and ``flash_attention.wgmma``, and the
      token gate on every generated token. It prints TTFT p50 / p99 and
      the largest step beside an unloaded engine of the same kernels
      (default pool, no budget) and the greedy-token agreement with it,
      and profiles a step that holds a continuation chunk (the plain
      ``prefix_attention``'s device share, annotated and replayed).
   f. speculative dense: run a's engine and prompts with ``speculate=True,
      spec_k=4, draft_bits=4, draft_mode="affine"`` (a packed-int4 draft
      derived from the raw weights, its decode on ``axllm_matmul.gemv``):
      axllm_matmul, decode_attention, flash_attention.
   g. speculative paged reuse: run b's engine and prompts with
      ``speculate=True, spec_k=8, draft_bits=8, draft_mode="shiftadd"``
      (the shift-add reparameterization, dense float32: its projections
      are plain products; its host seconds are printed): reuse_matmul,
      paged_decode_attention (verify), decode_attention (the draft's
      dense cache), flash_attention.
   Runs f and g require each request's tokens to equal run a's (run b's)
   from this call, exactly, every emitted token past the prefill's to
   have come from a round, every quantized-matmul launch on ``.wgmma`` or
   ``.gemv``; run g also the pager's books after every step and only the
   published prefixes in use at drain. Each prints tok/s, the acceptance
   rate, accepted tokens per step, rounds, launches per entry point and
   the device-busy and idle share of 4 profiled rounds, split into the
   draft and verify halves.
   Runs a to d each require its matmul's and flash attention's
   tensor-core paths (``<kernel>.wgmma``) to have launched in its prefill
   waves (every flash launch on the tensor cores) and its matmul's decode
   kernel (``<kernel>.gemv``) in its decode steps (every matmul launch
   one of the two), holds its first wave's logits against the plain path,
   holds every generated token to the token gate (``serve/token_gate.py``: the
   plain path's teacher-forced logit of the token within 2 x the logits
   tolerance of the plain maximum, at every position), profiles 4
   decode chunks for the device's idle share and its first wave's
   prefill for its device time (flash attention's share), serves the same
   requests through the plain path for greedy-token agreement. Run b also
   holds the first-token logits of its first prefix-hit wave, as served
   (prefix KV gathered out of the pool, suffix-only prefill), against a
   plain dense prefill of the whole prompts; runs b, c and d read the
   reuse rate the kernel achieves on each projection of layer 0 (run d
   on the decode and the prefill path, each count held against
   ``reuse_mult_count``). Run c also
   requires each adapter row's first-wave logits to differ from the same
   prompt's base logits by more than the tolerance.
6. Simulator phase: the paper's cycle model (``core.simulator``) on run
   b's served int8 codes, 7 matrices a layer: each one's multiply count
   from the
   reuse kernel (M 8, segment 256) must equal ``simulate_matrix(codes,
   SimConfig(), tokens=8).mults``; prints the computation reduction,
   simulated speedup and ``energy.power_report`` reduction, the cycle
   model's figures for the paper's accelerator, not card time.
7. Chaos phase: ``repro_torch.serve.chaos.run(smoke=True, device="cuda")``,
   the eight scenarios on the harness's own f32 model through the kernels:
   no request lost, no block or pin leaked, the pager consistent after
   every step, and a request whose tokens differ from the card's own
   fault-free run printed and held to the token gate; speculation_storm
   must inject faults, preempt a speculating slot, restore none fast and
   give every request the fault-free target-only run's tokens.
8. Runs h (moe) and i (vlm): qwen2-moe-a2.7b and chameleon-34b at full
   width, each cut to 2 layers (the cut printed), serve run a's requests
   as run a does (its checks: launches on ``.wgmma`` / ``.gemv``, the
   token gate, first-wave logits, greedy agreement, profiles split into
   attention, quantized matmul, expert products and the rest, peak
   memory at init and beside a quantized copy). Run h's gate replays the
   serving schedule with the served expert choices, recorded from a
   second serving that must repeat the first bit for bit, and holds each
   choice to the routing gate; it also prints the share of layer 0's
   (token, choice) pairs its first wave dropped at capacity. Runs j (ssm)
   and k (hybrid): xlstm-1.3b (float32, ``impl="auto"``; cut to 8 of its
   48 layers, one super-block) and zamba2-1.2b (bf16, ``impl="reuse"``;
   cut to 14 of its 38 layers: 2 attention sites and the 2 remainder
   Mamba2 layers the whole model has), the cuts printed, both
   at full width, serve run a's
   requests the same way, their waves split into equal-length sub-waves;
   their profiles label the recurrent mixers' kernels apart
   (``recurrent_mixer``); run j's tile-kernel launches must be exactly
   its f32 projections' and it prints why it serves in float32 (the bf16
   model's plain path against itself and the kernel path against it, and
   the same in float32); run k prints the counted reuse rate of its
   shared block's projections.
9. Run l (audio): whisper-small at full width and full depth (12
   encoder and 12 decoder layers, bf16, int8 per channel; the encoder and
   prefill streams float32 as in the reference) through the model API and
   ``serve/decode.decode_steps`` (the reference serves no audio model
   through its engine): 16 requests in two waves of 8, each a ragged
   prefill of decoder prompts cycling 16/64/200 tokens over its own frames
   [1500, 80] (f32 from a seed, the stub frontend's input), then greedy
   decode chunks of 8 until 64 tokens a request, in a 448-token cache.
   Its launches must be exactly ``audio_launches`` (encoder and prefill
   projections on the f32 tile kernel, decode projections on ``.gemv``,
   every flash call on the SIMT kernel, two decode attentions a layer a
   step), every token must pass the token gate on its own frames, and the
   first wave's logits must lie within the tolerance of the plain path's;
   it prints tok/s, prefill wall time, an encoder pass's, a prefill wave's
   and 4 decode chunks' device time by kind with the idle share and peak
   memory. Its kernel rows (the
   f32 tile kernel at M12000 with the frontend's K80, ``.gemv`` at the
   decode MLP, flash non-causal over 1500 frames and at Sq 200 > Sk 64,
   decode attention over the 1500 cross K/V and the 448-token self cache)
   come after the zero-row check.
10. Launcher phase: a checkpoint of full-width repro-100m (the port's
   init from seed 1 and its AdamW state) written by
   ``train/checkpoint.save``, then ``python -m repro_torch.launch.serve
   --ckpt <dir> --slots 8 --max-len 1024 --requests 16 --max-new 64
   --prompt-lens 64,200,511 --stats`` as a subprocess on the card, plain
   and with ``--reuse --paged``: each must exit 0, print "restored step
   7" and print the token lines and stats of
   ``repro_torch.launch.serve.main`` run in process on the card with the
   same flags, whose launches (counted from 0 just before it) must
   include every kernel of its mode. A third run adds ``--mesh-shape 2``
   and a fourth ``--mesh-shape 2x2``: the launcher spawns two (four)
   ranks on the card (gloo), restores every leaf the layout cuts onto
   them, and must print the ``, mesh 2`` (``, mesh 2x2``) tag and the
   token lines and stats of the launcher's rank body (what ``serve.main``
   runs on each rank it spawns) run with the same flags in run n's (run
   q's) spawn, every rank the same tokens; its launches are rank 0's.
   The subprocesses run one after another on a lane beside the main
   thread (``CliLane``) from the in-process runs on; run q starts once
   they have ended, and their checks follow it.
10b. Tensor-parallel serving, ranks sharing the one card over gloo (the
   kernels on the card, the collectives through the host: correctness,
   not a tensor-parallel rate). Run n: full-width repro-100m at runs a
   to g's depth at mesh 1x2 (head-sharded: a rank holds 6 q and 2 KV
   heads), int8 per channel, serving run a's requests plainly, run b's
   with ``impl="reuse", paged=True`` and run c's with ``impl="reuse",
   fuse_qkv=True`` and its adapters. Run o: glm4-9b at full width cut to
   4 of 40 layers (the cut printed) at mesh 1x4, sequence-sharded (2 KV
   heads do not divide 4: wk/wv whole, the dense cache cut along its
   rows, decode through ``kernels.sharded_decode``), run a's requests;
   its ranks spawn beside run n's (``start_mesh``). Both serve
   ``MESH_MAX_NEW`` tokens a request, and each rank's engine quantizes
   only its own blocks: the engine's memory by rank is printed beside the
   single-card engine's. Each rank's launch
   counts are set to 0 just before it serves and read just after; every
   rank must serve rank 0's tokens and stats and launch the mode's kernels
   at its shapes; every token must pass the token gate on the unsharded
   model; the share of tokens equal to runs a's and b's (of run n's
   depth) is printed. Their
   kernel rows (the rank shapes no earlier row has: both quantized matmuls
   at repro-100m's model-2 blocks, axllm_matmul at glm4-9b's model-4
   blocks and its head's quarter, decode attention at 6/2 heads, flash at
   6/2 heads of 64 and 8/1 of 128) follow the backward kernel's.
   Run p, one spawn at mesh 1x2 serving in turn (each freed before the
   next): qwen2-moe-a2.7b at full width cut to 6 of 24 layers,
   int8, expert-parallel (a rank holds 32 of the 64 padded experts; rank
   0 records the served expert choices, and the moe gate replays the
   serving schedule with them); zamba2-1.2b cut to 14 of 38 layers (2
   shared-attention sites and the 2 remainder layers), bf16,
   ``impl="reuse"``; xlstm-1.3b cut to 8 of 48, float32, as run j;
   each on run a's requests. Run q, one spawn at mesh 2x2: full-width,
   full-depth repro-100m serving run a's requests (int8; a data
   rank runs 4 of the 8 slots' rows) and run b's (reuse + paged, whose
   pool and rows are whole on each data rank; its prefix hits must equal
   run b's), then the module phase: ``decode_attention_seqsharded`` with
   batch axes ("data",) and sequence axes ("model",), then with the batch
   whole and the sequence over ("model", "data") (the long-context
   cells' rule), at glm4-9b's layer (B8 S1024 H32 Hk2 d128, bf16
   and int8 KV), each rank's rows held against the single-card
   ``decode_attention`` kernel on the same rows, its call, its local
   part and the kernel timed. Runs p and q hold what n and o hold, print
   each rank's slot rows, and run q checks them. Their kernel rows (run
   p's rank blocks at model 2, run q's at a data rank's M4, and their
   decode and flash layouts) follow run o's.
11. Training. The flash backward kernel (``csrc/flash_attention_bwd.cu``,
   no TPU counterpart) against its plain version
   ``ref.flash_attention_bwd_ref`` (dQ, dK, dV) at run m's layer (B8 S256
   H12 Hk4 d64 causal, bf16 and f32), at B8 S512 d128 with H16/Hk16,
   H64/Hk8 and H32/Hk2, at f32 H4/Hk2 d16, at whisper's non-causal Sq200
   over Sk1500 and Sk64 and at ragged causal 200 and 511; each with its
   error, tolerance, time, bound, the plain version's time and SDPA's
   backward (``enable_gqa``), and a second launch bit-equal. Run m:
   step 1's gradients through the kernels against the plain path on the
   card (bf16 at full depth, f32 on a 2-layer cut), then
   ``repro_torch.launch.train.main`` in process (``--arch repro-100m
   --batch 8 --seq 256 --steps 40 --lr 1e-3 --save-every 10 --ckpt
   <dir>``: full width and depth, bf16, remat), launches counted from 0:
   flash forward exactly 40 x 12 x 2 (remat), all on ``.wgmma``, the
   backward 40 x 12, the mean loss of the last 5 steps 0.5 nat below step
   1's; a second run with a failure injected at step 25 restores step 20
   and ends bit-equal to the first (every parameter and moment). It
   prints tokens a second, the median step, peak memory and 4 profiled
   steps split into flash forward, flash backward, matmuls, optimizer and
   the rest. Then ``python -m repro_torch.launch.train`` with the same
   flags as a subprocess must print the JAX launcher's lines, and
   ``python -m repro_torch.launch.serve --ckpt <its dir> --reuse --paged``
   must restore its step 40. These two subprocesses run on a second
   lane beside runs n to p, and are checked before run q.
11b. Run s: the moe, ssm, hybrid and audio families trained on a 2x2
   mesh, four ranks sharing the card over gloo, in one spawn (a
   subprocess on a lane): ``launch.train``'s rank body (``train_ranks``)
   on qwen2-moe-a2.7b cut to 1 of 24 layers (bf16, expert-parallel: a
   rank holds 32 of the 64 padded experts), xlstm-1.3b cut to 8 of 48
   (one super-block, float32 as run j serves it), zamba2-1.2b cut to 14
   of 38 (2 shared-attention sites and the 2 remainder layers, bf16) and
   whisper-small at full depth (bf16 weights, float32 streams), each at
   full width, B8 S256, 4 steps, grad_accum 1 (a rank's 4 rows), seed 0,
   in turn and each freed before the next (the cuts printed). Once the
   spawn has ended, the same subprocess trains each family on one card
   with the same flags (``launch.train.main`` in process). Every rank
   must print the same lines, each step's loss must lie within
   ``MESH_TRAIN_LOSS_TOL`` of one card's (``MESH_FAMILY_F32_TOL`` for
   float32 xlstm), a rank must hold exactly its ``param_specs`` blocks
   (its share printed beside the predicted one, and its peak memory),
   and its flash forward and backward launches must be exactly its
   attention layers' (remat counted: the moe's 1, zamba2's 2 sites,
   whisper's 12 encoder, 12 self and 12 cross; xlstm none). The moe
   run's checkpoint of step 4 restores on one card with every leaf
   bit-equal to the ranks' blocks. Its kernel rows (flash forward and
   backward at a rank's layer: the moe's B4 S256 H8 d128, zamba2's H16
   d64, whisper's float32 encoder S1500, cross Sq256 Sk1500 and self
   S256 at H6) follow run r's.
11c. The dry run (``launch.dryrun``; after the kernel phases): one
   rank's decode step of runs a-g's model (2 layers, int8, B8 over a
   1024-position cache, a (1, 1) mesh) counted on the meta device; its
   counted argument bytes must equal what the same parameters, cache and
   token take on the card (``torch.cuda.memory_allocated()``) within 1%;
   its counted temp bytes and roofline bound are printed beside a real
   step's added peak and its device time. Run q's module phase holds the
   sequence cut over ("model", "data") (above). On a lane, after run r's
   failure-injected run: ``python -m repro_torch.launch.dryrun --cells
   zamba2-1.2b:long_500k,qwen2-moe-a2.7b:decode_32k`` (full configs, rank
   0 of the 16 x 16 production mesh over a fake process group, no
   accelerator) must exit 0 with both cells ``ok``; it is checked after
   run s, and its figures printed.
12. Prints the ``kernels`` JSON line (each kernel's launches in runs f and
   g, in runs h to l, in the launcher phase's in-process ``serve.main``
   runs, in runs n to q (rank 0), in run m, in run r and in run s by
   family (rank 0), beside its main run's; the backward kernel's row
   from run m), then the result line.

Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 and f32 FLOP/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

N_SLOTS, MAX_LEN, DECODE_CHUNK = 8, 1024, 8
# runs a to g and n serve full-width repro-100m cut to this many of its 12
# layers (chip time: the script must end well within its 1200 s limit; 4
# until run s's 185-254 s took the script to 812-980 s)
E2E_LAYERS = 2
PROMPT_LENS, N_REQUESTS, MAX_NEW = (64, 200, 511), 16, 64
SHARED_PREFIX, TAIL_LENS, KV_BLOCK = 256, (64, 200, 255), 16
ADAPTERS = ("a0", "a1", "a2", "a3")   # run c: requests cycle base + these
LORA_B_STD = 0.01       # run c: B ~ N(0, 0.01^2), A ~ N(0, 1/r)
FUSED = ((768, 1280), (768, 4096))    # K x N of wqkv and gate_up
# the codebook route's kernel phase: the 7 projections' K x N and the fused
# ones at a prefill wave's M, NF4 (packed) and identity-8, per channel and
# in groups of 128 rows
CODEBOOK_SHAPES = ((768, 2048), (768, 768), (768, 256), (2048, 768)) + FUSED
THRESHOLD_M = (1, 8, 16, 32, 48, 64, 96, 128, 256)  # paths timed at each
GEMV_M = (1, 8, 16)     # where the decode kernels are timed as well
# flash kernel phase: (B, Sq, Sk, causal, head dim)
FLASH_CASES = ((N_SLOTS, 512, 512, True, 64), (2, 256, 1024, True, 64),
               (2, 256, 1024, False, 64), (N_SLOTS, 512, 512, True, 128))
LOGIT_TOL = 5e-2        # |kernel - plain| / scale: bf16 transformers and
                        # zamba2 (20 layers), float32 xlstm (8 layers)
F32_LOGIT_TOL = 1e-4    # the same for run l's float32 prefill logits (read
                        # at 1.3e-6 of the scale on the H100, PERF.md)
SPIN_CYCLES = 4_000_000  # ~2 ms of device spin ahead of each timed launch
# run e (overload + chunked prefill): 24 requests on run a's prompt cycle,
# the last 4 at priority 1 after the second step; 111 usable pool blocks
# against the 147 eight seated requests hold by their last step (the pager
# takes no pool below 8 x 64 + 2 = 514 blocks, so the engine gets that and
# the rest is held outside it for the whole run, as the chaos harness's
# BlockThief holds blocks); a prefill budget a step; request 1 streams,
# request 4 hangs up after 10 tokens, request 19 is cancelled while queued
E_REQUESTS, E_LATE, E_USABLE, E_BUDGET = 24, 4, 111, 1024
E_STREAM, E_HANGUP, E_HANGUP_AFTER, E_CANCEL = 1, 4, 10, 19


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


class CliLane:
    """Command lines of the launcher phases, run one after another in a
    background thread beside the main thread's runs (they check what the
    entry points print, not how fast). Each runs in a session of its own
    (a mesh launcher's spawned ranks with it), with ``src`` on the path
    and a time limit of ``timeout`` seconds. ``result(label)`` waits for
    a job and gives (exit code, stdout, stderr, wall s); ``stop()`` kills
    the one running, its ranks included, and runs no other."""

    def __init__(self, timeout: float = 600.0):
        import queue
        import threading
        self._jobs = queue.Queue()
        self._done = {}
        self._cv = threading.Condition()
        self._proc = None
        self._stopped = False
        self._timeout = timeout
        threading.Thread(target=self._loop, daemon=True).start()

    def submit(self, label, argv) -> None:
        self._jobs.put((label, list(argv)))

    def _loop(self):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        while True:
            label, argv = self._jobs.get()
            t0 = time.perf_counter()
            with self._cv:
                if self._stopped:
                    return
                try:
                    self._proc = proc = subprocess.Popen(
                        argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                        stderr=subprocess.PIPE, text=True,
                        start_new_session=True)
                except OSError as e:
                    proc = None
                    rc, out, err = None, "", f"did not start: {e}"
            if proc is not None:
                try:
                    out, err = proc.communicate(timeout=self._timeout)
                    rc = proc.returncode
                except subprocess.TimeoutExpired:
                    self._kill(proc)
                    out, err = proc.communicate()
                    rc, err = None, f"timed out after {self._timeout} s\n{err}"
            with self._cv:
                self._done[label] = (rc, out, err, time.perf_counter() - t0)
                self._cv.notify_all()

    @staticmethod
    def _kill(proc):
        import signal
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass

    def result(self, label) -> tuple:
        with self._cv:
            self._cv.wait_for(lambda: label in self._done)
            return self._done[label]

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            if self._proc is not None and self._proc.poll() is None:
                self._kill(self._proc)


def time_ms(fn, flush, iters: int = 20) -> float:
    """Median device time of ``fn`` in ms from CUDA events. Before each
    launch the L2 cache is flushed (the serving path finds it cold: twelve
    layers of weights and KV exceed its 50 MB) and a spin kernel keeps the
    card busy while the host enqueues ``fn``, so the events bracket device
    work and not the host's launch overhead."""
    import torch
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


MIXER_LABEL = "recurrent_mixer"


def annotated(label, names):
    """Within the block every call of the functions ``names`` ((module,
    attribute) pairs) runs inside ``record_function(label)``, so a profile
    can tell the kernels they launch apart."""
    import contextlib
    from torch.profiler import record_function

    def wrap(fn):
        def wrapped(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return wrapped

    @contextlib.contextmanager
    def block():
        orig = [(mod, name, getattr(mod, name)) for mod, name in names]
        for mod, name, fn in orig:
            setattr(mod, name, wrap(fn))
        try:
            yield
        finally:
            for mod, name, fn in orig:
                setattr(mod, name, fn)
    return block()


def annotated_mixers():
    """Every recurrent mixer call (Mamba2, mLSTM, sLSTM, forward and step)
    inside ``record_function(MIXER_LABEL)``."""
    from repro_torch.models import ssm as S
    from repro_torch.models import xlstm as X
    return annotated(MIXER_LABEL, (
        (S, "mamba2_fwd"), (S, "mamba2_step"), (X, "mlstm_fwd"),
        (X, "mlstm_step"), (X, "slstm_fwd")))


def device_busy_ms(fn, mixers: bool = False, annotation=None) -> tuple:
    """(wall ms, device-busy ms, device ms of every kernel by name, the
    largest first) of ``fn`` under torch.profiler: the busy time is the
    sum of the card's kernel, memcpy and memset durations (one stream, so
    they do not overlap). With ``mixers`` a fourth item: the device ms by
    kernel name of the kernels launched inside a recurrent mixer
    (``annotated_mixers``), found by the host time range of the op that
    launched each; with ``annotation`` ((label, names), as ``annotated``
    takes them) the same for the calls it names."""
    import bisect
    import contextlib
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    label = MIXER_LABEL
    block = contextlib.nullcontext()
    if mixers:
        block = annotated_mixers()
    elif annotation is not None:
        label, block = annotation[0], annotated(*annotation)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, block:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        # a record_function range shows on the device timeline too: it is
        # no device work
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    if not mixers and annotation is None:
        return wall, sum(by_name.values()), top
    # the labelled ranges do not nest, so sorted starts and ends bracket
    # them
    ranges = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name == label
                    and e.device_type == DeviceType.CPU)
    starts = [a for a, _ in ranges]
    in_mixer = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i < 0 or e.time_range.end > ranges[i][1]:
            continue
        for k in e.kernels:
            in_mixer[k.name] = in_mixer.get(k.name, 0.0) + k.duration / 1e3
    return wall, sum(by_name.values()), top, in_mixer


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def path_of(m, x, qt) -> str:
    """The kernel a quantized-matmul call of this shape and type takes:
    "wgmma", "gemv" (the split-K decode kernel) or "tile"."""
    from repro_torch.kernels.axllm_matmul import matmul_path
    return matmul_path(m, x.dtype, qt, x.data_ptr() % 16 == 0)


def gemv_checks(name, x, qt, got, call, reuse) -> dict:
    """A split-K decode kernel's result ``got`` (f32) of ``call(dtype)``
    against its split emulation (within 1e-5 of the output scale), a
    second launch (the same bits) and its bf16 output (the f32 output
    rounded to nearest even)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.axllm_matmul import gemv_buffers
    plan = gemv_buffers(x, qt, torch.cuda.current_stream(x.device)
                        .cuda_stream, reuse)[0]
    emu = ref.quant_gemv_split_ref(x, qt, plan, reuse)
    err = float((got - emu).abs().max())
    tol = 1e-5 * max(1.0, float(emu.abs().max()))
    same = torch.equal(call(torch.float32), got)
    rne = torch.equal(call(torch.bfloat16), got.to(torch.bfloat16))
    print(f"kernel {name} [gemv] M{x.shape[0]} K{qt.shape[0]} "
          f"N{qt.shape[1]}: err vs its split emulation {err:.3e} (tol "
          f"{tol:.3e}); {plan.blocks} blocks ({plan.n_tiles} column x "
          f"{plan.m_tiles} M x {plan.splits} K splits of "
          f"{plan.k_per_split}); second launch identical {same}; bf16 out "
          f"= f32 out rounded {rne}", flush=True)
    check(err <= tol, f"{name} differs from its split emulation by {err}")
    check(same, f"{name}: a second launch gave other bits")
    check(rne, f"{name}: bf16 output is not the f32 output rounded")
    return dict(emulation_err=err, blocks=plan.blocks, splits=plan.splits)


def split_err(got, emu, name) -> float:
    """A split-KV decode kernel against its emulation (the same splits):
    within one bf16 rounding of the output (2^-8 of its scale)."""
    err = float((got.float() - emu.float()).abs().max())
    tol = 2.0 ** -8 * max(1.0, float(emu.float().abs().max()))
    print(f"kernel {name}: err vs its split emulation {err:.3e} "
          f"(tol {tol:.3e})", flush=True)
    check(err <= tol, f"{name} differs from its split emulation by {err}")
    return err


def case_row(name, shape, err, tol, ms, plain_ms, lib_ms, nb, flops, dtype,
             path=None):
    bound_ms, bound_by = bound(nb, flops, dtype)
    row = dict(kernel=name, shape=shape, max_abs_err=err, tolerance=tol,
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=lib_ms, path=path)
    print(f"kernel {name}{'' if path is None else f' [{path}]'} {shape}: "
          f"err {err:.3e} (tol {tol:.3e}) "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}), library "
          f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}", flush=True)
    check(err <= tol, f"{name} {shape} error {err} > tolerance {tol}")
    return row


def kernel_phase(dev, flush):
    import torch
    import torch.nn.functional as F
    from repro_torch.core.quantization import QuantConfig, dequantize, \
        quantize
    from repro_torch.kernels import ref
    from repro_torch.kernels import _build
    from repro_torch.kernels import axllm_matmul
    from repro_torch.kernels.axllm_matmul import axllm_matmul_cuda
    from repro_torch.kernels.decode_attention import decode_attention_cuda, \
        split_plan

    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    rows = []

    # -- axllm_matmul: the 7 projections at decode M = n_slots, one prefill
    mm_cases = [(8, 768, 768, QuantConfig(8)), (8, 768, 256, QuantConfig(8)),
                (8, 768, 2048, QuantConfig(8)), (8, 2048, 768, QuantConfig(8)),
                (4096, 768, 2048, QuantConfig(8)),
                (4096, 2048, 768, QuantConfig(8)),
                (8, 768, 2048, QuantConfig(4, "affine", pack=True)),
                (8, 768, 2048, QuantConfig(8, "affine", "per_group")),
                (8, 768, 2048, QuantConfig(4, "codebook", pack=True))]
    mm_cases += [(m, k, n, QuantConfig(8)) for m in (N_SLOTS, 4096)
                 for k, n in FUSED]
    mm_cases += [(4096, 768, 2048, qc) for qc in (   # the prefill path
        QuantConfig(8, "affine", "per_group"),
        QuantConfig(4, "affine", pack=True))]
    for m, k, n, qc in mm_cases:
        x = torch.randn(m, k, generator=g, device=dev).to(bf16)
        qt = quantize(torch.randn(k, n, generator=g, device=dev) * k ** -0.5,
                      qc)
        want = ref.axllm_matmul_ref(x, qt)
        got = axllm_matmul_cuda(x, qt)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        w_deq = dequantize(qt, bf16)
        ms = time_ms(lambda: axllm_matmul_cuda(x, qt), flush)
        plain = time_ms(lambda: ref.axllm_matmul_ref(x, qt), flush)
        lib = time_ms(lambda: torch.matmul(x, w_deq), flush)
        nb = nbytes(x, qt.codes, qt.kernel_scale, got)
        shape = f"M{m} K{k} N{n} {qc.bits}b-{qc.mode}-{qc.granularity}"
        path = path_of(m, x, qt)
        row = case_row("axllm_matmul", shape, err, tol, ms, plain, lib, nb,
                       2.0 * m * k * n, "bfloat16", path)
        if path == "gemv":   # beside it: its checks and the tile kernel
            row.update(gemv_checks(
                "axllm_matmul", x, qt, got,
                lambda dt: axllm_matmul_cuda(x, qt, dt), False))
            row["tile_ms"] = time_ms(lambda: axllm_matmul.launch(
                x, qt, torch.float32, "tile"), flush)
            print(f"kernel axllm_matmul [tile] {shape}: {row['tile_ms']:.4f}"
                  " ms", flush=True)
        rows.append(row)

    # -- decode_attention: one decode step of the 8 slots, S = max_len
    b, s, h, hk, d = N_SLOTS, MAX_LEN, 12, 4, 64
    length = torch.tensor([0, 64, 200, 511, 700, 1000, s, s + 300],
                          dtype=torch.int32, device=dev)
    valid = torch.clamp(length, 0, s)
    q = torch.randn(b, h, d, generator=g, device=dev).to(bf16)
    mask = (torch.arange(s, device=dev)[None, :] < valid[:, None])[:, None,
                                                                     None]
    for quant in (False, True):
        if quant:
            kc = torch.randint(-127, 128, (b, s, hk, d), generator=g,
                               device=dev, dtype=torch.int8)
            vc = torch.randint(-127, 128, (b, s, hk, d), generator=g,
                               device=dev, dtype=torch.int8)
            ks = torch.rand(b, s, hk, 1, generator=g, device=dev) * 0.02
            vs = torch.rand(b, s, hk, 1, generator=g, device=dev) * 0.02
            per_key = hk * (2 * d + 2 * 4)
        else:
            kc = torch.randn(b, s, hk, d, generator=g, device=dev).to(bf16)
            vc = torch.randn(b, s, hk, d, generator=g, device=dev).to(bf16)
            ks = vs = None
            per_key = hk * 2 * d * 2
        want = ref.decode_attention_ref(q, kc, vc, length, ks, vs)
        got = decode_attention_cuda(q, kc, vc, length, ks, vs)
        torch.cuda.synchronize()
        check(int(torch.count_nonzero(got[0])) == 0,
              "decode_attention: a length-0 row is not exactly 0")
        err = float((got.float() - want.float()).abs().max())
        tol = 2.0 ** -7 * max(1.0, float(want.float().abs().max()))
        split_err(got, ref.decode_attention_split_ref(
            q.float(), kc, vc, length, ks, vs,
            *split_plan(s, b * hk, _build.sm_count(dev))), "decode_attention")
        ms = time_ms(lambda: decode_attention_cuda(q, kc, vc, length, ks, vs),
                     flush)
        plain = time_ms(lambda: ref.decode_attention_ref(q, kc, vc, length,
                                                         ks, vs), flush)
        lib = None
        if not quant:   # one library call computes the dense case
            qs, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qs, kt, vt, attn_mask=mask, enable_gqa=True), flush)
        n_keys = int(valid.sum())
        nb = nbytes(q, length, got) + n_keys * per_key
        shape = f"B{b} S{s} H{h} Hk{hk} d{d} {'int8' if quant else 'bf16'}-kv"
        rows.append(case_row("decode_attention", shape, err, tol, ms, plain,
                             lib, nb, 4.0 * n_keys * h * d, "bfloat16"))

    # -- flash_attention: the prefill wave (8 x 512), Sq < Sk and the wave
    # at head dim 128; the wrapper's own choice (the tensor-core kernel,
    # also held against its emulation) and the SIMT kernel
    from repro_torch.kernels import flash_attention as fa
    for b, sq, sk, causal, dd in FLASH_CASES:
        q = torch.randn(b, sq, h, dd, generator=g, device=dev).to(bf16)
        k = torch.randn(b, sk, hk, dd, generator=g, device=dev).to(bf16)
        v = torch.randn(b, sk, hk, dd, generator=g, device=dev).to(bf16)
        want = ref.attention_ref(q, k, v, causal)
        tol = 2.0 ** -7 * max(1.0, float(want.float().abs().max()))
        check(fa.tensor_core_path(q), "bf16 attention does not take the "
                                      "tensor-core path")
        emu = ref.flash_attention_tc_ref(q.float(), k.float(), v.float(),
                                         causal)
        qt_, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        amask = None
        if causal:      # queries sit at the last sq key positions
            amask = (torch.arange(sq, device=dev)[:, None] + sk - sq
                     >= torch.arange(sk, device=dev)[None, :])
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt_, kt, vt, attn_mask=amask, enable_gqa=True), flush)
        plain = time_ms(lambda: ref.attention_ref(q, k, v, causal), flush)
        pairs = sum(min(sk, i + sk - sq + 1) for i in range(sq)) if causal \
            else sq * sk
        shape = f"B{b} Sq{sq} Sk{sk} H{h} Hk{hk} d{dd} " \
                f"{'causal' if causal else 'full'}"
        for path, call in (
                ("wgmma", lambda: fa.flash_attention_cuda(q, k, v, causal)),
                ("simt", lambda: fa.launch(q, k, v, causal, False))):
            got = call()
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            ms = time_ms(call, flush)
            row = case_row("flash_attention", shape, err, tol, ms, plain, lib,
                           nbytes(q, k, v, got), 4.0 * b * h * dd * pairs,
                           "bfloat16", path)
            if path == "wgmma":
                emu_err = float((got.float() - emu).abs().max())
                emu_tol = 2.0 ** -8 * max(1.0, float(emu.abs().max()))
                print(f"kernel flash_attention [wgmma] {shape}: err vs its "
                      f"emulation {emu_err:.3e} (tol {emu_tol:.3e})",
                      flush=True)
                check(emu_err <= emu_tol, f"flash_attention {shape} differs "
                                          f"from its emulation by {emu_err}")
                row.update(emulation_err=emu_err)
            rows.append(row)
    return rows


def reuse_paged_kernel_phase(dev, flush):
    """The two kernels of the reuse + paged path: reuse_matmul at the 7
    projections' K x N (decode M = n_slots and a prefill wave of 8 x 512
    rows) and in every alphabet, paged_decode_attention at one decode
    step of the 8 slots through shuffled, shared block tables."""
    import torch
    from repro_torch.core.quantization import QuantConfig, dequantize, \
        quantize
    from repro_torch.kernels import ref
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import split_plan
    from repro_torch.kernels import reuse_matmul
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention_cuda
    from repro_torch.kernels.reuse_matmul import reuse_matmul_cuda, segment

    g = torch.Generator(device=dev).manual_seed(1)
    bf16 = torch.bfloat16
    rows = []
    int8 = QuantConfig(8)
    shapes = [(768, 768), (768, 256), (768, 2048), (2048, 768)]
    cases = [(m, k, n, int8) for m in (N_SLOTS, 4096)
             for k, n in shapes + list(FUSED)]
    cases += [(N_SLOTS, 768, 2048, QuantConfig(4, "affine", pack=True)),
              (N_SLOTS, 768, 2048, QuantConfig(8, "affine", "per_group")),
              (N_SLOTS, 768, 2048, QuantConfig(4, "codebook", pack=True))]
    cases += [(4096, 768, 2048, qc) for qc in (      # the prefill path
        QuantConfig(8, "affine", "per_group"),
        QuantConfig(4, "affine", pack=True))]
    for m, k, n, qc in cases:
        x = torch.randn(m, k, generator=g, device=dev).to(bf16)
        qt = quantize(torch.randn(k, n, generator=g, device=dev) * k ** -0.5,
                      qc)
        want = ref.reuse_matmul_ref(x, qt)
        got, mults = reuse_matmul_cuda(x, qt, with_stats=True)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        count = ref.reuse_mult_count(qt, segment(n))
        rate = 1.0 - int(mults) / (k * n)
        shape = f"M{m} K{k} N{n} {qc.bits}b-{qc.mode}-{qc.granularity}"
        print(f"kernel reuse_matmul {shape}: mults {int(mults)} "
              f"(reuse_mult_count {count}), reuse rate {rate:.4f}",
              flush=True)
        check(int(mults) == count, f"reuse_matmul {shape} counted "
                                   f"{int(mults)} multiplies, not {count}")
        w_deq = dequantize(qt, bf16)
        ms = time_ms(lambda: reuse_matmul_cuda(x, qt), flush)
        plain = time_ms(lambda: ref.reuse_matmul_ref(x, qt), flush)
        lib = time_ms(lambda: torch.matmul(x, w_deq), flush)
        nb = nbytes(x, qt.codes, qt.kernel_scale, got)
        path = path_of(m, x, qt)
        row = case_row("reuse_matmul", shape, err, tol, ms, plain, lib, nb,
                       2.0 * m * k * n, "bfloat16", path)
        if path == "gemv":   # beside it: its checks and the tile kernel
            row.update(gemv_checks(
                "reuse_matmul", x, qt, got,
                lambda dt: reuse_matmul_cuda(x, qt, out_dtype=dt)[0], True))
            row["tile_ms"] = time_ms(lambda: reuse_matmul.launch(
                x, qt, False, torch.float32, "tile"), flush)
            print(f"kernel reuse_matmul [tile] {shape}: {row['tile_ms']:.4f}"
                  " ms", flush=True)
        rows.append(dict(row, mults=int(mults), reuse_rate=rate))

    # one decode step of the 8 slots: tables shuffled over the pool, rows
    # sharing prefix blocks, a length-0 row and one past its table
    b, h, hk, d, bs, mb = N_SLOTS, 12, 4, 64, KV_BLOCK, MAX_LEN // KV_BLOCK
    nb_pool = 2 * N_SLOTS * mb + 2
    bt = (1 + torch.randperm(nb_pool - 1, generator=g, device=dev)[:b * mb])
    bt = bt.reshape(b, mb).to(torch.int32)
    bt[1:, :SHARED_PREFIX // bs] = bt[0, :SHARED_PREFIX // bs]
    length = torch.tensor([0, 320, 456, 511, 700, 1000, mb * bs,
                           mb * bs + 300], dtype=torch.int32, device=dev)
    valid = torch.clamp(length, 0, mb * bs)
    q = torch.randn(b, h, d, generator=g, device=dev).to(bf16)
    for quant in (False, True):
        if quant:
            kp = torch.randint(-127, 128, (nb_pool, bs, hk, d), generator=g,
                               device=dev, dtype=torch.int8)
            vp = torch.randint(-127, 128, (nb_pool, bs, hk, d), generator=g,
                               device=dev, dtype=torch.int8)
            ks = torch.rand(nb_pool, bs, hk, 1, generator=g, device=dev) * .02
            vs = torch.rand(nb_pool, bs, hk, 1, generator=g, device=dev) * .02
            per_key = hk * (2 * d + 2 * 4)
        else:
            kp = torch.randn(nb_pool, bs, hk, d, generator=g,
                             device=dev).to(bf16)
            vp = torch.randn(nb_pool, bs, hk, d, generator=g,
                             device=dev).to(bf16)
            ks = vs = None
            per_key = hk * 2 * d * 2
        want = ref.paged_decode_attention_ref(q, kp, vp, bt, length, ks, vs)
        got = paged_decode_attention_cuda(q, kp, vp, bt, length, ks, vs)
        torch.cuda.synchronize()
        check(int(torch.count_nonzero(got[0])) == 0,
              "paged_decode_attention: a length-0 row is not exactly 0")
        split_err(got, ref.paged_decode_attention_split_ref(
            q.float(), kp, vp, bt, length, ks, vs,
            *split_plan(mb * bs, b * hk, _build.sm_count(dev), bs)),
            "paged_decode_attention")
        err = float((got.float() - want.float()).abs().max())
        tol = 2.0 ** -7 * max(1.0, float(want.float().abs().max()))
        ms = time_ms(lambda: paged_decode_attention_cuda(
            q, kp, vp, bt, length, ks, vs), flush)
        plain = time_ms(lambda: ref.paged_decode_attention_ref(
            q, kp, vp, bt, length, ks, vs), flush)
        n_keys = int(valid.sum())
        # the bytes the function must move: each distinct pool entry the
        # valid positions read (rows share their prefix blocks), once, and
        # the table entries the rows need
        pos = torch.arange(mb * bs, device=dev)
        entry = bt.long()[:, pos // bs] * bs + pos % bs
        n_entries = int(torch.unique(
            entry[pos[None, :] < valid[:, None]]).numel())
        nbt = int(((valid + bs - 1) // bs).sum()) * 4
        nb = nbytes(q, length, got) + n_entries * per_key + nbt
        shape = f"B{b} H{h} Hk{hk} d{d} bs{bs} MB{mb} " \
                f"{'int8' if quant else 'bf16'}-kv"
        rows.append(case_row("paged_decode_attention", shape, err, tol, ms,
                             plain, None, nb, 4.0 * n_keys * h * d,
                             "bfloat16"))
    return rows


def codebook_kernel_phase(dev, flush):
    """The codebook route of the tensor-core path (each level three bf16
    terms) on both quantized matmuls at a prefill wave (M4096), for NF4
    (packed) and identity-8, per channel and per group of 128 rows, at
    ``CODEBOOK_SHAPES``: each row held against its plain version and the
    route's emulation ``ref.quant_gemm_ref`` (within 1e-5 of the output
    scale), its bf16 output against its f32 output rounded to nearest even,
    a second launch against the first (the same bits), and the reuse
    kernel's count against ``reuse_mult_count``; beside its time the plain
    version's, ``torch.matmul`` on the dequantized bf16 weights and the old
    tile kernel's (the route these calls took before)."""
    import torch
    from repro_torch.core.quantization import QuantConfig, dequantize, \
        quantize
    from repro_torch.kernels import axllm_matmul, ref, reuse_matmul
    from repro_torch.kernels.reuse_matmul import segment

    g = torch.Generator(device=dev).manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    m = 4096
    rows = []
    for qc in (QuantConfig(4, "codebook"),
               QuantConfig(4, "codebook", "per_group"),
               QuantConfig(8, "codebook"),
               QuantConfig(8, "codebook", "per_group")):
        for k, n in CODEBOOK_SHAPES:
            x = torch.randn(m, k, generator=g, device=dev).to(bf16)
            qt = quantize(torch.randn(k, n, generator=g, device=dev)
                          * k ** -0.5, qc)
            emu = ref.quant_gemm_ref(x, qt)
            w_deq = dequantize(qt, bf16)
            lib = time_ms(lambda: torch.matmul(x, w_deq), flush)
            shape = f"M{m} K{k} N{n} {qc.bits}b-{qc.mode}-{qc.granularity}"
            for name, plain_fn, call, tile in (
                    ("axllm_matmul", ref.axllm_matmul_ref,
                     lambda dt: axllm_matmul.launch(x, qt, dt, "wgmma"),
                     lambda: axllm_matmul.launch(x, qt, f32, "tile")),
                    ("reuse_matmul", ref.reuse_matmul_ref,
                     lambda dt: reuse_matmul.launch(x, qt, False, dt,
                                                    "wgmma")[0],
                     lambda: reuse_matmul.launch(x, qt, False, f32,
                                                 "tile")[0])):
                path = path_of(m, x, qt)
                check(path == "wgmma", f"{name} {shape} takes {path}")
                want = plain_fn(x, qt)
                got = call(f32)
                torch.cuda.synchronize()
                scale = max(1.0, float(want.abs().max()))
                err = float((got - want).abs().max())
                emu_err = float((got - emu).abs().max())
                same = torch.equal(call(f32), got)
                rne = torch.equal(call(bf16), got.to(bf16))
                check(emu_err <= 1e-5 * scale, f"{name} {shape} differs "
                      f"from its emulation by {emu_err}")
                check(same, f"{name} {shape}: a second launch gave other "
                            "bits")
                check(rne, f"{name} {shape}: bf16 output is not the f32 "
                           "output rounded")
                extra = {}
                if name == "reuse_matmul":   # the count, on the served call
                    _, mults = reuse_matmul.launch(x, qt, True, bf16,
                                                   "wgmma")
                    count = ref.reuse_mult_count(qt, segment(n))
                    check(int(mults) == count, f"{name} {shape} counted "
                          f"{int(mults)} multiplies, not {count}")
                    extra = dict(mults=int(mults),
                                 reuse_rate=1.0 - int(mults) / (k * n))
                ms = time_ms(lambda: call(f32), flush)
                plain = time_ms(lambda: plain_fn(x, qt), flush)
                tile_ms = time_ms(tile, flush)
                row = case_row(name, shape, err, 1e-5 * scale, ms, plain,
                               lib, nbytes(x, qt.codes, qt.kernel_scale,
                                           got), 2.0 * m * k * n,
                               "bfloat16", path)
                print(f"kernel {name} [wgmma] {shape}: err vs its emulation "
                      f"{emu_err:.3e}; second launch identical {same}; bf16 "
                      f"out = f32 out rounded {rne}; the tile kernel "
                      f"{tile_ms:.4f} ms"
                      + (f"; mults {extra['mults']} = reuse_mult_count"
                         if extra else ""), flush=True)
                rows.append(dict(row, emulation_err=emu_err,
                                 tile_ms=tile_ms, **extra))
    return rows


def tensor_core_phase(dev, flush):
    """Where the tensor-core path of the two quantized matmuls overtakes
    their skinny kernels: the tensor-core and tile kernels of both at K768
    N256 and N2048 (bf16, int8 and NF4 per-channel) for each M of
    ``THRESHOLD_M`` and M4096, and the split-K decode kernels at each M of
    ``GEMV_M``, each held against its plain version; and the bf16 output
    that the serving path asks for at M4096 N2048 (written by the kernel,
    no separate cast)."""
    import torch
    from repro_torch.core.quantization import QuantConfig, quantize
    from repro_torch.kernels import axllm_matmul, ref, reuse_matmul
    from repro_torch.kernels.axllm_matmul import TC_MIN_M

    g = torch.Generator(device=dev).manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    sweep = []
    for (k, n), (alpha, qc) in itertools.product(
            ((768, 256), (768, 2048)),
            (("int8", QuantConfig(8)), ("nf4", QuantConfig(4, "codebook")))):
        qt = quantize(torch.randn(k, n, generator=g, device=dev) * k ** -0.5,
                      qc)
        for m in THRESHOLD_M + (4096,):
            x = torch.randn(m, k, generator=g, device=dev).to(bf16)
            want = ref.axllm_matmul_ref(x, qt)
            tol = 1e-5 * max(1.0, float(want.abs().max()))
            row = dict(m=m, k=k, n=n, alphabet=alpha)
            calls = [
                ("axllm_simt",
                 lambda: axllm_matmul.launch(x, qt, f32, "tile")),
                ("reuse_table", lambda: reuse_matmul.launch(
                    x, qt, False, f32, "tile")[0])]
            if m >= 16:
                calls += [
                    ("axllm_wgmma",
                     lambda: axllm_matmul.launch(x, qt, f32, "wgmma")),
                    ("reuse_wgmma", lambda: reuse_matmul.launch(
                        x, qt, False, f32, "wgmma")[0])]
            if m in GEMV_M:
                calls += [
                    ("axllm_gemv",
                     lambda: axllm_matmul.launch(x, qt, f32, "gemv")),
                    ("reuse_gemv", lambda: reuse_matmul.launch(
                        x, qt, False, f32, "gemv")[0])]
            for name, fn in calls:
                err = float((fn() - want).abs().max())
                check(err <= tol, f"{name} M{m} N{n}: error {err} > {tol}")
                row[name] = time_ms(fn, flush)
            if m == 4096 and n == 2048 and alpha == "int8":
                # the serving path's bf16 output
                got = axllm_matmul.launch(x, qt, bf16, "wgmma")
                check(torch.equal(got, axllm_matmul.launch(
                    x, qt, f32, "wgmma").to(bf16)), "bf16 output is not the "
                    "f32 output rounded to nearest even")
                row["axllm_wgmma_bf16_out"] = time_ms(
                    lambda: axllm_matmul.launch(x, qt, bf16, "wgmma"), flush)
                row["reuse_wgmma_bf16_out"] = time_ms(
                    lambda: reuse_matmul.launch(x, qt, False, bf16,
                                                "wgmma")[0], flush)
            print(f"tensor-core path vs skinny kernels, M{m} K{k} N{n} "
                  f"{alpha}: " + ", ".join(
                      f"{key} {v:.4f} ms" for key, v in row.items()
                      if key not in ("m", "k", "n", "alphabet")), flush=True)
            sweep.append(row)
    print(f"tensor-core path taken from M = {TC_MIN_M} (TC_MIN_M)",
          flush=True)
    return sweep


# the moe and vlm families' kernel shapes (runs h and i): qwen2-moe-a2.7b's
# projections (wq/wk/wv/wo K2048 N2048, the 4 shared experts' gate/up K2048
# N5632 and down K5632 N2048) and chameleon-34b's (wq/wo K8192 N8192, wk/wv
# K8192 N1024, gate/up K8192 N22016, down K22016 N8192), at decode M8 and a
# prefill wave's M4096; their untied heads at M8 only
FAMILY_MATMULS = ((2048, 2048), (2048, 5632), (5632, 2048), (8192, 8192),
                  (8192, 1024), (8192, 22016), (22016, 8192))
FAMILY_HEADS = ((2048, 152064), (8192, 65536))
# decode attention (H, Hk, d) at B8 S1024: qwen2-moe, chameleon, glm4-9b
# (16 query heads a KV head: two groups) and the chaos harness's d16
FAMILY_DECODE = ((16, 16, 128), (64, 8, 128), (32, 2, 128), (4, 2, 16))
# flash at B8 Sq = Sk = 512: (H, Hk, d, dtype)
FAMILY_FLASH = ((16, 16, 128, "bfloat16"), (64, 8, 128, "bfloat16"),
                (4, 2, 16, "float32"))


def matmul_case(kernel, m, k, n, g, dev, flush, act="bfloat16") -> dict:
    """One quantized-matmul case (int8 affine per channel, x in ``act``:
    bf16, or f32 as the recurrent families' gate projections take it) of
    ``kernel`` ("axllm_matmul" or "reuse_matmul") against its plain
    version, timed beside it and ``torch.matmul`` on the dequantized
    weight; a decode-path case also against its split emulation."""
    import torch
    from repro_torch.core.quantization import QuantConfig, dequantize, \
        quantize
    from repro_torch.kernels import ref
    from repro_torch.kernels.axllm_matmul import axllm_matmul_cuda
    from repro_torch.kernels.reuse_matmul import reuse_matmul_cuda
    reuse = kernel == "reuse_matmul"
    x = torch.randn(m, k, generator=g, device=dev).to(getattr(torch, act))
    qt = quantize(torch.randn(k, n, generator=g, device=dev) * k ** -0.5,
                  QuantConfig(8))
    plain_fn = ref.reuse_matmul_ref if reuse else ref.axllm_matmul_ref

    def call(dt=torch.float32):
        return (reuse_matmul_cuda(x, qt, out_dtype=dt)[0] if reuse
                else axllm_matmul_cuda(x, qt, dt))

    want = plain_fn(x, qt)
    got = call()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    # two f32 sums of K products in other orders (the scale applied after
    # the sum or to each weight) differ by about sqrt(K) units in the last
    # place of a typical output: 8 sqrt(K) ulps of the output scale (2.2e-5
    # at K2048, 7.1e-5 at K22016), never below the small shapes' 1e-5
    tol = max(1e-5, 8 * 2.0 ** -24 * k ** 0.5) * max(
        1.0, float(want.abs().max()))
    del want
    w_deq = dequantize(qt, x.dtype)
    ms = time_ms(call, flush)
    plain = time_ms(lambda: plain_fn(x, qt), flush, iters=5)
    lib = time_ms(lambda: torch.matmul(x, w_deq), flush)
    shape = f"M{m} K{k} N{n} 8b-affine-per_channel" + (
        "" if act == "bfloat16" else f" {act}-x")
    path = path_of(m, x, qt)
    row = case_row(kernel, shape, err, tol, ms, plain, lib,
                   nbytes(x, qt.codes, qt.kernel_scale, got),
                   2.0 * m * k * n, act, path)
    if path == "gemv":
        row.update(gemv_checks(kernel, x, qt, got, call, reuse))
    return row


DECODE_LENGTHS = (0, 64, 200, 511, 700, 1000, MAX_LEN, MAX_LEN + 300)


def decode_case(paged, h, hk, d, quant, g, dev, flush,
                lengths=DECODE_LENGTHS, s=MAX_LEN) -> dict:
    """One decode step of a row a length (the 8 slots, or a data rank's 4
    in run q) at S = ``s`` (dense cache; 1024 but for run l's shapes) or
    through shuffled, shared 16-key block tables
    (paged), at ``lengths`` (0 to past the end), against the plain version
    and the split emulation; every length-0 row must be exactly 0."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.decode_attention import decode_attention_cuda, \
        plan_rows, split_plan
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention_cuda
    bf16 = torch.bfloat16
    b, bs = len(lengths), KV_BLOCK      # a row a length (8: the slots)
    mb = s // bs
    n_rows = 2 * N_SLOTS * mb + 2 if paged else b   # pool blocks or rows
    inner = (bs,) if paged else (s,)
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    valid = torch.clamp(length, 0, s)
    q = torch.randn(b, h, d, generator=g, device=dev).to(bf16)
    shape_kv = (n_rows, *inner, hk, d)
    if quant:
        kc = torch.randint(-127, 128, shape_kv, generator=g, device=dev,
                           dtype=torch.int8)
        vc = torch.randint(-127, 128, shape_kv, generator=g, device=dev,
                           dtype=torch.int8)
        ks = torch.rand(*shape_kv[:-1], 1, generator=g, device=dev) * 0.02
        vs = torch.rand(*shape_kv[:-1], 1, generator=g, device=dev) * 0.02
        per_key = hk * (2 * d + 2 * 4)
    else:
        kc = torch.randn(*shape_kv, generator=g, device=dev).to(bf16)
        vc = torch.randn(*shape_kv, generator=g, device=dev).to(bf16)
        ks = vs = None
        per_key = hk * 2 * d * 2
    sms = _build.sm_count(dev)
    rows = plan_rows(b, h, hk)
    if paged:
        bt = (1 + torch.randperm(n_rows - 1, generator=g,
                                 device=dev)[:b * mb])
        bt = bt.reshape(b, mb).to(torch.int32)
        bt[1:, :SHARED_PREFIX // bs] = bt[0, :SHARED_PREFIX // bs]
        args = (q, kc, vc, bt, length, ks, vs)
        fn, plain_fn = paged_decode_attention_cuda, \
            ref.paged_decode_attention_ref
        emu = ref.paged_decode_attention_split_ref(
            q.float(), *args[1:], *split_plan(s, rows, sms, bs))
        pos = torch.arange(s, device=dev)
        entry = bt.long()[:, pos // bs] * bs + pos % bs
        n_entries = int(torch.unique(
            entry[pos[None, :] < valid[:, None]]).numel())
        extra = int(((valid + bs - 1) // bs).sum()) * 4
        name = "paged_decode_attention"
    else:
        args = (q, kc, vc, length, ks, vs)
        fn, plain_fn = decode_attention_cuda, ref.decode_attention_ref
        emu = ref.decode_attention_split_ref(q.float(), *args[1:],
                                             *split_plan(s, rows, sms))
        n_entries, extra = int(valid.sum()), 0
        name = "decode_attention"
    want = plain_fn(*args)
    got = fn(*args)
    torch.cuda.synchronize()
    zero = length <= 0
    nz = int(torch.count_nonzero(got[zero]))
    check(nz == 0, f"{name}: a length-0 row is not exactly 0 (H{h} Hk{hk} "
          f"d{d} {'int8' if quant else 'bf16'}-kv, lengths "
          f"{list(lengths)}): {nz} nonzero entries")
    err = float((got.float() - want.float()).abs().max())
    tol = 2.0 ** -7 * max(1.0, float(want.float().abs().max()))
    split_err(got, emu, f"{name} H{h} Hk{hk} d{d}")
    ms = time_ms(lambda: fn(*args), flush)
    plain = time_ms(lambda: plain_fn(*args), flush)
    lib = None
    if not quant and not paged:     # one library call computes it
        mask = (torch.arange(s, device=dev)[None, :]
                < valid[:, None])[:, None, None]
        qs, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qs, kt, vt, attn_mask=mask, enable_gqa=True), flush)
    shape = (f"B{b} H{h} Hk{hk} d{d} bs{bs} MB{mb}" if paged
             else f"B{b} S{s} H{h} Hk{hk} d{d}") + \
        f" {'int8' if quant else 'bf16'}-kv" + (
            "" if tuple(lengths) == DECODE_LENGTHS
            else f" lengths {','.join(map(str, lengths))}")
    return case_row(name, shape, err, tol, ms, plain, lib,
                    nbytes(q, length, got) + n_entries * per_key + extra,
                    4.0 * int(valid.sum()) * h * d, "bfloat16")


def flash_case(h, hk, d, dtype_name, g, dev, flush, sq=512, sk=None,
               causal=True, b=N_SLOTS) -> list:
    """Flash attention of a prefill wave (``b`` x ``sq`` queries, ``sk``
    keys, default ``sq``) at this head layout, causal or not: the
    wrapper's path and, for bf16, the SIMT kernel beside it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dtype = getattr(torch, dtype_name)
    sk = sk or sq
    q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, sk, hk, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, sk, hk, d, generator=g, device=dev).to(dtype)
    want = ref.attention_ref(q, k, v, causal)
    scale = max(1.0, float(want.float().abs().max()))
    tol = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) * scale
    amask = (torch.arange(sq, device=dev)[:, None] + sk - sq
             >= torch.arange(sk, device=dev)[None, :]) if causal else None
    qt_, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt_, kt, vt, attn_mask=amask, enable_gqa=True), flush)
    plain = time_ms(lambda: ref.attention_ref(q, k, v, causal), flush)
    # the query-key pairs the softmax covers (causal: the last sq rows of
    # the sk x sk triangle)
    pairs = sq * sk - (sq * (sq - 1) // 2 if causal else 0)
    shape = (f"B{b} Sq{sq} Sk{sk} H{h} Hk{hk} d{d} "
             f"{'causal' if causal else 'full'} {dtype_name}")
    calls = [("simt", lambda: fa.launch(q, k, v, causal, False))]
    if fa.tensor_core_path(q):
        calls.insert(0, ("wgmma", lambda: fa.flash_attention_cuda(
            q, k, v, causal)))
    rows = []
    for path, call in calls:
        got = call()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        rows.append(case_row("flash_attention", shape, err, tol,
                             time_ms(call, flush), plain, lib,
                             nbytes(q, k, v, got), 4.0 * b * h * d * pairs,
                             dtype_name, path))
    return rows


def family_kernel_phase(dev, flush):
    """Kernels 1 to 5 at the shapes of runs h and i (qwen2-moe-a2.7b and
    chameleon-34b at full width), each against its plain version."""
    import torch
    g = torch.Generator(device=dev).manual_seed(11)
    rows = []
    for kernel in ("axllm_matmul", "reuse_matmul"):
        for m in (N_SLOTS, 4096):
            for k, n in FAMILY_MATMULS:
                rows.append(matmul_case(kernel, m, k, n, g, dev, flush))
        for k, n in FAMILY_HEADS:
            rows.append(matmul_case(kernel, N_SLOTS, k, n, g, dev, flush))
    for paged in (False, True):
        for h, hk, d in FAMILY_DECODE:
            for quant in (False, True):
                rows.append(decode_case(paged, h, hk, d, quant, g, dev,
                                        flush))
    for h, hk, d, dt in FAMILY_FLASH:
        rows += flash_case(h, hk, d, dt, g, dev, flush)
    return rows


# the recurrent families' kernel shapes (runs j and k). Through
# axllm_matmul: xlstm-1.3b's bf16 projections (mLSTM up K2048 N8192, wq/wk
# K4096 N4096, down K4096 N2048; sLSTM GeGLU gate/up K2048 N2752 and down
# K2752 N2048) and zamba2-1.2b's mixers' (Mamba2 in_proj K2048 N8384,
# out_proj and the shared block's concat_proj K4096 N2048), which the JAX
# package runs on the AxLLM matmul under impl="reuse" too; through
# reuse_matmul: zamba2's shared MLP (up K2048 N8192, down K8192 N2048; its
# attention's K2048 N2048 is qwen2-moe's row above). At decode M8 and a
# prefill wave's M4096; xLSTM's f32 gate projections (mLSTM wif K4096 N8,
# sLSTM wx K2048 N8192) with f32 activations; the untied heads at M8
RECURRENT_MATMULS = {
    "axllm_matmul": ((2048, 8384), (4096, 2048), (2048, 8192), (4096, 4096),
                     (2048, 2752), (2752, 2048)),
    "reuse_matmul": ((2048, 8192), (8192, 2048)),
}
RECURRENT_F32 = ((4096, 8), (2048, 8192))
RECURRENT_HEADS = {"axllm_matmul": (2048, 50432),
                   "reuse_matmul": (2048, 32000)}
# zamba2's shared attention (H, Hk, d): decode at B8 S1024 and flash at
# the exact lengths of run k's sub-waves, which are not multiples of a tile
RECURRENT_ATTN = (32, 32, 64)
RECURRENT_SQ = (64, 200, 511)
# the open length-0 question: both decode kernels at B8 H16 Hk2 d32 (the
# layout of an untraced report of a nonzero length-0 row), bf16 and int8
# KV, at the usual lengths and at lengths with five 0 rows among others
ZERO_ROW = (16, 2, 32)
ZERO_ROW_LENGTHS = (0, 512, 0, 1, 0, 1000, 0, 0)


def recurrent_kernel_phase(dev, flush):
    """Kernels 1 to 3 at the shapes of runs j and k (xlstm-1.3b and
    zamba2-1.2b at full width), each against its plain version."""
    import torch
    g = torch.Generator(device=dev).manual_seed(12)
    rows = []
    for kernel, shapes in RECURRENT_MATMULS.items():
        for m in (N_SLOTS, 4096):
            for k, n in shapes:
                rows.append(matmul_case(kernel, m, k, n, g, dev, flush))
        rows.append(matmul_case(kernel, N_SLOTS, *RECURRENT_HEADS[kernel], g,
                                dev, flush))
    for m in (N_SLOTS, 4096):
        for k, n in RECURRENT_F32:
            rows.append(matmul_case("axllm_matmul", m, k, n, g, dev, flush,
                                    act="float32"))
    rows.append(decode_case(False, *RECURRENT_ATTN, False, g, dev, flush))
    for sq in RECURRENT_SQ:
        rows += flash_case(*RECURRENT_ATTN, "bfloat16", g, dev, flush, sq=sq)
    return rows


def zero_row_phase(dev, flush):
    """Both decode kernels at ``ZERO_ROW``, bf16 and int8 KV: every
    length-0 row must be exactly 0 (``decode_case`` checks it), the
    reference's rule (``src/repro/kernels/ref.py:169-173``)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(13)
    rows = []
    for paged in (False, True):
        for quant in (False, True):
            for lengths in (DECODE_LENGTHS, ZERO_ROW_LENGTHS):
                rows.append(decode_case(paged, *ZERO_ROW, quant, g, dev,
                                        flush, lengths=lengths))
    print(f"zero-row check: both decode kernels at H{ZERO_ROW[0]} "
          f"Hk{ZERO_ROW[1]} d{ZERO_ROW[2]}, bf16 and int8 KV, "
          f"{len(rows)} cases: every length-0 row exactly 0", flush=True)
    return rows


def sass_hgmma(lib: str) -> int:
    """The number of HGMMA (wgmma) instructions in a built library."""
    from repro_torch.kernels import _build
    sass = subprocess.run(
        ["/usr/local/cuda/bin/cuobjdump", "--dump-sass",
         str(_build.target(lib))], capture_output=True, text=True,
        check=True).stdout
    return sum("HGMMA" in line for line in sass.splitlines())


# the strip kernel that csrc/quantize.cu replaced, built as its own library
# only to time it beside the cluster kernel ("was"); no path calls it
STRIP_SOURCE = ROOT / "src/repro_torch/baseline/quantize_strip.cu"
# the quantization kernel's shapes: the table's (timed), then the routes of
# its plan (held bit-equal only): K beyond what a cluster holds, ragged N
# (not a multiple of 16, 8 or 4) in stacks
QUANT_TIMED = ((768, 768), (768, 256), (768, 2048), (2048, 768),
               (8192, 2048))
QUANT_ROUTES = ((65536, 96), (3, 300, 130), (2, 300, 100), (2, 70, 37),
                (8192, 130))


def start_strip_build():
    """Start nvcc on the strip kernel (in parallel with the port's build)."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "quantize_strip.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
           str(STRIP_SOURCE)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def strip_kernel(proc_out):
    """The strip kernel as a function w, bits -> (codes, scale)."""
    import ctypes
    import torch
    proc, out = proc_out
    log = proc.communicate()[0]
    check(proc.returncode == 0, f"nvcc failed for the strip kernel:\n{log}")
    fn = ctypes.CDLL(str(out)).quantize_strip_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(w, bits=8):
        *lead, k, n = w.shape
        codes = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        scale = torch.empty((*lead, 1, n), dtype=torch.float32,
                            device=w.device)
        err = fn(w.data_ptr(), int(w.dtype == torch.bfloat16),
                 codes.data_ptr(), scale.data_ptr(), w.numel() // (k * n), k,
                 n, bits, torch.cuda.current_stream(w.device).cuda_stream)
        check(err == 0, f"strip kernel launch failed: cudaError_t {err}")
        return codes, scale
    return run


def quantize_kernel_phase(dev, flush, strip):
    """The quantization kernel against its plain version: codes and scales
    equal at every shape, type and width (8 and 4 bits at the timed
    shapes, 2 to 8 bits on every route of the plan: K beyond what a
    cluster holds, ragged N, stacks), and on columns that hold a NaN, an
    inf or only zeros, with times at 8 bits beside the strip kernel it
    replaced (``strip``, "was") and the launch floor (a kernel that does
    nothing, timed the same way); then the deploy pass through
    ``ops.quantize_channels`` (the kernel's path) over every projection
    leaf of full-width repro-100m, with the launch count set to 0 just
    before it and read just after. Returns (rows, the pass's metrics)."""
    import torch
    from repro_torch.configs.repro_100m import CONFIG
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.quantize import quantize_cuda, quantize_plan
    from repro_torch.models.model import get_model

    g = torch.Generator(device=dev).manual_seed(2)
    rows = []

    def plan_of(w):
        *lead, k, n = w.shape
        return quantize_plan(w.numel() // (k * n), k, n, w.dtype,
                             _build.sm_count(w.device))

    def held(w, codes, scale, bits, what):
        want_codes, want_scale = ref.quantize_ref(w, bits)
        n_codes = int((codes != want_codes).sum())
        n_scales = int(((scale != want_scale)
                        & ~(scale.isnan() & want_scale.isnan())).sum())
        check(n_codes == 0 and n_scales == 0,
              f"quantize {what}: {n_codes} codes and {n_scales} scales "
              "differ from the plain version")
        return float((codes.int() - want_codes.int()).abs().max())

    floor = time_ms(lambda: torch.cuda._sleep(0), flush)
    print(f"quantize launch floor (a kernel that does nothing, timed the "
          f"same way): {floor:.4f} ms", flush=True)
    for k, n in QUANT_TIMED:
        for dtype in (torch.bfloat16, torch.float32):
            w = (torch.randn(k, n, generator=g, device=dev)
                 * k ** -0.5).to(dtype)
            for bits in (8, 4):
                codes, scale = quantize_cuda(w, bits)
                torch.cuda.synchronize()
                shape = f"K{k} N{n} {str(dtype)[6:]} {bits}b"
                err = held(w, codes, scale, bits, shape)
                ms = time_ms(lambda: quantize_cuda(w, bits), flush)
                plain = time_ms(lambda: ref.quantize_ref(w, bits), flush)
                row = case_row("quantize", shape, err, 0.0, ms, plain,
                               None, nbytes(w, codes, scale), 5.0 * k * n,
                               "float32", "cluster")
                was = time_ms(lambda: strip(w, bits), flush)
                print(f"kernel quantize {shape}: plan {plan_of(w).describe()}"
                      f"; was (strip kernel) {was:.4f} ms; launch floor "
                      f"{floor:.4f} ms", flush=True)
                rows.append(dict(row, was_ms=was, launch_floor_ms=floor,
                                 plan=plan_of(w).describe()))

    routes = []
    for shape in QUANT_ROUTES:
        for dtype in (torch.bfloat16, torch.float32):
            w = (torch.randn(shape, generator=g, device=dev)
                 * 0.05).to(dtype)
            w[..., 1, 3] = 0.0          # a tie column: absmax 127 * 2^-7
            w[..., 0, 3] = 127 * 2.0 ** -7
            w[..., 2, 3] = 2.5 * 2.0 ** -7
            for bits in (8, 7, 4, 3, 2):
                codes, scale = quantize_cuda(w, bits)
                torch.cuda.synchronize()
                held(w, codes, scale, bits, f"{shape} {dtype} {bits}b")
            routes.append(dict(shape=list(shape), dtype=str(dtype)[6:],
                               plan=plan_of(w).describe()))
            print(f"quantize {shape} {str(dtype)[6:]}, bits 8/7/4/3/2: codes "
                  f"and scales equal to the plain version; plan "
                  f"{plan_of(w).describe()}", flush=True)
    special = []
    for shape in ((768, 2048), (3, 300, 130), (65536, 96)):
        for dtype in (torch.bfloat16, torch.float32):
            w = (torch.randn(shape, generator=g, device=dev)
                 * 0.05).to(dtype)
            w[..., 5, 0] = float("nan")
            w[..., 0, 1] = float("inf")
            w[..., 7, 2] = float("-inf")
            w[..., :, 4] = 0.0
            codes, scale = quantize_cuda(w, 8)
            torch.cuda.synchronize()
            held(w, codes, scale, 8, f"NaN/inf/zero columns {shape}")
            check(bool(scale[..., 0].isnan().all()
                       & scale[..., 1].isinf().all())
                  and not codes[..., [0, 1, 2, 4]].any(),
                  f"NaN/inf/zero columns {shape}: wrong scale or codes")
            old_codes, old_scale = strip(w, 8)
            want_codes, want_scale = ref.quantize_ref(w, 8)
            torch.cuda.synchronize()
            old_bad = int((old_codes != want_codes).sum())
            special.append(dict(shape=list(shape), dtype=str(dtype)[6:],
                                strip_kernel_codes_off=old_bad))
            print(f"quantize NaN/inf/zero columns {shape} "
                  f"{str(dtype)[6:]}: codes and scales equal to the plain "
                  f"version (NaN scale, inf scale, codes 0); the strip "
                  f"kernel it replaced gets {old_bad} codes wrong",
                  flush=True)

    params = get_model(CONFIG).init(seed=0, device=dev)
    layers = params["layers"]
    leaves = [layers[grp][name] for grp, names in (
        ("attn", ("wq", "wk", "wv", "wo")), ("ffn", ("gate", "up", "down")))
        for name in names]
    torch.cuda.synchronize()
    _build.reset_launches()
    out = [ops.quantize_channels(w) for w in leaves]
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    check(launches == {"quantize": len(leaves)},
          f"deploy pass launched {launches}, not {len(leaves)} quantize")
    for w, (codes, scale) in zip(leaves, out):
        held(w, codes, scale, 8, f"deploy {tuple(w.shape)}")
    n_mat = sum(w.shape[0] for w in leaves)
    nb = sum(nbytes(w, c, sc) for w, (c, sc) in zip(leaves, out))
    n_w = sum(w.numel() for w in leaves)
    bound_ms, bound_by = bound(nb, 5.0 * n_w, "float32")
    ms = time_ms(lambda: [quantize_cuda(w) for w in leaves], flush, iters=10)
    plain = time_ms(lambda: [ref.quantize_ref(w) for w in leaves], flush,
                    iters=10)
    was = time_ms(lambda: [strip(w) for w in leaves], flush, iters=10)
    plans = {f"{tuple(w.shape)}": plan_of(w).describe() for w in leaves}
    print(f"quantize deploy pass: {n_mat} matrices ({n_w} weights, "
          f"{nb / 1e6:.1f} MB) in {launches['quantize']} launches, codes and "
          f"scales equal to the plain version; {ms:.4f} ms, plain "
          f"{plain:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), was (strip "
          f"kernel) {was:.4f} ms; plans {plans}", flush=True)
    deploy = dict(matrices=n_mat, weights=n_w, bytes=nb, launches=launches,
                  ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=bound_by,
                  was_ms=was, launch_floor_ms=floor, plans=plans,
                  routes=routes, nan_inf_zero=special)
    return rows, deploy


def small_input_check(dev):
    """Reduced float32 repro-100m, int8 weights: greedy tokens through the
    kernels equal those through the plain versions, for the dense engine
    and for a paged reuse engine with prefix hits (against the dense
    engine's plain versions)."""
    import numpy as np
    from repro_torch.configs.repro_100m import CONFIG
    from repro_torch.kernels import _build
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import ServeEngine

    cfg = CONFIG.reduced(dtype="float32", remat=False)
    params = get_model(cfg).init(seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (8, 12, 31, 8, 12, 31)]
    head = rng.integers(0, cfg.vocab_size, size=24).astype(np.int32)
    prompts += [np.concatenate([head, rng.integers(0, cfg.vocab_size,
                                                   size=n).astype(np.int32)])
                for n in (3, 9, 5, 12)]

    def serve(impl, **kw):
        return ServeEngine(cfg, params, n_slots=2, max_len=64, quantize=True,
                           impl=impl, device=dev, **kw)

    toks = {impl: serve(impl).generate(prompts, max_new=16)
            for impl in ("cuda", "ref", "reuse_ref")}
    check(toks["cuda"] == toks["ref"],
          "small-input tokens differ between kernel and plain paths")
    eng = serve("reuse", paged=True, kv_block_size=8)
    _build.reset_launches()
    paged = eng.generate(prompts, max_new=16)
    launches = dict(_build.LAUNCHES)
    check(paged == toks["reuse_ref"], "small-input tokens of the paged "
          "reuse engine differ from the dense plain path")
    check(eng.stats.prefix_hit_tokens > 0, "no prefix hit in the paged run")
    for name in ("reuse_matmul", "paged_decode_attention", "flash_attention"):
        check(launches.get(name, 0) > 0, f"{name} never launched in the "
                                         "small paged reuse run")
    print("small-input check: reduced fp32 int8 engine tokens identical "
          "(kernels vs plain versions); paged reuse engine through the "
          "kernels identical to the dense engine through the plain "
          f"versions ({eng.stats.prefix_hit_tokens} prefix-hit tokens)",
          flush=True)


def record_routes(eng):
    """(routes, wave_lens): a :class:`Routes` that, within its
    ``record()`` block, records the expert choices of ``eng``'s moe
    layers by (rid, layer, position), and each request's wave's padded
    prompt length by rid. The engine's dense prefill and decode are
    wrapped to say what each call's batch rows hold (a wave's requests at
    positions 0 .. len - 1, a decode step's slots at their cursors)."""
    import dataclasses
    import numpy as np
    from repro_torch.serve.token_gate import Routes
    routes, pending, wave_lens = Routes(), [], {}
    group_fn, api = eng._prefill_group, eng.api

    def group(g, free):
        pending[:] = [r.rid for r in g]
        return group_fn(g, free)

    def prefill(p, b, c, lengths=None, **kw):
        n = lengths.cpu().numpy()
        ar = np.arange(b["tokens"].shape[1])
        wave_lens.update((rid, len(ar)) for rid in pending)
        routes.at(pending + [None] * (len(n) - len(pending)),
                  np.where(ar[None] < n[:, None], ar[None], -1))
        return api.prefill(p, b, c, lengths=lengths, **kw)

    def decode(p, t, c, **kw):
        routes.at([None if r is None else r.rid for r in eng.slots],
                  c["pos"].cpu().numpy()[:, None])
        return api.decode(p, t, c, **kw)

    eng._prefill_group = group
    eng.api = dataclasses.replace(api, prefill=prefill, decode=decode)
    return routes, wave_lens


def print_routes(tag, what, routes) -> dict:
    """Print and return the routing gate's account of ``routes``."""
    print(f"{tag}: {what}: routing gate: {routes.tokens} (token, layer) "
          f"routings of the served path taken, {routes.differ} of them not "
          f"the plain router's top-k, smallest slack {routes.min_slack:.4e};"
          f" {len(routes.failures)} choices more than 2 x tol below the "
          f"plain k-th logit, {routes.missing} tokens without a record",
          flush=True)
    return dict(tokens=routes.tokens, differ=routes.differ,
                min_slack=routes.min_slack, failures=len(routes.failures),
                missing=routes.missing)


def record_hit_wave(eng) -> dict:
    """Wrap a paged engine's prefill so that it records its first wave with
    a prefix hit: the rows' whole prompts and the first-token logits the
    paged path gave them."""
    import numpy as np
    rec, wave = {}, []
    group_fn, prefill_fn = eng._prefill_group_paged, eng._paged_prefill

    def group(g, free):
        wave[:] = [r.prompt for r in g]
        return group_fn(g, free)

    def prefill(toks, lengths, prefix_len, pbt, sbt, aidx):
        logits = prefill_fn(toks, lengths, prefix_len, pbt, sbt, aidx)
        if pbt is not None and not rec:
            for i, p in enumerate(wave):   # row i: cached head ++ its tail
                check(np.array_equal(np.concatenate(
                    [p[:prefix_len[i]], toks[i, :lengths[i]]]), p),
                    f"prefix-hit wave row {i} is not its request's prompt")
            rec.update(prompts=list(wave), logits=logits[:len(wave)].clone(),
                       hit_tokens=int(prefix_len[:len(wave)].sum()))
        return logits

    eng._prefill_group_paged, eng._paged_prefill = group, prefill
    return rec


def split_by_kind(top, in_mixer=None) -> dict:
    """Device ms of a profile's kernels (``top``: (name, ms) pairs) split
    into attention (the decode and flash kernels), the quantized matmuls
    (both libraries), the expert products (every other GEMM: cuBLAS's
    batched expert products and the router's product) and the rest (the
    expert banks' dequantization among it). With ``in_mixer`` (the device
    ms by name of the kernels launched inside a recurrent mixer) those
    kernels but the quantized matmuls count as ``recurrent_mixer``
    instead: the SSD and mLSTM einsums' GEMMs, the sLSTM loop, the causal
    conv, the gates and norms."""
    out = dict(attention=0.0, quantized_matmul=0.0, expert_products=0.0,
               rest=0.0)
    if in_mixer is not None:
        out["recurrent_mixer"] = 0.0
    for name, ms in top:
        n = name.lower()
        if "attention" in n or "paged_decode" in n or "flash" in n:
            out["attention"] += ms
            continue
        if "axllm" in n or "reuse_" in n or "quant_gemm" in n:
            out["quantized_matmul"] += ms
            continue
        if in_mixer is not None:
            mixer_ms = min(ms, in_mixer.get(name, 0.0))
            out["recurrent_mixer"] += mixer_ms
            ms -= mixer_ms
        if any(t in n for t in ("gemm", "nvjet", "xmma", "cutlass", "bmm")):
            out["expert_products"] += ms
        else:
            out["rest"] += ms
    return out


def serve_run(dev, card, label, prompts, kernels, names=None,
              registry=None, cfg=None, after=None, tile_expect=None,
              **engine_kw):
    """One end-to-end run, on ``e2e_config()`` unless ``cfg`` says
    otherwise: ``prompts`` through ``ServeEngine(quantize=True, n_slots=8,
    max_len=1024, decode_chunk=8, adapters=registry, **engine_kw)``,
    request i with adapter ``names[i]``, with every launch count set to 0
    just before and read just after, each of ``kernels`` required to have
    launched. ``after(prefill, wave)`` adds its metrics: ``prefill()``
    runs the first wave (``wave``, its prompts) again as served.
    ``tile_expect(stats)`` gives the launches each quantized matmul must
    make on its tile kernel (none without it). A recurrent family's
    profiles label its mixers' kernels apart (``annotated_mixers``), and
    its plain first-wave prefill runs equal-length groups. Returns
    (metrics, the engine)."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import ServeEngine, _pow2_bucket
    from repro_torch.serve.token_gate import Routes, token_gate

    cfg = cfg or e2e_config()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = get_model(cfg).init(seed=0, device=dev)
    init_peak = torch.cuda.max_memory_allocated()
    impl = engine_kw.pop("impl", "auto")
    plain_impl = "reuse_ref" if impl == "reuse" else "ref"
    tag = f"e2e {label} [{card}]"
    names = names or [None] * len(prompts)

    def engine(impl):
        return ServeEngine(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                           quantize=True, decode_chunk=DECODE_CHUNK,
                           impl=impl, adapters=registry, device=dev,
                           **engine_kw)

    torch.cuda.reset_peak_memory_stats()
    warm = engine(impl)         # its deploy_quantize: the peak beside init
    deploy_peak = torch.cuda.max_memory_allocated()
    warm.generate(prompts[:2], max_new=8,     # warm-up (cuBLAS, etc.)
                  adapters=names[:2])
    del warm
    eng = engine(impl)
    hit_wave = record_hit_wave(eng) if eng.paged else None
    for p, name in zip(prompts, names):
        eng.submit(p, max_new=MAX_NEW, adapter=name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    done = {r.rid: r for r in eng.finished}
    check(sorted(done) == list(range(len(prompts))),
          f"{label}: only {len(done)} of {len(prompts)} requests finished")
    for r in done.values():
        check(r.finish_reason == "max_new" and len(r.tokens) == MAX_NEW,
              f"{label}: request {r.rid} stopped {r.finish_reason} after "
              f"{len(r.tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"{label}: request {r.rid} has a token outside the vocab")
    for name in kernels:
        check(launches.get(name, 0) > 0, f"{label}: {name} never launched "
                                         "on the main path")
    # every quantized-matmul launch took the tensor cores (prefill) or the
    # split-K decode kernel (decode): none the tile kernel, but those that
    # ``tile_expect`` counts (f32 activations, N not a multiple of 16)
    tile_want = {} if tile_expect is None else tile_expect(eng.stats)
    for lib in ("axllm_matmul", "reuse_matmul"):
        tile = launches.get(lib, 0) - launches.get(f"{lib}.wgmma", 0) \
            - launches.get(f"{lib}.gemv", 0)
        check(tile == tile_want.get(lib, 0), f"{label}: {lib} launches "
              f"{launches.get(lib, 0)} are wgmma "
              f"{launches.get(f'{lib}.wgmma', 0)} + gemv "
              f"{launches.get(f'{lib}.gemv', 0)} + tile {tile}, not the "
              f"{tile_want.get(lib, 0)} tile launches expected")
    # bf16 prefill: every flash launch takes the tensor cores, one a layer
    # per wave that runs flash attention
    check(launches.get("flash_attention.wgmma") ==
          launches.get("flash_attention"), f"{label}: flash launches "
          f"{launches.get('flash_attention')} of which "
          f"{launches.get('flash_attention.wgmma')} on the tensor cores")
    generated = sum(len(r.tokens) for r in done.values())
    st = eng.stats
    print(f"{tag}: {generated} tokens in {wall:.3f} s = "
          f"{generated / wall:.1f} tok/s; decode {st.decode_tokens} tokens "
          f"in {st.steps} steps; prefill {st.prefill_waves} waves, "
          f"{st.prefill_tokens} tokens, {st.prefill_wall_s:.3f} s; "
          f"prefix-hit tokens {st.prefix_hit_tokens}; LoRA requests "
          f"{st.lora_requests}; peak memory "
          f"{peak / 2**30:.3f} GiB (init {init_peak / 2**30:.3f}, with a "
          f"quantized copy {deploy_peak / 2**30:.3f})", flush=True)
    print(f"{tag}: launches {launches}", flush=True)

    # the token gate: each request's tokens, teacher-forced through the
    # plain path on the kernel path's own prefix; a moe model's (whose
    # output depends on its wave's padded length, the capacity) on the
    # served schedule with the served expert choices, recorded from a
    # second serving of the same requests (which must repeat the first
    # bit for bit), each choice held to the routing gate
    routes = wave_lens = None
    if cfg.family == "moe":
        rec_eng = engine(impl)
        routes, wave_lens = record_routes(rec_eng)
        with routes.record():
            again = rec_eng.generate(prompts, max_new=MAX_NEW)
        del rec_eng
        same = sum(a == done[i].tokens for i, a in enumerate(again))
        print(f"{tag}: a second serving of the same requests: {same}/"
              f"{len(prompts)} requests' tokens identical", flush=True)
        check(same == len(prompts), f"{label}: serving did not repeat")
    gate = token_gate(cfg, eng.params, prompts,
                      [done[i].tokens for i in range(len(prompts))],
                      impl=plain_impl, tol_rel=LOGIT_TOL, device=dev,
                      registry=registry, names=names,
                      prefill_lens=None if wave_lens is None else
                      [wave_lens[i] for i in range(len(prompts))],
                      routes=routes)
    print(f"{tag}: token gate: {gate.positions} generated positions checked "
          f"against the plain path's teacher-forced logits"
          + ("" if routes is None else " (the served schedule replayed, "
             "the served expert choices taken)") +
          f"; {gate.differ} where the token is not the plain path's "
          f"argmax; smallest slack {gate.min_slack:.4e} (request "
          f"{gate.worst[0]}, position {gate.worst[1]}); "
          f"{len(gate.failures)} positions more than 2 x tol below the "
          f"plain maximum", flush=True)
    route_gate = {}
    if routes is not None:
        route_gate = print_routes(tag, "token gate", routes)
    check(gate.ok, f"{label}: token gate failed at (request, position, "
                   f"slack) {gate.failures[:5]}; routing {route_gate}")
    def dense_logits(which, wave, wave_names=None, wave_routes=None):
        """First-token logits of a plain dense prefill of ``wave``, row i
        with adapter ``wave_names[i]`` (all base when None); row i is
        request i of ``wave_routes``."""
        pl = _pow2_bucket(max(len(p) for p in wave), 8, MAX_LEN)
        toks = np.zeros((len(wave), pl), np.int32)
        for i, p in enumerate(wave):
            toks[i, :len(p)] = p
        lengths = torch.tensor([len(p) for p in wave], dtype=torch.int32,
                               device=dev)
        lora = {}
        if registry is not None:
            rows = [-1 if n is None else registry.index_of(n)
                    for n in wave_names or [None] * len(wave)]
            lora = dict(adapters=registry.stacked,
                        adapter_idx=torch.tensor(rows, dtype=torch.int32,
                                                 device=dev),
                        lora_scaling=registry.scaling)
        api = get_model(cfg, impl=which)
        if not api.ragged_prefill:
            # a recurrent family: equal-length groups, each at its exact
            # length, the rows put back in order
            out = [None] * len(wave)
            with torch.inference_mode():
                for n in sorted({len(p) for p in wave}):
                    idx = [i for i, p in enumerate(wave) if len(p) == n]
                    toks = torch.from_numpy(np.stack(
                        [np.asarray(wave[i], np.int32) for i in idx])).to(dev)
                    logits = api.prefill(eng.params, {"tokens": toks},
                                         api.init_cache(len(idx), n, dev))[0]
                    for j, i in enumerate(idx):
                        out[i] = logits[j]
            return torch.stack(out)
        if wave_routes is not None:
            ar = np.arange(pl)
            wave_routes.at(range(len(wave)), np.where(
                ar[None] < lengths.cpu().numpy()[:, None], ar[None], -1))
        with torch.inference_mode():
            return api.prefill(
                eng.params, {"tokens": torch.from_numpy(toks).to(dev)},
                api.init_cache(len(wave), pl, dev), lengths=lengths,
                **lora)[0]

    def hold(what, a, b):
        a, b = a.float(), b.float()
        check(bool(torch.isfinite(a).all()), f"{label}: non-finite {what}")
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        ka = a[:, :cfg.vocab_size].argmax(-1)
        kb = b[:, :cfg.vocab_size].argmax(-1)
        agree = float((ka == kb).float().mean())
        # where the argmax differs: the plain path's own margin between its
        # top token and the kernel path's (a near-tie when below err)
        gaps = [float(b[i, kb[i]] - b[i, ka[i]])
                for i in range(len(ka)) if ka[i] != kb[i]]
        print(f"{tag}: {what} |kernel - plain| = {err:.4e}, scale "
              f"{scale:.4f}, tolerance {LOGIT_TOL * max(1.0, scale):.4e}; "
              f"argmax agreement {agree:.3f}"
              + ("" if not gaps else "; plain-path logit margin of the "
                 "differing rows " + ", ".join(f"{x:.4e}" for x in gaps)),
              flush=True)
        check(err <= LOGIT_TOL * max(1.0, scale),
              f"{label}: {what} differ by {err}")
        return err, scale, agree

    # first wave (no prefix hit: the plain ragged prefill) against the
    # plain path, same card and weights
    # (moe: the plain pass takes the served pass's expert choices, each
    # held to the routing gate)
    wave, wave_names = prompts[:N_SLOTS], names[:N_SLOTS]
    if routes is None:
        served = dense_logits(impl, wave, wave_names)
        plain_wave = dense_logits(plain_impl, wave, wave_names)
    else:
        wave_routes = Routes()
        with wave_routes.record():
            served = dense_logits(impl, wave, wave_names, wave_routes)
        with wave_routes.force(LOGIT_TOL):
            plain_wave = dense_logits(plain_impl, wave, wave_names,
                                      wave_routes)
        route_gate["first_wave"] = print_routes(tag, "first wave",
                                                wave_routes)
        check(wave_routes.ok, f"{label}: the first wave's routing gate "
                              f"failed: {wave_routes.failures[:5]}")
    logit_err, scale, argmax_agree = hold("first-wave logits", served,
                                          plain_wave)
    hit = {}
    if registry is not None:
        # the delta ran: each adapter row's logits move beyond the
        # tolerance from the same prompt's base logits
        base = dense_logits(impl, wave).float()
        tol = LOGIT_TOL * max(1.0, scale)
        moved = {}
        for i, name in enumerate(wave_names):
            if name is not None:
                moved[i] = float((served[i].float() - base[i]).abs().max())
                check(moved[i] > tol, f"{label}: row {i} ({name}) logits "
                                      f"moved only {moved[i]} from base")
        print(f"{tag}: adapter rows' first-wave logits move "
              f"{min(moved.values()):.4f}-{max(moved.values()):.4f} from "
              f"the same prompts' base logits (tolerance {tol:.4e})",
              flush=True)
        hit["adapter_logit_moved"] = moved
    if eng.paged:
        # the served wave with a prefix hit (prefix KV gathered out of the
        # pool, suffix-only prefill) against a plain dense prefill of the
        # whole prompts
        check(bool(hit_wave), f"{label}: no prefill wave had a prefix hit")
        err, hscale, agree = hold(
            f"prefix-hit wave ({len(hit_wave['prompts'])} rows, "
            f"{hit_wave['hit_tokens']} cached tokens) logits",
            hit_wave["logits"], dense_logits(plain_impl, hit_wave["prompts"]))
        hit = dict(hit_wave_logit_err=err, hit_wave_logit_scale=hscale,
                   hit_wave_argmax_agree=agree,
                   hit_wave_cached_tokens=hit_wave["hit_tokens"])

    # where the decode time goes: 4 chunks of 8 full slots, profiled
    prof_eng = engine(impl)
    for p, name in zip(prompts[:N_SLOTS], names):
        prof_eng.submit(p, max_new=MAX_NEW, adapter=name)
    prof_eng.step()                                  # prefill + 1st chunk
    recurrent = not eng.api.ragged_prefill
    wall_ms, busy_ms, top, *mixer = device_busy_ms(
        lambda: [prof_eng.step() for _ in range(4)], mixers=recurrent)
    idle = 1.0 - busy_ms / wall_ms
    print(f"{tag}: 4 decode chunks (32 steps, 8 slots): wall "
          f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share "
          f"{idle:.3f}", flush=True)
    for name, ms in top[:8]:
        print(f"{tag}:   device {ms:8.3f} ms  {name[:90]}", flush=True)
    decode_split = split_by_kind(top, *mixer)
    print(f"{tag}: decode device ms by kind: "
          + ", ".join(f"{k} {v:.3f}" for k, v in decode_split.items()),
          flush=True)
    # where a prefill wave's time goes: the first wave's prefill through
    # the kernel path (as served: the same model call), profiled
    p_wall, p_busy, p_top, *p_mixer = device_busy_ms(
        lambda: dense_logits(impl, wave, wave_names), mixers=recurrent)
    flash_ms = sum(ms for name, ms in p_top if "flash" in name)
    wave_split = split_by_kind(p_top, *p_mixer)
    print(f"{tag}: one prefill wave ({len(wave)} rows): wall {p_wall:.2f} "
          f"ms, device busy {p_busy:.2f} ms, idle share "
          f"{1.0 - p_busy / p_wall:.3f}; flash attention {flash_ms:.3f} ms "
          f"device; by kind: "
          + ", ".join(f"{k} {v:.3f}" for k, v in wave_split.items()),
          flush=True)
    extra = {} if after is None else after(
        lambda: dense_logits(impl, wave, wave_names), wave)

    plain = engine(plain_impl)
    for p, name in zip(prompts, names):
        plain.submit(p, max_new=MAX_NEW, adapter=name)
    plain.run()
    ptoks = {r.rid: r.tokens for r in plain.finished}
    same = sum(done[i].tokens == ptoks[i] for i in done)
    agree = np.mean([np.mean(np.equal(done[i].tokens, ptoks[i]))
                     for i in done])
    print(f"{tag}: greedy tokens vs plain path: {same}/{len(prompts)} "
          f"requests identical, {agree:.3f} of positions equal", flush=True)
    return dict(tokens=generated, wall_s=wall, tok_per_s=generated / wall,
                prefill_wall_s=st.prefill_wall_s, steps=st.steps,
                prefill_waves=st.prefill_waves,
                prefill_tokens=st.prefill_tokens,
                lora_requests=st.lora_requests,
                prefix_hit_tokens=st.prefix_hit_tokens,
                blocks_in_use=st.blocks_in_use, peak_bytes=peak,
                launches=launches, logit_err=logit_err, logit_scale=scale,
                init_peak_bytes=init_peak, deploy_peak_bytes=deploy_peak,
                routing_gate=route_gate,
                **extra,
                gate=dict(positions=gate.positions, differ=gate.differ,
                          min_slack=gate.min_slack,
                          failures=len(gate.failures)),
                first_wave_argmax_agree=argmax_agree, **hit,
                requests_identical=same, position_agree=float(agree),
                decode_profile=dict(wall_ms=wall_ms, busy_ms=busy_ms,
                                    idle_share=idle, top=top,
                                    by_kind=decode_split),
                prefill_profile=dict(wall_ms=p_wall, busy_ms=p_busy,
                                     flash_ms=flash_ms, top=p_top[:8],
                                     by_kind=wave_split)), eng


def e2e_config():
    """The config runs a to g and n serve: full-width repro-100m, cut to
    ``E2E_LAYERS`` layers."""
    import dataclasses
    from repro_torch.configs.repro_100m import CONFIG
    return dataclasses.replace(CONFIG, n_layers=E2E_LAYERS)


def run_a_prompts() -> list:
    """Run a's 16 prompts (64/200/511 tokens, numpy seed 0), which runs c
    and d serve too."""
    return prompt_cycle(N_REQUESTS)


def served_tokens(eng) -> list:
    """Each request's tokens, in rid order."""
    done = {r.rid: r.tokens for r in eng.finished}
    return [done[i] for i in sorted(done)]


def end_to_end(dev, card):
    """Run a; returns (metrics, its requests' tokens)."""
    e2e, eng = serve_run(dev, card, "dense", run_a_prompts(), (
        "axllm_matmul", "axllm_matmul.wgmma", "axllm_matmul.gemv",
        "decode_attention",
        "flash_attention", "flash_attention.wgmma"))
    return e2e, served_tokens(eng)


def reuse_rates(projections, where, label, card, rows=(N_SLOTS,)) -> dict:
    """The reuse rate the kernel counts on each quantized projection of
    ``projections`` (name -> weight, ``where`` names them: "layer 0",
    ...), on a call of each M in ``rows`` (each through the path serving
    takes at that M), each count held against ``reuse_mult_count``,
    beside the analytic Gaussian model."""
    import torch
    from repro_torch.core.quantization import QTensor
    from repro_torch.core.reuse import expected_reuse_rate
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.reuse_matmul import segment

    predicted = expected_reuse_rate(256, 128, "gaussian")
    rates = {}
    for name, qt in projections.items():
        if not isinstance(qt, QTensor):
            continue
        k, n = qt.shape
        count = ref.reuse_mult_count(qt, segment(n))
        for m in rows:
            x = torch.ones((m, k), dtype=torch.bfloat16,
                           device=qt.codes.device)
            _, mults = ops.reuse_matmul(x, qt, impl="reuse",
                                        with_stats=True)
            check(int(mults) == count, f"{label}: {where} {name} M{m}: "
                  f"kernel counted {int(mults)}, host {count}")
        rates[name] = 1.0 - count / (k * n)
        print(f"e2e {label} [{card}]: {where} {name} K{k} N{n} "
              f"{qt.bits}b-{qt.mode}: reuse rate {rates[name]:.4f} "
              f"(kernel count {count} = reuse_mult_count at M "
              f"{', '.join(f'{m} [{path_of(m, x, qt)}]' for m in rows)}"
              f"; analytic gaussian model {predicted:.4f})", flush=True)
    key = "reuse_rate_" + where.replace(" ", "_").replace("layer_", "layer")
    return {key: rates, "reuse_rate_predicted": predicted}


def layer0_reuse_rates(eng, label, card, rows=(N_SLOTS,)) -> dict:
    """:func:`reuse_rates` on layer 0's attention and FFN projections of
    ``eng``'s served weights."""
    from repro_torch.models.transformer import layer_slice
    layer0 = layer_slice(eng.params["layers"], 0)
    return reuse_rates({**layer0["attn"], **layer0["ffn"]}, "layer 0", label,
                       card, rows)


def run_b_prompts() -> list:
    """Run b's 16 prompts: a shared 256-token head and tails of
    64/200/255 tokens (numpy seed 1), which run g serves too."""
    import numpy as np
    from repro_torch.configs.repro_100m import CONFIG

    rng = np.random.default_rng(1)
    vocab = CONFIG.vocab_size
    head = rng.integers(0, vocab, size=SHARED_PREFIX).astype(np.int32)
    return [np.concatenate([head, rng.integers(
        0, vocab, size=TAIL_LENS[i % len(TAIL_LENS)]).astype(np.int32)])
        for i in range(N_REQUESTS)]


def end_to_end_reuse_paged(dev, card):
    """Run b, and the reuse rate the kernel achieves on layer 0's seven
    projections of the served weights. Returns (metrics, its requests'
    tokens, its engine)."""
    e2e, eng = serve_run(dev, card, "reuse+paged", run_b_prompts(), (
        "reuse_matmul", "reuse_matmul.wgmma", "reuse_matmul.gemv",
        "paged_decode_attention",
        "flash_attention", "flash_attention.wgmma"),
        impl="reuse", paged=True, kv_block_size=KV_BLOCK)
    check(e2e["prefix_hit_tokens"] >= N_SLOTS * SHARED_PREFIX,
          f"reuse+paged: only {e2e['prefix_hit_tokens']} prefix-hit tokens")
    e2e.update(layer0_reuse_rates(eng, "reuse+paged", card))
    return e2e, served_tokens(eng), eng


def end_to_end_lora(dev, card):
    """Run c: run a's prompts on the reuse pipeline with fused projections
    and four LoRA adapters, the requests cycling base/a0/a1/a2/a3; the
    counted reuse rate of layer 0's fused wqkv and gate_up."""
    registry = run_c_registry(e2e_config(), dev)
    prompts = run_a_prompts()
    cycle = (None,) + ADAPTERS
    names = [cycle[i % len(cycle)] for i in range(N_REQUESTS)]
    e2e, eng = serve_run(dev, card, "lora+reuse+fused", prompts, (
        "reuse_matmul", "reuse_matmul.wgmma", "reuse_matmul.gemv",
        "decode_attention",
        "flash_attention", "flash_attention.wgmma"), names=names,
        registry=registry, impl="reuse", fuse_qkv=True)
    check(e2e["lora_requests"] == sum(n is not None for n in names),
          f"lora+reuse+fused: {e2e['lora_requests']} LoRA requests admitted")
    e2e.update(layer0_reuse_rates(eng, "lora+reuse+fused", card))
    check({"wqkv", "gate_up"} <= set(e2e["reuse_rate_layer0"]),
          "lora+reuse+fused: layer 0 is not fused")
    return e2e


def end_to_end_nf4(dev, card):
    """Run d: run a's prompts through a reuse engine on NF4 weights (4-bit
    codebook, packed, per channel: the QLoRA-style base). Every prefill
    projection takes the codebook route of the tensor cores and every
    decode projection the split-K table kernel; layer 0's counted reuse
    rates on both paths."""
    from repro_torch.core.quantization import QTensor

    e2e, eng = serve_run(dev, card, "nf4+reuse", run_a_prompts(), (
        "reuse_matmul", "reuse_matmul.wgmma", "reuse_matmul.gemv",
        "decode_attention",
        "flash_attention", "flash_attention.wgmma"),
        impl="reuse", quant_bits=4, quant_mode="codebook")
    wq = eng.params["layers"]["attn"]["wq"]
    check(isinstance(wq, QTensor) and (wq.bits, wq.mode, wq.packed) ==
          (4, "codebook", True), "nf4+reuse: the engine does not serve "
          "packed NF4 weights")
    # one launch per projection and layer: every prefill one on the tensor
    # cores, every decode one on the split-K kernel
    n_proj = 7 * eng.cfg.n_layers
    got = e2e["launches"]
    check(got.get("reuse_matmul.wgmma") == n_proj * e2e["prefill_waves"],
          f"nf4+reuse: {got.get('reuse_matmul.wgmma')} tensor-core launches "
          f"for {e2e['prefill_waves']} prefill waves of {n_proj} "
          "projections")
    check(got.get("reuse_matmul.gemv") == n_proj * e2e["steps"],
          f"nf4+reuse: {got.get('reuse_matmul.gemv')} decode launches for "
          f"{e2e['steps']} decode steps of {n_proj} projections")
    e2e.update(layer0_reuse_rates(eng, "nf4+reuse", card,
                                  rows=(N_SLOTS, 512)))
    return e2e


def profile_rounds(eng, rounds: int = 4) -> dict:
    """torch.profiler over ``rounds`` speculative rounds of ``eng`` (one
    step each, no admission), split into the draft and the verify halves.
    Each half runs inside a ``record_function`` range that ends with a
    synchronize, so its kernels run inside the range's wall time; a kernel
    counts for the half whose range holds its start (the ctypes launches
    of the port's kernels are no torch ops, so the ranges' own device
    totals miss them). Per half: wall ms (the ranges' host time),
    device-busy ms, idle share; and the same over the whole window, whose
    busy time outside both halves is the round's own bookkeeping."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    make = eng._spec_fns
    names = ("spec.draft", "spec.verify")

    def annotated():
        halves = dict(zip(names, make()))

        def wrap(name):
            def fn(*args):
                with record_function(name):
                    out = halves[name](*args)
                    torch.cuda.synchronize()
                return out
            return fn
        return wrap(names[0]), wrap(names[1])

    eng._spec_fns = annotated
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(rounds):
                eng.step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        eng._spec_fns = make
    ranges = {name: [] for name in names}
    kernels = []
    for e in prof.events():
        if e.name in ranges:
            if e.device_type == DeviceType.CPU:
                ranges[e.name].append((e.time_range.start, e.time_range.end))
        elif e.device_type == DeviceType.CUDA:
            kernels.append((e.time_range.start, e.time_range.elapsed_us()))
    out = {name: dict(wall_ms=sum(b - a for a, b in spans) / 1e3,
                      busy_ms=0.0, ranges=len(spans))
           for name, spans in ranges.items()}
    busy = 0.0
    for start, us in kernels:
        busy += us / 1e3
        for name, spans in ranges.items():
            if any(a <= start < b for a, b in spans):
                out[name]["busy_ms"] += us / 1e3
    for half in out.values():
        half["idle_share"] = 1.0 - half["busy_ms"] / half["wall_ms"]
    return dict(wall_ms=wall, busy_ms=busy, idle_share=1.0 - busy / wall,
                outside_ms=busy - sum(h["busy_ms"] for h in out.values()),
                draft=out[names[0]], verify=out[names[1]])


def timed_drafts():
    """Wrap the engine module's ``derive_draft_params`` so that each
    derivation's host seconds are recorded and the engines of one run share
    one draft (the warm-up engine and the measured one derive the same
    tree from the same weights). Returns (the record, a function that
    restores the original)."""
    from repro_torch.serve import engine as engine_mod
    derive = engine_mod.derive_draft_params
    record = dict(seconds=[], cache={})

    def timed(params, *, bits, mode):
        key = (bits, mode)
        if key not in record["cache"]:
            import torch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            record["cache"][key] = derive(params, bits=bits, mode=mode)
            torch.cuda.synchronize()
            record["seconds"].append(time.perf_counter() - t0)
        return record["cache"][key]

    engine_mod.derive_draft_params = timed

    def restore():
        engine_mod.derive_draft_params = derive
    return record, restore


def spec_run(dev, card, label, prompts, ref_tokens, kernels, **engine_kw):
    """One speculative end-to-end run on ``e2e_config()``: ``prompts``
    through ``ServeEngine(quantize=True, n_slots=8, max_len=1024,
    decode_chunk=8, speculate=True, **engine_kw)``, every launch count set
    to 0 just before and read just after, each of ``kernels`` required to
    have launched, the pager's books checked after every step. Each
    request's tokens must equal ``ref_tokens`` (the target-only run of the
    same engine, earlier in this call), and every emitted token beyond the
    prefill's must have come from a round. Returns (metrics, the
    engine)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import ServeEngine

    cfg = e2e_config()
    params = get_model(cfg).init(seed=0, device=dev)
    tag = f"e2e {label} [{card}]"
    drafts, restore = timed_drafts()
    try:
        def engine():
            return ServeEngine(cfg, params, n_slots=N_SLOTS,
                               max_len=MAX_LEN, quantize=True,
                               decode_chunk=DECODE_CHUNK, speculate=True,
                               device=dev, **engine_kw)

        engine().generate(prompts[:2], max_new=8)     # warm-up
        eng = engine()
        prof_eng = engine()
    finally:
        restore()
    for p in prompts:
        eng.submit(p, max_new=MAX_NEW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    steps = 0
    while eng.step():
        steps += 1
        if eng.paged:
            eng.pager.check_consistency()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    got = served_tokens(eng)
    check(len(got) == len(prompts), f"{label}: only {len(got)} of "
          f"{len(prompts)} requests finished")
    same = [i for i, (a, b) in enumerate(zip(got, ref_tokens)) if a == b]
    for i, (a, b) in enumerate(zip(got, ref_tokens)):
        if a != b:
            first = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            print(f"{tag}: request {i} differs from the target-only run at "
                  f"token {first}: {a[first:first + 4]} against "
                  f"{b[first:first + 4]}", flush=True)
    check(len(same) == len(prompts), f"{label}: {len(prompts) - len(same)} "
          "requests' tokens differ from the target-only run's")
    st = eng.stats
    generated = sum(len(t) for t in got)
    check(st.spec_emitted_tokens == generated - len(prompts),
          f"{label}: {st.spec_emitted_tokens} tokens from rounds, "
          f"{generated} generated for {len(prompts)} requests")
    for name in kernels:
        check(launches.get(name, 0) > 0, f"{label}: {name} never launched "
                                         "on the main path")
    for lib in ("axllm_matmul", "reuse_matmul"):
        check(launches.get(lib, 0) == launches.get(f"{lib}.wgmma", 0)
              + launches.get(f"{lib}.gemv", 0), f"{label}: {lib} launches "
              f"{launches.get(lib, 0)} are not wgmma "
              f"{launches.get(f'{lib}.wgmma', 0)} + gemv "
              f"{launches.get(f'{lib}.gemv', 0)}: the tile kernel ran")
    check(launches.get("flash_attention.wgmma") ==
          launches.get("flash_attention"), f"{label}: flash launches "
          f"{launches.get('flash_attention')} of which "
          f"{launches.get('flash_attention.wgmma')} on the tensor cores")
    if eng.paged:
        # at drain the pool holds the published prefixes alone
        check(all(not eng.pager.slot_blocks(i) for i in range(N_SLOTS)),
              f"{label}: a slot holds blocks at drain")
        check(eng.pager.blocks_in_use == eng.pager.evictable_blocks(),
              f"{label}: {eng.pager.blocks_in_use} blocks in use at drain, "
              f"{eng.pager.evictable_blocks()} of them published prefixes")
    print(f"{tag}: {generated} tokens in {wall:.3f} s = "
          f"{generated / wall:.1f} tok/s; {len(same)}/{len(prompts)} "
          f"requests identical to the target-only run; {st.spec_rounds} "
          f"rounds ({steps} engine steps), {st.steps} target steps, "
          f"drafted {st.drafted_tokens}, accepted "
          f"{st.accepted_draft_tokens}: acceptance rate "
          f"{st.acceptance_rate:.4f}, accepted tokens per step "
          f"{st.accepted_tokens_per_step:.4f}; prefill {st.prefill_waves} "
          f"waves, {st.prefill_tokens} tokens, {st.prefill_wall_s:.3f} s; "
          f"prefix-hit tokens {st.prefix_hit_tokens}; peak memory "
          f"{peak / 2**30:.3f} GiB"
          + "".join(f"; draft derived in {x:.3f} s on the host"
                    for x in drafts["seconds"]), flush=True)
    print(f"{tag}: launches {launches}", flush=True)

    # where a round's time goes: 4 rounds of 8 full slots, profiled
    for p in prompts[:N_SLOTS]:
        prof_eng.submit(p, max_new=MAX_NEW)
    prof_eng.step()                             # prefill + first round
    prof = profile_rounds(prof_eng)
    print(f"{tag}: 4 rounds (8 slots): wall {prof['wall_ms']:.2f} ms, "
          f"device busy {prof['busy_ms']:.2f} ms, idle share "
          f"{prof['idle_share']:.3f}; draft half wall "
          f"{prof['draft']['wall_ms']:.2f} ms, busy "
          f"{prof['draft']['busy_ms']:.2f} ms, idle "
          f"{prof['draft']['idle_share']:.3f}; verify half wall "
          f"{prof['verify']['wall_ms']:.2f} ms, busy "
          f"{prof['verify']['busy_ms']:.2f} ms, idle "
          f"{prof['verify']['idle_share']:.3f}; busy outside both "
          f"{prof['outside_ms']:.2f} ms", flush=True)
    return dict(tokens=generated, wall_s=wall, tok_per_s=generated / wall,
                spec_rounds=st.spec_rounds, engine_steps=steps,
                steps=st.steps, drafted_tokens=st.drafted_tokens,
                accepted_draft_tokens=st.accepted_draft_tokens,
                acceptance_rate=st.acceptance_rate,
                accepted_tokens_per_step=st.accepted_tokens_per_step,
                spec_emitted_tokens=st.spec_emitted_tokens,
                prefill_wall_s=st.prefill_wall_s,
                prefill_waves=st.prefill_waves,
                prefix_hit_tokens=st.prefix_hit_tokens, peak_bytes=peak,
                requests_identical=len(same), launches=launches,
                draft_seconds=drafts["seconds"], round_profile=prof), eng


def end_to_end_spec_dense(dev, card, ref_tokens):
    """Run f: run a's engine and prompts with an int4 affine draft, four
    proposals a round; tokens held to run a's."""
    return spec_run(dev, card, "spec dense (int4 draft)", run_a_prompts(),
                    ref_tokens, (
                        "axllm_matmul", "axllm_matmul.wgmma",
                        "axllm_matmul.gemv", "decode_attention",
                        "flash_attention", "flash_attention.wgmma"),
                    spec_k=4, draft_bits=4, draft_mode="affine")[0]


def end_to_end_spec_paged(dev, card, ref_tokens):
    """Run g: run b's engine and prompts with an 8-plane shift-add draft
    (dense float32 weights: their projections are plain products), eight
    proposals a round; tokens held to run b's. The draft's cache is dense:
    its steps run ``decode_attention``, the target's verify steps the paged
    kernel."""
    return spec_run(dev, card, "spec reuse+paged (shift-add draft)",
                    run_b_prompts(), ref_tokens, (
                        "reuse_matmul", "reuse_matmul.wgmma",
                        "reuse_matmul.gemv", "paged_decode_attention",
                        "decode_attention", "flash_attention",
                        "flash_attention.wgmma"),
                    impl="reuse", paged=True, kv_block_size=KV_BLOCK,
                    spec_k=8, draft_bits=8, draft_mode="shiftadd")[0]


# runs h, i, j and k: (config, layers kept, why the rest are cut; None:
# full depth)
FAMILY_RUNS = {
    "moe": ("qwen2-moe-a2.7b", 2, "chip time: the script must finish well "
            "within 1200 s with runs p to s; at 24 layers the raw bf16 tree "
            "alone is 30.3 GB"),
    "vlm": ("chameleon-34b", 2, "chip time, as run h; at 48 layers its "
            "34.3 B parameters (68.6 GB raw plus 34 GB of codes) do not fit "
            "in 80 GB"),
    "ssm": ("xlstm-1.3b", 8, "chip time (run l and the launcher phase "
            "joined the call; at 48 layers run j alone took 157 s, at 16 "
            "55-70 s); 8 layers keep one super-block, 7 mLSTM and the sLSTM"),
    "hybrid": ("zamba2-1.2b", 14, "chip time, as run h; 14 layers keep 2 "
               "of its 6 attention sites and its remainder of 2 Mamba2 "
               "layers"),
}
FAMILY_KERNELS = ("axllm_matmul", "axllm_matmul.wgmma", "axllm_matmul.gemv",
                  "decode_attention", "flash_attention",
                  "flash_attention.wgmma")
# runs j and k: the kernels each must launch, the engine's impl and the
# model's dtype. Run k's mixers take axllm_matmul under impl="reuse" (as
# in the JAX package); its shared attention block and head take
# reuse_matmul. Run j serves xlstm-1.3b in float32: in bf16 its plain path
# does not reproduce itself (random weights, at full depth: the same prompt
# in another batch, or chunked otherwise, moves the logits by a third of
# their scale, and the kernel path lies as far off; in float32 both stay
# within 3e-4 of the scale), so no token gate could hold it. Its
# projections then take the SIMT tile kernel at prefill (f32 activations)
# and the split-K kernel at decode
RECURRENT_RUNS = {
    "ssm": (("axllm_matmul", "axllm_matmul.gemv"), "auto", "float32"),
    "hybrid": (("axllm_matmul", "axllm_matmul.wgmma", "axllm_matmul.gemv",
                "reuse_matmul", "reuse_matmul.wgmma", "reuse_matmul.gemv",
                "decode_attention", "flash_attention",
                "flash_attention.wgmma"), "reuse", None),
}


def xlstm_tile_launches(cfg):
    """``tile_expect`` of run j: the launches of xLSTM's projections on
    the tile kernel. mLSTM's wif (N = 2 heads, not a multiple of 16) takes
    it at every decode step; at a prefill wave (every wave of run a's
    prompts holds more than 16 tokens) the f32-activation projections do:
    wif and the sLSTM's wx always, and in a float32 model all five mLSTM
    and four sLSTM projections."""
    from repro_torch.models.xlstm import _superblock_counts
    n_super, m_per = _superblock_counts(cfg)
    f32 = cfg.dtype == "float32"
    per_wave = n_super * m_per * (5 if f32 else 1) + n_super * (4 if f32
                                                                else 1)

    def expect(st):
        return {"axllm_matmul": n_super * m_per * st.steps
                + per_wave * st.prefill_waves}
    return expect


def moe_drops(cfg):
    """``after`` of run h: the share of layer 0's (token, choice) pairs of
    the first wave that the capacity dropped, by the port's own dispatch
    (``moe._dispatch_row``) on the FFN input the wave gave layer 0, over
    all pairs and over the real (not padding) tokens' pairs."""
    def after(prefill, wave):
        import torch
        from repro_torch.models import moe as M
        seen, orig = [], M.moe_ffn

        def hook(p, x, c, impl="auto"):
            if not seen:
                seen.append((p, x))
            return orig(p, x, c, impl=impl)

        M.moe_ffn = hook
        try:
            prefill()
        finally:
            M.moe_ffn = orig
        p, x = seen[0]
        b, s, d = x.shape
        k = cfg.top_k
        w, e = M._route(p, x.reshape(-1, d), cfg)
        cap = M.capacity(cfg, s)
        _, _, tok, _, keep, _ = M._dispatch_row(
            w.reshape(b, s, k), e.reshape(b, s, k), cfg.padded_experts, cap,
            k)
        lengths = torch.tensor([len(q) for q in wave], device=x.device)
        real = tok < lengths[:b, None]
        all_share = 1.0 - float(keep.float().mean())
        real_share = 1.0 - float(keep[real].float().mean())
        print(f"e2e moe: layer 0 of the first wave (B{b} S{s}, capacity "
              f"{cap} pairs an expert a row): {all_share:.4f} of its "
              f"{keep.numel()} (token, choice) pairs dropped, "
              f"{real_share:.4f} of the {int(real.sum())} real tokens' "
              f"pairs", flush=True)
        return dict(layer0_drop_share=all_share,
                    layer0_real_drop_share=real_share, layer0_capacity=cap)
    return after


def reproducibility(dev, card, cfg, f32_params) -> dict:
    """Why run j serves in float32: request 3's prompt (64 tokens) through
    ``cfg``'s int8 model in bf16 (weights from seed 0) and in float32
    (``f32_params``, run j's served weights), alone and as row 1 of a
    batch of four (requests 0, 3, 6 and a row of zeros), on the plain path
    and on the kernel path. Prints and returns each pair's largest logit
    difference at the last position over the logit scale."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.axllm_linear import deploy_quantize
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.models.model import get_model
    prompts = run_a_prompts()
    alone = torch.from_numpy(np.asarray(prompts[3], np.int64))[None].to(dev)
    four = torch.from_numpy(np.stack(
        [prompts[0], prompts[3], prompts[6], np.zeros_like(prompts[0])])
        .astype(np.int64)).to(dev)
    out = {}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        params = f32_params if dtype == "float32" else deploy_quantize(
            get_model(c).init(seed=0, device=dev), QuantConfig(bits=8))

        def last(impl, toks, row=0):
            api = get_model(c, impl=impl)
            with torch.inference_mode():
                return api.prefill(params, {"tokens": toks},
                                   api.init_cache(len(toks), toks.shape[1],
                                                  dev))[0][row].float()

        plain = last("ref", alone)
        scale = max(1.0, float(plain.abs().max()))
        pairs = {"plain in a batch of four": last("ref", four, 1),
                 "kernel path": last("auto", alone)}
        out[dtype] = {k: float((v - plain).abs().max()) / scale
                      for k, v in pairs.items()}
        print(f"e2e ssm [{card}]: {dtype}, request 3's prompt alone on the "
              f"plain path against "
              + "; ".join(f"{k}: {v:.4e} of the logit scale {scale:.4f}"
                          for k, v in out[dtype].items()), flush=True)
        del params
        torch.cuda.empty_cache()
    return out


def end_to_end_family(dev, card, family):
    """Run h (moe), i (vlm), j (ssm) or k (hybrid): the config at full
    width, cut in depth where ``FAMILY_RUNS`` says, serving run a's
    requests as run a does. Earlier runs' engines hold reference cycles
    (their wrapped methods), so they are collected first: the peaks then
    count this run's tensors alone. Run k also reads the reuse rate the
    kernel counts on the shared attention block's projections."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    name, layers, why = FAMILY_RUNS[family]
    full = get_config(name)
    cfg = dataclasses.replace(full, n_layers=layers)
    kw = {}
    kernels = FAMILY_KERNELS
    if family in RECURRENT_RUNS:
        kernels, kw["impl"], dtype = RECURRENT_RUNS[family]
        cfg = dataclasses.replace(cfg, dtype=dtype or cfg.dtype)
        if family == "ssm":
            kw["tile_expect"] = xlstm_tile_launches(cfg)
    depth = (f"full depth, {layers} layers" if layers == full.n_layers
             else f"depth cut to {layers} of {full.n_layers} layers: {why}")
    print(f"e2e {family} [{card}]: {name} at full width (d_model "
          f"{cfg.d_model}, H{cfg.n_heads}/Hk{cfg.n_kv_heads}, head dim "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
          f"padded {cfg.padded_vocab}"
          + (f", {cfg.n_experts} experts padded to {cfg.padded_experts}, "
             f"top-{cfg.top_k}, {cfg.n_shared_experts} shared, capacity "
             f"factor {cfg.capacity_factor}" if cfg.n_experts else "")
          + (f", an sLSTM every {cfg.xlstm_slstm_every} blocks"
             if cfg.xlstm_slstm_every else "")
          + (f", ssm_state {cfg.ssm_state}, SSM head dim "
             f"{cfg.ssm_head_dim}, shared attention every "
             f"{cfg.hybrid_attn_every} layers" if cfg.hybrid_attn_every
             else "")
          + f", {cfg.dtype}), {depth}; {cfg.n_params() / 1e9:.3f} G "
          f"parameters at this depth", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    if family == "moe":
        kw["after"] = moe_drops(cfg)
    e2e, eng = serve_run(dev, card, family, run_a_prompts(), kernels,
                         cfg=cfg, **kw)
    if family == "ssm":
        e2e["reproducibility"] = reproducibility(
            dev, card, dataclasses.replace(full, n_layers=layers), eng.params)
    if family == "hybrid":
        shared = eng.params["shared"]
        e2e.update(reuse_rates({**shared["attn"], **shared["mlp"]},
                               "shared block", family, card))
    del eng
    torch.cuda.empty_cache()
    return dict(e2e, config=name, layers=layers, full_layers=full.n_layers)


def simulator_phase(eng, card) -> dict:
    """The paper's cycle model on the int8 codes run b serves (7 matrices a
    layer, full width): each matrix's multiply count from the reuse kernel
    (``reuse_matmul_cuda(with_stats=True)`` at M = 8, its counting segment
    256 for every N here; the port's wrapper counts per activation row, so
    times 8) must equal ``simulate_matrix(codes, SimConfig(),
    tokens=8).mults`` (segments of ``SimConfig.buf`` = 256 columns, sign
    folded: the kernel's definition). Hazards are not measured (their
    penalty is 0, so no cycle count moves). Prints the model's computation
    reduction, simulated speedup and power reduction: figures of the cycle
    model for the paper's accelerator, not of the card."""
    import torch
    from repro_torch.core.energy import power_report
    from repro_torch.core.quantization import QTensor
    from repro_torch.core.simulator import SimConfig, SimReport, \
        simulate_matrix
    from repro_torch.kernels.reuse_matmul import reuse_matmul_cuda, segment
    from repro_torch.models.transformer import layer_slice

    sim = SimConfig()
    total = SimReport(0.0, 0.0, 0, 0, 0, 0)
    tag = f"simulator [{card}]"
    per = {}
    t0 = time.perf_counter()
    for layer in range(eng.cfg.n_layers):
        lp = layer_slice(eng.params["layers"], layer)
        for group in ("attn", "ffn"):
            for name, qt in lp[group].items():
                if not isinstance(qt, QTensor):
                    continue
                k, n = qt.shape
                check((qt.bits, qt.mode) == (8, "affine") and
                      segment(n) == sim.buf, f"simulator: {name} is "
                      f"{qt.bits}b-{qt.mode} N{n}")
                x = torch.ones((N_SLOTS, k), dtype=torch.bfloat16,
                               device=qt.codes.device)
                _, mults = reuse_matmul_cuda(x, qt, with_stats=True)
                kernel = int(mults) * N_SLOTS
                rep = simulate_matrix(qt, sim, tokens=N_SLOTS,
                                      measure_hazards=False)
                check(kernel == rep.mults, f"simulator: layer {layer} {name}"
                      f": kernel counted {kernel}, the cycle model "
                      f"{rep.mults}")
                total = total.merge(rep)
                per.setdefault(name, []).append(
                    dict(kernel_mults=kernel, model_mults=rep.mults,
                         total_ops=rep.total_ops,
                         speedup=rep.speedup))
    wall = time.perf_counter() - t0
    matrices = sum(len(v) for v in per.values())
    check(matrices == 7 * eng.cfg.n_layers,
          f"simulator: {matrices} matrices, not 7 a layer")
    pr = power_report(total)
    reduction = 1.0 - total.mults / total.total_ops
    print(f"{tag}: {matrices} int8 matrices of run b's served model: each "
          f"reuse kernel multiply count (M {N_SLOTS}, segment {sim.buf}) "
          f"equals simulate_matrix(tokens={N_SLOTS}).mults; "
          f"{wall:.1f} s", flush=True)
    print(f"{tag}: the cycle model's figures for the paper's accelerator "
          f"(not card time): computation reduction 1 - mults/total_ops = "
          f"{reduction:.4f} ({total.mults} of {total.total_ops}); simulated "
          f"speedup {total.speedup:.4f} ({total.cycles_baseline:.0f} / "
          f"{total.cycles_axllm:.0f} cycles); power reduction "
          f"{pr['power_reduction']:.4f}, energy reduction "
          f"{pr['energy_reduction']:.4f} (energy.power_report)",
          flush=True)
    return dict(matrices=matrices, mults=total.mults,
                total_ops=total.total_ops, computation_reduction=reduction,
                cycles_axllm=total.cycles_axllm,
                cycles_baseline=total.cycles_baseline,
                simulated_speedup=total.speedup, power=pr, wall_s=wall,
                per_matrix=per)


def prompt_cycle(n: int) -> list:
    """``n`` prompts on run a's cycle of lengths (64/200/511 tokens, numpy
    seed 0): the first 16 are run a's."""
    import numpy as np
    from repro_torch.configs.repro_100m import CONFIG
    rng = np.random.default_rng(0)
    return [rng.integers(0, CONFIG.vocab_size,
                         size=PROMPT_LENS[i % len(PROMPT_LENS)])
            .astype(np.int32) for i in range(n)]


def check_fast_restores(eng) -> dict:
    """Wrap a paged engine's swap-out and fast restore so that each fast
    restore is held to the KV its slot had at swap-out, bit for bit (the
    full blocks through the radix index, the tail through the host copy).
    Returns the running tally."""
    import torch
    tally, kv_at_swap = dict(checked=0), {}
    preempt, restore = eng._preempt_slot, eng._try_fast_restore

    def slot_kv(slot, n):
        idx = torch.tensor(eng.pager.slot_blocks(slot), device=eng.device)
        return {name: eng.cache[name][:, idx].flatten(1, 2)[:, :n].clone()
                for name in eng._pool_leaves}

    def preempt_slot(i):
        r = eng.slots[i]
        if not r.prefilling:
            kv_at_swap[r.rid] = slot_kv(i, len(eng._kv_seq(r)))
        preempt(i)

    def try_fast_restore(r, slot):
        if not restore(r, slot):
            return False
        want = kv_at_swap.pop(r.rid)
        got = slot_kv(slot, next(iter(want.values())).shape[1])
        for name in want:
            check(torch.equal(got[name], want[name]), f"fast restore of "
                  f"request {r.rid}: {name} differs from its KV at swap-out")
        tally["checked"] += 1
        return True

    eng._preempt_slot, eng._try_fast_restore = preempt_slot, try_fast_restore
    return tally


def percentiles(xs) -> tuple:
    import numpy as np
    return float(np.percentile(xs, 50)), float(np.percentile(xs, 99))


def end_to_end_overload(dev, card):
    """Run e: run a's prompt cycle on a paged int8 engine whose pool cannot
    hold eight seated requests to their end, under a prefill budget, with
    priority arrivals, two streams (one hanging up) and a cancel while
    queued; beside it the same prompts on an unloaded engine of the same
    kernels, and a profiled step that holds a continuation chunk."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ref as plain
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import ServeEngine, StopStream
    from repro_torch.serve.token_gate import token_gate

    cfg = e2e_config()
    params = get_model(cfg).init(seed=0, device=dev)
    prompts = prompt_cycle(E_REQUESTS)
    tag = f"e2e overload+chunked [{card}]"
    smallest_pool = N_SLOTS * -(-MAX_LEN // KV_BLOCK) + 2

    def engine(squeeze=False, **kw):
        """An engine of run e's kernels; ``squeeze``: run e's budget and a
        pool of E_USABLE free blocks (the rest held in ``eng.held``)."""
        if squeeze:
            kw.update(prefill_budget=E_BUDGET, num_blocks=smallest_pool)
        eng = ServeEngine(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                          quantize=True, decode_chunk=DECODE_CHUNK,
                          paged=True, kv_block_size=KV_BLOCK, device=dev,
                          **kw)
        eng.held = [eng.pager.alloc() for _ in range(
            len(eng.pager._free) - E_USABLE)] if squeeze else []
        return eng

    def serve(eng, late_after=None):
        """Step ``eng`` to the end; the late requests go in after step
        ``late_after``. Returns per-step (wall s, prefill tokens, whether
        a slot was mid-prefill when the step began)."""
        steps = []
        while True:
            st = eng.stats
            before = st.prefill_tokens
            cont = any(s is not None and s.prefilling for s in eng.slots)
            t0 = time.perf_counter()
            more = eng.step()
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0,
                          st.prefill_tokens - before, cont))
            eng.pager.check_consistency(external=eng.held)
            if not more:
                return steps
            if len(steps) == late_after:
                free = sum(s is None for s in eng.slots)
                check(free < E_LATE, f"run e: {free} free slots take all "
                      "the priority arrivals")
                for i in range(E_REQUESTS - E_LATE, E_REQUESTS):
                    eng.submit(prompts[i], max_new=MAX_NEW, priority=1)

    engine(squeeze=True).generate(prompts[:2], max_new=8)     # warm-up
    eng = engine(squeeze=True)
    restores = check_fast_restores(eng)
    by_priority, priority_preempt = [0], eng._priority_preempt

    def counted_priority_preempt():
        before = eng.stats.preempted
        priority_preempt()
        by_priority[0] += eng.stats.preempted - before

    eng._priority_preempt = counted_priority_preempt
    streamed = {}

    def tap(req, tok):
        streamed.setdefault(req.rid, []).append(tok)

    def hang_up(req, tok):
        tap(req, tok)
        if len(streamed[req.rid]) == E_HANGUP_AFTER:
            raise StopStream()

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    for i in range(E_REQUESTS - E_LATE):
        eng.submit(prompts[i], max_new=MAX_NEW,
                   on_token={E_STREAM: tap, E_HANGUP: hang_up}.get(i))
    check(eng.cancel(E_CANCEL), "run e: the queued cancel found nothing")
    steps = serve(eng, late_after=2)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)

    st = eng.stats
    done = {r.rid: r for r in eng.finished}
    check(len(eng.finished) == len(done) == E_REQUESTS
          and sorted(done) == list(range(E_REQUESTS)),
          f"run e: {len(eng.finished)} finishes of {len(done)} requests")
    for rid, r in done.items():
        want = {E_CANCEL: ("cancelled", 0), E_HANGUP: (
            "cancelled", E_HANGUP_AFTER)}.get(rid, ("max_new", MAX_NEW))
        check((r.finish_reason, len(r.tokens)) == want, f"run e: request "
              f"{rid} ended {r.finish_reason} with {len(r.tokens)} tokens")
    for rid in (E_STREAM, E_HANGUP):
        check(streamed.get(rid) == done[rid].tokens, f"run e: request {rid} "
              "streamed other tokens than it holds")
    check(by_priority[0] > 0 and st.preempted > by_priority[0]
          and st.restored == st.preempted, f"run e: {st.preempted} "
          f"preemptions ({by_priority[0]} for priority), {st.restored} "
          "restores")
    check(restores["checked"] == st.fast_restores, "run e: a fast restore "
          "went unchecked")
    most = max(p for _, p, _ in steps)
    continuation_steps = sum(c for *_, c in steps)
    check(st.prefill_chunks > st.prefill_waves and continuation_steps > 0
          and most <= E_BUDGET, f"run e: {st.prefill_chunks} chunks in "
          f"{st.prefill_waves} waves, {continuation_steps} steps with a "
          f"continuation, at most {most} prefill tokens a step")
    check(not eng.queue and all(s is None for s in eng.slots)
          and eng.registry is None, "run e: the engine did not drain")
    for b in eng.held:
        eng.pager._release_block(b)
    eng.pager.evict_prefixes()
    check(eng.pager.blocks_in_use == 0, f"run e: {eng.pager.blocks_in_use} "
          "pool blocks held after the drain")
    check(launches.get("axllm_matmul", 0) == launches.get(
        "axllm_matmul.wgmma", 0) + launches.get("axllm_matmul.gemv", 0),
        f"run e: axllm_matmul launches {launches} are not wgmma + gemv")
    for name in ("axllm_matmul.wgmma", "axllm_matmul.gemv",
                 "paged_decode_attention", "flash_attention.wgmma"):
        check(launches.get(name, 0) > 0, f"run e: {name} never launched")
    check(launches.get("flash_attention") == launches.get(
        "flash_attention.wgmma"), f"run e: flash launches {launches}")
    generated = sum(len(r.tokens) for r in done.values())
    ttft = [r.t_first - r.t_submit for r in done.values()
            if r.t_first is not None]
    p50, p99 = percentiles(ttft)
    step_max = max(w for w, *_ in steps)
    print(f"{tag}: {generated} tokens in {wall:.3f} s = {generated / wall:.1f}"
          f" tok/s; {len(steps)} steps; preempted {st.preempted} (for "
          f"priority {by_priority[0]}, mid-prefill {st.preempted_prefill}), "
          f"restored {st.restored} (fast {st.fast_restores}, each bit-exact "
          f"to its KV at swap-out), cancelled {st.cancelled}; prefill "
          f"{st.prefill_chunks} chunks in {st.prefill_waves} waves, "
          f"{continuation_steps} steps with a "
          f"continuation, at most {most} prompt tokens a step (budget "
          f"{E_BUDGET}), {st.prefill_tokens} tokens, prefix-hit tokens "
          f"{st.prefix_hit_tokens}; pool {E_USABLE} usable blocks", flush=True)
    print(f"{tag}: launches {launches}", flush=True)
    gate = token_gate(cfg, eng.params, prompts,
                      [done[i].tokens for i in range(E_REQUESTS)],
                      impl="ref", tol_rel=LOGIT_TOL, device=dev)
    print(f"{tag}: token gate: {gate.positions} generated positions checked "
          f"against the plain path's teacher-forced logits; {gate.differ} "
          f"where the token is not the plain path's argmax; smallest slack "
          f"{gate.min_slack:.4e}; {len(gate.failures)} positions more than "
          f"2 x tol below the plain maximum", flush=True)
    check(gate.ok, f"run e: token gate failed at (request, position, slack) "
                   f"{gate.failures[:5]}")

    # the same prompts on an unloaded engine of the same kernels: default
    # pool, no budget, all at priority 0
    calm = engine()
    c0 = time.perf_counter()
    for p in prompts:
        calm.submit(p, max_new=MAX_NEW)
    calm_steps = serve(calm)
    calm_wall = time.perf_counter() - c0
    calm_done = {r.rid: r for r in calm.finished}
    c50, c99 = percentiles([r.t_first - r.t_submit
                            for r in calm_done.values()])
    served = [i for i in range(E_REQUESTS) if i not in (E_CANCEL, E_HANGUP)]
    same = sum(done[i].tokens == calm_done[i].tokens for i in served)
    agree = float(np.mean([np.mean(np.equal(done[i].tokens,
                                            calm_done[i].tokens))
                           for i in served]))
    calm_max = max(w for w, *_ in calm_steps)
    print(f"{tag}: TTFT p50 {p50 * 1e3:.1f} ms, p99 {p99 * 1e3:.1f} ms, "
          f"largest step {step_max * 1e3:.1f} ms; unloaded engine: TTFT p50 "
          f"{c50 * 1e3:.1f} ms, p99 {c99 * 1e3:.1f} ms, largest step "
          f"{calm_max * 1e3:.1f} ms, {len(calm_steps)} steps, "
          f"{calm_wall:.3f} s", flush=True)
    print(f"{tag}: greedy tokens vs the unloaded engine: {same}/{len(served)}"
          f" requests identical, {agree:.3f} of positions equal (not "
          "required: budgeted chunks and recompute restores run other "
          "shapes)", flush=True)

    # where a continuation step's time goes: a fresh loaded engine, its
    # second step (the first leaves a slot mid-prefill), profiled, with the
    # plain prefix attention's share (annotated, and its calls replayed)
    prof_eng = engine(squeeze=True)
    for p in prompts[:E_REQUESTS - E_LATE]:
        prof_eng.submit(p, max_new=MAX_NEW)
    prof_eng.step()
    check(any(s is not None and s.prefilling for s in prof_eng.slots),
          "run e: no slot is mid-prefill after the first step")
    calls, prefix_attention = [], ops.prefix_attention

    def annotated(*args, **kw):
        calls.append(args)
        with torch.profiler.record_function("prefix_attention"):
            return prefix_attention(*args, **kw)

    ops.prefix_attention = annotated
    try:
        p_wall, p_busy, p_top, p_prefix = profile_step(
            prof_eng.step, "prefix_attention")
    finally:
        ops.prefix_attention = prefix_attention
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    replayed = sum(time_ms(lambda a=a: plain.prefix_attention_ref(*a), flush)
                   for a in calls)
    rows = {tuple(a[0].shape[:2]) + (a[1].shape[1],) for a in calls}
    print(f"{tag}: one step with a continuation chunk ({len(calls)} prefix "
          f"attention calls, q B x S and prefix P {sorted(rows)}): wall "
          f"{p_wall:.2f} ms, device busy {p_busy:.2f} ms, idle share "
          f"{1.0 - p_busy / p_wall:.3f}; plain prefix_attention "
          f"{p_prefix:.3f} ms device ({p_prefix / p_busy:.3f} of busy); its "
          f"calls replayed alone (L2 flushed) {replayed:.3f} ms", flush=True)
    for name, ms in p_top[:8]:
        print(f"{tag}:   device {ms:8.3f} ms  {name[:90]}", flush=True)
    return dict(tokens=generated, wall_s=wall, tok_per_s=generated / wall,
                steps=len(steps), launches=launches, stats=st.as_dict(),
                priority_preemptions=by_priority[0],
                max_prefill_tokens_a_step=most,
                continuation_steps=continuation_steps,
                fast_restores_checked=restores["checked"],
                ttft_p50_s=p50, ttft_p99_s=p99, max_step_s=step_max,
                gate=dict(positions=gate.positions, differ=gate.differ,
                          min_slack=gate.min_slack,
                          failures=len(gate.failures)),
                unloaded=dict(ttft_p50_s=c50, ttft_p99_s=c99,
                              max_step_s=calm_max, steps=len(calm_steps),
                              wall_s=calm_wall, requests_identical=same,
                              position_agree=agree),
                continuation_profile=dict(
                    wall_ms=p_wall, busy_ms=p_busy,
                    prefix_attention_ms=p_prefix,
                    prefix_attention_share=p_prefix / p_busy,
                    prefix_attention_replayed_ms=replayed, calls=len(calls),
                    top=p_top[:8]))


def profile_step(fn, annotation: str) -> tuple:
    """``device_busy_ms`` of ``fn`` plus the device ms of the kernels
    launched inside ``record_function(annotation)`` ranges. The range also
    shows on the device's timeline (first kernel to last, idle gaps
    included); it is no kernel and counts in neither sum."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name, marked = {}, 0.0
    for e in prof.events():
        if e.name == annotation:
            if e.device_type == DeviceType.CPU:
                marked += e.device_time_total / 1e3
        elif e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return wall, sum(by_name.values()), top, marked


def chaos_phase(dev, card) -> dict:
    """The eight chaos scenarios (smoke mode) on the harness's own f32
    model through the kernels: no request lost, no block or pin leaked,
    the pager consistent after every step (checked inside the harness),
    and every request whose tokens differ from the card's own fault-free
    run held to the token gate; speculation_storm's tokens must equal the
    fault-free target-only run's."""
    from repro_torch.kernels import _build
    from repro_torch.serve import chaos
    from repro_torch.serve.adapters import make_synthetic_adapters
    from repro_torch.serve.token_gate import token_gate

    _build.reset_launches()
    t0 = time.perf_counter()
    reports = chaos.run(smoke=True, device=dev)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    out = {}
    for rep in reports:
        tag = f"chaos {rep.scenario} [{card}]"
        check(rep.lost == 0 and not rep.errors,
              f"{tag}: lost {rep.lost}, errors {rep.errors}")
        for m in rep.mismatches:
            registry = None
            if m["adapter"] is not None:   # the scenario evicted its own
                registry, _ = make_synthetic_adapters(chaos.CFG, 2,
                                                      device=dev)
            gate = token_gate(chaos.CFG, rep.engine.params, [m["prompt"]],
                              [m["tokens"]], impl="ref", tol_rel=LOGIT_TOL,
                              device=dev, registry=registry,
                              names=[m["adapter"]])
            print(f"{tag}: request {m['rid']} ({m['finish_reason']}, "
                  f"preempted {m['preemptions']}x) tokens {m['tokens']} "
                  f"differ from the fault-free run's {m['reference']}; "
                  f"token gate smallest slack {gate.min_slack:.4e}",
                  flush=True)
            check(gate.ok, f"{tag}: request {m['rid']} fails the token gate "
                           f"at {gate.failures[:5]}")
        print(f"{tag}: {rep.submitted} submitted, {rep.finished} finished, "
              f"rejected {rep.rejected}, expired {rep.expired}, cancelled "
              f"{rep.cancelled}, preempted {rep.preempted} (mid-prefill "
              f"{rep.preempted_prefill}), restored {rep.restored} (fast "
              f"{rep.fast_restores}), faults {rep.faults_injected}, retries "
              f"{rep.step_retries}, lost 0, {rep.mismatched} differing from "
              "the fault-free run (each within the token gate)", flush=True)
        if rep.scenario == "speculation_storm":
            # faults at the draft and verify dispatches, a speculating slot
            # preempted and restored by recompute, and every token the
            # fault-free target-only run's
            check(rep.faults_injected > 0 and rep.preempted > 0
                  and rep.fast_restores == 0 and not rep.mismatches,
                  f"{tag}: faults {rep.faults_injected}, preempted "
                  f"{rep.preempted}, fast restores {rep.fast_restores}, "
                  f"{rep.mismatched} requests off the target-only run")
            st = rep.engine.stats
            print(f"{tag}: {st.spec_rounds} rounds, acceptance rate "
                  f"{st.acceptance_rate:.4f}; every request's tokens those "
                  "of the fault-free target-only run", flush=True)
        out[rep.scenario] = rep.as_dict()
    for name in ("axllm_matmul", "decode_attention", "paged_decode_attention",
                 "flash_attention"):
        check(launches.get(name, 0) > 0, f"chaos: {name} never launched")
    print(f"chaos [{card}]: {len(reports)} scenarios in {wall:.1f} s; "
          f"launches {launches}", flush=True)
    return dict(scenarios=out, wall_s=wall, launches=launches)


# run l: whisper-small at full width and full depth. The reference serves
# no audio model through its engine, so run l drives the model API and
# ``serve/decode.decode_steps`` as ``tests/test_decode_steps.py`` does:
# waves of 8 requests, each a ragged prefill of decoder prompts cycling
# 16/64/200 tokens over its own frames [1500, 80] (f32, the stub frontend's
# input), then greedy decode chunks of 8 steps until every row holds
# MAX_NEW tokens, in a cache of whisper's decoder context (448)
AUDIO_ARCH, AUDIO_MAX_LEN = "whisper-small", 448
AUDIO_PROMPTS = (16, 64, 200)
# its kernel shapes: the f32 projections of a wave's encoder (M = 8 x 1500)
# on the tile kernel, the frontend's K80 among them; the decode step's bf16
# MLP projections on the split-K kernel (K768 N768 is repro-100m's row)
AUDIO_F32 = ((80, 768), (768, 768), (768, 3072), (3072, 768))
AUDIO_DECODE = ((768, 3072), (3072, 768))
# decode attention: cross-attention over the 1500 frames at full length,
# self-attention in the 448-token cache at run l's lengths
AUDIO_SELF_LENGTHS = (16, 64, 200, 79, 127, 263, 300, 447)


def audio_kernel_phase(dev, flush):
    """Kernels 1 to 3 at run l's shapes and the non-causal Sq > Sk case,
    each against its plain version: the f32 tile kernel at M12000 (the
    frontend's K80 and the encoder's projections), ``.gemv`` at the decode
    MLP, flash non-causal f32 over 1500 frames (the encoder, Sq = Sk =
    1500; a prefill's cross-attention, Sq 200) and causal at the decoder's
    200-token prompts, non-causal at Sq 200 > Sk 64 (bf16 on both paths,
    f32), and decode attention over the 1500 cross K/V and the self cache."""
    import torch
    g = torch.Generator(device=dev).manual_seed(14)
    rows = []
    m = N_SLOTS * 1500
    for k, n in AUDIO_F32:
        rows.append(matmul_case("axllm_matmul", m, k, n, g, dev, flush,
                                act="float32"))
    for k, n in AUDIO_DECODE:
        rows.append(matmul_case("axllm_matmul", N_SLOTS, k, n, g, dev,
                                flush))
    rows += flash_case(12, 12, 64, "float32", g, dev, flush, sq=1500,
                       causal=False)
    rows += flash_case(12, 12, 64, "float32", g, dev, flush, sq=200,
                       sk=1500, causal=False)
    rows += flash_case(12, 12, 64, "float32", g, dev, flush, sq=200)
    for dt in ("bfloat16", "float32"):
        rows += flash_case(12, 12, 64, dt, g, dev, flush, sq=200, sk=64,
                           causal=False)
    rows.append(decode_case(False, 12, 12, 64, False, g, dev, flush,
                            lengths=(1500,) * N_SLOTS, s=1500))
    rows.append(decode_case(False, 12, 12, 64, False, g, dev, flush,
                            lengths=AUDIO_SELF_LENGTHS, s=AUDIO_MAX_LEN))
    return rows


def audio_requests(cfg, dev):
    """Run l's 16 requests: decoder prompts cycling 16/64/200 tokens (numpy
    seed 0) and frames [16, enc_seq, d_feat] f32, standard normal from a
    generator seeded 0 on the card."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size,
                            size=AUDIO_PROMPTS[i % len(AUDIO_PROMPTS)])
               .astype(np.int32) for i in range(N_REQUESTS)]
    g = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randn((N_REQUESTS, cfg.enc_seq, cfg.d_feat), generator=g,
                         device=dev)
    return prompts, frames


def audio_prefill(api, params, wave, frames, dev):
    """A wave's ragged prefill: the prompts right-padded to the longest,
    ``lengths`` each row's own. Returns (first-token logits, cache)."""
    import numpy as np
    import torch
    toks = np.zeros((len(wave), max(len(p) for p in wave)), np.int32)
    for i, p in enumerate(wave):
        toks[i, :len(p)] = p
    lengths = torch.tensor([len(p) for p in wave], dtype=torch.int32,
                           device=dev)
    with torch.inference_mode():
        return api.prefill(params, {"frames": frames,
                                    "tokens": torch.from_numpy(toks).to(dev)},
                           api.init_cache(len(wave), AUDIO_MAX_LEN, dev),
                           lengths=lengths)


def audio_decode_chunk(api, params, state, cache):
    """One chunk of ``DECODE_CHUNK`` greedy decode steps; ``state`` is
    (last, stop mask, generated counts)."""
    import torch
    from repro_torch.serve.decode import decode_steps
    last, stop, gen = state
    with torch.inference_mode():
        return decode_steps(api.decode, params, last, cache, None, stop, gen,
                            torch.full_like(gen, MAX_NEW), n=DECODE_CHUNK,
                            vocab_size=api.cfg.vocab_size,
                            max_len=AUDIO_MAX_LEN)


def serve_audio(api, params, prompts, frames, dev) -> tuple:
    """Serve ``prompts`` on their ``frames`` in waves of ``N_SLOTS``: the
    first token is the prefill's argmax, the rest come from decode chunks
    until every row holds ``MAX_NEW`` tokens (the host reads each chunk's
    tokens, as the engine does). Returns (tokens per request, prefill wall
    s, decode steps)."""
    import torch
    out, prefill_s, steps = [], 0.0, 0
    for w0 in range(0, len(prompts), N_SLOTS):
        wave = prompts[w0:w0 + N_SLOTS]
        b = len(wave)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = audio_prefill(api, params, wave,
                                      frames[w0:w0 + b], dev)
        last = torch.argmax(logits[:, :api.cfg.vocab_size], -1).to(
            torch.int32)
        torch.cuda.synchronize()
        prefill_s += time.perf_counter() - t0
        toks = [[t] for t in last.tolist()]
        state = (last, torch.zeros(b, dtype=torch.bool, device=dev),
                 torch.ones(b, dtype=torch.int32, device=dev))
        while not bool(state[1].all()):
            ch = audio_decode_chunk(api, params, state, cache)
            got, valid = ch.tokens.cpu(), ch.valid.cpu()
            for i in range(b):
                toks[i] += got[valid[:, i], i].tolist()
            state, steps = (ch.last, ch.stop_mask, ch.gen), \
                steps + DECODE_CHUNK
        out += toks
    return out, prefill_s, steps


def audio_launches(cfg, waves: int, steps: int) -> dict:
    """The launches run l must make, exactly. A wave: the frontend and six
    projections an encoder layer, ten a decoder layer (self q/k/v/o, cross
    q, k, v, o, MLP up/down) on the tile kernel (f32 activations above
    M16), one non-causal flash an encoder layer and two a decoder layer
    (causal self, non-causal cross), all SIMT (f32). A decode step: eight
    projections a decoder layer on ``.gemv`` (the cross K/V are cached)
    and two decode attentions (self, cross)."""
    tile = waves * (1 + 6 * cfg.n_enc_layers + 10 * cfg.n_layers)
    gemv = steps * 8 * cfg.n_layers
    return {"axllm_matmul": tile + gemv, "axllm_matmul.gemv": gemv,
            "flash_attention": waves * (cfg.n_enc_layers + 2 * cfg.n_layers),
            "decode_attention": steps * 2 * cfg.n_layers}


def end_to_end_audio(dev, card):
    """Run l: whisper-small at full width and full depth (12 + 12 layers,
    bf16, int8 affine per channel, ``impl="auto"``) serving 16 requests
    in two waves (``serve_audio``), with every launch count set to 0 just
    before and read just after and held to ``audio_launches`` exactly;
    every generated token held to the token gate, teacher-forced through
    the plain path on its own frames; the first wave's logits against the
    plain path's; an encoder pass, a prefill wave and 4 decode chunks
    profiled."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.axllm_linear import deploy_quantize
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.kernels import _build
    from repro_torch.models import encdec
    from repro_torch.models.model import get_model
    from repro_torch.serve.token_gate import token_gate
    cfg = get_config(AUDIO_ARCH)
    tag = f"e2e audio [{card}]"
    print(f"{tag}: {cfg.name} at full width and full depth ({cfg.n_enc_layers}"
          f" encoder + {cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
          f"H{cfg.n_heads}/Hk{cfg.n_kv_heads}, head dim "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, {cfg.norm}, {cfg.act}, "
          f"vocab {cfg.vocab_size} padded {cfg.padded_vocab}, frames "
          f"[{cfg.enc_seq}, {cfg.d_feat}], {cfg.dtype}; the encoder and "
          f"prefill streams float32 as in the reference), max_len "
          f"{AUDIO_MAX_LEN}; {cfg.n_params() / 1e9:.3f} G parameters",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    raw = get_model(cfg).init(seed=0, device=dev)
    init_peak = torch.cuda.max_memory_allocated()
    params = deploy_quantize(raw, QuantConfig(bits=8))
    deploy_peak = torch.cuda.max_memory_allocated()
    del raw
    api, plain_api = get_model(cfg), get_model(cfg, impl="ref")
    prompts, frames = audio_requests(cfg, dev)
    serve_audio(api, params, prompts[:2], frames[:2], dev)     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    tokens, prefill_s, steps = serve_audio(api, params, prompts, frames, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for i, t in enumerate(tokens):
        check(len(t) == MAX_NEW and all(0 <= x < cfg.vocab_size for x in t),
              f"audio: request {i} has {len(t)} tokens or one outside the "
              "vocab")
    want = audio_launches(cfg, -(-len(prompts) // N_SLOTS), steps)
    print(f"{tag}: launches {launches}; expected {want}", flush=True)
    check(launches == want, f"audio: launches {launches} are not the "
          f"expected {want}")
    generated = sum(len(t) for t in tokens)
    print(f"{tag}: {generated} tokens in {wall:.3f} s = "
          f"{generated / wall:.1f} tok/s; {steps} decode steps; prefill "
          f"{prefill_s:.3f} s (2 waves); peak memory {peak / 2**30:.3f} GiB "
          f"(init {init_peak / 2**30:.3f}, with a quantized copy "
          f"{deploy_peak / 2**30:.3f})", flush=True)

    gate = token_gate(cfg, params, prompts, tokens, impl="ref",
                      tol_rel=LOGIT_TOL, device=dev, frames=frames)
    print(f"{tag}: token gate: {gate.positions} generated positions checked "
          f"against the plain path's teacher-forced logits on each "
          f"request's frames; {gate.differ} where the token is not the "
          f"plain path's argmax; smallest slack {gate.min_slack:.4e} "
          f"(request {gate.worst[0]}, position {gate.worst[1]}); "
          f"{len(gate.failures)} positions more than 2 x tol below the "
          f"plain maximum", flush=True)
    check(gate.ok, f"audio: token gate failed at (request, position, "
                   f"slack) {gate.failures[:5]}")

    wave, wframes = prompts[:N_SLOTS], frames[:N_SLOTS]
    served = audio_prefill(api, params, wave, wframes, dev)[0].float()
    plain = audio_prefill(plain_api, params, wave, wframes, dev)[0].float()
    check(bool(torch.isfinite(served).all()), "audio: non-finite logits")
    scale = float(plain.abs().max())
    err = float((served - plain).abs().max())
    agree = float((served[:, :cfg.vocab_size].argmax(-1)
                   == plain[:, :cfg.vocab_size].argmax(-1)).float().mean())
    print(f"{tag}: first-wave logits (float32) |kernel - plain| = "
          f"{err:.4e}, scale {scale:.4f}, tolerance "
          f"{F32_LOGIT_TOL * max(1.0, scale):.4e}; argmax agreement "
          f"{agree:.3f}", flush=True)
    check(err <= F32_LOGIT_TOL * max(1.0, scale),
          f"audio: first-wave logits differ by {err}")

    e_wall, e_busy, e_top = device_busy_ms(
        lambda: encdec.encode(params, wframes, cfg))
    p_wall, p_busy, p_top = device_busy_ms(
        lambda: audio_prefill(api, params, wave, wframes, dev))
    _, cache = audio_prefill(api, params, wave, wframes, dev)
    state = (torch.zeros(N_SLOTS, dtype=torch.int32, device=dev),
             torch.zeros(N_SLOTS, dtype=torch.bool, device=dev),
             torch.ones(N_SLOTS, dtype=torch.int32, device=dev))
    ch = audio_decode_chunk(api, params, state, cache)    # the first chunk
    state = (ch.last, ch.stop_mask, ch.gen)

    def four_chunks():
        st = state
        for _ in range(4):
            c = audio_decode_chunk(api, params, st, cache)
            st = (c.last, c.stop_mask, c.gen)
            c.tokens.cpu()          # the host reads each chunk, as served

    d_wall, d_busy, d_top = device_busy_ms(four_chunks)
    profiles = {}
    for what, (w, b, top) in (("encoder pass", (e_wall, e_busy, e_top)),
                              ("prefill wave", (p_wall, p_busy, p_top)),
                              ("4 decode chunks (32 steps)",
                               (d_wall, d_busy, d_top))):
        split = split_by_kind(top)
        profiles[what] = dict(wall_ms=w, busy_ms=b, idle_share=1.0 - b / w,
                              by_kind=split, top=top[:8])
        print(f"{tag}: {what} ({len(wave)} rows): wall {w:.2f} ms, device "
              f"busy {b:.2f} ms, idle share {1.0 - b / w:.3f}; by kind: "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items()),
              flush=True)
        for name, ms in top[:4]:
            print(f"{tag}:   device {ms:8.3f} ms  {name[:90]}", flush=True)

    del params, cache
    torch.cuda.empty_cache()
    return dict(config=cfg.name, tokens=generated, wall_s=wall,
                tok_per_s=generated / wall, prefill_wall_s=prefill_s,
                steps=steps, launches=launches, expected_launches=want,
                peak_bytes=peak, init_peak_bytes=init_peak,
                deploy_peak_bytes=deploy_peak, logit_err=err,
                logit_scale=scale, first_wave_argmax_agree=agree,
                gate=dict(positions=gate.positions, differ=gate.differ,
                          min_slack=gate.min_slack,
                          failures=len(gate.failures)),
                profiles=profiles)


# the launcher phase: ``python -m repro_torch.launch.serve`` on a
# checkpoint of full-width repro-100m, with and without the reuse kernel
# and paging (kernels 1 to 5 under the normal entry point)
LAUNCH_ARGS = ("--arch", "repro-100m", "--slots", str(N_SLOTS), "--max-len",
               str(MAX_LEN), "--requests", str(N_REQUESTS), "--max-new",
               str(MAX_NEW), "--prompt-lens",
               ",".join(map(str, PROMPT_LENS)), "--stats")
# the mesh run serves half the requests, a quarter of the tokens each: its
# ranks share the card over gloo, about 60 tok/s (chip time)
LAUNCH_RUNS = {"default": (), "reuse+paged": ("--reuse", "--paged"),
               "mesh 2": ("--mesh-shape", "2", "--requests", "8",
                          "--max-new", "16"),
               "mesh 2x2": ("--mesh-shape", "2x2", "--requests", "8",
                            "--max-new", "16")}
LAUNCH_KERNELS = {
    "default": ("axllm_matmul", "axllm_matmul.wgmma", "axllm_matmul.gemv",
                "decode_attention", "flash_attention",
                "flash_attention.wgmma"),
    "reuse+paged": ("reuse_matmul", "reuse_matmul.wgmma", "reuse_matmul.gemv",
                    "paged_decode_attention", "flash_attention",
                    "flash_attention.wgmma"),
}
LAUNCH_KERNELS["mesh 2"] = LAUNCH_KERNELS["default"]   # rank 0's launches
LAUNCH_KERNELS["mesh 2x2"] = LAUNCH_KERNELS["default"]
# the mesh run whose spawn (the same mesh) runs a mesh mode's in-process
# reference, the launcher's rank body
LAUNCH_MESH_RUN = {"mesh 2": "n", "mesh 2x2": "q"}
LAUNCH_STEP = 7     # the step the checkpoint is saved at


def launcher_phase(dev, card, lane):
    """The launcher from a checkpoint: the port's full-width repro-100m
    init from seed 1 and ``adamw.init`` saved by ``train/checkpoint.save``
    under ``build/`` (seed 1, where the launcher's own init is seed 0, so a
    restore that did nothing would show), then ``python -m
    repro_torch.launch.serve --ckpt <dir> ...`` for each of
    ``LAUNCH_RUNS``, queued on ``lane`` (subprocesses on the card, beside
    the main thread), and ``repro_torch.launch.serve.main`` run in process
    on the card with the same flags; a mesh mode's in-process run is the
    launcher's rank body in the spawn of the mesh run of its shape
    (``LAUNCH_MESH_RUN``; ``serve.main`` spawns ranks that run just that
    body). Returns what ``launcher_check`` holds the subprocesses to. The
    launch counts are the in-process run's: the entry point itself,
    counted from 0 just before it."""
    import contextlib
    import io
    import shutil
    import torch
    from repro_torch.configs.repro_100m import CONFIG
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models.model import get_model
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint
    ckpt = ROOT / "build" / "launcher_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    params = get_model(CONFIG).init(seed=1, device=dev)
    t0 = time.perf_counter()
    checkpoint.save(str(ckpt), LAUNCH_STEP,
                    (params, adamw.init(params, adamw.AdamWConfig())))
    save_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in ckpt.rglob("*.npy"))
    for label, extra in LAUNCH_RUNS.items():
        lane.submit(("launcher", label),
                    [sys.executable, "-m", "repro_torch.launch.serve",
                     *launch_flags(ckpt, extra)])
    like = get_model(CONFIG).init(seed=0, device=dev)
    (got, _), step = checkpoint.restore(
        str(ckpt), (like, adamw.init(like, adamw.AdamWConfig())))
    del like
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        checkpoint._flatten(got), checkpoint._flatten(params)))
    print(f"launcher [{card}]: checkpoint of repro-100m (seed 1) and its "
          f"AdamW state, {size / 2**20:.1f} MiB, saved in {save_s:.2f} s; "
          f"restored in process at step {step}, every leaf bit-equal "
          f"{same}", flush=True)
    check(same and step == LAUNCH_STEP, "launcher: the in-process restore "
          "differs from the saved tree")
    del got, params

    out = {}
    for label, extra in LAUNCH_RUNS.items():
        if label in LAUNCH_MESH_RUN:
            continue
        buf = io.StringIO()
        _build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            serve.main(launch_flags(ckpt, extra), device=dev)
        torch.cuda.synchronize()
        out[label] = launcher_in_process(
            card, label, ckpt, buf.getvalue(), dict(_build.LAUNCHES),
            time.perf_counter() - t0, "`serve.main`")
    return dict(out, ckpt=ckpt, checkpoint_mib=size / 2**20, save_s=save_s)


def launcher_in_process(card, label, ckpt, stdout, launches, wall,
                        where) -> dict:
    """Hold the in-process run of launcher mode ``label`` (its printed
    ``stdout`` and ``launches``) to the restore line and the mode's
    kernels; returns what ``launcher_check`` compares."""
    lines, stats = split_stats(stdout)
    print(f"launcher [{card}] {label}: in process, {where} in {wall:.1f} s: "
          f"restore line {lines[0] if lines else None!r}; prefix-hit tokens "
          f"{stats['prefix_hit_tokens']}, admitted {stats['admitted']}, "
          f"finished {stats['finished']}; launches {launches}", flush=True)
    check(f"restored step {LAUNCH_STEP} from {ckpt}" in lines,
          f"launcher {label}: no restore line in process")
    for name in LAUNCH_KERNELS[label]:
        check(launches.get(name, 0) > 0, f"launcher {label}: {name} "
              "never launched")
    return dict(in_process_s=wall, stats=stats, launches=launches,
                lines=lines)


def launcher_mesh_in_process(card, label, inproc, ranks) -> None:
    """Mesh mode ``label``'s in-process run from its mesh run's ranks
    (each rank's result of the launcher's rank body): every rank the
    same tokens, rank 0's lines and launches (as ``serve.main``)."""
    check(all(r["tokens"] == ranks[0]["tokens"] for r in ranks),
          f"launcher {label}: the ranks' tokens differ in process")
    inproc[label] = launcher_in_process(
        card, label, inproc["ckpt"], ranks[0]["out"], ranks[0]["launches"],
        ranks[0]["wall_s"], f"the launcher's rank body in run "
        f"{LAUNCH_MESH_RUN[label]}'s spawn")


def launch_flags(ckpt, extra) -> list:
    """The launcher's flags for ``LAUNCH_RUNS`` entry ``extra``."""
    return ["--ckpt", str(ckpt), *LAUNCH_ARGS, *extra]


def split_stats(stdout) -> tuple:
    """(the launcher's lines before its stats JSON, the stats without the
    timing field)"""
    start = stdout.find("\n{")     # the stats JSON ends the output
    stats = json.loads(stdout[start:])
    stats.pop("prefill_wall_s")
    return stdout[:start].splitlines(), stats


def launcher_check(card, lane, inproc) -> dict:
    """The launcher phase's subprocesses (``launcher_phase``), each waited
    for on ``lane``: each must exit 0, print ``restored step 7``, and print
    the token lines and stats JSON (all stats but the timing field) of its
    in-process run; a mesh run's summary line carries its mesh tag. Removes
    the checkpoint."""
    import shutil
    import torch
    ckpt = inproc["ckpt"]
    out = {}
    for label, extra in LAUNCH_RUNS.items():
        rc, stdout, stderr, wall = lane.result(("launcher", label))
        flags = launch_flags(ckpt, extra)
        print(f"launcher [{card}] {label}: `python -m "
              f"repro_torch.launch.serve {' '.join(flags)}` exited "
              f"{rc} in {wall:.1f} s (beside the main thread's runs)",
              flush=True)
        check(rc == 0, f"launcher {label}: exit {rc}: {stderr[-2000:]}")
        lines, stats = split_stats(stdout)
        for ln in lines:
            print(f"launcher [{card}] {label}: | {ln}", flush=True)
        check(f"restored step {LAUNCH_STEP} from {ckpt}" in lines,
              f"launcher {label}: no restore line")
        if "--mesh-shape" in extra:
            summary = [ln for ln in lines if ln.startswith("[axllm")]
            shape = extra[extra.index("--mesh-shape") + 1]
            check(summary and summary[0].endswith(f", mesh {shape}"),
                  f"launcher {label}: no mesh tag in {summary}")
        token_lines = [ln for ln in lines if ln.startswith("  -> ")]
        got = inproc[label]
        want_lines = [ln for ln in got["lines"] if ln.startswith("  -> ")]
        print(f"launcher [{card}] {label}: token lines equal the in-process "
              f"run's {token_lines == want_lines}, stats equal "
              f"{stats == got['stats']}", flush=True)
        check(len(token_lines) == 3 and token_lines == want_lines,
              f"launcher {label}: token lines {token_lines} != the "
              f"in-process run's {want_lines}")
        check(stats == got["stats"], f"launcher {label}: stats {stats} != "
              f"the in-process run's {got['stats']}")
        out[label] = dict(wall_s=wall, in_process_s=got["in_process_s"],
                          stats=stats, launches=got["launches"],
                          token_lines=token_lines)
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(out, checkpoint_mib=inproc["checkpoint_mib"],
                save_s=inproc["save_s"])


# -- serving on a mesh: runs n, o, p and q -----------------------------------

# run -> (config (None: each mode's own, ``MESH_FAMILIES``), depth (None:
# full), mesh (data, model), why the depth)
MESH_RUNS = {
    "n": ("repro-100m", E2E_LAYERS, (1, 2), "chip time, as runs a to g, "
          "whose tokens it is compared with"),
    "o": ("glm4-9b", 4, (1, 4), "chip time and memory: the four ranks share "
          "one card, and each makes the whole raw bf16 tree before its "
          "engine keeps and quantizes its blocks"),
    "p": (None, None, (1, 2), ""),
    "q": ("repro-100m", None, (2, 2), ""),
}
# run p's modes, one family each: (config, layers kept, dtype (None: the
# config's), why the depth)
MESH_FAMILIES = {
    "h moe int8": ("qwen2-moe-a2.7b", 6, None, "chip time; at 24 layers "
                   "the raw bf16 tree alone is 30.3 GB, and each of the two "
                   "ranks makes it whole"),
    "k hybrid reuse": ("zamba2-1.2b", 14, None, "chip time; 14 layers keep "
                       "2 of its 6 shared-attention sites and its remainder "
                       "of 2 Mamba2 layers"),
    "j ssm float32": ("xlstm-1.3b", 8, "float32", "as run j (one "
                      "super-block: 7 mLSTM and the sLSTM); float32 as run "
                      "j, whose bf16 plain path does not reproduce itself"),
}
# tokens a request of runs n to q: enough for rank agreement, the gate and
# every kernel's launches (gloo on one card serves some 70 tokens a second)
MESH_MAX_NEW = 16
# run -> mode -> (the run whose prompts and requests it serves, engine
# keywords, the kernels every rank must launch)
MESH_MODES = {
    "n": {
        "a int8": ("a", {}, ("axllm_matmul.gemv", "axllm_matmul.wgmma",
                             "decode_attention", "flash_attention",
                             "flash_attention.wgmma")),
        "b reuse+paged": ("b", dict(impl="reuse", paged=True,
                                    kv_block_size=KV_BLOCK),
                          ("reuse_matmul.gemv", "reuse_matmul.wgmma",
                           "paged_decode_attention", "flash_attention")),
        "c lora+reuse+fused": ("c", dict(impl="reuse", fuse_qkv=True),
                               ("reuse_matmul.gemv", "reuse_matmul.wgmma",
                                "decode_attention", "flash_attention")),
    },
    "o": {
        "a int8": ("a", {}, ("axllm_matmul.gemv", "axllm_matmul.wgmma",
                             "flash_attention", "flash_attention.wgmma")),
    },
    "p": {
        "h moe int8": ("a", {}, FAMILY_KERNELS),
        "k hybrid reuse": ("a", dict(impl="reuse"),
                           RECURRENT_RUNS["hybrid"][0]),
        "j ssm float32": ("a", {}, RECURRENT_RUNS["ssm"][0]),
    },
}
MESH_MODES["q"] = {k: MESH_MODES["n"][k] for k in ("a int8",
                                                   "b reuse+paged")}
# the rank shapes of runs n to q that no earlier row has: (kernel, the Ms,
# K, N, the activations' dtype). Run n: repro-100m at model 2 (wq, wk/wv,
# wo, gate/up, down, run c's fused wqkv); run o: glm4-9b at model 4 (wq,
# wk/wv whole, wo, gate/up, down; the untied head's quarter); run p at
# model 2: qwen2-moe-a2.7b's wq/wk/wv, wo, shared gate/up and down and its
# head's half, zamba2-1.2b's shared wq/wk/wv, wo, up and down and head's
# half on reuse_matmul and its Mamba2 out_proj's columns on axllm_matmul,
# xlstm-1.3b's mLSTM up columns and down rows and head's half (f32
# activations); run q: run n's blocks at a data rank's 4 decode rows
_N_BLOCKS = ((768, 384), (768, 128), (384, 768), (768, 1024), (1024, 768))
_BOTH = ("axllm_matmul", "reuse_matmul")
_WAVE = (N_SLOTS, 4096)
MESH_MATMULS = {
    "n": [(kern, _WAVE, k, n, "bfloat16") for kern in _BOTH
          for k, n in _N_BLOCKS + ((768, 640),)],
    "o": [("axllm_matmul", _WAVE, k, n, "bfloat16") for k, n in (
        (4096, 1024), (4096, 256), (1024, 4096), (4096, 3424), (3424, 4096))]
    + [("axllm_matmul", (N_SLOTS,), 4096, 151552 // 4, "bfloat16")],
    "p": [("axllm_matmul", _WAVE, k, n, "bfloat16") for k, n in (
        (2048, 1024), (1024, 2048), (2048, 2816), (2816, 2048))]
    + [("axllm_matmul", (N_SLOTS,), 2048, 152064 // 2, "bfloat16")]
    + [("reuse_matmul", _WAVE, k, n, "bfloat16") for k, n in (
        (2048, 1024), (1024, 2048), (2048, 4096), (4096, 2048))]
    + [("reuse_matmul", (N_SLOTS,), 2048, 32000 // 2, "bfloat16"),
       ("axllm_matmul", _WAVE, 4096, 1024, "bfloat16")]
    + [("axllm_matmul", (N_SLOTS,), k, n, "float32") for k, n in (
        (2048, 4096), (2048, 2048), (2048, 50432 // 2))],
    "q": [(kern, (N_SLOTS // 2,), k, n, "bfloat16") for kern in _BOTH
          for k, n in _N_BLOCKS],
}
# a rank's attention: run -> ((q heads, KV heads, head dim, rows), ...)
MESH_ATTN = {"n": ((6, 2, 64, N_SLOTS),), "o": ((8, 1, 128, N_SLOTS),),
             "p": ((8, 8, 128, N_SLOTS), (16, 16, 64, N_SLOTS)),
             "q": ((6, 2, 64, N_SLOTS // 2),)}
# run q's module phase: the sequence-sharded decode with batch axes
# ("data",) at glm4-9b's layer (B, S, H, Hk, d)
SEQ_SHARD = (8, 1024, 32, 2, 128)


def run_c_registry(cfg, dev):
    """Run c's four rank-16 adapters (``LoRAConfig()``, A and B from numpy
    seed 3) for ``cfg``, carried in by ``bridge.registry_from_numpy``."""
    import numpy as np
    from repro_torch.bridge import registry_from_numpy
    from repro_torch.core.axllm_linear import LoRAConfig
    from repro_torch.serve.adapters import target_dims
    lcfg = LoRAConfig()
    rng = np.random.default_rng(3)
    nl, r, n_ad = cfg.n_layers, lcfg.rank, len(ADAPTERS)
    stacked = {}
    for t in lcfg.targets:
        n_in, n_out = target_dims(cfg, t)
        stacked[t] = {
            "lora_a": (rng.standard_normal((nl, n_ad, n_in, r))
                       / np.sqrt(r)).astype(np.float32),
            "lora_b": (rng.standard_normal((nl, n_ad, r, n_out))
                       * LORA_B_STD).astype(np.float32)}
    return registry_from_numpy(cfg, stacked, list(ADAPTERS), lcfg,
                               device=dev)


def mesh_requests(run):
    """(prompts, adapter names) of run a, b or c."""
    if run == "b":
        return run_b_prompts(), [None] * N_REQUESTS
    cycle = (None,) + ADAPTERS
    names = [cycle[i % len(cycle)] if run == "c" else None
             for i in range(N_REQUESTS)]
    return run_a_prompts(), names


def mesh_config(run, label):
    """The config of mode ``label`` of mesh run ``run``."""
    import dataclasses
    from repro_torch.configs import get_config
    arch, layers, _, _ = MESH_RUNS[run]
    dtype = None
    if arch is None:
        arch, layers, dtype, _ = MESH_FAMILIES[label]
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def describe(cfg, why) -> str:
    """A config's widths and its depth, with the reason of a cut."""
    from repro_torch.configs import get_config
    full = get_config(cfg.name).n_layers
    depth = "full depth" if cfg.n_layers == full else \
        f"depth cut to {cfg.n_layers} of {full} layers: {why}"
    return (f"{cfg.name} at full width (d_model {cfg.d_model}, "
            f"H{cfg.n_heads}/Hk{cfg.n_kv_heads}, head dim "
            f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab padded "
            f"{cfg.padded_vocab}"
            + (f", {cfg.n_experts} experts padded to {cfg.padded_experts}, "
               f"top-{cfg.top_k}, {cfg.n_shared_experts} shared"
               if cfg.n_experts else "")
            + f", {cfg.dtype}, int8 per channel), {depth}; "
            f"{cfg.n_params() / 1e9:.3f} G parameters at this depth")


def collective_probe(mesh, n: int = 50) -> dict:
    """Host ms a call, on this rank, of what a decode step on a shared card
    repeats: an all-reduce of a decode step's activation ([8, 768] f32) on
    the card (gloo stages it through the host) and on the host, and one
    small op followed by a device sync (the ranks time-share the card)."""
    import torch
    import torch.distributed as dist
    dev = mesh.device
    x = torch.randn(N_SLOTS, 768, device=dev)
    h = torch.randn(N_SLOTS, 768)
    calls = {"all_reduce_card": lambda: dist.all_reduce(x, group=mesh.group),
             "all_reduce_host": lambda: dist.all_reduce(h, group=mesh.group),
             "op_and_sync": lambda: (x.mul_(1.0), torch.cuda.synchronize(dev))}
    out = {}
    for name, call in calls.items():
        for _ in range(5):
            call()
        torch.cuda.synchronize(dev)
        dist.barrier(group=mesh.host_group)
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize(dev)
        out[name] = (time.perf_counter() - t0) / n * 1e3
    return out


def held_gib(*trees) -> float:
    """GiB of the tensors ``trees`` hold (QTensors' children, nested dicts
    and tuples), each storage once: an engine's weights and cache, whether
    it copied them or shares them with its caller."""
    import dataclasses
    import torch
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
    for t in trees:
        walk(t)
    return total / 2**30


def mesh_rank(mesh, run, launcher_argv=None):
    """One rank of run n, o, p or q (spawned by ``launch.mesh.run_ranks``):
    each mode's config's weights from seed 0 on this rank's card (made
    again when the config changes, the last freed first), then the mode's
    engine on the mesh serving its run's requests, every launch count set
    to 0 just before and read just after. Rank 0 of a moe mode records
    the served expert choices and wave lengths for the token gate. Then,
    given ``launcher_argv``, the serving launcher's rank body
    (``launch.serve._rank``, what ``serve.main`` runs on each rank it
    spawns) with those flags on this mesh, timed. Run q ends with the
    sequence-sharded decode's module phase."""
    import contextlib
    import gc
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import ServeEngine
    dev = mesh.device
    out = {"probe": collective_probe(mesh)}
    params = made = None
    for label, (req_run, kw, _) in MESH_MODES[run].items():
        cfg = mesh_config(run, label)
        if cfg != made:
            params = None
            torch.cuda.empty_cache()
            params, made = get_model(cfg).init(seed=0, device=dev), cfg
        prompts, names = mesh_requests(req_run)
        registry = run_c_registry(cfg, dev) if req_run == "c" else None
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        eng = ServeEngine(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                          quantize=True, decode_chunk=DECODE_CHUNK,
                          adapters=registry, mesh=mesh, device=dev, **kw)
        engine_gib = held_gib(eng.params, eng.cache)
        routes = wave_lens = None
        if cfg.family == "moe" and mesh.rank == 0:
            routes, wave_lens = record_routes(eng)
        _build.reset_launches()
        t0 = time.perf_counter()
        for p, name in zip(prompts, names):
            eng.submit(p, max_new=MESH_MAX_NEW, adapter=name)
        with contextlib.nullcontext() if routes is None else routes.record():
            eng.run()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        tokens = served_tokens(eng)
        lay = eng._layout
        out[label] = dict(
            tokens=tokens, launches=dict(_build.LAUNCHES), wall_s=wall,
            tok_s=sum(map(len, tokens)) / wall,
            stats={k: v for k, v in eng.stats.as_dict().items()
                   if k != "prefill_wall_s"},
            layout=None if lay is None else {
                k: getattr(lay, k) for k in ("heads", "kv_heads", "seq",
                                             "mlp", "vocab", "experts",
                                             "ssm_in", "ssm_out")},
            rows=None if eng._rows is None else (eng._rows.lo, eng._rows.n),
            routes=routes, wave_lens=wave_lens,
            engine_gib=engine_gib,
            raw_gib=before / 2**30,
            peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
        # a recording engine's wrapped methods hold it in a cycle
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    if launcher_argv is not None:
        from repro_torch.launch.serve import _rank as launcher_rank
        t0 = time.perf_counter()
        out["launcher"] = launcher_rank(mesh, launcher_argv)
        torch.cuda.synchronize(dev)
        out["launcher"]["wall_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    if run == "q":
        out["seqsharded"] = seqsharded_rank_phase(mesh)
    return out


# run q's cuts of the sequence-sharded decode: (batch axes, sequence axes)
# by the label of its lines; "model, data" is the long-context cells'
# "cache_seq_long" rule (the batch whole, the sequence over all 4 ranks)
SEQ_CUTS = {"model": (("data",), ("model",)),
            "model, data": ((), ("model", "data"))}


def seqsharded_rank_phase(mesh) -> dict:
    """One rank of run q's module phase: ``decode_attention_seqsharded``
    at ``SEQ_SHARD`` (glm4-9b's layer), bf16 and int8 KV, every rank
    drawing the whole state from one seed and taking its block, in each
    cut of ``SEQ_CUTS``: the batch over "data" and the sequence over
    "model" (batch axes ``("data",)``), and the batch whole with the
    sequence over ("model", "data") (block model * D + data). Held against
    the single-card ``decode_attention`` kernel on the same rows over the
    whole sequence, updated the same way (within 2^-7 of its output scale,
    as the decode rows). Timed with CUDA events: the whole call (its two
    all-reduces through the host over gloo, the card shared by four
    ranks), the rank's local part alone (the owner's write and the
    partial flash-decode, PyTorch ops) and the kernel on the rows."""
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.kernels import sharded_decode as SD
    dev = mesh.device
    b, s, h, hk, d = SEQ_SHARD
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for (cut, (batch_axes, seq_axes)), kv in itertools.product(
            SEQ_CUTS.items(), ("bf16", "int8")):
        rows = shd.block_index((b,), (batch_axes or None,), mesh,
                               mesh.rank)[0]
        seq = shd.block_index((s,), (seq_axes,), mesh, mesh.rank)[0]
        nb, ns = rows.stop - rows.start, seq.stop - seq.start
        g = torch.Generator(device=dev).manual_seed(17)
        q = torch.randn(b, h, d, generator=g, device=dev).to(torch.bfloat16)
        length = torch.randint(1, s + 1, (b,), generator=g, device=dev,
                               dtype=torch.int32)
        length[0] = s
        st = {}
        for name, shape in (("k", (b, s, hk, d)), ("v", (b, s, hk, d)),
                            ("nk", (b, hk, d)), ("nv", (b, hk, d))):
            st[name] = torch.randint(-127, 128, shape, generator=g,
                                     device=dev, dtype=torch.int8) \
                if kv == "int8" else torch.randn(
                    shape, generator=g, device=dev).to(torch.bfloat16)
        if kv == "int8":
            for name, shape in (("ks", (b, s, hk, 1)), ("vs", (b, s, hk, 1)),
                                ("nks", (b, hk, 1)), ("nvs", (b, hk, 1))):
                st[name] = torch.rand(shape, generator=g, device=dev) * 0.02
        pos = length - 1
        r = {k: v[rows] for k, v in st.items()}
        blk = {k: r[k][:, seq].clone() for k in ("k", "v", "ks", "vs")
               if k in r}
        scales = {} if kv != "int8" else dict(
            k_scale=blk["ks"], v_scale=blk["vs"], new_k_scale=r["nks"],
            new_v_scale=r["nvs"])
        lo = seq.start

        def call():
            return SD.decode_attention_seqsharded(
                q[rows], blk["k"], blk["v"], r["nk"], r["nv"], pos[rows],
                length[rows], mesh, seq_axes, batch_axes, **scales)

        def local():
            SD._local_update(blk["k"], r["nk"], pos[rows], lo)
            SD._local_update(blk["v"], r["nv"], pos[rows], lo)
            return SD._partial_attend(q[rows], blk["k"], blk["v"],
                                      blk.get("ks"), blk.get("vs"), lo,
                                      length[rows], 1.0 / d ** 0.5)

        got = call()[0]
        whole = {k: r[k].clone() for k in ("k", "v", "ks", "vs") if k in r}
        ar = torch.arange(nb, device=dev)
        for k, new in (("k", "nk"), ("v", "nv"), ("ks", "nks"),
                       ("vs", "nvs")):
            if k in whole:
                whole[k][ar, pos[rows].long()] = r[new]
        kern = lambda: ops.decode_attention(  # noqa: E731
            q[rows], whole["k"], whole["v"], length[rows],
            k_scale=whole.get("ks"), v_scale=whole.get("vs"))
        want = kern()
        torch.cuda.synchronize(dev)
        err = float((got.float() - want.float()).abs().max())
        tol = 2.0 ** -7 * max(1.0, float(want.float().abs().max()))
        per_key = hk * (2 * d + 8) if kv == "int8" else hk * 2 * d * 2
        valid = int(torch.clamp(length[rows] - lo, 0, ns).sum())
        out[kv if cut == "model" else f"{kv}, sequence over ({cut})"] = dict(
            shape=f"B{b} S{s} H{h} Hk{hk} d{d} {kv}-kv, a rank's "
                  f"B{nb} S{ns}", batch_axes=batch_axes, seq_axes=seq_axes,
            max_abs_err=err, tolerance=tol,
            ms=time_ms(call, flush), local_ms=time_ms(local, flush),
            kernel_rows_ms=time_ms(kern, flush),
            local_bound_ms=bound(valid * per_key + 2 * q[rows].numel()
                                 * q.element_size(),
                                 4.0 * valid * h * d, "bfloat16")[0])
    return out


def start_mesh(run, launcher_argv=None):
    """Spawn run ``run``'s ranks (``mesh_rank``) from a background thread.
    Returns a function that waits for them and gives (each rank's result,
    the spawn's wall s), or raises what the spawn raised."""
    import threading
    from repro_torch.launch.mesh import run_ranks
    shape = MESH_RUNS[run][2]
    box = {}

    def spawn():
        t0 = time.perf_counter()
        try:
            # one intra-op thread a rank: the ranks do no host math but the
            # schedule, and their collectives' host halves share the cores
            box["ranks"] = run_ranks(mesh_rank, shape[0] * shape[1], "cuda",
                                     run, launcher_argv, mesh_shape=shape,
                                     threads=1)
        except BaseException as e:      # raised again in the caller
            box["error"] = e
        box["wall"] = time.perf_counter() - t0

    thread = threading.Thread(target=spawn, daemon=True)
    thread.start()

    def wait():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["ranks"], box["wall"]
    return wait


def end_to_end_mesh(dev, card, run, ref_tokens, spawned=None):
    """Run n, o, p or q: ``MESH_RUNS[run]``'s mesh of ranks that share the
    card (gloo: the kernels on the card, each collective through the
    host), serving each mode's config at full width and its requests.
    Every rank must serve rank 0's tokens and stats and launch the mode's
    kernels at its shapes; every token must pass the token gate on the
    unsharded model (built here, quantized whole; a moe mode's on the
    served schedule with rank 0's expert choices); the share of tokens
    equal to the single-card run of the same requests in this call
    (``ref_tokens``: {request run: tokens}) is printed. Run q's data rows
    and, with ``ref_tokens["b hits"]``, run b's prefix hits are held.
    The host figures measure gloo on one card: correctness, not a
    parallel rate. ``spawned``: the wait of a ``start_mesh(run)`` already
    started (else the ranks are spawned here). Each rank's result of the
    launcher's rank body, where it ran, is returned under "launcher"."""
    import gc
    import torch
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.token_gate import token_gate
    arch, _, shape, why = MESH_RUNS[run]
    world, mesh_s = shape[0] * shape[1], f"{shape[0]}x{shape[1]}"
    for label in MESH_MODES[run] if arch is None else list(MESH_MODES[run])[:1]:
        cfg = mesh_config(run, label)
        why_l = MESH_FAMILIES[label][3] if arch is None else why
        print(f"e2e mesh {run} [{card}]: "
              + (f"{label}: " if arch is None else "") + describe(cfg, why_l)
              + f"; mesh {mesh_s}, {world} ranks on one card", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    ranks, spawn_wall = (spawned or start_mesh(run))()
    probe = [r["probe"] for r in ranks]
    print(f"e2e mesh {run} [{card}]: host ms a call on rank 0 (rank "
          f"{world - 1}): all-reduce of [8, 768] f32 on the card "
          f"{probe[0]['all_reduce_card']:.3f} ({probe[-1]['all_reduce_card']:.3f}),"
          f" on the host {probe[0]['all_reduce_host']:.3f} "
          f"({probe[-1]['all_reduce_host']:.3f}); an op and a device sync "
          f"{probe[0]['op_and_sync']:.3f} ({probe[-1]['op_and_sync']:.3f})",
          flush=True)
    out = {"probe_by_rank": probe}
    params = made = None
    for label, (req_run, kw, kernels) in MESH_MODES[run].items():
        cfg = mesh_config(run, label)
        if cfg != made:
            params = None
            torch.cuda.empty_cache()
            params, made = get_model(cfg).init(seed=0, device=dev), cfg
        tag = f"e2e mesh {run} {label} [{card}]"
        res = [r[label] for r in ranks]
        tokens = res[0]["tokens"]
        agree = all(r["tokens"] == tokens for r in res)
        print(f"{tag}: layout {res[0]['layout']}; slot rows (first, count) "
              f"by rank {[r['rows'] for r in res]}; "
              f"{sum(map(len, tokens))} "
              f"tokens, every rank's equal to rank 0's {agree}; "
              f"{res[0]['tok_s']:.1f} tok/s on rank 0 ({res[0]['wall_s']:.2f}"
              f" s; gloo on one card: not a parallel rate); GiB by "
              f"rank: its engine's weights and cache "
              f"{[round(r['engine_gib'], 3) for r in res]}, held before it "
              f"(the whole raw tree) {[round(r['raw_gib'], 3) for r in res]}"
              f", peak {[round(r['peak_gib'], 3) for r in res]}",
              flush=True)
        check(agree, f"mesh {run} {label}: the ranks' tokens differ")
        check(all(len(t) == MESH_MAX_NEW for t in tokens),
              f"mesh {run} {label}: a request stopped early")
        for rank, r in enumerate(res):
            print(f"{tag}: rank {rank} launches {r['launches']}", flush=True)
            for name in kernels:
                check(r["launches"].get(name, 0) > 0, f"mesh {run} {label}: "
                      f"rank {rank} never launched {name}")
            check(r["stats"] == res[0]["stats"], f"mesh {run} {label}: rank "
                  f"{rank}'s stats differ")
        if shape[0] > 1:
            # a dense engine's 8 slots over D 2: 4 rows a data rank; the
            # paged pool's rows whole on every data rank
            want_rows = [(0, N_SLOTS) if kw.get("paged") else
                         (rank // shape[1] * N_SLOTS // shape[0],
                          N_SLOTS // shape[0]) for rank in range(world)]
            check([r["rows"] for r in res] == want_rows, f"mesh {run} "
                  f"{label}: rows {[r['rows'] for r in res]}")
        if "b hits" in ref_tokens and req_run == "b":
            hits = res[0]["stats"]["prefix_hit_tokens"]
            print(f"{tag}: prefix-hit tokens {hits}, the single-card run "
                  f"b's {ref_tokens['b hits']}", flush=True)
            check(hits == ref_tokens["b hits"], f"mesh {run} {label}: "
                  f"prefix hits {hits} != run b's {ref_tokens['b hits']}")
        prompts, names = mesh_requests(req_run)
        registry = run_c_registry(cfg, dev) if req_run == "c" else None
        plain = ServeEngine(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                            quantize=True, adapters=registry, device=dev,
                            **{k: v for k, v in kw.items()
                               if k in ("fuse_qkv", "paged",
                                        "kv_block_size")})
        one_card_gib = held_gib(plain.params, plain.cache)
        impl = "reuse_ref" if kw.get("impl") == "reuse" else "ref"
        routes = res[0]["routes"]
        gate = token_gate(cfg, plain.params, prompts, tokens, impl=impl,
                          tol_rel=LOGIT_TOL, device=dev, registry=registry,
                          names=names, routes=routes,
                          prefill_lens=None if routes is None else
                          [res[0]["wave_lens"][i]
                           for i in range(len(prompts))])
        del plain
        torch.cuda.empty_cache()
        route_gate = {} if routes is None else print_routes(
            tag, "token gate", routes)
        ref = ref_tokens.get(req_run)
        same = None if ref is None else sum(
            a == b for x, y in zip(tokens, ref) for a, b in zip(x, y)) / max(
            1, sum(min(len(x), len(y)) for x, y in zip(tokens, ref)))
        print(f"{tag}: token gate: {gate.positions} positions, "
              f"{gate.differ} off the plain argmax, smallest slack "
              f"{gate.min_slack:.4f}; "
              + ("" if same is None else
                 f"share of tokens equal to the first {MESH_MAX_NEW} of "
                 f"each of run {req_run}'s on one card {same:.3f}; ")
              + f"the single-card engine of the same mode holds "
              f"{one_card_gib:.3f} GiB of weights and cache, a rank's "
              f"{res[0]['engine_gib']:.3f} "
              f"({res[0]['engine_gib'] / one_card_gib:.3f} of it)",
              flush=True)
        check(gate.ok, f"mesh {run} {label}: the token gate failed at "
              f"{gate.failures[:3]}; routing {route_gate}")
        out[label] = dict(res[0], tokens=None, routes=None, wave_lens=None,
                          route_gate=route_gate,
                          gate_positions=gate.positions,
                          gate_off_argmax=gate.differ,
                          gate_min_slack=gate.min_slack, same_as_one_card=same,
                          rows_by_rank=[r["rows"] for r in res],
                          launches_by_rank=[r["launches"] for r in res],
                          peak_gib_by_rank=[r["peak_gib"] for r in res],
                          engine_gib_by_rank=[r["engine_gib"] for r in res],
                          one_card_engine_gib=one_card_gib)
    del params
    torch.cuda.empty_cache()
    if run == "q":
        sd = [r["seqsharded"] for r in ranks]
        for kv in sd[0]:
            rs = [x[kv] for x in sd]
            print(f"kernel decode_attention_seqsharded [{card}] "
                  f"{rs[0]['shape']}, batch axes {rs[0]['batch_axes']}, "
                  f"sequence axes {rs[0]['seq_axes']}, mesh {mesh_s}: "
                  f"err vs the single-card decode_attention kernel on the "
                  f"same rows by rank {[round(x['max_abs_err'], 6) for x in rs]}"
                  f" (tol {rs[0]['tolerance']:.3e}); ms by rank: the call "
                  f"(two all-reduces over gloo, the card shared by "
                  f"{world} ranks) {[round(x['ms'], 4) for x in rs]}, its "
                  f"local part (PyTorch ops) "
                  f"{[round(x['local_ms'], 4) for x in rs]} (bound "
                  f"{rs[0]['local_bound_ms']:.4f}), the kernel on the rank's "
                  f"rows over the whole sequence "
                  f"{[round(x['kernel_rows_ms'], 4) for x in rs]}",
                  flush=True)
            for rank, x in enumerate(rs):
                check(x["max_abs_err"] <= x["tolerance"], f"sharded decode "
                      f"{kv} rank {rank}: error {x['max_abs_err']}")
        out["seqsharded_by_rank"] = sd
    print(f"e2e mesh {run} [{card}]: {world} ranks spawned, served and "
          f"joined in {spawn_wall:.1f} s", flush=True)
    return dict(out, config=arch or [MESH_FAMILIES[m][0]
                                     for m in MESH_MODES[run]],
                layers=[mesh_config(run, m).n_layers for m in MESH_MODES[run]],
                mesh=mesh_s, wall_s=spawn_wall,
                **({} if "launcher" not in ranks[0] else
                   {"launcher": [r["launcher"] for r in ranks]}))


def mesh_kernel_phase(dev, flush):
    """The rank shapes of runs n to q that earlier rows do not cover
    (``MESH_MATMULS``: decode rows M8, or a data rank's M4, and a wave's
    M4096; ``MESH_ATTN``: decode attention, dense and paged at run n's and
    run q's layouts, and flash at each)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(15)
    rows = []
    for run, cases in MESH_MATMULS.items():
        for kernel, ms, k, n, act in cases:
            for m in ms:
                rows.append(matmul_case(kernel, m, k, n, g, dev, flush,
                                        act=act))
    for run, layouts in MESH_ATTN.items():
        for h, hk, d, b in layouts:
            lengths = DECODE_LENGTHS[:b]
            for paged in (False, True) if run in ("n", "q") else (False,):
                for quant in (False, True) if run == "n" else (False,):
                    rows.append(decode_case(paged, h, hk, d, quant, g, dev,
                                            flush, lengths=lengths))
            rows += flash_case(h, hk, d, "bfloat16", g, dev, flush, b=b)
    return rows


# -- training: the flash backward kernel and run m ---------------------------

# the backward kernel phase: (B, Sq, Sk, H, Hk, d, causal, dtype): run m's
# layer (repro-100m) in bf16 and f32, the wide families' head layouts at d128
# (chameleon-34b's H64/Hk8, qwen2-moe's H16/Hk16, glm4-9b's H32/Hk2), the
# chaos harness's f32 d16, whisper's non-causal cross-attention over 1500
# frames and with Sq 200 > Sk 64, and ragged causal lengths 200 and 511
BWD_CASES = (
    (8, 256, 256, 12, 4, 64, True, "bfloat16"),
    (8, 256, 256, 12, 4, 64, True, "float32"),
    (8, 512, 512, 16, 16, 128, True, "bfloat16"),
    (8, 512, 512, 64, 8, 128, True, "bfloat16"),
    (8, 512, 512, 32, 2, 128, True, "bfloat16"),
    (8, 256, 256, 4, 2, 16, True, "float32"),
    (8, 200, 1500, 12, 12, 64, False, "float32"),
    (8, 200, 64, 12, 12, 64, False, "float32"),
    (8, 200, 200, 12, 4, 64, True, "bfloat16"),
    (8, 511, 511, 12, 4, 64, True, "bfloat16"))
BWD_MAIN = "B8 Sq256 Sk256 H12 Hk4 d64 causal bfloat16"   # run m's layer
TRAIN_ARGS = ("--arch", "repro-100m", "--batch", "8", "--seq", "256",
              "--steps", "40", "--lr", "1e-3", "--save-every", "10")
TRAIN_STEPS, TRAIN_FAIL_AT, TRAIN_RESTORED = 40, 25, 20
GRAD_TOL = {"bfloat16": 5e-2, "float32": 1e-4}   # of each leaf's scale


def flash_bwd_case(case, g, dev, flush) -> dict:
    """The backward kernel at one shape against its plain version on the
    same q, k, v, o (the forward kernel's) and dO: error within 1e-5 of
    each gradient's scale in f32, 1e-2 in bf16 (one rounding of the
    output); a second launch must give the same bits. Timed beside the
    plain version and SDPA's backward (``enable_gqa``, a yardstick the
    port never calls); the bound counts q, k, v, o, dO read and dQ, dK, dV
    written once, and 10 d operations a query-key pair and head (S, dP,
    dQ, dK, dV) at the type's peak."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    b, sq, sk, h, hk, d, causal, dtype_name = case
    dtype = getattr(torch, dtype_name)
    q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, sk, hk, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, sk, hk, d, generator=g, device=dev).to(dtype)
    do = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
    o = flash_attention_cuda(q, k, v, causal)
    got = flash_attention_bwd_cuda(q, k, v, o, do, causal)
    again = flash_attention_bwd_cuda(q, k, v, o, do, causal)
    torch.cuda.synchronize()
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal)
    same = all(torch.equal(a, c) for a, c in zip(got, again))
    scale = max(1.0, max(float(w.float().abs().max()) for w in want))
    err = max(float((a.float() - w.float()).abs().max())
              for a, w in zip(got, want))
    tol = (1e-2 if dtype == torch.bfloat16 else 1e-5) * scale
    kernel = time_ms(lambda: flash_attention_bwd_cuda(q, k, v, o, do,
                                                      causal), flush)
    plain = time_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, o, do,
                                                        causal), flush)
    # SDPA's backward alone: its forward once, then the gradient timed
    leaves = [t.transpose(1, 2).detach().requires_grad_(True)
              for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                         enable_gqa=True)
    dout = do.transpose(1, 2)
    lib = time_ms(lambda: torch.autograd.grad(out, leaves, dout,
                                              retain_graph=True), flush)
    del out, leaves
    pairs = sq * sk - (sq * (sq - 1) // 2 if causal else 0)
    shape = (f"B{b} Sq{sq} Sk{sk} H{h} Hk{hk} d{d} "
             f"{'causal' if causal else 'full'} {dtype_name}")
    row = case_row("flash_attention_bwd", shape, err, tol, kernel, plain, lib,
                   nbytes(q, k, v, o, do, *got), 10.0 * b * h * d * pairs,
                   dtype_name, "simt")
    print(f"kernel flash_attention_bwd {shape}: second launch identical "
          f"{same}", flush=True)
    check(same, f"flash_attention_bwd {shape}: a second launch gave other "
          "bits")
    return dict(row, relaunch_identical=same)


def flash_bwd_phase(dev, flush) -> list:
    import torch
    g = torch.Generator(device=dev).manual_seed(24)
    rows = [flash_bwd_case(case, g, dev, flush) for case in BWD_CASES]
    torch.cuda.empty_cache()
    return rows


def grad_check(cfg, params, batch, dtype_name, card) -> dict:
    """Step 1's gradients through the kernels against the same step
    through the plain path on the card (``impl="ref"``: the same params
    and batch), per leaf: not all zero where the plain leaf is not, zero
    in at most 1 in 1000 entries where the plain one is nonzero, and
    within ``GRAD_TOL`` of the plain leaf's largest entry."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models.model import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.loop import _grad_fn
    _build.reset_launches()
    loss, got = _grad_fn(get_model(cfg))(params, batch)
    launches = dict(_build.LAUNCHES)
    ref_loss, want = _grad_fn(get_model(cfg, impl="ref"))(params, batch)
    worst, lost_max, leaves = 0.0, 0.0, 0
    for a, w in zip(adamw.tree_leaves(got), adamw.tree_leaves(want)):
        a, w = a.float(), w.float()
        scale = float(w.abs().max())
        check(bool(a.any()) or scale == 0.0, f"grad check {cfg.name}: a "
              "leaf is all zero on the kernel path and not on the plain one")
        lost = float(((a == 0) & (w != 0)).float().mean())
        worst = max(worst, float((a - w).abs().max()) / max(scale, 1e-30))
        lost_max, leaves = max(lost_max, lost), leaves + 1
    tol = GRAD_TOL[dtype_name]
    print(f"train [{card}]: step-1 gradients of {cfg.name} "
          f"({cfg.n_layers} layers, {dtype_name}) through the kernels vs "
          f"the plain path: {leaves} leaves, worst |diff| / leaf scale "
          f"{worst:.3e} (tol {tol:.0e}), largest share of entries zeroed "
          f"{lost_max:.2e}; loss {float(loss):.6f} vs {float(ref_loss):.6f}"
          f"; launches {launches}", flush=True)
    check(worst <= tol and lost_max <= 1e-3, f"grad check {cfg.name} "
          f"{dtype_name}: worst {worst}, zeroed share {lost_max}")
    check(launches.get("flash_attention_bwd", 0) == cfg.n_layers,
          f"grad check {cfg.name}: {launches}")
    return dict(worst=worst, tolerance=tol, zeroed_share=lost_max,
                leaves=leaves, loss=float(loss), plain_loss=float(ref_loss),
                launches=launches)


def step_recorder():
    """A ``StepMonitor`` that also keeps every step's wall time in
    ``times``."""
    from repro_torch.train.fault_tolerance import StepMonitor

    class Recorder(StepMonitor):
        def observe(self, step, dt):
            self.times.append(dt)
            return super().observe(step, dt)

    mon = Recorder()
    mon.times = []
    return mon


def train_main(argv, dev, **kw) -> tuple:
    """``launch.train.main`` in process: (its stdout lines, the per-step
    losses of its ``step N  loss X`` lines, wall s)."""
    import contextlib
    import io
    import re
    import torch
    from repro_torch.launch import train
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        train.main(argv, device=dev, log_every=1, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    losses = [float(m.group(1)) for m in
              (re.fullmatch(r"step +\d+  loss (\S+)", ln) for ln in lines)
              if m]
    return lines, losses, wall


def profile_train(cfg, params, dev, card, steps: int = 4) -> dict:
    """Device-busy and idle share of ``steps`` training steps of run m
    (batch 8 x 256 of the data pipeline, the launcher's schedule), device
    ms split into the flash forward, the flash backward, the matmuls
    (cuBLAS), the optimizer (kernels launched inside ``adamw.update``) and
    the rest."""
    from repro_torch.data.pipeline import make_dataset, shard_batch
    from repro_torch.launch.train import deterministic
    from repro_torch.models.model import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.loop import make_train_step
    ocfg = adamw.AdamWConfig(lr=1e-3)
    ds = make_dataset(cfg, batch=8, seq=256, seed=0)
    batches = [shard_batch(ds.batch_at(s), device=dev) for s in range(steps)]
    with deterministic():
        step = make_train_step(get_model(cfg), ocfg, total_steps=TRAIN_STEPS,
                               warmup=5)
        state = [params, adamw.init(params, ocfg)]

        def run():
            for s, b in enumerate(batches):
                state[0], state[1], _ = step(state[0], state[1], b, s)

        run()                                      # warm
        wall, busy, top, in_opt = device_busy_ms(
            run, annotation=("optimizer", ((adamw, "update"),)))
    kinds = dict(flash_forward=0.0, flash_backward=0.0, matmul=0.0,
                 optimizer=0.0, rest=0.0)
    for name, ms in top:
        n = name.lower()
        opt_ms = min(ms, in_opt.get(name, 0.0))
        kinds["optimizer"] += opt_ms
        ms -= opt_ms
        if "flash_bwd" in n:
            kinds["flash_backward"] += ms
        elif "flash" in n:
            kinds["flash_forward"] += ms
        elif any(t in n for t in ("gemm", "nvjet", "xmma", "cutlass")):
            kinds["matmul"] += ms
        else:
            kinds["rest"] += ms
    idle = 1.0 - busy / wall
    print(f"train [{card}]: {steps} profiled steps: wall {wall:.2f} ms, "
          f"device busy {busy:.2f} ms, idle share {idle:.3f}; by kind (ms) "
          + ", ".join(f"{k} {v:.3f}" for k, v in kinds.items()), flush=True)
    for name, ms in top[:8]:
        print(f"train [{card}]:   {ms:9.3f} ms  {name[:110]}", flush=True)
    return dict(wall_ms=wall, busy_ms=busy, idle_share=idle, kinds=kinds,
                top=top[:12])


def end_to_end_train(dev, card) -> dict:
    """Run m: ``launch.train.main`` in process on full-width, full-depth
    repro-100m (bf16, its own ``remat=True``) with ``TRAIN_ARGS`` and a
    checkpoint directory under ``build/``, launches counted from 0 just
    before it. Before it, step 1's gradients through the kernels against
    the plain path's on the card, in bf16 at full depth and in f32 on a
    2-layer cut (the SIMT forward). It requires the flash forward's
    launches to be 2 (remat) x 12 layers x 40 steps, all on the tensor
    cores, the backward's 12 x 40, the mean loss of the last 5 steps 0.5
    nat below step 1's, and a second run with a failure injected at step
    25 (restored from step 20) to end with every parameter and moment
    bit-equal to the first run's. It prints tokens a second, the median
    step, peak memory and a profile of 4 steps."""
    import dataclasses
    import shutil
    import statistics
    import torch
    from repro_torch.configs.repro_100m import CONFIG
    from repro_torch.data.pipeline import make_dataset, shard_batch
    from repro_torch.kernels import _build
    from repro_torch.launch.train import deterministic
    from repro_torch.models.model import get_model
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint
    from repro_torch.train.fault_tolerance import FailureInjector
    check(CONFIG.dtype == "bfloat16" and CONFIG.remat,
          "run m: repro-100m is configured bf16 with remat")
    batch = shard_batch(make_dataset(CONFIG, batch=8, seq=256,
                                     seed=0).batch_at(0), device=dev)
    with deterministic():
        params = get_model(CONFIG).init(seed=0, device=dev)
        grads = {"bfloat16": grad_check(CONFIG, params, batch, "bfloat16",
                                        card)}
        f32 = dataclasses.replace(CONFIG, n_layers=2, dtype="float32")
        grads["float32"] = grad_check(
            f32, get_model(f32).init(seed=0, device=dev), batch, "float32",
            card)
    del params
    torch.cuda.empty_cache()

    dirs = [ROOT / "build" / f"train_ckpt_{i}" for i in (1, 2)]
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    runs = []
    for i, d in enumerate(dirs):
        monitor = step_recorder()
        hook = FailureInjector([TRAIN_FAIL_AT]) if i else None
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        lines, losses, wall = train_main([*TRAIN_ARGS, "--ckpt", str(d)],
                                         dev, monitor=monitor,
                                         fail_hook=hook)
        launches = dict(_build.LAUNCHES)
        runs.append(dict(lines=lines, losses=losses, wall_s=wall,
                         launches=launches, times=monitor.times,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30))
    first, second = runs
    n_layers = CONFIG.n_layers
    want = {"flash_attention": 2 * n_layers * TRAIN_STEPS,
            "flash_attention.wgmma": 2 * n_layers * TRAIN_STEPS,
            "flash_attention_bwd": n_layers * TRAIN_STEPS}
    for name, n in want.items():
        check(first["launches"].get(name, 0) == n, f"run m: {name} launched "
              f"{first['launches'].get(name, 0)} times, want {n}")
    check(first["lines"][-1].startswith("done: restarts=0 "),
          f"run m: {first['lines'][-1]}")
    check(second["lines"][-1].startswith("done: restarts=1 "),
          f"run m with a failure: {second['lines'][-1]}")
    losses = first["losses"]
    check(len(losses) == TRAIN_STEPS, f"run m: {len(losses)} loss lines")
    tail = statistics.fmean(losses[-5:])
    check(tail <= losses[0] - 0.5, f"run m: loss {losses[0]} -> {tail}")
    # the second run restored step 20 and ran on: its last checkpoint must
    # equal the first run's, every parameter and moment
    like = get_model(CONFIG).init(seed=1, device=dev)
    like = (like, adamw.init(like, adamw.AdamWConfig()))
    trees = [checkpoint.restore(str(d), like) for d in dirs]
    check(trees[0][1] == trees[1][1] == TRAIN_STEPS, "run m: last steps "
          f"{trees[0][1]}, {trees[1][1]}")
    flat = [checkpoint._flatten(t[0]) for t in trees]
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(*flat))
    check(second["losses"][:TRAIN_FAIL_AT] == losses[:TRAIN_FAIL_AT],
          "run m: the two runs' losses differ before the failure")
    params = trees[0][0][0]
    del like, trees, flat
    step_ms = statistics.median(first["times"]) * 1e3
    tok_s = 8 * 256 / statistics.median(first["times"])
    print(f"e2e train [{card}]: repro-100m (12 layers, d768, bf16, remat), "
          f"batch 8 x 256, {TRAIN_STEPS} steps in {first['wall_s']:.1f} s "
          f"(checkpoints every 10 included); median step {step_ms:.2f} ms, "
          f"{tok_s:.0f} training tokens/s; peak memory "
          f"{first['peak_gib']:.2f} GiB; loss {losses[0]:.4f} -> last 5 "
          f"mean {tail:.4f}; launches {first['launches']}", flush=True)
    print(f"e2e train [{card}]: losses "
          + " ".join(f"{x:.4f}" for x in losses), flush=True)
    print(f"e2e train [{card}]: failure injected at step {TRAIN_FAIL_AT}: "
          f"{second['lines'][-1]}; restored step {TRAIN_RESTORED}, every "
          f"parameter and moment at step {TRAIN_STEPS} bit-equal to the "
          f"uninterrupted run's {same}; its wall {second['wall_s']:.1f} s",
          flush=True)
    check(same, "run m: the resumed run's parameters or moments differ")
    profile = profile_train(CONFIG, params, dev, card)
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    del params
    torch.cuda.empty_cache()
    return dict(grads=grads, launches=first["launches"],
                launches_resumed=second["launches"], losses=losses,
                loss_tail=tail, wall_s=first["wall_s"], step_ms=step_ms,
                tokens_per_s=tok_s, peak_gib=first["peak_gib"],
                resumed_bit_equal=same, profile=profile)


def train_launcher_submit(lane):
    """Queue run m's launchers on ``lane``: ``python -m
    repro_torch.launch.train`` with run m's flags into a fresh checkpoint
    directory, then ``python -m repro_torch.launch.serve --ckpt <that dir>
    --reuse --paged --stats`` (run b's serving flags). Returns the
    directory."""
    import shutil
    ckpt = ROOT / "build" / "train_cli_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    lane.submit(("train cli", "train"),
                [sys.executable, *train_cli_argv("train", ckpt)])
    lane.submit(("train cli", "serve"),
                [sys.executable, *train_cli_argv("serve", ckpt)])
    return ckpt


def train_cli_argv(label, ckpt) -> list:
    if label == "train":
        return ["-m", "repro_torch.launch.train", *TRAIN_ARGS, "--ckpt",
                str(ckpt)]
    return ["-m", "repro_torch.launch.serve", "--ckpt", str(ckpt),
            *LAUNCH_ARGS, "--reuse", "--paged"]


def train_launcher_phase(card, lane, ckpt) -> dict:
    """Run m through the launchers as subprocesses on the card
    (``train_launcher_submit``): the training launcher must exit 0 and
    print the JAX launcher's lines (``arch=repro-100m devices=1
    mesh={'data': 1, 'model': 1}``, ``step N loss X`` at steps 10, 20, 30,
    40, ``done: restarts=0 ...``); the serving launcher must restore step
    40 from its checkpoint and exit 0."""
    import re
    import shutil
    out = {}
    for label in ("train", "serve"):
        rc, stdout, stderr, wall = lane.result(("train cli", label))
        print(f"launcher [{card}] {label}: `python "
              f"{' '.join(train_cli_argv(label, ckpt))}` exited {rc} in "
              f"{wall:.1f} s (beside the main thread's runs)", flush=True)
        check(rc == 0, f"launcher {label}: exit {rc}: {stderr[-2000:]}")
        lines = stdout.splitlines()
        for ln in lines[:8]:
            print(f"launcher [{card}] {label}: | {ln}", flush=True)
        out[label] = dict(wall_s=wall, lines=lines)
    lines = out["train"]["lines"]
    check(lines[0] == "arch=repro-100m devices=1 mesh={'data': 1, "
          "'model': 1}", f"launcher train: {lines[0]}")
    steps = [re.fullmatch(r"step +(\d+)  loss \d+\.\d{4}", ln)
             for ln in lines[1:-1]]
    check(all(steps) and [int(m.group(1)) for m in steps] == [10, 20, 30, 40],
          f"launcher train: step lines {lines[1:-1]}")
    check(re.fullmatch(r"done: restarts=0 stragglers=\d+", lines[-1]),
          f"launcher train: {lines[-1]}")
    check(f"restored step {TRAIN_STEPS} from {ckpt}" in out["serve"]["lines"],
          "launcher serve: no restore line for the trained checkpoint")
    shutil.rmtree(ckpt, ignore_errors=True)
    out["serve"]["lines"] = out["serve"]["lines"][:8]
    return out



# -- run r: training on a 2x2 mesh, and the dist modules ----------------------

MESH_TRAIN_ARGS = ("--arch", "repro-100m", "--mesh", "2x2", "--batch", "8",
                   "--seq", "256", "--steps", "4", "--save-every", "2")
MESH_TRAIN_FAIL_AT = 3
# |mesh loss - one-card loss| per step, nats: bf16 weights, and the mesh
# sums each row-parallel block's bf16 partials in f32 and each gradient
# over its data ranks, the one card in one bf16 product
MESH_TRAIN_LOSS_TOL = 5e-2
# the ring matmuls: repro-100m's gate and up (K768 N2048, int8 per
# channel) at model 2 and 4, a decode batch (M8, the .gemv kernels) and a
# prefill wave (bf16 M4096, the tensor-core mainloop)
RING_K, RING_N = 768, 2048
RING_M = (8, 4096)
RING_MODELS = {2: {"data": 2, "model": 2}, 4: {"model": 4}}
PIPE_STAGES, PIPE_MICRO, PIPE_B, PIPE_S = 4, 6, 2, 256
# the 2x2 rank's kernel shapes: flash forward and backward at a rank's
# layer (its 4 rows of the batch, 6 of 12 heads, 2 of 4 KV heads), the
# ring block products at model 2 and 4
MESH_TRAIN_FLASH = (4, 256, 6, 2, 64)
RING_BLOCKS = ((384, 1024), (192, 512))


def mesh_train_dirs():
    return [ROOT / "build" / f"mesh_train_ckpt_{i}" for i in (1, 2)]


def mesh_train_submit(lanes):
    """Queue run r's subprocesses, which time nothing: on ``lanes[2]`` the
    training launcher on the 2x2 mesh (``python -m
    repro_torch.launch.train --mesh 2x2 ...``) into a fresh directory,
    then ``python -m repro_torch.launch.serve --ckpt`` of it; on
    ``lanes[1]``, after the training launchers of run m, the same
    training with a failure injected at step ``MESH_TRAIN_FAIL_AT`` on
    every rank (``launch.train.main`` with ``fail_hook=``, a keyword,
    through :func:`mesh_train_failed_run`); on ``lanes[0]``, after the
    serving launchers, the dist modules' four ranks
    (:func:`dist_module_run`)."""
    import shutil
    for d in mesh_train_dirs():
        shutil.rmtree(d, ignore_errors=True)
    clean, failed = mesh_train_dirs()
    lanes[2].submit(("mesh r", "train"), [sys.executable,
                                          *mesh_train_argv("train", clean)])
    lanes[2].submit(("mesh r", "serve"), [sys.executable,
                                          *mesh_train_argv("serve", clean)])
    lanes[1].submit(("mesh r", "failed"), [
        sys.executable, "-c", "import sys, chip_smoke; "
        "chip_smoke.mesh_train_failed_run(sys.argv[1], sys.argv[2])",
        str(failed), str(OUT / "mesh_r_failed.json")])
    lanes[0].submit(("mesh r", "modules"), [
        sys.executable, "-c", "import sys, chip_smoke; "
        "chip_smoke.dist_module_run(sys.argv[1])",
        str(OUT / "mesh_r_modules.json")])


def mesh_train_argv(label, ckpt) -> list:
    if label == "train":
        return ["-m", "repro_torch.launch.train", *MESH_TRAIN_ARGS,
                "--ckpt", str(ckpt)]
    return ["-m", "repro_torch.launch.serve", "--ckpt", str(ckpt),
            *LAUNCH_ARGS, "--reuse", "--paged"]


def mesh_train_failed_run(ckpt, out):
    """Run r's second training (a subprocess on a lane): ``launch.train.
    main`` on the 2x2 mesh with every step logged and a failure injected
    at step ``MESH_TRAIN_FAIL_AT`` on every rank; writes each rank's
    result (its lines, launches, block digests and bytes) to ``out``."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import train
    from repro_torch.train.fault_tolerance import FailureInjector
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    ranks = train.main([*MESH_TRAIN_ARGS, "--ckpt", ckpt], device="cuda",
                       fail_hook=FailureInjector([MESH_TRAIN_FAIL_AT]),
                       log_every=1)
    Path(out).write_text(json.dumps(dict(
        ranks=ranks, wall_s=time.perf_counter() - t0)))


def dist_module_run(out):
    """The dist modules' phase (a subprocess on a lane): four ranks on the
    card (``dist_module_rank``); writes their results to ``out``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    ranks = run_ranks(dist_module_rank, 4, "cuda", mesh_shape={"pod": 4},
                      threads=1)
    Path(out).write_text(json.dumps(dict(
        ranks=ranks, wall_s=time.perf_counter() - t0)))


def dist_module_rank(mesh) -> dict:
    """One rank of the dist modules' phase: the ring matmuls (each rank's
    block held to its block of the plain whole product, the launches
    counted by kernel), the compressed exchange of a full-width
    repro-100m gradient leaf, and the pipeline of four stages of three
    repro-100m layers against the twelve in sequence."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    return dict(rings=ring_rank(mesh), compression=compression_rank(mesh),
                pipeline=pipeline_rank(mesh))


def ring_rank(mesh) -> list:
    import torch
    from repro_torch.core.quantization import QuantConfig, dequantize, \
        quantize
    from repro_torch.dist import collective_matmul as R
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    dev = mesh.device
    g = torch.Generator(device=dev).manual_seed(27)     # one on every rank
    qt = quantize(torch.randn(RING_K, RING_N, generator=g, device=dev)
                  * RING_K ** -0.5, QuantConfig(8))
    w = dequantize(qt, torch.float32)
    rows = []
    for p, axes in RING_MODELS.items():
        sub = make_host_mesh(axes, device=dev)
        r = sub.coords["model"]
        kl, nl = RING_K // p, RING_N // p
        for m in RING_M:
            x = torch.randn(m, RING_K, generator=g, device=dev).to(
                torch.bfloat16)
            want = (x.float() @ w)[:, r * nl:(r + 1) * nl]
            scale = max(1.0, float(want.abs().max()))
            xb = x[:, r * kl:(r + 1) * kl].contiguous()
            blocks = {"allgather": R._qslice(qt, r * nl, nl, axis=1),
                      "reducescatter": R._qslice(qt, r * kl, kl, axis=0)}
            for impl in ("auto", "reuse"):
                for form, wb in blocks.items():
                    fn = R.ring_allgather_matmul if form == "allgather" \
                        else R.ring_matmul_reducescatter
                    torch.cuda.synchronize()
                    _build.reset_launches()
                    y = fn(xb, wb, "model", impl=impl, mesh=sub)
                    torch.cuda.synchronize()
                    launches = dict(_build.LAUNCHES)
                    err = float((y.float() - want).abs().max())
                    # the ring returns x's type: one bf16 rounding of the
                    # f32 sum of p block products
                    rows.append(dict(
                        model=p, m=m, impl=impl, form=form, err=err,
                        tol=2.0 ** -8 * scale, scale=scale,
                        launches=launches))
    return rows


def compression_rank(mesh) -> dict:
    import torch
    from repro_torch.configs.repro_100m import CONFIG
    from repro_torch.dist import compression as Z
    from repro_torch.launch.mesh import make_host_mesh
    pod = make_host_mesh({"pod": mesh.size}, device=mesh.device)
    r = pod.coords["pod"]
    shape = (CONFIG.n_layers, CONFIG.d_model, CONFIG.d_ff)  # layers.ffn.gate
    g = torch.Generator(device=mesh.device).manual_seed(100 + r)
    x = torch.randn(shape, generator=g, device=mesh.device) * (1 + r) * 1e-3
    exact = x.clone()
    import torch.distributed as dist
    dist.all_reduce(exact, group=pod.group_of("pod"))
    exact /= pod.size
    mean, _ = Z.compressed_allreduce_mean(x, "pod", mesh=pod)
    rel = float(torch.linalg.vector_norm(mean - exact)
                / torch.linalg.vector_norm(exact))
    acc, acc_exact, err = torch.zeros_like(x), torch.zeros_like(x), None
    for _ in range(8):
        m, err = Z.compressed_allreduce_mean(x, "pod", err, mesh=pod)
        acc += m
        acc_exact += exact
    ef = float(torch.linalg.vector_norm(acc - acc_exact)
               / torch.linalg.vector_norm(acc_exact))
    comp, raw = Z.wire_bytes(x)
    return dict(shape=list(shape), rel=rel, feedback_rel=ef,
                wire_bytes=[comp, raw])


def pipeline_rank(mesh) -> dict:
    import torch
    from repro_torch.configs.repro_100m import CONFIG
    from repro_torch.dist.pipeline import make_pipelined_apply
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.model import get_model
    stage = make_host_mesh({"stage": PIPE_STAGES}, device=mesh.device)
    per = CONFIG.n_layers // PIPE_STAGES
    params = get_model(CONFIG).init(seed=0, device=mesh.device)

    def stack(t):
        return t.reshape(PIPE_STAGES, per, *t.shape[1:])

    def restack(tree):
        if isinstance(tree, dict):
            return {k: restack(v) for k, v in tree.items()}
        return stack(tree)

    def stage_fn(w, act):
        for i in range(per):
            act = T._layer_fwd(T.layer_slice(w, i), act, CONFIG, "auto")
        return act

    g = torch.Generator(device=mesh.device).manual_seed(31)
    tokens = torch.randint(0, CONFIG.vocab_size, (PIPE_MICRO, PIPE_B,
                                                  PIPE_S), generator=g,
                           device=mesh.device)
    with torch.inference_mode():
        x = L.embed_fwd(params["embed"], tokens).to(T.param_dtype(CONFIG))
        _build.reset_launches()
        apply = make_pipelined_apply(stage_fn, stage, PIPE_MICRO)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = apply(restack(params["layers"]), x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        # the 12 layers in sequence, a microbatch at a time (the shapes
        # the stages ran)
        seq = []
        for mb in x:
            for i in range(CONFIG.n_layers):
                mb = T._layer_fwd(T.layer_slice(params["layers"], i), mb,
                                  CONFIG, "auto")
            seq.append(mb)
        seq = torch.stack(seq)
        same = bool(torch.equal(y, seq))
        err = float((y.float() - seq.float()).abs().max())
    return dict(equal=same, max_abs_err=err, wall_s=wall, launches=launches,
                ticks=PIPE_MICRO + PIPE_STAGES - 1)


def mesh_train_kernel_phase(dev, flush) -> list:
    """Run r's rank shapes: flash forward and backward at a 2x2 rank's
    layer, and the ring block products (K384 N1024 at model 2, K192 N512
    at model 4) on both matmul kernels at M8 (.gemv) and bf16 M4096
    (.wgmma)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(33)
    b, s, h, hk, d = MESH_TRAIN_FLASH
    rows = flash_case(h, hk, d, "bfloat16", g, dev, flush, sq=s, b=b)
    rows.append(flash_bwd_case((b, s, s, h, hk, d, True, "bfloat16"), g,
                               dev, flush))
    for k, n in RING_BLOCKS:
        for m in RING_M:
            for kernel in ("axllm_matmul", "reuse_matmul"):
                rows.append(matmul_case(kernel, m, k, n, g, dev, flush))
    torch.cuda.empty_cache()
    return rows


def end_to_end_mesh_train(dev, card, lanes) -> dict:
    """Run r's checks, once its subprocesses (``mesh_train_submit``) are
    done: the launcher on the 2x2 mesh exits 0 and prints the JAX
    launcher's lines (``devices=4 mesh={'data': 2, 'model': 2}``); the run
    with a failure at step 3 restarts once, every rank prints the same
    lines, its step-4 loss line is the uninterrupted run's and its last
    checkpoint equals that run's in every leaf; each step's loss is the
    one-card launcher's with the same flags (run in process here) within
    ``MESH_TRAIN_LOSS_TOL``; the checkpoint restores on one card with
    every leaf bit-equal to the ranks' blocks (each rank's digests of its
    blocks against the restored leaves cut for it); ``launch.serve
    --ckpt`` of it restores step 4 and serves; each rank holds about a
    quarter of the parameters and moments, and the path launched the
    flash forward and backward kernels. Then the dist modules' phase."""
    import hashlib
    import re
    import shutil
    import torch
    from repro_torch.configs.repro_100m import CONFIG
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import _blocks, deterministic
    from repro_torch.models.model import get_model
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint
    clean, failed = mesh_train_dirs()
    out = {}
    for label in ("train", "serve"):
        rc, stdout, stderr, wall = lanes[2].result(("mesh r", label))
        print(f"e2e mesh r [{card}] {label}: `python "
              f"{' '.join(mesh_train_argv(label, clean))}` exited {rc} in "
              f"{wall:.1f} s", flush=True)
        check(rc == 0, f"run r {label}: exit {rc}: {stderr[-3000:]}")
        out[label] = dict(wall_s=wall, lines=stdout.splitlines())
        for ln in out[label]["lines"][:8]:
            print(f"e2e mesh r [{card}] {label}: | {ln}", flush=True)
    lines = out["train"]["lines"]
    check(lines[0] == "arch=repro-100m devices=4 mesh={'data': 2, "
          "'model': 2}", f"run r: {lines[0]}")
    check(re.fullmatch(r"done: restarts=0 stragglers=\d+", lines[-1]),
          f"run r: {lines[-1]}")
    check(f"restored step 4 from {clean}" in out["serve"]["lines"],
          "run r: launch.serve did not restore step 4")
    rc, _, stderr, wall = lanes[1].result(("mesh r", "failed"))
    check(rc == 0, f"run r with a failure: exit {rc}: {stderr[-3000:]}")
    res = json.loads((OUT / "mesh_r_failed.json").read_text())
    ranks = res["ranks"]
    flines = ranks[0]["out"].splitlines()
    same_lines = all(r["out"] == ranks[0]["out"] for r in ranks)
    check(same_lines, "run r: the ranks printed different lines")
    check(flines[-1].startswith("done: restarts=1 "), f"run r: {flines[-1]}")
    # steps 1 to 3 logged, the failure at step index 3 restores step 2,
    # and step 3 is logged again: it must repeat its loss
    by_step = {}
    for m in (re.fullmatch(r"step +(\d+)  loss (\S+)", ln) for ln in flines):
        if m:
            by_step.setdefault(int(m.group(1)), set()).add(m.group(2))
    check(sorted(by_step) == [1, 2, 3, 4]
          and all(len(v) == 1 for v in by_step.values())
          and flines[-2] == lines[-2],
          f"run r: step lines {flines[1:-1]} against {lines[1:-1]}")
    losses = [float(next(iter(by_step[s]))) for s in (1, 2, 3, 4)]
    # the one card, the same flags
    one_argv = [a for a in MESH_TRAIN_ARGS if a not in ("--mesh", "2x2")]
    one_dir = ROOT / "build" / "mesh_train_one"
    shutil.rmtree(one_dir, ignore_errors=True)
    one_lines, one_losses, one_wall = train_main(
        [*one_argv, "--ckpt", str(one_dir)], dev)
    gaps = [abs(a - b) for a, b in zip(losses, one_losses)]
    print(f"e2e mesh r [{card}]: repro-100m ({CONFIG.n_layers} layers, "
          f"d{CONFIG.d_model}, {CONFIG.dtype}) on 2x2 ranks sharing the card "
          f"(gloo), batch 8 x 256: losses "
          + " ".join(f"{x:.4f}" for x in losses) + "; one card "
          + " ".join(f"{x:.4f}" for x in one_losses)
          + f"; largest gap {max(gaps):.4f} nats (tol "
          f"{MESH_TRAIN_LOSS_TOL}); every rank the same lines {same_lines}",
          flush=True)
    check(max(gaps) <= MESH_TRAIN_LOSS_TOL, f"run r: loss gaps {gaps}")
    # both runs' last checkpoints, leaf by leaf, and the ranks' blocks
    like = get_model(CONFIG).init(seed=1, device=dev)
    like = (like, adamw.init(like, adamw.AdamWConfig()))
    trees = [checkpoint.restore(str(d), like) for d in (clean, failed)]
    flat = [dict(checkpoint._flatten(t[0])) for t in trees]
    resumed_equal = trees[0][1] == trees[1][1] == 4 and all(
        torch.equal(flat[0][k], flat[1][k]) for k in flat[0])
    whole_meta = get_model(CONFIG).init(seed=0, device="meta")
    blocks_equal = True
    for rank, r in enumerate(ranks):
        mesh = Mesh(axes={"data": 2, "model": 2}, rank=rank, device=dev)
        pspec = shd.param_specs(whole_meta, mesh, shd.DEFAULT_RULES)
        ospec = adamw.state_specs(adamw.init(whole_meta, adamw.AdamWConfig()),
                                  pspec)
        cut = (_blocks(trees[1][0][0], pspec, mesh),
               _blocks(trees[1][0][1], ospec, mesh))
        for name, t in checkpoint._flatten(cut):
            t = t.detach().cpu().contiguous()
            raw = t.reshape(-1).view(torch.uint8) if t.numel() else t
            blocks_equal &= r["digests"][name] == hashlib.sha1(
                raw.numpy().tobytes()).hexdigest()
    shares = [r["bytes"] / r["whole_bytes"] for r in ranks]
    for rank, r in enumerate(ranks):
        print(f"e2e mesh r [{card}]: rank {rank} holds {r['bytes'] / 2**30:.4f}"
              f" GiB of parameters and moments, a share {shares[rank]:.4f} of"
              f" the whole tree's {r['whole_bytes'] / 2**30:.4f} GiB; "
              f"launches {r['launches']}", flush=True)
    print(f"e2e mesh r [{card}]: failure injected at step "
          f"{MESH_TRAIN_FAIL_AT} on every rank: {flines[-1]}; its last "
          f"checkpoint equal to the uninterrupted run's in every leaf "
          f"{resumed_equal}; restored on one card, every leaf bit-equal to "
          f"the ranks' blocks {blocks_equal}; walls {out['train']['wall_s']:.1f}"
          f" s and {wall:.1f} s (one card, in process: {one_wall:.1f} s)",
          flush=True)
    check(resumed_equal, "run r: the resumed run's checkpoint differs")
    check(blocks_equal, "run r: a restored leaf differs from a rank's block")
    check(all(0.24 < s < 0.26 for s in shares), f"run r: shares {shares}")
    for r in ranks:        # steps 1, 2, then 3 failed and restored 2: 3, 4
        for name in ("flash_attention.wgmma", "flash_attention_bwd"):
            check(r["launches"].get(name, 0) > 0, f"run r: {name} "
                  f"launched {r['launches'].get(name, 0)} times")
    del like, trees, flat
    for d in (clean, failed, one_dir):
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    modules = dist_module_check(card, lanes)
    return dict(lines=lines, failed_lines=flines, losses=losses,
                one_card_losses=one_losses, loss_gaps=gaps,
                loss_tol=MESH_TRAIN_LOSS_TOL, resumed_equal=resumed_equal,
                blocks_equal=blocks_equal, shares=shares,
                bytes=[r["bytes"] for r in ranks],
                launches=ranks[0]["launches"],
                launches_ranks=[r["launches"] for r in ranks],
                walls=dict(train=out["train"]["wall_s"], failed=wall,
                           one_card=one_wall),
                modules=modules)


def dist_module_check(card, lanes) -> dict:
    rc, _, stderr, wall = lanes[0].result(("mesh r", "modules"))
    check(rc == 0, f"dist modules: exit {rc}: {stderr[-3000:]}")
    ranks = json.loads((OUT / "mesh_r_modules.json").read_text())["ranks"]
    for rank, r in enumerate(ranks):
        for row in r["rings"]:
            lib = "reuse_matmul" if row["impl"] == "reuse" else "axllm_matmul"
            path = "gemv" if row["m"] <= 16 else "wgmma"
            hops = row["model"]
            if rank == 0:
                print(f"ring {row['form']} [{card}]: model {row['model']} "
                      f"M{row['m']} K{RING_K} N{RING_N} int8 per-channel "
                      f"impl={row['impl']}: |err| {row['err']:.3e} (tol "
                      f"{row['tol']:.1e}); launches {row['launches']}",
                      flush=True)
            check(row["err"] <= row["tol"], f"ring {row}")
            check(row["launches"].get(f"{lib}.{path}", 0) == hops,
                  f"ring: {lib}.{path} launched {row['launches']}, want "
                  f"{hops} (one a hop)")
        c = r["compression"]
        check(c["rel"] < 0.02 and c["feedback_rel"] < 0.005,
              f"compression: {c}")
        p = r["pipeline"]
        check(p["equal"], f"pipeline: {p}")
    c, p = ranks[0]["compression"], ranks[0]["pipeline"]
    print(f"compression [{card}]: 4 ranks, one repro-100m gradient leaf "
          f"(layers.ffn.gate {c['shape']}, f32): relative error of the "
          f"mean {c['rel']:.3e} (bound 0.02); 8 steps of error feedback "
          f"{c['feedback_rel']:.3e} (bound 0.005); wire bytes "
          f"{c['wire_bytes'][0]} of {c['wire_bytes'][1]} "
          f"({c['wire_bytes'][1] / c['wire_bytes'][0]:.2f}x fewer)",
          flush=True)
    from repro_torch.configs.repro_100m import CONFIG
    print(f"pipeline [{card}]: {PIPE_STAGES} stages of "
          f"{CONFIG.n_layers // PIPE_STAGES} repro-100m layers, "
          f"{PIPE_MICRO} microbatches of B{PIPE_B} S{PIPE_S}, {p['ticks']} "
          f"ticks: equal to the {CONFIG.n_layers} layers in sequence "
          f"{p['equal']} (max "
          f"|err| {p['max_abs_err']:.3e}); rank 0's launches "
          f"{p['launches']}; wall {p['wall_s']:.2f} s over gloo; the "
          f"modules' spawn {wall:.1f} s", flush=True)
    return dict(rings=ranks[0]["rings"], compression=c, pipeline=p,
                wall_s=wall,
                launches={f"{row['form']} model{row['model']} M{row['m']} "
                          f"{row['impl']}": row["launches"]
                          for row in ranks[0]["rings"]})


# -- run s: the moe, ssm, hybrid and audio families trained on a 2x2 mesh ----

# family -> (arch, layers kept (None: every layer), dtype (None: the
# config's), int8 AdamW moments); the depth cuts for chip time, xlstm in
# float32 as run j serves it (a bf16 xlstm-1.3b with random weights does
# not reproduce itself), the moe's moments int8: its float32 moments
# (14.6 GB) made its one-card run peak at 63 GB and its checkpoint 17 GB,
# on a card the other lanes share, and so its expert stacks' int8 moments
# go through the 2x2 checkpoint and its restore
MESH_FAMILY_RUNS = {"moe": ("qwen2-moe-a2.7b", 1, None, True),
                    "ssm": ("xlstm-1.3b", 8, "float32", False),
                    "hybrid": ("zamba2-1.2b", 14, None, False),
                    "audio": ("whisper-small", None, None, False)}
MESH_FAMILY_STEPS = 4
MESH_FAMILY_ARGS = ("--batch", "8", "--seq", "256", "--steps",
                    str(MESH_FAMILY_STEPS), "--save-every",
                    str(MESH_FAMILY_STEPS), "--set", "grad_accum=1")
# |mesh loss - one-card loss| per step, nats, for a float32 config: the
# mesh sums the same float32 products in another order
MESH_FAMILY_F32_TOL = 1e-3
# each family's rank shapes of flash attention (B, Sq, Sk, H, Hk, d,
# causal, dtype): a 2x2 rank's 4 of 8 rows and half of the heads; the
# audio model's attention runs in float32 (its encoder and decoder
# streams are float32 in the reference)
MESH_FAMILY_FLASH = {
    "moe": ((4, 256, 256, 8, 8, 128, True, "bfloat16"),),
    "hybrid": ((4, 256, 256, 16, 16, 64, True, "bfloat16"),),
    "audio": ((4, 1500, 1500, 6, 6, 64, False, "float32"),
              (4, 256, 1500, 6, 6, 64, False, "float32"),
              (4, 256, 256, 6, 6, 64, True, "float32"))}


def mesh_family_config(family):
    """(the cut config, the launcher's flags for it, a line saying the
    cut) of a family of run s."""
    import dataclasses
    from repro_torch.configs import get_config
    arch, layers, dtype, int8 = MESH_FAMILY_RUNS[family]
    full = get_config(arch)
    sets = {"grad_accum": 1}
    if layers is not None:
        sets["n_layers"] = layers
    if dtype is not None:
        sets["dtype"] = dtype
    if int8:
        sets["int8_optimizer"] = True
    cfg = dataclasses.replace(full, **sets)
    argv = ["--arch", arch, *MESH_FAMILY_ARGS,
            *[a for k, v in sets.items() if k != "grad_accum"
              for a in ("--set", f"{k}={v}")]]
    cut = (f"{arch} at full width (d{cfg.d_model}), {cfg.n_layers} of "
           f"{full.n_layers} layers"
           + (f" and {cfg.n_enc_layers} encoder layers"
              if cfg.is_encoder_decoder else "")
           + f", {cfg.dtype}, grad_accum 1 (the config's {full.grad_accum}:"
           " a rank's 4 rows a step)"
           + (", int8 AdamW moments" if int8 else ""))
    return cfg, argv, cut


def mesh_family_flash(cfg, steps: int) -> tuple:
    """(flash forward, flash backward) launches a rank of run s makes in
    ``steps`` steps of one microbatch: one forward a layer's attention,
    again in the backward's recompute where ``remat`` wraps that layer,
    and one backward each. The moe decoder's layers and the audio
    model's encoder, self- and cross-attention layers are rematerialized;
    the hybrid's shared attention block (one a site) is not; the ssm
    family has no attention."""
    from repro_torch.models import hybrid
    if cfg.family == "ssm":
        return 0, 0
    if cfg.family == "hybrid":
        sites = hybrid._groups(cfg)[0]
        return sites * steps, sites * steps
    layers = cfg.n_layers + (cfg.n_layers + cfg.n_enc_layers
                             if cfg.is_encoder_decoder else 0)
    return layers * (2 if cfg.remat else 1) * steps, layers * steps


def mesh_family_ckpt():
    return ROOT / "build" / "mesh_s_moe_ckpt"


def mesh_family_rank(mesh) -> dict:
    """One rank of run s: ``launch.train``'s rank body
    (``train_ranks``: launches counted from 0 just before it) on each
    family in turn, each freed before the next, with its wall time and
    the rank's peak device memory; the moe's run checkpoints its last
    step."""
    import gc
    import torch
    from repro_torch.launch import train
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for family in MESH_FAMILY_RUNS:
        argv = mesh_family_config(family)[1] + ["--mesh", "2x2"]
        if family == "moe":
            argv += ["--ckpt", str(mesh_family_ckpt())]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = train.train_ranks(mesh, argv, log_every=1)
        torch.cuda.synchronize()
        r["wall_s"] = time.perf_counter() - t0
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if family != "moe":
            r.pop("digests")
        out[family] = r
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_family_run(out, device="cuda"):
    """Run s (a subprocess on a lane): the four ranks at 2x2 on the card
    over gloo (:func:`mesh_family_rank`), then, once they have ended, the
    one-card run of each family with the same flags (``launch.train.main``
    in this process), then the moe's checkpoint restored onto the card
    against the ranks' blocks; writes everything to ``out``. ``device``:
    the card (a rehearsal on the host passes "cpu")."""
    import concurrent.futures
    import gc
    import hashlib
    import shutil
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import Mesh, run_ranks
    from repro_torch.launch.train import _blocks
    from repro_torch.models.model import get_model
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint
    torch.backends.cuda.matmul.allow_tf32 = False
    shutil.rmtree(mesh_family_ckpt(), ignore_errors=True)
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_family_rank, 4, device,
                      mesh_shape={"data": 2, "model": 2}, threads=1)
    spawn_s = time.perf_counter() - t0
    dev = torch.device(device)
    one = {}
    for family in MESH_FAMILY_RUNS:
        torch.cuda.reset_peak_memory_stats()
        lines, losses, wall = train_main(mesh_family_config(family)[1], dev)
        one[family] = dict(lines=lines, losses=losses, wall_s=wall,
                           peak_gib=torch.cuda.max_memory_allocated()
                           / 2**30)
        gc.collect()
        torch.cuda.empty_cache()
    # the moe's checkpoint on one card, cut again for each rank: every
    # block's bytes against the digest the rank took of its own
    t1 = time.perf_counter()
    cfg = mesh_family_config("moe")[0]
    meta = get_model(cfg).init(seed=0, device="meta")
    like = (meta, adamw.init(meta, adamw.AdamWConfig(
        int8_moments=cfg.int8_optimizer)))
    tree, step = checkpoint.restore(str(mesh_family_ckpt()), like,
                                    device=dev)
    equal = step == MESH_FAMILY_STEPS

    def digest(t):     # hashlib lets go of the GIL: threads hash at once
        t = t.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8) if t.numel() else t
        return hashlib.sha1(raw.numpy().data).hexdigest()

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        for rank, r in enumerate(ranks):
            mesh = Mesh(axes={"data": 2, "model": 2}, rank=rank, device=dev)
            pspec = shd.param_specs(meta, mesh, shd.DEFAULT_RULES)
            ospec = adamw.state_specs(like[1], pspec)
            cut = checkpoint._flatten((_blocks(tree[0], pspec, mesh),
                                       _blocks(tree[1], ospec, mesh)))
            got = pool.map(digest, [t for _, t in cut])
            equal &= all(r["moe"]["digests"][name] == d
                         for (name, _), d in zip(cut, got))
            r["moe"].pop("digests")
            del cut
    restore_s = time.perf_counter() - t1
    del tree
    shutil.rmtree(mesh_family_ckpt(), ignore_errors=True)
    Path(out).write_text(json.dumps(dict(
        ranks=ranks, one_card=one, spawn_s=spawn_s, restored_equal=equal,
        restore_s=restore_s, wall_s=time.perf_counter() - t0)))


def mesh_family_submit(lane) -> None:
    """Queue run s's subprocess (:func:`mesh_family_run`) on ``lane``."""
    lane.submit(("mesh s", "families"), [
        sys.executable, "-c", "import sys, chip_smoke; "
        "chip_smoke.mesh_family_run(sys.argv[1])",
        str(OUT / "mesh_s_families.json")])


def mesh_family_kernel_phase(dev, flush) -> list:
    """Run s's rank shapes of flash attention, forward and backward
    (``MESH_FAMILY_FLASH``)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(34)
    rows = []
    for cases in MESH_FAMILY_FLASH.values():
        for case in cases:
            b, sq, sk, h, hk, d, causal, dtype_name = case
            rows += flash_case(h, hk, d, dtype_name, g, dev, flush, sq=sq,
                               sk=sk, causal=causal, b=b)
            rows.append(flash_bwd_case(case, g, dev, flush))
    torch.cuda.empty_cache()
    return rows


def end_to_end_mesh_family(card, lane) -> dict:
    """Run s's checks, once its subprocess (:func:`mesh_family_run`) is
    done: for each family every rank prints the same lines (the JAX
    launcher's, ``devices=4 mesh={'data': 2, 'model': 2}``), each step's
    loss lies within ``MESH_TRAIN_LOSS_TOL`` (``MESH_FAMILY_F32_TOL`` for a
    float32 config) of the one-card run's, a rank holds exactly the
    blocks ``param_specs`` gives it, and its flash forward and backward
    launches are exactly :func:`mesh_family_flash`'s; the moe's
    checkpoint restores on one card with every leaf bit-equal to the
    ranks' blocks."""
    import re
    rc, _, stderr, wall = lane.result(("mesh s", "families"))
    check(rc == 0, f"run s: exit {rc}: {stderr[-3000:]}")
    res = json.loads((OUT / "mesh_s_families.json").read_text())
    ranks, one = res["ranks"], res["one_card"]
    out = {}
    for family in MESH_FAMILY_RUNS:
        cfg, argv, cut = mesh_family_config(family)
        rs = [r[family] for r in ranks]
        lines = rs[0]["out"].splitlines()
        same = all(r["out"] == rs[0]["out"] for r in rs)
        losses = [float(m.group(1)) for m in
                  (re.fullmatch(r"step +\d+  loss (\S+)", ln) for ln in lines)
                  if m]
        gaps = [abs(a - b) for a, b in zip(losses, one[family]["losses"])]
        tol = MESH_FAMILY_F32_TOL if cfg.dtype == "float32" \
            else MESH_TRAIN_LOSS_TOL
        fwd, bwd = mesh_family_flash(cfg, MESH_FAMILY_STEPS)
        launches = [(r["launches"].get("flash_attention", 0),
                     r["launches"].get("flash_attention_bwd", 0)) for r in rs]
        tc = [r["launches"].get("flash_attention.wgmma", 0) for r in rs]
        shares = [r["bytes"] / r["whole_bytes"] for r in rs]
        predicted = [r["spec_bytes"] / r["whole_bytes"] for r in rs]
        print(f"e2e mesh s [{card}] {family}: {cut}; B8 S256, "
              f"{MESH_FAMILY_STEPS} steps on 2x2 ranks sharing the card "
              f"(gloo)", flush=True)
        print(f"e2e mesh s [{card}] {family}: losses "
              + " ".join(f"{x:.4f}" for x in losses) + "; one card "
              + " ".join(f"{x:.4f}" for x in one[family]["losses"])
              + f"; largest gap {max(gaps):.4f} nats (tol {tol}); every rank "
              f"the same lines {same}; walls: ranks "
              + " / ".join(f"{r['wall_s']:.1f}" for r in rs)
              + f" s, one card {one[family]['wall_s']:.1f} s", flush=True)
        for rank, r in enumerate(rs):
            print(f"e2e mesh s [{card}] {family}: rank {rank} holds "
                  f"{r['bytes'] / 2**30:.4f} GiB of parameters and moments, "
                  f"a share {shares[rank]:.4f} of the whole tree's "
                  f"{r['whole_bytes'] / 2**30:.4f} GiB (param_specs "
                  f"predict {predicted[rank]:.4f}); peak "
                  f"{r['peak_gib']:.3f} GiB (one card "
                  f"{one[family]['peak_gib']:.3f}); flash forward "
                  f"{launches[rank][0]} ({tc[rank]} on .wgmma), backward "
                  f"{launches[rank][1]} (expected {fwd}, {bwd})", flush=True)
        check(rc == 0 and lines[0] == f"arch={cfg.name} devices=4 "
              "mesh={'data': 2, 'model': 2}", f"run s {family}: {lines[:1]}")
        check(re.fullmatch(r"done: restarts=0 stragglers=\d+", lines[-1]),
              f"run s {family}: {lines[-1]}")
        check(same, f"run s {family}: the ranks printed different lines")
        check(len(losses) == len(one[family]["losses"]) == MESH_FAMILY_STEPS
              and max(gaps) <= tol, f"run s {family}: loss gaps {gaps}")
        check(all(r["bytes"] == r["spec_bytes"] for r in rs),
              f"run s {family}: a rank's bytes are not its specs' blocks")
        check(all(n == (fwd, bwd) for n in launches),
              f"run s {family}: flash launches {launches}, want {fwd, bwd}")
        out[family] = dict(
            cut=cut, losses=losses, one_card_losses=one[family]["losses"],
            loss_gaps=gaps, loss_tol=tol, same_lines=same, shares=shares,
            predicted_shares=predicted, peak_gib=[r["peak_gib"] for r in rs],
            one_card_peak_gib=one[family]["peak_gib"],
            launches=rs[0]["launches"],
            launches_ranks=[r["launches"] for r in rs],
            walls=dict(ranks=[r["wall_s"] for r in rs],
                       one_card=one[family]["wall_s"]))
    print(f"e2e mesh s [{card}]: the moe's checkpoint of step "
          f"{MESH_FAMILY_STEPS} from the 2x2 ranks, restored on one card: "
          f"every leaf bit-equal to the ranks' blocks "
          f"{res['restored_equal']} ({res['restore_s']:.1f} s); the spawn "
          f"{res['spawn_s']:.1f} s, the subprocess {wall:.1f} s", flush=True)
    check(res["restored_equal"], "run s: a restored moe leaf differs from a "
          "rank's block")
    return dict(families=out, restored_equal=res["restored_equal"],
                walls=dict(spawn=res["spawn_s"], restore=res["restore_s"],
                           lane=wall))


def mesh_family_launches(e2e, name) -> dict:
    """A kernel's launches in run s by family (rank 0's)."""
    return {f: r["launches"].get(name, 0)
            for f, r in e2e["mesh s"]["families"].items()}


# the dry-run phase: the count of runs a-g's repro-100m (E2E_LAYERS
# layers, bf16, int8 per channel) at one decode step of N_SLOTS rows over a
# MAX_LEN cache on a (1, 1) mesh, held against the card; and the dry-run
# CLI at two full production cells (16 x 16 fake mesh), on a lane
DRYRUN_VARIANT = "axllm-int8"
DRYRUN_ARG_TOL = 0.01       # |counted - allocated| / counted argument bytes
DRYRUN_CELLS = ("zamba2-1.2b:long_500k", "qwen2-moe-a2.7b:decode_32k")


def dryrun_phase(dev, card, flush) -> dict:
    """The port's dry run (``launch.dryrun.count_cell``: one rank's
    program on meta tensors) of the decode step of runs a-g's model on a
    (1, 1) mesh, against the same step on the card: the counted argument
    bytes must equal the growth of ``torch.cuda.memory_allocated()`` when
    the same quantized parameters, cache and token are made on the card,
    within ``DRYRUN_ARG_TOL``; printed without a gate: the counted temp
    bytes beside the peak a real step adds (its second call, after the
    first made the kernels' plans and buffers), and the roofline bound of
    the counted FLOPs and bytes (H100 SXM peaks) beside the step's device
    time (CUDA events, L2 flushed) and its busy time (torch.profiler)."""
    import torch
    from repro_torch.core.axllm_linear import deploy_quantize
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import shapes as shp
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.model import get_model
    from repro_torch.roofline import analysis as ra
    cfg = e2e_config()
    spec = shp.ShapeSpec("chip_decode", MAX_LEN, N_SLOTS, "decode")
    t0 = time.perf_counter()
    rec = DR.count_cell(cfg, spec, Mesh(1, 1, 0, "meta"), DRYRUN_VARIANT,
                        DR.cell_rules(DRYRUN_VARIANT, spec))
    count_s = time.perf_counter() - t0
    api = get_model(cfg)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    params = deploy_quantize(api.init(seed=0, device=dev), DR._qcfg(cfg))
    cache = api.init_cache(N_SLOTS, MAX_LEN, dev)
    token = torch.zeros(N_SLOTS, dtype=torch.int32, device=dev)
    torch.cuda.synchronize(dev)
    held = torch.cuda.memory_allocated(dev) - base
    mem = rec["memory"]
    args = mem["argument_size_in_bytes"]
    rel = abs(held - args) / args

    def step():
        with torch.inference_mode():
            return api.decode(params, token, cache)

    step()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    step()
    torch.cuda.synchronize(dev)
    temp = torch.cuda.max_memory_allocated(dev) - before
    ms = time_ms(step, flush)
    _, busy, _ = device_busy_ms(step)
    cost = rec["cost_analysis"]
    terms = ra.roofline_terms(cost["flops"], cost["bytes accessed"],
                              rec["collective_bytes"], 1)
    bound_ms = terms["bound_step_s"] * 1e3
    print(f"dryrun [{card}] {cfg.name} {cfg.n_layers} layers, decode B"
          f"{N_SLOTS} S{MAX_LEN}, (1, 1) mesh, {DRYRUN_VARIANT}: counted on "
          f"the meta device in {count_s:.2f} s; argument bytes counted "
          f"{args} against {held} allocated on the card (rel {rel:.2e}, tol "
          f"{DRYRUN_ARG_TOL}); temp bytes counted {mem['temp_size_in_bytes']}"
          f" (the plain versions' intermediates) against {temp} a real step "
          f"adds at its peak; roofline bound {bound_ms:.4f} ms "
          f"({terms['dominant']}: {cost['flops']:.4e} FLOPs, "
          f"{cost['bytes accessed']:.4e} bytes counted) against the step's "
          f"{ms:.4f} ms device time (events) and {busy:.4f} ms busy",
          flush=True)
    check(rel <= DRYRUN_ARG_TOL, f"dry run: counted argument bytes {args} "
          f"against {held} allocated")
    del params, cache
    torch.cuda.empty_cache()
    return dict(config=cfg.name, layers=cfg.n_layers, count_s=count_s,
                argument_bytes=args, allocated_bytes=held, rel_err=rel,
                temp_bytes=mem["temp_size_in_bytes"], step_peak_bytes=temp,
                bound_ms=bound_ms, dominant=terms["dominant"], step_ms=ms,
                step_busy_ms=busy, flops=cost["flops"],
                bytes_accessed=cost["bytes accessed"])


def dryrun_submit(lane):
    """Queue ``python -m repro_torch.launch.dryrun --cells DRYRUN_CELLS``
    (the 16 x 16 production mesh, full configs) on ``lane``; returns its
    output directory."""
    import shutil
    out = ROOT / "build" / "dryrun_smoke"
    shutil.rmtree(out, ignore_errors=True)
    lane.submit("dryrun", [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--cells", ",".join(DRYRUN_CELLS),
                           "--out", str(out)])
    return out


def dryrun_check(card, lane, out) -> dict:
    """The dry-run CLI's run: exit 0 and every cell ``ok``; prints each
    record's figures (rank 0 of 256) and its roofline terms."""
    from repro_torch.launch import report
    from repro_torch.roofline import analysis as ra
    rc, stdout, stderr, wall = lane.result("dryrun")
    check(rc == 0, f"dry-run CLI exit {rc}: {stderr[-2000:]}")
    recs = report.load(out)
    got = {}
    for (cell, mesh, _), rec in sorted(recs.items()):
        check(rec["status"] == "ok", f"dry run {cell}: {rec.get('error')}")
        fl, by, co, inter, _ = report.global_totals(rec)
        t = ra.roofline_terms(fl, by, co, rec["chips"], inter_bytes=inter)
        mem = rec["memory"]
        print(f"dryrun cli [{card}] {cell} {mesh} rank {rec['rank']}: ok, "
              f"counted in {rec['count_s']} s; argument "
              f"{mem['argument_size_in_bytes']} B, temp "
              f"{mem['temp_size_in_bytes']} B, "
              f"{rec['cost_analysis']['flops']:.4e} FLOPs, collectives "
              f"{rec['collective_bytes']:.4e} B ("
              f"{rec['collective_inter_bytes']:.4e} across nodes); terms "
              f"compute {t['compute_s']:.3e} s, memory {t['memory_s']:.3e}"
              f" s, collective {t['collective_s']:.3e} s ({t['dominant']})",
              flush=True)
        got[cell] = dict(status=rec["status"], count_s=rec["count_s"],
                         memory=mem, cost=rec["cost_analysis"],
                         collective_bytes=rec["collective_bytes"],
                         terms=t)
    check(sorted(got) == sorted(DRYRUN_CELLS),
          f"dry-run CLI records {sorted(got)}")
    print(f"dryrun cli [{card}]: {len(got)} cells in {wall:.1f} s on a "
          "lane", flush=True)
    return dict(cells=got, wall_s=wall)


PREFILL_SHAPE = "M4096 K768 N2048 8b-affine-per_channel"
CODEBOOK_SHAPE = "M4096 K768 N2048 4b-codebook-per_channel"

# kernel -> (the TPU kernel it replaces, the main shape reported, the
# end-to-end run whose launch count is reported)
KERNELS = {
    "axllm_matmul": ("src/repro/kernels/axllm_matmul.py:104",
                     "M8 K768 N2048 8b-affine-per_channel", "dense"),
    "decode_attention": ("src/repro/kernels/decode_attention.py:71",
                         "B8 S1024 H12 Hk4 d64 bf16-kv", "dense"),
    "flash_attention": ("src/repro/kernels/flash_attention.py:81",
                        "B8 Sq512 Sk512 H12 Hk4 d64 causal", "dense"),
    "reuse_matmul": ("src/repro/kernels/reuse_matmul.py:115",
                     "M8 K768 N2048 8b-affine-per_channel", "reuse+paged"),
    "paged_decode_attention": (
        "src/repro/kernels/paged_decode_attention.py:81",
        "B8 H12 Hk4 d64 bs16 MB64 bf16-kv", "reuse+paged"),
    "quantize": ("src/repro/kernels/quantize.py:33", "K768 N2048 bfloat16 8b",
                 "deploy"),
}
# the path of each kernel's main row: the one its serving path takes
MAIN_PATH = {"flash_attention": "wgmma", "axllm_matmul": "gemv",
             "reuse_matmul": "gemv"}
ROW_KEYS = ("max_abs_err", "tolerance", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
SPEC_RUNS = ("spec dense", "spec reuse+paged")     # runs f and g


def main() -> int:
    # run m trains under deterministic algorithms, whose cuBLAS asks for
    # this workspace setting before CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    start = time.perf_counter()

    def stamp(what):
        print(f"[{time.perf_counter() - start:.1f} s] {what} done",
              flush=True)

    card = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    t0 = time.perf_counter()
    strip_build = start_strip_build()
    logs = _build.build()
    strip = strip_kernel(strip_build)
    print(f"built {len(_build.LIBRARIES)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s ({len(logs)} compiled)",
          flush=True)
    hgmma = {lib: sass_hgmma(lib) for lib in ("axllm_matmul", "reuse_matmul",
                                              "flash_attention")}
    for lib, count in hgmma.items():
        print(f"sass {lib}: {count} HGMMA instructions", flush=True)
        check(count > 0, f"{lib} has no tensor-core (HGMMA) instruction")
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_nvcc.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = kernel_phase(dev, flush) + reuse_paged_kernel_phase(dev, flush)
    rows += codebook_kernel_phase(dev, flush)
    sweep = tensor_core_phase(dev, flush)
    q_rows, deploy = quantize_kernel_phase(dev, flush, strip)
    rows += q_rows
    stamp("kernel phases")
    rows += family_kernel_phase(dev, flush)
    rows += recurrent_kernel_phase(dev, flush)
    rows += zero_row_phase(dev, flush)
    rows += audio_kernel_phase(dev, flush)
    stamp("the families' kernel phases, the zero-row check and run l's "
          "kernel rows")
    rows += flash_bwd_phase(dev, flush)
    stamp("the flash backward kernel phase")
    rows += mesh_kernel_phase(dev, flush)
    rows += mesh_train_kernel_phase(dev, flush)
    rows += mesh_family_kernel_phase(dev, flush)
    stamp("the mesh runs' kernel rows")
    dryrun = dryrun_phase(dev, card, flush)
    stamp("the dry-run phase")
    small_input_check(dev)
    dense, dense_tokens = end_to_end(dev, card)
    stamp("run a")
    reuse_paged, reuse_paged_tokens, reuse_paged_eng = \
        end_to_end_reuse_paged(dev, card)
    stamp("run b")
    e2e = {"dense": dense, "reuse+paged": reuse_paged, "deploy": deploy}
    for run, (name, fn) in {"c": ("lora+reuse+fused", end_to_end_lora),
                            "d": ("nf4+reuse", end_to_end_nf4),
                            "e": ("overload+chunked", end_to_end_overload)
                            }.items():
        e2e[name] = fn(dev, card)
        stamp(f"run {run}")
    e2e["spec dense"] = end_to_end_spec_dense(dev, card, dense_tokens)
    stamp("run f")
    e2e["spec reuse+paged"] = end_to_end_spec_paged(dev, card,
                                                    reuse_paged_tokens)
    stamp("run g")
    simulator = simulator_phase(reuse_paged_eng, card)
    del reuse_paged_eng
    chaos = chaos_phase(dev, card)
    stamp("simulator and chaos phases")
    for family in FAMILY_RUNS:                  # runs h, i, j and k
        e2e[family] = end_to_end_family(dev, card, family)
        stamp(f"run {family}")
    e2e["audio"] = end_to_end_audio(dev, card)   # run l
    stamp("run audio")
    # the launchers' subprocesses run on two lanes beside the in-process
    # launcher runs and runs n to p, which time nothing but the host's
    # gloo, and run r's on a third and after run m's launchers; run o's
    # ranks spawn beside run n's; run s (its moe ranks take most of the
    # card) runs alone once run r's lanes have drained; run q (its module
    # phase timed) starts after it, and run m, timed, after that
    lanes = [CliLane(), CliLane(), CliLane()]
    try:
        launcher = launcher_phase(dev, card, lanes[0])
        train_ckpt = train_launcher_submit(lanes[1])
        mesh_train_submit(lanes)                    # run r, after those
        dryrun_out = dryrun_submit(lanes[1])        # the dry-run CLI
        stamp("launcher phase in process")
        host = {run: label for label, run in LAUNCH_MESH_RUN.items()}

        def spawn(run):     # with the launcher's mode of the same mesh
            return start_mesh(run, launch_flags(
                launcher["ckpt"], LAUNCH_RUNS[host[run]])
                if run in host else None)

        spawned = {run: spawn(run) for run in ("n", "o")}
        for run, refs in (("n", {"a": dense_tokens, "b": reuse_paged_tokens}),
                          ("o", {})):
            e2e[f"mesh {run}"] = end_to_end_mesh(dev, card, run, refs,
                                                 spawned[run])
            stamp(f"run {run}")
        e2e["mesh p"] = end_to_end_mesh(dev, card, "p", {})
        stamp("run p")
        e2e["train launcher"] = train_launcher_phase(card, lanes[1],
                                                     train_ckpt)
        for label in LAUNCH_RUNS:
            lanes[0].result(("launcher", label))
        stamp("the launchers' subprocesses")
        e2e["mesh r"] = end_to_end_mesh_train(dev, card, lanes)
        stamp("run r and the dist modules")
        mesh_family_submit(lanes[2])                # run s, alone
        e2e["mesh s"] = end_to_end_mesh_family(card, lanes[2])
        stamp("run s")
        dryrun["cli"] = dryrun_check(card, lanes[1], dryrun_out)
        stamp("the dry-run CLI")
        # full depth: runs a and b's tokens are another model's
        e2e["mesh q"] = end_to_end_mesh(
            dev, card, "q", {"b hits": reuse_paged["prefix_hit_tokens"]},
            spawn("q"))
        stamp("run q")
        for label, run in LAUNCH_MESH_RUN.items():
            launcher_mesh_in_process(card, label, launcher,
                                     e2e[f"mesh {run}"].pop("launcher"))
        e2e["launcher"] = launcher_check(card, lanes[0], launcher)
    finally:
        for lane in lanes:
            lane.stop()
    e2e["train"] = end_to_end_train(dev, card)              # run m
    stamp("run train")

    kernels = []
    for name, (replaces, main_shape, run) in KERNELS.items():
        row = next(r for r in rows
                   if r["kernel"] == name and r["shape"] == main_shape
                   and r["path"] == MAIN_PATH.get(name, r["path"]))
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
            replaces=replaces, launches=e2e[run]["launches"][name],
            **{key: row[key] for key in ROW_KEYS},
            shape=main_shape, launches_from=run,
            # the speculative runs f and g that serve it, and its launches
            launches_spec={r: e2e[r]["launches"][name] for r in SPEC_RUNS
                           if e2e[r]["launches"].get(name)},
            # runs h (moe), i (vlm), j (ssm), k (hybrid) and l (audio)
            launches_families={r: e2e[r]["launches"].get(name, 0)
                               for r in (*FAMILY_RUNS, "audio")},
            # the launcher phase's in-process serve.main, one per mode
            # (the mesh run's rank 0)
            launches_launcher={r: v["launches"].get(name, 0)
                               for r, v in e2e["launcher"].items()
                               if r in LAUNCH_RUNS},
            # runs n to q by mode, rank 0's (every rank's in the details)
            launches_mesh={f"mesh {r}": {
                mode: e2e[f"mesh {r}"][mode]["launches"].get(name, 0)
                for mode in MESH_MODES[r]} for r in MESH_RUNS},
            # run m's in-process launch.train.main
            launches_train=e2e["train"]["launches"].get(name, 0),
            # run r's 2x2 training (rank 0's, every rank's in the details)
            launches_mesh_train=e2e["mesh r"]["launches"].get(name, 0),
            # run s's 2x2 training of the other families (rank 0's)
            launches_mesh_family_train=mesh_family_launches(e2e, name)))
        if name in ("axllm_matmul", "reuse_matmul"):
            # the ring matmuls by form, model size, batch and impl (rank 0's)
            kernels[-1]["launches_rings"] = {
                k: launches[name] for k, launches in
                e2e["mesh r"]["modules"]["launches"].items()
                if name in launches}
        if name in ("axllm_matmul", "reuse_matmul"):
            # the main row is the decode kernel; beside it the tile kernel
            # at the same shape (for axllm_matmul the path the row took
            # before it; reuse_matmul's took a split-K table kernel that
            # the decode kernel replaced: chip_ab.py times it)
            kernels[-1].update(
                path="gemv", skeleton="src/repro_torch/csrc/quant_gemv.cuh",
                gemv_launches=e2e[run]["launches"][f"{name}.gemv"],
                tile_ms=row["tile_ms"], emulation_err=row["emulation_err"],
                blocks=row["blocks"])
            if name == "axllm_matmul":   # its tile kernel is the old path
                kernels[-1]["was"] = dict(path="simt", ms=row["tile_ms"])
            # the prefill path: the library's tensor-core entry point
            tc = next(r for r in rows if r["kernel"] == name
                      and r["shape"] == PREFILL_SHAPE)
            kernels[-1]["tensor_core"] = dict(
                source="src/repro_torch/csrc/quant_gemm_sm90.cuh",
                shape=PREFILL_SHAPE, hgmma_instructions=hgmma[name],
                launches=e2e[run]["launches"][f"{name}.wgmma"],
                **{key: tc[key] for key in ROW_KEYS})
            # its codebook route (NF4); run d serves it through reuse_matmul,
            # and no run serves axllm_matmul on a codebook: no count is read
            # for it
            cb = next(r for r in rows if r["kernel"] == name
                      and r["shape"] == CODEBOOK_SHAPE)
            served = name == "reuse_matmul"
            kernels[-1]["codebook"] = dict(
                source="src/repro_torch/csrc/quant_gemm_sm90.cuh",
                shape=CODEBOOK_SHAPE, path=cb["path"],
                launches=(e2e["nf4+reuse"]["launches"][f"{name}.wgmma"]
                          if served else None),
                launches_from="nf4+reuse" if served else None,
                emulation_err=cb["emulation_err"],
                was=dict(path="tile", ms=cb["tile_ms"]),
                **{key: cb[key] for key in ROW_KEYS})
        if name == "flash_attention":
            # the main row is the tensor-core kernel; the SIMT one beside it
            simt = next(r for r in rows if r["kernel"] == name
                        and r["shape"] == main_shape and r["path"] == "simt")
            kernels[-1].update(
                path="wgmma", hgmma_instructions=hgmma[name],
                wgmma_launches=e2e[run]["launches"][f"{name}.wgmma"],
                simt={key: simt[key] for key in ROW_KEYS})
        if name == "quantize":
            # the cluster kernel; beside it the strip kernel it replaced
            # and the deploy pass (its path)
            dep = e2e["deploy"]
            kernels[-1].update(
                path="cluster", plan=row["plan"],
                launch_floor_ms=row["launch_floor_ms"],
                was=dict(path="strip", ms=row["was_ms"]),
                deploy_pass={key: dep[key] for key in (
                    "matrices", "ms", "plain_ms", "bound_ms", "was_ms")})
    # the backward of flash attention: no TPU counterpart (the Pallas
    # kernel it differentiates has no VJP); its main row is run m's layer
    bwd = next(r for r in rows if r["kernel"] == "flash_attention_bwd"
               and r["shape"] == BWD_MAIN)
    kernels.append(dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:81",
        counterpart="none: the backward of flash_attention_pallas, which "
                    "has no VJP",
        launches=e2e["train"]["launches"]["flash_attention_bwd"],
        **{key: bwd[key] for key in ROW_KEYS}, shape=BWD_MAIN,
        launches_from="train", path="simt",
        launches_train=e2e["train"]["launches"]["flash_attention_bwd"],
        launches_mesh_train=e2e["mesh r"]["launches"].get(
            "flash_attention_bwd", 0),
        launches_mesh_family_train=mesh_family_launches(
            e2e, "flash_attention_bwd")))
    (OUT / "chip_smoke.json").write_text(json.dumps(
        dict(card=smi, kernels=kernels, cases=rows, tensor_core_sweep=sweep,
             e2e=e2e, simulator=simulator, chaos=chaos, dryrun=dryrun),
        indent=1,
        default=str))
    print(json.dumps({"kernels": kernels}), flush=True)
    # the run used one card, whatever else the machine shows
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
