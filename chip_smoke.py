#!/usr/bin/env python3
"""Drive the PyTorch port's BERT-base serving and training paths, its
ResNet-50 training path and its generative serving, plain and speculative,
with the KV hand-off between engines, the serving monitor and
multi-replica serving under injected faults, on one CUDA card.

    python3 chip_smoke.py [--out PATH] [--seed N]

Run from the root of a checkout. It imports ``paddle_tpu_torch`` (never
``jax`` or ``paddle_tpu``) and fails, printing no result, where there is
no CUDA card or no port beside it. Phases, each printed as JSON lines:

1. device: the card's name and power limit; every kernel of the path is
   built from ``paddle_tpu_torch/csrc`` (one ``nvcc`` per source, all at
   once) and ``-Xptxas -v``'s registers, shared memory and spills shown,
   with each kernel instance's count of tensor-core (HMMA) instructions
   from ``cuobjdump -sass``: the flash forward, dQ and dK/dV kernels, bf16
   and float32 (split TF32), on the tensor cores must have some, and no
   spill at head dim 64; the layer-norm instances that run D = 768 with
   16-byte accesses (forward f32, bf16 and bf16 with an f32 weight;
   backward f32 and bf16 with an f32 weight) must spill nothing and load
   x by 128-bit global loads (``LDG.E.128``, counted per instance).
2. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, at the shapes the serving path gives it (layer norm also at the
   training step's (8192, 768), and at rows the 16-byte instances do not
   take, D = 770 and a view one element into its buffer, and at rows
   wider than a warp holds, D = 9000 and 16384; flash attention also
   causal at S = 512, a full bias, S = 200, 77 queries over 200 keys, and
   head dim 128 causal with dropout, in bf16; head dims 16 and 96, which
   run zero-padded, in float32 and bf16; float16 through the float32
   kernels; and (B, 1, S, 1) bool and additive masks, which the
   reference hands to sdpa, under causal), with the tolerance
   stated; CUDA-event times of the kernel, the plain version and one
   PyTorch library call computing the same function (a yardstick the port
   never calls), replayed from a CUDA graph so that they are the card's
   time alone, beside the least time the card could take (bytes over
   3.35 TB/s or operations over the peak rate of the inputs' type; the
   float32 forward's three TF32 products a term over the TF32 rate), and
   the eager time per call of the kernel's wrapper and the library call,
   host side included.
3. serving f32: BERT-base at full width (12 layers, 768 wide, 12 heads,
   vocab 30522) with seeded weights behind
   ``ServingEngine(Predictor(model), buckets=[8, 32], max_batch=32,
   timeout_ms=2)``; 40 requests of 1, 3, 7 or 13 rows at seq 128 from 4
   closed-loop client threads, then 4 at seq 512, with padding masks of
   real lengths 16..S. Every future must resolve to finite outputs of the
   right shape, 3 requests must match the same model run on the CPU, and
   the launch counters, zeroed just before the traffic, must show 25
   layer-norm and 12 flash-attention launches per executed batch.
4. serving bf16: the same requests through ``Config().enable_bf16()``,
   held against the f32 card outputs.
5. training kernels: the layer-norm backward kernel (also at phase 2's
   other layer-norm rows), the flash forward
   kernel with in-kernel dropout (and its kept fraction), and the flash
   dQ and dK/dV kernels, each against its plain version on the card at
   the training path's shapes, in bf16 and float32 (and causal, unaligned
   and head-dim-128 cases, and in bf16 the causal, full-bias, S = 200,
   77-over-200 and head-dim-128 causal dropout cases of phase 2, in
   float32 head dim 128 causal, dropout and a full bias, and phase 2's
   padded head dims, float16 and sdpa masks under causal), timed as in
   phase 2 (dK/dV alone, from the delta a dQ launch wrote, on the
   operands the wrapper hands it);
   the library yardsticks are
   ``aten.native_layer_norm_backward`` and the backward of
   ``scaled_dot_product_attention``.
6. loss and optimizer kernels: ``softmax_xent`` forward and backward at
   the masked-LM logits (8192, 30522) in f32 with ``bench_bert``'s labels
   and in bf16, with smoothing 0.1 at (4096, 30522), at the NSP logits
   (64, 2), and at V = 2500 with out-of-range labels; ``fused_adam`` at
   (30522, 768) f32 and a bf16 (1000, 77); ``fused_adam_multi`` over
   ``BertForPretraining``'s 157 trained shapes; ``fused_adam_flat`` at
   their arena length, which must give the many-tensor kernel's bits. Each
   against its plain version, timed as in phase 2; the library yardsticks
   are ``F.cross_entropy(ignore_index=-1, reduction="none")`` (forward,
   and forward+backward minus forward), ``torch._fused_adam_`` and
   ``torch._fused_adamw_`` over the same tensors (the same function up to
   rounding: torch divides ``sqrt(v)`` by ``sqrt(1 - b2^t)`` and decays
   first).
7. training: ``tools/bench_bert``'s step at full width and depth
   (BERT-base pretraining, batch 64, seq 128, amp bf16, AdamW 1e-4,
   dropouts 0.1), first on its default route, then on the fused route
   (``kernels.configure(softmax_xent=True, fused_adam_multi=True)``),
   each from a fresh ``Trainer``: 8 warm-up steps, then 16 steps with the
   launch counters zeroed just before and read just after (26 layer-norm
   forward and backward, 12 flash forward, dQ and dK/dV launches a step;
   on the fused route also 2 ``softmax_xent`` forward and backward, for
   the masked-LM and NSP losses, and 1 ``fused_adam_multi`` for the 157
   tensors with a gradient; on the default route none of these), every
   loss finite, step time and tokens/s; then 11 steps on one batch, whose
   loss must fall. ``Trainer.step`` is ``jit.to_static``'s CUDA graph: the
   first call runs eagerly and captures, the counted calls replay (a
   replay adds the launches its capture recorded); phase 11 likewise.
8. optimizer routes: one BERT-base f32 backward with token types (so that
   all 158 parameters get a gradient) steps four copies of the same
   weights 3 times, by the plain per-parameter AdamW, ``use_fused=True``
   (158 ``fused_adam`` launches a step), ``use_multi_tensor=True`` (1
   ``fused_adam_multi``) and ``flat_arena=True`` under
   ``configure(fused_adam_multi=True)`` (1 ``fused_adam_flat``). The
   multi-tensor and arena copies must agree to the bit, each fused route
   with the plain one within 2 lr a step per element and 1e-2 relative L2
   over the update; then one arena step on ``bench_bert``'s data, without
   token types, must launch ``fused_adam_flat`` no time (its mask route).
9. f32 step check: one BERT-base pretraining step in float32 (TF32 off,
   dropout 0, batch 4, seq 128) on the card and on the CPU from the same
   weights: the loss, every gradient and every parameter after AdamW; the
   counters, zeroed just before the card's step, must show the path's
   launches (12 of each float32 flash kernel).
10. batch-norm kernels: ``batch_norm_stats``, ``batch_norm_normalize``,
   ``batch_norm_bwd_reduce`` and ``batch_norm_bwd_dx`` against their plain
   versions at the five shapes ResNet-50 gives them at batch 128 (rows by
   channels (1605632, 64) to (6272, 2048), bf16), at (100352, 256) in
   f32, and at (10007, 100) in bf16, where no 16-byte load applies and
   the last row chunk is ragged; the two reductions must give the same
   bits twice; timed as in phase 2. The library yardstick is
   ``torch.nn.functional.batch_norm(training=True)`` on the same
   channels-last data: its forward beside stats + normalize, its backward
   (forward+backward minus forward) beside reduce + dx.
11. ResNet-50 training: ``tools/bench_resnet``'s step at full width and
   depth (batch 128, 224x224 uint8 images normalised on the card, amp
   bf16, Momentum(0.1, 0.9)) on three routes, each from a fresh
   ``Trainer``: NCHW and NHWC with the plain batch norm (no launch of any
   kernel), then NHWC under ``kernels.configure(batch_norm=True)`` (53
   launches of each of the four batch-norm kernels a step, counted over 8
   steps with the counters zeroed just before and read just after); every
   loss finite, step time, images/s and peak memory; then 10 steps on one
   batch, whose loss must fall.
12. ResNet f32 step check: one float32 training step of ResNet-50 (TF32
   off, batch 8, 224x224, NHWC, batch-norm kernels on) on the card and on
   the CPU from the same weights: the loss, every gradient, and every
   parameter and running statistic after the Momentum step.
13. generative serving: kernel #3 in float32, causal, at the prefill's
   shapes (1, 4, S, 64) for S = 1, 4, 16, 128, 256 and 512, and (1, 2, 16, 8)
   zero-padded, against its plain version and timed as in phase 2; then
   ``tools/decode_loadgen``'s traffic (96 requests from its seed) through
   ``GenerateEngine(demo_model(vocab=64, dim=256, heads=4, layers=2,
   seed=1), slots=8, page=32, max_len=96, prompt_buckets=(4, 16))`` with
   ``refill="continuous"`` and ``"drain"``, greedy and sampled
   (temperature 1, top-k 20, top-p 0.9, seed 1000 + i): every request
   complete with its token count, no signature met after ``warmup()``,
   the flash kernel launched once a layer a prefill and nothing else, and
   each discipline's streams equal to the other's; the first 8 requests
   again on the CPU with the same weights, the card's logits along the
   CPU's greedy streams within 1e-4 scaled at every position and the
   tokens equal wherever the CPU's top-2 margin exceeds that; 16 prompts
   of 200-448 tokens through an engine at max_len 512 (prefill at 256 and
   512, the arena grown to 512), one prompt of each bucket again on the
   CPU and held to it as above, with one prefill's device time; and 10
   decode ticks on the host clock, then 10 under ``torch.profiler``,
   greedy and sampled: wall time a tick against the card's busy time.
   Every engine of phases 13-16 runs its steps through the CUDA graphs
   its warmup captured (phase 18), the flash kernel's launches counted
   through the replays.
14. speculative decoding: kernel #3 in float32, causal, at the pair's
   prefill shapes (1, 2, 4, 96) and (1, 2, 16, 96), zero-padded to 128,
   against its plain version and timed as in phase 2; then
   ``tools/decode_loadgen --spec``'s A/B on phase 13's traffic and engine:
   ``demo_spec_pair(vocab=64, dim=192, heads=2, draft_layers=1,
   extra_layers=7, seed=1, distill=0.10)``'s target, plain and with its
   draft at k = 8, sampled at temperature 1 (seed 1000 + i), then greedy:
   every request complete with its token count (and 8 more at prompt +
   new = 96), no signature met after ``warmup()``, the flash kernel
   launched 9 times a prefill (8 target layers, 1 draft layer) and never
   in a tick; tokens/s, the speedup, accept rate and tokens a verify.
   Greedy speculative streams against greedy plain, and a model drafting
   for itself (``demo_model(vocab=64, dim=192, heads=2, layers=2,
   seed=1)``) against plain sampling, every departure counted and each a
   near-tie of the card's teacher-forced logits; the first 8 requests'
   greedy speculative streams again on the CPU with the same weights,
   the card's ``verify_fn`` logits along them within 1e-4 scaled and the
   tokens equal beyond that margin; a speculative tick and a plain tick
   of the 8-layer target on the host clock and under ``torch.profiler``,
   and the target's and the draft's prefill at 16 tokens (device time
   from a CUDA graph, and eager).
15. the KV hand-off and the monitor: phase 13's traffic (greedy, then
   sampled) into a ``GenerateEngine`` on phase 13's model and engine
   settings, 40 ticks, then every request to a second, warmed engine
   built with ``kv_import=True`` (live lanes by
   ``disown_inflight(export_kv=True)``, queued ones by ``steal_pending``;
   half through ``requeue``, half through ``submit_request(admit=False)``),
   with the launch counts zeroed just before each engine's traffic and
   read just after: every request complete with its token count, the
   second engine meeting no signature after ``warmup()``, its
   ``kv_imports`` equal to the exported lanes, its flash launches one a
   layer a bare request's prefill and none for an imported lane, each
   segment's bytes ``bytes_per_token x pad``, and every stream equal to
   the unmoved run's on the card (each departure counted and a near-tie
   of the teacher-forced logits); then the speculative pair of phase 14
   at k = 8, greedy, after 3 ticks, the second engine carrying the draft;
   each lane's export and import time (mean, max) and the bytes moved.
   Then the port's monitor: phase 13's sampled traffic with the monitor
   and tracer off, on with its JSONL sink and on in memory, in turns
   (tokens/s each way, and the records' own host time), one record a
   request, the decode counters equal to the engine's, TTFT and TPOT
   p50/p99 and ``serving.decode.prefill_ratio``; a sampled tick's
   launches with the monitor off and on (equal); phase 14's sampled A/B
   with the monitor on, the speculative arm's summed prefill time against
   its summed tick time; the Chrome trace written under
   ``paddle_tpu_torch/_build/monitor/`` and read back, the engine's slot
   lanes in it.
16. multi-replica serving: ``MultiDeviceEngine`` over two copies of
   phase 3's BERT-base on the one card (``buckets=[8, 32], max_batch=32,
   timeout_ms=2``) takes phase 3's 44 requests while replica 0 fails its
   first three batch attempts (``replica_error``, inside a four-attempt
   retry policy): its breaker opens and no later request reaches it,
   every future resolves to the single engine's phase 3 outputs within
   1e-4, and the counters, zeroed just before, show 25 layer-norm and 12
   flash launches per executed batch over both replicas; the supervisor's
   half-open probe then readmits replica 0 on the card, and a rolling
   ``swap_weights`` to a second seed's weights runs under a client's
   traffic with no request failing, after which 8 requests equal a single
   engine's over those weights; each replica captures its warm signatures
   over the new module before it binds it (``Predictor.prepare``), and no
   call under the traffic captures or meets a new signature. Then ``MultiDecodeEngine`` over 1, 2 and
   3 copies of phase 13's model on the card (phase 13's engine settings)
   takes phase 13's 96 sampled requests (tokens/s each, through the
   loadgen's ``run_fleet``); again over 3 under the supervisor, where
   replica 1 hangs (``replica_hang``, 5 s) in a tick with lanes seated and
   requests queued: the verdict trips its breaker and moves both, then a
   ``preempt_replica`` notice drains replica 2, held between ticks with
   lanes seated and requests queued until the drain is decided
   (``held_ticker``), and moves its work; again
   over 3 with every engine on its own thread and the hang left where it
   falls, counting the requests a hung prefill strands (they finish on
   the hung replica once the hang ends); then phase 14's pair at k = 8,
   greedy, over 2 replicas with a hang that moves lanes seated and
   requests queued. Every request completes with its token count, no engine
   meets a signature after ``warmup()``, the flash kernel launches once a
   layer a prefill (re-prefills of moved requests included) and never in
   a tick, and every stream equals phase 13's single-engine stream
   (phase 14's plain greedy one for the pair), each departure counted and
   a near-tie of the teacher-forced logits; the failover time (verdict to
   the last moved request done), the supervisor's decisions, each
   breaker's state and the hedges against ``hedge_budget``.
17. CUDA graphs (``jit.to_static``'s step and the ``Predictor``'s
   executables): ``tools/bench_bert``'s BERT-base step at batch 64, seq
   128, amp bf16, dropout 0, 2 steps a call, on the default route and on
   the kernel route (the fused loss, ``AdamW(flat_arena=True)``, token
   types), and ``tools/bench_resnet``'s ResNet-50 step (batch 128, NHWC,
   the batch-norm kernels, 2 steps a call): one trainer steps eagerly,
   one through its graph, from the same weights and state, beside a
   second eager one (the control): the losses within ``GRAPH_LOSS_TOL``
   and every BERT parameter within Adam's 2 lr a step (ResNet's update
   within ``GRAPH_UPDATE_TOL``, relative L2), bit equality reported for
   both pairs; the graph must have replayed, and its calls must count the
   eager calls' launches; then each arm's step time and tokens/s (images/s)
   in turns (eager, graph, graph, eager), and one call of each profiled:
   wall against device time, the idle share, device events and the port's
   launches; the graph pool's reserved bytes. At dropout 0.1 two replays
   of a captured draw give other seed words and masks, each replay's
   flash output the plain version's at its own words, and a BERT-base
   forward in train mode with attention dropout alone differs between
   two replays (and not in eval mode). BERT-base ``Predictor`` in f32 and
   bf16 at batch 32, seq 128: the replay against the module's eager
   forward within ``KERNEL_TOL``, 37 port launches a replay, replay and
   eager forward times; phases 3 and 4 (qps, latency) and 16 (the swap's
   captures) serve through the same graphs.
18. the decode engine's steps as CUDA graphs. Phases 13-16 already run
   every ``GenerateEngine`` through them: each decode step,
   draft-then-verify step and prefill is captured at ``warmup()``, one
   graph per signature and batch-wide branch, and every tick and
   admission replays one. Here phase 13's traffic (greedy and sampled,
   continuous and drain) and phase 14's sampled pair (plain, and drafted
   at k = 8) run in both arms in turns (graph, eager, eager, graph; the
   eager arm is ``decode_loadgen.EagerEngine``, the same step bodies run
   launch by launch): every request complete with its token count, no
   signature met and nothing captured after warmup, a graphed run's tick
   replays equal to its ticks and its prefill replays to its prefills,
   the flash kernel launched once a layer a prefill (through the
   replays' counts) and never in a tick, and the graphed streams equal
   to the eager ones, each departure counted and a near-tie of the
   card's teacher-forced logits; tokens/s, latency, warmup seconds and
   captures, the reserved bytes, the graph pool's bytes (its segments in
   the allocator's snapshot) and the arenas' bytes. Then the four
   ticks (greedy and sampled at 2 layers, plain and speculative at 8)
   profiled in both arms: wall against busy, idle share, launches; the
   decode fleet over 1, 2 and 3 replicas under the profiler (tokens/s,
   idle share); and a 2-replica decode fleet's weight swap: each replica
   captures its executables over the new module before binding it, and
   the traffic after it captures nothing and gives a single engine's
   streams on the new weights (departures near-ties).
19. the ``kernels`` line (all 14), the card's name and power limit, and
   the last line ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero. ``--out`` also
writes every record to a JSON file.
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# H100 SXM, dense (NVIDIA's data sheet): HBM bandwidth, and the peak rate
# for each input type: bf16 on the tensor cores, float32 on the CUDA cores,
# and TF32 on the tensor cores, where the float32 flash kernels run each
# product as three TF32 products (float32 accuracy).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "tfloat32": 495e12}
# kernel vs plain version, as |diff| / max(1, |plain|): float32 sums in
# another order; bf16 rounds the f32 result once, one step being 2^-8
# relative, so 2e-2 allows a few steps; float16 runs the float32 kernels
# and rounds once, one step being 2^-11 relative
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-3}
# the served f32 model on the card vs the same model on the CPU: 12
# layers of float32 matmuls in another summation order, and attention
# products in split TF32 (the gap measured on an H100 is about 2e-5)
SERVE_F32_TOL = 1e-4
# bf16 serving vs f32 serving, as a relative L2 error per output (the gap
# measured on an H100 is about 1.2e-2)
SERVE_BF16_REL_TOL = 3e-2
# the served traffic: requests at seq 128, then at seq 512
REQUESTS_128 = 40
REQUESTS_512 = 4
# BERT-base launches per executed batch: embeddings.norm plus attn_norm
# and ffn_norm in each of 12 layers; one attention in each layer
LAUNCHES_PER_BATCH = {"layer_norm_fwd": 25, "flash_attention_fwd": 12}
# BERT-base pretraining launches per step: 25 encoder/embedding layer
# norms and mlm_norm, forward and backward; one attention a layer
TRAIN_LAUNCHES_PER_STEP = {"layer_norm_fwd": 26, "layer_norm_bwd": 26,
                           "flash_attention_fwd": 12,
                           "flash_attention_bwd_dq": 12,
                           "flash_attention_bwd_dkv": 12}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_INNER = 64, 128, 8
TRAIN_TIMED_CALLS = 2        # x TRAIN_INNER steps, counted and timed
REPEAT_STEPS = 11            # steps on one batch; the loss must fall
# the attention-dropout rate and the kept fraction's tolerance
DROPOUT_P, KEEP_TOL = 0.1, 0.005
# the f32 step, card vs CPU: the loss and each gradient relative to the
# gradient's largest element (12 layers of float32 products summed in
# another order); after AdamW's first step an element moves by about
# lr * sign(g), so where g is rounding noise the two may step opposite
# ways: every element within 2 lr, the whole update within 1e-2 relative
# L2
F32_LOSS_TOL = 1e-4
F32_GRAD_TOL = 1e-3
F32_UPDATE_TOL = 1e-2
# the fused route's launches a step: the default route's, plus the
# masked-LM and NSP losses' softmax_xent forward and backward, and one
# fused_adam_multi for the 157 tensors with a gradient (256 a launch)
FUSED_LAUNCHES_PER_STEP = dict(TRAIN_LAUNCHES_PER_STEP, softmax_xent_fwd=2,
                               softmax_xent_bwd=2, fused_adam_multi=1)
# the optimizer-route check: AdamW steps on one f32 backward's gradients
OPT_LR, OPT_STEPS = 1e-4, 3
# ResNet-50 at batch 128, 224x224: its 53 batch-norm layers, each through
# the four batch-norm kernels once a step on the kernel route
RESNET_BATCH, RESNET_SIZE, RESNET_INNER = 128, 224, 4
RESNET_TIMED_CALLS = 2       # x RESNET_INNER steps, counted and timed
RESNET_REPEAT_STEPS = 10
RESNET_BN_LAYERS = 53
BN_KERNELS = ("batch_norm_stats", "batch_norm_normalize",
              "batch_norm_bwd_reduce", "batch_norm_bwd_dx")
# (N, H, W, C) of the batch-norm inputs the path's five widths first meet
BN_PATH_SHAPES = ((128, 112, 112, 64), (128, 56, 56, 256),
                  (128, 28, 28, 512), (128, 14, 14, 1024),
                  (128, 7, 7, 2048))
BN_ITERS = 20                # launches per timed run of a batch-norm case
# the ResNet f32 step, card vs CPU. Of ResNet-50's tens of millions of
# ReLU inputs at batch 8 a few lie within float32 rounding of 0 and fall
# on the other side on the other device; each such flip moves the
# gradients upstream of it a little, so a gradient is held by its relative
# L2 error rather than element by element (the gap measured on an H100 is
# 2.0e-2 over all gradients, 2.2e-5 for the classifier's, which no flip
# reaches)
RESNET_F32_LOSS_TOL = 1e-4
RESNET_F32_GRAD_TOL = 5e-2
RESNET_F32_FC_GRAD_TOL = 1e-3     # the classifier's: downstream of them all
RESNET_F32_STAT_TOL = 1e-4      # running statistics: the forward alone
# flash cases of phases 2 and 5 beyond the path's widths and dtypes: head
# dims run zero-padded to 64 or 128, float16 through the float32 kernels,
# and (B, 1, S, 1) masks, which the reference hands to sdpa, under causal
FLASH_OTHER = (
    ("head_dim_16", "float32", 4, 12, 128, 16, "key", False),
    ("head_dim_16", "bfloat16", 4, 12, 128, 16, "key", False),
    ("head_dim_96", "float32", 4, 12, 128, 96, "key", False),
    ("head_dim_96", "bfloat16", 4, 12, 128, 96, "key", False),
    ("float16", "float16", 4, 12, 128, 64, "key", False),
    ("row_bool_causal", "float32", 4, 12, 128, 64, "row_bool", True),
    ("row_additive_causal", "float32", 4, 12, 128, 64, "row_additive",
     True),
    ("row_bool_causal", "bfloat16", 4, 12, 128, 64, "row_bool", True),
    ("row_additive_causal", "bfloat16", 4, 12, 128, 64, "row_additive",
     True))
# layer-norm rows beyond the path's width, (n, d, offset): D = 770 and a
# view one element into its buffer take the one-element-a-lane instances,
# D = 9000 and 16384 the block-per-row instances
LN_OTHER = ((8192, 770, 0), (8192, 768, 1), (512, 9000, 0), (512, 16384, 0))
TIMED_ITERS = 50             # launches per timed run (median of 5 runs)
XENT_ITERS = 20              # the same for the (8192, 30522) loss kernels
ADAM_ITERS = 10              # the same for the whole-model Adam cases
ROTATE_BYTES = 128 << 20     # inputs rotate over > 2x the 50 MB L2 cache
RECORDS = []


class CheckFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def emit(rec):
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# -- timing ------------------------------------------------------------------

def warm_card(torch, seconds=0.5):
    """Keep the card busy for a moment, so that the first timing does not
    run while its clocks rise from idle."""
    a = torch.randn(4096, 4096, device="cuda")
    b = torch.empty_like(a)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        torch.mm(a, a, out=b)
        torch.cuda.synchronize()


def _event_ms(torch, run, iters, repeats):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(repeats):
        start.record()
        run()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs)


def time_ms(torch, fn, arg_sets, iters, repeats=5):
    """ms per eager call by CUDA events, host side included: the median
    over ``repeats`` runs of the mean over ``iters`` calls, after ``iters``
    warm-up calls. Where the host takes longer to issue a call than the
    card takes to run it, this is the host's time. The calls rotate over
    ``arg_sets`` so each reads its inputs from device memory."""
    def run():
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    run()
    torch.cuda.synchronize()
    return _event_ms(torch, run, iters, repeats)


def graph_ms(torch, fn, arg_sets, iters, repeats=5):
    """ms per call of the device work alone: ``iters`` calls (rotating
    over ``arg_sets``) captured into one CUDA graph, whose replay issues
    them with no Python, allocation or launch cost between them; the
    median over ``repeats`` replays, after one warm-up replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm the allocator off-capture
        for args in arg_sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    ms = _event_ms(torch, graph.replay, iters, repeats)
    del graph
    torch.cuda.empty_cache()
    return ms


def timings(torch, kernel, plain, library, sets, iters):
    """The kernel's, its plain version's and the library call's device
    time per call (``ms``, ``plain_ms``, ``library_ms``, from a CUDA
    graph), and the kernel's and library call's eager time per call, host
    side included (``call_ms``, ``library_call_ms``)."""
    rec = dict(ms=graph_ms(torch, kernel, sets, iters),
               plain_ms=graph_ms(torch, plain, sets, iters),
               call_ms=time_ms(torch, kernel, sets, iters))
    if library is not None:
        rec.update(library_ms=graph_ms(torch, library, sets, iters),
                   library_call_ms=time_ms(torch, library, sets, iters))
    return rec


def n_sets(set_bytes):
    return max(1, min(16, math.ceil(ROTATE_BYTES / max(set_bytes, 1))))


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def scaled_err(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs() / b.abs().clamp_min(1.0)).max().item()


def abs_err(a, b):
    return (a.float() - b.float()).abs().max().item()


# -- phase 1: what the build made ---------------------------------------------

# the tensor-core kernels, by their template instance; those at head dim 64
# (the path's) must also show no spill
TENSOR_CORE_KERNELS = ("flash_fwd_tc<64>", "flash_fwd_tc<128>",
                       "flash_fwd_tf32<64>", "flash_fwd_tf32<128>",
                       "flash_bwd_dq_tc<64>", "flash_bwd_dq_tc<128>",
                       "flash_bwd_dkv_tc<64, false>",
                       "flash_bwd_dkv_tc<128, false>",
                       "flash_bwd_dkv_tc<64, true>",
                       "flash_bwd_dkv_tc<128, true>",
                       "flash_bwd_dq_tf32<64>", "flash_bwd_dq_tf32<128>",
                       "flash_bwd_dkv_tf32<64>", "flash_bwd_dkv_tf32<128>")
NO_SPILL_KERNELS = ("flash_fwd_tc<64>", "flash_fwd_tf32<64>",
                    "flash_bwd_dq_tc<64>", "flash_bwd_dkv_tc<64, false>",
                    "flash_bwd_dq_tf32<64>", "flash_bwd_dkv_tf32<64>")
# the layer-norm instances the path runs at D = 768 with 16-byte accesses
# (x's dtype, the weight's, elements an access, chunks a lane): no spill,
# and 128-bit global loads
LN_VECTOR_KERNELS = ("ln_fwd_warp<float, float, 4, 6>",
                     "ln_fwd_warp<bf16, bf16, 8, 3>",
                     "ln_fwd_warp<bf16, float, 8, 3>",
                     "ln_bwd_warp<float, float, 4, 6>",
                     "ln_bwd_warp<bf16, float, 8, 3>")


def demangle(names, tool_dir):
    """Short names ("flash_fwd_tc<64>") for mangled kernel names, by the
    toolkit's cu++filt (or c++filt); a name stays mangled where neither
    is found."""
    for tool in (tool_dir / "cu++filt", "c++filt"):
        try:
            out = subprocess.run([str(tool)], input="\n".join(names),
                                 capture_output=True, text=True, timeout=60,
                                 check=True).stdout.splitlines()
        except (OSError, subprocess.SubprocessError):
            continue
        if len(out) == len(names):
            short = [re.search(r"::(\w+(?:<[^>]*>)?)\(", d) for d in out]
            return {n: (re.sub(r"\(\w+\)", "", m.group(1))
                        .replace("__nv_bfloat16", "bf16") if m else d)
                    for n, m, d in zip(names, short, out)}
    return {n: n for n in names}


def build_report(kernels, logs):
    """Per kernel instance: registers and spill bytes from ``-Xptxas
    -v``, and its tensor-core (HMMA) instructions and 128-bit global loads
    (``ldg128``) in ``cuobjdump -sass`` of the built library (the
    toolkit's copy beside nvcc)."""
    tool_dir = Path(kernels._nvcc()).parent
    info = {}
    for log in logs.values():
        fn = None
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                fn = m.group(1)
                info[fn] = {}
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m and fn:
                info[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m and fn:
                info[fn]["registers"] = int(m.group(1))
    for source in logs:
        so = kernels._library_path(source)
        out = subprocess.run([str(tool_dir / "cuobjdump"), "-sass", str(so)],
                             capture_output=True, text=True, timeout=300,
                             check=True).stdout
        fn = None
        for ln in out.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                fn = m.group(1)
                info.setdefault(fn, {}).update(hmma=0, ldg128=0)
            elif fn and "HMMA" in ln:
                info[fn]["hmma"] += 1
            elif fn and re.search(r"LDG\.E[.\w]*\.128", ln):
                info[fn]["ldg128"] += 1
    names = demangle(sorted(info), tool_dir)
    report = {names[n]: v for n, v in info.items()}

    def entry(name):
        # "flash_fwd_tc<64>" is "...12flash_fwd_tcILi64EE..." mangled,
        # "flash_bwd_dkv_tc<64, true>" "...16flash_bwd_dkv_tcILi64ELb1EE..."
        base, args = name[:-1].split("<")
        code = "".join({"false": "Lb0E", "true": "Lb1E"}.get(a, f"Li{a}E")
                       for a in args.split(", "))
        hits = [v for k, v in info.items()
                if f"{len(base)}{base}I{code}E" in k]
        check(len(hits) == 1, f"{name}: {len(hits)} kernels of that name "
                              f"in the build")
        return hits[0]

    for name in TENSOR_CORE_KERNELS:
        check(entry(name).get("hmma", 0) > 0,
              f"{name}: no tensor-core (HMMA) instruction in the build")
    for name in NO_SPILL_KERNELS:
        check(entry(name).get("spill_bytes") == 0,
              f"{name}: ptxas reports {entry(name).get('spill_bytes')} "
              f"spill bytes")
    for name in LN_VECTOR_KERNELS:
        rec = report.get(name, {})
        check(rec.get("spill_bytes") == 0 and rec.get("ldg128", 0) > 0,
              f"{name}: want no spill and 128-bit global loads, the build "
              f"has {rec or 'no such instance'}")
    return report


# -- phase 2: kernels against their plain versions ----------------------------

def layer_norm_case(torch, LN, dtype, n, d, iters, gen, offset=0):
    """The forward kernel at (n, d), x a view ``offset`` elements into its
    buffer."""
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    eps = 1e-12
    set_bytes = n * d * es * 2
    sets = []
    for _ in range(n_sets(set_bytes)):
        x = offset_rows((torch.randn(n * d + offset, device="cuda",
                                     generator=gen) * 3 + 1).to(dt),
                        n, d, offset)
        w = (torch.rand(d, device="cuda", generator=gen) + 0.5).to(dt)
        b = torch.randn(d, device="cuda", generator=gen).to(dt)
        sets.append((x, w, b))
    x, w, b = sets[0]
    y, mu, rstd = LN.layer_norm_fwd(x, w, b, eps)
    torch.cuda.synchronize()
    y0, mu0, rstd0 = LN.layer_norm_fwd_plain(x, w, b, eps)
    err = max(scaled_err(y, y0), scaled_err(mu, mu0),
              scaled_err(rstd, rstd0))
    rec = dict(phase="kernel", name="layer_norm_fwd", dtype=dtype,
               shape=[n, d], offset=offset, eps=eps,
               max_abs_err=abs_err(y, y0),
               max_scaled_err=err, tol=KERNEL_TOL[dtype])
    check(err <= KERNEL_TOL[dtype],
          f"layer_norm_fwd {dtype} {n}x{d}+{offset}: error {err} > "
          f"tolerance")
    F = torch.nn.functional
    rec.update(timings(
        torch, lambda *a: LN.layer_norm_fwd(*a, eps),
        lambda *a: LN.layer_norm_fwd_plain(*a, eps),
        lambda x, w, b: F.layer_norm(x, (d,), w, b, eps), sets, iters))
    # x read and y written once, w and b read, mu and rstd written; about
    # 8 operations an element (mean, centre, square, sum, scale, affine)
    nbytes = 2 * n * d * es + 2 * d * es + 2 * n * 4
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 8 * n * d, dtype)
    rec["bytes"] = nbytes
    emit(rec)
    return rec


def offset_rows(flat, n, d, offset):
    """(n, d) rows of ``flat`` from element ``offset``: contiguous, but
    16-byte aligned only at offset 0."""
    return flat[offset:offset + n * d].view(n, d)


def causal_pairs(sq, sk):
    """(query, key) pairs with q_pos >= k_pos (top-left)."""
    return sum(min(i + 1, sk) for i in range(sq))


def flash_case(torch, FA, label, dtype, b, h, s, d, mask_kind, causal,
               iters, gen, sk=None, dropout_p=0.0, phase="kernel",
               card=None):
    """The forward kernel at (b, h, s, d) queries over ``sk`` keys (default
    s) against its plain version, with dropout at ``dropout_p`` from one
    seed (and then the kept fraction of its hash mask checked); ``card``,
    the card's name and power limit, goes into the record."""
    sk = sk or s
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    # the words as the kernels read them: a (2,) int32 tensor on the card,
    # through a pointer (a pair of ints would be copied from the host at
    # each call, which the CUDA graphs of the timings cannot capture)
    words = (20240601, -17)
    seed = FA.seed_words(words, "cuda")
    kw = dict(causal=causal, dropout_p=dropout_p, seed=seed)
    sets = [st[:4] for st in flash_sets(
        torch, dtype, b, h, s, d, mask_kind, gen,
        n_sets(2 * b * h * (s + sk) * d * es), sk=sk)]
    q, k, v, mask = sets[0]
    out, m, l = FA.flash_attention_fwd(q, k, v, mask, **kw)
    torch.cuda.synchronize()
    out0, m0, l0 = FA.flash_attention_fwd_plain(q, k, v, mask, **kw)
    err = max(scaled_err(out, out0), scaled_err(m, m0), scaled_err(l, l0))
    rec = dict(phase=phase, name="flash_attention_fwd", case=label,
               dtype=dtype, shape=[b, h, s, d], keys=sk, mask=mask_kind,
               causal=causal, dropout_p=dropout_p,
               max_abs_err=abs_err(out, out0), max_scaled_err=err,
               tol=KERNEL_TOL[dtype])
    if card is not None:
        rec["card"] = card
    check(err <= KERNEL_TOL[dtype],
          f"flash_attention_fwd {label}: error {err} > tolerance")
    check_masked_rows(label, mask_kind, out, v)
    if dropout_p > 0:
        keep = FA.dropout_keep_mask(seed, b * h, s, sk, dropout_p, "cuda")
        check(torch.equal(keep, FA.dropout_keep_mask(words, b * h, s, sk,
                                                     dropout_p, "cuda")),
              f"flash_attention_fwd {label}: the mask of the seed tensor is "
              f"not the mask of its int words")
        kept = keep.float().mean().item()
        rec["kept_fraction"] = kept
        check(abs(kept - (1 - dropout_p)) <= KEEP_TOL,
              f"flash_attention_fwd {label}: kept fraction {kept}, want "
              f"{1 - dropout_p} +- {KEEP_TOL}")
    F = torch.nn.functional

    def library(q, k, v, mask):
        if mask is not None and mask.dtype != torch.bool:
            mask = mask.to(q.dtype)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              is_causal=causal,
                                              dropout_p=dropout_p)

    # sdpa takes no mask beside is_causal: no yardstick for those cases
    rec.update(timings(
        torch, lambda *a: FA.flash_attention_fwd(*a, **kw),
        lambda *a: FA.flash_attention_fwd_plain(*a, **kw),
        None if causal and mask is not None else library, sets, iters))
    # q, k, v read and O written once, the mask read as given, m and l
    # written; two products of 2*D operations per (query, key) pair the
    # function needs (the lower triangle when causal). float32 runs them
    # on the tensor cores as three TF32 products each: its bound is theirs
    # at the TF32 rate, beside the CUDA cores' float32 rate for one
    pairs = causal_pairs(s, sk) if causal else s * sk
    ops = 4 * b * h * pairs * d
    nbytes = (2 * b * h * (s + sk) * d * es + 2 * b * h * s * 4 +
              (0 if mask is None else mask.numel() * mask.element_size()))
    if dtype == "bfloat16":
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, dtype)
    else:
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, 3 * ops,
                                                 "tfloat32")
        rec["bound_cuda_cores_ms"] = bound(nbytes, ops, "float32")[0]
    rec["bytes"] = nbytes
    emit(rec)
    return rec


def check_masked_rows(label, mask_kind, out, v):
    """A bool mask's row with no key gives 0; a row that a (B, 1, Sq, 1)
    mask masks everywhere (row 5 of batch 0) is sdpa's average of all the
    keys, also under causal."""
    if mask_kind == "bool":
        check(bool((out[0, :, 5] == 0).all()),
              f"flash {label}: a fully masked row must give 0")
    elif mask_kind in ("row_bool", "row_additive"):
        err = scaled_err(out[0, :, 5], v[0].float().mean(dim=1))
        check(err <= KERNEL_TOL[str(out.dtype).split(".")[-1]],
              f"flash {label}: a masked row must average the keys, error "
              f"{err}")


# -- phase 5: the training kernels against their plain versions --------------

def layer_norm_bwd_case(torch, LN, dtype, n, d, iters, gen, offset=0):
    """The backward kernel at (n, d), x and g in ``dtype`` and the weight
    f32, as on the training path; x and g views ``offset`` elements into
    their buffers."""
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    eps = 1e-12
    sets = []
    for _ in range(n_sets(3 * n * d * es)):
        x = offset_rows((torch.randn(n * d + offset, device="cuda",
                                     generator=gen) * 3 + 1).to(dt),
                        n, d, offset)
        w = torch.rand(d, device="cuda", generator=gen) + 0.5
        b = torch.randn(d, device="cuda", generator=gen)
        g = offset_rows(torch.randn(n * d + offset, device="cuda",
                                    generator=gen).to(dt), n, d, offset)
        _, mu, rstd = LN.layer_norm_fwd(x, w, b, eps)
        sets.append((x, w, mu, rstd, g, b))
    x, w, mu, rstd, g, b = sets[0]
    got = LN.layer_norm_bwd(x, w, mu, rstd, g)
    torch.cuda.synchronize()
    ref = LN.layer_norm_bwd_plain(x, w, mu, rstd, g)
    err = scaled_err(got[0], ref[0])
    # dw and db sum n rows: relative to their largest element
    for a, r in zip(got[1:], ref[1:]):
        err = max(err, abs_err(a, r) / max(1.0, r.abs().max().item()))
    rec = dict(phase="train_kernel", name="layer_norm_bwd", dtype=dtype,
               shape=[n, d], offset=offset,
               max_abs_err=max(abs_err(a, r) for a, r in zip(got, ref)),
               max_scaled_err=err, tol=KERNEL_TOL[dtype])
    check(err <= KERNEL_TOL[dtype],
          f"layer_norm_bwd {dtype} {n}x{d}+{offset}: error {err} > "
          f"tolerance")
    check(all(torch.equal(a, c) for a, c in
              zip(got, LN.layer_norm_bwd(x, w, mu, rstd, g))),
          "layer_norm_bwd: two runs differ (the reduction must be "
          "deterministic)")

    def library(x, w, mu, rstd, g, b):
        return torch.ops.aten.native_layer_norm_backward(
            g, x, [d], mu, rstd, w.to(x.dtype), b.to(x.dtype),
            [True, True, True])

    rec.update(timings(
        torch, lambda *a: LN.layer_norm_bwd(*a[:5]),
        lambda *a: LN.layer_norm_bwd_plain(*a[:5]), library, sets, iters))
    # x and g read, dx written once; w, mu, rstd read; dw, db written;
    # about 12 operations an element (xhat, g*w, two sums, dx, dw, db)
    nbytes = 3 * n * d * es + d * 4 + 2 * n * 4 + 2 * d * 4
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 12 * n * d, dtype)
    rec["bytes"] = nbytes
    emit(rec)
    return rec


def flash_sets(torch, dtype, b, h, s, d, mask_kind, gen, count, sk=None):
    """``count`` input sets (q, k, v, mask, dO): head-split views of a
    fused (B, S, 3, H, D) projection, as BERT gives the kernels (with
    ``sk`` keys other than s: q from a (B, S, H, D) projection, k and v
    from a fused (B, Sk, 2, H, D) one); a key padding mask of real lengths
    16..Sk, a full f32 bias, a bool mask with one query row that sees no
    key, or none; masks the reference hands to sdpa, (B, 1, S, 1) bool
    (``row_bool``) or additive (``row_additive``: 2 N(0, 1), and -1e9),
    with row 5 of batch 0 masked everywhere; and dO in the (B, S, H, D)
    memory order the model hands the backward."""
    dt = getattr(torch, dtype)
    sk = sk or s
    sets = []
    for _ in range(count):
        if sk == s:
            qkv = torch.randn(b, s, 3, h, d, device="cuda", generator=gen)
            q, k, v = qkv.to(dt).permute(2, 0, 3, 1, 4)
        else:
            q = torch.randn(b, s, h, d, device="cuda", generator=gen)
            q = q.to(dt).transpose(1, 2)
            kv = torch.randn(b, sk, 2, h, d, device="cuda", generator=gen)
            k, v = kv.to(dt).permute(2, 0, 3, 1, 4)
        mask = None
        if mask_kind == "key":
            lens = torch.randint(16, sk + 1, (b,), device="cuda",
                                 generator=gen)
            keep = torch.arange(sk, device="cuda")[None, :] < lens[:, None]
            mask = ((~keep).float() * -1e9)[:, None, None, :]
        elif mask_kind == "full":
            mask = torch.randn(b, 1, s, sk, device="cuda", generator=gen) * 2
        elif mask_kind == "bool":
            mask = torch.rand(b, 1, s, sk, device="cuda", generator=gen) > 0.3
            mask[0, 0, 5, :] = False       # one query row sees no key
        elif mask_kind == "row_bool":
            mask = torch.ones(b, 1, s, 1, dtype=torch.bool, device="cuda")
            mask[0, 0, 5, 0] = False
        elif mask_kind == "row_additive":
            mask = torch.randn(b, 1, s, 1, device="cuda", generator=gen) * 2
            mask[0, 0, 5, 0] = -1e9
        do = torch.randn(b, s, h, d, device="cuda", generator=gen).to(dt)
        sets.append((q, k, v, mask, do.transpose(1, 2)))
    return sets


def flash_bwd_case(torch, FA, label, dtype, b, h, s, d, mask_kind, causal,
                   dropout_p, iters, gen, sk=None):
    """The dQ and dK/dV kernels against the plain backward, timed each on
    its own (``dq``, which also computes delta; ``dkv``, from the delta a
    dQ launch wrote) and together through the wrapper (``ms``), and
    against the plain backward and the backward of
    ``scaled_dot_product_attention``, which compute all three gradients.
    ``sk`` keys (default s) for the ``s`` queries."""
    sk = sk or s
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    seed = FA.seed_words((7, 11), "cuda")     # read through a pointer
    sets = flash_sets(torch, dtype, b, h, s, d, mask_kind, gen,
                      n_sets(4 * b * h * (s + sk) * d * es), sk=sk)
    fwd = [FA.flash_attention_fwd(q, k, v, mask, causal=causal,
                                  dropout_p=dropout_p, seed=seed)
           for q, k, v, mask, _ in sets]
    full = [st[:4] + f + (st[4],) for st, f in zip(sets, fwd)]
    args = full[0]
    got = FA.flash_attention_bwd(*args, causal=causal, dropout_p=dropout_p,
                                 seed=seed)
    torch.cuda.synchronize()
    ref = FA.flash_attention_bwd_plain(*args, causal=causal,
                                       dropout_p=dropout_p, seed=seed)
    err = max(scaled_err(a, r) for a, r in zip(got, ref))
    names = ("dq", "dk", "dv")
    rec = dict(phase="train_kernel", name="flash_attention_bwd", case=label,
               dtype=dtype, shape=[b, h, s, d], keys=sk, mask=mask_kind,
               causal=causal, dropout_p=dropout_p,
               max_abs_err={n: abs_err(a, r)
                            for n, a, r in zip(names, got, ref)},
               max_scaled_err=err, tol=KERNEL_TOL[dtype])
    check(err <= KERNEL_TOL[dtype],
          f"flash_attention_bwd {label}: error {err} > tolerance")
    check(all(bool(torch.isfinite(a).all()) for a in got),
          f"flash_attention_bwd {label}: non-finite gradient")
    if mask_kind == "row_bool":
        check(not got[0][0, :, 5].any(),
              f"flash_attention_bwd {label}: a masked row gets no dq")
    F = torch.nn.functional
    # each kernel alone, on the operands the wrapper hands it: padded to
    # the kernels' head dim and in their dtype, the mask canonical
    w, kdt = FA._kernel_head_dim(d), FA._kernel_dtype(dt)
    launchers = []
    for q, k, v, mask, out, m, l, do in full:
        cm, rows, causal_k = FA._kernel_mask(mask, b, h, s, sk, causal)
        ops = [FA._to_kernel(t, w, kdt)
               for t in (FA._zero_rows(q, rows), k, v, out, do)]
        launchers.append((FA._bwd_setup(
            *ops[:3], cm, ops[3], m, l, ops[4], causal_k, 1 / math.sqrt(d),
            dropout_p, seed)[3],))
    rec["dq_ms"] = graph_ms(torch, lambda L: L(FA.BWD_DQ), launchers, iters)
    for (L,) in launchers:      # each dK/dV reads the delta its dQ wrote
        L(FA.BWD_DQ)
    rec["dkv_ms"] = graph_ms(torch, lambda L: L(FA.BWD_DKV), launchers,
                             iters)
    # the library's backward alone cannot be captured (autograd runs it on
    # the stream of its forward): its forward and backward are captured
    # together, its forward alone likewise, and the backward is the
    # difference of the two device times
    lib_sets = [tuple(t.detach().requires_grad_() for t in (q, k, v)) +
                (None if mask is None else mask.to(q.dtype), do)
                for q, k, v, mask, do in sets]

    def library_fwd(q, k, v, mask, do):
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal, dropout_p=dropout_p)

    no_library = causal and sets[0][3] is not None    # sdpa refuses both

    def library_fwd_bwd(q, k, v, mask, do):
        return torch.autograd.grad(library_fwd(q, k, v, mask, do),
                                   (q, k, v), do)

    # the kernel time here is the wrapper's: both kernels
    rec.update(timings(
        torch, lambda *a: FA.flash_attention_bwd(*a, causal=causal,
                                                 dropout_p=dropout_p,
                                                 seed=seed),
        lambda *a: FA.flash_attention_bwd_plain(*a, causal=causal,
                                                dropout_p=dropout_p,
                                                seed=seed),
        None, full, iters))
    rec["library_ms"] = None
    if not no_library:
        with torch.no_grad():
            rec["library_fwd_ms"] = graph_ms(torch, library_fwd, lib_sets,
                                             iters)
        rec["library_fwd_bwd_ms"] = graph_ms(torch, library_fwd_bwd,
                                             lib_sets, iters)
        rec["library_ms"] = rec["library_fwd_bwd_ms"] - rec["library_fwd_ms"]
    # each kernel's own work: dQ reads q, k, v, dO, O, m, l (and the mask)
    # and writes dq and delta, three products of 2 D operations a (query,
    # key) pair and D for delta a query; dK/dV reads q, k, v, dO, m, l,
    # delta (and the mask) and writes dk and dv, four products. In float32
    # (and float16, which runs the float32 kernels) each product is three
    # TF32 products at the TF32 rate
    pairs = causal_pairs(s, sk) if causal else s * sk
    mask_bytes = 0 if sets[0][3] is None else sets[0][3].numel() * 4
    rd = 2 * b * h * (s + sk) * d * es + 3 * b * h * s * 4 + mask_bytes
    ops_dq = 6 * b * h * pairs * d + 2 * b * h * s * d
    ops_dkv = 8 * b * h * pairs * d
    rate, split = ("bfloat16", 1) if dtype == "bfloat16" else ("tfloat32", 3)
    rec["bound_dq_ms"], rec["bound_dq_by"] = bound(
        rd + 2 * b * h * s * d * es, split * ops_dq, rate)
    rec["bound_dkv_ms"], rec["bound_dkv_by"] = bound(
        rd + 2 * b * h * sk * d * es, split * ops_dkv, rate)
    emit(rec)
    return rec


# -- phase 6: the loss and optimizer kernels -----------------------------------

def max_rel_err(a, b):
    """|a - b| over the largest |b|: for outputs whose scale is set by a
    factor (dx by g = 1 / count) rather than near 1."""
    return abs_err(a, b) / max(b.float().abs().max().item(), 1e-30)


def xent_case(torch, SX, label, dtype, n, v, eps, labels, iters, gen):
    """The softmax_xent forward and backward kernels at (n, v) against
    their plain versions. ``labels``: ``bench`` (bench_bert's masked-LM
    labels: a class at 15% of positions, -1, no column, elsewhere), ``oor``
    (a third -1, a fifth beyond the vocabulary) or ``all``. The loss
    gradient is the masked mean's: 1 / count on labelled rows, else 0."""
    from paddle_tpu_torch.tools.bench_bert import make_data
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    if labels == "bench":
        mlm = make_data(v, TRAIN_BATCH, TRAIN_SEQ, 1)[1][0].reshape(-1)
        lab = torch.from_numpy(mlm[:n].copy()).cuda().reshape(n, 1)
    else:
        lab = torch.randint(0, v, (n, 1), device="cuda", generator=gen,
                            dtype=torch.int32)
        if labels == "oor":
            lab[::3] = -1
            lab[1::5] = v + 7
    valid = lab != -1
    g = valid.float() / valid.sum().clamp_min(1)
    sets = [((torch.randn(n, v, device="cuda", generator=gen) * 3).to(dt),
             lab, g) for _ in range(n_sets(n * v * es))]
    x = sets[0][0]
    loss, lse = SX.softmax_xent_fwd(x, lab, eps)
    dx = SX.softmax_xent_bwd(x, lab, lse, g, eps)
    torch.cuda.synchronize()
    loss0, lse0 = SX.softmax_xent_fwd_plain(x, lab, eps)
    dx0 = SX.softmax_xent_bwd_plain(x, lab, lse, g, eps)
    err_f = max(scaled_err(loss, loss0), scaled_err(lse, lse0))
    err_b = max_rel_err(dx, dx0)
    common = dict(phase="loss_kernel", case=label, dtype=dtype, shape=[n, v],
                  eps=eps, labels=labels,
                  labelled_rows=int(valid.sum().item()))
    fwd = dict(common, name="softmax_xent_fwd",
               max_abs_err=max(abs_err(loss, loss0), abs_err(lse, lse0)),
               max_scaled_err=err_f, tol=KERNEL_TOL["float32"])
    bwd = dict(common, name="softmax_xent_bwd", max_abs_err=abs_err(dx, dx0),
               max_err_rel_to_max=err_b, tol=KERNEL_TOL[dtype])
    check(err_f <= KERNEL_TOL["float32"],
          f"softmax_xent_fwd {label}: error {err_f} > tolerance")
    check(err_b <= KERNEL_TOL[dtype],
          f"softmax_xent_bwd {label}: error {err_b} > tolerance")
    F = torch.nn.functional
    # the library takes no label beyond the vocabulary: those rows ignored
    lib_lab = torch.where((lab >= 0) & (lab < v), lab, -1).long().reshape(-1)

    def library(x, lab, g):
        return F.cross_entropy(x, lib_lab, ignore_index=-1, reduction="none",
                               label_smoothing=eps)

    fwd.update(timings(torch, lambda *a: SX.softmax_xent_fwd(*a[:2], eps),
                       lambda *a: SX.softmax_xent_fwd_plain(*a[:2], eps),
                       library, sets, iters))
    # the logits read once; labels read, loss and lse written; a compare,
    # a subtraction, an exp and an add an element (and the eps sum)
    nbytes = n * v * es + 3 * n * 4
    fwd["bound_ms"], fwd["bound_by"] = bound(nbytes, (5 if eps else 4) * n
                                             * v, "float32")
    fwd["bytes"] = nbytes
    emit(fwd)
    bsets = [(x, lab, SX.softmax_xent_fwd(x, lab, eps)[1], g)
             for x, lab, g in sets]
    bwd.update(timings(torch, lambda *a: SX.softmax_xent_bwd(*a, eps),
                       lambda *a: SX.softmax_xent_bwd_plain(*a, eps), None,
                       bsets, iters))
    # the library's backward is timed as forward+backward minus forward,
    # both captured (autograd runs it on its forward's stream)
    lib_sets = [(x.detach().requires_grad_(), lab, g) for x, lab, g in sets]

    def library_fwd_bwd(x, lab, g):
        return torch.autograd.grad(library(x, lab, g), x,
                                   g.reshape(-1).to(x.dtype))

    with torch.no_grad():
        bwd["library_fwd_ms"] = graph_ms(torch, library, lib_sets, iters)
    bwd["library_fwd_bwd_ms"] = graph_ms(torch, library_fwd_bwd, lib_sets,
                                         iters)
    bwd["library_ms"] = bwd["library_fwd_bwd_ms"] - bwd["library_fwd_ms"]
    # the logits read and dx written once; labels, lse and g read; an exp,
    # a compare, a subtraction and a product an element
    nbytes = 2 * n * v * es + 3 * n * 4
    bwd["bound_ms"], bwd["bound_by"] = bound(nbytes, 5 * n * v, "float32")
    bwd["bytes"] = nbytes
    emit(bwd)
    return fwd, bwd


def adam_state(torch, shapes, dtype, gen):
    dt = getattr(torch, dtype)
    ps, gs, ms, vs = [], [], [], []
    for shape in shapes:
        ps.append(torch.randn(shape, device="cuda", generator=gen).to(dt))
        gs.append(torch.randn(shape, device="cuda", generator=gen))
        ms.append(torch.randn(shape, device="cuda", generator=gen) * 0.1)
        vs.append(torch.rand(shape, device="cuda", generator=gen) * 0.01)
    return ps, gs, ms, vs


def adam_bound(n, p_bytes):
    """p read and written in its dtype; g read, m and v read and written
    in float32; about 15 float32 operations an element."""
    nbytes = n * (2 * p_bytes + 20)
    return bound(nbytes, 15 * n, "float32") + (nbytes,)


def adam_scalars(torch, FAD, wd=None):
    lr, b1p, b2p = (torch.tensor(x, device="cuda")
                    for x in (OPT_LR, 0.9 ** 3, 0.999 ** 3))
    extra = () if wd is None else (wd,)
    return (lr, b1p, b2p), FAD.scalars("cuda", lr, b1p, b2p, *extra)


def fused_adam_case(torch, FAD, dtype, shape, iters, gen):
    """The single-tensor kernel (no decay) against its plain version; the
    library yardstick ``torch._fused_adam_`` takes m and v in p's dtype."""
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    n = math.prod(shape)
    step = torch.tensor(3.0, device="cuda")
    sets = []
    for _ in range(n_sets(n * (2 * es + 20))):
        (p,), (g,), (m,), (v,) = adam_state(torch, [shape], dtype, gen)
        sets.append((p, g, m, v, g.to(dt), m.to(dt), v.to(dt)))
    (lr, b1p, b2p), scal = adam_scalars(torch, FAD)
    p, g, m, v = sets[0][:4]
    want = FAD.adam_plain(p, g, m, v, scal)
    got = FAD.fused_adam_update(p.clone(), g, m.clone(), v.clone(), lr, b1p,
                                b2p)
    torch.cuda.synchronize()
    err = max(scaled_err(a, b) for a, b in zip(got, want))
    rec = dict(phase="adam_kernel", name="fused_adam", dtype=dtype,
               shape=list(shape),
               max_abs_err=max(abs_err(a, b) for a, b in zip(got, want)),
               max_scaled_err=err, tol=KERNEL_TOL[dtype])
    check(err <= KERNEL_TOL[dtype], f"fused_adam {dtype} {shape}: error "
                                    f"{err} > tolerance")

    def library(p, g, m, v, gl, ml, vl):
        torch._fused_adam_([p], [gl], [ml], [vl], [], [step], lr=OPT_LR,
                           beta1=0.9, beta2=0.999, weight_decay=0.0,
                           eps=1e-8, amsgrad=False, maximize=False)

    rec.update(timings(
        torch, lambda *a: FAD.fused_adam_update(*a[:4], lr, b1p, b2p),
        lambda *a: FAD.adam_plain(*a[:4], scal), library, sets, iters))
    rec["bound_ms"], rec["bound_by"], rec["bytes"] = adam_bound(n, es)
    emit(rec)
    return rec


def pretraining_shapes():
    """The shapes of BERT-base pretraining's 157 parameters with a
    gradient in ``bench_bert`` (all but the token-type table), in
    parameter order."""
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    model = BertForPretraining(BertConfig.base())
    return [tuple(p.shape) for name, p in model.named_parameters()
            if name != "bert.embeddings.token_type_embeddings.weight"]


def fused_adam_multi_flat_cases(torch, FAD, shapes, iters, gen):
    """The many-tensor kernel over ``shapes`` and the arena kernel over
    the same elements laid flat (padded to 1024), each against its plain
    version, and the two against each other: identical bits. The library
    yardstick is ``torch._fused_adamw_`` over the same tensors."""
    wd = 0.01
    ps, gs, ms, vs = adam_state(torch, shapes, "float32", gen)
    (lr, b1p, b2p), scal = adam_scalars(torch, FAD, wd)
    total = sum(p.numel() for p in ps)
    size = total + (-total) % 1024

    def flat(ts):
        f = torch.zeros(size, device="cuda")
        f[:total] = torch.cat([t.reshape(-1) for t in ts])
        return f

    fp, fg, fm, fv = (flat(ts) for ts in (ps, gs, ms, vs))
    mp, mm, mv = ([t.clone() for t in ts] for ts in (ps, ms, vs))
    FAD.fused_adam_update_multi(mp, gs, mm, mv, lr, b1p, b2p,
                                weight_decay=wd)
    got_flat = FAD.fused_adam_update_flat(fp.clone(), fg, fm.clone(),
                                          fv.clone(), lr, b1p, b2p,
                                          weight_decay=wd)
    torch.cuda.synchronize()
    identical = all(torch.equal(f[:total], torch.cat(
        [t.reshape(-1) for t in ts])) for f, ts in
        zip(got_flat, (mp, mm, mv)))
    check(identical, "fused_adam_flat and fused_adam_multi differ on the "
                     "same inputs")
    err, aerr = 0.0, 0.0
    for p, g, m, v, got in zip(ps, gs, ms, vs, zip(mp, mm, mv)):
        want = FAD.adam_plain(p, g, m, v, scal, decay=True)
        err = max(err, max(scaled_err(a, b) for a, b in zip(got, want)))
        aerr = max(aerr, max(abs_err(a, b) for a, b in zip(got, want)))
    del mp, mm, mv, got_flat
    check(err <= KERNEL_TOL["float32"],
          f"fused_adam_multi: error {err} > tolerance")
    step = torch.tensor(3.0, device="cuda")
    common = dict(phase="adam_kernel", dtype="float32", tensors=len(ps),
                  elements=total, max_abs_err=aerr, max_scaled_err=err,
                  tol=KERNEL_TOL["float32"], flat_equals_multi=identical)

    def library(ps, gs, ms, vs):
        torch._fused_adamw_(ps, gs, ms, vs, [], [step] * len(ps), lr=OPT_LR,
                            beta1=0.9, beta2=0.999, weight_decay=wd,
                            eps=1e-8, amsgrad=False, maximize=False)

    multi = dict(common, name="fused_adam_multi",
                 launches_per_call=-(-len(ps) // FAD.MULTI_MAX_TENSORS))
    multi.update(timings(
        torch, lambda *a: FAD.fused_adam_update_multi(
            *a, lr, b1p, b2p, weight_decay=wd),
        lambda *a: [FAD.adam_plain(*t, scal, decay=True)
                    for t in zip(*a)], library, [(ps, gs, ms, vs)], iters))
    multi["bound_ms"], multi["bound_by"], multi["bytes"] = adam_bound(total,
                                                                      4)
    emit(multi)
    del ps, gs, ms, vs
    flat_rec = dict(common, name="fused_adam_flat", elements=size)
    flat_rec.update(timings(
        torch, lambda *a: FAD.fused_adam_update_flat(
            *a, lr, b1p, b2p, weight_decay=wd),
        lambda *a: FAD.adam_plain(*a, scal, decay=True),
        lambda *a: library(*([t] for t in a)), [(fp, fg, fm, fv)], iters))
    flat_rec["bound_ms"], flat_rec["bound_by"], flat_rec["bytes"] = \
        adam_bound(size, 4)
    emit(flat_rec)
    return multi, flat_rec


# -- phases 3 and 4: serving ---------------------------------------------------

def make_requests(np, seed):
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(REQUESTS_128 + REQUESTS_512):
        s = 128 if i < REQUESTS_128 else 512
        rows = int(rng.choice([1, 3, 7, 13]))
        ids = rng.randint(0, 30522, (rows, s)).astype("int32")
        tt = (rng.rand(rows, s) < 0.5).astype("int32")
        lens = rng.randint(16, s + 1, rows)
        mask = (np.arange(s)[None, :] < lens[:, None]).astype("int32")
        reqs.append((ids, tt, mask))
    return reqs


def drive(np, eng, reqs, clients=4):
    """Closed loop: each client thread sends its next request when the
    last one has come back. Returns (outputs, latencies_ms, wall_s)."""
    outs = [None] * len(reqs)
    lat = [None] * len(reqs)

    def client(idx):
        for i in idx:
            t0 = time.perf_counter()
            outs[i] = eng.submit(*reqs[i]).result(600)
            lat[i] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client,
                                args=(range(c, len(reqs), clients),))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outs, lat, time.perf_counter() - t0


def serve(np, pred, reqs, label, smi):
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving import ServingEngine
    eng = ServingEngine(pred, buckets=[8, 32], max_batch=32, timeout_ms=2)
    t0 = time.perf_counter()
    fresh = eng.warmup([((128,), "int32")] * 3, [((512,), "int32")] * 3)
    warm_s = time.perf_counter() - t0
    n128 = REQUESTS_128

    # the main path: counts zeroed just before, read just after
    kernels.reset_launches()
    b0 = eng.stats()["batches"]
    outs128, lat128, wall128 = drive(np, eng, reqs[:n128])
    outs512, lat512, wall512 = drive(np, eng, reqs[n128:])
    launches = dict(kernels.launches)
    st = eng.stats()
    eng.close()
    batches = st["batches"] - b0
    check(all(o is not None for o in outs128 + outs512),
          f"{label}: a future did not resolve")
    check(st["failed"] == 0 and st["expired"] == 0,
          f"{label}: failed or expired requests: {st}")
    for (ids, _, _), (seq, pooled) in zip(reqs, outs128 + outs512):
        n, s = ids.shape
        check(seq.shape == (n, s, 768) and pooled.shape == (n, 768),
              f"{label}: output shapes {seq.shape}, {pooled.shape}")
        check(seq.dtype == np.float32 and np.isfinite(seq).all()
              and np.isfinite(pooled).all(), f"{label}: non-finite output")
    for name, k in LAUNCHES_PER_BATCH.items():
        check(launches[name] == k * batches,
              f"{label}: {name} launched {launches[name]} times in "
              f"{batches} batches, want {k} per batch")
    lat = np.asarray(lat128)
    rec = dict(phase="serve", precision=label, card=smi,
               requests=len(reqs), requests_seq128=n128, batches=batches,
               launches=launches, warmup_s=warm_s, warmed_signatures=fresh,
               compiles_after_warmup=st["compiles"] - fresh,
               p50_ms=float(np.percentile(lat, 50)),
               # the highest percentile with 10 of the 40 samples beyond it
               p75_ms=float(np.percentile(lat, 75)),
               # of 40 samples, p99 is in effect the slowest: not a tail
               p99_ms=float(np.percentile(lat, 99)),
               max_ms=float(lat.max()),
               qps=n128 / wall128,
               rows_per_s=sum(r[0].shape[0] for r in reqs[:n128]) / wall128,
               seq512_latency_ms=[float(x) for x in lat512],
               coalesced_rows=st["coalesced_rows"],
               padded_rows=st["padded_rows"])
    check(rec["compiles_after_warmup"] == 0,
          f"{label}: traffic met a signature warmup did not run")
    return outs128 + outs512, rec


# -- phases 6 and 7: training --------------------------------------------------

def train(np, smi, route):
    """``tools/bench_bert``'s pretraining step at full width and depth, on
    its ``default`` route or the ``fused`` one (the caller has set the
    kernel switch)."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.tools.bench_bert import Trainer
    import torch
    want = FUSED_LAUNCHES_PER_STEP if route == "fused" else \
        TRAIN_LAUNCHES_PER_STEP
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(TRAIN_BATCH, TRAIN_SEQ, TRAIN_INNER)
    check(len(tr.model.bert.encoder) == 12 and
          tr.config.hidden_dropout_prob == 0.1 and
          tr.config.attention_probs_dropout_prob == 0.1,
          "training runs BERT-base with its default dropouts")
    # warm-up: the step's eager run, then its capture into a CUDA graph
    tr.step(*tr.data)[-1].item()
    warm_s = time.perf_counter() - t0

    # the main path (graph replays): counts zeroed just before, read just
    # after; a replay adds the launches its capture recorded
    kernels.reset_launches()
    t0 = time.perf_counter()
    outs = [tr.step(*tr.data) for _ in range(TRAIN_TIMED_CALLS)]
    outs[-1][-1].item()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    steps = TRAIN_TIMED_CALLS * TRAIN_INNER
    losses = torch.cat(outs).tolist()
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"training ({route}): non-finite loss in {losses}")
    for name in kernels.SOURCES:
        k = want.get(name, 0)
        check(launches[name] == k * steps,
              f"training ({route}): {name} launched {launches[name]} times "
              f"in {steps} steps, want {k} a step")
    step_ms = wall / steps * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    # the loss on one repeated batch must fall
    ids, mlm, nsp = (t[0] for t in tr.data)
    rep = [tr.one(ids, mlm, nsp) for _ in range(REPEAT_STEPS)]
    rep = [x.item() for x in rep]
    check(all(math.isfinite(x) for x in rep) and rep[-1] < rep[0],
          f"training ({route}): the loss on a repeated batch did not "
          f"fall: {rep}")
    rec = dict(phase="train", route=route,
               kernels_on=[k for k in kernels.KERNELS if kernels.enabled(k)],
               card=smi, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               layers=len(tr.model.bert.encoder), amp="bfloat16",
               optimizer="AdamW(1e-4)", dropout=0.1, warmup_steps=TRAIN_INNER,
               warmup_s=warm_s, steps=steps, launches=launches,
               step_ms=step_ms,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (wall / steps),
               losses=losses, repeated_batch_losses=rep,
               peak_memory_gib=peak_gb)
    emit(rec)
    del tr
    gc.collect()    # the trainer and its graph form a cycle
    return rec


def optimizer_routes(np, seed):
    """One BERT-base f32 backward with token types steps four copies of
    the same weights by each AdamW route; then one arena step on
    bench_bert's data (no token types) takes the arena's mask route."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.tools.bench_bert import make_data
    t0 = time.perf_counter()
    ptt.seed(seed)
    cfg = BertConfig.base(hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    base = BertForPretraining(cfg).cuda().train()
    ids, mlm, nsp = (torch.from_numpy(a[0]).cuda() for a in
                     make_data(cfg.vocab_size, 4, TRAIN_SEQ, 1,
                               rng_seed=seed))
    tt = torch.from_numpy(np.random.RandomState(seed).randint(
        0, 2, (4, TRAIN_SEQ)).astype("int32")).cuda()
    logits, nsp_logits = base(ids, tt)
    base.loss(logits, nsp_logits, mlm, nsp).backward()
    del logits, nsp_logits
    check(all(p.grad is not None for p in base.parameters()),
          "optimizer routes: a parameter got no gradient")
    grads = [p.grad.detach().clone() for p in base.parameters()]
    base.clear_gradients()
    p0 = [p.detach().clone() for p in base.parameters()]
    n = len(p0)
    # name, AdamW options, kernels switched on, launches a step
    routes = (("plain", dict(use_fused=False, use_multi_tensor=False), {},
               {}),
              ("use_fused", dict(use_fused=True, use_multi_tensor=False), {},
               {"fused_adam": n}),
              ("use_multi_tensor", dict(use_multi_tensor=True), {},
               {"fused_adam_multi": 1}),
              ("flat_arena", dict(flat_arena=True),
               dict(fused_adam_multi=True), {"fused_adam_flat": 1}))
    params, launches, opts = {}, {}, {}
    for name, opt_kw, on, per_step in routes:
        model = copy.deepcopy(base)
        opt = optimizer.AdamW(learning_rate=OPT_LR,
                              parameters=list(model.parameters()), **opt_kw)
        kernels.configure(**on)
        try:
            # this route's path: counts zeroed just before, read just after
            kernels.reset_launches()
            for _ in range(OPT_STEPS):
                for p, g in zip(model.parameters(), grads):
                    p.grad = g.clone()
                opt.step()
                opt.clear_grad()
            torch.cuda.synchronize()
            launches[name] = dict(kernels.launches)
        finally:
            kernels.configure(fused_adam_multi=None)
        for k in ("fused_adam", "fused_adam_multi", "fused_adam_flat"):
            want = per_step.get(k, 0) * OPT_STEPS
            check(launches[name][k] == want,
                  f"optimizer route {name}: {k} launched "
                  f"{launches[name][k]} times, want {want}")
        params[name] = [p.detach() for p in model.parameters()]
        opts[name] = (model, opt)
    same = all(torch.equal(a, b) for a, b in
               zip(params["flat_arena"], params["use_multi_tensor"]))
    check(same, "optimizer routes: flat arena and multi-tensor differ")
    upd_plain = torch.cat([(a - q).ravel() for a, q in
                           zip(params["plain"], p0)])
    vs_plain = {}
    for name in ("use_fused", "use_multi_tensor", "flat_arena"):
        upd = torch.cat([(a - q).ravel() for a, q in zip(params[name], p0)])
        vs_plain[name] = dict(
            max_abs=(upd - upd_plain).abs().max().item(),
            update_rel_l2=((upd - upd_plain).norm() /
                           upd_plain.norm()).item())
        check(vs_plain[name]["max_abs"] <= 2 * OPT_LR * OPT_STEPS and
              vs_plain[name]["update_rel_l2"] <= F32_UPDATE_TOL,
              f"optimizer route {name} vs plain: {vs_plain[name]}")
    del upd, upd_plain
    # the arena on bench_bert's data: the token-type table gets no
    # gradient, so the arena takes its mask route and not the kernel
    model, opt = opts["flat_arena"]
    tt_table = model.bert.embeddings.token_type_embeddings.weight
    before = tt_table.detach().clone()
    kernels.configure(fused_adam_multi=True)
    try:
        kernels.reset_launches()
        logits, nsp_logits = model(ids)
        model.loss(logits, nsp_logits, mlm, nsp).backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        mask_launches = dict(kernels.launches)
    finally:
        kernels.configure(fused_adam_multi=None)
    check(mask_launches["fused_adam_flat"] == 0 and
          torch.equal(tt_table, before),
          f"flat arena without token types: fused_adam_flat launched "
          f"{mask_launches['fused_adam_flat']} times, or the token-type "
          f"table moved")
    rec = dict(phase="optimizer_routes", params=n, steps=OPT_STEPS,
               lr=OPT_LR, launches={k: {n_: v for n_, v in d.items()
                                        if n_.startswith("fused_adam")}
                                    for k, d in launches.items()},
               flat_equals_multi=same, vs_plain=vs_plain,
               param_tol=2 * OPT_LR * OPT_STEPS, update_tol=F32_UPDATE_TOL,
               mask_step_flat_launches=mask_launches["fused_adam_flat"],
               seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


def f32_step_check(np, seed):
    """One float32 pretraining step of BERT-base (dropout 0) on the card
    and on the CPU from the same weights; on the card the float32 flash
    kernels launch once a layer each, counted."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    from paddle_tpu_torch.tools.bench_bert import make_data
    ptt.seed(seed)
    cfg = BertConfig.base(hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    cpu = BertForPretraining(cfg).train()
    card = copy.deepcopy(cpu).cuda()
    p0 = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    data = [torch.from_numpy(a[0]) for a in
            make_data(cfg.vocab_size, 4, TRAIN_SEQ, 1, rng_seed=seed)]
    # token types too, so that every parameter has a gradient to compare
    data.append(torch.from_numpy(
        np.random.RandomState(seed).randint(0, 2, (4, TRAIN_SEQ)))
        .to(torch.int32))

    def step(model, dev):
        opt = optimizer.AdamW(learning_rate=1e-4,
                              parameters=model.parameters())
        ids, mlm, nsp, tt = (a.to(dev) for a in data)
        logits, nsp_logits = model(ids, tt)
        loss = model.loss(logits, nsp_logits, mlm, nsp)
        loss.backward()
        grads = {n: p.grad.detach().cpu() for n, p in
                 model.named_parameters() if p.grad is not None}
        opt.step()
        return loss.item(), grads, {n: p.detach().cpu() for n, p in
                                    model.named_parameters()}

    t0 = time.perf_counter()
    kernels.reset_launches()
    l_card, g_card, p_card = step(card, "cuda")
    torch.cuda.synchronize()
    launches = {n: kernels.launches[n] for n in TRAIN_LAUNCHES_PER_STEP}
    l_cpu, g_cpu, p_cpu = step(cpu, "cpu")
    check(set(g_card) == set(g_cpu) == set(p0),
          f"f32 step: gradients for {len(g_card)} and {len(g_cpu)} of "
          f"{len(p0)} params")
    loss_err = abs(l_card - l_cpu) / max(1.0, abs(l_cpu))
    grad_err = max((g_card[n] - g_cpu[n]).abs().max().item() /
                   max(g_cpu[n].abs().max().item(), 1e-30)
                   for n in g_cpu if g_cpu[n].abs().max() > 0)
    upd_card = torch.cat([(p_card[n] - p0[n]).ravel() for n in p0])
    upd_cpu = torch.cat([(p_cpu[n] - p0[n]).ravel() for n in p0])
    upd_err = ((upd_card - upd_cpu).norm() / upd_cpu.norm()).item()
    param_err = (upd_card - upd_cpu).abs().max().item()
    rec = dict(phase="f32_step", batch=4, seq=TRAIN_SEQ, loss_card=l_card,
               loss_cpu=l_cpu, loss_err=loss_err, loss_tol=F32_LOSS_TOL,
               max_grad_err_rel_to_max=grad_err, grad_tol=F32_GRAD_TOL,
               update_rel_l2=upd_err, update_tol=F32_UPDATE_TOL,
               max_param_abs_err=param_err, param_tol=2e-4,
               params_checked=len(p0), launches=launches,
               seconds=time.perf_counter() - t0)
    emit(rec)
    check(launches == TRAIN_LAUNCHES_PER_STEP,
          f"f32 step: launches {launches}, want {TRAIN_LAUNCHES_PER_STEP}")
    check(loss_err <= F32_LOSS_TOL, f"f32 step: loss {l_card} vs {l_cpu}")
    check(grad_err <= F32_GRAD_TOL, f"f32 step: gradient error {grad_err}")
    check(upd_err <= F32_UPDATE_TOL and param_err <= 2e-4,
          f"f32 step: parameters after AdamW differ: update relative L2 "
          f"{upd_err}, max {param_err}")
    return rec


# -- phase 10: the batch-norm kernels ---------------------------------------------

def batch_norm_case(torch, BN, label, dtype, shape, iters, gen):
    """The four batch-norm kernels on ``shape`` (N, H, W, C) channels-last
    data seen as (N H W, C) rows, x and g in ``dtype`` and every
    per-channel operand f32, as on the training path. Returns the four
    records in ``BN_KERNELS``' order."""
    dt = getattr(torch, dtype)
    es = torch.empty((), dtype=dt).element_size()
    c = shape[-1]
    m = math.prod(shape[:-1])
    eps = 1e-5
    sets = []
    for _ in range(n_sets(3 * m * c * es)):
        x = (torch.randn(m, c, device="cuda", generator=gen) * 2 + 1).to(dt)
        g = torch.randn(m, c, device="cuda", generator=gen).to(dt)
        w = torch.rand(c, device="cuda", generator=gen) + 0.5
        b = torch.randn(c, device="cuda", generator=gen)
        mean, _, rstd, scale, shift = BN.bn_stats_plain(x, w, b, eps)
        dg, db = BN.bn_bwd_reduce_plain(x, g, mean, rstd)
        gm, gv = torch.randn(2, c, device="cuda", generator=gen).unbind(0)
        sets.append(dict(x=x, g=g, w=w, b=b, eps=eps, mean=mean, rstd=rstd,
                         scale=scale, shift=shift, dg=dg, db=db, gm=gm,
                         gv=gv))
    # name -> (wrapper, plain version, operand names, bytes, operations);
    # the per-channel operands' bytes are counted too
    cases = {
        "batch_norm_stats": (BN.bn_stats, BN.bn_stats_plain,
                             ("x", "w", "b", "eps"),
                             m * c * es + 7 * c * 4, 3 * m * c),
        "batch_norm_normalize": (BN.bn_normalize, BN.bn_normalize_plain,
                                 ("x", "scale", "shift"),
                                 2 * m * c * es + 2 * c * 4, 2 * m * c),
        "batch_norm_bwd_reduce": (BN.bn_bwd_reduce, BN.bn_bwd_reduce_plain,
                                  ("x", "g", "mean", "rstd"),
                                  2 * m * c * es + 4 * c * 4, 5 * m * c),
        "batch_norm_bwd_dx": (BN.bn_bwd_dx, BN.bn_bwd_dx_plain,
                              ("x", "g", "mean", "rstd", "w", "dg", "db",
                               "gm", "gv"), 3 * m * c * es + 7 * c * 4,
                              6 * m * c),
    }
    recs = []
    for name in BN_KERNELS:
        kernel, plain, names, nbytes, ops = cases[name]
        arg_sets = [tuple(st[k] for k in names) for st in sets]
        got = kernel(*arg_sets[0])
        torch.cuda.synchronize()
        ref = plain(*arg_sets[0])
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        if name == "batch_norm_bwd_reduce":
            # sums over m rows: relative to their largest element
            err = max(abs_err(a, r) / max(1.0, r.abs().max().item())
                      for a, r in zip(got, ref))
        else:
            err = max(scaled_err(a, r) for a, r in zip(got, ref))
        # stats and sums are f32 whatever x's dtype
        tol = KERNEL_TOL[dtype if name in ("batch_norm_normalize",
                                           "batch_norm_bwd_dx")
                         else "float32"]
        rec = dict(phase="bn_kernel", name=name, case=label, dtype=dtype,
                   shape=[m, c],
                   max_abs_err=max(abs_err(a, r) for a, r in zip(got, ref)),
                   max_scaled_err=err, tol=tol)
        check(err <= tol, f"{name} {label} {dtype} {m}x{c}: error {err} > "
                          f"tolerance {tol}")
        check(all(bool(torch.isfinite(a).all()) for a in got),
              f"{name} {label}: non-finite output")
        if name in ("batch_norm_stats", "batch_norm_bwd_reduce"):
            again = kernel(*arg_sets[0])
            check(all(torch.equal(a, c2) for a, c2 in zip(got, again)),
                  f"{name} {label}: two runs differ (the reduction must be "
                  f"deterministic)")
        rec.update(timings(torch, kernel, plain, None, arg_sets, iters))
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, ops, "float32")
        rec["bytes"] = nbytes
        recs.append(rec)
    # the library yardstick: torch's training-mode batch norm on the same
    # channels-last data, forward, and forward+backward minus forward
    F = torch.nn.functional
    lib_sets = [(st["x"].view(shape).permute(0, 3, 1, 2).detach()
                 .requires_grad_(), st["w"].detach().requires_grad_(),
                 st["b"].detach().requires_grad_(),
                 st["g"].view(shape).permute(0, 3, 1, 2)) for st in sets]

    def library_fwd(x, w, b, g):
        return F.batch_norm(x, None, None, w, b, training=True, eps=eps)

    def library_fwd_bwd(x, w, b, g):
        return torch.autograd.grad(library_fwd(x, w, b, g), (x, w, b), g)

    with torch.no_grad():
        lib_fwd = graph_ms(torch, library_fwd, lib_sets, iters)
    lib_fwd_bwd = graph_ms(torch, library_fwd_bwd, lib_sets, iters)
    st, no, rd, dx = recs
    for rec, lib, pair in ((st, lib_fwd, st["ms"] + no["ms"]),
                           (no, lib_fwd, st["ms"] + no["ms"]),
                           (rd, lib_fwd_bwd - lib_fwd, rd["ms"] + dx["ms"]),
                           (dx, lib_fwd_bwd - lib_fwd, rd["ms"] + dx["ms"])):
        # the library call does the pair's work: stats + normalize in its
        # forward, reduce + dx in its backward
        rec.update(library_ms=lib, pair_ms=pair,
                   library_covers="stats + normalize"
                   if rec in (st, no) else "bwd_reduce + bwd_dx")
        emit(rec)
    return recs


# -- phases 11 and 12: ResNet-50 training -------------------------------------------

def train_resnet(np, smi, route, data_format):
    """``tools/bench_resnet``'s training step at full width and depth on
    one route (the caller has set the kernel switch)."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.tools.bench_resnet import Trainer
    import torch
    per_step = RESNET_BN_LAYERS if route == "kernels" else 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(RESNET_BATCH, RESNET_INNER, data_format, size=RESNET_SIZE)
    bns = [m for m in tr.model.modules() if isinstance(m, nn.BatchNorm)]
    n_params = sum(p.numel() for p in tr.model.parameters())
    check(len(bns) == RESNET_BN_LAYERS and n_params == 25_557_032,
          f"training runs ResNet-50: {len(bns)} batch norms, {n_params} "
          f"parameters")
    # warm-up: the step's eager run, then its capture into a CUDA graph
    tr.step(*tr.data)[-1].item()
    warm_s = time.perf_counter() - t0

    # the main path (graph replays): counts zeroed just before, read just
    # after; a replay adds the launches its capture recorded
    kernels.reset_launches()
    t0 = time.perf_counter()
    outs = [tr.step(*tr.data) for _ in range(RESNET_TIMED_CALLS)]
    outs[-1][-1].item()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    steps = RESNET_TIMED_CALLS * RESNET_INNER
    losses = torch.cat(outs).tolist()
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"resnet training ({route}): non-finite loss in {losses}")
    for name in kernels.SOURCES:
        k = per_step if name in BN_KERNELS else 0
        check(launches[name] == k * steps,
              f"resnet training ({route}): {name} launched {launches[name]} "
              f"times in {steps} steps, want {k} a step")
    step_ms = wall / steps * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    # the loss on one repeated batch must fall
    xb, yb = (t[0] for t in tr.data)
    rep = [tr.one(xb, yb) for _ in range(RESNET_REPEAT_STEPS)]
    rep = [x.item() for x in rep]
    check(all(math.isfinite(x) for x in rep) and rep[-1] < rep[0],
          f"resnet training ({route}): the loss on a repeated batch did not "
          f"fall: {rep}")
    stats = bns[0]._mean.float()
    check(bool(torch.isfinite(stats).all()) and bool(stats.abs().sum() > 0),
          f"resnet training ({route}): the running mean did not move")
    rec = dict(phase="train_resnet", route=route, data_format=data_format,
               kernels_on=[k for k in kernels.KERNELS if kernels.enabled(k)],
               card=smi, batch=RESNET_BATCH, size=RESNET_SIZE,
               batch_norm_layers=len(bns), params=n_params, amp="bfloat16",
               optimizer="Momentum(0.1, 0.9)", warmup_steps=RESNET_INNER,
               warmup_s=warm_s, steps=steps,
               launches={k: launches[k] for k in BN_KERNELS},
               launches_per_step={k: launches[k] // steps
                                  for k in BN_KERNELS},
               step_ms=step_ms, images_per_s=RESNET_BATCH / (wall / steps),
               losses=losses, repeated_batch_losses=rep,
               peak_memory_gib=peak_gb)
    emit(rec)
    del tr
    gc.collect()    # the trainer and its graph form a cycle
    return rec


def resnet_f32_step_check(np, seed):
    """One float32 training step of ResNet-50 on the kernel route (NHWC,
    batch-norm kernels on) on the card and on the CPU, where the wrappers
    compute their plain versions, from the same weights."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.models import resnet50
    from paddle_tpu_torch.ops import kernels, loss as loss_ops
    from paddle_tpu_torch.tools.bench_resnet import make_data, normalize_u8
    ptt.seed(seed)
    cpu = resnet50(data_format="NHWC").train()
    card = copy.deepcopy(cpu).cuda()
    s0 = {n: t.detach().clone() for n, t in cpu.state_dict().items()}
    x, y = (torch.from_numpy(a[0]) for a in
            make_data(8, 1, "NHWC", RESNET_SIZE, rng_seed=seed))

    def step(model, dev):
        opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                 parameters=model.parameters())
        loss = loss_ops.cross_entropy(model(normalize_u8(x.to(dev))),
                                      y.to(dev))
        loss.backward()
        grads = {n: p.grad.detach().cpu() for n, p in
                 model.named_parameters()}
        opt.step()
        return loss.item(), grads, {n: t.detach().cpu() for n, t in
                                    model.state_dict().items()}

    t0 = time.perf_counter()
    kernels.reset_launches()
    l_card, g_card, s_card = step(card, "cuda")
    launches = {k: kernels.launches[k] for k in BN_KERNELS}
    l_cpu, g_cpu, s_cpu = step(cpu, "cpu")
    check(all(v == RESNET_BN_LAYERS for v in launches.values()),
          f"resnet f32 step: launches {launches}")
    check(set(g_card) == set(g_cpu) and len(g_cpu) == 161,
          f"resnet f32 step: gradients for {len(g_card)} and {len(g_cpu)} "
          f"params")
    loss_err = abs(l_card - l_cpu) / max(1.0, abs(l_cpu))
    rel = {n: ((g_card[n] - g_cpu[n]).norm() /
               g_cpu[n].norm().clamp_min(1e-30)).item() for n in g_cpu}
    worst = max(rel, key=rel.get)
    all_card = torch.cat([g_card[n].ravel() for n in g_cpu])
    all_cpu = torch.cat([g_cpu[n].ravel() for n in g_cpu])
    grad_err = ((all_card - all_cpu).norm() / all_cpu.norm()).item()
    # after the step: a parameter moved by lr * g, so the update is held as
    # the gradient is; the running statistics come from the forward alone
    params = list(g_cpu)
    upd_card = torch.cat([(s_card[n] - s0[n]).ravel() for n in params])
    upd_cpu = torch.cat([(s_cpu[n] - s0[n]).ravel() for n in params])
    upd_err = ((upd_card - upd_cpu).norm() / upd_cpu.norm()).item()
    stat_err = max(scaled_err(s_card[n], s_cpu[n]) for n in s_cpu
                   if n not in g_cpu)
    moved = all(not torch.equal(s_cpu[n], s0[n]) for n in s_cpu)
    rec = dict(phase="resnet_f32_step", batch=8, size=RESNET_SIZE,
               data_format="NHWC", launches=launches, loss_card=l_card,
               loss_cpu=l_cpu, loss_err=loss_err,
               loss_tol=RESNET_F32_LOSS_TOL, grad_rel_l2=grad_err,
               worst_grad=worst, worst_grad_rel_l2=rel[worst],
               fc_grad_rel_l2=rel["fc.weight"],
               grad_tol=RESNET_F32_GRAD_TOL,
               fc_grad_tol=RESNET_F32_FC_GRAD_TOL, update_rel_l2=upd_err,
               update_tol=RESNET_F32_GRAD_TOL,
               max_running_stat_scaled_err=stat_err,
               running_stat_tol=RESNET_F32_STAT_TOL,
               entries_checked=len(s_cpu),
               seconds=time.perf_counter() - t0)
    emit(rec)
    check(loss_err <= RESNET_F32_LOSS_TOL,
          f"resnet f32 step: loss {l_card} vs {l_cpu}")
    check(grad_err <= RESNET_F32_GRAD_TOL and
          rel["fc.weight"] <= RESNET_F32_FC_GRAD_TOL,
          f"resnet f32 step: gradient relative L2 {grad_err}, the "
          f"classifier's {rel['fc.weight']}")
    check(upd_err <= RESNET_F32_GRAD_TOL and moved,
          f"resnet f32 step: the Momentum update differs by {upd_err} "
          f"relative L2 (or an entry did not move)")
    check(stat_err <= RESNET_F32_STAT_TOL,
          f"resnet f32 step: running statistics differ by {stat_err}")
    return rec


# -- phase 13: generative serving ---------------------------------------------

# the decode load generator's model and engine (scripts/decode_loadgen.py:433
# and :138-141): vocab 64, width 256, 4 heads (head dim 64), 2 layers,
# float32, seeded weights; 8 lanes, pages of 32 doubling to max_len 96
# (tools/decode_loadgen's PAGE and FACTOR), prompt buckets (4, 16); its
# workload of 96 requests (:66-81)
GEN_MODEL = dict(vocab=64, dim=256, heads=4, layers=2, seed=1)
GEN_SLOTS, GEN_MAX_LEN = 8, 96
GEN_PROMPT_BUCKETS = (4, 16)
GEN_REQUESTS = 96
GEN_SAMPLING = {"temperature": 1.0, "top_k": 20, "top_p": 0.9}
GEN_SEED_BASE = 1000             # request i samples with seed 1000 + i
GEN_CPU_PROMPTS = 8              # requests replayed on the CPU
# the card's logits against the CPU's along the CPU's greedy streams, as
# |diff| / max(1, |cpu|): two layers of float32 products summed in another
# order, and the prefill's attention in split TF32
GEN_CPU_TOL = 1e-4
# long prompts: one engine at max_len 512 over the capacity family, 16
# requests of 200-448 prompt tokens and 32 new ones (prefill at 256, 512)
LONG_REQUESTS, LONG_PROMPT, LONG_NEW, LONG_MAX_LEN = 16, (200, 448), 32, 512
# kernel #3 at the prefill's shapes: one prompt, 4 heads of 64, float32
# causal, queries from one token to 512 (the loadgen's buckets 4 and 16,
# the long prompts' 256 and 512)
PREFILL_LENGTHS = (1, 4, 16, 128, 256, 512)


def serve_generate(np, smi, model, workload, mode, sampling, label,
                   max_len=GEN_MAX_LEN, prompt_buckets=GEN_PROMPT_BUCKETS,
                   draft=None, spec_k=4, phase="generate"):
    """The workload through ``tools/decode_loadgen``'s ``run_load`` (a
    warmed ``GenerateEngine`` fed by ``submit``; speculative with
    ``draft``): every request must come back with its token count, the
    traffic meet no signature that warmup did not, and launch the flash
    kernel once a layer of each model a prefill and no other kernel (the
    launch counts are zeroed after warmup and read when the last request
    is back)."""
    from paddle_tpu_torch.tools.decode_loadgen import run_load
    r = run_load(model, mode, workload, GEN_SLOTS, max_len, prompt_buckets,
                 sampling=sampling,
                 seed_base=GEN_SEED_BASE if sampling else None,
                 draft=draft, spec_k=spec_k)
    outs = [[int(t) for t in o] for o in r.pop("outputs")]
    check(r["failed"] == 0 and [len(o) for o in outs] ==
          [n for _, n in workload], f"generate {label}: a request did not "
                                    f"complete with its token count")
    check(all(0 <= t < model.vocab for o in outs for t in o),
          f"generate {label}: a token outside the vocabulary")
    check(r["post_warmup_signatures"] == 0,
          f"generate {label}: traffic met {r['post_warmup_signatures']} "
          f"signatures warmup did not")
    layers = model.layers + (draft.layers if draft is not None else 0)
    want = {"flash_attention_fwd": layers * r["prefills"]}
    check(r["prefills"] == len(workload) and r["launches"] == want,
          f"generate {label}: launches {r['launches']}, want {want} "
          f"({layers} a prefill, none a decode tick)")
    r.update(phase=phase, case=label, card=smi, sampling=sampling)
    emit(r)
    return r, outs


def held_to_cpu(np, cpu, model, workload, cpu_outs, card_outs, chunk=None):
    """The card's logits along the CPU's greedy streams, teacher-forced
    (through ``verify_fn`` over ``chunk`` inputs at a time, where given),
    against the CPU's: the largest scaled difference, the positions whose
    CPU top-2 margin exceeds the tolerance, and for each request whether
    the card's tokens equal the CPU's at every such position (its own
    free-running stream up to the first position within the margin)."""
    from paddle_tpu_torch.tools.decode_loadgen import teacher_forced_logits
    errs, sure_n, agree = [], 0, []
    for (prompt, _), want, got in zip(workload, cpu_outs, card_outs):
        ref = teacher_forced_logits(cpu, prompt, want, chunk=chunk)
        card = teacher_forced_logits(model, prompt, want, chunk=chunk)
        scale = np.maximum(1.0, np.abs(ref))
        errs.append(float((np.abs(card - ref) / scale).max()))
        top2 = np.sort(ref, axis=-1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) > GEN_CPU_TOL * scale.max(axis=-1)
        sure_n += int(sure.sum())
        first = len(want) if sure.all() else int(np.argmin(sure))
        agree.append(got[:first] == want[:first] and bool(
            (np.argmax(card, axis=-1)[sure] == np.asarray(want)[sure]).all()))
    return max(errs), sure_n, agree


def generate_phase(np, torch, FA, smi, seed, gen):
    """Phase 13: kernel #3 at the prefill's shapes, the decode load
    generator's traffic in both refill disciplines, greedy and sampled,
    the card against the CPU, and long prompts."""
    from paddle_tpu_torch.io.bucketing import grow_buckets
    from paddle_tpu_torch.serving import demo_model
    from paddle_tpu_torch.serving.kv_cache import bytes_per_token
    from paddle_tpu_torch.tools import decode_loadgen as LG
    from paddle_tpu_torch.tools.decode_loadgen import (
        make_workload, profile_decode, run_load)
    t0 = time.perf_counter()
    fa = [flash_case(torch, FA, f"prefill_s{s}", "float32", 1, 4, s, 64,
                     None, True, TIMED_ITERS, gen, phase="generate_kernel")
          for s in PREFILL_LENGTHS]
    fa.append(flash_case(torch, FA, "prefill_head_dim_8", "float32", 1, 2,
                         16, 8, None, True, TIMED_ITERS, gen,
                         phase="generate_kernel"))

    # the main path: each run zeroes the counts after its warmup and reads
    # them when its last request is back
    model = demo_model(**GEN_MODEL)
    check(model.device.type == "cuda" and model.head_dim == 64,
          f"the model is on {model.device}, head dim {model.head_dim}")
    wl = make_workload(GEN_REQUESTS, GEN_PROMPT_BUCKETS, GEN_MAX_LEN,
                       seed=seed)
    runs, outs = {}, {}
    for sampling in (None, GEN_SAMPLING):
        kind = "sampled" if sampling else "greedy"
        for mode in ("continuous", "drain"):
            runs[kind, mode], outs[kind, mode] = serve_generate(
                np, smi, model, wl, mode, sampling, f"{kind}_{mode}")
        check(outs[kind, "continuous"] == outs[kind, "drain"],
              f"generate {kind}: continuous and drain streams differ")
    check(outs["sampled", "drain"] != outs["greedy", "drain"],
          "generate: sampled streams equal the greedy ones")

    # the card against the CPU, with the same weights, teacher-forced
    cpu = demo_model(**GEN_MODEL, device="cpu")
    cpu.load_state_dict(model.state_dict())
    cpu_outs = [[int(t) for t in o] for o in run_load(
        cpu, "continuous", wl[:GEN_CPU_PROMPTS], GEN_SLOTS, GEN_MAX_LEN,
        GEN_PROMPT_BUCKETS)["outputs"]]
    err, sure_n, agree = held_to_cpu(np, cpu, model, wl, cpu_outs,
                                     outs["greedy", "continuous"])
    rec = dict(phase="generate_vs_cpu", requests=GEN_CPU_PROMPTS,
               positions=sum(len(o) for o in cpu_outs),
               positions_beyond_margin=sure_n, max_scaled_err=err,
               tol=GEN_CPU_TOL, tokens_agree=agree,
               streams_equal=[a == b for a, b in
                              zip(cpu_outs, outs["greedy", "continuous"])])
    emit(rec)
    check(err <= GEN_CPU_TOL,
          f"generate: card vs CPU logits differ by {err}")
    check(all(agree), f"generate: card and CPU tokens differ beyond the "
                      f"margin: {agree}")

    # long prompts over the capacity family
    rng = np.random.RandomState(seed + 1)
    long_wl = [(rng.randint(1, 31, size=int(rng.randint(
        LONG_PROMPT[0], LONG_PROMPT[1] + 1))).tolist(), LONG_NEW)
        for _ in range(LONG_REQUESTS)]
    family = grow_buckets(LG.PAGE, LG.FACTOR, LONG_MAX_LEN)
    long_run, long_outs = serve_generate(np, smi, model, long_wl,
                                         "continuous", None, "long_prompts",
                                         max_len=LONG_MAX_LEN,
                                         prompt_buckets=family)
    check(long_run["pool_bytes"] == GEN_SLOTS * LONG_MAX_LEN *
          bytes_per_token(model.kv_spec()),
          f"generate long prompts: the arena did not reach {LONG_MAX_LEN}")
    # the first prompt of each of the buckets 256 and 512 again on the
    # CPU, the card's logits held to the CPU's as above
    picks = [next((i for i, (p, _) in enumerate(long_wl)
                   if lo < len(p) <= hi), None)
             for lo, hi in ((128, 256), (256, 512))]
    check(None not in picks, f"generate long prompts: no prompt for the "
                             f"buckets 256 and 512 ({picks})")
    picked = [long_wl[i] for i in picks]
    long_cpu = [[int(t) for t in o] for o in run_load(
        cpu, "continuous", picked, GEN_SLOTS, LONG_MAX_LEN,
        family)["outputs"]]
    err, sure_n, agree = held_to_cpu(np, cpu, model, picked, long_cpu,
                                     [long_outs[i] for i in picks])
    emit(dict(phase="generate_long_vs_cpu",
              prompt_lengths=[len(p) for p, _ in picked],
              positions=sum(len(o) for o in long_cpu),
              positions_beyond_margin=sure_n, max_scaled_err=err,
              tol=GEN_CPU_TOL, tokens_agree=agree))
    check(err <= GEN_CPU_TOL,
          f"generate long prompts: card vs CPU logits differ by {err}")
    check(all(agree), f"generate long prompts: card and CPU tokens differ "
                      f"beyond the margin: {agree}")
    # one prefill's device time (a CUDA graph of prefill_fn) and eager time
    prefill = {}
    for s in (256, 512):
        toks = [(torch.randint(1, 31, (1, s), device="cuda", generator=gen),
                 torch.tensor([s], device="cuda")) for _ in range(4)]

        def run(t, n):
            with torch.no_grad():
                return model.prefill_fn(model.state, t, n)

        prefill[s] = dict(ms=graph_ms(torch, run, toks, 10),
                          call_ms=time_ms(torch, run, toks, 10))
    emit(dict(phase="generate_prefill", card=smi, layers=model.layers,
              prefill=prefill))

    ticks = [profile_decode(model, wl, GEN_SLOTS, GEN_MAX_LEN,
                            GEN_PROMPT_BUCKETS, sampling=sampling)
             for sampling in (None, GEN_SAMPLING)]
    for t in ticks:
        t.pop("events")
        emit(dict(t, phase="generate_tick", card=smi))
    c, d = runs["greedy", "continuous"], runs["greedy", "drain"]
    cs, ds = runs["sampled", "continuous"], runs["sampled", "drain"]
    summary = dict(
        phase="generate_summary", card=smi,
        greedy_tokens_per_s=[c["tokens_per_s"], d["tokens_per_s"]],
        greedy_speedup_x=c["tokens_per_s"] / d["tokens_per_s"],
        sampled_tokens_per_s=[cs["tokens_per_s"], ds["tokens_per_s"]],
        sampled_speedup_x=cs["tokens_per_s"] / ds["tokens_per_s"],
        long_tokens_per_s=long_run["tokens_per_s"],
        prefill_ms={s: v["ms"] for s, v in prefill.items()},
        tick_ms=[t["tick_ms"] for t in ticks],
        tick_busy_ms=[t["busy_ms_per_tick"] for t in ticks],
        tick_idle_share=[t["idle_share"] for t in ticks],
        seconds=time.perf_counter() - t0)
    emit(summary)
    return dict(kernel=fa, runs=runs, long=long_run, ticks=ticks,
                outs=outs, workload=wl)

# -- phase 14: speculative decoding -------------------------------------------

# the decode load generator's --spec arm (scripts/decode_loadgen.py:398-429;
# tools/decode_loadgen's SPEC_PAIR and SPEC_SELF): the pair's 8-layer target
# (width 192, 2 heads of 96) drafted for by its own first layer, k = 8, at
# temperature 1, request i with seed 1000 + i, over phase 13's engine and
# 96 requests
SPEC_K = 8
SPEC_SAMPLING = {"temperature": 1.0}
# kernel #3 at the pair's prefill: one prompt, 2 heads of 96 (zero-padded
# to 128), float32 causal, at the prompt buckets
SPEC_PREFILL_LENGTHS = (4, 16)
# where a speculative stream parts from the plain one, the decision there,
# from the card's teacher-forced logits, must lie within this of a tie
# (the scaled top-2 margin, or |u q(d) - p(d)|): a draft step, a verify
# and a decode step compute the same logits at other row counts and arena
# capacities, so their products may round apart
SPEC_TIE_TOL = 1e-4


def spec_departures(np, torch, model, workload, plain, spec, sampling):
    """The requests whose speculative stream parts from the plain one, each
    at its first parting ``t`` with the closeness to a tie of the decision
    there, from ``model``'s logits teacher-forced along the plain stream:
    greedy, the scaled top-2 margin; sampled (a model drafting for itself,
    whose q is p up to rounding), the smaller of the Gumbel-perturbed
    top-2 margin and the accept test's ``|u p(d) - p(d)|``. Each must be
    within :data:`SPEC_TIE_TOL`."""
    from paddle_tpu_torch.serving import sampling as S
    from paddle_tpu_torch.tools.decode_loadgen import teacher_forced_logits

    def margin(x):
        top2 = torch.topk(x, 2).values
        return float(top2[0] - top2[1]) / max(1.0, abs(float(top2[0])))

    found = []
    for i, ((prompt, _), want, got) in enumerate(
            zip(workload, plain, spec)):
        t = next((j for j in range(min(len(want), len(got)))
                  if want[j] != got[j]), None)
        if t is None:
            check(len(want) == len(got), f"spec: request {i} has "
                                         f"{len(got)} tokens, plain "
                                         f"{len(want)}")
            continue
        z = torch.from_numpy(teacher_forced_logits(model, prompt,
                                                   want[:t + 1])[t:])
        if sampling is None:
            closeness = margin(z[0])
        else:
            seed = [GEN_SEED_BASE + i]
            filt = S.filter_logits(z, [sampling["temperature"]],
                                   [sampling.get("top_k", 0)],
                                   [sampling.get("top_p", 1.0)])
            scored = (filt + S.gumbel(S.keys_for(seed, [t], S.SALT_TOKEN),
                                      z.shape[-1]))[0]
            p = S.probs_from_filtered(filt)[0]
            d = int(torch.argmax(scored))
            u = float(S.uniform_for(seed, [t], S.SALT_ACCEPT)[0])
            closeness = min(margin(scored), float(p[d]) * (1.0 - u))
        found.append(dict(request=i, at=t, closeness=closeness))
        check(closeness <= SPEC_TIE_TOL,
              f"spec: request {i} parts from the plain stream at {t}, "
              f"{closeness} from a tie")
    return found


def spec_phase(np, torch, FA, smi, seed, gen):
    """Phase 14: kernel #3 at the pair's prefill shapes, the decode load
    generator's --spec A/B (sampled, then greedy), the self-draft arm, the
    card against the CPU, and a speculative tick against a plain one."""
    from paddle_tpu_torch.serving import demo_model, demo_spec_pair
    from paddle_tpu_torch.tools import decode_loadgen as LG
    t0 = time.perf_counter()
    fa = [flash_case(torch, FA, f"spec_prefill_s{s}", "float32", 1, 2, s,
                     96, None, True, TIMED_ITERS, gen, phase="spec_kernel",
                     card=smi)
          for s in SPEC_PREFILL_LENGTHS]

    # the main path: each run zeroes the counts after its warmup and reads
    # them when its last request is back (9 flash launches a prefill: the
    # target's 8 layers and the draft's 1)
    target, draft = demo_spec_pair(**LG.SPEC_PAIR, max_len=GEN_MAX_LEN)
    check(target.device.type == "cuda" and target.head_dim == 96
          and (target.layers, draft.layers) == (8, 1)
          and draft.embed is target.embed and draft.wq0 is target.wq0,
          f"the pair: {target.layers} + {draft.layers} layers on "
          f"{target.device}, head dim {target.head_dim}")
    wl = LG.make_workload(GEN_REQUESTS, GEN_PROMPT_BUCKETS, GEN_MAX_LEN,
                          seed=seed)
    runs, outs = {}, {}
    for kind, sampling in (("sampled", SPEC_SAMPLING), ("greedy", None)):
        for arm, d in (("plain", None), ("spec", draft)):
            runs[arm, kind], outs[arm, kind] = serve_generate(
                np, smi, target, wl, "continuous", sampling,
                f"pair_{arm}_{kind}", draft=d, spec_k=SPEC_K, phase="spec")
    greedy_dep = spec_departures(np, torch, target, wl,
                                 outs["plain", "greedy"],
                                 outs["spec", "greedy"], None)
    # requests at prompt + new = the model's max_len: near their budget the
    # chunks reach past the position table and the arena (the traffic has
    # one such request within k of it)
    brim = [(prompt, GEN_MAX_LEN - len(prompt))
            for prompt, _ in wl[:GEN_SLOTS]]
    serve_generate(np, smi, target, brim, "continuous", SPEC_SAMPLING,
                   "pair_spec_brim", draft=draft, spec_k=SPEC_K,
                   phase="spec")
    # the self-draft arm: a model drafting for itself reproduces plain
    # sampling, every proposal accepted
    own = demo_model(**LG.SPEC_SELF, max_len=GEN_MAX_LEN)
    for arm, d in (("self_plain", None), ("self_spec", own)):
        runs[arm, "sampled"], outs[arm, "sampled"] = serve_generate(
            np, smi, own, wl, "continuous", SPEC_SAMPLING, arm, draft=d,
            spec_k=SPEC_K, phase="spec")
    self_dep = spec_departures(np, torch, own, wl,
                               outs["self_plain", "sampled"],
                               outs["self_spec", "sampled"], SPEC_SAMPLING)
    ss = runs["self_spec", "sampled"]
    check(ss["spec_accepted"] == ss["spec_proposed"] or self_dep,
          "spec self-draft: a proposal rejected where no stream parted")
    emit(dict(phase="spec_departures", card=smi, tol=SPEC_TIE_TOL,
              greedy_requests=len(wl), greedy=greedy_dep,
              self_draft_requests=len(wl), self_draft=self_dep,
              self_draft_proposed=ss["spec_proposed"],
              self_draft_accepted=ss["spec_accepted"]))

    # the card against the CPU, with the same weights: the CPU's greedy
    # speculative streams, and the card's verify logits teacher-forced
    # along them a chunk of k + 1 at a time
    cpu_t, cpu_d = demo_spec_pair(**LG.SPEC_PAIR, max_len=GEN_MAX_LEN,
                                  device="cpu")
    cpu_t.load_state_dict(target.state_dict())
    check(cpu_d.embed is cpu_t.embed and torch.equal(
        cpu_d.wq0, draft.wq0.cpu()), "the CPU pair shares no tensors")
    cpu_outs = [[int(t) for t in o] for o in LG.run_load(
        cpu_t, "continuous", wl[:GEN_CPU_PROMPTS], GEN_SLOTS, GEN_MAX_LEN,
        GEN_PROMPT_BUCKETS, draft=cpu_d, spec_k=SPEC_K)["outputs"]]
    err, sure_n, agree = held_to_cpu(np, cpu_t, target, wl, cpu_outs,
                                     outs["spec", "greedy"],
                                     chunk=SPEC_K + 1)
    emit(dict(phase="spec_vs_cpu", requests=GEN_CPU_PROMPTS,
              positions=sum(len(o) for o in cpu_outs),
              positions_beyond_margin=sure_n, max_scaled_err=err,
              tol=GEN_CPU_TOL, tokens_agree=agree,
              streams_equal=[a == b for a, b in
                             zip(cpu_outs, outs["spec", "greedy"])]))
    check(err <= GEN_CPU_TOL,
          f"spec: card vs CPU verify logits differ by {err}")
    check(all(agree), f"spec: card and CPU tokens differ beyond the "
                      f"margin: {agree}")

    # a speculative tick against a plain tick of the 8-layer target
    ticks = {arm: LG.profile_decode(target, wl, GEN_SLOTS, GEN_MAX_LEN,
                                    GEN_PROMPT_BUCKETS,
                                    sampling=SPEC_SAMPLING, draft=d,
                                    spec_k=SPEC_K)
             for arm, d in (("spec", draft), ("plain", None))}
    for arm, t in ticks.items():
        t.pop("events")
        emit(dict(t, phase="spec_tick", arm=arm, card=smi))
    # an admission's prefills at the bucket 16, the target's and the
    # draft's: device time (a CUDA graph of prefill_fn) and eager time
    toks = [(torch.randint(1, 31, (1, 16), device="cuda", generator=gen),
             torch.tensor([16], device="cuda")) for _ in range(4)]
    prefill = {}
    for name, m in (("target", target), ("draft", draft)):
        def run(t, n, m=m):
            with torch.no_grad():
                return m.prefill_fn(m.state, t, n)

        prefill[name] = dict(ms=graph_ms(torch, run, toks, 10),
                             call_ms=time_ms(torch, run, toks, 10))
    emit(dict(phase="spec_prefill", card=smi, length=16, prefill=prefill))
    sp, pl = runs["spec", "sampled"], runs["plain", "sampled"]
    summary = dict(
        phase="spec_summary", card=smi, spec_k=SPEC_K,
        # requests whose last chunk can reach past the position table
        past_table_requests=sum(len(p) + n + SPEC_K - 2 >= GEN_MAX_LEN
                                for p, n in wl),
        brim_requests=len(brim),
        kernel_ms={r["case"]: [r["ms"], r["plain_ms"], r["library_ms"],
                               r["bound_ms"]] for r in fa},
        tokens_per_s=[pl["tokens_per_s"], sp["tokens_per_s"]],
        spec_speedup_x=sp["tokens_per_s"] / pl["tokens_per_s"],
        accept_rate=sp["accept_rate"],
        spec_tokens_per_step=sp["spec_tokens_per_step"],
        latency_p50_ms=[pl["latency_p50_ms"], sp["latency_p50_ms"]],
        latency_p99_ms=[pl["latency_p99_ms"], sp["latency_p99_ms"]],
        greedy_tokens_per_s=[runs["plain", "greedy"]["tokens_per_s"],
                             runs["spec", "greedy"]["tokens_per_s"]],
        greedy_accept_rate=runs["spec", "greedy"]["accept_rate"],
        greedy_departures=len(greedy_dep),
        self_draft_tokens_per_s=[runs["self_plain", "sampled"]
                                 ["tokens_per_s"], ss["tokens_per_s"]],
        self_draft_departures=len(self_dep),
        vs_cpu_max_scaled_err=err,
        tick_ms=[ticks["plain"]["tick_ms"], ticks["spec"]["tick_ms"]],
        tick_busy_ms=[ticks["plain"]["busy_ms_per_tick"],
                      ticks["spec"]["busy_ms_per_tick"]],
        tick_tokens=[ticks["plain"]["tokens_per_tick"],
                     ticks["spec"]["tokens_per_tick"]],
        tick_launches=[ticks["plain"]["launches_per_tick"],
                       ticks["spec"]["launches_per_tick"]],
        prefill_call_ms=[prefill["target"]["call_ms"],
                         prefill["draft"]["call_ms"]],
        seconds=time.perf_counter() - t0)
    emit(summary)
    return dict(kernel=fa, runs=runs, ticks=ticks, outs=outs, workload=wl)


# -- phase 15: the KV hand-off and the monitor --------------------------------

# engine A takes phase 13's traffic and ticks this many times before every
# request moves to engine B (each live lane then has decode tokens of its
# own, and the long requests' lanes have outgrown the first capacity); the
# speculative pair emits up to k tokens a lane a tick, so fewer
HANDOFF_TICKS, HANDOFF_SPEC_TICKS = 40, 3
# the monitor's cost: phase 13's sampled traffic with the monitor off, on
# with its JSONL sink, and on in memory only, in turns, this block this
# many times (a host-bound number drifts within a call: the order cancels
# a steady drift)
MONITOR_BLOCK = ("off", "sink", "memory", "memory", "sink", "off")
MONITOR_TURNS = 4
# the monitor's own host time: record calls timed in a loop (a tick's
# record, and one request's records from submit to its terminal record)
MONITOR_COST_CALLS = 2000
# where a moved stream parts from the unmoved one, the decision there, from
# the card's teacher-forced logits, must lie within this of a tie (the
# scaled top-2 margin, Gumbel-perturbed where sampled): A's and B's arenas
# may stand at other capacities, so the attention's products may round
# apart
HANDOFF_TIE_TOL = SPEC_TIE_TOL


def _engine(model, **kw):
    from paddle_tpu_torch.serving import GenerateEngine
    return GenerateEngine(model, slots=GEN_SLOTS, page=32, factor=2.0,
                          max_len=GEN_MAX_LEN, prompt_buckets=GEN_PROMPT_BUCKETS,
                          queue_depth=GEN_REQUESTS + 8, shed=False,
                          start=False, **kw)


def _drain(eng, futs, ticks=5000):
    for _ in range(ticks):
        if all(f.done() for f in futs):
            break
        eng.tick()
    return [[int(t) for t in f.result(timeout=60)] for f in futs]


def handoff_departures(torch, model, workload, clean, moved, sampling):
    """The requests whose moved stream parts from the unmoved one, each at
    its first parting ``t`` with the closeness to a tie of the decision
    there, from ``model``'s logits teacher-forced along the unmoved
    stream: the scaled top-2 margin, of the Gumbel-perturbed filtered
    logits where sampled. Each must be within :data:`HANDOFF_TIE_TOL`."""
    from paddle_tpu_torch.serving import sampling as S
    from paddle_tpu_torch.tools.decode_loadgen import teacher_forced_logits
    found = []
    for i, ((prompt, n), want, got) in enumerate(zip(workload, clean,
                                                     moved)):
        check(len(got) == n, f"handoff: request {i} has {len(got)} tokens, "
                             f"asked {n}")
        t = next((j for j in range(n) if want[j] != got[j]), None)
        if t is None:
            continue
        z = torch.from_numpy(teacher_forced_logits(model, prompt,
                                                   want[:t + 1])[t:])
        if sampling is not None:
            z = S.filter_logits(z, [sampling["temperature"]],
                                [sampling.get("top_k", 0)],
                                [sampling.get("top_p", 1.0)])
            z = z + S.gumbel(S.keys_for([GEN_SEED_BASE + i], [t],
                                        S.SALT_TOKEN), z.shape[-1])
        top2 = torch.topk(z[0], 2).values
        closeness = float(top2[0] - top2[1]) / max(1.0, abs(float(top2[0])))
        found.append(dict(request=i, at=t, closeness=closeness))
        check(closeness <= HANDOFF_TIE_TOL,
              f"handoff: request {i} parts from its unmoved stream at {t}, "
              f"{closeness} from a tie")
    return found


def handoff_run(np, torch, smi, model, workload, sampling, label,
                draft=None, clean=None, ticks=HANDOFF_TICKS):
    """Phase 15's hand-off: ``workload`` into engine A, ``ticks`` ticks,
    then every request to a warmed ``kv_import=True`` engine B (the
    live lanes exported with their KV, the queued ones bare; half through
    ``requeue``, half through ``submit_request(admit=False)``), with the
    launch counts zeroed just before each engine's traffic and read just
    after. Each moved stream is held to ``clean`` (the unmoved streams on
    the same card), departures counted and each a near-tie."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.serving.kv_cache import KVCachePool, bytes_per_token
    layers = model.layers + (draft.layers if draft is not None else 0)
    a = _engine(model, draft_model=draft, spec_k=SPEC_K)
    a.warmup()
    kernels.reset_launches()
    futs = [a.submit(p, max_new_tokens=n, sampling=sampling,
                     seed=(GEN_SEED_BASE + i) if sampling else None)
            for i, (p, n) in enumerate(workload)]
    for _ in range(ticks):
        a.tick()
    torch.cuda.synchronize()
    a_launches = dict(kernels.launches)
    a_stats = a.stats()
    check(a_launches["flash_attention_fwd"] == layers * a_stats["prefills"]
          > 0, f"handoff {label}: engine A's flash launches "
               f"{a_launches['flash_attention_fwd']}, want {layers} a "
               f"prefill ({a_stats['prefills']})")
    live = [(s, slot) for s, slot in enumerate(a._slots)
            if slot.req is not None]
    check(live and all(len(slot.tokens) >= 2 for _, slot in live),
          f"handoff {label}: a live lane without a decode token")
    # each lane's export alone, timed (the device-to-host copies and the
    # one wait), then the engine's own hand-off, which exports them again
    export_ms = []
    for s, slot in live:
        t0 = time.perf_counter()
        a.pool.export_slot(s, pad_to=a.pool.capacity_for(slot.length))
        export_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    moved = a.disown_inflight(export_kv=True) + a.steal_pending()
    disown_ms = (time.perf_counter() - t0) * 1e3
    a.close(drain=False)
    exported = [r for r in moved if r.preset is not None]
    per_tok = bytes_per_token(model.kv_spec())
    for r in exported:
        seg = r.preset["segment"]
        check(seg["bytes"] == per_tok * seg["pad"],
              f"handoff {label}: a segment of {seg['bytes']} bytes at pad "
              f"{seg['pad']}, want {per_tok} a position")
    check(len(exported) == len(live) and len(moved) == len(workload)
          - a_stats["completed"],
          f"handoff {label}: moved {len(moved)}, exported {len(exported)} "
          f"of {len(live)} live lanes")
    # each segment's import alone into a spare arena, timed to the card's
    # completion of the host-to-device copies
    spare = KVCachePool(model.kv_spec(), GEN_SLOTS, page=32, factor=2.0,
                        max_len=GEN_MAX_LEN)
    spare.grow_to(spare.max_len, lambda b, o, n: {k: torch.cat([v, torch.zeros(
        (v.shape[0], n - o) + tuple(v.shape[2:]), device=v.device)], 1)
        for k, v in b.items()})
    import_ms = []
    for i, r in enumerate(exported):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spare.import_slot(i % GEN_SLOTS, r.preset["segment"])
        torch.cuda.synchronize()
        import_ms.append((time.perf_counter() - t0) * 1e3)

    b = _engine(model, draft_model=draft, spec_k=SPEC_K, kv_import=True)
    b.warmup()
    before = b.executables()
    kernels.reset_launches()
    b.requeue(moved[:len(moved) // 2])
    for r in moved[len(moved) // 2:]:
        b.submit_request(r, admit=False)
    outs = _drain(b, futs)
    torch.cuda.synchronize()
    b_launches = dict(kernels.launches)
    st = b.stats()
    after = b.executables()
    b.close()
    check(after == before, f"handoff {label}: engine B met "
                           f"{after[0] - before[0]} signatures after warmup")
    check(st["kv_imports"] == len(exported),
          f"handoff {label}: {st['kv_imports']} imports, "
          f"{len(exported)} exported lanes")
    check(st["prefills"] == len(moved) - len(exported)
          and b_launches["flash_attention_fwd"] == layers * st["prefills"],
          f"handoff {label}: engine B's {b_launches['flash_attention_fwd']} "
          f"flash launches, {st['prefills']} prefills for "
          f"{len(moved) - len(exported)} bare requests (an imported lane "
          f"must launch none)")
    deps = handoff_departures(torch, model, workload, clean, outs, sampling)
    rec = dict(phase="handoff", case=label, card=smi, ticks_before=ticks,
               requests=len(workload), moved=len(moved),
               exported=len(exported),
               pads=sorted(r.preset["segment"]["pad"] for r in exported),
               bytes_moved=sum(r.preset["segment"]["bytes"]
                               for r in exported),
               export_ms_mean=statistics.mean(export_ms),
               export_ms_max=max(export_ms),
               import_ms_mean=statistics.mean(import_ms),
               import_ms_max=max(import_ms), disown_ms=disown_ms,
               engine_a_prefills=a_stats["prefills"],
               engine_b_prefills=st["prefills"], kv_imports=st["kv_imports"],
               engine_b_flash_launches=b_launches["flash_attention_fwd"],
               departures=deps, tol=HANDOFF_TIE_TOL)
    if draft is not None:
        rec.update(spec_proposed=st["spec_proposed"],
                   spec_accepted=st["spec_accepted"])
    emit(rec)
    return rec


def monitor_host_cost(monitor, path):
    """The host time the monitor's records take, on, with a sink: a decode
    tick's record, and one request's records and spans from its submit
    to its terminal record (what ``GenerateEngine`` calls for it), in µs,
    each the mean of :data:`MONITOR_COST_CALLS` calls."""
    from paddle_tpu_torch.serving import metrics, reqtrace
    trc = monitor.trace
    monitor.enable(str(path))
    trc.enable()
    try:
        t0 = time.perf_counter()
        for _ in range(MONITOR_COST_CALLS):
            metrics.record_decode_tick(8, 8, 8, 7.0)
        tick_us = (time.perf_counter() - t0) / MONITOR_COST_CALLS * 1e6
        t0 = time.perf_counter()
        for i in range(MONITOR_COST_CALLS):
            att = reqtrace.attach(None, kind="decode")
            metrics.record_submit(1)
            metrics.record_queue_depth(1)
            att.hop("enqueue")
            with trc.span("serving.enqueue", depth=1):
                reqtrace.flow_mark(att)
            metrics.record_queue_depth(0)
            att.to("prefill")
            pc = time.perf_counter()
            metrics.record_prefill(8, 5.0, 16)
            att.first_token()
            trc.lane_complete("kv.slot0", "prefill", pc, pc, rid=i,
                              tokens=8, bucket=16)
            att.note_tokens(8)
            metrics.record_completed(1, [100.0], within_sla=[True])
            att.finalize("ok")
            trc.lane_complete("kv.slot0", "req", pc, rid=i, tokens=8)
        request_us = (time.perf_counter() - t0) / MONITOR_COST_CALLS * 1e6
    finally:
        monitor.disable()
        trc.disable()
        monitor.reset()
        trc.clear()
        reqtrace.reset()
        metrics.reset_windows()
    return tick_us, request_us


def monitor_phase(np, torch, smi, seed):
    """Phase 15, second half: phase 13's sampled traffic and phase 14's
    A/B with the port's monitor and tracer on (and phase 13's traffic off,
    in the same call): TTFT and TPOT, the prefill share, the speculative
    arm's summed prefill against tick time, the records and counters
    against the engine's, a tick's launches with the monitor on and off,
    and the Chrome trace."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.serving import demo_model, demo_spec_pair, metrics
    from paddle_tpu_torch.tools import decode_loadgen as LG
    out_dir = HERE / "paddle_tpu_torch" / "_build" / "monitor"
    model = demo_model(**GEN_MODEL)
    wl = LG.make_workload(GEN_REQUESTS, GEN_PROMPT_BUCKETS, GEN_MAX_LEN,
                          seed=seed)

    def load(m, draft=None, sampling=GEN_SAMPLING):
        r = LG.run_load(m, "continuous", wl, GEN_SLOTS, GEN_MAX_LEN,
                        GEN_PROMPT_BUCKETS, sampling=sampling,
                        seed_base=GEN_SEED_BASE, draft=draft, spec_k=SPEC_K)
        r.pop("outputs")
        return r

    # the monitor's cost on tokens/s: off and on in turns, in one call
    runs = {arm: [] for arm in MONITOR_BLOCK}
    snaps, sink = [], None
    try:
        for arm in MONITOR_BLOCK * MONITOR_TURNS:
            if arm != "off":
                path = monitor.enable(str(out_dir) if arm == "sink"
                                      else None)
                sink = path or sink
                monitor.trace.enable()
            snaps.append(monitor.snapshot("serving.decode."))
            runs[arm].append(load(model))
            snaps.append(monitor.snapshot("serving.decode."))
            monitor.disable()
            monitor.trace.disable()
        # a sampled tick's launches, with the monitor off and on
        ticks_off = LG.profile_decode(model, wl, GEN_SLOTS, GEN_MAX_LEN,
                                      GEN_PROMPT_BUCKETS,
                                      sampling=GEN_SAMPLING)
        monitor.enable(str(out_dir))
        monitor.trace.enable()
        ticks_on = LG.profile_decode(model, wl, GEN_SLOTS, GEN_MAX_LEN,
                                     GEN_PROMPT_BUCKETS, sampling=GEN_SAMPLING)
        target, draft = demo_spec_pair(**LG.SPEC_PAIR, max_len=GEN_MAX_LEN)
        arms = {arm: load(target, d, SPEC_SAMPLING)
                for arm, d in (("plain", None), ("spec", draft))}
        trace_path = monitor.trace.export_chrome_trace(
            str(out_dir / "trace.json"))
    finally:
        monitor.disable()
        monitor.trace.disable()
    off, ons = runs["off"], runs["sink"]
    on = ons[0]
    tick_us, request_us = monitor_host_cost(monitor, out_dir / "cost")
    snap0, snap1 = snaps[2], snaps[3]
    # the runs' requests completed; the profiled ticks' requests, closed
    # mid-stream, end as errors
    records = [r for r in monitor.read_jsonl(sink)
               if r["kind"] == "serving.request" and r["outcome"] == "ok"]
    check(all(len(r["records"]) == GEN_REQUESTS
              for r in ons + runs["memory"])
          and len(records) == GEN_REQUESTS * (len(ons) + 2),
          f"monitor: {[len(r['records']) for r in ons]} records for "
          f"{GEN_REQUESTS} requests a run, {len(records)} in the sink for "
          f"{len(ons) + 2} runs")
    delta = {k: snap1[k] - snap0.get(k, 0) for k in (
        "serving.decode.ticks", "serving.decode.tokens",
        "serving.decode.prefills", "serving.decode.prefill_tokens")}
    want = {"serving.decode.ticks": on["ticks"],
            # a tick's tokens: each request's first comes from its prefill
            "serving.decode.tokens": on["tokens"] - on["prefills"],
            "serving.decode.prefills": on["prefills"],
            "serving.decode.prefill_tokens": sum(len(p) for p, _ in wl)}
    check(delta == want, f"monitor: decode counters {delta}, the engine's "
                         f"{want}")
    check(on["tick_ms_total"][0] == on["ticks"]
          and on["prefill_ms_total"][0] == on["prefills"],
          "monitor: a tick or prefill the histograms missed")
    ev_off, ev_on = ticks_off["events"], ticks_on["events"]
    check(ticks_on["launches_per_tick"] == ticks_off["launches_per_tick"],
          f"monitor: a tick launches {ticks_on['launches_per_tick']} with "
          f"the monitor on, {ticks_off['launches_per_tick']} off; the "
          f"events whose counts differ (off, on): " + str({
              n: (ev_off.get(n, 0), ev_on.get(n, 0))
              for n in sorted(set(ev_off) | set(ev_on))
              if ev_off.get(n, 0) != ev_on.get(n, 0)}))
    with open(trace_path) as fh:
        doc = json.load(fh)
    lanes = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    names = {e["name"] for e in doc["traceEvents"]}
    check(any(n.startswith("kv.slot") for n in lanes) and "kv.pool" in lanes
          and {"serving.enqueue", "serving.warmup", "prefill"} <= names,
          f"monitor: the Chrome trace lacks the engine's lanes ({lanes})")
    sp = arms["spec"]
    rec = dict(
        phase="monitor", card=smi, requests=GEN_REQUESTS,
        tokens_per_s_off=[r["tokens_per_s"] for r in off],
        tokens_per_s_on=[r["tokens_per_s"] for r in ons],
        tokens_per_s_memory=[r["tokens_per_s"] for r in runs["memory"]],
        monitor_cost=1.0 - statistics.median(r["tokens_per_s"] for r in ons)
        / statistics.median(r["tokens_per_s"] for r in off),
        memory_cost=1.0 - statistics.median(
            r["tokens_per_s"] for r in runs["memory"])
        / statistics.median(r["tokens_per_s"] for r in off),
        # each block's own ratio: on (sink) over off, its two runs each
        block_ratios=[sum(r["tokens_per_s"] for r in ons[2 * b:2 * b + 2])
                      / sum(r["tokens_per_s"] for r in off[2 * b:2 * b + 2])
                      for b in range(MONITOR_TURNS)],
        # the monitor's own host time, and what it comes to in a run of
        # the same ticks and requests, as a share of the run's wall time
        record_tick_us=tick_us, record_request_us=request_us,
        monitor_host_share=(tick_us * on["ticks"] + request_us
                            * GEN_REQUESTS) / 1e6 / on["wall_s"],
        ttft_p50_ms=[r["ttft_p50_ms"] for r in ons],
        ttft_p99_ms=[r["ttft_p99_ms"] for r in ons],
        tpot_p50_ms=[r["tpot_p50_ms"] for r in ons],
        tpot_p99_ms=[r["tpot_p99_ms"] for r in ons],
        prefill_ratio=[r["prefill_ratio"] for r in ons],
        prefill_ms_total=[r["prefill_ms_total"] for r in ons],
        tick_ms_total=[r["tick_ms_total"] for r in ons],
        wall_s=[r["wall_s"] for r in ons],
        tick_launches=[ticks_off["launches_per_tick"],
                       ticks_on["launches_per_tick"]],
        tick_ms=[ticks_off["tick_ms"], ticks_on["tick_ms"]],
        spec={arm: dict(tokens_per_s=r["tokens_per_s"], wall_s=r["wall_s"],
                        prefill_ms_total=r["prefill_ms_total"],
                        tick_ms_total=r["tick_ms_total"],
                        prefill_ratio=r["prefill_ratio"],
                        ttft_p50_ms=r["ttft_p50_ms"],
                        ttft_p99_ms=r["ttft_p99_ms"],
                        tpot_p50_ms=r["tpot_p50_ms"],
                        tpot_p99_ms=r["tpot_p99_ms"])
              for arm, r in arms.items()},
        spec_prefill_s=sp["prefill_ms_total"][1] / 1e3,
        spec_tick_s=sp["tick_ms_total"][1] / 1e3,
        trace_events=len(doc["traceEvents"]), trace=str(trace_path),
        decode_rollup=metrics.decode_rollup())
    emit(rec)
    return rec


def handoff_phase(np, torch, smi, seed):
    """Phase 15: the KV hand-off on the card (plain, greedy and sampled;
    then the speculative pair, greedy), then the monitor."""
    from paddle_tpu_torch.serving import demo_model, demo_spec_pair
    from paddle_tpu_torch.tools import decode_loadgen as LG
    t0 = time.perf_counter()
    model = demo_model(**GEN_MODEL)
    wl = LG.make_workload(GEN_REQUESTS, GEN_PROMPT_BUCKETS, GEN_MAX_LEN,
                          seed=seed)
    runs = {}
    for kind, sampling in (("greedy", None), ("sampled", GEN_SAMPLING)):
        eng = _engine(model)
        eng.warmup()
        clean = _drain(eng, [eng.submit(
            p, max_new_tokens=n, sampling=sampling,
            seed=(GEN_SEED_BASE + i) if sampling else None)
            for i, (p, n) in enumerate(wl)])
        eng.close()
        runs[kind] = handoff_run(np, torch, smi, model, wl, sampling, kind,
                                 clean=clean)
    target, draft = demo_spec_pair(**LG.SPEC_PAIR, max_len=GEN_MAX_LEN)
    eng = _engine(target)
    eng.warmup()
    clean = _drain(eng, [eng.submit(p, max_new_tokens=n) for p, n in wl])
    eng.close()
    runs["spec_greedy"] = handoff_run(np, torch, smi, target, wl, None,
                                      "spec_greedy", draft=draft,
                                      clean=clean, ticks=HANDOFF_SPEC_TICKS)
    mon = monitor_phase(np, torch, smi, seed)
    emit(dict(
        phase="handoff_summary", card=smi,
        export_ms_mean={k: r["export_ms_mean"] for k, r in runs.items()},
        export_ms_max={k: r["export_ms_max"] for k, r in runs.items()},
        import_ms_mean={k: r["import_ms_mean"] for k, r in runs.items()},
        import_ms_max={k: r["import_ms_max"] for k, r in runs.items()},
        bytes_moved={k: r["bytes_moved"] for k, r in runs.items()},
        exported={k: r["exported"] for k, r in runs.items()},
        departures={k: len(r["departures"]) for k, r in runs.items()},
        ttft_ms=[statistics.median(mon["ttft_p50_ms"]),
                 statistics.median(mon["ttft_p99_ms"])],
        tpot_ms=[statistics.median(mon["tpot_p50_ms"]),
                 statistics.median(mon["tpot_p99_ms"])],
        prefill_ratio=statistics.median(mon["prefill_ratio"]),
        record_tick_us=mon["record_tick_us"],
        record_request_us=mon["record_request_us"],
        monitor_host_share=mon["monitor_host_share"],
        spec_prefill_s=mon["spec_prefill_s"], spec_tick_s=mon["spec_tick_s"],
        spec_wall_s=mon["spec"]["spec"]["wall_s"],
        monitor_cost=mon["monitor_cost"], memory_cost=mon["memory_cost"],
        block_ratios=mon["block_ratios"],
        tokens_per_s=[mon["tokens_per_s_off"], mon["tokens_per_s_on"]],
        tick_launches=mon["tick_launches"],
        seconds=time.perf_counter() - t0))
    return runs, mon

# -- phase 16: multi-replica serving ------------------------------------------

# the BERT fleet: phase 3's model twice on the one card. Replica 0 fails
# its first three batch attempts (replica_error) inside a retry policy of
# four attempts, so that its breaker (threshold 3) opens and no request
# fails; the breaker's cooldown outlasts the traffic
FLEET_REPLICAS = 2
FLEET_ERRORS = 3
FLEET_COOLDOWN_S = 600.0
# requests held, after the rolling swap, to a single engine over the
# second seed's weights
FLEET_SWAP_CHECK = 8
# the decode fleets: phase 13's model, engine and sampled traffic over 1,
# 2 and 3 replicas on the one card (the loadgen's run_fleet); then
# supervised runs in which replica 1 hangs (replica_hang, FLEET_HANG_S)
# and the supervisor's verdict comes once its tick is FLEET_INFLIGHT_MS
# old. In a scripted run replica 1's ticks run on a thread of this
# script, its engine's own loop with one check between ticks, from the
# moment all the traffic is offered, and the hang is injected at the
# first boundary with lanes seated and requests queued, so that a
# failover has both to move; with 3 replicas, replica 2 then gets a
# preemption notice. In the free run every replica ticks on its engine's
# own thread and the hang lands wherever replica 1 is. A hang in a
# prefill strands that request, which a failover does not move (ROADMAP.md
# Queue C) and which completes on replica 1 once the hang ends: every
# run counts those
DECODE_FLEET_REPLICAS = (1, 2, 3)
FLEET_HANG_S = 5.0
FLEET_INFLIGHT_MS = 1000.0
FLEET_SUPERVISOR_S = 0.05
FLEET_WAIT_S = 60.0


def wait_for(cond, what, timeout=FLEET_WAIT_S, poll=0.005):
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"fleet: timed out waiting for "
                                           f"{what}")
        time.sleep(poll)


def spy_moves(engine):
    """Record the requests ``engine`` hands over when the fleet migrates
    its work: ``{"disown_inflight": [...], "steal_pending": [...]}``."""
    log = {}
    for name in ("disown_inflight", "steal_pending"):
        orig = getattr(engine, name)
        log[name] = []

        def spy(*a, _orig=orig, _log=log[name], **kw):
            out = _orig(*a, **kw)
            _log.extend(out)
            return out

        setattr(engine, name, spy)
    return log


def bert_fleet(np, torch, smi, seed, reqs, outs32):
    """The BERT-base fleet: phase 3's traffic with replica 0 failing until
    its breaker opens, the supervisor's half-open probe readmitting it,
    then a rolling swap to a second seed's weights under traffic."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.models import Bert, BertConfig
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.resilience.retry import RetryPolicy
    from paddle_tpu_torch.serving import MultiDeviceEngine, ServingEngine
    t0 = time.perf_counter()
    ptt.seed(seed)
    model = Bert(BertConfig.base()).eval()
    fleet = MultiDeviceEngine(
        Predictor(model), devices=["cuda:0"] * FLEET_REPLICAS,
        buckets=[8, 32], max_batch=32, timeout_ms=2,
        breaker_cooldown_s=FLEET_COOLDOWN_S,
        retry_policy=RetryPolicy(max_attempts=FLEET_ERRORS + 1,
                                 base_delay=0.001, max_delay=0.001,
                                 jitter=0.0))
    try:
        fresh = fleet.warmup([((128,), "int32")] * 3,
                             [((512,), "int32")] * 3)
        spec = faults.inject("replica_error", replica=0, times=FLEET_ERRORS)
        n128 = REQUESTS_128
        # the main path: counts zeroed just before, read just after
        kernels.reset_launches()
        b0 = sum(e.stats()["batches"] for e in fleet.engines)
        outs128, _, wall128 = drive(np, fleet, reqs[:n128])
        routed0 = fleet.engines[0].stats()["submitted"]
        outs512, _, _ = drive(np, fleet, reqs[n128:])
        launches = dict(kernels.launches)
        st = fleet.stats()
        faults.clear()
        batches = st["batches"] - b0
        outs = outs128 + outs512
        check(all(o is not None for o in outs),
              "bert fleet: a future did not resolve")
        check(spec.fired == FLEET_ERRORS and st["breakers"][0] == "open",
              f"bert fleet: replica_error fired {spec.fired} times, "
              f"breakers {st['breakers']}")
        check(st["replicas"][0]["submitted"] == routed0,
              "bert fleet: traffic reached replica 0 past its open breaker")
        for r in st["replicas"]:
            check(r["failed"] == 0 and r["expired"] == 0
                  and r["isolated"] == 0, f"bert fleet: a replica failed "
                                          f"or isolated requests: {r}")
        check(st["compiles"] == fresh,
              "bert fleet: traffic met a signature warmup did not run")
        errs = [max(float(np.abs(a - b).max()) for a, b in zip(o, w))
                for o, w in zip(outs, outs32)]
        check(max(errs) <= SERVE_F32_TOL,
              f"bert fleet: outputs differ from the single engine's by "
              f"{max(errs)}")
        for name, k in LAUNCHES_PER_BATCH.items():
            check(launches[name] == k * batches,
                  f"bert fleet: {name} launched {launches[name]} times in "
                  f"{batches} batches, want {k} per batch")
        # the operator shortens replica 0's cooldown: the supervisor's
        # half-open probe runs on the card and readmits it
        fleet._replicas[0].breaker.cooldown_s = 0.0
        wait_for(lambda: "reclose" in [d["decision"] for d in
                                       fleet.supervisor.decisions],
                 "replica 0's reclose")
        # a rolling swap to the second seed's weights under traffic
        ptt.seed(seed + 1)
        model2 = Bert(BertConfig.base()).eval()
        single = ServingEngine(Predictor(model2), buckets=[8, 32],
                               max_batch=32, timeout_ms=2)
        want2 = [single.run(*reqs[i], timeout=600)
                 for i in range(FLEET_SWAP_CHECK)]
        single.close()
        stop, during, errors = threading.Event(), [], []

        def client():
            i = 0
            while not stop.is_set():
                try:
                    during.append(fleet.submit(*reqs[i % n128])
                                  .result(600))
                except Exception as e:   # noqa: BLE001 - checked below
                    errors.append(repr(e))
                i += 1

        preds = [r.predictor for r in fleet._replicas]
        warm = [len(p._compiled) for p in preds]
        captures0 = [p.captures for p in preds]
        compiles0 = fleet.stats()["compiles"]
        th = threading.Thread(target=client)
        th.start()
        ts = time.perf_counter()
        version = fleet.swap_weights(model2.state_dict())
        swap_s = time.perf_counter() - ts
        stop.set()
        th.join(600)
        check(not errors and during and all(
            np.isfinite(a).all() for o in during for a in o),
            f"bert fleet: requests during the swap failed: {errors[:3]}")
        post = [fleet.run(*reqs[i], timeout=600)
                for i in range(FLEET_SWAP_CHECK)]
        swap_err = max(float(np.abs(a - b).max()) for o, w in
                       zip(post, want2) for a, b in zip(o, w))
        check(version == 1 and [e.weights_version for e in fleet.engines]
              == [1] * FLEET_REPLICAS and swap_err <= SERVE_F32_TOL,
              f"bert fleet: after the swap, version {version}, outputs "
              f"{swap_err} from the second seed's")
        st2 = fleet.stats()
        # the swap captured each replica's warm signatures over its new
        # module before binding it; no call under traffic captured or met
        # a new signature, and every signature has an entry of the new
        # module (bound, or prepared for its first call)
        recaptures = [p.captures - c for p, c in zip(preds, captures0)]
        check(recaptures == warm and st2["compiles"] == compiles0 == fresh
              and all({sig for entries in (p._compiled, p._prepared)
                       for sig, e in entries.items()
                       if e.module is p.model} == set(p._compiled)
                      for p in preds),
              f"bert fleet: the swap captured {recaptures} graphs for "
              f"{warm} warm signatures; compiles {compiles0} -> "
              f"{st2['compiles']}")
        decisions = [dict(d, t=None) for d in fleet.supervisor.decisions]
    finally:
        faults.clear()
        fleet.close()
    rec = dict(phase="fleet_bert", card=smi, replicas=FLEET_REPLICAS,
               requests=len(reqs), batches=batches, launches=launches,
               replica_error_fired=spec.fired,
               routed=[r["submitted"] for r in st["replicas"]],
               breakers_after_traffic=st["breakers"],
               max_abs_err_vs_single=max(errs), tol=SERVE_F32_TOL,
               qps=n128 / wall128, requests_during_swap=len(during),
               swap_s=swap_s, swap_max_abs_err=swap_err,
               swap_recaptures=recaptures,
               compiles_under_traffic=st2["compiles"] - fresh,
               hedged=st2["hedged"], hedge_wins=st2["hedge_wins"],
               hedge_budget=fleet.hedge_budget,
               submitted=sum(r["submitted"] for r in st2["replicas"]),
               breakers=st2["breakers"], decisions=decisions,
               seconds=time.perf_counter() - t0)
    emit(rec)
    del model, model2
    torch.cuda.empty_cache()
    return rec


def hang_ticker(engine, stop, state):
    """Replica 1's tick loop (its engine's own, ``GenerateEngine._worker``,
    with a check between ticks), from the moment the traffic is all
    offered: at the first tick boundary where lanes are seated and
    requests queued, ``replica_hang`` is injected, so that the next tick
    hangs with both to move: in its step where every lane is taken (long
    sampled requests), else in the prefill of the next queued request,
    which the hang strands (short speculative ones; counted)."""
    from paddle_tpu_torch.resilience import faults
    state["offered"].wait(FLEET_WAIT_S)
    while not stop.is_set():
        busy = engine.tick()
        hb = engine.heartbeat()
        if "spec" not in state and hb["active"] and hb["queue_depth"]:
            state["spec"] = faults.inject("replica_hang", replica=1,
                                          delay=FLEET_HANG_S)
            state["hang_t"] = time.time()
            state["seated_queued"] = [hb["active"], hb["queue_depth"]]
        if not busy:
            time.sleep(0.002)


def held_ticker(engine, stop, state):
    """Replica 2's tick loop in a preempting run (its engine's own ticks,
    as :func:`hang_ticker`'s): from the moment the traffic is all offered
    it ticks until lanes are seated and requests queued, then ticks no
    more until the preemption's drain is decided, and after it serves on
    until the run stops. The preemption lands after replica 1's hang
    verdict, about FLEET_INFLIGHT_MS into the traffic, when graphed
    replicas left free to tick would have finished their share; held
    between ticks (no step in flight, so no hang verdict), replica 2 still
    has work for the drain to move, however fast the replicas serve."""
    state["offered"].wait(FLEET_WAIT_S)
    while not stop.is_set():
        if "held" in state and not state["drained"].is_set():
            state["drained"].wait(0.01)
            continue
        busy = engine.tick()
        hb = engine.heartbeat()
        if "held" not in state and hb["active"] and hb["queue_depth"]:
            state["held"] = [hb["active"], hb["queue_depth"]]
        if not busy:
            time.sleep(0.002)


def check_fleet_run(label, wl, outs, post_warmup_signatures, launches,
                    layers, prefills):
    """A decode fleet's run: every request complete with its token count,
    no signature met after warmup, and #3 launched ``layers`` times a
    prefill and never in a tick."""
    check([len(o) for o in outs] == [n for _, n in wl],
          f"fleet {label}: a request did not complete with its token count")
    check(post_warmup_signatures == 0,
          f"fleet {label}: traffic met {post_warmup_signatures} signatures "
          f"warmup did not")
    want = {"flash_attention_fwd": layers * prefills}
    check(launches == want, f"fleet {label}: launches {launches}, want "
                            f"{want} ({layers} a prefill, none a tick)")


def decode_fleet(np, torch, smi, model, wl, sampling, replicas, label,
                 draft=None, scripted=True, preempt=False):
    """A supervised ``MultiDecodeEngine`` over ``replicas`` copies of
    ``model`` on the one card, the workload offered all at once (request
    i seeded 1000 + i where sampled), its engines warmed and the launch
    counts zeroed just before the traffic, in which replica 1 hangs: in a
    step (``scripted``, :func:`hang_ticker`) or wherever it is once the
    traffic is offered. After the failover verdict, where ``preempt``,
    replica 2, held between ticks with work (:func:`held_ticker`), gets a
    preemption notice. Returns (record, streams)."""
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving import MultiDecodeEngine
    fleet = MultiDecodeEngine(
        model, devices=["cuda:0"] * replicas, slots=GEN_SLOTS, page=32,
        factor=2.0, max_len=GEN_MAX_LEN, prompt_buckets=GEN_PROMPT_BUCKETS,
        queue_depth=len(wl) + 8, shed=False, draft_model=draft,
        spec_k=SPEC_K, supervise=True,
        supervisor_interval_s=FLEET_SUPERVISOR_S,
        inflight_timeout_ms=FLEET_INFLIGHT_MS,
        breaker_cooldown_s=FLEET_COOLDOWN_S,
        restart_after_s=FLEET_COOLDOWN_S, start=not scripted)
    stop, tickers = threading.Event(), []
    state = {"offered": threading.Event(), "drained": threading.Event()}
    try:
        fresh = fleet.warmup()
        execs = [e.executables() for e in fleet.engines]
        spies = [spy_moves(e) for e in fleet.engines]
        done_at = [None] * len(wl)
        if scripted:
            loops = {1: hang_ticker, **({2: held_ticker} if preempt else {})}
            for i, e in enumerate(fleet.engines):
                if i not in loops:
                    e.start()
            for i, loop in loops.items():
                tickers.append(threading.Thread(
                    target=loop, args=(fleet.engines[i], stop, state)))
                tickers[-1].start()
        kernels.reset_launches()
        t0 = time.perf_counter()
        futs = []
        for i, (p, n) in enumerate(wl):
            f = fleet.submit(p, max_new_tokens=n, sampling=sampling,
                             seed=(GEN_SEED_BASE + i) if sampling else None)
            f.add_done_callback(
                lambda _f, i=i: done_at.__setitem__(i, time.time()))
            futs.append(f)
        if not scripted:
            # at replica 1's next fault site: a prefill's or a step's
            state["spec"] = faults.inject("replica_hang", replica=1,
                                          delay=FLEET_HANG_S)
            state["hang_t"] = time.time()
        state["offered"].set()
        decided = lambda kind: kind in [  # noqa: E731
            d["decision"] for d in fleet.supervisor.decisions]
        wait_for(lambda: decided("failover"), "the failover verdict")
        # replica 1 is hung: what it completes from here on, the hang
        # stranded
        completed_at_verdict = fleet.engines[1].stats()["completed"]
        # the supervisor's probe of the hung replica: its step on the
        # card, on a side thread, while the replica's tick is wedged
        t_probe = time.perf_counter()
        state["probe"] = fleet.engines[1].probe(timeout_s=FLEET_WAIT_S)
        state["probe_s"] = time.perf_counter() - t_probe
        state["probe_while_hung"] = \
            fleet.engines[1].heartbeat()["inflight_age_s"] is not None
        if preempt:
            wait_for(lambda: "held" in state, "replica 2 held with work")
            faults.inject("preempt_replica", replica=2, times=1)
            wait_for(lambda: decided("drain"), "replica 2's drain")
            state["drained"].set()
        outs = [[int(t) for t in f.result(timeout=600)] for f in futs]
        wall_s = time.perf_counter() - t0
        # the hung tick wakes and ends before the fleet closes
        stop.set()
        for ticker in tickers:
            ticker.join(FLEET_HANG_S + FLEET_WAIT_S)
            check(not ticker.is_alive(), f"fleet {label}: a scripted "
                                         f"replica's tick did not end")
        launches = {k: v for k, v in kernels.launches.items() if v}
        st = fleet.stats()
        after = [e.executables() for e in fleet.engines]
        decisions = list(fleet.supervisor.decisions)
    finally:
        stop.set()
        faults.clear()
        fleet.close(drain=False, timeout=10.0)
    layers = model.layers + (draft.layers if draft is not None else 0)
    prefills = sum(r["prefills"] for r in st["replicas"])
    check_fleet_run(label, wl, outs, sum(
        (a[0] - b[0]) + (a[1] - b[1]) for a, b in zip(after, execs)),
        launches, layers, prefills)
    tokens = sum(len(o) for o in outs)
    idx = {id(f): i for i, f in enumerate(futs)}
    moved = [log["disown_inflight"] + log["steal_pending"] for log in spies]
    verdict = next(d for d in decisions if d["decision"] == "failover")
    hung = [idx[id(r.future)] for r in moved[1]]
    stranded = st["replicas"][1]["completed"] - completed_at_verdict
    check(state["spec"].fired == 1 and verdict["moved"] == len(hung)
          and (hung or stranded),
          f"fleet {label}: the hang fired {state['spec'].fired} times, "
          f"moved {len(hung)}, stranded {stranded}")
    # a scripted hang moves seated lanes and queued requests both
    inflight = len(spies[1]["disown_inflight"])
    check(not scripted or 0 < inflight < len(hung),
          f"fleet {label}: the hang moved {inflight} seated of {len(hung)}")
    check(not preempt or (st["draining_replicas"] == 1
                          and len(moved[2]) > 0),
          f"fleet {label}: replica 2's drain moved nothing")
    check(state["probe"] is True and state["probe_while_hung"],
          f"fleet {label}: the probe of the hung replica gave "
          f"{state['probe']} (while hung: {state['probe_while_hung']})")
    rec = dict(phase="fleet_decode", case=label, card=smi,
               replicas=replicas, sampling=sampling, requests=len(wl),
               hang="in a step" if scripted else "where it fell",
               tokens=tokens, wall_s=wall_s, tokens_per_s=tokens / wall_s,
               prefills=prefills, launches=launches,
               warmed_signatures=fresh,
               routed=[r["submitted"] for r in st["replicas"]],
               ticks=[r["ticks"] for r in st["replicas"]],
               breakers=st["breakers"], failovers=st["failovers"],
               draining=st["draining_replicas"],
               moved=[len(m) for m in moved],
               moved_inflight=[len(log["disown_inflight"])
                               for log in spies],
               stranded=stranded,
               seated_queued_at_hang=state.get("seated_queued"),
               seated_queued_at_preempt=state.get("held"),
               decisions=[dict(d, t=round(d["t"] - verdict["t"], 4))
                          for d in decisions],
               failover_s=(max(done_at[i] for i in hung) - verdict["t"]
                           if hung else None),
               # scripted: from the hang's injection at a tick boundary;
               # free: from its injection, which fires at replica 1's
               # next fault site
               hang_to_verdict_s=verdict["t"] - state["hang_t"],
               probe_while_hung_s=state["probe_s"])
    emit(rec)
    return rec, outs


def fleet_phase(np, torch, smi, seed, reqs, outs32, gen13, spec14):
    """Phase 16: the BERT fleet, then the decode fleets: phase 13's sampled
    traffic over 1, 2 and 3 replicas, again over 3 with a hang and a
    preemption under the supervisor, and phase 14's pair at k = 8, greedy,
    over 2 replicas with a hang; every stream held to the single engine's
    of phases 13 and 14, each departure counted and a near-tie."""
    from paddle_tpu_torch.serving import demo_model, demo_spec_pair
    from paddle_tpu_torch.tools import decode_loadgen as LG
    t0 = time.perf_counter()
    bert = bert_fleet(np, torch, smi, seed, reqs, outs32)
    model = demo_model(**GEN_MODEL)
    wl = gen13["workload"]
    clean = gen13["outs"]["sampled", "continuous"]
    runs, departures = {}, {}
    for n in DECODE_FLEET_REPLICAS:
        label = f"sampled_x{n}"
        runs[n] = r = LG.run_fleet(model, wl, n, GEN_SLOTS, GEN_MAX_LEN,
                                   GEN_PROMPT_BUCKETS, sampling=GEN_SAMPLING,
                                   seed_base=GEN_SEED_BASE)
        outs = r.pop("outputs")
        check_fleet_run(label, wl, outs, r["post_warmup_signatures"],
                        r["launches"], model.layers, sum(r["prefills"]))
        emit(dict(phase="fleet_decode", case=label, card=smi, **r))
        departures[n] = handoff_departures(torch, model, wl, clean, outs,
                                           GEN_SAMPLING)
    chaos, outs = decode_fleet(np, torch, smi, model, wl, GEN_SAMPLING, 3,
                               "sampled_hang_preempt", preempt=True)
    departures["chaos"] = handoff_departures(torch, model, wl, clean, outs,
                                             GEN_SAMPLING)
    check(chaos["failovers"] == 1 and chaos["breakers"][1] == "open",
          f"fleet: hang and preemption: {chaos}")
    free, outs = decode_fleet(np, torch, smi, model, wl, GEN_SAMPLING, 3,
                              "sampled_hang_free", scripted=False)
    departures["free"] = handoff_departures(torch, model, wl, clean, outs,
                                            GEN_SAMPLING)
    check(free["failovers"] == 1 and free["breakers"][1] == "open",
          f"fleet: the free hang: {free}")
    target, draft = demo_spec_pair(**LG.SPEC_PAIR, max_len=GEN_MAX_LEN)
    spec, outs = decode_fleet(np, torch, smi, target, spec14["workload"],
                              None, 2, "spec_greedy_hang", draft=draft)
    departures["spec"] = spec_departures(
        np, torch, target, spec14["workload"],
        spec14["outs"]["plain", "greedy"], outs, None)
    check(spec["failovers"] == 1, f"fleet: the pair's hang: {spec}")
    emit(dict(
        phase="fleet_summary", card=smi,
        decode_tokens_per_s={n: r["tokens_per_s"] for n, r in runs.items()},
        decode_speedup_x={n: r["tokens_per_s"] / runs[1]["tokens_per_s"]
                          for n, r in runs.items()},
        decode_wall_ms_per_tick={n: r["wall_ms_per_tick"]
                                 for n, r in runs.items()},
        failover_s={"sampled": chaos["failover_s"],
                    "sampled_free": free["failover_s"],
                    "spec_greedy": spec["failover_s"]},
        hang_to_verdict_s={"sampled": chaos["hang_to_verdict_s"],
                           "sampled_free": free["hang_to_verdict_s"],
                           "spec_greedy": spec["hang_to_verdict_s"]},
        decisions={"bert": [d["decision"] for d in bert["decisions"]],
                   "sampled": [d["decision"] for d in chaos["decisions"]],
                   "sampled_free": [d["decision"] for d in
                                    free["decisions"]],
                   "spec_greedy": [d["decision"] for d in
                                   spec["decisions"]]},
        breakers={"bert": bert["breakers"], "sampled": chaos["breakers"],
                  "sampled_free": free["breakers"],
                  "spec_greedy": spec["breakers"]},
        moved={"sampled": chaos["moved"], "sampled_free": free["moved"],
               "spec_greedy": spec["moved"]},
        moved_inflight={"sampled": chaos["moved_inflight"],
                        "sampled_free": free["moved_inflight"],
                        "spec_greedy": spec["moved_inflight"]},
        stranded={"sampled": chaos["stranded"],
                  "sampled_free": free["stranded"],
                  "spec_greedy": spec["stranded"]},
        departures={k: len(v) for k, v in departures.items()},
        departure_detail={k: v for k, v in departures.items() if v},
        bert_hedged=[bert["hedged"], bert["hedge_budget"] * bert[
            "submitted"]],
        single_engine_tokens_per_s=gen13["runs"]["sampled", "continuous"][
            "tokens_per_s"],
        bert_qps=bert["qps"], bert_swap_s=bert["swap_s"],
        seconds=time.perf_counter() - t0))



# -- phase 17: CUDA graphs ------------------------------------------------------

GRAPH_INNER = 2              # BERT steps a call (the bench's default is 8)
RESNET_GRAPH_INNER = 2
GRAPH_CALLS = 3              # held graph vs eager: 1 eager + capture, 2 replays
GRAPH_TIMED_CALLS = 2        # calls a turn, turns eager, graph, graph, eager
# graph vs eager training, the same kernels on the same state. Where no
# kernel of the path sums in a run-dependent order the two are bit-equal
# (``bit_equal``). PyTorch's embedding backward sums with atomics (the
# token-type table takes 8192 rows into 2 a step), so two eager trainers
# part too (``eager_vs_eager``, measured in the same call), and where a
# gradient is rounding noise Adam then steps the element by lr one way or
# the other: BERT is held as the f32 step check holds it, the losses as
# |diff| / max(1, |eager|) and every parameter within 2 lr a step;
# ResNet-50 (Momentum, no such sign) by the whole update's relative L2
GRAPH_LOSS_TOL = 1e-3
GRAPH_UPDATE_TOL = 1e-2
BERT_LR = 1e-4               # tools/bench_bert's AdamW
PREDICT_BATCH, PREDICT_SEQ = 32, 128
PREDICT_ITERS = 10


def call_profile(torch, call):
    """One ``call()`` (warmed once) under ``torch.profiler``: its host wall
    time to the sync, its CUDA-event time, the device's busy time and idle
    share over it, its device events, and the port's kernel launches it
    counted."""
    from paddle_tpu_torch.ops import kernels
    call()
    torch.cuda.synchronize()
    kernels.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, n = 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += e.time_range.elapsed_us() / 1e3
            n += 1
    event_ms = start.elapsed_time(end)
    return dict(wall_ms=wall, event_ms=event_ms, busy_ms=busy,
                idle_share=1.0 - busy / event_ms, device_events=n,
                port_launches=sum(kernels.launches.values()))


def update_gap(torch, after, ref, before):
    """The relative L2 gap between two updates of one model: parameters
    ``after`` and ``ref`` less ``before``, over all of them."""
    num = den = 0.0
    for a, r, b in zip(after, ref, before):
        a, r = a.detach(), r.detach()
        num += float(((a - r).double() ** 2).sum())
        den += float(((r - b).double() ** 2).sum())
    return (num / den) ** 0.5 if den else 0.0


def held_gap(torch, got, want, after, ref, before):
    """Two runs of one training from the same state: their losses'
    largest |diff| / max(1, |ref|), their parameters' largest |diff|,
    their updates' relative L2 gap, and whether all are bit-equal."""
    return dict(
        bit_equal=torch.equal(got, want) and all(
            torch.equal(a, r) for a, r in zip(after, ref)),
        loss_max_err=((got - want).abs() /
                      want.abs().clamp_min(1.0)).max().item(),
        param_max_abs_err=max((a - r).abs().max().item()
                              for a, r in zip(after, ref)),
        update_rel_l2=update_gap(torch, after, ref, before))


def graph_training(np, torch, smi, label, make, per_step, unit, adam_lr):
    """``make()`` builds a seeded trainer (the same weights each time): two
    step eagerly (the control) and one through ``jit.to_static``'s graph,
    from the same state, and are held together; then the graph and an
    eager arm are timed in turns and one call of each is profiled.
    ``per_step`` items (tokens, images) a step; ``adam_lr``, the Adam
    learning rate that bounds a parameter's step (None for Momentum)."""
    from paddle_tpu_torch.ops import kernels
    gc.collect()
    torch.cuda.empty_cache()
    eager, other, graph = make(), make(), make()
    inner = graph.inner
    # to_static creates every slot (and the arena) before its first step:
    # every arm starts from that layout
    for tr in (eager, other, graph):
        tr.opt._ensure_all_slots()
    before = [p.detach().clone() for p in eager.model.parameters()]
    again = torch.cat([other.eager_step(*other.data)
                       for _ in range(GRAPH_CALLS)])
    kernels.reset_launches()
    want = torch.cat([eager.eager_step(*eager.data)
                      for _ in range(GRAPH_CALLS)])
    torch.cuda.synchronize()
    eager_launches = dict(kernels.launches)
    ref = list(eager.model.parameters())
    control = held_gap(torch, again, want, list(other.model.parameters()),
                       ref, before)
    del other
    kernels.reset_launches()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    got = [graph.step(*graph.data)]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    pool_bytes = torch.cuda.memory_reserved() - reserved
    got += [graph.step(*graph.data) for _ in range(GRAPH_CALLS - 1)]
    torch.cuda.synchronize()
    graph_launches = dict(kernels.launches)
    got = torch.cat(got)
    (entry,) = graph.step._cache.values()
    check(entry.graph is not None and entry.replays == GRAPH_CALLS - 1,
          f"graphs ({label}): the step did not replay a captured graph")
    check(graph_launches == eager_launches,
          f"graphs ({label}): the graphed calls counted {graph_launches}, "
          f"the eager ones {eager_launches}")
    held = held_gap(torch, got, want, list(graph.model.parameters()), ref,
                    before)
    del before, ref
    param_tol = None if adam_lr is None else \
        2 * adam_lr * GRAPH_CALLS * inner
    check(bool(torch.isfinite(got).all())
          and held["loss_max_err"] <= GRAPH_LOSS_TOL
          and (held["param_max_abs_err"] <= param_tol if param_tol
               else held["update_rel_l2"] <= GRAPH_UPDATE_TOL),
          f"graphs ({label}): graph vs eager {held}; two eager runs "
          f"{control}")
    times = {"eager": [], "graph": []}
    for arm in ("eager", "graph", "graph", "eager"):
        tr = eager if arm == "eager" else graph
        fn = tr.eager_step if arm == "eager" else tr.step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GRAPH_TIMED_CALLS):
            out = fn(*tr.data)
        out[-1].item()
        times[arm].append((time.perf_counter() - t0) * 1e3 /
                          (GRAPH_TIMED_CALLS * inner))
    prof = {"eager": call_profile(torch, lambda: eager.eager_step(
        *eager.data)), "graph": call_profile(torch, lambda: graph.step(
            *graph.data))}
    rec = dict(phase="graphs_train", case=label, card=smi, inner=inner,
               calls_held=GRAPH_CALLS, eager_vs_eager=control, **held,
               loss_tol=GRAPH_LOSS_TOL, param_tol=param_tol,
               update_tol=None if param_tol else GRAPH_UPDATE_TOL,
               port_launches_per_step={k: v // (GRAPH_CALLS * inner)
                                       for k, v in graph_launches.items()
                                       if v},
               first_call_s=first_s, pool_reserved_bytes=pool_bytes,
               capture_launches=entry.launches)
    for arm in ("eager", "graph"):
        step_ms = statistics.median(times[arm])
        p = prof[arm]
        rec[arm] = dict(step_ms=step_ms, step_ms_turns=times[arm],
                        **{f"{unit}_per_s": per_step / step_ms * 1e3},
                        call_wall_ms=p["wall_ms"],
                        call_device_ms=p["event_ms"],
                        call_busy_ms=p["busy_ms"],
                        idle_share=p["idle_share"],
                        device_events_per_step=p["device_events"] / inner,
                        port_launches_per_step=p["port_launches"] / inner)
    check(prof["graph"]["port_launches"] == prof["eager"]["port_launches"],
          f"graphs ({label}): a replay counted {prof['graph']} launches, "
          f"an eager call {prof['eager']}")
    emit(rec)
    del eager, graph, entry
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def graph_dropout(np, torch, FA, smi, gen, model):
    """Fresh dropout at every replay: a captured draw of the flash
    kernels' seed words and a forward at BERT's training shape, replayed
    twice; ``model`` (BERT-base with attention dropout alone) forward in
    train mode, replayed twice (and in eval mode, where replays agree)."""
    from paddle_tpu_torch import jit, random
    q = torch.randn(TRAIN_BATCH, 12, TRAIN_SEQ, 64, device="cuda",
                    generator=gen).to(torch.bfloat16)

    def draw(q):
        words = random.next_seed_words(q.device)
        out, _, _ = FA.flash_attention_fwd(q, q, q, dropout_p=DROPOUT_P,
                                           seed=words)
        return words, out

    f = jit.to_static(draw)
    f(q)
    (w1, o1), (w2, o2) = f(q), f(q)
    check(not torch.equal(w1, w2) and not torch.equal(o1, o2),
          "graphs: two replays drew the same flash seed words")
    bh = TRAIN_BATCH * 12
    masks_differ = not torch.equal(
        FA.dropout_keep_mask(w1, bh, TRAIN_SEQ, TRAIN_SEQ, DROPOUT_P,
                             "cuda"),
        FA.dropout_keep_mask(w2, bh, TRAIN_SEQ, TRAIN_SEQ, DROPOUT_P,
                             "cuda"))
    check(masks_differ, "graphs: two replays drew the same mask")
    errs = []
    for w, o in ((w1, o1), (w2, o2)):
        ref, _, _ = FA.flash_attention_fwd_plain(q, q, q,
                                                 dropout_p=DROPOUT_P, seed=w)
        errs.append(scaled_err(o, ref))
    check(max(errs) <= KERNEL_TOL["bfloat16"],
          f"graphs: a replay's flash output is {errs} from the plain "
          f"version at its words")
    ids = torch.randint(0, 30522, (8, TRAIN_SEQ), device="cuda",
                        generator=gen)
    fwd = jit.to_static(lambda ids: model(ids)[0], models=[model])
    fwd(ids)
    train_differ = not torch.equal(fwd(ids), fwd(ids))
    model.eval()
    fwd(ids)
    eval_equal = torch.equal(fwd(ids), fwd(ids))
    check(train_differ and eval_equal,
          f"graphs: BERT-base replays with attention dropout differ "
          f"{train_differ}, without {not eval_equal}")
    rec = dict(phase="graphs_dropout", card=smi, words=[w1.tolist(),
                                                        w2.tolist()],
               masks_differ=masks_differ, replay_vs_plain_err=errs,
               tol=KERNEL_TOL["bfloat16"],
               bert_train_replays_differ=train_differ,
               bert_eval_replays_equal=eval_equal)
    emit(rec)
    del fwd
    return rec


def graph_predictor(np, torch, smi, seed, label, config, model):
    """BERT-base ``model`` behind a ``Predictor`` at batch 32, seq 128: a
    replay of its captured signature against the served module's eager
    forward, and both timed."""
    from paddle_tpu_torch.inference import Predictor
    pred = Predictor(model.eval(), config)
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 30522, (PREDICT_BATCH, PREDICT_SEQ)).astype("int32")
    tt = (rng.rand(PREDICT_BATCH, PREDICT_SEQ) < 0.5).astype("int32")
    lens = rng.randint(16, PREDICT_SEQ + 1, PREDICT_BATCH)
    mask = (np.arange(PREDICT_SEQ)[None, :] < lens[:, None]).astype("int32")
    dev = [torch.from_numpy(a).cuda() for a in (ids, tt, mask)]
    pred.warmup([((PREDICT_BATCH, PREDICT_SEQ), "int32")] * 3)
    check(pred.captures == 1 and len(pred._compiled) == 1,
          f"graphs ({label}): warmup captured {pred.captures} graphs")
    got = pred.run_device(*dev)

    def eager():
        with torch.inference_mode():
            return pred.model(*dev)

    want = eager()
    err = max(scaled_err(a, b) for a, b in zip(got, want))
    check(err <= KERNEL_TOL[label],
          f"graphs ({label}): Predictor replay vs eager error {err}")
    ms = {}
    for arm, call in (("graph", lambda: pred.run_device(*dev)),
                      ("eager", eager)):
        ms[arm] = _event_ms(torch, lambda: [call() for _ in range(
            PREDICT_ITERS)], PREDICT_ITERS, 3)
    prof = {"graph": call_profile(torch, lambda: pred.run_device(*dev)),
            "eager": call_profile(torch, eager)}
    want_launches = sum(LAUNCHES_PER_BATCH.values())
    check(prof["graph"]["port_launches"] == want_launches ==
          prof["eager"]["port_launches"],
          f"graphs ({label}): a replay counted "
          f"{prof['graph']['port_launches']} port launches, want "
          f"{want_launches}")
    check(pred.captures == 1, f"graphs ({label}): a call captured again")
    rec = dict(phase="graphs_predict", precision=label, card=smi,
               batch=PREDICT_BATCH, seq=PREDICT_SEQ, max_scaled_err=err,
               tol=KERNEL_TOL[label], forward_ms=ms, profile=prof)
    emit(rec)
    del pred
    return rec


def graphs_phase(np, torch, FA, smi, seed, gen, rec32, rec16):
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.tools import bench_bert, bench_resnet
    t0 = time.perf_counter()
    no_dropout = dict(hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    recs = {"bert_default": graph_training(
        np, torch, smi, "bert_default", lambda: bench_bert.Trainer(
            TRAIN_BATCH, TRAIN_SEQ, GRAPH_INNER, **no_dropout),
        tokens, "tokens", BERT_LR)}
    kernels.configure(softmax_xent=True, fused_adam_multi=True)
    try:
        recs["bert_kernels"] = graph_training(
            np, torch, smi, "bert_kernels", lambda: bench_bert.Trainer(
                TRAIN_BATCH, TRAIN_SEQ, GRAPH_INNER,
                opt_kw=dict(flat_arena=True), token_types=True,
                **no_dropout), tokens, "tokens", BERT_LR)
    finally:
        kernels.configure(softmax_xent=None, fused_adam_multi=None)
    kernels.configure(batch_norm=True)
    try:
        recs["resnet_kernels"] = graph_training(
            np, torch, smi, "resnet_kernels", lambda: bench_resnet.Trainer(
                RESNET_BATCH, RESNET_GRAPH_INNER, "NHWC",
                size=RESNET_SIZE), RESNET_BATCH, "images", None)
    finally:
        kernels.configure(batch_norm=None)
    # one BERT-base, attention dropout alone, for the dropout check and then
    # (in eval mode, where dropout is off) behind the Predictors
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.inference import Config
    from paddle_tpu_torch.models import Bert, BertConfig
    ptt.seed(seed)
    bert = Bert(BertConfig.base(hidden_dropout_prob=0.0)).to("cuda")
    drop = graph_dropout(np, torch, FA, smi, gen, bert)
    pred = {"float32": graph_predictor(np, torch, smi, seed, "float32",
                                       None, bert),
            "bfloat16": graph_predictor(np, torch, smi, seed, "bfloat16",
                                        Config().enable_bf16(), bert)}
    del bert
    emit(dict(phase="graphs", card=smi, seconds=time.perf_counter() - t0,
              train={k: dict(eager_step_ms=r["eager"]["step_ms"],
                             graph_step_ms=r["graph"]["step_ms"],
                             graph_idle_share=r["graph"]["idle_share"],
                             eager_idle_share=r["eager"]["idle_share"],
                             bit_equal=r["bit_equal"],
                             eager_vs_eager_bit_equal=r["eager_vs_eager"][
                                 "bit_equal"],
                             update_rel_l2=r["update_rel_l2"])
                     for k, r in recs.items()},
              dropout_words_differ=True,
              predict={k: r["forward_ms"] for k, r in pred.items()},
              serve_qps={"float32": rec32["qps"], "bfloat16": rec16["qps"]},
              serve_p50_ms={"float32": rec32["p50_ms"],
                            "bfloat16": rec16["p50_ms"]},
              flash_words=drop["words"]))


# -- phase 18: the decode engine's steps as CUDA graphs -----------------------

# graph against eager: each run of phase 13's traffic (greedy and sampled,
# continuous and drain) and of phase 14's sampled A/B (plain and drafted at
# k = 8) in both arms, in turns graph, eager, eager, graph (a host-bound
# number drifts within a call: the order cancels a steady drift)
DECODE_ARMS = ("graph", "eager", "eager", "graph")
# a decode fleet's weight swap: replicas, and requests after it
DECODE_SWAP_REPLICAS, DECODE_SWAP_REQUESTS = 2, 16


def graph_ab(np, torch, smi, model, wl, mode, sampling, label, draft=None):
    """``wl`` through ``run_load`` in each arm in turns: each graphed run
    must replay an executable every tick and admission and capture none
    after warmup, every run launch the flash kernel once a layer a prefill
    and nothing else, and the graphed streams equal the eager ones, each
    departure counted and a near-tie of the card's teacher-forced logits.
    Returns (each arm's runs, the departures)."""
    from paddle_tpu_torch.tools.decode_loadgen import run_load
    layers = model.layers + (draft.layers if draft is not None else 0)
    runs, outs = {"graph": [], "eager": []}, {}
    for arm in DECODE_ARMS:
        r = run_load(model, mode, wl, GEN_SLOTS, GEN_MAX_LEN,
                     GEN_PROMPT_BUCKETS, sampling=sampling,
                     seed_base=GEN_SEED_BASE if sampling else None,
                     draft=draft, spec_k=SPEC_K, arm=arm)
        got = [[int(t) for t in o] for o in r.pop("outputs")]
        r.pop("records", None)
        check(r["failed"] == 0 and [len(o) for o in got] ==
              [n for _, n in wl], f"graphs {label} {arm}: a request did "
                                  f"not complete with its token count")
        check(r["post_warmup_signatures"] == 0
              and r["post_warmup_captures"] == 0,
              f"graphs {label} {arm}: {r['post_warmup_signatures']} "
              f"signatures and {r['post_warmup_captures']} captures after "
              f"warmup")
        want = {"flash_attention_fwd": layers * r["prefills"]}
        check(r["prefills"] == len(wl) and r["launches"] == want,
              f"graphs {label} {arm}: launches {r['launches']}, want "
              f"{want} ({layers} a prefill, none a tick)")
        if arm == "graph":
            check(r["tick_replays"] == r["ticks"] > 0
                  and r["prefill_replays"] == r["prefills"]
                  and r["draft_prefill_replays"] == (
                      r["prefills"] if draft is not None else 0)
                  and r["warmup_captures"] > 0,
                  f"graphs {label}: {r['tick_replays']} tick replays for "
                  f"{r['ticks']} ticks, {r['prefill_replays']} prefill "
                  f"replays for {r['prefills']} prefills")
        else:
            check(r["warmup_captures"] == r["tick_replays"] == 0,
                  f"graphs {label}: the eager arm captured or replayed")
        if arm in outs:
            check(got == outs[arm], f"graphs {label} {arm}: two runs of "
                                    f"one arm differ")
        outs[arm] = got
        runs[arm].append(r)
    if draft is None:
        deps = handoff_departures(torch, model, wl, outs["eager"],
                                  outs["graph"], sampling)
    else:
        deps = spec_departures(np, torch, model, wl, outs["eager"],
                               outs["graph"], sampling)
    med = {arm: statistics.median(r["tokens_per_s"] for r in rs)
           for arm, rs in runs.items()}
    g, e = runs["graph"][0], runs["eager"][0]
    rec = dict(phase="decode_graphs", case=label, card=smi, mode=mode,
               sampling=sampling, requests=len(wl),
               tokens_per_s={arm: [r["tokens_per_s"] for r in rs]
                             for arm, rs in runs.items()},
               tokens_per_s_median=med,
               graph_speedup_x=med["graph"] / med["eager"],
               latency_p50_ms=[g["latency_p50_ms"], e["latency_p50_ms"]],
               latency_p99_ms=[g["latency_p99_ms"], e["latency_p99_ms"]],
               ticks=g["ticks"], tick_replays=g["tick_replays"],
               prefills=g["prefills"], prefill_replays=g["prefill_replays"],
               warmup_s={arm: [r["warmup_s"] for r in rs]
                         for arm, rs in runs.items()},
               warmup_captures=g["warmup_captures"],
               reserved_bytes=[g["reserved_bytes"], e["reserved_bytes"]],
               graph_pool_bytes=[g["graph_pool_bytes"],
                                 e["graph_pool_bytes"]],
               arena_bytes=g["arena_bytes"], launches=g["launches"],
               departures=deps)
    if draft is not None:
        rec.update(accept_rate=[g["accept_rate"], e["accept_rate"]])
    emit(rec)
    return runs, deps


def decode_swap(np, torch, smi, model, wl):
    """A warmed ``MultiDecodeEngine`` of phase 13's model over
    :data:`DECODE_SWAP_REPLICAS` replicas swaps to a second seed's weights:
    each replica captures its executables over the new module before it
    binds it; then traffic, under which nothing captures and no signature
    is met, and whose streams equal a single engine's on the new
    weights."""
    from paddle_tpu_torch.serving import MultiDecodeEngine, demo_model
    from paddle_tpu_torch.tools.decode_loadgen import run_load
    other = demo_model(**dict(GEN_MODEL, seed=GEN_MODEL["seed"] + 1))
    fleet = MultiDecodeEngine(
        model, devices=["cuda:0"] * DECODE_SWAP_REPLICAS, slots=GEN_SLOTS,
        page=32, factor=2.0, max_len=GEN_MAX_LEN,
        prompt_buckets=GEN_PROMPT_BUCKETS, queue_depth=GEN_REQUESTS + 8,
        shed=False, supervise=False)
    wl = wl[:DECODE_SWAP_REQUESTS]
    try:
        t0 = time.perf_counter()
        fleet.warmup()
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        caps0 = [e.captures for e in fleet.engines]
        held = [len(e._graphs.entries) for e in fleet.engines]
        t0 = time.perf_counter()
        version = fleet.swap_weights(other.state)
        swap_s = time.perf_counter() - t0
        caps1 = [e.captures for e in fleet.engines]
        execs = [e.executables() for e in fleet.engines]
        futs = [fleet.submit(p, max_new_tokens=n) for p, n in wl]
        outs = [[int(t) for t in f.result(timeout=600)] for f in futs]
        caps2 = [e.captures for e in fleet.engines]
        after = [e.executables() for e in fleet.engines]
    finally:
        fleet.close(drain=False, timeout=10.0)
    check(version == 1 and [b - a for a, b in zip(caps0, caps1)] == held,
          f"decode swap: captured {[b - a for a, b in zip(caps0, caps1)]} "
          f"over the new weights, the replicas hold {held}")
    check(caps2 == caps1 and after == execs,
          f"decode swap: captures {caps1} -> {caps2}, signatures {execs} -> "
          f"{after} under the traffic after the swap")
    want = [[int(t) for t in o] for o in run_load(
        other, "continuous", wl, GEN_SLOTS, GEN_MAX_LEN, GEN_PROMPT_BUCKETS)
        ["outputs"]]
    deps = handoff_departures(torch, other, wl, want, outs, None)
    rec = dict(phase="decode_swap", card=smi,
               replicas=DECODE_SWAP_REPLICAS, warmup_s=warmup_s,
               warmup_captures=caps0, swap_s=swap_s,
               swap_captures=[b - a for a, b in zip(caps0, caps1)],
               requests=len(wl), departures=deps)
    emit(rec)
    return rec


def decode_graphs_phase(np, torch, smi, seed, gen13, spec14):
    """Phase 18: the decode engine's executables as CUDA graphs against
    its eager arm (``decode_loadgen.EagerEngine``): phase 13's traffic
    and phase 14's sampled A/B in turns, the four ticks profiled in both
    arms, the 1/2/3-replica fleet under the profiler, and a decode fleet's
    weight swap."""
    from paddle_tpu_torch.serving import demo_model, demo_spec_pair
    from paddle_tpu_torch.tools import decode_loadgen as LG
    t0 = time.perf_counter()
    model = demo_model(**GEN_MODEL)
    wl = gen13["workload"]
    ab, deps = {}, {}
    for kind, sampling in (("greedy", None), ("sampled", GEN_SAMPLING)):
        for mode in ("continuous", "drain"):
            ab[kind, mode], deps[kind, mode] = graph_ab(
                np, torch, smi, model, wl, mode, sampling,
                f"{kind}_{mode}")
    target, draft = demo_spec_pair(**LG.SPEC_PAIR, max_len=GEN_MAX_LEN)
    swl = spec14["workload"]
    for arm, d in (("plain", None), ("spec", draft)):
        ab["pair", arm], deps["pair", arm] = graph_ab(
            np, torch, smi, target, swl, "continuous", SPEC_SAMPLING,
            f"pair_{arm}", draft=d)
    # the four ticks, in both arms
    ticks = {}
    for name, m, w, sampling, d in (
            ("greedy", model, wl, None, None),
            ("sampled", model, wl, GEN_SAMPLING, None),
            ("plain_8_layers", target, swl, SPEC_SAMPLING, None),
            ("spec_k8", target, swl, SPEC_SAMPLING, draft)):
        for arm in ("graph", "eager"):
            t = LG.profile_decode(m, w, GEN_SLOTS, GEN_MAX_LEN,
                                  GEN_PROMPT_BUCKETS, sampling=sampling,
                                  draft=d, spec_k=SPEC_K, arm=arm)
            check(t["tick_replays"] == (2 * t["ticks"] + 1
                                        if arm == "graph" else 0),
                  f"graphs tick {name} {arm}: {t['tick_replays']} replays "
                  f"in {2 * t['ticks'] + 1} ticks")
            t.pop("events")
            ticks[name, arm] = t
            emit(dict(t, phase="decode_graphs_tick", case=name, card=smi))
    # the decode fleet over 1, 2 and 3 replicas, profiled
    fleet = {}
    for n in DECODE_FLEET_REPLICAS:
        r = LG.run_fleet(model, wl, n, GEN_SLOTS, GEN_MAX_LEN,
                         GEN_PROMPT_BUCKETS, sampling=GEN_SAMPLING,
                         seed_base=GEN_SEED_BASE, profile=True)
        outs = r.pop("outputs")
        check_fleet_run(f"graphs_x{n}", wl, outs, r["post_warmup_signatures"],
                        r["launches"], model.layers, sum(r["prefills"]))
        fleet[n] = r
        emit(dict(phase="decode_graphs_fleet", card=smi, **r))
    swap = decode_swap(np, torch, smi, model, wl)

    def med(key, arm):
        return statistics.median(r["tokens_per_s"] for r in ab[key][arm])

    emit(dict(
        phase="decode_graphs_summary", card=smi,
        tokens_per_s={f"{k[0]}_{k[1]}": [med(k, "graph"), med(k, "eager")]
                      for k in ab},
        spec_speedup_x=[med(("pair", "spec"), arm)
                        / med(("pair", "plain"), arm)
                        for arm in ("graph", "eager")],
        tick_ms={f"{n}_{a}": t["tick_ms"] for (n, a), t in ticks.items()},
        tick_busy_ms={f"{n}_{a}": t["busy_ms_per_tick"]
                      for (n, a), t in ticks.items()},
        tick_idle_share={f"{n}_{a}": t["idle_share"]
                         for (n, a), t in ticks.items()},
        tick_launches={f"{n}_{a}": t["launches_per_tick"]
                       for (n, a), t in ticks.items()},
        fleet_tokens_per_s={n: r["tokens_per_s"] for n, r in fleet.items()},
        fleet_idle_share={n: r["idle_share"] for n, r in fleet.items()},
        warmup_captures={f"{k[0]}_{k[1]}": ab[k]["graph"][0][
            "warmup_captures"] for k in ab},
        warmup_s={f"{k[0]}_{k[1]}": [ab[k]["graph"][0]["warmup_s"],
                                      ab[k]["eager"][0]["warmup_s"]]
                  for k in ab},
        swap_s=swap["swap_s"], swap_captures=swap["swap_captures"],
        departures={f"{k[0]}_{k[1]}": len(v) for k, v in deps.items()},
        seconds=time.perf_counter() - t0))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every record to this file")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, inputs and requests")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false); the port's kernels run only on one", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    try:
        import paddle_tpu_torch as ptt
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e}); run "
              f"it from the root of a checkout", file=sys.stderr)
        return 2
    if Path(ptt.__file__).resolve().parent.parent != HERE:
        print(f"chip_smoke: imported {ptt.__file__}, not the checkout's "
              f"port", file=sys.stderr)
        return 2
    from paddle_tpu_torch.inference import Config, Predictor
    from paddle_tpu_torch.models import Bert, BertConfig
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import batch_norm as BN
    from paddle_tpu_torch.ops.kernels import flash_attention as FA
    from paddle_tpu_torch.ops.kernels import fused_adam as FAD
    from paddle_tpu_torch.ops.kernels import layer_norm as LN
    from paddle_tpu_torch.ops.kernels import softmax_xent as SX

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device and build
    smi = nvidia_smi()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase="device", nvidia_smi=smi, kind=kind,
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0]))
    t0 = time.perf_counter()
    logs = kernels.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "Used" in ln or "spill" in ln or "Compiling" in ln]
             for name, log in logs.items()}
    build_s = time.perf_counter() - t0
    emit(dict(phase="build", seconds=build_s,
              flags=" ".join(kernels.NVCC_FLAGS), ptxas=ptxas,
              instances=build_report(kernels, logs)))

    # 2. kernels against their plain versions, at the path's shapes
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    warm_card(torch)
    ln = [layer_norm_case(torch, LN, dt, n, 768, TIMED_ITERS, gen)
          for n in (4096, 8192) for dt in ("float32", "bfloat16")]
    for n, d, offset in LN_OTHER:
        for dt in ("float32", "bfloat16"):
            layer_norm_case(torch, LN, dt, n, d, TIMED_ITERS, gen, offset)
    fa = [flash_case(torch, FA, *c, TIMED_ITERS, gen) for c in (
        ("bert_s128", "float32", 32, 12, 128, 64, "key", False),
        ("bert_s128", "bfloat16", 32, 12, 128, 64, "key", False),
        ("bert_s512", "float32", 4, 12, 512, 64, "key", False),
        ("causal", "float32", 4, 12, 512, 64, None, True),
        ("full_mask", "float32", 4, 12, 128, 64, "full", False),
        ("bool_fully_masked_row", "bfloat16", 4, 12, 128, 64, "bool",
         False),
        ("unaligned_s200", "float32", 4, 12, 200, 64, "key", False),
        ("head_dim_128", "bfloat16", 4, 8, 256, 128, None, False),
        ("causal", "bfloat16", 4, 12, 512, 64, None, True),
        ("unaligned_s200", "bfloat16", 4, 12, 200, 64, "key", False),
        ("full_mask", "bfloat16", 4, 12, 128, 64, "full", False))]
    fa += [flash_case(torch, FA, "q77_k200", "bfloat16", 4, 12, 77, 64,
                      "key", False, TIMED_ITERS, gen, sk=200),
           flash_case(torch, FA, "head_dim_128_causal_dropout", "bfloat16",
                      4, 8, 256, 128, None, True, TIMED_ITERS, gen,
                      dropout_p=DROPOUT_P)]
    # head dims the kernels run zero-padded, float16 through the float32
    # kernels, and masks the reference hands to sdpa under causal
    fa += [flash_case(torch, FA, *c, TIMED_ITERS, gen) for c in FLASH_OTHER]

    # 3. serving, f32
    ptt.seed(args.seed)
    model = Bert(BertConfig.base()).eval()
    check(len(model.encoder) == 12, "BertConfig.base() must have 12 layers")
    n_params = sum(p.numel() for p in model.parameters())
    cpu_model = copy.deepcopy(model)
    reqs = make_requests(np, args.seed)
    outs32, rec32 = serve(np, Predictor(model), reqs, "float32", smi)
    cpu = Predictor(cpu_model, device="cpu")
    small = [i for i in range(REQUESTS_128)
             if reqs[i][0].shape[0] <= 7][:3]
    errs = []
    for i in small:
        ref = cpu.run(*reqs[i])
        errs.append(max(float(np.abs(a - r).max())
                        for a, r in zip(outs32[i], ref)))
    check(len(small) == 3 and max(errs) <= SERVE_F32_TOL,
          f"f32 serving vs the CPU: errors {errs} > {SERVE_F32_TOL}")
    rec32.update(params=n_params, layers=len(model.encoder),
                 cpu_check_requests=small, cpu_max_abs_err=errs,
                 cpu_tol=SERVE_F32_TOL)
    emit(rec32)

    # 4. serving, bf16
    outs16, rec16 = serve(np, Predictor(model, Config().enable_bf16()),
                          reqs, "bfloat16", smi)
    rel = max(float(np.linalg.norm(a - r) / np.linalg.norm(r))
              for o16, o32 in zip(outs16, outs32) for a, r in zip(o16, o32))
    mx = max(float(np.abs(a - r).max())
             for o16, o32 in zip(outs16, outs32) for a, r in zip(o16, o32))
    check(rel <= SERVE_BF16_REL_TOL,
          f"bf16 serving vs f32: relative error {rel} > tolerance")
    rec16.update(vs_f32_max_rel_l2=rel, vs_f32_max_abs=mx,
                 tol_rel_l2=SERVE_BF16_REL_TOL)
    emit(rec16)

    # 5. the training kernels against their plain versions
    lnb = [layer_norm_bwd_case(torch, LN, dt, 8192, 768, TIMED_ITERS, gen)
           for dt in ("float32", "bfloat16")]
    for n, d, offset in LN_OTHER:
        for dt in ("float32", "bfloat16"):
            layer_norm_bwd_case(torch, LN, dt, n, d, TIMED_ITERS, gen,
                                offset)
    flash_case(torch, FA, "bert_s128_dropout", "bfloat16", 64, 12, 128, 64,
               "key", False, TIMED_ITERS, gen, dropout_p=DROPOUT_P,
               phase="train_kernel")
    fab = [flash_bwd_case(torch, FA, *c, TIMED_ITERS, gen) for c in (
        ("bert_s128_dropout", "bfloat16", 64, 12, 128, 64, "key", False,
         DROPOUT_P),
        ("bert_s128", "bfloat16", 64, 12, 128, 64, "key", False, 0.0),
        ("bert_s128", "float32", 64, 12, 128, 64, "key", False, 0.0),
        ("causal", "float32", 4, 12, 512, 64, None, True, 0.0),
        ("unaligned_s200", "float32", 4, 12, 200, 64, "key", False, 0.0),
        ("head_dim_128", "bfloat16", 4, 8, 256, 128, None, False, 0.0),
        ("causal", "bfloat16", 4, 12, 512, 64, None, True, 0.0),
        ("unaligned_s200", "bfloat16", 4, 12, 200, 64, "key", False, 0.0),
        ("full_mask", "bfloat16", 4, 12, 128, 64, "full", False, 0.0),
        ("head_dim_128_causal_dropout", "bfloat16", 4, 8, 256, 128, None,
         True, DROPOUT_P))]
    fab.append(flash_bwd_case(torch, FA, "q77_k200", "bfloat16", 4, 12, 77,
                              64, "key", False, 0.0, TIMED_ITERS, gen,
                              sk=200))
    fab += [flash_bwd_case(torch, FA, *c, TIMED_ITERS, gen) for c in (
        ("head_dim_128_causal", "float32", 4, 8, 256, 128, None, True, 0.0),
        ("bert_s128_dropout", "float32", 64, 12, 128, 64, "key", False,
         DROPOUT_P),
        ("full_mask", "float32", 4, 12, 128, 64, "full", False, 0.0))]
    fab += [flash_bwd_case(torch, FA, *c, 0.0, TIMED_ITERS, gen)
            for c in FLASH_OTHER]

    # 6. the loss and optimizer kernels against their plain versions
    del model, cpu_model
    torch.cuda.empty_cache()
    xent = [xent_case(torch, SX, *c, XENT_ITERS, gen) for c in (
        ("bert_mlm", "float32", 8192, 30522, 0.0, "bench"),
        ("bert_mlm", "bfloat16", 8192, 30522, 0.0, "bench"),
        ("smoothing", "float32", 4096, 30522, 0.1, "all"),
        ("bert_nsp", "float32", 64, 2, 0.0, "all"),
        ("out_of_range", "float32", 8192, 2500, 0.0, "oor"))]
    adam1 = [fused_adam_case(torch, FAD, *c, TIMED_ITERS, gen) for c in (
        ("float32", (30522, 768)), ("bfloat16", (1000, 77)))]
    multi, flat = fused_adam_multi_flat_cases(torch, FAD, pretraining_shapes(),
                                              ADAM_ITERS, gen)
    torch.cuda.empty_cache()

    # 7. training on the default route, then on the fused route
    rect = train(np, smi, "default")
    kernels.configure(softmax_xent=True, fused_adam_multi=True)
    try:
        rectf = train(np, smi, "fused")
    finally:
        kernels.configure(softmax_xent=None, fused_adam_multi=None)
    emit(dict(phase="train_routes", card=smi,
              default_step_ms=rect["step_ms"],
              default_tokens_per_s=rect["tokens_per_s"],
              fused_step_ms=rectf["step_ms"],
              fused_tokens_per_s=rectf["tokens_per_s"]))

    # 8. the optimizer routes, and 9. the f32 step against the CPU
    rop = optimizer_routes(np, args.seed)
    f32_step_check(np, args.seed)

    # 10. the batch-norm kernels against their plain versions
    torch.cuda.empty_cache()
    bn = [batch_norm_case(torch, BN, "x".join(map(str, shape)), "bfloat16",
                          shape, BN_ITERS, gen) for shape in BN_PATH_SHAPES]
    batch_norm_case(torch, BN, "f32", "float32", (128, 28, 28, 256),
                    BN_ITERS, gen)
    batch_norm_case(torch, BN, "scalar_route_ragged_rows", "bfloat16",
                    (10007, 1, 1, 100), BN_ITERS, gen)
    torch.cuda.empty_cache()

    # 11. ResNet-50 training: NCHW and NHWC on the plain batch norm, then
    # NHWC through the batch-norm kernels
    recr = {}
    for route, fmt, on in (("default", "NCHW", None),
                           ("nhwc_plain", "NHWC", None),
                           ("kernels", "NHWC", True)):
        kernels.configure(batch_norm=on)
        try:
            recr[route] = train_resnet(np, smi, route, fmt)
        finally:
            kernels.configure(batch_norm=None)
    for route, rec in recr.items():
        print(json.dumps(dict(
            phase="train_resnet_route", route=route, card=smi,
            step_ms=rec["step_ms"], images_per_s=rec["images_per_s"],
            peak_memory_gib=rec["peak_memory_gib"],
            batch_norm_launches_per_step=rec["launches_per_step"])),
            flush=True)

    # 12. the ResNet f32 step against the CPU
    kernels.configure(batch_norm=True)
    try:
        resnet_f32_step_check(np, args.seed)
    finally:
        kernels.configure(batch_norm=None)

    # 13. generative serving
    torch.cuda.empty_cache()
    gen13 = generate_phase(np, torch, FA, smi, args.seed, gen)

    # 14. speculative decoding
    spec14 = spec_phase(np, torch, FA, smi, args.seed, gen)

    # 15. the KV hand-off, and the monitor
    handoff_phase(np, torch, smi, args.seed)

    # 16. multi-replica serving: the BERT fleet, the decode fleets
    fleet_phase(np, torch, smi, args.seed, reqs, outs32, gen13, spec14)

    # 17. CUDA graphs: the training steps and the Predictor's executables
    gc.collect()
    torch.cuda.empty_cache()
    graphs_phase(np, torch, FA, smi, args.seed, gen, rec32, rec16)

    # 18. the decode engine's steps as CUDA graphs, against its eager arm
    gc.collect()
    torch.cuda.empty_cache()
    decode_graphs_phase(np, torch, smi, args.seed, gen13, spec14)

    # 19. the kernels line, the card, and the verdict
    csrc = "paddle_tpu_torch/csrc/"
    pallas = "paddle_tpu/ops/pallas/"
    fb = fab[0]
    line = []
    for name, source, replaces, launches, rec in (
            ("layer_norm_fwd", "layer_norm.cu", "layer_norm.py:78",
             rec32["launches"], ln[0]),
            ("flash_attention_fwd", "flash_attention.cu",
             "flash_attention.py:344", rec16["launches"], fa[1]),
            ("layer_norm_bwd", "layer_norm_bwd.cu", "layer_norm.py:122",
             rect["launches"], lnb[0]),
            ("flash_attention_bwd_dq", "flash_attention_bwd.cu",
             "flash_attention.py:434", rect["launches"],
             dict(fb, ms=fb["dq_ms"], max_abs_err=fb["max_abs_err"]["dq"],
                  bound_ms=fb["bound_dq_ms"], bound_by=fb["bound_dq_by"])),
            ("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
             "flash_attention.py:469", rect["launches"],
             dict(fb, ms=fb["dkv_ms"],
                  max_abs_err=max(fb["max_abs_err"]["dk"],
                                  fb["max_abs_err"]["dv"]),
                  bound_ms=fb["bound_dkv_ms"], bound_by=fb["bound_dkv_by"])),
            ("softmax_xent_fwd", "softmax_xent.cu", "softmax_xent.py:79",
             rectf["launches"], xent[0][0]),
            ("softmax_xent_bwd", "softmax_xent.cu", "softmax_xent.py:105",
             rectf["launches"], xent[0][1]),
            ("fused_adam", "fused_adam.cu", "fused_adam.py:62",
             rop["launches"]["use_fused"], adam1[0]),
            ("fused_adam_multi", "fused_adam.cu", "fused_adam.py:161",
             rectf["launches"], multi),
            ("fused_adam_flat", "fused_adam.cu", "fused_adam.py:232",
             rop["launches"]["flat_arena"], flat),
            ("batch_norm_stats", "batch_norm.cu", "batch_norm.py:118",
             recr["kernels"]["launches"], bn[0][0]),
            ("batch_norm_normalize", "batch_norm.cu", "batch_norm.py:138",
             recr["kernels"]["launches"], bn[0][1]),
            ("batch_norm_bwd_reduce", "batch_norm.cu", "batch_norm.py:181",
             recr["kernels"]["launches"], bn[0][2]),
            ("batch_norm_bwd_dx", "batch_norm.cu", "batch_norm.py:199",
             recr["kernels"]["launches"], bn[0][3])):
        check(launches[name] > 0,
              f"{name}: no launch on its path")
        line.append(dict(name=name, route="cuda", source=csrc + source,
                         replaces=pallas + replaces,
                         launches=launches[name],
                         max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                         plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                         bound_by=rec["bound_by"],
                         library_ms=rec["library_ms"]))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(records=RECORDS, kernels=line,
                 seconds=time.perf_counter() - t_start), indent=1))
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
