"""Card smoke test of paddle_tpu_torch: builds the CUDA kernels from this
checkout, holds each against its plain PyTorch version at the training
path's shapes and at head_dim 256 (and, through the padding of
ops.flash_attention, at head_dims and lengths the kernels do not take),
runs the dot-form probe, then trains GPT-350M (gpt3-medium: hidden 1024,
24 layers, 16 heads, vocab 50304; batch 8 x seq 1024, bf16 O2, AdamW with
f32 masters, chunked fused LM-head cross-entropy) under each flash dot
strategy (FLAGS_flash_dot_impl): auto (the default) for 5 steps, then nn,
nn2 and f32 for 3 steps each, every one through its own kernels; then the
same model in f32 (no amp.decorate: the f32-storage kernels) and
gpt3-large cut to 4 layers (head_dim 96, padded to 128) for 3 steps each;
then gpt3-xl's widths with 8 heads (head_dim 256: the D = 256 kernels) cut
to 2 layers, bf16 O2 under auto, nn, nn2 and f32 and in f32, 3 steps each
(in each of them the forward, dQ and dK/dV launch their tensor-core
D = 256 instances, which each phase checks by the instance counts); then
serves gpt3-medium's weights in f32 through the continuous-batching
GenerativeEngine (8 slots, max_context 1024): 16 requests with prompts of
16-512 tokens at once, then one alone, 64 greedy tokens each, checked
against GPTForCausalLM.generate and for zero failures, requeues, sheds,
first calls after warm-up and flash launches (the serving attention is
einsum), with one decode step at batch 8 profiled; then, on 8 of those
prompts, seeded sampling (batched against one by one, another seed,
temperature 0 and top_k=1 against greedy), the sampler alone (threefry
bits on the card against the CPU's, 8192 draws against the filtered
softmax), the prefix cache (8 prompts sharing a 256-token head), a
gpt3-small draft and a self-draft, the int8 KV pool and weight-only int8,
each engine of its own checked the same way; last, the HTTP front and
the KV handoff: those 8 prompts over ServingHTTPServer (streamed and
not) against the engine's own tokens, the client's TTFT beside the
engine's, /healthz and /metrics; prefill_only exports continued on a
second engine through /admin/kv/import (f32, and an int8 pool pair;
greedy and sampled) with their payload bytes and export and import ms;
resume_from; a migrating drain (POST /admin/drain) of streams spliced on
the second engine; and the CLI (python -m
paddle_tpu_torch.inference.serve --generate gpt3-medium --state-dict)
serving the same weights from a checkpoint in a subprocess. Between the
training phases and serving, the trainer's phases, at gpt3-medium, batch
8 x 1024, bf16 O2 unless named: train-full (dropout 0.1, two
micro-batches of 4 a step by accumulate_steps=2, AdamW under
LinearWarmup(CosineAnnealingDecay) with ClipGradByGlobalNorm(1.0) and a
decay gate sparing biases and LayerNorms, skip_bad_steps under the chaos
rule step:nan:3; 4 steps: no flash launch, each lr the CPU scheduler's,
post-clip norms <= 1, one dropped micro-batch, one dropout mask bitwise
the CPU's, the cost of drawing the masks), ckpt (that model and
optimizer saved by framework_io.save, the optimizer read back bitwise,
the model served by the CLI from its bf16 file), skip-bad (step:nan:2:
the state bitwise unchanged across it), recompute (all 24 blocks wrapped:
losses of 3 steps against the plain run's, 48 forward, 24 dQ and 24
dK/dV launches a step, peak memory; batch 32's tokens/s), o1 (f32
parameters under auto_cast O1 with GradScaler and eager steps) and
chunked (flash off: the chunked query scan's loss against the full
einsum's, chunks counted, peak memory of both). Last, the predict phase:
every flash kernel against its plain version at the shapes the path
gives the forward (batch 1 and 8 x 512, 16 heads, D = 64, causal, f32
and bf16 storage); then the same gpt3-medium weights saved by jit.save
(input_spec [None, 512]) in f32 and in bf16 (amp.decorate O2), each
loaded by a fresh Predictor and served by a ServingEngine (max_batch_size
8, 2 replicas), then by one of 1 replica, to 8 client threads sending 32
requests of 1-3 rows: exactly 24 forward launches a batch, of the
instance checked above (kF32 for f32, kBf16 for bf16), and no other
launch, no call of a plain version, no failed, shed, rejected, expired or
split request, no revived replica, no batch that was a shape's first
call, and a batch of more than one request; each of the served
program's 48 forward calls on a one-row request and an 8-row batch
against the plain version of the same call (the kernel phase's limits);
each request's logits against the eager model's on its rows alone (1e-4
of their RMS in f32, 2e-2 in bf16, argmax equal where the top-2 margin
exceeds that) and, in f32, against the eager model's with the plain
attention (read in bf16, beside what two plain attentions part by); the
execute spans split into the inputs' copy, the forward and the outputs'
copy; then the CLI (serve PREFIX --engine --http) and the pipe worker
(serve PREFIX) in subprocesses, their outputs bitwise the engine's for
the same rows. Last, the serving fabric: a native TCPStore (cpp/tcpstore.cc
built into build/store/) in this process, the front door CLI (python -m
paddle_tpu_torch.inference.fabric) in a subprocess, host A in this process
(the serving phase's f32 GenerativeEngine and the bf16 artifact, written
again, under a ServingEngine, behind an admin ServingHTTPServer and a
HostAgent) and host B the serve CLI (serve PREFIX --generate gpt3-medium
--state-dict W --fabric) on the same card; through a FleetClient: the
serving phase's 16 requests streamed (tokens by the margin rule, both
hosts serving, TTFT against the same requests sent to A directly), the
predict phase's 32 requests as raw /predict over both hosts and then to A
alone (A's answers bitwise its Predictor's, 24 flash_fwd launches a batch
on A of a checked instance), SIGKILL of B with 8 streams on it (each
finishes on A with generate's tokens, no duplicate or gap; B suspect,
then evicted within lease + drain + two polls of the door's view), B
restarted with --pool prefill and A leased as pool decode (4 streams
prefilled on B and imported into A), and the door's /healthz and merged
/metrics with both hosts. Last, the models phase, BASELINE.md's
single-chip rows: the flash kernels at BERT-base's attention shape (B =
32, L = 512, 12 heads, D = 64, bf16, non-causal), held and timed; BERT-base
MLM (vocab 30522, hidden 768, 12 layers, 12 heads, batch 32 x 512, 15% of
positions masked; amp.decorate O2 to bf16, AdamW with f32 masters,
auto_cast bf16; eager steps) (a) with dropout 0.1 (no flash launch), (b)
with dropout 0 (12 launches a step of each of the forward, dQ and dK/dV,
of the instances held; the losses against the same steps with the flash
path off; the loss on a held-out batch falls), (c) eval forwards in bf16
and f32 (12 forward launches, each held against its plain version; the
logits against the plain attention's), (d) a padded batch under
attention_mask (no launch); then ResNet-50 (small_input, 10 classes, f32)
for 5 dygraph Momentum steps on a 128 x 3 x 32 x 32 batch (the loss falls,
every batch-norm buffer moves) and its eval logits against a CPU copy.
After the fit phase, the ops phase: (a) every op of the op surface
(creation, random, element-wise math in float32 and, for a selection,
bfloat16, special functions, integer ops, reductions, logic, shape,
index, sort and search, linear algebra, nn.functional's activations) on
the card and on the CPU on the same seeded inputs (about 1M elements for
element-wise ops and reductions, 1024 x 1024 for the shape, index and
sort families): every card output on the card with the CPU's dtype,
bitwise where the family is exact (creation, integer, logic, shape,
index, sort, random; randn and standard_normal within 4 float32 units
in the last place), within OPS_LIMITS where it is float (digamma and
normal(1, 2) within OPS_ROW_LIMITS); (b) gpt3-medium's 24 blocks
at full width in bf16, batch 8 x 1024, one training step written in the
port's op calls (matmul, reshape, transpose, split, add, mean, F.layer_norm,
F.gelu, F.scaled_dot_product_attention, F.embedding, F.cross_entropy) on
a GPTForCausalLM's state_dict: its loss within 2e-3 and every gradient
within 2e-2 relative norm of the module's, 24 launches each of flash_fwd,
flash_dq and flash_dkv a step and no other flash kernel, and both steps'
ms.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare OTHER_CHECKOUT
    python3 chip_smoke.py --serving
    python3 chip_smoke.py --trainer
    python3 chip_smoke.py --predict
    python3 chip_smoke.py --fabric
    python3 chip_smoke.py --models
    python3 chip_smoke.py --fit
    python3 chip_smoke.py --ops

Needs one CUDA card (written for an H100, sm_90a) and nvcc. Prints the
card and its power limit, a `kernels` JSON line (time, achieved TFLOP/s,
launches on the training path, bound, plain and library times, error of
each kernel; the f32-storage forward, dQ and dK/dV as `name@float32`, the
forward and dQ rows with the time of the split pass they run; the D = 256
kernels as `name@D256` and `name@float32@D256`), a `serving` JSON line
(warm-up, TTFT, tokens/s, decode step and prefill times by bucket, the
profiled decode step, KV pool bytes, peak memory; the sampling, sampler,
prefix-cache, speculation and int8 checks with each engine's decode step
at bucket 8; the HTTP, handoff, migration, resume and CLI checks), a
`trainer` JSON line (each trainer phase's losses, step ms, peak memory,
launches, checks and seconds; the masks' share of a train-full step), a
`predict` JSON line (export, save and load seconds, artifact bytes, each
bucket's first call, bucket 8's forward and output copy, execute ms by
bucket and by stage, QPS, latencies, occupancy, launches, with 2
replicas and with 1, errors, HTTP and pipe;
the flash_fwd and flash_fwd@float32 rows of the kernels line also carry
their predict launches), a `fabric` line (host starts, TTFT through the
door and direct, /predict QPS over two hosts and one, A's launches, the
gap from the SIGKILL to a resumed stream's next token, the times to
suspect and evict, the handoffs' payload bytes, import ms and TTFT; the
flash_fwd row carries its launches through the door), a `models` line
(BERT's runs: losses, launches, instances, probe loss, tokens/s, peak
memory, the profiled step's busy time and idle share, the eval forwards'
errors; ResNet-50's losses, images/s, peak memory, buffers moved, eval
error; the non-causal kernel rows, `name@noncausal`, join the kernels
line with run (b)'s launches) and, as the last line,
{"ok": true, "device": {...}}. Any failed check exits non-zero without that
line. With --compare, it only times every flash kernel of this checkout
and of OTHER_CHECKOUT (another tree of the repo, e.g. the parent commit
unpacked by `git archive`) at the training shape, in bf16 and, for the
forward, dQ, dK/dV and the whole backward (flash_bwd), in f32, and at the
head_dim-256 shape (B*H = 64, L = 1024) in bf16 and f32 (`@D256`, the
whole f32 backward too), the bf16 dQ at D = 256 at B*H = 16 and 32,
L = 2048 (`@D256@16x2048`, `@D256@32x2048`) and the f32-storage forward at
D = 256 at the same two shapes (`@float32@D256@16x2048`, `@32x2048`), by
the same method, in turns (other, this, this, other), each in a process of
its own that builds that tree's kernels, with the SM clock read after each
row. With --serving, it runs only the serving phase and prints its line
(without the {"ok": ...} line); with --trainer, only the kernels' build
and the trainer's phases, and their line (without it either); with
--predict, only the kernels' build and the predict phase, and its line
(without it either); with --fabric, only the kernels' build, the forward
held at the predict path's bf16 shapes and the fabric phase, and its
line (without it either); with --models, only the kernels' build and the
models phase, and the non-causal kernel rows and the `models` line
(without it either); with --fit, the kernels' build and the fit phase,
and with --ops, the kernels' build and the ops phase, each with its line
(without it either).
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import urllib.request

# Published H100 SXM peaks (NVIDIA data sheet, dense): tensor-core bf16,
# f32 on the CUDA cores (f32 products run without TF32 here), HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# On bf16 storage an f32 dot needs no f32 product: a product of two bf16
# values is exact in f32, and an f32 operand (P, dS) splits into three bf16
# terms that hold its 24 significant bits. So the least time for an f32-dot
# kernel there is that of its bf16 tensor-core passes, each of 2 D flops a
# (query, key) pair: forward S, then P.V in three; dQ S, dP, then dS.K in
# three; dK/dV S, dP, then P^T.dO and dS^T.Q in three each.
F32DOT_BF16_PASSES = {"fwd": 1 + 3, "dq": 1 + 1 + 3, "dkv": 1 + 1 + 3 + 3}
# On f32 storage both operands of every product are f32. Split into three
# bf16 terms each, a product keeps f32's 24 bits with six bf16 passes (the
# term pairs of weight 2^-16 and above: hi.hi, hi.mid, mid.hi, hi.lo,
# mid.mid, lo.hi): the f32-storage forward, dQ and dK/dV run so at every
# head_dim, 256 included (bound by six passes a product: forward 2
# products, dQ 3, dK/dV 4).
F32_STORAGE_SPLIT_PASSES = {"fwd": 6 * 2, "dq": 6 * 3, "dkv": 6 * 4}
# the kernels timed on f32 storage: the nn, nn2 and f32-dot entry points run
# the same kernels there (the nn forms bitwise, checked each run)
F32_STORAGE_TIMED = ("flash_fwd", "flash_dq", "flash_dkv")
# the kernel instance each wrapper launches at head_dim 256 on bf16
# storage: the tensor-core forward, dQ and dK/dV of every strategy (kBf16
# for bf16, nn and nn2; kSplit for f32)
D256_INSTANCES = {
    "flash_fwd": "flash_fwd_mma_kernel<256, kStd, kBf16>",
    "flash_fwd_nn": "flash_fwd_mma_kernel<256, kNN, kBf16>",
    "flash_dq": "flash_dq_mma_kernel<256, kStd, kBf16>",
    "flash_dq_nn": "flash_dq_mma_kernel<256, kNN, kBf16>",
    "flash_dkv": "flash_dkv_mma_kernel<256, kStd, kBf16>",
    "flash_dkv_nn": "flash_dkv_mma_kernel<256, kNN, kBf16>",
    "flash_dkv_nn2": "flash_dkv_mma_kernel<256, kNN2, kBf16>",
    "flash_fwd_f32dot": "flash_fwd_mma_kernel<256, kStd, kSplit>",
    "flash_dq_f32dot": "flash_dq_mma_kernel<256, kStd, kSplit>",
    "flash_dkv_f32dot": "flash_dkv_mma_kernel<256, kStd, kSplit>",
}
# ... and on f32 storage: every strategy's forward, dQ and dK/dV on the
# tensor cores (nn and nn2 split their transposed operands into the same
# terms and run kStd's instances)
D256_F32_INSTANCES = {
    name: f"flash_{name.split('_')[1]}_mma_kernel<256, kStd, kF32>"
    for name in D256_INSTANCES}
# the kernel instances at head_dim 256, all on the tensor cores, which
# must not spill
D256_TC_INSTANCES = frozenset((*D256_INSTANCES.values(),
                               *D256_F32_INSTANCES.values()))

# Kernel vs plain version, as the largest error divided by the RMS of its
# row (the D entries of one position and head), or by the RMS of the whole
# tensor where the row's is smaller: a row that sees many keys has small
# entries, and a wrong tile there must not hide under the rounding of the
# few large rows. float32 (every kernel on f32 storage, the nn forms'
# included): the kernel's own f32 rounding, against the plain version
# evaluated in f64 on the same inputs (LSE and delta included). The plain
# version in f32 is no yardstick at that limit: in a causal head's first
# rows P is one-hot and dP - delta cancels, so its own dQ there is f32
# noise, 1.2e-5 of the tensor's RMS from f64's at D = 128 (and 2.0e-5 of
# the f32 dQ on the card at the training shape read against it alone; see
# tests/test_torch_f32_storage_split.py).
# bfloat16 (the tensor-core kernels of bf16, nn and nn2): outputs carry 8
# significant bits (a relative step of 2^-8), the kernel rounds P to bf16
# against the running row max where the plain version uses the final max,
# and the tensor cores sum in their own order. f32dot-bfloat16 (strategy
# f32 on bf16 storage): P and dS stay f32 in both, so they differ only
# where another order of f32 sums flips an output's final rounding to
# bf16, one step of that entry (the forward's f32 products come from bf16
# tensor-core passes, exact in f32, summed in the tensor cores' order). A
# kernel that skips one off-diagonal tile reads far above each limit;
# `fault_readings` computes that reading in every run.
REL_TOL = {"float32": 1e-5, "bfloat16": 1e-1, "f32dot-bfloat16": 5e-2}
# That one-step error cannot tell an f32-dot kernel from one that rounds P
# and dS to bf16 (bf16's function): both part from the f32-dot plain
# version by one step of some entries. What tells them apart is how many:
# reordered f32 sums flip an output's rounding rarely, rounding P and dS
# flips a third or more (the CPU tests read 35-44%). So the f32-dot
# kernels on bf16 storage are also held to the share of output entries
# that differ at all, and every run checks that bf16's function, from the
# plain versions, reads above this limit.
SHARE_TOL = 0.01
LSE_ATOL = 1e-4          # LSE is f32 in both
# Step-1 training loss through the kernels vs through the plain einsum
# attention (bf16 softmax). A sanity check of the routing only: at
# initialisation (weights of std 0.02) attention moves the loss little,
# so the kernels' numerics are held by the kernel phase, not by this.
LOSS_ATOL = 1e-3
# Step-1 loss of the nn and nn2 phases vs the bf16 (auto) phase: their
# forward kernel feeds the tensor cores the same fragments in the same
# order as bf16's, and every other op of the step is the same, so the
# losses are equal. Of the f32 phase: P enters P.V unrounded, an
# attention-only difference that, like the einsum's above, moves the loss
# at initialisation little.
LOSS_SAME_ATOL = 0.0
LOSS_F32_ATOL = 1e-3
# Step-1 loss of the f32 model (f32 storage) through the kernels vs the
# plain einsum attention on the same f32 model: the two differ in the order
# of f32 sums only.
LOSS_F32_MODEL_ATOL = 1e-4

STRATEGY_STEPS = {"auto": 5, "nn": 3, "nn2": 3, "f32": 3}
# the phases after the strategy phases: gpt3-medium in f32 (the f32-storage
# kernels), and gpt3-large (head_dim 96, padded to 128) cut to 4 layers,
# bf16 O2; 3 steps each under auto
F32_MODEL_STEPS = 3
D96_LAYERS, D96_STEPS = 4, 3
# head_dim 256: gpt3-xl's widths (hidden 2048) with 8 heads, cut to 2
# layers; bf16 O2 under each strategy, then in f32 under auto, 3 steps each
D256_HEADS, D256_LAYERS, D256_STEPS = 8, 2, 3
# the serving phase: GenerativeEngine over gpt3-medium in f32, 8 slots;
# SERVING_REQUESTS requests with prompts of uniform length in
# SERVING_PROMPT, submitted at once, then one alone, SERVING_NEW tokens
# each. The engine's tokens may part from GPTForCausalLM.generate's only
# at a step where both paths' top-2 logit margin is under SERVING_MARGIN:
# the two differ in the order of f32 sums (their LayerNorms, the engine's
# gathered rows and padded prompt), a few 1e-6 of logits of O(1).
SERVING_SLOTS, SERVING_REQUESTS, SERVING_NEW = 8, 16, 64
SERVING_PROMPT = (16, 512)
SERVING_MARGIN = 1e-4
# Beyond greedy, on the same weights: each check runs BEYOND_ROWS of the
# burst's prompts (batch bucket 8) for BEYOND_NEW tokens. SAMPLE is the
# reference serving tests' sampling set. Sampled tokens follow the greedy
# rule on the logits they were drawn from (filtered, plus the step's
# Gumbel noise): two paths may part first only where both margins are
# under SERVING_MARGIN, or where the two passes keep different top-k/top-p
# sets (a boundary case; counted).
SAMPLE = {"temperature": 0.8, "top_k": 50, "top_p": 0.9, "seed": 42}
BEYOND_ROWS, BEYOND_NEW = 8, 32
# the sampler alone: SAMPLER_DRAWS draws on one row of logits, held to a
# total-variation distance of SAMPLER_TV_FACTOR times the one expected
# from the draw count alone
SAMPLER_DRAWS, SAMPLER_TV_FACTOR = 8192, 3.0
# the prefix cache: 8 prompts sharing a PREFIX_HEAD-token head, tails of
# PREFIX_TAILS tokens, PREFIX_SLOTS cache rows
PREFIX_HEAD, PREFIX_TAILS, PREFIX_SLOTS = 256, (16, 128), 4
# speculation: a gpt3-small draft (its own seeded weights), SPEC_TOKENS
# positions a burst; a self-draft must accept at least SELF_DRAFT_ACCEPT
# of its proposals (draft decode and the verify pass round differently
# only at near ties)
SPEC_TOKENS, SELF_DRAFT_ACCEPT = 4, 0.9
# the HTTP front and the KV handoff, last, on the serving engine (A) and a
# second engine of the same weights (B): HANDOFF_STREAMS of the prompts
# exported by prefill_only on A and continued on B (greedy, then SAMPLE),
# in f32 and on an int8 pool pair; MIGRATE_STREAMS streams of MIGRATE_NEW
# tokens drained off A with migration once each has MIGRATE_AFTER tokens;
# resume_from=RESUME_FROM; then the CLI serving the same weights from a
# checkpoint, given CLI_START_S to answer /healthz
HANDOFF_STREAMS, MIGRATE_STREAMS, MIGRATE_NEW, MIGRATE_AFTER = 2, 3, 96, 8
RESUME_FROM, CLI_START_S = 5, 240
# the trainer's phases, at gpt3-medium, batch x seq 8 x 1024, bf16 O2 unless
# named: train-full (dropout 0.1, two micro-batches of 4 a step), skip-bad,
# recompute (batch 8 with and without, then batch 32 with), o1 (f32
# parameters), chunked (flash off) and ckpt. The recompute run's losses
# should equal the plain run's bitwise (the replay runs the same kernels on
# the same inputs); the limit admits autograd summing the tied embedding's
# two gradients in another order. The chunked scan's scores are f32 where
# the full einsum's are bf16, so the losses part by where bf16 rounds:
# 1e-3 relative (1.3e-5 read on an H100).
TRAIN_FULL_STEPS, RECOMPUTE_STEPS, O1_STEPS = 4, 3, 3
RECOMPUTE_LOSS_RTOL, CHUNKED_RTOL = 1e-6, 1e-3
# the predict phase: gpt3-medium saved by jit.save at [None, PREDICT_LEN]
# (a static length: the flash gate needs L % 128 == 0, which no export
# can decide on a symbolic length) in f32 and bf16, each served by a
# ServingEngine of PREDICT_REPLICAS replicas, batches of up to
# PREDICT_MAX_BATCH rows held open PREDICT_BATCH_TIMEOUT_MS for
# batchmates, to PREDICT_CLIENTS client threads sending PREDICT_REQUESTS
# requests of 1-3 rows, then by one replica to the same clients and
# requests. A request's logits may part by PREDICT_TOL of their RMS from
# those of the eager model on its rows alone, and from those of the eager
# model with the attention's plain version in place of the kernel: f32,
# the order of f32 sums (GEMMs of another batch size, the kernel's tiles);
# bf16, a few steps of bf16 rounding carried through 24 layers. The CLI
# and the pipe worker get PREDICT_CLI_START_S to answer.
PREDICT_LEN, PREDICT_MAX_BATCH, PREDICT_REPLICAS = 512, 8, 2
PREDICT_CLIENTS, PREDICT_REQUESTS, PREDICT_BATCH_TIMEOUT_MS = 8, 32, 10.0
PREDICT_TOL = {"f32": 1e-4, "bf16": 2e-2}
PREDICT_CLI_START_S = 240
# the fabric phase: the door's lease and drain windows (its view polls
# every lease / 4), host A's heartbeat; FABRIC_KILL_STREAMS streams on
# host B, each FABRIC_KILL_AFTER tokens out when B is killed;
# FABRIC_HANDOFFS disaggregated streams; a host gets FABRIC_START_S to
# register behind the door
FABRIC_LEASE_S, FABRIC_DRAIN_S, FABRIC_BEAT_S = 2.0, 2.0, 0.5
FABRIC_KILL_STREAMS, FABRIC_KILL_AFTER, FABRIC_HANDOFFS = 8, 8, 4
FABRIC_START_S = 240
# the models phase, BASELINE.md's single-chip rows. BERT-base MLM
# (BertConfig's defaults) at BERT_BATCH x BERT_SEQ, 15% of the positions
# [MASK]ed (id BERT_MASK_ID) and labelled, bf16 O2 with AdamW's f32
# masters under auto_cast bf16, BERT_STEPS eager steps a run at BERT_LR:
# (a) dropout 0.1; (b) dropout 0 under auto (the non-causal flash
# kernels) and the same steps with FLAGS_use_flash_attention off, whose
# losses part by at most BERT_FLASH_LOSS_RTOL (the bf16 loss limit of the
# CPU tests; at initialisation attention moves the loss little, so this
# checks the routing, and the kernel phase at the path's shapes holds the
# kernels); (c) an eval forward of BERT_EVAL_ROWS rows, each forward call
# held against its plain version as the kernel phase holds it, and the
# logits within BERT_EVAL_TOL of the same forward's with the attention's
# plain version (the norm of the difference over the reference's; two
# correct bf16 attentions, P rounded and not, read 1.4e-2 through 12 such
# layers on the CPU), then the same in f32 (PREDICT_TOL's f32 limit); (d)
# a padded batch under attention_mask (the einsum). ResNet-50
# (small_input, 10 classes, f32) on RESNET_BATCH x 3 x 32 x 32 images,
# RESNET_STEPS dygraph Momentum steps (momentum 0.9) at RESNET_LR on one
# fixed batch, whose loss must fall (at 0.01 momentum overshot from the
# random start: 2.647 to 3.234 over 5 steps on an H100; the baseline
# row's own resnet50 test takes 0.003); its eval logits on
# RESNET_EVAL_ROWS images against a CPU copy of the same state within
# RESNET_EVAL_TOL of their RMS (cuDNN's f32 convolution algorithms
# against the CPU's, 53 convolutions deep)
BERT_BATCH, BERT_SEQ, BERT_STEPS, BERT_LR = 32, 512, 3, 5e-4
BERT_MASK_ID, BERT_EVAL_ROWS = 103, 8
BERT_FLASH_LOSS_RTOL, BERT_EVAL_TOL = 2e-3, 5e-2
RESNET_BATCH, RESNET_STEPS, RESNET_LR = 128, 5, 0.001
RESNET_EVAL_ROWS, RESNET_EVAL_TOL = 16, 1e-3
# The fit phase (--fit), both models at full width through the training
# API: ResNet-50 (small_input, 10 classes, f32) by Model.fit over the
# DataLoader that fit builds from FakeData(FIT_IMAGES) under random crop
# and flip, FIT_EPOCHS epochs at batch FIT_BATCH with FIT_WORKERS
# workers, forked and then threaded (Momentum RESNET_LR: PR 19 found 0.01
# made the loss rise); BERT-base MLM (bf16 O2, AdamW BERT_LR, batch 32 x
# 512, dropout 0: the non-causal flash kernels) by Model.fit over an
# io.Pipeline (the 15% corruption in map, FIT_WORKERS decode threads, a
# device prefetch FIT_PREFETCH deep) for FIT_BERT_ITERS steps, then
# FIT_PROFILED_ITERS more under a ProfilerCallback whose scheduler
# (closed 1, ready 1, record 4) records 4. The profiler's products (mm,
# addmm, bmm) of a recorded step within FIT_FLOPS_RTOL of the count
# worked out from the config (their bias adds are 1/(2K) of a product,
# 0.07% at K = 768).
FIT_IMAGES, FIT_BATCH, FIT_EPOCHS, FIT_WORKERS = 2560, 128, 2, 4
FIT_BERT_ROWS, FIT_BERT_ITERS, FIT_PROFILED_ITERS = 576, 12, 6
FIT_PREFETCH, FIT_RECORDED, FIT_FLOPS_RTOL = 2, 4, 0.01
SEED = 0

REF = "paddle_tpu/ops/pallas/flash_attention.py"
# the line of each kernel's reference function in REF
REPLACES = {"flash_fwd": 83, "flash_dq": 174, "flash_dkv": 233,
            "flash_fwd_nn": 83, "flash_dq_nn": 203, "flash_dkv_nn": 233,
            "flash_dkv_nn2": 289, "flash_fwd_f32dot": 83,
            "flash_dq_f32dot": 174, "flash_dkv_f32dot": 233,
            "flash_probe": 467}
# inputs of each flash kernel's wrapper, before (causal, sm_scale)
ARGS = {
    "flash_fwd": ("q", "k", "v"),
    "flash_fwd_nn": ("q", "kt", "v"),
    "flash_fwd_f32dot": ("q", "k", "v"),
    "flash_dq": ("q", "k", "v", "do", "lse", "delta"),
    "flash_dq_nn": ("q", "k", "kt", "vt", "do", "lse", "delta"),
    "flash_dq_f32dot": ("q", "k", "v", "do", "lse", "delta"),
    "flash_dkv": ("q", "k", "v", "do", "lse", "delta"),
    "flash_dkv_nn": ("q", "kt", "vt", "do", "lse", "delta"),
    "flash_dkv_nn2": ("q", "qt", "kt", "vt", "do", "dot", "lse", "delta"),
    "flash_dkv_f32dot": ("q", "k", "v", "do", "lse", "delta"),
}
# the nn forms give bitwise what these kernels of strategy bf16 give, on
# bf16 storage (mma kernels) and on f32 (f32-dot kernels) alike
BF16_TWIN = {"flash_fwd_nn": "flash_fwd", "flash_dq_nn": "flash_dq",
             "flash_dkv_nn": "flash_dkv", "flash_dkv_nn2": "flash_dkv"}


class SmokeFailure(Exception):
    pass


def is_instance(inst, want):
    """Whether instance name `inst` is `want` (a whole instance name) or
    an instance of kernel `want` (a kernel's name)."""
    return inst == want or inst.startswith(want + "<")


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps=7, launches=20, warmup=3):
    """Device time of one call of fn: CUDA events around `launches` calls
    back to back, divided by their count; the median of `reps` such runs.
    Back to back, the card is not left idle while the host prepares the
    next launch (one launch between events would add that host time)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(launches):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / launches)
    times.sort()
    return times[len(times) // 2]


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def row_err(a, b):
    """max |a - b| / RMS of its row of b, floored at the RMS of all of b."""
    a, b = a.float(), b.float()
    floor = float(b.pow(2).mean().sqrt())
    scale = b.pow(2).mean(-1, keepdim=True).sqrt().clamp(min=floor)
    return float(((a - b).abs() / scale).max())


def abs_err(a, b):
    return float((a.float() - b.float()).abs().max())


def mismatch_share(a, b):
    """Share of the entries of a that differ from b's."""
    return float((a != b).float().mean())


def fault_readings(q, k, v, do, sc, ref, T=64):
    """What the error metrics read for kernels that each skip one tile:
    the forward and dQ kernels the keys of K/V tile t for query tile s, the
    dK/dV kernel query tile s for K/V tile t. s is the last T-row tile and
    t the middle one, off the diagonal: a pair whose loss changes the
    outputs little, since the last queries see the most keys and add the
    least to each key's gradients. The faulty outputs are the plain
    version's less that pair's contribution, rounded as the kernels
    round."""
    import torch

    o, lse, delta, dq, dk, dv = ref
    L = q.shape[1]
    s0, t0 = L - T, (L // 2 // T) * T
    rows, cols = slice(s0, s0 + T), slice(t0, t0 + T)
    heads = lambda x: x.transpose(1, 2).float()           # noqa: E731
    back = lambda x: x.transpose(1, 2).to(q.dtype)        # noqa: E731
    qs, dos = heads(q[:, rows]), heads(do[:, rows])
    kt, vt = heads(k[:, cols]), heads(v[:, cols])
    p = torch.exp(qs @ kt.transpose(-1, -2) * sc - lse[:, :, rows, None])
    ds = p * (dos @ vt.transpose(-1, -2) - delta[:, :, rows, None]) * sc
    kept = 1 - p.sum(-1, keepdim=True)

    def without(x, sl, part):
        y = x.clone()
        y[:, sl] = back(heads(x[:, sl]) - part)
        return y

    o_f = o.clone()
    o_f[:, rows] = back((heads(o[:, rows]) - p @ vt) / kept)
    lse_f = lse.clone()
    lse_f[:, :, rows] += torch.log(kept.squeeze(-1))
    dq_f = without(dq, rows, ds @ kt)
    dk_f = without(dk, cols, ds.transpose(-1, -2) @ qs)
    dv_f = without(dv, cols, p.transpose(-1, -2) @ dos)
    return ({"O": row_err(o_f, o), "dQ": row_err(dq_f, dq),
             "dK": row_err(dk_f, dk), "dV": row_err(dv_f, dv)},
            abs_err(lse_f, lse))


def named_outputs(name, out):
    """A flash kernel's outputs by name, dK^T and dV^T turned back into
    [B, L, H, D]."""
    from paddle_tpu_torch.ops import flash_attention as fa

    if name.startswith("flash_fwd"):
        return {"O": out[0], "LSE": out[1]}
    if name.startswith("flash_dq"):
        return {"dQ": out}
    if name == "flash_dkv_nn2":
        out = tuple(fa.from_t(x) for x in out)
    return {"dK": out[0], "dV": out[1]}


def kernel_phase(B, L, H, D, dtype_name, causal, timed, time_names=None):
    """Each flash kernel against its plain version on the card (the nn
    forms also against the bf16 kernels, bitwise); with `timed`, also the
    CUDA-event medians, bounds and library times of the kernels named in
    `time_names` (all by default). Returns their rows (with `timed`), else
    each kernel's instance name."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    dt = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, do = (torch.randn(B, L, H, D, device="cuda", dtype=dt,
                               generator=g) for _ in range(4))
    sc = 1.0 / math.sqrt(D)
    o, lse = fa.flash_fwd_plain(q, k, v, causal, sc)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    t = {"q": q, "k": k, "v": v, "do": do, "lse": lse, "delta": delta,
         "qt": fa.to_t(q), "kt": fa.to_t(k), "vt": fa.to_t(v),
         "dot": fa.to_t(do)}
    # the plain outputs of each rounding family, and what kernels that skip
    # one tile would read in each
    plain, faults = {}, {}
    for fam, f32_dots in (("mma", False), ("f32dot", True)):
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, sc, f32_dots)
        grads = fa.flash_bwd_plain(q, k, v, do, lse, delta, causal, sc,
                                   f32_dots)
        plain[fam] = dict(zip(("O", "dQ", "dK", "dV"), (o_p, *grads)))
        faults[fam] = fault_readings(q, k, v, do, sc,
                                     (o_p, lse_p, delta, *grads))
    # the share of entries where bf16's function (P and dS rounded) parts
    # from the f32-dot function: what a kernel that rounded would read
    rounding = {n: mismatch_share(plain["mma"][n], plain["f32dot"][n])
                for n in plain["mma"]}
    del plain
    tag = f"B={B} L={L} H={H} D={D} {dtype_name} causal={causal}"
    fmt = lambda d: {n: f"{e:.3e}" for n, e in d.items()}   # noqa: E731

    results, got_by_name = {}, {}
    for name in ARGS:
        args = [t[a] for a in ARGS[name]] + [causal, sc]
        fa.reset_launch_counts()
        got = named_outputs(name, fa.CUDA[name](*args))
        torch.cuda.synchronize()
        (instance,) = fa.INSTANCE_LAUNCHES
        if D == 256:
            want_inst = (D256_INSTANCES if dtype_name == "bfloat16"
                         else D256_F32_INSTANCES)[name]
            check(is_instance(instance, want_inst),
                  f"{name} at D = 256 {dtype_name} launched {instance}, not "
                  f"{want_inst}")
        ref_args = ([a.double() if torch.is_tensor(a) else a for a in args]
                    if dtype_name == "float32" else args)
        want = named_outputs(name, fa.PLAIN[name](*ref_args))
        got_by_name[name] = got
        f32dot = name.endswith("f32dot") or dtype_name == "float32"
        fam = "f32dot" if f32dot else "mma"
        tol = REL_TOL[dtype_name if dtype_name == "float32" or not f32dot
                      else "f32dot-bfloat16"]
        errs = {n: row_err(got[n], want[n]) for n in got if n != "LSE"}
        fault, lse_fault = faults[fam]
        line = (f"{name} ({instance}) vs plain [{tag}]: row-normalised err "
                f"{fmt(errs)} (tol {tol}; a kernel skipping one tile reads "
                f"{fmt({n: fault[n] for n in errs})})")
        for n, e in errs.items():
            check(e <= tol, f"{name} {n} disagrees with its plain version "
                            f"[{tag}]: {e:.3e} > {tol}")
            check(fault[n] > tol, f"the {name} {n} check would pass a "
                                  f"kernel that skips a tile [{tag}]")
        if "LSE" in got:
            lse_err = abs_err(got["LSE"], want["LSE"])
            line += (f", LSE abs err {lse_err:.3e} (tol {LSE_ATOL}; "
                     f"skipping: {lse_fault:.3e})")
            check(lse_err <= LSE_ATOL, f"{name} LSE disagrees [{tag}]: "
                                       f"{lse_err:.3e}")
            check(lse_fault > LSE_ATOL, f"the LSE check would pass a kernel "
                                        f"that skips a tile [{tag}]")
        share = None
        if name.endswith("f32dot") and dtype_name == "bfloat16":
            shares = {n: mismatch_share(got[n], want[n]) for n in errs}
            share = max(shares.values())
            line += (f"; share of entries that differ {fmt(shares)} (limit "
                     f"{SHARE_TOL}; rounding P and dS to bf16 reads "
                     f"{fmt({n: rounding[n] for n in shares})})")
            for n, x in shares.items():
                check(x <= SHARE_TOL, f"{name} {n}: {x:.3e} of its entries "
                                      f"differ from the f32-dot plain version "
                                      f"[{tag}], limit {SHARE_TOL}")
                check(rounding[n] > SHARE_TOL,
                      f"the {name} {n} share check would pass a kernel that "
                      f"rounds P and dS to bf16 [{tag}]")
        twin_diff = None
        if name in BF16_TWIN:
            twin = got_by_name[BF16_TWIN[name]]
            twin_diff = max(abs_err(got[n], twin[n]) for n in got)
            line += f"; largest difference from {BF16_TWIN[name]} {twin_diff}"
            check(twin_diff <= 0.0, f"{name} is not bitwise "
                                    f"{BF16_TWIN[name]} [{tag}]")
        log(line)
        results[name] = {
            "max_abs_err": max(abs_err(got[n], want[n]) for n in got),
            "row_err": max(errs.values()), "diff_vs_bf16": twin_diff,
            "mismatch_share": share, "args": args, "f32dot": f32dot,
            "instance": instance,
            "out_bytes": sum(x.numel() * x.element_size()
                             for x in got.values())}
    if not timed:
        return {name: r["instance"] for name, r in results.items()}

    # work this run's inputs need: causal rows see keys 0..row
    pairs = B * H * (L * (L + 1) // 2 if causal else L * L)
    flops = {"fwd": 4 * D * pairs, "dq": 6 * D * pairs, "dkv": 8 * D * pairs}

    # library yardsticks (timed only, never used by the port): PyTorch's
    # fused SDPA forward, and its backward (dQ, dK and dV in one call), on
    # the inputs and, for the f32-dot kernels, on their f32 copies
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = {}
    for key, ldt in (("mma", dt), ("f32dot", torch.float32)):
        if ldt == dt and lib:     # f32 storage: one set of times for both
            lib[key] = lib["mma"]
            continue
        qh, kh, vh = (x.transpose(1, 2).to(ldt).contiguous().requires_grad_()
                      for x in (q, k, v))
        doh = do.transpose(1, 2).to(ldt).contiguous()
        with torch.no_grad():
            lib_fwd = median_ms(lambda: sdpa(qh, kh, vh, is_causal=causal))
        out = sdpa(qh, kh, vh, is_causal=causal)
        lib_bwd = median_ms(lambda: torch.autograd.grad(
            out, (qh, kh, vh), doh, retain_graph=True))
        lib[key] = {"fwd": lib_fwd, "bwd": lib_bwd}
        del qh, kh, vh, doh, out

    # f32 storage: each kernel works from split terms, timed as the training
    # path calls it, from the terms one split made (the forward's call
    # splits Q, K and V; the dQ call of a backward splits Q, K, V and dO,
    # the dK/dV call reads them), and the split pass by itself as the
    # difference of the forward's and the dQ call with and without it
    terms = {}
    if fa.works_from_terms(q):
        for kind, name, n_ops in (("fwd", "flash_fwd", 3),
                                  ("dq", "flash_dq", 4)):
            terms[kind] = fa.split_terms(q, n_ops)
            fa.CUDA[name](*results[name]["args"], terms=terms[kind])
        terms["dkv"] = terms["dq"]
    rows = []
    for name, r in results.items():
        if time_names is not None and name not in time_names:
            continue
        args = r["args"]
        kind = name.split("_")[1]
        # one copy of each operand of the function: an nn form computes its
        # bf16 twin's function, and the transposed copies it is also handed
        # (K and K^T for dq_nn, Q^T and dO^T for dkv_nn2) are layout
        in_bytes = sum(t[a].numel() * t[a].element_size()
                       for a in ARGS[BF16_TWIN.get(name, name)])
        nbytes = in_bytes + r["out_bytes"]
        extra = {}
        if kind in terms:
            # six bf16 passes of split operands a product, on the tensor
            # cores; the same f32 flops on the CUDA cores beside it
            b = bound(F32_STORAGE_SPLIT_PASSES[kind] * 2 * D * pairs, nbytes,
                      "bfloat16")
            extra["cuda_core_bound_ms"] = bound(flops[kind], nbytes,
                                                "float32")[0]
        elif r["f32dot"] and dtype_name == "bfloat16":
            b = bound(F32DOT_BF16_PASSES[kind] * 2 * D * pairs, nbytes,
                      "bfloat16")
            # the same function's f32 flops on the CUDA cores, the bound
            # before the split (PERF.md gives both)
            extra["cuda_core_bound_ms"] = bound(flops[kind], nbytes,
                                                "float32")[0]
        else:
            b = bound(flops[kind], nbytes,
                      "float32" if r["f32dot"] else "bfloat16")
        if kind in terms:
            mine = terms[kind]
            ms = median_ms(lambda: fa.CUDA[name](*args, terms=mine,
                                                 split=False))
            if kind in ("fwd", "dq"):
                with_split = median_ms(lambda: fa.CUDA[name](*args,
                                                             terms=mine))
                extra["split_ms"] = with_split - ms
                # the split pass reads 4 and writes 6 bytes an element of
                # each operand it splits
                ops = ("q", "k", "v") + (("do",) if kind == "dq" else ())
                extra["split_pass_bound_ms"] = bound(
                    0, sum(t[a].numel() for a in ops) * (4 + 6),
                    "bfloat16")[0]
        else:
            ms = median_ms(lambda: fa.CUDA[name](*args))
        plain = median_ms(lambda: fa.PLAIN[name](*args), reps=5, launches=3)
        rows.append({
            "name": name + ("@float32" if dtype_name == "float32" else "")
            + ("@D256" if D == 256 else ""),
            "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": f"{REF}:{REPLACES[name]}",
            "instance": r["instance"],
            "max_abs_err": r["max_abs_err"], "row_err": r["row_err"],
            **({"mismatch_share": r["mismatch_share"]}
               if r["mismatch_share"] is not None else {}),
            "ms": ms, "tflops": flops[kind] / ms * 1e-9, "plain_ms": plain,
            "bound_ms": b[0], "bound_by": b[1], **extra,
            "library_ms": lib["f32dot" if r["f32dot"] else "mma"][
                "fwd" if kind == "fwd" else "bwd"],
            **({"diff_vs_bf16": r["diff_vs_bf16"]} if name in BF16_TWIN
               else {})})
    # the forward with its split, and the backward pair as a training step
    # runs it (the split, dQ and dK/dV), beside SDPA's f32 calls
    by = {r["name"].split("@")[0]: r for r in rows}
    if "split_ms" in by.get("flash_fwd", {}):
        fwd_row = by["flash_fwd"]
        log(f"f32-storage forward [{tag}]: split {fwd_row['split_ms']:.4f} "
            f"+ kernel {fwd_row['ms']:.4f} = "
            f"{fwd_row['split_ms'] + fwd_row['ms']:.4f} ms; SDPA's f32 "
            f"forward {fwd_row['library_ms']:.4f} ms")
    if "split_ms" in by.get("flash_dq", {}) and "flash_dkv" in by:
        dq_row, dkv_row = by["flash_dq"], by["flash_dkv"]
        pair = dq_row["split_ms"] + dq_row["ms"] + dkv_row["ms"]
        for r in (dq_row, dkv_row):
            r["pair_ms"] = pair
        log(f"f32-storage backward pair [{tag}]: split "
            f"{dq_row['split_ms']:.4f} + dQ {dq_row['ms']:.4f} + dK/dV "
            f"{dkv_row['ms']:.4f} = {pair:.4f} ms; SDPA's f32 backward "
            f"{dq_row['library_ms']:.4f} ms")
    return rows


def padded_phase(B, L, H, D, dtype_name, causal, block, impl="bf16"):
    """flash attention at a head_dim or length the kernels do not take,
    through the padding on the card (ops.flash_attention.padded_fwd and
    padded_bwd under dot strategy `impl`: bf16, the storage dtype's
    kernels, or f32, the f32-dot kernels on bf16 storage), against the
    plain versions at the true shape: O, LSE, dQ, dK and dV, under the
    kernel phase's limits (f32-dot on bf16 storage also the share of
    entries that differ), and what a kernel skipping one `block`-row tile
    would read there."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    dt = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, do = (torch.randn(B, L, H, D, device="cuda", dtype=dt,
                               generator=g) for _ in range(4))
    sc = 1.0 / math.sqrt(D)
    fa.reset_launch_counts()
    o, lse, saved = fa.padded_fwd(q, k, v, causal, sc, impl)
    grads = fa.padded_bwd(saved, do, causal, sc, impl)
    torch.cuda.synchronize()
    instances = sorted(fa.INSTANCE_LAUNCHES)
    f32_dots = impl == "f32"

    def plain(*x):
        o_p, lse_p = fa.flash_fwd_plain(*x[:3], causal, sc, f32_dots)
        acc = torch.promote_types(o_p.dtype, torch.float32)
        delta = (x[3].to(acc) * o_p.to(acc)).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        return (o_p, lse_p, delta,
                *fa.flash_bwd_plain(*x, lse_p, delta, causal, sc, f32_dots))

    ref = plain(q, k, v, do)
    # f32 storage: against the plain version in f64 (see REL_TOL)
    want = (plain(*(x.double() for x in (q, k, v, do)))
            if dtype_name == "float32" else ref)
    share_checked = f32_dots and dtype_name == "bfloat16"
    tol = REL_TOL["f32dot-bfloat16" if share_checked else dtype_name]
    outs = dict(zip(("O", "dQ", "dK", "dV"), (o, *grads)))
    wants = dict(zip(("O", "dQ", "dK", "dV"), (want[0], *want[3:])))
    errs = {n: row_err(outs[n], wants[n]) for n in outs}
    fault, lse_fault = fault_readings(q, k, v, do, sc, ref, T=block)
    lse_err = abs_err(lse, want[1])
    Lp, Dp = fa.kernel_shape(L, D)
    tag = (f"B={B} L={L} H={H} D={D} {dtype_name} causal={causal} impl "
           f"{impl}, padded to L={Lp} D={Dp}")
    log(f"padded flash vs plain [{tag}] ({', '.join(instances)}): "
        f"row-normalised err "
        f"{ {n: f'{e:.3e}' for n, e in errs.items()} } (tol {tol}; a kernel "
        f"skipping one {block}-row tile reads "
        f"{ {n: f'{fault[n]:.3e}' for n in errs} }), LSE abs err "
        f"{lse_err:.3e} (tol {LSE_ATOL}; skipping: {lse_fault:.3e})")
    if share_checked:
        shares = {n: mismatch_share(outs[n], wants[n]) for n in outs}
        log(f"  share of entries that differ "
            f"{ {n: f'{x:.3e}' for n, x in shares.items()} } (limit "
            f"{SHARE_TOL})")
        for n, x in shares.items():
            check(x <= SHARE_TOL, f"padded {n}: {x:.3e} of its entries "
                                  f"differ from the f32-dot plain version "
                                  f"[{tag}], limit {SHARE_TOL}")
    if Dp == 256:
        fwd = fa.STRATEGY_KERNELS[impl][0]
        want_fwd = (D256_INSTANCES if dtype_name == "bfloat16"
                    else D256_F32_INSTANCES)[fwd]
        check(want_fwd in instances, f"the padded forward at D = 256 "
                                     f"[{tag}] did not launch {want_fwd}: "
                                     f"{instances}")
    for n, e in errs.items():
        check(e <= tol, f"padded {n} disagrees with the plain version "
                        f"[{tag}]: {e:.3e} > {tol}")
        check(fault[n] > tol, f"the padded {n} check would pass a kernel "
                              f"that skips a tile [{tag}]")
    check(lse_err <= LSE_ATOL, f"padded LSE disagrees [{tag}]: {lse_err}")
    check(lse_fault > LSE_ATOL, f"the padded LSE check would pass a kernel "
                                f"that skips a tile [{tag}]")


def probe_phase():
    """The dot-form probe on the card: its four products against the exact
    ones, the caps it yields and the strategy "auto" picks from them (on an
    H100, bf16). Returns the probe's kernels row."""
    import torch

    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.ops import flash_attention as fa

    a, a32, b = fa.probe_inputs("cuda")
    got = fa.flash_probe_cuda(a, a32, b)
    want = fa.flash_probe_plain(a, a32, b)
    err = abs_err(got, want)
    forms = ("NT", "TN", "NN", "f32-transposed")
    exact = {f: bool(torch.equal(x, y)) for f, x, y in zip(forms, got, want)}
    log(f"probe vs exact products: {exact}, max abs err {err}")
    check(err == 0.0, f"the probe's products are not exact: {err}")
    caps = fa.probe_caps(torch.device("cuda", 0))
    set_flags({"flash_dot_impl": "auto"})
    fa._IMPL_MEMO.clear()
    picked = fa.resolve_dot_impl(torch.device("cuda", 0))
    log(f"probe caps {caps}; FLAGS_flash_dot_impl=auto resolves to {picked}")
    check(picked == "bf16", f"auto resolved to {picked} on this card, not "
                            f"bf16: caps {caps}")
    n = a.shape[0]
    flops = 4 * 2 * n ** 3
    b_ = bound(flops, sum(x.numel() * x.element_size()
                          for x in (a, a32, b, got)), "bfloat16")
    ms = median_ms(lambda: fa.flash_probe_cuda(a, a32, b))
    return {"name": "flash_probe", "route": "cuda",
            "source": "paddle_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": f"{REF}:{REPLACES['flash_probe']}",
            "max_abs_err": err, "caps": caps,
            "ms": ms, "tflops": flops / ms * 1e-9,
            "plain_ms": median_ms(lambda: fa.flash_probe_plain(a, a32, b)),
            "bound_ms": b_[0], "bound_by": b_[1], "library_ms": None}


def reference_layout_weights(cfg, seed):
    """Seeded random weights at full width, laid out under the JAX scan
    model's parameter names and shapes (Linear weights [in, out], stacked
    over layers), as `paddle_tpu` would hand them over."""
    import numpy as np

    rng = np.random.default_rng(seed)
    L, D, F, V = cfg.num_layers, cfg.hidden_size, cfg.ffn_hidden, \
        cfg.vocab_size

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    ones = lambda *s: np.ones(s, np.float32)     # noqa: E731
    zeros = lambda *s: np.zeros(s, np.float32)   # noqa: E731
    return {
        "wte.weight": normal(V, D), "wpe.weight": normal(cfg.max_seq_len, D),
        "ln1_w": ones(L, D), "ln1_b": zeros(L, D),
        "qkv_w": normal(L, D, 3 * D), "qkv_b": zeros(L, 3 * D),
        "out_w": normal(L, D, D), "out_b": zeros(L, D),
        "ln2_w": ones(L, D), "ln2_b": zeros(L, D),
        "fc1_w": normal(L, D, F), "fc1_b": zeros(L, F),
        "fc2_w": normal(L, F, D), "fc2_b": zeros(L, D),
        "ln_f.weight": ones(D), "ln_f.bias": zeros(D),
    }


def training_phase(label, impl, weights, cfg, steps, o2=True,
                   plain_tol=None, bf16_loss=None, instances=()):
    """`cfg` at bench.py's batch 8 x seq 1024 from `weights` (the same
    batch in every phase), `steps` TrainStep steps under
    FLAGS_flash_dot_impl=impl, bf16 O2 with f32 masters (`o2`) or in f32.
    Checks that the loss is finite and falls, that each of the strategy's
    three kernels launched once per layer and step and no other flash
    kernel launched (the probe once under auto), the step-1 loss against
    the einsum attention on the same model (`plain_tol`) and against the
    bf16 phase's (`bf16_loss`: the nn, nn2 and f32 strategies), and that
    each kernel instance in `instances` (a whole instance name, or a
    kernel's name for any instance of it) launched once per layer and step,
    as the only instance of its kernel's family (forward, dQ or dK/dV).
    Returns (launches, losses)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.framework_io import params_from_paddle_tpu
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.nn.functional_more import \
        fused_linear_cross_entropy
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    batch, seq = 8, 1024
    t0 = time.time()
    set_flags({"flash_dot_impl": impl})
    model = GPTForCausalLM(cfg, device="cuda")
    model.load_state_dict(params_from_paddle_tpu(weights))
    model.train()
    if o2:
        model = amp.decorate(model, level="O2", dtype="bfloat16")
    opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                multi_precision=o2)

    def loss_fn(m, ids, labels):
        return fused_linear_cross_entropy(m.hidden(ids), m.head_weight(),
                                          labels, transpose_y=True,
                                          chunk=2048)

    step = TrainStep(model, opt, loss_fn)
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int64)
    labels = np.roll(ids, -1, axis=1)
    ids_t = torch.as_tensor(ids, device="cuda")
    labels_t = torch.as_tensor(labels, device="cuda")
    head_dim = cfg.hidden_size // cfg.num_heads
    log(f"[{label}] {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_heads} heads (head_dim {head_dim}), "
        f"{'bf16 O2' if o2 else 'f32'}, impl {impl}: "
        f"{sum(p.numel() for p in model.parameters())} parameters, set-up "
        f"{time.time() - t0:.1f} s")

    plain_loss = None
    if plain_tol is not None:
        # step 1's loss through the plain einsum attention, same weights
        set_flags({"use_flash_attention": False})
        try:
            with torch.no_grad():
                plain_loss = float(loss_fn(model, ids_t, labels_t))
        finally:
            set_flags({"use_flash_attention": True})
    fa._IMPL_MEMO.clear()     # so that an auto run's first attention probes

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = step(ids_t, labels_t)
        losses.append(float(loss))   # waits for the step
        times.append(time.perf_counter() - t)
    launches = dict(fa.LAUNCHES)
    by_instance = dict(fa.INSTANCE_LAUNCHES)
    resolved = fa.resolve_dot_impl(torch.device("cuda", 0))

    log(f"[{label}] resolved to {resolved}; losses {losses}; launches "
        f"{ {n: c for n, c in launches.items() if c} }; by kernel instance "
        f"{by_instance}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"[{label}] loss did not fall: {losses}")
    if plain_loss is not None:
        diff = abs(losses[0] - plain_loss)
        log(f"[{label}] step-1 loss: kernels {losses[0]:.6f}, plain "
            f"attention {plain_loss:.6f}, diff {diff:.2e} (tol {plain_tol})")
        check(diff <= plain_tol, f"[{label}] step-1 loss {losses[0]} "
                                 f"disagrees with plain attention "
                                 f"{plain_loss}")
    if bf16_loss is not None:
        tol = LOSS_F32_ATOL if impl == "f32" else LOSS_SAME_ATOL
        diff = abs(losses[0] - bf16_loss)
        log(f"[{label}] step-1 loss vs the bf16 phase's: {losses[0]!r} vs "
            f"{bf16_loss!r}, diff {diff:.3e} (tol {tol})")
        check(diff <= tol, f"[{label}] step-1 loss {losses[0]} vs bf16 "
                           f"{bf16_loss}: {diff} > {tol}")
    want = cfg.num_layers * steps
    mine = set(fa.STRATEGY_KERNELS[resolved])
    for name, n in launches.items():
        expected = (want if name in mine else
                    int(impl == "auto") if name == "flash_probe" else 0)
        check(n == expected, f"[{label}] {name} launched {n} times in "
                             f"{steps} steps, expected {expected}")
    for inst in instances:
        family = inst.split("_")[1]      # fwd, dq or dkv
        mine = {i: n for i, n in by_instance.items()
                if i.split("_")[1] == family}
        check(len(mine) == 1 and all(is_instance(i, inst) and n == want
                                     for i, n in mine.items()),
              f"[{label}] the {family} launches by instance are {mine}, "
              f"expected {want} of {inst}")
    step_s = statistics.median(times[1:])
    log(f"[{label}] step times s {times}; median of steps 2-{steps}: "
        f"{step_s:.4f} s, {batch * seq / step_s:.0f} tokens/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_step(step, ids_t, labels_t, step_s, cfg.vocab_size,
                 top=12 if label in ("auto", "f32-model") else 6)
    set_flags({"flash_dot_impl": "auto"})
    del step, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, losses


# ------------------------------------------------------ trainer phases --
def trainer_model(weights, cfg, dropout=0.0, o2=True):
    """gpt3-medium (`cfg`) on the card from `weights`, in train mode, with
    `dropout`; bf16 O2 unless `o2` is False (f32 parameters)."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework_io import params_from_paddle_tpu
    from paddle_tpu_torch.models import GPTForCausalLM

    gc.collect()
    torch.cuda.empty_cache()
    model = GPTForCausalLM(type(cfg)(**{**vars(cfg), "dropout": dropout}),
                           device="cuda")
    model.load_state_dict(params_from_paddle_tpu(weights))
    model.train()
    return amp.decorate(model, level="O2", dtype="bfloat16") if o2 \
        else model


def trainer_batch(cfg, batch):
    """bench.py's batch (ids from default_rng(SEED), labels the ids
    shifted) at `batch` x 1024 on the card, and a float per-token loss
    weight of ones: the floating batch element that the chaos harness's
    `step:nan` poisons (ids and labels are integers)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, cfg.vocab_size, (batch, 1024)).astype(np.int64)
    return (torch.as_tensor(ids, device="cuda"),
            torch.as_tensor(np.roll(ids, -1, axis=1), device="cuda"),
            torch.ones(batch, 1024, device="cuda"))


def trainer_loss(m, ids, labels, weight):
    """The fused LM-head CE (bench.py's), times the batch's mean loss
    weight (1, or NaN once poisoned)."""
    from paddle_tpu_torch.nn.functional_more import \
        fused_linear_cross_entropy

    return fused_linear_cross_entropy(m.hidden(ids), m.head_weight(),
                                      labels, transpose_y=True,
                                      chunk=2048) * weight.mean()


def decay_gate(name):
    """AdamW's apply_decay_param_fun: no decay of biases and LayerNorms."""
    return not (name.endswith(".bias") or ".ln" in name)


def run_steps(step, batch, n, per_step=1):
    """`n` optimizer steps of `step`, `per_step` calls each (micro-batches
    split from `batch` along rows); returns (losses of every call, host
    seconds of each step, synchronised)."""
    import torch

    rows = batch[0].shape[0] // per_step
    losses, times = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(per_step):
            losses.append(float(step(*(x[i * rows:(i + 1) * rows]
                                       for x in batch))))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return losses, times


def flash_counts():
    from paddle_tpu_torch.ops import flash_attention as fa

    return {n: c for n, c in fa.LAUNCHES.items() if c}


def gib(nbytes):
    return round(nbytes / 2**30, 3)


def mask_draw_ms(shape, reps=3):
    """Device ms of one dropout mask of `shape` (threefry float64
    uniforms below 0.9, plain PyTorch), the median of `reps` draws."""
    import torch

    from paddle_tpu_torch.core import rng

    key = rng.fold_in(rng.key(SEED), 1).cuda()
    times = []
    for _ in range(reps + 1):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        rng.bernoulli(key, 0.9, shape)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times[1:])


def train_full_phase(weights, cfg):
    """gpt3-medium with dropout 0.1, bf16 O2, batch 8 as two micro-batches
    of 4 (accumulate_steps=2), TRAIN_FULL_STEPS steps of AdamW (f32
    masters) under LinearWarmup(CosineAnnealingDecay), ClipGradByGlobalNorm
    (1.0) and a decay gate sparing biases and LayerNorms, skip_bad_steps
    with the chaos rule step:nan:3 (the first micro-batch of step 2).
    Checks: no flash launch (attention dropout takes the einsum), the lr
    of each update equal to a CPU scheduler's, every post-clip global norm
    <= 1 (1 + 1e-6), exactly one dropped micro-batch and no skipped
    update, every loss finite but the poisoned one's, and a dropout mask
    drawn on the card equal to the same key's on the CPU. Returns (its
    line, the model, the optimizer)."""
    import torch

    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm, lr

    class RecordingClip(ClipGradByGlobalNorm):
        """The clip, recording the global norm of what it returns."""

        post = []

        def _apply(self, params_grads):
            out = super()._apply(params_grads)
            self.post.append(float(self.global_norm([g for _, g in out])))
            return out

    def schedule():
        return lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4, T_max=8),
                               warmup_steps=2, start_lr=1e-5, end_lr=1e-4)

    t0 = time.time()
    model = trainer_model(weights, cfg, dropout=0.1)
    clip = RecordingClip(1.0)
    opt = AdamW(schedule(), parameters=model.parameters(),
                weight_decay=0.01, apply_decay_param_fun=decay_gate,
                grad_clip=clip, multi_precision=True)
    step = TrainStep(model, opt, trainer_loss, accumulate_steps=2,
                     skip_bad_steps=True)
    batch = trainer_batch(cfg, 8)
    cpu_sched = schedule()
    rng.seed(SEED)
    set_flags({"chaos_spec": "step:nan:3"})
    fa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, times, lrs, want_lrs = [], [], [], []
    try:
        for _ in range(TRAIN_FULL_STEPS):
            ls, ts = run_steps(step, batch, 1, per_step=2)
            losses += ls
            times += ts
            lrs.append(step.last_lr)
            want_lrs.append(cpu_sched())
            opt._learning_rate.step()
            cpu_sched.step()
    finally:
        set_flags({"chaos_spec": ""})
    peak = torch.cuda.max_memory_allocated()
    launches = flash_counts()
    log(f"[train-full] losses {losses}; lr {lrs}; post-clip norms "
        f"{clip.post}; bad micro {step.bad_micro_count}, bad steps "
        f"{step.bad_step_count}; flash launches {launches}")
    check(not launches, f"[train-full] flash launched {launches} with "
                        f"attention dropout")
    check(lrs == want_lrs, f"[train-full] lr {lrs} != the scheduler's "
                           f"{want_lrs}")
    check(len(clip.post) == TRAIN_FULL_STEPS
          and all(n <= 1.0 * (1 + 1e-6) for n in clip.post),
          f"[train-full] post-clip global norms {clip.post}")
    check(step.bad_micro_count == 1 and step.bad_step_count == 0,
          f"[train-full] bad micro {step.bad_micro_count}, bad steps "
          f"{step.bad_step_count}; expected 1 and 0")
    check([i for i, x in enumerate(losses) if not math.isfinite(x)] == [2],
          f"[train-full] losses {losses}: only the 3rd call's may be NaN")
    # one mask of the embedding dropout's shape at micro-batch 4, drawn on
    # the card and on the CPU from one key
    key = rng.fold_in(rng.key(SEED), 7)
    card = rng.bernoulli(key.cuda(), 0.9, (4, 1024, cfg.hidden_size))
    cpu = rng.bernoulli(key, 0.9, (4, 1024, cfg.hidden_size))
    check(torch.equal(card.cpu(), cpu), "[train-full] the card's dropout "
                                        "mask differs from the CPU's")
    # what drawing the masks costs: per micro-batch, 24 attention masks
    # [4, 16, 1024, 1024] and 49 of the hidden states [4, 1024, 1024]
    attn_ms = mask_draw_ms((4, cfg.num_heads, 1024, 1024))
    hid_ms = mask_draw_ms((4, 1024, cfg.hidden_size))
    step_ms = statistics.median(times[1:]) * 1e3
    masks_ms = 2 * (cfg.num_layers * attn_ms
                    + (2 * cfg.num_layers + 1) * hid_ms)
    line = {"steps": TRAIN_FULL_STEPS, "micro_batch": 4,
            "step_ms": [round(t * 1e3, 1) for t in times],
            "median_step_ms": round(step_ms, 1),
            "tokens_per_s": round(8 * 1024 / (step_ms / 1e3)),
            "peak_gib": gib(peak), "losses": losses, "lr": lrs,
            "post_clip_norm": clip.post,
            "bad_micro_count": step.bad_micro_count,
            "bad_step_count": step.bad_step_count,
            "attn_mask_ms": round(attn_ms, 3),
            "hidden_mask_ms": round(hid_ms, 3),
            "mask_ms_per_step": round(masks_ms, 1),
            "mask_share": round(masks_ms / step_ms, 3),
            "flash_launches": 0, "s": round(time.time() - t0, 1)}
    log(f"[train-full] {json.dumps(line)}")
    return line, model, opt


def skip_bad_phase(weights, cfg):
    """gpt3-medium, dropout 0, bf16 O2, batch 8, 3 AdamW steps with
    skip_bad_steps and step:nan:2: parameters, f32 masters and moments
    bitwise the same after step 2 as before it; bad_step_count 1; the
    flash kernels launched by steps 1-3 (the poisoned step runs forward
    and backward too)."""
    import torch

    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    t0 = time.time()
    model = trainer_model(weights, cfg)
    opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                multi_precision=True)
    step = TrainStep(model, opt, trainer_loss, skip_bad_steps=True)
    batch = trainer_batch(cfg, 8)
    fa.resolve_dot_impl(torch.device("cuda", 0))    # no probe in the count
    set_flags({"chaos_spec": "step:nan:2"})
    fa.reset_launch_counts()
    try:
        losses, times = run_steps(step, batch, 1)
        before = [t.clone() for t in (*model.parameters(),
                                      *(v for st in opt.state.values()
                                        for v in st.values()))]
        ls, ts = run_steps(step, batch, 1)
        losses += ls
        times += ts
        after = [*model.parameters(),
                 *(v for st in opt.state.values() for v in st.values())]
        same = len(before) == len(after) and all(
            torch.equal(a, b) for a, b in zip(before, after))
        del before
        ls, ts = run_steps(step, batch, 1)
        losses += ls
        times += ts
    finally:
        set_flags({"chaos_spec": ""})
    launches = flash_counts()
    log(f"[skip-bad] losses {losses}; state unchanged across step 2: "
        f"{same}; bad steps {step.bad_step_count}; launches {launches}")
    check(same, "[skip-bad] the state moved across the skipped step")
    check(step.bad_step_count == 1, f"[skip-bad] bad_step_count "
                                    f"{step.bad_step_count}")
    check(math.isfinite(losses[0]) and math.isfinite(losses[2])
          and not math.isfinite(losses[1]),
          f"[skip-bad] losses {losses}")
    check(sum(launches.values()) == 3 * 3 * cfg.num_layers,
          f"[skip-bad] flash launches {launches}")
    line = {"losses": losses, "bad_step_count": step.bad_step_count,
            "state_unchanged": same,
            "step_ms": [round(t * 1e3, 1) for t in times],
            "s": round(time.time() - t0, 1)}
    del step, opt, model
    return line


def recompute_phase(weights, cfg):
    """gpt3-medium, dropout 0, bf16 O2 under auto, batch 8: RECOMPUTE_STEPS
    AdamW steps without recompute and, on the same weights and batch,
    with `recompute_wrap_sublayers` on all 24 blocks: the same losses
    (RECOMPUTE_LOSS_RTOL), launches per step of the strategy's kernels
    (forward twice a layer under recompute, dQ and dK/dV once), peak
    memory of both; then batch 32 with recompute (bench.py's
    batch32_remat): tokens/s and peak memory."""
    import torch

    from paddle_tpu_torch.distributed import recompute_wrap_sublayers
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    t0 = time.time()
    # resolve auto now, so that no probe launch falls in a counted step
    resolved = fa.resolve_dot_impl(torch.device("cuda", 0))
    blocks = [f"gpt.blocks.{i}" for i in range(cfg.num_layers)]
    runs = {}
    for label, batch_n, remat in (("plain", 8, False), ("remat", 8, True),
                                  ("remat-b32", 32, True)):
        model = trainer_model(weights, cfg)
        if remat:
            recompute_wrap_sublayers(model, blocks)
        opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                    multi_precision=True)
        step = TrainStep(model, opt, trainer_loss)
        batch = trainer_batch(cfg, batch_n)
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        losses, times = run_steps(step, batch, RECOMPUTE_STEPS)
        step_s = statistics.median(times[1:])
        runs[label] = {"losses": losses, "launches": flash_counts(),
                       "peak_gib": gib(torch.cuda.max_memory_allocated()),
                       "step_ms": round(step_s * 1e3, 1),
                       "tokens_per_s": round(batch_n * 1024 / step_s)}
        log(f"[recompute] {label}: {json.dumps(runs[label])}")
        del step, opt, model, batch
    fwd, dq, dkv = fa.STRATEGY_KERNELS[resolved]
    n = cfg.num_layers * RECOMPUTE_STEPS
    for label in ("remat", "remat-b32"):
        want = {fwd: 2 * n, dq: n, dkv: n}
        check(runs[label]["launches"] == want,
              f"[recompute] {label} launches {runs[label]['launches']}, "
              f"expected {want}")
    check(runs["plain"]["launches"] == {fwd: n, dq: n, dkv: n},
          f"[recompute] plain launches {runs['plain']['launches']}")
    a, b = runs["plain"]["losses"], runs["remat"]["losses"]
    bitwise = a == b
    diff = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    log(f"[recompute] losses without {a}, with {b}: bitwise {bitwise}, "
        f"largest relative difference {diff:.3e} "
        f"(limit {RECOMPUTE_LOSS_RTOL})")
    check(diff <= RECOMPUTE_LOSS_RTOL, f"[recompute] losses {b} part from "
                                       f"{a}")
    line = {**runs, "bitwise": bitwise, "max_rel_diff": diff,
            "per_step": {"flash_fwd": 2 * cfg.num_layers,
                         "dq": cfg.num_layers, "dkv": cfg.num_layers},
            "s": round(time.time() - t0, 1)}
    return line


def o1_phase(weights, cfg):
    """gpt3-medium with f32 parameters, dropout 0, batch 8: O1_STEPS eager
    steps of amp.auto_cast O1 (bf16) with GradScaler and AdamW's
    optimizer.step(): finite losses, and the scaler's state the
    reference's rules give for that many finite steps."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    t0 = time.time()
    model = trainer_model(weights, cfg, o2=False)
    opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01)
    scaler = amp.GradScaler()
    batch = trainer_batch(cfg, 8)
    fa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(O1_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = trainer_loss(model, *batch)
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    state = scaler.state_dict()
    want = {"scale": 2.0 ** 16, "good_steps": O1_STEPS, "bad_steps": 0}
    launches = flash_counts()
    log(f"[o1] losses {losses}; scaler {state}; launches {launches}")
    check(all(math.isfinite(x) for x in losses), f"[o1] losses {losses}")
    check(state == want, f"[o1] scaler state {state}, expected {want}")
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          "[o1] a parameter left f32")
    line = {"losses": losses, "scaler": state, "launches": launches,
            "step_ms": [round(t * 1e3, 1) for t in times],
            "peak_gib": gib(torch.cuda.max_memory_allocated()),
            "s": round(time.time() - t0, 1)}
    del opt, model
    return line


def chunked_phase(weights, cfg):
    """gpt3-medium, dropout 0, bf16 O2, batch 8, flash off: one step
    through the chunked query scan (FLAGS_attention_chunk 256: 4 chunks a
    layer) and one through the full einsum (attention_chunk 0), each on
    a fresh model of the same weights: the losses within CHUNKED_RTOL,
    the chunks counted, peak memory of both."""
    import torch

    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    t0 = time.time()
    out = {}
    set_flags({"use_flash_attention": False})
    try:
        for label, chunk in (("chunked", 256), ("einsum", 0)):
            set_flags({"attention_chunk": chunk})
            model = trainer_model(weights, cfg)
            opt = AdamW(1e-4, parameters=model.parameters(),
                        multi_precision=True)
            step = TrainStep(model, opt, trainer_loss)
            batch = trainer_batch(cfg, 8)
            torch.cuda.reset_peak_memory_stats()
            before = F.CHUNKED_CALLS["chunks"]
            losses, times = run_steps(step, batch, 1)
            out[label] = {"loss": losses[0],
                          "chunks": F.CHUNKED_CALLS["chunks"] - before,
                          "step_ms": round(times[0] * 1e3, 1),
                          "peak_gib": gib(torch.cuda.max_memory_allocated())}
            del step, opt, model, batch
    finally:
        set_flags({"use_flash_attention": True, "attention_chunk": 256})
    diff = abs(out["chunked"]["loss"] - out["einsum"]["loss"]) / \
        abs(out["einsum"]["loss"])
    log(f"[chunked] {json.dumps(out)}; relative loss difference "
        f"{diff:.3e} (limit {CHUNKED_RTOL})")
    check(out["chunked"]["chunks"] == cfg.num_layers * 1024 // 256,
          f"[chunked] {out['chunked']['chunks']} chunks, expected "
          f"{cfg.num_layers * 4}")
    check(out["einsum"]["chunks"] == 0, "[chunked] the einsum run chunked")
    check(diff <= CHUNKED_RTOL, f"[chunked] loss {out['chunked']['loss']} "
                                f"vs the einsum's {out['einsum']['loss']}")
    return {**out, "rel_diff": diff, "s": round(time.time() - t0, 1)}


def ckpt_phase(model, opt):
    """The train-full model (bf16) and its optimizer saved with
    framework_io.save in the reference's layout; the optimizer's file
    loaded back equal bitwise; the model's served by `python -m
    paddle_tpu_torch.inference.serve --generate gpt3-medium --state-dict`
    in a subprocess, which must answer /healthz within CLI_START_S and one
    /generate. Files and process removed."""
    import shutil
    import socket

    import torch

    from paddle_tpu_torch import framework_io as fio

    t0 = time.time()
    root = os.path.dirname(os.path.abspath(__file__))
    ckdir = os.path.join(root, "build", "trainer_ckpt")
    os.makedirs(ckdir, exist_ok=True)
    model_path = os.path.join(ckdir, "gpt3-medium-bf16.pdparams")
    opt_path = os.path.join(ckdir, "gpt3-medium-bf16.pdopt")
    names = [n for n, _ in model.named_parameters()]
    try:
        t = time.perf_counter()
        fio.save(fio.params_to_paddle_tpu(model.state_dict()), model_path)
        fio.save(fio.transpose_optimizer_state(opt.state_dict(), names),
                 opt_path)
        save_s = time.perf_counter() - t
        sizes = {"model_gib": gib(os.path.getsize(model_path)),
                 "optimizer_gib": gib(os.path.getsize(opt_path))}
        back = fio.transpose_optimizer_state(fio.load(opt_path), names)
        live = opt.state_dict()
        same = back.keys() == live.keys() and all(
            torch.equal(v.cpu(), back[k]) if isinstance(v, torch.Tensor)
            else v == back[k] for k, v in live.items())
        check(same, "[ckpt] the optimizer state read back differs")
        del back, live
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        logpath = os.path.join(ckdir, "serve.log")
        t = time.perf_counter()
        with open(logpath, "w") as logf:
            proc = subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch.inference.serve",
                 "--generate", "gpt3-medium", "--state-dict", model_path,
                 "--http", str(port)], cwd=root, stdout=logf,
                stderr=subprocess.STDOUT)
        url = f"http://127.0.0.1:{port}"
        try:
            while True:
                if proc.poll() is not None:
                    with open(logpath) as f:
                        raise SmokeFailure(f"[ckpt] the server exited: "
                                           f"{f.read()[-2000:]}")
                try:
                    if http_get(url + "/healthz")[0] == 200:
                        break
                except OSError:
                    pass
                check(time.perf_counter() - t < CLI_START_S,
                      f"[ckpt] no /healthz answer within {CLI_START_S} s")
                time.sleep(0.5)
            healthz_s = time.perf_counter() - t
            body, _ = http_post(url + "/generate", {
                "input_ids": list(range(1, 17)), "max_new_tokens": 8})
            check(len(body["tokens"]) == 8, f"[ckpt] /generate gave {body}")
        finally:
            proc.terminate()
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(30)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    line = {**sizes, "save_s": round(save_s, 1), "healthz_s":
            round(healthz_s, 1), "optimizer_round_trip": True,
            "s": round(time.time() - t0, 1)}
    log(f"[ckpt] {json.dumps(line)}")
    return line


def trainer_phases(weights, cfg):
    """The trainer's phases at gpt3-medium; returns the `trainer` line."""
    import torch

    t0 = time.time()
    line = {}
    line["train_full"], model, opt = train_full_phase(weights, cfg)
    line["ckpt"] = ckpt_phase(model, opt)
    del model, opt
    line["skip_bad"] = skip_bad_phase(weights, cfg)
    line["recompute"] = recompute_phase(weights, cfg)
    line["o1"] = o1_phase(weights, cfg)
    line["chunked"] = chunked_phase(weights, cfg)
    line["card"] = card_line()
    line["s"] = round(time.time() - t0, 1)
    gc.collect()
    torch.cuda.empty_cache()
    return line


def top2_margin(logits):
    """Top logit minus the runner-up."""
    import torch

    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def prefix_logits(model, eng, prefix):
    """The logits after `prefix` (1-D ids) on each path, each from its
    own full-prefix pass: GPTForCausalLM.generate's prefill (the cached
    attention) and the engine's prefill body (its own LayerNorm and
    attention, into a pool row of its own)."""
    import torch

    from paddle_tpu_torch.inference.serving import generate as gen

    cfg = model.cfg
    H, Dh, P = cfg.num_heads, cfg.hidden_size // cfg.num_heads, len(prefix)
    ids = torch.as_tensor(prefix, device="cuda")[None]
    with torch.inference_mode():
        caches = [{"k": torch.zeros(1, P, H, Dh, device="cuda"),
                   "v": torch.zeros(1, P, H, Dh, device="cuda"), "pos": 0}
                  for _ in model.gpt.blocks]
        h = model.gpt(ids, caches=caches)
        by_model = model._logits_from_hidden(h[0, -1])
        pool = torch.zeros(1, cfg.num_layers, P, H, Dh, device="cuda")
        by_engine, _, _ = gen._prefill_core(
            eng._params_for(torch.device("cuda", 0)), pool, pool.clone(), 0,
            ids, P, H, cfg.layer_norm_eps)
    return by_model, by_engine


def serving_margins(model, eng, prefix, sample=None, step=0):
    """The top-2 margins of the logits the token after `prefix` is drawn
    from, on each of prefix_logits' two passes: the logits themselves
    (greedy), or with `sample` (a request's temperature, top_k, top_p and
    seed) the filtered logits plus the Gumbel noise of the request's
    `step`-th token. Returns (margins, whether the two passes keep the
    same top-k/top-p set)."""
    import torch

    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.inference.serving import generate as gen

    logits = prefix_logits(model, eng, prefix)
    if sample is None:
        return tuple(top2_margin(x) for x in logits), True
    key = rng.key(sample["seed"])
    for _ in range(step + 1):
        key, sub = rng.split(key)
    drawn, kept = [], []
    for x in logits:
        f = gen._filter_logits(x[None], torch.tensor([sample["temperature"]]),
                               torch.tensor([sample["top_k"]]),
                               torch.tensor([sample["top_p"]]))[0]
        kept.append(f > -1e29)
        drawn.append(f + rng.gumbel(sub[None].to(f.device),
                                    (f.shape[-1],))[0])
    return (tuple(top2_margin(x) for x in drawn),
            bool(torch.equal(kept[0], kept[1])))


def token_agreement(label, model, eng, prompt, got, ref, sample=None):
    """Tokens `got` against `ref` after `prompt`: they may part first only
    where both passes' top-2 margins (serving_margins) are under
    SERVING_MARGIN, or where the passes keep different sampling sets.
    Returns the row of the check."""
    import numpy as np

    j = next((k for k, (a, b) in enumerate(zip(ref, got)) if a != b), None)
    row = {"prompt": len(prompt), "first_mismatch": j}
    if j is None:
        check(len(got) == len(ref), f"[{label}] {len(got)} tokens against "
                                    f"{len(ref)}")
        return row
    margins, same_set = serving_margins(
        model, eng, np.concatenate([prompt, got[:j]]), sample, j)
    row.update(margins=margins, same_set=same_set)
    log(f"[{label}] prompt {len(prompt)}: tokens part at step {j}; top-2 "
        f"margins there {margins}, same sampling set {same_set}")
    check(not same_set or max(margins) < SERVING_MARGIN,
          f"[{label}] prompt {len(prompt)}: tokens part at step {j} with "
          f"top-2 margins {margins} (limit {SERVING_MARGIN})")
    return row


def burst(eng, prompts, new, **samp):
    """All `prompts` submitted at once: (tokens of each, the peak of
    allocated device memory during the burst above its start)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    handles = [eng.submit(p, new, **samp) for p in prompts]
    out = [h.result(300)["tokens"] for h in handles]
    return out, torch.cuda.max_memory_allocated() - base


def engine_checks(label, eng):
    """Zero failures, requeues, sheds, rejects and first calls after
    warm-up; returns the decode step's p50 ms at batch bucket 8."""
    snap = eng.metrics.snapshot()
    for key in ("failed_total", "requeues_total", "shed_total",
                "rejected_total"):
        check(snap[key] == 0, f"[{label}] {key} is {snap[key]}")
    cold = eng.program_report()["first_calls_after_warmup"]
    check(cold == 0, f"[{label}] {cold} calls after admission ran a "
                     f"program for the first time")
    return eng.metrics.step_ms()["decode"].get(SERVING_SLOTS, {}).get("p50")


def profile_decode_step(eng, cfg, lengths):
    """One decode step of the engine's body at batch bucket
    len(lengths), on a pool of its own with rows cached to `lengths`:
    its host time (median of 5, each ending in the tokens' copy to the
    host), the least time of the bytes the step must read (every weight
    once, each row's valid K and V once), and one step under
    torch.profiler: the device time of each kernel, summed by name, and
    the device's idle share. Returns the phase's `decode_step_b8` dict."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference.serving import generate as gen

    dev = torch.device("cuda", 0)
    p = eng._params_for(dev)
    pool = eng._alloc_pool(dev)
    b = len(lengths)
    args = (torch.arange(b, device=dev),
            torch.zeros(b, dtype=torch.int64, device=dev),
            torch.tensor(lengths, device=dev))
    # greedy rows: temperature 0 (the host's sampling values and keys)
    samp = (torch.zeros(b), torch.ones(b, dtype=torch.int64), torch.ones(b),
            torch.zeros(b, 2, dtype=torch.int64))
    H = cfg.num_heads

    def step():
        nxt, _, _, _ = gen._decode_body(p, pool.buf_k, pool.buf_v, *args,
                                        *samp, eng._slots, H,
                                        cfg.layer_norm_eps)
        return nxt.cpu()

    times = []
    with torch.inference_mode():
        for _ in range(6):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step()
            times.append(time.perf_counter() - t)
        step_s = statistics.median(times[1:])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    kernels = sorted(((e.device_time_total, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(k[0] for k in kernels)
    weight_bytes = sum(t.numel() * t.element_size() for t in p.values())
    kv_bytes = 2 * 4 * cfg.num_layers * cfg.hidden_size * sum(
        n + 1 for n in lengths)
    out = {"ms": step_s * 1e3, "launches": sum(k[1] for k in kernels),
           "device_busy_ms": busy_us / 1e3,
           "idle_share": (1 - busy_us / (step_s * 1e6)) if busy_us else None,
           "bound_ms": (weight_bytes + kv_bytes) / PEAK_BYTES * 1e3,
           "bound_by": "bytes",
           "top": [[name[:60], us / 1e3, n] for us, n, name in kernels[:8]]}
    log(f"[serving] one decode step at batch {b} (lengths {lengths}): "
        f"{out['ms']:.3f} ms host, device busy {out['device_busy_ms']:.3f} "
        f"ms in {out['launches']} kernel launches, bound {out['bound_ms']:.3f}"
        f" ms (weights {weight_bytes / 1e9:.2f} GB + valid K/V "
        f"{kv_bytes / 1e9:.3f} GB)")
    for us, n, name in kernels[:12]:
        log(f"  {us / 1e3:8.3f} ms {100 * us / max(busy_us, 1):5.1f}% "
            f"x{n:<5d} {name[:90]}")
    return out


def serving_phase(weights, cfg):
    """Greedy serving on the card: GenerativeEngine (slots 8, max_context
    1024, prompt buckets pow2 8..1024) over GPTForCausalLM at `cfg`'s
    full width in f32, with `weights`. SERVING_REQUESTS requests (prompt
    lengths and ids from RandomState(SEED)) submitted at once, then one
    request alone (batch bucket 1), each asking for SERVING_NEW tokens and
    naming no eos. Checks that every request returns SERVING_NEW tokens,
    that none failed, was requeued or was shed, that the decode batch
    reached all 8 slots, that no program first ran after warm-up, that
    no flash kernel launched (the serving attention is einsum, as the
    reference's), and that the engine's tokens for the shortest and the
    longest prompt are GPTForCausalLM.generate's (or part from them first
    where both paths' top-2 logit margin is under SERVING_MARGIN). Then
    the checks beyond greedy on BEYOND_ROWS of the prompts (sampling,
    sampler, prefix cache, speculation, int8), each engine checked as the
    first. Prints and returns the `serving` line's dict."""
    import numpy as np
    import torch

    from paddle_tpu_torch.framework_io import params_from_paddle_tpu
    from paddle_tpu_torch.inference import GenerativeEngine
    from paddle_tpu_torch.inference.serving import metrics as sm
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.ops import flash_attention as fa

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = GPTForCausalLM(cfg, device="cuda")
    model.load_state_dict(params_from_paddle_tpu(weights))
    model.eval()
    fa.reset_launch_counts()
    t_warm = time.perf_counter()
    eng = GenerativeEngine(model, slots=SERVING_SLOTS, max_context=1024,
                           device="cuda")
    warm_s = time.perf_counter() - t_warm
    try:
        rng, prompts = serving_prompts(cfg)
        lens = np.array([len(p) for p in prompts])
        alone_prompt = rng.randint(
            0, cfg.vocab_size,
            size=int(rng.randint(SERVING_PROMPT[0], SERVING_PROMPT[1] + 1)))
        t1 = time.perf_counter()
        handles = [eng.submit(p, SERVING_NEW) for p in prompts]
        results = [h.result(300) for h in handles]
        wall = time.perf_counter() - t1
        occupancy = eng.metrics.max_occupancy()
        alone = eng.generate(alone_prompt, SERVING_NEW, timeout=300)
        snap = eng.metrics.snapshot()
        report = eng.program_report()
        flash = {n: c for n, c in fa.LAUNCHES.items() if c}
        log(f"[serving] {len(prompts)} requests (prompts {sorted(lens)}) in "
            f"{wall:.3f} s, then one of {len(alone_prompt)} alone; warm-up "
            f"{warm_s:.3f} s ({eng.warmup_report['warm_passes']} programs); "
            f"occupancy histogram {snap['occupancy_hist']}; programs "
            f"{report}")
        for r in results + [alone]:
            check(r["n_tokens"] == SERVING_NEW,
                  f"[serving] a request returned {r['n_tokens']} tokens, "
                  f"expected {SERVING_NEW}")
        for key in ("failed_total", "requeues_total", "shed_total",
                    "rejected_total"):
            check(snap[key] == 0, f"[serving] {key} is {snap[key]}")
        check(snap["completed_total"] == SERVING_REQUESTS + 1,
              f"[serving] {snap['completed_total']} requests completed")
        check(occupancy == SERVING_SLOTS,
              f"[serving] the decode batch reached {occupancy} rows, "
              f"expected {SERVING_SLOTS}")
        check(report["first_calls_after_warmup"] == 0,
              f"[serving] {report['first_calls_after_warmup']} calls after "
              f"admission ran a program for the first time")
        check(not flash, f"[serving] flash kernels launched: {flash}")

        agreement = {}
        for i in (int(np.argmin(lens)), int(np.argmax(lens))):
            p = prompts[i]
            ref = model.generate(torch.as_tensor(p, device="cuda")[None],
                                 max_new_tokens=SERVING_NEW)
            agreement[str(len(p))] = token_agreement(
                "serving", model, eng, p, results[i]["tokens"],
                ref[0, len(p):].tolist())
        check(not any(fa.LAUNCHES.values()),
              f"[serving] flash kernels launched in generate: "
              f"{dict(fa.LAUNCHES)}")

        decode = profile_decode_step(
            eng, cfg, [int(n) + SERVING_NEW // 2
                       for n in lens[:SERVING_SLOTS]])
        steps = eng.metrics.step_ms()
        stream_tps = sorted(
            (r["n_tokens"] - 1) / ((r["latency_ms"] - r["ttft_ms"]) / 1e3)
            for r in results)
        ttft = sm.percentiles([r["ttft_ms"] for r in results])
        line = {
            "model": "gpt3-medium", "dtype": "float32",
            "slots": SERVING_SLOTS, "requests": len(results) + 1,
            "new_tokens": SERVING_NEW, "warmup_s": warm_s,
            "ttft_ms": {"p50": ttft["p50"], "p99": ttft["p99"]},
            "tokens_per_s": len(results) * SERVING_NEW / wall,
            "stream_tokens_per_s_p50": statistics.median(stream_tps),
            "alone": {"ttft_ms": alone["ttft_ms"],
                      "tokens_per_s": (alone["n_tokens"] - 1) / (
                          (alone["latency_ms"] - alone["ttft_ms"]) / 1e3)},
            "decode_step_ms": {b: v["p50"] for b, v in
                               steps["decode"].items()},
            "decode_steps": {b: v["n"] for b, v in steps["decode"].items()},
            "prefill_ms": {b: v["p50"] for b, v in
                           steps["prefill"].items()},
            "decode_step_b8": decode,
            "kv_pool_bytes": eng.kv_pool_bytes(),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "agreement": agreement,
        }
        ps = prompts[:BEYOND_ROWS]
        greedy, f32_peak = burst(eng, ps, BEYOND_NEW)
        line["sampling"], sampled = sampling_checks(model, eng, ps)
        line["sampler"] = sampler_checks(model, eng, ps[0])
        line["prefix_cache"] = prefix_checks(model, eng, cfg)
        line["speculation"] = spec_checks(model, eng, cfg, ps, greedy,
                                          sampled)
        line["int8"] = int8_checks(model, eng, ps, greedy, f32_peak)
        line["decode_step_ms_b8"] = {
            "greedy": engine_checks("serving", eng),
            **{k: v["decode_step_ms_b8"] for k, v in line.items()
               if isinstance(v, dict) and "decode_step_ms_b8" in v}}
        check(not any(fa.LAUNCHES.values()),
              f"[serving] flash kernels launched: {dict(fa.LAUNCHES)}")
        # last: it drains the serving engine
        line["http"] = http_handoff_checks(model, eng, ps, greedy, sampled)
        line["cli"] = cli_checks(model, eng, weights, ps[0], greedy[0])
        check(not any(fa.LAUNCHES.values()),
              f"[http] flash kernels launched: {dict(fa.LAUNCHES)}")
    finally:
        eng.shutdown()
    log(f"[serving] phase took {time.time() - t0:.1f} s")
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return line


def new_engine(model, **kw):
    """A GenerativeEngine on the card as the serving phase's (8 slots at
    cap 1024) with options `kw`."""
    from paddle_tpu_torch.inference import GenerativeEngine

    return GenerativeEngine(model, slots=SERVING_SLOTS, max_context=1024,
                            device="cuda", **kw)


def free_engine(eng):
    import torch

    eng.shutdown()
    gc.collect()
    torch.cuda.empty_cache()


def sampling_checks(model, eng, ps):
    """Seeded sampling on the serving engine (no new warm-up): SAMPLE's
    tokens for `ps` submitted at once and one by one agree (margin rule);
    another seed gives other tokens; temperature 0 with any top_k, top_p
    and seed is greedy bitwise, and so is top_k=1 at temperature 5 (one
    prompt, alone, against greedy alone). The median decode step of the
    sampled burst is read apart. Returns (its line, the batched
    tokens)."""
    steps = eng.metrics._step_s[SERVING_SLOTS]
    n0 = len(steps)
    batched, _ = burst(eng, ps, BEYOND_NEW, **SAMPLE)
    sampled_ms = statistics.median(list(steps)[n0:]) * 1e3
    seq = [eng.generate(p, BEYOND_NEW, timeout=300, **SAMPLE)["tokens"]
           for p in ps]
    rows = [token_agreement("sampling", model, eng, p, a, b, SAMPLE)
            for p, a, b in zip(ps, batched, seq)]
    other = eng.generate(ps[0], BEYOND_NEW, timeout=300,
                         **dict(SAMPLE, seed=43))["tokens"]
    check(other != seq[0], "[sampling] seeds 42 and 43 gave the same "
                           "tokens")
    greedy = eng.generate(ps[0], BEYOND_NEW, timeout=300)["tokens"]
    frozen = eng.generate(ps[0], BEYOND_NEW, timeout=300, temperature=0.0,
                          top_k=5, top_p=0.5, seed=7)["tokens"]
    check(frozen == greedy, "[sampling] temperature 0 is not greedy")
    k1 = eng.generate(ps[0], BEYOND_NEW, timeout=300, temperature=5.0,
                      top_k=1, seed=9)["tokens"]
    check(k1 == greedy, "[sampling] top_k=1 is not greedy")
    parted = [r["first_mismatch"] for r in rows]
    log(f"[sampling] {len(ps)} prompts x {BEYOND_NEW} tokens, batched vs "
        f"one by one: first differences {parted}; seed 43 differs, "
        f"temperature 0 and top_k=1 equal greedy")
    return {"agreement": rows, "seed_43_differs": True,
            "temperature_0_is_greedy": True, "top_k_1_is_greedy": True,
            "distinct_tokens": len({t for r in seq for t in r}),
            "decode_step_ms_b8": sampled_ms}, batched


def sampler_checks(model, eng, prompt):
    """The sampler alone on the card: threefry bits and uniforms of 8 keys
    x vocab on CUDA equal the CPU's bitwise (the Gumbel noise is reported
    against the CPU's); SAMPLER_DRAWS draws of `_sample_rows` with
    SAMPLE's filter on the logits after `prompt` follow the filtered
    softmax (computed in f64 on the host): every draw in the kept set,
    and the total-variation distance under SAMPLER_TV_FACTOR times the
    distance expected from the draw count. Returns its line."""
    import numpy as np
    import torch

    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.inference.serving import generate as gen

    V = model.cfg.vocab_size
    keys = rng.split(rng.key(SEED), 8)
    for name, fn in (("bits", rng.random_bits), ("uniform", rng.uniform)):
        a, b = fn(keys.cuda(), (V,)), fn(keys, (V,))
        check(torch.equal(a.cpu(), b), f"[sampler] CUDA {name} differ from "
                                       f"the CPU's")
    g_err = float((rng.gumbel(keys.cuda(), (V,)).cpu()
                   - rng.gumbel(keys, (V,))).abs().max())
    logits = prefix_logits(model, eng, prompt)[1].float()
    x = logits.double().cpu().numpy() / SAMPLE["temperature"]
    order = np.argsort(-x, kind="stable")
    top = x[order[:SAMPLE["top_k"]]]
    sp = np.exp(top - top.max())
    sp /= sp.sum()
    n_keep = int(((np.cumsum(sp) - sp) < SAMPLE["top_p"]).sum())
    kept = order[:n_keep]
    p_exp = np.exp(top[:n_keep] - top[0])
    p_exp /= p_exp.sum()
    draw_keys = rng.split(rng.key(SEED + 1), SAMPLER_DRAWS)
    counts = np.zeros(V, np.int64)
    t0 = time.perf_counter()
    for c in range(0, SAMPLER_DRAWS, 1024):
        k = draw_keys[c:c + 1024]
        n = k.shape[0]
        toks = gen._sample_rows(
            logits[None].expand(n, V), torch.full((n,), SAMPLE["temperature"]),
            torch.full((n,), SAMPLE["top_k"]),
            torch.full((n,), SAMPLE["top_p"]), k)
        counts += np.bincount(toks.cpu().numpy(), minlength=V)
    draw_s = time.perf_counter() - t0
    outside = int(counts.sum() - counts[kept].sum())
    freq = counts[kept] / SAMPLER_DRAWS
    tv = 0.5 * float(np.abs(freq - p_exp).sum())
    tv_expected = 0.5 * float(np.sqrt(
        2 * p_exp * (1 - p_exp) / (math.pi * SAMPLER_DRAWS)).sum())
    line = {"bits_equal_cpu": True, "uniform_equal_cpu": True,
            "gumbel_max_abs_err_vs_cpu": g_err, "draws": SAMPLER_DRAWS,
            "kept": n_keep, "outside_kept": outside, "tv": tv,
            "tv_expected": tv_expected,
            "tv_limit": SAMPLER_TV_FACTOR * tv_expected,
            "draw_ms_per_1024": draw_s * 1e3 / (SAMPLER_DRAWS / 1024)}
    log(f"[sampler] {json.dumps(line)}")
    check(outside == 0, f"[sampler] {outside} draws outside the kept set")
    check(tv <= SAMPLER_TV_FACTOR * tv_expected,
          f"[sampler] total variation {tv} over {SAMPLER_TV_FACTOR} x "
          f"{tv_expected}")
    return line


def prefix_checks(model, eng, cfg):
    """The prefix cache: an engine with PREFIX_SLOTS cache rows serves 8
    prompts sharing a PREFIX_HEAD-token head at once (the first prefills
    and admits the head, the other 7 hit it and prefill their tails);
    the hits and reused tokens are counted, and the tokens agree with the
    cache-less serving engine's (margin rule). Returns its line."""
    import numpy as np

    r = np.random.RandomState(SEED + 2)
    head = r.randint(0, cfg.vocab_size, size=PREFIX_HEAD)
    ps = [np.concatenate([head, r.randint(0, cfg.vocab_size, size=int(n))])
          for n in r.randint(PREFIX_TAILS[0], PREFIX_TAILS[1] + 1,
                             size=BEYOND_ROWS)]
    ref, _ = burst(eng, ps, BEYOND_NEW)
    t = time.perf_counter()
    pc = new_engine(model, prefix_cache_slots=PREFIX_SLOTS)
    warm_s = time.perf_counter() - t
    try:
        out, _ = burst(pc, ps, BEYOND_NEW)
        snap = pc.metrics.snapshot()
        rows = [token_agreement("prefix", model, eng, p, a, b)
                for p, a, b in zip(ps, out, ref)]
        line = {k: snap[k] for k in ("prefix_hits_total",
                                     "prefix_misses_total",
                                     "prefix_evictions_total",
                                     "prefix_tokens_reused_total")}
        check(snap["prefix_hits_total"] == BEYOND_ROWS - 1 and
              snap["prefix_tokens_reused_total"] ==
              (BEYOND_ROWS - 1) * PREFIX_HEAD,
              f"[prefix] hits {line}, expected {BEYOND_ROWS - 1} of "
              f"{PREFIX_HEAD} tokens")
        line.update(agreement=rows, warmup_s=warm_s,
                    programs=len(pc.program_report()["programs"]),
                    kv_pool_bytes=pc.kv_pool_bytes(),
                    extend_ms=pc.metrics.step_ms()["extend"],
                    prefill_ms=pc.metrics.step_ms()["prefill"],
                    decode_step_ms_b8=engine_checks("prefix", pc))
        log(f"[prefix] {json.dumps(line)}")
    finally:
        free_engine(pc)
    return line


def spec_checks(model, eng, cfg, ps, greedy, sampled):
    """Speculative decoding: a gpt3-small draft (seeded weights of its
    own, spec_tokens SPEC_TOKENS) gives the serving engine's greedy and
    SAMPLE tokens for `ps` (margin rule), its accept rate reported; a
    self-draft engine accepts at least SELF_DRAFT_ACCEPT of its
    proposals. Returns its line."""
    from paddle_tpu_torch.framework_io import params_from_paddle_tpu
    from paddle_tpu_torch.models import PRESETS, GPTForCausalLM

    small = PRESETS["gpt3-small"]
    draft = GPTForCausalLM(small, device="cuda")
    draft.load_state_dict(params_from_paddle_tpu(
        reference_layout_weights(small, SEED + 3)))
    draft.eval()
    line = {}
    for label, d in (("gpt3-small", draft), ("self", model)):
        t = time.perf_counter()
        spec = new_engine(model, draft=d, spec_tokens=SPEC_TOKENS)
        warm_s = time.perf_counter() - t
        try:
            g, _ = burst(spec, ps, BEYOND_NEW)
            rows = [token_agreement(f"spec-{label}", model, eng, p, a, b)
                    for p, a, b in zip(ps, g, greedy)]
            rate_g = spec.metrics.snapshot()["spec_accept_rate"]
            row = {"greedy_accept_rate": rate_g, "greedy_agreement": rows,
                   "warmup_s": warm_s,
                   "programs": len(spec.program_report()["programs"]),
                   "kv_pool_bytes": spec.kv_pool_bytes()}
            if label == "self":
                check(rate_g >= SELF_DRAFT_ACCEPT,
                      f"[spec-self] accept rate {rate_g} under "
                      f"{SELF_DRAFT_ACCEPT}")
            else:
                s_, _ = burst(spec, ps, BEYOND_NEW, **SAMPLE)
                row["sampled_agreement"] = [
                    token_agreement(f"spec-{label}", model, eng, p, a, b,
                                    SAMPLE)
                    for p, a, b in zip(ps, s_, sampled)]
            snap = spec.metrics.snapshot()
            row.update({k: snap[k] for k in (
                "spec_steps_total", "spec_proposed_total",
                "spec_accepted_total", "spec_accept_rate",
                "draft_steps_total")})
            row["decode_step_ms_b8"] = engine_checks(f"spec-{label}", spec)
            log(f"[spec-{label}] {json.dumps(row)}")
            line[label] = row
        finally:
            free_engine(spec)
    del draft
    line["decode_step_ms_b8"] = line["gpt3-small"]["decode_step_ms_b8"]
    return line


def int8_checks(model, eng, ps, greedy, f32_peak):
    """The int8 KV pool (its bytes are pool_nbytes(shape, "int8")) and
    weight-only int8, each an engine of its own: greedy tokens for `ps`
    against the f32 engine's, first tokens required equal for the int8
    pool (its prefill attends the pass's own float K/V), the share of
    equal tokens reported; with int8 weights the bytes of the engine's
    parameters and the burst's peak memory above its start, beside the
    f32 engine's. Returns its line."""
    import numpy as np

    from paddle_tpu_torch.quantization import kv as kvq

    def share(out):
        return float(np.mean([np.mean([a == b for a, b in zip(x, y)])
                              for x, y in zip(out, greedy)]))

    def nbytes(p):
        return sum(t.numel() * t.element_size() for t in p.values())

    line = {"f32": {"kv_pool_bytes": eng.kv_pool_bytes(),
                    "param_bytes": nbytes(eng._params),
                    "burst_peak_bytes": f32_peak}}
    for label, kw in (("kv", {"kv_dtype": "int8"}),
                      ("weights", {"quantize_weights": True})):
        q = new_engine(model, **kw)
        try:
            out, peak = burst(q, ps, BEYOND_NEW)
            first = [a[0] == b[0] for a, b in zip(out, greedy)]
            row = {"kv_pool_bytes": q.kv_pool_bytes(),
                   "param_bytes": nbytes(q._params),
                   "burst_peak_bytes": peak,
                   "first_tokens_equal": int(sum(first)),
                   "token_match_share": share(out),
                   "decode_step_ms_b8": engine_checks(f"int8-{label}", q)}
            if label == "kv":
                want = 2 * kvq.pool_nbytes(q._pool_shape(), "int8")
                check(row["kv_pool_bytes"] == want and
                      q._alloc_bufs("cuda")[0].nbytes == want // 2,
                      f"[int8-kv] pool {row['kv_pool_bytes']} B, expected "
                      f"{want}")
                check(all(first), f"[int8-kv] first tokens differ from "
                                  f"f32's: {first}")
            log(f"[int8-{label}] {json.dumps(row)}")
            line[label] = row
        finally:
            free_engine(q)
    line["decode_step_ms_b8"] = line["kv"]["decode_step_ms_b8"]
    return line


# a urllib opener that consults no proxy: every request of this script
# goes to 127.0.0.1
LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def http_post(url, obj=None, raw=None, on_line=None):
    """POST `obj` as JSON, or the bytes `raw`: (the JSON reply, or a
    streamed reply's ndjson lines, and the seconds from the request to
    the first token line). `on_line` sees each ndjson line as it comes.
    A status other than 200 raises."""
    import urllib.request

    req = urllib.request.Request(
        url, data=raw if raw is not None else json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with LOCAL.open(req, timeout=600) as r:
        if r.headers.get("Content-Type") != "application/x-ndjson":
            return json.loads(r.read()), None
        lines, t_first = [], None
        for ln in r:
            obj = json.loads(ln)
            if t_first is None and "token" in obj:
                t_first = time.perf_counter() - t0
            lines.append(obj)
            if on_line is not None:
                on_line(obj)
        return lines, t_first


def http_get(url):
    """(status, body text) of a GET; a status other than 200 raises."""
    with LOCAL.open(url, timeout=60) as r:
        return r.status, r.read().decode()


def stream_tokens(label, lines, terminal="done"):
    """The token lines of an ndjson stream, which must end in a
    `terminal` line ("done" or "handoff")."""
    check(lines and terminal in lines[-1],
          f"[{label}] the stream ended in "
          f"{str(lines[-1])[:200] if lines else 'nothing'}, not {terminal}")
    toks = [obj["token"] for obj in lines if "token" in obj]
    check(len(toks) == len(lines) - 1,
          f"[{label}] a line that is neither a token nor the end")
    return toks


def metrics_agree(label, text, snap):
    """Every paddle_generate_* counter of /metrics' text equals the
    engine's snapshot (read while it is idle)."""
    counters = {ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE") and ln.split()[3] == "counter"}
    values = {ln.split()[0]: float(ln.split()[1])
              for ln in text.splitlines() if ln and not ln.startswith("#")}
    check(len(counters) >= 16, f"[{label}] /metrics has {len(counters)} "
                               f"counters")
    for name in counters:
        key = name[len("paddle_generate_"):]
        key = "tokens_out_total" if key == "tokens_total" else key
        check(values[name] == snap[key],
              f"[{label}] /metrics {name} {values[name]} against the "
              f"snapshot's {snap[key]}")
    return len(counters)


def handoff_checks(label, model, eng, src_url, dst_url, prompts, refs,
                   samples):
    """Each prompt exported by prefill_only on the engine behind
    `src_url` and continued through /admin/kv/import on `dst_url`: the
    continuation against `refs` (margin rule, on `eng`'s logits), the
    payload's bytes, and from the tracer's spans the export's and the
    import's ms (kv_export: the row's copy to the host and the encode;
    kv_import: the copy to the card and the row write)."""
    from paddle_tpu_torch.inference.fabric import handoff
    from paddle_tpu_torch.observability import trace

    trace.reset()
    rows = []
    for p, ref, samp in zip(prompts, refs, samples):
        t0 = time.perf_counter()
        body, _ = http_post(src_url + "/generate", dict(
            samp or {}, input_ids=p.tolist(), max_new_tokens=BEYOND_NEW,
            prefill_only=True))
        check(body["finish_reason"] == "handoff",
              f"[{label}] prefill_only finished as {body['finish_reason']}")
        raw = handoff.from_b64(body["handoff"])
        t1 = time.perf_counter()
        lines, _ = http_post(dst_url + "/admin/kv/import", raw=raw)
        t2 = time.perf_counter()
        row = token_agreement(label, model, eng, p,
                              stream_tokens(label, lines), ref, samp)
        # client wall time: the prefill_only request to the decoded
        # payload, and the import request to its stream's end
        row.update(sampled=samp is not None, payload_bytes=len(raw),
                   prefill_only_request_ms=(t1 - t0) * 1e3,
                   import_request_ms=(t2 - t1) * 1e3)
        rows.append(row)
    spans = trace.spans()
    for name, key in (("generate.kv_export", "export_ms"),
                      ("generate.kv_import", "import_ms")):
        ms = [s["dur"] / 1e3 for s in spans if s["name"] == name]
        check(len(ms) == len(rows), f"[{label}] {len(ms)} {name} spans for "
                                    f"{len(rows)} handoffs")
        for row, t in zip(rows, ms):
            row[key] = t
    log(f"[{label}] {json.dumps(rows)}")
    return rows


def migrate_checks(model, eng, url_a, url_b, b, ps):
    """MIGRATE_STREAMS streams of MIGRATE_NEW tokens over HTTP on the
    engine behind `url_a`; once each has MIGRATE_AFTER tokens, POST
    /admin/drain {"migrate": true}: every stream must end in a handoff
    line whose `streamed` is the tokens it sent, and its payload imported
    on `url_b` must continue it with no duplicate and no gap, the splice
    against engine `b`'s uninterrupted tokens (margin rule)."""
    import threading

    from paddle_tpu_torch.inference.fabric import handoff

    prompts = ps[:MIGRATE_STREAMS]
    want, _ = burst(b, prompts, MIGRATE_NEW)
    outs = [None] * len(prompts)
    ready = [threading.Event() for _ in prompts]
    errors = []

    def run(i):
        n = [0]

        def on_line(obj):
            n[0] += "token" in obj
            if n[0] == MIGRATE_AFTER:
                ready[i].set()

        try:
            outs[i], _ = http_post(url_a + "/generate", {
                "input_ids": prompts[i].tolist(),
                "max_new_tokens": MIGRATE_NEW, "stream": True},
                on_line=on_line)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        finally:
            ready[i].set()

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for ev in ready:
        check(ev.wait(300), "[migrate] a stream never reached "
                            f"{MIGRATE_AFTER} tokens")
    drain, _ = http_post(url_a + "/admin/drain", {"migrate": True})
    for t in threads:
        t.join(300)
    check(not errors and not any(t.is_alive() for t in threads),
          f"[migrate] streams failed: {errors}")
    check(drain == {"draining": True, "migrate": True},
          f"[migrate] /admin/drain answered {drain}")
    status, health = http_get_status(url_a + "/healthz")
    check(status == 503, f"[migrate] /healthz gave {status} while draining")
    rows = []
    for p, lines, ref in zip(prompts, outs, want):
        head = stream_tokens("migrate", lines, "handoff")
        end = lines[-1]
        check(end["streamed"] == end["n_tokens"] == len(head) and
              MIGRATE_AFTER <= len(head) < MIGRATE_NEW,
              f"[migrate] a handoff line after {len(head)} tokens says "
              f"streamed {end['streamed']}, n_tokens {end['n_tokens']}")
        tail = stream_tokens("migrate", http_post(
            url_b + "/admin/kv/import",
            raw=handoff.from_b64(end["handoff"]))[0])
        check(len(head) + len(tail) == MIGRATE_NEW,
              f"[migrate] {len(head)} + {len(tail)} tokens, expected "
              f"{MIGRATE_NEW}")
        row = token_agreement("migrate", model, eng, p, head + tail, ref)
        row.update(head=len(head), tail=len(tail))
        rows.append(row)
    migrated = eng.metrics.snapshot()["migrations_out_total"]
    check(migrated == len(prompts), f"[migrate] {migrated} migrations")
    log(f"[migrate] {json.dumps(rows)}")
    return rows


def http_get_status(url):
    """(status, body) of a GET that may answer an error status."""
    import urllib.error

    try:
        return http_get(url)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def http_handoff_checks(model, eng, ps, greedy, sampled):
    """The HTTP front and the KV handoff on the card, over the serving
    engine A (which this drains) and an engine B of the same weights
    (new_engine), each behind an in-process admin ServingHTTPServer on
    127.0.0.1:0: `ps` streamed and not over /generate at once, their
    tokens against A's direct burst tokens `greedy` (margin rule), the
    client's TTFT beside the engine's, /healthz, /metrics against the
    snapshot; HANDOFF_STREAMS prefill_only exports from A continued on B
    (greedy against `greedy`, SAMPLE against `sampled`) and the same on
    an int8 pool pair (against the exporting engine's own uninterrupted
    tokens); resume_from on B; the migrating drain (migrate_checks); and
    every engine checked by engine_checks. Returns the `http` line."""
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.inference import ServingHTTPServer

    t0 = time.time()
    line = {}
    engines = {"B": new_engine(model)}
    servers = []

    def serve(e):
        srv = ServingHTTPServer(generator=e, admin=True).start()
        servers.append(srv)
        return f"http://127.0.0.1:{srv.port}"

    try:
        url_a, url_b = serve(eng), serve(engines["B"])
        reqs = [(p, s) for s in (True, False) for p in ps]
        with ThreadPoolExecutor(len(reqs)) as pool:
            outs = list(pool.map(lambda r: http_post(url_a + "/generate", {
                "input_ids": r[0].tolist(), "max_new_tokens": BEYOND_NEW,
                "stream": r[1]}), reqs))
        client_ttft, engine_ttft, rows = [], [], []
        for (p, streamed), (body, t_first), ref in zip(reqs, outs,
                                                      greedy * 2):
            if streamed:
                toks = stream_tokens("http", body)
                check(toks == body[-1]["tokens"],
                      "[http] the token lines differ from the done line's")
                client_ttft.append(t_first * 1e3)
                engine_ttft.append(body[-1]["ttft_ms"])
            else:
                toks = body["tokens"]
            rows.append(token_agreement("http", model, eng, p, toks, ref))
        status, _ = http_get(url_a + "/healthz")
        check(status == 200, f"[http] /healthz gave {status}")
        _, text = http_get(url_a + "/metrics")
        line.update(
            agreement=[r["first_mismatch"] for r in rows],
            client_ttft_ms=sorted(client_ttft),
            engine_ttft_ms=sorted(engine_ttft),
            metrics_counters=metrics_agree("http", text,
                                           eng.metrics.snapshot()))
        log(f"[http] {len(reqs)} requests over HTTP; TTFT p50 "
            f"{statistics.median(client_ttft):.3f} ms at the client, "
            f"{statistics.median(engine_ttft):.3f} ms in the engine")
        parts = {"http": time.time() - t0}

        set_flags({"trace_dir": os.path.join("build", "serving_trace")})
        try:
            n = HANDOFF_STREAMS
            line["handoff_f32"] = handoff_checks(
                "handoff-f32", model, eng, url_a, url_b,
                ps[:n] * 2, greedy[:n] + sampled[:n],
                [None] * n + [SAMPLE] * n)
            parts["handoff_f32"] = time.time() - t0 - sum(parts.values())
            engines["A8"] = new_engine(model, kv_dtype="int8")
            engines["B8"] = new_engine(model, kv_dtype="int8")
            own = [engines["A8"].generate(p, BEYOND_NEW, timeout=300,
                                          **(s or {}))["tokens"]
                   for p, s in zip(ps[:n] * 2, [None] * n + [SAMPLE] * n)]
            line["handoff_int8"] = handoff_checks(
                "handoff-int8", model, eng, serve(engines["A8"]),
                serve(engines["B8"]), ps[:n] * 2, own,
                [None] * n + [SAMPLE] * n)
        finally:
            set_flags({"trace_dir": ""})
        parts["handoff_int8"] = time.time() - t0 - sum(parts.values())

        full = engines["B"].generate(ps[0], BEYOND_NEW, timeout=300,
                                     **SAMPLE)["tokens"]
        lines, _ = http_post(url_b + "/generate", dict(
            SAMPLE, input_ids=ps[0].tolist(), max_new_tokens=BEYOND_NEW,
            stream=True, resume_from=RESUME_FROM))
        toks = stream_tokens("resume", lines)
        check(toks == lines[-1]["tokens"][RESUME_FROM:] and
              len(toks) == BEYOND_NEW - RESUME_FROM,
              f"[resume] {len(toks)} tokens streamed, not tokens "
              f"{RESUME_FROM}: of the run")
        line["resume_from"] = token_agreement(
            "resume", model, eng, ps[0], lines[-1]["tokens"], full, SAMPLE)

        parts["resume"] = time.time() - t0 - sum(parts.values())
        line["migrate"] = migrate_checks(model, eng, url_a, url_b,
                                         engines["B"], ps)
        parts["migrate"] = time.time() - t0 - sum(parts.values())
        line["parts_s"] = parts
        line["decode_step_ms_b8"] = {
            k: engine_checks(f"http-{k}", e)
            for k, e in dict(engines, A=eng).items()}
    finally:
        for srv in servers:
            srv.stop(drain=False)
        for e in engines.values():
            free_engine(e)
    line["s"] = time.time() - t0
    log(f"[http] the HTTP and handoff checks took {line['s']:.1f} s")
    return line


def cli_checks(model, eng, weights, prompt, ref):
    """`python -m paddle_tpu_torch.inference.serve --generate gpt3-medium
    --state-dict CKPT --http PORT` in a subprocess on the card, CKPT the
    serving phase's weights written as the reference's paddle_tpu.save
    writes a state_dict (the scan model's names): /healthz must answer
    within CLI_START_S, then /generate of `prompt` against `ref` (the
    serving engine's tokens; margin rule). The process is stopped and the
    checkpoint removed. Returns the `cli` line."""
    import shutil
    import socket

    root = os.path.dirname(os.path.abspath(__file__))
    ckdir = os.path.join(root, "build", "serving_ckpt")
    ckpt = write_state_dict(weights, ckdir)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logpath = os.path.join(ckdir, "serve.log")
    t0 = time.perf_counter()
    with open(logpath, "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.inference.serve",
             "--generate", "gpt3-medium", "--state-dict", ckpt, "--http",
             str(port)], cwd=root, stdout=logf, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    try:
        while True:
            if proc.poll() is not None:
                with open(logpath) as f:
                    raise SmokeFailure(f"[cli] the server exited: "
                                       f"{f.read()[-2000:]}")
            try:
                if http_get(url + "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            check(time.perf_counter() - t0 < CLI_START_S,
                  f"[cli] no /healthz answer within {CLI_START_S} s")
            time.sleep(0.5)
        start_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        body, _ = http_post(url + "/generate", {
            "input_ids": prompt.tolist(), "max_new_tokens": BEYOND_NEW})
        answer_ms = (time.perf_counter() - t1) * 1e3
        row = token_agreement("cli", model, eng, prompt, body["tokens"],
                              ref)
    finally:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
        shutil.rmtree(ckdir, ignore_errors=True)
    row.update(start_s=start_s, answer_ms=answer_ms)
    log(f"[cli] {json.dumps(row)}")
    return row


# ------------------------------------------------------------- predict --
def pipe_session(prefix, row_sets):
    """One session of the pipe worker (`python -m
    paddle_tpu_torch.inference.serve PREFIX`, on the card) over `row_sets`
    (one RUN_ each, then BYE_): its handshake and outputs."""
    import io
    import struct

    import numpy as np

    msg = b""
    for ids in row_sets:
        raw = np.ascontiguousarray(ids).tobytes()
        msg += b"RUN_" + struct.pack("<Q", len(raw)) + raw
    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.inference.serve", prefix],
        input=msg + b"BYE_", cwd=root, capture_output=True,
        timeout=PREDICT_CLI_START_S)
    check(out.returncode == 0, f"[predict] the pipe worker exited "
                               f"{out.returncode}: {out.stderr[-2000:]}")
    buf = io.BytesIO(out.stdout)

    def u32():
        return struct.unpack("<I", buf.read(4))[0]

    def blob():
        return buf.read(struct.unpack("<Q", buf.read(8))[0])

    check(buf.read(4) == b"PDIS" and u32() == 1, "[predict] bad handshake")
    specs = []
    for _ in range(u32()):
        dtype = blob().decode()
        nd = u32()
        specs.append((dtype, struct.unpack(f"<{nd}q", buf.read(8 * nd))))
    n_out = u32()
    outs = []
    for _ in row_sets:
        tag = buf.read(4)
        check(tag == b"OUT_", f"[predict] pipe reply {tag!r}: "
                              f"{blob()[:500] if tag == b'ERR_' else ''}")
        check(u32() == 1, "[predict] the pipe sent several outputs")
        dtype = blob().decode()
        nd = u32()
        dims = struct.unpack(f"<{nd}q", buf.read(8 * nd))
        outs.append(np.frombuffer(blob(), dtype).reshape(dims))
    check(buf.read() == b"", "[predict] bytes after the last reply")
    return specs, n_out, outs


def predict_http_checks(label, prefix, eng, raw_ids, json_ids):
    """`python -m paddle_tpu_torch.inference.serve PREFIX --engine --http
    PORT` in a subprocess on the card: /healthz, a raw-binary /predict of
    `raw_ids` and a JSON-base64 one of `json_ids`, each bitwise the
    in-process engine's answer for the same rows alone, then /metrics.
    Returns the check's row."""
    import base64
    import socket

    import numpy as np

    root = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    logpath = os.path.join(os.path.dirname(prefix), f"serve_{label}.log")
    t0 = time.perf_counter()
    with open(logpath, "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.inference.serve",
             prefix, "--engine", "--http", str(port), "--replicas", "1",
             "--max-batch-size", str(PREDICT_MAX_BATCH)], cwd=root,
            stdout=logf, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    try:
        while True:
            if proc.poll() is not None:
                with open(logpath) as f:
                    raise SmokeFailure(f"[predict-{label}] the server "
                                       f"exited: {f.read()[-2000:]}")
            try:
                if http_get(url + "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            check(time.perf_counter() - t0 < PREDICT_CLI_START_S,
                  f"[predict-{label}] no /healthz answer within "
                  f"{PREDICT_CLI_START_S} s")
            time.sleep(0.5)
        start_s = time.perf_counter() - t0
        req = urllib.request.Request(
            url + "/predict", data=raw_predict_body(raw_ids),
            headers={"Content-Type": "application/octet-stream"})
        t1 = time.perf_counter()
        with LOCAL.open(req, timeout=600) as r:
            reply = r.read()
        raw_ms = (time.perf_counter() - t1) * 1e3
        got_raw = raw_predict_reply(reply)
        (want_raw,) = eng.predict([raw_ids], timeout=600)
        check(np.array_equal(got_raw, want_raw),
              f"[predict-{label}] raw /predict differs from the engine's")
        t1 = time.perf_counter()
        body, _ = http_post(url + "/predict", {"inputs": [{
            "b64": base64.b64encode(json_ids.tobytes()).decode(),
            "dtype": "int64", "shape": list(json_ids.shape)}]})
        json_ms = (time.perf_counter() - t1) * 1e3
        o = body["outputs"][0]
        got_json = np.frombuffer(base64.b64decode(o["b64"]),
                                 o["dtype"]).reshape(o["shape"])
        (want_json,) = eng.predict([json_ids], timeout=600)
        check(np.array_equal(got_json, want_json),
              f"[predict-{label}] JSON /predict differs from the engine's")
        status, h = http_get(url + "/healthz")
        h = json.loads(h)
        check(h["status"] == "ok" and h["replicas"] == 1,
              f"[predict-{label}] /healthz {h}")
        _, text = http_get(url + "/metrics")
        check("paddle_serving_requests_total 2" in text.splitlines(),
              f"[predict-{label}] /metrics does not count 2 requests")
    finally:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
    return {"start_s": round(start_s, 3), "raw_ms": round(raw_ms, 3),
            "json_ms": round(json_ms, 3), "raw_rows": int(len(raw_ids)),
            "json_rows": int(len(json_ids)), "bitwise": True}


@contextlib.contextmanager
def plain_forward_on_card(plain):
    """The flash forwards' plain versions (`plain`: name -> function) in
    place of their CUDA kernels while it is open: a reference forward on
    the card that launches no kernel."""
    from paddle_tpu_torch.ops import flash_attention as fa

    names = [n for n in fa.CUDA if n.startswith("flash_fwd")]
    saved = {n: fa.CUDA[n] for n in names}
    fa.CUDA.update({n: plain[n] for n in names})
    try:
        yield
    finally:
        fa.CUDA.update(saved)


@contextlib.contextmanager
def forward_checked_against_plain(plain, calls):
    """While open, each flash forward launched on the card also runs its
    plain version (`plain`: name -> function, uncounted) on the same
    inputs (f64 for f32 storage, as kernel_phase holds it) and appends
    the call's row-normalised error of O, LSE's absolute error and O's
    limit (kernel_phase's) to `calls`."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    names = [n for n in fa.CUDA if n.startswith("flash_fwd")]
    saved = {n: fa.CUDA[n] for n in names}

    def checked(name):
        def call(q, k, v, causal, sm_scale, kv_len=None):
            o, lse = saved[name](q, k, v, causal, sm_scale, kv_len=kv_len)
            f32 = q.dtype == torch.float32
            ref = [t.double() if f32 else t for t in (q, k, v)]
            o_p, lse_p = plain[name](*ref, causal, sm_scale, kv_len=kv_len)
            tol = REL_TOL["float32" if f32 else "f32dot-bfloat16"
                          if name.endswith("f32dot") else "bfloat16"]
            calls.append({"name": name, "shape": str(tuple(q.shape)),
                          "row_err": row_err(o, o_p),
                          "lse_err": abs_err(lse, lse_p), "tol": tol})
            return o, lse
        return call

    fa.CUDA.update({n: checked(n) for n in names})
    try:
        yield
    finally:
        fa.CUDA.update(saved)


def execute_stages(spans):
    """Per batch bucket, the serving.execute spans' count, median and max
    (ms), and the medians of the Predictor's stages inside them: inputs
    to the card (h2d), the program until the stream has run it (forward,
    waiting behind another replica's work included), outputs to the host
    (d2h), and the rest (batch assembly)."""
    execs = {e["args"]["span"]: e for e in spans
             if e["name"] == "serving.execute"}
    stages = {}
    for e in spans:
        sid = e["args"].get("parent")
        if e["name"].startswith("predictor.") and sid in execs:
            stages.setdefault(sid, {})[e["name"].split(".")[1]] = \
                e["dur"] / 1e3
    by_bucket = {}
    for sid, e in execs.items():
        st = stages.get(sid, {})
        ms = e["dur"] / 1e3
        row = {"execute": ms, **st,
               "rest": ms - sum(st.get(k, 0.0)
                                for k in ("h2d", "forward", "d2h"))}
        for k, v in row.items():
            by_bucket.setdefault(e["args"]["bucket"], {}).setdefault(
                k, []).append(v)
    out = {}
    for b, cols in sorted(by_bucket.items()):
        ex = cols.pop("execute")
        out[b] = {"n": len(ex), "median": round(statistics.median(ex), 3),
                  "max": round(max(ex), 3),
                  **{f"{k}_median": round(statistics.median(v), 3)
                     for k, v in cols.items()}}
    return out


def predict_burst(label, eng, requests, outdir, cfg, checked):
    """PREDICT_CLIENTS client threads send `requests` to `eng` (each
    client every PREDICT_CLIENTS-th, one at a time), traced, the flash
    counts set to 0 just before. Fails unless every request is answered
    with no failure, shed, rejection, expiry, split, revived replica or
    batch that was a shape's first call, some batch coalesced two
    requests, and each batch launched cfg.num_layers forward kernels of
    the instance checked against its plain version at the path's shapes
    (`checked`) and nothing else. Returns (the answers, the burst's
    row)."""
    import threading

    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.inference.serving import metrics as sm
    from paddle_tpu_torch.observability import trace
    from paddle_tpu_torch.ops import flash_attention as fa

    set_flags({"trace_dir": os.path.join(outdir, "trace")})
    try:
        trace.reset()
        fa.reset_launch_counts()
        results = [None] * len(requests)
        lat = [None] * len(requests)
        errors = []

        def client(c):
            try:
                for i in range(c, len(requests), PREDICT_CLIENTS):
                    t = time.perf_counter()
                    (results[i],) = eng.predict([requests[i]], timeout=600)
                    lat[i] = time.perf_counter() - t
            except Exception as ex:  # noqa: BLE001 — reported below
                errors.append(repr(ex))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(PREDICT_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        burst_s = time.perf_counter() - t0
        launches = flash_counts()
        instances = dict(fa.INSTANCE_LAUNCHES)
        snap = eng.metrics.snapshot()
        spans = trace.spans()
    finally:
        set_flags({"trace_dir": ""})
    check(not errors, f"[predict-{label}] client errors: {errors[:3]}")
    check(all(r is not None for r in results),
          f"[predict-{label}] a request got no answer")
    for key in ("failed_total", "shed_total", "rejected_total",
                "deadline_expired_total", "batch_splits_total"):
        check(snap[key] == 0, f"[predict-{label}] {key} {snap[key]}")
    check(snap["responses_total"] == len(requests),
          f"[predict-{label}] {snap['responses_total']} responses")
    check(all(r["generation"] == 0 for r in eng.replica_states()),
          f"[predict-{label}] a replica was revived (requeued work)")
    firsts = sum(v["compiles"] for v in snap["buckets"].values())
    check(firsts == 0, f"[predict-{label}] {firsts} batches were a "
                       f"shape's first call after warm-up")
    check(snap["max_batch_occupancy"] > 1,
          f"[predict-{label}] no batch coalesced two requests: "
          f"{snap['occupancy_hist']}")
    batches = snap["batches_total"]
    check(launches == {"flash_fwd": cfg.num_layers * batches},
          f"[predict-{label}] launches {launches} for {batches} "
          f"batches (want flash_fwd {cfg.num_layers} a batch and "
          f"nothing else)")
    check(set(instances) <= checked
          and sum(instances.values()) == launches["flash_fwd"],
          f"[predict-{label}] kernel instances {instances}, checked "
          f"against the plain version: {sorted(checked)}")
    pct = sm.percentiles(lat)
    return results, {
        "replicas": len(eng.replica_states()),
        "execute_ms_by_bucket": execute_stages(spans),
        "requests": len(requests), "rows": snap["rows_total"],
        "batches": batches, "padded_rows": snap["padded_rows_total"],
        "occupancy_hist": snap["occupancy_hist"],
        "burst_s": round(burst_s, 3),
        "qps": round(len(requests) / burst_s, 3),
        "client_latency_ms": {k: round(v * 1e3, 3)
                              for k, v in pct.items()},
        "engine_latency_ms": snap["latency_ms"],
        "launches": launches, "instances": instances,
        "launches_per_batch": launches["flash_fwd"] / batches}


def predict_artifact(label, weights, cfg, requests, outdir, checked):
    """One artifact of the predict phase: gpt3-medium at `cfg`'s widths
    from `weights`, in f32 or (label "bf16") bf16 O2, saved by jit.save
    at [None, PREDICT_LEN], loaded by a fresh Predictor and served by a
    ServingEngine of PREDICT_REPLICAS replicas, then by one of one
    replica, to PREDICT_CLIENTS client threads sending `requests`
    (predict_burst; `checked`: the forward's instances that the phase held
    against its plain version at the path's shapes); then HTTP and the
    pipe worker. Returns the artifact's row."""
    import numpy as np
    import torch

    from paddle_tpu_torch import amp, jit
    from paddle_tpu_torch.framework_io import params_from_paddle_tpu
    from paddle_tpu_torch.inference import (Predictor, ServingEngine,
                                            config_for)
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.ops import flash_attention as fa

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = GPTForCausalLM(cfg, device="cuda")
    model.load_state_dict(params_from_paddle_tpu(weights))
    model.eval()
    if label == "bf16":
        amp.decorate(model, level="O2", dtype="bfloat16")
    prefix = os.path.join(outdir, label)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    jit.save(model, prefix, input_spec=[jit.InputSpec([None, PREDICT_LEN],
                                                      "int64")])
    save_s = time.perf_counter() - t0
    # the trace runs on fake tensors: no kernel (the probe ran before,
    # on real ones, when "auto" first met the card)
    check(set(flash_counts()) <= {"flash_probe"},
          f"[predict-{label}] the export launched {flash_counts()}")
    sizes = {ext: os.path.getsize(prefix + ext)
             for ext in (".pdmodel", ".pdiparams", ".meta.json",
                         ".pdparams")}
    t0 = time.perf_counter()
    pred = Predictor(config_for(prefix, "cuda"))
    load_s = time.perf_counter() - t0
    n_ops = sum(1 for n in pred._exported.graph.nodes
                if str(n.target) == "paddle_tpu_torch.flash_fwd.default")
    check(n_ops == cfg.num_layers, f"[predict-{label}] the program calls "
                                   f"the flash op {n_ops} times")
    # each batch bucket's first call on this Predictor, then bucket 8's
    # forward alone (device time) and its outputs' copy to the host
    first_ms = {}
    for b in bucket_sizes(PREDICT_MAX_BATCH):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.execute([np.zeros((b, PREDICT_LEN), np.int64)])
        first_ms[b] = round((time.perf_counter() - t0) * 1e3, 3)
    ids8 = torch.zeros(PREDICT_MAX_BATCH, PREDICT_LEN, dtype=torch.int64,
                       device="cuda")
    fwd_ms, copy_ms = [], []
    with torch.inference_mode():
        for _ in range(3):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = pred._module(ids8)
            e.record()
            e.synchronize()
            fwd_ms.append(s.elapsed_time(e))
            t0 = time.perf_counter()
            host = out.float().cpu() if out.dtype == torch.bfloat16 \
                else out.cpu()
            copy_ms.append((time.perf_counter() - t0) * 1e3)
    out_bytes = host.numel() * host.element_size()
    del out, host
    profile = profile_forward(pred, ids8, cfg, label)

    # the plain versions must not run on the card: count their calls
    plain_calls = {}
    saved_plain = dict(fa.PLAIN)

    def counted(name, fn):
        def call(*a, **k):
            plain_calls[name] = plain_calls.get(name, 0) + 1
            return fn(*a, **k)
        return call

    for name, fn in saved_plain.items():
        fa.PLAIN[name] = counted(name, fn)
    eng = eng1 = None
    try:
        t0 = time.perf_counter()
        eng = ServingEngine(pred, max_batch_size=PREDICT_MAX_BATCH,
                            replicas=PREDICT_REPLICAS,
                            batch_timeout_ms=PREDICT_BATCH_TIMEOUT_MS)
        engine_warm_s = time.perf_counter() - t0
        results, burst = predict_burst(label, eng, requests, outdir, cfg,
                                       checked)
        # the same requests from one replica: what the second one buys
        eng1 = ServingEngine(pred, max_batch_size=PREDICT_MAX_BATCH,
                             replicas=1,
                             batch_timeout_ms=PREDICT_BATCH_TIMEOUT_MS)
        results1, burst1 = predict_burst(f"{label}-1", eng1, requests,
                                         outdir, cfg, checked)
        eng1.shutdown()
        eng1 = None

        # the served program's every forward launch on its own
        # activations (a one-row request, then a batch of 8 rows), each
        # held against the plain version of the same call
        one = next(r for r in requests if len(r) == 1)
        two = next(r for r in requests if len(r) == 2)
        eight = np.concatenate(requests)[:PREDICT_MAX_BATCH]
        calls = []
        with forward_checked_against_plain(saved_plain, calls):
            for ids in (one, eight):
                pred.execute([ids])
        check(len(calls) == 2 * cfg.num_layers,
              f"[predict-{label}] {len(calls)} forward launches checked")
        for c in calls:
            check(c["row_err"] <= c["tol"] and c["lse_err"] <= LSE_ATOL,
                  f"[predict-{label}] a served forward call parts from "
                  f"its plain version: {c}")
        program_calls = {
            "calls": len(calls), "shapes": sorted({c["shape"]
                                                   for c in calls}),
            "max_row_err": max(c["row_err"] for c in calls),
            "tol": calls[0]["tol"],
            "max_lse_err": max(c["lse_err"] for c in calls),
            "lse_tol": LSE_ATOL}
        log(f"[predict-{label}] the served program's forward calls "
            f"against their plain versions: {json.dumps(program_calls)}")

        # each request's logits (from both engines) against the eager
        # model's on its rows alone (the same kernel: bitwise in every
        # run so far), and against two eager forwards that launch no
        # kernel: the attention's plain version, and its plain version
        # with P unrounded (f32 dots), which sets what two correct
        # attentions part by through 24 layers. The plain-attention
        # limit holds in f32; in bf16 the model's rounding through 24
        # layers spreads the kernel's own rounding (the calls above)
        # past it, so there it is read, not held. Argmax equal wherever
        # the reference's top-2 margin exceeds the tolerance.
        tol = PREDICT_TOL[label]
        f32dot_plain = {**saved_plain,
                        "flash_fwd": saved_plain["flash_fwd_f32dot"]}
        worst = {"eager": 0.0, "plain_attention": 0.0,
                 "plain_f32dot_vs_plain": 0.0}
        argmax_diff = {"eager": 0, "plain_attention": 0}
        sure = 0
        for i, ids in enumerate(requests):
            x = torch.from_numpy(ids).cuda()
            fa.reset_launch_counts()
            with torch.inference_mode():
                with plain_forward_on_card(saved_plain):
                    want_plain = model(x).float()
                with plain_forward_on_card(f32dot_plain):
                    want_f32dot = model(x).float()
            check(not flash_counts(), f"[predict-{label}] the plain "
                                      f"reference launched {flash_counts()}")
            with torch.inference_mode():
                want = model(x).float()
            rms = want_plain.pow(2).mean().sqrt()
            worst["plain_f32dot_vs_plain"] = max(
                worst["plain_f32dot_vs_plain"],
                float((want_f32dot - want_plain).abs().max() / rms))
            for got in (results[i], results1[i]):
                got = torch.from_numpy(got).cuda()
                check(got.shape == want.shape and bool(torch.isfinite(
                    got).all()), f"[predict-{label}] shape "
                                 f"{tuple(got.shape)} or non-finite logits")
                for ref_name, ref in (("eager", want),
                                      ("plain_attention", want_plain)):
                    rms = ref.pow(2).mean().sqrt()
                    worst[ref_name] = max(worst[ref_name], float(
                        (got - ref).abs().max() / rms))
                    top2 = ref.topk(2, dim=-1).values
                    clear = (top2[..., 0] - top2[..., 1]) > tol * rms
                    sure += int(clear.sum())
                    argmax_diff[ref_name] += int(
                        ((got.argmax(-1) != ref.argmax(-1)) & clear).sum())
                del got
            del want, want_plain, want_f32dot
        held = ("eager", "plain_attention") if label == "f32" \
            else ("eager",)
        for ref_name in held:
            check(worst[ref_name] <= tol,
                  f"[predict-{label}] logits part from the {ref_name} "
                  f"model's by {worst[ref_name]:.3e} of their RMS (limit "
                  f"{tol})")
            check(argmax_diff[ref_name] == 0,
                  f"[predict-{label}] {argmax_diff[ref_name]} argmaxes "
                  f"differ from the {ref_name} model's where the margin "
                  f"exceeds {tol}")
        log(f"[predict-{label}] served logits against the eager model, "
            f"the plain-attention one and the two plain versions' spread "
            f"(over the RMS): {worst}; argmaxes differing where the margin "
            f"exceeds {tol}: {argmax_diff} (held: {held})")
        plain = dict(plain_calls)
        check(not plain, f"[predict-{label}] plain versions ran: {plain}")

        # HTTP (the CLI in a subprocess) and the pipe worker, each against
        # this engine's answers for the same rows alone (row counts that
        # are their own batch bucket: the pipe worker runs them unpadded)
        http = predict_http_checks(label, prefix, eng, two, one)
        t0 = time.perf_counter()
        specs, n_out, piped = pipe_session(prefix, [one, two, one])
        pipe_s = time.perf_counter() - t0
        check(specs == [("int64", (-1, PREDICT_LEN))] and n_out == 1,
              f"[predict-{label}] pipe handshake {specs}, {n_out}")
        for ids, got in zip((one, two, one), piped):
            (want,) = eng.predict([ids], timeout=600)
            check(np.array_equal(got, want),
                  f"[predict-{label}] pipe output differs from the engine's")
        row = {
            "save_s": round(save_s, 3), "load_s": round(load_s, 3),
            "artifact_bytes": sizes,
            "first_call_ms_by_bucket": first_ms,
            "engine_warmup_s": round(engine_warm_s, 3),
            "warmup_report": eng.warmup_report,
            "batch8_forward_ms": [round(x, 3) for x in fwd_ms],
            "batch8_output_copy_ms": [round(x, 3) for x in copy_ms],
            "batch8_output_bytes": out_bytes,
            "batch8_profile": profile,
            **burst, "one_replica": burst1,
            "program_calls_vs_plain": program_calls,
            "max_err_over_rms": worst, "tol": tol,
            "argmax_checked": sure, "argmax_differing": argmax_diff,
            "plain_calls": 0,
            "http": http, "pipe_s": round(pipe_s, 3),
            "peak_gib": gib(torch.cuda.max_memory_allocated()),
        }
    finally:
        fa.PLAIN.update(saved_plain)
        for e in (eng, eng1):
            if e is not None:
                e.shutdown()
        del model, pred
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[predict-{label}] {json.dumps(row)}")
    return row


def profile_forward(pred, ids, cfg, label):
    """One forward of the loaded program on `ids` (no host copy) under
    torch.profiler: the device time of each kernel, summed by name, the
    device's busy time and idle share over the call's host time, and the
    least time of the call (the larger of its weights and outputs once
    over the memory rate and its products over the dtype's peak)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            out = pred._module(ids)
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t
    kernels = sorted(((e.device_time_total, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(k[0] for k in kernels)
    B, L = ids.shape
    D, V, n = cfg.hidden_size, cfg.vocab_size, cfg.num_layers
    flops = 2 * B * L * (n * 12 * D * D + D * V) \
        + n * B * 2 * 2 * D * L * (L + 1) // 2
    weights = sum(t.numel() * t.element_size()
                  for t in pred._module.parameters())
    nbytes = weights + out.numel() * out.element_size()
    bound_ms, by = bound(flops, nbytes,
                         "float32" if label == "f32" else "bfloat16")
    row = {"host_ms": round(host_s * 1e3, 3),
           "device_busy_ms": round(busy_us / 1e3, 3),
           "idle_share": round(1 - busy_us / (host_s * 1e6), 3),
           "launches": sum(k[1] for k in kernels),
           "bound_ms": round(bound_ms, 3), "bound_by": by,
           "top": [[name[:60], round(us / 1e3, 3), cnt]
                   for us, cnt, name in kernels[:8]]}
    log(f"[predict-{label}] one forward at batch {B} x {L}: "
        f"{row['host_ms']} ms host, device busy {row['device_busy_ms']} ms "
        f"in {row['launches']} launches, bound {row['bound_ms']} ms ({by})")
    for us, cnt, name in kernels[:12]:
        log(f"  {us / 1e3:8.3f} ms {100 * us / max(busy_us, 1):5.1f}% "
            f"x{cnt:<5d} {name[:90]}")
    return row


def bucket_sizes(max_batch):
    """The predict engine's batch buckets: powers of two up to max_batch."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    return out + [max_batch]


def predict_phase(weights, cfg):
    """The predict path on the card: the flash kernels against their plain
    versions at the path's shapes (kernel_phase), then gpt3-medium (`cfg`,
    published widths) from `weights`, saved by jit.save with input_spec
    [None, PREDICT_LEN] in f32 and in bf16 (amp.decorate O2), each served
    from a fresh Predictor (predict_artifact). The requests: PREDICT_REQUESTS of 1-3
    rows of ids from RandomState(SEED). Fails on any failed check; the
    artifacts are written under build/predict/ and removed. Returns the
    `predict` line's dict."""
    import shutil

    import numpy as np

    root = os.path.dirname(os.path.abspath(__file__))
    outdir = os.path.join(root, "build", "predict")
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    requests = predict_requests(cfg)
    t0 = time.perf_counter()
    line = {"card": card_line(), "model": "gpt3-medium",
            "seq": PREDICT_LEN, "max_batch_size": PREDICT_MAX_BATCH,
            "replicas": PREDICT_REPLICAS, "clients": PREDICT_CLIENTS}
    # the forward (and the other flash kernels) against their plain
    # versions at the shapes this path gives them: batch buckets 1 and 8
    # of PREDICT_LEN tokens, cfg's heads and head_dim, causal, on the
    # storage of each artifact
    checked = checked_forward_instances(cfg, ("f32", "bf16"))
    line["checked_instances"] = {k: sorted(v) for k, v in checked.items()}
    try:
        for label in ("f32", "bf16"):
            line[label] = predict_artifact(label, weights, cfg, requests,
                                           outdir, checked[label])
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    line["seconds"] = round(time.perf_counter() - t0, 1)
    return line


# --------------------------------------------------------------- fabric --
def write_state_dict(weights, ckdir):
    """`weights` written as the reference's paddle_tpu.save writes a
    state_dict (the scan model's names), the serve CLI's --state-dict
    input; returns its path."""
    import pickle

    os.makedirs(ckdir, exist_ok=True)
    ckpt = os.path.join(ckdir, "gpt3-medium.pdparams")
    with open(ckpt, "wb") as f:
        pickle.dump({n: {"__tensor__": True, "data": a,
                         "stop_gradient": False, "is_param": True,
                         "name": n} for n, a in weights.items()},
                    f, protocol=4)
    return ckpt


def raw_predict_body(ids):
    """A raw-binary /predict body of one int64 input."""
    import struct

    import numpy as np

    raw = np.ascontiguousarray(ids).tobytes()
    return struct.pack("<Q", len(raw)) + raw


def raw_predict_reply(reply):
    """The one output array of a raw-binary /predict reply."""
    import struct

    import numpy as np

    (n,) = struct.unpack_from("<I", reply, 0)
    check(n == 1, f"{n} outputs in a raw /predict reply")
    off = 4
    (dl,) = struct.unpack_from("<Q", reply, off)
    dtype = reply[off + 8:off + 8 + dl].decode()
    off += 8 + dl
    (nd,) = struct.unpack_from("<I", reply, off)
    dims = struct.unpack_from(f"<{nd}q", reply, off + 4)
    off += 4 + 8 * nd
    (nb,) = struct.unpack_from("<Q", reply, off)
    return np.frombuffer(reply, dtype, count=nb // np.dtype(
        dtype).itemsize, offset=off + 8).reshape(dims)


def checked_forward_instances(cfg, labels):
    """The flash forward's instances that kernel_phase holds against the
    plain version at the predict path's shapes (batch buckets 1 and 8 x
    PREDICT_LEN, cfg's heads and head_dim, causal), by storage: label ->
    set of instance names."""
    out = {}
    for label in labels:
        dtype_name = {"f32": "float32", "bf16": "bfloat16"}[label]
        out[label] = {
            kernel_phase(B, PREDICT_LEN, cfg.num_heads,
                         cfg.hidden_size // cfg.num_heads, dtype_name, True,
                         timed=False)["flash_fwd"]
            for B in (1, PREDICT_MAX_BATCH)}
    return out


def serving_prompts(cfg):
    """The serving phase's SERVING_REQUESTS prompts (lengths and ids from
    RandomState(SEED)): (the generator, to draw on from, and the
    prompts)."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    lens = rng.randint(SERVING_PROMPT[0], SERVING_PROMPT[1] + 1,
                       size=SERVING_REQUESTS)
    return rng, [rng.randint(0, cfg.vocab_size, size=int(n)) for n in lens]


def predict_requests(cfg):
    """The predict phase's PREDICT_REQUESTS requests of 1-3 rows x
    PREDICT_LEN (RandomState(SEED))."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    return [rng.randint(0, cfg.vocab_size, (int(rng.randint(1, 4)),
                                            PREDICT_LEN)).astype(np.int64)
            for _ in range(PREDICT_REQUESTS)]


class _Procs:
    """Subprocesses of the fabric phase, each logging to a file; stop()
    ends every one still running."""

    def __init__(self, root, outdir):
        self.root, self.outdir, self.procs = root, outdir, {}

    def start(self, name, argv, stdout_pipe=False):
        log_f = open(os.path.join(self.outdir, f"{name}.log"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", *argv], cwd=self.root,
            stdout=subprocess.PIPE if stdout_pipe else log_f,
            stderr=log_f if stdout_pipe else subprocess.STDOUT, text=True)
        self.procs[name] = (proc, log_f)
        return proc

    def tail(self, name):
        self.procs[name][1].flush()
        with open(os.path.join(self.outdir, f"{name}.log")) as f:
            return f.read()[-2000:]

    def stop(self):
        for proc, _ in self.procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc, log_f in self.procs.values():
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(30)
            log_f.close()


def read_line(proc, timeout):
    """proc's first stdout line, waiting at most `timeout` seconds."""
    import threading

    out = []
    t = threading.Thread(target=lambda: out.append(proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(timeout)
    return out[0].strip() if out else ""


def fleet_stream(client, obj, marks=None):
    """One streamed /generate through a FleetClient: (the records, the
    seconds to the first token, each token's arrival on perf_counter).
    `marks` (a list) sees each token's arrival as it comes."""
    t0 = time.perf_counter()
    recs, stamps = [], []
    for rec in client.stream_generate(obj):
        recs.append(rec)
        if "token" in rec:
            stamps.append(time.perf_counter())
            if marks is not None:
                marks.append(stamps[-1])
    return recs, (stamps[0] - t0 if stamps else None), stamps


def fabric_phase(weights, cfg, checked):
    """The serving fabric on the card. A native TCPStore in this process;
    the front door CLI (python -m paddle_tpu_torch.inference.fabric) in a
    subprocess; host A in this process (gpt3-medium's f32 GenerativeEngine
    of the serving phase, 8 slots at cap 1024, and the predict phase's
    bf16 artifact, written again here, under a ServingEngine, behind an
    admin ServingHTTPServer and a HostAgent); host B the serve CLI
    (`serve PREFIX --generate gpt3-medium --state-dict W --http 0
    --fabric STORE`) on the same card. Through a FleetClient over the
    door: (1) the serving phase's 16 requests streamed, tokens against
    generate's (margin rule), both hosts serving, TTFT beside the same
    requests sent to A directly; (2) the predict phase's 32 requests as
    raw /predict through the door (8 client threads), then straight to
    A: A's served logits bitwise its Predictor's on the rows alone,
    flash_fwd launched on A (24 a batch, of an instance in `checked`),
    QPS over two hosts and over one; (3) SIGKILL of B with
    FABRIC_KILL_STREAMS streams on it, each FABRIC_KILL_AFTER tokens
    out: every stream ends on A with generate's tokens, no duplicate and
    no gap, B suspect and then evicted within lease + drain + two polls
    of the door's view; (4) B restarted with --pool prefill (generation
    only) and A leased as pool decode: FABRIC_HANDOFFS streams prefill on
    B, import into A over /admin/kv/import and are relayed, the door
    counting that many prefill handoffs; (5) /healthz and the merged
    /metrics carry both hosts. Any failed check fails the phase. Returns the `fabric` line."""
    import shutil
    import signal
    import socket
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from paddle_tpu_torch import amp, jit
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.distributed.store import TCPStore
    from paddle_tpu_torch.framework_io import params_from_paddle_tpu
    from paddle_tpu_torch.inference import (GenerativeEngine, ServingEngine,
                                            ServingHTTPServer)
    from paddle_tpu_torch.inference.fabric import (FleetClient, HostAgent,
                                                   _http, build_ring,
                                                   ring_hosts)
    from paddle_tpu_torch.inference.serving import metrics as sm
    from paddle_tpu_torch.models import GPTForCausalLM
    from paddle_tpu_torch.observability import trace
    from paddle_tpu_torch.ops import flash_attention as fa

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    outdir = os.path.join(root, "build", "fabric")
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    poll_s = FABRIC_LEASE_S / 4          # the door's view polls this often
    line = {"card": card_line(), "model": "gpt3-medium",
            "lease_s": FABRIC_LEASE_S, "drain_s": FABRIC_DRAIN_S,
            "view_poll_s": poll_s, "heartbeat_s": FABRIC_BEAT_S}
    seconds = {}
    procs = _Procs(root, outdir)
    store = srv_a = agent_a = gen_a = pred_a = model = None
    hostname = socket.gethostname()

    def mark(name, t0):
        seconds[name] = round(time.perf_counter() - t0, 1)

    def start_b(name, front):
        """Host B: the serve CLI with `front` (the predict artifact's
        prefix, or the pool it joins) beside generation."""
        t0 = time.perf_counter()
        proc = procs.start(
            name, ["paddle_tpu_torch.inference.serve", *front, "--generate",
                   "gpt3-medium", "--state-dict", ckpt, "--http", "0",
                   "--fabric", store_ep])
        return proc, f"{hostname}-{proc.pid}", t0

    try:
        t0 = time.perf_counter()
        store = TCPStore(is_master=True)
        check(store._py is None, "[fabric] the store runs on the "
                                 "in-process fallback, not cpp/tcpstore.cc")
        store_ep = f"127.0.0.1:{store.port}"
        door = procs.start("door", [
            "paddle_tpu_torch.inference.fabric", "--store", store_ep,
            "--lease_s", str(FABRIC_LEASE_S), "--drain_s",
            str(FABRIC_DRAIN_S)], stdout_pipe=True)
        mark("store_and_door", t0)
        t0 = time.perf_counter()
        ckpt = write_state_dict(weights, outdir)
        mark("checkpoint", t0)
        t0 = time.perf_counter()
        m16 = GPTForCausalLM(cfg, device="cuda")
        m16.load_state_dict(params_from_paddle_tpu(weights))
        m16.eval()
        amp.decorate(m16, level="O2", dtype="bfloat16")
        prefix = os.path.join(outdir, "bf16")
        jit.save(m16, prefix, input_spec=[jit.InputSpec(
            [None, PREDICT_LEN], "int64")])
        del m16
        gc.collect()
        torch.cuda.empty_cache()
        mark("bf16_artifact", t0)

        t0 = time.perf_counter()
        door_line = read_line(door, 120)
        check(door_line.startswith("DOOR="),
              f"[fabric] the door printed {door_line!r}: "
              f"{procs.tail('door')}")
        door_ep = door_line.split("=", 1)[1]
        client = FleetClient([door_ep], timeout_s=600.0,
                             stream_idle_timeout_s=300.0)
        host_b, b_id, tb = start_b("host_b", [prefix])

        # host A, while B starts
        model = GPTForCausalLM(cfg, device="cuda")
        model.load_state_dict(params_from_paddle_tpu(weights))
        model.eval()
        gen_a = GenerativeEngine(model, slots=SERVING_SLOTS,
                                 max_context=1024, device="cuda")
        pred_a = ServingEngine(prefix, max_batch_size=PREDICT_MAX_BATCH,
                               replicas=1,
                               batch_timeout_ms=PREDICT_BATCH_TIMEOUT_MS,
                               device="cuda")
        srv_a = ServingHTTPServer(pred_a, generator=gen_a,
                                  admin=True).start()
        url_a = f"http://127.0.0.1:{srv_a.port}"
        agent_a = HostAgent(srv_a, TCPStore("127.0.0.1", store.port),
                            host_id="A", heartbeat_s=FABRIC_BEAT_S).start()
        mark("host_a_start", t0)

        _, prompts = serving_prompts(cfg)
        t0 = time.perf_counter()
        refs = [model.generate(torch.as_tensor(p, device="cuda")[None],
                               max_new_tokens=SERVING_NEW)[0, len(p):]
                .tolist() for p in prompts]
        mark("generate_refs", t0)

        def alive():
            status, h = client.healthz()
            return {r["host"]: r for r in h.get("hosts", ())
                    if r["state"] == "alive"}

        def wait_for(cond, what, proc=None, name=None, timeout=None):
            deadline = time.perf_counter() + (timeout or FABRIC_START_S)
            while not cond():
                if proc is not None and proc.poll() is not None:
                    raise SmokeFailure(f"[fabric] {name} exited "
                                       f"({proc.returncode}): "
                                       f"{procs.tail(name)}")
                check(time.perf_counter() < deadline,
                      f"[fabric] {what} within "
                      f"{timeout or FABRIC_START_S} s")
                time.sleep(0.1)

        wait_for(lambda: set(alive()) == {"A", b_id},
                 "both hosts alive behind the door", host_b, "host_b")
        line["host_b_start_s"] = round(time.perf_counter() - tb, 3)
        log(f"[fabric] door {door_ep}, hosts A and {b_id} alive "
            f"(B up in {line['host_b_start_s']} s)")

        # (1) streamed generation through the door, then straight to A
        t0 = time.perf_counter()
        fa.reset_launch_counts()
        with ThreadPoolExecutor(len(prompts)) as pool:
            outs = list(pool.map(lambda p: fleet_stream(client, {
                "input_ids": p.tolist(),
                "max_new_tokens": SERVING_NEW}), prompts))
        door_wall = time.perf_counter() - t0
        agreement = []
        for p, ref, (recs, _, _) in zip(prompts, refs, outs):
            check(recs and recs[-1].get("done") is True,
                  f"[fabric] a stream ended in {str(recs[-1:])[:300]}")
            toks = [r["token"] for r in recs if "token" in r]
            check(len(toks) == len(recs) - 1,
                  "[fabric] a line that is neither a token nor the end")
            agreement.append(token_agreement("fabric", model, gen_a, p,
                                             toks, ref))
        text = client.metrics_text()
        by_host = {}
        for ln in text.splitlines():
            m = re.match(r'paddle_generate_requests_total\{host="([^"]+)"\} '
                         r'(\S+)', ln)
            if m:
                by_host[m.group(1)] = float(m.group(2))
        check(by_host.get("A", 0) > 0 and by_host.get(b_id, 0) > 0,
              f"[fabric] streams by host (merged /metrics): {by_host}")
        with ThreadPoolExecutor(len(prompts)) as pool:
            direct = list(pool.map(lambda p: http_post(
                url_a + "/generate", {"input_ids": p.tolist(),
                                      "max_new_tokens": SERVING_NEW,
                                      "stream": True}), prompts))
        for p, ref, (lines, _) in zip(prompts, refs, direct):
            token_agreement("fabric-direct", model, gen_a, p,
                            stream_tokens("fabric-direct", lines), ref)
        check(not flash_counts(), f"[fabric] generation launched "
                                  f"{flash_counts()}")
        ttft_door = sm.percentiles([o[1] * 1e3 for o in outs])
        ttft_a = sm.percentiles([d[1] * 1e3 for d in direct])
        line["streams"] = {
            "requests": len(prompts), "new_tokens": SERVING_NEW,
            "requests_by_host": {("A" if h == "A" else "B"): int(v)
                                 for h, v in by_host.items()},
            "ttft_ms_door": {k: round(ttft_door[k], 3)
                             for k in ("p50", "p99")},
            "ttft_ms_direct_a": {k: round(ttft_a[k], 3)
                                 for k in ("p50", "p99")},
            "door_burst_s": round(door_wall, 3),
            "parted": [r for r in agreement
                       if r["first_mismatch"] is not None]}
        mark("streams", t0)
        log(f"[fabric] streams: {json.dumps(line['streams'])}")

        # (2) /predict through the door over both hosts, then to A alone
        t0 = time.perf_counter()
        requests = predict_requests(cfg)
        served_a = {}
        engine_predict = pred_a.predict

        def recording(inputs, **kw):
            outs = engine_predict(inputs, **kw)
            served_a[inputs[0].tobytes()] = outs[0]
            return outs

        pred_a.predict = recording

        def burst(endpoint):
            got = [None] * len(requests)
            lat = [None] * len(requests)
            errors = []

            def one(c):
                try:
                    for i in range(c, len(requests), PREDICT_CLIENTS):
                        t = time.perf_counter()
                        status, _, reply = _http.request(
                            endpoint, "POST", "/predict",
                            raw_predict_body(requests[i]),
                            ctype="application/octet-stream", timeout=600)
                        lat[i] = time.perf_counter() - t
                        check(status == 200, f"[fabric] /predict answered "
                                             f"{status}: {reply[:300]}")
                        got[i] = raw_predict_reply(reply)
                except Exception as ex:  # noqa: BLE001 — reported below
                    errors.append(repr(ex))

            threads = [threading.Thread(target=one, args=(c,))
                       for c in range(PREDICT_CLIENTS)]
            tb = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(900)
            wall = time.perf_counter() - tb
            check(not errors, f"[fabric] /predict errors: {errors[:3]}")
            pct = sm.percentiles(lat)
            return got, {"burst_s": round(wall, 3),
                         "qps": round(len(requests) / wall, 3),
                         "client_latency_ms": {
                             k: round(v * 1e3, 3) for k, v in pct.items()}}

        before = pred_a.metrics.snapshot()
        fa.reset_launch_counts()
        got, two = burst(door_ep)
        launches = flash_counts()
        instances = dict(fa.INSTANCE_LAUNCHES)
        after = pred_a.metrics.snapshot()
        batches = after["batches_total"] - before["batches_total"]
        n_a = after["responses_total"] - before["responses_total"]
        check(0 < n_a < len(requests) and len(served_a) == n_a,
              f"[fabric] host A served {n_a} of {len(requests)} /predict "
              f"requests (both hosts must serve)")
        check(launches.get("flash_fwd", 0) > 0
              and launches == {"flash_fwd": cfg.num_layers * batches},
              f"[fabric] host A launched {launches} for {batches} batches")
        check(set(instances) <= checked,
              f"[fabric] served instances {instances}, checked: "
              f"{sorted(checked)}")
        # A's answers bitwise its Predictor's on the rows alone; B's held
        # to the predict phase's bf16 limit against them
        bitwise_b, worst_b = 0, 0.0
        for ids, out in zip(requests, got):
            check(out.shape == (len(ids), PREDICT_LEN, cfg.vocab_size)
                  and bool(np.isfinite(out).all()),
                  f"[fabric] /predict shape {out.shape} or non-finite")
            (want,) = pred_a._predictor.run([ids])
            want = np.asarray(want)
            mine = served_a.get(ids.tobytes())
            if mine is not None:
                check(np.array_equal(out, mine) and np.array_equal(mine, want),
                      "[fabric] host A's /predict answer is not bitwise "
                      "its Predictor's on the rows alone")
            elif np.array_equal(out, want):
                bitwise_b += 1
            else:
                rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
                worst_b = max(worst_b, float(np.abs(out - want).max()) / rms)
        check(worst_b <= PREDICT_TOL["bf16"],
              f"[fabric] host B's logits part from A's Predictor's by "
              f"{worst_b:.3e} of the RMS")
        pred_a.predict = engine_predict
        del got, served_a
        fa.reset_launch_counts()
        _, one = burst(f"127.0.0.1:{srv_a.port}")
        one["launches"] = flash_counts()
        line["predict"] = {
            "requests": len(requests), "clients": PREDICT_CLIENTS,
            "two_hosts": {**two, "served_by_a": n_a, "batches_a": batches,
                          "launches": launches, "instances": instances,
                          "launches_per_batch": launches["flash_fwd"] /
                          batches},
            "a_alone": one, "b_bitwise_a": bitwise_b,
            "b_max_err_over_rms": worst_b,
            "qps_two_over_one": round(two["qps"] / one["qps"], 3)}
        mark("predict", t0)
        log(f"[fabric] /predict: {json.dumps(line['predict'])}")

        # (3) SIGKILL of B with streams on it
        t0 = time.perf_counter()
        ring = build_ring(sorted(["A", b_id]), 32)
        sessions = [s for s in (f"kill-{i}" for i in range(4096))
                    if ring_hosts(ring, s.encode())[0] == b_id]
        order = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))
        kill_ix = order[:FABRIC_KILL_STREAMS]
        marks = [[] for _ in kill_ix]
        res = [None] * len(kill_ix)

        def run(j):
            i = kill_ix[j]
            res[j] = fleet_stream(client, {
                "input_ids": prompts[i].tolist(),
                "max_new_tokens": SERVING_NEW, "session": sessions[j]},
                marks[j])

        resumed0 = client.fleet()[1]["router"]["streams_resumed_total"]
        done_a0 = gen_a.metrics.snapshot()["completed_total"]
        threads = [threading.Thread(target=run, args=(j,))
                   for j in range(len(kill_ix))]
        for t in threads:
            t.start()
        wait_for(lambda: min(len(m) for m in marks) >= FABRIC_KILL_AFTER,
                 f"{FABRIC_KILL_AFTER} tokens on every stream of B",
                 host_b, "host_b", timeout=120)
        out_at_kill = [len(m) for m in marks]
        t_kill = time.perf_counter()
        host_b.send_signal(signal.SIGKILL)
        host_b.wait(30)
        check(max(out_at_kill) < SERVING_NEW, f"[fabric] a stream had "
              f"ended before the kill: {out_at_kill} tokens")
        # B restarts as the prefill pool while the door walks its ladder
        host_b2, b2_id, tb2 = start_b("host_b_prefill",
                                      ["--pool", "prefill"])
        t_b2 = time.perf_counter()
        # the view reads a lease on its poll: B's last beat may be seen
        # one poll after the kill, and the eviction lands on the poll
        # after lease + drain
        evict_limit = FABRIC_LEASE_S + FABRIC_DRAIN_S + 2 * poll_s
        t_suspect = t_evict = None
        deadline = t_kill + evict_limit + 10.0
        while time.perf_counter() < deadline and t_evict is None:
            _, h = client.healthz()
            rows = {r["host"]: r["state"] for r in h.get("hosts", ())}
            if t_suspect is None and rows.get(b_id) == "suspect":
                t_suspect = time.perf_counter() - t_kill
            if b_id not in rows:
                t_evict = time.perf_counter() - t_kill
            time.sleep(0.025)
        for t in threads:
            t.join(300)
        gaps = []
        for j, i in enumerate(kill_ix):
            recs, _, stamps = res[j]
            check(recs and recs[-1].get("done") is True,
                  f"[fabric] a stream of B ended in {str(recs[-1:])[:300]}")
            toks = [r["token"] for r in recs if "token" in r]
            token_agreement("fabric-kill", model, gen_a, prompts[i], toks,
                            refs[i])
            after_kill = [s for s in stamps if s > t_kill]
            check(after_kill, "[fabric] a stream got no token after the "
                              "kill")
            gaps.append((after_kill[0] - t_kill) * 1e3)
        resumed = client.fleet()[1]["router"]["streams_resumed_total"] - \
            resumed0
        done_a = gen_a.metrics.snapshot()["completed_total"] - done_a0
        check(resumed == len(kill_ix) and done_a >= len(kill_ix),
              f"[fabric] {resumed} streams resumed, {done_a} completed on A")
        check(t_suspect is not None and t_evict is not None
              and t_suspect < t_evict <= evict_limit,
              f"[fabric] B suspect at {t_suspect} s, evicted at {t_evict} "
              f"s after the kill (limit {evict_limit} s)")
        line["host_loss"] = {
            "streams": len(kill_ix), "tokens_at_kill": out_at_kill,
            "resume_gap_ms": {"min": round(min(gaps), 3),
                              "median": round(statistics.median(gaps), 3),
                              "max": round(max(gaps), 3)},
            "suspect_s": round(t_suspect, 3), "evicted_s": round(t_evict, 3),
            "evict_limit_s": evict_limit}
        mark("host_loss", t0)
        log(f"[fabric] host loss: {json.dumps(line['host_loss'])}")

        # (4) disaggregated prefill: B prefill pool, A decode pool
        t0 = t_b2
        agent_a.stop()
        agent_a = HostAgent(srv_a, TCPStore("127.0.0.1", store.port),
                            host_id="A-decode", pools=["decode"],
                            heartbeat_s=FABRIC_BEAT_S).start()
        wait_for(lambda: set(alive()) == {"A-decode", b2_id},
                 "the prefill and decode pools alive", host_b2,
                 "host_b_prefill")
        line["host_b_prefill_start_s"] = round(time.perf_counter() - tb2, 3)
        hand_ix = list(range(FABRIC_HANDOFFS))
        router0 = client.fleet()[1]["router"]
        pf0 = router0["prefill_handoffs_total"]
        streams0 = router0["streams_total"]
        snap0 = gen_a.metrics.snapshot()
        set_flags({"trace_dir": os.path.join(outdir, "trace")})
        try:
            trace.reset()
            with ThreadPoolExecutor(len(hand_ix)) as pool:
                outs = list(pool.map(lambda i: fleet_stream(client, {
                    "input_ids": prompts[i].tolist(),
                    "max_new_tokens": SERVING_NEW}), hand_ix))
            spans = [s["dur"] / 1e3 for s in trace.spans()
                     if s["name"] == "generate.kv_import"]
        finally:
            set_flags({"trace_dir": ""})
        for i, (recs, _, _) in zip(hand_ix, outs):
            check(recs and recs[-1].get("done") is True,
                  f"[fabric] a disaggregated stream ended in "
                  f"{str(recs[-1:])[:300]}")
            token_agreement("fabric-disagg", model, gen_a, prompts[i],
                            [r["token"] for r in recs if "token" in r],
                            refs[i])
        snap1 = gen_a.metrics.snapshot()
        # the door counts a stream when its relay returns, just after
        # the client read the done line
        wait_for(lambda: client.fleet()[1]["router"]["streams_total"]
                 >= streams0 + len(hand_ix), "the door's stream count",
                 timeout=10)
        n_pf = client.fleet()[1]["router"]["prefill_handoffs_total"] - pf0
        n_in = snap1["handoffs_in_total"] - snap0["handoffs_in_total"]
        check(n_pf == len(hand_ix) and n_in == len(hand_ix)
              and len(spans) == len(hand_ix),
              f"[fabric] {n_pf} prefill handoffs at the door, {n_in} "
              f"imports into A, {len(spans)} import spans (want "
              f"{len(hand_ix)})")
        nbytes = snap1["handoff_bytes_total"] - snap0["handoff_bytes_total"]
        line["disaggregated"] = {
            "streams": len(hand_ix),
            "prompt_tokens": [len(prompts[i]) for i in hand_ix],
            "payload_bytes_mean": nbytes / len(hand_ix),
            "import_ms": [round(x, 3) for x in spans],
            "ttft_ms": [round(o[1] * 1e3, 3) for o in outs]}
        mark("disaggregated", t0)
        log(f"[fabric] disaggregated: {json.dumps(line['disaggregated'])}")

        # (5) the door's aggregate health and merged metrics
        status, h = client.healthz()
        rows = {r["host"]: r for r in h["hosts"]}
        check(status == 200 and h["hosts_alive"] == 2
              and rows["A-decode"]["pools"] == ["decode"]
              and rows[b2_id]["pools"] == ["prefill"],
              f"[fabric] door /healthz {h}")
        text = client.metrics_text()
        for host in ("A-decode", b2_id):
            check(f'host="{host}"' in text and
                  f'paddle_fabric_member_state{{host="{host}"' in text,
                  f"[fabric] the merged /metrics lacks host {host}")
        check(f"paddle_fabric_prefill_handoffs_total "
              f"{pf0 + len(hand_ix)}" in text.splitlines(),
              "[fabric] /metrics' prefill handoff count")
        line["door"] = {"hosts": sorted(rows),
                        "metrics_lines": len(text.splitlines())}
    except BaseException:
        for name in procs.procs:
            log(f"[fabric] {name}'s log: {procs.tail(name)}")
        raise
    finally:
        if agent_a is not None:
            agent_a.stop()
        procs.stop()
        if srv_a is not None:
            srv_a.stop(drain=False)
        else:
            for eng in (pred_a, gen_a):
                if eng is not None:
                    eng.shutdown(drain=False)
        if store is not None:
            store.stop()
        shutil.rmtree(outdir, ignore_errors=True)
        del model, gen_a, pred_a, srv_a
        gc.collect()
        torch.cuda.empty_cache()
    line["seconds_by_step"] = seconds
    line["seconds"] = round(time.perf_counter() - t_phase, 1)
    log(f"[fabric] phase took {line['seconds']} s")
    return line


def fabric_only():
    """The kernels' build, the forward held at the predict path's shapes
    in bf16, and the fabric phase alone: prints the card and the `fabric`
    line, not the {"ok": ...} line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from paddle_tpu_torch.models import PRESETS

    card = card_line()
    log(f"card: {card}")
    build_kernels()
    cfg = PRESETS["gpt3-medium"]
    checked = checked_forward_instances(cfg, ("bf16",))["bf16"]
    line = fabric_phase(reference_layout_weights(cfg, SEED), cfg, checked)
    print(card)
    print(json.dumps({"fabric": line}), flush=True)
    return 0



# ------------------------------------------------------- models phase --
def bert_weights(cfg):
    """Seeded random weights for BertForMaskedLM(cfg) in the reference's
    layout (its names, Linear weights [in, out]; framework_io's
    params_to_paddle_tpu of a model drawn on the card): Linear and
    embedding weights normal with std 0.02, biases zero, LayerNorms one
    and zero."""
    import torch

    from paddle_tpu_torch.framework_io import params_to_paddle_tpu
    from paddle_tpu_torch.models import BertForMaskedLM

    g = torch.Generator(device="cuda").manual_seed(SEED)
    model = BertForMaskedLM(cfg, device="cuda")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=g)
    weights = params_to_paddle_tpu(model.state_dict())
    del model
    return weights


def bert_model(cfg, weights, dropout, o2=True):
    """BertForMaskedLM at cfg's widths with `dropout`, from `weights`, on
    the card in train mode, amp.decorate O2 to bf16 (unless `o2` is
    False), and its AdamW (multi_precision: f32 masters)."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.framework_io import params_from_paddle_tpu
    from paddle_tpu_torch.models import BertForMaskedLM
    from paddle_tpu_torch.optimizer import AdamW

    gc.collect()
    torch.cuda.empty_cache()
    model = BertForMaskedLM(type(cfg)(**{**vars(cfg), "dropout": dropout}),
                            device="cuda")
    model.load_state_dict(params_from_paddle_tpu(weights))
    model.train()
    if o2:
        model = amp.decorate(model, level="O2", dtype="bfloat16")
    return model, AdamW(BERT_LR, parameters=model.parameters(),
                        multi_precision=o2)


def bert_eval(model, ids, layers, label):
    """Run (c): an eval forward of BERT_EVAL_ROWS rows of `ids`, one
    forward launch a layer, each call held against its plain version as
    the kernel phase holds it; the logits against the same forward with
    the attention's plain version, as the norm of their difference over
    the reference's (BERT_EVAL_TOL in bf16, PREDICT_TOL's f32 limit in
    f32), beside what two correct plain attentions (P rounded to bf16,
    and not) part by."""
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    model.eval()
    ids = ids[:BERT_EVAL_ROWS]
    plain = dict(fa.PLAIN)
    f32dot_plain = {**plain, "flash_fwd": plain["flash_fwd_f32dot"]}
    calls = []
    fa.reset_launch_counts()
    with torch.inference_mode():
        with forward_checked_against_plain(plain, calls):
            got = model(ids).float()
        launches = flash_counts()
        instances = dict(fa.INSTANCE_LAUNCHES)
        with plain_forward_on_card(plain):
            want = model(ids).float()
        with plain_forward_on_card(f32dot_plain):
            want_f32dot = model(ids).float()
    check(not set(flash_counts()) - {"flash_fwd"},
          f"[bert-c-{label}] the plain forwards launched {flash_counts()}")
    norm = want.norm()
    err = float((got - want).norm() / norm)
    yardstick = float((want_f32dot - want).norm() / norm)
    tol = BERT_EVAL_TOL if label == "bf16" else PREDICT_TOL["f32"]
    out = {"launches": launches, "instances": instances,
           "err_vs_plain": err, "tol": tol,
           "max_abs_err_over_rms": float((got - want).abs().max()
                                         / want.pow(2).mean().sqrt()),
           "plain_f32dot_vs_plain": yardstick,
           "max_call_row_err": max(c["row_err"] for c in calls),
           "call_tol": calls[0]["tol"]}
    log(f"[bert-c-{label}] eval forward: {json.dumps(out)}")
    check(launches == {"flash_fwd": layers},
          f"[bert-c-{label}] eval forward launched {launches}")
    check(len(calls) == layers and all(
        c["row_err"] <= c["tol"] and c["lse_err"] <= LSE_ATOL
        for c in calls), f"[bert-c-{label}] a forward call parts from its "
                         f"plain version: {calls}")
    check(bool(torch.isfinite(got).all()) and got.shape == (
        BERT_EVAL_ROWS, BERT_SEQ, model.cfg.vocab_size),
        f"[bert-c-{label}] logits {tuple(got.shape)}")
    check(err <= tol, f"[bert-c-{label}] logits part from the plain "
                      f"attention's by {err:.3e} (limit {tol})")
    return out


def mlm_batches(cfg, n):
    """n MLM batches from default_rng(SEED): ids in [1000, vocab) drawn by
    a Zipf law (p proportional to 1 / rank), as text's tokens fall; 15%
    of the positions (at least the first of each row) replaced by [MASK]
    and labelled with their ids, -100 elsewhere, as the baseline row's
    test masks them; on the card. (Uniform ids over 29.5K tokens leave a
    held-out batch nothing to learn in a few steps: each step raises the
    tokens it saw and lowers the rest, and the held-out loss rises.)"""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)
    span = cfg.vocab_size - 1000
    zipf = 1.0 / np.arange(1, span + 1)
    zipf /= zipf.sum()
    out = []
    for _ in range(n):
        ids = 1000 + rng.choice(span, size=(BERT_BATCH, BERT_SEQ), p=zipf)
        pos = rng.random(ids.shape) < 0.15
        pos[:, 0] = True
        out.append(tuple(torch.as_tensor(a, device="cuda") for a in (
            np.where(pos, BERT_MASK_ID, ids), np.where(pos, ids, -100))))
    return out


def bert_steps(model, opt, batches):
    """The baseline row's eager step on each batch: the MLM loss under
    auto_cast bf16, backward, opt.step, opt.clear_grad. Returns (losses,
    host seconds of each step, synchronised)."""
    import torch

    from paddle_tpu_torch import amp

    losses, times = [], []
    for ids, labels in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        with amp.auto_cast(dtype="bfloat16"):
            loss = model.loss(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        times.append(time.perf_counter() - t)
    return losses, times


def bert_probe(model, batch):
    """The MLM loss on a fixed batch, without autograd (auto_cast bf16)."""
    import torch

    from paddle_tpu_torch import amp

    with torch.no_grad(), amp.auto_cast(dtype="bfloat16"):
        return float(model.loss(*batch))


def bert_phase(checked):
    """BERT-base MLM under bf16 O2, runs (a)-(d) (see BERT_* above);
    `checked`: the instance of each of flash_fwd, flash_dq and flash_dkv
    that the kernel phase held at this path's shapes."""
    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.models import BertConfig
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = BertConfig()
    t0 = time.perf_counter()
    weights = bert_weights(cfg)
    *batches, probe = mlm_batches(cfg, BERT_STEPS + 1)
    line = {"config": {**vars(cfg), "batch": BERT_BATCH, "seq": BERT_SEQ,
                       "lr": BERT_LR, "steps": BERT_STEPS},
            "parameters": sum(int(w.numel()) for w in weights.values())}
    per_step = cfg.num_layers

    # (a) dropout 0.1: the attention's dropout takes the einsum
    model, opt = bert_model(cfg, weights, cfg.dropout)
    fa.reset_launch_counts()
    losses, times = bert_steps(model, opt, batches)
    launches = flash_counts()
    log(f"[bert-a] dropout {cfg.dropout}: losses {losses}, step s {times}, "
        f"flash launches {launches}")
    check(all(math.isfinite(x) for x in losses), f"[bert-a] {losses}")
    check(not launches, f"[bert-a] dropout launched {launches}")
    line["a_dropout"] = {"losses": losses, "step_s": times,
                         "launches": launches}
    del model, opt

    # (b) dropout 0: the non-causal flash kernels, then the einsum
    model, opt = bert_model(cfg, weights, 0.0)
    before = bert_probe(model, probe)
    fa._IMPL_MEMO.clear()     # so that auto's first attention probes
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    losses, times = bert_steps(model, opt, batches)
    launches = flash_counts()
    by_instance = dict(fa.INSTANCE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    after = bert_probe(model, probe)
    resolved = fa.resolve_dot_impl(torch.device("cuda", 0))
    log(f"[bert-b] dropout 0, auto -> {resolved}: losses {losses}, step s "
        f"{times}, launches {launches}, by instance {by_instance}; probe "
        f"loss {before} -> {after}")
    check(resolved == "bf16", f"[bert-b] auto resolved to {resolved}")
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        want = per_step * BERT_STEPS
        check(launches.get(name, 0) == want,
              f"[bert-b] {name} launched {launches.get(name, 0)} times in "
              f"{BERT_STEPS} steps, expected {want}")
        mine = {i: n for i, n in by_instance.items()
                if i.split("_")[1] == name.split("_")[1]}
        check(mine == {checked[name]: want},
              f"[bert-b] {name}'s launches by instance {mine}, expected "
              f"{want} of {checked[name]}")
    others = {n: c for n, c in launches.items()
              if n not in ("flash_fwd", "flash_dq", "flash_dkv",
                           "flash_probe")}
    check(not others and launches.get("flash_probe", 0) <= 1,
          f"[bert-b] other launches {launches}")
    check(after < before, f"[bert-b] probe loss did not fall: {before} -> "
                          f"{after}")
    step_s = statistics.median(times[1:])
    prof = profile_step(lambda i, y: bert_steps(model, opt, [(i, y)]),
                        *batches[0], step_s, cfg.vocab_size, top=8)
    line["b_flash"] = {
        "losses": losses, "step_s": times, "launches": launches,
        "launches_per_step": {n: c / BERT_STEPS for n, c in launches.items()
                              if n != "flash_probe"},
        "instances": by_instance, "probe_loss": [before, after],
        "tokens_per_s": BERT_BATCH * BERT_SEQ / step_s,
        "peak_gib": gib(peak), "profiled_step": prof}

    # (d) a padded batch under attention_mask: the einsum, no launch
    lengths = torch.randint(BERT_SEQ // 2, BERT_SEQ + 1, (BERT_BATCH,),
                            generator=torch.Generator().manual_seed(SEED))
    keep = (torch.arange(BERT_SEQ)[None] < lengths[:, None]).cuda()
    ids, labels = batches[0]
    ids, labels = ids * keep, torch.where(keep, labels, -100)
    fa.reset_launch_counts()
    with amp.auto_cast(dtype="bfloat16"):
        logits = model(ids, attention_mask=keep.long())
        loss = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                               labels.reshape(-1))
    loss.backward()
    opt.clear_grad()
    launches = flash_counts()
    loss = float(loss.detach())
    del logits
    log(f"[bert-d] padded batch (lengths {int(lengths.min())}-"
        f"{int(lengths.max())}) under attention_mask: loss {loss}, "
        f"launches {launches}")
    check(math.isfinite(loss) and not launches,
          f"[bert-d] loss {loss}, launches {launches}")
    line["d_mask"] = {"loss": loss, "launches": launches,
                      "lengths": [int(lengths.min()), int(lengths.max())]}

    # (c) eval forwards: the trained bf16 model, then an f32 copy of the
    # initial weights (the f32-storage kernel)
    line["c_eval"] = {"bf16": bert_eval(model, probe[0], per_step, "bf16")}
    del model, opt
    model, _ = bert_model(cfg, weights, 0.0, o2=False)
    line["c_eval"]["f32"] = bert_eval(model, probe[0], per_step, "f32")
    del model

    # (b) again with the flash path off: the einsum on the card
    model, opt = bert_model(cfg, weights, 0.0)
    set_flags({"use_flash_attention": False})
    try:
        fa.reset_launch_counts()
        einsum_losses, einsum_times = bert_steps(model, opt, batches)
        launches = flash_counts()
    finally:
        set_flags({"use_flash_attention": True})
    diff = max(abs(a - b) / abs(b) for a, b in zip(losses, einsum_losses))
    log(f"[bert-b] flash off (einsum): losses {einsum_losses}, step s "
        f"{einsum_times}; largest relative difference from the flash run's "
        f"{diff:.3e} (limit {BERT_FLASH_LOSS_RTOL})")
    check(not launches, f"[bert-b] flash off launched {launches}")
    check(diff <= BERT_FLASH_LOSS_RTOL,
          f"[bert-b] losses {losses} vs einsum {einsum_losses}")
    line["b_flash"].update(
        einsum_losses=einsum_losses, einsum_step_s=einsum_times,
        loss_rel_diff=diff, loss_rtol=BERT_FLASH_LOSS_RTOL,
        einsum_tokens_per_s=BERT_BATCH * BERT_SEQ
        / statistics.median(einsum_times[1:]))
    del model, opt
    line["seconds"] = round(time.perf_counter() - t0, 1)
    return line


def resnet_phase():
    """ResNet-50 (small_input, 10 classes, f32) on the card: RESNET_STEPS
    dygraph Momentum steps on one fixed CIFAR-shaped batch (the loss must
    fall, every batch-norm buffer must move), then an eval forward
    against a CPU copy of the same state."""
    import numpy as np
    import torch

    from paddle_tpu_torch.jit import EvalStep
    from paddle_tpu_torch.models import resnet50
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    model = resnet50(num_classes=10, small_input=True, device="cuda",
                     generator=g)
    model.train()
    rng = np.random.default_rng(SEED)
    x = torch.as_tensor(rng.standard_normal((RESNET_BATCH, 3, 32, 32),
                                            dtype=np.float32), device="cuda")
    y = torch.as_tensor(rng.integers(0, 10, RESNET_BATCH), device="cuda")
    initial = {n: b.clone() for n, b in model.named_buffers()}
    opt = Momentum(RESNET_LR, momentum=0.9, parameters=model.parameters())
    lossf = CrossEntropyLoss()

    def step(x, y):
        loss = lossf(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(RESNET_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(float(step(x, y).detach()))
        times.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(times[1:])
    moved = sum(not torch.equal(b, initial[n])
                for n, b in model.named_buffers())
    log(f"[resnet50] losses {losses}, step s {times}, "
        f"{RESNET_BATCH / step_s:.0f} images/s, peak "
        f"{peak / 2**30:.2f} GiB; {moved} of {len(initial)} batch-norm "
        f"buffers moved")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"[resnet50] loss did not fall: {losses}")
    check(moved == len(initial) and len(initial) == 2 * 53,
          f"[resnet50] {moved} of {len(initial)} buffers moved")
    prof = profile_step(step, x, y, step_s, None, top=8)

    # eval on the running statistics, against a CPU copy of the state
    xe = x[:RESNET_EVAL_ROWS]
    got = EvalStep(model)(xe).float().cpu()
    cpu = resnet50(num_classes=10, small_input=True, device="cpu")
    cpu.load_state_dict({n: t.cpu() for n, t in model.state_dict().items()})
    want = EvalStep(cpu)(xe.cpu())
    rms = want.pow(2).mean().sqrt()
    err = float((got - want).abs().max() / rms)
    log(f"[resnet50] eval logits vs the CPU copy's: {err:.3e} of their RMS "
        f"(limit {RESNET_EVAL_TOL})")
    check(bool(torch.isfinite(got).all()) and err <= RESNET_EVAL_TOL,
          f"[resnet50] eval logits part from the CPU copy's by {err:.3e}")
    del model, opt, cpu
    return {"config": {"model": "resnet50", "small_input": True,
                       "num_classes": 10, "batch": RESNET_BATCH,
                       "lr": RESNET_LR, "momentum": 0.9,
                       "steps": RESNET_STEPS, "dtype": "float32"},
            "losses": losses, "step_s": times,
            "images_per_s": RESNET_BATCH / step_s, "peak_gib": gib(peak),
            "buffers_moved": moved, "buffers": len(initial),
            "eval_err_vs_cpu": err, "eval_tol": RESNET_EVAL_TOL,
            "profiled_step": prof,
            "seconds": round(time.perf_counter() - t0, 1)}


def models_phase():
    """The kernels at BERT-base's attention shape (B = 32, L = 512, 12
    heads, D = 64, bf16, non-causal: timed, their rows named
    `name@noncausal`), then the BERT and ResNet-50 runs. Returns (the
    `models` line, the kernel rows with BERT run (b)'s launches)."""
    cfg_heads = 12
    rows = kernel_phase(BERT_BATCH, BERT_SEQ, cfg_heads, 64, "bfloat16",
                        False, timed=True,
                        time_names=("flash_fwd", "flash_dq", "flash_dkv"))
    checked = {r["name"]: r["instance"] for r in rows}
    line = {"bert": bert_phase(checked), "resnet50": resnet_phase()}
    launches = line["bert"]["b_flash"]["launches"]
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["launches_per_step"] = launches[r["name"]] / BERT_STEPS
        r["name"] += "@noncausal"
    return line, rows


def models_only():
    """The kernels' build and the models phase alone: prints the card,
    the non-causal kernel rows and the `models` line, not the
    {"ok": ...} line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}")
    build_kernels()
    line, rows = models_phase()
    print(card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"models": line}), flush=True)
    return 0


# ----------------------------------------------------------- fit phase --
def fit_clock():
    """A fit callback: the host seconds of each step, from the previous
    step's end (the first: from train begin) to its own, and the part of
    them spent before the step began (the wait for its batch); each
    step's flash launches."""
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.ops import flash_attention as fa

    class Clock(Callback):
        def on_train_begin(self, logs=None):
            self.steps, self.waits, self.launches = [], [], []
            self._end = time.perf_counter()
            self._mark = dict(fa.LAUNCHES)

        def on_train_batch_begin(self, step, logs=None):
            self._begin = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            now = time.perf_counter()
            self.steps.append(now - self._end)
            self.waits.append(self._begin - self._end)
            self._end = now
            cur = dict(fa.LAUNCHES)
            self.launches.append({n: c - self._mark.get(n, 0)
                                  for n, c in cur.items()
                                  if c != self._mark.get(n, 0)})
            self._mark = cur

        def rates(self, items):
            """Items/s, batches/s and the share of the time spent waiting
            for batches, over the steps after the first (warm-up)."""
            total = sum(self.steps[1:])
            return {"items_per_s": items * (len(self.steps) - 1) / total,
                    "batches_per_s": (len(self.steps) - 1) / total,
                    "starvation_fraction": sum(self.waits[1:]) / total,
                    "first_step_s": self.steps[0],
                    "median_step_s": statistics.median(self.steps[1:])}

    return Clock()


def image_transforms(train):
    from paddle_tpu_torch.vision import transforms as T

    head = [T.RandomCrop(32, padding=4), T.RandomHorizontalFlip()] \
        if train else []
    return T.Compose(head + [T.ToTensor(),
                             T.Normalize([0.5] * 3, [0.5] * 3)])


def loaders_agree(data):
    """One shuffled epoch of a forked and a threaded DataLoader over
    `data` (deterministic transforms), numpy's stream seeded alike: the
    same batches in the same order, bitwise; and each loader's own rate
    with no model behind it."""
    import numpy as np

    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.io import DataLoader

    out, batches = {}, {}
    for kind in ("forked", "threaded"):
        set_flags({"dataloader_fork_workers": kind == "forked"})
        np.random.seed(SEED)
        loader = DataLoader(data, batch_size=FIT_BATCH, shuffle=True,
                            num_workers=FIT_WORKERS)
        t = time.perf_counter()
        batches[kind] = list(loader)
        out[kind + "_batches_per_s"] = len(batches[kind]) / (
            time.perf_counter() - t)
        if kind == "forked":
            check(loader._fork_safe(), "[fit] the forked loader fell back "
                                       "to threads")
    set_flags({"dataloader_fork_workers": False})
    same = len(batches["forked"]) == len(batches["threaded"]) and all(
        all(a.dtype == b.dtype and bool((a == b).all())
            for a, b in zip(f, t))
        for f, t in zip(batches["forked"], batches["threaded"]))
    check(same, "[fit] the forked and the threaded loaders delivered "
                "different batches")
    out["batches"] = len(batches["forked"])
    log(f"[fit] forked and threaded loaders agree over "
        f"{out['batches']} batches: {json.dumps(out)}")
    return out


def resnet_fit_run(kind, train):
    """ResNet-50 (seeded random init on the card) through Model.fit over
    `train` with forked or threaded workers. Returns (the Model, its
    numbers)."""
    import random

    import numpy as np
    import torch

    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.models import resnet50
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum

    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    net = resnet50(num_classes=10, small_input=True, device="cuda",
                   generator=g)
    model = Model(net)
    model.prepare(Momentum(RESNET_LR, momentum=0.9,
                           parameters=net.parameters()),
                  CrossEntropyLoss(), Accuracy(topk=(1, 5)))
    set_flags({"dataloader_fork_workers": kind == "forked"})
    random.seed(SEED)
    np.random.seed(SEED)
    clock = fit_clock()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        hist = model.fit(train, batch_size=FIT_BATCH, epochs=FIT_EPOCHS,
                         shuffle=True, num_workers=FIT_WORKERS, verbose=0,
                         callbacks=[clock])
    finally:
        set_flags({"dataloader_fork_workers": False})
    seconds = time.perf_counter() - t0
    losses = hist["loss"]
    steps = FIT_EPOCHS * (FIT_IMAGES // FIT_BATCH)
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    out = {"loader": kind, "losses": losses, "steps": len(losses),
           **clock.rates(FIT_BATCH), "seconds": seconds,
           "peak_gib": gib(torch.cuda.max_memory_allocated())}
    log(f"[fit-resnet50-{kind}] {len(losses)} steps in {seconds:.1f} s: "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first 5 "
        f"{first:.4f}, of the last 5 {last:.4f}); "
        f"{out['items_per_s']:.0f} images/s, starvation "
        f"{out['starvation_fraction']:.4f}, peak {out['peak_gib']:.2f} GiB")
    check(len(losses) == steps, f"[fit-resnet50-{kind}] {len(losses)} "
                                f"steps, expected {steps}")
    check(all(math.isfinite(v) for v in losses) and last < first,
          f"[fit-resnet50-{kind}] the loss did not fall: {first} -> {last}")
    return model, out


def resnet_fit_phase():
    """Run (a): the loaders' agreement, the forked and the threaded fit,
    then evaluate, predict and a save/load round trip on the forked
    run's model."""
    import shutil

    import numpy as np
    import torch

    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.jit import EvalStep
    from paddle_tpu_torch.models import resnet50
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.datasets import FakeData

    train = FakeData(FIT_IMAGES, transform=image_transforms(True))
    plain = FakeData(FIT_IMAGES, transform=image_transforms(False))
    line = {"loaders": loaders_agree(plain)}
    model, line["forked"] = resnet_fit_run("forked", train)

    logs = model.evaluate(plain, batch_size=2 * FIT_BATCH,
                          num_workers=FIT_WORKERS, verbose=0)
    top1, top5 = logs["acc_top1"]
    counts = np.bincount(plain.labels, minlength=10)
    majority = float(counts.max() / counts.sum())
    pred = model.predict(plain, batch_size=2 * FIT_BATCH,
                         num_workers=FIT_WORKERS, stack_outputs=True)
    pred_top1 = float((pred.argmax(1) == plain.labels).mean())
    log(f"[fit-resnet50] evaluate on the training set: loss "
        f"{logs['loss']:.4f}, top-1 {top1:.4f}, top-5 {top5:.4f} (chance "
        f"0.1; the commonest label's share {majority:.4f}); predict "
        f"{pred.shape}, its top-1 {pred_top1:.4f}")
    check(top1 > 0.1, f"[fit-resnet50] top-1 {top1} is not above chance")
    check(pred.shape == (FIT_IMAGES, 10) and bool(np.isfinite(pred).all())
          and abs(pred_top1 - top1) <= 1.0 / FIT_IMAGES,
          f"[fit-resnet50] predict {pred.shape} (top-1 {pred_top1} against "
          f"evaluate's {top1})")
    line["eval"] = {"loss": logs["loss"], "top1": top1, "top5": top5,
                    "chance": 0.1, "majority_label_share": majority,
                    "predict_top1": pred_top1}

    # save/load: a fresh model loads the files; its eval logits are
    # bitwise the saved model's
    ckdir = os.path.join("build", "fit_ckpt")
    path = os.path.join(ckdir, "resnet50")
    try:
        model.save(path)
        nbytes = sum(os.path.getsize(path + ext)
                     for ext in (".pdparams", ".pdopt"))
        g = torch.Generator(device="cuda").manual_seed(SEED + 1)
        net2 = resnet50(num_classes=10, small_input=True, device="cuda",
                        generator=g)
        other = Model(net2)
        other.prepare(Momentum(RESNET_LR, momentum=0.9,
                               parameters=net2.parameters()),
                      CrossEntropyLoss())
        other.load(path)
        x = torch.stack([torch.from_numpy(plain[i][0])
                         for i in range(RESNET_EVAL_ROWS)]).cuda()
        same = torch.equal(EvalStep(model.network)(x),
                           EvalStep(net2)(x))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    log(f"[fit-resnet50] save/load: {nbytes} bytes, reloaded eval logits "
        f"bitwise the saved model's: {same}")
    check(same, "[fit-resnet50] the reloaded model's eval logits differ")
    line["save_load"] = {"bytes": nbytes, "bitwise": same}
    del model, other, net2

    _, line["threaded"] = resnet_fit_run("threaded", train)
    return line


def mlm_dataset(cfg):
    """FIT_BERT_ROWS rows of BERT_SEQ ids in [1000, vocab) drawn by a Zipf
    law from default_rng(SEED), as mlm_batches draws them, made in bulk;
    a sample is (its index, its ids)."""
    import numpy as np

    from paddle_tpu_torch.io import Dataset

    rng = np.random.default_rng(SEED)
    span = cfg.vocab_size - 1000
    zipf = 1.0 / np.arange(1, span + 1)
    zipf /= zipf.sum()
    rows = 1000 + rng.choice(span, size=(FIT_BERT_ROWS, BERT_SEQ), p=zipf)

    class Rows(Dataset):
        def __len__(self):
            return len(rows)

        def __getitem__(self, i):
            return i, rows[i]

    return Rows()


def mlm_corrupt(sample):
    """The MLM corruption (Pipeline.map): 15% of the positions, at least
    the first, from default_rng((SEED, index)), become [MASK] and are
    labelled with their ids, -100 elsewhere."""
    import numpy as np

    i, ids = sample
    pos = np.random.default_rng((SEED, int(i))).random(ids.shape) < 0.15
    pos[0] = True
    return (np.where(pos, BERT_MASK_ID, ids).astype(np.int64),
            np.where(pos, ids, -100).astype(np.int64))


def mlm_pipeline(data, seed, prefetch=True):
    from paddle_tpu_torch.io import pipeline

    pipe = pipeline.from_dataset(data, shuffle=True, seed=seed) \
        .map(mlm_corrupt).batch(BERT_BATCH).workers(FIT_WORKERS)
    return pipe.device_prefetch(FIT_PREFETCH, device="cuda") if prefetch \
        else pipe


def bert_fit_model(cfg, weights):
    """BERT-base from `weights` (bf16 O2, AdamW with f32 masters) as a
    Model whose loss layer keeps a copy of every label batch and whose
    network keeps a copy of every input batch it is given."""
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.nn import CrossEntropyLoss

    net, opt = bert_model(cfg, weights, 0.0)
    seen = {"ids": [], "labels": []}

    class Recording(CrossEntropyLoss):
        def forward(self, input, label):
            seen["labels"].append(label.detach().clone())
            return super().forward(input, label)

    net.register_forward_pre_hook(
        lambda m, args: seen["ids"].append(args[0].detach().clone()))
    model = Model(net)
    model.prepare(opt, Recording(ignore_index=-100),
                  amp_configs={"level": "O2", "dtype": "bfloat16"})
    return model, seen


def bert_matmul_flops(cfg):
    """Products of one BERT-base MLM training step, from the config:
    2 * rows * in * out for each weight product of the forward (every
    Linear over the tokens; the pooler over the first token of each row;
    the MLM head's product with the vocab's embedding rows), and twice
    that in the backward (dX and dW) but for the pooler, whose output
    the loss does not read."""
    tokens = BERT_BATCH * BERT_SEQ
    h, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    per_token = cfg.num_layers * (4 * h * h + 2 * h * f) + h * h + h * v
    pooler = 2 * BERT_BATCH * h * h
    fwd = 2 * tokens * per_token + pooler
    return fwd + 2 * (fwd - pooler)


def bert_fit_phase():
    """Runs (b) and (c)."""
    import numpy as np
    import torch

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.hapi.callbacks import ProfilerCallback
    from paddle_tpu_torch.models import BertConfig
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.profiler.stats import aggregator, flops

    cfg = BertConfig()
    weights = bert_weights(cfg)
    data = mlm_dataset(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    model, seen = bert_fit_model(cfg, weights)

    # (b) FIT_BERT_ITERS steps over the pipeline
    pipe = mlm_pipeline(data, SEED)
    fa._IMPL_MEMO.clear()      # so that auto probes the card again
    fa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    clock = fit_clock()
    t0 = time.perf_counter()
    hist = model.fit(pipe, epochs=1, num_iters=FIT_BERT_ITERS, verbose=0,
                     callbacks=[clock])
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = hist["loss"]
    snap = pipe.metrics.snapshot()
    instances = dict(fa.INSTANCE_LAUNCHES)
    resolved = fa.resolve_dot_impl(torch.device("cuda", 0))
    rates = clock.rates(BERT_BATCH * BERT_SEQ)
    resident = FIT_PREFETCH * 2 * BERT_BATCH * BERT_SEQ * 8
    log(f"[fit-bert] {len(losses)} steps in {seconds:.1f} s, auto -> "
        f"{resolved}: losses {losses}; {rates['items_per_s']:.0f} tokens/s, "
        f"starvation by the clock {rates['starvation_fraction']:.4f}, the "
        f"pipeline's {snap['starvation_fraction']}; copy "
        f"{1e3 * snap['device_put_s'] / max(snap['batches'], 1):.3f} ms a "
        f"batch; {resident} bytes resident in the prefetch; peak "
        f"{gib(peak):.2f} GiB; launches by step {clock.launches}; by "
        f"instance {instances}")
    check(resolved == "bf16", f"[fit-bert] auto resolved to {resolved}")
    check(len(losses) == FIT_BERT_ITERS and all(
        math.isfinite(x) for x in losses), f"[fit-bert] losses {losses}")
    check(statistics.mean(losses[-4:]) < statistics.mean(losses[:4]),
          f"[fit-bert] the loss did not fall: {losses}")
    want = {"flash_fwd": cfg.num_layers, "flash_dq": cfg.num_layers,
            "flash_dkv": cfg.num_layers}
    for i, got in enumerate(clock.launches):
        got = {n: c for n, c in got.items() if n != "flash_probe"}
        check(got == want, f"[fit-bert] step {i} launched {got}, expected "
                           f"{want}")
    check(fa.LAUNCHES["flash_probe"] <= 1, "[fit-bert] the probe ran "
                                           "more than once")
    total = cfg.num_layers * FIT_BERT_ITERS
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        inst = f"{name}_mma_kernel<64, kStd, kBf16>"
        mine = {i: n for i, n in instances.items()
                if i.startswith(name + "_")}
        check(mine == {inst: total}, f"[fit-bert] {name}'s launches by "
                                     f"instance {mine}, expected {total} "
                                     f"of {inst}")

    # every batch the steps took is bitwise the host batch it came from
    host = list(mlm_pipeline(data, SEED, prefetch=False).iter_epoch(0))
    host = host[:FIT_BERT_ITERS]
    same = len(seen["ids"]) == len(seen["labels"]) == len(host) and all(
        torch.equal(i.cpu(), torch.from_numpy(h[0])) and torch.equal(
            l.cpu(), torch.from_numpy(h[1]))
        for i, l, h in zip(seen["ids"], seen["labels"], host))
    log(f"[fit-bert] the {len(host)} prefetched batches bitwise their host "
        f"batches: {same}")
    check(same, "[fit-bert] a prefetched batch differs from its host batch")
    seen["ids"].clear()
    seen["labels"].clear()
    line = {"b": {"losses": losses, "steps": len(losses),
                  "seconds": seconds, **rates,
                  "tokens_per_s": rates["items_per_s"],
                  "pipeline": snap,
                  "copy_ms_per_batch": 1e3 * snap["device_put_s"]
                  / max(snap["batches"], 1),
                  "resident_prefetch_bytes": resident,
                  "peak_gib": gib(peak),
                  "launches_per_step": clock.launches[1],
                  "instances": instances, "prefetch_bitwise": same}}

    # (c) FIT_PROFILED_ITERS more steps under the profiler
    cb = ProfilerCallback(
        scheduler=profiler.make_scheduler(closed=1, ready=1,
                                          record=FIT_RECORDED),
        timer_only=False, with_flops=True, profile_memory=True,
        print_summary=False)
    t0 = time.perf_counter()
    model.fit(mlm_pipeline(data, SEED + 1), epochs=1,
              num_iters=FIT_PROFILED_ITERS, verbose=0, callbacks=[cb])
    prof_s = time.perf_counter() - t0
    prof = cb.profiler
    summary = prof.summary_dict(top_ops=8)
    ops = aggregator.op_stats(prof.events())
    products = sum(ops[n].flops for n in ("mm", "addmm", "bmm")
                   if n in ops) / FIT_RECORDED
    expected = bert_matmul_flops(cfg)
    att = ops.get("scaled_dot_product_attention")
    per_call = flops.attention_flops(
        (BERT_BATCH, BERT_SEQ, cfg.num_heads, 64),
        (BERT_BATCH, BERT_SEQ, cfg.num_heads, 64))
    kernels = {k["name"]: k for k in summary.get("device_kernels", [])}
    log(f"[fit-profiler] {len(prof.kernels)} kernels in the device trace; "
        f"those of the attention op: "
        f"{[k for k in prof.kernels if aggregator.kernel_op(k)]}")
    flash = {name: [k for n, k in kernels.items() if name in n]
             for name in ("flash_fwd_mma_kernel", "flash_dq_mma_kernel",
                          "flash_dkv_mma_kernel")}
    trace_path = os.path.join("build", "fit_trace.json")
    prof.export(trace_path)
    log(f"[fit-profiler] {FIT_PROFILED_ITERS} steps in {prof_s:.1f} s, "
        f"{FIT_RECORDED} recorded: step MFU {summary.get('step_mfu')}, "
        f"products {products:.6e} FLOPs a step against {expected:.6e} from "
        f"the config ({products / expected - 1:+.5f}); attention events "
        f"{att.calls if att else 0} of {att.flops // max(att.calls, 1) if att else 0} "
        f"FLOPs (want {cfg.num_layers * FIT_RECORDED} of {per_call}); "
        f"memory {summary.get('memory')}; flash kernels {flash}; trace "
        f"{trace_path} ({os.path.getsize(trace_path)} bytes)")
    log(f"[fit-profiler] summary_dict: {json.dumps(summary, default=str)}")
    check(len(summary.get("step_mfu", [])) == FIT_RECORDED and all(
        0 < m < 1 for m in summary["step_mfu"]),
        f"[fit-profiler] step MFU {summary.get('step_mfu')}")
    check(abs(products / expected - 1) <= FIT_FLOPS_RTOL,
          f"[fit-profiler] products {products} FLOPs a step, {expected} "
          f"from the config")
    check(att is not None and att.calls == cfg.num_layers * FIT_RECORDED
          and att.flops == att.calls * per_call,
          f"[fit-profiler] attention events {att and att.calls}, FLOPs "
          f"{att and att.flops}")
    for name, ks in flash.items():
        check(len(ks) == 1 and ks[0]["launches"]
              == cfg.num_layers * FIT_RECORDED,
              f"[fit-profiler] the device table's {name}: {ks}")
    check(summary.get("memory", {}).get("peak_bytes", 0) > 0,
          f"[fit-profiler] memory {summary.get('memory')}")
    check("input_pipeline" in summary, "[fit-profiler] no input_pipeline "
                                       "section")
    line["c"] = {"seconds": prof_s, "recorded_steps": FIT_RECORDED,
                 "step_mfu": summary["step_mfu"],
                 "avg_step_time_ms": summary["avg_step_time_ms"],
                 "flops_per_step": summary["flops_per_step"],
                 "matmul_flops_per_step": products,
                 "matmul_flops_expected": expected,
                 "attention_events": att.calls,
                 "attention_flops_per_event": att.flops // att.calls,
                 "flash_kernels": {n: ks[0] for n, ks in flash.items()},
                 "device_ms": summary.get("device_ms"),
                 "memory": summary["memory"],
                 "input_pipeline": summary["input_pipeline"],
                 "top_ops": summary["top_ops"],
                 "trace_bytes": os.path.getsize(trace_path)}
    del model, seen, cb, prof
    os.remove(trace_path)

    # (b)'s first step again with the flash path off (the einsum)
    gc.collect()
    torch.cuda.empty_cache()
    model, _ = bert_fit_model(cfg, weights)
    set_flags({"use_flash_attention": False})
    try:
        fa.reset_launch_counts()
        einsum = model.fit(mlm_pipeline(data, SEED), epochs=1, num_iters=1,
                           verbose=0)["loss"][0]
        launched = flash_counts()
    finally:
        set_flags({"use_flash_attention": True})
    diff = abs(losses[0] - einsum) / abs(einsum)
    log(f"[fit-bert] step 1 with the flash path off: {einsum} against "
        f"{losses[0]} ({diff:.3e}, limit {BERT_FLASH_LOSS_RTOL}); "
        f"launches {launched}")
    check(not launched and diff <= BERT_FLASH_LOSS_RTOL,
          f"[fit-bert] einsum step 1 {einsum} vs flash {losses[0]}, "
          f"launches {launched}")
    line["b"].update(einsum_step1_loss=einsum, step1_rel_diff=diff,
                     step1_rtol=BERT_FLASH_LOSS_RTOL)
    del model
    return line


def fit_phase(direct=None):
    """The training API on the card: runs (a), (b) and (c) (see FIT_*);
    `direct`: the models phase's line, whose direct loops at the same
    shapes stand beside fit's rates."""
    t0 = time.perf_counter()
    line = {"resnet50": resnet_fit_phase(), "bert": bert_fit_phase()}
    if direct is not None:
        line["direct"] = {
            "resnet50_images_per_s": direct["resnet50"]["images_per_s"],
            "bert_tokens_per_s": direct["bert"]["b_flash"]["tokens_per_s"]}
    line["seconds"] = round(time.perf_counter() - t0, 1)
    return line


def fit_only():
    """The kernels' build and the fit phase alone: prints the card and the
    `fit` line, not the {"ok": ...} line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}")
    build_kernels()
    line = fit_phase()
    print(card)
    print(json.dumps({"fit": line}), flush=True)
    return 0


# ------------------------------------------------------------- ops phase --
# (a) the op sweep: every op of the op surface on the card and on the CPU,
# on the same seeded inputs (about 1M elements for element-wise ops and
# reductions, 1024 x 1024 for the shape, index and sort families); the
# card's outputs lie on the card, with the CPU's dtypes, bitwise where the
# family is exact and within OPS_LIMITS where it is float
OPS_N = 1024
OPS_LIMITS = {"creation": 0.0, "integer": 0.0, "logic": 0.0,
              "manipulation": 0.0, "index": 0.0, "sort": 0.0,
              "random": 0.0, "elementwise": 1e-5, "special": 1e-4,
              "reduction": 1e-5, "linalg": 1e-5, "activation": 1e-5,
              "bf16": 2.0 ** -7,
              # randn and standard_normal (sqrt(2) * erfinv) go through
              # two erfinv series, the card's and the CPU's: 4 float32
              # units in the last place of each element
              "normal": 4 * 2.0 ** -23}
# rows with a limit of their own, out of their family's worst:
# - digamma: the card's series parts from the CPU's by about 5e-7
#   absolute near its root at 1.4616, 2.4e-4 of the floor below (a
#   thousandth of the output's scale; on an NVIDIA H100 80GB HBM3 at
#   700.00 W);
# - normal(1, 2): its shift cancels near 0, so it is held to 8 float32
#   units in the last place of the output's scale (its largest entry)
OPS_ROW_LIMITS = {"digamma": 5e-4, "normal": 8 * 2.0 ** -23}
# rows held against the output's largest entry, not each entry: products
# (the linalg family), normal(1, 2), and x - tanh(x), which cancels near 0
OPS_SCALE_ROWS = ("F.tanhshrink", "normal")


def ops_inputs(seed):
    """The sweep's seeded numpy inputs."""
    import numpy as np

    rng = np.random.RandomState(seed)
    n = OPS_N

    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, shape or (n, n)).astype(np.float32)

    ins = {"x": u(-2, 2), "y": u(-2, 2), "pos": u(0.5, 2), "pos2": u(0.5, 2),
           "unit": u(-0.9, 0.9), "near1": u(0.999, 1.001),
           "p01": u(0.02, 0.98), "vec": u(-2, 2, n), "vec2": u(-2, 2, n),
           "small": u(-2, 2, 32, 32), "small2": u(-2, 2, 32, 32),
           "x3": u(-2, 2, 16, 64, n), "pts": u(-2, 2, n * n // 2, 2),
           "seq": np.sort(u(-2, 2, n)),
           "i64": rng.randint(-50, 50, (n, n)).astype(np.int64),
           "i64b": rng.randint(-50, 50, (n, n)).astype(np.int64),
           "ipos": rng.randint(1, 9, (n, n)).astype(np.int64),
           "i32": rng.randint(-50, 50, (n, n)).astype(np.int32),
           "ties": rng.randint(0, 8, (n, n)).astype(np.float32),
           "b": rng.rand(n, n) > 0.5, "b2": rng.rand(n, n) > 0.5,
           "idx": rng.randint(-n, n, n).astype(np.int64),
           "perm": rng.permutation(n).astype(np.int64),
           "ids": rng.randint(0, 64, n * n).astype(np.int64),
           "rates": np.repeat(np.array([0.0, 0.5, 3.0, 9.5, 12.0, 40.0],
                                       np.float32), 1 << 13)}
    ins["nans"] = ins["x"].copy()
    ins["nans"][rng.rand(n, n) < 0.05] = np.nan
    ins["x3_w"] = u(-2, 2, n, 5)
    ins["v3"] = u(-2, 2, 1 << 18, 3)
    ins["w3"] = u(-2, 2, 1 << 18, 3)
    return ins


def ops_table():
    """(family, name, fn(P, F, *inputs), input names) of every swept op."""
    t = []

    def add(family, name, fn, *names):
        t.append((family, name, fn, names))

    # creation (on the current place: the card, then the CPU)
    for name, fn in (
            ("zeros", lambda P, F: P.zeros([OPS_N, OPS_N])),
            ("ones", lambda P, F: P.ones([OPS_N, OPS_N], "int32")),
            ("full", lambda P, F: P.full([OPS_N, OPS_N], 1.5)),
            ("full_int", lambda P, F: P.full([OPS_N], 3)),
            ("full_bool", lambda P, F: P.full([OPS_N], True)),
            ("empty", lambda P, F: P.empty([OPS_N, 2])),
            ("arange", lambda P, F: P.arange(OPS_N * OPS_N)),
            ("arange_float", lambda P, F: P.arange(0.0, 100.0, 1e-4)),
            ("linspace", lambda P, F: P.linspace(-2.5, 3.1, OPS_N * OPS_N)),
            ("linspace_int", lambda P, F: P.linspace(0, 1e6, 4097,
                                                     "int64")),
            ("eye", lambda P, F: P.eye(OPS_N)),
            ("tril_indices", lambda P, F: P.tril_indices(OPS_N)),
            ("triu_indices", lambda P, F: P.triu_indices(OPS_N, OPS_N, 1)),
            ("fill_constant", lambda P, F: P.fill_constant(
                [OPS_N, OPS_N], "float32", 3.5)),
            ("create_tensor", lambda P, F: P.create_tensor("int32"))):
        add("creation", name, fn)
    for name, fn, ins in (
            ("zeros_like", lambda P, F, x: P.zeros_like(x), ("x",)),
            ("ones_like", lambda P, F, x: P.ones_like(x, "int64"), ("x",)),
            ("full_like", lambda P, F, x: P.full_like(x, 2.5), ("i64",)),
            ("empty_like", lambda P, F, x: P.empty_like(x), ("i32",)),
            ("tril", lambda P, F, x: P.tril(x, -3), ("x",)),
            ("triu", lambda P, F, x: P.triu(x, 2), ("i64",)),
            ("diag", lambda P, F, v: P.diag(v, 1, padding_value=9), ("vec",)),
            ("diag_mat", lambda P, F, x: P.diag(x), ("x",)),
            ("diagflat", lambda P, F, x: P.diagflat(x), ("vec",)),
            ("diag_embed", lambda P, F, x: P.diag_embed(x), ("small",)),
            ("diagonal", lambda P, F, x: P.diagonal(x, 1), ("x",)),
            ("meshgrid", lambda P, F, a, b: P.meshgrid(a, b),
             ("vec", "vec2")),
            ("clone", lambda P, F, x: P.clone(x), ("x",)),
            ("assign", lambda P, F, x: P.assign(x), ("i64",)),
            ("complex", lambda P, F, a, b: P.complex(a, b), ("x", "y")),
            ("as_complex", lambda P, F, x: P.as_complex(P.reshape(
                x, [OPS_N, -1, 2])), ("x",)),
            ("as_real", lambda P, F, a, b: P.as_real(P.complex(a, b)),
             ("x", "y"))):
        add("creation", name, fn, *ins)
    # random: seeded alike before each side's draw
    for name, fn, ins in (
            ("rand", lambda P, F: P.rand([OPS_N, OPS_N]), ()),
            ("rand_f64", lambda P, F: P.rand([OPS_N, OPS_N], "float64"), ()),
            ("rand_bf16", lambda P, F: P.rand([OPS_N, OPS_N], "bfloat16"),
             ()),
            ("uniform", lambda P, F: P.uniform([OPS_N, OPS_N], min=-3.0,
                                               max=5.0), ()),
            ("uniform_seed", lambda P, F: P.uniform([OPS_N, OPS_N],
                                                    seed=11), ()),
            ("randint", lambda P, F: P.randint(0, 1000, [OPS_N, OPS_N]), ()),
            ("randint_int32", lambda P, F: P.randint(-5, 5, [OPS_N, OPS_N],
                                                     "int32"), ()),
            ("randint_wide", lambda P, F: P.randint(0, 1 << 40, [OPS_N]), ()),
            ("randint_like", lambda P, F, x: P.randint_like(x, 7), ("x",)),
            ("randperm", lambda P, F: P.randperm(OPS_N * OPS_N), ()),
            ("bernoulli", lambda P, F, p: P.bernoulli(p), ("p01",)),
            ("multinomial", lambda P, F, v: P.multinomial(
                P.abs(v), 64), ("vec",)),
            ("multinomial_replace", lambda P, F, v: P.multinomial(
                P.abs(v), 4096, True), ("vec",)),
            ("poisson", lambda P, F, r: P.poisson(r), ("rates",))):
        add("random", name, fn, *ins)
    for name, fn in (
            ("randn", lambda P, F: P.randn([OPS_N, OPS_N])),
            ("standard_normal", lambda P, F: P.standard_normal(
                [OPS_N, OPS_N])),
            ("normal", lambda P, F: P.normal(1.0, 2.0, [OPS_N, OPS_N]))):
        add("normal", name, fn)
    # element-wise math (float32; bf16 below)
    for name in ("add", "subtract", "multiply", "divide", "maximum",
                 "minimum", "fmax", "fmin", "atan2", "logaddexp", "hypot",
                 "copysign", "heaviside", "nextafter", "pow", "xlogy",
                 "floor_divide", "remainder", "mod", "floor_mod", "mul"):
        add("elementwise", name, lambda P, F, a, b, n=name: getattr(P, n)(
            a, b), "pos", "pos2")
    for name, dom in (
            ("exp", "x"), ("expm1", "x"), ("log", "pos"), ("log2", "pos"),
            ("log10", "pos"), ("log1p", "pos"), ("sqrt", "pos"),
            ("rsqrt", "pos"), ("square", "x"), ("sin", "x"), ("cos", "x"),
            ("tan", "unit"), ("asin", "unit"), ("acos", "unit"),
            ("atan", "x"), ("sinh", "x"), ("cosh", "x"), ("tanh", "x"),
            ("asinh", "x"), ("acosh", "pos"), ("atanh", "unit"),
            ("reciprocal", "pos"), ("erf", "x"), ("deg2rad", "x"),
            ("rad2deg", "x"), ("sinc", "x"), ("angle", "x"),
            ("sigmoid", "x"), ("neg", "x"), ("abs", "x"), ("floor", "x"),
            ("ceil", "x"), ("round", "x"), ("trunc", "x"), ("frac", "x"),
            ("sign", "x"), ("sgn", "x"), ("conj", "x"), ("real", "x"),
            ("imag", "x"), ("signbit", "x"), ("isnan", "nans"),
            ("isinf", "nans"), ("isfinite", "nans"),
            ("nan_to_num", "nans"), ("stanh", "x"), ("logit", "p01")):
        add("elementwise", name, lambda P, F, a, n=name: getattr(P, n)(a),
            dom)
    for name, fn, ins in (
            ("add_scalar", lambda P, F, a: P.add(a, 1.5), ("x",)),
            ("logspace", lambda P, F: P.logspace(0, 2, OPS_N), ()),
            ("add_int32_float", lambda P, F, a: P.add(a, 1.5), ("i32",)),
            ("pow_scalar", lambda P, F, a: P.pow(a, 3), ("x",)),
            ("divide_int", lambda P, F, a, b: P.divide(a, b),
             ("i64", "ipos")),
            ("clip", lambda P, F, a: P.clip(a, -0.5, 0.5), ("x",)),
            ("scale", lambda P, F, a: P.scale(a, 2.0, 1.0), ("x",)),
            ("lerp", lambda P, F, a, b: P.lerp(a, b, 0.3), ("x", "y")),
            ("add_n", lambda P, F, a, b, c: P.add_n([a, b, c]),
             ("x", "y", "pos")),
            ("increment", lambda P, F, a: P.increment(P.clone(a), 2.5),
             ("x",)),
            ("ldexp", lambda P, F, a, e: P.ldexp(a, P.remainder(e, 8)),
             ("x", "i64")),
            ("outer", lambda P, F, a, b: P.outer(a, b), ("vec", "vec2")),
            ("kron", lambda P, F, a, b: P.kron(a, b), ("small", "small2")),
            ("frexp", lambda P, F, a: P.frexp(a), ("x",)),
            ("vander", lambda P, F, a: P.vander(P.clip(a, -1.0, 1.0), 64),
             ("vec",)),
            ("polar", lambda P, F, a, b: P.polar(a, b), ("pos", "x")),
            ("renorm", lambda P, F, a: P.renorm(a, 2.0, 0, 10.0), ("x",)),
            ("diff", lambda P, F, a: P.diff(a, 2), ("x",)),
            ("trapezoid", lambda P, F, a: P.trapezoid(a), ("pos",)),
            ("cumulative_trapezoid", lambda P, F, a: P.cumulative_trapezoid(
                a), ("pos",)),
            ("interp", lambda P, F, a, xp, fp: P.interp(a, xp, fp),
             ("x", "seq", "vec"))):
        add("elementwise", name, fn, *ins)
    for name, dom in (("erfinv", "unit"), ("lgamma", "pos"),
                      ("digamma", "pos"), ("i0", "x"), ("i0e", "x"),
                      ("i1", "x"), ("i1e", "x")):
        add("special", name, lambda P, F, a, n=name: getattr(P, n)(a), dom)
    add("special", "polygamma", lambda P, F, a: P.polygamma(a, 1), "pos")
    add("special", "igamma", lambda P, F, a, b: P.igamma(a, b), "pos",
        "pos2")
    add("special", "igammac", lambda P, F, a, b: P.igammac(a, b), "pos",
        "pos2")
    # integer
    for name in ("add", "subtract", "multiply", "floor_divide", "remainder",
                 "maximum", "minimum", "gcd", "lcm", "pow"):
        add("integer", f"{name}_int", lambda P, F, a, b, n=name: getattr(
            P, n)(a, P.remainder(b, 5) if n == "pow" else b), "i64", "ipos")
    for name, fn, ins in (
            ("add_int32", lambda P, F, a, b: P.add(a, b), ("i32", "i32")),
            ("abs_int", lambda P, F, a: P.abs(a), ("i64",)),
            ("square_int", lambda P, F, a: P.square(a), ("i32",)),
            ("cumsum_int", lambda P, F, a: P.cumsum(a, 1), ("i32",)),
            ("cumprod_int", lambda P, F, a: P.cumprod(P.remainder(
                a, 3), 1), ("i64",)),
            ("sum_int", lambda P, F, a: P.sum(a, axis=0), ("i32",)),
            ("matmul_int", lambda P, F, a, b: P.matmul(a, b),
             ("i64", "i64b")),
            ("matmul_int32", lambda P, F, a, b: P.matmul(a, b),
             ("i32", "i32")),
            ("matmul_bool", lambda P, F, a, b: P.matmul(a, b), ("b", "b2")),
            ("multi_dot_int", lambda P, F, a, b: P.linalg.multi_dot(
                [P.slice(a, [0], [0], [64]), b, P.slice(a, [1], [0], [64])]),
             ("i64", "i64b"))):
        add("integer", name, fn, *ins)
    # reductions (on positive data: no sum cancels)
    for name in ("sum", "mean", "amax", "amin", "max", "min", "nansum",
                 "nanmean", "logsumexp"):
        add("reduction", name, lambda P, F, a, n=name: getattr(P, n)(a),
            "pos")
        add("reduction", f"{name}_axis", lambda P, F, a, n=name: getattr(
            P, n)(a, axis=1), "pos")
    for name, fn, ins in (
            ("prod", lambda P, F, a: P.prod(a, axis=1), ("near1",)),
            ("std", lambda P, F, a: P.std(a), ("x",)),
            ("var", lambda P, F, a: P.var(a, 0, unbiased=False), ("x",)),
            ("cumsum", lambda P, F, a: P.cumsum(a, 1), ("pos",)),
            ("cumprod", lambda P, F, a: P.cumprod(a, dim=1), ("near1",)),
            ("logcumsumexp", lambda P, F, a: P.logcumsumexp(a, axis=1),
             ("x",)),
            ("trace", lambda P, F, a: P.trace(a), ("pos",)),
            ("median", lambda P, F, a: P.median(a, axis=1), ("x",)),
            ("median_all", lambda P, F, a: P.median(a), ("x",)),
            ("nanmedian", lambda P, F, a: P.nanmedian(a, 1), ("nans",)),
            ("quantile", lambda P, F, a: P.quantile(a, [0.1, 0.5, 0.9],
                                                    axis=0), ("x",)),
            ("nanquantile", lambda P, F, a: P.nanquantile(a, 0.3, axis=1),
             ("nans",)),
            ("count_nonzero", lambda P, F, a: P.count_nonzero(a, 1),
             ("i64",)),
            ("numel", lambda P, F, a: P.numel(a), ("x",)),
            ("all", lambda P, F, a: P.all(a, axis=1), ("b",)),
            ("any", lambda P, F, a: P.any(a), ("b",)),
            ("sum_bool", lambda P, F, a: P.sum(a), ("b",)),
            ("mean_int32", lambda P, F, a: P.mean(P.abs(a)), ("i32",)),
            ("argmax", lambda P, F, a: P.argmax(a, 1), ("ties",)),
            ("argmin", lambda P, F, a: P.argmin(a), ("ties",)),
            ("cummax", lambda P, F, a: P.cummax(a, 1), ("ties",)),
            ("cummin", lambda P, F, a: P.cummin(a, 0), ("ties",))):
        add("reduction", name, fn, *ins)
    # logic
    for name in ("equal", "not_equal", "less_than", "less_equal",
                 "greater_than", "greater_equal", "bitwise_and",
                 "bitwise_or", "bitwise_xor", "logical_and", "logical_or",
                 "logical_xor"):
        add("logic", name, lambda P, F, a, b, n=name: getattr(P, n)(a, b),
            "i64", "i64b")
    for name, fn, ins in (
            ("less_than_float", lambda P, F, a, b: P.less_than(a, b),
             ("x", "y")),
            ("logical_not", lambda P, F, a: P.logical_not(a), ("b",)),
            ("bitwise_not", lambda P, F, a: P.bitwise_not(a), ("i32",)),
            ("equal_all", lambda P, F, a: P.equal_all(a, P.clone(a)),
             ("x",)),
            ("allclose", lambda P, F, a, b: P.allclose(a, b), ("x", "y")),
            ("isclose", lambda P, F, a, b: P.isclose(a, b, rtol=0.5),
             ("x", "y")),
            ("is_empty", lambda P, F, a: P.is_empty(a), ("x",)),
            ("is_tensor", lambda P, F, a: P.is_tensor(a), ("x",)),
            ("is_complex", lambda P, F, a: P.is_complex(a), ("x",)),
            ("is_floating_point", lambda P, F, a: P.is_floating_point(a),
             ("x",)),
            ("is_integer", lambda P, F, a: P.is_integer(a), ("i32",))):
        add("logic", name, fn, *ins)
    # shape
    for name, fn, ins in (
            ("reshape", lambda P, F, a: P.reshape(a, [256, -1]), ("x",)),
            ("reshape_", lambda P, F, a: P.reshape_(P.clone(a), [-1]),
             ("x",)),
            ("flatten", lambda P, F, a: P.flatten(a, 1), ("x3",)),
            ("squeeze", lambda P, F, a: P.squeeze(P.unsqueeze(a, 1)),
             ("x",)),
            ("unsqueeze", lambda P, F, a: P.unsqueeze(a, [0, 2]), ("x",)),
            ("transpose", lambda P, F, a: P.transpose(a, [2, 0, 1]),
             ("x3",)),
            ("t", lambda P, F, a: P.t(a), ("x",)),
            ("transpose_", lambda P, F, a: P.transpose_(P.clone(a),
                                                        [1, 0]), ("x",)),
            ("moveaxis", lambda P, F, a: P.moveaxis(a, 0, -1), ("x3",)),
            ("swapaxes", lambda P, F, a: P.swapaxes(a, 0, 2), ("x3",)),
            ("concat", lambda P, F, a, b: P.concat([a, b], axis=1),
             ("x", "i64")),
            ("stack", lambda P, F, a, b: P.stack([a, b], 1), ("x", "y")),
            ("split", lambda P, F, a: P.split(a, [100, -1, 24], axis=1),
             ("x",)),
            ("chunk", lambda P, F, a: P.chunk(a, 4), ("x",)),
            ("unbind", lambda P, F, a: P.unbind(a, 0)[::97], ("small",)),
            ("unstack", lambda P, F, a: P.unstack(a), ("small",)),
            ("tile", lambda P, F, a: P.tile(a, [2, 1]), ("x",)),
            ("expand", lambda P, F, a: P.expand(P.unsqueeze(a, 0),
                                                [4, -1]), ("vec",)),
            ("expand_as", lambda P, F, a, b: P.expand_as(a, b),
             ("vec", "x")),
            ("broadcast_to", lambda P, F, a: P.broadcast_to(a, [OPS_N,
                                                                OPS_N]),
             ("vec",)),
            ("broadcast_tensors", lambda P, F, a, b: P.broadcast_tensors(
                [a, P.unsqueeze(b, 1)]), ("vec", "vec2")),
            ("flip", lambda P, F, a: P.flip(a, [0, 1]), ("x",)),
            ("rot90", lambda P, F, a: P.rot90(a), ("x",)),
            ("roll", lambda P, F, a: P.roll(a, [3, -5], [0, 1]), ("x",)),
            ("reverse", lambda P, F, a: P.reverse(a, 0), ("x",)),
            ("vsplit", lambda P, F, a: P.vsplit(a, 4), ("x",)),
            ("crop", lambda P, F, a: P.crop(a, [512, -1], [3, 5]), ("x",)),
            ("slice", lambda P, F, a: P.slice(a, [0, 1], [1, -300],
                                              [900, -2]), ("x",)),
            ("strided_slice", lambda P, F, a: P.strided_slice(
                a, [0, 1], [0, 1000], [OPS_N, 0], [3, -7]), ("x",)),
            ("pad", lambda P, F, a: P.pad(a, [1, 2, 3, 4]), ("x",)),
            ("pad_reflect", lambda P, F, a: P.pad(
                P.reshape(a, [1, 1, OPS_N, OPS_N]), [2, 1, 1, 2],
                mode="reflect"), ("x",)),
            ("pad_circular", lambda P, F, a: P.pad(
                P.reshape(a, [1, 1, OPS_N, OPS_N]), [2, 1, 1, 2],
                mode="circular"), ("x",)),
            ("repeat_interleave", lambda P, F, a: P.repeat_interleave(
                a, 2, 1), ("small",)),
            ("one_hot", lambda P, F, a: P.one_hot(a, 64), ("ids",)),
            ("multiplex", lambda P, F, a, b, i: P.multiplex(
                [a, b], P.remainder(i, 2)), ("x", "y", "perm")),
            ("cartesian_prod", lambda P, F, a, b: P.cartesian_prod([a, b]),
             ("vec", "vec2")),
            ("combinations", lambda P, F, a: P.combinations(a), ("vec",)),
            ("array_ops", lambda P, F, a: P.array_read(P.array_write(
                a, 2), 2), ("x",))):
        add("manipulation", name, fn, *ins)
    # index
    for name, fn, ins in (
            ("gather", lambda P, F, a, i: P.gather(a, i), ("x", "idx")),
            ("gather_axis1", lambda P, F, a, i: P.gather(a, i, axis=1),
             ("i64", "idx")),
            ("gather_nd", lambda P, F, a, i: P.gather_nd(
                a, P.stack([P.remainder(i, OPS_N), i], 1)), ("x", "idx")),
            ("take_along_axis", lambda P, F, a, i: P.take_along_axis(
                a, P.argsort(i), 1), ("x", "i64")),
            ("put_along_axis", lambda P, F, a, i: P.put_along_axis(
                a, P.unsqueeze(P.remainder(i, OPS_N), 1), 2.0, 1,
                reduce="add"), ("x", "perm")),
            ("index_select", lambda P, F, a, i: P.index_select(a, i, 1),
             ("x", "idx")),
            ("index_sample", lambda P, F, a, i: P.index_sample(
                a, P.remainder(i, OPS_N)), ("x", "ipos")),
            ("index_add", lambda P, F, a, i, v: P.index_add(a, i, 0, v),
             ("i64", "perm", "i64b")),
            ("scatter", lambda P, F, a, i, v: P.scatter(a, i, v),
             ("x", "perm", "y")),
            ("scatter_nd_add", lambda P, F, a, i, v: P.scatter_nd_add(
                a, P.unsqueeze(i, 1), v), ("i64", "perm", "i64b")),
            ("scatter_nd", lambda P, F, i, v: P.scatter_nd(
                P.unsqueeze(i, 1), v, [OPS_N, OPS_N]), ("perm", "y")),
            ("where", lambda P, F, c, a, b: P.where(c, a, b),
             ("b", "x", "i64")),
            ("masked_fill", lambda P, F, a, m: P.masked_fill(a, m, 7.5),
             ("x", "b")),
            ("nonzero", lambda P, F, a: P.nonzero(a), ("b",)),
            ("masked_select", lambda P, F, a, m: P.masked_select(a, m),
             ("x", "b")),
            ("take", lambda P, F, a, i: P.take(a, i, mode="wrap"),
             ("x", "i64")),
            ("getitem", lambda P, F, a, i: P.getitem(a, i), ("x", "perm")),
            ("shard_index", lambda P, F, a: P.shard_index(
                P.abs(a), 64, 4, 1), ("i64",)),
            ("searchsorted", lambda P, F, s, v: P.searchsorted(s, v),
             ("seq", "x")),
            ("bucketize", lambda P, F, v, s: P.bucketize(v, s, right=True),
             ("x", "seq"))):
        add("index", name, fn, *ins)
    # sort and search (ties: integer-valued floats)
    for name, fn, ins in (
            ("sort", lambda P, F, a: P.sort(a, 1), ("ties",)),
            ("sort_desc", lambda P, F, a: P.sort(a, 0, descending=True),
             ("x",)),
            ("argsort", lambda P, F, a: P.argsort(a), ("ties",)),
            ("argsort_desc", lambda P, F, a: P.argsort(a, 0, True),
             ("ties",)),
            ("topk", lambda P, F, a: P.topk(a, 5), ("ties",)),
            ("topk_smallest", lambda P, F, a: P.topk(a, 7, 0, False),
             ("ties",)),
            ("kthvalue", lambda P, F, a: P.kthvalue(a, 9), ("ties",)),
            ("mode", lambda P, F, a: P.mode(a), ("ties",)),
            ("unique", lambda P, F, a: P.unique(
                a, return_index=True, return_inverse=True,
                return_counts=True), ("i64",)),
            ("unique_consecutive", lambda P, F, a: P.unique_consecutive(
                P.flatten(P.sort(a, 1)), return_inverse=True,
                return_counts=True), ("ties",)),
            ("histogram", lambda P, F, a: P.histogram(a, 100, -2, 2),
             ("x",)),
            ("histogramdd", lambda P, F, a: P.histogramdd(a, bins=16),
             ("pts",)),
            ("bincount", lambda P, F, a: P.bincount(a), ("ids",))):
        add("sort", name, fn, *ins)
    # linear algebra (errors relative to the output's largest entry)
    for name, fn, ins in (
            ("matmul", lambda P, F, a, b: P.matmul(a, b), ("x", "y")),
            ("matmul_t", lambda P, F, a, b: P.matmul(
                a, b, transpose_x=True, transpose_y=True), ("x", "y")),
            ("mm", lambda P, F, a, b: P.mm(a, b), ("x", "y")),
            ("bmm", lambda P, F, a: P.bmm(a, P.transpose(a, [0, 2, 1])),
             ("x3",)),
            ("inner", lambda P, F, a, b: P.inner(a, b), ("x", "y")),
            ("tensordot", lambda P, F, a, b: P.tensordot(a, b, 1),
             ("x", "y")),
            ("dot", lambda P, F, a, b: P.dot(a, b), ("x", "y")),
            ("mv", lambda P, F, a, v: P.mv(a, v), ("x", "vec")),
            ("addmm", lambda P, F, a, b: P.addmm(a, a, b, 0.5, 2.0),
             ("x", "y")),
            ("einsum", lambda P, F, a, b: P.einsum("bij,jk->bik", a, b),
             ("x3", "x3_w")),
            ("multi_dot", lambda P, F, a, b, c: P.linalg.multi_dot(
                [a, b, c]), ("x", "y", "pos")),
            ("matrix_power", lambda P, F, a: P.linalg.matrix_power(
                P.divide(a, 32.0), 3), ("x",)),
            ("norm", lambda P, F, a: P.linalg.norm(a), ("x",)),
            ("norm_p1_axis", lambda P, F, a: P.norm(a, 1, axis=1), ("x",)),
            ("norm_inf", lambda P, F, a: P.norm(a, float("inf"), 0),
             ("x",)),
            ("norm_matrix", lambda P, F, a: P.norm(a, axis=[1, 2]),
             ("x3",)),
            ("dist", lambda P, F, a, b: P.dist(a, b), ("x", "y")),
            ("cross", lambda P, F, a, b: P.cross(a, b, axis=1),
             ("v3", "w3")),
            ("cov", lambda P, F, a: P.cov(P.slice(a, [0], [0], [64])),
             ("x",)),
            ("corrcoef", lambda P, F, a: P.corrcoef(P.slice(
                a, [0], [0], [64])), ("x",)),
            ("cos_sim", lambda P, F, a, b: P.cos_sim(a, b), ("x", "y"))):
        add("linalg", name, fn, *ins)
    # nn.functional
    for name in ("relu", "relu6", "sigmoid", "tanh", "silu", "swish",
                 "log_sigmoid", "mish", "softsign", "tanhshrink",
                 "hardswish", "hardsigmoid", "gelu", "leaky_relu", "elu",
                 "celu", "selu", "hardtanh", "hardshrink", "softshrink",
                 "softplus", "thresholded_relu"):
        add("activation", f"F.{name}", lambda P, F, a, n=name: getattr(
            F, n)(a), "x")
    for name, fn, ins in (
            ("F.gelu_tanh", lambda P, F, a: F.gelu(a, approximate=True),
             ("x",)),
            ("F.softmax", lambda P, F, a: F.softmax(a), ("x",)),
            ("F.log_softmax", lambda P, F, a: F.log_softmax(a, 0), ("x",)),
            ("F.prelu", lambda P, F, a, w: F.prelu(a, P.abs(P.slice(
                w, [0], [0], [1]))), ("x", "vec")),
            ("F.glu", lambda P, F, a: F.glu(a), ("x",)),
            ("F.maxout", lambda P, F, a: F.maxout(a, 4, 1), ("x3",)),
            ("F.normalize", lambda P, F, a: F.normalize(a), ("x",)),
            ("F.label_smooth", lambda P, F, a: F.label_smooth(a), ("p01",)),
            ("F.one_hot", lambda P, F, a: F.one_hot(a, 64), ("ids",)),
            ("F.sequence_mask", lambda P, F, a: F.sequence_mask(
                P.remainder(a, 200), 256), ("idx",)),
            ("F.pad", lambda P, F, a: F.pad(a, [2, 2]), ("x",))):
        add("activation", name, fn, *ins)
    return t


# element-wise ops also swept in bfloat16: one bf16 unit in the last place
OPS_BF16 = ("add", "subtract", "multiply", "divide", "maximum", "exp",
            "log", "sqrt", "rsqrt", "sin", "tanh", "sigmoid", "erf",
            "floor", "abs", "square", "reciprocal", "sum_axis", "mean_axis",
            "amax_axis", "F.gelu", "F.silu", "F.softmax")


def _leaves(v):
    if isinstance(v, (list, tuple)):
        return [x for e in v for x in _leaves(e)]
    return [v]


def ops_compare(family, name, got, want, on_card):
    """Worst error of `got` (the card's) against `want` (the CPU's) under
    the family's rule; fails on a device, dtype, shape or value
    departure."""
    import torch

    g_leaves, w_leaves = _leaves(got), _leaves(want)
    check(len(g_leaves) == len(w_leaves), f"ops {name}: output count")
    worst = 0.0
    for g, w in zip(g_leaves, w_leaves):
        if not isinstance(w, torch.Tensor):
            check(g == w, f"ops {name}: {g!r} against the CPU's {w!r}")
            continue
        check(isinstance(g, torch.Tensor) and g.device.type == on_card,
              f"ops {name}: an output is on {getattr(g, 'device', None)}, "
              f"not the card")
        check(g.dtype == w.dtype, f"ops {name}: dtype {g.dtype} against "
                                  f"the CPU's {w.dtype}")
        check(tuple(g.shape) == tuple(w.shape), f"ops {name}: shape "
              f"{tuple(g.shape)} against the CPU's {tuple(w.shape)}")
        g = g.detach().cpu()
        w = w.detach()
        if g.is_complex():
            g, w = torch.view_as_real(g), torch.view_as_real(w)
        exact = family in ("creation", "integer", "logic", "manipulation",
                           "index", "sort", "random") or not (
            w.is_floating_point())
        if exact:
            same = torch.equal(g, w) or bool(
                ((g == w) | (torch.isnan(g) & torch.isnan(w))).all())
            check(same, f"ops {name}: not bitwise the CPU's "
                        f"({int((g != w).sum())} of {w.numel()} differ)")
            continue
        g64, w64 = g.double(), w.double()
        fin = torch.isfinite(w64)
        check(torch.equal(torch.isfinite(g64), fin) and torch.equal(
            torch.nan_to_num(g64[~fin]), torch.nan_to_num(w64[~fin])),
            f"ops {name}: non-finite entries differ")
        if not bool(fin.any()):
            continue
        g64, w64 = g64[fin], w64[fin]
        top = float(w64.abs().max())
        scale = torch.full_like(w64, top) if family == "linalg" \
            or name in OPS_SCALE_ROWS else \
            torch.clamp(w64.abs(), min=1e-3 * top)
        err = float(((g64 - w64).abs() / scale.clamp(min=1e-300)).max())
        worst = max(worst, err)
    return worst


def ops_sweep():
    """(a): every op of the table on the card against the CPU."""
    import torch

    import paddle_tpu_torch as P
    import paddle_tpu_torch.nn.functional as F

    t0 = time.perf_counter()
    host = ops_inputs(SEED)
    cpu = {k: torch.from_numpy(v) for k, v in host.items()}
    card = {k: v.cuda() for k, v in cpu.items()}
    worst, own, swept = {}, {}, 0

    def run(fn, ins, place, seed):
        P.set_device(place)
        P.seed(seed)
        return fn(P, F, *ins)

    failures = []
    rows = [(fam, name, fn, names, None) for fam, name, fn, names
            in ops_table()]
    rows += [("bf16", f"{name}@bf16", fn, names, torch.bfloat16)
             for fam, name, fn, names in ops_table()
             if name in OPS_BF16]
    try:
        for i, (family, name, fn, names, dtype) in enumerate(rows):
            def ins(side):
                return [side[n].to(dtype) if dtype is not None
                        and side[n].is_floating_point() else side[n]
                        for n in names]
            got = run(fn, ins(card), "gpu:0", SEED + i)
            want = run(fn, ins(cpu), "cpu", SEED + i)
            limit = OPS_ROW_LIMITS.get(name, OPS_LIMITS[family])
            # every row runs; the failures are listed together at the end
            try:
                err = ops_compare(family, name, got, want, "cuda")
                check(err <= limit, f"ops {name}: {err:.3e} over "
                                    f"{limit:.1e}")
            except SmokeFailure as e:
                failures.append(str(e))
                log(f"FAILED {e}")
                err = float("nan")
            if name in OPS_ROW_LIMITS:
                own[name] = {"err": err, "limit": limit}
            else:
                worst[family] = max(worst.get(family, 0.0), err)
            swept += 1
            del got, want
    finally:
        P.set_device("gpu:0")
    torch.cuda.synchronize()
    check(not failures, f"ops sweep: {len(failures)} of {swept} calls "
                        f"failed: {failures}")
    line = {"swept": swept, "bf16_rows": len(rows) - len(ops_table()),
            "families": {f: {"worst": worst[f], "limit": OPS_LIMITS[f]}
                         for f in sorted(worst)},
            "rows": own,
            "seconds": round(time.perf_counter() - t0, 1)}
    log(f"ops sweep: {swept} op calls ({line['bf16_rows']} of them in "
        f"bfloat16) in {line['seconds']} s; worst by family "
        f"{line['families']}; rows with their own limit {own}")
    return line


# (b) a gpt3-medium training step written in op calls, against the module
OPS_STEP_BATCH, OPS_STEP_LEN = 8, 1024
OPS_STEP_LOSS_RTOL = 2e-3
OPS_STEP_GRAD_RTOL = 2e-2


def op_program_loss(P, F, params, ids, labels, cfg):
    """gpt3-medium's forward and loss in the port's public op calls only,
    on `params` named as GPTForCausalLM's state_dict."""
    b, l = ids.shape
    hid, heads = cfg.hidden_size, cfg.num_heads
    d = hid // heads
    x = P.add(F.embedding(ids, params["gpt.wte.weight"]),
              F.embedding(P.arange(l), params["gpt.wpe.weight"]))
    for i in range(cfg.num_layers):
        p = f"gpt.blocks.{i}."
        h = F.layer_norm(x, [hid], params[p + "ln1.weight"],
                         params[p + "ln1.bias"], cfg.layer_norm_eps)
        qkv = P.add(P.matmul(h, params[p + "attn.qkv_proj.weight"],
                             transpose_y=True),
                    params[p + "attn.qkv_proj.bias"])
        q, k, v = P.split(P.reshape(qkv, [b, l, 3, heads, d]), 3, axis=2)
        q, k, v = (P.reshape(t, [b, l, heads, d]) for t in (q, k, v))
        a = P.reshape(F.scaled_dot_product_attention(q, k, v,
                                                     is_causal=True),
                      [b, l, hid])
        out_w = P.transpose(params[p + "attn.out_proj.weight"], [1, 0])
        x = P.add(x, P.add(P.matmul(a, out_w),
                           params[p + "attn.out_proj.bias"]))
        h = F.layer_norm(x, [hid], params[p + "ln2.weight"],
                         params[p + "ln2.bias"], cfg.layer_norm_eps)
        h = F.gelu(P.add(P.matmul(h, params[p + "mlp.fc1.weight"],
                                  transpose_y=True),
                         params[p + "mlp.fc1.bias"]), approximate=True)
        x = P.add(x, P.add(P.matmul(h, params[p + "mlp.fc2.weight"],
                                    transpose_y=True),
                           params[p + "mlp.fc2.bias"]))
    h = F.layer_norm(x, [hid], params["gpt.ln_f.weight"],
                     params["gpt.ln_f.bias"], cfg.layer_norm_eps)
    logits = P.matmul(h, params["gpt.wte.weight"], transpose_y=True)
    return P.mean(F.cross_entropy(P.cast(logits, "float32"), labels,
                                  reduction="none"))


def paired_step_ms(steps, warmup=2, reps=5):
    """Each of `steps` timed in turns (one step of each per round, so the
    card's and the host's drift falls on all alike): `reps` readings a
    step of CUDA events around it, after `warmup` steps of each."""
    import torch

    for step in steps:
        for _ in range(warmup):
            step()
    times = [[] for _ in steps]
    for _ in range(reps):
        for step, got in zip(steps, times):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            step()
            e.record()
            e.synchronize()
            got.append(s.elapsed_time(e))
    return times


def op_program_phase(card):
    """(b): gpt3-medium (24 blocks, hidden 1024, 16 heads, vocab 50304) in
    bf16 at batch 8 x 1024: the op-call program's loss and gradients
    against the module's on the same weights and batch, its flash
    launches, and both steps' times."""
    import numpy as np
    import torch

    import paddle_tpu_torch as P
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.models import PRESETS, GPTForCausalLM
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = PRESETS["gpt3-medium"]
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(SEED)).to(torch.bfloat16)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in model.state_dict().items()}
    rng = np.random.RandomState(SEED + 21)
    ids = P.to_tensor(rng.randint(0, cfg.vocab_size, (
        OPS_STEP_BATCH, OPS_STEP_LEN)).astype(np.int64))
    labels = P.to_tensor(rng.randint(0, cfg.vocab_size, (
        OPS_STEP_BATCH, OPS_STEP_LEN)).astype(np.int64))

    def program_step():
        for t in params.values():
            t.grad = None
        loss = op_program_loss(P, F, params, ids, labels, cfg)
        loss.backward()
        return loss.detach()

    def module_step():
        model.zero_grad(set_to_none=True)
        loss = F.cross_entropy(P.cast(model(ids), "float32"), labels)
        loss.backward()
        return loss.detach()

    m_loss = float(module_step())
    p_loss = float(program_step())     # also the first warm-up
    fa.reset_launch_counts()
    p_loss = float(program_step())
    torch.cuda.synchronize()
    counts = dict(fa.LAUNCHES)
    instances = dict(fa.INSTANCE_LAUNCHES)
    layers = cfg.num_layers
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        check(counts[name] == layers, f"ops step: {name} launched "
                                      f"{counts[name]} times, not {layers}")
    others = {n: c for n, c in counts.items()
              if c and n not in ("flash_fwd", "flash_dq", "flash_dkv")}
    check(not others, f"ops step: other flash kernels launched {others}")
    check(len(instances) == 3 and all(c == layers
                                      for c in instances.values()),
          f"ops step: flash instances {instances}")
    loss_rel = abs(p_loss - m_loss) / abs(m_loss)
    check(loss_rel <= OPS_STEP_LOSS_RTOL,
          f"ops step: loss {p_loss} against the module's {m_loss} "
          f"({loss_rel:.2e} relative)")
    mod_params = dict(model.named_parameters())
    grad_rel = {}
    for name, t in params.items():
        ref_g = mod_params[name].grad.float()
        got = t.grad.float()
        grad_rel[name] = float((got - ref_g).norm() / ref_g.norm().clamp(
            min=1e-30))
    worst_name = max(grad_rel, key=grad_rel.get)
    check(grad_rel[worst_name] <= OPS_STEP_GRAD_RTOL,
          f"ops step: gradient of {worst_name} {grad_rel[worst_name]:.3e} "
          f"relative to the module's")
    program_reads, module_reads = paired_step_ms([program_step,
                                                  module_step])
    program_ms = statistics.median(program_reads)
    module_ms = statistics.median(module_reads)
    line = {"model": "gpt3-medium", "batch": [OPS_STEP_BATCH, OPS_STEP_LEN],
            "dtype": "bfloat16", "loss": p_loss, "module_loss": m_loss,
            "loss_rel": loss_rel, "loss_limit": OPS_STEP_LOSS_RTOL,
            "worst_grad_rel": grad_rel[worst_name],
            "worst_grad": worst_name, "grad_limit": OPS_STEP_GRAD_RTOL,
            "launches": {n: counts[n] for n in ("flash_fwd", "flash_dq",
                                                "flash_dkv")},
            "instances": instances, "program_step_ms": program_ms,
            "module_step_ms": module_ms,
            "program_step_reads_ms": [round(t, 2) for t in program_reads],
            "module_step_reads_ms": [round(t, 2) for t in module_reads],
            "card": card,
            "seconds": round(time.perf_counter() - t0, 1)}
    log(f"ops step on {card}: op program {program_ms:.1f} ms, module "
        f"{module_ms:.1f} ms a step (medians of 5, timed in turns: "
        f"{program_reads}, {module_reads}); loss {p_loss:.6f} "
        f"against {m_loss:.6f} ({loss_rel:.2e}); worst gradient "
        f"{grad_rel[worst_name]:.2e} ({worst_name}); launches {counts}")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return line


def ops_phase(card):
    """The op surface on the card: (a) the sweep, (b) the op program; (b)
    runs after a failed (a) too, and then the phase fails."""
    t0 = time.perf_counter()
    try:
        sweep = ops_sweep()
    except SmokeFailure as e:
        op_program_phase(card)
        raise e
    line = {"sweep": sweep, "step": op_program_phase(card)}
    line["seconds"] = round(time.perf_counter() - t0, 1)
    return line


def ops_only():
    """The kernels' build and the ops phase alone: prints the card and
    the `ops` line, not the {"ok": ...} line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}")
    build_kernels()
    line = ops_phase(card)
    print(card)
    print(json.dumps({"ops": line}), flush=True)
    return 0


def profile_step(step, ids, labels, step_s, vocab, top):
    """One more train step under torch.profiler: the device time of each
    kernel, summed by name; that of the LM-head CE's GEMMs (the aten::mm
    calls with the vocab in a shape); and the device's idle share of an
    unprofiled step (the profiler's own host cost would inflate the
    profiled one)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step(ids, labels)
        torch.cuda.synchronize()
    kernels = sorted(((e.device_time_total, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(k[0] for k in kernels)
    if not busy_us:
        log("profiled step: the profiler recorded no device time")
        return None
    ce = [e for e in prof.key_averages(group_by_input_shape=True)
          if vocab is not None and e.key == "aten::mm"
          and any(vocab in shape for shape in e.input_shapes if shape)]
    ce_us = sum(e.device_time_total for e in ce)
    log(f"profiled step: device busy {busy_us / 1e3:.1f} ms; idle share of "
        f"a {step_s * 1e3:.1f} ms step {1 - busy_us / (step_s * 1e6):.3f}; "
        f"LM-head CE GEMMs {ce_us / 1e3:.2f} ms in {sum(e.count for e in ce)}"
        f" calls" + ("" if ce_us else " (not measured: no device time on "
                                       "aten::mm)"))
    for us, n, name in kernels[:top]:
        log(f"  {us / 1e3:8.2f} ms {100 * us / busy_us:5.1f}% x{n:<5d} "
            f"{name[:90]}")
    return {"busy_ms": round(busy_us / 1e3, 3),
            "idle_share": round(1 - busy_us / (step_s * 1e6), 4),
            "top": [{"name": name[:90], "ms": round(us / 1e3, 3),
                     "count": n} for us, n, name in kernels[:top]]}


def mma_instance(mangled):
    """The mma kernel instance a mangled name names, as the kernels' own
    instance names spell it, or None."""
    from paddle_tpu_torch.ops import flash_attention as fa

    m = re.search(r"(flash_(?:fwd|dq|dkv)_mma_kernel)ILi(\d+)ELi(\d+)ELi"
                  r"(\d+)E", mangled)
    return (None if m is None else
            f"{m[1]}<{m[2]}, {fa._FORMS[int(m[3])]}, {fa._MODES[int(m[4])]}>")


def build_kernels():
    """Build the kernels' source (one nvcc) and report ptxas's registers
    and spills for each kernel instance; the tensor-core D = 256 instances
    each on a line of their own, and they must not spill."""
    from paddle_tpu_torch.ops import _build

    t0 = time.time()
    _build.load("flash_attention")
    log(f"kernels built in {time.time() - t0:.1f} s")
    for name, rep in _build.BUILD_LOG.items():
        fns = re.findall(r"Compiling entry function '(\w+)'", rep)
        regs = re.findall(r"Used (\d+) registers", rep)
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                             rep)]
        log(f"{name}.cu: {len(regs)} kernel instances, registers {regs}, "
            f"spill stores {sum(spills)} bytes")
        for fn, s in zip(fns, spills):
            if s:
                log(f"  spills {s} bytes: {fn}")
        for fn, r, s in zip(fns, regs, spills):
            inst = mma_instance(fn)
            if inst in D256_TC_INSTANCES:
                log(f"  {inst}: {r} registers at launch, {s} bytes spill "
                    f"stores")
                check(s == 0, f"{inst} spills {s} bytes")
        for line in rep.splitlines():
            if "warning" in line.lower():
                log(f"  {line.strip()}")
        # ptxas's notes of wgmma products it serialized (each one waited
        # for before the next issues), by instance; none in the tensor-core
        # D = 256 instances
        for fn in sorted(set(re.findall(
                r"Performance Loss: wgmma[^']*'(\w+)'", rep))):
            inst = mma_instance(fn)
            log(f"  wgmma serialized in {inst or fn}")
            check(inst not in D256_TC_INSTANCES,
                  f"ptxas serialized the wgmma products of {inst}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from paddle_tpu_torch.models import PRESETS
    from paddle_tpu_torch.ops import flash_attention as fa

    t_start = time.time()
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    build_kernels()

    probe_row = probe_phase()
    rows = kernel_phase(8, 1024, 16, 64, "bfloat16", True, timed=True)
    # f32 storage at the training shape: the f32 model phase runs these
    f32_rows = kernel_phase(8, 1024, 16, 64, "float32", True, timed=True,
                            time_names=F32_STORAGE_TIMED)
    kernel_phase(8, 1024, 16, 64, "bfloat16", False, timed=False)
    kernel_phase(8, 1024, 8, 128, "bfloat16", True, timed=False)
    kernel_phase(2, 256, 4, 64, "float32", True, timed=False)
    kernel_phase(2, 256, 4, 64, "float32", False, timed=False)
    kernel_phase(2, 512, 8, 128, "float32", True, timed=False)
    # D = 128 on f32 storage at gpt3-xl's attention shape (batch 8 x 1024,
    # 16 heads), the one-consumer kF32 kernels: timed, the forward's and the
    # backward pair's times logged beside SDPA's (no model of this run
    # trains at it, so its rows stay out of the kernels line)
    kernel_phase(8, 1024, 16, 128, "float32", True, timed=True,
                 time_names=F32_STORAGE_TIMED)
    # L = 192, a multiple of 64 but not of 128: the half tiles of the
    # 128-row kernels (forward, dQ, dK/dV); at D = 128 with 160 heads, so
    # that every block of the persistent grids walks several (head, tile)
    # items (on f32 storage, where a D = 128 block has one consumer, its
    # second round of the last tile is empty)
    kernel_phase(2, 192, 4, 64, "bfloat16", True, timed=False)
    kernel_phase(4, 192, 40, 128, "bfloat16", True, timed=False)
    kernel_phase(4, 192, 40, 128, "float32", True, timed=False)
    # head_dims and lengths the kernels take only padded: gpt3-large's 96
    # and gpt3-tiny's 16 (to 128 and 64), and L = 96 (blocks of 32, to 128
    # with the keys past 96 masked)
    padded_phase(2, 256, 8, 96, "bfloat16", True, 64)
    padded_phase(2, 256, 8, 16, "bfloat16", True, 64)
    padded_phase(2, 96, 4, 64, "bfloat16", True, 32)
    padded_phase(2, 96, 4, 64, "bfloat16", False, 32)
    padded_phase(2, 96, 4, 64, "float32", False, 32)
    # head_dim 256 (bf16 storage: the tensor-core forward, dQ and dK/dV of
    # bf16, nn and nn2 and their f32-dot kSplit instances; f32 storage: the
    # tensor-core kF32 forward, dQ and dK/dV): timed at B*H = 64, L = 1024
    # (the D = 256 training phase's shape), causal; at L = 192 causal and
    # not (the forward's half item, three dK/dV items a head); and head_dims
    # 160 and 192 through the padding to 256, at L = 96 too (keys past the
    # true length masked)
    rows256 = kernel_phase(4, 1024, 16, 256, "bfloat16", True, timed=True)
    f32_rows256 = kernel_phase(4, 1024, 16, 256, "float32", True,
                               timed=True, time_names=F32_STORAGE_TIMED)
    for dtype_name in ("bfloat16", "float32"):
        for causal in (True, False):
            kernel_phase(2, 192, 8, 256, dtype_name, causal, timed=False)
    # (each under bf16 and f32 on bf16 storage, and on f32 storage: the
    # tensor-core forward's kBf16, kSplit and kF32 instances)
    for D, L, block, causal in ((160, 256, 64, True), (192, 256, 64, True),
                                (160, 96, 32, True), (160, 256, 64, False)):
        B, H = (2, 8) if L == 256 else (2, 4)
        if causal:
            padded_phase(B, L, H, D, "bfloat16", True, block)
            padded_phase(B, L, H, D, "bfloat16", True, block, impl="f32")
        padded_phase(B, L, H, D, "float32", causal, block)
    # the D = 256 dQ on each side of its item order's switch (all heads'
    # K and V against L2's 50 MB): rank by rank at B*H = 16, L = 2048
    # (32 MB), head by head at B*H = 32 (64 MB); and so the f32-storage
    # forward about its own switch at three L2s (all heads' K and V terms:
    # 96 MB at B*H = 16, L = 2048, rank by rank; 192 MB at 32, head by
    # head); timed and logged, their rows out of the kernels line (no
    # model of this run trains at them)
    for B in (1, 2):
        for dtype_name, names in (("bfloat16", ("flash_dq", "flash_dq_nn")),
                                  ("float32", ("flash_fwd",))):
            rows_l2 = kernel_phase(B, 2048, 16, 256, dtype_name, True,
                                   timed=True, time_names=names)
            for r in rows_l2:
                split = (f" (+ split {r['split_ms']:.4f})"
                         if "split_ms" in r else "")
                log(f"{r['name']} at B*H = {16 * B}, L = 2048: "
                    f"{r['ms']:.4f} ms{split}, bound {r['bound_ms']:.4f} "
                    f"ms, SDPA's "
                    f"{'forward' if 'fwd' in r['name'] else 'backward'} "
                    f"{r['library_ms']:.4f} ms, row err {r['row_err']:.3e}")

    cfg = PRESETS["gpt3-medium"]
    weights = reference_layout_weights(cfg, SEED)
    launches, bf16_loss = {}, None
    for impl, steps in STRATEGY_STEPS.items():
        counts, losses = training_phase(
            impl, impl, weights, cfg, steps,
            plain_tol=LOSS_ATOL if impl == "auto" else None,
            bf16_loss=bf16_loss)
        bf16_loss = losses[0] if impl == "auto" else bf16_loss
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        for r in rows + [probe_row]:
            if counts[r["name"]]:
                r["launches_per_step"] = counts[r["name"]] / steps
    # the same weights in f32, no amp.decorate: every attention runs the
    # f32-storage kernels (auto resolves to bf16, whose kernels on f32
    # storage are the f32-storage forward, dQ and dK/dV)
    counts, _ = training_phase("f32-model", "auto", weights, cfg,
                               F32_MODEL_STEPS, o2=False,
                               plain_tol=LOSS_F32_MODEL_ATOL)
    for r in f32_rows:
        name = r["name"].split("@")[0]
        r["launches"] = counts[name]
        r["launches_per_step"] = counts[name] / F32_MODEL_STEPS
        check(r["launches"] > 0, f"{r['name']} never launched in the f32 "
                                 f"model phase")
    launches["flash_probe"] += counts["flash_probe"]
    # head_dim 96 (gpt3-large, cut to D96_LAYERS layers): padded to 128
    large = PRESETS["gpt3-large"]
    large = type(large)(**{**vars(large), "num_layers": D96_LAYERS})
    counts, _ = training_phase("d96", "auto", reference_layout_weights(
        large, SEED), large, D96_STEPS, plain_tol=LOSS_ATOL)
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    for r in rows + [probe_row]:
        r["launches"] = launches.get(r["name"], 0)
        check(r["launches"] > 0, f"{r['name']} never launched on the "
                                 f"training path")
    # head_dim 256 (gpt3-xl's widths with D256_HEADS heads, cut to
    # D256_LAYERS layers): the D = 256 kernels, under each strategy on bf16
    # storage and in f32; every launch of these phases is one at D = 256
    xl = PRESETS["gpt3-xl"]
    wide = type(xl)(**{**vars(xl), "num_heads": D256_HEADS,
                       "num_layers": D256_LAYERS})
    wide_weights = reference_layout_weights(wide, SEED)
    launches256, f32_counts256, bf16_loss = {}, {}, None
    for impl in STRATEGY_STEPS:
        # each strategy's forward, dQ and dK/dV instances, all three on
        # the tensor cores
        names = fa.STRATEGY_KERNELS["bf16" if impl == "auto" else impl]
        counts, losses = training_phase(
            f"d256-{impl}", impl, wide_weights, wide, D256_STEPS,
            plain_tol=LOSS_ATOL if impl == "auto" else None,
            bf16_loss=bf16_loss,
            instances=tuple(D256_INSTANCES[n] for n in names))
        bf16_loss = losses[0] if impl == "auto" else bf16_loss
        for name, n in counts.items():
            launches256[name] = launches256.get(name, 0) + n
    # the f32 model: auto resolves to bf16, whose kernels on f32 storage
    # are the tensor-core kF32 forward, dQ and dK/dV
    f32_counts256, _ = training_phase(
        "d256-f32-model", "auto", wide_weights, wide, D256_STEPS, o2=False,
        plain_tol=LOSS_F32_MODEL_ATOL,
        instances=tuple(D256_F32_INSTANCES[n]
                        for n in fa.STRATEGY_KERNELS["bf16"]))
    for r in rows256 + f32_rows256:
        name = r["name"].split("@")[0]
        counts = f32_counts256 if "@float32" in r["name"] else launches256
        r["launches"] = counts[name]
        check(r["launches"] > 0, f"{r['name']} never launched in the "
                                 f"head_dim 256 phases")
    # the trainer's phases (dropout, skip-bad steps, recompute, O1,
    # the chunked attention, checkpoints) at gpt3-medium
    trainer = trainer_phases(weights, cfg)
    # greedy serving over the gpt3-medium weights, in f32 (no kernel of
    # this path is a flash kernel: its attention is einsum)
    serving = serving_phase(weights, cfg)
    # the predict path: the same weights saved by jit.save and served by
    # the dynamic-batching engine, each batch through the flash forward
    # (bf16: flash_fwd's row; f32: flash_fwd@float32's)
    predict = predict_phase(weights, cfg)
    for rs, name, label in ((rows, "flash_fwd", "bf16"),
                            (f32_rows, "flash_fwd@float32", "f32")):
        r = next(r for r in rs if r["name"] == name)
        r["predict_launches"] = predict[label]["launches"]["flash_fwd"]
        r["predict_launches_per_batch"] = \
            predict[label]["launches_per_batch"]
    # the serving fabric: a door over host A (this process: the f32
    # generation engine and the bf16 artifact, each /predict batch on A
    # through flash_fwd) and host B (the serve CLI on the same card)
    fabric = fabric_phase(weights, cfg,
                          set(predict["checked_instances"]["bf16"]))
    r = next(r for r in rows if r["name"] == "flash_fwd")
    r["fabric_launches"] = \
        fabric["predict"]["two_hosts"]["launches"]["flash_fwd"]
    r["fabric_launches_per_batch"] = \
        fabric["predict"]["two_hosts"]["launches_per_batch"]
    # BASELINE.md's single-chip rows: BERT-base MLM under bf16 O2 (the
    # non-causal flash kernels inside a model) and ResNet-50 on
    # CIFAR-shaped data
    models, noncausal_rows = models_phase()
    # the training API: ResNet-50 and BERT-base through Model.fit (BERT's
    # steps through the non-causal kernels)
    fit = fit_phase(models)
    for r in noncausal_rows:
        r["fit_launches_per_step"] = \
            fit["bert"]["b"]["launches_per_step"][r["name"].split("@")[0]]
    # the op surface: the sweep of every ported op against the CPU, and a
    # gpt3-medium step written in op calls through the causal kernels
    ops = ops_phase(card)
    for r in rows:
        if r["name"] in ops["step"]["launches"]:
            r["ops_launches_per_step"] = ops["step"]["launches"][r["name"]]
    log(json.dumps({"kernels": rows + f32_rows + rows256 + f32_rows256
                    + noncausal_rows + [probe_row]}))
    log(json.dumps({"serving": serving}))
    log(json.dumps({"trainer": trainer}))
    log(json.dumps({"predict": predict}))
    log(json.dumps({"fabric": fabric}))
    log(json.dumps({"models": models}))
    log(json.dumps({"fit": fit}))
    log(json.dumps({"ops": ops}))
    log(f"chip_smoke took {time.time() - t_start:.0f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def serving_only():
    """The serving phase alone (no kernel build, no training): prints the
    card and the `serving` line, not the {"ok": ...} line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from paddle_tpu_torch.models import PRESETS

    card = card_line()
    log(f"card: {card}")
    cfg = PRESETS["gpt3-medium"]
    line = serving_phase(reference_layout_weights(cfg, SEED), cfg)
    print(card)
    print(json.dumps({"serving": line}), flush=True)
    return 0


def predict_only():
    """The kernels' build and the predict phase alone: prints the card and
    the `predict` line, not the {"ok": ...} line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from paddle_tpu_torch.models import PRESETS

    card = card_line()
    log(f"card: {card}")
    build_kernels()
    cfg = PRESETS["gpt3-medium"]
    line = predict_phase(reference_layout_weights(cfg, SEED), cfg)
    print(card)
    print(json.dumps({"predict": line}), flush=True)
    return 0


def trainer_only():
    """The kernels' build and the trainer's phases alone: prints the card
    and the `trainer` line, not the {"ok": ...} line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from paddle_tpu_torch.models import PRESETS

    card = card_line()
    log(f"card: {card}")
    build_kernels()
    cfg = PRESETS["gpt3-medium"]
    line = trainer_phases(reference_layout_weights(cfg, SEED), cfg)
    print(card)
    print(json.dumps({"trainer": line}), flush=True)
    return 0


def sm_clock_mhz():
    """The card's SM clock now, in MHz (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return int(out.stdout.strip().splitlines()[0])


def time_kernels(root):
    """Time every flash kernel of the checkout at `root` at the training
    shape and at the head_dim-256 phase's, and the D = 256 dQ and the
    f32-storage forward at D = 256 at B*H = 16 and 32, L = 2048 (its
    package imported from there, its kernels built there), each row with
    the SM clock read right after its timing (a tensor-core kernel can
    leave the card clocked down for the next row); print {"root": root,
    "ms": {name: ms}, "clock_mhz": {name: MHz}}."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa

    check(os.path.abspath(fa.__file__).startswith(os.path.abspath(root)),
          f"imported {fa.__file__}, not the package under {root}")
    causal, ms, clock = True, {}, {}
    for B, H, D, L, dt, names, suffix in (
            (8, 16, 64, 1024, torch.bfloat16, ARGS, ""),
            (8, 16, 64, 1024, torch.float32, F32_STORAGE_TIMED, "@float32"),
            (4, 16, 256, 1024, torch.bfloat16, ARGS, "@D256"),
            (4, 16, 256, 1024, torch.float32, F32_STORAGE_TIMED,
             "@float32@D256"),
            # D = 256 dQ on each side of its item order's switch (B*H =
            # 16 and 32 at L = 2048; see main)
            (1, 16, 256, 2048, torch.bfloat16, ("flash_dq",),
             "@D256@16x2048"),
            (2, 16, 256, 2048, torch.bfloat16, ("flash_dq",),
             "@D256@32x2048"),
            # the f32-storage forward at D = 256 on each side of its own
            # switch (B*H = 16 and 32 at L = 2048), with its split
            (1, 16, 256, 2048, torch.float32, ("flash_fwd",),
             "@float32@D256@16x2048"),
            (2, 16, 256, 2048, torch.float32, ("flash_fwd",),
             "@float32@D256@32x2048")):
        sc = 1.0 / math.sqrt(D)
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v, do = (torch.randn(B, L, H, D, device="cuda", dtype=dt,
                                   generator=g) for _ in range(4))
        o, lse = fa.flash_fwd_plain(q, k, v, causal, sc)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        t = {"q": q, "k": k, "v": v, "do": do, "lse": lse, "delta": delta,
             "qt": fa.to_t(q), "kt": fa.to_t(k), "vt": fa.to_t(v),
             "dot": fa.to_t(do)}
        for name in names:
            args = [t[a] for a in ARGS[name]] + [causal, sc]
            ms[name + suffix] = median_ms(lambda: fa.CUDA[name](*args))
            clock[name + suffix] = sm_clock_mhz()
        if suffix in ("@float32", "@float32@D256"):
            # the whole f32-storage backward as a training step calls it
            ms["flash_bwd" + suffix] = median_ms(lambda: fa.flash_bwd(
                q, k, v, do, lse, delta, causal, sc))
            clock["flash_bwd" + suffix] = sm_clock_mhz()
    print(json.dumps({"root": root, "ms": ms, "clock_mhz": clock}),
          flush=True)
    return 0


def compare(other):
    """Each flash kernel of `other` (another checkout) and of this one,
    timed by time_kernels in turns: other, this, this, other."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}")
    runs, clocks = [], []
    for root in (other, ".", ".", other):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time-kernels",
             root], capture_output=True, text=True, timeout=900)
        check(out.returncode == 0, f"timing {root} failed:\n{out.stderr}")
        run = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append(run["ms"])
        clocks.append(run.get("clock_mhz", {}))
        log(f"{root}: {runs[-1]}")
    result = {}
    for name in runs[0]:
        mine, theirs = (runs[1][name], runs[2][name]), (runs[0][name],
                                                         runs[3][name])
        mhz = [c.get(name) for c in clocks]
        result[name] = {"ms": mine, "other_ms": theirs,
                        "ratio": (min(mine) / max(theirs),
                                  max(mine) / min(theirs)),
                        "clock_mhz": mhz[1:3], "other_clock_mhz": mhz[::3]}
        log(f"{name:26s} {mine[0]:.4f} {mine[1]:.4f} ms at {mhz[1]} {mhz[2]} "
            f"MHz against {theirs[0]:.4f} {theirs[1]:.4f} at {mhz[0]} "
            f"{mhz[3]}: x{result[name]['ratio'][0]:.3f}-"
            f"{result[name]['ratio'][1]:.3f}")
    print(card)
    print(json.dumps({"compare": result, "other": other}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--time-kernels"]:
            sys.exit(time_kernels(sys.argv[2]))
        if sys.argv[1:2] == ["--compare"]:
            sys.exit(compare(sys.argv[2]))
        if sys.argv[1:2] == ["--serving"]:
            sys.exit(serving_only())
        if sys.argv[1:2] == ["--trainer"]:
            sys.exit(trainer_only())
        if sys.argv[1:2] == ["--predict"]:
            sys.exit(predict_only())
        if sys.argv[1:2] == ["--fabric"]:
            sys.exit(fabric_only())
        if sys.argv[1:2] == ["--models"]:
            sys.exit(models_only())
        if sys.argv[1:2] == ["--fit"]:
            sys.exit(fit_only())
        if sys.argv[1:2] == ["--ops"]:
            sys.exit(ops_only())
        sys.exit(main())
    except (SmokeFailure, ImportError) as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
