#!/usr/bin/env python
"""On-card smoke test of the PyTorch port (pytorch_distributed_nn_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build   -- nvcc builds the five csrc/*.cu (int8_matmul, flash_attention,
              bn_stats, quantize, ring_attention) for sm_90a, one nvcc each,
              started together; prints seconds and each kernel's
              registers and spilled bytes from the compiler's report.
2. kernel  -- int8_matmul (the W8A16 CUDA kernel) against its plain PyTorch
              version at every (K, N) of the Llama-3-8B path, M in
              {1, 8, 16, 64, 128}; each row alone (M = 1) bit for bit
              against M = 8 and M = 128; times the kernel, the plain
              version, one library call and torch.sum over the weight's
              bytes with CUDA events (L2 flushed before each launch: the
              decode path reads every weight cold).
3. flash   -- the three flash-attention kernels (forward, dq pass, dk/dv
              pass) at the long-context shapes (B 1, H 8, Hkv 4, D 128,
              causal, bf16) against their plain versions: in full at
              T = 4096, on row slices at T = 32768; times each kernel, its
              plain version and F.scaled_dot_product_attention at T = 32768.
4. auto    -- one layer's attention forward + backward, flash against the
              plain path, at T from 128 to 4096: the sweep behind
              nn/attention.py's FLASH_MIN_T.
5. train   -- llama3_longcontext at full width (8 layers, d 1024, vocab
              32000) through Trainer: at T = 4096 one step's loss and every
              gradient with the kernels against the plain attention; then
              the main path, the preset as it is (T = 32768) for 4 steps
              with the flash counts reset just before and read just after
              (16 forward, 8 dq and 8 dk/dv launches a step), finite losses,
              step time, tokens/s, MFU and peak memory; one more step under
              torch.profiler for the device-time breakdown.
6. forward -- the quantized Llama-3-8B at full width (d 4096, vocab
              128256) and 8 of 32 layers (SERVE_LAYERS), seeded synthetic
              int8 weights: one prefill and 4
              teacher-forced decode steps with the kernel (33 launches per
              forward, and 33 w8a16 kernels in a profiled decode step), again with every kernel call held against the plain
              version on its own live activations, and again with the plain
              version swapped in; the logits must agree, and the greedy
              token must agree on every row where the plain top-2 margin is
              decisive.
7. serve   -- the serving path: InferenceServer(ServingEngine(...)) with 8
              slots, on the compute and then the int8 KV cache, answers a
              mix of 14 ragged requests (prompts 16-128 tokens, 32 new
              tokens each): 6 greedy, 4 sampled (temperature 0.8, top_k 50,
              top_p 0.95, fixed seeds), one n-best (n 2, best_of 4) and 3
              streamed; W8A16 counts reset just before and read just after
              (33 a forward at 8 layers); every greedy request's
              next-token logits and tokens must equal a solo generate()'s
              on the same cache bit for bit; the sampled and n-best
              requests again in another batch mix must give the same
              streams (the engine's prefix cache is on, as by default:
              a sampled request again restores its prompt's rows but the
              last two; an n-best request donates nothing); streamed chunks concatenate to the tokens; the
              n-best winner has the highest cumulative log-probability and,
              stepped by hand, its 4 branches hold the prompt's full blocks
              once (refcount 4); the compute run's greedy tokens, fed
              through both caches, give int8 logits within INT8_KV_TOL of
              the compute cache's, an int8 cache with its scales dropped
              or off by one position lies beyond it, and the greedy choices
              agree wherever the compute margin exceeds twice it. Before
              that, sample_rows on the card against the CPU at 8 rows of
              vocab 128256: keys bit for bit, Gumbel noise within
              GUMBEL_TOL, tokens where the perturbed margin exceeds
              SAMPLE_MARGIN, and the sampling's device time a round.

The data-parallel slice (run after phase 3, and after phase 5):

8. bn_stats -- the BatchNorm-statistics kernel at ResNet-50's largest and
              smallest BatchNorm at batch 256 and one ragged M, bf16 and
              f32, kernel and plain version against an f64 sum (1e-5 of
              sum|term| per channel), bitwise repeatable; one training
              step's 53 + 53 calls timed for the kernel, the plain version
              and torch.batch_norm_stats / batch_norm_backward_reduce.
9. quantize -- the stochastic int8 kernel on a 25 MB bucket and on the
              whole ResNet-50 gradient: bit for bit its plain version,
              |q scale - x| < scale, mean error within 4 sigma, saturation;
              one step's buckets timed for the kernel (CUDA events around
              the calls, and the launches' own device time by
              torch.profiler) and the plain version.
10. dp_check -- one full-width ResNet-50 step at batch 256, bn_stats kernel
              against the torch reductions: loss and every gradient.
11. dp_train -- the main path: resnet50_dp with parallel.strategy
              dp_explicit, the int8 wire and bn_impl pallas, batch 256 on
              one card (NCCL, world 1): 2 warm-up and 4 timed steps with the
              counts reset just before and read just after (53 + 53
              bn_stats and one quantize a bucket a step), images/s, MFU,
              peak memory, loader wait, bytes a step on each wire; one step
              under torch.profiler.
12. dp_preset -- resnet50_dp as it is (dp, flax BatchNorm, exact reduce) at
              batch 256, and mlp_mnist as it is for 20 steps.

The sequence-parallel slice (ring attention; phase 13 runs after phase 3,
phase 14 after phase 5's check step, phases 15 and 16 after phase 5):

13. ring      -- the ring block kernel at the long-context shapes (B 1, H 8,
              Hkv 4, D 128, bf16): (a) against its plain version at Tl = 8192
              on a diagonal, a past and a future pair with random incoming
              carries (the future pair's carries bit for bit untouched);
              (b) the 16 (query shard, visiting shard) pairs of a seq = 4
              ring at T = 32768 replayed in ring order through the ring's
              own per-pair steps (parallel/sequence.py: ring_order,
              ring_forward_pair, ring_finish), the assembled output and lse
              against flash_fwd at T = 32768; (c) the same 16 pairs through
              its ring_backward_pair (flash dq and dk/dv with f32 outputs;
              diagonal causal, past dense, future skipped), the summed dq,
              dk, dv against the full-T flash backward; (d) the main path's
              pairs at world 1 against the plain versions: the kernel with
              fresh and with random carries at Tl = 32768 (every row) and
              98304 (the first and last 512 rows), and the pair's f32 dq and
              dk/dv on 512-row slices; (e) times of the kernel at Tl = 32768
              (the world-1 main path's one pair) and at Tl = 8192 (diagonal,
              past), its plain version, its bound and the nearest library
              call (F.scaled_dot_product_attention on the same pair).
14. ring_check -- one full-width llama3_longcontext step at T = 4096 from
              the same weights and batch: attn_impl ring and ulysses against
              flash, loss and every gradient.
15. ring_train -- the main path: llama3_longcontext as it is (T = 32768)
              with model.extra.attn_impl = ring through Trainer on NCCL at
              world 1, 4 steps, the launch counts reset just before and read
              just after (16 ring_block_update, 8 flash_bwd_dq, 8
              flash_bwd_dkv and no flash_fwd a step), one more step under
              torch.profiler; then 2 steps of llama3_longcontext_96k
              (T = 98304) on the same path.
16. ring4     -- only on a machine with 4 or more cards: the train entry
              point under torchrun on 4 ranks with mesh.seq = 4, 2 steps with
              ring and 2 with Ulysses attention, the losses against the
              world-1 run's.

Config 4's transformer LM and config 3's BERT (phase 17 runs after phase
3, phases 18 and 19 after phase 12):

17. flash64 -- the three flash kernels at the transformer LM's shapes (B 64,
              T 1024, H = Hkv = 12, D 64, causal, bf16), every output in
              full against the plain versions; times of each kernel, its
              plain version, its bound and SDPA's forward and backward (the
              kernels line's ``at_d64``).
18. lm_d64  -- transformer_lm_pp with --mesh.pipe 1 --parallel.strategy dp
              at its full width and batch (12 layers, d 768, vocab 32000,
              B 64, T 1024, remat, adam): one step's loss and every gradient
              with the flash kernels against the plain attention; one
              warm-up and 4 timed steps with the flash counts reset just
              before and read just after (24 forward, 12 dq, 12 dk/dv a
              step); tokens/s, MFU, peak memory; one profiled step.
19. bert    -- bert_base_buckets as it is (12 layers, d 768, vocab 30522,
              T 128, batch 256, dp_explicit, 100 MB buckets, overlap) on
              NCCL at world 1: one step with overlap bit for bit the step
              without; 2 warm-up and 4 timed steps, each issuing the plan's
              buckets from the backward; the share of bytes issued before
              the backward's last hook; tokens/s, MFU, peak memory, one
              profiled step and the attention, f32 head and loss parts'
              own times; then 2 steps on the int8 wire with the quantize
              count reset just before and read just after (one launch a
              f32 bucket a step).

The trainer features (run after phase 19):

20. ckpt     -- llama3_longcontext (T 32768) at 1 of its 8 layers: 4
              straight steps
              against 2 steps with an asynchronous save every 2 steps, a
              fresh Trainer that resumes and 2 more steps (losses and
              state within CKPT_TOL, bit for bit expected); the
              checkpoint's bytes, the save's added seconds on its step, the
              drain and restore seconds; the newest step torn (the restore
              falls back to step 2); the train entry point in a subprocess
              with TPUNN_PREEMPT=1 sent SIGTERM: exit 83 and a checkpoint
              that resumes.
21. accum    -- transformer_lm_pp (--mesh.pipe 1 --parallel.strategy dp)
              with grad_accum 4 and label_smoothing 0.1: one step's loss and
              gradients against accum 1 on the same batch, then 3 timed
              steps (flash launches counted), step time and peak memory;
              resnet50_dp (dp, overlap) with bn_impl pallas, batch 256,
              grad_accum 2: bn_stats launched on each microbatch.
22. multistep -- mlp_mnist as it is, multistep_k 20 with fresh batches and
              with multistep_pool 4, and ResNet-50 at batch 256 with k 4 and
              pool 4: the graph's losses bit for bit the eager steps'
              (ResNet-50 under cuDNN's deterministic algorithms), then
              samples/s both ways (the pool: the device alone; ResNet-50
              on a graph captured anew under the default cuDNN setting),
              and bn_stats counted by name in three profiled replays.
23. offload  -- llama3_longcontext_96k, 2 steps with remat_offload against
              2 without: losses bit for bit, peak memory and step time.

The sharded strategies (phase 24 runs after phase 17, phases 25 and 26
after phase 23):

24. flash8b -- the three flash kernels at config 5's attention (B 1,
              T 4096, H 32, Hkv 8: GQA group 4, D 128, causal, bf16), every
              output in full against the plain versions; times of each
              kernel, its plain version, its bound and SDPA's forward and
              backward (the kernels line's ``at_8b``).
25. zero8b  -- config 5 on one card: llama3_8b_zero at full width (d 4096,
              32/8 heads of 128, MLP 14336, vocab 128256, T 4096, xent_chunk
              2048, remat, adamw, clip 1.0, zero_stage 3) cut to 8 layers
              and batch 1, NCCL at world 1 (nothing split, no collective):
              a warm-up and 3 steps with the flash counts reset just before
              and read just after, tokens/s, MFU, peak memory, one profiled
              step; its losses against the dp step's from the same weights.
26. pipe    -- config 4 as the preset sets it (mesh.pipe 4, 8 microbatches,
              B 64, T 1024), every stage in this process: gpipe, 1f1b and
              interleaved (pipe_chunks 3), 3 steps each with the flash
              counts reset just before and read just after (2 L M forward,
              L M dq, L M dk/dv a step); losses against each other and the
              --mesh.pipe 1 --parallel.strategy dp run; peak memory, step
              time, the most microbatches a stage held.

The expert axis (phase 27 runs after phase 26):

27. moe     -- moe_lm_ep at full width (12 layers, d 768, 12 heads of 64,
              8 experts of MLP 3072, top-2, capacity 1.25, routing groups
              of 1024, vocab 32000, B 32, T 1024, no remat, adamw,
              zero_stage 3) on NCCL at world 1, where expert = -1
              resolves to 1 and nothing is split: one step's loss with the
              flash kernels against the plain attention's forward loss
              from the same weights and batch (MOE_LOSS_TOL); a warm-up and
              3 steps with the flash counts reset just before and read just
              after (12 forward, 12 dq, 12 dk/dv a step: no remat) and no
              collective; step time, tokens/s, MFU by the MoE closed form
              (utils/flops.py), peak memory, the routing's fraction of
              (token, choice)s dropped; one profiled step with the flash
              kernels counted by name between the spin kernels, and the
              device time by kernel family (the kernels line's
              ``at_moe``).

Serving a trained checkpoint (phase 28 runs after phase 27):

28. serve_ckpt -- (a) transformer_lm_pp with --mesh.pipe 1
              --parallel.strategy dp at full width and depth (12 layers,
              d 768, vocab 32000) trains 2 steps with a checkpoint; the
              serve entry point (serve/__main__.main) serves it; the
              restored params equal the trained ones bit for bit, the
              engine's greedy tokens equal generate()'s on them, one
              sampled request twice gives one stream. (b) llama3_8b_zero at
              full width, zero_stage 3, cut to 1 of 32 layers, trains 1
              step at batch 1 and saves; served with {"quantized": true,
              "fused_proj": true}, quantized at load: the int8 params equal
              the trained f32 params quantized in memory, the engine's
              greedy tokens equal generate() on those, and W8A16 runs 9
              times a forward (4 a layer plus the head). The flash
              launches of both trainings are counted.

Training from the user's files and the MoE LM under the pipeline (phases
29 and 30 run after phase 28):

29. files    -- a 16M-token uint16 token file (vocab 32000), an MNIST idx
              pair (10k train, 2k t10k rows) and CIFAR-10's data_batch_1.bin
              and test_batch.bin (10k and 2k records) written from a numpy
              seed in a temporary directory; transformer_lm_pp with
              --mesh.pipe 1 --parallel.strategy dp at full width (B 64,
              T 1024, remat) from the token file with holdout_frac 0.05:
              the device batches of two training steps and an evaluation
              step bit for bit the memmap's windows; a warm-up and 3 steps
              with the flash counts reset just before and read just after
              (24 forward, 12 dq, 12 dk/dv a step), one evaluation on the
              held-out tail, one profiled step with the kernels counted by
              name; step time, tokens/s, peak memory and the loader's wait
              against phase 18's synthetic-data step; then mlp_mnist from
              the idx files and lenet_cifar10 from the binaries, 20 steps
              each (the loss falls) and one evaluation on the test split.
              image_folder is not decoded here: its decode is PIL host
              code, held against the JAX reader by the CPU tests.
30. pipe_moe -- moe_lm_ep at full width (12 layers, d 768, 8 experts of
              3072, top-2, B 32, T 1024, no remat) under the pipeline with 8
              microbatches, every stage in this process: 1f1b on mesh.pipe
              4 with moe_every 1, and interleaved on pipe 2 x 3 chunks with
              moe_every 2 (pipe 4 would split its dense + MoE pairs), a
              warm-up and 2 steps each with the flash counts reset just
              before and read just after (96 forward, dq and dk/dv a
              step); the first loss,
              load-balance terms included, against the dp step's from the
              same weights and batch (PIPE_MOE_LOSS_TOL); a routing group
              within a microbatch's rows; step time, peak memory, the most
              microbatches a stage held, a profiled step with the flash
              kernels counted by name.

The prefix cache and LoRA adapters (phase 31 runs after phase 7, on the
same seeded int8 8B cut to 8 of 32 layers, PL_LAYERS):

31. prefix_lora -- the full-width int8 Llama-3-8B at 8 layers serving
              through InferenceServer(ServingEngine(...)) with 8 slots and
              blocks of 16 rows, on the compute and then the int8 KV
              cache: 4 system prompts of 256 tokens, 24 requests each a
              system prompt and a suffix of its own (16-64 tokens), 32 new
              tokens (every fourth sampled, one n-best of 4), the first 4
              (one a system prompt) finished before the other 20 arrive
              at 50 a second; the same with the prefix cache off. Every
              request's tokens (and the n-best's streams) equal across the
              two (else the largest logit gap of the first parted request
              and a failure); at least 20 hits; hits, misses, evictions,
              prompt tokens saved, TTFT and prefill time of hits and
              misses; W8A16 counts reset just before and read just after
              each run (33 a forward); a hit's restore (16 blocks) and a
              retire's save (20 blocks) timed against their bound; the
              w8a16 kernels counted by name in one profiled round of a
              hit. Before each cache's runs, a 300-token prompt's last T
              rows (T in PL_ROWS) prefilled over the whole prefill's
              other rows: logits and K/V bit for bit the whole prefill's
              for T >= 2 (the prefill's attention on fixed blocks of query
              rows). An eviction run (compute cache, 352
              rows a slot: 176 blocks): wave 1, 8 requests, 4 cold
              320-token prompts, 8 more requests; evictions > 0, tokens
              equal the cache-off run's. LoRA: a bank of 4 adapters of
              rank 16 at scale 0.3 (adapter 0 the base); one prompt on
              every adapter and one of its own on each, 8 new tokens, in
              one batch: adapter
              0's rows equal the engine's without a bank, each adapter's
              rows its rows served alone, an adapter moves the shared
              prompt's tokens; one new prompt on adapters 2, 3, 2: miss,
              miss, hit. Last, one W8A16 call at the stream's median
              suffix rows against its plain version.

Tenants, the greedy contract of float models and the user scripts (phase
32 runs after phase 31, on its model, then frees it):

32. tenants_scripts -- (a) the int8 8B, 8 slots, tenant quotas: a flood
              tenant of 24 requests (quota 2) and two light tenants of 3,
              all submitted before the first round: 22 rejected
              tenant_quota, each light head admitted within one rotation,
              every served request's tokens equal it served alone, W8A16
              33 a forward (counts reset just before and read just after)
              and by name in a profiled round. (b) fault 1: a float bf16
              Llama at the 8B's widths (1 layer) and config 4's LM (6 of
              12 layers), greedy
              rows in engines of 1, 3 and 8 slots against a solo
              generate() of each prompt: logits bit for bit and tokens
              (the decode step's dense products on fixed row blocks); the
              gap without the blocks, and the bf16 decode step's time at 1
              and 8 rows with and without them. (c) scripts/eval.py on
              phase 28's 1-layer 8B checkpoint: its line equals phase
              28's Trainer.evaluate of the state it saved, taken before
              the Trainer closed; flash_fwd counted by the wrapper
              and by name. (d) a seeded HF-layout Llama state_dict at the
              8B's widths (1 layer, bf16) through scripts/convert.py (on
              the CPU, --optim.name sgd), scripts/generate.py quantized at
              load (tokens equal generate() on the weights loaded in
              memory; W8A16 5 a forward) and --export (every tensor back
              bit for bit); seconds and bytes of each. (e) the serve entry
              point with --metrics-out (int8, 1 layer at the 8B's
              widths): one serve_request a finished request with the JAX
              record's keys, one serve_summary.
33. tensor  -- the tensor axis (ROADMAP §1 item 3.2) with the tensor ranks
              as processes that share the card in their own gloo group
              (NCCL refuses two ranks on one device), every run and its
              one-process reference at the full lr (no warmup), so each
              second loss follows a real update: (a) transformer_lm_pp at
              full width and batch, 6 of 12 layers, at mesh.tensor 2, the
              first batch's gradients leaf by leaf and 2 steps' losses
              against one process's, flash 12/6/6 a step by wrapper and by
              name, the
              recorder's collectives, peak memory a rank; (b)
              llama3_8b_zero at full width, 1 of 32 layers, under ZeRO-3
              on fsdp 2 x tensor 2 (4 processes; the vocab tables split
              over tensor and fsdp), 2 steps against the world-1 steps;
              (c) scripts/generate.py --tp 2 on the 8B (32 layers), bf16
              and int8, tokens equal to one process's, W8A16 129 a decode
              step by wrapper and by name, per-token latency and cache
              bytes a rank; (d) transformer_lm_pp at 2 layers on
              mesh.pipe 2 x tensor 2 (both stages in each process), gpipe
              and 1f1b against one process's pipe 2.
34. zero_seq -- ZeRO under sequence parallelism, seq x tensor and a resume
              onto other layouts (ROADMAP §1 items 3.3, 3.4), the ranks as
              processes sharing the card in a gloo group as in phase 33,
              the ring's shifts between them staged through host memory:
              llama3_longcontext at its preset's full width (8 layers, d
              1024, 8/4 heads of 128, T 32768, xent_chunk 2048, remat) with
              ring attention on the ring kernel, at the full lr: (a)
              ZeRO-3 on fsdp 2 x seq 2 (4 processes, batch 2), its first
              batch's gradient slices and 2 steps' losses against one
              process's, saved after step 1 (only the first seq rank of
              each fsdp slice writes); (b) seq 2 x tensor 2 (batch 1, 4/2
              heads a rank), 2 steps against one process's; per step and
              rank the seconds, peak memory, all-gathers, reduce-scatters
              and shifts with their bytes, the host-staged messages, the
              ring kernel and the flash backward kernels by wrapper and by
              name in a profiled step; (c) (a)'s step-1 checkpoint
              restored (resharded on read) into ZeRO-1 on fsdp 2 without
              seq (2 processes) and into one process, each taking step 2:
              its loss within ZS_RESUME_TOL of (a)'s step 2.

The last three lines of standard output are the kernels JSON line, the
card's name and power limit from nvidia-smi, and the result JSON line.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

TPU_KERNEL = "pytorch_distributed_nn_tpu/ops/pallas/int8_matmul.py:72"
SOURCE = "pytorch_distributed_nn_tpu_torch/csrc/int8_matmul.cu"
FLASH_SOURCE = "pytorch_distributed_nn_tpu_torch/csrc/flash_attention.cu"
FLASH_TPU = "pytorch_distributed_nn_tpu/ops/pallas/flash_attention.py"
# kernel -> (TPU kernel body it replaces, causal FLOPs per head / (T^2 D))
FLASH_KERNELS = {"flash_fwd": (f"{FLASH_TPU}:56", 2),
                 "flash_bwd_dq": (f"{FLASH_TPU}:227", 3),
                 "flash_bwd_dkv": (f"{FLASH_TPU}:257", 4)}
# the long-context preset's attention: B 1, 8 query heads, 4 K/V heads, D 128
FLASH_B, FLASH_H, FLASH_HKV, FLASH_D = 1, 8, 4, 128
# flash kernel vs plain version. The kernels round p (and ds) to bf16 for
# the tensor cores and write bf16 outputs; the plain versions keep f32:
# O, dq, dk and dv agree to a few bf16 steps of the largest output.
# lse is f32 statistics of the same inputs (absolute limit).
FLASH_TOL = 2e-2
LSE_TOL = 1e-4
# one full-width training step at T = 4096, flash kernels vs the plain
# attention from the same weights and batch: the two round to bf16 at
# other places (p and ds for the tensor cores; the plain path's bf16
# probabilities), and 8 layers carry the differences into every gradient
TRAIN_LOSS_TOL = 1e-3  # relative
TRAIN_GRAD_TOL = 5e-2  # max|err| / max|ref|, per parameter
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate
V = 128256  # Llama-3 vocabulary
# the (K, N) of every int8 matmul on the fused 8B path, and the count of
# each in one forward (32 layers of qkv/out/gate_up/down + the lm_head)
PATH_SHAPES = [("qkv", 4096, 6144, 32), ("out", 4096, 4096, 32),
               ("gate_up", 4096, 28672, 32), ("down", 14336, 4096, 32),
               ("lm_head", 4096, 128256, 1)]
# kernel vs plain version: the same f32 products summed in another order;
# a bf16 output may round to the neighbouring bf16 value
TOL = {"bfloat16": 2 ** -7, "float32": 1e-5}
# the M of phase 2: decode (1, 8) and the engine's prefill buckets
INT8_MS = (1, 8, 16, 64, 128)
# full-width logits, kernel vs plain version, max|diff| over the largest
# logit. The two differ in summation order only, but 32 layers of random
# weights amplify rounding-order noise: an element that rounds to the
# neighbouring bf16 value in one run and not the other grows to a few
# percent of the logits (measured on an H100: 4.3e-2 in bf16 compute,
# 9.8e-3 in f32 compute). The per-call check of phase 3 holds every launch
# to TOL on the model's own activations, where that noise has not grown.
LOGIT_TOL = {"bfloat16": 8e-2, "float32": 2e-2}
# phase 7: the int8 KV cache's teacher-forced logits against the compute
# cache's, max|d| / max|ref| of a request (int8_vs_compute). Measured on an
# H100 at full width: 5.9e-3 to 8.4e-2 over phase 7's 8 greedy requests
# (largest at the first steps, as the bf16 noise of LOGIT_TOL); the same
# cache with its scales off by one position 0.28, with scales of 1 1.63.
INT8_KV_TOL = 0.15


def log(msg: str) -> None:
    print(msg, flush=True)


_TICK = [time.monotonic()]


def tick(label: str) -> None:
    """Log the seconds since the previous tick (each phase's wall time)."""
    now = time.monotonic()
    log(f"[time] {label}: {now - _TICK[0]:.1f} s")
    _TICK[0] = now


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled):
    """``flash_fwd_kernel<128>`` of a kernel's mangled name (a function,
    maybe templated on one int, maybe inside one namespace)."""
    if not mangled.startswith("_Z"):
        return mangled
    nested = mangled.startswith("_ZN")
    pos = 3 if nested else 2

    def ident():  # the next length-prefixed identifier
        nonlocal pos
        n = re.match(r"\d+", mangled[pos:])
        start = pos + n.end()
        pos = start + int(n.group())
        return mangled[start:pos]

    name = ident()
    if nested:
        name = ident()  # the first was the (anonymous) namespace
    targ = re.match(r"ILi(\d+)E", mangled[pos:])
    return name + (f"<{targ.group(1)}>" if targ else "")


def kernel_resources(report):
    """{kernel: {"registers": n, "spill_bytes": n}} from nvcc's -Xptxas -v
    report, kernels named by :func:`kernel_name`."""
    out, name = {}, None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name = kernel_name(entry.group(1))
            out[name] = {}
        elif name is not None:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", line)
            if spill:
                out[name]["spill_bytes"] = int(spill.group(1)) + int(
                    spill.group(2))
            regs = re.search(r"Used (\d+) registers", line)
            if regs:
                out[name]["registers"] = int(regs.group(1))
    return out


def time_ms(fn, iters, flush=None):
    """Median milliseconds of ``fn`` by CUDA events, one warm-up call
    first, the L2 cache flushed (``flush`` zeroed) before every timed
    launch when ``flush`` is given."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for e0, e1 in pairs:
        if flush is not None:
            flush.zero_()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    ts = sorted(e0.elapsed_time(e1) for e0, e1 in pairs)
    return ts[len(ts) // 2]


def library_call(x, q, s, out_dtype):
    """The yardstick (never used by the port): torch._weight_int8pack_mm
    where this PyTorch has it on CUDA, else a bf16 matmul against weights
    dequantized ahead of time. Returns (label, fn)."""
    import torch

    wt = q.t().contiguous()  # (N, K) int8
    sc = s.reshape(-1).to(torch.bfloat16)
    op = getattr(torch, "_weight_int8pack_mm", None)
    if op is not None:
        try:
            op(x[:1], wt, sc)
            torch.cuda.synchronize()
            return "torch._weight_int8pack_mm", lambda: op(x, wt, sc)
        except (RuntimeError, NotImplementedError):
            pass
    w = (q.to(torch.float32) * s).to(torch.bfloat16)
    return ("torch.matmul(bf16 x, bf16 weights dequantized ahead)",
            lambda: torch.matmul(x, w))


def read_ms(nbytes, flush):
    """torch.sum over a tensor of ``nbytes`` under the same L2 flush: what
    reading the weights' bytes once takes with this timing (a yardstick of
    the method, never used by the port)."""
    import torch

    buf = torch.zeros((nbytes // 4,), dtype=torch.float32, device="cuda")
    ms = time_ms(lambda: buf.sum(), 20, flush)
    del buf
    return ms


def int8_invariance(name, x, q, s, out_dtype):
    """The engine's bit-identity contract on the card: each row alone (M = 1)
    gives the same bits as inside M = 8 and M = 128."""
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import int8_matmul as tmm

    alone = torch.cat([tmm.int8_matmul(x[i:i + 1], q, s, out_dtype)
                       for i in range(x.shape[0])])
    for m in (8, 128):
        got = tmm.int8_matmul(x[:m], q, s, out_dtype)
        if not torch.equal(got, alone[:m]):
            rows = int((got != alone[:m]).any(dim=1).sum())
            raise AssertionError(
                f"int8_matmul {name}: {rows} of {m} rows differ in bits "
                f"from the same rows alone (M = 1)")
    log(f"[kernel] {name}: every row of M = 8 and M = 128 equals itself "
        "alone (M = 1) bit for bit")


def phase_kernel(flush):
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import int8_matmul as tmm

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    rows, max_err, library_label = [], 0.0, None
    for name, k, n, per_fwd in PATH_SHAPES:
        kp, np_ = tmm.padded_kn(k, n)
        q = torch.empty((kp, np_), dtype=torch.int8, device=dev)
        q.random_(-64, 64, generator=g)
        s = torch.full((1, np_), 2.7e-4, device=dev)
        out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
        dt = "float32" if name == "lm_head" else "bfloat16"
        weight_read_ms = read_ms(q.numel(), flush)
        for m in INT8_MS:
            x = torch.randn((m, kp), generator=g, device=dev).to(
                torch.bfloat16)
            got = tmm.int8_matmul(x, q, s, out_dtype=out_dtype)
            ref = tmm.int8_matmul_reference(x, q, s, out_dtype=out_dtype)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            if not err <= TOL[dt] * scale:
                raise AssertionError(
                    f"int8_matmul {name} M={m}: max|err| {err} > "
                    f"{TOL[dt]} * max|ref| {scale}")
            max_err = max(max_err, err)
            if m == 128:
                int8_invariance(name, x, q, s, out_dtype)
            ms = time_ms(lambda: tmm.int8_matmul(x, q, s, out_dtype),
                         20, flush)
            plain_ms = time_ms(
                lambda: tmm.int8_matmul_reference(x, q, s, out_dtype),
                3, flush)
            library_label, lib_fn = library_call(x, q, s, out_dtype)
            library_ms = time_ms(lib_fn, 20, flush)
            nbytes = (x.numel() * 2 + q.numel() + s.numel() * 4
                      + m * np_ * got.element_size())
            ops = 2 * m * kp * np_
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / BF16_OPS_PER_S * 1e3
            row = dict(shape=name, m=m, k=kp, n=np_, per_forward=per_fwd,
                       out=dt, max_abs_err=err, max_abs_ref=scale, ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       read_ms=weight_read_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       gbytes_per_s=nbytes / ms / 1e6,
                       plan=tmm.launch_plan(m, kp, np_)._asdict())
            rows.append(row)
            log(f"[kernel] {json.dumps(row)}")
            del got, ref, lib_fn
        del q, s
        torch.cuda.empty_cache()
    log(f"[kernel] library yardstick: {library_label}")
    for m in INT8_MS:
        at = {r["shape"]: r for r in rows if r["m"] == m}
        fwd = {key: sum(at[name][key] * per for name, _, _, per in
                        PATH_SHAPES)
               for key in ("ms", "bound_ms", "read_ms", "plain_ms")}
        log(f"[kernel] one 8B forward (129 calls) at M={m}: "
            f"{json.dumps(fwd)}")
    return rows, max_err, library_label


def flash_inputs(T, seed):
    """q, k, v, dO of the long-context attention, bf16 on the card."""
    import torch

    g = torch.Generator("cuda").manual_seed(seed)

    def r(h):
        return torch.randn((FLASH_B, T, h, FLASH_D), generator=g,
                           device="cuda").to(torch.bfloat16)

    return r(FLASH_H), r(FLASH_HKV), r(FLASH_HKV), r(FLASH_H)


def rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def flash_check(name, got, ref, tol=FLASH_TOL):
    """max|err| and max|err|/max|ref| of ``got`` against ``ref``, logged;
    raises when the latter is above ``tol``."""
    err = (got.float() - ref.float()).abs().max().item()
    rel = err / ref.float().abs().max().item()
    log(f"[check] {name}: max|err| {err:.3e}, max|err|/max|ref| {rel:.3e}")
    if not rel <= tol:
        raise AssertionError(f"{name}: max|err|/max|ref| {rel} > {tol}")
    return dict(max_abs_err=err, rel_err=rel)


def worst(*checks):
    """The largest of each error over ``flash_check`` results."""
    return {key: max(c[key] for c in checks) for key in checks[0]}


def flash_bound_ms(name, T, B=FLASH_B, H=FLASH_H, HKV=FLASH_HKV,
                   D=FLASH_D):
    """max(operations / bf16 peak, bytes / HBM rate) of one call: causal
    FLOPs per head from FLASH_KERNELS; each input read once, each output
    written once."""
    n_q = B * T * H * D * 2  # bf16 bytes of q (or dO, O)
    n_kv = B * T * HKV * D * 2
    n_stat = B * H * T * 4  # f32 lse or delta
    nbytes = {"flash_fwd": 2 * n_q + 2 * n_kv + n_stat,  # q k v -> O lse
              "flash_bwd_dq": 3 * n_q + 2 * n_kv + 2 * n_stat,
              "flash_bwd_dkv": 2 * n_q + 4 * n_kv + 2 * n_stat}[name]
    ops = FLASH_KERNELS[name][1] * B * H * T * T * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_once_ms(fn):
    """Milliseconds of one call of ``fn`` by CUDA events (for the plain
    versions, which are slow and large)."""
    import torch

    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def phase_flash(flush):
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa

    errs = {}
    # T = 4096: every output in full against the plain versions
    T = 4096
    q, k, v, do = flash_inputs(T, seed=0)
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.flash_delta(o, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, True)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, True)
    errs["flash_fwd"] = flash_check("flash_fwd O, T=4096", o, o_ref)
    lse_err = (lse - lse_ref).abs().max().item()
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"flash_fwd lse, T=4096: {lse_err} > {LSE_TOL}")
    args = (q, k, v, do, lse, delta, True)
    errs["flash_bwd_dq"] = flash_check(
        "flash_bwd_dq, T=4096", dq, fa.flash_bwd_dq_reference(*args))
    dk_ref, dv_ref = fa.flash_bwd_dkv_reference(*args)
    errs["flash_bwd_dkv"] = worst(flash_check("flash_bwd_dkv dk, T=4096",
                                              dk, dk_ref),
                                  flash_check("flash_bwd_dkv dv, T=4096",
                                              dv, dv_ref))
    log(f"[flash] T=4096 in full: {errs}, lse {lse_err:.3e}")
    del o_ref, lse_ref, dk_ref, dv_ref
    torch.cuda.empty_cache()

    # T = 32768: the last 512 query rows (they see every key) for O, lse
    # and dq; the first and last 512-key tiles for dk and dv
    T = 32768
    q, k, v, do = flash_inputs(T, seed=1)
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.flash_delta(o, do)
    args = (q, k, v, do, lse, delta, True)
    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    last = slice(T - 512, T)
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, True, q_rows=last)
    errs["flash_fwd"] = worst(errs["flash_fwd"], flash_check(
        "flash_fwd O, T=32768", o[:, last], o_ref))
    lse_err = max(lse_err, (lse[:, last] - lse_ref).abs().max().item())
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"flash_fwd lse, T=32768: {lse_err} > {LSE_TOL}")
    errs["flash_bwd_dq"] = worst(errs["flash_bwd_dq"], flash_check(
        "flash_bwd_dq, T=32768", dq[:, last],
        fa.flash_bwd_dq_reference(*args, q_rows=last)))
    for rows in (slice(0, 512), last):
        dk_ref, dv_ref = fa.flash_bwd_dkv_reference(*args, k_rows=rows)
        errs["flash_bwd_dkv"] = worst(
            errs["flash_bwd_dkv"],
            flash_check(f"flash_bwd_dkv dk rows {rows}", dk[:, rows], dk_ref),
            flash_check(f"flash_bwd_dkv dv rows {rows}", dv[:, rows], dv_ref))
    del o_ref, lse_ref, dk_ref, dv_ref
    torch.cuda.empty_cache()
    log(f"[flash] T=32768 on row slices: {errs}, lse {lse_err:.3e}")

    # times at T = 32768: the kernels (median of 10), their plain versions
    # (the whole output, 2048 rows at a time, one run), the library call
    kern = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, True),
            "flash_bwd_dq": lambda: fa.flash_bwd_dq(*args),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(*args)}
    step = 2048

    def plain_rows(fn):
        def run():
            for r0 in range(0, T, step):
                fn(slice(r0, r0 + step))
        return run

    plain = {
        "flash_fwd": lambda r: fa.flash_forward_reference(
            q, k, v, True, q_rows=r),
        "flash_bwd_dq": lambda r: fa.flash_bwd_dq_reference(
            *args, q_rows=r),
        "flash_bwd_dkv": lambda r: fa.flash_bwd_dkv_reference(
            *args, k_rows=r)}
    # the yardstick, never used by the port: PyTorch's fused attention on
    # the same inputs, its forward and its backward (which computes dq, dk
    # and dv in one call)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    with torch.no_grad():
        lib_fwd = time_ms(sdpa, 10, flush)
    out_t = sdpa()
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out_t, (qt, kt, vt), dot, retain_graph=True), 10, flush)
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd,
               "flash_bwd_dkv": lib_bwd}
    rows = {}
    for name in FLASH_KERNELS:
        ms = time_ms(kern[name], 10, flush)
        plain[name](slice(0, step))  # warm-up
        plain_ms = time_once_ms(plain_rows(plain[name]))
        torch.cuda.empty_cache()
        bound, by = flash_bound_ms(name, T)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library[name],
                          bound_ms=bound, bound_by=by,
                          share_of_bound=bound / ms,
                          **errs[name],
                          tflops=FLASH_KERNELS[name][1] * FLASH_B * FLASH_H
                          * T * T * FLASH_D / ms / 1e9)
        log(f"[flash] {name} T=32768: {json.dumps(rows[name])}")
    log("[flash] library yardstick: F.scaled_dot_product_attention("
        "is_causal=True, enable_gqa=True); its backward computes dq, dk "
        "and dv in one call")
    del qt, kt, vt, out_t, q, k, v, do, o, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()
    return rows, lse_err


def phase_auto():
    """One layer's attention forward + backward at the long-context
    shapes, flash against the plain path: the sweep behind FLASH_MIN_T."""
    import torch

    from pytorch_distributed_nn_tpu_torch.nn.attention import (
        FLASH_MIN_T,
        dot_product_attention,
    )

    sweep = {}
    for T in (128, 256, 512, 1024, 2048, 4096):
        q, k, v, do = flash_inputs(T, seed=T)
        leaves = [x.requires_grad_() for x in (q, k, v)]
        ms = {}
        for impl in ("flash", "xla", "xla", "flash"):  # in turns
            def fn(impl=impl):
                out = dot_product_attention(*leaves, causal=True, impl=impl)
                torch.autograd.grad(out, leaves, do)
            t = time_ms(fn, 10)
            ms[impl] = min(ms.get(impl, t), t)
        sweep[T] = ms
        log(f"[auto] T={T} fwd+bwd ms: flash {ms['flash']:.4f} "
            f"xla {ms['xla']:.4f}")
    wins = [T for T in sweep
            if all(sweep[u]["flash"] <= sweep[u]["xla"] for u in sweep
                   if u >= T)]
    measured = min(wins) if wins else None
    log(f"[auto] flash wins from T={measured} on; FLASH_MIN_T={FLASH_MIN_T}")
    return dict(sweep=sweep, flash_wins_from=measured,
                flash_min_t=FLASH_MIN_T)


def flash_counts():
    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa

    return {name: getattr(fa, name).launches for name in FLASH_KERNELS}


def reset_flash_counts():
    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa

    for name in FLASH_KERNELS:
        getattr(fa, name).launches = 0


def longcontext(**overrides):
    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    cfg = get_config("llama3_longcontext", log_every="1", **overrides)
    return Trainer(cfg, device="cuda")  # seeded init (cfg.seed)


def phase_train_check():
    """T = 4096, full width: one step's loss and gradients with the flash
    kernels against the same step with the plain attention, from the same
    weights and batch."""
    import torch

    from pytorch_distributed_nn_tpu_torch.parallel import dp
    from pytorch_distributed_nn_tpu_torch.parallel.api import (
        make_chunked_loss,
    )

    trainer = longcontext(**{"data.seq_len": "4096"})
    x, y = trainer.loader.batch_at(0)
    loss_fn = make_chunked_loss(trainer.cfg.xent_chunk)
    out = {}
    for impl in ("flash", "xla"):
        for i in range(trainer.model.num_layers):
            getattr(trainer.model, f"layer{i}").attn.impl = impl
        reset_flash_counts()
        loss = dp._loss_and_grads(trainer.state, x, y, loss_fn).item()
        counts = flash_counts()
        grads = {n: p.grad.clone()
                 for n, p in trainer.model.named_parameters()}
        trainer.state.optimizer.zero_grad()
        out[impl] = (loss, grads, counts)
    L = trainer.model.num_layers
    if out["flash"][2] != {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                           "flash_bwd_dkv": L}:
        raise AssertionError(f"flash launches in one step: {out['flash'][2]}")
    if any(out["xla"][2].values()):
        raise AssertionError("the plain step launched a flash kernel")
    loss_f, grads_f, _ = out["flash"]
    loss_x, grads_x, _ = out["xla"]
    loss_err = abs(loss_f - loss_x) / abs(loss_x)
    grad_err = {n: rel_err(grads_f[n], g) for n, g in grads_x.items()}
    worst = max(grad_err, key=grad_err.get)
    log(f"[train] T=4096 one step, flash vs plain attention: loss "
        f"{loss_f:.6f} vs {loss_x:.6f} (rel {loss_err:.3e}); worst gradient "
        f"{worst} max|err|/max|ref| {grad_err[worst]:.3e}")
    if not (loss_err <= TRAIN_LOSS_TOL
            and grad_err[worst] <= TRAIN_GRAD_TOL):
        raise AssertionError("flash training step disagrees with the plain "
                             f"attention (limits {TRAIN_LOSS_TOL}, "
                             f"{TRAIN_GRAD_TOL})")
    del trainer, out, grads_f, grads_x
    torch.cuda.empty_cache()
    return dict(loss_rel_err=loss_err, worst_grad=worst,
                worst_grad_rel_err=grad_err[worst])


def matmul_params(model):
    """Parameters that take part in a matmul: every 2-D one but the
    embedding table (a lookup)."""
    return sum(p.numel() for n, p in model.named_parameters()
               if p.dim() == 2 and not n.startswith("tok_embed"))


def profile_train_step(trainer):
    """Device time of one training step by torch.profiler, by kernel
    family; None where the profiler records no device activity.
    Measurement only: the step itself runs outside any ``except``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA], acc_events=True)
    try:
        prof.start()
    except RuntimeError as e:
        log(f"[train] profiler did not start: {e}")
        return None
    t0 = time.monotonic()
    try:
        trainer.train(steps=1)
        torch.cuda.synchronize()
    finally:
        stopped = _profiler_stop(prof)
    wall = time.monotonic() - t0
    if not stopped:
        return None
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return None
    fams, names = {}, {}
    for e in kern:
        name = e.name
        fam = ("ring_block_update" if "ring_block" in name
               else "flash_fwd" if "flash_fwd" in name
               else "flash_bwd_dq" if "flash_bwd_dq" in name
               else "flash_bwd_dkv" if "flash_bwd_dkv" in name
               else "gemm" if any(s in name.lower() for s in
                                  ("gemm", "cutlass", "sm90_xmma", "nvjet"))
               else "other")
        ms = e.time_range.elapsed_us() / 1e3
        fams[fam] = fams.get(fam, 0.0) + ms
        n, t = names.get(name[:96], (0, 0.0))
        names[name[:96]] = (n + 1, t + ms)
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:12]
    return dict(kernels=len(kern), device_ms=sum(fams.values()),
                profiled_wall_ms=wall * 1e3, by_family_ms=fams,
                top_kernels=[dict(name=k, calls=n, ms=t)
                             for k, (n, t) in top])


def phase_train():
    """The main path: the preset as it is (T = 32768) for 4 steps."""
    import torch

    from pytorch_distributed_nn_tpu_torch.utils.flops import (
        lm_train_flops_per_token,
    )

    trainer = longcontext()
    cfg, model = trainer.cfg, trainer.model
    T, L, steps = cfg.data.seq_len, model.num_layers, 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()  # the main path's count starts here
    trainer.train(steps=steps)
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps,
            "flash_bwd_dkv": L * steps}
    if launches != want:
        raise AssertionError(f"flash launches {launches} in {steps} steps, "
                             f"expected {want}")
    losses = trainer.losses()
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses {losses}")
    secs = sorted(r.seconds for r in trainer.history)
    step_s = (secs[steps // 2 - 1] + secs[steps // 2]) / 2  # median
    tokens = cfg.data.batch_size * T
    n_mm = matmul_params(model)
    model_flops = tokens * lm_train_flops_per_token(
        n_mm, L, T, model.d_model, causal=True)
    # the work the card does: attention forward twice (remat) + both
    # backward passes; every matmul forward, rerun (remat, chunked head)
    # and twice in the backward
    D, H = model.head_dim, model.num_heads
    hw_flops = (L * H * T * T * D * (2 * 2 + 3 + 4)
                + 8 * n_mm * tokens)
    prof = profile_train_step(trainer)
    if prof is not None:
        # against the unprofiled median step: the profiler's own host
        # overhead stretches the profiled step's wall time
        prof["idle_share_vs_unprofiled_step"] = (
            1 - prof["device_ms"] / (step_s * 1e3))
    result = dict(
        seq_len=T, steps=steps, losses=losses,
        step_s=[r.seconds for r in trainer.history[:steps]],
        median_step_s=step_s, tokens_per_s=tokens / step_s,
        model_tflop_per_step=model_flops / 1e12,
        mfu=model_flops / step_s / BF16_OPS_PER_S,
        hw_tflop_per_step=hw_flops / 1e12,
        hfu=hw_flops / step_s / BF16_OPS_PER_S,
        peak_mem_gb=peak / 1e9, launches=launches,
        params=sum(p.numel() for p in model.parameters()),
        matmul_params=n_mm, profile=prof)
    log(f"[train] {json.dumps(result)}")
    del trainer, model
    torch.cuda.empty_cache()
    return result, launches


# ---------------------------------------------------------------------------
# slice 4: sequence parallelism, the ring block kernel
# ---------------------------------------------------------------------------
RING_SOURCE = "pytorch_distributed_nn_tpu_torch/csrc/ring_attention.cu"
RING_TPU = "pytorch_distributed_nn_tpu/ops/pallas/ring_attention.py:57"
RING_SEQ = 4  # the ring replayed in one process at T = 32768
RING_LIBRARY = ("F.scaled_dot_product_attention(enable_gqa=True) forward on "
                "the same pair (nearest: no PyTorch call updates a carry)")


def reset_ring_counts():
    from pytorch_distributed_nn_tpu_torch.ops import ring_attention as ra

    reset_flash_counts()
    ra.ring_block_update.launches = 0


def ring_counts():
    from pytorch_distributed_nn_tpu_torch.ops import ring_attention as ra

    return {"ring_block_update": ra.ring_block_update.launches,
            **flash_counts()}


def ring_carries(T, seed):
    """Random non-trivial incoming carries (m, l, acc) for Tl = T."""
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    m = torch.randn((FLASH_B * FLASH_H, T), generator=g, device="cuda")
    l = torch.rand((FLASH_B * FLASH_H, T), generator=g, device="cuda") * 4 \
        + 0.5
    acc = torch.randn((FLASH_B, T, FLASH_H, FLASH_D), generator=g,
                      device="cuda")
    return m, l, acc


def ring_plain(q, k, v, m, l, acc, q_off, k_off, causal, step=2048):
    """The plain version, 2048 query rows at a time (it is row by row the
    same function; a whole Tl = 32768 pair's f32 scores would not fit)."""
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import ring_attention as ra

    parts = [ra.ring_block_reference(
        q[:, r0:r0 + step], k, v, m[:, r0:r0 + step], l[:, r0:r0 + step],
        acc[:, r0:r0 + step], q_off + r0, k_off, causal=causal)
        for r0 in range(0, q.shape[1], step)]
    return tuple(torch.cat(p, dim=1) for p in zip(*parts))


def ring_check(label, got, want):
    """Kernel carries ``got`` = (m, l, acc) against the plain version's
    ``want``, and the (O, lse) that parallel/sequence.py's ring_finish makes
    of each: m and lse within LSE_TOL, l, acc and O within FLASH_TOL of
    their largest elements, or raise. Returns the errors."""
    import torch

    from pytorch_distributed_nn_tpu_torch.parallel import sequence as sp

    m, l, acc = got
    o, lse = sp.ring_finish(got, torch.float32)
    o_ref, lse_ref = sp.ring_finish(want, torch.float32)
    e = dict(m=(m - want[0]).abs().max().item(),
             lse=(lse - lse_ref).abs().max().item(),
             l_rel=rel_err(l, want[1]), o_rel=rel_err(o, o_ref),
             acc_rel=rel_err(acc, want[2]),
             max_abs_err=(acc - want[2]).abs().max().item())
    if not (e["m"] <= LSE_TOL and e["lse"] <= LSE_TOL
            and max(e["l_rel"], e["o_rel"], e["acc_rel"]) <= FLASH_TOL):
        raise AssertionError(f"ring block, {label}: {e} (limits lse "
                             f"{LSE_TOL}, {FLASH_TOL})")
    log(f"[ring] {label} vs plain: {json.dumps(e)}")
    return e


def ring_bound_ms(Tq, Tk, causal_diagonal):
    """Operations 4 BH Tq Tk D (half on a causal diagonal) over the bf16
    peak, against bytes (q, k, v read once; m, l, acc read and written)
    over the HBM rate: the larger."""
    bh = FLASH_B * FLASH_H
    ops = 4 * bh * Tq * Tk * FLASH_D / (2 if causal_diagonal else 1)
    nbytes = (bh * Tq * FLASH_D * 2 + 2 * FLASH_B * FLASH_HKV * Tk
              * FLASH_D * 2 + 2 * (2 * bh * Tq * 4 + bh * Tq * FLASH_D * 4))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def ring_main_pair_check(T, seed, q_rows, edge=512):
    """The main path's one pair at world 1 (Tl = T, the diagonal, offsets
    0 and 0) through parallel/sequence.py's per-pair steps: the block
    update with fresh and with random carries against the plain version on
    the query rows ``q_rows``; then the pair's backward (ring_backward_pair:
    flash dq and dk/dv with f32 outputs, from the fresh run's lse) against
    their plain versions, dq on the last ``edge`` query rows (they see
    every key), dk and dv on the first and last ``edge`` key rows."""
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_nn_tpu_torch.parallel import sequence as sp

    f32 = torch.float32
    q, k, v, do = flash_inputs(T, seed=seed)
    errs = {}
    for label in ("fresh", "random"):
        carries = (sp.ring_carries(q) if label == "fresh"
                   else ring_carries(T, seed))
        m, l, acc = carries
        want = [ring_plain(q[:, r], k, v, m[:, r], l[:, r], acc[:, r],
                           r.start, 0, True) for r in q_rows]
        sp.ring_forward_pair(q, k, v, carries, 0, 0, True)
        torch.cuda.synchronize()
        for r, w in zip(q_rows, want):
            errs[f"{label} rows {r.start}:{r.stop}"] = ring_check(
                f"Tl={T} main-path pair, {label} carries, rows "
                f"{r.start}:{r.stop}", (m[:, r], l[:, r], acc[:, r]), w)
        if label == "fresh":
            out, lse = sp.ring_finish(carries, q.dtype)
        del want, carries, m, l, acc
    delta = fa.flash_delta(out, do)
    args = (q, k, v, do, lse, delta, True)
    dq, dk, dv = sp.ring_backward_pair(q, k, v, do, lse, delta, 0, 0, True)
    torch.cuda.synchronize()
    last = slice(T - edge, T)
    bwd = {"dq": flash_check(f"ring pair dq (f32), T={T}", dq[:, last],
                             fa.flash_bwd_dq_reference(*args, q_rows=last,
                                                       out_dtype=f32))}
    for r in (slice(0, edge), last):
        dk_ref, dv_ref = fa.flash_bwd_dkv_reference(*args, k_rows=r,
                                                    out_dtype=f32)
        bwd[f"dk rows {r.start}:{r.stop}"] = flash_check(
            f"ring pair dk (f32), T={T}", dk[:, r], dk_ref)
        bwd[f"dv rows {r.start}:{r.stop}"] = flash_check(
            f"ring pair dv (f32), T={T}", dv[:, r], dv_ref)
        del dk_ref, dv_ref
    log(f"[ring] T={T} main-path pair backward (f32 out) vs plain: "
        f"{json.dumps(bwd)}")
    del q, k, v, do, out, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()
    return dict(forward=errs, backward=bwd)


def phase_ring(flush):
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa
    from pytorch_distributed_nn_tpu_torch.ops import ring_attention as ra
    from pytorch_distributed_nn_tpu_torch.parallel import sequence as sp

    f32 = torch.float32
    # (a) Tl = 8192 against the plain version, carries random
    Tl = 8192
    q, k, v, _ = flash_inputs(Tl, seed=20)
    pairs = {"diagonal": (Tl, Tl), "past": (2 * Tl, 0), "future": (0, Tl)}
    errs = {}
    for name, (q_off, k_off) in pairs.items():
        m, l, acc = ring_carries(Tl, seed=len(name))
        want = ring_plain(q, k, v, m, l, acc, q_off, k_off, True)
        before = (m.clone(), l.clone(), acc.clone())
        ra.ring_block_update(q, k, v, m, l, acc, q_off, k_off, causal=True)
        torch.cuda.synchronize()
        if name == "future" and not all(
                torch.equal(a, b) for a, b in zip((m, l, acc), before)):
            raise AssertionError("ring block: the future pair changed its "
                                 "carries")
        errs[name] = ring_check(f"Tl={Tl} {name} pair", (m, l, acc), want)
        del want, before, m, l, acc
    torch.cuda.empty_cache()

    # (b) the 16 pairs of a seq = 4 ring at T = 32768, in ring order, through
    # the ring's own per-pair steps (parallel/sequence.py)
    T = 32768
    Tl = T // RING_SEQ
    q, k, v, do = flash_inputs(T, seed=21)
    o_full, lse_full = fa.flash_fwd(q, k, v, True)
    shard = [slice(r * Tl, (r + 1) * Tl) for r in range(RING_SEQ)]
    n0 = ra.ring_block_update.launches
    outs, lses = [], []
    for r in range(RING_SEQ):
        qr = q[:, shard[r]]
        carries = sp.ring_carries(qr)
        for src in sp.ring_order(r, RING_SEQ):
            sp.ring_forward_pair(qr, k[:, shard[src]], v[:, shard[src]],
                                 carries, r, src, True)
        o, lse = sp.ring_finish(carries, q.dtype)
        outs.append(o)
        lses.append(lse)
        del carries
    torch.cuda.synchronize()
    pairs_run = ra.ring_block_update.launches - n0
    o_ring = torch.cat(outs, dim=1)
    lse_ring = torch.cat(lses, dim=1)
    fwd = dict(pairs=pairs_run, o_rel=rel_err(o_ring, o_full),
               lse=(lse_ring - lse_full).abs().max().item())
    log(f"[ring] seq=4 ring at T={T}, 16 pairs vs flash_fwd: "
        f"{json.dumps(fwd)}")
    if not (pairs_run == RING_SEQ ** 2 and fwd["o_rel"] <= FLASH_TOL
            and fwd["lse"] <= LSE_TOL):
        raise AssertionError(f"seq=4 ring forward disagrees with flash_fwd "
                             f"(limits {FLASH_TOL}, lse {LSE_TOL})")

    # (c) the same pairs through the ring backward's pair step
    delta_full = fa.flash_delta(o_full, do)
    dq_full = fa.flash_bwd_dq(q, k, v, do, lse_full, delta_full, True)
    dk_full, dv_full = fa.flash_bwd_dkv(q, k, v, do, lse_full, delta_full,
                                        True)
    dq = torch.zeros(q.shape, dtype=f32, device="cuda")
    dk = torch.zeros(k.shape, dtype=f32, device="cuda")
    dv = torch.zeros(k.shape, dtype=f32, device="cuda")
    n_dq, n_dkv = fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches
    for r in range(RING_SEQ):
        qr, dor = q[:, shard[r]], do[:, shard[r]]
        delta_r = fa.flash_delta(outs[r], dor)
        for src in sp.ring_order(r, RING_SEQ):
            part = sp.ring_backward_pair(qr, k[:, shard[src]],
                                         v[:, shard[src]], dor, lses[r],
                                         delta_r, r, src, True)
            if part is None:  # the future: no gradient
                continue
            dq[:, shard[r]] += part[0]
            dk[:, shard[src]] += part[1]
            dv[:, shard[src]] += part[2]
    torch.cuda.synchronize()
    bwd = dict(dq_pairs=fa.flash_bwd_dq.launches - n_dq,
               dkv_pairs=fa.flash_bwd_dkv.launches - n_dkv,
               dq_rel=rel_err(dq, dq_full), dk_rel=rel_err(dk, dk_full),
               dv_rel=rel_err(dv, dv_full))
    log(f"[ring] seq=4 ring backward at T={T}, pair schedule (f32 out) vs "
        f"the full flash backward: {json.dumps(bwd)}")
    live = RING_SEQ * (RING_SEQ + 1) // 2  # diagonal and past pairs
    if not (bwd["dq_pairs"] == bwd["dkv_pairs"] == live
            and max(bwd["dq_rel"], bwd["dk_rel"], bwd["dv_rel"])
            <= FLASH_TOL):
        raise AssertionError(f"seq=4 ring backward disagrees with the flash "
                             f"backward (limit {FLASH_TOL})")
    del o_full, lse_full, o_ring, lse_ring, outs, lses, delta_full, dq_full
    del dk_full, dv_full, dq, dk, dv
    torch.cuda.empty_cache()

    # (d) the main path's pairs at world 1 against the plain versions: the
    # whole Tl = 32768 diagonal; the first and last 512 rows of the
    # Tl = 98304 one (llama3_longcontext_96k)
    T96 = 3 * T
    main = {T: ring_main_pair_check(T, 22, [slice(0, T)]),
            T96: ring_main_pair_check(T96, 23, [slice(0, 512),
                                                slice(T96 - 512, T96)])}

    # (e) times: the world-1 main path's pair (Tl = 32768, diagonal), and
    # the diagonal and a past pair of a seq = 4 ring (Tl = 8192)
    rows = {}
    for label, Tq, q_off, k_off in (("diagonal_32768", T, 0, 0),
                                    ("diagonal_8192", Tl, Tl, Tl),
                                    ("past_8192", Tl, 2 * Tl, 0)):
        qq, kk, vv = q[:, :Tq], k[:, :Tq], v[:, :Tq]
        causal_diag = q_off == k_off
        m, l, acc = sp.ring_carries(qq)
        ms = time_ms(lambda: ra.ring_block_update(
            qq, kk, vv, m, l, acc, q_off, k_off, causal=True), 10, flush)
        ring_plain(qq[:, :2048], kk, vv, m[:, :2048], l[:, :2048],
                   acc[:, :2048], q_off, k_off, True)  # warm-up
        plain_ms = time_once_ms(lambda: ring_plain(qq, kk, vv, m, l, acc,
                                                   q_off, k_off, True))
        torch.cuda.empty_cache()
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (qq, kk, vv))
        with torch.no_grad():
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal_diag, enable_gqa=True), 10,
                flush)
        bound, by = ring_bound_ms(Tq, Tq, causal_diag)
        flops = 4 * FLASH_B * FLASH_H * Tq * Tq * FLASH_D / (
            2 if causal_diag else 1)
        rows[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound, bound_by=by,
                           tflops=flops / ms / 1e9)
        log(f"[ring] {label}: {json.dumps(rows[label])}")
        del m, l, acc, qt, kt, vt
    del q, k, v, do
    torch.cuda.empty_cache()
    checks = [*errs.values()] + [e for c in main.values()
                                 for e in c["forward"].values()]
    return dict(check_8192=errs, ring_forward=fwd, ring_backward=bwd,
                main_pairs=main, times=rows,
                max_abs_err=max(e["max_abs_err"] for e in checks),
                rel_err=max(e["acc_rel"] for e in checks))


def set_attn_impl(model, impl):
    for i in range(model.num_layers):
        getattr(model, f"layer{i}").attn.impl = impl


def phase_ring_check():
    """T = 4096, full width: one step's loss and gradients with ring and
    with ulysses attention (world 1) against flash, from the same weights
    and batch."""
    import torch

    from pytorch_distributed_nn_tpu_torch.parallel import dp
    from pytorch_distributed_nn_tpu_torch.parallel.api import (
        make_chunked_loss,
    )

    trainer = longcontext(**{"data.seq_len": "4096"})
    x, y = trainer.loader.batch_at(0)
    loss_fn = make_chunked_loss(trainer.cfg.xent_chunk)
    L = trainer.model.num_layers
    want = {"flash": {"ring_block_update": 0, "flash_fwd": 2 * L,
                      "flash_bwd_dq": L, "flash_bwd_dkv": L},
            "ring": {"ring_block_update": 2 * L, "flash_fwd": 0,
                     "flash_bwd_dq": L, "flash_bwd_dkv": L},
            "ulysses": {"ring_block_update": 0, "flash_fwd": 2 * L,
                        "flash_bwd_dq": L, "flash_bwd_dkv": L}}
    out = {}
    for impl in want:
        set_attn_impl(trainer.model, impl)
        reset_ring_counts()
        loss = dp._loss_and_grads(trainer.state, x, y, loss_fn).item()
        if ring_counts() != want[impl]:
            raise AssertionError(f"{impl}: launches in one step "
                                 f"{ring_counts()}, expected {want[impl]}")
        out[impl] = (loss, {n: p.grad.clone()
                            for n, p in trainer.model.named_parameters()})
        trainer.state.optimizer.zero_grad()
    loss_f, grads_f = out["flash"]
    result = {}
    for impl in ("ring", "ulysses"):
        loss, grads = out[impl]
        loss_err = abs(loss - loss_f) / abs(loss_f)
        grad_err = {n: rel_err(grads[n], g) for n, g in grads_f.items()}
        worst = max(grad_err, key=grad_err.get)
        log(f"[ring_check] T=4096 one step, {impl} vs flash: loss "
            f"{loss:.6f} vs {loss_f:.6f} (rel {loss_err:.3e}); worst "
            f"gradient {worst} max|err|/max|ref| {grad_err[worst]:.3e}")
        if not (loss_err <= TRAIN_LOSS_TOL
                and grad_err[worst] <= TRAIN_GRAD_TOL):
            raise AssertionError(f"{impl} training step disagrees with "
                                 f"flash (limits {TRAIN_LOSS_TOL}, "
                                 f"{TRAIN_GRAD_TOL})")
        result[impl] = dict(loss_rel_err=loss_err, worst_grad=worst,
                            worst_grad_rel_err=grad_err[worst])
    del trainer, out, grads_f
    torch.cuda.empty_cache()
    return result


def ring_trainer(preset="llama3_longcontext", **overrides):
    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    extra = dict(get_config(preset).model.extra, attn_impl="ring")
    cfg = get_config(preset, log_every="1",
                     **{"model.extra": json.dumps(extra)}, **overrides)
    return Trainer(cfg, device="cuda")


def phase_ring_train():
    """The main path: llama3_longcontext as it is with attn_impl ring on
    NCCL at world 1, 4 steps, counts reset just before and read just
    after; then 2 steps of llama3_longcontext_96k on the same path."""
    import torch

    from pytorch_distributed_nn_tpu_torch.utils.flops import (
        lm_tokens_per_card,
        lm_train_flops_per_token,
    )

    result = {}
    for preset, steps in (("llama3_longcontext", 4),
                          ("llama3_longcontext_96k", 2)):
        trainer = ring_trainer(preset)
        if (trainer.process.backend, trainer.process.world_size) != (
                "nccl", 1):
            raise AssertionError(f"process group {trainer.process}")
        cfg, model = trainer.cfg, trainer.model
        T, L = cfg.data.seq_len, model.num_layers
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_ring_counts()  # the main path's count starts here
        trainer.train(steps=steps)
        launches = ring_counts()
        peak = torch.cuda.max_memory_allocated()
        want = {"ring_block_update": 2 * L * steps, "flash_fwd": 0,
                "flash_bwd_dq": L * steps, "flash_bwd_dkv": L * steps}
        if launches != want:
            raise AssertionError(f"{preset}: launches {launches} in {steps} "
                                 f"steps, expected {want}")
        losses = trainer.losses()
        if len(losses) != steps or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{preset}: losses {losses}")
        step_s, _ = step_stats(trainer, steps)
        tokens = lm_tokens_per_card(cfg.data.batch_size, T, 1, 1)
        flops = tokens * lm_train_flops_per_token(
            matmul_params(model), L, T, model.d_model, causal=True)
        result[preset] = dict(
            seq_len=T, steps=steps, losses=losses,
            step_s=[r.seconds for r in trainer.history],
            median_step_s=step_s, tokens_per_s=tokens / step_s,
            mfu=flops / step_s / BF16_OPS_PER_S, peak_mem_gb=peak / 1e9,
            launches=launches)
        if preset == "llama3_longcontext":  # one more step, profiled
            prof = profile_train_step(trainer)
            if prof is not None:
                prof["idle_share_vs_unprofiled_step"] = (
                    1 - prof["device_ms"] / (step_s * 1e3))
            result[preset]["profile"] = prof
        log(f"[ring_train] {preset} attn_impl=ring: "
            f"{json.dumps(result[preset])}")
        del trainer, model
        torch.cuda.empty_cache()
    return result


def phase_ring4(world1_losses):
    """The train entry point on 4 cards under torchrun (NCCL, one card a
    rank), mesh.seq = 4, 2 steps with ring attention and 2 with Ulysses:
    the losses against the world-1 ring run's; rank 0's logged step
    seconds. Needs 4 cards."""
    import re

    import torch

    n = torch.cuda.device_count()
    if n < 4:
        log(f"[ring4] not run: {n} card{'s' if n != 1 else ''}")
        return None
    from pytorch_distributed_nn_tpu_torch.config import get_config

    result = {}
    for impl in ("ring", "ulysses"):
        extra = dict(get_config("llama3_longcontext").model.extra,
                     attn_impl=impl)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "4", "-m",
               "pytorch_distributed_nn_tpu_torch.train", "--preset",
               "llama3_longcontext", "--steps", "2", "--log_every", "1",
               "--mesh.seq", "4", "--model.extra", json.dumps(extra)]
        env = dict(os.environ, PYTHONPATH=HERE)
        out = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                             text=True, timeout=600)
        if out.returncode != 0:
            raise AssertionError(f"ring4 {impl} exit {out.returncode}: "
                                 f"{out.stderr[-3000:]}")
        line = [x for x in out.stdout.splitlines()
                if x.startswith('{"losses"')]
        losses = json.loads(line[0])["losses"]
        step_s = [float(t) for t in re.findall(
            r"step \d+ loss \S+ \(([\d.]+)s\)", out.stderr)]
        err = max(abs(a - b) / abs(b) for a, b in zip(losses, world1_losses))
        log(f"[ring4] 4 cards, seq=4, {impl}: losses {losses} vs world 1 "
            f"{world1_losses[:2]} (rel {err:.3e}); step s {step_s}")
        if not err <= TRAIN_LOSS_TOL:
            raise AssertionError(f"ring4 {impl} losses differ from world 1 "
                                 f"by {err}")
        result[impl] = dict(losses=losses, rel_err=err, step_s=step_s)
    return result


# ---------------------------------------------------------------------------
# slice 3: the data-parallel path (ResNet-50), its bn_stats and quantize
# ---------------------------------------------------------------------------
BN_SOURCE = "pytorch_distributed_nn_tpu_torch/csrc/bn_stats.cu"
BN_TPU = "pytorch_distributed_nn_tpu/ops/pallas/bn_stats.py:64"
QUANT_SOURCE = "pytorch_distributed_nn_tpu_torch/csrc/quantize.cu"
QUANT_TPU = "pytorch_distributed_nn_tpu/ops/pallas/quantize.py:33"
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
# per-channel sums, kernel or plain version, against an f64 sum: f32
# summation error for these lengths stays well inside 1e-5 of sum|term|
BN_TOL = 1e-5
# one full-width ResNet-50 step, bn_stats kernel vs the torch reductions
# (bn_impl pallas vs flax) from the same weights and batch: the sums round
# in another order, and a bf16 activation may round to its neighbour, which
# 53 BatchNorms carry into every gradient. The backward's raw moments
# (sum dy*x - mean * sum dy, the JAX formula) cancel where a channel's mean
# is large against its spread, so even in f32 a last-bit difference in the
# sums grows to percents in a few gradient elements
DP_LOSS_TOL = 1e-3  # relative
DP_GRAD_TOL = 5e-2  # max|err| / max|ref|, per parameter
DP_BATCH = 256  # one card's share of the preset's 1024 on a four-card mesh
RESNET_BN_PER_STEP = 53
DP_OVERRIDES = {"parallel.strategy": "dp_explicit",
                "parallel.quantized_allreduce": "int8",
                "model.extra": json.dumps({"bn_impl": "pallas"}),
                "data.batch_size": str(DP_BATCH), "log_every": "1"}


def resnet50_bn_shapes(batch, image=224):
    """(M, C) of the 53 BatchNorms of ResNet-50 at ``batch``, in forward
    order: the stem's, then each bottleneck's bn1, bn2, bn3 (and bn_proj)."""
    h = image // 2
    shapes = [(batch * h * h, 64)]
    h //= 2
    ch = 64
    for stage, n in enumerate((3, 4, 6, 3)):
        f = 64 * 2 ** stage
        for block in range(n):
            stride = 2 if stage > 0 and block == 0 else 1
            ho = (h - 1) // stride + 1
            shapes += [(batch * h * h, f), (batch * ho * ho, f),
                       (batch * ho * ho, 4 * f)]
            if ch != 4 * f or stride != 1:
                shapes.append((batch * ho * ho, 4 * f))
            h, ch = ho, 4 * f
    return shapes


def bn_counts():
    from pytorch_distributed_nn_tpu_torch.ops import bn_stats

    return {"sum_and_sumsq": bn_stats.sum_and_sumsq.launches,
            "sum_and_dot": bn_stats.sum_and_dot.launches}


def quantize_count():
    from pytorch_distributed_nn_tpu_torch.ops import quantize as tq

    return tq.quantize_int8.launches


def reset_dp_counts():
    from pytorch_distributed_nn_tpu_torch.ops import bn_stats
    from pytorch_distributed_nn_tpu_torch.ops import quantize as tq

    bn_stats.sum_and_sumsq.launches = 0
    bn_stats.sum_and_dot.launches = 0
    bn_stats.copies = 0
    tq.quantize_int8.launches = 0


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bn_check(name, got, ref64, mag):
    err = (got.double() - ref64).abs()
    worst = float((err / mag.clamp(min=1e-300)).max())
    if not bool((err <= BN_TOL * mag).all()):
        raise AssertionError(f"{name}: per-channel |err| / sum|term| "
                             f"{worst:.3e} > {BN_TOL}")
    return float(err.max()), worst


def phase_bn_stats():
    """bn_stats at ResNet-50's largest and smallest BatchNorm at batch 256
    and one ragged M, bf16 and f32: kernel and plain version against an
    f64 sum; then the 53 forward and 53 backward calls of one training
    step at their shapes, timed for the kernel, the plain version and the
    library (torch.batch_norm_stats / batch_norm_backward_reduce)."""
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import bn_stats

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(3)
    rows, max_err, worst_rel = [], 0.0, 0.0
    for m, c in ((DP_BATCH * 112 * 112, 64), (DP_BATCH * 7 * 7, 2048),
                 (200_003, 96)):
        for dtype in (torch.bfloat16, torch.float32):
            a = (torch.randn((m, c), generator=g, device=dev) + 0.5).to(dtype)
            b = torch.randn((m, c), generator=g, device=dev).to(dtype)
            a64, b64 = a.double(), b.double()
            want = {"s1": a64.sum(0), "sq": (a64 * a64).sum(0),
                    "dot": (a64 * b64).sum(0)}
            mag = {"s1": a64.abs().sum(0), "sq": want["sq"],
                   "dot": (a64 * b64).abs().sum(0)}
            del a64, b64
            outs = {"kernel": (bn_stats.sum_and_sumsq(a),
                               bn_stats.sum_and_dot(a, b)),
                    "plain": (bn_stats.sum_and_sumsq_reference(a),
                              bn_stats.sum_and_dot_reference(a, b))}
            torch.cuda.synchronize()
            for who, ((s1, s2), (d1, d2)) in outs.items():
                for key, got in (("s1", s1), ("sq", s2), ("s1", d1),
                                 ("dot", d2)):
                    err, rel = bn_check(f"bn_stats {who} {key} ({m}, {c}) "
                                        f"{dtype}", got, want[key], mag[key])
                    if who == "kernel":
                        max_err, worst_rel = max(max_err, err), max(worst_rel,
                                                                     rel)
            again = bn_stats.sum_and_dot(a, b)
            if not (torch.equal(again[0], outs["kernel"][1][0])
                    and torch.equal(again[1], outs["kernel"][1][1])):
                raise AssertionError("bn_stats is not bitwise repeatable")
            nbytes = m * c * a.element_size()
            row = dict(m=m, c=c, dtype=str(dtype).split(".")[-1],
                       fwd_ms=time_ms(lambda: bn_stats.sum_and_sumsq(a), 10),
                       bwd_ms=time_ms(lambda: bn_stats.sum_and_dot(a, b), 10),
                       fwd_bound_ms=bound(nbytes, 3 * m * c)[0],
                       bwd_bound_ms=bound(2 * nbytes, 3 * m * c)[0])
            rows.append(row)
            log(f"[bn_stats] {json.dumps(row)}")
            del a, b, outs, again, want, mag
            torch.cuda.empty_cache()

    # one training step's 106 calls at ResNet-50's shapes, bf16
    shapes = resnet50_bn_shapes(DP_BATCH)
    if len(shapes) != RESNET_BN_PER_STEP:
        raise AssertionError(f"{len(shapes)} BatchNorm shapes")
    big = max(m * c for m, c in shapes)
    a = torch.randn((big,), generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn((big,), generator=g, device=dev).to(torch.bfloat16)

    def views(t):
        return [t[:m * c].view(m, c) for m, c in shapes]

    def nchw(t, m, c):  # the (M, C) matrix as channels_last (N, C, H, W)
        hw = m // DP_BATCH
        side = int(round(hw ** 0.5))
        return t[:m * c].view(DP_BATCH, side, side, c).permute(0, 3, 1, 2)

    av, bv = views(a), views(b)
    a4 = [nchw(a, m, c) for m, c in shapes]
    b4 = [nchw(b, m, c) for m, c in shapes]

    def loop(fn, xs, ys=None):
        def run():
            for i, x in enumerate(xs):
                fn(x) if ys is None else fn(x, ys[i])
        return run

    t = {"kernel_fwd": time_ms(loop(bn_stats.sum_and_sumsq, av), 10),
         "kernel_bwd": time_ms(loop(bn_stats.sum_and_dot, av, bv), 10),
         "plain_fwd": time_ms(loop(bn_stats.sum_and_sumsq_reference, av), 3),
         "plain_bwd": time_ms(loop(bn_stats.sum_and_dot_reference, av, bv),
                              3)}
    try:
        stats = [torch.batch_norm_stats(x, 1e-5) for x in a4]
        t["library_fwd"] = time_ms(
            loop(lambda x: torch.batch_norm_stats(x, 1e-5), a4), 10)
        t["library_bwd"] = time_ms(lambda: [
            torch.batch_norm_backward_reduce(dy, x, mu, inv, None, True,
                                             False, False)
            for dy, x, (mu, inv) in zip(b4, a4, stats)], 10)
    except RuntimeError as e:  # a yardstick only: report it as missing
        log(f"[bn_stats] library call failed: {e}")
        t["library_fwd"] = t["library_bwd"] = None
    el = sum(m * c for m, c in shapes)
    b_fwd = bound(2 * el + 8 * sum(c for _, c in shapes), 3 * el)
    b_bwd = bound(4 * el + 8 * sum(c for _, c in shapes), 3 * el)
    step = dict(calls=2 * len(shapes), elements=el,
                ms=t["kernel_fwd"] + t["kernel_bwd"],
                plain_ms=t["plain_fwd"] + t["plain_bwd"],
                library_ms=(None if t["library_fwd"] is None
                            else t["library_fwd"] + t["library_bwd"]),
                bound_ms=b_fwd[0] + b_bwd[0], bound_by=b_fwd[1],
                fwd_bound_ms=b_fwd[0], bwd_bound_ms=b_bwd[0], **t)
    log(f"[bn_stats] one step's 53 + 53 calls at batch {DP_BATCH}, bf16: "
        f"{json.dumps(step)}")
    del a, b, av, bv, a4, b4
    torch.cuda.empty_cache()
    return dict(shapes=rows, step=step, max_abs_err=max_err,
                worst_rel_err=worst_rel)


def bucket_sizes(model=None):
    """Element counts of the f32 buckets of ``model``'s gradient (ResNet-50
    by default) at the preset's bucket_mb = 25, in reduction order
    (ops/buckets.py's plan)."""
    import torch

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.models import get_model
    from pytorch_distributed_nn_tpu_torch.ops.buckets import bucket_plan

    cfg = get_config("resnet50_dp")
    if model is None:
        model = get_model(cfg.model, device="meta")
    shapes = {n: (p.shape, p.dtype) for n, p in model.named_parameters()}
    plan = bucket_plan(shapes, int(cfg.parallel.bucket_mb * 1024 * 1024))
    return [sum(shapes[n][0].numel() for n in names)
            for dtype, names in plan if dtype == torch.float32]


def phase_quantize():
    """The stochastic int8 kernel on a 25 MB bucket and on the whole
    ResNet-50 gradient: bit for bit its plain version, within one code
    step of x, unbiased to 4 sigma, saturating past 127 scale; the
    kernel and the plain version timed over one step's buckets."""
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import quantize as tq

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(4)
    sizes = bucket_sizes()
    total = sum(sizes)
    checks = {}
    for label, n in (("bucket_25MB", 25 * 2 ** 20 // 4),
                     ("resnet50_gradient", total)):
        x = torch.randn((n,), generator=g, device=dev) * 1e-3
        scale = (x.abs().max() / 127.0).clamp(min=1e-12)
        q = tq.quantize_int8(x, scale, seed=n)
        ref = tq.quantize_int8_reference(x, scale, seed=n)
        torch.cuda.synchronize()
        if not torch.equal(q, ref):
            diff = int((q != ref).sum())
            raise AssertionError(f"quantize {label}: {diff} codes differ "
                                 "from the plain version")
        err = q.float() * scale - x
        worst = float(err.abs().max() / scale)
        if not worst < 1.0:
            raise AssertionError(f"quantize {label}: |q scale - x| / scale "
                                 f"{worst} >= 1")
        mean = float(err.double().mean() / scale)
        limit = 4 * 0.5 / n ** 0.5  # 4 sigma, sigma <= scale / 2 each
        if not abs(mean) <= limit:
            raise AssertionError(f"quantize {label}: mean error {mean} "
                                 f"scale, limit {limit}")
        small = scale / 4  # values past 127 * small saturate
        qs = tq.quantize_int8(x, small, seed=1)
        over = x >= 127 * small
        under = x <= -127 * small
        if not (bool((qs[over] == 127).all())
                and bool((qs[under] == -127).all())
                and int(over.sum()) > 0):
            raise AssertionError(f"quantize {label}: no saturation")
        checks[label] = dict(n=n, worst_err_over_scale=worst,
                             mean_err_over_scale=mean, mean_limit=limit,
                             saturated=int(over.sum() + under.sum()))
        log(f"[quantize] {label}: bitwise equal to the plain version; "
            f"{json.dumps(checks[label])}")
        del x, q, ref, err, qs
    torch.cuda.empty_cache()
    # one step: one call a bucket, on the bucket's slice of the gradient
    grad = torch.randn((total,), generator=g, device=dev) * 1e-3
    scale = (grad.abs().max() / 127.0).reshape(())
    parts = list(torch.split(grad, sizes))

    def step(fn):
        def run():
            for i, part in enumerate(parts):
                fn(part, scale, seed=i)
        return run

    ms = time_ms(step(tq.quantize_int8), 20)
    plain_ms = time_ms(step(tq.quantize_int8_reference), 3)
    # the five launches' own device time, without the host's launch gaps
    device_ms = kernel_device_ms(step(tq.quantize_int8), 5,
                                 "quantize_kernel")
    b = bound(5 * total, 4 * total)
    row = dict(buckets=len(sizes), elements=total, ms=ms,
               device_ms=device_ms, plain_ms=plain_ms,
               bound_ms=b[0], bound_by=b[1], checks=checks)
    log(f"[quantize] one step's {len(sizes)} buckets: {json.dumps(row)}")
    del grad, parts
    torch.cuda.empty_cache()
    return row


def resnet_trainer(**overrides):
    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    cfg = get_config("resnet50_dp", **overrides)
    return Trainer(cfg, device="cuda")  # seeded init (cfg.seed)


def grad_rel_err(got, ref):
    """max|err| / max|ref| of one gradient; a gradient that is zero in the
    reference (the residual branches behind a zero-initialised bn3 scale)
    must be zero in the other run too."""
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if scale == 0.0:
        return 0.0 if err == 0.0 else math.inf
    return err / scale


def phase_dp_check():
    """One full-width ResNet-50 step (batch 256) with the bn_stats kernel
    and with the torch reductions, from the same weights and batch: the
    loss and every gradient before the reduce, in the main path's bf16
    compute and in f32 (where no bf16 rounding of the activations can
    flip between the two runs, and the kernel's sums are all that
    differs)."""
    import torch

    from pytorch_distributed_nn_tpu_torch.parallel import dp

    from pytorch_distributed_nn_tpu_torch.ops import bn_stats

    plain = (bn_stats.sum_and_sumsq_reference, bn_stats.sum_and_dot_reference)

    def f64_sums():  # the sums taken in f64, rounded once to f32
        def sumsq(x, dim=-1):
            x64 = x.double()
            dims = bn_stats._reduce_dims(x, dim)
            return x64.sum(dims).float(), (x64 * x64).sum(dims).float()

        def dot(a, b, dim=-1):
            a64 = a.double()
            dims = bn_stats._reduce_dims(a, dim)
            return (a64.sum(dims).float(),
                    (a64 * b.double()).sum(dims).float())
        return sumsq, dot

    result = {}
    for dtype in ("bfloat16", "float32"):
        trainer = resnet_trainer(**DP_OVERRIDES,
                                 **{"model.compute_dtype": dtype})
        x, y = trainer.loader.batch_at(0)
        out = {}
        for impl in ("pallas", "flax", "f64"):
            trainer.model.set_bn_impl("flax" if impl == "f64" else impl)
            if impl == "f64":  # the check only: restored just below
                (bn_stats.sum_and_sumsq_reference,
                 bn_stats.sum_and_dot_reference) = f64_sums()
            reset_dp_counts()
            try:
                loss = dp._loss_and_grads(trainer.state, x, y,
                                          trainer.loss_fn).item()
            finally:
                (bn_stats.sum_and_sumsq_reference,
                 bn_stats.sum_and_dot_reference) = plain
            counts = bn_counts()
            grads = {n: p.grad.clone()
                     for n, p in trainer.model.named_parameters()}
            trainer.state.optimizer.zero_grad()
            out[impl] = (loss, grads, counts)
        per = RESNET_BN_PER_STEP
        if out["pallas"][2] != {"sum_and_sumsq": per, "sum_and_dot": per}:
            raise AssertionError(f"bn_stats launches in one step: "
                                 f"{out['pallas'][2]}")
        if any(out["flax"][2].values()):
            raise AssertionError("the flax BatchNorm launched bn_stats")
        loss_k, grads_k, _ = out["pallas"]
        loss_p, grads_p, _ = out["flax"]
        loss_err = abs(loss_k - loss_p) / abs(loss_p)
        grad_err = {n: grad_rel_err(grads_k[n], gp)
                    for n, gp in grads_p.items()}
        worst = max(grad_err, key=grad_err.get)
        # the same worst tensor by norms, for scale: max|err| is set by a
        # few elements where a ReLU mask flipped
        norm_err = ((grads_k[worst] - grads_p[worst]).float().norm()
                    / grads_p[worst].float().norm()).item()
        zero = sum(1 for g in grads_p.values() if not bool(g.any()))
        log(f"[dp_check] ResNet-50 batch {DP_BATCH}, {dtype}, bn_stats "
            f"kernel vs torch reductions: loss {loss_k:.6f} vs {loss_p:.6f} "
            f"(rel {loss_err:.3e}); worst gradient {worst} max|err|/max|ref| "
            f"{grad_err[worst]:.3e} (limit {DP_GRAD_TOL}), |err|/|ref| "
            f"{norm_err:.3e}; {zero} of {len(grads_p)} gradients are zero "
            "in both")
        result[dtype] = dict(loss_rel_err=loss_err, worst_grad=worst,
                             worst_grad_rel_err=grad_err[worst],
                             worst_grad_norm_rel_err=norm_err,
                             zero_grads=zero)
        # how far each run is from the same step with f64 sums: which of
        # the two is nearer the exact sums
        g64 = out["f64"][1]
        vs = {who: max(grad_rel_err(g[n], g64[n]) for n in g64)
              for who, g in (("kernel", grads_k), ("torch", grads_p))}
        result[dtype]["worst_vs_f64_sums"] = vs
        log(f"[dp_check] {dtype}, worst gradient max|err|/max|ref| against "
            f"the step with f64 sums: kernel {vs['kernel']:.3e}, torch "
            f"reductions {vs['torch']:.3e}")
        if not (math.isfinite(loss_k) and loss_err <= DP_LOSS_TOL
                and grad_err[worst] <= DP_GRAD_TOL):
            raise AssertionError("the bn_stats step disagrees with the "
                                 f"torch reductions ({dtype}; limits "
                                 f"{DP_LOSS_TOL}, {DP_GRAD_TOL})")
        del trainer, out, grads_k, grads_p, x, y
        torch.cuda.empty_cache()
    return result


def _top_level(events, key):
    """Events whose name contains ``key`` and no ancestor's does."""
    out = []
    for e in events:
        if key not in e.name:
            continue
        p = e.cpu_parent
        while p is not None and key not in p.name:
            p = p.cpu_parent
        if p is None:
            out.append(e)
    return out


def profile_dp_step(trainer):
    """Device time of one dp_explicit step by torch.profiler, split into
    convolutions, BatchNorm elementwise passes, bn_stats, quantize, NCCL,
    the optimizer and the rest; None where the profiler records no device
    activity. Measurement only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   acc_events=True)
    try:
        prof.start()
    except RuntimeError as e:
        log(f"[dp_train] profiler did not start: {e}")
        return None
    try:
        trainer.train(steps=1)
        torch.cuda.synchronize()
    finally:
        stopped = _profiler_stop(prof)
    if not stopped:
        return None
    events = prof.events()
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return None
    fams, names = {}, {}
    for e in kern:
        low = e.name.lower()
        fam = ("bn_stats" if "bn_partial" in low or "bn_finish" in low
               else "quantize" if "quantize_kernel" in low
               else "nccl" if "nccl" in low
               else "optimizer" if "multi_tensor" in low or "foreach" in low
               else "conv" if any(k in low for k in (
                   "conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad",
                   "fprop", "gemm", "nvjet", "cutlass", "nhwc", "nchw"))
               else "other")
        ms = e.time_range.elapsed_us() / 1e3
        fams[fam] = fams.get(fam, 0.0) + ms
        n, t = names.get(e.name[:96], (0, 0.0))
        names[e.name[:96]] = (n + 1, t + ms)
    # the BatchNorm autograd Function's forward and backward: their device
    # time, less the bn_stats kernels, is the elementwise passes
    bn_fn = _top_level(events, "_BatchNormTrain")
    bn_ms = sum(e.device_time_total for e in bn_fn) / 1e3
    elementwise = bn_ms - fams.get("bn_stats", 0.0) if bn_fn else None
    if elementwise is not None:
        fams["other"] -= elementwise
        fams["bn_elementwise"] = elementwise
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:12]
    return dict(kernels=len(kern), device_ms=sum(fams.values()),
                by_family_ms=fams, batchnorm_function_events=len(bn_fn),
                top_kernels=[dict(name=k, calls=n, ms=t)
                             for k, (n, t) in top])


def step_stats(trainer, steps):
    secs = sorted(r.seconds for r in trainer.history[-steps:])
    med = (secs[(steps - 1) // 2] + secs[steps // 2]) / 2
    wait = sum(r.data_wait for r in trainer.history[-steps:]) / steps
    return med, wait


def phase_dp_train():
    """The main path: resnet50_dp at full width, dp_explicit with the int8
    wire and bn_impl=pallas, batch 256 on one card (NCCL, world 1): 2
    warm-up steps, 4 timed steps with the launch counts reset just before
    and read just after, one profiled step, one step on the exact wire
    for its bytes."""
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import bn_stats
    from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
    from pytorch_distributed_nn_tpu_torch.parallel.api import make_train_step
    from pytorch_distributed_nn_tpu_torch.utils.flops import (
        resnet_train_flops_per_example,
    )

    trainer = resnet_trainer(**DP_OVERRIDES)
    if (trainer.process.backend, trainer.process.world_size) != ("nccl", 1):
        raise AssertionError(f"process group {trainer.process}")
    buckets = len(bucket_sizes(trainer.model))
    trainer.train(steps=2)  # warm-up: cuDNN picks its algorithms
    steps = 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_dp_counts()  # the main path's count starts here
    with cc.recording() as recs:
        trainer.train(steps=steps)
    counts = bn_counts()
    q_launches = quantize_count()
    copies = bn_stats.copies
    peak = torch.cuda.max_memory_allocated()
    want = {"sum_and_sumsq": RESNET_BN_PER_STEP * steps,
            "sum_and_dot": RESNET_BN_PER_STEP * steps}
    if counts != want or q_launches != buckets * steps:
        raise AssertionError(f"launches {counts}, quantize {q_launches} in "
                             f"{steps} steps; expected {want} and "
                             f"{buckets * steps}")
    losses = trainer.losses()[-steps:]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"losses {losses}")
    step_s, wait_s = step_stats(trainer, steps)
    flops = DP_BATCH * resnet_train_flops_per_example()
    payload_int8 = cc.payload_bytes(recs) / steps
    prof = profile_dp_step(trainer)
    if prof is not None:
        prof["idle_share_vs_unprofiled_step"] = (
            1 - prof["device_ms"] / (step_s * 1e3))
    # one step on the exact wire, for its bytes (the same weights go on)
    exact = trainer.cfg.override(**{"parallel.quantized_allreduce": ""})
    trainer.step_fn, _ = make_train_step(exact, trainer.loss_fn)
    with cc.recording() as recs_exact:
        trainer.train(steps=1)
    payload_exact = cc.payload_bytes(recs_exact)
    result = dict(
        batch=DP_BATCH, steps=steps, losses=losses, median_step_s=step_s,
        step_s=[r.seconds for r in trainer.history[-steps - 2:-2]],
        images_per_s=DP_BATCH / step_s, model_tflop_per_step=flops / 1e12,
        mfu=flops / step_s / BF16_OPS_PER_S, peak_mem_gb=peak / 1e9,
        loader_wait_s_per_step=wait_s, launches=counts,
        quantize_launches=q_launches, f32_buckets=buckets,
        bn_input_copies=copies,
        payload_bytes_per_step={"int8": payload_int8,
                                "exact": payload_exact},
        ring_wire_bytes_per_rank_at_4={
            "int8": cc.ring_wire_bytes("all_reduce", payload_int8, 4),
            "exact": cc.ring_wire_bytes("all_reduce", payload_exact, 4)},
        wire_bytes_per_step_at_1=cc.wire_bytes(recs) / steps,
        profile=prof)
    log(f"[dp_train] {json.dumps(result)}")
    del trainer
    torch.cuda.empty_cache()
    return result, counts, q_launches


def phase_dp_preset():
    """The preset as it is (dp, flax BatchNorm, exact reduce) at batch 256:
    one warm-up step and 4 timed; then mlp_mnist as it is, 20 steps."""
    import torch

    trainer = resnet_trainer(**{"data.batch_size": str(DP_BATCH),
                                "log_every": "1"})
    reset_dp_counts()
    trainer.train(steps=5)
    if any(bn_counts().values()) or quantize_count():
        raise AssertionError("the preset as it is launched a dp kernel")
    losses = trainer.losses()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"losses {losses}")
    step_s, wait_s = step_stats(trainer, 4)
    preset = dict(losses=losses, median_step_s=step_s,
                  images_per_s=DP_BATCH / step_s,
                  loader_wait_s_per_step=wait_s)
    log(f"[dp_preset] resnet50_dp as it is, batch {DP_BATCH}: "
        f"{json.dumps(preset)}")
    del trainer
    torch.cuda.empty_cache()

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    mlp = Trainer(get_config("mlp_mnist", log_every="1"), device="cuda")
    mlp.train(steps=20)
    ml = mlp.losses()
    if not (len(ml) == 20 and all(math.isfinite(v) for v in ml)
            and ml[-1] < ml[0]):
        raise AssertionError(f"mlp_mnist losses {ml}")
    step_s, _ = step_stats(mlp, 19)
    mlp_row = dict(first_loss=ml[0], last_loss=ml[-1], median_step_s=step_s)
    log(f"[dp_preset] mlp_mnist 20 steps: {json.dumps(mlp_row)}")
    return dict(resnet50_dp=preset, mlp_mnist=mlp_row)


# ---------------------------------------------------------------------------
# rule 3: config 4's transformer LM at head_dim 64 on the flash kernels, and
# config 3's BERT-base with the overlapped bucket reduce
# ---------------------------------------------------------------------------
# transformer_lm_pp's attention: B 64, T 1024, 12 heads of 64, causal
LM_B, LM_T, LM_H, LM_D = 64, 1024, 12, 64
LM_OVERRIDES = {"mesh.pipe": "1", "parallel.strategy": "dp",
                "log_every": "1"}
BERT_BATCH, BERT_T = 256, 128  # bert_base_buckets as it is


def flash64_inputs(seed):
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    return [torch.randn((LM_B, LM_T, LM_H, LM_D), generator=g,
                        device="cuda").to(torch.bfloat16) for _ in range(4)]


def phase_flash64(flush):
    """The three flash kernels at the transformer LM's shapes (B 64, T 1024,
    H = Hkv = 12, D 64, causal), every output in full against the plain
    versions (16 rows of the batch at a time); times of each kernel, its
    plain version, its bound and SDPA's forward and backward."""
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa

    q, k, v, do = flash64_inputs(seed=64)
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.flash_delta(o, do)
    args = (q, k, v, do, lse, delta, True)
    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    rows = 16  # batch rows a plain-version call takes

    def plain(name):
        """The plain version over the whole batch, ``rows`` at a time."""
        outs = []
        for b0 in range(0, LM_B, rows):
            b, h = slice(b0, b0 + rows), slice(b0 * LM_H, (b0 + rows) * LM_H)
            sub = (q[b], k[b], v[b], do[b], lse[h], delta[h], True)
            outs.append(fa.flash_forward_reference(*sub[:3], True)
                        if name == "flash_fwd"
                        else fa.flash_bwd_dq_reference(*sub)
                        if name == "flash_bwd_dq"
                        else fa.flash_bwd_dkv_reference(*sub))
        return outs

    ref = plain("flash_fwd")
    o_ref = torch.cat([r[0] for r in ref])
    lse_ref = torch.cat([r[1] for r in ref])
    errs = {"flash_fwd": flash_check("flash_fwd O, D=64", o, o_ref)}
    lse_err = (lse - lse_ref).abs().max().item()
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"flash_fwd lse, D=64: {lse_err} > {LSE_TOL}")
    errs["flash_bwd_dq"] = flash_check("flash_bwd_dq, D=64", dq,
                                       torch.cat(plain("flash_bwd_dq")))
    ref = plain("flash_bwd_dkv")
    errs["flash_bwd_dkv"] = worst(
        flash_check("flash_bwd_dkv dk, D=64", dk,
                    torch.cat([r[0] for r in ref])),
        flash_check("flash_bwd_dkv dv, D=64", dv,
                    torch.cat([r[1] for r in ref])))
    del ref, o_ref, lse_ref
    torch.cuda.empty_cache()
    kern = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, True),
            "flash_bwd_dq": lambda: fa.flash_bwd_dq(*args),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(*args)}
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    with torch.no_grad():
        lib_fwd = time_ms(sdpa, 10, flush)
    out_t = sdpa()
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out_t, (qt, kt, vt), dot, retain_graph=True), 10, flush)
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd,
               "flash_bwd_dkv": lib_bwd}
    out = {}
    for name in FLASH_KERNELS:
        ms = time_ms(kern[name], 10, flush)
        plain_ms = time_once_ms(lambda name=name: plain(name))
        torch.cuda.empty_cache()
        bound, by = flash_bound_ms(name, LM_T, LM_B, LM_H, LM_H, LM_D)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library[name],
                         bound_ms=bound, bound_by=by, card=card_line(),
                         share_of_bound=bound / ms, **errs[name],
                         tflops=FLASH_KERNELS[name][1] * LM_B * LM_H * LM_T
                         * LM_T * LM_D / ms / 1e9)
        log(f"[flash64] {name} B={LM_B} T={LM_T} H={LM_H} D={LM_D}: "
            f"{json.dumps(out[name])}")
    log(f"[flash64] lse max|err| {lse_err:.3e}; library yardstick: "
        "F.scaled_dot_product_attention(is_causal=True) forward, and its "
        "backward (dq, dk and dv in one call)")
    del qt, kt, vt, out_t, q, k, v, do, o, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()
    return out


def _family(name):
    """A CUDA kernel's family for the step breakdowns."""
    low = name.lower()
    for fam, keys in (("flash_fwd", ("flash_fwd",)),
                      ("flash_bwd_dq", ("flash_bwd_dq",)),
                      ("flash_bwd_dkv", ("flash_bwd_dkv",)),
                      ("quantize", ("quantize_kernel",)),
                      ("nccl", ("nccl",)),
                      ("optimizer", ("multi_tensor", "foreach")),
                      ("gemm", ("gemm", "cutlass", "xmma", "nvjet")),
                      ("softmax", ("softmax",)),
                      ("reduce", ("reduce",))):
        if any(k in low for k in keys):
            return fam
    return "other"


# spin kernels (``torch.cuda._sleep``, which nothing else launches) set
# before and after the profiled work: torch.profiler can lose the first
# records of a session, and then loses these rather than the work's
MARGIN_KERNELS = 32


def _margin():
    import torch

    for _ in range(MARGIN_KERNELS):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def _without_margin(kern):
    """The device events ``kern`` less the spin kernels of :func:`_margin`,
    and how many of those the trace holds before and after the work."""
    spins = [e.time_range.start for e in kern if "spin_kernel" in e.name]
    kern = [e for e in kern if "spin_kernel" not in e.name]
    first = min((e.time_range.start for e in kern), default=0)
    return kern, dict(before=sum(1 for t in spins if t < first),
                      after=sum(1 for t in spins if t >= first))


def profile_step(trainer, steps=1, count=None):
    """Device time of ``steps`` training steps (one dispatch of a multistep
    trainer: ``steps`` = its k) by torch.profiler, by kernel family
    (:func:`_family`) and the top kernels; with ``count`` ({label: regex}),
    the number of device kernels whose name matches each regex. The steps
    are set between :func:`_margin`'s spin kernels, which are left out of
    every figure but their own count. None where the profiler records no
    device activity. Measurement only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA], acc_events=True)
    try:
        prof.start()
    except RuntimeError as e:
        log(f"[profile] profiler did not start: {e}")
        return None
    try:
        _margin()
        trainer.train(steps=steps)
        torch.cuda.synchronize()
        _margin()
    finally:
        stopped = _profiler_stop(prof)
    if not stopped:
        return None
    kern, margin = _without_margin(
        [e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA])
    if not kern:
        return None
    fams, names = {}, {}
    for e in kern:
        ms = e.time_range.elapsed_us() / 1e3
        fam = _family(e.name)
        fams[fam] = fams.get(fam, 0.0) + ms
        n, t = names.get(e.name[:96], (0, 0.0))
        names[e.name[:96]] = (n + 1, t + ms)
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:15]
    out = dict(kernels=len(kern), device_ms=sum(fams.values()),
               margin_kernels_seen=margin, by_family_ms=fams,
               top_kernels=[dict(name=k, calls=n, ms=t)
                            for k, (n, t) in top])
    if count:
        out["counted"] = {label: sum(1 for e in kern
                                     if re.search(rx, e.name))
                          for label, rx in count.items()}
    return out


def lm_trainer(**overrides):
    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    cfg = get_config("transformer_lm_pp", **{**LM_OVERRIDES, **overrides})
    return Trainer(cfg, device="cuda")  # seeded init (cfg.seed)


def train_report(trainer, steps, flops_per_token, tokens, peak,
                 count=None):
    """Step time, tokens/s, MFU and peak memory of the last ``steps``
    steps, and one more step under torch.profiler (``count``: as
    :func:`profile_step`'s)."""
    step_s, wait_s = step_stats(trainer, steps)
    flops = flops_per_token * tokens
    out = dict(card=card_line(), steps=steps,
               losses=trainer.losses()[-steps:],
               step_s=[r.seconds for r in trainer.history[-steps:]],
               median_step_s=step_s, loader_wait_s_per_step=wait_s,
               tokens_per_s=tokens / step_s,
               model_gflop_per_token=flops_per_token / 1e9,
               model_tflop_per_step=flops / 1e12,
               mfu=flops / step_s / BF16_OPS_PER_S, peak_mem_gb=peak / 1e9)
    prof = profile_step(trainer, count=count)
    if prof is not None:
        prof["idle_share_vs_unprofiled_step"] = (
            1 - prof["device_ms"] / (step_s * 1e3))
    out["profile"] = prof
    return out


def lm_grad_errors(got, ref):
    """max|err| / max|ref| of each gradient of ``got`` against ``ref``. The
    attention key biases are held otherwise: softmax is invariant to a
    shift of a row's logits, so their exact gradient is zero and both runs
    hold only rounding noise; each is held, in both runs, to the same
    layer's key-kernel gradient (max|g_bias| / max|g_kernel|)."""
    out = {}
    for n, g in ref.items():
        if n.endswith("attn.key.bias"):
            kernel = ref[n[:-len("bias")] + "kernel"].float().abs().max()
            out[n] = max(got[n].float().abs().max().item(),
                         g.float().abs().max().item()) / kernel.item()
        else:
            out[n] = grad_rel_err(got[n], g)
    return out


def phase_lm_d64():
    """transformer_lm_pp with --mesh.pipe 1 --parallel.strategy dp at its
    full width and batch (12 layers, d 768, 12 heads of 64, vocab 32000,
    B 64, T 1024, remat, adam): one step's loss and every gradient with
    the flash kernels against the plain attention from the same weights
    and batch; then one warm-up and 4 timed steps with the flash counts
    reset just before and read just after (24 forward, 12 dq, 12 dk/dv a
    step); one more step under torch.profiler."""
    import torch

    from pytorch_distributed_nn_tpu_torch.parallel import dp
    from pytorch_distributed_nn_tpu_torch.utils.flops import (
        transformer_train_flops_per_token,
    )

    trainer = lm_trainer()
    model, cfg = trainer.model, trainer.cfg
    L = model.num_layers
    if (model.head_dim, cfg.data.batch_size, cfg.data.seq_len) != (
            LM_D, LM_B, LM_T) or not cfg.model.remat:
        raise AssertionError(f"transformer_lm_pp at {model.head_dim}, "
                             f"{cfg.data.batch_size}, {cfg.data.seq_len}")
    x, y = trainer.loader.batch_at(0)
    out = {}
    for impl in ("auto", "xla"):
        for i in range(L):
            getattr(model, f"block{i}").attn.impl = impl
        reset_flash_counts()
        loss = dp._loss_and_grads(trainer.state, x, y,
                                  trainer.loss_fn).item()
        counts = flash_counts()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        trainer.state.optimizer.zero_grad()
        out[impl] = (loss, grads, counts)
    if out["auto"][2] != {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                          "flash_bwd_dkv": L}:
        raise AssertionError(f"flash launches in one step: {out['auto'][2]}")
    if any(out["xla"][2].values()):
        raise AssertionError("the plain step launched a flash kernel")
    loss_f, grads_f, _ = out["auto"]
    loss_x, grads_x, _ = out["xla"]
    loss_err = abs(loss_f - loss_x) / abs(loss_x)
    grad_err = lm_grad_errors(grads_f, grads_x)
    worst_g = max(grad_err, key=grad_err.get)
    log(f"[lm_d64] one step, flash vs plain attention: loss {loss_f:.6f} vs "
        f"{loss_x:.6f} (rel {loss_err:.3e}); worst gradient {worst_g} "
        f"max|err|/max|ref| {grad_err[worst_g]:.3e}")
    if not (math.isfinite(loss_f) and loss_err <= TRAIN_LOSS_TOL
            and grad_err[worst_g] <= TRAIN_GRAD_TOL):
        raise AssertionError("the flash LM step disagrees with the plain "
                             f"attention (limits {TRAIN_LOSS_TOL}, "
                             f"{TRAIN_GRAD_TOL})")
    del out, grads_f, grads_x
    for i in range(L):
        getattr(model, f"block{i}").attn.impl = "auto"
    torch.cuda.empty_cache()
    trainer.train(steps=1)  # warm-up
    steps = 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()  # the path's count starts here
    trainer.train(steps=steps)
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_fwd": 2 * L * steps, "flash_bwd_dq": L * steps,
            "flash_bwd_dkv": L * steps}
    if launches != want:
        raise AssertionError(f"flash launches {launches} in {steps} steps, "
                             f"expected {want}")
    losses = trainer.losses()[-steps:]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"losses {losses}")
    per_token = transformer_train_flops_per_token(model, LM_T, causal=True)
    report = train_report(trainer, steps, per_token, LM_B * LM_T, peak)
    result = dict(check=dict(loss_rel_err=loss_err, worst_grad=worst_g,
                             worst_grad_rel_err=grad_err[worst_g]),
                  launches=launches, losses=losses, **{
                      k: v for k, v in report.items() if k != "losses"})
    log(f"[lm_d64] {json.dumps(result)}")
    del trainer, model
    torch.cuda.empty_cache()
    return result, launches


def bert_trainer(**overrides):
    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    cfg = get_config("bert_base_buckets", log_every="1", **overrides)
    return Trainer(cfg, device="cuda")  # seeded init (cfg.seed)


def bert_components(model):
    """CUDA-event medians (5 runs, forward + backward) of three parts of the
    BERT step at the main path's shapes: the plain attention of the 12
    layers, the f32 mlm_decoder head and the masked-LM loss."""
    import torch

    from pytorch_distributed_nn_tpu_torch.nn.attention import (
        dot_product_attention,
    )
    from pytorch_distributed_nn_tpu_torch.train.losses import masked_lm_xent

    g = torch.Generator("cuda").manual_seed(3)
    H, D = model.num_heads, model.head_dim
    qkv = [torch.randn((BERT_BATCH, BERT_T, H, D), generator=g,
                       device="cuda").to(torch.bfloat16).requires_grad_()
           for _ in range(3)]
    do = torch.randn((BERT_BATCH, BERT_T, H, D), generator=g,
                     device="cuda").to(torch.bfloat16)

    def attention():
        for _ in range(model.num_layers):
            out = dot_product_attention(*qkv, causal=False, impl="xla")
            torch.autograd.grad(out, qkv, do)

    head = model.mlm_decoder
    h = torch.randn((BERT_BATCH, BERT_T, model.d_model), generator=g,
                    device="cuda").to(torch.bfloat16).requires_grad_()
    dl = torch.randn((BERT_BATCH, BERT_T, head.kernel.shape[1]), generator=g,
                     device="cuda")

    def decoder():
        out = head(h)
        torch.autograd.grad(out, [h, head.kernel, head.bias], dl)

    logits = dl.clone().requires_grad_()
    labels = torch.randint(0, head.kernel.shape[1], (BERT_BATCH, BERT_T),
                           generator=g, device="cuda")
    labels[torch.rand(labels.shape, generator=g, device="cuda") > 0.15] = -1

    def loss():
        torch.autograd.grad(masked_lm_xent(logits, labels), logits)

    return {name: time_ms(fn, 5) for name, fn in (
        ("attention_plain_fwd_bwd", attention),
        ("mlm_decoder_f32_fwd_bwd", decoder), ("mlm_loss_fwd_bwd", loss))}


def phase_bert():
    """bert_base_buckets as it is (12 layers, d 768, vocab 30522, T 128,
    batch 256, dp_explicit, 100 MB buckets, overlap) on NCCL at world 1:
    one step with and without overlap from the same seeded weights and
    batch must leave the parameters bit for bit equal; 2 warm-up and 4
    timed steps; one profiled step; the parts' own times; then 2 steps on
    the int8 wire with the quantize count reset just before and read just
    after (one launch a f32 bucket a step)."""
    import torch

    from pytorch_distributed_nn_tpu_torch.ops.buckets import (
        bucket_plan,
        issue_order,
    )
    from pytorch_distributed_nn_tpu_torch.parallel.api import make_train_step
    from pytorch_distributed_nn_tpu_torch.utils.flops import (
        transformer_train_flops_per_token,
    )

    plain = bert_trainer(**{"parallel.overlap": "false"})
    plain.train(steps=1)
    want = {k: v.clone() for k, v in plain.model.state_dict().items()}
    del plain
    torch.cuda.empty_cache()
    trainer = bert_trainer()
    cfg, model = trainer.cfg, trainer.model
    if ((trainer.process.backend, trainer.process.world_size) != ("nccl", 1)
            or not cfg.parallel.overlap
            or (cfg.data.batch_size, cfg.data.seq_len) != (BERT_BATCH,
                                                           BERT_T)):
        raise AssertionError(f"bert_base_buckets: {trainer.process}, "
                             f"{cfg.parallel}, {cfg.data}")
    trainer.train(steps=1)
    got = model.state_dict()
    differ = [k for k, v in want.items() if not torch.equal(got[k], v)]
    if differ:
        raise AssertionError(f"overlap changed {len(differ)} parameters, "
                             f"e.g. {differ[:3]}")
    del want, got
    log("[bert] one step with overlap equals the step without, bit for bit")
    shapes = {n: (p.shape, p.dtype) for n, p in model.named_parameters()}
    plan = bucket_plan(shapes, int(cfg.parallel.bucket_mb * 1024 * 1024))
    reducer = trainer.step_fn.reducer(trainer.state)
    trainer.train(steps=1)  # the second warm-up step
    steps = 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    issued = reducer.buckets_issued
    trainer.train(steps=steps)
    peak = torch.cuda.max_memory_allocated()
    per_step = (reducer.buckets_issued - issued) / steps
    if per_step != len(plan):
        raise AssertionError(f"{per_step} buckets a step, the plan has "
                             f"{len(plan)}")
    losses = trainer.losses()[-steps:]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"losses {losses}")
    last = reducer.last
    if [tuple(x) for x in last["issued"]] != issue_order(
            plan, last["hook_order"]):
        raise AssertionError("buckets issued out of the hooks' order")
    mb = [sum(shapes[n][0].numel() * 4 for n in names) / 2 ** 20
          for _, names in plan]
    hooks = last["hooks"]
    overlap = dict(
        buckets=len(plan), bucket_mib=mb, hooks=hooks,
        issued=[dict(bucket=b, mib=mb[b], hooks_fired=k)
                for b, k in last["issued"]],
        share_before_last_hook=last["bytes_before_last_hook"]
        / last["bytes_total"],
        share_with_a_tenth_of_hooks_to_come=sum(
            mb[b] for b, k in last["issued"] if k <= 0.9 * hooks) / sum(mb))
    log(f"[bert] overlap: {json.dumps(overlap)}")
    per_token = transformer_train_flops_per_token(model, BERT_T,
                                                  causal=False)
    report = train_report(trainer, steps, per_token, BERT_BATCH * BERT_T,
                          peak)
    parts = bert_components(model)
    # the int8 wire, the same weights on: its quantize launches
    int8 = cfg.override(**{"parallel.quantized_allreduce": "int8"})
    trainer.step_fn, _ = make_train_step(int8, trainer.loss_fn)
    reset_dp_counts()
    trainer.train(steps=2)
    q_launches = quantize_count()
    if q_launches != 2 * len(plan):
        raise AssertionError(f"quantize launches {q_launches} in 2 int8 "
                             f"steps, expected {2 * len(plan)}")
    int8_losses = trainer.losses()[-2:]
    if not all(math.isfinite(v) for v in int8_losses):
        raise AssertionError(f"int8 losses {int8_losses}")
    result = dict(losses=losses, buckets_per_step=per_step, overlap=overlap,
                  all_step_s=[r.seconds for r in trainer.history],
                  parts_ms=parts, int8=dict(losses=int8_losses,
                                            quantize_launches=q_launches),
                  **{k: v for k, v in report.items() if k != "losses"})
    log(f"[bert] {json.dumps(result)}")
    del trainer, model
    torch.cuda.empty_cache()
    return result, q_launches


# the 8B that phases 6 and 7 serve: full width, 8 of 32 layers (the
# script's time limit; every greedy request's logits are a solo
# generate()'s bit for bit on both KV caches at this depth, and at 16 in
# tests/test_torch_cuda.py)
SERVE_LAYERS = 8
# the 8B of phases 31 and 32's tenants: full width, 8 of 32 layers (the
# script's time limit); their checks hold engine runs against engine runs
PL_LAYERS = 8


def w8a16_a_forward(layers):
    """W8A16 launches a forward of the int8 8B at ``layers`` layers: each
    layer's qkv, out, gate_up and down, and the head."""
    return 4 * layers + 1


W8A16_A_FORWARD = w8a16_a_forward(SERVE_LAYERS)
W8A16_PL = w8a16_a_forward(PL_LAYERS)
# phase 33 (c): scripts/generate.py --tp 2 on the 8B at its whole depth
# (at 16 layers its bf16 tokens left one process's: the tensor split sums
# its products in another order, ROADMAP.md §3)
TP_GEN_LAYERS = 32
W8A16_TP_GEN = w8a16_a_forward(TP_GEN_LAYERS)


def build_model(seed=0, layers=SERVE_LAYERS):
    import torch

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.models import get_model
    from pytorch_distributed_nn_tpu_torch.nn.quantized import (
        synthetic_int8_params,
    )

    cfg = get_config("llama3_8b_zero", **{
        "model.extra": json.dumps(dict(quantized=True, fused_proj=True,
                                       num_layers=layers))})
    model = get_model(cfg.model, device=torch.device("cuda"))
    synthetic_int8_params(model, seed=seed)
    torch.cuda.synchronize()
    return model


def run_forwards(model, tokens, steps):
    """One prefill + ``steps`` teacher-forced decode steps; returns the
    list of f32 logits and the decode step seconds."""
    import torch

    from pytorch_distributed_nn_tpu_torch.inference.generate import (
        init_cache,
    )

    B, total = tokens.shape
    P = total - steps
    cache = init_cache(model, B, total)
    outs, step_s = [], []
    with torch.inference_mode():
        zeros = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
        outs.append(model(tokens[:, :P], cache=cache,
                          cache_positions=zeros)[:, -1].float().cpu())
        for i in range(steps):
            pos = torch.full((B,), P + i, dtype=torch.int32,
                             device=tokens.device)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            lg = model(tokens[:, P + i:P + i + 1], cache=cache,
                       cache_positions=pos, last_only=True)[:, -1]
            torch.cuda.synchronize()
            step_s.append(time.monotonic() - t0)
            outs.append(lg.float().cpu())
    return outs, step_s


def profile_decode_step(model, tokens):
    """Device time of one B=8 decode step by torch.profiler: the sum of the
    CUDA kernels' own durations, and the W8A16 kernels' share and count
    (one a call: W8A16_A_FORWARD a forward), the step set between
    :func:`_margin`'s
    spin kernels. None
    where the profiler cannot start or records no device activity. Only
    the profiler's own errors are caught: the step itself runs outside any
    ``except``. Measurement only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_nn_tpu_torch.inference.generate import (
        init_cache,
    )

    B, P = tokens.shape[0], tokens.shape[1] - 1
    cache = init_cache(model, B, P + 1)
    pos = torch.full((B,), P, dtype=torch.int32, device=tokens.device)
    zeros = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
    with torch.inference_mode():
        model(tokens[:, :P], cache=cache, cache_positions=zeros)
        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CUDA], acc_events=True)
        try:
            prof.start()
        except RuntimeError as e:
            log(f"[forward] profiler did not start: {e}")
            return None
        try:
            _margin()
            model(tokens[:, P:], cache=cache, cache_positions=pos,
                  last_only=True)
            torch.cuda.synchronize()
            _margin()
        finally:
            stopped = _profiler_stop(prof)
    if not stopped:
        return None
    kern, margin = _without_margin(
        [e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA])
    if not kern:
        return None
    dev_us = sum(e.time_range.elapsed_us() for e in kern)
    w8 = [e for e in kern if "w8a16" in e.name]
    w8_us = sum(e.time_range.elapsed_us() for e in w8)
    return dict(kernels=len(kern), device_ms=dev_us / 1e3,
                w8a16_ms=w8_us / 1e3, w8a16_kernels=len(w8),
                margin_kernels_seen=margin)


def kernel_device_ms(fn, reps, name):
    """Device time of the CUDA kernels whose name holds ``name`` in one call
    of ``fn`` (the mean over ``reps`` calls under torch.profiler): the
    kernels' own durations, without the host's launch gaps. None where the
    profiler cannot start or records none. Measurement only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the device's activity alone: only its kernels are read
    prof = profile(activities=[ProfilerActivity.CUDA], acc_events=True)
    try:
        prof.start()
    except RuntimeError as e:
        log(f"[profile] profiler did not start: {e}")
        return None
    try:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    finally:
        stopped = _profiler_stop(prof)
    if not stopped:
        return None
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and name in e.name]
    return sum(us) / reps / 1e3 if us else None


def _profiler_stop(prof) -> bool:
    try:
        prof.stop()
    except RuntimeError as e:
        log(f"[forward] profiler did not stop cleanly: {e}")
        return False
    return True


def twin(model, compute_dtype, cache_dtype="compute"):
    """The same 8B model (the same weight tensors, shared) computing in
    ``compute_dtype`` with a ``cache_dtype`` KV cache."""
    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.models import get_model

    cfg = get_config("llama3_8b_zero", **{
        "model.extra": json.dumps(dict(quantized=True, fused_proj=True,
                                       cache_dtype=cache_dtype,
                                       num_layers=model.num_layers)),
        "model.compute_dtype": compute_dtype})
    out = get_model(cfg.model, device="meta")
    out.load_state_dict(model.state_dict(), assign=True)
    return out


def phase_forward(model):
    import torch

    from pytorch_distributed_nn_tpu_torch.nn import quantized as nq
    from pytorch_distributed_nn_tpu_torch.ops import int8_matmul as tmm

    def plain(x, q, s, out_dtype=torch.bfloat16):
        x = torch.nn.functional.pad(x, (0, q.shape[0] - x.shape[1]))
        return tmm.int8_matmul_reference(x, q, s, out_dtype)

    calls = []  # (max|err|, max|ref|, tol) per kernel call, on the device

    def checked(x, q, s, out_dtype=torch.bfloat16):
        got = tmm.int8_matmul(x, q, s, out_dtype)
        ref = plain(x, q, s, out_dtype).float()
        tol = TOL["float32" if out_dtype == torch.float32 else "bfloat16"]
        calls.append(torch.stack([(got.float() - ref).abs().max(),
                                  ref.abs().max(), torch.tensor(
                                      tol, device=ref.device)]))
        return got

    def run_with(fn, m):  # the check only: swap the module's matmul
        nq.int8_matmul = fn
        try:
            return run_forwards(m, tokens, steps)[0]
        finally:
            nq.int8_matmul = tmm.int8_matmul

    g = torch.Generator("cuda").manual_seed(1)
    steps = 4
    tokens = torch.randint(0, V, (8, 64 + steps), generator=g,
                           device="cuda", dtype=torch.int32)
    result = {}
    for dtype, m in (("bfloat16", model), ("float32", twin(model,
                                                             "float32"))):
        tmm.int8_matmul.launches = 0
        got, step_s = run_forwards(m, tokens, steps)
        launches = tmm.int8_matmul.launches
        if launches != W8A16_A_FORWARD * (1 + steps):
            raise AssertionError(
                f"{launches} kernel launches in {1 + steps} forwards, "
                f"expected {W8A16_A_FORWARD * (1 + steps)}")
        calls.clear()
        run_with(checked, m)
        err, scale, tol = torch.stack(calls).cpu().unbind(1)
        if len(calls) != launches or not bool((err <= tol * scale).all()):
            i = int(torch.argmax(err / (tol * scale)))
            raise AssertionError(
                f"{dtype}: kernel call {i} of {len(calls)} on the model's "
                f"activations: max|err| {float(err[i])} > {float(tol[i])} "
                f"* max|ref| {float(scale[i])}")
        call_err = float((err / scale).max())
        ref = run_with(plain, m)
        tol = LOGIT_TOL[dtype]
        worst, agree, rows, decisive, dis = 0.0, 0, 0, 0, 0
        for a, b in zip(got, ref):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError("non-finite logits on the kernel path")
            scale = b.abs().max().item()
            worst = max(worst, (a - b).abs().max().item() / scale)
            same = a.argmax(-1) == b.argmax(-1)
            agree += int(same.sum())
            rows += a.shape[0]
            # the greedy token must agree wherever the plain version's
            # top-1/top-2 margin exceeds twice the logit tolerance
            top2 = b.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > 2 * tol * scale
            decisive += int(sure.sum())
            dis += int((sure & ~same).sum())
        log(f"[forward] {dtype}: launches={launches} "
            f"({W8A16_A_FORWARD} x {1 + steps}); "
            f"every call on live activations max|err|/max|ref|="
            f"{call_err:.3e} (tol {TOL}); logits max|dlogit|/max|logit|="
            f"{worst:.3e} (tol {tol}); greedy token agrees in {agree}/{rows}"
            f" rows, differs on {dis} of {decisive} decisive rows; decode "
            f"step B=8 ms={[round(t * 1e3, 3) for t in step_s]}")
        if worst > tol:
            raise AssertionError(f"{dtype} kernel-path logits disagree "
                                 "with the plain version")
        if dis:
            raise AssertionError(
                f"{dtype}: the greedy token differs from the plain "
                f"version's on {dis} rows where its margin is decisive")
        result[dtype] = dict(launches=launches, call_rel_err=call_err,
                             rel_err=worst, argmax_agree=agree / rows,
                             decisive_rows=decisive,
                             decode_step_ms=[t * 1e3 for t in step_s])
    prof = profile_decode_step(model, tokens)
    if prof is None:
        log("[forward] device time of a decode step: not measured")
    else:
        wall = sorted(result["bfloat16"]["decode_step_ms"])[steps // 2]
        prof["idle_share_vs_unprofiled_step"] = 1 - prof["device_ms"] / wall
        log(f"[forward] decode step B=8 under torch.profiler: "
            f"{json.dumps(prof)}")
        if prof["w8a16_kernels"] != W8A16_A_FORWARD:  # one a call
            raise AssertionError(f"{prof['w8a16_kernels']} w8a16 kernels in "
                                 "one decode forward, expected "
                                 f"{W8A16_A_FORWARD}")
    result["profile"] = prof
    return result


SERVE_SLOTS, SERVE_NEW = 8, 32
# the request mix of phase 7: name -> DecodeSpec fields (None: greedy) and
# whether it streams; prompts 16-128 tokens from one seeded sampler
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
SERVE_MIX = (
    [(f"greedy{i}", None, False) for i in range(6)]
    + [(f"sampled{i}", dict(SAMPLED, seed=100 + i), False) for i in range(4)]
    + [("nbest", dict(SAMPLED, n=2, best_of=4, seed=7), False)]
    + [("streamed_greedy0", None, True), ("streamed_greedy1", None, True),
       ("streamed_sampled", dict(SAMPLED, seed=300), True)])
MIX_SPEC = {name: kw for name, kw, _ in SERVE_MIX}
# card against CPU sampling: Gumbel noise |d| <= this * max(|ref|, 1), and
# the tokens must agree where the perturbed top-2 margin exceeds the other
GUMBEL_TOL, SAMPLE_MARGIN = 1e-6, 1e-4


def mix_prompts(seed):
    from pytorch_distributed_nn_tpu_torch.serve import ragged_prompt_sampler

    sample = ragged_prompt_sampler(V, min_len=16, max_len=128, seed=seed)
    return {name: sample() for name, _, _ in SERVE_MIX}


def submit_mix(server, prompts, names, rate_hz=50.0):
    """Submit ``names`` of :data:`SERVE_MIX` on an open loop at ``rate_hz``
    and wait for all; returns {name: Request}."""
    from pytorch_distributed_nn_tpu_torch.serve import DecodeSpec

    spec = {name: (None if kw is None else DecodeSpec(**kw), stream)
            for name, kw, stream in SERVE_MIX}
    reqs, t0 = {}, time.monotonic()
    for i, name in enumerate(names):
        wait = t0 + i / rate_hz - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        decode, stream = spec[name]
        reqs[name] = server.submit(prompts[name], SERVE_NEW, decode=decode,
                                   stream=stream)
    for name, r in reqs.items():
        if not r.done.wait(600) or not r.ok:
            raise AssertionError(f"{name}: {r.state} {r.reject_reason}")
    return reqs


def check_nbest_shares_blocks(model, prompt):
    """One n-best request stepped by hand through a fresh engine: after its
    admission the 4 branches hold the prompt's full blocks once (refcount
    4) plus a tail each, and retirement returns every block."""
    from pytorch_distributed_nn_tpu_torch.serve import (
        DecodeSpec,
        ServingEngine,
    )
    from pytorch_distributed_nn_tpu_torch.serve.scheduler import (
        branch_seq_ids,
    )

    engine = ServingEngine(model, max_slots=SERVE_SLOTS, max_seq_len=256)
    pool = engine.scheduler.pool
    free0 = pool.free_blocks
    spec = MIX_SPEC["nbest"]
    req = engine.submit(prompt, SERVE_NEW, decode=DecodeSpec(**spec))
    engine.step()
    tables = [pool.block_table(s) for s in branch_seq_ids(req)]
    full = len(prompt) // pool.block_size
    shared = set(tables[0][:full])
    held = {b for t in tables for b in t}
    if not (all(set(t[:full]) == shared for t in tables)
            and all(pool.refcount(b) == len(tables) for b in shared)
            and len(held) == full + sum(len(t) - full for t in tables)):
        raise AssertionError(f"n-best branches do not share the prompt's "
                             f"blocks: {tables}")
    engine.run_until_idle()
    if not req.ok or pool.free_blocks != free0:
        raise AssertionError("the n-best request leaked blocks")
    return dict(branches=len(tables), prompt_blocks_shared=full,
                blocks_held=len(held),
                blocks_unshared=sum(len(t) for t in tables))


def tap_greedy_logits(engine, model):
    """Record every greedy request's next-token logits as ``engine`` makes
    them (the prefill's row, then each decode round's), (V,) f32 on the
    host, by request id. Returns (the dict, a function that removes the
    taps). The server's thread calls the wrapped methods."""
    logs, taps = {}, []
    hook = model.register_forward_hook(
        lambda m, a, out: taps.append(out[:, -1]))
    prefill_into, decode_round = engine._prefill_into, engine._decode_round

    def greedy(req):
        return req.decode is None or not req.decode.sampled

    def tapped_prefill(rows, req):
        n = len(taps)
        prefill_into(rows, req)
        if greedy(req):
            logs[req.request_id] = [taps[n][0].float().cpu()]
        del taps[n:]

    def tapped_round():
        owners = [s and s.req for s in engine._slots]
        n = len(taps)
        out = decode_round()
        for i, req in enumerate(owners):
            if req is not None and greedy(req):
                logs[req.request_id].append(taps[n][i].float().cpu())
        del taps[n:]
        return out

    engine._prefill_into, engine._decode_round = tapped_prefill, tapped_round

    def remove():
        hook.remove()
        engine._prefill_into, engine._decode_round = prefill_into, \
            decode_round
    return logs, remove


def greedy_gaps(model, reqs, logs, names):
    """Each greedy request of ``names`` against a solo ``generate()`` of
    its prompt: the largest |engine - solo| next-token logit over its
    steps, the first step where they differ (None: every bit equal) and
    whether the tokens agree."""
    import numpy as np

    out = {}
    for name in names:
        r = reqs[name]
        ref, ref_toks = f1_solo_logits(model, r.prompt, SERVE_NEW)
        got = logs[r.request_id]
        gaps = [float((a - b.cpu()).abs().max()) for a, b in zip(got, ref)]
        first = next((i for i, g in enumerate(gaps) if g), None)
        out[name] = dict(gap=max(gaps), first_step=first,
                         steps=len(gaps), solo_steps=len(ref),
                         tokens_equal=bool(np.array_equal(r.tokens,
                                                          ref_toks)))
    return out


def serve_one_cache(model, cache_dtype):
    """Phase 7 on one cache dtype: the mix through the server (the main
    path, W8A16 counted), then its sampled requests again in another batch
    mix; every greedy request's logits and tokens against a solo
    ``generate()``, bit for bit; returns (summary, {name: tokens},
    launches)."""
    import numpy as np
    import torch

    from pytorch_distributed_nn_tpu_torch.inference.generate import (
        cache_bytes,
    )
    from pytorch_distributed_nn_tpu_torch.obs.stats import percentile
    from pytorch_distributed_nn_tpu_torch.ops import int8_matmul as tmm
    from pytorch_distributed_nn_tpu_torch.serve import (
        DecodeSpec,
        InferenceServer,
        ServingEngine,
    )

    engine = ServingEngine(model, max_slots=SERVE_SLOTS, max_seq_len=256,
                           max_queue=64, max_prefills_per_round=2)
    prompts = mix_prompts(3)
    logs, untap = tap_greedy_logits(engine, model)
    server = InferenceServer(engine).start()
    try:
        warm = np.random.default_rng(7)
        for L in (16, 32, 64, 128):  # every prefill bucket, + decode
            r = server.generate(warm.integers(0, V, size=(L,)), 2,
                                timeout=300)
            if not r.ok:
                raise AssertionError(f"warm-up request {r.state}")
        r = server.generate(warm.integers(0, V, size=(16,)), 2, timeout=300,
                            decode=DecodeSpec(**MIX_SPEC["nbest"]))
        if not r.ok:  # the sampled step, warm
            raise AssertionError(f"warm-up request {r.state}")
        warm_done = len(engine.completed)
        warm_rounds = len(engine.round_seconds)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tmm.int8_matmul.launches = 0  # the main path's count starts here
        t0 = time.monotonic()
        reqs = submit_mix(server, prompts, [n for n, _, _ in SERVE_MIX])
        wall = time.monotonic() - t0
        launches = tmm.int8_matmul.launches
        timed = engine.completed[warm_done:]
        rounds = engine.round_seconds[warm_rounds:]
        # the sampled requests again, in another batch: in reverse order,
        # each after a greedy stranger with another prompt
        greedy = [n for n, kw, _ in SERVE_MIX if kw is None]
        again_names = [n for n, kw, _ in SERVE_MIX if kw is not None][::-1]
        order = [n for pair in itertools.zip_longest(greedy, again_names)
                 for n in pair if n is not None]
        others = mix_prompts(11)
        again = submit_mix(server, {**prompts, **{n: others[n]
                                                  for n in greedy}}, order)
    finally:
        server.stop()
        untap()
    peak = torch.cuda.max_memory_allocated()
    for name, r in reqs.items():
        if len(r.tokens) != SERVE_NEW or not (
                0 <= int(r.tokens.min()) and int(r.tokens.max()) < V):
            raise AssertionError(f"{name}: {r.tokens}")
    per_forward = w8a16_a_forward(model.num_layers)
    if launches != per_forward * (len(timed) + len(rounds)):
        raise AssertionError(
            f"{cache_dtype}: {launches} launches for {len(timed)} prefills "
            f"and {len(rounds)} decode rounds, expected {per_forward} "
            "per forward")
    for name in again_names:
        a, b = again[name], reqs[name]
        same = np.array_equal(a.tokens, b.tokens)
        if name == "nbest":
            same &= [(x["branch"], x["tokens"]) for x in a.n_best] == \
                [(x["branch"], x["tokens"]) for x in b.n_best]
            same &= all(abs(x["logprob"] - y["logprob"])
                        <= 1e-5 * abs(y["logprob"])
                        for x, y in zip(a.n_best, b.n_best))
        if not same:
            raise AssertionError(f"{cache_dtype}: {name} differs in "
                                 "another batch mix")
    gaps = greedy_gaps(model, reqs, logs,
                       [n for n, kw, _ in SERVE_MIX if kw is None])
    del logs
    log(f"[serve] {cache_dtype}: greedy engine rows against solo "
        f"generate(): {json.dumps(gaps)}")
    for name, g in gaps.items():
        if not g["tokens_equal"]:
            raise AssertionError(f"{cache_dtype}: {name}: engine tokens "
                                 "differ from sequential generate")
        if g["gap"] != 0 or g["steps"] != g["solo_steps"]:
            raise AssertionError(
                f"{cache_dtype}: {name}: engine logits differ from "
                f"sequential generate's: {g}")
    for name, r in reqs.items():
        if r.stream is not None and not np.array_equal(
                np.concatenate(list(r.stream)), r.tokens):
            raise AssertionError(f"{name}: streamed chunks != tokens")
    nb = reqs["nbest"]
    lps = [b["logprob"] for b in nb.n_best]
    if not (len(nb.n_best) == 2 and lps == sorted(lps, reverse=True)
            and nb.logprob == lps[0]
            and list(nb.tokens) == nb.n_best[0]["tokens"]):
        raise AssertionError(f"n-best ranking: {lps} winner {nb.logprob}")
    sharing = check_nbest_shares_blocks(model, prompts["nbest"])
    tokens_out = sum(c["new_tokens"] for c in timed)
    summary = dict(
        cache_dtype=cache_dtype, requests=len(reqs), completed=len(timed),
        tokens_out=tokens_out, wall_s=wall, tokens_per_s=tokens_out / wall,
        ttft_p50_s=percentile([c["ttft_s"] for c in timed], 0.5),
        ttft_p95_s=percentile([c["ttft_s"] for c in timed], 0.95),
        token_lat_p50_s=percentile(rounds, 0.5),
        token_lat_p95_s=percentile(rounds, 0.95),
        rounds=len(rounds), occupancy=engine.summary()["occupancy"],
        kv_cache_bytes=cache_bytes(engine._cache),
        peak_mem_gb=peak / 1e9, int8_matmul_launches=launches,
        nbest_logprobs=lps, nbest_sharing=sharing,
        same_seed_other_mix=again_names,
        greedy_logit_gap=max(g["gap"] for g in gaps.values()),
        greedy_vs_generate=gaps)
    log(f"[serve] {json.dumps(summary)}")
    return summary, {n: r.tokens for n, r in reqs.items()}, launches


def teacher_forced(model, prompts, tokens, spoil=None):
    """(R, N, V) f32 logits of R requests decoded in one batch over the
    model's KV cache with ``tokens`` (R, N) fed in (teacher forcing): the
    ragged prefill's at each prompt's end, then N - 1 decode steps', each
    row at its own position as the engine steps it. ``spoil(cache)`` runs
    on the cache after the prefill."""
    import torch

    from pytorch_distributed_nn_tpu_torch.inference.generate import (
        decode_step_ragged,
        init_cache,
        prefill_ragged,
    )

    lens = torch.tensor([len(p) for p in prompts], device="cuda")
    x = torch.zeros((len(prompts), int(lens.max())), dtype=torch.int32,
                    device="cuda")
    for i, p in enumerate(prompts):
        x[i, :len(p)] = torch.as_tensor(p)
    toks = torch.as_tensor(tokens, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        cache = init_cache(model, len(prompts), x.shape[1] + toks.shape[1])
        out = [prefill_ragged(model, cache, x, lens).float()]
        if spoil is not None:
            spoil(cache)
        for i in range(toks.shape[1] - 1):
            out.append(decode_step_ragged(model, cache, toks[:, i],
                                          lens + i).float())
        return torch.stack(out, 1)


def _scales(cache, fn):
    for layer in cache.values():
        for key in ("cached_key_scale", "cached_value_scale"):
            layer[key].copy_(fn(layer[key]))


# the int8 cache spoiled after the prefill, as a fault would: the check of
# phase 7 must tell each from a right int8 cache
INT8_SPOILS = {
    "scales_dropped": lambda c: _scales(c, lambda s: s.new_ones(s.shape)),
    "scales_off_by_one": lambda c: _scales(
        c, lambda s: s.roll(1, dims=1)),
}


def int8_vs_compute(model, prompts, tokens):
    """The int8 KV cache against the compute cache on ``model``'s weights,
    both teacher-forced with the compute run's greedy ``tokens``: the
    largest |int8 - compute| logit of a request over its largest |compute|
    logit (the worst request), the same for each of
    :data:`INT8_SPOILS`, and the greedy choices of the int8 cache at every
    step where the compute cache's top-1/top-2 margin exceeds twice the
    int8 error bound (INT8_KV_TOL of the request's largest logit)."""
    import torch

    m8 = twin(model, "bfloat16", "int8")
    ref = teacher_forced(model, prompts, tokens)
    scale = ref.abs().amax((1, 2))

    def rel(lg):
        return float(((lg - ref).abs().amax((1, 2)) / scale).max())

    got = teacher_forced(m8, prompts, tokens)
    top2 = ref.topk(2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]) > \
        2 * INT8_KV_TOL * scale[:, None]
    agree = got.argmax(-1) == ref.argmax(-1)
    out = dict(rel_err=rel(got), steps=int(agree.numel()),
               decisive=int(decisive.sum()),
               decisive_disagree=int((decisive & ~agree).sum()),
               agree=int(agree.sum()), tol=INT8_KV_TOL)
    del got
    for name, spoil in INT8_SPOILS.items():
        out[name] = rel(teacher_forced(m8, prompts, tokens, spoil))
    del m8, ref
    torch.cuda.empty_cache()
    return out


def int8_cache_agreement(model, prompts, tokens_c, tokens_q):
    """Phase 7's int8 cache against its compute cache
    (:func:`int8_vs_compute` on the greedy requests): the logits within
    INT8_KV_TOL, every spoiled cache beyond it, the greedy choices equal
    wherever the compute margin is decisive. The first token where the
    two served streams part is recorded."""
    import numpy as np

    names = [n for n, kw, _ in SERVE_MIX if kw is None]
    out = int8_vs_compute(model, [prompts[n] for n in names],
                          np.stack([tokens_c[n] for n in names]))
    out["first_diff"] = {
        n: (int(d[0]) if (d := np.flatnonzero(tokens_c[n] != tokens_q[n]))
            .size else None) for n in names}
    if not out["rel_err"] <= INT8_KV_TOL:
        raise AssertionError(f"int8 cache logits {out['rel_err']} from the "
                             f"compute cache's, limit {INT8_KV_TOL}")
    for name in INT8_SPOILS:
        if not out[name] > INT8_KV_TOL:
            raise AssertionError(f"the int8 check cannot tell {name}: "
                                 f"{out[name]} <= {INT8_KV_TOL}")
    if out["decisive_disagree"]:
        raise AssertionError(f"the int8 cache changes "
                             f"{out['decisive_disagree']} decisive greedy "
                             "choices")
    return out


def sampling_card_vs_cpu():
    """sample_rows on the card against the same function on the CPU for
    fixed seeded (8, 128256) logits: the keys bit for bit, the Gumbel noise
    within GUMBEL_TOL, the tokens wherever the perturbed top-2 margin
    exceeds SAMPLE_MARGIN; and the sampling's device time a round (CUDA
    events around keys, sample_rows and token_logprobs at 8 rows)."""
    import torch

    from pytorch_distributed_nn_tpu_torch.serve import decoding
    from pytorch_distributed_nn_tpu_torch.utils import threefry

    B = SERVE_SLOTS
    g = torch.Generator().manual_seed(5)
    logits = torch.randn((B, V), generator=g) * 3
    temps = torch.tensor([0.8, 1.0, 0.5, 1.3, 0.8, 0.0, 2.0, 0.8])
    ks = torch.tensor([50, 0, 10, 0, 50, 0, 1000, V], dtype=torch.int32)
    ps = torch.tensor([0.95, 0.0, 0.9, 1.0, 0.0, 0.0, 0.99, 0.5])
    seeds = torch.arange(B, dtype=torch.int64) * 1000 + 3
    branches = torch.arange(B, dtype=torch.int64) % 4
    steps = torch.arange(B, dtype=torch.int64) * 7
    args = [logits, temps, ks, ps]
    keys = decoding.row_keys(seeds, branches, steps)
    dkeys = decoding.row_keys(seeds.cuda(), branches.cuda(), steps.cuda())
    if not torch.equal(dkeys.cpu(), keys):
        raise AssertionError("threefry keys differ between card and CPU")
    noise = threefry.gumbel(keys, (V,))
    dnoise = threefry.gumbel(dkeys, (V,)).cpu()
    gerr = float(((dnoise - noise).abs()
                  / noise.abs().clamp(min=1.0)).max())
    if not gerr <= GUMBEL_TOL:
        raise AssertionError(f"Gumbel noise card vs CPU: {gerr}")
    toks = decoding.sample_rows(*args, keys)
    dtoks = decoding.sample_rows(*[a.cuda() for a in args], dkeys).cpu()
    masked = decoding._mask_one(logits, ks, ps)
    pert = noise + masked / temps.clamp(min=1e-6)[:, None]
    top2 = pert.topk(2, dim=-1).values
    sure = ((top2[:, 0] - top2[:, 1]) > SAMPLE_MARGIN) | (temps == 0)
    bad = int((sure & (toks != dtoks)).sum())
    if bad:
        raise AssertionError(f"{bad} sampled tokens differ card vs CPU")
    dl = logits.cuda()
    dargs = [dl, temps.cuda(), ks.cuda(), ps.cuda()]
    lanes = [seeds.cuda(), branches.cuda(), steps.cuda()]

    def one_round():  # what the sampled step adds to a decode round
        t = decoding.sample_rows(*dargs, decoding.row_keys(*lanes))
        return decoding.token_logprobs(dl, t)

    ms = time_ms(one_round, 20)
    out = dict(rows=B, vocab=V, keys_bitwise=True, gumbel_rel_err=gerr,
               tokens_agree=int((toks == dtoks).sum()), decisive=int(
                   sure.sum()), sample_ms_per_round=ms)
    log(f"[serve] sampling card vs CPU: {json.dumps(out)}")
    return out


# phase 7's measure of the norms' row blocks: engines of these many slots,
# each request this many new tokens
NORM_COST_SLOTS, NORM_COST_NEW = (8, 32), 16


class plain_norms:
    """Inside the block the norms' statistics are one library mean over
    all of a decode step's rows, as before the fixed row blocks
    (``nn.layers.row_mean``): what the blocks cost, measured. The block
    restores the function. Measurement only."""

    def __enter__(self):
        from pytorch_distributed_nn_tpu_torch.models import llama
        from pytorch_distributed_nn_tpu_torch.nn import layers

        self.saved = layers.row_mean
        llama.row_mean = layers.row_mean = \
            lambda x: x.mean(-1, keepdim=True)

    def __exit__(self, *exc):
        from pytorch_distributed_nn_tpu_torch.models import llama
        from pytorch_distributed_nn_tpu_torch.nn import layers

        llama.row_mean = layers.row_mean = self.saved
        return False


def norm_block_cost(model):
    """What the decode step's norm row blocks cost on the host and on the
    card: for each of :data:`NORM_COST_SLOTS`, one engine of that many
    slots (prefix cache on, every prompt admitted in the first round)
    decodes as many new greedy 16-token prompts, ``NORM_COST_NEW`` tokens
    each, with the plain mean and with the blocks in turns (plain, blocks,
    blocks, plain). Each turn: the run's wall seconds and tokens/s, and its
    decode rounds' wall time (a round gives each request one token: the
    per-token latency) p50 and mean. Then one decode step of that many
    rows each way, by CUDA events and on the device
    (:func:`f1_decode_ms`)."""
    import numpy as np

    from pytorch_distributed_nn_tpu_torch.obs.stats import percentile
    from pytorch_distributed_nn_tpu_torch.serve import ServingEngine

    rng = np.random.default_rng(5)
    out = {}
    for slots in NORM_COST_SLOTS:
        engine = ServingEngine(model, max_slots=slots, max_seq_len=128,
                               max_queue=64, max_prefills_per_round=slots)
        engine.submit(rng.integers(0, V, size=(16,)), 2)  # warm
        engine.run_until_idle()
        turns = []
        for plain in (True, False, False, True):
            with plain_norms() if plain else contextlib.nullcontext():
                n0 = len(engine.round_seconds)
                reqs = [engine.submit(rng.integers(0, V, size=(16,)),
                                      NORM_COST_NEW) for _ in range(slots)]
                t0 = time.monotonic()
                engine.run_until_idle()
                wall = time.monotonic() - t0
            rounds = engine.round_seconds[n0:]
            if not all(r.ok and len(r.tokens) == NORM_COST_NEW
                       for r in reqs):
                raise AssertionError(f"norm cost at {slots} slots: "
                                     f"{[r.state for r in reqs]}")
            turns.append(dict(
                norms="plain" if plain else "row_blocks", wall_s=wall,
                tokens_per_s=slots * NORM_COST_NEW / wall,
                rounds=len(rounds), round_p50_s=percentile(rounds, 0.5),
                round_mean_s=sum(rounds) / len(rounds)))
        del engine
        with plain_norms():
            plain_step = f1_decode_ms(model, slots, reps=10)
        out[slots] = dict(turns=turns, step_ms=dict(
            plain=plain_step, row_blocks=f1_decode_ms(model, slots,
                                                      reps=10)))
    log(f"[serve] norm row blocks' cost: {json.dumps(out)}")
    return out


def phase_serve(model):
    """Phase 7 on the compute and the int8 KV cache, the int8 cache against
    the compute cache, the sampling on the card against the CPU, and what
    the norms' row blocks cost on the int8 cache."""
    import torch

    sampling = sampling_card_vs_cpu()
    by_dtype, tokens, launches = {}, {}, {}
    for cache_dtype in ("compute", "int8"):
        m = model if cache_dtype == "compute" else twin(
            model, "bfloat16", cache_dtype)
        by_dtype[cache_dtype], tokens[cache_dtype], launches[cache_dtype] = \
            serve_one_cache(m, cache_dtype)
        if cache_dtype == "int8":
            norm_cost = norm_block_cost(m)
        del m
        gc.collect()
        torch.cuda.empty_cache()
    agreement = int8_cache_agreement(model, mix_prompts(3),
                                     tokens["compute"], tokens["int8"])
    log(f"[serve] int8 cache against the compute cache: "
        f"{json.dumps(agreement)}")
    return dict(by_dtype, int8_vs_compute=agreement, sampling=sampling,
                norm_blocks=norm_cost), launches


# ---------------------------------------------------------------------------
# rule 3: the prefix cache and per-request LoRA adapters on the 8B int8
# serving path (phase 31)
# ---------------------------------------------------------------------------
PL_BLOCK, PL_SYSTEMS, PL_SYSTEM_LEN, PL_REQUESTS = 16, 4, 256, 24
PL_SUFFIX = (16, 64)  # each request's own suffix, tokens
PL_SEQ = 384  # 256 + 64 + 32 = 352 rows at most
# the eviction run: 8 slots x 22 blocks; wave 1, 8 requests of wave 2,
# 4 cold prompts of 320 tokens whose reservations the cached ring must
# make room for, then 8 more requests of wave 2
PL_EVICT_SEQ, PL_COLD = 352, 4
PL_MIN_HITS = 20
PL_NBEST_AT = 13  # the stream's n-best of 4 (2 returned)
PL_LORA = dict(num_adapters=4, rank=16, scale=0.3)
PL_LORA_NEW = 8
PL_RATE_HZ = 50.0
PL_ROWS = (1, 2, 4, 8, 16, 44)  # suffix rows of pl_rows



def pl_stream(seed=31):
    """Phase 31's 24 requests: request i is system prompt i % 4 (256
    tokens) and a suffix of its own (16-64 tokens); every fourth is
    sampled (seed 100 + i), request 13 an n-best of 4, the rest greedy.
    Requests 0-3 (one a system prompt) are wave 1, the rest wave 2.
    Returns [(prompt, DecodeSpec fields or None)]."""
    import numpy as np

    rng = np.random.default_rng(seed)
    systems = [rng.integers(0, V, size=PL_SYSTEM_LEN)
               for _ in range(PL_SYSTEMS)]
    out = []
    for i in range(PL_REQUESTS):
        suffix = rng.integers(0, V, size=int(rng.integers(
            PL_SUFFIX[0], PL_SUFFIX[1] + 1)))
        kw = (dict(SAMPLED, n=2, best_of=4, seed=100 + i)
              if i == PL_NBEST_AT else dict(SAMPLED, seed=100 + i)
              if i % 4 == 3 else None)
        out.append((np.concatenate([systems[i % PL_SYSTEMS], suffix])
                    .astype(np.int32), kw))
    return out


def pl_submit(server, stream, rate_hz=PL_RATE_HZ):
    """Submit ``stream`` on an open loop at ``rate_hz`` and wait for all;
    returns the requests."""
    from pytorch_distributed_nn_tpu_torch.serve import DecodeSpec

    reqs, t0 = [], time.monotonic()
    for i, (prompt, kw) in enumerate(stream):
        wait = t0 + i / rate_hz - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        reqs.append(server.submit(prompt, SERVE_NEW, decode=None if kw is None
                                  else DecodeSpec(**kw)))
    for r in reqs:
        if not r.done.wait(600) or not r.ok:
            raise AssertionError(f"{r.request_id}: {r.state} "
                                 f"{r.reject_reason}")
    return reqs


def pl_serve(model, waves, *, prefix_cache=True, max_seq_len=PL_SEQ):
    """``waves`` (lists of :func:`pl_stream` entries) through
    InferenceServer(ServingEngine(...)) with 8 slots, each wave submitted
    once the one before finished; the W8A16 count reset just before and
    read just after. Returns (engine, requests, launches, wall seconds)."""
    from pytorch_distributed_nn_tpu_torch.ops import int8_matmul as tmm
    from pytorch_distributed_nn_tpu_torch.serve import (
        InferenceServer,
        ServingEngine,
    )

    engine = ServingEngine(model, max_slots=SERVE_SLOTS,
                           max_seq_len=max_seq_len, block_size=PL_BLOCK,
                           max_queue=64, max_prefills_per_round=2,
                           prefix_cache=prefix_cache)
    server = InferenceServer(engine).start()
    try:
        tmm.int8_matmul.launches = 0  # the main path's count starts here
        t0 = time.monotonic()
        reqs = []
        for wave in waves:
            reqs += pl_submit(server, wave)
        wall = time.monotonic() - t0
        launches = tmm.int8_matmul.launches
    finally:
        server.stop()
    forwards = len(engine.completed) + len(engine.round_seconds)
    if launches != W8A16_PL * forwards:
        raise AssertionError(f"{launches} W8A16 launches for {forwards} "
                             f"forwards, expected {W8A16_PL} a "
                             "forward")
    return engine, reqs, launches, wall


def pl_rows(model, cache_dtype, L=300):
    """A prefill's rows against the same rows prefilled after the rest
    was restored, bit for bit: the last position's logits and every
    layer's K/V of a 300-token prompt, prefilled whole, against the
    last T rows prefilled at offset 300 - T over the whole prefill's
    own rows [0, 300 - T), for T in PL_ROWS. T = 1 is a decode step's
    forward (the engine prefills 2 rows then, nn.attention.
    suffix_prefill_start). Fails unless every T >= 2 is equal."""
    import numpy as np
    import torch

    from pytorch_distributed_nn_tpu_torch.inference.generate import (
        init_cache,
    )

    dev = model.device
    toks = torch.as_tensor(np.random.default_rng(34).integers(
        0, V, size=(1, L)), dtype=torch.int32, device=dev)

    def prefill(cache, start):
        return model(toks[:, start:], cache=cache, cache_positions=torch.full(
            (1,), start, dtype=torch.int32, device=dev),
            last_only=True)[0, -1].float()

    def kv(cache):
        return [layer[k][:, :L] for layer in cache.values()
                for k in ("cached_key", "cached_value")]

    out = {}
    with torch.inference_mode():
        full = init_cache(model, 1, 512)
        ref = prefill(full, 0)
        for T in PL_ROWS:
            part = init_cache(model, 1, 512)
            for name, layer in part.items():
                for k, v in layer.items():
                    if v.dim() >= 2:
                        v[:, :L - T].copy_(full[name][k][:, :L - T])
            got = prefill(part, L - T)
            out[T] = dict(
                equal=bool(torch.equal(got, ref)) and all(
                    torch.equal(a, b) for a, b in zip(kv(part), kv(full))),
                logit_gap=float((got - ref).abs().max()))
    log(f"[prefix_lora] rows, {cache_dtype} cache: {json.dumps(out)}")
    bad = [T for T, r in out.items() if T >= 2 and not r["equal"]]
    if bad:
        raise AssertionError(f"{cache_dtype}: suffix prefills of {bad} rows "
                             "differ from the whole prefill's rows")
    return out


def pl_same(a, b):
    """The tokens of two runs' requests equal (an n-best's ranked streams
    too)."""
    import numpy as np

    same = np.array_equal(a.tokens, b.tokens)
    if a.n_best is not None:
        same &= [x["tokens"] for x in a.n_best] == \
            [x["tokens"] for x in b.n_best]
    return bool(same)


def pl_first_diff(a, b):
    """The first new-token position where two streams part (the shorter
    one's length where one is the other's head)."""
    import numpy as np

    n = min(len(a), len(b))
    d = np.flatnonzero(np.asarray(a[:n]) != np.asarray(b[:n]))
    return int(d[0]) if d.size else n


def pl_logit_gap(model, prompt, m):
    """Where a hit's tokens parted from the cache-off run's: the last
    position's logits of the full prefill against those of the rows
    [0, m) copied from a prefill of the prefix and the rest prefilled at
    offset m. Returns (max |gap|, its vocab index)."""
    import torch

    from pytorch_distributed_nn_tpu_torch.inference.generate import (
        init_cache,
    )

    dev = model.device
    toks = torch.as_tensor(prompt[None], device=dev)
    with torch.inference_mode():
        full = init_cache(model, 1, 512)
        ref = model(toks, cache=full, cache_positions=torch.zeros(
            (1,), dtype=torch.int32, device=dev), last_only=True)[0, -1]
        part = init_cache(model, 1, 512)
        model(toks[:, :m], cache=part, cache_positions=torch.zeros(
            (1,), dtype=torch.int32, device=dev), last_only=True)
        got = model(toks[:, m:], cache=part, cache_positions=torch.full(
            (1,), m, dtype=torch.int32, device=dev),
            last_only=True)[0, -1]
    gap = (got.float() - ref.float()).abs()
    return float(gap.max()), int(gap.argmax())


def pl_timing(engine, reqs):
    """p50 TTFT (submit to first token) and prefill (admission to first
    token) seconds of the hits, of the misses and of wave 2 (queued
    behind 8 slots: the same requests in the run with the cache off)."""
    from pytorch_distributed_nn_tpu_torch.obs.stats import percentile

    cached = {c["request_id"]: c["cached_tokens"] for c in engine.completed}
    wave2 = {r.request_id for r in reqs[PL_SYSTEMS:PL_REQUESTS]}
    out = {}
    for kind, pick in (("hit", lambda r: cached[r.request_id] > 0),
                       ("miss", lambda r: cached[r.request_id] == 0),
                       ("wave2", lambda r: r.request_id in wave2)):
        rs = [r for r in reqs if pick(r)]
        out[kind] = dict(
            requests=len(rs),
            ttft_p50_s=percentile([r.t_first_token - r.t_submit
                                   for r in rs], 0.5),
            prefill_p50_s=percentile([r.t_first_token - r.t_admit
                                      for r in rs], 0.5))
    return out


def pl_store_ms(engine):
    """Device times by CUDA events of a hit's restore (the 16 blocks of a
    system prompt, 256 rows of every layer's K/V, and the int8 cache's
    scales) and of a retire's save of 20 blocks, with their bound:
    the bytes read and written once at the HBM rate."""
    import torch

    from pytorch_distributed_nn_tpu_torch.inference.generate import (
        cache_bytes,
        init_cache,
    )
    from pytorch_distributed_nn_tpu_torch.serve import engine as eng

    row = init_cache(engine.model, 1, 512)
    per_row = cache_bytes(engine._store) / (engine.scheduler.pool.num_blocks
                                            * PL_BLOCK)
    out = {}
    for name, nb, fn in (
            ("restore", 16, lambda t: eng._restore_blocks(
                row, engine._store, t)),
            ("save", 20, lambda t: eng._save_blocks(
                engine._cache, engine._store, 0, t))):
        table = torch.arange(nb, device="cuda")
        moved = 2 * nb * PL_BLOCK * per_row
        out[name] = dict(blocks=nb, ms=time_ms(lambda: fn(table), 20),
                         bound_ms=moved / HBM_BYTES_PER_S * 1e3,
                         bytes=moved)
    del row
    return out


def pl_profiled_step(model, prompt):
    """The W8A16 kernels by name in one profiled round of a fresh engine
    that admits ``prompt`` on a hit (the prompt served once before) and
    decodes a round: W8A16_PL a forward. None where the profiler records
    nothing. Measurement only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_nn_tpu_torch.serve import ServingEngine

    engine = ServingEngine(model, max_slots=SERVE_SLOTS, max_seq_len=PL_SEQ,
                           block_size=PL_BLOCK)
    engine.submit(prompt[:-1], 2)
    engine.run_until_idle()
    req = engine.submit(prompt, 2)
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA], acc_events=True)
    try:
        prof.start()
    except RuntimeError as e:
        log(f"[prefix_lora] profiler did not start: {e}")
        return None
    try:
        _margin()
        engine.step()
        torch.cuda.synchronize()
        _margin()
    finally:
        stopped = _profiler_stop(prof)
    engine.run_until_idle()
    if not stopped or not req.ok:
        return None
    kern, margin = _without_margin(
        [e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA])
    cached = engine.completed[-1]["cached_tokens"]
    return dict(w8a16_kernels=sum(1 for e in kern if "w8a16" in e.name),
                forwards=2, cached_tokens=cached, kernels=len(kern),
                margin_kernels_seen=margin)


def pl_kernel_check(model, m):
    """One W8A16 call at the phase's suffix rows (M = ``m``, layer 0's
    fused qkv) against its plain version; max|err| within TOL of max|ref|.
    Called after the counts were read: it does not count."""
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import int8_matmul as tmm

    qkv = model.layer0.attn.qkv
    g = torch.Generator("cuda").manual_seed(m)
    x = torch.randn((m, qkv.kernel_q.shape[0]), generator=g,
                    device="cuda").to(torch.bfloat16)
    got = tmm.int8_matmul(x, qkv.kernel_q, qkv.scale, torch.bfloat16)
    ref = tmm.int8_matmul_reference(x, qkv.kernel_q, qkv.scale,
                                    torch.bfloat16)
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    if not err <= TOL["bfloat16"] * scale:
        raise AssertionError(f"int8_matmul at M={m}: max|err| {err} > "
                             f"{TOL['bfloat16']} * {scale}")
    return dict(m=m, k=int(qkv.kernel_q.shape[0]),
                n=int(qkv.kernel_q.shape[1]), max_abs_err=err,
                max_abs_ref=scale, tol=TOL["bfloat16"])


def pl_cache(model, cache_dtype, stream):
    """Phase 31 on one KV cache: the stream with the prefix cache on and
    off; every request's tokens equal (else the largest logit gap of the
    first parted hit, and a failure); the hits, misses, evictions and
    prompt tokens saved; TTFT and prefill of hits and misses."""
    waves = (stream[:PL_SYSTEMS], stream[PL_SYSTEMS:])
    on, reqs_on, launches_on, wall_on = pl_serve(model, waves)
    off, reqs_off, launches_off, wall_off = pl_serve(
        model, waves, prefix_cache=False)
    stats = on.prefix_cache.stats()
    parted = [i for i, (a, b) in enumerate(zip(reqs_on, reqs_off))
              if not pl_same(a, b)]
    out = dict(cache_dtype=cache_dtype, requests=len(reqs_on), **stats,
               timing_on=pl_timing(on, reqs_on),
               timing_off=pl_timing(off, reqs_off),
               wall_on_s=wall_on, wall_off_s=wall_off,
               rounds_on=len(on.round_seconds),
               rounds_off=len(off.round_seconds),
               w8a16_launches=launches_on,
               w8a16_launches_prefix_off=launches_off, parted=parted)
    if cache_dtype == "compute":
        out["store"] = pl_store_ms(on)
        out["store_bytes"] = int(sum(
            v.numel() * v.element_size() for layer in on._store.values()
            for v in layer.values()))
        prof = pl_profiled_step(model, stream[5][0])
        if prof is not None and \
                prof["w8a16_kernels"] != W8A16_PL * 2:
            raise AssertionError(f"{prof['w8a16_kernels']} w8a16 kernels "
                                 "in a profiled round of 2 forwards")
        out["profiled_round"] = prof
    if parted:
        out["first_diff"] = {i: pl_first_diff(reqs_on[i].tokens,
                                              reqs_off[i].tokens)
                             for i in parted}
        prompt = stream[parted[0]][0]
        out["logit_gap"] = pl_logit_gap(model, prompt, PL_SYSTEM_LEN)
    log(f"[prefix_lora] {json.dumps(out)}")
    if parted:
        raise AssertionError(f"{cache_dtype}: {len(parted)} requests' tokens "
                             f"differ with the prefix cache on: {parted}; "
                             f"logit gap {out['logit_gap']}")
    if stats["prefix_hits"] < PL_MIN_HITS:
        raise AssertionError(f"{stats['prefix_hits']} prefix hits of "
                             f"{len(reqs_on)}, expected {PL_MIN_HITS}")
    return out, reqs_off, launches_on + launches_off


def pl_evict(model, stream, reqs_off):
    """The eviction run (compute cache): 8 slots of 352 rows (176 blocks);
    wave 1, the next 8 requests, 4 cold 320-token prompts, then 8 more
    requests of the stream. The cached ring must shed blocks; the stream's
    tokens equal the cache-off run's."""
    import numpy as np

    rng = np.random.default_rng(32)
    cold = [(rng.integers(0, V, size=320).astype(np.int32), None)
            for _ in range(PL_COLD)]
    mid = PL_SYSTEMS + 8
    engine, reqs, launches, wall = pl_serve(
        model, (stream[:PL_SYSTEMS], stream[PL_SYSTEMS:mid], cold,
                stream[mid:mid + 8]), max_seq_len=PL_EVICT_SEQ)
    stats = engine.prefix_cache.stats()
    parted = [i for i, (a, b) in enumerate(zip(
        reqs[:mid] + reqs[mid + PL_COLD:], reqs_off[:mid + 8]))
        if not pl_same(a, b)]
    out = dict(pool_blocks=engine.scheduler.pool.num_blocks,
               requests=len(reqs), **stats, wall_s=wall,
               w8a16_launches=launches, parted=parted)
    log(f"[prefix_lora] eviction: {json.dumps(out)}")
    if not stats["prefix_evictions"]:
        raise AssertionError("the eviction run evicted nothing")
    if parted:
        raise AssertionError(f"eviction run: {parted} differ from the "
                             "cache-off run")
    return out, launches


def pl_lora(model):
    """LoRA on the 8B (compute cache): a bank of 4 adapters of rank 16 at
    scale 0.3 (adapter 0 the base). One prompt on all 4 adapters and one
    prompt of its own on each, in one batch; adapter 0's rows equal the
    no-bank engine's, each adapter's rows its rows served alone, some
    adapter moves the shared prompt's tokens; then one new prompt on
    adapter 2 and adapter 3 (two misses) and on adapter 2 again (a
    hit)."""
    import numpy as np
    import torch

    from pytorch_distributed_nn_tpu_torch.nn.lora import init_lora_bank
    from pytorch_distributed_nn_tpu_torch.ops import int8_matmul as tmm
    from pytorch_distributed_nn_tpu_torch.serve import ServingEngine

    bank = init_lora_bank(model, generator=torch.Generator().manual_seed(31),
                          **PL_LORA)
    rng = np.random.default_rng(33)
    shared = rng.integers(0, V, size=96).astype(np.int32)
    rows = [(a, shared) for a in range(4)] + [
        (a, rng.integers(0, V, size=int(rng.integers(64, 129)))
         .astype(np.int32)) for a in range(4)]
    launches = 0

    def serve(batch, b=bank):
        nonlocal launches
        engine = ServingEngine(model, max_slots=SERVE_SLOTS, max_seq_len=256,
                               block_size=PL_BLOCK, lora_bank=b)
        tmm.int8_matmul.launches = 0
        reqs = [engine.submit(p, PL_LORA_NEW, adapter=a) for a, p in batch]
        engine.run_until_idle()
        launches += tmm.int8_matmul.launches
        if not all(r.ok for r in reqs):
            raise AssertionError("a LoRA request did not finish")
        return engine, [r.tokens for r in reqs]

    engine, mixed = serve(rows)
    alone = {}
    for a in range(4):
        alone[a] = serve([r for r in rows if r[0] == a])[1]
    base = serve([r for r in rows if r[0] == 0], b=None)[1]
    by = {a: [t for (aa, _), t in zip(rows, mixed) if aa == a]
          for a in range(4)}
    out = dict(adapters=PL_LORA["num_adapters"], rank=PL_LORA["rank"],
               scale=PL_LORA["scale"], requests=len(rows),
               bank_bytes=int(sum(v.numel() * 4 for v in bank.values())),
               adapter0_equals_no_bank=all(
                   np.array_equal(x, y) for x, y in zip(by[0], base)),
               mixed_equals_alone={a: all(np.array_equal(x, y) for x, y in
                                          zip(by[a], alone[a]))
                                   for a in range(4)},
               moved_from_base=[a for a in range(1, 4)
                                if not np.array_equal(mixed[a], mixed[0])])
    before = engine.prefix_cache.stats()
    other = rng.integers(0, V, size=80).astype(np.int32)
    seq = []
    for a in (2, 3, 2):
        r = engine.submit(other, 2, adapter=a)
        engine.run_until_idle()
        seq.append(engine.completed[-1]["cached_tokens"])
    after = engine.prefix_cache.stats()
    out.update(cached_tokens_2_3_2=seq,
               misses=after["prefix_misses"] - before["prefix_misses"],
               hits=after["prefix_hits"] - before["prefix_hits"],
               w8a16_launches=launches)
    log(f"[prefix_lora] lora: {json.dumps(out)}")
    if not out["adapter0_equals_no_bank"]:
        raise AssertionError("adapter 0 differs from the engine without a "
                             "bank")
    if not all(out["mixed_equals_alone"].values()):
        raise AssertionError(f"mixed batch != alone: "
                             f"{out['mixed_equals_alone']}")
    if not out["moved_from_base"]:
        raise AssertionError("no adapter moved a token from the base")
    if not (seq[0] == 0 and seq[1] == 0 and seq[2] > 0):
        raise AssertionError(f"adapter namespaces: cached tokens {seq} for "
                             "one prompt on adapters 2, 3, 2")
    return out, launches


def phase_prefix_lora(model):
    """Phase 31: the prefill rows' bits, the prefix cache on the compute
    and the int8 KV cache, the eviction run, LoRA, and one W8A16 call at
    the suffix's rows."""
    import gc

    import torch

    t0 = time.monotonic()
    stream = pl_stream()
    by_dtype, launches = {}, {}
    rows = {}
    for cache_dtype in ("compute", "int8"):
        m = model if cache_dtype == "compute" else twin(
            model, "bfloat16", cache_dtype)
        rows[cache_dtype] = pl_rows(m, cache_dtype)
        by_dtype[cache_dtype], reqs_off, launches[cache_dtype] = pl_cache(
            m, cache_dtype, stream)
        if cache_dtype == "compute":
            evict, launches["evict"] = pl_evict(m, stream, reqs_off)
        del m
        gc.collect()
        torch.cuda.empty_cache()
    lora, launches["lora"] = pl_lora(model)
    suffixes = sorted(len(p) - PL_SYSTEM_LEN for p, _ in stream)
    check = pl_kernel_check(model, suffixes[len(suffixes) // 2])
    out = dict(by_dtype, rows=rows, evict=evict, lora=lora,
               w8a16_at_suffix=check, seconds=time.monotonic() - t0)
    log(f"[prefix_lora] phase 31 in {out['seconds']:.1f} s")
    return out, launches


# ---------------------------------------------------------------------------
# rule 3: the trainer features (checkpoints, accumulation, label smoothing,
# multistep as CUDA graphs, remat offload)
# ---------------------------------------------------------------------------
CKPT_TOL = 1e-6  # resume against the straight run: max|d| / max|ref|
PREEMPT_TIMEOUT = 300  # seconds for the SIGTERM'd subprocess


def state_copy(trainer):
    import torch

    return {k: v.detach().clone() for k, v in
            trainer.state.state_dict().items()}


def state_diff(got, want):
    """max|got - want| / max|want| over the float tensors of two state
    dicts, and whether every tensor is bit for bit equal."""
    import torch

    worst, bitwise = 0.0, True
    for k, w in want.items():
        g = got[k]
        if not torch.equal(g.cpu(), w.cpu()):
            bitwise = False
        if w.is_floating_point() and w.numel():
            scale = max(w.float().abs().max().item(), 1e-30)
            worst = max(worst, (g.float() - w.float()).abs().max().item()
                        / scale)
    return worst, bitwise


# phase ckpt's llama3_longcontext: full width and T, cut to 1 of its 8
# layers (the script's time limit; PERF.md §4)
CKPT_LAYERS = 1


def ckpt_overrides():
    from pytorch_distributed_nn_tpu_torch.config import get_config

    extra = dict(get_config("llama3_longcontext").model.extra,
                 num_layers=CKPT_LAYERS)
    return {"model.extra": json.dumps(extra)}


def phase_ckpt():
    """llama3_longcontext (T 32768, flash at D 128) at CKPT_LAYERS: 4 straight
    steps against 2 steps with an asynchronous save every 2 steps, a fresh
    Trainer that resumes, and 2 more steps; then the newest step torn (the
    restore falls back to the one before), then the train entry point in
    a subprocess with TPUNN_PREEMPT=1 sent SIGTERM: exit 83 and a
    checkpoint that resumes."""
    import shutil
    import signal
    import tempfile

    import torch

    from pytorch_distributed_nn_tpu_torch.runtime import failure
    from pytorch_distributed_nn_tpu_torch.train.checkpoint import (
        CheckpointManager,
    )

    root = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        straight = longcontext(**ckpt_overrides())
        straight.train(steps=2)
        at2 = state_copy(straight)
        straight.train(steps=2)
        want_losses, want = straight.losses(), state_copy(straight)
        straight_s = [r.seconds for r in straight.history]
        del straight
        torch.cuda.empty_cache()

        ckdir = os.path.join(root, "run")
        ov = {"checkpoint_dir": ckdir, "checkpoint_every": "2",
              **ckpt_overrides()}
        first = longcontext(**ov)
        L = first.model.num_layers
        reset_flash_counts()
        first.train(steps=2)  # queues the save of step 2
        t0 = time.perf_counter()
        first.close()  # drains the writer
        drain_s = time.perf_counter() - t0
        save1 = dict(first.ckpt.last_save)
        first_s = [r.seconds for r in first.history]
        first_losses = first.losses()
        del first
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed = longcontext(**ov)  # restores step 2 in its constructor
        torch.cuda.synchronize()
        construct_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        resumed.ckpt.restore(resumed.state)  # once more, timed alone
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if resumed.data_step != 2 or resumed.state.step != 2:
            raise AssertionError(f"resumed at {resumed.data_step}")
        resumed.train(steps=2)  # queues the save of step 4
        resumed_s = [r.seconds for r in resumed.history]
        t0 = time.perf_counter()
        resumed.ckpt.wait()
        drain2_s = time.perf_counter() - t0
        launches = flash_counts()
        want_l = {"flash_fwd": 2 * L * 4, "flash_bwd_dq": L * 4,
                  "flash_bwd_dkv": L * 4}
        if launches != want_l:
            raise AssertionError(f"flash launches {launches} in 2 + 2 "
                                 f"steps, expected {want_l}")
        got_losses = first_losses + resumed.losses()
        got = state_copy(resumed)
        resumed.close()
        del resumed
        torch.cuda.empty_cache()
        loss_d = max(abs(a - b) / abs(b) for a, b in zip(got_losses,
                                                          want_losses))
        param_d, bitwise = state_diff(got, want)
        log(f"[ckpt] losses straight {want_losses} resumed {got_losses}; "
            f"max rel {loss_d:.3e}; state max|d|/max|ref| {param_d:.3e}, "
            f"bitwise {bitwise}")
        if not (loss_d <= CKPT_TOL and param_d <= CKPT_TOL):
            raise AssertionError(f"resume disagrees with the straight run "
                                 f"(limit {CKPT_TOL})")
        # the newest step torn: the restore falls back to step 2
        mgr = CheckpointManager(ckdir)
        if mgr.all_steps() != [2, 4]:
            raise AssertionError(f"steps on disk {mgr.all_steps()}")
        torn = os.path.join(ckdir, "4", "optim.pt")
        with open(torn, "r+b") as f:
            f.truncate(os.path.getsize(torn) // 2)
        fallback = longcontext(**ov)
        fb_step = fallback.data_step
        fb_d, fb_bitwise = state_diff(state_copy(fallback), at2)
        fallback.close()
        del fallback
        torch.cuda.empty_cache()
        if fb_step != 2 or fb_d > CKPT_TOL:
            raise AssertionError(f"torn step 4: restored {fb_step}, "
                                 f"max|d| {fb_d:.3e}")
        # SIGTERM to the train entry point with TPUNN_PREEMPT=1
        pdir = os.path.join(root, "preempt")
        cmd = [sys.executable, "-m", "pytorch_distributed_nn_tpu_torch.train",
               "--preset", "llama3_longcontext", "--steps", "1000",
               "--log_every", "1", "--checkpoint_dir", pdir,
               "--model.extra", ckpt_overrides()["model.extra"]]
        env = dict(os.environ, TPUNN_PREEMPT="1",
                   PYTHONPATH=HERE + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=HERE, env=env,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True)
        try:
            for line in proc.stderr:
                if "step 1 loss" in line:
                    break
                if time.perf_counter() - t0 > PREEMPT_TIMEOUT:
                    raise AssertionError("the subprocess logged no step 1")
            t_term = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            _, err = proc.communicate(timeout=PREEMPT_TIMEOUT)
            exit_s = time.perf_counter() - t_term
        finally:
            proc.kill()
            proc.wait()
        if proc.returncode != failure.GRACEFUL_EXIT_CODE:
            raise AssertionError(f"SIGTERM: exit {proc.returncode}, want "
                                 f"{failure.GRACEFUL_EXIT_CODE}: "
                                 f"{err[-2000:]}")
        saved = CheckpointManager(pdir).latest_step()
        after = longcontext(checkpoint_dir=pdir, **ckpt_overrides())
        if saved is None or after.data_step != saved:
            raise AssertionError(f"preempted run saved {saved}, resumed at "
                                 f"{after.data_step}")
        after.train(steps=1)
        if not math.isfinite(after.losses()[-1]):
            raise AssertionError("the resumed run's loss")
        after.close()
        del after
        torch.cuda.empty_cache()
        result = dict(
            card=card_line(), losses=got_losses, straight=want_losses,
            loss_max_rel_diff=loss_d, state_max_rel_diff=param_d,
            bitwise=bitwise, tolerance=CKPT_TOL,
            checkpoint_bytes=save1["bytes"], write_s=save1["seconds"],
            drain_s=drain_s, drain_step4_s=drain2_s,
            restore_s=restore_s, resume_construct_s=construct_s,
            step_s_with_save=first_s, step_s_straight=straight_s[:2],
            save_step_added_s=first_s[1] - straight_s[1],
            # the second save in the process reuses freed pinned blocks
            step_s_with_second_save=resumed_s,
            step_s_straight_3_4=straight_s[2:],
            second_save_step_added_s=resumed_s[1] - straight_s[3],
            launches=launches, fallback_step=fb_step,
            fallback_bitwise=fb_bitwise, preempt_exit=proc.returncode,
            preempt_saved_step=saved, preempt_exit_s=exit_s)
        log(f"[ckpt] {json.dumps(result)}")
        return result
    finally:
        shutil.rmtree(root, ignore_errors=True)


ACCUM_GRAD_TOL = 5e-2  # max|err| / max|ref| a gradient, bf16 compute
ACCUM_LOSS_TOL = 1e-3  # relative
# the accum-1 step of this model on the same card (PERF.md §6)
LM_ACCUM1_REF = dict(step_s=0.5044, peak_gb=37.92)


def phase_accum():
    """transformer_lm_pp (--mesh.pipe 1 --parallel.strategy dp) with
    grad_accum 4 and label_smoothing 0.1: B 64 as 4 x 16, T 1024, the
    dense loss, flash at D 64. One step's loss and gradients against
    accum 1 on the same batch; 1 warm-up and 3 timed steps, flash counts
    reset before and read after. Then resnet50_dp as the preset sets it
    (dp, overlap) with bn_impl=pallas, batch 256, grad_accum 2: bn_stats
    on each microbatch."""
    import torch

    from pytorch_distributed_nn_tpu_torch.parallel import dp, zero

    ov = {"parallel.grad_accum": "4", "label_smoothing": "0.1"}
    gc.collect()  # earlier phases' reference cycles (the overlap hooks)
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    trainer = lm_trainer(**ov)
    model, L = trainer.model, trainer.model.num_layers
    x, y = trainer.loader.batch_at(0)
    out = {}
    for accum in (4, 1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if accum == 1:
            loss = dp._loss_and_grads(trainer.state, x, y, trainer.loss_fn)
        else:
            loss = zero._accumulate(trainer.state, x, y, trainer.loss_fn,
                                    accum, None, 1)
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        trainer.state.optimizer.zero_grad()
        out[accum] = (loss.item(), grads,
                      torch.cuda.max_memory_allocated() / 1e9)
        del grads
    loss_err = abs(out[4][0] - out[1][0]) / abs(out[1][0])
    grad_err = lm_grad_errors(out[4][1], out[1][1])
    worst_g = max(grad_err, key=grad_err.get)
    check = dict(loss_accum4=out[4][0], loss_accum1=out[1][0],
                 loss_rel_err=loss_err, worst_grad=worst_g,
                 worst_grad_rel_err=grad_err[worst_g],
                 peak_gb_one_grad_accum4=out[4][2],
                 peak_gb_one_grad_accum1=out[1][2])
    log(f"[accum] transformer_lm_pp one step, accum 4 vs 1: "
        f"{json.dumps(check)}")
    if not (loss_err <= ACCUM_LOSS_TOL
            and grad_err[worst_g] <= ACCUM_GRAD_TOL):
        raise AssertionError(f"accum 4 disagrees with accum 1 (limits "
                             f"{ACCUM_LOSS_TOL}, {ACCUM_GRAD_TOL})")
    del out
    torch.cuda.empty_cache()
    trainer.train(steps=1)  # warm-up
    steps = 3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()  # the path's count starts here
    trainer.train(steps=steps)
    lm_launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_fwd": 4 * 2 * L * steps, "flash_bwd_dq": 4 * L * steps,
            "flash_bwd_dkv": 4 * L * steps}
    if lm_launches != want:
        raise AssertionError(f"flash launches {lm_launches}, want {want}")
    losses = trainer.losses()[-steps:]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"losses {losses}")
    step_s, _ = step_stats(trainer, steps)
    prof = profile_step(trainer)  # one more step, profiled
    if prof is not None:
        prof["idle_share_vs_unprofiled_step"] = (
            1 - prof["device_ms"] / (step_s * 1e3))
    lm = dict(card=card_line(), check=check, losses=losses, profile=prof,
              median_step_s=step_s, tokens_per_s=LM_B * LM_T / step_s,
              peak_mem_gb=peak / 1e9, resident_before_gb=resident / 1e9,
              accum1_reference=LM_ACCUM1_REF,
              launches=lm_launches)
    log(f"[accum] transformer_lm_pp accum 4: {json.dumps(lm)}")
    del trainer, model
    torch.cuda.empty_cache()

    rn = resnet_trainer(**{"data.batch_size": str(DP_BATCH),
                           "log_every": "1", "parallel.grad_accum": "2",
                           "model.extra": json.dumps({"bn_impl": "pallas"})})
    if not (rn.cfg.parallel.strategy == "dp" and rn.cfg.parallel.overlap):
        raise AssertionError("resnet50_dp's preset strategy")
    rn.train(steps=1)  # warm-up: cuDNN picks its algorithms
    steps = 3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_dp_counts()
    rn.train(steps=steps)
    bn_launches = bn_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"sum_and_sumsq": 2 * RESNET_BN_PER_STEP * steps,
            "sum_and_dot": 2 * RESNET_BN_PER_STEP * steps}
    if bn_launches != want:
        raise AssertionError(f"bn_stats launches {bn_launches}, want {want}")
    losses = rn.losses()[-steps:]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"losses {losses}")
    step_s, wait_s = step_stats(rn, steps)
    resnet = dict(card=card_line(), losses=losses, median_step_s=step_s,
                  images_per_s=DP_BATCH / step_s,
                  loader_wait_s_per_step=wait_s, peak_mem_gb=peak / 1e9,
                  launches=bn_launches)
    log(f"[accum] resnet50_dp accum 2: {json.dumps(resnet)}")
    del rn
    torch.cuda.empty_cache()
    return dict(transformer_lm_pp=lm, resnet50_dp=resnet), lm_launches, \
        bn_launches


def timed_s(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def eager_on_pool(trainer, steps, pool):
    """``steps`` eager steps cycling the device-resident ``pool`` (the
    multistep pool mode's batches, without a graph); the losses."""
    xs, ys = pool
    out = []
    for i in range(steps):
        trainer.state, m = trainer.step_fn(trainer.state, xs[i % len(xs)],
                                           ys[i % len(ys)])
        out.append(m["loss"])
    return [v.item() for v in out]


# the bn_stats kernels by name in a device trace, demangled or not:
# bn_partial<T, kDot> (csrc/bn_stats.cu) is launched once by each wrapper
# call
BN_KERNELS = {
    "sum_and_sumsq": r"bn_partial<[^<>]*,\s*false>|bn_partialI\w*?Lb0E",
    "sum_and_dot": r"bn_partial<[^<>]*,\s*true>|bn_partialI\w*?Lb1E"}


def graph_vs_eager(preset, k, pool, steps, timed_steps, profile=0,
                   deterministic=False, **ov):
    """The preset with ``multistep_k k`` (and the pool) against eager
    steps on the same batches from the same seed: losses bit for bit over
    ``steps`` (with ``deterministic``, under cuDNN's deterministic
    algorithms); then ``timed_steps`` more of each, timed (synchronised),
    under the caller's cuDNN setting (with ``deterministic``, on a graph
    captured anew); then ``profile`` more replays, each under
    torch.profiler, in which the bn_stats kernels are counted by name.
    The profiler can lose kernel records (:data:`MARGIN_KERNELS`), never
    adds any, and every replay runs the same graph: so the count taken is
    each kernel's most over the profiled replays, and each replay's
    counts are reported."""
    import torch

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    def make(**extra):
        cfg = get_config(preset, log_every="1", **ov, **extra)
        return Trainer(cfg, device="cuda")

    mov = {"multistep_k": str(k)}
    if pool:
        mov["multistep_pool"] = str(pool)

    pools = {}  # each eager trainer's device-resident pool, made once

    def run_eager(trainer, n):
        if pool:
            if id(trainer) not in pools:
                pools[id(trainer)] = trainer.loader.stacked_batch_at(0, pool)
            return eager_on_pool(trainer, n, pools[id(trainer)])
        trainer.train(steps=n)
        return trainer.losses()[-n:]

    setting = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = setting or deterministic
    try:
        graph = make(**mov)
        n0 = bn_counts()
        graph.train(steps=steps)
        n1 = bn_counts()
        eager = make()
        eager_losses = run_eager(eager, steps)
        graph_losses = graph.losses()
        if graph_losses != eager_losses:
            raise AssertionError(f"{preset}: graph losses {graph_losses} "
                                 f"vs eager {eager_losses}")
        replays_checked = graph._multisteps[k].replays
    finally:
        torch.backends.cudnn.deterministic = setting
    if deterministic:  # time the caller's setting: capture anew
        del graph, eager
        pools.clear()
        torch.cuda.empty_cache()
        graph, eager = make(**mov), make()
        graph.train(steps=k)
        run_eager(eager, k)
    graph.cfg.log_every = eager.cfg.log_every = 0
    t_graph = timed_s(lambda: graph.train(steps=timed_steps))
    t_eager = timed_s(lambda: run_eager(eager, timed_steps))
    profs = [p for p in (profile_step(graph, steps=k, count=BN_KERNELS)
                         for _ in range(profile)) if p is not None]
    prof = counted = None
    if profs:
        counted = {m: max(p["counted"][m] for p in profs) for m in BN_KERNELS}
        prof = max(profs, key=lambda p: p["kernels"])
        prof["idle_share_vs_unprofiled_replay"] = (
            1 - prof["device_ms"] / (t_graph * k / timed_steps * 1e3))
        prof["each_replay"] = [
            dict(kernels=p["kernels"], counted=p["counted"],
                 margin_kernels_seen=p["margin_kernels_seen"])
            for p in profs]
    out = dict(k=k, pool=pool, steps=steps, losses_bitwise=True,
               losses_cudnn_deterministic=deterministic or setting,
               timed_cudnn_deterministic=setting, graph_profile=prof,
               replays_checked=replays_checked,
               replays=graph._multisteps[k].replays,
               timed_steps=timed_steps, graph_s=t_graph, eager_s=t_eager,
               # wrapper calls while the first dispatch warmed up (1 step)
               # and captured (k steps); a replay calls no wrapper
               bn_stats_warmup_and_capture={m: n1[m] - n0[m] for m in n1},
               bn_stats_in_profiled_replay=counted)
    del graph, eager
    return out


def phase_multistep():
    """mlp_mnist as it is (batch 128): multistep_k 20 fresh and with
    multistep_pool 4, 40 steps (two replays) against 40 eager steps, bit
    for bit, then 200 timed steps each way; resnet50_dp at batch 256 with
    bn_impl=pallas, multistep_k 4 and multistep_pool 4: 8 steps against
    eager, bit for bit under cuDNN's deterministic algorithms, then, on a
    graph captured anew under the default setting, 12 timed steps each
    way (the device's images/s apart from the host's loader) and three
    profiled replays, whose traces must show 4 x 53 launches of each
    bn_stats kernel."""
    import torch

    result = {}
    for pool in (0, 4):
        r = graph_vs_eager("mlp_mnist", 20, pool, 40, 200)
        b = 128
        r.update(card=card_line(), graph_samples_per_s=b * 200 / r["graph_s"],
                 eager_samples_per_s=b * 200 / r["eager_s"])
        result[f"mlp_mnist_pool{pool}"] = r
        log(f"[multistep] mlp_mnist k 20 pool {pool}: {json.dumps(r)}")
    torch.cuda.empty_cache()
    reset_dp_counts()
    r = graph_vs_eager("resnet50_dp", 4, 4, 8, 12, profile=3,
                       deterministic=True, **{
                           "data.batch_size": str(DP_BATCH),
                           "model.extra": json.dumps({"bn_impl": "pallas"})})
    r.update(card=card_line(),
             graph_images_per_s=DP_BATCH * 12 / r["graph_s"],
             eager_images_per_s=DP_BATCH * 12 / r["eager_s"])
    log(f"[multistep] resnet50_dp k 4 pool 4: {json.dumps(r)}")
    want = RESNET_BN_PER_STEP * 4
    if r["bn_stats_in_profiled_replay"] != {"sum_and_sumsq": want,
                                            "sum_and_dot": want}:
        raise AssertionError("bn_stats kernels in the profiled replay "
                             f"{r['bn_stats_in_profiled_replay']}, want "
                             f"{want} of each")
    if r["bn_stats_warmup_and_capture"] != {
            "sum_and_sumsq": 5 * RESNET_BN_PER_STEP,
            "sum_and_dot": 5 * RESNET_BN_PER_STEP}:
        raise AssertionError("bn_stats wrapper calls in warm-up and capture "
                             f"{r['bn_stats_warmup_and_capture']}")
    result["resnet50_dp"] = r
    torch.cuda.empty_cache()
    return result


# the 96k step without offload on the same card (PERF.md §6)
OFFLOAD_REF = dict(step_s=3.39, peak_gb=11.30)


def phase_offload():
    """llama3_longcontext_96k (T 98304, flash at D 128), 2 steps with
    model.remat_offload against the same 2 steps without: losses bit for
    bit; peak memory and step time of each."""
    import torch

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    out = {}
    for offload in (True, False):
        # earlier phases' trainers hold reference cycles (the overlap
        # hooks): collected here, so the peak is this run's
        gc.collect()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        cfg = get_config("llama3_longcontext_96k", log_every="1",
                         **{"model.remat_offload": str(offload)})
        trainer = Trainer(cfg, device="cuda")
        L = trainer.model.num_layers
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_flash_counts()
        trainer.train(steps=2)
        launches = flash_counts()
        want = {"flash_fwd": 2 * L * 2, "flash_bwd_dq": L * 2,
                "flash_bwd_dkv": L * 2}
        if launches != want:
            raise AssertionError(f"flash launches {launches}, want {want}")
        out[offload] = dict(
            losses=trainer.losses(),
            step_s=[r.seconds for r in trainer.history],
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            resident_before_gb=resident / 1e9,
            launches=launches, offloaded=dict(trainer.model.offloaded),
            layers=L)
        del trainer
        torch.cuda.empty_cache()
    on, off = out[True], out[False]
    if on["losses"] != off["losses"] or not all(
            math.isfinite(v) for v in on["losses"]):
        raise AssertionError(f"offload losses {on['losses']} vs "
                             f"{off['losses']}")
    if not (on["offloaded"]["pinned"]
            and on["offloaded"]["tensors"] == on["layers"]):
        raise AssertionError(f"offloaded {on['offloaded']}")
    result = dict(card=card_line(), offload=on, no_offload=off,
                  reference=OFFLOAD_REF)
    log(f"[offload] {json.dumps(result)}")
    return result, on["launches"]


# ---------------------------------------------------------------------------
# the sharded strategies: ZeRO (config 5) and the pipeline (config 4)
# ---------------------------------------------------------------------------
# config 5's attention: Llama-3-8B's 32 query and 8 KV heads of 128, T 4096
Z8_B, Z8_T, Z8_H, Z8_HKV, Z8_D = 1, 4096, 32, 8, 128
Z8_STEPS = 3  # timed ZeRO steps (after one warm-up step)
Z8_LOSS_TOL = 1e-6  # relative, zero-3 against dp at world 1 (same step)
PIPE_STEPS = 3
PIPE_LOSS_TOL = 1e-3  # relative, bf16: schedules against each other and dp
PIPE_SCHEDULES = (("gpipe", 1), ("1f1b", 1), ("interleaved", 3))


def phase_flash8b(flush):
    """The three flash kernels at config 5's shape (B 1, T 4096, H 32,
    Hkv 8 (GQA group 4), D 128, causal, bf16), every output in full
    against the plain versions; times of each kernel, its plain version,
    its bound and SDPA's forward and backward."""
    import torch
    import torch.nn.functional as F

    from pytorch_distributed_nn_tpu_torch.ops import flash_attention as fa

    g = torch.Generator("cuda").manual_seed(8)

    def r(h):
        return torch.randn((Z8_B, Z8_T, h, Z8_D), generator=g,
                           device="cuda").to(torch.bfloat16)

    q, k, v, do = r(Z8_H), r(Z8_HKV), r(Z8_HKV), r(Z8_H)
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.flash_delta(o, do)
    args = (q, k, v, do, lse, delta, True)
    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_forward_reference(q, k, v, True)
    errs = {"flash_fwd": flash_check("flash_fwd O, config 5", o, o_ref)}
    lse_err = (lse - lse_ref).abs().max().item()
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"flash_fwd lse, config 5: {lse_err}")
    errs["flash_bwd_dq"] = flash_check("flash_bwd_dq, config 5", dq,
                                       fa.flash_bwd_dq_reference(*args))
    dk_ref, dv_ref = fa.flash_bwd_dkv_reference(*args)
    errs["flash_bwd_dkv"] = worst(
        flash_check("flash_bwd_dkv dk, config 5", dk, dk_ref),
        flash_check("flash_bwd_dkv dv, config 5", dv, dv_ref))
    del o_ref, lse_ref, dk_ref, dv_ref
    torch.cuda.empty_cache()
    kern = {"flash_fwd": lambda: fa.flash_fwd(q, k, v, True),
            "flash_bwd_dq": lambda: fa.flash_bwd_dq(*args),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(*args)}
    plain = {"flash_fwd": lambda: fa.flash_forward_reference(q, k, v, True),
             "flash_bwd_dq": lambda: fa.flash_bwd_dq_reference(*args),
             "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_reference(*args)}
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    with torch.no_grad():
        lib_fwd = time_ms(sdpa, 10, flush)
    out_t = sdpa()
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out_t, (qt, kt, vt), dot, retain_graph=True), 10, flush)
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd,
               "flash_bwd_dkv": lib_bwd}
    out = {}
    for name in FLASH_KERNELS:
        ms = time_ms(kern[name], 10, flush)
        plain[name]()  # warm-up
        plain_ms = time_once_ms(plain[name])
        torch.cuda.empty_cache()
        bound, by = flash_bound_ms(name, Z8_T, Z8_B, Z8_H, Z8_HKV, Z8_D)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library[name],
                         bound_ms=bound, bound_by=by, card=card_line(),
                         share_of_bound=bound / ms, **errs[name],
                         tflops=FLASH_KERNELS[name][1] * Z8_B * Z8_H * Z8_T
                         * Z8_T * Z8_D / ms / 1e9)
        log(f"[flash8b] {name} B={Z8_B} T={Z8_T} H={Z8_H} Hkv={Z8_HKV} "
            f"D={Z8_D}: {json.dumps(out[name])}")
    log(f"[flash8b] lse max|err| {lse_err:.3e}; library yardstick: "
        "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True) "
        "forward, and its backward (dq, dk and dv in one call)")
    del qt, kt, vt, out_t, q, k, v, do, o, lse, delta, dq, dk, dv
    torch.cuda.empty_cache()
    return out


def zero8b_trainer(strategy):
    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    cfg = get_config("llama3_8b_zero", log_every="1", **{
        "model.extra": json.dumps({"num_layers": 8}),
        "data.batch_size": "1", "parallel.strategy": strategy})
    return Trainer(cfg, device="cuda")  # seeded init (cfg.seed)


def phase_zero8b():
    """Config 5 on one card: llama3_8b_zero at full width (d 4096, 32/8
    heads of 128, MLP 14336, vocab 128256, T 4096, xent_chunk 2048, remat,
    adamw with clip 1.0, zero_stage 3) cut to 8 of 32 layers and batch 1
    (one card's share of the preset's 16 on a 16-card fsdp mesh), NCCL at
    world 1: one warm-up step, then 3 steps with the flash counts reset
    just before and read just after (16 forward, 8 dq, 8 dk/dv a step) and
    no collective issued; tokens/s, MFU, peak memory; one profiled step;
    then the dp step from the same weights on the same batches, whose
    losses the zero-3 losses equal."""
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
    from pytorch_distributed_nn_tpu_torch.parallel.zero import ZeroShards
    from pytorch_distributed_nn_tpu_torch.utils.flops import (
        transformer_train_flops_per_token,
    )

    gc.collect()
    torch.cuda.empty_cache()
    trainer = zero8b_trainer("zero")
    model, cfg = trainer.model, trainer.cfg
    zs = trainer.state.sharding
    if not (isinstance(zs, ZeroShards) and zs.stage == 3
            and cfg.parallel.zero_stage == 3 and model.num_layers == 8
            and model.d_model == 4096 and model.num_heads == Z8_H
            and model.num_kv_heads == Z8_HKV and cfg.data.seq_len == Z8_T
            and cfg.xent_chunk == 2048 and cfg.model.remat
            and cfg.optim.grad_clip_norm == 1.0):
        raise AssertionError("llama3_8b_zero is not config 5 at depth 8")
    if zs.shards or zs.active:
        raise AssertionError("at world 1 zero-3 splits nothing")
    L = model.num_layers
    n_params = sum(p.numel() for p in model.parameters())
    trainer.train(steps=1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()  # the main path's count starts here
    with cc.recording() as records:
        trainer.train(steps=Z8_STEPS)
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_fwd": 2 * L * Z8_STEPS, "flash_bwd_dq": L * Z8_STEPS,
            "flash_bwd_dkv": L * Z8_STEPS}
    if launches != want:
        raise AssertionError(f"flash launches {launches}, want {want}")
    if records:
        raise AssertionError(f"collectives at world 1: {records[:3]}")
    losses = trainer.losses()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"losses {losses}")
    per_token = transformer_train_flops_per_token(model, Z8_T, causal=True)
    report = train_report(trainer, Z8_STEPS, per_token, Z8_B * Z8_T, peak)
    zero_losses = trainer.losses()[:1 + Z8_STEPS]
    del trainer, model, zs
    gc.collect()
    torch.cuda.empty_cache()
    ref = zero8b_trainer("dp")
    ref.train(steps=1 + Z8_STEPS)
    dp_losses = ref.losses()
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    err = max(abs(a - b) / abs(b) for a, b in zip(zero_losses, dp_losses))
    log(f"[zero8b] zero-3 losses {zero_losses} vs dp {dp_losses} "
        f"(max rel {err:.3e})")
    if not err <= Z8_LOSS_TOL:
        raise AssertionError(f"zero-3 against dp: {err} > {Z8_LOSS_TOL}")
    result = dict(launches=launches, params=n_params, layers=L,
                  zero_losses=zero_losses, dp_losses=dp_losses,
                  loss_rel_err_vs_dp=err, collectives=len(records),
                  **{k: v for k, v in report.items() if k != "losses"})
    log(f"[zero8b] {json.dumps(result)}")
    return result, launches


def phase_pipe():
    """Config 4 as the preset sets it: transformer_lm_pp with mesh.pipe 4,
    8 microbatches, B 64, T 1024, 12 layers, d 768, 12 heads of 64, remat,
    adam, every stage held by this one process (the local transport).
    gpipe, then 1f1b, then interleaved with pipe_chunks 3, each 3 steps
    from the same weights with the flash counts reset just before and
    read just after (2 L M forward, L M dq, L M dk/dv a step); then the
    --mesh.pipe 1 --parallel.strategy dp run: losses against each other
    to PIPE_LOSS_TOL; peak memory, step time and the most microbatches a
    stage held, for each. The stages run one after another on one card:
    the step time is no pipeline's and measures no bubble."""
    import torch

    from pytorch_distributed_nn_tpu_torch.parallel.pipeline import (
        PipelineStages,
    )
    from pytorch_distributed_nn_tpu_torch.utils.flops import (
        transformer_train_flops_per_token,
    )

    out, launches = {}, {}
    for schedule, chunks in PIPE_SCHEDULES:
        gc.collect()
        torch.cuda.empty_cache()
        trainer = lm_trainer(**{"mesh.pipe": "4",
                                "parallel.strategy": "pipeline",
                                "parallel.pipeline_schedule": schedule,
                                "parallel.pipe_chunks": str(chunks)})
        st, cfg = trainer.state.sharding, trainer.cfg
        L, M = trainer.model.num_layers, cfg.parallel.microbatches
        if not (isinstance(st, PipelineStages) and st.S == 4
                and st.devices == [0, 1, 2, 3] and M == 8
                and (cfg.data.batch_size, cfg.data.seq_len) == (LM_B, LM_T)
                and cfg.model.remat and trainer.model.head_dim == LM_D):
            raise AssertionError(f"transformer_lm_pp under {schedule}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_flash_counts()
        trainer.train(steps=PIPE_STEPS)
        got = flash_counts()
        want = {"flash_fwd": 2 * L * M * PIPE_STEPS,
                "flash_bwd_dq": L * M * PIPE_STEPS,
                "flash_bwd_dkv": L * M * PIPE_STEPS}
        if got != want:
            raise AssertionError(f"{schedule}: flash launches {got}, want "
                                 f"{want}")
        losses = trainer.losses()
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{schedule}: losses {losses}")
        step_s, _ = step_stats(trainer, PIPE_STEPS)
        flops = transformer_train_flops_per_token(
            trainer.model, LM_T, causal=True) * LM_B * LM_T
        out[schedule] = dict(
            pipe_chunks=chunks, losses=losses,
            step_s=[r.seconds for r in trainer.history],
            median_step_s=step_s, tokens_per_s=LM_B * LM_T / step_s,
            mfu=flops / step_s / BF16_OPS_PER_S,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            most_live_microbatches=dict(st.peak_live), launches=got)
        launches[schedule] = got
        log(f"[pipe] {schedule}: {json.dumps(out[schedule])}")
        del trainer, st
    gc.collect()
    torch.cuda.empty_cache()
    ref = lm_trainer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ref.train(steps=PIPE_STEPS)
    step_s, _ = step_stats(ref, PIPE_STEPS)
    flops = transformer_train_flops_per_token(
        ref.model, LM_T, causal=True) * LM_B * LM_T
    out["dp"] = dict(losses=ref.losses(), median_step_s=step_s,
                     tokens_per_s=LM_B * LM_T / step_s,
                     mfu=flops / step_s / BF16_OPS_PER_S,
                     peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    want = out["dp"]["losses"]
    errs = {name: max(abs(a - b) / abs(b)
                      for a, b in zip(out[name]["losses"], want))
            for name, _ in PIPE_SCHEDULES}
    log(f"[pipe] losses against dp (max rel): {errs}")
    if not max(errs.values()) <= PIPE_LOSS_TOL:
        raise AssertionError(f"pipeline losses against dp: {errs} > "
                             f"{PIPE_LOSS_TOL}")
    if out["1f1b"]["most_live_microbatches"] != {
            s: min(8, 2 * (4 - s) - 1) for s in range(4)}:
        raise AssertionError("1f1b held more microbatches than 2(S-s)-1")
    result = dict(card=card_line(), loss_rel_err_vs_dp=errs, **out)
    log(f"[pipe] {json.dumps(result)}")
    return result, launches


MOE_B, MOE_T, MOE_D = 32, 1024, 64  # moe_lm_ep as it is
MOE_STEPS = 3  # timed steps (after one warm-up step)
# one full-width step's loss, flash kernels against the plain attention
# from the same weights and batch: the two round to bf16 at other places,
# and a routing choice that flips on a tie-close pair moves a few tokens'
# terms of the mean
MOE_LOSS_TOL = 1e-3  # relative
# the flash kernels' names in a device trace
FLASH_RX = {"flash_fwd": r"flash_fwd_kernel", "flash_bwd_dq":
            r"flash_bwd_dq_kernel", "flash_bwd_dkv": r"flash_bwd_dkv_kernel"}


def phase_moe():
    """moe_lm_ep at full width on one card (NCCL, world 1, expert 1:
    nothing split): one step's loss with the flash kernels against the
    plain attention's forward loss from the same weights and batch; a
    warm-up and MOE_STEPS steps with the flash counts reset just before
    and read just after (L forward, L dq, L dk/dv a step) and no
    collective; tokens/s, MFU, peak memory, the routing's dropped
    fraction; one profiled step with the flash kernels counted by name."""
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
    from pytorch_distributed_nn_tpu_torch.parallel import dp
    from pytorch_distributed_nn_tpu_torch.parallel.expert import (
        MoEMLP,
        add_aux_losses,
        collect_aux_losses,
    )
    from pytorch_distributed_nn_tpu_torch.parallel.zero import ZeroShards
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer
    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.utils.flops import (
        transformer_train_flops_per_token,
    )

    gc.collect()
    torch.cuda.empty_cache()
    trainer = Trainer(get_config("moe_lm_ep", log_every="1"),
                      device="cuda")  # seeded init (cfg.seed)
    model, cfg = trainer.model, trainer.cfg
    layers = [m for m in model.modules() if isinstance(m, MoEMLP)]
    zs = trainer.state.sharding
    if not (isinstance(zs, ZeroShards) and zs.stage == 3 and not zs.active
            and trainer.mesh.spec.expert == 1 and model.num_layers == 12
            and model.d_model == 768 and model.head_dim == MOE_D
            and len(layers) == 12 and layers[0].num_experts == 8
            and layers[0].mlp_dim == 3072 and not cfg.model.remat
            and (cfg.data.batch_size, cfg.data.seq_len) == (MOE_B, MOE_T)):
        raise AssertionError("moe_lm_ep is not the preset at full width")
    L = model.num_layers
    n_params = sum(p.numel() for p in model.parameters())
    x, y = trainer.loader.batch_at(0)
    reset_flash_counts()
    loss_f = dp._loss_and_grads(trainer.state, x, y, trainer.loss_fn).item()
    check_counts = flash_counts()
    trainer.state.optimizer.zero_grad()
    if check_counts != {k: L for k in FLASH_KERNELS}:
        raise AssertionError(f"flash launches in one step: {check_counts}")
    for i in range(L):
        getattr(model, f"block{i}").attn.impl = "xla"
    reset_flash_counts()
    with torch.no_grad(), collect_aux_losses(model) as aux:
        loss_x = add_aux_losses(trainer.loss_fn(model(x), y), aux).item()
    if any(flash_counts().values()):
        raise AssertionError("the plain forward launched a flash kernel")
    for i in range(L):
        getattr(model, f"block{i}").attn.impl = "auto"
    loss_err = abs(loss_f - loss_x) / abs(loss_x)
    log(f"[moe] one step, flash vs plain attention: loss {loss_f:.6f} vs "
        f"{loss_x:.6f} (rel {loss_err:.3e}, limit {MOE_LOSS_TOL})")
    if not (math.isfinite(loss_f) and loss_err <= MOE_LOSS_TOL):
        raise AssertionError("the flash MoE step disagrees with the plain "
                             "attention")
    torch.cuda.empty_cache()
    trainer.train(steps=1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()  # the main path's count starts here
    with cc.recording() as records:
        trainer.train(steps=MOE_STEPS)
    launches = flash_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: L * MOE_STEPS for k in FLASH_KERNELS}
    if launches != want:
        raise AssertionError(f"flash launches {launches}, want {want}")
    if records:
        raise AssertionError(f"collectives at world 1: {records[:3]}")
    losses = trainer.losses()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"losses {losses}")
    dropped = [float(m.last_fraction_dropped.mean()) for m in layers]
    per_token = transformer_train_flops_per_token(model, MOE_T, causal=True)
    report = train_report(trainer, MOE_STEPS, per_token, MOE_B * MOE_T,
                          peak, count=FLASH_RX)
    prof = report["profile"]
    if prof is None:
        raise AssertionError("the profiled MoE step recorded no device time")
    profiled = prof["counted"]
    if profiled != {k: L for k in FLASH_KERNELS}:
        raise AssertionError(f"flash kernels in a profiled step: {profiled}")
    result = dict(check=dict(loss_flash=loss_f, loss_plain=loss_x,
                             loss_rel_err=loss_err, limit=MOE_LOSS_TOL),
                  launches=launches, profiled_launches=profiled,
                  params=n_params, layers=L, losses=losses,
                  fraction_dropped_by_layer=dropped,
                  fraction_dropped_mean=sum(dropped) / len(dropped),
                  collectives=len(records),
                  **{k: v for k, v in report.items() if k != "losses"})
    log(f"[moe] {json.dumps(result)}")
    del trainer, model, zs, layers
    gc.collect()
    torch.cuda.empty_cache()
    return result, launches, profiled


# ---------------------------------------------------------------------------
# rule 3, slice 5: serve a checkpoint that the port's Trainer wrote
# ---------------------------------------------------------------------------
CK_NEW = 16  # tokens a request in phase 28's engine checks
CK_8B_LAYERS = 1  # of 32: the checkpoint (f32 params + adamw) ~12.6 GB


def serve_entry(argv):
    """The serve entry point (``serve/__main__.main``) in this process: its
    one summary line, parsed; it must exit 0."""
    import contextlib
    import io

    from pytorch_distributed_nn_tpu_torch.serve import __main__ as serve_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve_main.main(argv)
    lines = out.getvalue().strip().splitlines()
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"serve {argv}: rc {rc}, {lines}")
    return json.loads(lines[0])


def engine_run(model, prompts, specs):
    """``prompts`` through one 8-slot engine, each with its DecodeSpec (or
    None); returns the Requests, their prefills plus decode rounds."""
    from pytorch_distributed_nn_tpu_torch.serve import ServingEngine

    eng = ServingEngine(model, max_slots=SERVE_SLOTS, max_seq_len=256,
                        max_queue=64)
    reqs = [eng.submit(p, CK_NEW, decode=d) for p, d in zip(prompts, specs)]
    eng.run_until_idle()
    for r in reqs:
        if not r.ok:
            raise AssertionError(f"{r.request_id}: {r.state}")
    return reqs, len(eng.completed) + len(eng.round_seconds)


def same_state(got, want):
    import torch

    return sorted(got) == sorted(want) and all(
        torch.equal(got[k].cpu(), want[k].cpu()) for k in want)


def phase_serve_ckpt(root):
    """Phase 28, its checkpoints written under ``root`` (the caller's, which
    phase 32's eval reads the CK_8B_LAYERS-layer 8B's from and then
    removes). (a)
    transformer_lm_pp (--mesh.pipe 1 --parallel.strategy dp) at full width
    and depth trains 2 steps with a checkpoint; the serve
    entry point serves it; the restored params are the trained ones bit
    for bit, the engine's greedy tokens on them equal generate()'s, and one
    sampled request twice gives one stream. (b) llama3_8b_zero at full
    width, zero_stage 3, cut to CK_8B_LAYERS layers, trains 1 step at batch
    1 and saves; served with {"quantized": true, "fused_proj": true}, which
    quantizes at load: the served int8 params equal the trained f32 params
    quantized in memory bit for bit, the engine's greedy tokens equal
    generate() on those, and W8A16 runs 4 a layer plus the head a forward;
    its trainer evaluates the trained state before it closes (the line
    phase 32's scripts/eval.py must print of the saved step). The flash
    launches of both trainings and the W8A16 launches of (b)'s engine are
    counted."""
    import shutil

    import numpy as np
    import torch

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.inference.generate import generate
    from pytorch_distributed_nn_tpu_torch.models import get_model
    from pytorch_distributed_nn_tpu_torch.ops import int8_matmul as tmm
    from pytorch_distributed_nn_tpu_torch.serve import DecodeSpec
    from pytorch_distributed_nn_tpu_torch.serve import __main__ as serve_main
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    def train(preset, evaluate=False, **ov):
        cfg = get_config(preset, **ov)
        t0 = time.monotonic()
        trainer = Trainer(cfg, device="cuda")
        reset_flash_counts()
        trainer.train()
        trainer.ckpt.wait()
        flash = flash_counts()
        trained = {k: v.detach().clone()
                   for k, v in trainer.model.state_dict().items()}
        save = dict(trainer.ckpt.last_save)
        if evaluate:  # what phase 32's scripts/eval.py must print of it
            rec = trainer.evaluate(num_batches=EVAL_BATCHES)
            save["eval"] = dict(step=rec.step, eval_loss=round(rec.loss, 6),
                                eval_accuracy=round(rec.accuracy, 6),
                                batches=EVAL_BATCHES)
        trainer.close()
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        return cfg, trained, flash, save, time.monotonic() - t0

    rng = np.random.default_rng(28)
    # (a) config 4's transformer LM
    d_lm = os.path.join(root, "lm")
    cfg, trained, lm_flash, lm_save, lm_train_s = train(
        "transformer_lm_pp", **LM_OVERRIDES, steps="2",
        checkpoint_dir=d_lm, checkpoint_every="2")
    t0 = time.monotonic()
    lm_summary = serve_entry([
        "--preset", "transformer_lm_pp", "--checkpoint-dir", d_lm,
        "--mesh.pipe", "1", "--parallel.strategy", "dp", "--slots", "8",
        "--requests", "16", "--rate", "50", "--max-new", str(CK_NEW)])
    lm_serve_s = time.monotonic() - t0
    params, step = serve_main.restore_params(d_lm)
    if step != 2 or not same_state(params, trained):
        raise AssertionError("the restored LM params are not the "
                             "trained ones bit for bit")
    model = get_model(cfg.model, device="cuda")
    serve_main.load_params(model, params)
    model.eval()
    vocab = model.vocab_size
    prompts = [rng.integers(0, vocab, size=(n,)) for n in (24, 57, 100)]
    sampled = DecodeSpec(**SAMPLED, seed=2)
    reqs, _ = engine_run(model, prompts + [prompts[1]] * 2,
                         [None] * 3 + [sampled] * 2)
    for p, r in zip(prompts, reqs):
        ref = generate(model, p[None], CK_NEW).cpu().numpy()
        if not np.array_equal(r.tokens, ref[0, len(p):]):
            raise AssertionError("LM: served tokens differ from "
                                 "generate()")
    if not np.array_equal(reqs[3].tokens, reqs[4].tokens):
        raise AssertionError("LM: one sampled request twice gave two "
                             "streams")
    lm = dict(flash_launches=lm_flash, save=lm_save,
              train_s=lm_train_s, serve_s=lm_serve_s,
              params=sum(v.numel() for v in params.values()),
              summary=lm_summary)
    del model, params, trained
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[serve_ckpt] lm: {json.dumps(lm)}")

    # (b) config 5's Llama, ZeRO-3, quantized at load
    d_8b = os.path.join(root, "llama")
    cfg, trained, z_flash, z_save, z_train_s = train(
        "llama3_8b_zero", evaluate=True, steps="1", checkpoint_dir=d_8b,
        checkpoint_every="1", log_every="1", **{
            "model.extra": json.dumps({"num_layers": CK_8B_LAYERS}),
            "data.batch_size": "1", "parallel.zero_stage": "3"})
    meta = json.loads(open(os.path.join(d_8b, "1", "meta.json")).read())
    if meta.get("layout", {}).get("zero_stage") != 3:
        raise AssertionError(f"not a ZeRO-3 layout: {meta}")
    qextra = json.dumps({"num_layers": CK_8B_LAYERS, "quantized": True,
                         "fused_proj": True})
    t0 = time.monotonic()
    z_summary = serve_entry([
        "--preset", "llama3_8b_zero", "--checkpoint-dir", d_8b,
        "--model.extra", qextra, "--slots", "8", "--requests", "8",
        "--rate", "50", "--max-new", str(CK_NEW)])
    z_serve_s = time.monotonic() - t0
    qcfg = get_config("llama3_8b_zero", **{"model.extra": qextra})
    params, _ = serve_main.restore_params(d_8b)
    served = get_model(qcfg.model, device="cuda")
    serve_main.load_params(served, params)
    del params
    ref = get_model(qcfg.model, device="cuda")
    serve_main.load_params(ref, trained)
    del trained
    gc.collect()
    torch.cuda.empty_cache()
    if not same_state(served.state_dict(), ref.state_dict()):
        raise AssertionError("quantized at load differs from the "
                             "trained params quantized in memory")
    prompts = [rng.integers(0, V, size=(n,)) for n in (20, 64, 111)]
    tmm.int8_matmul.launches = 0  # (b)'s engine: the count starts here
    reqs, forwards = engine_run(served, prompts, [None] * 3)
    z_launches = tmm.int8_matmul.launches
    if z_launches != (4 * CK_8B_LAYERS + 1) * forwards:
        raise AssertionError(f"{z_launches} W8A16 launches in "
                             f"{forwards} forwards, expected "
                             f"{4 * CK_8B_LAYERS + 1} a forward")
    for p, r in zip(prompts, reqs):
        want = generate(ref, p[None], CK_NEW).cpu().numpy()
        if not np.array_equal(r.tokens, want[0, len(p):]):
            raise AssertionError("8B: served tokens differ from "
                                 "generate() on the weights "
                                 "quantized in memory")
    z = dict(flash_launches=z_flash, save=z_save, train_s=z_train_s,
             serve_s=z_serve_s, layers=CK_8B_LAYERS,
             int8_matmul_launches=z_launches, forwards=forwards,
             summary=z_summary)
    del served, ref
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[serve_ckpt] llama3_8b_zero: {json.dumps(z)}")
    shutil.rmtree(d_lm, ignore_errors=True)
    flash = {k: lm_flash[k] + z_flash[k] for k in lm_flash}
    return dict(lm=lm, llama3_8b_zero=z), flash, z_launches


# ---------------------------------------------------------------------------
# rule 3: training from the user's files, and the MoE LM under the pipeline
# ---------------------------------------------------------------------------
FILES_SEED = 0  # the files' numpy seed
FILES_TOKENS = 16 * 2 ** 20  # uint16 tokens of the token file (32 MiB)
FILES_VOCAB = 32000
FILES_HOLDOUT = 0.05
FILES_STEPS = 3  # timed LM steps (after one warm-up step)
FILES_SMALL_STEPS = 20  # mlp_mnist and lenet_cifar10 from their files
MNIST_ROWS, CIFAR_ROWS = (10000, 2000), (10000, 2000)  # (train, test)
_IDX_CODES = {"uint8": 0x08, "int32": 0x0C}


def write_idx(path, arr):
    """``arr`` as an idx file: the header, then the big-endian array."""
    import struct

    head = struct.pack(">HBB", 0, _IDX_CODES[arr.dtype.name], arr.ndim)
    head += struct.pack(f">{arr.ndim}I", *arr.shape)
    with open(path, "wb") as f:
        f.write(head + arr.astype(arr.dtype.newbyteorder(">")).tobytes())


def striped_images(rng, n, shape, row_axis):
    """n uint8 images with a saturated stripe at rows 2y..2y+3 of class y
    (learnable), labels y = i mod 10."""
    import numpy as np

    y = (np.arange(n) % 10).astype(np.uint8)
    x = rng.integers(0, 256, (n, *shape), dtype=np.uint8)
    rows = np.arange(shape[row_axis - 1])
    hit = (rows >= 2 * y[:, None]) & (rows < 2 * y[:, None] + 3)
    view = [n] + [1] * len(shape)
    view[row_axis] = shape[row_axis - 1]
    x[np.broadcast_to(hit.reshape(view), x.shape)] = 255
    return x, y


def write_files(root):
    """The token file, an MNIST idx pair and CIFAR-10 binaries under
    ``root``, from FILES_SEED."""
    import numpy as np

    rng = np.random.default_rng(FILES_SEED)
    paths = dict(tokens=os.path.join(root, "tokens.bin"),
                 mnist=os.path.join(root, "mnist"),
                 cifar=os.path.join(root, "cifar10"))
    rng.integers(0, FILES_VOCAB, FILES_TOKENS, dtype=np.uint16).tofile(
        paths["tokens"])
    os.makedirs(paths["mnist"])
    for split, n in zip(("train", "t10k"), MNIST_ROWS):
        x, y = striped_images(rng, n, (28, 28), 1)
        write_idx(os.path.join(paths["mnist"], f"{split}-images-idx3-ubyte"),
                  x)
        write_idx(os.path.join(paths["mnist"], f"{split}-labels-idx1-ubyte"),
                  y)
    os.makedirs(paths["cifar"])
    for name, n in zip(("data_batch_1.bin", "test_batch.bin"), CIFAR_ROWS):
        x, y = striped_images(rng, n, (3, 32, 32), 2)  # CHW records
        rec = np.concatenate([y[:, None], x.reshape(n, -1)], axis=1)
        with open(os.path.join(paths["cifar"], name), "wb") as f:
            f.write(rec.tobytes())
    return paths


def memmap_windows(path, seed, step, batch, seq_len, holdout):
    """The (inputs, targets) windows of a token file's step, read from the
    memmap by the sampler's contract: ``batch`` starts drawn by
    default_rng(SeedSequence([seed, step])) from the head region (the
    tail ``holdout`` from the eval offset on)."""
    import numpy as np

    from pytorch_distributed_nn_tpu_torch.data.datasets import (
        EVAL_STEP_OFFSET,
    )

    tokens = np.memmap(path, dtype=np.uint16, mode="r")
    n = len(tokens)
    tail = n - int(n * holdout)
    lo, hi = ((tail, n - seq_len) if step >= EVAL_STEP_OFFSET
              else (0, tail - seq_len))
    starts = np.random.default_rng(
        np.random.SeedSequence([seed, step])).integers(lo, hi, size=batch)
    rows = np.stack([tokens[s:s + seq_len + 1] for s in starts]).astype(
        np.int32)
    return rows[:, :-1], rows[:, 1:]


def small_from_files(preset, dataset, path, n_test):
    """``preset`` trained FILES_SMALL_STEPS steps on the card from its
    files, one evaluation on the files' test split."""
    import torch

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer
    from pytorch_distributed_nn_tpu_torch.utils.flops import input_spec

    cfg = get_config(preset, **{"data.dataset": dataset, "data.path": path,
                                "log_every": "1"})
    t0 = time.monotonic()
    with Trainer(cfg, device="cuda") as trainer:
        ds = trainer.dataset
        if (input_spec(cfg) != (ds.spec.x_shape, ds.spec.x_dtype)
                or len(ds._eval_rows) != n_test):
            raise AssertionError(f"{preset} from {dataset}: spec "
                                 f"{ds.spec}, {len(ds._eval_rows)} eval "
                                 "rows")
        trainer.train(steps=FILES_SMALL_STEPS)
        ev = trainer.evaluate(num_batches=2)
        losses = trainer.losses()
        torch.cuda.synchronize()
    if not (all(math.isfinite(v) for v in losses)
            and math.isfinite(ev.loss) and losses[-1] < losses[0]):
        raise AssertionError(f"{preset} from {dataset}: losses {losses}, "
                             f"eval {ev}")
    return dict(steps=len(losses), first_loss=losses[0],
                last_loss=losses[-1], eval_loss=ev.loss,
                eval_accuracy=ev.accuracy, eval_rows=n_test,
                seconds=time.monotonic() - t0)


def phase_files(lm_ref):
    """Training from the user's files (phase 29): the token file, MNIST
    idx files and CIFAR-10 binaries written from FILES_SEED in a temporary
    directory. config 4's transformer LM (--mesh.pipe 1
    --parallel.strategy dp) at full width from the token file with
    holdout_frac 0.05: the device batches of two training steps and an
    evaluation step bit for bit the memmap's windows; a warm-up and
    FILES_STEPS steps with the flash counts reset just before and read
    just after (24 forward, 12 dq, 12 dk/dv a step), one evaluation on the
    held-out tail, one profiled step with the kernels counted by name;
    step time, tokens/s, peak memory and the loader's wait against
    ``lm_ref`` (phase 18's synthetic-data step). Then mlp_mnist from the
    idx files and lenet_cifar10 from the binaries, each with one
    evaluation on the real test split."""
    import shutil
    import tempfile

    import torch

    from pytorch_distributed_nn_tpu_torch.data.datasets import (
        EVAL_STEP_OFFSET,
        TokenFileDataset,
    )
    from pytorch_distributed_nn_tpu_torch.utils.flops import (
        transformer_train_flops_per_token,
    )

    root = tempfile.mkdtemp(prefix="chip_smoke_files_")
    try:
        t0 = time.monotonic()
        paths = write_files(root)
        write_s = time.monotonic() - t0
        gc.collect()
        torch.cuda.empty_cache()
        trainer = lm_trainer(**{"data.dataset": "token_file",
                                "data.path": paths["tokens"],
                                "data.holdout_frac": str(FILES_HOLDOUT)})
        model, cfg = trainer.model, trainer.cfg
        L = model.num_layers
        if not (isinstance(trainer.dataset, TokenFileDataset)
                and model.head_dim == LM_D and cfg.model.remat
                and (cfg.data.batch_size, cfg.data.seq_len,
                     cfg.data.vocab_size) == (LM_B, LM_T, FILES_VOCAB)):
            raise AssertionError("transformer_lm_pp from the token file is "
                                 "not the preset at full width")
        for step in (0, 1, EVAL_STEP_OFFSET):
            x, y = trainer.loader.batch_at(step)
            wx, wy = memmap_windows(paths["tokens"], cfg.seed, step, LM_B,
                                    LM_T, FILES_HOLDOUT)
            if not (x.is_cuda and torch.equal(x.cpu(), torch.from_numpy(wx))
                    and torch.equal(y.cpu(), torch.from_numpy(wy))):
                raise AssertionError(f"step {step}: the device batch is not "
                                     "the memmap's windows")
        trainer.train(steps=1)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_flash_counts()  # the path's count starts here
        trainer.train(steps=FILES_STEPS)
        launches = flash_counts()
        peak = torch.cuda.max_memory_allocated()
        want = {"flash_fwd": 2 * L * FILES_STEPS,
                "flash_bwd_dq": L * FILES_STEPS,
                "flash_bwd_dkv": L * FILES_STEPS}
        if launches != want:
            raise AssertionError(f"flash launches {launches}, want {want}")
        losses = trainer.losses()[-FILES_STEPS:]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"losses {losses}")
        per_token = transformer_train_flops_per_token(model, LM_T,
                                                      causal=True)
        report = train_report(trainer, FILES_STEPS, per_token, LM_B * LM_T,
                              peak, count=FLASH_RX)
        prof = report["profile"]
        if prof is None:
            raise AssertionError("the profiled step recorded no device time")
        profiled = prof["counted"]
        if profiled != {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                        "flash_bwd_dkv": L}:
            raise AssertionError(f"flash kernels in a profiled step: "
                                 f"{profiled}")
        ev = trainer.evaluate(num_batches=2)  # the held-out tail
        if not math.isfinite(ev.loss):
            raise AssertionError(f"eval {ev}")
        trainer.close()
        lm = dict(launches=launches, profiled_launches=profiled,
                  losses=losses, eval_loss=ev.loss,
                  eval_accuracy=ev.accuracy,
                  tokens_file_mb=FILES_TOKENS * 2 / 2 ** 20,
                  write_files_s=write_s,
                  step_s_vs_synthetic=(report["median_step_s"]
                                       / lm_ref["median_step_s"]),
                  synthetic=dict((k, lm_ref[k]) for k in (
                      "median_step_s", "tokens_per_s", "peak_mem_gb",
                      "loader_wait_s_per_step")),
                  **{k: v for k, v in report.items() if k != "losses"})
        log(f"[files] transformer_lm_pp from the token file: "
            f"{json.dumps(lm)}")
        del trainer, model
        gc.collect()
        torch.cuda.empty_cache()
        small = dict(
            mlp_mnist=small_from_files("mlp_mnist", "mnist_idx",
                                       paths["mnist"], MNIST_ROWS[1]),
            lenet_cifar10=small_from_files("lenet_cifar10", "cifar10_bin",
                                           paths["cifar"], CIFAR_ROWS[1]))
        log(f"[files] {json.dumps(small)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return dict(card=card_line(), lm=lm, **small), launches, profiled


# the MoE LM under the pipeline: (schedule, pipe, pipe_chunks, moe_every).
# 12 layers at pipe 4 give 3 a stage, which splits moe_every 2's pairs:
# the interleaved run takes pipe 2 x 3 chunks, 2 layers (one pair) a chunk
PIPE_MOE_RUNS = (("1f1b", 4, 1, 1), ("interleaved", 2, 3, 2))
PIPE_MOE_M = 8  # microbatches: 4 rows of 1024 tokens each
PIPE_MOE_STEPS = 2
# the pipeline's first loss against the dp step's from the same weights and
# batch: bf16 products over other row counts, and a routing choice that
# flips on a tie-close pair moves a few tokens' terms of the mean
PIPE_MOE_LOSS_TOL = 1e-3  # relative
MOE_WIDTH = dict(layers=12, d_model=768, experts=8)  # moe_lm_ep as it is


def phase_pipe_moe():
    """The MoE LM under the pipeline (phase 30): moe_lm_ep at full width
    (12 layers, d 768, 8 experts of 3072, top-2, B 32, T 1024, no remat)
    with 8 microbatches, every stage in this process: 1f1b on mesh.pipe 4
    with moe_every 1, and interleaved on pipe 2 x 3 chunks with moe_every
    2. Each: the dp step of the same model (phase 27's path) from the same
    weights and batch gives the reference first loss, the load-balance
    terms included; a warm-up step, whose loss is the first, within
    PIPE_MOE_LOSS_TOL of the dp step's; PIPE_MOE_STEPS steps with the
    flash counts reset just before and read just after (L M forward, L M
    dq, L M dk/dv a step); step time, peak memory, the most microbatches
    a stage held, one profiled step with the flash kernels counted by
    name."""
    import torch

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.parallel.expert import MoEMLP
    from pytorch_distributed_nn_tpu_torch.parallel.pipeline import (
        PipelineStages,
    )
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer
    from pytorch_distributed_nn_tpu_torch.utils.flops import (
        transformer_train_flops_per_token,
    )

    out, launches, profiled = {}, {}, {}
    for schedule, S, v, every in PIPE_MOE_RUNS:
        ov = {"log_every": "1", "model.extra": json.dumps(
            {"moe_every": every})}
        gc.collect()
        torch.cuda.empty_cache()
        ref = Trainer(get_config("moe_lm_ep", **ov), device="cuda")
        init = {k: v_.detach().cpu().clone()
                for k, v_ in ref.model.state_dict().items()}
        ref.train(steps=1)
        dp_loss = ref.losses()[0]
        del ref
        gc.collect()
        torch.cuda.empty_cache()
        trainer = Trainer(get_config("moe_lm_ep", **ov, **{
            "parallel.strategy": "pipeline", "mesh.pipe": str(S),
            "mesh.expert": "1", "parallel.microbatches": str(PIPE_MOE_M),
            "parallel.pipeline_schedule": schedule,
            "parallel.pipe_chunks": str(v)}), device="cuda", params=init)
        del init
        model, cfg, st = trainer.model, trainer.cfg, trainer.state.sharding
        layers = [m for m in model.modules() if isinstance(m, MoEMLP)]
        L = model.num_layers
        rows = MOE_B // PIPE_MOE_M
        if not (isinstance(st, PipelineStages) and st.S == S and st.v == v
                and st.devices == list(range(S)) and st.part.period == every
                and (L, model.d_model, layers[0].num_experts)
                == tuple(MOE_WIDTH.values())
                and model.head_dim == MOE_D and len(layers) == L // every
                and not cfg.model.remat
                and (cfg.data.batch_size, cfg.data.seq_len)
                == (MOE_B, MOE_T)):
            raise AssertionError(f"moe_lm_ep under {schedule} is not the "
                                 "preset at full width")
        if (rows * MOE_T) % layers[0].group_size:
            raise AssertionError("a routing group would span microbatches")
        n_params = sum(p.numel() for p in model.parameters())
        trainer.train(steps=1)  # warm-up: its loss is the first step's
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_flash_counts()  # the path's count starts here
        trainer.train(steps=PIPE_MOE_STEPS)
        got = flash_counts()
        peak = torch.cuda.max_memory_allocated()
        want = {k: L * PIPE_MOE_M * PIPE_MOE_STEPS for k in FLASH_KERNELS}
        if got != want:
            raise AssertionError(f"{schedule}: flash launches {got}, want "
                                 f"{want}")
        losses = trainer.losses()
        err = abs(losses[0] - dp_loss) / abs(dp_loss)
        log(f"[pipe_moe] {schedule}: first loss {losses[0]:.6f} against the "
            f"dp step's {dp_loss:.6f} (rel {err:.3e}, limit "
            f"{PIPE_MOE_LOSS_TOL})")
        if not (all(math.isfinite(x) for x in losses)
                and err <= PIPE_MOE_LOSS_TOL):
            raise AssertionError(f"{schedule}: losses {losses} against the "
                                 f"dp step's {dp_loss}")
        per_token = transformer_train_flops_per_token(model, MOE_T,
                                                      causal=True)
        report = train_report(trainer, PIPE_MOE_STEPS, per_token,
                              MOE_B * MOE_T, peak, count=FLASH_RX)
        prof = report["profile"]
        if prof is None:
            raise AssertionError("the profiled step recorded no device time")
        if prof["counted"] != {k: L * PIPE_MOE_M for k in FLASH_KERNELS}:
            raise AssertionError(f"{schedule}: flash kernels in a profiled "
                                 f"step: {prof['counted']}")
        out[schedule] = dict(
            pipe=S, pipe_chunks=v, moe_every=every,
            microbatches=PIPE_MOE_M, params=n_params,
            dp_first_loss=dp_loss, loss_rel_err_vs_dp=err,
            limit=PIPE_MOE_LOSS_TOL, launches=got,
            profiled_launches=prof["counted"],
            most_live_microbatches=dict(st.peak_live), losses=losses,
            **{k: v_ for k, v_ in report.items() if k != "losses"})
        launches[schedule], profiled[schedule] = got, prof["counted"]
        log(f"[pipe_moe] {schedule}: {json.dumps(out[schedule])}")
        del trainer, model, st, layers
    gc.collect()
    torch.cuda.empty_cache()
    return dict(card=card_line(), **out), launches, profiled


# ---------------------------------------------------------------------------
# rule 3: the serving slice closed -- the greedy contract of float models,
# tenants, and the user scripts (phase 32)
# ---------------------------------------------------------------------------
F1_SLOTS = (1, 3, 8)  # engine batches: one request a slot
F1_NEW = 8  # tokens a request
F1_LM_LAYERS = 6  # config 4's LM, 6 of its 12 layers (the time limit)


def f1_engine_logits(model, prompts, slots, n_new=F1_NEW, tenants=None,
                     **engine_kw):
    """Greedy ``prompts`` (of ``tenants``, one name a prompt, or the
    default tenant) through one engine of ``slots`` rows (prefix cache
    off unless ``engine_kw`` says otherwise, two admissions a round, so
    the rows join at different rounds and decode at different cache
    lengths): each request's next-token logits ((V,) f32, the prefill's
    then every decode round's row) and tokens. The CPU tests and the
    ``cuda`` tests use it too."""
    from pytorch_distributed_nn_tpu_torch.serve import ServingEngine

    eng = ServingEngine(model, max_slots=slots, max_seq_len=256,
                        **dict(dict(prefix_cache=False), **engine_kw))
    taps = []
    hook = model.register_forward_hook(
        lambda m, a, out: taps.append(out[:, -1].float().clone()))
    logs = {}
    prefill_into, decode_round = eng._prefill_into, eng._decode_round

    def tapped_prefill(rows, req):
        n = len(taps)
        prefill_into(rows, req)
        logs[req.request_id] = [taps[n][0]]

    def tapped_round():
        owners = [s and s.req.request_id for s in eng._slots]
        n = len(taps)
        out = decode_round()
        for i, rid in enumerate(owners):
            if rid:
                logs[rid].append(taps[n][i])
        return out

    eng._prefill_into, eng._decode_round = tapped_prefill, tapped_round
    try:
        reqs = [eng.submit(p, n_new, tenant=t) for p, t in
                zip(prompts, tenants or ["default"] * len(prompts))]
        eng.run_until_idle()
    finally:
        hook.remove()
    return [(logs[r.request_id], r.tokens) for r in reqs]


def f1_solo_logits(model, prompt, n_new=F1_NEW):
    """A solo ``generate()`` of ``prompt``: its next-token logits, one (V,)
    f32 a token, and its tokens."""
    from pytorch_distributed_nn_tpu_torch.inference.generate import generate

    taps = []
    hook = model.register_forward_hook(
        lambda m, a, out: taps.append(out[0, -1].float().clone()))
    try:
        out = generate(model, prompt[None], n_new).cpu().numpy()[0]
    finally:
        hook.remove()
    return taps, out[len(prompt):]


def f1_check(model, vocab, seed):
    """Tentpole §0: greedy rows in engines of 1, 3 and 8 slots against a
    solo ``generate()`` of each prompt, logits bit for bit and tokens.
    Returns the largest logit gap (0 when equal), the first (slots,
    request, step) that differs and whether every token agreed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    gap, first, tokens_equal = 0.0, None, True
    for slots in F1_SLOTS:
        prompts = [rng.integers(0, vocab, size=int(n)).astype(np.int32)
                   for n in rng.integers(5, 120, size=slots)]
        served = f1_engine_logits(model, prompts, slots)
        for i, (p, (logits, toks)) in enumerate(zip(prompts, served)):
            ref, ref_toks = f1_solo_logits(model, p)
            tokens_equal &= bool(np.array_equal(toks, ref_toks))
            for step, (a, b) in enumerate(zip(logits, ref)):
                d = (a - b).abs().max().item()
                if d > gap:
                    gap = d
                if d and first is None:
                    first = dict(slots=slots, request=i, step=step)
    return dict(max_logit_gap=gap, first_diff=first,
                tokens_equal=tokens_equal)


def f1_models():
    """The float models of §0 at full width: Llama at the 8B's widths cut to
    CK_8B_LAYERS layers and config 4's transformer LM cut to F1_LM_LAYERS,
    seeded, bf16 compute."""
    import torch

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.models import get_model

    llama_cfg = get_config("llama3_8b_zero", **{
        "model.extra": json.dumps({"num_layers": CK_8B_LAYERS})})
    llama = get_model(llama_cfg.model, device=torch.device("cuda"))
    llama.init_params(seed=32)
    lm_cfg = get_config("transformer_lm_pp", **LM_OVERRIDES, **{
        "model.extra": json.dumps({"num_layers": F1_LM_LAYERS})})
    lm = get_model(lm_cfg.model, device=torch.device("cuda"))
    lm.init_params(seed=32)
    return dict(llama=llama.eval(), lm=lm.eval())


def f1_decode_ms(model, rows, reps=20):
    """One decode step of ``rows`` rows at a 64-token cache, the step the
    engine runs a round: ``host``, the median of ``reps`` steps between
    CUDA events (the host's launch gaps included), and ``device``, the
    step's kernels' own time under torch.profiler (the mean of 5)."""
    import torch

    from pytorch_distributed_nn_tpu_torch.inference.generate import (
        decode_step_ragged,
        init_cache,
    )

    cache = init_cache(model, rows, 128)
    tok = torch.ones((rows,), dtype=torch.int32, device="cuda")
    pos = torch.full((rows,), 64, dtype=torch.int32, device="cuda")

    def step():
        decode_step_ragged(model, cache, tok, pos)

    times = []
    for _ in range(reps + 3):
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        step()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return dict(host=sorted(times[3:])[reps // 2],
                device=kernel_device_ms(step, 5, ""))


class f1_unblocked:
    """Inside the block the decode step's dense products are one library
    product each, as before the fixed row blocks
    (``nn.layers.dense_product``): the fault's own size, measured. The
    block restores the module's function. Measurement only."""

    def __enter__(self):
        from pytorch_distributed_nn_tpu_torch.nn import attention, layers

        self.saved = layers.dense_product
        layers.dense_product = attention.dense_product = \
            lambda x, kernel: x @ kernel

    def __exit__(self, *exc):
        from pytorch_distributed_nn_tpu_torch.nn import attention, layers

        layers.dense_product = attention.dense_product = self.saved
        return False


def phase_fault1():
    """Phase 32 (b), ROADMAP §3's fault 1: the float models' greedy rows
    through the engine against a solo ``generate()``, logits bit for bit,
    with the decode step's products on fixed row blocks (must be equal)
    and without them (the fault's size); and the bf16 decode step's time
    at 1 and 8 rows both ways, in the order without, with, with,
    without."""
    import torch

    models = f1_models()
    out = {}
    for name, m in models.items():
        with f1_unblocked():
            before = f1_check(m, m.vocab_size, seed=32)
        after = f1_check(m, m.vocab_size, seed=32)
        if after["max_logit_gap"] != 0.0 or not after["tokens_equal"]:
            raise AssertionError(f"fault 1, {name}: {after}")
        times = {}
        for blocked in (False, True, True, False):
            label = "blocked" if blocked else "unblocked"
            with (contextlib.nullcontext() if blocked else f1_unblocked()):
                for rows in (1, 8):
                    times.setdefault(f"rows{rows}_{label}", []).append(
                        f1_decode_ms(m, rows))
        out[name] = dict(unblocked=before, blocked=after, decode_ms=times)
        log(f"[fault1] {name}: {json.dumps(out[name])}")
    del models
    gc.collect()
    torch.cuda.empty_cache()
    return out


T32_TENANTS = (("flood", 24), ("light1", 3), ("light2", 3))
T32_QUOTA = {"flood": 2}
T32_NEW = 16


def t32_admission_order(engine):
    """Record (tenant, request id) of every admission of ``engine``."""
    order = []
    admit = engine.scheduler.next_admissions

    def recorded(free_slots):
        got = admit(free_slots)
        order.extend((r.tenant, r.request_id) for r in got)
        return got

    engine.scheduler.next_admissions = recorded
    return order


def t32_profiled_round(model):
    """The W8A16 kernels by name in one profiled decode round of an engine
    serving two tenants' requests (W8A16_PL a forward). None where
    the profiler
    records nothing. Measurement only."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_nn_tpu_torch.serve import ServingEngine

    engine = ServingEngine(model, max_slots=SERVE_SLOTS, max_seq_len=256,
                           tenant_quotas=T32_QUOTA)
    rng = np.random.default_rng(33)
    for tenant in ("flood", "light1"):
        engine.submit(rng.integers(0, V, size=24).astype(np.int32), 4,
                      tenant=tenant)
    engine.step()  # the admissions and a first round
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA], acc_events=True)
    try:
        prof.start()
    except RuntimeError as e:
        log(f"[tenants] profiler did not start: {e}")
        return None
    try:
        _margin()
        engine.step()
        torch.cuda.synchronize()
        _margin()
    finally:
        stopped = _profiler_stop(prof)
    engine.run_until_idle()
    if not stopped:
        return None
    kern, margin = _without_margin(
        [e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA])
    return dict(w8a16_kernels=sum(1 for e in kern if "w8a16" in e.name),
                forwards=1, kernels=len(kern), margin_kernels_seen=margin)


def phase_tenants(model):
    """Phase 32 (a): tenants on the full-width int8 8B of phase 31, 8 slots:
    a flood tenant of 24 requests with a quota of 2 and two light tenants
    of 3, all submitted before the first round; 22 rejected
    ``tenant_quota``; each light head admitted within one rotation (at
    most one admission of each other tenant since its tenant's last);
    every served request's tokens equal the request served alone; W8A16
    W8A16_PL a forward, and by name in a profiled round."""
    import collections

    import numpy as np

    from pytorch_distributed_nn_tpu_torch.ops import int8_matmul as tmm
    from pytorch_distributed_nn_tpu_torch.serve import ServingEngine

    rng = np.random.default_rng(32)
    stream = [(tenant, rng.integers(0, V, size=int(rng.integers(16, 65)))
               .astype(np.int32))
              for tenant, n in T32_TENANTS for _ in range(n)]
    engine = ServingEngine(model, max_slots=SERVE_SLOTS, max_seq_len=256,
                           tenant_quotas=T32_QUOTA)
    order = t32_admission_order(engine)
    tmm.int8_matmul.launches = 0
    t0 = time.monotonic()
    reqs = [engine.submit(p, T32_NEW, tenant=t) for t, p in stream]
    engine.run_until_idle()
    secs = time.monotonic() - t0
    launches = tmm.int8_matmul.launches
    forwards = len(engine.completed) + len(engine.round_seconds)
    if launches != W8A16_PL * forwards:
        raise AssertionError(f"tenants: {launches} W8A16 launches in "
                             f"{forwards} forwards")
    rejects = collections.Counter(r.reject_reason for r in reqs
                                  if r.state == "rejected")
    if dict(rejects) != {"tenant_quota": 22}:
        raise AssertionError(f"tenants: rejects {dict(rejects)}")
    served = [(t, p, r) for (t, p), r in zip(stream, reqs) if r.ok]
    if len(served) != 8:
        raise AssertionError(f"tenants: {len(served)} served, expected 8")
    waits, last = {}, {}
    for i, (tenant, rid) in enumerate(order):
        waits[rid] = i - last.get(tenant, -1) - 1
        last[tenant] = i
    light = {r.request_id: dict(tenant=t, round=r.round_admitted,
                                waited=waits[r.request_id])
             for t, _, r in served if t != "flood"}
    if max(v["waited"] for v in light.values()) > len(T32_TENANTS) - 1:
        raise AssertionError(f"tenants: a light head waited more than one "
                             f"rotation: {light}")
    solo = ServingEngine(model, max_slots=SERVE_SLOTS, max_seq_len=256,
                         prefix_cache=False)
    for t, p, r in served:
        alone = solo.submit(p, T32_NEW)
        solo.run_until_idle()
        if not np.array_equal(alone.tokens, r.tokens):
            raise AssertionError(f"tenants: {r.request_id} ({t}) differs "
                                 "from the request served alone")
    out = dict(seconds=secs, rejects=dict(rejects), light=light,
               admission_order=[t for t, _ in order],
               w8a16_launches=launches, forwards=forwards,
               counts=engine.summary()["serve_tenant_requests_total"],
               profiled_round=t32_profiled_round(model))
    log(f"[tenants] {json.dumps(out)}")
    return out, launches


def hf_llama_8b(seed):
    """A seeded HF-layout ``LlamaForCausalLM`` state_dict at the 8B's
    widths and CK_8B_LAYERS layers, bf16 on the CPU (drawn on the card)."""
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    D, H, Hkv, F = 4096, 32, 8, 14336
    dh = D // H

    def w(*shape):
        x = torch.randn(shape, generator=g, device="cuda")
        return (x * shape[-1] ** -0.5).to(torch.bfloat16).cpu()

    sd = {"model.embed_tokens.weight": w(V, D)}
    for i in range(CK_8B_LAYERS):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": 1 + w(D) * 0.0,
                   p + "self_attn.q_proj.weight": w(H * dh, D),
                   p + "self_attn.k_proj.weight": w(Hkv * dh, D),
                   p + "self_attn.v_proj.weight": w(Hkv * dh, D),
                   p + "self_attn.o_proj.weight": w(D, H * dh),
                   p + "post_attention_layernorm.weight": 1 + w(D) * 0.0,
                   p + "mlp.gate_proj.weight": w(F, D),
                   p + "mlp.up_proj.weight": w(F, D),
                   p + "mlp.down_proj.weight": w(D, F)})
    sd["model.norm.weight"] = 1 + w(D) * 0.0
    sd["lm_head.weight"] = w(V, D)
    return sd


def run_script(main, argv):
    """A script's ``main(argv)`` in this process: (stdout lines, seconds);
    it must exit 0."""
    import contextlib
    import io

    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"{main.__module__} {argv}: rc {rc}")
    return out.getvalue().strip().splitlines(), time.monotonic() - t0


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def profiled_call(fn, count):
    """``fn()`` under torch.profiler: (its result, the number of device
    kernels whose name matches each regex of ``count``; None where the
    profiler records nothing). Measurement only."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:
        log(f"[scripts] profiler did not start: {e}")
        return fn(), None
    try:
        result = fn()
        torch.cuda.synchronize()
    finally:
        stopped = _profiler_stop(prof)
    if not stopped:
        return result, None
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return result, {k: sum(1 for e in kern if re.search(rx, e.name))
                    for k, rx in count.items()}


EVAL_BATCHES = 2
T32_EXTRA = {"num_layers": CK_8B_LAYERS}
T32_QEXTRA = {"num_layers": CK_8B_LAYERS, "quantized": True,
              "fused_proj": True}


def phase_scripts(d_8b, want):
    """Phase 32 (c)-(e). (c) ``scripts/eval.py`` on phase 28's
    CK_8B_LAYERS-layer 8B checkpoint (ZeRO-3) on the card: its JSON line
    equals ``want``, what phase 28's ``Trainer.evaluate`` gave on the
    state it saved; flash_fwd counted by the wrapper and by name in a
    profiled trace. The checkpoint is then removed. (d) a seeded
    HF-layout Llama state_dict at the 8B's widths (CK_8B_LAYERS layers,
    bf16) through
    ``scripts/convert.py`` into llama3_8b_zero (on the CPU, with
    --optim.name sgd: a state of the parameters alone), then
    ``scripts/generate.py`` on the card quantized at load (W8A16 4 x
    CK_8B_LAYERS + 1 a forward; tokens equal ``generate()`` on the same
    weights loaded in memory), then ``--export``: every tensor back, bit for bit. (e) the
    serve entry point with ``--metrics-out`` at the 8B's widths, int8,
    CK_8B_LAYERS layers: one ``serve_request`` a finished request (the warm-up's
    included) with the JAX record's keys and one ``serve_summary``, the
    stdout line's."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from pytorch_distributed_nn_tpu_torch.config import get_config
    from pytorch_distributed_nn_tpu_torch.inference.generate import generate
    from pytorch_distributed_nn_tpu_torch.models import get_model
    from pytorch_distributed_nn_tpu_torch.ops import int8_matmul as tmm
    from pytorch_distributed_nn_tpu_torch.runtime import bootstrap
    from pytorch_distributed_nn_tpu_torch.scripts import convert
    from pytorch_distributed_nn_tpu_torch.scripts import eval as evals
    from pytorch_distributed_nn_tpu_torch.scripts import generate as gen
    from pytorch_distributed_nn_tpu_torch.serve import __main__ as serve_main
    from pytorch_distributed_nn_tpu_torch.serve.engine import _bucket_len
    from pytorch_distributed_nn_tpu_torch.utils import torch_interop as ti
    from pytorch_distributed_nn_tpu_torch.utils.interop import (
        llama_params_from_jax,
    )

    out = {}
    # (c) eval of phase 28's checkpoint
    ov = {"model.extra": json.dumps(T32_EXTRA), "data.batch_size": "1",
          "parallel.zero_stage": "3"}
    argv = ["--preset", "llama3_8b_zero", "--checkpoint-dir", d_8b,
            "--batches", str(EVAL_BATCHES)]
    for k, v in ov.items():
        argv += [f"--{k}", v]
    reset_flash_counts()
    (lines, secs), by_name = profiled_call(
        lambda: run_script(evals.main, argv),
        {"flash_fwd": FLASH_RX["flash_fwd"]})
    flash = flash_counts()
    line = json.loads(lines[-1])
    gc.collect()
    torch.cuda.empty_cache()
    if line != want:
        raise AssertionError(f"eval: {line} != the trained Trainer's {want}")
    per_eval = CK_8B_LAYERS * EVAL_BATCHES
    if flash["flash_fwd"] != per_eval:
        raise AssertionError(f"eval: {flash} flash launches, expected "
                             f"{per_eval} flash_fwd")
    out["eval"] = dict(line=line, seconds=secs, flash_launches=flash,
                       flash_by_name=by_name)
    log(f"[scripts] eval: {json.dumps(out['eval'])}")
    shutil.rmtree(d_8b, ignore_errors=True)

    # (d) convert -> generate -> export at the 8B's widths
    root = tempfile.mkdtemp(prefix="chip-smoke-convert-")
    try:
        t0 = time.monotonic()
        sd = hf_llama_8b(seed=32)
        pt = os.path.join(root, "llama.pt")
        torch.save(sd, pt)
        made = dict(seconds=time.monotonic() - t0,
                    bytes=os.path.getsize(pt),
                    params=sum(t.numel() for t in sd.values()))
        common = ["--model.extra", json.dumps(T32_EXTRA), "--optim.name",
                  "sgd", "--data.batch_size", "1"]
        ck = os.path.join(root, "ckpt")
        # the CPU Trainer of the conversion joins a gloo group of its own
        bootstrap.shutdown()
        _, convert_s = run_script(convert.main, [
            "--arch", "llama3", "--preset", "llama3_8b_zero",
            "--torch-checkpoint", pt, "--out", ck, *common])
        ck_bytes = dir_bytes(ck)
        prompt = " ".join(str(t) for t in np.random.default_rng(32)
                          .integers(0, V, size=24))
        tmm.int8_matmul.launches = 0
        lines, generate_s = run_script(gen.main, [
            "--preset", "llama3_8b_zero", "--checkpoint-dir", ck,
            "--prompt", prompt, "--max-new", str(F1_NEW), "--model.extra",
            json.dumps(T32_QEXTRA)])
        gen_launches = tmm.int8_matmul.launches
        tokens = [int(t) for t in lines[-1].split()]
        per_forward = 4 * CK_8B_LAYERS + 1
        if gen_launches != per_forward * F1_NEW:
            raise AssertionError(f"generate: {gen_launches} W8A16 launches"
                                 f", expected {per_forward} a forward")
        qcfg = get_config("llama3_8b_zero",
                          **{"model.extra": json.dumps(T32_QEXTRA)})
        ref = get_model(qcfg.model, device="cuda")
        serve_main.load_params(ref, llama_params_from_jax(
            ti.llama_params_from_torch(sd, num_layers=CK_8B_LAYERS,
                                       num_heads=32, num_kv_heads=8)))
        ref.eval()
        p = np.asarray([[int(t) for t in prompt.split()]], np.int32)
        want = generate(ref, p, F1_NEW).cpu().numpy()[0].tolist()
        del ref
        if tokens != want:
            raise AssertionError(f"generate: {tokens} != {want}")
        back = os.path.join(root, "back.pt")
        _, export_s = run_script(convert.main, [
            "--arch", "llama3", "--preset", "llama3_8b_zero", "--export",
            ck, "--torch-checkpoint", back, *common])
        exported = torch.load(back, weights_only=True)
        if sorted(exported) != sorted(sd) or not all(
                torch.equal(exported[k].to(torch.bfloat16), t)
                and torch.equal(exported[k], t.float())
                for k, t in sd.items()):
            raise AssertionError("export: not the state_dict bit for bit")
        out["convert"] = dict(
            state_dict=made, convert_s=convert_s, checkpoint_bytes=ck_bytes,
            generate_s=generate_s, w8a16_launches=gen_launches,
            export_s=export_s, export_bytes=os.path.getsize(back),
            tokens=tokens[len(p[0]):])
        log(f"[scripts] convert: {json.dumps(out['convert'])}")
        del sd, exported
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the serve entry point's --metrics-out
    root = tempfile.mkdtemp(prefix="chip-smoke-metrics-")
    try:
        path = os.path.join(root, "serve.jsonl")
        lines, serve_s = run_script(serve_main.main, [
            "--preset", "llama3_8b_zero", "--model.extra",
            json.dumps(T32_QEXTRA), "--slots", str(SERVE_SLOTS),
            "--requests", "8", "--rate", "50", "--max-new", str(F1_NEW),
            "--metrics-out", path])
        summary = json.loads(lines[-1])
        recs = [json.loads(x) for x in open(path).read().splitlines()]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    b, warm = _bucket_len(4), 0  # the entry point's warm-up buckets
    while b <= min(_bucket_len(48), 256):
        warm, b = warm + 1, b * 2
    reqs = [r for r in recs if r["event"] == "serve_request"]
    sums = [r for r in recs if r["event"] == "serve_summary"]
    keys = {"event", "time", "process", "request_id", "prompt_len",
            "new_tokens", "ttft_s", "total_s", "per_token_s",
            "rounds_waited", "kv_util", "waterfall", "tenant", "adapter",
            "cached_tokens"}
    if len(reqs) != warm + summary["completed"] or len(sums) != 1 or any(
            set(r) != keys for r in reqs) or {
            k: v for k, v in sums[0].items()
            if k not in ("event", "time", "process")} != summary:
        raise AssertionError(f"--metrics-out: {len(reqs)} serve_request "
                             f"records for {warm} + {summary['completed']}"
                             f" requests, {len(sums)} summaries")
    out["metrics_out"] = dict(serve_requests=len(reqs), warm_up=warm,
                              summaries=len(sums), seconds=serve_s,
                              summary=summary)
    log(f"[scripts] metrics_out: {json.dumps(out['metrics_out'])}")
    return out, flash, by_name


# --------------------------------------------------------------------------
# phase 33: the tensor axis (ROADMAP §1 item 3.2)
# --------------------------------------------------------------------------

TP = 2
# every run of phase 33 and its one-process references starts at the full
# lr (no warmup: the presets' warmup starts from an lr of 0, so a first
# update would leave the weights as they are) and takes TP_STEPS steps:
# the second loss follows a real update
TP_NO_WARMUP = {"optim.warmup_steps": "0"}
TP_STEPS = 2
# relative, a tensor-parallel loss against the one-process loss from the
# same weights and batches: the row-parallel products add their bf16
# partial sums in another order than one product does
TP_LOSS_TOL = 1e-4
# max|err| / max|ref| of each parameter's gradient (a rank's slice of a
# split leaf) in (a) against the one-process gradient, same weights and
# batch: the bf16 compute's rounding, as TRAIN_GRAD_TOL
TP_GRAD_TOL = 5e-2
# phase 33 (b): llama3_8b_zero under ZeRO-3 x tensor 2 on 4 processes
# (fsdp 2 x tensor 2) sharing the card: depth and batch (2 rows: one for
# each of the fsdp ranks). Each rank builds the whole model before it is
# cut (ROADMAP §1 item 3.2's leftovers), so four of them hold few
# layers; 1 since phase 34 (the script's time limit)
TP8B_LAYERS, TP8B_BATCH = 1, 2
# phase 33 (a): transformer_lm_pp's depth at tensor 2, and (d)'s under
# pipe 2 x tensor 2 (of 12; the script's time limit)
TP_LM_LAYERS = 6
TP_PIPE_LAYERS = 2
TP_GEN_PROMPT = " ".join(str(7 * i + 3) for i in range(16))
TP_GEN_NEW = 16
TP_TIMEOUT_S = 600
TP_FLASH = {name: rf"{name}_kernel" for name in FLASH_KERNELS}
TP_GEN_EXTRA = {"bf16": {"num_layers": TP_GEN_LAYERS},
                "int8": {"num_layers": TP_GEN_LAYERS, "quantized": True,
                         "fused_proj": True}}


def tp_gen_argv(kind, tp=1):
    """``scripts/generate.py``'s arguments for phase 33 (c): Llama-3-8B at
    full width with seeded random weights, bf16 or int8 (quantized with
    fused projections, as phases 7 and 31 serve it)."""
    argv = ["--preset", "llama3_8b_zero", "--prompt", TP_GEN_PROMPT,
            "--max-new", str(TP_GEN_NEW), "--model.extra",
            json.dumps(TP_GEN_EXTRA[kind])]
    if kind == "bf16":
        argv += ["--model.dtype", "bfloat16"]
    return argv + (["--tp", str(tp)] if tp > 1 else [])


def tp_8b_config(mesh=None):
    from pytorch_distributed_nn_tpu_torch.config import get_config

    return get_config("llama3_8b_zero", log_every="1", **{
        **TP_NO_WARMUP,
        "model.extra": json.dumps({"num_layers": TP8B_LAYERS}),
        "data.batch_size": str(TP8B_BATCH), **(mesh or {})})


def tp_lm_config(tensor=1):
    from pytorch_distributed_nn_tpu_torch.config import get_config

    return get_config("transformer_lm_pp", **{
        **LM_OVERRIDES, **TP_NO_WARMUP, "mesh.tensor": str(tensor),
        "model.extra": json.dumps({"num_layers": TP_LM_LAYERS})})


def tp_pipe_config(sched, tensor=1):
    from pytorch_distributed_nn_tpu_torch.config import get_config

    return get_config("transformer_lm_pp", log_every="1", **{
        **TP_NO_WARMUP, "mesh.pipe": "2", "mesh.tensor": str(tensor),
        "mesh.data": "1", "parallel.pipeline_schedule": sched,
        "model.extra": json.dumps({"num_layers": TP_PIPE_LAYERS})})


def tp_collectives(records):
    """The recorder's collectives of a step by op: count and payload
    bytes."""
    out = {}
    for r in records:
        n, b = out.get(r.op, (0, 0))
        out[r.op] = (n + 1, b + r.bytes_payload)
    return {op: dict(count=n, payload_bytes=b) for op, (n, b) in out.items()}


def tp_grads(trainer, ref_path, loss_fn=None):
    """One forward and backward of the first batch as the step runs them
    (the vocab-parallel loss, or ``loss_fn`` where the step's objective is
    another: the chunked LM loss; the ZeRO layout's gradient hooks): each
    gradient the rank holds once reduced (a split leaf's fsdp slice, a
    tensor slice, a whole leaf) against the one-process gradient of the
    same weights and batch (``ref_path``, whole leaves), max|err| /
    max|ref|. The gradients are cleared after. Returns the loss and the
    errors by name."""
    import torch

    from pytorch_distributed_nn_tpu_torch.parallel import dp
    from pytorch_distributed_nn_tpu_torch.parallel.sharding_rules import (
        local_slice,
    )
    from pytorch_distributed_nn_tpu_torch.parallel.tensor import (
        vocab_parallel_loss,
    )

    ref = torch.load(ref_path)
    zs, model = trainer.state.sharding, trainer.model
    fn = loss_fn or vocab_parallel_loss(trainer.loss_fn, model,
                                        zs.tensor) or trainer.loss_fn
    x, y = trainer.loader.batch_at(0)
    zs.begin(last=True, accum=1)
    with zs.hold(getattr(fn, "reads", ())):
        loss = dp._loss_and_grads(trainer.state, x, y, fn).item()
    zs.end()
    f, t = zs.fsdp, zs.tensor
    errs = {}
    for k, p in model.named_parameters():
        g = zs.shards[k].grad if k in zs.shards else p.grad
        want = local_slice(k, ref[k], tensor=(t.size, t.index),
                           fsdp=(f.size, f.index) if k in zs.shards
                           else (1, 0))
        err = (g.float() - want.to(g.device).float()).abs().max()
        if k.endswith("attn.key.bias"):
            # no gradient in exact arithmetic (the softmax ignores a shift
            # common to every key): both are rounding noise, held against
            # the layer's key kernel's gradient
            want = ref[k[:-len("bias")] + "kernel"]
        errs[k] = (err / want.float().abs().max()).item()
    trainer.state.optimizer.zero_grad()
    del ref
    return loss, errs


def tp_lm(res, ref_dir):
    """(a) transformer_lm_pp at full width cut to TP_LM_LAYERS layers (B
    64, T 1024, 12 heads of 64,
    vocab 32000, remat) at mesh.tensor 2: the first batch's gradients
    against one process's (:func:`tp_grads`); then TP_STEPS steps through
    the Trainer, the flash counts set to 0 before them; the last step
    profiled, its flash kernels counted by name; the tensor collectives of
    the first step by the recorder."""
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    t = Trainer(tp_lm_config(TP), device="cuda")
    m, L = t.model, t.model.num_layers
    split = t.model.tensor_split
    if not (t.mesh.spec.tensor == TP and m.block0.attn.num_heads == LM_H // TP
            and "block0.attn.query.kernel" in split
            and "lm_head.kernel" in split and "tok_embed.embedding" in split):
        raise AssertionError(f"(a) not cut over tensor: {sorted(split)[:6]}")
    grad_loss, errs = tp_grads(t, os.path.join(ref_dir, "lm_grads.pt"))
    worst = max(errs, key=errs.get)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()  # the path's count starts here
    with cc.recording() as records:
        t.train(steps=TP_STEPS - 1)
    prof = profile_step(t, count=TP_FLASH)
    launches = flash_counts()
    per = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    want = {k: v * TP_STEPS for k, v in per.items()}
    if launches != want:
        raise AssertionError(f"(a) flash launches {launches}, want {want}")
    if prof is not None and prof["counted"] != per:
        raise AssertionError(f"(a) flash by name {prof['counted']}")
    res["lm"] = dict(losses=t.losses(), launches=launches,
                     by_name=prof and prof["counted"],
                     grad_loss=grad_loss, worst_grad=worst,
                     worst_grad_rel_err=errs[worst],
                     step_s=[r.seconds for r in t.history],
                     peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                     collectives_a_step=tp_collectives(records),
                     device_ms=prof and prof["device_ms"],
                     by_family_ms=prof and prof["by_family_ms"],
                     local_heads=m.block0.attn.num_heads)
    t.close()
    del t, m
    gc.collect()
    torch.cuda.empty_cache()


def tp_pipe(res, ref_dir):
    """(d) transformer_lm_pp at full width cut to TP_PIPE_LAYERS layers, at
    mesh.pipe 2 x tensor 2 on the two processes: each holds both stages
    (pipe_local) and its tensor slice of them; TP_STEPS steps under gpipe,
    then under 1f1b, from the same weights."""
    import torch

    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    res["pipe"] = {}
    for sched in ("gpipe", "1f1b"):
        cfg = tp_pipe_config(sched, TP)
        t = Trainer(cfg, device="cuda")
        L = t.model.num_layers
        if not (t.mesh.pipe_local and t.state.sharding.S == 2
                and t.model.tensor_split):
            raise AssertionError(f"(d) {sched}: not pipe 2 x tensor 2 local")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_flash_counts()
        t0 = time.monotonic()
        t.train(steps=TP_STEPS)
        secs = time.monotonic() - t0
        launches = flash_counts()
        # each layer runs each microbatch; remat reruns the forward
        per = L * cfg.parallel.microbatches * TP_STEPS
        want = {"flash_fwd": (2 if cfg.model.remat else 1) * per,
                "flash_bwd_dq": per, "flash_bwd_dkv": per}
        if launches != want:
            raise AssertionError(f"(d) {sched} flash {launches}, want {want}")
        res["pipe"][sched] = dict(
            losses=t.losses(), steps_s=secs, launches=launches,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        t.close()
        del t
        gc.collect()
        torch.cuda.empty_cache()


def tp_generate(res, ref_dir):
    """(c) ``scripts/generate.py --tp 2`` on Llama-3-8B at full width, bf16
    and int8: its printed tokens; then, on the model the script laid out
    (kept by a wrapper of ``generate``), the per-token latency, the cache
    bytes a rank, and for int8 the w8a16 kernels by name in one profiled
    decode step (the wrapper's count too)."""
    import torch

    from pytorch_distributed_nn_tpu_torch.inference import generate as ig
    from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
    from pytorch_distributed_nn_tpu_torch.ops import int8_matmul as tmm
    from pytorch_distributed_nn_tpu_torch.runtime.mesh import (
        MeshSpec,
        process_mesh,
    )
    from pytorch_distributed_nn_tpu_torch.scripts import generate as script

    seen = {}
    original = ig.generate

    def kept(model, prompt, n, **kw):
        seen["model"] = model
        return original(model, prompt, n, **kw)

    res["generate"] = {}
    mesh = None
    for kind in TP_GEN_EXTRA:
        ig.generate = kept
        tmm.int8_matmul.launches = 0
        try:
            lines, secs = run_script(script.main, tp_gen_argv(kind, TP))
        finally:
            ig.generate = original
        launches = tmm.int8_matmul.launches
        model = seen.pop("model")
        mesh = mesh or process_mesh(MeshSpec(tensor=TP, data=-1),
                                    cc.rank(), cc.world_size())
        prompt = [[int(v) for v in TP_GEN_PROMPT.split()]]
        P = len(prompt[0])

        def timed(n):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            original(model, prompt, n, mesh=mesh)
            torch.cuda.synchronize()
            return time.monotonic() - t0

        prefill_s, whole_s = timed(1), timed(TP_GEN_NEW)
        cache = ig.init_cache(model, 1, P + TP_GEN_NEW)
        out = dict(lines=lines, script_s=secs, script_w8a16=launches,
                   per_token_ms=(whole_s - prefill_s) / (TP_GEN_NEW - 1)
                   * 1e3,
                   cache_bytes=ig.cache_bytes(cache),
                   cache_heads=cache["layer0"]["cached_key"].shape[2],
                   split=len(model.tensor_split))
        if kind == "int8":
            with torch.inference_mode():
                tok = torch.tensor(prompt, device="cuda")
                model(tok, cache=cache, last_only=True)
                step = tok[:, -1:]
                tmm.int8_matmul.launches = 0
                _, counted = profiled_call(
                    lambda: model(step, cache=cache, last_only=True),
                    {"w8a16": r"w8a16"})
                out["decode_step_w8a16"] = tmm.int8_matmul.launches
                out["decode_step_w8a16_by_name"] = (counted or {}).get(
                    "w8a16")
        res["generate"][kind] = out
        del model, cache
        gc.collect()
        torch.cuda.empty_cache()


def tp_8b(res, ref_dir):
    """(b) llama3_8b_zero (32/8 heads of 128, T 4096, xent_chunk 2048,
    remat) at depth TP8B_LAYERS under ZeRO-3 on fsdp 2 x tensor 2: the
    vocab tables split over (tensor, fsdp) on the vocab dim; TP_STEPS
    steps, the last profiled, the flash counts set to 0 before them."""
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import collectives as cc
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    cfg = tp_8b_config({"mesh.fsdp": "2", "mesh.tensor": str(TP),
                        "mesh.data": "1"})
    t = Trainer(cfg, device="cuda")
    zs, m = t.state.sharding, t.model
    table = "tok_embed.embedding"
    local = tuple(zs.shards[table].shape) if table in zs.shards else None
    if not (zs.stage == 3 and zs.dims.get(table) == 0
            and m.tensor_split.get(table, (None,))[0] == 0
            and local == (128256 // (2 * TP), 4096)
            and m.layer0.attn.num_heads == Z8_H // TP
            and m.layer0.attn.num_kv_heads == Z8_HKV // TP):
        raise AssertionError(f"(b) not ZeRO-3 x tensor: {table} {local}")
    L = m.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    with cc.recording() as records:
        t.train(steps=TP_STEPS - 1)
    prof = profile_step(t, count=TP_FLASH)
    launches = flash_counts()
    per = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    want = {k: v * TP_STEPS for k, v in per.items()}
    if launches != want:
        raise AssertionError(f"(b) flash launches {launches}, want {want}")
    if prof is not None and prof["counted"] != per:
        raise AssertionError(f"(b) flash by name {prof['counted']}")
    res["zero_tp"] = dict(
        losses=t.losses(), launches=launches,
        by_name=prof and prof["counted"],
        step_s=[r.seconds for r in t.history],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        collectives_a_step=tp_collectives(records), local_table=local,
        device_ms=prof and prof["device_ms"])
    t.close()


def tp_worker(rank, world, port, job, ref_dir, out_dir):
    """One process of a phase-33 gang: all ranks on the one card, in a gloo
    group formed here (NCCL refuses two ranks on one device; gloo reduces
    and gathers CUDA tensors), which ``runtime/bootstrap.py`` keeps; the
    job's parts, its results as JSON."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port),
                      # several processes share the card: return freed
                      # blocks rather than keep fragments of them
                      PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    import torch
    import torch.distributed as dist

    from pytorch_distributed_nn_tpu_torch.runtime import bootstrap

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    proc = bootstrap.initialize("cuda")
    if proc.backend != "gloo" or proc.device != torch.device("cuda", 0):
        raise AssertionError(f"rank {rank}: {proc}")
    res = dict(rank=rank, backend=proc.backend, device=str(proc.device))
    parts = {"lm": (tp_lm, tp_pipe, tp_generate), "8b": (tp_8b,),
             "zs": (zs_train,), "zs_resume": (zs_resume,)}[job]
    for part in parts:
        t0 = time.monotonic()
        part(res, ref_dir)
        res[f"{part.__name__}_s"] = time.monotonic() - t0
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    bootstrap.shutdown()


def tp_gang(job, world, ref_dir):
    """``world`` processes of :func:`tp_worker` on the card (spawned, a
    free port), waited for with a hard timeout and killed past it; each
    rank's results."""
    import socket

    import torch
    import torch.multiprocessing as mp

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[tensor] gang {job!r} of {world}: this process holds "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"({torch.cuda.memory_reserved() / 1e9:.2f} reserved); the card "
        f"{free / 1e9:.1f} of {total / 1e9:.1f} GB free")
    out_dir = tempfile.mkdtemp(prefix=f"chip-smoke-tp-{job}-")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(tp_worker,
                             args=(world, port, job, ref_dir, out_dir),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + TP_TIMEOUT_S
    try:
        while not ctx.join(timeout=5.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"phase 33 gang {job!r} ran past "
                                   f"{TP_TIMEOUT_S} s")
        return [json.loads(open(os.path.join(out_dir, f"rank{r}.json"))
                           .read()) for r in range(world)]
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        shutil.rmtree(out_dir, ignore_errors=True)


def tp_rel(got, want):
    """The largest relative gap of a run's losses from the reference's,
    step by step."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} losses against {len(want)}")
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def tp_references(ref_dir):
    """Phase 33's one-process runs, from the same seeds, at the full lr:
    (a)'s LM (its first batch's gradients saved to ``ref_dir``, then
    TP_STEPS steps), (d)'s pipeline (pipe 2, both stages here, gpipe),
    (b)'s ZeRO-3 8B, and (c)'s tokens of ``scripts/generate.py``."""
    import torch

    from pytorch_distributed_nn_tpu_torch.parallel import dp
    from pytorch_distributed_nn_tpu_torch.scripts import generate as script
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    out = {}
    ref = Trainer(tp_lm_config(), device="cuda")
    x, y = ref.loader.batch_at(0)
    dp._loss_and_grads(ref.state, x, y, ref.loss_fn)
    torch.save({k: p.grad.detach().cpu()
                for k, p in ref.model.named_parameters()},
               os.path.join(ref_dir, "lm_grads.pt"))
    ref.state.optimizer.zero_grad()
    for name, cfg in (("lm", None), ("pipe", tp_pipe_config("gpipe")),
                      ("zero", tp_8b_config())):
        if cfg is not None:
            ref = Trainer(cfg, device="cuda")
        ref.train(steps=TP_STEPS)
        out[name] = ref.losses()
        ref.close()
        del ref
        gc.collect()
        torch.cuda.empty_cache()
    for kind in TP_GEN_EXTRA:
        lines, secs = run_script(script.main, tp_gen_argv(kind))
        out[kind] = dict(tokens=lines[-1], script_s=secs)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_tensor():
    """Phase 33: the tensor axis on the one card. NCCL refuses two ranks on
    one device, and gloo reduces and gathers CUDA tensors (a probe on the
    H100 found every collective but point-to-point works), so the tensor
    ranks run as real processes sharing the card in a gloo group they form
    themselves, through the normal entry points. (a) and (d) on a 2-rank
    gang, with (c); (b) on a 4-rank gang (fsdp 2 x tensor 2); each against
    the same model on one process from the same weights and batches
    (:func:`tp_references`), every loss after a real update included, and
    (a)'s gradients leaf by leaf."""
    t_start = time.monotonic()
    ref_dir = tempfile.mkdtemp(prefix="chip-smoke-tp-ref-")
    try:
        refs = tp_references(ref_dir)
        log(f"[tensor] one-process references: "
            f"{json.dumps({k: refs[k] for k in ('lm', 'pipe', 'zero')})}, "
            f"tokens { {k: refs[k]['tokens'] for k in TP_GEN_EXTRA} }")
        ranks_a = tp_gang("lm", TP, ref_dir)
        ranks_b = tp_gang("8b", 2 * TP, ref_dir)
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    a0, b0 = ranks_a[0], ranks_b[0]
    lm, pipe, gen = a0["lm"], a0["pipe"], a0["generate"]
    errs = dict(
        lm=tp_rel(lm["losses"], refs["lm"]),
        pipe_gpipe=tp_rel(pipe["gpipe"]["losses"], refs["pipe"]),
        pipe_1f1b=tp_rel(pipe["1f1b"]["losses"], refs["pipe"]),
        zero_tp=tp_rel(b0["zero_tp"]["losses"], refs["zero"]))
    grad_errs = {r["rank"]: (r["lm"]["worst_grad"],
                             r["lm"]["worst_grad_rel_err"]) for r in ranks_a}
    same = all(r["lm"]["losses"] == lm["losses"] for r in ranks_a) and all(
        r["zero_tp"]["losses"] == b0["zero_tp"]["losses"] for r in ranks_b)
    tokens = {k: gen[k]["lines"][-1] for k in gen}
    out = dict(card=card_line(), approach="tensor ranks as processes "
               "sharing the card in their own gloo group",
               world1_tokens={k: refs[k] for k in TP_GEN_EXTRA},
               ref_losses={k: refs[k] for k in ("lm", "pipe", "zero")},
               rel_err=errs, worst_grad_rel_err=grad_errs, ranks_agree=same,
               lm=lm, pipe=pipe, generate=gen, zero_tp=b0["zero_tp"],
               peak_mem_gb=dict(
                   lm=[r["lm"]["peak_mem_gb"] for r in ranks_a],
                   zero_tp=[r["zero_tp"]["peak_mem_gb"] for r in ranks_b]),
               part_s={k: v for k, v in a0.items() if k.endswith("_s")}
               | {k: v for k, v in b0.items() if k.endswith("_s")},
               phase_s=time.monotonic() - t_start)
    log(f"[tensor] {json.dumps(out)}")
    bad = [k for k, v in errs.items() if not v <= TP_LOSS_TOL]
    if bad or not same:
        raise AssertionError(f"phase 33 losses off (limit {TP_LOSS_TOL}): "
                             f"{ {k: errs[k] for k in bad} }, ranks agree "
                             f"{same}")
    if not all(e <= TP_GRAD_TOL for _, e in grad_errs.values()):
        raise AssertionError(f"(a) gradients off (limit {TP_GRAD_TOL}): "
                             f"{grad_errs}")
    for kind in TP_GEN_EXTRA:
        if tokens[kind] != refs[kind]["tokens"]:
            raise AssertionError(
                f"(c) {kind} --tp {TP} tokens {tokens[kind]!r} differ from "
                f"one process's {refs[kind]['tokens']!r}")
        if ranks_a[1]["generate"][kind]["lines"]:
            raise AssertionError("(c) rank 1 printed")
    i8 = gen["int8"]
    if i8["script_w8a16"] != W8A16_TP_GEN * TP_GEN_NEW or \
            i8["decode_step_w8a16"] != W8A16_TP_GEN or \
            i8["decode_step_w8a16_by_name"] not in (None, W8A16_TP_GEN):
        raise AssertionError(f"(c) int8 w8a16 launches {i8}")
    return out


# ---------------------------------------------------------------------------
# rule 3: ZeRO under sequence parallelism, seq x tensor, and resuming onto
# another layout (phase 34)
# ---------------------------------------------------------------------------
ZS_STEPS = 2
ZS_MESH = {
    # (a) ZeRO-3 on fsdp 2 x seq 2, ring attention on the ring kernel
    "zero_seq": {"parallel.strategy": "zero", "parallel.zero_stage": "3",
                 "mesh.fsdp": "2", "mesh.seq": "2", "mesh.data": "1"},
    # (b) seq 2 x tensor 2 (the dp step at tensor 2), 4/2 heads a rank
    "seq_tensor": {"parallel.strategy": "dp", "mesh.seq": "2",
                   "mesh.tensor": "2", "mesh.data": "1"},
    # (c) (a)'s step-1 checkpoint resumed on ZeRO-1 over fsdp 2, no seq
    "zero1": {"parallel.strategy": "zero", "parallel.zero_stage": "1",
              "mesh.fsdp": "2", "mesh.data": "1"},
    # (c) and by one process (replicated)
    "single": {"parallel.strategy": "single"},
}
ZS_BATCH = {"zero_seq": 2, "seq_tensor": 1, "zero1": 2, "single": 2}
# a resumed step 2 against the straight run's step 2
ZS_RESUME_TOL = 1e-5
ZS_COUNT = {"ring_block": r"ring_block_kernel",
            **{k: rf"{k}_kernel" for k in ("flash_bwd_dq", "flash_bwd_dkv")}}


def zs_config(layout, ckpt=None):
    """llama3_longcontext at its preset's full width (8 layers, d 1024,
    8/4 heads of 128, T 32768, xent_chunk 2048, remat) with ring attention
    (on one process a one-rank ring: the ring kernel over the whole
    sequence), at the full lr, on ``layout``."""
    from pytorch_distributed_nn_tpu_torch.config import get_config

    extra = dict(get_config("llama3_longcontext").model.extra,
                 attn_impl="ring")  # an override replaces the preset's
    ov = {**TP_NO_WARMUP, **ZS_MESH[layout], "steps": str(ZS_STEPS),
          "data.batch_size": str(ZS_BATCH[layout]),
          "model.extra": json.dumps(extra)}
    if ckpt:
        ov["checkpoint_dir"] = ckpt
    return get_config("llama3_longcontext", log_every="1", **ov)


def zs_steps(res, key, t, save=False):
    """ZS_STEPS steps of Trainer ``t`` (the last profiled, its ring and
    flash backward kernels counted by name): each step's seconds, the
    rank's peak GB, the collectives with their payload bytes, the ring's
    host-staged shifts, the kernels' launches by wrapper; with ``save`` a
    synchronous save before the last step."""
    import torch

    from pytorch_distributed_nn_tpu_torch.ops import collectives as cc

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_ring_counts()
    for k in cc.host_p2p:
        cc.host_p2p[k] = 0
    saved = None
    with cc.recording() as records:
        t.train(steps=ZS_STEPS - 1)
        if save:
            t.save_checkpoint()
            saved = dict(t.ckpt.last_save)
        prof = profile_step(t, count=ZS_COUNT)
    res[key] = dict(
        losses=t.losses(), step_s=[r.seconds for r in t.history],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        collectives=tp_collectives(records), host_p2p=dict(cc.host_p2p),
        launches=ring_counts(), by_name=prof and prof["counted"],
        device_ms=prof and prof["device_ms"], save=saved)


def zs_train(res, ref_dir):
    """(a) then (b) on the 4-rank gang: (a) ZeRO-3 on fsdp 2 x seq 2 (its
    first batch's gradients against one process's; 2 steps, saved after
    the first, into ``ref_dir``'s checkpoint), (b) seq 2 x tensor 2."""
    from pytorch_distributed_nn_tpu_torch.parallel.api import (
        make_chunked_loss,
    )
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    t = Trainer(zs_config("zero_seq", os.path.join(ref_dir, "ckpt")),
                device="cuda")
    zs = t.state.sharding
    if not (zs.stage == 3 and zs.grad.size == 4 and zs.fsdp.size == 2
            and t.mesh.seq.size == 2 and zs.shards):
        raise AssertionError(f"(a) not ZeRO-3 on fsdp 2 x seq 2: "
                             f"{t.mesh.spec}")
    loss, errs = tp_grads(t, os.path.join(ref_dir, "grads.pt"),
                          make_chunked_loss(t.cfg.xent_chunk))
    worst = max(errs, key=errs.get)
    res["grads"] = dict(loss=loss, worst=worst, worst_rel_err=errs[worst],
                        writes=zs.writes)
    zs_steps(res, "zero_seq", t, save=True)
    t.close()
    del t, zs
    gc.collect()
    t = Trainer(zs_config("seq_tensor"), device="cuda")
    attn = t.model.layer0.attn
    if (attn.num_heads, attn.num_kv_heads) != (4, 2):
        raise AssertionError(f"(b) at {attn.num_heads}/"
                             f"{attn.num_kv_heads} heads")
    zs_steps(res, "seq_tensor", t)
    t.close()


def zs_resume(res, ref_dir):
    """(c) on a 2-rank gang: (a)'s step-1 checkpoint restored into ZeRO-1
    over fsdp 2, no seq (resharded on read), and its step 2."""
    zs_resumed(res, "zero1", os.path.join(ref_dir, "ckpt"))


def zs_resumed(res, layout, ckpt):
    import torch

    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    torch.cuda.synchronize()
    t0 = time.monotonic()
    t = Trainer(zs_config(layout, ckpt), device="cuda")
    restore = dict(t.ckpt.last_restore, build_and_restore_s=time.monotonic()
                   - t0, data_step=t.data_step)
    t.train(steps=1)
    res[layout] = dict(losses=t.losses(), restore=restore,
                       step_s=[r.seconds for r in t.history])
    t.close()


def zs_references(ref_dir):
    """Phase 34's one-process runs, at the full lr: (a)'s batch of 2 (its
    first batch's gradients saved to ``ref_dir``, then ZS_STEPS steps)
    and (b)'s batch of 1."""
    import torch

    from pytorch_distributed_nn_tpu_torch.parallel import dp
    from pytorch_distributed_nn_tpu_torch.parallel.api import (
        make_chunked_loss,
    )
    from pytorch_distributed_nn_tpu_torch.train.trainer import Trainer

    out = {}
    for layout in ("single", "seq_tensor"):
        cfg = zs_config("single")
        if layout == "seq_tensor":
            cfg = cfg.override(**{"data.batch_size": "1"})
        ref = Trainer(cfg, device="cuda")
        if layout == "single":
            x, y = ref.loader.batch_at(0)
            dp._loss_and_grads(ref.state, x, y,
                               make_chunked_loss(cfg.xent_chunk))
            torch.save({k: p.grad.detach().cpu()
                        for k, p in ref.model.named_parameters()},
                       os.path.join(ref_dir, "grads.pt"))
            ref.state.optimizer.zero_grad()
        ref.train(steps=ZS_STEPS)
        out["zero_seq" if layout == "single" else layout] = ref.losses()
        ref.close()
        del ref
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_zero_seq():
    """Phase 34: ZeRO under sequence parallelism, seq x tensor and a
    resume onto other layouts, at llama3_longcontext's full width on the
    one card. The ranks are processes sharing the card in a gloo group (as
    phase 33's): the ring's shifts between them go through host memory
    (``ops.collectives`` ``host_p2p``), the ring kernel runs in every rank.
    (a) ZeRO-3 on fsdp 2 x seq 2 (4 processes, batch 2) and (b) seq 2 x
    tensor 2 (batch 1) against one process's runs from the same weights
    and batches (losses within TP_LOSS_TOL; (a)'s gradient slices within
    TP_GRAD_TOL); (c) (a)'s step-1 checkpoint restored into ZeRO-1 on
    fsdp 2 (2 processes) and into one process: step 2's loss within
    ZS_RESUME_TOL of (a)'s."""
    t_start = time.monotonic()
    ref_dir = tempfile.mkdtemp(prefix="chip-smoke-zs-")
    try:
        refs = zs_references(ref_dir)
        log(f"[zero_seq] one-process references: {json.dumps(refs)}")
        ranks = tp_gang("zs", 4, ref_dir)
        pair = tp_gang("zs_resume", 2, ref_dir)
        one = {}
        zs_resumed(one, "single", os.path.join(ref_dir, "ckpt"))
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    r0 = ranks[0]
    a, b = r0["zero_seq"], r0["seq_tensor"]
    errs = dict(zero_seq=tp_rel(a["losses"], refs["zero_seq"]),
                seq_tensor=tp_rel(b["losses"], refs["seq_tensor"]))
    straight = a["losses"][1]
    resumed = {"zero1": pair[0]["zero1"], "single": one["single"]}
    resume_err = {k: abs(v["losses"][0] - straight) / abs(straight)
                  for k, v in resumed.items()}
    grads = {r["rank"]: (r["grads"]["worst"], r["grads"]["worst_rel_err"])
             for r in ranks}
    same = all(r[k]["losses"] == r0[k]["losses"] for r in ranks
               for k in ("zero_seq", "seq_tensor"))
    out = dict(card=card_line(), approach="the ranks as processes sharing "
               "the card in their own gloo group; the ring's shifts "
               "staged through host memory",
               ref_losses=refs, rel_err=errs, worst_grad_rel_err=grads,
               ranks_agree=same, resume_rel_err=resume_err,
               resumed=resumed, writes=[r["grads"]["writes"]
                                        for r in ranks],
               per_rank={r["rank"]: {k: {f: r[k][f] for f in (
                   "step_s", "peak_mem_gb", "collectives", "host_p2p",
                   "launches", "by_name", "device_ms")}
                   for k in ("zero_seq", "seq_tensor")} for r in ranks},
               save=a["save"], zero_seq=a, seq_tensor=b,
               part_s={k: v for k, v in r0.items() if k.endswith("_s")},
               phase_s=time.monotonic() - t_start)
    log(f"[zero_seq] {json.dumps(out)}")
    bad = [k for k, v in errs.items() if not v <= TP_LOSS_TOL]
    if bad or not same:
        raise AssertionError(f"phase 34 losses off (limit {TP_LOSS_TOL}): "
                             f"{ {k: errs[k] for k in bad} }, ranks agree "
                             f"{same}")
    if not all(e <= TP_GRAD_TOL for _, e in grads.values()):
        raise AssertionError(f"(a) gradients off (limit {TP_GRAD_TOL}): "
                             f"{grads}")
    if [r["grads"]["writes"] for r in ranks] != [True, False, True, False]:
        raise AssertionError("(a) a seq rank other than the first wrote")
    for k, v in resumed.items():
        if not (v["restore"]["resharded"] and v["restore"]["data_step"] == 1
                and resume_err[k] <= ZS_RESUME_TOL):
            raise AssertionError(f"(c) {k}: {v}, step 2 off by "
                                 f"{resume_err[k]} (limit {ZS_RESUME_TOL})")
    for r in ranks:
        for k in ("zero_seq", "seq_tensor"):
            got = r[k]
            if not (got["launches"]["ring_block_update"]
                    and got["launches"]["flash_bwd_dq"]
                    and got["launches"]["flash_bwd_dkv"]
                    and got["host_p2p"]["messages"]):
                raise AssertionError(f"rank {r['rank']} {k}: {got}")
            if got["by_name"] is not None and not got["by_name"][
                    "ring_block"]:
                raise AssertionError(f"rank {r['rank']} {k}: no ring "
                                     f"kernel by name {got['by_name']}")
    return out


def main() -> int:
    started = time.monotonic()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from pytorch_distributed_nn_tpu_torch.ops import build
    from pytorch_distributed_nn_tpu_torch.ops import int8_matmul as tmm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev_name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.monotonic()
    sources = ("int8_matmul.cu", "flash_attention.cu", "bn_stats.cu",
               "quantize.cu", "ring_attention.cu")
    build.load_libraries(*sources)  # one nvcc each, all started together
    log(f"[build] {' + '.join(sources)}: {time.monotonic() - t0:.2f} s")
    tick("build")
    resources = {}
    for src in sources:
        secs, report = build.build_info[src]
        log(f"[build] {src}: nvcc {secs:.2f} s")
        resources.update(kernel_resources(report))
    for kernel, res in resources.items():
        log(f"[build] {kernel}: {json.dumps(res)}")

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows, max_err, library_label = phase_kernel(flush)
    tick("phase_kernel")
    flash_rows, lse_err = phase_flash(flush)
    tick("phase_flash")
    flash64 = phase_flash64(flush)
    tick("phase_flash64")
    flash8b = phase_flash8b(flush)
    tick("phase_flash8b")
    ring = phase_ring(flush)
    tick("phase_ring")
    del flush
    torch.cuda.empty_cache()
    bn = phase_bn_stats()
    tick("phase_bn_stats")
    quant = phase_quantize()
    tick("phase_quantize")
    auto = phase_auto()
    tick("phase_auto")
    train_check = phase_train_check()
    tick("phase_train_check")
    ring_check = phase_ring_check()
    tick("phase_ring_check")
    train, flash_launches = phase_train()
    tick("phase_train")
    ring_train = phase_ring_train()
    tick("phase_ring_train")
    ring4 = phase_ring4(ring_train["llama3_longcontext"]["losses"])
    tick("phase_ring4")
    dp_check = phase_dp_check()
    tick("phase_dp_check")
    dp_train, bn_launches, q_launches = phase_dp_train()
    tick("phase_dp_train")
    dp_preset = phase_dp_preset()
    tick("phase_dp_preset")
    lm_d64, lm_launches = phase_lm_d64()
    tick("phase_lm_d64")
    bert, bert_q_launches = phase_bert()
    tick("phase_bert")
    ckpt = phase_ckpt()
    tick("phase_ckpt")
    accum, accum_flash, accum_bn = phase_accum()
    tick("phase_accum")
    multistep = phase_multistep()
    tick("phase_multistep")
    offload, offload_flash = phase_offload()
    tick("phase_offload")
    zero8b, zero8b_flash = phase_zero8b()
    tick("phase_zero8b")
    pipe, pipe_flash = phase_pipe()
    tick("phase_pipe")
    moe, moe_flash, moe_profiled = phase_moe()
    tick("phase_moe")
    # phase 28's checkpoints stay under ckpt_root for phase 32's eval
    ckpt_root = tempfile.mkdtemp(prefix="chip-smoke-serve-")
    try:
        serve_ckpt, ckpt_flash, ckpt_int8 = phase_serve_ckpt(ckpt_root)
        tick("phase_serve_ckpt")
        files, files_flash, files_profiled = phase_files(lm_d64)
        tick("phase_files")
        pipe_moe, pipe_moe_flash, pipe_moe_profiled = phase_pipe_moe()
        tick("phase_pipe_moe")

        model = build_model(seed=0)
        forward = phase_forward(model)
        tick("phase_forward")
        serve, serve_launches = phase_serve(model)
        tick("phase_serve")
        if PL_LAYERS != SERVE_LAYERS:
            del model
            gc.collect()
            torch.cuda.empty_cache()
            model = build_model(seed=0, layers=PL_LAYERS)
        prefix_lora, pl_launches = phase_prefix_lora(model)
        tick("phase_prefix_lora")
        t32 = time.monotonic()
        tenants, tenant_launches = phase_tenants(model)
        tick("phase_tenants")
        del model
        gc.collect()
        torch.cuda.empty_cache()
        fault1 = phase_fault1()
        tick("phase_fault1")
        scripts, eval_flash, eval_by_name = phase_scripts(
            os.path.join(ckpt_root, "llama"),
            serve_ckpt["llama3_8b_zero"]["save"]["eval"])
        tick("phase_scripts")
        log(f"[tenants_scripts] phase 32: {time.monotonic() - t32:.1f} s")
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    tensor = phase_tensor()
    tick("phase_tensor")
    zero_seq = phase_zero_seq()
    tick("phase_zero_seq")
    gen_launches = scripts["convert"]["w8a16_launches"]
    tp_gen = tensor["generate"]["int8"]
    launches = (sum(serve_launches.values()) + ckpt_int8
                + sum(pl_launches.values()) + tenant_launches + gen_launches
                + tp_gen["script_w8a16"])

    at8 = {r["shape"]: r for r in rows if r["m"] == 8}
    at128 = {r["shape"]: r for r in rows if r["m"] == 128}

    def per_forward(key, at=at8):
        return sum(at[name][key] * per for name, _, _, per in PATH_SHAPES)

    kernels = [dict(
        name="int8_matmul", route="cuda", source=SOURCE,
        replaces=TPU_KERNEL, launches=launches, max_abs_err=max_err,
        # one 8B decode forward at 8 slots: 129 calls
        ms=per_forward("ms"), plain_ms=per_forward("plain_ms"),
        bound_ms=per_forward("bound_ms"),
        bound_by=("bytes" if all(r["bound_by"] == "bytes"
                                 for r in at8.values()) else "operations"),
        launches_by_path=dict(serve_compute=serve_launches["compute"],
                              serve_int8_cache=serve_launches["int8"],
                              serve_ckpt_8b=ckpt_int8,
                              prefix_lora=pl_launches,
                              tenants=tenant_launches,
                              generate_converted=gen_launches,
                              generate_tp2=tp_gen["script_w8a16"]),
        at_tensor=dict(
            decode_step=tp_gen["decode_step_w8a16"],
            decode_step_by_name=tp_gen["decode_step_w8a16_by_name"],
            per="phase 33 (c): scripts/generate.py --tp 2 on the int8 8B "
                f"(two processes on the card), {TP_GEN_NEW} forwards of "
                f"{W8A16_TP_GEN} on rank 0, the weights whole on each "
                "rank; "
                "decode_step: one decode step's launches, by wrapper and "
                "by name in its profiled trace"),
        at_tenants=dict(
            profiled_round=tenants["profiled_round"],
            per=f"phase 32 on the full-width 8B at {PL_LAYERS} of 32 "
                "layers: the tenant mix (a flood of "
                "24 with a quota of 2, two light tenants of 3), "
                f"{W8A16_PL} a "
                "forward; profiled_round: the w8a16 kernels by name in one "
                "profiled decode round; generate_converted: "
                "scripts/generate.py on a converted "
                f"{CK_8B_LAYERS}-layer 8B, {4 * CK_8B_LAYERS + 1} a "
                "forward"),
        at_prefix_lora=dict(
            profiled_round=prefix_lora["compute"]["profiled_round"],
            at_suffix_rows=prefix_lora["w8a16_at_suffix"],
            per=f"phase 31 on the full-width 8B at {PL_LAYERS} of 32 "
                "layers: the prefix-cache stream "
                "with the cache on and off on each KV cache (compute, "
                "int8), the eviction run and the LoRA runs, "
                f"{W8A16_PL} a "
                "forward; profiled_round: the w8a16 kernels by name in one "
                "profiled round of a hit's suffix prefill and a decode "
                "step"),
        library_ms=per_forward("library_ms"), library=library_label,
        read_ms=per_forward("read_ms"),
        prefill_ms=per_forward("ms", at128),
        prefill_bound_ms=per_forward("bound_ms", at128),
        prefill_plain_ms=per_forward("plain_ms", at128),
        resources={k: v for k, v in resources.items() if "w8a16" in k},
        decode_profile=forward["profile"],
        per="one 8B decode forward at M=8 (129 calls); prefill_*: one "
            "forward at M=128; read_ms: torch.sum over the same weight "
            "bytes under the same flush", shapes=rows)]
    for name, (replaces, _) in FLASH_KERNELS.items():
        kernels.append(dict(
            name=name, route="cuda", source=FLASH_SOURCE, replaces=replaces,
            launches=flash_launches[name], **flash_rows[name],
            resources=resources.get(f"{name}_kernel<128>"),
            library="F.scaled_dot_product_attention(is_causal=True, "
                    "enable_gqa=True)" + (" backward (dq, dk and dv)"
                                          if name != "flash_fwd" else ""),
            per="one call at B 1, T 32768, H 8, Hkv 4, D 128, causal",
            at_d64=dict(
                launches=lm_launches[name], **flash64[name],
                resources=resources.get(f"{name}_kernel<64>"),
                per="one call at B 64, T 1024, H = Hkv = 12, D 64, causal "
                    "(transformer_lm_pp); launches: its 4 timed steps",
                launches_accum=accum_flash[name],
                accum="transformer_lm_pp with grad_accum 4 (4 x B 16), "
                      "3 timed steps"),
            at_8b=dict(
                launches=zero8b_flash[name], **flash8b[name],
                per="one call at B 1, T 4096, H 32, Hkv 8, D 128, causal "
                    "(llama3_8b_zero, config 5); launches: its 3 timed "
                    "zero-3 steps at depth 8"),
            at_moe=dict(
                launches=moe_flash[name],
                profiled_launches=moe_profiled[name],
                per="moe_lm_ep at full width (B 32, T 1024, H = Hkv = 12, "
                    "D 64, causal, no remat); launches: its 3 timed steps; "
                    "profiled_launches: the kernels of this name in one "
                    "profiled step's device trace"),
            launches_pipe={sched: pipe_flash[sched][name]
                           for sched in pipe_flash},
            pipe="transformer_lm_pp on mesh.pipe 4 (one process, every "
                 "stage), 8 microbatches, 3 steps a schedule",
            launches_resume=ckpt["launches"][name],
            launches_serve_ckpt=ckpt_flash[name],
            serve_ckpt="phase 28's trainings: transformer_lm_pp 2 steps "
                       "(B 64, T 1024, remat) and llama3_8b_zero at depth "
                       f"{CK_8B_LAYERS} 1 step (B 1, T 4096, remat)",
            launches_offload=offload_flash[name],
            launches_eval=eval_flash[name],
            eval_by_name=(eval_by_name or {}).get(name),
            eval=f"scripts/eval.py on phase 28's {CK_8B_LAYERS}-layer 8B "
                 f"checkpoint, {EVAL_BATCHES} batches at T 4096; by name: "
                 "the kernels "
                 "of this name in the call's profiled trace",
            launches_files=files_flash[name],
            profiled_launches_files=files_profiled[name],
            files="transformer_lm_pp from a 16M-token uint16 token file "
                  "(B 64, T 1024, remat, holdout_frac 0.05): its 3 timed "
                  "steps; profiled: the kernels of this name in one "
                  "profiled step's device trace",
            launches_pipe_moe={sched: pipe_moe_flash[sched][name]
                               for sched in pipe_moe_flash},
            profiled_launches_pipe_moe={
                sched: pipe_moe_profiled[sched][name]
                for sched in pipe_moe_profiled},
            pipe_moe="moe_lm_ep at full width under the pipeline, every "
                     "stage in one process, 8 microbatches (B 32, T 1024, "
                     "no remat): 1f1b on pipe 4 with moe_every 1, "
                     "interleaved on pipe 2 x 3 chunks with moe_every 2, "
                     "2 timed steps each; profiled: one step's device "
                     "trace",
            at_tensor=dict(
                launches_lm=tensor["lm"]["launches"][name],
                by_name_lm=(tensor["lm"]["by_name"] or {}).get(name),
                launches_pipe={s: tensor["pipe"][s]["launches"][name]
                               for s in tensor["pipe"]},
                launches_zero_tp=tensor["zero_tp"]["launches"][name],
                by_name_zero_tp=(tensor["zero_tp"]["by_name"]
                                 or {}).get(name),
                per="phase 33 on rank 0 of the tensor ranks sharing the "
                    "card: transformer_lm_pp at tensor 2 (6 of 12 heads "
                    f"of 64, {TP_LM_LAYERS} of 12 layers), {TP_STEPS} "
                    "steps, by name in the last; "
                    f"pipe 2 x tensor 2, {TP_STEPS} steps a schedule; "
                    f"llama3_8b_zero at depth {TP8B_LAYERS} under ZeRO-3 "
                    "on fsdp 2 x tensor 2 (16/4 of 32/8 heads of 128), "
                    f"{TP_STEPS} steps, by name in the last"),
            launches_zero_seq={k: zero_seq[k]["launches"][name]
                               for k in ("zero_seq", "seq_tensor")},
            zero_seq="phase 34 on rank 0 of 4 processes sharing the card: "
                     "llama3_longcontext under ZeRO-3 on fsdp 2 x seq 2 "
                     "and on seq 2 x tensor 2, the ring's backward pairs, "
                     f"{ZS_STEPS} steps each",
            resume="llama3_longcontext, 2 steps + save + a resumed "
                   "Trainer's 2 steps",
            offload="llama3_longcontext_96k with remat_offload, 2 steps"))
    bn_step = bn["step"]
    kernels.append(dict(
        name="bn_stats", route="cuda", source=BN_SOURCE, replaces=BN_TPU,
        launches=sum(bn_launches.values()), launches_by_mode=bn_launches,
        launches_accum=sum(accum_bn.values()),
        accum="resnet50_dp (dp, overlap) at batch 256, grad_accum 2, 3 "
              "timed steps: 2 x (53 + 53) a step",
        launches_in_graph=sum(multistep["resnet50_dp"][
            "bn_stats_in_profiled_replay"].values()),
        in_graph="resnet50_dp at batch 256, multistep_k 4, pool 4: the "
                 "bn_stats kernels (bn_partial) counted by name in the "
                 "torch.profiler traces of three replays of the captured "
                 "graph, each kernel's most (53 + 53 a step, 4 steps a "
                 "replay)",
        max_abs_err=bn["max_abs_err"], ms=bn_step["ms"],
        plain_ms=bn_step["plain_ms"], bound_ms=bn_step["bound_ms"],
        bound_by=bn_step["bound_by"], library_ms=bn_step["library_ms"],
        library="torch.batch_norm_stats + torch.batch_norm_backward_reduce",
        per=f"one ResNet-50 training step at batch {DP_BATCH}: 53 "
            "sum_and_sumsq + 53 sum_and_dot calls, bf16",
        shapes=bn["shapes"]))
    kernels.append(dict(
        name="quantize", route="cuda", source=QUANT_SOURCE,
        replaces=QUANT_TPU, launches=q_launches, max_abs_err=0.0,
        ms=quant["ms"], device_ms=quant["device_ms"],
        plain_ms=quant["plain_ms"],
        bound_ms=quant["bound_ms"], bound_by=quant["bound_by"],
        library_ms=None, library="none (no single PyTorch call rounds "
        "stochastically to int8)",
        per=f"one ResNet-50 step's {quant['buckets']} f32 buckets "
            f"({quant['elements']} elements); max_abs_err against the "
            "plain version, which it equals bit for bit",
        launches_bert_int8=bert_q_launches,
        bert_int8="bert_base_buckets, 2 steps on the int8 wire, issued "
                  "from the overlap hooks: one launch a f32 bucket a step"))
    main_pair = ring["times"]["diagonal_32768"]
    kernels.append(dict(
        name="ring_block_update", route="cuda", source=RING_SOURCE,
        replaces=RING_TPU,
        launches=ring_train["llama3_longcontext"]["launches"][
            "ring_block_update"],
        max_abs_err=ring["max_abs_err"], rel_err=ring["rel_err"],
        ms=main_pair["ms"],
        plain_ms=main_pair["plain_ms"], bound_ms=main_pair["bound_ms"],
        bound_by=main_pair["bound_by"], library_ms=main_pair["library_ms"],
        library=RING_LIBRARY,
        resources=resources.get("ring_block_kernel<128>"),
        per="one call at the world-1 main path's shape: the diagonal pair "
            "at Tl = 32768 (B 1, H 8, Hkv 4, D 128, causal); max_abs_err "
            "and rel_err (max|err|/max|ref|) of acc against the plain "
            "version over every check (Tl 8192; the main path's pairs at "
            "Tl 32768 and, on row slices, 98304)",
        at_8192={k: v for k, v in ring["times"].items() if "8192" in k},
        at_zero_seq={k: dict(launches=zero_seq[k]["launches"],
                             by_name=zero_seq[k]["by_name"])
                     for k in ("zero_seq", "seq_tensor")},
        zero_seq="phase 34 on rank 0 of 4 processes sharing the card: "
                 "llama3_longcontext (T 32768, 8 layers) under ZeRO-3 on "
                 "fsdp 2 x seq 2 (8/4 heads) and on seq 2 x tensor 2 (4/2 "
                 f"heads), {ZS_STEPS} steps each; by_name: the ring and "
                 "flash backward kernels in the last step's profiled "
                 "trace"))
    log(json.dumps(dict(forward=forward, serve=serve, auto=auto,
                        train_check=train_check, train=train,
                        ring=ring, ring_check=ring_check,
                        ring_train=ring_train, ring4=ring4,
                        flash_lse_err=lse_err, bn_stats=bn,
                        quantize=quant, dp_check=dp_check,
                        dp_train=dp_train, dp_preset=dp_preset,
                        flash64=flash64, lm_d64=lm_d64, bert=bert,
                        ckpt=ckpt, accum=accum, multistep=multistep,
                        offload=offload, flash8b=flash8b, zero8b=zero8b,
                        pipe=pipe, moe=moe, serve_ckpt=serve_ckpt,
                        files=files, pipe_moe=pipe_moe,
                        prefix_lora=prefix_lora, tenants=tenants,
                        fault1=fault1, scripts=scripts, tensor=tensor,
                        zero_seq=zero_seq)))
    from pytorch_distributed_nn_tpu_torch.runtime import bootstrap

    bootstrap.shutdown()  # the NCCL group of the data-parallel phases
    log(f"[total] chip_smoke.py wall time {time.monotonic() - started:.1f} "
        "s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    raise SystemExit(rc)
