#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`paddle_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100. It
builds the port's CUDA kernels from `paddle_tpu_torch/csrc/`, holds each
one against its plain PyTorch version on the card, checks cut-down models
on the card against the same models on the CPU, serves 16 requests
through the continuous-batching `LLMEngine` (plainly, then with
speculative decoding, its own draft or `gpt3-125m` proposing) and trains
13 steps through `ScanTrainStep` twice, both at the full width of
`gpt3-1.3b` in bf16,
serves a shared system prompt through the prefix cache, its host tier
and a stream handoff at the same width, trains it in fp32 master weights
through a DistributedStrategy (AMP bf16 and fp16 with dynamic loss
scaling, recompute, gradient merge) and in Paddle's pure-fp16 recipe
(amp.decorate O2, fp32 master weights), serves it cast to fp16, then
does the same for the Llama-2 family: serves `llama2-7b` whole and
`llama2-70b`'s widths cut in depth, and trains `llama2-7b` whole with the
Llama 2 recipe, then trains `ernie-moe-base` whole, and last trains
`resnet50` as bench.py trains BASELINE config 1 (random weights from a
seed), fits `mobilenet_v2` through Paddle's high-level `Model.fit`
over `io.DataLoader`, and trains full `gpt3-125m` under the resilient
runtime (checkpoint tiers, fault injection, a killed and a resumed
child process) and under the numerics observatory; between the train
phases and Llama it fine-tunes LoRA adapters on full `gpt3-1.3b` and
serves them, three at once, beside base streams; after the speculative
phase it serves the same model through the HTTP front end, a two-replica
router (a failover, a prefill/decode handoff) and two rolling weight
deploys (one rolled back); last it trains `gpt3-1.3b` over several
ranks on the one card (tensor parallelism, ZeRO 2, hybrid data x tensor
parallelism with a clip) against the one-rank step, and checks a
one-rank NCCL group. It prints one JSON line per
phase, then each phase's wall seconds, the `{"kernels": [...]}` line,
the card's name and power limit as `nvidia-smi` reports them, and last
`{"ok": true, "device": {...}}`. Any failure exits non-zero before the
last two lines; with no GPU, or outside a checkout, it exits 2 at once.

Phases:
  1. device   — card name, count, nvidia-smi name/power limit
  2. build    — nvcc build of the kernel library, timed, with ptxas's
                register and spill report (no instantiation of a
                tensor-core kernel or of a LayerNorm kernel may spill),
                the tensor-core instructions (wgmma's HGMMA, mma.sync's
                HMMA) of every instantiation of the bf16 and fp16 flash
                forward, dq and dk/dv (plain, mask and dropout) and the
                bf16 and fp16 paged attention counted in their machine
                code (cuobjdump -sass), the fp16 instantiations among them
                counted (TENSOR_CORE_FP16), and 16-byte loads and stores
                (LDG.E.128, STG.E.128) in every bf16 and fp16 LayerNorm
                instantiation of the 16-byte path
  3. kernels  — each kernel against its plain version at its path's
                shapes (serving: paged attention and the LayerNorm
                forward; training: flash attention forward, dq and dk/dv
                at [4,16,1024,128] bf16 causal and the LayerNorm forward
                and backward at 4096x2048 bf16, the forward also with its
                input cycled past L2, and a row's forward bit-equal alone,
                among 64 or 512 rows and at scalar width; the optimizer:
                fused Adam bit for bit in every dtype, with and without a
                master weight, at n = 1000, 2049, linear1.weight and the
                word embedding), with fp32, GQA, block_len 12..64, non-causal,
                Sq != Sk, ragged, D=16..64 and B*H > 132 edge cases, the
                bf16 paged attention and flash forward, dq and dk/dv run
                twice and held bit-equal, the flash kernels also at
                ernie-moe-base's [8,12,1024,64] (`at_moe_shape`), timed
                on the device (median of
                21 CUDA-event samples of back-to-back calls held behind a
                spin kernel) beside one PyTorch library call for the same
                function and the least time the card could take (flash
                and paged attention: with their achieved TFLOP/s and share
                of that bound); paged attention at the speculative draft's
                shape (gpt3-125m's 12 heads of 64, block_len 8, 8 slots) at
                Tq = 1 and 64 (`at_draft_shape`), held, run twice
                bit-equal and timed beside its bound, its plain version
                and SDPA; the prefix cache's layout, 8 rows reading one
                row's 32 pages, bit-equal to the rows reading private copies
                and timed beside them; the fp16 kernels (fp16_kernels):
                the flash forward, dq and dk/dv at [4,16,1024,128] causal
                and edge shapes, the LayerNorm forward and backward at
                512x2048 and 4096x2048 (and edge widths) under the
                FP16_TRAIN_* rule, fused Adam bit for bit in every dtype
                combination with fp16 in it and at the word embedding with
                fp16 p and g, an fp32 master and fp32 moments, paged
                attention at the serve shape on both routes (block_len 8
                and 12) and at the GQA shape under the FP16_PA_* rule,
                each run twice bit-equal and timed beside its bound, its
                plain version and fp16 SDPA / F.layer_norm (no PyTorch
                call computes the fp16 Adam update with a master); fused
                Adam's do_update flag (0: p, m1, m2, master and, through
                AdamW, the beta powers bit-unchanged; 1 and null: the same
                bits; fp32, bf16 and fp16 masters)
  3d. attention_variants — the additive-mask and dropout variants of the
                flash forward, dq and dk/dv at gpt3-1.3b's attention width
                ([4,16,1024,128] bf16; fp32 at [2,4,256,64]): key padding
                (causal or not), a per-head bf16 mask, a 3-D mask, dropout
                0.1, each against its plain version (the dropout keep-mask
                of the kernels, philox.cuh, against its plain twin bit for
                bit), run twice bit-equal; then driven through
                scaled_dot_product_attention (forward and backward) with
                the launch counts zeroed just before and read just after,
                mask plus dropout taking the plain reference (the JAX
                package's rule) with its mask gradient; timed beside the
                kernels without the variant and F.scaled_dot_product_attention;
                and the same in fp16 at cases a, b and e (the variants'
                fp16 instantiations: checks, two runs, the entry point's
                launches, timings)
  4. model    — gpt3-1.3b widths cut to 2 layers, fp32, on the card
                (kernels) against a CPU twin with the same weights (plain
                versions): the engine's unified steps (logits and tokens),
                the cached forward with adapters= (four rows on bank rows
                0-3 of three synthetic LoRA adapters; row 0 bit-equal to
                the unadapted forward),
                and, cut to 1 layer, twice 2 steps through ScanTrainStep,
                with AdamW and with the train recipe's optimizer and
                recompute (first-step gradient norms, losses, weights)
  4c. moe_model — ernie-moe-base widths cut to 2 layers (dense, MoE),
                fp32, 2 x 256 tokens, on the card against a CPU twin: the
                logits, the aux loss and every (token, rank)'s expert,
                slot and kept flag (a differing choice passes only between
                gates within MOE_MARGIN_TOL), then 2 AdamW steps held as
                in phase 4
  4d. optimizers — Adamax, Adagrad, RMSProp, Adadelta, DecayedAdagrad,
                Ftrl, Dpsgd, ProximalAdagrad and ProximalGD, 3 steps on
                the card against the CPU over 1 M-element leaves
  4e. resnet_model — resnet50 (1000 classes), training mode, 8 x 3 x 64 x
                64, TF32 off, on the card (cuDNN convolutions, BatchNorm
                and pools, fused Adam) against a CPU twin: a float64 and
                an fp32 forward and backward (logits, loss, every leaf's
                gradient norm, the running statistics), then 3 AdamW
                steps through ScanTrainStep, each from the CPU's state;
                and the bf16 BatchNorm at [64, 64, 56, 56] against fp32
                math on its bf16 inputs
  4f. vision_model — LeNet (8 x 1 x 28 x 28), vgg11(batch_norm=True)
                (8 x 3 x 32 x 32) and mobilenet_v1/v2 (8 x 3 x 64 x 64),
                1000 classes (LeNet 10), training mode, Dropout p 0, TF32
                off, on the card against CPU twins: a float64 forward and
                backward (logits, loss, every leaf's gradient norm, the
                running statistics), then 3 Adam steps through
                Model.train_batch each from the CPU's state; and a bf16
                depthwise convolution at mobilenet_v2's widest shapes
                ([64, 144, 56, 56], [64, 960, 7, 7]) within one bf16 ulp
                of fp32 math on its inputs
  4b. model_amp — the same widths cut to 1 layer in fp32 master weights
                through parallelize(model, opt, strategy=s) on the card
                against the CPU: AMP bf16 with recompute and gradient
                merge k = 2, AMP fp16 with dynamic loss scaling and a
                first step forced to overflow, and pure fp16 (amp.decorate
                O2,
                multi_precision) with that scaler, recompute and merge;
                loss scale, counters and merge count exactly equal, losses
                and weights (O2: the fp32 masters, and the fp16 parameters
                within an ulp more) within stated limits, O2 launching
                only fp16 instantiations
  5. serve    — full gpt3-1.3b, bf16, LLMEngine(num_slots=8, block_len=8,
                n_blocks=64, prefill_chunk=64, prefix cache off, as in the
                runs before it was ported) on a MonotonicClock via
                start(): 16 requests, prompts 32..400 tokens, 32 new tokens
                each; kernel launch counts are zeroed just before and read
                just after; 4 streams and their first-step logits are
                compared with generate()
  5e. serve_fp16 — the same cell with the model built in fp32 and cast by
                model.to(dtype=torch.float16): the fp16 LayerNorm and paged
                attention (tensor-core route, as the profiler names it)
                launched exactly (2 L + 1) and L times a step and no bf16
                one, phase 5's readings and its comparison with generate()
  5b. sampling — the sampling slice's arithmetic on the card against the
                port's CPU path at gpt3-1.3b's vocabulary: threefry lane
                keys, fold_in, split and random bits over [8, 50304] and
                [512, 50304] bit-equal (16 seed/index pairs, seeds up to
                2^31 - 1), gumbel noise within 2 ulps, and select_tokens
                over [8, 64, 50304] fp32 logits in every mode (greedy,
                temperature, top-k, top-p, both, constrained) giving the
                same tokens and DFA states
  5c. sample_serve — phase 5's cell with a mixed burst: greedy, seeded
                top-k and top-p, and JSON-schema-constrained requests (half
                greedy, half sampled, 64 new tokens, ending at EOS); greedy
                streams equal phase 5's bit for bit, top-k streams equal
                when resubmitted in reverse beside other batch-mates, four
                first tokens equal the CPU's select_tokens on the captured
                logits row, every constrained stream parses as the
                schema's JSON; tok/s, TTFT and decode step beside phase 5's,
                the selection's device time and ops a step (torch.profiler
                over 8 replayed selections), the host time a step of its
                operands, and 8 sampled steps replayed with greedy and
                with sampled selection
  5g. spec_serve — phase 5's cell with speculative decoding (spec_k 4):
                A, the target its own draft; B, full gpt3-125m (random
                weights of another seed) as the draft; C, phase 5c's mixed
                burst on A's engine; D, B with one request's draft
                poisoned (poison_request@6:draft). Every stream bit-equal
                to phase 5's (C: to 5c's); launches exactly what the
                target steps and draft forwards make, every paged launch
                on the tensor cores (the draft's D = 64 ones included);
                both pools balanced after each drain; C gives no
                constrained request a draft row; D quarantines exactly
                that request's draft and never charges the target. Reads
                decode iterations, acceptance, tok/s, TTFT and decode step
                beside phase 5's, and the draft phase's host ms a pump
                and its catch-up's and propose's device ms (8 replays each
                under torch.profiler)
  5h. frontend_serve — phase 5's cell behind the front end, five runs (the
                comment above phase_frontend_serve has them): A, a
                ServingServer over one engine, the 16 prompts and then 5c's
                mixed burst POSTed by 16 client threads at once (streams
                equal 5's and 5c's, tok/s and TTFT through HTTP); B, a
                RouterServer over two replicas, each engine on its own model
                (a fault-free burst, the fleet's tok/s on one card; then
                replica_crash@0 mid-decode: every request 200 with 5's
                stream, replica 0 quarantined, resumed streams = failover
                events = the responses' failovers, 4 or more); C, roles
                prefill and decode (16 handoffs, none failed, streams equal
                5's, export ms); D, a gpt3-1.3b of another seed published
                as a WeightSet and POSTed to /deploy while a burst runs
                (streams equal 5's, the fleet on v2, a burst after equal to
                a plain engine's on v2; publish, certify, load, drain,
                swap, canary times); E,
                the same set under deploy_bad_weights@1 (canary fails, every
                replica back on its prior tensors, a burst after equal to
                D's, one rollback in pdtpu_deploy_*); launches counted from
                A's first burst to E's last, every paged launch on the
                tensor cores
  5f. serve_observed — phase 5's cell with the serving observability
                armed (economics=True: the serving ledger and the SLO burn
                monitor; every request traced; two tenants, two SLO
                classes, a TTFT target): streams equal phase 5's, the
                ledger's phases tile its wall, per-owner device seconds
                sum to the compute phases, its tokens and positions are
                the engine's, decode MFU in (0, 1), the burn monitor's
                outcomes and fired classes equal a CPU twin's, render()
                parses with the twin's families, every timeline ordered;
                the ledger's decode_compute a step beside the profiler's
                busy ms; then batch_serve replays its trace once more with
                EngineConfig(economics=True): the same dispatches and
                logits, the ledger tiling its wall
  5d. prefix_serve — phase 5's model and engine with the prefix cache on
                and a 1 GiB host KV tier, pumped on one thread: a 256-token
                shared prefix (a donor, then 15 requests with suffixes of
                16..144 at once: each prefills len - 256, every stream equal
                bit for bit to a cold twin's, TTFT, tok/s and prefilled
                tokens beside it), an exact duplicate (one prefilled token,
                one COW), cache pressure until the prefix lives only in
                the host tier and its onboarding (the cold stream again),
                another tenant (no hit), and a stream handed off after its
                first token to a second engine (one prefilled token, the
                cold stream); the ledgers balanced after each part
  6. train    — full gpt3-1.3b, bf16, B=4, S=1024, AdamW (lr 1e-4, wd
                0.01, fp32 moments), one batch repeated: a ScanTrainStep
                chunk of 3 warm-up steps, then one of 10 timed steps with
                the launch counts zeroed just before and read just after;
                tokens/s, step time, MFU, peak memory, losses (finite and
                falling) and exactly the launches a step that
                TRAIN_KERNELS_PER_STEP states
  7. train_recipe — the same cell with bench.py's recipe for this model
                (recompute, bf16 moments) and GPT-3's optimizer settings
                (a warm-up into a cosine schedule, global-norm clip,
                weight decay 0.1 on all but biases and LayerNorms): the
                same readings, the lr vector each step used (equal to the
                scheduler's values on the host), RECIPE_KERNELS_PER_STEP
                launches a step, and a peak memory below the train phase's
  8. llama_model — llama2-7b widths cut to 2 layers, fp32, on the card
                against a CPU twin, as phase 4 with AdamW only (two lines:
                llama_model, llama_model_train), the same limits
  9. llama_serve — full llama2-7b, bf16, phase 5's engine and 16 requests:
                paged attention launched, no LayerNorm kernel (RMSNorm is
                plain torch), phase 5's checks, and the device-busy time of
                a step beside its wall time (is serving still host-bound?)
 10. llama_serve_gqa — llama2-70b's widths (64 query heads over 8 kv
                heads) cut to 4 of 80 layers, 8 of the same requests, the
                same checks: n_rep = 8 through the engine
 11. llama_train — full llama2-7b, bf16, B=1 x S=4096, the Llama 2 recipe
                (Touvron et al. 2023, sec. 2.2: AdamW 0.9/0.95, eps 1e-5, wd
                0.1 but norms, clip 1.0, warm-up into a cosine to peak/10
                at a 3e-4 peak) with recompute and bf16 moments: phase 7's
                readings and exactly LLAMA_KERNELS_PER_STEP launches a step
 12. train_amp — full gpt3-1.3b in fp32 master weights through
                parallelize(): AMP O1 bf16, whole-loss recompute, gradient
                merge k = 2 (avg), AdamW fp32 moments, clip 1.0, 4 x 1024,
                scan_steps 4: tokens/s, micro-step ms, MFU, peak memory,
                falling losses, exactly AMP_KERNELS_PER_MICRO_STEP a
                micro-step (fused Adam on applying micro-steps only), the
                LayerNorms fed fp32 and the attention bf16
 13. train_amp_fp16 — the same in fp16 with dynamic loss scaling (init
                32768), fewer timed steps: the fp16 flash kernels
                launched, the skipped micro-steps and the final scale
 13b. train_fp16_o2 — the same cell in Paddle's pure-fp16 recipe:
                amp.decorate(level="O2", dtype="float16"), AdamW(
                multi_precision=True), the same strategy in fp16: exactly
                the fp16 instantiations a micro-step (LayerNorm 98/49,
                flash 48/24/24, fused Adam 293 on applying micro-steps),
                none in fp32 or bf16; tokens/s, micro-step ms, MFU, peak
                memory, finite losses, skipped micro-steps, final scale
 14. moe_train — full ernie-moe-base (12 layers, 6 of them MoE with 8
                experts, top-2, capacity factor 1.25), bf16, B=8, S=1024,
                AdamW (lr 1e-4, wd 0.01, fp32 moments), as bench.py trains
                BASELINE config 5: phase 6's readings with the MFU counted
                on active parameters, each MoE layer's share of dropped
                (token, rank) pairs, and exactly MOE_KERNELS_PER_STEP
                launches a step
 15. resnet_train — full resnet50 (1000 classes) as bench.py trains
                BASELINE config 1: paddle_tpu_torch.flops at [1, 3, 224,
                224] first (its exact MAC count printed), then the model
                and 64 x 3 x 224 x 224 images in bf16, CrossEntropyLoss,
                AdamW (lr 1e-4, wd 0.01, fp32 moments), one batch
                repeated, 3 warm-up and 10 timed steps: images/s, step ms,
                MFU = conv_train_flops_per_step / step time / 989 TFLOP/s,
                peak memory, falling losses, every running statistic
                finite and moved, and exactly RESNET50_LEAVES fused-Adam
                launches a step (no other port kernel)
 16. mobilenet_fit — full mobilenet_v2 (scale 1.0, 1000 classes), fp32,
                TF32 off, through Model(net).prepare(Adam(1e-3),
                CrossEntropyLoss(), Accuracy(topk=(1, 5))).fit over 512
                seeded 224 x 224 x 3 uint8 images (ToTensor, Normalize),
                batch 64, eval on 128 more, a ModelCheckpoint an epoch:
                two fits of one epoch, num_workers 0 then 4. Images/s an
                epoch (loading included), train_batch ms (CUDA events),
                MFU = 6 x forward MACs x 64 / step / 67 TFLOP/s, the host
                ms of the step's two syncs (metric, loss.item()), device
                busy over wall (torch.profiler, 4 train_batch calls fed by
                each loader), peak memory, the second epoch's mean loss
                below the first's, evaluate's top-1/top-5, exactly
                MOBILENET_V2_LEAVES fused-Adam launches a step (no other
                port kernel), and the last checkpoint loaded into a fresh
                model giving bit-equal eval logits and equal Adam slots
 17. resilient_train — full gpt3-125m (12 layers, 768 wide), bf16, 8 x
                1024, AdamW 1e-4 fp32 moments, ScanTrainStep(scan_steps=2),
                10 steps over 10 seeded batches, under
                ResilientTrainer(goodput=True):
                a baseline (only the end-of-run save: step ms), a sync
                CheckpointManager at save_interval 8 (save ms), an
                AsyncCheckpointManager at save_interval 2, max_to_keep 2
                with raise@5 (a retry) and nan_loss@9 (a rollback served
                from the ring), and a child process killed by SIGKILL in
                the writer (kill@6:persist) then resumed by a second one
                after the scrubber: losses and final parameters and
                moments bit-equal to the sync run's, restores keeping
                every tensor's storage, exactly RESILIENT_KERNELS_PER_STEP
                launches a step; snapshot blocking ms and GB/s, persist
                ms, lag and drops, ring rollback against disk restore ms,
                goodput, live MFU and phase shares of each run, the
                resumed child's time from resume to its first step, each
                line with the card's name and power limit
 18. train_numerics — phase 17's cell with the step built armed, under
                ResilientTrainer(numerics=True, numerics_interval=2): 12
                steps, a NaN written into 3,000,000 elements of the token
                table after the chunk of steps 6-7 and that step's loss
                read as NaN (nan_loss@6): the blame probe (flash and
                LayerNorm kernels, no fused Adam) must count exactly those
                elements, the train_nonfinite event name the leaf, the
                trainer roll back and finish; the telemetry of step 4
                against an fp64 recomputation; /debug/numerics; step ms
                and peak memory armed and not, the probe's and a sample
                read's ms
 19. lora_finetune — the train cell (full gpt3-1.3b, bf16, 4 x 1024, one
                batch repeated) with inject_lora(LoRAConfig(rank 8, alpha
                16)): 192 fp32 adapter leaves (6,291,456 parameters),
                AdamW 1e-3 with clip 1.0 through ScanTrainStep, 2 warm-up
                and 6 timed steps with the launch counts zeroed just
                before and read just after (exactly LORA_KERNELS_PER_STEP),
                then 2 with the numerics telemetry armed; falling losses,
                every base parameter bit-equal after, the optimizer's
                state only the adapter leaves; tokens/s, step ms, MFU (4
                N_base + 6 N_lora FLOPs a token), peak memory beside
                train's; the adapter tree published as a certified
                AdapterWeightSet under build/
 20. lora_serve — serve's model and 16 prompts with
                LLMEngine(max_adapters=3, lora_rank=8): 4 base streams and
                4 on each of three synthetic adapters (sigma 0.02); bursts
                unarmed, armed, armed, unarmed: the base streams equal
                serve's, every adapter moves a token, the armed turns
                equal; the bank's rows permuted: the same 16 streams; the
                step's LoRA device ms, kernel launches and ATen ops beside
                the unarmed step's (torch.profiler, 8 replayed steps), the
                ops and the kernels by name (copies and fills apart)
                unchanged across a hot swap and an unload; each adapter's
                first stream decoded solo, recorded as equal to the
                burst's or not with the first op that differs; the
                fine-tuned adapter certified against the bank, registered
                and decoded, a rank-16 one refused (typed); prefix
                namespaces and the scoped flush of a hot swap, the canary,
                and the ledger's adapter seconds summing to its tenants'
                on a third engine; the adapter token counters partitioning
                the emitted tokens
 21. multirank_train — multi-rank training at one GPU: ranks started as
                `chip_smoke.py --rank-child RUN RANK WORLD WORKDIR`
                processes after the build (each loads the built library),
                all on cuda:0 over gloo, through fleet.init(strategy) and
                parallelize; the weights are the port's seeded model,
                exported once and sharded by bridge.shard_state. A: full
                gpt3-1.3b, bf16, AdamW fp32 moments, 4 x 1024, mp_degree 2
                over 2 ranks, 3 steps; B: the same at sharding_degree 2,
                ZeRO stage 2, 2 x 1024 a rank (each rank's moment bytes
                half the one-rank step's, but leaves under min_numel);
                C: gpt3-1.3b's widths cut to 2 layers, fp32, dp2 x mp2
                over 4 ranks, SGD under a global-norm clip that binds, each
                leaf's change over the steps against the one-rank step's
                (MULTIRANK_UPDATE_TOL); each run's
                losses against the one-rank step on the card from the same
                weights and global batch (MULTIRANK_BF16_TOL,
                MULTIRANK_FP32_TOL), each rank's step ms, tokens/s, peak
                memory and collective bytes a step, and the collectives'
                seconds in the last step; rank 0 of A counts the launches
                of kernels 1, 3-7 (the kernels line's `multirank_train`);
                D: a one-rank NCCL group, every collective giving the
                one-rank result
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from functools import partial

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12,    # dense tensor-core rate
            "float16": 989e12,     # the same rate in fp16
            "float32": 67e12}      # fp32 outside the tensor cores
L2_COPIES = 4   # distinct input copies cycled where the caller finds its
#                 inputs cold: four sets of paged-attention slabs exceed
#                 the H100's 50 MB L2


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def time_cuda(fns, reps=21, per_rep=10, warmup=3):
    """(device_ms, call_ms) of one call, each the median of `reps` samples
    taken with CUDA events after `warmup` calls.

    `fns` holds equivalent calls on distinct copies of the inputs, cycled
    call by call, so that a call finds its inputs out of L2 where the real
    caller would (one entry: the inputs stay warm). device_ms: a spin
    kernel (`torch.cuda._sleep`) holds the stream while the host enqueues
    `per_rep` calls between two events, so a sample is back-to-back device
    work divided by `per_rep`; the spin lasts twice the measured enqueue
    time. call_ms: one call between two events with the host's launch cost
    included — what a call costs its caller."""
    import torch
    calls = [0]

    def call():
        fns[calls[0] % len(fns)]()
        calls[0] += 1

    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(per_rep):
        call()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    device, host = [], []
    for _ in range(reps):
        # 2e6 cycles per ms is at or above the H100's top SM clock
        torch.cuda._sleep(int(2 * enqueue_ms * 2.0e6))
        a.record()
        for _ in range(per_rep):
            call()
        b.record()
        b.synchronize()
        device.append(a.elapsed_time(b) / per_rep)
        a.record()
        call()
        b.record()
        b.synchronize()
        host.append(a.elapsed_time(b))
    return statistics.median(device), statistics.median(host)


def bound_ms(n_bytes, n_ops, dtype_name):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ulp_bf16(x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    import torch
    a = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def ulp_fp16(x):
    """One fp16 unit in the last place at |x| (11 significant bits; the
    subnormal spacing, 2^-24, below 2^-14)."""
    import torch
    a = x.float().abs().clamp_min(2.0 ** -14)
    return torch.exp2(torch.floor(torch.log2(a)) - 10)


# ---------------------------------------------------------------- phase 1
def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0].strip()
    emit({"phase": "device", "kind": name, "count": count,
          "nvidia_smi": smi_line,
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return name, count, smi_line


# ---------------------------------------------------------------- phase 2
# the kernels that must run on the tensor cores, each with the instructions
# that show it in its machine code: warpgroup products (wgmma's HGMMA) or
# warp products (mma.sync's HMMA)
TENSOR_CORE_KERNELS = {"flash_fwd_kernel_tc": ("HGMMA",),
                       "flash_bwd_dq_kernel_tc": ("HGMMA",),
                       "flash_bwd_dkv_kernel_tc": ("HGMMA",),
                       "paged_attention_kernel_tc": ("HMMA", "HGMMA")}
# the fp16 instantiations of each (pure-fp16 training and fp16 serving)
TENSOR_CORE_FP16 = {"flash_fwd_kernel_tc": 6, "flash_bwd_dq_kernel_tc": 6,
                    "flash_bwd_dkv_kernel_tc": 6,
                    "paged_attention_kernel_tc": 16}


def tensor_core_instructions(sass, name, opcodes):
    """{symbol: counts} of the functions of `name` in a
    sass_instruction_counts() result; empty unless every one of them holds
    one of `opcodes`."""
    found = {k: c for k, c in sass.items() if name in k}
    if all(sum(c[op] for op in opcodes) > 0 for c in found.values()):
        return found
    return {}


def phase_build():
    from paddle_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    _kernels.load_library()
    seconds = time.perf_counter() - t0
    sass = _kernels.sass_instruction_counts()
    stats = _kernels.ptxas_kernel_stats(_kernels.ptxas_report)
    tensor_core, resources = {}, {}
    for name, opcodes in TENSOR_CORE_KERNELS.items():
        found = tensor_core_instructions(sass, name, opcodes)
        check(found, f"{name}: no {' or '.join(opcodes)} instruction in its "
                     f"machine code ({sass})")
        # the fp16 instantiations are among them: every flash kernel's
        # head dim 64/128 x plain, mask, dropout, the paged kernel's head
        # dim 64/128 x block_len 8..64
        fp16 = [k for k in found if MANGLED_16BIT["float16"] in k]
        check(len(fp16) == TENSOR_CORE_FP16[name],
              f"{name}: {len(fp16)} fp16 instantiations on the tensor "
              f"cores, want {TENSOR_CORE_FP16[name]}: {sorted(found)}")
        tensor_core[name] = list(found.values())
        if not _kernels.ptxas_report:
            continue     # loaded from an earlier build: no report to read
        mine = {k: v for k, v in stats.items() if name in k}
        check(mine, f"{name}: not in ptxas's report")
        spills = {k: v for k, v in mine.items()
                  if v["spill_stores"] or v["spill_loads"]}
        check(not spills, f"{name}: ptxas spills registers: {spills}")
        # every instantiation (the flash kernels': head dim 64/128 x plain,
        # mask, dropout) with its registers and HGMMA/HMMA count
        resources[name] = {k: dict(registers=v["registers"],
                                   spill_stores=v["spill_stores"],
                                   **found.get(k, {}))
                           for k, v in mine.items()}
    # ptxas's notes that it serialised a kernel's wgmmas (C7510-C7519):
    # reported, they cost the products their overlap
    serialized = sorted({line.split("function '")[1].split("'")[0]
                         for line in _kernels.ptxas_report.splitlines()
                         if "(C751" in line and "function '" in line})
    emit({"phase": "build", "seconds": seconds,
          "wgmma_serialized": serialized,
          "nvcc_seconds": _kernels.build_seconds,
          "sources": [f"paddle_tpu_torch/csrc/{s}" for s in _kernels.SOURCES],
          "tensor_core_instructions": tensor_core,
          "tensor_core_registers": resources or None,
          "layernorm": layernorm_build_checks(_kernels, stats),
          "ptxas": _kernels.ptxas_report or None})


# the LayerNorm kernels' 16-byte accesses, as cuobjdump names them
WIDE_OPCODES = ("LDG.E.128", "STG.E.128")


# the 16-bit types' names as they follow the kernel's in a mangled symbol
MANGLED_16BIT = {"bfloat16": "13__nv_bfloat16", "float16": "6__half"}


def layernorm_build_checks(_kernels, stats):
    """Every bf16 and fp16 LayerNorm instantiation on the 16-byte path (the
    forward's and the backward's first pass, `kWide` true: `Lb1E` right
    after the type in the mangled name; one a table entry of
    ops/layernorm.py) holds LDG.E.128 and STG.E.128 in its machine code,
    and no LayerNorm kernel spills."""
    import torch
    from paddle_tpu_torch.ops import layernorm as ln
    sass = _kernels.sass_instruction_counts(WIDE_OPCODES)
    wide = {}
    for dname, mangled in MANGLED_16BIT.items():
        dtype = getattr(torch, dname)
        wide_re = re.compile(rf"layernorm_(fwd|bwd)_kernelI{mangled}Lb1E")
        found = {k: c for k, c in sass.items() if wide_re.search(k)}
        want = len(ln.FWD_BUCKETS[dtype]) + len(ln.BWD_BUCKETS[dtype])
        check(len(found) == want and all(all(c[op] for op in WIDE_OPCODES)
                                         for c in found.values()),
              f"{dname} LayerNorm kernels on the 16-byte path: {len(found)} "
              f"of {want} found with {' and '.join(WIDE_OPCODES)}: {found}; "
              f"every LayerNorm function's counts: "
              f"{ {k: c for k, c in sass.items() if 'layernorm' in k} }")
        wide.update(found)
    mine = {k: v for k, v in stats.items() if "layernorm" in k}
    if _kernels.ptxas_report:
        check(mine, "no LayerNorm kernel in ptxas's report")
        spills = {k: v for k, v in mine.items()
                  if v["spill_stores"] or v["spill_loads"]}
        check(not spills, f"LayerNorm kernels spill registers: {spills}")
    return {"wide_16bit": {k: dict(c, registers=mine.get(k, {}).get(
                "registers")) for k, c in wide.items()},
            "registers": {k: v["registers"] for k, v in mine.items()},
            "spills": 0 if _kernels.ptxas_report else None}


# ---------------------------------------------------------------- phase 3
def _paged_case(torch, gen, *, dtype, H, Hkv, D, B=8, Tq=64, block_len=8,
                n_blocks=64, pad=64, lens=None, decode_rows=()):
    """Inputs shaped like the engine's unified step over its pool: slabs
    [B, Hkv, n_blocks*block_len + pad, D], a shuffled (non-identity) page
    table with -1 pads past each row's length, ragged lengths, prefill rows
    at q_pos = len - Tq and decode rows at q_pos = len - 1."""
    dev = "cuda"
    L = n_blocks * block_len + pad
    k = torch.randn(B, Hkv, L, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Hkv, L, D, generator=gen, device=dev).to(dtype)
    q = torch.randn(B, H, Tq, D, generator=gen, device=dev).to(dtype)
    cap = n_blocks * block_len
    if lens is None:
        lens = torch.randint(1, cap + 1, (B,), generator=gen,
                             device=dev).tolist()
    perm = torch.randperm(B * n_blocks, generator=gen, device=dev)
    table = perm.reshape(B, n_blocks).to(torch.int32)
    for b, n in enumerate(lens):
        table[b, -(-n // block_len):] = -1
    q_pos = [max(n - 1, 0) if b in decode_rows else max(n - Tq, 0)
             for b, n in enumerate(lens)]
    i32 = dict(dtype=torch.int32, device=dev)
    return dict(q=q, k=k, v=v, table=table,
                lens=torch.tensor(lens, **i32),
                q_pos=torch.tensor(q_pos, **i32),
                block_len=block_len, pages_per_row=n_blocks)


SHARED_PAGES = 32     # the shared_pages case: a 256-token prefix of 8-wide
SHARED_SUFFIXES = (64, 16, 144, 1, 100, 33, 64, 120)   # pages, each row's


def shared_pages_cases(torch, gen, H=16, D=128, Tq=64, block_len=8,
                       n_blocks=64, pad=64, decode_rows=(3,)):
    """The prefix cache's layout for the paged kernel, at the serve cell's
    shapes: (shared, private). In `shared`, all 8 rows' tables point at
    the same SHARED_PAGES pages of row 0 and then at their own pages past
    them; in `private`, each row holds a copy of those pages in its own
    row and reads it through the identity table. Same queries, same
    lengths (256 + SHARED_SUFFIXES), so the outputs must be bit-equal."""
    B = len(SHARED_SUFFIXES)
    dev = "cuda"
    L = n_blocks * block_len + pad
    k = torch.randn(B, H, L, D, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, H, L, D, generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn(B, H, Tq, D, generator=gen,
                    device=dev).to(torch.bfloat16)
    n_sh = SHARED_PAGES * block_len
    lens = [n_sh + n for n in SHARED_SUFFIXES]
    shared = torch.full((B, n_blocks), -1, dtype=torch.int32)
    ident = torch.full((B, n_blocks), -1, dtype=torch.int32)
    for b, n in enumerate(lens):
        used = -(-n // block_len)
        own = torch.arange(used, dtype=torch.int32) + b * n_blocks
        ident[b, :used] = own
        shared[b, :used] = own
        shared[b, :SHARED_PAGES] = torch.arange(SHARED_PAGES)
    kp, vp = k.clone(), v.clone()
    kp[:, :, :n_sh] = k[:1, :, :n_sh]
    vp[:, :, :n_sh] = v[:1, :, :n_sh]
    i32 = dict(dtype=torch.int32, device=dev)
    q_pos = torch.tensor([n - 1 if b in decode_rows else n - Tq
                          for b, n in enumerate(lens)], **i32)
    common = dict(q=q, lens=torch.tensor(lens, **i32), q_pos=q_pos,
                  block_len=block_len, pages_per_row=n_blocks)
    return (dict(common, k=k, v=v, table=shared.to(dev)),
            dict(common, k=kp, v=vp, table=ident.to(dev)))


def _paged_bytes_ops(c):
    """Bytes the function must move and the operations it must do.

    Bytes: q read and out written once; K and V of each row's first
    seq_len columns once per kv head; the table entries of the occupied
    blocks, the lengths and the positions. Operations: QK and PV, two per
    multiply-add, over the columns each query row sees,
    min(seq_len, q_pos + t + 1)."""
    q, k = c["q"], c["k"]
    B, H, Tq, D = q.shape
    Hkv = k.shape[1]
    el = q.element_size()
    bl = c["block_len"]
    lens = c["lens"].tolist()
    kv_bytes = sum(lens) * Hkv * D * 2 * el
    side = (sum(-(-n // bl) for n in lens) + 2 * B) * 4
    n_bytes = 2 * q.numel() * el + kv_bytes + side
    seen = sum(min(n, p + t + 1) for n, p in zip(lens, c["q_pos"].tolist())
               for t in range(Tq))
    n_ops = 4 * H * D * seen
    return n_bytes, n_ops


def _sdpa_inputs(torch, c):
    """The library yardstick's inputs: each row's pages gathered into a
    contiguous [B, H, S, D] cache (GQA heads repeated) and the ragged causal
    mask as a boolean [B, 1, Tq, S]. Built once, outside the timing."""
    from paddle_tpu_torch.ops.paged_attention import _gather_block
    q, k, v, table = c["q"], c["k"], c["v"], c["table"]
    B, H, Tq, D = q.shape
    n_rep = H // k.shape[1]
    bl, ppr = c["block_len"], c["pages_per_row"]
    idx = table.long().clamp_min(0)
    ks = torch.cat([_gather_block(k, idx[:, j], bl, ppr)
                    for j in range(table.shape[1])], dim=2)
    vs = torch.cat([_gather_block(v, idx[:, j], bl, ppr)
                    for j in range(table.shape[1])], dim=2)
    ks = ks.repeat_interleave(n_rep, dim=1).contiguous()
    vs = vs.repeat_interleave(n_rep, dim=1).contiguous()
    S = ks.shape[2]
    col = torch.arange(S, device=q.device)
    row = c["q_pos"].long()[:, None] + torch.arange(Tq, device=q.device)
    mask = ((col[None, None, :] <= row[:, :, None])
            & (col[None, None, :] < c["lens"].long()[:, None, None]))
    return q, ks, vs, mask[:, None]


# bf16 paged attention, kernel against plain version. Both round one fp32
# output to bf16 after sums taken in another order, so nearly every element
# agrees within one bf16 ulp of the output. Both also round p to bf16
# before PV: where the two sides' fp32 p of one column straddle a rounding
# boundary, that p moves by one ulp of p (at most 2^-8) and the output by
# that times |v| / l, which rows with few visible columns feel most; such
# columns are rare. The readings on the H100 (PERF.md) put one element in
# a million past one ulp, by 4e-9. The limits: every element within
# BF16_PA_ULPS ulps + BF16_PA_ATOL, room for a p flip in a short row, and
# at most BF16_PA_SHARE of the elements more than one ulp apart. A side
# that skipped the p rounding would move nearly every output by a
# fraction of an ulp of p, and fail the share.
BF16_PA_ULPS = 2
BF16_PA_ATOL = 1e-3
BF16_PA_SHARE = 1e-3
# fp16 paged attention (fp16 serving): the bf16 rule scaled by the ulp,
# 2^-11 against 2^-8. One ulp of the output is 2^-3 of bf16's, and the
# ulp count stays. How often the two sides' fp32 values (of p, and of the
# output) straddle a rounding boundary is their fp32 difference over the
# spacing of the rounded values, 2^3 times bf16's for the same
# difference: the share grows by 2^3. A p that lands on the other side of
# an fp16 boundary moves its output by 2^-11 p |v| / l, and with 2^3 as
# many flips the rare large ones come 2^3 times as often too: the atol is
# the move of one flip where p |v| / l reaches 1, 2^-11 (bf16's 1e-3
# scaled by 2^-3, 1.25e-4, was measured too small: the CUDA test's GQA
# prefill at served lengths put an element 1.5e-4 past two ulps, and the
# plain fp16 version is itself 1.2e-4 past two ulps from fp32 arithmetic
# on the same inputs there). A side that skipped the p rounding would
# move most outputs by a fraction of an ulp of p (half an output ulp,
# typically), far past the share: fp16_paged_kernels reads that control
# (the plain version in fp32, its output rounded once) at each of its
# shapes and fails unless the control breaks the rule (PERF.md row 2h has
# its readings).
FP16_PA_ULPS = BF16_PA_ULPS
FP16_PA_ATOL = 2.0 ** -11
FP16_PA_SHARE = BF16_PA_SHARE * 2.0 ** 3


def half_readings(torch, out, ref, ulp_of, n_ulps):
    """The readings the *_PA_* rules hold: the largest difference, its
    largest excess over one and over `n_ulps` ulps of the output, and the
    share of elements more than one ulp apart."""
    err = (out.float() - ref.float()).abs()
    ulp = ulp_of(torch.maximum(out.float().abs(), ref.float().abs()))
    return dict(max_abs_err=float(err.max()),
                max_excess_over_1ulp=float((err - ulp).max()),
                max_excess_over_2ulp=float((err - n_ulps * ulp).max()),
                share_over_1ulp=float((err > ulp).float().mean()))


def check_paged(torch, c, label, tol=None):
    """Kernel against plain version on the case `c`. bf16 takes the limits
    above, fp16 the FP16_PA_* ones; fp32 takes atol = rtol = `tol`.
    Returns (readings, args)."""
    from paddle_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                      paged_attention_plain)
    scale = 1.0 / math.sqrt(c["q"].shape[-1])
    args = (c["q"], c["k"], c["v"], c["table"], c["lens"], c["q_pos"],
            c["block_len"], c["pages_per_row"], scale)
    out = paged_attention_cuda(*args)
    ref = paged_attention_plain(*args)
    torch.cuda.synchronize()
    check(torch.isfinite(out.float()).all().item(),
          f"paged attention {label}: non-finite output")
    err = (out.float() - ref.float()).abs()
    worst = float(err.max())
    if c["q"].dtype in (torch.bfloat16, torch.float16):
        half = c["q"].dtype == torch.float16
        ulp_of, n_ulps, atol, share, name = (
            (ulp_fp16, FP16_PA_ULPS, FP16_PA_ATOL, FP16_PA_SHARE, "fp16")
            if half else
            (ulp_bf16, BF16_PA_ULPS, BF16_PA_ATOL, BF16_PA_SHARE, "bf16"))
        readings = half_readings(torch, out, ref, ulp_of, n_ulps)
        check(readings["max_excess_over_2ulp"] <= atol,
              f"paged attention {label}: an element is "
              f"{readings['max_excess_over_2ulp']} past {n_ulps} {name} "
              f"ulps, limit {atol}")
        check(readings["share_over_1ulp"] <= share,
              f"paged attention {label}: {readings['share_over_1ulp']} of "
              f"the elements are more than one {name} ulp apart, limit "
              f"{share}")
    else:
        readings = dict(max_abs_err=worst)
        check(bool((err <= tol + tol * ref.float().abs()).all()),
              f"paged attention {label}: max |kernel - plain| = {worst} "
              f"exceeds atol = rtol = {tol}")
    return readings, args


def check_layernorm(torch, x, w, b, label, bf16_ulp=False, atol=1e-5):
    from paddle_tpu_torch.ops.layernorm import (layer_norm_fwd_cuda,
                                                layer_norm_fwd_plain)
    y, mu, rstd = layer_norm_fwd_cuda(x, w, b, 1e-5)
    y_ref, mu_ref, rstd_ref = layer_norm_fwd_plain(x, w, b, 1e-5)
    torch.cuda.synchronize()
    check(torch.isfinite(y.float()).all().item(),
          f"layernorm {label}: non-finite output")
    err = (y.float() - y_ref.float()).abs()
    worst = float(err.max())
    if bf16_ulp:
        # both round an fp32 value to bf16 once; the fp32 values differ by
        # sum order in mean/variance, so near a rounding midpoint they land
        # one bf16 ulp apart, and near y = 0 (x_hat*w cancelling b) the
        # fp32 difference itself, ~1e-6, survives: 1 ulp + 1e-5
        big = torch.maximum(y.float().abs(), y_ref.float().abs())
        ok = bool((err <= ulp_bf16(big) + 1e-5).all())
        what = "one bf16 ulp of the output + 1e-5"
    else:
        ok = bool((err <= atol + atol * y_ref.float().abs()).all())
        what = f"atol/rtol {atol}"
    check(ok, f"layernorm {label}: max |kernel - plain| = {worst} exceeds "
              f"{what}")
    stat_err = max(float((mu - mu_ref).abs().max()),
                   float(((rstd - rstd_ref) / rstd_ref).abs().max()))
    check(stat_err <= 1e-5, f"layernorm {label}: mean/rstd differ by "
                            f"{stat_err}")
    return worst


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                      paged_attention_plain,
                                                      paged_route)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    results = {}

    # ---- paged attention at the served path's shapes: gpt3-1.3b heads
    # (H=16, D=128), 8 slots, 64-wide rows, block_len 8, lengths up to 512
    lens = [512, 37, 200, 1, 448, 64, 300, 129]
    decode_rows = (1, 3, 6)
    cases = {}
    bf = _paged_case(torch, gen, dtype=torch.bfloat16, H=16, Hkv=16, D=128,
                     lens=lens, decode_rows=decode_rows)
    cases["bf16"], args_bf = check_paged(torch, bf, "bf16 H16 D128")
    # fp32: same op sequence, sums in another order: 1e-5
    f32 = _paged_case(torch, gen, dtype=torch.float32, H=16, Hkv=16, D=128,
                      lens=lens, decode_rows=decode_rows)
    cases["fp32"] = check_paged(torch, f32, "fp32 H16 D128", 1e-5)[0]
    # GQA (4 query heads per kv head), bf16 and fp32
    gqa = _paged_case(torch, gen, dtype=torch.bfloat16, H=16, Hkv=4, D=128,
                      lens=lens, decode_rows=decode_rows)
    cases["gqa_bf16"] = check_paged(torch, gqa, "GQA bf16")[0]
    gqa32 = _paged_case(torch, gen, dtype=torch.float32, H=8, Hkv=2, D=64,
                        B=3, Tq=5, block_len=32, n_blocks=6, pad=8)
    cases["gqa_fp32_d64_bl32"] = check_paged(torch, gqa32,
                                             "GQA fp32 D64 bl32", 1e-5)[0]
    odd = _paged_case(torch, gen, dtype=torch.float32, H=2, Hkv=2, D=128,
                      B=2, Tq=1, block_len=16, n_blocks=3, pad=0,
                      lens=[48, 17], decode_rows=(0, 1))
    cases["decode_fp32_bl16"] = check_paged(torch, odd, "decode fp32 bl16",
                                            1e-5)[0]
    # bf16 at the other block lengths: every tensor-core instantiation the
    # tests reach (block_len 16, 24, 64; D 64; Tq past one 64-row tile;
    # decode rows) and block_len 12, which the route sends to the scalar
    # kernel; lengths of the served kind
    for label, kw in {
            "bf16_gqa_d64_bl16": dict(H=8, Hkv=2, D=64, B=3, Tq=90,
                                      block_len=16, n_blocks=12, pad=8,
                                      lens=[192, 100, 150],
                                      decode_rows=(1,)),
            "bf16_bl24": dict(H=4, Hkv=4, D=128, B=3, Tq=33, block_len=24,
                              n_blocks=9, pad=0, lens=[216, 80, 130],
                              decode_rows=(1,)),
            "bf16_gqa_bl64_decode": dict(H=8, Hkv=1, D=128, B=2, Tq=1,
                                         block_len=64, n_blocks=5, pad=0,
                                         lens=[320, 77], decode_rows=(0, 1)),
            "bf16_bl12_scalar": dict(H=4, Hkv=2, D=128, B=3, Tq=20,
                                     block_len=12, n_blocks=10, pad=4,
                                     lens=[120, 45, 90])
            }.items():
        c = _paged_case(torch, gen, dtype=torch.bfloat16, **kw)
        cases[label] = check_paged(torch, c, label)[0]
        cases[label]["route"] = paged_route(torch.bfloat16, kw["block_len"],
                                            kw["D"])
    # the Llama serve cells' layouts behind the same engine: llama2-7b's
    # heads (H = Hkv = 32) and llama2-70b's grouped-query heads (64 over 8:
    # 512 rows a kv group at Tq = 64, 8 at Tq = 1); a generator of their
    # own leaves the other cases' inputs as they were
    lgen = torch.Generator(device="cuda")
    lgen.manual_seed(SEED + 8)
    llama = {}
    for label, kw in {
            "bf16_llama2_7b": dict(H=32, Hkv=32, decode_rows=decode_rows),
            "bf16_llama2_70b_gqa": dict(H=64, Hkv=8,
                                        decode_rows=decode_rows),
            "bf16_llama2_70b_gqa_decode": dict(
                H=64, Hkv=8, Tq=1, decode_rows=tuple(range(8)))}.items():
        llama[label] = _paged_case(torch, lgen, dtype=torch.bfloat16, D=128,
                                   lens=lens, **kw)
        cases[label] = check_paged(torch, llama[label], label)[0]
    # a row's sums run in one fixed order: two runs are bit-equal
    for label, c in (("bf16 H16 D128", bf), ("GQA bf16", gqa)):
        a = (c["q"], c["k"], c["v"], c["table"], c["lens"], c["q_pos"],
             c["block_len"], c["pages_per_row"], 1.0 / math.sqrt(128))
        runs = [paged_attention_cuda(*a) for _ in range(2)]
        torch.cuda.synchronize()
        check(torch.equal(*runs), f"paged attention {label}: two runs differ")
    emit({"phase": "kernel_checks", "name": "paged_attention_bitwise",
          "runs": 2, "equal": ["bf16 H16 D128", "GQA bf16"]})
    # the prefix cache's layout: 8 rows reading one row's 32 pages, held
    # bit-equal to the same rows reading private copies, and timed beside
    # that identity layout (one input copy each: the shared pages stay in
    # L2 for the rows after the first, which is the layout's point)
    sh, priv = shared_pages_cases(torch, gen)
    cases["shared_pages"] = check_paged(torch, sh, "shared pages")[0]
    a_sh = (sh["q"], sh["k"], sh["v"], sh["table"], sh["lens"],
            sh["q_pos"], 8, 64, 1.0 / math.sqrt(128))
    a_pr = (priv["q"], priv["k"], priv["v"], priv["table"], priv["lens"],
            priv["q_pos"], 8, 64, 1.0 / math.sqrt(128))
    sh_equal = torch.equal(paged_attention_cuda(*a_sh),
                           paged_attention_cuda(*a_pr))
    sh_ms, _ = time_cuda([partial(paged_attention_cuda, *a_sh)])
    pr_ms, _ = time_cuda([partial(paged_attention_cuda, *a_pr)])
    shared_pages = dict(
        equal_to_private_copies=sh_equal, ms=sh_ms, identity_ms=pr_ms,
        shape=dict(B=8, H=16, Tq=64, D=128, block_len=8,
                   shared_pages=SHARED_PAGES,
                   seq_lens=sh["lens"].tolist()))
    del sh, priv, a_sh, a_pr
    check(sh_equal, "paged attention over shared pages differs from the "
                    "same rows over private copies")

    # each layer of a served step reads its own slabs, which the layers
    # before it have pushed out of L2: every timing cycles input copies
    q, ks, vs, mask = _sdpa_inputs(torch, bf)
    scale = 1.0 / math.sqrt(128)
    slabs = [args_bf[1:3]] + [(args_bf[1].clone(), args_bf[2].clone())
                              for _ in range(L2_COPIES - 1)]
    pa_ms, pa_call_ms = time_cuda([
        partial(paged_attention_cuda, args_bf[0], k, v, *args_bf[3:])
        for k, v in slabs])
    # the plain version is ~1000 small launches a call: one call a sample
    pa_plain_ms, _ = time_cuda([
        partial(paged_attention_plain, args_bf[0], k, v, *args_bf[3:])
        for k, v in slabs], per_rep=1, warmup=1)
    lib_kv = [(ks, vs)] + [(ks.clone(), vs.clone())
                           for _ in range(L2_COPIES - 1)]
    pa_lib_ms, _ = time_cuda([
        partial(F.scaled_dot_product_attention, q, k, v, attn_mask=mask,
                scale=scale) for k, v in lib_kv])
    del slabs, lib_kv
    at_llama = {}
    for label in ("bf16_llama2_7b", "bf16_llama2_70b_gqa"):
        c = llama[label]
        a = (c["q"], c["k"], c["v"], c["table"], c["lens"], c["q_pos"],
             c["block_len"], c["pages_per_row"], scale)
        ms, _ = time_cuda([partial(paged_attention_cuda, *a)])
        lq, lk, lv, lm = _sdpa_inputs(torch, c)
        lib_ms, _ = time_cuda([partial(F.scaled_dot_product_attention, lq,
                                       lk, lv, attn_mask=lm, scale=scale)])
        n_bytes, n_ops = _paged_bytes_ops(c)
        bound, by = bound_ms(n_bytes, n_ops, "bfloat16")
        at_llama[label] = dict(
            ms=ms, library_ms=lib_ms, bound_ms=bound, bound_by=by,
            tflops=n_ops / ms / 1e9, share_of_bound=bound / ms,
            shape=dict(B=8, H=c["q"].shape[1], Hkv=c["k"].shape[1], Tq=64,
                       D=128, block_len=8, seq_lens=lens))
        del lq, lk, lv, lm
    del llama
    # the speculative draft's shape (gpt3-125m: H = Hkv = 12, D = 64) at
    # the serve engine's block_len 8 and 8 slots: Tq = 1 (each propose
    # step) and Tq = 64 (the catch-up); a generator of its own
    dgen = torch.Generator(device="cuda")
    dgen.manual_seed(SEED + 20)
    at_draft = {}
    for label, kw in {"tq1": dict(Tq=1, decode_rows=tuple(range(8))),
                      "tq64": dict(Tq=64, decode_rows=decode_rows)}.items():
        c = _paged_case(torch, dgen, dtype=torch.bfloat16, H=12, Hkv=12,
                        D=64, lens=lens, **kw)
        readings = check_paged(torch, c, f"draft bf16 H12 D64 {label}")[0]
        dscale = 1.0 / math.sqrt(64)
        a = (c["q"], c["k"], c["v"], c["table"], c["lens"], c["q_pos"],
             c["block_len"], c["pages_per_row"], dscale)
        runs = [paged_attention_cuda(*a) for _ in range(2)]
        torch.cuda.synchronize()
        check(torch.equal(*runs), f"paged attention draft {label}: two "
                                  "runs differ")
        ms, _ = time_cuda([partial(paged_attention_cuda, *a)])
        plain_ms, _ = time_cuda([partial(paged_attention_plain, *a)],
                                per_rep=1, warmup=1)
        lq, lk, lv, lm = _sdpa_inputs(torch, c)
        lib_ms, _ = time_cuda([partial(F.scaled_dot_product_attention, lq,
                                       lk, lv, attn_mask=lm, scale=dscale)])
        n_bytes, n_ops = _paged_bytes_ops(c)
        bound, by = bound_ms(n_bytes, n_ops, "bfloat16")
        at_draft[label] = dict(
            route=paged_route(torch.bfloat16, 8, 64),
            max_abs_err=readings["max_abs_err"], readings=readings,
            two_runs_equal=True, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound, bound_by=by, bytes=n_bytes, ops=n_ops,
            share_of_bound=bound / ms,
            shape=dict(B=8, H=12, Hkv=12, Tq=kw["Tq"], D=64, block_len=8,
                       pages_per_row=64, seq_lens=lens, dtype="bfloat16"))
        del c, a, runs, lq, lk, lv, lm
    n_bytes, n_ops = _paged_bytes_ops(bf)
    pa_bound, pa_by = bound_ms(n_bytes, n_ops, "bfloat16")
    results["paged_attention"] = dict(
        route=paged_route(torch.bfloat16, 8, 128),
        max_abs_err=cases["bf16"]["max_abs_err"],
        tol=f"bf16: each element within {BF16_PA_ULPS} bf16 ulps + "
            f"{BF16_PA_ATOL}, at most {BF16_PA_SHARE} of them past one ulp; "
            f"fp32 atol=rtol=1e-5",
        ms=pa_ms, call_ms=pa_call_ms, plain_ms=pa_plain_ms,
        library_ms=pa_lib_ms,
        bound_ms=pa_bound, bound_by=pa_by, bytes=n_bytes, ops=n_ops,
        tflops=n_ops / pa_ms / 1e9, share_of_bound=pa_bound / pa_ms,
        shape=dict(B=8, H=16, Hkv=16, Tq=64, D=128, block_len=8,
                   pages_per_row=64, seq_lens=lens, dtype="bfloat16"),
        at_llama_shapes=at_llama, at_draft_shape=at_draft,
        shared_pages=shared_pages, cases=cases)
    emit({"phase": "kernel", "name": "paged_attention",
          **results["paged_attention"]})

    # ---- LayerNorm at the served path's shapes: R = 8 slots x 64, N = 2048
    R, N = 8 * 64, 2048
    ln_cases = {}
    x32 = torch.randn(R, N, generator=gen, device="cuda") * 3 + 0.5
    w32 = torch.randn(N, generator=gen, device="cuda")
    b32 = torch.randn(N, generator=gen, device="cuda")
    ln_cases["fp32"] = check_layernorm(torch, x32, w32, b32, "fp32 512x2048")
    xb, wb, bb = (t.to(torch.bfloat16) for t in (x32, w32, b32))
    ln_cases["bf16"] = check_layernorm(torch, xb, wb, bb, "bf16 512x2048",
                                       bf16_ulp=True)
    for (r, n) in ((3, 8192), (5, 1000), (1, 1)):
        xe = torch.randn(r, n, generator=gen, device="cuda")
        we = torch.randn(n, generator=gen, device="cuda")
        be = torch.randn(n, generator=gen, device="cuda")
        ln_cases[f"fp32_{r}x{n}"] = check_layernorm(torch, xe, we, be,
                                                    f"fp32 {r}x{n}")
    emit({"phase": "kernel_checks", "name": "layernorm_rows",
          **check_layernorm_rows(torch, gen)})
    results["layernorm_fwd"] = layernorm_fwd_reading(torch, xb, wb, bb,
                                                     ln_cases)
    emit({"phase": "kernel", "name": "layernorm_fwd",
          **results["layernorm_fwd"]})
    return results


def check_layernorm_rows(torch, gen, R=512, head=64):
    """A row's forward does not depend on the rows around it: the first
    `head` rows of an R-row call equal a `head`-row call on those rows, and
    each equals a one-row call, bit for bit (y, mean and rstd), as the
    engine's steps and generate() need. The same rows at an odd storage
    offset (scalar accesses) equal them too. bf16 at N = 2048 (the
    served width) and fp32 at N = 1000 (a width of whole packs whose
    rows are still 16-byte aligned)."""
    from paddle_tpu_torch.ops.layernorm import layer_norm_fwd_cuda
    done = {}
    for dtype, N in ((torch.bfloat16, 2048), (torch.float32, 1000)):
        x, w, b = (torch.randn(*s, generator=gen, device="cuda").to(dtype)
                   for s in ((R, N), (N,), (N,)))
        full = layer_norm_fwd_cuda(x, w, b, 1e-5)
        part = layer_norm_fwd_cuda(x[:head], w, b, 1e-5)
        buf = torch.empty(head * N + 1, device="cuda", dtype=dtype)
        odd = buf[1:].view(head, N)
        odd.copy_(x[:head])
        scalar = layer_norm_fwd_cuda(odd, w, b, 1e-5)
        label = f"{str(dtype).split('.')[-1]} {R}x{N}"
        for name, f, p, q in zip(("y", "mean", "rstd"), full, part, scalar):
            check(torch.equal(f[:head], p),
                  f"layernorm {label}: rows 0..{head} of the {R}-row call "
                  f"differ from a {head}-row call ({name})")
            check(torch.equal(p, q),
                  f"layernorm {label}: the scalar-access path differs from "
                  f"the 16-byte one ({name})")
        for i in range(head):
            one = layer_norm_fwd_cuda(x[i:i + 1], w, b, 1e-5)
            for name, p, o in zip(("y", "mean", "rstd"), part, one):
                check(torch.equal(p[i:i + 1], o),
                      f"layernorm {label}: row {i} alone differs from the "
                      f"{head}-row call ({name})")
        done[label] = {"rows": head, "equal": ["y", "mean", "rstd"]}
    return {"bitwise": done}


def layernorm_fwd_reading(torch, xb, wb, bb, cases, cold=False):
    """The LayerNorm forward's line at the bf16 shape of `xb`: its error
    (from `cases`, the checks already made), its time, the plain version's
    and F.layer_norm's, and its bound. A step's LayerNorm reads the
    residual sum the op before it just wrote, so its input stays warm in L2
    here too (`ms`). With `cold`, a second reading cycles the input over
    L2_COPIES copies, kernel and F.layer_norm alike (`cold_ms`,
    `cold_library_ms`): a warm L2 can read under the HBM bound."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.layernorm import (layer_norm_fwd_cuda,
                                                layer_norm_fwd_plain)
    R, N = xb.shape
    ms, call_ms = time_cuda([partial(layer_norm_fwd_cuda, xb, wb, bb, 1e-5)])
    plain_ms, _ = time_cuda([partial(layer_norm_fwd_plain, xb, wb, bb,
                                     1e-5)])
    lib_ms, _ = time_cuda([partial(F.layer_norm, xb, (N,), wb, bb, 1e-5)])
    el = xb.element_size()
    n_bytes = 2 * R * N * el + 2 * N * el + 2 * R * 4
    n_ops = 8 * R * N
    bound, by = bound_ms(n_bytes, n_ops, "bfloat16")
    line = dict(
        max_abs_err=cases["bf16"],
        tol="one bf16 ulp of the output + 1e-5 (bf16); fp32 atol=rtol=1e-5; "
            "mean and rstd within 1e-5",
        ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=bound, bound_by=by, bytes=n_bytes, ops=n_ops,
        share_of_bound=bound / ms,
        shape=dict(R=R, N=N, dtype="bfloat16"), cases=cases)
    if cold:
        xs = [xb] + [xb.clone() for _ in range(L2_COPIES - 1)]
        line["cold_ms"], _ = time_cuda([
            partial(layer_norm_fwd_cuda, x_, wb, bb, 1e-5) for x_ in xs])
        line["cold_library_ms"], _ = time_cuda([
            partial(F.layer_norm, x_, (N,), wb, bb, 1e-5) for x_ in xs])
        line["cold_share_of_bound"] = bound / line["cold_ms"]
        del xs
    return line


# ------------------------------------------------ phase 3b: training kernels
# bf16 training kernels against their plain versions. The yardstick is the
# plain version run in fp32 on the same bf16 inputs: the kernel's largest
# error from it may be at most BF16_TRAIN_FACTOR times the bf16 plain
# version's own, plus BF16_TRAIN_ATOL. Both bf16 sides round the same
# values (p, ds and the outputs) to bf16 once, after fp32 sums taken in
# another order, so their errors are of one size: a rounding that lands on
# the other side of a midpoint moves an element by at most half an ulp
# more than the plain version's worst, well inside the factor of 2. The
# atol (a quarter of a bf16 ulp at 0.25) covers outputs whose plain error
# happens to be near 0. A wrong mask, tile or formula moves elements by
# their own size and fails; fp32 cases hold the algorithm to 1e-5 (forward
# and dx, one op sequence) or 1e-4 (sums of up to 4096 products, dq, dk,
# dv, dw, db, taken in another order).
BF16_TRAIN_FACTOR = 2.0
BF16_TRAIN_ATOL = 2.0 ** -12
# fp16 (AMP in float16) under the same rule scaled to its ulp: fp16 keeps
# 11 significant bits against bf16's 8, so its ulp at a given magnitude
# is 8 times smaller and the atol is a quarter of an fp16 ulp at 0.25;
# the factor stays 2 for the same reason as bf16's (both sides round the
# same values once after fp32 sums in another order). fp16's narrower
# range adds nothing here: p, ds and the outputs of these inputs lie far
# inside it, and a value that left it would fail as non-finite.
FP16_TRAIN_FACTOR = 2.0
FP16_TRAIN_ATOL = 2.0 ** -15
TRAIN_B, TRAIN_S = 4, 1024          # bench.py's gpt3-1.3b batch
LLAMA_FLASH_SHAPE = (1, 32, 4096, 128)   # llama2-7b's B, H, S, head_dim
MOE_FLASH_SHAPE = (8, 12, 1024, 64)      # ernie-moe-base's train step


def bf16_vs_fp32_plain(torch, got, plain_bf16, plain_fp32):
    """(kernel error, plain bf16 or fp16 error, limit) against the fp32
    plain version, as maxima of absolute differences; the limit is the
    BF16_TRAIN_* rule, or FP16_TRAIN_* for fp16 results."""
    ref = plain_fp32.float()
    err_k = float((got.float() - ref).abs().max())
    err_p = float((plain_bf16.float() - ref).abs().max())
    if got.dtype == torch.float16:
        return err_k, err_p, FP16_TRAIN_FACTOR * err_p + FP16_TRAIN_ATOL
    return err_k, err_p, BF16_TRAIN_FACTOR * err_p + BF16_TRAIN_ATOL


def _check_close(torch, got, ref, tol, what):
    err = (got.float() - ref.float()).abs()
    worst = float(err.max()) if err.numel() else 0.0
    check(bool((err <= tol + tol * ref.float().abs()).all()),
          f"{what}: max |kernel - plain| = {worst} exceeds atol = rtol = "
          f"{tol}")
    return worst


def _check_bf16(torch, got, plain_bf16, plain_fp32, what):
    """bf16 or fp16 `got` against the fp32 plain version under its
    dtype's training rule."""
    err_k, err_p, limit = bf16_vs_fp32_plain(torch, got, plain_bf16,
                                             plain_fp32)
    check(err_k <= limit, f"{what}: kernel is {err_k} from the fp32 plain "
                          f"version, limit {limit} (the {got.dtype} rule: "
                          f"a factor of the plain version's {err_p} plus an "
                          f"atol)")
    return dict(err=err_k, plain_err=err_p)


def _flash_inputs(torch, gen, B, H, Sq, Sk, D, dtype):
    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    return r(B, H, Sq, D), r(B, H, Sk, D), r(B, H, Sk, D), r(B, H, Sq, D)


def check_flash(torch, q, k, v, g, causal, label):
    """Forward, dq and dk/dv kernels against the plain versions on one
    case. Returns the readings."""
    from paddle_tpu_torch.ops.attention import (flash_attention_delta,
                                                flash_bwd_dkv_cuda,
                                                flash_bwd_dq_cuda,
                                                flash_bwd_plain,
                                                flash_fwd_cuda,
                                                flash_fwd_plain)
    scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = flash_fwd_cuda(q, k, v, causal, scale)
    delta = flash_attention_delta(g, out)
    dq = flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal, scale)
    torch.cuda.synchronize()
    for t, n in ((out, "out"), (lse, "lse"), (dq, "dq"), (dk, "dk"),
                 (dv, "dv")):
        check(bool(torch.isfinite(t.float()).all()),
              f"flash {label}: non-finite {n}")
    ref_out, ref_lse = flash_fwd_plain(q, k, v, causal, scale)
    ref_b = flash_bwd_plain(q, k, v, g, lse, delta, causal, scale)
    readings = {}
    if q.dtype == torch.float32:
        readings["out"] = _check_close(torch, out, ref_out, 1e-5,
                                       f"flash {label} out")
        readings["lse"] = _check_close(torch, lse, ref_lse, 1e-5,
                                       f"flash {label} lse")
        for n, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), ref_b):
            readings[n] = _check_close(torch, got, ref, 1e-4,
                                       f"flash {label} {n}")
        return readings
    f32 = [t.float() for t in (q, k, v, g)]
    ref32_out, ref32_lse = flash_fwd_plain(*f32[:3], causal, scale)
    ref32_b = flash_bwd_plain(*f32, lse, delta, causal, scale)
    readings["out"] = _check_bf16(torch, out, ref_out, ref32_out,
                                  f"flash {label} out")
    # lse is fp32 on both sides, from the same bf16 inputs
    readings["lse"] = _check_close(torch, lse, ref_lse, 1e-5,
                                   f"flash {label} lse")
    for n, got, ref, ref32 in zip(("dq", "dk", "dv"), (dq, dk, dv), ref_b,
                                  ref32_b):
        readings[n] = _check_bf16(torch, got, ref, ref32,
                                  f"flash {label} {n}")
    return readings


def visible_pairs(Sq, Sk, causal):
    """The (query, key) pairs of one batch*head a causal (bottom-right
    aligned) or full mask leaves visible."""
    if causal:
        return sum(max(0, min(Sk, r + (Sk - Sq) + 1)) for r in range(Sq))
    return Sq * Sk


def flash_bytes_ops(B, H, Sq, Sk, D, causal, el):
    """(bytes, operations) of the forward, dq and dk/dv functions.

    Pairs: the (query, key) pairs a causal (bottom-right aligned) or full
    mask leaves visible. Forward reads q, k, v and writes out and the fp32
    lse, doing QK and PV (4·D operations a pair); dq reads q, k, v, g, lse
    and delta and writes dq, doing QK, g·v and ds·k (6·D); dk/dv reads the
    same and writes dk and dv, doing QK, g·v, p·g and ds·q (8·D)."""
    pairs = visible_pairs(Sq, Sk, causal) * B * H
    qb, kb = B * H * Sq * D * el, B * H * Sk * D * el
    row = B * H * Sq * 4
    return {"flash_fwd": (2 * qb + 2 * kb + row, 4 * D * pairs),
            "flash_bwd_dq": (3 * qb + 2 * kb + 2 * row, 6 * D * pairs),
            "flash_bwd_dkv": (2 * qb + 4 * kb + 2 * row, 8 * D * pairs)}


def check_layernorm_bwd(torch, x, w, b, dy, label):
    from paddle_tpu_torch.ops.layernorm import (layer_norm_bwd_cuda,
                                                layer_norm_bwd_plain,
                                                layer_norm_fwd_cuda)
    _, mu, rstd = layer_norm_fwd_cuda(x, w, b, 1e-5)
    got = layer_norm_bwd_cuda(x, w, mu, rstd, dy)
    torch.cuda.synchronize()
    ref = layer_norm_bwd_plain(x, w, mu, rstd, dy)
    names = ("dx", "dw", "db")
    for t, n in zip(got, names):
        check(bool(torch.isfinite(t.float()).all()),
              f"layernorm_bwd {label}: non-finite {n}")
    if x.dtype == torch.float32:
        return {n: _check_close(torch, a, r, 1e-5 if n == "dx" else 1e-4,
                                f"layernorm_bwd {label} {n}")
                for n, a, r in zip(names, got, ref)}
    ref32 = layer_norm_bwd_plain(x.float(), w.float(), mu, rstd, dy.float())
    return {n: _check_bf16(torch, a, r, r32, f"layernorm_bwd {label} {n}")
            for n, a, r, r32 in zip(names, got, ref, ref32)}


def _sdpa_bwd_call(torch, F, q, k, v, g):
    """One backward of F.scaled_dot_product_attention(is_causal=True) on a
    graph built once (the library's dq, dk and dv together)."""
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    return partial(torch.autograd.grad, out, (qr, kr, vr), g,
                   retain_graph=True)


def _ln_bwd_call(torch, F, x, w, b, dy):
    """One backward of F.layer_norm on a graph built once."""
    xr, wr, br = (t.detach().requires_grad_() for t in (x, w, b))
    y = F.layer_norm(xr, (x.shape[-1],), wr, br, 1e-5)
    return partial(torch.autograd.grad, y, (xr, wr, br), dy,
                   retain_graph=True)


def phase_train_kernels():
    """The training slice's kernels against their plain versions at the
    training shapes (gpt3-1.3b: B=4, H=16, S=1024, D=128, bf16, causal;
    LayerNorm R = 4096, N = 2048) and at edge shapes, then timed."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.attention import (flash_attention_delta,
                                                flash_bwd_dkv_cuda,
                                                flash_bwd_dq_cuda,
                                                flash_bwd_plain,
                                                flash_fwd_cuda,
                                                flash_fwd_plain)
    from paddle_tpu_torch.ops.layernorm import (layer_norm_bwd_cuda,
                                                layer_norm_bwd_plain,
                                                layer_norm_fwd_cuda)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    B, H, S, D = TRAIN_B, 16, TRAIN_S, 128
    bf = torch.bfloat16
    cases = {}
    q, k, v, g = _flash_inputs(torch, gen, B, H, S, S, D, bf)
    cases["bf16_train_causal"] = check_flash(torch, q, k, v, g, True,
                                             "bf16 [4,16,1024,128] causal")
    for name, (b_, h_, sq, sk, d_, dt, causal) in {
            "fp32_causal": (2, 4, 256, 256, 128, torch.float32, True),
            "fp32_noncausal": (2, 4, 256, 256, 128, torch.float32, False),
            "fp32_sq_lt_sk": (1, 3, 100, 300, 64, torch.float32, True),
            "fp32_sq_gt_sk": (1, 3, 300, 100, 64, torch.float32, True),
            "fp32_ragged_d64": (2, 2, 200, 200, 64, torch.float32, True),
            "fp32_ragged_d32_noncausal": (1, 2, 77, 130, 32,
                                          torch.float32, False),
            "bf16_ragged_d64": (2, 4, 333, 333, 64, bf, True),
            "bf16_sq_gt_sk_noncausal": (1, 4, 190, 70, 128, bf, False),
            "bf16_sq_lt_sk_d32": (1, 3, 100, 300, 32, bf, True),
            "bf16_one_row_d16": (1, 2, 1, 1, 16, bf, True),
            "bf16_bh160": (4, 40, 128, 128, 128, bf, True)}.items():
        cases[name] = check_flash(
            torch, *_flash_inputs(torch, gen, b_, h_, sq, sk, d_, dt),
            causal, name)
    # llama2-7b's train step: one sequence of 4096, 32 heads; a generator
    # of its own leaves the other cases' inputs as they were
    lgen = torch.Generator(device="cuda")
    lgen.manual_seed(SEED + 9)
    lB, lH, lS, lD = LLAMA_FLASH_SHAPE
    llama = _flash_inputs(torch, lgen, lB, lH, lS, lS, lD, bf)
    cases["bf16_llama2_7b_causal"] = check_flash(
        torch, *llama, True, "bf16 [1,32,4096,128] causal")
    emit({"phase": "kernel_checks", "name": "flash_attention",
          "cases": cases})
    # fixed summation order, no atomics: two runs are bit-equal
    scale = 1.0 / math.sqrt(D)
    runs = []
    for _ in range(2):
        out, lse = flash_fwd_cuda(q, k, v, True, scale)
        delta = flash_attention_delta(g, out)
        runs.append((out, lse,
                     flash_bwd_dq_cuda(q, k, v, g, lse, delta, True, scale),
                     *flash_bwd_dkv_cuda(q, k, v, g, lse, delta, True,
                                         scale)))
    torch.cuda.synchronize()
    names = ("out", "lse", "dq", "dk", "dv")
    for n, a, b in zip(names, *runs):
        check(torch.equal(a, b), f"flash bf16 {n}: two runs differ")
    emit({"phase": "kernel_checks", "name": "flash_attention_bitwise",
          "runs": 2, "equal": list(names)})
    del runs

    # LayerNorm backward: the training rows (4 x 1024) at width 2048
    R, N = TRAIN_B * TRAIN_S, 2048
    x32 = torch.randn(R, N, generator=gen, device="cuda") * 3 + 0.5
    w32 = torch.randn(N, generator=gen, device="cuda")
    b32 = torch.randn(N, generator=gen, device="cuda")
    dy32 = torch.randn(R, N, generator=gen, device="cuda")
    ln_cases = {"fp32": check_layernorm_bwd(torch, x32, w32, b32, dy32,
                                            "fp32 4096x2048")}
    xb, wb, bb, dyb = (t.to(bf) for t in (x32, w32, b32, dy32))
    ln_cases["bf16"] = check_layernorm_bwd(torch, xb, wb, bb, dyb,
                                           "bf16 4096x2048")
    # the forward at the training rows: y, mean and rstd against the plain
    # version, so the statistics the backward takes are held too
    fwd_cases = {"fp32": check_layernorm(torch, x32, w32, b32,
                                         "fp32 4096x2048"),
                 "bf16": check_layernorm(torch, xb, wb, bb, "bf16 4096x2048",
                                         bf16_ulp=True)}
    for (r, n) in ((3, 8192), (5, 1000), (1, 1), (70001, 64)):
        t = [torch.randn(*s, generator=gen, device="cuda")
             for s in ((r, n), (n,), (n,), (r, n))]
        ln_cases[f"fp32_{r}x{n}"] = check_layernorm_bwd(torch, *t,
                                                        f"fp32 {r}x{n}")
        fwd_cases[f"fp32_{r}x{n}"] = check_layernorm(torch, *t[:3],
                                                     f"fp32 {r}x{n}")
    emit({"phase": "kernel_checks", "name": "layernorm_bwd",
          "cases": ln_cases})

    # ---- timing at the training shapes. Attention's inputs (67 MB) and
    # the LayerNorm backward's x and dy (34 MB) are cycled over two copies,
    # so a call finds them out of L2, as a layer of a train step does.
    results = {}
    copies = [(q, k, v, g)] + [tuple(t.clone() for t in (q, k, v, g))]
    outs = []
    for cq, ck, cv, cg in copies:
        o, lse = flash_fwd_cuda(cq, ck, cv, True, scale)
        outs.append((o, lse, flash_attention_delta(cg, o)))
    t = {}
    t["flash_fwd"] = time_cuda([partial(flash_fwd_cuda, cq, ck, cv, True,
                                        scale) for cq, ck, cv, _ in copies])
    t["flash_bwd_dq"] = time_cuda([
        partial(flash_bwd_dq_cuda, cq, ck, cv, cg, lse, dl, True, scale)
        for (cq, ck, cv, cg), (_, lse, dl) in zip(copies, outs)])
    t["flash_bwd_dkv"] = time_cuda([
        partial(flash_bwd_dkv_cuda, cq, ck, cv, cg, lse, dl, True, scale)
        for (cq, ck, cv, cg), (_, lse, dl) in zip(copies, outs)])
    plain_fwd, _ = time_cuda([partial(flash_fwd_plain, q, k, v, True,
                                      scale)], per_rep=2)
    o, lse, dl = outs[0]
    plain_bwd, _ = time_cuda([partial(flash_bwd_plain, q, k, v, g, lse, dl,
                                      True, scale)], per_rep=2)
    lib_fwd, _ = time_cuda([partial(F.scaled_dot_product_attention, cq, ck,
                                    cv, is_causal=True)
                            for cq, ck, cv, _ in copies])
    lib_bwd, _ = time_cuda([_sdpa_bwd_call(torch, F, *c) for c in copies])
    del outs, copies
    plain = {"flash_fwd": plain_fwd, "flash_bwd_dq": plain_bwd,
             "flash_bwd_dkv": plain_bwd}
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd,
               "flash_bwd_dkv": lib_bwd}
    bo = flash_bytes_ops(B, H, S, S, D, True, 2)
    tol = (f"bf16: max error from the fp32 plain version <= "
           f"{BF16_TRAIN_FACTOR} x the bf16 plain version's + "
           f"{BF16_TRAIN_ATOL}; fp32 atol=rtol=1e-5 (out, lse), 1e-4 "
           f"(dq, dk, dv)")
    read = cases["bf16_train_causal"]
    err = {"flash_fwd": read["out"]["err"], "flash_bwd_dq": read["dq"]["err"],
           "flash_bwd_dkv": max(read["dk"]["err"], read["dv"]["err"])}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        n_bytes, n_ops = bo[name]
        bound, by = bound_ms(n_bytes, n_ops, "bfloat16")
        results[name] = dict(
            max_abs_err=err[name], tol=tol, ms=t[name][0],
            call_ms=t[name][1], plain_ms=plain[name],
            library_ms=library[name], bound_ms=bound, bound_by=by,
            bytes=n_bytes, ops=n_ops,
            tflops=n_ops / t[name][0] / 1e9,
            share_of_bound=bound / t[name][0],
            shape=dict(B=B, H=H, Sq=S, Sk=S, D=D, causal=True,
                       dtype="bfloat16"),
            note=(None if name == "flash_fwd" else
                  "plain_ms and library_ms compute dq, dk and dv together"))
    # at llama2-7b's train shape, beside F.scaled_dot_product_attention;
    # 134 MB of inputs a call, past L2
    lq, lk, lv, lg = llama
    lo, llse = flash_fwd_cuda(lq, lk, lv, True, scale)
    ldl = flash_attention_delta(lg, lo)
    lt = {"flash_fwd": time_cuda([partial(flash_fwd_cuda, lq, lk, lv, True,
                                          scale)])[0],
          "flash_bwd_dq": time_cuda([partial(
              flash_bwd_dq_cuda, lq, lk, lv, lg, llse, ldl, True,
              scale)])[0],
          "flash_bwd_dkv": time_cuda([partial(
              flash_bwd_dkv_cuda, lq, lk, lv, lg, llse, ldl, True,
              scale)])[0]}
    llib_fwd = time_cuda([partial(F.scaled_dot_product_attention, lq, lk,
                                  lv, is_causal=True)])[0]
    llib_bwd = time_cuda([_sdpa_bwd_call(torch, F, lq, lk, lv, lg)])[0]
    lbo = flash_bytes_ops(lB, lH, lS, lS, lD, True, 2)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        n_bytes, n_ops = lbo[name]
        bound, by = bound_ms(n_bytes, n_ops, "bfloat16")
        results[name]["at_llama_shape"] = dict(
            ms=lt[name], library_ms=llib_fwd if name == "flash_fwd"
            else llib_bwd, bound_ms=bound, bound_by=by,
            tflops=n_ops / lt[name] / 1e9, share_of_bound=bound / lt[name],
            shape=dict(B=lB, H=lH, Sq=lS, Sk=lS, D=lD, causal=True,
                       dtype="bfloat16"))
    del llama, lq, lk, lv, lg, lo, llse, ldl
    # at ernie-moe-base's train shape (head dim 64), checked against the
    # plain versions and timed beside F.scaled_dot_product_attention
    mgen = torch.Generator(device="cuda")
    mgen.manual_seed(SEED + 12)
    mB, mH, mS, mD = MOE_FLASH_SHAPE
    moe = _flash_inputs(torch, mgen, mB, mH, mS, mS, mD, bf)
    mread = check_flash(torch, *moe, True, "bf16 [8,12,1024,64] causal")
    mq, mk, mv, mg = moe
    mscale = 1.0 / math.sqrt(mD)
    mo, mlse = flash_fwd_cuda(mq, mk, mv, True, mscale)
    mdl = flash_attention_delta(mg, mo)
    mt = {"flash_fwd": time_cuda([partial(flash_fwd_cuda, mq, mk, mv, True,
                                          mscale)])[0],
          "flash_bwd_dq": time_cuda([partial(
              flash_bwd_dq_cuda, mq, mk, mv, mg, mlse, mdl, True,
              mscale)])[0],
          "flash_bwd_dkv": time_cuda([partial(
              flash_bwd_dkv_cuda, mq, mk, mv, mg, mlse, mdl, True,
              mscale)])[0]}
    mlib_fwd = time_cuda([partial(F.scaled_dot_product_attention, mq, mk,
                                  mv, is_causal=True)])[0]
    mlib_bwd = time_cuda([_sdpa_bwd_call(torch, F, mq, mk, mv, mg)])[0]
    mbo = flash_bytes_ops(mB, mH, mS, mS, mD, True, 2)
    merr = {"flash_fwd": mread["out"]["err"],
            "flash_bwd_dq": mread["dq"]["err"],
            "flash_bwd_dkv": max(mread["dk"]["err"], mread["dv"]["err"])}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        n_bytes, n_ops = mbo[name]
        bound, by = bound_ms(n_bytes, n_ops, "bfloat16")
        results[name]["at_moe_shape"] = dict(
            ms=mt[name], max_abs_err=merr[name], library_ms=(
                mlib_fwd if name == "flash_fwd" else mlib_bwd),
            bound_ms=bound, bound_by=by, tflops=n_ops / mt[name] / 1e9,
            share_of_bound=bound / mt[name],
            shape=dict(B=mB, H=mH, Sq=mS, Sk=mS, D=mD, causal=True,
                       dtype="bfloat16"))
        emit({"phase": "kernel", "name": name, **results[name]})
    del moe, mq, mk, mv, mg, mo, mlse, mdl

    _, mu, rstd = layer_norm_fwd_cuda(xb, wb, bb, 1e-5)
    ln_in = [(xb, dyb), (xb.clone(), dyb.clone())]
    ln_ms, ln_call_ms = time_cuda([partial(layer_norm_bwd_cuda, x_, wb, mu,
                                           rstd, dy_) for x_, dy_ in ln_in])
    ln_plain, _ = time_cuda([partial(layer_norm_bwd_plain, xb, wb, mu, rstd,
                                     dyb)])
    ln_lib, _ = time_cuda([_ln_bwd_call(torch, F, x_, wb, bb, dy_)
                           for x_, dy_ in ln_in])
    el = xb.element_size()
    ln_bytes = 3 * R * N * el + N * el + 2 * R * 4 + 2 * N * el
    ln_ops = 13 * R * N     # the plain formula's operations an element
    ln_bound, ln_by = bound_ms(ln_bytes, ln_ops, "bfloat16")
    results["layernorm_bwd"] = dict(
        max_abs_err=max(v["err"] for v in ln_cases["bf16"].values()),
        tol=(f"bf16: max error from the fp32 plain version <= "
             f"{BF16_TRAIN_FACTOR} x the bf16 plain version's + "
             f"{BF16_TRAIN_ATOL}; fp32 atol=rtol=1e-5 (dx), 1e-4 (dw, db)"),
        ms=ln_ms, call_ms=ln_call_ms, plain_ms=ln_plain, library_ms=ln_lib,
        bound_ms=ln_bound, bound_by=ln_by, bytes=ln_bytes, ops=ln_ops,
        share_of_bound=ln_bound / ln_ms,
        shape=dict(R=R, N=N, dtype="bfloat16"),
        note="library_ms: the backward of F.layer_norm (dx, dw, db)")
    emit({"phase": "kernel", "name": "layernorm_bwd",
          **results["layernorm_bwd"]})
    results["layernorm_fwd_train"] = layernorm_fwd_reading(
        torch, xb, wb, bb, fwd_cases, cold=True)
    emit({"phase": "kernel", "name": "layernorm_fwd",
          **results["layernorm_fwd_train"]})
    torch.cuda.empty_cache()
    return results


# ------------------------------------ phase 3b': the fp16 kernels
# Every fp16 instantiation (AMP in float16, pure-fp16 O2 training, fp16
# serving) against its plain version on the card, each run twice
# bit-equal and timed (median of 21 CUDA-event samples) beside its bound,
# its plain version and, where one PyTorch call computes the same
# function, that call:
#   - the tensor-core forward, dq and dk/dv at the train step's shape,
#     [4, 16, 1024, 128] causal, under the FP16_TRAIN_* rule, plus edge
#     shapes, beside F.scaled_dot_product_attention in fp16 (forward, and
#     its backward for the pair);
#   - the LayerNorm forward and backward at the served step's 512 x 2048
#     and the train step's 4096 x 2048, under the FP16_TRAIN_* rule (the
#     fp32 plain version on the same fp16 inputs the yardstick; mean and
#     rstd within 1e-5), beside fp16 F.layer_norm and its backward;
#   - fused Adam bit for bit in every dtype combination with fp16 in it,
#     and at the word embedding (103.0 M elements) with pure-fp16
#     training's dtypes: fp16 p and g, an fp32 master, fp32 moments;
#   - paged attention at phase 3's serve shape on both routes (block_len 8
#     on the tensor cores, 12 on the scalar kernel) and at its GQA shape,
#     under the FP16_PA_* rule, beside fp16 SDPA over the gathered pages.
FP16_FLASH_EDGES = {"fp16_ragged_d64": (2, 4, 333, 333, 64, True),
                    "fp16_sq_gt_sk_noncausal": (1, 4, 190, 70, 128, False),
                    "fp16_sq_lt_sk_d32": (1, 3, 100, 300, 32, True),
                    "fp16_bh160": (4, 40, 128, 128, 128, True)}


def fp16_flash_kernels():
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.attention import (flash_attention_delta,
                                                flash_bwd_dkv_cuda,
                                                flash_bwd_dq_cuda,
                                                flash_bwd_plain,
                                                flash_fwd_cuda,
                                                flash_fwd_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    B, H, S, D = TRAIN_B, 16, TRAIN_S, 128
    h = torch.float16
    q, k, v, g = _flash_inputs(torch, gen, B, H, S, S, D, h)
    cases = {"fp16_train_causal": check_flash(
        torch, q, k, v, g, True, "fp16 [4,16,1024,128] causal")}
    for name, (b_, h_, sq, sk, d_, causal) in FP16_FLASH_EDGES.items():
        cases[name] = check_flash(
            torch, *_flash_inputs(torch, gen, b_, h_, sq, sk, d_, h),
            causal, name)
    scale = 1.0 / math.sqrt(D)
    runs = []
    for _ in range(2):
        out, lse = flash_fwd_cuda(q, k, v, True, scale)
        delta = flash_attention_delta(g, out)
        runs.append((out, lse,
                     flash_bwd_dq_cuda(q, k, v, g, lse, delta, True, scale),
                     *flash_bwd_dkv_cuda(q, k, v, g, lse, delta, True,
                                         scale)))
    torch.cuda.synchronize()
    names = ("out", "lse", "dq", "dk", "dv")
    for n, a, b in zip(names, *runs):
        check(torch.equal(a, b), f"flash fp16 {n}: two runs differ")
    del runs
    emit({"phase": "kernel_checks", "name": "flash_attention_fp16",
          "cases": cases, "bitwise_runs": 2, "equal": list(names)})
    # timing, inputs cycled over two copies as in the bf16 phase
    copies = [(q, k, v, g)] + [tuple(t.clone() for t in (q, k, v, g))]
    outs = []
    for cq, ck, cv, cg in copies:
        o, lse = flash_fwd_cuda(cq, ck, cv, True, scale)
        outs.append((lse, flash_attention_delta(cg, o)))
    t = {"flash_fwd_fp16": time_cuda([
        partial(flash_fwd_cuda, cq, ck, cv, True, scale)
        for cq, ck, cv, _ in copies]),
         "flash_bwd_dq_fp16": time_cuda([
             partial(flash_bwd_dq_cuda, cq, ck, cv, cg, lse, dl, True, scale)
             for (cq, ck, cv, cg), (lse, dl) in zip(copies, outs)]),
         "flash_bwd_dkv_fp16": time_cuda([
             partial(flash_bwd_dkv_cuda, cq, ck, cv, cg, lse, dl, True,
                     scale)
             for (cq, ck, cv, cg), (lse, dl) in zip(copies, outs)])}
    plain_fwd, _ = time_cuda([partial(flash_fwd_plain, q, k, v, True,
                                      scale)], per_rep=2)
    lse, dl = outs[0]
    plain_bwd, _ = time_cuda([partial(flash_bwd_plain, q, k, v, g, lse, dl,
                                      True, scale)], per_rep=2)
    lib_fwd, _ = time_cuda([partial(F.scaled_dot_product_attention, cq, ck,
                                    cv, is_causal=True)
                            for cq, ck, cv, _ in copies])
    lib_bwd, _ = time_cuda([_sdpa_bwd_call(torch, F, *c) for c in copies])
    del outs, copies
    bo = flash_bytes_ops(B, H, S, S, D, True, 2)
    read = cases["fp16_train_causal"]
    err = {"flash_fwd": read["out"]["err"], "flash_bwd_dq": read["dq"]["err"],
           "flash_bwd_dkv": max(read["dk"]["err"], read["dv"]["err"])}
    tol = (f"fp16: max error from the fp32 plain version <= "
           f"{FP16_TRAIN_FACTOR} x the fp16 plain version's + "
           f"{FP16_TRAIN_ATOL}")
    results = {}
    for base in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        name = base + "_fp16"
        n_bytes, n_ops = bo[base]
        bound, by = bound_ms(n_bytes, n_ops, "float16")
        results[name] = dict(
            max_abs_err=err[base], tol=tol, ms=t[name][0],
            call_ms=t[name][1],
            plain_ms=plain_fwd if base == "flash_fwd" else plain_bwd,
            library_ms=lib_fwd if base == "flash_fwd" else lib_bwd,
            bound_ms=bound, bound_by=by, bytes=n_bytes, ops=n_ops,
            tflops=n_ops / t[name][0] / 1e9,
            share_of_bound=bound / t[name][0],
            shape=dict(B=B, H=H, Sq=S, Sk=S, D=D, causal=True,
                       dtype="float16"),
            note=(None if base == "flash_fwd" else
                  "plain_ms and library_ms compute dq, dk and dv together"))
        emit({"phase": "kernel", "name": name, **results[name]})
    torch.cuda.empty_cache()
    return results


FP16_LN_SHAPES = ((8 * 64, 2048), (TRAIN_B * TRAIN_S, 2048))  # serve, train


def _equal_runs(torch, fn, n=2):
    """`fn()` run n times (a tuple of tensors each): whether all runs are
    bit-equal."""
    runs = [fn() for _ in range(n)]
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for r in runs[1:]
               for a, b in zip(runs[0], r))


def fp16_layernorm_kernels():
    """The fp16 LayerNorm forward and backward at FP16_LN_SHAPES: checked,
    twice bit-equal, timed. Returns {"layernorm_fwd_fp16": reading,
    "layernorm_bwd_fp16": reading}, the readings at the served shape
    (forward) and the train shape (backward), the other shape beside."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.layernorm import (layer_norm_bwd_cuda,
                                                layer_norm_bwd_plain,
                                                layer_norm_fwd_cuda,
                                                layer_norm_fwd_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 13)
    h = torch.float16
    tol = (f"fp16: max error from the fp32 plain version on the same fp16 "
           f"inputs <= {FP16_TRAIN_FACTOR} x the fp16 plain version's + "
           f"{FP16_TRAIN_ATOL}; mean and rstd within 1e-5")
    by_shape = {}
    for R, N in FP16_LN_SHAPES:
        x = (torch.randn(R, N, generator=gen, device="cuda") * 3 + 0.5).to(h)
        w, b, dy = (torch.randn(*s_, generator=gen, device="cuda").to(h)
                    for s_ in ((N,), (N,), (R, N)))
        label = f"fp16 {R}x{N}"
        y, mu, rstd = layer_norm_fwd_cuda(x, w, b, 1e-5)
        y_ref, mu_ref, rstd_ref = layer_norm_fwd_plain(x, w, b, 1e-5)
        y32, _, _ = layer_norm_fwd_plain(x.float(), w.float(), b.float(),
                                         1e-5)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y.float()).all()),
              f"layernorm {label}: non-finite output")
        fwd = _check_bf16(torch, y, y_ref, y32, f"layernorm {label} y")
        fwd["stat_err"] = max(float((mu - mu_ref).abs().max()), float(
            ((rstd - rstd_ref) / rstd_ref).abs().max()))
        check(fwd["stat_err"] <= 1e-5, f"layernorm {label}: mean/rstd "
                                       f"differ by {fwd['stat_err']}")
        bwd = check_layernorm_bwd(torch, x, w, b, dy, label)
        equal = (_equal_runs(torch, partial(layer_norm_fwd_cuda, x, w, b,
                                            1e-5))
                 and _equal_runs(torch, partial(layer_norm_bwd_cuda, x, w,
                                                mu, rstd, dy)))
        check(equal, f"layernorm {label}: two runs differ")
        # the step reads the residual sum the op before it just wrote: the
        # forward's input stays warm; the backward's x and dy (the train
        # shape's 34 MB) cycle over two copies, as a layer's would
        ins = [(x, dy), (x.clone(), dy.clone())]
        t = {"fwd": time_cuda([partial(layer_norm_fwd_cuda, x, w, b,
                                       1e-5)]),
             "bwd": time_cuda([partial(layer_norm_bwd_cuda, x_, w, mu, rstd,
                                       dy_) for x_, dy_ in ins])}
        plain = {"fwd": time_cuda([partial(layer_norm_fwd_plain, x, w, b,
                                           1e-5)])[0],
                 "bwd": time_cuda([partial(layer_norm_bwd_plain, x, w, mu,
                                           rstd, dy)])[0]}
        lib = {"fwd": time_cuda([partial(F.layer_norm, x, (N,), w, b,
                                         1e-5)])[0],
               "bwd": time_cuda([_ln_bwd_call(torch, F, x_, w, b, dy_)
                                 for x_, dy_ in ins])[0]}
        el = 2
        bo = {"fwd": (2 * R * N * el + 2 * N * el + 2 * R * 4, 8 * R * N),
              "bwd": (3 * R * N * el + N * el + 2 * R * 4 + 2 * N * el,
                      13 * R * N)}
        errs = {"fwd": fwd["err"],
                "bwd": max(v["err"] for v in bwd.values())}
        cold = {}
        if R * N * 2 > 8 * 2**20:
            # a train step's forward input may also come from HBM: the
            # input cycled over L2_COPIES copies, kernel and library alike
            xs = [x] + [x.clone() for _ in range(L2_COPIES - 1)]
            cold["cold_ms"] = time_cuda([partial(
                layer_norm_fwd_cuda, x_, w, b, 1e-5) for x_ in xs])[0]
            cold["cold_library_ms"] = time_cuda([partial(
                F.layer_norm, x_, (N,), w, b, 1e-5) for x_ in xs])[0]
            del xs
        for k in ("fwd", "bwd"):
            bound, by = bound_ms(*bo[k], "float16")
            if k == "fwd" and cold:
                cold["cold_share_of_bound"] = bound / cold["cold_ms"]
            by_shape[(k, R)] = dict(
                **(cold if k == "fwd" else {}),
                max_abs_err=errs[k], tol=tol, ms=t[k][0], call_ms=t[k][1],
                plain_ms=plain[k], library_ms=lib[k], bound_ms=bound,
                bound_by=by, bytes=bo[k][0], ops=bo[k][1],
                share_of_bound=bound / t[k][0], bitwise_runs=2,
                checks=fwd if k == "fwd" else bwd,
                shape=dict(R=R, N=N, dtype="float16"),
                note=None if k == "fwd" else
                "library_ms: the backward of F.layer_norm (dx, dw, db)")
        del x, w, b, dy, y, mu, rstd, y_ref, y32, ins
    # widths that are not whole 16-byte packs (the scalar-access path) and
    # the widest row
    edges = {}
    for R, N in ((5, 1000), (3, 8192)):
        x, w, b, dy = (torch.randn(*s_, generator=gen, device="cuda").to(h)
                       for s_ in ((R, N), (N,), (N,), (R, N)))
        y, _, _ = layer_norm_fwd_cuda(x, w, b, 1e-5)
        y_ref, _, _ = layer_norm_fwd_plain(x, w, b, 1e-5)
        y32, _, _ = layer_norm_fwd_plain(x.float(), w.float(), b.float(),
                                         1e-5)
        edges[f"{R}x{N}"] = dict(
            y=_check_bf16(torch, y, y_ref, y32, f"layernorm fp16 {R}x{N} y"),
            bwd=check_layernorm_bwd(torch, x, w, b, dy, f"fp16 {R}x{N}"))
        del x, w, b, dy, y, y_ref, y32
    emit({"phase": "kernel_checks", "name": "layernorm_fp16_edges",
          "cases": edges, "tol": tol})
    (r_serve, _), (r_train, _) = FP16_LN_SHAPES
    results = {
        "layernorm_fwd_fp16": dict(by_shape[("fwd", r_serve)],
                                   at_train_shape=by_shape[("fwd",
                                                            r_train)]),
        "layernorm_bwd_fp16": dict(by_shape[("bwd", r_train)],
                                   at_serve_shape=by_shape[("bwd",
                                                            r_serve)])}
    for name, reading in results.items():
        emit({"phase": "kernel", "name": name, **reading})
    torch.cuda.empty_cache()
    return results


# fused Adam's dtype combinations with fp16 in them (p, g, moments, an fp32
# master): pure-fp16 training's first (fp16 p and g, fp32 master and
# moments), then the rest the JAX kernel takes
FP16_ADAM_DTYPES = {
    "fp16_master_fp32_m": ("float16", "float16", "float32", True),
    "fp16_master_fp16_m": ("float16", "float16", "float16", True),
    "fp16": ("float16", "float16", "float16", False),
    "fp16_p_fp32_m": ("float16", "float16", "float32", False),
    "fp32_p_fp16_g_fp16_m": ("float32", "float16", "float16", False),
    "bf16_master_fp16_m": ("bfloat16", "bfloat16", "float16", True),
    "fp16_p_bf16_g_m": ("float16", "bfloat16", "bfloat16", False),
}
FP16_ADAM_LEAVES = ("n2049", "n1000", "linear1.weight")


def fp16_adam_kernel():
    """Fused Adam with fp16 operands bit for bit against its plain version
    (FP16_ADAM_DTYPES over FP16_ADAM_LEAVES, decoupled or not), then at
    the word embedding with pure-fp16 training's dtypes: checked, twice
    bit-equal, timed beside its plain version. No PyTorch call computes
    this update: torch._fused_adamw_ takes one dtype for p, g and both
    moments and keeps no master weight."""
    import torch
    from paddle_tpu_torch.ops.fused_adam import (fused_adam_cuda,
                                                 fused_adam_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 14)
    cases = {}
    for leaf in FP16_ADAM_LEAVES:
        n = ADAM_LEAVES[leaf]
        for dname, (pd, gd, md, master) in FP16_ADAM_DTYPES.items():
            for decoupled in (False, True):
                label = f"{leaf} {dname} decoupled={decoupled}"
                c = _adam_leaf(torch, gen, n, getattr(torch, pd),
                               getattr(torch, md), master,
                               getattr(torch, gd))
                cases[label] = check_adam(torch, c, decoupled, label)
                del c
    n = ADAM_LEAVES["word_embeddings.weight"]
    h, f32 = torch.float16, torch.float32
    c = _adam_leaf(torch, gen, n, h, f32, True)
    first = {k: None if v is None else v.clone() for k, v in c.items()}
    label = "word_embeddings.weight fp16_master_fp32_m decoupled=True"
    cases[label] = check_adam(torch, c, True, label)
    kw = dict(ADAM_HP, decoupled=True)
    sc = adam_scalars(torch)

    def update():
        d = {k: None if v is None else v.clone() for k, v in first.items()}
        fused_adam_cuda(d["p"], d["g"], d["m1"], d["m2"], *sc, 0.1,
                        master=d["master"], **kw)
        return tuple(d[k] for k in ("p", "m1", "m2", "master"))
    check(_equal_runs(torch, update), "fused_adam fp16: two runs differ")
    del first
    torch.cuda.empty_cache()
    emit({"phase": "kernel_checks", "name": "fused_adam_fp16",
          "cases": cases, "bitwise_runs": 2})
    args = (c["p"], c["g"], c["m1"], c["m2"], *sc, 0.1)
    # a leaf of 3.1 GB is far past the 50 MB L2: every call cold
    ms, call_ms = time_cuda([partial(fused_adam_cuda, *args,
                                     master=c["master"], **kw)])
    plain_ms, _ = time_cuda([partial(fused_adam_plain, *args,
                                     master=c["master"], **kw)], per_rep=2)
    n_bytes, n_ops = adam_bytes_ops(n, 2, 4, True)
    bound, by = bound_ms(n_bytes, n_ops, "float32")
    del c, args
    torch.cuda.empty_cache()
    result = dict(
        max_abs_err=max(cases.values()),
        tol="0: bit for bit against the plain version on the card, every "
            "fp16 dtype, master and decay case",
        ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=None,
        bound_ms=bound, bound_by=by, bytes=n_bytes, ops=n_ops,
        share_of_bound=bound / ms, bitwise_runs=2,
        shape=dict(n=n, p="float16", g="float16", moments="float32",
                   master="float32"),
        note="library_ms null: torch._fused_adamw_ takes one dtype for p, "
             "g and both moments and keeps no master weight, so no "
             "PyTorch call computes this update")
    emit({"phase": "kernel", "name": "fused_adam_fp16", **result})
    return {"fused_adam_fp16": result}


def fp16_paged_kernels():
    """fp16 paged attention at phase 3's serve shape (gpt3-1.3b heads, 8
    slots, 64-wide rows, lengths up to 512) on the tensor cores (block_len
    8) and on the scalar kernel (block_len 12), and at its GQA shape (16
    query heads over 4): checked, twice bit-equal, timed with the slabs
    cycled past L2 as a served step's layers find them. Returns
    {"paged_attention_fp16": reading}."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.paged_attention import (TENSOR_CORES,
                                                      paged_attention_cuda,
                                                      paged_attention_plain,
                                                      paged_route)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 15)
    h = torch.float16
    lens = [512, 37, 200, 1, 448, 64, 300, 129]
    common = dict(dtype=h, D=128, lens=lens, decode_rows=(1, 3, 6))
    shapes = {"serve_bl8": dict(H=16, Hkv=16),
              "serve_bl12_scalar": dict(H=16, Hkv=16, block_len=12,
                                        n_blocks=43),
              "gqa_bl8": dict(H=16, Hkv=4)}
    readings = {}
    for label, kw in shapes.items():
        c = _paged_case(torch, gen, **common, **kw)
        bl = c["block_len"]
        check_r, args = check_paged(torch, c, f"fp16 {label}")
        # the control: the plain version in fp32 (p not rounded to fp16),
        # its output rounded once, held to the same rule against the fp16
        # plain version. It must fail the rule, or the rule cannot tell a
        # kernel that skipped the p rounding.
        control = half_readings(
            torch, paged_attention_plain(*(t.float() for t in args[:3]),
                                         *args[3:]).half(),
            paged_attention_plain(*args), ulp_fp16, FP16_PA_ULPS)
        check(control["max_excess_over_2ulp"] > FP16_PA_ATOL
              or control["share_over_1ulp"] > FP16_PA_SHARE,
              f"paged attention fp16 {label}: the no-rounding control "
              f"{control} passes the FP16_PA_* rule")
        check(_equal_runs(torch, lambda: (paged_attention_cuda(*args),)),
              f"paged attention fp16 {label}: two runs differ")
        slabs = [args[1:3]] + [(args[1].clone(), args[2].clone())
                               for _ in range(L2_COPIES - 1)]
        ms, call_ms = time_cuda([
            partial(paged_attention_cuda, args[0], k, v, *args[3:])
            for k, v in slabs])
        plain_ms, _ = time_cuda([partial(paged_attention_plain, *args)],
                                per_rep=1, warmup=1)
        q, ks, vs, mask = _sdpa_inputs(torch, c)
        lib_kv = [(ks, vs)] + [(ks.clone(), vs.clone())
                               for _ in range(L2_COPIES - 1)]
        lib_ms, _ = time_cuda([
            partial(F.scaled_dot_product_attention, q, k, v, attn_mask=mask,
                    scale=args[-1]) for k, v in lib_kv])
        n_bytes, n_ops = _paged_bytes_ops(c)
        bound, by = bound_ms(n_bytes, n_ops, "float16")
        readings[label] = dict(
            route=paged_route(h, bl, 128), max_abs_err=check_r[
                "max_abs_err"], checks=check_r, no_rounding_control=control,
            tol=f"fp16: each element within {FP16_PA_ULPS} fp16 ulps + "
                f"{FP16_PA_ATOL}, at most {FP16_PA_SHARE} of them past one "
                f"ulp (the bf16 rule scaled by the ulp: share x 2^3; atol "
                f"one p flip at p|v|/l = 1)",
            ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound, bound_by=by, bytes=n_bytes, ops=n_ops,
            tflops=n_ops / ms / 1e9, share_of_bound=bound / ms,
            bitwise_runs=2,
            shape=dict(B=8, H=kw["H"], Hkv=kw["Hkv"], Tq=64, D=128,
                       block_len=bl, pages_per_row=c["pages_per_row"],
                       seq_lens=lens, dtype="float16"),
            note="ms and library_ms with the slabs cycled over "
                 f"{L2_COPIES} copies (past L2)")
        del c, args, slabs, q, ks, vs, mask, lib_kv, control
    check(readings["serve_bl8"]["route"] == TENSOR_CORES
          and readings["gqa_bl8"]["route"] == TENSOR_CORES
          and readings["serve_bl12_scalar"]["route"] != TENSOR_CORES,
          "fp16 paged routes: "
          + str({k: r["route"] for k, r in readings.items()}))
    result = dict(readings["serve_bl8"],
                  scalar_route=readings["serve_bl12_scalar"],
                  at_gqa_shape=readings["gqa_bl8"])
    emit({"phase": "kernel", "name": "paged_attention_fp16", **result})
    torch.cuda.empty_cache()
    return {"paged_attention_fp16": result}


def phase_fp16_kernels():
    """Phase 3b' (the note above): {kernel name: reading}."""
    results = fp16_flash_kernels()
    results.update(fp16_layernorm_kernels())
    results.update(fp16_adam_kernel())
    results.update(fp16_paged_kernels())
    return results

# ------------------------------------------------ phase 3c: the optimizer
# Fused Adam against its plain version on the card: bit for bit (tolerance
# 0). Both run _adam_math's operations in one order, each rounded once (the
# kernel uses the explicitly rounded intrinsics, so nothing becomes an FMA;
# PyTorch's elementwise kernels round every operation alike), and bf16
# outputs are one round-to-nearest-even of the same fp32 value. The leaves:
# a ragged n, n < 1024, linear1.weight, the word embedding (lm_head.weight
# is as large) and the Llama train cell's largest, llama2-7b's embedding.
ADAM_LEAVES = {"n2049": 2049, "n1000": 1000,
               "linear1.weight": 2048 * 8192,
               "word_embeddings.weight": 50304 * 2048,
               "llama.embed_tokens.weight": 32000 * 4096}
ADAM_OPS = 16     # fp32 operations an element (_adam_math, either decay)
ADAM_HP = dict(beta1=0.9, beta2=0.95, epsilon=1e-8)


def _adam_leaf(torch, gen, n, pdtype, mdtype, master, gdtype=None):
    """p, g (of p's dtype unless `gdtype`), m1, m2 and the optional fp32
    master of one flat leaf."""
    def r():
        return torch.randn(n, generator=gen, device="cuda")
    p32 = r()
    return dict(p=p32.to(pdtype), g=r().to(gdtype or pdtype),
                m1=(r() * 0.1).to(mdtype),
                m2=(r().abs() * 0.01).to(mdtype),
                master=p32 if master else None)


def adam_scalars(torch, lr=1e-4, step=5):
    """lr, beta1^t and beta2^t as 0-d fp32 tensors on the card."""
    f32 = dict(dtype=torch.float32, device="cuda")
    return (torch.tensor(lr, **f32),
            torch.tensor(ADAM_HP["beta1"] ** step, **f32),
            torch.tensor(ADAM_HP["beta2"] ** step, **f32))


def adam_bytes_ops(n, p_el, m_el, master):
    """Bytes fused Adam must move over a leaf of n elements and its
    operations: g read; m1, m2 and p read and written, except that with a
    master the kernel reads the fp32 master in p's place and writes both."""
    per = p_el + (0 if master else p_el) + p_el + 4 * m_el + (
        8 if master else 0)
    return n * per, n * ADAM_OPS


def check_adam(torch, c, decoupled, label):
    """Kernel against plain version on one leaf, bit for bit. Returns the
    largest |difference| (0 when it passes)."""
    from paddle_tpu_torch.ops.fused_adam import (fused_adam_cuda,
                                                 fused_adam_plain)
    ref = {k: None if v is None else v.clone() for k, v in c.items()}
    kw = dict(ADAM_HP, decoupled=decoupled)
    fused_adam_cuda(c["p"], c["g"], c["m1"], c["m2"], *adam_scalars(torch),
                    0.1, master=c["master"], **kw)
    fused_adam_plain(ref["p"], ref["g"], ref["m1"], ref["m2"],
                     *adam_scalars(torch), 0.1, master=ref["master"], **kw)
    torch.cuda.synchronize()
    worst = 0.0
    for k in ("p", "m1", "m2", "master"):
        if c[k] is None:
            continue
        check(bool(torch.isfinite(c[k].float()).all()),
              f"fused_adam {label}: non-finite {k}")
        d = float((c[k].float() - ref[k].float()).abs().max())
        worst = max(worst, d)
        check(torch.equal(c[k], ref[k]),
              f"fused_adam {label}: {k} is not bit-equal to the plain "
              f"version (max |kernel - plain| = {d})")
    return worst


def check_adam_flag(torch, gen):
    """The kernel's do_update flag (the strategy step's skipped update):
    flag False leaves p, m1, m2 (and a master) bit for bit as they were,
    flag True and a null flag give the same bits; through AdamW a skipped
    step also keeps both beta powers, so apply, skip, apply equals apply,
    apply bit for bit. Returns the readings."""
    from paddle_tpu_torch.ops.fused_adam import fused_adam_cuda
    from paddle_tpu_torch.optimizer import AdamW
    f32, bf = torch.float32, torch.bfloat16
    kw = dict(ADAM_HP, decoupled=True)
    out = {}
    for name, (pd, md, master) in {"fp32": (f32, f32, False),
                                   "bf16_master": (bf, bf, True),
                                   "fp16_master": (torch.float16, f32,
                                                   True)}.items():
        c = _adam_leaf(torch, gen, ADAM_LEAVES["linear1.weight"], pd, md,
                       master)
        runs = {}
        for flag in (None, True, False):
            d = {k: None if v is None else v.clone() for k, v in c.items()}
            f = None if flag is None else torch.tensor(flag, device="cuda")
            fused_adam_cuda(d["p"], d["g"], d["m1"], d["m2"],
                            *adam_scalars(torch), 0.1, master=d["master"],
                            do_update=f, **kw)
            runs[flag] = d
        torch.cuda.synchronize()
        for k in ("p", "m1", "m2", "master"):
            if c[k] is None:
                continue
            check(torch.equal(runs[False][k], c[k]),
                  f"fused_adam flag 0 ({name}) changed {k}")
            check(torch.equal(runs[True][k], runs[None][k]),
                  f"fused_adam flag 1 and null flag differ in {k} ({name})")
            check(not torch.equal(runs[True][k], c[k]),
                  f"fused_adam flag 1 ({name}) left {k} unchanged")
        out[name] = "flag 0 unchanged, flag 1 == null"
        del c, runs
    # the optimizer's gate: the beta powers' advance too
    n = ADAM_LEAVES["linear1.weight"]
    w = torch.nn.Parameter(torch.randn(n, generator=gen, device="cuda"))
    twin = torch.nn.Parameter(w.detach().clone())
    g = torch.randn(n, generator=gen, device="cuda")
    opt = AdamW(learning_rate=1e-4, parameters=[w])
    ref = AdamW(learning_rate=1e-4, parameters=[twin])
    opt.apply_gradients([(w, g)])
    snap = {k: v.clone() for k, v in opt.state[w].items()}
    w0 = w.detach().clone()
    opt.apply_gradients([(w, g)], do_update=torch.tensor(False,
                                                         device="cuda"))
    torch.cuda.synchronize()
    check(torch.equal(w.detach(), w0) and all(
        torch.equal(v, snap[k]) for k, v in opt.state[w].items()),
        "a skipped AdamW step changed the weight, a moment or a beta power")
    opt.apply_gradients([(w, g)], do_update=torch.tensor(True,
                                                         device="cuda"))
    for _ in range(2):
        ref.apply_gradients([(twin, g)])
    torch.cuda.synchronize()
    check(torch.equal(w.detach(), twin.detach()) and all(
        torch.equal(v, ref.state[twin][k]) for k, v in opt.state[w].items()),
        "apply, skip, apply differs from apply, apply")
    out["adamw_apply_skip_apply"] = "bit-equal to apply, apply"
    return out


def phase_adam_kernel():
    """Fused Adam against its plain version over ADAM_LEAVES in every dtype
    the path takes (p and g bf16 or fp32; moments fp32 or bf16; a master
    weight), decoupled or not; then timed at the largest leaf with the
    train cell's dtypes (bf16 p and g, fp32 moments) and the recipe's (bf16
    moments), beside its plain version and torch._fused_adamw_."""
    import torch
    from paddle_tpu_torch.ops.fused_adam import (fused_adam_cuda,
                                                 fused_adam_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    f32, bf = torch.float32, torch.bfloat16
    dtypes = {"fp32": (f32, f32, False), "fp32_p_bf16_m": (f32, bf, False),
              "bf16_p_fp32_m": (bf, f32, False), "bf16": (bf, bf, False),
              "bf16_master_fp32_m": (bf, f32, True),
              "bf16_master_bf16_m": (bf, bf, True)}
    cases = {}
    for leaf, n in ADAM_LEAVES.items():
        for dname, (pd, md, master) in dtypes.items():
            for decoupled in (False, True):
                label = f"{leaf} {dname} decoupled={decoupled}"
                c = _adam_leaf(torch, gen, n, pd, md, master)
                cases[label] = check_adam(torch, c, decoupled, label)
                del c
    torch.cuda.empty_cache()
    emit({"phase": "kernel_checks", "name": "fused_adam", "cases": cases})

    n = ADAM_LEAVES["word_embeddings.weight"]
    readings = {}
    for cfg, md in (("train", f32), ("recipe", bf)):
        c = _adam_leaf(torch, gen, n, bf, md, False)
        sc = adam_scalars(torch)
        args = (c["p"], c["g"], c["m1"], c["m2"], *sc, 0.1)
        kw = dict(ADAM_HP, decoupled=True)
        # a leaf of 1.4-2.3 GB is far past the 50 MB L2: every call cold
        ms, call_ms = time_cuda([partial(fused_adam_cuda, *args, **kw)])
        plain_ms, _ = time_cuda([partial(fused_adam_plain, *args, **kw)],
                                per_rep=2)
        n_bytes, n_ops = adam_bytes_ops(n, 2, md.itemsize, False)
        bound, by = bound_ms(n_bytes, n_ops, "float32")
        readings[cfg] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, bytes=n_bytes,
                             ops=n_ops, shape=dict(n=n, p="bfloat16",
                                                   g="bfloat16",
                                                   moments=str(md)[6:]))
        del c, args
    # the library yardstick: torch._fused_adamw_ (torch.optim.AdamW's
    # fused=True path) on the same leaf, all four tensors bf16: it takes
    # one dtype for p, g and the moments
    lib = [torch.randn(n, generator=gen, device="cuda").to(bf)
           for _ in range(4)]
    lib[3].abs_()
    steps = [torch.tensor(5.0, device="cuda")]
    lib_ms, _ = time_cuda([partial(
        torch._fused_adamw_, [lib[0]], [lib[1]], [lib[2]], [lib[3]], [],
        steps, lr=1e-4, beta1=ADAM_HP["beta1"], beta2=ADAM_HP["beta2"],
        weight_decay=0.1, eps=ADAM_HP["epsilon"], amsgrad=False,
        maximize=False)])
    del lib
    torch.cuda.empty_cache()
    flag = check_adam_flag(torch, gen)
    c = _adam_leaf(torch, gen, n, bf, f32, False)
    on = torch.tensor(True, device="cuda")
    flag["ms_with_flag_true"], _ = time_cuda([partial(
        fused_adam_cuda, c["p"], c["g"], c["m1"], c["m2"],
        *adam_scalars(torch), 0.1, do_update=on, decoupled=True,
        **ADAM_HP)])
    flag["ms_null_flag"] = readings["train"]["ms"]
    del c
    torch.cuda.empty_cache()
    emit({"phase": "kernel_checks", "name": "fused_adam_do_update",
          **flag})
    # the main path's reading is the recipe's (bf16 moments); the train
    # phase's fp32 moments beside it
    result = dict(
        max_abs_err=max(cases.values()),
        tol="0: bit for bit against the plain version on the card, every "
            "dtype, master and decay case",
        **readings["recipe"], library_ms=lib_ms,
        at_train_dtypes=readings["train"], do_update_flag=flag,
        note="library_ms: torch._fused_adamw_ on the same leaf with bf16 p, "
             "g and moments (14 bytes an element, as the recipe's dtypes)")
    emit({"phase": "kernel", "name": "fused_adam", **result})
    return {"fused_adam": result}


# ---------------------------------- phase 3d: the mask and dropout variants
# The additive-mask and dropout variants of the flash forward, dq and dk/dv
# at gpt3-1.3b's attention width ([4, 16, 1024, 128] bf16), each against
# its plain version under the training kernels' rule (fp32 cases at
# [2, 4, 256, 64] under the fp32 flash limits), the device keep-mask
# against its plain twin bit for bit, then driven through the entry points
# (scaled_dot_product_attention, [B, S, H, D]) with the launch counts
# zeroed just before and read just after, and timed.
VARIANT_LENGTHS = (1024, 777, 512, 129)   # case a's valid keys a row
VARIANT_P = 0.1
VARIANT_SEED = 0x5EED0F1A5                # above 2**32: both key words
VARIANT_CASES = {  # mask, causal, dropout p; "plain": the reference's rule
    "a": ("padding", False, 0.0), "b": ("padding", True, 0.0),
    "c": ("normal_bf16_per_head", False, 0.0), "d": ("normal_3d", False, 0.0),
    "e": (None, True, VARIANT_P), "f": ("padding", True, VARIANT_P)}
# the cases the fp16 instantiations of the variants run (pure-fp16 training)
VARIANT_FP16_CASES = "abe"
# case f's dmask: the plain reference run in bf16 rounds p, dp and out to
# bf16 once each on the way; four bf16 ulps at the largest |dmask| (2^-6
# of it) bound what that rounding can move an element
VARIANT_DMASK_PLAIN_REL = 2.0 ** -6


def padding_mask(torch, lengths, S, device="cuda"):
    """Key padding as an additive mask [B, 1, S, S] fp32: 0 on the first
    lengths[b] keys, -inf past them."""
    cols = torch.arange(S, device=device)
    lens = torch.tensor(lengths, device=device)
    m = torch.where(cols[None, :] < lens[:, None], 0.0, float("-inf"))
    return m[:, None, None, :].expand(len(lengths), 1, S, S).contiguous()


def _variant_mask(torch, gen, kind, B, H, S):
    if kind == "padding":
        return padding_mask(torch, VARIANT_LENGTHS[:B], S)
    if kind == "normal_bf16_per_head":
        return torch.randn(B, H, S, S, generator=gen,
                           device="cuda").bfloat16()
    if kind == "normal_3d":
        return torch.randn(B, S, S, generator=gen, device="cuda")
    return None


def variant_bytes_ops(B, H, S, D, causal, el, mask_rows):
    """flash_bytes_ops of the plain kernels plus the fp32 mask each
    variant reads once: of each of its rows ([rows, Sq, Sk]), the entries
    of the visible pairs only (a causal function needs none above the
    diagonal); dropout adds no bytes, and its Philox (integer work on the
    CUDA cores) is not counted in the operations, which stay the products
    on the tensor cores."""
    bo = flash_bytes_ops(B, H, S, S, D, causal, el)
    extra = mask_rows * visible_pairs(S, S, causal) * 4
    return {k: (b + extra, o) for k, (b, o) in bo.items()}


def check_variant(torch, q, k, v, g, causal, mask, p, seed, label):
    """The variant kernels against their plain versions on one case, as
    check_flash does. Returns (readings, (out, lse, dq, dk, dv))."""
    from paddle_tpu_torch.ops.attention import (dropout_keep_mask,
                                                flash_attention_delta,
                                                flash_bwd_dkv_cuda,
                                                flash_bwd_dq_cuda,
                                                flash_bwd_plain,
                                                flash_fwd_cuda,
                                                flash_fwd_plain)
    B, H, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    keep = dropout_keep_mask(seed, B, H, S, S, p, "cuda") if p else None
    out, lse = flash_fwd_cuda(q, k, v, causal, scale, mask, p, seed)
    delta = flash_attention_delta(g, out)
    dq = flash_bwd_dq_cuda(q, k, v, g, lse, delta, causal, scale, mask, p,
                           seed)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, g, lse, delta, causal, scale, mask,
                                p, seed)
    torch.cuda.synchronize()
    got = (out, lse, dq, dk, dv)
    for t, n in zip(got, ("out", "lse", "dq", "dk", "dv")):
        check(bool(torch.isfinite(t.float()).all()),
              f"flash variant {label}: non-finite {n}")
    ref_out, ref_lse = flash_fwd_plain(q, k, v, causal, scale, mask, keep, p)
    ref_b = flash_bwd_plain(q, k, v, g, lse, delta, causal, scale, mask,
                            keep, p)
    readings = {"lse": _check_close(torch, lse, ref_lse, 1e-5,
                                    f"flash variant {label} lse")}
    if q.dtype == torch.float32:
        readings["out"] = _check_close(torch, out, ref_out, 1e-5,
                                       f"flash variant {label} out")
        for n, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref_b):
            readings[n] = _check_close(torch, a, r, 1e-4,
                                       f"flash variant {label} {n}")
        return readings, got
    f32 = [t.float() for t in (q, k, v, g)]
    ref32_out, _ = flash_fwd_plain(*f32[:3], causal, scale, mask, keep, p)
    ref32_b = flash_bwd_plain(*f32, lse, delta, causal, scale, mask, keep, p)
    readings["out"] = _check_bf16(torch, out, ref_out, ref32_out,
                                  f"flash variant {label} out")
    for n, a, r, r32 in zip(("dq", "dk", "dv"), (dq, dk, dv), ref_b,
                            ref32_b):
        readings[n] = _check_bf16(torch, a, r, r32,
                                  f"flash variant {label} {n}")
    return readings, got


def _sdpa_masked_bwd_call(torch, F, q, k, v, g, **kw):
    """One backward of F.scaled_dot_product_attention(**kw) on a graph
    built once (dq, dk and dv together)."""
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qr, kr, vr, **kw)
    return partial(torch.autograd.grad, out, (qr, kr, vr), g,
                   retain_graph=True)


def _sdpa_fwd_bwd_call(torch, sdpa, copy, causal, mask):
    """One forward + backward of the port's scaled_dot_product_attention
    on `copy` (q, k, v, g [B, H, S, D], passed as [B, S, H, D] views)."""
    q, k, v, g = (t.transpose(1, 2) for t in copy)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def run():
        o = sdpa(*leaves, attn_mask=mask, is_causal=causal, training=True)
        torch.autograd.grad(o, leaves, g)
    return run


def time_variants(torch, copies, masks, cases, prefix):
    """Phase 3d's timing at [4,16,1024,128] in the dtype of `copies` (two
    copies of q, k, v, g, cycled so a call finds its 67 MB of inputs out of
    L2): cases a (mask), b (mask, causal) and e (dropout, causal) of
    `cases` (keys prefix + letter), each beside the kernel without the
    variant, its plain version and one library call. Returns {kernel
    name: reading}, the names suffixed "_fp16" for fp16."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.ops.attention import (dropout_keep_mask,
                                                flash_attention_delta,
                                                flash_bwd_dkv_cuda,
                                                flash_bwd_dq_cuda,
                                                flash_bwd_plain,
                                                flash_fwd_cuda,
                                                flash_fwd_plain)
    q, k, v, g = copies[0]
    B, H, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    half = q.dtype == torch.float16
    dname = str(q.dtype)[6:]
    short, factor, atol = (("fp16", FP16_TRAIN_FACTOR, FP16_TRAIN_ATOL)
                           if half else
                           ("bf16", BF16_TRAIN_FACTOR, BF16_TRAIN_ATOL))
    results = {}
    for c in "abe":
        _, causal, p = VARIANT_CASES[c]
        mask = masks[c]
        fwd_outs = [flash_fwd_cuda(cq, ck, cv, causal, scale, mask, p,
                                   VARIANT_SEED) for cq, ck, cv, _ in copies]
        deltas = [flash_attention_delta(cg, o) for (_, _, _, cg), (o, _)
                  in zip(copies, fwd_outs)]
        t = {"flash_fwd": time_cuda([
            partial(flash_fwd_cuda, cq, ck, cv, causal, scale, mask, p,
                    VARIANT_SEED) for cq, ck, cv, _ in copies])}
        t["flash_bwd_dq"] = time_cuda([
            partial(flash_bwd_dq_cuda, cq, ck, cv, cg, lse, dl, causal, scale,
                    mask, p, VARIANT_SEED)
            for (cq, ck, cv, cg), (_, lse), dl in zip(copies, fwd_outs,
                                                      deltas)])
        t["flash_bwd_dkv"] = time_cuda([
            partial(flash_bwd_dkv_cuda, cq, ck, cv, cg, lse, dl, causal,
                    scale, mask, p, VARIANT_SEED)
            for (cq, ck, cv, cg), (_, lse), dl in zip(copies, fwd_outs,
                                                      deltas)])
        # the same kernels without the variant
        base = {"flash_fwd": time_cuda([
            partial(flash_fwd_cuda, cq, ck, cv, causal, scale)
            for cq, ck, cv, _ in copies])[0]}
        base["flash_bwd_dq"] = time_cuda([
            partial(flash_bwd_dq_cuda, cq, ck, cv, cg, lse, dl, causal,
                    scale) for (cq, ck, cv, cg), (_, lse), dl
            in zip(copies, fwd_outs, deltas)])[0]
        base["flash_bwd_dkv"] = time_cuda([
            partial(flash_bwd_dkv_cuda, cq, ck, cv, cg, lse, dl, causal,
                    scale) for (cq, ck, cv, cg), (_, lse), dl
            in zip(copies, fwd_outs, deltas)])[0]
        keep_c = (dropout_keep_mask(VARIANT_SEED, B, H, S, S, p, "cuda")
                  if p else None)
        lse0, dl0 = fwd_outs[0][1], deltas[0]
        plain_fwd, _ = time_cuda([partial(flash_fwd_plain, q, k, v, causal,
                                          scale, mask, keep_c, p)],
                                 per_rep=2)
        plain_bwd, _ = time_cuda([partial(flash_bwd_plain, q, k, v, g, lse0,
                                          dl0, causal, scale, mask, keep_c,
                                          p)], per_rep=2)
        if p:
            kw = dict(dropout_p=p, is_causal=True)
        else:
            lib_mask = mask if not causal else torch.where(
                torch.ones(S, S, dtype=torch.bool, device="cuda").tril(),
                mask, float("-inf"))
            kw = dict(attn_mask=lib_mask.to(q.dtype))
        lib_fwd, _ = time_cuda([partial(F.scaled_dot_product_attention, cq,
                                        ck, cv, **kw)
                                for cq, ck, cv, _ in copies])
        lib_bwd, _ = time_cuda([_sdpa_masked_bwd_call(torch, F, *cp, **kw)
                                for cp in copies])
        rows = 0 if p else mask.shape[0]
        bo = variant_bytes_ops(B, H, S, D, causal, 2, rows)
        suffix = ("_dropout" if p else "_mask") + (
            _kernels.FP16_SUFFIX if half else "")
        plain = {"flash_fwd": plain_fwd, "flash_bwd_dq": plain_bwd,
                 "flash_bwd_dkv": plain_bwd}
        read = cases[prefix + c]
        err = {"flash_fwd": read["out"]["err"],
               "flash_bwd_dq": read["dq"]["err"],
               "flash_bwd_dkv": max(read["dk"]["err"], read["dv"]["err"])}
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            n_bytes, n_ops = bo[name]
            bound, by = bound_ms(n_bytes, n_ops, dname)
            reading = dict(
                case=c, max_abs_err=err[name],
                tol=(f"{short}: max error from the fp32 plain version "
                     f"<= {factor} x the {short} plain version's + {atol}; "
                     f"fp32 cases atol=rtol=1e-5 (out, lse), 1e-4 (dq, dk, "
                     f"dv); keep-mask bit for bit"),
                ms=t[name][0], call_ms=t[name][1], plain_ms=plain[name],
                library_ms=lib_fwd if name == "flash_fwd" else lib_bwd,
                without_variant_ms=base[name], bound_ms=bound, bound_by=by,
                bytes=n_bytes, ops=n_ops, tflops=n_ops / t[name][0] / 1e9,
                share_of_bound=bound / t[name][0],
                shape=dict(B=B, H=H, Sq=S, Sk=S, D=D, causal=causal,
                           dtype=dname,
                           mask=None if p else list(mask.shape),
                           dropout_p=p),
                note=(None if name == "flash_fwd" else
                      "plain_ms and library_ms compute dq, dk and dv "
                      "together; library_ms: F.scaled_dot_product_"
                      "attention's backward with " + ", ".join(kw)))
            emit({"phase": "kernel", "name": name + suffix, **reading})
            if c == "b":
                results[name + suffix]["causal_case_b"] = reading
            else:
                results[name + suffix] = reading
        del fwd_outs, deltas, keep_c
    return results


def phase_attention_variants():
    """Phase 3d. Returns ({kernel name: reading}, launch counts of the
    entry-point run)."""
    import torch
    import torch.nn.functional as F
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.core.random import next_seed
    from paddle_tpu_torch.ops import _kernels, scaled_dot_product_attention
    from paddle_tpu_torch.ops.attention import (_attention_reference,
                                                _mask_grad,
                                                dropout_keep_mask,
                                                dropout_keep_mask_cuda,
                                                flash_attention_delta,
                                                flash_bwd_dkv_cuda,
                                                flash_bwd_dq_cuda,
                                                flash_bwd_plain,
                                                flash_fwd_cuda,
                                                flash_fwd_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    B, H, S, D = TRAIN_B, 16, TRAIN_S, 128
    bf = torch.bfloat16
    scale = 1.0 / math.sqrt(D)

    # ---- the keep-mask: device (philox.cuh) against the plain twin
    keep_dev = dropout_keep_mask_cuda(VARIANT_SEED, B, H, S, S, VARIANT_P)
    keep = dropout_keep_mask(VARIANT_SEED, B, H, S, S, VARIANT_P, "cuda")
    check(torch.equal(keep_dev, keep),
          "the device keep-mask differs from dropout_keep_mask")
    n = keep.numel()
    rate = float(keep.float().mean())
    sigma = math.sqrt(VARIANT_P * (1 - VARIANT_P) / n)
    check(abs(rate - (1 - VARIANT_P)) < 5 * sigma,
          f"keep rate {rate} is not within 5 sigma ({sigma}) of "
          f"{1 - VARIANT_P}")
    other = dropout_keep_mask_cuda(VARIANT_SEED + 1, B, H, S, S, VARIANT_P)
    check(not torch.equal(other, keep_dev), "a second seed gave the same "
                                            "keep-mask")
    keep_reading = dict(elements=n, keep_rate=rate, sigma=sigma,
                        bit_equal=True, second_seed_differs=True)
    del keep_dev, keep, other

    # ---- every variant kernel against its plain version
    q, k, v, g = _flash_inputs(torch, gen, B, H, S, S, D, bf)
    masks = {c: _variant_mask(torch, gen, kind, B, H, S)
             for c, (kind, _, _) in VARIANT_CASES.items() if c != "f"}
    masks["f"] = masks["a"]
    cases, outs = {}, {}
    for c in "abcde":
        _, causal, p = VARIANT_CASES[c]
        cases[c], outs[c] = check_variant(
            torch, q, k, v, g, causal, masks[c], p, VARIANT_SEED,
            f"{c} bf16 [4,16,1024,128]")
    gen32 = torch.Generator(device="cuda")
    gen32.manual_seed(SEED + 7)
    t32 = _flash_inputs(torch, gen32, 2, 4, 256, 256, 64, torch.float32)
    pad32 = padding_mask(torch, (256, 129), 256)
    for c in "abe":
        _, causal, p = VARIANT_CASES[c]
        cases[f"fp32_{c}"], _ = check_variant(
            torch, *t32, causal, None if p else pad32, p, VARIANT_SEED,
            f"{c} fp32 [2,4,256,64]")
    del t32, pad32
    # bf16 variants run twice are bit-equal; another seed moves dropout
    for c in "abcde":
        _, causal, p = VARIANT_CASES[c]
        _, again = check_variant(torch, q, k, v, g, causal, masks[c], p,
                                 VARIANT_SEED, f"{c} again")
        for n_, a, b_ in zip(("out", "lse", "dq", "dk", "dv"), outs[c],
                             again):
            check(torch.equal(a, b_), f"flash variant {c} {n_}: two runs "
                                      f"differ")
    moved = flash_fwd_cuda(q, k, v, True, scale, None, VARIANT_P,
                           VARIANT_SEED + 1)[0]
    check(not torch.equal(moved, outs["e"][0]),
          "dropout with another seed gave the same output")
    # dmask through the kernels (case a, mask.requires_grad): _mask_grad
    # on the kernels' lse against the plain versions'
    out_a, lse_a = outs["a"][:2]
    dm = _mask_grad(q, k, v, masks["a"], lse_a, g,
                    flash_attention_delta(g, out_a), False, scale)
    ro, rl = flash_fwd_plain(q, k, v, False, scale, masks["a"])
    dm_plain = _mask_grad(q, k, v, masks["a"], rl, g,
                          flash_attention_delta(g, ro), False, scale)
    f32 = [t.float() for t in (q, k, v, g)]
    ro32, rl32 = flash_fwd_plain(*f32[:3], False, scale, masks["a"])
    dm32 = _mask_grad(*f32[:3], masks["a"], rl32, f32[3],
                      flash_attention_delta(f32[3], ro32), False, scale)
    cases["a"]["dmask"] = _check_bf16(torch, dm, dm_plain, dm32,
                                      "flash variant a dmask")
    del dm, dm_plain, dm32, ro, rl, ro32, rl32
    # the fp16 instantiations of the variants (pure-fp16 training) at cases
    # a, b and e, under the FP16_TRAIN_* rule, run twice bit-equal
    gen16 = torch.Generator(device="cuda")
    gen16.manual_seed(SEED + 16)
    t16 = _flash_inputs(torch, gen16, B, H, S, S, D, torch.float16)
    outs16 = {}
    for c in VARIANT_FP16_CASES:
        _, causal, p = VARIANT_CASES[c]
        cases[f"fp16_{c}"], outs16[c] = check_variant(
            torch, *t16, causal, masks[c], p, VARIANT_SEED,
            f"{c} fp16 [4,16,1024,128]")
        _, again = check_variant(torch, *t16, causal, masks[c], p,
                                 VARIANT_SEED, f"{c} fp16 again")
        check(all(torch.equal(a_, b_) for a_, b_ in zip(outs16[c], again)),
              f"flash variant {c} fp16: two runs differ")
        del again
    emit({"phase": "kernel_checks", "name": "flash_attention_variants",
          "keep_mask": keep_reading, "cases": cases,
          "bitwise_runs": 2, "cases_by_letter": {
              c: dict(mask=m, causal=cz, dropout_p=p)
              for c, (m, cz, p) in VARIANT_CASES.items()}})

    # ---- the entry points, counts zeroed just before and read just after
    bshd = [t.transpose(1, 2) for t in (q, k, v)]     # [B, S, H, D] views
    g_bshd = g.transpose(1, 2)
    ptt.seed(SEED)
    seed_e = next_seed()
    ptt.seed(SEED)
    entry = {}
    _kernels.reset_launch_counts()
    for c in "abcdef":
        _, causal, p = VARIANT_CASES[c]
        leaves = [t.detach().requires_grad_() for t in bshd]
        m = masks[c]
        if c == "f":
            m = m.detach().clone().requires_grad_()
        before = _kernels.launch_counts()
        o = scaled_dot_product_attention(*leaves, attn_mask=m, dropout_p=p,
                                         is_causal=causal, training=True)
        o.backward(g_bshd)
        torch.cuda.synchronize()
        after = _kernels.launch_counts()
        entry[c] = dict(out=o.detach(), grads=[t.grad for t in leaves],
                        dmask=m.grad if c == "f" else None,
                        launched={n_: after[n_] - before[n_]
                                  for n_ in after if after[n_] > before[n_]})
    # fp16 through the same entry point: the variants' fp16 instantiations
    bshd16 = [t.transpose(1, 2) for t in t16[:3]]
    ptt.seed(SEED + 1)
    seed16_e = next_seed()      # case e's: a and b draw none
    ptt.seed(SEED + 1)
    entry16 = {}
    for c in VARIANT_FP16_CASES:
        _, causal, p = VARIANT_CASES[c]
        leaves = [t.detach().requires_grad_() for t in bshd16]
        before = _kernels.launch_counts()
        o = scaled_dot_product_attention(*leaves, attn_mask=masks[c],
                                         dropout_p=p, is_causal=causal,
                                         training=True)
        o.backward(t16[3].transpose(1, 2))
        torch.cuda.synchronize()
        after = _kernels.launch_counts()
        entry16[c] = dict(out=o.detach(), grads=[t.grad for t in leaves],
                          launched={n_: after[n_] - before[n_] for n_ in
                                    after if after[n_] > before[n_]})
    launches = _kernels.launch_counts()
    for c in VARIANT_FP16_CASES:
        kind = "_dropout_fp16" if VARIANT_CASES[c][2] else "_mask_fp16"
        check(entry16[c]["launched"] == {
            k_ + kind: 1 for k_ in ("flash_fwd", "flash_bwd_dq",
                                    "flash_bwd_dkv")},
            f"fp16 case {c} launched {entry16[c]['launched']}")
        ref = (outs16[c] if VARIANT_CASES[c][2] == 0.0 else check_variant(
            torch, *t16, True, None, VARIANT_P, seed16_e,
            "e fp16 at the entry point's seed")[1])
        o, dq_, dk_, dv_ = (entry16[c]["out"], *entry16[c]["grads"])
        check(torch.equal(o.transpose(1, 2), ref[0])
              and torch.equal(dq_.transpose(1, 2), ref[2])
              and torch.equal(dk_.transpose(1, 2), ref[3])
              and torch.equal(dv_.transpose(1, 2), ref[4]),
              f"fp16 case {c}: the entry point differs from its kernels")
    del entry16, bshd16
    for c in "abcd":
        check(entry[c]["launched"] == dict.fromkeys(
            ("flash_fwd_mask", "flash_bwd_dq_mask", "flash_bwd_dkv_mask"), 1),
            f"case {c} launched {entry[c]['launched']}")
    check(entry["e"]["launched"] == dict.fromkeys(
        ("flash_fwd_dropout", "flash_bwd_dq_dropout",
         "flash_bwd_dkv_dropout"), 1),
        f"case e launched {entry['e']['launched']}")
    check(entry["f"]["launched"] == {},
          f"case f (mask and dropout: the plain reference) launched "
          f"{entry['f']['launched']}")
    # a-d through the entry point are the kernels' outputs, bit for bit
    for c in "abcd":
        o, dq_, dk_, dv_ = (entry[c]["out"], *entry[c]["grads"])
        ref = outs[c]
        check(torch.equal(o.transpose(1, 2), ref[0])
              and torch.equal(dq_.transpose(1, 2), ref[2])
              and torch.equal(dk_.transpose(1, 2), ref[3])
              and torch.equal(dv_.transpose(1, 2), ref[4]),
              f"case {c}: the entry point differs from its kernels")
    # e drew its seed from core.random: the kernels at that seed
    want_e = check_variant(torch, q, k, v, g, True, None, VARIANT_P, seed_e,
                           "e at the entry point's seed")[1]
    check(torch.equal(entry["e"]["out"].transpose(1, 2), want_e[0])
          and torch.equal(entry["e"]["grads"][0].transpose(1, 2), want_e[2]),
          "case e: the entry point differs from its kernels at its seed")
    del want_e
    # f: the plain reference with the Philox keep-mask of its seed
    ptt.seed(SEED)
    next_seed()                      # case e's
    seed_f = next_seed()
    keep_f = dropout_keep_mask(seed_f, B, H, S, S, VARIANT_P, "cuda")
    mf = masks["f"].detach().clone().requires_grad_()
    lf = [t.detach().requires_grad_() for t in (q, k, v)]
    of = _attention_reference(*lf, True, scale, mf, VARIANT_P, keep_f)
    of.backward(g)
    check(torch.equal(entry["f"]["out"].transpose(1, 2), of.detach())
          and torch.equal(entry["f"]["dmask"], mf.grad),
          "case f: the entry point is not the plain reference with its "
          "keep-mask")
    m32 = masks["f"].detach().clone().requires_grad_()
    l32 = [t.detach().float().requires_grad_() for t in (q, k, v)]
    o32 = _attention_reference(*l32, True, scale, m32, VARIANT_P, keep_f)
    o32.backward(g.float())
    dm_err = float((mf.grad.float() - m32.grad).abs().max())
    dm_lim = VARIANT_DMASK_PLAIN_REL * float(m32.grad.abs().max())
    check(dm_err <= dm_lim, f"case f dmask is {dm_err} from the fp32 plain "
                            f"reference, limit {dm_lim}")
    cases["f"] = dict(route="plain", dmask_err=dm_err, dmask_limit=dm_lim,
                      out_err=float((of.float() - o32).abs().max().detach()))
    del of, o32, mf, m32, lf, l32, keep_f, entry
    emit({"phase": "attention_variants", "entry": "scaled_dot_product_"
          "attention([B,S,H,D], attn_mask, dropout_p, is_causal, training)",
          "launches": {n_: c for n_, c in launches.items() if c},
          "case_f": cases["f"]})

    # ---- timing at [4,16,1024,128] bf16: cases a (mask), b (mask, causal)
    # and e (dropout, causal), each beside the kernel without the variant
    # and one library call; inputs cycled over two copies (67 MB each)
    copies = [(q, k, v, g), tuple(t.clone() for t in (q, k, v, g))]
    results = time_variants(torch, copies, masks, cases, "")
    copies16 = [t16, tuple(t.clone() for t in t16)]
    results.update(time_variants(torch, copies16, masks, cases, "fp16_"))
    del copies16, t16, outs16
    # the entry point converts a mask to the kernels' fp32 rows once a
    # forward (FlashAttentionFn): forward + backward with the README's
    # key padding [B, 1, 1, Sk] and case c's bf16 per-head mask, each
    # beside the same mask handed over already in that layout
    for name, c, given in (("key_padding_b11s", "a",
                            masks["a"][:, :, :1].contiguous()),
                           ("per_head_bf16", "c", masks["c"])):
        _, causal, _ = VARIANT_CASES[c]
        laid = masks[c].float().contiguous()
        ms = {}
        for how, m in (("given", given), ("laid_out", laid)):
            ms[how] = time_cuda([_sdpa_fwd_bwd_call(
                torch, scaled_dot_product_attention, cp, causal, m)
                for cp in copies])[0]
        results["flash_fwd_mask"][f"entry_{name}"] = dict(
            case=c, mask=list(given.shape), mask_dtype=str(given.dtype)[6:],
            fwd_bwd_ms=ms["given"], laid_out_fwd_bwd_ms=ms["laid_out"],
            conversion_ms=ms["given"] - ms["laid_out"],
            note="scaled_dot_product_attention forward + backward "
                 "([B,S,H,D]); laid_out: the same mask as fp32 [rows, Sq, "
                 "Sk], which the kernels take without a copy")
        del laid
    del copies, masks, outs
    torch.cuda.empty_cache()
    return results, launches


# ---------------------------------------------------------------- phase 4
def _record_steps(engine, prompts, max_new):
    """Drive a SimClock engine to completion, recording every unified
    step's inputs (toks, pos, adv) and its logits (on the CPU)."""
    handles = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    steps = []
    orig = engine._step_logits

    def recording(a):
        lg = orig(a)
        steps.append(((a.toks.copy(), a.pos.copy(), a.adv.copy()),
                      lg.float().cpu()))
        return lg

    engine._step_logits = recording
    try:
        while engine.has_work():
            engine.pump()
    finally:
        engine._step_logits = orig
    for h in handles:
        h.result(0)
    return steps


def model_class(preset):
    """The port's causal-LM class of a preset's family (the Llama-2 presets
    are named llama*, as bench.py tells them apart)."""
    if preset.startswith("llama"):
        from paddle_tpu_torch.models.llama import LlamaForCausalLM
        return LlamaForCausalLM
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    return GPTForCausalLM


def preset_config(preset):
    """The config a preset names, from its family's preset table."""
    from paddle_tpu_torch.models import GPT_PRESETS, LLAMA_PRESETS
    return (LLAMA_PRESETS if preset.startswith("llama")
            else GPT_PRESETS)[preset]


def served_kernels(preset, dtype="bfloat16"):
    """(kernels a served step of the preset's family must launch, kernels
    it must not): GPT's LayerNorms run the port's LayerNorm kernel,
    Llama's RMSNorms are plain torch, as in the JAX package. A model in
    fp16 launches the fp16 instantiations and none of the others."""
    if preset.startswith("llama"):
        return ("paged_attention",), ("layernorm_fwd", "layernorm_bwd")
    if dtype == "float16":
        return (tuple(k + "_fp16" for k in SERVE_KERNELS),
                SERVE_KERNELS + ("layernorm_bwd",))
    return SERVE_KERNELS, ()


def _twins(preset, seed, layers=2, **overrides):
    """(CPU model, card model) of `preset` cut to `layers` layers, fp32,
    with the same weights drawn on the CPU from `seed`."""
    import torch
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    cls = model_class(preset)
    over = dict(num_hidden_layers=layers, **overrides)
    cpu = cls.from_preset(preset, device="cpu", dtype="float32",
                          generator=gen, **over)
    card = cls.from_preset(preset, device="cuda", dtype="float32", **over)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


# the model phases: the preset whose widths they run, cut to 2 layers
MODEL_PHASES = {"model": "gpt3-1.3b", "llama_model": "llama2-7b"}


def phase_model(phase="model"):
    """The MODEL_PHASES preset's widths cut to 2 layers (a depth cut),
    fp32: the engine's unified steps on the card, with the CUDA kernels,
    replayed step by step on a CPU twin with the same weights and the
    plain versions. Each step feeds both sides the same rows, so a
    near-tie that flips one greedy token cannot make later steps
    diverge."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    preset = MODEL_PHASES[phase]
    cpu, card = _twins(preset, SEED)
    vocab = preset_config(preset).vocab_size
    rng = np.random.RandomState(SEED)
    # 8 slots: two prompts longer than one 64-wide chunk, the rest shorter,
    # so the steps mix prefill chunks with decode rows
    plens = (100, 5, 130, 30, 12, 64, 7, 45)
    prompts = [rng.randint(0, vocab, (n,)).astype(np.int32) for n in plens]
    cfg = LLMEngineConfig(num_slots=8, block_len=8, n_blocks=64,
                          prefill_chunk=64)
    launches0 = _kernels.launch_counts()
    steps = _record_steps(LLMEngine(card, cfg, clock=SimClock()), prompts, 4)
    launched = {k: v - launches0[k] for k, v in
                _kernels.launch_counts().items()}
    must, must_not = served_kernels(preset)
    check(all(launched[k] > 0 for k in must)
          and not any(launched[k] for k in must_not),
          f"card engine launched {launched}: want each of {must}, none of "
          f"{must_not}")
    twin = LLMEngine(cpu, cfg, clock=SimClock())
    # fp32 on both sides (TF32 off): GEMMs with K up to 11008 summed in
    # another order on the card and the CPU move logits of magnitude ~1 by
    # ~1e-5; 1e-3 leaves room and still catches any real kernel fault
    tol = 1e-3
    worst = 0.0
    real_cols = equal_cols = 0
    for (toks, pos, adv), lg_card in steps:
        lg_cpu = twin._step_logits(twin._step_args(toks, pos, adv)).float()
        check(bool(torch.isfinite(lg_card).all()),
              "non-finite logits on the card")
        worst = max(worst, float((lg_card - lg_cpu).abs().max()))
        for r in range(len(adv)):
            n = int(adv[r])
            a = lg_card[r, :n].argmax(-1)
            b = lg_cpu[r, :n].argmax(-1)
            real_cols += n
            equal_cols += int((a == b).sum())
    ad_worst, ad_moved = lora_forward_diff(cpu, card, vocab)
    emit({"phase": phase, "config": f"{preset} widths, 2 layers, fp32",
          "steps": len(steps), "logits_max_abs_diff": worst, "tol": tol,
          "greedy_tokens_equal": equal_cols, "greedy_tokens": real_cols,
          "kernel_launches": launched,
          "adapted_logits_max_abs_diff": ad_worst,
          "adapted_rows_moved_from_base": ad_moved})
    check(worst <= tol, f"card vs CPU logits differ by {worst} > {tol}")
    check(ad_worst <= tol, f"adapted forward: card vs CPU logits differ by "
          f"{ad_worst} > {tol}")
    check(ad_moved[0] == 0.0 and min(ad_moved[1:]) > tol,
          f"adapted forward: rows moved from base by {ad_moved}")
    del cpu, card, twin, steps
    gc.collect()
    torch.cuda.empty_cache()


def lora_forward_diff(cpu, card, vocab, rows=(0, 1, 2, 3), S=48):
    """The cached forward with `adapters=` on both twins: banks of rank
    LORA_RANK holding the same three synthetic adapters, a batch whose
    rows ride bank rows `rows` (0: base) over S prompt tokens. Returns
    (max |card - CPU| of the adapted logits, each row's max |adapted -
    unadapted| on the card)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.serving.llm.lora import AdapterBank
    ids = np.random.RandomState(SEED + 50).randint(
        0, vocab, (len(rows), S)).astype(np.int32)
    outs = []
    for m in (cpu, card):
        bank = AdapterBank(m, max_adapters=3, rank=LORA_RANK,
                           num_slots=len(rows))
        for i in (1, 2, 3):
            bank.load(f"ad{i}", lora_tree(m, SEED + 50 + i))
        x = torch.from_numpy(ids).to(m.device)
        with torch.no_grad():
            lg, _ = m.forward_with_cache(x, m.init_cache(len(rows), S), 0,
                                         adapters=bank.args_for_rows(rows))
        outs.append(lg.float().cpu())
    with torch.no_grad():
        base, _ = card.forward_with_cache(x, card.init_cache(len(rows), S), 0)
    base = base.float().cpu()
    moved = [float((outs[1][r] - base[r]).abs().max())
             for r in range(len(rows))]
    return float((outs[1] - outs[0]).abs().max()), moved


def _train_steps(model, device, chunk, steps, recipe=False):
    """`steps` steps of `model` through ScanTrainStep over `chunk`: AdamW
    (lr TRAIN_PARITY_LR, wd 0.01, global-norm clip 1.0) or, with `recipe`,
    the train recipe's optimizer peaking at TRAIN_PARITY_LR. Returns (the
    [K] losses on the CPU, the lr vector the steps used)."""
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ScanTrainStep
    if recipe:
        opt = recipe_optimizer(model.parameters(), TRAIN_PARITY_LR)
    else:
        opt = AdamW(learning_rate=TRAIN_PARITY_LR, weight_decay=0.01,
                    parameters=model.parameters(),
                    grad_clip=ClipGradByGlobalNorm(1.0))
    step = ScanTrainStep(model, opt, scan_steps=steps, device=device)
    return step(*chunk).cpu(), step.lr_vector


# train parity, card against a CPU twin, fp32 (TF32 off). Losses: GEMMs
# with K up to 11008 and the cross-entropy over the vocabulary (GPT's
# chunked 50304 columns, Llama's full 32000) summed in another order move
# a loss of ~11 by ~1e-5; 1e-4 leaves room. Weights:
# Adam normalises each gradient, so where a gradient is near 0 the two
# sides' rounding can flip its sign and move that element's update by up
# to 2 x lr a step: the largest difference may reach 2 x lr x K over K steps,
# but such elements are rare; at most TRAIN_PARITY_SHARE of the elements
# may differ by more than lr / 10. Adam's update barely depends on a
# gradient's size, so the weights cannot see a gradient scaled by a
# constant: the first step's gradient norm of every leaf, before the clip,
# is held to rtol TRAIN_PARITY_GRAD_RTOL as well. fp32 sums taken in
# another order move a norm by ~1e-7 of itself (PERF.md); a kernel that
# returned 2*dk or dq/2 would move its leaves' norms by far more than
# 1e-4.
TRAIN_PARITY_LR = 1e-4
TRAIN_PARITY_LOSS_TOL = 1e-4
TRAIN_PARITY_SHARE = 1e-3
TRAIN_PARITY_GRAD_RTOL = 1e-4


def _grad_norms(model, device, ids, labels):
    """{parameter name: fp32 norm of its gradient} of one forward and
    backward of `model` on (ids, labels), before any clip; the gradients
    are dropped again and the weights are left as they were."""
    import torch
    from paddle_tpu_torch.parallel import make_compute_loss
    loss = make_compute_loss(model)(torch.from_numpy(ids).to(device),
                                    torch.from_numpy(labels).to(device))
    loss.backward()
    norms = {}
    for name, p in model.named_parameters():
        if p.requires_grad:
            # in fp64: an fp32 norm over a 12.6 M-element leaf on the CPU
            # is itself off by ~5e-4 of the result
            norms[name] = float(p.grad.double().norm())
            p.grad = None
    return norms


def launches_per_step(n_layers, leaves, recompute, layer_norms=True):
    """Kernel launches one train step of a model with `n_layers` layers and
    `leaves` parameters must make: a flash forward a layer, twice with
    recompute (the backward reruns the layer); one dq and one dk/dv a
    layer; one fused Adam a leaf. With `layer_norms` (GPT) also two
    LayerNorm forwards a layer, twice with recompute, plus the final
    LayerNorm, and two LayerNorm backwards a layer plus the final one;
    Llama's RMSNorms launch none."""
    f = 2 if recompute else 1
    ln = 1 if layer_norms else 0
    return {"flash_fwd": n_layers * f, "flash_bwd_dq": n_layers,
            "flash_bwd_dkv": n_layers,
            "layernorm_fwd": ln * (2 * n_layers * f + 1),
            "layernorm_bwd": ln * (2 * n_layers + 1), "fused_adam": leaves}


# the train parity phases: the preset whose widths they run, cut to 2
# layers, and their optimizers (AdamW, and for GPT the train recipe's)
MODEL_TRAIN_PHASES = {"model_train": ("gpt3-1.3b", (False, True)),
                      "llama_model_train": ("llama2-7b", (False,)),
                      "moe_model": ("ernie-moe-base", (False,))}
# their batch, B x S (moe_model: T = 512 tokens, 160 slots an expert;
# llama_model_train one row, was 2: its CPU twin is most of the phase, and
# the room goes to multirank_train)
MODEL_TRAIN_BATCH = {"moe_model": (2, 256), "llama_model_train": (1, 128)}
# their depth where it is not 2 layers: gpt3-1.3b's and llama2-7b's widths
# at 1 layer (their CPU twins' steps over the full-width embedding and
# the layers are most of the phase; one layer keeps every kernel and check
# and leaves the script's time for spec_serve)
MODEL_TRAIN_LAYERS = {"model_train": 1, "llama_model_train": 1}


def phase_model_train(phase="model_train"):
    """The MODEL_TRAIN_PHASES preset's widths cut to 2 layers (a depth
    cut; MODEL_TRAIN_LAYERS where it says otherwise), fp32, B=2, S=128
    (MODEL_TRAIN_BATCH where it says otherwise):
    K = 2 steps through ScanTrainStep on the card
    (kernels) and on a CPU twin with the same weights (plain versions),
    with AdamW and (GPT) once more with the train recipe (its optimizer at
    TRAIN_PARITY_LR's scale, and recompute): the first step's gradient
    norm of every leaf, per-step losses and the final parameters."""
    import numpy as np
    import torch
    from paddle_tpu_torch.bridge import export_state
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.parallel import stack_batches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    preset, recipes = MODEL_TRAIN_PHASES[phase]
    rng = np.random.RandomState(SEED + 3)
    # K = 2 steps (was 3; the CPU twins' steps are most of the phase: room
    # for frontend_serve), each check kept
    (B, S), K = MODEL_TRAIN_BATCH.get(phase, (2, 128)), 2
    layers = MODEL_TRAIN_LAYERS.get(phase, 2)
    ids = rng.randint(0, preset_config(preset).vocab_size, (B, S)).astype(
        np.int32)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -100                    # ignored tokens on the path
    chunk = stack_batches([(ids, labels)] * K)
    for recipe in recipes:
        cpu, card = _twins(preset, SEED + 3, layers=layers,
                           use_recompute=recipe)
        cpu.train()
        card.train()
        g_card = _grad_norms(card, "cuda", ids, labels)
        g_cpu = _grad_norms(cpu, "cpu", ids, labels)
        grad_rel = {k: abs(g_card[k] - g_cpu[k]) / g_cpu[k] for k in g_cpu}
        worst_grad = max(grad_rel, key=grad_rel.get)
        _kernels.reset_launch_counts()
        loss_card, lr_card = _train_steps(card, "cuda", chunk, K, recipe)
        launched = _kernels.launch_counts()
        t0 = time.perf_counter()
        loss_cpu, lr_cpu = _train_steps(cpu, "cpu", chunk, K, recipe)
        cpu_s = time.perf_counter() - t0
        check(bool(torch.isfinite(loss_card).all()), "non-finite train loss "
                                                     "on the card")
        leaves = sum(p.requires_grad for p in card.parameters())
        want = dict.fromkeys(launched, 0)      # paged attention: none
        want.update({k: v * K for k, v in launches_per_step(
            layers, leaves, recipe,
            layer_norms=not preset.startswith("llama")).items()})
        loss_diff = float((loss_card - loss_cpu).abs().max())
        wc, wp = export_state(card), export_state(cpu)
        worst, far, total = 0.0, 0, 0
        for k in wc:
            d = np.abs(wc[k] - wp[k])
            worst = max(worst, float(d.max()))
            far += int((d > TRAIN_PARITY_LR / 10).sum())
            total += d.size
        what = ("train recipe (schedule, clip, decay filter, bf16 moments, "
                "recompute)" if recipe else "AdamW")
        emit({"phase": phase, "config": f"{preset} widths, {layers} "
              f"layer{'s' if layers > 1 else ''}, fp32, B={B}, S={S}, "
              f"{K} steps, {what}",
              "loss_card": loss_card.tolist(), "loss_cpu": loss_cpu.tolist(),
              "lr_vector": lr_card.tolist(), "loss_max_abs_diff": loss_diff,
              "loss_tol": TRAIN_PARITY_LOSS_TOL,
              "grad_norm_max_rel_diff": grad_rel[worst_grad],
              "grad_norm_worst_leaf": worst_grad,
              "grad_norm_rtol": TRAIN_PARITY_GRAD_RTOL,
              "grad_norm_leaves": len(grad_rel), "param_max_abs_diff": worst,
              "param_tol": 2 * K * TRAIN_PARITY_LR,
              "param_share_past_lr_over_10": far / total,
              "param_share_tol": TRAIN_PARITY_SHARE, "cpu_twin_s": cpu_s,
              "kernel_launches": launched})
        check(launched == want,
              f"train parity ({what}) launched {launched}, want {want}")
        check(np.array_equal(lr_card, lr_cpu),
              f"card and CPU lr vectors differ: {lr_card} vs {lr_cpu}")
        check(grad_rel[worst_grad] <= TRAIN_PARITY_GRAD_RTOL,
              f"card vs CPU first-step gradient norm of {worst_grad} differs "
              f"by {grad_rel[worst_grad]} of itself > "
              f"{TRAIN_PARITY_GRAD_RTOL}")
        check(loss_diff <= TRAIN_PARITY_LOSS_TOL,
              f"card vs CPU train losses ({what}) differ by {loss_diff}")
        check(worst <= 2 * K * TRAIN_PARITY_LR
              and far / total <= TRAIN_PARITY_SHARE,
              f"card vs CPU weights after {K} steps ({what}): max diff "
              f"{worst}, share past lr/10 {far / total}")
        del cpu, card, wc, wp
        gc.collect()
        torch.cuda.empty_cache()


# ------------------------------------------ phase 4c: MoE at one GPU
# ernie-moe-base's widths cut to 2 layers (layer 0 dense, layer 1 MoE with
# 8 experts, top-2, capacity factor 1.25), fp32, B x S = 2 x 256 (T = 512
# tokens, 160 slots an expert), on the card against a CPU twin with the
# same weights. Limits:
# - logits within MOE_LOGITS_TOL, phase 4's limit and reason;
# - the summed aux loss (~1: E · sum_e f_e · p_e) within MOE_AUX_TOL: two
#   fp32 means over 512 tokens summed in another order move it by ~1e-7;
#   one token routed elsewhere moves it by ~1/512 of a gate;
# - the routing: every (token, rank)'s expert, slot and kept flag equal
#   to the CPU's. The router's fp32 logits (768-term sums in another
#   order) may differ by ~1e-7, so a choice between two gates closer than
#   that can flip: a pair whose expert differs is printed with its gate
#   margin on the CPU (its gate minus the next one below it), and passes
#   only if that margin is under MOE_MARGIN_TOL (its slot and those after
#   it in the two experts may then differ too);
# - three AdamW steps as phase 4 holds them (moe_model in
#   MODEL_TRAIN_PHASES).
MOE_PRESET = "ernie-moe-base"
MOE_LOGITS_TOL = 1e-3
MOE_AUX_TOL = 1e-5
MOE_MARGIN_TOL = 1e-6


def route_mismatches(torch, card_route, cpu_route):
    """(pairs whose expert differs as [(token, rank, margin)], slots
    equal, kept flags equal) of two MoELayer.routing records; the margin
    is read on the CPU's gates."""
    e_card, s_card, k_card, _ = (t.cpu() for t in card_route)
    e_cpu, s_cpu, k_cpu, gates = (t.cpu() for t in cpu_route)
    ranked = gates.sort(-1, descending=True).values
    diff = [(t, r, float(ranked[t, r] - ranked[t, r + 1]))
            for t, r in (e_card != e_cpu).nonzero().tolist()]
    return diff, bool(torch.equal(s_card, s_cpu)), \
        bool(torch.equal(k_card, k_cpu))


def phase_moe_model():
    """The forward checks of phase 4c, then its train parity
    (phase_model_train("moe_model"))."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu, card = _twins(MOE_PRESET, SEED + 11)
    layers = [bool(layer.use_moe) for layer in card.gpt.layers]
    check(layers == [False, True], f"moe_model layers {layers}: want a "
                                   "dense layer, then an MoE layer")
    from paddle_tpu_torch.nn.layer.moe import capacity_of
    cfg = preset_config(MOE_PRESET)
    B, S = MODEL_TRAIN_BATCH["moe_model"]
    ids = np.random.RandomState(SEED + 11).randint(0, cfg.vocab_size,
                                                   (B, S))
    _kernels.reset_launch_counts()
    with torch.no_grad():
        h, aux_card = card.gpt(torch.from_numpy(ids).cuda())
        lg_card = card.lm_head(h).float().cpu()
        launched = _kernels.launch_counts()
        h, aux_cpu = cpu.gpt(torch.from_numpy(ids))
        lg_cpu = cpu.lm_head(h)
    check(bool(torch.isfinite(lg_card).all()), "non-finite MoE logits on "
                                               "the card")
    worst = float((lg_card - lg_cpu).abs().max())
    aux_diff = abs(float(aux_card) - float(aux_cpu))
    moe_card, moe_cpu = card.gpt.layers[1].moe, cpu.gpt.layers[1].moe
    diff, slots_equal, kept_equal = route_mismatches(
        torch, moe_card.routing, moe_cpu.routing)
    kept = moe_cpu.routing[2]
    want = {k: 0 for k in launched}
    want.update(flash_fwd=2, layernorm_fwd=5)
    emit({"phase": "moe_model", "config": f"{MOE_PRESET} widths, 2 layers "
          f"(dense, MoE), fp32, B={B}, S={S}, forward",
          "tokens": B * S, "capacity": capacity_of(
              B * S, cfg.moe_top_k, cfg.moe_num_experts,
              cfg.moe_capacity_factor),
          "logits_max_abs_diff": worst, "logits_tol": MOE_LOGITS_TOL,
          "aux_card": float(aux_card), "aux_cpu": float(aux_cpu),
          "aux_abs_diff": aux_diff, "aux_tol": MOE_AUX_TOL,
          "pairs": int(kept.numel()), "dropped_pairs": int((~kept).sum()),
          "expert_mismatches": diff, "margin_tol": MOE_MARGIN_TOL,
          "slots_equal": slots_equal, "kept_equal": kept_equal,
          "kernel_launches": launched})
    check(launched == want, f"MoE forward launched {launched}, want {want}")
    check(worst <= MOE_LOGITS_TOL,
          f"card vs CPU MoE logits differ by {worst}")
    check(aux_diff <= MOE_AUX_TOL,
          f"card vs CPU aux loss differs by {aux_diff}")
    check(all(m < MOE_MARGIN_TOL for _, _, m in diff),
          f"routing differs where the gates are apart: {diff}")
    check(diff or (slots_equal and kept_equal),
          "the experts agree but the slots or kept flags differ")
    del cpu, card, h, lg_card, lg_cpu
    gc.collect()
    torch.cuda.empty_cache()
    phase_model_train("moe_model")


# ------------------------------------------- phase 4d: the optimizers
# Adamax, Adagrad, RMSProp (centered, with momentum), Adadelta,
# DecayedAdagrad, Ftrl, Dpsgd, ProximalAdagrad and ProximalGD: plain
# PyTorch, three steps on the card against the same steps on the CPU from
# the same start, over random fp32 leaves of 1.5 M and 1 M elements.
# Each step is a sequence of elementwise fp32 operations, each correctly
# rounded on both sides, so most elements come out bit-equal. Every
# element of a parameter must lie within OPT_RTOL of itself plus
# OPT_MOVE_SHARE of the largest distance the CPU's leaf moved in the 3
# steps (a wrong formula or operand moves elements by about that whole
# distance; a rehearsal of this phase with both sides on one CPU once saw
# 4% of an Adagrad leaf part by up to 1.3e-4 of its movement, cause
# unknown), and every element of a slot within OPT_RTOL of itself plus
# OPT_MOVE_SHARE of the slot's largest magnitude; int32 slots equal.
# Dpsgd also sums its gradient's squares (another order: ~1e-7 of the
# norm) and draws one normal a leaf a step, whose erf_inv takes torch's
# log1p, which may differ by an ulp between the two: the draw may move by
# DPSGD_NOISE_ULPS ulps of itself, so its parameters get lr · sigma /
# batch_size · that, a step, more.
OPT_LEAVES = {"w": (1024, 1536), "v": (1048583,)}
OPT_STEPS = 3
OPT_RTOL = 1e-6
OPT_MOVE_SHARE = 1e-3
DPSGD_NOISE_ULPS = 4
OPT_CASES = {
    "Adamax": dict(learning_rate=1e-3, weight_decay=0.01),
    "Adagrad": dict(learning_rate=1e-2, weight_decay=0.01,
                    initial_accumulator_value=0.1),
    "RMSProp": dict(learning_rate=1e-3, momentum=0.9, centered=True,
                    weight_decay=0.01),
    "Adadelta": dict(learning_rate=1.0, weight_decay=0.01),
    "DecayedAdagrad": dict(learning_rate=1e-2, weight_decay=0.01),
    "Ftrl": dict(learning_rate=1e-2, l1=1e-3, l2=1e-3),
    "Dpsgd": dict(learning_rate=1e-2, clip=10.0, batch_size=16.0, sigma=1.0,
                  seed=SEED + 14),
    "ProximalAdagrad": dict(learning_rate=1e-2, l1=1e-3, l2=1e-3),
    "ProximalGD": dict(learning_rate=1e-2, l1=1e-3, l2=1e-3),
}


def _opt_steps(torch, cls, kw, p0, grads, device):
    """OPT_STEPS named steps of optimizer `cls` over copies of p0 on
    `device`; returns (params, optimizer)."""
    from paddle_tpu_torch import optimizer as topt
    params = {k: v.to(device).clone() for k, v in p0.items()}
    names = list(params)
    opt = getattr(topt, cls)(parameters=list(params.values()), **kw)
    for g in grads:
        opt.apply_gradients([(params[k], g[k].to(device)) for k in names],
                            names=names)
    if device == "cuda":
        torch.cuda.synchronize()
    return params, opt


def phase_optimizers():
    import torch
    gen = torch.Generator().manual_seed(SEED + 13)
    p0 = {k: torch.randn(s, generator=gen) for k, s in OPT_LEAVES.items()}
    grads = [{k: torch.randn(s, generator=gen)
              for k, s in OPT_LEAVES.items()} for _ in range(OPT_STEPS)]
    rows = {}
    for cls, kw in OPT_CASES.items():
        (pc, oc), (pg, og) = (_opt_steps(torch, cls, kw, p0, grads, d)
                              for d in ("cpu", "cuda"))
        noise = 0.0
        if cls == "Dpsgd":
            # the largest normal a step can draw here is below 8
            noise = OPT_STEPS * kw["learning_rate"] * kw["sigma"] / \
                kw["batch_size"] * DPSGD_NOISE_ULPS * 2.0 ** -20
        worst, worst_share, equal, total, bad = 0.0, 0.0, 0, 0, []
        pairs = [(f"param {k}", pg[k], pc[k],
                  float((pc[k] - p0[k]).abs().max())) for k in pc]
        pairs += [(f"{k}.{s}", og.state[pg[k]][s], oc.state[pc[k]][s],
                   None) for k in pc for s in oc.state[pc[k]]]
        for what, got, ref, moved in pairs:
            got = got.cpu()
            check(got.dtype == ref.dtype, f"{cls} {what}: {got.dtype} on "
                                          f"the card, {ref.dtype} on the CPU")
            if not ref.is_floating_point():
                check(torch.equal(got, ref), f"{cls} {what}: {got} != {ref}")
                continue
            scale = moved if moved is not None else float(ref.abs().max())
            d = (got - ref).abs()
            worst = max(worst, float(d.max()))
            worst_share = max(worst_share, float(d.max()) / max(scale,
                                                                1e-30))
            equal += int((d == 0).sum())
            total += d.numel()
            lim = OPT_RTOL * ref.abs() + OPT_MOVE_SHARE * scale + (
                noise if moved is not None else 0.0)
            if not bool((d <= lim).all()):
                bad.append(what)
        rows[cls] = dict(max_abs_diff=worst,
                         max_diff_over_movement=worst_share,
                         bit_equal_share=equal / total,
                         dpsgd_noise_allowance=noise, slots=sorted(
                             oc.state[pc["w"]]))
        check(not bad, f"{cls}: card vs CPU past the limits in {bad}: "
                       f"{rows[cls]}")
    emit({"phase": "optimizers", "leaves": {k: list(s) for k, s in
                                            OPT_LEAVES.items()},
          "steps": OPT_STEPS, "rtol": OPT_RTOL,
          "move_share": OPT_MOVE_SHARE, "optimizers": rows})


# ------------------------------------------- phase 4b: AMP through a plan
# The strategy step (parallel.parallelize with a DistributedStrategy) at
# gpt3-1.3b's widths cut to 1 layer, fp32 master weights, on the card
# (kernels) against the same code on a CPU twin (plain versions), B=2,
# AdamW lr TRAIN_PARITY_LR, wd 0.01, clip 1.0:
#   a. AMP bf16 with whole-loss recompute and gradient merge k = 2 (avg),
#      B=2, S=64, one ScanTrainStep chunk of 4 micro-steps (two applying
#      steps, so the merge accumulator resets between two applies) at 1
#      layer;
#   b. AMP fp16 with dynamic loss scaling, B=1, S=16, 3 single steps: the
#      first is forced to overflow by an init_loss_scaling of 2^40 (fp16
#      overflows on both sides, whatever the rounding), after which the
#      scale drops by 2^-25 to 32768; the next two are finite, and after
#      the second of them (incr_every_n_steps = 2) it grows to 65536:
#      the first finite step leaves the scale as it is and carries the
#      good-step counter over.
#      The batch is small because the CPU twin runs fp16 slowly on the
#      card's machine: 5 such steps at B=2, S=128 took 900 s there,
#      against 20 s for case a's 4 bf16 steps (on the host of an NVIDIA
#      H100 80GB HBM3); the scaler's decisions do not depend on the
#      batch. 4 steps at B=1, S=32 took 131 s and 3 took 86 s, most of it
#      the CPU's elementwise work over the 310 M parameters.
#   c. pure fp16 (O2): both twins through amp.decorate(level="O2",
#      dtype="float16") (every parameter fp16) and AdamW(multi_precision=
#      True) (fp32 master weights), case b's scaler and batch but growing
#      after every finite step, whole-loss recompute and gradient merge
#      k = 2 (avg), 2 single steps: the overflow (banked as nothing) and
#      an applying step, after which the scale grows to 65536. The
#      launches: the fp16 instantiations of LayerNorm, flash and fused
#      Adam, and none of the fp32 or bf16 LayerNorm and Adam.
# The loss scale, its good and bad counters and the gradient-merge count
# after every call must be EXACTLY equal on both sides (so the same steps
# were skipped and banked). Losses: the card's bf16/fp16 GEMMs (cuBLAS)
# and the CPU's round each product's output once after fp32 sums in
# other orders, so the activations part by about one low-precision ulp
# (bf16 2^-8, fp16 2^-11 of themselves) and a loss of ~11 by about 1e-3
# (bf16) / 1e-4 (fp16): the limits are 2e-2 and 4e-3. O2 also rounds the
# residual stream, the LayerNorm outputs and every other activation to
# fp16 on both sides, at other points: some ten times the roundings of
# O1, so 1e-2.
# Weights: every element within 2 x lr x steps (Adam's step is ~lr, and
# a gradient near 0 may flip its sign on one side), and at most
# AMP_PARITY_SHARE of them more than lr / 2 apart: a wrong cast, scale,
# merge or skip moves most elements. Under O2 that rule holds the fp32
# master weights; each fp16 parameter, one rounding of its master, may
# be one fp16 ulp further.
AMP_PARITY_CASES = {
    "a_bf16_recompute_merge_k2": dict(
        fields={"amp": True, "recompute": True, "gradient_merge": True,
                "gradient_merge_configs": {"k_steps": 2}},
        batch=(2, 64), layers=1, scan=4, calls=1, loss_tol=2e-2),
    "b_fp16_dynamic_scaling_overflow": dict(
        fields={"amp": True, "amp_configs": {
            "dtype": "float16", "init_loss_scaling": 2.0 ** 40,
            "decr_every_n_nan_or_inf": 1, "decr_ratio": 2.0 ** -25,
            "incr_every_n_steps": 2}},
        batch=(1, 16), layers=1, scan=1, calls=3, loss_tol=4e-3,
        scales=(2.0 ** 15, 2.0 ** 15, 2.0 ** 16)),
    "c_fp16_o2_recompute_merge_k2_overflow": dict(
        fields={"amp": True, "amp_configs": {
            "dtype": "float16", "init_loss_scaling": 2.0 ** 40,
            "decr_every_n_nan_or_inf": 1, "decr_ratio": 2.0 ** -25,
            "incr_every_n_steps": 1}, "recompute": True,
            "gradient_merge": True, "gradient_merge_configs": {"k_steps": 2}},
        batch=(1, 8), layers=1, scan=1, calls=2, loss_tol=1e-2,
        level="O2", scales=(2.0 ** 15, 2.0 ** 16)),
}
# the fp16 cases run 1 layer over 16 tokens: their CPU twins' fp16 GEMMs
# run slowly on the CPU and take most of the phase. Case a runs 1 layer
# (was 2) to make room for the LoRA phases (the CPU twins took 25.8 s,
# 44.5 s and 46.5 s with case a at 2 layers, on the host of an NVIDIA
# H100 80GB HBM3), and over 2 x 64 tokens (was 2 x 128) to make room for
# frontend_serve: its 4 micro-steps still apply twice. Case c runs 8 tokens
# (was 16; its fp16 CPU twin took 36.5 s) to make room for multirank_train
AMP_PARITY_SHARE = 1e-2


def amp_strategy(fields, scan):
    """A DistributedStrategy with `fields` (dicts merge into *_configs)
    and scan_steps `scan`."""
    from paddle_tpu_torch.distributed.strategy import DistributedStrategy
    s = DistributedStrategy()
    for k, v in fields.items():
        setattr(s, k, v)
    s.scan_steps = scan
    return s


def _extras_scalars(step):
    return {k: v.item() for k, v in step._extras.items() if k != "accum"}


def _master_state(model, opt):
    """{name: fp32 numpy copy} of the master weights `opt` keeps for
    `model`'s parameters (multi_precision)."""
    return {k: opt.state[p]["master_weight"].cpu().numpy()
            for k, p in model.named_parameters()}


def phase_model_amp():
    import numpy as np
    import torch
    from paddle_tpu_torch.amp import decorate
    from paddle_tpu_torch.bridge import export_state
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import parallelize, stack_batches

    torch.backends.cuda.matmul.allow_tf32 = False
    preset = "gpt3-1.3b"
    lr = TRAIN_PARITY_LR
    for case, c in AMP_PARITY_CASES.items():
        rng = np.random.RandomState(SEED + 12)
        B, S = c["batch"]
        ids = rng.randint(0, preset_config(preset).vocab_size,
                          (B, S)).astype(np.int32)
        labels = np.roll(ids, -1, axis=1)
        labels[:, -1] = -100
        layers = c["layers"]
        cpu, card = _twins(preset, SEED + 12, layers=layers)
        o2 = c.get("level") == "O2"
        runs, opts = {}, {}
        for dev, model in (("cuda", card), ("cpu", cpu)):
            if o2:
                decorate(model, level="O2", dtype="float16")
            model.train()
            opt = opts[dev] = AdamW(learning_rate=lr, weight_decay=0.01,
                                    parameters=model.parameters(),
                                    multi_precision=o2,
                                    grad_clip=ClipGradByGlobalNorm(1.0))
            step = parallelize(model, opt,
                               strategy=amp_strategy(c["fields"], c["scan"]),
                               device=dev)
            batch = (stack_batches([(ids, labels)] * c["scan"])
                     if c["scan"] > 1 else (ids, labels))
            _kernels.reset_launch_counts()
            t0 = time.perf_counter()
            losses, extras = [], []
            for _ in range(c["calls"]):
                losses += np.atleast_1d(step(*batch).cpu().numpy()).tolist()
                extras.append(_extras_scalars(step))
            runs[dev] = dict(losses=losses, extras=extras,
                             launches=_kernels.launch_counts(),
                             seconds=time.perf_counter() - t0)
        steps = len(runs["cuda"]["losses"])
        loss_diff = max(abs(a - b) for a, b in zip(runs["cuda"]["losses"],
                                                   runs["cpu"]["losses"]))
        wc, wp = export_state(card), export_state(cpu)
        half_worst = None
        if o2:
            # the rule holds the masters; each fp16 parameter may be one
            # fp16 ulp past it
            half_worst = max(float((np.abs(wc[k] - wp[k]) - ulp_fp16(
                torch.from_numpy(np.maximum(np.abs(wc[k]), np.abs(wp[k]))))
                .numpy()).max()) for k in wc)
            wc, wp = (_master_state(card, opts["cuda"]),
                      _master_state(cpu, opts["cpu"]))
        worst, far, total = 0.0, 0, 0
        for k in wc:
            d = np.abs(wc[k] - wp[k])
            worst = max(worst, float(d.max()))
            far += int((d > lr / 2).sum())
            total += d.size
        launched = runs["cuda"]["launches"]
        fp16 = c["fields"].get("amp_configs", {}).get("dtype") == "float16"
        emit({"phase": "model_amp", "case": case,
              "config": f"{preset} widths, {layers} layer"
                        + ("s, " if layers > 1 else ", ")
                        + ("fp16 parameters (O2), " if o2 else "")
                        + f"fp32 master weights, B={B}, S={S}, AdamW lr "
                          f"{lr}",
              "strategy": c["fields"], "steps": steps,
              "loss_card": runs["cuda"]["losses"],
              "loss_cpu": runs["cpu"]["losses"],
              "extras_card": runs["cuda"]["extras"],
              "extras_cpu": runs["cpu"]["extras"],
              "loss_max_abs_diff": loss_diff, "loss_tol": c["loss_tol"],
              "param_max_abs_diff": worst, "param_tol": 2 * lr * steps,
              "param_share_past_lr_over_2": far / total,
              "param_share_tol": AMP_PARITY_SHARE,
              "fp16_param_max_diff_past_1ulp": half_worst,
              "cpu_twin_s": runs["cpu"]["seconds"],
              "kernel_launches": launched})
        check(runs["cuda"]["extras"] == runs["cpu"]["extras"],
              f"model_amp {case}: loss scale, counters or merge count "
              f"differ: card {runs['cuda']['extras']}, CPU "
              f"{runs['cpu']['extras']}")
        check(all(math.isfinite(x) for x in runs["cuda"]["losses"]),
              f"model_amp {case}: non-finite loss on the card")
        check(loss_diff <= c["loss_tol"],
              f"model_amp {case}: card vs CPU losses differ by {loss_diff}")
        check(worst <= 2 * lr * steps and far / total <= AMP_PARITY_SHARE,
              f"model_amp {case}: weights differ by {worst} (max), share "
              f"past lr/2 {far / total}")
        check(half_worst is None or half_worst <= 2 * lr * steps,
              f"model_amp {case}: an fp16 weight is {half_worst} past one "
              f"fp16 ulp from the CPU's")
        tc = "_fp16" if fp16 else ""
        o2_tc = tc if o2 else ""       # O1 keeps LayerNorm and Adam fp32
        check(all(launched[k + tc] > 0 for k in ("flash_fwd", "flash_bwd_dq",
                                                 "flash_bwd_dkv"))
              and all(launched[k + o2_tc] > 0 for k in (
                  "fused_adam", "layernorm_fwd", "layernorm_bwd")),
              f"model_amp {case}: kernels not launched: {launched}")
        if o2:
            check(not any(launched[k] for k in ("fused_adam", "layernorm_fwd",
                                                "layernorm_bwd")),
                  f"model_amp {case}: fp32 LayerNorm or Adam launched under "
                  f"O2: {launched}")
        if fp16:
            check(tuple(e["loss_scale"] for e in runs["cuda"]["extras"])
                  == c["scales"],
                  f"model_amp {case}: scale trajectory "
                  f"{runs['cuda']['extras']}, want {c['scales']}")
        del cpu, card, wc, wp, runs, opts
        gc.collect()
        torch.cuda.empty_cache()


# ------------------------------------------ phases 12-13: AMP train cells
# Full gpt3-1.3b in fp32 master weights through parallelize(): AMP O1
# (bf16, or fp16 with dynamic loss scaling at the default
# init_loss_scaling 32768), whole-loss recompute, gradient merge k = 2
# (avg), AdamW lr 1e-4, wd 0.01, fp32 moments, global-norm clip 1.0,
# B x S = 4 x 1024, scan_steps 4: a warm-up chunk, then timed chunks, one
# batch repeated. A micro-step launches exactly AMP_KERNELS_PER_MICRO_STEP
# (the flash kernels in the AMP dtype, the LayerNorms in fp32 on the fp32
# residual stream, fused Adam on applying steps only).
# train_fp16_o2 is Paddle's pure-fp16 recipe on the same cell: the model
# through amp.decorate(level="O2", dtype="float16") (every parameter
# fp16), AdamW(multi_precision=True) (fp32 master weights), the same
# strategy in fp16: every kernel in its fp16 instantiation (the
# LayerNorms see the fp16 residual stream, fused Adam updates fp16
# parameters from their masters), none in fp32 or bf16.
AMP_TRAIN_CELLS = {
    "train_amp": dict(dtype="bfloat16", warmup_chunks=1, timed_chunks=2),
    "train_amp_fp16": dict(dtype="float16", warmup_chunks=1,
                           timed_chunks=1),
    "train_fp16_o2": dict(dtype="float16", level="O2", warmup_chunks=1,
                          timed_chunks=1),
}
AMP_SCAN_STEPS = 4
AMP_MERGE_K = 2
# whole-loss recompute reruns the whole forward in the backward: each
# layer's flash forward and two LayerNorm forwards, and the final
# LayerNorm, twice a micro-step
AMP_KERNELS_PER_MICRO_STEP = {"flash_fwd": 48, "flash_bwd_dq": 24,
                              "flash_bwd_dkv": 24, "layernorm_fwd": 98,
                              "layernorm_bwd": 49}
AMP_ADAM_PER_APPLY = 293


def amp_train_workload(cell):
    """(model, opt, step, ids, labels) of an AMP train cell: gpt3-1.3b in
    fp32 with random weights from SEED (cast to fp16 by amp.decorate at
    level O2), its AdamW (fp32 master weights under O2), the
    parallelize()d step, one batch from SEED. Shared by the phase below
    and anything that profiles the cell."""
    import numpy as np
    import torch
    from paddle_tpu_torch.amp import decorate
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import parallelize
    c = AMP_TRAIN_CELLS[cell]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    model = GPTForCausalLM.from_preset("gpt3-1.3b", device="cuda",
                                       dtype="float32", generator=gen)
    o2 = c.get("level") == "O2"
    if o2:
        decorate(model, level="O2", dtype=c["dtype"])
    model.train()
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters(), multi_precision=o2,
                moment_dtype="float32", grad_clip=ClipGradByGlobalNorm(1.0))
    s = amp_strategy({"amp": True, "amp_configs": {"dtype": c["dtype"]},
                      "recompute": True, "gradient_merge": True,
                      "gradient_merge_configs": {"k_steps": AMP_MERGE_K,
                                                 "avg": True}},
                     AMP_SCAN_STEPS)
    step = parallelize(model, opt, strategy=s)
    rng = np.random.RandomState(SEED + 4)
    vocab = model.config.vocab_size
    ids = rng.randint(0, vocab, (TRAIN_B, TRAIN_S)).astype(np.int32)
    labels = rng.randint(0, vocab, (TRAIN_B, TRAIN_S)).astype(np.int32)
    return model, opt, step, ids, labels


def amp_timed_chunks(step, ids, labels, chunks):
    """Run `chunks` chunks of `step` over (ids, labels) repeated, with a
    CUDA event, the launch counts and (with a loss scale) device copies of
    the scale and its counters after every micro-step. Returns (losses,
    wall s, per-micro-step device ms, per-micro-step launches, per-step
    (scale, good, bad) on the host)."""
    import torch
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.parallel import stack_batches
    chunk = stack_batches([(ids, labels)] * step.scan_steps)
    inner = step._train_step
    events, launches, marks = [], [], []
    prev = [_kernels.launch_counts()]

    def marked(*a):
        loss = inner(*a)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        now = _kernels.launch_counts()
        launches.append({k: now[k] - prev[0][k] for k in now})
        prev[0] = now
        if "loss_scale" in step._extras:
            marks.append(tuple(step._extras[k].clone() for k in
                               ("loss_scale", "good_steps", "bad_steps")))
        return loss

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    step._train_step = marked
    try:
        t0 = time.perf_counter()
        start.record()
        losses = [step(*chunk) for _ in range(chunks)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del step._train_step
    ms = [a.elapsed_time(b) for a, b in zip([start] + events[:-1], events)]
    scale = [tuple(float(t) for t in m) for m in marks]
    return (torch.cat(losses).cpu().tolist(), wall, ms, launches, scale)


def phase_train_amp(device_name, cell="train_amp"):
    """An AMP train cell (module note above): tokens/s, micro-step ms,
    MFU, peak memory, falling losses, the launches of every micro-step,
    the dtypes the LayerNorms and the attention saw, and with fp16 the
    steps the loss scaler skipped and its final scale. Returns the launch
    counts of the timed chunks."""
    import torch
    from paddle_tpu_torch.obs.flops import peak_flops, train_flops_per_step
    from paddle_tpu_torch.ops import _kernels

    gc.collect()
    torch.cuda.empty_cache()
    c = AMP_TRAIN_CELLS[cell]
    model, opt, step, ids, labels = amp_train_workload(cell)
    n_params = sum(p.numel() for p in model.parameters())
    # the dtypes a warm-up micro-step feeds the LayerNorms and the
    # attention (the qkv projection's output), read by hooks
    seen = {"layernorm_in": set(), "attention_in": set()}
    hooks = []
    for name, mod in model.named_modules():
        if type(mod).__name__ == "LayerNorm":
            hooks.append(mod.register_forward_pre_hook(
                lambda m, a: seen["layernorm_in"].add(str(a[0].dtype))))
        if name.endswith("qkv_proj"):
            hooks.append(mod.register_forward_hook(
                lambda m, a, o: seen["attention_in"].add(str(o.dtype))))
    warm = amp_timed_chunks(step, ids, labels, c["warmup_chunks"])
    for h in hooks:
        h.remove()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    losses, wall, step_ms, per_step, scale = amp_timed_chunks(
        step, ids, labels, c["timed_chunks"])
    launches = _kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    micro = len(step_ms)
    first = AMP_SCAN_STEPS * c["warmup_chunks"] + 1
    applying = [(first + i) % AMP_MERGE_K == 0 for i in range(micro)]
    fp16 = c["dtype"] == "float16"
    o2 = c.get("level") == "O2"
    tc = "_fp16" if fp16 else ""
    other = "" if fp16 else "_fp16"
    # O1 runs the LayerNorms and Adam in fp32, O2 every kernel in fp16
    want = []
    for apply in applying:
        w = dict.fromkeys(launches, 0)
        for k, v in AMP_KERNELS_PER_MICRO_STEP.items():
            w[k + tc if k.startswith("flash") or o2 else k] = v
        w["fused_adam" + (tc if o2 else "")] = (AMP_ADAM_PER_APPLY if apply
                                                else 0)
        want.append(w)
    all_losses = warm[0] + losses
    step_s = wall / micro
    tokens = TRAIN_B * TRAIN_S * micro
    # a micro-step was skipped when its census found a non-finite
    # gradient: its bad counter rose, or reached the limit and shrank the
    # scale (which resets the counter)
    skipped, last = [], 32768.0
    for i, (sc, _good, bad) in enumerate(warm[4] + scale):
        if bad > 0 or sc < last:
            skipped.append(i + 1)
        last = sc
    result = {
        "phase": cell, "model": "gpt3-1.3b",
        "dtype": ("fp16 parameters (amp.decorate O2), fp32 master "
                  "weights, AMP float16" if o2 else
                  f"fp32 master weights, AMP O1 {c['dtype']}"),
        "batch": TRAIN_B, "seq": TRAIN_S, "n_params": n_params,
        "strategy": (f"amp {c['dtype']}"
                     + (" dynamic loss scaling (init 32768)" if fp16 else "")
                     + f", recompute (whole loss), gradient_merge k = "
                       f"{AMP_MERGE_K} avg, scan_steps {AMP_SCAN_STEPS}"),
        "optimizer": "AdamW lr 1e-4 wd 0.01 fp32 moments, global-norm "
                     "clip 1.0" + (", multi_precision" if o2 else ""),
        "warmup_micro_steps": len(warm[2]), "warmup_s": warm[1],
        "timed_micro_steps": micro, "wall_s": wall,
        "tokens_per_s": tokens / wall, "micro_step_ms_mean": step_s * 1e3,
        "micro_step_ms_median": statistics.median(step_ms),
        "micro_step_ms": step_ms,
        "mfu": train_flops_per_step(n_params, TRAIN_B * TRAIN_S) / step_s
        / peak_flops(device_name),
        "peak_mem_gib": peak_gib, "losses": all_losses,
        "loss_first": all_losses[0], "loss_last": all_losses[-1],
        "dtypes_seen": {k: sorted(v) for k, v in seen.items()},
        "kernel_launches": launches,
        "launches_per_micro_step": per_step,
        "applying_micro_steps": applying}
    if fp16:
        result.update(skipped_micro_steps=skipped,
                      loss_scale_final=(warm[4] + scale)[-1][0],
                      loss_scale_trajectory=[m[0] for m in warm[4] + scale])
    emit(result)
    check(all(math.isfinite(x) for x in all_losses),
          f"{cell}: non-finite loss")
    check(all_losses[-1] < all_losses[0],
          f"{cell}: loss did not fall: {all_losses[0]} -> {all_losses[-1]}")
    check(per_step == want, f"{cell}: launches a micro-step {per_step}, "
                            f"want {want}")
    check(seen["layernorm_in"] == {"torch.float16" if o2 else
                                   "torch.float32"}
          and seen["attention_in"] == {f"torch.{c['dtype']}"},
          f"{cell}: dtypes seen {seen}")
    check(not any(launches[k + other] for k in ("flash_fwd", "flash_bwd_dq",
                                                "flash_bwd_dkv")),
          f"{cell}: launched flash kernels of the other dtype: {launches}")
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 5
SERVE_NEW_TOKENS = 32
SERVE_KERNELS = ("paged_attention", "layernorm_fwd")
# the serve cells: the preset served in bf16 (overrides cut its depth) and
# how many of the 16 prompts it takes; every cell runs one engine
# configuration, LLMEngine(num_slots=8, block_len=8, n_blocks=64,
# prefill_chunk=64), and its prompts have the same lengths
SERVE_CELLS = {
    "serve": dict(preset="gpt3-1.3b", requests=16),
    "llama_serve": dict(preset="llama2-7b", requests=16),
    # llama2-70b's widths, 4 of its 80 layers: 64 query heads over 8 kv
    # heads, the only grouped-query layout served at full width
    "llama_serve_gqa": dict(preset="llama2-70b", requests=8,
                            num_hidden_layers=4),
    # the serve cell's model and prompts under a mixed burst (sample_burst)
    "sample_serve": dict(preset="gpt3-1.3b", requests=16),
    # the serve cell's model cast to fp16 (model.to(dtype=torch.float16)):
    # the fp16 LayerNorm and paged-attention kernels, the latter on the
    # tensor cores at block_len 8
    "serve_fp16": dict(preset="gpt3-1.3b", requests=16, dtype="float16"),
}
SERVE_BUSY_STEPS = 8     # the burst's steps replayed to read device busy
# the serve cells' engine: the prefix cache is off, so that the burst's
# prompts (and serve_warm_up's prompts[0][:40], which would warm-hit the
# burst) cost the same prefill as in the runs before the cache was ported;
# the prefix_serve phase turns it on
SERVE_ENGINE = dict(num_slots=8, block_len=8, n_blocks=64, prefill_chunk=64,
                    max_new_tokens=SERVE_NEW_TOKENS, enable_prefix_cache=False)


def serve_model(cell="serve"):
    """(model, model_init_s): a serve cell's model on the card, random
    weights from SEED: in bf16, or built in fp32 and cast with
    model.to(dtype=torch.float16) for an fp16 cell."""
    import torch
    over = dict(SERVE_CELLS[cell])
    preset = over.pop("preset")
    over.pop("requests")
    dtype = over.pop("dtype", "bfloat16")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    model = model_class(preset).from_preset(
        preset, device="cuda",
        dtype="float32" if dtype == "float16" else dtype, generator=gen,
        **over)
    if dtype == "float16":
        model.to(dtype=torch.float16)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def serve_workload(cell="serve"):
    """A serve cell of SERVE_CELLS, shared with
    tools/profile_torch_serving.py: its model (serve_model) behind
    LLMEngine(num_slots=8, block_len=8, n_blocks=64, prefill_chunk=64)
    with the prefix cache off (SERVE_ENGINE) on a MonotonicClock, and its
    prompts of 32..400 tokens. Returns (model, engine, prompts,
    model_init_s); the engine is not started."""
    import numpy as np
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig

    n_req = SERVE_CELLS[cell]["requests"]
    model, init_s = serve_model(cell)
    engine = LLMEngine(model, LLMEngineConfig(**SERVE_ENGINE))
    prompts = serve_prompts(model.config.vocab_size)
    return model, engine, prompts[:n_req], init_s


def serve_prompts(vocab):
    """The serve cells' 16 prompts of 32..400 tokens, from SEED + 1."""
    import numpy as np
    rng = np.random.RandomState(SEED + 1)
    return [rng.randint(0, vocab, (int(n),)).astype(np.int32)
            for n in rng.randint(32, 401, size=16)]


def serve_warm_up(engine, prompts):
    """One short request through the started engine, outside any counted
    run (cuBLAS handles, allocator growth)."""
    import torch
    engine.generate(prompts[0][:40], max_new_tokens=2, timeout=600)
    torch.cuda.synchronize()


def serve_burst(engine, prompts, logprobs=False):
    """Submit every prompt to the started engine at once and wait for every
    stream. Returns (handles, outs, wall_s, steps, decode_iterations)."""
    steps0, dec0 = engine.steps, engine.decode_iterations
    t0 = time.perf_counter()
    handles = [engine.submit(p, max_new_tokens=SERVE_NEW_TOKENS,
                             logprobs=logprobs) for p in prompts]
    outs = [h.result(timeout=900) for h in handles]
    wall = time.perf_counter() - t0
    return (handles, outs, wall, engine.steps - steps0,
            engine.decode_iterations - dec0)


def step_busy(step_logits, recorded, names=None):
    """(device-busy ms, wall ms) of one unified step: SERVE_BUSY_STEPS of
    the burst's recorded step inputs, spread over it, replayed through the
    engine's `step_logits` after the burst. Wall: host clock around the
    replay to its synchronize. Busy: the kernels' device time under
    torch.profiler, None when it recorded none. `names`, a set, receives
    the names of the device kernels the profiler recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n = min(SERVE_BUSY_STEPS, len(recorded))
    picks = [recorded[i * len(recorded) // n] for i in range(n)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in picks:
        step_logits(*a)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for a in picks:
            step_logits(*a)
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    if names is not None:
        names.update(e.key for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)
    return (busy_us / 1e3 / n if busy_us > 0 else None), wall_ms


def phase_serve(cell="serve", record=None):
    """A serve cell of SERVE_CELLS through the started engine (prefix
    cache off, SERVE_ENGINE): its prompts submitted at once, launch counts
    zeroed just before and read just after; every stream checked, 4 against generate(); then the
    device-busy time of a step beside its wall time. `record`, a dict,
    receives the burst's streams and its tok/s, TTFT and decode step
    (phase_sample_serve holds its greedy streams to them)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models.generation import generate
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.ops.paged_attention import TENSOR_CORES, paged_route

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, engine, prompts, init_s = serve_workload(cell)
    preset = SERVE_CELLS[cell]["preset"]
    vocab = model.config.vocab_size
    plens = [len(p) for p in prompts]
    n_compare = 4
    # the first-token logits row of each compared request, copied out of
    # the step that lands its last prompt chunk (on the scheduler thread,
    # which alone changes engine._active while the engine runs); every
    # step's inputs are kept for the busy reading
    watch = {prompts[i].tobytes(): i for i in range(n_compare)}
    first_logits = {}
    recorded = []
    step_logits = engine._step_logits

    def capturing_step_logits(a):
        lg = step_logits(a)
        adv = a.adv
        recorded.append((a.toks.copy(), a.pos.copy(), adv.copy()))
        for slot, req in engine._active.items():
            i = watch.get(req.prompt.tobytes())
            if i is not None and req.chunk_off < len(req.prompt) \
                    and req.chunk_off + int(adv[slot]) == len(req.prompt):
                first_logits[i] = lg[slot, int(adv[slot]) - 1].float().cpu()
        return lg

    engine._step_logits = capturing_step_logits
    engine.start()
    try:
        serve_warm_up(engine, prompts)
        recorded.clear()
        _kernels.reset_launch_counts()
        handles, outs, wall, steps, decode_iters = serve_burst(
            engine, prompts, logprobs=True)
        launches = _kernels.launch_counts()
        routes = _kernels.route_counts()
    finally:
        engine.stop(drain=True, timeout=60)
    dtype = SERVE_CELLS[cell].get("dtype", "bfloat16")
    must, must_not = served_kernels(preset, dtype)
    check(all(launches[k] > 0 for k in must)
          and not any(launches[k] for k in must_not),
          f"the served path launched {launches}: want each of {must}, none "
          f"of {must_not}")
    if dtype == "float16":
        # every unified step runs every layer once: its two LayerNorms and
        # its paged attention, and the final LayerNorm
        layers = model.config.num_hidden_layers
        want = {"layernorm_fwd_fp16": (2 * layers + 1) * steps,
                "paged_attention_fp16": layers * steps}
        check({k: launches[k] for k in want} == want,
              f"{cell}: launched {launches} in {steps} steps, want {want}")
    # the route each paged launch took, by the library's own rule: all on
    # the tensor cores at the engine's block_len
    paged = _kernels.fp16_name("paged_attention", getattr(torch, dtype))
    want_routes = dict.fromkeys(routes, 0)
    want_routes[f"{paged}:{TENSOR_CORES}"] = launches[paged]
    check(routes == want_routes,
          f"{cell}: paged launches by route {routes}, want {want_routes}")
    for o, h in zip(outs, handles):
        check(o.shape == (SERVE_NEW_TOKENS,),
              f"stream of shape {o.shape}, want ({SERVE_NEW_TOKENS},)")
        check(((o >= 0) & (o < vocab)).all(), "token id out of range")
        lps = np.asarray(h.logprobs_so_far(), np.float64)
        check(np.isfinite(lps).all() and (lps <= 0).all(),
              "non-finite or positive logprob")
    ttfts = sorted(h.ttft_ms for h in handles)
    gen_tokens = sum(len(o) for o in outs)
    engine.pool.check_balance()

    # 4 streams against the port's one-shot generate(); bitwise equality
    # is a CPU contract (cuBLAS picks algorithms by M), so token agreement
    # is reported and the first step's logits are held to a bound. Both
    # paths round every layer's activations to bf16, so another GEMM
    # grouping moves a logit (|logit| < 2 with these random weights) by a
    # few bf16 ulps of at most 2^-7 each; 2^-4 allows eight. A broken path
    # (a wrong mask, page or position) changes the hidden state wholesale
    # and moves logits by their own spread, ~0.3.
    logits_tol = 2.0 ** -4
    check(sorted(first_logits) == list(range(n_compare)),
          f"captured first-step logits of {sorted(first_logits)} only")
    compare = []
    for i in range(n_compare):
        p = prompts[i]
        ref = generate(model, p[None],
                       max_new_tokens=SERVE_NEW_TOKENS).numpy()[0, len(p):]
        o = outs[i]
        same = int((ref == o).sum())
        first_div = next((j for j in range(len(o)) if ref[j] != o[j]), None)
        # generate()'s prefill: the whole prompt in one call at pos 0
        caches = model.init_cache(1, -(-(len(p) + SERVE_NEW_TOKENS) // 8) * 8)
        with torch.no_grad():
            lg, _ = model.forward_with_cache(
                torch.from_numpy(p[None]).cuda(), caches, 0)
        lg_ref = lg[0, -1].float().cpu()
        lp_ref = torch.log_softmax(lg_ref, -1)[int(o[0])].item()
        lp_eng = handles[i].logprobs_so_far()[0]
        compare.append(dict(
            prompt_len=len(p), tokens_equal=same, first_divergence=first_div,
            first_logits_max_abs_diff=float(
                (first_logits[i] - lg_ref).abs().max()),
            first_logprob_diff=abs(lp_eng - lp_ref)))
        del caches, lg
    worst_logits = max(c["first_logits_max_abs_diff"] for c in compare)
    stats = engine.metrics.snapshot()
    kernel_names = set()
    busy_ms, replay_ms = step_busy(
        lambda *a: step_logits(engine._step_args(*a)), recorded,
        kernel_names)
    step_ms = wall * 1e3 / steps
    paged_seen = sorted(k for k in kernel_names if "paged_attention" in k)
    result = {
        "phase": cell, "model": preset, "overrides": {
            k: v for k, v in SERVE_CELLS[cell].items()
            if k not in ("preset", "requests")},
        "n_params": sum(p.numel() for p in model.parameters()),
        "dtype": dtype, "paged_route": paged_route(
            getattr(torch, dtype), SERVE_ENGINE["block_len"],
            model.config.hidden_size // model.config.num_attention_heads),
        "paged_kernels_profiled": paged_seen, "paged_launches_by_route":
            routes,
        "requests": len(prompts), "prompt_lens": [int(n) for n in plens],
        "max_new_tokens": SERVE_NEW_TOKENS, "generated_tokens": gen_tokens,
        "wall_s": wall, "generated_tok_s": gen_tokens / wall,
        "ttft_p50_ms": statistics.median(ttfts),
        "ttft_p99_ms": ttfts[min(len(ttfts) - 1,
                                 int(round(0.99 * (len(ttfts) - 1))))],
        "decode_step_p50_ms": stats["intertoken_p50_ms"],
        "steps": steps, "decode_iterations": decode_iters,
        "step_ms": step_ms, "step_device_busy_ms": busy_ms,
        "step_replay_wall_ms": replay_ms,
        "busy_over_step": None if busy_ms is None else busy_ms / step_ms,
        "kernel_launches": launches, "model_init_s": init_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "vs_generate": compare, "first_logits_tol": logits_tol}
    emit(result)
    if record is not None:
        record.update({k: result[k] for k in (
            "generated_tok_s", "ttft_p50_ms", "decode_step_p50_ms", "steps",
            "decode_iterations")}, ttft_max_ms=ttfts[-1],
            streams=dict(enumerate(outs)))
    check(worst_logits <= logits_tol,
          f"engine vs generate() first-step logits differ by {worst_logits} "
          f"> {logits_tol}")
    if dtype == "float16":
        # beside the launches by route above: the route rule (paged_route
        # mirrors the C one) and, where the profiler kept its kernel
        # records, the kernel it names
        check(result["paged_route"] == TENSOR_CORES,
              f"{cell}: fp16 paged attention routed to "
              f"{result['paged_route']}")
        check(not paged_seen or all("paged_attention_kernel_tc" in k
                                    and "__half" in k for k in paged_seen),
              f"{cell}: the profiled step ran {paged_seen}")
    del model, engine, handles, recorded
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------- phase 5a
# serve_supervised: the serve cell's model, engine and 16 prompts under
# supervision (SERVE_ENGINE with dispatch_retries 2, breaker_threshold 3).
# Run A: one FaultPlan of four clauses (a decode-scoped poison on request
# 5, a prefill-scoped poison on request 10, a raise on a mid-run decode
# step, an injected hang): the 14 survivors' streams must equal serve's;
# the plan's log, the supervisor's snapshot, the failures and every
# outcome must equal those of SCHED_TWIN, a CPU engine of the same
# configuration and prompt lengths on a SimClock (scheduling depends on
# no token value while no request names an EOS). Fault-free bursts
# without and with the watchdog, in turns, give the step times runs A and
# B are read against and the watchdog's cost. Run B: the watchdog
# armed at SUPERVISED_TIMEOUT_S and one attempt really abandoned: a
# forward pre-hook on layer 12 of 24 holds the first attempt after
# SUPERVISED_HOLD_STEP committed steps, with layers 0-11 enqueued; the
# watchdog fires, the retry commits, the engine runs 4 more steps, then
# the hook lets go and the attempt must stop at the write fence; the
# streams must still equal serve's. Run C: a burst under a token budget
# and brownout, its admissions, sheds, rejects and caps equal to
# SCHED_TWIN's, each completed stream the prefix of serve's.
SUPERVISED_ENGINE = dict(SERVE_ENGINE, dispatch_retries=2,
                         breaker_threshold=3)
SUPERVISED_SPEC = ("poison_request@5:decode;poison_request@10:prefill;"
                   "dispatch_raise@24;dispatch_hang@40:30.0")
SUPERVISED_TIMEOUT_S = 0.5   # some 20x a decode step (PERF.md, serve)
SUPERVISED_HOLD_STEP = 20
SUPERVISED_HOLD_LAYER = 12
SUPERVISED_WAIT_S = 120.0
OVERLOAD = dict(max_inflight_tokens=2000, brownout_queue_depth=6,
                brownout_max_new_tokens=8, retry_after_s=0.5)
OVERLOAD_SLOS = ("interactive", "batch", "best_effort")
# the scheduling twin: a 1-layer GPT of 32 wide over a 64-token vocab (the
# prompts are taken mod 64) with room for the serve cell's 576-token slabs
SCHED_TWIN = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                  num_attention_heads=2, intermediate_size=64,
                  max_position_embeddings=1024)


def sched_twin(config, spec, prompts, slos=None):
    """(engine, handles or rejects, plan) of the CPU scheduling twin: the
    engine `config` on a SimClock with FaultPlan `spec`, every prompt
    submitted (mod 64, in order, with `slos`) and the engine drained."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    from paddle_tpu_torch.utils.fault_injection import FaultPlan
    model = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu",
                                       **SCHED_TWIN)
    plan = FaultPlan.from_spec(spec)
    eng = LLMEngine(model, LLMEngineConfig(**config), clock=SimClock(),
                    fault_plan=plan)
    out = submit_outcomes(eng, [p % 64 for p in prompts], slos)
    while eng.has_work():
        eng.pump()
    eng.stop()
    return eng, out, plan


def submit_outcomes(engine, prompts, slos=None):
    """Submit every prompt (with its class of `slos`), keeping each handle
    or ("rejected", reason, retry_after_s)."""
    from paddle_tpu_torch.serving import RejectedError
    out = []
    for i, p in enumerate(prompts):
        try:
            out.append(engine.submit(
                p, slo=None if slos is None else slos[i % len(slos)]))
        except RejectedError as e:
            out.append(("rejected", e.reason, e.retry_after_s))
    return out


def outcome(h):
    """What a handle or a reject ended as: ("completed", max_new_tokens,
    tokens emitted) or (error, reason, retry_after_s, tokens emitted)."""
    if isinstance(h, tuple):
        return h
    exc = h.future.exception(timeout=0)
    if exc is None:
        return ("completed", h.max_new_tokens, len(h.tokens_so_far()))
    return (type(exc).__name__, getattr(exc, "reason", None),
            getattr(exc, "retry_after_s", None), len(h.tokens_so_far()))


SUPERVISED_KEYS = ("dispatch_failures", "quarantined", "completed",
                   "failed", "shed", "rejected", "brownout_entries")


def _supervised_burst(engine, handles, timeout=900):
    """Start the engine over the queued handles, wait for every one; the
    wall seconds from the start."""
    t0 = time.perf_counter()
    engine.start()
    for h in handles:
        if not isinstance(h, tuple):
            try:
                h.result(timeout=timeout)
            except Exception:
                pass
    return time.perf_counter() - t0


def step_thread_costs(model, prompts, steps=24):
    """Host ms of one decode step's forward over 8 rows (`_step_logits`
    on an engine's operands, to a synchronize): on the calling thread, on
    a new thread each step (the watchdog's way), and on one other thread
    that runs every step; in turns (caller, new, one, one, new, caller)."""
    import threading
    import numpy as np
    import torch
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    engine = LLMEngine(model, LLMEngineConfig(**SERVE_ENGINE))
    n, c = SERVE_ENGINE["num_slots"], SERVE_ENGINE["prefill_chunk"]
    toks = np.zeros((n, c), np.int32)
    toks[:, 0] = [int(p[0]) for p in prompts[:n]]
    args = engine._step_args(toks, np.full((n,), 200, np.int32),
                             np.ones((n,), np.int32))

    def step():
        with torch.no_grad():
            engine._step_logits(args)
        torch.cuda.synchronize()

    def on_caller():
        for _ in range(steps):
            step()

    def on_new():
        for _ in range(steps):
            t = threading.Thread(target=step)
            t.start()
            t.join()

    def on_one():
        t = threading.Thread(target=on_caller)
        t.start()
        t.join()

    on_caller()                                   # warm
    out = {"caller": [], "new_each_step": [], "one_thread": []}
    for key, fn in (("caller", on_caller), ("new_each_step", on_new),
                    ("one_thread", on_one), ("one_thread", on_one),
                    ("new_each_step", on_new), ("caller", on_caller)):
        t0 = time.perf_counter()
        fn()
        out[key].append((time.perf_counter() - t0) * 1e3 / steps)
    del engine, args
    return {k: statistics.mean(v) for k, v in out.items()}


def phase_serve_supervised(serve):
    import threading
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import _kernels, attention
    from paddle_tpu_torch.serving import EngineSupervisor
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    from paddle_tpu_torch.serving.llm.llm_engine import _AttemptRevoked
    from paddle_tpu_torch.utils.fault_injection import FaultPlan

    gc.collect()
    torch.cuda.empty_cache()
    model, init_s = serve_model("serve")
    prompts = serve_prompts(model.config.vocab_size)
    streams = serve["streams"]
    warm = LLMEngine(model, LLMEngineConfig(**SERVE_ENGINE))
    warm.start()
    try:
        serve_warm_up(warm, prompts)
    finally:
        warm.stop(drain=True, timeout=60)
    del warm

    # the cost of the watchdog: fault-free bursts of the serve cell's
    # work without and with a deadline thread for each attempt, in turns
    # (off, on, on, off), every stream equal to serve's
    clean = {False: [], True: []}
    for watchdog in (False, True, True, False):
        cfg = dict(SUPERVISED_ENGINE, dispatch_timeout_s=(
            SUPERVISED_TIMEOUT_S if watchdog else None))
        engine_0 = LLMEngine(model, LLMEngineConfig(**cfg),
                             fault_plan=FaultPlan.from_spec(""))
        handles_0 = submit_outcomes(engine_0, prompts)
        try:
            wall_0 = _supervised_burst(engine_0, handles_0)
        finally:
            engine_0.stop(drain=True, timeout=60)
        equal_0 = [bool(np.array_equal(h.result(0), streams[i]))
                   for i, h in enumerate(handles_0)]
        check(all(equal_0), f"serve_supervised fault-free burst (watchdog "
                            f"{watchdog}): streams equal serve's: {equal_0}")
        snap_0 = engine_0.metrics.snapshot()
        check(engine_0.supervisor.snapshot()["watchdog_fires"] == 0,
              "a fault-free burst fired the watchdog")
        clean[watchdog].append(dict(
            generated_tok_s=sum(len(h.tokens_so_far())
                                for h in handles_0) / wall_0,
            decode_step_p50_ms=snap_0["intertoken_p50_ms"]))
        del engine_0
    # the watchdog's own cost an attempt: a no-op dispatch through the
    # supervisor, without and with its deadline thread; and one decode
    # step's forward (8 rows) enqueued and synchronised on this thread, on
    # a new thread each step, and on one other thread for every step
    attempt_us = {}
    for timeout in (None, SUPERVISED_TIMEOUT_S):
        sup = EngineSupervisor(dispatch_timeout_s=timeout)
        t0 = time.perf_counter()
        for _ in range(200):
            sup.run(lambda: None)
        attempt_us[str(timeout)] = (time.perf_counter() - t0) / 200 * 1e6
    step_host_ms = step_thread_costs(model, prompts)

    # run A: injected faults, no watchdog thread
    plan = FaultPlan.from_spec(SUPERVISED_SPEC)
    engine = LLMEngine(model, LLMEngineConfig(**SUPERVISED_ENGINE),
                       fault_plan=plan)
    handles = submit_outcomes(engine, prompts)
    _kernels.reset_launch_counts()
    try:
        wall_a = _supervised_burst(engine, handles)
        launches = _kernels.launch_counts()
    finally:
        engine.stop(drain=True, timeout=60)
    twin, twin_out, twin_plan = sched_twin(SUPERVISED_ENGINE,
                                           SUPERVISED_SPEC, prompts)
    got = [outcome(h) for h in handles]
    check(got == [outcome(h) for h in twin_out],
          f"serve_supervised: outcomes {got} differ from the CPU twin's "
          f"{[outcome(h) for h in twin_out]}")
    check(plan.log == twin_plan.log and len(plan.log) == 4,
          f"serve_supervised: plan log {plan.log}, CPU {twin_plan.log}")
    snap_a, twin_snap = engine.metrics.snapshot(), twin.metrics.snapshot()
    check(engine.supervisor.snapshot() == twin.supervisor.snapshot(),
          f"serve_supervised: supervisor {engine.supervisor.snapshot()}, "
          f"CPU {twin.supervisor.snapshot()}")
    keys_a = {k: snap_a[k] for k in SUPERVISED_KEYS}
    check(keys_a == {k: twin_snap[k] for k in SUPERVISED_KEYS},
          f"serve_supervised: metrics {keys_a} differ from the CPU twin's")
    poisoned = {5: got[5], 10: got[10]}
    check(poisoned[10][:2] == ("DispatchFailedError", "poisoned")
          and poisoned[10][3] == 0
          and poisoned[5][:2] == ("DispatchFailedError", "poisoned")
          and poisoned[5][3] >= 1,
          f"serve_supervised: poisoned requests ended {poisoned}")
    survivors = [i for i in range(len(prompts)) if i not in poisoned]
    equal_a = {i: bool(np.array_equal(handles[i].result(0), streams[i]))
               for i in survivors}
    check(len(survivors) == 14 and all(equal_a.values()),
          f"serve_supervised: survivor streams equal serve's: {equal_a}")
    check(engine.pool.check_balance() and engine.pool.active_slots() == 0,
          "serve_supervised: pool ledger unbalanced after run A")
    must, _ = served_kernels("gpt3-1.3b")
    check(all(launches[k] > 0 for k in must),
          f"serve_supervised: the path launched {launches}")
    tokens_a = sum(len(handles[i].tokens_so_far()) for i in survivors)

    # run B: the watchdog armed, one attempt really abandoned
    engine_b = LLMEngine(model, LLMEngineConfig(
        **SUPERVISED_ENGINE, dispatch_timeout_s=SUPERVISED_TIMEOUT_S),
        fault_plan=FaultPlan.from_spec(""))
    gate, held = threading.Event(), threading.Event()
    box = {}

    def hold(module, args):
        if not held.is_set() and engine_b.steps >= SUPERVISED_HOLD_STEP:
            box["fence"] = attention._KV_GUARD.guard
            box["step"] = engine_b.steps
            box["t"] = time.perf_counter()
            held.set()
            gate.wait(SUPERVISED_WAIT_S)

    hook = model.gpt.layers[SUPERVISED_HOLD_LAYER].register_forward_pre_hook(
        hold)
    handles_b = submit_outcomes(engine_b, prompts)
    try:
        t0 = time.perf_counter()
        engine_b.start()
        check(held.wait(SUPERVISED_WAIT_S), "run B: no attempt was held")
        while engine_b.steps < box["step"] + 4:
            check(time.perf_counter() - t0 < SUPERVISED_WAIT_S,
                  "run B: the engine did not run on past the held attempt")
            time.sleep(0.002)
        box["let_go_steps"] = engine_b.steps
        box["held_s"] = time.perf_counter() - box["t"]
        gate.set()
        fence = box["fence"]
        check(fence.stopped.wait(SUPERVISED_WAIT_S),
              "run B: the abandoned attempt never reached its next write")
        outs_b = [h.result(timeout=900) for h in handles_b]
        wall_b = time.perf_counter() - t0
    finally:
        gate.set()
        hook.remove()
        engine_b.stop(drain=True, timeout=60)
    sup_b = engine_b.supervisor.snapshot()
    check(isinstance(fence.error, _AttemptRevoked)
          and fence in engine_b.abandoned_attempts,
          f"run B: the held attempt ended with {fence.error!r}")
    check(sup_b["watchdog_fires"] >= 1 and not sup_b["circuit_open"],
          f"run B: supervisor {sup_b}")
    equal_b = [bool(np.array_equal(o, streams[i]))
               for i, o in enumerate(outs_b)]
    check(all(equal_b), f"run B: streams equal serve's: {equal_b}")
    check(engine_b.pool.check_balance(), "run B: pool ledger unbalanced")
    snap_b = engine_b.metrics.snapshot()

    # run C: a token budget and brownout
    over = dict(SERVE_ENGINE, **OVERLOAD)
    engine_c = LLMEngine(model, LLMEngineConfig(**over),
                         fault_plan=FaultPlan.from_spec(""))
    handles_c = submit_outcomes(engine_c, prompts, OVERLOAD_SLOS)
    try:
        _supervised_burst(engine_c, handles_c)
    finally:
        engine_c.stop(drain=True, timeout=60)
    twin_c, twin_c_out, _ = sched_twin(over, "", prompts, OVERLOAD_SLOS)
    got_c = [outcome(h) for h in handles_c]
    check(got_c == [outcome(h) for h in twin_c_out],
          f"run C: outcomes {got_c} differ from the CPU twin's "
          f"{[outcome(h) for h in twin_c_out]}")
    snap_c = engine_c.metrics.snapshot()
    twin_snap_c = twin_c.metrics.snapshot()
    check(all(snap_c[k] == twin_snap_c[k] for k in SUPERVISED_KEYS)
          and engine_c.metrics.reject_reasons
          == twin_c.metrics.reject_reasons,
          "run C: metrics differ from the CPU twin's")
    kinds = {o[0] if o[0] != "RejectedError" else o[1] for o in got_c}
    capped = [o for o in got_c if o[0] == "completed"
              and o[1] == OVERLOAD["brownout_max_new_tokens"]]
    check({"completed", "shed", "rejected"} <= kinds and capped
          and all(o[2] == OVERLOAD["retry_after_s"] for o in got_c
                  if o[0] != "completed"),
          f"run C: want admissions, sheds, rejects and brownout caps, each "
          f"reject with retry_after_s: {got_c}")
    prefix_c = [bool(np.array_equal(h.result(0),
                                    streams[i][:h.max_new_tokens]))
                for i, h in enumerate(handles_c)
                if outcome(h)[0] == "completed"]
    check(all(prefix_c), f"run C: streams are serve's prefixes: {prefix_c}")

    result = {
        "phase": "serve_supervised", "model": "gpt3-1.3b", "dtype": "bfloat16",
        "spec": SUPERVISED_SPEC, "plan_log": plan.log,
        "outcomes": got, "supervisor": engine.supervisor.snapshot(),
        "metrics": keys_a,
        "dispatch_idx": engine._dispatch_idx, "steps": engine.steps,
        "survivor_streams_equal_serve": sum(equal_a.values()),
        "generated_tok_s": tokens_a / wall_a,
        "decode_step_p50_ms": snap_a["intertoken_p50_ms"],
        "serve_generated_tok_s": serve["generated_tok_s"],
        "serve_decode_step_p50_ms": serve["decode_step_p50_ms"],
        "fault_free_runs": {"no_watchdog": clean[False],
                            "watchdog": clean[True],
                            "order": "off, on, on, off"},
        "decode_step_added_ms": (
            statistics.mean(r["decode_step_p50_ms"] for r in clean[True])
            - statistics.mean(r["decode_step_p50_ms"]
                              for r in clean[False])),
        "supervised_noop_attempt_us": attempt_us,
        "decode_step_forward_ms_by_thread": step_host_ms,
        "timeout_run": {
            "dispatch_timeout_s": SUPERVISED_TIMEOUT_S,
            "held_at_step": box["step"], "held_layer": SUPERVISED_HOLD_LAYER,
            "held_s": box["held_s"], "let_go_at_step": box["let_go_steps"],
            "fenced": type(fence.error).__name__,
            "supervisor": sup_b, "streams_equal_serve": sum(equal_b),
            "generated_tok_s": sum(len(o) for o in outs_b) / wall_b,
            "decode_step_p50_ms": snap_b["intertoken_p50_ms"]},
        "overload_run": {**OVERLOAD, "slos": OVERLOAD_SLOS,
                         "outcomes": got_c,
                         "metrics": {k: snap_c[k] for k in SUPERVISED_KEYS},
                         "reject_reasons": engine_c.metrics.reject_reasons},
        "kernel_launches": launches, "model_init_s": init_s}
    emit(result)
    del model, engine, engine_b, engine_c
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------- phase 5f
# serve_observed: the serve cell again (its model, SERVE_ENGINE, the same
# 16 prompts) with the serving observability armed: economics=True (the
# ServingLedger and SLOBurnMonitor), every request traced, two tenants,
# two SLO classes, and a TTFT target of OBSERVED_TTFT_MS for both
# classes. The 16 requests are queued before the engine starts, so the 8
# interactive ones take the 8 slots and reach their first token within 7
# steps (a prompt of at most 400 tokens in chunks of 64), while the 8
# batch ones wait for a slot to free, at least 32 steps. On the CPU twin
# (SCHED_TWIN on a SimClock advanced OBSERVED_TICK_S before each pump) the
# target is 20 steps; on the card any step between 12 and 57 ms gives the
# same outcome for every request, so the burn monitor's outcomes (8 good,
# 8 bad) and its fired classes must equal the twin's. Every stream must
# equal serve's (arming changes no token); the ledger's phases must tile
# its wall clock within 1%, the per-tenant and per-class device seconds
# sum to prefill_compute + decode_compute within 1e-9 relative, its
# decode tokens equal the tokens the decode steps emitted and its
# positions what the engine dispatched; decode MFU lies in (0, 1);
# render() parses line by line as exposition text with the twin's family
# set; each timeline runs submitted < admitted <= first token <=
# finished. The ledger's decode_compute a decode step is printed beside
# the profiler's busy ms of a replayed step: the port launches op by op,
# so the ledger's span holds the host's enqueue time too. Then the same
# burst disarmed and armed, in turns (off, on, on, off), gives what
# arming costs a decode step (host speed varies between phases, so the
# comparison with serve's numbers alone would not).
OBSERVED_TICK_S = 0.02
OBSERVED_TTFT_MS = 400.0
OBSERVED_ENGINE = dict(SERVE_ENGINE, economics=True, slo_burn_min_events=4,
                       slo_ttft_target_ms={"interactive": OBSERVED_TTFT_MS,
                                           "batch": OBSERVED_TTFT_MS})
OBSERVED_SLOS = ("interactive", "batch")
OBSERVED_TENANTS = ("tenant_a", "tenant_b")


def observed_submit(engine, prompts, trace=True):
    """Queue every prompt, classes and tenants alternating."""
    return [engine.submit(p, slo=OBSERVED_SLOS[i % 2],
                          tenant=OBSERVED_TENANTS[(i // 2) % 2], trace=trace)
            for i, p in enumerate(prompts)]


def observed_turns(model, prompts, streams):
    """The observed burst disarmed (SERVE_ENGINE, untraced) and armed
    (OBSERVED_ENGINE, traced), in turns: {armed: [(tok/s, decode step
    p50 ms), ...]}, every stream checked against serve's."""
    import numpy as np
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    out = {False: [], True: []}
    for armed in (False, True, True, False):
        eng = LLMEngine(model, LLMEngineConfig(
            **(OBSERVED_ENGINE if armed else SERVE_ENGINE)))
        hs = observed_submit(eng, prompts, trace=armed)
        try:
            t0 = time.perf_counter()
            eng.start()
            outs = [h.result(timeout=900) for h in hs]
            wall = time.perf_counter() - t0
        finally:
            eng.stop(drain=True, timeout=60)
        check(all(np.array_equal(o, streams[i]) for i, o in enumerate(outs)),
              f"serve_observed: a turn (armed {armed}) changed a stream")
        out[armed].append((sum(len(o) for o in outs) / wall,
                           eng.metrics.snapshot()["intertoken_p50_ms"]))
        del eng
    return out


def burn_outcomes(engine):
    """{class: [good, ...]} of the burn monitor's recorded outcomes, and
    its fire records without their instants."""
    snap = engine.burn.snapshot()
    return ({c: [g for _, g in dq] for c, dq in engine.burn._events.items()},
            {c: {k: v for k, v in rec.items() if k != "t"}
             for c, rec in snap["fired"].items()})


def exposition_families(text):
    """The family names of an exposition text, checking every line is a
    TYPE line or a sample line whose value parses."""
    fams = []
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            check(len(parts) == 4 and parts[3] in (
                "counter", "gauge", "summary", "histogram"),
                f"serve_observed: bad TYPE line {line!r}")
            fams.append(parts[2])
            continue
        head, _, val = line.rpartition(" ")
        try:
            float(val)
        except ValueError:
            fail(f"serve_observed: bad sample value in {line!r}")
        base = head.split("{")[0]
        check(base and any(base.startswith(f) for f in fams),
              f"serve_observed: sample of no declared family: {line!r}")
    return fams


def phase_serve_observed(serve, device_name):
    import numpy as np
    import torch
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.obs.flops import decode_flops_per_token, peak_flops
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.serving.clock import SimClock
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig

    gc.collect()
    torch.cuda.empty_cache()
    model, init_s = serve_model("serve")
    prompts = serve_prompts(model.config.vocab_size)
    streams = serve["streams"]
    warm = LLMEngine(model, LLMEngineConfig(**SERVE_ENGINE))
    warm.start()
    try:
        serve_warm_up(warm, prompts)
    finally:
        warm.stop(drain=True, timeout=60)
    del warm

    engine = LLMEngine(model, LLMEngineConfig(**OBSERVED_ENGINE))
    n_params = sum(p.numel() for p in model.parameters())
    engine.ledger.set_decode_flops(decode_flops_per_token(n_params),
                                   peak_flops(device_name))
    recorded = []
    step_logits = engine._step_logits

    def recording_step_logits(a):
        recorded.append((a.toks.copy(), a.pos.copy(), a.adv.copy()))
        return step_logits(a)

    engine._step_logits = recording_step_logits
    handles = observed_submit(engine, prompts)
    _kernels.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        engine.start()
        outs = [h.result(timeout=900) for h in handles]
        wall = time.perf_counter() - t0
    finally:
        engine.stop(drain=True, timeout=60)
    launches = _kernels.launch_counts()
    must, _ = served_kernels("gpt3-1.3b")
    check(all(launches[k] > 0 for k in must),
          f"serve_observed: the path launched {launches}")
    equal = [bool(np.array_equal(o, streams[i])) for i, o in enumerate(outs)]
    check(all(equal), f"serve_observed: streams equal serve's: {equal}")
    check(engine.pool.check_balance(), "serve_observed: pool unbalanced")

    led = engine.ledger.snapshot()
    snap = engine.metrics.snapshot()
    phases = led["phase_seconds"]
    tiled = sum(phases.values())
    check(abs(tiled - led["wall_seconds"]) <= 0.01 * led["wall_seconds"],
          f"serve_observed: phases sum to {tiled}, wall "
          f"{led['wall_seconds']}")
    compute = phases["prefill_compute"] + phases["decode_compute"]
    for owner in ("tenants", "classes"):
        total = sum(v["device_seconds"] for v in led[owner].values())
        check(abs(total - compute) <= 1e-9 * compute,
              f"serve_observed: {owner} device seconds {total}, compute "
              f"{compute}")
    check(set(led["tenants"]) == set(OBSERVED_TENANTS)
          and set(led["classes"]) == set(OBSERVED_SLOS),
          f"serve_observed: owners {sorted(led['tenants'])}, "
          f"{sorted(led['classes'])}")
    emitted = sum(len(o) for o in outs)
    check(led["decode_tokens"] == snap["tokens_out"]
          == emitted - len(prompts),
          f"serve_observed: ledger decode tokens {led['decode_tokens']}, "
          f"decode steps emitted {snap['tokens_out']}, streams {emitted}")
    n, c = SERVE_ENGINE["num_slots"], SERVE_ENGINE["prefill_chunk"]
    check(led["total_positions"] == engine.steps * n * c
          and led["useful_positions"] == engine.prefill_tokens
          + led["decode_tokens"] and led["dispatches"] == engine.steps,
          f"serve_observed: positions {led['useful_positions']}/"
          f"{led['total_positions']} over {engine.steps} steps, prefilled "
          f"{engine.prefill_tokens}")
    mfu = led["decode_mfu"]
    check(mfu is not None and 0.0 < mfu < 1.0,
          f"serve_observed: decode MFU {mfu}")
    for i, h in enumerate(handles):
        tl = h.timeline()
        mk = tl["marks_ms"]
        check(tl["outcome"] == "completed" and mk["submitted"]
              < mk["admitted"] <= mk["first_token"] <= mk["finished"],
              f"serve_observed: request {i} timeline {tl['outcome']} {mk}")
    check(len(engine.timelines) == len(prompts),
          f"serve_observed: {len(engine.timelines)} stored timelines")

    # the CPU twin: the same configuration, prompt lengths, classes and
    # tenants on a SimClock, OBSERVED_TICK_S a step
    twin_model = GPTForCausalLM.from_preset("gpt2-tiny", device="cpu",
                                            **SCHED_TWIN)
    twin = LLMEngine(twin_model, LLMEngineConfig(**OBSERVED_ENGINE),
                     clock=SimClock())
    twin_handles = observed_submit(twin, [p % 64 for p in prompts])
    while twin.has_work():
        twin.clock.advance(OBSERVED_TICK_S)
        twin.pump()
    got_burn, twin_burn = burn_outcomes(engine), burn_outcomes(twin)
    check(got_burn == twin_burn,
          f"serve_observed: burn outcomes {got_burn}, CPU twin {twin_burn}")
    check(got_burn[0] == {"interactive": [True] * 8, "batch": [False] * 8}
          and set(got_burn[1]) == {"batch"},
          f"serve_observed: burn outcomes {got_burn}")
    text = engine.metrics.render()
    fams = exposition_families(text)
    twin_fams = exposition_families(twin.metrics.render())
    check(set(fams) == set(twin_fams) and len(fams) == len(set(fams)),
          f"serve_observed: families {sorted(set(fams) ^ set(twin_fams))} "
          "differ from the CPU twin's")
    for fam in ("pdtpu_llm_phase_seconds_total", "pdtpu_llm_decode_mfu",
                "pdtpu_llm_tenant_device_seconds_total",
                "pdtpu_llm_slo_burn_rate", "pdtpu_llm_class_ttft_ms"):
        check(fam in fams, f"serve_observed: no {fam} family")
    twin_led = twin.ledger.snapshot()
    check(all(twin_led[k] == led[k] for k in (
        "useful_positions", "total_positions", "decode_tokens",
        "prefill_tokens", "dispatches")),
        "serve_observed: token economics differ from the CPU twin's")

    busy_ms, replay_ms = step_busy(
        lambda *a: step_logits(engine._step_args(*a)), recorded)
    turns = observed_turns(model, prompts, streams)
    steps = engine.steps
    decode_steps = engine.decode_iterations
    result = {
        "phase": "serve_observed", "model": "gpt3-1.3b", "dtype": "bfloat16",
        "slo_ttft_target_ms": OBSERVED_TTFT_MS,
        "streams_equal_serve": sum(equal),
        "generated_tok_s": emitted / wall,
        "decode_step_p50_ms": snap["intertoken_p50_ms"],
        "ttft_p50_ms_by_class": {
            c: engine.metrics.ttft_quantile_ms(0.5, slo=c)
            for c in OBSERVED_SLOS},
        "serve_generated_tok_s": serve["generated_tok_s"],
        "serve_decode_step_p50_ms": serve["decode_step_p50_ms"],
        "steps": steps, "decode_steps": decode_steps,
        "ledger": {k: led[k] for k in (
            "wall_seconds", "phase_seconds", "host_fraction",
            "token_efficiency", "useful_positions", "total_positions",
            "prefill_tokens", "decode_tokens", "decode_mfu", "tenants",
            "classes")},
        "phase_ms_a_step": {k: v * 1e3 / steps for k, v in phases.items()},
        "phase_shares": {k: v / led["wall_seconds"]
                         for k, v in phases.items()},
        "decode_compute_ms_a_decode_step":
            phases["decode_compute"] * 1e3 / decode_steps,
        "profiler_busy_ms_a_step": busy_ms,
        "step_replay_wall_ms": replay_ms,
        "busy_share_a_step": None if busy_ms is None
        else busy_ms / (wall * 1e3 / steps),
        "burn": {"outcomes": got_burn[0], "fired": got_burn[1]},
        "families": len(fams),
        "turns": {"order": "off, on, on, off", "tok_s_and_decode_p50_ms": {
            "not_armed": turns[False], "armed": turns[True]},
            "decode_step_added_ms": (
                statistics.mean(p for _, p in turns[True])
                - statistics.mean(p for _, p in turns[False])),
            "tok_s_armed_over_not": (
                statistics.mean(t for t, _ in turns[True])
                / statistics.mean(t for t, _ in turns[False]))},
        "kernel_launches": launches, "model_init_s": init_s}
    emit(result)
    del model, engine, recorded
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------- phase 5c
# batch_serve: BatchingEngine(max_batch_size=8, max_wait_ms=2.0) over a
# predict_fn that runs full gpt3-1.3b's forward without cache on the card
# (bf16: the flash forward and LayerNorm kernels) and returns each row's
# last-position logits as fp32 numpy. BATCH_REQUESTS single-row requests
# of 128 tokens on a seeded Poisson trace through sim.replay (a SimClock,
# so the batches are those the CPU port engine forms from the same trace),
# dispatch_raise on the third dispatch. Each completed request's logits
# are held to a forward of that row alone within BATCH_LOGITS_TOL: the
# padded batch is another M for cuBLAS, so activations round in another
# order; as in phase_serve, a logit (|logit| < 2 with these random
# weights) moves by a few bf16 ulps of at most 2^-7, and 2^-4 allows
# eight, while a wrong row, mask or position moves logits by their own
# spread (~0.3). The argmax must agree except at a tie: the batch's
# choice within BATCH_LOGITS_TOL of the top of the solo logits.
BATCH_REQUESTS = 32
BATCH_ROW = 128
BATCH_RATE_HZ = 2000.0
BATCH_SPEC = "dispatch_raise@2"
BATCH_LOGITS_TOL = 2.0 ** -4


def phase_batch_serve():
    import numpy as np
    import torch
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.utils.fault_injection import FaultPlan

    gc.collect()
    torch.cuda.empty_cache()
    model, init_s = serve_model("serve")
    model.eval()
    vocab = model.config.vocab_size
    rng = np.random.RandomState(SEED + 17)
    rows = [rng.randint(0, vocab, (1, BATCH_ROW)).astype(np.int32)
            for _ in range(BATCH_REQUESTS)]

    def last_logits(ids):
        with torch.no_grad():
            hidden, _ = model.gpt(torch.from_numpy(ids).cuda())
            return model.lm_head(hidden[:, -1]).float().cpu().numpy()

    calls, twin_calls = [], []

    def predict(args):
        calls.append(args[0].shape[0])
        return [last_logits(args[0])]

    def stub(args):
        twin_calls.append(args[0].shape[0])
        return [np.zeros((args[0].shape[0], 1), np.float32)]

    def replay(fn, economics=False):
        cfg = serving.EngineConfig(max_batch_size=8, max_wait_ms=2.0,
                                   economics=economics)
        eng = serving.BatchingEngine(fn, cfg, clock=serving.SimClock(),
                                     fault_plan=FaultPlan.from_spec(
                                         BATCH_SPEC))
        trace = serving.poisson_trace(BATCH_REQUESTS, BATCH_RATE_HZ,
                                      make_inputs=lambda i: [rows[i]],
                                      seed=SEED)
        return eng, serving.replay(eng, trace)

    last_logits(rows[0])                        # warm-up, uncounted
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng, report = replay(predict)
    wall = time.perf_counter() - t0
    launches = _kernels.launch_counts()
    _, twin_report = replay(stub)
    check(calls == twin_calls and report.dispatches == twin_report.dispatches,
          f"batch_serve: dispatch sizes {calls}, CPU engine {twin_calls}")
    check(report.outcomes == twin_report.outcomes,
          "batch_serve: outcomes differ from the CPU engine's")
    failed = [i for i, o in enumerate(report.outcomes) if o == "failed"]
    check(failed and all(isinstance(report.errors[i],
                                    serving.DispatchFailedError)
                         for i in failed)
          and report.completed == BATCH_REQUESTS - len(failed),
          f"batch_serve: outcomes {report.outcomes}")
    # each successful dispatch runs the 24 layers' flash forward and their
    # 49 LayerNorms once; the failed one raised before predict_fn
    ok_calls = len(calls)
    layers = model.config.num_hidden_layers
    want = {"flash_fwd": layers * ok_calls,
            "layernorm_fwd": (2 * layers + 1) * ok_calls}
    check({k: launches[k] for k in want} == want,
          f"batch_serve: launched {launches} over {ok_calls} dispatches, "
          f"want {want}")
    worst, ties, mismatched = 0.0, [], []
    for i, o in enumerate(report.outcomes):
        if o != "completed":
            continue
        got = report.results[i][0][0]
        solo = last_logits(rows[i])[0]
        worst = max(worst, float(np.abs(got - solo).max()))
        a, b = int(got.argmax()), int(solo.argmax())
        if a != b:
            gap = float(solo[b] - solo[a])
            (ties if gap <= BATCH_LOGITS_TOL else mismatched).append(
                (i, a, b, gap))
    check(worst <= BATCH_LOGITS_TOL,
          f"batch_serve: batched vs solo logits differ by {worst}")
    check(not mismatched, f"batch_serve: argmax differs beyond a tie: "
          f"{mismatched}")
    # the trace once more with the economics ledger armed: the same
    # dispatches and logits, and the ledger's phases tiling its wall
    plain_calls = list(calls)
    calls.clear()
    eng_e, report_e = replay(predict, economics=True)
    check(calls == plain_calls and report_e.outcomes == report.outcomes,
          f"batch_serve economics: dispatches {calls}, plain {plain_calls}")
    same = [bool(np.array_equal(report_e.results[i][0], report.results[i][0]))
            for i, o in enumerate(report.outcomes) if o == "completed"]
    check(all(same), f"batch_serve economics: logits equal: {same}")
    led = eng_e.ledger.snapshot()
    check(abs(sum(led["phase_seconds"].values()) - led["wall_seconds"])
          <= 0.01 * led["wall_seconds"]
          and led["total_positions"] == sum(calls)
          and led["useful_positions"] == report.completed
          and led["dispatches"] == len(calls),
          f"batch_serve economics: ledger {led}")
    snap = eng.metrics.snapshot()
    emit({"phase": "batch_serve", "model": "gpt3-1.3b", "dtype": "bfloat16",
          "requests": BATCH_REQUESTS, "row_tokens": BATCH_ROW,
          "spec": BATCH_SPEC, "dispatch_rows": calls,
          "dispatches": report.dispatches, "failed": failed,
          "completed": report.completed, "wall_s": wall,
          "requests_per_s": BATCH_REQUESTS / wall,
          "logits_max_abs_diff_vs_solo": worst,
          "logits_tol": BATCH_LOGITS_TOL, "argmax_ties": ties,
          "economics": {k: led[k] for k in (
              "wall_seconds", "phase_seconds", "token_efficiency",
              "useful_positions", "total_positions", "dispatches")},
          "metrics": {k: snap[k] for k in (
              "dispatches", "batch_hist", "pad_overhead_rows",
              "dispatch_failures", "completed", "failed", "p50_ms")},
          "kernel_launches": launches, "model_init_s": init_s})
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 5b
SAMPLE_ROWS = (8, 512)     # rows of a lane draw: the engine's emission rows
#                            a step, and a whole unified step's N*C rows
SAMPLE_PAIRS = 16          # (seed, stream index) pairs of the lane checks
GUMBEL_ULPS = 2            # of max(|g|, 1), see gumbel_ulps
SELECT_NC = (8, 64)        # the serve cell's unified step: N slots x C


def sample_pairs():
    """SAMPLE_PAIRS (seed, index) pairs: the edge seeds 0, 1, 2^31 - 1
    and random ones, at stream indices from 0 to 2^31 - 1."""
    import numpy as np
    rng = np.random.RandomState(SEED + 9)
    n = SAMPLE_PAIRS - 3
    seeds = [0, 1, 2 ** 31 - 1] + rng.randint(0, 2 ** 31, n).tolist()
    index = [0, 2 ** 31 - 1, 31] + rng.randint(0, 2 ** 20, n).tolist()
    return seeds, index


def gumbel_ulps(torch, got, want):
    """Largest |got - want| in fp32 ulps of max(|want|, 1). The noise is
    -log(L), L = -log(u): one ulp of L (2^-23 of it) is an absolute
    error of 2^-23 in the result, which is one ulp at |g| = 1 and many
    ulps of a value near 0, where the noise crosses zero."""
    scale = torch.maximum(want.abs(), torch.ones_like(want))
    ulp = torch.nextafter(scale, torch.full_like(scale, math.inf)) - scale
    return float(((got.double() - want.double()).abs() / ulp.double()).max())


def lane_mismatches(torch, vocab):
    """({draw: words that differ between the card and the CPU}, gumbel's
    largest distance in ulps) for the lane keys, fold_in, split and
    random_bits over SAMPLE_ROWS x vocab, one key for the whole draw
    (generate()'s form) and one key a row (the engine's)."""
    from paddle_tpu_torch.core import threefry
    from paddle_tpu_torch.serving.llm.sampling import lane_key
    seeds, index = sample_pairs()
    keys = {d: lane_key(torch.tensor(seeds, device=d),
                        torch.tensor(index, device=d))
            for d in ("cuda", "cpu")}

    def rows_draw(r, d):
        return threefry.random_bits(keys[d][r % SAMPLE_PAIRS], (r, vocab))

    draws = {
        "lane_key": lambda d: keys[d],
        "fold_in": lambda d: threefry.fold_in(
            keys[d], torch.tensor(index, device=d)),
        "split": lambda d: threefry.split(keys[d], 3),
        "random_bits_per_row": lambda d: threefry.random_bits(
            keys[d], (vocab,)),
        **{f"random_bits_{r}x{vocab}": partial(rows_draw, r)
           for r in SAMPLE_ROWS}}
    out = {}
    for name, fn in draws.items():
        card, cpu = fn("cuda").cpu(), fn("cpu")
        out[name] = (int((card != cpu).sum()) if card.shape == cpu.shape
                     else -1)
    worst = 0.0
    for r in SAMPLE_ROWS:
        key = r % SAMPLE_PAIRS
        card = threefry.gumbel(keys["cuda"][key], (r, vocab)).cpu()
        cpu = threefry.gumbel(keys["cpu"][key], (r, vocab))
        worst = max(worst, gumbel_ulps(torch, card, cpu))
    card = threefry.gumbel(keys["cuda"], (vocab,)).cpu()
    worst = max(worst, gumbel_ulps(torch, card,
                                   threefry.gumbel(keys["cpu"], (vocab,))))
    return out, worst


# the constrained requests' JSON schema (a string enum, an integer and a
# boolean) over a token table of a few dozen short texts; integers come
# as whole tokens with their comma, so a stream closes within 64 tokens
# whatever the model's weights, and the decoys are never legal
SAMPLE_SCHEMA = {"type": "object", "properties": {
    "color": {"enum": ["red", "green", "blue"]},
    "count": {"type": "integer"},
    "ok": {"type": "boolean"}}}
SAMPLE_TEXTS = ("{", "}", ",", ":", '"color"', '"count"', '"ok"', '"red"',
                '"green"', '"blue"', "0,", "7,", "42,", "-5,", "100,",
                "true", "false", '"color":', '"ok":true', '"count":',
                "x", "null", "[", "]", '"', " ", "True", "1.5", "{}",
                '"size"', "0.", "-")
SAMPLE_TOKEN0 = 1000       # the texts take ids 1000, 1001, ...
SAMPLE_EOS = 50256         # GPT-2's end-of-text id, in the table as ""


def sample_grammar():
    """(grammar dict, eos id) of the constrained requests."""
    tokens = {SAMPLE_TOKEN0 + j: t for j, t in enumerate(SAMPLE_TEXTS)}
    tokens[SAMPLE_EOS] = ""
    return {"schema": SAMPLE_SCHEMA, "tokens": tokens}, SAMPLE_EOS


def select_case(torch, vocab, device):
    """select_tokens over fp32 logits [SELECT_NC x vocab] on `device`,
    every mode in a row of its own: greedy, temperature 0.7, top-k 50,
    top-p 0.9, top-k + top-p, a constrained greedy row, a constrained
    sampled row (one at the start state, one mid-object) and a free row
    (adv 0), in the engine's [9, 128, vocab] grammar bank. The logits
    come from SEED on the card and are copied to `device`. Returns
    (tokens [N, C], new DFA states [N]) on the CPU."""
    import numpy as np
    from paddle_tpu_torch.serving.llm.sampling import (
        SamplingParams, SlotSamplingTable, compile_grammar, select_tokens)
    N, C = SELECT_NC
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    logits = (torch.randn((N, C, vocab), generator=gen, device="cuda")
              * 3).to(device)
    grammar, eos = sample_grammar()
    tab = SlotSamplingTable(N, vocab)
    gid = tab.intern(SamplingParams(grammar=grammar).grammar_key(),
                     compile_grammar(grammar, vocab, eos))
    mid = int(tab.bank[gid, 0, SAMPLE_TOKEN0])          # after "{"
    rng = np.random.RandomState(SEED + 12)
    seeds, _ = sample_pairs()

    def t(a, dt):
        return torch.tensor(a, dtype=dt, device=device)

    return tuple(x.cpu() for x in select_tokens(
        logits, t([1, 64, 33, 1, 64, 1, 17, 0], torch.int32),
        t([1.0, 0.7, 1.0, 1.0, 0.8, 1.0, 1.0, 1.0], torch.float32),
        t([0, 0, 50, 0, 50, 0, 0, 0], torch.int32),
        t([1.0, 1.0, 1.0, 0.9, 0.9, 1.0, 0.9, 1.0], torch.float32),
        t([False, True, True, True, True, False, True, True], torch.bool),
        t(seeds[:N], torch.int32),
        t(rng.randint(0, 4096, N).tolist(), torch.int32),
        t([0, 0, 0, 0, 0, 0, mid, 0], torch.int32),
        t([0, 0, 0, 0, 0, gid, gid, 0], torch.int32),
        torch.from_numpy(tab.bank).to(device)))


def phase_sampling():
    """The sampling slice's arithmetic on the card against the port's own
    CPU path (neither side needs JAX; the tier-1 tests tie the CPU side
    to jax.random): lanes, folds, splits and random bits bit-equal,
    gumbel noise within GUMBEL_ULPS, select_tokens's tokens and DFA
    states equal, at gpt3-1.3b's vocabulary."""
    import torch
    vocab = preset_config("gpt3-1.3b").vocab_size
    t0 = time.perf_counter()
    words, ulps = lane_mismatches(torch, vocab)
    lanes_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks_card, state_card = select_case(torch, vocab, "cuda")
    toks_cpu, state_cpu = select_case(torch, vocab, "cpu")
    select_s = time.perf_counter() - t0
    tok_diff = int((toks_card != toks_cpu).sum())
    emit({"phase": "sampling", "vocab": vocab, "pairs": SAMPLE_PAIRS,
          "rows": list(SAMPLE_ROWS), "differing_words": words,
          "gumbel_max_ulps": ulps, "gumbel_tol_ulps": GUMBEL_ULPS,
          "select_shape": [*SELECT_NC, vocab],
          "select_tokens_differing": tok_diff,
          "dfa_states": state_card.tolist(),
          "dfa_states_cpu": state_cpu.tolist(),
          "lanes_s": lanes_s, "select_s": select_s})
    check(all(v == 0 for v in words.values()),
          f"threefry draws differ between the card and the CPU: {words}")
    check(ulps <= GUMBEL_ULPS,
          f"gumbel noise {ulps} ulps from the CPU's > {GUMBEL_ULPS}")
    check(tok_diff == 0 and torch.equal(state_card, state_cpu),
          f"select_tokens: {tok_diff} tokens differ from the CPU's, states "
          f"{state_card.tolist()} against {state_cpu.tolist()}")


# ---------------------------------------------------------------- phase 5c
SAMPLE_CONSTRAINED_NEW = 64   # a constrained request's budget: its object
#                               closes well inside it


def sample_params(i):
    """(SamplingParams or None, max_new_tokens, eos id or None) of
    request i of the mixed burst: i % 4 == 0 greedy; 1 temperature 0.8,
    top-k 50; 2 temperature 1.0, top-p 0.9; 3 constrained by
    SAMPLE_SCHEMA, greedy for i = 3, 11 and sampled for i = 7, 15."""
    from paddle_tpu_torch.serving.llm.sampling import SamplingParams
    mode = i % 4
    if mode == 0:
        return None, SERVE_NEW_TOKENS, None
    if mode == 1:
        return (SamplingParams(temperature=0.8, top_k=50, seed=1000 + i),
                SERVE_NEW_TOKENS, None)
    if mode == 2:
        return (SamplingParams(temperature=1.0, top_p=0.9, seed=1000 + i),
                SERVE_NEW_TOKENS, None)
    grammar, eos = sample_grammar()
    seed = 1000 + i if i % 8 == 7 else None
    return (SamplingParams(seed=seed, grammar=grammar),
            SAMPLE_CONSTRAINED_NEW, eos)


def submit_all(engine, prompts, which):
    """Submit requests `which` (indices into prompts) at once with their
    sample_params; {i: handle}."""
    out = {}
    for i in which:
        sp, mnt, eos = sample_params(i)
        out[i] = engine.submit(prompts[i], max_new_tokens=mnt,
                               eos_token_id=eos, sampling=sp)
    return out


def sample_warm_up(engine, prompts):
    """serve_warm_up, then one short constrained sampled request: the
    first such step uploads the grammar bank and loads the sort and scan
    kernels, outside any counted burst."""
    import torch
    serve_warm_up(engine, prompts)
    sp, _, eos = sample_params(7)
    engine.generate(prompts[0][:40], max_new_tokens=2, eos_token_id=eos,
                    sampling=sp, timeout=600)
    torch.cuda.synchronize()


def sample_burst(engine, prompts):
    """The mixed burst of the sample_serve cell, like serve_burst: every
    prompt submitted at once with its sample_params. Returns ({i:
    handle}, {i: stream}, wall_s, steps, decode_iterations)."""
    steps0, dec0 = engine.steps, engine.decode_iterations
    t0 = time.perf_counter()
    handles = submit_all(engine, prompts, range(len(prompts)))
    outs = {i: h.result(timeout=900) for i, h in handles.items()}
    wall = time.perf_counter() - t0
    return (handles, outs, wall, engine.steps - steps0,
            engine.decode_iterations - dec0)


def _picks(recorded):
    n = min(SERVE_BUSY_STEPS, len(recorded))
    return [recorded[i * len(recorded) // n] for i in range(n)]


def _replay_wall_ms(torch, fn, picks):
    """Host wall ms a call of `fn` over `picks`, to a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in picks:
        fn(*a)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(picks)


def selection_busy(engine, steps):
    """(device ms, device ops, wall ms) a step of the engine's selection
    (`select_rows`): SERVE_BUSY_STEPS of the burst's sampled steps
    (toks, pos, adv, ctr, constrained) replayed after it through
    `_run_sampled_step` to capture their selection's inputs, then those
    calls replayed: device time and ops from torch.profiler (None when it
    saw no device time), wall from the host clock. Capturing after the
    burst keeps the burst's allocations as the engine makes them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving.llm import llm_engine
    select_rows = llm_engine.select_rows
    picks = []

    def capture(*a):
        picks.append(a)
        return select_rows(*a)

    llm_engine.select_rows = capture
    try:
        for a in _picks(steps):
            engine._run_sampled_step(engine._step_args(*a))
    finally:
        llm_engine.select_rows = select_rows
    _replay_wall_ms(torch, select_rows, picks)          # warm
    wall = _replay_wall_ms(torch, select_rows, picks)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for a in picks:
            select_rows(*a)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in ev)
    if busy_us <= 0:
        return None, None, wall
    return busy_us / 1e3 / len(picks), sum(e.count for e in ev) / len(picks), \
        wall


def sampled_step_cost(torch, engine, steps):
    """(greedy ms, sampled ms) of one unified step with its selection,
    SERVE_BUSY_STEPS of the burst's sampled steps (toks, pos, adv, ctr,
    constrained) replayed after it through the engine's greedy
    `_run_step` and its `_run_sampled_step`, host clock to a
    synchronize, in turns (greedy, sampled, sampled, greedy)."""
    picks = _picks(steps)

    def greedy(toks, pos, adv, ctr, constrained):
        engine._run_step(engine._step_args(toks, pos, adv))

    def sampled(*a):
        engine._run_sampled_step(engine._step_args(*a))

    g = [_replay_wall_ms(torch, greedy, picks)]
    s = [_replay_wall_ms(torch, sampled, picks) for _ in range(2)]
    g.append(_replay_wall_ms(torch, greedy, picks))
    return statistics.mean(g), statistics.mean(s)


def _first_token_on_cpu(torch, row, sp):
    """The port's CPU select_tokens on one captured fp32 logits row, at
    stream index 0 of the request's lane, no grammar."""
    from paddle_tpu_torch.serving.llm.sampling import select_tokens

    def t(a, dt):
        return torch.tensor([a], dtype=dt)

    tok, _ = select_tokens(
        row[None, None], t(1, torch.int32), t(sp.temperature, torch.float32),
        t(sp.top_k, torch.int32), t(sp.top_p, torch.float32),
        t(True, torch.bool), t(sp.seed, torch.int32), t(0, torch.int32),
        t(0, torch.int32), t(0, torch.int32),
        torch.zeros((1, 1, row.shape[-1]), dtype=torch.int32))
    return int(tok[0, 0])


def phase_sample_serve(serve, record=None):
    """The serve cell (full gpt3-1.3b, bf16, the same engine, prefix cache
    off, and 16 prompts) with a burst that mixes greedy, sampled and constrained
    requests by index (sample_params), launch counts zeroed just before
    it and read just after. `record`, a dict, receives the burst's
    streams and its tok/s, TTFT and decode step (phase_spec_serve holds
    its sampled run to them). Checks: every stream in-vocab and of its
    length; each greedy stream equal to the serve phase's stream of its
    prompt (`serve`, the record phase_serve filled); the top-k streams
    equal when resubmitted in reverse order beside other batch-mates;
    the first token of four sampled requests equal to the CPU's
    select_tokens on that step's logits row; every constrained stream
    valid JSON of the schema's shape, ending at EOS; paged attention and
    the LayerNorm forward launched. Reads tok/s, TTFT and decode step
    beside the serve phase's, the selection's device time and ops a
    step, and the host time a step of its operand assembly."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.serving.llm.sampling import compile_grammar

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, engine, prompts, init_s = serve_workload("sample_serve")
    vocab = model.config.vocab_size
    grammar, eos = sample_grammar()
    dfa = compile_grammar(grammar, vocab, eos)
    watch = {prompts[i].tobytes(): i for i in (1, 2, 5, 6)}
    first_logits = {}
    sampled_steps = []
    step_logits = engine._step_logits
    run_sampled_step = engine._run_sampled_step

    def capturing_step_logits(a):
        lg = step_logits(a)
        adv = a.adv
        for slot, req in engine._active.items():
            i = watch.get(req.prompt.tobytes())
            if i is not None and req.chunk_off < len(req.prompt) \
                    and req.chunk_off + int(adv[slot]) == len(req.prompt):
                first_logits[i] = lg[slot, int(adv[slot]) - 1].float().cpu()
        return lg

    def recording_sampled_step(a):
        sampled_steps.append((a.toks.copy(), a.pos.copy(), a.adv.copy(),
                              a.ctr.copy(), a.constrained))
        return run_sampled_step(a)

    engine._step_logits = capturing_step_logits
    engine._run_sampled_step = recording_sampled_step
    engine.start()
    try:
        sample_warm_up(engine, prompts)
        sampled_steps.clear()
        first_logits.clear()
        overhead0 = len(engine.metrics._mask_overhead_ms)
        _kernels.reset_launch_counts()
        handles, outs, wall, steps, _ = sample_burst(engine, prompts)
        launches = _kernels.launch_counts()
        watch.clear()
        stats = engine.metrics.snapshot()
        overhead = list(engine.metrics._mask_overhead_ms)[overhead0:]
        n_sampled = len(sampled_steps)
        topk = [i for i in range(len(prompts)) if i % 4 == 1]
        again = submit_all(engine, prompts, topk[::-1])
        mates = [engine.submit(prompts[i][:48], max_new_tokens=8)
                 for i in range(0, len(prompts), 4)]
        again = {i: h.result(timeout=900) for i, h in again.items()}
        for h in mates:
            h.result(timeout=900)
    finally:
        engine.stop(drain=True, timeout=60)
        engine._run_sampled_step = run_sampled_step
    must, _ = served_kernels("gpt3-1.3b")
    check(all(launches[k] > 0 for k in must),
          f"the mixed burst launched {launches}: want each of {must}")
    for i, o in outs.items():
        check(((o >= 0) & (o < vocab)).all(), f"request {i}: id out of range")
        sp, mnt, _ = sample_params(i)
        check(len(o) == mnt or (sp is not None and sp.constrained),
              f"request {i}: {len(o)} tokens, want {mnt}")
    greedy_equal = {i: bool(np.array_equal(outs[i], serve["streams"][i]))
                    for i in outs if i % 4 == 0}
    reorder_equal = {i: bool(np.array_equal(outs[i], again[i]))
                     for i in topk}
    first_equal = {i: _first_token_on_cpu(torch, first_logits[i],
                                          sample_params(i)[0])
                   == int(outs[i][0]) for i in sorted(first_logits)}
    texts = {SAMPLE_TOKEN0 + j: s for j, s in enumerate(SAMPLE_TEXTS)}
    texts[eos] = ""
    constrained = {}
    for i in (i for i in outs if i % 4 == 3):
        o, q = outs[i], 0
        for tkn in o:
            q = int(dfa.trans[q, int(tkn)]) if q >= 0 else -1
        text = "".join(texts.get(int(tkn), "�") for tkn in o)
        try:
            obj = json.loads(text)
        except ValueError:
            obj = None
        constrained[i] = dict(
            text=text, tokens=len(o), ends_at_eos=int(o[-1]) == eos,
            final_state_legal=q >= 0, shape_ok=(
                isinstance(obj, dict)
                and set(obj) == {"color", "count", "ok"}
                and obj["color"] in ("red", "green", "blue")
                and type(obj["count"]) is int and type(obj["ok"]) is bool))
    ttfts = sorted(h.ttft_ms for h in handles.values())
    gen_tokens = sum(len(o) for o in outs.values())
    engine.pool.check_balance()
    sel_ms, sel_ops, sel_wall = selection_busy(engine,
                                               sampled_steps[:n_sampled])
    greedy_ms, sampled_ms = sampled_step_cost(torch, engine,
                                              sampled_steps[:n_sampled])
    result = {
        "phase": "sample_serve", "model": "gpt3-1.3b", "dtype": "bfloat16",
        "requests": len(prompts),
        "modes": {m: [i for i in outs if i % 4 == k] for k, m in enumerate(
            ("greedy", "top_k", "top_p", "constrained"))},
        "generated_tokens": gen_tokens, "wall_s": wall,
        "generated_tok_s": gen_tokens / wall,
        "ttft_p50_ms": statistics.median(ttfts),
        "decode_step_p50_ms": stats["intertoken_p50_ms"],
        "serve_phase": {k: serve[k] for k in (
            "generated_tok_s", "ttft_p50_ms", "decode_step_p50_ms")},
        "steps": steps, "step_ms": wall * 1e3 / steps,
        "sampled_steps": n_sampled,
        "selection_device_ms_per_step": sel_ms,
        "selection_device_ops_per_step": sel_ops,
        "selection_wall_ms_per_step": sel_wall,
        "step_replay_greedy_select_ms": greedy_ms,
        "step_replay_sampled_select_ms": sampled_ms,
        "operand_host_ms_p50": (statistics.median(overhead)
                                if overhead else None),
        "sampled_tokens": stats["sampled_tokens"],
        "constrained_tokens": stats["constrained_tokens"],
        "greedy_equal_serve_phase": greedy_equal,
        "topk_equal_reordered": reorder_equal,
        "first_token_equal_cpu_select": first_equal,
        "constrained": constrained, "kernel_launches": launches,
        "model_init_s": init_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(result)
    if record is not None:
        record.update({k: result[k] for k in (
            "generated_tok_s", "ttft_p50_ms", "decode_step_p50_ms",
            "steps")}, streams=dict(outs))
    check(all(greedy_equal.values()),
          f"greedy streams differ from the serve phase's: {greedy_equal}")
    check(all(reorder_equal.values()),
          f"top-k streams changed with their batch-mates: {reorder_equal}")
    check(sorted(first_equal) == [1, 2, 5, 6] and all(first_equal.values()),
          f"first tokens against the CPU's select_tokens: {first_equal}")
    check(all(c["shape_ok"] and c["final_state_legal"] and c["ends_at_eos"]
              for c in constrained.values()),
          f"constrained streams: {constrained}")
    check(sel_ms is not None, "the profiler saw no selection kernel")
    del model, engine, handles, sampled_steps
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 5g
# spec_serve: speculative decoding on the serve cell (full gpt3-1.3b, bf16,
# SERVE_ENGINE plus spec_k = SPEC_K, the same 16 prompts and weights). Run
# A: the target model is also its own draft; every stream must equal the
# serve phase's bit for bit (both engines run the same [8, 64] step, so
# every GEMM sees one M, and a window column's attention past its own
# position adds exact zeros). Run B: full gpt3-125m as the draft (12 heads
# of 64, random weights from SPEC_DRAFT_SEED): the same streams, acceptance
# near 0. Run C: sample_serve's mixed burst on run A's engine: every
# stream equal to sample_serve's, windows committed, no constrained
# request given a draft row. Run D: run B's configuration with
# poison_request@SPEC_POISON:draft: exactly that request's draft
# quarantined, every stream still equal to serve's, the target breaker
# never charged. Each burst's launches are counted (zeroed just before,
# read just after) and held to what its target steps and draft forwards
# must launch, every paged launch on the tensor cores.
SPEC_K = 4
SPEC_ENGINE = dict(SERVE_ENGINE, spec_k=SPEC_K)
SPEC_DRAFT = "gpt3-125m"
SPEC_DRAFT_SEED = SEED + 20
SPEC_POISON = 6          # submit index of burst request 5 (the warm-up is 0)


def spec_engine(model, draft, plan=None):
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    from paddle_tpu_torch.utils.fault_injection import FaultPlan
    return LLMEngine(model, LLMEngineConfig(**SPEC_ENGINE), draft_model=draft,
                     fault_plan=FaultPlan.from_spec(plan or ""))


def count_forwards(model, box, key):
    """Count `model.forward_with_cache` calls into box[key]."""
    inner = model.forward_with_cache

    def counted(*a, **k):
        box[key] += 1
        return inner(*a, **k)

    model.forward_with_cache = counted


def record_draft_phase(engine, box):
    """Wrap the engine's draft phase: host ms of each pump's draft phase
    (to the proposals' copy back) and whether it proposed, into
    box["pumps"]; every catch-up's and propose's operands into
    box["catchup"] and box["propose"], for replays after the burst."""
    phase, catchup, propose = (engine._draft_phase, engine._catchup_attempt,
                               engine._propose_attempt)
    for k in ("pumps", "catchup", "propose"):
        box[k] = []

    def timed_phase():
        t0 = time.perf_counter()
        out = phase()
        box["pumps"].append(((time.perf_counter() - t0) * 1e3, bool(out)))
        return out

    def rec(kind, fn):
        def wrapped(d):
            box[kind].append(d)
            return fn(d)
        return wrapped

    engine._draft_phase = timed_phase
    engine._catchup_attempt = rec("catchup", catchup)
    engine._propose_attempt = rec("propose", propose)


def draft_busy(engine, recorded, kind):
    """(device-busy ms, wall ms) of one draft attempt of `kind`
    ("catchup" or "propose"): SERVE_BUSY_STEPS of the burst's recorded
    operands replayed after it through the engine's attempt callables
    (their writes land past every row's committed draft length): wall on
    the host clock to a synchronize, busy from torch.profiler (None when
    it recorded no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving.llm.llm_engine import _WriteFence
    picks = _picks(recorded)
    if not picks:
        return None, None
    make = (engine._catchup_attempt if kind == "catchup"
            else engine._propose_attempt)

    def replay():
        for d in picks:
            make(d)(_WriteFence())
        torch.cuda.synchronize()

    replay()
    t0 = time.perf_counter()
    replay()
    wall = (time.perf_counter() - t0) * 1e3 / len(picks)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        replay()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return (busy_us / 1e3 / len(picks) if busy_us > 0 else None), wall


def spec_burst(engine, prompts, box, fwd, draft_key, sample=False):
    """One burst through the started engine with the launch counts, the
    forward counts and the draft-phase records zeroed just before it and
    read just after: serve_burst's 16 requests, or sample_burst's mix.
    Returns (readings, {i: stream}, {i: handle}, launches, routes)."""
    from paddle_tpu_torch.ops import _kernels
    m0 = engine.metrics.snapshot()
    sp0 = (engine.spec_windows, engine.spec_drafted, engine.spec_accepted)
    allocs0 = engine.draft_pool.stats["allocs"]
    for k in ("pumps", "catchup", "propose"):
        box[k] = []
    for k in fwd:
        fwd[k] = 0
    _kernels.reset_launch_counts()
    if sample:
        handles, outs, wall, steps, dec = sample_burst(engine, prompts)
    else:
        hs, outs, wall, steps, dec = serve_burst(engine, prompts)
        handles, outs = dict(enumerate(hs)), dict(enumerate(outs))
    launches, routes = _kernels.launch_counts(), _kernels.route_counts()
    stats = engine.metrics.snapshot()
    windows, drafted, accepted = (engine.spec_windows - sp0[0],
                                  engine.spec_drafted - sp0[1],
                                  engine.spec_accepted - sp0[2])
    ttfts = sorted(h.ttft_ms for h in handles.values())
    gen = sum(len(o) for o in outs.values())
    pumps = box["pumps"]
    proposing = [ms for ms, p in pumps if p]
    target_fwd = steps
    draft_fwd = (fwd["all"] - steps if draft_key == "all"
                 else fwd[draft_key])
    readings = dict(
        requests=len(outs), generated_tokens=gen, wall_s=wall,
        generated_tok_s=gen / wall, ttft_p50_ms=statistics.median(ttfts),
        ttft_max_ms=ttfts[-1],
        decode_step_p50_ms=stats["intertoken_p50_ms"], steps=steps,
        decode_iterations=dec, spec_windows=windows, spec_drafted=drafted,
        spec_accepted=accepted,
        spec_accept_rate=accepted / drafted if drafted else None,
        draft_rows_given=engine.draft_pool.stats["allocs"] - allocs0,
        draft_quarantines=(stats["spec_draft_quarantines"]
                           - m0["spec_draft_quarantines"]),
        pumps=len(pumps), proposing_pumps=len(proposing),
        catchups=len(box["catchup"]), proposes=len(box["propose"]),
        draft_phase_host_ms_per_pump=(statistics.mean(ms for ms, _ in pumps)
                                      if pumps else None),
        draft_phase_host_ms_per_proposing_pump=(
            statistics.mean(proposing) if proposing else None),
        target_forwards=target_fwd, draft_forwards=draft_fwd,
        kernel_launches=launches, paged_launches_by_route=routes)
    return readings, outs, handles, launches, routes


def check_spec_launches(label, r, launches, routes, draft_layers):
    """Every target step launches 24 paged attentions and 49 LayerNorm
    forwards, every draft forward `draft_layers` and 2 * draft_layers + 1;
    nothing else launches; every paged launch takes the tensor cores."""
    from paddle_tpu_torch.ops.paged_attention import TENSOR_CORES
    t, d = r["target_forwards"], r["draft_forwards"]
    want = dict.fromkeys(launches, 0)
    want["paged_attention"] = 24 * t + draft_layers * d
    want["layernorm_fwd"] = 49 * t + (2 * draft_layers + 1) * d
    check(launches == want,
          f"spec_serve {label}: launched {launches} over {t} target steps "
          f"and {d} draft forwards, want {want}")
    want_routes = dict.fromkeys(routes, 0)
    want_routes[f"paged_attention:{TENSOR_CORES}"] = want["paged_attention"]
    check(routes == want_routes,
          f"spec_serve {label}: paged launches by route {routes}, want "
          f"{want_routes}")


def check_spec_drained(label, engine):
    engine.pool.check_balance()
    engine.draft_pool.check_balance()
    check(engine.draft_pool.active_slots() == 0,
          f"spec_serve {label}: {engine.draft_pool.active_slots()} draft "
          "rows left after the drain")


def phase_spec_serve(serve, sample):
    """Runs A-D above. `serve` and `sample` are the records phase_serve
    and phase_sample_serve filled. Returns the launches of the four
    bursts summed."""
    import numpy as np
    import torch
    from paddle_tpu_torch.obs.flight_recorder import flight_recorder
    from paddle_tpu_torch.ops.paged_attention import TENSOR_CORES, paged_route

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, init_s = serve_model("serve")
    prompts = serve_prompts(model.config.vocab_size)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SPEC_DRAFT_SEED)
    draft = model_class(SPEC_DRAFT).from_preset(
        SPEC_DRAFT, device="cuda", dtype="bfloat16", generator=gen)
    dcfg = draft.config
    fwd = {"all": 0, "draft": 0}
    count_forwards(model, fwd, "all")
    count_forwards(draft, fwd, "draft")
    runs, totals = {}, {}

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    def equal_streams(outs, ref):
        return {i: bool(np.array_equal(outs[i], ref[i])) for i in outs}

    # run A (self draft), then run C on the same engine
    box = {}
    eng = spec_engine(model, model)
    record_draft_phase(eng, box)
    eng.start()
    try:
        sample_warm_up(eng, prompts)
        ra, outs, _, la, rta = spec_burst(eng, prompts, box, fwd, "all")
        busy = {k: draft_busy(eng, list(box[k]), k)
                for k in ("catchup", "propose")}
        rc, outs_c, _, lc, rtc = spec_burst(eng, prompts, box, fwd, "all",
                                            sample=True)
    finally:
        eng.stop(drain=True, timeout=60)
    check_spec_drained("A/C", eng)
    ra["streams_equal_serve"] = equal_streams(outs, serve["streams"])
    ra["draft_attempt_device_ms"] = {k: v[0] for k, v in busy.items()}
    ra["draft_attempt_replay_wall_ms"] = {k: v[1] for k, v in busy.items()}
    if None not in ra["draft_attempt_device_ms"].values():
        ra["draft_phase_device_ms_per_pump"] = sum(
            ra[k + "s"] * ms for k, ms in
            ra["draft_attempt_device_ms"].items()) / ra["pumps"]
    rc["streams_equal_sample_serve"] = equal_streams(outs_c,
                                                     sample["streams"])
    n_unconstrained = sum(1 for i in outs_c if sample_params(i)[0] is None
                          or not sample_params(i)[0].constrained)
    runs["a_self_draft"], runs["c_sampled_mix"] = ra, rc
    check_spec_launches("A", ra, la, rta, model.config.num_hidden_layers)
    check_spec_launches("C", rc, lc, rtc, model.config.num_hidden_layers)
    add(la)
    add(lc)
    del eng, box

    # run B (gpt3-125m draft), then run D with its draft poisoned
    for label, plan in (("b_mismatched_draft", None),
                        ("d_poisoned_draft",
                         f"poison_request@{SPEC_POISON}:draft")):
        box = {}
        eng = spec_engine(model, draft, plan)
        record_draft_phase(eng, box)
        eng.start()
        try:
            serve_warm_up(eng, prompts)
            flight_recorder().clear()
            r, outs, handles, lb, rtb = spec_burst(eng, prompts, box, fwd,
                                                   "draft")
            events = flight_recorder().snapshot()["events"]
        finally:
            eng.stop(drain=True, timeout=60)
        check_spec_drained(label, eng)
        r["streams_equal_serve"] = equal_streams(outs, serve["streams"])
        r["draft_paged_launches_d64"] = (dcfg.num_hidden_layers
                                         * r["draft_forwards"])
        r["supervisor"] = eng.supervisor.snapshot()
        r["quarantined"] = eng.metrics.snapshot()["quarantined"]
        quar = [e["submit_idx"] for e in events
                if e["kind"] == "draft_quarantine"]
        r["draft_quarantined_submit_idx"] = quar
        if plan is not None:
            r["draft_quarantined_requests"] = [
                i for i, h in handles.items()
                if any(e.get("rid") == h.rid for e in events
                       if e["kind"] == "draft_quarantine")]
        runs[label] = r
        check_spec_launches(label, r, lb, rtb, dcfg.num_hidden_layers)
        add(lb)
        del eng, box
    emit({"phase": "spec_serve", "model": "gpt3-1.3b", "dtype": "bfloat16",
          "spec_k": SPEC_K, "draft_b": SPEC_DRAFT,
          "draft_b_heads": dict(H=dcfg.num_attention_heads,
                                D=dcfg.hidden_size // dcfg.num_attention_heads,
                                layers=dcfg.num_hidden_layers),
          "draft_b_paged_route": paged_route(
              torch.bfloat16, SERVE_ENGINE["block_len"],
              dcfg.hidden_size // dcfg.num_attention_heads),
          "serve_phase": {k: serve[k] for k in (
              "generated_tok_s", "ttft_p50_ms", "ttft_max_ms",
              "decode_step_p50_ms", "steps", "decode_iterations")},
          "sample_serve_phase": {k: sample[k] for k in (
              "generated_tok_s", "ttft_p50_ms", "decode_step_p50_ms",
              "steps")},
          "runs": runs, "model_init_s": init_s,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    ra, rb = runs["a_self_draft"], runs["b_mismatched_draft"]
    rc, rd = runs["c_sampled_mix"], runs["d_poisoned_draft"]
    for label, r in runs.items():
        key = ("streams_equal_sample_serve" if label == "c_sampled_mix"
               else "streams_equal_serve")
        check(len(r[key]) == len(prompts) and all(r[key].values()),
              f"spec_serve {label}: streams differ from the plain "
              f"engine's: {r[key]}")
    check(ra["spec_windows"] > 0 and ra["spec_accepted"] > 0,
          f"spec_serve A: {ra['spec_windows']} windows, "
          f"{ra['spec_accepted']} accepted")
    check(rb["spec_windows"] > 0, "spec_serve B: no window committed")
    check(rc["spec_windows"] > 0, "spec_serve C: no window committed")
    check(rc["draft_rows_given"] == n_unconstrained,
          f"spec_serve C: {rc['draft_rows_given']} draft rows for "
          f"{n_unconstrained} unconstrained requests")
    check(rd["draft_quarantines"] == 1
          and rd["draft_quarantined_submit_idx"] == [SPEC_POISON],
          f"spec_serve D: draft quarantines {rd['draft_quarantines']} of "
          f"submit indices {rd['draft_quarantined_submit_idx']}, want "
          f"[{SPEC_POISON}]")
    sup = rd["supervisor"]
    check(sup["dispatch_failures"] == 0 and sup["quarantines"] == 0
          and sup["breaker_trips"] == 0 and rd["quarantined"] == 0
          and sup["exempt_failures"] >= 1,
          f"spec_serve D: the target was charged: {sup}, quarantined "
          f"{rd['quarantined']}")
    check(paged_route(torch.bfloat16, SERVE_ENGINE["block_len"],
                      dcfg.hidden_size // dcfg.num_attention_heads)
          == TENSOR_CORES, "the draft's paged attention is not routed to "
                           "the tensor cores")
    del model, draft
    gc.collect()
    torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------- phase 5h
# frontend_serve: the serving front end on the serve cell (full gpt3-1.3b,
# bf16, SERVE_ENGINE, the 16 prompts, weights from SEED, MonotonicClock
# engines with their own scheduler threads). Run A: ServingServer over one
# LLMEngine; the 16 prompts POSTed to /generate by 16 client threads at
# once, then sample_serve's mixed burst with its sampling fields: streams
# equal serve's and sample_serve's; tok/s and TTFT through HTTP beside
# serve's. Run B: RouterServer over two InProcessReplicas, each engine on
# its own model: a fault-free burst (the fleet's tok/s, two engines on one
# card), then a burst during which replica_crash@0 is armed once
# FRONTEND_MIN_VICTIMS of replica 0's streams have emitted: every request
# 200 with serve's stream (the victims re-prefilled on replica 1), replica
# 0 read "quarantined", router_failover events = resumed streams = the
# responses' failovers, at least FRONTEND_MIN_VICTIMS of them.
# Run C: roles prefill and decode: every stream handed off after its first
# token, equal to serve's, no failed handoff; the export's host ms. Run D:
# a v2 (gpt3-1.3b from FRONTEND_V2_SEED) published as a WeightSet, then
# POST /deploy, and a burst as soon as it answers (it certifies and loads
# the set first), so the streams run through the drains and swaps: every
# stream 200 and equal to serve's (all are placed before replica 0's swap
# is readmitted, on v0), /healthz all v2, a burst after it equal to a
# plain engine's on v2's model; the seconds of the publish, of a certify
# timed on its own and of the POST (a certify and a load), each replica's
# drain and canary ms from the rollout's flight events, and the ms of a
# swap (the plain engine rebound to its own tensors). Run E: the same set
# deployed again
# under deploy_bad_weights@1 (the controller's second deploy): the canary
# fails, every replica holds its prior tensors again, a burst after it
# equals D's, and pdtpu_deploy_* reads one rollback. Launch counts are
# zeroed just before run A's first burst and read after run E; every paged
# launch takes the tensor cores.
FRONTEND_V2_SEED = SEED + 30
FRONTEND_TIMEOUT_S = 900.0
FRONTEND_CLIENTS = 16
# run B's crash is armed once this many of replica 0's streams (of its 8
# slots) have emitted, and must fail over at least this many
FRONTEND_MIN_VICTIMS = 4


def http_json(base, path, body=None):
    """(status, JSON body) of one request to a local server."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=FRONTEND_TIMEOUT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_text(base, path):
    import urllib.request
    with urllib.request.urlopen(base + path,
                                timeout=FRONTEND_TIMEOUT_S) as r:
        return r.read().decode()


def http_burst(base, bodies, box=None):
    """POST every body of `bodies` ({i: body}) to /generate at once, one
    client thread each, released together. Returns ({i: (status, body)},
    wall_s) and also puts them in `box` when given (for a burst run on a
    thread of its own)."""
    import threading
    out = {}
    gate = threading.Barrier(len(bodies) + 1)

    def client(i, body):
        gate.wait()
        out[i] = http_json(base, "/generate", body)

    threads = [threading.Thread(target=client, args=(i, b))
               for i, b in bodies.items()]
    for t in threads:
        t.start()
    gate.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    res = (out, time.perf_counter() - t0)
    if box is not None:
        box["burst"] = res
    return res


def sample_body(prompt, i):
    """The /generate body of request i of the mixed burst: sample_params'
    fields as JSON (a grammar's token ids become string keys, which the
    server turns back)."""
    sp, mnt, eos = sample_params(i)
    body = {"input_ids": prompt.tolist(), "max_new_tokens": mnt}
    if eos is not None:
        body["eos_token_id"] = eos
    if sp is not None:
        body.update(temperature=sp.temperature, top_k=sp.top_k,
                    top_p=sp.top_p)
        if sp.seed is not None:
            body["seed"] = sp.seed
        if sp.grammar is not None:
            body["grammar"] = sp.grammar
    return body


def burst_readings(out, wall, ref):
    """Readings of an HTTP burst against reference streams `ref` ({i:
    tokens}): statuses, streams equal, tok/s, TTFT p50 and max."""
    import numpy as np
    ok = {i: s == 200 for i, (s, _) in out.items()}
    equal = {i: ok[i] and np.array_equal(np.asarray(b["tokens"]), ref[i])
             for i, (_, b) in out.items()}
    ttfts = sorted(b["ttft_ms"] for s, b in out.values() if s == 200)
    toks = sum(len(b["tokens"]) for s, b in out.values() if s == 200)
    return dict(requests=len(out), all_200=all(ok.values()),
                streams_equal=all(equal.values()),
                unequal=[i for i, e in equal.items() if not e],
                generated_tokens=toks, wall_s=wall,
                generated_tok_s=toks / wall,
                ttft_p50_ms=statistics.median(ttfts) if ttfts else None,
                ttft_max_ms=ttfts[-1] if ttfts else None,
                failovers=sum(b.get("failovers", 0)
                              for s, b in out.values() if s == 200))


def frontend_fleet(models, roles=None, plan=None):
    """A ReplicaRouter over one LLMEngine (SERVE_ENGINE, MonotonicClock) a
    model, replica i of role roles[i]."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    roles = roles or ["mixed"] * len(models)
    return serving.ReplicaRouter([
        serving.InProcessReplica(LLMEngine(m, LLMEngineConfig(
            **SERVE_ENGINE)), i, fault_plan=plan, role=roles[i])
        for i, m in enumerate(models)])


def wait_for(cond, what, timeout_s=FRONTEND_TIMEOUT_S, poll_s=0.002):
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < timeout_s,
              f"frontend_serve: timed out waiting for {what}")
        time.sleep(poll_s)


def streams_emitting(router, submitted, replica, n):
    """True once the router has taken `submitted` requests in all and at
    least `n` streams in flight on `replica` have emitted a token."""
    if router.metrics.snapshot()["submitted"] < submitted:
        return False
    with router._lock:
        return sum(1 for h in router._inflight.values()
                   if h._replica is replica and h.tokens_so_far()) >= n


def deploy_wait(base):
    """Poll /debug/deploy until the rollout is over; its last record."""
    box = {}

    def idle():
        box["st"] = http_json(base, "/debug/deploy")[1]
        return box["st"]["state"] == "idle"

    wait_for(idle, "the rollout to finish", poll_s=0.02)
    return box["st"]["history"][-1]


def deploy_phase_ms(events):
    """{replica: {drain_ms, canary_ms}} from a rollout's flight events:
    drain_ms from its deploy_drain event to its deploy_swap (the wait for
    its streams to settle, and the swap), canary_ms from that swap to its
    canary verdict (every golden prompt, and the controller's pumps
    between)."""
    out = {}
    t = {}
    for e in events:
        r = e.get("replica")
        if e["kind"] == "deploy_drain":
            t[r] = e["t_mono"]
        elif e["kind"] == "deploy_swap" and not e.get("rollback") \
                and r in t:
            out.setdefault(r, {})["drain_ms"] = (e["t_mono"] - t[r]) * 1e3
            t[r] = e["t_mono"]
        elif e["kind"] in ("deploy_canary_pass", "deploy_canary_fail") \
                and r in t:
            out.setdefault(r, {})["canary_ms"] = \
                (e["t_mono"] - t[r]) * 1e3
    return out


def phase_frontend_serve(serve, sample):
    """Runs A-E above. `serve` and `sample` are the records phase_serve
    and phase_sample_serve filled. Returns the launches of the five runs."""
    import shutil
    import threading
    import numpy as np
    import torch
    from paddle_tpu_torch import serving
    from paddle_tpu_torch import checkpoint
    from paddle_tpu_torch.obs.flight_recorder import flight_recorder
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.ops.paged_attention import TENSOR_CORES
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    from paddle_tpu_torch.utils import fault_injection as fi

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, engine, prompts, init_s = serve_workload("serve")
    greedy = {i: {"input_ids": p.tolist(), "max_new_tokens": SERVE_NEW_TOKENS}
              for i, p in enumerate(prompts)}
    ref = serve["streams"]
    runs = {}

    # run A: ServingServer over one engine
    server = serving.ServingServer(
        llm_engine=engine, request_timeout_s=FRONTEND_TIMEOUT_S).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        sample_warm_up(engine, prompts)
        _kernels.reset_launch_counts()
        a_out, a_wall = http_burst(base, greedy)
        m_out, m_wall = http_burst(base, {i: sample_body(p, i)
                                          for i, p in enumerate(prompts)})
        health = http_json(base, "/healthz")
        flat = serving.parse_exposition(http_text(base, "/metrics"))
    finally:
        server.stop()
    ra = burst_readings(a_out, a_wall, ref)
    ra["mixed_burst"] = burst_readings(m_out, m_wall, sample["streams"])
    ra["serve_phase"] = {k: serve[k] for k in (
        "generated_tok_s", "ttft_p50_ms", "ttft_max_ms")}
    ra["healthz"] = health
    ra["llm_completed"] = flat.get(
        'pdtpu_llm_requests_total{outcome="completed"}')
    runs["a_serving_server"] = ra
    check(ra["all_200"] and ra["streams_equal"]
          and ra["mixed_burst"]["all_200"]
          and ra["mixed_burst"]["streams_equal"],
          f"frontend_serve A: streams through HTTP differ from serve's / "
          f"sample_serve's: {ra['unequal']}, {ra['mixed_burst']['unequal']}")
    check(health[0] == 200 and health[1]["status"] == "ok"
          and health[1]["llm_weight_version"] == "v0",
          f"frontend_serve A: /healthz {health}")
    check(ra["llm_completed"] == 2 * len(prompts) + 2,
          f"frontend_serve A: /metrics completed {ra['llm_completed']}")
    del engine, server

    # run B: RouterServer over two replicas, a fault-free burst, then
    # replica_crash@0 once replica 0's streams have emitted
    model1, init1_s = serve_model("serve")
    plan = fi.FaultPlan()
    router = frontend_fleet([model, model1], plan=plan)
    server = serving.RouterServer(
        router, request_timeout_s=FRONTEND_TIMEOUT_S).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        for r in router.replicas:
            serve_warm_up(r.engine, prompts)
        f_out, f_wall = http_burst(base, greedy)
        flight_recorder().clear()
        sub0 = router.metrics.snapshot()["submitted"]
        box = {}
        burst = threading.Thread(target=http_burst, args=(base, greedy, box))
        burst.start()
        wait_for(lambda: streams_emitting(router, sub0 + len(prompts),
                                          router.replicas[0],
                                          FRONTEND_MIN_VICTIMS),
                 "replica 0's streams to emit", timeout_s=120)
        with router._lock:
            armed_at = {h.rid: len(h.tokens_so_far())
                        for h in router._inflight.values()
                        if h._replica is router.replicas[0]}
        plan.add("replica_crash", 0)
        burst.join()
        wait_for(lambda: http_json(base, "/healthz")[1]["replicas"][
            "replica0"] == "quarantined", "replica 0's quarantine",
            poll_s=0.02)
        health = http_json(base, "/healthz")
        flat = serving.parse_exposition(http_text(base, "/metrics"))
        events = [e for e in flight_recorder().snapshot()["events"]
                  if e["kind"] == "router_failover"]
    finally:
        server.stop()
    rb = burst_readings(*box["burst"], ref)
    rb["fault_free_burst"] = burst_readings(f_out, f_wall, ref)
    rb["armed_at_emitted"] = sorted(armed_at.values())
    rb["router_failover_events"] = len(events)
    rb["resumed_streams"] = flat["pdtpu_router_resumed_streams_total"]
    rb["healthz"] = health[1]
    rb["routed"] = {k: v for k, v in flat.items()
                    if k.startswith("pdtpu_router_routed_total")}
    runs["b_router_failover"] = rb
    check(rb["fault_free_burst"]["all_200"]
          and rb["fault_free_burst"]["streams_equal"],
          f"frontend_serve B: fault-free fleet streams differ from serve's: "
          f"{rb['fault_free_burst']['unequal']}")
    check(rb["all_200"] and rb["streams_equal"],
          f"frontend_serve B: streams across the failover differ from "
          f"serve's: {rb['unequal']}")
    check(rb["healthz"]["replicas"] == {"replica0": "quarantined",
                                        "replica1": "ok"},
          f"frontend_serve B: /healthz {rb['healthz']}")
    check(rb["router_failover_events"] == rb["resumed_streams"]
          == rb["failovers"] >= FRONTEND_MIN_VICTIMS,
          f"frontend_serve B: failover events {rb['router_failover_events']}"
          f", resumed {rb['resumed_streams']}, responses' failovers "
          f"{rb['failovers']}")
    del router, server

    # run C: prefill/decode handoff
    router = frontend_fleet([model, model1], roles=["prefill", "decode"])
    src = router.replicas[0]
    export_ms = []

    def timed_export(rid, _orig=src.export_stream):
        t0 = time.perf_counter()
        payload = _orig(rid)
        export_ms.append((time.perf_counter() - t0) * 1e3)
        return payload

    src.export_stream = timed_export
    router.start()
    try:
        for r in router.replicas:
            serve_warm_up(r.engine, prompts)
        flight_recorder().clear()
        t0 = time.perf_counter()
        hs = [router.submit(p, max_new_tokens=SERVE_NEW_TOKENS)
              for p in prompts]
        outs = {i: h.result(timeout=FRONTEND_TIMEOUT_S)
                for i, h in enumerate(hs)}
        c_wall = time.perf_counter() - t0
        snap = router.metrics.snapshot()
        imported = router.replicas[1].engine.kv_import_tokens
        kv_tokens = [e["kv_tokens"] for e in flight_recorder().snapshot()[
            "events"] if e["kind"] == "router_handoff"]
    finally:
        router.stop()
    rc = dict(wall_s=c_wall, generated_tok_s=sum(len(o) for o in
                                                 outs.values()) / c_wall,
              streams_equal={i: bool(np.array_equal(o, ref[i]))
                             for i, o in outs.items()},
              handoffs=snap["handoffs"],
              handoffs_failed=snap["handoffs_failed"],
              export_ms_p50=statistics.median(export_ms) if export_ms
              else None, export_ms_max=max(export_ms, default=None),
              export_ms_per_kv_token=(sum(export_ms) / sum(kv_tokens)
                                      if kv_tokens else None),
              kv_import_tokens=imported, handoff_kv_tokens=sum(kv_tokens),
              # the rows a handoff exported past the one-token minimum:
              # the prefill replica's scheduler stepped again before the
              # router's next pump exported the stream
              extra_tokens_exported=sum(kv_tokens) - sum(
                  len(p) for p in prompts),
              decoded_on=sorted({h._replica.name for h in hs}))
    runs["c_handoff"] = rc
    check(all(rc["streams_equal"].values()),
          f"frontend_serve C: handed-off streams differ from serve's: "
          f"{rc['streams_equal']}")
    check(rc["handoffs"] == len(kv_tokens) == len(prompts)
          and rc["handoffs_failed"] == 0
          and rc["kv_import_tokens"] == rc["handoff_kv_tokens"]
          and rc["extra_tokens_exported"] >= 0
          and rc["decoded_on"] == ["replica1"],
          f"frontend_serve C: handoffs {rc['handoffs']}, failed "
          f"{rc['handoffs_failed']}, imported {rc['kv_import_tokens']}, "
          f"decoded on {rc['decoded_on']}")
    del router, src

    # run D: a rolling deploy of v2 while a burst runs; run E: the same
    # set again with NaN-poisoned weights
    gen = torch.Generator(device="cuda")
    gen.manual_seed(FRONTEND_V2_SEED)
    v2 = model_class("gpt3-1.3b").from_preset(
        "gpt3-1.3b", device="cuda", dtype="bfloat16", generator=gen)
    wdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "frontend_weights")
    shutil.rmtree(wdir, ignore_errors=True)
    t0 = time.perf_counter()
    checkpoint.WeightSet.publish(wdir, "v2", dict(v2.state_dict()))
    publish_s = time.perf_counter() - t0
    # one certify (a CRC pass) on its own: the POST certifies and loads
    # (load certifies again, then reads), so its load is the POST's time
    # less this
    t0 = time.perf_counter()
    checkpoint.WeightSet(wdir, "v2").certify()
    certify_s = time.perf_counter() - t0
    router = frontend_fleet([model, model1])
    server = serving.RouterServer(
        router, request_timeout_s=FRONTEND_TIMEOUT_S).start()
    base = f"http://127.0.0.1:{server.port}"
    prior_plan = fi.global_plan()
    fi.set_global_plan(fi.FaultPlan.from_spec("deploy_bad_weights@1"))
    try:
        for r in router.replicas:
            serve_warm_up(r.engine, prompts)
        flight_recorder().clear()
        # the POST certifies and loads the set before it answers 202; the
        # rollout then drains replica 0 on its own thread while the burst
        # arrives, so the burst's streams run through the drains and swaps
        t0 = time.perf_counter()
        code_d, st_d = http_json(base, "/deploy",
                                 {"directory": wdir, "version": "v2"})
        post_d_s = time.perf_counter() - t0
        box = {}
        burst = threading.Thread(target=http_burst, args=(base, greedy, box))
        burst.start()
        burst.join()
        rec_d = deploy_wait(base)
        events_d = flight_recorder().snapshot()["events"]
        health_d = http_json(base, "/healthz")[1]
        post_d = http_burst(base, greedy)
        ptrs = {r.name: {k: v.data_ptr() for k, v in r.engine.params.items()}
                for r in router.replicas}
        flight_recorder().clear()
        t0 = time.perf_counter()
        code_e, st_e = http_json(base, "/deploy",
                                 {"directory": wdir, "version": "v2"})
        post_e_s = time.perf_counter() - t0
        rec_e = deploy_wait(base)
        events_e = flight_recorder().snapshot()["events"]
        back = {r.name: all(v.data_ptr() == ptrs[r.name][k]
                            for k, v in r.engine.params.items())
                for r in router.replicas}
        health_e = http_json(base, "/healthz")[1]
        post_e = http_burst(base, greedy)
        flat = serving.parse_exposition(http_text(base, "/metrics"))
    finally:
        fi.set_global_plan(prior_plan)
        server.stop()
        shutil.rmtree(wdir, ignore_errors=True)
    launches = _kernels.launch_counts()
    routes = _kernels.route_counts()
    # the v2 reference: a plain engine on v2's model; a swap of it to its
    # own tensors makes the checks and the rebind of any swap, timed
    plain = LLMEngine(v2, LLMEngineConfig(**SERVE_ENGINE))
    t0 = time.perf_counter()
    plain.replace_params(dict(v2.state_dict()), "v2")
    swap_ms = (time.perf_counter() - t0) * 1e3
    plain.start()
    try:
        serve_warm_up(plain, prompts)
        _, v2_outs, _, _, _ = serve_burst(plain, prompts)
    finally:
        plain.stop(drain=True, timeout=60)
    v2_ref = dict(enumerate(v2_outs))
    rd = burst_readings(*box["burst"], ref)
    rd.update(deploy_status=code_d, record=rec_d,
              weight_versions=health_d["weight_versions"],
              post_deploy=burst_readings(*post_d, v2_ref),
              publish_s=publish_s, certify_s=certify_s,
              load_s=post_d_s - certify_s, deploy_post_s=post_d_s,
              swap_ms=swap_ms,
              by_replica=deploy_phase_ms(events_d),
              kinds=[e["kind"] for e in events_d
                     if e["kind"].startswith("deploy_")])
    runs["d_rolling_deploy"] = rd
    post_e_ref = {i: np.asarray(b["tokens"]) for i, (_, b) in
                  post_d[0].items()}
    re_ = dict(deploy_status=code_e, record=rec_e, back_on_prior=back,
               weight_versions=health_e["weight_versions"],
               post_rollback=burst_readings(*post_e, post_e_ref),
               deploy_post_s=post_e_s, by_replica=deploy_phase_ms(events_e),
               kinds=[e["kind"] for e in events_e
                      if e["kind"].startswith("deploy_")],
               deploy_families={k: v for k, v in flat.items()
                                if k.startswith("pdtpu_deploy_")})
    runs["e_bad_weights_rollback"] = re_
    emit({"phase": "frontend_serve", "model": "gpt3-1.3b",
          "dtype": "bfloat16", "engine": SERVE_ENGINE,
          "requests": len(prompts), "v2_seed": FRONTEND_V2_SEED,
          "runs": runs, "kernel_launches": launches,
          "paged_launches_by_route": routes,
          "model_init_s": [init_s, init1_s],
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    check(code_d == 202 and rec_d["outcome"] == "completed"
          and rd["all_200"] and rd["streams_equal"],
          f"frontend_serve D: deploy {code_d} {rec_d}, streams during it "
          f"equal serve's: {rd['streams_equal']} ({rd['unequal']})")
    check(set(rd["weight_versions"].values()) == {"v2"},
          f"frontend_serve D: versions {rd['weight_versions']}")
    check(rd["post_deploy"]["all_200"] and rd["post_deploy"]["streams_equal"],
          f"frontend_serve D: the burst after the deploy differs from a "
          f"plain engine's on v2: {rd['post_deploy']['unequal']}")
    check(code_e == 202 and rec_e["outcome"] == "rolled_back"
          and rec_e["reason"].startswith("canary_fail:nonfinite_logits"),
          f"frontend_serve E: deploy {code_e} {rec_e}")
    check(all(back.values()) and set(re_["weight_versions"].values())
          == {"v2"}, f"frontend_serve E: not back on the prior tensors: "
                     f"{back}, {re_['weight_versions']}")
    check(re_["post_rollback"]["all_200"]
          and re_["post_rollback"]["streams_equal"],
          f"frontend_serve E: the burst after the rollback differs from "
          f"D's: {re_['post_rollback']['unequal']}")
    fam = re_["deploy_families"]
    check(fam.get('pdtpu_deploy_deploys_total{outcome="rolled_back"}') == 1
          and fam.get('pdtpu_deploy_deploys_total{outcome="completed"}') == 1
          and sum(v for k, v in fam.items()
                  if k.startswith("pdtpu_deploy_rollbacks_total")) == 1,
          f"frontend_serve E: deploy families {fam}")
    must, must_not = served_kernels("gpt3-1.3b")
    check(all(launches[k] > 0 for k in must)
          and not any(launches[k] for k in must_not),
          f"frontend_serve launched {launches}: want each of {must}, none "
          f"of {must_not}")
    want_routes = dict.fromkeys(routes, 0)
    want_routes[f"paged_attention:{TENSOR_CORES}"] = \
        launches["paged_attention"]
    check(routes == want_routes,
          f"frontend_serve: paged launches by route {routes}, want "
          f"{want_routes}")
    del model, model1, v2, router, server
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 5d
PREFIX_SHARED = 256          # the shared system prompt: 32 blocks of 8
PREFIX_DONOR_SUFFIX = 32
PREFIX_SUFFIXES = [16 + (144 - 16) * i // 14 for i in range(15)]  # 16..144
PREFIX_HOST_BYTES = 1 << 30  # the host tier: ~680 pages of 1.5 MiB
PREFIX_PRESSURE_LEN = 264    # 33 blocks, sharing no block with the rest
PREFIX_PRESSURE_MAX = 32     # prompts allowed before the prefix must spill


def prefix_prompts(vocab):
    """(shared prefix, donor prompt, 15 warm prompts), drawn from SEED + 2:
    256 shared tokens, then a 32-token suffix (the donor) or suffixes of
    16..144 tokens."""
    import numpy as np
    rng = np.random.RandomState(SEED + 2)
    shared = rng.randint(0, vocab, (PREFIX_SHARED,)).astype(np.int32)

    def with_suffix(n):
        return np.concatenate(
            [shared, rng.randint(0, vocab, (n,)).astype(np.int32)])

    donor = with_suffix(PREFIX_DONOR_SUFFIX)
    return shared, donor, [with_suffix(n) for n in PREFIX_SUFFIXES]


def _drive(engine):
    """Pump an engine on this thread until it is idle."""
    while engine.has_work():
        engine.pump()


def _prefix_burst(engine, donor, warm):
    """The donor alone, then the warm prompts at once. Returns (donor
    handle, warm handles, the burst's readings)."""
    import torch
    h0 = engine.submit(donor, logprobs=True)
    _drive(engine)
    torch.cuda.synchronize()
    pre0, steps0 = engine.prefill_tokens, engine.steps
    t0 = time.perf_counter()
    hs = [engine.submit(p, logprobs=True) for p in warm]
    _drive(engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ttfts = sorted(h.ttft_ms for h in hs)
    gen = sum(len(h.result(0)) for h in hs)
    return h0, hs, dict(
        prefilled_tokens=engine.prefill_tokens - pre0,
        steps=engine.steps - steps0, wall_s=wall,
        generated_tok_s=gen / wall,
        ttft_p50_ms=statistics.median(ttfts), ttft_min_ms=ttfts[0],
        ttft_max_ms=ttfts[-1],
        decode_step_p50_ms=engine.metrics.snapshot()["intertoken_p50_ms"])


def phase_prefix_serve():
    """The serve cell's model (full gpt3-1.3b, bf16, random weights from
    SEED) behind the serve engine with the prefix cache on and a 1 GiB
    host tier, pumped on this thread on a MonotonicClock; launch counts
    zeroed just before the parts and read just after.

    a. Shared prefix: a donor (256 shared + 32 tokens) alone, then 15
       prompts of the same 256 tokens with suffixes of 16..144 at once.
       Each warm request hits exactly 256 tokens, so it prefills
       len - 256; prefix_hits is 15. A cold twin (cache off) serves the
       same prompts in the same order first; every warm stream equals its
       cold stream bit for bit. Readings: prefilled tokens, TTFT p50 and
       max, generated tok/s, decode step p50, warm beside cold.
    b. The last warm prompt again: one prefilled token, one more COW, its
       stream equal to its first run.
    c. Distinct 264-token prompts (2 new tokens) until the trie holds none
       of the shared prefix while prefix_probe still finds all 256 tokens
       (in the host tier), at most 32; then the second warm prompt again:
       at least 256 tokens onboarded, a multiple of 8, the rest
       prefilled, its cold stream. Readings: pages spilled, ms a spilled
       page, ms a page onboarded, the host ms of an admission that
       spilled.
    d. The same prompt under tenant "b": no hit, no onboard, its cold
       stream.
    e. Handoff: the third warm prompt's stream exported after its first
       token and resubmitted with its kv_row and lane into a second
       engine: len(prompt) tokens imported, one prefilled, the cold
       stream.
    check_balance() after each part; paged attention (tensor-core route)
    and the LayerNorm forward launched."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.ops.paged_attention import (TENSOR_CORES,
                                                      paged_route)
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, init_s = serve_model("serve")
    vocab = model.config.vocab_size
    shared, donor, warm = prefix_prompts(vocab)
    warm_cfg = dict(SERVE_ENGINE, enable_prefix_cache=True,
                    host_kv_bytes=PREFIX_HOST_BYTES)
    ns = "default"
    _kernels.reset_launch_counts()

    # a. the cold twin first (it also warms the process), then cache on
    cold_eng = LLMEngine(model, LLMEngineConfig(**SERVE_ENGINE))
    c0, cold_hs, cold = _prefix_burst(cold_eng, donor, warm)
    c_pre = cold["prefilled_tokens"]
    cold_streams = [c0.result(0)] + [h.result(0) for h in cold_hs]
    cold_lps = [c0.logprobs_so_far()] + [h.logprobs_so_far()
                                         for h in cold_hs]
    cold_eng.pool.check_balance()
    del cold_eng, cold_hs
    gc.collect()
    eng = LLMEngine(model, LLMEngineConfig(**warm_cfg))
    lookups = []
    on_lookup = eng.metrics.on_prefix_lookup

    def record_lookup(tenant, hit, n):
        lookups.append((tenant, int(hit), int(n)))
        on_lookup(tenant, hit, n)

    eng.metrics.on_prefix_lookup = record_lookup
    # each pressure eviction walks the whole trie for its LRU victim
    walks = []
    lru_victim = eng.prefix_cache._lru_victim

    def timed_victim():
        t0 = time.perf_counter()
        out = lru_victim()
        walks.append((time.perf_counter() - t0) * 1e3)
        return out

    eng.prefix_cache._lru_victim = timed_victim
    w0, warm_hs, warm_r = _prefix_burst(eng, donor, warm)
    w_pre = warm_r["prefilled_tokens"]
    # the spills that pressure made inside the warm burst, on its path
    warm_r.update(spilled_pages=eng.prefix_cache.spilled_pages,
                  spill_s=eng.prefix_cache.spill_seconds,
                  alloc_failures=eng.pool.stats["alloc_failures"])
    warm_streams = [w0.result(0)] + [h.result(0) for h in warm_hs]
    eng.pool.check_balance()
    snap = eng.metrics.snapshot()
    hits = [hit for _, hit, _ in lookups[1:]]
    equal = [bool(np.array_equal(a, b))
             for a, b in zip(warm_streams, cold_streams)]
    lp_diff = max(float(np.max(np.abs(np.asarray(h.logprobs_so_far())
                                      - np.asarray(c))))
                  for h, c in zip([w0] + warm_hs, cold_lps))
    part_a = dict(cold=cold, warm=warm_r, prefix_hits=snap["prefix_hits"],
                  hit_tokens=hits, streams_equal=equal,
                  logprob_max_abs_diff=lp_diff,
                  first_divergence={
                      i: int(np.flatnonzero(a != b)[0])
                      for i, (a, b) in enumerate(zip(warm_streams,
                                                     cold_streams))
                      if not equal[i]})
    check(lookups[0][1] == 0 and c_pre == sum(len(p) for p in warm),
          f"donor lookup {lookups[0]}, cold burst prefilled {c_pre}")
    check(hits == [PREFIX_SHARED] * len(warm)
          and w_pre == sum(len(p) - PREFIX_SHARED for p in warm),
          f"warm hits {hits}, prefilled {w_pre}: want each request to "
          f"prefill len - {PREFIX_SHARED}")
    check(snap["prefix_hits"] == len(warm),
          f"prefix_hits {snap['prefix_hits']}, want {len(warm)}")

    # b. an exact duplicate of the last warm prompt, whose chain is the
    # newest in the trie (no allocation followed its insert)
    dup = warm[-1]
    pre0, cow0 = eng.prefill_tokens, eng.pool.stats["cow_copies"]
    hd = eng.submit(dup)
    _drive(eng)
    part_b = dict(prompt_len=len(dup), prefilled=eng.prefill_tokens - pre0,
                  cow_copies=eng.pool.stats["cow_copies"] - cow0,
                  stream_equal=bool(np.array_equal(hd.result(0),
                                                   warm_streams[-1])))
    eng.pool.check_balance()

    # c. pressure until the shared prefix lives only in the host tier
    admits, imports = [], []
    spilled = [eng.prefix_cache.spilled_pages]
    admit = eng._admit

    def timed_admit():
        t0 = time.perf_counter()
        admit()
        torch.cuda.synchronize()
        admits.append(((time.perf_counter() - t0) * 1e3,
                       eng.prefix_cache.spilled_pages - spilled[0]))
        spilled[0] = eng.prefix_cache.spilled_pages

    eng._admit = timed_admit
    rng = np.random.RandomState(SEED + 3)
    n_pressure = 0
    while n_pressure < PREFIX_PRESSURE_MAX and (
            eng.prefix_cache.probe(ns, shared) != 0
            or eng.prefix_probe(shared) != PREFIX_SHARED):
        eng.submit(rng.randint(0, vocab, (PREFIX_PRESSURE_LEN,)).astype(
            np.int32), max_new_tokens=2)
        _drive(eng)
        n_pressure += 1
    check(eng.prefix_cache.probe(ns, shared) == 0
          and eng.prefix_probe(shared) == PREFIX_SHARED,
          f"after {n_pressure} pressure prompts the trie holds "
          f"{eng.prefix_cache.probe(ns, shared)} shared tokens and both "
          f"tiers {eng.prefix_probe(shared)}")
    eng.pool.check_balance()
    back = warm[1]
    import_page = eng.pool.import_page

    def timed_import(*args):
        t0 = time.perf_counter()
        import_page(*args)
        torch.cuda.synchronize()
        imports.append((time.perf_counter() - t0) * 1e3)

    eng.pool.import_page = timed_import
    on0, pre0 = eng.host_onboard_tokens, eng.prefill_tokens
    hb = eng.submit(back)
    _drive(eng)
    eng.pool.import_page = import_page
    onboarded = eng.host_onboard_tokens - on0
    spill_admits = [ms for ms, n in admits if n > 0]
    part_c = dict(
        pressure_prompts=n_pressure,
        spilled_pages=eng.prefix_cache.spilled_pages,
        spill_ms_per_page=(eng.prefix_cache.spill_seconds * 1e3
                           / max(eng.prefix_cache.spilled_pages, 1)),
        onboarded_tokens=onboarded,
        prefilled=eng.prefill_tokens - pre0,
        onboard_ms_per_page=(statistics.median(imports) if imports
                             else None),
        spill_admission_host_ms=dict(
            n=len(spill_admits),
            p50=statistics.median(spill_admits) if spill_admits else None,
            max=max(spill_admits) if spill_admits else None,
            pages=[n for _, n in admits if n > 0]),
        lru_walks=dict(n=len(walks), ms_p50=statistics.median(walks),
                       ms_max=max(walks), ms_total=sum(walks)),
        host_kv=eng.host_kv.snapshot(),
        stream_equal=bool(np.array_equal(hb.result(0), cold_streams[2])))
    eng.pool.check_balance()

    # d. the same prompt under another tenant: no hit in either tier
    hits0 = eng.metrics.snapshot()["prefix_hits"]
    on0, pre0 = eng.host_onboard_tokens, eng.prefill_tokens
    ht = eng.submit(back, tenant="b")
    _drive(eng)
    part_d = dict(hits=eng.metrics.snapshot()["prefix_hits"] - hits0,
                  onboarded=eng.host_onboard_tokens - on0,
                  prefilled=eng.prefill_tokens - pre0,
                  stream_equal=bool(np.array_equal(ht.result(0),
                                                   cold_streams[2])))
    eng.pool.check_balance()

    # e. handoff after the first token into a second engine
    src_p = warm[2]
    hs = eng.submit(src_p, rid="handoff")
    while not hs.tokens_so_far():
        eng.pump()
    payload = eng.export_stream("handoff")
    eng.pool.check_balance()
    pool_snap = eng.pool.snapshot()
    cache_snap = {k: v for k, v in eng.prefix_cache.snapshot().items()
                  if k != "tenants"}
    del eng
    gc.collect()
    dst = LLMEngine(model, LLMEngineConfig(**warm_cfg))
    emitted = payload["emitted"]
    h2 = dst.submit(np.concatenate([src_p, emitted]).astype(np.int32),
                    max_new_tokens=SERVE_NEW_TOKENS - len(emitted),
                    kv_row=payload["kv_row"], lane=payload["lane"],
                    sample_offset=len(emitted))
    _drive(dst)
    stream = np.asarray(list(emitted) + list(h2.result(0)), np.int32)
    part_e = dict(emitted_at_export=len(emitted),
                  kv_import_tokens=dst.kv_import_tokens,
                  prefilled=dst.prefill_tokens,
                  stream_equal=bool(np.array_equal(stream,
                                                   cold_streams[3])))
    dst.pool.check_balance()
    launches = _kernels.launch_counts()
    head_dim = model.config.hidden_size // model.config.num_attention_heads
    result = {
        "phase": "prefix_serve", "model": "gpt3-1.3b", "dtype": "bfloat16",
        "engine": warm_cfg, "shared_prefix": PREFIX_SHARED,
        "suffixes": PREFIX_SUFFIXES, "a_shared_prefix": part_a,
        "b_duplicate": part_b, "c_pressure_host_tier": part_c,
        "d_tenant": part_d, "e_handoff": part_e, "pool": pool_snap,
        "prefix_cache": cache_snap, "kernel_launches": launches,
        "paged_route": paged_route(torch.bfloat16, warm_cfg["block_len"],
                                   head_dim),
        "model_init_s": init_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(result)
    check(all(equal), f"warm streams differ from cold ones: {equal}")
    check(part_b["prefilled"] == 1 and part_b["cow_copies"] == 1
          and part_b["stream_equal"], f"duplicate: {part_b}")
    check(onboarded >= PREFIX_SHARED and onboarded % 8 == 0
          and part_c["prefilled"] == len(back) - onboarded
          and part_c["stream_equal"], f"host onboard: {part_c}")
    check(part_d["hits"] == 0 and part_d["onboarded"] == 0
          and part_d["prefilled"] == len(back) and part_d["stream_equal"],
          f"tenant b: {part_d}")
    check(part_e["kv_import_tokens"] == len(src_p) + len(emitted) - 1
          and part_e["prefilled"] == 1 and part_e["stream_equal"],
          f"handoff: {part_e}")
    check(launches["paged_attention"] > 0 and launches["layernorm_fwd"] > 0
          and result["paged_route"] == TENSOR_CORES,
          f"prefix_serve launched {launches} on the {result['paged_route']} "
          "route: want paged attention on the tensor cores and the "
          "LayerNorm forward")
    del model, dst, payload
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------- phase 4e: ResNet-50 at one GPU
# resnet50 (1000 classes) in training mode, TF32 off for matmuls and
# cuDNN, 8 x 3 x 64 x 64 images (every BatchNorm reduces at least
# 8 x 2 x 2 = 32 values a channel), on the card (cuDNN convolutions,
# BatchNorm and pools; the fused-Adam kernel) against a CPU twin with the
# same weights and buffers (the plain versions).
#
# fp32 resnet50 at random init amplifies rounding: its gradient norms
# part by a median 3.4e-4 and up to 4.6e-3 of themselves between the card
# and the CPU, and by 2.3e-4 and 2.6e-3 between two CPU runs that differ
# only in their thread count, so in their sums' order
# (tools/resnet_fp32_spread.py); three AdamW steps on one batch then part
# chaotically (CPU against CPU, lr 1e-4: losses 0.078 apart, 69% of the
# weights more than lr / 10). In float64 the card and the CPU agree to
# 1e-12 on the logits and 3e-9 on every gradient norm: the card computes
# the CPU's function. So:
# - float64 forward and backward: logits within RESNET_FP64_LOGITS_TOL,
#   every leaf's gradient norm within RESNET_FP64_GRAD_RTOL of itself,
#   the running statistics the forward moved within RESNET_FP64_BUFFER_TOL
#   of themselves (+ that, absolute): the only fp32 step is the
#   cross-entropy, over logits 1e-12 apart;
# - fp32 forward and backward: logits within RESNET_LOGITS_TOL and the
#   loss within TRAIN_PARITY_LOSS_TOL (phase 4's limits and reasons), each
#   gradient norm within RESNET_FP32_GRAD_RTOL (4x the worst card-vs-CPU
#   spread above, 8x the CPU's own; a missing term or factor moves a norm
#   by far more), the buffers within RESNET_BUFFER_TOL x (1 + |CPU|): each
#   is a mean or a variance of conv outputs, the quantities the logits are
#   made of, so it gets the logits' limit, relative to its size beyond 1
#   (the variances reach O(100)); a wrong momentum moves a buffer by 10%
#   of its step, an update missed or made twice by all of it;
# - RESNET_STEPS fp32 AdamW steps through ScanTrainStep, each from a
#   common state (the card takes the CPU's weights, buffers and moments
#   before each step, so the chaos above cannot compound): each step's
#   loss within TRAIN_PARITY_LOSS_TOL, every weight within 6 x lr (phase
#   4's limit), at most RESNET_PARAM_SHARE of them past lr / 10, and its
#   buffers within RESNET_BUFFER_TOL as above. Adam's first step moves
#   every element by lr x sign(g), so an element whose gradient is within
#   the fp32 spread above of 0 lands 2 x lr away: 0.47% of them between
#   the card and the CPU, 0.21% between two CPU runs of other thread
#   counts; RESNET_PARAM_SHARE is 4x the first, while a
#   wrong gradient flips about half of the signs and a lost update moves
#   every element by lr.
# The bf16 BatchNorm of the train cell (bf16 input, weight, bias and
# buffers, as model.to(bfloat16) leaves them) runs on the card at
# layer1's shape in bench.py's batch against fp32 math on the same bf16
# inputs: statistics in fp32 and one rounding of each output and buffer,
# so every element within one bf16 ulp of the larger magnitude + 1e-6
# (an fp32 difference near 0 survives the rounding).
RESNET_MODEL_BATCH = (8, 64)          # images, side
RESNET_STEPS = 3
RESNET_FP64_LOGITS_TOL = 1e-9
RESNET_FP64_GRAD_RTOL = 1e-6
RESNET_FP64_BUFFER_TOL = 1e-9
RESNET_LOGITS_TOL = 1e-3
RESNET_FP32_GRAD_RTOL = 2e-2
RESNET_PARAM_SHARE = 2e-2
RESNET_BUFFER_TOL = 1e-3
RESNET_BF16_BN_SHAPE = (64, 64, 56, 56)
# resnet50's leaves: 53 conv weights, 53 BatchNorms' weight and bias, the
# fc weight and bias; each one fused-Adam launch a step
RESNET50_LEAVES = 161


def resnet_twins(depth, seed, num_classes=1000):
    """(CPU model, card model) of resnet{depth} in fp32 and training mode
    with the same weights and buffers, drawn on the CPU from `seed`."""
    import torch
    from paddle_tpu_torch.vision import models
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    build = getattr(models, f"resnet{depth}")
    cpu = build(num_classes=num_classes, device="cpu", generator=gen)
    card = build(num_classes=num_classes, device="cuda")
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def _buffer_diff(torch, card, cpu):
    """max over every buffer of |card - cpu| / (1 + |cpu|); 0 without
    buffers."""
    return max((float(((a.detach().cpu().double() - b.double()).abs()
                       / (1 + b.double().abs())).max())
                for a, b in zip(card.buffers(), cpu.buffers())),
               default=0.0)


def _forward_backward(torch, card, cpu, x, y):
    """(max |logits diff|, |loss diff|, {leaf: relative gradient-norm
    diff}, buffer diff) of one training forward and backward of both
    models on (x, y); the gradients are dropped again."""
    from paddle_tpu_torch.nn import CrossEntropyLoss
    out = {}
    for name, m, dev in (("card", card, "cuda"), ("cpu", cpu, "cpu")):
        dtype = next(m.parameters()).dtype
        logits = m(torch.from_numpy(x).to(dev, dtype))
        loss = CrossEntropyLoss()(logits, torch.from_numpy(y).to(dev))
        loss.backward()
        out[name] = (logits.detach().cpu().double(), float(loss.detach()),
                     {k: float(p.grad.double().norm())
                      for k, p in m.named_parameters()})
        for p in m.parameters():
            p.grad = None
    (lg_a, loss_a, g_a), (lg_b, loss_b, g_b) = out["card"], out["cpu"]
    rel = {k: abs(g_a[k] - g_b[k]) / max(g_b[k], 1e-30) for k in g_b}
    return (float((lg_a - lg_b).abs().max()), abs(loss_a - loss_b), rel,
            _buffer_diff(torch, card, cpu))


def _sync_from(torch, card, cpu, opt_card, opt_cpu):
    """The card model and optimizer take the CPU's weights, buffers and
    optimizer slots."""
    with torch.no_grad():
        for a, b in zip(list(card.parameters()) + list(card.buffers()),
                        list(cpu.parameters()) + list(cpu.buffers())):
            a.copy_(b)
        for a, b in zip(card.parameters(), cpu.parameters()):
            for k, t in opt_card.state[a].items():
                t.copy_(opt_cpu.state[b][k])


def resnet_card_vs_cpu(depth=50, batch=RESNET_MODEL_BATCH, steps=RESNET_STEPS,
                       seed=SEED + 13, num_classes=1000):
    """resnet{depth} on the card against its CPU twin under phase 4e's
    limits: a float64 and an fp32 forward and backward, then `steps`
    AdamW steps through ScanTrainStep, each from the CPU's state. Returns
    the readings; checks nothing."""
    import copy

    import numpy as np
    import torch
    from paddle_tpu_torch.bridge import export_state
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ScanTrainStep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, side = batch
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, 3, side, side)).astype(np.float32)
    y = rng.randint(0, num_classes, (B,)).astype(np.int64)
    cpu, card = resnet_twins(depth, seed, num_classes)
    lg64, loss64, rel64, buf64 = _forward_backward(
        torch, copy.deepcopy(card).double(), copy.deepcopy(cpu).double(),
        x.astype(np.float64), y)
    lg32, loss32, rel32, buf32 = _forward_backward(torch, card, cpu, x, y)
    opts = [AdamW(learning_rate=TRAIN_PARITY_LR, weight_decay=0.01,
                  parameters=m.parameters()) for m in (card, cpu)]
    runs = [ScanTrainStep(m, o, scan_steps=1, loss_fn=CrossEntropyLoss(),
                          device=d)
            for m, o, d in ((card, opts[0], "cuda"), (cpu, opts[1], "cpu"))]
    per_step = []
    _kernels.reset_launch_counts()
    for i in range(steps):
        if i:
            _sync_from(torch, card, cpu, *opts)
        l_card = float(runs[0](x[None], y[None])[0])
        l_cpu = float(runs[1](x[None], y[None])[0])
        wc, wp = export_state(card), export_state(cpu)
        worst, far, total = 0.0, 0, 0
        for k in wc:
            d = np.abs(wc[k] - wp[k])
            worst = max(worst, float(d.max()))
            far += int((d > TRAIN_PARITY_LR / 10).sum())
            total += d.size
        per_step.append({"loss_card": l_card, "loss_cpu": l_cpu,
                         "loss_abs_diff": abs(l_card - l_cpu),
                         "param_max_abs_diff": worst,
                         "param_share_past_lr_over_10": far / total,
                         "buffer_max_rel_diff": _buffer_diff(torch, card,
                                                             cpu)})
    torch.cuda.synchronize()
    launched = _kernels.launch_counts()
    worst64 = max(rel64, key=rel64.get)
    worst32 = max(rel32, key=rel32.get)
    readings = {
        "config": f"resnet{depth} ({num_classes} classes), TF32 off, train "
                  f"mode, {B} x 3 x {side} x {side}; {steps} AdamW steps "
                  f"(lr {TRAIN_PARITY_LR}, wd 0.01) each from the CPU's "
                  "state",
        "fp64": {"logits_max_abs_diff": lg64, "loss_abs_diff": loss64,
                 "grad_norm_max_rel_diff": rel64[worst64],
                 "grad_norm_worst_leaf": worst64,
                 "buffer_max_rel_diff": buf64,
                 "tols": [RESNET_FP64_LOGITS_TOL, RESNET_FP64_GRAD_RTOL,
                          RESNET_FP64_BUFFER_TOL]},
        "fp32": {"logits_max_abs_diff": lg32, "loss_abs_diff": loss32,
                 "grad_norm_max_rel_diff": rel32[worst32],
                 "grad_norm_median_rel_diff": float(np.median(
                     list(rel32.values()))),
                 "grad_norm_worst_leaf": worst32,
                 "buffer_max_rel_diff": buf32,
                 "tols": [RESNET_LOGITS_TOL, TRAIN_PARITY_LOSS_TOL,
                          RESNET_FP32_GRAD_RTOL, RESNET_BUFFER_TOL]},
        "steps": per_step,
        "step_tols": [TRAIN_PARITY_LOSS_TOL, 6 * TRAIN_PARITY_LR,
                      RESNET_PARAM_SHARE, RESNET_BUFFER_TOL],
        "grad_norm_leaves": len(rel32),
        "leaves": sum(1 for _ in card.parameters()),
        "kernel_launches": launched}
    del cpu, card
    return readings


def check_resnet_readings(r, steps):
    """Phase 4e's limits over resnet_card_vs_cpu's readings."""
    want = {k: 0 for k in r["kernel_launches"]}
    want["fused_adam"] = r["leaves"] * steps
    check(r["kernel_launches"] == want,
          f"ResNet steps launched {r['kernel_launches']}, want {want}")
    f64, f32 = r["fp64"], r["fp32"]
    check(f64["logits_max_abs_diff"] <= RESNET_FP64_LOGITS_TOL
          and f64["grad_norm_max_rel_diff"] <= RESNET_FP64_GRAD_RTOL
          and f64["buffer_max_rel_diff"] <= RESNET_FP64_BUFFER_TOL,
          f"float64 card vs CPU ResNet: {f64}")
    check(f32["logits_max_abs_diff"] <= RESNET_LOGITS_TOL
          and f32["loss_abs_diff"] <= TRAIN_PARITY_LOSS_TOL
          and f32["grad_norm_max_rel_diff"] <= RESNET_FP32_GRAD_RTOL
          and f32["buffer_max_rel_diff"] <= RESNET_BUFFER_TOL,
          f"fp32 card vs CPU ResNet: {f32}")
    for i, st in enumerate(r["steps"]):
        check(st["loss_abs_diff"] <= TRAIN_PARITY_LOSS_TOL
              and st["param_max_abs_diff"] <= 6 * TRAIN_PARITY_LR
              and st["param_share_past_lr_over_10"] <= RESNET_PARAM_SHARE
              and st["buffer_max_rel_diff"] <= RESNET_BUFFER_TOL,
              f"card vs CPU ResNet step {i}: {st}")


def check_bf16_batch_norm(shape=RESNET_BF16_BN_SHAPE, momentum=0.9,
                          eps=1e-5):
    """The port's batch_norm on bf16 input, weight, bias and buffers on the
    card, training then eval, against fp32 math on the same bf16 values.
    Returns the readings; checks the one-ulp limit."""
    import torch
    from paddle_tpu_torch.nn import functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 14)
    C = shape[1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(
        torch.bfloat16)
    w = (torch.rand(C, generator=gen, device="cuda") + 0.5).to(
        torch.bfloat16)
    b = torch.randn(C, generator=gen, device="cuda").to(torch.bfloat16)
    rm = (torch.randn(C, generator=gen, device="cuda") * 0.1).to(
        torch.bfloat16)
    rv = (torch.rand(C, generator=gen, device="cuda") + 0.5).to(
        torch.bfloat16)
    h = x.float()
    mu = h.mean((0, 2, 3))
    var = h.var((0, 2, 3), unbiased=False)
    n = h.numel() // C

    def affine(m, v):
        return ((h - m[None, :, None, None])
                / torch.sqrt(v[None, :, None, None] + eps)
                * w.float()[None, :, None, None]
                + b.float()[None, :, None, None])

    want = {"train_out": affine(mu, var).to(torch.bfloat16),
            "train_mean": (momentum * rm.float() + (1 - momentum) * mu).to(
                torch.bfloat16),
            "train_var": (momentum * rv.float() + (1 - momentum) * var
                          * (n / (n - 1))).to(torch.bfloat16)}
    bm, bv = rm.clone(), rv.clone()
    got = {"train_out": F.batch_norm(x, bm, bv, w, b, training=True,
                                     momentum=momentum, epsilon=eps),
           "train_mean": bm, "train_var": bv}
    want["eval_out"] = affine(bm.float(), bv.float()).to(torch.bfloat16)
    got["eval_out"] = F.batch_norm(x, bm, bv, w, b, training=False,
                                   epsilon=eps)
    readings = {"shape": list(shape)}
    for k in want:
        check(got[k].dtype == torch.bfloat16, f"bf16 batch_norm {k} came "
                                              f"back in {got[k].dtype}")
        a, r = got[k].float(), want[k].float()
        # the distance in units of the limit, one ulp + 1e-6
        units = (a - r).abs() / (
            ulp_bf16(torch.maximum(a.abs(), r.abs())) + 1e-6)
        readings[f"{k}_max_over_limit"] = float(units.max())
        readings[f"{k}_share_off"] = float((a != r).float().mean())
        check(float(units.max()) <= 1.0,
              f"bf16 batch_norm {k} is {float(units.max())} times its limit "
              "(one bf16 ulp + 1e-6) from fp32 math on its inputs")
    return readings


def phase_resnet_model():
    """Phase 4e: resnet_card_vs_cpu(resnet50) under its limits, and the
    bf16 BatchNorm check."""
    import torch
    t0 = time.perf_counter()
    r = resnet_card_vs_cpu()
    r["seconds"] = time.perf_counter() - t0
    r["bf16_batch_norm"] = check_bf16_batch_norm()
    emit({"phase": "resnet_model", **r})
    check_resnet_readings(r, RESNET_STEPS)
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------- phase 15: resnet_train
# BASELINE config 1 as bench.py trains it (bench.py:115, :137-165): full
# resnet50 (1000 classes), 64 x 3 x 224 x 224 images, the model and the
# images in bf16, CrossEntropyLoss, AdamW(1e-4, fp32 moments, its default
# weight decay 0.01 on every leaf), no clip, one batch repeated through
# ScanTrainStep: a chunk of TRAIN_WARMUP_STEPS, then one of
# TRAIN_TIMED_STEPS timed. cudnn.benchmark stays off (torch's default), so
# cuDNN picks its algorithms by heuristics, the same in every run.
RESNET_TRAIN = dict(batch=64, side=224, classes=1000, lr=1e-4)


def resnet_workload():
    """BASELINE config 1 as bench.py builds it, shared with
    tools/profile_torch_training.py: resnet50 in fp32 on the card with
    weights from SEED, in training mode; `paddle_tpu_torch.flops` at
    [1, 3, 224, 224] (in training mode it moves the running statistics,
    as bench.py's count does); the model cast to bf16 with its buffers;
    AdamW(1e-4, fp32 moments); 64 images (randn) and then their labels
    (randint) from RandomState(SEED), the images cast to bf16 on the
    card. Returns (model, opt, loss_fn, images, labels, macs, init_s)."""
    import numpy as np
    import torch
    import paddle_tpu_torch
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.vision.models import resnet50

    c = RESNET_TRAIN
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    model = resnet50(num_classes=c["classes"], device="cuda", generator=gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    macs = paddle_tpu_torch.flops(model, input_size=[1, 3, c["side"],
                                                     c["side"]])
    model.to(torch.bfloat16)
    opt = AdamW(learning_rate=c["lr"], parameters=model.parameters(),
                moment_dtype="float32")
    rng = np.random.RandomState(SEED)
    x = rng.randn(c["batch"], 3, c["side"], c["side"]).astype(np.float32)
    y = rng.randint(0, c["classes"], (c["batch"],))
    images = torch.from_numpy(x).cuda().to(torch.bfloat16)
    labels = torch.from_numpy(y.astype(np.int64)).cuda()
    return model, opt, CrossEntropyLoss(), images, labels, macs, init_s


def phase_resnet_train(device_name):
    """Phase 15: resnet_workload() through ScanTrainStep, a warm-up chunk,
    then a timed chunk with the launch counts zeroed just before and read
    just after. Returns the timed chunk's launch counts."""
    import torch
    from paddle_tpu_torch.obs.flops import (conv_train_flops_per_step,
                                            peak_flops)
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.parallel import ScanTrainStep

    gc.collect()
    torch.cuda.empty_cache()
    c = RESNET_TRAIN
    model, opt, ce, images, labels, macs, init_s = resnet_workload()
    check(all(b.dtype == torch.bfloat16 for b in model.buffers())
          and all(p.dtype == torch.bfloat16 for p in model.parameters()),
          "resnet_train's model is not all bf16")
    bufs0 = [b.clone() for b in model.buffers()]
    flops = conv_train_flops_per_step(macs, c["batch"])
    warm = ScanTrainStep(model, opt, scan_steps=TRAIN_WARMUP_STEPS,
                         loss_fn=ce)
    warm_losses, warm_s, _, _ = timed_chunk(warm, images, labels)
    step = ScanTrainStep(model, opt, scan_steps=TRAIN_TIMED_STEPS,
                         loss_fn=ce)
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    losses, wall, step_ms, host_ms = timed_chunk(step, images, labels)
    launches = _kernels.launch_counts()
    all_losses = warm_losses.tolist() + losses.tolist()
    step_s = wall / TRAIN_TIMED_STEPS
    moved = [not torch.equal(a, b) for a, b in zip(model.buffers(), bufs0)]
    finite = all(bool(torch.isfinite(b).all()) for b in model.buffers())
    per_step = {k: v / TRAIN_TIMED_STEPS for k, v in launches.items()}
    emit({"phase": "resnet_train", "model": "resnet50",
          "dtype": "bfloat16", "batch": c["batch"],
          "image": [3, c["side"], c["side"]], "classes": c["classes"],
          "optimizer": "AdamW lr 1e-4 wd 0.01 fp32 moments, no clip",
          "cudnn_benchmark": torch.backends.cudnn.benchmark,
          "n_params": sum(p.numel() for p in model.parameters()),
          "leaves": sum(1 for _ in model.parameters()),
          "forward_macs_per_image": macs,
          "warmup_steps": TRAIN_WARMUP_STEPS, "warmup_s": warm_s,
          "timed_steps": TRAIN_TIMED_STEPS, "wall_s": wall,
          "images_per_s": c["batch"] * TRAIN_TIMED_STEPS / wall,
          "step_ms_mean": step_s * 1e3,
          "step_ms_median": statistics.median(step_ms),
          "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
          "host_ms_per_step_median": statistics.median(host_ms),
          "mfu": flops / step_s / peak_flops(device_name),
          "flops_per_step": flops,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "loss_first": all_losses[0], "loss_last": all_losses[-1],
          "losses": all_losses, "buffers": len(moved),
          "buffers_moved": sum(moved), "buffers_finite": finite,
          "kernel_launches": launches, "launches_per_step": per_step,
          "model_init_s": init_s})
    check(all(math.isfinite(v) for v in all_losses), "non-finite loss")
    check(all_losses[-1] < all_losses[0],
          f"loss did not fall: {all_losses[0]} -> {all_losses[-1]}")
    want = {k: 0.0 for k in launches}
    want["fused_adam"] = float(RESNET50_LEAVES)
    check(per_step == want, f"launches per step {per_step}, want {want}")
    check(finite and all(moved),
          f"running statistics: finite {finite}, moved {sum(moved)} of "
          f"{len(moved)}")
    del model, opt, warm, step, images
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 6
TRAIN_WARMUP_STEPS = 3
TRAIN_TIMED_STEPS = 10
# launches_per_step(24, 293, recompute): gpt3-1.3b has 24 layers and 293
# parameters (12 a layer, two embeddings, the final LayerNorm's two and
# the untied lm_head), each with a gradient and one fused-Adam launch
TRAIN_KERNELS_PER_STEP = {"flash_fwd": 24, "flash_bwd_dq": 24,
                          "flash_bwd_dkv": 24, "layernorm_fwd": 49,
                          "layernorm_bwd": 49, "fused_adam": 293}
# recompute reruns every layer's forward (one flash forward, two LayerNorm
# forwards) in the backward; the final LayerNorm is outside the layers
RECIPE_KERNELS_PER_STEP = {"flash_fwd": 48, "flash_bwd_dq": 24,
                           "flash_bwd_dkv": 24, "layernorm_fwd": 97,
                           "layernorm_bwd": 49, "fused_adam": 293}
# launches_per_step(32, 291, True, layer_norms=False): llama2-7b has 32
# layers and 291 parameters (9 a layer: q, k, v, o, gate, up, down and two
# RMSNorm weights; the embedding, the final RMSNorm and the untied
# lm_head); recompute reruns each layer's flash forward; RMSNorm is plain
# torch, so no LayerNorm kernel runs
LLAMA_KERNELS_PER_STEP = {"flash_fwd": 64, "flash_bwd_dq": 32,
                          "flash_bwd_dkv": 32, "layernorm_fwd": 0,
                          "layernorm_bwd": 0, "fused_adam": 291}
# launches_per_step(12, 155, False): ernie-moe-base has 12 layers and 155
# parameters (12 a dense layer, 13 an MoE layer: the gate and the four
# expert stacks in place of the MLP's four; 6 of each; the two
# embeddings, the final LayerNorm's two and the untied lm_head); the MoE
# itself (router, dispatch, experts, combine) is plain torch
MOE_KERNELS_PER_STEP = {"flash_fwd": 12, "flash_bwd_dq": 12,
                        "flash_bwd_dkv": 12, "layernorm_fwd": 25,
                        "layernorm_bwd": 25, "fused_adam": 155}
RECIPE_PEAK_LR = 2e-4
# the published optimizers the recipe cells follow: GPT-3 1.3B (Brown et
# al. 2020, Table 2.1 and Appendix B) and Llama 2 (Touvron et al. 2023,
# sec. 2.2); both AdamW(0.9, 0.95), wd 0.1, clip 1.0, warm-up into a
# cosine to peak/10
GPT3_RECIPE = dict(peak_lr=RECIPE_PEAK_LR, epsilon=1e-8)
LLAMA2_RECIPE = dict(peak_lr=3e-4, epsilon=1e-5)
# the train cells: preset (bf16, full depth), batch B x S, the recipe
# (None: AdamW lr 1e-4, wd 0.01, fp32 moments, no recompute; else
# recipe_optimizer, use_recompute, bf16 moments) and the launches a step
TRAIN_CELLS = {
    "train": dict(preset="gpt3-1.3b", batch=(TRAIN_B, TRAIN_S), recipe=None,
                  launches=TRAIN_KERNELS_PER_STEP),
    "train_recipe": dict(preset="gpt3-1.3b", batch=(TRAIN_B, TRAIN_S),
                         recipe=GPT3_RECIPE,
                         launches=RECIPE_KERNELS_PER_STEP),
    # one sequence at Llama 2's context length (its batch is 4 M tokens)
    "llama_train": dict(preset="llama2-7b", batch=(1, 4096),
                        recipe=LLAMA2_RECIPE,
                        launches=LLAMA_KERNELS_PER_STEP),
    # BASELINE config 5 as bench.py trains it: 8 x 1024, the model in
    # bf16, AdamW(lr 1e-4) with fp32 moments, no recompute
    "moe_train": dict(preset="ernie-moe-base", batch=(8, 1024), recipe=None,
                      launches=MOE_KERNELS_PER_STEP),
}


def recipe_decays(name):
    """The recipes' weight-decay filter: neither a bias nor a norm
    parameter (`gpt.layers.0.norm1.weight`, `gpt.final_norm.bias`,
    `llama.layers.0.input_layernorm.weight`, `llama.norm.weight`)."""
    return not (name.endswith(".bias") or "norm" in name)


def recipe_schedule(peak_lr):
    """The recipes' schedule cut to the smoke's 3 + 10 steps: a linear
    warm-up from 0 over 4 steps into a cosine decay to peak/10 over 9."""
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)
    return LinearWarmup(CosineAnnealingDecay(peak_lr, T_max=9,
                                             eta_min=peak_lr / 10),
                        warmup_steps=4, start_lr=0.0, end_lr=peak_lr)


def recipe_optimizer(parameters, peak_lr, epsilon=1e-8):
    """A recipe cell's optimizer with bench.py's bf16 moments:
    AdamW(0.9, 0.95, epsilon), weight decay 0.1 through recipe_decays,
    global-norm clip 1.0 and recipe_schedule(peak_lr). epsilon 1e-8 is
    GPT-3's, 1e-5 Llama 2's."""
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    return AdamW(learning_rate=recipe_schedule(peak_lr), beta1=0.9,
                 beta2=0.95, epsilon=epsilon, parameters=parameters,
                 weight_decay=0.1, apply_decay_param_fun=recipe_decays,
                 grad_clip=ClipGradByGlobalNorm(1.0),
                 moment_dtype="bfloat16")


def train_workload(cell="train"):
    """A train cell of TRAIN_CELLS, shared with
    tools/profile_torch_training.py: its model in bf16 with random weights
    from SEED, in training mode, with its optimizer; one batch of B x S
    token ids and labels from SEED, repeated every step as bench.py
    repeats its batch. Returns (model, opt, ids, labels, model_init_s)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.optimizer import AdamW

    c = TRAIN_CELLS[cell]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    model = model_class(c["preset"]).from_preset(
        c["preset"], device="cuda", dtype="bfloat16", generator=gen,
        use_recompute=c["recipe"] is not None)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model.train()
    if c["recipe"] is not None:
        opt = recipe_optimizer(model.parameters(), **c["recipe"])
    else:
        opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                    parameters=model.parameters(), moment_dtype="float32")
    vocab = model.config.vocab_size
    rng = np.random.RandomState(SEED + 4)
    ids = rng.randint(0, vocab, c["batch"]).astype(np.int32)
    labels = rng.randint(0, vocab, c["batch"]).astype(np.int32)
    return model, opt, ids, labels, init_s


def timed_chunk(step, ids, labels):
    """Run one chunk of `step` (a ScanTrainStep) over (ids, labels) repeated
    K times, with a CUDA event after every step. Returns (losses on the
    CPU, wall s from the call to the end of the last step, per-step
    device-timeline ms, per-step host ms). The host ms of a step runs from
    its first launch to its last; nothing in a step waits for the device,
    but the host blocks once the launch queue is full, so while the device
    is the bottleneck it reads the step time, not the host's own work.
    Tensors already on the card are repeated as [K, ...] views, with no
    copy; numpy arrays are stacked."""
    import torch
    from paddle_tpu_torch.parallel import stack_batches
    K = step.scan_steps
    events = [torch.cuda.Event(enable_timing=True) for _ in range(K + 1)]
    host_ms = []
    inner = step._train_step

    def marked(*a):
        t = time.perf_counter()
        loss = inner(*a)
        host_ms.append((time.perf_counter() - t) * 1e3)
        events[len(host_ms)].record()
        return loss

    if torch.is_tensor(ids):
        chunk = tuple(a.unsqueeze(0).expand(K, *a.shape)
                      for a in (ids, labels))
    else:
        chunk = stack_batches([(ids, labels)] * K)
    torch.cuda.synchronize()
    step._train_step = marked
    try:
        t0 = time.perf_counter()
        events[0].record()
        losses = step(*chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del step._train_step
    ms = [events[i].elapsed_time(events[i + 1]) for i in range(K)]
    return losses.cpu(), wall, ms, host_ms


def moe_flops_args(model):
    """train_flops_per_step's MoE keywords for `model` (none for a dense
    one): its expert parameters, every MoELayer parameter but the gate,
    counted from the modules as bench.py counts them."""
    from paddle_tpu_torch.nn.layer.moe import MoELayer
    layers = [m for m in model.modules() if isinstance(m, MoELayer)]
    if not layers:
        return {}
    return dict(expert_params=sum(
        p.numel() for m in layers for k, p in m.named_parameters()
        if k != "gate_weight"), moe_top_k=layers[0].top_k,
        moe_num_experts=layers[0].num_experts)


def phase_train(device_name, cell="train", train_peak_gib=None,
                record=None):
    """A train cell of TRAIN_CELLS (phases 6, 7 and 11): a warm-up chunk
    of TRAIN_WARMUP_STEPS, then one of TRAIN_TIMED_STEPS with the launch
    counts zeroed just before and read just after. The train_recipe
    cell's peak memory must stay below `train_peak_gib`. `record`, a
    dict, receives the cell's tokens/s, step ms, MFU and peak memory.
    Returns (launch counts of the timed chunk, peak memory in GiB)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.nn.layer.moe import capacity_of
    from paddle_tpu_torch.obs.flops import peak_flops, train_flops_per_step
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.parallel import ScanTrainStep

    # an earlier phase's model held by a reference cycle (the serve phase's
    # engine) is freed only by the cyclic collector: collect it now, or the
    # peak below counts it whenever the collector has not yet run
    gc.collect()
    torch.cuda.empty_cache()
    c = TRAIN_CELLS[cell]
    recipe = c["recipe"]
    B, S = c["batch"]
    model, opt, ids, labels, init_s = train_workload(cell)
    n_params = sum(p.numel() for p in model.parameters())
    flops = train_flops_per_step(n_params, B * S, **moe_flops_args(model))
    warm = ScanTrainStep(model, opt, scan_steps=TRAIN_WARMUP_STEPS)
    warm_losses, warm_s, _, _ = timed_chunk(warm, ids, labels)
    lr_used = list(warm.lr_vector)
    step = ScanTrainStep(model, opt, scan_steps=TRAIN_TIMED_STEPS)
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    losses, wall, step_ms, _ = timed_chunk(step, ids, labels)
    launches = _kernels.launch_counts()
    lr_used += list(step.lr_vector)
    want_launches = c["launches"]
    per_step = {k: launches[k] / TRAIN_TIMED_STEPS for k in want_launches}
    tokens = B * S * TRAIN_TIMED_STEPS
    step_s = wall / TRAIN_TIMED_STEPS
    all_losses = warm_losses.tolist() + losses.tolist()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if recipe is None:
        what = "AdamW lr 1e-4 wd 0.01 fp32 moments"
    else:
        peak = recipe["peak_lr"]
        what = (f"AdamW(0.9, 0.95, {recipe['epsilon']}) wd 0.1 but biases "
                f"and norms, bf16 moments, global-norm clip 1.0, "
                f"LinearWarmup(4 steps, 0 -> {peak}) into "
                f"CosineAnnealingDecay(T_max 9, eta_min {peak / 10}); "
                f"use_recompute")
    result = {
        "phase": cell, "model": c["preset"],
        "dtype": "bfloat16", "batch": B, "seq": S,
        "optimizer": what, "n_params": n_params,
        "warmup_steps": TRAIN_WARMUP_STEPS, "warmup_s": warm_s,
        "timed_steps": TRAIN_TIMED_STEPS, "wall_s": wall,
        "tokens_per_s": tokens / wall, "step_ms_mean": step_s * 1e3,
        "step_ms_median": statistics.median(step_ms),
        "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
        "mfu": flops / step_s / peak_flops(device_name),
        "flops_per_step": flops,
        "peak_mem_gib": peak_gib,
        "loss_first": all_losses[0], "loss_last": all_losses[-1],
        "losses": all_losses, "lr_vector": [float(x) for x in lr_used],
        "kernel_launches": launches,
        "launches_per_step": per_step, "model_init_s": init_s,
        "dispatch_count": warm.dispatch_count + step.dispatch_count}
    moe = [m for m in model.modules() if type(m).__name__ == "MoELayer"]
    if moe:
        # the last step's share of (token, rank) pairs each MoE layer
        # dropped at its capacity
        result["moe_dropped_share"] = [
            float((~m.routing[2]).float().mean()) for m in moe]
        result["moe_capacity"] = capacity_of(B * S, moe[0].top_k,
                                             moe[0].num_experts,
                                             moe[0].capacity_factor)
    emit(result)
    if record is not None:
        record.update({k: result[k] for k in (
            "tokens_per_s", "step_ms_median", "mfu", "peak_mem_gib")})
    check(all(math.isfinite(x) for x in all_losses), "non-finite loss")
    check(all_losses[-1] < all_losses[0],
          f"loss did not fall: {all_losses[0]} -> {all_losses[-1]}")
    check(per_step == {k: float(v) for k, v in want_launches.items()},
          f"launches per step {per_step}, want {want_launches}")
    check(not any(launches[k] for k in _kernels.FLASH_VARIANTS),
          f"the train step launched a mask or dropout variant: {launches}")
    if recipe is not None:
        host = recipe_schedule(recipe["peak_lr"])
        want_lr = []
        for _ in lr_used:
            want_lr.append(host())
            host.step()
        check(np.array_equal(np.asarray(lr_used, np.float32),
                             np.asarray(want_lr, np.float32)),
              f"lr vector {lr_used}, the schedule on the host {want_lr}")
    if train_peak_gib is not None:
        check(peak_gib < train_peak_gib,
              f"{cell} peak memory {peak_gib} GiB is not below the train "
              f"phase's {train_peak_gib} GiB")
    del model, opt, warm, step
    gc.collect()
    torch.cuda.empty_cache()
    return launches, peak_gib


# ------------------------------------------- phase 4f: vision_model
# The rest of vision/models on the card against CPU twins with the same
# weights, in training mode with every Dropout's p at 0 (the two devices
# draw different masks), TF32 off: a float64 forward and backward (the
# function: fp32 mobilenet at random init is ill-conditioned, see
# tests/test_torch_vision_models.py, and resnet_model's reason), then
# VISION_STEPS Adam steps through Model.train_batch, each from the CPU's
# state, under resnet_model's step rule. A gradient-norm limit is relative
# to the leaf's norm, with a floor of 1e-12 of the model's largest leaf
# norm: the projection BatchNorms' biases of mobilenet_v2 have a gradient
# that is zero in exact arithmetic (a later BatchNorm removes any shift),
# so their norm is rounding noise in float64 too.
VISION_MODELS = {"LeNet": ({}, (8, 1, 28, 28)),
                 "vgg11": ({"batch_norm": True}, (8, 3, 32, 32)),
                 "mobilenet_v1": ({}, (8, 3, 64, 64)),
                 "mobilenet_v2": ({}, (8, 3, 64, 64))}
VISION_STEPS = 3
VISION_GRAD_FLOOR = 1e-12
# the loss of the float64 run: the port's cross_entropy returns the fp32
# mean loss (as the JAX one does), so a few fp32 ulps of a loss near 7
VISION_FP64_LOSS_TOL = 1e-6
# mobilenet_v2's widest depthwise convolutions in a 64-image batch at
# 224 x 224: the 144-channel one at 56 x 56 and the 960-channel one at
# 7 x 7 (3 x 3, stride 1, padding 1, groups = channels)
DEPTHWISE_BF16_SHAPES = ((64, 144, 56, 56), (64, 960, 7, 7))


def vision_twins(name, seed, **kw):
    """(CPU model, card model) of vision model `name` (1000 classes by
    default) in fp32, training mode, the same weights and buffers drawn
    on the CPU from `seed`, every Dropout's p at 0."""
    import torch
    from paddle_tpu_torch.vision import models
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    cpu = getattr(models, name)(device="cpu", generator=gen, **kw)
    card = getattr(models, name)(device="cuda", **kw)
    card.load_state_dict(cpu.state_dict())
    for m in list(cpu.modules()) + list(card.modules()):
        if type(m).__name__ == "Dropout":
            m.p = 0.0
    return cpu, card


def vision_card_vs_cpu(name, kw, shape, seed):
    """Phase 4f's readings for one model; checks nothing."""
    import copy

    import numpy as np
    import torch
    import paddle_tpu_torch
    from paddle_tpu_torch.bridge import export_state
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.optimizer import Adam

    rng = np.random.RandomState(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    classes = kw.get("num_classes", 10 if name == "LeNet" else 1000)
    y = rng.randint(0, classes, (shape[0],)).astype(np.int64)
    cpu, card = vision_twins(name, seed, **kw)
    norms = {}
    for tag, m in (("card", copy.deepcopy(card).double()),
                   ("cpu", copy.deepcopy(cpu).double())):
        dev = "cuda" if tag == "card" else "cpu"
        logits = m(torch.from_numpy(x).to(dev, torch.float64))
        loss = CrossEntropyLoss()(logits, torch.from_numpy(y).to(dev))
        loss.backward()
        norms[tag] = (logits.detach().cpu(), float(loss.detach()),
                      {k: float(p.grad.norm()) for k, p in
                       m.named_parameters()},
                      [b.detach().cpu() for b in m.buffers()])
    (lg_a, l_a, g_a, b_a), (lg_b, l_b, g_b, b_b) = norms["card"], \
        norms["cpu"]
    floor = VISION_GRAD_FLOOR * max(g_b.values())
    over = {k: abs(g_a[k] - g_b[k]) / (RESNET_FP64_GRAD_RTOL * g_b[k]
                                       + floor) for k in g_b}
    worst = max(over, key=over.get)
    fp64 = {"logits_max_abs_diff": float((lg_a - lg_b).abs().max()),
            "loss_abs_diff": abs(l_a - l_b),
            "grad_norm_worst_over_limit": over[worst],
            "grad_norm_worst_leaf": worst,
            "grad_norm_worst_rel_diff": abs(g_a[worst] - g_b[worst])
            / max(g_b[worst], 1e-300),
            "buffer_max_rel_diff": max(
                [float(((a - b).abs() / (1 + b.abs())).max())
                 for a, b in zip(b_a, b_b)] or [0.0])}
    models, opts = {}, {}
    for tag, m in (("card", card), ("cpu", cpu)):
        opts[tag] = Adam(learning_rate=TRAIN_PARITY_LR,
                         parameters=m.parameters())
        models[tag] = paddle_tpu_torch.Model(m).prepare(
            opts[tag], CrossEntropyLoss(), Accuracy())
    per_step = []
    _kernels.reset_launch_counts()
    for i in range(VISION_STEPS):
        if i:
            _sync_from(torch, card, cpu, opts["card"], opts["cpu"])
        out = {tag: models[tag].train_batch([torch.from_numpy(x)],
                                            [torch.from_numpy(y)])
               for tag in ("card", "cpu")}
        wc, wp = export_state(card), export_state(cpu)
        worst_w, far, total = 0.0, 0, 0
        for k in wc:
            d = np.abs(wc[k] - wp[k])
            worst_w = max(worst_w, float(d.max()))
            far += int((d > TRAIN_PARITY_LR / 10).sum())
            total += d.size
        l_card, l_cpu = out["card"][0][0], out["cpu"][0][0]
        per_step.append({"loss_card": l_card, "loss_cpu": l_cpu,
                         "loss_abs_diff": abs(l_card - l_cpu),
                         "acc_card": float(out["card"][1][0]),
                         "acc_cpu": float(out["cpu"][1][0]),
                         "param_max_abs_diff": worst_w,
                         "param_share_past_lr_over_10": far / total,
                         "buffer_max_rel_diff": _buffer_diff(torch, card,
                                                             cpu)})
    torch.cuda.synchronize()
    launched = _kernels.launch_counts()
    readings = {"model": name, **{k: v for k, v in kw.items()},
                "input": list(shape), "fp64": fp64, "steps": per_step,
                "leaves": sum(1 for _ in card.parameters()),
                "buffers": sum(1 for _ in card.buffers()),
                "kernel_launches": launched}
    del cpu, card, models, opts
    return readings


def check_depthwise_bf16(shape, seed):
    """A bf16 depthwise 3 x 3 convolution (stride 1, padding 1) through
    the port's conv2d on the card against fp32 math on the same bf16
    inputs rounded once to bf16 (F.conv2d in fp32, TF32 off): every
    element within one bf16 ulp of the larger magnitude + 1e-6 (two
    roundings of fp32 sums that differ only in order). Returns the
    readings; checks the limit."""
    import torch
    import torch.nn.functional as TF
    from paddle_tpu_torch.nn import functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    C = shape[1]
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((C, 1, 3, 3), generator=gen, device="cuda")
         / 3).to(torch.bfloat16)
    got = F.conv2d(x, w, None, 1, 1, 1, C)
    want = TF.conv2d(x.float(), w.float(), None, 1, 1, 1, C).to(
        torch.bfloat16)
    check(got.dtype == torch.bfloat16 and got.shape == want.shape,
          f"bf16 depthwise conv gave {got.dtype} {tuple(got.shape)}")
    a, r = got.float(), want.float()
    units = (a - r).abs() / (ulp_bf16(torch.maximum(a.abs(), r.abs()))
                             + 1e-6)
    ms, _ = time_cuda([lambda: F.conv2d(x, w, None, 1, 1, 1, C)])
    out = {"shape": list(shape), "max_over_limit": float(units.max()),
           "share_off": float((a != r).float().mean()), "ms": ms}
    check(out["max_over_limit"] <= 1.0,
          f"bf16 depthwise conv {shape} is {out['max_over_limit']} times "
          "its limit (one bf16 ulp + 1e-6) from fp32 math on its inputs")
    return out


def phase_vision_model():
    """Phase 4f: vision_card_vs_cpu for each of VISION_MODELS under its
    limits, then the bf16 depthwise convolutions."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    results = []
    for i, (name, (kw, shape)) in enumerate(VISION_MODELS.items()):
        r = vision_card_vs_cpu(name, kw, shape, SEED + 20 + i)
        results.append(r)
        gc.collect()
        torch.cuda.empty_cache()
    depthwise = [check_depthwise_bf16(s, SEED + 30 + i)
                 for i, s in enumerate(DEPTHWISE_BF16_SHAPES)]
    emit({"phase": "vision_model",
          "config": f"train mode, Dropout p 0, TF32 off; float64 forward "
                    f"and backward; {VISION_STEPS} Adam steps (lr "
                    f"{TRAIN_PARITY_LR}) through Model.train_batch each "
                    "from the CPU's state",
          "tols": {"fp64": [RESNET_FP64_LOGITS_TOL, VISION_FP64_LOSS_TOL,
                            RESNET_FP64_GRAD_RTOL, VISION_GRAD_FLOOR,
                            RESNET_FP64_BUFFER_TOL],
                   "steps": [TRAIN_PARITY_LOSS_TOL, 6 * TRAIN_PARITY_LR,
                             RESNET_PARAM_SHARE, RESNET_BUFFER_TOL]},
          "models": results, "depthwise_bf16": depthwise,
          "seconds": time.perf_counter() - t0})
    for r in results:
        want = {k: 0 for k in r["kernel_launches"]}
        want["fused_adam"] = r["leaves"] * VISION_STEPS
        check(r["kernel_launches"] == want,
              f"{r['model']} steps launched {r['kernel_launches']}, want "
              f"{want}")
        f64 = r["fp64"]
        check(f64["logits_max_abs_diff"] <= RESNET_FP64_LOGITS_TOL
              and f64["loss_abs_diff"] <= VISION_FP64_LOSS_TOL
              and f64["grad_norm_worst_over_limit"] <= 1.0
              and f64["buffer_max_rel_diff"] <= RESNET_FP64_BUFFER_TOL,
              f"float64 card vs CPU {r['model']}: {f64}")
        for i, st in enumerate(r["steps"]):
            check(st["loss_abs_diff"] <= TRAIN_PARITY_LOSS_TOL
                  and st["param_max_abs_diff"] <= 6 * TRAIN_PARITY_LR
                  and st["param_share_past_lr_over_10"]
                  <= RESNET_PARAM_SHARE
                  and st["buffer_max_rel_diff"] <= RESNET_BUFFER_TOL,
                  f"card vs CPU {r['model']} step {i}: {st}")


# ------------------------------------------ phase 16: mobilenet_fit
# Paddle's high-level path on the card: full mobilenet_v2 (scale 1.0,
# 1000 classes) in fp32 (the JAX Model path's dtype; TF32 off, as the JAX
# package computes fp32 at full precision), Model.prepare(Adam(1e-3),
# CrossEntropyLoss(), Accuracy(topk=(1, 5))), fitted on 512 seeded
# 224 x 224 x 3 uint8 images with labels in [0, 1000) through
# Compose([ToTensor(), Normalize(ImageNet mean, std)]), batch 64, eval on
# 128 more, a ModelCheckpoint each epoch: two fits of one epoch each, the
# first loading in the main process (num_workers=0), the second with 4
# worker processes. The counts are zeroed just before the first fit and
# read just after the second.
MOBILENET_FIT = dict(images=512, eval_images=128, side=224, classes=1000,
                     batch=64, lr=1e-3, workers=(0, 4))
MOBILENET_V2_LEAVES = 158        # fused-Adam launches a step
MOBILENET_V2_MACS = 320_237_568  # paddle.flops at [1, 3, 224, 224]
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BUSY_STEPS = 4                   # train_batch calls in a profiled window


class SeededImages:
    """`n` uint8 HWC images and int64 labels drawn from `seed`, each
    image through `transform` (a map-style dataset)."""

    def __init__(self, n, seed, side, classes, transform):
        import numpy as np
        rng = np.random.RandomState(seed)
        self.images = rng.randint(0, 256, (n, side, side, 3), dtype=np.uint8)
        self.labels = rng.randint(0, classes, (n,)).astype(np.int64)
        self.transform = transform

    def __getitem__(self, i):
        return self.transform(self.images[i]), self.labels[i]

    def __len__(self):
        return len(self.images)


def _busy_window(torch, model, dataset, workers):
    """(device-busy ms, wall ms) of BUSY_STEPS train_batch calls fed by a
    DataLoader with `workers` processes, under torch.profiler; the
    workers are started, and one batch taken, before the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.io import DataLoader
    c = MOBILENET_FIT
    it = iter(DataLoader(dataset, batch_size=c["batch"], shuffle=True,
                         num_workers=workers))
    next(it)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(BUSY_STEPS):
            x, y = next(it)
            model.train_batch([x], [y])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    if workers:
        it.close()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return busy, wall


def phase_mobilenet_fit(device_name):
    """Phase 16. Returns the fits' launch counts."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import paddle_tpu_torch
    from paddle_tpu_torch.callbacks import Callback, ModelCheckpoint
    from paddle_tpu_torch.metric import Accuracy
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision import transforms as T
    from paddle_tpu_torch.vision.models import mobilenet_v2

    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = MOBILENET_FIT
    macs = paddle_tpu_torch.flops(mobilenet_v2(device="cpu"),
                                  input_size=[1, 3, c["side"], c["side"]])
    check(macs == MOBILENET_V2_MACS, f"mobilenet_v2 counts {macs} MACs, "
                                     f"want {MOBILENET_V2_MACS}")
    flops_per_step = 6 * macs * c["batch"]
    tf = T.Compose([T.ToTensor(), T.Normalize(IMAGENET_MEAN, IMAGENET_STD)])
    t0 = time.perf_counter()
    train = SeededImages(c["images"], SEED + 40, c["side"], c["classes"], tf)
    evals = SeededImages(c["eval_images"], SEED + 41, c["side"],
                         c["classes"], tf)
    data_s = time.perf_counter() - t0
    paddle_tpu_torch.seed(SEED + 42)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 43)
    net = mobilenet_v2(num_classes=c["classes"], device="cuda",
                       generator=gen)
    model = paddle_tpu_torch.Model(net).prepare(
        Adam(learning_rate=c["lr"], parameters=net.parameters()),
        CrossEntropyLoss(), Accuracy(topk=(1, 5)))
    check(all(p.dtype == torch.float32 and p.is_cuda
              for p in net.parameters()), "mobilenet_fit's model is not "
                                          "fp32 on the card")

    class Clock(Callback):
        """Epoch wall (loading included), each train_batch's device time
        between two CUDA events, the losses and the eval logs."""

        def __init__(self):
            super().__init__()
            self.epoch_s, self.pairs, self.losses, self.evals = [], [], [], []

        def on_epoch_begin(self, epoch, logs=None):
            torch.cuda.synchronize()
            self._t0 = time.perf_counter()
            self.losses.append([])

        def on_train_batch_begin(self, step, logs=None):
            a = torch.cuda.Event(enable_timing=True)
            a.record()
            self.pairs.append([a])

        def on_train_batch_end(self, step, logs=None):
            b = torch.cuda.Event(enable_timing=True)
            b.record()
            self.pairs[-1].append(b)
            self.losses[-1].append(logs["loss"])

        def on_epoch_end(self, epoch, logs=None):
            torch.cuda.synchronize()
            self.epoch_s.append(time.perf_counter() - self._t0)

        def on_eval_end(self, logs=None):
            self.evals.append({"loss": float(logs["loss"]),
                               "acc": [float(a) for a in logs["acc"]]})

    save_dir = tempfile.mkdtemp(prefix="mobilenet_fit_")
    clock = Clock()
    epochs, syncs = [], []
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    try:
        for workers in c["workers"]:
            n_pairs = len(clock.pairs)
            for k in model.host_sync_s:
                model.host_sync_s[k] = 0.0
            t0 = time.perf_counter()
            model.fit(train, eval_data=evals, batch_size=c["batch"],
                      epochs=1, verbose=0, num_workers=workers,
                      callbacks=[clock, ModelCheckpoint(save_dir=save_dir)])
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            step_ms = [a.elapsed_time(b) for a, b in clock.pairs[n_pairs:]]
            steps = len(step_ms)
            epochs.append({
                "num_workers": workers, "steps": steps,
                "epoch_s": clock.epoch_s[-1],
                "images_per_s": c["images"] / clock.epoch_s[-1],
                "fit_s_with_eval_and_checkpoint": fit_s,
                "train_batch_ms_mean": statistics.mean(step_ms),
                "train_batch_ms_median": statistics.median(step_ms),
                "train_batch_ms_min": min(step_ms),
                "train_batch_ms_max": max(step_ms),
                "mfu_fp32": flops_per_step / (statistics.mean(step_ms) / 1e3)
                / PEAK_OPS["float32"],
                "loss_mean": statistics.mean(clock.losses[-1]),
                "eval": clock.evals[-1]})
            syncs.append({k: v / steps * 1e3
                          for k, v in model.host_sync_s.items()})
        torch.cuda.synchronize()
        launches = _kernels.launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        # the last checkpoint into a fresh model: eval-mode logits on one
        # batch bit-equal to the fitted model's (the same cuDNN
        # algorithms: benchmark mode is off, so cuDNN picks them by
        # heuristics from the shapes alone, and the forward is
        # deterministic)
        gen2 = torch.Generator(device="cuda")
        gen2.manual_seed(SEED + 44)
        net2 = mobilenet_v2(num_classes=c["classes"], device="cuda",
                            generator=gen2)
        model2 = paddle_tpu_torch.Model(net2).prepare(
            Adam(learning_rate=c["lr"], parameters=net2.parameters()),
            CrossEntropyLoss())
        ckpt = sorted(os.listdir(save_dir))
        model2.load(os.path.join(save_dir, "0"))
        x = torch.from_numpy(np.stack([evals[i][0] for i in
                                       range(c["batch"])])).cuda()
        net.eval()
        net2.eval()
        with torch.no_grad():
            bit_equal = torch.equal(net(x), net2(x))
        slots_equal = all(
            torch.equal(model._optimizer.state[p][k],
                        model2._optimizer.state[q][k])
            for p, q in zip(net.parameters(), net2.parameters())
            for k in model._optimizer.state[p])
        del model2, net2
        busy = {}
        for workers in c["workers"]:
            b, w = _busy_window(torch, model, train, workers)
            busy[f"num_workers_{workers}"] = {
                "device_busy_ms": b, "wall_ms": w, "busy_share": b / w,
                "steps": BUSY_STEPS}
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    per_step = {k: v / sum(e["steps"] for e in epochs)
                for k, v in launches.items()}
    emit({"phase": "mobilenet_fit", "model": "mobilenet_v2",
          "scale": 1.0, "classes": c["classes"], "dtype": "float32",
          "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                   "cudnn": torch.backends.cudnn.allow_tf32},
          "mfu_peak": "67 TFLOP/s fp32 (TF32 off)",
          "images": c["images"], "eval_images": c["eval_images"],
          "batch": c["batch"], "image": [3, c["side"], c["side"]],
          "optimizer": f"Adam lr {c['lr']}",
          "fits": "two fits of one epoch: num_workers 0, then 4",
          "n_params": sum(p.numel() for p in net.parameters()),
          "leaves": sum(1 for _ in net.parameters()),
          "forward_macs_per_image": macs, "flops_per_step": flops_per_step,
          "data_s": data_s, "epochs": epochs,
          "host_sync_ms_per_step": syncs, "busy": busy,
          "peak_mem_gib": peak_gib, "checkpoint_files": ckpt,
          "reload_logits_bit_equal": bit_equal,
          "reload_optimizer_slots_equal": slots_equal,
          "kernel_launches": launches, "launches_per_step": per_step})
    losses = [v for e in epochs for v in [e["loss_mean"]]]
    check(all(math.isfinite(v) for e in clock.losses for v in e),
          "non-finite loss")
    check(losses[1] < losses[0], f"the second epoch's mean loss "
                                 f"{losses[1]} is not below the first's "
                                 f"{losses[0]}")
    for e in epochs:
        acc = e["eval"]["acc"]
        check(len(acc) == 2 and 0 <= acc[0] <= acc[1] <= 1,
              f"evaluate's top-1/top-5 {acc}")
    want = {k: 0.0 for k in launches}
    want["fused_adam"] = float(MOBILENET_V2_LEAVES)
    check(per_step == want, f"launches per step {per_step}, want {want}")
    check(ckpt == ["0.pdopt", "0.pdparams"], f"checkpoint files {ckpt}")
    check(bit_equal and slots_equal,
          f"reloaded checkpoint: logits bit-equal {bit_equal}, optimizer "
          f"slots equal {slots_equal}")
    del model, net
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# -------------------------------------------- phase 17: resilient_train
# The resilient training runtime (ResilientTrainer with the goodput ledger,
# CheckpointManager, AsyncCheckpointManager, fault injection) over full
# gpt3-125m (GPT-3 Small: Brown et al. 2020, Table 2.1), bf16, 8 x 1024
# tokens a step, AdamW lr 1e-4 wd 0.01 with fp32 moments, through
# ScanTrainStep(scan_steps=2): 10 steps a run over the first 10 of
# RESILIENT_BATCHES seeded batches (one a step, so a replayed step takes
# its own batch again).
#   1. baseline  only the end-of-run save: the step time;
#   2. sync      CheckpointManager at save_interval 8;
#   3. async     AsyncCheckpointManager at save_interval 2, max_to_keep 2,
#                with raise@5 (a retry) and nan_loss@9 (mid-chunk, the
#                last: rolled back to the ring's snapshot of step 8);
#   4. resume    a child process runs 3's configuration with
#                kill@6:persist and dies by SIGKILL in the writer; a
#                second child resumes from the same directory (the
#                scrubber first) and runs to step 10.
# Runs 3 and 4 must give run 2's losses and final parameters and moments
# bit for bit (the flash and LayerNorm kernels are atomic-free, with a
# fixed order of summation), and the rollback must write into the live
# parameter and slot storage. The killed child runs RESILIENT_KILL_STEPS
# steps: with the writer slower than a chunk (the expected backpressure),
# snapshot 6 survives the drop-oldest queue only while at most one newer
# snapshot is queued behind it, which a run that ends at step 8 ensures.
# (was 16: the faults, the kill and the rollback all fall before step
# 10, so the steps cut held no check of their own, only checkpoint writes)
RESILIENT = dict(preset="gpt3-125m", batch=(8, 1024), steps=10,
                 scan_steps=2, lr=1e-4)
RESILIENT_BATCHES = 16     # drawn; train_numerics runs 12 steps over them
RESILIENT_SYNC_INTERVAL = 8
RESILIENT_ASYNC_INTERVAL = 2
RESILIENT_KEEP = 2
RESILIENT_FAULTS = "raise@5;nan_loss@9"
RESILIENT_KILL = "kill@6:persist"
RESILIENT_KILL_STEPS = 8
RESILIENT_CHILD_TIMEOUT = 300
# a step's launches: 12 layers, no recompute, 149 parameters (12 a layer,
# the two embeddings, the final LayerNorm's two and the untied lm_head)
RESILIENT_KERNELS_PER_STEP = launches_per_step(12, 149, False)


def resilient_model():
    """The cell's model (bf16, random weights from SEED, training mode),
    its optimizer, and a ScanTrainStep that records every chunk: its first
    step (`start`, set by the batch fn), its losses and its wall ms, and
    calls `on_chunk(start, losses)` when set."""
    import torch
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ScanTrainStep

    class RecordingStep(ScanTrainStep):
        start = None
        on_chunk = None

        def __call__(self, *args):
            t0 = time.perf_counter()
            losses = super().__call__(*args)
            torch.cuda.synchronize()   # the trainer reads them next anyway
            t1 = time.perf_counter()
            self.chunks.append((self.start, losses.tolist(),
                                (t1 - t0) * 1e3, t1))
            if self.on_chunk is not None:
                self.on_chunk(self.start, losses.tolist())
            return losses

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    model = GPTForCausalLM.from_preset(RESILIENT["preset"], device="cuda",
                                       dtype="bfloat16", generator=gen)
    model.train()
    opt = AdamW(learning_rate=RESILIENT["lr"], weight_decay=0.01,
                parameters=model.parameters(), moment_dtype="float32")
    step = RecordingStep(model, opt, scan_steps=RESILIENT["scan_steps"])
    step.chunks = []
    return model, opt, step


def resilient_batches(vocab):
    """[RESILIENT_BATCHES, B, S] int32 token ids and labels on the card,
    from SEED."""
    import numpy as np
    import torch
    rng = np.random.RandomState(SEED + 5)
    shape = (RESILIENT_BATCHES,) + RESILIENT["batch"]
    return tuple(torch.from_numpy(rng.randint(0, vocab, shape)
                                  .astype(np.int32)).cuda() for _ in "il")


def state_digest(state):
    """{keystr: [dtype, shape, crc32 of the bytes]} of every tensor of a
    state tree, the other leaves as they are: equal digests, equal bits."""
    import zlib
    import torch
    from paddle_tpu_torch.checkpoint import _keystr, _leaves_with_path
    out = {}
    for path, leaf in _leaves_with_path(state):
        if torch.is_tensor(leaf):
            b = leaf.detach().reshape(-1).view(torch.uint8).cpu().numpy()
            leaf = [str(leaf.dtype), list(leaf.shape), zlib.crc32(b)]
        out[_keystr(path)] = leaf
    return out


def first_difference(a, b):
    """The first key whose leaves differ between two digests, or None."""
    for k in sorted(set(a) | set(b)):
        if a.get(k) != b.get(k):
            return k
    return None


def check_disk_room(directory, model):
    """Fail unless `directory`'s disk holds RESILIENT_KEEP + 1 step files:
    4 bytes an element of every parameter (bf16 is written as fp32
    values) and of every slot the optimizer will hold (two fp32 moments a
    parameter)."""
    import shutil
    n = sum(p.numel() for p in model.parameters())
    per_file = 4 * n + 2 * 4 * n
    free = shutil.disk_usage(directory).free
    need = (RESILIENT_KEEP + 1) * per_file
    check(free >= need,
          f"resilient_train: {directory} has {free / 2**30:.2f} GiB free; "
          f"{RESILIENT_KEEP + 1} checkpoints of {RESILIENT['preset']} "
          f"need {need / 2**30:.2f} GiB")
    return per_file


def resilient_run(workdir, tier, spec=None, num_steps=None, on_chunk=None,
                  time_disk_restore=False):
    """One run of the cell under ResilientTrainer(goodput=True) writing
    into `workdir`: `tier` None (only the end-of-run save), "sync"
    (CheckpointManager at RESILIENT_SYNC_INTERVAL) or "async"
    (AsyncCheckpointManager at RESILIENT_ASYNC_INTERVAL); `spec` a
    FaultPlan spec for the trainer (None: the process-global plan, which
    PDTPU_FAULTS sets, as the writer's kill points read it). With
    `time_disk_restore`, an async run then times a resume's restore of
    its newest certified step into the live state. Returns a dict of
    readings; the model is freed before it returns."""
    import torch
    from paddle_tpu_torch.checkpoint import (AsyncCheckpointManager,
                                             CheckpointManager,
                                             _leaves_with_path)
    from paddle_tpu_torch.distributed.resilient import (ResilientConfig,
                                                        ResilientTrainer)
    from paddle_tpu_torch.obs.flight_recorder import flight_recorder
    from paddle_tpu_torch.obs.flops import peak_flops, train_flops_per_step
    from paddle_tpu_torch.utils.fault_injection import FaultPlan

    num_steps = num_steps or RESILIENT["steps"]
    model, opt, step = resilient_model()
    step.on_chunk = on_chunk
    ids, labels = resilient_batches(model.config.vocab_size)
    K = step.scan_steps
    os.makedirs(workdir, exist_ok=True)
    file_bytes = check_disk_room(workdir, model)

    def batch_fn(i):
        step.start = i
        return ids[i:i + K], labels[i:i + K]

    def live_ptrs():
        return [p.data_ptr() for p in model.parameters()] + [
            t.data_ptr() for slots in opt.state.values()
            for t in slots.values()]

    def get_state():
        return {"model": model.state_dict(), "opt": opt.state_dict(),
                "step": step._step_count}

    moved = []     # storage pointers a restore changed, one entry a call

    def set_state(s):
        before = live_ptrs()
        missing, unexpected = model.set_state_dict(s["model"])
        check(not missing and not unexpected,
              f"restore: missing {missing[:3]}, unexpected {unexpected[:3]}")
        opt.set_state_dict(s["opt"])
        step._step_count = int(s["step"])
        moved.append(sum(a != b for a, b in zip(before, live_ptrs())))

    if tier == "async":
        ckpt = AsyncCheckpointManager(workdir, max_to_keep=RESILIENT_KEEP)
        interval = RESILIENT_ASYNC_INTERVAL
    else:
        ckpt = CheckpointManager(workdir, max_to_keep=RESILIENT_KEEP)
        interval = RESILIENT_SYNC_INTERVAL if tier == "sync" else num_steps
    trainer = ResilientTrainer(
        step, ckpt, get_state=get_state, set_state=set_state,
        config=ResilientConfig(save_interval=interval),
        fault_plan=FaultPlan.from_spec(spec) if spec is not None else None,
        goodput=True)
    # live MFU: the ledger's productive steps over its wall, 6·N·D
    trainer.ledger.set_flops(
        train_flops_per_step(sum(p.numel() for p in model.parameters()),
                             RESILIENT["batch"][0] * RESILIENT["batch"][1]),
        peak_flops(torch.cuda.get_device_name(0)))
    save_ms, rollback_ms = [], []
    if tier != "async":
        plain_save = ckpt.save

        def timed_save(*a, **kw):
            t0 = time.perf_counter()
            plain_save(*a, **kw)
            save_ms.append((time.perf_counter() - t0) * 1e3)
        ckpt.save = timed_save
    plain_restore = trainer._restore_latest

    def timed_restore():
        t0 = time.perf_counter()
        out = plain_restore()
        torch.cuda.synchronize()
        rollback_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    trainer._restore_latest = timed_restore

    flight_recorder().clear()
    t_run = time.perf_counter()
    summary = trainer.run(batch_fn, num_steps=num_steps)
    run_s = time.perf_counter() - t_run
    events = flight_recorder().snapshot()["events"]
    losses = {}
    for start, vec, _, _ in step.chunks:
        for i, v in enumerate(vec):
            losses.setdefault(start + i, []).append(v)
    out = {"run_s": run_s, "losses": losses,
           "steps_run": sum(len(c[1]) for c in step.chunks),
           "chunk_ms": [c[2] for c in step.chunks],
           "first_chunk_s": step.chunks[0][3] - t_run,
           "save_ms": save_ms, "rollback_ms": rollback_ms,
           "restore_moved_ptrs": moved, "file_bytes": file_bytes,
           "events": [{k: v for k, v in e.items()
                       if isinstance(v, (str, int, float, bool))}
                      for e in summary["events"]],
           "retries": summary["retries"], "rollbacks": summary["rollbacks"],
           "goodput": summary["goodput"],
           "snapshot_blocking_ms": [e["blocking_ms"] for e in events
                                    if e["kind"] == "ckpt_snapshot"],
           "persist_ms": [e["ms"] for e in events
                          if e["kind"] == "ckpt_persist"],
           "persist_lag_ms": [e["lag_ms"] for e in events
                              if e["kind"] == "ckpt_persist"],
           "quarantined": [e["step"] for e in summary["events"]
                           if e["kind"] == "ckpt_quarantined"]}
    out["digest"] = state_digest(get_state())
    if tier == "async":
        out["checkpoint"] = summary["checkpoint"]
        out["snapshot_bytes"] = sum(
            t.numel() * t.element_size()
            for _, t in _leaves_with_path(ckpt.newest_snapshot().state)
            if torch.is_tensor(t))
    if time_disk_restore:
        latest = ckpt.latest_step()
        # a resume's restore: the certified file back into the live state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        set_state(ckpt.restore(latest))
        torch.cuda.synchronize()
        out["disk_restore_ms"] = (time.perf_counter() - t0) * 1e3
        out["disk_restore_step"] = latest
    if tier == "async":
        ckpt.close()
    del model, opt, step, trainer, ids, labels
    gc.collect()
    torch.cuda.empty_cache()
    return out


def resilient_child(workdir, num_steps):
    """The child processes of phase 17 (`chip_smoke.py --resilient-child
    WORKDIR STEPS`): run 3's configuration over WORKDIR/ckpt with the
    faults of PDTPU_FAULTS (the process-global plan), appending every
    chunk's losses to WORKDIR/losses.jsonl (fsynced: a SIGKILL loses
    none), then writing WORKDIR/report.json."""
    path = os.path.join(workdir, "losses.jsonl")
    with open(path, "a") as f:
        def on_chunk(start, losses):
            f.write(json.dumps({"start": start, "losses": losses}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        r = resilient_run(os.path.join(workdir, "ckpt"), "async",
                          num_steps=num_steps, on_chunk=on_chunk)
    resumed = [e["step"] for e in r["events"] if e["kind"] == "resumed"]
    r.pop("losses")
    r["resumed_from"] = resumed[0] if resumed else 0
    with open(os.path.join(workdir, "report.json"), "w") as f:
        json.dump(r, f)
    return 0


def _child_losses(workdir):
    """{step: [every recording]} from a child's losses.jsonl."""
    losses = {}
    with open(os.path.join(workdir, "losses.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            for i, v in enumerate(rec["losses"]):
                losses.setdefault(rec["start"] + i, []).append(v)
    return losses


def _spawn_child(workdir, num_steps, faults):
    env = dict(os.environ)
    env.pop("PDTPU_FAULTS", None)
    if faults:
        env["PDTPU_FAULTS"] = faults
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--resilient-child",
         workdir, str(num_steps)], env=env, capture_output=True, text=True,
        timeout=RESILIENT_CHILD_TIMEOUT)
    return proc, time.perf_counter() - t0


def _ms_stats(xs):
    return {"n": len(xs), "p50": statistics.median(xs) if xs else None,
            "max": max(xs) if xs else None}


def phase_resilient_train(device_name, smi_line):
    """Phase 17 (see RESILIENT). Returns the launch counts of runs 1-3,
    the phase's main path in this process."""
    import shutil
    import signal
    import tempfile
    import torch
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.ops import _kernels

    gc.collect()
    torch.cuda.empty_cache()
    # the checkpoints go beside the kernel build, on the checkout's disk
    # (build/ is not committed); check_disk_room fails a run without room
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="resilient_train_", dir=build)
    try:
        _kernels.reset_launch_counts()
        base = resilient_run(os.path.join(root, "baseline"), None)
        shutil.rmtree(os.path.join(root, "baseline"))
        sync = resilient_run(os.path.join(root, "sync"), "sync")
        shutil.rmtree(os.path.join(root, "sync"))
        asy = resilient_run(os.path.join(root, "async"), "async",
                            RESILIENT_FAULTS, time_disk_restore=True)
        launches = _kernels.launch_counts()
        shutil.rmtree(os.path.join(root, "async"))

        work = os.path.join(root, "resume")
        os.makedirs(work)
        killed, killed_s = _spawn_child(work, RESILIENT_KILL_STEPS,
                                        RESILIENT_KILL)
        check(killed.returncode == -signal.SIGKILL,
              f"the {RESILIENT_KILL} child exited {killed.returncode}, not "
              f"by SIGKILL: {killed.stderr[-3000:]}")
        on_disk = CheckpointManager(os.path.join(work, "ckpt"),
                                    device="cpu").all_steps()
        killed_losses = _child_losses(work)
        resumed, resumed_s = _spawn_child(work, RESILIENT["steps"], None)
        check(resumed.returncode == 0,
              f"the resumed child exited {resumed.returncode}: "
              f"{resumed.stderr[-3000:]}")
        with open(os.path.join(work, "report.json")) as f:
            rep = json.load(f)
        stitched = _child_losses(work)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    steps = RESILIENT["steps"]
    want = sync["losses"]
    per_step = {k: launches[k] / (base["steps_run"] + sync["steps_run"]
                                  + asy["steps_run"])
                for k in RESILIENT_KERNELS_PER_STEP}
    warm = base["chunk_ms"][1:]
    step_ms = statistics.median(warm) / RESILIENT["scan_steps"]
    n_steps = RESILIENT["scan_steps"]

    def shares(g):
        return {k: v / g["wall_seconds"] for k, v in
                g["phase_seconds"].items()} if g["wall_seconds"] else {}

    common = {"phase": "resilient_train", "card": smi_line,
              "model": RESILIENT["preset"], "dtype": "bfloat16",
              "batch": list(RESILIENT["batch"]), "scan_steps": n_steps}
    emit({**common, "part": "baseline", "steps": steps,
          "step_ms": step_ms, "chunk_ms": base["chunk_ms"],
          "end_save_ms": base["save_ms"], "run_s": base["run_s"],
          "goodput": base["goodput"]["goodput"],
          "live_mfu": base["goodput"]["mfu"],
          "phase_shares": shares(base["goodput"]),
          "tokens_per_s": (RESILIENT["batch"][0] * RESILIENT["batch"][1]
                           / step_ms * 1e3),
          "losses_equal_sync": base["losses"] == want})
    emit({**common, "part": "sync", "save_interval": RESILIENT_SYNC_INTERVAL,
          "save_ms": sync["save_ms"], "file_bytes": sync["file_bytes"],
          "run_s": sync["run_s"], "goodput": sync["goodput"]["goodput"],
          "live_mfu": sync["goodput"]["mfu"],
          "phase_shares": shares(sync["goodput"]),
          "checkpoint_blocking_s":
              sync["goodput"]["checkpoint_blocking_seconds"]})
    blocking = asy["snapshot_blocking_ms"]
    emit({**common, "part": "async", "faults": RESILIENT_FAULTS,
          "save_interval": RESILIENT_ASYNC_INTERVAL,
          "max_to_keep": RESILIENT_KEEP,
          "snapshot_blocking_ms": _ms_stats(blocking),
          "snapshot_bytes": asy["snapshot_bytes"],
          "snapshot_gb_per_s": (asy["snapshot_bytes"] / 1e9
                                / (statistics.median(blocking) / 1e3)),
          "persist_ms": _ms_stats(asy["persist_ms"]),
          "persist_lag_ms": _ms_stats(asy["persist_lag_ms"]),
          "dropped": asy["checkpoint"]["dropped"],
          "snapshots": asy["checkpoint"]["snapshots"],
          "persisted": asy["checkpoint"]["persisted"],
          "ring_rollback_ms": asy["rollback_ms"],
          "disk_restore_ms": asy["disk_restore_ms"],
          "disk_restore_step": asy["disk_restore_step"],
          "restore_moved_ptrs": asy["restore_moved_ptrs"],
          "events": [(e["kind"], e["step"]) for e in asy["events"]],
          "retries": asy["retries"], "rollbacks": asy["rollbacks"],
          "run_s": asy["run_s"], "goodput": asy["goodput"]["goodput"],
          "live_mfu": asy["goodput"]["mfu"],
          "phase_shares": shares(asy["goodput"]),
          "checkpoint_blocking_s":
              asy["goodput"]["checkpoint_blocking_seconds"],
          "checkpoint_async_s": asy["goodput"]["checkpoint_async_seconds"],
          "steps_run": asy["steps_run"]})
    emit({**common, "part": "resume", "kill": RESILIENT_KILL,
          "killed_rc": killed.returncode, "killed_child_s": killed_s,
          "certified_after_kill": on_disk,
          "resumed_from": rep["resumed_from"],
          "quarantined": rep["quarantined"],
          # the child's process outside its run: interpreter, imports,
          # CUDA context, the kernel library's load, model build, exit
          "child_outside_run_s": resumed_s - rep["run_s"],
          "resume_to_first_step_s": rep["first_chunk_s"],
          "resumed_child_s": resumed_s, "run_s": rep["run_s"],
          "goodput": rep["goodput"]["goodput"],
          "live_mfu": rep["goodput"]["mfu"],
          "phase_shares": shares(rep["goodput"]),
          "dropped": rep["checkpoint"]["dropped"],
          "launches_per_step": per_step})

    check(set(want) == set(range(steps))
          and all(len(v) == 1 for v in want.values()),
          f"the sync run recorded steps {sorted(want)}")
    check(all(math.isfinite(v[0]) for v in want.values()),
          f"non-finite loss in the sync run: {want}")
    check(per_step == {k: float(v)
                       for k, v in RESILIENT_KERNELS_PER_STEP.items()},
          f"launches per step {per_step}, want {RESILIENT_KERNELS_PER_STEP}")
    check(asy["steps_run"] == steps + n_steps,
          f"the async run ran {asy['steps_run']} steps, want {steps} and "
          f"one replayed chunk")

    def bit_equal(got, what):
        """Every recording of every step in `got` is the sync run's."""
        bad = {s: (xs, want.get(s)) for s, xs in got.items()
               if s not in want or any(x != want[s][0] for x in xs)}
        check(not bad, f"{what}: losses differ from the sync run's: {bad}")

    bit_equal(asy["losses"], "async run")
    check(set(asy["losses"]) == set(range(steps)),
          f"async run recorded steps {sorted(asy['losses'])}")
    kinds = [(e["kind"], e["step"]) for e in asy["events"]]
    check(kinds == [("step_error", 4), ("retry", 4), ("bad_loss", 9),
                    ("rollback", 8)],
          f"async run events {kinds}")
    rb = [e for e in asy["events"] if e["kind"] == "rollback"]
    check(rb[0]["source"] == "ring", f"rollback served from {rb[0]}")
    check(asy["restore_moved_ptrs"] and not any(asy["restore_moved_ptrs"]),
          f"a restore moved {asy['restore_moved_ptrs']} tensors' storage")
    diff = first_difference(asy["digest"], sync["digest"])
    check(diff is None, f"async run's final state differs at {diff}")
    bit_equal(killed_losses, "killed child")
    check(rep["resumed_from"] < 6 and rep["resumed_from"] in on_disk,
          f"resumed from {rep['resumed_from']}, certified {on_disk}")
    bit_equal(stitched, "killed and resumed children")
    check(set(stitched) == set(range(steps)),
          f"children recorded steps {sorted(stitched)}")
    diff = first_difference(rep["digest"], sync["digest"])
    check(diff is None, f"resumed child's final state differs at {diff}")
    return launches


# -------------------------------------------- phase 18: train_numerics
# The numerics observatory over resilient_train's cell (full gpt3-125m,
# bf16, 8 x 1024, AdamW 1e-4 fp32 moments, ScanTrainStep(scan_steps=2),
# the step built armed: numerics=True) under ResilientTrainer(numerics=
# True, numerics_interval=2, goodput=True) with a CheckpointManager at
# save_interval 6, 12 steps. After the chunk of steps 6-7 has run, the
# phase writes NaN into NUMERICS_K elements of NUMERICS_LEAF (the first
# rows of the token table), and the nan_loss@6 fault has the trainer read
# step 6's loss as NaN. The chunk must have run clean: had it run on the
# corrupted table, its updates would have spread NaN into every leaf before
# the trainer could look (in JAX too), and no census could name the
# leaf. The blame probe then runs on step 6's batch (the flash forward and
# backward and the LayerNorm kernels, no fused Adam): its census must
# hold exactly NUMERICS_K non-finite elements of that leaf and no other
# parameter; every gradient is non-finite once the loss is, so the
# worst-count culprit is a gradient leaf (grads first, as in JAX), and
# NUMERICS_K is large enough that the parameter ranks among the event's
# four worst leaves, which the train_nonfinite event names in the JAX
# bracket spelling. The trainer rolls back to step 6's certified file and
# finishes. The telemetry the trainer sampled at step 4 must match an
# fp64 recomputation from that step's gradients and its parameters before
# and after the update within NUMERICS_RTOL (bf16 leaves summed in fp32);
# /debug/numerics answers on a MetricsServer. Then chunks armed and not,
# in turns (off, on, on, off): step ms and peak memory of each, the
# probe's ms and the sample read's ms.
NUMERICS = dict(steps=12, interval=2, save_interval=6, fault="nan_loss@6",
                poison_after_step=8, telemetry_step=4, timed_chunks=3)
NUMERICS_LEAF = "gpt.word_embeddings.weight"
NUMERICS_K = 3_000_000        # rows 0..3905 and part of row 3906
NUMERICS_RTOL = 1e-3
# a blame probe's launches: a forward and backward of 12 layers, no Adam
NUMERICS_PROBE_LAUNCHES = {**launches_per_step(12, 0, False)}


def numerics_model():
    """resilient_model's cell with the step built armed, recording each
    chunk, capturing in fp64 the gradients and the parameters before and
    after the update of global step `capture_at`, and corrupting
    NUMERICS_LEAF once after the chunk that ends at `poison_after`."""
    import torch
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ScanTrainStep

    class NumericsStep(ScanTrainStep):
        capture_at = None
        captured = None
        poison_after = None
        poisoned = False
        capturing = False

        def __call__(self, *args):
            t0 = time.perf_counter()
            losses = super().__call__(*args)
            torch.cuda.synchronize()
            self.chunks.append((self._step_count - self.scan_steps,
                                losses.tolist(),
                                (time.perf_counter() - t0) * 1e3))
            if self._step_count == self.poison_after and not self.poisoned:
                self.poisoned = True
                with torch.no_grad():
                    dict(self.model.named_parameters())[
                        NUMERICS_LEAF].view(-1)[:NUMERICS_K] = float("nan")
            return losses

        def _train_step(self, arrays, lr, step=None, telemetry=True):
            self.capturing = step == self.capture_at and telemetry
            return super()._train_step(arrays, lr, step, telemetry)

        def _update(self, grads, lr, do_update):
            if self.capturing:
                g = [x.double() for x in grads]
                old = [p.detach().double() for p in self._params]
            super()._update(grads, lr, do_update)
            if self.capturing:
                new = [p.detach().double() for p in self._params]
                self.captured = (g, old, new)
                self.capturing = False

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    model = GPTForCausalLM.from_preset(RESILIENT["preset"], device="cuda",
                                       dtype="bfloat16", generator=gen)
    model.train()
    opt = AdamW(learning_rate=RESILIENT["lr"], weight_decay=0.01,
                parameters=model.parameters(), moment_dtype="float32")
    step = NumericsStep(model, opt, scan_steps=RESILIENT["scan_steps"],
                        numerics=True)
    step.chunks = []
    step.capture_at = NUMERICS["telemetry_step"]
    step.poison_after = NUMERICS["poison_after_step"]
    return model, opt, step


def fp64_telemetry(names, captured):
    """The telemetry keys' values in fp64 from captured (grads, old, new)
    fp64 tensors in `names` order."""
    import torch
    from paddle_tpu_torch.obs.numerics import telemetry_groups
    groups = telemetry_groups(names)
    g, old, new = captured
    at = {n: i for i, n in enumerate(names)}
    out, tot = {}, {"g": 0.0, "p": 0.0, "w": 0.0, "d": 0.0}
    for grp in sorted(groups):
        idx = [at[n] for n in groups[grp]]
        gs = sum(float(torch.sum(g[i] * g[i])) for i in idx)
        ps = sum(float(torch.sum(new[i] * new[i])) for i in idx)
        ws = sum(float(torch.sum(old[i] * old[i])) for i in idx)
        ds = sum(float(torch.sum((new[i] - old[i]) ** 2)) for i in idx)
        out[f"grad_norm/{grp}"] = math.sqrt(gs)
        out[f"param_norm/{grp}"] = math.sqrt(ps)
        out[f"update_ratio/{grp}"] = math.sqrt(ds) / max(math.sqrt(ws),
                                                         1e-12)
        for k, v in zip("gpwd", (gs, ps, ws, ds)):
            tot[k] += v
    out["grad_norm/_total"] = math.sqrt(tot["g"])
    out["param_norm/_total"] = math.sqrt(tot["p"])
    out["update_ratio/_total"] = math.sqrt(tot["d"]) / max(
        math.sqrt(tot["w"]), 1e-12)
    return out


def phase_train_numerics(device_name, smi_line):
    import shutil
    import tempfile
    import urllib.request
    import torch
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed.resilient import (ResilientConfig,
                                                        ResilientTrainer)
    from paddle_tpu_torch.obs.flight_recorder import (DUMP_DIR_ENV,
                                                      flight_recorder)
    from paddle_tpu_torch.obs.numerics import bracket_path, format_leaf
    from paddle_tpu_torch.obs.prom import MetricsServer
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.utils.fault_injection import FaultPlan

    gc.collect()
    torch.cuda.empty_cache()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="train_numerics_", dir=build)
    model, opt, step = numerics_model()
    ids, labels = resilient_batches(model.config.vocab_size)
    K = step.scan_steps
    n_steps = NUMERICS["steps"]
    check_disk_room(root, model)
    bad = NUMERICS["poison_after_step"] - K
    check(bool((ids[bad] < NUMERICS_K // model.config.hidden_size).any()),
          "train_numerics: step 6's batch reads no corrupted row")

    def get_state():
        return {"model": model.state_dict(), "opt": opt.state_dict(),
                "step": step._step_count}

    def set_state(s):
        model.set_state_dict(s["model"])
        opt.set_state_dict(s["opt"])
        step._step_count = int(s["step"])

    probes = []
    plain_probe = step.nonfinite_blame

    def counted_probe(*a):
        torch.cuda.synchronize()
        before = _kernels.launch_counts()
        rep = plain_probe(*a)
        torch.cuda.synchronize()
        after = _kernels.launch_counts()
        probes.append((rep, {k: after[k] - before[k] for k in after}))
        return rep
    step.nonfinite_blame = counted_probe

    flight_recorder().clear()
    trainer = ResilientTrainer(
        step, CheckpointManager(root, max_to_keep=2),
        get_state=get_state, set_state=set_state,
        config=ResilientConfig(save_interval=NUMERICS["save_interval"]),
        fault_plan=FaultPlan.from_spec(NUMERICS["fault"]), goodput=True,
        numerics=True, numerics_interval=NUMERICS["interval"])
    # the blame's black-box dump goes beside the checkpoints
    dump_dir = os.environ.get(DUMP_DIR_ENV)
    os.environ[DUMP_DIR_ENV] = root
    _kernels.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        summary = trainer.run(
            lambda i: (ids[i:i + K], labels[i:i + K]), num_steps=n_steps)
        run_s = time.perf_counter() - t0
        launches = _kernels.launch_counts()
    finally:
        if dump_dir is None:
            os.environ.pop(DUMP_DIR_ENV, None)
        else:
            os.environ[DUMP_DIR_ENV] = dump_dir
        shutil.rmtree(root, ignore_errors=True)
    events = [(e["kind"], e["step"]) for e in summary["events"]]
    check(summary["completed_steps"] == n_steps
          and events == [("bad_loss", bad), ("rollback", bad)],
          f"train_numerics: events {events}")
    check(bool(torch.isfinite(dict(model.named_parameters())[
        NUMERICS_LEAF]).all()), "train_numerics: the rollback left NaN")
    steps_run = sum(len(c[1]) for c in step.chunks)
    check(steps_run == n_steps + K,
          f"train_numerics: ran {steps_run} steps, want {n_steps} and one "
          "replayed chunk")
    check(len(probes) == 1, f"train_numerics: {len(probes)} probes ran")
    report, probe_launches = probes[0]
    check(report["params"] == {NUMERICS_LEAF: NUMERICS_K}
          and len(report["grads"]) > 1 and math.isnan(report["loss"]),
          f"train_numerics: probe census params {report['params']}, "
          f"{len(report['grads'])} grad leaves, loss {report['loss']}")
    want_probe = {k: NUMERICS_PROBE_LAUNCHES.get(k, 0) for k in
                  RESILIENT_KERNELS_PER_STEP}
    got_probe = {k: probe_launches[k] for k in want_probe}
    check(got_probe == want_probe,
          f"train_numerics: the probe launched {got_probe}, want "
          f"{want_probe}")
    want_launches = {k: v * steps_run + want_probe[k]
                     for k, v in RESILIENT_KERNELS_PER_STEP.items()}
    check({k: launches[k] for k in want_launches} == want_launches,
          f"train_numerics: launched {launches}, want {want_launches}")
    nfe = [e for e in flight_recorder().snapshot()["events"]
           if e["kind"] == "train_nonfinite"]
    leaf_line = format_leaf(NUMERICS_LEAF, "param", NUMERICS_K,
                            report["sizes"][NUMERICS_LEAF])
    check(len(nfe) == 1 and nfe[0]["step"] == bad
          and nfe[0]["param_leaves"] == 1
          and nfe[0]["param_nonfinite"] == NUMERICS_K
          and leaf_line in nfe[0]["leaves"].split("; ")
          and leaf_line.startswith(bracket_path(NUMERICS_LEAF)),
          f"train_numerics: train_nonfinite events {nfe}, want {leaf_line}")

    # the sampled telemetry of step 4 against fp64 from its tensors
    snap = trainer.numerics.snapshot()
    sampled = {h["step"]: h for h in snap["history"]}
    check(sorted(sampled) == list(range(2, n_steps + 1, 2)),
          f"train_numerics: sampled steps {sorted(sampled)}")
    check(step.captured is not None, "train_numerics: no step captured")
    ref = fp64_telemetry(step._names, step.captured)
    got = sampled[NUMERICS["telemetry_step"]]
    worst = max(abs(got[k] - v) / abs(v) for k, v in ref.items() if v)
    check(set(ref) <= set(got) and worst <= NUMERICS_RTOL,
          f"train_numerics: telemetry off fp64 by {worst} (rtol "
          f"{NUMERICS_RTOL}): {got} vs {ref}")
    step.captured = None

    server = MetricsServer([trainer.metrics.render]).start()
    try:
        url = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(url + "/debug/numerics",
                                    timeout=30) as r:
            doc = json.loads(r.read())
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            text = r.read().decode()
    finally:
        server.stop()
    check(doc.get("armed") is True and doc["nonfinite_events"] == 1
          and doc["last_sample_step"] == n_steps,
          f"train_numerics: /debug/numerics {doc}")
    check("pdtpu_train_numerics_grad_norm{group=" in text
          and "pdtpu_train_numerics_nonfinite_events_total 1" in text,
          "train_numerics: /metrics lacks the numerics families")

    # armed against not: chunks in turns, each with its peak memory
    timing = {False: [], True: []}
    peaks = {False: [], True: []}
    chunk = 0
    for armed in (False, True, True, False):
        step.numerics_armed = armed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(NUMERICS["timed_chunks"]):
            i = (chunk * K) % RESILIENT_BATCHES
            chunk += 1
            t0 = time.perf_counter()
            step(ids[i:i + K], labels[i:i + K])
            ms.append((time.perf_counter() - t0) * 1e3 / K)
        timing[armed].append(statistics.median(ms))
        peaks[armed].append(torch.cuda.max_memory_allocated() / 2**30)
    step.numerics_armed = True
    torch.cuda.synchronize()
    read_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        sample = step.numerics_host_sample()
        read_ms.append((time.perf_counter() - t0) * 1e3)
    check(all(math.isfinite(v) for v in sample.values()),
          f"train_numerics: a non-finite sample {sample}")
    emit({"phase": "train_numerics", "card": smi_line,
          "model": RESILIENT["preset"], "dtype": "bfloat16",
          "batch": list(RESILIENT["batch"]), "scan_steps": K,
          "steps": n_steps, "interval": NUMERICS["interval"],
          "fault": NUMERICS["fault"], "leaf": NUMERICS_LEAF,
          "k": NUMERICS_K, "events": events,
          "culprit": nfe[0]["culprit"], "leaves": nfe[0]["leaves"],
          "grad_leaves_nonfinite": len(report["grads"]),
          "probe_ms": report["probe_seconds"] * 1e3,
          "probe_launches": got_probe,
          "telemetry_step": NUMERICS["telemetry_step"],
          "telemetry_max_rel_err_vs_fp64": worst,
          "telemetry_rtol": NUMERICS_RTOL,
          "telemetry_groups": sorted({k.split("/")[1] for k in ref}),
          "step_ms": {"not_armed": timing[False], "armed": timing[True],
                      "order": "off, on, on, off"},
          "armed_added_ms": (statistics.mean(timing[True])
                             - statistics.mean(timing[False])),
          "peak_mem_gib": {"not_armed": peaks[False], "armed": peaks[True]},
          "sample_read_ms": statistics.median(read_ms),
          "run_s": run_s, "goodput": summary["goodput"]["goodput"],
          "rollback_waste_s":
              summary["goodput"]["phase_seconds"]["rollback_waste"],
          "kernel_launches": launches})
    del model, opt, step, trainer, ids, labels
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------ phases 19-20: multi-LoRA at one GPU
# lora_finetune: full gpt3-1.3b in bf16 (the train cell's model, seed and
# batch) with inject_lora(LoRAConfig(rank 8, alpha 16)) on GPT's four
# sites: every base parameter frozen, LORA_LEAVES fp32 adapter leaves
# (6,291,456 parameters) trained by AdamW (lr LORA_LR, wd 0.01, fp32
# moments, global-norm clip 1.0) through ScanTrainStep over the train
# cell's 4 x 1024 batch repeated: a warm-up chunk, a timed chunk with the
# launch counts zeroed just before and read just after, then a chunk
# with the numerics telemetry armed. Every base parameter must be
# bit-equal after; the adapter tree is published as a certified
# AdapterWeightSet for lora_serve. MFU counts 4 N_base + 6 N_lora FLOPs a
# token: the frozen base runs its forward (2 N) and the backward to its
# inputs (2 N) but no weight gradient; the adapters run all three.
LORA_RANK = 8
LORA_ALPHA = 16.0
LORA_LR = 1e-3
LORA_WARMUP_STEPS = 2
LORA_TIMED_STEPS = 6
LORA_NUMERICS_STEPS = 2
LORA_LEAVES = 192          # 24 layers x 4 sites x (A, B)
# launches a step: the train cell's flash and LayerNorm forwards and
# backwards, but layer 0's first LayerNorm has no backward (its input,
# the frozen embeddings, and its own weight and bias need no gradient, so
# autograd never reaches it), and fused Adam once a LoRA leaf
LORA_KERNELS_PER_STEP = {**launches_per_step(24, LORA_LEAVES, False),
                         "layernorm_bwd": 48}
# lora_serve: serve's model and 16 prompts behind LLMEngine(SERVE_ENGINE,
# max_adapters=3, lora_rank=8, lora_alpha default (16)): request i rides
# LORA_ROUTE[i % 4], so 4 base streams and 4 on each synthetic adapter.
# The adapters' factors are N(0, LORA_SIGMA^2): at width 2048 a site's
# delta is then ~ alpha/r * sigma^2 * sqrt(in * r) * sqrt(r) ~ 0.1 of
# the base projection's output (xavier weights, LayerNorm'd inputs), so
# every adapter moves greedy tokens while all logits stay finite
# (tests/test_lora.py's 0.3 is for gpt2-tiny's width 128).
LORA_SIGMA = 0.02
LORA_ROUTE = (None, "ad1", "ad2", "ad3")
LORA_SERVE_ENGINE = dict(SERVE_ENGINE, max_adapters=3, lora_rank=LORA_RANK)
LORA_CHURN_NEW = 8         # new tokens a request of the churned burst
# the churn's kernel check: profiled replays a side of the armed burst's
# first steps, each name taken at its most launches over them (a replay of
# one state lost a record in 1 of ~12,000 in a test run: an int add's, its
# ATen op counted every time; in other runs one replay lost a record of
# each of 17 names, and records of a step's first kernels went missing in
# every replay of one side, which step_kernels' discarded warm-up cycle
# now absorbs)
LORA_CHURN_REPLAYS = 4
LORA_CHURN_REPLAY_STEPS = 1    # was 2: room for frontend_serve


def lora_tree(model, seed, rank=LORA_RANK, sigma=LORA_SIGMA):
    """A synthetic adapter for `model` in the bank's canonical layout
    (`tuning.lora.synthetic_adapter_tree`, the CPU tests' draw too)."""
    from paddle_tpu_torch.tuning import target_sites
    from paddle_tpu_torch.tuning.lora import synthetic_adapter_tree
    return synthetic_adapter_tree(target_sites(model)[0], seed, rank, sigma)


def lora_dir():
    """The adapter sets' directory, beside the kernel build on the
    checkout's disk (build/ is not committed)."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "lora_adapters")
    os.makedirs(d, exist_ok=True)
    return d


def phase_lora_finetune(device_name, train=None):
    """Phase 19 (see the comment above LORA_RANK). `train`: the train
    phase's readings, reported beside this one's. Returns (launch counts
    of the timed chunk, the published AdapterWeightSet)."""
    import torch
    from paddle_tpu_torch.checkpoint import AdapterWeightSet
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.obs.flops import peak_flops
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ScanTrainStep
    from paddle_tpu_torch.tuning import (LoRAConfig, adapter_signature,
                                         adapter_state_dict, inject_lora,
                                         lora_parameters)

    gc.collect()
    torch.cuda.empty_cache()
    model, opt, ids, labels, init_s = train_workload("train")
    del opt                 # the cell's full-model optimizer: not used
    B, S = TRAIN_CELLS["train"]["batch"]
    n_base = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 19)
    inject_lora(model, LoRAConfig(rank=LORA_RANK, alpha=LORA_ALPHA),
                generator=gen)
    params = lora_parameters(model)
    n_lora = sum(p.numel() for p in params)
    trainable = [k for k, p in model.named_parameters() if p.requires_grad]
    frozen = {k: p.detach().clone() for k, p in model.named_parameters()
              if not p.requires_grad}
    opt = AdamW(learning_rate=LORA_LR, weight_decay=0.01, parameters=params,
                moment_dtype="float32", grad_clip=ClipGradByGlobalNorm(1.0))
    warm = ScanTrainStep(model, opt, scan_steps=LORA_WARMUP_STEPS)
    warm_losses, warm_s, _, _ = timed_chunk(warm, ids, labels)
    step = ScanTrainStep(model, opt, scan_steps=LORA_TIMED_STEPS)
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    losses, wall, step_ms, _ = timed_chunk(step, ids, labels)
    launches = _kernels.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    armed = ScanTrainStep(model, opt, scan_steps=LORA_NUMERICS_STEPS,
                          numerics=True)
    armed_losses, _, armed_ms, _ = timed_chunk(armed, ids, labels)
    sample = armed.numerics_host_sample()
    named = dict(model.named_parameters())
    moved_base = [k for k, t in frozen.items() if not torch.equal(named[k], t)]
    lora_ids = {id(p) for p in params}
    state_leaves = [p for p in opt.state if id(p) in lora_ids]
    per_step = {k: launches[k] / LORA_TIMED_STEPS
                for k in LORA_KERNELS_PER_STEP}
    all_losses = (warm_losses.tolist() + losses.tolist()
                  + armed_losses.tolist())
    step_s = wall / LORA_TIMED_STEPS
    flops = (4 * n_base + 6 * n_lora) * B * S
    tree = adapter_state_dict(model)
    sig = adapter_signature(model, LORA_RANK)
    t0 = time.perf_counter()
    ws = AdapterWeightSet.publish(lora_dir(), "lora-ft-v1", tree, sig)
    publish_s = time.perf_counter() - t0
    result = {
        "phase": "lora_finetune", "model": "gpt3-1.3b", "dtype": "bfloat16",
        "batch": B, "seq": S, "lora": dict(rank=LORA_RANK, alpha=LORA_ALPHA,
                                           sites=list(sig["targets"])),
        "optimizer": f"AdamW lr {LORA_LR} wd 0.01 fp32 moments, global-norm "
                     "clip 1.0, over the LoRA leaves",
        "n_base_params": n_base, "n_lora_params": n_lora,
        "trainable_leaves": len(trainable), "frozen_leaves": len(frozen),
        "optimizer_state_leaves": len(opt.state),
        "warmup_steps": LORA_WARMUP_STEPS, "warmup_s": warm_s,
        "timed_steps": LORA_TIMED_STEPS, "wall_s": wall,
        "tokens_per_s": B * S * LORA_TIMED_STEPS / wall,
        "step_ms_mean": step_s * 1e3,
        "step_ms_median": statistics.median(step_ms),
        "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
        "mfu": flops / step_s / peak_flops(device_name),
        "mfu_formula": "(4 N_base + 6 N_lora) B S / step / peak",
        "flops_per_step": flops, "peak_mem_gib": peak_gib,
        "train": train, "losses": all_losses,
        "numerics_step_ms": armed_ms, "numerics_sample": sample,
        "kernel_launches": launches, "launches_per_step": per_step,
        "base_leaves_moved": moved_base, "model_init_s": init_s,
        "published": dict(version=ws.version, seconds=publish_s,
                          bytes=os.path.getsize(ws.data_path))}
    emit(result)
    check(len(trainable) == LORA_LEAVES and n_lora == 6291456,
          f"lora_finetune: {len(trainable)} trainable leaves of {n_lora} "
          f"parameters, want {LORA_LEAVES} of 6291456")
    check(all(math.isfinite(x) for x in all_losses), "non-finite loss")
    check(all_losses[-1] < all_losses[0],
          f"lora_finetune: loss did not fall: {all_losses}")
    check(not moved_base, f"lora_finetune: base leaves moved: {moved_base}")
    check(per_step == {k: float(v) for k, v in LORA_KERNELS_PER_STEP.items()},
          f"lora_finetune: launches per step {per_step}, want "
          f"{LORA_KERNELS_PER_STEP}")
    check(len(opt.state) == LORA_LEAVES == len(state_leaves),
          f"lora_finetune: optimizer state for {len(opt.state)} leaves, "
          f"{len(state_leaves)} of them LoRA leaves")
    check(sample is not None and all(math.isfinite(v)
                                     for v in sample.values()),
          f"lora_finetune: numerics telemetry {sample}")
    check(train is None or peak_gib < train["peak_mem_gib"],
          f"lora_finetune: peak {peak_gib} GiB is not below train's")
    del model, opt, warm, step, armed, frozen, named, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, ws


def op_counter():
    """A TorchDispatchMode counting the ATen ops run under it (`.n`): a
    step's host-side op count, which a churned adapter bank must not
    change."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCounter(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))
    return OpCounter()


def settle(engine, dec0=0, timeout_s=30.0):
    """Wait until the started engine's metrics hold every decode step it
    committed since `dec0` (its decode_iterations when they were made): a
    stream's future resolves inside its last step's commit, a moment
    before that step is booked."""
    t0 = time.perf_counter()
    while (engine.metrics.counters["decode_steps"]
           < engine.decode_iterations - dec0):
        check(time.perf_counter() - t0 < timeout_s,
              "the engine's last decode step was never booked")
        time.sleep(0.001)


def lora_burst(engine, prompts, route, max_new=SERVE_NEW_TOKENS):
    """Submit every prompt to the started, settled engine at once, request
    i on adapter route[i % len(route)], with fresh metrics, and wait for
    every stream and its booking. Returns (outs, wall_s, steps, metrics
    snapshot)."""
    from paddle_tpu_torch.serving.metrics import LLMMetrics
    engine.metrics = LLMMetrics()
    engine.metrics.set_slots(0, engine.pool.num_slots)
    steps0, dec0 = engine.steps, engine.decode_iterations
    t0 = time.perf_counter()
    handles = [engine.submit(p, max_new_tokens=max_new,
                             adapter=route[i % len(route)])
               for i, p in enumerate(prompts)]
    outs = [h.result(timeout=900) for h in handles]
    wall = time.perf_counter() - t0
    settle(engine, dec0)
    return outs, wall, engine.steps - steps0, engine.metrics.snapshot()


def is_copy(name):
    """A profiler device event that is a copy or a fill, not a kernel."""
    return name.startswith(("Memcpy", "Memset"))


def step_kernels(engine, recorded, n_steps=SERVE_BUSY_STEPS):
    """(device-busy ms, kernel launches, ATen ops, {device event name:
    launches}) of one of `engine`'s unified steps: the first `n_steps`
    recorded (toks, pos, adv) replayed under torch.profiler (busy and
    launches None when it recorded no kernel; launches and the names'
    counts a step, copies and fills included, see is_copy), and the first
    one once more under op_counter(). The profiler traces a warm-up
    replay first and discards it (its schedule's warmup cycle): records of
    the first launches after the trace starts can be lost (ROADMAP §3 item
    5), and those are the steps' first kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    picks = recorded[:n_steps]
    for a in picks:                               # warm, outside the trace
        engine._step_logits(engine._step_args(*a))
    torch.cuda.synchronize()
    cycles = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: cycles.append(p.key_averages())
                 ) as prof:
        for _ in range(2):                        # the warmup, the active
            for a in picks:
                engine._step_logits(engine._step_args(*a))
            torch.cuda.synchronize()
            prof.step()
    evs = [e for e in cycles[0] if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in evs)
    count = sum(e.count for e in evs)
    with op_counter() as c:
        engine._step_logits(engine._step_args(*picks[0]))
    torch.cuda.synchronize()
    n = len(picks)
    return ((busy_us / 1e3 / n if busy_us > 0 else None),
            (count / n if count else None), c.n,
            {e.key: e.count / n for e in evs})


def most_launches(maps):
    """{kernel name: the most launches any of several step_kernels name
    maps saw}, copies and fills left out: the profiler loses a kernel's
    record now and then (ROADMAP §3 item 5), but never adds one."""
    return {k: max(m.get(k, 0) for m in maps)
            for k in set().union(*maps) if not is_copy(k)}


def name_diff(a, b):
    """{name: [count in a, count in b]} of the names whose counts differ
    between two step_kernels name maps."""
    return {k: [a.get(k, 0), b.get(k, 0)] for k in sorted(set(a) | set(b))
            if a.get(k, 0) != b.get(k, 0)}


class SlotOpRecorder:
    """The rows of watched requests in every leaf module's output, and in
    every LoRA delta's sum, step by step, on an engine the caller pumps.
    `watch` maps id(handle) to a key; each step the engine runs, a key
    whose request is in it gets a new list of (op name, its rows: the
    slot's first adv columns)."""

    def __init__(self, engine):
        import paddle_tpu_torch.models.gpt as gpt
        self.engine, self.watch, self.ops = engine, {}, {}
        self._rows, self._last, self._gpt = {}, None, gpt
        self._hooks = [m.register_forward_hook(self._hook(name))
                       for name, m in engine.model.named_modules()
                       if not list(m.children())]
        self._add = gpt.add_lora_delta
        gpt.add_lora_delta = self._lora
        inner = engine._step_logits

        def step(a):
            self._rows = {}
            for slot, req in engine._active.items():
                key = self.watch.get(id(req.handle))
                if key is not None and a.adv[slot] > 0:
                    self._rows[key] = (slot, int(a.adv[slot]))
                    self.ops.setdefault(key, []).append([])
            return inner(a)
        engine._step_logits = step

    def _take(self, name, out):
        import torch
        if not torch.is_tensor(out) or out.ndim < 2:
            return
        N, C = self.engine.pool.num_slots, self.engine.config.prefill_chunk
        if out.shape[0] != N:
            return
        for key, (slot, adv) in self._rows.items():
            rows = out[slot, :adv] if out.ndim > 2 and out.shape[1] == C \
                else out[slot]
            self.ops[key][-1].append((name, rows.detach().clone()))

    def _hook(self, name):
        def record(_mod, _args, out):
            self._last = name
            self._take(name, out)
        return record

    def _lora(self, y, x, entry, idx, scale):
        out = self._add(y, x, entry, idx, scale)
        if entry is not None:
            self._take(f"{self._last} + lora delta", out)
        return out

    def remove(self):
        for h in self._hooks:
            h.remove()
        self._gpt.add_lora_delta = self._add
        del self.engine._step_logits


def first_differing_op(a, b):
    """The first op, in execution order, whose rows differ between two
    SlotOpRecorder records of one request (lists of steps), or None when
    every op of every step is bit-equal."""
    import torch
    if len(a) != len(b):
        return dict(op=None, what=f"{len(a)} steps against {len(b)}")
    for k, (sa, sb) in enumerate(zip(a, b)):
        names = ([n for n, _ in sa], [n for n, _ in sb])
        if names[0] != names[1]:
            return dict(step=k, op=None, what="the steps ran other ops")
        for (name, x), (_, y) in zip(sa, sb):
            if x.shape != y.shape or not torch.equal(x, y):
                d = (None if x.shape != y.shape else
                     float((x.float() - y.float()).abs().max()))
                return dict(step=k, rows=int(x.shape[0]), op=name,
                            shapes=[list(x.shape), list(y.shape)],
                            max_abs_diff=d)
    return None


def _armed_engine(model, trees):
    """A fresh armed lora_serve engine (not started) with `trees`
    registered in order, so in the burst engine's rows."""
    from paddle_tpu_torch.serving.llm import LLMEngine, LLMEngineConfig
    eng = LLMEngine(model, LLMEngineConfig(**LORA_SERVE_ENGINE))
    for aid, tree in trees.items():
        eng.register_adapter(aid, tree)
    return eng


def _pumped_ops(model, trees, prompts, picks, solo):
    """{adapter: SlotOpRecorder record} of the requests `picks` ({adapter:
    request index}) on a fresh armed engine: each alone (`solo`) or inside
    the whole burst, pumped to its end."""
    eng = _armed_engine(model, trees)
    rec = SlotOpRecorder(eng)
    try:
        batches = ([[i] for i in picks.values()] if solo
                   else [list(range(len(prompts)))])
        for batch in batches:
            hs = {i: eng.submit(prompts[i], max_new_tokens=SERVE_NEW_TOKENS,
                                adapter=LORA_ROUTE[i % 4]) for i in batch}
            rec.watch = {id(hs[i]): aid for aid, i in picks.items()
                         if i in hs}
            while eng.has_work():
                eng.pump()
    finally:
        rec.remove()
    return rec.ops


def solo_decodes(model, trees, prompts, burst_outs):
    """Each adapter's first stream of the burst (request i on
    LORA_ROUTE[i % 4]) decoded solo, one request at a time on a fresh
    armed engine with the adapters in the burst engine's rows: {adapter:
    reading}, whether it equals the started burst's stream (`burst_outs`)
    and, where it does not, the first op whose rows differ between its
    solo run and the burst pumped on another fresh armed engine (both
    recorded by a SlotOpRecorder)."""
    import numpy as np
    import torch
    first = {aid: min(i for i in range(len(prompts))
                      if LORA_ROUTE[i % 4] == aid) for aid in trees}
    eng = _armed_engine(model, trees)
    out = {}
    for aid, i in first.items():
        h = eng.submit(prompts[i], max_new_tokens=SERVE_NEW_TOKENS,
                       adapter=aid)
        while eng.has_work():
            eng.pump()
        out[aid] = dict(request=i, solo_equal_burst=bool(
            np.array_equal(h.result(0), burst_outs[i])),
            first_differing_op=None)
    del eng
    differ = {aid: i for aid, i in first.items()
              if not out[aid]["solo_equal_burst"]}
    if differ:
        solo = _pumped_ops(model, trees, prompts, differ, solo=True)
        burst = _pumped_ops(model, trees, prompts, differ, solo=False)
        for aid in differ:
            out[aid]["first_differing_op"] = first_differing_op(
                solo.get(aid, []), burst.get(aid, []))
        del solo, burst
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def phase_lora_serve(serve, finetuned=None):
    """Phase 20 (see the comment above LORA_SIGMA): serve's model and
    prompts unarmed and armed in turns (unarmed, armed, armed, unarmed);
    the armed burst's base streams equal serve's, its adapter streams move
    tokens, a bank with its rows permuted gives the same 16 streams bit
    for bit; the LoRA ops' device ms and launches a step beside the
    unarmed step's; a hot swap and an unload leave a step's ops and its
    kernels by name unchanged; each adapter's first stream decoded solo
    against the burst (solo_decodes); the fine-tuned adapter certified,
    registered and decoded, a rank-16 one refused; the prefix namespaces,
    the scoped flush, the canary and the ledger on a third engine. `serve`: the serve phase's
    record; `finetuned`: lora_finetune's AdapterWeightSet. Returns the
    launch counts of the first armed burst."""
    import numpy as np
    import torch
    from paddle_tpu_torch.checkpoint import (AdapterWeightSet,
                                             UncertifiedWeightsError)
    from paddle_tpu_torch.obs.flops import (decode_flops_per_token,
                                            lora_decode_flops_per_token)
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.serving.llm import (AdapterError, LLMEngine,
                                              LLMEngineConfig)
    from paddle_tpu_torch.tuning import adapter_signature, target_sites

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    model, init_s = serve_model("serve")
    prompts = serve_prompts(model.config.vocab_size)
    trees = {f"ad{i}": lora_tree(model, SEED + 30 + i) for i in (1, 2, 3)}
    plain = LLMEngine(model, LLMEngineConfig(**SERVE_ENGINE))
    armed = LLMEngine(model, LLMEngineConfig(**LORA_SERVE_ENGINE))
    for aid, tree in trees.items():
        armed.register_adapter(aid, tree)
    recorded = {}
    for name, eng in (("plain", plain), ("armed", armed)):
        inner = eng._step_logits
        rec = recorded[name] = []

        def recording(a, inner=inner, rec=rec):
            rec.append((a.toks.copy(), a.pos.copy(), a.adv.copy()))
            return inner(a)
        eng._step_logits = recording
        eng.start()
        serve_warm_up(eng, prompts)
        settle(eng)
    parts = {"build_and_warm": time.perf_counter() - t_phase}
    turns = []
    try:
        for name, eng in (("plain", plain), ("armed", armed),
                          ("armed", armed), ("plain", plain)):
            route = LORA_ROUTE if name == "armed" else (None,)
            recorded[name].clear()
            _kernels.reset_launch_counts()
            outs, wall, steps, snap = lora_burst(eng, prompts, route)
            turns.append(dict(engine=name, outs=outs, wall_s=wall,
                              steps=steps, snap=snap,
                              launches=_kernels.launch_counts(),
                              recorded=list(recorded[name])))
        for eng in (plain, armed):
            del eng._step_logits
        parts["turns"] = time.perf_counter() - t_phase - sum(parts.values())
        # the step's cost: device ms, kernels and ops of the same recorded
        # steps on each idle engine (armed: every slot back on row 0,
        # which costs what any row does)
        busy_plain, kern_plain, ops_plain, _ = step_kernels(
            plain, turns[0]["recorded"])
        busy_armed, kern_armed, ops_armed, _ = step_kernels(
            armed, turns[1]["recorded"])
        parts["profile"] = time.perf_counter() - t_phase - sum(parts.values())
        # churn: a short burst with every step's ops counted under
        # op_counter(), a hot swap and an unload, the same burst again;
        # the device events of LORA_CHURN_REPLAYS profiled replays of
        # the burst's first steps, by name, just before and just after
        def replays():
            return [step_kernels(armed, turns[1]["recorded"],
                                 LORA_CHURN_REPLAY_STEPS)[3]
                    for _ in range(LORA_CHURN_REPLAYS)]
        names_before = replays()
        counts = {}

        def counted(a, inner=armed._step_logits):
            with op_counter() as c:
                out = inner(a)
            counts[phase].append(c.n)
            return out

        armed._step_logits = counted
        for phase in ("before_churn", "after_churn"):
            counts[phase] = []
            lora_burst(armed, prompts[:8], ("ad2", "ad1", None),
                       LORA_CHURN_NEW)
            if phase == "before_churn":
                armed.register_adapter("ad1", lora_tree(model, SEED + 39))
                armed.unregister_adapter("ad3")
        del armed._step_logits
        names_after = replays()
        parts["churn"] = time.perf_counter() - t_phase - sum(parts.values())
    finally:
        plain.stop(drain=True, timeout=60)
        armed.stop(drain=True, timeout=60)
    a1 = turns[1]
    launches = a1["launches"]
    base_idx = [i for i in range(len(prompts))
                if LORA_ROUTE[i % 4] is None]
    base_equal = [bool(np.array_equal(a1["outs"][i], serve["streams"][i]))
                  for i in base_idx]
    moved = {aid: sum(int(not np.array_equal(a1["outs"][i],
                                             serve["streams"][i]))
                      for i in range(len(prompts))
                      if LORA_ROUTE[i % 4] == aid)
             for aid in trees}
    turns_equal = all(np.array_equal(a, b) for a, b in
                      zip(turns[1]["outs"], turns[2]["outs"]))
    plain_equal = all(np.array_equal(a, serve["streams"][i]) for t in
                      (turns[0], turns[3]) for i, a in enumerate(t["outs"]))
    tokens = a1["snap"]["adapter_tokens"]
    partition = (sum(tokens.values()), a1["snap"]["tokens_out"]
                 + a1["snap"]["prefills"])
    kernels_churn = [most_launches(m) for m in (names_before, names_after)]
    churn_events = dict(
        replayed_steps=LORA_CHURN_REPLAY_STEPS,
        replays_a_side=LORA_CHURN_REPLAYS,
        # the profiler's own drift: replays of one state, nothing between
        within_before=name_diff(*names_before[:2]),
        within_after=name_diff(*names_after[:2]),
        before_vs_after=name_diff(*kernels_churn),
        kernels_a_step=[sum(m.values()) for m in kernels_churn],
        copies_a_step=[[sum(v for k, v in m.items() if is_copy(k))
                        for m in side] for side in (names_before,
                                                    names_after)])

    # the bank's rows permuted: the same streams bit for bit; then the
    # fine-tune's adapter certified against this bank, registered in the
    # row ad3 leaves and one stream decoded through it, and a rank-16
    # tree and its signature refused, typed
    perm = LLMEngine(model, LLMEngineConfig(**LORA_SERVE_ENGINE))
    for aid in ("ad3", "ad1", "ad2"):
        perm.register_adapter(aid, trees[aid])
    rows = {aid: perm.adapter_bank.row_of(aid) for aid in trees}
    ft = {}
    perm.start()
    try:
        serve_warm_up(perm, prompts)
        settle(perm)
        p_outs, p_wall, _, _ = lora_burst(perm, prompts, LORA_ROUTE)
        if finetuned is not None:
            sig = perm.adapter_bank.signature
            manifest = finetuned.certify_for(sig)
            tree = finetuned.load(device="cpu")
            tree = {li: {s: {f: np.asarray(v, np.float32)
                             for f, v in e.items()}
                         for s, e in layer.items()}
                    for li, layer in tree.items()}
            perm.unregister_adapter("ad3")
            perm.register_adapter("lora-ft", tree)
            out = perm.submit(prompts[0], max_new_tokens=SERVE_NEW_TOKENS,
                              adapter="lora-ft").result(300)
            ft = dict(version=manifest["version"],
                      format=manifest["format"], tokens=int(len(out)),
                      tokens_equal_base=int(
                          (out == serve["streams"][0]).sum()))
            r16 = lora_tree(model, SEED + 40, rank=16)
            try:
                perm.register_adapter("r16", r16)
                ft["rank16_register"] = "accepted"
            except AdapterError as e:
                ft["rank16_register"] = e.reason
            ws16 = AdapterWeightSet.publish(lora_dir(), "rank16", r16,
                                            adapter_signature(model, 16))
            try:
                ws16.certify_for(sig)
                ft["rank16_certify"] = "accepted"
            except UncertifiedWeightsError as e:
                ft["rank16_certify"] = e.reason
    finally:
        perm.stop(drain=True, timeout=60)
    perm_equal = all(np.array_equal(a, b) for a, b in zip(p_outs, a1["outs"]))
    del perm
    parts["permuted_and_finetuned"] = (time.perf_counter() - t_phase
                                       - sum(parts.values()))
    # each adapter's first stream decoded solo, against the burst
    solo = solo_decodes(model, trees, prompts, a1["outs"])
    parts["solo"] = time.perf_counter() - t_phase - sum(parts.values())

    # namespaces, the scoped flush, the canary and the ledger: a third
    # engine with the prefix cache and the economics ledger on
    ns = LLMEngine(model, LLMEngineConfig(**dict(
        LORA_SERVE_ENGINE, enable_prefix_cache=True, economics=True)))
    for aid in ("ad1", "ad2"):
        ns.register_adapter(aid, trees[aid])
    shared = prompts[1][:64]                # 8 full blocks of 8
    ns.start()
    try:
        for ad in (None, "ad1", "ad2"):
            ns.submit(shared, max_new_tokens=4, adapter=ad).result(300)
        probe0 = [ns.prefix_probe(shared, adapter=a)
                  for a in (None, "ad1", "ad2", "other")]
        ns.register_adapter("ad1", trees["ad3"])      # hot swap
        probe1 = [ns.prefix_probe(shared, adapter=a)
                  for a in (None, "ad1", "ad2", "other")]
        led = ns.ledger.snapshot()
    finally:
        ns.stop(drain=True, timeout=60)
    canary, finite = ns.canary_probe(prompts[2][:32], 4, adapter="ad2")
    ad_s = sum(v["device_seconds"] for v in led["adapters"].values())
    ten_s = sum(v["device_seconds"] for v in led["tenants"].values())
    ad_tok = sum(v["tokens"] for v in led["adapters"].values())
    ten_tok = sum(v["tokens"] for v in led["tenants"].values())
    del ns
    parts["namespaces"] = time.perf_counter() - t_phase - sum(parts.values())

    sites, _ = target_sites(model)
    n_params = sum(p.numel() for p in model.parameters())
    lora_flops = lora_decode_flops_per_token(
        LORA_RANK, [io for layer in sites for io in layer.values()])
    base_flops = decode_flops_per_token(n_params)
    gen_tokens = sum(len(o) for o in a1["outs"])
    readings = [dict(engine=t["engine"], wall_s=t["wall_s"],
                     steps=t["steps"],
                     generated_tok_s=sum(len(o) for o in t["outs"])
                     / t["wall_s"],
                     decode_step_p50_ms=t["snap"]["intertoken_p50_ms"],
                     ttft_p50_ms=t["snap"]["ttft_p50_ms"])
                for t in turns]
    result = {
        "phase": "lora_serve", "model": "gpt3-1.3b", "dtype": "bfloat16",
        "engine": {k: v for k, v in LORA_SERVE_ENGINE.items()},
        "lora_alpha": armed.adapter_bank.default_alpha,
        "adapter_sigma": LORA_SIGMA, "route": list(map(str, LORA_ROUTE)),
        "requests": len(prompts), "generated_tokens": gen_tokens,
        "turns": readings,
        "serve_reference": {k: serve[k] for k in (
            "generated_tok_s", "ttft_p50_ms", "decode_step_p50_ms")},
        "base_streams_equal_serve": base_equal,
        "unarmed_streams_equal_serve": plain_equal,
        "armed_turns_equal": turns_equal,
        "adapter_streams_moved": moved,
        "permuted_rows": rows, "permuted_streams_equal": perm_equal,
        "permuted_wall_s": p_wall,
        "adapter_tokens": tokens, "emitted_tokens": partition[1],
        "step_device_busy_ms": {"unarmed": busy_plain, "armed": busy_armed},
        "lora_device_ms_a_step": (None if None in (busy_plain, busy_armed)
                                  else busy_armed - busy_plain),
        "step_kernel_launches": {"unarmed": kern_plain, "armed": kern_armed},
        "step_aten_ops": {"unarmed": ops_plain, "armed": ops_armed,
                          "bursts": {k: sorted(set(v))
                                     for k, v in counts.items()}},
        "churn_device_events": churn_events,
        "solo_decodes": solo,
        "lora_decode_flops_per_token": lora_flops,
        "decode_flops_per_token": base_flops,
        "lora_flops_share": lora_flops / base_flops,
        "finetuned": ft,
        "prefix_probe_before_swap": probe0, "prefix_probe_after_swap":
            probe1,
        "canary": dict(tokens=canary.tolist(), finite=finite),
        "ledger_adapter_seconds": ad_s, "ledger_tenant_seconds": ten_s,
        "ledger_adapter_tokens": ad_tok, "ledger_tenant_tokens": ten_tok,
        "kernel_launches": launches, "model_init_s": init_s,
        "seconds": parts,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    emit(result)
    check(all(base_equal), f"lora_serve: base streams differ from serve's: "
          f"{base_equal}")
    check(plain_equal, "lora_serve: an unarmed turn differs from serve")
    check(turns_equal, "lora_serve: the two armed turns differ")
    check(all(v > 0 for v in moved.values()),
          f"lora_serve: an adapter changed no token: {moved}")
    check(perm_equal, "lora_serve: permuted bank rows changed a stream")
    check(partition[0] == partition[1] == gen_tokens
          and set(tokens) == {"base", "ad1", "ad2", "ad3"},
          f"lora_serve: adapter tokens {tokens} do not partition the "
          f"{partition[1]} emitted")
    churn_ops = set(counts["before_churn"]) | set(counts["after_churn"])
    check(len(churn_ops) == 1,
          f"lora_serve: a churned bank changed a step's ops: {counts}")
    check(kernels_churn[0] and kernels_churn[0] == kernels_churn[1],
          f"lora_serve: a churned bank changed a step's kernels: "
          f"{churn_events}")
    check(min(probe0[:3]) > 0 and probe0[3] == 0 and probe1[1] == 0
          and probe1[0] == probe0[0] and probe1[2] == probe0[2]
          and probe1[3] == 0,
          f"lora_serve: prefix probes (base, ad1, ad2, unknown) {probe0} "
          f"-> {probe1} across ad1's hot swap")
    check(finetuned is None or (
        ft["tokens"] == SERVE_NEW_TOKENS
        and ft["rank16_register"] == "adapter_mismatch"
        and ft["rank16_certify"] == "adapter_mismatch"),
        f"lora_serve: the fine-tuned adapter's loop: {ft}")
    check(finite and len(canary) == 4, "lora_serve: the canary failed")
    check(ad_tok == ten_tok and abs(ad_s - ten_s) <= 1e-9 * max(ten_s, 1.0),
          f"lora_serve: ledger adapters {ad_s} s / {ad_tok} tokens, "
          f"tenants {ten_s} s / {ten_tok}")
    must, _ = served_kernels("gpt3-1.3b")
    check(all(launches[k] > 0 for k in must),
          f"lora_serve: the armed burst launched {launches}")
    del model, plain, armed, turns
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# phase 21, multirank_train: the runs, each (preset, dtype, layers or None
# for full depth, (dp, sharding, mp), ZeRO stage, global batch B x S,
# global-norm clip or None, optimizer); every rank shares cuda:0 over gloo
MULTIRANK_RUNS = {
    "A": dict(preset="gpt3-1.3b", dtype="bfloat16", layers=None,
              dims=(1, 1, 2), zero=0, batch=(TRAIN_B, TRAIN_S), clip=None,
              opt="adamw"),
    "B": dict(preset="gpt3-1.3b", dtype="bfloat16", layers=None,
              dims=(1, 2, 1), zero=2, batch=(TRAIN_B, TRAIN_S), clip=None,
              opt="adamw"),
    # fp32 at gpt3-1.3b's widths cut to 2 layers (a cut of depth), with a
    # clip far below the first step's gradient norm, under SGD, whose
    # update scales with the clip factor and the gradient average (Adam's
    # hardly does)
    "C": dict(preset="gpt3-1.3b", dtype="float32", layers=2,
              dims=(2, 1, 2), zero=1, batch=(TRAIN_B, TRAIN_S), clip=0.05,
              opt="sgd"),
}
MULTIRANK_STEPS = 3
# the losses' relative tolerance against the one-rank step: bf16 (A, B)
# and fp32 (C); and C's update check, each leaf's change over the steps
# (its norm, and its dot with a seeded probe) against the one-rank
# step's, relative to that change's norm
MULTIRANK_BF16_TOL = 1e-3
MULTIRANK_FP32_TOL = 1e-4
MULTIRANK_UPDATE_TOL = 1e-3
MULTIRANK_CHILD_TIMEOUT = 420
MULTIRANK_KERNELS = ("layernorm_fwd", "flash_fwd", "flash_bwd_dq",
                     "flash_bwd_dkv", "layernorm_bwd", "fused_adam")


def multirank_strategy(run):
    from paddle_tpu_torch.distributed.strategy import DistributedStrategy
    c = MULTIRANK_RUNS[run]
    s = DistributedStrategy()
    dp, sh, mp = c["dims"]
    s.hybrid_configs = {"dp_degree": dp, "sharding_degree": sh,
                        "mp_degree": mp}
    if c["zero"]:
        s.sharding = True
        s.sharding_configs = {"stage": c["zero"]}
    return s


def multirank_model(run, device, generator=None):
    """The run's model on `device` in train mode, with AdamW (lr 1e-4, wd
    0.01, fp32 moments) or SGD (lr 1) and the run's clip."""
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import SGD, AdamW
    c = MULTIRANK_RUNS[run]
    over = {} if c["layers"] is None else {"num_hidden_layers": c["layers"]}
    model = model_class(c["preset"]).from_preset(
        c["preset"], device=device, dtype=c["dtype"], generator=generator,
        **over)
    model.train()
    clip = ClipGradByGlobalNorm(c["clip"]) if c["clip"] else None
    if c["opt"] == "sgd":
        return model, SGD(learning_rate=1.0, parameters=model.parameters(),
                          grad_clip=clip)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters(), moment_dtype="float32",
                grad_clip=clip)
    return model, opt


def multirank_update(state, directory):
    """{name: [norm of the change, its dot with a seeded probe]} of each
    parameter in `state` (whole tensors on the card) against the exported
    weights in `directory`, in fp32 on the card: what the steps moved,
    read the same way on a rank and in the one-rank step."""
    import numpy as np
    import torch
    out = {}
    gen = torch.Generator(device="cuda")
    for i, k in enumerate(sorted(state)):
        arr = np.load(os.path.join(directory, k + ".npy"), mmap_mode="r")
        w0 = torch.from_numpy(np.ascontiguousarray(arr)).cuda()
        if state[k].dtype == torch.bfloat16:
            w0 = w0.view(torch.int16).view(torch.bfloat16)
        d = state[k].float() - w0.float()
        gen.manual_seed(SEED + i)
        probe = torch.randn(d.shape, generator=gen, device="cuda")
        out[k] = [float(d.norm()), float((d * probe).sum())]
        del w0, d, probe
    return out


def multirank_export(model, directory):
    """Each parameter of `model` as directory/<name>.npy, bf16 as its
    uint16 bits (half the bytes of fp32)."""
    import numpy as np
    import torch
    os.makedirs(directory, exist_ok=True)
    for k, p in model.named_parameters():
        t = p.detach().cpu()
        arr = (t.view(torch.int16).numpy().view(np.uint16)
               if t.dtype == torch.bfloat16 else t.numpy())
        np.save(os.path.join(directory, k + ".npy"), arr)


def multirank_load(model, hcg, directory):
    """This rank's shards of the exported parameters (bridge.shard_state
    over memory-mapped files) into `model`."""
    import numpy as np
    import torch
    from paddle_tpu_torch.bridge import shard_state
    named = dict(model.named_parameters())
    arrays = {k: np.load(os.path.join(directory, k + ".npy"),
                         mmap_mode="r") for k in named}
    with torch.no_grad():
        for k, arr in shard_state(arrays, model, hcg).items():
            p = named[k]
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if p.dtype == torch.bfloat16:
                t = t.view(torch.int16).view(torch.bfloat16)
            check(tuple(t.shape) == tuple(p.shape),
                  f"multirank: shard of {k} {tuple(t.shape)} vs the "
                  f"rank's {tuple(p.shape)}")
            p.copy_(t.to(p.device))


def multirank_steps(step, ids, labels, on_last=None):
    """MULTIRANK_STEPS calls of `step` on the global batch, each timed
    with a synchronize; `on_last()` runs before the last. Returns (losses,
    step ms)."""
    import torch
    losses, ms = [], []
    for i in range(MULTIRANK_STEPS):
        if i == MULTIRANK_STEPS - 1 and on_last is not None:
            on_last()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(ids, labels)))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def moment_bytes(opt):
    return sum(t.numel() * t.element_size() for slots in opt.state.values()
               for k, t in slots.items() if k.startswith("moment"))


def rank_child(run, rank, world, workdir):
    """A rank of phase 21 (`chip_smoke.py --rank-child RUN RANK WORLD
    WORKDIR`): run D's one-rank NCCL check, or fleet.init over a
    FileStore in WORKDIR, the run's model with this rank's shards of the
    exported weights, MULTIRANK_STEPS steps through parallelize on the
    global batch; writes WORKDIR/<run>_rank<rank>.json."""
    os.environ.update(PADDLE_TRAINER_ID=str(rank),
                      PADDLE_TRAINERS_NUM=str(world),
                      FLAGS_selected_gpus="0")
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    if run == "D":
        out = nccl_one_rank()
    else:
        from paddle_tpu_torch.ops import _kernels
        from paddle_tpu_torch.parallel import parallelize
        s = multirank_strategy(run)
        fleet.init(is_collective=True, strategy=s,
                   init_method=f"file://{workdir}/store_{run}")
        hcg = fleet.get_hybrid_communicate_group()
        # a CUDA tensor from rank 0 to rank 1 (gloo's send and recv of a
        # CUDA tensor cross through host memory)
        ping = torch.arange(8, dtype=torch.float32, device="cuda") + 1
        if rank == 0:
            C.send(ping, 1)
        elif rank == 1:
            got = C.recv(torch.zeros_like(ping), 0)
            check(torch.equal(got, ping), "multirank: recv of a CUDA tensor")
        model, opt = multirank_model(run, "cuda")
        multirank_load(model, hcg, os.path.join(workdir, f"w_{run}"))
        step = parallelize(model, opt, strategy=s)
        batch = np.load(os.path.join(workdir, f"batch_{run}.npz"))
        ids, labels = batch["ids"], batch["labels"]
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        C.reset_comm_counts()
        losses, ms = multirank_steps(step, ids, labels,
                                     on_last=lambda: C.comm_timing(True))
        C.comm_timing(False)
        launches = _kernels.launch_counts()
        B, S = MULTIRANK_RUNS[run]["batch"]
        out = {"losses": losses, "step_ms": ms,
               "tokens_per_s": B * S / (ms[1] / 1e3),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "comm_bytes_per_step": {k: v / MULTIRANK_STEPS for k, v in
                                       C.comm_bytes().items()},
               "comm_s_last_step": C.comm_seconds(),
               "moment_bytes": moment_bytes(opt),
               "coord": dict(step.mesh.coord),
               "launches": launches}
        if MULTIRANK_RUNS[run]["dtype"] == "float32":
            # the whole parameters after the steps (a gather on every
            # rank), read on rank 0, after the step's bytes and memory
            names = dict(model.named_parameters())
            full = {k: v for k, v in step.state_dict().items()
                    if k in names}
            out["update"] = (multirank_update(
                full, os.path.join(workdir, f"w_{run}")) if rank == 0
                else None)
            del full
        C.destroy_process_group()
    with open(os.path.join(workdir, f"{run}_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def nccl_one_rank():
    """Run D: a one-rank NCCL group on cuda:0; every collective of
    collective.py must give the one-rank result (its input)."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import init_parallel_env
    init_parallel_env()
    backend = dist.get_backend()
    check(backend == "nccl", f"multirank D: one rank on one GPU chose "
          f"{backend}, not nccl")
    x = torch.arange(12, dtype=torch.float32, device="cuda").reshape(3, 4)
    got = {}
    for name, op in (("sum", C.ReduceOp.SUM), ("max", C.ReduceOp.MAX),
                     ("min", C.ReduceOp.MIN), ("prod", C.ReduceOp.PROD),
                     ("avg", C.ReduceOp.AVG)):
        got[f"all_reduce_{name}"] = C.all_reduce(x.clone(), op)
    got["reduce"] = C.reduce(x.clone(), 0)
    got["all_gather"] = C.all_gather([], x)[0]
    got["all_gather_concat"] = C.all_gather_concat(x, concat_axis=1)
    got["reduce_scatter"] = C.reduce_scatter(torch.empty_like(x), x.clone())
    got["all_to_all_single"] = C.all_to_all_single(x.clone())
    got["alltoall"] = C.alltoall([x])[0]
    got["broadcast"] = C.broadcast(x.clone(), 0)
    got["scatter"] = C.scatter(torch.empty_like(x), [x.clone()], src=0)
    C.barrier()
    C.wait(x)
    bad = [k for k, v in got.items() if not torch.equal(v, x)]
    moved = C.comm_bytes()
    C.destroy_process_group()
    check(not bad, f"multirank D: NCCL one-rank results differ: {bad}")
    return {"backend": backend, "checked": sorted(got), "bytes": moved}


def _launch_ranks(run, world, workdir):
    """Start the run's ranks; return their Popen objects."""
    env = dict(os.environ)
    env.pop("PDTPU_FAULTS", None)
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-child", run,
         str(r), str(world), workdir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _join_ranks(run, procs, workdir):
    """Wait for every rank (killing them all past the timeout or when one
    fails); returns each rank's JSON. Any failure fails the phase."""
    deadline = time.perf_counter() + MULTIRANK_CHILD_TIMEOUT
    outs = [None] * len(procs)
    try:
        while any(p.poll() is None for p in procs):
            if time.perf_counter() > deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for i, p in enumerate(procs):
            outs[i] = p.communicate()[0]
    for r, p in enumerate(procs):
        check(p.returncode == 0,
              f"multirank {run}: rank {r} exited {p.returncode}:\n"
              f"{(outs[r] or '')[-4000:]}")
    res = []
    for r in range(len(procs)):
        with open(os.path.join(workdir, f"{run}_rank{r}.json")) as f:
            res.append(json.load(f))
    return res


def multirank_reference(run, workdir, ids, labels):
    """The one-rank step on the card from the run's seeded weights: export
    them to WORKDIR/w_<run>, then MULTIRANK_STEPS steps on the global
    batch. Returns (losses, step ms, moment bytes by leaf, first step's
    gradient norm)."""
    import torch
    from paddle_tpu_torch.nn.clip import clip_grad_norm_
    from paddle_tpu_torch.parallel import ShardedTrainStep
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    model, opt = multirank_model(run, "cuda", generator=gen)
    multirank_export(model, os.path.join(workdir, f"w_{run}"))
    gnorm = None
    if MULTIRANK_RUNS[run]["clip"]:
        loss = model(torch.from_numpy(ids).cuda(),
                     torch.from_numpy(labels).cuda())
        loss.backward()
        gnorm = float(clip_grad_norm_(model.parameters(), float("inf")))
        model.zero_grad(set_to_none=True)
    step = ShardedTrainStep(model, opt)
    losses, ms = multirank_steps(step, ids, labels)
    leaves = [(p.numel(), t.numel() * t.element_size())
              for p, slots in opt.state.items()
              for k, t in slots.items() if k.startswith("moment")]
    update = None
    if MULTIRANK_RUNS[run]["dtype"] == "float32":
        update = multirank_update(
            {k: p.detach() for k, p in model.named_parameters()},
            os.path.join(workdir, f"w_{run}"))
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return losses, ms, leaves, gnorm, update


def phase_multirank_train(device_name, smi_line):
    """Phase 21: multi-rank training at one GPU (module docstring)."""
    import shutil
    import tempfile
    import numpy as np
    gc.collect()
    workdir = tempfile.mkdtemp(prefix="pdtt_multirank_")
    d_procs = []
    try:
        refs, runs = {}, {}
        for run, c in MULTIRANK_RUNS.items():
            B, S = c["batch"]
            vocab = preset_config(c["preset"]).vocab_size
            rng = np.random.RandomState(SEED + 4)
            ids = rng.randint(0, vocab, (B, S)).astype(np.int64)
            labels = rng.randint(0, vocab, (B, S)).astype(np.int64)
            np.savez(os.path.join(workdir, f"batch_{run}.npz"), ids=ids,
                     labels=labels)
            if run == "B":      # the same model and batch as A
                refs[run] = refs["A"]
                shutil.copytree(os.path.join(workdir, "w_A"),
                                os.path.join(workdir, "w_B"))
            else:
                refs[run] = multirank_reference(run, workdir, ids, labels)
        # D's one rank starts beside A's ranks (it moves 624 bytes)
        t0 = time.perf_counter()
        d_procs = _launch_ranks("D", 1, workdir)
        for run in ("A", "B", "C", "D"):
            if run == "D":
                runs[run] = _join_ranks(run, d_procs, workdir)
            else:
                world = int(np.prod(MULTIRANK_RUNS[run]["dims"]))
                runs[run] = _join_ranks(
                    run, _launch_ranks(run, world, workdir), workdir)
                shutil.rmtree(os.path.join(workdir, f"w_{run}"))
            runs[run + "_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            emit({"phase": "multirank_train", "run": run,
                  "wall_s": runs[run + "_s"],
                  "ranks": [{k: v for k, v in r.items()
                             if k not in ("launches", "update")}
                            for r in runs[run]]})
    finally:
        for p in d_procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(workdir, ignore_errors=True)
    out = {"phase": "multirank_train", "device": device_name,
           "smi": smi_line, "steps": MULTIRANK_STEPS,
           "tol": {"bf16": MULTIRANK_BF16_TOL, "fp32": MULTIRANK_FP32_TOL,
                   "update_fp32": MULTIRANK_UPDATE_TOL}}
    for run in ("A", "B", "C"):
        c = MULTIRANK_RUNS[run]
        ref_losses, ref_ms, leaves, gnorm, ref_update = refs[run]
        tol = MULTIRANK_FP32_TOL if c["dtype"] == "float32" \
            else MULTIRANK_BF16_TOL
        ranks = runs[run]
        worst = max(abs(a - b) / abs(b) for r in ranks
                    for a, b in zip(r["losses"], ref_losses))
        check(all(math.isfinite(x) for r in ranks for x in r["losses"]),
              f"multirank {run}: a non-finite loss")
        check(worst <= tol, f"multirank {run}: losses {[r['losses'] for r in ranks]} "
              f"vs one rank {ref_losses}: relative {worst:.3g} > {tol}")
        rec = {"config": {k: v for k, v in c.items()},
               "one_rank": {"losses": ref_losses, "step_ms": ref_ms},
               "max_rel_loss_diff": worst, "wall_s": runs[run + "_s"],
               "ranks": [{k: r[k] for k in (
                   "coord", "losses", "step_ms", "tokens_per_s", "peak_gib",
                   "comm_bytes_per_step", "comm_s_last_step",
                   "moment_bytes")} for r in ranks]}
        if ref_update is not None:
            # fp32 (C): each leaf's change against the one-rank step's,
            # relative to the norm of that change: its norm, and its dot
            # with the probe (a bf16 update is mostly parameter rounding)
            update = ranks[0]["update"]
            upd = max(max(abs(a[0] - b[0]), abs(a[1] - b[1]))
                      / max(b[0], 1e-30)
                      for a, b in ((update[k], ref_update[k])
                                   for k in ref_update))
            check(upd <= MULTIRANK_UPDATE_TOL,
                  f"multirank {run}: a leaf's update differs by {upd:.3g} "
                  f"of its norm > {MULTIRANK_UPDATE_TOL} (the losses by "
                  f"{worst:.3g})")
            rec["max_rel_update_diff"] = upd
            rec["update_norm"] = math.sqrt(sum(v[0] ** 2 for v in
                                               ref_update.values()))
        if gnorm is not None:
            check(gnorm > c["clip"], f"multirank {run}: the clip "
                  f"{c['clip']} does not bind (norm {gnorm})")
            rec["first_grad_norm"] = gnorm
        if c["dims"][1] > 1 and c["dims"][2] == 1:
            # ZeRO over sharding alone: each rank holds 1/S of every
            # moment but those of the leaves under min_numel
            S = c["dims"][1]
            want = sum(b // S if n >= 1024 else b for n, b in leaves)
            got = [r["moment_bytes"] for r in ranks]
            check(all(g == want for g in got),
                  f"multirank {run}: moment bytes {got} a rank, want "
                  f"{want} (one rank: {sum(b for _, b in leaves)})")
            rec["one_rank_moment_bytes"] = sum(b for _, b in leaves)
        out[run] = rec
    launches = runs["A"][0]["launches"]
    missing = [k for k in MULTIRANK_KERNELS if not launches.get(k)]
    check(not missing, f"multirank A: rank 0 launched no {missing}")
    out["A"]["rank0_launches"] = {k: launches[k] for k in MULTIRANK_KERNELS}
    out["D"] = runs["D"][0]
    out["D"]["wall_s"] = runs["D_s"]
    emit(out)
    return launches


KERNEL_META = {
    "paged_attention": dict(
        source="paddle_tpu_torch/csrc/paged_attention_tc.cu",
        replaces="paddle_tpu/ops/paged_attention.py:136", phase="serve"),
    "layernorm_fwd": dict(
        source="paddle_tpu_torch/csrc/layernorm.cu",
        replaces="paddle_tpu/ops/layernorm.py:35", phase="serve"),
    "flash_fwd": dict(
        source="paddle_tpu_torch/csrc/flash_attention_tc.cu",
        replaces="paddle_tpu/ops/attention.py:174", phase="train"),
    "flash_bwd_dq": dict(
        source="paddle_tpu_torch/csrc/flash_attention_tc.cu",
        replaces="paddle_tpu/ops/attention.py:246", phase="train"),
    "flash_bwd_dkv": dict(
        source="paddle_tpu_torch/csrc/flash_attention_tc.cu",
        replaces="paddle_tpu/ops/attention.py:300", phase="train"),
    "layernorm_bwd": dict(
        source="paddle_tpu_torch/csrc/layernorm.cu",
        replaces="paddle_tpu/ops/layernorm.py:48", phase="train"),
    "fused_adam": dict(
        source="paddle_tpu_torch/csrc/fused_adam.cu",
        replaces="paddle_tpu/ops/fused_adam.py:47", phase="train_recipe"),
    # the mask and dropout variants of kernels 3-5 (the TPU kernels'
    # has_mask and dropout_p > 0 branches)
    **{f"{k}_{v}": dict(
        source="paddle_tpu_torch/csrc/flash_attention_tc.cu",
        replaces=f"paddle_tpu/ops/attention.py:{line}",
        phase="attention_variants")
       for k, line in (("flash_fwd", 174), ("flash_bwd_dq", 246),
                       ("flash_bwd_dkv", 300))
       for v in ("mask", "dropout")},
    # the fp16 instantiations of kernels 3-5 (AMP in float16)
    **{f"{k}_fp16": dict(
        source="paddle_tpu_torch/csrc/flash_attention_tc.cu",
        replaces=f"paddle_tpu/ops/attention.py:{line}",
        phase="train_amp_fp16")
       for k, line in (("flash_fwd", 174), ("flash_bwd_dq", 246),
                       ("flash_bwd_dkv", 300))},
    # their mask and dropout variants in fp16
    **{f"{k}_{v}_fp16": dict(
        source="paddle_tpu_torch/csrc/flash_attention_tc.cu",
        replaces=f"paddle_tpu/ops/attention.py:{line}",
        phase="attention_variants")
       for k, line in (("flash_fwd", 174), ("flash_bwd_dq", 246),
                       ("flash_bwd_dkv", 300))
       for v in ("mask", "dropout")},
    # the fp16 instantiations of kernels 1, 6, 7 and 2 (pure-fp16 training,
    # fp16 serving)
    "layernorm_fwd_fp16": dict(
        source="paddle_tpu_torch/csrc/layernorm.cu",
        replaces="paddle_tpu/ops/layernorm.py:35", phase="serve_fp16"),
    "layernorm_bwd_fp16": dict(
        source="paddle_tpu_torch/csrc/layernorm.cu",
        replaces="paddle_tpu/ops/layernorm.py:48", phase="train_fp16_o2"),
    "fused_adam_fp16": dict(
        source="paddle_tpu_torch/csrc/fused_adam.cu",
        replaces="paddle_tpu/ops/fused_adam.py:47", phase="train_fp16_o2"),
    "paged_attention_fp16": dict(
        source="paddle_tpu_torch/csrc/paged_attention_tc.cu",
        replaces="paddle_tpu/ops/paged_attention.py:136",
        phase="serve_fp16"),
}


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "paddle_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository "
              "(paddle_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    if sys.argv[1:2] == ["--resilient-child"]:
        return resilient_child(sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:2] == ["--rank-child"]:
        return rank_child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                          sys.argv[5])
    seconds = {}

    def timed(phase, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[phase] = time.perf_counter() - t0
        return out

    name, count, smi_line = timed("device", phase_device)
    timed("build", phase_build)
    kern = timed("kernels", phase_kernels)
    kern.update(timed("train_kernels", phase_train_kernels))
    kern.update(timed("fp16_kernels", phase_fp16_kernels))
    kern.update(timed("adam_kernel", phase_adam_kernel))
    variants, variant_launches = timed("attention_variants",
                                       phase_attention_variants)
    kern.update(variants)
    timed("model", phase_model)
    timed("model_train", phase_model_train)
    timed("model_amp", phase_model_amp)
    timed("moe_model", phase_moe_model)
    timed("optimizers", phase_optimizers)
    timed("resnet_model", phase_resnet_model)
    timed("vision_model", phase_vision_model)
    serve = {}
    by_phase = {"attention_variants": variant_launches,
                "serve": timed("serve", phase_serve, record=serve)}
    by_phase["serve_fp16"] = timed("serve_fp16", phase_serve, "serve_fp16")
    timed("sampling", phase_sampling)
    sample = {}
    by_phase["sample_serve"] = timed("sample_serve", phase_sample_serve,
                                     serve, record=sample)
    by_phase["spec_serve"] = timed("spec_serve", phase_spec_serve, serve,
                                   sample)
    by_phase["frontend_serve"] = timed("frontend_serve",
                                       phase_frontend_serve, serve, sample)
    by_phase["prefix_serve"] = timed("prefix_serve", phase_prefix_serve)
    by_phase["serve_supervised"] = timed("serve_supervised",
                                         phase_serve_supervised, serve)
    by_phase["serve_observed"] = timed("serve_observed",
                                       phase_serve_observed, serve, name)
    by_phase["batch_serve"] = timed("batch_serve", phase_batch_serve)
    train = {}
    by_phase["train"], train_peak = timed("train", phase_train, name,
                                          record=train)
    by_phase["train_recipe"], _ = timed("train_recipe", phase_train, name,
                                        "train_recipe",
                                        train_peak_gib=train_peak)
    by_phase["lora_finetune"], adapter_set = timed(
        "lora_finetune", phase_lora_finetune, name, train)
    by_phase["lora_serve"] = timed("lora_serve", phase_lora_serve, serve,
                                   adapter_set)
    timed("llama_model", phase_model, "llama_model")
    timed("llama_model_train", phase_model_train, "llama_model_train")
    for cell in ("llama_serve", "llama_serve_gqa"):
        by_phase[cell] = timed(cell, phase_serve, cell)
    by_phase["llama_train"], _ = timed("llama_train", phase_train, name,
                                       "llama_train")
    for cell in AMP_TRAIN_CELLS:
        by_phase[cell] = timed(cell, phase_train_amp, name, cell)
    by_phase["moe_train"], _ = timed("moe_train", phase_train, name,
                                     "moe_train")
    by_phase["resnet_train"] = timed("resnet_train", phase_resnet_train,
                                     name)
    by_phase["mobilenet_fit"] = timed("mobilenet_fit", phase_mobilenet_fit,
                                      name)
    by_phase["resilient_train"] = timed("resilient_train",
                                        phase_resilient_train, name,
                                        smi_line)
    by_phase["train_numerics"] = timed("train_numerics",
                                       phase_train_numerics, name, smi_line)
    by_phase["multirank_train"] = timed("multirank_train",
                                        phase_multirank_train, name,
                                        smi_line)
    emit({"phase": "phase_seconds", **seconds})
    keys = ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    lines = []
    for k in KERNEL_META:
        line = dict(name=k, route="cuda", **KERNEL_META[k],
                    launches=by_phase[KERNEL_META[k]["phase"]][k],
                    launches_by_phase={ph: c[k] for ph, c in
                                       by_phase.items()},
                    **{x: kern[k][x] for x in keys}, kernel_ms=kern[k]["ms"])
        for x in ("tflops", "share_of_bound", "without_variant_ms",
                  "causal_case_b", "entry_key_padding_b11s",
                  "entry_per_head_bf16",    # the flash kernels and variants
                  "at_llama_shape", "at_llama_shapes", "at_moe_shape",
                  "at_draft_shape", "shared_pages",
                  "do_update_flag",
                  # the fp16 LayerNorm and paged-attention readings
                  "at_train_shape", "at_serve_shape", "scalar_route",
                  "at_gqa_shape"):
            if x in kern[k]:
                line[x] = kern[k][x]
        if k + "_train" in kern:   # a served kernel the train step runs too
            line["at_train_shape"] = {
                x: kern[k + "_train"][x] for x in
                keys + ("shape", "share_of_bound", "cold_ms",
                        "cold_library_ms", "cold_share_of_bound")}
        lines.append(line)
    emit({"kernels": lines})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
