#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero; nothing is caught and passed over):

1. the card: ``nvidia-smi`` name and power limit;
2. build every CUDA kernel from this checkout's sources (``nvcc``, into
   ``build/repro_torch_kernels/``) and print ptxas' register report; fail
   if B4's tensor-core instances (``wgmma_bf16_dh64`` / ``_dh128``) or B5's
   (``wgmma_bf16``) issue no ``HGMMA`` in their SASS (``cuobjdump -sass``)
   or spill, or if any kernel of B1 or B2 spills; print each B1 instance's
   registers;
3. hold each kernel against its plain torch version on the card, TF32 off,
   at every per-tile shape its run gives it plus edge cases (stride 2,
   ragged, Cout=1, Cin=3, odd Cin, bf16 and mixed precision, each B1 and B2
   tile instance and gather, B1's and B2's split-K over a ragged M, B1's
   with bias and leaky after the reduce), and time kernel, plain version
   and the library call at those shapes: the forward (B1) at the serve
   run's bucket-8 shapes (also checked at the training run's microbatch-4
   shapes), dgrad (B2) and wgrad (B3) at the training run's microbatch-4
   shapes.  B1, B2 and B3 must give the same bits on a rerun, and at each
   path shape B2 must come within ``DGRAD_FP64_FACTOR`` of the plain
   version's distance from an fp64 dgrad; each path shape's B1 and B2 tile,
   split and gather is printed;
4. serve full-width YOLOv2-16 at 416x416 on a 2x2 virtual tile grid
   through the CUDA kernel: freeze BN on a seeded calibration batch, warm
   the (1, 2, 4, 8) bucket ladder (one CUDA graph captured per bucket),
   drive 32 requests through ``run_serving``, check every response against
   the untiled plain reference and the launch count against 12 convs x
   dispatches: a replay launches no Python, so every serve check counts
   each graph's launches (counted at its capture) times its replays
   (``served_launches``), B1's by tile instance, with no launch from the
   host during the drive and the replays equal to the dispatches by
   bucket;
5. train the same network (BN on, fp32) on the same grid through all three
   kernels: global batch 8 in 2 microbatches, Darknet's SGD at lr 1e-3,
   the launcher's seeded batches, 3 steps through ``make_train_step`` and
   ``run_training`` (no warmup, so every step moves the params).  Checks
   the run's launch counts against the code (12 B1, 11 B2 - the image
   input needs no dgrad - and 12 B3 per microbatch; B1's by tile instance
   summing to its count), ``restarts`` 0 and
   finite losses; then the gradients the run's own step 1 handed its
   update, against the untiled plain reference (cuDNN, TF32 off,
   autograd): the loss against its fp32 run, the gradients against its
   fp64 run (see ``GRAD_FLOOR_FACTOR``), and that the same check rejects a
   planted wgrad fault (one tile dropped) and a planted dgrad fault (one
   tile's dx zeroed); then the params after the last step against the
   same trainer run on the torch backend in fp64.  Every bar rests on
   ``BAR_ORDERS`` orders of the fp32 reference (ROADMAP C.20; each leaf's
   spread and its bar beside the one-order bar printed).  Prints the
   ``{"train": ...}`` line and a profile of one step;
6. flash attention (B4) and RMSNorm (B6) against their plain versions on the
   card, TF32 off: at the LM runs' shapes (q (2, 2048, 28, 128), k/v
   (2, 2048, 4, 128), causal, and phases 20's and 21's training shapes in
   bf16 - Mixtral-8x22B's q (2, 2048, 48, 128), kv 8, with its window of
   4096, and Jamba-v0.1's q (2, 2048, 32, 128), kv 8 - and Mixtral's heads
   at ``FA_WINDOW_SEQ`` tokens, where the window masks (held against the
   plain version alone: its fp64 logits do not fit the card); RMSNorm at
   every width of each trained RMSNorm config (``b6_widths``): Qwen2-7B's
   (4096, 3584), bf16 and fp32, Mamba2-780m's (8192, 1536) and (8192,
   3072), CodeQwen1.5-7B's (4096, 4096), Mixtral's (4096, 6144) and
   Jamba's (4096, 4096) and (4096, 8192) in each run's types, the same bits
   on a rerun), on every case of ``tests/test_kernels.py``'s ``FA_CASES`` in its
   own dtype and in bf16, on ``FA_BF16_EDGE_CASES``, on ``RMS_CASES`` and
   ``RMS_EDGE_CASES`` (every B6 instance, the scalar one included), each
   case naming the instance it took; kernel, plain version and one library
   call timed (``F.scaled_dot_product_attention`` with the same mask and
   repeated KV heads, ``F.rms_norm``), bounds computed (B4 in bf16 on the
   tensor cores, in fp32 on the CUDA cores); B6 and ``F.rms_norm`` also
   timed cold (over distinct x that exceed the L2 ``RMS_COLD_FACTOR``
   times) and as device time alone (``graph_ms``); at the LM shape in bf16
   the kernel's and the plain version's distances from an fp64 evaluation,
   the kernel within ``FA_FP64_FACTOR`` of the plain version's;
7. train Qwen2-7B at full width, 12 of its 28 layers (bf16, random weights
   from seed 0), AdamW (``TrainConfig`` defaults but ``CAPTURE_WARMUP``
   warmup steps), remat
   "full": global batch 4 x 2048 tokens in 2 microbatches from
   ``synth_batch``, 4 steps through ``make_train_step`` and
   ``run_training``.  Checks the B4 and B6 launch counts against the
   code's (every B4 launch on a tensor-core instance, B6's launches by
   instance summing to its count), ``restarts`` 0,
   finite losses, and the step-1 loss against a
   forward pass through the plain versions of B4 and B6 on the same params
   (rtol ``LM_LOSS_RTOL``).  Prints the ``{"lm_train": ...}`` line and a
   profile of one step;
8. the LM path's gradients: full width, 2 layers, fp32, one microbatch of
   the same stream - the loss and gradients the trainer's
   ``lm_value_and_grad`` takes through B4 and B6, held per leaf against
   the plain path in fp64 within max(1e-3, 2 x the fp32 plain path's own
   distance), every B4 launch on a SIMT instance, and the same check must
   reject a planted fault (B4 fed one KV head's values zeroed);
9. the SSD intra-chunk kernel (B5) against its plain version on the card,
   TF32 off: at the Mamba2 run's shape (x (2, 4096, 48, 64), B/C (2, 4096,
   1, 128), chunk 256) in bf16 (``wgmma_bf16``) and fp32 (``simt_fp32``),
   at Jamba-v0.1's (``SSD_JAMBA_SHAPE``: x (2, 2048, 128, 64), B/C (2, 2048,
   1, 16)) in bf16, where 48 of each 64-wide C and B panel are TMA's zero
   fill, on every case of ``tests/test_kernels.py``'s ``SSD_CASES`` and a
   T < chunk case, each naming its instance (``kernel.py:ssd_instance``),
   held to the fp32 bar or, where an output misses it, to
   ``SSD_FP64_FACTOR`` against fp64, with decay and pref bitwise equal to
   the plain version's and every output bitwise equal on a rerun; kernel
   and plain version timed, bound computed per instance from the function's
   work (C·Bᵀ once per batch, chunk and group; no torch call computes this
   function);
10. train Mamba2-780m at full width and full depth (48 layers, bf16, random
   weights from seed 0), as phase 7: global batch 4 x 4096 tokens in 2
   microbatches, 4 AdamW steps; B5 and B6 launch counts against the code's
   (``lm_launches_per_microbatch``; B5's and B6's by instance, every B5
   launch a ``wgmma_bf16`` one), ``restarts`` 0, finite losses, the
   step-1 loss against a forward through the plain B5 and B6.  Prints the
   ``{"mamba_train": ...}`` line and a profile of one step;
11. the Mamba2 path's gradients as phase 8 (2 layers, fp32, one sequence of
   1024 tokens: 4 chunks of 256; every B5 launch a ``simt_fp32`` one), with
   a planted B5 fault (head 0's
   y_intra zeroed); and, as the record of why the port masks the decay's
   exponent, which gradient leaves the reference's literal
   ``where(tri, exp(dseg), 0)`` leaves non-finite at these inputs;
12. the grouping cost model's own plans: ``groups="auto"`` for YOLOv2-16 at
   416x416 on the 2x2 grid, batch 8, under each registered hardware profile
   (groups against ``AUTO_GROUPS_416``; halos, ``profile_cost``'s
   components, ``peak_device_memory`` and the planner's wall ms printed);
   the ``AUTO_HW`` plan trained as phase 5 (without the planted faults;
   ``{"train_auto": ...}``, and phase 5's numbers beside it), B1-B3 held as
   in phase 3 at every per-tile shape of that plan phase 3 did not hold,
   its inference twin served under the engine's modeled step bound (32
   requests against the untiled reference, launches 12 x dispatches,
   ``{"serve_auto": ...}``), and both launchers run once with ``--groups
   auto`` on the card;
13. the overlap schedule and hybrid spatial->data plans: (a) the
   hand-picked groups of phases 3-5 under ``schedule="overlap"`` (every
   group lead split into its interior and four boundary pieces) trained as
   phase 5 (without the planted faults; ``{"train_overlap": ...}``) and
   held against the sync plan and the untiled reference at
   ``scripts/check_overlap.py``'s bar (``OVERLAP_TOL``), its inference twin
   served as phase 4 (``{"serve_overlap": ...}``), phases 4's and 5's
   numbers beside them; (b) ``crossover="auto"`` planned under the four
   profiles (held to ``HYBRID_PLANS_416``), the ``HYBRID_HW`` plan with
   overlap, ``(0-5)(6-9)(10-13)(14-15 data)``, trained and served on
   ``HYBRID_BUCKETS``, and one step each of the ``jetson-edge-100m`` and
   ``jetson-nano-gpu`` hybrid plans (their params after the step held to
   the step-1 gradients' bars, ``ONE_STEP_UPDATE_BAR``); (c) B1-B3 as in phase 3 at every
   per-tile shape of those plans that phases 3 and 12 did not hold
   (overlap pieces, data-mode full maps); (d) both launchers with
   ``--schedule overlap --crossover auto`` on ``HYBRID_HW``.  In every
   training and serving run the launches equal the code's count
   (``conv_shapes``: one per conv call, the first conv's image input taking
   no dgrad), B1's by tile instance;
14. non-uniform tile partitions (``RAGGED_PLANS_416``), each under
   ``ragged_exec="spec"`` (one conv per tile-shape class) and ``"padded"``
   (one conv over every tile padded to the largest): (a) the 3x3 grid with
   the hand-picked groups, where 416 splits (144, 144, 128); (b) the
   ``pi3x3+jetson`` cluster on 2x2 with ``groups="auto"``, its
   FLOPs-balanced (16, 400) split, and its ``crossover=14`` twin for one
   step.  Each spec plan is held to its padded twin and the untiled
   reference on one microbatch (``OVERLAP_TOL``), each plan trained as
   phase 5 (without the planted faults; launches per microbatch equal to
   ``RAGGED_LAUNCHES``), the four plans served as phase 4, the cluster
   trained once through ``python -m
   repro_torch.launch.train --grid 2 --cluster pi3x3+jetson --groups
   auto``, and B1-B3 held as in phase 3 at every new per-tile shape (the
   classes' true extents down to the 1x1 corner tiles, the padded canonical
   extents); the ``{"ragged": ...}`` line gives each plan's device work,
   event step, idle share, peak memory and conv work beside phase 5's
   uniform plan;
15. pipeline tails (``PIPELINE_PLANS_416``: YOLOv2-16 without BN, batch 8,
   forced stage counts on ``PIPELINE_HW``): pipe2x2 (a 12-layer spatial
   prefix, two stages, M=2), pipe1x4 (an 8-layer prefix on 1x4 strips,
   four stages, M=4) and pure1x4 (two stages on whole 416 maps, M=2), each
   trained as phase 5 with M = grad_accum (launches a microbatch
   ``PIPELINE_LAUNCHES``; the executor's slots a step equal to
   ``pipeline_schedule_census``; pipe2x2 with a planted hand-off to the
   wrong stage rank that the step-1 grad check must reject), beside the
   same stack's sync all-spatial plan; the launcher with ``--pipeline 2``
   (its plan line prints ``stages=``); B1-B3 held as in phase 3 at every
   new shape (the stages' full maps); the ``{"pipeline": ...}`` line gives
   each plan's device work, event and host step, idle share, slots and
   peak memory;
16. wire codecs (``WIRE_PLANS_416``, ``wire_phase``), each plan trained
   through B1-B3 under its codec beside its none twin (the same plan,
   uncompressed): (a) phase 5's hand-picked 2x2 plan under int8 for 3
   steps - its step-1 loss within ``WIRE_LOSS_RTOL`` of phase 5's, its
   step-1 grads within ``CODEC_BAR`` x the codec's own effect of the same
   codec plan on the plain versions (normwise, per leaf; the bar of
   ``tests/test_torch_wire_codec.py``), a tile's decode scale planted x2
   that this check must reject, the EF carry across the two microbatches
   (the second one's residuals are the first one's, nonzero, and dropping
   them moves the grads) and EF's telescoping on one recorded exchange on
   the card; (b) one step each of phase 13's overlap+hybrid plan under
   topk:0.5, phase 14's padded cluster and phase 15's pipe2x2 under int8;
   (c) the ``jetson-edge-100m`` plan planned under int8, trained one step
   and served on ``WIRE_SERVE_BUCKETS`` through the engine, its responses
   within ``CODEC_BAR`` of the plain codec forward; (d) both launchers with
   ``--wire-codec int8``; (e) B1-B3 at every new per-tile shape; the
   ``{"wire": ...}`` line gives each plan's device kernels a step, device
   work, event step, idle share, peak memory and
   ``modeled_step_wire_bytes`` beside its none twin's;
17. one CUDA graph per batch bucket (``capture_phase``): (a) every plan the
   earlier phases serve (``CAPTURE_PLANS_416``: sync, nano auto, overlap,
   hybrid+overlap, the 3x3 grid and the cluster each spec and padded, edge
   int8, and phase 16's hybrid plan under topk:0.5), on every bucket of its
   ladder: the engine's captured replay
   bitwise equal to the uncaptured forward on a seeded input, its graph's
   B1 launches equal to the code's count by tile instance, pool bytes, and
   the forward on the host clock eager against replayed; the sync and
   hybrid+overlap engines then serve phase 4's requests under one
   ``ManualClock`` (``SERVE29_CLOCK``, ``clock_drive``): the batch log, the
   responses' hashes and B1's graph launches x replays phase 29(f) holds
   its rank engines to; (b) phase 4's
   plan and 32 requests served once with ``capture=False`` and once
   captured, under phase 4's step bound: p50, p99, img/s, the bucket-1 and
   bucket-8 dispatch on the host clock (in turns), the staging copies
   alone, device ms, idle share and the profiler's B1 kernels of three
   bucket-8 dispatches, replays and pool bytes per bucket, the two
   engines' responses equal; (c) the replay after a swap of the params
   for another seed's, and after an in-place update of a leaf, equal to the
   eager forward with them; (d) a planted fault - a replay that skips the
   copy into the static input - rejected by (a)'s check.  The serve
   launchers' B1 launches are the host's (warm runs and captures) plus
   each graph's times its replays (``run_serve_launcher``);
18. elastic training (``elastic_phase``; phase 5's settings under one
   cosine horizon of ``ELASTIC_STEPS``, checkpoints in a temporary
   directory the phase removes): (a) phase 5's 2x2 plan for 4 steps
   uninterrupted, stopped after step 1 and resumed (async saves), and under
   ``ELASTIC_FAIL_FAULTS`` (a failed step and a writer crash absorbed by
   ``retry_io``) - every param, momentum leaf, ``opt["t"]`` and ``step``
   bitwise equal to the uninterrupted run's, a resume with the momentum
   zeroed rejected, a corrupted newest checkpoint falling back one retained
   step while its explicit restore raises; (b) phase 14's padded
   ``pi3x3+jetson`` plan losing the Jetson (``ELASTIC_DROP_FAULTS``) and
   replanning onto the survivors' 1x3 grid through the launcher's
   ``make_replan`` (its ``replan`` line printed), the live state bitwise
   equal to a fresh 1x3 driver resumed from the step-1 checkpoint, the
   stored plan manifest the 1x3 plan's; (c) the original cluster plan
   resuming the 1x3 run's last checkpoint for 2 more steps, the 7-step
   trajectory bitwise equal to the same steps held in memory and, leaf by
   leaf, within ``GRAD_FLOOR_FACTOR`` x the largest of three fp32
   trainers' errors of the untiled fp64 trainer's (the untiled one, the
   cluster plan alone and the phase's plans, both on the torch backend;
   ROADMAP C.5's bar), a momentum lost at the replan rejected; B1-B3 held as in phase 3 at the padded and spec
   1x3 plans' new shapes; the launcher with ``--ckpt-dir``, ``--ckpt-every``,
   ``--fault-schedule ELASTIC_LAUNCHER_FAULTS`` and then ``--resume
   always``; (d) the reduced Qwen2-7B config with bf16 params and AdamW in
   place: an async save's snapshot holds the saved step while the next
   step updates in place, and a resume from it is bitwise equal to the
   uninterrupted run (B4 and B6 launches counted); (e) the ``{"elastic":
   ...}`` line: checkpoint bytes and files, blocking save, the async save's
   snapshot and writer, restore with CRCs, replan and the first step after
   it, the median step on the 2x2 cluster and on 1x3, the peak after the
   replan.  (b) and (c) keep each step's param checksums and their last
   checkpoints', and (c) its bars, for phase 29(d);
19. LM serving (``lm_serve_phase``): (d) B6 against its plain version at
   the decode shapes - rows ``RMS_DECODE_ROWS`` (the slots) at every B6
   width of the configs phases 19 and 20 serve (Qwen2-7B's, Mamba2-780m's
   and CodeQwen1.5-7B's), bf16 and fp32, the same bits on a rerun, each
   shape naming its instance; (b) at full width, 2 layers, fp32: tokens
   teacher-forced through ``decode_step`` against ``apply_lm``'s logits
   (B4 or B5 on their SIMT instances, and B6) within ``DECODE_BAR``, and
   planted faults this check must reject: for Qwen2 a K/V cache written one
   row late, for Mamba2 a conv ring rolled one position and an SSM state
   that is never written back; (c) a request admitted into a recycled slot
   beside two active ones gives, bit for bit, the logits and tokens it
   gives alone in the same 3-slot engine (ROADMAP C.8 repaired); (a, e) Qwen2-7B (28
   layers) and Mamba2-780m (48 layers) at full width, bf16, seed-0 params,
   served through ``ServeEngine``: ``LM_SERVE_REQUESTS`` prompts, greedy
   ``LM_SERVE_NEW`` tokens each over ``LM_SERVE_SLOTS`` slots - every
   request complete, finite logits, B6's launches the code's count (a
   decode call's norms x the prefill tokens plus the ticks), no B4 or B5
   launch; the ``{"lm_serve": ...}`` line per arch: tok/s, per-tick decode
   ms on CUDA events and the host clock, a profiled tick's device time and
   idle share, prefill ms per admitted request, peak memory, B6 launches by
   instance; the serve launcher's LM mode (``python -m
   repro_torch.launch.serve --arch <id>``) on the card;
20. the dense configs of ROADMAP A.18.2 (``dense_phase``): StableLM-2-1.6B
   (LayerNorm, partial rotary), CodeQwen1.5-7B (MHA, QKV bias) and
   Command-R 35B (LayerNorm, parallel block, tied embeddings) at their
   published widths, seed-0 params: (a) at 2 layers, fp32, with seeded
   noise on every bias and norm leaf, decode teacher-forced against
   ``apply_lm`` (B4 ``simt_fp32_dh64`` / ``_dh128``, B6 for CodeQwen
   alone) within ``DECODE_BAR``, and one planted fault each over it (decode
   rotating the whole head, dropping ``b_v``, running the sequential
   block); (b) each trained as phase 7 (bf16, remat full, AdamW, 4 x 2048
   tokens in 2 microbatches) at ``DENSE_TRAIN_DEPTH``: B4 twice per layer
   per microbatch on ``wgmma_bf16_dh64`` / ``_dh128``, B6 only for the
   RMSNorm config (a LayerNorm runs as plain torch; phases 7's, 19's and
   20's B6 counts follow the norm kind), with the modeled state of one
   layer more beside the card (no step profiled: ``UNPROFILED_TRAIN``);
   (c) each served at full width and full
   depth with ``CONFIG_SERVE_TRAFFIC`` (``lm_serve_drive``, Command-R 35B's
   60.6 GB included, after ``gc.collect()`` and ``empty_cache()``), init's
   peak held within ``INIT_PEAK_SLACK`` of the params plus the largest fp32
   draw; (d) both
   launchers with their default ``--arch`` (``stablelm-1.6b``) on the card.
   B4 is also timed in phase 6 at each config's bf16 training shape;
21. the Mixture-of-Experts configs of ROADMAP A.18.3 (``moe_phase``):
   Mixtral-8x22B (MoE on every layer, window 4096) and Jamba-v0.1-52B
   (Mamba layers, attention without RoPE at offset 4 of each period of 8,
   MoE on odd layers) at their published widths, seed-0 params: (a) at
   ``MOE_CHECK_DEPTH`` layers (2; 5, which reaches Jamba's attention), fp32,
   one sequence of ``LM_SERVE_FORCED`` tokens (128 assignments: dropless,
   as every decode) teacher-forced through ``decode_step`` against
   ``apply_lm``, the logits and every attention layer's output within
   ``DECODE_BAR`` (``decode_vs_forward_mixes``), the planted faults of
   ``MOE_FAULTS`` over it (top-k weights left unnormalised, every
   assignment sent to the next expert, RoPE on Jamba's attention layer),
   and phase 19(c)'s beside-vs-alone check; (b) trained as phase 7 with
   adafactor (in place, by slices) at ``MOE_TRAIN_DEPTH`` (3 and 5
   layers), with the share of assignments dropped by capacity in step 1's
   forward and the modeled state of one layer more beside the card; (c)
   served as phase 19 (``lm_serve_drive``) at ``MOE_SERVE_DEPTH`` (13 of
   56 and 16 of 32 layers), with the tick's weight-read bound; (d) both
   launchers with each id (reduced) and ``--optimizer adafactor``;
22. DeepSeek-V3-671B of ROADMAP A.18.4 (``deepseek_phase``: MLA, 3 dense
   layers then 256 routed experts top-8 beside a shared one, an MTP head)
   at its published widths, seed-0 params: (a) at ``DS_CHECK_DEPTH`` (4:
   the dense prefix and one MoE layer), no MTP head, fp32 (60.4 GB): one
   sequence of ``LM_SERVE_FORCED`` tokens (64 x top-8 = 512 assignments:
   dropless) teacher-forced through ``decode_step`` (the absorbed MLA
   decode) against ``apply_lm``, logits and MLA outputs within
   ``DECODE_BAR``, B6's launches the code's count and no B4 (MLA runs the
   plain ``_sdpa``), the planted faults of ``DS_FAULTS`` over the bar (q
   absorbed through ``w_uv``, ``k_pe`` cached unrotated, the shared expert
   dropped), beside vs alone; (b) trained as phase 21 with adafactor at
   ``DS_TRAIN_DEPTH`` (3 of 61: the dense prefix and an MTP head on a dense
   layer, 4.29 B params; B6 30 a microbatch), step 1's main CE and MTP
   term apart, a planted "MTP term dropped" the loss check must reject, the
   modeled state of layer 4 (11.51 B params of MoE) beside the card, and
   ``mla_attention``'s gradients alone at full width, 2048 tokens, fp32
   through B6 against fp64 with phase 8's bar rule and a planted fault
   (``mla_grad_check``); (c) served at ``DS_SERVE_DEPTH`` (4
   layers with the MTP head the config draws: 53.4 GB), the tick's
   weight-read bound leaving out the MTP head; (d) both launchers with the
   id (reduced).  Phase 6 also times B6 at DeepSeek's widths 7168, 1536
   and 512;
23. Qwen2-VL-2B of ROADMAP A.18.5 (``vl_phase``: M-RoPE, patch embeddings
   in place of the leading tokens) at full width and all 28 layers, seed-0
   params: (a) fp32, noise on every bias and norm leaf, one prompt of
   ``LM_SERVE_FORCED`` tokens opening with a ``VL_GRID`` x ``VL_GRID``
   image (``vl_streams``: one temporal position, the rows and columns on
   the height and width streams, so the three streams differ) through
   ``apply_lm`` (M-RoPE, then B4 by the sequence index: ROADMAP C.14)
   against the same prompt teacher-forced through ``decode_step``
   (``vl_decode_side`` feeds each step its patch and streams), logits and
   attention outputs within ``DECODE_BAR``, the planted faults of
   ``VL_FAULTS`` over it (sections permuted, height and width swapped,
   patches not substituted), beside vs alone; (b) trained as phase 7 at
   ``VL_TRAIN_DEPTH`` (6 layers), 4 x 2048 tokens (512 of them patches)
   in 2 microbatches,
   bf16, AdamW, 4 steps; (c) served at full depth, ``VL_SERVE_REQUESTS``
   text prompts; (d) both launchers with the id;
24. Whisper-medium of ROADMAP A.18.6 (``whisper_phase``: the encoder-
   decoder, cross-attention) at full width, 24 + 24 layers: (a) fp32, noise
   on every bias and norm leaf, ``decode_train(encode(frames))`` on
   ``WHISPER_CHECK_FRAMES`` frames against the tokens teacher-forced through
   ``whisper_decode_step`` with the cross K/V filled from the encoding
   (``whisper_decoded``; the reference's serving never fills them, ROADMAP
   C.15), within ``DECODE_BAR``, the planted faults of ``WHISPER_FAULTS``
   over it (cross K/V from the decoder's states, a causal encoder, the
   sinusoid dropped); (b) trained as phase 7 (the decoder at ``VL_TRAIN_DEPTH``,
   4 layers), 4 x (2048 frames, 512 tokens)
   in 2 microbatches, bf16, AdamW, 4 steps (B4 in three modes: the
   encoder's non-causal, the decoder's causal, the cross-attention's 512
   queries against 2048 keys); (c) served at full depth as the reference's
   ``_lm_main`` serves it, token prompts against zeroed cross K/V; (d) both
   launchers with the id.  Phase 6 also holds B4 at these phases' four
   training shapes (``FA_VL_WHISPER_SHAPES``) with the causal flag flipped
   as a planted fault;
25. the sequence-sharded forward and decode of ROADMAP A.18.8
   (``seq_shard_phase``; a virtual mesh of ``SEQ_SHARDS`` shards): (a)
   Mamba2-780m at full width, ``SEQ_CHECK_DEPTH`` layers, fp32, Mamba2's
   own decay init, 2 x 4096 tokens, sharded and unsharded - hidden states,
   CE loss and every grad leaf - against the plain path in fp64 by phase
   8's rule, and the planted faults of ``SEQ_FAULTS`` over their bars; (b)
   all 48 layers, bf16, one AdamW step on the training cell's first
   microbatch sharded and unsharded: the losses within ``LM_LOSS_RTOL``, B5
   96 launches both ways; (c) Qwen2-7B at full depth, 4 slots of a
   32768-row cache filled with random K/V rows: 8 greedy ticks through
   ``decode_attend_seq_sharded`` against the unsharded decode, bf16 timed
   (tick and device ms both ways) and its layer 0 attention output held
   within ``SEQ_LAYER0_ULPS`` bf16 ulps of the plain attend's, fp32's logits
   held to ``DECODE_BAR`` with the same tokens, a planted fault (the masks
   dropped) over each bar.  Phase 9 also times B5 at the
   sharded shape ``SSD_SHARDED_SHAPE``;
26. ``remat="dots"`` of ROADMAP A.18.9 (``remat_dots_phase``): Qwen2-7B at
   full width, ``DOTS_DEPTH`` layers, bf16, one microbatch of loss and grads
   under "none", "dots" and "full": "dots" bit for bit "none"'s, the peaks
   ordered none > dots > full, the saved tensors and bytes, B4 and B6
   launches (the recomputation included) as the code counts;
27. the captured training step and decode of ROADMAP A items 1 and 1b
   (``capture_train_step``, ``ServeEngine``'s graphs).  Each part runs
   where its cell's model already lies: (c) in every LM training cell of
   phases 7, 10 and 20-24(b) - which take ``CAPTURE_WARMUP`` of their 4
   steps as warmup, so the LR differs from step to step - the eager run's
   final state (``state_checksums``, per leaf) and losses are held bit for
   bit against the same run captured from a re-init from seed 0
   (``lm_capture_run``: two eager warm steps, one
   capture, replays), with the launches from the host (the warm steps and
   the capture: none while replaying) and the graph's (the code's per
   step), event and host step ms eager and replayed, the idle shares
   against the cell's profiled device work (a twin at a cut depth,
   ``CAPTURE_TRAIN_DEPTH``, has none), peaks and pool bytes
   (``{"capture_train": ...}``); (d) every
   serving drive of phases 19-24 decodes through the engine's graphs - B6
   counted as each graph's launches at its capture times its replays, none
   from the host - and ``decode_compare`` serves ``CAPTURE_DECODE_PROMPTS``
   through an eager and a captured engine, the last request admitted
   beside busy slots: the same tokens, tick ms, time to first token,
   graphs and pool bytes (``{"capture_decode": ...}``), and for Whisper
   C.18 on the card (idle slots ticked past the 8192-row position table, no
   device-side assert).  After phase 26: (a) phase 5's plan with int8 error
   feedback over ``CAPTURE_CNN_STEPS`` steps eager and captured - losses,
   params, momenta, counters and EF bit for bit, the graph's launches (24
   B1, 22 B2, 24 B3 a step) x replays, a planted stale step counter that
   the check must reject (``capture_cnn_phase``); (b) the training launcher
   under ``ELASTIC_CAPTURE_FAULTS`` (a drop that replans: a second graph; a
   failed step restored into the graph's state) against the same argv
   eager: the last checkpoints byte for byte (``capture_elastic_phase``);
   (e) the phase's and the run's seconds.  The ``{"kernels": ...}`` line's
   launches include phases 12's to 27's.
28. the dry run held against the card (``dryrun_phase``; ROADMAP A.19): (a)
   ``launch/dryrun.py``'s ``lower_train`` and ``_compile_stats`` of 27(c)'s
   Qwen2-7B cell on ``make_local_mesh`` (the step traced on CPU fake
   tensors): its argument bytes must equal the captured step's live state
   plus its batch, counted leaf by leaf on the card, and a dry run that
   leaves out the optimizer moments must fail that equality; the predicted
   bound on ``analysis/roofline.py:H100`` and the model FLOPs over the
   peak times the replayed step are printed beside 27(c)'s replayed step,
   capture and pool (``{"dryrun": {"train_cell": ...}}``); (b) the
   training cells of phases 7, 10 and 20-24 dry-run at no more than
   ``DRYRUN_CELL_DEPTH`` layers, one line each:
   supported, FLOPs and argument bytes a device, ``hbm_ok``, the dominant
   term (``{"dryrun": {"phase_cells": ...}}``; the whole 40-cell grid
   traces for longer than this phase may take).  Launches nothing.
29. one tile per process (``dist_phase``; ROADMAP A.20.1-A.20.4):
   phase 5's plan, then ``DIST_PLANS`` - phase 13's
   tpu-v5e-chip plan (overlap, crossover 14), phase 16's edge_auto int8
   plan, phase 14's cluster (spec) and its crossover-14 twin (padded),
   phase 15's pipe2x2 and pure1x4 (1x4) - in the same processes, on
   ``torch.distributed`` ranks spawned by
   ``parallel/dist.py:run_ranks`` (``dist_rank``, each through
   ``make_train_step`` on its block of the grid): (a) nccl at W = the cards
   - on one card each plan's params after every step bitwise its virtual
   run's (phases 13-16's runs are reused), B1-B3 launches the code's
   count; (b) ``DIST_WORLD`` gloo ranks sharing the card, one tile each,
   started cold (each rank builds B1-B3 into one fresh directory at once;
   all must load the same libraries): the params after 3 steps of every
   uncompressed plan within its phase's fp32-trainer bars, the
   int8 plan's step-1 grads within ``CODEC_BAR`` of its virtual run, every
   rank's params equal, a strip or hand-off taken from the wrong
   neighbour past the bar on every plan (``CODEC_BAR`` on the int8 plan);
   one line per rank and plan with its
   peak memory, launches (the rank's own count: its shape classes, its
   stages), collectives (count and bytes equal to
   ``analysis/collectives.py:plan_collectives`` at the rank's place, the
   model the CPU tests hold to the reference's compiled step) and step ms
   (staged through host memory: not a result); (c) nccl at ``DIST_WORLD``
   ranks where there are that many cards; (d) elastic training (ROADMAP
   A.20.2, elastic) in (a)'s, (b)'s and (c)'s processes after their plans
   (``elastic_rank``, ``elastic_held``): phase 18(b)-(c)'s schedule -
   the padded cluster plan under ``ELASTIC29_FAULTS`` (the Jetson dropped,
   a failed step restored from rank 0's checkpoint, a writer crash), then
   the original plan resuming the survivors' last checkpoint - through
   ``run_training`` on the ranks and the launcher's ``make_replan``: at one
   nccl rank every step's params and both last checkpoints bitwise phase
   18's runs; on ``DIST_WORLD`` gloo ranks ranks 0-2 at 1x3 while rank 3
   idles, the 7-step update within phase 18(c)'s bars, every active rank's
   params equal, a planted restore the other ranks skip past the bars;
   every rank's launches the code's count for its blocks and its driver's
   collectives ``driver_collectives``; one ``{"elastic29": ...}`` line
   (replan ms, restore read and broadcast ms, the first step after the
   replan, each rank's peak before and after, restarts and replans); (e)
   the step captured on nccl ranks (ROADMAP A.20.3; ``capture_rank``,
   ``capture_held``) in (a)'s and (c)'s processes: 27(a)'s cell (phase 5's
   plan, int8 EF, ``CAPTURE_CNN_STEPS``) eager, captured with the
   collectives inside the graph and captured with 27(a)'s planted stale
   counter, and ``launch/train.py``'s ``_train_tiled`` under 27(b)'s
   faults (a replan captured anew on the regrouped rank, a failed step
   restored into the graph's state) - at one rank every step bitwise the
   rank's eager run and 27(a)'s captured virtual run, the launcher's last
   checkpoint 27(b)'s byte for byte, the stale counter caught, the graph's
   B1-B3 launches (24 / 22 / 24 a step) x replays, the captured run's
   record (replays included) the eager run's and its exchanges
   ``plan_collectives``'; on 4 cards (c) each plan's step captured,
   bitwise its eager run on the ranks; one ``capture29<cell>_rank`` line a
   rank and the ``{"capture29": ...}`` line (replay and eager ms, pool);
   (f) the serve engine on the ranks of (a), (b) and (c) (ROADMAP A.20.4;
   ``serve_rank``, ``serve_held``): phase 17's ``SERVE29_PLANS`` (sync,
   hybrid+overlap) served phase 4's requests under ``SERVE29_CLOCK``, rank
   0 owning the queue and broadcasting each dispatch, the others
   following - at one nccl rank every bucket a graph and the responses
   phase 17's clock drive bit for bit, B1's graph launches x replays
   phase 17's; on 4 gloo ranks the eager forward within ``TOL_SERVE`` of
   the untiled reference and a follower serving a stale batch past it;
   everywhere the batch log phase 17's and every rank's collectives of the
   drive ``plan_collectives(forward_only=True)`` a dispatch plus
   ``dispatch_collectives``; one ``serve29<cell>_rank`` line a rank and
   plan and the ``{"serve29": ...}`` line.  The ranks' launches join the
   ``{"kernels": ...}`` line, B1-B3's also by plan ("elastic": 29(d)'s,
   "capture29": (e)'s, "serve29": (f)'s).

The last line is the contract's ``{"ok": true, "device": {...}}``; the
``{"kernels": [...]}`` line and the serve and train metrics come before it.
Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
INPUT_HW = (416, 416)
GRID = (2, 2)
BUCKETS = (1, 2, 4, 8)
ARRIVALS = (8, 5, 3, 8, 2, 1, 5)     # requests per tick: 32 in all
N_CONVS = 12                         # conv layers of the 16-layer prefix
PROFILE_EDGE_S = 0.25                # idle host time at each edge of a kernel-counting window
# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet), from the
# port's one hardware target (analysis/roofline.py:H100): fp32 on CUDA cores,
# HBM3 bandwidth, and (below) the dense bf16 tensor-core peak.
from repro_torch.analysis.roofline import H100, H100_FP32_PEAK_FLOPS  # noqa: E402

FP32_PEAK_FLOPS = H100_FP32_PEAK_FLOPS
HBM_BYTES_PER_S = H100.hbm_bw
TOL_FP32 = dict(atol=2e-5, rtol=1e-4)      # tests/test_kernels.py:22-23
TOL_BF16 = dict(atol=2e-3, rtol=2e-2)
# End to end, 12 fp32 convs whose sums run in another order in the kernel
# than in cuDNN, each followed by BN; the per-layer bar is TOL_FP32 above.
TOL_SERVE = dict(atol=1e-4, rtol=1e-4)
# wgrad sums ~1e5-1e6 products per element, in another order than the plain
# version, so it is held normwise: max |got - want| <= WGRAD_NORM_TOL *
# max |want|.  The training gradients are held the same way, per leaf.
WGRAD_NORM_TOL = 1e-3
TRAIN_LOSS_RTOL = 1e-5
# The whole-step gradients of 16 BN layers under an L2 loss to a near-zero
# target are ill-conditioned in fp32: BN's backward cancels most of a
# cotangent that is nearly the layer's own normalised output, and the plain
# fp32 reference itself lands ~1e-2 (normwise, per leaf) from an fp64
# evaluation of the same step.  So step 1's grads are held against the fp64
# reference: per leaf within max(WGRAD_NORM_TOL, GRAD_FLOOR_FACTOR x the
# plain fp32 reference's own error), i.e. no worse than twice what fp32 gives
# (measured: at most 1.05x on a leaf above the floor).  A wgrad that leaves
# out one tile must fail this check, and the script plants that fault to show
# it does.  The params after the last step are held the same way against an
# fp64 run of the trainer.  Distances from the fp32 reference are printed too.
GRAD_FLOOR_FACTOR = 2.0
# ONE_STEP_UPDATE_BAR.  A run of one step takes its params check from the
# step-1 gradient's bar: one SGD step from the seeded params is an
# elementwise map of those gradients (clip scale, lr, exact weight decay),
# and the fp32 trainer's own error after one step is a single rounding
# sample.  On the ill-conditioned BN-bias leaves that sample is heavy-tailed:
# four fp32 conv orders put the all-data plan's 10.bn_bias gradient 1.4e-3
# to 2.0e-2 from fp64 (on the CPU), and on the card the fp32 trainer's error
# there moved between runs with cuDNN's atomics, so a bar of twice it
# failed one run in four while the kernel path sat 1.2x from the untiled
# fp32 reference's own error.
# At each path shape B2's max |err| from an fp64 dgrad must be within this
# factor of the plain fp32 version's own (the two sum in other orders).
DGRAD_FP64_FACTOR = 2.0
# ROADMAP C.20: ``train_phase``'s bars rest on BAR_ORDERS fp32 summation
# orders of the torch-backend reference, not one draw: the images of every
# microbatch taken in a seeded order (``image_orders``; the first order the
# identity), under cuDNN's deterministic algorithms.  The math is the same
# in every order; the BN, loss and wgrad sums run in another.  A leaf's bar
# is GRAD_FLOOR_FACTOR x the largest of the orders' errors from fp64.
BAR_ORDERS = 4
TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS, TRAIN_LR = 8, 2, 3, 1e-3
# bf16 tensor-core peak (dense) of an H100 SXM: B4's bound in bf16
BF16_PEAK_FLOPS = H100.peak_flops
# LM phases: Qwen2-7B at full width, 12 of 28 layers (the deepest cut whose
# bf16 params, fp32 grad accumulators and fp32 AdamW moments fit 80 GB)
LM_ARCH, LM_DEPTH, LM_SEQ, LM_BATCH, LM_ACCUM, LM_STEPS = "qwen2-7b", 12, 2048, 4, 2, 4
# The step-1 loss of the bf16 run against a bf16 forward through the plain
# versions of B4 and B6: the two differ only in those two functions' bf16
# roundings, so a loss near ln(152064) ~ 11.9 agrees to far better than this.
LM_LOSS_RTOL = 1e-2
LM_GRAD_DEPTH = 2            # phase 8: full width, 2 layers, fp32 / fp64
FA_CASES = [                 # tests/test_kernels.py:30
    # b, tq, tk, hq, hkv, dh, causal, window, dtype
    (2, 128, 128, 4, 4, 64, True, None, "float32"),
    (1, 256, 256, 8, 2, 64, True, None, "float32"),      # GQA 4x
    (1, 256, 256, 4, 1, 128, True, 96, "float32"),       # MQA + window
    (2, 128, 128, 4, 4, 64, False, None, "float32"),     # bidirectional
    (1, 192, 192, 4, 2, 64, True, None, "float32"),      # non-pow2 T
    (1, 128, 128, 4, 4, 64, True, None, "bfloat16"),
    (1, 128, 256, 4, 4, 64, False, None, "float32"),     # cross-length
]
FA_BF16_EDGE_CASES = [       # the tensor-core instance's edges, bf16
    (1, 200, 200, 4, 2, 128, True, None),                # Dh 128, ragged Tq = Tk
    (1, 100, 300, 4, 2, 128, True, None),                # Tq < Tk
    (1, 512, 512, 14, 2, 128, True, 96),                 # window 96, GQA 7x
]
# At the LM shape in bf16, B4's max |err| from an fp64 evaluation of the
# plain version must be within this factor of the plain version's own (fp32
# math on the same bf16 inputs, output rounded to bf16: the output's own
# rounding sets that distance).
FA_FP64_FACTOR = 2.0
RMS_CASES = [                # tests/test_kernels.py:411
    ((4, 128, 512), "float32"),
    ((1000, 256), "float32"),
    ((2, 64, 1024), "bfloat16"),
    ((7, 384), "float32"),
]
# B6's instances off the path's widths (shape, x type, scale type, x's offset
# in elements from a 16-byte aligned base): a width that is not a multiple of
# the 16-byte vector and an unaligned base (the scalar instance), mixed types,
# and rows wider than a warp's registers (the stream instance)
RMS_EDGE_CASES = [
    ((33, 1000), "bfloat16", "bfloat16", 0),
    ((7, 100), "bfloat16", "bfloat16", 0),
    ((5, 384), "float32", "float32", 1),
    ((16, 1536), "bfloat16", "float32", 0),
    ((16, 1536), "float32", "bfloat16", 0),
    ((64, 3584), "bfloat16", "float32", 0),
    ((64, 3584), "float32", "bfloat16", 0),
    ((17, 70000), "bfloat16", "bfloat16", 0),
]
# B6 is timed cold too: over a rotation of distinct x buffers that together
# exceed the card's L2 this many times
L2_BYTES = 50 * 2**20
RMS_COLD_FACTOR = 4
# Mamba phases: Mamba2-780m at full width and full depth (48 layers), the
# repo's train_4k sequence length
MAMBA_ARCH, MAMBA_DEPTH, MAMBA_SEQ, MAMBA_BATCH, MAMBA_ACCUM, MAMBA_STEPS = \
    "mamba2-780m", 48, 4096, 4, 2, 4
MAMBA_GRAD_DEPTH, MAMBA_GRAD_SEQ = 2, 1024     # phase 11: 4 chunks of 256, one sequence
SSD_CASES = [                # tests/test_kernels.py:456: b, t, h, p, g, n, chunk
    (2, 128, 4, 16, 2, 8, 32),
    (1, 64, 2, 8, 1, 4, 64),
    (1, 256, 8, 32, 2, 16, 64),
]
SSD_SHORT_CASE = (2, 96, 4, 16, 1, 8, 256)     # T < chunk: one chunk of 96 (not a multiple of 64)
SSD_MODEL_SHAPE = (MAMBA_BATCH // MAMBA_ACCUM, MAMBA_SEQ, 48, 64, 1, 128, 256)
# Jamba-v0.1's SSD at phase 21's training microbatch: d_inner 8192 / head
# dim 64 = 128 heads, one group, d_state 16
SSD_JAMBA_SHAPE = (2, 2048, 128, 64, 1, 16, 256)
# SSD_FP64_RULE.  B5 is held to the fp32 bar (TOL_FP32) against its plain
# version, output by output.  An output that misses it is held against an
# fp64 evaluation of the plain version instead: its max |err| from fp64 must
# be within SSD_FP64_FACTOR x the plain fp32 version's own.  At the model
# shape the chunk's log-decay prefix reaches about -200, where one fp32 ulp
# is 1.5e-5, so two fp32 evaluations that sum the intra-chunk products in
# another order may each sit near the fp32 bar from the exact value; the
# rule then asks that B5 be no worse than twice what fp32 gives.  The line
# of each case says which rule held.
SSD_FP64_FACTOR = 2.0
# Phase 12: what the grouping cost model chooses for YOLOv2-16 (BN) at
# 416x416 on the 2x2 grid, batch 8, sync schedule, per registered profile
# (the JAX reference's choice too: tests/test_torch_grouping.py), and the
# profile whose plan is trained and served on the card
AUTO_GROUPS_416 = {
    "jetson-edge-100m": [(0, 7), (8, 11), (12, 15)],
    "jetson-nano-gpu": [(0, 11), (12, 15)],
    "pi3-core": [(0, 1), (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (12, 13), (14, 15)],
    "tpu-v5e-chip": [(0, 7), (8, 11), (12, 15)],
}
AUTO_HW = "jetson-nano-gpu"
# Phase 13: what the cost model plans with crossover="auto" beside
# groups="auto" (same stack, grid and batch): per profile the schedule it
# is planned under, the groups with their modes, and the crossover - the
# JAX reference's choice too (tests/test_torch_hybrid.py)
HYBRID_PLANS_416 = {
    "jetson-edge-100m": ("sync", [(0, 7, "spatial"), (8, 11, "spatial"), (12, 13, "spatial"),
                                  (14, 15, "data")], 14),
    "jetson-nano-gpu": ("sync", [(0, 15, "data")], 0),
    "pi3-core": ("sync", [(0, 1, "spatial"), (2, 3, "spatial"), (4, 5, "spatial"),
                          (6, 7, "spatial"), (8, 9, "spatial"), (10, 11, "spatial"),
                          (12, 13, "spatial"), (14, 15, "spatial")], None),
    "tpu-v5e-chip": ("overlap", [(0, 5, "spatial"), (6, 9, "spatial"), (10, 13, "spatial"),
                                 (14, 15, "data")], 14),
}
HYBRID_HW = "tpu-v5e-chip"
# the HYBRID_HW plan phase 13 trains and serves (and phase 29 runs on ranks)
HYBRID_KW = dict(groups="auto", hw=HYBRID_HW, batch=TRAIN_BATCH, microbatches=TRAIN_ACCUM,
                 crossover="auto", schedule="overlap")
# a hybrid plan splits every batch over the 4 tiles, so every bucket divides by 4
HYBRID_BUCKETS = (4, 8)
# scripts/check_overlap.py:90: the overlap schedule against the untiled
# reference (and here also against the sync plan), max |diff|
OVERLAP_TOL = dict(forward=1e-4, loss=1e-5, grads=1e-4)
# Phase 14: non-uniform tile partitions of YOLOv2-16 (BN) at 416x416 - name:
# (grid, groups, planner kwargs, the groups and modes planned).  "grid3": 416
# does not divide over 3, so the near-even split (144, 144, 128) -> ... ->
# (9, 9, 8); "cluster": the README's heterogeneous cluster on 2x2, the
# FLOPs-balanced (16, 400) split with groups="auto" (the launcher's batch
# and microbatches), and its crossover=14 hybrid twin.  The reference plans
# the same (tests/test_torch_ragged.py).
_CLUSTER_KW = dict(hw="pi3x3+jetson", batch=8, microbatches=2)
_PAIRS = [(s, s + 1, "spatial") for s in range(0, 16, 2)]
RAGGED_PLANS_416 = {
    "grid3": (3, [(0, 3), (4, 7), (8, 11), (12, 15)], {},
              [(0, 3, "spatial"), (4, 7, "spatial"), (8, 11, "spatial"), (12, 15, "spatial")]),
    "cluster": (2, "auto", _CLUSTER_KW, _PAIRS),
    "cluster_crossover": (2, "auto", dict(_CLUSTER_KW, crossover=14),
                          _PAIRS[:-1] + [(14, 15, "data")]),
}
# The code's launches per dispatch (B1) or microbatch (B1-B3) of those plans,
# from conv_shapes: spec one conv per shape class (4 on each plan) and conv,
# padded one per conv; the image input takes no dgrad.
RAGGED_LAUNCHES = {
    "grid3": {"spec": {"conv2d_tile": 48, "conv2d_dgrad_tile": 44, "conv2d_wgrad_tile": 48},
              "padded": {"conv2d_tile": 12, "conv2d_dgrad_tile": 11, "conv2d_wgrad_tile": 12}},
    "cluster": {"spec": {"conv2d_tile": 48, "conv2d_dgrad_tile": 44, "conv2d_wgrad_tile": 48},
                "padded": {"conv2d_tile": 12, "conv2d_dgrad_tile": 11, "conv2d_wgrad_tile": 12}},
    "cluster_crossover": {
        "spec": {"conv2d_tile": 42, "conv2d_dgrad_tile": 38, "conv2d_wgrad_tile": 42},
        "padded": {"conv2d_tile": 12, "conv2d_dgrad_tile": 11, "conv2d_wgrad_tile": 12}},
}
# Phase 15: pipeline tails of YOLOv2-16 without BN (stages hold no BN layer)
# at 416x416, batch 8, planned by the cost model on PIPELINE_HW with a forced
# stage count (pipeline="auto" picks no tail at 416 under any profile) - name:
# (grid, stages S, microbatches M, the groups and modes planned, the stages'
# flat tile ranges).  The reference plans the same
# (tests/test_torch_pipeline_mode.py).  M is the trainer's grad_accum.
PIPELINE_HW = "jetson-nano-gpu"
PIPELINE_PLANS_416 = {
    "pipe2x2": ((2, 2), 2, 2, [(0, 11, "spatial"), (12, 13, "pipeline"), (14, 15, "pipeline")],
                [(0, 2), (2, 4)]),
    "pipe1x4": ((1, 4), 4, 4, [(0, 7, "spatial"), (8, 9, "pipeline"), (10, 11, "pipeline"),
                               (12, 13, "pipeline"), (14, 15, "pipeline")],
                [(0, 1), (1, 2), (2, 3), (3, 4)]),
    "pure1x4": ((1, 4), 2, 2, [(0, 8, "pipeline"), (9, 15, "pipeline")], [(0, 2), (2, 4)]),
}
# The code's launches a microbatch of every pipeline plan (conv_shapes): the
# prefix one call a conv for all tiles, each stage one call a conv over its
# tiles' blocks, only the busy (stage, tick) slots run; the image input takes
# no dgrad.
PIPELINE_LAUNCHES = {"conv2d_tile": 12, "conv2d_dgrad_tile": 11, "conv2d_wgrad_tile": 12}


def pipeline_kw(stages: int, microbatches: int) -> dict:
    """Planner knobs of a phase-15 plan."""
    return dict(groups="auto", hw=PIPELINE_HW, batch=TRAIN_BATCH, pipeline=stages,
                microbatches=microbatches)


# Phase 16: wire codecs (DESIGN.md §12).  The whole-plan bar of
# tests/test_torch_wire_codec.py: a codec plan's output or gradient through
# B1-B3 within CODEC_BAR x the codec's own effect on the plain torch run
# (||kernel run - plain codec run|| <= CODEC_BAR x ||plain codec run - plain
# none run||, normwise per leaf), or the fp32 bar taken normwise where that
# is larger.  The planted decode fault multiplies the scales one tile decodes
# with by DECODE_FAULT_SCALE.
CODEC_BAR = 0.1
DECODE_FAULT_SCALE = 2.0
# The codec plan's step-1 loss against phase 5's uncompressed loss on the
# same batch (scripts/check_pipeline.py:490 holds int8 training to 1e-2).
WIRE_LOSS_RTOL = 1e-2
# name: (grid, plan kwargs, codec, steps, batch_norm); groups as (start,
# end, mode) tuples.  "sync2x2": phase 5's hand-picked groups; "hybrid_tpu":
# HYBRID_HW's overlap+hybrid plan of phase 13; "cluster_padded": phase 14's
# cluster plan under the padded executor; "pipe2x2": phase 15's plan;
# "edge_auto": groups and crossover planned under int8 on jetson-edge-100m,
# where the cheaper wire coarsens the plan.
WIRE_PLANS_416 = {
    "sync2x2": ((2, 2), dict(groups=[(0, 3, "spatial"), (4, 7, "spatial"), (8, 11, "spatial"),
                                     (12, 15, "spatial")]), "int8", TRAIN_STEPS, True),
    "hybrid_tpu": ((2, 2), dict(groups=HYBRID_PLANS_416[HYBRID_HW][1], schedule="overlap"),
                   "topk:0.5", 1, True),
    "cluster_padded": ((2, 2), dict(_CLUSTER_KW, groups=_PAIRS, ragged_exec="padded"), "int8", 1,
                       True),
    "pipe2x2": ((2, 2), dict(groups=PIPELINE_PLANS_416["pipe2x2"][3], hw=PIPELINE_HW,
                             batch=TRAIN_BATCH, microbatches=2), "int8", 1, False),
    "edge_auto": ((2, 2), dict(groups="auto", hw="jetson-edge-100m", batch=TRAIN_BATCH,
                               crossover="auto", microbatches=TRAIN_ACCUM), "int8", TRAIN_STEPS,
                  True),
}
WIRE_SERVE_BUCKETS = (4, 8)
# Phase 17: every plan an earlier phase serves, with its bucket ladder - name:
# (grid, make_yolo_tiled_arch kwargs, buckets); groups as (start, end) or
# (start, end, mode) tuples.  "sync" is phases 3-5's hand-picked plan,
# "nano_auto" phase 12's, "overlap" and "hybrid_overlap" phase 13's,
# "grid3_*" and "cluster_*" phase 14's, "edge_int8" phase 16's; "hybrid_topk"
# is phase 16's top-k plan (trained there), served here.
_HAND = [(0, 3), (4, 7), (8, 11), (12, 15)]
CAPTURE_PLANS_416 = {
    "sync": ((2, 2), dict(groups=_HAND), BUCKETS),
    "nano_auto": ((2, 2), dict(groups="auto", hw=AUTO_HW, batch=TRAIN_BATCH,
                               microbatches=TRAIN_ACCUM), BUCKETS),
    "overlap": ((2, 2), dict(groups=_HAND, schedule="overlap"), BUCKETS),
    "hybrid_overlap": ((2, 2), dict(groups="auto", hw=HYBRID_HW, batch=TRAIN_BATCH,
                                    microbatches=TRAIN_ACCUM, crossover="auto",
                                    schedule="overlap"), HYBRID_BUCKETS),
    "grid3_spec": ((3, 3), dict(groups=_HAND, ragged_exec="spec"), BUCKETS),
    "grid3_padded": ((3, 3), dict(groups=_HAND, ragged_exec="padded"), BUCKETS),
    "cluster_spec": ((2, 2), dict(_CLUSTER_KW, groups="auto", ragged_exec="spec"), BUCKETS),
    "cluster_padded": ((2, 2), dict(_CLUSTER_KW, groups="auto", ragged_exec="padded"), BUCKETS),
    "edge_int8": ((2, 2), dict(groups="auto", hw="jetson-edge-100m", batch=TRAIN_BATCH,
                               microbatches=TRAIN_ACCUM, crossover="auto", wire_codec="int8"),
                  WIRE_SERVE_BUCKETS),
    "hybrid_topk": ((2, 2), dict(groups=HYBRID_PLANS_416[HYBRID_HW][1], schedule="overlap",
                                 wire_codec="topk:0.5"), HYBRID_BUCKETS),
}

# Phase 18: elastic training (DESIGN.md §10).  Every run is YOLOv2-16 at
# 416 as phase 5 (fp32, BN, batch 8 in 2 microbatches, SGD at lr 1e-3, no
# warmup) under one cosine horizon of ELASTIC_STEPS steps: (a) phase 5's
# 2x2 sync plan, 4 steps uninterrupted, resumed after step 1 and restarted
# under ELASTIC_FAIL_FAULTS; (b) phase 14's padded cluster plan losing the
# Jetson at step 2 of 5 (ELASTIC_DROP_FAULTS) beside a fresh driver on the
# survivors' plan from the step-1 checkpoint; (c) the original cluster plan
# resuming the survivors' last checkpoint for the last 2 steps; (d) the
# reduced Qwen2-7B config with bf16 params, ELASTIC_LM_* (AdamW in place).
ELASTIC_STEPS = 7
ELASTIC_FAIL_FAULTS = "fail@2,ckpt-crash@1"
ELASTIC_DROP_FAULTS = "drop:jetson@2"
ELASTIC_LAUNCHER_FAULTS = "drop:jetson@1,slow:0.2@2,ckpt-crash@2,corrupt@3"
ELASTIC_LM_SEQ, ELASTIC_LM_BATCH, ELASTIC_LM_ACCUM, ELASTIC_LM_STEPS = 256, 4, 2, 4

# Phase 27: the captured training step and decode (ROADMAP A items 1, 1b).
# Every LM training cell (phases 7, 10, 20-24(b)) takes CAPTURE_WARMUP
# warmup steps of its 4, so the LR changes at every step but at the
# warmup's end, and its eager run is then held bit for bit against the same
# run captured (``lm_capture_run``, 27(c)); every served config's drive
# (phases 19-24) is captured, and ``decode_compare`` (27(d)) serves
# CAPTURE_DECODE_PROMPTS / CAPTURE_DECODE_NEW through an eager and a
# captured engine.  27(a) is phase 5's plan over CAPTURE_CNN_STEPS steps with
# int8 error feedback, its planted fault a stale step counter at
# CAPTURE_FAULT_STEP (a step whose LR differs from the one before); 27(b) the
# launcher under ELASTIC_CAPTURE_FAULTS (a drop: a new graph; a failed
# step: a restore into the graph's state).
CAPTURE_WARMUP = 3
CAPTURE_CNN_STEPS = 6
CAPTURE_FAULT_STEP = 4
CAPTURE_DECODE_PROMPTS = (6, 10, 4, 8, 6)
CAPTURE_DECODE_NEW = (4, 12, 12, 12, 6)     # request 4 takes request 0's slot beside 1-3
ELASTIC_CAPTURE_STEPS = 9
ELASTIC_CAPTURE_FAULTS = "drop:3@3,fail@6"
CHECKSUM_CHUNKS = 64
# 27(c)'s depth for the cells whose captured step does not fit the card at
# the cell's own depth (measured on an H100 80GB HBM3 at 700 W): a captured
# step peaked 0-6 GB above its eager twin; the captured CodeQwen1.5-7B ran
# out of memory at 17, 15 and (in one run of two) 14 layers, Command-R 35B
# at 3, Mixtral-8x22B at 3 (eager peak 68.7 GB) and Jamba-v0.1-52B at 5 (its
# eager twin at 4, two MoE layers as at 5, after it in the same process).
# The twins run at the depth given, beside the cell's eager run at its own;
# a depth that still does not fit steps down a layer.
# Mamba2-780m's twins take a cut too (12 of its 48 layers), for the run's
# time: the whole run must end inside its 1200 s on a slow host (one run on
# the card took 1237 s before the cuts here, at VL_TRAIN_DEPTH and at
# DRYRUN_CELL_DEPTH).  A replay's bits against eager do not depend on depth.
CAPTURE_TRAIN_DEPTH = {"codeqwen1.5-7b": 13, "command-r-35b": 2, "mixtral-8x22b": 2,
                       "jamba-v0.1-52b": 3, "mamba2-780m": 12}
# Phase 28(b) traces each training cell at no more than this many layers:
# the trace costs the host 0.15-0.5 ms an op, and the run's time is bounded
# as above (5 since phase 29(d) came: Jamba's attention layer, index 4, is
# the deepest kind of layer a cell holds).
DRYRUN_CELL_DEPTH = 5
CAPTURE_EXTRA_REPLAYS = 2       # timed replays past the compared steps (27(c))
# launches the captured runs' checks executed (warm steps + graphs x replays),
# by kernel: added to the kernels line
CAPTURED_LAUNCHES: dict = {}

# Phase 29: one tile per process (ROADMAP A.20.1).  Phase 5's plan (416, the
# hand-picked groups, batch 8 in 2 microbatches, SGD, 3 steps) on ranks of
# ``parallel/dist.py``: (a) nccl at W = the cards (1 on one card), bitwise the
# virtual mesh; (b) DIST_WORLD gloo ranks sharing the card, one tile each,
# cold: each rank builds DIST_COLD_LIBS into one fresh directory at once
# (DIST_WARM_LIBS copied in from this checkout's build: B3 alone keeps the
# run's time); (c) nccl at DIST_WORLD where the machine has that many cards.
DIST_WORLD = 4
DIST_COLD_LIBS = ("conv2d_wgrad_tile",)
DIST_WARM_LIBS = ("conv2d_tile", "conv2d_dgrad_tile")
# ... and after phase 5's plan, in the same processes, two more (ROADMAP
# A.20.2, uniform plans), each TRAIN_STEPS steps: phase 13's HYBRID_HW plan
# (the overlap schedule, crossover 14), held to phase 13's bars, and phase
# 16's edge_auto plan under int8 (groups and crossover by the cost model),
# its step-1 grads held at CODEC_BAR to phase 16's virtual-mesh runs; then
# four more (A.20.2, ragged partitions and pipeline tails): phase 14's
# cluster plan (spec) and its crossover=14 twin under the padded executor,
# held to phase 14's bars of the cluster's spec and padded plans, and phase
# 15's pipe2x2 and pure1x4 (on a 1x4 grid: at DIST_WORLD ranks its
# hand-off hops 2 blocks), held to phase 15's bars.  At one rank each is
# bitwise its virtual run; on DIST_WORLD ranks every rank's collectives
# equal ``analysis/collectives.py:plan_collectives`` at its coordinates.
# "grid" is the plan's tile grid where it is not GRID.
# ... and then 29(d), elastic training on the ranks (ROADMAP A.20.2,
# elastic): phase 18(b)-(c)'s schedule - the padded cluster plan losing the
# Jetson (ELASTIC_DROP_FAULTS), here with a failed step after the replan and
# a writer crash (ELASTIC29_FAULTS) and a checkpoint every
# ELASTIC29_CKPT_EVERY steps, so that the failed step's restore reaches back
# past the live state; then the original plan resuming the survivors' last
# checkpoint.  At one rank every step and both last checkpoints bitwise
# phase 18's; on DIST_WORLD ranks ranks 0-2 train at 1x3 while rank 3
# idles, the 7 steps held to phase 18(c)'s bars, and the same runs with a
# planted restore the other ranks skip (they keep their pre-failure state)
# past them.
ELASTIC29_FAULTS = ELASTIC_DROP_FAULTS + ",fail@3,ckpt-crash@1"
ELASTIC29_CKPT_EVERY = 2
DIST_PLANS = {"hybrid_tpu": HYBRID_KW, "edge_int8": dict(WIRE_PLANS_416["edge_auto"][1],
                                                          wire_codec="int8"),
              "cluster_spec": dict(_CLUSTER_KW, groups="auto", ragged_exec="spec"),
              "cluster_crossover_padded": dict(_CLUSTER_KW, groups="auto", crossover=14,
                                               ragged_exec="padded"),
              "pipe2x2": dict(pipeline_kw(2, 2), batch_norm=False),
              "pure1x4": dict(pipeline_kw(2, 2), batch_norm=False, grid=(1, 4))}
# ... and then 29(e), the step captured on nccl ranks (ROADMAP A.20.3): 27(a)'s
# cell and 27(b)'s launcher on the rank; 29(f), the serve engine on ranks
# (A.20.4): phase 17's SERVE29_PLANS (hybrid_overlap with the crossover's
# gathers inside its graphs) served phase 4's requests under one ManualClock,
# SERVE29_CLOCK = (tick s, a dispatch's service s, step bound s, latency
# budget s), chosen so that the sync ladder dispatches all four buckets;
# phase 17 serves its virtual engines under the same clock.
SERVE29_PLANS = ("sync", "hybrid_overlap")
SERVE29_CLOCK = (0.02, 0.01, 0.01, 0.035)

# Phase 19: LM serving (``lm_serve_phase``).  The slot engine at full width
# and full depth, bf16, seed-0 params: LM_SERVE_REQUESTS prompts of
# LM_SERVE_PROMPT tokens (numpy's default_rng(SEED)), LM_SERVE_NEW greedy
# tokens each over LM_SERVE_SLOTS slots, so slots recycle.  The checks at
# full width and 2 layers in fp32 (the depth convention of LM_GRAD_DEPTH):
# LM_SERVE_FORCED tokens teacher-forced through decode_step against the full
# forward, at the reference's own bar (DECODE_BAR, tests/test_attention.py:
# 94-96: the fp32 path sits far inside it, and the planted faults - a K/V
# row written one row late, a conv ring rolled one position, an SSM state
# never written back - land outside), and a request served beside others
# against the same request alone, bit for bit (both runs have the same
# 3-slot shapes, and each batch row is computed on its own).  B6 is held at
# the decode shapes: rows = slots.
LM_SERVE_ARCHS = ("qwen2-7b", "mamba2-780m")
LM_SERVE_SLOTS, LM_SERVE_MAX_SEQ, LM_SERVE_REQUESTS, LM_SERVE_NEW = 4, 256, 8, 32
LM_SERVE_PROMPT = (4, 64)                 # prompt lengths, inclusive
LM_SERVE_FORCED = 64
DECODE_BAR = dict(atol=2e-2, rtol=2e-2)
RMS_DECODE_ROWS = (1, 4, 8)
# Init's peak, beyond what was allocated before it, may exceed the params'
# bytes plus its largest fp32 draw (the embedding, or an MoE layer's expert
# tensor) by this factor: the streaming init (models/lm.py) casts each draw
# into its stacked row, and holds beside them a layer's undrawn leaves
# (norms, biases) until they are copied into theirs.
INIT_PEAK_SLACK = 1.05
# Phase 20: the three dense configs of ROADMAP A.18.2 (``dense_phase``) at
# their published widths, seed-0 params.  (a) The decode check of phase 19
# at 2 layers, fp32, with seeded noise of DENSE_NOISE on every bias and norm
# leaf (at init they are 0 and 1, which would hide the bias and LayerNorm
# branches) and one planted fault each (DENSE_FAULTS).  (b) Training as
# phase 7 at DENSE_TRAIN_DEPTH: StableLM whole; CodeQwen and Command-R at
# the deepest cut whose state fits 80 GB - bf16 params, fp32 gradient
# accumulators and AdamW moments, and the bf16 gradient tree of a
# microbatch, 16 bytes a param, beside the activations.  (c) Serving at full
# depth with CONFIG_SERVE_TRAFFIC.
DENSE_ARCHS = ("stablelm-1.6b", "codeqwen1.5-7b", "command-r-35b")
DENSE_TRAIN_DEPTH = {"stablelm-1.6b": 24, "codeqwen1.5-7b": 17, "command-r-35b": 3}
# The training cells whose step is not profiled, for the run's time (PR 36:
# processing a profiled step's trace cost a slow host 18.2 and 3.4 s here,
# and StableLM's 19.9 s, which pays for phase 29(e)-(f)).  Their step's
# breakdown is Qwen2-7B's kind (phase 7), a LayerNorm step's Whisper's
# (phase 24), and their kernels' launches are still held to the code's count
UNPROFILED_TRAIN = ("dense_train_stablelm-1.6b", "dense_train_codeqwen1.5-7b",
                    "dense_train_command-r-35b")
DENSE_TRAIN_STEPS = 4
DENSE_NOISE = 0.3
# the planted fault of each config's decode: decode rotates the whole head
# (ignores rope_pct), drops b_v (not b_k: a key bias shifts every logit of a
# query row alike, which softmax cannot see), or runs the sequential block
DENSE_FAULTS = {"stablelm-1.6b": "whole_head_rotary", "codeqwen1.5-7b": "no_b_v",
                "command-r-35b": "sequential_block"}
# Phase 21: the Mixture-of-Experts configs of ROADMAP A.18.3 (``moe_phase``)
# at their published widths, seed-0 params.  (a) The decode check of phase
# 19 in fp32 at MOE_CHECK_DEPTH (Jamba's 5 layers reach its attention layer
# at offset 4), batch 1 and LM_SERVE_FORCED tokens, so the forward's 64 x 2
# assignments take the dropless floor as every decode does; beside the
# logits it holds each attention layer's output (the mixer's, before the
# residual add: an MoE layer adds outputs in the hundreds to the residual,
# beside which a wrong attention output is small in the logits), and the
# planted faults (MOE_FAULTS) must take one of the two over the bar; and
# phase 19(c)'s beside-vs-alone check.  (b) Training as phase 7 with
# adafactor at MOE_TRAIN_DEPTH, the deepest cut whose state fits 80 GB at
# MOE_STATE_BYTES a param (bf16 params, fp32 gradient accumulators, the
# bf16 gradient tree of a microbatch; adafactor's factored statistics are
# small) beside the activations.  (c) Serving with CONFIG_SERVE_TRAFFIC at
# MOE_SERVE_DEPTH: Mixtral's deepest cut whose init peak (params plus the
# fp32 draw of one expert tensor, 3.22 GB) stays near 75 GB, Jamba's two
# whole periods (both attention layers).
MOE_ARCHS = ("mixtral-8x22b", "jamba-v0.1-52b")
MOE_CHECK_DEPTH = {"mixtral-8x22b": 2, "jamba-v0.1-52b": 5}
MOE_TRAIN_DEPTH = {"mixtral-8x22b": 3, "jamba-v0.1-52b": 5}
MOE_SERVE_DEPTH = {"mixtral-8x22b": 13, "jamba-v0.1-52b": 16}
MOE_TRAIN_STEPS = 4
MOE_OPTIMIZER = "adafactor"
MOE_STATE_BYTES = 8
MOE_FAULTS = {"mixtral-8x22b": ("unnormalised_topk", "next_expert"),
              "jamba-v0.1-52b": ("unnormalised_topk", "next_expert", "rope_on_attention")}
# B4 at Mixtral's heads where its window of 4096 masks (phase 6)
FA_WINDOW_SEQ = 8192
# Phases 23-24: Qwen2-VL-2B (ROADMAP A.18.5) and Whisper-medium (A.18.6) at
# full width and depth, seed-0 params.  Qwen2-VL trains on VL_SEQ tokens a
# sequence, of which the registry's max(4, T / 4) = 512 are patch
# embeddings; Whisper on VL_SEQ encoder frames and VL_SEQ / 4 decoder
# tokens; both 4 sequences in 2 microbatches (LM_BATCH, LM_ACCUM), bf16,
# remat full, AdamW, 3 steps.  The decode checks are fp32 at full depth.
VL_ARCH, WHISPER_ARCH = "qwen2-vl-2b", "whisper-medium"
# (b) trains a cut of the layers (Qwen2-VL 6 of 28, Whisper's decoder 4 of
# 24 beside its whole encoder), so the run ends inside its time on a slow
# host; (a) and (c) keep the full depth
VL_TRAIN_DEPTH = {VL_ARCH: 6, WHISPER_ARCH: 4}
VL_SEQ = 2048
VL_STEPS = 4
# Qwen2-VL's decode check: LM_SERVE_FORCED tokens, the first VL_GRID^2 of
# them an image's patch embeddings at one temporal position, its grid's
# rows and columns on the height and width streams, then text from the
# next position on (arXiv:2409.12191 §2.1), so the three streams differ
VL_GRID = 6
VL_FAULTS = ("sections_permuted", "h_w_swapped", "patches_not_substituted")
VL_FAULT_SECTIONS = (24, 24, 16)
# serving: VL_SERVE_REQUESTS text prompts of VL_SERVE_PROMPT tokens,
# VL_SERVE_NEW greedy tokens each (both configs)
VL_SERVE_REQUESTS, VL_SERVE_PROMPT, VL_SERVE_NEW = 4, (8, 24), 16
# The serving traffic of phases 20(c)-22(c): twice LM_SERVE_SLOTS prompts of
# VL_SERVE_PROMPT tokens, VL_SERVE_NEW new each, so the second half waits
# for freed slots as phase 19's traffic does, at shorter prompts and fewer
# new tokens.  A served token costs an eager decode call, prompt tokens
# included: phase 19's traffic held phases 20-22 to 243 s of a 1116-s run
# on a slow host.
CONFIG_SERVE_TRAFFIC = (2 * LM_SERVE_SLOTS, VL_SERVE_PROMPT, VL_SERVE_NEW)
# Whisper's decode check: LM_SERVE_FORCED tokens against WHISPER_CHECK_FRAMES
# encoder frames; its planted faults on the decode side
WHISPER_CHECK_FRAMES = 2048
WHISPER_FAULTS = ("cross_kv_from_decoder_state", "encoder_causal", "sinusoid_dropped")
# phase 6: B4 at phases 23-24's training shapes (b, tq, tk, hq, hkv, dh, causal)
FA_VL_WHISPER_SHAPES = [
    (LM_BATCH // LM_ACCUM, VL_SEQ, VL_SEQ, 12, 2, 128, True),             # Qwen2-VL
    (LM_BATCH // LM_ACCUM, VL_SEQ, VL_SEQ, 16, 16, 64, False),            # Whisper encoder
    (LM_BATCH // LM_ACCUM, VL_SEQ // 4, VL_SEQ // 4, 16, 16, 64, True),   # decoder
    (LM_BATCH // LM_ACCUM, VL_SEQ // 4, VL_SEQ, 16, 16, 64, False),       # cross
]
# Phase 22: DeepSeek-V3-671B of ROADMAP A.18.4 (``deepseek_phase``) at its
# published widths, seed-0 params.  One MoE layer (256 experts of 3 x 7168 x
# 2048, a shared expert and MLA) holds 11.51 B params, over the card at
# adafactor's 8 bytes a param on its own.  (a) The decode check of phase 21
# in fp32 at DS_CHECK_DEPTH (3 dense layers and the first MoE layer, no MTP:
# 60.4 GB), batch 1 and LM_SERVE_FORCED tokens (64 x top-8 = 512
# assignments: dropless), logits and MLA outputs within DECODE_BAR, the
# planted faults DS_FAULTS on the decode side, beside vs alone.  (b)
# Training as phase 21 with adafactor at DS_TRAIN_DEPTH (``with_depth(cfg,
# 0)``: the dense prefix, MLA on every layer, the MTP head on a dense layer:
# 4.29 B params), the step-1 loss's main CE and MTP term apart, a planted
# "MTP term dropped" that the loss check must reject, and the modeled state
# of layer 4 (an MoE layer) beside the card; ``mla_attention``'s gradients
# alone at full width (DS_GRAD_SEQ tokens, fp32 through B6 against plain
# fp64, phase 8's bar rule) with a planted fault.  (c) Serving with phase
# 19's traffic at DS_SERVE_DEPTH with the MTP head the launcher's config
# draws (26.7 B params, 53.4 GB); a tick reads every weight but the MTP
# head's and the embedding table.  (d) Both launchers with the id.
DS_ARCH = "deepseek-v3-671b"
DS_CHECK_DEPTH, DS_TRAIN_DEPTH, DS_SERVE_DEPTH = 4, 3, 4
DS_TRAIN_STEPS = 4
DS_GRAD_SEQ = 2048
# the decode side's planted faults: q absorbed through w_uv in place of
# w_uk (the same shape at 128 / 128), k_pe written to the cache unrotated,
# the MoE layer's shared expert dropped
DS_FAULTS = ("absorbed_through_w_uv", "k_pe_unrotated", "no_shared_expert")
# Phase 25: the sequence-sharded Mamba2 forward and decode (ROADMAP A.18.8)
# on a virtual mesh whose sequence axis has SEQ_SHARDS shards.  (a) The
# check at SEQ_CHECK_DEPTH layers, fp32 / fp64, SEQ_CHECK_BATCH x MAMBA_SEQ
# tokens, and its planted faults: each shard's incoming state dropped, the
# conv's K-1 token halo zeroed, the hop's decay not applied.  (c) Qwen2-7B's
# decode at the length where the reference's dry run takes the sharded
# decode (src/repro/launch/dryrun.py:250), from caches filled with random
# K/V rows up to per-slot lengths in SEQ_DECODE_LEN (a prefill of 8192+
# tokens would take minutes in the eager forward), the last ones far enough
# from the end that every tick writes a row of its own.
SEQ_SHARDS = 4
SEQ_CHECK_DEPTH, SEQ_CHECK_BATCH = 4, 2
SEQ_FAULTS = ("incoming_state_dropped", "conv_halo_zeroed", "hop_decay_not_applied")
SEQ_DECODE_SLOTS, SEQ_DECODE_MAX_SEQ, SEQ_DECODE_TICKS = 4, 32768, 8
SEQ_DECODE_LEN = (8192, SEQ_DECODE_MAX_SEQ - SEQ_DECODE_TICKS - 1)
# bf16's bar at one layer, in ulps of each head's largest output
SEQ_LAYER0_ULPS = 4
# B5 at the sharded path's shape: 2 sequences x 4 shards of 1024 tokens
SSD_SHARDED_SHAPE = (MAMBA_BATCH // MAMBA_ACCUM * SEQ_SHARDS, MAMBA_SEQ // SEQ_SHARDS, 48, 64, 1,
                     128, 256)
# Phase 26: remat "dots" (ROADMAP A.18.9) on Qwen2-7B at full width, cut to
# DOTS_DEPTH layers so "none"'s activations fit beside the params
DOTS_DEPTH, DOTS_SEQ, DOTS_BATCH = 6, 2048, 2


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def ulp_ratio(got, want, dtype, ulps: int) -> float:
    """max |got - want| over ``ulps`` ulps of ``dtype`` at the largest
    |want| of each row (the last dim): a bar of the rounding of the output
    type, which rounding in the accumulator's order cannot cross near a
    zero element."""
    import torch

    top = want.float().abs().amax(-1, keepdim=True).clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(top))) * torch.finfo(dtype).eps
    return float(((got.float() - want.float()).abs() / (ulps * ulp)).max())


def err_stats(got, want, atol: float, rtol: float) -> tuple[float, float]:
    """(max |got - want|, max |got - want| / (atol + rtol |want|)); the
    second is <= 1 exactly when torch.testing-style closeness holds."""
    d = (got.float() - want.float()).abs()
    return float(d.max()), float((d / (atol + rtol * want.float().abs())).max())


def time_ms(fn, reps: int = 5, iters: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    by CUDA events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / iters)
    return statistics.median(out)


def graph_ms(fn, n: int = 20) -> float:
    """Device time (ms) of one ``fn()``: ``n`` calls captured in a CUDA graph,
    the graph replayed under CUDA events (``time_ms``), so the host's launch
    cost is left out."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    ms = time_ms(graph.replay, reps=5, iters=3) / n
    del graph
    return ms


def conv_shapes(plan, batch: int, rank=None) -> list[dict]:
    """The conv calls the executor hands the backend for a batch of
    ``batch`` images, in order, each one kernel launch: all n*m tiles in one
    call, each input carrying the halo present at that layer.  Under the
    overlap schedule a group lead with a halo makes one call per piece of
    ``split_1d``'s split (interior, the interior rows' left and right
    strips, the top and bottom bands), or one on the whole extended tile
    where it has no interior; a data-mode layer one call over the batch's
    full maps, padded.  A ragged plan's spatial layer makes one call over
    every tile at the canonical extent (``ragged_exec="padded"``) or one
    per tile-shape class over its tiles' true extents (``"spec"``, the
    classes of ``core/halo.py:_switch_by_size``).  A pipeline stage's layer
    makes one call a microbatch over its tiles' blocks of full maps, which
    together are the microbatch (``core/fusion.py:_make_pipeline_local``),
    padded.  ``rank`` = (rank grid, coord): the calls of that rank of a
    run on ranks instead, over its block of the grid - its shape classes,
    its batch blocks, the stages it holds tiles of."""
    import torch

    from repro_torch.core.fusion import _pipeline_geometry, _ragged_group_geom, _stage_tiles
    from repro_torch.core.halo import _switch_by_size
    from repro_torch.core.spatial import split_1d
    from repro_torch.launch.mesh import DistTileMesh

    out = []
    mesh = None if rank is None else DistTileMesh(plan.n, plan.m, torch.device("cpu"), None,
                                                  *rank)
    held = 1 if mesh is None else (mesh.block[0] * mesh.block[1]) / (plan.n * plan.m)
    tiles = round(plan.n * plan.m * held) * batch
    for gi, g in enumerate(plan.groups):
        halo = plan.group_halos[gi]
        ragged = not plan.is_uniform and g.mode == "spatial"
        if ragged:
            geom = _ragged_group_geom(plan, gi)
            classes = _switch_by_size(plan.tile_rows[g.start], plan.tile_cols[g.start], mesh)
            cum = 1
        if g.mode == "pipeline":
            s = [x for x in plan.groups if x.mode == "pipeline"].index(g)
            here = len(_stage_tiles(plan, s, mesh))
            if not here:
                continue
            stage_batch = here * batch // _pipeline_geometry(plan)["per_stage"]
        for k, l in enumerate(g.layers):
            layer = plan.layers[l]
            k_, st, cin = layer.kernel, layer.stride, layer.in_channels
            sh, sw = plan.shard_hw[l]
            eh, ew = sh + halo[0] + halo[1], sw + halo[2] + halo[3]
            pieces = [("tile", (tiles, eh, ew))]
            if g.mode in ("data", "pipeline"):
                h, w = plan.map_hw[l]
                pieces = [("full" if g.mode == "data" else "stage",
                           (round(batch * held) if g.mode == "data" else stage_batch,
                            h + 2 * layer.padding, w + 2 * layer.padding))]
            elif ragged and plan.ragged_exec == "padded":
                pieces = [("padded", (tiles, *geom["ein"][k]))]
            elif ragged:
                top, bottom, left, right = geom["halos"][k]
                pieces = [(f"class_{r0}x{c0}", (len(t) * batch, top + r0 // cum + bottom,
                                                 left + c0 // cum + right))
                          for (r0, c0), t in classes]
                cum *= st
            elif plan.schedule == "overlap" and l == g.start and any(halo):
                rs = split_1d(sh, halo[0], halo[1], k_, st)
                cs = split_1d(sw, halo[2], halo[3], k_, st)
                if rs is None or cs is None:
                    pieces = [("whole", (tiles, eh, ew))]
                else:
                    mid_h = (rs.i1 - rs.i0) * st + k_
                    pieces = [("interior", (tiles, rs.int_in_hi - rs.int_in_lo,
                                            cs.int_in_hi - cs.int_in_lo))]
                    if cs.n_lo:
                        pieces.append(("mid_lo", (tiles, mid_h, (cs.i0 - 1) * st + k_)))
                    if cs.n_hi:
                        pieces.append(("mid_hi", (tiles, mid_h, (cs.out - 2 - cs.i1) * st + k_)))
                    if rs.n_lo:
                        pieces.append(("band_lo", (tiles, (rs.i0 - 1) * st + k_, ew)))
                    if rs.n_hi:
                        pieces.append(("band_hi", (tiles, (rs.out - 2 - rs.i1) * st + k_, ew)))
            if not layer.pool:
                out.extend(dict(layer=l, piece=piece, stride=st, x=(*x, cin),
                                w=(k_, k_, cin, layer.out_channels)) for piece, x in pieces)
            halo = plan.rem_halos[l]
    return out


def launches_per_batch(plan, batch: int, rank=None) -> tuple[dict, dict]:
    """The code's launch count of one forward and backward of a batch:
    (per kernel, B1's per tile instance).  One B1 and one B3 per conv call,
    one B2 per conv call whose input takes a gradient (every one but the
    first layer's, whose input is the image).  ``rank``: one rank's of a
    run on ranks (``conv_shapes``)."""
    from repro_torch.kernels.conv2d_tiled.kernel import fwd_tile

    calls = conv_shapes(plan, batch, rank)
    by_instance = {}
    for c in calls:
        tile = fwd_tile(c["w"][-1])
        by_instance[tile] = by_instance.get(tile, 0) + 1
    return ({"conv2d_tile": len(calls),
             "conv2d_dgrad_tile": sum(1 for c in calls if c["layer"] != 0),
             "conv2d_wgrad_tile": len(calls)}, by_instance)


def served_launches(label: str, engine, plan, host: int, host_by_instance: dict
                    ) -> tuple[int, dict]:
    """B1's launches in a serve drive: ``host`` (the wrapper's count over the
    drive, by tile instance in ``host_by_instance``) plus, for each captured
    bucket, its graph's launches (counted at the capture) times its replays.
    Checks the replays against the drive's dispatches by bucket, each
    graph's launches against the code's count (``launches_per_batch``) by
    tile instance, that a captured engine launched nothing from the host,
    and the total against the code's count times the dispatches.  The
    engine must be fresh from ``warmup``, so that every replay is the
    drive's."""
    stats = engine.stats()
    cap, census = stats["capture"], stats["bucket_census"]
    total, by_instance = host, {k: v for k, v in host_by_instance.items() if v}
    if engine.capture:
        check(host == 0, f"{label}: {host} B1 launches from the host in a captured drive")
        check(cap["replays"] == {b: census.get(b, 0) for b in cap["buckets"]},
              f"{label}: replays {cap['replays']} != dispatches by bucket {census}")
        for b in cap["buckets"]:
            per, per_instance = launches_per_batch(plan, b)
            want = {"conv2d_tile": per["conv2d_tile"],
                    **{f"conv2d_tile/{k}": v for k, v in per_instance.items()}}
            check(cap["launches"][b] == want,
                  f"{label}: bucket-{b} graph launches {cap['launches'][b]} != the code's {want}")
            total += per["conv2d_tile"] * cap["replays"][b]
            for k, v in per_instance.items():
                by_instance[k] = by_instance.get(k, 0) + v * cap["replays"][b]
    dispatches = sum(census.values())
    per, per_instance = launches_per_batch(plan, 1)
    want_instances = {k: v * dispatches for k, v in per_instance.items()}
    check(total == per["conv2d_tile"] * dispatches and total > 0,
          f"{label}: B1 launches {total} != {per['conv2d_tile']} x {dispatches} dispatches")
    check(by_instance == want_instances,
          f"{label}: B1 launches by instance {by_instance} != the code's {want_instances}")
    return total, by_instance


def run_serve_launcher(argv: list, plan) -> tuple[int, int, str]:
    """``python -m repro_torch.launch.serve`` on the card, its output printed:
    (B1 launches from the host, B1 launches its graphs replayed, the
    output).  Checks the host's launches against the warm runs and the
    capture of every bucket (``WARM_RUNS + 1`` forwards each), each graph's
    launches against the code's count and the replays against the
    dispatches the launcher reports."""
    from repro_torch.kernels.conv2d_tiled.kernel import conv2d_tile
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.serve.exec_cache import WARM_RUNS

    host0 = conv2d_tile.launches
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_launcher.main(argv)
    out = buf.getvalue()
    print(out, end="")
    check(rc == 0, f"serve launcher {argv} exited {rc}")
    host = conv2d_tile.launches - host0
    cap = json.loads(next(ln for ln in out.splitlines() if ln.startswith("capture: "))[9:])
    dispatches = int(re.search(r"over (\d+) dispatches", out).group(1))
    per = launches_per_batch(plan, 1)[0]["conv2d_tile"]
    check(cap["buckets"] and all(v["conv2d_tile"] == per for v in cap["launches"].values()),
          f"serve launcher graphs {cap['launches']} ({per} launches each)")
    check(sum(cap["replays"].values()) == dispatches,
          f"serve launcher replays {cap['replays']} != {dispatches} dispatches")
    check(host == (WARM_RUNS + 1) * per * len(cap["buckets"]),
          f"serve launcher host launches {host} != {WARM_RUNS + 1} x {per} x "
          f"{len(cap['buckets'])} buckets")
    replayed = sum(v["conv2d_tile"] * cap["replays"][b] for b, v in cap["launches"].items())
    return host, replayed, out


def conv_flops(x_shape, w_shape, stride: int) -> int:
    """Multiply-adds x 2 of one VALID conv - the same for its dgrad and
    wgrad, which pair the same products differently."""
    n, h, w, cin = x_shape
    k, _, _, cout = w_shape
    oh, ow = (h - k) // stride + 1, (w - k) // stride + 1
    return 2 * n * oh * ow * cout * k * k * cin


def bound(flops: int, nbytes: int) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of the fp32
    operations over the CUDA-core peak and the bytes (each input read once,
    each output written once) over HBM bandwidth."""
    t_ops, t_bytes = flops / FP32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def out_shape(x_shape, w_shape, stride: int) -> tuple:
    n, h, w, _ = x_shape
    k = w_shape[0]
    return (n, (h - k) // stride + 1, (w - k) // stride + 1, w_shape[-1])


def kernel_entry(name, source, replaces, rows, launches, err):
    """One entry of the ``{"kernels": ...}`` line: ``rows`` are the per-shape
    timings of the run's shapes, summed."""
    b = sum(r["bound_ms"] for r in rows)
    ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err,
        "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": b, "bound_by": "operations" if ops >= b - ops else "bytes",
        "library_ms": (None if any(r["library_ms"] is None for r in rows)
                       else sum(r["library_ms"] for r in rows)),
    }


def device_ms_by_name(prof, runs: int) -> dict:
    """Device time (ms per run) by kernel name from a profiler trace: device
    events only (kernels, copies, fills), since the host ops that launch
    them report the same time again."""
    import torch

    by_name = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3 / runs
    return by_name


def planted_faults(arch, params0, xs, ts, names, ref64, bars, normwise):
    """Phase 5's planted faults: the step-1 grad check (per-leaf bars
    ``bars`` against the fp64 reference grads ``ref64``) must reject a B3
    that drops one tile and a B2 that zeroes one tile's dx.  Returns each
    fault's err / bar per conv filter."""
    import repro_torch.kernels.conv2d_tiled.ops as conv_ops
    from repro_torch.core.fusion import make_deferred_grad_step
    from repro_torch.models.yolo import l2_loss_local
    from repro_torch.optim.optimizers import tree_leaves

    # The same check must reject a wrong backward: B3 leaving out one of the
    # 16 tile-images of a microbatch (tile (0, 0), image 0) fails it on
    # every conv filter.
    real_wgrad = conv_ops.conv2d_wgrad_tile

    def wgrad_dropping_one_tile(x, g, kernel, **kw):
        g = g.clone()
        g[0] = 0
        return real_wgrad(x, g, kernel, **kw)

    conv_ops.conv2d_wgrad_tile = wgrad_dropping_one_tile
    try:
        _, bad = make_deferred_grad_step(arch.plan, arch.mesh, l2_loss_local,
                                         microbatches=TRAIN_ACCUM)(
            params0, xs, ts)
    finally:
        conv_ops.conv2d_wgrad_tile = real_wgrad
    fault = {n: normwise(a, r) / bar for n, a, r, bar in zip(names, tree_leaves(bad), ref64, bars)
             if n.endswith(".w")}
    print(f"planted fault (B3 drops one tile): err / bar per conv filter, least "
          f"{min(fault.values()):.2f} ({min(fault, key=fault.get)})")
    check(len(fault) == N_CONVS and all(r > 1.0 for r in fault.values()),
          f"the step-1 grad check passed a wgrad that drops one tile: {fault}")

    # ... and a wrong B2: dx of one of the 16 tile-images (tile (0, 0), image
    # 0) zeroed fails it on every conv filter that a dgrad feeds, i.e. all
    # but the last conv's.
    real_dgrad = conv_ops.conv2d_dgrad_tile

    def dgrad_zeroing_one_tile(g, w, in_hw, **kw):
        dx = real_dgrad(g, w, in_hw, **kw)
        dx[0] = 0
        return dx

    conv_ops.conv2d_dgrad_tile = dgrad_zeroing_one_tile
    try:
        _, bad = make_deferred_grad_step(arch.plan, arch.mesh, l2_loss_local,
                                         microbatches=TRAIN_ACCUM)(
            params0, xs, ts)
    finally:
        conv_ops.conv2d_dgrad_tile = real_dgrad
    filters = [n for n in names if n.endswith(".w")]
    dfault = {n: normwise(a, r) / bar for n, a, r, bar in zip(names, tree_leaves(bad), ref64, bars)
              if n in filters[:-1]}
    print(f"planted fault (B2 zeroes one tile's dx): err / bar per conv filter upstream of a "
          f"dgrad, least {min(dfault.values()):.2f} ({min(dfault, key=dfault.get)})")
    check(len(dfault) == N_CONVS - 1 and all(r > 1.0 for r in dfault.values()),
          f"the step-1 grad check passed a dgrad that zeroes one tile: {dfault}")
    return fault, dfault


def planted_handoff_fault(arch, params0, xs, ts, names, ref64, bars, normwise, accum):
    """Phase 15's planted fault: a pipeline hand-off shifted one stage rank
    too far - each stage tile receives the block of the rank before its
    own, the first rank zeros - must fail the step-1 grad check on every
    conv filter.  (A mere permutation of the rank blocks would only pair
    samples with other targets, which this loss's 0.05-scale targets barely
    show.)  Returns err / bar per leaf."""
    import torch

    import repro_torch.core.fusion as fusion
    from repro_torch.models.yolo import l2_loss_local
    from repro_torch.optim.optimizers import tree_leaves

    real = fusion._stage_handoff
    per = (arch.plan.n * arch.plan.m) // len(arch.plan.stages)
    check(per > 1, "the hand-off fault needs two stage ranks")

    def handoff_to_the_wrong_rank(y, plan, s, wire=None):
        out = real(y, plan, s, wire).reshape(per, -1, *y.shape[1:])
        return torch.cat([torch.zeros_like(out[:1]), out[:-1]]).reshape(-1, *y.shape[1:])

    fusion._stage_handoff = handoff_to_the_wrong_rank
    try:
        _, bad = fusion.make_deferred_grad_step(arch.plan, arch.mesh, l2_loss_local,
                                                microbatches=accum)(params0, xs, ts)
    finally:
        fusion._stage_handoff = real
    fault = {n: normwise(a, r) / bar for n, a, r, bar in zip(names, tree_leaves(bad), ref64, bars)}
    over = sorted(n for n, v in fault.items() if v > 1.0)
    print(f"planted fault (hand-off to the wrong stage rank): {len(over)} of {len(fault)} leaves "
          f"over their bar, err / bar from {min(fault.values()):.2f} to {max(fault.values()):.2f}")
    filters = [n for n in names if n.endswith(".w")]
    check(all(fault[n] > 1.0 for n in filters),
          f"the step-1 grad check passed a hand-off to the wrong stage rank: {fault}")
    return fault


def image_orders(batch: int, accum: int) -> list:
    """``BAR_ORDERS`` orders of a batch's images, each a permutation within
    every one of its ``accum`` microbatches (so each microbatch holds the
    same images), drawn from numpy's ``default_rng([SEED, k])``; order 0 is
    the identity."""
    import numpy as np

    per = batch // accum
    out = [np.arange(batch)]
    for k in range(1, BAR_ORDERS):
        rng = np.random.default_rng([SEED, k])
        out.append(np.concatenate([i * per + rng.permutation(per) for i in range(accum)]))
    return out


def deterministic_cudnn():
    """cuDNN restricted to its deterministic algorithms (TF32 off, as phase
    3 sets it) for the duration of a ``with`` block."""
    import torch

    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                      allow_tf32=False)


def train_phase(dev, smi: str, plan_kw: dict, label: str = "train",
                plant_faults: bool = True, steps: int = TRAIN_STEPS, grid=GRID,
                accum: int = TRAIN_ACCUM, batch_norm: bool = True,
                orders_from: dict | None = None) -> dict:
    """Phases 5, 12, 13, 14 and 15: train YOLOv2-16 at 416x416 on the
    ``grid`` (2x2 unless given) through the three kernels for ``steps``
    steps of ``accum`` microbatches, under the plan
    ``make_yolo_tiled_arch(**plan_kw)`` gives.  Prints the ``{label: ...}``
    line; returns its numbers, with the launch count of each kernel in the
    training run under "launches".  A pipeline plan's slot census is held
    to ``pipeline_schedule_census`` and, with ``plant_faults``, its planted
    fault is the hand-off to the wrong stage rank.  "reference" holds the
    fp64 trainer's update, the initial params (both on the host) and the
    per-leaf bars, the run's param checksums after each step, and the
    step-1 gradients in fp64 with their bars: phase 29 holds its ranks to
    them.  ``orders_from``: an earlier run of the same
    stack on the same batches (phase 5's for phases 12, 13 and 14, the sync
    no-BN plan's for phase 15's pipelines), whose fp32 trainers in image orders
    1..BAR_ORDERS-1 the update bars reuse beside this plan's own order 0,
    instead of running BAR_ORDERS - 1 more fp32 trainers."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.fusion import pipeline_schedule_census, reference_loss
    from repro_torch.core.grouping import peak_device_memory
    from repro_torch.kernels.conv2d_tiled.kernel import (
        conv2d_dgrad_tile,
        conv2d_tile,
        conv2d_wgrad_tile,
        reset_launches,
    )
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.yolo import l2_loss_local, make_yolo_tiled_arch
    from repro_torch.optim.optimizers import make_optimizer, tree_leaves, tree_map
    from repro_torch.runtime.driver import DriverConfig, run_training
    from repro_torch.train.trainer import TrainState, make_train_step

    def make_arch(backend):
        return make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=grid[0], m=grid[1],
                                    backend=backend, device=dev, batch_norm=batch_norm, **plan_kw)

    arch = make_arch("cuda")
    print(f"{label}: grid {grid[0]}x{grid[1]}, schedule {arch.plan.schedule}, crossover "
          f"{arch.plan.crossover}, groups {[(g.start, g.end, g.mode) for g in arch.plan.groups]}, "
          f"group halos {list(arch.plan.group_halos)}, tile rows {arch.plan.tile_rows[0]} cols "
          f"{arch.plan.tile_cols[0]}, ragged_exec "
          f"{None if arch.plan.is_uniform else arch.plan.ragged_exec}, stages "
          f"{arch.plan.stages}, microbatches {accum}, batch_norm {batch_norm}")
    pcfg = ParallelConfig(grad_accum=accum)
    tcfg = TrainConfig(lr=TRAIN_LR, optimizer="sgd", warmup=0, steps=steps, seed=SEED)
    step1 = {}      # the run's own step-1 loss and gradients, as its update sees them

    def on_grads(step, loss, grads):
        if step == 0 and not step1:
            step1.update(loss=loss, grads=tree_leaves(grads))

    init_state, train_step = make_train_step(arch, pcfg, tcfg, on_grads=on_grads)
    make_batch = make_batch_fn(TRAIN_BATCH, INPUT_HW[0], arch.target_shape(TRAIN_BATCH), SEED, dev)

    # the main path: make_train_step under run_training, counts from 0
    events, logged, last, sums = [], [], {}, []

    def timed_step(state, batch):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = train_step(state, batch)
        b.record()
        events.append((a, b))
        logged.append(m)
        last["state"] = state
        # a host copy (pinned, queued behind the step), summed after the run
        sums.append(tree_map(lambda t: t.to("cpu", non_blocking=True), state.params))
        return state, m

    kernels = {"conv2d_tile": conv2d_tile, "conv2d_dgrad_tile": conv2d_dgrad_tile,
               "conv2d_wgrad_tile": conv2d_wgrad_tile}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for f in kernels.values():
        f.launches = 0
    reset_launches()
    report = run_training(init_state=init_state, train_step=timed_step, make_batch=make_batch,
                          steps=steps, cfg=DriverConfig(), seed=SEED)
    launches = {name: f.launches for name, f in kernels.items()}
    b1_instances = {k: v for k, v in conv2d_tile.launches_by_instance.items() if v}
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = [a.elapsed_time(b) for a, b in events]
    losses = [float(m["loss"]) for m in logged]
    gnorms = [float(m["grad_norm"]) for m in logged]
    census = getattr(train_step.grad_step, "census", None)
    micro = accum * steps
    per_mb, per_mb_instances = launches_per_batch(arch.plan, TRAIN_BATCH // accum)
    want = {k: v * micro for k, v in per_mb.items()}
    want_instances = {k: v * micro for k, v in per_mb_instances.items()}
    print(f"trained {report.steps_done} steps, restarts {report.restarts}, launches {launches} "
          f"(the code's count per microbatch {per_mb})")
    check(report.restarts == 0, f"restarts {report.restarts}")
    check(report.steps_done == steps and len(losses) == steps, "step count")
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)), f"losses {losses} gnorms {gnorms}")
    check(launches == want, f"launches {launches} != {want}")
    print(f"B1 launches by tile instance {b1_instances} (the code's count {want_instances})")
    check(b1_instances == want_instances,
          f"B1 launches by instance {b1_instances} != the code's {want_instances}")
    if arch.plan.stages:
        want_census = pipeline_schedule_census(len(arch.plan.stages), accum)
        print(f"pipeline slots of the last step {census} (census {want_census})")
        check(census == {"ticks": want_census["ticks"], "busy_slots": want_census["busy_slots"],
                         "prefix_passes": accum},
              f"pipeline slots {census} != the census {want_census}")

    # Step 1 of the run against the untiled plain reference from the same
    # params and batch: per-microbatch forward (BN statistics per
    # microbatch, as the deferred step takes them), cuDNN with TF32 off,
    # autograd, in fp32 and in fp64.  The two microbatches have equal
    # counts, so the deferred loss is the mean of their losses.
    params0 = init_state(SEED).params
    names = [f"{i}.{k}" for i, p in enumerate(params0) for k in p]
    ref_plan = dataclasses.replace(arch.plan, backend="torch")

    def split(v):
        return v.reshape(accum, v.shape[0] // accum, *v.shape[1:])

    b0 = make_batch(0)
    orders = image_orders(TRAIN_BATCH, accum)

    def reference(dtype, order=orders[0]):
        live = [{k: v.detach().to(dtype).requires_grad_(True) for k, v in p.items()}
                for p in params0]
        idx = torch.as_tensor(order, device=b0["x"].device)
        loss = sum(reference_loss(live, xm.to(dtype), tm.to(dtype), ref_plan, l2_loss_local)
                   for xm, tm in zip(split(b0["x"][idx]), split(b0["t"][idx]))) / accum
        grads = torch.autograd.grad(loss, tree_leaves(live))
        return float(loss.detach()), grads

    def normwise(a, b):
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    # Why the references run on cuDNN's deterministic algorithms (ROADMAP
    # C.20): the default ones sum in an order that changes from run to run,
    # so each bar's base, the fp32 reference's distance from fp64, did too
    # and a bar could not be reproduced.  On phase 14's padded cluster plan
    # 13.bn_bias's fp32 trainer error spans 0.0013-0.0051 under the default
    # algorithms, 0.003756 under the deterministic ones, and the port's
    # fixed 0.007106 sits at 0.95 of that bar: one summation order among
    # others of the same spread, not a less accurate kernel
    # (``chip_bar_probe.py``).  So each bar rests on BAR_ORDERS orders of the
    # images within each microbatch (the first the identity), not one.
    with deterministic_cudnn():
        ref_loss, ref32 = reference(torch.float32)
        _, ref64 = reference(torch.float64)
        by_order = [[normwise(a, b) for a, b in zip(ref32, ref64)]]
        for order in orders[1:]:
            by_order.append([normwise(a, b) for a, b in zip(reference(torch.float32, order)[1],
                                                            ref64)])
    plain64 = [max(e) for e in zip(*by_order)]
    bars = [max(WGRAD_NORM_TOL, GRAD_FLOOR_FACTOR * p) for p in plain64]
    bars_one = [max(WGRAD_NORM_TOL, GRAD_FLOOR_FACTOR * p) for p in by_order[0]]
    vs_plain = [normwise(a, b) for a, b in zip(step1["grads"], ref32)]
    tiled64 = [normwise(a, b) for a, b in zip(step1["grads"], ref64)]
    step1["loss"] = float(step1["loss"])
    loss_rel = abs(step1["loss"] - ref_loss) / abs(ref_loss)
    worst = max(range(len(names)), key=lambda i: tiled64[i] / bars[i])
    print(f"train step 1 vs untiled plain reference: loss {step1['loss']:.7g} vs {ref_loss:.7g} "
          f"(rel err {loss_rel:.2e}, bar {TRAIN_LOSS_RTOL}); grads vs the fp32 reference: max "
          f"normwise err {max(vs_plain):.2e}; vs fp64: tiled {max(tiled64):.2e}, plain fp32 "
          f"{max(plain64):.2e}; nearest its bar: {names[worst]} tiled {tiled64[worst]:.2e}, "
          f"plain {plain64[worst]:.2e}, {tiled64[worst] / bars[worst]:.2f} of its bar")
    spread = {n: [min(e), max(e)] for n, e in zip(names, zip(*by_order))}
    print(json.dumps({f"{label}_step1_bar_orders": {
        "orders": len(orders), "plain32_err_min_max": spread,
        "bar_one_order": dict(zip(names, bars_one)), "bar": dict(zip(names, bars)),
        "nearest": [names[worst], tiled64[worst], bars_one[worst], bars[worst]]}}))
    print(f"step-1 bars over {len(orders)} image orders: plain fp32 err from fp64 spans up to "
          f"{max(b / max(a, 1e-30) for a, b in spread.values()):.2f}x by order; nearest its bar "
          f"{names[worst]} {tiled64[worst]:.2e}, bar {bars[worst]:.2e} (one order "
          f"{bars_one[worst]:.2e})")
    check(step1["loss"] == losses[0], "on_grads saw another loss than the run logged")
    check(loss_rel <= TRAIN_LOSS_RTOL, f"step-1 loss rel err {loss_rel}")
    for n, t64, p64, bar in zip(names, tiled64, plain64, bars):
        check(t64 <= bar, f"step-1 grad {n}: normwise err {t64} vs fp64 over its bar {bar} "
              f"(plain fp32 reference {p64})")

    fault = dfault = None
    if plant_faults and arch.plan.stages:
        fault = planted_handoff_fault(arch, params0, split(b0["x"]), split(b0["t"]), names,
                                      ref64, bars, normwise, accum)
    elif plant_faults:
        fault, dfault = planted_faults(arch, params0, split(b0["x"]), split(b0["t"]), names,
                                       ref64, bars, normwise)
    del ref32

    # The trainer tail (clipping, schedule, SGD momentum and weight decay,
    # the microbatch accumulation) on the card: the run's params after all
    # steps against the same trainer on the torch backend, in fp64 and in
    # fp32, on the same batches.  Each leaf's update (params after - before)
    # is held normwise to the fp64 run, within max(WGRAD_NORM_TOL,
    # GRAD_FLOOR_FACTOR x the fp32 run's own error) - or, after a single
    # step, within the step-1 gradient's bar (ONE_STEP_UPDATE_BAR).
    def trainer_run(dtype, order=orders[0]):
        init, step = make_train_step(make_arch("torch"), pcfg, tcfg)
        p = tree_map(lambda t: t.to(dtype), init(SEED).params)
        st = TrainState(p, make_optimizer(tcfg.optimizer).init(p), 0)
        out = []
        for s in range(steps):
            batch = make_batch(s)
            idx = torch.as_tensor(order, device=batch["x"].device)
            st, m = step(st, {k: v[idx].to(dtype) for k, v in batch.items()})
            out.append(float(m["loss"]))
        return tree_leaves(st.params), out

    p0 = tree_leaves(params0)
    with deterministic_cudnn():
        fin64, losses64 = trainer_run(torch.float64)
    upd64 = [a.double() - b.double() for a, b in zip(fin64, p0)]

    def upd_err(fin):
        return [normwise(a.double() - b.double(), u) for a, b, u in zip(fin, p0, upd64)]

    # the fp32 trainer in BAR_ORDERS image orders (one after a single step,
    # whose bars are the step-1 gradients'); with ``orders_from``, this
    # plan's order 0 and that run's other orders
    own = orders[:1] if steps == 1 or orders_from is not None else orders
    with deterministic_cudnn():
        tail_by_order = [upd_err(trainer_run(torch.float32, order)[0]) for order in own]
    if orders_from is not None and steps > 1:
        tail_by_order += orders_from["reference"]["update_errs_by_order"][1:]
    tail = upd_err(tree_leaves(last["state"].params))
    tail32 = [max(e) for e in zip(*tail_by_order)]
    tail_bars = ([max(WGRAD_NORM_TOL, GRAD_FLOOR_FACTOR * e) for e in tail32] if steps > 1
                 else bars)
    if steps > 1:
        tail_one = [max(WGRAD_NORM_TOL, GRAD_FLOOR_FACTOR * e) for e in tail_by_order[0]]
        near = max(range(len(names)), key=lambda i: tail[i] / tail_bars[i])
        print(json.dumps({f"{label}_update_bar_orders": {
            "orders": len(tail_by_order),
            "fp32_trainer_err_min_max": {n: [min(e), max(e)]
                                         for n, e in zip(names, zip(*tail_by_order))},
            "bar_one_order": dict(zip(names, tail_one)), "bar": dict(zip(names, tail_bars)),
            "nearest": [names[near], tail[near], tail_one[near], tail_bars[near]]}}))
        print(f"update bars over {len(tail_by_order)} image orders: nearest its bar "
              f"{names[near]} {tail[near]:.2e}, bar {tail_bars[near]:.2e} (one order "
              f"{tail_one[near]:.2e}: {tail[near] / tail_one[near]:.2f} of it)")
    loss64_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, losses64))
    worst = max(range(len(names)), key=lambda i: tail[i] / tail_bars[i])
    print(f"params after {steps} steps vs the torch-backend trainer in fp64: update err max "
          f"{max(tail):.2e} (fp32 trainer {max(tail32):.2e}); bars from "
          f"{'the fp32 trainer' if steps > 1 else 'the step-1 gradients'}; nearest its bar: "
          f"{names[worst]} "
          f"{tail[worst]:.2e}, {tail[worst] / tail_bars[worst]:.2f} of its bar; losses rel err "
          f"{loss64_rel:.2e}")
    check(loss64_rel <= TRAIN_LOSS_RTOL, f"losses {losses} vs fp64 trainer {losses64}")
    for n, e, bar in zip(names, tail, tail_bars):
        check(e <= bar, f"param update {n} after {steps} steps: normwise err {e} over {bar}")
    step1_out = {"loss_rel_err": loss_rel, "grad_err_vs_plain32": max(vs_plain),
                 "grad_err_vs_fp64": max(tiled64), "plain32_err_vs_fp64": max(plain64),
                 "per_leaf": {n: [a, b, c] for n, a, b, c in zip(names, vs_plain, tiled64, plain64)},
                 "planted_fault_err_over_bar": fault, "planted_dgrad_fault_err_over_bar": dfault}
    after = {"update_err_vs_fp64": max(tail), "fp32_trainer_update_err_vs_fp64": max(tail32),
             "loss_rel_err_vs_fp64": loss64_rel,
             "per_leaf": {n: [a, b] for n, a, b in zip(names, tail, tail32)}}
    reference = dict(p0=[t.cpu() for t in p0], upd64=[u.cpu() for u in upd64], bars=tail_bars,
                     losses64=losses64, names=names, update_errs_by_order=tail_by_order,
                     checksums=[state_checksums(p) for p in sums],
                     grads64=[g.cpu() for g in ref64], step1_bars=bars)
    del fin64, upd64, ref64

    # where the device time of one step goes, by kernel name
    state = init_state(SEED)
    batch = make_batch(0)
    train_step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, batch)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_ms_by_name(prof, 1)
    dev_ms = sum(by_name.values())
    part = {name: sum(v for k, v in by_name.items() if key in k)
            for name, key in (("conv2d_tile", "conv2d_tile_"),          # partial and reduce
                              ("conv2d_dgrad_tile", "conv2d_dgrad_"),
                              ("conv2d_wgrad_tile", "conv2d_wgrad_"))}
    check(dev_ms > 0 and all(v > 0 for v in part.values()),
          f"profiler saw no device time for a kernel: {part}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    idle = max(0.0, 1 - dev_ms / prof_wall_ms)
    print(json.dumps({f"profile_{label}_step": {
        "wall_ms": prof_wall_ms, "device_ms": dev_ms, "idle_share": idle, "kernel_ms": part,
        "top": [[k[:80], v] for k, v in top],
    }}))
    # the cost model's working set of the JAX executor for this plan, per
    # tile (one device there), at the plan's batch; printed beside the
    # measured peak of all four tiles on the card, not held against it
    plan = arch.plan
    modeled = peak_device_memory(INPUT_HW, plan.layers, plan.groups, plan.n, plan.m,
                                 batch=TRAIN_BATCH, partition=plan.partition)
    med = statistics.median(step_ms)
    out = {
        "grid": list(grid), "tile_rows": list(plan.tile_rows[0]),
        "tile_cols": list(plan.tile_cols[0]),
        "ragged_exec": None if plan.is_uniform else plan.ragged_exec,
        "groups": [[g.start, g.end] for g in plan.groups],
        "modes": [g.mode for g in plan.groups], "schedule": plan.schedule,
        "crossover": plan.crossover,
        "group_halos": [list(h) for h in plan.group_halos],
        "steps": report.steps_done, "restarts": report.restarts,
        "stages": [list(x) for x in plan.stages], "pipeline_census": census,
        "batch_norm": batch_norm,
        "global_batch": TRAIN_BATCH, "microbatches": accum, "optimizer": "sgd",
        "lr": TRAIN_LR, "loss": losses, "grad_norm": gnorms,
        "step_ms_cuda_events": step_ms, "step_ms_cuda_events_median": med,
        "step_ms_host": [t * 1e3 for t in report.step_times],
        "step_ms_host_median": statistics.median(report.step_times) * 1e3,
        "img_per_s_cuda_events": TRAIN_BATCH / (med / 1e3),
        "device_ms": dev_ms, "device_ms_by_kernel": part, "idle_share": idle,
        "peak_mem_bytes": peak, "modeled_peak_device_memory_per_tile": modeled,
        "launches": launches, "b1_launches_by_instance": b1_instances,
        "launches_per_microbatch": per_mb, "step1": step1_out, "after_steps": after,
        "card": smi,
    }
    print(json.dumps({label: out}))
    out["reference"] = reference
    return out


def normwise_codec(got, plain_codec, plain_none, bar: float) -> tuple[float, float]:
    """(err, bar) of the whole-plan codec bar: ||got - plain_codec|| against
    max(bar ||plain_codec - plain_none||, the fp32 bar taken normwise)."""
    got, pc, pn = (t.detach().double() for t in (got, plain_codec, plain_none))
    err = float((got - pc).norm())
    fp32 = TOL_FP32["atol"] * math.sqrt(pc.numel()) + TOL_FP32["rtol"] * float(pc.norm())
    return err, max(bar * float((pc - pn).norm()), fp32)


def wire_run(dev, smi: str, arch, label: str, steps: int, accum: int) -> dict:
    """Phase 16: train ``arch`` (a codec plan or its none twin) for ``steps``
    steps of ``accum`` microbatches through B1-B3 as phase 5 does, then
    profile one step.  Returns its numbers, the step-1 loss and gradients
    (as the run's update saw them), the params' checksums after each step
    and the run's conv launches against the code's count."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.kernels.conv2d_tiled.kernel import (
        conv2d_dgrad_tile,
        conv2d_tile,
        conv2d_wgrad_tile,
        reset_launches,
    )
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    from repro_torch.runtime.driver import DriverConfig, run_training
    from repro_torch.train.trainer import make_train_step

    plan = arch.plan
    pcfg = ParallelConfig(grad_accum=accum)
    tcfg = TrainConfig(lr=TRAIN_LR, optimizer="sgd", warmup=0, steps=steps, seed=SEED)
    step1 = {}

    def on_grads(step, loss, grads):
        if step == 0 and not step1:
            step1.update(loss=float(loss), grads=[g.detach().clone() for g in tree_leaves(grads)])

    init_state, train_step = make_train_step(arch, pcfg, tcfg, on_grads=on_grads)
    make_batch = make_batch_fn(TRAIN_BATCH, INPUT_HW[0], arch.target_shape(TRAIN_BATCH), SEED, dev)
    events, logged, sums = [], [], []

    def timed_step(state, batch):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = train_step(state, batch)
        b.record()
        events.append((a, b))
        logged.append(m)
        # a host copy (pinned, queued behind the step), summed after the run
        sums.append(tree_map(lambda t: t.to("cpu", non_blocking=True), state.params))
        return state, m

    kernels = {"conv2d_tile": conv2d_tile, "conv2d_dgrad_tile": conv2d_dgrad_tile,
               "conv2d_wgrad_tile": conv2d_wgrad_tile}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for f in kernels.values():
        f.launches = 0
    reset_launches()
    report = run_training(init_state=init_state, train_step=timed_step, make_batch=make_batch,
                          steps=steps, cfg=DriverConfig(), seed=SEED)
    launches = {name: f.launches for name, f in kernels.items()}
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(m["loss"]) for m in logged]
    per_mb, _ = launches_per_batch(plan, TRAIN_BATCH // accum)
    want = {k: v * accum * steps for k, v in per_mb.items()}
    print(f"{label}: codec {plan.wire_codec}, schedule {plan.schedule}, crossover "
          f"{plan.crossover}, groups {[(g.start, g.end, g.mode) for g in plan.groups]}, stages "
          f"{plan.stages}, tile rows {plan.tile_rows[0]}; trained {report.steps_done} steps, "
          f"losses {losses}, conv launches {launches} (the code's {want})")
    check(report.restarts == 0 and report.steps_done == steps, f"{label}: run {report}")
    check(all(np.isfinite(losses)), f"{label}: losses {losses}")
    check(launches == want, f"{label}: conv launches {launches} != the code's {want}")
    check(step1["loss"] == losses[0], f"{label}: on_grads saw another loss than the run logged")

    # one step under the profiler: device work, device kernels, idle share
    state = init_state(SEED)
    batch = make_batch(0)
    train_step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_ms_by_name(prof, 1)
    dev_ms = sum(by_name.values())
    kernel_events = sum(e.count for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
    check(dev_ms > 0, f"{label}: the profiler saw no device time")
    step_ms = [a.elapsed_time(b) for a, b in events]
    return {
        "codec": plan.wire_codec, "grid": [plan.n, plan.m], "schedule": plan.schedule,
        "crossover": plan.crossover, "groups": [[g.start, g.end, g.mode] for g in plan.groups],
        "stages": [list(s) for s in plan.stages], "ragged_exec": None if plan.is_uniform
        else plan.ragged_exec, "steps": steps, "microbatches": accum, "loss": losses,
        "step_ms_cuda_events": step_ms, "step_ms_cuda_events_median": statistics.median(step_ms),
        "step_ms_host_median": statistics.median(report.step_times) * 1e3,
        "device_ms": dev_ms, "profiled_wall_ms": wall_ms,
        "idle_share": max(0.0, 1 - dev_ms / wall_ms), "device_kernels_per_step": kernel_events,
        "peak_mem_bytes": peak, "conv_launches": launches,
        "conv_launches_per_microbatch": per_mb, "card": smi,
        "_step1": step1, "_checksums": [state_checksums(p) for p in sums],
    }


def plain_grads(arch, codec: str, accum: int):
    """Step 1's loss and gradients of ``arch``'s plan under ``codec`` on the
    plain torch versions (cuDNN, TF32 off, autograd) on the card, from the
    seeded params and batch 0 - the run's own update's inputs."""
    import dataclasses as dc

    from repro_torch.core.fusion import make_deferred_grad_step
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.optim.optimizers import tree_leaves

    plan = dc.replace(arch.plan, backend="torch", wire_codec=codec)
    b0 = make_batch_fn(TRAIN_BATCH, INPUT_HW[0], arch.target_shape(TRAIN_BATCH), SEED,
                       arch.mesh.device)(0)

    def split(v):
        return v.reshape(accum, v.shape[0] // accum, *v.shape[1:])

    loss, grads = make_deferred_grad_step(plan, arch.mesh, arch.loss_local, microbatches=accum)(
        arch.init(SEED), split(b0["x"]), split(b0["t"]))
    return float(loss), tree_leaves(grads)


def codec_grad_check(arch, accum: int, got, bar: float, what: str, plain=None):
    """Every leaf of ``got`` (step-1 gradients) against the plain codec run
    at the whole-plan bar; -> (per-leaf err / bar, plain runs)."""
    names = [f"{i}.{k}" for i, p in enumerate(arch.init(SEED)) for k in p]
    if plain is None:
        plain = (plain_grads(arch, arch.plan.wire_codec, accum)[1],
                 plain_grads(arch, "none", accum)[1])
    ratios = {}
    for n, g, pc, pn in zip(names, got, *plain):
        err, b = normwise_codec(g, pc, pn, bar)
        ratios[n] = err / b
    worst = max(ratios, key=ratios.get)
    print(f"  {what}: step-1 grads vs the plain codec run, err / bar (bar {bar} x the codec's "
          f"effect) from {min(ratios.values()):.3g} to {ratios[worst]:.3g} ({worst})")
    return ratios, plain


def wire_phase(dev, smi: str, phase5_loss: float, held_b1: set, held_bwd: set, fwd_row, bwd_rows,
               calib, images):
    """Phase 16: wire codecs on the card (``WIRE_PLANS_416``): (a) the
    hand-picked 2x2 plan under int8 - its step-1 loss against phase 5's,
    its step-1 grads against the plain codec run at ``CODEC_BAR``, a planted
    decode-scale fault that check must reject, the EF carry across the
    microbatches and EF's telescoping on one recorded exchange; (b) one step each of the hybrid (top-k), padded cluster and
    pipe2x2 plans; (c) the jetson-edge-100m int8 plan trained and served on
    ``WIRE_SERVE_BUCKETS``, responses at ``CODEC_BAR`` against the plain
    codec forward; (d) both launchers with ``--wire-codec int8``; (e) B1-B3
    at every new per-tile shape (``fwd_row`` / ``bwd_rows``, phase 3's
    checks).  Every plan beside its none twin in the ``{"wire": ...}``
    line.  Returns (conv launches, B1, B2 and B3 rows of the new shapes,
    the edge_auto runs' checksums and step-1 grads for phase 29)."""
    import numpy as np
    import torch

    from repro_torch.core.tiling import Group
    from repro_torch.kernels.conv2d_tiled.kernel import (
        conv2d_dgrad_tile,
        conv2d_tile,
        conv2d_wgrad_tile,
        reset_launches,
    )
    from repro_torch.launch import train as train_launcher
    from repro_torch.models.yolo import make_yolo_tiled_arch

    def reset_counts():
        for f in (conv2d_tile, conv2d_dgrad_tile, conv2d_wgrad_tile):
            f.launches = 0
        reset_launches()

    def shape_key(s):
        return s["x"], s["w"], s["stride"]

    # (a)-(c): each plan under its codec beside its none twin (the same plan,
    # codec "none"), trained through B1-B3
    import repro_torch.core.fusion as fusion_mod
    import repro_torch.core.halo as halo_mod
    from repro_torch.core.grouping import PI3_PROFILE, PROFILES, modeled_step_wire_bytes
    from repro_torch.core.fusion import make_deferred_grad_step, make_tiled_infer
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.tiled_cnn import TiledCNNArch
    from repro_torch.optim.compression import WireCodec, ef_encode, get_codec
    from repro_torch.optim.optimizers import tree_leaves

    wire_runs, plans16, archs16 = {}, {}, {}
    wire_launches = {k: 0 for k in ("conv2d_tile", "conv2d_dgrad_tile", "conv2d_wgrad_tile")}
    for name, (grid16, kw16, codec16, steps16, bn16) in WIRE_PLANS_416.items():
        if not isinstance(kw16["groups"], str):
            kw16 = dict(kw16, groups=[Group(*g) for g in kw16["groups"]])
        a16 = make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=grid16[0], m=grid16[1],
                                   backend="cuda", device=dev, batch_norm=bn16, wire_codec=codec16,
                                   **kw16)
        twin = TiledCNNArch(plan=dataclasses.replace(a16.plan, wire_codec="none"),
                            mesh=a16.mesh, loss_local=a16.loss_local)
        hw16 = kw16.get("hw")
        prof16 = PROFILES.get(hw16, PI3_PROFILE) if isinstance(hw16, str) else PI3_PROFILE
        runs = {}
        for c, a in ((codec16, a16), ("none", twin)):
            r = wire_run(dev, smi, a, f"wire_{name}_{c}", steps16, TRAIN_ACCUM)
            r["modeled_step_wire_bytes"] = modeled_step_wire_bytes(
                INPUT_HW, a.plan.layers, a.plan.groups, a.plan.n, a.plan.m, prof16,
                batch=TRAIN_BATCH, wire_codec=c)
            for k in wire_launches:
                wire_launches[k] += r["conv_launches"][k]
            runs[c] = r
        rel = abs(runs[codec16]["loss"][0] - runs["none"]["loss"][0]) / abs(runs["none"]["loss"][0])
        print(f"wire {name}: step-1 loss {codec16} {runs[codec16]['loss'][0]:.7g} vs none "
              f"{runs['none']['loss'][0]:.7g} (rel {rel:.2e}, bar {WIRE_LOSS_RTOL}); device kernels "
              f"a step {runs[codec16]['device_kernels_per_step']} vs "
              f"{runs['none']['device_kernels_per_step']}")
        check(rel <= WIRE_LOSS_RTOL, f"wire {name}: step-1 loss rel {rel} over {WIRE_LOSS_RTOL}")
        wire_runs[name], plans16[name], archs16[name] = runs, a16.plan, a16

    # (a) the hand-picked 2x2 plan under int8: the step-1 loss against phase 5's
    # (the same plan, uncompressed, on the same batch), the step-1 grads
    # against the same codec plan on the plain versions, two planted faults
    # the same check must reject, and EF's telescoping on one exchange
    a16 = archs16["sync2x2"]
    r16 = wire_runs["sync2x2"]["int8"]
    rel5 = abs(r16["loss"][0] - phase5_loss) / abs(phase5_loss)
    print(f"wire sync2x2: int8 step-1 loss {r16['loss'][0]:.7g} vs phase 5's {phase5_loss:.7g} "
          f"(rel {rel5:.2e}, bar {WIRE_LOSS_RTOL})")
    check(rel5 <= WIRE_LOSS_RTOL, f"wire sync2x2: step-1 loss rel {rel5} vs phase 5")
    check(wire_runs["sync2x2"]["none"]["loss"][0] == phase5_loss,
          "the none twin's step-1 loss is not phase 5's")
    good16, plain16 = codec_grad_check(a16, TRAIN_ACCUM, r16["_step1"]["grads"], CODEC_BAR,
                                       "sync2x2 int8 run")
    check(all(v <= 1.0 for v in good16.values()),
          f"wire sync2x2: step-1 grads over the bar: {good16}")
    b0 = make_batch_fn(TRAIN_BATCH, INPUT_HW[0], a16.target_shape(TRAIN_BATCH), SEED, dev)(0)
    xs16 = b0["x"].reshape(TRAIN_ACCUM, -1, *b0["x"].shape[1:])
    ts16 = b0["t"].reshape(TRAIN_ACCUM, -1, *b0["t"].shape[1:])

    def faulty_grads():
        return tree_leaves(make_deferred_grad_step(a16.plan, a16.mesh, a16.loss_local,
                                                   microbatches=TRAIN_ACCUM)(
            a16.init(SEED), xs16, ts16)[1])

    # A dropped EF carry moves these grads by well under CODEC_BAR x the
    # codec's effect (the forward strips' stateless quantisation dominates
    # that effect at full width), so the carry is checked directly: the
    # second microbatch's bag hands out the first one's new residuals, one
    # per exchange, nonzero, and dropping them changes the grads (the
    # kernels give the same bits on a rerun, so any change is the carry's).
    bags = []

    class RecordingBag(halo_mod.EFBag):
        def __init__(self, mode="stateless", buffers=None):
            super().__init__(mode, buffers)
            bags.append(self)

    class DroppedCarry(halo_mod.EFBag):
        """Every microbatch's residuals start from zero again."""

        def take(self, shape, dtype=torch.float32, device=None):
            buf = super().take(shape, dtype, device)
            return torch.zeros_like(buf).requires_grad_(True) if self.mode == "buffers" else buf

    fusion_mod.EFBag = RecordingBag
    try:
        rerun16 = faulty_grads()
    finally:
        fusion_mod.EFBag = halo_mod.EFBag
    check([b.mode for b in bags] == ["collect", "buffers"] and len(bags[1].buffers)
          == len(bags[0].drawn) > 0 and all(bool(b.any()) for b in bags[1].buffers),
          f"the EF carry: bags {[(b.mode, len(b.drawn), len(b.buffers or ())) for b in bags]}")
    check(all(torch.equal(a, b) for a, b in zip(rerun16, r16["_step1"]["grads"])),
          "the kernel path's step-1 grads changed on a rerun")
    fusion_mod.EFBag = DroppedCarry
    try:
        dropped16 = faulty_grads()
    finally:
        fusion_mod.EFBag = halo_mod.EFBag
    names16 = [f"{i}.{k}" for i, p in enumerate(a16.init(SEED)) for k in p]
    moved16 = {n: float((a - b).norm() / b.norm()) for n, a, b in zip(names16, dropped16, rerun16)
               if float(b.norm()) > 0}
    carry16, _ = codec_grad_check(a16, TRAIN_ACCUM, dropped16, CODEC_BAR,
                                  "EF carry dropped (not held to the bar)", plain16)
    print(f"  EF carry: {len(bags[1].buffers)} residuals carried into microbatch 2; dropping them "
          f"moves the step-1 grads by {min(moved16.values()):.2e} to {max(moved16.values()):.2e} "
          f"(normwise, per leaf)")
    check(max(moved16.values()) > 0, "dropping the EF carry left the grads unchanged")
    del bags, rerun16, dropped16
    real_decode = WireCodec.decode

    def decode_perturbing_one_tile(self, payload, shape, dtype, tiles=0):
        if self.kind == "int8" and tiles >= 2:
            q, scale = payload
            scale = scale.clone()
            scale[0, 0] *= DECODE_FAULT_SCALE        # the scales tile (0, 0) decodes with
            payload = (q, scale)
        return real_decode(self, payload, shape, dtype, tiles)

    WireCodec.decode = decode_perturbing_one_tile
    try:
        scale16, _ = codec_grad_check(a16, TRAIN_ACCUM, faulty_grads(), CODEC_BAR,
                                      f"planted fault (one tile's decode scale x"
                                      f"{DECODE_FAULT_SCALE})", plain16)
    finally:
        WireCodec.decode = real_decode
    filters16 = [n for n in scale16 if n.endswith(".w")]
    check(all(scale16[n] > 1.0 for n in filters16),
          f"the step-1 grad check passed a perturbed decode scale: {scale16}")
    # EF telescopes on the card: one recorded exchange's backward strip,
    # sent T times against its own residual
    recorded = []
    real_ef = halo_mod.ef_encode

    def recording_ef(codec, ct, res, tiles=0):
        if not recorded:
            recorded.append(ct.detach().clone())
        return real_ef(codec, ct, res, tiles)

    halo_mod.ef_encode = recording_ef
    try:
        faulty_grads()
    finally:
        halo_mod.ef_encode = real_ef
    ct16 = recorded[0]
    res16, total16, T16 = torch.zeros_like(ct16), torch.zeros_like(ct16), 16
    int8 = get_codec("int8")
    for _ in range(T16):
        payload, res16 = ef_encode(int8, ct16, res16, 2)
        total16 += int8.decode(payload, ct16.shape, torch.float32, 2)
    tele = float((total16 - (T16 * ct16 - res16)).abs().max())
    tele_bar = 1e-4 * float(ct16.abs().max())          # tests/test_wire_codec.py's atol, scaled
    print(f"  EF telescoping on the card: strip {tuple(ct16.shape)}, {T16} sends, "
          f"max |sum applied - (T ct - res)| {tele:.3e} (bar {tele_bar:.3e})")
    check(tele <= tele_bar and float(res16.abs().max()) > 0, "EF does not telescope on the card")
    del plain16

    # (b) one step each of the other plans: their step-1 grads against the
    # same codec plan on the plain versions, printed (not held)
    grads16 = {"sync2x2": good16}
    for name in ("hybrid_tpu", "cluster_padded", "pipe2x2"):
        grads16[name], _ = codec_grad_check(archs16[name], TRAIN_ACCUM,
                                            wire_runs[name][plans16[name].wire_codec]["_step1"]["grads"],
                                            CODEC_BAR, f"{name} {plans16[name].wire_codec} run")

    # (c) the jetson-edge-100m int8 plan, trained above, served on (4, 8):
    # responses against the plain codec forward, at the whole-plan bar
    ea = archs16["edge_auto"]
    eparams = ea.serve_params(ea.init(SEED), calib)
    engine16 = ea.make_serve_engine(eparams, buckets=WIRE_SERVE_BUCKETS, step_bound=1.0,
                                    latency_budget=60.0)
    engine16.warmup()
    reset_counts()
    for im in images[:16]:
        engine16.submit(im)
    engine16.drain()
    check([b["bucket"] for b in engine16.batch_log] == [8, 8],
          f"edge_auto serve dispatches {engine16.batch_log}")
    serve16_launches, _ = served_launches("serve edge_auto", engine16, ea.serve_plan(),
                                          conv2d_tile.launches, conv2d_tile.launches_by_instance)
    got16 = torch.from_numpy(np.stack([r.result for r in sorted(engine16.finished,
                                                                 key=lambda r: r.rid)]))
    plain_fwd = {c: torch.cat([make_tiled_infer(dataclasses.replace(ea.serve_plan(), backend="torch",
                                                                     wire_codec=c), ea.mesh)(
        eparams, torch.from_numpy(images[i:i + 8]).to(dev)).cpu() for i in (0, 8)])
        for c in ("int8", "none")}
    serve_err16, serve_bar16 = normwise_codec(got16, plain_fwd["int8"], plain_fwd["none"], CODEC_BAR)
    print(f"wire edge_auto served 16 in {len(engine16.batch_log)} dispatches, {serve16_launches} B1 "
          f"launches; responses vs the plain int8 forward: err {serve_err16:.3e}, bar "
          f"{serve_bar16:.3e} ({serve_err16 / serve_bar16:.3g} of it)")
    check(bool(torch.isfinite(got16).all()) and serve_err16 <= serve_bar16,
          "edge_auto int8 responses over the whole-plan bar")
    wire_launches["conv2d_tile"] += serve16_launches
    del engine16, eparams, plain_fwd, got16

    # (d) both launchers with --wire-codec on the card
    reset_counts()
    out16 = io.StringIO()
    with contextlib.redirect_stdout(out16):
        rc16 = train_launcher.main([
            "--arch", "yolov2-tiled", "--grid", "2", "--groups", "4", "--wire-codec", "int8",
            "--input-hw", str(INPUT_HW[0]), "--depth", "16", "--batch", str(TRAIN_BATCH),
            "--grad-accum", str(TRAIN_ACCUM), "--steps", "1"])
    print(out16.getvalue(), end="")
    _, replayed16, out16s = run_serve_launcher(
        ["--cnn", "--size", str(INPUT_HW[0]), "--depth", "16", "--wire-codec", "int8",
         "--buckets", "4", "8", "--requests", "8", "--ticks", "2"],
        make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=2, m=2, backend="cuda", device=dev,
                             wire_codec="int8").serve_plan())
    check(rc16 == 0 and "wire_codec=int8" in out16.getvalue() and "wire_codec=int8" in out16s,
          "the launchers with --wire-codec int8")
    launcher16 = {f.__name__: f.launches for f in (conv2d_tile, conv2d_dgrad_tile,
                                                   conv2d_wgrad_tile)}
    launcher16["conv2d_tile"] += replayed16
    print(f"phase-16 launchers (--wire-codec int8): {launcher16}")
    for k in wire_launches:
        wire_launches[k] += launcher16[k]

    # (e) B1-B3 at every per-tile shape of the phase-16 plans no earlier
    # phase held
    new_tr16 = {shape_key(s): s for p in plans16.values()
                for s in conv_shapes(p, TRAIN_BATCH // TRAIN_ACCUM) if shape_key(s) not in held_bwd}
    new_fwd16 = {shape_key(s): s for s in conv_shapes(plans16["edge_auto"].inference_twin(), 8)
                 if shape_key(s) not in held_b1}
    print(f"phase 16 plans: {len(new_fwd16)} new bucket-8 forward shapes, {len(new_tr16)} new "
          f"training shapes")
    fwd16 = [dict(fwd_row(s), piece=s["piece"]) for k, s in {**new_fwd16, **new_tr16}.items()
             if k not in held_b1]
    bwd16 = [bwd_rows(s) for s in new_tr16.values()]
    dgrad16 = [d for d, _ in bwd16 if d]
    wgrad16 = [w for _, w in bwd16]
    kernel_ms16 = {}
    for rows16, what in ((fwd16, "conv2d_tile"), (dgrad16, "conv2d_dgrad_tile"),
                         (wgrad16, "conv2d_wgrad_tile")):
        kernel_ms16[what] = {k: sum(r[k] for r in rows16)
                             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        kernel_ms16[what]["shapes"] = len(rows16)
        print(f"{what} at the {len(rows16)} new phase-16 shapes: kernel "
              f"{kernel_ms16[what]['ms']:.4f} ms, cudnn {kernel_ms16[what]['library_ms']:.4f} ms, "
              f"plain {kernel_ms16[what]['plain_ms']:.4f} ms, bound "
              f"{kernel_ms16[what]['bound_ms']:.4f} ms")

    # (f) the {"wire": ...} line: each plan beside its none twin
    keep16 = ("codec", "grid", "schedule", "crossover", "groups", "stages", "ragged_exec", "steps",
              "loss", "step_ms_cuda_events", "step_ms_host_median", "device_ms",
              "profiled_wall_ms", "idle_share", "device_kernels_per_step", "peak_mem_bytes",
              "conv_launches_per_microbatch", "modeled_step_wire_bytes")
    print(json.dumps({"wire": {
        "train": {name: {c: {k: r[k] for k in keep16} for c, r in runs.items()}
                  for name, runs in wire_runs.items()},
        "step1_grads_err_over_bar": grads16,
        "planted_fault_decode_scale_err_over_bar": scale16,
        "ef_carry_dropped_err_over_bar": carry16, "ef_carry_dropped_moves_grads": moved16,
        "telescoping": {"strip": list(ct16.shape), "sends": T16, "max_abs_err": tele},
        "serve_edge_auto": {"buckets": list(WIRE_SERVE_BUCKETS), "err": serve_err16,
                            "bar": serve_bar16, "b1_launches": serve16_launches},
        "bars": {"codec": CODEC_BAR, "loss_rtol": WIRE_LOSS_RTOL},
        "kernel_ms_new_shapes": kernel_ms16,
        "card": smi,
    }}))
    print(json.dumps({"phase16_launches": wire_launches}))
    # phase 29 holds its ranks to the edge_auto runs: checksums, step-1 grads
    edge16 = {c: {"checksums": r["_checksums"],
                  "step1_grads": [g.cpu() for g in r["_step1"]["grads"]]}
              for c, r in wire_runs["edge_auto"].items()}
    del wire_runs, archs16
    torch.cuda.empty_cache()
    return wire_launches, fwd16, dgrad16, wgrad16, edge16


def serve_phase(dev, smi: str, arch, label: str, buckets, images, calib) -> dict:
    """Phase 13: serve the inference twin of ``arch``'s plan as phase 4
    does (step bound and budget from the measured bucket-8 dispatch), the
    32 requests against the untiled plain reference, launches (each
    captured graph's times its replays, ``served_launches``) against the
    code's count by tile instance.  Prints the ``{label: ...}`` line and
    returns its numbers."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.fusion import make_tiled_infer
    from repro_torch.core.spatial import stack_reference
    from repro_torch.kernels.conv2d_tiled.kernel import conv2d_tile, reset_launches
    from repro_torch.runtime.driver import run_serving

    plan = arch.serve_plan()
    params = arch.serve_params(arch.init(SEED), calib)
    infer = make_tiled_infer(plan, arch.mesh)
    x8 = torch.from_numpy(images[:8]).to(dev)
    fwd_ms = time_ms(lambda: infer(params, x8), reps=3, iters=3)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        infer(params, torch.from_numpy(images[:8]).to(dev)).cpu().numpy()
        walls.append(time.perf_counter() - t0)
    step_s = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            infer(params, x8)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    by_name = device_ms_by_name(prof, 3)
    dev_ms = sum(by_name.values())
    conv_ms = sum(v for k, v in by_name.items() if "conv2d_tile_" in k)
    check(dev_ms > 0 and conv_ms > 0, f"{label}: profiler saw no device time for the conv kernel")

    engine = arch.make_serve_engine(params, buckets=buckets, step_bound=step_s,
                                    latency_budget=2.0 * step_s)
    check(engine.warmup()["misses"] == len(buckets), f"{label} warmup misses")
    it = iter(images)

    def on_tick(t, eng):
        for _ in range(ARRIVALS[t]):
            eng.submit(next(it))

    reset_launches()
    report = run_serving(engine, ticks=len(ARRIVALS), on_tick=on_tick)
    per_dispatch, _ = launches_per_batch(plan, 1)
    launches, b1_instances = served_launches(label, engine, plan, conv2d_tile.launches,
                                             conv2d_tile.launches_by_instance)
    print(f"{label}: served {report.served} in {report.dispatches} dispatches, census "
          f"{report.bucket_census}, launches {launches} (by tile instance {b1_instances}; the "
          f"code's {per_dispatch['conv2d_tile']} a dispatch; captured graphs replayed "
          f"{report.capture['replays']}, pool bytes {report.capture['pool_bytes']})")
    check(report.served == len(images), f"{label} served {report.served}")
    with torch.inference_mode():
        ref = torch.cat([
            stack_reference(torch.from_numpy(images[i:i + 8]).to(dev), params, plan.layers,
                            inference=True).cpu()
            for i in range(0, len(images), 8)
        ])
    got = torch.from_numpy(np.stack([r.result for r in sorted(engine.finished, key=lambda r: r.rid)]))
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
          f"{label} output {tuple(got.shape)}")
    err, ratio = err_stats(got, ref, **TOL_SERVE)
    print(f"{label} output {tuple(got.shape)} vs untiled plain reference: max err {err:.3e} "
          f"({ratio:.3f} of tolerance {TOL_SERVE})")
    check(ratio <= 1.0, f"{label} responses disagree with the untiled reference")
    out = {
        "schedule": plan.schedule, "crossover": plan.crossover,
        "groups": [[g.start, g.end, g.mode] for g in plan.groups], "buckets": list(buckets),
        "p50_ms": report.p50_s * 1e3, "p99_ms": report.p99_s * 1e3,
        "img_per_s": report.throughput, "dispatches": report.dispatches,
        "bucket_census": report.bucket_census, "deadline_misses": report.deadline_misses,
        "bucket8_forward_ms": fwd_ms, "bucket8_dispatch_ms": step_s * 1e3,
        "bucket8_device_ms": dev_ms, "bucket8_conv_kernel_ms": conv_ms,
        "bucket8_idle_share": max(0.0, 1 - dev_ms / prof_wall_ms),
        "max_abs_err": err, "launches": launches, "launches_per_dispatch": per_dispatch["conv2d_tile"],
        "b1_launches_by_instance": b1_instances, "capture": report.capture, "card": smi,
    }
    print(json.dumps({label: out}))
    return out


def same_bits(got, want) -> bool:
    """Phase 17's check of a captured replay against the uncaptured forward:
    the same shape, dtype and bits."""
    import torch

    return got.shape == want.shape and got.dtype == want.dtype and bool(torch.equal(got, want))


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of ``fn()`` followed by a device synchronize."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def capture_phase(dev, smi: str, calib, images, step_s: float) -> tuple[int, dict]:
    """Phase 17: one CUDA graph per bucket.  (a) Every plan of
    ``CAPTURE_PLANS_416`` served through the engine's captured steps: on
    every bucket of its ladder the replay equals the uncaptured forward
    bitwise on a seeded input (``same_bits``), the graph's launches equal the
    code's count by tile instance, and the forward alone is timed on the
    host clock, eager against replayed; then ``SERVE29_PLANS``' engines
    serve phase 4's requests under ``SERVE29_CLOCK`` (``clock_drive``): the
    batch log, the responses' hashes and B1's graph launches x replays are
    what phase 29 holds its rank engines to; (b) phase 4's plan and 32 requests
    served by an uncaptured (``capture=False``) and a captured engine in
    this run, under phase 4's step bound: p50, p99, img/s, the bucket-1 and
    bucket-8 dispatch on the host clock (in turns), the host's copies in and
    out of the staging buffers alone, the profiler's device ms, idle share
    and B1 kernels of three bucket-8 dispatches, launches, replays and pool
    bytes; (c) the captured step after a swap of the params for another
    seed's, and after an in-place update of one leaf, equals the eager
    forward with them; (d) a planted fault, a replay that skips the copy
    into the static input, fails (a)'s check.  Prints the ``{"capture":
    ...}`` line; returns B1's launches of (b)'s two drives."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.core.fusion import make_tiled_infer
    from repro_torch.core.tiling import Group
    from repro_torch.kernels.conv2d_tiled.kernel import conv2d_tile, reset_launches
    from repro_torch.models.yolo import make_yolo_tiled_arch
    from repro_torch.runtime.driver import run_serving

    gen = torch.Generator(device=dev).manual_seed(SEED + 17)

    def arch_of(grid, kw):
        if not isinstance(kw["groups"], str):
            kw = dict(kw, groups=[Group(*g) for g in kw["groups"]])
        return make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=grid[0], m=grid[1],
                                    backend="cuda", device=dev, **kw)

    # (a) every served plan, every bucket: replay against the eager forward
    plans, clocked, launches = {}, {}, 0
    for name, (grid, kw, buckets) in CAPTURE_PLANS_416.items():
        arch = arch_of(grid, kw)
        plan = arch.serve_plan()
        params = arch.serve_params(arch.init(SEED), calib)
        engine = arch.make_serve_engine(params, buckets=buckets, step_bound=1.0,
                                        latency_budget=60.0)
        t0 = time.perf_counter()
        check(engine.capture and engine.warmup()["misses"] == len(buckets),
              f"capture {name}: warmup")
        warm_s = time.perf_counter() - t0
        cap = engine.stats()["capture"]
        check(cap["buckets"] == list(buckets), f"capture {name}: captured {cap['buckets']}")
        infer = make_tiled_infer(plan, arch.mesh)
        rows = {}
        for b in buckets:
            x = torch.randn((b, *INPUT_HW, 3), generator=gen, device=dev)
            step = engine.executable(b)
            got, want = step(params, x), infer(params, x)
            equal = same_bits(got, want)
            per, per_instance = launches_per_batch(plan, b)
            graph = {"conv2d_tile": per["conv2d_tile"],
                     **{f"conv2d_tile/{k}": v for k, v in per_instance.items()}}
            eager_ms = [host_ms(lambda: infer(params, x), 3)]
            replay_ms = [host_ms(lambda: step(params, x), 3)]
            replay_ms.append(host_ms(lambda: step(params, x), 3))
            eager_ms.append(host_ms(lambda: infer(params, x), 3))
            rows[b] = {"equal": equal, "max_abs_diff": float((got - want).abs().max()),
                       "pool_bytes": cap["pool_bytes"][b], "launches": cap["launches"][b],
                       "forward_host_ms_eager": statistics.median(eager_ms),
                       "forward_host_ms_replay": statistics.median(replay_ms)}
            print(f"capture {name} bucket {b}: replay == eager forward bitwise: {equal}; pool "
                  f"{cap['pool_bytes'][b]} B; graph launches {cap['launches'][b]}; forward on "
                  f"the host clock eager {rows[b]['forward_host_ms_eager']:.3f} ms, replayed "
                  f"{rows[b]['forward_host_ms_replay']:.3f} ms")
            check(equal, f"capture {name} bucket {b}: the replay differs from the eager forward "
                  f"(max |diff| {rows[b]['max_abs_diff']:.3e})")
            check(cap["launches"][b] == graph,
                  f"capture {name} bucket {b}: graph launches {cap['launches'][b]} != {graph}")
        plans[name] = {"grid": list(grid), "buckets": list(buckets), "warmup_s": warm_s,
                       "schedule": plan.schedule, "crossover": plan.crossover,
                       "ragged_exec": None if plan.is_uniform else plan.ragged_exec,
                       "wire_codec": plan.wire_codec, "by_bucket": rows}
        if name in SERVE29_PLANS:
            log = clock_drive(engine, images)
            b1 = sum(cap["launches"][b]["conv2d_tile"] for _, b, _ in log)
            clocked[name] = {"log": log, "hashes": response_hashes(engine), "b1_launches": b1}
            plans[name]["clock_drive"] = {"log": log, "b1_launches": b1}
            launches += b1
        del engine, arch, params, infer, step, got, want, x
        torch.cuda.empty_cache()

    # (b) phase 4's plan and requests, uncaptured and captured, in this run
    arch = arch_of(*CAPTURE_PLANS_416["sync"][:2])
    plan = arch.serve_plan()
    params = arch.serve_params(arch.init(SEED), calib)
    engines = {c: arch.make_serve_engine(params, buckets=BUCKETS, step_bound=step_s,
                                         latency_budget=2.0 * step_s, capture=c)
               for c in (False, True)}
    served = {}
    for c, engine in engines.items():
        label = "captured" if c else "uncaptured"
        check(engine.capture == c and engine.warmup()["misses"] == len(BUCKETS),
              f"capture (b) {label} warmup")
        it = iter(images)

        def on_tick(t, eng):
            for _ in range(ARRIVALS[t]):
                eng.submit(next(it))

        reset_launches()
        report = run_serving(engine, ticks=len(ARRIVALS), on_tick=on_tick)
        n, by_instance = served_launches(f"capture (b) {label}", engine, plan,
                                         conv2d_tile.launches, conv2d_tile.launches_by_instance)
        launches += n
        check(report.served == len(images) and report.cache["misses"] == len(BUCKETS),
              f"capture (b) {label}: served {report.served}, cache {report.cache}")
        served[label] = {
            "p50_ms": report.p50_s * 1e3, "p99_ms": report.p99_s * 1e3,
            "img_per_s": report.throughput, "dispatches": report.dispatches,
            "bucket_census": report.bucket_census, "deadline_misses": report.deadline_misses,
            "b1_launches": n, "b1_launches_by_instance": by_instance,
            "replays": report.capture["replays"], "pool_bytes": report.capture["pool_bytes"],
            "graph_launches": report.capture["launches"],
            "results": np.stack([r.result for r in sorted(engine.finished, key=lambda r: r.rid)]),
        }
    check(np.array_equal(served["captured"].pop("results"), served["uncaptured"].pop("results")),
          "capture (b): the captured engine's responses differ from the uncaptured engine's")

    def dispatch_ms(engine, b):
        for im in images[:b]:
            engine.submit(im)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.step(force=True)
        return (time.perf_counter() - t0) * 1e3

    turns = {(c, b): [] for c in ("uncaptured", "captured") for b in (1, 8)}
    for c in ("uncaptured", "captured", "captured", "uncaptured"):
        for b in (1, 8):
            turns[(c, b)] += [dispatch_ms(engines[c == "captured"], b) for _ in range(5)]
    # the engine's host copies of a bucket of 8 alone, and numpy's
    # single-threaded copies of the same bytes
    stage = torch.empty((8, *INPUT_HW, 3), pin_memory=True)
    out8 = torch.empty((8, *plan.out_hw(), plan.layers[-1].out_channels), pin_memory=True)

    def stage_torch():
        for i, im in enumerate(images[:8]):
            stage[i].copy_(torch.from_numpy(im))

    def stage_numpy():
        for i, im in enumerate(images[:8]):
            stage.numpy()[i] = im

    copies = {"stage_in_ms_torch": host_ms(stage_torch), "stage_in_ms_numpy": host_ms(stage_numpy),
              "copy_out_ms_torch": host_ms(lambda: out8.clone().numpy()),
              "copy_out_ms_numpy": host_ms(lambda: out8.numpy().copy())}
    # The profiler's count of B1 kernels is held exactly.  Late in a whole
    # run a bare window has lost one of the 36 (PERF.md PR 36).  The profiler
    # keeps a device event only if it falls inside the window on its host
    # clock, so a drift of the two clocks over a long process can drop an
    # event at an edge.  The window kept opens after one warm-up dispatch
    # and holds idle host time at both edges; the idle time is outside
    # ``wall``.  The kernels' earliest start after their launch call, on the
    # profiler's clocks, is kept too.
    for c, engine in engines.items():
        label = "captured" if c else "uncaptured"
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            dispatch_ms(engine, 8)          # the profiler's warm-up, not kept
            prof.step()
            reset_launches()
            time.sleep(PROFILE_EDGE_S)
            t0 = time.perf_counter()
            for _ in range(3):
                dispatch_ms(engine, 8)
            wall = (time.perf_counter() - t0) * 1e3 / 3
            torch.cuda.synchronize()
            time.sleep(PROFILE_EDGE_S)
            prof.step()
        by_name = device_ms_by_name(prof, 3)
        b1_events = {e.key: e.count for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "conv2d_tile_kernel<" in e.key}
        conv_events = sum(b1_events.values())
        events = prof.events()
        launch_us = {e.id: e.time_range.start for e in events
                     if e.device_type == torch.autograd.DeviceType.CPU and "Launch" in e.name}
        lags = [e.time_range.start - launch_us[e.id] for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "conv2d_tile_kernel<" in e.name and e.id in launch_us]
        dev_ms = sum(by_name.values())
        served[label].update({
            f"bucket{b}_dispatch_ms": statistics.median(turns[(label, b)]) for b in (1, 8)})
        served[label].update({
            "bucket8_device_ms": dev_ms, "bucket8_profiled_wall_ms": wall,
            "bucket8_idle_share": max(0.0, 1 - dev_ms / wall),
            "bucket8_idle_share_unprofiled": max(
                0.0, 1 - dev_ms / statistics.median(turns[(label, 8)])),
            "profiler_b1_kernels_3_dispatches": conv_events,
            "profiler_b1_min_launch_to_start_us": min(lags) if lags else None,
            "host_b1_launches_3_dispatches": conv2d_tile.launches,
        })
        want = 0 if c else 3 * N_CONVS
        check(conv2d_tile.launches == want, f"capture (b) {label}: {conv2d_tile.launches} host B1 "
              f"launches in 3 dispatches, not {want}")
        check(conv_events in (0, 3 * N_CONVS),
              f"capture (b) {label}: the profiler saw {conv_events} B1 kernels in 3 dispatches "
              f"({b1_events})")
    print(f"capture (b): {json.dumps(served)}; host copies alone {copies}")

    # (c) another seed's params, then an in-place update of one leaf
    step = engines[True].executable(8)
    infer = make_tiled_infer(plan, arch.mesh)
    x = torch.randn((8, *INPUT_HW, 3), generator=gen, device=dev)
    params2 = arch.serve_params(arch.init(SEED + 1), calib)
    rebinds = step.rebinds
    swap_ok = same_bits(step(params2, x), infer(params2, x))
    with torch.no_grad():
        params2[5]["w"].mul_(0.5)            # layer 5: a 1x1 conv
    inplace_ok = same_bits(step(params2, x), infer(params2, x))
    back_ok = same_bits(step(params, x), infer(params, x))
    print(f"capture (c): replay after a params swap == eager {swap_ok}, after an in-place update "
          f"{inplace_ok}, back to the first params {back_ok}; rebinds {step.rebinds - rebinds}")
    check(swap_ok and inplace_ok and back_ok and step.rebinds - rebinds == 3,
          "capture (c): a replay with new params differs from the eager forward")

    # (d) a planted fault: a replay that skips the copy into the static input
    x_new = torch.randn((8, *INPUT_HW, 3), generator=gen, device=dev)
    stale = step.replay(params)
    planted_caught = not same_bits(stale, infer(params, x_new))
    print(f"capture (d): a replay without the input copy rejected by (a)'s check: "
          f"{planted_caught} (it returns the previous input's bits: "
          f"{same_bits(stale, infer(params, x))})")
    check(planted_caught, "capture (d): the planted stale-input replay passed the check")
    print(json.dumps({"capture": {
        "plans": plans, "serve_phase4": served, "host_copies_bucket8": copies,
        "params_swap_equal": swap_ok, "params_in_place_equal": inplace_ok,
        "planted_stale_input_rejected": planted_caught, "card": smi,
    }}))
    del engines, step, arch, params, params2, infer
    torch.cuda.empty_cache()
    return launches, clocked


def overlap_vs_sync(dev, overlap_kw: dict, sync_kw: dict, grid=GRID,
                    names=("overlap", "sync")) -> dict:
    """Phase 13a: the overlap plan against the sync plan and the untiled
    plain reference on one microbatch of the training stream, same params:
    the training forward, the loss and its gradients, max |diff| each, held
    to ``OVERLAP_TOL`` (``scripts/check_overlap.py``'s bar).  Phase 14
    holds a spec plan against its padded twin the same way (``names``)."""
    import torch

    from repro_torch.core.fusion import (
        make_tiled_forward,
        make_tiled_loss,
        reference_forward,
        reference_loss,
    )
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.yolo import l2_loss_local, make_yolo_tiled_arch
    from repro_torch.optim.optimizers import tree_leaves

    mb = TRAIN_BATCH // TRAIN_ACCUM
    res = {}
    first, second = names
    for name, kw in ((first, overlap_kw), (second, sync_kw)):
        arch = make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=grid[0], m=grid[1],
                                    backend="cuda", device=dev, **kw)
        params = arch.init(SEED)
        batch = make_batch_fn(mb, INPUT_HW[0], arch.target_shape(mb), SEED, dev)(0)
        with torch.no_grad():
            y = make_tiled_forward(arch.plan, arch.mesh)(params, batch["x"])
        live = [{k: v.detach().requires_grad_(True) for k, v in p.items()} for p in params]
        loss = make_tiled_loss(arch.plan, arch.mesh, l2_loss_local)(live, batch["x"], batch["t"])
        grads = torch.autograd.grad(loss, tree_leaves(live))
        res[name] = (y, float(loss.detach()), grads)
        if name == second:
            plan = dataclasses.replace(arch.plan, backend="torch")
            live = [{k: v.detach().requires_grad_(True) for k, v in p.items()} for p in params]
            rloss = reference_loss(live, batch["x"], batch["t"], plan, l2_loss_local)
            rgrads = torch.autograd.grad(rloss, tree_leaves(live))
            with torch.no_grad():
                ry = reference_forward(params, batch["x"], plan)
            res["reference"] = (ry, float(rloss), rgrads)
    out = {}
    y_o, l_o, g_o = res[first]
    for other in (second, "reference"):
        y, l, g = res[other]
        d = {"forward": float((y_o - y).abs().max()), "loss": abs(l_o - l),
             "grads": max(float((a - b).abs().max()) for a, b in zip(g_o, g))}
        print(f"{first} vs {other}: max |diff| forward {d['forward']:.3e}, loss {d['loss']:.3e}, "
              f"grads {d['grads']:.3e} (bar {OVERLAP_TOL})")
        for k, bar in OVERLAP_TOL.items():
            check(d[k] <= bar, f"{first} vs {other}: {k} differs by {d[k]} > {bar}")
        out[other] = d
    return out


def attention_mask(tq: int, tk: int, causal: bool, window, device):
    """(Tq, Tk) bool: key positions a query attends to (both from 0)."""
    import torch

    qp = torch.arange(tq, device=device)[:, None]
    kp = torch.arange(tk, device=device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    return mask


def attn_norm_kernel_phase(dev) -> tuple[list, float, list, float]:
    """Phase 6: B4 and B6 against their plain versions on the card, at the
    LM run's shapes and on the CPU tests' edge cases; timing and bounds at
    the run's shapes.  Returns (B4 rows, B4 max err at the path's shape,
    B6 rows, B6 max err at the path's shape)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import fa_instance, flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.kernel import INSTANCES as RMS_INSTANCES
    from repro_torch.kernels.rmsnorm.kernel import rms_instance, rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.models.registry import load_config

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)

    def tol(dt):
        return TOL_BF16 if dt == torch.bfloat16 else TOL_FP32

    def fa_case(b, tq, tk, hq, hkv, dh, causal, window, dt, timed, fp64=True, flip=False):
        """B4 at one shape against its plain version; ``flip``: also the
        planted fault of the causal flag flipped (causal where none, or none
        where causal), which the same check must reject."""
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(dt)
                   for s in ((b, tq, hq, dh), (b, tk, hkv, dh), (b, tk, hkv, dh)))
        got = flash_attention_fwd(q, k, v, causal=causal, window=window)
        want = attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check(got.dtype == want.dtype == dt and got.shape == want.shape, f"B4 {got.dtype} {got.shape}")
        err, ratio = err_stats(got, want, **tol(dt))
        instance = fa_instance(dt, dh)
        check(ratio <= 1.0, f"B4 {(b, tq, tk, hq, hkv, dh, causal, window, dt)} ({instance}): max "
              f"err {err} over tolerance {tol(dt)}")
        row = dict(shape=[b, tq, tk, hq, hkv, dh], causal=causal, window=window, dtype=str(dt),
                   instance=instance, max_abs_err=err, err_ratio=ratio)
        if flip:
            bad = flash_attention_fwd(q, k, v, causal=not causal, window=window)
            _, row["planted_causal_flipped_ratio"] = err_stats(bad, want, **tol(dt))
            del bad
            check(row["planted_causal_flipped_ratio"] > 1.0,
                  f"B4 {row['shape']}: the check passed the causal flag flipped")
        if timed:
            mask = attention_mask(tq, tk, causal, window, dev)
            pairs = int(mask.sum())
            flops = 4 * b * hq * dh * pairs          # q·k and p·v over the unmasked pairs
            nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
            fp32_ms, fp32_by = bound(flops, nbytes)
            tc_ms = 1e3 * max(flops / BF16_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)
            tc_by = "operations" if flops / BF16_PEAK_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes"
            # the bound of the units the instance runs on: bf16 tensor cores or fp32 CUDA cores
            b_ms, b_by = (tc_ms, tc_by) if dt == torch.bfloat16 else (fp32_ms, fp32_by)
            # the library call: SDPA on (B, H, T, D) with the KV heads repeated
            rep = hq // hkv
            qs = q.transpose(1, 2)
            ks = k.repeat_interleave(rep, dim=2).transpose(1, 2)
            vs = v.repeat_interleave(rep, dim=2).transpose(1, 2)
            if window is None and not causal:
                lib_kw = {}
            elif window is None and tq == tk:
                lib_kw = dict(is_causal=True)
            else:
                lib_kw = dict(attn_mask=mask)
            row.update(
                ms=time_ms(lambda: flash_attention_fwd(q, k, v, causal=causal, window=window)),
                plain_ms=time_ms(lambda: attention_ref(q, k, v, causal=causal, window=window),
                                 reps=3, iters=3),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, **lib_kw)),
                bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
                fp32_core_bound_ms=fp32_ms, bf16_tensor_core_bound_ms=tc_ms)
            del qs, ks, vs, mask
            if dt == torch.bfloat16 and fp64:
                # kernel and plain version (fp32 math, output rounded to bf16)
                # against an fp64 evaluation of the plain version
                exact = attention_ref(q.double(), k.double(), v.double(), causal=causal,
                                      window=window)
                row.update(kernel_err_vs_fp64=float((got.double() - exact).abs().max()),
                           plain_err_vs_fp64=float((want.double() - exact).abs().max()))
                del exact
                check(row["kernel_err_vs_fp64"] <= FA_FP64_FACTOR * row["plain_err_vs_fp64"],
                      f"B4 {instance} at the LM shape: {row['kernel_err_vs_fp64']} from fp64, over "
                      f"{FA_FP64_FACTOR} x the plain version's {row['plain_err_vs_fp64']}")
        del q, k, v, got, want
        return row

    fa_rows = []
    # the Qwen2-7B run's shape, bf16 (its path) and fp32; then phases 20's
    # and 21's training shapes in bf16, timed beside it (Mixtral's with its
    # window of 4096, which masks nothing at 2048 but takes the window path),
    # and Mixtral's heads at 8192 tokens, where the window masks.  At 8192
    # the fp64 evaluation of the plain version (96 GB of logits) does not
    # fit the card: that shape is held against the plain version alone.
    def heads(name):
        c = load_config(name)
        return c.n_heads, c.n_kv_heads, c.resolved_head_dim, c.swa_window

    mb = LM_BATCH // LM_ACCUM
    shapes = [(mb, LM_SEQ, heads(LM_ARCH), dt, True) for dt in (torch.bfloat16, torch.float32)]
    shapes += [(mb, LM_SEQ, heads(name), torch.bfloat16, True) for name in DENSE_ARCHS + MOE_ARCHS]
    shapes += [(1, FA_WINDOW_SEQ, heads("mixtral-8x22b"), torch.bfloat16, False)]
    for b, t, (hq, hkv, dh, window), dt, fp64 in shapes:
        r = fa_case(b, t, t, hq, hkv, dh, True, window, dt, True, fp64)
        fa_rows.append(r)
        fp64 = (f"; vs fp64: kernel {r['kernel_err_vs_fp64']:.3e} plain "
                f"{r['plain_err_vs_fp64']:.3e}" if "kernel_err_vs_fp64" in r else "")
        print(f"  B4 {r['shape']} causal window {r['window']} {r['dtype']} ({r['instance']}): err "
              f"{r['max_abs_err']:.2e} ({r['err_ratio']:.3f} of tol) kernel {r['ms']:.4f} ms plain "
              f"{r['plain_ms']:.3f} sdpa {r['library_ms']:.4f} bound {r['bound_ms']:.4f} "
              f"({r['bound_by']}; fp32 cores {r['fp32_core_bound_ms']:.3f}, bf16 tensor cores "
              f"{r['bf16_tensor_core_bound_ms']:.4f}){fp64}")
    # the bf16 shapes of phases 23-24's training microbatch: Qwen2-VL's causal
    # 12 q heads over 2 kv heads of 128, Whisper's encoder (non-causal),
    # decoder (causal) and cross-attention (non-causal, 512 queries against
    # 2048 keys), each with its causal flag flipped as a planted fault
    for shape in FA_VL_WHISPER_SHAPES:
        r = fa_case(*shape, None, torch.bfloat16, True, True, flip=True)
        fa_rows.append(r)
        print(f"  B4 {r['shape']} causal={r['causal']} bf16 ({r['instance']}): err "
              f"{r['max_abs_err']:.2e} ({r['err_ratio']:.3f} of tol; causal flipped "
              f"{r['planted_causal_flipped_ratio']:.1f}x) kernel {r['ms']:.4f} ms plain "
              f"{r['plain_ms']:.3f} sdpa {r['library_ms']:.4f} bound {r['bound_ms']:.4f} "
              f"({r['bound_by']}); vs fp64: kernel {r['kernel_err_vs_fp64']:.3e} plain "
              f"{r['plain_err_vs_fp64']:.3e}")
    cases = [(c[:8], c[8]) for c in FA_CASES]
    cases += [(c[:8], "bfloat16") for c in FA_CASES if c[8] != "bfloat16"]
    cases += [(c, "bfloat16") for c in FA_BF16_EDGE_CASES]
    for shape, dt in cases:
        r = fa_case(*shape, getattr(torch, dt), False)
        print(f"  B4 case {shape} {dt} ({r['instance']}): err {r['max_abs_err']:.2e} "
              f"({r['err_ratio']:.3f} of tol)")
    print(f"B4 checks passed (fp32 {TOL_FP32}, bf16 {TOL_BF16}; {len(cases) + len(shapes)} "
          f"cases)")

    def rms_case(shape, dt, sdt, timed, offset=0):
        # offset > 0: x starts ``offset`` elements into its buffer (a base
        # that is not 16-byte aligned)
        x = torch.randn(math.prod(shape) + offset, generator=gen, device=dev).to(dt)[offset:]
        x = x.view(shape)
        sc = (1 + 0.1 * torch.randn(shape[-1:], generator=gen, device=dev)).to(sdt)
        aligned = x.data_ptr() % 16 == 0 and sc.data_ptr() % 16 == 0
        instance = rms_instance(dt, sdt, shape[-1], aligned)
        before = rmsnorm.launches_by_instance[instance]
        got, again = rmsnorm(x, sc), rmsnorm(x, sc)
        want = rmsnorm_ref(x, sc)
        torch.cuda.synchronize()
        out_dt = torch.promote_types(dt, sdt)
        check(got.dtype == want.dtype == out_dt and got.shape == want.shape, f"B6 {got.dtype}")
        check(rmsnorm.launches_by_instance[instance] == before + 2, f"B6 {shape}: not {instance}")
        check(torch.equal(got, again), f"B6 {shape} {dt} x {sdt}: other bits on a rerun")
        err, ratio = err_stats(got, want, **tol(out_dt))
        check(ratio <= 1.0, f"B6 {shape} {dt} x {sdt} ({instance}): max err {err} over tolerance "
              f"{tol(out_dt)}")
        row = dict(shape=list(shape), dtype=str(dt), scale_dtype=str(sdt), instance=instance,
                   max_abs_err=err, err_ratio=ratio)
        if timed:
            nbytes = x.element_size() * x.numel() + sc.element_size() * sc.numel() + \
                got.element_size() * got.numel()
            b_ms, b_by = bound(4 * x.numel(), nbytes)     # square, add, scale, multiply
            lib = getattr(F, "rms_norm", None)
            # cold: a rotation of distinct x whose sum exceeds the L2 RMS_COLD_FACTOR times
            xs = [torch.randn(shape, generator=gen, device=dev).to(dt) for _ in
                  range(max(2, -(-RMS_COLD_FACTOR * L2_BYTES // (x.element_size() * x.numel()))))]
            turn = itertools.cycle(xs)
            row.update(ms=time_ms(lambda: rmsnorm(x, sc)),
                       plain_ms=time_ms(lambda: rmsnorm_ref(x, sc)),
                       library_ms=None if lib is None else time_ms(
                           lambda: lib(x, (shape[-1],), sc, 1e-6)),
                       ms_cold=time_ms(lambda: rmsnorm(next(turn), sc), iters=len(xs)),
                       library_ms_cold=None if lib is None else time_ms(
                           lambda: lib(next(turn), (shape[-1],), sc, 1e-6), iters=len(xs)),
                       device_ms=graph_ms(lambda: rmsnorm(x, sc)),
                       device_ms_cold=graph_ms(lambda: [rmsnorm(t, sc) for t in xs]) / len(xs),
                       library_device_ms=None if lib is None else graph_ms(
                           lambda: lib(x, (shape[-1],), sc, 1e-6)),
                       library_device_ms_cold=None if lib is None else graph_ms(
                           lambda: [lib(t, (shape[-1],), sc, 1e-6) for t in xs]) / len(xs),
                       cold_copies=len(xs), bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
            del xs
        return row

    def rms_line(r):
        return (f"  B6 {r['shape']} {r['dtype']} x {r['scale_dtype']} ({r['instance']}): err "
                f"{r['max_abs_err']:.2e} ({r['err_ratio']:.3f} of tol) kernel warm {r['ms']:.4f} "
                f"cold {r['ms_cold']:.4f} (device {r['device_ms']:.4f} / "
                f"{r['device_ms_cold']:.4f}) "
                f"plain {r['plain_ms']:.4f} F.rms_norm warm {r['library_ms']} cold "
                f"{r['library_ms_cold']} (device {r['library_device_ms']} / "
                f"{r['library_device_ms_cold']}) bound {r['bound_ms']:.4f} ({r['bound_by']})")

    # the path's shapes: every B6 width (``b6_widths``) of each config the
    # smoke trains (Qwen2-7B 3584; Mamba2-780m 1536 and its gated norm's 3072;
    # CodeQwen1.5-7B 4096; Mixtral-8x22B 6144; Jamba-v0.1 4096 and its gated
    # norm's 8192; DeepSeek-V3 7168 and MLA's q_norm 1536 and kv_norm 512) at
    # its run's microbatch rows, x and scale in the run's types; Qwen2-7B's
    # in fp32 too
    path = []
    for name in (LM_ARCH, MAMBA_ARCH) + DENSE_ARCHS + MOE_ARCHS + (DS_ARCH,):
        cfg = load_config(name)
        rows = (MAMBA_BATCH // MAMBA_ACCUM * MAMBA_SEQ if name == MAMBA_ARCH
                else LM_BATCH // LM_ACCUM * LM_SEQ)
        dts = [(getattr(torch, cfg.dtype), getattr(torch, cfg.param_dtype))]
        dts += [(torch.float32, torch.float32)] if name == LM_ARCH else []
        path += [(name, (rows, d), dt, sdt) for d in b6_widths(cfg) for dt, sdt in dts]
    print(f"B6 on the path: {[(name, shape[-1]) for name, shape, _, _ in path]}")
    rms_rows = []
    for name, shape, dt, sdt in path:
        rms_rows.append(dict(arch=name, **rms_case(shape, dt, sdt, True)))
        print(rms_line(rms_rows[-1]))
    seen = {r["instance"] for r in rms_rows}
    cases = [(shape, dt, dt, 0) for shape, dt in RMS_CASES] + RMS_EDGE_CASES
    for shape, dt, sdt, offset in cases:
        dt, sdt = getattr(torch, dt), getattr(torch, sdt)
        r = rms_case(shape, dt, sdt, False, offset)
        seen.add(r["instance"])
        print(f"  B6 case {shape} {dt} x {sdt}{' unaligned' if offset else ''} ({r['instance']}): "
              f"err {r['max_abs_err']:.2e} ({r['err_ratio']:.3f} of tol)")
    check(seen == set(RMS_INSTANCES), f"B6 instances not checked: {set(RMS_INSTANCES) - seen}")
    print(f"B6 checks passed (fp32 {TOL_FP32}, bf16 {TOL_BF16}; every instance: {sorted(seen)})")
    print(json.dumps({"flash_attention_shapes": fa_rows}))
    print(json.dumps({"rmsnorm_shapes": rms_rows}))
    return fa_rows, fa_rows[0]["max_abs_err"], rms_rows, rms_rows[0]["max_abs_err"]


@dataclasses.dataclass(frozen=True)
class LMRun:
    """One LM training cell of the smoke run (phases 7-8 and 10-11)."""

    key: str            # the metrics line's key
    arch: str
    depth: int
    seq: int
    batch: int          # global batch
    accum: int          # microbatches
    steps: int
    grad_depth: int     # the gradient check's depth (full width, fp32 / fp64)
    grad_batch: int     # ... and its one microbatch: grad_batch x grad_seq tokens
    grad_seq: int
    optimizer: str = "adamw"


QWEN_RUN = LMRun("lm_train", LM_ARCH, LM_DEPTH, LM_SEQ, LM_BATCH, LM_ACCUM, LM_STEPS,
                 LM_GRAD_DEPTH, LM_BATCH // LM_ACCUM, LM_SEQ)
MAMBA_RUN = LMRun("mamba_train", MAMBA_ARCH, MAMBA_DEPTH, MAMBA_SEQ, MAMBA_BATCH, MAMBA_ACCUM,
                  MAMBA_STEPS, MAMBA_GRAD_DEPTH, 1, MAMBA_GRAD_SEQ)


def phase_train_runs() -> list:
    """The training cells of phases 7, 10 and 20-24 (``lm_train_phase``'s
    runs; phase 28 dry-runs each)."""
    runs = [QWEN_RUN, MAMBA_RUN]
    runs += [LMRun(f"dense_train_{n}", n, DENSE_TRAIN_DEPTH[n], LM_SEQ, LM_BATCH, LM_ACCUM,
                   DENSE_TRAIN_STEPS, LM_GRAD_DEPTH, LM_BATCH // LM_ACCUM, LM_SEQ)
             for n in DENSE_ARCHS]
    runs += [LMRun(f"moe_train_{n}", n, MOE_TRAIN_DEPTH[n], LM_SEQ, LM_BATCH, LM_ACCUM,
                   MOE_TRAIN_STEPS, LM_GRAD_DEPTH, LM_BATCH // LM_ACCUM, LM_SEQ,
                   optimizer=MOE_OPTIMIZER) for n in MOE_ARCHS]
    runs.append(LMRun("deepseek_train", DS_ARCH, DS_TRAIN_DEPTH, LM_SEQ, LM_BATCH, LM_ACCUM,
                      DS_TRAIN_STEPS, LM_GRAD_DEPTH, LM_BATCH // LM_ACCUM, LM_SEQ,
                      optimizer=MOE_OPTIMIZER))
    for key, name in (("vl_train", VL_ARCH), ("whisper_train", WHISPER_ARCH)):
        runs.append(LMRun(key, name, VL_TRAIN_DEPTH[name], VL_SEQ, LM_BATCH, LM_ACCUM,
                          VL_STEPS, LM_GRAD_DEPTH, LM_BATCH // LM_ACCUM, VL_SEQ))
    return runs


def train_run(key: str) -> LMRun:
    """The cell of ``phase_train_runs`` whose metrics line is ``key``."""
    return next(r for r in phase_train_runs() if r.key == key)


# each LM kernel's name in a profiler trace
LM_KERNEL_TRACE_NAMES = {"flash_attention_fwd": "flash_attention_fwd_",   # both instances
                         "ssd_chunk_fwd": "ssd_chunk_fwd_",        # both instances
                         "rmsnorm": "rmsnorm_"}                     # every instance


def b6_norms_per_layer(cfg, i: int) -> int:
    """B6 launches of layer ``i``'s forward (or one decode call): norm1, and
    norm2 where the layer has an MLP or experts outside a parallel block,
    when the config's norm is RMSNorm (a LayerNorm runs as plain torch, as
    the reference leaves it to XLA); a Mamba2 block's gated RMSNorm always;
    an MLA layer's ``q_norm`` and ``kv_norm`` always."""
    from repro_torch.models.lm import layer_kind

    kind = layer_kind(cfg, i)
    rms = cfg.norm == "rmsnorm"
    return (rms * (1 + ((cfg.d_ff > 0 or kind.moe) and not cfg.parallel_block))
            + (kind.mixer == "mamba") + 2 * (kind.mixer == "attn" and cfg.mla is not None))


def b6_widths(cfg) -> list:
    """The row widths B6 normalises in ``cfg``'s forward and decode: d_model
    where the config's norm is RMSNorm, MLA's q and kv ranks (``q_norm``,
    ``kv_norm``), and a Mamba2 block's d_inner (its gated RMSNorm)."""
    from repro_torch.models.lm import layer_kind

    widths = [cfg.d_model] if cfg.norm == "rmsnorm" else []
    if cfg.mla is not None:
        widths += [cfg.mla.q_lora_rank, cfg.mla.kv_lora_rank]
    if any(layer_kind(cfg, i).mixer == "mamba" for i in range(cfg.n_layers)):
        widths.append(cfg.ssm.d_inner(cfg.d_model))
    return widths


def b6_per_decode_call(cfg) -> int:
    """B6 launches of one ``decode_step`` call: every layer's, and the final
    norm's when it is RMSNorm."""
    return sum(b6_norms_per_layer(cfg, i) for i in range(cfg.n_layers)) + (cfg.norm == "rmsnorm")


def lm_launches_per_microbatch(cfg, remat: str) -> dict:
    """Kernel launches of one microbatch's loss and grads, from the code:
    each layer's forward runs its mixer's kernel once (B4 for attention but
    MLA, which runs the plain ``_sdpa`` as the reference runs XLA; B5 for a
    Mamba2 block) and B6 as ``b6_norms_per_layer`` says; the final norm runs
    B6 once more where it is RMSNorm.  remat "full" reruns each layer's
    forward (all of it: the checkpoint saves only the layer's input) in the
    backward, outside the final norm; so does "dots", whose policy saves
    matmul outputs alone, never a kernel's buffer.  An MTP head runs its norm and one
    layer of the last layer's kind once, with no remat.  The backwards of
    all three ops are plain torch and launch no kernel.  A config without an
    RMSNorm counts B6 as 0: the run must launch it no time."""
    from repro_torch.models.lm import layer_kind

    out = {"rmsnorm": 0}
    if cfg.encoder_decoder:
        # Whisper (LayerNorm: no B6): each encoder layer's self-attention and
        # each decoder layer's self- and cross-attention run B4 once a forward
        runs = 2 if remat != "none" else 1
        out["flash_attention_fwd"] = runs * (cfg.n_encoder_layers + 2 * cfg.n_layers)
        return out

    def layer(i, runs):
        kind = layer_kind(cfg, i)
        if kind.mixer == "mamba" or cfg.mla is None:
            mixer = "flash_attention_fwd" if kind.mixer == "attn" else "ssd_chunk_fwd"
            out[mixer] = out.get(mixer, 0) + runs
        out["rmsnorm"] += b6_norms_per_layer(cfg, i) * runs

    for i in range(cfg.n_layers):
        layer(i, 1 if remat == "none" else 2)
    out["rmsnorm"] += cfg.norm == "rmsnorm"
    if cfg.mtp_depth > 0:
        layer(cfg.n_layers - 1, 1)
        out["rmsnorm"] += cfg.norm == "rmsnorm"
    return out


class swapped:
    """Context: each ``(module, attribute, value)`` set for the duration,
    then put back as it was."""

    def __init__(self, *swaps):
        self.swaps = swaps

    def __enter__(self):
        self.saved = [(m, a, getattr(m, a)) for m, a, _ in self.swaps]
        for m, a, v in self.swaps:
            setattr(m, a, v)
        return self

    def __exit__(self, *exc):
        for m, a, v in self.saved:
            setattr(m, a, v)
        return False


def plain_lm_kernels() -> swapped:
    """The models call the plain versions of B4, B5 and B6 (for the
    references of phases 7-8 and 10-11)."""
    import repro_torch.models.attention as attn_mod
    import repro_torch.models.common as common_mod
    import repro_torch.models.mamba2 as mamba_mod
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssd_chunk.ops import ssd_scan_ref

    return swapped(
        (attn_mod, "flash_attention", lambda q, k, v, causal=True, window=None, scale=None, *_:
         attention_ref(q, k, v, causal=causal, window=window, scale=scale)),
        (common_mod, "rmsnorm", rmsnorm_ref),
        (mamba_mod, "ssd_scan", ssd_scan_ref),
    )


def microbatch(batch: dict, i: int, accum: int) -> dict:
    """Microbatch ``i`` of ``accum`` of a placed LM batch, as the trainer
    splits it: M-RoPE's (3, B, T) positions on their batch dim, the rest on
    dim 0."""
    return {k: v.chunk(accum, dim=1 if (k == "positions" and v.dim() == 3) else 0)[i]
            for k, v in batch.items()}


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree for p in named_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in named_leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def lm_train_phase(dev, smi: str, run: LMRun) -> dict:
    """Phase 7 (Qwen2-7B, 12 layers), 10 (Mamba2-780m, 48 layers), 20 (the
    dense configs), 21 (the MoE configs), 22-24 (DeepSeek-V3, Qwen2-VL,
    Whisper): full width, bf16, ``run.steps`` steps of ``run.optimizer``
    with CAPTURE_WARMUP warmup steps, the config cut to its first
    ``run.depth`` layers; then 27(c): the same run captured
    (``lm_capture_run``), bit for bit.  Returns the launch count of each
    kernel in the eager training run, the
    params, the params of one layer of each kind the run holds, the run's
    peak memory, and for an MoE config the share of (token, k) assignments
    its step-1 forward dropped by capacity."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ParallelConfig, ShapeConfig, TrainConfig
    from repro_torch.data.synthetic import place, synth_batch
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd, reset_launches
    from repro_torch.kernels.rmsnorm.kernel import reset_launches as reset_b6_launches
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    from repro_torch.kernels.ssd_chunk.kernel import reset_launches as reset_b5_launches
    from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk_fwd
    from repro_torch.models import mlp as mlp_mod
    from repro_torch.models.lm import plan_segments
    from repro_torch.models.registry import bundle_from_cfg, load_config
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.runtime.driver import DriverConfig, run_training
    from repro_torch.train.trainer import make_train_step

    cfg = dataclasses.replace(load_config(run.arch), n_layers=run.depth)
    arch = bundle_from_cfg(cfg, dev)
    pcfg = ParallelConfig(grad_accum=run.accum, remat="full")
    tcfg = TrainConfig(warmup=CAPTURE_WARMUP, steps=run.steps, seed=SEED,
                       optimizer=run.optimizer)
    specs = arch.input_specs(ShapeConfig("smoke", run.seq, run.batch, "train"))

    def make_batch(step):
        return place(synth_batch(specs, cfg, SEED, step), dev)

    step1 = {}
    init_state, train_step = make_train_step(
        arch, pcfg, tcfg, on_grads=lambda s, l, g: step1.setdefault("loss", float(l)))
    events, logged, last = [], [], {}

    def timed_step(state, batch):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = train_step(state, batch)
        b.record()
        events.append((a, b))
        logged.append(m)
        last["state"] = state
        return state, m

    per_mb = lm_launches_per_microbatch(cfg, pcfg.remat)
    wrappers = {"flash_attention_fwd": flash_attention_fwd, "ssd_chunk_fwd": ssd_chunk_fwd,
                "rmsnorm": rmsnorm}
    kernels = {name: wrappers[name] for name in per_mb}
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    for f in kernels.values():
        f.launches = 0
    reset_launches()
    reset_b5_launches()
    reset_b6_launches()
    report = run_training(init_state=init_state, train_step=timed_step, make_batch=make_batch,
                          steps=run.steps, cfg=DriverConfig(), seed=SEED)
    launches = {name: f.launches for name, f in kernels.items()}
    b4_instances = {k: v for k, v in flash_attention_fwd.launches_by_instance.items() if v}
    b5_instances = {k: v for k, v in ssd_chunk_fwd.launches_by_instance.items() if v}
    b6_instances = {k: v for k, v in rmsnorm.launches_by_instance.items() if v}
    torch.cuda.synchronize()
    run_s = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    n_params = sum(p.numel() for p in tree_leaves(last["state"].params))
    # one layer's params by its kind (mixer, moe, swa): a stacked row each
    kind_params = {}
    for seg, seg_p in zip(plan_segments(cfg), last["state"].params.get("segments", [])):
        for kind, layer in zip(seg.block, seg_p):
            kind_params[dataclasses.astuple(kind)] = sum(t[0].numel() for t in tree_leaves(layer))
    step_ms = [a.elapsed_time(b) for a, b in events]
    losses = [float(m["loss"]) for m in logged]
    gnorms = [float(m["grad_norm"]) for m in logged]
    want = {k: v * run.accum * run.steps for k, v in per_mb.items()}
    # the eager run's end, for 27(c)'s captured twin
    eager = {"sums": state_checksums(last["state"]), "losses": losses, "step_ms": step_ms,
             "host_ms": [t * 1e3 for t in report.step_times], "peak": peak}
    print(f"{run.key}: {cfg.name} {cfg.n_layers} layers, {n_params / 1e9:.3f} B params, trained "
          f"{report.steps_done} steps in {run_s:.1f} s, restarts {report.restarts}, "
          f"launches {launches}, losses {losses}")
    check(report.restarts == 0, f"restarts {report.restarts}")
    check(report.steps_done == run.steps and len(losses) == run.steps, f"{run.key} step count")
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)), f"losses {losses} gnorms {gnorms}")
    check(launches == want, f"{run.key} launches {launches} != {want}")
    # a bf16 run's attention goes to the tensor-core instance alone
    check(sum(b4_instances.values()) == launches.get("flash_attention_fwd", 0)
          and all(k.startswith("wgmma_bf16") for k in b4_instances),
          f"{run.key} B4 launches by instance {b4_instances}")
    # every B6 launch is counted by instance, and the instances sum to the code's count
    print(f"{run.key}: B6 launches by instance {b6_instances} (the code's count "
          f"{want['rmsnorm']})")
    check(sum(b6_instances.values()) == launches["rmsnorm"] == want["rmsnorm"],
          f"{run.key} B6 launches by instance {b6_instances} vs {want['rmsnorm']}")
    if "ssd_chunk_fwd" in want:
        # a bf16 Mamba2 run's SSD goes to the tensor-core instance alone
        print(f"{run.key}: B5 launches by instance {b5_instances} (the code's count "
              f"{want['ssd_chunk_fwd']})")
        check(sum(b5_instances.values()) == launches["ssd_chunk_fwd"] == want["ssd_chunk_fwd"]
              and set(b5_instances) == {"wgmma_bf16"},
              f"{run.key} B5 launches by instance {b5_instances} vs {want['ssd_chunk_fwd']}")
    check(step1["loss"] == losses[0], "on_grads saw another loss than the run logged")

    # where the device time of one step goes (one more step on the final
    # state).  The trace records the card's activity alone: with the host's
    # ops too, building its events took minutes for a deep model's step
    med = statistics.median(step_ms)
    dev_ms = None                   # an unprofiled cell's replays have no idle share
    if run.key in UNPROFILED_TRAIN:
        print(f"{run.key}: not profiled (UNPROFILED_TRAIN)")
    else:
        batch = make_batch(0)
        t_trace = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            train_step(last["state"], batch)
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        by_name = device_ms_by_name(prof, 1)
        trace_s = time.perf_counter() - t_trace
        dev_ms = sum(by_name.values())
        part = {name: sum(v for k, v in by_name.items() if LM_KERNEL_TRACE_NAMES[name] in k)
                for name in kernels}
        check(dev_ms > 0 and all((v > 0) == (want[k] > 0) for k, v in part.items()),
              f"profiler saw no device time for a kernel of the run, or some for one it does "
              f"not launch: {part}")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
        print(json.dumps({f"profile_{run.key}_step": {
            "wall_ms": prof_wall_ms, "device_ms": dev_ms, "kernel_ms": part, "trace_s": trace_s,
            "idle_share": max(0.0, 1 - dev_ms / prof_wall_ms),
            # against the unprofiled step (CUDA events, median of the run)
            "idle_share_vs_event_step": max(0.0, 1 - dev_ms / med),
            "top": [[k[:80], v] for k, v in top],
        }}))
        del batch, prof
    del last, init_state, train_step
    torch.cuda.empty_cache()

    # step 1's loss against a bf16 forward through the plain versions of the
    # path's kernels: the same params (init is seeded) and both microbatches
    # of step 1
    params0 = arch.init(SEED)
    b0 = make_batch(0)
    # the MoE layers' capacity drops in that forward (the run's step 1)
    kept = []
    real_queue = mlp_mod.queue_positions

    def counted(topi, n_experts, cap):
        pos, keep = real_queue(topi, n_experts, cap)
        kept.append((keep.sum(), keep.numel()))
        return pos, keep

    with torch.no_grad(), plain_lm_kernels(), swapped((mlp_mod, "queue_positions", counted)):
        plain = [float(arch.loss_fn(params0, microbatch(b0, i, run.accum), remat="none"))
                 for i in range(run.accum)]
    plain_loss = sum(plain) / run.accum
    dropped = (1 - float(sum(k for k, _ in kept)) / sum(n for _, n in kept)) if kept else None
    if kept:
        print(f"{run.key}: {len(kept)} MoE dispatches in step 1's forward, capacity "
              f"{mlp_mod.moe_capacity(run.batch // run.accum * run.seq, cfg.moe)} an expert: "
              f"{dropped:.4%} of the (token, k) assignments dropped")
    loss_rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    print(f"{run.key} step-1 loss {losses[0]:.6f} vs the plain-kernel forward {plain_loss:.6f} "
          f"(microbatches {plain}): rel err {loss_rel:.2e}, bar {LM_LOSS_RTOL}")
    check(loss_rel <= LM_LOSS_RTOL, f"{run.key} step-1 loss rel err {loss_rel}")
    del params0
    torch.cuda.empty_cache()

    eager["device_ms"] = dev_ms
    capture = lm_capture_run(dev, smi, run, cfg, arch, pcfg, tcfg, make_batch, per_mb, eager)

    tokens = run.batch * run.seq
    print(json.dumps({run.key: {
        "arch": cfg.name, "layers": cfg.n_layers, "params": n_params, "dtype": cfg.dtype,
        "seq": run.seq, "global_batch": run.batch, "microbatches": run.accum, "remat": pcfg.remat,
        "optimizer": tcfg.optimizer, "lr": tcfg.lr, "steps": report.steps_done,
        "restarts": report.restarts, "loss": losses, "grad_norm": gnorms,
        "step1_loss_plain_kernels": plain_loss, "step1_loss_rel_err": loss_rel,
        "step_ms_cuda_events": step_ms, "step_ms_cuda_events_median": med,
        "step_ms_host": [t * 1e3 for t in report.step_times],
        "step_ms_host_median": statistics.median(report.step_times) * 1e3,
        "tokens_per_s_cuda_events": tokens / (med / 1e3),
        "peak_mem_bytes": peak, "launches": launches, "launches_expected": want,
        "b4_launches_by_instance": b4_instances, "b5_launches_by_instance": b5_instances,
        "b6_launches_by_instance": b6_instances, "moe_dropped_share": dropped, "card": smi,
    }}))
    return {"launches": launches, "params": n_params, "kind_params": kind_params,
            "peak_mem_bytes": peak, "moe_dropped_share": dropped,
            "step_ms_median": med, "tokens_per_s": tokens / (med / 1e3), "losses": losses,
            "step1_loss_plain_kernels": plain_loss, "capture": capture}


def lm_grad_phase(dev, run: LMRun, fault, must_fail, note: str) -> dict:
    """Phase 8 or 11: the LM path's loss and gradients through its kernels at
    full width (``run.grad_depth`` layers, fp32) against the plain path in
    fp64, per leaf, and a planted fault that the same check must reject:
    ``fault`` is a ``swapped`` context, and every leaf in ``must_fail`` must
    land over its bar under it.  ``note`` says what the fault is."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import place, synth_batch
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd, reset_launches
    from repro_torch.kernels.ssd_chunk.kernel import reset_launches as reset_b5_launches
    from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk_fwd
    from repro_torch.models.lm import lm_loss
    from repro_torch.models.registry import bundle_from_cfg, load_config, with_depth
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.train.trainer import lm_value_and_grad

    base = with_depth(load_config(run.arch), run.grad_depth)
    cfg32 = dataclasses.replace(base, dtype="float32", param_dtype="float32")
    cfg64 = dataclasses.replace(base, dtype="float64", param_dtype="float64")
    arch = bundle_from_cfg(cfg32, dev)
    params = arch.init(SEED)
    specs = arch.input_specs(ShapeConfig("smoke", run.grad_seq, run.grad_batch, "train"))
    batch = place(synth_batch(specs, cfg32, SEED, 0), dev)    # step 1's first microbatch

    def grads(cfg, p):
        return lm_value_and_grad(lambda p_, b_: lm_loss(p_, b_, cfg, remat="full"), p, batch)

    reset_launches()
    reset_b5_launches()
    loss_k, g_k = grads(cfg32, params)            # through the path's kernels
    b4_instances = {k: v for k, v in flash_attention_fwd.launches_by_instance.items() if v}
    b5_instances = {k: v for k, v in ssd_chunk_fwd.launches_by_instance.items() if v}
    # an fp32 model's attention and SSD go to the SIMT instances alone
    check(all(k.startswith("simt_fp32") for k in b4_instances)
          and (base.ssm is not None or sum(b4_instances.values()) > 0),
          f"{run.arch} fp32 grads: B4 launches by instance {b4_instances}")
    check(set(b5_instances) == ({"simt_fp32"} if base.ssm is not None else set()),
          f"{run.arch} fp32 grads: B5 launches by instance {b5_instances}")
    with plain_lm_kernels():
        p64 = tree_map(lambda t: t.double(), params)
        loss64, g64 = grads(cfg64, p64)
        del p64
        loss32, g32 = grads(cfg32, params)
    names = [n for n, _ in named_leaves(g64)]
    # b_k's exact gradient is zero (a key bias shifts a query row's logits
    # alike, which softmax ignores), so its computed grads are rounding
    # noise: it is scaled by its sibling b_q's fp64 grad instead of its own.
    scale = {n: float(t.abs().max()) for n, t in named_leaves(g64)}
    scale = {n: scale[n.replace("/b_k", "/b_q")] if n.endswith("/b_k") else v
             for n, v in scale.items()}

    def errs(g):
        return [float((a.double() - b).abs().max()) / scale[n]
                for n, a, b in zip(names, (t for _, t in named_leaves(g)),
                                   (t for _, t in named_leaves(g64)))]

    plain64 = errs(g32)
    del g32
    kern64 = errs(g_k)
    bars = [max(WGRAD_NORM_TOL, GRAD_FLOOR_FACTOR * e) for e in plain64]
    worst = max(range(len(names)), key=lambda i: kern64[i] / bars[i])
    loss_rel = abs(float(loss_k) - float(loss64)) / abs(float(loss64))
    loss32_rel = abs(float(loss32) - float(loss64)) / abs(float(loss64))
    print(f"{run.arch} grads (full width, {run.grad_depth} layers, fp32) vs the plain path in "
          f"fp64: loss rel err {loss_rel:.2e} (plain fp32 {loss32_rel:.2e}); grads normwise max "
          f"{max(kern64):.2e} (plain fp32 {max(plain64):.2e}); nearest its bar: {names[worst]} "
          f"{kern64[worst]:.2e}, {kern64[worst] / bars[worst]:.2f} of its bar")
    check(loss_rel <= max(WGRAD_NORM_TOL, GRAD_FLOOR_FACTOR * loss32_rel),
          f"{run.arch} loss rel err {loss_rel} vs fp64")
    for n, e, p, bar in zip(names, kern64, plain64, bars):
        check(e <= bar, f"{run.arch} grad {n}: normwise err {e} vs fp64 over its bar {bar} "
                        f"(plain fp32 {p})")
    del g_k

    with fault:
        _, g_bad = grads(cfg32, params)
    fault_ratio = {n: e / bar for n, e, bar in zip(names, errs(g_bad), bars)}
    failing = sorted(n for n, r in fault_ratio.items() if r > 1.0)
    print(f"planted fault ({note}): {len(failing)} of {len(names)} leaves over their bar; "
          + ", ".join(f"{n} {fault_ratio[n]:.1f}x" for n in must_fail))
    check(all(n in failing for n in must_fail),
          f"the {run.arch} grad check passed a planted fault ({note}): {fault_ratio}")
    del g_bad, g64
    out = {"loss_rel_err_vs_fp64": loss_rel, "plain32_loss_rel_err_vs_fp64": loss32_rel,
           "grad_err_vs_fp64": max(kern64), "plain32_grad_err_vs_fp64": max(plain64),
           "per_leaf": {n: [a, b] for n, a, b in zip(names, kern64, plain64)},
           "planted_fault_err_over_bar": fault_ratio, "b4_launches_by_instance": b4_instances,
           "b5_launches_by_instance": b5_instances}
    if base.ssm is not None:
        # the record of why the port masks the decay's exponent: the same
        # grads with the reference's literal where(tri, exp(dseg), 0)
        import repro_torch.kernels.ssd_chunk.ref as ssd_ref

        def literal_decay(cum):
            q = cum.shape[-1]
            tri = torch.ones((q, q), dtype=torch.bool, device=cum.device).tril()
            return torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)

        with swapped((ssd_ref, "causal_decay", literal_decay)):
            loss_lit, g_lit = grads(cfg32, params)
        bad = [n for n, t in named_leaves(g_lit) if not bool(torch.isfinite(t).all())]
        print(f"the reference's unmasked decay at these inputs: loss {float(loss_lit):.6f}, "
              f"{len(bad)} of {len(names)} gradient leaves non-finite: {bad}")
        out["unmasked_reference_form_nonfinite_leaves"] = bad
        del g_lit
    del params
    torch.cuda.empty_cache()
    return out


def ssd_kernel_phase(dev) -> tuple[list, float]:
    """Phase 9: B5 against its plain version on the card, TF32 off: at the
    Mamba2 run's shape (bf16, its path, and fp32), on every case of
    ``tests/test_kernels.py``'s ``SSD_CASES`` and a T < chunk case, in fp32
    and bf16; kernel and plain version timed at the run's shape, bound
    computed (no single torch call computes this function).  Returns (the
    rows at the run's shape, B5's max err at the path's shape)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk_fwd, ssd_instance, ssd_slab
    from repro_torch.kernels.ssd_chunk.ref import chunk_len, ssd_chunk_ref

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    outs = ("y", "S", "decay", "pref")

    def case(shape, dt, timed):
        b, t, h, p, g, n, chunk = shape
        q = chunk_len(t, chunk)
        instance = ssd_instance(dt, dt, n, p, q)
        before = ssd_chunk_fwd.launches_by_instance[instance]
        x = torch.randn((b, t, h, p), generator=gen, device=dev).to(dt)
        d = F.softplus(torch.randn((b, t, h), generator=gen, device=dev))
        A = -torch.exp(0.3 * torch.randn((h,), generator=gen, device=dev))
        Bm = torch.randn((b, t, g, n), generator=gen, device=dev).to(dt)
        Cm = torch.randn((b, t, g, n), generator=gen, device=dev).to(dt)
        args = (x, d, A, Bm, Cm)
        got = ssd_chunk_fwd(*args, chunk=chunk)
        want = ssd_chunk_ref(*args, chunk=chunk)
        again = ssd_chunk_fwd(*args, chunk=chunk)
        torch.cuda.synchronize()
        check(all(a.dtype == w.dtype == torch.float32 and a.shape == w.shape
                  for a, w in zip(got, want)), f"B5 {shape} {dt}: {[a.shape for a in got]}")
        check(ssd_chunk_fwd.launches_by_instance[instance] == before + 2,
              f"B5 {shape} {dt}: not {instance}")
        check(all(torch.equal(a, r) for a, r in zip(got, again)),
              f"B5 {shape} {dt}: two runs on the same inputs differ")
        # the log-decay prefix is the plain version's sequential adds: decay and
        # pref equal it bit for bit
        check(torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]),
              f"B5 {shape} {dt} ({instance}): decay or pref differs from the plain version")
        stats = [err_stats(a, w, **TOL_FP32) for a, w in zip(got, want)]
        row = dict(shape=list(shape), dtype=str(dt), instance=instance,
                   slab=ssd_slab(h // g, q, g, b * (t // q)) if instance == "wgmma_bf16" else None,
                   max_abs_err=max(e for e, _ in stats),
                   err_ratio={o: r for o, (_, r) in zip(outs, stats)}, rule="fp32 bar")
        missed = [i for i, (_, r) in enumerate(stats) if r > 1.0]
        if missed:
            # SSD_FP64_RULE: an output that misses the fp32 bar against the
            # plain version is held, with the plain version, against fp64
            exact = ssd_chunk_ref(*(a.double() for a in args), chunk=chunk)
            k64 = {outs[i]: float((got[i].double() - exact[i]).abs().max()) for i in missed}
            p64 = {outs[i]: float((want[i].double() - exact[i]).abs().max()) for i in missed}
            row.update(rule="fp64", kernel_err_vs_fp64=k64, plain_err_vs_fp64=p64)
            del exact
            check(all(k64[o] <= SSD_FP64_FACTOR * p64[o] for o in k64),
                  f"B5 {shape} {dt}: outside the fp32 bar and over {SSD_FP64_FACTOR}x the plain "
                  f"fp32 version's distance from fp64: {row}")
        if timed:
            nc = t // q
            pairs = q * (q + 1) // 2
            # the function's work: C·Bᵀ's causal pairs once per (batch, chunk,
            # group) - every head of a group shares it - then per head the
            # causal pairs' M·x and the state
            flops = b * nc * (g * pairs * n * 2 + h * (pairs * p * 2 + q * n * p * 2))
            flops_cb_per_head = b * nc * h * (pairs * (n + p) * 2 + q * n * p * 2)
            nbytes = sum(a.numel() * a.element_size() for a in args + tuple(got))
            fp32_ms, fp32_by = bound(flops, nbytes)
            t_ops, t_bytes = flops / BF16_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
            tc_ms, tc_by = 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
            # the bound of the units the instance runs on: bf16 tensor cores or fp32 CUDA cores
            b_ms, b_by = (tc_ms, tc_by) if instance == "wgmma_bf16" else (fp32_ms, fp32_by)
            row.update(ms=time_ms(lambda: ssd_chunk_fwd(*args, chunk=chunk)),
                       plain_ms=time_ms(lambda: ssd_chunk_ref(*args, chunk=chunk), reps=3, iters=3),
                       library_ms=None, bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes,
                       fp32_core_bound_ms=fp32_ms, bf16_tensor_core_bound_ms=tc_ms,
                       flops_cb_per_head=flops_cb_per_head)
        del args, got, want, again
        return row

    rows = []
    # the Mamba2 run's shape (bf16 is its path, and fp32), then Jamba's in
    # bf16: N = 16, so 48 of each 64-wide C and B panel are the TMA box's
    # zero fill
    for shape, dt in ((SSD_MODEL_SHAPE, torch.bfloat16), (SSD_MODEL_SHAPE, torch.float32),
                      (SSD_JAMBA_SHAPE, torch.bfloat16), (SSD_SHARDED_SHAPE, torch.bfloat16)):
        r = case(shape, dt, True)
        rows.append(r)
        print(f"  B5 {r['shape']} {r['dtype']} ({r['instance']}, slab {r['slab']}): err "
              f"{r['max_abs_err']:.2e} ({r['rule']}: {r['err_ratio']}) kernel {r['ms']:.4f} ms "
              f"plain {r['plain_ms']:.3f} bound {r['bound_ms']:.4f} ({r['bound_by']}; "
              f"{r['flops'] / 1e9:.2f} GFLOP, {r['bytes'] / 1e6:.1f} MB; fp32 cores "
              f"{r['fp32_core_bound_ms']:.4f}, bf16 tensor cores "
              f"{r['bf16_tensor_core_bound_ms']:.4f}; C·Bᵀ counted per head "
              f"{r['flops_cb_per_head'] / 1e9:.1f} GFLOP)")
    check([r["instance"] for r in rows] == ["wgmma_bf16", "simt_fp32", "wgmma_bf16", "wgmma_bf16"],
          f"B5 at the model shapes: {[r['instance'] for r in rows]}")
    seen = set()
    for shape in SSD_CASES + [SSD_SHORT_CASE]:
        for dt in (torch.float32, torch.bfloat16):
            r = case(shape, dt, False)
            seen.add(r["instance"])
            print(f"  B5 case {shape} {r['dtype']} ({r['instance']}, slab {r['slab']}): err "
                  f"{r['max_abs_err']:.2e} ({r['rule']}: {r['err_ratio']})")
    check(seen == {"simt_fp32", "wgmma_bf16"}, f"B5 edge cases ran {seen}")
    print(f"B5 checks passed (fp32 {TOL_FP32} against the plain version, or SSD_FP64_FACTOR "
          f"{SSD_FP64_FACTOR} against fp64; decay and pref bitwise equal to the plain version; "
          f"bitwise equal on a rerun)")
    print(json.dumps({"ssd_chunk_shapes": rows}))
    torch.cuda.empty_cache()
    return rows, rows[0]["max_abs_err"]


def same_state(a, b) -> bool:
    """Two train states hold the same leaves at the same paths, bit for bit
    (tensors of one dtype and shape, ints equal)."""
    import torch

    from repro_torch.ckpt.manager import map_with_path

    xs, ys = [], []
    map_with_path(lambda p, x: xs.append((p, x)), a)
    map_with_path(lambda p, x: ys.append((p, x)), b)

    def equal(x, y):
        if isinstance(x, torch.Tensor):
            return (isinstance(y, torch.Tensor) and x.dtype == y.dtype and x.shape == y.shape
                    and bool(torch.equal(x, y)))
        return x == y

    return [p for p, _ in xs] == [p for p, _ in ys] and all(
        equal(x, y) for (_, x), (_, y) in zip(xs, ys))


def elastic_phase(dev, smi: str, held_b1: set, held_bwd: set, fwd_row, bwd_rows):
    """Phase 18: elastic training on the card.  (a) resume and restart on
    phase 5's plan bitwise equal to the uninterrupted run, with a planted
    lost momentum and a corrupted newest checkpoint; (b) the padded cluster
    loses the Jetson and replans onto the survivors' 1x3 grid, the live
    state bitwise equal to a fresh driver on that plan resumed from the
    step-1 checkpoint, the stored plan manifest that plan; (c) the original
    cluster plan resumes the 1x3 run's last checkpoint, the 7-step
    trajectory held to the untiled fp64 trainer (a momentum lost at the
    replan must fail it); (d) the bf16 LM's async save under its in-place
    step and its bitwise resume; the launcher with the elastic flags; B1-B3
    at the 1x3 plans' new shapes; the ``{"elastic": ...}`` numbers.  Returns
    (B1-B3 launches of the phase's runs, their B4/B6 launches, the B1, B2
    and B3 rows of the new shapes)."""
    import shutil
    import tempfile
    import threading

    import torch

    from repro_torch.ckpt.manager import CheckpointManager, map_with_path
    from repro_torch.configs.base import ParallelConfig, ShapeConfig, TrainConfig
    from repro_torch.configs.qwen2_7b import reduced
    from repro_torch.core.fusion import plan_from_manifest, plan_manifest
    from repro_torch.core.grouping import parse_cluster_spec
    from repro_torch.core.tiling import Group
    from repro_torch.data.synthetic import place, synth_batch
    from repro_torch.kernels.conv2d_tiled.kernel import (
        conv2d_dgrad_tile,
        conv2d_tile,
        conv2d_wgrad_tile,
        reset_launches,
    )
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.mesh import make_tile_mesh
    from repro_torch.launch.train import make_batch_fn, make_replan
    from repro_torch.models.registry import bundle_from_cfg
    from repro_torch.models.tiled_cnn import TiledCNNArch
    from repro_torch.models.yolo import make_yolo_tiled_arch
    from repro_torch.optim.optimizers import make_optimizer, tree_leaves, tree_map
    from repro_torch.runtime.driver import DriverConfig, run_training
    from repro_torch.runtime.faults import ClusterChange, FaultInjector, corrupt_leaf
    from repro_torch.train.trainer import TrainState, abstract_of, make_train_step

    conv = {"conv2d_tile": conv2d_tile, "conv2d_dgrad_tile": conv2d_dgrad_tile,
            "conv2d_wgrad_tile": conv2d_wgrad_tile}
    lm_kernels = {"flash_attention_fwd": fa_kernel.flash_attention_fwd,
                  "rmsnorm": rms_kernel.rmsnorm}
    launches18 = dict.fromkeys(conv, 0)
    lm_launches18 = dict.fromkeys(lm_kernels, 0)

    def reset_counts():
        for f in (*conv.values(), *lm_kernels.values()):
            f.launches = 0
        reset_launches()
        fa_kernel.reset_launches()
        rms_kernel.reset_launches()

    def counted():
        """The launches since the last reset, added to the phase's."""
        got = {k: f.launches for k, f in {**conv, **lm_kernels}.items()}
        for k in launches18:
            launches18[k] += got[k]
        for k in lm_launches18:
            lm_launches18[k] += got[k]
        return got

    def drive(init_state, train_step, make_batch, steps, cfg, replan=None, on_replan=None,
              sums=False, **kw):
        """One ``run_training`` on the card, the counts from 0: the run's
        report, final state, CUDA-event step ms, launches and, after a
        replan, its ms, the step index it happened at and the peak after
        it; with ``sums`` the params' checksums after each step, by the
        state's step count (phase 29(d) holds its ranks to them)."""
        rec = {"events": [], "checksums": {}}

        def timed(fn):
            def step(state, batch):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                state, m = fn(state, batch)
                b.record()
                rec["events"].append((a, b))
                rec["state"] = state
                if sums:
                    rec["checksums"][int(state.step)] = state_checksums(state.params)
                return state, m
            return step

        def replan_timed(ev):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn, man = replan(ev)
            rec["replan_ms"] = (time.perf_counter() - t0) * 1e3
            rec["replan_at"] = len(rec["events"])
            if on_replan is not None:
                on_replan()
            torch.cuda.reset_peak_memory_stats(dev)
            return timed(fn), man

        torch.cuda.synchronize()
        reset_counts()
        rec["report"] = run_training(init_state=init_state, train_step=timed(train_step),
                                     make_batch=make_batch, steps=steps, cfg=cfg, seed=SEED,
                                     replan=replan_timed if replan is not None else None, **kw)
        torch.cuda.synchronize()
        rec["launches"] = counted()
        rec["ms"] = [a.elapsed_time(b) for a, b in rec["events"]]
        rec["host_ms"] = [t * 1e3 for t in rec["report"].step_times]
        if replan is not None:
            rec["peak_after_replan"] = torch.cuda.max_memory_allocated(dev)
        return rec

    def normwise(a, b):
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    def per_mb(plan):
        return launches_per_batch(plan, TRAIN_BATCH // TRAIN_ACCUM)[0]

    def want_launches(*plan_steps):
        out = dict.fromkeys(conv, 0)
        for plan, steps in plan_steps:
            for k, v in per_mb(plan).items():
                out[k] += v * steps * TRAIN_ACCUM
        return out

    def zero_momentum(st):
        return st._replace(opt={**st.opt, "m": tree_map(torch.zeros_like, st.opt["m"])})

    pcfg = ParallelConfig(grad_accum=TRAIN_ACCUM)
    tcfg = TrainConfig(lr=TRAIN_LR, optimizer="sgd", warmup=0, steps=ELASTIC_STEPS, seed=SEED)
    root = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    out18 = {"card": smi}
    try:
        # (a) resume and restart on phase 5's 2x2 sync plan
        arch_a = make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=GRID[0], m=GRID[1],
                                      groups=[Group(*g) for g in _HAND], backend="cuda",
                                      device=dev)
        init_a, step_a = make_train_step(arch_a, pcfg, tcfg)
        mb_a = make_batch_fn(TRAIN_BATCH, INPUT_HW[0], arch_a.target_shape(TRAIN_BATCH), SEED,
                             dev)
        like_a, like_dev = abstract_of(init_a, SEED)
        check(like_dev == torch.device(dev) and all(
            x.device.type == "meta" for x in tree_leaves(like_a.params)),
              f"abstract state on {like_dev}, not meta leaves for the card")
        d_r, d_f = os.path.join(root, "resume"), os.path.join(root, "fail")
        run_u = drive(init_a, step_a, mb_a, 4, DriverConfig())
        run_r1 = drive(init_a, step_a, mb_a, 2, DriverConfig(ckpt_dir=d_r, ckpt_every=1))
        run_r2 = drive(init_a, step_a, mb_a, 4, DriverConfig(ckpt_dir=d_r, ckpt_every=1,
                                                              resume="always"))
        run_f = drive(init_a, step_a, mb_a, 4, DriverConfig(ckpt_dir=d_f, ckpt_every=1),
                      faults=FaultInjector(ELASTIC_FAIL_FAULTS))
        rep_r, rep_f = run_r2["report"], run_f["report"]
        print(f"18(a) sync 2x2: uninterrupted {run_u['report'].steps_done} steps; resumed at "
              f"step {rep_r.resumed_step} for {rep_r.steps_done}; under {ELASTIC_FAIL_FAULTS}: "
              f"{rep_f.steps_done} steps, restarts {rep_f.restarts}; launches U "
              f"{run_u['launches']} R {run_r1['launches']} + {run_r2['launches']} F "
              f"{run_f['launches']}")
        check(rep_r.resumed_step == 1 and rep_r.steps_done == 2, f"resume: {rep_r}")
        check(rep_f.restarts == 1 and rep_f.resumed_step is None, f"restart: {rep_f}")
        for name, run, steps in (("U", run_u, 4), ("R1", run_r1, 2), ("R2", run_r2, 2),
                                 ("F", run_f, 4)):
            want = want_launches((arch_a.plan, steps))
            got = {k: run["launches"][k] for k in conv}
            check(got == want, f"18(a) {name}: launches {got} != the code's {want}")
        resume_equal = same_state(run_r2["state"], run_u["state"])
        restart_equal = same_state(run_f["state"], run_u["state"])
        print(f"18(a) final states bit for bit: resumed {resume_equal}, restarted {restart_equal} "
              f"(step {run_u['state'].step}, opt t {run_u['state'].opt['t']})")
        check(resume_equal and restart_equal, "18(a): a resumed or restarted run's state differs "
              "from the uninterrupted run's")
        # planted: the momentum lost at the resume must fail the comparison
        mgr_r = CheckpointManager(d_r)
        st = zero_momentum(mgr_r.restore(like_a, step=1, device=dev))
        for s in (2, 3):
            st, _ = step_a(st, mb_a(s))
        planted_m = not same_state(st, run_u["state"])
        # planted: a corrupted newest checkpoint falls back one retained step
        mgr_f = CheckpointManager(d_f)
        kept = mgr_f.all_steps()
        corrupt_leaf(d_f, kept[-1])
        _, fell_to = mgr_f.restored_step(like_a, device=dev)
        try:
            mgr_f.restore(like_a, step=kept[-1], device=dev)
            explicit_raised = False
        except IOError:
            explicit_raised = True
        print(f"18(a) planted: a resume with the momentum zeroed rejected: {planted_m}; after "
              f"corrupt@{kept[-1]} of {kept} the restore fell back to step {fell_to}, the "
              f"explicit restore raised: {explicit_raised}")
        check(planted_m, "18(a): a resume with the momentum zeroed passed the comparison")
        check(fell_to == kept[-2] and explicit_raised, "18(a): corrupt fallback")

        # (e, first half) the checkpoint's size and the save and restore times
        final_a = run_u["state"]
        step_dir = os.path.join(d_r, "step_00000003")
        files = os.listdir(step_dir)
        ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in files)
        mgr_t = CheckpointManager(os.path.join(root, "timing"))
        blocking, snap, writer, restore = [], [], [], []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr_t.save(10 + i, final_a, blocking=True)
            blocking.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            mgr_t.save(20 + i, final_a, blocking=False)
            t1 = time.perf_counter()
            mgr_t.wait()
            t2 = time.perf_counter()
            snap.append((t1 - t0) * 1e3)
            writer.append((t2 - t1) * 1e3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            back = mgr_t.restore(like_a, step=20 + i, device=dev)
            torch.cuda.synchronize()
            restore.append((time.perf_counter() - t0) * 1e3)
        check(same_state(back, final_a), "18(e): the timed save and restore changed the state")
        del back
        out18.update(ckpt_bytes=ckpt_bytes, ckpt_files=len(files), save_blocking_ms=blocking,
                     save_async_snapshot_ms=snap, save_async_writer_ms=writer,
                     restore_with_crc_ms=restore)
        print(f"18(e) checkpoint {ckpt_bytes} bytes in {len(files)} files; blocking save "
              f"{statistics.median(blocking):.2f} ms, async {statistics.median(snap):.2f} ms "
              f"blocking + {statistics.median(writer):.2f} ms writer, restore with CRCs "
              f"{statistics.median(restore):.2f} ms (medians of 3; {smi})")
        del run_r1, run_r2, run_f, st
        torch.cuda.empty_cache()

        # (b) the padded cluster loses the Jetson at step 2
        cluster = parse_cluster_spec(_CLUSTER_KW["hw"], *GRID)
        arch_b = make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=GRID[0], m=GRID[1],
                                      groups="auto", ragged_exec="padded", backend="cuda",
                                      device=dev, **_CLUSTER_KW)
        plan0 = arch_b.plan
        init_b, step_b = make_train_step(arch_b, pcfg, tcfg)
        mb_b = make_batch_fn(TRAIN_BATCH, INPUT_HW[0], arch_b.target_shape(TRAIN_BATCH), SEED,
                             dev)
        replan = make_replan(arch_b, cluster, "pi3-core", TRAIN_BATCH, pcfg, tcfg)
        d_d, aside = os.path.join(root, "drop"), os.path.join(root, "aside")

        def copy_step1():
            src = os.path.join(d_d, "step_00000001")
            check(os.path.isdir(src), "18(b): no committed step-1 checkpoint at the replan")
            shutil.copytree(src, os.path.join(aside, "step_00000001"))

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run_d = drive(init_b, step_b, mb_b, 5, DriverConfig(ckpt_dir=d_d, ckpt_every=1),
                          replan=replan, on_replan=copy_step1, sums=True,
                          faults=FaultInjector(ELASTIC_DROP_FAULTS),
                          plan=plan_manifest(plan0, cluster))
        print(buf.getvalue(), end="")
        plan1, survivors = replan.live["plan"], replan.live["cluster"]
        rep_d = run_d["report"]
        print(f"18(b) cluster {[(g.start, g.end, g.mode) for g in plan0.groups]} cols "
              f"{plan0.partition.col_bounds} -> {plan1.n}x{plan1.m} cols "
              f"{plan1.partition.col_bounds} ({plan1.ragged_exec}); replans {rep_d.replans}, "
              f"restarts {rep_d.restarts}, launches {run_d['launches']}")
        check("replan (drop:jetson): grid=1x3" in buf.getvalue(), "18(b): no replan line")
        check(rep_d.replans == 1 and rep_d.restarts == 0 and rep_d.steps_done == 5,
              f"18(b): {rep_d}")
        check((plan1.n, plan1.m) == (1, 3) and plan1.ragged_exec == "padded",
              f"18(b): survivors' plan {plan1.n}x{plan1.m} {plan1.ragged_exec}")
        want = want_launches((plan0, 2), (plan1, 3))
        got = {k: run_d["launches"][k] for k in conv}
        check(got == want, f"18(b): launches {got} != the code's {want}")
        mgr_d = CheckpointManager(d_d)
        like_b = abstract_of(init_b, SEED)[0]
        for29 = {"drop": {"checksums": run_d["checksums"],
                          "ckpt": state_checksums(mgr_d.restore(like_b, step=4, device=dev))}}
        stored = mgr_d.plan_of()
        check(stored == json.loads(json.dumps(plan_manifest(plan1, survivors))),
              "18(b): the stored plan manifest is not the survivors' plan")
        check(plan_from_manifest(stored) == plan1, "18(b): plan_from_manifest of it")
        arch_1x3 = TiledCNNArch(plan=plan1, mesh=make_tile_mesh(plan1.n, plan1.m, dev),
                                loss_local=arch_b.loss_local)
        init_c, step_c = make_train_step(arch_1x3, pcfg, tcfg)
        run_b = drive(init_c, step_c, mb_b, 5, DriverConfig(ckpt_dir=aside, resume="always"))
        check(run_b["report"].resumed_step == 1 and run_b["report"].steps_done == 3,
              f"18(b): fresh 1x3 driver {run_b['report']}")
        check({k: run_b["launches"][k] for k in conv} == want_launches((plan1, 3)),
              f"18(b): fresh 1x3 launches {run_b['launches']}")
        drop_equal = same_state(run_b["state"], run_d["state"])
        print(f"18(b) the live state across the drop against a fresh 1x3 driver from the step-1 "
              f"checkpoint, bit for bit: {drop_equal}")
        check(drop_equal, "18(b): the dropped run's state differs from the 1x3 restore's")

        # (c) the original cluster plan resumes the 1x3 run's last checkpoint
        run_c = drive(init_b, step_b, mb_b, ELASTIC_STEPS,
                      DriverConfig(ckpt_dir=d_d, ckpt_every=1, resume="always"), sums=True)
        for29["resume"] = {"checksums": run_c["checksums"], "ckpt": state_checksums(
            mgr_d.restore(like_b, step=ELASTIC_STEPS - 1, device=dev))}
        check(run_c["report"].resumed_step == 4 and run_c["report"].steps_done == 2,
              f"18(c): {run_c['report']}")
        check({k: run_c["launches"][k] for k in conv} == want_launches((plan0, 2)),
              f"18(c): launches {run_c['launches']}")
        p0 = tree_leaves(init_b(SEED).params)
        names = [f"{i}.{k}" for i, p in enumerate(init_b(SEED).params) for k in p]
        segments = ((plan0, range(0, 2)), (plan1, range(2, 5)), (plan0, range(5, ELASTIC_STEPS)))

        def trajectory(backend, st=None, start=0, plans=None):
            """The 7 steps on the phase's plans in turn (or ``plans``, one a
            segment; the same batches), in fp32 through ``backend``, from
            ``st`` at step ``start``."""
            st = init_b(SEED) if st is None else st
            for plan, rng in zip(plans or [p for p, _ in segments], [r for _, r in segments]):
                arch = TiledCNNArch(plan=dataclasses.replace(plan, backend=backend),
                                    mesh=make_tile_mesh(plan.n, plan.m, dev),
                                    loss_local=arch_b.loss_local)
                _, stp = make_train_step(arch, pcfg, tcfg)
                for s in rng:
                    if s >= start:
                        st, _ = stp(st, mb_b(s))
            return tree_leaves(st.params)

        def untiled(dtype):
            ref = make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=1, m=1, backend="torch",
                                       device=dev)
            init, stp = make_train_step(ref, pcfg, tcfg)
            p = tree_map(lambda t: t.to(dtype), init(SEED).params)
            st = TrainState(p, make_optimizer("sgd").init(p), 0)
            for s in range(ELASTIC_STEPS):
                st, _ = stp(st, {k: v.to(dtype) for k, v in mb_b(s).items()})
            return tree_leaves(st.params)

        fin64 = untiled(torch.float64)
        upd64 = [a.double() - b.double() for a, b in zip(fin64, p0)]
        del fin64

        def upd_err(fin):
            return [normwise(a.double() - b.double(), u) for a, b, u in zip(fin, p0, upd64)]

        got_err = upd_err(tree_leaves(run_c["state"].params))
        # the same 7 steps held in memory through the kernels: the resume on
        # another partition continues the trajectory exactly
        in_memory = trajectory("cuda")
        resumed_equal = all(torch.equal(a, b) for a, b in
                            zip(tree_leaves(run_c["state"].params), in_memory))
        del in_memory
        # three fp32 trainers of the same steps: untiled, the cluster plan
        # alone and the phase's plan sequence, both on the torch backend
        e32 = {"untiled": upd_err(untiled(torch.float32)),
               "cluster_torch": upd_err(trajectory("torch", plans=(plan0, plan0, plan0))),
               "elastic_torch": upd_err(trajectory("torch"))}
        bars = [max(WGRAD_NORM_TOL, GRAD_FLOOR_FACTOR * max(e))
                for e in zip(*e32.values())]
        # planted: the momentum lost at the replan (the step-1 checkpoint is
        # the state entering step 2, where the drop replanned)
        lost = CheckpointManager(aside).restore(like_a, step=1, device=dev)
        lost_err = upd_err(trajectory("cuda", zero_momentum(lost), start=2))
        del lost
        worst = max(range(len(names)), key=lambda i: got_err[i] / bars[i])
        lost_over = max(e / b for e, b in zip(lost_err, bars))
        print(f"18(c) the {ELASTIC_STEPS}-step trajectory (2x2 cluster -> 1x3 -> 2x2): bitwise "
              f"equal to the same steps held in memory: {resumed_equal}; against the untiled "
              f"fp64 trainer: update err max {max(got_err):.2e}; fp32 trainers "
              + ", ".join(f"{k} {max(v):.2e}" for k, v in e32.items())
              + f"; nearest its bar {names[worst]} {got_err[worst]:.2e}, "
              f"{got_err[worst] / bars[worst]:.2f} of its bar (of a bar from the untiled fp32 "
              f"trainer alone: {got_err[worst] / max(WGRAD_NORM_TOL, GRAD_FLOOR_FACTOR * e32['untiled'][worst]):.2f}); "
              f"a momentum lost at the replan {lost_over:.1f}x its bar")
        for29["bar"] = {"names": names, "p0": [t.cpu() for t in p0],
                        "upd64": [u.cpu() for u in upd64], "bars": bars,
                        "err": got_err, "lost_over": lost_over}
        check(resumed_equal, "18(c): the resumed trajectory differs from the in-memory one")
        for n, e, bar in zip(names, got_err, bars):
            check(e <= bar, f"18(c) param update {n}: normwise err {e} over {bar}")
        check(lost_over > 1.0, "18(c): a momentum lost at the replan passed the bar")
        before = [run_d["ms"][1]] + run_c["ms"]
        after = run_d["ms"][run_d["replan_at"] + 1:]
        host_before = [run_d["host_ms"][1]] + run_c["host_ms"]
        host_after = run_d["host_ms"][run_d["replan_at"] + 1:]
        out18.update(
            replan_ms=run_d["replan_ms"],
            first_step_after_replan_ms=run_d["ms"][run_d["replan_at"]],
            first_step_after_replan_host_ms=run_d["host_ms"][run_d["replan_at"]],
            step_ms_2x2_cluster=before, step_ms_1x3=after,
            step_ms_median_2x2_cluster=statistics.median(before),
            step_ms_median_1x3=statistics.median(after),
            step_ms_host_median_2x2_cluster=statistics.median(host_before),
            step_ms_host_median_1x3=statistics.median(host_after),
            peak_mem_after_replan_bytes=run_d["peak_after_replan"],
            drop_step_ms=run_d["ms"], plan_1x3={
                "cols": list(plan1.partition.col_bounds), "ragged_exec": plan1.ragged_exec,
                "groups": [[g.start, g.end, g.mode] for g in plan1.groups]},
            bitwise={"resume": resume_equal, "restart": restart_equal, "drop": drop_equal},
            planted={"momentum_zeroed_at_resume_rejected": planted_m,
                     "corrupt_fallback": [kept[-1], fell_to],
                     "explicit_restore_of_corrupt_raised": explicit_raised,
                     "momentum_lost_at_replan_err_over_bar": lost_over},
            trajectory={"bitwise_vs_in_memory": resumed_equal, "update_err_max": max(got_err),
                        **{f"fp32_{k}_max": max(v) for k, v in e32.items()},
                        "nearest": names[worst], "nearest_over_bar": got_err[worst] / bars[worst],
                        "per_leaf": {n: [e, *x] for n, e, *x in
                                     zip(names, got_err, *e32.values())}})
        del run_d, run_b, run_c, upd64
        torch.cuda.empty_cache()

        # B1-B3 at the survivors' new shapes: the padded 1x3 plan above and
        # the launcher's spec twin below
        spec0 = make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=GRID[0], m=GRID[1],
                                     groups="auto", backend="cuda", device=dev, **_CLUSTER_KW)
        spec_replan = make_replan(spec0, cluster, "pi3-core", TRAIN_BATCH, pcfg, tcfg)
        spec_replan(ClusterChange("drop", "jetson", 2))
        spec1 = spec_replan.live["plan"]
        check((spec1.n, spec1.m, spec1.ragged_exec) == (1, 3, "spec"), "18: the spec replan")

        def shape_key(s):
            return s["x"], s["w"], s["stride"]

        new_tr18 = {shape_key(s): s for p in (plan1, spec1)
                    for s in conv_shapes(p, TRAIN_BATCH // TRAIN_ACCUM)
                    if shape_key(s) not in held_bwd}
        print(f"phase 18 plans: {len(new_tr18)} new microbatch-4 shapes")
        check(new_tr18, "the phase-18 plans give B1-B3 no new shape")
        fwd18 = [dict(fwd_row(s), piece=s["piece"]) for k, s in new_tr18.items()
                 if k not in held_b1]
        bwd18 = [bwd_rows(s) for s in new_tr18.values()]
        dgrad18 = [d for d, _ in bwd18 if d]
        wgrad18 = [w for _, w in bwd18]
        kernel_ms18 = {}
        for rows18, what in ((fwd18, "conv2d_tile"), (dgrad18, "conv2d_dgrad_tile"),
                             (wgrad18, "conv2d_wgrad_tile")):
            kernel_ms18[what] = {k: sum(r[k] for r in rows18)
                                 for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
            kernel_ms18[what]["shapes"] = len(rows18)
            print(f"{what} at the {len(rows18)} new phase-18 shapes: kernel "
                  f"{kernel_ms18[what]['ms']:.4f} ms, cudnn "
                  f"{kernel_ms18[what]['library_ms']:.4f} ms, plain "
                  f"{kernel_ms18[what]['plain_ms']:.4f} ms, bound "
                  f"{kernel_ms18[what]['bound_ms']:.4f} ms")
        print(json.dumps({"phase18_conv_shapes": fwd18}))
        print(json.dumps({"phase18_dgrad_shapes": dgrad18}))
        print(json.dumps({"phase18_wgrad_shapes": wgrad18}))
        out18["kernel_ms_new_shapes"] = kernel_ms18

        # the launcher, as a user runs elastic training on the cluster
        d_l = os.path.join(root, "launcher")
        base = ["--arch", "yolov2-tiled", "--input-hw", str(INPUT_HW[0]), "--depth", "16",
                "--grid", str(GRID[0]), "--cluster", _CLUSTER_KW["hw"], "--groups", "auto",
                "--batch", str(TRAIN_BATCH), "--grad-accum", str(TRAIN_ACCUM), "--ckpt-dir", d_l,
                "--ckpt-every", "1"]
        lines = []
        for argv, want_done in ((["--steps", "4", "--fault-schedule", ELASTIC_LAUNCHER_FAULTS],
                                 "done: steps=4 restarts=0 replans=1"),
                                (["--steps", "6", "--resume", "always"],
                                 "done: steps=2 restarts=0 replans=0")):
            reset_counts()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = train_launcher.main(base + argv)
            print(buf.getvalue(), end="")
            got = counted()
            print(f"phase-18 launcher {' '.join(argv)}: rc {rc}, launches "
                  f"{ {k: got[k] for k in conv} }")
            check(rc == 0 and want_done in buf.getvalue(),
                  f"train launcher {' '.join(argv)}: no '{want_done}'")
            if "--fault-schedule" in argv:
                check("replan (drop:jetson): grid=1x3" in buf.getvalue(),
                      "train launcher: no replan line")
            check(all(got[k] > 0 for k in conv), f"train launcher launched {got}")
            lines += [ln for ln in buf.getvalue().splitlines()
                      if ln.startswith(("replan", "done:"))]
        out18["launcher_lines"] = lines

        # (d) the LM path: reduced Qwen2-7B, bf16 params, AdamW in place
        cfg_lm = dataclasses.replace(reduced(), dtype="bfloat16", param_dtype="bfloat16")
        lm = bundle_from_cfg(cfg_lm, dev)
        lm_pcfg = ParallelConfig(grad_accum=ELASTIC_LM_ACCUM)
        lm_tcfg = TrainConfig(warmup=0, steps=ELASTIC_LM_STEPS, seed=SEED)
        init_l, step_l = make_train_step(lm, lm_pcfg, lm_tcfg)
        specs = lm.input_specs(ShapeConfig("elastic", ELASTIC_LM_SEQ, ELASTIC_LM_BATCH, "train"))

        def mb_l(s):
            return place(synth_batch(specs, cfg_lm, SEED, s), dev)

        like_l, like_l_dev = abstract_of(init_l, SEED)
        check(like_l_dev == torch.device(dev) and like_l.params["embed"].device.type == "meta"
              and like_l.params["embed"].dtype == torch.bfloat16,
              f"18(d): abstract LM state {like_l_dev} {like_l.params['embed']}")
        d_lm = os.path.join(root, "lm")
        run_lu = drive(init_l, step_l, mb_l, ELASTIC_LM_STEPS, DriverConfig())
        run_la = drive(init_l, step_l, mb_l, ELASTIC_LM_STEPS,
                       DriverConfig(ckpt_dir=d_lm, ckpt_every=2))     # async: step 1 under step 2
        shutil.rmtree(os.path.join(d_lm, f"step_{ELASTIC_LM_STEPS - 1:08d}"))
        run_lr = drive(init_l, step_l, mb_l, ELASTIC_LM_STEPS,
                       DriverConfig(ckpt_dir=d_lm, resume="always"))
        dtypes = {e["path"]: e["dtype"] for e in CheckpointManager(d_lm).read_manifest(1)["leaves"]}
        check(dtypes["params/embed"] == "bfloat16" and dtypes["opt/m/embed"] == "float32"
              and dtypes["opt/t"] == dtypes["step"] == "int32", f"18(d): stored dtypes {dtypes}")
        check(run_lr["report"].resumed_step == 1 and run_lr["report"].steps_done == 2,
              f"18(d): {run_lr['report']}")
        lm_async_equal = same_state(run_la["state"], run_lu["state"])
        lm_resume_equal = same_state(run_lr["state"], run_lu["state"])
        # the snapshot against the in-place step, the writer held until
        # the next step has run
        mgr_g = CheckpointManager(os.path.join(root, "lm_gate"))
        gate = threading.Event()
        mgr_g.write_fault = lambda i: gate.wait(120)
        st = init_l(SEED)
        st, _ = step_l(st, mb_l(0))
        expect = map_with_path(lambda p, x: x.clone() if isinstance(x, torch.Tensor) else x, st)
        mgr_g.save(0, st, blocking=False)
        st, _ = step_l(st, mb_l(1))
        torch.cuda.synchronize()
        gate.set()
        mgr_g.wait()
        moved = not torch.equal(st.params["embed"], expect.params["embed"])
        snapshot_equal = same_state(mgr_g.restore(like_l, step=0, device=dev), expect)
        per = lm_launches_per_microbatch(cfg_lm, lm_pcfg.remat)
        lm_want = {k: per[k] * ELASTIC_LM_ACCUM * (2 * ELASTIC_LM_STEPS + 2) for k in lm_kernels}
        lm_got = {k: run_lu["launches"][k] + run_la["launches"][k] + run_lr["launches"][k]
                  for k in lm_kernels}
        print(f"18(d) reduced Qwen2-7B, bf16 params, AdamW in place: async save and resume at "
              f"step 1 bit for bit {lm_resume_equal} (the async run itself {lm_async_equal}); "
              f"the snapshot held the saved step's values while the next step updated in place: "
              f"{snapshot_equal} (live leaves moved: {moved}); launches {lm_got} (the code's "
              f"{lm_want})")
        check(lm_async_equal and lm_resume_equal, "18(d): the LM resume is not bitwise")
        check(snapshot_equal and moved, "18(d): the async snapshot is not the saved step's")
        check(lm_got == lm_want, f"18(d): LM launches {lm_got} != {lm_want}")
        out18["bitwise"].update(lm_resume=lm_resume_equal, lm_async_snapshot=snapshot_equal)
        out18["launches"] = {**launches18, **lm_launches18}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"elastic": out18}))
    print(json.dumps({"phase18_launches": out18["launches"]}))
    torch.cuda.empty_cache()
    return launches18, lm_launches18, fwd18, dgrad18, wgrad18, for29


def decode_vs_forward(cfg, arch, params, tokens, decode_fault=None,
                      forward_kw=None) -> tuple[float, float]:
    """(max err, ratio to DECODE_BAR) of ``decode_step``'s logits, token by
    token from empty caches, against ``apply_lm``'s (given ``forward_kw``:
    a VLM's positions and patch embeddings); ``decode_fault`` (a
    ``swapped`` context) is applied around the decode alone."""
    import torch

    from repro_torch.models.lm import apply_lm, lm_head_weight

    head = lm_head_weight(params, cfg).to(cfg.act_dtype)
    full = (apply_lm(params, tokens, cfg, **(forward_kw or {})) @ head.T).float()
    caches = arch.make_caches(tokens.shape[0], tokens.shape[1])
    with decode_fault or contextlib.nullcontext():
        dec = torch.stack([arch.decode_fn(params, tokens[:, t:t + 1], caches)[0][:, 0]
                           for t in range(tokens.shape[1])], 1)
    return err_stats(dec, full, **DECODE_BAR)


def served_logits(arch, params, reqs, target):
    """The target request's logits at each of its ticks and its answer, from
    a 3-slot engine serving ``reqs`` ((rid, prompt, new) triples)."""
    import torch

    import repro_torch.serve.engine as engine_mod
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(arch, params, batch=3, max_seq=LM_SERVE_FORCED)
    seen = []
    real = engine_mod.sample_logits

    def record(logits, generator, temperature):
        slot = [i for i, r in enumerate(eng.slots) if r is not None and r.rid == target]
        if slot:
            seen.append(logits[slot[0], -1].clone())
        return real(logits, generator, temperature)

    with swapped((engine_mod, "sample_logits", record)):
        for rid, p, n in reqs:
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=n))
        done = {r.rid: r for r in eng.run()}
    return torch.stack(seen), done[target].out_tokens


def beside_vs_alone(name, cfg, arch, params, rng) -> dict:
    """Phases 19(c) and 21(a): a request admitted into a recycled slot beside
    two others gives, bit for bit, the logits and tokens it gives alone in
    the same 3-slot engine."""
    import numpy as np
    import torch

    p = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (5, 9, 7, 11)]
    beside = [(0, p[0], 3), (1, p[1], 12), (2, p[2], 12), (3, p[3], 8)]
    got, got_toks = served_logits(arch, params, beside, 3)
    want, want_toks = served_logits(arch, params, [(3, p[3], 8)], 3)
    same = got.shape == want.shape == (8, cfg.vocab) and bool(torch.equal(got, want))
    c_err = float((got - want).abs().max()) if got.shape == want.shape else float("nan")
    print(f"{name}: a request admitted into a recycled slot beside two others vs alone: "
          f"logits {'the same bits' if same else f'differ by up to {c_err:.3e}'}, tokens "
          f"{'equal' if got_toks == want_toks else 'differ'}")
    check(same and got_toks == want_toks,
          f"{name}: the request's logits or tokens depend on the other slots ({c_err})")
    return dict(beside_vs_alone_err=c_err, beside_vs_alone_same_bits=same,
                beside_vs_alone_same_tokens=got_toks == want_toks)


def lm_serve_drive(dev, smi: str, name: str, depth=None, requests: int = LM_SERVE_REQUESTS,
                   prompt: tuple = LM_SERVE_PROMPT, new: int = LM_SERVE_NEW) -> int:
    """One full-width serving cell (phases 19-21): ``name``'s published
    config in bf16 (cut to its first ``depth`` layers where given), seed-0
    params, ``requests`` prompts of
    ``prompt`` tokens (numpy's default_rng(SEED)), ``new`` greedy
    tokens each over LM_SERVE_SLOTS slots (by default LM_SERVE_REQUESTS of
    LM_SERVE_PROMPT, LM_SERVE_NEW).  Checks every request complete,
    finite logits, B6's launches the code's count (``b6_per_decode_call`` x
    the prefill tokens plus the ticks) and no B4 or B5 launch, and init's
    peak (beyond what was allocated before it) within INIT_PEAK_SLACK of
    the params' bytes plus the largest fp32 draw; prints the ``{"lm_serve":
    ...}`` line, with the tick's bound: every weight a decode call reads (all
    but the embedding table, of which it gathers a row a slot, and an MTP
    head, which decode never runs; for Whisper the decoder's layers and
    norm and the embedding as its head, not the encoder or the position
    table) over HBM bandwidth.  Returns B6's
    launches."""
    import gc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.serve.engine as engine_mod
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.kernel import reset_launches as reset_b4_launches
    from repro_torch.kernels.rmsnorm.kernel import reset_launches as reset_b6_launches
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    from repro_torch.kernels.ssd_chunk.kernel import reset_launches as reset_b5_launches
    from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk_fwd
    from repro_torch.models.registry import bundle_from_cfg, load_config
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = load_config(name)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    arch = bundle_from_cfg(cfg, dev)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    reserved = torch.cuda.memory_reserved(dev)
    print(f"{name} serve: before init {before / 1e9:.3f} GB allocated, {reserved / 1e9:.3f} GB "
          f"reserved")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = arch.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    # init draws each leaf in fp32, then casts it (models/common.py): a
    # stacked leaf (an LM's segments, Whisper's enc and dec) one row (one
    # layer) at a time
    stacked = ("segments", "enc", "dec")
    largest_draw = 4 * max([t.numel() for k, v in params.items() if k not in stacked
                            for t in tree_leaves(v)]
                           + [t[0].numel() for k in stacked for t in tree_leaves(params.get(k, {}))])
    init_peak = torch.cuda.max_memory_allocated(dev)
    init_bar = INIT_PEAK_SLACK * (param_bytes + largest_draw)
    embed = params["embed"]

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    mtp_bytes = nbytes(params.get("mtp", {}))
    if cfg.encoder_decoder:
        read_bytes = nbytes([params["dec"], params["dec_norm"], embed])
    else:
        read_bytes = param_bytes - mtp_bytes - nbytes(embed) * (not cfg.tie_embeddings)
    tick_bound_ms = 1e3 * read_bytes / HBM_BYTES_PER_S
    print(f"{name} init: {n_params / 1e9:.3f} B params ({param_bytes / 1e9:.3f} GB) in "
          f"{init_s:.2f} s, peak {init_peak / 1e9:.3f} GB ({(init_peak - before) / 1e9:.3f} GB "
          f"beyond what was allocated before), bar {init_bar / 1e9:.3f} GB (params + the largest "
          f"fp32 draw {largest_draw / 1e9:.3f} GB, x{INIT_PEAK_SLACK})")
    check(init_peak - before <= init_bar, f"{name}: init's peak {init_peak - before} over "
          f"{init_bar}")
    torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(SEED)
    lo, hi = prompt
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(lo, hi + 1))).astype(np.int32)
               for _ in range(requests)]
    eng = ServeEngine(arch, params, batch=LM_SERVE_SLOTS, max_seq=LM_SERVE_MAX_SEQ)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=new))
    finite = []
    real = engine_mod.sample_logits

    def finite_sample(logits, generator, temperature):
        finite.append(torch.isfinite(logits).all())
        return real(logits, generator, temperature)

    prefill_ms, tick_ev, tick_host = [], [], []
    torch.cuda.synchronize()
    reset_b4_launches()
    reset_b5_launches()
    reset_b6_launches()
    t_start = time.perf_counter()
    with swapped((engine_mod, "sample_logits", finite_sample)):
        while eng.queue or any(r is not None for r in eng.slots):
            n0, t0 = eng.prefill_calls, time.perf_counter()
            eng._admit()
            if eng.prefill_calls > n0:
                torch.cuda.synchronize()
                prefill_ms.append(((time.perf_counter() - t0) * 1e3, eng.prefill_calls - n0))
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            h0 = time.perf_counter()
            eng.tick()                       # reads the sampled tokens back: synchronised
            tick_host.append((time.perf_counter() - h0) * 1e3)
            b.record()
            b.synchronize()
            tick_ev.append(a.elapsed_time(b))
    wall_s = time.perf_counter() - t_start
    launches = rmsnorm.launches
    by_instance = {k: v for k, v in rmsnorm.launches_by_instance.items() if v}
    others = flash_attention_fwd.launches + ssd_chunk_fwd.launches
    done = eng._finished
    per_call = b6_per_decode_call(cfg)
    want = per_call * (eng.prefill_tokens + eng.decode_calls)
    if eng.capture:
        # a replay launches no Python: the drive's launches are each graph's
        # (counted at its capture, before the drive) times its replays
        graphs = eng.graph_launches
        prefill = [graphs[f"prefill/{i}"] for i in range(LM_SERVE_SLOTS)]
        check(launches == 0 and others == 0,
              f"{name}: {launches} B6 and {others} B4/B5 launches from the host while replaying")
        check(graphs["tick"].get("rmsnorm", 0) == per_call
              and all(g == graphs["tick"] for g in prefill)
              and not any(k.startswith(("flash", "ssd")) for k in graphs["tick"]),
              f"{name}: graph launches {graphs} != {per_call} B6 a decode call")
        check(eng.replays == {"tick": eng.decode_calls, "prefill": eng.prefill_tokens},
              f"{name}: replays {eng.replays}")
        calls = eng.decode_calls + eng.prefill_tokens
        launches = graphs["tick"].get("rmsnorm", 0) * calls
        by_instance = {k.split("/", 1)[1]: v * calls for k, v in graphs["tick"].items()
                       if k.startswith("rmsnorm/") and v}
    toks = sum(len(r.out_tokens) for r in done)
    print(f"{name} serve: {cfg.n_layers} layers, {n_params / 1e9:.3f} B params, {len(done)} "
          f"requests, {toks} tokens in {wall_s:.2f} s ({toks / wall_s:.1f} tok/s), "
          f"{eng.decode_calls} ticks, {eng.prefill_tokens} prefill tokens; B6 launches "
          f"{launches} by instance {by_instance} (the code's count {per_call} a call x "
          f"{eng.prefill_tokens + eng.decode_calls} calls = {want})")
    check(sorted(r.rid for r in done) == list(range(requests))
          and all(len(r.out_tokens) == new for r in done),
          f"{name}: requests {[(r.rid, len(r.out_tokens)) for r in done]}")
    check(not eng.queue and eng.slots == [None] * LM_SERVE_SLOTS, f"{name}: engine not drained")
    check(all(0 <= t < cfg.vocab for r in done for t in r.out_tokens), f"{name}: token ids")
    check(bool(torch.stack(finite).all()), f"{name}: non-finite logits")
    check(eng.prefill_calls == requests
          and eng.prefill_tokens == sum(len(p) - 1 for p in prompts)
          and eng.decode_calls == len(tick_ev), f"{name}: engine counters")
    # more requests than slots: the queued ones were admitted into freed slots
    check(requests <= LM_SERVE_SLOTS or len(prefill_ms) > 1,
          f"{name}: {requests} requests admitted in one round over {LM_SERVE_SLOTS} slots")
    check(launches == want and sum(by_instance.values()) == launches,
          f"{name}: B6 launches {launches} ({by_instance}) != the code's {want}")
    check(others == 0, f"{name}: decode launched B4/B5 {others} times")
    peak = torch.cuda.max_memory_allocated(dev)
    drive = {"requests": len(done), "prompt_tokens": sum(len(p) for p in prompts),
             "new_tokens": toks, "ticks": eng.decode_calls,
             "prefill_calls": eng.prefill_calls, "prefill_tokens": eng.prefill_tokens,
             "wall_s": wall_s, "tokens_per_s": toks / wall_s, "captured": eng.capture,
             "graph_pool_bytes": sum(eng.graph_pool_bytes.values())}
    decode_compare(dev, smi, name, cfg, arch, params)

    # one profiled window of ticks with every slot busy
    for rid, p in enumerate(prompts[:LM_SERVE_SLOTS]):
        eng.submit(Request(rid=100 + rid, prompt=p[:8], max_new_tokens=8))
    eng._admit()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            eng.tick()
        torch.cuda.synchronize()
        prof_tick_ms = (time.perf_counter() - t0) * 1e3 / 4
    by_name = device_ms_by_name(prof, 4)
    dev_ms = sum(by_name.values())
    check(dev_ms > 0, f"{name}: the profiler saw no device time in a tick")
    b6_ms = sum(v for k, v in by_name.items() if LM_KERNEL_TRACE_NAMES["rmsnorm"] in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]

    def spread(v):
        return {"median": statistics.median(v), "mean": statistics.fmean(v), "min": min(v),
                "max": max(v), "n": len(v)}

    print(json.dumps({"lm_serve": {name: {
        "layers": cfg.n_layers, "params": n_params, "param_bytes": param_bytes,
        "dtype": cfg.dtype, "slots": LM_SERVE_SLOTS, "max_seq": LM_SERVE_MAX_SEQ, **drive,
        "tick_ms_cuda_events": spread(tick_ev), "tick_ms_host": spread(tick_host),
        "tick_bound_ms_weight_reads": tick_bound_ms, "mtp_param_bytes": mtp_bytes,
        # each admission round: its ms over the requests it admitted
        "prefill_ms_per_request": [ms / n for ms, n in prefill_ms],
        "prefill_ms_per_token": sum(ms for ms, _ in prefill_ms)
        / max(1, drive["prefill_tokens"]),
        "profiled_tick": {"wall_ms": prof_tick_ms, "device_ms": dev_ms, "b6_ms": b6_ms,
                          "idle_share": max(0.0, 1 - dev_ms / prof_tick_ms),
                          # against the unprofiled ticks (CUDA events, median of the drive)
                          "idle_share_vs_event_tick":
                              max(0.0, 1 - dev_ms / statistics.median(tick_ev)),
                          "top": [[k[:80], v] for k, v in top]},
        "peak_mem_bytes": peak, "init_peak_mem_bytes": init_peak,
        "allocated_before_init_bytes": before, "init_s": init_s,
        "b6_launches": launches, "b6_launches_expected": want,
        "b6_launches_by_instance": by_instance, "card": smi,
    }}}))
    del eng, params, leaves, arch, prof
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def lm_serve_phase(dev, smi: str) -> int:
    """Phase 19: LM serving on the card.  (d) B6 at the decode shapes against
    its plain version, the same bits on a rerun; (b) at full width, 2
    layers, fp32: LM_SERVE_FORCED tokens teacher-forced through
    ``decode_step`` against ``apply_lm`` (B4 or B5, and B6) within
    DECODE_BAR, and planted faults rejected (a KV cache written one row
    late; a conv ring rolled one position, an SSM state never written
    back); (c) at the same size, a request admitted into a recycled slot
    beside two others gives the bits it gives alone; (a, e) Qwen2-7B and Mamba2-780m at full
    width and depth, bf16, served through ``ServeEngine``: every request
    complete, B6's launches the code's count, the ``{"lm_serve": ...}`` line;
    the LM serve launcher on the card.  Returns B6's launches of the two
    full-width serve drives."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    import repro_torch.models.attention as attn_mod
    import repro_torch.models.mamba2 as mamba_mod
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.kernel import reset_launches as reset_b4_launches
    from repro_torch.kernels.rmsnorm.kernel import rms_instance, rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssd_chunk.kernel import reset_launches as reset_b5_launches
    from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk_fwd
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.models.registry import bundle_from_cfg, load_config, with_depth

    # -- (d) B6 at the decode shapes: rows = slots, (B, 1, D) as decode gives it
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    # every B6 width of the configs phases 19 to 22 serve
    widths = sorted({d for name in LM_SERVE_ARCHS + DENSE_ARCHS + MOE_ARCHS + (DS_ARCH,)
                     for d in b6_widths(load_config(name))})
    lib = getattr(F, "rms_norm", None)
    rms_rows = []
    for dt in (torch.bfloat16, torch.float32):
        tol = TOL_BF16 if dt == torch.bfloat16 else TOL_FP32
        for d in widths:
            for rows in RMS_DECODE_ROWS:
                x = torch.randn((rows, 1, d), generator=gen, device=dev).to(dt)
                sc = (1 + 0.1 * torch.randn((d,), generator=gen, device=dev)).to(dt)
                instance = rms_instance(dt, dt, d, x.data_ptr() % 16 == 0 and sc.data_ptr() % 16 == 0)
                before = rmsnorm.launches_by_instance[instance]
                got, again, want = rmsnorm(x, sc), rmsnorm(x, sc), rmsnorm_ref(x, sc)
                torch.cuda.synchronize()
                check(rmsnorm.launches_by_instance[instance] == before + 2,
                      f"B6 ({rows}, 1, {d}) {dt}: not {instance}")
                err, ratio = err_stats(got, want, **tol)
                check(ratio <= 1.0, f"B6 decode ({rows}, 1, {d}) {dt} ({instance}): max err {err} "
                                    f"over tolerance {tol}")
                check(torch.equal(got, again), f"B6 decode ({rows}, 1, {d}) {dt}: other bits on a rerun")
                nbytes = 2 * x.numel() * x.element_size() + sc.numel() * sc.element_size()
                b_ms, b_by = bound(4 * x.numel(), nbytes)
                row = dict(shape=[rows, 1, d], dtype=str(dt), instance=instance, max_abs_err=err,
                           err_ratio=ratio, ms=time_ms(lambda: rmsnorm(x, sc)),
                           plain_ms=time_ms(lambda: rmsnorm_ref(x, sc)),
                           library_ms=None if lib is None else time_ms(lambda: lib(x, (d,), sc, 1e-6)),
                           device_ms=graph_ms(lambda: rmsnorm(x, sc)), bound_ms=b_ms, bound_by=b_by)
                rms_rows.append(row)
                print(f"  B6 decode {row['shape']} {dt} ({instance}): err {err:.2e} ({ratio:.3f} of "
                      f"tol), same bits on a rerun; kernel {row['ms']:.4f} ms (device "
                      f"{row['device_ms']:.4f}) plain {row['plain_ms']:.4f} F.rms_norm "
                      f"{row['library_ms']} bound {b_ms:.6f} ({b_by})")
    print(json.dumps({"rmsnorm_decode_shapes": rms_rows}))

    # -- (b, c) full width, 2 layers, fp32 ----------------------------------------
    def late(pos, s, ring):          # the planted fault: each K/V row one row late
        return (pos + 1) % s if ring else torch.clamp(pos + 1, max=s - 1)

    real_mamba_decode = mamba_mod.mamba_decode

    def ring_rolled(params, u, state, cfg):      # the conv ring one position out
        out, state = real_mamba_decode(params, u, state, cfg)
        state.conv.copy_(torch.roll(state.conv, 1, dims=1))
        return out, state

    def ssm_stale(params, u, state, cfg):        # the SSM state never written back
        old = state.ssm.clone()
        out, state = real_mamba_decode(params, u, state, cfg)
        state.ssm.copy_(old)
        return out, state

    checks = {}
    rng = np.random.default_rng(SEED + 19)
    for name in LM_SERVE_ARCHS:
        cfg = dataclasses.replace(with_depth(load_config(name), LM_GRAD_DEPTH), dtype="float32",
                                  param_dtype="float32")
        arch = bundle_from_cfg(cfg, dev)
        params = arch.init(SEED)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, LM_SERVE_FORCED))).to(dev)
        with torch.no_grad():
            reset_b4_launches()
            reset_b5_launches()
            err, ratio = decode_vs_forward(cfg, arch, params, tokens)
            kernels = {k: v for f in (flash_attention_fwd, ssd_chunk_fwd)
                       for k, v in f.launches_by_instance.items() if v}
            out = dict(decode_vs_forward_err=err, decode_vs_forward_ratio=ratio,
                       forward_kernels=kernels)
            print(f"{name} (full width, {LM_GRAD_DEPTH} layers, fp32): {LM_SERVE_FORCED} tokens "
                  f"teacher-forced through decode_step vs apply_lm ({kernels}): max err {err:.3e}, "
                  f"{ratio:.4f} of the bar {DECODE_BAR}")
            check(ratio <= 1.0, f"{name} decode vs the full forward: {err} over {DECODE_BAR}")
            check(kernels and all(k.startswith("simt_fp32") for k in kernels),
                  f"{name} fp32 forward: kernels {kernels}")
            faults = ({"late_row": (attn_mod, "_write_slot", late)} if cfg.ssm is None else
                      {"conv_ring_rolled": (mamba_mod, "mamba_decode", ring_rolled),
                       "ssm_state_stale": (mamba_mod, "mamba_decode", ssm_stale)})
            for fault, swap in faults.items():
                f_err, f_ratio = decode_vs_forward(cfg, arch, params, tokens, swapped(swap))
                out.update({f"planted_{fault}_err": f_err, f"planted_{fault}_ratio": f_ratio})
                print(f"planted fault ({fault}): max err {f_err:.3e}, {f_ratio:.1f}x the bar")
                check(f_ratio > 1.0, f"{name}: the decode check passed the planted fault {fault} "
                                     f"({f_err})")
            # (c) a request admitted into a recycled slot beside two others, and alone
            out.update(beside_vs_alone(name, cfg, arch, params, rng))
        checks[name] = out
        del arch, params, tokens
        torch.cuda.empty_cache()
    print(json.dumps({"lm_decode_checks": checks}))

    # -- (a, e) full width and depth, bf16: the serving path --------------------------
    b6_launches = sum(lm_serve_drive(dev, smi, name) for name in LM_SERVE_ARCHS)

    # the launcher's LM mode on the card (the reduced configs, as the reference's)
    for name in LM_SERVE_ARCHS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = serve_launcher.main(["--arch", name, "--requests", "8"])
        print(buf.getvalue(), end="")
        check(rc == 0 and "served 8 requests, 128 tokens" in buf.getvalue()
              and "on cuda" in buf.getvalue(), f"LM serve launcher --arch {name}")
    return b6_launches


def add_noise(params, gen, dev) -> list:
    """DENSE_NOISE x N(0, 1) added to every bias and norm leaf (at init 0 and
    1, which would hide those branches); their paths."""
    import torch

    noisy = [(path, leaf) for path, leaf in named_leaves(params)
             if "/b_" in path or "norm" in path]
    for _, leaf in noisy:
        leaf.add_(DENSE_NOISE * torch.randn(leaf.shape, generator=gen, device=dev))
    return [path for path, _ in noisy]


def run_launchers(arch_id: str, optimizer=None) -> None:
    """Phases 21-24(d): both launchers with ``arch_id`` (reduced) on the
    card, the train launcher with ``optimizer`` where given."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher

    opt = ["--optimizer", optimizer] if optimizer else []
    for launcher, argv, want in (
            (train_launcher, ["--arch", arch_id, *opt, "--steps", "2", "--batch", "2", "--seq",
                              "32"], "done: steps=2 restarts=0"),
            (serve_launcher, ["--arch", arch_id, "--requests", "8"],
             "served 8 requests, 128 tokens")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = launcher.main(argv)
        print(buf.getvalue(), end="")
        text = buf.getvalue()
        check(rc == 0 and want in text and arch_id in text and "cuda" in text
              and (launcher is serve_launcher or not opt or f"optimizer={optimizer}" in text),
              f"{launcher.__name__} --arch {arch_id}")


def dense_phase(dev, smi: str) -> dict:
    """Phase 20: StableLM-2-1.6B, CodeQwen1.5-7B and Command-R 35B on the
    card (see DENSE_ARCHS).  (a) At full width, 2 layers, fp32, seed-0
    params with DENSE_NOISE on every bias and norm leaf: LM_SERVE_FORCED
    tokens teacher-forced through ``decode_step`` against ``apply_lm`` (B4
    ``simt_fp32_dh64`` or ``_dh128``; B6 for CodeQwen alone) within
    DECODE_BAR, and each config's planted fault (DENSE_FAULTS) over it.
    (b) Each trained as phase 7 at DENSE_TRAIN_DEPTH (``lm_train_phase``:
    B4 twice per attention layer per microbatch, B6 only for the RMSNorm
    config) with the modeled state of one more layer printed beside the
    card.  (c) Each served at full width and depth (``lm_serve_drive``),
    Command-R last, after everything earlier phases hold is released.  (d)
    Both launchers with their default ``--arch`` on the card.  Returns the
    launches of (b) and (c) by kernel."""
    import gc

    import numpy as np
    import torch

    import repro_torch.models.attention as attn_mod
    import repro_torch.models.lm as lm_mod
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.kernel import reset_launches as reset_b4_launches
    from repro_torch.kernels.rmsnorm.kernel import reset_launches as reset_b6_launches
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    from repro_torch.models.registry import bundle_from_cfg, load_config, with_depth

    t_phase = time.perf_counter()
    real_rope, real_qkv, real_layer = attn_mod._rope_qk, attn_mod._qkv, lm_mod._decode_layer

    def whole_head_rotary(q, k, positions, cfg):
        return real_rope(q, k, positions, dataclasses.replace(cfg, rope_pct=1.0))

    def no_b_v(params, x, cfg):
        return real_qkv(dict(params, b_v=torch.zeros_like(params["b_v"])), x, cfg)

    def sequential_block(p, kind, x, cache, cfg, seq_sharded):
        return real_layer(dict(p, norm2=p["norm1"]), kind, x, cache,
                          dataclasses.replace(cfg, parallel_block=False), seq_sharded)

    faults = {"whole_head_rotary": (attn_mod, "_rope_qk", whole_head_rotary),
              "no_b_v": (attn_mod, "_qkv", no_b_v),
              "sequential_block": (lm_mod, "_decode_layer", sequential_block)}

    # -- (a) decode against the full forward, full width, 2 layers, fp32 -------------
    checks = {}
    rng = np.random.default_rng(SEED + 20)
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    t0 = time.perf_counter()
    for name in DENSE_ARCHS:
        cfg = dataclasses.replace(with_depth(load_config(name), LM_GRAD_DEPTH), dtype="float32",
                                  param_dtype="float32")
        arch = bundle_from_cfg(cfg, dev)
        params = arch.init(SEED)
        noisy = add_noise(params, gen, dev)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, LM_SERVE_FORCED))).to(dev)
        with torch.no_grad():
            reset_b4_launches()
            reset_b6_launches()
            err, ratio = decode_vs_forward(cfg, arch, params, tokens)
            b4 = {k: v for k, v in flash_attention_fwd.launches_by_instance.items() if v}
            b6 = rmsnorm.launches
            fault = DENSE_FAULTS[name]
            f_err, f_ratio = decode_vs_forward(cfg, arch, params, tokens,
                                               swapped(faults[fault]))
        want_b4 = "simt_fp32_dh64" if cfg.resolved_head_dim <= 64 else "simt_fp32_dh128"
        checks[name] = dict(noisy_leaves=noisy, decode_vs_forward_err=err,
                            decode_vs_forward_ratio=ratio, forward_b4=b4, b6_launches=b6,
                            planted=fault, planted_err=f_err, planted_ratio=f_ratio)
        print(f"{name} (full width, {LM_GRAD_DEPTH} layers, fp32, noise on {len(noisy)} bias and "
              f"norm leaves): {LM_SERVE_FORCED} tokens teacher-forced through decode_step vs "
              f"apply_lm (B4 {b4}, B6 {b6}): max err {err:.3e}, {ratio:.4f} of the bar "
              f"{DECODE_BAR}; planted fault ({fault}): max err {f_err:.3e}, {f_ratio:.1f}x the bar")
        check(ratio <= 1.0, f"{name} decode vs the full forward: {err} over {DECODE_BAR}")
        check(set(b4) == {want_b4}, f"{name} fp32 forward: B4 instances {b4}, not {want_b4}")
        check((b6 > 0) == (cfg.norm == "rmsnorm"), f"{name}: B6 launches {b6} ({cfg.norm})")
        check(f_ratio > 1.0, f"{name}: the decode check passed the planted fault {fault} ({f_err})")
        del arch, params, tokens
        torch.cuda.empty_cache()
    print(json.dumps({"dense_decode_checks": checks}))
    times = {"a": time.perf_counter() - t0}
    print(f"phase 20 (a): {times['a']:.1f} s, {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB "
          f"allocated after it")

    # -- (b) training at full width, as phase 7 ----------------------------------------
    t0 = time.perf_counter()
    launches = {"flash_attention_fwd": 0, "rmsnorm": 0}
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    for name in DENSE_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        run = train_run(f"dense_train_{name}")
        got = lm_train_phase(dev, smi, run)
        peak = torch.cuda.max_memory_allocated(dev)
        for k in launches:
            launches[k] += got["launches"].get(k, 0)
        full = load_config(name)
        # a layer's params: the run's, less the embedding, the head and the final norm
        outside = full.vocab * full.d_model * (1 + (not full.tie_embeddings)) \
            + full.d_model * (1 + (full.norm == "layernorm"))
        layer_params = (got["params"] - outside) // run.depth
        print(json.dumps({"dense_train_depth": {name: {
            "depth": run.depth, "of": full.n_layers, "peak_mem_bytes": peak,
            "layer_params": layer_params, "state_bytes_per_layer": 16 * layer_params,
            "modeled_peak_one_layer_deeper": peak + 16 * layer_params,
            "card_bytes": card_bytes}}}))
        if run.depth < full.n_layers:
            print(f"{name}: trained {run.depth} of {full.n_layers} layers, peak "
                  f"{peak / 1e9:.3f} GB; one layer more adds ~{16 * layer_params / 1e9:.2f} GB of "
                  f"state ({(peak + 16 * layer_params) / 1e9:.2f} of {card_bytes / 1e9:.2f} GB)")

    times["b"] = time.perf_counter() - t0
    print(f"phase 20 (b): {times['b']:.1f} s, {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB "
          f"allocated after it")

    # -- (c) serving at full width and depth ---------------------------------------------
    t0 = time.perf_counter()
    for name in DENSE_ARCHS:
        launches["rmsnorm"] += lm_serve_drive(dev, smi, name, None, *CONFIG_SERVE_TRAFFIC)
    times["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # -- (d) both launchers with their default --arch (stablelm-1.6b, reduced) --------
    for launcher, argv, want in (
            (serve_launcher, ["--requests", "8"], "served 8 requests, 128 tokens"),
            (train_launcher, ["--steps", "2", "--batch", "2", "--seq", "32"],
             "done: steps=2 restarts=0")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = launcher.main(argv)
        print(buf.getvalue(), end="")
        check(rc == 0 and want in buf.getvalue() and "stablelm-1.6b" in buf.getvalue()
              and "cuda" in buf.getvalue(), f"{launcher.__name__} with its default --arch")
    times["d"] = time.perf_counter() - t0
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s ((a)-(d): "
          f"{', '.join(f'{k} {v:.1f}' for k, v in times.items())})")
    print(json.dumps({"phase20_launches": launches}))
    return launches


def decode_vs_forward_mixes(cfg, arch, params, tokens, decode_fault=None,
                            forward_kw=None) -> dict:
    """Phase 21(a)'s decode check: ``decode_vs_forward``'s logits, and each
    attention layer's output (the mixer's, before the residual add), token
    by token, against the forward's, both at DECODE_BAR.  ``ratio`` is the
    larger of the two; ``decode_fault`` is applied around the decode alone."""
    import torch

    import repro_torch.models.attention as attn_mod

    fwd, dec = [], []
    real_attn, real_dec = attn_mod.attention, attn_mod.decode_attention

    def attention(*a, **k):
        fwd.append(real_attn(*a, **k))
        return fwd[-1]

    def decode_attention(*a, **k):
        out, cache = real_dec(*a, **k)
        dec.append(out)
        return out, cache

    with swapped((attn_mod, "attention", attention),
                 (attn_mod, "decode_attention", decode_attention)):
        err, ratio = decode_vs_forward(cfg, arch, params, tokens, decode_fault, forward_kw)
    n = len(fwd)
    check(n > 0 and len(dec) == n * tokens.shape[1], f"attention calls {n}, {len(dec)}")
    # decode's calls run token-major: layer j's outputs are every n-th
    mixes = [err_stats(torch.cat(dec[j::n], dim=1), fwd[j], **DECODE_BAR) for j in range(n)]
    mix_err, mix_ratio = max(e for e, _ in mixes), max(r for _, r in mixes)
    return dict(logits_err=err, logits_ratio=ratio, attention_err=mix_err,
                attention_ratio=mix_ratio, ratio=max(ratio, mix_ratio))


def moe_phase(dev, smi: str) -> dict:
    """Phase 21: Mixtral-8x22B and Jamba-v0.1-52B on the card (see
    MOE_ARCHS).  (a) At full width, MOE_CHECK_DEPTH layers, fp32, seed-0
    params: LM_SERVE_FORCED tokens of one sequence teacher-forced through
    ``decode_step`` against ``apply_lm`` (B4 ``simt_fp32_dh128``, B5
    ``simt_fp32`` for Jamba, B6), logits and attention outputs within
    DECODE_BAR (``decode_vs_forward_mixes``), each planted fault of
    MOE_FAULTS over it, and a request beside two others giving its bits
    alone.  (b) Each trained as phase 7 with adafactor at MOE_TRAIN_DEPTH
    (B4 twice per attention layer per microbatch on ``wgmma_bf16_dh128``,
    B5 likewise per Mamba layer on ``wgmma_bf16``), the share of
    assignments dropped by capacity, and the modeled state of one layer
    more beside the card.  (c) Each served at MOE_SERVE_DEPTH
    (``lm_serve_drive``).  (d) Both launchers with each id (reduced) and
    ``--optimizer adafactor`` on the card.  Returns the launches of (b) and
    (c) by kernel."""
    import gc

    import numpy as np
    import torch

    import repro_torch.models.attention as attn_mod
    import repro_torch.models.mlp as mlp_mod
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.kernel import reset_launches as reset_b4_launches
    from repro_torch.kernels.rmsnorm.kernel import reset_launches as reset_b6_launches
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    from repro_torch.kernels.ssd_chunk.kernel import reset_launches as reset_b5_launches
    from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk_fwd
    from repro_torch.models.lm import layer_kind
    from repro_torch.models.registry import bundle_from_cfg, load_config

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    real_route, real_rope = mlp_mod._route, attn_mod._rope_qk

    def unnormalised_topk(router_w, x_flat, m):
        _, topi, gates = real_route(router_w, x_flat, m)
        return torch.gather(gates, -1, topi), topi, gates

    def next_expert(router_w, x_flat, m):
        topw, topi, gates = real_route(router_w, x_flat, m)
        return topw, (topi + 1) % m.n_experts, gates

    def rope_on_attention(q, k, positions, cfg):
        return real_rope(q, k, positions, dataclasses.replace(cfg, use_rope=True))

    faults = {"unnormalised_topk": (mlp_mod, "_route", unnormalised_topk),
              "next_expert": (mlp_mod, "_route", next_expert),
              "rope_on_attention": (attn_mod, "_rope_qk", rope_on_attention)}

    # -- (a) decode against the full forward, full width, fp32 ---------------------
    checks = {}
    rng = np.random.default_rng(SEED + 21)
    t0 = time.perf_counter()
    for name in MOE_ARCHS:
        cfg = dataclasses.replace(load_config(name), n_layers=MOE_CHECK_DEPTH[name],
                                  dtype="float32", param_dtype="float32")
        arch = bundle_from_cfg(cfg, dev)
        params = arch.init(SEED)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, LM_SERVE_FORCED))).to(dev)
        with torch.no_grad():
            reset_b4_launches()
            reset_b5_launches()
            reset_b6_launches()
            out = decode_vs_forward_mixes(cfg, arch, params, tokens)
            kernels = {k: v for f in (flash_attention_fwd, ssd_chunk_fwd)
                       for k, v in f.launches_by_instance.items() if v}
            b6 = rmsnorm.launches
            print(f"{name} (full width, {cfg.n_layers} layers, fp32): {LM_SERVE_FORCED} tokens "
                  f"teacher-forced through decode_step vs apply_lm ({kernels}, B6 {b6}): logits "
                  f"max err {out['logits_err']:.3e} ({out['logits_ratio']:.4f} of the bar "
                  f"{DECODE_BAR}), attention outputs {out['attention_err']:.3e} "
                  f"({out['attention_ratio']:.4f})")
            check(out["ratio"] <= 1.0, f"{name} decode vs the full forward: {out}")
            want = {"simt_fp32_dh128"} | ({"simt_fp32"} if cfg.ssm is not None else set())
            check(set(kernels) == want and b6 > 0, f"{name} fp32 forward: kernels {kernels}, "
                                                   f"B6 {b6}")
            out.update(forward_kernels=kernels, b6_launches=b6)
            for fault in MOE_FAULTS[name]:
                f_out = decode_vs_forward_mixes(cfg, arch, params, tokens,
                                                swapped(faults[fault]))
                out[f"planted_{fault}"] = f_out
                print(f"planted fault ({fault}): logits {f_out['logits_ratio']:.1f}x the bar, "
                      f"attention outputs {f_out['attention_ratio']:.1f}x")
                check(f_out["ratio"] > 1.0, f"{name}: the decode check passed the planted "
                                            f"fault {fault} ({f_out})")
            out.update(beside_vs_alone(name, cfg, arch, params, rng))
        checks[name] = out
        del arch, params, tokens
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"moe_decode_checks": checks}))
    times = {"a": time.perf_counter() - t0}
    print(f"phase 21 (a): {times['a']:.1f} s, {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB "
          f"allocated after it")

    # -- (b) training at full width, as phase 7, with adafactor ----------------------
    t0 = time.perf_counter()
    launches = {"flash_attention_fwd": 0, "ssd_chunk_fwd": 0, "rmsnorm": 0}
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    trained = {}
    for name in MOE_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        run = train_run(f"moe_train_{name}")
        got = lm_train_phase(dev, smi, run)
        for k in launches:
            launches[k] += got["launches"].get(k, 0)
        full = load_config(name)
        nxt = got["kind_params"][dataclasses.astuple(layer_kind(full, run.depth))]
        peak = got["peak_mem_bytes"]
        trained[name] = {
            "depth": run.depth, "of": full.n_layers, "params": got["params"],
            "peak_mem_bytes": peak, "step_ms_cuda_events_median": got["step_ms_median"],
            "tokens_per_s_cuda_events": got["tokens_per_s"],
            "moe_dropped_share": got["moe_dropped_share"],
            "next_layer_params": nxt, "state_bytes_next_layer": MOE_STATE_BYTES * nxt,
            "modeled_peak_one_layer_deeper": peak + MOE_STATE_BYTES * nxt,
            "card_bytes": card_bytes}
        print(f"{name}: trained {run.depth} of {full.n_layers} layers with {MOE_OPTIMIZER}, peak "
              f"{peak / 1e9:.3f} GB; layer {run.depth} adds ~{MOE_STATE_BYTES * nxt / 1e9:.2f} GB "
              f"of state ({(peak + MOE_STATE_BYTES * nxt) / 1e9:.2f} of {card_bytes / 1e9:.2f} "
              f"GB); {got['moe_dropped_share']:.4%} of the assignments dropped by capacity")
    print(json.dumps({"moe_train": trained}))
    times["b"] = time.perf_counter() - t0
    print(f"phase 21 (b): {times['b']:.1f} s, {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB "
          f"allocated after it")

    # -- (c) serving at full width --------------------------------------------------------
    t0 = time.perf_counter()
    for name in MOE_ARCHS:
        launches["rmsnorm"] += lm_serve_drive(dev, smi, name, MOE_SERVE_DEPTH[name],
                                              *CONFIG_SERVE_TRAFFIC)
    times["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # -- (d) both launchers with each id (reduced) and adafactor ---------------------
    for name in MOE_ARCHS:
        run_launchers(name, MOE_OPTIMIZER)
    times["d"] = time.perf_counter() - t0
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s ((a)-(d): "
          f"{', '.join(f'{k} {v:.1f}' for k, v in times.items())})")
    print(json.dumps({"phase21_launches": launches}))
    return launches


def moe_layer_params(cfg) -> int:
    """Params of one MoE layer of ``cfg`` with MLA, from the shapes
    ``models/attention.py:init_attention``, ``models/mlp.py:init_moe`` and
    the two norms give it."""
    m, e, d, h = cfg.mla, cfg.moe, cfg.d_model, cfg.n_heads
    mla = (d * m.q_lora_rank + m.q_lora_rank
           + m.q_lora_rank * h * (m.qk_nope_head_dim + m.qk_rope_head_dim)
           + d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank
           + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim) + h * m.v_head_dim * d)
    experts = d * e.n_experts + 3 * e.n_experts * d * e.d_ff_expert
    shared = 3 * d * e.d_ff_shared * e.n_shared_experts
    return 2 * d + mla + experts + shared


def mla_grad_check(dev) -> dict:
    """Phase 22(b): ``mla_attention`` alone at DeepSeek-V3's full width, one
    sequence of DS_GRAD_SEQ tokens, fp32 through B6 (``q_norm`` at 1536,
    ``kv_norm`` at 512), against the plain path in fp64: the gradients of x
    and of each leaf (the norm scales given DENSE_NOISE of seeded noise),
    normwise, with phase 8's bar rule; and a planted fault that the same
    check must reject (``kv_norm``'s scale left out of the compressed
    rows)."""
    import torch

    import repro_torch.models.attention as attn_mod
    from repro_torch.kernels.rmsnorm.kernel import reset_launches as reset_b6_launches
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    from repro_torch.models.registry import load_config

    base = load_config(DS_ARCH)
    cfg32 = dataclasses.replace(base, dtype="float32", param_dtype="float32")
    cfg64 = dataclasses.replace(base, dtype="float64", param_dtype="float64")
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    params = attn_mod.init_attention(gen, cfg32, torch.float32)
    for k in ("q_norm", "kv_norm"):
        params[k] += DENSE_NOISE * torch.randn(params[k].shape, generator=gen, device=dev)
    t = DS_GRAD_SEQ
    x = torch.randn((1, t, base.d_model), generator=gen, device=dev)
    w = torch.randn((1, t, base.d_model), generator=gen, device=dev)
    pos = torch.arange(t, device=dev)[None]
    names = ["x"] + list(params)

    def grads(cfg, p, x_):
        live = [x_.detach().requires_grad_()] + [v.detach().requires_grad_() for v in p.values()]
        out = attn_mod.mla_attention(dict(zip(params, live[1:])), live[0], pos, cfg)
        loss = (out * w.to(out.dtype)).sum()
        g = torch.autograd.grad(loss, live, allow_unused=True)
        return [torch.zeros_like(v) if gi is None else gi for gi, v in zip(g, live)]

    reset_b6_launches()
    g_k = grads(cfg32, params, x)
    b6 = {k: v for k, v in rmsnorm.launches_by_instance.items() if v}
    check(rmsnorm.launches == 2 and b6 == {"warp_regs16": 1, "warp_regs4": 1},
          f"mla_attention fp32 at full width: B6 launches {b6} (q_norm at 1536, kv_norm at 512)")
    with plain_lm_kernels():
        g64 = grads(cfg64, {k: v.double() for k, v in params.items()}, x.double())
        g32 = grads(cfg32, params, x)
    scale = [float(g.abs().max()) for g in g64]

    def errs(g):
        return [float((a.double() - b).abs().max()) / s for a, b, s in zip(g, g64, scale)]

    plain64, kern64 = errs(g32), errs(g_k)
    del g32, g_k
    bars = [max(WGRAD_NORM_TOL, GRAD_FLOOR_FACTOR * e) for e in plain64]
    worst = max(range(len(names)), key=lambda i: kern64[i] / bars[i])
    print(f"mla_attention grads (full width, {t} tokens, fp32 through B6 {b6}) vs the plain path "
          f"in fp64: normwise max {max(kern64):.2e} (plain fp32 {max(plain64):.2e}); nearest its "
          f"bar: {names[worst]} {kern64[worst]:.2e}, {kern64[worst] / bars[worst]:.2f} of its bar")
    for n, e, p, bar in zip(names, kern64, plain64, bars):
        check(e <= bar, f"mla_attention grad {n}: normwise err {e} vs fp64 over its bar {bar} "
                        f"(plain fp32 {p})")
    real_kv = attn_mod._mla_kv

    def kv_norm_unscaled(p, x_, positions, cfg):
        return real_kv(dict(p, kv_norm=torch.ones_like(p["kv_norm"])), x_, positions, cfg)

    must_fail = ["kv_norm", "w_uk", "w_uv", "w_dkv"]
    with swapped((attn_mod, "_mla_kv", kv_norm_unscaled)):
        fault_ratio = {n: e / bar for n, e, bar in zip(names, errs(grads(cfg32, params, x)), bars)}
    print("planted fault (kv_norm's scale left out): "
          + ", ".join(f"{n} {fault_ratio[n]:.1f}x" for n in must_fail))
    check(all(fault_ratio[n] > 1.0 for n in must_fail),
          f"the mla_attention grad check passed a planted fault: {fault_ratio}")
    del g64, params, x, w
    torch.cuda.empty_cache()
    return {"tokens": t, "grad_err_vs_fp64": max(kern64), "plain32_grad_err_vs_fp64": max(plain64),
            "per_leaf": {n: [a, b] for n, a, b in zip(names, kern64, plain64)},
            "planted_fault_err_over_bar": fault_ratio, "b6_launches_by_instance": b6}


def deepseek_phase(dev, smi: str) -> dict:
    """Phase 22: DeepSeek-V3-671B on the card (see DS_ARCH).  (a) At full
    width, DS_CHECK_DEPTH layers, no MTP head, fp32, seed-0 params:
    LM_SERVE_FORCED tokens of one sequence teacher-forced through
    ``decode_step`` (the absorbed MLA decode) against ``apply_lm`` (MLA
    through the plain ``_sdpa``, B6 for every norm), logits and MLA outputs
    within DECODE_BAR (``decode_vs_forward_mixes``), each planted fault of
    DS_FAULTS over it, and a request beside two others giving its bits
    alone.  (b) Trained as phase 21 with adafactor at DS_TRAIN_DEPTH, the
    step-1 loss's main CE and MTP term apart, a planted "MTP term dropped"
    rejected, the modeled state of the next (MoE) layer beside the card;
    ``mla_grad_check``.  (c) Served at DS_SERVE_DEPTH (``lm_serve_drive``).
    (d) Both launchers with the id (reduced) on the card.  Returns the
    launches of (b) and (c) by kernel."""
    import gc

    import numpy as np
    import torch

    import repro_torch.models.attention as attn_mod
    import repro_torch.models.mlp as mlp_mod
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import place, synth_batch
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.kernel import reset_launches as reset_b4_launches
    from repro_torch.kernels.rmsnorm.kernel import reset_launches as reset_b6_launches
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    from repro_torch.models.lm import MTP_WEIGHT, apply_lm, lm_head_weight, lm_loss, mtp_loss
    from repro_torch.models.registry import bundle_from_cfg, load_config, with_depth

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    full = load_config(DS_ARCH)
    real_decode, real_kv, real_moe = attn_mod._decode_mla, attn_mod._mla_kv, mlp_mod.moe

    def absorbed_through_w_uv(params, x, cache, cfg):
        # in decode, w_uk is read by the absorption alone
        return real_decode(dict(params, w_uk=params["w_uv"]), x, cache, cfg)

    def k_pe_unrotated(params, x, positions, cfg):
        c_kv, _ = real_kv(params, x, positions, cfg)
        m = cfg.mla
        return c_kv, (x @ params["w_dkv"])[..., m.kv_lora_rank:]

    def no_shared_expert(params, x, cfg, act="silu"):
        return real_moe({k: v for k, v in params.items() if k != "shared"}, x, cfg, act)

    faults = {"absorbed_through_w_uv": (attn_mod, "_decode_mla", absorbed_through_w_uv),
              "k_pe_unrotated": (attn_mod, "_mla_kv", k_pe_unrotated),
              "no_shared_expert": (mlp_mod, "moe", no_shared_expert)}

    # -- (a) decode against the full forward, full width, fp32 ---------------------
    rng = np.random.default_rng(SEED + 22)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(full, n_layers=DS_CHECK_DEPTH, mtp_depth=0, dtype="float32",
                              param_dtype="float32")
    arch = bundle_from_cfg(cfg, dev)
    params = arch.init(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, LM_SERVE_FORCED))).to(dev)
    with torch.no_grad():
        reset_b4_launches()
        reset_b6_launches()
        out = decode_vs_forward_mixes(cfg, arch, params, tokens)
        b6 = {k: v for k, v in rmsnorm.launches_by_instance.items() if v}
        want_b6 = b6_per_decode_call(cfg) * (1 + LM_SERVE_FORCED)
        print(f"{DS_ARCH} (full width, {cfg.n_layers} layers, fp32): {LM_SERVE_FORCED} tokens "
              f"teacher-forced through decode_step vs apply_lm (B6 {b6}, the code's count "
              f"{want_b6}; B4 {flash_attention_fwd.launches}): logits max err "
              f"{out['logits_err']:.3e} ({out['logits_ratio']:.4f} of the bar "
              f"{DECODE_BAR}), MLA outputs {out['attention_err']:.3e} "
              f"({out['attention_ratio']:.4f})")
        check(out["ratio"] <= 1.0, f"{DS_ARCH} decode vs the full forward: {out}")
        check(flash_attention_fwd.launches == 0 and rmsnorm.launches == want_b6,
              f"{DS_ARCH} fp32 decode check: B4 {flash_attention_fwd.launches}, B6 {b6} "
              f"(the code's {want_b6})")
        out.update(b6_launches_by_instance=b6)
        for fault in DS_FAULTS:
            f_out = decode_vs_forward_mixes(cfg, arch, params, tokens, swapped(faults[fault]))
            out[f"planted_{fault}"] = f_out
            print(f"planted fault ({fault}): logits {f_out['logits_ratio']:.1f}x the bar, "
                  f"MLA outputs {f_out['attention_ratio']:.1f}x")
            check(f_out["ratio"] > 1.0, f"{DS_ARCH}: the decode check passed the planted fault "
                                        f"{fault} ({f_out})")
        out.update(beside_vs_alone(DS_ARCH, cfg, arch, params, rng))
    del arch, params, tokens
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"deepseek_decode_check": out}))
    times = {"a": time.perf_counter() - t0}
    print(f"phase 22 (a): {times['a']:.1f} s, {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB "
          f"allocated after it")

    # -- (b) training at full width, as phase 21 ------------------------------------
    t0 = time.perf_counter()
    check(with_depth(full, 0).n_layers == DS_TRAIN_DEPTH, "DeepSeek's dense prefix")
    run = train_run("deepseek_train")
    got = lm_train_phase(dev, smi, run)
    launches = {"rmsnorm": got["launches"]["rmsnorm"]}
    check(set(got["launches"]) == {"rmsnorm"}, f"{DS_ARCH} training launches {got['launches']}")
    # the step-1 loss's parts (the plain forward of lm_train_phase, split):
    # the main CE and 0.3 x the MTP CE; and the same check without the MTP term
    cfg = dataclasses.replace(full, n_layers=run.depth)
    arch = bundle_from_cfg(cfg, dev)
    params0 = arch.init(SEED)
    specs = arch.input_specs(ShapeConfig("smoke", run.seq, run.batch, "train"))
    b0 = place(synth_batch(specs, cfg, SEED, 0), dev)
    no_mtp = {k: v for k, v in params0.items() if k != "mtp"}
    main_ce, mtp_ce = [], []
    with torch.no_grad(), plain_lm_kernels():
        for i in range(run.accum):
            mb = {k: v.chunk(run.accum)[i] for k, v in b0.items()}
            hidden = apply_lm(params0, mb["tokens"], cfg)
            head = lm_head_weight(params0, cfg).to(cfg.act_dtype)
            main_ce.append(float(lm_loss(no_mtp, mb, cfg, remat="none")))
            mtp_ce.append(float(mtp_loss(params0, mb, hidden, head, cfg)))
    main, mtp = sum(main_ce) / run.accum, MTP_WEIGHT * sum(mtp_ce) / run.accum
    step1 = got["losses"][0]
    dropped_rel = abs(step1 - main) / abs(main)
    print(f"{DS_ARCH} step-1 loss {step1:.6f} = main CE {main:.6f} + {MTP_WEIGHT} x MTP CE "
          f"{mtp / MTP_WEIGHT:.6f} ({mtp:.6f}; the plain forward's sum "
          f"{got['step1_loss_plain_kernels']:.6f}); planted 'MTP term dropped': rel err "
          f"{dropped_rel:.3e} against the bar {LM_LOSS_RTOL}")
    check(abs(main + mtp - got["step1_loss_plain_kernels"]) <= 1e-3 * abs(main + mtp),
          f"{DS_ARCH}: the main CE and the MTP term do not sum to the plain forward's loss")
    check(dropped_rel > LM_LOSS_RTOL, f"{DS_ARCH}: the loss check passed the MTP term dropped "
                                      f"({dropped_rel})")
    del params0, no_mtp, b0, arch, hidden, head
    gc.collect()
    torch.cuda.empty_cache()
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    nxt = moe_layer_params(full)
    peak = got["peak_mem_bytes"]
    trained = {"depth": run.depth, "of": full.n_layers, "params": got["params"],
               "peak_mem_bytes": peak, "step_ms_cuda_events_median": got["step_ms_median"],
               "tokens_per_s_cuda_events": got["tokens_per_s"], "step1_loss": step1,
               "step1_main_ce": main, "step1_mtp_term": mtp, "step1_mtp_ce": mtp / MTP_WEIGHT,
               "planted_mtp_dropped_rel_err": dropped_rel,
               "next_layer_params": nxt, "state_bytes_next_layer": MOE_STATE_BYTES * nxt,
               "modeled_peak_one_layer_deeper": peak + MOE_STATE_BYTES * nxt,
               "card_bytes": card_bytes}
    deeper = peak + MOE_STATE_BYTES * nxt
    print(f"{DS_ARCH}: trained {run.depth} of {full.n_layers} layers with {MOE_OPTIMIZER}, peak "
          f"{peak / 1e9:.3f} GB; layer {run.depth + 1} (MoE, {nxt / 1e9:.3f} B params) adds "
          f"~{MOE_STATE_BYTES * nxt / 1e9:.2f} GB of state ({deeper / 1e9:.2f} of "
          f"{card_bytes / 1e9:.2f} GB)")
    trained["mla_grads"] = mla_grad_check(dev)
    print(json.dumps({"deepseek_train": trained}))
    times["b"] = time.perf_counter() - t0
    print(f"phase 22 (b): {times['b']:.1f} s, {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB "
          f"allocated after it")

    # -- (c) serving at full width --------------------------------------------------------
    t0 = time.perf_counter()
    launches["rmsnorm"] += lm_serve_drive(dev, smi, DS_ARCH, DS_SERVE_DEPTH,
                                          *CONFIG_SERVE_TRAFFIC)
    times["c"] = time.perf_counter() - t0

    # -- (d) both launchers with the id (reduced) --------------------------------------
    t0 = time.perf_counter()
    run_launchers(DS_ARCH, MOE_OPTIMIZER)
    times["d"] = time.perf_counter() - t0
    print(f"phase 22: {time.perf_counter() - t_phase:.1f} s ((a)-(d): "
          f"{', '.join(f'{k} {v:.1f}' for k, v in times.items())})")
    print(json.dumps({"phase22_launches": launches}))
    return launches


def vl_streams(t: int, grid: int):
    """(3, T) M-RoPE streams (temporal, height, width) of a prompt that opens
    with one image of grid x grid patches, as Qwen2-VL numbers them: every
    patch at temporal position 0, its row on the height stream and its
    column on the width stream; the text after it at grid, grid + 1, ... on
    all three."""
    import numpy as np

    n = grid * grid
    text = list(range(grid, grid + t - n))
    return np.array([[0] * n + text,
                     [r for r in range(grid) for _ in range(grid)] + text,
                     [c for _ in range(grid) for c in range(grid)] + text], np.int64)


def vl_decode_side(streams, patches, fault=None) -> swapped:
    """Phase 23(a)'s decode side: ``decode_step`` call t (from 0) embeds
    ``patches[:, t]`` in place of its token while t < Tv, and rotates q and
    k by ``streams[:, :, t]`` in place of its length broadcast to the three
    streams, so that teacher-forcing a multimodal prompt through the decode
    computes the forward's function.  ``fault`` plants one of VL_FAULTS:
    the M-RoPE sections permuted to VL_FAULT_SECTIONS, the height and width
    streams swapped, the patch embeddings not substituted."""
    import torch.nn.functional as F

    import repro_torch.models.attention as attn_mod
    import repro_torch.models.lm as lm_mod

    step = [-1]
    if fault == "h_w_swapped":
        streams = streams[[0, 2, 1]]
    real_rope, real_mrope = attn_mod._rope_qk, attn_mod.apply_mrope

    class Embedding:
        def __getattr__(self, name):
            return getattr(F, name)

        def embedding(self, ids, table):
            step[0] += 1
            out = F.embedding(ids, table)
            if fault != "patches_not_substituted" and step[0] < patches.shape[1]:
                out = patches[:, step[0]:step[0] + 1].to(out.dtype)
            return out

    def rope(q, k, positions, cfg):
        return real_rope(q, k, streams[:, :, step[0]:step[0] + 1], cfg)

    swaps = [(lm_mod, "F", Embedding()), (attn_mod, "_rope_qk", rope)]
    if fault == "sections_permuted":
        swaps.append((attn_mod, "apply_mrope",
                      lambda x, pos, theta, sections: real_mrope(x, pos, theta,
                                                                 VL_FAULT_SECTIONS)))
    return swapped(*swaps)


def vl_phase(dev, smi: str) -> dict:
    """Phase 23: Qwen2-VL-2B on the card (VL_ARCH), full width, all 28
    layers.  (a) fp32, seed-0 params with DENSE_NOISE on every bias and norm
    leaf: one prompt of LM_SERVE_FORCED tokens that opens with an image of
    VL_GRID x VL_GRID patch embeddings (``vl_streams``: three distinct
    streams) through ``apply_lm`` (M-RoPE, then B4 ``simt_fp32_dh128`` by the
    index mask) against the same prompt teacher-forced through
    ``decode_step`` (``vl_decode_side``), the logits and every attention
    output within DECODE_BAR, each planted fault of VL_FAULTS over it, B6
    the code's count, and a text request beside two others giving its bits
    alone.  (b) Trained as phase 7 at VL_TRAIN_DEPTH: LM_BATCH sequences of
    VL_SEQ tokens (a quarter of them patch embeddings, the registry's
    streams) in LM_ACCUM microbatches, bf16, remat full, AdamW, VL_STEPS
    steps; step 1's loss beside ln V.  (c) Served at full depth
    (``lm_serve_drive``: VL_SERVE_REQUESTS text prompts).  (d) Both
    launchers with the id.  Returns the launches of (b) and (c) by kernel."""
    import gc

    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.kernel import reset_launches as reset_b4_launches
    from repro_torch.kernels.rmsnorm.kernel import reset_launches as reset_b6_launches
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    from repro_torch.models.registry import bundle_from_cfg, load_config

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    full = load_config(VL_ARCH)

    # -- (a) decode against the full forward, full width and depth, fp32 -------------
    rng = np.random.default_rng(SEED + 23)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(full, dtype="float32", param_dtype="float32")
    arch = bundle_from_cfg(cfg, dev)
    params = arch.init(SEED)
    noisy = add_noise(params, gen, dev)
    t = LM_SERVE_FORCED
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, t))).to(dev)
    streams = torch.from_numpy(vl_streams(t, VL_GRID)[:, None, :]).to(dev)      # (3, 1, T)
    patches = torch.randn((1, VL_GRID * VL_GRID, cfg.d_model), generator=gen, device=dev)
    fwd_kw = dict(positions=streams, extra_embeds=patches)
    check(len({tuple(s) for s in streams[:, 0].tolist()}) == 3, "the three streams are distinct")
    with torch.no_grad():
        reset_b4_launches()
        reset_b6_launches()
        out = decode_vs_forward_mixes(cfg, arch, params, tokens, vl_decode_side(streams, patches),
                                      fwd_kw)
        b4 = {k: v for k, v in flash_attention_fwd.launches_by_instance.items() if v}
        want_b6 = b6_per_decode_call(cfg) * (1 + t)
        b6 = rmsnorm.launches
        print(f"{VL_ARCH} (full width, {cfg.n_layers} layers, fp32, noise on {len(noisy)} bias and "
              f"norm leaves): {t} tokens ({VL_GRID}x{VL_GRID} patches, then text; streams "
              f"{streams[:, 0, :VL_GRID * VL_GRID + 2].tolist()}...) teacher-forced through "
              f"decode_step vs apply_lm (B4 {b4}, B6 {b6}, the code's count {want_b6}): logits "
              f"max err {out['logits_err']:.3e} ({out['logits_ratio']:.4f} of the bar "
              f"{DECODE_BAR}), attention outputs {out['attention_err']:.3e} "
              f"({out['attention_ratio']:.4f})")
        check(out["ratio"] <= 1.0, f"{VL_ARCH} decode vs the full forward: {out}")
        check(b4 == {"simt_fp32_dh128": cfg.n_layers} and b6 == want_b6,
              f"{VL_ARCH} fp32 decode check: B4 {b4}, B6 {b6} (the code's {want_b6})")
        out.update(noisy_leaves=len(noisy), forward_b4=b4, b6_launches=b6)
        for fault in VL_FAULTS:
            f_out = decode_vs_forward_mixes(cfg, arch, params, tokens,
                                            vl_decode_side(streams, patches, fault), fwd_kw)
            out[f"planted_{fault}"] = f_out
            print(f"planted fault ({fault}): logits {f_out['logits_ratio']:.1f}x the bar, "
                  f"attention outputs {f_out['attention_ratio']:.1f}x")
            check(f_out["ratio"] > 1.0, f"{VL_ARCH}: the decode check passed the planted fault "
                                        f"{fault} ({f_out})")
        out.update(beside_vs_alone(VL_ARCH, cfg, arch, params, rng))
    del arch, params, tokens, patches
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"vl_decode_check": out}))
    times = {"a": time.perf_counter() - t0}
    print(f"phase 23 (a): {times['a']:.1f} s, {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB "
          f"allocated after it")

    # -- (b) training at full width, VL_TRAIN_DEPTH, as phase 7 ----------------------
    t0 = time.perf_counter()
    run = train_run("vl_train")
    got = lm_train_phase(dev, smi, run)
    launches = dict(got["launches"])
    check(set(launches) == {"flash_attention_fwd", "rmsnorm"}, f"{VL_ARCH} launches {launches}")
    step1, ln_v = got["losses"][0], math.log(full.vocab)
    print(json.dumps({"vl_train_summary": {
        "layers": run.depth, "of": full.n_layers, "params": got["params"],
        "patch_tokens_per_sequence": VL_SEQ // 4, "step1_loss": step1, "ln_vocab": ln_v,
        "step_ms_cuda_events_median": got["step_ms_median"],
        "tokens_per_s_cuda_events": got["tokens_per_s"], "peak_mem_bytes": got["peak_mem_bytes"],
        "launches": launches, "card": smi}}))
    times["b"] = time.perf_counter() - t0
    print(f"phase 23 (b): {times['b']:.1f} s; step-1 loss {step1:.4f} (ln V = {ln_v:.4f})")

    # -- (c) serving at full width and depth --------------------------------------------
    t0 = time.perf_counter()
    launches["rmsnorm"] += lm_serve_drive(dev, smi, VL_ARCH, None, VL_SERVE_REQUESTS,
                                          VL_SERVE_PROMPT, VL_SERVE_NEW)
    times["c"] = time.perf_counter() - t0

    # -- (d) both launchers with the id (reduced) --------------------------------------
    t0 = time.perf_counter()
    run_launchers(VL_ARCH)
    times["d"] = time.perf_counter() - t0
    print(f"phase 23: {time.perf_counter() - t_phase:.1f} s ((a)-(d): "
          f"{', '.join(f'{k} {v:.1f}' for k, v in times.items())})")
    print(json.dumps({"phase23_launches": launches}))
    return launches


def whisper_decoded(arch, params, frames, tokens, fault=None):
    """Phase 24(a)'s decode side: fp32 logits (B, T, V) of ``tokens``
    teacher-forced through ``whisper_decode_step`` against the cross K/V of
    ``cross_attention_kv(encode(frames))`` (``fill_cross_caches``: the
    reference's serving never fills them, ROADMAP C.15).  ``fault`` plants
    one of WHISPER_FAULTS: the cross K/V computed from the decoder's input
    states (token embeddings plus positions), an encoder whose
    self-attention is causal, the encoder's sinusoid dropped."""
    import torch

    import repro_torch.models.attention as attn_mod
    import repro_torch.models.whisper as whisper_mod

    cfg = arch.cfg
    real_attn = attn_mod.attention

    def causal_attention(*a, **k):
        return real_attn(*a, **dict(k, causal=True))

    encoder_swaps = {
        "encoder_causal": [(attn_mod, "attention", causal_attention)],
        "sinusoid_dropped": [(whisper_mod, "_sinusoid",
                              lambda t, d, dtype, device: torch.zeros((t, d), dtype=dtype,
                                                                      device=device))],
    }.get(fault, [])
    with swapped(*encoder_swaps):
        enc = whisper_mod.encode(params, frames, cfg)
    if fault == "cross_kv_from_decoder_state":
        t = tokens.shape[1]
        enc = (torch.nn.functional.embedding(tokens.long(), params["embed"])
               + params["dec_pos"][:t]).to(cfg.act_dtype)
    caches = whisper_mod.init_whisper_caches(cfg, tokens.shape[0], tokens.shape[1],
                                             enc.shape[1], cfg.act_dtype, frames.device)
    whisper_mod.fill_cross_caches(params, caches, enc, cfg)
    return torch.stack([arch.decode_fn(params, tokens[:, i:i + 1], caches)[0][:, 0]
                        for i in range(tokens.shape[1])], 1)


def whisper_phase(dev, smi: str) -> dict:
    """Phase 24: Whisper-medium on the card (WHISPER_ARCH), full width, 24 +
    24 layers.  (a) fp32, seed-0 params with DENSE_NOISE on every bias and
    norm leaf: one sequence of LM_SERVE_FORCED tokens against
    WHISPER_CHECK_FRAMES frames, ``decode_train(encode(frames))``'s logits
    (B4 ``simt_fp32_dh64``: the encoder's non-causal, the decoder's causal
    and the cross-attention) against the tokens teacher-forced through
    ``whisper_decode_step`` with the cross K/V filled from the encoding
    (``whisper_decoded``), within DECODE_BAR, and each planted fault of
    WHISPER_FAULTS over it.  (b) Trained as phase 7, the decoder at
    VL_TRAIN_DEPTH: LM_BATCH sequences of
    VL_SEQ frames and VL_SEQ / 4 tokens in LM_ACCUM microbatches, bf16, remat
    full, AdamW, VL_STEPS steps (B4 three times a decoder layer's and once an
    encoder layer's forward, twice with remat; no B6: LayerNorm); step 1's
    loss beside ln V.  (c) Served at full depth through ``ServeEngine`` as
    the reference's ``_lm_main`` serves it: token prompts alone against
    zeroed cross K/V (``lm_serve_drive``).  (d) Both launchers with the id.
    Returns the launches of (b) by kernel."""
    import gc

    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.kernel import reset_launches as reset_b4_launches
    from repro_torch.kernels.rmsnorm.kernel import reset_launches as reset_b6_launches
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    from repro_torch.models.registry import bundle_from_cfg, load_config
    from repro_torch.models.whisper import decode_train, encode

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    full = load_config(WHISPER_ARCH)

    # -- (a) decode against decode_train, full width and depth, fp32 --------------------
    rng = np.random.default_rng(SEED + 24)
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(full, dtype="float32", param_dtype="float32")
    arch = bundle_from_cfg(cfg, dev)
    params = arch.init(SEED)
    noisy = add_noise(params, gen, dev)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, LM_SERVE_FORCED))).to(dev)
    frames = torch.randn((1, WHISPER_CHECK_FRAMES, cfg.d_model), generator=gen, device=dev)
    out = {}
    with torch.no_grad():
        reset_b4_launches()
        reset_b6_launches()
        want = (decode_train(params, tokens, encode(params, frames, cfg), cfg)
                @ params["embed"].T).float()
        b4 = {k: v for k, v in flash_attention_fwd.launches_by_instance.items() if v}
        got = whisper_decoded(arch, params, frames, tokens)
        out["logits_err"], out["logits_ratio"] = err_stats(got, want, **DECODE_BAR)
        print(f"{WHISPER_ARCH} (full width, {cfg.n_encoder_layers} + {cfg.n_layers} layers, fp32, "
              f"noise on {len(noisy)} bias and norm leaves): {LM_SERVE_FORCED} tokens against "
              f"{WHISPER_CHECK_FRAMES} frames teacher-forced through whisper_decode_step (cross "
              f"K/V from the encoding) vs decode_train (B4 {b4}, B6 {rmsnorm.launches}): logits "
              f"max err {out['logits_err']:.3e} ({out['logits_ratio']:.4f} of the bar "
              f"{DECODE_BAR})")
        check(out["logits_ratio"] <= 1.0, f"{WHISPER_ARCH} decode vs decode_train: {out}")
        want_b4 = 2 * cfg.n_layers + cfg.n_encoder_layers      # the reference side's forward
        check(b4 == {"simt_fp32_dh64": want_b4} and rmsnorm.launches == 0,
              f"{WHISPER_ARCH} fp32 forward: B4 {b4} (the code's {want_b4}), B6 "
              f"{rmsnorm.launches}")
        out.update(noisy_leaves=len(noisy), forward_b4=b4)
        for fault in WHISPER_FAULTS:
            bad = whisper_decoded(arch, params, frames, tokens, fault)
            f_err, f_ratio = err_stats(bad, want, **DECODE_BAR)
            out[f"planted_{fault}"] = dict(logits_err=f_err, logits_ratio=f_ratio)
            print(f"planted fault ({fault}): logits {f_ratio:.1f}x the bar")
            check(f_ratio > 1.0, f"{WHISPER_ARCH}: the decode check passed the planted fault "
                                 f"{fault} ({f_err})")
    del arch, params, tokens, frames, want, got
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"whisper_decode_check": out}))
    times = {"a": time.perf_counter() - t0}
    print(f"phase 24 (a): {times['a']:.1f} s, {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB "
          f"allocated after it")

    # -- (b) training at full width, VL_TRAIN_DEPTH, as phase 7 ----------------------
    t0 = time.perf_counter()
    run = train_run("whisper_train")
    got = lm_train_phase(dev, smi, run)
    launches = dict(got["launches"])
    check(launches == {"flash_attention_fwd": launches.get("flash_attention_fwd", 0),
                       "rmsnorm": 0} and launches["flash_attention_fwd"] > 0,
          f"{WHISPER_ARCH} launches {launches}")
    step1, ln_v = got["losses"][0], math.log(full.vocab)
    med_s = got["step_ms_median"] / 1e3
    print(json.dumps({"whisper_train_summary": {
        "encoder_layers": full.n_encoder_layers, "decoder_layers": run.depth,
        "of_decoder_layers": full.n_layers,
        "params": got["params"], "frames_per_sequence": VL_SEQ,
        "tokens_per_sequence": VL_SEQ // 4, "step1_loss": step1, "ln_vocab": ln_v,
        "step_ms_cuda_events_median": got["step_ms_median"],
        "frames_per_s_cuda_events": LM_BATCH * VL_SEQ / med_s,
        "decoder_tokens_per_s_cuda_events": LM_BATCH * (VL_SEQ // 4) / med_s,
        "peak_mem_bytes": got["peak_mem_bytes"], "launches": launches, "card": smi}}))
    times["b"] = time.perf_counter() - t0
    print(f"phase 24 (b): {times['b']:.1f} s; step-1 loss {step1:.4f} (ln V = {ln_v:.4f})")

    # -- (c) serving at full width and depth: token prompts, zeroed cross K/V -----------
    t0 = time.perf_counter()
    launches["rmsnorm"] += lm_serve_drive(dev, smi, WHISPER_ARCH, None, VL_SERVE_REQUESTS,
                                          VL_SERVE_PROMPT, VL_SERVE_NEW)
    times["c"] = time.perf_counter() - t0

    # -- (d) both launchers with the id (reduced) --------------------------------------
    t0 = time.perf_counter()
    run_launchers(WHISPER_ARCH)
    times["d"] = time.perf_counter() - t0
    print(f"phase 24: {time.perf_counter() - t_phase:.1f} s ((a)-(d): "
          f"{', '.join(f'{k} {v:.1f}' for k, v in times.items())})")
    print(json.dumps({"phase24_launches": launches}))
    return launches


def _decay_like_mamba2(params, gen) -> None:
    """Mamba2's own init of each SSD head's decay, drawn into ``params`` in
    place: A ~ U[1, 16] (``A_log = log A``) and dt log-uniform in [1e-3,
    1e-1] (``dt_bias`` its inverse softplus).  The reference draws zeros
    (A = 1, dt = softplus(0) = 0.69), under which a shard of 1024 tokens
    decays by e^-709 and hands its successor nothing a check could see."""
    import torch

    for seg in params["segments"]:
        for layer in seg:
            if "mamba" not in layer:
                continue
            m = layer["mamba"]
            a = torch.rand(m["A_log"].shape, generator=gen, device=m["A_log"].device)
            m["A_log"].copy_(torch.log(1 + 15 * a))
            u = torch.rand(m["dt_bias"].shape, generator=gen, device=m["dt_bias"].device)
            dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
            m["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))


def seq_shard_phase(dev, smi: str) -> dict:
    """Phase 25: the sequence-sharded Mamba2 forward (``apply_lm(seq_axis=)``
    on a virtual mesh whose axis "sp" has ``SEQ_SHARDS`` shards) and the
    sequence-sharded decode.  (a) ``SEQ_CHECK_DEPTH`` layers of
    Mamba2-780m at full width, fp32, 2 x 4096 tokens, Mamba2's decay init:
    the sharded and unsharded hidden states, CE loss and every grad leaf
    against the plain path in fp64, each within max(1e-3, GRAD_FLOOR_FACTOR
    x the unsharded fp32 run's distance), normwise; each of ``SEQ_FAULTS``
    must land over a bar.  (b) All 48 layers, bf16, remat "full": one
    training step (AdamW) on the training cell's first microbatch, sharded
    and unsharded; the step-1 losses within ``LM_LOSS_RTOL``; B5 launches
    the same number of times both ways.  (c) Qwen2-7B at full depth,
    ``SEQ_DECODE_SLOTS`` slots of a ``SEQ_DECODE_MAX_SEQ``-row cache filled
    with random K/V rows up to per-slot lengths in ``SEQ_DECODE_LEN``:
    ``SEQ_DECODE_TICKS`` greedy ticks with ``seq_sharded_cache`` on 4
    shards of the ``seq_shard`` axis against the unsharded decode, in bf16
    (timed, the logits reported) and in fp32 (logits within
    ``DECODE_BAR``, the same tokens), and a planted fault in each: the
    masks of ``decode_attend_seq_sharded`` dropped.  Returns the kernels'
    launches in (b) and (c)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.core.sequence as seq_mod
    import repro_torch.models.attention as attn_mod
    import repro_torch.models.mamba2 as mamba_mod
    from repro_torch.configs.base import ParallelConfig, ShapeConfig, TrainConfig
    from repro_torch.data.synthetic import place, synth_batch
    from repro_torch.kernels.rmsnorm.kernel import reset_launches as reset_b6_launches
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    from repro_torch.kernels.ssd_chunk.kernel import reset_launches as reset_b5_launches
    from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk_fwd
    from repro_torch.launch.mesh import make_virtual_mesh
    from repro_torch.models.lm import (apply_lm, chunked_cross_entropy, decode_step,
                                       init_caches, lm_head_weight)
    from repro_torch.models.registry import bundle_from_cfg, load_config, with_depth
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    from repro_torch.parallel.api import sharding_ctx
    from repro_torch.train.trainer import make_train_step

    t_phase = time.monotonic()
    out = {"card": smi}
    mesh = make_virtual_mesh({"sp": SEQ_SHARDS}, dev)

    # -- (a) fp32 against fp64, and the planted faults ------------------------
    base = with_depth(load_config(MAMBA_ARCH), SEQ_CHECK_DEPTH)
    cfg32 = dataclasses.replace(base, dtype="float32", param_dtype="float32")
    cfg64 = dataclasses.replace(base, dtype="float64", param_dtype="float64")
    arch = bundle_from_cfg(cfg32, dev)
    params = arch.init(SEED)
    _decay_like_mamba2(params, torch.Generator(device=dev).manual_seed(SEED + 25))
    specs = arch.input_specs(ShapeConfig("smoke", MAMBA_SEQ, SEQ_CHECK_BATCH, "train"))
    batch = place(synth_batch(specs, cfg32, SEED, 0), dev)

    def run(cfg, p, axis):
        """(hidden, loss, grads) of the CE loss, remat "full"; the backward
        runs outside the mesh's context, as a trainer's would."""
        live = tree_map(lambda t: t.detach().requires_grad_(True), p)
        with sharding_ctx(mesh if axis else None):
            hidden = apply_lm(live, batch["tokens"], cfg, remat="full", seq_axis=axis)
            loss = chunked_cross_entropy(hidden, lm_head_weight(live, cfg).to(cfg.act_dtype),
                                         batch["labels"])
        grads = torch.autograd.grad(loss, tree_leaves(live))
        return [hidden.detach(), loss.detach()] + list(grads)

    names = ["hidden", "loss"] + [n for n, _ in named_leaves(params)]
    with plain_lm_kernels():
        exact = run(cfg64, tree_map(lambda t: t.double(), params), None)
    scale = [float(e.abs().max()) for e in exact]

    def errs(got):
        return [float((g.double() - e).abs().max()) / s for g, e, s in zip(got, exact, scale)]

    reset_b5_launches()
    unsharded = errs(run(cfg32, params, None))
    b5_un = dict(ssd_chunk_fwd.launches_by_instance)
    reset_b5_launches()
    sharded = errs(run(cfg32, params, "sp"))
    b5_sh = dict(ssd_chunk_fwd.launches_by_instance)
    bars = [max(WGRAD_NORM_TOL, GRAD_FLOOR_FACTOR * e) for e in unsharded]
    worst = max(range(len(names)), key=lambda i: sharded[i] / bars[i])
    print(f"25(a) {cfg32.name} {cfg32.n_layers} layers fp32, {SEQ_CHECK_BATCH} x {MAMBA_SEQ} "
          f"tokens on {SEQ_SHARDS} shards vs the plain fp64 path: sharded max "
          f"{max(sharded):.2e}, unsharded max {max(unsharded):.2e}; nearest its bar: "
          f"{names[worst]} {sharded[worst]:.2e} ({sharded[worst] / bars[worst]:.2f} of it); B5 "
          f"by instance sharded {b5_sh}, unsharded {b5_un}")
    check(b5_sh == b5_un and set(k for k, v in b5_sh.items() if v) == {"simt_fp32"},
          f"25(a) B5 launches sharded {b5_sh} vs unsharded {b5_un}")
    for n, e, bar in zip(names, sharded, bars):
        check(e <= bar, f"25(a) sharded {n}: normwise err {e} vs fp64 over its bar {bar}")
    real_hops = seq_mod.seq_scan_combine_hops

    def zero_halo(x, halo_lo, halo_hi, *, tile_dim, dim, wire=None):
        shape = list(x.shape)
        shape[dim] = halo_lo
        return torch.cat([x.new_zeros(shape), x], dim=dim)

    faults = {
        "incoming_state_dropped": swapped((mamba_mod, "_cross_shard", lambda axis, b, n: (
            lambda total, final: torch.zeros_like(final)))),
        "conv_halo_zeroed": swapped((seq_mod, "halo_exchange_1d", zero_halo)),
        "hop_decay_not_applied": swapped((mamba_mod, "seq_scan_combine_hops", (
            lambda decay, state, axis, shard_dim: real_hops(torch.ones_like(decay), state, axis,
                                                            shard_dim=shard_dim)))),
    }
    fault_over = {}
    for fname in SEQ_FAULTS:
        with faults[fname]:
            got = errs(run(cfg32, params, "sp"))
        ratio = {n: e / bar for n, e, bar in zip(names, got, bars)}
        top = max(ratio, key=ratio.get)
        fault_over[fname] = {"max_over_bar": ratio[top], "at": top,
                             "leaves_over": sum(r > 1 for r in ratio.values())}
        print(f"25(a) planted fault {fname}: {fault_over[fname]['leaves_over']} of {len(names)} "
              f"outputs over their bar, the most {top} at {ratio[top]:.1f}x")
        check(ratio[top] > 1.0, f"25(a) the check passed the planted fault {fname}: {ratio}")
    out["check"] = {"layers": cfg32.n_layers, "tokens": [SEQ_CHECK_BATCH, MAMBA_SEQ],
                    "shards": SEQ_SHARDS, "sharded_err_vs_fp64": dict(zip(names, sharded)),
                    "unsharded_err_vs_fp64": dict(zip(names, unsharded)),
                    "nearest_bar": [names[worst], sharded[worst] / bars[worst]],
                    "planted_faults": fault_over}
    del params, exact, batch
    torch.cuda.empty_cache()
    t_a = time.monotonic() - t_phase

    # -- (b) one training step at full depth, sharded and unsharded -----------
    cfg = load_config(MAMBA_ARCH)
    arch = bundle_from_cfg(cfg, dev)
    specs = arch.input_specs(ShapeConfig("smoke", MAMBA_SEQ, MAMBA_BATCH, "train"))
    batch = microbatch(place(synth_batch(specs, cfg, SEED, 0), dev), 0, MAMBA_ACCUM)

    def sharded_loss(params, b, remat="full", unroll=False, ce_chunk=512):
        with sharding_ctx(mesh):
            hidden = apply_lm(params, b["tokens"], cfg, remat=remat, seq_axis="sp")
        return chunked_cross_entropy(hidden, lm_head_weight(params, cfg).to(cfg.act_dtype),
                                     b["labels"], chunk=ce_chunk)

    per_mb = lm_launches_per_microbatch(cfg, "full")
    steps, launches = {}, {"ssd_chunk_fwd": 0, "rmsnorm": 0}
    for label, loss_fn in (("unsharded", arch.loss_fn), ("sharded", sharded_loss)):
        run_arch = dataclasses.replace(arch, loss_fn=loss_fn)
        init_state, train_step = make_train_step(
            run_arch, ParallelConfig(remat="full"), TrainConfig(warmup=0, steps=1, seed=SEED))
        state = init_state(SEED)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_b5_launches()
        reset_b6_launches()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = train_step(state, batch)
        b.record()
        torch.cuda.synchronize()
        got = {"ssd_chunk_fwd": ssd_chunk_fwd.launches, "rmsnorm": rmsnorm.launches}
        steps[label] = {
            "loss": float(m["loss"]), "step_ms_cuda_events": a.elapsed_time(b),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev), "launches": got,
            "b5_launches_by_instance": {k: v for k, v in
                                        ssd_chunk_fwd.launches_by_instance.items() if v},
            "b6_launches_by_instance": {k: v for k, v in rmsnorm.launches_by_instance.items() if v}}
        for k in launches:
            launches[k] += got[k]
        check(got == {k: per_mb[k] for k in got}, f"25(b) {label} launches {got} vs {per_mb}")
        check(set(steps[label]["b5_launches_by_instance"]) == {"wgmma_bf16"},
              f"25(b) {label} B5 instances {steps[label]['b5_launches_by_instance']}")
        del state, init_state, train_step
        torch.cuda.empty_cache()
    rel = abs(steps["sharded"]["loss"] - steps["unsharded"]["loss"]) / abs(steps["unsharded"]["loss"])
    print(f"25(b) {cfg.name} {cfg.n_layers} layers bf16, one step of 2 x {MAMBA_SEQ} tokens: "
          + "; ".join(f"{k} loss {v['loss']:.6f}, {v['step_ms_cuda_events']:.1f} ms, peak "
                      f"{v['peak_mem_bytes'] / 1e9:.2f} GB, launches {v['launches']}"
                      for k, v in steps.items()) + f"; loss rel diff {rel:.2e}")
    check(rel <= LM_LOSS_RTOL, f"25(b) sharded step-1 loss rel diff {rel}")
    check(steps["sharded"]["launches"] == steps["unsharded"]["launches"],
          f"25(b) launches differ: {steps}")
    out["train"] = {"layers": cfg.n_layers, "tokens": [2, MAMBA_SEQ], "loss_rel_diff": rel,
                    **steps}
    del batch
    torch.cuda.empty_cache()
    t_b = time.monotonic() - t_phase - t_a

    # -- (c) the sequence-sharded decode at 32768 rows ------------------------
    dmesh = make_virtual_mesh({"model": SEQ_SHARDS}, dev)
    real_attend = attn_mod.decode_attend_seq_sharded

    def masks_dropped(q, k, v, q_pos, k_pos, valid, window):
        return real_attend(q, k, v, torch.full_like(q_pos, 2**30), k_pos,
                           torch.ones_like(valid), window)

    def decode_pair(dtype):
        """Both decodes of Qwen2-7B in ``dtype`` from one set of caches of
        random K/V rows: ``SEQ_DECODE_TICKS`` greedy ticks unsharded, the
        same ticks sharded and fed the unsharded tokens, one tick of the
        planted fault, and a profiled tick each way."""
        cfg = dataclasses.replace(load_config(LM_ARCH), dtype=str(dtype).split(".")[1],
                                  param_dtype=str(dtype).split(".")[1])
        params = bundle_from_cfg(cfg, dev).init(SEED)
        caches = init_caches(cfg, SEQ_DECODE_SLOTS, SEQ_DECODE_MAX_SEQ, dtype, dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 26)
        lens = torch.randint(SEQ_DECODE_LEN[0], SEQ_DECODE_LEN[1] + 1, (SEQ_DECODE_SLOTS,),
                             generator=gen, device=dev, dtype=torch.int32)
        for c in caches:
            c.k.normal_(generator=gen)
            c.v.normal_(generator=gen)
        first = torch.randint(0, cfg.vocab, (SEQ_DECODE_SLOTS, 1), generator=gen, device=dev,
                              dtype=torch.int32)

        def drive(sharded, feed=None, ticks=SEQ_DECODE_TICKS):
            """``ticks`` greedy ticks from the filled caches (lengths reset: a
            tick writes row ``length`` before it reads it, so what the last
            drive left past the lengths is never read); each tick fed its own
            argmax, or ``feed``'s tokens.  -> (logits, tokens, event ms)."""
            for c in caches:
                c.lengths.copy_(lens)
            tok, logits, toks, ms = first, [], [], []
            with sharding_ctx(dmesh if sharded else None):
                for t in range(ticks):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    lg, _ = decode_step(params, tok, caches, cfg, seq_sharded_cache=sharded)
                    b.record()
                    logits.append(lg[:, 0])
                    toks.append(lg[:, 0].argmax(-1))
                    ms.append((a, b))
                    tok = (toks[-1] if feed is None else feed[t])[:, None].to(torch.int32)
            torch.cuda.synchronize()
            return logits, toks, [a.elapsed_time(b) for a, b in ms]

        def device_ms(sharded):
            for c in caches:
                c.lengths.copy_(lens)
            with sharding_ctx(dmesh if sharded else None), \
                    profile(activities=[ProfilerActivity.CUDA]) as prof:
                decode_step(params, first, caches, cfg, seq_sharded_cache=sharded)
                torch.cuda.synchronize()
            return sum(device_ms_by_name(prof, 1).values())

        reset_b6_launches()
        want, want_tok, ms_un = drive(False)
        got, got_tok, ms_sh = drive(True, feed=want_tok)
        b6 = rmsnorm.launches
        check(b6 == 2 * SEQ_DECODE_TICKS * b6_per_decode_call(cfg),
              f"25(c) {dtype} B6 launches {b6} vs {2 * SEQ_DECODE_TICKS * b6_per_decode_call(cfg)}")
        # layer 0's attention output at tick 0 (the same inputs both ways), the
        # plain attend's against the sharded one's and the planted fault's
        layer0 = {}

        def first_out(key, fn):
            def rec(*args, **kwargs):
                y = fn(*args, **kwargs)
                layer0.setdefault(key, y.float())
                return y
            return rec

        with swapped((attn_mod, "_sdpa", first_out("plain", attn_mod._sdpa))):
            drive(False, ticks=1)
        with swapped((attn_mod, "decode_attend_seq_sharded", first_out("sharded", real_attend))):
            drive(True, ticks=1)
        with swapped((attn_mod, "decode_attend_seq_sharded", first_out("fault", masks_dropped))):
            bad, _, _ = drive(True, feed=want_tok, ticks=1)
        top2 = [w.topk(2, dim=-1).values for w in want]
        row = {"dtype": str(dtype), "lengths": lens.tolist(),
               "logits_over_bar": max(err_stats(g, w, **DECODE_BAR)[1] for g, w in zip(got, want)),
               "tokens_equal": sum(bool(torch.equal(a, b)) for a, b in zip(got_tok, want_tok)),
               "min_top2_gap": min(float((t[:, 0] - t[:, 1]).min()) for t in top2),
               "planted_masks_dropped_over_bar": err_stats(bad[0], want[0], **DECODE_BAR)[1],
               "layer0_over_ulp_bar": ulp_ratio(layer0["sharded"], layer0["plain"], dtype,
                                                SEQ_LAYER0_ULPS),
               "layer0_planted_over_ulp_bar": ulp_ratio(layer0["fault"], layer0["plain"], dtype,
                                                        SEQ_LAYER0_ULPS),
               "tick_ms_unsharded": ms_un, "tick_ms_sharded": ms_sh,
               "device_ms": {"unsharded": device_ms(False), "sharded": device_ms(True)},
               "b6_launches": b6}
        print(f"25(c) {cfg.name} {cfg.n_layers} layers {dtype}, {SEQ_DECODE_SLOTS} slots at "
              f"lengths {row['lengths']} of {SEQ_DECODE_MAX_SEQ} rows, {SEQ_DECODE_TICKS} ticks: "
              f"sharded vs unsharded logits at {row['logits_over_bar']:.4f} of the decode bar, "
              f"{row['tokens_equal']} of {SEQ_DECODE_TICKS} ticks the same tokens (smallest "
              f"top-2 gap {row['min_top2_gap']:.4f}); tick ms (events, median) unsharded "
              f"{statistics.median(ms_un):.2f}, sharded {statistics.median(ms_sh):.2f}; device "
              f"ms a tick {row['device_ms']}; planted fault (masks dropped) "
              f"{row['planted_masks_dropped_over_bar']:.1f}x the bar; layer 0's attention "
              f"output at {row['layer0_over_ulp_bar']:.4f} of {SEQ_LAYER0_ULPS} ulps, the "
              f"planted fault at {row['layer0_planted_over_ulp_bar']:.1f}x")
        del params, caches, want, got, bad
        torch.cuda.empty_cache()
        return row

    # bf16, the serving type, is timed and held at one layer: at 28 layers a
    # 1-ulp change of layer 0's attention output alone moves the random-init
    # model's bf16 logits 9.7x the decode bar (0.23 on logits of magnitude
    # 6.6, NVIDIA H100 80GB HBM3, 700.00 W), so its logits are reported, and
    # its layer 0 attention output is held within SEQ_LAYER0_ULPS ulps of the
    # plain attend's.  fp32, where an ulp is 2^16 times smaller, is held to
    # the decode bar on the logits.
    bf16 = decode_pair(torch.bfloat16)
    fp32 = decode_pair(torch.float32)
    check(fp32["logits_over_bar"] <= 1.0,
          f"25(c) fp32 sharded decode at {fp32['logits_over_bar']} of the decode bar")
    check(fp32["tokens_equal"] == SEQ_DECODE_TICKS, f"25(c) fp32 sharded decode chose other tokens")
    check(bf16["layer0_over_ulp_bar"] <= 1.0,
          f"25(c) bf16 layer 0 attention at {bf16['layer0_over_ulp_bar']} of {SEQ_LAYER0_ULPS} ulps")
    check(fp32["planted_masks_dropped_over_bar"] > 1.0 and bf16["layer0_planted_over_ulp_bar"]
          > 1.0, f"25(c) the decode check passed the masks dropped: {fp32}, {bf16}")
    out["decode"] = {"layers": load_config(LM_ARCH).n_layers, "slots": SEQ_DECODE_SLOTS,
                     "max_seq": SEQ_DECODE_MAX_SEQ, "ticks": SEQ_DECODE_TICKS,
                     "bf16": bf16, "fp32": fp32}
    launches["rmsnorm"] += bf16["b6_launches"] + fp32["b6_launches"]
    out["seconds"] = {"a": t_a, "b": t_b, "c": time.monotonic() - t_phase - t_a - t_b}
    print(json.dumps({"seq_shard": out}))
    return launches


def remat_dots_phase(dev, smi: str) -> dict:
    """Phase 26: ``remat="dots"`` on Qwen2-7B at full width, ``DOTS_DEPTH``
    layers, bf16: one microbatch (``DOTS_BATCH`` x ``DOTS_SEQ``) of loss
    and grads from the same params and batch under "none", "dots" and
    "full".  The loss and every grad leaf under "dots" must equal "none"'s
    bit for bit; the peak above the step's start must order none > dots >
    full; B4 and B6 launch as ``lm_launches_per_microbatch`` counts (the
    recomputation of "dots" and "full" included).  The saved tensors: those
    the autograd graph holds outside the checkpoints (unique storages, the
    params' left out) plus the outputs ``save_dots`` keeps.  Returns the
    kernels' launches."""
    import torch

    import repro_torch.models.lm as lm_mod
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import place, synth_batch
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd, reset_launches
    from repro_torch.kernels.rmsnorm.kernel import reset_launches as reset_b6_launches
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    from repro_torch.models.registry import bundle_from_cfg, load_config
    from repro_torch.optim.optimizers import tree_leaves

    t0 = time.monotonic()
    cfg = dataclasses.replace(load_config(LM_ARCH), n_layers=DOTS_DEPTH)
    arch = bundle_from_cfg(cfg, dev)
    params = arch.init(SEED)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    param_storages = {p.untyped_storage().data_ptr() for p in leaves}
    specs = arch.input_specs(ShapeConfig("smoke", DOTS_SEQ, DOTS_BATCH * LM_ACCUM, "train"))
    batch = microbatch(place(synth_batch(specs, cfg, SEED, 0), dev), 0, LM_ACCUM)
    real_policy = lm_mod.save_dots
    aten = torch.ops.aten
    res, ref = {}, None
    launches = {"flash_attention_fwd": 0, "rmsnorm": 0}
    for remat in ("none", "dots", "full"):
        kept, storages = [], {}

        def policy(ctx, op, *args, **kwargs):
            got = real_policy(ctx, op, *args, **kwargs)
            if got == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                a = args[1] if op is aten.addmm.default else args[0]
                b = args[2] if op is aten.addmm.default else args[1]
                n = a.shape[0] * b.shape[-1] * (a.shape[1] if op is aten.bmm.default else 1)
                kept.append(n * a.element_size())
            return got

        def pack(t):
            ptr = t.untyped_storage().data_ptr()
            if ptr not in param_storages:
                storages[ptr] = t.untyped_storage().nbytes()
            return t

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        start = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        reset_b6_launches()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        with swapped((lm_mod, "save_dots", policy)), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = arch.loss_fn(params, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        b.record()
        torch.cuda.synchronize()
        got = {"flash_attention_fwd": flash_attention_fwd.launches, "rmsnorm": rmsnorm.launches}
        want = lm_launches_per_microbatch(cfg, remat)
        res[remat] = {"loss": float(loss), "ms_cuda_events": a.elapsed_time(b),
                      "peak_above_start_bytes": torch.cuda.max_memory_allocated(dev) - start,
                      "saved_tensors": len(storages) + len(kept),
                      "saved_bytes": sum(storages.values()) + sum(kept),
                      "policy_saved_bytes": sum(kept), "launches": got,
                      "launches_expected": want,
                      "b4_launches_by_instance": {k: v for k, v in
                                                  flash_attention_fwd.launches_by_instance.items()
                                                  if v}}
        check(got == want, f"26 remat {remat}: launches {got} vs the code's {want}")
        for k in launches:
            launches[k] += got[k]
        if ref is None:
            ref = (loss.detach(), [g for g in grads])
        else:
            res[remat]["bitwise_equal_to_none"] = bool(
                torch.equal(loss.detach(), ref[0])
                and all(torch.equal(x, y) for x, y in zip(grads, ref[1])))
        del loss, grads
    peaks = [res[r]["peak_above_start_bytes"] for r in ("none", "dots", "full")]
    print(f"26 {cfg.name} {cfg.n_layers} layers bf16, {DOTS_BATCH} x {DOTS_SEQ} tokens: "
          + "; ".join(f"{r} loss {v['loss']:.6f}, {v['ms_cuda_events']:.1f} ms, peak above the "
                      f"start {v['peak_above_start_bytes'] / 1e9:.2f} GB, saved "
                      f"{v['saved_tensors']} tensors / {v['saved_bytes'] / 1e9:.3f} GB, launches "
                      f"{v['launches']}" for r, v in res.items())
          + f"; dots bitwise equal to none: {res['dots']['bitwise_equal_to_none']}, full: "
          f"{res['full']['bitwise_equal_to_none']}")
    check(res["dots"]["bitwise_equal_to_none"], "26 remat dots: loss or grads differ from none's")
    check(peaks[0] > peaks[1] > peaks[2], f"26 peaks none, dots, full: {peaks}")
    check(res["none"]["saved_bytes"] > res["dots"]["saved_bytes"] > res["full"]["saved_bytes"],
          f"26 saved bytes: {[res[r]['saved_bytes'] for r in res]}")
    del params, leaves, ref, batch
    torch.cuda.empty_cache()
    print(json.dumps({"remat_dots": {"arch": cfg.name, "layers": cfg.n_layers,
                                     "tokens": [DOTS_BATCH, DOTS_SEQ], **res,
                                     "seconds": time.monotonic() - t0, "card": smi}}))
    return launches


# ---------------------------------------------------------------------------
# Phase 27: the captured training step and decode (ROADMAP A items 1, 1b)
# ---------------------------------------------------------------------------


def state_checksums(state) -> dict:
    """Each leaf of a train state by path: a tensor's bits (viewed as an
    integer of its width) summed as int64 over ``CHECKSUM_CHUNKS``
    contiguous chunks, an int as it is - a position-sensitive digest that
    holds no second copy of a full-width state."""
    import torch

    from repro_torch.ckpt.manager import map_with_path

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}

    def leaf(path, x):
        if isinstance(x, torch.Tensor):
            bits = x.detach().reshape(-1).view(ints[x.element_size()])
            out[path] = torch.stack([c.sum(dtype=torch.int64)
                                     for c in bits.tensor_split(CHECKSUM_CHUNKS)]).cpu()
        else:
            out[path] = x

    map_with_path(leaf, state)
    return out


def same_checksums(a: dict, b: dict) -> bool:
    import torch

    def equal(x, y):
        if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
            return bool(torch.equal(x, y))
        return x == y

    return list(a) == list(b) and all(equal(a[k], b[k]) for k in a)


def kernel_totals(counts: dict) -> dict:
    """The per-kernel entries of a ``kernel_launch_counts`` difference (its
    ``name/instance`` entries left out)."""
    return {k: v for k, v in counts.items() if "/" not in k and v}


def lm_eager_twin(dev, run, arch, pcfg, tcfg, make_batch) -> dict:
    """``run``'s eager steps on ``arch`` from seed 0, as ``lm_train_phase``
    takes them: the final ``state_checksums``, losses, event and host step
    ms and peak."""
    import gc

    import torch

    from repro_torch.runtime.driver import DriverConfig, run_training
    from repro_torch.train.trainer import make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    init_state, body = make_train_step(arch, pcfg, tcfg)
    events, losses, last = [], [], {}

    def timed_step(state, batch):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = body(state, batch)
        b.record()
        events.append((a, b))
        losses.append(float(m["loss"]))
        last["state"] = state
        return state, m

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    report = run_training(init_state=init_state, train_step=timed_step, make_batch=make_batch,
                          steps=run.steps, cfg=DriverConfig(max_restarts=0), seed=SEED)
    torch.cuda.synchronize()
    out = {"sums": state_checksums(last["state"]), "losses": losses,
           "step_ms": [a.elapsed_time(b) for a, b in events],
           "host_ms": [t * 1e3 for t in report.step_times],
           "peak": torch.cuda.max_memory_allocated(dev)}
    del last, init_state, body
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_capture_run(dev, smi: str, run, cfg, arch, pcfg, tcfg, make_batch, per_mb: dict,
                   eager: dict) -> dict:
    """Phase 27(c) for one LM cell (``lm_capture_pair``), at the cell's depth or,
    where the captured step does not fit the card, at the deepest depth
    whose captured step does, beside an eager twin at that depth (printed,
    and in the line as ``layers``)."""
    import gc

    import torch

    from repro_torch.models.registry import bundle_from_cfg

    def cut(cfg, depth, why):
        cfg = dataclasses.replace(cfg, n_layers=depth)
        print(f"27(c) {run.key}: {why}; eager and captured twins at {depth} layers")
        arch = bundle_from_cfg(cfg, dev)
        eager = lm_eager_twin(dev, run, arch, pcfg, tcfg, make_batch)
        return cfg, arch, lm_launches_per_microbatch(cfg, pcfg.remat), eager

    depth = CAPTURE_TRAIN_DEPTH.get(run.arch, cfg.n_layers)
    if depth < cfg.n_layers:
        cfg, arch, per_mb, eager = cut(
            cfg, depth, f"CAPTURE_TRAIN_DEPTH cuts the captured step's {cfg.n_layers} layers "
                        f"(it does not fit, or the run's time)")
    while True:
        try:
            return lm_capture_pair(dev, smi, run, cfg, arch, pcfg, tcfg, make_batch, per_mb,
                                   eager)
        except torch.OutOfMemoryError as e:
            msg = str(e).splitlines()[0]
        gc.collect()
        torch.cuda.empty_cache()
        check(cfg.n_layers > 1, f"27(c) {run.key}: no depth's captured step fits")
        cfg, arch, per_mb, eager = cut(cfg, cfg.n_layers - 1, f"the captured step does not fit "
                                       f"at {cfg.n_layers} layers ({msg})")


def lm_capture_pair(dev, smi: str, run, cfg, arch, pcfg, tcfg, make_batch, per_mb: dict,
                    eager: dict) -> dict:
    """One LM training cell captured: the same config, params (a
    re-init from seed 0) and batches as the eager run of ``lm_train_phase``
    (``eager``: its per-leaf ``state_checksums`` after the last step, its
    losses, event and host step ms and peak), now through
    ``capture_train_step``: WARM_RUNS eager steps, one
    capture, a replay every later step.  Checks the final state's checksums
    and every loss bit for bit against the eager run's, the launches the
    host counted (the warm steps and the capture; none while replaying)
    and the graph's (``per_mb`` x microbatches), then times
    CAPTURE_EXTRA_REPLAYS more replays; the idle shares take the device
    work of the cell's profiled eager step.  Prints the
    ``{"capture_train": ...}`` line and adds the launches the run executed
    (warm steps + graph x replays) to ``CAPTURED_LAUNCHES``."""
    import gc

    import torch

    from repro_torch.launch.dryrun import leaf_bytes
    from repro_torch.runtime.driver import DriverConfig, run_training
    from repro_torch.serve.exec_cache import WARM_RUNS, kernel_launch_counts
    from repro_torch.train.trainer import capture_train_step, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    init_state, body = make_train_step(arch, pcfg, tcfg)
    step = capture_train_step(body, dev)
    events, losses, last = [], [], {}

    def timed_step(state, batch):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = step(state, batch)
        b.record()
        events.append((a, b))
        losses.append(float(m["loss"]))
        last["state"] = state
        return state, m

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = kernel_launch_counts()
    try:
        report = run_training(init_state=init_state, train_step=timed_step,
                              make_batch=make_batch, steps=run.steps,
                              cfg=DriverConfig(max_restarts=0), seed=SEED)
    except torch.OutOfMemoryError:
        del step, body, init_state, last
        raise
    torch.cuda.synchronize()
    host = kernel_totals({k: v - before.get(k, 0) for k, v in kernel_launch_counts().items()})
    peak = torch.cuda.max_memory_allocated(dev)
    sums = state_checksums(last["state"])
    same = same_checksums(sums, eager["sums"])
    # the captured step's live state and one step's batch, leaf by leaf, on
    # the card (phase 28(a) holds the dry run's argument bytes to them)
    live_bytes = leaf_bytes((last["state"], make_batch(0)))
    step_ms = [a.elapsed_time(b) for a, b in events]
    per_step = {k: v * run.accum for k, v in per_mb.items() if v}
    graph = kernel_totals(step.launches)
    print(f"27(c) {run.key}: {cfg.n_layers} layers, captured {step.warm_steps} warm steps + "
          f"{step.replays} replays; losses {losses} (eager {eager['losses']}); final state "
          f"{'bit for bit' if same else 'DIFFERS from'} the eager run's; graph launches {graph}, "
          f"host launches {host} (warm + capture {per_step} x {WARM_RUNS + 1})")
    check(report.restarts == 0 and report.steps_done == run.steps, f"27(c) {run.key}: {report}")
    check(step.warm_steps == WARM_RUNS and step.replays == run.steps - WARM_RUNS,
          f"27(c) {run.key}: {step.warm_steps} warm steps, {step.replays} replays")
    check(same and losses == eager["losses"],
          f"27(c) {run.key}: the captured run's state or losses differ from the eager run's")
    check(graph == per_step, f"27(c) {run.key}: graph launches {graph} != the code's {per_step}")
    check(host == {k: v * (WARM_RUNS + 1) for k, v in per_step.items()},
          f"27(c) {run.key}: launches from the host {host} beyond the warm steps and the capture")
    executed = {k: v * (step.warm_steps + step.replays) for k, v in per_step.items()}
    for k, v in executed.items():
        CAPTURED_LAUNCHES[k] = CAPTURED_LAUNCHES.get(k, 0) + v
    replays = step.replays
    # more replays to time (the last run step's is the only pure one: the
    # step before it also captured), then one profiled (the card alone)
    state = last["state"]
    for i in range(CAPTURE_EXTRA_REPLAYS):
        timed_step(state, make_batch(run.steps + i))
    torch.cuda.synchronize()
    replayed = [a.elapsed_time(b) for a, b in events[WARM_RUNS + 1:]]
    # a replay runs the eager step's kernels on the same shapes: its device
    # work is the cell's profiled eager step's (a twin at a cut depth has no
    # profile, and its idle shares are not measured)
    dev_ms = eager.get("device_ms")
    eager_steady = eager["step_ms"][WARM_RUNS:]
    out = {
        "arch": cfg.name, "layers": cfg.n_layers, "steps": run.steps, "warmup": tcfg.warmup,
        "warm_steps": step.warm_steps, "replays": replays,
        "capture_step_ms": step_ms[WARM_RUNS], "replays_timed": len(replayed),
        "bitwise_equal_to_eager": same, "losses": losses[:run.steps],
        "step_ms_cuda_events_eager": eager["step_ms"], "step_ms_cuda_events_captured": step_ms,
        "step_ms_replays": replayed,
        "step_ms_eager_steady_median": statistics.median(eager_steady),
        "step_ms_replay_median": statistics.median(replayed),
        "step_ms_host_eager": eager["host_ms"],
        "step_ms_host_captured": [t * 1e3 for t in report.step_times],
        "device_ms_eager_profile": dev_ms,
        "idle_share_replay": (None if dev_ms is None
                              else max(0.0, 1 - dev_ms / statistics.median(replayed))),
        "idle_share_eager_steady": (None if dev_ms is None else
                                    max(0.0, 1 - dev_ms / statistics.median(eager_steady))),
        "peak_mem_bytes_eager": eager["peak"], "peak_mem_bytes_captured": peak,
        "pool_bytes": step.pool_bytes, "graph_launches": graph, "launches_executed": executed,
        "card": smi,
    }
    print(json.dumps({"capture_train": {run.key: out}}))
    out["live_bytes"] = live_bytes
    del step, body, init_state, last, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def decode_compare(dev, smi: str, name: str, cfg, arch, params) -> dict:
    """Phase 27(d) for one served config: the same requests (CAPTURE_DECODE_
    PROMPTS tokens, CAPTURE_DECODE_NEW greedy tokens; LM_SERVE_SLOTS slots,
    so the last request is admitted into a freed slot while the others
    decode) through ``ServeEngine(capture=False)`` and the captured engine:
    the same tokens, request for request; tick ms on events and the host
    clock, time to first token (a request's admission to its first token),
    the graphs and their pools.  For an encoder-decoder also C.18 on the
    card: the captured engine's idle slots at DEC_POS_ROWS - 2 while slot 0
    serves, ticked past the table's end, finite and with no device-side
    assert.  Prints the ``{"capture_decode": ...}`` line."""
    import numpy as np
    import torch

    from repro_torch.models.whisper import DEC_POS_ROWS
    from repro_torch.serve.engine import Request, ServeEngine

    from repro_torch.serve.exec_cache import kernel_launch_counts

    rng = np.random.default_rng(SEED + 27)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in CAPTURE_DECODE_PROMPTS]
    out, answers = {}, {}
    for cap in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = ServeEngine(arch, params, batch=LM_SERVE_SLOTS, max_seq=LM_SERVE_MAX_SEQ,
                          capture=cap)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        b6_before = kernel_launch_counts()["rmsnorm"]
        for rid, (p, n) in enumerate(zip(prompts, CAPTURE_DECODE_NEW)):
            eng.submit(Request(rid=rid, prompt=p, max_new_tokens=n))
        admitted, first, beside = {}, {}, []
        ev, host = [], []
        while eng.queue or any(r is not None for r in eng.slots):
            t_adm = time.perf_counter()
            busy = [r.rid for r in eng.slots if r is not None]
            free = {i for i, r in enumerate(eng.slots) if r is None}
            eng._admit()
            new = [eng.slots[i].rid for i in free if eng.slots[i] is not None]
            for rid in new:
                admitted[rid] = t_adm
                if busy:
                    beside.append(rid)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            live = [r for r in eng.slots if r is not None]
            a.record()
            h0 = time.perf_counter()
            eng.tick()
            host.append((time.perf_counter() - h0) * 1e3)
            b.record()
            b.synchronize()
            ev.append(a.elapsed_time(b))
            now = time.perf_counter()
            for r in live:
                if len(r.out_tokens) == 1:
                    first[r.rid] = now
        answers[cap] = {r.rid: r.out_tokens for r in eng._finished}
        b6 = kernel_launch_counts()["rmsnorm"] - b6_before
        if cap:
            check(b6 == 0, f"27(d) {name}: {b6} B6 launches from the host while replaying")
            b6 = eng.graph_launches["tick"].get("rmsnorm", 0) * (eng.decode_calls
                                                                 + eng.prefill_tokens)
        check(b6 == b6_per_decode_call(cfg) * (eng.decode_calls + eng.prefill_tokens),
              f"27(d) {name}: B6 launches {b6}")
        CAPTURED_LAUNCHES["rmsnorm"] = CAPTURED_LAUNCHES.get("rmsnorm", 0) + b6
        ttft = [(first[k] - admitted[k]) * 1e3 for k in sorted(first)]
        out["captured" if cap else "eager"] = {
            "tick_ms_cuda_events_median": statistics.median(ev),
            "tick_ms_host_median": statistics.median(host), "ticks": len(ev),
            "ttft_ms": ttft, "ttft_ms_median": statistics.median(ttft),
            "prefill_tokens": eng.prefill_tokens, "engine_build_s": build_s,
            "graphs": len(eng.graphs), "pool_bytes": sum(eng.graph_pool_bytes.values()),
            "replays": dict(eng.replays), "admitted_beside_busy_slots": beside,
        }
        if cap and cfg.encoder_decoder:
            eng.submit(Request(rid=99, prompt=prompts[0][:4], max_new_tokens=8))
            eng._admit()
            for c in eng.caches:
                c.attn.lengths[1:] = DEC_POS_ROWS - 2
            for _ in range(4):
                eng.tick()
            torch.cuda.synchronize()
            lengths = [int(x) for x in eng.caches[0].attn.lengths]
            finite = bool(torch.isfinite(eng._logits).all())
            out["c18"] = {"lengths": lengths, "finite": finite}
            print(f"27(d) {name} C.18 on the card: idle slots ticked to positions {lengths[1:]} "
                  f"past the {DEC_POS_ROWS}-row table beside slot 0 at {lengths[0]}: logits "
                  f"finite {finite}, no device-side assert")
            check(finite and min(lengths[1:]) > DEC_POS_ROWS, f"27(d) {name}: C.18 {out['c18']}")
        del eng
    same = answers[False] == answers[True]
    e, c = out["eager"], out["captured"]
    print(f"27(d) {name}: captured decode {'gives the same tokens as' if same else 'DIFFERS from'}"
          f" eager for {len(answers[True])} requests (admitted beside busy slots: "
          f"{c['admitted_beside_busy_slots']}); tick {e['tick_ms_cuda_events_median']:.2f} -> "
          f"{c['tick_ms_cuda_events_median']:.2f} ms (events), ttft "
          f"{e['ttft_ms_median']:.1f} -> {c['ttft_ms_median']:.1f} ms; {c['graphs']} graphs, "
          f"{c['pool_bytes']} pool bytes")
    check(same and sorted(answers[True]) == list(range(len(prompts))),
          f"27(d) {name}: captured tokens {answers[True]} != eager {answers[False]}")
    check(c["admitted_beside_busy_slots"] and c["graphs"] == LM_SERVE_SLOTS + 1
          and e["graphs"] == 0, f"27(d) {name}: {c}")
    out.update(same_tokens=same, card=smi)
    print(json.dumps({"capture_decode": {name: out}}))
    return out


def capture_cnn_phase(dev, smi: str) -> dict:
    """Phase 27(a): phase 5's network and plan (2x2 sync, hand-picked
    groups, batch 8 in 2 microbatches, SGD) with int8 error feedback and
    CAPTURE_WARMUP, CAPTURE_CNN_STEPS steps eager and captured from the same
    init and batches: every loss, the params, momenta, counters and EF bit
    for bit; a planted fault - a replay whose step counter was not advanced
    (step CAPTURE_FAULT_STEP replays step CAPTURE_FAULT_STEP - 1's count) -
    must fail that check.  Reports event-step ms (median of the replays)
    against the eager steps', host ms, a profiled replay's idle share, the
    graph's launches (the code's per step) x replays, pool bytes and peaks."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.tiling import Group
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.yolo import make_yolo_tiled_arch
    from repro_torch.serve.exec_cache import WARM_RUNS, kernel_launch_counts
    from repro_torch.train.trainer import capture_train_step, make_train_step

    arch = make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=GRID[0], m=GRID[1],
                                groups=[Group(*g) for g in _HAND], backend="cuda", device=dev)
    pcfg = ParallelConfig(grad_accum=TRAIN_ACCUM)
    tcfg = TrainConfig(lr=TRAIN_LR, optimizer="sgd", warmup=CAPTURE_WARMUP,
                       steps=CAPTURE_CNN_STEPS, seed=SEED, grad_compression="int8")
    make_batch = make_batch_fn(TRAIN_BATCH, INPUT_HW[0], arch.target_shape(TRAIN_BATCH), SEED,
                               dev)
    batches = [make_batch(s) for s in range(CAPTURE_CNN_STEPS)]
    per_mb, _ = launches_per_batch(arch.plan, TRAIN_BATCH // TRAIN_ACCUM)
    per_step = {k: v * TRAIN_ACCUM for k, v in per_mb.items()}

    def drive(captured: bool, fault: bool = False):
        gc.collect()
        torch.cuda.empty_cache()
        init_state, step = make_train_step(arch, pcfg, tcfg)
        if captured:
            step = capture_train_step(step, dev)
        state = init_state(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = kernel_launch_counts()
        losses, lrs, ev, host, sums = [], [], [], [], []
        for s, batch in enumerate(batches):
            if fault and s == CAPTURE_FAULT_STEP:
                state.step.sub_(1)          # the counter the last replay advanced, set back
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            h0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            host.append((time.perf_counter() - h0) * 1e3)
            b.record()
            b.synchronize()
            ev.append(a.elapsed_time(b))
            lrs.append(float(m["lr"]))
            if captured and not fault:
                sums.append(state_checksums(state.params))
        launched = kernel_totals({k: v - before.get(k, 0)
                                  for k, v in kernel_launch_counts().items()})
        return dict(state=state, step=step, losses=losses, lrs=lrs, ev=ev, host=host,
                    launched=launched, peak=torch.cuda.max_memory_allocated(dev), sums=sums)

    t0 = time.perf_counter()
    eager = drive(False)
    graph = drive(True)
    step = graph["step"]
    same = same_state(graph["state"], eager["state"])
    glaunch = kernel_totals(step.launches)
    print(f"27(a) CNN 2x2 sync, int8 EF, warmup {CAPTURE_WARMUP}, {CAPTURE_CNN_STEPS} steps: LRs "
          f"{eager['lrs']}; losses eager {eager['losses']} captured {graph['losses']}; state "
          f"{'bit for bit' if same else 'DIFFERS'}; graph launches {glaunch} x {step.replays} "
          f"replays, host {graph['launched']}")
    check(len(set(eager["lrs"])) == CAPTURE_CNN_STEPS - 1, f"27(a): LRs {eager['lrs']}")
    check(same and graph["losses"] == eager["losses"] and graph["state"].ef is not None,
          "27(a): the captured CNN run differs from the eager run")
    check(step.warm_steps == WARM_RUNS and step.replays == CAPTURE_CNN_STEPS - WARM_RUNS,
          f"27(a): {step.warm_steps} warm steps, {step.replays} replays")
    check(glaunch == per_step, f"27(a): graph launches {glaunch} != the code's {per_step}")
    check(graph["launched"] == {k: v * (WARM_RUNS + 1) for k, v in per_step.items()}
          and eager["launched"] == {k: v * CAPTURE_CNN_STEPS for k, v in per_step.items()},
          f"27(a): host launches {graph['launched']} / eager {eager['launched']}")
    for k, v in per_step.items():
        CAPTURED_LAUNCHES[k] = CAPTURED_LAUNCHES.get(k, 0) + v * (2 * CAPTURE_CNN_STEPS)

    batch = batches[0]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        step(graph["state"], batch)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - h0) * 1e3
    dev_ms = sum(device_ms_by_name(prof, 1).values())
    check(dev_ms > 0, "27(a): the profiler saw no device time in a replay")
    replay_ms = statistics.median(graph["ev"][WARM_RUNS:])
    eager_ms = statistics.median(eager["ev"][WARM_RUNS:])
    fault = drive(True, fault=True)
    caught = not same_state(fault["state"].params, eager["state"].params)
    print(f"27(a) planted: step {CAPTURE_FAULT_STEP} replays step {CAPTURE_FAULT_STEP - 1}'s "
          f"count (LR {fault['lrs'][CAPTURE_FAULT_STEP]} for {eager['lrs'][CAPTURE_FAULT_STEP]}): "
          f"the bitwise check {'fails, as it must' if caught else 'PASSES'}")
    check(caught, "27(a): a replay with a stale step counter passed the bitwise check")
    out = {"steps": CAPTURE_CNN_STEPS, "warmup": CAPTURE_WARMUP, "lrs": eager["lrs"],
           "losses": graph["losses"], "bitwise_equal_to_eager": same,
           "step_ms_cuda_events_eager": eager["ev"], "step_ms_cuda_events_captured": graph["ev"],
           "step_ms_eager_steady_median": eager_ms, "step_ms_replay_median": replay_ms,
           "step_ms_host_eager": eager["host"], "step_ms_host_captured": graph["host"],
           "replay_device_ms": dev_ms, "replay_profiled_wall_ms": prof_wall,
           "idle_share_replay": max(0.0, 1 - dev_ms / replay_ms),
           "idle_share_eager_steady": max(0.0, 1 - dev_ms / eager_ms),
           "graph_launches": glaunch, "replays": step.replays, "pool_bytes": step.pool_bytes,
           "peak_mem_bytes_eager": eager["peak"], "peak_mem_bytes_captured": graph["peak"],
           "planted_stale_counter_caught": caught, "s": time.perf_counter() - t0, "card": smi}
    print(json.dumps({"capture_train": {"cnn": out}}))
    out["checksums"] = graph["sums"]          # for 29(e): the captured run's params a step
    del eager, graph, fault, step, prof
    gc.collect()
    torch.cuda.empty_cache()
    return out


def capture_elastic_phase(dev, smi: str, root: str) -> dict:
    """Phase 27(b): ``python -m repro_torch.launch.train`` on the card with
    phase 5's plan (``--groups 4``), a checkpoint a step and
    ELASTIC_CAPTURE_FAULTS: a device dropped (a replan onto the three
    survivors: a new graph) and later a failed step (a restart from the
    last checkpoint, copied into the graph's static state).  The same argv
    with ``jit_step`` set to the eager step is the twin: both report
    ``replans=1 restarts=1``, and their last checkpoints hold the same
    bytes.  Prints the number of graphs captured."""
    import torch

    from repro_torch.launch import train as train_launcher

    argv = ["--arch", "yolov2-tiled", "--grid", str(GRID[0]), "--input-hw", str(INPUT_HW[0]),
            "--depth", "16", "--groups", "4", "--batch", str(TRAIN_BATCH), "--grad-accum",
            str(TRAIN_ACCUM), "--optimizer", "sgd", "--lr", str(TRAIN_LR), "--steps",
            str(ELASTIC_CAPTURE_STEPS), "--ckpt-every", "1", "--fault-schedule",
            ELASTIC_CAPTURE_FAULTS]
    t0 = time.perf_counter()
    runs = {}
    for label in ("eager", "captured"):
        d = os.path.join(root, f"capture_{label}")
        buf = io.StringIO()
        swaps = ([(train_launcher, "jit_step", lambda step, device, group=None: step)]
                 if label == "eager" else [])
        with contextlib.redirect_stdout(buf), swapped(*swaps):
            rc = train_launcher.main([*argv, "--ckpt-dir", d])
        text = buf.getvalue()
        print(text, end="")
        last = os.path.join(d, f"step_{ELASTIC_CAPTURE_STEPS - 1:08d}")
        check(rc == 0 and os.path.isdir(last), f"27(b) {label}: rc {rc}, no final checkpoint")
        files = {f: open(os.path.join(last, f), "rb").read() for f in sorted(os.listdir(last))
                 if f.endswith(".npy")}
        graphs = int(text.split("step: ")[-1].split(" CUDA graphs")[0])
        runs[label] = dict(text=text, files=files, graphs=graphs)
    same = runs["eager"]["files"] == runs["captured"]["files"]
    print(f"27(b) the launcher under {ELASTIC_CAPTURE_FAULTS}: {runs['captured']['graphs']} CUDA "
          f"graphs captured (eager twin {runs['eager']['graphs']}); the last checkpoint's "
          f"{len(runs['captured']['files'])} leaves {'the same bytes' if same else 'DIFFER'}")
    for label, r in runs.items():
        check("restarts=1 replans=1" in r["text"] and "replan (drop:3)" in r["text"],
              f"27(b) {label}: replans and restarts")
    check(same and runs["captured"]["graphs"] == 2 and runs["eager"]["graphs"] == 0,
          f"27(b): captured {runs['captured']['graphs']} graphs, same bytes {same}")
    torch.cuda.empty_cache()
    import hashlib

    return {"graphs": runs["captured"]["graphs"], "bitwise_equal_to_eager": same,
            "s": time.perf_counter() - t0,
            "ckpt": {f: hashlib.sha256(b).hexdigest()
                     for f, b in runs["captured"]["files"].items()}}


# ---------------------------------------------------------------------------
# Phase 28: the dry run held against the card (ROADMAP A.19)
# ---------------------------------------------------------------------------


def elastic_rank(group, root: str, plant: bool) -> dict:
    """Phase 29(d), one rank: phase 18(b)-(c)'s elastic runs through
    ``run_training`` on the ranks, as ``launch/train.py --dist`` drives
    them: the padded cluster plan on this rank's block under
    ``ELASTIC29_FAULTS`` (its Jetson drop replanned onto the survivors by
    the launcher's ``make_replan``, a rank past them idle), then the
    original plan resuming the survivors' last checkpoint to
    ``ELASTIC_STEPS``; checkpoints under ``root`` (rank 0 alone writes).
    Per run: the report, each step's param checksums (by the state's step
    count) and event ms, the peak before and after the replan, the replan
    ms, rank 0's restore (read and broadcast) ms, the B1-B3 launches, the
    driver's collectives by role and the model's, and on rank 0 the final
    params and the last checkpoint's checksums.  ``plant``: the other ranks
    take part in rank 0's restore broadcast but keep their pre-failure
    state."""
    import copy

    import torch

    from repro_torch.analysis.collectives import driver_collectives, split_record
    from repro_torch.ckpt.manager import CheckpointManager, map_with_path
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.fusion import plan_manifest
    from repro_torch.core.grouping import parse_cluster_spec
    from repro_torch.launch.mesh import make_dist_tile_mesh
    from repro_torch.launch.train import make_batch_fn, make_replan
    from repro_torch.models.yolo import make_yolo_tiled_arch
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.runtime import driver as tdriver
    from repro_torch.runtime.driver import DriverConfig, run_training
    from repro_torch.runtime.faults import FaultInjector
    from repro_torch.serve.exec_cache import kernel_launch_counts
    from repro_torch.train.trainer import make_train_step

    dev = group.device
    cluster = parse_cluster_spec(_CLUSTER_KW["hw"], *GRID)
    pcfg = ParallelConfig(grad_accum=TRAIN_ACCUM)
    tcfg = TrainConfig(lr=TRAIN_LR, optimizer="sgd", warmup=0, steps=ELASTIC_STEPS, seed=SEED)
    d = os.path.join(root, "planted" if plant else "ckpt")

    def arch_of():
        return make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=GRID[0], m=GRID[1],
                                    groups="auto", ragged_exec="padded", backend="cuda",
                                    mesh=make_dist_tile_mesh(*GRID, dev, group), **_CLUSTER_KW)

    real_share, real_read = tdriver._share_state, CheckpointManager.restored_step

    def drive(steps, cfg, faults=None, with_replan=False):
        arch = arch_of()
        init_state, step0 = make_train_step(arch, pcfg, tcfg)
        make_batch = make_batch_fn(TRAIN_BATCH, INPUT_HW[0], arch.target_shape(TRAIN_BATCH),
                                   SEED, dev)
        replan = make_replan(arch, cluster, "pi3-core", TRAIN_BATCH, pcfg, tcfg, group)
        rec = {"checksums": {}, "ms": [], "ms_after_replan": [], "restore_read_ms": [],
               "restore_broadcast_ms": [], "return_broadcast_ms": []}

        def timed(fn, key):
            def step(state, batch):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                state, m = fn(state, batch)
                b.record()
                b.synchronize()
                rec[key].append(a.elapsed_time(b))
                rec["checksums"][int(state.step)] = state_checksums(state.params)
                rec["state"] = state
                return state, m
            return step

        def replan_timed(ev):
            torch.cuda.synchronize()
            rec["peak_before_replan"] = torch.cuda.max_memory_allocated(dev)
            t0 = time.perf_counter()
            fn, man = replan(ev)
            torch.cuda.synchronize()
            rec["replan_ms"] = (time.perf_counter() - t0) * 1e3
            rec["replanned"] = fn
            rec["active_after_replan"] = group.active
            torch.cuda.reset_peak_memory_stats(dev)
            return (None if fn is None else timed(fn, "ms_after_replan")), man

        def share(g, state, role):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if plant and role == "restore" and g.rank != 0:
                real_share(g, copy.deepcopy(state), role)
                out = state
            else:
                out = real_share(g, state, role)
            torch.cuda.synchronize()
            rec[f"{role}_broadcast_ms"].append((time.perf_counter() - t0) * 1e3)
            return out

        def read(self, like, device=None):
            t0 = time.perf_counter()
            got = real_read(self, like, device)
            torch.cuda.synchronize()
            rec["restore_read_ms"].append((time.perf_counter() - t0) * 1e3)
            return got

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        group.take_record()
        before = kernel_launch_counts()
        tdriver._share_state, CheckpointManager.restored_step = share, read
        try:
            rep = run_training(init_state=init_state, train_step=timed(step0, "ms"),
                               make_batch=make_batch, steps=steps, cfg=cfg, seed=SEED,
                               faults=FaultInjector(faults) if faults else None,
                               replan=replan_timed if with_replan else None,
                               plan=plan_manifest(arch.plan, cluster), device=dev, group=group)
        finally:
            tdriver._share_state, CheckpointManager.restored_step = real_share, real_read
        torch.cuda.synchronize()
        launches = kernel_totals({k: v - before.get(k, 0)
                                  for k, v in kernel_launch_counts().items()})
        # under nccl the replanned step is a graph: the host counted its
        # capture's pass once, and each replay ran it
        fn = rec.pop("replanned", None)
        rec["replanned_captured"] = bool(getattr(fn, "captured", False))
        if rec["replanned_captured"]:
            for k, v in kernel_totals(fn.launches).items():
                launches[k] += v * (fn.replays - 1)
        _, roles = split_record(group.take_record())
        state = rec.pop("state")
        leaves = [x.numel() * x.element_size() for x in tree_leaves(state.params)]
        state_leaves = []
        map_with_path(lambda _, x: state_leaves.append(x.numel() * x.element_size())
                      if isinstance(x, torch.Tensor) else None, state)
        rec.update(
            report={"steps_done": rep.steps_done, "restarts": rep.restarts,
                    "replans": rep.replans, "resumed_step": rep.resumed_step,
                    "attempts": len(rep.step_times)},
            launches=launches, roles=roles, leaves=leaves, state_leaves=state_leaves,
            peak=torch.cuda.max_memory_allocated(dev),
            params=[t.cpu() for t in tree_leaves(state.params)] if group.rank == 0 else None,
            ckpt=state_checksums(CheckpointManager(d).restore(state, step=steps - 1, device=dev))
            if group.rank == 0 else None)
        return rec

    out = {"drop": drive(5, DriverConfig(ckpt_dir=d, ckpt_every=ELASTIC29_CKPT_EVERY),
                         ELASTIC29_FAULTS, with_replan=True),
           "resume": drive(ELASTIC_STEPS, DriverConfig(ckpt_dir=d, ckpt_every=ELASTIC29_CKPT_EVERY,
                                                       resume="always"))}
    drop, back = out["drop"], out["resume"]
    # the driver's collectives: an agreement a step attempted (the drop's
    # and the failure's included, where the rank was active), the meetings,
    # rank 0's decisions, the params' init and the restores' broadcasts
    out["roles_model"] = {
        "drop": driver_collectives(
            agreements=drop["report"]["attempts"] + 1 + drop["report"]["restarts"], meetings=2,
            decisions=1 + drop["report"]["restarts"],
            shares={"init": (1, drop["leaves"]),
                    "restore": (drop["report"]["restarts"], drop["state_leaves"])}),
        "resume": driver_collectives(
            agreements=back["report"]["attempts"], meetings=1, decisions=2,
            shares={"init": (1, back["leaves"]), "restore": (1, back["state_leaves"])})}
    return out


def clock_drive(engine, images) -> list:
    """Phase 17's requests (``ARRIVALS``) under ``SERVE29_CLOCK``: a
    ``ManualClock`` advanced a tick at a time, each tick's arrivals
    submitted and one engine step taken, a dispatch's service time
    simulated, then the drain; the engine's step bound and budget the
    clock's.  -> the batch log as (t, bucket, filled)."""
    from repro_torch.serve.cnn_engine import ManualClock

    tick, service, bound, budget = SERVE29_CLOCK
    engine.clock, engine.simulate_step_s = ManualClock(), service
    engine.step_bound, engine.latency_budget = bound, budget
    it = iter(images)
    for a in ARRIVALS:
        for _ in range(a):
            engine.submit(next(it))
        engine.clock.advance(tick)
        engine.step()
    engine.drain()
    return [(b["t"], b["bucket"], b["filled"]) for b in engine.batch_log]


def response_hashes(engine) -> list:
    """The sha256 of each response's bytes, in request order."""
    import hashlib

    return [hashlib.sha256(r.result.tobytes()).hexdigest()
            for r in sorted(engine.finished, key=lambda r: r.rid)]


def capture_rank(group, root: str, plans: dict) -> dict:
    """Phase 29(a)(i)-(ii) (and (c)), one nccl rank (ROADMAP A.20.3).  (i)
    27(a)'s cell - phase 5's plan, int8 error feedback, ``CAPTURE_WARMUP``,
    ``CAPTURE_CNN_STEPS`` steps - on this rank's block: eager, captured
    (``capture_train_step`` with the group: the collectives inside the
    graph), and captured with 27(a)'s planted stale step counter; per run
    each step's param checksums and event ms, the host's B1-B3 launches,
    the graph's launches and replays, the pool, the peak and the record.
    (ii) ``launch/train.py``'s ``_train_tiled`` on the rank under 27(b)'s
    argv and faults (a drop replanned onto the survivors: a new graph on the
    regrouped communicators; a failed step restored into the graph's
    state): its output, the last checkpoint's leaf hashes, the graphs'
    launches and replays.  On more ranks (29(c)) also each of ``plans``
    (label -> ``make_yolo_tiled_arch`` kwargs) captured for TRAIN_STEPS
    steps, its checksums beside the eager run's."""
    import argparse
    import hashlib

    import torch

    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.tiling import Group
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.mesh import make_dist_tile_mesh
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.yolo import make_yolo_tiled_arch
    from repro_torch.serve.exec_cache import kernel_launch_counts
    from repro_torch.train.trainer import capture_train_step, make_train_step

    dev = group.device
    t0 = time.perf_counter()

    def run(arch, tcfg, steps, captured, fault=False):
        make_batch = make_batch_fn(TRAIN_BATCH, INPUT_HW[0], arch.target_shape(TRAIN_BATCH), SEED,
                                   dev)
        batches = [make_batch(s) for s in range(steps)]
        init_state, step = make_train_step(arch, ParallelConfig(grad_accum=TRAIN_ACCUM), tcfg)
        if captured:
            step = capture_train_step(step, dev, group)
        state = init_state(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        group.take_record()
        before = kernel_launch_counts()
        sums, ms = [], []
        for s, batch in enumerate(batches):
            if fault and s == CAPTURE_FAULT_STEP:
                state.step.sub_(1)          # the counter the last replay advanced, set back
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            state, _ = step(state, batch)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
            sums.append(state_checksums(state.params))
        host = kernel_totals({k: v - before.get(k, 0) for k, v in kernel_launch_counts().items()})
        out = dict(checksums=sums, ms=ms, host=host, record=group.take_record(),
                   peak=torch.cuda.max_memory_allocated(dev))
        if captured:
            graph = kernel_totals(step.launches)
            out.update(graph=graph, replays=step.replays, warm=step.warm_steps,
                       pool=step.pool_bytes, graph_record=step.collectives,
                       launched={k: host[k] + graph.get(k, 0) * (step.replays - 1) for k in host})
        else:
            out["launched"] = host
        return out

    def arch_of(kw, grid=GRID):
        return make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=grid[0], m=grid[1],
                                    backend="cuda", mesh=make_dist_tile_mesh(*grid, dev, group),
                                    **kw)

    # (i) 27(a)'s cell
    arch = arch_of(dict(groups=[Group(*g) for g in _HAND]))
    tcfg = TrainConfig(lr=TRAIN_LR, optimizer="sgd", warmup=CAPTURE_WARMUP,
                       steps=CAPTURE_CNN_STEPS, seed=SEED, grad_compression="int8")
    out = {"cell": {c: run(arch, tcfg, CAPTURE_CNN_STEPS, c != "eager", c == "planted")
                    for c in ("eager", "captured", "planted")}}
    del arch
    # (ii) the launcher under 27(b)'s faults
    argv = ["--arch", "yolov2-tiled", "--grid", str(GRID[0]), "--input-hw", str(INPUT_HW[0]),
            "--depth", "16", "--groups", "4", "--batch", str(TRAIN_BATCH), "--grad-accum",
            str(TRAIN_ACCUM), "--optimizer", "sgd", "--lr", str(TRAIN_LR), "--steps",
            str(ELASTIC_CAPTURE_STEPS), "--ckpt-every", "1", "--fault-schedule",
            ELASTIC_CAPTURE_FAULTS, "--ckpt-dir", os.path.join(root, "capture29")]
    steps, real_jit = [], train_launcher.jit_step

    def kept_jit(step, device, grp=None):
        steps.append(real_jit(step, device, grp))
        return steps[-1]

    ap = argparse.ArgumentParser()
    train_launcher._add_args(ap)
    buf = io.StringIO()
    group.take_record()
    before = kernel_launch_counts()
    with contextlib.redirect_stdout(buf), swapped((train_launcher, "jit_step", kept_jit)):
        rc = train_launcher._train_tiled(ap.parse_args(argv), group)
    host = kernel_totals({k: v - before.get(k, 0) for k, v in kernel_launch_counts().items()})
    graphs = [s for s in steps if getattr(s, "captured", False)]
    launched = dict(host)
    for s in graphs:
        for k, v in kernel_totals(s.launches).items():
            launched[k] += v * (s.replays - 1)
    last = os.path.join(root, "capture29", f"step_{ELASTIC_CAPTURE_STEPS - 1:08d}")
    out["launcher"] = {
        "rc": rc, "text": buf.getvalue(), "graphs": len(graphs),
        "replays": [s.replays for s in graphs], "launched": launched,
        "ckpt": ({f: hashlib.sha256(open(os.path.join(last, f), "rb").read()).hexdigest()
                  for f in sorted(os.listdir(last)) if f.endswith(".npy")}
                 if group.rank == 0 and os.path.isdir(last) else None)}
    group.take_record()
    del steps, graphs
    # (c) every plan's step captured, on more than one rank
    if group.world > 1:
        tcfg = TrainConfig(lr=TRAIN_LR, optimizer="sgd", warmup=0, steps=TRAIN_STEPS, seed=SEED)
        out["plans"] = {}
        for label, kw in plans.items():
            kw = dict(kw)
            grid = kw.pop("grid", GRID)
            out["plans"][label] = run(arch_of(kw, grid), tcfg, TRAIN_STEPS, True)
    out["s"] = time.perf_counter() - t0
    return out


def serve_rank(group, spec: dict) -> dict:
    """Phase 29(a)(iii), (b) and (c)'s serving, one rank (ROADMAP A.20.4):
    ``SERVE29_PLANS`` - phase 17's plans - each through ``CNNServeEngine``
    on this rank's block (rank 0's params and frozen BN statistics), its
    ladder warmed on every rank (under nccl each bucket captured with the
    forward's collectives inside its graph; gloo the eager forward), then
    phase 17's requests under ``SERVE29_CLOCK``: rank 0 drives the queue
    (``clock_drive``) and broadcasts every dispatch, the others follow.  Per
    plan: the engine's capture mode, warm-up s, the drive's record, the B1
    launches (the host's, plus each graph's at its capture times its
    replays), pool bytes and the drive's host s; rank 0 also the batch log,
    the responses' hashes and their error against the untiled reference
    (``spec["untiled"]``) over ``TOL_SERVE``.  ``spec["fault"]``: the first
    plan again with the last rank serving the batch its bucket held at its
    previous dispatch (it still takes part in every broadcast)."""
    import numpy as np
    import torch

    from repro_torch.core.tiling import Group
    from repro_torch.kernels.conv2d_tiled.kernel import launch_counts
    from repro_torch.launch.mesh import make_dist_tile_mesh
    from repro_torch.models.yolo import make_yolo_tiled_arch
    from repro_torch.serve.cnn_engine import CNNServeEngine

    dev = group.device
    images, calib = np.load(spec["images"]), np.load(spec["calib"])
    untiled = torch.from_numpy(np.load(spec["untiled"])) if group.rank == 0 else None
    out = {}
    runs = list(SERVE29_PLANS) + (["fault"] if spec["fault"] else [])
    for label in runs:
        name = SERVE29_PLANS[0] if label == "fault" else label
        grid, kw, buckets = CAPTURE_PLANS_416[name]
        if not isinstance(kw["groups"], str):
            kw = dict(kw, groups=[Group(*g) for g in kw["groups"]])
        mesh = make_dist_tile_mesh(*grid, dev, group)
        arch = make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=grid[0], m=grid[1],
                                    backend="cuda", mesh=mesh, **kw)
        real = CNNServeEngine._share_batch
        if label == "fault" and group.rank == group.world - 1:
            CNNServeEngine._share_batch = lambda self, x: real(self, x.clone())
        try:
            params = arch.serve_params(arch.init(SEED), calib)
            engine = arch.make_serve_engine(params, buckets=buckets)
            t0 = time.perf_counter()
            engine.warmup()
            torch.cuda.synchronize()
            row = {"plan": name, "mode": engine.capture_mode, "warmup_s": time.perf_counter() - t0,
                   "coord": list(mesh.coord), "ranks": list(mesh.ranks), "buckets": list(buckets)}
            group.take_record()
            before = launch_counts().get("conv2d_tile", 0)
            t0 = time.perf_counter()
            if engine.leader:
                try:
                    row["log"] = clock_drive(engine, images)
                finally:
                    engine.finish()
            else:
                row["followed"] = engine.follow()
            torch.cuda.synchronize()
            row["drive_s"] = time.perf_counter() - t0
        finally:
            CNNServeEngine._share_batch = real
        cap = engine.stats()["capture"]
        row.update(record=group.take_record(), pool_bytes=cap["pool_bytes"],
                   replays=cap["replays"], graph_launches=cap["launches"],
                   b1_launches=launch_counts().get("conv2d_tile", 0) - before + sum(
                       cap["launches"][b].get("conv2d_tile", 0) * n
                       for b, n in cap["replays"].items()))
        if engine.leader:
            got = torch.from_numpy(np.stack([r.result for r in sorted(
                engine.finished, key=lambda r: r.rid)]))
            row["hashes"] = response_hashes(engine)
            row["max_abs_err"], row["err_over_bar"] = err_stats(got, untiled, **TOL_SERVE)
            row["finite"] = bool(torch.isfinite(got).all())
        out[label] = row
        del engine, arch, params
        torch.cuda.empty_cache()
    return out


def dist_rank(group, build_dir, fault, plans, elastic=None, extra=None) -> dict:
    """Phase 29, one rank (``parallel/dist.py:run_ranks``): phase 5's plan,
    then each plan of ``plans`` (label -> ``make_yolo_tiled_arch`` kwargs),
    on this rank's block of the 2x2 grid, trained TRAIN_STEPS steps from
    seed 0 through ``make_train_step`` as the launcher runs it.  Per plan:
    each step's param checksums, losses and event ms, the B1-B3 launches,
    the peak memory, the collectives recorded, and on rank 0 the final
    params and the step-1 gradients.  ``build_dir``: build DIST_COLD_LIBS
    there first, cold, and report each library's path and hash.
    ``fault="wrong_neighbour"``: train phase 5's plan and each plan of
    ``plans`` again, one step, with every row strip (or row hand-off) sent to (and
    taken from) the rank mirrored across the columns, and every hop past
    the neighbour block (pure1x4's hand-off on a one-row rank grid) landed
    one block short; every rank plans the same wrong hops, so their
    messages still pair.  A plan's "grid" names its tile grid (GRID
    otherwise); each run also keeps the rank grid and this rank's place in
    it.  ``elastic`` ({"root": a directory, "plant": bool}): then 29(d)'s
    runs (``elastic_rank``), and with "plant" their planted twin.
    ``extra``: then, under nccl, the captured step's runs (``capture_rank``
    in ``extra["root"]``), and the serve engines (``serve_rank`` of
    ``extra["serve"]``)."""
    import hashlib
    from pathlib import Path

    import torch

    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.tiling import Group
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import DistTileMesh, make_dist_tile_mesh
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.yolo import make_yolo_tiled_arch
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.parallel import dist as tdist
    from repro_torch.serve.exec_cache import kernel_launch_counts
    from repro_torch.train.trainer import make_train_step

    torch.backends.cudnn.allow_tf32 = False          # as phase 3 sets them
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = group.device
    out = {"rank": group.rank, "device": str(dev), "backend": group.backend}
    if build_dir is not None:
        _build.BUILD_DIR = Path(build_dir)
        t0 = time.perf_counter()
        libs = _build.build(DIST_COLD_LIBS)
        out["cold_build_s"] = time.perf_counter() - t0
        out["libs"] = {n: (str(p), hashlib.sha256(p.read_bytes()).hexdigest())
                       for n, p in libs.items()}
    mesh = make_dist_tile_mesh(*GRID, dev, group)
    pcfg = ParallelConfig(grad_accum=TRAIN_ACCUM)
    tcfg = TrainConfig(lr=TRAIN_LR, optimizer="sgd", warmup=0, steps=TRAIN_STEPS, seed=SEED)
    out.update(ranks=list(mesh.ranks), coord=list(mesh.coord), origin=list(mesh.origin))

    def drive(arch, steps=TRAIN_STEPS):
        step1 = {}

        def on_grads(step, loss, grads):
            if step == 0 and not step1 and group.rank == 0:
                step1["grads"] = [g.detach().cpu() for g in tree_leaves(grads)]

        make_batch = make_batch_fn(TRAIN_BATCH, INPUT_HW[0], arch.target_shape(TRAIN_BATCH),
                                   SEED, dev)
        init_state, step = make_train_step(arch, pcfg, tcfg, on_grads=on_grads)
        state = init_state(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        group.take_record()
        before = kernel_launch_counts()
        sums, losses, ms = [], [], []
        for s in range(steps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            state, m = step(state, make_batch(s))
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
            losses.append(float(m["loss"]))
            sums.append(state_checksums(state.params))
        return dict(checksums=sums, losses=losses, step_ms=ms,
                    launches=kernel_totals({k: v - before.get(k, 0)
                                            for k, v in kernel_launch_counts().items()}),
                    peak=torch.cuda.max_memory_allocated(dev), record=group.take_record(),
                    params=[t.cpu() for t in tree_leaves(state.params)] if group.rank == 0
                    else None, step1_grads=step1.get("grads"),
                    ranks=list(arch.mesh.ranks), coord=list(arch.mesh.coord))

    def arch_of(kw):
        kw = dict(kw)
        grid = kw.pop("grid", GRID)
        return make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=grid[0], m=grid[1],
                                    backend="cuda",
                                    mesh=make_dist_tile_mesh(*grid, dev, group), **kw)

    archs = {"phase5": arch_of(dict(groups=[Group(*g) for g in _HAND]))}
    archs.update({label: arch_of(kw) for label, kw in plans.items()})
    out["runs"], out["faults"] = {}, {}
    for label, arch in archs.items():
        out["runs"][label] = drive(arch)
        if fault == "wrong_neighbour":
            real, real_hop = DistTileMesh.neighbour, tdist._hop_start

            def mirrored(self, dim, step):
                r = real(self, dim, step)
                if r is None or dim != 0:
                    return r
                pr, pc = divmod(r, self.ranks[1])
                return pr * self.ranks[1] + (self.ranks[1] - 1 - pc)

            def one_block_short(x, dim, shift, mesh, span, tag):
                b = x.shape[dim]
                if abs(shift) > b:
                    shift -= b if shift > 0 else -b
                return real_hop(x, dim, shift, mesh, span, tag)

            DistTileMesh.neighbour, tdist._hop_start = mirrored, one_block_short
            try:
                out["faults"][label] = drive(arch, steps=1)
            finally:
                DistTileMesh.neighbour, tdist._hop_start = real, real_hop
    if elastic is not None:
        # 29(d): the elastic runs, after the plans, in the same processes
        t0 = time.perf_counter()
        out["elastic"] = elastic_rank(group, elastic["root"], False)
        if elastic["plant"]:
            out["elastic_planted"] = elastic_rank(group, elastic["root"], True)
        out["elastic_s"] = time.perf_counter() - t0
    if extra is not None:
        # 29(a)-(c): the captured step (nccl) and the serve engines, here too
        if group.backend == "nccl":
            out["capture"] = capture_rank(group, extra["root"], plans)
        t0 = time.perf_counter()
        out["serve"] = serve_rank(group, extra["serve"])
        out["serve_s"] = time.perf_counter() - t0
    return out


def dist_phase(dev, smi: str, train5: dict, hybrid13: dict, edge16: dict, ragged14: dict,
               pipe15: dict, elastic18: dict, cnn27: dict, el27: dict, serve17: dict,
               served: dict) -> tuple[dict, dict]:
    """Phase 29: phase 5's plan, then DIST_PLANS, over ``torch.distributed``
    ranks, one block of the tile grid a process (ROADMAP A.20.1, A.20.2's
    uniform plans, ragged partitions and pipeline tails).  The virtual
    mesh's runs of phase 5's plan and of the cluster's padded crossover
    twin (the checksums of its params after each step) come first; the
    other plans' virtual runs are phase 13's (``hybrid13``: its checksums,
    its torch-backend trainer in fp64 and its bars), phase 16's
    (``edge16``: the int8 run's checksums and step-1 grads, its none twin's
    step-1 grads), phase 14's (``ragged14``: the cluster's spec run, and
    the padded run whose trainer and bars the crossover twin is held to)
    and phase 15's (``pipe15``: pipe2x2's and pure1x4's).  Then

    (a) nccl at W = the cards: with one card, each plan's params after every
        step bitwise its virtual run's, and B1-B3 launches the code's count;
    (b) DIST_WORLD gloo ranks sharing the card, one tile each, each strip,
        gather, hand-off and sum staged through pinned host memory, started
        cold (each rank builds B1-B3 into one fresh directory at once; all
        must load the same libraries): the params after TRAIN_STEPS steps of
        every uncompressed plan held to its phase's fp32-trainer bars, the
        int8 plan's step-1 grads at CODEC_BAR to its virtual codec run,
        every rank's params equal, the wrong-neighbour fault's step-1
        gradients past their phase's step-1 bar on every plan (the int8
        plan's: CODEC_BAR); per rank and plan its
        peak memory, launches (the code's count for that rank: its shape
        classes, its stages), collectives (count and bytes equal to
        ``analysis/collectives.py:plan_collectives`` at the rank's place,
        the model the CPU tests hold to the reference's compiled step) and
        step ms (host-staged: not a result);
    (c) nccl at DIST_WORLD ranks, only where the machine has that many
        cards, held as (b);
    (d) elastic training in (a)'s and (b)'s processes, after their plans
        (``elastic_rank``; ``elastic18``: phase 18's drop and resume runs,
        their checksums and its trajectory bars): at one nccl rank every
        step's params and both last checkpoints bitwise phase 18's; on
        DIST_WORLD gloo ranks the drop leaves rank 3 idle while ranks 0-2
        train at 1x3, the 7-step update within phase 18(c)'s bars, every
        active rank's params equal, the planted restore past the bars;
        every rank's launches the code's count for its blocks, its
        driver's collectives ``driver_collectives``; the ``{"elastic29":
        ...}`` line;
    (e) the step captured on nccl ranks (ROADMAP A.20.3) in (a)'s and (c)'s
        processes (``capture_rank``, ``capture_held``; ``cnn27``, ``el27``:
        27(a)'s captured run's checksums a step, 27(b)'s last checkpoint's
        leaf hashes): 27(a)'s cell eager, captured and planted on the rank,
        and the launcher under 27(b)'s faults; at one rank bitwise 27(a)'s
        and 27(b)'s runs;
    (f) the serve engine on the ranks of (a), (b) and (c) (ROADMAP A.20.4;
        ``serve_rank``, ``serve_held``; ``serve17``: phase 17's captured
        virtual engines under ``SERVE29_CLOCK``; ``served``: phase 4's
        images, calibration batch and untiled responses): at one nccl rank
        every bucket captured and the responses phase 17's bit for bit; on
        ``DIST_WORLD`` gloo ranks the eager forward within ``TOL_SERVE`` of
        the untiled reference and a follower serving a stale batch past it;
        the batch log and every rank's collectives a dispatch against the
        model.

    Returns the B1-B3 launches of the correct runs on every rank, in all
    and by plan (29(d)'s under "elastic", (e)'s under "capture29", (f)'s
    under "serve29")."""
    import gc
    import hashlib
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from repro_torch.analysis.collectives import collective_stats, plan_collectives
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.tiling import Group
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.yolo import make_yolo_tiled_arch
    from repro_torch.kernels import _build
    from repro_torch.parallel.dist import run_ranks
    from repro_torch.train.trainer import make_train_step

    t_phase = time.perf_counter()
    groups = [Group(*g) for g in _HAND]
    pcfg = ParallelConfig(grad_accum=TRAIN_ACCUM)
    tcfg = TrainConfig(lr=TRAIN_LR, optimizer="sgd", warmup=0, steps=TRAIN_STEPS, seed=SEED)

    def arch_of(kw):
        kw = dict(kw)
        grid = kw.pop("grid", GRID)
        return make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=grid[0], m=grid[1],
                                    backend="cuda", device=dev, **kw)

    def virtual_run(kw) -> list:
        """The virtual mesh's params after each of TRAIN_STEPS steps."""
        arch = arch_of(kw)
        make_batch = make_batch_fn(TRAIN_BATCH, INPUT_HW[0], arch.target_shape(TRAIN_BATCH), SEED,
                                   dev)
        init_state, step = make_train_step(arch, pcfg, tcfg)
        state, sums = init_state(SEED), []
        for s in range(TRAIN_STEPS):
            state, _ = step(state, make_batch(s))
            sums.append(state_checksums(state.params))
        return sums

    all_plans = {"phase5": dict(groups=groups), **DIST_PLANS}
    plans = {label: arch_of(kw).plan for label, kw in all_plans.items()}
    virtual = {"phase5": virtual_run(all_plans["phase5"]),
               "hybrid_tpu": hybrid13["reference"]["checksums"],
               "edge_int8": edge16["int8"]["checksums"],
               "cluster_spec": ragged14["cluster_spec"]["reference"]["checksums"],
               "cluster_crossover_padded": virtual_run(DIST_PLANS["cluster_crossover_padded"]),
               "pipe2x2": pipe15["pipe2x2"]["reference"]["checksums"],
               "pure1x4": pipe15["pure1x4"]["reference"]["checksums"]}
    refs = {"phase5": train5["reference"], "hybrid_tpu": hybrid13["reference"],
            "cluster_spec": ragged14["cluster_spec"]["reference"],
            "cluster_crossover_padded": ragged14["cluster_padded"]["reference"],
            "pipe2x2": pipe15["pipe2x2"]["reference"], "pure1x4": pipe15["pure1x4"]["reference"]}

    def want_launches(label, run):
        """The code's B1-B3 launches of one rank's run of ``label``."""
        per_mb, _ = launches_per_batch(plans[label], TRAIN_BATCH // TRAIN_ACCUM,
                                       (tuple(run["ranks"]), tuple(run["coord"])))
        return {k: v * TRAIN_ACCUM * TRAIN_STEPS for k, v in per_mb.items()}

    for label, run in (("phase5", train5), ("hybrid_tpu", hybrid13),
                       ("cluster_spec", ragged14["cluster_spec"]),
                       ("pipe2x2", pipe15["pipe2x2"]), ("pure1x4", pipe15["pure1x4"])):
        want = want_launches(label, {"ranks": (1, 1), "coord": (0, 0)})
        check(want == run["launches"], f"{label} launched {run['launches']}, the code's count {want}")
    check(all(len(v) == TRAIN_STEPS for v in virtual.values()),
          f"an earlier phase kept no checksums of its virtual run: "
          f"{ {k: len(v) for k, v in virtual.items()} }")
    print(f"phase 29 plans: " + "; ".join(
        f"{label} grid {p.n}x{p.m} schedule {p.schedule} crossover {p.crossover} codec "
        f"{p.wire_codec} ragged {None if p.is_uniform else p.ragged_exec} stages {p.stages} "
        f"groups {[(g.start, g.end, g.mode) for g in p.groups]}" for label, p in plans.items()))
    gc.collect()
    torch.cuda.empty_cache()

    def held(cell, runs):
        """Checks and prints the runs of one cell, every plan; returns its
        rows and each plan's model of the collectives (by rank)."""
        rows, models = [], {}
        for label, plan in plans.items():
            models[label] = {}
            for r in runs:
                run = r["runs"][label]
                model = {k: [c * TRAIN_ACCUM * TRAIN_STEPS, b * TRAIN_ACCUM * TRAIN_STEPS]
                         for k, (c, b) in plan_collectives(
                             plan, TRAIN_BATCH // TRAIN_ACCUM, tuple(run["ranks"]),
                             tuple(run["coord"])).items()}
                models[label][r["rank"]] = model
                want = want_launches(label, run)
                st = collective_stats(run["record"])
                got = {k: [st.count[k], st.bytes_naive[k]] for k in st.count if k != "all-reduce"}
                row = {"rank": r["rank"], "plan": label, "device": r["device"],
                       "backend": r["backend"], "coord": run["coord"], "ranks": run["ranks"],
                       "peak_mem_bytes": run["peak"], "launches": run["launches"],
                       "collectives": st.count, "collective_bytes": st.bytes_naive,
                       "collective_ring_bytes": st.bytes_ring, "model": model,
                       "losses": run["losses"], "step_ms_cuda_events": run["step_ms"],
                       "step": ("eager (gloo: its collectives run on the host, no capture)"
                                if r["backend"] == "gloo" else
                                "eager (an on_grads observer; 29(e) captures the step)"),
                       "card": smi}
                rows.append(row)
                print(json.dumps({f"dist29{cell}_rank": row}))
                check(run["launches"] == want,
                      f"29({cell}) {label} rank {r['rank']} launches {run['launches']} != {want}")
                check(got == model, f"29({cell}) {label} rank {r['rank']} collectives {got} != "
                      f"the model's {model}")
                check(all(same_checksums(a, b) for a, b in zip(
                    run["checksums"], runs[0]["runs"][label]["checksums"])),
                      f"29({cell}) {label} rank {r['rank']}'s params differ from rank 0's")
        return rows, models

    def to_bar(cell, label, run):
        """The update error of ``run``'s params after TRAIN_STEPS steps over
        its phase's bar, per leaf -> (errs, losses rel err, the worst ratio)."""
        ref = refs[label]
        names = ref["names"]
        errs = [float((a.cpu().double() - b.double() - u).abs().max() / u.abs().max())
                for a, b, u in zip(run["params"], ref["p0"], ref["upd64"])]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], ref["losses64"]))
        worst = max(range(len(names)), key=lambda i: errs[i] / ref["bars"][i])
        ratio = errs[worst] / ref["bars"][worst]
        print(f"29({cell}) {label}: params after {TRAIN_STEPS} steps vs the torch-backend "
              f"trainer in fp64: update err max {max(errs):.2e}; nearest its bar: "
              f"{names[worst]} {errs[worst]:.2e}, {ratio:.3f} of it; losses rel err "
              f"{loss_rel:.2e}")
        return errs, loss_rel, ratio

    def grads_to_bar(cell, label, run):
        """The step-1 gradients of ``run`` against its phase's fp64 ones,
        normwise per leaf over the step-1 bars: the worst ratio."""
        ref = refs[label]
        ratios = {n: float((g.double() - w).abs().max() / w.abs().max()) / bar
                  for n, g, w, bar in zip(ref["names"], run["step1_grads"], ref["grads64"],
                                          ref["step1_bars"])}
        worst = max(ratios, key=ratios.get)
        print(f"29({cell}) {label}: step-1 grads vs the fp64 reference's, normwise over the "
              f"step-1 bar: up to {ratios[worst]:.3g} ({worst})")
        return ratios[worst]

    def codec_grads(cell, run):
        """The int8 plan's step-1 grads against phase 16's virtual int8 run
        at CODEC_BAR x the codec's effect there (its none twin), floored at
        fp32 (``normwise_codec``): the worst err / bar over the leaves."""
        seen = {}
        for n, g, vc, vn in zip(train5["reference"]["names"], run["step1_grads"],
                                edge16["int8"]["step1_grads"], edge16["none"]["step1_grads"]):
            err, bar = normwise_codec(g, vc, vn, CODEC_BAR)
            seen[n] = (err / bar, err, bar, CODEC_BAR * float((vc.double() - vn.double()).norm()))
        worst = max(seen, key=lambda n: seen[n][0])
        ratio, err, bar, term = seen[worst]
        print(f"29({cell}) edge_int8: step-1 grads vs the virtual int8 run, err / bar (bar "
              f"{CODEC_BAR} x the codec's effect, floored at fp32) up to "
              f"{ratio:.3g} ({worst}: err {err:.3g}, bar {bar:.3g}, its codec term {term:.3g})")
        return ratio

    def to_bars(cell, runs):
        """Each plan's check against its virtual run's bars; -> summary."""
        res = {}
        for label in plans:
            run = runs[0]["runs"][label]
            if label in refs:
                _, loss_rel, ratio = to_bar(cell, label, run)
                check(ratio <= 1.0 and loss_rel <= TRAIN_LOSS_RTOL,
                      f"29({cell}) {label} past its phase's bar: {ratio}, losses {loss_rel}")
                res[label] = {"update_err_over_bar": ratio, "loss_rel_err_vs_fp64": loss_rel}
            else:
                ratio = codec_grads(cell, run)
                check(ratio <= 1.0, f"29({cell}) {label} step-1 grads past CODEC_BAR: {ratio}")
                res[label] = {"step1_grads_err_over_codec_bar": ratio}
        return res

    out = {"card": smi, "plans": {label: {"schedule": p.schedule, "crossover": p.crossover,
                                          "codec": p.wire_codec,
                                          "groups": [[g.start, g.end, g.mode] for g in p.groups]}
                                  for label, p in plans.items()},
           "steps": TRAIN_STEPS, "global_batch": TRAIN_BATCH, "microbatches": TRAIN_ACCUM}
    kernels = ("conv2d_tile", "conv2d_dgrad_tile", "conv2d_wgrad_tile")
    by_plan = {label: {k: 0 for k in kernels} for label in plans}

    def count(runs):
        for r in runs:
            for label, run in r["runs"].items():
                by_plan[label] = {k: v + run["launches"][k] for k, v in by_plan[label].items()}

    # 29(d)'s plans: the padded cluster, the survivors' after the drop
    from repro_torch.core.grouping import parse_cluster_spec
    from repro_torch.launch.train import make_replan
    from repro_torch.runtime.faults import ClusterChange

    arch_d = arch_of(dict(_CLUSTER_KW, groups="auto", ragged_exec="padded"))
    replan_d = make_replan(arch_d, parse_cluster_spec(_CLUSTER_KW["hw"], *GRID), "pi3-core",
                           TRAIN_BATCH, pcfg, tcfg)
    with contextlib.redirect_stdout(io.StringIO()):
        replan_d(ClusterChange("drop", "jetson", 2))
    plans_d = (arch_d.plan, replan_d.live["plan"])
    elastic_root = tempfile.mkdtemp(prefix="chip_smoke_elastic29_")
    del arch_d, replan_d
    # (e)-(f): the captured step's checkpoints, phase 4's requests for the
    # engines, read by the ranks from files
    import numpy as np

    for key in ("images", "calib", "untiled"):
        np.save(os.path.join(elastic_root, f"{key}.npy"), served[key])

    def extra(cell, fault):
        return {"root": os.path.join(elastic_root, f"capture_{cell}"),
                "serve": {k: os.path.join(elastic_root, f"{k}.npy")
                          for k in ("images", "calib", "untiled")} | {"fault": fault}}

    # (a) nccl at W = the cards
    world_a = torch.cuda.device_count()
    t0 = time.perf_counter()
    runs_a = run_ranks(dist_rank, world_a, "cuda", "nccl",
                       args=(None, None, DIST_PLANS,
                             {"root": os.path.join(elastic_root, "a"), "plant": False},
                             extra("a", False)),
                       timeout=900)
    a_s = time.perf_counter() - t0
    rows_a, models_a = held("a", runs_a)
    bars_a = to_bars("a", runs_a)
    bitwise = {label: [same_checksums(a, b) for a, b in zip(runs_a[0]["runs"][label]["checksums"],
                                                            virtual[label])]
               for label in plans}
    print(f"29(a) nccl, {world_a} rank(s): params bitwise the virtual mesh's after each step "
          f"{bitwise}; {a_s:.1f} s with the spawn")
    if world_a == 1:
        check(all(all(v) for v in bitwise.values()),
              f"29(a): one nccl rank's params differ from the virtual mesh's: {bitwise}")
    out["a"] = {"world": world_a, "backend": "nccl", "bitwise_virtual_each_step": bitwise,
                "bars": bars_a, "collectives_model": models_a, "seconds": a_s, "ranks": rows_a}
    count(runs_a)

    # (b) DIST_WORLD gloo ranks sharing the card, B3 cold
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cold_build_") as cold:
        for name in DIST_WARM_LIBS:
            warm = _build.library_path(name)
            shutil.copy2(warm, Path(cold) / warm.name)
        runs_b = run_ranks(dist_rank, DIST_WORLD, "cuda", "gloo",
                           args=(cold, "wrong_neighbour", DIST_PLANS,
                                 {"root": os.path.join(elastic_root, "b"), "plant": True},
                                 extra("b", True)),
                           timeout=900)
        # nvcc's output differs from build to build, so each rank may have
        # loaded its own: all must name one path, and the file left there
        # must be one rank's whole build (the rename is atomic)
        paths = [{n: p for n, (p, _) in r["libs"].items()} for r in runs_b]
        check(all(p == paths[0] for p in paths)
              and all(p.startswith(cold) for p in paths[0].values()),
              f"29(b): the cold ranks loaded libraries of different names: {paths}")
        builds = {n: {r["libs"][n][1] for r in runs_b} for n in DIST_COLD_LIBS}
        final = {n: hashlib.sha256(Path(p).read_bytes()).hexdigest()
                 for n, p in paths[0].items()}
        check(all(final[n] in builds[n] for n in DIST_COLD_LIBS),
              f"29(b): a library left in place is no rank's build: {final} {builds}")
        libs = [r["libs"] for r in runs_b]
    b_s = time.perf_counter() - t0
    rows_b, models_b = held("b", runs_b)
    bars_b = to_bars("b", runs_b)
    faults = {}
    for label, run in runs_b[0]["faults"].items():
        if label in refs:
            faults[label] = grads_to_bar("b, wrong neighbour", label, run)
        else:
            faults[label] = codec_grads("b, wrong neighbour", run)
        check(faults[label] > 1.0, f"29(b): the wrong-neighbour fault passed {label}'s bar "
              f"({faults[label]})")
    check(set(faults) == set(plans), f"29(b): faults run on {sorted(faults)}")
    print(f"29(b) gloo, {DIST_WORLD} ranks on {sorted({r['device'] for r in runs_b})}: cold "
          f"builds {[round(r['cold_build_s'], 1) for r in runs_b]} s, one path each "
          f"{ {n: p.rsplit('/', 1)[-1] for n, (p, _) in libs[0].items()} } (distinct builds "
          f"seen { {n: len(v) for n, v in builds.items()} }); bars {bars_b}; the wrong-neighbour "
          f"fault {faults} of the bar; {b_s:.1f} s with the spawn")
    out["b"] = {"world": DIST_WORLD, "backend": "gloo", "staged_through_host": True,
                "bars": bars_b, "wrong_neighbour_err_over_bar": faults,
                "cold_build_s": [r["cold_build_s"] for r in runs_b],
                "libraries": {n: p.rsplit("/", 1)[-1] for n, (p, _) in libs[0].items()},
                "distinct_builds_seen": {n: len(v) for n, v in builds.items()},
                "collectives_model": models_b, "seconds": b_s, "ranks": rows_b}
    count(runs_b)

    # (d) elastic training on the ranks of (a) and (b)
    by_plan["elastic"] = {k: 0 for k in kernels}
    el = {"card": smi, "faults": ELASTIC29_FAULTS, "ckpt_every": ELASTIC29_CKPT_EVERY,
          "a": elastic_held("a", runs_a, plans_d, elastic18, by_plan["elastic"], smi)}
    el["b"] = elastic_held("b", runs_b, plans_d, elastic18, by_plan["elastic"], smi)

    # (e) the captured step on the nccl rank; (f) the serve engines
    by_plan["capture29"] = {k: 0 for k in kernels}
    by_plan["serve29"] = {k: 0 for k in kernels}
    cap29 = {"a": capture_held("a", runs_a, cnn27, el27, plans, by_plan["capture29"], smi)}
    serve29 = {"a": serve_held("a", runs_a, serve17, by_plan["serve29"], smi),
               "b": serve_held("b", runs_b, serve17, by_plan["serve29"], smi)}

    # (c) nccl at DIST_WORLD ranks, where there are that many cards
    if torch.cuda.device_count() >= DIST_WORLD:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_elastic29c_") as root_c:
            runs_c = run_ranks(dist_rank, DIST_WORLD, "cuda", "nccl",
                               args=(None, None, DIST_PLANS, {"root": root_c, "plant": False},
                                     extra("c", False)),
                               timeout=900)
        rows_c, _ = held("c", runs_c)
        out["c"] = {"world": DIST_WORLD, "backend": "nccl", "bars": to_bars("c", runs_c),
                    "ranks": rows_c}
        el["c"] = elastic_held("c", runs_c, plans_d, elastic18, by_plan["elastic"], smi)
        cap29["c"] = capture_held("c", runs_c, cnn27, el27, plans, by_plan["capture29"], smi)
        serve29["c"] = serve_held("c", runs_c, serve17, by_plan["serve29"], smi)
        count(runs_c)
    else:
        print(f"29(c) not run: {torch.cuda.device_count()} card(s), nccl needs {DIST_WORLD}")
        out["c"] = None
    shutil.rmtree(elastic_root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    launched = {k: sum(p[k] for p in by_plan.values()) for k in kernels}
    out["launches"], out["launches_by_plan"] = launched, by_plan
    el["launches"] = by_plan["elastic"]
    print(json.dumps({"elastic29": el}))
    print(json.dumps({"capture29": dict(cap29, launches=by_plan["capture29"], card=smi,
                                        seconds=[r["capture"]["s"] for r in runs_a])}))
    print(json.dumps({"serve29": dict(serve29, launches=by_plan["serve29"], card=smi,
                                      seconds={"a": [r["serve_s"] for r in runs_a],
                                               "b": [r["serve_s"] for r in runs_b]})}))
    print(json.dumps({"dist": out}))
    return launched, by_plan


def capture_held(cell: str, runs: list, cnn27: dict, el27: dict, virtual_plans: dict,
                 launched: dict, smi: str) -> dict:
    """Phase 29(a)(i)-(ii)'s checks of one nccl cell's ranks
    (``capture_rank``): 27(a)'s cell captured on the ranks bitwise their
    eager run at every step, and at one rank bitwise 27(a)'s captured
    virtual run too; the planted stale counter caught; the graph's B1-B3
    launches the code's count for the rank's block, the warm steps and
    replays, every launch executed; the captured run's record equal to the
    eager run's (replays included), its permutes and gathers
    ``plan_collectives`` x microbatches x steps.  The launcher under 27(b)'s
    faults on the ranks: two graphs, a restart and a replan, and at one rank
    its last checkpoint 27(b)'s byte for byte.  On more ranks (29(c)) each
    plan's captured step bitwise its eager run on the ranks.  Adds the
    executed launches to ``launched``; prints a ``capture29<cell>_rank``
    line a rank; -> the cell's summary."""
    from repro_torch.analysis.collectives import collective_stats, plan_collectives
    from repro_torch.serve.exec_cache import WARM_RUNS

    world = len(runs)
    rows = []
    plan = virtual_plans["phase5"]
    mb = TRAIN_BATCH // TRAIN_ACCUM
    for r in runs:
        cap = r["capture"]
        cellr = cap["cell"]
        eager, graph, planted = cellr["eager"], cellr["captured"], cellr["planted"]
        rank_at = (tuple(r["ranks"]), tuple(r["coord"]))
        per_mb, _ = launches_per_batch(plan, mb, rank_at)
        per_step = {k: v * TRAIN_ACCUM for k, v in per_mb.items()}
        bitwise = [same_checksums(a, b) for a, b in zip(graph["checksums"], eager["checksums"])]
        caught = not all(same_checksums(a, b)
                         for a, b in zip(planted["checksums"], eager["checksums"]))
        check(all(bitwise) and len(bitwise) == CAPTURE_CNN_STEPS,
              f"29({cell}) rank {r['rank']}: the captured step differs from the eager one: {bitwise}")
        check(caught, f"29({cell}) rank {r['rank']}: a replay with a stale step counter passed")
        check(graph["graph"] == per_step and graph["warm"] == WARM_RUNS
              and graph["replays"] == CAPTURE_CNN_STEPS - WARM_RUNS,
              f"29({cell}) rank {r['rank']}: graph launches {graph['graph']} (the code's "
              f"{per_step}), {graph['warm']} warm steps, {graph['replays']} replays")
        for run in (eager, graph, planted):
            check(run["launched"] == {k: v * CAPTURE_CNN_STEPS for k, v in per_step.items()},
                  f"29({cell}) rank {r['rank']}: launches {run['launched']} != the code's "
                  f"{per_step} x {CAPTURE_CNN_STEPS}")
            for k in launched:
                launched[k] += run["launched"][k]
        model = {k: [c * TRAIN_ACCUM * CAPTURE_CNN_STEPS, b * TRAIN_ACCUM * CAPTURE_CNN_STEPS]
                 for k, (c, b) in plan_collectives(plan, mb, *rank_at).items()}
        st = collective_stats(graph["record"])
        got = {k: [st.count[k], st.bytes_naive[k]] for k in st.count if k != "all-reduce"}
        check(graph["record"] == eager["record"] and got == model,
              f"29({cell}) rank {r['rank']}: the captured run's record differs from the eager "
              f"run's, or its exchanges {got} from the model's {model}")
        la = cap["launcher"]
        text = la["text"]
        check(la["rc"] == 0 and la["graphs"] == 2 and "captured=True" in text
              and "restarts=1 replans=1" in text and "replan (drop:3)" in text,
              f"29({cell}) rank {r['rank']}: the launcher under {ELASTIC_CAPTURE_FAULTS}: rc "
              f"{la['rc']}, {la['graphs']} graphs")
        for k in launched:
            launched[k] += la["launched"][k]
        row = {"rank": r["rank"], "coord": r["coord"], "ranks": r["ranks"],
               "bitwise_eager_each_step": bitwise, "planted_stale_counter_caught": caught,
               "graph_launches": graph["graph"], "replays": graph["replays"],
               "step_ms_eager": eager["ms"], "step_ms_captured": graph["ms"],
               "step_ms_eager_steady_median": statistics.median(eager["ms"][WARM_RUNS:]),
               "step_ms_replay_median": statistics.median(graph["ms"][WARM_RUNS + 1:]),
               "pool_bytes": graph["pool"], "peak_mem_bytes_eager": eager["peak"],
               "peak_mem_bytes_captured": graph["peak"],
               "graph_collectives": collective_stats(graph["graph_record"]).count,
               "run_collectives": st.count, "launcher_graphs": la["graphs"],
               "launcher_replays": la["replays"], "s": cap["s"], "card": smi}
        if "plans" in cap:
            row["plans_bitwise_eager"] = {}
            for label, run in cap["plans"].items():
                same = [same_checksums(a, b) for a, b in zip(
                    run["checksums"], r["runs"][label]["checksums"])]
                row["plans_bitwise_eager"][label] = same
                check(all(same), f"29({cell}) {label} rank {r['rank']}: captured != eager {same}")
                for k in launched:
                    launched[k] += run["launched"][k]
        rows.append(row)
        print(json.dumps({f"capture29{cell}_rank": row}))
    out = {"world": world, "ranks": rows}
    if world == 1:
        virtual = [same_checksums(a, b) for a, b in zip(
            runs[0]["capture"]["cell"]["captured"]["checksums"], cnn27["checksums"])]
        ckpt = runs[0]["capture"]["launcher"]["ckpt"] == el27["ckpt"]
        print(f"29({cell}) one nccl rank: 27(a)'s cell captured on the rank bitwise its eager "
              f"run {rows[0]['bitwise_eager_each_step']} and 27(a)'s captured virtual run "
              f"{virtual}; replay {rows[0]['step_ms_replay_median']:.2f} ms, eager "
              f"{rows[0]['step_ms_eager_steady_median']:.2f} ms; the launcher's last checkpoint "
              f"27(b)'s byte for byte: {ckpt}")
        check(all(virtual) and len(virtual) == CAPTURE_CNN_STEPS,
              f"29({cell}): the rank's captured step differs from 27(a)'s: {virtual}")
        check(ckpt, f"29({cell}): the rank's launcher under {ELASTIC_CAPTURE_FAULTS} left "
              f"another last checkpoint than 27(b)'s")
        out.update(bitwise_27a_each_step=virtual, launcher_ckpt_bitwise_27b=ckpt)
    return out


def serve_held(cell: str, runs: list, serve17: dict, launched: dict, smi: str) -> dict:
    """Phase 29's serve checks of one cell's ranks (``serve_rank``): rank
    0's batch log phase 17's under the same clock, every follower serving
    every dispatch, every rank's collectives of the drive
    ``plan_collectives(forward_only=True)`` at its place per dispatch plus
    ``dispatch_collectives``, its B1 launches the code's count per dispatch
    for its block; under nccl every bucket captured, at one rank the
    responses phase 17's captured virtual engine's bit for bit and the
    graph launches x replays phase 17's; on more ranks the responses
    within ``TOL_SERVE`` of the untiled reference, and the planted stale
    batch past it.  Adds the launches to ``launched``; prints a
    ``serve29<cell>_rank`` line per rank and plan; -> the cell's summary."""
    from repro_torch.analysis.collectives import (
        collective_stats,
        dispatch_collectives,
        plan_collectives,
        split_record,
    )
    from repro_torch.core.tiling import Group
    from repro_torch.models.yolo import make_yolo_tiled_arch

    world, backend = len(runs), runs[0]["backend"]
    image_bytes = 4 * INPUT_HW[0] * INPUT_HW[1] * 3
    out = {"world": world, "backend": backend, "plans": {}}
    for name in SERVE29_PLANS:
        grid, kw, _ = CAPTURE_PLANS_416[name]
        if not isinstance(kw["groups"], str):
            kw = dict(kw, groups=[Group(*g) for g in kw["groups"]])
        plan = make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=grid[0], m=grid[1],
                                    backend="cuda", device="cpu", **kw).serve_plan()
        lead = runs[0]["serve"][name]
        log = lead["log"]
        check(log == serve17[name]["log"], f"29({cell}) {name}: batch log {log} != phase 17's "
              f"{serve17[name]['log']}")
        check(lead["finite"], f"29({cell}) {name}: non-finite responses")
        for r in runs:
            row = r["serve"][name]
            rank_at = (tuple(row["ranks"]), tuple(row["coord"]))
            steps, roles = split_record(row["record"])
            st = collective_stats(steps)
            got = {k: [st.count[k], st.bytes_naive[k]] for k in st.count}
            model, b1 = {}, 0
            for _, bucket, _ in log:
                for k, (c, b) in plan_collectives(plan, bucket, *rank_at,
                                                  forward_only=True).items():
                    w = model.setdefault(k, [0, 0])
                    w[0], w[1] = w[0] + c, w[1] + b
                b1 += launches_per_batch(plan, bucket, rank_at)[0]["conv2d_tile"]
            want_roles = dispatch_collectives([b for _, b, _ in log], image_bytes)
            check(got == model and roles == want_roles,
                  f"29({cell}) {name} rank {r['rank']}: the drive's collectives {got} {roles} != "
                  f"the model's {model} {want_roles}")
            check(row["b1_launches"] == b1, f"29({cell}) {name} rank {r['rank']}: B1 launches "
                  f"{row['b1_launches']} != the code's {b1}")
            check(row["mode"] == ("cuda graphs" if backend == "nccl" else "eager: gloo"),
                  f"29({cell}) {name} rank {r['rank']}: serves by {row['mode']}")
            if r["rank"]:
                check(row["followed"] == len(log), f"29({cell}) {name} rank {r['rank']} "
                      f"followed {row['followed']} of {len(log)} dispatches")
            launched["conv2d_tile"] += row["b1_launches"]
            line = {k: v for k, v in row.items() if k not in ("record", "hashes", "log")}
            line.update(rank=r["rank"], backend=backend, collectives=st.count,
                        collective_bytes=st.bytes_naive, collectives_by_role=roles,
                        dispatches=len(log), card=smi)
            print(json.dumps({f"serve29{cell}_rank": line}, default=str))
        res = {"log": log, "err_over_bar": lead["err_over_bar"], "max_abs_err": lead["max_abs_err"],
               "warmup_s": [r["serve"][name]["warmup_s"] for r in runs],
               "drive_s": [r["serve"][name]["drive_s"] for r in runs]}
        if world == 1:
            same = lead["hashes"] == serve17[name]["hashes"]
            res.update(bitwise_phase17=same, b1_launches=lead["b1_launches"],
                       b1_launches_phase17=serve17[name]["b1_launches"])
            check(same, f"29({cell}) {name}: the rank's responses differ from phase 17's captured "
                  f"virtual engine's")
            check(lead["b1_launches"] == serve17[name]["b1_launches"],
                  f"29({cell}) {name}: B1 launches {lead['b1_launches']} != phase 17's "
                  f"{serve17[name]['b1_launches']}")
        else:
            check(lead["err_over_bar"] <= 1.0, f"29({cell}) {name}: responses "
                  f"{lead['err_over_bar']} of the serve bar from the untiled reference")
        print(f"29({cell}) serve {name} on {world} {backend} rank(s): {len(log)} dispatches "
              f"{[b for _, b, _ in log]}, responses {lead['err_over_bar']:.3g} of the serve bar"
              + (f", bitwise phase 17's: {res['bitwise_phase17']}" if world == 1 else ""))
        out["plans"][name] = res
    if "fault" in runs[0]["serve"]:
        f = runs[0]["serve"]["fault"]
        name = SERVE29_PLANS[0]
        check(f["log"] == runs[0]["serve"][name]["log"],
              f"29({cell}) planted: the batch log {f['log']} changed")
        print(f"29({cell}) planted: rank {world - 1} serving a stale batch: responses "
              f"{f['err_over_bar']:.3g} of the serve bar")
        check(f["err_over_bar"] > 1.0, f"29({cell}): a follower serving a stale batch passed "
              f"the serve bar ({f['err_over_bar']})")
        for r in runs:
            launched["conv2d_tile"] += r["serve"]["fault"]["b1_launches"]
        out["planted_stale_batch_over_bar"] = f["err_over_bar"]
    return out


def elastic_held(cell: str, runs: list, plans_d: tuple, elastic18: dict, launched: dict,
                 smi: str) -> dict:
    """Phase 29(d)'s checks of one cell's ranks (``elastic_rank``'s runs):
    the reports, the idle rank, the launches and the driver's collectives
    of every rank; at one rank every step's params and both last
    checkpoints bitwise phase 18's; on more, the 7-step update against
    phase 18(c)'s bars and the planted restore past them.  Adds the
    launches to ``launched``; -> the cell's summary."""
    from repro_torch.parallel.dist import rank_grid, survivors

    plan0, plan1 = plans_d
    world = len(runs)
    w1 = survivors(plan1.n, plan1.m, world)
    ranks0 = rank_grid(plan0.n, plan0.m, world)
    ranks1 = rank_grid(plan1.n, plan1.m, w1)
    per_mb = TRAIN_BATCH // TRAIN_ACCUM

    def want(rank, segs):
        """The code's B1-B3 launches of ``rank`` over ``segs`` ((plan, rank
        grid, steps) where the rank is active)."""
        got = dict.fromkeys(("conv2d_tile", "conv2d_dgrad_tile", "conv2d_wgrad_tile"), 0)
        for plan, rg, steps in segs:
            if rank < rg[0] * rg[1] and steps:
                counts, _ = launches_per_batch(plan, per_mb, (rg, divmod(rank, rg[1])))
                for k, v in counts.items():
                    got[k] += v * TRAIN_ACCUM * steps
        return got

    rows = []
    for r in runs:
        rank = r["rank"]
        for label in ("elastic", "elastic_planted"):
            if label not in r:
                continue
            drop, back = r[label]["drop"], r[label]["resume"]
            rep = drop["report"]
            active = rank < w1
            # steps 0-1 on the cluster plan; after the drop 2 and, past the
            # failed step 3's restore of step 1, 2-4 again on the survivors'
            check(rep["replans"] == 1 and rep["restarts"] == (1 if active else 0)
                  and rep["steps_done"] == (6 if active else 2),
                  f"29({cell}) {label} rank {rank}: the drop run's report {rep}")
            check(drop["active_after_replan"] == w1,
                  f"29({cell}) rank {rank}: {drop['active_after_replan']} active after the drop, "
                  f"not {w1}")
            check(back["report"]["resumed_step"] == 4 and back["report"]["steps_done"] == 2,
                  f"29({cell}) {label} rank {rank}: the resume's report {back['report']}")
            if label == "elastic_planted":
                continue        # its other ranks replay from their own, later state
            check(sorted(drop["checksums"]) == ([1, 2, 3, 4, 5] if active else [1, 2]),
                  f"29({cell}) rank {rank}: steps {sorted(drop['checksums'])}")
            got = {k: drop["launches"].get(k, 0) + back["launches"].get(k, 0) for k in launched}
            exp = want(rank, ((plan0, ranks0, 2), (plan1, ranks1, 4 if active else 0),
                              (plan0, ranks0, 2)))
            check(got == exp, f"29({cell}) rank {rank}: elastic launches {got} != the code's {exp}")
            for k in launched:
                launched[k] += got[k]
            for run, key in ((drop, "drop"), (back, "resume")):
                check(run["roles"] == r[label]["roles_model"][key],
                      f"29({cell}) rank {rank} {key}: the driver's collectives {run['roles']} != "
                      f"the model's {r[label]['roles_model'][key]}")
            rows.append({"rank": rank, "active_after_drop": active,
                         "peak_before_replan_bytes": drop["peak_before_replan"],
                         "peak_after_replan_bytes": drop["peak"],
                         "peak_resume_bytes": back["peak"], "restarts": rep["restarts"],
                         "replans": rep["replans"], "replan_ms": drop["replan_ms"],
                         "restore_read_ms": drop["restore_read_ms"] + back["restore_read_ms"],
                         "restore_broadcast_ms": drop["restore_broadcast_ms"]
                         + back["restore_broadcast_ms"],
                         "first_step_after_replan_ms": (drop["ms_after_replan"] or [None])[0],
                         "step_ms": drop["ms"], "step_ms_after_replan": drop["ms_after_replan"],
                         "step_ms_resume": back["ms"], "launches": got,
                         "collectives_by_role": {"drop": drop["roles"], "resume": back["roles"]}})
    # every active rank holds rank 0's params after every step
    for r in runs[1:]:
        for key in ("drop", "resume"):
            mine, zero = r["elastic"][key]["checksums"], runs[0]["elastic"][key]["checksums"]
            check(all(same_checksums(v, zero[s]) for s, v in mine.items()),
                  f"29({cell}) rank {r['rank']}'s {key} params differ from rank 0's")
    out = {"world": world, "survivors": w1, "ranks": rows,
           "seconds": [r["elastic_s"] for r in runs]}
    e0 = runs[0]["elastic"]
    if world == 1:
        bitwise = {key: {s: same_checksums(v, elastic18[key]["checksums"][s])
                         for s, v in e0[key]["checksums"].items()} for key in ("drop", "resume")}
        ckpts = {key: same_checksums(e0[key]["ckpt"], elastic18[key]["ckpt"])
                 for key in ("drop", "resume")}
        print(f"29({cell}) elastic, one rank: params after every step bitwise phase 18's "
              f"{bitwise}; last checkpoints {ckpts}")
        check(all(all(v.values()) for v in bitwise.values()) and all(ckpts.values()),
              f"29({cell}): one rank's elastic runs differ from phase 18's: {bitwise} {ckpts}")
        out.update(bitwise_phase18_each_step=bitwise, bitwise_phase18_ckpt=ckpts)
    else:
        bar = elastic18["bar"]

        def over(params):
            errs = [float((a.double() - b.double() - u).abs().max() / u.abs().max())
                    for a, b, u in zip(params, bar["p0"], bar["upd64"])]
            worst = max(range(len(errs)), key=lambda i: errs[i] / bar["bars"][i])
            return errs[worst] / bar["bars"][worst], bar["names"][worst], max(errs)

        ratio, name, err = over(e0["resume"]["params"])
        line = {"update_err_max": err, "nearest": name, "nearest_over_bar": ratio}
        print(f"29({cell}) elastic, {world} ranks ({w1} after the drop): the {ELASTIC_STEPS}-step "
              f"update against the untiled fp64 trainer: err max {err:.2e}, nearest its bar "
              f"{name} at {ratio:.3f} of it (phase 18's: {max(bar['err']):.2e})")
        check(ratio <= 1.0, f"29({cell}) elastic past phase 18(c)'s bar: {ratio} ({name})")
        if "elastic_planted" in runs[0]:
            p_ratio, p_name, _ = over(runs[0]["elastic_planted"]["resume"]["params"])
            print(f"29({cell}) planted: a restore the other ranks skip {p_ratio:.1f}x its bar "
                  f"({p_name})")
            check(p_ratio > 1.0, f"29({cell}): a restore the other ranks skip passed the bar "
                  f"({p_ratio})")
            line["planted_restore_skipped_over_bar"] = p_ratio
        out["trajectory"] = line
    for row in rows:
        print(json.dumps({f"elastic29{cell}_rank": dict(row, card=smi)}))
    return out


def dryrun_cell(run: LMRun, dev, depth=None, accum=None) -> tuple:
    """The dry run of ``run``'s training cell - its config cut to ``depth``
    (default ``run.depth``) layers, its batch, its microbatches (or
    ``accum``) and optimizer, remat "full", bf16 - on
    ``make_local_mesh(dev)``: ``lower_train`` and
    ``_compile_stats`` under the counting stub (the step traced on CPU fake
    tensors: nothing allocated, nothing launched), the flash kernel's terms
    added back, the roofline on ``H100``.  Returns the lowering and a row."""
    from repro_torch.analysis.roofline import (count_params_cfg, embed_param_count,
                                               flash_attention_terms, model_flops,
                                               terms_from_counts)
    from repro_torch.configs.base import ParallelConfig, ShapeConfig, TrainConfig
    from repro_torch.launch.dryrun import _compile_stats, lower_train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.attention import attention_impl
    from repro_torch.models.registry import cell_supported, load_config

    cfg = dataclasses.replace(load_config(run.arch), n_layers=depth or run.depth)
    shape = ShapeConfig("card", run.seq, run.batch, "train")
    pcfg = ParallelConfig(grad_accum=accum or run.accum, remat="full")
    tcfg = TrainConfig(warmup=CAPTURE_WARMUP, steps=run.steps, seed=SEED,
                       optimizer=run.optimizer)
    mesh = make_local_mesh(device=dev)
    n_dev = math.prod(mesh.shape.values())
    t0 = time.monotonic()
    with attention_impl("stub"):
        low = lower_train(cfg, shape, mesh, unroll=False, pcfg=pcfg, tcfg=tcfg)
        stats = _compile_stats(low)
    fa_fl, fa_by = flash_attention_terms(cfg, shape, remat=True)
    flops, nbytes = stats["flops"] + fa_fl / n_dev, stats["bytes"] + fa_by / n_dev
    terms = terms_from_counts(flops, nbytes, 0.0, H100)
    _, active = count_params_cfg(low.args[0].params, cfg)
    mf = model_flops(cfg, shape, active, embed_params=embed_param_count(cfg))
    row = {"cell": run.key, "arch": cfg.name, "layers": cfg.n_layers,
           "microbatches": pcfg.grad_accum,
           "supported": cell_supported(cfg, shape)[0], "devices": n_dev,
           "flops_per_device": flops, "bytes_per_device": nbytes,
           "argument_bytes": stats["mem"]["argument_bytes"],
           "hbm_ok": bool(stats["mem"]["argument_bytes"] <= H100.hbm_bytes),
           "compute_s": terms.compute_s, "memory_s": terms.memory_s,
           "dominant": terms.dominant, "bound_s": terms.bound_s, "model_flops": mf,
           "trace_s": stats["compile_s"], "cell_s": time.monotonic() - t0}
    return low, row


def dryrun_phase(dev, smi: str, qwen: dict) -> dict:
    """Phase 28: the dry run (``launch/dryrun.py``) held against the card.
    (a) Phase 27(c)'s Qwen2-7B cell (``qwen``: phase 7's result, at the
    depth its captured step ran): the predicted argument bytes must equal
    the captured step's live state plus its batch, leaf by leaf, and a dry
    run that leaves out the optimizer moments must fail that equality; the
    predicted bound and the step's share of ``H100.peak_flops`` are printed
    beside the measured replayed step, the capture and the graph's pool
    (capture stands in for ``compile_s``, the pool for ``temp_bytes``).
    (b) The training cells of phases 7, 10 and 20-24 (the whole grid,
    ``dryrun --all --mesh single --no-rates``, traces for longer than this
    phase may take), each traced with its global batch as one microbatch:
    the FLOPs and argument bytes of its microbatched step in half the
    trace.  One line each - supported, FLOPs and argument bytes a device,
    ``hbm_ok``, the dominant term."""
    from repro_torch.launch.dryrun import argument_bytes

    t0 = time.perf_counter()
    cap = qwen["capture"]
    low, row = dryrun_cell(QWEN_RUN, dev, cap["layers"])
    predicted, live = argument_bytes(low), cap["live_bytes"]
    diff = sorted(k for k in set(predicted) | set(live) if predicted.get(k) != live.get(k))
    print(f"28(a) {QWEN_RUN.key}: {row['layers']} layers, predicted argument bytes "
          f"{row['argument_bytes']} ({len(predicted)} leaves), the captured step's live state "
          f"and batch on the card {sum(live.values())} ({len(live)} leaves); leaves that "
          f"differ: {diff[:8]}")
    check(row["argument_bytes"] == sum(live.values()) and not diff,
          f"28(a) the dry run's argument bytes {row['argument_bytes']} != the live state's "
          f"{sum(live.values())}: {diff[:8]}")
    state_abs, batch_abs = low.args
    no_moments = dataclasses.replace(
        low, args=(state_abs._replace(opt={"t": state_abs.opt["t"]}), batch_abs),
        specs=(low.specs[0]._replace(opt={"t": None}), low.specs[1]))
    planted = sum(argument_bytes(no_moments).values())
    print(f"28(a) planted fault (the optimizer moments left out): {planted} bytes predicted")
    check(planted != sum(live.values()), "28(a) the planted fault passed the equality")
    replay_s = cap["step_ms_replay_median"] / 1e3
    a = dict(row, replay_ms=cap["step_ms_replay_median"],
             capture_step_ms=cap["capture_step_ms"], pool_bytes=cap["pool_bytes"],
             live_bytes=sum(live.values()), planted_fault_bytes=planted,
             mfu=row["model_flops"] / (H100.peak_flops * replay_s),
             bound_over_replay=row["bound_s"] / replay_s, card=smi)
    print(f"28(a) predicted bound {row['bound_s'] * 1e3:.2f} ms ({row['dominant']}; compute "
          f"{row['compute_s'] * 1e3:.2f} ms, memory {row['memory_s'] * 1e3:.2f} ms) beside the "
          f"replayed step {cap['step_ms_replay_median']:.2f} ms: model FLOPs "
          f"{row['model_flops']:.4e}, {a['mfu']:.2%} of H100.peak_flops; trace "
          f"{row['trace_s']} s beside the capture step {cap['capture_step_ms']:.1f} ms, "
          f"pool {cap['pool_bytes']} bytes ({smi})")
    print(json.dumps({"dryrun": {"train_cell": a}}))

    rows = []
    for run in phase_train_runs():
        _, r = dryrun_cell(run, dev, depth=min(run.depth, DRYRUN_CELL_DEPTH), accum=1)
        rows.append(r)
        print(f"28(b) [{run.key}: {r['arch']} {r['layers']} of {run.depth} layers, "
              f"{run.batch} x {run.seq}, "
              f"one microbatch] "
              f"{'supported' if r['supported'] else 'skipped'} flops/dev "
              f"{r['flops_per_device']:.4e} args/dev {r['argument_bytes']} "
              f"hbm_ok={r['hbm_ok']} dominant={r['dominant']} ({r['cell_s']:.1f} s)")
    seconds = time.perf_counter() - t0
    print(json.dumps({"dryrun": {"phase_cells": rows, "phase28_s": seconds, "card": smi}}))
    return {"train_cell": a, "phase_cells": rows, "seconds": seconds}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one CUDA card",
              file=sys.stderr)
        return 2

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.core.spatial import stack_reference
    from repro_torch.core.tiling import Group
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv2d_tiled.backward import (
        conv2d_dgrad_tile,
        conv2d_wgrad_tile,
        dgrad_gather,
        dgrad_split,
        dgrad_tile,
        wgrad_split,
        wgrad_tile,
    )
    from repro_torch.kernels.conv2d_tiled.kernel import (
        FWD_TILES,
        conv2d_tile,
        fwd_gather,
        fwd_split,
        fwd_tile,
    )
    from repro_torch.kernels.conv2d_tiled.kernel import reset_launches as reset_b1_launches
    from repro_torch.kernels.conv2d_tiled.ref import (
        conv2d_dgrad_ref,
        conv2d_ref,
        conv2d_wgrad_ref,
    )
    from repro_torch.models.yolo import make_yolo_tiled_arch
    from repro_torch.runtime.driver import run_serving

    import tempfile

    t_run = time.perf_counter()
    laps = {}

    def lap(done: str) -> None:
        """Prints the seconds the phases since the last lap took."""
        now = time.perf_counter()
        laps[done], lap.t = now - lap.t, now
        print(f"phases {done}: {laps[done]:.1f} s; the whole run so far {now - t_run:.1f} s",
              flush=True)

    lap.t = t_run
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    lap("1")

    # -- 2. build ------------------------------------------------------------
    t0 = time.monotonic()
    libs = _build.build()
    print(f"built {sorted(libs)} in {time.monotonic() - t0:.1f}s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")
    tc_sass = {fn: text.count("HGMMA") for fn, text in _build.sass("flash_attention_fwd").items()
               if "flash_attention_fwd_wgmma_kernel" in fn}
    tc_spills = {fn: v for fn, v in _build.spills("flash_attention_fwd").items()
                 if "flash_attention_fwd_wgmma_kernel" in fn}
    print(f"B4 tensor-core instances: HGMMA instructions {list(tc_sass.values())}, spill bytes "
          f"(stores, loads) {list(tc_spills.values())}")
    check(len(tc_sass) == 2 and all(n > 0 for n in tc_sass.values()),
          f"B4 tensor-core instances without HGMMA in their SASS: {tc_sass}")
    check(len(tc_spills) == 2 and all(v == (0, 0) for v in tc_spills.values()),
          f"B4 tensor-core instances spill: {tc_spills}")
    b2_spills = _build.spills("conv2d_dgrad_tile")
    print(f"B2 instances: {len(b2_spills)} kernels, spill bytes (stores, loads) "
          f"{sorted(set(b2_spills.values()))}")
    check(len(b2_spills) > 0 and all(v == (0, 0) for v in b2_spills.values()),
          f"B2 instances spill: {b2_spills}")
    b6_spills = {fn: v for fn, v in _build.spills("rmsnorm").items() if v != (0, 0)}
    print(f"B6 kernels that spill: {b6_spills}")
    b1_regs = _build.registers("conv2d_tile")
    b1_spills = _build.spills("conv2d_tile")
    print("B1 instances (registers, spill bytes (stores, loads)):")
    for fn in sorted(b1_regs):
        print(f"  {_build.demangle(fn)}: {b1_regs[fn]} registers, spills {b1_spills.get(fn)}")
    check(len(b1_spills) > 0 and all(v == (0, 0) for v in b1_spills.values()),
          f"B1 instances spill: { {_build.demangle(k): v for k, v in b1_spills.items() if v != (0, 0)} }")
    b5_sass = {fn: text.count("HGMMA") for fn, text in _build.sass("ssd_chunk_fwd").items()
               if "ssd_chunk_fwd_wgmma_kernel" in fn}
    b5_spills = {fn: v for fn, v in _build.spills("ssd_chunk_fwd").items()
                 if "ssd_chunk_fwd_wgmma_kernel" in fn}
    b5_regs = {fn: v for fn, v in _build.registers("ssd_chunk_fwd").items()
               if "ssd_chunk_fwd_wgmma_kernel" in fn}
    print(f"B5 wgmma_bf16: HGMMA instructions {list(b5_sass.values())}, registers "
          f"{list(b5_regs.values())}, spill bytes (stores, loads) {list(b5_spills.values())}")
    check(len(b5_sass) == 1 and all(n > 0 for n in b5_sass.values()),
          f"B5 wgmma_bf16 without HGMMA in its SASS: {b5_sass}")
    check(len(b5_spills) == 1 and all(v == (0, 0) for v in b5_spills.values()),
          f"B5 wgmma_bf16 spills: {b5_spills}")

    lap("2")

    # -- 3. kernel against its plain version ----------------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    groups = [Group(0, 3), Group(4, 7), Group(8, 11), Group(12, 15)]
    arch = make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=GRID[0], m=GRID[1],
                                groups=groups, backend="cuda", device=dev)
    plan = arch.plan
    check(list(plan.group_halos) == [(3, 3, 3, 3)] + [(2, 2, 2, 2)] * 3,
          f"group halos {plan.group_halos}")
    shapes = conv_shapes(plan, max(BUCKETS))
    check(len(shapes) == N_CONVS, f"{len(shapes)} conv shapes")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def inputs(x_shape, w_shape, bias, x_dtype=torch.float32, w_dtype=torch.float32):
        out_dtype = torch.promote_types(x_dtype, w_dtype)
        x = torch.randn(x_shape, generator=gen, device=dev).to(x_dtype)
        fan_in = w_shape[0] * w_shape[1] * w_shape[2]
        w = (torch.randn(w_shape, generator=gen, device=dev) * (2.0 / fan_in) ** 0.5).to(w_dtype)
        b = torch.randn(w_shape[-1], generator=gen, device=dev).to(out_dtype) if bias else \
            torch.zeros(w_shape[-1], device=dev, dtype=out_dtype)
        return x, w, b

    def fwd_rules(x_shape, w_shape, stride):
        """B1's tile, (splits, chunk) and gather at one shape: the code's rules."""
        k, _, cin, cout = w_shape
        pixels = math.prod(out_shape(x_shape, w_shape, stride)[:3])
        return fwd_tile(cout), fwd_split(pixels, cout, k * k * cin), fwd_gather(cin)

    def fwd_case(x, w, b, stride, act="linear"):
        """B1 against its plain version, and bitwise against itself on a rerun."""
        got = conv2d_tile(x, w, b, stride=stride, act=act)
        want = conv2d_ref(x, w, b, stride=stride, act=act)
        again = conv2d_tile(x, w, b, stride=stride, act=act)
        torch.cuda.synchronize()
        check(got.dtype == want.dtype == torch.promote_types(x.dtype, w.dtype)
              and got.shape == want.shape, f"B1 {tuple(x.shape)}: {got.dtype} {tuple(got.shape)}")
        check(torch.equal(got, again), f"B1 {tuple(x.shape)}x{tuple(w.shape)}: two runs on the "
              f"same inputs differ")
        tol = TOL_BF16 if got.dtype == torch.bfloat16 else TOL_FP32
        err, ratio = err_stats(got, want, **tol)
        check(ratio <= 1.0, f"B1 {tuple(x.shape)}x{tuple(w.shape)} s{stride} {act}: max err {err} "
              f"over tolerance {tol}")
        return got, want, err, ratio

    def fwd_row(s):
        """B1 at one path shape of the serve run (zero bias, linear): checked,
        timed against its plain version and cuDNN, bound computed."""
        x, w, b = inputs(s["x"], s["w"], bias=False)
        got, want, err, ratio = fwd_case(x, w, b, s["stride"])
        xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
        k_ms = time_ms(lambda: conv2d_tile(x, w, b, stride=s["stride"]))
        p_ms = time_ms(lambda: conv2d_ref(x, w, b, stride=s["stride"]))
        l_ms = time_ms(lambda: F.conv2d(xn, wn, stride=s["stride"]))
        y_shape = out_shape(s["x"], s["w"], s["stride"])
        b_ms, b_by = bound(conv_flops(s["x"], s["w"], s["stride"]), 4 * (
            math.prod(s["x"]) + math.prod(s["w"]) + s["w"][-1] + math.prod(y_shape)))
        tile, split, gather = fwd_rules(s["x"], s["w"], s["stride"])
        print(f"  conv layer {s['layer']:2d} x{s['x']} w{s['w']} ({tile}, splits x chunk "
              f"{split[0]} x {split[1]}, {gather}): err {err:.2e} ({ratio:.3f} of tol) "
              f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms cudnn {l_ms:.4f} ms "
              f"bound {b_ms:.4f} ms ({b_by})")
        return dict(layer=s["layer"], x=s["x"], w=s["w"], max_abs_err=err, err_ratio=ratio,
                    tile=tile, splits_chunk=list(split), gather=gather,
                    ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by)

    def fwd_check(s):
        """B1 at one training-run shape: checked, not timed."""
        x, w, b = inputs(s["x"], s["w"], bias=False)
        _, _, err, ratio = fwd_case(x, w, b, s["stride"])
        tile, split, gather = fwd_rules(s["x"], s["w"], s["stride"])
        print(f"  train conv layer {s['layer']:2d} x{s['x']} w{s['w']} ({tile}, splits x chunk "
              f"{split[0]} x {split[1]}, {gather}): err {err:.2e} ({ratio:.3f} of tol), bitwise "
              f"equal on a rerun")
        return err

    rows = [fwd_row(s) for s in shapes]
    serve_err = max(r["max_abs_err"] for r in rows)
    print(f"B1 at the 12 bucket-8 shapes: kernel {sum(r['ms'] for r in rows):.4f} ms, cudnn "
          f"{sum(r['library_ms'] for r in rows):.4f} ms, bound {sum(r['bound_ms'] for r in rows):.4f} ms")
    # the training run's forward shapes: all 16 tiles of a microbatch of 4
    for s in conv_shapes(plan, TRAIN_BATCH // TRAIN_ACCUM):
        fwd_check(s)

    f32, bf16 = torch.float32, torch.bfloat16
    extra = [
        # name, x shape, w shape, stride, act, bias, x dtype, w dtype
        ("stride2", (4, 33, 33, 16), (3, 3, 16, 32), 2, "linear", False, f32, f32),
        ("relu", (4, 20, 20, 32), (3, 3, 32, 40), 1, "relu", True, f32, f32),
        ("leaky", (4, 20, 20, 32), (3, 3, 32, 40), 1, "leaky", True, f32, f32),
        ("bias", (2, 18, 18, 64), (1, 1, 64, 96), 1, "linear", True, f32, f32),
        ("bf16", (4, 30, 30, 128), (3, 3, 128, 256), 1, "leaky", True, bf16, bf16),
        ("bf16_x_fp32_w", (4, 30, 30, 128), (3, 3, 128, 256), 1, "leaky", True, bf16, f32),
        ("fp32_x_bf16_w", (4, 30, 30, 128), (3, 3, 128, 256), 1, "relu", False, f32, bf16),
        ("cout1", (2, 17, 17, 24), (3, 3, 24, 1), 1, "relu", True, f32, f32),
        ("cin3_ragged", (3, 21, 19, 3), (3, 3, 3, 32), 1, "leaky", True, f32, f32),
        ("odd_cin", (3, 19, 23, 5), (3, 3, 5, 70), 2, "leaky", True, f32, f32),
        # each tile instance and gather off the path's shapes: ragged Cout, ragged M
        ("128x32_vector_ragged_cout", (3, 21, 19, 16), (3, 3, 16, 30), 1, "relu", True, f32, f32),
        ("128x64_vector_ragged_cout", (2, 11, 13, 48), (3, 3, 48, 50), 1, "leaky", True, f32, f32),
        ("128x128_general_ragged_cout", (3, 21, 19, 40), (3, 3, 40, 130), 1, "leaky", True, f32,
         f32),
        ("128x64_general_stride2", (2, 17, 17, 24), (3, 3, 24, 64), 2, "relu", True, f32, f32),
        # split-K (2 or more slices) over a ragged M, bias and leaky after the reduce
        ("split_ragged_m_bias_leaky", (5, 9, 7, 256), (3, 3, 256, 256), 1, "leaky", True, f32,
         f32),
        ("split_1x1_bias_leaky_bf16", (4, 13, 13, 512), (1, 1, 512, 256), 1, "leaky", True, bf16,
         bf16),
    ]
    seen = set()
    for name, xs, ws, stride, act, bias, x_dtype, w_dtype in extra:
        x, w, b = inputs(xs, ws, bias, x_dtype, w_dtype)
        got, want, err, ratio = fwd_case(x, w, b if bias else None, stride, act)
        tile, split, gather = fwd_rules(xs, ws, stride)
        seen |= {tile, gather} | ({"split"} if split[0] > 1 else set())
        print(f"  case {name} ({tile}, splits x chunk {split[0]} x {split[1]}, {gather}): out "
              f"{got.dtype}, max err {err:.2e} ({ratio:.3f} of tolerance), max |out| "
              f"{float(want.float().abs().max()):.3g}")
    check(seen >= set(FWD_TILES) | {"vector", "general", "split"},
          f"B1 edge cases miss {set(FWD_TILES) | {'vector', 'general', 'split'} - seen}")
    print(f"B1 checks passed (fp32 {TOL_FP32}, bf16 {TOL_BF16}; bitwise equal on a rerun; every "
          f"tile, both gathers and split-K)")

    # B2 / B3 at the training run's shapes: all 16 tiles of a microbatch of 4.
    # Layer 0's dgrad is checked but not on the path (its input is the image).
    def bwd_case(x_shape, w_shape, stride, x_dtype=f32, w_dtype=f32):
        x, w, _ = inputs(x_shape, w_shape, False, x_dtype, w_dtype)
        g_dtype = torch.promote_types(x_dtype, w_dtype)
        g = torch.randn(out_shape(x_shape, w_shape, stride), generator=gen, device=dev).to(g_dtype)
        hw, k = x_shape[1:3], w_shape[0]
        dx = conv2d_dgrad_tile(g, w, hw, stride=stride)
        dx_ref = conv2d_dgrad_ref(g, w, hw, stride)
        dw = conv2d_wgrad_tile(x, g, k, stride=stride, out_dtype=w_dtype)
        dw_ref = conv2d_wgrad_ref(x, g, k, stride, w_dtype)
        torch.cuda.synchronize()
        check(dx.dtype == dx_ref.dtype == g_dtype and dx.shape == dx_ref.shape == x.shape,
              f"dgrad {x_shape}x{w_shape}: {dx.dtype} {tuple(dx.shape)}")
        check(dw.dtype == dw_ref.dtype == w_dtype and dw.shape == dw_ref.shape == w.shape,
              f"wgrad {x_shape}x{w_shape}: {dw.dtype} {tuple(dw.shape)}")
        d_err, d_ratio = err_stats(dx, dx_ref, **(TOL_BF16 if g_dtype == bf16 else TOL_FP32))
        check(d_ratio <= 1.0, f"dgrad {x_shape}x{w_shape} s{stride}: max err {d_err} over tolerance")
        check(torch.equal(dx, conv2d_dgrad_tile(g, w, hw, stride=stride)),
              f"dgrad {x_shape}x{w_shape} s{stride}: two runs on the same inputs differ")
        if w_dtype == bf16:
            w_err, w_ratio = err_stats(dw, dw_ref, **TOL_BF16)
        else:
            w_err = float((dw.float() - dw_ref.float()).abs().max())
            w_ratio = w_err / (WGRAD_NORM_TOL * float(dw_ref.float().abs().max()))
        check(w_ratio <= 1.0, f"wgrad {x_shape}x{w_shape} s{stride}: max err {w_err} over tolerance")
        return x, w, g, d_err, d_ratio, w_err, w_ratio

    def bwd_rows(s):
        """B2 and B3 at one training-run shape: checked (B2 also against fp64,
        both bitwise on a rerun), timed against their plain versions and
        cuDNN.  Returns (dgrad row, None at layer 0 whose dgrad is off the
        path; wgrad row)."""
        st, k, hw = s["stride"], s["w"][0], s["x"][1:3]
        x, w, g, d_err, d_ratio, w_err, w_ratio = bwd_case(s["x"], s["w"], st)
        xn, wn, gn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2)
        flops = conv_flops(s["x"], s["w"], st)
        nbytes = 4 * (math.prod(s["x"]) + math.prod(s["w"]) + math.prod(g.shape))
        line = f"  bwd layer {s['layer']:2d} x{s['x']} w{s['w']}:"
        drow = None
        if s["layer"] != 0:
            b_ms, b_by = bound(flops, nbytes)
            # how close kernel and plain fp32 version each come to an fp64 dgrad
            dx64 = conv2d_dgrad_ref(g.double(), w.double(), hw, st)
            fp64_err = [float((d.double() - dx64).abs().max())
                        for d in (conv2d_dgrad_tile(g, w, hw, stride=st), conv2d_dgrad_ref(g, w, hw, st))]
            del dx64
            check(fp64_err[0] <= DGRAD_FP64_FACTOR * fp64_err[1],
                  f"dgrad layer {s['layer']}: {fp64_err[0]} from fp64, over {DGRAD_FP64_FACTOR} x "
                  f"the plain version's {fp64_err[1]}")
            pixels, cin, kd = math.prod(s["x"][:3]), s["w"][2], k * k * s["w"][3]
            d_tile, d_split = dgrad_tile(cin), dgrad_split(pixels, cin, kd)
            drow = dict(layer=s["layer"], x=s["x"], w=s["w"], max_abs_err=d_err, err_ratio=d_ratio,
                        tile=d_tile, splits_chunk=list(d_split),
                        gather=dgrad_gather(s["w"][3], st),
                        kernel_err_vs_fp64=fp64_err[0], plain_err_vs_fp64=fp64_err[1],
                        ms=time_ms(lambda: conv2d_dgrad_tile(g, w, hw, stride=st)),
                        plain_ms=time_ms(lambda: conv2d_dgrad_ref(g, w, hw, st)),
                        library_ms=time_ms(lambda: torch.nn.grad.conv2d_input(xn.shape, wn, gn, stride=st)),
                        bound_ms=b_ms, bound_by=b_by)
            line += (f" dgrad ({d_tile}, splits x chunk {d_split[0]} x {d_split[1]}, "
                     f"{drow['gather']}) err {d_err:.2e} ({d_ratio:.2f} of tol; vs fp64 kernel "
                     f"{fp64_err[0]:.2e} plain {fp64_err[1]:.2e}) {drow['ms']:.4f} ms plain "
                     f"{drow['plain_ms']:.4f} cudnn {drow['library_ms']:.4f} bound {b_ms:.4f} ({b_by});")
        else:
            line += f" dgrad err {d_err:.2e} ({d_ratio:.2f} of tol, not on the path);"
        check(torch.equal(conv2d_wgrad_tile(x, g, k, stride=st), conv2d_wgrad_tile(x, g, k, stride=st)),
              f"wgrad layer {s['layer']}: two runs on the same inputs differ")
        b_ms, b_by = bound(flops, nbytes)
        rows_kc, cout = k * k * s["w"][2], s["w"][3]
        tile, split = wgrad_tile(rows_kc, cout), wgrad_split(math.prod(g.shape[:3]), rows_kc, cout)
        wrow = dict(layer=s["layer"], x=s["x"], w=s["w"], max_abs_err=w_err, err_ratio=w_ratio,
                    tile=tile, splits_chunk=list(split),
                    ms=time_ms(lambda: conv2d_wgrad_tile(x, g, k, stride=st)),
                    plain_ms=time_ms(lambda: conv2d_wgrad_ref(x, g, k, st)),
                    library_ms=time_ms(lambda: torch.nn.grad.conv2d_weight(xn, wn.shape, gn, stride=st)),
                    bound_ms=b_ms, bound_by=b_by)
        print(line + f" wgrad ({tile}, splits x chunk {split[0]} x {split[1]}) err {w_err:.2e} "
              f"({w_ratio:.2f} of normwise tol) {wrow['ms']:.4f} ms "
              f"plain {wrow['plain_ms']:.4f} cudnn {wrow['library_ms']:.4f} bound {b_ms:.4f} ({b_by})")
        return drow, wrow

    dgrad_rows, wgrad_rows = [], []
    for s in conv_shapes(plan, TRAIN_BATCH // TRAIN_ACCUM):
        drow, wrow = bwd_rows(s)
        dgrad_rows += [drow] if drow else []
        wgrad_rows.append(wrow)
    dgrad_err = max(r["max_abs_err"] for r in dgrad_rows)
    wgrad_err = max(r["max_abs_err"] for r in wgrad_rows)

    bwd_extra = [
        # name, x shape, w shape, stride, x dtype, w dtype
        ("stride2", (4, 33, 33, 16), (3, 3, 16, 32), 2, f32, f32),
        ("ragged_r", (2, 14, 13, 3), (3, 3, 3, 5), 2, f32, f32),     # (14-3) % 2 = 1 row
        ("k2_stride2", (2, 16, 15, 8), (2, 2, 8, 24), 2, f32, f32),  # (15-2) % 2 = 1 col
        ("cout1", (2, 17, 17, 24), (3, 3, 24, 1), 1, f32, f32),
        ("odd_cin", (3, 19, 23, 5), (3, 3, 5, 70), 2, f32, f32),
        ("bf16", (4, 30, 30, 128), (3, 3, 128, 256), 1, bf16, bf16),
        ("bf16_x_fp32_w", (4, 30, 30, 128), (3, 3, 128, 256), 1, bf16, f32),
        ("fp32_x_bf16_w", (4, 30, 30, 128), (3, 3, 128, 256), 1, f32, bf16),
        # each B2 tile instance off the path's shapes: ragged Cin, ragged M
        ("dgrad_128x32", (3, 21, 19, 32), (3, 3, 32, 48), 1, f32, f32),
        ("dgrad_128x64_ragged_cin", (2, 11, 13, 40), (3, 3, 40, 48), 1, f32, f32),
        ("dgrad_128x128_ragged_cin", (3, 21, 19, 96), (3, 3, 96, 64), 1, f32, f32),
        ("dgrad_128x128_general_stride2", (2, 17, 17, 96), (3, 3, 96, 64), 2, f32, f32),
        # split-K (36 slices of 128 terms) over a ragged M = 315 dx pixels
        ("dgrad_split_ragged_m", (5, 9, 7, 32), (3, 3, 32, 512), 1, f32, f32),
    ]
    for name, xs, ws, stride, x_dtype, w_dtype in bwd_extra:
        *_, d_err, d_ratio, w_err, w_ratio = bwd_case(xs, ws, stride, x_dtype, w_dtype)
        pixels, kd = math.prod(xs[:3]), ws[0] * ws[1] * ws[3]
        print(f"  bwd case {name}: dgrad ({dgrad_tile(ws[2])}, splits x chunk "
              f"{dgrad_split(pixels, ws[2], kd)}, {dgrad_gather(ws[3], stride)}) err {d_err:.2e} "
              f"({d_ratio:.3f} of tol), wgrad err {w_err:.2e} ({w_ratio:.3f} of tol)")
    print(f"B2/B3 checks passed (dgrad fp32 {TOL_FP32} and within {DGRAD_FP64_FACTOR} x the plain "
          f"version's distance from fp64, wgrad normwise {WGRAD_NORM_TOL} x max, both bitwise "
          f"equal on a rerun, bf16 outputs {TOL_BF16})")

    lap("3")

    # -- 4. serve ------------------------------------------------------------
    rng = np.random.default_rng(SEED)
    params = arch.init(SEED)
    calib = rng.standard_normal((8, *INPUT_HW, 3)).astype(np.float32)
    images = rng.standard_normal((sum(ARRIVALS), *INPUT_HW, 3)).astype(np.float32)
    sparams = arch.serve_params(params, calib)

    # The forward alone (device time, CUDA events) and the service time the
    # deadline policy plans with: a whole bucket-8 dispatch on the host
    # clock, host->device copy and device->host copy of the result included.
    from repro_torch.core.fusion import make_tiled_infer

    infer = make_tiled_infer(arch.serve_plan(), arch.mesh)
    x8 = torch.from_numpy(images[:8]).to(dev)
    fwd_ms = time_ms(lambda: infer(sparams, x8), reps=3, iters=3)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        infer(sparams, torch.from_numpy(images[:8]).to(dev)).cpu().numpy()
        walls.append(time.perf_counter() - t0)
    step_s = statistics.median(walls)
    print(f"bucket-8 forward {fwd_ms:.3f} ms (CUDA events); whole dispatch "
          f"{step_s * 1e3:.3f} ms (host clock, copies included)")

    # where the device time of a bucket-8 forward goes, by kernel name
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            infer(sparams, x8)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    by_name = device_ms_by_name(prof, 3)
    dev_ms = sum(by_name.values())
    conv_ms = sum(v for k, v in by_name.items() if "conv2d_tile_" in k)
    check(dev_ms > 0 and conv_ms > 0, "profiler saw no device time for the conv kernel")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({"profile_bucket8": {
        "wall_ms": prof_wall_ms, "device_ms": dev_ms, "conv_kernel_ms": conv_ms,
        "idle_share": max(0.0, 1 - dev_ms / prof_wall_ms),
        "top": [[k[:80], v] for k, v in top],
    }}))

    engine = arch.make_serve_engine(
        sparams, buckets=BUCKETS, step_bound=step_s,
        latency_budget=2.0 * step_s,   # headroom of 2 steps: every tick ships
    )
    warm = engine.warmup()
    check(warm["misses"] == len(BUCKETS), f"warmup misses {warm['misses']}")

    it = iter(images)

    def on_tick(t, eng):
        for _ in range(ARRIVALS[t]):
            eng.submit(next(it))

    reset_b1_launches()
    report = run_serving(engine, ticks=len(ARRIVALS), on_tick=on_tick)
    check(engine.capture and report.capture["buckets"] == list(BUCKETS),
          f"phase 4 served without a graph per bucket: {report.capture}")
    launches, b1_instances = served_launches("serve", engine, plan, conv2d_tile.launches,
                                             conv2d_tile.launches_by_instance)
    print(f"served {report.served} in {report.dispatches} dispatches, census "
          f"{report.bucket_census}, launches {launches} (by tile instance {b1_instances}; "
          f"replays {report.capture['replays']} of graphs of {report.capture['launches']}), "
          f"cache {report.cache}")
    check(report.served == len(images), f"served {report.served}")
    check(launches == N_CONVS * report.dispatches, f"launches {launches} != {N_CONVS} x "
          f"{report.dispatches} dispatches")
    check(report.cache["misses"] == len(BUCKETS), f"cache misses {report.cache['misses']}")

    with torch.inference_mode():
        ref = torch.cat([
            stack_reference(torch.from_numpy(images[i:i + 8]).to(dev), sparams,
                            plan.layers, inference=True).cpu()
            for i in range(0, len(images), 8)
        ])
    got = torch.from_numpy(np.stack([r.result for r in sorted(engine.finished, key=lambda r: r.rid)]))
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()), f"output {tuple(got.shape)}")
    e2e_err, e2e_ratio = err_stats(got, ref, **TOL_SERVE)
    served4 = {"images": images, "calib": calib, "untiled": ref.numpy()}   # phase 29(f)
    print(f"serve output {tuple(got.shape)} vs untiled plain reference: max err {e2e_err:.3e} "
          f"({e2e_ratio:.3f} of tolerance {TOL_SERVE})")
    check(e2e_ratio <= 1.0, "serve responses disagree with the untiled reference")

    kernel_ms = sum(r["ms"] for r in rows)
    print(json.dumps({"conv_shapes": rows}))
    print(json.dumps({"dgrad_shapes": dgrad_rows}))
    print(json.dumps({"wgrad_shapes": wgrad_rows}))
    serve4 = {
        "p50_ms": report.p50_s * 1e3, "p99_ms": report.p99_s * 1e3,
        "img_per_s": report.throughput, "dispatches": report.dispatches,
        "bucket_census": report.bucket_census, "deadline_misses": report.deadline_misses,
        "bucket8_forward_ms": fwd_ms, "bucket8_dispatch_ms": step_s * 1e3,
        "bucket8_device_ms": dev_ms, "bucket8_kernel_ms": kernel_ms, "max_abs_err": e2e_err,
        "bucket8_idle_share": max(0.0, 1 - dev_ms / prof_wall_ms),
        "launches": launches, "launches_per_dispatch": N_CONVS,
        "b1_launches_by_instance": b1_instances, "capture": report.capture, "card": smi,
    }
    print(json.dumps({"serve": serve4}))
    train5 = train_phase(dev, smi, dict(groups=groups))
    train_launches = train5["launches"]

    def shape_key(s):
        return s["x"], s["w"], s["stride"]

    held_serve = {shape_key(s) for s in shapes}       # phase 3's B1 and B2/B3 shapes
    held_train = {shape_key(s) for s in conv_shapes(plan, TRAIN_BATCH // TRAIN_ACCUM)}
    del arch, plan, params, sparams, engine, infer, x8, ref, got
    torch.cuda.empty_cache()

    lap("4-5")

    # -- 6-8. flash attention and RMSNorm; the LM training path ---------------
    import repro_torch.kernels.ssd_chunk.ops as ssd_ops
    import repro_torch.models.attention as attn_mod
    from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk_fwd

    fa_rows, fa_err, rms_rows, rms_err = attn_norm_kernel_phase(dev)
    qwen7 = lm_train_phase(dev, smi, QWEN_RUN)
    lm_launches = qwen7["launches"]
    real_fa = attn_mod.flash_attention

    def zero_one_kv_head(q, k, v, *a):
        v = v.clone()
        v[:, :, 0] = 0
        return real_fa(q, k, v, *a)

    lm_grads = lm_grad_phase(
        dev, QWEN_RUN, swapped((attn_mod, "flash_attention", zero_one_kv_head)),
        ["/segments/0/0/attn/w_v", "/segments/0/0/attn/b_v"], "B4 fed KV head 0's values zeroed")
    print(json.dumps({"lm_grads": lm_grads}))
    torch.cuda.empty_cache()
    print(f"after the Qwen phases: {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated")

    lap("6-8")

    # -- 9-11. the SSD kernel; the Mamba2 training path ---------------------
    ssd_rows, ssd_err = ssd_kernel_phase(dev)
    mamba_launches = lm_train_phase(dev, smi, MAMBA_RUN)["launches"]

    def zero_head0_y_intra(*a, **k):
        y, *rest = ssd_chunk_fwd(*a, **k)
        y[:, :, 0] = 0
        return (y, *rest)

    # the op's forward reaches B5 through its module reference ``_kernel``
    mamba_grads = lm_grad_phase(
        dev, MAMBA_RUN,
        swapped((ssd_ops, "_kernel", types.SimpleNamespace(ssd_chunk_fwd=zero_head0_y_intra))),
        ["/segments/0/0/mamba/w_out", "/segments/0/0/mamba/norm_scale"],
        "B5's y_intra of head 0 zeroed")
    print(json.dumps({"mamba_grads": mamba_grads}))

    lap("9-11")

    # -- 12. the cost model's own plans on the card ----------------------------
    from repro_torch.core.fusion import build_stack_plan
    from repro_torch.core.grouping import PROFILES, peak_device_memory, profile_cost
    from repro_torch.launch import train as train_launcher
    from repro_torch.models.yolo import yolov2_16_layers
    from repro_torch.serve.cnn_engine import modeled_step_bound

    layers16 = yolov2_16_layers(batch_norm=True)
    for name in sorted(PROFILES):
        t0 = time.perf_counter()
        p = build_stack_plan(INPUT_HW, layers16, *GRID, "auto", backend="cuda", hw=name,
                             batch=TRAIN_BATCH, device=dev)
        planner_ms = (time.perf_counter() - t0) * 1e3
        got_groups = [[g.start, g.end] for g in p.groups]
        print(json.dumps({"auto_plan": {
            "hw": name, "groups": got_groups, "group_halos": [list(h) for h in p.group_halos],
            "profile_cost": profile_cost(INPUT_HW, p.layers, p.groups, p.n, p.m, PROFILES[name],
                                         TRAIN_BATCH),
            "peak_device_memory": peak_device_memory(INPUT_HW, p.layers, p.groups, p.n, p.m,
                                                     batch=TRAIN_BATCH),
            "planner_ms": planner_ms,
        }}))
        check(got_groups == [list(g) for g in AUTO_GROUPS_416[name]],
              f"{name}: auto groups {got_groups} != {AUTO_GROUPS_416[name]}")

    auto_kw = dict(groups="auto", hw=AUTO_HW, batch=TRAIN_BATCH, microbatches=TRAIN_ACCUM)
    train12 = train_phase(dev, smi, auto_kw, label="train_auto", plant_faults=False,
                          orders_from=train5)
    check(train12["groups"] == [list(g) for g in AUTO_GROUPS_416[AUTO_HW]],
          f"train_auto groups {train12['groups']}")
    summary = ("groups", "step_ms_cuda_events_median", "step_ms_host_median", "device_ms",
               "device_ms_by_kernel", "idle_share", "peak_mem_bytes")
    print(json.dumps({"train_auto_vs_hand": {
        "hand": {k: train5[k] for k in summary}, "auto": {k: train12[k] for k in summary},
        "card": smi,
    }}))

    # B1, B2 and B3 at every per-tile shape the auto plan gives them that
    # phase 3 did not hold: its first group's wider halo changes the extents
    auto_arch = make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=GRID[0], m=GRID[1],
                                     backend="cuda", device=dev, **auto_kw)
    aplan = auto_arch.plan
    new_serve = [s for s in conv_shapes(aplan, max(BUCKETS)) if shape_key(s) not in held_serve]
    new_train = [s for s in conv_shapes(aplan, TRAIN_BATCH // TRAIN_ACCUM)
                 if shape_key(s) not in held_train]
    print(f"auto plan: {len(new_serve)} new bucket-8 forward shapes, {len(new_train)} new "
          f"microbatch-4 shapes")
    check(new_serve and new_train, "the auto plan gives B1-B3 no shape phase 3 did not hold")
    auto_fwd = [fwd_row(s) for s in new_serve]
    auto_err = max([r["max_abs_err"] for r in auto_fwd] + [fwd_check(s) for s in new_train])
    auto_bwd = [bwd_rows(s) for s in new_train]
    auto_dgrad = [d for d, _ in auto_bwd if d]
    auto_wgrad = [w for _, w in auto_bwd]
    print(json.dumps({"auto_conv_shapes": auto_fwd}))
    print(json.dumps({"auto_dgrad_shapes": auto_dgrad}))
    print(json.dumps({"auto_wgrad_shapes": auto_wgrad}))
    serve_err = max(serve_err, auto_err)
    dgrad_err = max([dgrad_err] + [r["max_abs_err"] for r in auto_dgrad])
    wgrad_err = max([wgrad_err] + [r["max_abs_err"] for r in auto_wgrad])

    # serve the plan's inference twin under the modeled step bound
    aparams = auto_arch.serve_params(auto_arch.init(SEED), calib)
    bound_s = modeled_step_bound(auto_arch.serve_plan(), max(BUCKETS), AUTO_HW)
    ainfer = make_tiled_infer(auto_arch.serve_plan(), auto_arch.mesh)
    x8 = torch.from_numpy(images[:8]).to(dev)
    afwd_ms = time_ms(lambda: ainfer(aparams, x8), reps=3, iters=3)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        ainfer(aparams, torch.from_numpy(images[:8]).to(dev)).cpu().numpy()
        walls.append(time.perf_counter() - t0)
    adispatch_s = statistics.median(walls)
    engine = auto_arch.make_serve_engine(aparams, buckets=BUCKETS, step_bound=None, hw=AUTO_HW,
                                         latency_budget=2.0 * bound_s)
    check(engine.step_bound == bound_s, f"engine bound {engine.step_bound} != modeled {bound_s}")
    print(f"serve auto plan: modeled step bound ({AUTO_HW}) {bound_s * 1e3:.3f} ms; measured "
          f"bucket-8 forward {afwd_ms:.3f} ms (CUDA events), dispatch {adispatch_s * 1e3:.3f} ms "
          f"(host clock)")
    check(engine.warmup()["misses"] == len(BUCKETS), "auto serve warmup misses")
    it = iter(images)

    def on_tick(t, eng):
        for _ in range(ARRIVALS[t]):
            eng.submit(next(it))

    reset_b1_launches()
    areport = run_serving(engine, ticks=len(ARRIVALS), on_tick=on_tick)
    aserve_launches, _ = served_launches("serve_auto", engine, auto_arch.serve_plan(),
                                         conv2d_tile.launches, conv2d_tile.launches_by_instance)
    check(areport.served == len(images), f"auto serve served {areport.served}")
    check(aserve_launches == N_CONVS * areport.dispatches,
          f"auto serve launches {aserve_launches} != {N_CONVS} x {areport.dispatches}")
    with torch.inference_mode():
        ref = torch.cat([
            stack_reference(torch.from_numpy(images[i:i + 8]).to(dev), aparams, aplan.layers,
                            inference=True).cpu()
            for i in range(0, len(images), 8)
        ])
    got = torch.from_numpy(np.stack([r.result for r in sorted(engine.finished, key=lambda r: r.rid)]))
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()), f"auto output {tuple(got.shape)}")
    ae2e_err, ae2e_ratio = err_stats(got, ref, **TOL_SERVE)
    check(ae2e_ratio <= 1.0, "auto-plan serve responses disagree with the untiled reference")
    print(json.dumps({"serve_auto": {
        "groups": [[g.start, g.end] for g in aplan.groups], "hw": AUTO_HW,
        "modeled_step_bound_ms": bound_s * 1e3, "bucket8_forward_ms": afwd_ms,
        "bucket8_dispatch_ms": adispatch_s * 1e3,
        "p50_ms": areport.p50_s * 1e3, "p99_ms": areport.p99_s * 1e3,
        "img_per_s": areport.throughput, "dispatches": areport.dispatches,
        "bucket_census": areport.bucket_census, "deadline_misses": areport.deadline_misses,
        "max_abs_err": ae2e_err, "launches": aserve_launches, "capture": areport.capture,
        "card": smi,
    }}))
    del auto_arch, aparams, ainfer, engine, x8, ref, got
    torch.cuda.empty_cache()

    # the launchers themselves, as a user runs them, on the card
    def reset_counts():
        for f in (conv2d_tile, conv2d_dgrad_tile, conv2d_wgrad_tile):
            f.launches = 0
        reset_b1_launches()

    reset_counts()
    check(train_launcher.main([
        "--arch", "yolov2-tiled", "--groups", "auto", "--hw-profile", AUTO_HW,
        "--grid", str(GRID[0]),
        "--input-hw", str(INPUT_HW[0]), "--depth", "16", "--batch", str(TRAIN_BATCH),
        "--grad-accum", str(TRAIN_ACCUM), "--steps", "1"]) == 0, "train launcher")
    launcher_train = {f.__name__: f.launches for f in (conv2d_tile, conv2d_dgrad_tile,
                                                      conv2d_wgrad_tile)}
    want = {"conv2d_tile": N_CONVS * TRAIN_ACCUM, "conv2d_dgrad_tile": (N_CONVS - 1) * TRAIN_ACCUM,
            "conv2d_wgrad_tile": N_CONVS * TRAIN_ACCUM}
    check(launcher_train == want, f"train launcher launches {launcher_train} != {want}")
    reset_counts()
    host12, replayed12, _ = run_serve_launcher(
        ["--cnn", "--groups", "auto", "--hw", AUTO_HW, "--size", str(INPUT_HW[0]), "--depth",
         "16"], aplan.inference_twin())
    launcher_serve = host12 + replayed12
    print(f"launchers: train {launcher_train}, serve B1 {launcher_serve} ({host12} from the "
          f"host: warm runs and captures; {replayed12} replayed)")
    auto_launches = {k: train12["launches"][k] + launcher_train[k] for k in launcher_train}
    auto_launches["conv2d_tile"] += aserve_launches + launcher_serve
    held_b1 = held_serve | held_train | {shape_key(s) for s in new_serve + new_train}
    held_bwd = held_train | {shape_key(s) for s in new_train}

    lap("12")

    # -- 13. the overlap schedule and hybrid plans on the card ------------------
    # (a) the hand-picked groups under the overlap schedule
    overlap_kw = dict(groups=groups, schedule="overlap")
    ovs = overlap_vs_sync(dev, overlap_kw, dict(groups=groups))
    train13 = {"train_overlap": train_phase(dev, smi, overlap_kw, label="train_overlap",
                                            plant_faults=False, orders_from=train5)}
    oarch = make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=GRID[0], m=GRID[1],
                                 backend="cuda", device=dev, **overlap_kw)
    serve13 = {"serve_overlap": serve_phase(dev, smi, oarch, "serve_overlap", BUCKETS, images,
                                            calib)}
    summary = ("step_ms_cuda_events_median", "step_ms_host_median", "device_ms",
               "device_ms_by_kernel", "idle_share", "peak_mem_bytes", "launches_per_microbatch")
    print(json.dumps({"overlap_vs_sync": {
        "train": {"sync": {k: train5.get(k) for k in summary},
                  "overlap": {k: train13["train_overlap"][k] for k in summary}},
        "serve": {"sync": {k: serve4[k] for k in ("p50_ms", "p99_ms", "img_per_s",
                                                   "bucket8_forward_ms", "bucket8_dispatch_ms",
                                                   "bucket8_device_ms", "launches")},
                  "overlap": {k: serve13["serve_overlap"][k] for k in (
                      "p50_ms", "p99_ms", "img_per_s", "bucket8_forward_ms",
                      "bucket8_dispatch_ms", "bucket8_device_ms", "launches")}},
        "max_abs_diff": ovs, "card": smi,
    }}))
    del oarch
    torch.cuda.empty_cache()

    # (b) crossover="auto" under every profile; the HYBRID_HW plan with
    # overlap trained and served, one step of each other hybrid plan
    for name in sorted(PROFILES):
        sched, want_groups, want_cross = HYBRID_PLANS_416[name]
        p = build_stack_plan(INPUT_HW, layers16, *GRID, "auto", backend="cuda", hw=name,
                             batch=TRAIN_BATCH, crossover="auto", schedule=sched, device=dev)
        on_card = build_stack_plan(INPUT_HW, layers16, *GRID, "auto", backend="cuda", hw=name,
                                   batch=TRAIN_BATCH, crossover="auto", schedule="auto",
                                   device=dev)
        got = [[g.start, g.end, g.mode] for g in p.groups]
        print(json.dumps({"hybrid_plan": {
            "hw": name, "schedule": p.schedule, "groups": got, "crossover": p.crossover,
            "group_halos": [list(h) for h in p.group_halos],
            "schedule_auto_on_card": [on_card.schedule, on_card.crossover,
                                      [[g.start, g.end, g.mode] for g in on_card.groups]],
        }}))
        check(p.schedule == sched and got == [list(g) for g in want_groups]
              and p.crossover == want_cross,
              f"{name}: crossover='auto' plans {p.schedule} {got} {p.crossover}, not "
              f"{HYBRID_PLANS_416[name]}")
    hybrid_kw = dict(HYBRID_KW)
    train13["train_hybrid"] = train_phase(dev, smi, hybrid_kw, label="train_hybrid",
                                          plant_faults=False, orders_from=train5)
    harch = make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=GRID[0], m=GRID[1],
                                 backend="cuda", device=dev, **hybrid_kw)
    check([[g.start, g.end, g.mode] for g in harch.plan.groups]
          == [list(g) for g in HYBRID_PLANS_416[HYBRID_HW][1]], "hybrid plan groups")
    serve13["serve_hybrid"] = serve_phase(dev, smi, harch, "serve_hybrid", HYBRID_BUCKETS,
                                          images, calib)
    del harch
    torch.cuda.empty_cache()
    for name in ("jetson-edge-100m", "jetson-nano-gpu"):
        kw = dict(groups="auto", hw=name, batch=TRAIN_BATCH, microbatches=TRAIN_ACCUM,
                  crossover="auto")
        train13[f"train_hybrid_{name}"] = train_phase(dev, smi, kw, label=f"train_hybrid_{name}",
                                                      plant_faults=False, steps=1)
    print(json.dumps({"phase13_vs_phase5": {
        label: {k: r.get(k) for k in ("schedule", "crossover", "groups", "modes") + summary}
        for label, r in [("train_sync_phase5", train5)] + list(train13.items())
    }}))

    # (c) B1-B3 at every per-tile shape of those plans phases 3 and 12 did not hold
    plans13 = [make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=GRID[0], m=GRID[1],
                                    backend="cuda", device=dev, **kw).plan
               for kw in (overlap_kw, hybrid_kw,
                          *(dict(groups="auto", hw=name, batch=TRAIN_BATCH, crossover="auto")
                            for name in ("jetson-edge-100m", "jetson-nano-gpu")))]
    new_fwd = {shape_key(s): s for s in conv_shapes(plans13[0], max(BUCKETS))
               + conv_shapes(plans13[1], max(BUCKETS)) if shape_key(s) not in held_b1}
    new_tr = {shape_key(s): s for p in plans13 for s in conv_shapes(p, TRAIN_BATCH // TRAIN_ACCUM)
              if shape_key(s) not in held_bwd}
    print(f"phase 13 plans: {len(new_fwd)} new bucket-8 forward shapes, {len(new_tr)} new "
          f"microbatch-4 shapes")
    check(new_fwd and new_tr, "the phase-13 plans give B1-B3 no shape phases 3 and 12 did not hold")
    fwd13 = [dict(fwd_row(s), piece=s["piece"]) for s in new_fwd.values()]
    err13 = max([r["max_abs_err"] for r in fwd13]
                + [fwd_check(s) for k, s in new_tr.items() if k not in new_fwd])
    bwd13 = [bwd_rows(s) for s in new_tr.values()]
    dgrad13 = [d for d, _ in bwd13 if d]
    wgrad13 = [w for _, w in bwd13]
    for rows13, what in ((fwd13, "B1 bucket-8"), (dgrad13, "B2"), (wgrad13, "B3")):
        print(f"{what} at the {len(rows13)} new phase-13 shapes: kernel "
              f"{sum(r['ms'] for r in rows13):.4f} ms, cudnn {sum(r['library_ms'] for r in rows13):.4f}"
              f" ms, plain {sum(r['plain_ms'] for r in rows13):.4f} ms, bound "
              f"{sum(r['bound_ms'] for r in rows13):.4f} ms")
    print(json.dumps({"phase13_conv_shapes": fwd13}))
    print(json.dumps({"phase13_dgrad_shapes": dgrad13}))
    print(json.dumps({"phase13_wgrad_shapes": wgrad13}))
    serve_err = max(serve_err, err13)
    dgrad_err = max([dgrad_err] + [r["max_abs_err"] for r in dgrad13])
    wgrad_err = max([wgrad_err] + [r["max_abs_err"] for r in wgrad13])
    del plans13

    # (d) the launchers with the overlap schedule and an auto crossover
    reset_counts()
    check(train_launcher.main([
        "--arch", "yolov2-tiled", "--schedule", "overlap", "--crossover", "auto",
        "--hw-profile", HYBRID_HW,
        "--groups", "auto", "--grid", str(GRID[0]), "--input-hw", str(INPUT_HW[0]),
        "--depth", "16", "--batch", str(TRAIN_BATCH), "--grad-accum", str(TRAIN_ACCUM),
        "--steps", "1"]) == 0, "train launcher, overlap and crossover")
    launcher13_train = {f.__name__: f.launches for f in (conv2d_tile, conv2d_dgrad_tile,
                                                         conv2d_wgrad_tile)}
    per_mb, _ = launches_per_batch(
        make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=GRID[0], m=GRID[1], backend="cuda",
                             device=dev, **hybrid_kw).plan, TRAIN_BATCH // TRAIN_ACCUM)
    want = {k: v * TRAIN_ACCUM for k, v in per_mb.items()}
    check(launcher13_train == want, f"train launcher launches {launcher13_train} != {want}")
    reset_counts()
    host13, replayed13, _ = run_serve_launcher(
        ["--cnn", "--schedule", "overlap", "--crossover", "auto", "--hw", HYBRID_HW, "--groups",
         "auto", "--buckets", *map(str, HYBRID_BUCKETS), "--size", str(INPUT_HW[0]), "--depth",
         "16"], make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=GRID[0], m=GRID[1],
                                     backend="cuda", device=dev, **hybrid_kw).serve_plan())
    launcher13_serve = host13 + replayed13
    print(f"phase-13 launchers: train {launcher13_train}, serve B1 {launcher13_serve} ({host13} "
          f"from the host, {replayed13} replayed)")
    phase13_launches = {k: sum(r["launches"][k] for r in train13.values()) + launcher13_train[k]
                        for k in launcher13_train}
    phase13_launches["conv2d_tile"] += (sum(r["launches"] for r in serve13.values())
                                        + launcher13_serve)
    auto_launches = {k: v + phase13_launches[k] for k, v in auto_launches.items()}
    print(json.dumps({"phase13_launches": phase13_launches}))
    held_b1 |= set(new_fwd) | set(new_tr)
    held_bwd |= set(new_tr)

    lap("13")

    # -- 14. non-uniform tile partitions on the card ----------------------------
    # every phase-14 plan, spec and padded: its groups and the code's launch
    # counts per dispatch / microbatch (RAGGED_LAUNCHES, written down before
    # the first card run)
    kw14, plans14 = {}, {}
    for name, (g14, groups14, extra, want_groups) in RAGGED_PLANS_416.items():
        for ex in ("spec", "padded"):
            kw = dict(extra, ragged_exec=ex,
                      groups=groups14 if groups14 == "auto" else [Group(*x) for x in groups14])
            p = make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=g14, m=g14, backend="cuda",
                                     device=dev, **kw).plan
            got = [(x.start, x.end, x.mode) for x in p.groups]
            per_mb, _ = launches_per_batch(p, 1)
            print(f"phase 14 plan {name} {ex}: grid {g14}x{g14}, groups {got}, tile rows "
                  f"{p.tile_rows[0]} -> {p.tile_rows[12]}, cols {p.tile_cols[0]} -> "
                  f"{p.tile_cols[12]}, launches a dispatch / microbatch {per_mb}")
            check(not p.is_uniform and p.ragged_exec == ex, f"{name} {ex}: not a ragged plan")
            check(got == [tuple(x) for x in want_groups], f"{name} {ex}: groups {got}")
            check(per_mb == RAGGED_LAUNCHES[name][ex],
                  f"{name} {ex}: launches {per_mb} != {RAGGED_LAUNCHES[name][ex]}")
            kw14[(name, ex)], plans14[(name, ex)] = ((g14, g14), kw), p

    def arch14(key):
        grid14, kw = kw14[key]
        return make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=grid14[0], m=grid14[1],
                                    backend="cuda", device=dev, **kw)

    # (a) the 3x3 grid, hand-picked groups, spec and padded trained and
    # served; (b) the pi3x3+jetson cluster on 2x2 (groups="auto"), spec and
    # padded trained and served, and its crossover=14 twin trained one step.
    # Each spec plan is held to its padded twin and the untiled reference on
    # one microbatch first.
    vs14, train14, serve14 = {}, {}, {}
    for name, execs in (("grid3", ("spec", "padded")), ("cluster", ("spec", "padded"))):
        vs14[name] = overlap_vs_sync(dev, kw14[(name, "spec")][1], kw14[(name, "padded")][1],
                                     grid=kw14[(name, "spec")][0], names=("spec", "padded"))
        for ex in execs:
            grid14, kw = kw14[(name, ex)]
            # the update bars take image orders 1.. from phase 5's fp32
            # trainers, as phases 12 and 13 do (the run's time)
            r = train_phase(dev, smi, kw, label=f"train_ragged_{name}_{ex}", plant_faults=False,
                            grid=grid14, orders_from=train5)
            check(r["launches_per_microbatch"] == RAGGED_LAUNCHES[name][ex],
                  f"{name} {ex}: trained with {r['launches_per_microbatch']} launches a microbatch")
            train14[f"{name}_{ex}"] = r
    r = train_phase(dev, smi, kw14[("cluster_crossover", "spec")][1],
                    label="train_ragged_cluster_crossover_spec", plant_faults=False, steps=1)
    check(r["crossover"] == 14 and r["launches_per_microbatch"]
          == RAGGED_LAUNCHES["cluster_crossover"]["spec"], "cluster crossover twin")
    train14["cluster_crossover_spec"] = r
    for key in (("grid3", "spec"), ("grid3", "padded"), ("cluster", "spec"),
                ("cluster", "padded")):
        serve14["_".join(key)] = serve_phase(dev, smi, arch14(key), "serve_ragged_" + "_".join(key),
                                             BUCKETS, images, calib)
    torch.cuda.empty_cache()

    # (c) the launcher, as a user runs the cluster
    reset_counts()
    check(train_launcher.main([
        "--arch", "yolov2-tiled", "--grid", "2", "--cluster", "pi3x3+jetson", "--groups", "auto",
        "--input-hw", str(INPUT_HW[0]), "--depth", "16", "--batch", str(TRAIN_BATCH),
        "--grad-accum", str(TRAIN_ACCUM), "--steps", "1"]) == 0, "train launcher, pi3x3+jetson")
    launcher14 = {f.__name__: f.launches for f in (conv2d_tile, conv2d_dgrad_tile,
                                                   conv2d_wgrad_tile)}
    want = {k: v * TRAIN_ACCUM for k, v in RAGGED_LAUNCHES["cluster"]["spec"].items()}
    print(f"phase-14 launcher (--cluster pi3x3+jetson): {launcher14}")
    check(launcher14 == want, f"train launcher launches {launcher14} != {want}")

    # (d) B1-B3 at every per-tile shape of the phase-14 plans the earlier
    # phases did not hold: the shape classes' true extents, down to the 1x1
    # corner tiles' 3x3 windows, and the padded plans' canonical extents
    new_fwd14 = {shape_key(s): s for key in (("grid3", "spec"), ("grid3", "padded"),
                                            ("cluster", "spec"), ("cluster", "padded"))
                 for s in conv_shapes(plans14[key], max(BUCKETS)) if shape_key(s) not in held_b1}
    new_tr14 = {shape_key(s): s for key in (("grid3", "spec"), ("grid3", "padded"),
                                           ("cluster", "spec"), ("cluster_crossover", "spec"))
                for s in conv_shapes(plans14[key], TRAIN_BATCH // TRAIN_ACCUM)
                if shape_key(s) not in held_bwd}
    print(f"phase 14 plans: {len(new_fwd14)} new bucket-8 forward shapes, {len(new_tr14)} new "
          f"microbatch-4 shapes")
    check(new_fwd14 and new_tr14, "the phase-14 plans give B1-B3 no new shape")
    fwd14 = [dict(fwd_row(s), piece=s["piece"]) for s in new_fwd14.values()]
    err14 = max([r["max_abs_err"] for r in fwd14]
                + [fwd_check(s) for k, s in new_tr14.items() if k not in held_b1 | set(new_fwd14)])
    bwd14 = [bwd_rows(s) for s in new_tr14.values()]
    dgrad14 = [d for d, _ in bwd14 if d]
    wgrad14 = [w for _, w in bwd14]
    kernel_ms14 = {}
    for rows14, what in ((fwd14, "conv2d_tile"), (dgrad14, "conv2d_dgrad_tile"),
                         (wgrad14, "conv2d_wgrad_tile")):
        kernel_ms14[what] = {k: sum(r[k] for r in rows14)
                             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        print(f"{what} at the {len(rows14)} new phase-14 shapes: kernel "
              f"{kernel_ms14[what]['ms']:.4f} ms, cudnn {kernel_ms14[what]['library_ms']:.4f} ms, "
              f"plain {kernel_ms14[what]['plain_ms']:.4f} ms, bound "
              f"{kernel_ms14[what]['bound_ms']:.4f} ms")
    print(json.dumps({"phase14_conv_shapes": fwd14}))
    print(json.dumps({"phase14_dgrad_shapes": dgrad14}))
    print(json.dumps({"phase14_wgrad_shapes": wgrad14}))
    serve_err = max(serve_err, err14)
    dgrad_err = max([dgrad_err] + [r["max_abs_err"] for r in dgrad14])
    wgrad_err = max([wgrad_err] + [r["max_abs_err"] for r in wgrad14])

    # (e) the {"ragged": ...} line: each plan beside phase 5's uniform 2x2
    # plan from this run, with the conv work each plan's calls carry
    def conv_work(plan):
        return sum(conv_flops(c["x"], c["w"], c["stride"])
                   for c in conv_shapes(plan, TRAIN_BATCH // TRAIN_ACCUM))

    work5 = conv_work(make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=GRID[0], m=GRID[1],
                                           groups=groups, backend="cuda", device=dev).plan)
    summary14 = ("grid", "tile_rows", "tile_cols", "ragged_exec", "groups", "modes",
                 "crossover", "step_ms_cuda_events_median", "step_ms_host_median", "device_ms",
                 "device_ms_by_kernel", "idle_share", "peak_mem_bytes", "launches_per_microbatch")
    ragged = {"uniform_2x2_phase5": dict({k: train5.get(k) for k in summary14},
                                         conv_flops_per_microbatch=work5)}
    for label, r in train14.items():
        name, ex = label.rsplit("_", 1)
        work = conv_work(plans14[(name, ex)])
        ragged[label] = dict({k: r.get(k) for k in summary14}, conv_flops_per_microbatch=work,
                             conv_flops_vs_uniform=work / work5)
    serve_keys = ("p50_ms", "p99_ms", "img_per_s", "bucket8_forward_ms", "bucket8_dispatch_ms",
                  "bucket8_device_ms", "bucket8_idle_share", "launches_per_dispatch")
    print(json.dumps({"ragged": {
        "train": ragged,
        "serve": {"uniform_2x2_phase4": {k: serve4.get(k) for k in serve_keys},
                  **{k: {x: v[x] for x in serve_keys} for k, v in serve14.items()}},
        "spec_vs_padded_max_abs_diff": vs14, "kernel_ms_new_shapes": kernel_ms14, "card": smi,
    }}))
    phase14_launches = {k: sum(r["launches"][k] for r in train14.values()) + launcher14[k]
                        for k in launcher14}
    phase14_launches["conv2d_tile"] += sum(r["launches"] for r in serve14.values())
    auto_launches = {k: v + phase14_launches[k] for k, v in auto_launches.items()}
    print(json.dumps({"phase14_launches": phase14_launches}))

    lap("14")

    # -- 15. pipeline tails on the card -------------------------------------------
    # (a) the three plans: groups and stages held to PIPELINE_PLANS_416, the
    # code's launches a microbatch to PIPELINE_LAUNCHES
    plans15 = {}
    for name, (grid15, s15, m15, want_groups, want_stages) in PIPELINE_PLANS_416.items():
        p = make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=grid15[0], m=grid15[1],
                                 backend="cuda", device=dev, batch_norm=False,
                                 **pipeline_kw(s15, m15)).plan
        got = [(x.start, x.end, x.mode) for x in p.groups]
        per_mb, _ = launches_per_batch(p, TRAIN_BATCH // m15)
        print(f"phase 15 plan {name}: grid {grid15[0]}x{grid15[1]}, groups {got}, stages "
              f"{p.stages}, entry map {p.map_hw[p.pipeline_first]}, M {m15}, launches a "
              f"microbatch {per_mb}")
        check(got == [tuple(x) for x in want_groups], f"{name}: groups {got}")
        check(p.stages == tuple(map(tuple, want_stages)), f"{name}: stages {p.stages}")
        check(per_mb == PIPELINE_LAUNCHES, f"{name}: launches {per_mb} != {PIPELINE_LAUNCHES}")
        plans15[name] = p

    # (b) each plan trained as phase 5 (pipe2x2 with the planted hand-off
    # fault), beside the same no-BN stack's sync all-spatial plan
    train15 = {"sync_no_bn": train_phase(dev, smi, dict(groups=groups), label="train_sync_no_bn",
                                         plant_faults=False, batch_norm=False)}
    for name, (grid15, s15, m15, _, _) in PIPELINE_PLANS_416.items():
        r = train_phase(dev, smi, pipeline_kw(s15, m15), label=f"train_pipeline_{name}",
                        plant_faults=(name == "pipe2x2"), grid=grid15, accum=m15,
                        batch_norm=False, orders_from=train15["sync_no_bn"])
        check(r["launches_per_microbatch"] == PIPELINE_LAUNCHES,
              f"{name}: trained with {r['launches_per_microbatch']} launches a microbatch")
        train15[name] = r
    torch.cuda.empty_cache()

    # (c) the launcher, as a user runs a pipeline plan
    reset_counts()
    out15 = io.StringIO()
    with contextlib.redirect_stdout(out15):
        rc15 = train_launcher.main([
            "--arch", "yolov2-tiled", "--grid", "2", "--groups", "auto", "--hw-profile",
            PIPELINE_HW, "--pipeline", "2", "--no-batch-norm", "--input-hw", str(INPUT_HW[0]),
            "--depth", "16", "--batch", str(TRAIN_BATCH), "--grad-accum", "2", "--steps", "2"])
    print(out15.getvalue(), end="")
    check(rc15 == 0 and "stages=((0, 2), (2, 4))" in out15.getvalue(),
          "train launcher, --pipeline 2: no stages=((0, 2), (2, 4)) in its plan line")
    launcher15 = {f.__name__: f.launches for f in (conv2d_tile, conv2d_dgrad_tile,
                                                   conv2d_wgrad_tile)}
    want = {k: v * 2 * 2 for k, v in PIPELINE_LAUNCHES.items()}
    print(f"phase-15 launcher (--pipeline 2): {launcher15}")
    check(launcher15 == want, f"train launcher launches {launcher15} != {want}")

    # (d) B1-B3 at every per-tile shape of the phase-15 plans the earlier
    # phases did not hold: the stages' full maps, pure1x4's whole image
    new_tr15 = {shape_key(s): s for name, p in plans15.items()
                for s in conv_shapes(p, TRAIN_BATCH // PIPELINE_PLANS_416[name][2])
                if shape_key(s) not in held_bwd}
    print(f"phase 15 plans: {len(new_tr15)} new shapes")
    check(new_tr15, "the phase-15 plans give B1-B3 no new shape")
    fwd15 = [dict(fwd_row(s), piece=s["piece"]) for k, s in new_tr15.items() if k not in held_b1]
    bwd15 = [bwd_rows(s) for s in new_tr15.values()]
    dgrad15 = [d for d, _ in bwd15 if d]
    wgrad15 = [w for _, w in bwd15]
    kernel_ms15 = {}
    for rows15, what in ((fwd15, "conv2d_tile"), (dgrad15, "conv2d_dgrad_tile"),
                         (wgrad15, "conv2d_wgrad_tile")):
        kernel_ms15[what] = {k: sum(r[k] for r in rows15)
                             for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        kernel_ms15[what]["shapes"] = len(rows15)
        print(f"{what} at the {len(rows15)} new phase-15 shapes: kernel "
              f"{kernel_ms15[what]['ms']:.4f} ms, cudnn {kernel_ms15[what]['library_ms']:.4f} ms, "
              f"plain {kernel_ms15[what]['plain_ms']:.4f} ms, bound "
              f"{kernel_ms15[what]['bound_ms']:.4f} ms")
    print(json.dumps({"phase15_conv_shapes": fwd15}))
    print(json.dumps({"phase15_dgrad_shapes": dgrad15}))
    print(json.dumps({"phase15_wgrad_shapes": wgrad15}))
    serve_err = max([serve_err] + [r["max_abs_err"] for r in fwd15])
    dgrad_err = max([dgrad_err] + [r["max_abs_err"] for r in dgrad15])
    wgrad_err = max([wgrad_err] + [r["max_abs_err"] for r in wgrad15])

    # (e) the {"pipeline": ...} line: each plan beside the sync no-BN plan and
    # phase 5's BN plan from this run
    summary15 = ("grid", "groups", "modes", "stages", "microbatches", "pipeline_census",
                 "step_ms_cuda_events_median", "step_ms_host_median", "device_ms",
                 "device_ms_by_kernel", "idle_share", "peak_mem_bytes",
                 "modeled_peak_device_memory_per_tile", "launches_per_microbatch")
    print(json.dumps({"pipeline": {
        "train": {"bn_sync_phase5": {k: train5.get(k) for k in summary15},
                  **{k: {x: r.get(x) for x in summary15} for k, r in train15.items()}},
        "planted_handoff_fault_err_over_bar": train15["pipe2x2"]["step1"]["planted_fault_err_over_bar"],
        "kernel_ms_new_shapes": kernel_ms15, "card": smi,
    }}))
    phase15_launches = {k: sum(r["launches"][k] for r in train15.values()) + launcher15[k]
                        for k in launcher15}
    auto_launches = {k: v + phase15_launches[k] for k, v in auto_launches.items()}
    print(json.dumps({"phase15_launches": phase15_launches}))

    lap("15")

    # -- 16. wire codecs on the card -------------------------------------------
    wire_launches, fwd16, dgrad16, wgrad16, edge16 = wire_phase(
        dev, smi, train5["loss"][0], held_b1, held_bwd, fwd_row, bwd_rows, calib, images)
    serve_err = max([serve_err] + [r["max_abs_err"] for r in fwd16])
    dgrad_err = max([dgrad_err] + [r["max_abs_err"] for r in dgrad16])
    wgrad_err = max([wgrad_err] + [r["max_abs_err"] for r in wgrad16])
    auto_launches = {k: v + wire_launches[k] for k, v in auto_launches.items()}

    lap("16")

    # -- 17. one CUDA graph per batch bucket -------------------------------------
    launches17, serve17 = capture_phase(dev, smi, calib, images, step_s)
    auto_launches["conv2d_tile"] += launches17

    lap("17")

    # -- 18. elastic training ------------------------------------------------------
    launches18, lm18, fwd18, dgrad18, wgrad18, elastic18 = elastic_phase(
        dev, smi, held_b1, held_bwd, fwd_row, bwd_rows)
    serve_err = max([serve_err] + [r["max_abs_err"] for r in fwd18])
    dgrad_err = max([dgrad_err] + [r["max_abs_err"] for r in dgrad18])
    wgrad_err = max([wgrad_err] + [r["max_abs_err"] for r in wgrad18])
    auto_launches = {k: v + launches18[k] for k, v in auto_launches.items()}

    lap("18")

    # -- 19. LM serving ------------------------------------------------------------
    b6_serve = lm_serve_phase(dev, smi)

    lap("19")

    # -- 20. the dense configs: StableLM-2-1.6B, CodeQwen1.5-7B, Command-R 35B -------
    dense = dense_phase(dev, smi)

    lap("20")

    # -- 21. the Mixture-of-Experts configs: Mixtral-8x22B, Jamba-v0.1-52B ----------
    moe = moe_phase(dev, smi)

    lap("21")

    # -- 22. DeepSeek-V3-671B: MLA, the shared expert, the MTP head -------------------
    ds = deepseek_phase(dev, smi)

    lap("22")

    # -- 23. Qwen2-VL-2B: M-RoPE and patch embeddings ---------------------------------
    vl = vl_phase(dev, smi)

    lap("23")

    # -- 24. Whisper-medium: the encoder-decoder and cross-attention --------------------
    wsp = whisper_phase(dev, smi)

    lap("24")

    # -- 25. the sequence-sharded Mamba2 forward and decode ---------------------------
    sp = seq_shard_phase(dev, smi)

    lap("25")

    # -- 26. remat "dots" -------------------------------------------------------------
    dots = remat_dots_phase(dev, smi)

    lap("26")

    # -- 27. the captured training step and decode (27(c) ran in phases 7, 10 and
    # 20-24(b), 27(d) in phases 19-24's serving) ------------------------------------
    t27 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_capture_") as root27:
        cnn27 = capture_cnn_phase(dev, smi)
        el27 = capture_elastic_phase(dev, smi, root27)
    phase27_s = time.perf_counter() - t27
    run_s = time.perf_counter() - t_run
    print(json.dumps({"capture_phase": {
        "cnn_step_ms_eager_vs_replay": [cnn27["step_ms_eager_steady_median"],
                                        cnn27["step_ms_replay_median"]],
        "elastic_graphs": el27["graphs"], "elastic_bitwise": el27["bitwise_equal_to_eager"],
        "phase27ab_s": phase27_s, "run_s": run_s, "card": smi}}))

    lap("27")

    # -- 28. the dry run held against the card -----------------------------------------
    dryrun_phase(dev, smi, qwen7)

    lap("28")

    # -- 29. one tile per process: phase 5's plan on torch.distributed ranks -------------
    launches29, launches29_by_plan = dist_phase(
        dev, smi, train5, train13["train_hybrid"], edge16,
        {k: train14[k] for k in ("cluster_spec", "cluster_padded")},
        {k: train15[k] for k in ("pipe2x2", "pure1x4")}, elastic18, cnn27, el27, serve17,
        served4)
    auto_launches = {k: v + launches29[k] for k, v in auto_launches.items()}

    lap("29")
    print(json.dumps({"phase_seconds": laps, "run_s": time.perf_counter() - t_run}))

    kernels = [
        kernel_entry("conv2d_tile", "src/repro_torch/kernels/conv2d_tiled/csrc/conv2d_tile.cu",
                     "src/repro/kernels/conv2d_tiled/kernel.py:140", rows,
                     launches + train_launches["conv2d_tile"] + auto_launches["conv2d_tile"],
                     serve_err),
        kernel_entry("conv2d_dgrad_tile",
                     "src/repro_torch/kernels/conv2d_tiled/csrc/conv2d_dgrad_tile.cu",
                     "src/repro/kernels/conv2d_tiled/backward.py:59", dgrad_rows,
                     train_launches["conv2d_dgrad_tile"] + auto_launches["conv2d_dgrad_tile"],
                     dgrad_err),
        kernel_entry("conv2d_wgrad_tile",
                     "src/repro_torch/kernels/conv2d_tiled/csrc/conv2d_wgrad_tile.cu",
                     "src/repro/kernels/conv2d_tiled/backward.py:127", wgrad_rows,
                     train_launches["conv2d_wgrad_tile"] + auto_launches["conv2d_wgrad_tile"],
                     wgrad_err),
        kernel_entry("flash_attention_fwd",
                     "src/repro_torch/kernels/flash_attention/csrc/flash_attention_fwd.cu",
                     "src/repro/kernels/flash_attention/kernel.py:127", fa_rows[:1],
                     lm_launches["flash_attention_fwd"] + lm18["flash_attention_fwd"]
                     + dense["flash_attention_fwd"] + moe["flash_attention_fwd"]
                     + vl["flash_attention_fwd"] + wsp["flash_attention_fwd"]
                     + dots["flash_attention_fwd"], fa_err),
        kernel_entry("rmsnorm", "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                     "src/repro/kernels/rmsnorm/kernel.py:42", rms_rows[:1],
                     lm_launches["rmsnorm"] + mamba_launches["rmsnorm"] + lm18["rmsnorm"]
                     + b6_serve + dense["rmsnorm"] + moe["rmsnorm"] + ds["rmsnorm"]
                     + vl["rmsnorm"] + wsp["rmsnorm"] + sp["rmsnorm"] + dots["rmsnorm"],
                     rms_err),
        kernel_entry("ssd_chunk_fwd", "src/repro_torch/kernels/ssd_chunk/csrc/ssd_chunk_fwd.cu",
                     "src/repro/kernels/ssd_chunk/kernel.py:98", ssd_rows[:1],
                     mamba_launches["ssd_chunk_fwd"] + moe["ssd_chunk_fwd"]
                     + sp["ssd_chunk_fwd"], ssd_err),
    ]
    for k in kernels:
        k["launches"] += CAPTURED_LAUNCHES.get(k["name"], 0)
        if k["name"] in launches29:
            # phase 29's share of B1-B3's launches, by plan (every rank's)
            k["phase29_launches_by_plan"] = {label: c[k["name"]]
                                             for label, c in launches29_by_plan.items()}
    check(all(k["launches"] > 0 for k in kernels), f"launches {[k['launches'] for k in kernels]}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
