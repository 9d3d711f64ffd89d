#!/usr/bin/env python3
"""On-card smoke run of seldon_core_tpu_torch (one NVIDIA H100).

    python3 chip_smoke.py [--phases kernels,spec,...]

Drives the port's main path on the card and fails (non-zero exit, no
result line) if any phase fails. ``--phases`` runs a subset of
``kernels, small, serve, engine, small-sched, sched, prefix, pressure,
spec, spec-pressure, dh256, f32, disagg, kvtier, migration, telemetry,
fronts, zoo, rag, explain, moe, train, model, controlplane, tools, mesh,
predict-mesh``
(device and build always run; the
result lines print only when every phase ran, as with no argument):

1. Device: the card's name and power limit (nvidia-smi) and torch's view.
2. Build: compiles every CUDA kernel of the path from ``ops/csrc``.
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   same inputs, at the shapes the serving path gives it (each route at
   both its block sizes: wgmma at bf16 head dims 8-256, those off
   64/128/256 padded by TMA; mma at f32, llm-1.26b-f32's prefill
   included, at bf16 Dh 12 and 7 and through an odd T stride; ragged T
   and a key-length mask), with times -- per call from the host (``call_ms``) and
   on the device from a CUDA graph of 20 launches (``device_ms``) --
   the PyTorch library call (SDPA; with a key-length mask, SDPA with the
   causal and key-length mask as an explicit boolean ``attn_mask``) timed
   both ways as a yardstick, the bound, TFLOP/s and the share of the
   bound.
4. Small model on the card: the continuous batcher's greedy and seeded
   tokens equal ``DecoderLM.generate`` on the same device and weights.
5. Serve: the ``llm-1.26b`` configuration (full width, random weights from
   seed 0) behind the REST microservice on CUDA; concurrent greedy and
   seeded requests across the prefill buckets; checks response shapes,
   repeatability, and that every prefill dispatch went through the flash
   kernel (launch counters reset just before, read just after); prints
   tokens/s, TTFT p50 and peak device memory; then compares full-width
   prefill logits with the kernel against the plain attention.
6. Engine: the same configuration behind the inference-graph engine
   (``EngineApp`` over one in-process GENERATE_SERVER unit), driven with
   the serve phase's waves (same checks and numbers, flash launches
   counted over the whole phase); a greedy request alone must give the
   serve phase's tokens; SSE streams must concatenate to unary; a
   dropped stream must cancel its request and free the lane; a
   RAG_PROMPT_BUILDER -> GENERATE_SERVER graph and a remote REST hop must
   give the single-unit tokens; a 1 ms deadline must be refused (504 or
   429); gRPC Predict and GenerateStream must equal REST when grpcio
   imports (else one line says the gRPC front was not driven); and the
   client-side latency of a 1-token request through the engine against
   a microservice over the same generate server, median of 20, and of
   a SIMPLE_MODEL request (host only), median of 200; then the serve
   waves through the engine and then through that microservice, their
   tokens/s, TTFT and TPOT side by side.
7. Small scheduler (float32, the small model of phase 4): the batcher's
   configurations A-E (as in phase 8, ``MIN_ATTN_BUCKET`` lowered so
   that depth groups split), P (the prefix cache on: the second pass
   hits every prompt the first published) and Q (the HBM ledger shrunk
   to one lane during the second pass: lanes preempted and resumed) give
   the same tokens, greedy and seeded, one request at a time and all
   together; S1-S6 (speculation: a separate Dh 8 draft, an early-exit
   self-draft alone, with fused 64, with forced depth groups and
   prefill_chunk, with the prefix cache, and under a shrink that fires
   reclaim rungs 2 and 3) give A's tokens for every greedy request and
   repeat their seeded ones; no decode graph is captured after
   ``warm()``.
8. Scheduler (llm-1.26b at full width and depth, bf16, on the engine
   phase's weights; 8 slots, steps_per_poll 16, pipeline_depth 3,
   attn_bucket 128): configurations A (every knob off, CUDA graphs off:
   the eager path, kept as the comparison), B (graphs on), C (fused
   decode K 64), D (C + depth groups 4 with a forced split), E (C +
   prefill_chunk 256) and F (depth groups 4, default cost model), each
   warmed for the serve phase's prompt lengths and driven with the serve
   waves, every wave queued whole so that each run has one batch
   composition; one run each (each run repeats its probe wave); four requests of the mixed wave stop at the token their
   knobs-off run emitted at steps 3, 17, 40 and 63. Fails unless B and C
   equal A token for token, every configuration repeats itself, every
   stop fires where A's does, no graph is captured after ``warm()``,
   every whole-prompt prefill launches the flash kernel, D splits and E
   chunks. Reports per configuration tokens/s, TTFT p50/p99, TPOT p50,
   peak memory, the graph pool's growth, graphs and capture seconds,
   graph launches per decode step, realized K, group bursts and
   occupancy, prefill chunks, and how many of D's, E's and F's streams
   equal A's (bf16 over another read may round otherwise: reported, not
   gated).
9. Prefix cache (llm-1.26b, bf16, the JAX package's shared-prefix
   scenario: 4 system prompts of 384 tokens, 32 prompts of a system
   prompt + 64 user tokens, 64 new tokens, 16 slots, cache length 640,
   2 GiB of cache): cache on against off, alternated on, off, on in one
   process, each run priming one request per system prompt and then
   queuing the 32 whole. Fails unless every request answers 64 tokens,
   each cache-on wave makes 32 hits and no miss, the on-runs repeat,
   every whole prefill launched the flash kernel and no graph is
   captured after ``warm()``. Reports tokens/s, TTFT p50/p99, TPOT p50,
   the prefix counters, the cache's bytes, peak allocated and reserved
   memory and the bf16 on-vs-off equality count; then a hit under
   prefill_chunk 128 (a 300-token suffix chunked from the splice).
10. HBM pressure (llm-1.26b, the scheduler's B plus the ledger): the
   mixed wave queued whole and streamed while the fault config's
   pressure section shrinks the ledger to two lanes at the deepest
   bucket for 24 polls, then four requests under a 64-byte budget never
   restored. Fails unless lanes are preempted and all resume, every
   request answers 64 tokens, every stream's spans equal its tokens, the
   tiny-budget run ends and no graph is captured after ``warm()``;
   reports the bf16 equality with the pressure-free B run.
11. Speculation (llm-1.26b, bf16, 4 slots, cache 512, built through
   GenerateServer's parameters): four 128-token greedy prompts with 256
   new tokens and one seeded request, off (steps_per_poll 8) against on
   (steps_per_poll 4, speculate_tokens 4, draft_layers 6), off, on, on.
   Fails unless every request answers 256 tokens, the on-runs are
   token-identical, no graph is captured after ``warm()``, a round emits
   1..5 tokens and every prefill (target and draft) launched the flash
   kernel; reports tokens/s, TTFT p50/p99, TPOT p50, tokens per round,
   rounds, graph replays per round, peak memory and the bf16 greedy
   equality count on vs off.
12. Dh 256 (``llm-1.26b-dh256``: llm-1.26b with Gemma-2B's attention
   shape, 8 heads / 1 kv head, Dh 256, bf16, random weights from seed
   0), built through GenerateServer's typed parameters as the serve
   phase's server and driven twice with the serve waves, each queued
   whole. Fails unless the two runs are token-identical, every greedy
   stream equals ``generate()`` on the card or parts from it at a
   near-tie of the logits, every prefill launched the flash kernel and
   only on ``wgmma bfloat16 Dh 256``, no graph is captured after
   ``warm()``, and full-width prefill logits agree with the plain
   attention's. Reports tokens/s, TTFT and TPOT beside the serve phase's,
   and a B=1, T=1024 prefill's time with the flash kernel's share.
13. Float32 (``llm-1.26b-f32``: llm-1.26b at float32, random weights
   from seed 0), served as phase 12 serves Dh 256: fails unless the two
   runs are token-identical, every greedy stream equals ``generate()``
   or parts from it where the candidates' logits are within 1e-3, every
   prefill launched the flash kernel and only on ``mma float32 Dh 128``
   (3xTF32), no graph is captured after ``warm()``, and the B=1, T=1024
   prefill logits are within 1e-3 of the plain attention's. Reports
   tokens/s, TTFT, TPOT, peak memory, and a B=1, T=1024 prefill's device
   time with the flash kernel's share.
14. Disaggregated prefill/decode (llm-1.26b, bf16, seed-0 weights,
   GenerateServers built from typed parameters, 8 slots): a unified, a
   prefill-role and a decode-role server (prefix cache on) in this
   process over the loopback transport, then a decode role over TCP to
   a prefill role started as a second process (the microservice CLI,
   ``role=prefill``, ``kv_port``), which must reuse the kernel library
   this process built. Fails unless three greedy requests of the mixed
   wave (buckets 32, 128, 1024) and its two seeded ones, each alone,
   give the unified server's tokens over both transports,
   seeded requests repeat, the shared-prefix traffic ships suffix-only
   slabs (``kv_transfer_bytes_saved`` > 0), a transfer corrupted by a
   ``SELDON_FAULTS`` peer rule is refused typed and retried on the next
   peer with the same tokens, killing the prefill process degrades to
   local prefill with the same tokens (``degraded_local_prefill``) and
   every prefill in this process launched the flash kernel. Reports the
   export of a 1024-position slab (time, bytes, codec rates), TCP
   request-to-slab times full and suffix-only, admit_remote to first
   credit, the mixed wave streamed over loopback, TCP and unified
   (tokens/s, client-side TTFT p50/p99, TPOT p50) and the peak memory.
15. Host KV tier (llm-1.26b, the scheduler phase's B with the ledger and
   a 2 GiB prefix cache): a 384-token system prompt primes the cache,
   the pressure phase's mixed wave runs under its 24-poll shrink, then
   a prompt sharing the system prompt comes alone; tier off, on (4 GiB)
   and too small for any checkpoint (one attention bucket's slab). Fails unless every stream
   and the warm request equal the tier-off run's, the tier-on run
   demoted a prefix and promoted it for the warm hit, resumed lanes by
   copy-back with no replay fallback, the small tier resumed by replay
   only, and no graph is captured after ``warm()``. Reports ms per
   copy-back resume against a replay resume, and per promote against a
   re-prefill of the same prompt.
16. Migration (llm-1.26b, bf16, `GenerateServer`s from typed parameters
   with `resume_tokens`; random weights from seed 0, seeds 1 and 2 the
   swap target and the other tenants; 96 new tokens): two requests
   (greedy and seeded, buckets 128 and 512) each streamed alone and drained
   mid-decode along a chain of servers over loopback (`drain_to`), the
   mixed wave streamed and drained, one request drained over TCP through
   the peer engine's `/drain`, a greedy and a seeded stream resumed on a
   peer from their last keyless resume token after their member is
   killed, `/weights/swap` seed 0 -> 1 under three in-flight requests and
   the straggler bound under `resume` and `fail`, then a server with
   three tenants (a 10 GiB pager) interleaved and behind a backlog. Fails
   unless every request alone and every in-flight one equals the
   undrained run's alone (the wave's equality is reported), spans add
   up with none re-sent, a mangled token answers 400 and one of another
   weight version 409, requests after the swap and each tenant's equal a
   fresh server's on those weights alone, the swap purged the prefix
   cache, no graph is captured across the swap and the page-ins, the
   starvation bound forces a switch, an unknown tenant answers 404 and
   every whole-prompt prefill launched the flash kernel. Reports drain
   and resume ms, the swap's checkpoint load, stage and flip ms and peak
   memory, and each page-in's decode, stage and flip ms.
17. Telemetry (llm-1.26b, bf16, seed-0 weights, `GenerateServer`s from
   the serve phase's typed parameters plus fused K 64 and depth groups
   4): a profiler-off boot gives the decode graph count and the tokens
   alone of the serve probe, greedy_128 and seeded_500; a boot with the device-time ledger (CUDA
   event pairs, 3350 GB/s), the flight
   recorder (512) and TTFT/TPOT objectives serves the serve waves,
   after the profiler-off boot (off, on: tokens/s,
   TTFT and TPOT side by side, the SM clock after each). Prints the ledger's device ms and share per kind, the busy and idle
   share and MBU over the waves, the live gauges, the scheduler's phases, the
   dump's records and the burn verdicts. Fails unless each request alone
   equals the profiler-off boot's (and greedy_20 the serve phase's when
   it ran), the graph count equals the profiler-off boot's with none
   captured after ``warm()``, the ledger's ms per step of its most
   frequent fused burst lies within 25% of CUDA events around the same
   replayed burst, a retune of fused K and depth groups through the
   engine's ``/retune`` under in-flight traffic applies with no graph
   captured and each request alone unchanged after it, an out-of-census
   K answers 409, and ``/flightrecorder`` and ``/fleet`` answer 200 with
   the JAX payload keys. Prints, not gated, a B=1 T=1024 prefill's ledger
   (stream) time beside torch.profiler's kernel sum.
18. Fronts (llm-1.26b, bf16, seed-0 weights, a GenerateServer from the
   serve phase's typed parameters): (a) an FBSServer over it: two
   20-byte strData prompts, a wave of 8 (20-900 bytes) on 8 connections,
   the probe and half the wave (20-900 bytes) each alone over FBS equal to
   the same prompt alone over REST
   ``/predict`` (a strData prompt is greedy with the server's default 32
   new tokens: the FBS wire carries no sampling fields), FBS and REST
   client ms side by side, an ndarray request answered by a FAILURE
   frame carrying the server's ValueError on a connection that then
   serves again; (b) the request-logger collector started through its
   CLI, an engine built with ``RequestLogger.from_env()`` against one
   without a logger, 16 generate records alone through each,
   alternated: equal tokens, 16 documents at ``/entries``, the sink's
   posted 16, dropped and errors 0, engine latency and TTFT on vs off;
   (c) a FileQueue of the 16 records and a poison record drained through
   the engine by ``IngestConsumer(concurrency=8)``, stopped after half
   and restarted: each record once in the results, the poison
   dead-lettered, the commit at the queue's end (equality with alone
   reported: bf16 rounding depends on batch composition), then a second
   group at concurrency 1 whose every result equals the record alone;
   records/s and per-record p50/p99; (d) ``/openapi.json`` 200 on the
   engine and the microservice, paths equal to each app's routes; (e)
   ``python -m seldon_core_tpu_torch.microservice PidGenerateServer
   REST --workers 2`` (a GenerateServer subclass tagging its pid): the
   16 records on fresh connections answered by both pids, each equal to
   the record alone, SIGTERM ending both workers with code 0 within 30
   s; boot times and each worker's memory from nvidia-smi. The flash
   kernel's launches over (a)-(d) join the ``kernels`` line.
19. Zoo (the predict path, full width, random weights from seed 0): (a)
   ResNet-50 (bf16, 1000 classes, 224x224) as a JAX_SERVER unit of an
   engine with ``seldon.io/microbatch`` (max-batch 128, timeout 600 ms)
   and ``seldon.io/max-inflight`` 4, every batch shape the batcher can
   produce warmed first, driven over REST with binary SeldonMessages of
   raw uint8 [32, 224, 224, 3] photo-like images at concurrency 16 for
   2.5 s (a 429 backs off 20 ms); (b) BERT-base (bf16, 2 classes) the same
   way over gRPC ``Seldon/Predict`` (REST binary protobuf when grpcio
   does not import; the line says which) with raw int32 [16, 128] token
   ids, max-batch 256, timeout 25 ms, concurrency 64 for 2.5 s. Each prints
   rows/s, req/s, p50/p99, flushes, rows per flush, padded rows, 429s,
   H2D ms per flush, peak memory and MFU against 989 TFLOP/s, and one
   bf16 forward at the max batch in CUDA-event device time; fails on any
   other status, a wrong or non-finite response, or a device put that
   fell back to the host fuse; prints, not gated, the bf16 |dlogit| and
   top-1 agreement of 4 requests micro-batched against alone. Then, at
   float32 with TF32 off: 4 requests micro-batched (one flush) equal the
   same requests alone for ResNet-50 and BERT-base, and the card equals
   the CPU on the same params for ResNet-50, BERT-base, ViT-B/16 and the
   iris MLP (2 rows each), both within 1e-4 of the largest |logit|; (c)
   ViT-B/16 and the iris MLP through the REST microservice with
   TorchServer (every MLP row sums to 1); (d) EpsilonGreedy (epsilon 0.1,
   seed 7), then ThompsonSampling, over two ResNet-50 units (seeds 0 and
   1) in one engine graph: 200 single-image requests, each rewarded
   through ``/api/v0.1/feedback`` (numpy seed 1, p 0.2 and 0.8); the
   router ends on branch 1 with 200 tries, most on branch 1, routing as
   the same router driven directly, and its state persisted, the engine
   rebuilt around the restored router and the state equal. The flash
   kernel's launches over the phase (none: no zoo model runs it) join the
   ``kernels`` line.
20. RAG (``llm-rag-chip``: a BERT-base embedder with 256 classes as the
   query embedding, a 256-document corpus at d_embed 256 drawn by the
   port's threefry (seed 7), top-8 retrieval, an MLP reranker,
   RAG_PROMPT_BUILDER with 32 new tokens greedy, and llm-1.26b at
   max_seq 256 with 4 slots; bf16, random weights from seed 0) on the
   port's GraphExecutor, hop by hop and with ``seldon.io/fuse: "true"``:
   (a) 24 requests of 64 query tokens (numpy seed 11) interleaved, the
   fused responses byte for byte the hop-by-hop ones (puid and TIMER
   metrics dropped), requestPath the five units, the segment [embed,
   retrieve, rerank] a prefix continuing at the prompt builder with 24
   dispatches and no fallback, one traced fused request with one
   ``gen.fused_segment`` span and no stage span, and a chaos leg (1 ms of
   injected latency on rerank: a counted ``faults`` fallback, rerank in
   no segment, 4 requests equal to hop); prints p50/p99 of both paths,
   the segment's span against the hop stage spans, the segment's and the
   embed forward's eager and device (CUDA graph) times, peak memory and
   the flash launches; (b) at float32 with TF32 off, the small RAG
   configuration of the tests on the card and the CPU over the same
   weights: the embed output within 1e-5 of its largest |value|, equal
   indices, doc rows and greedy tokens, and the card's rng corpus within
   4 ulps of the CPU's; (c) the VAE, seq2seq and Mahalanobis detectors
   and KS drift as input TRANSFORMERs before the iris MLP, on the card
   and the CPU: equal flags, scores within 1e-5 relative, the same drift
   verdicts (unshifted windows pass, shifted ones flag). The flash
   kernel's launches over (a) join the ``kernels`` line.
21. Explain (``/explain`` and the rest of the component inventory): (a)
   an integrated-gradients ``Explainer`` (32 steps) behind the REST
   microservice over ResNet-50 (224x224, 1000 classes, the port's
   seed-0 weights written as ``params.npz``) at bf16: 4 photo-like
   images sent as float, finite attributions and targets the argmax of
   the prediction; the client latency, one explanation's CUDA-event time
   and one forward-backward pass of the folded alphas; then at float32
   with TF32 off, IG from a gray baseline and saliency on 2 images
   against the same explainers on the CPU and against the same forward
   in float64 on both: the same targets, card vs CPU within 1e-2
   relative L2, the card's error against float64 at most 2x the CPU's
   plus 1e-3, float64 card vs CPU within 1e-5 of the largest, the same
   request twice bit-identical, IG complete within 5%; (b) the iris MLP (f32) served
   by the port's engine on the card, an ablation and an anchor_tabular
   explainer (150 seeded background rows) pointed at it over REST:
   ablation within 1e-6 and the same anchors, precision and coverage as
   against the model on the CPU; (c) ``VAEOutlier.fit`` and
   ``Seq2SeqOutlier.fit`` at their default widths and 25 epochs on the
   card and on the CPU: the same flags on seeded inliers and planted
   outliers, scores within 1e-3, seconds per epoch; (d) SKLEARN,
   XGBOOST, MLFLOW, TENSORFLOW and SAGEMAKER servers resolved from graph
   specs give their missing-library errors (none "not ported"), and
   TRITON_SERVER answers through the engine on a stub transport. The
   flash kernel's launches over the phase (none) join the ``kernels``
   line.
22. MoE (``llm-1.26b-moe8``: llm-1.26b with a top-1 switch mixture of 8
   GELU experts, capacity factor 1.25, in every layer: 4.86 B parameters,
   bf16, random weights from seed 0; and a small float32 model with 4
   experts): (a) on the small model, greedy requests alone whose prompts
   fill their prefill bucket equal ``generate()``, a whole batch of six
   requests over four lanes (greedy and seeded, staggered budgets, queued
   at once, ``pipeline_depth`` 1) from graph replay equals the same batch
   eager, and a seeded request alone repeats, graph == eager; (b)
   llm-1.26b-moe8 through GenerateServer with the serve phase's typed
   parameters and the device-time ledger, the serve waves (2 + 8 + 2
   requests of 20-900 prompt tokens, 64 new tokens) twice, each wave
   queued whole: every request answers 64 tokens, both runs and each
   run's probe repeat token for token (the experts' capacity counts every
   row of a call, so the same batch must give the same tokens), every
   prefill launched the flash kernel, no graph is captured after
   ``warm()``; prints tokens/s, TTFT, TPOT, peak memory, the ledger's
   split, busy share and MBU, and the decode step beside its weight-read
   bound (every expert read once per step); (c) torch.profiler's device
   time of the MoE layer's stages (router and softmax, dispatch, expert
   matmuls, combine) in one B=8 decode step and one B=1, T=1024 prefill,
   each stage alone at layer 0's shapes in CUDA-event-timed graphs, and
   the share of rows dropped past capacity in a separate forward. Prints
   the phase's wall time; its flash launches join the ``kernels`` line.
23. Train (the parallel training step, ``parallel/train.py``): a
   one-rank NCCL group joined through ``initialize_distributed`` with a
   file coordinator and the mesh {data 1, stage 1, seq 1, model 1};
   (a) ``make_train_step`` on llm-1.26b at full width and depth (bf16
   compute over float32 params, seed-0 weights, TF32 off), 5 SGD steps at
   lr 1e-2 on one seeded batch [4, 1025]: fails unless every loss is
   finite and the last below the first; prints each step's ms, the steady
   ms per step, tokens/s, MFU (3 x ``flops_per_row(1024)`` x 4 a step
   against 989 TFLOP/s), peak memory and the losses, then one
   forward-backward under torch.profiler (kernel sum, top kernels); (b)
   one float32 step of llm-1.26b's width at 2 layers, B 1, T 256, on the
   card against the CPU from the same weights: the loss within 1e-4, each
   gradient leaf within 1e-4 and each updated parameter leaf within 1e-5
   of its largest |value|; (c) two steps of llm-1.26b-moe8 at full width
   and 4 layers (depth cut for the time budget), ep 1: finite losses. The
   flash kernel must not launch (training attends in plain PyTorch, as in
   the JAX package); its count (0) joins the ``kernels`` line.
24. Model (on the engine phase's copy, after every serving phase: a
   profiler run may slow later launches): full-width prefill time per
   bucket, with the flash kernel's device time inside the 128 and 1024
   ones (torch.profiler), a prefix hit's suffix prefill against the full
   512-bucket prefill (wall and device-busy time), a decode step's wall
   time beside its device-busy time and weight-read bound, and a
   16-step decode burst through the batcher, eager against CUDA-graph
   replay: wall and device span per step, then device-busy time, device
   operations, host launches and busy share per step from torch.profiler
   over a 2-step eager burst and a replayed 16-step one; then one
   speculation round (4 steps of
   a 6-layer early-exit draft, the W = 5 verify chunk, acceptance)
   against 5 decode steps at B = 4, attention 512, in device-busy time
   and device operations.
25. Control plane (``seldon_core_tpu_torch/controlplane``, the port's
   ``sdctl`` as processes): ``sdctl controller --subprocess-runtime``
   with its gateway; (a) ``sdctl apply`` of a GENERATE_SERVER
   SeldonDeployment of llm-1.26b (full width and depth, bf16, seed 0, the
   serve phase's parameters without ``device``) -> Available; three
   greedy requests alone through the gateway (one of them through the
   port's ``SeldonClient``) must equal the serve phase's alone tokens,
   the member must be
   ``seldon_core_tpu_torch.engine_main`` with no device parameter and
   CUDA memory on the card in its ``/fleet``, and the flash kernel must
   launch there (its count joins the ``kernels`` line); the gateway's
   overhead against the member's port (1-token requests, ABBA, median
   of 4); (b) an annotation change: create-before-delete with two
   generations on the card while a client sends requests back to back,
   every one 200 with its alone tokens; (c) at llm-1.26b's widths and 8
   of 24 layers (depth cut for the time budget), one slot:
   ``seldon.io/disagg`` (one prefill, one decode member) equal to the
   unified deployment with the decode member importing KV slabs,
   ``sdctl scale`` 2 -> 1 with requests queued on both members, the
   removed one draining over ``/drain`` and every request answering
   with its alone tokens, and a shadow rollout on an in-process
   ``sdctl controller`` promoted by its mirrored samples with
   ``diff_responses`` finding no token diff; (d) ``sdctl delete``: no
   member left, both controllers stopped, the card's memory back.
   Prints apply -> Available, client ms, peak memory, flip, drain and
   teardown seconds.
26. Tools (the user's tools against the port's engines on the card):
   one engine serving ResNet-50 (bf16, 224, micro-batched as the zoo
   phase's (a), without its admission cap), one the iris MLP at float32;
   (a) the port's ``tester`` fuzzes the MLP from a contract (every
   response inside the contract's targets) and ``SeldonClient`` over
   REST, and over gRPC where ``import grpc`` works, answers what a plain
   HTTP call answers; (b) ``python -m seldon_core_tpu_torch.loadtester``
   as a process of its own against ResNet-50 over REST with ``--binary``
   (2 workers x 4 clients, 3 s): no failure, its table, rows/s and the
   micro-batcher's flushes; (c) the batch scorer over 256 MLP rows with
   ``--batch-rows 8`` and concurrency 16: one output line per row in
   input order, each row equal to the same row scored alone (float32,
   TF32 off, within 1e-4 of the largest); (d) the native engine
   (``native_engine.NativeEngine``) fronting the port's microservice on
   the card as a remote REST unit: its answers equal the port's Python
   engine's on the same spec, and the load tester's rows/s against both
   for the same seconds; where the machine lacks ``protoc`` or the
   protobuf headers (probed before any build), one line says the native
   engine was not driven. The flash kernel launches 0 times (no model
   here runs it).
27. Mesh (sharded generate serving): llm-1.26b (full width and depth,
   bf16, seed 0, 8 slots) through ``GenerateServer`` on an explicit
   ``ServingMesh`` of data=1, model=4 with every position on cuda:0 (the
   layout a 4-card cell would use: params and KV cache stored in 4
   blocks, each layer gathered onto the compute device), beside an
   unsharded twin with the same knobs (fused K 64, a 2 GiB prefix
   cache, prefill_chunk 256, the ledger; pipeline_depth 1, so the two
   take the same scheduling decisions). Fails unless (a) greedy_20,
   seeded_20 and greedy_128 alone equal the twin's and the serve
   phase's alone tokens; (b) two prefix splices, the chunked
   seeded_500, and the mixed wave under a 24-poll ledger shrink
   (the sharded budget a quarter of the twin's: its ledger prices one
   position) equal the twin's token for token with the same hits,
   chunks, fused bursts, preemptions and resumes (at least one of each);
   (c) no graph is
   captured after ``warm()``; (d) the census names 7 of 12 leaves split
   and the ``gen_mesh_*`` gauges say 4 positions, model 4, kv_shard 4
   and the param shard bytes; (f) the flash kernel launches on the
   sharded server as often as on the twin (once a layer for every
   whole-prompt prefill). Prints (d) beside nvidia-smi's
   memory.used and (e) a B=8 decode step's wall and device time
   sharded against unsharded at attention 128 and 1024, and the
   gathers' and re-slices' own device time. One card cannot show the
   capacity a mesh buys across cards.
28. Predict mesh (sharded predict: ``TorchServer`` and the
   ``Explainer`` on an explicit ``ServingMesh`` with every position on
   cuda:0, beside an unsharded twin): (a) BERT-base bf16 [16, 128] on
   data=1, model=4 answers 3 batches through the engine with the twin's
   logits bit for bit, its matmul weights and their bf16 copies split
   in 4; (b) ResNet-50 bf16 224 on data=2, model=4 through a
   micro-batched engine fuses four concurrent 4-image requests on the
   compute device into one 16-row forward whose rows equal the twin
   engine's bit for bit, and refuses a 3-image request (it does not
   tile data=2); (c) IG with the meshed Explainer on the explain
   phase's ResNet-50 (8 steps) equals the unmeshed Explainer's
   attributions bit for bit; the flash kernel launches 0 times. Prints
   (d) BERT-base's parameter bytes per position against the whole,
   nvidia-smi's memory.used, and one forward's device time meshed
   against unmeshed (the difference is the gathers).
29. The ``kernels`` JSON line (the flash kernel on the main path, its
   Dh 256 instance on the dh256 phase's and its float32 instance on the
   f32 phase's), then the final ``{"ok": true, ...}`` line.

Exits 2 when CUDA is unavailable, 1 on any failure.
"""

from __future__ import annotations

import asyncio
import collections
import gc
import http.client
import io
import json
import math
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
# bandwidth; float32 runs on the tensor cores as 3xTF32, three TF32
# products (495 TFLOP/s) per float32 product
PEAK_FLOPS = {"bfloat16": 989e12}
PEAK_TF32_FLOPS = 495e12
TF32_PASSES = 3
PEAK_BYTES_S = 3.35e12

# llm-1.26b: the flagship generate configuration of the JAX package's
# benchmark (seldon_core_tpu/modelbench.py, "llm-1.26b")
LLM_1_26B = {
    "vocab_size": 32000, "d_model": 2048, "n_layers": 24, "n_heads": 16,
    "n_kv_heads": 8, "d_ff": 5632, "max_seq": 1024, "residual_scale": 0.05,
    "dtype": "bfloat16", "seed": 0,
}

# Tolerances, kernel against its plain version on the same inputs:
#  * float32: the two differ only in summation order and in exp/scale
#    rounding, ~1e-6 relative over up to 1024 keys;
#  * bfloat16: both round an f32 result to bf16 (a different summation
#    order may flip the last bit: one ulp, 2**-6 at |o| < 4), and the
#    kernel feeds the tensor cores bf16 probabilities (relative 2**-9 per
#    weight, as FlashAttention does): two ulps at |o| < 4.
TOL = {"float32": 5e-5, "bfloat16": 2.0 ** -5}
# Full-width prefill logits, kernel vs plain attention in the same bf16
# model: the attention outputs may differ by a bf16 ulp per layer, and
# that noise compounds over 24 layers into unit-scale logits.
LOGITS_TOL = 0.25
TOP1_MIN_AGREEMENT = 0.75


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Device time of one call: ``launches`` calls captured once in a CUDA
    graph, the graph replayed ``reps`` times between CUDA events; the
    median replay over ``launches``. The host's launch cost is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as torch asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return sorted(times)[len(times) // 2]


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi unavailable"
    log(card)  # the card's name and power limit, as nvidia-smi prints them
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device cuda:0 {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    # parity phases compare in true float32: no TF32 in matmuls or convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] allow_tf32 matmul=False cudnn=False")
    return card


def phase_build():
    from seldon_core_tpu_torch.ops import _build, flash_attention

    t0 = time.perf_counter()
    flash_attention.build()
    dt = time.perf_counter() - t0
    lib = _build.library_path("flash_attention.cu")
    log(f"[build] flash_attention.cu -> {os.path.relpath(lib, HERE)} in {dt:.2f} s")
    ptxas = lib.with_name(lib.stem + ".ptxas.txt")
    if ptxas.exists():
        for line in _ptxas_summary(ptxas.read_text()):
            log(f"[build] {line}")


def _kernel_name(mangled):
    """flash_fwd_wgmma_kernel<128,2> or flash_fwd_mma_kernel<bf16,256,2>
    from a mangled entry-function name."""
    short = "flash_fwd_wgmma_kernel"
    if short in mangled:
        tmpl = mangled.split(short, 1)[1].split("EE", 1)[0]
        return short + "<" + ",".join(tmpl.replace("ILi", "").split("ELi")) + ">"
    short = "flash_fwd_mma_kernel"
    if short in mangled:
        tmpl = mangled.split(short + "I", 1)[1].split("EE", 1)[0]
        dtype = "bf16" if "bfloat16" in tmpl else "f32"
        ints = [x.rstrip("E") for x in tmpl.split("Li")[1:]]
        return f"{short}<{dtype},{','.join(ints)}>"
    return mangled


def _ptxas_summary(text):
    """One line per kernel from ``ptxas -v`` (registers, spills), plus the
    compiler's notes that bear on wgmma: fences it had to inject before a
    product, and any warning (a setmaxnreg it ignored)."""
    out, name, spills = [], None, ""
    injected = collections.Counter()
    for raw in text.splitlines():
        line = raw.strip()
        if "Compiling entry function" in line:
            name, spills = _kernel_name(line.split("'")[1]), ""
        elif "spill stores" in line:
            spills = line
        elif name and line.startswith("ptxas info") and "registers" in line:
            out.append(f"{name}: {line.split('Used', 1)[-1].strip()}; {spills}")
            name = None
        elif "warpgroup.arrive is injected" in line:
            injected[_kernel_name(line.rsplit("'", 2)[-2])] += 1
        elif "setmaxnreg" in line or "warning" in line.lower():
            out.append("warning: " + line[:200])
    out += [f"{n}: ptxas injected {c} warpgroup.arrive fences before wgmma"
            for n, c in injected.items()]
    return out


def _prefill_like(b, h, kv, t, dh, dtype, gen, extra=0):
    """q/k/v laid out as DecoderLM.prefill hands them to attention():
    head-transposed views of [B, T, heads*Dh] projections; ``extra``
    unused elements after each row of T make the T stride odd."""
    import torch

    def view(heads):
        x = torch.randn(b, t, heads * dh + extra, generator=gen, device="cuda").to(dtype)
        return x[:, :, : heads * dh].unflatten(2, (heads, dh)).transpose(1, 2)

    return view(h), view(kv), view(kv)


def _flops(b, h, t, dh, causal=True, kv_len=None):
    """FLOPs this input needs: q.k and p.v over the visible keys only, 2
    FLOPs per multiply-add."""
    limit = t if kv_len is None else min(t, kv_len)
    keys = sum(min(i + 1, limit) for i in range(t)) if causal else t * limit
    return 4.0 * b * h * dh * keys


def _bound(b, h, kv, t, dh, dtype_name, causal=True, kv_len=None):
    """Least time for the work: max(FLOPs this input needs / peak for its
    type, bytes of q, k, v read once and o written once / HBM rate); at
    float32 the FLOPs are 3xTF32's, three TF32 products each."""
    flops = _flops(b, h, t, dh, causal=causal, kv_len=kv_len)
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = item * dh * t * b * (2 * h + 2 * kv)
    if dtype_name == "float32":
        t_ops = TF32_PASSES * flops / PEAK_TF32_FLOPS
    else:
        t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(card):
    import torch
    import torch.nn.functional as F

    from seldon_core_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # (label, B, H, KV, T, Dh, dtype, kv_len[, extra]): the serving path's
    # shapes (llm-1.26b heads, every prefill bucket, batched admissions
    # m = 4 and 8), plus ragged T with a key-length mask, head dim 64, the
    # float32 path (mma, 3xTF32) with llm-1.26b-f32's prefill, and head
    # dims 8 (the separate draft of the speculation configurations:
    # d_model 16, 2 heads, 1 kv head), 32 and 256 at float32 (mma) and
    # bfloat16 (wgmma, padded by TMA below 64); llm-1.26b-dh256's shapes
    # (Gemma-2B's attention: 8 heads, 1 kv head, Dh 256) and the same at 8
    # kv heads; Dh 96 and 200 (padded inside the 128 and 256 instances),
    # Dh 12 and 7 (bfloat16 off the multiple of 8: mma, with 8- and
    # 2-byte copies) and a float32 view whose T stride is odd (`extra` 1:
    # 4-byte copies)
    cases = [
        ("b1_t32", 1, 16, 8, 32, 128, torch.bfloat16, None),
        ("b1_t128", 1, 16, 8, 128, 128, torch.bfloat16, None),
        ("b1_t512", 1, 16, 8, 512, 128, torch.bfloat16, None),
        ("b1_t1024", 1, 16, 8, 1024, 128, torch.bfloat16, None),
        ("b4_t128", 4, 16, 8, 128, 128, torch.bfloat16, None),
        ("b8_t512", 8, 16, 8, 512, 128, torch.bfloat16, None),
        ("b8_t1024", 8, 16, 8, 1024, 128, torch.bfloat16, None),
        ("bf16_ragged_t130_kvlen100", 1, 4, 2, 130, 128, torch.bfloat16, 100),
        ("bf16_b2_t200_dh64", 2, 4, 1, 200, 64, torch.bfloat16, None),
        ("f32_b2_t256_dh64", 2, 4, 4, 256, 64, torch.float32, None),
        ("f32_ragged_t130_kvlen100", 1, 4, 2, 130, 128, torch.float32, 100),
        ("f32_dh128_b1_t1024", 1, 16, 8, 1024, 128, torch.float32, None),
        ("f32_dh64_b2_t256_odd_stride", 2, 4, 2, 256, 64, torch.float32, None, 1),
        ("f32_dh8_b1_t128", 1, 2, 1, 128, 8, torch.float32, None),
        ("bf16_dh8_b4_t130_kvlen100", 4, 2, 1, 130, 8, torch.bfloat16, 100),
        ("bf16_dh8_b1_t512", 1, 2, 1, 512, 8, torch.bfloat16, None),
        ("f32_dh32_b2_t300", 2, 8, 2, 300, 32, torch.float32, None),
        ("bf16_dh32_b2_t257_kvlen200", 2, 8, 2, 257, 32, torch.bfloat16, 200),
        ("bf16_dh32_b1_t1024", 1, 8, 2, 1024, 32, torch.bfloat16, None),
        ("bf16_dh12_b1_t512", 1, 4, 2, 512, 12, torch.bfloat16, None),
        ("bf16_dh7_b1_t256", 1, 4, 2, 256, 7, torch.bfloat16, None),
        ("bf16_dh96_b2_t300", 2, 8, 2, 300, 96, torch.bfloat16, None),
        ("bf16_dh200_b2_t257_kvlen200", 2, 8, 1, 257, 200, torch.bfloat16, 200),
        ("bf16_dh200_b1_t1024", 1, 8, 1, 1024, 200, torch.bfloat16, None),
        ("f32_dh256_b1_t512", 1, 8, 4, 512, 256, torch.float32, None),
        ("bf16_dh256_b2_t130_kvlen100", 2, 4, 2, 130, 256, torch.bfloat16, 100),
        ("bf16_dh256_kv8_b1_t1024", 1, 8, 8, 1024, 256, torch.bfloat16, None),
        ("bf16_dh256_b1_t1024", 1, 8, 1, 1024, 256, torch.bfloat16, None),
        ("bf16_dh256_b8_t512", 8, 8, 1, 512, 256, torch.bfloat16, None),
        ("bf16_dh256_t130_kvlen100", 1, 8, 1, 130, 256, torch.bfloat16, 100),
    ] + [
        # every mma instance (DMAX 8-256) at a head dim it pads, ragged T
        # and a key-length mask: copies of 4-16 bytes, and 2 at bf16 Dh 15
        (f"{name}_dh{dh}_b2_t130_kvlen100", 2, 4, 2, 130, dh, dt, 100)
        for name, dt, dims in (("f32", torch.float32, (5, 13, 24, 40, 100, 200)),
                               ("bf16", torch.bfloat16, (15, 20, 50, 100, 250)))
        for dh in dims
    ]
    results = {}
    for label, b, h, kv, t, dh, dt, kv_len, *extra in cases:
        q, k, v = _prefill_like(b, h, kv, t, dh, dt, gen, *extra)
        dname = "bfloat16" if dt == torch.bfloat16 else "float32"
        tol = TOL[dname]
        ref = fa.attention_plain(q, k, v, kv_len=kv_len, causal=True)
        # both block sizes of the route are checked and timed; the
        # wrapper's own choice is what the main path runs
        route = fa.kernel_route(dt, dh)
        if route == "wgmma":
            chosen, sizes, copy = fa.choose_block_m(b, h, t, sms), (64, 128), "tma"
        else:
            chosen, sizes, copy = fa.choose_mma_block_m(b, h, t, sms), (32, 64), fa.copy_bytes(q, k, v)
        per_bm = {}
        for bm in sizes:
            out = fa.flash_attention_cuda(q, k, v, kv_len=kv_len, causal=True, block_m=bm)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if err > tol:
                raise AssertionError(f"flash_attention {label} block_m {bm}: "
                                     f"max_abs_err {err} > {tol}")
            per_bm[bm] = (err, device_ms(lambda: fa.flash_attention_cuda(
                q, k, v, kv_len=kv_len, causal=True, block_m=bm)))
        err, dev_ms = per_bm[chosen]
        call_ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, kv_len=kv_len, causal=True))
        plain_ms = time_ms(lambda: fa.attention_plain(q, k, v, kv_len=kv_len, causal=True), iters=5)
        if kv_len is None:
            def sdpa():
                return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        else:
            # the same function with the mask spelt out: causal, and no
            # key at or past kv_len
            pos = torch.arange(t, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] < kv_len)

            def sdpa():
                return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
        library_err = (sdpa().float() - ref.float()).abs().max().item()
        library_ms = time_ms(sdpa)
        library_dev_ms = device_ms(sdpa)
        bound_ms, bound_by = _bound(b, h, kv, t, dh, dname, kv_len=kv_len)
        flops = _flops(b, h, t, dh, kv_len=kv_len)
        smem = fa.smem_bytes(dt, dh, chosen)
        others = " ".join(f"device_ms[block_m={bm}]={ms:.4f}" for bm, (_e, ms) in per_bm.items())
        log(f"[kernel] flash_attention {label} B={b} H={h} KV={kv} T={t} Dh={dh} {dname} "
            f"route={route} kv_len={kv_len} block_m={chosen} smem={smem} copy={copy} "
            f"T_stride={q.stride(2)} max_abs_err={err:.3e} tol={tol:.3e} "
            f"device_ms={dev_ms:.4f} call_ms={call_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={_r(library_ms)} library_device_ms={_r(library_dev_ms)} "
            f"library_max_abs_err={library_err:.3e} "
            f"bound_ms={bound_ms:.4f} bound_us={bound_ms * 1e3:.3g} ({bound_by}) TFLOP/s={flops / dev_ms / 1e9:.1f} "
            f"bound_share={bound_ms / dev_ms:.3f} {others} [{card}] OK")
        results[label] = dict(max_abs_err=err, ms=call_ms, device_ms=dev_ms, plain_ms=plain_ms,
                              library_ms=library_ms, library_device_ms=library_dev_ms,
                              bound_ms=bound_ms, bound_by=bound_by, block_m=chosen,
                              route=route, dh=dh, dtype=dname)
    log(f"[kernel] flash_attention launches in this phase: {fa.LAUNCHES['flash_attention']}")
    return results


def _r(x):
    return None if x is None else round(x, 4)


def phase_small_model():
    """The batcher's tokens equal DecoderLM.generate on the card (float32,
    Dh 64 so the prefill runs the kernel), greedy and seeded."""
    import torch

    from seldon_core_tpu_torch.models.llm import DecoderLM
    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

    cfg = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
               d_ff=512, max_seq=128, dtype="float32")
    model = DecoderLM(**cfg)
    params = model.init_params(0, device="cuda")
    before = fa.LAUNCHES["flash_attention"]
    b = ContinuousBatcher(model, params, slots=4, prefill_buckets=(32, 64),
                          steps_per_poll=4)
    try:
        prompts = [[3, 17, 42, 99, 7], list(range(1, 40)), [5] * 12]
        for temp, seed in ((0.0, 0), (0.9, 11)):
            futs = [b.submit(p, max_new_tokens=16, temperature=temp, seed=seed) for p in prompts]
            got = [f.result(timeout=300) for f in futs]
            for p, g in zip(prompts, got):
                ref = model.generate(
                    params, torch.tensor([p], device="cuda"), 16,
                    temperature=temp, seed=seed,
                )[0].tolist()
                if temp == 0.0 and g != ref:
                    raise AssertionError(f"batcher greedy {g} != generate {ref}")
                if len(g) != len(p) + 16 or g[: len(p)] != p:
                    raise AssertionError(f"malformed batcher output {g}")
        again = b.submit(prompts[0], max_new_tokens=16, temperature=0.9, seed=11).result(timeout=300)
        if again != got[0]:
            raise AssertionError("seeded request not reproducible on the card")
    finally:
        b.close()
    launched = fa.LAUNCHES["flash_attention"] - before
    if launched <= 0:
        raise AssertionError("small model prefill did not launch the flash kernel")
    log(f"[small] batcher == generate (greedy), seeded repeat identical; "
        f"flash launches {launched}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port: int, body: dict, timeout: float = 600.0, path: str = "/predict",
          headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


# the generate server of the serve and engine phases: llm-1.26b at 8
# slots, warmed for the waves' prompt lengths before it listens
SERVE_PARAMS = [
    {"name": "device", "value": "cuda", "type": "STRING"},
    {"name": "slots", "value": "8", "type": "INT"},
    {"name": "steps_per_poll", "value": "16", "type": "INT"},
    {"name": "pipeline_depth", "value": "3", "type": "INT"},
    {"name": "warmup_prompt_lens", "value": "20,128,300,500,900", "type": "STRING"},
    {"name": "warmup_max_new_tokens", "value": "64", "type": "INT"},
]
MAX_NEW = 64


def serve_waves():
    """The traffic of the serve and engine phases: two 20-token requests
    (greedy, seeded) alone, a mixed wave of 8 across every prefill
    bucket, then the first two again."""
    import numpy as np

    rs = np.random.RandomState(0)
    vocab = LLM_1_26B["vocab_size"]

    def prompt(n):
        return rs.randint(0, vocab, n).tolist()

    g20, s20 = prompt(20), prompt(20)
    # the same two requests alone, before and after a mixed wave: in the
    # same batch composition bf16 decode is deterministic, so the repeat
    # must give identical tokens
    probe = [("greedy_20", g20, 0.0, 0), ("seeded_20", s20, 1.0, 3)]
    mixed = [
        ("mixed_greedy_20", g20, 0.0, 0),
        ("greedy_128", prompt(128), 0.0, 0),
        ("seeded_500", prompt(500), 0.8, 7),
        ("greedy_900", prompt(900), 0.0, 0),
        ("mixed_seeded_20", s20, 1.0, 3),
        ("greedy_300", prompt(300), 0.0, 0),
        ("greedy_24", prompt(24), 0.0, 0),
        ("greedy_30", prompt(30), 0.0, 0),
    ]
    return probe, mixed


def _gen_body(toks, temp=0.0, seed=0, max_new=MAX_NEW):
    return {"jsonData": {"prompt_tokens": toks, "max_new_tokens": max_new,
                         "temperature": temp, "seed": seed}}


def fire(post, wave):
    """Send a wave's requests concurrently; ``post(body)`` returns
    ``(status, json)``."""
    out = {}

    def one(item):
        label, toks, temp, seed = item
        out[label] = post(_gen_body(toks, temp, seed))

    threads = [threading.Thread(target=one, args=(it,)) for it in wave]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    return out


def _slo(batcher):
    """TTFT p50/p99 and TPOT p50 (ms) over the batcher's SLO reservoir."""
    import numpy as np

    ttfts = [r[1] for r in batcher.slo_recent]
    tpots = [r[2] for r in batcher.slo_recent if r[2] is not None]
    return {"ttft_p50": float(np.percentile(ttfts, 50)) * 1e3,
            "ttft_p99": float(np.percentile(ttfts, 99)) * 1e3,
            "tpot_p50": float(np.percentile(tpots, 50)) * 1e3}


def run_waves(tag, post, batcher, probe, mixed, card):
    """Drive probe, mixed, probe through ``post`` with the flash kernel's
    launch count and the batcher's SLO reservoir reset just before; check
    every response and the repeats; print the end-to-end numbers. Returns
    the flash launches, the prefill dispatches, the first probe wave's
    results, and tokens/s with the SLO percentiles."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.ops import flash_attention as fa

    vocab = LLM_1_26B["vocab_size"]
    stats0 = dict(batcher.stats)
    batcher.slo_recent.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES["flash_attention"] = 0  # count this path only
    t_serve = time.perf_counter()
    results = [fire(post, probe), fire(post, mixed), fire(post, probe)]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_serve
    launches = fa.LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    prefills = batcher.stats["prefill_steps"] - stats0["prefill_steps"]
    n_req = 0
    gen_tokens = 0
    for wave, res in zip((probe, mixed, probe), results):
        for label, toks, _temp, _seed in wave:
            status, body = res[label]
            if status != 200:
                raise AssertionError(f"{label}: HTTP {status} {body}")
            out = body["jsonData"]["tokens"]
            if len(out) != 1 or len(out[0]) != len(toks) + MAX_NEW \
                    or out[0][: len(toks)] != toks \
                    or not all(0 <= t < vocab for t in out[0]):
                raise AssertionError(f"{label}: malformed tokens")
            n_req += 1
            gen_tokens += MAX_NEW
    first, _mix, again = results
    for label in ("greedy_20", "seeded_20"):
        if first[label][1]["jsonData"]["tokens"] != again[label][1]["jsonData"]["tokens"]:
            raise AssertionError(f"{label}: repeated request gave other tokens")
    log(f"[{tag}] {n_req} REST requests OK; repeated greedy and seeded requests identical")
    for label in ("greedy_20", "seeded_20"):
        a = first[label][1]["jsonData"]["tokens"][0][20:]
        m = results[1]["mixed_" + label][1]["jsonData"]["tokens"][0][20:]
        same = next((i for i, (x, y) in enumerate(zip(a, m)) if x != y), len(a))
        log(f"[{tag}] {label} alone vs inside the mixed wave: first {same} of "
            f"{len(a)} tokens equal (bf16 rounding depends on batch composition)")
    layers = LLM_1_26B["n_layers"]
    log(f"[{tag}] prefill dispatches {prefills}, flash kernel launches {launches} "
        f"(need >= {layers} x {prefills})")
    if prefills <= 0 or launches < layers * prefills:
        raise AssertionError("not every prefill went through the flash kernel")
    slo = _slo(batcher)
    log(f"[{tag}] tokens/s {gen_tokens / serve_s:.1f} ({gen_tokens} generated tokens "
        f"in {serve_s:.2f} s, {n_req} requests, 8 slots) [{card}]")
    log(f"[{tag}] TTFT p50 {slo['ttft_p50']:.1f} ms, p99 {slo['ttft_p99']:.1f} ms; "
        f"TPOT p50 {slo['tpot_p50']:.2f} ms [{card}]")
    log(f"[{tag}] peak device memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated) [{card}]")
    return launches, prefills, first, {"tok_s": gen_tokens / serve_s, **slo}


def serve_in_thread(start):
    """Run ``start()`` (a coroutine function that opens the listeners and
    returns an async closer) on an event loop in a daemon thread; returns
    a function that closes the listeners and stops the loop."""
    loop = asyncio.new_event_loop()
    ready = threading.Event()
    closer = {}

    def run():
        asyncio.set_event_loop(loop)
        try:
            closer["fn"] = loop.run_until_complete(start())
        except BaseException as e:  # noqa: BLE001 - reported to the caller
            closer["error"] = e
        ready.set()
        if "fn" in closer:
            loop.run_forever()

    thread = threading.Thread(target=run, name="serve", daemon=True)
    thread.start()
    if not ready.wait(120) or "error" in closer:
        raise AssertionError(f"server did not start: {closer.get('error')}")

    def stop():
        asyncio.run_coroutine_threadsafe(closer["fn"](), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)

    return stop


def phase_serve(card):
    import numpy as np
    import torch

    from seldon_core_tpu_torch import microservice, wrapper
    from seldon_core_tpu_torch.ops import flash_attention as fa

    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as model_dir:
        with open(os.path.join(model_dir, "jax_config.json"), "w") as f:
            json.dump({"family": "llm", "config": LLM_1_26B}, f)
        params = [{"name": "model_uri", "value": model_dir, "type": "STRING"}] + SERVE_PARAMS
        t0 = time.perf_counter()
        user = microservice.build_user_object(
            "seldon_core_tpu_torch.servers.generateserver.GenerateServer", json.dumps(params)
        )
        user.load()  # what the CLI does before it listens: load + warm
        log(f"[serve] llm-1.26b loaded and warmed in {time.perf_counter() - t0:.1f} s "
            f"({user._model.n_params() / 1e9:.3f} B params, bf16)")
        app = wrapper.get_rest_microservice(user)
        port = _free_port()

        async def start():
            await app.start("127.0.0.1", port)

            async def close():
                app.close()
            return close

        stop = serve_in_thread(start)
        try:
            probe, mixed = serve_waves()
            launches, _prefills, _first, numbers = run_waves(
                "serve", lambda body: _post(port, body), user.batcher, probe, mixed, card)
            # one greedy request alone: the engine phase must give the
            # same tokens through the engine (same batch composition)
            status, body = _post(port, _gen_body(probe[0][1]))
            if status != 200:
                raise AssertionError(f"greedy_20 alone: HTTP {status} {body}")
            alone = body["jsonData"]["tokens"]
            # each of these greedy requests alone: the control-plane
            # phase's gateway must give the same tokens
            numbers["alone_tokens"] = {}
            toks = {x[0]: x[1] for x in probe + mixed}
            for label in CP_LABELS:
                status, body = _post(port, _gen_body(toks[label]))
                if status != 200:
                    raise AssertionError(f"{label} alone: HTTP {status} {body}")
                numbers["alone_tokens"][label] = body["jsonData"]["tokens"][0]
            # the seeded probe alone: the mesh phase's sharded server must
            # give the same tokens
            status, body = _post(port, _gen_body(probe[1][1], probe[1][2], probe[1][3]))
            if status != 200:
                raise AssertionError(f"seeded_20 alone: HTTP {status} {body}")
            numbers["alone_tokens"]["seeded_20"] = body["jsonData"]["tokens"][0]
        finally:
            stop()
            app._hook_pool.shutdown(wait=False)
            user.close()

        # full-width prefill: the kernel against the plain attention,
        # called explicitly, in the same model on the same weights
        from seldon_core_tpu_torch.models import llm as llm_mod

        model, params_dev = user._model, user.batcher.params
        rs = np.random.RandomState(1)
        prompts = torch.tensor(rs.randint(0, LLM_1_26B["vocab_size"], (8, 128)), device="cuda")
        logits_k, _ = model.prefill(params_dev, prompts, 128)
        saved = llm_mod.prefill_attention
        llm_mod.prefill_attention = fa.attention_plain
        try:
            logits_p, _ = model.prefill(params_dev, prompts, 128)
        finally:
            llm_mod.prefill_attention = saved
        if not bool(torch.isfinite(logits_k).all()):
            raise AssertionError("non-finite prefill logits")
        diff = (logits_k - logits_p).abs().max().item()
        top1 = (logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean().item()
        log(f"[serve] prefill logits kernel vs plain at full width: max_abs {diff:.4e} "
            f"(tol {LOGITS_TOL}), top-1 agreement {top1:.3f} (min {TOP1_MIN_AGREEMENT}), "
            f"|logits| max {logits_p.abs().max().item():.3f}")
        if diff > LOGITS_TOL or top1 < TOP1_MIN_AGREEMENT:
            raise AssertionError("prefill logits disagree between kernel and plain attention")
        return launches, alone, numbers


def _grpc_available() -> bool:
    try:
        import google.protobuf  # noqa: F401
        import grpc  # noqa: F401
    except ImportError:
        return False
    return True


def _sse(port: int, body: dict, timeout: float = 600.0):
    """The events of one SSE stream from /api/v0.1/generate."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/api/v0.1/generate", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"SSE: HTTP {resp.status} {resp.read()[:300]}")
        raw = resp.read().decode()
    finally:
        conn.close()
    return [json.loads(block[len("data: "):])
            for block in raw.split("\n\n") if block.startswith("data: ")]


def _sse_drop_after_first(port: int, body: dict) -> None:
    """Open an SSE stream, wait for its first event, then vanish."""
    data = json.dumps(body).encode()
    sock = socket.create_connection(("127.0.0.1", port), timeout=120)
    try:
        sock.sendall(b"POST /api/v0.1/generate HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\n"
                     + f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
        got = b""
        while b"data: " not in got:
            chunk = sock.recv(4096)
            if not chunk:
                raise AssertionError(f"stream ended before its first event: {got[:200]}")
            got += chunk
        if not got.startswith(b"HTTP/1.1 200"):
            raise AssertionError(f"stream refused: {got[:200]}")
    finally:
        sock.close()


def _wait_for(cond, what: str, timeout: float = 60.0) -> None:
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _paired_latency(engine_call, micro_call, n):
    """Client-side seconds of ``n`` calls each, in ABBA order so drift
    falls on both sides alike; every call must answer 200."""
    lat = {"engine": [], "micro": []}
    calls = {"engine": engine_call, "micro": micro_call}
    for i in range(n):
        for name in (("engine", "micro") if i % 2 == 0 else ("micro", "engine")):
            t = time.perf_counter()
            status, out = calls[name]()
            lat[name].append(time.perf_counter() - t)
            if status != 200:
                raise AssertionError(f"request via {name}: HTTP {status} {out}")
    return lat


def _lat_line(lat):
    import numpy as np

    q = {k: np.percentile(v, [25, 50, 75]) * 1e3 for k, v in lat.items()}
    return (f"engine {q['engine'][1]:.2f} ms (p25-p75 {q['engine'][0]:.2f}-"
            f"{q['engine'][2]:.2f}), microservice {q['micro'][1]:.2f} ms (p25-p75 "
            f"{q['micro'][0]:.2f}-{q['micro'][2]:.2f}), engine overhead "
            f"{q['engine'][1] - q['micro'][1]:.2f} ms")


def _host_overhead(card, engine_app):
    """The engine's host cost without device noise: a SIMPLE_MODEL unit
    through the engine against the same unit behind a component
    microservice, median of 200 each (ABBA order)."""
    from seldon_core_tpu_torch import wrapper
    from seldon_core_tpu_torch.graph.units import SimpleModelUnit

    app = engine_app({"name": "m", "implementation": "SIMPLE_MODEL"})
    micro = wrapper.get_rest_microservice(SimpleModelUnit())
    port, micro_port = _free_port(), _free_port()
    rest = app.rest_app()

    async def start():
        await rest.start("127.0.0.1", port)
        await micro.start("127.0.0.1", micro_port)

        async def close():
            rest.close()
            micro.close()
            await app.executor.close()
        return close

    stop = serve_in_thread(start)
    try:
        msg = {"data": {"ndarray": [[1.0, 2.0]]}}
        lat = _paired_latency(
            lambda: _post(port, msg, path="/api/v0.1/predictions"),
            lambda: _post(micro_port, msg), 200)
    finally:
        stop()
        micro._hook_pool.shutdown(wait=False)
    log(f"[engine] SIMPLE_MODEL request, client side, median of 200 (host only): "
        f"{_lat_line(lat)} [{card}]")


def phase_engine(card, alone_ref):
    """The engine path at llm-1.26b full width: an EngineApp over one
    in-process GENERATE_SERVER unit on CUDA, served on REST (and gRPC
    when grpcio imports), driven with the serve phase's waves; then a
    greedy request alone against the serve phase's, SSE streams against
    unary, a dropped stream, a two-unit RAG graph, a remote REST hop, a
    1 ms deadline, and the engine's per-request overhead against a
    component microservice over the same generate server."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch import wrapper
    from seldon_core_tpu_torch.graph.engine_metrics import MetricsRegistry
    from seldon_core_tpu_torch.graph.service import EngineApp
    from seldon_core_tpu_torch.graph.spec import (
        PredictorSpec,
        default_predictor,
        validate_predictor,
    )
    from seldon_core_tpu_torch.ops import flash_attention as fa

    def engine_app(graph, registry=None):
        spec = PredictorSpec.from_dict({
            "name": "llm-1-26b", "graph": graph,
            # generate requests outlive the 5 s default unit-call timeout
            "annotations": {"seldon.io/rest-read-timeout": "600000"}})
        spec = default_predictor(spec)
        validate_predictor(spec)
        return EngineApp(spec, registry=registry, metrics=MetricsRegistry())

    with tempfile.TemporaryDirectory(prefix="chip-smoke-engine-") as model_dir:
        with open(os.path.join(model_dir, "jax_config.json"), "w") as f:
            json.dump({"family": "llm", "config": LLM_1_26B}, f)
        unit = {"name": "llm", "implementation": "GENERATE_SERVER",
                "modelUri": model_dir, "parameters": SERVE_PARAMS}
        t0 = time.perf_counter()
        app = engine_app(unit)  # resolves, loads and warms the generate server
        gen = app.executor.root.client.user_object
        if gen.device.type != "cuda" or gen.batcher.device.type != "cuda":
            raise AssertionError(f"engine generate unit on {gen.device}, not CUDA")
        log(f"[engine] EngineApp over GENERATE_SERVER (llm-1.26b) loaded and warmed in "
            f"{time.perf_counter() - t0:.1f} s on {gen.batcher.device}")
        # the same generate server behind a component microservice: the
        # remote hop's target and the yardstick of the engine's overhead
        micro = wrapper.get_rest_microservice(gen)
        rag = {"name": "rag", "implementation": "RAG_PROMPT_BUILDER", "parameters": [
            {"name": "max_new_tokens", "value": str(MAX_NEW), "type": "INT"},
            {"name": "temperature", "value": "0.0", "type": "FLOAT"},
            {"name": "seed", "value": "0", "type": "INT"}], "children": [dict(unit)]}
        app_rag = engine_app(rag, registry={"llm": gen})
        micro_port = _free_port()
        app_remote = engine_app(dict(unit, endpoint={
            "service_host": "127.0.0.1", "service_port": micro_port, "transport": "REST"}))
        grpc_ok = _grpc_available()
        port, rag_port, remote_port = _free_port(), _free_port(), _free_port()
        grpc_port = _free_port() if grpc_ok else None

        async def start():
            listeners = [app.rest_app(), app_rag.rest_app(), app_remote.rest_app(), micro]
            for http_app, p in zip(listeners, (port, rag_port, remote_port, micro_port)):
                await http_app.start("127.0.0.1", p)
            gsrv = None
            if grpc_ok:
                gsrv = app.grpc_server()
                gsrv.add_insecure_port(f"127.0.0.1:{grpc_port}")
                await gsrv.start()

            async def close():
                for http_app in listeners:
                    http_app.close()
                if gsrv is not None:
                    await gsrv.stop(grace=0.5)
                for a in (app, app_rag, app_remote):
                    await a.executor.close()
            return close

        stop = serve_in_thread(start)
        b = gen.batcher
        try:
            def post(body, headers=None, to=port):
                return _post(to, body, path="/api/v0.1/predictions", headers=headers)

            probe, mixed = serve_waves()
            g20, s20 = probe[0][1], probe[1][1]
            prefill0 = b.stats["prefill_steps"]
            run_waves("engine", post, b, probe, mixed, card)

            # a greedy request alone: the serve phase's tokens
            status, out = post(_gen_body(g20))
            if status != 200:
                raise AssertionError(f"greedy_20 alone: HTTP {status} {out}")
            alone = out["jsonData"]["tokens"]
            if alone_ref is not None and alone != alone_ref:
                raise AssertionError("greedy_20 alone: engine tokens differ from the microservice's")
            status, out = post(_gen_body(s20, 1.0, 3))
            if status != 200:
                raise AssertionError(f"seeded_20 alone: HTTP {status} {out}")
            seeded_alone = out["jsonData"]["tokens"]
            log("[engine] greedy_20 alone: engine tokens == microservice tokens (serve phase)"
                if alone_ref is not None else
                "[engine] greedy_20 alone: not compared (the serve phase did not run)")

            # SSE: spans concatenate to the unary result of the same request
            for label, toks, temp, seed, unary in (
                    ("greedy_20", g20, 0.0, 0, alone[0]),
                    ("seeded_20", s20, 1.0, 3, seeded_alone[0])):
                events = _sse(port, _gen_body(toks, temp, seed))
                streamed = [t for ev in events[:-1] for t in ev["tokens"]]
                if len(events) <= 2 or not events[-1].get("done") \
                        or events[-1]["tokens"] != unary or streamed != unary[len(toks):]:
                    raise AssertionError(f"SSE {label}: {len(events)} events do not "
                                         "concatenate to the unary result")
                log(f"[engine] SSE {label}: {len(events)} events, spans == unary tokens")

            # a dropped stream cancels its request and frees the lane
            cancelled0 = b.stats["cancelled"]
            _sse_drop_after_first(port, _gen_body(g20))
            _wait_for(lambda: b.stats["cancelled"] > cancelled0, "the dropped stream's cancel")
            _wait_for(lambda: not b._active and app.inflight == 0, "the lane to come back")
            status, out = post(_gen_body(g20, max_new=8))
            if status != 200 or len(out["jsonData"]["tokens"][0]) != 28:
                raise AssertionError(f"request after the dropped stream: HTTP {status}")
            log(f"[engine] dropped stream: cancelled {cancelled0} -> {b.stats['cancelled']}, "
                "lane freed, next request admitted")

            # two-unit graph: RAG_PROMPT_BUILDER -> GENERATE_SERVER
            status, out = post({"data": {"ndarray": [g20]}}, to=rag_port)
            if status != 200 or out["jsonData"]["tokens"] != alone:
                raise AssertionError(f"RAG graph: HTTP {status}, tokens differ from the "
                                     "single-unit graph's")
            log(f"[engine] RAG_PROMPT_BUILDER -> GENERATE_SERVER == single unit "
                f"(path {out['meta']['requestPath']})")

            # remote hop: the generate unit behind the component microservice
            status, out = post(_gen_body(g20), to=remote_port)
            if status != 200 or out["jsonData"]["tokens"] != alone:
                raise AssertionError(f"remote REST hop: HTTP {status}, tokens differ")
            log("[engine] remote REST hop to the component microservice == in-process")

            # a 1 ms budget is refused, never served
            counters = ("seldon_engine_deadline_exceeded", "seldon_engine_load_shed")
            before = [app.metrics.counter_total(c) for c in counters]
            status, out = post(_gen_body(g20), headers={"Seldon-Deadline-Ms": "1"})
            after = [app.metrics.counter_total(c) for c in counters]
            if status not in (504, 429) or after == before:
                raise AssertionError(f"1 ms deadline: HTTP {status}, counters {before} -> {after}")
            log(f"[engine] 1 ms deadline: HTTP {status}; deadline_exceeded/load_shed "
                f"{before} -> {after}")

            if grpc_ok:
                import grpc

                from seldon_core_tpu_torch.payload import json_to_proto, proto_to_json
                from seldon_core_tpu_torch.proto import prediction_pb2 as pb

                with grpc.insecure_channel(f"127.0.0.1:{grpc_port}") as ch:
                    unary_rpc = ch.unary_unary(
                        "/seldontpu.Seldon/Predict",
                        request_serializer=lambda m: m.SerializeToString(),
                        response_deserializer=pb.SeldonMessage.FromString)
                    stream_rpc = ch.unary_stream(
                        "/seldontpu.Seldon/GenerateStream",
                        request_serializer=lambda m: m.SerializeToString(),
                        response_deserializer=pb.SeldonMessage.FromString)
                    req = json_to_proto(_gen_body(g20))
                    got = proto_to_json(unary_rpc(req, timeout=600))["jsonData"]["tokens"]
                    chunks = [proto_to_json(m)["jsonData"] for m in stream_rpc(req, timeout=600)]
                streamed = [t for c in chunks[:-1] for t in c["tokens"]]
                if got != alone or chunks[-1]["tokens"] != alone[0] or streamed != alone[0][20:]:
                    raise AssertionError("gRPC Predict/GenerateStream differ from REST")
                log(f"[engine] gRPC Predict == REST; GenerateStream {len(chunks)} messages == REST")
            else:
                log("[engine] gRPC front not driven: grpcio is absent on this machine "
                    "(import grpc, google.protobuf failed); the CPU tests hold it")

            launches = fa.LAUNCHES["flash_attention"]
            prefills = b.stats["prefill_steps"] - prefill0
            layers = LLM_1_26B["n_layers"]
            log(f"[engine] whole engine phase: prefill dispatches {prefills}, flash kernel "
                f"launches {launches} (need >= {layers} x {prefills})")
            if prefills <= 0 or launches < layers * prefills:
                raise AssertionError("not every engine prefill went through the flash kernel")

            # the engine's per-request overhead: one 1-token request through
            # the engine vs the same request to the microservice over the
            # same generate server, median of 20 each (ABBA order)
            one = _gen_body(g20, max_new=1)
            lat = _paired_latency(
                lambda: post(one), lambda: _post(micro_port, one), 20)
            log(f"[engine] 1-token request, client side, median of 20: {_lat_line(lat)} "
                f"[{card}]")

            # the engine's end-to-end cost: the same waves through the
            # engine and through the microservice over the same generate
            # server, in one process, one run each
            paths = {"engine": post, "micro": lambda body: _post(micro_port, body)}
            ab = {"engine": [], "micro": []}
            for name in ("engine", "micro"):
                b.slo_recent.clear()
                t = time.perf_counter()
                results = [fire(paths[name], wave) for wave in (probe, mixed, probe)]
                wall = time.perf_counter() - t
                if any(st != 200 for res in results for st, _out in res.values()):
                    raise AssertionError(f"A/B waves via {name}: a request failed")
                tok_s = MAX_NEW * (2 * len(probe) + len(mixed)) / wall
                ab[name].append((tok_s, _slo(b)))
            for name, runs in ab.items():
                tok = [r[0] for r in runs]
                tpot = [r[1]["tpot_p50"] for r in runs]
                ttft = [r[1]["ttft_p50"] for r in runs]
                log(f"[engine] A/B waves via {name} ({len(runs)} runs): tokens/s median "
                    f"{np.median(tok):.1f} {[round(x, 1) for x in tok]}; TPOT p50 median "
                    f"{np.median(tpot):.2f} {[round(x, 2) for x in tpot]} ms; TTFT p50 median "
                    f"{np.median(ttft):.1f} {[round(x, 1) for x in ttft]} ms [{card}]")
        finally:
            stop()
            micro._hook_pool.shutdown(wait=False)
            gen.close()
        _host_overhead(card, engine_app)
        return launches, gen._model, b.params


# the scheduler phase's configurations (llm-1.26b, 8 slots, steps_per_poll
# 16, pipeline_depth 3, attn_bucket 128): A is today's eager path, kept
# behind the batcher's cuda_graphs argument as the comparison
SCHED_BASE = dict(slots=8, steps_per_poll=16, pipeline_depth=3, attn_bucket=128)
SCHED_CONFIGS = {
    "A": ("every knob off, graphs off", dict(cuda_graphs=False)),
    "B": ("every knob off, graphs on", {}),
    "C": ("fused_steps_per_dispatch 64", dict(fused_steps_per_dispatch=64)),
    "D": ("C + depth_groups 4, split forced (depth_group_split_bytes 0)",
          dict(fused_steps_per_dispatch=64, depth_groups=4, depth_group_split_bytes=0)),
    "E": ("C + prefill_chunk 256", dict(fused_steps_per_dispatch=64, prefill_chunk=256)),
    "F": ("depth_groups 4, default cost model", dict(depth_groups=4)),
}
WARM_LENS = (20, 128, 300, 500, 900)
# mid-burst stops: steps of a request's knobs-off run whose token becomes
# its eos_id (see _pick_stops)
STOP_STEPS = (3, 17, 40, 63)


class _Gate:
    """A poll hook that parks the batcher's loop, so that a whole wave is
    queued before the loop takes any of it: the wave is admitted in one
    poll and every run of it has the same batch composition."""

    def __init__(self):
        self.hold, self.parked, self.go = threading.Event(), threading.Event(), threading.Event()

    def __call__(self, _poll):
        if self.hold.is_set():
            self.parked.set()
            self.go.wait(60)

    def submit_together(self, batcher, items, on_tokens=None, max_new=MAX_NEW):
        """Submit ``items`` ``(tokens, temperature, seed, eos)`` while the
        loop is parked; ``on_tokens[i]`` (optional) streams item i;
        ``max_new`` is every item's budget or a list of one per item."""
        budgets = max_new if isinstance(max_new, list) else [max_new] * len(items)
        self.go.clear()
        self.parked.clear()
        self.hold.set()
        if not self.parked.wait(30):
            raise AssertionError("the batcher loop did not reach its poll hook")
        try:
            return [batcher.submit(toks, max_new_tokens=budgets[i], temperature=temp,
                                   seed=seed, eos_id=eos,
                                   on_tokens=on_tokens[i] if on_tokens else None)
                    for i, (toks, temp, seed, eos) in enumerate(items)]
        finally:
            self.hold.clear()
            self.go.set()


def _sched_batcher(model, params, cfg_kw, gate=None):
    from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

    b = ContinuousBatcher(model, params, **SCHED_BASE, **cfg_kw)
    b.fault_hook = gate
    return b


def _wave_tokens(gate, batcher, wave, eos=None):
    futs = gate.submit_together(batcher, [
        (toks, temp, seed, (eos or {}).get(label)) for label, toks, temp, seed in wave])
    return {label: f.result(timeout=600) for (label, *_r), f in zip(wave, futs)}


def _sched_run(gate, b, probe, mixed):
    """One run of the serve waves (probe, mixed, probe), each queued
    whole: tokens by label, tokens/s, the SLO percentiles, the flash
    launches, the scheduler counters' deltas and the peak memory."""
    import torch

    from seldon_core_tpu_torch.ops import flash_attention as fa

    b.slo_recent.clear()
    stats0 = dict(b.stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES["flash_attention"] = 0
    t = time.perf_counter()
    out = {}
    for i, wave in enumerate((probe, mixed, probe)):
        got = _wave_tokens(gate, b, wave)
        out.update({(lab if i < 2 else lab + "#2"): v for lab, v in got.items()})
    wall = time.perf_counter() - t
    delta = {k: v - stats0[k] for k, v in b.stats.items() if isinstance(v, (int, float))}
    return {"tokens": out, "tok_s": MAX_NEW * (2 * len(probe) + len(mixed)) / wall,
            "slo": _slo(b), "launches": fa.LAUNCHES["flash_attention"], "delta": delta,
            "peak": torch.cuda.max_memory_allocated()}


def _first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def _check_sched_run(name, run, probe, mixed):
    """Shape, flash-launch and repeat checks of one run."""
    vocab = LLM_1_26B["vocab_size"]
    for key, out in run["tokens"].items():
        toks = _p(key, probe, mixed)
        if len(out) != len(toks) + MAX_NEW or out[: len(toks)] != toks \
                or not all(0 <= x < vocab for x in out):
            raise AssertionError(f"[sched] {name} {key}: malformed tokens")
    for label, *_r in probe:
        if run["tokens"][label] != run["tokens"][label + "#2"]:
            raise AssertionError(f"[sched] {name} {label}: repeated request gave other tokens")
    d = run["delta"]
    whole = d["prefill_steps"] - d["prefill_chunks"]
    layers = LLM_1_26B["n_layers"]
    if whole <= 0 or run["launches"] < layers * whole:
        raise AssertionError(f"[sched] {name}: {whole} whole-prompt prefills but "
                             f"{run['launches']} flash launches (need >= {layers} each)")


def phase_scheduler(card, model, params):
    """The scheduler knobs at llm-1.26b full width (bf16, 8 slots):
    configurations A-F of SCHED_CONFIGS driven with the serve waves, one
    run each; the gated checks and the reported numbers are in the module
    docstring."""
    import gc

    import numpy as np
    import torch

    probe, mixed = serve_waves()
    prompts = {label: toks for label, toks, _t, _s in mixed}
    gate = _Gate()
    runs = {name: [] for name in SCHED_CONFIGS}
    info = {}

    def build(name):
        b = _sched_batcher(model, params, SCHED_CONFIGS[name][1], gate)
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        t = time.perf_counter()
        b.warm(prompt_lens=WARM_LENS, max_new_tokens=MAX_NEW)
        info[name] = {"warm_s": time.perf_counter() - t,
                      "warm_reserved": torch.cuda.memory_reserved() - reserved,
                      "graphs": b.stats["graphs_captured"],
                      "capture_s": b.stats["graph_capture_s"],
                      "pool": b.stats["graph_pool_bytes"]}
        b.start()
        return b

    live = {name: build(name) for name in ("A", "B", "C")}
    # one run each (a run repeats its probe wave: the repeat check holds
    # inside it); the ABBA alternation of A/B and A/C is cut for the
    # whole script's time budget
    for name in ("A", "B", "C"):
        runs[name].append(_sched_run(gate, live[name], probe, mixed))
    # the stops ride the mixed wave itself (same batch composition as the
    # knobs-off run they are read from)
    eos, expect = _pick_stops(runs["A"][0]["tokens"], prompts)
    stops = {}
    for name in ("A", "B", "C"):
        stops[name] = _wave_tokens(gate, live[name], mixed, eos)
    inline = {}
    for name in ("A", "B", "C"):
        inline[name] = live[name].stats["graph_captures_inline"]
        live[name].close()
    live.clear()
    gc.collect()
    torch.cuda.empty_cache()
    for name in ("D", "E", "F"):
        # one run each, to keep the whole script inside its time limit (a
        # run repeats itself all the same: the probe wave goes twice)
        b = build(name)
        runs[name].append(_sched_run(gate, b, probe, mixed))
        stops[name] = _wave_tokens(gate, b, mixed, eos)
        inline[name] = b.stats["graph_captures_inline"]
        b.close()
        del b
        gc.collect()
        torch.cuda.empty_cache()

    a0 = runs["A"][0]["tokens"]
    for name, rs in runs.items():
        for run in rs:
            _check_sched_run(name, run, probe, mixed)
            if run["tokens"] != rs[0]["tokens"]:
                raise AssertionError(f"[sched] {name}: the same waves gave other tokens")
        if name in ("A", "B", "C") and rs[0]["tokens"] != a0:
            bad = [k for k in a0 if rs[0]["tokens"][k] != a0[k]]
            raise AssertionError(f"[sched] {name} != A at full width: {bad}")
        if name != "A" and inline[name]:
            raise AssertionError(f"[sched] {name}: {inline[name]} graphs captured after warm()")
        for label, e in eos.items():
            out = stops[name][label]
            gen = out[len(prompts[label]):]
            if e in gen[:-1] or (gen[-1] != e and len(gen) < MAX_NEW):
                raise AssertionError(f"[sched] {name} {label}: did not stop at its eos {e}")
            if name in ("A", "B", "C") and out != expect[label]:
                raise AssertionError(f"[sched] {name} {label}: stop differs from the "
                                     f"knobs-off run ({len(out)} vs {len(expect[label])} tokens)")
        if name in ("A", "B", "C"):
            rest = [k for k in prompts if k not in eos and stops[name][k] != a0[k]]
            if rest:
                raise AssertionError(f"[sched] {name}: streams beside the stops changed: {rest}")
    d_groups = sum(r["delta"]["group_bursts"] for r in runs["D"])
    if d_groups <= 0:
        raise AssertionError("[sched] D: the forced split dispatched no group burst")
    if sum(r["delta"]["prefill_chunks"] for r in runs["E"]) <= 0:
        raise AssertionError("[sched] E: no prompt was chunked")
    log(f"[sched] B == A and C == A token for token (greedy and seeded, {len(a0)} "
        "streams per run); every configuration repeatable; every stop fired at its "
        "step; no graph captured after warm()")

    for name, (label, _kw) in SCHED_CONFIGS.items():
        rs = runs[name]
        d = {k: sum(r["delta"][k] for r in rs) for k in rs[0]["delta"]}
        same = [k for k in a0 if rs[0]["tokens"][k] == a0[k]]
        diffs = {k: _first_diff(rs[0]["tokens"][k][len(_p(k, probe, mixed)):],
                                a0[k][len(_p(k, probe, mixed)):])
                 for k in a0 if k not in same}
        stop_same = sum(stops[name][lab] == expect[lab] for lab in eos)
        k_real = d["fused_steps"] / d["fused_dispatches"] if d["fused_dispatches"] else None
        occ = (d["group_lanes"] / (d["group_lanes"] + d["group_pad_lanes"])
               if d["group_bursts"] else None)
        launches_step = d["graph_replays"] / d["steps"] if d["steps"] else 0.0
        med = {m: float(np.median([r["slo"][m] for r in rs]))
               for m in ("ttft_p50", "ttft_p99", "tpot_p50")}
        info[name].update(runs=len(rs), launches=[r["launches"] for r in rs])
        log(f"[sched] {name} ({label}), {len(rs)} runs: tokens/s median "
            f"{np.median([r['tok_s'] for r in rs]):.1f} {[round(r['tok_s'], 1) for r in rs]}; "
            f"TTFT p50 {med['ttft_p50']:.1f} p99 {med['ttft_p99']:.1f} ms; TPOT p50 "
            f"{med['tpot_p50']:.2f} ms {[round(r['slo']['tpot_p50'], 2) for r in rs]} "
            f"[{card}]")
        log(f"[sched] {name}: peak device memory {max(r['peak'] for r in rs) / 2**30:.2f} GiB "
            f"(all live batchers); graph pool grew {info[name]['pool'] / 2**20:.1f} MiB over "
            f"{info[name]['graphs']} graphs captured in {info[name]['capture_s']:.2f} s "
            f"(warm {info[name]['warm_s']:.1f} s); host launches per decode step "
            f"{'eager (see [model])' if name == 'A' else f'{launches_step:.3f} graph replays'}; "
            f"realized K {k_real if k_real is None else round(k_real, 2)}; group bursts "
            f"{d['group_bursts']} occupancy {occ if occ is None else round(occ, 3)}; prefill "
            f"chunks {d['prefill_chunks']}; flash launches {info[name]['launches']}")
        log(f"[sched] {name}: {len(same)} of {len(a0)} streams equal A's"
            + (f"; first differing generated step {diffs}" if diffs else "")
            + f"; stops equal to A's {stop_same} of {len(eos)}")
    return {name: info[name]["launches"][0] for name in SCHED_CONFIGS}, a0


def _pick_stops(tokens, prompts):
    """For each of STOP_STEPS, a request of the mixed wave (never the
    deepest, greedy_900, whose lane sets every burst's attention bucket)
    whose knobs-off token at that step is its first occurrence there, so
    the stop can only fire at that step: ``({label: eos}, {label:
    expected stream})``. Where no request qualifies, the next free one
    is taken and its stop fires at the token's first occurrence."""
    eos, expect, notes = {}, {}, []
    free = [lab for lab in prompts if lab != "greedy_900"]
    for step in STOP_STEPS:
        def first_at(lab):
            gen = tokens[lab][len(prompts[lab]):]
            return gen.index(gen[step])

        label = next((lab for lab in free if first_at(lab) == step), free[0])
        free.remove(label)
        n = len(prompts[label])
        eos[label] = tokens[label][n + step]
        fires = first_at(label)
        expect[label] = tokens[label][: n + fires + 1]
        notes.append(f"{label} eos {eos[label]} (its step-{step} token) fires at step {fires}")
    log("[sched] mid-burst stops on the mixed wave: " + "; ".join(notes))
    return eos, expect


def _p(key, probe, mixed):
    label = key.split("#")[0]
    return next(toks for lab, toks, _t, _s in list(probe) + list(mixed) if lab == label)


# the prefix phase (the JAX package's shared-prefix flagship scenario,
# seldon_core_tpu/modelbench.py bench_generate_shared_prefix, at
# llm-1.26b): 4 system prompts of 384 tokens, 32 prompts of a system
# prompt + a 64-token user suffix, 64 new tokens, 16 slots, cache length
# 640 (prompt 448 + 64 new + the burst's overhang, as that scenario)
PREFIX_BASE = dict(slots=16, steps_per_poll=16, pipeline_depth=3, attn_bucket=128,
                   max_seq=640)
PREFIX_BYTES = 2 << 30
SYSTEM_LEN, USER_LEN, N_SYSTEM, N_PROMPTS = 384, 64, 4, 32


def prefix_traffic():
    """``(systems, prompts)`` from RandomState(0), as the JAX scenario."""
    import numpy as np

    rs = np.random.RandomState(0)
    vocab = LLM_1_26B["vocab_size"]
    systems = [rs.randint(1, vocab, SYSTEM_LEN).tolist() for _ in range(N_SYSTEM)]
    prompts = [systems[i % N_SYSTEM] + rs.randint(1, vocab, USER_LEN).tolist()
               for i in range(N_PROMPTS)]
    return systems, prompts


def _prefix_run(gate, b, systems, prompts):
    """One run: the cache emptied, one priming request per system prompt
    (queued whole), then the 32 prompts queued whole. Tokens, the wave's
    tokens/s and SLO percentiles, the counters' deltas over priming and
    over the wave, the flash launches and the memory."""
    import torch

    from seldon_core_tpu_torch.ops import flash_attention as fa

    if b._prefix_index is not None:
        b._prefix_index.evict_to(0)  # every on-run primes and hits alike
    fa.LAUNCHES["flash_attention"] = 0
    s0 = dict(b.stats)
    for f in gate.submit_together(b, [(p, 0.0, 0, None) for p in systems]):
        f.result(timeout=600)
    s1 = dict(b.stats)
    b.slo_recent.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = [f.result(timeout=600)
           for f in gate.submit_together(b, [(p, 0.0, 0, None) for p in prompts])]
    wall = time.perf_counter() - t
    keys = [k for k, v in b.stats.items() if isinstance(v, (int, float))]
    return {"tokens": out, "tok_s": MAX_NEW * len(prompts) / wall, "slo": _slo(b),
            "prime": {k: s1[k] - s0[k] for k in keys},
            "wave": {k: b.stats[k] - s1[k] for k in keys},
            "launches": fa.LAUNCHES["flash_attention"],
            "peak": torch.cuda.max_memory_allocated(),
            "reserved": torch.cuda.memory_reserved(),
            "cache_bytes": b.stats["prefix_cache_bytes"]}


def phase_prefix(card, model, params):
    """The radix prefix cache at llm-1.26b (bf16, full width and depth):
    the shared-prefix traffic with the cache on (2 GiB) and off,
    alternated on, off, on in one process. Fails unless every
    request answers 64 tokens, each on-run's wave makes 32 hits and no
    miss after priming, the two on-runs give the same tokens, every
    priming miss launched the flash kernel and no decode graph is
    captured after warm(). Reports tokens/s, TTFT p50/p99, TPOT p50, the
    counters, the cache's bytes and the memory, and how many streams the
    cache leaves equal at bf16. Then one request composes a hit with
    prefill_chunk 128: a 300-token suffix chunked from the splice."""
    import gc

    import numpy as np
    import torch

    from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

    systems, prompts = prefix_traffic()
    # a gate each: a batcher parked at another's gate would let this one's
    # wave in over two polls
    gates = {"on": _Gate(), "off": _Gate()}
    layers = LLM_1_26B["n_layers"]
    live = {}
    for name, extra in (("on", dict(prefix_cache_hbm_bytes=PREFIX_BYTES)), ("off", {})):
        b = ContinuousBatcher(model, params, **PREFIX_BASE, **extra)
        b.fault_hook = gates[name]
        b.warm(prompt_lens=(SYSTEM_LEN, SYSTEM_LEN + USER_LEN), max_new_tokens=MAX_NEW)
        b.start()
        live[name] = b
    runs = {"on": [], "off": []}
    for name in ("on", "off", "on"):
        runs[name].append(_prefix_run(gates[name], live[name], systems, prompts))
    inline = {name: b.stats["graph_captures_inline"] for name, b in live.items()}
    for b in live.values():
        b.close()
    live.clear()
    gc.collect()
    torch.cuda.empty_cache()

    vocab = LLM_1_26B["vocab_size"]
    for name, rs in runs.items():
        for run in rs:
            for p, out in zip(prompts, run["tokens"]):
                if len(out) != len(p) + MAX_NEW or out[: len(p)] != p \
                        or not all(0 <= x < vocab for x in out):
                    raise AssertionError(f"[prefix] cache {name}: malformed tokens")
            whole = run["prime"]["prefill_steps"] + run["wave"]["prefill_steps"] \
                - run["wave"]["prefix_hits"]
            if run["launches"] < layers * whole:
                raise AssertionError(f"[prefix] cache {name}: {whole} whole-prompt prefills "
                                     f"but {run['launches']} flash launches")
        if inline[name]:
            raise AssertionError(f"[prefix] cache {name}: {inline[name]} graphs captured "
                                 "after warm()")
    for run in runs["on"]:
        w = run["wave"]
        if w["prefix_hits"] != N_PROMPTS or w["prefix_misses"] != 0:
            raise AssertionError(f"[prefix] {w['prefix_hits']} hits and {w['prefix_misses']} "
                                 f"misses after priming (want {N_PROMPTS} and 0)")
    if runs["on"][0]["tokens"] != runs["on"][1]["tokens"]:
        raise AssertionError("[prefix] the two cache-on runs gave other tokens")
    same = sum(a == b for a, b in zip(runs["on"][0]["tokens"], runs["off"][0]["tokens"]))
    firsts = [_first_diff(a[len(p):], b[len(p):]) for p, a, b in
              zip(prompts, runs["on"][0]["tokens"], runs["off"][0]["tokens"]) if a != b]
    for name, rs in runs.items():
        med = {m: float(np.median([r["slo"][m] for r in rs]))
               for m in ("ttft_p50", "ttft_p99", "tpot_p50")}
        w = rs[0]["wave"]
        log(f"[prefix] cache {name} ({len(rs)} runs, 32 prompts after {N_SYSTEM} priming "
            f"requests): tokens/s median {np.median([r['tok_s'] for r in rs]):.1f} "
            f"{[round(r['tok_s'], 1) for r in rs]}; TTFT p50 {med['ttft_p50']:.1f} p99 "
            f"{med['ttft_p99']:.1f} ms {[round(r['slo']['ttft_p50'], 1) for r in rs]}; TPOT "
            f"p50 {med['tpot_p50']:.2f} ms; wave: prefix_hits {w['prefix_hits']} "
            f"prefix_misses {w['prefix_misses']} prefix_tokens_saved "
            f"{w['prefix_tokens_saved']} prefill_tokens {w['prefill_tokens']} prefill "
            f"dispatches {w['prefill_steps']}; prefix_cache_bytes {rs[0]['cache_bytes']}; "
            f"flash launches {[r['launches'] for r in rs]}; peak allocated "
            f"{max(r['peak'] for r in rs) / 2**30:.2f} GiB, reserved "
            f"{max(r['reserved'] for r in rs) / 2**30:.2f} GiB (both batchers live) [{card}]")
    log(f"[prefix] checks: {N_PROMPTS} hits and 0 misses per cache-on wave, on-runs "
        f"repeat, no graph captured after warm(); bf16: {same} of {N_PROMPTS} streams "
        f"equal cache on vs off (first differing generated steps {sorted(firsts)})")

    # a hit composed with chunked prefill: the donor spliced into the
    # staging slab up to the chunk grid, the 300-token rest chunked
    b = ContinuousBatcher(model, params, **dict(PREFIX_BASE, max_seq=1024),
                          prefill_chunk=128, prefix_cache_hbm_bytes=PREFIX_BYTES)
    try:
        long_prompt = systems[0] + np.random.RandomState(1).randint(1, vocab, 300).tolist()
        b.warm(prompt_lens=(SYSTEM_LEN, len(long_prompt)), max_new_tokens=MAX_NEW)
        b.generate(systems[0], max_new_tokens=MAX_NEW)
        c0 = b.stats["prefill_chunks"]
        fut = b.submit(long_prompt, max_new_tokens=MAX_NEW)
        hit = fut.result(timeout=600)
        chunks = b.stats["prefill_chunks"] - c0
        if (b.stats["prefix_hits"] != 1 or fut.gen_request.cache_hit_tokens != SYSTEM_LEN
                or chunks <= 0 or len(hit) != len(long_prompt) + MAX_NEW):
            raise AssertionError(f"[prefix] chunked hit: hits {b.stats['prefix_hits']}, "
                                 f"cache_hit_tokens {fut.gen_request.cache_hit_tokens}, "
                                 f"chunks {chunks}, {len(hit)} tokens")
        b._prefix_index.evict_to(0)
        miss = b.generate(long_prompt, max_new_tokens=MAX_NEW)
        if b.stats["graph_captures_inline"]:
            raise AssertionError("[prefix] chunked hit: graphs captured after warm()")
        log(f"[prefix] a {len(long_prompt)}-token prompt with prefill_chunk 128: hit of "
            f"{SYSTEM_LEN} spliced, {chunks} chunks from position {SYSTEM_LEN}, 64 tokens; "
            f"bf16 against the same prompt chunked whole: "
            f"{'equal' if hit == miss else f'first differing step {_first_diff(hit[len(long_prompt):], miss[len(long_prompt):])}'}")
    finally:
        b.close()
    return {name: [r["launches"] for r in rs] for name, rs in runs.items()}


def phase_pressure(card, model, params, ref_tokens):
    """HBM pressure at llm-1.26b (bf16, the scheduler phase's B: graphs
    on, every other knob off, plus the ledger): the mixed wave queued
    whole while the fault config's pressure section shrinks the ledger
    to two lanes at the deepest bucket for 24 working polls, every
    request streamed through ``on_tokens``; then four of its requests
    under a budget of 64 bytes that is never restored. Fails unless
    lanes are preempted, every preemption resumes, every request answers
    64 tokens, every stream's spans concatenate to its tokens (nothing
    sent twice), the tiny-budget run ends, every whole prefill launched
    the flash kernel and no graph is captured after warm(). Reports how
    many streams equal the pressure-free B run's at bf16."""
    import torch

    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.resilience import FaultInjector

    _probe, mixed = serve_waves()
    gate = _Gate()
    b = _sched_batcher(model, params, dict(hbm_ledger_bytes=1 << 40), gate)
    kv = b._kv_key_bytes
    b.pressure_hook = FaultInjector([], pressure={
        "shrink_to_bytes": 2 * b.max_seq * kv, "after_polls": 3,
        "restore_after_polls": 24}).pressure_hook()
    try:
        b.warm(prompt_lens=WARM_LENS, max_new_tokens=MAX_NEW)
        b.start()
        spans = {label: [] for label, *_r in mixed}
        fa.LAUNCHES["flash_attention"] = 0
        s0 = dict(b.stats)
        t = time.perf_counter()
        futs = gate.submit_together(b, [(toks, temp, seed, None) for _l, toks, temp, seed in mixed],
                                    on_tokens=[spans[label].append for label, *_r in mixed])
        out = {label: f.result(timeout=600) for (label, *_r), f in zip(mixed, futs)}
        wall = time.perf_counter() - t
        d = {k: b.stats[k] - s0[k] for k in ("preemptions", "preempt_resumes", "replayed_tokens",
                                             "prefill_steps", "prefill_chunks")}
        launches = fa.LAUNCHES["flash_attention"]
        for label, toks, _t, _s in mixed:
            gen = out[label][len(toks):]
            if len(gen) != MAX_NEW or out[label][: len(toks)] != toks:
                raise AssertionError(f"[pressure] {label}: {len(gen)} tokens")
            if [x for span in spans[label] for x in span] != gen:
                raise AssertionError(f"[pressure] {label}: its streamed spans are not its tokens")
        if d["preemptions"] <= 0 or d["preempt_resumes"] != d["preemptions"]:
            raise AssertionError(f"[pressure] {d['preemptions']} preemptions, "
                                 f"{d['preempt_resumes']} resumes")
        whole = d["prefill_steps"] - d["prefill_chunks"]
        if launches < LLM_1_26B["n_layers"] * whole:
            raise AssertionError(f"[pressure] {whole} whole prefills, {launches} flash launches")
        ref_tokens = ref_tokens or {}
        same = [label for label, *_r in mixed if out[label] == ref_tokens.get(label)]
        firsts = {label: _first_diff(out[label][len(toks):], ref_tokens[label][len(toks):])
                  for label, toks, _t, _s in mixed if label not in same and label in ref_tokens}
        log(f"[pressure] mixed wave under a 24-poll shrink to {2 * b.max_seq * kv} B: "
            f"preemptions {d['preemptions']}, resumes {d['preempt_resumes']}, replayed tokens "
            f"{d['replayed_tokens']}, every request 64 tokens, streamed spans equal to the "
            f"tokens; {MAX_NEW * len(mixed) / wall:.1f} tokens/s; flash launches {launches} "
            f"[{card}]")
        log(f"[pressure] bf16: {len(same)} of {len(mixed)} streams equal the pressure-free B "
            f"run's" + (f"; first differing generated steps {firsts}" if firsts else ""))
        # a budget below one lane, never restored, from the second poll
        # (all four admitted): three are preempted, then one lane at a time
        b.pressure_hook = FaultInjector([], pressure={
            "shrink_to_bytes": 64, "after_polls": b._work_poll_count + 2}).pressure_hook()
        p0 = b.stats["preemptions"]
        t = time.perf_counter()
        tiny = [f.result(timeout=300) for f in gate.submit_together(
            b, [(toks, temp, seed, None) for _l, toks, temp, seed in mixed[:4]])]
        if any(len(o) != len(m[1]) + MAX_NEW for o, m in zip(tiny, mixed[:4])):
            raise AssertionError("[pressure] tiny budget: a request came back short")
        if b.stats["graph_captures_inline"]:
            raise AssertionError(f"[pressure] {b.stats['graph_captures_inline']} graphs "
                                 "captured after warm()")
        log(f"[pressure] budget 64 B never restored: 4 requests ended in "
            f"{time.perf_counter() - t:.1f} s, {b.stats['preemptions'] - p0} preemptions; "
            f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    finally:
        b.close()
    return launches


SMALL_CFG = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
                 d_ff=512, max_seq=128, dtype="float32")


# the separate draft of S1: a model that shares nothing with the target
# (tests/test_generate_serving.py's bad draft at this vocab), head dim 8
SMALL_DRAFT_CFG = dict(vocab_size=512, d_model=16, n_layers=1, n_heads=2, n_kv_heads=1,
                       d_ff=32, max_seq=128, dtype="float32")


def _take_freed_draft_block(b):
    """While rung 2 keeps speculation off, hold the block the draft cache
    was freed from, so that the resume allocates it elsewhere and must
    capture the spec graphs again."""
    import torch

    suppress, taken = b._suppress_speculation, []

    def suppress_and_take():
        ptr, nbytes = b._draft_buf.data_ptr(), b._draft_buf.nbytes
        suppress()
        for _ in range(64):
            taken.append(torch.empty(nbytes, dtype=torch.uint8, device=b.device))
            if taken[-1].data_ptr() == ptr:
                break

    b._suppress_speculation = suppress_and_take


def phase_small_scheduler():
    """f32 small model on the card: configurations A-E (the full-width
    phase's knobs at this size, MIN_ATTN_BUCKET lowered to 16 so that
    depth groups really split), P (the prefix cache: the second pass
    hits what the first published) and Q (the ledger shrunk to one lane
    at the deepest bucket during the second pass: lanes are preempted
    and resume) give the same tokens, greedy and seeded; the
    speculation configurations S1 (a separate draft, head dim 8: its
    prefill runs the flash kernel's mma route), S2 (an early-exit self-draft of
    one layer), S3 (S2 + fused 64, which degrades to spec bursts), S4
    (S2 + forced depth groups + prefill_chunk), S5 (S2 + the prefix
    cache), S6 (S2, its second pass greedy-only under a ledger shrink
    that fires rung 2 and then rung 3, then the restore) and S7 (S6
    without warm(), so that every spec graph is captured at its first
    dispatch, and with the freed draft block taken while speculation is
    off, so that the resume finds the draft cache at a new address) give
    A's tokens for every greedy request, and their seeded requests repeat
    (one at a time = together; S3-S7 = S2). No graph is captured after
    warm() but the spec graphs a resume captures again when the draft
    cache moved (S6, S7: reported, and in S7 each of them at least once).
    Prints the flash kernel's launches by route, dtype and head dim over
    the phase."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.llm import DecoderLM
    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.resilience import FaultInjector
    from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

    model = DecoderLM(device="cuda", **SMALL_CFG)
    params = model.init_params(0, device="cuda")
    bad = DecoderLM(device="cuda", **SMALL_DRAFT_CFG)
    self_draft = DecoderLM(device="cuda", **{**SMALL_CFG, "n_layers": 1})
    drafts = {
        "bad": dict(draft_model=bad, draft_params=bad.init_params(99, device="cuda"),
                    speculate_tokens=4),
        "self": dict(draft_model=self_draft, speculate_tokens=4, draft_params={
            **params, "blocks": {k: w[:1] for k, w in params["blocks"].items()}}),
    }
    rs = np.random.RandomState(5)
    lens = (5, 39, 12, 50, 20, 3, 60, 33)
    reqs = [(rs.randint(0, SMALL_CFG["vocab_size"], n).tolist(),
             dict(max_new_tokens=24 + i % 5, **({"temperature": 0.9, "seed": i} if i % 2 else {})))
            for i, n in enumerate(lens)]
    greedy = [i for i, (_p, r) in enumerate(reqs) if "temperature" not in r]
    base = dict(slots=4, prefill_buckets=(32, 64), steps_per_poll=4, attn_bucket=16)
    fused = dict(fused_steps_per_dispatch=16)
    configs = {"A": dict(cuda_graphs=False), "B": {}, "C": fused,
               "D": dict(fused, depth_groups=4, depth_group_split_bytes=0),
               "E": dict(fused, prefill_chunk=32),
               "P": dict(prefix_cache_hbm_bytes=1 << 30, prefix_cache_min_tokens=4),
               "Q": dict(hbm_ledger_bytes=1 << 40),
               "S1": drafts["bad"], "S2": drafts["self"],
               "S3": dict(drafts["self"], fused_steps_per_dispatch=64),
               "S4": dict(drafts["self"], depth_groups=4, depth_group_split_bytes=0,
                          prefill_chunk=32),
               "S5": dict(drafts["self"], prefix_cache_hbm_bytes=1 << 30,
                          prefix_cache_min_tokens=4),
               "S6": dict(drafts["self"], hbm_ledger_bytes=1 << 40),
               "S7": dict(drafts["self"], hbm_ledger_bytes=1 << 40)}
    old = ContinuousBatcher.MIN_ATTN_BUCKET
    ContinuousBatcher.MIN_ATTN_BUCKET = 16
    outs, notes = {}, []
    fa.ROUTE_LAUNCHES.clear()
    try:
        for name, kw in configs.items():
            b = ContinuousBatcher(model, params, **base, **kw)
            try:
                lane = b._attn_need(b.max_seq) * b._kv_key_bytes
                if name in ("Q", "S6"):
                    # armed before warm(), which then captures the replay
                    # step (and with a draft the plain bursts); the shrink
                    # lands during the second pass
                    b.pressure_hook = FaultInjector([], pressure={
                        "shrink_to_bytes": lane, "after_polls": 1 << 30,
                        "restore_after_polls": 12}).pressure_hook()
                if name == "S7":
                    _take_freed_draft_block(b)
                else:
                    b.warm(prompt_lens=lens, max_new_tokens=28)
                got = [[b.submit(p, **r).result(timeout=300) for p, r in reqs]]
                second = reqs
                if name in ("Q", "S6", "S7"):
                    b.pressure_hook = FaultInjector([], pressure={
                        "shrink_to_bytes": int((1.0 if name == "Q" else 1.1) * lane),
                        "after_polls": b._work_poll_count + 3,
                        "restore_after_polls": 12}).pressure_hook()
                if name in ("S6", "S7"):
                    # rung 2 waits while a lane samples: a greedy-only pass
                    second = [reqs[i] for i in greedy]
                futs = [b.submit(p, **r) for p, r in second]
                got.append([f.result(timeout=300) for f in futs])
                if name in ("S6", "S7"):
                    actions = {e["action"] for e in b.pressure_events}
                    if not {"cancel_speculation", "resume_speculation"} <= actions:
                        raise AssertionError(f"[small-sched] {name}: reclaim actions {actions}")
                    _wait_for(lambda: not b._spec_suppressed,
                              f"{name}: speculation back after the window")
                    got[1] = [got[1][greedy.index(i)] if i in greedy else got[0][i]
                              for i in range(len(reqs))]
                s = b.stats
                # after warm() the only captures allowed are the spec graphs
                # a resume captures again over a moved draft cache
                after_warm = s["graph_captures_inline"] - s["spec_graph_recaptures"]
                if name not in ("A", "S7") and after_warm:
                    raise AssertionError(f"[small-sched] {name}: {after_warm} graphs captured "
                                         "after warm()")
                if name == "S7" and not (s["spec_graph_recaptures"] and not s["spec_graph_reuses"]):
                    raise AssertionError(f"[small-sched] S7: the draft cache did not move "
                                         f"({s['spec_graph_recaptures']} re-captures, "
                                         f"{s['spec_graph_reuses']} reuses)")
            finally:
                b.close()
            if got[0] != got[1]:
                raise AssertionError(f"[small-sched] {name}: one at a time != together")
            outs[name] = got[0]
            notes.append(f"{name} graphs {s['graphs_captured']} fused {s['fused_dispatches']} "
                         f"group bursts {s['group_bursts']} chunks {s['prefill_chunks']} "
                         f"prefix hits {s['prefix_hits']} preemptions {s['preemptions']}"
                         + (f" spec rounds {s['spec_rounds']} tokens/round "
                            f"{s['spec_emitted'] / max(1, s['spec_rounds']):.2f} spec graphs "
                            f"re-captured {s['spec_graph_recaptures']} reused "
                            f"{s['spec_graph_reuses']}, graphs captured after warm() "
                            f"{s['graph_captures_inline']}"
                            + (" (no warm())" if name == "S7" else "")
                            if name.startswith("S") else ""))
            if name == "D" and not s["group_bursts"]:
                raise AssertionError("[small-sched] D: groups never split")
            if name == "S4" and s["group_bursts"]:
                raise AssertionError("[small-sched] S4: a spec burst split into groups")
            if name in ("E", "S4") and not s["prefill_chunks"]:
                raise AssertionError(f"[small-sched] {name}: nothing was chunked")
            # the second pass hits every prompt the first one published
            # (a match leaves one token to compute: n - 1 >= 4 needed)
            if name in ("P", "S5") and s["prefix_hits"] != sum(len(p) > 4 for p, _r in reqs):
                raise AssertionError(f"[small-sched] {name}: {s['prefix_hits']} prefix hits")
            if name in ("Q", "S6") and not (0 < s["preemptions"] == s["preempt_resumes"]):
                raise AssertionError(f"[small-sched] {name}: {s['preemptions']} preemptions, "
                                     f"{s['preempt_resumes']} resumes")
            if name.startswith("S") and not s["spec_rounds"]:
                raise AssertionError(f"[small-sched] {name}: no speculation round ran")
            if name == "S3" and s["fused_dispatches"]:
                raise AssertionError("[small-sched] S3: the fused plan ran under speculation")
    finally:
        ContinuousBatcher.MIN_ATTN_BUCKET = old
    for name, got in outs.items():
        # speculation changes seeded streams (its draws differ), never
        # greedy ones; within speculation every knob is on = off
        ref, idx = ("A", range(len(reqs))) if not name.startswith("S") else (
            ("A", greedy) if name in ("S1", "S2") else ("S2", range(len(reqs))))
        bad_ix = [i for i in idx if got[i] != outs[ref][i]]
        if name.startswith("S") and ref == "S2":
            bad_ix += [i for i in greedy if got[i] != outs["A"][i]]
        if bad_ix:
            raise AssertionError(f"[small-sched] {name} != {ref} at f32 (requests {bad_ix})")
    log(f"[small-sched] f32 on the card: A == B == C == D == E == P == Q token for token, "
        f"greedy and seeded, {len(reqs)} requests one at a time and together (P: prefix cache "
        f"on = off; Q: preempted = not); S1 (separate draft, Dh 8) and S2-S7 (self-draft; "
        f"fused, depth groups + chunk, prefix cache, rungs 2 and 3, rungs 2 and 3 with no "
        f"warm() and a moved draft cache) == A for every greedy request, S3-S7 == S2 seeded "
        f"too; " + "; ".join(notes))
    log(f"[small-sched] flash launches over the phase by route: "
        f"{dict(sorted(fa.ROUTE_LAUNCHES.items()))}")


# the prefill buckets profiled (every bucket's wall time is taken)
MODEL_PROFILED_BUCKETS = (128, 1024)


def phase_model(model, params):
    """Model-layer times at full width: prefill per bucket (B=1), and one
    ragged decode step over 8 lanes — its wall time beside the device
    time its kernels take (torch.profiler), whose gap is the host's
    dispatch time, and the step's weight-read bound."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    cfg = model.cfg
    rs = np.random.RandomState(2)
    prompts = {t: torch.tensor(rs.randint(0, cfg.vocab_size, (1, t)), device="cuda")
               for t in (32, 128, 512, 1024)}
    wall = {t: time_ms(lambda: model.prefill(params, toks, t), iters=5, warmup=1)
            for t, toks in prompts.items()}
    # then, under the profiler (after all the wall times: a profiler run
    # can slow later launches), the flash kernel's device time inside a
    # prefill, by its name in the per-kernel sums
    for t in MODEL_PROFILED_BUCKETS:
        toks, n = prompts[t], 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                model.prefill(params, toks, t)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
        flash = [e for e in events if "flash_fwd" in e.key]
        flash_ms = sum(e.self_device_time_total for e in flash) / 1e3 / n
        flash_calls = sum(e.count for e in flash) / n
        log(f"[model] prefill B=1 T={t}: {wall[t]:.2f} ms; device busy {busy_ms:.3f} ms, of "
            f"which the flash kernel {flash_ms:.4f} ms over {flash_calls:.0f} launches "
            f"({100 * flash_ms / busy_ms:.1f}% of the device time)")
    # a prefix hit's suffix prefill (the prefix phase's shape: a 384-token
    # match in a 512-position donor slab, the 64-token suffix padded to
    # its 128 bucket) against the full prefill of the 512 bucket it skips
    # (and the batched m=8 full prefill the cache-off run admits with)
    toks = prompts[512]
    _logits, donor = model.prefill(params, toks, 512)
    suffix = toks[:, :128].clone()
    last = torch.tensor([USER_LEN - 1], device="cuda")
    toks8 = toks.expand(8, -1).contiguous()
    cases = {"hit suffix prefill (W 128 over a 512 donor at 384)":
             lambda: model.prefill_with_prefix(params, donor, suffix, SYSTEM_LEN, last_index=last),
             "full prefill (T 512)": lambda: model.prefill(params, toks, 512),
             "full prefill m=8 (T 512)": lambda: model.prefill(params, toks8, 512)}
    busy = {}
    for name, fn in cases.items():
        wall_ms = time_ms(fn, iters=5, warmup=1)
        n = 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        busy[name] = sum(e.self_device_time_total for e in events) / 1e3 / n
        ops = sum(e.count for e in events) / n
        log(f"[prefix] {name}: wall {wall_ms:.2f} ms, device busy {busy[name]:.3f} ms "
            f"({ops:.0f} device ops)")
    hit_ms, full_ms, _m8 = busy.values()
    log(f"[prefix] a hit's suffix prefill takes {hit_ms / full_ms:.3f} of the full "
        f"prefill's device time")
    shape = (8, cfg.n_kv_heads, cfg.max_seq, cfg.head_dim)
    ks = [torch.zeros(shape, dtype=model.dtype, device="cuda") for _ in range(cfg.n_layers)]
    vs = [torch.zeros(shape, dtype=model.dtype, device="cuda") for _ in range(cfg.n_layers)]
    tok = torch.zeros((8, 1), dtype=torch.long, device="cuda")
    weight_ms = model.n_params() * 2 / PEAK_BYTES_S * 1e3
    for attn_len in (128, 1024):
        pos = torch.full((8,), attn_len - 1, dtype=torch.long, device="cuda")

        def step():
            model.decode_step_ragged_list(params, ks, vs, tok, pos, attn_len=attn_len)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        # 1 eager step traced (the profiler's processing takes ~2 s a
        # step; the 3 warm steps above precede it)
        n = 1
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        device_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
        kernels = sum(e.count for e in events) / n
        log(f"[model] decode step, 8 lanes, attn_len {attn_len}: wall {wall_ms:.2f} ms, "
            f"device busy {device_ms:.2f} ms ({kernels:.0f} device ops), "
            f"weight-read bound {weight_ms:.2f} ms")
    log(f"[time] model: prefill, suffix prefill and decode step profiles "
        f"{time.perf_counter() - t_phase:.1f} s")
    phase_burst(model, params, weight_ms)


# steps of the eager burst the model phase traces (the profiler's processing
# of an eager step takes ~2 s on the card's host; the replayed burst is
# traced whole)
PROF_EAGER_K = 2


def phase_burst(model, params, weight_ms, k=16, n=6, n_eager=2):
    """A whole decode burst through the batcher (8 lanes, k steps), eager
    (graphs off) against CUDA-graph replay: per step, the host's wall
    time (uninstrumented, host clock), the device span (CUDA events),
    the device-busy time and device operations (``torch.profiler``), the
    launches the host made (``cudaLaunchKernel`` / ``cudaGraphLaunch``)
    and the busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

    for graphs in (False, True):
        b = ContinuousBatcher(model, params, **SCHED_BASE, cuda_graphs=graphs)
        try:
            b.warm(prompt_lens=(100, 900), max_new_tokens=0)
            b._whole.act.fill_(True)
            for attn_len in (128, 1024):
                def burst():
                    b._whole_burst(k, attn_len, False, False)
                    b._whole.pos.zero_()

                burst()
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                # an eager step takes ~45 ms of host launches: 2 bursts
                # are enough for its per-step wall time
                reps = n if graphs else n_eager
                t0 = time.perf_counter()
                start.record()
                for _ in range(reps):
                    burst()
                end.record()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / (reps * k)
                span = start.elapsed_time(end) / (reps * k)
                # the profiler's host-side processing of a traced eager
                # burst (~2,260 device operations a step) takes seconds a
                # step: an eager burst of PROF_EAGER_K steps and one
                # replayed burst of k are enough for per-step averages
                steps = k if graphs else PROF_EAGER_K
                t_prof = time.perf_counter()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    b._whole_burst(steps, attn_len, False, False)
                    b._whole.pos.zero_()
                    torch.cuda.synchronize()
                events = prof.key_averages()
                dev = [e for e in events if e.device_type.name == "CUDA"]
                busy = sum(e.self_device_time_total for e in dev) / 1e3 / steps
                ops = sum(e.count for e in dev) / steps
                calls = {name: sum(e.count for e in events if e.key == name) / steps
                         for name in ("cudaLaunchKernel", "cudaGraphLaunch")}
                log(f"[burst] {'graph replay' if graphs else 'eager'}, 8 lanes, k {k}, attn_len "
                    f"{attn_len}, per step (a burst of {steps} profiled in "
                    f"{time.perf_counter() - t_prof:.1f} s): wall {wall:.3f} ms, device span "
                    f"{span:.3f} ms, "
                    f"device busy {busy:.3f} ms ({ops:.0f} device ops), host launches "
                    f"cudaLaunchKernel {calls['cudaLaunchKernel']:.1f} cudaGraphLaunch "
                    f"{calls['cudaGraphLaunch']:.2f}, busy share of wall {busy / wall:.3f}; "
                    f"weight-read bound {weight_ms:.2f} ms")
        finally:
            b.close()


# the speculation phase: the JAX package's "llm-1.26b-latency" /
# "llm-1.26b-specdecode" pair (seldon_core_tpu/modelbench.py), built
# through GenerateServer's parameters
SPEC_SLOTS, SPEC_MAX_SEQ, SPEC_PROMPT, SPEC_NEW = 4, 512, 128, 256
SPEC_SIDES = {
    "off": [{"name": "steps_per_poll", "value": "8", "type": "INT"}],
    "on": [{"name": "steps_per_poll", "value": "4", "type": "INT"},
           {"name": "speculate_tokens", "value": "4", "type": "INT"},
           {"name": "draft_layers", "value": "6", "type": "INT"}],
}
# the pressure window's server: speculation on, with the HBM ledger (its
# warm() then also captures the plain bursts rung 2 falls back to)
SPEC_SIDES["ledger"] = SPEC_SIDES["on"] + [
    {"name": "hbm_ledger_bytes", "value": str(1 << 40), "type": "INT"}]
SPEC_WINDOW_POLLS = 48


def _spec_server(model_dir, side):
    from seldon_core_tpu_torch import microservice

    params = [{"name": "model_uri", "value": model_dir, "type": "STRING"},
              {"name": "device", "value": "cuda", "type": "STRING"},
              {"name": "slots", "value": str(SPEC_SLOTS), "type": "INT"},
              {"name": "max_seq", "value": str(SPEC_MAX_SEQ), "type": "INT"},
              {"name": "pipeline_depth", "value": "3", "type": "INT"},
              {"name": "warmup_prompt_lens", "value": str(SPEC_PROMPT), "type": "STRING"},
              {"name": "warmup_max_new_tokens", "value": str(SPEC_NEW), "type": "INT"},
              ] + SPEC_SIDES[side]
    user = microservice.build_user_object(
        "seldon_core_tpu_torch.servers.generateserver.GenerateServer", json.dumps(params))
    user.load()  # load, the self-draft, and warm() with its graph captures
    return user


def _spec_run(gate, user, wave, seeded):
    """One run: the four greedy prompts queued whole, then the seeded
    request alone. Tokens, tokens/s over the wave, the SLO percentiles,
    the counters' deltas, flash launches and peak memory."""
    import torch

    from seldon_core_tpu_torch.ops import flash_attention as fa

    b = user.batcher
    b.slo_recent.clear()
    s0 = dict(b.stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES["flash_attention"] = 0
    t = time.perf_counter()
    futs = gate.submit_together(b, [(toks, 0.0, 0, None) for toks in wave], max_new=SPEC_NEW)
    out = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t
    slo = _slo(b)
    toks, temp, seed = seeded
    out.append(b.submit(toks, max_new_tokens=SPEC_NEW, temperature=temp, seed=seed)
               .result(timeout=600))
    d = {k: v - s0[k] for k, v in b.stats.items() if isinstance(v, (int, float))}
    return {"tokens": out, "tok_s": SPEC_NEW * len(wave) / wall, "slo": slo, "delta": d,
            "launches": fa.LAUNCHES["flash_attention"],
            "peak": torch.cuda.max_memory_allocated()}


def _window_run(gate, b, prompts, hook):
    """One run of the pressure window's traffic, queued whole, with
    ``hook`` as the batcher's pressure hook (None: no window); waits for
    speculation to be back before it returns."""
    import torch

    b.pressure_hook = hook
    b.slo_recent.clear()
    b.pressure_events.clear()
    s0 = dict(b.stats)
    torch.cuda.synchronize()
    t = time.perf_counter()
    futs = gate.submit_together(b, [(p, 0.0, 0, None) for p in prompts], max_new=SPEC_NEW)
    out = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t
    _wait_for(lambda: not b._spec_suppressed, "[spec-pressure] speculation back after the window")
    b.pressure_hook = None
    actions = [e["action"] for e in list(b.pressure_events) if e.get("type") == "pressure_reclaim"]
    return dict(out=out, wall=wall, slo=_slo(b),
                d={k: v - s0[k] for k, v in b.stats.items() if isinstance(v, (int, float))},
                actions={a: actions.count(a) for a in sorted(set(actions))})


def phase_spec_pressure(card):
    """Rung 2 at llm-1.26b, the spec phase's configuration: a server with
    speculation and the HBM ledger serves eight concurrent greedy 128-token
    prompts (twice its slots), 256 new tokens each, twice: free,
    then under a window that, four working polls in, shrinks the ledger
    to 1.36x the live lanes' target K/V (over the high watermark with the
    draft cache, under the low one without it) for SPEC_WINDOW_POLLS
    polls. Rung 2 cancels speculation; as the lanes deepen, rung 3
    preempts; greedy requests are admitted while speculation is off.
    Fails unless every request answers 256 tokens, speculation is
    cancelled and comes back, every preemption resumes, and no graph is
    captured after warm() but the spec graphs a resume captures again
    over a moved draft cache. Prints TTFT, TPOT and tokens/s of both
    runs."""
    import numpy as np

    rs = np.random.RandomState(11)
    prompts = [rs.randint(0, LLM_1_26B["vocab_size"], SPEC_PROMPT).tolist()
               for _ in range(2 * SPEC_SLOTS)]
    gate = _Gate()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-spec-pressure-") as model_dir:
        with open(os.path.join(model_dir, "jax_config.json"), "w") as f:
            json.dump({"family": "llm", "config": LLM_1_26B}, f)
        t0 = time.perf_counter()
        user = _spec_server(model_dir, "ledger")
        b = user.batcher
        b.fault_hook = gate
        log(f"[spec-pressure] server with the ledger loaded and warmed in "
            f"{time.perf_counter() - t0:.1f} s ({b.stats['graphs_captured']} graphs)")
        try:
            runs = {"free": _window_run(gate, b, prompts, None)}
            state = {}
            start = b._work_poll_count + 4

            def hook(poll):
                if poll == start:
                    live = sum(b._attn_need(p) for p in b._pos_host.values())
                    state["budget"] = int(1.36 * live * b._kv_key_bytes)
                    return state["budget"]
                return -1 if poll == start + SPEC_WINDOW_POLLS else None

            runs["window"] = _window_run(gate, b, prompts, hook)
        finally:
            user.close()
    for name, r in runs.items():
        for toks, o in zip(prompts, r["out"]):
            if len(o) != len(toks) + SPEC_NEW or o[: len(toks)] != toks:
                raise AssertionError(f"[spec-pressure] {name}: a request did not answer "
                                     f"{SPEC_NEW} tokens")
    same = sum(a == f for a, f in zip(runs["window"]["out"], runs["free"]["out"]))
    for name, r in runs.items():
        slo, dd = r["slo"], r["d"]
        log(f"[spec-pressure] {name}: {len(prompts)} greedy requests on {SPEC_SLOTS} slots, "
            f"tokens/s {SPEC_NEW * len(prompts) / r['wall']:.1f}, TTFT p50 {slo['ttft_p50']:.1f} "
            f"ms p99 {slo['ttft_p99']:.1f} ms, TPOT p50 {slo['tpot_p50']:.2f} ms, tokens per "
            f"round {dd['spec_emitted'] / max(1, dd['spec_rounds']):.3f}, reclaim actions "
            f"{r['actions']}, preemptions {dd['preemptions']}, spec graphs re-captured "
            f"{dd['spec_graph_recaptures']} (captures after warm()) reused "
            f"{dd['spec_graph_reuses']}"
            + (f", budget {state['budget']} B for {SPEC_WINDOW_POLLS} polls"
               if name == "window" else "") + f" [{card}]")
    log(f"[spec-pressure] bf16: {same} of {len(prompts)} greedy streams of the window equal "
        f"the free run's")
    d, acts = runs["window"]["d"], runs["window"]["actions"]
    if not acts.get("cancel_speculation") or not acts.get("resume_speculation"):
        raise AssertionError(f"[spec-pressure] reclaim actions {acts}")
    if d["preempt_resumes"] != d["preemptions"]:
        raise AssertionError(f"[spec-pressure] {d['preemptions']} preemptions, "
                             f"{d['preempt_resumes']} resumes")
    for name, r in runs.items():
        after_warm = r["d"]["graph_captures_inline"] - r["d"]["spec_graph_recaptures"]
        if after_warm:
            raise AssertionError(f"[spec-pressure] {name}: {after_warm} graphs captured "
                                 "after warm()")


def phase_spec(card):
    """Speculative decoding at llm-1.26b, full width and depth (bf16,
    random weights from seed 0), 4 slots, cache length 512: four
    concurrent 128-token greedy prompts with 256 new tokens each, then a
    seeded request alone. Off: steps_per_poll 8. On: steps_per_poll 4,
    speculate_tokens 4, draft_layers 6 (an early-exit self-draft). Runs
    off, on, on in one process. Fails unless every request answers
    256 tokens, the two on-runs are token-identical (the seeded request
    too), no graph is captured after warm(), a round emits 1..5 tokens
    on average and every prefill (target and draft) launched the flash
    kernel. Returns the flash launches of the first on-run."""
    import numpy as np

    rs = np.random.RandomState(11)
    vocab = LLM_1_26B["vocab_size"]
    wave = [rs.randint(0, vocab, SPEC_PROMPT).tolist() for _ in range(SPEC_SLOTS)]
    seeded = (rs.randint(0, vocab, SPEC_PROMPT).tolist(), 0.8, 5)
    gate = _Gate()
    users = {}
    runs = {"off": [], "on": []}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-spec-") as model_dir:
        with open(os.path.join(model_dir, "jax_config.json"), "w") as f:
            json.dump({"family": "llm", "config": LLM_1_26B}, f)
        try:
            for side in ("off", "on"):
                t0 = time.perf_counter()
                users[side] = _spec_server(model_dir, side)
                users[side].batcher.fault_hook = gate
                st = users[side].batcher.stats
                log(f"[spec] {side}: GenerateServer loaded and warmed in "
                    f"{time.perf_counter() - t0:.1f} s ({st['graphs_captured']} graphs, "
                    f"{st['graph_capture_s']:.2f} s of capture)")
            # off, on, on (the trailing off run is cut for the time budget;
            # the two on-runs must repeat each other)
            for side in ("off", "on", "on"):
                runs[side].append(_spec_run(gate, users[side], wave, seeded))
            metrics = {side: {m["key"]: m["value"] for m in users[side].metrics()
                              if m["type"] == "GAUGE"} for side in users}
            inline = {side: u.batcher.stats["graph_captures_inline"] for side, u in users.items()}
        finally:
            for u in users.values():
                u.close()
    for side, rr in runs.items():
        for r in rr:
            for toks, out in zip(wave + [seeded[0]], r["tokens"]):
                if len(out) != len(toks) + SPEC_NEW or out[: len(toks)] != toks \
                        or not all(0 <= x < vocab for x in out):
                    raise AssertionError(f"[spec] {side}: a request did not answer "
                                         f"{SPEC_NEW} tokens")
            d = r["delta"]
            # every prefill runs the flash kernel per layer: the target's,
            # and with speculation the 6-layer draft's of the same prompt
            per_prefill = LLM_1_26B["n_layers"] + (6 if side == "on" else 0)
            if r["launches"] < per_prefill * d["prefill_steps"]:
                raise AssertionError(f"[spec] {side}: {d['prefill_steps']} prefills, "
                                     f"{r['launches']} flash launches")
    if runs["on"][0]["tokens"] != runs["on"][1]["tokens"]:
        raise AssertionError("[spec] the two on-runs gave other tokens")
    if any(inline.values()):
        raise AssertionError(f"[spec] graphs captured after warm(): {inline}")
    for i, r in enumerate(runs["on"]):
        d = r["delta"]
        per_round = d["spec_emitted"] / max(1, d["spec_rounds"])
        if not 1.0 <= per_round <= 5.0:
            raise AssertionError(f"[spec] on-run {i}: {per_round} tokens per round")
    for side in ("off", "on"):
        for i, r in enumerate(runs[side]):
            d, slo = r["delta"], r["slo"]
            extra = ""
            if side == "on":
                extra = (f", spec rounds {d['spec_rounds']} (lane-rounds), tokens per round "
                         f"{d['spec_emitted'] / max(1, d['spec_rounds']):.3f}, bursts "
                         f"{d['steps'] // 4}, graph replays per round "
                         f"{d['graph_replays'] / max(1, d['steps']):.3f}, draft+target flash "
                         f"launches {r['launches']}")
            log(f"[spec] {side} run {i + 1}: tokens/s {r['tok_s']:.1f}, TTFT p50 "
                f"{slo['ttft_p50']:.1f} ms p99 {slo['ttft_p99']:.1f} ms, TPOT p50 "
                f"{slo['tpot_p50']:.2f} ms, graph replays {d['graph_replays']}, peak allocated "
                f"{r['peak'] / 2**30:.2f} GiB{extra} [{card}]")
    same = sum(a == b for a, b in zip(runs["on"][0]["tokens"][:SPEC_SLOTS],
                                      runs["off"][0]["tokens"][:SPEC_SLOTS]))
    firsts = [_first_diff(a[SPEC_PROMPT:], b[SPEC_PROMPT:])
              for a, b in zip(runs["on"][0]["tokens"][:SPEC_SLOTS],
                              runs["off"][0]["tokens"][:SPEC_SLOTS]) if a != b]
    ratio = {k: np.median([r[k] for r in runs["on"]]) / np.median([r[k] for r in runs["off"]])
             for k in ("tok_s",)}
    tpot = (np.median([r["slo"]["tpot_p50"] for r in runs["on"]])
            / np.median([r["slo"]["tpot_p50"] for r in runs["off"]]))
    log(f"[spec] on/off: tokens/s x{ratio['tok_s']:.3f}, TPOT p50 x{tpot:.3f}; the two on-runs "
        f"token-identical (seeded included); bf16 greedy streams equal on vs off: {same} of "
        f"{SPEC_SLOTS}" + (f" (first differing generated steps {firsts})" if firsts else "")
        + f"; gen_spec_tokens_per_round {metrics['on'].get('gen_spec_tokens_per_round')}; "
        f"graph_captures_inline {inline} [{card}]")
    return runs["on"][0]["launches"]


def phase_spec_round(model, params):
    """One speculation round against gamma + 1 = 5 plain decode steps at
    llm-1.26b, B = 4, attention length 512: device-busy time and device
    operations (torch.profiler) of the 4 draft steps of a 6-layer
    early-exit draft, of the W = 5 verify chunk, of the whole round
    through the batcher (sampling and acceptance included, eager) and of
    5 one-position decode steps of the target."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from seldon_core_tpu_torch.models.llm import DecoderLM
    from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

    cfg = model.cfg
    B, A, g = 4, 512, 4
    draft = DecoderLM(device="cuda", **{**dataclasses.asdict(cfg), "n_layers": 6})
    dparams = {**params, "blocks": {k: w[:6] for k, w in params["blocks"].items()}}

    def cache(n_layers):
        shape = (B, cfg.n_kv_heads, A, cfg.head_dim)
        return ([torch.zeros(shape, dtype=model.dtype, device="cuda") for _ in range(n_layers)],
                [torch.zeros(shape, dtype=model.dtype, device="cuda") for _ in range(n_layers)])

    ks, vs = cache(cfg.n_layers)
    dks, dvs = cache(6)
    tok = torch.zeros((B, 1), dtype=torch.long, device="cuda")
    win = torch.zeros((B, g + 1), dtype=torch.long, device="cuda")
    pos = torch.full((B,), 400, dtype=torch.long, device="cuda")
    b = ContinuousBatcher(model, params, slots=B, max_seq=A, steps_per_poll=4,
                          draft_model=draft, draft_params=dparams, speculate_tokens=g,
                          cuda_graphs=False)
    b._whole.act.fill_(True)
    b._whole.pos.fill_(400)

    def round_():
        b._spec_round(A, False)
        b._whole.pos.fill_(400)

    cases = {
        "4 draft steps (6 layers)": lambda: [draft.decode_step_ragged_list(
            dparams, dks, dvs, tok, pos, attn_len=A) for _ in range(g)],
        "verify chunk W=5 (24 layers)": lambda: model.decode_chunk_ragged_list(
            params, ks, vs, win, pos, attn_len=A),
        "whole round via the batcher (greedy)": round_,
        "5 decode steps (24 layers)": lambda: [model.decode_step_ragged_list(
            params, ks, vs, tok, pos, attn_len=A) for _ in range(g + 1)],
    }
    busy = {}
    try:
        for name, fn in cases.items():
            with torch.inference_mode():
                wall_ms = time_ms(fn, iters=3, warmup=1)
                n = 1
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(n):
                        fn()
                    torch.cuda.synchronize()
            events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
            busy[name] = sum(e.self_device_time_total for e in events) / 1e3 / n
            ops = sum(e.count for e in events) / n
            log(f"[spec-model] {name}, B={B}, attn_len {A}: wall {wall_ms:.2f} ms, device busy "
                f"{busy[name]:.3f} ms ({ops:.0f} device ops)")
    finally:
        b.close()
    draft_ms, verify_ms, round_ms, steps_ms = busy.values()
    log(f"[spec-model] the verify chunk takes {verify_ms / steps_ms:.3f} of 5 decode steps' "
        f"device time ({verify_ms / steps_ms * 5:.2f} steps' worth); the draft "
        f"{draft_ms / round_ms:.3f} of the round's")


# llm-1.26b with Gemma-2B's attention shape (the published google/gemma-2b
# config.json: hidden_size 2048, num_attention_heads 8,
# num_key_value_heads 1, head_dim 256), everything else llm-1.26b's: Dh =
# 2048 / 8 = 256 puts every prefill on the wgmma route's DH 256 instance
LLM_1_26B_DH256 = {**LLM_1_26B, "n_heads": 8, "n_kv_heads": 1}
# A greedy stream may part from generate() (other matmul shapes, so other
# bf16 rounding) only at a near-tie of the two candidate tokens' logits.
# The logits come out of a bf16 product: at |logit| < 8 one bf16 ulp is
# 2**-5, and each of three paths (the batcher's, generate()'s, and the
# prefill that reads the margin) may round a logit by one, so a tie reads
# as at most ~3 ulps apart; 4 are allowed.
GREEDY_TIE_TOL = 2.0 ** -3


def _greedy_vs_generate(model, params, prompt, stream, ref):
    """The batcher's greedy ``stream`` against ``ref``, ``generate()`` on
    the same prompt: ``None`` where they are equal, else ``(first
    differing generated step, logit margin)`` with the margin between
    the two candidate tokens in the logits of a prefill over the common
    prefix."""
    import torch

    n = len(prompt)
    i = _first_diff(stream[n:], ref[n:])
    if i is None:
        return None
    logits, _ = model.prefill(params, torch.tensor([ref[: n + i]], device="cuda"), n + i)
    return i, (logits[0, ref[n + i]] - logits[0, stream[n + i]]).abs().item()


# llm-1.26b at float32 (the JAX package serves a config with "dtype":
# "float32", LMConfig.dtype): every prefill runs the mma route's 3xTF32
# instance at Dh 128; 5.0 GB of weights, 1.6 GB of K/V at 8 x 1024
LLM_1_26B_F32 = {**LLM_1_26B, "dtype": "float32"}
# At float32 the batcher and generate() run their matmuls at other shapes,
# so cuBLAS sums in other orders: unit-scale logits differ by ~1e-5 after
# 24 layers. A greedy stream may part from generate() only where the two
# candidates' logits are within 1e-3 of each other (a tie at that noise).
F32_TIE_TOL = 1e-3
# Full-width float32 prefill logits, kernel vs plain attention: the
# attention outputs differ by ~1e-6 (3xTF32 products and an exp2 against
# einsum and softmax), which 24 layers grow ~10x (the bf16 model's 2**-8
# per layer became 0.03); 1e-3 leaves a margin of ~100x. A top-1 choice
# may differ only where the plain logits of the two tokens are within
# twice that.
F32_LOGITS_TOL = 1e-3


def _served_config(card, tag, config, route, tie_tol):
    """``config`` (random weights from seed 0) built through
    GenerateServer's typed parameters (the serve phase's: 8 slots,
    steps_per_poll 16, pipeline_depth 3, warmed for the waves' prompt
    lengths, the knobs off), driven twice with the serve waves, each wave
    queued whole. Fails unless every request answers 64 tokens, the
    second run repeats the first token for token, every prefill launched
    the flash kernel, the launches over both runs are all ``route`` and
    nothing else, no graph is captured after warm(), and every greedy
    stream equals ``generate()`` on the card or parts from it where the
    two candidates' logits are within ``tie_tol``. Prints tokens/s, TTFT,
    TPOT and peak memory per run. Returns the model, its weights and the
    launches by route."""
    import torch

    from seldon_core_tpu_torch import microservice
    from seldon_core_tpu_torch.ops import flash_attention as fa

    probe, mixed = serve_waves()
    gate = _Gate()
    with tempfile.TemporaryDirectory(prefix=f"chip-smoke-{tag}-") as model_dir:
        with open(os.path.join(model_dir, "jax_config.json"), "w") as f:
            json.dump({"family": "llm", "config": config}, f)
        server_params = [{"name": "model_uri", "value": model_dir, "type": "STRING"}] + SERVE_PARAMS
        t0 = time.perf_counter()
        user = microservice.build_user_object(
            "seldon_core_tpu_torch.servers.generateserver.GenerateServer",
            json.dumps(server_params))
        user.load()  # load, then warm() with its graph captures
        b, model = user.batcher, user._model
        cfg = model.cfg
        b.fault_hook = gate
        log(f"[{tag}] loaded and warmed in {time.perf_counter() - t0:.1f} s "
            f"({model.n_params() / 1e9:.3f} B params, {cfg.dtype}, {cfg.n_heads} heads / "
            f"{cfg.n_kv_heads} kv heads, Dh {cfg.head_dim}; {b.stats['graphs_captured']} graphs)")
        try:
            fa.ROUTE_LAUNCHES.clear()  # count this path only
            runs = [_sched_run(gate, b, probe, mixed) for _ in range(2)]
            routes = dict(fa.ROUTE_LAUNCHES)
            inline = b.stats["graph_captures_inline"]
        finally:
            user.close()
    params = b.params
    del user, b

    vocab = cfg.vocab_size
    for n, run in enumerate(runs):
        for key, out in run["tokens"].items():
            toks = _p(key, probe, mixed)
            if len(out) != len(toks) + MAX_NEW or out[: len(toks)] != toks \
                    or not all(0 <= x < vocab for x in out):
                raise AssertionError(f"[{tag}] run {n + 1} {key}: malformed tokens")
        prefills = run["delta"]["prefill_steps"]
        if prefills <= 0 or run["launches"] < cfg.n_layers * prefills:
            raise AssertionError(f"[{tag}] run {n + 1}: {prefills} prefills but "
                                 f"{run['launches']} flash launches")
    bad = [k for k in runs[0]["tokens"] if runs[1]["tokens"][k] != runs[0]["tokens"][k]]
    if bad:
        raise AssertionError(f"[{tag}] the second run gave other tokens: {bad}")
    if set(routes) != {route}:
        raise AssertionError(f"[{tag}] flash launches by route {routes}: want only {route}")
    if inline:
        raise AssertionError(f"[{tag}] {inline} graphs captured after warm()")

    # every greedy stream against generate() on the same card and weights
    refs, parted = {}, {}
    greedy = [(lab, toks) for lab, toks, temp, _s in list(probe) + list(mixed) if temp == 0.0]
    t0 = time.perf_counter()
    for label, toks in greedy:
        if tuple(toks) not in refs:
            refs[tuple(toks)] = model.generate(
                params, torch.tensor([toks], device="cuda"), MAX_NEW)[0].tolist()
        diff = _greedy_vs_generate(model, params, toks, runs[0]["tokens"][label],
                                   refs[tuple(toks)])
        if diff is not None:
            parted[label] = (diff[0], round(diff[1], 6))
    log(f"[{tag}] greedy streams vs generate() on the card: {len(greedy) - len(parted)} of "
        f"{len(greedy)} equal token for token"
        + (f"; parted (generated step, |logit margin| of the two candidates) {parted}, "
           f"tie tolerance {tie_tol}" if parted else "")
        + f" ({time.perf_counter() - t0:.1f} s)")
    if any(margin > tie_tol for _i, margin in parted.values()):
        raise AssertionError(f"[{tag}] greedy streams part from generate() off a tie: {parted}")

    for n, run in enumerate(runs):
        slo = run["slo"]
        log(f"[{tag}] run {n + 1}: tokens/s {run['tok_s']:.1f}, TTFT p50 {slo['ttft_p50']:.1f} ms "
            f"p99 {slo['ttft_p99']:.1f} ms, TPOT p50 {slo['tpot_p50']:.2f} ms, peak allocated "
            f"{run['peak'] / 2**30:.2f} GiB, flash launches {run['launches']} [{card}]")
    log(f"[{tag}] both runs token-identical ({len(runs[0]['tokens'])} streams each); flash "
        f"launches over the phase by route {routes}; graph_captures_inline {inline}")
    return model, params, routes


def _prefill_flash_share(card, tag, model, params):
    """One B=1, T=1024 prefill: eager (CUDA events around the calls, host
    gaps included) and replayed from a CUDA graph (device time), with the
    flash kernel's device time at its shapes, once per layer. Returns the
    graph's and the kernel's share of it."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.ops import flash_attention as fa

    cfg = model.cfg
    rs = np.random.RandomState(3)
    toks = torch.tensor(rs.randint(0, cfg.vocab_size, (1, 1024)), device="cuda")
    eager_ms = time_ms(lambda: model.prefill(params, toks, 1024), iters=5, warmup=1)
    graph_ms = device_ms(lambda: model.prefill(params, toks, 1024), launches=3, reps=3)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    q, k, v = _prefill_like(1, cfg.n_heads, cfg.n_kv_heads, 1024, cfg.head_dim, model.dtype, gen)
    flash_ms = device_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    share = cfg.n_layers * flash_ms / graph_ms
    log(f"[{tag}] prefill B=1 T=1024: eager {eager_ms:.2f} ms (CUDA events), device "
        f"{graph_ms:.3f} ms (CUDA graph replay); flash kernel {flash_ms:.4f} ms x "
        f"{cfg.n_layers} layers = {cfg.n_layers * flash_ms:.3f} ms, "
        f"{100 * share:.1f}% of the device time [{card}]")
    return graph_ms, share


def _logits_kernel_vs_plain(model, params, prompts):
    """Prefill logits of ``prompts`` with the kernel and with the plain
    attention in its place, on the same model and weights."""
    from seldon_core_tpu_torch.models import llm as llm_mod
    from seldon_core_tpu_torch.ops import flash_attention as fa

    t = prompts.shape[1]
    logits_k, _ = model.prefill(params, prompts, t)
    saved = llm_mod.prefill_attention
    llm_mod.prefill_attention = fa.attention_plain
    try:
        logits_p, _ = model.prefill(params, prompts, t)
    finally:
        llm_mod.prefill_attention = saved
    return logits_k, logits_p


def phase_dh256(card, serve_numbers):
    """llm-1.26b-dh256 (bf16, random weights from seed 0) served as
    ``_served_config`` drives it, every flash launch on ``wgmma bfloat16
    Dh 256`` (GREEDY_TIE_TOL); prints its numbers beside the serve
    phase's llm-1.26b numbers, a B=1, T=1024 prefill's time with the
    flash kernel's share, and fails unless full-width prefill logits with
    the kernel agree with the plain attention's. Returns the Dh 256
    launches of the two runs."""
    import numpy as np
    import torch

    route = "wgmma bfloat16 Dh 256"
    model, params, routes = _served_config(card, "dh256", LLM_1_26B_DH256, route, GREEDY_TIE_TOL)
    if serve_numbers:
        log(f"[dh256] beside llm-1.26b (Dh 128) in the serve phase (the same waves over REST): "
            f"tokens/s {serve_numbers['tok_s']:.1f}, TTFT p50 {serve_numbers['ttft_p50']:.1f} ms "
            f"p99 {serve_numbers['ttft_p99']:.1f} ms, TPOT p50 {serve_numbers['tpot_p50']:.2f} ms")
    _prefill_flash_share(card, "dh256", model, params)

    # full-width prefill logits: the kernel against the plain attention
    rs = np.random.RandomState(3)
    prompts = torch.tensor(rs.randint(0, model.cfg.vocab_size, (8, 128)), device="cuda")
    logits_k, logits_p = _logits_kernel_vs_plain(model, params, prompts)
    if not bool(torch.isfinite(logits_k).all()):
        raise AssertionError("[dh256] non-finite prefill logits")
    diff = (logits_k - logits_p).abs().max().item()
    top1 = (logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean().item()
    log(f"[dh256] prefill logits kernel vs plain at full width: max_abs {diff:.4e} "
        f"(tol {LOGITS_TOL}), top-1 agreement {top1:.3f} (min {TOP1_MIN_AGREEMENT})")
    if diff > LOGITS_TOL or top1 < TOP1_MIN_AGREEMENT:
        raise AssertionError("[dh256] prefill logits disagree between kernel and plain attention")
    return routes[route]


def phase_f32(card):
    """llm-1.26b-f32 (llm-1.26b at float32, random weights from seed 0)
    served as ``_served_config`` drives it, every flash launch on ``mma
    float32 Dh 128`` (F32_TIE_TOL); prints a B=1, T=1024 prefill's device
    time with the flash kernel's share, and fails unless the full-width
    B=1, T=1024 prefill logits with the kernel are within F32_LOGITS_TOL
    of the plain attention's, every top-1 choice agreeing but at a tie.
    Returns the Dh 128 launches of the two runs."""
    import numpy as np
    import torch

    route = "mma float32 Dh 128"
    model, params, routes = _served_config(card, "f32", LLM_1_26B_F32, route, F32_TIE_TOL)
    graph_ms, share = _prefill_flash_share(card, "f32", model, params)
    log(f"[f32] the rest of the prefill's device time, {graph_ms * (1 - share):.3f} ms "
        f"({100 * (1 - share):.1f}%), is the float32 matmuls and the other layers' operations"
        + (": the matmuls, not the flash kernel, dominate" if share < 0.5 else ""))

    rs = np.random.RandomState(4)
    prompts = torch.tensor(rs.randint(0, model.cfg.vocab_size, (1, 1024)), device="cuda")
    logits_k, logits_p = _logits_kernel_vs_plain(model, params, prompts)
    if not bool(torch.isfinite(logits_k).all()):
        raise AssertionError("[f32] non-finite prefill logits")
    diff = (logits_k - logits_p).abs().max().item()
    pick_k, pick_p = logits_k.argmax(-1), logits_p.argmax(-1)
    top1 = (pick_k == pick_p).float().mean().item()
    # a differing pick must be a tie in the plain logits
    margins = (logits_p.gather(-1, pick_p[..., None]) - logits_p.gather(-1, pick_k[..., None])).abs()
    worst_margin = margins.max().item()
    log(f"[f32] prefill logits kernel vs plain at full width, B=1 T=1024: max_abs {diff:.4e} "
        f"(tol {F32_LOGITS_TOL}), top-1 agreement {top1:.3f} (a differing pick's plain margin "
        f"at most {worst_margin:.3e}, tie tol {2 * F32_LOGITS_TOL})")
    if diff > F32_LOGITS_TOL or worst_margin > 2 * F32_LOGITS_TOL:
        raise AssertionError("[f32] prefill logits disagree between kernel and plain attention")
    return routes[route]


# -- disaggregated prefill/decode and the host KV tier ---------------------------------

FULL_SLAB_BYTES = 24 * 2 * 8 * 1024 * 128 * 2  # llm-1.26b, a 1024-position slab


def _gen_server(model_dir, **extra):
    """A GenerateServer over llm-1.26b built from typed parameters (the
    serve phase's, plus ``extra``), loaded and warmed."""
    from seldon_core_tpu_torch import microservice

    params = [{"name": "model_uri", "value": model_dir, "type": "STRING"}] + SERVE_PARAMS + [
        {"name": k, "value": str(v), "type": "INT" if isinstance(v, int) else "STRING"}
        for k, v in extra.items()]
    user = microservice.build_user_object(
        "seldon_core_tpu_torch.servers.generateserver.GenerateServer", json.dumps(params))
    user.load()
    return user


def _alone(server, items):
    """Each ``(label, toks, temp, seed)`` through ``predict`` alone:
    tokens by label."""
    return {label: server.predict({"prompt_tokens": toks, "max_new_tokens": MAX_NEW,
                                   "temperature": temp, "seed": seed}, [])["tokens"][0]
            for label, toks, temp, seed in items}


def _stream_wave(server, wave):
    """The wave's requests streamed concurrently through ``server.stream``
    (a decode role's handoff happens inside the call): tokens by label,
    client-side TTFT (call to first chunk) by label, and the wall time."""
    out, ttft, errors = {}, {}, []

    def one(item):
        label, toks, temp, seed = item
        try:
            t0 = time.perf_counter()
            handle = server.stream({"prompt_tokens": toks, "max_new_tokens": MAX_NEW,
                                    "temperature": temp, "seed": seed})
            spans = []
            for chunk in handle.chunks:
                if chunk.get("done"):
                    out[label] = chunk["tokens"]
                else:
                    ttft.setdefault(label, time.perf_counter() - t0)
                    spans.extend(chunk["tokens"])
            if out[label][len(toks):] != spans:
                raise AssertionError(f"{label}: streamed spans are not its tokens")
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(f"{label}: {type(e).__name__}: {e}")

    t = time.perf_counter()
    threads = [threading.Thread(target=one, args=(it,)) for it in wave]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    wall = time.perf_counter() - t
    if errors or len(out) != len(wave):
        raise AssertionError(f"stream wave failed: {errors or 'a request did not finish'}")
    for label, toks, _t, _s in wave:
        if len(out[label]) != len(toks) + MAX_NEW or out[label][: len(toks)] != toks:
            raise AssertionError(f"{label}: {len(out[label]) - len(toks)} tokens")
    return out, ttft, wall


def _wave_numbers(tag, server, wave, card):
    import numpy as np

    server.batcher.slo_recent.clear()
    out, ttft, wall = _stream_wave(server, wave)
    t = np.asarray(list(ttft.values())) * 1e3
    tpot = _slo(server.batcher)["tpot_p50"]
    num = {"tok_s": MAX_NEW * len(wave) / wall, "ttft_p50": float(np.percentile(t, 50)),
           "ttft_p99": float(np.percentile(t, 99)), "tpot_p50": tpot}
    log(f"[disagg] {tag}: mixed wave of {len(wave)} streamed: {num['tok_s']:.1f} tokens/s, "
        f"TTFT p50 {num['ttft_p50']:.1f} ms p99 {num['ttft_p99']:.1f} ms (client side, call "
        f"to first chunk), TPOT p50 {tpot:.2f} ms [{card}]")
    return out, num


def _check_equal(tag, got, want):
    bad = [label for label in got if got[label] != want[label]]
    if bad:
        raise AssertionError(f"[disagg] {tag}: {bad} differ from the unified server's "
                             f"(first differing steps "
                             f"{ {x: _first_diff(got[x], want[x]) for x in bad} })")


# the disagg phase's shared-prefix traffic: the first 8 of the 32 prompts
DISAGG_PREFIX_PROMPTS = 8


def _prefix_wave(tag, dec, card):
    """The shared-prefix traffic through a decode role with its cache on:
    the 4 system prompts, then the first 8 of the 32 prompts (2 per
    system prompt; cut for the whole script's time budget), each set
    from 8 client threads (the prefill listener's capacity: a ninth
    concurrent transfer would be shed with PeerBusy)."""
    from concurrent.futures import ThreadPoolExecutor

    systems, prompts = prefix_traffic()
    prompts = prompts[:DISAGG_PREFIX_PROMPTS]
    s0 = dict(dec.batcher.stats)

    def fire_all(items):
        with ThreadPoolExecutor(max_workers=8) as pool:
            futs = [pool.submit(dec.predict, {"prompt_tokens": toks,
                                              "max_new_tokens": MAX_NEW}, [])
                    for toks in items]
            return [f.result(timeout=600) for f in futs]

    fire_all(systems)
    t = time.perf_counter()
    res = fire_all(prompts)
    wall = time.perf_counter() - t
    d = {k: dec.batcher.stats[k] - s0[k] for k in
         ("kv_imports", "kv_import_bytes", "kv_transfer_bytes_saved", "prefix_hits")}
    hits = [r["cache_hit_tokens"][0] for r in res]
    for r, toks in zip(res, prompts):
        out = r["tokens"][0]
        if len(out) != len(toks) + MAX_NEW or out[: len(toks)] != toks:
            raise AssertionError(f"[disagg] {tag}: a shared-prefix request came back malformed")
    if min(hits) < SYSTEM_LEN or d["kv_transfer_bytes_saved"] <= 0:
        raise AssertionError(f"[disagg] {tag}: cache_hit_tokens {sorted(set(hits))}, "
                             f"kv_transfer_bytes_saved {d['kv_transfer_bytes_saved']}")
    log(f"[disagg] {tag}: shared-prefix traffic (4 systems, then {len(prompts)} prompts of "
        f"384 + 64 "
        f"tokens): every prompt shipped suffix-only over a {min(hits)}-token radix hit; "
        f"kv_imports {d['kv_imports']}, import bytes {d['kv_import_bytes']}, "
        f"kv_transfer_bytes_saved {d['kv_transfer_bytes_saved']}; {len(prompts)} prompts "
        f"{MAX_NEW * len(prompts) / wall:.1f} tokens/s [{card}]")
    return d


def _prefill_process(model_dir, kv_port, rest_port, log_path):
    """The prefill role as a process of its own: the microservice CLI
    with typed parameters (role prefill, kv_port), its output in
    ``log_path``."""
    params = [{"name": "model_uri", "value": model_dir, "type": "STRING"}] + SERVE_PARAMS + [
        {"name": "role", "value": "prefill", "type": "STRING"},
        {"name": "kv_port", "value": str(kv_port), "type": "INT"}]
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""),
               PREDICTIVE_UNIT_PARAMETERS=json.dumps(params))
    logf = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.microservice",
         "seldon_core_tpu_torch.servers.generateserver.GenerateServer", "REST",
         "--service-port", str(rest_port), "--host", "127.0.0.1"],
        cwd=HERE, env=env, stdout=logf, stderr=subprocess.STDOUT)
    return proc, logf


def _stop_process(proc, logf):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
    logf.close()


def phase_disagg(card):
    """Disaggregated prefill/decode at llm-1.26b (bf16, seed-0 weights):
    a prefill-role and a decode-role GenerateServer on the one card over
    the loopback transport, then over TCP with the prefill role as a
    second process (the microservice CLI, role=prefill, kv_port). Fails
    unless three greedy requests of the mixed wave (prefill buckets 32,
    128, 1024) and its seeded ones, each alone, give the unified server's
    tokens over both transports, seeded requests
    repeat, the shared-prefix traffic ships suffix-only slabs
    (kv_transfer_bytes_saved > 0), a transfer corrupted by a
    SELDON_FAULTS peer rule is refused typed and retried on the next
    peer with the same tokens, killing the prefill process degrades to
    local prefill with the same tokens, and every prefill in this
    process launched the flash kernel. Reports the export's time for a
    1024-token prompt, slab bytes, the codec's rates, TCP transfer times
    (full and suffix-only), admit_remote to first credit, the wave's
    TTFT/TPOT/tokens/s over loopback, TCP and unified, and the peak
    memory."""
    import io

    import numpy as np
    import torch

    from seldon_core_tpu_torch.ops import _build
    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.serving.disagg import TcpKVClient, decode_slab, encode_slab

    probe, mixed = serve_waves()
    greedy = [it for it in mixed if it[2] == 0.0]
    seeded = [it for it in mixed if it[2] != 0.0]
    # the greedy requests run alone: one per prefill bucket 32, 128, 1024
    greedy_alone = greedy[:3]
    # prompts no server has seen before the prefill process is killed: a
    # degraded request then prefills whole, as the unified server does
    rs = np.random.RandomState(6)
    fresh = [(f"fresh_greedy_{n}", rs.randint(0, LLM_1_26B["vocab_size"], n).tolist(), 0.0, 0)
             for n in (64, 200)]
    servers, proc, logf = [], None, None
    with tempfile.TemporaryDirectory(prefix="chip-smoke-disagg-") as model_dir:
        with open(os.path.join(model_dir, "jax_config.json"), "w") as f:
            json.dump({"family": "llm", "config": LLM_1_26B}, f)
        kv_port, rest_port = _free_port(), _free_port()
        log_path = os.path.join(model_dir, "prefill-process.log")
        lib = _build.library_path("flash_attention.cu")
        lib_mtime = lib.stat().st_mtime
        try:
            # the second process loads while this one serves loopback
            proc, logf = _prefill_process(model_dir, kv_port, rest_port, log_path)
            t0 = time.perf_counter()
            unified = _gen_server(model_dir)
            pf = _gen_server(model_dir, role="prefill")
            dec = _gen_server(model_dir, role="decode", prefix_cache_hbm_bytes=2 << 30)
            servers += [unified, pf, dec]
            dec.set_peer(pf)
            log(f"[disagg] unified, prefill-role (1 lane, no scheduler loop) and decode-role "
                f"GenerateServers loaded and warmed in {time.perf_counter() - t0:.1f} s")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.LAUNCHES["flash_attention"] = 0
            steps0 = {id(s): s.batcher.stats["prefill_steps"] for s in servers}
            # launches that are not the driven path: warm() of a server
            # loaded mid-phase and the prefill timed on its own
            aside = {"n": 0}

            def not_counted(fn, *a, **k):
                n0 = fa.LAUNCHES["flash_attention"]
                out = fn(*a, **k)
                aside["n"] += fa.LAUNCHES["flash_attention"] - n0
                return out

            # token for token: each greedy request alone
            want = _alone(unified, greedy_alone + seeded + fresh)
            lo = _alone(dec, greedy_alone + seeded)
            _check_equal("loopback, each request alone", lo, want)
            again = _alone(dec, seeded)
            if any(again[label] != lo[label] for label, *_r in seeded):
                raise AssertionError("[disagg] loopback: a seeded request did not repeat")
            log(f"[disagg] loopback: {len(greedy_alone)} greedy and {len(seeded)} seeded requests "
                f"of the mixed wave, each alone, equal the unified server's token for token; "
                f"seeded repeat identical (the repeat shipped suffix-only)")

            # the wave streamed concurrently: unified against loopback
            uni_wave, uni_num = _wave_numbers("unified", unified, mixed, card)
            lo_wave, lo_num = _wave_numbers("loopback", dec, mixed, card)
            same = sum(lo_wave[label] == uni_wave[label] for label, *_r in mixed)
            log(f"[disagg] loopback wave: {same} of {len(mixed)} streams equal the unified "
                f"wave's (the unified server batches same-bucket prefills, m = 4: other "
                f"matmul shapes at bf16)")

            # the export, the slab and the codec at 1024 tokens
            rs = np.random.RandomState(5)
            p1000 = rs.randint(0, LLM_1_26B["vocab_size"], 1000).tolist()
            b = pf.batcher
            pf.prefill_export({"tokens": p1000, "max_new_tokens": 16})  # warm the pull
            torch.cuda.synchronize()
            t = time.perf_counter()
            meta, slab = b.export_prefill(p1000, max_new_tokens=16)
            export_ms = (time.perf_counter() - t) * 1e3
            prompt = np.zeros((1, 1024), np.int64)
            prompt[0, :1000] = p1000
            prefill_ms = not_counted(time_ms, lambda: b._prefill(
                prompt, np.asarray([999]), [0], [0.0]), iters=5, warmup=1)
            toks_dev = torch.tensor(prompt, device=b.device)
            prefill_dev_ms = not_counted(device_ms, lambda: b.model.prefill(
                b.params, toks_dev, 1024), launches=3, reps=3)
            _logits, slab_dev = not_counted(b.model.prefill, b.params, toks_dev, 1024)
            pulls = []
            for _ in range(3):  # the first allocates its pinned blocks
                torch.cuda.synchronize()
                t = time.perf_counter()
                pulled = [b._to_host(slab_dev[name]) for name in ("k", "v")]
                pulls.append((time.perf_counter() - t) * 1e3)
                del pulled
            pull_ms = min(pulls)
            del slab_dev
            nbytes = sum(x.numel() * x.element_size() for x in slab.values())
            if nbytes != FULL_SLAB_BYTES:
                raise AssertionError(f"[disagg] a 1024-position slab is {nbytes} B, want "
                                     f"{FULL_SLAB_BYTES}")
            t = time.perf_counter()
            raw = b"".join(encode_slab(meta, slab))
            enc_s = time.perf_counter() - t
            t = time.perf_counter()
            _m2, back = decode_slab(io.BytesIO(raw).read)
            dec_s = time.perf_counter() - t
            if not all(torch.equal(back[n], slab[n]) for n in ("k", "v")):
                raise AssertionError("[disagg] the codec changed a slab")
            log(f"[disagg] export of a 1000-token prompt (bucket 1024): {export_ms:.2f} ms; "
                f"its prefill {prefill_ms:.2f} ms eager (CUDA events, host gaps included), "
                f"{prefill_dev_ms:.3f} ms of device time (CUDA graph replay); the pull of the "
                f"slab into pinned memory {pull_ms:.2f} ms ({nbytes / pull_ms / 1e6:.1f} GB/s, "
                f"best of 3); "
                f"slab {nbytes} B = {nbytes // 1024} B per position "
                f"({len(raw)} B on the wire); encode {nbytes / enc_s / 1e6:.0f} MB/s, decode "
                f"{nbytes / dec_s / 1e6:.0f} MB/s (one thread, CRC and copies) [{card}]")
            first = {}
            req = {"tokens": p1000, "max_new_tokens": 16, "covered_len": 0}
            meta, slab = dec._kv_client.prefill(req)
            t = time.perf_counter()
            fut = dec.batcher.admit_remote(
                slab, meta, on_tokens=lambda _s: first.setdefault("t", time.perf_counter()))
            fut.result(timeout=600)
            admit_ms = (first["t"] - t) * 1e3
            log(f"[disagg] admit_remote to first credit (upload, lane insert, one 16-step "
                f"burst, its host read): {admit_ms:.2f} ms [{card}]")
            d_lo = _prefix_wave("loopback", dec, card)

            # TCP: the prefill role in its own process
            client = TcpKVClient(f"127.0.0.1:{kv_port}")
            deadline = time.monotonic() + 600
            while not client.probe():
                if proc.poll() is not None or time.monotonic() > deadline:
                    logf.flush()
                    raise AssertionError("[disagg] the prefill process did not come up:\n"
                                         + open(log_path).read()[-4000:])
                time.sleep(0.5)
            reused = lib.stat().st_mtime == lib_mtime
            log(f"[disagg] prefill process up on KV port {kv_port} (pid {proc.pid}); the "
                f"flash kernel's library {'reused' if reused else 'REBUILT'} from build/kernels")
            if not reused:
                raise AssertionError("[disagg] the second process rebuilt the kernel library")
            dec_tcp = not_counted(_gen_server, model_dir, role="decode",
                                  peer=f"127.0.0.1:{kv_port}", prefix_cache_hbm_bytes=2 << 30)
            servers.append(dec_tcp)
            steps0[id(dec_tcp)] = dec_tcp.batcher.stats["prefill_steps"]
            tcp = _alone(dec_tcp, greedy_alone + seeded)
            _check_equal("TCP, each request alone", tcp, want)
            log(f"[disagg] TCP: {len(greedy_alone)} greedy and {len(seeded)} seeded requests, each "
                f"alone, equal the unified server's token for token")
            tcp_wave, tcp_num = _wave_numbers("TCP", dec_tcp, mixed, card)
            full_ms, suf_ms = [], []
            for _ in range(3):
                t = time.perf_counter()
                _m, s_full = client.prefill({"tokens": p1000, "max_new_tokens": 16})
                full_ms.append((time.perf_counter() - t) * 1e3)
                t = time.perf_counter()
                _m, s_suf = client.prefill({"tokens": p1000, "max_new_tokens": 16,
                                            "covered_len": 896})
                suf_ms.append((time.perf_counter() - t) * 1e3)
            suf_bytes = sum(x.numel() * x.element_size() for x in s_suf.values())
            log(f"[disagg] TCP request to slab in hand, 1000-token prompt (the other process's "
                f"prefill included), median of 3: full slab {sorted(full_ms)[1]:.1f} ms "
                f"({FULL_SLAB_BYTES} B), suffix-only past 896 cached tokens "
                f"{sorted(suf_ms)[1]:.1f} ms ({suf_bytes} B); in-process export "
                f"{export_ms:.2f} ms [{card}]")
            d_tcp = _prefix_wave("TCP", dec_tcp, card)

            # a corrupting peer rule: refused typed, retried on the next peer
            os.environ["SELDON_FAULTS"] = json.dumps({"seed": 3, "rules": [
                {"unit": f"kv:loopback:{id(pf):x}", "kv_corrupt_rate": 1.0}]})
            try:
                dec_f = not_counted(_gen_server, model_dir, role="decode",
                                    peer_eject_backoff_s=60)
            finally:
                del os.environ["SELDON_FAULTS"]
            servers.append(dec_f)
            steps0[id(dec_f)] = dec_f.batcher.stats["prefill_steps"]
            dec_f.set_peer([pf, f"127.0.0.1:{kv_port}"])
            reasons = []
            fc = dec_f._kv_client
            hook = fc._on_eject
            fc._on_eject = lambda addr, why: (reasons.append(why), hook(addr, why))
            got = _alone(dec_f, greedy[:2])
            _check_equal("a corrupted transfer retried on the next peer", got,
                         {label: want[label] for label, *_r in greedy[:2]})
            fault = fc.peers[0].transport._fault
            typed = reasons and reasons[0].split(":")[0] in (
                "ChecksumError", "TruncatedStream", "DisaggError")
            if fault.injected["corrupt"] != 1 or dec_f.batcher.stats["peer_ejections"] != 1 \
                    or not typed:
                raise AssertionError(f"[disagg] fault rule: injected {fault.injected}, "
                                     f"ejections {dec_f.batcher.stats['peer_ejections']}, "
                                     f"reasons {reasons}")
            log(f"[disagg] SELDON_FAULTS kv_corrupt_rate 1.0 on the loopback peer: its transfer "
                f"refused as {reasons[0][:90]!r}, the peer ejected, the request retried on the "
                f"TCP peer with the unified tokens")

            # kill the prefill process: local prefill, the same tokens
            _stop_process(proc, logf)
            got = _alone(dec_tcp, fresh)
            _check_equal("the prefill process killed", got,
                         {label: want[label] for label, *_r in fresh})
            st = dec_tcp.batcher.stats
            if st["degraded_local_prefill"] < 1 or st["peer_ejections"] < 1:
                raise AssertionError(f"[disagg] after the kill: degraded_local_prefill "
                                     f"{st['degraded_local_prefill']}, ejections "
                                     f"{st['peer_ejections']}")
            log(f"[disagg] prefill process killed: degraded_local_prefill "
                f"{st['degraded_local_prefill']}, peer_ejections {st['peer_ejections']}, "
                f"tokens equal the unified server's")

            launches = fa.LAUNCHES["flash_attention"] - aside["n"]
            prefills = sum(s.batcher.stats["prefill_steps"] - steps0[id(s)] for s in servers)
            if launches < LLM_1_26B["n_layers"] * prefills:
                raise AssertionError(f"[disagg] {prefills} prefills in this process, "
                                     f"{launches} flash launches")
            inline = sum(s.batcher.stats["graph_captures_inline"] for s in servers)
            if inline:
                raise AssertionError(f"[disagg] {inline} graphs captured after warm()")
            peak = torch.cuda.max_memory_allocated()
            log(f"[disagg] flash launches {launches} over {prefills} prefills in this process "
                f"(exports {pf.batcher.stats['kv_exports']}); peak allocated "
                f"{peak / 2**30:.2f} GiB with {len(servers)} servers resident [{card}]")
            tcp_same = sum(tcp_wave[label] == uni_wave[label] for label, *_r in mixed)
            log(f"[disagg] numbers: export 1024 {export_ms:.2f} ms (prefill {prefill_ms:.2f} "
                f"eager, {prefill_dev_ms:.3f} device; pull {pull_ms:.2f}); "
                f"slab {nbytes} B; encode {nbytes / enc_s / 1e6:.0f} MB/s, decode "
                f"{nbytes / dec_s / 1e6:.0f} MB/s; TCP full {sorted(full_ms)[1]:.1f} ms, "
                f"suffix {sorted(suf_ms)[1]:.1f} ms; admit to first credit {admit_ms:.2f} ms; "
                f"tokens/s unified {uni_num['tok_s']:.1f} loopback {lo_num['tok_s']:.1f} TCP "
                f"{tcp_num['tok_s']:.1f}; TTFT p50 unified {uni_num['ttft_p50']:.1f} loopback "
                f"{lo_num['ttft_p50']:.1f} TCP {tcp_num['ttft_p50']:.1f} ms; TPOT p50 unified "
                f"{uni_num['tpot_p50']:.2f} loopback {lo_num['tpot_p50']:.2f} TCP "
                f"{tcp_num['tpot_p50']:.2f} ms; wave streams equal to unified: loopback "
                f"{same}/{len(mixed)}, TCP {tcp_same}/{len(mixed)}; saved bytes loopback "
                f"{d_lo['kv_transfer_bytes_saved']} TCP {d_tcp['kv_transfer_bytes_saved']}; "
                f"peak {peak / 2**30:.2f} GiB [{card}]")
        finally:
            if proc is not None:
                _stop_process(proc, logf)
            for s in servers:
                s.close()
    return launches


def phase_kvtier(card, model, params):
    """The host KV tier at llm-1.26b (bf16, the scheduler phase's B plus
    the ledger and a 2 GiB prefix cache): a 384-token system prompt
    primes the cache, the pressure phase's mixed wave is queued whole
    under the same 24-poll shrink to two lanes, then a prompt sharing
    the system prompt comes alone. Three runs: the tier off (the system
    prompt re-primed before the warm request, so it hits on the device),
    the tier on at 4 GiB (the rung-1 demotion is promoted back by the
    warm request; preempted lanes resume by copy-back), and a tier under
    two checkpoints of one attention bucket, too small for any
    checkpoint (every resume replays; re-primed as the tier-off run). Fails unless every stream, greedy and seeded,
    and the warm request equal the tier-off run's, the tier-on run
    demoted a prefix and promoted it for a warm hit, resumed at least one
    lane by copy-back and fell back to replay none, the small tier
    resumed by replay only, every whole prefill launched the flash
    kernel and no graph is captured after warm(). Reports ms per
    copy-back resume against ms per replay resume, and ms per promote
    against a re-prefill of the same prompt."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.resilience import FaultInjector

    _probe, mixed = serve_waves()
    systems, prompts = prefix_traffic()
    system, warm_prompt = systems[0], prompts[0]
    launches = 0

    def timed(b, name, sink):
        orig = getattr(b, name)

        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig(*a, **k)
            torch.cuda.synchronize()
            sink.append(((time.perf_counter() - t) * 1e3, out))
            return out

        setattr(b, name, wrapper)

    def run(tag, tier_bytes, reprime):
        nonlocal launches
        gate = _Gate()
        kw = dict(hbm_ledger_bytes=1 << 40, prefix_cache_hbm_bytes=2 << 30)
        if tier_bytes:
            kw["host_kv_tier_bytes"] = tier_bytes
        b = _sched_batcher(model, params, kw, gate)
        resumes, copybacks, promotes = [], [], []
        timed(b, "_admit_resume", resumes)
        if tier_bytes:
            timed(b, "_resume_from_tier", copybacks)
            timed(b, "_promote_tier_prefix", promotes)
        try:
            b.warm(prompt_lens=WARM_LENS + (SYSTEM_LEN, SYSTEM_LEN + USER_LEN),
                   max_new_tokens=MAX_NEW)
            b.start()
            fa.LAUNCHES["flash_attention"] = 0
            s0 = dict(b.stats)
            b.generate(system, max_new_tokens=MAX_NEW)
            b.pressure_hook = FaultInjector([], pressure={
                "shrink_to_bytes": 2 * b.max_seq * b._kv_key_bytes,
                "after_polls": b._work_poll_count + 3, "restore_after_polls": 24}).pressure_hook()
            futs = gate.submit_together(b, [(toks, temp, seed, None)
                                            for _l, toks, temp, seed in mixed])
            out = {label: f.result(timeout=600) for (label, *_r), f in zip(mixed, futs)}
            b.pressure_hook = None
            if reprime:
                b.generate(system, max_new_tokens=MAX_NEW)
            h0 = b.stats["prefix_hits"]
            out["warm"] = b.generate(warm_prompt, max_new_tokens=MAX_NEW)
            warm_hit = b.stats["prefix_hits"] - h0
            b.sync_kv_tier_stats()
            d = {k: b.stats[k] - s0[k] for k in (
                "preemptions", "preempt_resumes", "replayed_tokens", "prefill_steps",
                "prefill_chunks", "prefix_hits", "kv_tier_demotions", "kv_tier_promotions",
                "kv_tier_replay_fallbacks", "pressure_prefix_evictions")}
            n = fa.LAUNCHES["flash_attention"]
            whole = d["prefill_steps"] - d["prefill_chunks"] - d["prefix_hits"]
            if n < LLM_1_26B["n_layers"] * whole:
                raise AssertionError(f"[kvtier] {tag}: {whole} whole prefills, {n} launches")
            launches += n
            for label, toks, _t, _s in mixed:
                if len(out[label]) != len(toks) + MAX_NEW:
                    raise AssertionError(f"[kvtier] {tag} {label}: came back short")
            if d["preemptions"] < 1 or d["preempt_resumes"] != d["preemptions"]:
                raise AssertionError(f"[kvtier] {tag}: {d['preemptions']} preemptions, "
                                     f"{d['preempt_resumes']} resumes")
            if b.stats["graph_captures_inline"]:
                raise AssertionError(f"[kvtier] {tag}: {b.stats['graph_captures_inline']} graphs "
                                     "captured after warm()")
            demoted = sum(e.get("demoted", 0) for e in b.pressure_events
                          if e.get("action") == "evict_prefix")
            cb = [ms for ms, ok in copybacks if ok]
            pm = [ms for ms, hit in promotes if hit is not None]
            widths = getattr(b, "_warm_tier_widths", [])
            log(f"[kvtier] {tag}: preemptions {d['preemptions']}, resumes "
                f"{d['preempt_resumes']} ({len(cb)} copy-back, replayed tokens "
                f"{d['replayed_tokens']}), replay fallbacks {d['kv_tier_replay_fallbacks']}, "
                f"prefix evictions {d['pressure_prefix_evictions']} ({demoted} handed to the tier), tier "
                f"demotions {d['kv_tier_demotions']}, promotions {d['kv_tier_promotions']} "
                f"({len(pm)} prefix), warm request a prefix hit: {bool(warm_hit)}; tier "
                f"{b.stats['kv_tier_bytes']} B used of {tier_bytes}; warm() tier widths "
                f"{widths}; flash launches {n} [{card}]")
            return {"tokens": out, "d": d, "demoted": demoted, "copyback_ms": cb,
                    "resume_ms": [ms for ms, _ in resumes], "promote_ms": pm,
                    "warm_hit": warm_hit, "b": b}
        except BaseException:
            b.close()
            raise

    off = run("tier off", 0, reprime=True)
    off["b"].close()
    on = run("tier on, 4 GiB", 4 << 30, reprime=False)
    try:
        b = on["b"]
        prompt = np.zeros((1, 512), np.int64)
        prompt[0, :SYSTEM_LEN] = system
        reprefill_ms = time_ms(lambda: b._prefill(prompt, np.asarray([SYSTEM_LEN - 1]), [0],
                                                  [0.0]), iters=5, warmup=1)
    finally:
        on["b"].close()
    # captured with the scheduler thread stopped: nothing else touches
    # the device during the capture
    toks_dev = torch.tensor(prompt, device=b.device)
    reprefill_dev_ms = device_ms(lambda: b.model.prefill(b.params, toks_dev, 512),
                                 launches=3, reps=3)
    # a tier under two checkpoints of the narrowest width a lane spills
    # at (one attention bucket): the half-budget rule refuses every one
    cfg = model.cfg
    small_bytes = (SCHED_BASE["attn_bucket"] * 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
                   * torch.empty((), dtype=model.dtype).element_size())
    small = run(f"tier {small_bytes} B", small_bytes, reprime=True)
    small["b"].close()
    for tag, r in (("tier on", on), ("small tier", small)):
        bad = [label for label in off["tokens"] if r["tokens"][label] != off["tokens"][label]]
        if bad:
            raise AssertionError(f"[kvtier] {tag}: {bad} differ from the tier-off run's")
    d = on["d"]
    if not (d["kv_tier_demotions"] >= 1 and on["demoted"] >= 1 and on["promote_ms"]
            and on["warm_hit"] and on["copyback_ms"] and d["kv_tier_replay_fallbacks"] == 0):
        raise AssertionError(f"[kvtier] tier on: {d}, demoted {on['demoted']}, prefix "
                             f"promotions {len(on['promote_ms'])}, copy-backs "
                             f"{len(on['copyback_ms'])}")
    ds = small["d"]
    if ds["kv_tier_promotions"] != 0 or ds["replayed_tokens"] <= 0:
        raise AssertionError(f"[kvtier] tier of {small_bytes} B: {ds}")
    med = lambda xs: float(np.median(xs)) if xs else float("nan")  # noqa: E731
    log(f"[kvtier] every stream (6 greedy, 2 seeded) and the warm request equal the tier-off "
        f"run's, tier on and at {small_bytes} B; ms per resume (scheduler thread, "
        f"synchronised): "
        f"copy-back median {med(on['copyback_ms']):.2f} (n {len(on['copyback_ms'])}) against "
        f"recompute + replay median {med(off['resume_ms']):.2f} (n {len(off['resume_ms'])}, "
        f"tier off) and {med(small['resume_ms']):.2f} (small tier); a promote of the 384-token "
        f"system prompt's 512-position slab {med(on['promote_ms']):.2f} ms against its "
        f"re-prefill {reprefill_ms:.2f} ms eager (CUDA events), {reprefill_dev_ms:.3f} ms of "
        f"device time (CUDA graph replay) [{card}]")
    log(f"[kvtier] ms per copy-back resume {[round(x, 2) for x in on['copyback_ms']]}; per "
        f"replay resume (tier off) {[round(x, 2) for x in off['resume_ms']]}; per promote "
        f"{[round(x, 2) for x in on['promote_ms']]} [{card}]")
    return launches


# -- migration: drain, resume tokens, hot swap, tenants -----------------------

# new tokens per migration request: after the first streamed span (16
# tokens) at most pipeline_depth more bursts are in flight, so a lane
# drained then is still mid-decode (1 + 4 x 16 < 96)
MIG_NEW = 96
# the straggler bound's generation: far longer than its 50 ms bound
STRAGGLER_NEW = 400


def _mig_dir(root, seed):
    """An llm-1.26b model directory with random weights from ``seed``."""
    d = os.path.join(root, f"seed{seed}")
    os.makedirs(d)
    with open(os.path.join(d, "jax_config.json"), "w") as f:
        json.dump({"family": "llm", "config": {**LLM_1_26B, "seed": seed}}, f)
    return d


def _mig_alone(server, items, tenant=None):
    """Each ``(label, toks, temp, seed)`` through ``predict`` alone with
    MIG_NEW new tokens: tokens by label."""
    out = {}
    for label, toks, temp, seed in items:
        body = {"prompt_tokens": toks, "max_new_tokens": MIG_NEW, "temperature": temp,
                "seed": seed}
        if tenant is not None:
            body["tenant"] = tenant
        out[label] = server.predict(body, [])["tokens"][0]
    return out


class _Stream:
    """A stream consumed on a thread: its spans with their arrival times,
    the final event, and an event set once ``k`` spans have arrived."""

    def __init__(self, handle, k=1):
        self.spans, self.times, self.final, self.error = [], [], None, None
        self.k, self.reached, self.done = k, threading.Event(), threading.Event()
        threading.Thread(target=self._run, args=(handle,), daemon=True).start()

    def _run(self, handle):
        try:
            for ch in handle.chunks:
                if ch.get("done"):
                    self.final = ch
                    break
                self.spans.append(ch)
                self.times.append(time.perf_counter())
                if len(self.spans) >= self.k:
                    self.reached.set()
        except BaseException as e:  # noqa: BLE001 - checked by the caller
            self.error = e
        finally:
            self.reached.set()
            self.done.set()

    def tokens(self):
        return [t for ch in self.spans for t in ch["tokens"]]

    def check(self, tag, toks, want):
        """Completed, the spans adding up to ``want`` with none re-sent."""
        if not self.done.wait(600) or self.error is not None or self.final is None:
            raise AssertionError(f"[migration] {tag}: the stream did not complete "
                                 f"({type(self.error).__name__}: {self.error})")
        if self.final["tokens"] != want or self.tokens() != want[len(toks):]:
            raise AssertionError(
                f"[migration] {tag}: tokens differ from the undrained run's alone (first "
                f"differing step {_first_diff(self.final['tokens'][len(toks):], want[len(toks):])}"
                f", spans add up: {self.tokens() == self.final['tokens'][len(toks):]})")


def _timed(obj, name, sink, sync=True):
    """Wrap ``obj.name`` to append each call's ms (after a device sync
    before and after) to ``sink``. A call on another thread may resolve
    a future before its time lands: read ``sink`` through
    :func:`_times`."""
    import torch

    orig = getattr(obj, name)

    def wrapper(*a, **k):
        if sync:
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(*a, **k)
        if sync:
            torch.cuda.synchronize()
        sink.append((time.perf_counter() - t) * 1e3)
        return out

    setattr(obj, name, wrapper)


def _times(sink, n):
    """``sink`` once it holds ``n`` times."""
    deadline = time.monotonic() + 10
    while len(sink) < n and time.monotonic() < deadline:
        time.sleep(0.001)
    if len(sink) < n:
        raise AssertionError(f"[migration] {len(sink)} of {n} timed calls landed")
    return sink


def _engine_for(server, model_dir, **kw):
    """An EngineApp over the in-process generate ``server`` (``kw`` to
    ``EngineApp``)."""
    from seldon_core_tpu_torch.graph.engine_metrics import MetricsRegistry
    from seldon_core_tpu_torch.graph.service import EngineApp
    from seldon_core_tpu_torch.graph.spec import (
        PredictorSpec,
        default_predictor,
        validate_predictor,
    )

    spec = PredictorSpec.from_dict({
        "name": "llm-1-26b", "graph": {"name": "llm", "implementation": "GENERATE_SERVER",
                                       "modelUri": model_dir},
        "annotations": {"seldon.io/rest-read-timeout": "600000"}})
    spec = default_predictor(spec)
    validate_predictor(spec)
    return EngineApp(spec, registry={"llm": server}, metrics=MetricsRegistry(), **kw)


def _serve_engines(apps):
    """Serve each app's REST front on a free port: ``(ports, stop)``."""
    ports = [_free_port() for _ in apps]

    async def start():
        fronts = [app.rest_app() for app in apps]
        for front, p in zip(fronts, ports):
            await front.start("127.0.0.1", p)

        async def close():
            for front in fronts:
                front.close()
        return close

    return ports, serve_in_thread(start)


def phase_migration(card):
    """Live migration, resume tokens, hot swap and tenants at llm-1.26b
    (bf16, random weights from seed 0; seeds 1 and 2 are the swap target
    and the other tenants), GenerateServers built from typed parameters
    (the serve phase's, ``resume_tokens`` on). Fails unless:

    * each of two requests (greedy and seeded, buckets 128 and 512) streamed
      alone and drained mid-decode to a peer over loopback
      (``drain_to``) completes through its original stream with the
      undrained run's tokens alone and no span re-sent (a chain of
      members: each receives one drain and sends the next);
    * a concurrent wave drained over loopback completes, every stream's
      spans adding up to its tokens (equality with the alone run
      reported, not gated: same-bucket prefills batch at bf16);
    * a request drained over TCP through the peer engine's ``/drain``
      gives the undrained tokens;
    * a greedy and a seeded stream whose member dies (an injected loop
      death, restart budget 0) after two spans resume on a peer from
      their last keyless resume token, the spans adding up to the
      undrained stream; a flipped byte answers 400 and a token of
      another ``weight_version`` 409 through the engine;
    * ``/weights/swap`` under traffic (three requests in flight, one per
      bucket): they finish on seed 0 with their alone tokens; afterwards
      requests equal a fresh seed-1 server's alone (the prefix cache,
      which held their prompts, purged: ``prefix_evicted`` > 0), no graph
      is captured; the straggler bound (``swap_drain_ms`` 50) resumes a
      long generation on the new weights under ``resume`` and refuses it
      with a 409 under ``fail``;
    * a server with three tenants (seeds 0, 1, 2; a 10 GiB pager)
      serves interleaved requests with each tenant's dedicated tokens,
      pages in without a graph capture, is forced to switch by the
      starvation bound behind a backlog, and refuses an unknown tenant
      (404);
    * every prefill in the phase launched the flash kernel.

    Reports the drain's ms, lanes and checkpoints, each resume's ms to
    its first resumed span, the swap's checkpoint load, stage and flip ms
    and peak memory, and each page-in's decode, stage and flip ms."""
    import gc

    import numpy as np
    import torch

    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.serving.disagg import WeightVersionMismatch
    from seldon_core_tpu_torch.serving.migration import checkpoint_token, parse_token
    from seldon_core_tpu_torch.serving.weightpager import TenantUnknown

    _probe, mixed = serve_waves()
    by_label = {it[0]: it for it in mixed}
    # one request per prefill bucket: each prefills at m = 1, alone or not
    alone_items = [by_label[x] for x in ("greedy_128", "seeded_500")]
    # in flight across the swap: one per bucket again, none of them a
    # prompt the swap server has published (a prefix hit's suffix prefill
    # reads the cache attention, other bf16 numerics than the reference's)
    swap_items = [by_label[x] for x in ("mixed_greedy_20", "greedy_300", "greedy_900")]
    both = list({it[0]: it for it in alone_items + swap_items}.values())
    servers, stops = [], []
    launches = 0
    with tempfile.TemporaryDirectory(prefix="chip-smoke-migration-") as root:
        dirs = [_mig_dir(root, s) for s in (0, 1, 2)]
        try:
            t0 = time.perf_counter()
            ref = _gen_server(dirs[0], resume_tokens=1)
            servers.append(ref)
            log(f"[migration] reference server (seed 0) loaded and warmed in "
                f"{time.perf_counter() - t0:.1f} s")
            torch.cuda.synchronize()
            fa.LAUNCHES["flash_attention"] = 0
            aside = {"n": 0}

            def whole(s):
                # prefills over the whole prompt launch the flash kernel; a
                # prefix hit's suffix prefill reads the cache attention
                return s.batcher.stats["prefill_steps"] - s.batcher.stats["prefix_hits"]

            steps0 = {id(ref): whole(ref)}
            done_steps = {"n": 0}

            def load(model_dir, **extra):
                # warm() of a server loaded mid-phase is not the driven path
                n0 = fa.LAUNCHES["flash_attention"]
                s = _gen_server(model_dir, **extra)
                aside["n"] += fa.LAUNCHES["flash_attention"] - n0
                servers.append(s)
                steps0[id(s)] = whole(s)
                return s

            def retire(s):
                done_steps["n"] += whole(s) - steps0.pop(id(s))
                s.close()
                servers.remove(s)

            def release():
                # the caller has dropped its names for retired servers
                gc.collect()
                torch.cuda.empty_cache()

            def first_credit(dst, sink):
                """Record, per checkpoint ``dst`` admits, the ms from its
                submit to its first credited span."""
                orig = dst.resume_checkpoint

                def resume_checkpoint(ck, on_tokens=None):
                    t = time.perf_counter()
                    seen = []

                    def relay(span):
                        if not seen:
                            seen.append(1)
                            sink.append((time.perf_counter() - t) * 1e3)
                        on_tokens(span)

                    return orig(ck, on_tokens=relay if on_tokens else None)

                dst.resume_checkpoint = resume_checkpoint

            want = _mig_alone(ref, mixed)

            # -- drain over loopback, each request alone (a chain of members)
            src, drain_ms, resume_ms, handed = ref, [], [], []
            for label, toks, temp, seed in alone_items:
                dst = load(dirs[0], resume_tokens=1)
                first_credit(dst, resume_ms)
                resumes0 = dst.batcher.stats["preempt_resumes"]
                st = _Stream(src.stream({"prompt_tokens": toks, "max_new_tokens": MIG_NEW,
                                         "temperature": temp, "seed": seed}))
                if not st.reached.wait(600):
                    raise AssertionError(f"[migration] {label}: no first span")
                t = time.perf_counter()
                summary = src.drain_to(dst)
                t_end = time.perf_counter()
                drain_ms.append((t_end - t) * 1e3)
                st.check(f"drained alone ({label})", toks, want[label])
                if summary != {"drained": 1, "checkpoints": 1, "handed": 1, "failed": 0} \
                        or dst.batcher.stats["preempt_resumes"] != resumes0 + 1:
                    raise AssertionError(f"[migration] {label}: drain summary {summary}, "
                                         "or the peer did not resume it mid-decode")
                # emitted at the checkpoint: the replayed tokens and the
                # one the lane resumed from
                handed.append(dst.batcher.stats["replayed_tokens"] + 1)
                retire(src)
                src = ref = None
                release()
                src = dst
            log(f"[migration] loopback drain, each request alone ({len(alone_items)}: greedy "
                f"and seeded, buckets 128 and 512): every stream completed through its original "
                f"handle with the undrained tokens, no span re-sent; drain_to "
                f"{', '.join(f'{x:.1f}' for x in drain_ms)} ms (1 lane, 1 checkpoint each, "
                f"{', '.join(map(str, handed))} tokens emitted at the checkpoint); resume to the "
                f"first resumed span {', '.join(f'{x:.1f}' for x in resume_ms)} ms (prompt "
                f"recompute, replay of the emitted tokens, first burst) [{card}]")

            # -- a concurrent wave drained over loopback
            dst = load(dirs[0], resume_tokens=1)
            streams = [_Stream(src.stream({"prompt_tokens": toks, "max_new_tokens": MIG_NEW,
                                           "temperature": temp, "seed": seed}))
                       for _label, toks, temp, seed in mixed]
            for st in streams:
                st.reached.wait(600)
            t = time.perf_counter()
            wave_summary = src.drain_to(dst)
            wave_ms = (time.perf_counter() - t) * 1e3
            same = 0
            for st, (label, toks, _t, _s) in zip(streams, mixed):
                if not st.done.wait(600) or st.error is not None or st.final is None \
                        or st.tokens() != st.final["tokens"][len(toks):] \
                        or len(st.final["tokens"]) != len(toks) + MIG_NEW:
                    raise AssertionError(f"[migration] wave drain: {label} did not complete "
                                         f"whole ({st.error})")
                same += st.final["tokens"] == want[label]
            log(f"[migration] loopback drain of a streamed wave of {len(mixed)}: "
                f"{wave_summary['drained']} requests drained ({wave_summary['checkpoints']} "
                f"checkpoints, {wave_summary['handed']} handed) in {wave_ms:.1f} ms; every "
                f"stream completed whole; {same} of {len(mixed)} equal their alone tokens "
                f"(reported, not gated) [{card}]")
            retire(src)
            src = dst
            release()

            # -- over TCP through the peer engine's /drain
            dst = load(dirs[0], resume_tokens=1, restart_budget=0)
            apps = [_engine_for(src, dirs[0]), _engine_for(dst, dirs[0])]
            (src_port, dst_port), stop_tcp = _serve_engines(apps)
            stops.append(stop_tcp)
            label, toks, temp, seed = by_label["seeded_500"]
            st = _Stream(src.stream({"prompt_tokens": toks, "max_new_tokens": MIG_NEW,
                                     "temperature": temp, "seed": seed}))
            st.reached.wait(600)
            t = time.perf_counter()
            status, out = _post(src_port, {"to": f"127.0.0.1:{dst_port}"}, path="/drain")
            tcp_ms = (time.perf_counter() - t) * 1e3
            unit = (out.get("units") or {}).get("llm")
            if status != 200 or unit != {"drained": 1, "checkpoints": 1, "handed": 1,
                                         "failed": 0}:
                raise AssertionError(f"[migration] TCP /drain answered {status}: {out}")
            st.check("drained over TCP (/drain)", toks, want[label])
            log(f"[migration] TCP: POST /drain to the peer engine: 1 lane handed, the stream "
                f"completed with the undrained tokens (its tail as one span); the route "
                f"answered in {tcp_ms:.1f} ms (the import waits for the resumed generation) "
                f"[{card}]")

            # -- resume tokens: the member dies after two spans
            items = [by_label["seeded_500"], by_label["greedy_128"]]
            streams = [_Stream(dst.stream({"prompt_tokens": toks, "max_new_tokens": MIG_NEW,
                                           "temperature": temp, "seed": seed}), k=2)
                       for _l, toks, temp, seed in items]
            for st in streams:
                st.reached.wait(600)

            def die(_n):
                raise RuntimeError("injected member death")

            dst.batcher.fault_hook = die
            for st in streams:
                st.done.wait(600)
                if getattr(st.error, "status", None) != 503:
                    raise AssertionError(f"[migration] the killed member's stream ended "
                                         f"with {st.error!r}, not a 503")
            if dst.batcher.health != "dead":
                raise AssertionError(f"[migration] killed member is {dst.batcher.health}")
            tokens = [st.spans[-1]["resume_token"] for st in streams]
            if any(parse_token(tk)["rng_key"] is not None for tk in tokens):
                raise AssertionError("[migration] a stream's resume token carries a key")
            # resumed on the swap server while it still serves seed 0
            w = load(dirs[0], resume_tokens=1, prefix_cache_hbm_bytes=2 << 30)
            w_app = _engine_for(w, dirs[0])
            (w_port,), stop = _serve_engines([w_app])
            stops.append(stop)
            for st, tk, (label, toks, _t, _s) in zip(streams, tokens, items):
                resumed = _Stream(w.stream({"resume_token": tk}))
                resumed.done.wait(600)
                delivered = [t for ch in st.spans for t in ch["tokens"]]
                if resumed.error is not None or resumed.final["tokens"] != want[label] \
                        or delivered + resumed.tokens() != want[label][len(toks):]:
                    raise AssertionError(f"[migration] token resume of {label}: spans do not "
                                         "add up to the undrained stream")
            flipped = bytearray(tokens[0].encode())
            flipped[40] = ord("A") if flipped[40] != ord("A") else ord("B")
            ck = parse_token(tokens[1])
            stale = checkpoint_token({**ck, "weight_version": "v-other"})
            st400 = _post(w_port, {"jsonData": {"resume_token": flipped.decode()}},
                          path="/api/v0.1/predictions")[0]
            st409 = _post(w_port, {"jsonData": {"resume_token": stale}},
                          path="/api/v0.1/predictions")[0]
            if (st400, st409) != (400, 409):
                raise AssertionError(f"[migration] a flipped token answered {st400}, a token "
                                     f"of another weight_version {st409}")
            log(f"[migration] resume tokens: a seeded and a greedy stream, their member killed "
                f"after 2 spans (503), resumed on a peer from the last keyless token "
                f"(derive_lane_key): spans add up to the undrained streams; a flipped byte "
                f"answered 400, another weight_version 409")
            # the engines hold their servers: stop them so that the
            # retired servers' memory goes before the swap's peak is read
            stops.remove(stop_tcp)
            stop_tcp()
            retire(src)
            retire(dst)
            apps = stop_tcp = src = dst = None
            release()

            # -- dedicated references on seeds 1 and 2
            refs = {0: want}
            for seed in (1, 2):
                f = load(dirs[seed])
                refs[seed] = _mig_alone(f, both)
                retire(f)
                f = None
                release()

            # -- hot swap under traffic, through /weights/swap; the resumed
            # streams published their prompts in the swap server's cache
            b = w.batcher
            if b._prefix_index.total_bytes <= 0:
                raise AssertionError("[migration] nothing was published before the swap")
            load_ms, stage_ms, flip_ms = [], [], []
            _timed(w, "_load_checkpoint", load_ms)
            _timed(b, "request_weight_swap", stage_ms)
            _timed(b, "_do_swap", flip_ms)
            captured, inline = b.stats["graphs_captured"], b.stats["graph_captures_inline"]
            evicted0 = b.stats["prefix_evicted"]
            streams = [_Stream(w.stream({"prompt_tokens": toks, "max_new_tokens": MIG_NEW,
                                         "temperature": temp, "seed": seed}))
                       for _l, toks, temp, seed in swap_items]
            for st in streams:
                st.reached.wait(600)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            status, out = _post(w_port, {"model_uri": dirs[1], "wait_s": 300},
                                path="/weights/swap")
            swap_ms = (time.perf_counter() - t) * 1e3
            peak = torch.cuda.max_memory_allocated()
            _times(flip_ms, 1)
            if status != 200 or not out["units"]["llm"]["swapped"] \
                    or b.weight_version != "v1":
                raise AssertionError(f"[migration] /weights/swap answered {status}: {out}")
            for st, (label, toks, _t, _s) in zip(streams, swap_items):
                st.check(f"in flight across the swap ({label})", toks, want[label])
            # the resumed and the in-flight prompts were published under
            # seed 0: after the purge they must miss
            after = _mig_alone(w, both)
            bad = [x for x in after if after[x] != refs[1][x]]
            if bad or b.stats["prefix_evicted"] <= evicted0:
                raise AssertionError(f"[migration] after the swap {bad} differ from a fresh "
                                     f"seed-1 server's; prefix_evicted "
                                     f"{b.stats['prefix_evicted'] - evicted0}")
            if (b.stats["graphs_captured"], b.stats["graph_captures_inline"]) != (captured,
                                                                                   inline) \
                    or inline:
                raise AssertionError("[migration] the swap captured decode graphs")
            log(f"[migration] hot swap seed 0 -> seed 1 through /weights/swap under "
                f"{len(swap_items)} in-flight requests: they finished on seed 0 with their alone "
                f"tokens; afterwards {len(after)} requests, their prompts published under seed "
                f"0, equal a fresh seed-1 server's alone (the prefix cache purged: "
                f"prefix_evicted +{b.stats['prefix_evicted'] - evicted0}); graphs_captured "
                f"{captured} unchanged, graph_captures_inline 0; checkpoint load (random init "
                f"and cast on the card) {load_ms[0]:.1f} ms, request_weight_swap (check and "
                f"stage) {stage_ms[0]:.1f} ms, flip (copy into the served tensors, synchronised) "
                f"{flip_ms[0]:.2f} ms, route {swap_ms:.1f} ms; peak allocated "
                f"{peak / 2**30:.2f} GiB [{card}]")

            # -- the straggler bound, resume then fail
            g_label, g_toks, _t, _s = by_label["mixed_greedy_20"]
            for policy, target, version in (("resume", dirs[2], "s2"), ("fail", dirs[0], "s0")):
                b.swap_drain_ms, b.swap_resume_policy = 50, policy
                pre = b.stats["swap_preemptions"]
                new = w._load_checkpoint(target, "straggler swap")
                fut = b.submit(g_toks, max_new_tokens=STRAGGLER_NEW)
                while not any(len(s.emitted) > 0 for s in b._active.values()):
                    time.sleep(0.001)
                b.request_weight_swap(new, version=version).result(timeout=300)
                del new
                try:
                    res = fut.result(timeout=600)
                    failed = None
                except WeightVersionMismatch as e:
                    res, failed = None, e
                ok = (res is not None and len(res) == len(g_toks) + STRAGGLER_NEW) \
                    if policy == "resume" \
                    else (failed is not None and failed.status == 409)
                if not ok or b.stats["swap_preemptions"] <= pre:
                    raise AssertionError(f"[migration] straggler bound, {policy}: result "
                                         f"{'ok' if res else failed!r}, swap_preemptions "
                                         f"{b.stats['swap_preemptions'] - pre}")
            b.swap_drain_ms = 0
            _times(flip_ms, 3)
            if b.stats["graph_captures_inline"] or b.stats["graphs_captured"] != captured:
                raise AssertionError("[migration] a straggler swap captured decode graphs")
            log(f"[migration] straggler bound swap_drain_ms 50: a {STRAGGLER_NEW}-token generation "
                f"checkpointed and finished on the new weights (resume), refused with 409 "
                f"(fail); flips {', '.join(f'{x:.2f}' for x in flip_ms[1:])} ms [{card}]")
            retire(w)

            # -- three tenants over one batcher
            t0 = time.perf_counter()
            tn = load(dirs[0], tenants=f"t0=standard,t1=standard@{dirs[1]},"
                                       f"t2=best_effort@{dirs[2]}",
                      weight_pager_host_bytes=10 << 30, tenant_min_resident_ms=0,
                      tenant_max_wait_polls=1)
            tb = tn.batcher
            log(f"[migration] tenant server (3 tenants staged: "
                f"{tn.tenant_pager.host_bytes / 2**30:.2f} GiB of host blobs) loaded in "
                f"{time.perf_counter() - t0:.1f} s")
            promote_ms, pstage_ms, pflip_ms = [], [], []
            _timed(tn.tenant_pager, "promote", promote_ms, sync=False)
            _timed(tb, "request_weight_swap", pstage_ms)
            _timed(tb, "_do_swap", pflip_ms)
            captured, inline = tb.stats["graphs_captured"], tb.stats["graph_captures_inline"]
            seeds = {"t0": 0, "t1": 1, "t2": 2}
            rounds = [(by_label["greedy_128"], t) for t in ("t1", "t0", "t2")] + [
                (by_label["seeded_500"], "t2")]
            for item, tenant in rounds:
                got = _mig_alone(tn, [item], tenant=tenant)[item[0]]
                if got != refs[seeds[tenant]][item[0]]:
                    raise AssertionError(f"[migration] tenant {tenant}, {item[0]}: tokens "
                                         "differ from the dedicated server's")
            stats = dict(tn.tenant_scheduler.stats)
            page_ins = tn.tenant_pager.stats["page_ins"]
            _times(pflip_ms, stats["switches"])
            # a t0 backlog deeper than one poll (twice the slots) when the
            # t1 request arrives: the resident never idles before the
            # starvation bound forces the switch (a flood of one request
            # at a time leaves gaps in which the idle resident yields)
            backlog = [threading.Thread(target=lambda: tn.predict(
                {"prompt_tokens": g_toks, "max_new_tokens": 64, "tenant": "t0"}, []),
                daemon=True) for _ in range(2 * tb.slots)]
            for th in backlog:
                th.start()
            _wait_for(lambda: len(tb._active) > 0, "the t0 backlog", 120)
            try:
                label, toks, temp, seed = by_label["greedy_128"]
                got = _mig_alone(tn, [by_label["greedy_128"]], tenant="t1")[label]
            finally:
                for th in backlog:
                    th.join(600)
            forced = tn.tenant_scheduler.stats["forced_switches"] - stats["forced_switches"]
            if got != refs[1][label] or not forced:
                raise AssertionError(f"[migration] starvation bound: forced_switches {forced}")
            try:
                tn.predict({"prompt_tokens": g_toks, "max_new_tokens": 4, "tenant": "nope"}, [])
                raise AssertionError("[migration] an unknown tenant was served")
            except TenantUnknown as e:
                if e.status != 404:
                    raise
            if (tb.stats["graphs_captured"], tb.stats["graph_captures_inline"]) != (captured,
                                                                                     inline) \
                    or inline:
                raise AssertionError("[migration] a page-in captured decode graphs")
            sw = tn.tenant_scheduler.stats
            log(f"[migration] tenants: {len(rounds)} requests interleaved over t1, t0, t2 (seeds "
                f"1, 0, 2; greedy then seeded) equal each tenant's dedicated server alone; "
                f"{stats['switches']} switches, "
                f"{page_ins} page-ins (the first tenant's at load included), no graph captured "
                f"({captured}); behind a t0 backlog a t1 request was served by a forced switch "
                f"(forced_switches {forced}); an unknown tenant answered 404. Page-in: decode "
                f"(CRC, copy into pinned memory) {np.median(promote_ms):.0f} ms, stage (upload "
                f"{tb._param_bytes / 1e9:.2f} GB) {np.median(pstage_ms):.1f} ms, flip "
                f"{np.median(pflip_ms):.2f} ms "
                f"(medians of {len(promote_ms)}); switch cost "
                f"{sw['switch_cost_s_sum'] / max(1, sw['switches']) * 1e3:.0f} ms mean [{card}]")

            launches = fa.LAUNCHES["flash_attention"] - aside["n"]
            prefills = done_steps["n"] + sum(whole(s) - steps0[id(s)] for s in servers)
            if launches < LLM_1_26B["n_layers"] * prefills:
                raise AssertionError(f"[migration] {prefills} whole prefills, {launches} "
                                     "flash launches")
            log(f"[migration] flash launches {launches} over {prefills} whole-prompt prefills "
                f"(resume recomputes included) [{card}]")
            log(f"[migration] numbers: drain alone {', '.join(f'{x:.1f}' for x in drain_ms)} ms; "
                f"resume to first span {', '.join(f'{x:.1f}' for x in resume_ms)} ms; wave drain "
                f"{wave_ms:.1f} ms ({wave_summary['drained']} lanes); swap load "
                f"{load_ms[0]:.1f} ms, stage {stage_ms[0]:.1f} ms, flip {flip_ms[0]:.2f} ms, "
                f"peak {peak / 2**30:.2f} GiB; page-in decode {np.median(promote_ms):.0f} ms, "
                f"stage {np.median(pstage_ms):.1f} ms, flip {np.median(pflip_ms):.2f} ms "
                f"[{card}]")
        finally:
            for stop in stops:
                stop()
            for s in list(servers):
                s.close()
    return launches


# the telemetry phase: llm-1.26b with the flight recorder, the device-time
# ledger and SLO objectives on, fused decode and depth groups in its boot
# census (retuned under traffic)
TELEMETRY_KNOBS = {"fused_steps_per_dispatch": 64, "depth_groups": 4}
TELEMETRY_ON = {"profiler": 1, "profiler_hbm_gb_s": 3350,
                "flight_recorder": 512, "slo_objectives": "ttft:1000:0.99,tpot:10:0.99"}
TELEMETRY_RETUNE = {"fused_steps_per_dispatch": 32, "depth_groups": 2}
# (c): the ledger's per-dispatch burst time against CUDA events around
# the same replayed burst
LEDGER_TOL = 0.25


def _engine_call(rest, method, path, body=None):
    """One request through an engine's REST router in process:
    ``(status, json)``."""
    from seldon_core_tpu_torch.http_server import Request

    data = json.dumps(body).encode() if body is not None else b""
    query = ""
    if "?" in path:
        path, query = path.split("?", 1)
    hdrs = {"content-type": "application/json"} if data else {}
    resp = asyncio.run(rest._dispatch(Request(method, path, query, hdrs, data)))
    return resp.status, json.loads(resp.body) if resp.body else None


def _ledger_split(tag, summary, wall_s, card):
    """Print the ledger's device ms and share per kind over ``wall_s`` of
    traffic; returns (device busy share, modelled bytes / s)."""
    rows = summary["buckets"]
    total = sum(r["s"] for r in rows) or 1e-12
    for kind, secs in sorted(summary["by_kind"].items(), key=lambda kv: -kv[1]):
        n = sum(r["n"] for r in rows if r["kind"] == kind)
        log(f"[telemetry] {tag}: {kind} {secs * 1e3:.2f} ms over {n} dispatches, "
            f"{100 * secs / total:.1f}% of measured device time [{card}]")
    nbytes = sum(r["bytes"] for r in rows)
    busy = total / wall_s
    log(f"[telemetry] {tag}: measured device time {total * 1e3:.1f} ms in {wall_s * 1e3:.1f} ms "
        f"of wall time: busy {busy:.4f}, idle {1 - busy:.4f}; modelled reads "
        f"{nbytes / 1e9:.3f} GB, {nbytes / wall_s / 1e9:.1f} GB/s = MBU "
        f"{100 * nbytes / wall_s / PEAK_BYTES_S:.2f}% of 3.35 TB/s [{card}]")
    return busy, nbytes / wall_s


def _ledger_delta(before, after):
    """``after`` minus ``before`` of two ledger summaries, as a summary."""
    prev = {(r["kind"], r["variant"], r.get("tenant", "")): r for r in before["buckets"]}
    rows, by_kind = [], {}
    for r in after["buckets"]:
        p = prev.get((r["kind"], r["variant"], r.get("tenant", "")))
        d = {k: r[k] - (p[k] if p else 0) for k in ("s", "n", "bytes", "tokens")}
        if d["n"]:
            rows.append({"kind": r["kind"], "variant": r["variant"], **d})
            by_kind[r["kind"]] = by_kind.get(r["kind"], 0.0) + d["s"]
    return {"buckets": rows, "by_kind": by_kind}


def _burst_check(server, summary, card):
    """(c): the ledger's ms per step of its most frequent fused burst
    against CUDA events around the same replayed burst (greedy and
    sampled step graphs: the traffic ran both) on the same batcher, idle,
    with every lane live."""
    import torch

    b = server.batcher
    fused = [r for r in summary["buckets"] if r["kind"] in ("fused_burst", "decode_burst")]
    if not fused:
        raise AssertionError("[telemetry] the ledger recorded no whole-batch decode burst")
    row = max(fused, key=lambda r: r["n"])
    k, bucket = (int(x) for x in re.match(r"k(\d+)b(\d+)", row["variant"]).groups())
    ledger_ms = row["s"] * 1e3 / row["n"]
    w = b._whole
    w.act.fill_(True)
    w.budget.fill_(1 << 20)
    w.stops.fill_(-1)
    timed = {}
    for stoch in (False, True):
        def burst():
            # every write lands inside the bucket: k steps from bucket - k - 1
            w.pos.fill_(bucket - k - 1)
            b._whole_burst(k, bucket, stoch, True)  # replays the captured graphs

        burst()
        torch.cuda.synchronize()
        n = 4
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            burst()
        end.record()
        torch.cuda.synchronize()
        timed[stoch] = start.elapsed_time(end) / n
    b._reset_lanes()  # the lanes are idle: their registers go back to zero
    lo, hi = min(timed.values()), max(timed.values())
    ok = (1 - LEDGER_TOL) * lo <= ledger_ms <= (1 + LEDGER_TOL) * hi
    log(f"[telemetry] (c) ledger {row['kind']} {row['variant']} over {row['n']} dispatches: "
        f"{ledger_ms / k:.3f} ms per step; CUDA events around the same replayed burst: greedy "
        f"{timed[False] / k:.3f}, sampled {timed[True] / k:.3f} ms per step (tolerance "
        f"{LEDGER_TOL:.0%}): {'OK' if ok else 'FAIL'} [{card}]")
    if not ok:
        raise AssertionError("[telemetry] the ledger's burst time is off the CUDA-event timing")


def _prefill_check(server, card):
    """(d), not gated: a B=1, T=1024 prefill measured by a CUDA ledger
    (stream time) beside torch.profiler's kernel sum for the same call
    and its host wall time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from seldon_core_tpu_torch.serving.profiler import DeviceTimeLedger

    b = server.batcher
    rs = np.random.RandomState(4)
    prompt = rs.randint(0, LLM_1_26B["vocab_size"], (1, 1024))
    last = np.asarray([1023])
    b._prefill(prompt, last, [0], [0.0])
    torch.cuda.synchronize()
    led = DeviceTimeLedger(enabled=True, device="cuda")
    n = 3
    t0 = time.perf_counter()
    for _ in range(n):
        with led.measure("prefill", variant="p1024"):
            b._prefill(prompt, last, [0], [0.0])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    ledger_ms = led.summary()["by_kind"]["prefill"] * 1e3 / n
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            b._prefill(prompt, last, [0], [0.0])
        torch.cuda.synchronize()
    kern_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type.name == "CUDA") / 1e3 / n
    log(f"[telemetry] (d) B=1 T=1024 prefill: ledger (stream time) {ledger_ms:.3f} ms, "
        f"torch.profiler kernel sum {kern_ms:.3f} ms, host wall {wall_ms:.3f} ms: stream "
        f"time is {ledger_ms / kern_ms:.2f}x the device's busy time on this eager dispatch "
        f"[{card}]")


def phase_telemetry(card, serve_alone=None):
    """Telemetry and retune at llm-1.26b (bf16, seed-0 weights, the serve
    phase's GenerateServer parameters plus fused K 64 and depth groups
    4): a profiler-off boot gives the graph count and the tokens alone of
    the probe, greedy_128 and seeded_500; a boot with the ledger (3350 GB/s), the
    recorder (512) and TTFT/TPOT objectives serves the serve waves
    after the profiler-off boot (off, on), then
    checks (a) each request alone against the profiler-off boot's (and
    greedy_20 against the serve phase's when it ran), (b) the graph count
    and no capture after warm(), (c) the ledger's burst time against CUDA
    events, (d) a B=1 prefill's stream time beside its kernel sum
    (printed), (e) a retune of fused K and depth groups through the
    engine's /retune under in-flight traffic (applied at a poll boundary,
    no graph captured, each request alone unchanged after it; an
    out-of-census value 409), (f) /flightrecorder and /fleet through the
    same engine. Returns the flash kernel's launches over the traffic."""
    import torch

    probe, mixed = serve_waves()
    items = probe + [m for m in mixed if m[0] in ("greedy_128", "seeded_500")]
    with tempfile.TemporaryDirectory(prefix="chip-telemetry-") as root:
        model_dir = _mig_dir(root, 0)
        t0 = time.perf_counter()
        off = _gen_server(model_dir, **TELEMETRY_KNOBS)
        boot_off = time.perf_counter() - t0
        graphs_off = off.batcher.stats["graphs_captured"]
        on = None
        try:
            if off.batcher.flight is None or off.profiler.enabled:
                raise AssertionError("[telemetry] the profiler-off boot is not the default")
            ref = _alone(off, items)
            if serve_alone is not None and ref["greedy_20"] != serve_alone[0]:
                raise AssertionError("[telemetry] greedy_20 alone differs from the serve "
                                     "phase's")
            t0 = time.perf_counter()
            on = _gen_server(model_dir, **TELEMETRY_KNOBS, **TELEMETRY_ON)
            boot_on = time.perf_counter() - t0
            b = on.batcher
            census = b.retune_census()
            log(f"[telemetry] boots: profiler off {boot_off:.1f} s, on {boot_on:.1f} s; graphs "
                f"captured {graphs_off} / {b.stats['graphs_captured']}; census {census}")
            if (b.stats["graphs_captured"] != graphs_off
                    or b.stats["graph_captures_inline"]):
                raise AssertionError("[telemetry] (b) the ledger changed the graph count")
            if TELEMETRY_RETUNE["fused_steps_per_dispatch"] not in census["fused_ks"]:
                raise AssertionError("[telemetry] the retune target is outside the census")
            app = _engine_for(on, model_dir)
            rest = app.rest_app()

            def poster(server):
                return lambda body: (200, {"jsonData": server.predict(body["jsonData"], [])})

            post = poster(on)
            # (a) each request alone, as on the profiler-off boot, so both
            # servers' waves come after the same traffic
            t_run = time.perf_counter()
            got = _alone(on, items)
            bad = [x for x in items if got[x[0]] != ref[x[0]]]
            if bad:
                raise AssertionError(f"[telemetry] (a) {[x[0] for x in bad]} alone differ "
                                     "from the profiler-off boot's")
            log(f"[telemetry] (a) {len(items)} requests alone on the profiler-on server equal "
                "the profiler-off boot's")
            # the serve waves with the ledger off and on (what the ledger
            # costs end to end), the SM clock and power sampled after each
            numbers = {"off": [], "on": []}
            wall = off_wall = 0.0
            before = on.profiler.summary()
            # (off, on: the second pair of the alternation is cut for the
            # whole script's time budget)
            for side in ("off", "on"):
                server = on if side == "on" else off
                t0 = time.perf_counter()
                n_launch, _p, _f, nums = run_waves(
                    f"telemetry ledger {side}", poster(server), server.batcher, probe, mixed,
                    card)
                if side == "on":
                    wall += time.perf_counter() - t0
                    launches = n_launch
                else:
                    off_wall += time.perf_counter() - t0
                numbers[side].append(nums)
                smi = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                    capture_output=True, text=True, timeout=60).stdout.strip()
                log(f"[telemetry] after the ledger-{side} waves: SM clock, power draw {smi}")
            log("[telemetry] the serve waves, ledger on vs off (off, on): "
                + "; ".join(f"{k} on {numbers['on'][0][k]:.2f} / off {numbers['off'][0][k]:.2f}"
                            for k in ("tok_s", "ttft_p50", "tpot_p50")) + f" [{card}]")
            off.close()
            off = None
            gc.collect()
            torch.cuda.empty_cache()
            traffic = _ledger_delta(before, on.profiler.summary())
            _ledger_split("the serve waves (the ledger-on run)", traffic, wall, card)
            live = on.profiler.gauges()
            phases = {k[len("sched_s_"):]: round(v, 3) for k, v in b.stats.items()
                      if k.startswith("sched_s_")}
            log(f"[telemetry] live gauges over the ledger's 10 s window: device_busy_frac "
                f"{live.get('device_busy_frac')}, mbu_pct {live.get('mbu_pct')} (3350 GB/s); "
                f"scheduler thread s by phase {phases} [{card}]")
            _burst_check(on, traffic, card)
            # (e) a retune through the engine while the mixed wave decodes
            graphs0 = b.stats["graphs_captured"]
            wave = {}
            th = threading.Thread(target=lambda: wave.update(fire(post, mixed)))
            th.start()
            # the retune lands while most of the wave decodes
            deadline = time.monotonic() + 60
            while len(b._active) < len(mixed) - 2 and time.monotonic() < deadline:
                time.sleep(0.001)
            t0 = time.perf_counter()
            status, out = _engine_call(rest, "POST", "/retune",
                                       {"knobs": TELEMETRY_RETUNE, "origin": "chip_smoke"})
            retune_ms = (time.perf_counter() - t0) * 1e3
            inflight = len(b._active)
            th.join(600)
            if status != 200:
                raise AssertionError(f"[telemetry] (e) /retune answered {status}: {out}")
            for label, toks, _t, _s in mixed:
                st, body = wave[label]
                if st != 200 or len(body["jsonData"]["tokens"][0]) != len(toks) + MAX_NEW:
                    raise AssertionError(f"[telemetry] (e) {label} failed across the retune")
            changed = out["units"]["llm"]["changed"]
            if set(changed) != set(TELEMETRY_RETUNE) or len(wave) != len(mixed):
                raise AssertionError(f"[telemetry] (e) retune changed {changed}")
            got = _alone(on, items)
            bad = [x[0] for x in items if got[x[0]] != ref[x[0]]]
            if bad or b.stats["graphs_captured"] != graphs0 or b.stats["graph_captures_inline"]:
                raise AssertionError(f"[telemetry] (e) after the retune: {bad} differ alone, "
                                     f"graphs {graphs0} -> {b.stats['graphs_captured']}")
            status, out = _engine_call(rest, "POST", "/retune",
                                       {"knobs": {"fused_steps_per_dispatch": 128}})
            if status != 409:
                raise AssertionError(f"[telemetry] (e) out-of-census retune answered {status}")
            log(f"[telemetry] (e) /retune {changed} applied at a poll boundary in "
                f"{retune_ms:.1f} ms with {inflight} lanes in flight; no graph captured; each "
                f"request alone unchanged; fused 128 answered 409 ({out['status']['info'][:60]})")
            # (f) the recorder and the fleet plane through the same engine
            status, fr = _engine_call(rest, "GET", "/flightrecorder")
            dump = fr["units"]["llm"] if status == 200 else {}
            want = {"capacity", "enabled", "recorded_total", "dropped", "entries", "slo",
                    "stats", "weight_version", "profiler", "slo_burn"}
            if status != 200 or not want <= set(dump):
                raise AssertionError(f"[telemetry] (f) /flightrecorder {status} "
                                     f"{sorted(dump)}")
            status, fleet = _engine_call(rest, "GET", "/fleet")
            unit = fleet["units"].get("llm", {}) if status == 200 else {}
            # on the card /fleet also carries the member's device block
            if status != 200 or set(fleet) != {"predictor", "metrics", "units", "device"} \
                    or set(unit) != {"profiler", "slo_burn", "planning"} \
                    or fleet["device"]["memory_allocated"] <= 0:
                raise AssertionError(f"[telemetry] (f) /fleet {status} {sorted(fleet)} "
                                     f"{sorted(unit)}")
            types = collections.Counter(e["type"] for e in dump["entries"])
            polls = [e for e in dump["entries"] if e["type"] == "poll"]
            log(f"[telemetry] (f) /flightrecorder: {dump['recorded_total']} records "
                f"({dump['dropped']} dropped), {len(polls)} poll records in the ring, "
                f"{sum('device_time' in e for e in polls)} with ledger rows; types "
                f"{dict(types)}; /fleet series: {len(fleet['metrics']['counters'])} counters, "
                f"{len(fleet['metrics']['gauges'])} gauges [{card}]")
            for v in unit["slo_burn"]["verdicts"]:
                log(f"[telemetry] burn {v['slo']} ({v['threshold_s'] * 1e3:.0f} ms at "
                    f"{v['target']}): fast {v['fast_burn']} slow {v['slow_burn']} over "
                    f"{v['slow_samples']} samples, budget left {v['budget_remaining']}, "
                    f"{v['severity']} [{card}]")
            # the profiler-on server's whole run, its traffic only
            _ledger_split("the whole serving run", on.profiler.summary(),
                          time.perf_counter() - t_run - off_wall, card)
            _prefill_check(on, card)
        finally:
            for server in (off, on):
                if server is not None:
                    server.close()
    return launches


FRONTS_NEW = 32  # new tokens of a strData prompt: the generate server's default
FRONTS_LENS = (20, 128, 500, 900, 20, 300, 24, 30)
WORKER_CLASS = """import os

import torch

from seldon_core_tpu_torch.servers.generateserver import GenerateServer


class PidGenerateServer(GenerateServer):
    def tags(self):
        return {**super().tags(), "pid": os.getpid(),
                "reserved_mib": torch.cuda.memory_reserved() >> 20,
                "peak_allocated_mib": torch.cuda.max_memory_allocated() >> 20}
"""


def fronts_traffic():
    """The fronts phase's traffic: strData prompts of printable ASCII (the
    byte-level prompts of a generate server), two of 20 bytes and a wave
    of 8 at the serve waves' lengths; and 16 token records at the same
    lengths, 64 new tokens, every fourth seeded."""
    import numpy as np

    rs = np.random.RandomState(12)

    def text(n):
        return "".join(chr(c) for c in rs.randint(32, 127, n))

    probe = [("str_20a", text(20)), ("str_20b", text(20))]
    wave = [(f"str_{n}_{i}", text(n)) for i, n in enumerate(FRONTS_LENS)]
    vocab = LLM_1_26B["vocab_size"]
    records = []
    for i in range(16):
        seeded = i % 4 == 2
        records.append((f"r{i:02d}", rs.randint(0, vocab, FRONTS_LENS[i % 8]).tolist(),
                        0.8 if seeded else 0.0, i if seeded else 0))
    return probe, wave, records


def _fbs_call(conn, frame):
    """One frame out on ``conn``, the decoded answer back."""
    import struct

    from seldon_core_tpu_torch import fbs

    conn.sendall(frame)
    head = fbs._recv_exact(conn, 4)
    payload = None if head is None else fbs._recv_exact(conn, struct.unpack("<I", head)[0])
    if payload is None:
        raise AssertionError("[fronts] the FBS server closed the connection mid-answer")
    return fbs.decode_message(head + payload)


def _fbs_text(port, text, timeout=600.0):
    """One strData request on a fresh connection: (tokens, client ms)."""
    from seldon_core_tpu_torch import fbs

    t = time.perf_counter()
    with socket.create_connection(("127.0.0.1", port), timeout) as conn:
        out = _fbs_call(conn, fbs.encode_message(str_data=text))
    return _fbs_tokens(out), (time.perf_counter() - t) * 1e3


def _fbs_tokens(out):
    st = out["status"]
    if not st or st["code"] != 200 or st["status"] != "SUCCESS" or out["strData"] is None:
        raise AssertionError(f"[fronts] FBS answered {st}")
    return json.loads(out["strData"])["tokens"]


def _ping(port) -> bool:
    try:
        return _get(port, "/ping", timeout=5)[0] == 200
    except (OSError, ValueError):
        return False


def _get(port, path, timeout=60.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        raw = resp.read()
        if resp.getheader("Content-Type", "").startswith("application/json"):
            return resp.status, json.loads(raw)
        return resp.status, raw
    finally:
        conn.close()


def _pctl(xs, q):
    import numpy as np

    return float(np.percentile(xs, q))


def _next_ttft(batcher, n_before, what):
    """TTFT (ms) of the request that completes the batcher's SLO reservoir
    past ``n_before`` entries (requests run one at a time)."""
    deadline = time.monotonic() + 10
    while len(batcher.slo_recent) <= n_before and time.monotonic() < deadline:
        time.sleep(0.001)
    if len(batcher.slo_recent) <= n_before:
        raise AssertionError(f"[fronts] {what}: no SLO record landed")
    return batcher.slo_recent[-1][1] * 1e3


def _smi_apps():
    """[(pid, MiB)] of the card's compute processes, one per line that
    nvidia-smi prints (inside a container several processes may show
    under one pid)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30).stdout
    apps = []
    for line in out.strip().splitlines():
        pid, _, mib = line.partition(",")
        try:
            apps.append((int(pid), int(mib)))
        except ValueError:
            continue
    return apps


def _smi_used():
    """The card's memory.used in MiB (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30).stdout
    return int(out.strip().splitlines()[0])


def _fronts_a(card, fport, mport, probe, wave):
    """(a) FBS over the in-process server; returns nothing, raises on a
    failed check."""
    import numpy as np

    from seldon_core_tpu_torch import fbs

    for label, text in probe:
        toks, _ms = _fbs_text(fport, text)
        if len(toks) != 1 or toks[0][:len(text)] != list(text.encode()) \
                or len(toks[0]) != len(text) + FRONTS_NEW:
            raise AssertionError(f"[fronts] {label}: malformed FBS tokens")
    got, errors = {}, []

    def one(label, text):
        try:
            got[label] = _fbs_text(fport, text)[0]
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(f"{label}: {type(e).__name__}: {e}")

    t = time.perf_counter()
    threads = [threading.Thread(target=one, args=it) for it in wave]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    wave_s = time.perf_counter() - t
    if errors or len(got) != len(wave):
        raise AssertionError(f"[fronts] FBS wave failed: {errors or 'a request did not finish'}")
    for label, text in wave:
        toks = got[label]
        if len(toks) != 1 or toks[0][:len(text)] != list(text.encode()) \
                or len(toks[0]) != len(text) + FRONTS_NEW:
            raise AssertionError(f"[fronts] {label}: malformed FBS tokens")
    log(f"[fronts] (a) FBS wave of {len(wave)} strData prompts ({min(FRONTS_LENS)}-"
        f"{max(FRONTS_LENS)} bytes, {FRONTS_NEW} new tokens) on {len(wave)} connections: "
        f"{len(wave) * FRONTS_NEW / wave_s:.1f} tokens/s in {wave_s:.2f} s [{card}]")
    fbs_ms, rest_ms, in_wave = [], [], 0
    # the probe and the first half of the wave alone (lengths 20-900)
    for label, text in probe + wave[: len(wave) // 2]:
        toks, ms = _fbs_text(fport, text)
        t = time.perf_counter()
        status, body = _post(mport, {"strData": text})
        rest_ms.append((time.perf_counter() - t) * 1e3)
        fbs_ms.append(ms)
        if status != 200:
            raise AssertionError(f"[fronts] {label}: REST HTTP {status} {body}")
        if toks != body["jsonData"]["tokens"]:
            raise AssertionError(f"[fronts] {label}: FBS alone != REST alone")
        in_wave += label in got and got[label] == toks
    log(f"[fronts] (a) each of {len(fbs_ms)} strData prompts alone: FBS tokens == REST "
        f"/predict tokens; the wave's equal to alone: {in_wave} of {len(wave)} "
        "(bf16 rounding depends on batch composition)")
    log(f"[fronts] (a) client ms alone, FBS vs REST: p50 {_pctl(fbs_ms, 50):.1f} vs "
        f"{_pctl(rest_ms, 50):.1f}, min {min(fbs_ms):.1f} vs {min(rest_ms):.1f}, "
        f"max {max(fbs_ms):.1f} vs {max(rest_ms):.1f} [{card}]")
    with socket.create_connection(("127.0.0.1", fport), 600) as conn:
        out = _fbs_call(conn, fbs.encode_message(np.array([[1.0, 2.0]]), ["a", "b"]))
        st = out["status"] or {}
        if st.get("status") != "FAILURE" or "ValueError" not in st.get("info", ""):
            raise AssertionError(f"[fronts] an ndarray request answered {st}, not a FAILURE "
                                 "frame with the server's ValueError")
        label, text = probe[0]
        again = _fbs_tokens(_fbs_call(conn, fbs.encode_message(str_data=text)))
        if again != _fbs_text(fport, text)[0]:
            raise AssertionError("[fronts] the connection after a FAILURE frame answered "
                                 "other tokens")
    log(f"[fronts] (a) DefaultData request: FAILURE frame, code {st['code']}, "
        f"{st['info'][:60]!r}...; the same connection then served {label}")


def _fronts_b(card, user, ports, records, sink, cport):
    """(b) the request logger: each record alone through the engine with
    the CloudEvents sink on and through the one without it, alternated.
    Returns each record's tokens alone."""
    batcher = user.batcher
    lat = {"on": [], "off": []}
    ttft = {"on": [], "off": []}
    alone = {}
    for i, (label, toks, temp, seed) in enumerate(records):
        got = {}
        for side in (("on", "off") if i % 2 == 0 else ("off", "on")):
            n0 = len(batcher.slo_recent)
            t = time.perf_counter()
            status, body = _post(ports["engine_" + side], _gen_body(toks, temp, seed),
                                 path="/api/v0.1/predictions")
            lat[side].append((time.perf_counter() - t) * 1e3)
            if status != 200:
                raise AssertionError(f"[fronts] {label} logger {side}: HTTP {status} {body}")
            ttft[side].append(_next_ttft(batcher, n0, label))
            got[side] = body["jsonData"]["tokens"]
            out = got[side]
            if len(out) != 1 or out[0][:len(toks)] != toks or len(out[0]) != len(toks) + MAX_NEW:
                raise AssertionError(f"[fronts] {label}: malformed tokens")
        if got["on"] != got["off"]:
            raise AssertionError(f"[fronts] {label}: logger on != off, each alone")
        alone[label] = got["off"][0]
    n = len(records)
    deadline = time.monotonic() + 30
    while sink.stats["posted"] + sink.stats["errors"] < n and time.monotonic() < deadline:
        time.sleep(0.01)
    status, entries = _get(cport, "/entries")
    docs = entries["entries"]
    if status != 200 or len(docs) != n or entries["stats"]["events"] != n \
            or sorted(d["response"]["tokens"][0] for d in docs) != sorted(alone.values()):
        raise AssertionError(f"[fronts] the collector holds {len(docs)} documents, "
                             f"stats {entries.get('stats')}, for {n} pairs")
    if sink.stats != {"posted": n, "dropped": 0, "errors": 0}:
        raise AssertionError(f"[fronts] sink stats {sink.stats}, want {n} posted")
    log(f"[fronts] (b) {n} generate predictions through the engine with the CloudEvents "
        f"sink: {n} documents at the collector's /entries, sink {sink.stats}; each alone "
        "equal with the logger on and off")
    for side in ("on", "off"):
        log(f"[fronts] (b) logger {side}: engine latency p50 {_pctl(lat[side], 50):.1f} ms, "
            f"p99 {_pctl(lat[side], 99):.1f}; TTFT p50 {_pctl(ttft[side], 50):.1f} ms, "
            f"p99 {_pctl(ttft[side], 99):.1f} (alternated, {n} each) [{card}]")
    return alone


def _fronts_c(card, tmp, engine_port, records, alone):
    """(c) the ingest tier: a FileQueue of the records and a poison record
    drained through the engine by IngestConsumer(concurrency=8), stopped
    after about half and restarted; then a second group at concurrency 1,
    whose records are each alone."""
    from seldon_core_tpu_torch.ingest import FileQueue, IngestConsumer, read_results

    q = FileQueue(os.path.join(tmp, "queue"))
    poison = {"id": "poison", "request": {"data": {"raw": {
        "dtype": "no-such-dtype", "shape": [1], "data": ""}}}}
    recs = [{"id": label, "request": _gen_body(toks, temp, seed)}
            for label, toks, temp, seed in records]
    q.append_many(recs[:8] + [poison] + recs[8:])
    ids = {r["id"] for r in recs}

    def drain(group, concurrency, stop_at=None):
        out = os.path.join(tmp, f"results-{group}.jsonl")
        dead = os.path.join(tmp, f"dead-{group}.jsonl")
        lat = []

        def consumer():
            c = IngestConsumer(q, "127.0.0.1", engine_port, group=group, out_path=out,
                               dead_letter_path=dead, concurrency=concurrency, retries=2,
                               retry_backoff_s=0.01, engine_timeout_s=600.0)
            score = c._score

            async def timed(record):
                t = time.perf_counter()
                try:
                    return await score(record)
                finally:
                    lat.append((time.perf_counter() - t) * 1e3)
            c._score = timed
            return c

        async def first_life():
            c = consumer()
            task = asyncio.ensure_future(c.run())
            while c.stats["scored"] < stop_at and not task.done():
                await asyncio.sleep(0.005)
            c.stop()
            return await task

        t = time.perf_counter()
        lives = []
        if stop_at is not None:
            lives.append(asyncio.run(first_life()))
            lives.append(q.committed(group))
        lives.append(asyncio.run(consumer().run(drain=True)))
        wall = time.perf_counter() - t
        results = read_results(out)
        with open(out) as f:
            rows = [json.loads(line)["id"] for line in f]
        with open(dead) as f:
            dead_rows = [json.loads(line) for line in f]
        if set(results) != ids or sorted(rows) != sorted(ids):
            raise AssertionError(f"[fronts] {group}: results {sorted(rows)}, want each of "
                                 f"{len(ids)} records once")
        if [r["record"]["id"] for r in dead_rows] != ["poison"] or not dead_rows[0]["error"]:
            raise AssertionError(f"[fronts] {group}: dead letters {dead_rows}")
        if q.committed(group) != q.end_offset():
            raise AssertionError(f"[fronts] {group}: commit {q.committed(group)} short of "
                                 f"the queue's end {q.end_offset()}")
        for rid, row in results.items():
            toks = row["response"]["jsonData"]["tokens"]
            if len(toks) != 1 or len(toks[0]) != len(alone[rid]) \
                    or toks[0][:len(toks[0]) - MAX_NEW] != alone[rid][:len(toks[0]) - MAX_NEW]:
                raise AssertionError(f"[fronts] {group} {rid}: malformed result")
        same = sum(results[rid]["response"]["jsonData"]["tokens"][0] == alone[rid] for rid in ids)
        return lives, wall, lat, same

    # stopped once the first record is scored: the first wave of 8 (and
    # what a freed slot polled) ends in the first life, the rest in the
    # restart
    lives, wall, lat, same = drain("fronts", 8, stop_at=1)
    first, commit1, second = lives
    if not 0 < first["scored"] < len(recs) or second["scored"] <= 0:
        raise AssertionError(f"[fronts] ingest lives scored {first['scored']} and "
                             f"{second['scored']}: the restart drained nothing")
    log(f"[fronts] (c) ingest, concurrency 8: {len(recs)} records + 1 poison; first life "
        f"scored {first['scored']} (commit {commit1}), the restart {second['scored']} "
        f"(replayed {second['replayed']}); every record once in the results, the poison "
        f"dead-lettered, commit at the end ({q.end_offset()}); equal to alone: {same} of "
        f"{len(recs)} (bf16, batch composition)")
    log(f"[fronts] (c) ingest, concurrency 8: {len(recs) / wall:.2f} records/s over both "
        f"lives ({wall:.2f} s), per-record engine call p50 {_pctl(lat, 50):.1f} ms, "
        f"p99 {_pctl(lat, 99):.1f} [{card}]")
    lives, wall, lat, same = drain("fronts-alone", 1)
    if same != len(recs):
        raise AssertionError(f"[fronts] ingest at concurrency 1: {same} of {len(recs)} "
                             "records equal to the same request alone")
    log(f"[fronts] (c) ingest, concurrency 1: every record equal to the same request alone; "
        f"{len(recs) / wall:.2f} records/s, p50 {_pctl(lat, 50):.1f} ms, "
        f"p99 {_pctl(lat, 99):.1f} [{card}]")


def _fronts_e(card, tmp, model_dir, records, alone):
    """(e) --workers 2: the microservice CLI as a subprocess serving
    PidGenerateServer from ``model_dir``; 16 requests on fresh
    connections answered by two pids, each equal to the same request
    alone; SIGTERM ends both workers with code 0."""
    with open(os.path.join(tmp, "PidGenerateServer.py"), "w") as f:
        f.write(WORKER_CLASS)
    params = [{"name": "model_uri", "value": model_dir, "type": "STRING"}] + SERVE_PARAMS
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + tmp,
               PREDICTIVE_UNIT_PARAMETERS=json.dumps(params))
    port = _free_port()
    log_path = os.path.join(tmp, "workers.log")
    logf = open(log_path, "w")
    base = _smi_used()
    peak = {"used": base, "lines": []}
    sampling = threading.Event()

    def sample():
        while not sampling.wait(0.5):
            used = _smi_used()
            if used > peak["used"]:
                peak.update(used=used, lines=_smi_apps())

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.microservice", "PidGenerateServer",
         "REST", "--workers", "2", "--service-port", str(port), "--host", "127.0.0.1"],
        cwd=tmp, env=env, stdout=logf, stderr=subprocess.STDOUT)
    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        seen, first_s = set(), None
        deadline = time.monotonic() + 240
        while len(seen) < 2 and time.monotonic() < deadline:
            if proc.poll() is not None:
                raise AssertionError(f"[fronts] --workers 2 exited with {proc.returncode}")
            try:
                status, body = _post(port, _gen_body([1, 2, 3], max_new=1), timeout=60)
            except OSError:
                time.sleep(0.2)
                continue
            if status != 200:
                raise AssertionError(f"[fronts] worker answered HTTP {status} {body}")
            seen.add(body["meta"]["tags"]["pid"])
            first_s = first_s or time.perf_counter() - t0
        if len(seen) < 2:
            raise AssertionError(f"[fronts] only pids {seen} answered within 240 s")
        both_s = time.perf_counter() - t0
        pids, mem = collections.Counter(), {}
        for label, toks, temp, seed in records:
            status, body = _post(port, _gen_body(toks, temp, seed))
            if status != 200:
                raise AssertionError(f"[fronts] {label} via --workers 2: HTTP {status} {body}")
            if body["jsonData"]["tokens"] != [alone[label]]:
                raise AssertionError(f"[fronts] {label} via --workers 2 != the same request alone")
            tags = body["meta"]["tags"]
            pids[tags["pid"]] += 1
            mem[tags["pid"]] = (tags["reserved_mib"], tags["peak_allocated_mib"])
        if len(pids) < 2:
            raise AssertionError(f"[fronts] {len(records)} requests all answered by {dict(pids)}")
        now, used = _smi_apps(), _smi_used()
        sampling.set()
        sampler.join(5)
        t = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(30)
        except subprocess.TimeoutExpired:
            raise AssertionError("[fronts] SIGTERM did not end --workers 2 within 30 s") from None
        stop_s = time.perf_counter() - t
        if rc != 0:
            raise AssertionError(f"[fronts] --workers 2 exited {rc} after SIGTERM")
    except BaseException:
        with open(log_path) as f:
            log(f"[fronts] workers log tail:\n{f.read()[-3000:]}")
        raise
    finally:
        sampling.set()
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        logf.close()
    log(f"[fronts] (e) --workers 2: first answer {first_s:.1f} s, both pids {both_s:.1f} s "
        f"after launch; {len(records)} requests on fresh connections answered by pids "
        f"{dict(pids)}, each equal to the same request alone; SIGTERM -> exit 0 in "
        f"{stop_s:.1f} s [{card}]")
    log(f"[fronts] (e) nvidia-smi --query-compute-apps=pid,used_memory after the requests "
        f"(pid, MiB): {now}, at the card's peak: {peak['lines']} (inside a container the "
        f"processes may show under one pid) [{card}]")
    log(f"[fronts] (e) the card's memory.used: {base} MiB before the launch, {used} MiB with "
        f"both workers serving (+{used - base}), peak {peak['used']} MiB (+{peak['used'] - base}) "
        f"over the boots and requests [{card}]")
    for pid in sorted(mem):
        log(f"[fronts] (e) worker {pid}: torch.cuda.memory_reserved {mem[pid][0]} MiB, "
            f"max_memory_allocated {mem[pid][1]} MiB (after its last answer) [{card}]")


def phase_fronts(card):
    """The fronts at llm-1.26b (bf16, seed-0 weights, the serve phase's
    GenerateServer parameters): (a) an FBSServer over the in-process
    server: the two 20-byte strData prompts, a wave of 8 on 8
    connections, each prompt alone equal over FBS and REST /predict, an
    ndarray request answered by a FAILURE frame on a connection that
    stays usable; (b) the request logger's collector started through its
    CLI, an engine with ``RequestLogger.from_env()`` over the same server
    against one without: 16 generate predictions alone, alternated, one
    document each at ``/entries``, the sink's posted 16 with nothing
    dropped; (c) the ingest tier through the engine; (d) ``/openapi.json``
    on the engine and the microservice; (e) ``--workers 2``. Returns the
    flash kernel's launches over (a)-(d)."""
    import torch

    from seldon_core_tpu_torch import fbs, wrapper
    from seldon_core_tpu_torch.graph.service import RequestLogger
    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.request_logging import CloudEventsSink

    probe, wave, records = fronts_traffic()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-fronts-") as tmp:
        model_dir = os.path.join(tmp, "llm")
        os.makedirs(model_dir)
        with open(os.path.join(model_dir, "jax_config.json"), "w") as f:
            json.dump({"family": "llm", "config": LLM_1_26B}, f)
        t0 = time.perf_counter()
        user = _gen_server(model_dir)
        log(f"[fronts] llm-1.26b loaded and warmed in {time.perf_counter() - t0:.1f} s")
        cport = _free_port()
        collector_log = open(os.path.join(tmp, "collector.log"), "w")
        collector = subprocess.Popen(
            [sys.executable, "-m", "seldon_core_tpu_torch.request_logging",
             "--host", "127.0.0.1", "--port", str(cport)],
            cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
            stdout=collector_log, stderr=subprocess.STDOUT)
        stops, fbs_srv, sink = [], None, None
        try:
            _wait_for(lambda: _ping(cport), "the request-logger collector", 60)
            saved = os.environ.get("SELDON_MESSAGE_LOGGING_SERVICE")
            os.environ["SELDON_MESSAGE_LOGGING_SERVICE"] = f"http://127.0.0.1:{cport}/"
            try:
                logger_on = RequestLogger.from_env()
            finally:
                if saved is None:
                    os.environ.pop("SELDON_MESSAGE_LOGGING_SERVICE")
                else:
                    os.environ["SELDON_MESSAGE_LOGGING_SERVICE"] = saved
            sink = logger_on.sink
            if not isinstance(sink, CloudEventsSink):
                raise AssertionError("SELDON_MESSAGE_LOGGING_SERVICE did not select the "
                                     "CloudEvents sink")
            fronts = {"micro": wrapper.get_rest_microservice(user),
                      "engine_on": _engine_for(user, model_dir,
                                               request_logger=logger_on).rest_app(),
                      "engine_off": _engine_for(user, model_dir).rest_app()}
            ports = {k: _free_port() for k in fronts}

            async def start():
                for k, front in fronts.items():
                    await front.start("127.0.0.1", ports[k])

                async def close():
                    for front in fronts.values():
                        front.close()
                return close

            stops.append(serve_in_thread(start))
            fbs_srv = fbs.FBSServer(user, host="127.0.0.1", port=0).start()
            stats0 = dict(user.batcher.stats)
            torch.cuda.synchronize()
            fa.LAUNCHES["flash_attention"] = 0  # count this phase's traffic only
            _fronts_a(card, fbs_srv.port, ports["micro"], probe, wave)
            alone = _fronts_b(card, user, ports, records, sink, cport)
            _fronts_c(card, tmp, ports["engine_off"], records, alone)
            for name, key in (("engine", "engine_off"), ("microservice", "micro")):
                status, doc = _get(ports[key], "/openapi.json")
                if status != 200 or set(doc["paths"]) != set(fronts[key].routes):
                    raise AssertionError(f"[fronts] {name} /openapi.json: HTTP {status}, "
                                         "paths other than its routes")
            log(f"[fronts] (d) /openapi.json 200 on the engine ({len(fronts['engine_off'].routes)}"
                f" paths) and the microservice ({len(fronts['micro'].routes)} paths), each "
                "equal to its served routes")
            torch.cuda.synchronize()
            launches = fa.LAUNCHES["flash_attention"]
            prefills = user.batcher.stats["prefill_steps"] - stats0["prefill_steps"]
            layers = LLM_1_26B["n_layers"]
            log(f"[fronts] prefill dispatches {prefills}, flash kernel launches {launches} "
                f"(need >= {layers} x {prefills})")
            if prefills <= 0 or launches < layers * prefills:
                raise AssertionError("not every prefill went through the flash kernel")
        finally:
            if fbs_srv is not None:
                fbs_srv.close()
            for stop in stops:
                stop()
            if sink is not None:
                sink.close()
            collector.terminate()
            collector.wait(30)
            collector_log.close()
            user.close()
        del user, fronts
        gc.collect()
        torch.cuda.empty_cache()
        _fronts_e(card, tmp, model_dir, records, alone)
    return launches


# -- zoo: the predict path's model zoo -------------------------------------

# full width and depth, random weights from seed 0: ResNet-50 and BERT-base
# as the JAX package's benchmark serves them (seldon_core_tpu/modelbench.py
# bench_resnet50_rest, bench_bert_grpc), ViT-B/16 and the iris MLP at the
# zoo's defaults
ZOO_RESNET = {"num_classes": 1000, "image_size": 224, "dtype": "bfloat16", "seed": 0}
ZOO_BERT = {"vocab_size": 30522, "d_model": 768, "n_layers": 12, "n_heads": 12,
            "d_ff": 3072, "max_seq": 512, "num_classes": 2, "dtype": "bfloat16", "seed": 0}
ZOO_VIT = {"image_size": 224, "patch_size": 16, "d_model": 768, "n_layers": 12,
           "n_heads": 12, "d_ff": 3072, "num_classes": 1000, "dtype": "bfloat16", "seed": 0}
ZOO_MLP = {"in_features": 4, "hidden": [64, 64], "num_classes": 3, "dtype": "bfloat16",
           "seed": 0}
ZOO_WINDOW_S = 2.5
ZOO_DEVICE = "cuda"
ZOO_RESNET_BATCH, ZOO_BERT_BATCH, ZOO_BERT_SEQ = 32, 16, 128
ZOO_RESNET_ANN = {"seldon.io/microbatch": "true", "seldon.io/microbatch-max-batch": "128",
                  "seldon.io/microbatch-timeout-ms": "600", "seldon.io/max-inflight": "4"}
ZOO_BERT_ANN = {"seldon.io/microbatch": "true", "seldon.io/microbatch-max-batch": "256",
                "seldon.io/microbatch-timeout-ms": "25"}
# float32 with TF32 off, relative to the largest |logit|: micro-batched
# rows against the same rows alone (another batch size may take another
# cuDNN/cuBLAS algorithm: summation order only), and the card against
# the CPU (another library's summation order, over up to 16 blocks;
# port vs JAX on the CPU agree to 2e-6)
ZOO_F32_TOL = 1e-4
ZOO_ROUTER_REQUESTS = 120
ZOO_REWARD_P = (0.2, 0.8)


class _exact_f32:
    """float32 as float32 on the card: TF32 off for cuBLAS matmuls and
    cuDNN convolutions inside the block, restored after."""

    def __enter__(self):
        import torch

        self._saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self._saved


def _zoo_dir(root, family, config, tag=""):
    d = os.path.join(root, f"{family}{tag}")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "jax_config.json"), "w") as f:
        json.dump({"family": family, "config": config}, f)
    return d


def _zoo_unit(name, model_dir):
    return {"name": name, "implementation": "JAX_SERVER", "modelUri": model_dir,
            "parameters": [{"name": "device", "value": ZOO_DEVICE, "type": "STRING"}]}


def _zoo_engine(graph, annotations=None, registry=None, mesh=None):
    from seldon_core_tpu_torch.graph.engine_metrics import MetricsRegistry
    from seldon_core_tpu_torch.graph.service import EngineApp
    from seldon_core_tpu_torch.graph.spec import (
        PredictorSpec,
        default_predictor,
        validate_predictor,
    )

    spec = default_predictor(PredictorSpec.from_dict(
        {"name": "zoo", "graph": graph, "annotations": annotations or {}}))
    validate_predictor(spec)
    return EngineApp(spec, registry=registry, metrics=MetricsRegistry(), mesh=mesh)


def _zoo_serve(apps, grpc_app=None):
    """Serve each app's REST front (and ``grpc_app``'s gRPC front) on free
    ports: ``(ports, grpc_port, stop)``; stopping closes the executors."""
    ports = [_free_port() for _ in apps]
    gport = _free_port() if grpc_app is not None else None

    async def start():
        fronts = [app.rest_app() for app in apps]
        for front, p in zip(fronts, ports):
            await front.start("127.0.0.1", p)
        gsrv = None
        if grpc_app is not None:
            gsrv = grpc_app.grpc_server()
            gsrv.add_insecure_port(f"127.0.0.1:{gport}")
            await gsrv.start()

        async def close():
            for front in fronts:
                front.close()
            if gsrv is not None:
                await gsrv.stop(grace=0.5)
            for app in apps:
                await app.executor.close()
        return close

    return ports, gport, serve_in_thread(start)


def _synthetic_images(n, size, seed=0):
    """Photo-like uint8 images: low-frequency sines plus mild noise, as the
    JAX package's benchmark builds them (modelbench.py _synthetic_images)."""
    import numpy as np

    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:size, 0:size]
    imgs = []
    for _ in range(n):
        chans = []
        for _c in range(3):
            fx, fy = rs.uniform(0.5, 3.0, 2)
            ph = rs.uniform(0, 2 * np.pi)
            chans.append(127.0 + 100.0 * np.sin(2 * np.pi * fx * x / size + ph)
                         * np.cos(2 * np.pi * fy * y / size))
        imgs.append(np.stack(chans, -1) + rs.normal(0, 6.0, (size, size, 3)))
    return np.asarray(np.clip(imgs, 0, 255), dtype=np.uint8)


def _bert_tokens(rows, seed=0):
    import numpy as np

    return np.random.RandomState(seed).randint(
        1, ZOO_BERT["vocab_size"], (rows, ZOO_BERT_SEQ)).astype(np.int32)


def _raw_message(arr) -> bytes:
    from seldon_core_tpu_torch.payload import array_to_raw, pb

    return pb.SeldonMessage(data=pb.DefaultData(raw=array_to_raw(arr))).SerializeToString()


def _message_rows(msg, rows, classes, what):
    """The logits of a SeldonMessage response, checked finite [rows, classes]."""
    import numpy as np

    from seldon_core_tpu_torch.payload import proto_data_to_array

    out = np.asarray(proto_data_to_array(msg.data), dtype=np.float32)
    if out.shape != (rows, classes) or not np.isfinite(out).all():
        raise AssertionError(f"[zoo] {what}: response {out.shape}, finite "
                             f"{bool(np.isfinite(out).all())}; want ({rows}, {classes})")
    return out


def _rest_proto_call(port, body, rows, classes, what):
    """A keep-alive REST caller posting a binary SeldonMessage to the
    engine: ``(call, close)``; ``call()`` returns None on a 429, else the
    checked logits."""
    from seldon_core_tpu_torch.payload import pb

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    headers = {"Content-Type": "application/x-protobuf"}

    def call():
        conn.request("POST", "/api/v0.1/predictions", body, headers)
        resp = conn.getresponse()
        raw = resp.read()
        if resp.status == 429:
            return None
        if resp.status != 200:
            raise AssertionError(f"[zoo] {what}: HTTP {resp.status} {raw[:300]!r}")
        return _message_rows(pb.SeldonMessage.FromString(raw), rows, classes, what)

    return call, conn.close


def _grpc_call(port, body, rows, classes, what):
    """``_rest_proto_call`` over gRPC ``Seldon/Predict`` (RESOURCE_EXHAUSTED
    is the 429)."""
    import grpc

    from seldon_core_tpu_torch.payload import pb

    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    rpc = channel.unary_unary("/seldontpu.Seldon/Predict",
                              request_serializer=lambda b: b,
                              response_deserializer=pb.SeldonMessage.FromString)

    def call():
        try:
            out = rpc(body, timeout=600)
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.RESOURCE_EXHAUSTED:
                return None
            raise AssertionError(f"[zoo] {what}: gRPC {e.code().name} {e.details()}") from None
        return _message_rows(out, rows, classes, what)

    return call, channel.close


def _closed_loop(make_call, seconds, concurrency, backoff_s=0.02):
    """``concurrency`` threads, each calling its own ``call()`` back to back
    for ``seconds``; a 429 (``call()`` returns None) backs off
    ``backoff_s`` and is not timed.
    Returns (latencies of the answered calls, 429s, wall seconds)."""
    lat, errors, rejects = [], [], [0]
    lock = threading.Lock()
    stop_at = time.perf_counter() + seconds

    def worker():
        call, close = make_call()
        try:
            while time.perf_counter() < stop_at:
                t = time.perf_counter()
                answered = call() is not None
                dt = time.perf_counter() - t
                with lock:
                    if answered:
                        lat.append(dt)
                    else:
                        rejects[0] += 1
                if not answered:
                    time.sleep(backoff_s)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            with lock:
                errors.append(e)
        finally:
            close()

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(concurrency)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(seconds + 600)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads):
        raise AssertionError("[zoo] a closed-loop worker did not finish")
    return lat, rejects[0], wall


def _warm_buckets(server, batch, max_batch, shape, dtype):
    """Run every batch shape the micro-batcher can hand the forward (the
    JAX benchmark's _warm_buckets): ``batch`` (a singleton flush), the
    power-of-two buckets of k * batch below ``max_batch``, and the first
    multiple of ``batch`` at or past ``max_batch`` (an oversize flush)."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.graph.batching import _bucket

    sizes, rows = {batch}, batch
    while rows < max_batch:
        sizes.add(_bucket(rows, max_batch))
        rows += batch
    sizes.add(rows)
    for b in sorted(sizes):
        server.predict(np.zeros((b, *shape), dtype=dtype), [])
    torch.cuda.synchronize()
    return sorted(sizes)


def _forward_ms(server, x):
    """Device time of one forward on the device tensor ``x`` (CUDA events
    around 5 back-to-back forwards after 2 warm ones)."""
    import torch

    with torch.no_grad():
        return time_ms(lambda: server._apply(server.params, x), iters=5, warmup=2)


def _zoo_window(card, tag, app, server, make_call, concurrency, batch, max_batch,
                flops_per_row, shape, dtype):
    """One closed-loop window through ``app`` (its MODEL unit micro-batched
    over ``server``): counters reset just before, read just after; prints
    the end-to-end, micro-batch and device numbers."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.graph.engine_metrics import (
        MICROBATCH_FLUSHES,
        MICROBATCH_PADDED_ROWS,
        MICROBATCH_ROWS,
    )

    mb = app.executor.root.client
    m = app.metrics
    c0 = [m.counter_total(s) for s in (MICROBATCH_FLUSHES, MICROBATCH_ROWS,
                                       MICROBATCH_PADDED_ROWS)]
    h2d0, puts0 = mb.h2d_seconds, mb.h2d_puts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat, rejects, wall = _closed_loop(make_call, ZOO_WINDOW_S, concurrency)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    flushes, rows, padded = (m.counter_total(s) - c for s, c in zip(
        (MICROBATCH_FLUSHES, MICROBATCH_ROWS, MICROBATCH_PADDED_ROWS), c0))
    if not lat or flushes <= 0:
        raise AssertionError(f"[zoo] {tag}: {len(lat)} answered, {flushes} flushes")
    if mb.prefetch_failures:
        raise AssertionError(f"[zoo] {tag}: {mb.prefetch_failures} device puts failed "
                             "(host fuse fallback)")
    if mb.h2d_puts - puts0 != rows / batch:
        raise AssertionError(f"[zoo] {tag}: {mb.h2d_puts - puts0} device puts for "
                             f"{rows / batch:.0f} requests fused")
    rows_s = len(lat) * batch / wall
    mfu = rows_s * flops_per_row / PEAK_FLOPS["bfloat16"]
    log(f"[zoo] {tag}: {rows_s:.1f} rows/s, {len(lat) / wall:.2f} req/s, p50 "
        f"{_pctl(lat, 50) * 1e3:.1f} ms, p99 {_pctl(lat, 99) * 1e3:.1f} ms over {wall:.1f} s "
        f"at concurrency {concurrency} ({len(lat)} answered, {rejects} 429s) [{card}]")
    log(f"[zoo] {tag}: flushes {flushes:.0f}, rows per flush {rows / flushes:.1f}, padded "
        f"rows {padded:.0f}, H2D {(mb.h2d_seconds - h2d0) * 1e3 / flushes:.2f} ms per flush "
        f"(host wall time of the device puts, default stream), device-put fallbacks "
        f"{mb.prefetch_failures}; peak {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated); MFU {100 * mfu:.2f}% of 989 TFLOP/s bf16 "
        f"({flops_per_row / 1e9:.2f} GFLOP per row) [{card}]")
    x = server._to_dev(np.zeros((max_batch, *shape), dtype=dtype))
    ms = _forward_ms(server, x)
    log(f"[zoo] {tag}: one bf16 forward at batch {max_batch}: {ms:.2f} ms device time "
        f"(CUDA events), {max_batch * 1e3 / ms:.0f} rows/s, MFU "
        f"{100 * max_batch * flops_per_row / (ms * 1e-3) / PEAK_FLOPS['bfloat16']:.2f}% "
        f"[{card}]")
    return {"rows_s": rows_s, "p50_ms": _pctl(lat, 50) * 1e3, "p99_ms": _pctl(lat, 99) * 1e3,
            "rows_per_flush": rows / flushes, "forward_ms": ms}


def _bf16_alone(tag, server, unit, make_call, bodies, arrays):
    """The bf16 numbers the gate does not hold: four distinct requests sent
    together to the micro-batched engine against each alone through an
    engine without batching over the same server; the largest |Δlogit|
    and the top-1 agreement."""
    import numpy as np

    got = [None] * len(bodies)

    def one(i):
        call, close = make_call(bodies[i])
        try:
            got[i] = call()
        finally:
            close()

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    if any(g is None for g in got):
        raise AssertionError(f"[zoo] {tag}: a concurrent request did not answer")
    alone_app = _zoo_engine(unit, registry={unit["name"]: server})
    try:
        alone = [_inproc_rows(alone_app, a) for a in arrays]
    finally:
        asyncio.run(alone_app.executor.close())
    fused = got
    diff = max(float(np.abs(f - a).max()) for f, a in zip(fused, alone))
    top1 = float(np.mean([(f.argmax(-1) == a.argmax(-1)).mean() for f, a in zip(fused, alone)]))
    log(f"[zoo] {tag}: bf16 micro-batched vs alone, 4 requests: max |dlogit| {diff:.4e}, "
        f"top-1 agreement {top1:.3f} (reported, not gated)")


def _inproc_rows(app, arr):
    """One request through ``app`` in this thread's own event loop: the
    logits of its raw response."""
    import numpy as np

    from seldon_core_tpu_torch.payload import array_to_json_data, json_data_to_array

    out = asyncio.run(app.predict({"data": array_to_json_data(arr, [], "raw")}))
    return np.asarray(json_data_to_array(out["data"]), dtype=np.float32)


def _zoo_f32_gates(card, root):
    """float32, TF32 off: (1) for ResNet-50 and BERT-base, the rows of 4
    distinct requests served micro-batched equal the same requests served
    alone with micro-batching off; (2) for all four families at full
    width, the port on CUDA equals the port on the CPU on the same params,
    2 rows each."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch import models as model_zoo
    from seldon_core_tpu_torch.servers.torchserver import TorchServer
    from seldon_core_tpu_torch.user_model import _tree_to

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    cases = {
        "resnet50": (ZOO_RESNET, lambda n, s: _synthetic_images(
            n, ZOO_RESNET["image_size"], seed=s)),
        "bert": (ZOO_BERT, lambda n, s: _bert_tokens(n, seed=s)),
        "vit": (ZOO_VIT, lambda n, s: _synthetic_images(n, ZOO_VIT["image_size"], seed=s)),
        "mlp": (ZOO_MLP, lambda n, s: np.random.RandomState(s).uniform(
            0, 8, (n, 4)).astype(np.float32)),
    }
    with _exact_f32():
        for family, (config, inputs) in cases.items():
            config = dict(config, dtype="float32")
            server = TorchServer(model_uri=_zoo_dir(root, family, config, "-f32"),
                                 device=ZOO_DEVICE)
            server.load()
            if family in ("resnet50", "bert"):
                unit = _zoo_unit(family, server.model_uri)
                arrays = [inputs(2, 10 + i) for i in range(4)]
                mb_app = _zoo_engine(unit, {
                    "seldon.io/microbatch": "true", "seldon.io/microbatch-max-batch": "16",
                    "seldon.io/microbatch-timeout-ms": "500"}, registry={family: server})
                alone_app = _zoo_engine(unit, registry={family: server})

                async def fire(app=mb_app, arrays=arrays):
                    from seldon_core_tpu_torch.payload import array_to_json_data

                    return await asyncio.gather(*(app.predict(
                        {"data": array_to_json_data(a, [], "raw")}) for a in arrays))

                from seldon_core_tpu_torch.payload import json_data_to_array

                try:
                    fused = [np.asarray(json_data_to_array(o["data"]), np.float32)
                             for o in asyncio.run(fire())]
                    flushes = mb_app.metrics.counter_total("seldon_engine_microbatch_flushes")
                    alone = [_inproc_rows(alone_app, a) for a in arrays]
                finally:
                    for app in (mb_app, alone_app):
                        asyncio.run(app.executor.close())
                err = max(rel(f, a) for f, a in zip(fused, alone))
                log(f"[zoo] f32 {family}: 4 requests x 2 rows micro-batched ({flushes:.0f} "
                    f"flush) vs alone: max relative |dlogit| {err:.3e} (tol {ZOO_F32_TOL})")
                if flushes != 1 or err > ZOO_F32_TOL:
                    raise AssertionError(f"[zoo] f32 {family}: micro-batched rows differ "
                                         "from alone (or did not fuse)")
            x = inputs(2, 20)
            cpu_model = model_zoo.build(family, **config)
            cpu_params = _tree_to(server.params, "cpu")
            with torch.no_grad():
                want = cpu_model.apply(cpu_params, server._to_dev(x).cpu()).float().numpy()
                got = server.predict(x, []).float().cpu().numpy()
            err = rel(got, want)
            top1 = float((got.argmax(-1) == want.argmax(-1)).mean())
            log(f"[zoo] f32 {family}: card vs CPU on the same params, 2 rows: max relative "
                f"|dout| {err:.3e} (tol {ZOO_F32_TOL}), top-1 agreement {top1:.2f}")
            if err > ZOO_F32_TOL:
                raise AssertionError(f"[zoo] f32 {family}: the card differs from the CPU")
            del server, cpu_params
            gc.collect()
            torch.cuda.empty_cache()


def _zoo_micro(card, root):
    """(c) ViT-B/16 and the iris MLP through the REST microservice with
    TorchServer: a few requests each; every MLP row sums to 1."""
    import base64

    import numpy as np

    from seldon_core_tpu_torch import microservice

    users = []
    for family, config in (("vit", ZOO_VIT), ("mlp", ZOO_MLP)):
        t0 = time.perf_counter()
        user = microservice.build_user_object(
            "seldon_core_tpu_torch.servers.torchserver.TorchServer", json.dumps([
                {"name": "model_uri", "value": _zoo_dir(root, family, config),
                 "type": "STRING"},
                {"name": "device", "value": ZOO_DEVICE, "type": "STRING"}]))
        user.load()
        log(f"[zoo] {family}: TorchServer loaded and warmed in {time.perf_counter() - t0:.1f} s")
        users.append(user)
    ports, stop = _serve_micro(users)
    try:
        lat, classes = [], ZOO_VIT["num_classes"]
        for i in range(4):
            imgs = _synthetic_images(2, ZOO_VIT["image_size"], seed=30 + i)
            body = {"data": {"raw": {"dtype": "uint8", "shape": list(imgs.shape),
                                     "data": base64.b64encode(imgs.tobytes()).decode()}}}
            t = time.perf_counter()
            status, out = _post(ports[0], body)
            lat.append(time.perf_counter() - t)
            from seldon_core_tpu_torch.payload import json_data_to_array

            logits = np.asarray(json_data_to_array(out["data"]), np.float32) \
                if status == 200 else None
            if logits is None or logits.shape != (2, classes) or not np.isfinite(logits).all():
                raise AssertionError(f"[zoo] vit: HTTP {status}, {out if status != 200 else ''}")
        log(f"[zoo] vit: 4 REST requests of 2 raw uint8 images: 200, logits [2, {classes}] "
            "finite, "
            f"client ms {[round(x * 1e3, 1) for x in lat]} [{card}]")
        rs = np.random.RandomState(7)
        lat, sums = [], []
        for n in (1, 3, 8):
            rows = rs.uniform(0.1, 7.9, (n, 4)).round(1).tolist()
            t = time.perf_counter()
            status, out = _post(ports[1], {"data": {"ndarray": rows}})
            lat.append(time.perf_counter() - t)
            probs = np.asarray(out["data"]["ndarray"]) if status == 200 else None
            if probs is None or probs.shape != (n, 3) or \
                    not np.allclose(probs.sum(-1), 1.0, atol=1e-5):
                raise AssertionError(f"[zoo] mlp: HTTP {status}, {out}")
            sums.extend(probs.sum(-1).tolist())
        log(f"[zoo] mlp: 3 REST ndarray requests (1, 3, 8 rows): 200, every row sums to 1 "
            f"(max |sum - 1| {max(abs(s - 1) for s in sums):.2e}), client ms "
            f"{[round(x * 1e3, 1) for x in lat]} [{card}]")
    finally:
        stop()


def _serve_micro(users):
    """Each user object behind its own REST microservice on a free port:
    ``(ports, stop)``."""
    from seldon_core_tpu_torch import wrapper

    apps = [wrapper.get_rest_microservice(u) for u in users]
    ports = [_free_port() for _ in apps]

    async def start():
        for app, p in zip(apps, ports):
            await app.start("127.0.0.1", p)

        async def close():
            for app in apps:
                app.close()
        return close

    stop = serve_in_thread(start)

    def stop_all():
        stop()
        for app in apps:
            app._hook_pool.shutdown(wait=False)
    return ports, stop_all


def _zoo_routers(card, root):
    """(d) EpsilonGreedy (epsilon 0.1, seed 7), then ThompsonSampling
    (seed 7), routing over two ResNet-50 TorchServers (seeds 0 and 1) in
    one engine graph: 200 single-image requests over REST, each answered
    by a Bernoulli reward (numpy seed 1; p 0.2 on branch 0, 0.8 on branch
    1) posted to /api/v0.1/feedback. The router converges to branch 1 and
    routes exactly as the same router driven directly; its state is
    persisted, the engine rebuilt around the restored router, and the
    state comes back equal."""
    import base64

    import numpy as np

    from seldon_core_tpu_torch import persistence
    from seldon_core_tpu_torch.components import EpsilonGreedy, ThompsonSampling

    dirs = [_zoo_dir(root, "resnet50", dict(ZOO_RESNET, seed=s), f"-seed{s}") for s in (0, 1)]
    graph = {"name": "router", "type": "ROUTER",
             "children": [_zoo_unit(f"resnet_{s}", d) for s, d in enumerate(dirs)]}
    img = _synthetic_images(1, ZOO_RESNET["image_size"], seed=40)
    request = {"data": {"raw": {"dtype": "uint8", "shape": list(img.shape),
                                "data": base64.b64encode(img.tobytes()).decode()}}}
    servers = None
    for cls, kw in ((EpsilonGreedy, {"epsilon": 0.1}), (ThompsonSampling, {})):
        name = cls.__name__
        params = dict(n_branches=2, seed=7, **kw)
        router = cls(**params)
        registry = {"router": router, **(servers or {})}
        app = _zoo_engine(graph, registry=registry)
        servers = {c.name: c.client.user_object for c in app.executor.root.children}
        (port,), _g, stop = _zoo_serve([app])
        rng = np.random.RandomState(1)
        branches, lat = [], []
        t0 = time.perf_counter()
        try:
            for _ in range(ZOO_ROUTER_REQUESTS):
                t = time.perf_counter()
                status, out = _post(port, request, path="/api/v0.1/predictions")
                lat.append(time.perf_counter() - t)
                if status != 200:
                    raise AssertionError(f"[zoo] {name}: predict HTTP {status} {out}")
                branch = out["meta"]["routing"]["router"]
                branches.append(branch)
                reward = float(rng.random_sample() < ZOO_REWARD_P[branch])
                status, fb = _post(port, {"request": request, "response": out,
                                          "reward": reward}, path="/api/v0.1/feedback")
                if status != 200:
                    raise AssertionError(f"[zoo] {name}: feedback HTTP {status} {fb}")
        finally:
            stop()
        wall = time.perf_counter() - t0
        # the same router driven directly with the same rewards routes alike
        ref, rng, want = cls(**params), np.random.RandomState(1), []
        for _ in range(ZOO_ROUTER_REQUESTS):
            b = ref.route(img, [])
            want.append(b)
            ref.send_feedback(img, [], float(rng.random_sample() < ZOO_REWARD_P[b]), None,
                              routing=b)
        st = router.state
        log(f"[zoo] {name}: {ZOO_ROUTER_REQUESTS} requests + feedback in {wall:.1f} s "
            f"(predict p50 {_pctl(lat, 50) * 1e3:.1f} ms), tries {st.tries.tolist()}, "
            f"success {st.success.tolist()}, best_branch {st.best_branch}; routing == the "
            f"router driven directly: {branches == want} [{card}]")
        if st.best_branch != 1 or st.tries.sum() != ZOO_ROUTER_REQUESTS \
                or st.tries[1] <= st.tries[0] or branches != want:
            raise AssertionError(f"[zoo] {name}: did not converge to branch 1 as driven directly")
        with tempfile.TemporaryDirectory(prefix="chip-smoke-router-") as store:
            key = persistence.state_key("router", "zoo", "smoke")
            path = persistence.persist(router, store, key)
            restored = persistence.restore(cls, params, store, key)
            app2 = _zoo_engine(graph, registry={"router": restored, **servers})
            (port2,), _g, stop2 = _zoo_serve([app2])
            try:
                status, out = _post(port2, request, path="/api/v0.1/predictions")
            finally:
                stop2()
        rs = restored.state
        same = (np.array_equal(rs.success, st.success) and np.array_equal(rs.tries, st.tries)
                and rs.best_branch == st.best_branch)
        log(f"[zoo] {name}: persisted to {os.path.basename(path)}, engine rebuilt around the "
            f"restored router: success/tries/best_branch equal {same}; a request after "
            f"the rebuild HTTP {status}")
        if not same or status != 200:
            raise AssertionError(f"[zoo] {name}: state not restored")


def phase_zoo(card):
    """The predict path's model zoo at full width (random weights from seed
    0): (a) ResNet-50 bf16 through the engine over REST (binary
    SeldonMessage, raw uint8 [32, 224, 224, 3]; micro-batching max-batch
    128, timeout 600 ms; max-inflight 4; concurrency 16 for 2.5 s, a 429
    backs off); (b) BERT-base bf16 through the engine over gRPC
    Seldon/Predict (REST binary protobuf without grpcio; raw int32 [16,
    128]; max-batch 256, timeout 25 ms; concurrency 64 for 2.5 s); the f32
    gates (micro-batched == alone, card == CPU); (c) ViT-B/16 and the
    iris MLP through the REST microservice; (d) the bandit routers.
    Returns the flash kernel's launches over the phase (no zoo model
    runs it)."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.ops import flash_attention as fa

    torch.cuda.synchronize()
    fa.LAUNCHES["flash_attention"] = 0
    grpc_ok = _grpc_available()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-zoo-") as root:
        # (a) ResNet-50 over REST
        t0 = time.perf_counter()
        unit = _zoo_unit("resnet", _zoo_dir(root, "resnet50", ZOO_RESNET))
        app = _zoo_engine(unit, ZOO_RESNET_ANN)
        server = app.executor.root.client.inner.user_object
        if server.device.type != torch.device(ZOO_DEVICE).type:
            raise AssertionError(f"[zoo] resnet50 on {server.device}")
        size, classes = ZOO_RESNET["image_size"], ZOO_RESNET["num_classes"]
        shape = (size, size, 3)
        sizes = _warm_buckets(server, ZOO_RESNET_BATCH, 128, shape, np.uint8)
        log(f"[zoo] resnet50 (bf16, {classes} classes, {size}x{size}) loaded and warmed at "
            f"batch {sizes} in {time.perf_counter() - t0:.1f} s")
        imgs = _synthetic_images(ZOO_RESNET_BATCH, size)
        body = _raw_message(imgs)
        (port,), _g, stop = _zoo_serve([app])
        try:
            _zoo_window(card, "resnet50 REST raw", app, server,
                        lambda: _rest_proto_call(port, body, ZOO_RESNET_BATCH, classes,
                                                 "resnet50"),
                        16, ZOO_RESNET_BATCH, 128, server._model.flops_per_row(), shape,
                        np.uint8)
            arrays = [_synthetic_images(2, size, seed=50 + i) for i in range(4)]
            _bf16_alone("resnet50", server, unit,
                        lambda b: _rest_proto_call(port, b, 2, classes, "resnet50"),
                        [_raw_message(a) for a in arrays], arrays)
        finally:
            stop()
        del app, server
        gc.collect()
        torch.cuda.empty_cache()

        # (b) BERT-base over gRPC (REST binary protobuf without grpcio)
        t0 = time.perf_counter()
        unit = _zoo_unit("bert", _zoo_dir(root, "bert", ZOO_BERT))
        app = _zoo_engine(unit, ZOO_BERT_ANN)
        server = app.executor.root.client.inner.user_object
        sizes = _warm_buckets(server, ZOO_BERT_BATCH, 256, (ZOO_BERT_SEQ,), np.int32)
        log(f"[zoo] bert (bf16, BERT-base, 2 classes) loaded and warmed at batch {sizes} "
            f"in {time.perf_counter() - t0:.1f} s")
        body = _raw_message(_bert_tokens(ZOO_BERT_BATCH))
        (port,), gport, stop = _zoo_serve([app], app if grpc_ok else None)
        transport = "gRPC Seldon/Predict" if grpc_ok else "REST binary protobuf"
        log(f"[zoo] bert: driven over {transport}" + (
            "" if grpc_ok else " (import grpc, google.protobuf failed on this machine)"))

        def caller(b, rows):
            if grpc_ok:
                return _grpc_call(gport, b, rows, ZOO_BERT["num_classes"], "bert")
            return _rest_proto_call(port, b, rows, ZOO_BERT["num_classes"], "bert")

        try:
            _zoo_window(card, f"bert {transport} raw int32", app, server,
                        lambda: caller(body, ZOO_BERT_BATCH), 64, ZOO_BERT_BATCH, 256,
                        server._model.flops_per_row(ZOO_BERT_SEQ), (ZOO_BERT_SEQ,), np.int32)
            arrays = [_bert_tokens(2, seed=50 + i) for i in range(4)]
            _bf16_alone("bert", server, unit, lambda b: caller(b, 2),
                        [_raw_message(a) for a in arrays], arrays)
        finally:
            stop()
        del app, server
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        _zoo_f32_gates(card, root)
        log(f"[zoo] f32 gates in {time.perf_counter() - t0:.1f} s")
        _zoo_micro(card, root)
        _zoo_routers(card, root)
    torch.cuda.synchronize()
    launches = fa.LAUNCHES["flash_attention"]
    log(f"[zoo] flash kernel launches over the phase: {launches} (no zoo model runs it)")
    return launches


# llm-rag-chip (seldon_core_tpu/modelbench.py, "llm-rag-chip"): a BERT-base
# embedder, a 256-document corpus and an llm-1.26b generate tail
RAG_BERT = {"vocab_size": 32000, "d_model": 768, "n_layers": 12, "n_heads": 12,
            "d_ff": 3072, "max_seq": 128, "num_classes": 256, "dtype": "bfloat16", "seed": 0}
RAG_RET = {"corpus_size": 256, "d_embed": 256, "top_k": 8, "doc_len": 64,
           "vocab_size": 32000, "seed": 7, "hidden": [32], "dtype": "bfloat16"}
RAG_LLM = dict(LLM_1_26B, max_seq=256)
RAG_GEN = {"slots": 4, "steps_per_poll": 8, "warmup_prompt_lens": [64],
           "warmup_max_new_tokens": 32}
RAG_REQUESTS, RAG_QUERY_LEN, RAG_MAX_NEW = 24, 64, 32
RAG_STAGES = ("embed", "retrieve", "rerank")
RAG_GRAPH = {
    "name": "embed", "type": "MODEL", "children": [{
        "name": "retrieve", "type": "MODEL", "children": [{
            "name": "rerank", "type": "MODEL", "children": [{
                "name": "prompt", "implementation": "RAG_PROMPT_BUILDER",
                "children": [{"name": "generate", "type": "MODEL"}],
            }],
        }],
    }],
}
# the small RAG configuration of tests/test_torch_fusion.py, at float32
RAG_SMALL = {
    "bert": {"vocab_size": 256, "d_model": 32, "n_layers": 2, "n_heads": 2, "d_ff": 64,
             "max_seq": 32, "num_classes": 16, "dtype": "float32"},
    "retrieval": {"corpus_size": 64, "d_embed": 16, "top_k": 4, "doc_len": 6,
                  "vocab_size": 256, "seed": 7, "dtype": "float32"},
    "llm": {"vocab_size": 256, "d_model": 32, "n_layers": 2, "n_heads": 2, "n_kv_heads": 2,
            "d_ff": 64, "max_seq": 32, "dtype": "float32"},
}
RAG_DEVICE = "cuda"
RAG_F32_TOL = 1e-5     # embed output, card vs CPU, of its largest |value|
RAG_NORMAL_ULPS = 4    # rng.normal, card vs CPU (tests/test_torch_retrieval.py)
RAG_DETECTOR_RTOL = 1e-5


def _rag_units(root, device, configs, gen, max_new, checkpoints=None):
    """The five units of the RAG graph on ``device``: TorchServers over
    ``configs`` (family -> config; ``checkpoints`` family -> params
    written as the unit's npz), a RAG_PROMPT_BUILDER asking ``max_new``
    tokens and a GenerateServer (``gen`` its keyword arguments), each
    loaded."""
    from seldon_core_tpu_torch.convert import save_npz
    from seldon_core_tpu_torch.graph.units import RagPromptBuilder
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer
    from seldon_core_tpu_torch.servers.torchserver import TorchServer

    checkpoints = checkpoints or {}
    dirs = {}
    for family in ("bert", "retrieval", "reranker", "llm"):
        config = configs["retrieval" if family == "reranker" else family]
        d = os.path.join(root, f"{family}-{device}")
        os.makedirs(d, exist_ok=True)
        meta = {"family": family, "config": config}
        if family in checkpoints:
            save_npz(checkpoints[family], os.path.join(d, "params.npz"))
            meta["checkpoint"] = "params.npz"
        with open(os.path.join(d, "jax_config.json"), "w") as f:
            json.dump(meta, f)
        dirs[family] = d
    units = {name: TorchServer(model_uri=dirs[family], device=device)
             for name, family in zip(RAG_STAGES, ("bert", "retrieval", "reranker"))}
    for u in units.values():
        u.load()
    generate = GenerateServer(model_uri=dirs["llm"], device=device, **gen)
    generate.load()
    units.update(prompt=RagPromptBuilder(max_new_tokens=max_new), generate=generate)
    return units


def _rag_executor(units, fuse, metrics=None, faults=None):
    from seldon_core_tpu_torch.graph.executor import GraphExecutor
    from seldon_core_tpu_torch.graph.spec import PredictorSpec, default_predictor

    spec = default_predictor(PredictorSpec.from_dict({
        "name": "rag", "graph": json.loads(json.dumps(RAG_GRAPH)),
        **({"annotations": {"seldon.io/fuse": "true"}} if fuse else {})}))
    return GraphExecutor(spec, registry=units, metrics=metrics, faults=faults)


def _rag_scrub(out):
    """A response as data: no puid, no TIMER metrics (wall time)."""
    out = json.loads(json.dumps(out))
    meta = out.get("meta", {})
    meta.pop("puid", None)
    if "metrics" in meta:
        meta["metrics"] = [m for m in meta["metrics"] if m.get("type") != "TIMER"]
    return out


def _rag_f32_gates(root):
    """(b) The small RAG configuration at float32, TF32 off, on the card
    and on the CPU over the same weights: the embed output within 1e-5 of
    its largest |value|, the retrieval indices, the reranker's doc rows
    and the graph's greedy tokens equal; the corpus drawn by rng on the
    card equal to the CPU's (doc rows exactly, embeddings within 4
    ulps)."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch import models as model_zoo
    from seldon_core_tpu_torch.models.retrieval import corpus_params

    ret = RAG_SMALL["retrieval"]
    args = (ret["seed"], ret["corpus_size"], ret["d_embed"], ret["doc_len"], ret["vocab_size"])
    emb_c, docs_c = corpus_params(*args, device=RAG_DEVICE)
    emb_h, docs_h = corpus_params(*args, device="cpu")
    a, b = emb_c.cpu().numpy(), emb_h.numpy()
    ulps = int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())
    docs_equal = torch.equal(docs_c.cpu(), docs_h)
    log(f"[rag] (b) rng corpus on the card vs the CPU: doc rows equal {docs_equal}, "
        f"embeddings max {ulps} ulps (tol {RAG_NORMAL_ULPS})")
    if not docs_equal or ulps > RAG_NORMAL_ULPS:
        raise AssertionError("[rag] the card's rng corpus differs from the CPU's")
    checkpoints = {}
    for family in ("bert", "retrieval", "reranker", "llm"):
        config = RAG_SMALL["retrieval" if family == "reranker" else family]
        checkpoints[family] = model_zoo.build(family, **config).init_params(0, device="cpu")
    with _exact_f32():
        gen = {"slots": 2, "steps_per_poll": 2, "warmup_prompt_lens": [ret["doc_len"]],
               "warmup_max_new_tokens": 8}
        sides = {dev: _rag_units(root, dev, RAG_SMALL, gen, 8, checkpoints)
                 for dev in (RAG_DEVICE, "cpu")}
        try:
            rs = np.random.RandomState(3)
            queries = rs.randint(1, 256, (4, 8))
            chain = {}
            for dev, units in sides.items():
                e = units["embed"].predict(queries, [])
                r = units["retrieve"].predict(e.float().cpu().numpy(), [])
                d = units["rerank"].predict(r.float().cpu().numpy(), [])
                chain[dev] = (e.float().cpu().numpy(), r.float().cpu().numpy(), d.cpu().numpy())
            (ec, rc, dc), (eh, rh, dh) = chain[RAG_DEVICE], chain["cpu"]
            err = float(np.abs(ec - eh).max() / np.abs(eh).max())
            k = ret["d_embed"]
            idx_equal = bool((rc[:, k:] == rh[:, k:]).all())
            docs_equal = bool((dc == dh).all())
            tokens = {}
            for dev, units in sides.items():
                ex = _rag_executor(units, fuse=True)
                try:
                    outs = [asyncio.run(ex.predict({"data": {"ndarray": queries[i:i + 2].tolist()}}))
                            for i in (0, 2)]
                finally:
                    asyncio.run(ex.close())
                tokens[dev] = [o["jsonData"]["tokens"] for o in outs]
        finally:
            for units in sides.values():
                units["generate"].close()
    log(f"[rag] (b) f32 card vs CPU, small RAG config: embed max relative |d| {err:.3e} "
        f"(tol {RAG_F32_TOL}), retrieval indices equal {idx_equal}, doc rows equal "
        f"{docs_equal}, greedy tokens equal {tokens[RAG_DEVICE] == tokens['cpu']}")
    if err > RAG_F32_TOL or not idx_equal or not docs_equal or tokens[RAG_DEVICE] != tokens["cpu"]:
        raise AssertionError("[rag] (b) the card differs from the CPU at float32")


def _rag_detectors(root):
    """(c) Mahalanobis, VAE and seq2seq detectors and KS drift as input
    TRANSFORMERs in front of the iris MLP through the engine, on the card
    and (the same parameters) on the CPU: equal flags, scores within 1e-5
    relative, the drift verdict false on unshifted windows and true on
    shifted ones on both."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch import rng
    from seldon_core_tpu_torch.components import KSDrift
    from seldon_core_tpu_torch.components.outlier import (
        Mahalanobis,
        Seq2SeqOutlier,
        VAEOutlier,
        seq2seq_init,
        vae_init,
    )
    from seldon_core_tpu_torch.components.outlier.base import numpy_tree
    from seldon_core_tpu_torch.servers.torchserver import TorchServer

    rs = np.random.RandomState(5)
    ref = rs.normal(3.0, 1.0, (256, 4)).astype(np.float32)
    stats = {"mean": ref.mean(axis=0), "std": ref.std(axis=0) + 1e-8}
    seq_stats = {"mean": ref.mean(axis=(0, 1)), "std": ref.std(axis=(0, 1)) + 1e-8}
    vae_p = numpy_tree(vae_init(rng.prng_key(0, device=RAG_DEVICE), 4, (8,), 2))
    seq_p = numpy_tree(seq2seq_init(rng.prng_key(1, device=RAG_DEVICE), 1, 8))
    mlp_dir = _zoo_dir(root, "mlp", dict(ZOO_MLP, dtype="float32"), "-rag")
    graph = {"name": "vae", "type": "TRANSFORMER", "children": [{
        "name": "seq2seq", "type": "TRANSFORMER", "children": [{
            "name": "maha", "type": "TRANSFORMER", "children": [{
                "name": "drift", "type": "TRANSFORMER", "children": [{
                    "name": "mlp", "type": "MODEL"}]}]}]}]}
    windows = [rs.normal(3.0, 1.0, (16, 4)) for _ in range(3)] + \
        [rs.normal(6.0, 1.0, (16, 4)) for _ in range(3)]
    seen = {}
    for dev in (RAG_DEVICE, "cpu"):
        mlp = TorchServer(model_uri=mlp_dir, device=dev)
        mlp.load()
        dets = {
            "vae": VAEOutlier(threshold=2.0, mc_samples=4, seed=0, device=dev).fit_from(
                vae_p, stats),
            "seq2seq": Seq2SeqOutlier(threshold=1.5, seq_len=4, device=dev).fit_from(
                seq_p, seq_stats),
            "maha": Mahalanobis(threshold=9.0, n_components=2, start_clip=32),
            "drift": KSDrift(reference=ref, window=32, min_window=32),
        }
        app = _zoo_engine(graph, registry={**dets, "mlp": mlp})
        rows = []
        try:
            for w in windows:
                out = asyncio.run(app.predict({"data": {"ndarray": w.tolist()}}))
                probs = np.asarray(out["data"]["ndarray"])
                if probs.shape != (16, 3) or not np.isfinite(probs).all():
                    raise AssertionError(f"[rag] (c) MLP output {probs.shape} on {dev}")
                rows.append({n: (dets[n].prediction_.copy(), dets[n].score_.copy())
                             for n in ("vae", "seq2seq", "maha")}
                            | {"drift": dets["drift"].drifted})
        finally:
            asyncio.run(app.executor.close())
        seen[dev] = rows
    worst = {}
    for n in ("vae", "seq2seq", "maha"):
        pairs = list(zip(seen[RAG_DEVICE], seen["cpu"]))
        flags_equal = all((c[n][0] == h[n][0]).all() for c, h in pairs)
        err = max(float(np.abs(c[n][1] - h[n][1]).max() / max(np.abs(h[n][1]).max(), 1e-30))
                  for c, h in pairs)
        flagged = sum(int(c[n][0].sum()) for c in seen[RAG_DEVICE])
        worst[n] = err
        log(f"[rag] (c) {n}: card vs CPU flags equal {flags_equal}, {flagged}/96 rows "
            f"flagged, max relative |dscore| {err:.3e} (tol {RAG_DETECTOR_RTOL})")
        if not flags_equal or err > RAG_DETECTOR_RTOL:
            raise AssertionError(f"[rag] (c) {n} differs between the card and the CPU")
    drift = [[r["drift"] for r in seen[d]] for d in (RAG_DEVICE, "cpu")]
    log(f"[rag] (c) KS drift per window (3 unshifted, 3 shifted), card {drift[0]}, CPU {drift[1]}")
    if drift[0] != drift[1] or drift[0][2] or not drift[0][-1]:
        raise AssertionError("[rag] (c) the drift verdicts are wrong or differ")
    torch.cuda.synchronize()


def phase_rag(card):
    """llm-rag-chip (BERT-base embedder, a 256-document corpus at d_embed
    256 with top-8 and an MLP reranker, RAG_PROMPT_BUILDER, llm-1.26b at
    max_seq 256 with 4 slots; bf16, random weights from seed 0) on the
    port's GraphExecutor, hop by hop and with ``seldon.io/fuse: "true"``:
    (a) 24 requests of 64 query tokens interleaved hop and fused, byte
    for byte equal, the segment [embed, retrieve, rerank] a prefix
    continuing at the prompt builder with 24 dispatches and no fallback,
    one traced fused request with one ``gen.fused_segment`` span and no
    stage span, then the chaos leg (1 ms of injected latency on rerank:
    counted ``faults`` fallback, output equal); (b) the float32 card ==
    CPU gates; (c) the detectors. Returns the flash kernel's launches
    over (a)."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch import tracing
    from seldon_core_tpu_torch.graph.engine_metrics import MetricsRegistry
    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.resilience import FaultInjector

    with tempfile.TemporaryDirectory(prefix="chip-smoke-rag-") as root:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        units = _rag_units(root, RAG_DEVICE, {"bert": RAG_BERT, "retrieval": RAG_RET,
                                              "llm": RAG_LLM}, RAG_GEN, RAG_MAX_NEW)
        hop_reg, fused_reg, chaos_reg = MetricsRegistry(), MetricsRegistry(), MetricsRegistry()
        ex_hop = _rag_executor(units, fuse=False, metrics=hop_reg)
        ex_fused = _rag_executor(units, fuse=True, metrics=fused_reg)
        seg = ex_fused.fusion.segments.get("embed")
        log(f"[rag] llm-rag-chip loaded (BERT-base, corpus 256 x 256, llm-1.26b max_seq 256) "
            f"and the segment warmed in {time.perf_counter() - t0:.1f} s")
        if seg is None or seg.kind != "prefix" or seg.names != list(RAG_STAGES) \
                or seg.continue_at is None or seg.continue_at.name != "prompt":
            raise AssertionError(f"[rag] wrong fusion plan: {ex_fused.fusion.dump()['segments']}")
        rs = np.random.RandomState(11)
        requests = [{"data": {"ndarray": rs.randint(1, 32000, (1, RAG_QUERY_LEN)).tolist()}}
                    for _ in range(RAG_REQUESTS)]
        loop = asyncio.new_event_loop()

        def call(ex, req):
            t = time.perf_counter()
            out = loop.run_until_complete(ex.predict(json.loads(json.dumps(req))))
            return out, (time.perf_counter() - t) * 1000.0

        torch.cuda.synchronize()
        fa.LAUNCHES["flash_attention"] = 0
        try:
            for ex in (ex_hop, ex_fused):  # thread pools and first calls
                call(ex, requests[0])
            before = seg.dispatches
            lat = {"hop": [], "fused": []}
            outs = {"hop": [], "fused": []}
            for req in requests:
                for name, ex in (("hop", ex_hop), ("fused", ex_fused)):
                    out, ms = call(ex, req)
                    outs[name].append(_rag_scrub(out))
                    lat[name].append(ms)
            identical = outs["hop"] == outs["fused"]
            dispatches = seg.dispatches - before
            empty = sum(1 for o in outs["fused"] if not o["jsonData"]["tokens"][0])
            paths = {tuple(o["meta"]["requestPath"]) for o in outs["fused"]}
            log(f"[rag] (a) {RAG_REQUESTS} requests interleaved: fused == hop byte for byte "
                f"{identical}; fused dispatches {dispatches}, fallbacks {seg.fallbacks}; "
                f"requestPath {sorted(paths)}; empty token lists {empty}")
            if not identical or dispatches != RAG_REQUESTS or seg.fallbacks or empty or \
                    paths != {("embed", "retrieve", "rerank", "prompt", "generate")}:
                raise AssertionError("[rag] (a) fused and hop-by-hop differ, or the segment "
                                     "did not serve every request")
            for name in ("hop", "fused"):
                xs = np.asarray(lat[name])
                log(f"[rag] (a) {name}: client p50 {np.percentile(xs, 50):.2f} ms, p99 "
                    f"{np.percentile(xs, 99):.2f} ms over {RAG_REQUESTS} requests "
                    f"({len(outs[name][0]['jsonData']['tokens'][0])} tokens each, prompt and new)")
            # the span proof: one fused request traced, then one hop request
            tracer = tracing.init_tracer(enabled=True)
            try:
                call(ex_fused, requests[1])
                spans = tracer.finished_spans()
                ops = [s.operation for s in spans]
                seg_spans = [s.duration_us for s in spans if s.operation == "gen.fused_segment"]
                stage_spans = sum(ops.count(f"{u}.predict") for u in RAG_STAGES)
                tracer = tracing.init_tracer(enabled=True)
                call(ex_hop, requests[1])
                hop_us = {s.operation: s.duration_us for s in tracer.finished_spans()
                          if s.operation.split(".")[0] in RAG_STAGES}
            finally:
                tracing.init_tracer(enabled=False)
            log(f"[rag] (a) traced fused request: {len(seg_spans)} gen.fused_segment span "
                f"({seg_spans[0] / 1000.0 if seg_spans else float('nan'):.3f} ms), "
                f"{stage_spans} stage spans; hop request's stage spans "
                + ", ".join(f"{k} {v / 1000.0:.3f} ms" for k, v in sorted(hop_us.items()))
                + f" (sum {sum(hop_us.values()) / 1000.0:.3f} ms)")
            if len(seg_spans) != 1 or stage_spans != 0 or len(hop_us) != 3:
                raise AssertionError("[rag] (a) the fused request is not one span")
            # the chaos leg: faults on rerank keep it per-unit, counted
            faults = FaultInjector([{"unit": "rerank", "latency_ms": 1.0}])
            ex_chaos = _rag_executor(units, fuse=True, metrics=chaos_reg, faults=faults)
            chaos = [_rag_scrub(call(ex_chaos, r)[0]) for r in requests[:4]]
            fallbacks = chaos_reg.counter_total("seldon_engine_fusion_fallbacks",
                                                {"reason": "faults"})
            in_segment = any("rerank" in s.names for s in ex_chaos.fusion.segments.values())
            log(f"[rag] (a) chaos (1 ms on rerank): faults fallbacks {fallbacks:.0f}, "
                f"segments {[s.label for s in ex_chaos.fusion.segments.values()]}, "
                f"4 requests equal to hop {chaos == outs['hop'][:4]}")
            if fallbacks < 1 or in_segment or chaos != outs["hop"][:4]:
                raise AssertionError("[rag] (a) the chaos leg fused rerank or changed the output")
            torch.cuda.synchronize()
            launches = fa.LAUNCHES["flash_attention"]
            # the fused segment and the embed forward alone: CUDA events
            # around eager calls (host launches included), and device time
            # from a CUDA graph of the same calls (launches left out)
            embed = units["embed"]
            x = embed._to_dev(np.asarray(requests[0]["data"]["ndarray"]))

            def embed_fwd():
                with torch.no_grad():
                    return embed._apply(embed.params, x)

            eager = {"segment": time_ms(lambda: seg._run(x), iters=20, warmup=3),
                     "embed": time_ms(embed_fwd, iters=20, warmup=3)}
            dev = {}
            for name, fn in (("segment", lambda: seg._run(x)), ("embed", embed_fwd)):
                try:
                    dev[name] = f"{device_ms(fn):.3f} ms"
                except Exception as e:  # noqa: BLE001 - reported, not gated
                    dev[name] = f"not measured ({type(e).__name__}: {str(e)[:80]})"
            log(f"[rag] (a) fused segment, B=1 T={RAG_QUERY_LEN}: {eager['segment']:.3f} ms per "
                f"eager call (CUDA events), device time {dev['segment']} (CUDA graph of 20); the "
                f"embed forward alone {eager['embed']:.3f} ms eager, device time {dev['embed']}")
            log(f"[rag] (a) peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                f"allocated, {torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved; "
                f"flash launches over (a) {launches} (card {card})")
            if launches <= 0:
                raise AssertionError("[rag] the generate tail launched no flash kernel")
            for ex in (ex_hop, ex_fused, ex_chaos):
                loop.run_until_complete(ex.close())
        finally:
            loop.close()
            units["generate"].close()
            del units
            gc.collect()
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _rag_f32_gates(root)
        _rag_detectors(root)
        log(f"[rag] (b) and (c) in {time.perf_counter() - t0:.1f} s")
    return launches


# /explain (explainer.py): ResNet-50 at full width under IG and saliency,
# ablation and anchors over the port's engine, the detectors' training,
# the host servers
EXPLAIN_RESNET = {"num_classes": 1000, "image_size": 224, "seed": 0}
EXPLAIN_DEVICE = "cuda"
EXPLAIN_STEPS = 32
EXPLAIN_IMAGES = 4     # the bf16 request
EXPLAIN_F32_IMAGES = 2  # the f32 requests, also explained on the CPU
EXPLAIN_BASELINE = 127.5  # the f32 IG request's gray baseline (meta.tags)
# float32 with TF32 off, attributions card vs CPU. The input gradient of
# ResNet-50 at 224 is ill-conditioned in float32: against the same
# forward in float64, the card's and the CPU's float32 saliency are both
# off by 3.5e-3-5.6e-3 in relative L2 (4.6e-2 of the largest element),
# ReLU and max-pool decisions flipping on rounding (measured on an H100
# 80GB HBM3 at 700 W, `PERF.md`). So the float32 gates are: card vs CPU
# relative L2 within EXPLAIN_F32_L2, and the card's error against the
# float64 reference at most 2x the CPU's plus 1e-3. The float64
# forward-backward (every
# convolution in float64, the float32 head) is the tight check of the
# card's gradient path: card vs CPU within EXPLAIN_F64_TOL of the
# largest |attribution| (rounded to float32 they were equal there).
EXPLAIN_F32_L2 = 1e-2
EXPLAIN_F64_TOL = 1e-5
# IG's midpoint rule over 32 steps from the gray baseline: |sum(attr) -
# (f(x) - f(baseline))| within this fraction of |f(x) - f(baseline)|
EXPLAIN_COMPLETENESS = 0.05
EXPLAIN_MLP = dict(ZOO_MLP, dtype="float32")
EXPLAIN_ABLATION_TOL = 1e-6  # float32 probabilities, card vs CPU (ulps)
EXPLAIN_TRAINED_RTOL = 1e-3  # detector scores trained on the card vs the CPU
# half the detectors' default 50 epochs (the smoke's time budget)
EXPLAIN_VAE_EPOCHS, EXPLAIN_SEQ_EPOCHS = 25, 25
# the host servers whose library the card's machine lacks: (implementation,
# the module its load imports first, the error naming it)
EXPLAIN_SERVERS = (("SKLEARN_SERVER", "joblib", "joblib"),
                   ("XGBOOST_SERVER", "xgboost", "xgboost"),
                   ("MLFLOW_SERVER", "mlflow", "mlflow"),
                   ("TENSORFLOW_SERVER", "tensorflow", "tensorflow"),
                   ("SAGEMAKER_SERVER", "boto3", "boto3"))


def _explain_dirs(root):
    """ResNet-50 (seed-0 weights through params.npz: the port's
    ``init_params(0)`` drawn on the CPU) at bf16, f32 and f64 (the f32
    reference), and the iris MLP at f32, each a ``jax_config.json`` +
    ``params.npz`` directory."""
    from seldon_core_tpu_torch import models
    from seldon_core_tpu_torch.convert import save_npz

    dirs = {}
    for tag, family, config in (("bf16", "resnet50", dict(EXPLAIN_RESNET, dtype="bfloat16")),
                                ("f32", "resnet50", dict(EXPLAIN_RESNET, dtype="float32")),
                                ("f64", "resnet50", dict(EXPLAIN_RESNET, dtype="float64")),
                                ("mlp", "mlp", EXPLAIN_MLP)):
        d = os.path.join(root, f"explain-{tag}")
        os.makedirs(d, exist_ok=True)
        src = os.path.join(root, "explain-bf16", "params.npz")
        if tag in ("f32", "f64"):
            os.link(src, os.path.join(d, "params.npz"))
        else:
            model = models.build(family, device="cpu", **config)
            save_npz(model.init_params(config.get("seed", 0), device="cpu"),
                     os.path.join(d, "params.npz"))
        with open(os.path.join(d, "jax_config.json"), "w") as f:
            json.dump({"family": family, "config": config, "checkpoint": "params.npz"}, f)
        dirs[tag] = d
    return dirs


def _explainer_user(model_dir, kind, device):
    from seldon_core_tpu_torch import microservice

    user = microservice.build_user_object(
        "seldon_core_tpu_torch.components.explainer.Explainer", json.dumps([
            {"name": "explainer_type", "value": kind, "type": "STRING"},
            {"name": "model_uri", "value": model_dir, "type": "STRING"},
            {"name": "n_steps", "value": str(EXPLAIN_STEPS), "type": "INT"},
            {"name": "device", "value": device, "type": "STRING"}]))
    user.load()
    return user


def _explain_call(port, x, baseline=None, what="explain"):
    """POST ``x`` (float) to ``/explain``; returns (jsonData, client s)."""
    import numpy as np

    body = {"data": {"tensor": {"shape": list(x.shape),
                                "values": x.astype(np.float32).ravel().tolist()}}}
    if baseline is not None:
        body["meta"] = {"tags": {"baseline": baseline}}
    t = time.perf_counter()
    status, out = _post(port, body, path="/explain")
    dt = time.perf_counter() - t
    if status != 200:
        raise AssertionError(f"[explain] {what}: HTTP {status} {str(out)[:300]}")
    got = out["jsonData"]
    attr = np.asarray(got["attributions"], np.float32)
    pred = np.asarray(got["prediction"], np.float32)
    if attr.shape != x.shape or not np.isfinite(attr).all() or \
            pred.shape != (x.shape[0], EXPLAIN_RESNET["num_classes"]):
        raise AssertionError(f"[explain] {what}: attributions {attr.shape}, prediction "
                             f"{pred.shape}, finite {bool(np.isfinite(attr).all())}")
    if got["target"] != np.argmax(pred, axis=-1).tolist():
        raise AssertionError(f"[explain] {what}: target is not the argmax of the prediction")
    return got, dt


def _score(user, x, target):
    """f(x)[target] in float32 through the explainer's own forward."""
    import numpy as np
    import torch

    with torch.no_grad():
        logits = user._apply(user._params, torch.from_numpy(x).to(user.device)).float()
    return logits.cpu().numpy()[np.arange(len(target)), target]


def _explain_timing(user, x, card):
    """One IG explanation's device work in CUDA-event time (the upload,
    the target forward, the folded passes, the attributions' copy back;
    not the response's encoding), and one forward-backward pass of the
    explainer's chunk (MAX_ROWS rows) alone, with cuDNN deterministic (as
    the explainer sets it when it loads) and without."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.components.explainer import MAX_ROWS

    zeros = np.zeros_like(x)
    user._white_box(x, zeros)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    user._white_box(x, zeros)
    end.record()
    torch.cuda.synchronize()
    one = start.elapsed_time(end)
    per = max(1, MAX_ROWS // x.shape[0])
    rows = per * x.shape[0]
    pts = torch.from_numpy(np.repeat(x, per, axis=0)).to(user.device)
    target = torch.zeros(rows, dtype=torch.int64, device=user.device)
    if not torch.backends.cudnn.deterministic:
        raise AssertionError("[explain] the explainer left cuDNN nondeterministic on the card")
    with torch.enable_grad():
        step = time_ms(lambda: user._grad(pts, target), iters=5, warmup=2)
        torch.backends.cudnn.deterministic = False
        try:
            free_step = time_ms(lambda: user._grad(pts, target), iters=5, warmup=2)
        finally:
            torch.backends.cudnn.deterministic = True
    with torch.no_grad():
        fwd = time_ms(lambda: user._apply(user._params, pts), iters=5, warmup=2)
    passes = -(-EXPLAIN_STEPS // per)
    log(f"[explain] (a) one IG explanation of {x.shape[0]} images, {EXPLAIN_STEPS} steps in "
        f"{passes} forward-backward passes of {rows} rows: {one:.1f} ms (CUDA events), "
        f"{one / EXPLAIN_STEPS:.2f} ms per step; one pass of {rows} rows alone {step:.2f} ms "
        f"({step / rows:.3f} ms per row), {free_step:.2f} ms without cuDNN deterministic, "
        f"the forward alone {fwd:.2f} ms [{card}]")


def _f64_explain(model_dir, kind, device, x, meta):
    """The explainer's answer from the float64 model directory (every
    convolution and batch norm in float64; the head stays float32): the
    reference the float32 attributions are measured against."""
    import torch

    from seldon_core_tpu_torch.components.explainer import Explainer

    e = Explainer(explainer_type=kind, model_uri=model_dir, n_steps=EXPLAIN_STEPS, device=device)
    e.load()
    if e._apply.__self__.dtype is not torch.float64:
        raise AssertionError(f"[explain] the float64 reference computes in "
                             f"{e._apply.__self__.dtype}")
    return e.explain(x, [], meta)


def _explain_white_box(card, dirs):
    """(a) ResNet-50 under IG and saliency behind the REST microservice:
    bf16 (4 images, latency and times), then f32 with TF32 off against
    the CPU."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    bf16 = _explainer_user(dirs["bf16"], "integrated_gradients", EXPLAIN_DEVICE)
    log(f"[explain] (a) ResNet-50 bf16 (224x224, 1000 classes, seed-0 params.npz) IG "
        f"explainer loaded in {time.perf_counter() - t0:.1f} s")
    imgs = _synthetic_images(EXPLAIN_IMAGES, EXPLAIN_RESNET["image_size"], seed=3) \
        .astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    (port,), stop = _serve_micro([bf16])
    try:
        _explain_call(port, imgs, what="bf16 warm-up")
        lat, outs = [], []
        for _ in range(1):
            got, dt = _explain_call(port, imgs, what="bf16 IG")
            lat.append(dt)
            outs.append(got)
    finally:
        stop()
    attr = np.asarray(outs[0]["attributions"], np.float32)
    fx = _score(bf16, imgs, outs[0]["target"])
    gap = np.abs(attr.reshape(len(imgs), -1).sum(1) - fx) / np.abs(fx)
    log(f"[explain] (a) bf16 IG over REST, {EXPLAIN_IMAGES} images sent as float: 200, "
        f"attributions [{EXPLAIN_IMAGES}, 224, 224, 3] finite, targets {outs[0]['target']}, "
        f"client ms {[round(x * 1e3, 1) for x in lat]}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; completeness |sum - f(x)|/|f(x)| "
        f"(zero baseline) {[float(f'{g:.3e}') for g in gap]} (not gated at bf16) [{card}]")
    _explain_timing(bf16, imgs, card)
    del bf16
    gc.collect()
    torch.cuda.empty_cache()

    x = _synthetic_images(EXPLAIN_F32_IMAGES, EXPLAIN_RESNET["image_size"], seed=4) \
        .astype(np.float32)
    with _exact_f32():
        users = {k: _explainer_user(dirs["f32"], k, EXPLAIN_DEVICE)
                 for k in ("integrated_gradients", "saliency")}
        ports, stop = _serve_micro([users["integrated_gradients"], users["saliency"]])
        try:
            ig = [_explain_call(ports[0], x, EXPLAIN_BASELINE, "f32 IG")[0] for _ in range(2)]
            sal = [_explain_call(ports[1], x, None, "f32 saliency")[0] for _ in range(2)]
        finally:
            stop()
        card_fx = _score(users["integrated_gradients"], x, ig[0]["target"])
        card_fb = _score(users["integrated_gradients"], np.full_like(x, EXPLAIN_BASELINE),
                         ig[0]["target"])
    t0 = time.perf_counter()
    metas = {"integrated_gradients": {"tags": {"baseline": EXPLAIN_BASELINE}}, "saliency": None}
    cpu = {k: _explainer_user(dirs["f32"], k, "cpu").explain(x, [], m) for k, m in metas.items()}
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = {(k, dev): _f64_explain(dirs["f64"], k, dev, x, m)
           for k, m in metas.items() for dev in (EXPLAIN_DEVICE, "cpu")}
    ref_s = time.perf_counter() - t0
    failed = []
    for kind, got in (("integrated_gradients", ig), ("saliency", sal)):
        want = cpu[kind]
        a0, a1 = (np.asarray(g["attributions"], np.float32) for g in got)
        ac = np.asarray(want["attributions"], np.float32)
        r_card, r_cpu = (np.asarray(ref[(kind, d)]["attributions"], np.float32)
                         for d in (EXPLAIN_DEVICE, "cpu"))

        def l2(a, b):
            return float(np.linalg.norm(a - b) / np.linalg.norm(b))

        err = float(np.abs(a0 - ac).max() / np.abs(ac).max())
        f64_err = float(np.abs(r_card - r_cpu).max() / np.abs(r_cpu).max())
        e_card, e_cpu = l2(a0, r_cpu), l2(ac, r_cpu)
        spread = float(np.abs(a0 - a1).max())
        targets = [got[0]["target"], want["target"]] + \
            [ref[(kind, d)]["target"] for d in (EXPLAIN_DEVICE, "cpu")]
        log(f"[explain] (a) f32 {kind} ({EXPLAIN_F32_IMAGES} images, TF32 off): targets card "
            f"{targets[0]} CPU {targets[1]} (float64 {targets[2]}, {targets[3]}); card vs CPU "
            f"relative L2 {l2(a0, ac):.3e} (tol {EXPLAIN_F32_L2}), max |dattr| {err:.3e} of "
            f"the largest; against the float64 reference: card {e_card:.3e}, CPU {e_cpu:.3e} "
            f"(card at most 2x + 1e-3); float64 card vs CPU max |dattr| {f64_err:.3e} (tol "
            f"{EXPLAIN_F64_TOL}); the same request twice max |dattr| {spread:.3e}")
        if any(t != targets[0] for t in targets) or l2(a0, ac) > EXPLAIN_F32_L2 or \
                e_card > 2 * e_cpu + 1e-3 or f64_err > EXPLAIN_F64_TOL or spread != 0.0:
            failed.append(kind)
    a0 = np.asarray(ig[0]["attributions"], np.float32)
    sums = a0.reshape(len(x), -1).sum(1)
    diff = card_fx - card_fb
    rel = np.abs(sums - diff) / np.abs(diff)
    log(f"[explain] (a) f32 IG completeness from the gray baseline {EXPLAIN_BASELINE}: sum "
        f"{sums.tolist()} vs f(x) - f(b) {diff.tolist()}, relative gap "
        f"{[float(f'{r:.3e}') for r in rel]} (tol {EXPLAIN_COMPLETENESS}); the CPU's two "
        f"explanations in {cpu_s:.1f} s, the four float64 ones in {ref_s:.1f} s")
    if not (rel <= EXPLAIN_COMPLETENESS).all():
        failed.append("completeness")
    if failed:
        raise AssertionError(f"[explain] (a) f32 gates failed: {failed}")
    del users
    gc.collect()
    torch.cuda.empty_cache()


def _iris_like(n, seed):
    """``n`` iris-like rows (three clusters at the iris class means)."""
    import numpy as np

    rs = np.random.RandomState(seed)
    means = np.array([[5.0, 3.4, 1.5, 0.2], [5.9, 2.8, 4.3, 1.3], [6.6, 3.0, 5.6, 2.0]])
    scale = np.array([0.35, 0.35, 0.45, 0.2])
    cls = rs.randint(0, 3, n)
    return np.round(means[cls] + rs.normal(0, 1, (n, 4)) * scale, 1)


def _explain_black_box(card, root, dirs):
    """(b) The iris MLP (f32) served by the port's engine on the card; an
    ablation and an anchor_tabular explainer point at it over REST, the
    same explainers against the model on the CPU."""
    import numpy as np

    from seldon_core_tpu_torch.components.explainer import Explainer
    from seldon_core_tpu_torch.servers.torchserver import TorchServer

    np.save(os.path.join(root, "iris-background.npy"), _iris_like(150, seed=17))
    train_uri = f"file://{root}/iris-background.npy"
    unit = {"name": "iris", "implementation": "JAX_SERVER", "modelUri": dirs["mlp"],
            "parameters": [{"name": "device", "value": EXPLAIN_DEVICE, "type": "STRING"}]}
    app = _zoo_engine(unit)
    host = TorchServer(dirs["mlp"], device="cpu")
    host.load()

    def on_cpu(batch):
        return np.asarray(host.predict(np.asarray(batch, np.float32), []), np.float32)

    rows = _iris_like(4, seed=18).astype(np.float32)
    calls = {"n": 0}
    (port,), _g, stop = _zoo_serve([app])
    try:
        remote = {k: Explainer(explainer_type=k, predictor_endpoint=f"127.0.0.1:{port}",
                               train_data_uri=train_uri, anchor_seed=0)
                  for k in ("ablation", "anchor_tabular")}
        local = {k: Explainer(explainer_type=k, predictor_endpoint="cpu",
                              train_data_uri=train_uri, anchor_seed=0)
                 for k in ("ablation", "anchor_tabular")}
        for e in local.values():
            e._query_predictor = on_cpu
        query = remote["anchor_tabular"]._query_predictor

        def counted(batch):
            calls["n"] += 1
            return query(batch)

        remote["anchor_tabular"]._query_predictor = counted
        t = time.perf_counter()
        abl = remote["ablation"].explain(rows, [])
        abl_s = time.perf_counter() - t
        t = time.perf_counter()
        anc = remote["anchor_tabular"].explain(rows[:2], [])
        anc_s = time.perf_counter() - t
    finally:
        stop()
    abl_cpu = local["ablation"].explain(rows, [])
    anc_cpu = local["anchor_tabular"].explain(rows[:2], [])
    err = float(np.abs(np.asarray(abl["attributions"]) - np.asarray(abl_cpu["attributions"])).max())
    log(f"[explain] (b) ablation of 4 iris rows through the engine (one predict call of "
        f"{4 * 5} rows, {abl_s * 1e3:.1f} ms): targets card {abl['target']} CPU "
        f"{abl_cpu['target']}, max |dattr| {err:.3e} (tol {EXPLAIN_ABLATION_TOL})")
    if abl["target"] != abl_cpu["target"] or err > EXPLAIN_ABLATION_TOL:
        raise AssertionError("[explain] (b) ablation differs between the card and the CPU")
    keys = ("anchor", "precision", "coverage", "prediction")
    for i, (a, c) in enumerate(zip(anc["anchors"], anc_cpu["anchors"])):
        log(f"[explain] (b) anchor_tabular row {i}: card {[a[k] for k in keys]}, CPU "
            f"{[c[k] for k in keys]}, converged {a['converged']}, {a['n_samples']} samples")
    log(f"[explain] (b) anchor_tabular of 2 rows: {calls['n']} predict calls through the "
        f"engine in {anc_s:.2f} s [{card}]")
    if anc != anc_cpu:
        raise AssertionError("[explain] (b) the anchors differ between the card and the CPU")


def _explain_training(card):
    """(c) VAEOutlier.fit and Seq2SeqOutlier.fit on the card and on the CPU
    at their default widths and 25 epochs: the same flags on seeded inliers
    and planted outliers, scores within EXPLAIN_TRAINED_RTOL."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.components.outlier import Seq2SeqOutlier, VAEOutlier

    rs = np.random.RandomState(21)
    X = rs.normal(0, 1, (1024, 4)).astype(np.float32)
    probe = np.concatenate([rs.normal(0, 1, (24, 4)), rs.normal(5, 1, (8, 4))]).astype(np.float32)
    t_seq = np.linspace(0, 6, 16)[None, :, None]
    S = (np.sin(t_seq) * rs.uniform(0.5, 1.5, (256, 1, 2))
         + rs.normal(0, 0.1, (256, 16, 2))).astype(np.float32)
    probe_s = np.concatenate([
        np.sin(t_seq) * rs.uniform(0.5, 1.5, (12, 1, 2)) + rs.normal(0, 0.1, (12, 16, 2)),
        rs.normal(0, 1.5, (4, 16, 2))]).astype(np.float32)
    for name, make, data, pr, n_out, epochs in (
            ("vae", lambda d: VAEOutlier(threshold=4.0, mc_samples=5, seed=0, device=d), X,
             probe, 8, EXPLAIN_VAE_EPOCHS),
            ("seq2seq", lambda d: Seq2SeqOutlier(threshold=1.0, device=d), S, probe_s, 4,
             EXPLAIN_SEQ_EPOCHS)):
        got = {}
        for dev in (EXPLAIN_DEVICE, "cpu"):
            det = make(dev)
            t = time.perf_counter()
            det.fit(data, epochs=epochs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            flags = det.predict(pr, [])
            got[dev] = (flags, det.score_.copy(), dt)
        (fc, sc, tc), (fh, sh, th) = got[EXPLAIN_DEVICE], got["cpu"]
        err = float(np.abs(sc - sh).max() / np.abs(sh).max())
        log(f"[explain] (c) {name}.fit ({len(data)} rows, {epochs} epochs, default widths): "
            f"card {tc:.2f} s ({tc / epochs * 1e3:.1f} ms/epoch), CPU {th:.2f} s "
            f"({th / epochs * 1e3:.1f} ms/epoch); flags card {fc.tolist()} == CPU "
            f"{bool((fc == fh).all())}, max relative |dscore| {err:.3e} (tol "
            f"{EXPLAIN_TRAINED_RTOL}) [{card}]")
        if not (fc == fh).all() or err > EXPLAIN_TRAINED_RTOL or fc[-n_out:].sum() < n_out:
            raise AssertionError(f"[explain] (c) {name} trained on the card differs from the "
                                 "CPU or misses the planted outliers")


def _explain_servers(root):
    """(d) The host servers resolved from graph specs by the port's engine:
    each gives its clear missing-library error (none "not ported"), and
    TRITON_SERVER goes through the engine against a stub transport."""
    import importlib.util

    import numpy as np

    from seldon_core_tpu_torch.servers.trtserver import TRTServer

    empty = os.path.join(root, "no-model")
    os.makedirs(empty, exist_ok=True)
    for impl, module, word in EXPLAIN_SERVERS:
        try:
            present = importlib.util.find_spec(module) is not None
        except (ImportError, ValueError):
            present = False
        try:
            _zoo_engine({"name": "m", "implementation": impl, "modelUri": empty})
            err = None
        except Exception as e:  # noqa: BLE001 - the error is the result
            err = e
        msg = f"{type(err).__name__}: {err}" if err is not None else "no error"
        log(f"[explain] (d) {impl}: {module} {'installed' if present else 'absent'}; {msg}")
        if err is None or "not ported" in str(err) or (not present and word not in str(err)):
            raise AssertionError(f"[explain] (d) {impl} did not give its missing-library error")

    def transport(url, body, timeout):
        if body is None:
            return {"inputs": [{"name": "x", "datatype": "FP64", "shape": [-1, 2]}]}
        req = json.loads(body)
        rows = np.asarray(req["inputs"][0]["data"]).reshape(req["inputs"][0]["shape"])
        return {"outputs": [{"name": "y", "datatype": "FP64", "shape": list(rows.shape),
                             "data": (rows * 3).ravel().tolist()}]}

    app = _zoo_engine({"name": "m", "type": "MODEL"},
                      registry={"m": TRTServer(transport=transport)})
    out = asyncio.run(app.predict({"data": {"ndarray": [[1.0, 2.0]]}}))
    asyncio.run(app.executor.close())
    log(f"[explain] (d) TRITON_SERVER through the engine on a stub transport: "
        f"{out['data']['ndarray']}")
    if out["data"]["ndarray"] != [[3.0, 6.0]]:
        raise AssertionError("[explain] (d) the Triton proxy answered wrongly")


def phase_explain(card):
    """``/explain`` and the rest of this slice on the card: (a) ResNet-50
    (224x224, 1000 classes, seed-0 params.npz) under integrated gradients
    (32 steps) behind the REST microservice at bf16, then IG and saliency
    at f32 with TF32 off against the CPU; (b) ablation and anchor_tabular
    over the iris MLP served by the port's engine, against the CPU; (c)
    the VAE and seq2seq detectors trained on the card against the CPU;
    (d) the host servers' errors and the Triton proxy. Returns the flash
    kernel's launches over the phase (none of these models runs it)."""
    import torch

    from seldon_core_tpu_torch.ops import flash_attention as fa

    torch.cuda.synchronize()
    fa.LAUNCHES["flash_attention"] = 0
    with tempfile.TemporaryDirectory(prefix="chip-smoke-explain-") as root:
        t0 = time.perf_counter()
        dirs = _explain_dirs(root)
        log(f"[explain] model directories written in {time.perf_counter() - t0:.1f} s")
        for part, fn in (("(a)", lambda: _explain_white_box(card, dirs)),
                         ("(b)", lambda: _explain_black_box(card, root, dirs)),
                         ("(c)", lambda: _explain_training(card)),
                         ("(d)", lambda: _explain_servers(root))):
            t0 = time.perf_counter()
            fn()
            log(f"[explain] {part} in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    launches = fa.LAUNCHES["flash_attention"]
    log(f"[explain] flash kernel launches over the phase: {launches} (no model here runs it)")
    return launches


# -- mixture of experts ---------------------------------------------------------------

# llm-1.26b-moe8: llm-1.26b with a top-1 switch mixture of 8 GELU experts
# (capacity factor 1.25) in every layer in place of its SwiGLU FFN: 4.86 B
# parameters, 4.43 B of them experts (8 x 2 x 2048 x 5632 x 24), 9.7 GB in
# bf16. The dense dispatch reads every expert on every decode step.
LLM_1_26B_MOE8 = {**LLM_1_26B, "n_experts": 8, "capacity_factor": 1.25}
MOE_SERVE = {"profiler": 1, "profiler_hbm_gb_s": 3350}
# (a): the small float32 model of phase 4 with 4 experts
MOE_SMALL_CFG = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
                     d_ff=512, max_seq=128, n_experts=4, dtype="float32")
MOE_SMALL_BATCHER = dict(slots=4, prefill_buckets=(32, 64), steps_per_poll=4, pipeline_depth=1)
# (a)'s whole batch: six requests over four lanes, greedy and seeded, their
# budgets staggered so that lanes free at different polls
MOE_SMALL_LENS = (32, 20, 64, 9, 50, 32)
MOE_SMALL_NEW = [16, 9, 12, 7, 14, 10]
MOE_STAGES = ("moe.router", "moe.dispatch", "moe.experts", "moe.combine")


def _moe_staged(wrap):
    """``moe_ffn``'s calls in its order, each stage inside ``wrap(name)``
    (``torch.profiler.record_function``): the layer the split reads."""
    import torch

    from seldon_core_tpu_torch.parallel import moe

    def staged(x, router_w, w1, w2, capacity_factor=1.25):
        with wrap("moe.router"):
            r = moe.route(x, router_w, capacity_factor)
        with wrap("moe.dispatch"):
            dispatch, combine = moe.dispatch_combine(r, router_w.shape[1], x.dtype)
            expert_in = torch.einsum("nec,nd->ecd", dispatch, x)
        with wrap("moe.experts"):
            expert_out = moe.experts(expert_in, w1, w2)
        with wrap("moe.combine"):
            out = torch.einsum("nec,ecd->nd", combine, expert_out)
        return out, r.aux_loss

    return staged


def _moe_small(card):
    """(a) The small float32 MoE model on the card: greedy requests alone
    (prompts that fill their bucket, so that the batcher's prefill runs
    generate()'s rows) equal ``generate``; a whole batch, greedy and
    seeded, queued at once, from graph replay equals the same batch run
    eagerly; a seeded request alone repeats, graph == eager."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.llm import DecoderLM
    from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

    model = DecoderLM(device="cuda", **MOE_SMALL_CFG)
    params = model.init_params(0, device="cuda")
    rs = np.random.RandomState(12)
    vocab = MOE_SMALL_CFG["vocab_size"]
    wave = [(rs.randint(0, vocab, n).tolist(), 0.9 * (i % 2), 20 + i, None)
            for i, n in enumerate(MOE_SMALL_LENS)]
    alone = [rs.randint(0, vocab, n).tolist() for n in (32, 64)]
    refs = [model.generate(params, torch.tensor([p], device="cuda"), 16)[0].tolist()
            for p in alone]
    out = {}
    for side, graphs in (("graphs", True), ("eager", False)):
        gate = _Gate()
        b = ContinuousBatcher(model, params, cuda_graphs=graphs, **MOE_SMALL_BATCHER)
        b.fault_hook = gate
        b.warm(prompt_lens=MOE_SMALL_LENS, max_new_tokens=max(MOE_SMALL_NEW))
        b.start()
        try:
            futs = gate.submit_together(b, wave, max_new=MOE_SMALL_NEW)
            batch = [f.result(timeout=300) for f in futs]
            greedy = [b.generate(p, max_new_tokens=16) for p in alone]
            seeded = [b.generate(alone[0], max_new_tokens=16, temperature=0.9, seed=5)
                      for _ in range(2)]
            inline, captured = b.stats["graph_captures_inline"], b.stats["graphs_captured"]
        finally:
            b.close()
        if graphs and (inline or not captured):
            raise AssertionError(f"[moe] (a) {captured} graphs captured, {inline} after warm()")
        if seeded[0] != seeded[1]:
            raise AssertionError(f"[moe] (a) {side}: a seeded request alone did not repeat")
        for p, g, ref in zip(alone, greedy, refs):
            if g != ref:
                raise AssertionError(f"[moe] (a) {side}: the greedy {len(p)}-token request "
                                     f"alone parts from generate() at step "
                                     f"{_first_diff(g[len(p):], ref[len(p):])}")
        out[side] = (batch, seeded[0])
    if out["graphs"] != out["eager"]:
        bad = [i for i, (x, y) in enumerate(zip(out["graphs"][0], out["eager"][0])) if x != y]
        raise AssertionError(f"[moe] (a) graph replay differs from eager: batch rows {bad}, "
                             f"seeded alone equal {out['graphs'][1] == out['eager'][1]}")
    log(f"[moe] (a) small f32 MoE (E=4): greedy alone == generate() (prompts of 32 and 64); "
        f"a whole batch of {len(wave)} (greedy and seeded) from graph replay == eager; a "
        f"seeded request alone repeats, graph == eager [{card}]")


def _moe_serve(card, model_dir):
    """(b) llm-1.26b-moe8 through GenerateServer (the serve phase's typed
    parameters with the device-time ledger on), driven twice with the
    serve waves, each wave queued whole. Fails unless every request
    answers 64 tokens, both runs and each run's probe repeat token for
    token, every prefill launched the flash kernel and no graph is
    captured after warm(). Prints tokens/s, TTFT, TPOT, peak memory, the
    ledger's split, busy share and MBU, and the decode step beside its
    weight-read bound. Returns the server and the flash launches of the
    two runs."""
    probe, mixed = serve_waves()
    t0 = time.perf_counter()
    server = _gen_server(model_dir, **MOE_SERVE)
    b, model = server.batcher, server._model
    gate = _Gate()
    b.fault_hook = gate
    log(f"[moe] (b) llm-1.26b-moe8 loaded and warmed in {time.perf_counter() - t0:.1f} s "
        f"({model.n_params() / 1e9:.3f} B params, {b._param_bytes / 1e9:.3f} GB in bf16, "
        f"{b.stats['graphs_captured']} graphs)")
    runs, launches = [], 0
    for n in range(2):
        before = server.profiler.summary()
        t = time.perf_counter()
        run = _sched_run(gate, b, probe, mixed)
        run["wall"] = time.perf_counter() - t
        run["ledger"] = _ledger_delta(before, server.profiler.summary())
        runs.append(run)
        launches += run["launches"]
    inline = b.stats["graph_captures_inline"]
    layers = model.cfg.n_layers
    vocab = model.cfg.vocab_size
    for n, run in enumerate(runs):
        for key, out in run["tokens"].items():
            toks = _p(key, probe, mixed)
            if len(out) != len(toks) + MAX_NEW or out[: len(toks)] != toks \
                    or not all(0 <= x < vocab for x in out):
                raise AssertionError(f"[moe] (b) run {n + 1} {key}: malformed tokens")
        for label, *_r in probe:
            if run["tokens"][label] != run["tokens"][label + "#2"]:
                raise AssertionError(f"[moe] (b) run {n + 1} {label}: the repeat gave other "
                                     "tokens")
        prefills = run["delta"]["prefill_steps"]
        if prefills <= 0 or run["launches"] < layers * prefills:
            raise AssertionError(f"[moe] (b) run {n + 1}: {prefills} prefills but "
                                 f"{run['launches']} flash launches")
    bad = [k for k in runs[0]["tokens"] if runs[1]["tokens"][k] != runs[0]["tokens"][k]]
    if bad:
        raise AssertionError(f"[moe] (b) the second run gave other tokens: {bad}")
    if inline:
        raise AssertionError(f"[moe] (b) {inline} graphs captured after warm()")
    bound_ms = b._param_bytes / PEAK_BYTES_S * 1e3
    for n, run in enumerate(runs):
        slo, led = run["slo"], run["ledger"]
        total = sum(r["s"] for r in led["buckets"]) or 1e-12
        nbytes = sum(r["bytes"] for r in led["buckets"])
        split = ", ".join(f"{kind} {100 * s / total:.1f}%" for kind, s in
                          sorted(led["by_kind"].items(), key=lambda kv: -kv[1]))
        # a whole-batch burst's ledger tokens are its steps times the slots
        bursts = [r for r in led["buckets"] if r["kind"] == "decode_burst"]
        step_ms = sum(r["s"] for r in bursts) * 1e3 * b.slots / max(
            1, sum(r["tokens"] for r in bursts))
        log(f"[moe] (b) run {n + 1}: tokens/s {run['tok_s']:.1f}, TTFT p50 "
            f"{slo['ttft_p50']:.1f} ms p99 {slo['ttft_p99']:.1f} ms, TPOT p50 "
            f"{slo['tpot_p50']:.2f} ms, peak allocated {run['peak'] / 2**30:.2f} GiB, flash "
            f"launches {run['launches']} over {run['delta']['prefill_steps']} prefills [{card}]")
        log(f"[moe] (b) run {n + 1} ledger: device {total * 1e3:.1f} ms in "
            f"{run['wall'] * 1e3:.1f} ms of wall time (busy {total / run['wall']:.4f}); "
            f"{split}; modelled reads {nbytes / 1e9:.2f} GB = MBU "
            f"{100 * nbytes / run['wall'] / PEAK_BYTES_S:.2f}% of 3.35 TB/s; decode step "
            f"{step_ms:.3f} ms (ledger stream time, whole-batch bursts) against a "
            f"{bound_ms:.3f} ms bound (every expert's bf16 weights once at 3.35 TB/s) [{card}]")
    log(f"[moe] (b) both runs token-identical ({len(runs[0]['tokens'])} streams each, probes "
        f"repeat); every prefill launched the flash kernel; graph_captures_inline {inline}")
    return server, launches


def _moe_dropped(model, params, x_prefill, ks, vs, toks, pos):
    """Share of rows dropped past capacity in a B=1 T=1024 prefill and a
    B=8 decode step: a separate forward whose layers count ``kept``."""
    from seldon_core_tpu_torch.models import llm as llm_mod
    from seldon_core_tpu_torch.parallel import moe

    counts = []
    orig = llm_mod.moe_ffn

    def counting(x, router_w, *a):
        r = moe.route(x, router_w, *a[2:])
        counts.append((int(r.kept.sum().item()), x.shape[0], r.capacity))
        return orig(x, router_w, *a)

    llm_mod.moe_ffn = counting
    try:
        model.prefill(params, x_prefill, x_prefill.shape[1])
        pre = list(counts)
        counts.clear()
        model.decode_step_ragged_list(params, ks, vs, toks, pos, attn_len=256)
        dec = list(counts)
    finally:
        llm_mod.moe_ffn = orig
    return pre, dec


def _moe_split(card, server):
    """(c) The MoE layer's stages in one B=8 decode step and one B=1,
    T=1024 prefill: torch.profiler's device time per stage (the stages of
    ``moe_ffn`` inside ``record_function`` ranges) against the whole
    call's kernel sum, each stage's time from CUDA-event-timed graphs at
    layer 0's shapes times the layers, and the share of dropped rows."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from seldon_core_tpu_torch.models import llm as llm_mod
    from seldon_core_tpu_torch.parallel import moe

    model, params = server._model, server.batcher.params
    cfg = model.cfg
    rs = np.random.RandomState(8)
    prompt = torch.tensor(rs.randint(0, cfg.vocab_size, (1, 1024)), device="cuda")
    ctx = torch.tensor(rs.randint(0, cfg.vocab_size, (8, 128)), device="cuda")
    _l, slab = model.prefill(params, ctx, 256)
    ks = [slab["k"][l] for l in range(cfg.n_layers)]
    vs = [slab["v"][l] for l in range(cfg.n_layers)]
    toks = torch.tensor(rs.randint(0, cfg.vocab_size, (8, 1)), device="cuda")
    pos = torch.full((8,), 128, dtype=torch.long, device="cuda")
    calls = {
        "decode step B=8": lambda: model.decode_step_ragged_list(
            params, ks, vs, toks, pos, attn_len=256),
        "prefill B=1 T=1024": lambda: model.prefill(params, prompt, 1024),
    }
    orig = llm_mod.moe_ffn
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        llm_mod.moe_ffn = _moe_staged(record_function)
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
        finally:
            llm_mod.moe_ffn = orig
        events = prof.key_averages()
        # a range shows twice: on the host with the device time of the
        # kernels it launched, and on the device as its span (gaps between
        # eager launches included), which the kernel sum leaves out
        kern_ms = sum(e.self_device_time_total for e in events
                      if e.device_type.name == "CUDA" and e.key not in MOE_STAGES) / 1e3
        inside = {e.key: e.device_time_total / 1e3 for e in events
                  if e.key in MOE_STAGES and e.device_type.name == "CPU"}
        span = {e.key: e.device_time_total / 1e3 for e in events
                if e.key in MOE_STAGES and e.device_type.name == "CUDA"}
        log(f"[moe] (c) {name}, eager under torch.profiler: kernel sum {kern_ms:.3f} ms; MoE "
            "stages (kernels launched in the range / the range's span on the device) "
            + ", ".join(f"{st.split('.')[1]} {inside.get(st, 0.0):.3f} / "
                        f"{span.get(st, 0.0):.3f} ms" for st in MOE_STAGES)
            + f"; the stages' kernels {100 * sum(inside.values()) / max(kern_ms, 1e-9):.1f}% "
            f"of the kernel sum [{card}]")
    # the stages alone at layer 0's shapes, CUDA-event-timed graphs
    p0 = {k: v[0] for k, v in params["blocks"].items()}
    for name, n in (("decode step B=8", 8), ("prefill B=1 T=1024", 1024)):
        x = torch.randn((n, cfg.d_model), device="cuda", dtype=model.dtype)
        r = moe.route(x, p0["router"], cfg.capacity_factor)
        disp, comb = moe.dispatch_combine(r, cfg.n_experts, x.dtype)
        e_in = torch.einsum("nec,nd->ecd", disp, x)
        e_out = moe.experts(e_in, p0["w1e"], p0["w2e"])
        timed = {
            "router": lambda: moe.route(x, p0["router"], cfg.capacity_factor),
            "dispatch": lambda: torch.einsum(
                "nec,nd->ecd", moe.dispatch_combine(r, cfg.n_experts, x.dtype)[0], x),
            "experts": lambda: moe.experts(e_in, p0["w1e"], p0["w2e"]),
            "combine": lambda: torch.einsum("nec,ecd->nd", comb, e_out),
        }
        ms = {k: device_ms(f, launches=10, reps=3) for k, f in timed.items()}
        log(f"[moe] (c) {name}, one layer's stages alone (CUDA graph, capacity "
            f"{r.capacity}): " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
            + f"; x {cfg.n_layers} layers = {cfg.n_layers * sum(ms.values()):.3f} ms [{card}]")
    pre, dec = _moe_dropped(model, params, prompt, ks, vs, toks, pos)
    for name, rows in (("prefill B=1 T=1024", pre), ("decode step B=8", dec)):
        kept = sum(k for k, _n, _c in rows)
        total = sum(n for _k, n, _c in rows)
        log(f"[moe] (c) {name}: {total - kept} of {total} rows dropped past capacity over "
            f"{len(rows)} layers ({100 * (total - kept) / total:.1f}%; capacity {rows[0][2]} "
            f"per expert, per layer {[n - k for k, n, _c in rows]})")


def phase_moe(card):
    """llm-1.26b-moe8 and a small float32 MoE model on the card: (a) the
    batcher against generate() and graph replay against eager, (b) serving
    at full width through GenerateServer, (c) the MoE layer's split and
    its dropped rows. Returns the flash launches of (b)'s two runs."""
    t0 = time.perf_counter()
    _moe_small(card)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-moe-") as model_dir:
        with open(os.path.join(model_dir, "jax_config.json"), "w") as f:
            json.dump({"family": "llm", "config": LLM_1_26B_MOE8}, f)
        server, launches = _moe_serve(card, model_dir)
        try:
            _moe_split(card, server)
        finally:
            server.close()
    log(f"[moe] phase wall time {time.perf_counter() - t0:.1f} s")
    return launches

# -- training -------------------------------------------------------------------------

# (a) and (c): one seeded batch of 4 rows of 1024 positions (+ the next-token
# target), SGD at the train step's default learning rate
TRAIN_BATCH = (4, 1025)
TRAIN_LR = 1e-2
TRAIN_STEPS = 5
# (b): llm-1.26b's width at 2 layers, float32, B 1, T 256, TF32 off; card
# against CPU after one step. Both sum float32 in different orders:
#  * the loss (~10.8, a mean over 256 tokens of a 32000-way log-softmax):
#    |card - CPU| <= 1e-4;
#  * each parameter leaf after the step, max |card - CPU| / max |CPU| <= 1e-5
#    (the update is ~1e-4 of a weight, so this is the params' own rounding);
#  * each gradient leaf, max |card - CPU| / max |CPU| <= 1e-4 (sums over up
#    to 5632-long products and 256 rows, ~1e-6 expected).
TRAIN_F32_LAYERS, TRAIN_F32_T = 2, 256
TRAIN_F32_TOL = {"loss": 1e-4, "param": 1e-5, "grad": 1e-4}
TRAIN_MOE_LAYERS = 4


def _train_model(config, **over):
    from seldon_core_tpu_torch.models.llm import DecoderLM

    return DecoderLM(device="cuda", **{**config, **over})


def _train_steps(step, params, tokens, n):
    """``n`` steps; per step its loss and its host time around a step that
    ends in a synchronise (the loss's read)."""
    import torch

    losses, secs = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, loss = step(params, tokens)
        losses.append(float(loss))
        secs.append(time.perf_counter() - t)
    return params, losses, secs


def _train_throughput(card, mesh, tokens):
    """(a) llm-1.26b at full width and depth, bf16 over float32 params:
    TRAIN_STEPS SGD steps on one batch; ms per step, tokens/s, MFU, peak
    memory and the losses; then one profiled forward-backward."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from seldon_core_tpu_torch.parallel.train import make_train_step

    model = _train_model(LLM_1_26B)
    torch.cuda.reset_peak_memory_stats()
    init, step = make_train_step(model, mesh, learning_rate=TRAIN_LR)
    t = time.perf_counter()
    params = init(LLM_1_26B["seed"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    params, losses, secs = _train_steps(step, params, tokens, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"[train] (a) losses {losses}: not finite or not falling")
    B, T = tokens.shape[0], tokens.shape[1] - 1
    steady = sum(secs[1:]) / len(secs[1:])
    flops = 3 * model.flops_per_row(T) * B
    log(f"[train] (a) llm-1.26b (full width and depth, {model.n_params() / 1e9:.3f} B params, "
        f"bf16 compute over float32 params, TF32 off), B {B} T {T}, SGD lr {TRAIN_LR}: init "
        f"{init_s:.2f} s; steps {', '.join(f'{1e3 * x:.1f}' for x in secs)} ms; steady (steps "
        f"2-{len(secs)}) {1e3 * steady:.2f} ms/step, {B * T / steady:.1f} tokens/s, MFU "
        f"{100 * flops / steady / PEAK_FLOPS['bfloat16']:.2f}% (3 x flops_per_row({T}) x {B} = "
        f"{flops / 1e12:.2f} TFLOP a step against 989 TFLOP/s); peak allocated "
        f"{peak / 2**30:.2f} GiB; losses {', '.join(f'{x:.4f}' for x in losses)} [{card}]")
    # where a step's device time goes: one forward-backward under the
    # profiler, attention inside a range, kernels attributed to the
    # operators that launched them
    from seldon_core_tpu_torch.models import llm as llm_mod

    ring = llm_mod.ring_attention

    def ranged(*a, **k):
        with record_function("train.attention"):
            return ring(*a, **k)

    llm_mod.ring_attention = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step.value_and_grad(params, tokens)
            torch.cuda.synchronize()
    finally:
        llm_mod.ring_attention = ring
    events = prof.key_averages()
    kern = [e for e in events if e.device_type.name == "CUDA"]
    total = sum(e.self_device_time_total for e in kern) / 1e3
    attn = sum(e.device_time_total for e in events
               if e.key == "train.attention" and e.device_type.name == "CPU") / 1e3
    ops = sorted((e for e in events if e.device_type.name == "CPU" and e.key.startswith("aten::")),
                 key=lambda e: -e.self_device_time_total)[:10]
    log(f"[train] (a) one forward-backward under torch.profiler: kernel sum {total:.1f} ms over "
        f"{sum(e.count for e in kern)} kernels; attention's forward (ring_attention, "
        f"{model.cfg.n_layers} layers) {attn:.1f} ms ({100 * attn / max(total, 1e-9):.1f}%); by "
        "operator (device time of the kernels it launched): " + "; ".join(
            f"{e.key} x{e.count} {e.self_device_time_total / 1e3:.1f} ms "
            f"({100 * e.self_device_time_total / 1e3 / max(total, 1e-9):.1f}%)" for e in ops))
    return steady


def _train_card_vs_cpu(card, mesh):
    """(b) One float32 step of llm-1.26b's width at 2 layers, B 1, T 256,
    on the card against the port on the CPU from the same weights, TF32
    off: the loss, each gradient leaf and each updated parameter leaf."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.convert import sorted_leaves
    from seldon_core_tpu_torch.models.llm import DecoderLM
    from seldon_core_tpu_torch.parallel.train import gather_params, make_train_step, shard_params

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("[train] (b) needs TF32 off")
    cfg = {**LLM_1_26B, "n_layers": TRAIN_F32_LAYERS, "dtype": "float32"}
    model = DecoderLM(**cfg)
    host = model.init_params(0, device="cpu")
    tokens = np.random.RandomState(1).randint(0, cfg["vocab_size"], (1, TRAIN_F32_T + 1))
    got = {}
    for dev in ("cuda", "cpu"):
        t = time.perf_counter()
        _init, step = make_train_step(model, mesh, learning_rate=TRAIN_LR, device=dev)
        params = shard_params(host, mesh, dev)
        loss0, grads = step.value_and_grad(params, tokens)
        grads = gather_params(grads, mesh)
        params, loss = step(params, tokens)
        got[dev] = (float(loss0), float(loss), grads, gather_params(params, mesh))
        got[dev + " s"] = time.perf_counter() - t
    card_loss, cpu_loss = got["cuda"][1], got["cpu"][1]

    def worst(a, b):
        return max((float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30)), path)
                   for (path, x), (_p, y) in zip(sorted_leaves(a), sorted_leaves(b)))

    g_err, g_leaf = worst(got["cuda"][2], got["cpu"][2])
    p_err, p_leaf = worst(got["cuda"][3], got["cpu"][3])
    dl = abs(card_loss - cpu_loss)
    log(f"[train] (b) float32 llm-1.26b width x {TRAIN_F32_LAYERS} layers, B 1 T {TRAIN_F32_T}, "
        f"TF32 off, one step: loss card {card_loss:.6f} CPU {cpu_loss:.6f} |diff| {dl:.3e} (tol "
        f"{TRAIN_F32_TOL['loss']:g}); worst gradient leaf {'/'.join(g_leaf)} {g_err:.3e} of its "
        f"largest (tol {TRAIN_F32_TOL['grad']:g}); worst updated parameter leaf "
        f"{'/'.join(p_leaf)} {p_err:.3e} (tol {TRAIN_F32_TOL['param']:g}); card "
        f"{got['cuda s']:.2f} s, CPU {got['cpu s']:.2f} s for both calls [{card}]")
    if dl > TRAIN_F32_TOL["loss"] or g_err > TRAIN_F32_TOL["grad"] \
            or p_err > TRAIN_F32_TOL["param"]:
        raise AssertionError("[train] (b) card and CPU disagree past the tolerance")


def _train_moe(card, mesh, tokens):
    """(c) One step of llm-1.26b-moe8 at full width and TRAIN_MOE_LAYERS
    layers (depth cut for the time budget), ep 1: a finite loss."""
    import torch

    from seldon_core_tpu_torch.parallel.train import make_train_step

    model = _train_model(LLM_1_26B_MOE8, n_layers=TRAIN_MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    init, step = make_train_step(model, mesh, learning_rate=TRAIN_LR)
    params = init(LLM_1_26B["seed"])
    params, losses, secs = _train_steps(step, params, tokens, 2)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[train] (c) losses {losses}: not finite")
    log(f"[train] (c) llm-1.26b-moe8 at {TRAIN_MOE_LAYERS} of 24 layers "
        f"({model.n_params() / 1e9:.3f} B params), ep 1, B {tokens.shape[0]} T "
        f"{tokens.shape[1] - 1}: steps {', '.join(f'{1e3 * x:.1f}' for x in secs)} ms, losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}, peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")


def phase_train(card):
    """The parallel training step on the card: a one-rank NCCL group joined
    through ``initialize_distributed`` with a file coordinator, the mesh
    {data 1, stage 1, seq 1, model 1}, then (a) llm-1.26b's throughput,
    (b) card == CPU at float32, (c) an llm-1.26b-moe8 step. Returns the
    flash kernel's launches over the phase (training attends in plain
    PyTorch, as the JAX package does: none)."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    t0 = time.perf_counter()
    fa.LAUNCHES["flash_attention"] = 0
    tokens = torch.as_tensor(np.random.RandomState(0).randint(
        0, LLM_1_26B["vocab_size"], TRAIN_BATCH), device="cuda")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as tmp:
        if not initialize_distributed(f"file://{tmp}/rendezvous", num_processes=1,
                                      process_id=0):
            raise AssertionError("[train] initialize_distributed did not join a group")
        try:
            mesh = make_mesh({"data": 1, "stage": 1, "seq": 1, "model": 1})
            log(f"[train] joined a {dist.get_world_size()}-rank {dist.get_backend()} group "
                f"(file coordinator); mesh {mesh.shape}, rank {mesh.rank} on "
                f"cuda:{torch.cuda.current_device()}")
            _train_throughput(card, mesh, tokens)
            gc.collect()
            torch.cuda.empty_cache()
            _train_card_vs_cpu(card, mesh)
            gc.collect()
            torch.cuda.empty_cache()
            _train_moe(card, mesh, tokens)
        finally:
            dist.destroy_process_group()
    launches = fa.LAUNCHES["flash_attention"]
    if launches:
        raise AssertionError(f"[train] training launched the flash kernel {launches} times")
    log(f"[train] flash launches 0; phase wall time {time.perf_counter() - t0:.1f} s")
    return launches


# -- the control plane: sdctl, the reconciler, the gateway -------------------

# the generate parameters of the control-plane phase's deployments: the
# serve phase's without ``device`` (the members run on the card by their
# own default; nothing here passes a device)
CP_PARAMS = [p for p in SERVE_PARAMS if p["name"] != "device"]
# (c)'s deployments: llm-1.26b's widths at CP_SMALL_LAYERS of 24 layers
# (depth cut for the time budget), one slot, so that every request runs
# alone and a member's queue is deep enough to be in flight at a drain
CP_SMALL_LAYERS = 8
CP_SMALL_PARAMS = [
    {"name": "slots", "value": "1", "type": "INT"},
    {"name": "steps_per_poll", "value": "16", "type": "INT"},
    {"name": "pipeline_depth", "value": "3", "type": "INT"},
    {"name": "warmup_prompt_lens", "value": "20", "type": "STRING"},
    {"name": "warmup_max_new_tokens", "value": "64", "type": "INT"},
]
CP_LABELS = ("greedy_20", "greedy_128", "greedy_300")
CP_DRAIN_NEW = 900


def _cp_children(pid):
    """The pids whose parent is ``pid`` (from /proc)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            out.append(int(d))
    return sorted(out)


def _cp_member(pid):
    """A controller child's command line, REST port, deployment and (for an
    engine) the predictor spec of its ``ENGINE_PREDICTOR``; None once it
    is gone."""
    import base64

    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            cmd = [c.decode() for c in f.read().split(b"\0") if c]
        with open(f"/proc/{pid}/environ", "rb") as f:
            env = dict(kv.split("=", 1) for kv in f.read().decode(errors="replace").split("\0")
                       if "=" in kv)
    except OSError:
        return None
    port = int(cmd[cmd.index("--http-port") + 1]) if "--http-port" in cmd else None
    spec = (json.loads(base64.b64decode(env["ENGINE_PREDICTOR"]))
            if "ENGINE_PREDICTOR" in env else None)
    return {"pid": pid, "cmd": cmd, "port": port, "spec": spec,
            "deployment": env.get("SELDON_DEPLOYMENT_ID")}


class _Controller:
    """``sdctl controller`` as a process of its own over a store directory,
    its output (and its children's) in ``log``."""

    def __init__(self, root, tag, subprocess_runtime):
        self.store = os.path.join(root, f"store-{tag}")
        self.log_path = os.path.join(root, f"controller-{tag}.log")
        self.gw_port = _free_port()
        self.env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
        cmd = [sys.executable, "-m", "seldon_core_tpu_torch.controlplane", "--store-dir",
               self.store, "controller", "--gateway-port", str(self.gw_port), "--poll-s", "0.2"]
        if subprocess_runtime:
            cmd.insert(cmd.index("controller") + 1, "--subprocess-runtime")
        self.logf = open(self.log_path, "w")
        self.proc = subprocess.Popen(cmd, cwd=HERE, env=self.env, stdout=self.logf,
                                     stderr=subprocess.STDOUT)

    def sdctl(self, *args):
        """The port's sdctl against this controller's store."""
        p = subprocess.run([sys.executable, "-m", "seldon_core_tpu_torch.controlplane",
                            "--store-dir", self.store, *args], cwd=HERE, env=self.env,
                           capture_output=True, text=True, timeout=120)
        if p.returncode != 0:
            raise AssertionError(f"sdctl {' '.join(args)}: exit {p.returncode} "
                                 f"{p.stderr[-2000:]}")
        return p.stdout

    def apply(self, root, body):
        path = os.path.join(root, f"{body['metadata']['name']}-{time.monotonic_ns()}.json")
        with open(path, "w") as f:
            json.dump(body, f)
        return self.sdctl("apply", "-f", path)

    def state(self, name):
        """The deployment's status as the store file holds it (the file
        ``sdctl get`` reads), polled without a process per look."""
        try:
            with open(os.path.join(self.store, f"default__{name}.json")) as f:
                return json.load(f).get("status") or {}
        except (OSError, ValueError):
            return {}

    def wait(self, name, cond, what, timeout=300.0):
        t0 = time.monotonic()
        while True:
            st = self.state(name)
            if cond(st):
                return time.monotonic() - t0
            if self.proc.poll() is not None:
                raise AssertionError(f"[controlplane] the controller exited: {self.tail()}")
            if time.monotonic() - t0 > timeout:
                raise AssertionError(f"[controlplane] timed out waiting for {name} {what}: "
                                     f"{st}; {self.tail()}")
            time.sleep(0.05)

    def members(self, name=None):
        out = [m for m in map(_cp_member, _cp_children(self.proc.pid)) if m is not None]
        return [m for m in out if name is None or m["deployment"] == f"default-{name}"]

    def predict(self, name, body, headers=None, timeout=600.0):
        return _post(self.gw_port, body, timeout=timeout, headers=headers,
                     path=f"/seldon/default/{name}/api/v0.1/predictions")

    def tail(self, n=3000):
        return self.log_text()[-n:]

    def log_text(self):
        if not self.logf.closed:
            self.logf.flush()
        with open(self.log_path) as f:
            return f.read()

    def stop(self):
        """SIGTERM: the controller stops every member it started, then
        exits; anything left behind is killed."""
        kids = _cp_children(self.proc.pid) if self.proc.poll() is None else []
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(30)
        left = [k for k in kids if os.path.exists(f"/proc/{k}")]
        for k in left:
            try:
                os.kill(k, signal.SIGKILL)
            except OSError:
                pass
        self.logf.close()
        return left


def _cp_deployment(name, model_dir, params, annotations=None, replicas=1, predictors=None):
    graph = {"name": "llm", "implementation": "GENERATE_SERVER", "modelUri": model_dir,
             "parameters": params}
    return {"apiVersion": "machinelearning.seldon.io/v1alpha2", "kind": "SeldonDeployment",
            "metadata": {"name": name},
            "spec": {"predictors": predictors or [{
                "name": "main", "replicas": replicas, "annotations": annotations or {},
                "graph": graph}]}}


def _cp_tokens(tag, status, body):
    if status != 200:
        raise AssertionError(f"[controlplane] {tag}: HTTP {status} {body}")
    return body["jsonData"]["tokens"][0]


def _cp_sampler(period=0.25):
    """nvidia-smi's memory.used sampled on a thread until the returned
    stop() is called; stop() gives the peak in MiB."""
    peak = {"mib": _smi_used()}
    done = threading.Event()

    def loop():
        while not done.wait(period):
            try:
                peak["mib"] = max(peak["mib"], _smi_used())
            except Exception:  # noqa: BLE001 - a missed sample
                pass

    t = threading.Thread(target=loop, daemon=True)
    t.start()

    def stop():
        done.set()
        t.join(10)
        return peak["mib"]
    return stop


def phase_controlplane(card, serve_alone):
    """The control plane on the card: the port's ``sdctl`` applies
    SeldonDeployments to ``sdctl controller --subprocess-runtime`` (its
    engines are ``seldon_core_tpu_torch.engine_main`` children) and the
    gateway answers. (a) llm-1.26b at full width and depth (bf16, seed 0):
    apply -> Available, greedy requests alone through the gateway equal to
    the serve phase's alone tokens, the member on the card (its /fleet:
    CUDA memory, the flash kernel's launches) with no device passed, the
    gateway's overhead against the member's own port (ABBA); (b) an
    annotation change: create-before-delete, two generations on the card,
    a client sending requests throughout, every one 200 with its tokens;
    (c) at llm-1.26b's widths and CP_SMALL_LAYERS layers: seldon.io/disagg
    (one prefill, one decode member) equal to the unified deployment,
    ``sdctl scale`` 2 -> 1 with requests in flight on both members drained
    over /drain and completing with their tokens, and a shadow rollout on
    an in-process controller (``sdctl controller``) promoted with no token
    diff; (d) ``sdctl delete``: no member left, the card's memory back.
    Returns the flash kernel's launches in (a)'s member over (a)'s
    requests."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.client import SeldonClient
    from seldon_core_tpu_torch.rollout import diff_responses

    t_phase = time.perf_counter()
    probe, mixed = serve_waves()
    prompts = {label: toks for label, toks, _t, _s in probe + mixed}
    body = {label: _gen_body(prompts[label]) for label in CP_LABELS}
    mem0 = _smi_used()
    ctls = []
    with tempfile.TemporaryDirectory(prefix="chip-smoke-cp-") as root:
        full = os.path.join(root, "llm-1.26b")
        small = os.path.join(root, f"llm-1.26b-{CP_SMALL_LAYERS}l")
        for d, cfg in ((full, LLM_1_26B), (small, {**LLM_1_26B, "n_layers": CP_SMALL_LAYERS})):
            os.makedirs(d)
            with open(os.path.join(d, "jax_config.json"), "w") as f:
                json.dump({"family": "llm", "config": cfg}, f)
        try:
            if serve_alone is None:
                # run alone: the serve phase's alone tokens from an
                # in-process server with its parameters
                ref_server = _gen_server(full)
                try:
                    serve_alone = {label: ref_server.predict(body[label]["jsonData"], [])[
                        "tokens"][0] for label in CP_LABELS}
                finally:
                    ref_server.close()
                    del ref_server
                    gc.collect()
                    torch.cuda.empty_cache()
                mem0 = _smi_used()
            sub = _Controller(root, "sub", subprocess_runtime=True)
            ctls.append(sub)

            # -- (a) apply -> Available, requests through the gateway
            t = time.perf_counter()
            sub.apply(root, _cp_deployment("cp-llm", full, CP_PARAMS))
            avail_s = sub.wait("cp-llm", lambda st: st.get("state") == "Available",
                               "Available")
            apply_s = time.perf_counter() - t
            shown = json.loads(sub.sdctl("get", "cp-llm"))["status"]
            if shown["state"] != "Available" or shown["predictorStatus"][0]["replicasAvailable"] != 1:
                raise AssertionError(f"[controlplane] sdctl get cp-llm: {shown}")
            (member,) = sub.members("cp-llm")
            if member["cmd"][1:3] != ["-m", "seldon_core_tpu_torch.engine_main"]:
                raise AssertionError(f"[controlplane] the member is not the port's engine: "
                                     f"{member['cmd']}")
            params = member["spec"]["graph"].get("parameters") or []
            if any(p["name"] == "device" for p in params):
                raise AssertionError(f"[controlplane] a device was passed: {params}")
            _s, fleet0 = _get(member["port"], "/fleet")
            n0 = fleet0["device"]["kernel_launches"]["flash_attention"]
            got, client_ms = {}, []
            # the first request through the port's SeldonClient
            client = SeldonClient(deployment_name="cp-llm",
                                  gateway_endpoint=f"127.0.0.1:{sub.gw_port}", timeout_s=600)
            for label in CP_LABELS:
                t = time.perf_counter()
                if label == CP_LABELS[0]:
                    r = client.predict(json_data=body[label]["jsonData"])
                    got[label] = _cp_tokens(f"{label} (SeldonClient)",
                                            200 if r.success else r.msg, r.response)
                else:
                    got[label] = _cp_tokens(label, *sub.predict("cp-llm", body[label]))
                client_ms.append((time.perf_counter() - t) * 1e3)
            _s, fleet1 = _get(member["port"], "/fleet")
            dev = fleet1["device"]
            launches = dev["kernel_launches"]["flash_attention"] - n0
            bad = [label for label in CP_LABELS if got[label] != serve_alone[label]]
            if bad:
                raise AssertionError(f"[controlplane] (a) tokens through sdctl/the gateway differ "
                                     f"from the serve phase's alone tokens: {bad}")
            if dev["memory_allocated"] <= 0 or dev["name"] != torch.cuda.get_device_name(0):
                raise AssertionError(f"[controlplane] (a) the member is not on the card: {dev}")
            if launches < len(CP_LABELS):
                raise AssertionError(f"[controlplane] (a) {launches} flash launches for "
                                     f"{len(CP_LABELS)} prefills")
            one = _gen_body(prompts["greedy_20"], max_new=1)
            pairs = {"gateway": [], "member": []}
            for i in range(4):
                order = ("gateway", "member") if i % 2 == 0 else ("member", "gateway")
                for side in order:
                    t = time.perf_counter()
                    if side == "gateway":
                        _cp_tokens("1-token", *sub.predict("cp-llm", one))
                    else:
                        _cp_tokens("1-token", *_post(member["port"], one,
                                                     path="/api/v0.1/predictions"))
                    pairs[side].append((time.perf_counter() - t) * 1e3)
            gw_ms, mem_ms = (float(np.median(pairs[k])) for k in ("gateway", "member"))
            log(f"[controlplane] (a) sdctl apply -> Available {apply_s:.1f} s (store file "
                f"polled every 50 ms: {avail_s:.1f} s after the apply returned); the member "
                f"is seldon_core_tpu_torch.engine_main pid {member['pid']} on {dev['name']} with "
                f"no device parameter, {dev['memory_allocated'] / 2**30:.2f} GiB allocated, peak "
                f"{dev['max_memory_allocated'] / 2**30:.2f} GiB; {len(CP_LABELS)} greedy "
                f"requests alone through the gateway ({CP_LABELS[0]} through SeldonClient) "
                f"equal the serve phase's alone tokens ({', '.join(CP_LABELS)}), client ms "
                f"{', '.join(f'{x:.1f}' for x in client_ms)}; flash launches {launches}; a "
                f"1-token request median of 4 (ABBA): gateway {gw_ms:.2f} ms, member port "
                f"{mem_ms:.2f} ms, gateway overhead {gw_ms - mem_ms:.2f} ms [{card}]")

            # -- (b) rolling update: an annotation change under traffic
            results, stop_client = [], threading.Event()

            def client():
                i = 0
                while not stop_client.is_set():
                    label = CP_LABELS[i % len(CP_LABELS)]
                    i += 1
                    t0 = time.perf_counter()
                    try:
                        status, out = sub.predict("cp-llm", body[label])
                    except Exception as e:  # noqa: BLE001 - recorded, fails below
                        status, out = None, repr(e)
                    results.append((label, t0, time.perf_counter(), status, out))

            sampler = _cp_sampler()
            thread = threading.Thread(target=client, daemon=True)
            thread.start()
            _wait_for(lambda: len(results) >= 2, "(b) traffic before the flip", 120)
            old_pid = member["pid"]
            t_apply = time.perf_counter()
            sub.apply(root, _cp_deployment("cp-llm", full, CP_PARAMS,
                                           annotations={"seldon.io/drain-seconds": "30"}))
            _wait_for(lambda: len(sub.members("cp-llm")) == 2, "(b) the second generation", 300)
            t_both = time.perf_counter()
            _wait_for(lambda: not os.path.exists(f"/proc/{old_pid}")
                      or old_pid not in _cp_children(sub.proc.pid), "(b) the old member's exit",
                      300)
            t_old_gone = time.perf_counter()
            n_at_flip = len(results)
            _wait_for(lambda: len(results) >= n_at_flip + 2, "(b) traffic after the flip", 120)
            stop_client.set()
            thread.join(600)
            peak_mib = sampler()
            sub.wait("cp-llm", lambda st: st.get("state") == "Available", "Available after (b)")
            (new_member,) = sub.members("cp-llm")
            _s, fleet_new = _get(new_member["port"], "/fleet")
            failed = [(label, st, str(out)[:200]) for label, _a, _b, st, out in results
                      if st != 200 or out["jsonData"]["tokens"][0] != serve_alone[label]]
            if failed:
                raise AssertionError(f"[controlplane] (b) requests across the rolling update "
                                     f"failed or changed tokens: {failed[:4]}")
            across = sum(1 for _l, a, b, _s, _o in results if b > t_apply and a < t_old_gone)
            log(f"[controlplane] (b) annotation change -> create-before-delete: the new member "
                f"(pid {new_member['pid']}) started {t_both - t_apply:.1f} s after the apply, "
                f"the old one (pid {old_pid}) gone {t_old_gone - t_apply:.1f} s after it (the "
                f"flip); {len(results)} requests sent back to back, {across} of them in flight "
                f"during the flip, all 200 with their alone tokens; the card's memory.used peak "
                f"{peak_mib / 1024:.2f} GiB with two generations (phase start "
                f"{mem0 / 1024:.2f} GiB), the new member's peak allocated "
                f"{fleet_new['device']['max_memory_allocated'] / 2**30:.2f} GiB [{card}]")

            # -- (c) annotation paths at CP_SMALL_LAYERS layers
            inproc = _Controller(root, "inproc", subprocess_runtime=False)
            ctls.append(inproc)
            t = time.perf_counter()
            sub.apply(root, _cp_deployment(
                "cp-unified", small, CP_SMALL_PARAMS, replicas=2,
                annotations={"seldon.io/drain-seconds": "120"}))
            sub.apply(root, _cp_deployment(
                "cp-disagg", small, CP_SMALL_PARAMS, annotations={
                    "seldon.io/disagg": "true", "seldon.io/disagg-prefill-replicas": "1",
                    "seldon.io/disagg-decode-replicas": "1"}))
            shadow_ann = {"seldon.io/shadow": "true", "seldon.io/rollout": "shadow",
                          "seldon.io/rollout-steps": "1", "seldon.io/rollout-interval-s": "2",
                          "seldon.io/rollout-min-samples": "3"}
            graph = {"name": "llm", "implementation": "GENERATE_SERVER", "modelUri": small,
                     "parameters": CP_SMALL_PARAMS}
            inproc.apply(root, _cp_deployment("cp-shadow", small, CP_SMALL_PARAMS, predictors=[
                {"name": "baseline", "traffic": 100, "graph": graph},
                {"name": "canary", "annotations": shadow_ann, "graph": graph}]))
            for c, name in ((sub, "cp-unified"), (sub, "cp-disagg"), (inproc, "cp-shadow")):
                c.wait(name, lambda st: st.get("state") == "Available", "Available")
            boot_s = time.perf_counter() - t
            roles = sorted(p["value"] for mm in sub.members("cp-disagg")
                           for p in mm["spec"]["graph"]["parameters"] if p["name"] == "role")
            if roles != ["decode", "prefill"]:
                raise AssertionError(f"[controlplane] (c) disagg roles {roles}")
            uni, dis = {}, {}
            for label in CP_LABELS:
                uni[label] = _cp_tokens(label, *sub.predict("cp-unified", body[label]))
                dis[label] = _cp_tokens(label, *sub.predict("cp-disagg", body[label]))
            if dis != uni:
                raise AssertionError(f"[controlplane] (c) disagg != unified: "
                                     f"{[k for k in uni if dis[k] != uni[k]]}")
            (dec,) = [mm for mm in sub.members("cp-disagg")
                      if any(p["value"] == "decode" for p in mm["spec"]["graph"]["parameters"]
                             if p["name"] == "role")]
            _s, fleet_dec = _get(dec["port"], "/fleet")
            imports = sum(c["value"] for c in fleet_dec["metrics"]["counters"].get(
                "seldon_engine_kv_transfer_slabs", []) if c["labels"].get("direction") == "import")
            if imports < len(CP_LABELS):
                raise AssertionError(f"[controlplane] (c) the decode member imported {imports} "
                                     f"KV slabs for {len(CP_LABELS)} requests")
            log(f"[controlplane] (c) cp-unified (2 members), cp-disagg (prefill + decode) and "
                f"the in-process controller's cp-shadow Available {boot_s:.1f} s after the "
                f"applies (llm-1.26b widths, {CP_SMALL_LAYERS} of 24 layers, bf16); disagg == "
                f"unified token for token on {len(CP_LABELS)} greedy prompts; the decode "
                f"member imported {imports:.0f} KV slabs [{card}]")

            # scale 2 -> 1 with requests in flight on both members
            drain_body = _gen_body(prompts["greedy_20"], max_new=CP_DRAIN_NEW)
            t = time.perf_counter()
            want = _cp_tokens("drain ref", *sub.predict("cp-unified", drain_body))
            one_s = time.perf_counter() - t
            # a queue of >= 3 s on each member: in flight when the scale
            # lands (sdctl's process, the store rescan, then the drain)
            per_member = max(2, min(8, math.ceil(3.0 / max(one_s, 1e-3))))
            members = sub.members("cp-unified")
            if len(members) != 2:
                raise AssertionError(f"[controlplane] (c) cp-unified has {len(members)} members")
            out, threads = [], []
            for mm in members:
                for _ in range(per_member):
                    th = threading.Thread(target=lambda p=mm["port"]: out.append(
                        _post(p, drain_body, path="/api/v0.1/predictions")), daemon=True)
                    th.start()
                    threads.append(th)

            def inflight(mm):
                _s, b = _get(mm["port"], "/inflight")
                return b["inflight"]

            _wait_for(lambda: all(inflight(mm) >= per_member for mm in members),
                      "(c) requests in flight on both members", 60)
            t = time.perf_counter()
            sub.sdctl("scale", "cp-unified", "1")
            _wait_for(lambda: len(sub.members("cp-unified")) == 1, "(c) the scale-down", 300)
            scale_s = time.perf_counter() - t
            for th in threads:
                th.join(600)
            bad = [(st, str(b)[:200]) for st, b in out
                   if st != 200 or b["jsonData"]["tokens"][0] != want]
            if len(out) != 2 * per_member or bad:
                raise AssertionError(f"[controlplane] (c) scale-down: {len(out)} of "
                                     f"{2 * per_member} answered, failed {bad[:3]}")
            drained = re.findall(r"drained (\d+) in-flight generation\(s\) to \S+ over /drain "
                                 r"in ([0-9.]+) ms", sub.log_text())
            if not drained or int(drained[-1][0]) < 1:
                raise AssertionError(f"[controlplane] (c) no drain over /drain: {sub.tail()}")
            log(f"[controlplane] (c) sdctl scale cp-unified 2 -> 1 with {per_member} requests of "
                f"{CP_DRAIN_NEW} tokens queued on each member (one alone took {one_s:.2f} s): "
                f"the removed member drained {drained[-1][0]} generation(s) over /drain in "
                f"{float(drained[-1][1]):.1f} ms, member gone {scale_s:.1f} s after the scale; "
                f"all {len(out)} requests 200 with the alone tokens [{card}]")

            # shadow rollout on the in-process controller
            sent = 0
            t = time.perf_counter()
            short = {label: _gen_body(prompts[label], max_new=16) for label in CP_LABELS}
            while True:
                _cp_tokens("shadow", *inproc.predict("cp-shadow", short[CP_LABELS[sent % 3]]))
                sent += 1
                phase = (inproc.state("cp-shadow").get("rollout") or {}).get("phase")
                if phase not in (None, "ramping"):
                    break
                if time.perf_counter() - t > 120:
                    raise AssertionError("[controlplane] (c) the shadow rollout never ended")
            if phase != "promoted":
                raise AssertionError(f"[controlplane] (c) shadow rollout {phase}: "
                                     f"{inproc.tail()}")
            base = inproc.predict("cp-shadow", body["greedy_128"])
            cand = inproc.predict("cp-shadow", body["greedy_128"],
                                  headers={"seldon-predictor": "canary"})
            diff = diff_responses(base[1], cand[1])
            if base[0] != 200 or cand[0] != 200 or diff["diverged"] or diff["mismatch_tokens"]:
                raise AssertionError(f"[controlplane] (c) baseline vs canary: {diff}")
            log(f"[controlplane] (c) shadow rollout (in-process controller, both predictors "
                f"on the card): promoted after {sent} requests mirrored to the canary "
                f"({time.perf_counter() - t:.1f} s; a 2 s window of >= 3 mirrored samples, no "
                f"divergence); diff_responses(baseline, canary) on greedy_128: "
                f"{diff['mismatch_tokens']} token diffs [{card}]")

            # -- (d) teardown
            pids = [mm["pid"] for mm in sub.members()]
            t = time.perf_counter()
            for c, names in ((sub, ("cp-llm", "cp-unified", "cp-disagg")),
                             (inproc, ("cp-shadow",))):
                for name in names:
                    c.sdctl("delete", name)
            _wait_for(lambda: not sub.members(), "(d) the members' exit", 120)
            delete_s = time.perf_counter() - t
            left = [c.stop() for c in ctls]
            ctls = []
            alive = [p for p in pids if os.path.exists(f"/proc/{p}")]
            mem_end = _smi_used()
            if any(left) or alive or mem_end > mem0 + 1024:
                raise AssertionError(f"[controlplane] (d) members left {left} {alive}, "
                                     f"memory.used {mem_end} MiB vs {mem0} MiB at the start")
            log(f"[controlplane] (d) sdctl delete: all {len(pids)} members gone "
                f"{delete_s:.1f} s after the deletes, both controllers stopped; the card's "
                f"memory.used {mem_end / 1024:.2f} GiB (phase start {mem0 / 1024:.2f} GiB) "
                f"[{card}]")
        except BaseException:
            for c in ctls:  # the members' side of the failure
                log(f"[controlplane] {os.path.basename(c.log_path)} (tail):\n{c.tail(12000)}")
            raise
        finally:
            for c in ctls:
                c.stop()
    log(f"[controlplane] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# the tools phase: the user's tools against engines on the card
TOOLS_SECONDS = 3.0
TOOLS_WORKERS, TOOLS_CLIENTS = 2, 4
# the zoo's micro-batching without its admission cap: the load tester
# counts a 429 as a failure (it has no backoff)
TOOLS_RESNET_ANN = {k: v for k, v in ZOO_RESNET_ANN.items() if k != "seldon.io/max-inflight"}
TOOLS_MLP = dict(ZOO_MLP, dtype="float32")
TOOLS_ROWS, TOOLS_BATCH_ROWS, TOOLS_CONCURRENCY = 256, 8, 16
TOOLS_NAMES = ["sepal_length", "sepal_width", "petal_length", "petal_width"]
TOOLS_CONTRACT = {
    "features": [{"name": n, "ftype": "continuous", "dtype": "FLOAT", "range": [0.1, 7.9]}
                 for n in TOOLS_NAMES],
    "targets": [{"name": "proba", "ftype": "continuous", "dtype": "FLOAT", "range": [0, 1],
                 "shape": [3]}],
}


def _tools_load(card, tag, target, body_path, rows_per_request):
    """``python -m seldon_core_tpu_torch.loadtester`` as a process of its own
    (its workers fork; this process holds a CUDA context and server
    threads) against ``target`` for TOOLS_SECONDS: its stats, checked for
    no failure, its table printed."""
    from seldon_core_tpu_torch.loadtester import format_table

    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "seldon_core_tpu_torch.loadtester", target,
           "--workers", str(TOOLS_WORKERS), "--clients-per-worker", str(TOOLS_CLIENTS),
           "--seconds", str(TOOLS_SECONDS), "--binary", "--body-file", body_path,
           "--timeout", "120", "--json"]
    proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True, text=True,
                          timeout=TOOLS_SECONDS + 300)
    if proc.returncode != 0:
        raise AssertionError(f"[tools] {tag}: the load tester exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    if stats["failures"] or not stats["requests"]:
        raise AssertionError(f"[tools] {tag}: {stats['requests']} requests, "
                             f"{stats['failures']} failures")
    for line in format_table(stats).splitlines():
        log(f"[tools] {tag} | {line}")
    rows_s = stats["rps"] * rows_per_request
    log(f"[tools] {tag}: {stats['requests']} requests, 0 failures, {stats['rps']:.2f} req/s = "
        f"{rows_s:.1f} rows/s ({rows_per_request} rows a request; the load tester's wall time "
        f"includes its workers' start) [{card}]")
    return stats, rows_s


def _tools_client(card, mlp_port, mlp_gport, grpc_ok):
    """(a) The tester fuzzes the MLP from a contract; SeldonClient over REST
    (and gRPC) against a plain HTTP call."""
    import numpy as np

    from seldon_core_tpu_torch.client import SeldonClient
    from seldon_core_tpu_torch.tester import run_contract_test

    rest = SeldonClient(engine_endpoint=f"127.0.0.1:{mlp_port}", timeout_s=120)
    t = time.perf_counter()
    summary = run_contract_test(rest, TOOLS_CONTRACT, n_requests=16, batch_size=4,
                                external=True, seed=0)
    if summary["ok"] != 16 or summary["failed"]:
        raise AssertionError(f"[tools] (a) the contract test failed: {summary}")
    log(f"[tools] (a) tester: 16 contract-generated requests of 4 rows (seed 0) through the "
        f"MLP engine, every response inside the contract's targets, in "
        f"{time.perf_counter() - t:.2f} s: {summary}")
    X = np.random.RandomState(3).uniform(0.1, 7.9, (4, 4)).round(2)
    status, plain = _post(mlp_port, {"data": {"names": TOOLS_NAMES, "ndarray": X.tolist()}},
                          path="/api/v0.1/predictions")
    got = rest.predict(X, names=TOOLS_NAMES)
    if status != 200 or not got.success or got.response["data"] != plain["data"]:
        raise AssertionError(f"[tools] (a) SeldonClient REST {got.msg or got.response} != "
                             f"plain HTTP {status} {plain}")
    line = "SeldonClient REST == a plain HTTP call (4 rows, the same data block)"
    if grpc_ok:
        g = SeldonClient(engine_endpoint=f"127.0.0.1:{mlp_gport}", transport="grpc",
                         timeout_s=120).predict(X, names=TOOLS_NAMES)
        if not g.success or not np.array_equal(g.data, np.asarray(plain["data"]["ndarray"])):
            raise AssertionError(f"[tools] (a) SeldonClient gRPC {g.msg or g.response} != "
                                 f"plain HTTP {plain}")
        line += "; SeldonClient gRPC Seldon/Predict == the same"
    else:
        line += "; gRPC not driven (import grpc, google.protobuf failed on this machine)"
    log(f"[tools] (a) {line} [{card}]")


def _tools_batch(card, root, mlp_port):
    """(c) The batch scorer over TOOLS_ROWS MLP rows fused TOOLS_BATCH_ROWS a
    request: one line per row in input order, each row equal to the same
    row scored alone."""
    import numpy as np

    from seldon_core_tpu_torch.batch import BatchScorer, fuse_rows, read_records

    rows = np.random.RandomState(11).uniform(0.1, 7.9, (TOOLS_ROWS, 4)).round(3)
    path = os.path.join(root, "rows.jsonl")
    with open(path, "w") as f:
        for r in rows.tolist():
            f.write(json.dumps(r) + "\n")

    def score(batch_rows):
        out = io.StringIO()
        scorer = BatchScorer(f"http://127.0.0.1:{mlp_port}", concurrency=TOOLS_CONCURRENCY,
                             timeout_s=120)
        t = time.perf_counter()
        with open(path) as f:
            stats = asyncio.run(scorer.run(fuse_rows(read_records(f, "jsonl"), batch_rows), out))
        return stats, [json.loads(x) for x in out.getvalue().splitlines()], \
            time.perf_counter() - t

    with _exact_f32():
        stats, fused, fused_s = score(TOOLS_BATCH_ROWS)
        stats1, alone, alone_s = score(1)
    want = {"requests": TOOLS_ROWS // TOOLS_BATCH_ROWS, "rows": TOOLS_ROWS, "failures": 0}
    if stats != want or stats1 != {"requests": TOOLS_ROWS, "rows": TOOLS_ROWS, "failures": 0}:
        raise AssertionError(f"[tools] (c) batch scorer stats {stats} / alone {stats1}")
    if [r["index"] for r in fused] != list(range(TOOLS_ROWS)):
        raise AssertionError("[tools] (c) the output is not in input order")
    a = np.asarray([r["response"]["data"]["ndarray"][0] for r in fused], dtype=np.float64)
    b = np.asarray([r["response"]["data"]["ndarray"][0] for r in alone], dtype=np.float64)
    err = float(np.abs(a - b).max() / np.abs(b).max())
    exact = int((a == b).all(axis=1).sum())
    log(f"[tools] (c) batch scorer: {TOOLS_ROWS} MLP rows, --batch-rows {TOOLS_BATCH_ROWS}, "
        f"concurrency {TOOLS_CONCURRENCY}: {stats['requests']} requests in {fused_s:.2f} s "
        f"({TOOLS_ROWS / fused_s:.1f} rows/s), one line per row in input order; each row "
        f"against the same row scored alone ({alone_s:.2f} s): max relative |dp| {err:.3e} "
        f"(tol {ZOO_F32_TOL}), {exact} of {TOOLS_ROWS} bit-identical [{card}]")
    if err > ZOO_F32_TOL:
        raise AssertionError("[tools] (c) fused rows differ from the same rows alone")


def _tools_native(card, root, mlp_dir):
    """(d) The native engine fronting the port's microservice (the MLP on
    the card) as a remote REST unit, against the port's Python engine on
    the same spec: the same answers, and the load tester against both."""
    import numpy as np

    from seldon_core_tpu_torch import microservice, native_engine

    missing = native_engine.missing_toolchain()
    if missing:
        log(f"[tools] (d) native engine: not driven, this machine lacks {', '.join(missing)} "
            "(probed before any build)")
        return
    t = time.perf_counter()
    native_engine.build()
    log(f"[tools] (d) native engine built from native/ into build/native/ in "
        f"{time.perf_counter() - t:.1f} s: {native_engine.version()}")
    user = microservice.build_user_object(
        "seldon_core_tpu_torch.servers.torchserver.TorchServer", json.dumps([
            {"name": "model_uri", "value": mlp_dir, "type": "STRING"},
            {"name": "device", "value": ZOO_DEVICE, "type": "STRING"}]))
    user.load()
    (mport,), stop_micro = _serve_micro([user])
    graph = {"name": "mlp", "type": "MODEL", "endpoint": {
        "service_host": "127.0.0.1", "service_port": mport, "transport": "REST"}}
    py_app = _zoo_engine(graph)
    (py_port,), _g, stop_py = _zoo_serve([py_app])
    nport = _free_port()
    # start() returns once the port listens (or raises)
    eng = native_engine.NativeEngine({"name": "tools", "graph": graph}, port=nport).start()
    try:
        rs = np.random.RandomState(5)
        for n in (1, 3, 8):
            body = {"data": {"ndarray": rs.uniform(0.1, 7.9, (n, 4)).round(2).tolist()}}
            s_n, got = _post(nport, body, path="/api/v0.1/predictions")
            s_p, want = _post(py_port, body, path="/api/v0.1/predictions")
            if s_n != 200 or s_p != 200 or got["data"] != want["data"]:
                raise AssertionError(f"[tools] (d) native {s_n} {got} != Python engine {s_p} "
                                     f"{want}")
        log("[tools] (d) native engine == the port's Python engine on the same spec (a remote "
            "REST unit: the MLP behind the port's microservice), 3 requests of 1, 3, 8 rows")
        path = os.path.join(root, "mlp-body.json")
        with open(path, "w") as f:
            json.dump({"data": {"ndarray": rs.uniform(0.1, 7.9, (8, 4)).round(2).tolist()}}, f)
        _s, native_rows = _tools_load(card, "(d) load, native engine", f"http://127.0.0.1:{nport}",
                                      path, 8)
        _s, py_rows = _tools_load(card, "(d) load, Python engine", f"http://127.0.0.1:{py_port}",
                                  path, 8)
        log(f"[tools] (d) rows/s over {TOOLS_SECONDS:.0f} s each: native engine {native_rows:.1f}, "
            f"Python engine {py_rows:.1f} (the same microservice behind both) [{card}]")
    finally:
        eng.stop()
        stop_py()
        stop_micro()


def phase_tools(card):
    """The user's tools against the port's engines on the card: (a) the
    tester and SeldonClient on the float32 MLP, (b) the load tester as a
    process of its own against ResNet-50 (bf16, micro-batched), (c) the
    batch scorer on the MLP, (d) the native engine where it can be built.
    Returns the flash kernel's launches over the phase (no model here runs
    it)."""
    import base64

    import numpy as np
    import torch

    from seldon_core_tpu_torch.graph.engine_metrics import MICROBATCH_FLUSHES, MICROBATCH_ROWS
    from seldon_core_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    fa.LAUNCHES["flash_attention"] = 0
    grpc_ok = _grpc_available()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-tools-") as root:
        t = time.perf_counter()
        rn_app = _zoo_engine(_zoo_unit("resnet", _zoo_dir(root, "resnet50", ZOO_RESNET)),
                             TOOLS_RESNET_ANN)
        rn_server = rn_app.executor.root.client.inner.user_object
        size = ZOO_RESNET["image_size"]
        sizes = _warm_buckets(rn_server, ZOO_RESNET_BATCH, 128, (size, size, 3), np.uint8)
        mlp_dir = _zoo_dir(root, "mlp", TOOLS_MLP, "-f32")
        mlp_app = _zoo_engine(_zoo_unit("mlp", mlp_dir))
        if rn_server.device.type != "cuda" and ZOO_DEVICE == "cuda":
            raise AssertionError(f"[tools] resnet50 on {rn_server.device}")
        log(f"[tools] engines: ResNet-50 (bf16, {size}x{size}, micro-batched, warmed at batch "
            f"{sizes}) and the iris MLP (float32) loaded in {time.perf_counter() - t:.1f} s")
        (rn_port, mlp_port), mlp_gport, stop = _zoo_serve(
            [rn_app, mlp_app], mlp_app if grpc_ok else None)
        try:
            _tools_client(card, mlp_port, mlp_gport, grpc_ok)
            imgs = _synthetic_images(ZOO_RESNET_BATCH, size, seed=60)
            body_path = os.path.join(root, "resnet-body.json")
            with open(body_path, "w") as f:
                json.dump({"data": {"raw": {"dtype": "uint8", "shape": list(imgs.shape),
                                            "data": base64.b64encode(imgs.tobytes()).decode()}}},
                          f)
            m = rn_app.metrics
            c0 = [m.counter_total(x) for x in (MICROBATCH_FLUSHES, MICROBATCH_ROWS)]
            _tools_load(card, "(b) load, ResNet-50 REST --binary", f"http://127.0.0.1:{rn_port}",
                        body_path, ZOO_RESNET_BATCH)
            flushes, rows = (m.counter_total(x) - c for x, c in zip(
                (MICROBATCH_FLUSHES, MICROBATCH_ROWS), c0))
            if flushes <= 0:
                raise AssertionError("[tools] (b) no micro-batch flush under the load tester")
            log(f"[tools] (b) the engine's micro-batcher over the load: {flushes:.0f} flushes, "
                f"{rows / flushes:.1f} rows per flush ({TOOLS_WORKERS} workers x "
                f"{TOOLS_CLIENTS} clients of {ZOO_RESNET_BATCH} images) [{card}]")
            _tools_batch(card, root, mlp_port)
        finally:
            stop()
        del rn_app, rn_server, mlp_app
        gc.collect()
        torch.cuda.empty_cache()
        _tools_native(card, root, mlp_dir)
    torch.cuda.synchronize()
    launches = fa.LAUNCHES["flash_attention"]
    log(f"[tools] flash kernel launches over the phase: {launches} (no model here runs it); "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    return launches


PHASES = ("kernels", "small", "serve", "engine", "small-sched", "sched", "prefix",
          "pressure", "spec", "spec-pressure", "dh256", "f32", "disagg", "kvtier", "migration",
          "telemetry", "fronts", "zoo", "rag", "model", "explain", "moe", "train",
          "controlplane", "tools", "mesh", "predict-mesh")


# the mesh phase: llm-1.26b stored split over a data=1, model=4 serving
# mesh whose every position is cuda:0 (the layout a 4-card cell would
# use), beside an unsharded twin with the same knobs. pipeline_depth 1:
# the host reads every burst in the poll that dispatched it, so both
# servers take the same scheduling decisions under the same traffic
MESH_CARD_SHAPE = {"data": 1, "model": 4}
MESH_KNOBS = dict(
    slots=8, steps_per_poll=16, pipeline_depth=1, warmup_prompt_lens=list(WARM_LENS),
    warmup_max_new_tokens=MAX_NEW, fused_steps_per_dispatch=64,
    prefix_cache_hbm_bytes=2 << 30, prefix_cache_min_tokens=64, prefill_chunk=256,
    hbm_ledger_bytes=1 << 40,
)
# the requests alone that equal the serve phase's (no chunk: bucket <= 256,
# no prefix hit: the first time each prompt is seen)
MESH_ALONE = ("greedy_20", "seeded_20", "greedy_128")


def _mesh_requests(server, gate, probe, mixed, shrink):
    """One server's traffic of the mesh phase, every request alone but
    the pressure wave: (a) ``MESH_ALONE``; (b) a prefix splice (a
    100-token stem, then two prompts extending it: suffix prefills
    spliced over the cached stem) and a chunked splice (a 300-token stem
    chunked at 256, then a prompt extending it), the chunked seeded_500,
    and the mixed wave queued whole under a
    24-poll ledger shrink to ``shrink`` bytes. Returns the tokens by
    label and the counters' deltas."""
    import numpy as np

    from seldon_core_tpu_torch.resilience import FaultInjector

    b = server.batcher
    rs = np.random.RandomState(5)
    vocab = LLM_1_26B["vocab_size"]
    s100, s300 = rs.randint(0, vocab, 100).tolist(), rs.randint(0, vocab, 300).tolist()
    by = {x[0]: x for x in probe + mixed}
    items = [by[label] for label in MESH_ALONE] + [
        ("stem_100", s100, 0.0, 0), ("stem_100+20", s100 + rs.randint(0, vocab, 20).tolist(),
                                     0.0, 0),
        ("stem_100+60", s100 + rs.randint(0, vocab, 60).tolist(), 0.8, 5),
        ("stem_300", s300, 0.0, 0), ("stem_300+80", s300 + rs.randint(0, vocab, 80).tolist(),
                                     0.0, 0),
        by["seeded_500"]]
    s0 = dict(b.stats)
    out = _alone(server, items)
    b.pressure_hook = FaultInjector([], pressure={
        "shrink_to_bytes": shrink, "after_polls": b._work_poll_count + 3,
        "restore_after_polls": 24}).pressure_hook()
    futs = gate.submit_together(b, [(toks, temp, seed, None) for _l, toks, temp, seed in mixed])
    out.update({"pressure_" + label: f.result(timeout=600)
                for (label, *_r), f in zip(mixed, futs)})
    keys = ("prefix_hits", "prefill_chunks", "fused_dispatches", "preemptions",
            "preempt_resumes", "replayed_tokens", "prefill_steps")
    return out, {k: b.stats[k] - s0[k] for k in keys}


def _mesh_step_ms(server, attn_len):
    """One 8-row decode step over ``server``'s cache at ``attn_len``: its
    wall time eager (CUDA events around 3 calls: host-bound) and its
    device time from a CUDA graph of 2 steps; the lanes are idle, so the
    positions it writes are residue."""
    import torch

    b = server.batcher
    tok = torch.zeros((b.slots, 1), dtype=torch.long, device="cuda")
    pos = torch.full((b.slots,), attn_len - 8, dtype=torch.long, device="cuda")

    def step():
        b.model.decode_step_ragged_list(b.params, b._cache["k"], b._cache["v"], tok, pos,
                                        attn_len=attn_len)

    with torch.inference_mode():
        return time_ms(step, iters=3, warmup=1), device_ms(step, launches=2, reps=3)


def _mesh_gather_ms(server, attn_len):
    """Device time of the gathers and re-slices alone of one sharded decode
    step: every layer's weights and its cache window gathered onto the
    compute device and the window re-sliced, no arithmetic."""
    import torch

    b = server.batcher
    model, blocks = b.model, b.params["blocks"]
    ks, vs = b._cache["k"], b._cache["v"]

    def gathers():
        for layer in range(len(ks)):
            model._layer(blocks, layer)
            ck, cv, region = model._kv_in(ks, vs, layer, attn_len)
            model._kv_out(ks, vs, layer, ck, cv, region)

    with torch.inference_mode():
        return device_ms(gathers, launches=2, reps=3)


def phase_mesh(card, serve_numbers):
    """Sharded generate serving at llm-1.26b (full width and depth, bf16,
    seed-0 weights, 8 slots) through GenerateServer on an explicit
    ServingMesh of data=1, model=4 with every position on cuda:0, beside
    an unsharded twin with the same knobs (``MESH_KNOBS``: fused K 64, a
    2 GiB prefix cache, prefill_chunk 256, the ledger). Fails unless (a)
    greedy_20, seeded_20 and greedy_128 alone equal the twin's and the
    serve phase's alone tokens; (b) two prefix splices, the chunked
    prompts and the mixed wave under a 24-poll ledger shrink (lanes
    preempted and resumed, the sharded ledger's budget a quarter of the
    twin's) equal the twin's token for token, with hits, chunks, fused
    bursts and preemptions on both; (c) no graph is captured after
    ``warm()``; (d) the census names 7 of 12 leaves split, the gen_mesh_*
    gauges say 4 positions, model 4, kv_shard 4 and the param shard
    bytes; (f) the flash kernel launches, once a layer for every
    whole-prompt prefill, as often as for the twin.
    Reports (d) beside nvidia-smi's memory.used and (e) the decode step's
    wall and device time sharded against unsharded, with the gathers'
    own device time. Returns the flash launches of the sharded server's
    traffic."""
    import logging

    import torch

    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.parallel.mesh import ServingMesh, ShardedTensor
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    probe, mixed = serve_waves()
    census = []

    class _Census(logging.Handler):
        def emit(self, record):
            if "sharded serving census" in record.getMessage():
                census.append(record.getMessage())

    cont_log = logging.getLogger("seldon_core_tpu_torch.serving.continuous")
    handler, level = _Census(), cont_log.level
    cont_log.addHandler(handler)
    cont_log.setLevel(logging.INFO)
    servers = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-mesh-") as model_dir:
        with open(os.path.join(model_dir, "jax_config.json"), "w") as f:
            json.dump({"family": "llm", "config": LLM_1_26B}, f)
        try:
            mib0 = _smi_used()
            t0 = time.perf_counter()
            mesh = ServingMesh(MESH_CARD_SHAPE, ["cuda:0"] * 4)
            servers["sharded"] = GenerateServer(model_uri=model_dir, device="cuda",
                                                mesh=mesh, **MESH_KNOBS)
            servers["sharded"].load()
            t_s = time.perf_counter() - t0
            mib_s = _smi_used()
            t0 = time.perf_counter()
            servers["unsharded"] = GenerateServer(model_uri=model_dir, device="cuda",
                                                  **MESH_KNOBS)
            servers["unsharded"].load()
            t_u = time.perf_counter() - t0
            mib_u = _smi_used()
            cont_log.removeHandler(handler)
            cont_log.setLevel(level)
            S, U = servers["sharded"], servers["unsharded"]
            sb, ub = S.batcher, U.batcher
            if sb.mesh is not mesh or not isinstance(sb._cache["k"][0], ShardedTensor) \
                    or len(sb._cache["k"][0].blocks()) != 4:
                raise AssertionError("[mesh] the sharded server's cache is not split in 4 blocks")
            log(f"[mesh] llm-1.26b on ServingMesh {mesh.shape} (every position cuda:0) loaded "
                f"and warmed in {t_s:.1f} s, the unsharded twin in {t_u:.1f} s")
            # (d) the census, the gauges and the footprint
            if not census or "devices=4" not in census[-1] or "kv_shard=4" not in census[-1] \
                    or "partitioned_params=7/12" not in census[-1]:
                raise AssertionError(f"[mesh] census {census}")
            log(f"[mesh] census: {census[-1]}")
            gauges = {d["key"]: d["value"] for d in S.metrics() if d["key"].startswith("gen_mesh_")}
            want = {"gen_mesh_devices": 4.0, "gen_mesh_data": 1.0, "gen_mesh_model": 4.0,
                    "gen_mesh_kv_shard": 4.0,
                    "gen_mesh_param_shard_bytes": float(sb._param_shard_bytes)}
            if gauges != want or sb._kv_shard != 4:
                raise AssertionError(f"[mesh] gauges {gauges}, want {want}")
            log(f"[mesh] gauges {gauges}; param bytes {sb._param_bytes} global, "
                f"{sb._param_shard_bytes} per position ({sb._param_shard_bytes / sb._param_bytes:.3f}); "
                f"nvidia-smi memory.used {mib0} MiB before, {mib_s} MiB with the sharded server, "
                f"{mib_u} MiB with both (+{mib_s - mib0} and +{mib_u - mib_s} MiB) [{card}]")
            # (a), (b): the same traffic through each server, flash
            # launches counted over the sharded server's
            shrink_u = 2 * ub.max_seq * ub._kv_key_bytes
            got, delta, launches = {}, {}, {}
            for name, srv, shrink in (("sharded", S, shrink_u // sb._kv_shard),
                                      ("unsharded", U, shrink_u)):
                gate = _Gate()
                srv.batcher.fault_hook = gate
                torch.cuda.synchronize()
                fa.LAUNCHES["flash_attention"] = 0
                t0 = time.perf_counter()
                got[name], delta[name] = _mesh_requests(srv, gate, probe, mixed, shrink)
                torch.cuda.synchronize()
                launches[name] = fa.LAUNCHES["flash_attention"]
                srv.batcher.fault_hook = None
                log(f"[mesh] {name}: {len(got[name])} requests in "
                    f"{time.perf_counter() - t0:.1f} s; {delta[name]}; flash launches "
                    f"{launches[name]}")
            ref = (serve_numbers or {}).get("alone_tokens") or {}
            for label in MESH_ALONE:
                if got["sharded"][label] != got["unsharded"][label]:
                    raise AssertionError(f"[mesh] (a) {label}: sharded != unsharded alone")
                if label in ref and got["sharded"][label] != ref[label]:
                    raise AssertionError(f"[mesh] (a) {label}: sharded != the serve phase's alone")
            log(f"[mesh] (a) {', '.join(MESH_ALONE)} alone: sharded == unsharded"
                + (" == the serve phase's alone tokens" if ref else
                   " (the serve phase did not run)"))
            diff = [k for k in got["unsharded"] if got["sharded"][k] != got["unsharded"][k]]
            if diff:
                raise AssertionError(f"[mesh] (b) sharded != unsharded for {diff}")
            ds, du = delta["sharded"], delta["unsharded"]
            # a preempted chunked admission, or a lane with nothing
            # credited yet, is re-admitted whole: no resume is counted
            if ds != du or ds["prefix_hits"] < 3 or ds["prefill_chunks"] <= 0 \
                    or ds["fused_dispatches"] <= 0 or ds["preemptions"] <= 0 \
                    or not 1 <= ds["preempt_resumes"] <= ds["preemptions"]:
                raise AssertionError(f"[mesh] (b) counters sharded {ds} unsharded {du}")
            log(f"[mesh] (b) prefix splices (stem 100 + 20, + 60 seeded; stem 300 + 80 chunked), "
                f"chunked seeded_500, the mixed wave under a 24-poll shrink to "
                f"{shrink_u} B unsharded / {shrink_u // sb._kv_shard} B per position: "
                f"{len(got['sharded'])} streams sharded == unsharded token for token; hits "
                f"{ds['prefix_hits']}, chunks {ds['prefill_chunks']}, fused bursts "
                f"{ds['fused_dispatches']}, preemptions {ds['preemptions']}, resumes "
                f"{ds['preempt_resumes']}, replayed tokens {ds['replayed_tokens']}")
            # (c) and (f)
            for name, b in (("sharded", sb), ("unsharded", ub)):
                if b.stats["graph_captures_inline"]:
                    raise AssertionError(f"[mesh] {name}: {b.stats['graph_captures_inline']} "
                                         "graphs captured after warm()")
            # every whole-prompt prefill launches the kernel once a layer;
            # a chunk or a prefix hit's suffix prefill reads the cache
            # attention: the two servers made the same dispatches
            layers = LLM_1_26B["n_layers"]
            if launches["sharded"] <= 0 or launches["sharded"] != launches["unsharded"] \
                    or launches["sharded"] % layers:
                raise AssertionError(f"[mesh] flash launches sharded {launches['sharded']}, "
                                     f"unsharded {launches['unsharded']}")
            log(f"[mesh] (c) graphs captured after warm(): 0 on both "
                f"({sb.stats['graphs_captured']} sharded, {ub.stats['graphs_captured']} "
                f"unsharded); (f) flash launches {launches['sharded']} "
                f"({launches['sharded'] // layers} whole-prompt prefills x {layers} layers), "
                f"equal to the unsharded server's")
            # (e) the decode step, sharded against unsharded
            for attn_len in (128, 1024):
                (ws, ds_ms), (wu, du_ms) = (_mesh_step_ms(srv, attn_len) for srv in (S, U))
                g_ms = _mesh_gather_ms(S, attn_len)
                log(f"[mesh] (e) decode step B=8 attn {attn_len}: sharded wall {ws:.3f} ms, "
                    f"device {ds_ms:.3f} ms; unsharded wall {wu:.3f} ms, device {du_ms:.3f} ms; "
                    f"the gathers and re-slices alone {g_ms:.3f} ms device [{card}]")
        finally:
            cont_log.removeHandler(handler)
            cont_log.setLevel(level)
            for srv in servers.values():
                srv.close()
    return launches["sharded"]



# the predict-mesh phase: the zoo's BERT-base (bf16, seed-0 weights read
# from a checkpoint on the host) and ResNet-50 (bf16, seed-0 weights) and
# the explain phase's ResNet-50, each stored split over an
# explicit ServingMesh whose every position is cuda:0, beside an
# unsharded twin on the same card
PREDICT_MESH_BERT_SHAPE = {"data": 1, "model": 4}
PREDICT_MESH_RESNET_SHAPE = {"data": 2, "model": 4}
PREDICT_MESH_BERT_BATCHES = 3
PREDICT_MESH_BERT_CONCURRENT = 8
# four requests of four images fill one 16-row flush: the fused batch the
# meshed engine computes is the twin's, whatever order they arrive in
PREDICT_MESH_RESNET_ANN = {"seldon.io/microbatch": "true",
                           "seldon.io/microbatch-max-batch": "16",
                           "seldon.io/microbatch-timeout-ms": "2000"}
PREDICT_MESH_RESNET_REQUESTS, PREDICT_MESH_RESNET_ROWS = 4, 4
PREDICT_MESH_IG_STEPS, PREDICT_MESH_IG_IMAGES = 8, 2
PREDICT_MESH_DEVICE = "cuda:0"


def _zoo_checkpoint(model_dir, family, config):
    """The port's seed-``config["seed"]`` params of ``family`` (made on
    the card, as a server without a checkpoint makes them) written as
    ``model_dir``'s ``params.npz``: a meshed server reads them on the
    host and copies only its blocks to the card."""
    import torch

    from seldon_core_tpu_torch import models
    from seldon_core_tpu_torch.convert import save_npz

    seed = int(config.get("seed", 0))
    params = models.build(family, device=PREDICT_MESH_DEVICE, **config).init_params(
        seed, device=PREDICT_MESH_DEVICE)
    save_npz(params, os.path.join(model_dir, "params.npz"))
    del params
    torch.cuda.empty_cache()
    with open(os.path.join(model_dir, "jax_config.json"), "w") as f:
        json.dump({"family": family, "config": config, "checkpoint": "params.npz"}, f)


def _engine_rows(app, bodies):
    """Concurrent predicts through ``app``: each answer's rows (float32
    lists, exact) or the exception it raised."""
    import asyncio

    async def go():
        return await asyncio.gather(*[app.predict(json.loads(json.dumps(b))) for b in bodies],
                                    return_exceptions=True)

    return [o if isinstance(o, Exception) else o["data"]["ndarray"] for o in asyncio.run(go())]


def _close_engines(apps):
    import asyncio

    while apps:
        asyncio.run(apps.pop().executor.close())


def phase_predict_mesh(card):
    """Sharded predict: TorchServer and the Explainer on an explicit
    ServingMesh with every position on cuda:0 (params stored split,
    gathered a layer at a time onto the compute device), beside an
    unsharded twin. Fails unless (a) BERT-base bf16 [16, 128] on data=1,
    model=4 answers ``PREDICT_MESH_BERT_BATCHES`` batches one at a time
    and ``PREDICT_MESH_BERT_CONCURRENT`` at once (the engine's thread
    pool runs them concurrently) through the engine with the twin's
    logits bit for bit, its matmul weights and
    their bf16 copies split in 4; (b) ResNet-50 bf16 224 on data=2,
    model=4 through a micro-batched engine answers four concurrent
    requests, fused on the compute device into one 16-row forward, with
    the twin engine's rows bit for bit, and refuses a 3-image request
    (it does not tile data=2); (c) IG with the meshed Explainer on the
    explain phase's ResNet-50 (bf16, ``PREDICT_MESH_IG_STEPS`` steps)
    equals the unmeshed Explainer's attributions bit for bit; the flash
    kernel does not launch. Reports (d): BERT-base's parameter bytes per
    position against the whole, nvidia-smi's memory.used, and one
    forward's device time meshed against unmeshed. Returns the flash
    launches (0)."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.components.explainer import Explainer
    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.parallel.mesh import ServingMesh, ShardedTensor, tree_shard_bytes
    from seldon_core_tpu_torch.servers.torchserver import TorchServer

    fa.LAUNCHES["flash_attention"] = 0
    apps = []
    with tempfile.TemporaryDirectory(prefix="chip-smoke-predict-mesh-") as root:
        try:
            # (a) BERT-base through the engine
            bert_dir = _zoo_dir(root, "bert", ZOO_BERT)
            _zoo_checkpoint(bert_dir, "bert", ZOO_BERT)
            mesh = ServingMesh(PREDICT_MESH_BERT_SHAPE, [PREDICT_MESH_DEVICE] * 4)
            mib0 = _smi_used()
            meshed = _zoo_engine(_zoo_unit("bert", bert_dir), mesh=mesh)
            apps.append(meshed)
            mib_m = _smi_used()
            twin = _zoo_engine(_zoo_unit("bert", bert_dir))
            apps.append(twin)
            mib_t = _smi_used()
            ms, ts = (a.executor.root.client.user_object for a in (meshed, twin))
            blocks = ms.params["blocks"]
            prep = ms._model.prepared(ms.params)["blocks"]
            for name in ("wq", "wk", "wv", "wo", "w1", "w2"):
                for leaf in (blocks[name], prep[name]):
                    if not isinstance(leaf, ShardedTensor) or len(leaf.blocks()) != 4:
                        raise AssertionError(f"[predict-mesh] (a) BERT {name} is not split in 4")
            if prep["wq"].dtype != torch.bfloat16:
                raise AssertionError("[predict-mesh] (a) BERT's prepared wq is not bf16")
            bodies, wants = [], []
            for i in range(PREDICT_MESH_BERT_CONCURRENT):
                toks = _bert_tokens(ZOO_BERT_BATCH, seed=100 + i)
                toks[1, ZOO_BERT_SEQ // 2:] = 0  # a padded tail
                bodies.append({"data": {"ndarray": toks.tolist()}})
                (want,) = _engine_rows(twin, bodies[-1:])
                if isinstance(want, Exception):
                    raise AssertionError(f"[predict-mesh] (a) the twin refused batch {i}: {want!r}")
                wants.append(want)
            for i in range(PREDICT_MESH_BERT_BATCHES):
                (got,) = _engine_rows(meshed, bodies[i:i + 1])
                if isinstance(got, Exception) or got != wants[i]:
                    raise AssertionError(f"[predict-mesh] (a) BERT batch {i}: meshed != twin")
            # all at once: the engine's thread pool runs the meshed
            # forwards concurrently, each gathering into tensors of its own
            for i, got in enumerate(_engine_rows(meshed, bodies)):
                if isinstance(got, Exception) or got != wants[i]:
                    raise AssertionError(
                        f"[predict-mesh] (a) BERT batch {i} of {len(bodies)} concurrent: "
                        "meshed != twin")
            shard, whole = tree_shard_bytes(ms.params), tree_shard_bytes(ts.params)
            log(f"[predict-mesh] (a) BERT-base bf16 [{ZOO_BERT_BATCH}, {ZOO_BERT_SEQ}] on "
                f"ServingMesh {mesh.shape} (every position cuda:0): {PREDICT_MESH_BERT_BATCHES} "
                f"batches one at a time and {PREDICT_MESH_BERT_CONCURRENT} concurrent through "
                "the engine, logits == the unsharded twin's bit for bit; "
                "wq wk wv w1 (columns) and wo w2 (rows) split in 4, their bf16 copies too")
            # (d) the footprint and one forward, meshed against unmeshed
            x = torch.from_numpy(_bert_tokens(ZOO_BERT_BATCH, seed=7)).to(PREDICT_MESH_DEVICE)
            with torch.inference_mode():
                fwd = {name: device_ms(lambda s=s: s._apply(s.params, x), launches=5, reps=5)
                       for name, s in (("meshed", ms), ("unmeshed", ts))}
            log(f"[predict-mesh] (d) BERT-base param bytes {shard} per position of {whole} whole "
                f"({shard / whole:.3f}); nvidia-smi memory.used {mib0} MiB before, {mib_m} MiB "
                f"with the meshed server (+{mib_m - mib0}), {mib_t} MiB with both "
                f"(+{mib_t - mib_m}); one forward [{ZOO_BERT_BATCH}, {ZOO_BERT_SEQ}] device "
                f"{fwd['meshed']:.3f} ms meshed, {fwd['unmeshed']:.3f} ms unmeshed (the gathers "
                f"{fwd['meshed'] - fwd['unmeshed']:.3f} ms) [{card}]")
            _close_engines(apps)
            # (b) ResNet-50 through a micro-batched engine
            rn_dir = _zoo_dir(root, "resnet50", ZOO_RESNET)
            mesh = ServingMesh(PREDICT_MESH_RESNET_SHAPE, [PREDICT_MESH_DEVICE] * 8)
            meshed = _zoo_engine(_zoo_unit("rn", rn_dir), PREDICT_MESH_RESNET_ANN, mesh=mesh)
            twin = _zoo_engine(_zoo_unit("rn", rn_dir), PREDICT_MESH_RESNET_ANN)
            apps += [meshed, twin]
            size = ZOO_RESNET["image_size"]
            imgs = _synthetic_images(PREDICT_MESH_RESNET_REQUESTS * PREDICT_MESH_RESNET_ROWS,
                                     size, seed=11)
            bodies = [{"data": {"ndarray": imgs[i:i + PREDICT_MESH_RESNET_ROWS].tolist()}}
                      for i in range(0, len(imgs), PREDICT_MESH_RESNET_ROWS)]
            seen = []
            mrn = meshed.executor.root.client.inner.user_object
            forward = mrn._apply

            def spy(params, xb):
                seen.append((xb.device, tuple(xb.shape)))
                return forward(params, xb)

            mrn._apply = spy
            got, want = _engine_rows(meshed, bodies), _engine_rows(twin, bodies)
            mrn._apply = forward
            if any(isinstance(o, Exception) for o in got + want) or got != want:
                raise AssertionError("[predict-mesh] (b) ResNet-50 meshed rows != the twin's")
            n = PREDICT_MESH_RESNET_REQUESTS * PREDICT_MESH_RESNET_ROWS
            if seen != [(torch.device(PREDICT_MESH_DEVICE), (n, size, size, 3))]:
                raise AssertionError(f"[predict-mesh] (b) the meshed forward saw {seen}")
            (refused,) = _engine_rows(meshed, [{"data": {"ndarray": imgs[:3].tolist()}}])
            if not isinstance(refused, ValueError) or "does not divide" not in str(refused):
                raise AssertionError(f"[predict-mesh] (b) a 3-image request gave {refused!r}")
            log(f"[predict-mesh] (b) ResNet-50 bf16 224 on ServingMesh {mesh.shape}, micro-"
                f"batched: {PREDICT_MESH_RESNET_REQUESTS} requests of {PREDICT_MESH_RESNET_ROWS} "
                f"images fused on cuda:0 into one {n}-row forward, rows == the twin engine's "
                f"bit for bit; a 3-image request refused: {refused}")
            _close_engines(apps)
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            # (c) IG through the meshed explainer
            ig_dir = _zoo_dir(root, "resnet50", dict(EXPLAIN_RESNET, dtype="bfloat16"), "-ig")
            x = _synthetic_images(PREDICT_MESH_IG_IMAGES, EXPLAIN_RESNET["image_size"],
                                  seed=5).astype(np.float32)
            outs = []
            for m in (mesh, None):
                e = Explainer(explainer_type="integrated_gradients", model_uri=ig_dir,
                              n_steps=PREDICT_MESH_IG_STEPS, device=EXPLAIN_DEVICE, mesh=m)
                outs.append(e.explain(x, []))
                del e
            if outs[0] != outs[1]:
                raise AssertionError("[predict-mesh] (c) meshed IG != unmeshed IG")
            attr = np.asarray(outs[0]["attributions"])
            if not np.isfinite(attr).all() or not np.abs(attr).max() > 0:
                raise AssertionError("[predict-mesh] (c) IG attributions are not finite and nonzero")
            log(f"[predict-mesh] (c) IG on ResNet-50 bf16 ({PREDICT_MESH_IG_IMAGES} images, "
                f"{PREDICT_MESH_IG_STEPS} steps) through the Explainer on ServingMesh "
                f"{mesh.shape}: attributions, prediction and target == the unmeshed "
                f"Explainer's bit for bit (targets {outs[0]['target']})")
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            launches = fa.LAUNCHES["flash_attention"]
            if launches:
                raise AssertionError(f"[predict-mesh] the flash kernel launched {launches} times")
            log("[predict-mesh] flash launches 0 (BERT, ResNet-50 and IG attend in plain "
                "PyTorch or not at all)")
        finally:
            _close_engines(apps)
    return launches


def _llm_model():
    """llm-1.26b on the card, as the engine phase's generate unit builds
    it (random weights from seed 0, cast to bf16): for a run of
    ``--phases`` that leaves the engine phase out."""
    from seldon_core_tpu_torch.models.llm import DecoderLM
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    model = DecoderLM(device="cuda", **LLM_1_26B)
    params = model.init_params(LLM_1_26B["seed"], device="cuda")
    return model, GenerateServer._cast_params_freeing(params, model.dtype)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="On-card smoke run of seldon_core_tpu_torch.")
    parser.add_argument(
        "--phases", default=",".join(PHASES),
        help="comma-separated phases to run (device and build always run; default: all "
             f"of {','.join(PHASES)}); the result lines print only when every phase ran")
    args = parser.parse_args(argv)
    phases = [x.strip() for x in args.phases.split(",") if x.strip()]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        parser.error(f"unknown phases {unknown}; have {list(PHASES)}")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import seldon_core_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the seldon_core_tpu_torch package is missing: {e}", file=sys.stderr)
        return 1
    import gc

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    clock = {"t": time.perf_counter()}

    def lap(name):
        now = time.perf_counter()
        log(f"[time] {name}: {now - clock['t']:.1f} s")
        clock["t"] = now

    try:
        t0 = time.perf_counter()
        card = phase_device()
        phase_build()
        lap("device and build")
        kern = phase_kernels(card) if "kernels" in phases else None
        lap("kernels")
        if "small" in phases:
            phase_small_model()
            lap("small")
        launches = alone = engine_launches = model = params = serve_numbers = None
        sched_launches = sched_tokens = prefix_launches = pressure_launches = None
        spec_launches = dh256_launches = f32_launches = None
        disagg_launches = kvtier_launches = migration_launches = telemetry_launches = None
        fronts_launches = zoo_launches = rag_launches = explain_launches = None
        moe_launches = train_launches = controlplane_launches = mesh_launches = None
        predict_mesh_launches = None
        if "serve" in phases:
            launches, alone, serve_numbers = phase_serve(card)
            free()  # the serve phase's copy of the model goes
            lap("serve")
        if "engine" in phases:
            engine_launches, model, params = phase_engine(card, alone)
            free()
            lap("engine")
        if "small-sched" in phases:
            phase_small_scheduler()
            lap("small-sched")
        if model is None and {"sched", "prefix", "pressure", "kvtier", "model"} & set(phases):
            model, params = _llm_model()
        if "sched" in phases:
            sched_launches, sched_tokens = phase_scheduler(card, model, params)
            free()
            lap("sched")
        if "prefix" in phases:
            prefix_launches = phase_prefix(card, model, params)
            free()
            lap("prefix")
        if "pressure" in phases:
            pressure_launches = phase_pressure(card, model, params, sched_tokens)
            free()
            lap("pressure")
        if "spec" in phases:
            spec_launches = phase_spec(card)
            free()
            lap("spec")
        if "spec-pressure" in phases:
            phase_spec_pressure(card)
            free()
            lap("spec-pressure")
        if "dh256" in phases:
            dh256_launches = phase_dh256(card, serve_numbers)
            free()
            lap("dh256")
        if "f32" in phases:
            f32_launches = phase_f32(card)
            free()
            lap("f32")
        if "disagg" in phases:
            disagg_launches = phase_disagg(card)
            free()
            lap("disagg")
        if "kvtier" in phases:
            kvtier_launches = phase_kvtier(card, model, params)
            free()
            lap("kvtier")
        if "migration" in phases:
            migration_launches = phase_migration(card)
            free()
            lap("migration")
        if "telemetry" in phases:
            telemetry_launches = phase_telemetry(card, alone)
            free()
            lap("telemetry")
        if "fronts" in phases:
            fronts_launches = phase_fronts(card)
            free()
            lap("fronts")
        if "zoo" in phases:
            zoo_launches = phase_zoo(card)
            free()
            lap("zoo")
        if "rag" in phases:
            rag_launches = phase_rag(card)
            free()
            lap("rag")
        if "explain" in phases:
            explain_launches = phase_explain(card)
            free()
            lap("explain")
        if "moe" in phases:
            moe_launches = phase_moe(card)
            free()
            lap("moe")
        if "train" in phases:
            train_launches = phase_train(card)
            free()
            lap("train")
        if "controlplane" in phases:
            controlplane_launches = phase_controlplane(
                card, serve_numbers["alone_tokens"] if serve_numbers else None)
            free()
            lap("controlplane")
        if "tools" in phases:
            phase_tools(card)
            free()
            lap("tools")
        if "mesh" in phases:
            mesh_launches = phase_mesh(card, serve_numbers)
            free()
            lap("mesh")
        if "predict-mesh" in phases:
            predict_mesh_launches = phase_predict_mesh(card)
            free()
            lap("predict-mesh")
        # the profiler runs last: once it has traced the card, later
        # launches may carry its overhead
        if "model" in phases:
            phase_model(model, params)
            phase_spec_round(model, params)
            lap("model")
        if set(phases) != set(PHASES):
            log(f"[done] phases {','.join(phases)} in {time.perf_counter() - t0:.1f} s; "
                "no result lines (not every phase ran)")
            return 0
        head, wide, f32 = kern["b1_t1024"], kern["bf16_dh256_b1_t1024"], kern["f32_dh128_b1_t1024"]

        def worst(pick):
            return max(r["max_abs_err"] for r in kern.values() if pick(r))

        source = "seldon_core_tpu_torch/ops/csrc/flash_attention.cu"
        replaces = "seldon_core_tpu/ops/flash_attention.py:138"
        log(json.dumps({"kernels": [{
            "name": "flash_attention",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "engine_launches": engine_launches,
            "scheduler_launches": sched_launches,
            "prefix_launches": prefix_launches,
            "pressure_launches": pressure_launches,
            "spec_launches": spec_launches,
            "disagg_launches": disagg_launches,
            "kvtier_launches": kvtier_launches,
            "migration_launches": migration_launches,
            "telemetry_launches": telemetry_launches,
            "fronts_launches": fronts_launches,
            "zoo_launches": zoo_launches,
            "rag_launches": rag_launches,
            "explain_launches": explain_launches,
            "moe_launches": moe_launches,
            "train_launches": train_launches,
            "controlplane_launches": controlplane_launches,
            "mesh_launches": mesh_launches,
            "predict_mesh_launches": predict_mesh_launches,
            "dh256_launches": dh256_launches,
            "max_abs_err": worst(lambda r: r["dtype"] == "bfloat16"),
            "wgmma_max_abs_err": worst(lambda r: r["route"] == "wgmma"),
            "mma_max_abs_err": worst(lambda r: r["route"] == "mma"),
            "ms": head["ms"],
            "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library_device_ms": head["library_device_ms"],
        }, {
            # the DH 256 instance on the dh256 phase's path (llm-1.26b-dh256)
            "name": "flash_attention_dh256",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": dh256_launches,
            "max_abs_err": worst(lambda r: r["dtype"] == "bfloat16" and r["dh"] == 256),
            "ms": wide["ms"],
            "device_ms": wide["device_ms"],
            "plain_ms": wide["plain_ms"],
            "bound_ms": wide["bound_ms"],
            "bound_by": wide["bound_by"],
            "library_ms": wide["library_ms"],
            "library_device_ms": wide["library_device_ms"],
        }, {
            # the mma route's 3xTF32 Dh 128 instance on the f32 phase's
            # path (llm-1.26b-f32)
            "name": "flash_attention_f32",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": f32_launches,
            "max_abs_err": worst(lambda r: r["dtype"] == "float32"),
            "ms": f32["ms"],
            "device_ms": f32["device_ms"],
            "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"],
            "library_ms": f32["library_ms"],
            "library_device_ms": f32["library_device_ms"],
        }]}))
        log(f"[done] {time.perf_counter() - t0:.1f} s")
    except Exception:  # noqa: BLE001 - any failed phase fails the run
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
