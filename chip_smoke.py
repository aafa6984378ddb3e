#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every kernel of the served and trained paths from the sources in
this checkout (six libraries, built at once), holds each kernel against
its plain PyTorch version on the card, serves the deployments below through the
port's engine and REST lane on a localhost port (the generator on the
static lane and on the continuous lane, also as an SSE token stream, and
in its sampled, shared-prefix and speculative modes on both lanes; the
float32 speculative example; the int8 generator example and the flagship
at int8 weights and K/V on both lanes, and the quantized MNIST; the iris, mean_transformer, gbm,
outlier_pipeline and epsilon_greedy examples, the last with feedback; the
ensemble4 example fused, compiled and in host mode with one node served by
the unit microservice, partial fusion, quorum and fallback; the MNIST
example over the binary tensor wire, gRPC, a unix socket and the relay,
and ensemble4 with a gRPC microservice and a unix: host),
trains the flagship LM a few steps and serves its checkpoint, then serves
the MNIST example, ensemble4 across processes and the flagship generator
with every observatory on and reads them back through the observability
routes (phase 10o, after every phase that opens a profiler), checks the
answers, shows that each run went through its kernels, and times each
kernel beside its plain version, a PyTorch library call and its bound.
Weights are random, from a seed.  Phases, in order; any failure exits
non-zero without the final line, and each phase prints its wall.  Every
phase but the continuous lane's runs with SELDON_TPU_GEN_CONTINUOUS=0, so
it serves the static lane it measured before that lane's switch:

  1. device   CUDA present; the card's name and power limit (nvidia-smi)
  2. build    nvcc of ops/csrc/fused_mlp.cu, flash_attention.cu,
              flash_attention_bwd.cu, flash_decode.cu, flash_decode_paged.cu
              and kv_write.cu at once, with ptxas's report; each kernel's own shape check
              asked for shapes it takes and shapes it must refuse, the int8
              variants at their dtype code too
  3. kernel   fused_mlp_softmax vs fused_mlp_softmax_reference at
              784-256-256-10 and 784-512-512-10 with non-zero biases,
              B in {1, 7, 32, 64, 128, 1024} (32 and 64 are the served
              stacks): a repeat the same bits, the cluster the kernel ran
              the one mlp_plan chose (more than one block at B=1), one
              row the same bits in every batch whatever the plan
  4. serve    examples/mnist_deployment.json: engine construction (the
              unit probes the kernel), then 1-row ndarray, 64-row tensor,
              32 concurrent 1-row requests and a 1-row latency loop over
              one keepalive connection, all through POST
              /api/v0.1/predictions; launch counts reset just before, read
              just after; then the same request's p50 inside the engine
              and at the dispatch
  5. times    fused-MLP kernel / plain / library device times, the bound
              and an empty launch of the same grid and cluster (the
              floor) at B=1, 32, 64 and 1024, and B=1 cold (rotating over
              256 MiB of weight copies); the wrapper's host time with
              its shape check cached and asked each call; the kernel
              of commit 30a1d89 in turns with the present one
              (mlp_turns.py) when its
              source is at build/dev/fused_mlp_30a1d89.cu or git can
              write it there
  6. flash    flash_attention kernel vs flash_attention_reference, o and
              lse, causal and not, at six shapes (the served prefill layer
              among them, and S=192: a ragged last 128-row query tile)
  7. decode-kernel  flash_decode_two_tier vs its plain version at fifteen
              shapes (the served layer with 1, 32 and 63 chunk tokens, B=1,
              main 100, main 640 full and 600 of 640, hd 128 and 256, MHA at
              hd 64 and 256, B=1 at 1, 17, 309 and 640 positions: clusters
              of 1, 2, 4 and 8 blocks), each a second time for the same
              bits; flash_decode over one cache; kv_write bit-exact and in
              place from strided head views; the decode step's fused call
              (k_new/v_new from strided head views) at the served layer
              with 1, 32 and 63 chunk tokens and an empty chunk: caches
              bit-exact against kv_write_reference, o within FLASH_O_ATOL
              of write-then-attend, a repeat the same bits
  8. gen      the flagship TransformerGenerator of bench.py:3342-3344
              (vocab 32768, d_model 1024, 16 heads over 4 kv heads, 12
              layers, d_ff 4096, 64 new tokens, bf16): engine construction
              (the unit probes the flash and flash-decode kernels once
              each, the latter with the write fused in), then a 1-row
              512-token ndarray prompt, a 32-row
              512-token tensor request, 8 concurrent 1-row requests and a
              1-row 100-token prompt (S % 128 != 0: a plain-attention
              prefill), launch counts reset before and read after: 12 flash
              launches per eligible prefill, 12 x 63 flash_decode launches
              (each with the step's K/V write) and no kv_write per
              dispatch; every served token
              teacher-forced through the plain path; prefill logits kernel
              vs plain
  9. stream   POST /api/v0.1/generate/stream with the 1-row 512-token
              prompt at chunk 8 (counts reset before, read after): frames
              parse, tokens equal an in-process generate, time to the first
              frame; then an in-process 4-row stream of 300 tokens across
              two grow_merges, teacher-forced through the plain path
 10. times    flash kernel / plain / SDPA device times and the bound at the
              served prefill shape and at S=2048, 4096 (B=4); flash decode
              (the served layer and the 1-row stream's, each rotating over
              256 MiB of inputs: cold L2, as the served step reads them),
              at the served layer also the fused call against the
              attention alone and kv_write then the attention, in turns;
              kv_write kernel / plain / library times and their bounds;
              TTFT and generate p50 with the kernels and with
              attention="xla" in turns (8 walls each, with quartiles),
              decode tokens/s; profiled prefill
              and generate both ways: launches and device time per decode
              step, busy share, flash_decode_kernel's time per call
 10a. paged-kernel  flash_decode_paged vs its plain version at seven
              shapes (the served round, B=32 over 64 blocks of 16 with
              ragged lengths 513..576; one row at 17 and 560 positions, a
              cluster of 8 with empty ranks; MHA at hd 128; 16 query heads
              at hd 256; the speculative drafts' MHA at hd 64 and hd 32)
              and on one batch of lengths 1, 17, 300, 560 and 1009, each
              also repeated and with the rows' blocks permuted in the pool
              (the same bits); the call with the decode step's K/V write
              fused in at the round's shape and the drafts' (three inactive
              rows): o of the active rows, the pools bit-exact outside the
              scratch block, a repeat and moved blocks the same bits;
              kv_write_paged bit-exact and in place at KV_PAGED_CASES
              (W=1, a prefill tick's W=128 and 512, a verify's W=5 of 16
              kv heads, W=127 and 130, hd 32 to 256, f32 at the
              speculative example's verify, views misaligned to units of
              8, 4 and 2 bytes; starts a multiple of neither bs nor W, a
              row with every position invalid, a table entry outside the
              pool), its launch plan in C equal to paged_write_plan
 10b. continuous  the flagship generator through the continuous lane
              (runtime/genserver.py, default knobs) over REST: a 1-row and
              a 32-row 512-token request (preemption must occur), 8 1-row
              requests 20 ms apart (a decode round must hold more than one
              row) and the 1-row prompt as an SSE stream (equal to the
              unary answer), counts reset before and read after: 12
              flash_decode_paged launches per decode step (each with the
              step's K/V write), 12 kv_write_paged launches per prefill
              tick and none in a decode step, none of the static lane's;
              every token teacher-forced through the plain path
 10c. times   the continuous and the static lane in turns (ABBA): 1-row
              TTFT (first SSE frame) and the 32-row request's wall; a
              profiled decode round (launches and device ms per step,
              flash_decode_paged's share, busy share), tokens/s, prefill
              ticks; flash_decode_paged (cold L2) beside its plain version,
              its bound, the fused call and the write launched apart, the
              gather-then-dense alternative, the two-segment kernel on the
              positions made dense and gather-then-SDPA, and on the ragged
              batch; kv_write_paged at a prefill tick's W=128 and 512
              beside index_put_
 10d. sampled  the flagship generator at temperature 0.8, top_k 50, top_p
              0.95: on the continuous lane a 1-row probe, 8 1-row requests
              20 ms apart and a 32-row request (12 flash_decode_paged
              launches a decode step, 12 kv_write_paged a prefill tick); on
              the static lane (no batcher) a 1-row and an 8-row request and
              a 1-row stream (12 flash launches a prefill, 12 x 63
              flash_decode a dispatch); every token within TOKEN_DELTA of
              its teacher-forced top 50; a fresh engine with the same seed
              replays the first answer on each lane; a round's device ms
              and wall, sampled against greedy in turns
 10e. prefix   a 200-token prefix_tokens (12 pinned blocks of 16, an
              8-token tail) with 312-token suffixes, greedy, a 1-row and a
              32-row request on each lane: every token within TOKEN_DELTA
              of its teacher-forced maximum over prefix + suffix; the
              pinned blocks hold the prefix cache bit for bit before and
              after; kv_write_paged launches 12 for the blocks, 12 a tail,
              12 a prefill tick; TTFT against the same 512 tokens sent
              whole, in turns
 10f. speculative  a float16 SpeculativeGenerator refused on the card (the
              paged kernel takes bf16 and f32); then one at the flagship target's dims
              (MHA), bf16, k=4, with its default draft and with the target
              as its own draft, on both lanes: every token within
              TOKEN_DELTA of the target's teacher-forced maximum;
              flash_decode_paged once a draft layer a draft step,
              kv_write_paged once a target layer a verify; the self-draft
              accepting at least 2 of 4 a row-round; the 32-row request's
              tokens/s of both against the plain continuous lane in turns
 10g. spec-f32  examples/speculative_deployment.json as written (float32,
              a draft of 2 heads of hd 32): flash_decode_paged's float32
              path vs its plain f32 version at one row of 1, 17 and 512
              positions, a ragged batch, the walk's edge lengths (1-2048),
              32 and 64 random rows and three wider shapes (clusters of 1-8
              blocks), and fused with three inactive rows (o within
              F32_O_ATOL, the pools bit-exact outside the scratch block, a
              repeat and moved blocks the same bits); the engine on the
              continuous lane over REST (1-row, 8-row and 4 concurrent
              requests), counts reset before and read after: flash_decode_paged
              once a draft layer a draft step, all on the float32 path,
              kv_write_paged once a target layer a verify and once a layer of
              each model a prefill tick; every token within F32_TOKEN_DELTA of
              the target's teacher-forced maximum and equal to the same
              engine's on the CPU; the 32-row request's tokens/s; the f32
              kernel cold beside its plain version, gather + SDPA in f32 and
              its bound
 10h. families examples/iris, mean_transformer, gbm and outlier_pipeline over
              REST: 1, 3 and 8 rows against the same engine on the CPU (the
              outlier's state moving in step); outlier_pipeline one fused-MLP
              launch a dispatch, 8 concurrent callers each with its own rows'
              outlierScore; 1-row p50s; the eigh share of the outlier's
              dispatch under torch.profiler
 10i. router  examples/epsilon_greedy_deployment.json over REST: 12 requests
              each followed by POST /api/v0.1/feedback of its meta.routing;
              branches and answers equal to the CPU engine's, success / tries
              moved on the routed branch only, fused-MLP launches by branch,
              the events stub
 10j. host   the host half of the graph runtime: the MNIST unit microservice
              (runtime/microservice.py) as a subprocess with
              MICROSERVICE_SMOKE_EXIT (exit 0, on cuda), then in this process
              on a localhost port (MnistClassifier, seed 3, through the fused
              MLP); examples/ensemble4_deployment.json as written (mode
              fused), with SELDON_TPU_GRAPH_FUSE=0 (compiled) and with m3
              bound to the microservice (host), the same weights, each a
              1-row, a 64-row and 8 concurrent 1-row requests over REST:
              fused and compiled the same bits, host within HOST_ATOL, all
              within MNIST_ATOL of the CPU twin, the launches counted (4 a
              dispatch; 3 in the engine and 1 in the microservice a request
              in host mode); the 1-row p50 of each mode and of the remote hop
              alone in turns; a quorum-1 COMBINER over a fused
              MeanTransformer -> MnistClassifier subtree and the REST leaf
              (the pure interpreter's answer; after the microservice stops,
              200s tagged seldon.degraded.comb until the leaf's breaker opens,
              shown in /ready and /stats); a ROUTER with fallback 1 over the
              dead leaf; examples/torch_model/torch_mnist_deployment.json (a
              plain user object) against its object's predict
 10k. int8-kernels  the int8-K/V variants against their plain versions,
              each call twice for the same bits: flash_decode_two_tier at
              the flagship layer (main 512 + 1, 32 and 63 chunk tokens), one
              row at 1, 17, 309 and 640 positions (clusters of 1-8) and the
              int8 example's hd 16; flash_decode_paged at B=32 over 560
              positions, a ragged batch (its blocks also permuted), one row
              and hd 16; all with the step's K/V write fused in; the caches
              quantized N(0, 1) bf16 rows, q at twice their spread, the
              fresh key at twice and the fresh value spiked: o within
              FLASH_O_ATOL of max(1, |o|), the written codes and scales bit
              for bit against the plain quantizer (the pools outside the
              scratch block); at the flagship's shapes the plain version
              with a 16-position tile dropped or k_s read one position off
              must miss that tolerance by 4x; kv_write_paged's int8
              variant bit-exact at I8_KV_CASES (W=128 and 512 into (2049,
              4, 16, 64), W=5, 127 and 130, hd 16 to 256, the same starts,
              invalid row and out-of-pool entry as 10a's), quantizing bf16
              rows and copying int8 ones, its plan in C equal to Python's
 10l. int8-serve  examples/generator_int8_deployment.json as written (int8
              weights and K/V, attention "flash") on the continuous and the
              static lane over REST: 1 row, 8 rows and a 1-row SSE stream of
              128-token prompts, counts reset before and read after (2 int8
              flash_decode_paged a decode step and 2 int8 kv_write_paged a
              prefill tick; 2 int8 flash_decode_two_tier a static step and 2
              flash-attention launches a prefill; no bf16 decode launch);
              tokens equal the same engine's on the CPU except where the two
              part at a near tie of the plain int8 logits; the flagship
              generator at quant / kv_quant int8 on both lanes, a 1-row and a
              32-row 512-token request (12 launches a step or tick), every
              token within INT8_TOKEN_DELTA of the plain int8 path's
              maximum; QuantizedMnistClassifier 784-256-256-10 over REST, 64
              rows: argmax agreement >= 0.95 with MnistClassifier
 10m. int8-times  each int8 variant cold beside the bf16 kernel at the same
              shape, its plain version, dequantize + SDPA (two calls) and its
              bound, at the served round (n=560) and the long-context shape
              (n=4096+64); kv_write_paged int8 at W=128 and 512;
              dequant_matmul against the dense bf16 matmul at the flagship's
              decode shapes and one prefill shape; the static lane's
              long-context decode tokens/s (B=32, S=4096, 64 new) with int8
              against bf16 K/V in turns; a profiled int8 decode step
 10n. wire-grpc  examples/mnist_deployment.json behind one engine with its
              REST lane, gRPC (serve_grpc_fast), its HTTP routes on a unix
              socket and the relay: the same 1-row and 64-row X (seed 0),
              each request alone, over JSON, the binary wire at float32,
              float64 and int8 with its scale plane, gRPC's tensor and
              object (ndarray) lanes, the HTTP socket and the relay: every
              answer the JSON answer's float64 values bit for bit (int8:
              within MNIST_ATOL, its rows within half a step of X), names,
              puid and status alike, one dispatch and one fused-MLP launch a
              request; a MULTI frame with a torn slot (its own 400 frame);
              typed 400/413 (the connection serving on), 415 with
              SELDON_TPU_WIRE=0, UNIMPLEMENTED, a malformed gRPC body's
              FAILURE message; ensemble4 with m3 behind `microservice
              MnistClassifier GRPC` (a subprocess) and behind a second
              engine's ENGINE_HTTP_UDS_PATH (a unix: host) within HOST_ATOL
              of fused, the remote launches counted in their processes; the
              microservice stopped, a quorum-3 ensemble degrading until m3's
              breaker opens; p50s over 200 keepalive requests a lane in turns
              (JSON, wire, gRPC at 1 and 64 rows; gRPC- against REST-remote
              ensemble4); a {"new_paths": {"wire_grpc": ...}} line
 11. flash-bwd the dQ and dK/dV kernels vs flash_attention_bwd_reference,
              dq/dk/dv, causal and not, at seven shapes (the training layer
              among them, a group of 8, and S=192: a ragged last 128-row
              tile); each call moves each launch counter by 1, and a
              second call gives the same bits
 12. train    the flagship config (GEN_DIMS) in bf16 on the copy task of
              bench.py:2105-2108 at B=16, S=512 with adam(3e-4): one step's
              loss and per-leaf gradients, kernel path vs plain path; then
              20 steps with counts reset before and read after (12 forward,
              12 dQ and 12 dK/dV launches per step), losses finite and
              falling; step wall, trained tokens/s, a profiled step
 13. hand-off save_lm_weights / load_lm_weights bit-identical; a
              TransformerGenerator with weights_path served over REST
              answers a 512-token copy-task prompt as an in-process
              generate on the trained params does
 14. times    dQ and dK/dV kernel / plain / SDPA-backward device times and
              their bounds at the training layer and at S=2048 (B=4), and
              the whole flash_attention_bwd call (both launches) beside
              SDPA's backward; then the {"kernels": [...]} line with all
              eight kernels, the float32 path of flash_decode_paged in a
              row of its own and the three int8 variants in rows of their
              own, each row's launches those of every served path (phases 4,
              8-10o), with a breakdown by path
 10o. observability (after phase 14, with no profiler open): MNIST with
              every observatory on (SELDON_TPU_TRACE at sample 1,
              telemetry and perf on), 200 1-row and 8 64-row keepalive
              requests: /prometheus parsed here, its families
              MetricsRegistry.family_names(), the server histogram's count
              the requests, the dispatch histogram's the dispatches; /perf's
              rows predict[1x784/float32] and predict[64x784/float32], calls
              == dispatches == the fused MLP's launches, FLOPs the hand count,
              MFU in (0, 1], the card's peaks not assumed, its memory rows;
              one request's /trace a single tree (request -> batch_queue,
              dispatch) whose critical path covers >= 90% of the root, and
              /trace/export; a profile window over 20 requests in an
              engine_main of its own (a process that has profiled nothing
              before) naming the fused-MLP kernel once a dispatch, a
              second start 409; the
              1-row p50 with everything on and off in turns beside /overhead.
              ensemble4 in host mode with m3 behind the microservice over
              REST (the binary wire), gRPC and an engine's unix socket: m3's
              spans of a traced request under the engine's client span.
              The flagship generator, continuous lane, default knobs: 8
              1-row 512-token requests 20 ms apart and one 32-row request;
              /genperf's prefill and decode ticks, host + device + bubble
              >= 95% of the scheduler's wall, served decode MFU and HBM
              share in (0, 1], flash_decode_paged's launches 12 x the ticks'
              decode steps, kv_write_paged's 12 x the prefill ticks; a
              {"new_paths": {"observability": ...}} line
 10p. quality, postmortems and costs (after 10o, engines of its own):
              MNIST with quality on at sample 1 and an SLO p99 target: 256
              reference rows as 64-row requests from a seeded normal, 8
              such requests, then 8 shifted (x1.5 + 0.3): /quality's window
              frozen, no significant drift after the first 8 (psi_max under
              0.25, psi_mean under 0.1), psi_mean up by half after the
              shift; the live x counts equal _summarize_np's recomputed
              here, and the 64-row batches went through the device
              summarizer (its row counter, errors 0); /prometheus's drift
              and burn gauges non-zero; POST /quality/reference resets;
              fused-MLP launches == dispatches.  epsilon_greedy with 12
              feedbacks: /quality's and /stats' routers rows from the
              card's router state, the mean reward.  outlier_pipeline: the
              outlier block counts the rows scored.  The flagship generator
              on the continuous lane: 8 1-row 512-token requests (acme and
              globex) and one 32-row (globex): /costs' identity within
              1e-6 s, accounted_fraction 1.0, both tenants with prefill and
              decode device-seconds and KV-block-seconds, flash_decode_paged
              12 x the decode steps, kv_write_paged 12 x the prefill ticks.
              Tracing at sample 0, a postmortem SLO below the 32-row
              request's wall and a pool that preempts: /postmortems keeps
              that request (reasons slo and preemption, a guilty phase, its
              gen_sequence slice and /costs row; ?puid= the exemplar).  The
              1-row MNIST p50 with quality, the ledger and postmortems on
              and off in turns, beside /overhead's fold costs; a
              {"new_paths": {"quality_costs": ...}} line
 10q. the autopilot and the policies (after 10p, engines of their own, the
              deciding singletons reset): MNIST prewarmed in process (a seed
              prior for every bucket), then 6 requests of each of 1, 8, 32
              and 64 rows: /autopilot's learned estimate of each pad
              bucket within 3x of /perf's p50 of the same key, dispatch
              spans carrying autopilot_predicted_ms, the keys gauge, the
              fused MLP's launches the dispatches.  3 bursts of 48
              concurrent 1-24-row requests (half with a deadline): flush
              decisions rise, every answer bit for bit a
              SELDON_TPU_AUTOPILOT=0 engine's.  8 binary frames whose
              Seldon-Deadline-Ms is the 64-row (else the 1,024-row)
              estimate / 1.25 answer 503 "autopilot load shed" with no
              launch, 8 ample ones are served, and postmortems keep the
              sheds and, at a low excess factor, autopilot_excess.  A
              fused RANDOM_ABTEST over outlier -> MNIST and MNIST: under a
              deadline between the learned branch walls every branch-0
              pick is served by branch 1 and tagged (the kill switch
              follows the router).  The flagship generator (16 slots, 384
              blocks) under a brownout ladder at depth 4: a batch-tier
              32-row request and 4 interactive ones, the ladder 0 -> 1 ->
              2 -> 3 and back one step a tick, offline and batch MNIST
              shed at stages 1 and 3, a stage-2 request half as long,
              prefill at the floor, batch-tier victims only, interactive
              admitted first; paged launches 12 x the steps and ticks.
              Two engine_main processes, one with ENGINE_PREWARM_WIDTHS:
              shapes and launches before binding, first-request walls and
              p50s; the perf corpus warming a restarted engine_main and
              rotating; the 1-row p50 with the policies on and off in
              turns beside /overhead; a {"new_paths": {"policies": ...}}
              line
 10r. the native data plane ([4d]): examples/mnist_deployment.json behind
              the C++ plane (runtime/nativeplane.py) and a second engine
              with the same weights behind the Python lane: 1-row, 64-row,
              32 concurrent and 200 keepalive requests and gRPC calls,
              every answer the Python lane's bits; fused-MLP launches equal
              to the plane's batches; dp_stats; /stats http_impl and codec
              native; the misc lane, 1e300 as NaN, a too-narrow row's 400;
              the plane and the Python lane in turns under a C++
              closed-loop client (requests/s, p50, p99, one connection's
              p50); engine_main with ENGINE_HTTP_IMPL unset; a persisted
              EpsilonGreedyRouter microservice on the card restarted from
              its checkpoint; a {"new_paths": {"native": ...}} line.  The
              engine_mains of earlier phases run with ENGINE_HTTP_IMPL=fast
 10s. MoE layers ([5e]): the flagship generator with every 2nd layer a
              mixture of 8 experts, top-2, bf16, served by EngineService on
              the static lane with the continuous switch on (genserver
              null): B=4 prompts of 128 and 100 tokens, 12 flash_attention
              launches at 128 and none at 100, 12 x 63 flash_decode a
              dispatch; the tokens held to the plain path (a replay that
              takes the kernel path's routing, the teacher-forced gap
              rule), each MoE layer's routing flip share with every flip's
              gate margin within the two paths' gate difference; the
              request wall p50 and an MoE FFN's device ms a decode step
              beside a dense one's; examples/generator_ep_deployment.json
              without mesh_axes against its CPU twin; 5 steps of
              lm_train_step at B=16, S=512 (12 forward, 12 dQ and 12 dK/dV
              launches a step, a falling loss, the router and the experts
              moved, step 0's loss against the plain path, the step wall
              p50 and max_memory_allocated); the checkpoint served through
              weights_path; a {"new_paths": {"moe": ...}} line
 10t. the disaggregated roles ([6d]) on one card: engine_main --gen-role
              decode (the relay on ENGINE_RELAY_TCP_PORT and a unix socket)
              and two --gen-role prefill replicas handing off to it over
              tcp: and uds:, the flagship generator; a pair for
              examples/generator_int8_deployment.json over tcp:; greedy
              tokens equal to an in-process unified engine's; from each
              side's /stats, kv_write_paged launches on the prefill side
              (12 a tick), flash_decode_paged on the decode side (12 a
              step) and no kv_write_paged there; the hand-off bytes and ms
              a sequence, TTFT and request wall p50 against the unified
              engine's in turns; a request to the tcp: prefill replica
              whose Seldon-Deadline-Ms budget is below its warm chain mean
              shed with a 503 and no prefill tick; SELDON_TPU_DISAGG=0
              serving both roles as unified; then decode replicas over
              {"tp": 4} (four cards, else four shards of cuda:0) fed by a
              one-device prefill replica over the wire's frames in process:
              examples/generator_tp (f32) with tokens identical to a
              one-device unified replica's and the flagship teacher-forced,
              flash_decode_paged on every shard of the decode side and no
              kv_write_paged there; a {"new_paths": {"disagg": ...}} line
 10u. device meshes held by one process ([6a]), on four cards when the
              machine has four, else four shards of cuda:0: (a) a
              SharedEnsembleUnit of 8 MnistClassifier members over
              {"ens": 4} held to the plain members' mean (fused_mlp on
              every shard); (b) the flagship over {"tp": 4}, each shard's
              params its own blocks (bytes and memory_allocated a card),
              prefill logits held to the one-device unit's, both lanes'
              tokens teacher-forced, flash_attention, flash_decode,
              kv_write_paged and flash_decode_paged counted on every
              shard, request walls against one device in turns, a
              profile and a collective round's host cost; (b') the
              flagship over {"tp": 8} (two shards a card on four cards,
              else eight shards of cuda:0), a tp twice its 4 kv heads: each
              shard 2 query heads on the one kv head they read, a 4x128
              request of 16 tokens, prefill logits and both lanes' tokens as
              (b), every shard's launches, each shard's pool bytes, the
              request wall against one device in turns, and each kernel
              held to its plain version and timed cold at its shard
              shape; (c)
              examples/generator_tp (both lanes; its continuous lane
              through kv_write_paged and the paged kernel's f32 path on
              every shard) and generator_ep (static lane), f32 tokens
              identical to the one-device unit's; (d)
              examples/ensemble4_deployment.json over engine_main --node
              processes, bit-identical to the collapsed engine; a
              {"new_paths": {"mesh": ...}} line
 10v. [6b] part 1, on four cards when the machine has four, else four
              shards of cuda:0: (a) ring_attention_sharded over {"sp": 4},
              4 causal blocks of (2, 16, 512, 64) bf16, the kernel path
              (RingFlash) against the plain ring in f32: o within
              FLASH_O_ATOL, dq/dk/dv within BWD_REL_TOL, 10 launches of
              each kernel (none above the diagonal); (b) TransformerLM at
              the flagship's widths with 16 kv heads over {"sp": 4}, a
              [2, 2048] request's logits against the one-device unit's,
              12 x 10 flash_attention launches, and a small binding with
              mesh_axes {"sp": 4}; (c) lm_train_step over {"tp": 2,
              "sp": 2} on the copy task (B=16, S=512): step 0's gradients
              against one device's kernel path, 3 steps, a falling loss,
              replicated copies bit-identical, 72 launches of each flash
              kernel a step; (d) the GQA flagship's pipeline over
              {"pp": 4}, 4 microbatches: logits against lm_apply, step 0's
              gradients, 3 steps, 48 forward launches a forward and 48 of
              each a step, each stage's bytes; (e) MNIST's train_step over
              {"dp": 4} against one device's; each path's walls against
              one device in turns (recorded, not claimed); a
              {"new_paths": {"sharded_train": ...}} line
 10w. [6b] part 2, one process a card: four worker processes over NCCL
              on four cards (CUDA_VISIBLE_DEVICES=i), else two sharing
              cuda:0 over gloo with two shards each, started through the
              SELDON_* env contract (this script with --multihost-worker),
              each with its own timeout, held to this process's
              one-process meshes of the same shapes: (a) all_reduce,
              all_gather, gather_slices and ring_shift over sp=4, tp=4
              and dp=2 x tp=2 across processes bit for bit, then 10v's
              ring over a cross-process sp=4 (10 launches of each kernel
              over the processes, o within FLASH_O_ATOL, dq/dk/dv within
              BWD_REL_TOL of the plain ring); (b) the flagship generator
              over a cross-process tp=4: prefill logits bit for bit the
              one-process mesh's and within MESH_LOGIT_ATOL of one
              device's, the static request's tokens teacher-forced,
              flash_attention and flash_decode on every process, the
              request wall against one device in turns and against 10u's
              one-process mesh (recorded, not claimed), a cross-process
              round's host cost; (c) lm_train_step over dp=2 x tp=2 at
              the GQA flagship on the copy task: step 0's loss bit for
              bit the one-process mesh's, its gradients within
              TRAIN_GRAD_REL_L2 of one device's, 3 steps, a falling loss,
              48 launches of each flash kernel a step, the replicated
              copies bit-identical across processes; (d) MNIST over a
              cross-process dp=4 against one device; (e) ensemble4 in host
              mode, quorum 3, m3 behind the port's FaultyNodeRuntime at
              error_rate 1.0: answers bit for bit the healthy three's,
              calls and injections as seeded, fused_mlp on the healthy
              members; a {"new_paths": {"multihost": ...}} line
 10x. gateway the port's gateway (seldon_core_tpu_torch/gateway) on the
              card: (a) examples/canary_deployment.json's two predictors as
              in-process engines behind the gateway's HTTP routes: 401
              without a token, 200 with one, GATEWAY_REQUESTS 1-row
              requests whose predictor sequence is the one its seed draws
              (the CPU test pins the same rule), every answer the same
              engine's direct answer bit for bit, one fused-MLP launch a
              dispatch, and the kernel held to its plain version at
              784-512-512-10, B = 1, 8 and 64; (b) the MNIST example on two
              engine_main subprocesses, one with the binary wire switched
              off, behind the gateway's predictions route with a bearer
              token: a deployment a lane (HTTP JSON, HTTP wire, uds: wire,
              uds: JSON) and one whose replica set holds the wire engine's
              REST and uds: endpoints, whose p2c picks reach both; one gRPC
              Predict through the gateway's front to that set; every answer
              an in-process twin's bit for bit, and each engine's /stats
              shows the launches and, by lane, the binary or JSON predicts
              its lanes sent there; (c) the flagship generator in process on the
              continuous lane, a 1-row 128-token prompt streamed through
              the gateway for 16 tokens: the engine's direct stream's
              tokens, 12 flash_decode_paged launches a decode step and 12
              kv_write_paged a prefill tick; (d) the gateway's overhead,
              its p50 minus the engine's own REST p50 over 200 requests
              each, in turns, each arm's launches counted apart; a {"new_paths": {"gateway": ...}} line
 10y. operator the operator's local half and the load rig on the card:
              (a) the materializer (device cuda) applies
              examples/canary_deployment.json from a spec directory: both
              engines on the card, registered, the status file Available;
              (b) OPERATOR_REQUESTS 1-row N(0,1) requests through the
              gateway (seed fixed, firehose on): the seed's predictor
              sequence, every answer the serving engine's direct answer bit
              for bit, one fused-MLP launch a request; (c) the port's
              replayer over the flushed firehose: main on the lines main
              served passes with disagreement 0.0, canary on the whole log
              fails, each replay's launches its engine's dispatches; (d) a
              staged rollout of the canary (5, 25, 100; drift gate 0.25,
              min 4 requests) rolls back on drift once the inputs shift to
              N(3,1): the split {main: 100, canary: 0}, GET /rollouts the
              controller's document, the rollback counter on /prometheus and
              in the firehose, no live request failing; (e) the reconciler
              on a FakeKubeApi with the controller and the scale-ahead
              planner: engine Deployments asking nvidia.com/gpu, rollout and
              autoscale status blocks, and a second pass with zero writes;
              (f) a runtime "rest" MnistClassifier at 784-512-512-10 spawned
              as the port's microservice on the card: 8 requests through the
              gateway equal to an in-process twin's bit for bit and 8
              launches on the unit's /stats; killed, Degraded, restarted by
              supervise(), Available, one more request; (g) the native
              loadgen (16 clients, 3 s) through the gateway's predictions
              route and at the main engine's own REST lane, zero failures,
              QPS, p50 and p99 recorded; fused_mlp.cu held to its plain
              version at 784-256-256-10; a {"new_paths": {"operator": ...}}
              line
 15. last line {"ok": true, "device": {"platform": "gpu", ...}}

It needs one card and exits non-zero when CUDA is absent or when the
port's package is not beside it.  It imports nothing of JAX.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import os
import subprocess
import sys
import threading
import time
import traceback
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
SEED = 0
KERNEL_SOURCES = ("fused_mlp", "flash_attention", "flash_attention_bwd", "flash_decode",
                  "flash_decode_paged", "kv_write")
KERNEL_ATOL = 2e-3   # kernel vs plain, probabilities: both round at the same
#                      bf16 casts, only the order of the f32 sums differs.
#                      Served answers are the same kernel against the same
#                      plain version, so they are held to it too.
FLASH_O_ATOL = 1.6e-2   # kernel vs plain, bf16 o (|o| < 2): p rounds to bf16
#                         at the kernel's running row max and at the plain
#                         version's final one, sums run in another order,
#                         and o is rounded to bf16 -- 2 bf16 ulps at |o| ~ 1
FLASH_LSE_ATOL = 1e-4   # lse is an f32 max + log of an f32 sum on both sides
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
SERVE_P50_REQUESTS = 200
# ABBA turns of the static lane's TTFT and generate walls, kernels against
# attention="xla" (2 walls a side a turn); the whole smoke must stay well
# inside its time limit as phases are added, so the earlier timings keep
# the fewest turns that still alternate the two arms
GEN_WALL_TURNS = 2
# bench.py:3342-3344, gen_lm_deployment(smoke=False), quant none
GEN_DIMS = {"vocab": 32768, "d_model": 1024, "n_heads": 16, "n_kv_heads": 4,
            "n_layers": 12, "d_ff": 4096, "max_new_tokens": 64}
GEN_S = 512            # the flagship traffic: B=32 prompts of 512 tokens
GEN_B = 32
# (B, H, KV, S, D); S = 192 is a ragged last 128-row query tile, which only
# the kernel's own entry (fa._launch) takes: the JAX contract wants S % 128
FLASH_SHAPES = [(1, 2, 2, 256, 64), (1, 1, 1, 384, 32), (32, 16, 4, 512, 64),
                (2, 8, 2, 1024, 128), (1, 4, 4, 256, 256), (2, 8, 2, 192, 64)]
FLASH_TIMED = [(32, 16, 4, 512, 64), (4, 16, 4, 2048, 64), (4, 16, 4, 4096, 64)]
# (B, H, KV, S, D): MHA, the 3-tile carry with D padded to the 64-wide
# tile, the training layer, GQA at D=128, D=256 (the two-walk dK/dV), a
# ragged last 128-row tile (S=192, through fa._launch_bwd: the JAX contract
# wants S % 128) and a group of 8 query heads on one kv head
FLASH_BWD_SHAPES = [(1, 2, 2, 256, 64), (1, 1, 1, 384, 32), (16, 16, 4, 512, 64),
                    (2, 8, 2, 1024, 128), (1, 4, 4, 256, 256), (2, 8, 2, 192, 64),
                    (1, 8, 1, 256, 64)]
FLASH_BWD_TIMED = [(16, 16, 4, 512, 64), (4, 16, 4, 2048, 64)]
BWD_REL_TOL = 2.0 ** -5   # kernel vs plain backward, each of dq, dk, dv, as
#                           a share of that gradient's largest element: both
#                           round p and ds to bf16 at the same places, but
#                           their f32 scores and sums run in other orders, so
#                           a rounding of p, ds or the bf16 result can move by
#                           an ulp; under GQA the plain version also rounds
#                           each query head's dK/dV before the group sum, the
#                           kernel once after it.  4 bf16 ulps of the largest
#                           element (an ulp is 2^-8 to 2^-7 of it).
# The served path (flash prefill, two-tier cached decode) and the plain
# path (attention="xla", the whole sequence at once) round at other places:
# the attention output by 1-2 bf16 ulps (p rounds at the running vs the final
# row max), the S=1 and S=575 matmuls by cuBLAS's choice of algorithm.  Over
# 12 layers that moves the bf16 logits near the row maximum (|logit| in
# [4, 8) at vocab 32768, ulp 2^-5) by a few ulps: the first card run
# measured 0.047 (token gap) and 0.051 (prefill logits).  Both are held to
# 4 ulps there.  A token that is not the plain argmax must still be within
# TOKEN_DELTA of it.
PREFILL_LOGIT_ATOL = 0.125
TOKEN_DELTA = 0.125
# Training: the flagship generator's config (GEN_DIMS) in bf16 on the copy
# task of bench.py:2105-2108 (rows head|head|head, bhalf = 171, so tokens
# [16, 513] and S = 512), adam(3e-4) as bench.py:2118
TRAIN_B, TRAIN_HALF, TRAIN_STEPS, TRAIN_LR = 16, 171, 20, 3e-4
# One step's gradients, kernel path vs plain path (use_flash=False), per
# leaf as ||g_kernel - g_plain|| / ||g_plain||.  Both are bf16 training, but
# the plain path's autograd rounds dP to bf16 and keeps ds and dq in f32,
# where the kernels keep dP in f32 and round ds to bf16, and the forward's o
# differs by 1-2 bf16 ulps (p rounded at the running vs the final row max):
# each element moves by about 2^-8 of itself, independently, and 12 layers
# of bf16 activations carry it down.  5e-2 (~13 x 2^-8) leaves room for
# that and still catches a wrong term (a wrong head's dQ/dK/dV is O(1)).
TRAIN_GRAD_REL_L2 = 5e-2
TRAIN_LOSS_RTOL = 1e-3   # the loss is a mean over 8,192 tokens of f32 nll
# Flash decode, kernel vs plain two-tier attention, bf16 o: FLASH_O_ATOL, for
# its reason (p rounds to bf16 at each slot's running max in the kernel and
# at the global max in the plain version; o rounds to bf16).  Shapes (B, KV,
# G, hd, main slots, n_main, chunk slots, n_chunk): the served layer (63
# chunk slots: 64 new tokens) at three chunk fills, B = 1, the 100-token
# prompt, main 640 full and 600 of 640 valid, hd 128 and 256, MHA at hd 64
# and 256 (one query row a block: the layout whose mbarriers need rounding
# up to 8 bytes), and B = 1 at 1, 17, 309 (a cluster of 4) and 640
# positions (a cluster of 8).  Together they plan clusters of 1, 2, 4 and 8.
DECODE_SHAPES = [(32, 4, 4, 64, 512, 512, 63, 1), (32, 4, 4, 64, 512, 512, 63, 32),
                 (32, 4, 4, 64, 512, 512, 63, 63), (1, 4, 4, 64, 512, 512, 63, 17),
                 (32, 4, 4, 64, 100, 100, 63, 9), (32, 4, 4, 64, 640, 640, 63, 9),
                 (4, 4, 4, 64, 640, 600, 63, 9), (4, 4, 4, 128, 512, 512, 63, 9),
                 (4, 4, 4, 256, 512, 512, 63, 9), (8, 16, 1, 64, 512, 512, 63, 9),
                 (4, 16, 1, 256, 512, 512, 63, 9), (1, 4, 4, 64, 512, 0, 63, 1),
                 (1, 4, 4, 64, 512, 0, 63, 17), (1, 4, 4, 64, 512, 300, 63, 9),
                 (1, 4, 4, 64, 640, 640, 63, 0)]
# the decode step's fused call (write and attention) at the served layer:
# the fresh row into the chunk after 0, 31 and 62 tokens, and into main's
# last slot with an empty chunk
FUSED_CHUNKS = (1, 32, 63, 0)
# the served layer at two chunk fills, and the 1-row SSE stream's layer
DECODE_TIMED = [(32, 4, 4, 64, 512, 512, 63, 32), (32, 4, 4, 64, 512, 512, 63, 63),
                (1, 4, 4, 64, 512, 512, 63, 17)]
# The served decode step reads a different cache in each of its 12 layers
# (~214 MB a step), so its kernel finds its K/V in HBM, not in the 50 MB
# L2: the decode times rotate over input sets of at least this many bytes.
DECODE_COLD_BYTES = 256 * 2**20
# the flash-attention and flash-decode designs, for the kernels line
FLASH_DESIGN = ("persistent CTAs (one per SM) over 128-row query tiles: two consumer "
                "warpgroups taking turns, one TMA producer warp, two Q buffers and a 3-stage "
                "mbarrier ring of K/V in 128-byte-swizzled shared memory, QK^T and PV by "
                "wgmma (P from registers), base-2 online softmax")
FLASH_BWD_DESIGN = ("persistent CTAs over items taken longest first in a snake (dQ: one CTA "
                    "per SM, two consumer warpgroups taking turns; dK/dV: two one-warpgroup "
                    "CTAs per SM); one TMA producer warp, two own buffers and a 4-stage "
                    "mbarrier ring in 128-byte-swizzled shared memory; every product wgmma "
                    "m64n64k16 (SS for S and dP, RS with P/dS from registers and the streamed "
                    "tile as an MN-major B); exp2 with the scale folded in; dQ also makes "
                    "dsum; two passes, no atomics")
MLP_DESIGN = ("the weights split over a thread-block cluster of 1-16 blocks a tile of 8-64 "
              "batch rows (mlp_plan), every slice in flight at entry by TMA on one mbarrier a "
              "layer, mma.sync m16n8k16 with A and B swapped, the k-steps in 8 classes summed "
              "in a fixed tree, activations pushed to the next layer's ranks by st.async "
              "through distributed shared memory (completing on their barriers), logits and "
              "softmax on rank 0: one launch")
DECODE_DESIGN = ("positions split across a thread-block cluster of 1-8 blocks "
                 "(decode_split_plan), a bulk-copy (cp.async.bulk) ring of K/V rows on "
                 "mbarriers, f32 FMAs, slots combined in shared memory and blocks on rank 0 "
                 "through distributed shared memory; the decode step's K/V write fused in "
                 "(the ring stops short of the fresh slot, which its lanes fill from the input, "
                 "the kernel templated on the write): one launch")
STREAM_CHUNK = 8          # tokens per SSE frame in the stream phase
STREAM_LONG = (4, 300)    # the in-process stream: rows, new tokens (two grow_merges)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, iters: int) -> float:
    """Device time per call: ``fn`` enqueued ``iters`` times behind a GPU
    sleep, so the host's enqueue cost never shows between the events."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s: the host enqueues meanwhile
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def mlp_bound(dims, batch: int):
    """Least time for the work: bytes (x read once, weights + biases read
    once, probabilities written once) over HBM bandwidth, against the
    matmul FLOPs over the bf16 peak; the larger one bounds."""
    layer_bytes = sum(k * n * 2 + n * 2 for k, n in zip(dims[:-1], dims[1:]))
    nbytes = batch * dims[0] * 4 + layer_bytes + batch * dims[-1] * 4
    flops = 2 * batch * sum(k * n for k, n in zip(dims[:-1], dims[1:]))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def random_params(torch, mlp_init, hidden: int, gen, device):
    params = mlp_init(gen, hidden=hidden, depth=2, device=device)
    for k in list(params):
        if k.startswith("b"):  # non-zero biases, so the bias add is checked
            params[k] = (torch.randn(params[k].shape, generator=gen) * 0.1).to(
                torch.bfloat16).to(device)
    return params


class ServerThread:
    """The port's REST lane on its own event loop and thread: an engine's
    routes, or with ``serve`` (``rest.serve_unit``) a unit microservice's
    over the node runtime given as ``engine``."""

    def __init__(self, engine, serve=None):
        self.engine = engine
        self.serve = serve
        self.loop = asyncio.new_event_loop()
        self.server = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self._up = threading.Event()
        self._error = None

    def _run(self):
        from seldon_core_tpu_torch.runtime.rest import serve_fast

        asyncio.set_event_loop(self.loop)
        try:
            self.server = self.loop.run_until_complete(
                (self.serve or serve_fast)(self.engine, "127.0.0.1", 0))
        except BaseException as e:  # noqa: BLE001 - reported to start()
            self._error = e
            self._up.set()
            return
        self._up.set()
        self.loop.run_forever()

    def start(self) -> int:
        self.thread.start()
        if not self._up.wait(60) or self._error is not None:
            raise RuntimeError(f"REST lane did not start: {self._error!r}")
        return self.server.port

    def stop(self, close_engine: bool = True):
        if self.server is not None:
            asyncio.run_coroutine_threadsafe(self.server.stop(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        if close_engine:
            self.engine.close()


def request(method: str, url: str, body=None):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        method=method, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def check_answer(status, raw, n_rows: int, kind: str):
    if status != 200:
        raise AssertionError(f"HTTP {status}: {raw[:300]!r}")
    doc = json.loads(raw)
    data = doc["data"]
    if kind not in data:
        raise AssertionError(f"response lost the request's wire kind {kind!r}: {list(data)}")
    if kind == "ndarray":
        y = np.asarray(data["ndarray"], dtype=np.float64)
    else:
        y = np.asarray(data["tensor"]["values"], dtype=np.float64).reshape(
            data["tensor"]["shape"])
    if y.shape != (n_rows, 10):
        raise AssertionError(f"answer shape {y.shape} != {(n_rows, 10)}")
    if not np.isfinite(y).all() or np.abs(y.sum(axis=1) - 1.0).max() > 1e-3:
        raise AssertionError("answer rows are not finite probabilities summing to 1")
    return y


def flash_build_checks(torch, fa) -> None:
    """The flash kernels' own shape checks (flash_attention_smem_bytes and
    flash_attention_bwd_smem_bytes): the served and trained head shape is
    taken, two others refused, and the backward takes every head dim the
    forward takes."""
    smem, why = fa._smem_bytes(64, GEN_S, torch.bfloat16)
    # two Q buffers (128 x 64), three stages of K and V (128 x 64 each), the
    # 1 KiB swizzle alignment and ten mbarriers
    if why is not None or smem != 2 * 128 * 64 * 2 + 3 * 2 * 128 * 64 * 2 + 1024 + 10 * 8:
        raise AssertionError(f"flash shape check at D=64 S={GEN_S}: {smem} bytes, {why!r}")
    for head_dim, dtype, match in ((40, torch.bfloat16, "multiple of 16"),
                                   (64, torch.float32, "bfloat16")):
        why = fa.kernel_shape_error(head_dim, dtype)
        if why is None or match not in why:
            raise AssertionError(f"flash shape check let D={head_dim} {dtype} through: {why!r}")
    log(f"[build] flash shape check: D=64 bf16 takes {smem} bytes of shared memory; "
        f"D=40 and float32 refused")
    bwd = {d: fa._smem_bytes(d, GEN_S, torch.bfloat16, bwd=True) for d in (16, 64, 128, 256)}
    # the larger kernel, dQ: two own buffers of Q, dO and o (128 x 64 each),
    # four stages of K and V (64 x 64 each), the 1 KiB swizzle alignment and
    # twelve mbarriers
    dq_smem = 2 * 3 * 128 * 64 * 2 + 4 * 2 * 64 * 64 * 2 + 1024 + 12 * 8
    if bwd[64] != (dq_smem, None) or any(w for _, w in bwd.values()):
        raise AssertionError(f"flash backward shape check: {bwd}")
    for head_dim, dtype, match in ((40, torch.bfloat16, "multiple of 16"),
                                   (64, torch.float32, "bfloat16")):
        why = fa.bwd_kernel_shape_error(head_dim, dtype)
        if why is None or match not in why:
            raise AssertionError(f"flash backward shape check let D={head_dim} {dtype} "
                                 f"through: {why!r}")
    log(f"[build] flash backward shape check: D=16, 64, 128, 256 bf16 take "
        f"{[bwd[d][0] for d in (16, 64, 128, 256)]} bytes of shared memory; D=40 and float32 "
        f"refused")


def decode_build_checks(torch, fd) -> None:
    """The flash-decode kernel's own shape check (flash_decode_smem_bytes):
    the served head shape and MHA at hd=256 are taken, three others
    refused."""
    smem, why = fd._smem_bytes(64, 4, torch.bfloat16)
    # the ring (4 stages of 2 x 32 positions' K and V rows), the slot
    # weights (32 slots x 4 rows), up to 8 ranks' (m, l, acc) per row and
    # the ring's 4 mbarriers
    if why is not None or smem != (4 * 2 * 32 * 64 * 4 + 32 * 4 * 4 + 8 * 4 * (64 + 2) * 4
                                   + 4 * 8):
        raise AssertionError(f"flash-decode shape check at hd=64 G=4: {smem} bytes, {why!r}")
    # hd=256, one row: 8 slots, so 9 weight floats put the mbarriers at an
    # odd float offset, which the layout rounds up to 8 bytes
    mha, why = fd._smem_bytes(256, 1, torch.bfloat16)
    floats = 4 * 2 * 8 * 256 + 9 + 8 * (256 + 2)
    if why is not None or mha != ((floats + 1) // 2 * 2) * 4 + 4 * 8:
        raise AssertionError(f"flash-decode shape check at hd=256 G=1: {mha} bytes, {why!r}")
    for head_dim, dtype, match in ((36, torch.bfloat16, "multiple of 8"),
                                   (512, torch.bfloat16, "up to 256"),
                                   (64, torch.float32, "bfloat16")):
        why = fd.decode_kernel_shape_error(head_dim, dtype, 4)
        if why is None or match not in why:
            raise AssertionError(f"flash-decode shape check let hd={head_dim} {dtype} "
                                 f"through: {why!r}")
    log(f"[build] flash-decode shape check: hd=64 G=4 bf16 takes {smem} bytes of shared "
        f"memory, hd=256 G=1 {mha} (mbarriers 8-byte aligned); hd=36, hd=512 and float32 "
        f"refused")


def paged_build_checks(torch, fd) -> None:
    """The paged kernel's own shape check (flash_decode_paged_smem_bytes):
    the served head shape and 16 query heads at hd=256 are taken, four
    others refused."""
    # 8 warps x 2 stages of a 16-position tile's K and V (one 2 KB box
    # each), then the 16 mbarriers and 1024 bytes of alignment; the combine
    # scratch fits inside the ring
    smem, why = fd._paged_smem_bytes(64, 4, PAGED_BS, torch.bfloat16)
    if why is not None or smem != 8 * 2 * 2 * 2048 + 16 * 8 + 1024:
        raise AssertionError(f"paged shape check at hd=64 G=4: {smem} bytes, {why!r}")
    # hd=256, 16 rows: 4 warps, one stage of 4 boxes of K and V each (64
    # KB), and beyond it the warps' (m, l, acc), the weights and 8 ranks'
    # gather
    big, why = fd._paged_smem_bytes(256, 16, PAGED_BS, torch.bfloat16)
    floats = 4 * 16 * 258 + 10 * 16 + 8 * 16 * 258
    if why is not None or big != floats * 4 + 4 * 8 + 1024:
        raise AssertionError(f"paged shape check at hd=256 G=16: {big} bytes, {why!r}")
    # the f32 path at the speculative example's draft (hd 32, one query row
    # a block): 8 warps x 4 stages of a tile's K and V (a 1 KB box each;
    # the warps' (m, l, acc), the weights and 8 ranks' gather fit inside),
    # q (32 floats), the 32 mbarriers and 1024 bytes of alignment
    f32, why = fd._paged_smem_bytes(32, 1, PAGED_BS, torch.float32)
    if why is not None or f32 != 8 * 4 * 2 * 1024 + 32 * 4 + 32 * 8 + 1024:
        raise AssertionError(f"paged shape check at hd=32 G=1 float32: {f32} bytes, {why!r}")
    for head_dim in range(8, 257, 8):  # paged_f32_layout is the source's layout_f32
        for group in (1, 2, 3, 4, 8, 16):
            n, why = fd._paged_smem_bytes(head_dim, group, PAGED_BS, torch.float32)
            if why is not None or n != fd.paged_f32_layout(head_dim, group)["bytes"]:
                raise AssertionError(f"the f32 layout's Python statement differs from the "
                                     f"source at hd={head_dim} G={group}: {n}, {why!r}")
    for head_dim, dtype, bs, match in ((36, torch.bfloat16, 16, "multiple of 8 up to"),
                                       (512, torch.bfloat16, 16, "up to 256"),
                                       (64, torch.float16, 16, "bfloat16 or float32"),
                                       (64, torch.bfloat16, 12, "pool blocks of 12")):
        why = fd.paged_kernel_shape_error(head_dim, dtype, 4, bs)
        if why is None or match not in why:
            raise AssertionError(f"paged shape check let hd={head_dim} {dtype} bs={bs} "
                                 f"through: {why!r}")
    log(f"[build] paged flash-decode shape check: hd=64 G=4 bf16 in blocks of {PAGED_BS} takes "
        f"{smem} bytes of shared memory, hd=256 G=16 {big}, hd=32 G=1 float32 {f32}; hd=36, "
        f"hd=512, float16 and blocks of 12 refused")


def decode_inputs(torch, shape, gen, dev):
    B, KV, G, hd, Lm, _, C, _ = shape

    def rnd(*dims):
        return torch.randn(*dims, generator=gen).to(torch.bfloat16).to(dev)

    return (rnd(B, KV, G, hd), rnd(B, KV, Lm, hd), rnd(B, KV, Lm, hd), rnd(B, KV, C, hd),
            rnd(B, KV, C, hd))


def head_views(torch, B, W, KV, hd, gen, dev):
    """k, v [B, KV, W, hd] bf16 as strided head views of a qkv row, as the
    served step makes them, drawn from ``gen`` on its own device."""
    qkv = torch.randn(B, W, 6 * KV * hd, generator=gen, device=gen.device)
    qkv = qkv.to(torch.bfloat16).to(dev)
    k = qkv[..., 4 * KV * hd:5 * KV * hd].reshape(B, W, KV, hd).transpose(1, 2)
    v = qkv[..., 5 * KV * hd:].reshape(B, W, KV, hd).transpose(1, 2)
    return k, v


def decode_kernel_phase(torch, fd, kw, dev) -> dict:
    """The decode-kernel phase: flash_decode_two_tier and flash_decode
    against their plain versions (each call one launch, a repeat the same
    bits), and kv_write bit-exact and in place.  Returns each kernel's
    largest absolute error."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 5)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    max_err, clusters = 0.0, set()
    for shape in DECODE_SHAPES:
        q, mk, mv, ck, cv = decode_inputs(torch, shape, gen, dev)
        n_main, n_chunk = shape[5], shape[7]
        split, span = fd.decode_split_plan(shape[0], shape[1], shape[2], n_main + n_chunk,
                                           sm_count)
        clusters.add(split)
        before = fd.LAUNCHES
        got = fd.flash_decode_two_tier(q, mk, mv, n_main, ck, cv, n_chunk)
        again = fd.flash_decode_two_tier(q, mk, mv, n_main, ck, cv, n_chunk)
        want = fd.flash_decode_two_tier_reference(q, mk, mv, n_main, ck, cv, n_chunk)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if (fd.LAUNCHES != before + 2 or got.dtype != torch.bfloat16 or err > FLASH_O_ATOL
                or not bool(torch.isfinite(got.float()).all())):
            raise AssertionError(f"flash decode vs plain at {shape}: o err {err:.3e} (tolerance "
                                 f"{FLASH_O_ATOL}), launches {fd.LAUNCHES - before}")
        if not torch.equal(got, again):
            raise AssertionError(f"flash decode at {shape} differs between two calls")
        max_err = max(max_err, err)
        log(f"[decode-kernel] (B,KV,G,hd,main,n_main,chunk,n_chunk)={shape}, a cluster of "
            f"{split} ({span} positions a block): o max abs err {err:.3e} (tolerance "
            f"{FLASH_O_ATOL}); a second call bit-identical")
    if clusters != {1, 2, 4, 8}:
        raise AssertionError(f"DECODE_SHAPES planned clusters of {sorted(clusters)}, not 1, 2, 4 "
                             f"and 8")
    q, mk, mv, _, _ = decode_inputs(torch, DECODE_SHAPES[0], gen, dev)
    got = fd.flash_decode(q, mk, mv, 300)
    err = float((got.float() - fd.flash_decode_reference(q, mk, mv, 300).float()).abs().max())
    if err > FLASH_O_ATOL:
        raise AssertionError(f"flash_decode over one cache, n_valid 300 of 512: err {err:.3e}")
    max_err = max(max_err, err)
    log(f"[decode-kernel] flash_decode over one 512-slot cache, n_valid 300: o max abs err "
        f"{err:.3e} (tolerance {FLASH_O_ATOL})")
    B, KV, _, hd, _, _, C, _ = DECODE_SHAPES[0]
    for pos in (0, C // 2, C - 1):
        ck, cv = (torch.randn(B, KV, C, hd, generator=gen).to(torch.bfloat16).to(dev)
                  for _ in range(2))
        k, v = head_views(torch, B, 1, KV, hd, gen, dev)
        want_k, want_v = kw.kv_write_reference(ck.clone(), cv.clone(), k, v, pos)
        ptrs, before = (ck.data_ptr(), cv.data_ptr()), kw.LAUNCHES
        out = kw.kv_write(ck, cv, k, v, pos)
        torch.cuda.synchronize()
        if (kw.LAUNCHES != before + 1 or (out[0].data_ptr(), out[1].data_ptr()) != ptrs
                or not torch.equal(ck, want_k) or not torch.equal(cv, want_v)):
            raise AssertionError(f"kv_write at slot {pos} is not the in-place slice assignment")
    log(f"[decode-kernel] kv_write into ({B},{KV},{C},{hd}) bf16 at slots 0, {C // 2}, {C - 1} "
        f"from strided head views: bit-exact, every other slot untouched, in place")
    # the decode step's call: the step's K/V written in the same launch
    for n_chunk in FUSED_CHUNKS:
        q, mk, mv, ck, cv = decode_inputs(torch, DECODE_SHAPES[0], gen, dev)
        n_main = DECODE_SHAPES[0][5]
        k, v = head_views(torch, B, 1, KV, hd, gen, dev)
        ref = [t.clone() for t in (mk, mv, ck, cv)]
        want = fd.flash_decode_two_tier_reference(q, *ref[:2], n_main, *ref[2:], n_chunk, k, v)
        before = (fd.LAUNCHES, kw.LAUNCHES)
        got = fd.flash_decode_two_tier(q, mk, mv, n_main, ck, cv, n_chunk, k, v)
        again = fd.flash_decode_two_tier(q, mk, mv, n_main, ck, cv, n_chunk, k, v)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if (fd.LAUNCHES - before[0], kw.LAUNCHES - before[1]) != (2, 0) or err > FLASH_O_ATOL \
                or not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"the fused call at n_chunk={n_chunk}: o err {err:.3e}, "
                                 f"launches {fd.LAUNCHES - before[0]} / {kw.LAUNCHES - before[1]}")
        if not all(torch.equal(t, r) for t, r in zip((mk, mv, ck, cv), ref)):
            raise AssertionError(f"the fused call at n_chunk={n_chunk} left the caches other "
                                 f"than kv_write_reference does")
        if not torch.equal(got, again):
            raise AssertionError(f"the fused call at n_chunk={n_chunk} differs between two calls")
        max_err = max(max_err, err)
        where = f"chunk slot {n_chunk - 1}" if n_chunk else f"main slot {n_main - 1}"
        log(f"[decode-kernel] the fused call (B,KV,G,hd)=({B},{KV},4,{hd}), main {n_main} + "
            f"{n_chunk} chunk positions, the fresh row into {where} from strided head views: "
            f"caches bit-exact against kv_write_reference, o max abs err {err:.3e} against "
            f"write-then-attend (tolerance {FLASH_O_ATOL}), a repeat the same bits, one launch "
            f"and no kv_write launch a call")
    log(f"[decode-kernel] phase wall {time.perf_counter() - t0:.2f} s")
    return {"flash_decode": max_err, "kv_write": 0.0}


def decode_bound(shape):
    """Least time for one flash-decode call: K and V of the valid
    positions, q read once and o written once over HBM bandwidth, against
    the score and PV FLOPs over the bf16 peak; the larger one bounds."""
    B, KV, G, hd, _, n_main, _, n_chunk = shape
    n = n_main + n_chunk
    nbytes = 2 * (2 * B * KV * n * hd + 2 * B * KV * G * hd)
    flops = 4 * B * KV * G * n * hd
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def sse_stream(port: int, body: dict):
    """POST /api/v0.1/generate/stream on a raw socket; returns (the parsed
    SSE events, seconds to the first frame, seconds to the terminal
    chunk).  Raises unless the answer is a well-formed chunked 200."""
    import socket

    payload = json.dumps(body).encode()
    t0 = time.perf_counter()
    with socket.create_connection(("127.0.0.1", port), timeout=120) as sock:
        sock.sendall(b"POST /api/v0.1/generate/stream HTTP/1.1\r\nHost: smoke\r\n"
                     b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n"
                     % len(payload) + payload)
        f = sock.makefile("rb")
        status = f.readline()
        head = b""
        while True:
            line = f.readline()
            if line in (b"\r\n", b""):
                break
            head += line.lower()
        if not status.startswith(b"HTTP/1.1 200") or b"transfer-encoding: chunked" not in head:
            raise AssertionError(f"stream answered {status!r} {head!r}")
        events, first = [], None
        while True:
            n = int(f.readline().strip(), 16)
            if n == 0:
                if f.readline() != b"\r\n":
                    raise AssertionError("the terminal chunk is malformed")
                break
            frame = f.read(n)
            if f.read(2) != b"\r\n" or not frame.startswith(b"data: ") or not frame.endswith(
                    b"\n\n"):
                raise AssertionError(f"malformed SSE chunk {frame[:80]!r}")
            if first is None:
                first = time.perf_counter() - t0
            events.append(json.loads(frame[6:]))
    return events, first, time.perf_counter() - t0


def flash_bound(shape, causal: bool = True):
    """Least time for the work: q, k, v read once and o, lse written once
    over HBM bandwidth, against the score and PV FLOPs this run needs (the
    causal pairs only) over the bf16 peak; the larger one bounds."""
    B, H, KV, S, D = shape
    nbytes = 2 * (2 * B * H * S * D + 2 * B * KV * S * D) + 4 * B * H * S
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * H * D * pairs
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def flash_inputs(torch, shape, gen, dev):
    B, H, KV, S, D = shape
    return (torch.randn(B, H, S, D, generator=gen).to(torch.bfloat16).to(dev),
            torch.randn(B, KV, S, D, generator=gen).to(torch.bfloat16).to(dev),
            torch.randn(B, KV, S, D, generator=gen).to(torch.bfloat16).to(dev))


def flash_kernel_phase(torch, fa, dev) -> float:
    """Phase 6: the kernel against its plain version; returns the max abs
    error of o over every shape."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 1)
    max_err = 0.0
    for shape in FLASH_SHAPES:
        q, k, v = flash_inputs(torch, shape, gen, dev)
        # S % 128 != 0 is the kernel's to take, not the JAX contract's
        fwd = fa.flash_attention_fwd if shape[3] % 128 == 0 else fa._launch
        for causal in (True, False):
            o, lse = fwd(q, k, v, causal)
            ro, rlse = fa.flash_attention_reference(q, k, v, causal=causal)
            torch.cuda.synchronize()
            o_err = float((o.float() - ro.float()).abs().max())
            lse_err = float((lse - rlse).abs().max())
            if (not bool(torch.isfinite(o.float()).all()) or o_err > FLASH_O_ATOL
                    or lse_err > FLASH_LSE_ATOL or o.dtype != torch.bfloat16):
                raise AssertionError(
                    f"flash kernel vs plain at {shape} causal={causal}: o err {o_err:.3e} "
                    f"(tolerance {FLASH_O_ATOL}), lse err {lse_err:.3e} "
                    f"(tolerance {FLASH_LSE_ATOL})")
            max_err = max(max_err, o_err)
            log(f"[flash] (B,H,KV,S,D)={shape} causal={causal}: o max abs err {o_err:.3e} "
                f"(tolerance {FLASH_O_ATOL}), lse {lse_err:.3e} (tolerance {FLASH_LSE_ATOL})")
    log(f"[flash] phase wall {time.perf_counter() - t0:.2f} s")
    return max_err


def flash_bwd_bound(shape, kernel: str, causal: bool = True):
    """Least time for one backward kernel's work: its inputs read once and
    its outputs written once over HBM bandwidth (dQ: q, k, v, dO, o, lse
    in, dq and dsum out; dK/dV: q, k, v, dO, lse, dsum in, dk and dv out),
    against the FLOPs of its products over the causal pairs this run needs
    (dQ: q.k, dO.v, ds.k; dK/dV: those of p^T dO, dO.v, ds^T q and q.k)
    over the bf16 peak; the larger one bounds."""
    B, H, KV, S, D = shape
    rows = 2 * 4 * B * H * S                  # lse and dsum, f32
    q_side, kv_side = 2 * B * H * S * D, 2 * B * KV * S * D
    if kernel == "dq":
        nbytes, products = 4 * q_side + 2 * kv_side + rows, 3
    else:
        nbytes, products = 2 * q_side + 4 * kv_side + rows, 4
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = products * 2 * B * H * D * pairs
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def flash_bwd_inputs(torch, fa, shape, gen, dev, causal: bool = True):
    """q, k, v, dO from ``gen`` on the card, and o, lse from the forward
    kernel, as a training step hands them to the backward (S % 128 != 0
    through the kernels' own entries, which the JAX contract refuses)."""
    q, k, v = flash_inputs(torch, shape, gen, dev)
    do = torch.randn(q.shape, generator=gen).to(torch.bfloat16).to(dev)
    fwd = fa.flash_attention_fwd if shape[3] % 128 == 0 else fa._launch
    o, lse = fwd(q, k, v, causal)
    return q, k, v, o, lse, do


def flash_bwd_phase(torch, fa, dev) -> dict:
    """Phase 11: the dQ and dK/dV kernels against the plain backward: dq,
    dk, dv at every shape, causal and not; each call moves each counter by
    exactly 1, and a second call on the same inputs gives the same bits.
    Returns each kernel's largest absolute error."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 3)
    worst = {"dq": 0.0, "dkv": 0.0}
    for shape in FLASH_BWD_SHAPES:
        for causal in (True, False):
            q, k, v, o, lse, do = flash_bwd_inputs(torch, fa, shape, gen, dev, causal)
            bwd = fa.flash_attention_bwd if shape[3] % 128 == 0 else fa._launch_bwd
            n_dq, n_dkv = fa.DQ_LAUNCHES, fa.DKV_LAUNCHES
            got = bwd(q, k, v, o, lse, do, causal)
            if (fa.DQ_LAUNCHES, fa.DKV_LAUNCHES) != (n_dq + 1, n_dkv + 1):
                raise AssertionError(f"one backward at {shape} moved the counters by "
                                     f"{fa.DQ_LAUNCHES - n_dq}, {fa.DKV_LAUNCHES - n_dkv}")
            again = bwd(q, k, v, o, lse, do, causal)
            want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
            torch.cuda.synchronize()
            errs = []
            for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
                scale = float(w.float().abs().max())
                abs_err = float((g.float() - w.float()).abs().max())
                err = abs_err / scale
                if (g.dtype != torch.bfloat16 or g.shape != w.shape
                        or not bool(torch.isfinite(g.float()).all()) or err > BWD_REL_TOL):
                    raise AssertionError(
                        f"flash backward {name} vs plain at {shape} causal={causal}: error "
                        f"{err:.3e} of its largest element {scale:.3e} (tolerance {BWD_REL_TOL})")
                if not torch.equal(g, g2):
                    raise AssertionError(f"flash backward {name} at {shape} causal={causal} "
                                         f"differs between two calls on the same inputs")
                errs.append(err)
                kern = "dq" if name == "dq" else "dkv"
                worst[kern] = max(worst[kern], abs_err)
            log(f"[flash-bwd] (B,H,KV,S,D)={shape} causal={causal}: dq {errs[0]:.3e}, dk "
                f"{errs[1]:.3e}, dv {errs[2]:.3e} of each gradient's largest element "
                f"(tolerance {BWD_REL_TOL}); a second call bit-identical")
            del q, k, v, o, lse, do, got, again, want
    log(f"[flash-bwd] phase wall {time.perf_counter() - t0:.2f} s")
    return worst


def kernel_ms_by_name(torch, fn, iters: int, expect=()) -> dict:
    """Device time per call of each kernel ``fn`` launches, from
    torch.profiler's kernel records over ``iters`` calls (after a warm-up
    call): how a wrapper that launches two kernels is timed kernel by
    kernel.  Every name in ``expect`` must be part of a recorded kernel's
    name: a profiler window that came back without one (it happened on
    the card, once three windows in a row) is taken again after a pause,
    up to five times, and then it raises rather than report a time of 0.
    A kernel's time is its recorded time over its recorded launches: a
    window that lost part of its records (on the card, after earlier
    profiler sessions of the same process, a dQ time of a tenth of its
    byte bound came back) then still gives the time of one call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total, _, counts = trace_kernels(prof, "kernel_times")
        by_name = {k: v / counts[k] for k, v in total.items()}
        if all(any(tag in name for name in by_name) for tag in expect):
            return by_name
    raise AssertionError(f"five profiler windows recorded no kernel named {expect}: "
                         f"{sorted(by_name)}")


def trace_kernels(prof, name: str):
    """({kernel name: summed device ms}, launches, {kernel name: its
    launches}) from a profiler's exported trace."""
    path = ROOT / "build" / f"trace_{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    path.unlink()
    by_name: dict = {}
    counts: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            counts[e["name"]] = counts.get(e["name"], 0) + 1
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e.get("dur", 0.0)) / 1e3
    return by_name, sum(counts.values()), counts


def gen_deployment(weights_path: str = "", params=None,
                   class_path: str = "TransformerGenerator") -> dict:
    """The flagship generator's deployment (GEN_DIMS, quant none), with
    ``params`` added or replacing GEN_DIMS's (a None value drops one)."""
    values = {**GEN_DIMS, "quant": "none", **(params or {})}
    if weights_path:
        values["weights_path"] = weights_path
    parameters = [{"name": k, "value": str(v),
                   "type": "FLOAT" if isinstance(v, float) else
                   "STRING" if isinstance(v, str) else "INT"}
                  for k, v in values.items() if v is not None]
    return {"spec": {"name": "gen-flagship", "predictors": [{
        "name": "main",
        "graph": {"name": "gen", "type": "MODEL"},
        "components": [{"name": "gen", "runtime": "inprocess",
                        "class_path": class_path, "parameters": parameters}],
    }]}}


def check_tokens(status, raw, prompts: np.ndarray, kind: str,
                 new: int = GEN_DIMS["max_new_tokens"], vocab: int = GEN_DIMS["vocab"]
                 ) -> np.ndarray:
    if status != 200:
        raise AssertionError(f"HTTP {status}: {raw[:300]!r}")
    data = json.loads(raw)["data"]
    if kind not in data:
        raise AssertionError(f"response lost the request's wire kind {kind!r}: {list(data)}")
    if kind == "ndarray":
        y = np.asarray(data["ndarray"], dtype=np.float64)
    else:
        y = np.asarray(data["tensor"]["values"], dtype=np.float64).reshape(
            data["tensor"]["shape"])
    want = (len(prompts), new)
    if y.shape != want:
        raise AssertionError(f"answer shape {y.shape} != {want}")
    if (not np.isfinite(y).all() or (y != np.round(y)).any() or y.min() < 0
            or y.max() >= vocab):
        raise AssertionError("answer rows are not token ids in [0, vocab)")
    return y.astype(np.int64)


def teacher_forced(torch, lm_apply, params, cfg, prompts, toks, dev, kth: int = 1):
    """Each generated token's gap to the plain path's ``kth`` largest logit
    at its position (prompt + the tokens before it, attention="xla"; 1: the
    maximum), and whether it is the maximum."""
    S, n = prompts.shape[1], toks.shape[1]
    seq = np.concatenate([prompts, toks[:, :-1]], axis=1)
    with torch.inference_mode():
        logits = lm_apply(params, torch.as_tensor(seq, dtype=torch.int32, device=dev), cfg,
                          use_flash=False)
        rows = logits[:, S - 1:S - 1 + n, :]
        tok = torch.as_tensor(toks, dtype=torch.long, device=dev)
        gap = rows.topk(kth, dim=-1).values[..., -1] - rows.gather(-1, tok[..., None])[..., 0]
        exact = rows.argmax(dim=-1) == tok
        del logits, rows
    return gap.cpu().numpy(), exact.cpu().numpy()


def wall_p50(torch, fn, runs: int) -> float:
    """Host-clock p50 in ms of ``fn`` ending in a synchronize, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return float(np.median(walls) * 1e3)


def device_profile(torch, fn, name: str, by_name: bool = False) -> dict:
    """One call of ``fn`` (after a warm-up call) under torch.profiler: the
    host wall, the summed device time of its kernels, their count, and the
    kernels that took the most device time, read from the exported trace's
    kernel events.  The profiler's own host cost lengthens the wall, so the
    busy share is a lower bound."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    names, n_kernels, _ = trace_kernels(prof, name)
    kernel_ms = sum(names.values())
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    prof = {"wall_ms": wall_ms, "kernel_ms": kernel_ms, "busy_share": kernel_ms / wall_ms,
            "kernels": n_kernels, "top_ms": [[k[:90], v] for k, v in top]}
    return {**prof, "by_name": names} if by_name else prof


def generation_phases(torch, dev, smi) -> list:
    """Phases 6-10; returns the flash_attention, flash_decode and kv_write
    rows of the kernels line."""
    from seldon_core_tpu_torch.graph.defaulting import default_and_validate
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.models.generate import init_cache, prefill, sample_token, generate
    from seldon_core_tpu_torch.models.transformer import lm_apply
    from seldon_core_tpu_torch.ops import flash_attention as fa, flash_decode as fd, fused_mlp
    from seldon_core_tpu_torch.ops import kv_write as kw

    max_err = flash_kernel_phase(torch, fa, dev)
    decode_errs = decode_kernel_phase(torch, fd, kw, dev)

    # -- 8. gen ---------------------------------------------------------------
    t_phase = time.perf_counter()
    spec = default_and_validate(SeldonDeploymentSpec.from_json_dict(gen_deployment()))
    from seldon_core_tpu_torch.runtime.engine import EngineService

    t0 = time.perf_counter()
    probes_before = (fa.LAUNCHES, fd.LAUNCHES, kw.LAUNCHES)
    engine = EngineService(spec, device=dev)
    unit = engine.compiled.units["gen"]
    probes = tuple(n - b for n, b in zip((fa.LAUNCHES, fd.LAUNCHES, kw.LAUNCHES), probes_before))
    if not unit.use_flash or probes != (1, 1, 0):
        raise AssertionError(f"the generator did not probe and take the flash and flash-decode "
                             f"kernels, the decode probe with the write fused in, and no "
                             f"kv_write (use_flash={unit.use_flash}, probe launches {probes})")
    cfg = unit.cfg
    params = engine.states()["gen"]["params"]
    n_params = sum(t.numel() for layer in params.values()
                   for t in (layer.values() if isinstance(layer, dict) else [layer]))
    log(f"[gen] engine built in {time.perf_counter() - t0:.2f} s: {n_params / 1e6:.1f} M "
        f"params ({cfg.dtype}), the unit probed the flash and flash-decode kernels once each "
        f"(the decode probe with the step's write fused in), kv_write not at all")
    dispatches = []
    batched = engine._batched_predict_sync

    def counted(stacked, *rest):  # every stacked dispatch's shape, in order
        dispatches.append(tuple(stacked.shape))
        return batched(stacked, *rest)

    engine._batched_predict_sync = counted
    server = ServerThread(engine)
    port = server.start()
    url = f"http://127.0.0.1:{port}/api/v0.1/predictions"
    rng = np.random.default_rng(SEED)
    vocab = GEN_DIMS["vocab"]
    p1 = rng.integers(0, vocab, size=(1, GEN_S))
    p32 = rng.integers(0, vocab, size=(GEN_B, GEN_S))
    p8 = [rng.integers(0, vocab, size=(1, GEN_S)) for _ in range(8)]
    p100 = rng.integers(0, vocab, size=(1, 100))
    new = GEN_DIMS["max_new_tokens"]
    try:
        fa.LAUNCHES = fd.LAUNCHES = kw.LAUNCHES = 0
        fused_mlp.LAUNCHES = 0
        s1 = request("POST", url, {"data": {"ndarray": p1.tolist()}})
        s32 = request("POST", url, {"data": {"tensor": {"shape": list(p32.shape),
                                                         "values": p32.ravel().tolist()}}})
        with ThreadPoolExecutor(8) as pool:
            s8 = list(pool.map(lambda x: request("POST", url, {"data": {"ndarray": x.tolist()}}),
                               p8))
        launches = fa.LAUNCHES
        eligible = sum(1 for d in dispatches if d[1] % 128 == 0)
        s100 = request("POST", url, {"data": {"ndarray": p100.tolist()}})
        launches_after_100 = fa.LAUNCHES
        decode_launches = {"flash_decode": fd.LAUNCHES, "kv_write": kw.LAUNCHES}
        n_dispatch = len(dispatches)  # the latency loop below dispatches after the read
        mlp_launches = fused_mlp.LAUNCHES
        st_stats, raw_stats = request("GET", f"http://127.0.0.1:{port}/stats")
        # the 32-row request's wall, after the counts were read
        body32 = {"data": {"tensor": {"shape": list(p32.shape), "values": p32.ravel().tolist()}}}
        walls32 = []
        for _ in range(3):
            t = time.perf_counter()
            st, _raw = request("POST", url, body32)
            walls32.append(time.perf_counter() - t)
            if st != 200:
                raise AssertionError(f"32-row latency loop: HTTP {st}")
    finally:
        server.stop(close_engine=False)
    if launches != 12 * eligible or eligible < 3:
        raise AssertionError(f"flash launches {launches} != 12 x {eligible} kernel-eligible "
                             f"prefill dispatches ({dispatches})")
    if launches_after_100 != launches:
        raise AssertionError(f"the 100-token prompt launched the flash kernel "
                             f"{launches_after_100 - launches} times")
    if mlp_launches != 0:
        raise AssertionError(f"the generation run launched the fused-MLP kernel {mlp_launches} times")
    want_decode = cfg.n_layers * (new - 1) * n_dispatch
    if decode_launches != {"flash_decode": want_decode, "kv_write": 0}:
        raise AssertionError(f"decode launches {decode_launches}, not {cfg.n_layers} x {new - 1} "
                             f"flash_decode per dispatch over {n_dispatch} dispatches and no "
                             f"kv_write (the step's write is fused into flash_decode)")
    stats = json.loads(raw_stats)
    if st_stats != 200 or stats["kernels"]["flash_attention"]["launches"] != launches_after_100 \
            or {k: stats["kernels"][k]["launches"] for k in decode_launches} != decode_launches:
        raise AssertionError(f"/stats does not report the kernel launches: {raw_stats[:400]!r}")
    log(f"[gen] dispatches {dispatches}: {eligible} kernel-eligible prefills; flash launches "
        f"{launches} = 12 x {eligible}; the 100-token prompt launched none "
        f"({launches_after_100} after it); fused-MLP launches 0")
    log(f"[gen] decode: flash_decode {decode_launches['flash_decode']} launches = "
        f"{cfg.n_layers} x {new - 1} x {n_dispatch} dispatches, the 100-token prompt included, "
        f"each with the step's K/V write; kv_write {decode_launches['kv_write']}; /stats agrees")

    # correctness: every served token teacher-forced through the plain path
    y1 = check_tokens(*s1, p1, "ndarray")
    y32 = check_tokens(*s32, p32, "tensor")
    y8 = np.concatenate([check_tokens(*r, x, "ndarray") for r, x in zip(s8, p8)])
    y100 = check_tokens(*s100, p100, "ndarray")
    gaps, exacts = [], []
    for prompts, toks in ((p32, y32), (np.concatenate([p1] + p8), np.concatenate([y1, y8])),
                          (p100, y100)):
        gap, exact = teacher_forced(torch, lm_apply, params, cfg, prompts, toks, dev)
        gaps.append(gap.ravel())
        exacts.append(exact.ravel())
    gaps, exacts = np.concatenate(gaps), np.concatenate(exacts)
    log(f"[gen] teacher-forced, {gaps.size} served tokens: gap to the plain maximum "
        f"max {gaps.max():.5f}, p99 {np.quantile(gaps, 0.99):.5f}, mean {gaps.mean():.6f} "
        f"(delta {TOKEN_DELTA}); {exacts.mean() * 100:.2f}% equal the plain argmax")
    if gaps.max() > TOKEN_DELTA:
        raise AssertionError(f"a served token is {gaps.max():.4f} below the plain maximum "
                             f"(delta {TOKEN_DELTA})")
    tok32 = torch.as_tensor(p32, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        lk, _ = prefill(params, tok32, init_cache(cfg, GEN_B, GEN_S, dev), cfg, use_flash=True)
        lp, _ = prefill(params, tok32, init_cache(cfg, GEN_B, GEN_S, dev), cfg, use_flash=False)
        logit_err = float((lk - lp).abs().max())
        same_first = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    log(f"[gen] prefill last-position logits, kernel vs plain attention: max abs err "
        f"{logit_err:.5f} (tolerance {PREFILL_LOGIT_ATOL}), first tokens equal "
        f"{same_first * 100:.1f}%")
    if not bool(torch.isfinite(lk).all()) or logit_err > PREFILL_LOGIT_ATOL:
        raise AssertionError(f"prefill logits differ by {logit_err} > {PREFILL_LOGIT_ATOL}")
    log(f"[gen] phase wall {time.perf_counter() - t_phase:.2f} s")

    stream = stream_phase(torch, dev, engine, params, cfg, p1, smi)

    # -- 10. times ------------------------------------------------------------
    t_phase = time.perf_counter()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator().manual_seed(SEED + 2)
    timings = []
    for shape in FLASH_TIMED:
        q, k, v = flash_inputs(torch, shape, gen, dev)
        k_ms = device_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, True), 20)
        p_ms = device_ms(torch, lambda: fa.flash_attention_reference(q, k, v, True), 10)
        l_ms = device_ms(torch, lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), 20)
        b_ms, b_by = flash_bound(shape)
        timings.append({"shape": list(shape), "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                        "bound_ms": b_ms, "bound_by": b_by})
        log(f"[times] flash (B,H,KV,S,D)={shape} causal: kernel {k_ms:.5f} ms, plain "
            f"{p_ms:.5f} ms, SDPA {l_ms:.5f} ms, bound {b_ms:.6f} ms ({b_by}) on {smi}")
        del q, k, v
    decode_rows = decode_times(torch, fd, kw, dev, smi, gen)
    with torch.inference_mode():
        def first_token(use_flash=True):
            logits, _ = prefill(params, tok32, init_cache(cfg, GEN_B, GEN_S, dev), cfg,
                                use_flash=use_flash)
            return sample_token(logits)

        # the kernels and attention="xla" (the plain path) in turns, ABBA,
        # 2 walls each: the host's launch rate moves between runs and calls
        walls = {"ttft": ([], []), "generate": ([], [])}
        fns = {"ttft": lambda uf: first_token(uf),
               "generate": lambda uf: generate(params, tok32, cfg, new, use_flash=uf)}
        for name, fn in fns.items():
            for uf in (True, False):
                fn(uf)  # warm-up
            for _ in range(GEN_WALL_TURNS):
                for uf in (True, False, False, True):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    fn(uf)
                    torch.cuda.synchronize()
                    walls[name][0 if uf else 1].append(time.perf_counter() - t)
        quart = {name: [[float(q) for q in np.percentile(np.asarray(w) * 1e3, [25, 50, 75])]
                        for w in pair] for name, pair in walls.items()}
        med = {name: [qs[1] for qs in pair] for name, pair in quart.items()}
    ttft_ms, ttft_xla_ms = med["ttft"]
    gen_ms, gen_xla_ms = med["generate"]
    served = {
        "ttft_p50_ms": ttft_ms,
        "generate_p50_ms": gen_ms,
        "request32_wall_p50_ms": float(np.median(walls32) * 1e3),
        "decode_tokens_per_s": GEN_B * (new - 1) / ((gen_ms - ttft_ms) / 1e3),
        "xla_ttft_p50_ms": ttft_xla_ms,
        "xla_generate_p50_ms": gen_xla_ms,
        "xla_decode_tokens_per_s": GEN_B * (new - 1) / ((gen_xla_ms - ttft_xla_ms) / 1e3),
        "kernel_share_of_prefill": 12 * timings[0]["ms"] / ttft_ms,
        "wall_quartiles_ms": {f"{name}{tag}": quart[name][i] for name in quart
                              for i, tag in ((0, ""), (1, "_xla"))},
        "stream": stream,
        "card": smi,
    }
    log(f"[times] {GEN_B}x{GEN_S} prefill (TTFT) p50 {ttft_ms:.3f} ms; generate({new} new) p50 "
        f"{gen_ms:.3f} ms; the 32-row REST request p50 {served['request32_wall_p50_ms']:.3f} "
        f"ms; decode {served['decode_tokens_per_s']:.1f} tokens/s; flash kernel "
        f"{served['kernel_share_of_prefill'] * 100:.2f}% of the prefill, on {smi}")
    log(f"[times] attention=\"xla\" (no kernel), in turns with the above: TTFT p50 "
        f"{ttft_xla_ms:.3f} ms; generate p50 {gen_xla_ms:.3f} ms; decode "
        f"{served['xla_decode_tokens_per_s']:.1f} tokens/s, on {smi}")
    log(f"[times] generate walls p25/p50/p75 over {2 * GEN_WALL_TURNS} each: kernels "
        f"{'/'.join(f'{q:.3f}' for q in quart['generate'][0])} ms, xla "
        f"{'/'.join(f'{q:.3f}' for q in quart['generate'][1])} ms")
    log(json.dumps({"served_generation": served}))
    profiles = {}
    with torch.inference_mode():
        for name, fn in (("prefill", first_token),
                         ("generate", lambda: generate(params, tok32, cfg, new, use_flash=True)),
                         ("prefill_xla", lambda: first_token(False)),
                         ("generate_xla", lambda: generate(params, tok32, cfg, new,
                                                           use_flash=False))):
            prof = device_profile(torch, fn, name, by_name=name == "generate")
            profiles[name] = prof
            log(f"[times] profiled {name} (B={GEN_B}, S={GEN_S}): wall {prof['wall_ms']:.3f} ms, "
                f"device kernels {prof['kernel_ms']:.3f} ms in {prof['kernels']} launches, "
                f"busy {prof['busy_share'] * 100:.1f}% on {smi}")
            log(json.dumps({f"profile_{name}": {k: v for k, v in prof.items() if k != "by_name"}}))
    for tag in ("", "_xla"):
        gen_p, pre_p = profiles[f"generate{tag}"], profiles[f"prefill{tag}"]
        per_step = (gen_p["kernels"] - pre_p["kernels"]) / (new - 1)
        step_ms = (gen_p["kernel_ms"] - pre_p["kernel_ms"]) / (new - 1)
        served[f"decode_launches_per_step{tag}"] = per_step
        served[f"decode_device_ms_per_step{tag}"] = step_ms
        log(f"[times] decode{' (xla)' if tag else ''}: {per_step:.1f} launches and {step_ms:.4f} "
            f"ms of device kernels per step (generate minus prefill, over {new - 1} steps)")
    fd_ms = sum(v for k, v in profiles["generate"]["by_name"].items() if "flash_decode_kernel" in k)
    served["flash_decode_ms_per_call_in_generate"] = fd_ms / (cfg.n_layers * (new - 1))
    log(f"[times] flash_decode_kernel in the profiled generate: "
        f"{served['flash_decode_ms_per_call_in_generate']:.5f} ms per call over "
        f"{cfg.n_layers * (new - 1)} calls (n = 513..575 positions), on {smi}")
    log(f"[times] phase wall {time.perf_counter() - t_phase:.2f} s")
    top = timings[0]
    flash_row = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "seldon_core_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "seldon_core_tpu/ops/flash_attention.py:56",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "design": FLASH_DESIGN,
        "shape": "B=32 H=16 KV=4 S=512 D=64 causal bf16",
        "at": timings,
        "served": served,
    }
    rows = [flash_row]
    for name, source, replaces, shape_text in (
            ("flash_decode", "flash_decode.cu", "seldon_core_tpu/ops/flash_decode.py:47",
             "B=32 KV=4 G=4 hd=64 n_main=512 n_chunk=32 bf16"),
            ("kv_write", "kv_write.cu", "scripts/probe_inplace.py:55",
             "caches (32,4,63,64) bf16, slot 31")):
        top = decode_rows[name][0]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"seldon_core_tpu_torch/ops/csrc/{source}",
            "replaces": replaces,
            "launches": decode_launches[name],
            "max_abs_err": decode_errs[name],
            "ms": top["ms"],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "shape": shape_text,
            "at": decode_rows[name],
        })
    rows[1]["design"] = DECODE_DESIGN
    rows[2]["folded_into"] = ("flash_decode: every decode step's K/V write is done in the "
                              "flash_decode launch that attends over it (flash_decode.cu); "
                              "kv_write itself is held and timed here, and launched on no path")
    return rows


def host_us_per_call(torch, fn, calls: int = 500) -> float:
    """Host wall per call of ``fn`` in microseconds: ``calls`` back-to-back
    calls after a warm-up, the device left to drain after the clock stops
    (the queue holds them all, so the host never waits on the card)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    return host / calls * 1e6


def decode_sets(torch, shape, dev, seed: int, fused: bool = False, int8: bool = False) -> list:
    """Input sets of one decode shape, made on the card, enough of them to
    hold DECODE_COLD_BYTES of K/V together: a run that walks them in turn
    finds each set's K/V evicted from the 50 MB L2, as the served step does.
    A set is (q, main k, main v, chunk k, chunk v); ``fused`` adds the
    step's fresh k, v and the scales (main k_s, v_s, chunk k_s, v_s), None
    for bf16 K/V; ``int8`` (fused only) makes K/V int8 codes with their
    scales (kv_write.int8_kv_rows)."""
    from seldon_core_tpu_torch.ops.kv_write import int8_kv_rows

    B, KV, G, hd, Lm, _, C, _ = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    per_set = (2 * B * KV * (Lm + C) * (hd + 4)) if int8 else 2 * 2 * B * KV * (Lm + C) * hd
    n_sets = max(4, -(-DECODE_COLD_BYTES // per_set))

    def rnd(*dims):
        return torch.randn(*dims, generator=gen, device=dev).to(torch.bfloat16)

    sets = []
    for _ in range(n_sets):
        q = rnd(B, KV, G, hd)
        if not int8:
            kv = (rnd(B, KV, Lm, hd), rnd(B, KV, Lm, hd), rnd(B, KV, C, hd), rnd(B, KV, C, hd))
            sets.append((q, *kv, rnd(B, KV, 1, hd), rnd(B, KV, 1, hd), None) if fused
                        else (q, *kv))
            continue
        (mk, mks), (mv, mvs), (ck, cks), (cv, cvs) = (
            int8_kv_rows((B, KV, L, hd), gen, dev) for L in (Lm, Lm, C, C))
        sets.append((q, mk, mv, ck, cv, rnd(B, KV, 1, hd), rnd(B, KV, 1, hd),
                     (mks, mvs, cks, cvs)))
    return sets


def rotating(sets, fn):
    """A call of ``fn(*set)`` that moves to the next set at every call."""
    state = {"i": 0}

    def call():
        x = sets[state["i"] % len(sets)]
        state["i"] += 1
        return fn(*x)

    return call


def decode_times(torch, fd, kw, dev, smi, gen) -> dict:
    """Device times of the decode kernels beside their plain versions, a
    PyTorch library call and their bounds: flash decode at DECODE_TIMED
    (SDPA over the same positions made dense beforehand, enable_gqa: a
    yardstick the port never calls), each of the three rotating over
    DECODE_COLD_BYTES of inputs, so K/V come from HBM; and kv_write into
    the served chunk buffer (torch._foreach_copy_ of the two slots)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {"flash_decode": [], "kv_write": []}
    for shape in DECODE_TIMED:
        B, KV, G, hd, _, n_main, _, n_chunk = shape
        sets = decode_sets(torch, shape, dev, SEED + 7)
        k_ms = device_ms(torch, rotating(sets, lambda q, mk, mv, ck, cv: fd.flash_decode_two_tier(
            q, mk, mv, n_main, ck, cv, n_chunk)), 200)
        p_ms = device_ms(torch, rotating(sets, lambda q, mk, mv, ck, cv:
                                         fd.flash_decode_two_tier_reference(
                                             q, mk, mv, n_main, ck, cv, n_chunk)), 50)
        dense = [(q.reshape(B, KV * G, 1, hd),
                  torch.cat([mk[:, :, :n_main], ck[:, :, :n_chunk]], dim=2),
                  torch.cat([mv[:, :, :n_main], cv[:, :, :n_chunk]], dim=2))
                 for q, mk, mv, ck, cv in sets]
        l_ms = device_ms(torch, rotating(dense, lambda qh, kd, vd: sdpa(qh, kd, vd,
                                                                        enable_gqa=True)), 200)
        del dense
        b_ms, b_by = decode_bound(shape)
        # the decode step: its K/V write fused in (the fresh row bound for
        # chunk slot n_chunk - 1), against the attention alone and the
        # write launched apart (kv_write, then the attention), in turns
        kn = [torch.randn(B, KV, 1, hd, generator=gen).to(torch.bfloat16).to(dev)
              for _ in range(2)]
        fused = rotating(sets, lambda q, mk, mv, ck, cv: fd.flash_decode_two_tier(
            q, mk, mv, n_main, ck, cv, n_chunk, *kn))
        apart = rotating(sets, lambda q, mk, mv, ck, cv: (
            kw.kv_write(ck, cv, *kn, n_chunk - 1),
            fd.flash_decode_two_tier(q, mk, mv, n_main, ck, cv, n_chunk)))
        alone = rotating(sets, lambda q, mk, mv, ck, cv: fd.flash_decode_two_tier(
            q, mk, mv, n_main, ck, cv, n_chunk))
        turns = {"fused_ms": [], "attention_ms": [], "write_then_attend_ms": []}
        for name, fn in (("attention_ms", alone), ("fused_ms", fused),
                         ("write_then_attend_ms", apart), ("write_then_attend_ms", apart),
                         ("fused_ms", fused), ("attention_ms", alone)):
            turns[name].append(device_ms(torch, fn, 200))
        fb_ms = b_ms + 2 * 2 * B * KV * hd * 2 / HBM_BYTES_PER_S * 1e3  # + the row read, written
        q, mk, mv, ck, cv = sets[0]
        h_us = host_us_per_call(torch, lambda: fd.flash_decode_two_tier(q, mk, mv, n_main, ck, cv,
                                                                        n_chunk))
        split, _ = fd.decode_split_plan(
            B, KV, G, n_main + n_chunk, torch.cuda.get_device_properties(dev).multi_processor_count)
        rows["flash_decode"].append({"shape": list(shape), "ms": k_ms, "plain_ms": p_ms,
                                     "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
                                     "cluster": split, "host_us_per_call": h_us,
                                     "input_sets": len(sets), "fused_bound_ms": fb_ms,
                                     "turns": turns})
        log(f"[times] flash decode (B,KV,G,hd,main,n_main,chunk,n_chunk)={shape}, cold L2 "
            f"({len(sets)} input sets): kernel {k_ms:.5f} ms (cluster of {split}), plain "
            f"{p_ms:.5f} ms, SDPA over {n_main + n_chunk} dense slots {l_ms:.5f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}); wrapper host {h_us:.3f} us per call on {smi}")
        log(f"[times]   the decode step's call, in turns: attention alone "
            f"{turns['attention_ms']} ms, the write fused in {turns['fused_ms']} ms (bound "
            f"{fb_ms:.6f}), kv_write then the attention {turns['write_then_attend_ms']} ms")
        del sets, q, mk, mv, ck, cv
    B, KV, _, hd, _, _, C, _ = DECODE_TIMED[0]
    ck, cv = (torch.randn(B, KV, C, hd, generator=gen).to(torch.bfloat16).to(dev) for _ in range(2))
    k, v = (torch.randn(B, KV, 1, hd, generator=gen).to(torch.bfloat16).to(dev) for _ in range(2))
    pos = C // 2
    k_ms = device_ms(torch, lambda: kw.kv_write(ck, cv, k, v, pos), 500)
    p_ms = device_ms(torch, lambda: kw.kv_write_reference(ck, cv, k, v, pos), 500)
    l_ms = None
    if hasattr(torch, "_foreach_copy_"):
        dst, src = [ck[:, :, pos], cv[:, :, pos]], [k[:, :, 0], v[:, :, 0]]
        l_ms = device_ms(torch, lambda: torch._foreach_copy_(dst, src), 500)
    nbytes = 2 * 2 * B * KV * hd * 2  # k, v read; their slots written
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    h_us = host_us_per_call(torch, lambda: kw.kv_write(ck, cv, k, v, pos))
    rows["kv_write"].append({"shape": [B, KV, C, hd, pos], "ms": k_ms, "plain_ms": p_ms,
                             "library_ms": l_ms, "bound_ms": b_ms, "bound_by": "bytes",
                             "host_us_per_call": h_us})
    log(f"[times] kv_write into ({B},{KV},{C},{hd}) bf16 at slot {pos}: kernel {k_ms:.5f} ms, "
        f"plain (two slice copies) {p_ms:.5f} ms, torch._foreach_copy_ "
        f"{'not available' if l_ms is None else f'{l_ms:.5f} ms'}, bound {b_ms:.7f} ms (bytes; "
        f"the launch itself dominates); wrapper host {h_us:.3f} us per call on {smi}")
    return rows


def stream_phase(torch, dev, engine, params, cfg, prompt, smi) -> dict:
    """Phase 9: the 1-row 512-token prompt streamed over REST at chunk 8
    (counts reset just before, read just after), its tokens equal to an
    in-process generate on the row; then an in-process B=4 stream of 300
    tokens across two grow_merges, teacher-forced through the plain path."""
    from seldon_core_tpu_torch.models import generate as gen_mod
    from seldon_core_tpu_torch.models.transformer import lm_apply
    from seldon_core_tpu_torch.ops import flash_attention as fa, flash_decode as fd
    from seldon_core_tpu_torch.ops import kv_write as kw

    t_phase = time.perf_counter()
    new = GEN_DIMS["max_new_tokens"]
    server = ServerThread(engine)
    port = server.start()
    try:
        fa.LAUNCHES = fd.LAUNCHES = kw.LAUNCHES = 0
        events, first_s, wall_s = sse_stream(port, {"data": {"ndarray": prompt.tolist()},
                                                    "chunk": STREAM_CHUNK})
        launches = {"flash_attention": fa.LAUNCHES, "flash_decode": fd.LAUNCHES,
                    "kv_write": kw.LAUNCHES}
    finally:
        server.stop()
    if not events or events[-1].get("done") is not True or "puid" not in events[-1].get("meta", {}):
        raise AssertionError(f"the stream did not end with its terminal frame: {events[-1:]}")
    chunks = [np.asarray(e["tokens"], dtype=np.float64) for e in events[:-1]]
    sizes = [c.shape[1] for c in chunks]
    if any(e["done"] for e in events[:-1]) or sizes != [STREAM_CHUNK] * (new // STREAM_CHUNK):
        raise AssertionError(f"stream frames {sizes}")
    streamed = np.concatenate(chunks, axis=1).astype(np.int64)
    tok = torch.as_tensor(prompt, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        local = gen_mod.generate(params, tok, cfg, new, use_flash=True).cpu().numpy()
    if not np.array_equal(streamed, local):
        raise AssertionError(f"streamed tokens differ from an in-process generate at "
                             f"{int((streamed != local).sum())} positions")
    want = {"flash_attention": cfg.n_layers, "flash_decode": cfg.n_layers * (new - 1),
            "kv_write": 0}
    if launches != want:
        raise AssertionError(f"the REST stream launched {launches}, not {want}")
    # after the first frame (the prefill and STREAM_CHUNK - 1 steps) come
    # new - STREAM_CHUNK steps
    rest_step_ms = (wall_s - first_s) * 1e3 / (new - STREAM_CHUNK)
    log(f"[stream] POST /api/v0.1/generate/stream, 1x{GEN_S} prompt at chunk {STREAM_CHUNK}: "
        f"{len(chunks)} frames + the terminal frame, all parse; tokens identical to an "
        f"in-process generate; first frame after {first_s * 1e3:.3f} ms, last after "
        f"{wall_s * 1e3:.3f} ms ({rest_step_ms:.4f} ms per step after the first frame); "
        f"launches {launches}")
    rows, n_tok = STREAM_LONG
    p4 = np.random.default_rng(SEED + 3).integers(0, cfg.vocab, size=(rows, GEN_S))
    merges = []
    orig = gen_mod.grow_merge
    gen_mod.grow_merge = lambda *a: merges.append(a[3]) or orig(*a)
    try:
        fd.LAUNCHES = kw.LAUNCHES = 0
        with torch.inference_mode():
            t = time.perf_counter()
            toks = [c.cpu().numpy() for c in gen_mod.stream_chunks(
                params, torch.as_tensor(p4, dtype=torch.int32, device=dev), cfg, n_tok,
                chunk=STREAM_CHUNK, use_flash=True)]
            long_s = time.perf_counter() - t
        long_launches = (fd.LAUNCHES, kw.LAUNCHES)
    finally:
        gen_mod.grow_merge = orig
    toks = np.concatenate(toks, axis=1).astype(np.int64)
    if toks.shape != (rows, n_tok) or len(merges) != 2:
        raise AssertionError(f"the long stream gave {toks.shape} with merges {merges}")
    if long_launches != (cfg.n_layers * (n_tok - 1), 0):
        raise AssertionError(f"the long stream launched {long_launches}")
    gap, exact = teacher_forced(torch, lm_apply, params, cfg, p4, toks, dev)
    long_step_ms = long_s * 1e3 / (n_tok - 1)
    log(f"[stream] in-process stream_chunks, {rows}x{GEN_S} prompt, {n_tok} tokens at chunk "
        f"{STREAM_CHUNK}: grow_merge of {merges} buffered tokens; launches {long_launches}; "
        f"teacher-forced gap max {gap.max():.5f} (delta {TOKEN_DELTA}), "
        f"{exact.mean() * 100:.2f}% equal the plain argmax; {long_s:.3f} s "
        f"({long_step_ms:.4f} ms per step, prefill included)")
    if gap.max() > TOKEN_DELTA:
        raise AssertionError(f"a streamed token is {gap.max():.4f} below the plain maximum")
    log(f"[stream] phase wall {time.perf_counter() - t_phase:.2f} s")
    return {"first_frame_ms": first_s * 1e3, "stream_wall_ms": wall_s * 1e3, "frames": len(chunks),
            "rest_step_ms": rest_step_ms, "launches": launches, "long_stream_s": long_s,
            "long_step_ms": long_step_ms, "long_merges": merges,
            "long_gap_max": float(gap.max()), "card": smi}


# The continuous lane (runtime/genserver.py) at its default knobs: pool
# blocks of 16 positions, and a decode round's table bucketed to a power of
# two of blocks: 64 (1,024 positions) once a row passes 512 positions.
PAGED_BS = 16
PAGED_NBLK = 64
# flash_decode_paged against its plain version (FLASH_O_ATOL, for its
# reason): (B, KV, G, hd, table blocks, lengths).  The served round (B=32,
# ragged lengths 513..576, a cluster of 2 that splits each row's own
# length), one row at 17 positions (a cluster of 8, seven ranks empty) and
# at 560, MHA at hd 128 with ragged lengths over 16 blocks, a group of
# 16 query heads (all 16 rows of the m16 tile) at hd 256, and the
# speculative lane's draft steps at B=32: MHA at hd 64 (16 kv heads, the
# flagship target as its own draft) and at hd 32 (8 kv heads, its
# default draft).
PAGED_SHAPES = [(32, 4, 4, 64, PAGED_NBLK, (513, 577)), (1, 4, 4, 64, PAGED_NBLK, (17, 18)),
                (1, 4, 4, 64, PAGED_NBLK, (560, 561)), (4, 8, 1, 128, 16, (1, 257)),
                (2, 1, 16, 256, 16, (100, 257)), (32, 16, 1, 64, 40, (513, 582)),
                (32, 8, 1, 32, 40, (513, 582))]
# the fused call (the decode step's write in the launch), at the served
# round and at the speculative lane's draft steps: the flagship target as
# its own draft (MHA, hd 64) and its default draft (8 heads of 32)
PAGED_FUSED = [(GEN_B, 4, 4, 64), (GEN_B, 16, 1, 64), (GEN_B, 8, 1, 32)]
# kv_write_paged bit-exact, (KV, hd, W, dtype, misalign): the served round
# (W = 1 and a prefill tick's 128 and 512), a speculative verify of the MHA
# target (W = k + 1), a prefill tick of the default draft (hd 32), the
# float32 speculative example's verify (4 heads of 32), ragged widths
# around a 128-position run (127, 130), hd 128 and 256, and head views
# that start 1, 2 or 4 bf16 elements (1 f32) past an aligned address, so
# that the copy's unit is 2, 4 or 8 bytes (kv_write.paged_write_inputs:
# starts a multiple of neither bs nor W, one row all invalid, one table
# entry outside the pool)
KV_PAGED_CASES = [(4, 64, 1, "bf16", 0), (4, 64, 128, "bf16", 0), (4, 64, 512, "bf16", 0),
                  (16, 64, 5, "bf16", 0), (8, 32, 128, "bf16", 0), (4, 32, 5, "f32", 0),
                  (4, 64, 127, "bf16", 0), (4, 64, 130, "bf16", 0), (4, 128, 130, "bf16", 0),
                  (2, 256, 127, "bf16", 0), (8, 32, 5, "bf16", 0), (4, 64, 128, "bf16", 1),
                  (16, 64, 5, "bf16", 2), (4, 64, 130, "bf16", 4), (2, 256, 5, "bf16", 1),
                  (4, 32, 5, "f32", 1)]
# one batch whose rows' lengths span the table: the split follows each row
PAGED_RAGGED = [1, 17, 300, 560, 1009]
# the timed shapes: the served round at a late step (512 + 48 positions in
# every row, so the same positions made dense are one n for the
# two-segment kernel), one row, and the speculative drafts' steps at B=32:
# the default draft's (8 kv heads of 32) and the self-draft's (MHA, hd 64)
PAGED_TIMED = [(32, 4, 4, 64, PAGED_NBLK, 560), (1, 4, 4, 64, PAGED_NBLK, 560),
               (32, 8, 1, 32, PAGED_NBLK, 560), (32, 16, 1, 64, PAGED_NBLK, 560)]
# the writes that kv_write_paged takes, (KV, hd, W): a prefill tick's B=32
# rows of W=128 (the chunk floor) and W=512 (its ceiling), and a
# speculative verify's W = k + 1 = 5 of the MHA target
KV_PAGED_TIMED = [(4, 64, 128), (4, 64, 512), (16, 64, 5)]
KV_WRITE_PLAN = ("a block of P positions of one row (blockIdx.y) for every kv head, P a power "
                 "of two with P * KV * lanes <= 256; a thread a (kv head, position, lane), "
                 "lanes lowest, every index a shift or mask of a 32-bit number; each thread's "
                 "K and V source loads started first, then lanes 0..P-1 look each position's "
                 "slot up once (start, then the table entry at the clamped index, loaded "
                 "unconditionally, block 0 selected after) into shared memory, one "
                 "__syncthreads, then the stores")
KV_PAGED_DESIGN = KV_WRITE_PLAN + "; K and V one 16-byte unit each a thread (else 8, 4, 2, 1)"
CONT_BURST = 8            # 1-row requests sent CONT_GAP_S apart: they join a running batch
CONT_GAP_S = 0.020
CONT_TURNS = 1            # ABBA turns of the lane comparison (2 walls each)
PAGED_DESIGN = ("a cluster of 1-8 blocks per (row, kv head); each block reads the row's "
                "length and block table on the device and takes a share of whole pool blocks "
                "of that length (paged_shares); 8 warps, each with its own TMA ring of "
                "16-position tiles (one 128-byte-swizzled box per pool block), QK^T and PV "
                "by mma.sync m16n8k16 with the query heads on M and P kept in registers, "
                "one rescale per tile; the decode step's K/V write fused in; warps and "
                "blocks combined in a fixed order through DSMEM: one launch")


# flash_decode_paged's float32 path (an f32 model's pools) against its plain
# version in f32, (B, KV, G, hd, table blocks, lengths): the speculative
# example's draft (2 kv heads of hd 32, one query head each) at one row of
# 1, 17 and 512 positions and on a ragged batch; the walk's edges (tiles of
# 8 positions a warp, pool blocks of 16, shares of at least 64 positions)
# in one batch and one row of 2048; 32 and 64 rows of random lengths
# (clusters of 2 and 1); then 4 query rows at hd 64, 8 at hd 256 and 3 at
# hd 40, which reach the path's other instances
F32_EDGE_LENGTHS = [1, 7, 8, 9, 31, 32, 33, 63, 64, 65, 511, 512, 2048, 100]
PAGED_F32_SHAPES = [(1, 2, 1, 32, PAGED_NBLK, [1]), (1, 2, 1, 32, PAGED_NBLK, [17]),
                    (1, 2, 1, 32, PAGED_NBLK, [512]),
                    (6, 2, 1, 32, PAGED_NBLK, [1, 17, 512, 100, 33, 1000]),
                    (len(F32_EDGE_LENGTHS), 2, 1, 32, 128, F32_EDGE_LENGTHS),
                    (1, 2, 1, 32, 128, [2048]), (1, 2, 1, 32, 128, [65]),
                    (32, 2, 1, 32, PAGED_NBLK, (1, 1025)), (64, 2, 1, 32, PAGED_NBLK, (1, 1025)),
                    (4, 4, 4, 64, 16, [1, 60, 200, 256]), (2, 1, 8, 256, 16, [100, 256]),
                    (3, 2, 3, 40, 16, [5, 77, 256])]
# the fused call at the draft's shape, (B, KV, G, hd, table blocks, lengths),
# the last three rows inactive
PAGED_F32_FUSED = [(8, 2, 1, 32, PAGED_NBLK, [1, 17, 512, 64, 300, 1000, 5, 2]),
                   (17, 2, 1, 32, 128, F32_EDGE_LENGTHS + [5, 2, 9])]
# f32 kernel vs plain f32: both sum f32 products, in other orders, and the
# kernel's exp is ex2.approx (~2 ulp), so o agrees to ~1e-6 at these sizes
F32_O_ATOL = 1e-5
# the timed f32 shapes: the draft's step at B=32 and at one row, 512
# positions a row, cold L2
PAGED_F32_TIMED = [(32, 2, 1, 32, PAGED_NBLK, 512), (1, 2, 1, 32, PAGED_NBLK, 512)]
F32_FLOPS = 67e12            # H100 SXM float32 peak outside the tensor cores


PAGED_F32_DESIGN = ("the bf16 path's share rule, fused write and DSMEM combine; the walk is "
                    "bound by the bytes (~G/2 f32 FLOP a byte), so each warp takes every 8th "
                    "tile of 8 positions (every warp busy from a 64-position share) through its "
                    "own ring of 2-4 stages filled by TMA (32-column boxes of 8 rows, 128-byte "
                    "swizzle, the next tile issued as a stage frees): scores 4 lanes a "
                    "position from shared memory, PV every 32nd column a lane with p by "
                    "shuffle, no global load in the loop; f32 FMAs on the CUDA cores, no TF32")


def paged_inputs(torch, case, gen, dev, dtype=None):
    """q, pools with every row's blocks in a shuffled order, tables and
    lengths of one PAGED_SHAPES case (a (lo, hi) range of lengths, or a
    list of one length a row), in bf16 or ``dtype``."""
    B, KV, G, hd, nblk, span = case
    N = B * nblk + 1

    def rnd(*dims):
        return torch.randn(*dims, generator=gen).to(dtype or torch.bfloat16).to(dev)

    tables = (torch.randperm(N - 1, generator=gen)[: B * nblk] + 1).reshape(B, nblk)
    lens = (torch.tensor(span) if isinstance(span, list) else
            torch.randint(span[0], span[1], (B,), generator=gen))
    return (rnd(B, KV, G, hd), rnd(N, KV, PAGED_BS, hd), rnd(N, KV, PAGED_BS, hd),
            tables.to(torch.int32).to(dev), lens.to(torch.int32).to(dev))


def permuted_pool(torch, pk, pv, tables, gen, dev):
    """The same rows in other physical blocks: pools with blocks 1.. moved
    to a random permutation, and the tables that follow them."""
    perm = torch.randperm(pk.shape[0] - 1, generator=gen).to(dev) + 1
    mk, mv = pk.clone(), pv.clone()
    mk[perm], mv[perm] = pk[1:], pv[1:]
    return mk, mv, perm[(tables - 1).long()].to(torch.int32)


def check_write_plan(kw, B, KV, W, lanes) -> tuple:
    """kv_write_paged's launch plan as the source computes it
    (kv_write_paged_plan) against paged_write_plan: the plan, or raises."""
    import ctypes

    out = (ctypes.c_int * 6)()
    rc = kw._library().plan(B, KV, W, lanes, ctypes.addressof(out))
    want = kw.paged_write_plan(B, KV, W, lanes)
    if rc != 0 or tuple(out) != want:
        raise AssertionError(f"kv_write_paged_plan({B}, {KV}, {W}, {lanes}) gave {rc}, "
                             f"{tuple(out)}; paged_write_plan {want}")
    return want


def kv_paged_checks(torch, kw, dev, gen) -> None:
    """kv_write_paged bit-exact and in place at KV_PAGED_CASES (inputs from
    kv_write.paged_write_inputs, drawn from the CPU generator ``gen``),
    each launch plan in C equal to paged_write_plan; raises otherwise."""
    for KV, hd, W, dt, misalign in KV_PAGED_CASES:
        x = kw.paged_write_inputs(32, KV, W, hd, PAGED_NBLK, gen, dev,
                                  dtype=torch.float32 if dt == "f32" else torch.bfloat16,
                                  bs=PAGED_BS, misalign=misalign)
        lanes = kw.paged_write_lanes(*x.pools, x.k, x.v)
        unit = hd * x.pools[0].element_size() // lanes
        if (misalign == 0) != (unit == 16):
            raise AssertionError(f"kv_write_paged at KV={KV} hd={hd} W={W} {dt}, {misalign} "
                                 f"elements off: a copy unit of {unit} bytes")
        plan = check_write_plan(kw, 32, KV, W, lanes)
        want = kw.paged_write_expected(x)
        ptrs, before = [t.data_ptr() for t in x.pools], kw.PAGED_LAUNCHES
        out = kw.kv_write_paged(*x.pools, x.k, x.v, x.tables, x.start, x.valid)
        torch.cuda.synchronize()
        # block 0 (scratch) takes several invalid writes to one row, in no order
        if (kw.PAGED_LAUNCHES != before + 1 or [t.data_ptr() for t in out] != ptrs
                or not all(torch.equal(a[1:], b[1:x.N]) for a, b in zip(x.pools, want))):
            raise AssertionError(f"kv_write_paged at KV={KV} hd={hd} W={W} {dt}, {misalign} "
                                 f"elements off, is not the plain scatter")
        log(f"[paged-kernel] kv_write_paged into pools ({x.N},{KV},{PAGED_BS},{hd}) {dt} "
            f"through [32,{PAGED_NBLK}] tables, W={W} from strided head views {misalign} "
            f"elements off (units of {unit} bytes; plan {plan}): bit-exact outside the scratch "
            f"block (an out-of-pool entry dropped, a row all invalid), in place")


def paged_kernel_phase(torch, fd, kw, dev) -> dict:
    """flash_decode_paged against its plain version at PAGED_SHAPES and the
    ragged batch PAGED_RAGGED (one launch a call, a repeat the same bits,
    the same bits with the rows' blocks moved elsewhere in the pool), then
    the fused call at PAGED_FUSED (B=32 from strided head views, three
    inactive rows on scratch tables): o of the active rows against the
    plain fused version, the pools bit-exact outside the scratch block, a
    repeat and moved blocks the same bits.  kv_write_paged bit-exact and in
    place at KV_PAGED_CASES (kv_write.paged_write_inputs: unaligned starts,
    a row all invalid, an out-of-pool entry, ragged widths), each launch
    plan in C equal to paged_write_plan.  Returns each kernel's largest
    absolute error."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 9)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    max_err = 0.0
    ragged = (len(PAGED_RAGGED), 4, 4, 64, PAGED_NBLK, PAGED_RAGGED)
    for case in PAGED_SHAPES + [ragged]:
        q, pk, pv, tables, lens = paged_inputs(torch, case, gen, dev)
        B, KV, G, _, nblk, _ = case
        split = fd.paged_cluster(B, KV, G, nblk * PAGED_BS, sm_count)
        mk, mv, moved_tables = permuted_pool(torch, pk, pv, tables, gen, dev)
        before = fd.PAGED_LAUNCHES
        got = fd.flash_decode_paged(q, pk, pv, tables, lens)
        again = fd.flash_decode_paged(q, pk, pv, tables, lens)
        moved = fd.flash_decode_paged(q, mk, mv, moved_tables, lens)
        want = fd.flash_decode_paged_reference(q, pk, pv, tables, lens)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if (fd.PAGED_LAUNCHES != before + 3 or got.dtype != torch.bfloat16 or err > FLASH_O_ATOL
                or not bool(torch.isfinite(got.float()).all())):
            raise AssertionError(f"flash_decode_paged vs plain at {case}: o err {err:.3e} "
                                 f"(tolerance {FLASH_O_ATOL}), launches "
                                 f"{fd.PAGED_LAUNCHES - before}")
        if not torch.equal(got, again) or not torch.equal(got, moved):
            raise AssertionError(f"flash_decode_paged at {case}: a repeat or the same rows in "
                                 f"other blocks gave other bits")
        max_err = max(max_err, err)
        n_max = int(lens.max())
        log(f"[paged-kernel] flash_decode_paged (B,KV,G,hd,blocks,lens)={case}: a cluster of "
            f"{split}; the longest row ({n_max}) split "
            f"{[b - a for a, b in fd.paged_shares(n_max, split, PAGED_BS)]}: o max abs err "
            f"{err:.3e} (tolerance {FLASH_O_ATOL}); a repeat and the blocks permuted in the pool "
            f"bit-identical")
    # the fused call at the round's shape and the speculative drafts'
    for B, KV, G, hd in PAGED_FUSED:
        nblk = PAGED_NBLK
        q, pk, pv, tables, lens = paged_inputs(torch, (B, KV, G, hd, nblk, (513, 577)), gen, dev)
        active = torch.arange(B, device=dev) < B - 3
        tables[~active] = 0  # an empty slot's table is the scratch block
        qkv = torch.randn(B, 1, (2 * G + 4) * KV * hd, generator=gen).to(torch.bfloat16).to(dev)
        k_new = qkv[..., -2 * KV * hd:-KV * hd].reshape(B, 1, KV, hd).transpose(1, 2)
        v_new = qkv[..., -KV * hd:].reshape(B, 1, KV, hd).transpose(1, 2)  # strided head views
        mk, mv, moved_tables = permuted_pool(torch, pk, pv, tables, gen, dev)
        moved_tables[~active] = 0
        pools = {name: (pk.clone(), pv.clone()) for name in ("got", "again", "want")}
        before = fd.PAGED_LAUNCHES
        got = fd.flash_decode_paged(q, *pools["got"], tables, lens, k_new, v_new, active)
        again = fd.flash_decode_paged(q, *pools["again"], tables, lens, k_new, v_new, active)
        moved = fd.flash_decode_paged(q, mk, mv, moved_tables, lens, k_new, v_new, active)
        want = fd.flash_decode_paged_reference(q, *pools["want"], tables, lens, k_new, v_new,
                                               active)
        torch.cuda.synchronize()
        err = float((got[active].float() - want[active].float()).abs().max())
        if fd.PAGED_LAUNCHES != before + 3 or err > FLASH_O_ATOL:
            raise AssertionError(f"fused flash_decode_paged vs plain at (B,KV,G,hd)="
                                 f"{(B, KV, G, hd)}: o err {err:.3e} (tolerance {FLASH_O_ATOL}), "
                                 f"launches {fd.PAGED_LAUNCHES - before}")
        if not all(torch.equal(pools["got"][i][1:], pools["want"][i][1:]) for i in (0, 1)):
            raise AssertionError(f"the fused write at {(B, KV, G, hd)} is not the plain write "
                                 f"outside the scratch block")
        if not torch.equal(got[active], again[active]) \
                or not torch.equal(got[active], moved[active]) \
                or not all(torch.equal(pools["got"][i], pools["again"][i]) for i in (0, 1)):
            raise AssertionError(f"the fused call at {(B, KV, G, hd)}: a repeat or the same rows "
                                 f"in other blocks gave other bits")
        max_err = max(max_err, err)
        log(f"[paged-kernel] flash_decode_paged with the step's write fused in, (B,KV,G,hd)="
            f"{(B, KV, G, hd)} (3 inactive rows) from strided head views, lengths "
            f"{int(lens.min())}..{int(lens.max())}: o max abs err {err:.3e} on the active rows "
            f"(tolerance {FLASH_O_ATOL}); the pools bit-exact outside the scratch block; a repeat "
            f"and the blocks permuted bit-identical")
    kv_paged_checks(torch, kw, dev, gen)
    log(f"[paged-kernel] phase wall {time.perf_counter() - t0:.2f} s")
    return {"flash_decode_paged": max_err, "kv_write_paged": 0.0}


def paged_f32_phase(torch, fd, dev) -> float:
    """flash_decode_paged's float32 path against its plain version in f32 at
    PAGED_F32_SHAPES (one launch a call, a repeat and the rows' blocks
    permuted in the pool the same bits), then the fused call at
    PAGED_F32_FUSED from strided head views: o of the active rows, the
    pools bit-exact outside the scratch block.  Returns the largest
    absolute error of o."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 19)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    max_err = 0.0
    for case in PAGED_F32_SHAPES:
        q, pk, pv, tables, lens = paged_inputs(torch, case, gen, dev, torch.float32)
        B, KV, G, hd, nblk, span = case
        split = fd.paged_cluster(B, KV, G, nblk * PAGED_BS, sm_count)
        mk, mv, moved_tables = permuted_pool(torch, pk, pv, tables, gen, dev)
        before = fd.PAGED_LAUNCHES
        got = fd.flash_decode_paged(q, pk, pv, tables, lens)
        again = fd.flash_decode_paged(q, pk, pv, tables, lens)
        moved = fd.flash_decode_paged(q, mk, mv, moved_tables, lens)
        want = fd.flash_decode_paged_reference(q, pk, pv, tables, lens)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if (fd.PAGED_LAUNCHES != before + 3 or got.dtype != torch.float32 or err > F32_O_ATOL
                or not bool(torch.isfinite(got).all())):
            raise AssertionError(f"flash_decode_paged float32 vs plain at {case}: o err "
                                 f"{err:.3e} (tolerance {F32_O_ATOL}), launches "
                                 f"{fd.PAGED_LAUNCHES - before}")
        if not torch.equal(got, again) or not torch.equal(got, moved):
            raise AssertionError(f"flash_decode_paged float32 at {case}: a repeat or the same "
                                 f"rows in other blocks gave other bits")
        max_err = max(max_err, err)
        log(f"[paged-f32] flash_decode_paged float32 (B,KV,G,hd,blocks,lens)={case}: a cluster "
            f"of {split}: o max abs err {err:.3e} (tolerance {F32_O_ATOL}); a repeat and the "
            f"blocks permuted in the pool bit-identical")
    for B, KV, G, hd, nblk, span in PAGED_F32_FUSED:
        q, pk, pv, tables, lens = paged_inputs(torch, (B, KV, G, hd, nblk, span), gen, dev,
                                               torch.float32)
        active = torch.arange(B, device=dev) < B - 3
        tables[~active] = 0  # an empty slot's table is the scratch block
        qkv = torch.randn(B, 1, (2 * G + 4) * KV * hd, generator=gen).to(dev)
        k_new = qkv[..., -2 * KV * hd:-KV * hd].reshape(B, 1, KV, hd).transpose(1, 2)
        v_new = qkv[..., -KV * hd:].reshape(B, 1, KV, hd).transpose(1, 2)  # strided head views
        mk, mv, moved_tables = permuted_pool(torch, pk, pv, tables, gen, dev)
        moved_tables[~active] = 0
        pools = {name: (pk.clone(), pv.clone()) for name in ("got", "again", "want")}
        before = fd.PAGED_LAUNCHES
        got = fd.flash_decode_paged(q, *pools["got"], tables, lens, k_new, v_new, active)
        again = fd.flash_decode_paged(q, *pools["again"], tables, lens, k_new, v_new, active)
        moved = fd.flash_decode_paged(q, mk, mv, moved_tables, lens, k_new, v_new, active)
        want = fd.flash_decode_paged_reference(q, *pools["want"], tables, lens, k_new, v_new,
                                               active)
        torch.cuda.synchronize()
        err = float((got[active] - want[active]).abs().max())
        if fd.PAGED_LAUNCHES != before + 3 or err > F32_O_ATOL:
            raise AssertionError(f"fused flash_decode_paged float32 vs plain at (B,KV,G,hd)="
                                 f"{(B, KV, G, hd)}, lengths {span}: o err {err:.3e} (tolerance "
                                 f"{F32_O_ATOL}), launches {fd.PAGED_LAUNCHES - before}")
        if not all(torch.equal(pools["got"][i][1:], pools["want"][i][1:]) for i in (0, 1)):
            raise AssertionError(f"the fused float32 write at lengths {span} is not the plain "
                                 f"write outside the scratch block")
        if not torch.equal(got[active], again[active]) \
                or not torch.equal(got[active], moved[active]) \
                or not all(torch.equal(pools["got"][i], pools["again"][i]) for i in (0, 1)):
            raise AssertionError(f"the fused float32 call at lengths {span}: a repeat or the "
                                 f"same rows in other blocks gave other bits")
        max_err = max(max_err, err)
        log(f"[paged-f32] flash_decode_paged float32 with the step's write fused in, "
            f"(B,KV,G,hd)={(B, KV, G, hd)}, lengths {span}, the last 3 rows inactive, from "
            f"strided head views: o max abs err {err:.3e} on the active rows (tolerance "
            f"{F32_O_ATOL}); the pools bit-exact outside the scratch block; a repeat and the "
            f"blocks permuted bit-identical")
    log(f"[paged-f32] phase wall {time.perf_counter() - t0:.2f} s")
    return max_err


def paged_f32_times(torch, fd, dev, smi) -> list:
    """flash_decode_paged's float32 path at PAGED_F32_TIMED, rotating over
    DECODE_COLD_BYTES of f32 inputs (cold L2), beside its plain version, the
    gather-then-SDPA library call in f32 and its bound (f32 bytes, f32 FMA
    peak); the fused call too.  Returns one row a shape."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for B, KV, G, hd, nblk, n in PAGED_F32_TIMED:
        sets = [tuple(t.float() if t.is_floating_point() else t for t in x)
                for x in paged_sets(torch, B, KV, G, hd, nblk, [n] * B, dev, SEED + 20)]
        attend = [x[:5] for x in sets]
        k_ms = device_ms(torch, rotating(attend, fd.flash_decode_paged), 200)
        p_ms = device_ms(torch, rotating(attend, fd.flash_decode_paged_reference), 20)
        f_ms = device_ms(torch, rotating(sets, fd.flash_decode_paged), 200)

        def gather_sdpa(q, pk, pv, t, _lens):
            k, v = fd.paged_view(pk, pv, t)
            return sdpa(q.reshape(B, KV * G, 1, hd), k[:, :, :n], v[:, :, :n], enable_gqa=True)

        l_ms = device_ms(torch, rotating(attend, gather_sdpa), 100)
        b_ms, b_by = paged_decode_bound(B, KV, G, hd, nblk, [n] * B, elt=4, peak=F32_FLOPS)
        split = fd.paged_cluster(B, KV, G, nblk * PAGED_BS, sm_count)
        rows.append({"shape": [B, KV, G, hd, nblk, n], "ms": k_ms, "plain_ms": p_ms,
                     "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by, "fused_ms": f_ms,
                     "cluster": split, "input_sets": len(sets)})
        log(f"[times] flash_decode_paged float32 (B,KV,G,hd,blocks,n)=({B},{KV},{G},{hd},{nblk},"
            f"{n}), cold L2 ({len(sets)} input sets): kernel {k_ms:.5f} ms (cluster of {split}), "
            f"fused {f_ms:.5f} ms, plain {p_ms:.5f} ms, gather then SDPA in f32 {l_ms:.5f} ms, "
            f"bound {b_ms:.6f} ms ({b_by}, {b_ms / k_ms * 100:.1f}% of it) on {smi}")
        del sets, attend
    return rows


def paged_decode_bound(B, KV, G, hd, nblk, lens, fused: bool = False, elt: int = 2,
                       peak: float = BF16_FLOPS):
    """Least time for one flash_decode_paged call: K and V of each row's
    positions (``lens``, one length a row), q, the tables and lengths read
    once and o written once over HBM bandwidth (with the fused write also
    the fresh K/V read and written once), against the score and PV FLOPs
    over the peak of their type: ``elt`` bytes a value, bf16's tensor-core
    peak by default, F32_FLOPS for the f32 path."""
    n_sum = sum(lens)
    nbytes = elt * (2 * KV * n_sum * hd + 2 * B * KV * G * hd) + 4 * (B * nblk + B)
    if fused:
        nbytes += 2 * 2 * elt * B * KV * hd
    flops = 4 * KV * G * n_sum * hd
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def paged_sets(torch, B, KV, G, hd, nblk, lens, dev, seed: int, int8: bool = False) -> list:
    """Input sets of one paged shape (q, pools, shuffled tables, lengths,
    fresh K/V), made on the card, enough of them to hold DECODE_COLD_BYTES
    of pools together: walked in turn, each set's K/V is out of the L2.
    ``int8`` makes the pools int8 codes (kv_write.int8_kv_rows) and adds
    their scale planes (pool k_s, v_s) to each set."""
    from seldon_core_tpu_torch.ops.kv_write import int8_kv_rows

    gen = torch.Generator(device=dev).manual_seed(seed)
    N = B * nblk + 1
    per_set = 2 * N * KV * PAGED_BS * (hd + 4 if int8 else 2 * hd)
    n_sets = max(4, -(-DECODE_COLD_BYTES // per_set))

    def rnd(*dims):
        return torch.randn(*dims, generator=gen, device=dev).to(torch.bfloat16)

    sets = []
    for _ in range(n_sets):
        tables = (torch.randperm(N - 1, generator=gen, device=dev)[: B * nblk] + 1)
        q = rnd(B, KV, G, hd)
        if int8:
            (pk, pks), (pv, pvs) = (int8_kv_rows((N, KV, PAGED_BS, hd), gen, dev)
                                    for _ in range(2))
        else:
            pk, pv = rnd(N, KV, PAGED_BS, hd), rnd(N, KV, PAGED_BS, hd)
        sets.append((q, pk, pv, tables.reshape(B, nblk).to(torch.int32),
                     torch.tensor(lens, dtype=torch.int32, device=dev),
                     rnd(B, KV, 1, hd), rnd(B, KV, 1, hd)) + (((pks, pvs),) if int8 else ()))
    return sets


def paged_times(torch, fd, kw, dev, smi) -> dict:
    """Device times of the paged kernels beside their plain versions, a
    library yardstick and their bounds.  flash_decode_paged at PAGED_TIMED
    and on the ragged batch PAGED_RAGGED, rotating over DECODE_COLD_BYTES
    of inputs (cold L2); at B=32 also the fused call (the decode step's
    write and attention in one launch) beside the write and the attention
    launched apart, the gather-then-dense alternative (paged_view, then the
    two-segment kernel), the two-segment kernel alone on the positions made
    dense beforehand, and the gather-then-SDPA library call (enable_gqa).
    kv_write_paged at KV_PAGED_TIMED (B=32: a prefill tick's writes and a
    speculative verify's) beside index_put_ on the pools with the indices
    made beforehand."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {"flash_decode_paged": [], "kv_write_paged": []}
    for B, KV, G, hd, nblk, n in PAGED_TIMED:
        sets = paged_sets(torch, B, KV, G, hd, nblk, [n] * B, dev, SEED + 12)
        attend = [x[:5] for x in sets]
        k_ms = device_ms(torch, rotating(attend, fd.flash_decode_paged), 200)
        p_ms = device_ms(torch, rotating(attend, fd.flash_decode_paged_reference), 20)
        f_ms = device_ms(torch, rotating(sets, fd.flash_decode_paged), 200)
        ones = torch.ones(B, 1, dtype=torch.bool, device=dev)

        def write_then_attend(q, pk, pv, t, lens, kn, vn, start):
            kw.kv_write_paged(pk, pv, kn, vn, t, start, ones)
            return fd.flash_decode_paged(q, pk, pv, t, lens)

        w_ms = device_ms(torch, rotating([(*x, x[4] - 1) for x in sets], write_then_attend), 200)

        def gather_two_segment(q, pk, pv, t, _lens):
            k, v = fd.paged_view(pk, pv, t)
            return fd.flash_decode_two_tier(q, k, v, n, k[:, :, :0], v[:, :, :0], 0)

        def gather_sdpa(q, pk, pv, t, _lens):
            k, v = fd.paged_view(pk, pv, t)
            return sdpa(q.reshape(B, KV * G, 1, hd), k[:, :, :n], v[:, :, :n], enable_gqa=True)

        g_ms = device_ms(torch, rotating(attend, gather_two_segment), 100)
        l_ms = device_ms(torch, rotating(attend, gather_sdpa), 100)
        dense = []
        for q, pk, pv, t, _ in attend:
            k, v = fd.paged_view(pk, pv, t)
            dense.append((q, k[:, :, :n].contiguous(), v[:, :, :n].contiguous()))
        t_ms = device_ms(torch, rotating(dense, lambda q, k, v: fd.flash_decode_two_tier(
            q, k, v, n, k[:, :, :0], v[:, :, :0], 0)), 200)
        s_ms = device_ms(torch, rotating(dense, lambda q, k, v: sdpa(
            q.reshape(B, KV * G, 1, hd), k, v, enable_gqa=True)), 200)
        del dense
        b_ms, b_by = paged_decode_bound(B, KV, G, hd, nblk, [n] * B)
        fb_ms, _ = paged_decode_bound(B, KV, G, hd, nblk, [n] * B, fused=True)
        split = fd.paged_cluster(B, KV, G, nblk * PAGED_BS, sm_count)
        h_us = host_us_per_call(torch, lambda: fd.flash_decode_paged(*sets[0]))
        rows["flash_decode_paged"].append({
            "shape": [B, KV, G, hd, nblk, n], "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": b_ms, "bound_by": b_by, "fused_ms": f_ms, "fused_bound_ms": fb_ms,
            "write_then_attend_ms": w_ms, "gather_two_segment_ms": g_ms,
            "two_segment_dense_ms": t_ms, "sdpa_dense_ms": s_ms, "cluster": split,
            "shares": [b - a for a, b in fd.paged_shares(n, split, PAGED_BS)],
            "host_us_per_call": h_us, "input_sets": len(sets)})
        log(f"[times] flash_decode_paged (B,KV,G,hd,blocks,n)=({B},{KV},{G},{hd},{nblk},{n}), "
            f"cold L2 ({len(sets)} input sets): kernel {k_ms:.5f} ms (cluster of {split}), plain "
            f"{p_ms:.5f} ms, bound {b_ms:.6f} ms ({b_by}, {b_ms / k_ms * 100:.1f}% of it); with "
            f"the step's write fused in {f_ms:.5f} ms (bound {fb_ms:.6f}), kv_write_paged then "
            f"the kernel {w_ms:.5f} ms; gather then the two-segment kernel {g_ms:.5f} ms, the "
            f"two-segment kernel on the positions made dense {t_ms:.5f} ms; gather then SDPA "
            f"{l_ms:.5f} ms, SDPA on the dense positions {s_ms:.5f} ms; wrapper host "
            f"{h_us:.3f} us per call on {smi}")
        del sets, attend
    B = len(PAGED_RAGGED)
    sets = [x[:5] for x in paged_sets(torch, B, 4, 4, 64, PAGED_NBLK, PAGED_RAGGED, dev,
                                      SEED + 15)]
    k_ms = device_ms(torch, rotating(sets, fd.flash_decode_paged), 200)
    b_ms, b_by = paged_decode_bound(B, 4, 4, 64, PAGED_NBLK, PAGED_RAGGED)
    split = fd.paged_cluster(B, 4, 4, PAGED_NBLK * PAGED_BS, sm_count)
    rows["flash_decode_paged"].append({
        "shape": [B, 4, 4, 64, PAGED_NBLK, PAGED_RAGGED], "ms": k_ms, "bound_ms": b_ms,
        "bound_by": b_by, "cluster": split, "input_sets": len(sets),
        "shares": {n: [b - a for a, b in fd.paged_shares(n, split, PAGED_BS)]
                   for n in PAGED_RAGGED}})
    log(f"[times] flash_decode_paged on a ragged batch, lengths {PAGED_RAGGED} over "
        f"{PAGED_NBLK} blocks, cold L2: kernel {k_ms:.5f} ms (a cluster of {split}), bound "
        f"{b_ms:.6f} ms ({b_by}) on {smi}")
    del sets
    B, nblk = 32, PAGED_NBLK
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    N = B * nblk + 1
    tables = (torch.randperm(N - 1, generator=gen, device=dev)[: B * nblk] + 1)
    tables = tables.reshape(B, nblk).to(torch.int32)
    for KV, hd, W in KV_PAGED_TIMED:
        pk, pv = (torch.randn(N, KV, PAGED_BS, hd, generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        k, v = head_views(torch, B, W, KV, hd, gen, dev)  # as a tick has them
        start = torch.full((B,), 512 - W, dtype=torch.int32, device=dev)
        valid = torch.ones(B, W, dtype=torch.bool, device=dev)
        check_write_plan(kw, B, KV, W, kw.paged_write_lanes(pk, pv, k, v))
        k_ms = device_ms(torch, lambda: kw.kv_write_paged(pk, pv, k, v, tables, start, valid), 200)
        p_ms = device_ms(torch, lambda: kw.kv_write_paged_reference(pk, pv, k, v, tables, start,
                                                                    valid), 50)
        pos = torch.arange(512 - W, 512, device=dev)
        blk = tables[:, pos // PAGED_BS].long()
        off = (pos % PAGED_BS)[None, :].expand(B, W)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)

        def index_put():
            pk[blk, :, off] = kt
            pv[blk, :, off] = vt

        l_ms = device_ms(torch, index_put, 200)
        b_ms = 2 * 2 * B * KV * W * hd * 2 / HBM_BYTES_PER_S * 1e3  # k, v read; their rows written
        h_us = host_us_per_call(torch, lambda: kw.kv_write_paged(pk, pv, k, v, tables, start,
                                                                 valid))
        rows["kv_write_paged"].append({"shape": [N, KV, PAGED_BS, hd, B, W], "ms": k_ms,
                                       "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
                                       "bound_by": "bytes", "host_us_per_call": h_us})
        log(f"[times] kv_write_paged into pools ({N},{KV},{PAGED_BS},{hd}) bf16, B={B} rows "
            f"of W={W} at positions {512 - W}..511 from strided head views: "
            f"kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms, index_put_ with the indices made "
            f"beforehand {l_ms:.5f} ms, bound {b_ms:.6f} ms (bytes); wrapper host {h_us:.3f} us "
            f"per call on {smi}")
    return rows


def round_inputs(torch, cfg, B, n, dev, gen):
    """A decode round's inputs at B rows of n cached positions: a pool of
    random K/V, shuffled tables of PAGED_NBLK blocks, random tokens."""
    from seldon_core_tpu_torch.models.generate import init_block_pool

    N = B * PAGED_NBLK + 1
    pool = init_block_pool(cfg, N, PAGED_BS, dev)
    for layer in pool.values():
        for t in layer.values():
            t.copy_(torch.randn(t.shape, generator=gen, device=dev).to(t.dtype))
    tables = (torch.randperm(N - 1, generator=gen, device=dev)[: B * PAGED_NBLK] + 1)
    return (pool, tables.reshape(B, PAGED_NBLK).to(torch.int32),
            torch.randint(0, cfg.vocab, (B,), generator=gen, device=dev).to(torch.int32),
            torch.full((B,), n, dtype=torch.int32, device=dev),
            torch.ones(B, dtype=torch.bool, device=dev), torch.zeros(B, dtype=torch.bool,
                                                                     device=dev))


def continuous_phases(torch, dev, smi) -> list:
    """The paged kernels against their plain versions, then the flagship
    generator served through the continuous lane (runtime/genserver.py) at
    its default knobs over REST: a 1-row and a 32-row 512-token request
    (the 32 prompts need 1,024 blocks of the pool's 1,023: preemption),
    CONT_BURST 1-row requests CONT_GAP_S apart (they join a running round)
    and the 1-row prompt as an SSE stream, counts reset just before and
    read just after; every token teacher-forced; then the lane against the
    static lane in turns, a profiled round, prefill ticks and the paged
    kernels' times.  Returns the flash_decode_paged and kv_write_paged
    rows of the kernels line."""
    from seldon_core_tpu_torch.graph.defaulting import default_and_validate
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.models.generate import paged_decode_round, paged_forward
    from seldon_core_tpu_torch.models.transformer import lm_apply
    from seldon_core_tpu_torch.ops import flash_attention as fa, flash_decode as fd
    from seldon_core_tpu_torch.ops import kv_write as kw
    from seldon_core_tpu_torch.runtime.engine import EngineService

    errs = paged_kernel_phase(torch, fd, kw, dev)

    # -- continuous: served --------------------------------------------------
    t_phase = time.perf_counter()
    spec = default_and_validate(SeldonDeploymentSpec.from_json_dict(gen_deployment()))
    lane_env = os.environ.pop("SELDON_TPU_GEN_CONTINUOUS", None)
    try:
        t0 = time.perf_counter()
        probes_before = (fd.PAGED_LAUNCHES, kw.PAGED_LAUNCHES)
        engine = EngineService(spec, device=dev)
    finally:
        if lane_env is not None:
            os.environ["SELDON_TPU_GEN_CONTINUOUS"] = lane_env
    g = engine.genserver
    probes = (fd.PAGED_LAUNCHES - probes_before[0], kw.PAGED_LAUNCHES - probes_before[1])
    if g is None or not g.use_flash or probes != (1, 1):
        raise AssertionError(f"the engine did not build the continuous lane over the paged "
                             f"kernels (genserver {g is not None}, probe launches {probes})")
    cfg = engine.compiled.units["gen"].cfg
    params = engine.states()["gen"]["params"]
    log(f"[continuous] engine built in {time.perf_counter() - t0:.2f} s with the continuous "
        f"lane: blocks of {g.block_size}, {g.num_blocks} pool blocks, {g.slots} slots, span "
        f"{g.span}, prefill chunk {g.prefill_chunk}..{g.prefill_chunk_max}; the scheduler probed "
        f"flash_decode_paged and kv_write_paged once each")
    server = ServerThread(engine)
    port = server.start()
    url = f"http://127.0.0.1:{port}/api/v0.1/predictions"
    rng = np.random.default_rng(SEED + 11)
    vocab, new = GEN_DIMS["vocab"], GEN_DIMS["max_new_tokens"]
    p1 = rng.integers(0, vocab, size=(1, GEN_S))
    p32 = rng.integers(0, vocab, size=(GEN_B, GEN_S))
    pb = [rng.integers(0, vocab, size=(1, GEN_S)) for _ in range(CONT_BURST)]
    try:
        fa.LAUNCHES = fd.LAUNCHES = kw.LAUNCHES = fd.PAGED_LAUNCHES = kw.PAGED_LAUNCHES = 0
        snap0 = g.snapshot()
        s1 = request("POST", url, {"data": {"ndarray": p1.tolist()}})
        s32 = request("POST", url, {"data": {"tensor": {"shape": list(p32.shape),
                                                         "values": p32.ravel().tolist()}}})
        preempted32 = g.snapshot()["preempted_total"] - snap0["preempted_total"]
        g.decode_round_rows_max = 0
        with ThreadPoolExecutor(CONT_BURST) as pool:
            futs = []
            for x in pb:
                futs.append(pool.submit(request, "POST", url, {"data": {"ndarray": x.tolist()}}))
                time.sleep(CONT_GAP_S)
            sb = [f.result() for f in futs]
        burst_rows_max = g.decode_round_rows_max
        events, first_s, wall_s = sse_stream(port, {"data": {"ndarray": p1.tolist()},
                                                    "chunk": STREAM_CHUNK})
        snap1 = g.snapshot()
        launches = {"flash_decode_paged": fd.PAGED_LAUNCHES, "kv_write_paged": kw.PAGED_LAUNCHES,
                    "flash_attention": fa.LAUNCHES, "flash_decode": fd.LAUNCHES,
                    "kv_write": kw.LAUNCHES}
        st_stats, raw_stats = request("GET", f"http://127.0.0.1:{port}/stats")
    finally:
        server.stop(close_engine=False)
    steps = snap1["decode_steps_total"] - snap0["decode_steps_total"]
    ticks = snap1["prefill_dispatches_total"] - snap0["prefill_dispatches_total"]
    want = {"flash_decode_paged": cfg.n_layers * steps, "kv_write_paged": cfg.n_layers * ticks,
            "flash_attention": 0, "flash_decode": 0, "kv_write": 0}
    if launches != want or steps == 0 or ticks == 0:
        raise AssertionError(f"continuous launches {launches}, not {want} ({steps} decode steps, "
                             f"{ticks} prefill ticks)")
    stats = json.loads(raw_stats)
    if st_stats != 200 or stats["batcher"] != {"mode": "genserver"} or any(
            stats["kernels"][k]["launches"] != launches[k]
            for k in ("flash_decode_paged", "kv_write_paged")):
        raise AssertionError(f"/stats does not report the continuous lane: {raw_stats[:400]!r}")
    if preempted32 < 1:
        raise AssertionError("the 32-row request preempted no sequence")
    if burst_rows_max < 2:
        raise AssertionError(f"the {CONT_BURST} staggered requests never shared a decode round")
    log(f"[continuous] 1-row, 32-row, {CONT_BURST} staggered 1-row requests and a 1-row stream: "
        f"{steps} decode steps in {steps // g.span} rounds and {ticks} prefill ticks; launches "
        f"{launches} = {cfg.n_layers} x {steps} flash_decode_paged (the step's write fused in) "
        f"and {cfg.n_layers} x {ticks} kv_write_paged (prefill ticks only), none of the static "
        f"lane's; /stats agrees")
    log(f"[continuous] the 32-row request preempted {preempted32} sequences (pool "
        f"{g.num_blocks - 1} blocks, {snap1['kv_blocks']['high_water']} at most in use); the "
        f"staggered requests shared rounds of up to {burst_rows_max} rows; scheduler "
        f"{json.dumps({k: snap1[k] for k in ('admitted_total', 'retired_total', 'preempted_total', 'steps_total', 'prefill_chunk_effective')})}")
    if not events or events[-1].get("done") is not True:
        raise AssertionError(f"the stream did not end with its terminal frame: {events[-1:]}")
    chunks = [np.asarray(e["tokens"], dtype=np.float64) for e in events[:-1]]
    if [c.shape[1] for c in chunks] != [STREAM_CHUNK] * (new // STREAM_CHUNK):
        raise AssertionError(f"stream frames {[c.shape for c in chunks]}")
    streamed = np.concatenate(chunks, axis=1).astype(np.int64)
    y1 = check_tokens(*s1, p1, "ndarray")
    y32 = check_tokens(*s32, p32, "tensor")
    yb = np.concatenate([check_tokens(*r, x, "ndarray") for r, x in zip(sb, pb)])
    if not np.array_equal(streamed, y1):
        raise AssertionError(f"the stream differs from the unary answer for the same prompt at "
                             f"{int((streamed != y1).sum())} positions")
    gaps, exacts = [], []
    for prompts, toks in ((p32, y32), (np.concatenate([p1] + pb), np.concatenate([y1, yb]))):
        gap, exact = teacher_forced(torch, lm_apply, params, cfg, prompts, toks, dev)
        gaps.append(gap.ravel())
        exacts.append(exact.ravel())
    gaps, exacts = np.concatenate(gaps), np.concatenate(exacts)
    log(f"[continuous] teacher-forced, {gaps.size} served tokens: gap to the plain maximum max "
        f"{gaps.max():.5f}, p99 {np.quantile(gaps, 0.99):.5f} (delta {TOKEN_DELTA}); "
        f"{exacts.mean() * 100:.2f}% equal the plain argmax; the stream equals the unary answer "
        f"(first frame after {first_s * 1e3:.3f} ms)")
    if gaps.max() > TOKEN_DELTA:
        raise AssertionError(f"a served token is {gaps.max():.4f} below the plain maximum")
    log(f"[continuous] phase wall {time.perf_counter() - t_phase:.2f} s")

    # -- continuous: times ----------------------------------------------------
    t_phase = time.perf_counter()
    static = EngineService(spec, device=dev)  # SELDON_TPU_GEN_CONTINUOUS=0: the static lane
    if static.genserver is not None:
        raise AssertionError("the kill switch did not keep the static lane")
    static.load_states(engine.states())
    lanes = {"continuous": ServerThread(engine), "static": ServerThread(static)}
    ports = {name: s.start() for name, s in lanes.items()}
    body32 = {"data": {"tensor": {"shape": list(p32.shape), "values": p32.ravel().tolist()}}}
    walls = {name: {"ttft": [], "request32": []} for name in lanes}
    try:
        for name in lanes:  # warm-up
            sse_stream(ports[name], {"data": {"ndarray": p1.tolist()}, "chunk": STREAM_CHUNK})
        for _ in range(CONT_TURNS):
            for name in ("continuous", "static", "static", "continuous"):
                _, first, _ = sse_stream(ports[name], {"data": {"ndarray": p1.tolist()},
                                                       "chunk": STREAM_CHUNK})
                t = time.perf_counter()
                st, _raw = request("POST", f"http://127.0.0.1:{ports[name]}/api/v0.1/predictions",
                                   body32)
                walls[name]["request32"].append(time.perf_counter() - t)
                walls[name]["ttft"].append(first)
                if st != 200:
                    raise AssertionError(f"{name} 32-row request: HTTP {st}")
    finally:
        lanes["static"].stop()
        lanes["continuous"].stop(close_engine=False)
    lane_ms = {name: {k: [float(x) for x in np.percentile(np.asarray(v) * 1e3, [25, 50, 75])]
                      for k, v in w.items()} for name, w in walls.items()}
    for name, w in lane_ms.items():
        log(f"[times] {name} lane over REST, in turns (ABBA, {2 * CONT_TURNS} each): 1-row "
            f"{GEN_S}-token TTFT (first SSE frame, chunk {STREAM_CHUNK}) p25/p50/p75 "
            f"{'/'.join(f'{x:.3f}' for x in w['ttft'])} ms; the 32-row request's wall "
            f"{'/'.join(f'{x:.3f}' for x in w['request32'])} ms, on {smi}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    with torch.inference_mode():
        inputs = round_inputs(torch, cfg, GEN_B, GEN_S, dev, gen)

        def one_round():
            return paged_decode_round(params, inputs[0], *inputs[1:], cfg, span=g.span,
                                      use_flash=True)[0]

        round_ms = wall_p50(torch, one_round, 5)
        prof = device_profile(torch, one_round, "continuous_round", by_name=True)
        paged_ms = sum(v for k, v in prof.pop("by_name").items() if "paged_decode_kernel" in k)
        per_step = {"launches": prof["kernels"] / g.span, "device_ms": prof["kernel_ms"] / g.span,
                    "flash_decode_paged_ms": paged_ms / g.span,
                    "flash_decode_paged_share": paged_ms / prof["kernel_ms"]}
        fd.PAGED_LAUNCHES = kw.PAGED_LAUNCHES = 0
        one_round()
        torch.cuda.synchronize()
        if (fd.PAGED_LAUNCHES, kw.PAGED_LAUNCHES) != (cfg.n_layers * g.span, 0):
            raise AssertionError(f"a round launched {fd.PAGED_LAUNCHES} flash_decode_paged and "
                                 f"{kw.PAGED_LAUNCHES} kv_write_paged, not "
                                 f"{cfg.n_layers * g.span} and 0")
        tick_ms = {}
        for B, C, start in ((GEN_B, 128, 0), (GEN_B, 128, 384), (GEN_B, 512, 0), (1, 512, 0)):
            nblk = 1 << max(-(-(start + C) // PAGED_BS) - 1, 0).bit_length()
            toks = torch.randint(0, cfg.vocab, (B, C), generator=gen, device=dev).to(torch.int32)
            args = (toks, inputs[0], inputs[1][:B, :nblk].contiguous(),
                    torch.full((B,), start, dtype=torch.int32, device=dev),
                    torch.full((B,), C, dtype=torch.int32, device=dev))
            tick_ms[f"B{B}_C{C}_at{start}"] = wall_p50(
                torch, lambda: paged_forward(params, *args[:2], *args[2:], cfg, use_flash=True),
                5)
        del inputs
    served = {
        "lanes_ms": lane_ms,
        "round_wall_ms": round_ms,
        "decode_tokens_per_s": GEN_B * g.span / (round_ms / 1e3),
        "per_step": per_step,
        "round_busy_share": prof["busy_share"],
        "round_profile": prof,
        "prefill_tick_ms": tick_ms,
        "served_first_frame_ms": first_s * 1e3,
        "served_stream_wall_ms": wall_s * 1e3,
        "preempted_32row": preempted32,
        "burst_round_rows_max": burst_rows_max,
        "card": smi,
    }
    log(f"[times] a decode round, B={GEN_B} at {GEN_S} cached positions, span {g.span}: wall p50 "
        f"{round_ms:.3f} ms ({served['decode_tokens_per_s']:.1f} tokens/s); profiled: "
        f"{per_step['launches']:.1f} launches and {per_step['device_ms']:.4f} ms of device "
        f"kernels per step, of which flash_decode_paged "
        f"{per_step['flash_decode_paged_ms']:.4f} ms "
        f"({per_step['flash_decode_paged_share'] * 100:.1f}%), busy "
        f"{prof['busy_share'] * 100:.1f}% on {smi}")
    log(f"[times] prefill ticks (paged_forward, the plain attention) wall p50: "
        f"{json.dumps({k: round(v, 3) for k, v in tick_ms.items()})} ms on {smi}")
    log(json.dumps({"continuous_lane": served}))
    rows_t = paged_times(torch, fd, kw, dev, smi)
    engine.close()
    log(f"[times] phase wall {time.perf_counter() - t_phase:.2f} s")
    out = []
    for name, source, replaces, shape_text in (
            ("flash_decode_paged", "flash_decode_paged.cu",
             "seldon_core_tpu/ops/flash_decode.py:47",
             f"B=32 KV=4 G=4 hd=64, {PAGED_NBLK} blocks of {PAGED_BS}, n=560 in every row, bf16 "
             f"(the attention alone; the main path's calls also take the step's write)"),
            ("kv_write_paged", "kv_write.cu", "scripts/probe_inplace.py:55",
             f"pools ({GEN_B * PAGED_NBLK + 1},4,{PAGED_BS},64) bf16, a prefill tick's B=32 rows "
             f"of W={KV_PAGED_TIMED[0][2]}")):
        top = rows_t[name][0]
        out.append({
            "name": name,
            "route": "cuda",
            "source": f"seldon_core_tpu_torch/ops/csrc/{source}",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": top["ms"],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "shape": shape_text,
            "at": rows_t[name],
        })
    out[0]["design"] = PAGED_DESIGN
    out[1]["design"] = KV_PAGED_DESIGN
    out[0]["served"] = served
    return out


# -- the generator's serving modes: sampling, the shared prefix, speculative ----

SAMPLING = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}
PREFIX_P = 200            # 12 full blocks of 16 and an 8-token tail
PREFIX_S = GEN_S - PREFIX_P
SPEC_K = 4
# the speculative phase's pools: 32 rows of 512 + 64 + k + 1 positions of
# the MHA target take 1,184 blocks of 16, past the default 1,024 (which
# preempts, as the continuous phase shows); every engine of the phase,
# the plain one it is timed against too, gets the same larger pool
SPEC_POOL_BLOCKS = 2048
SPEC_ENV = {"SELDON_TPU_GEN_POOL_BLOCKS": str(SPEC_POOL_BLOCKS)}
MODE_TURNS = 1            # ABBA turns of each timing below (2 walls a side)
COUNTED = ("flash_attention", "flash_decode", "kv_write", "flash_decode_paged", "kv_write_paged")


def reset_counts(fa, fd, kw) -> None:
    fa.LAUNCHES = fd.LAUNCHES = kw.LAUNCHES = fd.PAGED_LAUNCHES = kw.PAGED_LAUNCHES = 0


def read_counts(fa, fd, kw) -> dict:
    return dict(zip(COUNTED, (fa.LAUNCHES, fd.LAUNCHES, kw.LAUNCHES, fd.PAGED_LAUNCHES,
                              kw.PAGED_LAUNCHES)))


def mode_engine(torch, dev, doc: dict, continuous: bool, env=None):
    """An engine for ``doc`` on the continuous lane or, with
    SELDON_TPU_GEN_CONTINUOUS=0, the static lane (and ``env``'s knobs);
    the environment as it was afterwards."""
    from seldon_core_tpu_torch.graph.defaulting import default_and_validate
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.runtime.engine import EngineService

    spec = default_and_validate(SeldonDeploymentSpec.from_json_dict(doc))
    env = {"SELDON_TPU_GEN_CONTINUOUS": "1" if continuous else "0", **(env or {})}
    prev = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        engine = EngineService(spec, device=dev)
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    if (engine.genserver is not None) != continuous:
        raise AssertionError(f"the engine did not serve the {'continuous' if continuous else 'static'} "
                             f"lane")
    return engine


def ndarray(x) -> dict:
    return {"data": {"ndarray": np.asarray(x).tolist()}}


def sse_first_frame(port: int, body: dict, engine) -> float:
    """Seconds from sending a stream request to its first SSE frame; the
    connection is closed then, and the call returns once the lane has
    dropped the rest (the engine drained, then one more scheduler tick's
    worth of wait), so the next measurement finds it idle."""
    import socket

    payload = json.dumps(body).encode()
    t0 = time.perf_counter()
    with socket.create_connection(("127.0.0.1", port), timeout=120) as sock:
        sock.sendall(b"POST /api/v0.1/generate/stream HTTP/1.1\r\nHost: smoke\r\n"
                     b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n"
                     % len(payload) + payload)
        f = sock.makefile("rb")
        if not f.readline().startswith(b"HTTP/1.1 200"):
            raise AssertionError("the stream was not answered 200")
        while f.readline() not in (b"\r\n", b""):
            pass
        n = int(f.readline().strip(), 16)
        frame = f.read(n)
        first = time.perf_counter() - t0
    if not frame.startswith(b"data: ") or "tokens" not in json.loads(frame[6:]):
        raise AssertionError(f"the first frame is not a token frame: {frame[:80]!r}")
    deadline = time.perf_counter() + 60
    while not engine.drained() and time.perf_counter() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)  # a static stream's last chunk on the executor
    return first


def quartiles_ms(walls) -> list:
    return [float(q) for q in np.percentile(np.asarray(walls) * 1e3, [25, 50, 75])]


def check_gaps(torch, lm_apply, params, cfg, sets, dev, kth: int, what: str) -> dict:
    """Every token of every (prompts, tokens) set teacher-forced through the
    plain path: within TOKEN_DELTA of the ``kth`` largest logit."""
    gaps, exacts = [], []
    for prompts, toks in sets:
        gap, exact = teacher_forced(torch, lm_apply, params, cfg, prompts, toks, dev, kth)
        gaps.append(gap.ravel())
        exacts.append(exact.ravel())
    gaps, exacts = np.concatenate(gaps), np.concatenate(exacts)
    bound = "maximum" if kth == 1 else f"{kth}th largest logit"
    log(f"[{what}] teacher-forced, {gaps.size} tokens: the {bound} minus the token's logit "
        f"max {gaps.max():.5f}, p99 {np.quantile(gaps, 0.99):.5f} (delta {TOKEN_DELTA}); "
        f"{exacts.mean() * 100:.2f}% equal the plain argmax")
    if gaps.max() > TOKEN_DELTA:
        raise AssertionError(f"[{what}] a token is {gaps.max():.4f} below the {bound}")
    return {"tokens": int(gaps.size), "gap_max": float(gaps.max()),
            "argmax_share": float(exacts.mean())}


def sampled_phase(torch, dev, smi, counts: dict) -> dict:
    """10d. The flagship generator with temperature 0.8, top_k 50, top_p
    0.95 on both lanes: each token in its teacher-forced top 50 (within
    TOKEN_DELTA), a fresh engine with the same seed replays the first
    request's answer, launch counts; then a continuous round's device time
    and wall, sampled against greedy in turns."""
    from seldon_core_tpu_torch.models import prng
    from seldon_core_tpu_torch.models.generate import paged_decode_round
    from seldon_core_tpu_torch.models.transformer import lm_apply
    from seldon_core_tpu_torch.ops import flash_attention as fa, flash_decode as fd
    from seldon_core_tpu_torch.ops import kv_write as kw

    t_phase = time.perf_counter()
    doc = gen_deployment(params=SAMPLING)
    rng = np.random.default_rng(SEED + 21)
    vocab, new = GEN_DIMS["vocab"], GEN_DIMS["max_new_tokens"]
    probe = rng.integers(0, vocab, size=(1, GEN_S))
    pb = [rng.integers(0, vocab, size=(1, GEN_S)) for _ in range(CONT_BURST)]
    p32 = rng.integers(0, vocab, size=(GEN_B, GEN_S))
    p8 = rng.integers(0, vocab, size=(8, GEN_S))
    out = {}

    # the continuous lane: the probe first, 8 staggered 1-row requests, a 32-row one
    engine = mode_engine(torch, dev, doc, continuous=True)
    g = engine.genserver
    if (g.temperature, g.top_k, g.top_p) != (0.8, 50, 0.95):
        raise AssertionError("the continuous lane did not take the sampling knobs")
    params, cfg = engine.states()["gen"]["params"], engine.compiled.units["gen"].cfg
    server = ServerThread(engine)
    port = server.start()
    url = f"http://127.0.0.1:{port}/api/v0.1/predictions"
    try:
        reset_counts(fa, fd, kw)
        snap0 = g.snapshot()
        s_probe = request("POST", url, ndarray(probe))
        with ThreadPoolExecutor(CONT_BURST) as pool:
            futs = []
            for x in pb:
                futs.append(pool.submit(request, "POST", url, ndarray(x)))
                time.sleep(CONT_GAP_S)
            sb = [f.result() for f in futs]
        s32 = request("POST", url, ndarray(p32))
        launches = read_counts(fa, fd, kw)
        snap1 = g.snapshot()
    finally:
        server.stop(close_engine=False)
    steps = snap1["decode_steps_total"] - snap0["decode_steps_total"]
    ticks = snap1["prefill_dispatches_total"] - snap0["prefill_dispatches_total"]
    want = {"flash_attention": 0, "flash_decode": 0, "kv_write": 0,
            "flash_decode_paged": cfg.n_layers * steps, "kv_write_paged": cfg.n_layers * ticks}
    if launches != want or not steps or not ticks:
        raise AssertionError(f"[sampled] continuous launches {launches}, not {want}")
    for k, v in launches.items():
        counts[k] += v
    y_probe = check_tokens(*s_probe, probe, "ndarray")
    yb = np.concatenate([check_tokens(*r, x, "ndarray") for r, x in zip(sb, pb)])
    y32 = check_tokens(*s32, p32, "ndarray")
    log(f"[sampled] continuous lane, temperature 0.8 / top_k 50 / top_p 0.95: the probe, "
        f"{CONT_BURST} staggered 1-row requests and a 32-row one in {steps} decode steps and "
        f"{ticks} prefill ticks; launches {launches} = {cfg.n_layers} x {steps} "
        f"flash_decode_paged and {cfg.n_layers} x {ticks} kv_write_paged")
    out["continuous"] = check_gaps(torch, lm_apply, params, cfg,
                                   ((np.concatenate([probe] + pb), np.concatenate([y_probe, yb])),
                                    (p32, y32)), dev, SAMPLING["top_k"], "sampled")
    out["continuous"].update(launches=launches, decode_steps=steps, prefill_ticks=ticks)

    # the random source gives the same draws on the card as on the host
    keys = torch.stack([prng.fold_in(prng.key(SEED + 23), i) for i in range(GEN_B)])
    host_keys, host_g = prng.split(keys), prng.gumbel(keys, vocab)
    dev_keys, dev_g = prng.split(keys.to(dev)), prng.gumbel(keys.to(dev), vocab)
    g_diff = (dev_g.cpu() - host_g).abs()
    if not all(torch.equal(a.cpu(), b) for a, b in zip(dev_keys, host_keys)) \
            or float(g_diff.max()) > 1e-6:
        raise AssertionError(f"[sampled] the card's keys or Gumbel draws differ from the host's "
                             f"(largest draw difference {float(g_diff.max()):.3e})")
    out["gumbel_host_vs_card"] = {"draws": int(g_diff.numel()),
                                  "bit_identical": int((g_diff == 0).sum()),
                                  "max_abs_diff": float(g_diff.max())}
    log(f"[sampled] models/prng.py on the card and on the host, {GEN_B} keys: splits "
        f"bit-identical; of {g_diff.numel()} Gumbel draws {int((g_diff == 0).sum())} "
        f"bit-identical, the largest difference {float(g_diff.max()):.3e}")

    # a continuous round, sampled against greedy, in turns
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    with torch.inference_mode():
        inputs = round_inputs(torch, cfg, GEN_B, GEN_S, dev, gen)
        keys = torch.stack([prng.fold_in(prng.key(SEED), i) for i in range(GEN_B)]).to(dev)
        rounds = {
            "greedy": lambda: paged_decode_round(params, inputs[0], *inputs[1:], cfg, span=g.span,
                                                 use_flash=True)[0],
            "sampled": lambda: paged_decode_round(params, inputs[0], *inputs[1:], cfg, span=g.span,
                                                  keys=keys, use_flash=True, **SAMPLING)[0]}
        walls = {name: [] for name in rounds}
        for fn in rounds.values():
            fn()
        for _ in range(MODE_TURNS):
            for name in ("greedy", "sampled", "sampled", "greedy"):
                torch.cuda.synchronize()
                t = time.perf_counter()
                rounds[name]()
                torch.cuda.synchronize()
                walls[name].append(time.perf_counter() - t)
        prof = {name: device_profile(torch, fn, f"round_{name}", by_name=True)
                for name, fn in rounds.items()}
        del inputs
    per_step = {}
    for name, pr in prof.items():
        by_name = pr.pop("by_name")
        sort_ms = sum(v for k, v in by_name.items() if "sort" in k.lower() or "radix" in k.lower())
        per_step[name] = {"launches": pr["kernels"] / g.span, "device_ms": pr["kernel_ms"] / g.span,
                          "sort_ms": sort_ms / g.span, "wall_quartiles_ms": quartiles_ms(walls[name]),
                          "busy_share": pr["busy_share"]}
        log(f"[times] a continuous round, B={GEN_B} at {GEN_S} cached positions, span {g.span}, "
            f"{name}: wall p25/p50/p75 {'/'.join(f'{x:.3f}' for x in per_step[name]['wall_quartiles_ms'])} "
            f"ms in turns; profiled {per_step[name]['launches']:.1f} launches and "
            f"{per_step[name]['device_ms']:.4f} ms of device kernels a step, sort kernels "
            f"{per_step[name]['sort_ms']:.4f} ms a step, busy {pr['busy_share'] * 100:.1f}% on {smi}")
    out["round"] = per_step
    out["sampling_device_ms_per_step"] = per_step["sampled"]["device_ms"] - per_step["greedy"]["device_ms"]
    log(f"[times] sampling costs {out['sampling_device_ms_per_step']:.4f} ms of device kernels and "
        f"{per_step['sampled']['launches'] - per_step['greedy']['launches']:.1f} launches a step "
        f"over greedy (the sort over V={GEN_DIMS['vocab']}: {per_step['sampled']['sort_ms']:.4f} ms)")
    engine.close()

    replay = mode_engine(torch, dev, doc, continuous=True)  # a fresh engine, the same seed
    try:
        y_again = replay.genserver.submit(probe.astype(float)).future.result(120)
    finally:
        replay.close()
    if not np.array_equal(y_again, y_probe):
        raise AssertionError("[sampled] a fresh continuous engine did not replay the probe's answer")
    log(f"[sampled] a fresh continuous engine with the same seed replayed the probe's {new} "
        f"tokens")

    # the static lane: a 1-row and an 8-row request (no batcher), a 1-row stream
    static = mode_engine(torch, dev, doc, continuous=False)
    if static.batcher is not None:
        raise AssertionError("[sampled] the static lane batched a batch-coupled unit")
    server = ServerThread(static)
    port = server.start()
    url = f"http://127.0.0.1:{port}/api/v0.1/predictions"
    try:
        reset_counts(fa, fd, kw)
        s1 = request("POST", url, ndarray(probe))
        s8 = request("POST", url, ndarray(p8))
        events, first_s, _ = sse_stream(port, {**ndarray(probe), "chunk": STREAM_CHUNK})
        launches = read_counts(fa, fd, kw)
    finally:
        server.stop(close_engine=False)
    want = {"flash_attention": 3 * cfg.n_layers, "flash_decode": 3 * cfg.n_layers * (new - 1),
            "kv_write": 0, "flash_decode_paged": 0, "kv_write_paged": 0}
    if launches != want:
        raise AssertionError(f"[sampled] static launches {launches}, not {want}")
    if int(static.states()["gen"]["requests"]) != 2:
        raise AssertionError("[sampled] the static lane did not count its two requests")
    for k, v in launches.items():
        counts[k] += v
    y1 = check_tokens(*s1, probe, "ndarray")
    y8 = check_tokens(*s8, p8, "ndarray")
    streamed = np.concatenate([np.asarray(e["tokens"], np.int64) for e in events[:-1]], axis=1)
    params = static.states()["gen"]["params"]
    log(f"[sampled] static lane: a 1-row and an 8-row request and a 1-row stream (first frame "
        f"{first_s * 1e3:.3f} ms); launches {launches}; the request counter at 2")
    out["static"] = check_gaps(torch, lm_apply, params, cfg,
                               ((np.concatenate([probe, p8, probe]),
                                 np.concatenate([y1, y8, streamed])),), dev,
                               SAMPLING["top_k"], "sampled")
    out["static"]["launches"] = launches
    static.close()
    replay = mode_engine(torch, dev, doc, continuous=False)
    try:
        with torch.inference_mode():
            y_again = replay.compiled.predict_arrays(probe.astype(np.float32))[0].cpu().numpy()
    finally:
        replay.close()
    if not np.array_equal(y_again, y1):
        raise AssertionError("[sampled] a fresh static engine did not replay the first answer")
    log("[sampled] a fresh static engine with the same seed replayed the first request's answer")
    log(f"[sampled] phase wall {time.perf_counter() - t_phase:.2f} s")
    return out


def prefix_phase(torch, dev, smi, counts: dict) -> dict:
    """10e. The flagship generator with a 200-token prefix_tokens (12 full
    blocks of 16, an 8-token tail), greedy, on both lanes: a 1-row and a
    32-row request of 312-token suffixes, every token within TOKEN_DELTA of
    its teacher-forced maximum over prefix + suffix; on the continuous
    lane the pinned blocks hold the prefix cache, bit for bit, before and
    after, and kv_write_paged launches 12 for them, 12 a tail and 12 a
    prefill tick; then TTFT against the same 512 tokens sent without a
    prefix, in turns."""
    from seldon_core_tpu_torch.models.transformer import lm_apply
    from seldon_core_tpu_torch.ops import flash_attention as fa, flash_decode as fd
    from seldon_core_tpu_torch.ops import kv_write as kw

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 31)
    vocab, new = GEN_DIMS["vocab"], GEN_DIMS["max_new_tokens"]
    prefix = rng.integers(0, vocab, size=PREFIX_P)
    doc = gen_deployment(params={"prefix_tokens": ",".join(str(t) for t in prefix)})
    p1 = rng.integers(0, vocab, size=(1, PREFIX_S))
    p32 = rng.integers(0, vocab, size=(GEN_B, PREFIX_S))
    full = lambda x: np.concatenate([np.broadcast_to(prefix, (len(x), PREFIX_P)), x], axis=1)  # noqa: E731
    out = {}

    engine = mode_engine(torch, dev, doc, continuous=True)
    g = engine.genserver
    state = engine.states()["gen"]
    params, cfg, pc = state["params"], engine.compiled.units["gen"].cfg, state["prefix_cache"]

    def pinned_bytes():
        blocks = g._prefix_blocks
        return {li: {kk: g._pool[li][kk][blocks].clone() for kk in "kv"} for li in g._pool}

    server = ServerThread(engine)
    port = server.start()
    url = f"http://127.0.0.1:{port}/api/v0.1/predictions"
    try:
        reset_counts(fa, fd, kw)
        snap0 = g.snapshot()
        s1 = request("POST", url, ndarray(p1))  # its first tick writes and pins the full blocks
        before = pinned_bytes()
        s32 = request("POST", url, ndarray(p32))
        launches = read_counts(fa, fd, kw)
        snap1 = g.snapshot()
        after = pinned_bytes()
    finally:
        server.stop(close_engine=False)
    full_blocks = PREFIX_P // g.block_size
    steps = snap1["decode_steps_total"] - snap0["decode_steps_total"]
    ticks = snap1["prefill_dispatches_total"] - snap0["prefill_dispatches_total"]
    tails = snap1["prefix_tail_writes_total"] - snap0["prefix_tail_writes_total"]
    want = {"flash_attention": 0, "flash_decode": 0, "kv_write": 0,
            "flash_decode_paged": cfg.n_layers * steps,
            "kv_write_paged": cfg.n_layers * (1 + tails + ticks)}
    if launches != want or len(g._prefix_blocks) != full_blocks or tails < 1 + GEN_B:
        raise AssertionError(f"[prefix] continuous launches {launches}, not {want} ({tails} "
                             f"tails, {len(g._prefix_blocks)} pinned blocks)")
    for k, v in launches.items():
        counts[k] += v
    for li in before:
        for kk in "kv":
            # the pool's [blocks, KV, bs, hd] against the cache's [1, KV, P, hd]
            want_b = pc[li][kk][0, :, :full_blocks * g.block_size].reshape(
                cfg.kv_heads, full_blocks, g.block_size, cfg.head_dim).transpose(0, 1)
            if not torch.equal(before[li][kk], want_b) or not torch.equal(after[li][kk], want_b):
                raise AssertionError(f"[prefix] pinned blocks of {li}.{kk} are not the prefix "
                                     f"cache, or changed during the phase")
    if snap1["kv_blocks"]["pinned"] != full_blocks:
        raise AssertionError(f"[prefix] {snap1['kv_blocks']['pinned']} blocks pinned")
    log(f"[prefix] continuous lane, a {PREFIX_P}-token prefix ({full_blocks} blocks pinned, an "
        f"{PREFIX_P - full_blocks * g.block_size}-token tail): a 1-row and a 32-row request of "
        f"{PREFIX_S}-token suffixes in {steps} decode steps, {ticks} prefill ticks and {tails} "
        f"tail writes ({snap1['preempted_total'] - snap0['preempted_total']} preemptions); "
        f"launches {launches} = {cfg.n_layers} x {steps} flash_decode_paged and {cfg.n_layers} x "
        f"(1 + {tails} + {ticks}) kv_write_paged; the pinned blocks hold the prefix cache bit "
        f"for bit before and after")
    y1 = check_tokens(*s1, p1, "ndarray")
    y32 = check_tokens(*s32, p32, "ndarray")
    out["continuous"] = check_gaps(torch, lm_apply, params, cfg,
                                   ((full(p1), y1), (full(p32), y32)), dev, 1, "prefix")
    out["continuous"].update(launches=launches, tail_writes=tails, prefill_ticks=ticks)

    static = mode_engine(torch, dev, doc, continuous=False)
    server = ServerThread(static)
    sport = server.start()
    try:
        reset_counts(fa, fd, kw)
        s1 = request("POST", f"http://127.0.0.1:{sport}/api/v0.1/predictions", ndarray(p1))
        s32 = request("POST", f"http://127.0.0.1:{sport}/api/v0.1/predictions", ndarray(p32))
        launches = read_counts(fa, fd, kw)
    finally:
        server.stop(close_engine=False)
    want = {"flash_attention": 0, "flash_decode": 2 * cfg.n_layers * (new - 1), "kv_write": 0,
            "flash_decode_paged": 0, "kv_write_paged": 0}
    if launches != want:
        raise AssertionError(f"[prefix] static launches {launches}, not {want}")
    for k, v in launches.items():
        counts[k] += v
    log(f"[prefix] static lane: a 1-row and a 32-row request; launches {launches} (the suffix "
        f"prefills as a causal segment through the plain attention; every decode step through "
        f"flash_decode_two_tier over main = prefix + suffix)")
    y1 = check_tokens(*s1, p1, "ndarray")
    y32 = check_tokens(*s32, p32, "ndarray")
    out["static"] = check_gaps(torch, lm_apply, static.states()["gen"]["params"], cfg,
                               ((full(p1), y1), (full(p32), y32)), dev, 1, "prefix")
    out["static"]["launches"] = launches

    # TTFT (the first SSE frame at chunk 1), prefixed against the same 512
    # tokens sent whole to an engine without the prefix, in turns; on the
    # continuous lane both engines prefill in one chunk of up to 512 (the
    # adaptive chunk would otherwise differ between them with their history)
    engine.close()
    one_chunk = {"SELDON_TPU_GEN_PREFILL_CHUNK": str(GEN_S)}
    timed = {True: {"prefix": mode_engine(torch, dev, doc, True, env=one_chunk),
                    "whole": mode_engine(torch, dev, gen_deployment(), True, env=one_chunk)},
             False: {"prefix": static,
                     "whole": mode_engine(torch, dev, gen_deployment(), continuous=False)}}
    ttft = {}
    for continuous, by_name in timed.items():
        lane = "continuous" if continuous else "static"
        servers = {name: ServerThread(e) for name, e in by_name.items()}
        ports = {name: srv.start() for name, srv in servers.items()}
        try:
            for rows, x in (("1-row", p1), ("32-row", p32)):
                bodies = {"prefix": {**ndarray(x), "chunk": 1},
                          "whole": {**ndarray(full(x)), "chunk": 1}}
                walls = {name: [] for name in bodies}
                for name in bodies:  # warm-up
                    sse_first_frame(ports[name], bodies[name], by_name[name])
                for _ in range(MODE_TURNS):
                    for name in ("prefix", "whole", "whole", "prefix"):
                        walls[name].append(sse_first_frame(ports[name], bodies[name],
                                                           by_name[name]))
                ttft[f"{lane}_{rows}"] = {name: quartiles_ms(w) for name, w in walls.items()}
                log(f"[times] {lane} lane, {rows} TTFT (first SSE frame at chunk 1) p25/p50/p75, "
                    f"in turns: {PREFIX_P}-token prefix + {PREFIX_S}-token suffix "
                    f"{'/'.join(f'{v:.3f}' for v in ttft[f'{lane}_{rows}']['prefix'])} ms, the "
                    f"same {GEN_S} tokens without the prefix "
                    f"{'/'.join(f'{v:.3f}' for v in ttft[f'{lane}_{rows}']['whole'])} ms"
                    f"{f' (prefill chunk {GEN_S})' if continuous else ''}, on {smi}")
        finally:
            for srv in servers.values():
                srv.stop()
    out["ttft_ms"] = ttft
    log(f"[prefix] phase wall {time.perf_counter() - t_phase:.2f} s")
    return out


def spec_deployment(self_draft: bool) -> dict:
    """SpeculativeGenerator with the flagship target's dims (MHA: the unit
    has no n_kv_heads), bf16, k=4, 64 new tokens; the default draft, or a
    draft of the target's own dims."""
    params = {k: v for k, v in GEN_DIMS.items() if k != "n_kv_heads"}
    params.update(k=SPEC_K, dtype="bfloat16", n_kv_heads=None, quant=None)
    if self_draft:
        params.update(draft_d_model=GEN_DIMS["d_model"], draft_n_heads=GEN_DIMS["n_heads"],
                      draft_n_layers=GEN_DIMS["n_layers"], draft_d_ff=GEN_DIMS["d_ff"])
    return gen_deployment(params=params, class_path="SpeculativeGenerator")


def speculative_phase(torch, dev, smi, counts: dict) -> dict:
    """10f. SpeculativeGenerator at the flagship target's dims with two
    drafts, the default one and the target itself (its weights carried
    into the draft), on both lanes: every token within TOKEN_DELTA of the
    target's teacher-forced maximum; the continuous lane launches
    flash_decode_paged once a draft layer a draft step and kv_write_paged
    once a target layer a verify (and a layer of each model a prefill
    tick); the self-draft accepts at least 2 proposals a row-round; then
    the 32-row request's tokens/s of both drafts against the plain
    continuous lane serving the same target, in turns."""
    from seldon_core_tpu_torch.models.transformer import lm_apply
    from seldon_core_tpu_torch.ops import flash_attention as fa, flash_decode as fd
    from seldon_core_tpu_torch.ops import kv_write as kw

    from seldon_core_tpu_torch.models.speculative import SpeculativeGenerator

    t_phase = time.perf_counter()
    # float16 is a dtype the paged kernel does not take: on the card the
    # unit refuses it rather than serve the plain path (its float32 default
    # takes the kernel's float32 path: phase 10g serves it)
    try:
        SpeculativeGenerator(device=dev, dtype="float16")
    except ValueError as e:
        log(f"[speculative] a float16 draft is refused on the card: {e}")
    else:
        raise AssertionError("[speculative] a float16 SpeculativeGenerator was accepted on the "
                             "card, where its draft steps cannot take flash_decode_paged")
    rng = np.random.default_rng(SEED + 41)
    vocab, new = GEN_DIMS["vocab"], GEN_DIMS["max_new_tokens"]
    p1 = rng.integers(0, vocab, size=(1, GEN_S))
    p32 = rng.integers(0, vocab, size=(GEN_B, GEN_S))
    p8 = rng.integers(0, vocab, size=(8, GEN_S))
    out = {"pool_blocks": SPEC_POOL_BLOCKS}
    engines = {}
    for name, self_draft in (("default", False), ("self", True)):
        reset_counts(fa, fd, kw)
        engine = mode_engine(torch, dev, spec_deployment(self_draft), continuous=True,
                             env=SPEC_ENV)
        probes = read_counts(fa, fd, kw)
        if self_draft:  # the draft carries the target's weights
            target = engine.states()["gen"]["target"]
            engine.load_states({"gen": {"target": target, "draft": target}})
        engines[name] = engine
        unit, g = engine.compiled.units["gen"], engine.genserver
        if not g.spec or not g.use_flash or probes["flash_decode_paged"] != 1 \
                or probes["kv_write_paged"] != 2:
            raise AssertionError(f"[speculative] the {name} draft's scheduler did not probe its "
                                 f"kernels ({probes})")
        d = unit.draft_cfg
        log(f"[speculative] {name} draft: d_model {d.d_model}, {d.n_heads} heads of {d.head_dim}, "
            f"{d.n_layers} layers, d_ff {d.d_ff}; the target {unit.target_cfg.d_model} wide, "
            f"{unit.target_cfg.n_heads} heads (MHA) of {unit.target_cfg.head_dim}, "
            f"{unit.target_cfg.n_layers} layers, bf16, k={SPEC_K}")
        server = ServerThread(engine)
        port = server.start()
        url = f"http://127.0.0.1:{port}/api/v0.1/predictions"
        try:
            reset_counts(fa, fd, kw)
            snap0 = g.snapshot()
            s1 = request("POST", url, ndarray(p1))
            s32 = request("POST", url, ndarray(p32))
            launches = read_counts(fa, fd, kw)
            snap1 = g.snapshot()
        finally:
            server.stop(close_engine=False)
        rounds = snap1["spec_rounds_total"] - snap0["spec_rounds_total"]
        row_rounds = snap1["spec_row_rounds_total"] - snap0["spec_row_rounds_total"]
        accepted = snap1["spec_accepted_total"] - snap0["spec_accepted_total"]
        ticks = snap1["prefill_dispatches_total"] - snap0["prefill_dispatches_total"]
        t_layers, d_layers = unit.target_cfg.n_layers, d.n_layers
        want = {"flash_attention": 0, "flash_decode": 0, "kv_write": 0,
                "flash_decode_paged": d_layers * (SPEC_K + 1) * rounds,
                "kv_write_paged": t_layers * rounds + (t_layers + d_layers) * ticks}
        if launches != want or not rounds:
            raise AssertionError(f"[speculative] {name} draft launches {launches}, not {want}")
        for k, v in launches.items():
            counts[k] += v
        mean_accepted = accepted / row_rounds
        log(f"[speculative] continuous lane, {name} draft: a 1-row and a 32-row {GEN_S}-token "
            f"request in {rounds} rounds ({row_rounds} row-rounds, {ticks} prefill ticks, "
            f"{snap1['preempted_total'] - snap0['preempted_total']} preemptions); launches "
            f"{launches} = {d_layers} x {SPEC_K + 1} x {rounds} flash_decode_paged and "
            f"{t_layers} x {rounds} + ({t_layers} + {d_layers}) x {ticks} kv_write_paged; "
            f"{mean_accepted:.3f} of {SPEC_K} proposals accepted a row-round")
        if self_draft and mean_accepted < 2:
            raise AssertionError(f"[speculative] the self-draft accepted {mean_accepted:.3f} < 2 "
                                 f"proposals a row-round")
        target = engine.states()["gen"]["target"]
        y1 = check_tokens(*s1, p1, "ndarray")
        y32 = check_tokens(*s32, p32, "ndarray")
        out[name] = check_gaps(torch, lm_apply, target, unit.target_cfg,
                               ((p1, y1), (p32, y32)), dev, 1, "speculative")
        out[name].update(launches=launches, rounds=rounds, row_rounds=row_rounds,
                         mean_accepted=mean_accepted, prefill_ticks=ticks)

        static = mode_engine(torch, dev, spec_deployment(self_draft), continuous=False)
        static.load_states({"gen": engine.states()["gen"]})
        server = ServerThread(static)
        sport = server.start()
        try:
            reset_counts(fa, fd, kw)
            s8 = request("POST", f"http://127.0.0.1:{sport}/api/v0.1/predictions", ndarray(p8))
            launches = read_counts(fa, fd, kw)
        finally:
            server.stop()
        if any(launches.values()):
            raise AssertionError(f"[speculative] the static lane launched {launches}")
        y8 = check_tokens(*s8, p8, "ndarray")
        log(f"[speculative] static lane, {name} draft: an 8-row request through "
            f"speculative_generate (the reference's plain bitmap-masked attention, no kernel)")
        out[f"{name}_static"] = check_gaps(torch, lm_apply, target, unit.target_cfg,
                                           ((p8, y8),), dev, 1, "speculative")

    # tokens/s of the 32-row request: both drafts against the plain lane
    plain = mode_engine(torch, dev, gen_deployment(params={"n_kv_heads": 0}), continuous=True,
                        env=SPEC_ENV)
    target = engines["default"].states()["gen"]["target"]
    plain.load_states({"gen": {"params": target,
                               "requests": torch.zeros((), dtype=torch.int32, device=dev)}})
    lanes = {"plain": plain, **engines}
    servers = {name: ServerThread(e) for name, e in lanes.items()}
    ports = {name: srv.start() for name, srv in servers.items()}
    walls = {name: [] for name in lanes}
    try:
        answers = {}
        for name in lanes:  # warm-up, and the three answers for the same prompts
            answers[name] = check_tokens(*request(
                "POST", f"http://127.0.0.1:{ports[name]}/api/v0.1/predictions", ndarray(p32)),
                p32, "ndarray")
        for _ in range(MODE_TURNS):
            for name in ("plain", "default", "self", "self", "default", "plain"):
                t = time.perf_counter()
                st, _raw = request("POST", f"http://127.0.0.1:{ports[name]}/api/v0.1/predictions",
                                   ndarray(p32))
                walls[name].append(time.perf_counter() - t)
                if st != 200:
                    raise AssertionError(f"[speculative] {name}: HTTP {st}")
    finally:
        for srv in servers.values():
            srv.stop()
    same = {name: float((answers[name] == answers["plain"]).mean()) for name in engines}
    out["tokens_per_s"] = {name: GEN_B * new / float(np.median(w)) for name, w in walls.items()}
    out["wall_quartiles_ms"] = {name: quartiles_ms(w) for name, w in walls.items()}
    out["same_tokens_as_plain"] = same
    log(f"[times] the 32-row {GEN_S}-token request, {new} new tokens, in turns ({2 * MODE_TURNS} "
        f"walls each): plain continuous lane "
        f"{'/'.join(f'{v:.3f}' for v in out['wall_quartiles_ms']['plain'])} ms "
        f"({out['tokens_per_s']['plain']:.1f} tokens/s); speculative, default draft "
        f"{'/'.join(f'{v:.3f}' for v in out['wall_quartiles_ms']['default'])} ms "
        f"({out['tokens_per_s']['default']:.1f} tokens/s, {out['default']['mean_accepted']:.3f} "
        f"accepted a row-round); self-draft "
        f"{'/'.join(f'{v:.3f}' for v in out['wall_quartiles_ms']['self'])} ms "
        f"({out['tokens_per_s']['self']:.1f} tokens/s, {out['self']['mean_accepted']:.3f} "
        f"accepted); tokens equal to the plain lane's: {json.dumps(same)}, on {smi}")
    log(f"[speculative] phase wall {time.perf_counter() - t_phase:.2f} s")
    return out


def serving_modes_phases(torch, dev, smi):
    """Phases 10d-10f: the generator's sampled, shared-prefix and
    speculative modes on both lanes.  Returns (the launches each kernel
    made on these paths, their numbers)."""
    counts = {k: 0 for k in COUNTED}
    modes = {"sampled": sampled_phase(torch, dev, smi, counts),
             "prefix": prefix_phase(torch, dev, smi, counts),
             "speculative": speculative_phase(torch, dev, smi, counts), "card": smi}
    log(json.dumps({"serving_modes": modes}))
    return counts, modes


# -- the f32 speculative example, the model families and the router ----------

F32_TOKEN_DELTA = 1e-3    # an f32 token within this of the target's teacher-forced maximum
SPEC_EX_P = 24            # prompt tokens of the speculative example's requests
SPEC_EX_TURNS = 2         # walls of the example's 32-row request
FAMILY_P50_REQUESTS = 30  # 1-row requests a family example's p50 is read over
MNIST_ATOL = 2e-2         # the bf16 MNIST probabilities, card kernel vs the CPU's plain version
FAMILY_ATOL = 1e-5        # the f32 families, card vs CPU: f32 sums in other orders
SCORE_RTOL = 1e-3         # outlierScore, cuSOLVER vs LAPACK eigh and solve
FAMILY_INPUTS = {"iris": (4, 2.0, 4.0), "mean_transformer": (6, 10.0, 0.0),
                 "gbm": (8, 1.0, 0.0), "outlier_pipeline": (784, 1.0, 0.0)}


def example_doc(name: str) -> dict:
    return json.loads((ROOT / "examples" / f"{name}_deployment.json").read_text())


def cpu_twin(torch, engine, doc: dict):
    """The same deployment on the CPU, on the same lane, with the card
    engine's states."""
    twin = mode_engine(torch, torch.device("cpu"), doc, continuous=engine.genserver is not None)
    twin.load_states(engine.states())
    return twin


def keepalive_walls(port: int, body: dict, runs: int,
                    path: str = "/api/v0.1/predictions") -> list:
    """The walls (s) of ``runs`` POSTs of ``body`` to ``path`` over one
    keepalive connection."""
    payload = json.dumps(body)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    walls = []
    try:
        for _ in range(runs):
            t = time.perf_counter()
            conn.request("POST", path, payload, {"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            walls.append(time.perf_counter() - t)
            if resp.status != 200:
                raise AssertionError(f"latency loop: HTTP {resp.status}")
    finally:
        conn.close()
    return walls


def keepalive_p50_ms(port: int, body: dict, runs: int) -> float:
    """The p50 wall of ``runs`` POSTs of ``body`` over one keepalive connection."""
    return float(np.median(keepalive_walls(port, body, runs))) * 1e3


def spec_example_phase(torch, dev, smi) -> dict:
    """10g. examples/speculative_deployment.json as written (float32, its
    draft 2 heads of hd 32) on the continuous lane: flash_decode_paged's
    float32 path against its plain version (paged_f32_phase); the engine
    probes the f32 draft shape; a 1-row, an 8-row and 4 concurrent 1-row
    requests over REST, counts reset before and read after:
    flash_decode_paged once a draft layer a draft step, all on the float32
    path, kv_write_paged once a target layer a verify and once a layer of
    each model a prefill tick; every token within F32_TOKEN_DELTA of the
    target's teacher-forced maximum, and equal to the same engine's on the
    CPU (the card's states carried over); then the 32-row request's
    tokens/s and the f32 kernel's times (paged_f32_times)."""
    from seldon_core_tpu_torch.models.transformer import lm_apply
    from seldon_core_tpu_torch.ops import flash_attention as fa, flash_decode as fd
    from seldon_core_tpu_torch.ops import kv_write as kw

    t_phase = time.perf_counter()
    f32_err = paged_f32_phase(torch, fd, dev)
    doc = example_doc("speculative")
    reset_counts(fa, fd, kw)
    fd.PAGED_F32_LAUNCHES = 0
    engine = mode_engine(torch, dev, doc, continuous=True)
    probes = read_counts(fa, fd, kw)
    unit, g = engine.compiled.units["gen"], engine.genserver
    t_cfg, d_cfg = unit.target_cfg, unit.draft_cfg
    if (t_cfg.dtype != torch.float32 or not g.spec or not g.use_flash
            or probes["flash_decode_paged"] != 1 or fd.PAGED_F32_LAUNCHES != 1
            or probes["kv_write_paged"] != 2):
        raise AssertionError(f"[spec-f32] the example's scheduler did not probe its kernels at "
                             f"float32 ({probes}, {fd.PAGED_F32_LAUNCHES} on the f32 path)")
    log(f"[spec-f32] examples/speculative_deployment.json: float32 target {t_cfg.d_model} wide, "
        f"{t_cfg.n_heads} heads of {t_cfg.head_dim}, {t_cfg.n_layers} layers; draft "
        f"{d_cfg.d_model} wide, {d_cfg.n_heads} heads of {d_cfg.head_dim}, {d_cfg.n_layers} "
        f"layer(s); k={unit.k}; the scheduler probed flash_decode_paged at the f32 draft shape")
    rng = np.random.default_rng(SEED + 61)
    vocab, new = t_cfg.vocab, unit.max_new_tokens
    p1 = rng.integers(0, vocab, size=(1, SPEC_EX_P))
    p8 = rng.integers(0, vocab, size=(8, SPEC_EX_P))
    p4 = [rng.integers(0, vocab, size=(1, SPEC_EX_P)) for _ in range(4)]
    p32 = rng.integers(0, vocab, size=(GEN_B, SPEC_EX_P))
    server = ServerThread(engine)
    port = server.start()
    url = f"http://127.0.0.1:{port}/api/v0.1/predictions"
    twin = cpu_twin(torch, engine, doc)
    try:
        reset_counts(fa, fd, kw)
        fd.PAGED_F32_LAUNCHES = 0
        snap0 = g.snapshot()
        s1 = request("POST", url, ndarray(p1))
        s8 = request("POST", url, ndarray(p8))
        with ThreadPoolExecutor(4) as pool:
            s4 = list(pool.map(lambda p: request("POST", url, ndarray(p)), p4))
        launches = read_counts(fa, fd, kw)
        f32_launches = fd.PAGED_F32_LAUNCHES
        snap1 = g.snapshot()
        walls = []
        for _ in range(SPEC_EX_TURNS + 1):  # the first is the warm-up
            t = time.perf_counter()
            s32 = request("POST", url, ndarray(p32))
            walls.append(time.perf_counter() - t)
        walls = walls[1:]
    finally:
        server.stop()
    rounds = snap1["spec_rounds_total"] - snap0["spec_rounds_total"]
    ticks = snap1["prefill_dispatches_total"] - snap0["prefill_dispatches_total"]
    row_rounds = snap1["spec_row_rounds_total"] - snap0["spec_row_rounds_total"]
    accepted = snap1["spec_accepted_total"] - snap0["spec_accepted_total"]
    t_layers, d_layers = t_cfg.n_layers, d_cfg.n_layers
    want = {"flash_attention": 0, "flash_decode": 0, "kv_write": 0,
            "flash_decode_paged": d_layers * (unit.k + 1) * rounds,
            "kv_write_paged": t_layers * rounds + (t_layers + d_layers) * ticks}
    if launches != want or not rounds or f32_launches != want["flash_decode_paged"]:
        raise AssertionError(f"[spec-f32] launches {launches} ({f32_launches} on the f32 path), "
                             f"not {want}")
    log(f"[spec-f32] continuous lane over REST, a 1-row, an 8-row and 4 concurrent 1-row "
        f"{SPEC_EX_P}-token requests in {rounds} rounds ({row_rounds} row-rounds, {ticks} "
        f"prefill ticks): launches {launches} = {d_layers} x {unit.k + 1} x {rounds} "
        f"flash_decode_paged, every one on the float32 path ({f32_launches}), and {t_layers} x "
        f"{rounds} + ({t_layers} + {d_layers}) x {ticks} kv_write_paged; "
        f"{accepted / max(row_rounds, 1):.3f} of {unit.k} proposals accepted a row-round")
    sets = [(p1, s1), (p8, s8)] + list(zip(p4, s4)) + [(p32, s32)]
    served = [(p, check_tokens(*s, p, "ndarray", new, vocab)) for p, s in sets]
    target = engine.states()["gen"]["target"]
    gaps = {"tokens": 0, "gap_max": 0.0}
    same, ties = 0, 0
    for prompts, toks in served:
        gap, _ = teacher_forced(torch, lm_apply, target, t_cfg, prompts, toks, dev)
        gaps["tokens"] += gap.size
        gaps["gap_max"] = max(gaps["gap_max"], float(gap.max()))
        text, st = asyncio.run(twin.predict_json(json.dumps(ndarray(prompts))))
        cpu_toks = np.asarray(json.loads(text)["data"]["ndarray"], np.int64)
        if st != 200 or cpu_toks.shape != toks.shape:
            raise AssertionError(f"[spec-f32] the CPU engine answered {st}, {cpu_toks.shape}")
        same += int((cpu_toks == toks).sum())
        for r in np.nonzero((cpu_toks != toks).any(axis=1))[0]:
            # a row may part only at an f32 tie: where it first parts, the two
            # tokens' teacher-forced logits agree to well inside the delta
            j = int(np.argmax(cpu_toks[r] != toks[r]))
            seq = np.concatenate([prompts[r], toks[r, :j]])[None]
            with torch.inference_mode():
                row = lm_apply(target, torch.as_tensor(seq, dtype=torch.int32, device=dev),
                               t_cfg, use_flash=False)[0, -1]
            if abs(float(row[int(toks[r, j])] - row[int(cpu_toks[r, j])])) > 1e-4:
                raise AssertionError(f"[spec-f32] row {r} parts from the CPU engine's at token "
                                     f"{j} without a tie")
            ties += 1
    twin.close()
    if gaps["gap_max"] > F32_TOKEN_DELTA:
        raise AssertionError(f"[spec-f32] a token is {gaps['gap_max']:.3e} below the target's "
                             f"teacher-forced maximum (delta {F32_TOKEN_DELTA})")
    tok_s = GEN_B * new / float(np.median(walls))
    log(f"[spec-f32] {gaps['tokens']} served tokens teacher-forced through the target: max gap "
        f"{gaps['gap_max']:.3e} (delta {F32_TOKEN_DELTA}); {same} of {gaps['tokens']} equal to "
        f"the same engine's on the CPU ({ties} rows parted at an f32 tie)")
    log(f"[times] the speculative example's 32-row {SPEC_EX_P}-token request, {new} new tokens: "
        f"{'/'.join(f'{v:.3f}' for v in quartiles_ms(walls))} ms over {len(walls)} walls, "
        f"{tok_s:.1f} tokens/s on {smi}")
    times = paged_f32_times(torch, fd, dev, smi)
    log(f"[spec-f32] phase wall {time.perf_counter() - t_phase:.2f} s")
    return {"max_abs_err": f32_err, "launches": launches, "f32_launches": f32_launches,
            "rounds": rounds, "prefill_ticks": ticks, "mean_accepted": accepted / max(row_rounds, 1),
            "teacher_forced": gaps, "same_as_cpu": same, "cpu_ties": ties,
            "tokens_per_s": tok_s, "wall_quartiles_ms": quartiles_ms(walls), "times": times}


def eigh_share(torch, engine, x, calls: int = 5) -> dict:
    """The outlier's dispatch under torch.profiler: ``calls`` dispatches of
    ``x`` through the compiled graph, the host wall around them, and the
    share of it inside aten::linalg_eigh (its host time, which waits on
    cuSOLVER) and of the device time in the kernels launched under it."""
    from torch.profiler import ProfilerActivity, profile

    engine.compiled.predict_arrays(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(calls):
            engine.compiled.predict_arrays(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    ops = {e.key: e for e in prof.key_averages()}
    eigh = ops.get("aten::linalg_eigh") or ops.get("aten::_linalg_eigh")
    if eigh is None:
        raise AssertionError("[families] the profile shows no aten::linalg_eigh")
    dev_us = getattr(eigh, "device_time_total", None)
    if dev_us is None:
        dev_us = getattr(eigh, "cuda_time_total", 0.0)
    names, n_kernels, _ = trace_kernels(prof, "outlier")
    kernel_ms = sum(names.values())
    return {"calls": calls, "wall_ms": wall_ms, "eigh_host_ms": eigh.cpu_time_total / 1e3,
            "eigh_share_of_wall": eigh.cpu_time_total / 1e3 / wall_ms,
            "eigh_device_ms": dev_us / 1e3, "kernel_ms": kernel_ms, "kernels": n_kernels,
            "eigh_share_of_device": (dev_us / 1e3 / kernel_ms) if kernel_ms else None}


def family_phases(torch, dev, smi) -> dict:
    """10h. examples/iris, mean_transformer, gbm and outlier_pipeline over
    REST on the card: requests of 1, 3 and 8 rows held against the same
    engine on the CPU (the card's states carried over, the outlier's moving
    in step); outlier_pipeline (the outlier TRANSFORMER, then MNIST through
    fused_mlp_softmax) one fused-MLP launch a dispatch, then 8 concurrent
    requests each answered with its own rows' outlierScore tags; each
    example's 1-row p50 over one keepalive connection; the eigh share of
    the outlier's dispatch.  Returns its numbers and the fused-MLP
    launches of the outlier path."""
    from seldon_core_tpu_torch.ops import fused_mlp

    t_phase = time.perf_counter()
    out = {}
    for name, (width, scale, shift) in FAMILY_INPUTS.items():
        doc = example_doc(name)
        engine = mode_engine(torch, dev, doc, continuous=False)
        twin = cpu_twin(torch, engine, doc)
        rng = np.random.default_rng(SEED + width)
        xs = [rng.random((n, width)) * scale + shift for n in (1, 3, 8)]
        server = ServerThread(engine)
        port = server.start()
        url = f"http://127.0.0.1:{port}/api/v0.1/predictions"
        row = {}
        try:
            fused_mlp.LAUNCHES = 0
            errs = []
            for x in xs:
                st, raw = request("POST", url, ndarray(x))
                text, cst = asyncio.run(twin.predict_json(json.dumps(ndarray(x))))
                got, want = json.loads(raw), json.loads(text)
                if st != 200 or cst != 200 or got["data"].get("names") != want["data"].get("names"):
                    raise AssertionError(f"[families] {name}: HTTP {st}/{cst}, or other names")
                y, yw = np.asarray(got["data"]["ndarray"]), np.asarray(want["data"]["ndarray"])
                err = float(np.abs(y - yw).max())
                tol = MNIST_ATOL if name == "outlier_pipeline" else FAMILY_ATOL
                if y.shape != yw.shape or not np.isfinite(y).all() or err > tol:
                    raise AssertionError(f"[families] {name} {x.shape}: card vs CPU err {err:.3e} "
                                         f"(tolerance {tol})")
                errs.append(err)
                tags, wtags = got["meta"].get("tags", {}), want["meta"].get("tags", {})
                if set(tags) != set(wtags):
                    raise AssertionError(f"[families] {name}: tags {tags} vs {wtags}")
                if "outlierScore" in tags:
                    sc, wsc = np.asarray(tags["outlierScore"]), np.asarray(wtags["outlierScore"])
                    if sc.shape != (len(x),) or not np.allclose(sc, wsc, rtol=SCORE_RTOL,
                                                                 atol=1e-3):
                        raise AssertionError(f"[families] outlierScore {sc} vs the CPU's {wsc}")
            row["max_abs_err_vs_cpu"] = max(errs)
            if name == "outlier_pipeline":
                row["fused_mlp_launches"] = fused_mlp.LAUNCHES
                if fused_mlp.LAUNCHES != len(xs):
                    raise AssertionError(f"[families] {len(xs)} dispatches made "
                                         f"{fused_mlp.LAUNCHES} fused-MLP launches")
                sizes = [3, 4, 5, 6, 7, 8, 9, 10]
                n0 = float(engine.states()["outlier"]["n"])
                with ThreadPoolExecutor(len(sizes)) as pool:
                    answers = list(pool.map(lambda n: request(
                        "POST", url, ndarray(rng.random((n, width)))), sizes))
                for n, (st, raw) in zip(sizes, answers):
                    scores = json.loads(raw)["meta"]["tags"]["outlierScore"]
                    if st != 200 or len(scores) != n or not np.isfinite(scores).all():
                        raise AssertionError(f"[families] a concurrent {n}-row caller got "
                                             f"{len(scores)} scores (HTTP {st})")
                if float(engine.states()["outlier"]["n"]) != n0 + sum(sizes):
                    raise AssertionError("[families] the outlier's count missed rows")
                row["fused_mlp_launches"] = fused_mlp.LAUNCHES
                log(f"[families] outlier_pipeline: {len(sizes)} concurrent callers of 3..10 rows "
                    f"each answered with its own rows' outlierScore; the running count took "
                    f"every row; {fused_mlp.LAUNCHES} fused_mlp_softmax launches, one a dispatch")
            row["p50_ms"] = keepalive_p50_ms(port, ndarray(xs[0]), FAMILY_P50_REQUESTS)
        finally:
            server.stop(close_engine=False)
        if name == "outlier_pipeline":
            row["eigh"] = eigh_share(torch, engine, xs[2])
            e = row["eigh"]
            log(f"[times] outlier_pipeline's 8-row dispatch under torch.profiler, {e['calls']} "
                f"calls: {e['wall_ms'] / e['calls']:.3f} ms a call, aten::linalg_eigh "
                f"{e['eigh_host_ms'] / e['calls']:.3f} ms of it on the host "
                f"({e['eigh_share_of_wall'] * 100:.1f}%), its kernels {e['eigh_device_ms']:.3f} "
                f"of {e['kernel_ms']:.3f} device ms on {smi}")
        engine.close()
        twin.close()
        out[name] = row
        log(f"[families] {name} over REST: 1, 3 and 8 rows within {row['max_abs_err_vs_cpu']:.3e} "
            f"of the CPU engine; 1-row p50 {row['p50_ms']:.3f} ms over {FAMILY_P50_REQUESTS} "
            f"keepalive requests on {smi}")
    log(f"[families] phase wall {time.perf_counter() - t_phase:.2f} s")
    return out


def router_phase(torch, dev, smi) -> dict:
    """10i. examples/epsilon_greedy_deployment.json over REST: 12 requests of
    1-4 rows, each then a POST /api/v0.1/feedback of its response's
    meta.routing with a reward; the router's success / tries move on the
    routed branch only, as floor(reward * rows) and rows; the branches and
    answers equal the same engine's on the CPU (the same key: the port's
    draws are the same integers on both); the fused-MLP launches of each
    branch, one a request; the events stub answers 200."""
    from seldon_core_tpu_torch.messages import Feedback
    from seldon_core_tpu_torch.ops import fused_mlp

    t_phase = time.perf_counter()
    doc = example_doc("epsilon_greedy")
    engine = mode_engine(torch, dev, doc, continuous=False)
    if engine.batcher is not None or any(u.path != "kernel" for n, u in
                                         engine.compiled.units.items() if n != "eg-router"):
        raise AssertionError("[router] the router graph got a batcher, or an MNIST branch is "
                             "not on the kernel")
    twin = cpu_twin(torch, engine, doc)
    n = engine.compiled.units["eg-router"].n
    success, tries = np.zeros(n), np.zeros(n)
    per_branch = [0] * n
    rng = np.random.default_rng(SEED + 71)
    server = ServerThread(engine)
    port = server.start()
    base = f"http://127.0.0.1:{port}/api/v0.1"
    err = 0.0
    try:
        for i in range(12):
            x = rng.random((1 + i % 4, 784))
            before = fused_mlp.LAUNCHES
            st, raw = request("POST", f"{base}/predictions", ndarray(x))
            launched = fused_mlp.LAUNCHES - before
            text, cst = asyncio.run(twin.predict_json(json.dumps(ndarray(x))))
            resp, want = json.loads(raw), json.loads(text)
            branch = resp["meta"]["routing"]["eg-router"]
            if st != 200 or cst != 200 or want["meta"]["routing"] != resp["meta"]["routing"] \
                    or launched != 1:
                raise AssertionError(f"[router] request {i}: HTTP {st}/{cst}, routing "
                                     f"{resp['meta'].get('routing')} vs the CPU's "
                                     f"{want['meta'].get('routing')}, {launched} launches")
            err = max(err, float(np.abs(np.asarray(resp["data"]["ndarray"])
                                        - np.asarray(want["data"]["ndarray"])).max()))
            per_branch[branch] += launched
            reward = round(float(rng.random()), 3)
            fb = {"request": ndarray(x), "response": resp, "reward": reward}
            fst, fraw = request("POST", f"{base}/feedback", fb)
            asyncio.run(twin.send_feedback(Feedback.from_json(json.dumps(fb))))
            if fst != 200 or json.loads(fraw)["meta"]["puid"] != resp["meta"]["puid"]:
                raise AssertionError(f"[router] feedback {i}: HTTP {fst} {fraw[:200]!r}")
            success[branch] += np.floor(np.float32(reward) * np.float32(len(x)))
            tries[branch] += len(x)
        events = request("GET", f"{base}/events")
    finally:
        server.stop()
    state = engine.states()["eg-router"]
    got = (state["success"].cpu().numpy(), state["tries"].cpu().numpy())
    cpu_state = twin.states()["eg-router"]
    twin.close()
    if (not np.array_equal(got[0], success) or not np.array_equal(got[1], tries)
            or not torch.equal(cpu_state["success"], state["success"].cpu())):
        raise AssertionError(f"[router] success/tries {got} vs {success}/{tries} expected")
    if err > MNIST_ATOL or events != (200, b"Not Implemented") or min(per_branch) == 0:
        raise AssertionError(f"[router] answers err {err:.3e}, events {events}, launches by "
                             f"branch {per_branch}")
    log(f"[router] epsilon_greedy over REST: 12 requests then 12 feedbacks; routing equal to "
        f"the CPU engine's, answers within {err:.3e}; success {got[0].tolist()} and tries "
        f"{got[1].tolist()} moved on the routed branches only; fused_mlp_softmax launches by "
        f"branch {per_branch}; the events stub answers 200; phase wall "
        f"{time.perf_counter() - t_phase:.2f} s on {smi}")
    return {"success": got[0].tolist(), "tries": got[1].tolist(),
            "fused_mlp_launches_by_branch": per_branch, "max_abs_err_vs_cpu": err}


HOST_P50_REQUESTS = 100   # 1-row keepalive requests a turn; two turns a mode (ABBA): 200 each
HOST_ATOL = 1e-6          # host mode vs fused: m3's answer crosses JSON as float64 reprs of
#                           float32 values, which parse back to the same float32 values, so the
#                           bound is met with room (the run prints the difference it found)
HOST_BREAKER_TRIES = 12   # degraded requests allowed before the leaf's breaker must be open


def _seed3():
    from seldon_core_tpu_torch.graph.spec import Parameter

    return [Parameter.from_json_dict({"name": "seed", "value": "3", "type": "INT"})]


def _with_m3_remote(doc: dict, port: int) -> dict:
    doc = json.loads(json.dumps(doc))
    comps = doc["spec"]["predictors"][0]["components"]
    comps[[c["name"] for c in comps].index("m3")] = {
        "name": "m3", "runtime": "rest", "host": "127.0.0.1", "port": port}
    return doc


def _count_calls(obj, attr: str, counter: list) -> None:
    """Count the calls of ``obj.attr`` in ``counter[0]`` (an instance wrapper)."""
    orig = getattr(obj, attr)

    def counted(*a, **k):
        counter[0] += 1
        return orig(*a, **k)

    setattr(obj, attr, counted)


def _serve_rows(url: str, x1, x64, xs8) -> np.ndarray:
    """A 1-row ndarray, a 64-row tensor and 8 concurrent 1-row requests;
    their answers' rows in that order."""
    ys = [check_answer(*request("POST", url, ndarray(x1)), 1, "ndarray")]
    st, raw = request("POST", url, {"data": {"tensor": {"shape": list(x64.shape),
                                                        "values": x64.ravel().tolist()}}})
    ys.append(check_answer(st, raw, len(x64), "tensor"))
    with ThreadPoolExecutor(len(xs8)) as pool:
        for st, raw in pool.map(lambda x: request("POST", url, ndarray(x)), xs8):
            ys.append(check_answer(st, raw, 1, "ndarray"))
    return np.concatenate(ys)


def host_graph_phases(torch, dev, smi) -> dict:
    """10j. The host half of the graph runtime on the card.  The MNIST unit
    microservice: its entry point once as a subprocess with
    MICROSERVICE_SMOKE_EXIT (exit 0, on cuda), then served in this process
    (MnistClassifier, seed 3, on cuda, through the fused-MLP kernel) on a
    localhost port, so its launches show in fused_mlp.LAUNCHES.
    examples/ensemble4_deployment.json three ways with the same weights:
    as written (mode fused), with SELDON_TPU_GRAPH_FUSE=0 (compiled) and
    with m3 rebound to the microservice (host); each takes a 1-row, a
    64-row and 8 concurrent 1-row requests over REST: fused and compiled
    the same bits, host within HOST_ATOL of them, all within MNIST_ATOL of
    the CPU twin; 4 launches a dispatch in fused and compiled mode (the
    batcher may merge requests), 3 in the engine and 1 in the microservice
    a request in host mode.  The 1-row p50 over 200 keepalive requests of
    each mode and of the remote hop alone, in turns.  A COMBINER with quorum
    1 over MeanTransformer -> MnistClassifier (one FusedSubtreeRuntime)
    and the REST leaf: with the leaf up the answer is the pure
    interpreter's; with the microservice stopped every answer is 200 and
    tagged seldon.degraded.comb, the leaf's breaker opens and /ready and
    /stats show it; a ROUTER with fallback 1 over the dead leaf serves its
    branch 1.  examples/torch_model/torch_mnist_deployment.json (a plain
    user object, host mode) answers as its object's predict."""
    from seldon_core_tpu_torch.graph.defaulting import default_and_validate
    from seldon_core_tpu_torch.graph.fuse import FusedSubtreeRuntime
    from seldon_core_tpu_torch.graph.interpreter import to_device
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.ops import fused_mlp
    from seldon_core_tpu_torch.runtime.engine import EngineService
    from seldon_core_tpu_torch.runtime.microservice import build_runtime
    from seldon_core_tpu_torch.runtime.rest import serve_unit

    t_phase = time.perf_counter()
    out = {"launches": {}}
    # -- the microservice's entry point, once, as the image-build smoke runs it
    t0 = time.perf_counter()
    smoke = subprocess.run(
        [sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice", "MnistClassifier",
         "REST", "--parameters", json.dumps([p.to_json_dict() for p in _seed3()]),
         "--device", dev.type],
        cwd=ROOT, env={**os.environ, "MICROSERVICE_SMOKE_EXIT": "1"}, capture_output=True,
        text=True, timeout=300)
    if (smoke.returncode != 0
            or f"smoke ok: MnistClassifier as MODEL on {dev.type}" not in smoke.stdout):
        raise AssertionError(f"[host] microservice MICROSERVICE_SMOKE_EXIT run: exit "
                             f"{smoke.returncode}, {smoke.stdout[-300:]!r} {smoke.stderr[-800:]!r}")
    log(f"[host] python -m seldon_core_tpu_torch.runtime.microservice MnistClassifier REST with "
        f"MICROSERVICE_SMOKE_EXIT: exit 0, '{smoke.stdout.strip()}' "
        f"({time.perf_counter() - t0:.2f} s)")

    # -- the three modes of ensemble4, m3's weights in the microservice
    doc = example_doc("ensemble4")
    fused = mode_engine(torch, dev, doc, continuous=False)
    compiled = mode_engine(torch, dev, doc, continuous=False, env={"SELDON_TPU_GRAPH_FUSE": "0"})
    compiled.load_states(fused.states())
    unit_pool = ThreadPoolExecutor(1, thread_name_prefix="unit-dispatch")
    unit = build_runtime("MnistClassifier", "MODEL", _seed3(), unit_name="m3", device=dev,
                         executor=unit_pool)
    unit.state = to_device(fused.states()["m3"], dev)
    remote_calls = [0]
    _count_calls(unit.unit, "predict", remote_calls)
    unit_server = ServerThread(unit, serve=serve_unit)
    unit_port = unit_server.start()
    host = mode_engine(torch, dev, _with_m3_remote(doc, unit_port), continuous=False)
    host.load_states(fused.states())
    twin = cpu_twin(torch, fused, doc)
    engines = {"fused": fused, "compiled": compiled, "host": host}
    paths = [u.path for e in (fused, compiled) for u in e.compiled.units.values()
             if hasattr(u, "path")]
    paths += [host.executor.runtimes[f"m{i}"].unit.path for i in range(3)] + [unit.unit.path]
    if ([e.mode for e in engines.values()] != ["fused", "compiled", "host"]
            or set(paths) != {"kernel"} or unit.device.type != dev.type
            or sorted(host.breakers) != ["m3"]):
        raise AssertionError(f"[host] modes {[e.mode for e in engines.values()]}, unit paths "
                             f"{paths}, microservice on {unit.device}, breakers "
                             f"{sorted(host.breakers)}")
    servers = {mode: ServerThread(e) for mode, e in engines.items()}
    ports = {mode: srv.start() for mode, srv in servers.items()}
    rng = np.random.default_rng(SEED + 113)
    x1, x64 = rng.random((1, 784)), rng.random((64, 784))
    xs8 = [rng.random((1, 784)) for _ in range(8)]
    rows = np.concatenate([x1, x64] + xs8)
    answers, rules = {}, {}
    try:
        for mode, engine in engines.items():
            dispatches = [0]
            if engine.compiled is not None:
                _count_calls(engine.compiled, "predict_arrays", dispatches)
            remote_calls[0] = 0
            fused_mlp.LAUNCHES = 0
            answers[mode] = _serve_rows(f"http://127.0.0.1:{ports[mode]}/api/v0.1/predictions",
                                        x1, x64, xs8)
            n = fused_mlp.LAUNCHES
            if engine.compiled is not None:
                del engine.compiled.predict_arrays  # the class's method again
                ok = n == 4 * dispatches[0] and 3 <= dispatches[0] <= 10 and remote_calls[0] == 0
                rules[mode] = (f"{n} launches = 4 a dispatch x {dispatches[0]} dispatches of 10 "
                               f"requests (the batcher merges concurrent ones)")
            else:
                ok = remote_calls[0] == 10 and n == 3 * 10 + remote_calls[0]
                rules[mode] = (f"{n} launches = 3 a request in the engine x 10 + 1 a request in "
                               f"the microservice x {remote_calls[0]}")
            if not ok:
                raise AssertionError(f"[host] {mode}: {rules[mode]}")
            out["launches"][mode] = n
            log(f"[host] ensemble4 {mode}: 1-row, 64-row and 8 concurrent 1-row requests over "
                f"REST; {rules[mode]}")
        want = np.concatenate([np.asarray(json.loads(asyncio.run(twin.predict_json(json.dumps(
            ndarray(x))))[0])["data"]["ndarray"]) for x in (x1, x64, *xs8)])
        err_cpu = {m: float(np.abs(a - want).max()) for m, a in answers.items()}
        host_err = float(np.abs(answers["host"] - answers["fused"]).max())
        if (not np.array_equal(answers["fused"], answers["compiled"]) or host_err > HOST_ATOL
                or max(err_cpu.values()) > MNIST_ATOL or answers["fused"].shape != (len(rows), 10)):
            raise AssertionError(f"[host] fused vs compiled equal: "
                                 f"{np.array_equal(answers['fused'], answers['compiled'])}; host vs "
                                 f"fused {host_err:.3e} (bound {HOST_ATOL}); vs the CPU {err_cpu}")
        out.update(host_vs_fused_max_abs=host_err, max_abs_err_vs_cpu=err_cpu)
        log(f"[host] ensemble4: fused and compiled the same bits on all {len(rows)} rows; host "
            f"within {host_err:.3e} of them (bound {HOST_ATOL}: the remote leg's JSON float64 "
            f"reprs of float32 values parse back to the same float32); vs the plain CPU twin "
            f"{', '.join(f'{m} {e:.3e}' for m, e in err_cpu.items())} (tolerance {MNIST_ATOL})")

        # -- 1-row p50s in turns, and the remote hop alone
        walls = {m: [] for m in ("fused", "compiled", "host", "hop")}
        for mode in ("fused", "compiled", "host", "hop", "hop", "host", "compiled", "fused"):
            if mode == "hop":
                walls[mode] += keepalive_walls(unit_port, ndarray(x1), HOST_P50_REQUESTS,
                                               path="/predict")
            else:
                walls[mode] += keepalive_walls(ports[mode], ndarray(x1), HOST_P50_REQUESTS)
        p50 = {m: float(np.median(w)) * 1e3 for m, w in walls.items()}
        out.update(p50_ms=p50, quartiles_ms={m: quartiles_ms(w) for m, w in walls.items()},
                   hop_share_of_host=p50["hop"] / p50["host"])
        log(f"[times] ensemble4 1-row p50 over {2 * HOST_P50_REQUESTS} keepalive requests each, "
            f"in turns: fused {p50['fused']:.3f} ms, compiled {p50['compiled']:.3f} ms, host "
            f"{p50['host']:.3f} ms; the remote hop alone (POST /predict to the microservice) "
            f"{p50['hop']:.3f} ms, {100 * p50['hop'] / p50['host']:.1f}% of host's; on {smi}")
    finally:
        for srv in servers.values():
            srv.stop(close_engine=False)
        for e in (fused, compiled, host):
            e.close()
        twin.close()

    # -- partial fusion and degradation
    pf_doc = {"spec": {"name": "partial", "predictors": [{
        "name": "main",
        "components": [
            {"name": "norm", "runtime": "inprocess", "class_path": "MeanTransformer"},
            {"name": "mnist", "runtime": "inprocess", "class_path": "MnistClassifier",
             "parameters": [{"name": "seed", "value": "0", "type": "INT"}]},
            {"name": "leaf", "runtime": "rest", "host": "127.0.0.1", "port": unit_port}],
        "graph": {"name": "comb", "type": "COMBINER", "implementation": "AVERAGE_COMBINER",
                  "quorum": 1, "children": [
                      {"name": "norm", "type": "TRANSFORMER",
                       "children": [{"name": "mnist", "type": "MODEL"}]},
                      {"name": "leaf", "type": "MODEL"}]}}]}}
    partial = mode_engine(torch, dev, pf_doc, continuous=False)
    ref_doc = json.loads(json.dumps(pf_doc))
    ref_doc["spec"]["predictors"][0]["components"][2] = {
        "name": "leaf", "runtime": "inprocess", "class_path": "MnistClassifier",
        "parameters": [{"name": "seed", "value": "3", "type": "INT"}]}
    ref = EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(ref_doc)),
                        device=dev, force_host=True)
    ref.load_states({"mnist": partial.states()["mnist"], "leaf": unit.state})
    plan = partial.fusion_plan
    if (partial.mode != "host" or list(partial.executor.fused) != ["norm"]
            or not isinstance(partial.executor.fused["norm"], FusedSubtreeRuntime)
            or plan.hops_eliminated != 1 or ref.mode != "host" or ref.executor.fused):
        raise AssertionError(f"[host] partial fusion: mode {partial.mode}, fused "
                             f"{list(partial.executor.fused)}, plan {plan.summary()}")
    fb_doc = {"spec": {"name": "fallback", "predictors": [{
        "name": "main",
        "components": [
            {"name": "leaf", "runtime": "rest", "host": "127.0.0.1", "port": unit_port},
            {"name": "local", "runtime": "inprocess", "class_path": "MnistClassifier",
             "parameters": [{"name": "seed", "value": "3", "type": "INT"}]}],
        "graph": {"name": "r", "type": "ROUTER", "implementation": "SIMPLE_ROUTER",
                  "fallback": 1, "children": [{"name": "leaf", "type": "MODEL"},
                                              {"name": "local", "type": "MODEL"}]}}]}}
    fallback = mode_engine(torch, dev, fb_doc, continuous=False)
    fallback.load_states({"local": unit.state})
    srv_p, srv_f = ServerThread(partial), ServerThread(fallback)
    port_p, port_f = srv_p.start(), srv_f.start()
    url_p = f"http://127.0.0.1:{port_p}/api/v0.1/predictions"
    x4 = rng.random((4, 784))
    try:
        remote_calls[0] = 0
        fused_mlp.LAUNCHES = 0
        st, raw = request("POST", url_p, ndarray(x4))
        up = check_answer(st, raw, 4, "ndarray")
        n_up = fused_mlp.LAUNCHES
        text, cst = asyncio.run(ref.predict_json(json.dumps(ndarray(x4))))
        pf_err = float(np.abs(up - np.asarray(json.loads(text)["data"]["ndarray"])).max())
        if (cst != 200 or pf_err > HOST_ATOL or n_up != 2 or remote_calls[0] != 1
                or json.loads(raw)["meta"].get("tags")):
            raise AssertionError(f"[host] partial fusion up: vs the interpreter {pf_err:.3e}, "
                                 f"{n_up} launches, {remote_calls[0]} remote calls, tags "
                                 f"{json.loads(raw)['meta'].get('tags')}")
        log(f"[host] quorum-1 COMBINER over MeanTransformer -> MnistClassifier (one "
            f"FusedSubtreeRuntime, {plan.hops_eliminated} hop saved) and the REST leaf: within "
            f"{pf_err:.3e} of the pure interpreter; {n_up} launches, 1 fused subtree + 1 "
            f"microservice")
        unit_server.stop(close_engine=False)
        fused_mlp.LAUNCHES = 0
        degraded = 0
        while partial.open_breakers() != ["leaf"]:
            degraded += 1
            if degraded > HOST_BREAKER_TRIES:
                raise AssertionError(f"[host] the leaf's breaker did not open in "
                                     f"{HOST_BREAKER_TRIES} degraded requests: "
                                     f"{partial.stats()['resilience']['breakers']['leaf']}")
            st, raw = request("POST", url_p, ndarray(x4))
            check_answer(st, raw, 4, "ndarray")
            if json.loads(raw)["meta"].get("tags") != {"seldon.degraded.comb": ["leaf"]}:
                raise AssertionError(f"[host] degraded answer tags {json.loads(raw)['meta']}")
        n_down = fused_mlp.LAUNCHES
        ready = request("GET", f"http://127.0.0.1:{port_p}/ready")
        stats = json.loads(request("GET", f"http://127.0.0.1:{port_p}/stats")[1])
        leaf = stats["resilience"]["breakers"]["leaf"]
        if (ready != (200, b"ready (breakers open: leaf)") or leaf["state"] != "open"
                or n_down != degraded or stats["engine"]["mode"] != "host"):
            raise AssertionError(f"[host] after the stop: /ready {ready}, breaker {leaf}, "
                                 f"{n_down} launches in {degraded} requests")
        log(f"[host] microservice stopped: {degraded} requests answered 200 tagged "
            f"seldon.degraded.comb=['leaf'] until the breaker opened ({leaf['window_failures']} "
            f"of {leaf['window_calls']} calls failed in its window); /ready says "
            f"{ready[1].decode()!r}; {n_down} launches, the fused subtree's")
        fused_mlp.LAUNCHES = 0
        st, raw = request("POST", f"http://127.0.0.1:{port_f}/api/v0.1/predictions", ndarray(x4))
        y_fb = check_answer(st, raw, 4, "ndarray")
        meta = json.loads(raw)["meta"]
        n_fb = fused_mlp.LAUNCHES
        if (meta.get("routing") != {"r": 1} or meta["tags"].get("seldon.fallback.r") != 1
                or n_fb != 1 or "ConnectionRefusedError" not in meta["tags"].get(
                    "seldon.fallback.r.reason", "")):
            raise AssertionError(f"[host] fallback: {meta}, {n_fb} launches")
        # the local branch's own answer (a comparison launch, not counted)
        want_fb = fused_mlp.fused_mlp_softmax(unit.state, torch.as_tensor(
            x4, dtype=torch.float32, device=dev)).cpu().numpy()
        fb_err = float(np.abs(y_fb - want_fb).max())
        if fb_err > HOST_ATOL:
            raise AssertionError(f"[host] fallback answer vs its branch's unit {fb_err:.3e}")
        log(f"[host] ROUTER (SIMPLE_ROUTER, fallback 1) over the dead leaf: routing "
            f"{meta['routing']}, tag seldon.fallback.r=1 "
            f"({meta['tags']['seldon.fallback.r.reason']!r}); within {fb_err:.3e} of the "
            f"local branch's unit; {n_fb} launch, the local branch's")
        out["launches"]["partial fusion and degradation"] = n_up + n_down + n_fb
        out["degraded_requests_until_open"] = degraded
    finally:
        srv_p.stop(close_engine=False)
        srv_f.stop(close_engine=False)
        for e in (partial, fallback, ref):
            e.close()
        unit_pool.shutdown(wait=True)

    # -- a plain user object, host mode
    tm_doc = json.loads((ROOT / "examples" / "torch_model" /
                         "torch_mnist_deployment.json").read_text())
    tm = mode_engine(torch, dev, tm_doc, continuous=False)
    srv = ServerThread(tm)
    port = srv.start()
    x5 = rng.random((5, 784))
    url = f"http://127.0.0.1:{port}/api/v0.1/predictions"
    try:
        # twice: the object's first CPU matmul in a process rounds apart from
        # its later ones (a warm-up of torch's CPU kernels, not of the engine)
        first = check_answer(*request("POST", url, ndarray(x5)), 5, "ndarray")
        got = check_answer(*request("POST", url, ndarray(x5)), 5, "ndarray")
        own = tm.executor.runtimes["tm"].unit.user.predict(x5)
    finally:
        srv.stop()
    warm = float(np.abs(first - own).max())
    if tm.mode != "host" or not np.array_equal(got, own) or warm > HOST_ATOL:
        raise AssertionError(f"[host] torch_mnist: mode {tm.mode}, vs its object's predict "
                             f"{float(np.abs(got - own).max()):.3e} (the first answer {warm:.3e})")
    log(f"[host] examples/torch_model/torch_mnist_deployment.json (a plain TorchMnist object): "
        f"mode host, 5 rows the same bits as the object's own predict (the first, warm-up "
        f"answer within {warm:.3e})")
    out["card"] = smi
    log(f"[host] phase wall {time.perf_counter() - t_phase:.2f} s")
    return out


def copy_batch(rng, vocab: int):
    """bench.py:2105-2108: each row a random head repeated three times."""
    head = rng.integers(1, vocab, size=(TRAIN_B, TRAIN_HALF))
    return np.concatenate([head, head, head], axis=1)


def loss_and_grads(torch, lm_loss, params, batch, cfg, use_flash: bool):
    from seldon_core_tpu_torch.tree import leaves_with_paths, tree_map

    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = lm_loss(live, batch, cfg, use_flash=use_flash)
    leaves = leaves_with_paths(live)
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return float(loss.detach()), {k: g for (k, _), g in zip(leaves, grads)}


def training_phases(torch, dev, smi):
    """Phases 11-14: the backward kernels against their plain version, the
    flagship config trained 20 steps through them, its checkpoint served
    through weights_path, and their times.  Returns the dQ and dK/dV rows
    of the kernels line."""
    from seldon_core_tpu_torch.graph.defaulting import default_and_validate
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.models.generate import generate
    from seldon_core_tpu_torch.models.transformer import (
        LMConfig, lm_init, lm_loss, lm_train_step, load_lm_weights, resolve_train_flash,
        save_lm_weights)
    from seldon_core_tpu_torch.ops import flash_attention as fa, fused_mlp
    from seldon_core_tpu_torch.optim import adam
    from seldon_core_tpu_torch.runtime.engine import EngineService
    from seldon_core_tpu_torch.tree import leaves_with_paths

    bwd_errs = flash_bwd_phase(torch, fa, dev)

    # -- 12. train --------------------------------------------------------
    t_phase = time.perf_counter()
    dims = {k: v for k, v in GEN_DIMS.items() if k != "max_new_tokens"}
    cfg = LMConfig(**dims, dtype=torch.bfloat16)
    params = lm_init(torch.Generator().manual_seed(SEED), cfg, dev)
    if not resolve_train_flash(cfg, dev):  # asks both shape checks; probes both once
        raise AssertionError("training did not take the flash kernels at the flagship config")
    rng = np.random.default_rng(SEED)
    vocab = cfg.vocab

    def batch():
        return {"tokens": torch.as_tensor(copy_batch(rng, vocab), dtype=torch.int32, device=dev)}

    first = batch()
    loss_k, grads_k = loss_and_grads(torch, lm_loss, params, first, cfg, True)
    loss_p, grads_p = loss_and_grads(torch, lm_loss, params, first, cfg, False)
    rel = {k: float((grads_k[k].float() - grads_p[k].float()).norm()
                    / grads_p[k].float().norm()) for k in grads_p}
    worst_leaf = max(rel, key=rel.get)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"[train] one step at B={TRAIN_B}, S={first['tokens'].shape[1] - 1}: loss kernel path "
        f"{loss_k:.6f}, plain path {loss_p:.6f} (relative {loss_rel:.3e}, tolerance "
        f"{TRAIN_LOSS_RTOL}); gradients, relative L2 per leaf: max {rel[worst_leaf]:.3e} at "
        f"{worst_leaf}, median {float(np.median(list(rel.values()))):.3e} over {len(rel)} "
        f"leaves (tolerance {TRAIN_GRAD_REL_L2})")
    if (loss_rel > TRAIN_LOSS_RTOL or rel[worst_leaf] > TRAIN_GRAD_REL_L2
            or not all(bool(torch.isfinite(g.float()).all()) for g in grads_k.values())):
        raise AssertionError(f"kernel-path gradients differ from the plain path: {rel}")
    del grads_k, grads_p

    opt = adam(TRAIN_LR)
    opt_state = opt.init(params)
    losses, walls = [], []
    fa.LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
    fused_mlp.LAUNCHES = 0
    for _ in range(TRAIN_STEPS):
        b = batch()
        t = time.perf_counter()
        params, opt_state, loss = lm_train_step(params, opt_state, b, opt, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        losses.append(float(loss))
    launches = {"fwd": fa.LAUNCHES, "dq": fa.DQ_LAUNCHES, "dkv": fa.DKV_LAUNCHES,
                "fused_mlp": fused_mlp.LAUNCHES}
    want = cfg.n_layers * TRAIN_STEPS
    if launches != {"fwd": want, "dq": want, "dkv": want, "fused_mlp": 0}:
        raise AssertionError(f"{TRAIN_STEPS} train steps launched {launches}, not "
                             f"{cfg.n_layers} of each flash kernel per step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses {losses}")
    step_ms = float(np.median(walls) * 1e3)
    tokens = TRAIN_B * (first["tokens"].shape[1] - 1)
    log(f"[train] {TRAIN_STEPS} steps of adam({TRAIN_LR}): loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, all finite; launches {launches} = {cfg.n_layers} forward + "
        f"{cfg.n_layers} dQ + {cfg.n_layers} dK/dV per step")
    prof = device_profile(torch, lambda: lm_train_step(params, opt_state, first, opt, cfg),
                          "train_step")
    trained = {"step_wall_p50_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
               "losses": losses, "launches": launches, "profile": prof, "card": smi}
    log(f"[train] step wall p50 {step_ms:.3f} ms, {trained['tokens_per_s']:.1f} trained "
        f"tokens/s; profiled step: wall {prof['wall_ms']:.3f} ms, device kernels "
        f"{prof['kernel_ms']:.3f} ms in {prof['kernels']} launches, busy "
        f"{prof['busy_share'] * 100:.1f}% on {smi}")
    log(json.dumps({"training": trained}))
    log(f"[train] phase wall {time.perf_counter() - t_phase:.2f} s")

    # -- 13. hand-off -----------------------------------------------------
    t_phase = time.perf_counter()
    path = ROOT / "build" / "chip_smoke_trained_lm.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        save_lm_weights(params, str(path))
        back = load_lm_weights(lm_init(torch.Generator().manual_seed(SEED + 1), cfg, dev),
                               str(path))
        for (key, got), (_, want_t) in zip(leaves_with_paths(back), leaves_with_paths(params)):
            if got.dtype != torch.bfloat16 or not torch.equal(got, want_t):
                raise AssertionError(f"checkpoint round trip changed {key}")
        log(f"[hand-off] save_lm_weights -> load_lm_weights: {path.stat().st_size / 1e6:.1f} MB, "
            f"every bf16 leaf bit-identical")
        del back
        spec = default_and_validate(SeldonDeploymentSpec.from_json_dict(
            gen_deployment(weights_path=str(path))))
        engine = EngineService(spec, device=dev)
    finally:
        path.unlink(missing_ok=True)
    served_params = engine.states()["gen"]["params"]
    if not all(torch.equal(a, b) for (_, a), (_, b) in
               zip(leaves_with_paths(served_params), leaves_with_paths(params))):
        raise AssertionError("the generator's weights are not the trained weights")
    prompt = copy_batch(np.random.default_rng(SEED + 1), vocab)[:1, :GEN_S]
    server = ServerThread(engine)
    port = server.start()
    try:
        fa.LAUNCHES = 0
        st, raw = request("POST", f"http://127.0.0.1:{port}/api/v0.1/predictions",
                          {"data": {"ndarray": prompt.tolist()}})
        served_launches = fa.LAUNCHES
    finally:
        server.stop()
    served = check_tokens(st, raw, prompt, "ndarray")
    if served_launches != cfg.n_layers:
        raise AssertionError(f"the served prefill launched the flash kernel {served_launches} "
                             f"times, not {cfg.n_layers}")
    tok = torch.as_tensor(prompt, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        local = generate(params, tok, cfg, GEN_DIMS["max_new_tokens"], use_flash=True).cpu().numpy()
    if np.array_equal(served, local):
        held = "identical to an in-process generate on the trained params"
    else:
        from seldon_core_tpu_torch.models.transformer import lm_apply

        gap, _ = teacher_forced(torch, lm_apply, params, cfg, prompt, served, dev)
        if gap.max() > TOKEN_DELTA:
            raise AssertionError(f"served tokens differ from generate and a served token is "
                                 f"{gap.max():.4f} below the plain maximum")
        held = (f"not identical to generate ({int((served != local).sum())} tokens differ); "
                f"each within {gap.max():.5f} of the plain maximum (delta {TOKEN_DELTA})")
    log(f"[hand-off] a TransformerGenerator with weights_path, over REST: 1x{GEN_S} copy-task "
        f"prompt -> {served.shape[1]} tokens, {held}; {served_launches} flash launches")
    log(f"[hand-off] phase wall {time.perf_counter() - t_phase:.2f} s")
    del params, opt_state, served_params

    # -- 14. times --------------------------------------------------------
    t_phase = time.perf_counter()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator().manual_seed(SEED + 4)
    rows = {"dq": [], "dkv": []}
    for shape in FLASH_BWD_TIMED:
        q, k, v, o, lse, do = flash_bwd_inputs(torch, fa, shape, gen, dev)
        by_name = kernel_ms_by_name(
            torch, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, True), 20,
            expect=("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"))
        # the whole call: both launches and whatever the wrapper adds on the card
        call_ms = device_ms(torch, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, True), 20)
        g = shape[1] // shape[2]
        krep, vrep = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
        dsum = torch.sum(do.float() * o.float(), dim=-1)
        plain = {
            "dq": device_ms(torch, lambda: fa._dq_reference(q, krep, vrep, do, lse, dsum, True), 5),
            "dkv": device_ms(torch, lambda: fa._dkv_reference(q, krep, vrep, do, lse, dsum, True),
                             5),
        }
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        out = sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)
        lib_ms = device_ms(torch, lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                                              retain_graph=True), 20)
        for kern, tag in (("dq", "flash_bwd_dq_kernel"), ("dkv", "flash_bwd_dkv_kernel")):
            ms = sum(v for name, v in by_name.items() if tag in name)
            b_ms, b_by = flash_bwd_bound(shape, kern)
            rows[kern].append({"shape": list(shape), "ms": ms, "plain_ms": plain[kern],
                               "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                               "call_ms": call_ms})
            log(f"[times] {kern} (B,H,KV,S,D)={shape} causal: kernel {ms:.5f} ms, plain "
                f"{plain[kern]:.5f} ms, SDPA backward (dq, dk and dv) {lib_ms:.5f} ms, bound "
                f"{b_ms:.6f} ms ({b_by}) on {smi}")
        log(f"[times] flash_attention_bwd (B,H,KV,S,D)={shape} causal, the whole call (dQ "
            f"with dsum, then dK/dV): {call_ms:.5f} ms; SDPA backward {lib_ms:.5f} ms "
            f"({call_ms / lib_ms:.2f}x) on {smi}")
        del q, k, v, o, lse, do, krep, vrep, qs, ks, vs, out
    log(f"[times] phase wall {time.perf_counter() - t_phase:.2f} s")
    out_rows = []
    for kern, name, line, launches_k, computes in (
            ("dq", "flash_attention_bwd_dq", 208, launches["dq"],
             "dq, and dsum = rowsum(dO o) for the dK/dV kernel"),
            ("dkv", "flash_attention_bwd_dkv", 252, launches["dkv"],
             "dk and dv, the GQA group summed in f32")):
        top = rows[kern][0]
        out_rows.append({
            "name": name,
            "route": "cuda",
            "source": "seldon_core_tpu_torch/ops/csrc/flash_attention_bwd.cu",
            "replaces": f"seldon_core_tpu/ops/flash_attention.py:{line}",
            "launches": launches_k,
            "max_abs_err": bwd_errs[kern],
            "ms": top["ms"],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "computes": computes,
            "design": FLASH_BWD_DESIGN,
            "shape": "B=16 H=16 KV=4 S=512 D=64 causal bf16",
            "at": rows[kern],
        })
    return out_rows


def mnist_phases(torch, dev, smi) -> dict:
    """Phases 3-5 on examples/mnist_deployment.json; returns the fused-MLP
    row of the {"kernels": [...]} line."""
    from seldon_core_tpu_torch.graph.defaulting import default_and_validate
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.models.mnist import mlp_apply, mlp_init
    from seldon_core_tpu_torch.ops import fused_mlp
    from seldon_core_tpu_torch.runtime.engine import EngineService

    import mlp_turns  # the earlier design, in turns (beside this script)

    # -- 3. kernel vs plain --------------------------------------------------
    gen = torch.Generator().manual_seed(SEED)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    max_err = 0.0
    shapes = {}
    for hidden in (256, 512):
        params = random_params(torch, mlp_init, hidden, gen, dev)
        shapes[hidden] = params
        dims = (784, hidden, hidden, 10)
        row = torch.rand(1, 784, generator=gen).to(dev)
        first, clusters = None, set()
        for batch in (1, 7, 32, 64, 128, 1024):
            x = torch.rand(batch, 784, generator=gen).to(dev)
            x[0] = row[0]  # one row at the same place in every batch
            plan = fused_mlp.mlp_plan(batch, dims, sm_count)
            launched = torch.zeros(3, dtype=torch.int32, device=dev)
            before = fused_mlp.LAUNCHES
            got = fused_mlp._launch(fused_mlp._layer_params(params), dims, x, plan, launched)
            again = fused_mlp.fused_mlp_softmax(params, x)
            want = fused_mlp.fused_mlp_softmax_reference(params, x)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.isfinite(got).all() or err > KERNEL_ATOL:
                raise AssertionError(
                    f"kernel vs plain at 784-{hidden}-{hidden}-10 B={batch}: "
                    f"max abs err {err:.3e} > {KERNEL_ATOL}")
            if not torch.equal(got, again) or fused_mlp.LAUNCHES != before + 2:
                raise AssertionError(f"a repeat at 784-{hidden}-{hidden}-10 B={batch} gave "
                                     f"other bits, or the calls did not launch twice")
            BM, C = plan
            if launched.tolist() != [C, C * -(-batch // BM), BM]:
                raise AssertionError(f"B={batch}: the plan chose (BM, C) = {plan}, the kernel "
                                     f"ran (cluster, blocks, BM) = {launched.tolist()}")
            first = got[0] if first is None else first
            row_err = float((got[0] - first).abs().max())
            if row_err > KERNEL_ATOL or not torch.equal(got[0], first):
                raise AssertionError(f"the common row at B={batch} (plan {plan}) moved by "
                                     f"{row_err:.3e}: the plan changed its bits")
            clusters.add(C)
            max_err = max(max_err, err)
            log(f"[kernel] 784-{hidden}-{hidden}-10 B={batch:5d}: max abs err {err:.3e} "
                f"(tolerance {KERNEL_ATOL}); a repeat the same bits; plan BM={BM} C={C}, "
                f"launched clusters of {launched[0]} blocks, {launched[1]} blocks; the "
                f"common row the same bits as at B=1")
        if len(clusters) < 2 or fused_mlp.mlp_plan(1, dims, sm_count)[1] <= 1:
            raise AssertionError(f"the plans took clusters of {sorted(clusters)}: B=1 must "
                                 f"take more than one block, and the batches more than one C")

    # -- 4. serve ------------------------------------------------------------
    doc = json.loads((ROOT / "examples" / "mnist_deployment.json").read_text())
    spec = default_and_validate(SeldonDeploymentSpec.from_json_dict(doc))
    t0 = time.perf_counter()
    engine = EngineService(spec, device="cuda")
    log(f"[serve] engine built in {time.perf_counter() - t0:.3f} s; its unit "
        f"probed the kernel ({fused_mlp.LAUNCHES} launches so far, all before "
        f"the serve run)")
    unit = engine.compiled.units["mnist"]
    if unit.path != "kernel":
        raise AssertionError(f"the served unit took path {unit.path!r}, not the kernel")
    server = ServerThread(engine)
    port = server.start()
    url = f"http://127.0.0.1:{port}"
    rng = np.random.default_rng(SEED)
    x1 = rng.random((1, 784))
    x64 = rng.random((64, 784))
    xs32 = [rng.random((1, 784)) for _ in range(32)]
    try:
        fused_mlp.LAUNCHES = 0
        s1 = request("POST", f"{url}/api/v0.1/predictions", {"data": {"ndarray": x1.tolist()}})
        s64 = request("POST", f"{url}/api/v0.1/predictions",
                   {"data": {"tensor": {"shape": [64, 784], "values": x64.ravel().tolist()}}})
        with ThreadPoolExecutor(32) as pool:
            s32 = list(pool.map(
                lambda x: request("POST", f"{url}/api/v0.1/predictions",
                               {"data": {"ndarray": x.tolist()}}), xs32))
        body = json.dumps({"data": {"ndarray": x1.tolist()}})
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:  # one keepalive connection, as a load balancer or SDK holds
            http_walls = []
            for _ in range(SERVE_P50_REQUESTS):
                t = time.perf_counter()
                conn.request("POST", "/api/v0.1/predictions", body,
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                resp.read()
                http_walls.append(time.perf_counter() - t)
                if resp.status != 200:
                    raise AssertionError(f"latency loop: HTTP {resp.status}")
        finally:
            conn.close()
        launches = fused_mlp.LAUNCHES
        st_stats, raw_stats = request("GET", f"{url}/stats")
        # where the served request's time goes, layer by layer (these
        # calls launch the kernel too, after the count was read)
        engine_walls, dispatch_walls = [], []
        for _ in range(SERVE_P50_REQUESTS):
            t = time.perf_counter()
            text, st = asyncio.run_coroutine_threadsafe(
                engine.predict_json(body), server.loop).result(120)
            engine_walls.append(time.perf_counter() - t)
            if st != 200:
                raise AssertionError(f"in-process predict_json: {st}")
        for _ in range(SERVE_P50_REQUESTS):
            t = time.perf_counter()
            engine._batched_predict_sync(x1)
            dispatch_walls.append(time.perf_counter() - t)
    finally:
        server.stop()
    if launches <= 0:
        raise AssertionError("the serve phase launched the fused-MLP kernel 0 times")
    stats = json.loads(raw_stats)
    if st_stats != 200 or stats.get("device") != "cuda":
        raise AssertionError(f"/stats does not report device cuda: {raw_stats[:300]!r}")

    state = engine.states()["mnist"]

    def plain(x):
        return fused_mlp.fused_mlp_softmax_reference(
            state, torch.as_tensor(x, dtype=torch.float32, device=dev)).cpu().numpy()

    serve_err = 0.0
    for x, (st, raw), kind in ([(x1, s1, "ndarray"), (x64, s64, "tensor")]
                               + [(x, r, "ndarray") for x, r in zip(xs32, s32)]):
        y = check_answer(st, raw, len(x), kind)
        serve_err = max(serve_err, float(np.abs(y - plain(x)).max()))
    if serve_err > KERNEL_ATOL:
        raise AssertionError(f"served answers differ from the plain version by "
                             f"{serve_err:.3e} > {KERNEL_ATOL}")
    p50_ms = float(np.median(http_walls) * 1e3)
    log(f"[serve] 1-row ndarray, 64-row tensor, 32 concurrent 1-row and "
        f"{SERVE_P50_REQUESTS} sequential 1-row requests: all 200, wire kinds "
        f"kept, max abs err vs plain {serve_err:.3e} (tolerance {KERNEL_ATOL})")
    log(f"[serve] fused_mlp_softmax launches during the serve run: {launches} "
        f"(/stats reports {stats['kernels']['fused_mlp_softmax']['launches']}) "
        f"for {2 + len(xs32) + SERVE_P50_REQUESTS} requests")
    served = {
        "http_p50_ms": p50_ms,
        "engine_predict_json_p50_ms": float(np.median(engine_walls) * 1e3),
        "dispatch_p50_ms": float(np.median(dispatch_walls) * 1e3),
        "requests": SERVE_P50_REQUESTS,
        "card": smi,
    }
    log(f"[serve] 1-row request p50: HTTP keepalive {served['http_p50_ms']:.3f} ms; "
        f"engine.predict_json {served['engine_predict_json_p50_ms']:.3f} ms; "
        f"dispatch (graph + readback) {served['dispatch_p50_ms']:.3f} ms")
    log(json.dumps({"served": served}))

    # -- 5. times ------------------------------------------------------------
    params = shapes[256]
    dims = (784, 256, 256, 10)
    timings = {}
    for batch, iters in ((1, 500), (32, 500), (64, 500), (1024, 200)):
        x = torch.rand(batch, 784, generator=gen).to(dev)
        plan = fused_mlp.mlp_plan(batch, dims, sm_count)
        k_ms = device_ms(torch, lambda: fused_mlp.fused_mlp_softmax(params, x), iters)
        f_ms = device_ms(torch, lambda: fused_mlp._empty_launch(dims, batch, plan, dev), iters)
        p_ms = device_ms(torch, lambda: fused_mlp.fused_mlp_softmax_reference(params, x), iters)
        l_ms = device_ms(torch, lambda: torch.softmax(mlp_apply(params, x), dim=-1), iters)
        b_ms, b_by = mlp_bound(dims, batch)
        timings[batch] = {"B": batch, "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                          "bound_ms": b_ms, "bound_by": b_by, "floor_ms": f_ms,
                          "plan": {"BM": plan[0], "C": plan[1]}}
        log(f"[times] 784-256-256-10 B={batch}: kernel {k_ms:.5f} ms (BM={plan[0]}, a cluster "
            f"of {plan[1]}), an empty launch of that grid and cluster {f_ms:.5f} ms, plain "
            f"{p_ms:.5f} ms, library {l_ms:.5f} ms, bound {b_ms:.6f} ms ({b_by}) on {smi}")
    # B=1 with the weights cold in L2, as a request finds them after other
    # work: rotating over DECODE_COLD_BYTES of weight copies
    per_set = sum(t.numel() * t.element_size() for t in params.values())
    x = torch.rand(1, 784, generator=gen).to(dev)
    sets = [({k: v.clone() for k, v in params.items()}, x)
            for _ in range(-(-DECODE_COLD_BYTES // per_set))]
    cold_ms = device_ms(torch, rotating(sets, fused_mlp.fused_mlp_softmax), 2 * len(sets))
    timings[1]["cold_ms"] = cold_ms
    log(f"[times] 784-256-256-10 B=1, cold L2 ({len(sets)} weight sets, "
        f"{len(sets) * per_set / 2**20:.0f} MiB): kernel {cold_ms:.5f} ms on {smi}")
    del sets
    # the shape check asked once per widths (the wrapper's cache) against
    # asking the library at every call, as the wrapper did before
    cached_us = host_us_per_call(torch, lambda: fused_mlp.fused_mlp_softmax(params, x))
    asked_us = host_us_per_call(torch, lambda: (fused_mlp._smem_bytes(dims, 16, 8),
                                                fused_mlp.fused_mlp_softmax(params, x)))
    served["wrapper_host_us"] = {"shape_check_cached": cached_us,
                                 "shape_check_asked_each_call": asked_us}
    log(f"[times] fused_mlp_softmax wrapper host per B=1 call: {cached_us:.3f} us with the "
        f"shape check cached, {asked_us:.3f} us asking the library each call")
    source = mlp_turns.earlier_source()
    if source is None:
        log(f"[times] the earlier design ({mlp_turns.EARLIER_COMMIT}) is not run: its source "
            f"is not at {mlp_turns.EARLIER} and git cannot write it (see mlp_turns.py)")
        earlier = None
    else:
        earlier = mlp_turns.turns(torch, dev, smi, source, log=log)

    top = timings[1]
    row = {
        "name": "fused_mlp_softmax",
        "route": "cuda",
        "source": "seldon_core_tpu_torch/ops/csrc/fused_mlp.cu",
        "replaces": "seldon_core_tpu/ops/fused_mlp.py:44",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "floor_ms": top["floor_ms"],
        "design": MLP_DESIGN,
        "shape": "784-256-256-10",
        "at": [timings[b] for b in sorted(timings)],
        "earlier_design_turns": earlier,
        "served_p50_ms": p50_ms,
        "served": served,
    }
    return row


# ---------------------------------------------------------------------------
# [2q]: int8 weights (W8A16) and the int8 K/V cache (phases 10k-10m)
# ---------------------------------------------------------------------------

# The int8-K/V variants against their plain versions, bf16 o: FLASH_O_ATOL,
# for the bf16 kernels' reason (p, here p * v_s, rounds to bf16 at the
# kernel's running row max and at the plain version's final one; the sums
# run in another order).  The int8 path adds no rounding of its own to o:
# codes are exact in bf16, their products with bf16 q exact in f32, and the
# scales multiply f32 scores and p before p's one bf16 rounding on both
# sides.  The written codes and scales are held bit for bit.
# Two-tier shapes, (B, KV, G, hd, main slots, n_main, chunk slots, n_chunk),
# each call with the step's write fused in: the flagship layer after 1, 32
# and 63 chunk tokens; B=1 at 1, 17, 309 and 640 positions (clusters of 1,
# 1, 4 and 8 blocks; the flagship layer's is 1 under the int8 plan); the
# int8 example's layer (8 heads over 2 kv heads at d_model 128: hd 16,
# group 4); B=1 at 150 + 3 (a cluster of 2; n_main not a multiple of 4, so
# the tile across main's end and its scale runs are unaligned); hd 128 and
# 256 (other k-step counts; 4 warps at 256); group 1 and group 16 (the m16
# tile's rows 8-15)
I8_DECODE_SHAPES = [(32, 4, 4, 64, 512, 512, 63, 1), (32, 4, 4, 64, 512, 512, 63, 32),
                    (32, 4, 4, 64, 512, 512, 63, 63), (1, 4, 4, 64, 512, 0, 63, 1),
                    (1, 4, 4, 64, 512, 0, 63, 17), (1, 4, 4, 64, 512, 300, 63, 9),
                    (1, 4, 4, 64, 640, 640, 63, 0), (4, 2, 4, 16, 100, 100, 15, 9),
                    (1, 4, 4, 64, 512, 150, 63, 3), (4, 2, 4, 128, 256, 201, 31, 7),
                    (2, 4, 1, 256, 256, 130, 15, 5), (8, 8, 1, 64, 512, 333, 31, 11),
                    (2, 1, 16, 64, 512, 250, 31, 6)]
# the same positions with the chunk merged into main at two points, neither
# a multiple of 4, (B, KV, G, hd, n, (n_main, n_main')): the same bits
I8_MERGES = [(2, 4, 4, 64, 440, (403, 298)), (GEN_B, 4, 4, 64, 560, (512, 517))]
# the two-tier shape of check_sensitive: the flagship layer at n = 512 + 32
I8_DEFECTS_AT = I8_DECODE_SHAPES[1]
# paged shapes, (B, KV, G, hd, table blocks, lengths), each fused with the
# last row inactive: the served round (B=32 at 560 positions), the ragged
# batch (blocks also permuted), one row at 560, and the example's heads
# (also hd 128 and 256, group 1 and group 16)
I8_PAGED_SHAPES = [(GEN_B, 4, 4, 64, PAGED_NBLK, [560] * GEN_B),
                   (len(PAGED_RAGGED) + 1, 4, 4, 64, PAGED_NBLK, PAGED_RAGGED + [300]),
                   (2, 4, 4, 64, PAGED_NBLK, [560, 17]), (5, 2, 4, 16, 16, [1, 60, 200, 256, 9]),
                   (4, 2, 4, 128, 32, [1, 100, 333, 512]), (3, 2, 2, 256, 16, [17, 250, 256]),
                   (6, 8, 1, 64, 40, [1, 15, 16, 17, 600, 640]), (3, 1, 16, 64, 40, [64, 300, 640])]
# kv_write_paged's int8 variant, (KV, hd, W) into pools of 2,049 blocks: a
# prefill tick's B=32 rows of W=128 and 512; the example's heads; a verify's
# W=5, ragged widths around a 128-position run, hd 32 to 256 (lanes a row
# 4 to 32); kv_write.paged_write_inputs' starts, invalid row and
# out-of-pool entry
I8_KV_CASES = [(4, 64, 128), (4, 64, 512), (2, 16, 128), (4, 64, 5), (16, 64, 127),
               (2, 128, 130), (2, 256, 127), (8, 32, 130), (16, 256, 5)]
# the flagship generator with both quantizations stacked, as bench.py:533-535
# stacks them on bench.py:3342-3344's config
INT8_GEN = {"quant": "int8", "kv_quant": "int8"}
# the long-context arm of bench.py:547-560: B=32, 4096 prompt positions and
# 64 new tokens (the timed step reads 4096 + 64 positions)
LC_B, LC_S, LC_NEW = 32, 4096, 64
I8_TIMED_N = [560, LC_S + LC_NEW]
# dequant_matmul (W8A16) against the dense bf16 matmul: the flagship's
# decode-step products at B=32 (wqkv, wo, w1, w2) and one prefill product
DEQUANT_SHAPES = [(32, 1024, 1536), (32, 1024, 1024), (32, 1024, 4096), (32, 4096, 1024),
                  (16384, 1024, 4096)]
# The served int8 generator against its lane's plain int8 path (the same
# quantized weights; on the static lane a prefill over exact K/V stored
# quantized, then the plain two-tier decode over the codes; on the
# continuous lane one plain paged forward whose every position is written
# quantized, then attended; every served token fed back).
# Every rounding of the bf16 comparison (TOKEN_DELTA: 4 ulps of a logit in
# [4, 8)) is there, and one more: the K/V rows that the two paths quantize
# differ by those roundings, so a value at a rounding boundary takes the
# neighbouring code on one side, moving that element by one step, 1/127 of
# its row's absmax (~2 bf16 ulps of the row's largest element).  Twice the
# bf16 margin: 8 ulps.
INT8_TOKEN_DELTA = 0.25
# the example's card tokens against its CPU twin's (the same engine and
# states on the CPU, bf16 on another backend): a row may part only where the
# card's plain int8 logits of the two tokens differ by at most 8 bf16 ulps
# of the row's largest logit
EXAMPLE_TIE_ULPS = 8
I8_TURNS = 1               # ABBA turns of the long-context rate (2 walls each)
# the int8 kernels' inputs: caches of N(0, 1) bf16 rows quantized as the
# served path quantizes them (kv_write.int8_kv_rows), q at twice their
# spread (scores of std ~2: each row's softmax is held by a handful of
# positions, so the cache walk carries o and |o| ~ 1), the fresh key at
# twice (it holds a few rows of each call)
I8_Q_SPREAD = 2.0
I8_FRESH_K_SPREAD = 2.0
# a defect the kernel check must see (a 16-position tile dropped, k_s read
# one position off) moves the plain o by at least this many tolerances
I8_DEFECT_MARGIN = 4
I8_WALK = ("int8_walk.cuh's tile walk: each warp every 8th (4th at hd 256) tile of 16 "
           "positions through its own ring of 2-4 stages filled by its lanes' cp.async "
           "(16-byte chunks into a swizzled stage, the tile's k_s and v_s on the same stage "
           "and mbarrier); both products mma.sync m16n8k16, q's k order and V's n order "
           "permuted so a lane's K codes of a position are one 16-byte load and its V codes "
           "one 8-byte load, conflict-free; codes to bf16 by two LOP3s and a bf16x2 add a pair "
           "(no I2F or LDS.U8 in the walk, no F2FP but P's); k_s on the S fragment, v_s on p "
           "before its bf16 rounding; the fresh row quantized once by a warp reduction and "
           "attended as codes: one launch")
I8_DECODE_DESIGN = (I8_WALK + "; the split a cluster of 1-8 blocks with shares a multiple of "
                    "16 positions, doubled for long rows while two blocks an SM hold the grid "
                    "(i8_split_plan), a tile across main's end taking rows of both segments; "
                    "warps then ranks combined through DSMEM")
I8_PAGED_DESIGN = (I8_WALK + "; the bf16 path's share rule by each row's length and DSMEM "
                   "combine, the cluster doubled for long tables (i8_paged_cluster)")
I8_KV_DESIGN = ("kv_write_paged_plan's geometry (KV_WRITE_PLAN) with a row's hd/8 lanes one "
                "aligned group of a warp: 8 values of K and of V a lane, both loads in flight "
                "before the interleaved absmax shuffles, each value divided once (IEEE) and "
                "rounded to its code while the lookup is in flight, the group's first lane "
                "writing both scales; int8 rows with their scales copied")


def i8_bound(B, KV, G, hd, n_sum, fused: bool, extra: int = 0):
    """Least time for one int8-K/V decode call: K and V codes (1 byte a
    value) and their two f32 scales of every position read once, q read
    and o written once in bf16 (with the fused write also the fresh bf16
    rows read and their codes and scales written), ``extra`` bytes more
    (tables and lengths), over HBM bandwidth, against the score and PV
    FLOPs over the bf16 peak; the larger one bounds."""
    nbytes = KV * n_sum * (2 * hd + 8) + 2 * 2 * B * KV * G * hd + extra
    if fused:
        nbytes += B * KV * (2 * 2 * hd + 2 * (hd + 4))
    flops = 4 * KV * G * n_sum * hd
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def fresh_rows(torch, B, KV, hd, gen, dev):
    """A decode step's fresh k, v [B, KV, 1, hd] bf16, strided head views:
    k at I8_FRESH_K_SPREAD times the cache's spread (it holds most of the
    softmax in a few rows of each call), v N(0, 1) with a spike of 32 at
    column 0, so its scale is 32/127 and the other values round to
    multiples of ~0.25: attending the exact row instead of its codes moves
    o past FLASH_O_ATOL in those rows."""
    k, v = head_views(torch, B, 1, KV, hd, gen, dev)
    k = (I8_FRESH_K_SPREAD * k.float()).to(torch.bfloat16)
    v[..., 0] = 32.0
    return k, v


def i8_query(torch, B, KV, G, hd, gen, dev):
    """q [B, KV, G, hd] bf16 at I8_Q_SPREAD times the cache's spread."""
    return (I8_Q_SPREAD * torch.randn(B, KV, G, hd, generator=gen)).to(torch.bfloat16).to(dev)


def o_errs(got, want) -> tuple:
    """(max |got - want|, max |got - want| / max(1, |want|)).  The second is
    the one held to FLASH_O_ATOL, 2 bf16 ulps at |o| ~ 1: a bf16 o's
    rounding grows with |o|, and the fresh value's spike makes o's column 0
    reach ~30 in the rows it holds."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    return float(d.max()), float((d / w.abs().clamp_min(1.0)).max())


def check_sensitive(name: str, want, defects: dict) -> dict:
    """Fails unless each defect (the plain version's o with it) misses
    FLASH_O_ATOL by I8_DEFECT_MARGIN or more against ``want``, so the
    kernel check above it can see such a defect; returns their errors."""
    seen = {what: o_errs(o, want)[1] for what, o in defects.items()}
    for what, err in seen.items():
        if err < I8_DEFECT_MARGIN * FLASH_O_ATOL:
            raise AssertionError(f"[int8-kernels] {name}: {what} moves the plain o by only "
                                 f"{err:.3e}; the check at {FLASH_O_ATOL} could not see it")
    log(f"[int8-kernels] {name}: the plain version with "
        + ", ".join(f"{what} misses by {err:.3e}" for what, err in seen.items())
        + f" (each at least {I8_DEFECT_MARGIN}x the tolerance)")
    return seen


def i8_kv_checks(torch, kw, dev, gen) -> None:
    """kv_write_paged's int8 variant bit-exact and in place at I8_KV_CASES,
    quantizing bf16 head views and copying int8 rows with their scales
    (kv_write.paged_write_inputs, the CPU generator ``gen``), each plan in
    C equal to Python's; raises otherwise."""
    for KV, hd, W in I8_KV_CASES:
        for copy in (False, True):
            x = kw.paged_write_inputs(32, KV, W, hd, PAGED_NBLK, gen, dev, bs=PAGED_BS,
                                      int8=True, copy=copy)
            plan = check_write_plan(kw, 32, KV, W, kw.paged_write_lanes(*x.pools, x.k, x.v))
            want = kw.paged_write_expected(x)
            pools = x.pools + x.planes
            ptrs, before = [t.data_ptr() for t in pools], kw.PAGED_I8_LAUNCHES
            kw.kv_write_paged(*x.pools, x.k, x.v, x.tables, x.start, x.valid, tuple(x.planes),
                              x.k_s, x.v_s)
            torch.cuda.synchronize()
            if (kw.PAGED_I8_LAUNCHES != before + 1 or [t.data_ptr() for t in pools] != ptrs
                    or not all(torch.equal(a[1:], b[1:x.N]) for a, b in zip(pools, want))):
                raise AssertionError(f"[int8-kernels] kv_write_paged int8 at KV={KV} hd={hd} "
                                     f"W={W} ({'copy' if copy else 'quantize'}) is not the plain "
                                     f"scatter")
            log(f"[int8-kernels] kv_write_paged int8 into pools ({x.N},{KV},{PAGED_BS},{hd}) "
                f"with their scale planes through [32,{PAGED_NBLK}] tables, W={W}, "
                f"{'int8 rows with their scales copied' if copy else 'bf16 head views quantized'}"
                f" (plan {plan}): codes and scales bit-exact outside the scratch block (an "
                f"out-of-pool entry dropped, a row all invalid), in place")


def int8_kernel_phase(torch, fd, kw, dev) -> dict:
    """10k. Each int8-K/V variant against its plain version on the same
    inputs, a second call the same bits: flash_decode_two_tier at
    I8_DECODE_SHAPES and flash_decode_paged at I8_PAGED_SHAPES, each with
    the step's write fused in (the written codes and scales bit for bit
    against the plain quantizer, o within FLASH_O_ATOL of max(1, |o|), the
    paged pools outside the scratch block 0), the ragged paged batch also
    with its blocks permuted, the two-tier variant the same bits with main
    ending at two points (I8_MERGES); at the flagship's shapes the plain version
    with a tile dropped or k_s one position off must miss that tolerance
    (check_sensitive); kv_write_paged's int8 variant bit-exact at
    I8_KV_CASES, quantizing bf16 rows and copying int8 ones.  Returns each
    variant's largest error, absolute ("abs") and relative to max(1, |o|)
    ("rel"), and the defects' errors."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 141)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    errs = {name: {"abs": 0.0, "rel": 0.0}
            for name in ("flash_decode", "flash_decode_paged", "kv_write_paged")}
    defects = {}
    clusters = set()
    for shape in I8_DECODE_SHAPES:
        B, KV, G, hd, Lm, n_main, C, n_chunk = shape
        q = i8_query(torch, B, KV, G, hd, gen, dev)
        (mk, mks), (mv, mvs) = (kw.int8_kv_rows((B, KV, Lm, hd), gen, dev) for _ in range(2))
        (ck, cks), (cv, cvs) = (kw.int8_kv_rows((B, KV, C, hd), gen, dev) for _ in range(2))
        # the fresh row's absmax far from the rest: attended as the
        # reference writes and reads it (codes times its scale), not exact
        k, v = fresh_rows(torch, B, KV, hd, gen, dev)
        caches = [mk, mv, mks, mvs, ck, cv, cks, cvs]
        ref = [t.clone() for t in caches]

        def plain(main, n_m):
            # on copies (the plain write into them is the one already in ref)
            c = [t.clone() for t in (*main, *ref[4:])]
            return fd.flash_decode_two_tier_reference(q, c[0], c[1], n_m, c[4], c[5], n_chunk,
                                                      k, v, (c[2], c[3], c[6], c[7]))

        want = fd.flash_decode_two_tier_reference(q, ref[0], ref[1], n_main, ref[4], ref[5],
                                                  n_chunk, k, v, (ref[2], ref[3], ref[6], ref[7]))
        before = (fd.LAUNCHES, fd.I8_LAUNCHES)
        got = fd.flash_decode_two_tier(q, mk, mv, n_main, ck, cv, n_chunk, k, v,
                                       (mks, mvs, cks, cvs))
        again = fd.flash_decode_two_tier(q, mk, mv, n_main, ck, cv, n_chunk, k, v,
                                         (mks, mvs, cks, cvs))
        torch.cuda.synchronize()
        abs_err, err = o_errs(got, want)
        if ((fd.LAUNCHES - before[0], fd.I8_LAUNCHES - before[1]) != (2, 2) or err > FLASH_O_ATOL
                or not bool(torch.isfinite(got.float()).all())):
            raise AssertionError(f"[int8-kernels] flash_decode_two_tier int8 at {shape}: o err "
                                 f"{err:.3e}, launches {fd.LAUNCHES - before[0]}")
        if not all(torch.equal(a, b) for a, b in zip(caches, ref)):
            raise AssertionError(f"[int8-kernels] the int8 fused write at {shape} wrote other "
                                 f"codes or scales than the plain quantizer")
        if not torch.equal(got, again):
            raise AssertionError(f"[int8-kernels] flash_decode_two_tier int8 at {shape} differs "
                                 f"between two calls")
        split, span = fd.i8_split_plan(B, KV, G, n_main + n_chunk, sm_count)
        clusters.add(split)
        errs["flash_decode"] = {"abs": max(errs["flash_decode"]["abs"], abs_err),
                                "rel": max(errs["flash_decode"]["rel"], err)}
        log(f"[int8-kernels] flash_decode_two_tier int8 (B,KV,G,hd,main,n_main,chunk,n_chunk)="
            f"{shape}, a cluster of {split}, the fresh row (absmax far from its other values) "
            f"quantized in: codes and scales bit-exact, o max err {err:.3e} relative to "
            f"max(1, |o|) (tolerance {FLASH_O_ATOL}; {abs_err:.3e} absolute, |o| up to "
            f"{float(want.float().abs().max()):.3g}), a repeat the same bits")
        if shape == I8_DEFECTS_AT:
            def drop(t):  # positions 32-47 of main
                return torch.cat([t[:, :, :32], t[:, :, 48:]], dim=2)

            defects["flash_decode"] = check_sensitive(
                f"flash_decode_two_tier int8 at {shape}", want,
                {"a 16-position tile dropped": plain([drop(t) for t in ref[:4]], n_main - 16),
                 "k_s read one position off": plain(
                     [*ref[:2], torch.roll(ref[2], -1, dims=2), ref[3]], n_main)})
    if clusters != {1, 2, 4, 8}:
        raise AssertionError(f"[int8-kernels] I8_DECODE_SHAPES planned clusters of "
                             f"{sorted(clusters)}, not 1, 2, 4 and 8")
    for B, KV, G, hd, n, n_mains in I8_MERGES:
        # one stream's positions: main[:n_main] ++ chunk[:n - n_main] at two
        # merge points (the slots past them hold other codes)
        q = i8_query(torch, B, KV, G, hd, gen, dev)
        (gk, gks), (gv, gvs) = (kw.int8_kv_rows((B, KV, n, hd), gen, dev) for _ in range(2))
        k, v = fresh_rows(torch, B, KV, hd, gen, dev)
        outs, written = [], []
        for n_main in n_mains:
            segs = []
            for t in (gk, gv, gks, gvs):
                main, chunk = t.clone(), t.clone().roll(1, dims=2)
                main[:, :, n_main:] = t.roll(7, dims=2)[:, :, n_main:]
                chunk[:, :, :n - n_main] = t[:, :, n_main:]
                segs.append((main, chunk))
            (mk, ck), (mv, cv), (mks, cks), (mvs, cvs) = segs
            outs.append(fd.flash_decode_two_tier(q, mk, mv, n_main, ck, cv, n - n_main, k, v,
                                                 (mks, mvs, cks, cvs)))
            written.append([t[:, :, n - n_main - 1] for t in (ck, cv, cks, cvs)])
        torch.cuda.synchronize()
        want = fd.flash_decode_two_tier_reference(q, gk.clone(), gv.clone(), n, gk[:, :, :0],
                                                  gv[:, :, :0], 0, k, v,
                                                  (gks.clone(), gvs.clone(), gks[:, :, :0],
                                                   gvs[:, :, :0]))
        err = o_errs(outs[0], want)[1]
        if (not torch.equal(outs[0], outs[1]) or err > FLASH_O_ATOL
                or not all(torch.equal(a, b) for a, b in zip(*written))):
            raise AssertionError(f"[int8-kernels] flash_decode_two_tier int8, (B,KV,G,hd)="
                                 f"{(B, KV, G, hd)}, n={n}: main ending at {n_mains} gave other "
                                 f"bits or writes (o err {err:.3e})")
        log(f"[int8-kernels] flash_decode_two_tier int8 (B,KV,G,hd)={(B, KV, G, hd)}, n={n} with "
            f"main ending at {n_mains[0]} and at {n_mains[1]}: the same bits and the same "
            f"written codes and scales, o max err {err:.3e} of max(1, |o|) against the plain "
            f"version over one segment")
    for case in I8_PAGED_SHAPES:
        B, KV, G, hd, nblk, lens = case
        N = B * nblk + 1
        q = i8_query(torch, B, KV, G, hd, gen, dev)
        (pk, pks), (pv, pvs) = (kw.int8_kv_rows((N, KV, PAGED_BS, hd), gen, dev)
                                for _ in range(2))
        tables = (torch.randperm(N - 1, generator=gen)[: B * nblk] + 1).reshape(B, nblk)
        tables = tables.to(torch.int32).to(dev)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        valid = (torch.arange(B) < B - 1).to(dev)
        k, v = fresh_rows(torch, B, KV, hd, gen, dev)
        moved = permuted_pool(torch, pk, pv, tables, gen, dev)
        perm_tables = moved[2]
        mks, mvs = pks.clone(), pvs.clone()
        perm = torch.empty(N, dtype=torch.long, device=dev)
        perm[0] = 0
        # moved[0][perm[j]] = pk[j]: recover the permutation from the tables
        perm[tables.long().flatten()] = perm_tables.long().flatten()
        mks[perm[1:]], mvs[perm[1:]] = pks[1:], pvs[1:]
        pools = [pk, pv, pks, pvs]
        ref = [t.clone() for t in pools]

        def plain(planes, tb, ln):
            c = [t.clone() for t in (*ref[:2], *planes)]
            return fd.flash_decode_paged_reference(q, c[0], c[1], tb, ln, k, v, valid,
                                                   (c[2], c[3]))

        want = fd.flash_decode_paged_reference(q, ref[0], ref[1], tables, lens_t, k, v, valid,
                                               (ref[2], ref[3]))
        before = (fd.PAGED_LAUNCHES, fd.PAGED_I8_LAUNCHES)
        got = fd.flash_decode_paged(q, pk, pv, tables, lens_t, k, v, valid, (pks, pvs))
        again = fd.flash_decode_paged(q, pk, pv, tables, lens_t, k, v, valid, (pks, pvs))
        got_moved = fd.flash_decode_paged(q, moved[0], moved[1], perm_tables, lens_t, k, v,
                                          valid, (mks, mvs))
        torch.cuda.synchronize()
        act = valid.cpu().nonzero()[:, 0].to(dev)
        abs_err, err = o_errs(got[act], want[act])
        if ((fd.PAGED_LAUNCHES - before[0], fd.PAGED_I8_LAUNCHES - before[1]) != (3, 3)
                or err > FLASH_O_ATOL or not bool(torch.isfinite(got[act].float()).all())):
            raise AssertionError(f"[int8-kernels] flash_decode_paged int8 at {case[:5]}: o err "
                                 f"{err:.3e}, launches {fd.PAGED_LAUNCHES - before[0]}")
        if not all(torch.equal(a[1:], b[1:]) for a, b in zip(pools, ref)):
            raise AssertionError(f"[int8-kernels] the paged int8 fused write at {case[:5]} left "
                                 f"other codes or scale planes than the plain quantizer outside "
                                 f"block 0")
        if not torch.equal(got, again) or not torch.equal(got[act], got_moved[act]):
            raise AssertionError(f"[int8-kernels] flash_decode_paged int8 at {case[:5]}: a repeat "
                                 f"or the blocks permuted gave other bits")
        errs["flash_decode_paged"] = {"abs": max(errs["flash_decode_paged"]["abs"], abs_err),
                                      "rel": max(errs["flash_decode_paged"]["rel"], err)}
        log(f"[int8-kernels] flash_decode_paged int8 (B,KV,G,hd)={(B, KV, G, hd)} over "
            f"{nblk} blocks of {PAGED_BS}, lengths {min(lens)}..{max(lens)}, the last row "
            f"inactive, the fresh rows quantized in: pools and scale planes bit-exact outside "
            f"block 0, o max err {err:.3e} relative to max(1, |o|) on the active rows "
            f"(tolerance {FLASH_O_ATOL}; {abs_err:.3e} absolute, |o| up to "
            f"{float(want[act].float().abs().max()):.3g}); a repeat and the blocks permuted the "
            f"same bits")
        if case == I8_PAGED_SHAPES[0]:  # the served round, B=32 at n=560
            # the third table column (positions 32-47) left out of every row
            short = torch.cat([tables[:, :2], tables[:, 3:]], dim=1)
            found = check_sensitive(
                f"flash_decode_paged int8 at {case[:4]}, n={lens[0]}", want[act],
                {"a 16-position tile dropped": plain(ref[2:], short, lens_t - 16)[act],
                 "k_s read one position off": plain(
                     [torch.roll(ref[2], -1, dims=2), ref[3]], tables, lens_t)[act]})
            defects["flash_decode_paged"] = found
    i8_kv_checks(torch, kw, dev, gen)
    log(f"[int8-kernels] phase wall {time.perf_counter() - t0:.2f} s")
    return {"errs": errs, "defects": defects}


def plain_int8_logits(torch, params, cfg, prompts: np.ndarray, toks: np.ndarray, dev):
    """The plain int8 path's logits [B, n, V] f32 at each served token's
    position: the prompt's prefill (exact K/V attended, stored quantized),
    then one plain two-tier step a token over the codes, each fed the
    served token before it (use_flash off: no kernel)."""
    from seldon_core_tpu_torch.models.generate import (decode_step_two_tier, init_cache,
                                                       init_chunk, prefill)

    B, S = prompts.shape
    n = toks.shape[1]
    with torch.inference_mode():
        p = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
        logits, main = prefill(params, p, init_cache(cfg, B, S, dev), cfg, use_flash=False)
        chunk = init_chunk(cfg, B, max(n - 1, 1), dev)
        rows = [logits]
        for i in range(n - 1):
            tok = torch.as_tensor(toks[:, i], dtype=torch.int32, device=dev)
            logits, chunk = decode_step_two_tier(params, tok, main, chunk, S, i, cfg,
                                                 use_flash=False)
            rows.append(logits)
        return torch.stack(rows, dim=1)


def plain_paged_int8_logits(torch, params, cfg, prompts: np.ndarray, toks: np.ndarray, dev):
    """The continuous lane's plain int8 path, teacher-forced: one
    paged_forward of prompt + served tokens over fresh int8 pools (use_flash
    off), every position's K/V written quantized and then attended, as the
    lane's prefill ticks and decode steps do (so how the lane chunked its
    prefill does not matter); logits [B, n, V] f32 at each served token."""
    from seldon_core_tpu_torch.models.generate import init_block_pool, paged_forward

    B, S = prompts.shape
    n = toks.shape[1]
    W = S + n - 1
    nblk = -(-W // PAGED_BS)
    with torch.inference_mode():
        seq = torch.as_tensor(np.concatenate([prompts, toks[:, :-1]], axis=1), dtype=torch.int32,
                              device=dev)
        pool = init_block_pool(cfg, B * nblk + 1, PAGED_BS, dev)
        tables = (torch.arange(B * nblk, device=dev) + 1).reshape(B, nblk).to(torch.int32)
        start = torch.zeros(B, dtype=torch.int32, device=dev)
        width = torch.full((B,), W, dtype=torch.int32, device=dev)
        logits, _ = paged_forward(params, seq, pool, tables, start, width, cfg, last_only=False,
                                  use_flash=False)
        return logits[:, S - 1:S - 1 + n]


def plain_int8_gaps(torch, params, cfg, prompts, toks, dev, continuous: bool) -> np.ndarray:
    """Each served token's gap to the maximum logit of its lane's plain
    int8 path at its position."""
    teacher = plain_paged_int8_logits if continuous else plain_int8_logits
    rows = teacher(torch, params, cfg, prompts, toks, dev)
    tok = torch.as_tensor(toks, dtype=torch.long, device=dev)
    gap = rows.max(dim=-1).values - rows.gather(-1, tok[..., None])[..., 0]
    return gap.cpu().numpy()


def bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(x), 2.0 ** -126))) - 7)


def int8_counts(fa, fd, kw) -> dict:
    return {**read_counts(fa, fd, kw), "flash_decode int8": fd.I8_LAUNCHES,
            "flash_decode_paged int8": fd.PAGED_I8_LAUNCHES,
            "kv_write_paged int8": kw.PAGED_I8_LAUNCHES}


def int8_reset(fa, fd, kw) -> None:
    reset_counts(fa, fd, kw)
    fd.I8_LAUNCHES = fd.PAGED_I8_LAUNCHES = kw.PAGED_I8_LAUNCHES = 0


def int8_lane_run(torch, dev, doc: dict, continuous: bool, prompts: dict, stream: bool):
    """One int8 deployment on one lane over REST: each request of
    ``prompts`` (name -> rows), then ``prompts["1-row"]`` as an SSE stream
    when ``stream``, counts reset just before and read just after.
    Returns (engine, answers, launches, decode steps and prefill ticks of
    the continuous lane)."""
    from seldon_core_tpu_torch.ops import flash_attention as fa, flash_decode as fd
    from seldon_core_tpu_torch.ops import kv_write as kw

    int8_reset(fa, fd, kw)
    engine = mode_engine(torch, dev, doc, continuous=continuous)
    probes = int8_counts(fa, fd, kw)
    unit, g = engine.compiled.units["gen"], engine.genserver
    cfg = unit.cfg
    want_probes = ({"flash_decode_paged int8": 1, "kv_write_paged int8": 1} if continuous
                   else {"flash_decode int8": 1})
    if (not unit.use_flash or cfg.quant != "int8" or cfg.kv_quant != "int8"
            or any(probes[k] != n for k, n in want_probes.items())
            or "wqkv_q" not in engine.states()["gen"]["params"]["l0"]):
        raise AssertionError(f"[int8-serve] the engine did not build the int8 generator over the "
                             f"int8 variants (probe launches {probes})")
    server = ServerThread(engine)
    port = server.start()
    url = f"http://127.0.0.1:{port}/api/v0.1/predictions"
    try:
        int8_reset(fa, fd, kw)
        snap0 = g.snapshot() if g is not None else None
        answers = {name: request("POST", url, ndarray(p)) for name, p in prompts.items()}
        if stream:
            events, _, _ = sse_stream(port, {**ndarray(prompts["1-row"]), "chunk": STREAM_CHUNK})
            if not events or events[-1].get("done") is not True:
                raise AssertionError(f"[int8-serve] the stream did not end: {events[-1:]}")
            answers["stream"] = np.concatenate(
                [np.asarray(e["tokens"], dtype=np.int64) for e in events[:-1]], axis=1)
        launches = int8_counts(fa, fd, kw)
        snap1 = g.snapshot() if g is not None else None
    finally:
        server.stop(close_engine=False)
    work = None
    if g is not None:
        work = (snap1["decode_steps_total"] - snap0["decode_steps_total"],
                snap1["prefill_dispatches_total"] - snap0["prefill_dispatches_total"])
    return engine, answers, launches, work


def check_int8_launches(launches: dict, cfg, continuous: bool, work, dispatches: int,
                        new: int, flash_prefill: bool, what: str) -> str:
    """The launches of an int8 lane's run: every decode step's attention
    an int8-variant launch a layer (the step's write fused in), every
    continuous prefill tick's write an int8 kv_write_paged a layer, none of
    a bf16 decode kernel; the static lane's prefill one flash-attention
    launch a layer where the prompt takes the kernel."""
    L = cfg.n_layers
    if continuous:
        steps, ticks = work
        want = {"flash_decode_paged": L * steps, "flash_decode_paged int8": L * steps,
                "kv_write_paged": L * ticks, "kv_write_paged int8": L * ticks,
                "flash_attention": 0, "flash_decode": 0, "flash_decode int8": 0, "kv_write": 0}
        says = (f"{L} x {steps} int8 flash_decode_paged (the steps' writes fused in) and {L} x "
                f"{ticks} int8 kv_write_paged (prefill ticks)")
        ok = steps > 0 and ticks > 0
    else:
        want = {"flash_decode": L * (new - 1) * dispatches,
                "flash_decode int8": L * (new - 1) * dispatches,
                "flash_attention": L * dispatches if flash_prefill else 0,
                "flash_decode_paged": 0, "flash_decode_paged int8": 0, "kv_write_paged": 0,
                "kv_write_paged int8": 0, "kv_write": 0}
        says = (f"{L} x {new - 1} x {dispatches} int8 flash_decode_two_tier (the steps' writes "
                f"fused in), {want['flash_attention']} flash-attention prefill launches")
        ok = True
    if launches != want or not ok:
        raise AssertionError(f"[int8-serve] {what}: launches {launches}, not {want} ({work})")
    return says


def int8_serve_phase(torch, dev, smi) -> dict:
    """10l. examples/generator_int8_deployment.json as written (int8
    weights and K/V, attention "flash", hd 16) on the continuous and the
    static lane over REST (1 row, 8 rows, a 1-row SSE stream), launches
    counted (check_int8_launches), tokens equal the same engine's on the
    CPU except where the two part at a near tie (EXAMPLE_TIE_ULPS of the
    plain int8 path's logits); then the flagship generator at quant /
    kv_quant int8 (full width, 12 layers) on both lanes, a 1-row and a
    32-row 512-token request, every token within INT8_TOKEN_DELTA of its
    lane's plain int8 path's maximum; then QuantizedMnistClassifier (784-256-256-10)
    over REST, 64 rows, against MnistClassifier at the same seed."""
    t_phase = time.perf_counter()
    out = {"example": {}, "flagship": {}}
    doc = example_doc("generator_int8")
    rng = np.random.default_rng(SEED + 151)
    vocab = 256
    # 128-token prompts: the static lane's prefill takes the flash kernel
    ex_prompts = {"1-row": rng.integers(0, vocab, size=(1, 128)),
                  "8-row": rng.integers(0, vocab, size=(8, 128))}
    for continuous in (True, False):
        lane = "continuous" if continuous else "static"
        engine, answers, launches, work = int8_lane_run(torch, dev, doc, continuous, ex_prompts,
                                                        stream=True)
        unit = engine.compiled.units["gen"]
        cfg, new = unit.cfg, unit.max_new_tokens
        says = check_int8_launches(launches, cfg, continuous, work, 3, new, True,
                                   f"the int8 example, {lane} lane")
        params = engine.states()["gen"]["params"]
        twin = cpu_twin(torch, engine, doc)
        same = ties = total = 0
        try:
            for name, p in ex_prompts.items():
                toks = check_tokens(*answers[name], p, "ndarray", new, vocab)
                if name == "1-row" and not np.array_equal(answers["stream"], toks):
                    raise AssertionError(f"[int8-serve] the {lane} stream differs from the "
                                         f"unary answer")
                text, st = asyncio.run(twin.predict_json(json.dumps(ndarray(p))))
                cpu_toks = np.asarray(json.loads(text)["data"]["ndarray"], np.int64)
                if st != 200 or cpu_toks.shape != toks.shape:
                    raise AssertionError(f"[int8-serve] the CPU twin answered {st}")
                total += toks.size
                same += int((cpu_toks == toks).sum())
                teacher = plain_paged_int8_logits if continuous else plain_int8_logits
                rows = teacher(torch, params, cfg, p, toks, dev)
                for r in np.nonzero((cpu_toks != toks).any(axis=1))[0]:
                    j = int(np.argmax(cpu_toks[r] != toks[r]))
                    lr = rows[r, j]
                    d = abs(float(lr[int(toks[r, j])] - lr[int(cpu_toks[r, j])]))
                    margin = EXAMPLE_TIE_ULPS * bf16_ulp(float(lr.abs().max()))
                    if d > margin:
                        raise AssertionError(f"[int8-serve] {lane} row {r} parts from the CPU "
                                             f"twin at token {j} with a logit gap {d:.4f} > "
                                             f"{margin:.4f}")
                    ties += 1
        finally:
            twin.close()
            engine.close()
        out["example"][lane] = {"launches": launches, "work": work, "same_as_cpu": same,
                                "tokens": total, "near_ties": ties}
        log(f"[int8-serve] examples/generator_int8_deployment.json on the {lane} lane, a 1-row "
            f"and an 8-row 128-token request and a 1-row stream (equal to the unary answer): "
            f"launches {says}; {same} of {total} tokens equal the same engine's on the CPU, "
            f"{ties} rows parted at a near tie (<= {EXAMPLE_TIE_ULPS} bf16 ulps)")

    doc = gen_deployment(params=INT8_GEN)
    fl_prompts = {"1-row": rng.integers(0, GEN_DIMS["vocab"], size=(1, GEN_S)),
                  "32-row": rng.integers(0, GEN_DIMS["vocab"], size=(GEN_B, GEN_S))}
    for continuous in (True, False):
        lane = "continuous" if continuous else "static"
        engine, answers, launches, work = int8_lane_run(torch, dev, doc, continuous, fl_prompts,
                                                        stream=False)
        cfg = engine.compiled.units["gen"].cfg
        says = check_int8_launches(launches, cfg, continuous, work, 2, GEN_DIMS["max_new_tokens"],
                                   True, f"the int8 flagship, {lane} lane")
        params = engine.states()["gen"]["params"]
        gaps = []
        for name, p in fl_prompts.items():
            toks = check_tokens(*answers[name], p, "ndarray")
            gaps.append(plain_int8_gaps(torch, params, cfg, p, toks, dev, continuous).ravel())
        gaps = np.concatenate(gaps)
        engine.close()
        out["flagship"][lane] = {"launches": launches, "work": work, "tokens": int(gaps.size),
                                 "gap_max": float(gaps.max()),
                                 "gap_p99": float(np.quantile(gaps, 0.99)),
                                 "exact_share": float((gaps == 0).mean())}
        log(f"[int8-serve] the flagship generator at quant/kv_quant int8 on the {lane} lane, a "
            f"1-row and a 32-row {GEN_S}-token request: launches {says}; {gaps.size} tokens "
            f"teacher-forced through the plain int8 path: gap to its maximum max "
            f"{gaps.max():.5f}, p99 {np.quantile(gaps, 0.99):.5f} (delta {INT8_TOKEN_DELTA}), "
            f"{(gaps == 0).mean() * 100:.2f}% its argmax")
        if gaps.max() > INT8_TOKEN_DELTA:
            raise AssertionError(f"[int8-serve] a served int8 token is {gaps.max():.4f} below the "
                                 f"plain int8 path's maximum")
    out["mnist"] = quantized_mnist_check(torch, dev)
    log(f"[int8-serve] phase wall {time.perf_counter() - t_phase:.2f} s")
    return out


def quantized_mnist_check(torch, dev) -> dict:
    """QuantizedMnistClassifier (784-256-256-10, seed 0) over REST, 64 rows,
    against MnistClassifier at the same seed in an engine of its own: the
    same weights (the quantized state is quantize_mlp_params of the dense
    one, bit for bit), argmax agreement >= 0.95 and probabilities within
    0.05, as tests/test_quant.py:76 asks of the JAX units."""
    from seldon_core_tpu_torch.graph.defaulting import default_and_validate
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.ops.quant import quantize_mlp_params
    from seldon_core_tpu_torch.runtime.engine import EngineService

    def doc(cls):
        return {"spec": {"name": "q", "predictors": [{
            "name": "p", "graph": {"name": "m", "type": "MODEL"},
            "components": [{"name": "m", "runtime": "inprocess", "class_path": cls,
                            "parameters": [{"name": "hidden", "value": "256", "type": "INT"}]}]}]}}

    engines = [EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(doc(c))),
                             device=dev) for c in ("QuantizedMnistClassifier", "MnistClassifier")]
    qstate, dstate = (e.states()["m"] for e in engines)
    want_state = quantize_mlp_params(dstate)
    if set(qstate) != set(want_state) or not all(torch.equal(qstate[k], want_state[k])
                                                 for k in qstate):
        raise AssertionError("[int8-serve] the quantized MNIST unit's state is not the dense "
                             "unit's quantized")
    x = np.random.default_rng(SEED + 152).normal(size=(64, 784)).astype(np.float32)
    probs = []
    server = ServerThread(engines[0])
    port = server.start()
    try:
        status, raw = request("POST", f"http://127.0.0.1:{port}/api/v0.1/predictions",
                              ndarray(x))
    finally:
        server.stop()
    if status != 200:
        raise AssertionError(f"[int8-serve] quantized MNIST answered {status}: {raw[:200]!r}")
    probs.append(np.asarray(json.loads(raw)["data"]["ndarray"], np.float64))
    text, st = asyncio.run(engines[1].predict_json(json.dumps(ndarray(x))))
    probs.append(np.asarray(json.loads(text)["data"]["ndarray"], np.float64))
    engines[1].close()
    agree = float((probs[0].argmax(1) == probs[1].argmax(1)).mean())
    diff = float(np.abs(probs[0] - probs[1]).max())
    log(f"[int8-serve] QuantizedMnistClassifier 784-256-256-10 over REST, 64 rows: argmax "
        f"agreement {agree:.4f} with MnistClassifier at the same seed (>= 0.95), probabilities "
        f"within {diff:.4f} (0.05); its state is the dense unit's quantized, bit for bit")
    if st != 200 or agree < 0.95 or diff > 0.05:
        raise AssertionError(f"[int8-serve] quantized MNIST: agreement {agree}, diff {diff}")
    return {"argmax_agreement": agree, "max_prob_diff": diff}


def dequant_times(torch, dev, smi) -> list:
    """dequant_matmul (W8A16: bf16 x int8 weights, f32 accumulation and
    output, the scale on the output) against the dense bf16 matmul at
    DEQUANT_SHAPES, each rotating over copies of its weights that together
    exceed the 50 MB L2 (the decode step streams 12 layers' weights), with
    the bytes bound of each (x, weights, scales read once, y written once)."""
    from seldon_core_tpu_torch.ops.quant import dequant_matmul, quantize_weight

    rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 161)
    for M, K, N in DEQUANT_SHAPES:
        copies = max(2, -(-DECODE_COLD_BYTES // (K * N * 2)))
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        dense = [torch.randn(K, N, generator=gen, device=dev).to(torch.bfloat16) / K ** 0.5
                 for _ in range(copies)]
        quant = [quantize_weight(w) for w in dense[:copies]]
        i8_ms = device_ms(torch, rotating([(x, *q) for q in quant],
                                          lambda a, wq, ws: dequant_matmul(a, wq, ws,
                                                                           torch.bfloat16)), 50)
        bf_ms = device_ms(torch, rotating([(x, w) for w in dense], lambda a, w: a @ w), 50)
        flops = 2 * M * K * N
        b_i8 = max((M * K * 2 + K * N + 4 * N + M * N * 2) / HBM_BYTES_PER_S,
                   flops / BF16_FLOPS) * 1e3
        b_bf = max((M * K * 2 + K * N * 2 + M * N * 2) / HBM_BYTES_PER_S,
                   flops / BF16_FLOPS) * 1e3
        rows.append({"shape": [M, K, N], "dequant_ms": i8_ms, "bf16_ms": bf_ms,
                     "dequant_bound_ms": b_i8, "bf16_bound_ms": b_bf, "weight_copies": copies})
        log(f"[int8-times] [{M},{K}] x [{K},{N}], cold weights ({copies} copies): dequant_matmul "
            f"{i8_ms:.5f} ms (bound {b_i8:.6f}), dense bf16 matmul {bf_ms:.5f} ms (bound "
            f"{b_bf:.6f}) on {smi}")
        del dense, quant
    return rows


def int8_kernel_times(torch, fd, kw, dev, smi) -> dict:
    """Device ms per call, cold L2, of each int8-K/V variant at the served
    round (B=32, 4 kv heads of 4 query heads, hd 64, n=560: main 512 + 48
    chunk tokens on the static lane) and at the long-context shape (n =
    4096 + 64), the decode step's write fused in, beside the bf16 kernel at
    the same shape, the int8 plain version, dequantize + SDPA (two calls:
    no single PyTorch call computes int8-scaled decode) and the bound
    (i8_bound); kv_write_paged's int8 variant at a prefill tick's W=128 and
    512 into (2049, 4, 16, 64) beside the bf16 kernel, its plain version
    and its bound."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {"flash_decode": [], "flash_decode_paged": [], "kv_write_paged": []}
    B, KV, G, hd = GEN_B, 4, 4, 64
    for n in I8_TIMED_N:
        C = 64 if n > 1024 else 63
        n_chunk = n - (LC_S if n > 1024 else 512)
        shape = (B, KV, G, hd, n - n_chunk, n - n_chunk, C, n_chunk)
        t = {}
        for int8 in (True, False):
            sets = decode_sets(torch, shape, dev, SEED + 171, fused=True, int8=int8)
            t["int8" if int8 else "bf16"] = device_ms(torch, rotating(
                sets, lambda q, mk, mv, ck, cv, kn, vn, sc: fd.flash_decode_two_tier(
                    q, mk, mv, shape[5], ck, cv, n_chunk, kn, vn, sc)), 50)
            if int8:
                t["plain"] = device_ms(torch, rotating(
                    sets, lambda q, mk, mv, ck, cv, kn, vn, sc:
                    fd.flash_decode_two_tier_reference(q, mk, mv, shape[5], ck, cv, n_chunk, kn,
                                                       vn, sc)), 10)

                def deq_sdpa(q, mk, mv, ck, cv, kn, vn, sc):
                    k = torch.cat([mk.float() * sc[0][..., None], ck[:, :, :n_chunk].float()
                                   * sc[2][:, :, :n_chunk, None]], dim=2).to(torch.bfloat16)
                    v = torch.cat([mv.float() * sc[1][..., None], cv[:, :, :n_chunk].float()
                                   * sc[3][:, :, :n_chunk, None]], dim=2).to(torch.bfloat16)
                    return sdpa(q.reshape(B, KV * G, 1, hd), k, v, enable_gqa=True)

                t["dequant_sdpa"] = device_ms(torch, rotating(sets, deq_sdpa), 10)
            del sets
        b_ms, b_by = i8_bound(B, KV, G, hd, B * n, True)
        bf_ms, _ = decode_bound((B, KV, G, hd, 0, n - n_chunk, 0, n_chunk))
        rows["flash_decode"].append({"shape": list(shape), "n": n, "ms": t["int8"],
                                     "bf16_ms": t["bf16"], "plain_ms": t["plain"],
                                     "dequant_sdpa_ms": t["dequant_sdpa"], "library_ms": None,
                                     "bound_ms": b_ms, "bound_by": b_by,
                                     "bf16_bound_ms": bf_ms})
        log(f"[int8-times] flash_decode_two_tier int8 fused, (B,KV,G,hd)=({B},{KV},{G},{hd}), "
            f"n={n} (main {n - n_chunk} + chunk {n_chunk}), cold L2: int8 {t['int8']:.5f} ms, "
            f"bf16 kernel {t['bf16']:.5f} ms, int8 plain {t['plain']:.5f} ms, dequantize + SDPA "
            f"(two calls) {t['dequant_sdpa']:.5f} ms, bound {b_ms:.6f} ms ({b_by}; bf16 "
            f"{bf_ms:.6f}) on {smi}")
        nblk = -(-n // PAGED_BS) + 4
        t = {}
        for int8 in (True, False):
            sets = paged_sets(torch, B, KV, G, hd, nblk, [n] * B, dev, SEED + 172, int8)
            t["int8" if int8 else "bf16"] = device_ms(torch, rotating(
                sets, lambda q, pk, pv, tb, ln, kn, vn, sc=None: fd.flash_decode_paged(
                    q, pk, pv, tb, ln, kn, vn, None, sc)), 50)
            if int8:
                t["plain"] = device_ms(torch, rotating(
                    sets, lambda q, pk, pv, tb, ln, kn, vn, sc: fd.flash_decode_paged_reference(
                        q, pk, pv, tb, ln, kn, vn, None, sc)), 10)

                def deq_sdpa(q, pk, pv, tb, ln, kn, vn, sc):
                    k, v = fd.paged_view(pk, pv, tb)
                    ks, vs = (fd.paged_scale_view(s, tb) for s in sc)
                    k = (k[:, :, :n].float() * ks[:, :, :n, None]).to(torch.bfloat16)
                    v = (v[:, :, :n].float() * vs[:, :, :n, None]).to(torch.bfloat16)
                    return sdpa(q.reshape(B, KV * G, 1, hd), k, v, enable_gqa=True)

                t["dequant_sdpa"] = device_ms(torch, rotating(sets, deq_sdpa), 10)
            del sets
        b_ms, b_by = i8_bound(B, KV, G, hd, B * n, True, 4 * (B * nblk + B))
        bf_ms, _ = paged_decode_bound(B, KV, G, hd, nblk, [n] * B, fused=True)
        rows["flash_decode_paged"].append({"shape": [B, KV, G, hd, nblk, n], "n": n,
                                           "ms": t["int8"], "bf16_ms": t["bf16"],
                                           "plain_ms": t["plain"],
                                           "dequant_sdpa_ms": t["dequant_sdpa"],
                                           "library_ms": None, "bound_ms": b_ms,
                                           "bound_by": b_by, "bf16_bound_ms": bf_ms})
        log(f"[int8-times] flash_decode_paged int8 fused, (B,KV,G,hd)=({B},{KV},{G},{hd}), "
            f"{nblk} blocks of {PAGED_BS}, n={n} in every row, cold L2: int8 {t['int8']:.5f} ms, "
            f"bf16 kernel {t['bf16']:.5f} ms, int8 plain {t['plain']:.5f} ms, gather + dequantize "
            f"+ SDPA (calls of their own) {t['dequant_sdpa']:.5f} ms, bound {b_ms:.6f} ms "
            f"({b_by}; bf16 {bf_ms:.6f}) on {smi}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 173)
    Bw, nblk = 32, PAGED_NBLK
    N = Bw * nblk + 1
    for W in (128, 512):
        (pk, pks), (pv, pvs) = (kw.int8_kv_rows((N, 4, PAGED_BS, 64), gen, dev)
                                for _ in range(2))
        bk, bv = (torch.zeros(N, 4, PAGED_BS, 64, dtype=torch.bfloat16, device=dev)
                  for _ in range(2))
        tables = (torch.randperm(N - 1, generator=gen, device=dev)[: Bw * nblk] + 1)
        tables = tables.reshape(Bw, nblk).to(torch.int32)
        start = (torch.randint(0, nblk * PAGED_BS // W, (Bw,), generator=gen, device=dev)
                 * W).to(torch.int32)
        valid = torch.ones(Bw, W, dtype=torch.bool, device=dev)
        k, v = head_views(torch, Bw, W, 4, 64, torch.Generator().manual_seed(SEED + 174), dev)
        for pools in ((pk, pv), (bk, bv)):
            check_write_plan(kw, Bw, 4, W, kw.paged_write_lanes(*pools, k, v))
        i8_ms = device_ms(torch, lambda: kw.kv_write_paged(pk, pv, k, v, tables, start, valid,
                                                           (pks, pvs)), 100)
        bf_ms = device_ms(torch, lambda: kw.kv_write_paged(bk, bv, k, v, tables, start, valid),
                          100)
        p_ms = device_ms(torch, lambda: kw.kv_write_paged_reference(pk, pv, k, v, tables, start,
                                                                    valid, (pks, pvs)), 20)
        nbytes = Bw * 4 * W * (2 * 64 * 2 + 2 * (64 + 4)) + 4 * (Bw * nblk + Bw) + Bw * W
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows["kv_write_paged"].append({"shape": [N, 4, PAGED_BS, 64, Bw, W], "ms": i8_ms,
                                       "bf16_ms": bf_ms, "plain_ms": p_ms, "library_ms": None,
                                       "bound_ms": b_ms, "bound_by": "bytes"})
        log(f"[int8-times] kv_write_paged int8, {Bw} rows of W={W} bf16 into ({N},4,{PAGED_BS},"
            f"64) int8 pools with scale planes: int8 {i8_ms:.5f} ms, bf16 kernel {bf_ms:.5f} ms, "
            f"plain (quantize + index_put_) {p_ms:.5f} ms, bound {b_ms:.6f} ms (bytes) on {smi}")
        del pk, pv, pks, pvs, bk, bv
    return rows


def long_context_rates(torch, dev, smi) -> dict:
    """The static lane's long-context decode rate (bench.py:547-560: B=32,
    S=4096, 64 new tokens), the flagship at int8 K/V against bf16 K/V in
    turns (ABBA, I8_TURNS x 2 walls each): decode tokens/s from the wall of
    generate(64) less the wall of generate(1) (the prefill and first
    token), the same prompts and weights; then one profiled int8 decode
    step (its launches and kernel ms)."""
    from seldon_core_tpu_torch.models.generate import (decode_step_two_tier, generate,
                                                       init_chunk, prefill, init_cache)
    from seldon_core_tpu_torch.models.transformer import LMConfig, lm_init

    dims = {k: v for k, v in GEN_DIMS.items() if k != "max_new_tokens"}
    cfgs = {"int8": LMConfig(**dims, kv_quant="int8"), "bf16": LMConfig(**dims)}
    params = lm_init(torch.Generator().manual_seed(SEED + 181), cfgs["bf16"], dev)
    prompt = torch.as_tensor(np.random.default_rng(3).integers(0, GEN_DIMS["vocab"],
                                                               size=(LC_B, LC_S)),
                             dtype=torch.int32, device=dev)
    walls = {"int8": [], "bf16": []}

    def wall(cfg, new):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.inference_mode():
            generate(params, prompt, cfg, max_new_tokens=new, use_flash=True)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    for name in cfgs:  # warm-up
        wall(cfgs[name], 2)
    for _ in range(I8_TURNS):
        for name in ("int8", "bf16", "bf16", "int8"):
            walls[name].append((wall(cfgs[name], LC_NEW), wall(cfgs[name], 1)))
    rates = {name: [LC_B * (LC_NEW - 1) / (a - b) for a, b in w] for name, w in walls.items()}
    with torch.inference_mode():
        cfg = cfgs["int8"]
        _, main = prefill(params, prompt, init_cache(cfg, LC_B, LC_S, dev), cfg, True)
        chunk = init_chunk(cfg, LC_B, LC_NEW, dev)
        tok = prompt[:, -1]
        prof = device_profile(torch, lambda: decode_step_two_tier(params, tok, main, chunk, LC_S,
                                                                  0, cfg, True), "i8_step",
                              by_name=True)
    i8_ms = sum(v for k, v in prof["by_name"].items() if "flash_decode_i8_kernel" in k)
    del main, chunk
    log(f"[int8-times] long-context static decode, B={LC_B}, S={LC_S}, {LC_NEW} new tokens, "
        f"in turns (ABBA): int8 K/V {['%.1f' % r for r in rates['int8']]} tokens/s, bf16 K/V "
        f"{['%.1f' % r for r in rates['bf16']]} tokens/s (decode only: generate(64) less "
        f"generate(1)); a profiled int8 decode step: {prof['kernels']} kernels, "
        f"{prof['kernel_ms']:.4f} ms of kernels in a {prof['wall_ms']:.3f} ms wall, the int8 "
        f"decode kernel {i8_ms:.4f} ms ({12} launches) on {smi}")
    return {"tokens_per_s": rates, "walls_s": walls,
            "profiled_step": {k: prof[k] for k in ("wall_ms", "kernel_ms", "busy_share",
                                                   "kernels", "top_ms")},
            "int8_decode_kernel_ms_per_step": i8_ms}


def int8_phases(torch, dev, smi) -> list:
    """Phases 10k-10m, [2q] on the card: the int8-K/V variants against
    their plain versions (10k), the int8 example and the flagship at int8
    served on both lanes and the quantized MNIST (10l), their times (10m).
    Returns the kernels line's three int8 rows, launches those of 10l."""
    from seldon_core_tpu_torch.ops import flash_decode as fd
    from seldon_core_tpu_torch.ops import kv_write as kw

    t_phase = time.perf_counter()
    checked = int8_kernel_phase(torch, fd, kw, dev)
    errs = checked["errs"]
    served = int8_serve_phase(torch, dev, smi)
    t0 = time.perf_counter()
    times = int8_kernel_times(torch, fd, kw, dev, smi)
    matmuls = dequant_times(torch, dev, smi)
    rates = long_context_rates(torch, dev, smi)
    log(f"[int8-times] phase wall {time.perf_counter() - t0:.2f} s")
    log(json.dumps({"int8": {"served": served, "times": times, "dequant_matmul": matmuls,
                             "long_context": rates, "card": smi}}))

    def launches(name):
        by = {f"{what} {lane}": run["launches"][name]
              for what in ("example", "flagship") for lane, run in served[what].items()}
        return sum(by.values()), by

    rows = []
    for name, kernel, design, err_key, replaces in (
            ("flash_decode (int8 K/V)", "flash_decode int8", I8_DECODE_DESIGN, "flash_decode",
             "seldon_core_tpu/ops/flash_decode.py:47"),
            ("flash_decode_paged (int8 K/V)", "flash_decode_paged int8", I8_PAGED_DESIGN,
             "flash_decode_paged", "seldon_core_tpu/ops/flash_decode.py:47"),
            ("kv_write_paged (int8)", "kv_write_paged int8", I8_KV_DESIGN, "kv_write_paged",
             "scripts/probe_inplace.py:55")):
        top = times[err_key][0]
        total, by = launches(kernel)
        rows.append({
            "name": name, "route": "cuda",
            "source": ("seldon_core_tpu_torch/ops/csrc/"
                       + {"flash_decode": "flash_decode.cu",
                          "flash_decode_paged": "flash_decode_paged.cu",
                          "kv_write_paged": "kv_write.cu"}[err_key]),
            "replaces": replaces, "launches": total, "launches_by_path": by,
            "max_abs_err": errs[err_key]["abs"], "max_rel_err": errs[err_key]["rel"],
            "defects_rel_err": checked["defects"].get(err_key),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"], "library_ms": None,
            "bf16_ms": top["bf16_ms"],
            "library_note": ("no single PyTorch call computes int8-scaled decode; dequantize + "
                             "SDPA (two calls) in 'at'" if err_key != "kv_write_paged" else
                             "no PyTorch call quantizes and scatters"),
            "shape": top["shape"], "design": design, "at": times[err_key]})
    log(f"[int8] phases 10k-10m wall {time.perf_counter() - t_phase:.2f} s")
    return rows


def int8_build_checks(torch, fd) -> None:
    """The int8-K/V variants' own shape checks, at the sources' dtype code
    2: both take the flagship's (hd 64, group 4) and the example's (hd 16,
    group 4) heads, refuse hd 8 and 40 (not a multiple of 16) and float32 q
    over an int8 cache; the paged variant's shared memory equals
    ops/flash_decode.py's statement of the int8 walk's layout (i8_walk_layout,
    both variants' plan) at every head dim and group it takes, and so does
    the two-tier variant's; the paged variant refuses blocks of 12."""
    i8 = torch.int8
    for hd in (64, 16):
        n, why = fd._smem_bytes(hd, 4, torch.bfloat16, i8)
        if why is not None or n <= 0:
            raise AssertionError(f"the int8 two-tier variant refused hd {hd}: {why!r}")
    for hd, dtype, match in ((8, torch.bfloat16, "multiple of 16"),
                             (40, torch.bfloat16, "multiple of 16"),
                             (64, torch.float32, "int8 cache")):
        why = fd.decode_kernel_shape_error(hd, dtype, 4, i8)
        if why is None or match not in why:
            raise AssertionError(f"the int8 two-tier variant let hd {hd} {dtype} through: {why!r}")
    for hd in range(16, 257, 16):
        for group in (1, 2, 3, 4, 8, 16):
            want = fd.i8_walk_layout(hd, group)["bytes"]
            n, why = fd._paged_smem_bytes(hd, group, PAGED_BS, torch.bfloat16, i8)
            n2, why2 = fd._smem_bytes(hd, group, torch.bfloat16, i8)
            if why is not None or why2 is not None or n != want or n2 != want:
                raise AssertionError(f"the int8 walk's layout, stated in Python, differs from the "
                                     f"sources at hd {hd}, group {group}: paged {n} {why!r}, "
                                     f"two-tier {n2} {why2!r}, stated {want}")
    for hd, bs, dtype, match in ((40, PAGED_BS, torch.bfloat16, "multiple of 16"),
                                 (64, 12, torch.bfloat16, "multiple of 8"),
                                 (64, PAGED_BS, torch.float32, "int8 pools")):
        why = fd.paged_kernel_shape_error(hd, dtype, 4, bs, i8)
        if why is None or match not in why:
            raise AssertionError(f"the int8 paged variant let hd {hd}, blocks of {bs}, {dtype} "
                                 f"through: {why!r}")
    log(f"[build] int8-K/V variants (dtype code 2): hd 64 and 16 at group 4 taken by both; hd 8 "
        f"and 40 and float32 q refused; both variants' shared memory equals i8_walk_layout at "
        f"hd 16-256 x groups 1-16 ({fd.i8_walk_layout(64, 4)['bytes']} bytes at the flagship's "
        f"heads), blocks of 12 refused")


# -- 10n. the binary wire and gRPC ---------------------------------------

WIRE_P50_REQUESTS = 100   # keepalive requests a lane a turn; two turns (ABBA): 200 each
# sockets under /tmp, short: sun_path holds 108 bytes
WIRE_HTTP_UDS = "/tmp/sct_http_%d.sock"
WIRE_RELAY_UDS = "/tmp/sct_relay_%d.sock"
WIRE_M3_UDS = "/tmp/sct_m3_%d.sock"
WIRE_LANES = ("json", "wire_f32", "wire_f64", "wire_i8", "grpc_tensor", "grpc_ndarray",
              "http_uds", "relay")
GRPC_PREDICT = b"/seldon.protos.Seldon/Predict"


class UnixHTTPConnection(http.client.HTTPConnection):
    """http.client over a unix socket (the engine's HTTP routes there)."""

    def __init__(self, path: str, timeout: float = 120):
        super().__init__("localhost", timeout=timeout)
        self.unix_path = path

    def connect(self):
        import socket

        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(self.timeout)
        sock.connect(self.unix_path)
        self.sock = sock


class LanesThread:
    """One engine's lanes on their own event loop and thread: REST (and its
    routes on a unix socket), gRPC (``serve_grpc_fast``) and the relay
    (``serve_uds``)."""

    def __init__(self, engine, http_uds: str, relay_uds: str):
        self.engine, self.http_uds, self.relay_uds = engine, http_uds, relay_uds
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.servers = []

    def start(self):
        from seldon_core_tpu_torch.runtime.grpcfast import serve_grpc_fast
        from seldon_core_tpu_torch.runtime.rest import serve_fast
        from seldon_core_tpu_torch.runtime.udsrelay import serve_uds

        self.thread.start()

        async def up():
            rest = await serve_fast(self.engine, "127.0.0.1", 0, uds_path=self.http_uds)
            grpc = await serve_grpc_fast(self.engine, "127.0.0.1", 0)
            relay = await serve_uds(self.engine, self.relay_uds)
            return [rest, grpc, relay]

        self.servers = asyncio.run_coroutine_threadsafe(up(), self.loop).result(60)
        return self.servers[0].port, self.servers[1].port

    def stop(self):
        for srv in self.servers:
            asyncio.run_coroutine_threadsafe(srv.stop(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)


class LaneClients:
    """Keepalive clients of every lane of one engine, driven from this
    thread: HTTP over TCP and over the unix socket, a ``FastGrpcChannel``
    and a relay client on a client loop of their own."""

    def __init__(self, rest_port: int, grpc_port: int, http_uds: str, relay_uds: str):
        from seldon_core_tpu_torch.runtime.grpcfast import FastGrpcChannel
        from seldon_core_tpu_torch.runtime.udsrelay import UdsRelayClient

        self.http = http.client.HTTPConnection("127.0.0.1", rest_port, timeout=120)
        self.uds = UnixHTTPConnection(http_uds)
        self.loop = asyncio.new_event_loop()
        self.grpc = self.loop.run_until_complete(
            FastGrpcChannel().connect("127.0.0.1", grpc_port))
        self.relay = UdsRelayClient(relay_uds, pool=1)

    def post(self, body: bytes, ctype: str, conn=None, path="/api/v0.1/predictions"):
        conn = conn or self.http
        conn.request("POST", path, body, {"Content-Type": ctype})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type", ""), r.read()

    def grpc_call(self, body: bytes, path: bytes = GRPC_PREDICT) -> bytes:
        return self.loop.run_until_complete(self.grpc.call(path, body))

    def relay_call(self, op: int, body: bytes):
        return self.loop.run_until_complete(self.relay.call(op, body))

    def close(self):
        self.http.close()
        self.uds.close()
        self.loop.run_until_complete(self.grpc.close())
        self.loop.run_until_complete(self.relay.close())
        self.loop.close()


def lane_request(cl: LaneClients, lane: str, x: np.ndarray, puid: str):
    """``x`` over ``lane``: (probabilities as float64, puid, names, status
    200/SUCCESS) of the answer."""
    from seldon_core_tpu_torch import protoconv
    from seldon_core_tpu_torch.messages import Meta, SeldonMessage
    from seldon_core_tpu_torch.runtime import udsrelay, wire

    def frame_answer(status, raw):
        f = wire.decode_frame(raw)
        return (np.asarray(f.values(), dtype=np.float64), f.meta.get("puid"),
                f.extra().get("names"), status == 200 and f.status == 200 and f.is_response)

    def json_answer(status, raw):
        doc = json.loads(raw)
        data = doc["data"]
        y = (np.asarray(data["ndarray"], dtype=np.float64) if "ndarray" in data else
             np.asarray(data["tensor"]["values"], dtype=np.float64).reshape(
                 data["tensor"]["shape"]))
        return y, doc["meta"].get("puid"), data.get("names"), (
            status == 200 and doc.get("status", {}).get("status", "SUCCESS") == "SUCCESS")

    meta = wire.pack_wire_meta(puid=puid)
    json_body = json.dumps({"data": {"tensor": {"shape": list(x.shape),
                                                "values": x.ravel().tolist()}},
                            "meta": {"puid": puid}}).encode()
    if lane in ("json", "http_uds"):
        st, _, raw = cl.post(json_body, "application/json",
                             conn=cl.uds if lane == "http_uds" else None)
        return json_answer(st, raw)
    if lane in ("wire_f32", "wire_f64"):
        a = x.astype(np.float32 if lane == "wire_f32" else np.float64)
        st, ct, raw = cl.post(wire.join_parts(wire.encode_frame(a, meta_bytes=meta)),
                              wire.WIRE_CONTENT_TYPE)
        if ct != wire.WIRE_CONTENT_TYPE:
            raise AssertionError(f"[wire] {lane}: HTTP {st} {ct}: {raw[:300]!r}")
        return frame_answer(st, raw)
    if lane == "wire_i8":
        q, scales = wire.quantize_rows(x)
        body = wire.join_parts(wire.encode_frame(q, meta_bytes=meta, scales=scales))
        deq = wire.decode_frame(body).rows()
        step = float((np.abs(deq - x) / scales[:, None]).max())
        if step > 0.5 + 1e-6:
            raise AssertionError(f"[wire] the int8 frame's rows are {step:.4f} steps from X")
        st, ct, raw = cl.post(body, wire.WIRE_CONTENT_TYPE)
        return frame_answer(st, raw)
    if lane in ("grpc_tensor", "grpc_ndarray"):
        kind = "tensor" if lane == "grpc_tensor" else "ndarray"
        resp = protoconv.msg_from_proto(cl.grpc_call(protoconv.msg_to_proto(
            SeldonMessage.from_array(x, kind=kind, meta=Meta(puid=puid)))))
        ok = resp.status is not None and resp.status.status == "SUCCESS" \
            and resp.status.code == 200 and resp.data is not None and resp.data.kind == kind
        return (np.asarray(resp.array(), dtype=np.float64), resp.meta.puid,
                resp.data.names if resp.data is not None else None, ok)
    if lane == "relay":
        raw, st = cl.relay_call(udsrelay.OP_WIRE, wire.join_parts(
            wire.encode_frame(x, meta_bytes=meta)))
        return frame_answer(st, raw)
    raise ValueError(lane)


def lane_walls(cl: LaneClients, lane: str, x: np.ndarray, runs: int) -> list:
    """Walls (s) of ``runs`` requests of ``x`` over ``lane`` (JSON, the
    float64 wire or gRPC's tensor lane) on its keepalive connection, each
    request's bytes made beforehand and its answer read whole."""
    from seldon_core_tpu_torch import protoconv
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.runtime import wire

    if lane == "grpc":
        body = protoconv.msg_to_proto(SeldonMessage.from_array(x))
    elif lane == "wire":
        body, ctype = wire.join_parts(wire.encode_frame(x)), wire.WIRE_CONTENT_TYPE
    else:
        body, ctype = json.dumps(ndarray(x)).encode(), "application/json"
    walls = []
    for _ in range(runs):
        t = time.perf_counter()
        if lane == "grpc":
            cl.grpc_call(body)
        else:
            st, _, _ = cl.post(body, ctype)
            if st != 200:
                raise AssertionError(f"[wire] {lane} latency loop: HTTP {st}")
        walls.append(time.perf_counter() - t)
    return walls


def start_service(argv: list, env: dict, ready: str, timeout: float = 300):
    """A subprocess of this package with its stdout piped; returns it once
    its first line starts with ``ready``."""
    proc = subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT,
                            env={**os.environ, **env}, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    start = time.perf_counter()
    while True:
        line = proc.stdout.readline()
        if line.startswith(ready):
            return proc, line.strip()
        if not line or time.perf_counter() - start > timeout:
            proc.kill()
            out = line + proc.stdout.read()
            raise AssertionError(f"[wire] {' '.join(argv[:3])} did not come up: {out[-1500:]}")


def stop_service(proc, timeout: float = 60) -> str:
    """SIGTERM, then the rest of its output."""
    if proc.poll() is None:
        proc.send_signal(subprocess.signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wire_grpc_phase(torch, dev, smi) -> dict:
    """10n. The binary tensor wire, gRPC and the unix sockets ([3]).
    examples/mnist_deployment.json (bf16, seed 0) behind one engine with
    its REST lane, gRPC (``serve_grpc_fast``), its HTTP routes on a unix
    socket and the relay: the same 1-row and 64-row X (numpy, seed 0), each
    request alone and in turn, over JSON, the binary wire at float32,
    float64 and int8 with its scale plane, gRPC's tensor lane and its
    object lane (an ndarray request), the HTTP socket and the relay; every
    answer the JSON answer's float64 values exactly (int8: its rows within
    half a quantization step of X, its answer within MNIST_ATOL), the JSON
    answer within MNIST_ATOL of the plain version on the CPU, names, the
    puid echo and the status agreeing; one fused-MLP launch a request on
    every lane.  A MULTI frame of 8 sub-frames, one torn: 7 answers and
    the torn slot's own 400 frame.  Typed errors: a torn frame 400, a
    declared shape beyond the cap 413 (the connection serving on), 415
    with SELDON_TPU_WIRE=0, UNIMPLEMENTED for an unknown gRPC path, a
    FAILURE SeldonMessage for a malformed gRPC body.  ensemble4 in host
    mode with m3 behind a gRPC microservice subprocess
    (``microservice MnistClassifier GRPC`` on the card), then behind a
    second engine's ``ENGINE_HTTP_UDS_PATH`` socket (a ``unix:`` host):
    within HOST_ATOL of fused, the remote launches counted in the remote
    process; with the microservice stopped, a quorum-3 ensemble degrades
    until m3's breaker opens.  p50s over 200 keepalive requests a lane in
    turns (JSON, wire, gRPC at 1 and 64 rows; gRPC-remote against
    REST-remote ensemble4 at 1 row)."""
    from seldon_core_tpu_torch import protoconv
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.models.mnist import MnistClassifier
    from seldon_core_tpu_torch.ops import fused_mlp
    from seldon_core_tpu_torch.runtime import wire
    from seldon_core_tpu_torch.runtime.grpcfast import GrpcCallError

    t_phase = time.perf_counter()
    counted = dev.type == "cuda"  # the plain version on the CPU counts nothing
    pid = os.getpid()
    out = {"launches": {}}
    engine = mode_engine(torch, dev, example_doc("mnist"), continuous=False)
    dispatches = [0]
    _count_calls(engine.compiled, "predict_arrays", dispatches)
    lanes = LanesThread(engine, WIRE_HTTP_UDS % pid, WIRE_RELAY_UDS % pid)
    rest_port, grpc_port = lanes.start()
    cl = LaneClients(rest_port, grpc_port, WIRE_HTTP_UDS % pid, WIRE_RELAY_UDS % pid)
    rng = np.random.default_rng(SEED)
    xs = {1: rng.random((1, 784)), 64: rng.random((64, 784))}
    try:
        # -- one request, every transport ------------------------------------
        answers = {}
        launches = {lane: 0 for lane in WIRE_LANES}
        for n, x in xs.items():
            for lane in WIRE_LANES:
                puid = f"{lane}-{n}"
                fused_mlp.LAUNCHES = 0
                dispatches[0] = 0
                y, echo, names, ok = lane_request(cl, lane, x, puid)
                got = fused_mlp.LAUNCHES
                if (not ok or echo != puid or y.shape != (n, 10) or not np.isfinite(y).all()
                        or dispatches[0] != 1 or (counted and got != 1)):
                    raise AssertionError(f"[wire] {lane} at {n} rows: status ok {ok}, puid "
                                         f"{echo!r}, shape {y.shape}, {dispatches[0]} "
                                         f"dispatches, {got} launches")
                launches[lane] += got
                answers[lane, n] = (y, names)
        want_names = answers["json", 1][1]
        plain = {}
        state = {k: v.cpu() for k, v in engine.states()["mnist"].items()}
        for n, x in xs.items():
            yj = answers["json", n][0]
            plain[n] = float(np.abs(yj - fused_mlp.fused_mlp_softmax_reference(
                state, torch.as_tensor(x, dtype=torch.float32)).numpy()).max())
            for lane in WIRE_LANES:
                y, names = answers[lane, n]
                same = (np.abs(y - yj).max() <= MNIST_ATOL if lane == "wire_i8"
                        else np.array_equal(y, yj))
                if not same or names != want_names:
                    raise AssertionError(f"[wire] {lane} at {n} rows vs JSON: "
                                         f"{float(np.abs(y - yj).max()):.3e}, names {names}")
        i8_err = max(float(np.abs(answers["wire_i8", n][0] - answers["json", n][0]).max())
                     for n in xs)
        if max(plain.values()) > MNIST_ATOL or not want_names:
            raise AssertionError(f"[wire] JSON vs the plain version on the CPU {plain}")
        out.update(json_vs_plain_cpu=plain, int8_vs_json=i8_err,
                   launches_by_lane=launches)
        out["launches"]["lanes"] = sum(launches.values())
        log(f"[wire] 1 and 64 rows over {', '.join(WIRE_LANES)}: every answer the JSON "
            f"answer's float64 values bit for bit (int8 with its scale plane within "
            f"{i8_err:.3e}, its rows within half a step of X), names and puid echoed, status "
            f"200; JSON vs the plain version on the CPU {max(plain.values()):.3e} "
            f"(tolerance {MNIST_ATOL}); one dispatch and one fused-MLP launch a request: "
            f"{sum(launches.values())} launches")

        # -- a MULTI frame, one slot torn --------------------------------------
        subs = []
        for i in range(8):
            f = wire.join_parts(wire.encode_frame(
                xs[64][i:i + 1], meta_bytes=wire.pack_wire_meta(puid=f"m{i}")))
            subs.append(f[:-8] if i == 5 else f)
        fused_mlp.LAUNCHES = 0
        st, ct, raw = cl.post(wire.join_parts(wire.encode_multi(subs)), wire.WIRE_CONTENT_TYPE)
        n_multi = fused_mlp.LAUNCHES
        multi = wire.decode_frame(raw)
        slots = [wire.decode_frame(s) for s in multi.subframes]
        good = [i for i in range(8) if i != 5]
        errs = [float(np.abs(np.asarray(slots[i].values(), np.float64)
                             - answers["json", 64][0][i]).max()) for i in good]
        if (st != 200 or not multi.is_multi or len(slots) != 8 or slots[5].status != 400
                or "payload" not in slots[5].extra().get("error", "")
                or any(slots[i].status != 200 or slots[i].meta["puid"] != f"m{i}" for i in good)
                or max(errs) > KERNEL_ATOL or (counted and not 1 <= n_multi <= 7)):
            raise AssertionError(f"[wire] MULTI: HTTP {st}, statuses "
                                 f"{[s.status for s in slots]}, vs JSON {errs}, {n_multi} "
                                 f"launches")
        out["launches"]["multi"] = n_multi
        log(f"[wire] a MULTI frame of 8 one-row sub-frames, slot 5 torn: 7 answers within "
            f"{max(errs):.3e} of the 64-row JSON answer's rows (the batcher merged them: "
            f"{n_multi} launches), slot 5 its own 400 frame "
            f"({slots[5].extra()['error'][:60]!r})")

        # -- typed errors --------------------------------------------------------
        good_body = wire.join_parts(wire.encode_frame(xs[1]))
        torn = good_body[:-3]
        big = bytearray(wire.join_parts(wire.encode_frame(np.zeros((1, 4)))))
        big[14:22] = (70000).to_bytes(4, "big") + (70000).to_bytes(4, "big")  # f64 70000x70000
        typed = [cl.post(b, wire.WIRE_CONTENT_TYPE)[0] for b in (torn, bytes(big), good_body)]
        os.environ["SELDON_TPU_WIRE"] = "0"
        try:
            off = cl.post(good_body, wire.WIRE_CONTENT_TYPE)
        finally:
            del os.environ["SELDON_TPU_WIRE"]
        try:
            cl.grpc_call(protoconv.msg_to_proto(SeldonMessage.from_array(xs[1])),
                         b"/seldon.protos.Nope/X")
            unimplemented = None
        except GrpcCallError as e:
            unimplemented = e.code_name
        bad = protoconv.msg_from_proto(cl.grpc_call(b"\xff\xff\xff\xffgarbage"))
        if (typed != [400, 413, 200] or off[0] != 415 or unimplemented != "UNIMPLEMENTED"
                or bad.status is None or bad.status.status != "FAILURE" or bad.status.code != 400):
            raise AssertionError(f"[wire] typed errors: torn/oversized/then good {typed}, "
                                 f"SELDON_TPU_WIRE=0 {off[0]}, unknown gRPC path "
                                 f"{unimplemented}, malformed gRPC body {bad.status}")
        log(f"[wire] typed errors: a torn frame 400, a declared 70000x70000 float64 413, the "
            f"same keepalive connection then 200; SELDON_TPU_WIRE=0 415; an unknown gRPC path "
            f"UNIMPLEMENTED; a malformed gRPC body the FAILURE message {bad.status.info[:50]!r}")

        # -- p50s in turns: JSON, wire, gRPC at 1 and 64 rows ----------------------
        walls = {(lane, n): [] for lane in ("json", "wire", "grpc") for n in xs}
        for lane in ("json", "wire", "grpc", "grpc", "wire", "json"):
            for n, x in xs.items():
                walls[lane, n] += lane_walls(cl, lane, x, WIRE_P50_REQUESTS)
        p50 = {f"{lane}_{n}": float(np.median(w)) * 1e3 for (lane, n), w in walls.items()}
        out.update(p50_ms=p50, quartiles_ms={f"{lane}_{n}": quartiles_ms(w)
                                             for (lane, n), w in walls.items()})
        log(f"[times] MNIST p50 over {2 * WIRE_P50_REQUESTS} keepalive requests a lane, in "
            f"turns: 1 row JSON {p50['json_1']:.3f} ms, wire {p50['wire_1']:.3f}, gRPC "
            f"{p50['grpc_1']:.3f}; 64 rows JSON {p50['json_64']:.3f} ms, wire "
            f"{p50['wire_64']:.3f}, gRPC {p50['grpc_64']:.3f}; on {smi}")
    finally:
        cl.close()
        lanes.stop()
        engine.close()
    if any(os.path.exists(p % pid) for p in (WIRE_HTTP_UDS, WIRE_RELAY_UDS)):
        raise AssertionError("[wire] a unix socket file outlived its server")

    # -- ensemble4 across processes: gRPC, then a unix: host -------------------
    doc = example_doc("ensemble4")
    seed3 = json.dumps([p.to_json_dict() for p in _seed3()])
    grpc_port, rest_port = free_port(), free_port()
    m3_uds = WIRE_M3_UDS % pid
    m3_doc = {"spec": {"name": "m3", "predictors": [{
        "name": "main", "components": [c for c in doc["spec"]["predictors"][0]["components"]
                                       if c["name"] == "m3"],
        "graph": {"name": "m3", "type": "MODEL"}}]}}
    m3_file = Path(f"/tmp/sct_m3_{pid}.json")
    m3_file.write_text(json.dumps(m3_doc))
    # the three remote processes start at once; any that came up is stopped
    # if another did not
    with ThreadPoolExecutor(3) as pool:
        futs = [pool.submit(start_service, *a) for a in [
            (["seldon_core_tpu_torch.runtime.microservice", "MnistClassifier", "GRPC",
              "--port", str(grpc_port), "--parameters", seed3, "--device", dev.type], {},
              "unit up:"),
            (["seldon_core_tpu_torch.runtime.microservice", "MnistClassifier", "REST",
              "--port", str(rest_port), "--parameters", seed3, "--device", dev.type], {},
              "unit up:"),
            (["seldon_core_tpu_torch.runtime.engine_main", "--file", str(m3_file), "--device",
              dev.type, "--host", "127.0.0.1", "--rest-port", str(free_port())],
             {"ENGINE_SERVER_GRPC_PORT": str(free_port()), "ENGINE_HTTP_UDS_PATH": m3_uds},
             "engine up:")]]
    errors = [f.exception() for f in futs]
    if any(errors):
        for f, e in zip(futs, errors):
            if e is None:
                stop_service(f.result()[0])
        m3_file.unlink()
        raise next(e for e in errors if e is not None)
    (grpc_ms, _), (rest_ms, _), (m3_engine, m3_line) = [f.result() for f in futs]
    if f"http-uds={m3_uds}" not in m3_line or "grpc=:" not in m3_line:
        raise AssertionError(f"[wire] the unix engine's line: {m3_line}")

    def remote_doc(binding, quorum=None):
        d = json.loads(json.dumps(doc))
        comps = d["spec"]["predictors"][0]["components"]
        comps[[c["name"] for c in comps].index("m3")] = {"name": "m3", **binding}
        if quorum is not None:
            d["spec"]["predictors"][0]["graph"]["quorum"] = quorum
        return d

    fused, engines, servers = None, {}, {}
    try:
        fused = mode_engine(torch, dev, doc, continuous=False)
        engines["unix"] = mode_engine(torch, dev, remote_doc(
            {"runtime": "rest", "host": f"unix:{m3_uds}"}), continuous=False)
        engines["grpc"] = mode_engine(torch, dev, remote_doc(
            {"runtime": "grpc", "host": "127.0.0.1", "port": grpc_port}), continuous=False)
        engines["rest"] = mode_engine(torch, dev, remote_doc(
            {"runtime": "rest", "host": "127.0.0.1", "port": rest_port}), continuous=False)
        engines["grpc_quorum"] = mode_engine(torch, dev, remote_doc(
            {"runtime": "grpc", "host": "127.0.0.1", "port": grpc_port}, quorum=3),
            continuous=False)
        servers = {name: ServerThread(e) for name, e in engines.items()}
        ports = {name: srv.start() for name, srv in servers.items()}
        x1, x64 = xs[1], xs[64]
        if any(e.mode != "host" for e in engines.values()) or fused.mode != "fused":
            raise AssertionError(f"[wire] modes: fused {fused.mode}, "
                                 f"{ {k: e.mode for k, e in engines.items()} }")
        want_unix = np.concatenate([json_rows(asyncio.run(fused.predict_json(json.dumps(
            ndarray(x))))[0]) for x in (x1, x64)])
        # the microservices' m3: MnistClassifier(seed 3) built alone (no graph seed)
        ms_unit = MnistClassifier(seed=3, device=dev)
        fused.load_states({"m3": ms_unit.init_state(None)})
        want_ms = np.concatenate([json_rows(asyncio.run(fused.predict_json(json.dumps(
            ndarray(x))))[0]) for x in (x1, x64)])
        if np.array_equal(want_unix, want_ms):
            raise AssertionError("[wire] the two m3 weight sets are not distinct")

        def served(name):
            url = f"http://127.0.0.1:{ports[name]}/api/v0.1/predictions"
            return np.concatenate([check_answer(*request("POST", url, ndarray(x)), len(x),
                                                "ndarray") for x in (x1, x64)])

        before_unix = remote_launches_uds(m3_uds)
        fused_mlp.LAUNCHES = 0
        got = {"unix": served("unix"), "grpc": served("grpc")}
        local = fused_mlp.LAUNCHES
        unix_remote = remote_launches_uds(m3_uds) - before_unix
        errs = {"unix": float(np.abs(got["unix"] - want_unix).max()),
                "grpc": float(np.abs(got["grpc"] - want_ms).max())}
        if max(errs.values()) > HOST_ATOL or (counted and (local != 3 * 4 or unix_remote != 2)):
            raise AssertionError(f"[wire] ensemble4 remote m3 vs fused {errs} (bound "
                                 f"{HOST_ATOL}); {local} launches in this process, "
                                 f"{unix_remote} in the unix engine")
        # the 1-row p50s of the gRPC-remote and the REST-remote graph, in turns
        walls = {"grpc": [], "rest": []}
        for name in ("grpc", "rest", "rest", "grpc"):
            walls[name] += keepalive_walls(ports[name], ndarray(x1), WIRE_P50_REQUESTS)
        rest_err = float(np.abs(served("rest") - want_ms).max())
        remote_p50 = {k: float(np.median(w)) * 1e3 for k, w in walls.items()}
        grpc_remote_calls = 2 + len(walls["grpc"])
        grpc_ms_out = stop_service(grpc_ms)
        ms_launches = int(grpc_ms_out.split("fused_mlp_softmax launches: ")[1].split(")")[0])
        # the probe at the unit's construction is its first launch
        if rest_err > HOST_ATOL or (counted and ms_launches != 1 + grpc_remote_calls):
            raise AssertionError(f"[wire] the REST-remote graph vs fused {rest_err:.3e}; the "
                                 f"gRPC microservice launched {ms_launches} times for "
                                 f"{grpc_remote_calls} calls: {grpc_ms_out[-300:]}")
        # m3 stopped: the quorum-3 ensemble degrades until the breaker opens
        url_q = f"http://127.0.0.1:{ports['grpc_quorum']}/api/v0.1/predictions"
        degraded = 0
        while engines["grpc_quorum"].open_breakers() != ["m3"]:
            degraded += 1
            if degraded > HOST_BREAKER_TRIES:
                raise AssertionError(f"[wire] m3's breaker did not open in "
                                     f"{HOST_BREAKER_TRIES} degraded requests")
            st, raw = request("POST", url_q, ndarray(x1))
            check_answer(st, raw, 1, "ndarray")
            if json.loads(raw)["meta"].get("tags") != {"seldon.degraded.ensemble": ["m3"]}:
                raise AssertionError(f"[wire] degraded answer's meta {json.loads(raw)['meta']}")
        ready = request("GET", f"http://127.0.0.1:{ports['grpc_quorum']}/ready")
        if ready != (200, b"ready (breakers open: m3)"):
            raise AssertionError(f"[wire] /ready after the stop: {ready}")
        out.update(remote_vs_fused=errs, rest_remote_vs_fused=rest_err,
                   remote_p50_ms=remote_p50, degraded_requests_until_open=degraded,
                   remote_launches={"grpc_microservice": ms_launches - 1,
                                    "unix_engine": unix_remote})
        out["launches"]["ensemble4"] = local
        log(f"[wire] ensemble4 with m3 behind `microservice MnistClassifier GRPC` (a subprocess "
            f"on {dev.type}) and behind a second engine's ENGINE_HTTP_UDS_PATH (unix:{m3_uds}): "
            f"within {errs['grpc']:.3e} and {errs['unix']:.3e} of fused (bound {HOST_ATOL}); "
            f"{local} launches here (3 a request), {unix_remote} in the unix engine, "
            f"{ms_launches - 1} in the gRPC microservice for its {grpc_remote_calls} calls "
            f"(its probe aside); after the microservice stopped, a quorum-3 ensemble answered "
            f"{degraded} degraded requests tagged seldon.degraded.ensemble=['m3'] until m3's "
            f"breaker opened, /ready {ready[1].decode()!r}")
        log(f"[times] ensemble4 1-row p50 over {2 * WIRE_P50_REQUESTS} keepalive requests each, "
            f"in turns: m3 over gRPC {remote_p50['grpc']:.3f} ms, over REST (the binary wire) "
            f"{remote_p50['rest']:.3f} ms; on {smi}")
    finally:
        for srv in servers.values():
            srv.stop(close_engine=False)
        for e in (fused, *engines.values()):
            if e is not None:
                e.close()
        for proc in (grpc_ms, rest_ms, m3_engine):
            stop_service(proc)
        m3_file.unlink()
    out["card"] = smi
    log(f"[wire] phase wall {time.perf_counter() - t_phase:.2f} s")
    return out


def json_rows(text: str) -> np.ndarray:
    """The rows of a JSON answer, ndarray or tensor, as float64."""
    data = json.loads(text)["data"]
    if "ndarray" in data:
        return np.asarray(data["ndarray"], dtype=np.float64)
    return np.asarray(data["tensor"]["values"], dtype=np.float64).reshape(
        data["tensor"]["shape"])


def remote_launches_uds(path: str) -> int:
    """fused_mlp_softmax's launches in the engine behind the unix socket
    ``path`` (its /stats)."""
    conn = UnixHTTPConnection(path)
    try:
        conn.request("GET", "/stats")
        doc = json.loads(conn.getresponse().read())
    finally:
        conn.close()
    return int(doc["kernels"]["fused_mlp_softmax"]["launches"])



# ---------------------------------------------------------------------------
# 10o. observability: the flight recorder, Prometheus, the tracer, the perf
# observatory, the spine and /genperf on the card
# ---------------------------------------------------------------------------

OBS_ONE_ROW = 200          # keepalive 1-row requests with every observatory on
OBS_BATCHES = 8            # 64-row requests after them
OBS_PROFILED = 20          # requests inside the profile window
OBS_TURNS = 2              # ABBA turns of the overhead comparison (200 requests a wall)
OBS_SPAN_WAIT_S = 5.0      # how long a remote call's client span may take to be recorded
OBS_TRACE_COVER = 0.9      # the critical path's share of the root span's wall, at least
OBS_ACCOUNTED = 0.95       # host + device + bubble share of the scheduler's wall, at least
MLP_SYMBOL = "fused_mlp_softmax_kernel"


def parse_prometheus(text: str):
    """The text format (0.0.4): ``({family: type}, [(sample, {label: value},
    value)])``; enough of a parser for the port's own exposition."""
    import re

    types, samples = {}, []
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split(" ", 3)
            types[name] = typ
        elif line and not line.startswith("#"):
            head, _, value = line.rpartition(" ")
            name, _, labels = head.partition("{")
            samples.append((name, dict(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', labels)),
                            float(value)))
    return types, samples


def sample_sum(samples, name: str, **match) -> float:
    return sum(v for n, lbl, v in samples
               if n == name and all(lbl.get(k) == w for k, w in match.items()))


def get_json(port: int, path: str, method: str = "GET", body=None):
    status, raw = request(method, f"http://127.0.0.1:{port}{path}", body)
    if status != 200:
        raise AssertionError(f"[obs] {method} {path}: HTTP {status}: {raw[:300]!r}")
    return json.loads(raw)


def observatories(on: bool) -> None:
    """Every observatory of the process on (tracing at sample 1) or off:
    what SELDON_TPU_TRACE=1 / SELDON_TPU_TRACE_SAMPLE=1 and
    SELDON_TPU_TELEMETRY=0, SELDON_TPU_TRACE=0, SELDON_TPU_PERF=0 set at
    import, set here on the live singletons."""
    from seldon_core_tpu_torch.utils.hotrecord import SPINE
    from seldon_core_tpu_torch.utils.perf import OBSERVATORY
    from seldon_core_tpu_torch.utils.tracing import TRACER

    TRACER.enabled = on
    TRACER.sample = 1.0
    SPINE.telemetry_enabled = on
    OBSERVATORY.enabled = on


def obs_mnist(torch, dev, fused_mlp, smi) -> dict:
    """Part 1: MNIST with every observatory on, over REST."""
    from seldon_core_tpu_torch.utils.hotrecord import SPINE
    from seldon_core_tpu_torch.utils.metrics import MetricsRegistry
    from seldon_core_tpu_torch.utils.perf import OBSERVATORY
    from seldon_core_tpu_torch.utils.tracing import TRACER

    observatories(True)
    SPINE.drain()
    TRACER.clear()
    OBSERVATORY.reset()
    engine = mode_engine(torch, dev, example_doc("mnist"), continuous=False)
    unit = engine.compiled.units["mnist"]
    server = ServerThread(engine)
    port = server.start()
    out = {}
    try:
        rng = np.random.default_rng(SEED + 41)
        x1 = rng.random((1, 784))
        x64 = rng.random((64, 784))
        _, before = parse_prometheus(request("GET", f"http://127.0.0.1:{port}/prometheus")[1]
                                     .decode())
        fused_mlp.LAUNCHES = 0
        walls = keepalive_walls(port, ndarray(x1), OBS_ONE_ROW)
        walls64 = keepalive_walls(port, ndarray(x64), OBS_BATCHES)
        launches = fused_mlp.LAUNCHES
        sent = OBS_ONE_ROW + OBS_BATCHES
        status, raw = request("GET", f"http://127.0.0.1:{port}/prometheus")
        types, samples = parse_prometheus(raw.decode())
        families = {n for n in types if not n.endswith("_created")}
        if status != 200 or families != set(MetricsRegistry.family_names()):
            raise AssertionError(f"[obs] /prometheus families differ from family_names(): "
                                 f"{sorted(families ^ set(MetricsRegistry.family_names()))}")
        served = sample_sum(samples, "seldon_api_engine_server_requests_duration_seconds_count",
                            service="predictions")
        dispatch_n = {k: sample_sum(samples, "seldon_tpu_dispatch_seconds_count",
                                    executable=f"predict[{b}x784/float32]")
                      - sample_sum(before, "seldon_tpu_dispatch_seconds_count",
                                   executable=f"predict[{b}x784/float32]")
                      for k, b in (("1", 1), ("64", 64))}
        perf = get_json(port, "/perf")
        rows = {r["executable"]: r for r in perf["executables"]}
        r1, r64 = rows.get("predict[1x784/float32]"), rows.get("predict[64x784/float32]")
        if r1 is None or r64 is None:
            raise AssertionError(f"[obs] /perf rows: {sorted(rows)}")
        calls = r1["calls"] + r64["calls"]
        dims = unit.dims
        hand = {b: 2.0 * b * sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
                for b in (1, 64)}
        peaks = perf["device"]
        hbm = perf["hbm"][0]
        limit = torch.cuda.mem_get_info(dev)[1]
        checks = {
            "served == sent": served == sent,
            "dispatch histogram == dispatches": dispatch_n == {"1": OBS_ONE_ROW,
                                                               "64": OBS_BATCHES},
            "perf calls == launches == sent": calls == launches == sent,
            "flops == hand count": (r1["flops"], r64["flops"]) == (hand[1], hand[64]),
            "0 < mfu <= 1": all(0 < r["mfu"] <= 1 for r in (r1, r64)),
            "peaks name the card": (peaks["device_kind"] == torch.cuda.get_device_name(dev)
                                    and peaks["platform"] == "gpu"
                                    and peaks["peak_assumed"] is False),
            "hbm": hbm.get("bytes_in_use", 0) > 0 and hbm.get("bytes_limit") == limit,
        }
        if not all(checks.values()):
            raise AssertionError(f"[obs] MNIST checks failed: {checks}; served {served}, "
                                 f"dispatches {dispatch_n}, calls {calls}, launches {launches}, "
                                 f"flops {(r1.get('flops'), r64.get('flops'))} vs {hand}, "
                                 f"peaks {peaks}, hbm {hbm} vs limit {limit}")
        log(f"[obs] MNIST ({dims}, bf16) over REST, every observatory on: {OBS_ONE_ROW} 1-row "
            f"and {OBS_BATCHES} 64-row keepalive requests; /prometheus's {len(families)} families "
            f"are family_names(), the server histogram counts {served:.0f} requests, the dispatch "
            f"histogram {dispatch_n}; /perf: {calls} calls == {launches} fused-MLP launches, "
            f"FLOPs the hand count, MFU {r1['mfu']} (1 row) and {r64['mfu']} (64 rows, "
            f"{r64['bound']}-bound), p50 {r1['latency_ms']['p50']} / {r64['latency_ms']['p50']} ms "
            f"wall to readback; peaks {peaks['peak_bf16_tflops']} TFLOP/s and "
            f"{peaks['peak_hbm_gbs']} GB/s (not assumed); memory {hbm['bytes_in_use']} of "
            f"{hbm['bytes_limit']} bytes, peak {hbm['peak_bytes_in_use']} ({smi})")
        out["mnist"] = {"requests": sent, "dispatches": calls, "launches": launches,
                        "mfu_1row": r1["mfu"], "mfu_64row": r64["mfu"],
                        "bound_1row": r1.get("bound"), "bound_64row": r64.get("bound"),
                        "dispatch_p50_ms": {"1": r1["latency_ms"]["p50"],
                                            "64": r64["latency_ms"]["p50"]},
                        "request_p50_ms": {"1": float(np.median(walls)) * 1e3,
                                           "64": float(np.median(walls64)) * 1e3},
                        "hbm": hbm, "families": len(families)}

        # one request's tree, and the export
        puid = "obs-trace"
        status, raw = request("POST", f"http://127.0.0.1:{port}/api/v0.1/predictions",
                              {"meta": {"puid": puid}, "data": {"ndarray": x1.tolist()}})
        check_answer(status, raw, 1, "ndarray")
        doc = get_json(port, f"/trace?puid={puid}")
        spans = doc["spans"]
        roots = [s for s in spans if not s.get("parent_span_id")]
        root = roots[0] if len(roots) == 1 else None
        names = sorted((s["name"], s.get("parent_span_id") == (root or {}).get("span_id"))
                       for s in spans if s is not root)
        covered = sum(seg["self_ms"] for seg in doc["critical_path"])
        if (root is None or root["name"] != "request" or root["kind"] != "request"
                or names != [("batch_queue", True), ("dispatch", True)]
                or len({s["trace_id"] for s in spans}) != 1
                or covered < OBS_TRACE_COVER * doc["root_duration_ms"]):
            raise AssertionError(f"[obs] /trace?puid=: roots {roots}, children {names}, "
                                 f"critical path {covered} of {doc.get('root_duration_ms')} ms")
        export = get_json(port, f"/trace/export?puid={puid}")
        if not export.get("traceEvents"):
            raise AssertionError("[obs] /trace/export has no events")
        log(f"[obs] /trace?puid={puid}: one tree, request -> (batch_queue, dispatch) across the "
            f"batcher and the dispatch thread, trace {root['trace_id']}; critical path "
            f"{covered:.3f} of {doc['root_duration_ms']} ms; phases {doc['phases']}; "
            f"/trace/export {len(export['traceEvents'])} Chrome trace events")
        out["trace"] = {"root_ms": doc["root_duration_ms"], "critical_path_ms": covered,
                        "phases": doc["phases"]}

        out["profile"] = obs_profile_window(dev, x1, smi)

        # the overhead in turns: everything on, everything off, ABBA
        p50 = {"on": [], "off": []}
        for turn in range(OBS_TURNS):
            for mode in (("on", "off") if turn % 2 == 0 else ("off", "on")):
                observatories(mode == "on")
                p50[mode].append(keepalive_p50_ms(port, ndarray(x1), OBS_ONE_ROW))
        observatories(True)
        over = get_json(port, "/overhead")
        out["overhead"] = {"p50_ms_on": p50["on"], "p50_ms_off": p50["off"],
                           "framework_p50_ms": over["framework_p50_ms"],
                           "budget_ms": over["budget_ms"],
                           "within_budget": over["within_budget"]}
        log(f"[obs] MNIST 1-row p50 over {OBS_ONE_ROW} keepalive requests, ABBA: every "
            f"observatory on {[round(v, 4) for v in p50['on']]} ms, all off "
            f"{[round(v, 4) for v in p50['off']]} ms; /overhead framework_p50_ms "
            f"{over['framework_p50_ms']} against the {over['budget_ms']} ms budget (reported, "
            f"not gated; {smi})")
        # the 208 requests', the traced one's and the turns'
        out["launches"] = fused_mlp.LAUNCHES
    finally:
        server.stop()
    return out


def obs_profile_window(dev, x1, smi) -> dict:
    """The profile window over 20 requests, in an engine of its own
    (`engine_main` serving the MNIST example on the card, a process that
    has run no profiler before): a process that has already traced many
    launches loses some of a later session's device records (this script's
    own phases 4-14 left half of them unrecorded), so the check of one
    kernel event a dispatch is made where a window is the first session."""
    pid = os.getpid()
    port = free_port()
    prof_dir = f"/tmp/sct_obs_prof_{pid}"
    proc, _ = start_service(
        ["seldon_core_tpu_torch.runtime.engine_main", "--file",
         str(ROOT / "examples" / "mnist_deployment.json"), "--device", dev.type, "--host",
         "127.0.0.1", "--rest-port", str(port)],
        {"SELDON_TPU_PROFILE_DIR": prof_dir, "ENGINE_SERVER_GRPC_PORT": str(free_port()),
         "SELDON_TPU_TRACE": "1"}, "engine up:")
    try:
        keepalive_walls(port, ndarray(x1), 3)  # the first calls' set-up outside the window

        def launches() -> int:
            return int(get_json(port, "/stats")["kernels"]["fused_mlp_softmax"]["launches"])

        start = get_json(port, "/profile/start", "POST", {"duration_s": 120})
        busy, _ = request("POST", f"http://127.0.0.1:{port}/profile/start", {})
        before = launches()
        keepalive_walls(port, ndarray(x1), OBS_PROFILED)
        in_window = launches() - before
        stop = get_json(port, "/profile/stop", "POST", {})["last"]
        if busy != 409 or "error" in stop or not stop.get("artifact"):
            raise AssertionError(f"[obs] profile window: second start {busy}, stop {stop}")
        events = json.loads(Path(stop["artifact"]).read_text()).get("traceEvents", [])
        kernels = [e for e in events if e.get("cat") == "kernel"
                   and MLP_SYMBOL in str(e.get("name", ""))]
        if (len(kernels) != in_window or in_window != OBS_PROFILED
                or stop["launch_records"] != in_window):
            cats: dict = {}
            for e in events:
                cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
            raise AssertionError(f"[obs] the window's artifact names {MLP_SYMBOL} "
                                 f"{len(kernels)} times for {in_window} dispatches "
                                 f"(events by category {cats}; the window {stop})")
        status = get_json(port, "/profile")
        if status["active"] is not False:
            raise AssertionError(f"[obs] /profile after stop: {status}")
    finally:
        stop_service(proc)
    log(f"[obs] profile window {start['window']} in an engine_main of its own: a second start "
        f"answered 409; {OBS_PROFILED} requests, {in_window} fused-MLP launches there, "
        f"{len(kernels)} {MLP_SYMBOL} device events and {stop['launch_records']} launch "
        f"calls in its artifact ({stop['events']} events, {stop['device_events']} on the card; "
        f"{smi})")
    return {"dispatches": in_window, "kernel_events": len(kernels), "events": stop["events"],
            "device_events": stop["device_events"]}


def obs_across_processes(torch, dev, fused_mlp, smi) -> dict:
    """Part 2: ensemble4 in host mode with m3 behind the unit microservice
    (REST, so the binary wire; gRPC) and behind an engine's unix socket:
    one traced request each, its spans at m3's process under the engine's
    client span."""
    from seldon_core_tpu_torch.utils.tracing import TRACER

    observatories(True)
    doc = example_doc("ensemble4")
    pid = os.getpid()
    seed3 = json.dumps([p.to_json_dict() for p in _seed3()])
    rest_port, grpc_port, grpc_http = free_port(), free_port(), free_port()
    m3_rest, m3_uds = free_port(), f"/tmp/sct_obs_m3_{pid}.sock"
    m3_file = Path(f"/tmp/sct_obs_m3_{pid}.json")
    m3_file.write_text(json.dumps({"spec": {"name": "m3", "predictors": [{
        "name": "main", "components": [c for c in doc["spec"]["predictors"][0]["components"]
                                       if c["name"] == "m3"],
        "graph": {"name": "m3", "type": "MODEL"}}]}}))
    traced = {"SELDON_TPU_TRACE": "1", "SELDON_TPU_TRACE_SAMPLE": "1.0"}
    with ThreadPoolExecutor(3) as pool:
        futs = [pool.submit(start_service, *a) for a in [
            (["seldon_core_tpu_torch.runtime.microservice", "MnistClassifier", "REST",
              "--port", str(rest_port), "--parameters", seed3, "--device", dev.type], traced,
             "unit up:"),
            (["seldon_core_tpu_torch.runtime.microservice", "MnistClassifier", "GRPC",
              "--port", str(grpc_port), "--http-port", str(grpc_http), "--parameters", seed3,
              "--device", dev.type], traced, "unit up:"),
            (["seldon_core_tpu_torch.runtime.engine_main", "--file", str(m3_file), "--device",
              dev.type, "--host", "127.0.0.1", "--rest-port", str(m3_rest)],
             {**traced, "ENGINE_SERVER_GRPC_PORT": str(free_port()),
              "ENGINE_HTTP_UDS_PATH": m3_uds}, "engine up:")]]
    errors = [f.exception() for f in futs]
    procs = [f.result()[0] for f, e in zip(futs, errors) if e is None]
    out = {}
    engines = {}
    try:
        if any(errors):
            raise next(e for e in errors if e is not None)
        lanes = {
            "rest (binary wire)": ({"runtime": "rest", "host": "127.0.0.1", "port": rest_port},
                                   rest_port, "server"),
            "grpc": ({"runtime": "grpc", "host": "127.0.0.1", "port": grpc_port}, grpc_http,
                     "server"),
            "unix": ({"runtime": "rest", "host": f"unix:{m3_uds}"}, m3_rest, "request"),
        }
        x = np.random.default_rng(SEED + 42).random((1, 784))
        for lane, (binding, _, _) in lanes.items():
            d = json.loads(json.dumps(doc))
            comps = d["spec"]["predictors"][0]["components"]
            comps[[c["name"] for c in comps].index("m3")] = {"name": "m3", **binding}
            engines[lane] = mode_engine(torch, dev, d, continuous=False)
            if engines[lane].mode != "host":
                raise AssertionError(f"[obs] ensemble4 with a remote m3: mode "
                                     f"{engines[lane].mode}")
        fused_mlp.LAUNCHES = 0  # after the engines' probes: the requests' launches
        for lane, (binding, trace_port, remote_kind) in lanes.items():
            engine = engines[lane]
            puid = f"obs-{lane.split()[0]}"
            msg = json.dumps({"meta": {"puid": puid}, "data": {"ndarray": x.tolist()}})
            text, status = asyncio.run(engine.predict_json(msg))
            if status != 200:
                raise AssertionError(f"[obs] {lane}: HTTP {status}: {text[:300]}")
            # the client span is recorded when the remote call's context
            # exits, which may come after the answer is handed back: wait
            # (bounded) for it to land before counting
            deadline = time.perf_counter() + OBS_SPAN_WAIT_S
            while True:
                settle_spine()
                spans = TRACER.trace(puid)
                client = [s for s in spans if s.kind == "client" and s.name == "m3"]
                if client or time.perf_counter() > deadline:
                    break
                time.sleep(0.01)
            if len(client) != 1:
                raise AssertionError(f"[obs] {lane}: client spans {client}")
            client = client[0]
            remote = get_json(trace_port, f"/trace?trace_id={client.trace_id}")["spans"]
            far = [s for s in remote if s["kind"] == remote_kind]
            if (len(far) != 1 or far[0]["parent_span_id"] != client.span_id
                    or any(s["trace_id"] != client.trace_id for s in remote)):
                raise AssertionError(f"[obs] {lane}: m3's spans {remote} do not hang under the "
                                     f"engine's client span {client.span_id}")
            out[lane] = {"trace_id": client.trace_id, "remote_spans": len(remote),
                         "client_ms": round(client.duration_ms, 3),
                         "remote_ms": far[0]["duration_ms"],
                         "transport": client.attrs.get("transport")}
            log(f"[obs] ensemble4, m3 over {lane}: trace {client.trace_id}; at m3's process "
                f"{len(remote)} span(s) of that trace, its {remote_kind} span "
                f"({far[0]['duration_ms']} ms) the child of the engine's client span "
                f"({client.duration_ms:.3f} ms, transport {client.attrs.get('transport')})")
        out["launches"] = fused_mlp.LAUNCHES
    finally:
        for e in engines.values():
            e.close()
        for proc in procs:
            stop_service(proc)
        m3_file.unlink(missing_ok=True)
    return out


def obs_genperf(torch, dev, smi) -> dict:
    """Part 3: the flagship generator on the continuous lane, default
    knobs, behind /genperf."""
    from seldon_core_tpu_torch.ops import flash_decode as fd, kv_write as kw
    from seldon_core_tpu_torch.utils.genperf import GENPERF

    engine = mode_engine(torch, dev, gen_deployment(), continuous=True)
    g = engine.genserver
    cfg = engine.compiled.units["gen"].cfg
    server = ServerThread(engine)
    port = server.start()
    url = f"http://127.0.0.1:{port}/api/v0.1/predictions"
    rng = np.random.default_rng(SEED + 43)
    vocab = GEN_DIMS["vocab"]
    singles = [rng.integers(0, vocab, size=(1, GEN_S)) for _ in range(CONT_BURST)]
    batch = rng.integers(0, vocab, size=(GEN_B, GEN_S))
    try:
        GENPERF.reset()
        snap0 = g.snapshot()
        fd.PAGED_LAUNCHES = kw.PAGED_LAUNCHES = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(CONT_BURST + 1) as pool:
            futs = []
            for p in singles:
                futs.append(pool.submit(request, "POST", url, ndarray(p)))
                time.sleep(CONT_GAP_S)
            futs.append(pool.submit(request, "POST", url, ndarray(batch)))
            answers = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        paged, kvp = fd.PAGED_LAUNCHES, kw.PAGED_LAUNCHES
        for (status, raw), p in zip(answers, singles + [batch]):
            check_tokens(status, raw, p, "ndarray")
        snap = g.snapshot()
        doc = get_json(port, "/genperf")
    finally:
        server.stop()
    ticks = doc["ticks"]
    served = doc["served_decode"]
    acc = doc["accounting"]
    prefill_dispatches = snap["prefill_dispatches_total"] - snap0["prefill_dispatches_total"]
    steps = served["device_steps"]
    mfu = (served["served_decode_mfu_pct"] or 0.0) / 100.0
    bw = (served["served_decode_hbm_bw_util_pct"] or 0.0) / 100.0
    checks = {
        "prefill and decode ticks": ticks.get("prefill", 0) > 0 and (
            ticks.get("decode", 0) + ticks.get("mixed", 0)) > 0,
        "accounted": (acc["accounted_fraction"] or 0.0) >= OBS_ACCOUNTED,
        "0 < decode MFU <= 1": 0 < mfu <= 1,
        "0 < HBM share <= 1": 0 < bw <= 1,
        "paged launches == layers x steps": paged == cfg.n_layers * steps and steps > 0,
        "steps == the scheduler's": steps == snap["decode_steps_total"] - snap0[
            "decode_steps_total"],
        "kv_write_paged == layers x prefill ticks": (
            kvp == cfg.n_layers * prefill_dispatches and 0 < prefill_dispatches
            <= ticks.get("prefill", 0) + ticks.get("mixed", 0)),
    }
    if not all(checks.values()):
        raise AssertionError(f"[obs] /genperf checks failed: {checks}; ticks {ticks}, "
                             f"accounting {acc}, served {served}, launches paged {paged} "
                             f"kv {kvp}, prefill dispatches {prefill_dispatches}")
    bubbles = doc["bubbles"]
    log(f"[obs] flagship generator, continuous lane (default knobs): {CONT_BURST} 1-row "
        f"{GEN_S}-token requests {CONT_GAP_S * 1e3:.0f} ms apart and one {GEN_B}-row request in "
        f"{wall:.3f} s; /genperf ticks {ticks}; host {acc['host_s']} + device {acc['device_s']} "
        f"+ bubble {acc['bubble_s']} s = {acc['accounted_fraction']} of the scheduler's "
        f"{acc['scheduler_wall_s']} s; served decode MFU {mfu:.6f}, HBM-bandwidth share "
        f"{bw:.6f} ({served['real_tokens']} real tokens over {served['decode_device_s']} s "
        f"of decode wall to readback, {served['served_decode_tok_s_device']} tok/s); bubble "
        f"share {bubbles['fraction']} by cause {bubbles['by_cause_s']}; flash_decode_paged "
        f"{paged} launches = {cfg.n_layers} x {steps} decode steps, kv_write_paged {kvp} = "
        f"{cfg.n_layers} x {prefill_dispatches} prefill ticks ({smi})")
    return {"ticks": ticks, "accounting": acc, "served_decode_mfu": mfu,
            "served_decode_hbm_share": bw, "bubble_fraction": bubbles["fraction"],
            "bubbles_s": bubbles["by_cause_s"], "decode_steps": steps,
            "prefill_ticks": prefill_dispatches, "wall_s": wall,
            "launches": {"flash_decode_paged": paged, "kv_write_paged": kvp},
            "tok_s_device": served["served_decode_tok_s_device"]}


def observability_phase(torch, dev, smi) -> dict:
    """Phase 10o: the observability slice on the card, after every phase
    that opens a torch.profiler session of its own."""
    from seldon_core_tpu_torch.ops import fused_mlp

    t0 = time.perf_counter()
    mnist = obs_mnist(torch, dev, fused_mlp, smi)
    across = obs_across_processes(torch, dev, fused_mlp, smi)
    across_launches = across.pop("launches")
    gen = obs_genperf(torch, dev, smi)
    observatories(False)
    out = {"mnist": mnist.pop("mnist"), "trace": mnist.pop("trace"),
           "profile": mnist.pop("profile"), "overhead": mnist.pop("overhead"),
           "across_processes": across, "genperf": gen, "card": smi,
           "launches": {"fused_mlp_softmax": mnist["launches"] + across_launches,
                        **gen["launches"]},
           "wall_s": time.perf_counter() - t0}
    log(f"[obs] phase 10o wall {out['wall_s']:.2f} s")
    return out


QC_BATCH = 64              # rows a request in the drift part
QC_REF_BATCHES = 4         # 256 reference rows: SELDON_TPU_QUALITY_REF_ROWS' default
QC_LIVE_BATCHES = 8        # requests from the reference's distribution, then shifted
QC_SLO_P99_MS = 1.0        # the latency objective: a 64-row request's wall is over it
QC_NO_DRIFT_PSI_MAX = 0.25     # the classic "significant shift" PSI, per feature
QC_NO_DRIFT_PSI_MEAN = 0.1     # the classic "no shift" PSI, over the 784 features
QC_SHIFT_RATIO = 1.5           # psi_mean after the shift against before it, at least
QC_ROUTER_REQUESTS = 12
QC_OUTLIER_REQUESTS = 6
QC_IDENTITY_S = 1e-6       # /costs' accounting identity, seconds
QC_PM_POOL_BLOCKS = 640    # the 32-row 512-token request needs up to 1,152 blocks of 16
QC_PM_SLO_SHARE = 0.5      # the postmortem SLO budget: this share of the 32-row wall


def request_headers(method: str, url: str, body, headers: dict):
    """``request`` with extra headers (a tenant)."""
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(), method=method,
        headers={"Content-Type": "application/json", **headers})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def qc_switches(on: bool) -> None:
    """The [4b] consumers on or off, what SELDON_TPU_QUALITY,
    SELDON_TPU_COSTLEDGER and SELDON_TPU_POSTMORTEM set at import, set here
    on the live singletons (the ledger's switch is read per flush)."""
    from seldon_core_tpu_torch.utils.postmortem import POSTMORTEM
    from seldon_core_tpu_torch.utils.quality import QUALITY
    from seldon_core_tpu_torch.utils.tracing import TRACER

    QUALITY.enabled = on
    QUALITY.sample = 1.0
    os.environ["SELDON_TPU_COSTLEDGER"] = "1" if on else "0"
    POSTMORTEM.enabled = on
    TRACER.pm_hook = POSTMORTEM.offer if on else None


class FoldWalls:
    """The wall of each quality fold on the drainer thread (the window's
    state and the batch's rows beside it), while the block runs: what
    ``/overhead``'s single quality reservoir mixes together."""

    def __enter__(self):
        from seldon_core_tpu_torch.utils.quality import QUALITY

        self.rows, self._q = [], QUALITY
        orig = self._orig = QUALITY._observe

        def timed(node, X, Y, real_rows, ready=None):
            ent = QUALITY._nodes.get(node)
            frozen = bool(ent is not None and ent.frozen)
            t0 = time.perf_counter()
            try:
                return orig(node, X, Y, real_rows, ready)
            finally:
                self.rows.append((frozen, int(np.shape(X)[0]), time.perf_counter() - t0))

        QUALITY._observe = timed
        return self

    def __exit__(self, *exc):
        from seldon_core_tpu_torch.utils.hotrecord import SPINE

        SPINE.drain()
        self._q._observe = self._orig

    def p50_us(self, frozen: bool, rows: int) -> dict:
        w = np.asarray([r[2] for r in self.rows if r[0] == frozen and r[1] == rows]) * 1e6
        return {"folds": len(w), "p50_us": round(float(np.median(w)), 1) if len(w) else None,
                "p90_us": round(float(np.percentile(w, 90)), 1) if len(w) else None}


def qc_node_row(doc: dict, node: str) -> dict:
    rows = [r for r in doc["nodes"] if r["node"] == node]
    if len(rows) != 1:
        raise AssertionError(f"[quality] /quality has no single {node!r} row: {doc['nodes']}")
    return rows[0]


def qc_quality_after(port: int, live_rows: int, timeout_s: float = 30.0) -> dict:
    """``/quality`` once MNIST's window holds ``live_rows`` live rows: the
    drainer summarizes each sampled batch on the card after its answer is
    sent, so a read right after the last request can see only some of them
    (a card run read 192 of 512 rows and so a noisier psi).  Returns the
    last document read when ``timeout_s`` passes first."""
    end = time.perf_counter() + timeout_s
    while True:
        doc = get_json(port, "/quality")
        if (qc_node_row(doc, "mnist").get("live_rows", 0) >= live_rows
                or time.perf_counter() > end):
            return doc
        time.sleep(0.01)


def qc_drift(torch, dev, smi, counted: bool) -> dict:
    """Part 1: MNIST's drift window, the device summarizer and the SLO
    burn, over REST."""
    from seldon_core_tpu_torch.ops import fused_mlp
    from seldon_core_tpu_torch.utils.hotrecord import SPINE
    from seldon_core_tpu_torch.utils.quality import QUALITY, _summarize_np

    SPINE.drain()
    QUALITY.reset()
    QUALITY.ref_target = QC_REF_BATCHES * QC_BATCH
    QUALITY.slo.p99_ms = QC_SLO_P99_MS  # SELDON_TPU_SLO_P99_MS, read at import
    engine = mode_engine(torch, dev, example_doc("mnist"), continuous=False)
    server = ServerThread(engine)
    port = server.start()
    rng = np.random.default_rng(SEED + 91)
    ref = [rng.normal(size=(QC_BATCH, 784)) for _ in range(QC_REF_BATCHES)]
    same = [rng.normal(size=(QC_BATCH, 784)) for _ in range(QC_LIVE_BATCHES)]
    shifted = [rng.normal(size=(QC_BATCH, 784)) * 1.5 + 0.3 for _ in range(QC_LIVE_BATCHES)]
    try:
        fused_mlp.LAUNCHES = 0
        t0 = time.perf_counter()
        with FoldWalls() as folds:
            for x in ref + same:
                keepalive_walls(port, ndarray(x), 1)
            after_same = qc_quality_after(port, QC_LIVE_BATCHES * QC_BATCH)
            for x in shifted:
                keepalive_walls(port, ndarray(x), 1)
        wall = time.perf_counter() - t0
        device_fold = folds.p50_us(True, QC_BATCH)
        after_shift = qc_quality_after(port, 2 * QC_LIVE_BATCHES * QC_BATCH)
        launches = fused_mlp.LAUNCHES
        _, samples = parse_prometheus(request("GET", f"http://127.0.0.1:{port}/prometheus")[1]
                                      .decode())
        drift_gauge = sample_sum(samples, "seldon_tpu_drift_score", node="mnist", method="psi")
        burn_gauge = sample_sum(samples, "seldon_tpu_slo_burn_rate", window="5m")
        ent = QUALITY._nodes["mnist"]
        zeros = np.zeros((QC_BATCH, 10))
        want = sum(_summarize_np(x, zeros, ent.x_thr, ent.y_thr, QC_BATCH)[0]
                   for x in same + shifted)
        qs = np.arange(1, QUALITY.n_bins) / QUALITY.n_bins
        thr = np.quantile(np.concatenate(ref), qs, axis=0).T.astype(np.float32)
        counts_equal = bool(np.array_equal(ent.live_x_counts, want)
                            and np.array_equal(ent.x_thr, thr))
        rows_by_path = dict(QUALITY.summarizer_rows)
        errors = QUALITY.errors
        reset = get_json(port, "/quality/reference?action=reset", "POST", {})
        after_reset = qc_node_row(get_json(port, "/quality"), "mnist")
        stats = get_json(port, "/stats")
    finally:
        server.stop()
    r1, r2 = qc_node_row(after_same, "mnist"), qc_node_row(after_shift, "mnist")
    d1, d2 = r1["drift"], r2["drift"]
    sent = QC_REF_BATCHES + 2 * QC_LIVE_BATCHES
    checks = {
        "frozen window": (r1["status"] == "live" and r1["ref_rows"] == QC_REF_BATCHES * QC_BATCH
                          and r2["live_rows"] == 2 * QC_LIVE_BATCHES * QC_BATCH),
        "no drift before the shift": (d1["psi_max"] < QC_NO_DRIFT_PSI_MAX
                                      and d1["psi_mean"] < QC_NO_DRIFT_PSI_MEAN),
        "drift after the shift": (d2["psi_mean"] > QC_SHIFT_RATIO * d1["psi_mean"]
                                  and d2["psi_max"] > d1["psi_max"]
                                  and d2["ks_max"] > d1["ks_max"]),
        "x counts == _summarize_np's": counts_equal,
        "64-row batches on the device summarizer": (
            rows_by_path == {"torch": 2 * QC_LIVE_BATCHES * QC_BATCH, "numpy": 0}
            and errors == 0),
        "gauges non-zero": drift_gauge > 0 and burn_gauge > 0,
        "reset": (reset["nodes"] == {"mnist": "reset"}
                  and after_reset["status"] == "collecting_reference"
                  and after_reset["ref_rows"] == 0),
        "stats quality": stats["quality"]["nodes"]["mnist"]["status"] == "collecting_reference",
        "launches == dispatches": (launches == sent) if counted else True,
    }
    if not all(checks.values()):
        raise AssertionError(f"[quality] MNIST drift checks failed: {checks}; after the first "
                             f"{QC_LIVE_BATCHES} {r1}; after the shift {r2}; summarizer rows "
                             f"{rows_by_path}, errors {errors}; gauges drift {drift_gauge} burn "
                             f"{burn_gauge}; reset {reset} -> {after_reset}; launches {launches}")
    null_psi = (QUALITY.n_bins - 1) * (1 / (QC_REF_BATCHES * QC_BATCH)
                                       + 1 / (QC_LIVE_BATCHES * QC_BATCH))
    log(f"[quality] MNIST over REST, quality on at sample 1: {QC_REF_BATCHES} x {QC_BATCH} "
        f"reference rows (seeded normal) froze the window; after {QC_LIVE_BATCHES} more such "
        f"requests psi_max {d1['psi_max']} psi_mean {d1['psi_mean']} ks_max {d1['ks_max']} "
        f"prediction_psi {d1['prediction_psi']} (no shift: the null's expected psi_mean "
        f"{null_psi:.4f}); after {QC_LIVE_BATCHES} shifted (x1.5 + 0.3) psi_max {d2['psi_max']} "
        f"psi_mean {d2['psi_mean']} ks_max {d2['ks_max']} prediction_psi "
        f"{d2['prediction_psi']}; the live x counts equal _summarize_np's on the same rows, "
        f"the device summarizer served {rows_by_path['torch']} rows (numpy {rows_by_path['numpy']}), "
        f"errors {errors}; a {QC_BATCH}-row live fold (the device summarizer, wall on the "
        f"drainer thread) p50 {device_fold['p50_us']} us, p90 {device_fold['p90_us']}; "
        f"/prometheus drift {drift_gauge:.6f} burn(5m) {burn_gauge} at a "
        f"{QC_SLO_P99_MS} ms p99 target; reset -> {after_reset['status']}; {launches} fused-MLP "
        f"launches for {sent} dispatches; {wall:.3f} s ({smi})")
    return {"after_same": d1, "after_shift": d2, "null_psi_mean": null_psi,
            "summarizer_rows": rows_by_path, "device_fold_us": device_fold, "drift_gauge": drift_gauge, "burn_5m": burn_gauge,
            "launches": launches, "requests": sent}


def qc_router(torch, dev, smi, counted: bool) -> dict:
    """Part 2: epsilon_greedy with feedback, the routers rows from the
    card's router state."""
    from seldon_core_tpu_torch.ops import fused_mlp
    from seldon_core_tpu_torch.utils.hotrecord import SPINE
    from seldon_core_tpu_torch.utils.quality import QUALITY

    SPINE.drain()
    QUALITY.reset()
    engine = mode_engine(torch, dev, example_doc("epsilon_greedy"), continuous=False)
    server = ServerThread(engine)
    port = server.start()
    base = f"http://127.0.0.1:{port}/api/v0.1"
    rng = np.random.default_rng(SEED + 92)
    rewards, rows = [], 0
    try:
        fused_mlp.LAUNCHES = 0
        for i in range(QC_ROUTER_REQUESTS):
            x = rng.random((1 + i % 4, 784))
            st, raw = request("POST", f"{base}/predictions", ndarray(x))
            reward = round(float(rng.random()), 3)
            fst, _ = request("POST", f"{base}/feedback",
                             {"request": ndarray(x), "response": json.loads(raw),
                              "reward": reward})
            if st != 200 or fst != 200:
                raise AssertionError(f"[quality] router request {i}: HTTP {st}/{fst}")
            rewards.append(reward)
            rows += len(x)
        launches = fused_mlp.LAUNCHES
        qd = get_json(port, "/quality")
        stats = get_json(port, "/stats")
    finally:
        server.stop()
    state = engine.states()["eg-router"]
    tries = state["tries"].cpu().numpy().tolist()
    routers = qd["routers"]
    row = routers.get("eg-router", {})
    fb = qd["feedback"].get(engine.predictor.name, {})
    checks = {
        "one row, both branches": list(routers) == ["eg-router"] and len(row["branches"]) == 2,
        "state on the card": state["tries"].device.type == dev.type,
        "tries == the router's": [b["tries"] for b in row["branches"]] == tries
        and row["total_tries"] == rows,
        "/stats routers == /quality's": stats["routers"] == routers,
        "mean reward": (fb.get("count") == QC_ROUTER_REQUESTS
                        and fb.get("mean_reward") == round(float(np.mean(rewards)), 6)),
        "a launch a request": (launches == QC_ROUTER_REQUESTS) if counted else True,
    }
    if not all(checks.values()):
        raise AssertionError(f"[quality] router checks failed: {checks}; routers {routers}, "
                             f"state tries {tries}, feedback {fb}, rewards {rewards}")
    log(f"[quality] epsilon_greedy: {QC_ROUTER_REQUESTS} requests ({rows} rows) and feedbacks; "
        f"routers row read from the router's {state['tries'].device} state: tries {tries}, best "
        f"branch {row['best_branch']}, regret {row['total_regret']}; /stats' routers the same; "
        f"feedback mean reward {fb['mean_reward']} = the mean sent; {launches} fused-MLP "
        f"launches ({smi})")
    return {"routers": routers, "feedback": fb, "launches": launches}


def qc_outlier(torch, dev, smi, counted: bool) -> dict:
    """Part 3: outlier_pipeline, the outlier block counting the rows
    scored."""
    from seldon_core_tpu_torch.ops import fused_mlp
    from seldon_core_tpu_torch.utils.hotrecord import SPINE
    from seldon_core_tpu_torch.utils.quality import QUALITY

    SPINE.drain()
    QUALITY.reset()
    engine = mode_engine(torch, dev, example_doc("outlier_pipeline"), continuous=False)
    server = ServerThread(engine)
    port = server.start()
    rng = np.random.default_rng(SEED + 93)
    rows = 0
    try:
        fused_mlp.LAUNCHES = 0
        for i in range(QC_OUTLIER_REQUESTS):
            x = rng.random((3 + i, 784))
            st, raw = request("POST", f"http://127.0.0.1:{port}/api/v0.1/predictions",
                              ndarray(x))
            check_answer(st, raw, len(x), "ndarray")
            rows += len(x)
        launches = fused_mlp.LAUNCHES
        block = get_json(port, "/quality")["outliers"]
    finally:
        server.stop()
    if block["total"] != rows or block["scores"]["count"] != rows or (
            counted and launches != QC_OUTLIER_REQUESTS):
        raise AssertionError(f"[quality] outlier block {block} for {rows} rows scored, "
                             f"{launches} launches")
    log(f"[quality] outlier_pipeline: {QC_OUTLIER_REQUESTS} requests, {rows} rows scored, the "
        f"outlier block counts {block['total']} (score p50 {block['scores']['p50']:.3f}, max "
        f"{block['scores']['max']:.3f}); {launches} fused-MLP launches ({smi})")
    return {"rows": rows, "outliers": block, "launches": launches}


def qc_generator(torch, dev, smi, counted: bool, env=None, tenants=("acme", "globex"),
                 puid: str = "") -> tuple:
    """The flagship generator on the continuous lane: a warm-up request,
    then (the ledger and the postmortems reset) CONT_BURST 1-row
    GEN_S-token requests CONT_GAP_S apart, the tenants in turn, then one
    GEN_B-row request as the last tenant; returns the engine's /costs and
    /postmortems documents, the launches, the scheduler's deltas and the
    walls.  Without the warm-up the fresh engine's first prefill tick (the
    pool's allocation, the first calls of each op) is billed to whoever
    sends first."""
    from seldon_core_tpu_torch.ops import flash_decode as fd, kv_write as kw
    from seldon_core_tpu_torch.utils.costledger import LEDGER
    from seldon_core_tpu_torch.utils.hotrecord import SPINE
    from seldon_core_tpu_torch.utils.postmortem import POSTMORTEM

    engine = mode_engine(torch, dev, gen_deployment(), continuous=True, env=env)
    g = engine.genserver
    server = ServerThread(engine)
    port = server.start()
    url = f"http://127.0.0.1:{port}/api/v0.1/predictions"
    rng = np.random.default_rng(SEED + 94)
    vocab = GEN_DIMS["vocab"]
    singles = [rng.integers(0, vocab, size=(1, GEN_S)) for _ in range(CONT_BURST)]
    batch = rng.integers(0, vocab, size=(GEN_B, GEN_S))

    def send(rows, tenant, req_puid=""):
        body = ndarray(rows)
        if req_puid:
            body["meta"] = {"puid": req_puid}
        t = time.perf_counter()
        st, raw = request_headers("POST", url, body, {"Seldon-Tenant": tenant})
        return st, raw, time.perf_counter() - t

    try:
        check_tokens(*send(singles[0], "warmup")[:2], singles[0], "ndarray",
                     new=GEN_DIMS["max_new_tokens"], vocab=vocab)
        SPINE.drain()  # the warm-up's ticks and spans fold before the resets
        LEDGER.reset()
        POSTMORTEM.reset()
        snap0 = g.snapshot()
        fd.PAGED_LAUNCHES = kw.PAGED_LAUNCHES = 0
        with ThreadPoolExecutor(CONT_BURST + 1) as pool:
            futs = []
            for i, p in enumerate(singles):
                futs.append(pool.submit(send, p, tenants[i % len(tenants)]))
                time.sleep(CONT_GAP_S)
            futs.append(pool.submit(send, batch, tenants[-1], puid))
            answers = [f.result() for f in futs]
        paged, kvp = fd.PAGED_LAUNCHES, kw.PAGED_LAUNCHES
        for (status, raw, _), p in zip(answers, singles + [batch]):
            check_tokens(status, raw, p, "ndarray", new=GEN_DIMS["max_new_tokens"],
                         vocab=vocab)
        snap = g.snapshot()
        costs = get_json(port, "/costs")
        pms = get_json(port, f"/postmortems?puid={puid}") if puid else None
        pm_list = get_json(port, "/postmortems") if puid else None
    finally:
        server.stop()
    steps = snap["decode_steps_total"] - snap0["decode_steps_total"]
    prefill = snap["prefill_dispatches_total"] - snap0["prefill_dispatches_total"]
    preempted = snap["preempted_total"] - snap0["preempted_total"]
    n_layers = GEN_DIMS["n_layers"]
    if counted and (paged != n_layers * steps or kvp != n_layers * prefill or steps == 0):
        raise AssertionError(f"[costs] flash_decode_paged {paged} launches for {steps} decode "
                             f"steps, kv_write_paged {kvp} for {prefill} prefill ticks")
    return (costs, (pms, pm_list), {"flash_decode_paged": paged, "kv_write_paged": kvp},
            {"decode_steps": steps, "prefill_ticks": prefill, "preempted": preempted},
            [a[2] for a in answers])


def qc_costs(torch, dev, smi, counted: bool) -> dict:
    """Part 4: /costs bills both tenants through the continuous lane."""
    from seldon_core_tpu_torch.utils.costledger import LEDGER

    costs, _, launches, sched, walls = qc_generator(torch, dev, smi, counted)
    gap = abs(sum(LEDGER.device_s.values()) + sum(LEDGER.pad_tax_s.values()) + LEDGER.idle_s
              + LEDGER.unattributed_s - LEDGER.wall_s)
    acct = costs["accounting"]
    doc_gap = abs(acct["attributed_s"] + acct["pad_tax_s"] + acct["idle_s"]
                  + acct["unattributed_s"] - acct["device_wall_s"])
    rows = {r["tenant"]: r for r in costs["tenants"]}
    checks = {
        "identity": gap <= QC_IDENTITY_S,
        "accounted_fraction 1.0": acct["accounted_fraction"] == 1.0
        and acct["unattributed_s"] == 0.0,
        "both tenants billed": set(rows) == {"acme", "globex"} and all(
            r["device_s"].get("prefill", 0) > 0 and r["device_s"].get("decode", 0) > 0
            and r["kv_block_s"] > 0 for r in rows.values()),
        "devices": costs["capacity"]["chips"] == (torch.cuda.device_count()
                                                  if dev.type == "cuda" else 1),
    }
    if not all(checks.values()):
        raise AssertionError(f"[costs] checks failed: {checks}; identity gap {gap} s (document "
                             f"{doc_gap}); {costs}")
    log(f"[costs] flagship generator, continuous lane: {CONT_BURST} 1-row {GEN_S}-token "
        f"requests (acme, globex in turn) and one {GEN_B}-row (globex); /costs device wall "
        f"{acct['device_wall_s']} s = attributed {acct['attributed_s']} + pad tax "
        f"{acct['pad_tax_s']} + idle {acct['idle_s']} + unattributed {acct['unattributed_s']} "
        f"(identity gap {gap:.3e} s in the ledger, {doc_gap:.3e} s in the rounded document), "
        f"accounted_fraction {acct['accounted_fraction']}, {acct['folds']} folds; "
        + "; ".join(f"{t}: device_s {r['device_s']} pad {r['pad_tax_s']} kv_block_s "
                    f"{r['kv_block_s']} tokens {r['served_tokens']}" for t, r in rows.items())
        + f"; utilization {costs['capacity']['utilization']}; flash_decode_paged "
        f"{launches['flash_decode_paged']} = {GEN_DIMS['n_layers']} x {sched['decode_steps']} "
        f"decode steps, kv_write_paged {launches['kv_write_paged']} = {GEN_DIMS['n_layers']} x "
        f"{sched['prefill_ticks']} prefill ticks; the {GEN_B}-row request's wall "
        f"{walls[-1]:.3f} s ({smi})")
    return {"accounting": acct, "tenants": rows, "capacity": costs["capacity"],
            "identity_gap_s": gap, "launches": launches, "scheduler": sched,
            "walls_s": walls}


def qc_postmortem(torch, dev, smi, counted: bool, batch_wall_s: float) -> dict:
    """Part 5: tracing at sample 0, a postmortem SLO budget below the
    GEN_B-row request's wall and a pool small enough that it preempts: the
    request is kept though the head sampler dropped it."""
    from seldon_core_tpu_torch.utils.postmortem import POSTMORTEM
    from seldon_core_tpu_torch.utils.tracing import TRACER

    TRACER.enabled, TRACER.sample = True, 0.0
    budget_ms = QC_PM_SLO_SHARE * batch_wall_s * 1e3
    POSTMORTEM.slo_ms = budget_ms  # SELDON_TPU_POSTMORTEM_SLO_MS, read at import
    puid = "qc-pm-32"
    try:
        _, (pms, pm_list), launches, sched, walls = qc_generator(
            torch, dev, smi, counted, env={"SELDON_TPU_GEN_POOL_BLOCKS": str(QC_PM_POOL_BLOCKS)},
            tenants=("globex",), puid=puid)
        dropped = TRACER.trace(puid)
    finally:
        TRACER.sample = 1.0
    doc = pms.get("postmortem") or {}
    explain = doc.get("explain") or {}
    ledger = explain.get("gen_ledger") or []
    preempts = sum(1 for e in ledger for ev in e["events"] if ev["name"] == "preempt")
    kept = {s["puid"]: s for s in pm_list["kept"]}
    checks = {
        "sampled out at the head": dropped == [],
        "kept": pms["found"] and puid in kept and walls[-1] * 1e3 > budget_ms,
        "reasons": {"slo", "preemption"} <= set(doc.get("reasons", ())),
        "preempted": sched["preempted"] > 0 and preempts > 0,
        "guilty phase": explain.get("guilty_phase") is not None,
        "gen_seq slice": len(ledger) == GEN_B and all(e["name"] == "gen_sequence"
                                                      for e in ledger),
        "cost row": (explain.get("cost_row") or {}).get("tenant") == "globex",
    }
    if not all(checks.values()):
        raise AssertionError(f"[postmortem] checks failed: {checks}; summary {kept.get(puid)}; "
                             f"reasons {doc.get('reasons')}; explain "
                             f"{ {k: v for k, v in explain.items() if k != 'gen_ledger'} }; "
                             f"{len(ledger)} gen_seq spans; scheduler {sched}; walls {walls}")
    log(f"[postmortem] tracing at sample 0, SELDON_TPU_POSTMORTEM_SLO_MS {budget_ms:.1f} "
        f"({QC_PM_SLO_SHARE} x the {GEN_B}-row wall of part 4), a pool of {QC_PM_POOL_BLOCKS} "
        f"blocks: the {GEN_B}-row request ({walls[-1]:.3f} s, {sched['preempted']} preemptions) "
        f"is absent from the trace ring and kept: reasons {doc['reasons']}, guilty phase "
        f"{explain['guilty_phase']} (+{explain['excess_ms']} ms; phases {doc['phases']}), "
        f"{len(ledger)} gen_sequence spans ({preempts} preempt events), cost row "
        f"{explain['cost_row']['device_s']}; {doc['pinned_spans']} spans pinned; counters "
        f"{pm_list['counters']}; capture p50 {pm_list['capture_overhead_ms']} ms ({smi})")
    return {"reasons": doc["reasons"], "guilty_phase": explain["guilty_phase"],
            "excess_ms": explain["excess_ms"], "gen_seq_spans": len(ledger),
            "preempt_events": preempts, "counters": pm_list["counters"],
            "capture_overhead_ms": pm_list["capture_overhead_ms"], "launches": launches,
            "scheduler": sched, "budget_ms": budget_ms, "wall_s": walls[-1]}


def qc_overhead(torch, dev, smi, counted: bool) -> dict:
    """Part 6: the 1-row MNIST p50 with quality, the cost ledger and
    postmortem capture on and off, in turns (tracing on at sample 1 in
    both), beside /overhead's fold costs."""
    from seldon_core_tpu_torch.ops import fused_mlp

    engine = mode_engine(torch, dev, example_doc("mnist"), continuous=False)
    server = ServerThread(engine)
    port = server.start()
    x1 = np.random.default_rng(SEED + 95).random((1, 784))
    try:
        keepalive_walls(port, ndarray(x1), 5)
        fused_mlp.LAUNCHES = 0
        p50 = {"on": [], "off": []}
        with FoldWalls() as folds:
            for turn in range(OBS_TURNS):
                for mode in (("on", "off") if turn % 2 == 0 else ("off", "on")):
                    qc_switches(mode == "on")
                    p50[mode].append(keepalive_p50_ms(port, ndarray(x1), OBS_ONE_ROW))
        qc_switches(True)
        one_row = {"collecting": folds.p50_us(False, 1), "live": folds.p50_us(True, 1)}
        launches = fused_mlp.LAUNCHES
        over = get_json(port, "/overhead")
    finally:
        server.stop()
    fold = over["off_path_fold"]
    log(f"[quality] MNIST 1-row p50 over {OBS_ONE_ROW} keepalive requests, ABBA, tracing on at "
        f"sample 1: quality + costs + postmortems on {[round(v, 4) for v in p50['on']]} ms, off "
        f"{[round(v, 4) for v in p50['off']]} ms; /overhead off-path fold p50 quality "
        f"{fold['quality']['p50_us']} us, ledger {fold['ledger']['p50_us']} us, tracer "
        f"{fold['tracer']['p50_us']} us; a 1-row quality fold's wall while the window collects "
        f"p50 {one_row['collecting']['p50_us']} us ({one_row['collecting']['folds']} folds), live "
        f"(the numpy twin) {one_row['live']['p50_us']} us ({one_row['live']['folds']}); "
        f"framework_p50_ms {over['framework_p50_ms']} ({smi})")
    return {"p50_ms_on": p50["on"], "p50_ms_off": p50["off"], "fold_us": fold,
            "one_row_fold_us": one_row,
            "framework_p50_ms": over["framework_p50_ms"], "launches": launches}


def quality_costs_phase(torch, dev, smi) -> dict:
    """Phase 10p: quality, postmortems and the cost ledger on the card, in
    engines of their own, after 10o."""
    t0 = time.perf_counter()
    counted = dev.type == "cuda"  # the plain versions on the CPU count nothing
    observatories(True)
    qc_switches(True)
    # 10p's 1 ms SLO target burns its budget, and the brownout ladder would
    # answer that burn by halving its generations: 10p measures quality and
    # costs at full length, so the ladder is off until 10q
    os.environ["SELDON_TPU_BROWNOUT"] = "0"
    drift = qc_drift(torch, dev, smi, counted)
    router = qc_router(torch, dev, smi, counted)
    outlier = qc_outlier(torch, dev, smi, counted)
    costs = qc_costs(torch, dev, smi, counted)
    pm = qc_postmortem(torch, dev, smi, counted, costs["walls_s"][-1])
    over = qc_overhead(torch, dev, smi, counted)
    observatories(False)
    os.environ["SELDON_TPU_BROWNOUT"] = "1"
    out = {"drift": drift, "router": router, "outlier": outlier, "costs": costs,
           "postmortem": pm, "overhead": over, "card": smi,
           "launches": {
               "fused_mlp_softmax": (drift["launches"] + router["launches"]
                                     + outlier["launches"] + over["launches"]),
               **{k: costs["launches"][k] + pm["launches"][k]
                  for k in ("flash_decode_paged", "kv_write_paged")}},
           "wall_s": time.perf_counter() - t0}
    log(f"[quality] phase 10p wall {out['wall_s']:.2f} s")
    return out


PQ_BUCKETS = (1, 8, 32, 64)   # the pad buckets the model learns in part 1
PQ_BURSTS = 3              # bursts of PQ_BURST concurrent requests in part 2
PQ_BURST = 48
PQ_SHEDS = 8               # requests under a deadline the model says they miss
PQ_ROUTED = 24             # requests under the demotion deadline
PQ_EST_X = 3.0             # a learned estimate within this factor of /perf's p50
PQ_MAX_NEW_SCALE = 0.5     # SELDON_TPU_BROWNOUT_MAXNEW_SCALE's default
# the ladder's knobs (SELDON_TPU_BROWNOUT_{DEPTH,DWELL_S,TICK_MS,REVERT_S}) and the
# scheduler's in part 5: 16 slots, so the batch request's other 16 rows wait
# (pressure 16 / 4 = 4: stage 3), and a pool that preempts the 16 admitted
PQ_LADDER = {"enter_depth": 4.0, "dwell_s": 0.05, "tick_interval_s": 0.010, "revert_s": 1.0}
PQ_GEN_ENV = {"SELDON_TPU_GEN_SLOTS": "16", "SELDON_TPU_GEN_POOL_BLOCKS": "384"}
# part 5's generator engine: the batch-tier request waits behind the interactive
# ones and is preempted ~49 times by design, so its one HTTP answer spans every
# tick of its 32 rows (10-18 s inside the whole run on an H100's host, past the
# engine's 30 s default once on a slower one); a hung device still answers 504
# at this limit
PQ_DISPATCH_TIMEOUT_S = 180.0
PQ_LADDER_RETURN_S = 60.0  # the ladder back at 0 this long after the load ends
PQ_P50_REQUESTS = 50       # keepalive requests after a process's first
PQ_CORPUS_REQUESTS = 40
PQ_OVER_RUNS = 100         # requests a wall in part 9 (each of 32 clients: a share)
PQ_ROUTER = "ab"


def post_bytes(url: str, data: bytes, headers: dict):
    """A POST of raw bytes; (status, body)."""
    req = urllib.request.Request(url, data=data, method="POST", headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def policy_switches(on: bool) -> None:
    """The autopilot and the brownout ladder on or off: their kill switches
    are read at every decision."""
    os.environ["SELDON_TPU_AUTOPILOT"] = "1" if on else "0"
    os.environ["SELDON_TPU_BROWNOUT"] = "1" if on else "0"


def settle_spine() -> None:
    """Every pending record folded: a drain, then the drain lock once, so a
    fold the drainer thread had in hand when the rings looked empty has
    finished too."""
    from seldon_core_tpu_torch.utils.hotrecord import SPINE

    SPINE.drain()
    with SPINE._drain_lock:
        pass


def prom_samples(port: int):
    """/prometheus's samples, every pending record folded first."""
    settle_spine()
    status, raw = request("GET", f"http://127.0.0.1:{port}/prometheus")
    if status != 200:
        raise AssertionError(f"[policies] /prometheus: HTTP {status}")
    return parse_prometheus(raw.decode())[1]


def pq_learn(torch, dev, smi, engine, port, counted: bool) -> dict:
    """Part 1: the model learns the fused MLP's walls, bucket by bucket."""
    from seldon_core_tpu_torch.ops import fused_mlp
    from seldon_core_tpu_torch.runtime.autopilot import AUTOPILOT

    n = 2 * AUTOPILOT.min_samples + 2
    fused_mlp.LAUNCHES = 0
    sent = 0
    bodies = {b: ndarray(np.random.default_rng(SEED + 100 + b).random((b, 784)))
              for b in PQ_BUCKETS}
    # two dispatches a bucket first, then the model starts from nothing: a
    # cold first wall (a dispatch thread's first call) would stay in the EWMA
    # for many samples (0.7^(n-1) of it after n)
    for b in PQ_BUCKETS:
        keepalive_walls(port, bodies[b], 2)
        sent += 2
    settle_spine()
    AUTOPILOT.reset()
    for b in PQ_BUCKETS:
        keepalive_walls(port, bodies[b], n)
        sent += n
    launches = fused_mlp.LAUNCHES
    time.sleep(1.1)  # the spine's gauge refresh runs at most once a second
    get_json(port, "/stats")
    ap = get_json(port, "/autopilot")
    perf = {r["executable"]: r for r in get_json(port, "/perf")["executables"]}
    trace = get_json(port, "/trace?limit=400")
    samples = prom_samples(port)
    table = {r["key"]: r for r in ap["keys"]}
    rows = {}
    for b in PQ_BUCKETS:
        key = engine.compiled.shape_key((b, 784), np.float64)
        r, p = table.get(key), perf.get(key)
        if r is None or p is None:
            raise AssertionError(f"[policies] no /autopilot or /perf row for {key}: "
                                 f"{sorted(table)} / {sorted(perf)}")
        rows[b] = {"key": key, "samples": r["samples"], "learned_ms": r["learned_ms"],
                   "seed_ms": r["seed_ms"], "perf_p50_ms": p["latency_ms"]["p50"]}
    spans = [s for s in trace["spans"] if s["name"] == "dispatch"]
    predicted = [s for s in spans if "autopilot_predicted_ms" in (s.get("attrs") or {})]
    checks = {
        "every bucket n >= min_samples": all(r["samples"] >= AUTOPILOT.min_samples
                                             for r in rows.values()),
        f"learned within {PQ_EST_X}x of /perf p50": all(
            r["perf_p50_ms"] / PQ_EST_X <= r["learned_ms"] <= r["perf_p50_ms"] * PQ_EST_X
            for r in rows.values()),
        "dispatch spans carry autopilot_predicted_ms": len(predicted) > 0,
        "seldon_tpu_autopilot_keys > 0": sample_sum(samples, "seldon_tpu_autopilot_keys") > 0,
        "launches == dispatches": (launches == sent) if counted else True,
    }
    if not all(checks.values()):
        raise AssertionError(f"[policies] part 1 checks failed: {checks}; {rows}; "
                             f"{len(predicted)}/{len(spans)} dispatch spans predicted; "
                             f"launches {launches}, dispatches {sent}")
    log(f"[policies] MNIST, {n} requests a pad bucket over one keepalive connection: "
        + "; ".join(f"{b} rows: learned {r['learned_ms']} ms (seed {r['seed_ms']}, /perf p50 "
                    f"{r['perf_p50_ms']}, {r['samples']} samples)" for b, r in rows.items())
        + f"; {len(predicted)} of {len(spans)} dispatch spans in /trace carry "
        f"autopilot_predicted_ms; seldon_tpu_autopilot_keys "
        f"{sample_sum(samples, 'seldon_tpu_autopilot_keys')}; fused-MLP launches {launches} == "
        f"{sent} dispatches ({smi})")
    return {"buckets": rows, "launches": launches, "dispatches": sent,
            "predicted_spans": len(predicted)}


def pq_bursts(port: int, seed: int) -> list:
    """PQ_BURSTS bursts of PQ_BURST concurrent 1- to 24-row requests, half
    with a generous Seldon-Deadline-Ms; the answers, in order."""
    url = f"http://127.0.0.1:{port}/api/v0.1/predictions"
    rng = np.random.default_rng(seed)
    reqs = [(rng.random((int(rng.integers(1, 25)), 784)), i % 2 == 0)
            for i in range(PQ_BURSTS * PQ_BURST)]
    out = []
    with ThreadPoolExecutor(PQ_BURST) as pool:
        for k in range(PQ_BURSTS):
            burst = reqs[k * PQ_BURST:(k + 1) * PQ_BURST]
            futs = [pool.submit(request_headers, "POST", url, ndarray(x),
                                {"Seldon-Deadline-Ms": "5000"} if dl else {})
                    for x, dl in burst]
            for (x, _), f in zip(burst, futs):
                status, raw = f.result()
                out.append(check_answer(status, raw, len(x), "ndarray"))
    return out


def pq_flush(torch, dev, smi, engine, port) -> dict:
    """Part 2: the planner sizes the bursts' flushes; every answer equals the
    same rows' answer in a kill-switch engine, bit for bit."""
    before = sample_sum(prom_samples(port), "seldon_tpu_autopilot_decisions_total", site="flush")
    planned = pq_bursts(port, SEED + 120)
    after = sample_sum(prom_samples(port), "seldon_tpu_autopilot_decisions_total", site="flush")
    twin = mode_engine(torch, dev, example_doc("mnist"), continuous=False)
    twin.load_states(engine.states())
    server = ServerThread(twin)
    tport = server.start()
    os.environ["SELDON_TPU_AUTOPILOT"] = "0"
    try:
        tbefore = sample_sum(prom_samples(tport), "seldon_tpu_autopilot_decisions_total",
                             site="flush")
        legacy = pq_bursts(tport, SEED + 120)
        tdec = sample_sum(prom_samples(tport), "seldon_tpu_autopilot_decisions_total",
                          site="flush") - tbefore
    finally:
        os.environ["SELDON_TPU_AUTOPILOT"] = "1"
        server.stop()
    same = all(np.array_equal(a, b) for a, b in zip(planned, legacy))
    checks = {"flush decisions rose": after > before,
              "the kill switch plans nothing": tdec == 0,
              "answers bit for bit": same and len(planned) == len(legacy)}
    if not all(checks.values()):
        raise AssertionError(f"[policies] part 2 checks failed: {checks}; decisions "
                             f"{before} -> {after}, twin {tdec}")
    log(f"[policies] {PQ_BURSTS} bursts of {PQ_BURST} concurrent 1-24-row requests, half with "
        f"Seldon-Deadline-Ms 5000: seldon_tpu_autopilot_decisions_total{{site=\"flush\"}} "
        f"{before} -> {after}; {len(planned)} answers equal bit for bit to a "
        f"SELDON_TPU_AUTOPILOT=0 engine's ({smi})")
    return {"flush_decisions": after - before, "answers": len(planned)}


def pq_shed(torch, dev, smi, port, learned: dict, counted: bool) -> dict:
    """Part 3: requests whose deadline sits below the learned estimate / 1.25
    answer 503 before any dispatch; ample ones are served.  Binary frames
    whose sidecar carries the deadline: its clock starts where the frame is
    handled, so no host delay before admission (reading the body, a thread
    switch) spends a 1 ms budget first, which would answer 504 instead (a
    card run saw one of 8 header deadlines do so)."""
    from seldon_core_tpu_torch.ops import fused_mlp
    from seldon_core_tpu_torch.runtime import wire
    from seldon_core_tpu_torch.runtime.autopilot import SHED_INFO_PREFIX, shed_margin

    from seldon_core_tpu_torch.runtime.autopilot import AUTOPILOT

    coalesce_ms = 0.5  # the engine's MicroBatcher default, in the admission estimate
    url = f"http://127.0.0.1:{port}/api/v0.1/predictions"
    bucket = 64
    est_ms = learned[64]["learned_ms"]
    if est_ms + coalesce_ms < shed_margin():
        # a 1 ms deadline cannot undercut the 64-row estimate: the 1,024-row
        # bucket, learned here from binary frames
        bucket = 1024
        x = np.random.default_rng(SEED + 131).random((bucket, 784)).astype(np.float32)
        body = wire.join_parts(wire.encode_frame(x))
        for _ in range(AUTOPILOT.min_samples + 1):
            status, _ = post_bytes(url, body, {"Content-Type": wire.WIRE_CONTENT_TYPE})
            if status != 200:
                raise AssertionError(f"[policies] a 1,024-row frame: HTTP {status}")
        table = {r["key"]: r for r in get_json(port, "/autopilot")["keys"]}
        est_ms = table["predict[1024x784/float32]"]["learned_ms"]
    if est_ms + coalesce_ms < shed_margin():
        raise AssertionError(f"[policies] the {bucket}-row estimate {est_ms} ms is too small "
                             f"for a 1 ms deadline to undercut")
    deadline_ms = max(1, int(est_ms / shed_margin()))
    x = np.random.default_rng(SEED + 130).random((bucket, 784)).astype(np.float32)
    before = sample_sum(prom_samples(port), "seldon_tpu_autopilot_shed_total", where="admission")
    fused_mlp.LAUNCHES = 0
    shed, puids = [], []
    for i in range(PQ_SHEDS):
        puid = f"pq-shed-{i}"
        puids.append(puid)
        body = wire.join_parts(wire.encode_frame(x, meta_bytes=wire.pack_wire_meta(
            puid=puid, deadline_ms=deadline_ms)))
        status, raw = post_bytes(url, body, {"Content-Type": wire.WIRE_CONTENT_TYPE})
        err = wire.decode_frame(raw).extra().get("error", "") if status != 200 else ""
        shed.append((status, err.startswith(SHED_INFO_PREFIX)))
    launches_shed = fused_mlp.LAUNCHES
    after = sample_sum(prom_samples(port), "seldon_tpu_autopilot_shed_total", where="admission")
    served = []
    for i in range(PQ_SHEDS):
        body = wire.join_parts(wire.encode_frame(x))
        status, raw = post_bytes(url, body, {"Content-Type": wire.WIRE_CONTENT_TYPE,
                                             "Seldon-Deadline-Ms": "10000"})
        served.append(status)
    checks = {
        "every tight request 503 with the shed prefix": shed == [(503, True)] * PQ_SHEDS,
        "no launch across the sheds": launches_shed == 0 if counted else True,
        f"shed_total{{admission}} +{PQ_SHEDS}": after - before == PQ_SHEDS,
        "ample deadlines served": served == [200] * PQ_SHEDS,
    }
    if not all(checks.values()):
        raise AssertionError(f"[policies] part 3 checks failed: {checks}; {shed}; served "
                             f"{served}; launches {launches_shed}; sheds {before} -> {after}")
    log(f"[policies] admission: the {bucket}-row bucket's learned estimate {est_ms} ms, "
        f"the sidecar's deadline_ms {deadline_ms} (estimate / {shed_margin()} rounded down): "
        f"{PQ_SHEDS} binary frames answered 503 '{SHED_INFO_PREFIX}: ...' with "
        f"{launches_shed} fused-MLP launches, seldon_tpu_autopilot_shed_total{{where="
        f"\"admission\"}} {before} -> {after}; {PQ_SHEDS} at 10000 ms served ({smi})")
    return {"bucket": bucket, "estimate_ms": est_ms, "deadline_ms": deadline_ms,
            "sheds": after - before, "puids": puids}


def demotion_doc() -> dict:
    """A RANDOM_ABTEST router (ratioA 0.5) over the outlier_pipeline's
    outlier -> MNIST (branch 0) and MNIST (branch 1)."""
    out = example_doc("outlier_pipeline")["spec"]["predictors"][0]["components"]
    outlier = next(c for c in out if c["name"] == "outlier")
    mnist = {"runtime": "inprocess", "class_path": "MnistClassifier"}
    return {"spec": {"name": "policies-ab", "predictors": [{
        "name": "main",
        "components": [outlier, {"name": "mnist-a", **mnist}, {"name": "mnist-b", **mnist}],
        "graph": {"name": PQ_ROUTER, "implementation": "RANDOM_ABTEST",
                  "parameters": [{"name": "ratioA", "value": "0.5", "type": "FLOAT"}],
                  "children": [{"name": "outlier", "type": "TRANSFORMER",
                                "children": [{"name": "mnist-a", "type": "MODEL"}]},
                               {"name": "mnist-b", "type": "MODEL"}]}}]}}


def pq_routes(engine, port, n: int, headers: dict, seed: int) -> list:
    """n 1-row requests; each answer's (routing, reroute tag, probabilities)."""
    url = f"http://127.0.0.1:{port}/api/v0.1/predictions"
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        status, raw = request_headers("POST", url, ndarray(rng.random((1, 784))), headers)
        check_answer(status, raw, 1, "ndarray")
        meta = json.loads(raw)["meta"]
        out.append((meta["routing"].get(PQ_ROUTER),
                    meta.get("tags", {}).get(f"seldon.autopilot.reroute.{PQ_ROUTER}")))
    return out


def pq_demotion(torch, dev, smi, counted: bool) -> dict:
    """Part 4: the router's branch predicted past the deadline is demoted in
    fused mode; with the kill switch the same requests follow the router."""
    from seldon_core_tpu_torch.ops import fused_mlp
    from seldon_core_tpu_torch.runtime.autopilot import AUTOPILOT, branch_key, shed_margin

    keys = [branch_key(PQ_ROUTER, b, 1) for b in (0, 1)]
    runs = {}
    # the warm-up (both branches' first, cold calls), then the training; the
    # off run replays them all, so its router draws the same branches
    chunks = [(8, SEED + 139), (20, SEED + 140)]
    for mode in ("on", "off"):
        engine = mode_engine(torch, dev, demotion_doc(), continuous=False)
        if engine.mode != "fused":
            raise AssertionError(f"[policies] the demotion graph served in {engine.mode} mode")
        server = ServerThread(engine)
        port = server.start()
        try:
            fused_mlp.LAUNCHES = 0
            warm = pq_routes(engine, port, chunks[0][0], {}, chunks[0][1])
            if mode == "on":
                if {b for b, _ in warm} != {0, 1}:
                    raise AssertionError(f"[policies] the warm-up missed a branch: {warm}")
                # the model learns from warm branches only: a cold first wall
                # would hold the estimate up for many samples
                AUTOPILOT.reset()
            for n, seed in chunks[1:]:
                pq_routes(engine, port, n, {}, seed)
            while mode == "on" and min(AUTOPILOT._models[k].n if k in AUTOPILOT._models else 0
                                       for k in keys) < 2 * AUTOPILOT.min_samples:
                chunks.append((4, SEED + 141 + len(chunks)))
                pq_routes(engine, port, chunks[-1][0], {}, chunks[-1][1])
                if len(chunks) > 30:
                    raise AssertionError("[policies] a branch was never routed")
            if mode == "on":
                ap = {r["key"]: r for r in get_json(port, "/autopilot")["keys"]}
                est = [ap[k]["learned_ms"] for k in keys]
                n_train = sum(n for n, _ in chunks[1:])
                # rem x margin three quarters of the way from branch 1's
                # estimate to branch 0's: branch 0 overruns, branch 1 fits with
                # room for the time spent before the budget is read
                deadline_ms = (est[1] + 0.75 * (est[0] - est[1])) / shed_margin()
                before = sample_sum(prom_samples(port), "seldon_tpu_autopilot_decisions_total",
                                    site="route")
            else:
                os.environ["SELDON_TPU_AUTOPILOT"] = "0"
            try:
                routed = pq_routes(engine, port, PQ_ROUTED,
                                   {"Seldon-Deadline-Ms": f"{deadline_ms:.3f}"}, SEED + 150)
            finally:
                os.environ["SELDON_TPU_AUTOPILOT"] = "1"
            decisions = sample_sum(prom_samples(port), "seldon_tpu_autopilot_decisions_total",
                                   site="route")
            runs[mode] = {"routed": routed, "launches": fused_mlp.LAUNCHES,
                          "decisions": decisions}
        finally:
            server.stop()
    on, off = runs["on"]["routed"], runs["off"]["routed"]
    to0 = [i for i, (b, _) in enumerate(off) if b == 0]
    demoted = runs["on"]["decisions"] - before
    checks = {
        "estimates apart": est[0] > est[1],
        "the kill switch follows the router": all(t is None for _, t in off) and bool(to0),
        "every branch-0 pick served by branch 1": all(on[i] == (1, 1) for i in to0),
        "branch-1 picks untagged": all(on[i] == (1, None) for i in range(PQ_ROUTED)
                                       if i not in to0),
        "decisions{route} count the demotions": demoted == len(to0),
    }
    if not all(checks.values()):
        raise AssertionError(f"[policies] part 4 checks failed: {checks}; estimates {est}; "
                             f"deadline {deadline_ms} ms; on {on}; off {off}; route decisions "
                             f"+{demoted}")
    launches = runs["on"]["launches"] + runs["off"]["launches"]
    log(f"[policies] fused RANDOM_ABTEST (ratioA 0.5) over outlier -> MNIST | MNIST: learned "
        f"branch walls {est[0]} ms and {est[1]} ms after {n_train} requests; at "
        f"Seldon-Deadline-Ms {deadline_ms:.3f} the router picked branch 0 for {len(to0)} of "
        f"{PQ_ROUTED}, each served by branch 1 and tagged seldon.autopilot.reroute.{PQ_ROUTER}"
        f" (decisions{{route}} +{demoted}); with SELDON_TPU_AUTOPILOT=0 the same requests "
        f"follow the router; fused-MLP launches {launches} ({smi})")
    return {"estimates_ms": est, "deadline_ms": deadline_ms, "demoted": len(to0),
            "launches": launches}


def pq_brownout(torch, dev, smi, mnist_port, counted: bool) -> dict:
    """Part 5: the ladder and the tiers on the continuous lane.  A batch-tier
    32-row request in a pool that preempts, 4 interactive 1-row requests
    while it runs; 1-row MNIST requests on the second engine tick the ladder
    meanwhile (the ladder moves at admission, as traffic arrives)."""
    from seldon_core_tpu_torch.ops import flash_decode as fd, kv_write as kw
    from seldon_core_tpu_torch.runtime import genserver as gs
    from seldon_core_tpu_torch.runtime.brownout import BROWNOUT, BROWNOUT_INFO_PREFIX

    for k, v in PQ_LADDER.items():  # SELDON_TPU_BROWNOUT_* are read at import
        setattr(BROWNOUT, k, v)
    BROWNOUT.reset()
    engine = mode_engine(torch, dev, gen_deployment(), continuous=True, env=PQ_GEN_ENV)
    engine.dispatch_timeout_s = PQ_DISPATCH_TIMEOUT_S  # read at each request (GenLane)
    g = engine.genserver
    victims, admits, widths = [], [], []
    orig_preempt, orig_next = g._preempt, g._next_waiting_index

    def preempt(seq):
        victims.append(seq.request.tier)
        return orig_preempt(seq)

    def next_index():
        i = orig_next()
        waiting = {s.request.tier for s in g._waiting}
        admits.append((g._waiting[i].request.tier, waiting))
        return i

    orig_forward = gs.paged_forward

    def forward(params, toks, *a, **kwargs):
        widths.append((int(toks.shape[1]), BROWNOUT.stage()))
        return orig_forward(params, toks, *a, **kwargs)

    g._preempt, g._next_waiting_index = preempt, next_index
    gs.paged_forward = forward
    server = ServerThread(engine)
    port = server.start()
    url = f"http://127.0.0.1:{port}/api/v0.1/predictions"
    murl = f"http://127.0.0.1:{mnist_port}/api/v0.1/predictions"
    rng = np.random.default_rng(SEED + 160)
    vocab, new = GEN_DIMS["vocab"], GEN_DIMS["max_new_tokens"]
    batch = rng.integers(0, vocab, size=(GEN_B, GEN_S))
    singles = [rng.integers(0, vocab, size=(1, GEN_S)) for _ in range(4)]
    x1 = ndarray(np.random.default_rng(SEED + 161).random((1, 784)))
    stages, tier_sheds = [], {}
    stage2 = answered = None
    threads = threading.active_count()

    def batch_request():
        t = time.perf_counter()
        out = request_headers("POST", url, ndarray(batch), {"Seldon-Tier": "batch"})
        return (*out, time.perf_counter() - t)

    try:
        check_tokens(*request("POST", url, ndarray(singles[0][:, :64])), singles[0][:, :64],
                     "ndarray", new=new, vocab=vocab)  # warm-up: the pool, the first ops
        victims.clear(), admits.clear(), widths.clear()
        snap0 = g.snapshot()
        moves0 = sample_sum(prom_samples(mnist_port), "seldon_tpu_brownout_transitions_total")
        fd.PAGED_LAUNCHES = kw.PAGED_LAUNCHES = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            fb = pool.submit(batch_request)
            fi = []
            while not fb.done() or BROWNOUT.stage() > 0:
                status, _ = request_headers("POST", murl, x1, {})  # the tick
                st = BROWNOUT.stage()
                if not stages or stages[-1][1] != st:
                    stages.append((round(time.perf_counter() - t0, 3), st))
                if status != 200:
                    raise AssertionError(f"[policies] an interactive MNIST request: {status}")
                if len(fi) < len(singles) and time.perf_counter() - t0 > 0.05 * (len(fi) + 1):
                    fi.append(pool.submit(request, "POST", url, ndarray(singles[len(fi)])))
                for tier, at in (("offline", 1), ("batch", 3)):
                    if st >= at and tier not in tier_sheds:
                        s2, raw = request_headers("POST", murl, x1, {"Seldon-Tier": tier})
                        info = json.loads(raw)["status"]["info"] if s2 == 503 else ""
                        tier_sheds[tier] = (s2, info.startswith(BROWNOUT_INFO_PREFIX), st)
                if st >= 2 and stage2 is None:
                    stage2 = pool.submit(request, "POST", url, ndarray(singles[0]))
                if answered is None and fb.done():
                    answered = time.perf_counter()
                if answered is not None and time.perf_counter() - answered > PQ_LADDER_RETURN_S:
                    raise AssertionError(f"[policies] the ladder did not return to 0 within "
                                         f"{PQ_LADDER_RETURN_S} s of the batch request's "
                                         f"answer: {stages}")
                time.sleep(0.005)
            answers = [f.result() for f in fi]
            s2_status, s2_raw = stage2.result() if stage2 is not None else (None, b"")
            b_status, b_raw, batch_s = fb.result()
        paged, kvp = fd.PAGED_LAUNCHES, kw.PAGED_LAUNCHES
        snap = g.snapshot()
        stats = get_json(port, "/stats")
        moves = sample_sum(prom_samples(mnist_port),
                           "seldon_tpu_brownout_transitions_total") - moves0
    finally:
        g._preempt, g._next_waiting_index = orig_preempt, orig_next
        gs.paged_forward = orig_forward
        server.stop()
    check_tokens(b_status, b_raw, batch, "ndarray", new=new, vocab=vocab)
    short = max(1, int(new * PQ_MAX_NEW_SCALE))
    if s2_status != 200 or np.asarray(json.loads(s2_raw)["data"]["ndarray"]).shape != (1, short):
        raise AssertionError(f"[policies] the stage-2 request: HTTP {s2_status}, "
                             f"{s2_raw[:200]!r}")
    lengths = [np.asarray(json.loads(raw)["data"]["ndarray"]).shape[1] for _, raw in answers]
    trans = [(t.from_stage, t.to_stage) for t in BROWNOUT.transitions]
    steps = [b for _, b in stages]
    sched = {k: snap[k] - snap0[k] for k in ("decode_steps_total", "prefill_dispatches_total",
                                              "preempted_total")}
    n_layers = GEN_DIMS["n_layers"]
    floor = engine.genserver.prefill_chunk
    both_waiting = [t for t, w in admits if {"interactive", "batch"} <= w]
    checks = {
        "interactive answers": all(st == 200 for st, _ in answers)
        and all(n in (new, short) for n in lengths),
        "no interactive victim": "interactive" not in victims and "batch" in victims,
        "interactive admitted first while batch waits": bool(both_waiting)
        and all(t == "interactive" for t in both_waiting),
        "0 -> 1 -> 2 -> 3, one step a tick": trans[:3] == [(0, 1), (1, 2), (2, 3)]
        and all(b - a in (-1, 1) for a, b in trans),
        "back to 0 one stage at a time": trans[-1] == (1, 0) and steps[-1] == 0,
        "every move counted": moves == len(trans),
        "offline shed at stage >= 1": tier_sheds.get("offline", (0, False))[:2] == (503, True),
        "batch shed at stage 3": tier_sheds.get("batch", (0, False))[:2] == (503, True),
        "prefill at the floor at stage >= 2": all(w == floor for w, st in widths if st >= 2)
        and any(st >= 2 for _, st in widths),
        "/stats brownout": stats["brownout"]["stage"] == 0
        and len(stats["brownout"]["transitions"]) == min(8, len(trans)),
        "launches": (paged == n_layers * sched["decode_steps_total"]
                     and kvp == n_layers * sched["prefill_dispatches_total"]) if counted
        else True,
    }
    if not all(checks.values()):
        raise AssertionError(f"[policies] part 5 checks failed: {checks}; stages {stages}; "
                             f"transitions {trans}; victims {victims}; tier sheds "
                             f"{tier_sheds}; lengths {lengths}; admissions with both tiers "
                             f"waiting {both_waiting}; widths {widths[:40]}; scheduler "
                             f"{sched}; launches {paged}, {kvp}")
    log(f"[policies] brownout on the continuous lane (depth {PQ_LADDER['enter_depth']}, dwell "
        f"0.05 s, tick 10 ms, revert 1 s; {PQ_GEN_ENV}): a batch-tier {GEN_B}-row {GEN_S}-token "
        f"request and "
        f"4 interactive 1-row ones; the batch request answered in {batch_s:.3f} s "
        f"(dispatch limit {PQ_DISPATCH_TIMEOUT_S:.0f} s; {threads} threads live at its "
        f"start); stages over time {stages}; transitions {trans}; "
        f"{len(victims)} preemptions, all batch tier ({victims.count('interactive')} "
        f"interactive); {len(both_waiting)} admissions with both tiers waiting, all "
        f"interactive; tier sheds {tier_sheds}; the stage-2 request {short} tokens, the "
        f"interactive ones {lengths}; prefill widths at stage >= 2 "
        f"{sorted({w for w, st in widths if st >= 2})} (floor {floor}); flash_decode_paged "
        f"{paged} = {n_layers} x {sched['decode_steps_total']} decode steps, kv_write_paged "
        f"{kvp} = {n_layers} x {sched['prefill_dispatches_total']} prefill ticks ({smi})")
    return {"stages": stages, "transitions": trans, "victims": victims, "batch_s": batch_s,
            "tier_sheds": tier_sheds, "lengths": lengths, "short": short,
            "launches": {"flash_decode_paged": paged, "kv_write_paged": kvp},
            "scheduler": sched}


def engine_proc(dev, env: dict, port: int):
    """An engine_main serving MNIST; its lines before "engine up"."""
    argv = ["seldon_core_tpu_torch.runtime.engine_main", "--file",
            str(ROOT / "examples" / "mnist_deployment.json"), "--device", dev.type,
            "--host", "127.0.0.1", "--rest-port", str(port)]
    proc = subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT,
                            env={**os.environ, "ENGINE_SERVER_GRPC_PORT": str(free_port()),
                                 **env},
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    start = time.perf_counter()
    while True:
        line = proc.stdout.readline()
        lines.append(line.strip())
        if line.startswith("engine up:"):
            return proc, lines
        if not line or time.perf_counter() - start > 300:
            proc.kill()
            raise AssertionError(f"[policies] engine_main did not come up: "
                                 f"{(''.join(lines) + proc.stdout.read())[-1500:]}")


def pq_prewarm(torch, dev, smi, counted: bool) -> dict:
    """Part 6: two fresh engine_main processes, one with
    ENGINE_PREWARM_WIDTHS=784: its shapes and launches before it binds, and
    each process's first-request wall and p50 over the next requests."""
    ports = {"prewarm": free_port(), "cold": free_port()}
    envs = {"prewarm": {"ENGINE_PREWARM_WIDTHS": "784"}, "cold": {}}
    with ThreadPoolExecutor(2) as pool:
        futs = {k: pool.submit(engine_proc, dev, envs[k], ports[k]) for k in ports}
        procs = {k: f.result() for k, f in futs.items()}
    out = {}
    x1 = ndarray(np.random.default_rng(SEED + 170).random((1, 784)))
    try:
        for k in ("prewarm", "cold"):
            proc, lines = procs[k]
            launches0 = get_json(ports[k], "/stats")["kernels"]["fused_mlp_softmax"]["launches"]
            t = time.perf_counter()
            check_answer(*request("POST", f"http://127.0.0.1:{ports[k]}/api/v0.1/predictions",
                                  x1), 1, "ndarray")
            first_ms = (time.perf_counter() - t) * 1e3
            p50 = keepalive_p50_ms(ports[k], x1, PQ_P50_REQUESTS)
            line = next((ln for ln in lines if ln.startswith("prewarmed ")), None)
            out[k] = {"first_ms": first_ms, "p50_ms": p50, "launches_before_bind": launches0,
                      "line": line}
    finally:
        for proc, _ in procs.values():
            stop_service(proc)
    shapes = (1024).bit_length()
    line = out["prewarm"]["line"] or ""
    checks = {
        "the prewarm line": line.startswith(f"prewarmed {shapes} batch shapes for widths [784]"),
        "no line without the knob": out["cold"]["line"] is None,
        # the unit's construction probes the kernel once in both
        "launches before bind": (out["prewarm"]["launches_before_bind"] == 1 + shapes
                                 and out["cold"]["launches_before_bind"] == 1) if counted
        else True,
    }
    if not all(checks.values()):
        raise AssertionError(f"[policies] part 6 checks failed: {checks}; {out}")
    log(f"[policies] prewarm: '{line}'; fused-MLP launches before binding "
        f"{out['prewarm']['launches_before_bind']} (1 probe + {shapes} shapes) against "
        f"{out['cold']['launches_before_bind']}; first-request wall "
        f"{out['prewarm']['first_ms']:.3f} ms prewarmed, {out['cold']['first_ms']:.3f} ms not; "
        f"p50 over the next {PQ_P50_REQUESTS} {out['prewarm']['p50_ms']:.4f} and "
        f"{out['cold']['p50_ms']:.4f} ms (the kernel build cache warm in both) ({smi})")
    return out


def corpus_env(d: Path) -> dict:
    return {"SELDON_TPU_CORPUS_DIR": str(d), "SELDON_TPU_CORPUS": "1"}


def pq_corpus(torch, dev, smi, writer, port: int, d: Path) -> dict:
    """Part 7: an engine_main (``writer``, started beside part 6's pair on
    ``port`` with ``corpus_env(d)``) writes the corpus; a second one on the
    same directory prices the keys before its first request; small
    segments rotate, write sketch.json and unlink the oldest."""
    env = corpus_env(d)
    rng = np.random.default_rng(SEED + 180)
    bodies = [ndarray(rng.random((int(rng.choice([1, 8])), 784)))
              for _ in range(PQ_CORPUS_REQUESTS)]
    proc, _ = writer
    try:
        for body in bodies:
            status, raw = request("POST", f"http://127.0.0.1:{port}/api/v0.1/predictions", body)
            if status != 200:
                raise AssertionError(f"[policies] corpus writer: HTTP {status}")
        first = get_json(port, "/autopilot")
        written = get_json(port, "/corpus")  # drains: every row on disk
    finally:
        stop_service(proc)
    port = free_port()
    env2 = {**env, "SELDON_TPU_CORPUS_SEGMENT_BYTES": "4096",
            "SELDON_TPU_CORPUS_MAX_SEGMENTS": "2"}
    proc, _ = engine_proc(dev, env2, port)
    try:
        warm = get_json(port, "/autopilot")
        warm_stats = get_json(port, "/stats")["autopilot"]
        warm_corpus = get_json(port, "/corpus")
        keepalive_walls(port, bodies[0], 120)
        rotated = get_json(port, "/corpus")
    finally:
        stop_service(proc)
    keys = lambda doc: sorted(r["key"] for r in doc["keys"])  # noqa: E731
    segs = sorted(p.name for p in d.glob("corpus-*.jsonl"))
    checks = {
        "written": written["rows_total"] == PQ_CORPUS_REQUESTS and written["keys"],
        "warm keys before the first request": keys(warm) == keys(first)
        and warm_stats["warm_keys"] == len(keys(first)) > 0
        and all(r["trusted"] for r in warm["keys"]),
        "/corpus rows and sketches": sum(k["n"] for k in warm_corpus["keys"])
        == PQ_CORPUS_REQUESTS and warm_corpus["warm_keys"] > 0,
        "rotation": rotated["rotations"] > 0 and (d / "sketch.json").exists()
        and len(segs) <= 3 and "corpus-000001.jsonl" not in segs,
    }
    if not all(checks.values()):
        raise AssertionError(f"[policies] part 7 checks failed: {checks}; first {keys(first)}; "
                             f"warm {keys(warm)} {warm_stats}; segments {segs}; "
                             f"{ {k: rotated[k] for k in ('rotations', 'segments')} }")
    log(f"[policies] perf corpus: an engine_main served {PQ_CORPUS_REQUESTS} requests "
        f"({written['rows_total']} rows, {len(written['keys'])} keys, {written['disk_bytes']} "
        f"bytes); the next one on the same directory listed {keys(warm)} in /autopilot before "
        f"its first request (warm_keys {warm_stats['warm_keys']}, trusted); at 4096-byte "
        f"segments, 120 more requests rotated {rotated['rotations']} times: {segs} and "
        f"sketch.json left ({smi})")
    return {"keys": keys(warm), "warm_keys": warm_stats["warm_keys"],
            "rotations": rotated["rotations"], "segments": segs}


def pq_postmortem(torch, dev, smi, port, shed_puids: list) -> dict:
    """Part 8: with the excess factor low, a trained 1-row dispatch is kept
    for autopilot_excess; part 3's sheds are kept for shed."""
    from seldon_core_tpu_torch.utils.postmortem import POSTMORTEM

    before = dict(get_json(port, "/postmortems")["counters"]["kept"])
    prev = POSTMORTEM.excess_x
    POSTMORTEM.excess_x = 0.01  # SELDON_TPU_POSTMORTEM_EXCESS_X, read at import
    try:
        keepalive_walls(port, ndarray(np.random.default_rng(SEED + 190).random((1, 784))), 5)
        doc = get_json(port, "/postmortems")
    finally:
        POSTMORTEM.excess_x = prev
    kept = doc["counters"]["kept"]
    reasons = {s["puid"]: s["reasons"] for s in doc["kept"]}
    excess = kept.get("autopilot_excess", 0) - before.get("autopilot_excess", 0)
    shed = [p for p in shed_puids if "shed" in reasons.get(p, ())]
    if excess < 1 or len(shed) != len(shed_puids):
        raise AssertionError(f"[policies] part 8: autopilot_excess +{excess}; sheds kept "
                             f"{shed} of {shed_puids}; counters {kept}")
    log(f"[policies] postmortems: at SELDON_TPU_POSTMORTEM_EXCESS_X 0.01, {excess} requests "
        f"kept for autopilot_excess; part 3's {len(shed)} sheds kept for shed; counters "
        f"{kept} ({smi})")
    return {"autopilot_excess": excess, "sheds_kept": len(shed)}


def concurrent_p50_ms(port: int, body: dict, clients: int, runs: int) -> float:
    """The p50 wall of ``runs`` requests from each of ``clients`` keepalive
    connections at once."""
    with ThreadPoolExecutor(clients) as pool:
        walls = [w for f in [pool.submit(keepalive_walls, port, body, runs)
                             for _ in range(clients)] for w in f.result()]
    return float(np.median(walls)) * 1e3


def pq_overhead(torch, dev, smi, port) -> dict:
    """Part 9: the 32-concurrent and the keepalive 1-row MNIST p50 with the
    autopilot and the ladder on and off, in turns, beside /overhead."""
    x1 = ndarray(np.random.default_rng(SEED + 200).random((1, 784)))
    p50 = {"on": {"c32": [], "one": []}, "off": {"c32": [], "one": []}}
    try:
        for turn in range(OBS_TURNS):
            for mode in (("on", "off") if turn % 2 == 0 else ("off", "on")):
                policy_switches(mode == "on")
                p50[mode]["c32"].append(concurrent_p50_ms(port, x1, 32, PQ_OVER_RUNS // 32 + 1))
                p50[mode]["one"].append(keepalive_p50_ms(port, x1, PQ_OVER_RUNS))
    finally:
        policy_switches(True)
    fold = get_json(port, "/overhead")["off_path_fold"]
    log(f"[policies] MNIST 1-row p50, ABBA: 32 concurrent clients autopilot + brownout on "
        f"{[round(v, 4) for v in p50['on']['c32']]} ms, off "
        f"{[round(v, 4) for v in p50['off']['c32']]}; one keepalive client on "
        f"{[round(v, 4) for v in p50['on']['one']]}, off "
        f"{[round(v, 4) for v in p50['off']['one']]}; /overhead perf fold (observatory + "
        f"autopilot + corpus) p50 {fold['perf']['p50_us']} us ({smi})")
    return {"p50_ms": p50, "perf_fold_us": fold["perf"]}


def policies_phase(torch, dev, smi) -> dict:
    """Phase 10q: the autopilot and the engine's policies ([4c]) on the
    card, after 10p, in engines of their own, the deciding singletons reset
    first."""
    from seldon_core_tpu_torch.ops import fused_mlp
    from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons

    from seldon_core_tpu_torch.utils.quality import QUALITY

    t0 = time.perf_counter()
    counted = dev.type == "cuda"  # the plain versions on the CPU count nothing
    # no SLO target (10p set one, and its burn would drive the ladder): the
    # ladder here moves on queue depth alone
    QUALITY.slo.p99_ms = QUALITY.slo.error_rate = None
    reset_learned_singletons()
    observatories(True)
    qc_switches(True)
    # the drift summarizer off: its device folds hold the drainer thread's
    # GIL for tens of ms, and the dispatch walls the model learns would
    # carry that contention (on an H100, a 32-row estimate of 6.6 ms against
    # a p50 of 1.06 in one run); the postmortems and the ledger stay on
    QUALITY.enabled = False
    policy_switches(True)
    engine = mode_engine(torch, dev, example_doc("mnist"), continuous=False)
    fused_mlp.LAUNCHES = 0
    n_pre = engine.prewarm([784])  # a seed prior for every bucket the planner may price
    pre_launches = fused_mlp.LAUNCHES
    server = ServerThread(engine)
    port = server.start()
    walls = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        try:
            return fn(*args)
        finally:
            walls[name] = round(time.perf_counter() - t, 2)

    try:
        learn = timed("learn", pq_learn, torch, dev, smi, engine, port, counted)
        fused_mlp.LAUNCHES = 0
        flush = timed("flush", pq_flush, torch, dev, smi, engine, port)
        flush["launches"] = fused_mlp.LAUNCHES  # both engines'
        shed = timed("shed", pq_shed, torch, dev, smi, port, learn["buckets"], counted)
        shed["launches"] = fused_mlp.LAUNCHES
        pm = timed("postmortem", pq_postmortem, torch, dev, smi, port, shed["puids"])
        demo = timed("demotion", pq_demotion, torch, dev, smi, counted)
        brown = timed("brownout", pq_brownout, torch, dev, smi, port, counted)
        fused_mlp.LAUNCHES = 0
        over = timed("overhead", pq_overhead, torch, dev, smi, port)
        over["launches"] = fused_mlp.LAUNCHES
    finally:
        server.stop()
        observatories(False)
        QUALITY.enabled = True
    import tempfile

    # the corpus writer's process starts beside part 6's pair
    cdir, cport = Path(tempfile.mkdtemp(prefix="sct_corpus_")), free_port()
    with ThreadPoolExecutor(1) as pool:
        writer = pool.submit(engine_proc, dev, corpus_env(cdir), cport)
        try:
            prewarm = timed("prewarm", pq_prewarm, torch, dev, smi, counted)
            corpus = timed("corpus", pq_corpus, torch, dev, smi, writer.result(), cport, cdir)
        finally:
            if writer.done() and writer.exception() is None:
                stop_service(writer.result()[0])
    mlp = {"prewarm (in process)": pre_launches, "learn": learn["launches"],
           "flush planner (both engines)": flush["launches"],
           "admission (served after the sheds)": shed["launches"],
           "demotion": demo["launches"], "overhead": over["launches"]}
    out = {"learn": learn, "flush": flush, "shed": shed, "demotion": demo,
           "brownout": brown, "prewarm": prewarm, "corpus": corpus, "postmortem": pm,
           "overhead": over, "prewarmed_shapes_in_process": n_pre, "card": smi,
           "launches": {"fused_mlp_softmax": sum(mlp.values()),
                        "fused_mlp_by_part": mlp, **brown["launches"]},
           "walls_s": walls, "wall_s": time.perf_counter() - t0}
    log(f"[policies] phase 10q wall {out['wall_s']:.2f} s: {walls}")
    return out


# -- 10r. the native data plane, its codec and unit-state persistence ([4d]) ----

NP_SEQUENTIAL = 200        # 1-row requests on one keepalive connection
NP_CONCURRENT = 32         # concurrent 1-row requests
NP_LOAD_CLIENTS = 64       # keepalive connections of the throughput step
NP_LOAD_S = 1.5            # seconds a throughput run measures
NP_ONE_S = 0.8             # seconds a one-connection run measures
NP_WARMUP_S = 0.3
NP_ROUNDS = (("native", "fast"), ("fast", "native"), ("native", "fast"))  # ABBA..
NP_ROUTES = 20             # /route calls of the persistence part
NP_SAVE_S = 0.5            # PERSISTENCE_FREQUENCY of the persisted microservice


def _count_rows(compiled, counter: list) -> None:
    """Count ``compiled.predict_arrays``'s calls in ``counter[0]`` and the
    rows it was given (padded) in ``counter[1]``."""
    orig = compiled.predict_arrays

    def counted(x, *a, **k):
        counter[0] += 1
        counter[1] += len(x)
        return orig(x, *a, **k)

    compiled.predict_arrays = counted


class PlaneThread:
    """One engine behind the native data plane (``serve_native``, with its
    gRPC lane) on an event loop and thread of its own: the misc lane's
    routes run there."""

    def __init__(self, engine):
        self.engine = engine
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.plane = None

    def start(self):
        from seldon_core_tpu_torch.runtime.nativeplane import serve_native

        self.thread.start()
        self.plane = asyncio.run_coroutine_threadsafe(
            serve_native(self.engine, "127.0.0.1", 0, grpc_port=0), self.loop).result(120)
        return self.plane

    def stop(self):
        asyncio.run_coroutine_threadsafe(self.plane.stop(), self.loop).result(60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)


def np_answer(status: int, raw: bytes):
    """(float64 rows, puid, names, status) of a JSON answer; NaN and the
    infinities must be json's literals (``json.loads`` reads them)."""
    doc = json.loads(raw)
    data = doc.get("data") or {}
    y = (np.asarray(data["ndarray"], dtype=np.float64) if "ndarray" in data else
         np.asarray(data["tensor"]["values"], dtype=np.float64).reshape(data["tensor"]["shape"])
         if "tensor" in data else None)
    return y, doc.get("meta", {}).get("puid"), data.get("names"), status, doc.get("status")


def np_post(conn, body) -> tuple:
    payload = body if isinstance(body, bytes) else json.dumps(body).encode()
    conn.request("POST", "/api/v0.1/predictions", payload, {"Content-Type": "application/json"})
    r = conn.getresponse()
    return r.status, r.read()


def np_same(a, b, what: str) -> None:
    """Two answers (``np_answer``) alike: the float64 values bit for bit
    (NaN where NaN), names, puid (a generated one: 26 characters on both)
    and status."""
    if a[1] != b[1] and len(a[1] or "") == len(b[1] or "") == 26:
        a, b = a[:1] + ("generated",) + a[2:], b[:1] + ("generated",) + b[2:]
    ya, yb = a[0], b[0]
    same = (ya is None and yb is None) or (
        ya is not None and yb is not None and ya.shape == yb.shape
        and np.array_equal(np.isnan(ya), np.isnan(yb))
        and ya[~np.isnan(ya)].tobytes() == yb[~np.isnan(yb)].tobytes())
    if not same or a[1:] != b[1:]:
        diff = (float(np.nanmax(np.abs(ya - yb))) if ya is not None and yb is not None
                and ya.shape == yb.shape else None)
        raise AssertionError(f"[native] {what}: the plane's answer is not the Python lane's "
                             f"(max diff {diff}, {a[1:]} vs {b[1:]})")


def np_mnist(torch, dev, smi, engine, twin, plane, fast_port, fast_grpc) -> dict:
    """Part a: MNIST through the plane against the Python fast lane of a
    second engine with the same weights."""
    from seldon_core_tpu_torch import protoconv
    from seldon_core_tpu_torch.messages import Meta, SeldonMessage
    from seldon_core_tpu_torch.ops import fused_mlp
    from seldon_core_tpu_torch.runtime.grpcfast import FastGrpcChannel

    counted = dev.type == "cuda"
    rng = np.random.default_rng(SEED)
    x1, x64 = rng.random((1, 784)), rng.random((64, 784))
    xc, xs = rng.random((NP_CONCURRENT, 784)), rng.random((NP_SEQUENTIAL, 784))
    bodies = ([("1-row ndarray", {"meta": {"puid": "np-1"}, "data": {"ndarray": x1.tolist()}}),
               ("64-row tensor", {"meta": {"puid": "np-64"}, "data": {"tensor": {
                   "shape": [64, 784], "values": x64.ravel().tolist()}}})]
              + [(f"concurrent {i}", {"data": {"ndarray": xc[i:i + 1].tolist()}})
                 for i in range(NP_CONCURRENT)]
              + [(f"sequential {i}", {"data": {"ndarray": xs[i:i + 1].tolist()}})
                 for i in range(NP_SEQUENTIAL)])
    grpc_xs = [("gRPC 1-row", x1, "np-g1"), ("gRPC 64-row", x64, "np-g64")]
    dispatches = [0]
    _count_calls(engine.compiled, "predict_arrays", dispatches)
    before = plane.stats()

    def grpc_calls(port):
        async def run():
            ch = await FastGrpcChannel().connect("127.0.0.1", port)
            try:
                return [protoconv.msg_from_proto(await ch.call(GRPC_PREDICT, protoconv.msg_to_proto(
                    SeldonMessage.from_array(x, meta=Meta(puid=puid))))) for _, x, puid in grpc_xs]
            finally:
                await ch.close()
        return asyncio.run(run())

    # the plane's requests: every count set to 0 just before, read just after
    fused_mlp.LAUNCHES = 0
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", plane.port, timeout=120)
    got = [np_post(conn, body) for _, body in bodies[:2]]

    def one(body):
        c = http.client.HTTPConnection("127.0.0.1", plane.port, timeout=120)
        try:
            return np_post(c, body)
        finally:
            c.close()

    with ThreadPoolExecutor(NP_CONCURRENT) as pool:
        got += list(pool.map(one, [b for _, b in bodies[2:2 + NP_CONCURRENT]]))
    got += [np_post(conn, body) for _, body in bodies[2 + NP_CONCURRENT:]]
    grpc_got = grpc_calls(plane.grpc_port)
    launches, batches = fused_mlp.LAUNCHES, dispatches[0]
    plane_s = time.perf_counter() - t0
    after = plane.stats()
    n_http, n_grpc = int(after[0] - before[0]), int(after[19] - before[19])
    n_requests = len(bodies) + len(grpc_xs)
    if n_http != len(bodies) or n_grpc != len(grpc_xs):
        raise AssertionError(f"[native] dp_stats counted {n_http} HTTP and {n_grpc} gRPC answers "
                             f"of {len(bodies)} and {len(grpc_xs)} sent")
    if not 1 <= batches <= n_requests or (counted and launches != batches):
        raise AssertionError(f"[native] {launches} fused-MLP launches in {batches} native "
                             f"batches for {n_requests} requests")
    # the same X through the Python fast lane of the twin engine
    fast = http.client.HTTPConnection("127.0.0.1", fast_port, timeout=120)
    for (what, body), (st, raw) in zip(bodies, got):
        np_same(np_answer(st, raw), np_answer(*np_post(fast, body)), what)
    for (what, _, puid), a, b in zip(grpc_xs, grpc_got, grpc_calls(fast_grpc)):
        if (not np.array_equal(a.array(), b.array()) or a.meta.puid != puid != b.meta.puid
                or a.status.code != 200 or a.data.names != b.data.names):
            raise AssertionError(f"[native] {what}: the plane's answer is not the Python lane's")
    stats = json.loads(request("GET", f"http://127.0.0.1:{plane.port}/stats")[1])["engine"]
    if stats["http_impl"] != "native" or stats["codec"] != "native":
        raise AssertionError(f"[native] /stats engine block {stats}")
    # the misc lane, each answer the Python lane's
    misc = {}
    ping = request("GET", f"http://127.0.0.1:{plane.port}/ping")
    prom = request("GET", f"http://127.0.0.1:{plane.port}/prometheus")[1].decode()
    counts = [float(line.rsplit(" ", 1)[1]) for line in prom.splitlines()
              if line.startswith("seldon_api_engine_server_requests_duration_seconds_count")
              and 'service="predictions"' in line]
    if ping != (200, b"pong") or sum(counts) < n_requests:
        raise AssertionError(f"[native] /ping {ping}, /prometheus predictions count {counts}")
    for what, body, path in (
            ("strData", {"strData": "hello"}, "/api/v0.1/predictions"),
            ("names", {"data": {"names": [f"f{i}" for i in range(784)],
                                "ndarray": x1.tolist()}}, "/api/v0.1/predictions"),
            ("feedback", {"request": {"data": {"ndarray": x1.tolist()}},
                          "response": json.loads(got[0][1]), "reward": 1.0},
             "/api/v0.1/feedback"),
            ("1e300", {"data": {"ndarray": [[1e300] * 784]}}, "/api/v0.1/predictions"),
            ("too narrow", {"data": {"ndarray": [[1.0, 2.0]]}}, "/api/v0.1/predictions")):
        a = request("POST", f"http://127.0.0.1:{plane.port}{path}", body)
        b = request("POST", f"http://127.0.0.1:{fast_port}{path}", body)
        ya, yb = np_answer(*a), np_answer(*b)
        if what == "feedback":
            ya, yb = ya[1:], yb[1:]
            if ya != yb:
                raise AssertionError(f"[native] feedback: {a} vs {b}")
        else:
            np_same(ya, yb, what)
        misc[what] = a[0]
    if misc["too narrow"] != 400 or not np_answer(*request(
            "POST", f"http://127.0.0.1:{plane.port}/api/v0.1/predictions",
            {"data": {"ndarray": [[1.0, 2.0]]}}))[4]["info"].startswith(
                "graph rejected input of shape"):
        raise AssertionError(f"[native] a too-narrow row answered {misc['too narrow']}")
    huge = np_answer(*request("POST", f"http://127.0.0.1:{plane.port}/api/v0.1/predictions",
                              {"data": {"ndarray": [[1e300] * 784]}}))[0]
    sse = [request("POST", f"http://127.0.0.1:{p}/api/v0.1/generate/stream",
                   {"data": {"ndarray": [[1, 2, 3]]}}) for p in (plane.port, fast_port)]
    if sse[0] != sse[1] or sse[0][0] != 400:  # MNIST cannot stream, on either lane
        raise AssertionError(f"[native] the SSE route of MNIST: {sse}")
    conn.close()
    fast.close()
    log(f"[native] MNIST through the C++ plane: {len(bodies)} HTTP requests (a 1-row ndarray, "
        f"a 64-row tensor, {NP_CONCURRENT} concurrent 1-row, {NP_SEQUENTIAL} sequential 1-row "
        f"on one keepalive connection) and {len(grpc_xs)} gRPC in {plane_s:.3f} s: every "
        f"answer the Python fast lane's float64 values bit for bit, names, puid and status "
        f"alike; {batches} native batches, {launches} fused-MLP launches; dp_stats "
        f"{n_http} + {n_grpc}; /stats http_impl {stats['http_impl']}, codec {stats['codec']} "
        f"({stats['codec_binding']}); misc lane {misc} and SSE {sse[0][0]} (as the Python "
        f"lane), a row "
        f"of 1e300 {int(np.isnan(huge).sum())} NaN read by json.loads; {smi}")
    return {"launches": launches, "batches": batches, "requests": n_requests,
            "dp_http": n_http, "dp_grpc": n_grpc, "codec_binding": stats["codec_binding"],
            "native_errors": stats["native_errors"], "misc": misc}


def np_sse(torch, dev, smi) -> int:
    """The SSE route of a graph that streams (a small generator on the
    static lane, which the plane takes) answers 501 on the plane, naming
    the Python lane."""
    dims = {"vocab": 256, "d_model": 64, "n_heads": 4, "n_layers": 2, "d_ff": 128,
            "max_new_tokens": 4}
    params = [{"name": k, "value": str(v), "type": "INT"} for k, v in dims.items()]
    doc = {"spec": {"name": "sse", "predictors": [{
        "name": "p", "graph": {"name": "g", "type": "MODEL"},
        "components": [{"name": "g", "runtime": "inprocess", "class_path": "TransformerGenerator",
                        "parameters": params}]}]}}
    engine = mode_engine(torch, dev, doc, continuous=False)
    planes = PlaneThread(engine)
    plane = planes.start()
    try:
        status, raw = request("POST", f"http://127.0.0.1:{plane.port}/api/v0.1/generate/stream",
                              {"data": {"ndarray": [[1, 2, 3]]}})
    finally:
        planes.stop()
        engine.close()
    if status != 501 or "ENGINE_HTTP_IMPL=fast" not in json.loads(raw)["status"]["reason"]:
        raise AssertionError(f"[native] a generator's SSE route on the plane: {status} {raw!r}")
    log(f"[native] a static-lane generator behind the plane: its SSE route answers 501 naming "
        f"the Python lane; {smi}")
    return status


def np_loadgen(exe: str, port: int, request_file: str, clients: int, seconds: float) -> dict:
    """One closed-loop run of the C++ load generator; its JSON line, with
    the client's CPU share (its user + system seconds over its wall)."""
    import resource

    before = resource.getrusage(resource.RUSAGE_CHILDREN)
    t0 = time.perf_counter()
    out = subprocess.run([exe, "--host", "127.0.0.1", "--port", str(port), "--api", "rest",
                          "--clients", str(clients), "--duration", str(seconds),
                          "--warmup", str(NP_WARMUP_S), "--request-file", request_file],
                         capture_output=True, text=True, timeout=60)
    wall = time.perf_counter() - t0
    after = resource.getrusage(resource.RUSAGE_CHILDREN)
    if out.returncode != 0:
        raise AssertionError(f"[native] loadgen exit {out.returncode}: {out.stderr[-500:]}")
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    cpu = (after.ru_utime - before.ru_utime) + (after.ru_stime - before.ru_stime)
    doc["client_cpu_share"] = cpu / wall
    if doc["failures"] or not doc["requests"]:
        raise AssertionError(f"[native] loadgen on :{port}: {doc}")
    return doc


def np_throughput(dev, smi, plane_port: int, fast_port: int, dispatches: dict) -> dict:
    """Part b: 1-row requests from NP_LOAD_CLIENTS keepalive connections
    and from one, the native plane and the Python fast lane in turns;
    ``dispatches`` holds each lane's engine's [dispatches, padded rows]."""
    from seldon_core_tpu_torch.native import _build

    exe = str(_build.build("loadgen"))
    body = json.dumps({"data": {"ndarray": np.random.default_rng(SEED + 1).random(
        (1, 784)).tolist()}}).encode()
    req = (b"POST /api/v0.1/predictions HTTP/1.1\r\nHost: b\r\nContent-Type: application/json\r\n"
           b"Content-Length: %d\r\n\r\n" % len(body) + body)
    path = ROOT / "build" / "native" / f"np_request_{os.getpid()}.http"
    path.write_bytes(req)
    ports = {"native": plane_port, "fast": fast_port}
    runs = {"native": [], "fast": []}
    server_cpu = {"native": [], "fast": []}
    try:
        for order in NP_ROUNDS:
            for lane in order:
                t = os.times()
                calls0, rows0 = dispatches[lane]
                many = np_loadgen(exe, ports[lane], str(path), NP_LOAD_CLIENTS, NP_LOAD_S)
                t2 = os.times()
                calls, rows = dispatches[lane]
                per_dispatch = (rows - rows0) / max(1, calls - calls0)
                one = np_loadgen(exe, ports[lane], str(path), 1, NP_ONE_S)
                # this process's CPU (the plane's threads or the Python lane) over
                # the 64-client run's wall
                server_cpu[lane].append(((t2.user - t.user) + (t2.system - t.system))
                                        / (t2.elapsed - t.elapsed))
                runs[lane].append({"qps": many["qps"], "p50_ms": many["p50_ms"],
                                   "p99_ms": many["p99_ms"], "one_p50_ms": one["p50_ms"],
                                   "one_p99_ms": one["p99_ms"],
                                   "client_cpu_share": many["client_cpu_share"],
                                   "rows_per_dispatch": per_dispatch})
    finally:
        path.unlink(missing_ok=True)
    out = {}
    for lane, rs in runs.items():
        out[lane] = {"runs": rs, "qps_median": float(np.median([r["qps"] for r in rs])),
                     "p50_ms_median": float(np.median([r["p50_ms"] for r in rs])),
                     "p99_ms_median": float(np.median([r["p99_ms"] for r in rs])),
                     "one_conn_p50_ms_median": float(np.median([r["one_p50_ms"] for r in rs])),
                     "client_cpu_share_max": max(r["client_cpu_share"] for r in rs),
                     "server_process_cpu_share": [round(c, 3) for c in server_cpu[lane]]}
        saturated = out[lane]["client_cpu_share_max"] > 0.9
        out[lane]["client_saturated"] = saturated
        log(f"[native] {lane} lane, 1-row requests from {NP_LOAD_CLIENTS} keepalive "
            f"connections (C++ closed-loop client, {len(rs)} runs of {NP_LOAD_S} s in turns): "
            f"{[r['qps'] for r in rs]} requests/s, p50 {[r['p50_ms'] for r in rs]} ms, p99 "
            f"{[r['p99_ms'] for r in rs]} ms, {[round(r['rows_per_dispatch'], 2) for r in rs]} "
            f"padded rows a dispatch; one connection p50 "
            f"{[r['one_p50_ms'] for r in rs]} ms; the client's CPU share "
            f"{[round(r['client_cpu_share'], 3) for r in rs]} of a core "
            f"({'saturated' if saturated else 'not saturated'}), this process's "
            f"{out[lane]['server_process_cpu_share']} cores; {smi}")
    out["qps_ratio_native_over_fast"] = out["native"]["qps_median"] / out["fast"]["qps_median"]
    return out


def np_engine_main(dev, smi) -> dict:
    """Part c: engine_main with ENGINE_HTTP_IMPL unset serves the native
    lane and says so; one request over REST and one over gRPC."""
    from seldon_core_tpu_torch import protoconv
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.runtime.grpcfast import FastGrpcChannel

    rest, grpc_port = free_port(), free_port()
    t0 = time.perf_counter()
    proc, line = start_service(
        ["seldon_core_tpu_torch.runtime.engine_main", "--file",
         str(ROOT / "examples" / "mnist_deployment.json"), "--device", dev.type, "--host",
         "127.0.0.1", "--rest-port", str(rest)],
        {"ENGINE_SERVER_GRPC_PORT": str(grpc_port)}, "engine up:")
    up_s = time.perf_counter() - t0
    try:
        x = np.random.default_rng(SEED + 2).random((1, 784))
        y_rest = np_answer(*request("POST", f"http://127.0.0.1:{rest}/api/v0.1/predictions",
                                    ndarray(x)))

        async def call():
            ch = await FastGrpcChannel().connect("127.0.0.1", grpc_port)
            try:
                return protoconv.msg_from_proto(await ch.call(
                    GRPC_PREDICT, protoconv.msg_to_proto(SeldonMessage.from_array(x))))
            finally:
                await ch.close()

        y_grpc = asyncio.run(call())
        stats = json.loads(request("GET", f"http://127.0.0.1:{rest}/stats")[1])["engine"]
    finally:
        tail = stop_service(proc)
    if ("http=native" not in line or f"grpc=:{grpc_port} (native)" not in line
            or stats["http_impl"] != "native" or y_rest[3] != 200
            or y_grpc.status.code != 200 or not np.array_equal(y_rest[0], y_grpc.array())):
        raise AssertionError(f"[native] engine_main: {line!r}, /stats {stats}, REST "
                             f"{y_rest[3]}, gRPC {y_grpc.status}; {tail[-500:]}")
    log(f"[native] engine_main with ENGINE_HTTP_IMPL unset: {line!r} (up in {up_s:.2f} s); "
        f"one REST and one gRPC request answered alike; {smi}")
    return {"line": line, "up_s": up_s}


def np_persistence(torch, dev, smi) -> dict:
    """Part d: ``microservice EpsilonGreedyRouter ROUTER --persistence 1``
    on the card: routes and rewards, a periodic save, a restart, and the
    restarted unit's routes against an in-process unit on the card
    restored from the same file."""
    import tempfile

    from seldon_core_tpu_torch.graph.spec import Parameter
    from seldon_core_tpu_torch.runtime import persistence
    from seldon_core_tpu_torch.runtime.microservice import build_runtime

    params = [{"name": "n_branches", "value": "3", "type": "INT"},
              {"name": "epsilon", "value": "0.5", "type": "FLOAT"}]
    state_dir = tempfile.mkdtemp(prefix="sct_state_")
    env = {"SELDON_TPU_STATE_DIR": state_dir, "PERSISTENCE_FREQUENCY": str(NP_SAVE_S),
           "PREDICTIVE_UNIT_ID": "eg", "SELDON_DEPLOYMENT_ID": "smoke", "PREDICTOR_ID": "p",
           "PREDICTIVE_UNIT_PARAMETERS": json.dumps(params)}
    ckpt = Path(state_dir) / "smoke_p_eg.ckpt.npz"
    body = {"data": {"ndarray": [[0.0] * 4]}}

    def serve(feedback: bool):
        port = free_port()
        proc, _ = start_service(
            ["seldon_core_tpu_torch.runtime.microservice", "EpsilonGreedyRouter", "REST",
             "--service-type", "ROUTER", "--persistence", "1", "--device", dev.type,
             "--host", "127.0.0.1", "--port", str(port)], env, "unit up:")
        url = f"http://127.0.0.1:{port}"
        try:
            routes, success, tries = [], np.zeros(3, np.float32), np.zeros(3, np.float32)
            for i in range(NP_ROUTES):
                st, raw = request("POST", f"{url}/route", body)
                routes.append(int(json.loads(raw)["data"]["ndarray"][0][0]))
                if feedback:
                    reward = float(routes[-1] == i % 3)
                    request("POST", f"{url}/send-feedback", {
                        "request": body, "reward": reward,
                        "response": {"meta": {"routing": {"eg": routes[-1]}},
                                     "data": {"ndarray": [[routes[-1]]]}}})
                    success[routes[-1]] += np.floor(np.float32(reward) * 1)
                    tries[routes[-1]] += 1
            t0 = time.perf_counter()
            while feedback:  # a save that holds every reward
                if ckpt.exists():
                    with np.load(ckpt) as data:
                        if float(data["['tries']"].sum()) == NP_ROUTES:
                            break
                if time.perf_counter() - t0 > 30:
                    raise AssertionError("[native] no checkpoint held the rewards in 30 s")
                time.sleep(0.1)
            return routes, success, tries
        finally:
            stop_service(proc)

    t0 = time.perf_counter()
    _, success, tries = serve(feedback=True)
    with np.load(ckpt) as data:
        saved = {k: np.array(data[k]) for k in data.files}
    if (saved["['success']"].tobytes() != success.tobytes()
            or saved["['tries']"].tobytes() != tries.tobytes()
            or saved["__prngkey__:['key']"].dtype != np.uint32):
        raise AssertionError(f"[native] the checkpoint {saved} is not the state before the "
                             f"stop: success {success}, tries {tries}")
    prev = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        twin = build_runtime("EpsilonGreedyRouter", "ROUTER",
                             [Parameter.from_json_dict(p) for p in params], unit_name="eg",
                             device=dev)
        persistence.restore_runtime(twin)
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    if twin.state["tries"].device.type != dev.type:
        raise AssertionError(f"[native] the restored state is on {twin.state['tries'].device}")
    want = []
    for _ in range(NP_ROUTES):
        branch, aux = twin.unit.route(twin.state, torch.zeros(1, 4, device=dev))
        twin.state = aux.state
        want.append(int(branch))
    routes, _, _ = serve(feedback=False)
    if routes != want:
        raise AssertionError(f"[native] the restarted unit routed {routes}, the unit restored "
                             f"in process {want}")
    log(f"[native] persistence on the card: {NP_ROUTES} routes with rewards, a save every "
        f"{NP_SAVE_S} s held success {success.tolist()} and tries {tries.tolist()} exactly, "
        f"the key as uint32 words; the restarted microservice's next {NP_ROUTES} routes are "
        f"those of a unit on the card restored from the file ({time.perf_counter() - t0:.2f} "
        f"s); {smi}")
    return {"success": success.tolist(), "tries": tries.tolist(), "routes_after": routes}


def native_phase(torch, dev, smi) -> dict:
    """10r. The native data plane, its codec and unit-state persistence
    ([4d]).  examples/mnist_deployment.json (bf16, seed 0) behind
    ``serve_native`` with its gRPC lane, prewarmed, and a second engine
    with the same weights behind the Python fast lane: (a) a 1-row ndarray,
    a 64-row tensor, 32 concurrent and 200 sequential keepalive 1-row
    requests and two gRPC calls through the plane, every answer the Python
    lane's float64 values bit for bit with names, puid and status alike;
    fused-MLP launches equal to the plane's batches (at least 1, at most
    the requests); dp_stats counting every request; /stats http_impl and
    codec "native"; the misc lane's /ping, /prometheus, strData, names,
    feedback, a row of 1e300 (NaN read by json.loads) and a too-narrow
    row's 400 as the Python lane answers them, and a static-lane
    generator's SSE route 501 on a plane of its own; (b) the
    plane and the Python lane in turns under a C++ closed-loop client
    (NP_LOAD_CLIENTS connections, and one); (c) engine_main with
    ENGINE_HTTP_IMPL unset on the native lane, REST and gRPC; (d) a
    persisted EpsilonGreedyRouter microservice on the card restarted from
    its checkpoint."""
    from seldon_core_tpu_torch.native import fastcodec

    t_phase = time.perf_counter()
    # the earlier phases pin their engine_mains to the Python lane; this one
    # takes the default
    os.environ.pop("ENGINE_HTTP_IMPL", None)
    pid = os.getpid()
    engine = mode_engine(torch, dev, example_doc("mnist"), continuous=False)
    twin = mode_engine(torch, dev, example_doc("mnist"), continuous=False)
    same = all(torch.equal(a, twin.states()["mnist"][k])
               for k, a in engine.states()["mnist"].items())
    if not same or not engine._pipelined or engine.codec != "native":
        raise AssertionError(f"[native] engines: same weights {same}, pipelined "
                             f"{engine._pipelined}, codec {engine.codec} "
                             f"{fastcodec.codec_status()}")
    t0 = time.perf_counter()
    n_warm = engine.prewarm([784])
    warm_s = time.perf_counter() - t0
    planes = PlaneThread(engine)
    plane = planes.start()
    lanes = LanesThread(twin, WIRE_HTTP_UDS % pid, WIRE_RELAY_UDS % pid)
    fast_port, fast_grpc = lanes.start()
    out = {"prewarm": {"shapes": n_warm, "s": warm_s}}
    try:
        out["mnist"] = np_mnist(torch, dev, smi, engine, twin, plane, fast_port, fast_grpc)
        dispatches = {"native": [0, 0], "fast": [0, 0]}
        for lane, eng in (("native", engine), ("fast", twin)):
            _count_rows(eng.compiled, dispatches[lane])
        out["throughput"] = np_throughput(dev, smi, plane.port, fast_port, dispatches)
    finally:
        planes.stop()
        lanes.stop()
        engine.close()
        twin.close()
    out["launches"] = {"fused_mlp_softmax": out["mnist"]["launches"]}
    out["sse"] = np_sse(torch, dev, smi)
    out["engine_main"] = np_engine_main(dev, smi)
    out["persistence"] = np_persistence(torch, dev, smi)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[native] phase 10r wall {out['wall_s']:.2f} s")
    return out


# -- 10s. MoE layers ([5e]) on the flagship width -------------------------------

#: the flagship generator with every 2nd layer a mixture of 8 experts, top-2
#: (LMConfig's defaults): 6 MoE layers, about 0.8 GB of expert stacks in bf16
MOE_PARAMS = {"moe_every": 2, "n_experts": 8, "moe_k": 2}
MOE_B = 4
MOE_PROMPTS = (128, 100)   # prompt lengths: the flash forward at 128, the plain one at 100
MOE_TRAIN_STEPS = 5
#: step 0's training loss, kernel path against the plain path: the mean over
#: 8,192 tokens of f32 nll, the MoE routing included (a near-tie routed
#: otherwise moves a token's FFN output, not the mean)
MOE_LOSS_RTOL = 1e-2


def forced_route(torch, moe, gates, cfg, capacity: int, expert):
    """``moe._route`` with the experts chosen given (``expert`` [T, k]):
    the same queue slots, capacity and combine weights from ``gates``."""
    import torch.nn.functional as F

    T, E = gates.shape
    rows = torch.arange(T, device=gates.device)
    used = torch.zeros(E, dtype=torch.int64, device=gates.device)
    slots, keeps, vals = [], [], []
    for j in range(cfg.k):
        idx = expert[:, j]
        onehot = F.one_hot(idx, E)
        pos = (torch.cumsum(onehot, dim=0) - 1)[rows, idx] + used[idx]
        keep = pos < capacity
        slots.append(pos)
        keeps.append(keep)
        vals.append(gates[rows, idx])
        used += (onehot * keep[:, None]).sum(0)
    slot, kept = torch.stack(slots, dim=1), torch.stack(keeps, dim=1)
    weight = torch.stack(vals, dim=1) * kept
    if cfg.k > 1:
        weight = weight / torch.clamp(weight.sum(dim=1, keepdim=True), min=1e-9)
    return moe.Routing(expert, slot, weight, kept)


class RoutingTape:
    """Records each MoE call's gates and chosen experts (``moe._route``
    wrapped); with ``force`` (another tape's calls) each call takes that
    call's experts instead and records the ones it would have chosen."""

    def __init__(self, torch, moe, force=None):
        self.torch, self.moe = torch, moe
        self.force = None if force is None else [c["expert"] for c in force]
        self.calls = []

    def __enter__(self):
        orig = self._orig = self.moe._route

        def route(gates, cfg, capacity):
            own = orig(gates, cfg, capacity)
            self.calls.append({"gates": gates.detach().float(), "expert": own.expert})
            if self.force is None:
                return own
            return forced_route(self.torch, self.moe, gates, cfg, capacity,
                                self.force[len(self.calls) - 1])

        self.moe._route = route
        return self

    def __exit__(self, *exc):
        self.moe._route = self._orig


def moe_replay(torch, gm, params, cfg, prompts, toks, dev, use_flash: bool):
    """A static-lane generation's logits [B, n, V] with its tokens forced:
    the prefill over the prompts, then one cached step a token, as
    ``generate`` runs them (the same B*S and B token streams, so the same
    capacities)."""
    B, S = prompts.shape
    n = toks.shape[1]
    with torch.inference_mode():
        main = gm.init_cache(cfg, B, S, dev)
        logits, main = gm.prefill(params, torch.as_tensor(prompts, dtype=torch.int32, device=dev),
                                  main, cfg, use_flash)
        out = [logits]
        chunk = gm.init_chunk(cfg, B, n - 1, dev)
        t = torch.as_tensor(toks, dtype=torch.int32, device=dev)
        for i in range(n - 1):
            logits, chunk = gm.decode_step_two_tier(params, t[:, i], main, chunk, S, i, cfg,
                                                    use_flash)
            out.append(logits)
        return torch.stack(out, dim=1)


def moe_held(torch, gm, moe, params, cfg, prompts, toks, dev, what: str) -> dict:
    """The served tokens against the plain path (attention="xla") on the
    same weights: the kernel path's replay records its routing; the plain
    replay takes that routing, and each served token must be within
    TOKEN_DELTA of its maximum logit (the teacher-forced gap rule).  Where
    the plain path's own gates would route a token otherwise (a flip), its
    gate margin must be within twice the token's largest gate difference
    between the two paths: a near-tie that the input's rounding decides."""
    with RoutingTape(torch, moe) as kern:
        k_logits = moe_replay(torch, gm, params, cfg, prompts, toks, dev, True)
    with RoutingTape(torch, moe, force=kern.calls) as plain:
        p_logits = moe_replay(torch, gm, params, cfg, prompts, toks, dev, False)
    tok = torch.as_tensor(toks, dtype=torch.long, device=dev)
    gap = (p_logits.max(dim=-1).values - p_logits.gather(-1, tok[..., None])[..., 0]).float()
    same = float((k_logits.argmax(dim=-1) == tok).float().mean())
    layers = [i for i in range(cfg.n_layers) if cfg.is_moe_layer(i)]
    flips = {f"l{i}": [0, 0] for i in layers}
    worst_margin, worst_delta = 0.0, 0.0
    for c, (kc, pc) in enumerate(zip(kern.calls, plain.calls)):
        ks = kc["expert"].sort(dim=1).values
        ps = pc["expert"].sort(dim=1).values
        flipped = (ks != ps).any(dim=1)
        row = flips[f"l{layers[c % len(layers)]}"]
        row[0] += int(flipped.sum())
        row[1] += int(ks.shape[0])
        delta = (kc["gates"] - pc["gates"]).abs().max(dim=1).values
        worst_delta = max(worst_delta, float(delta.max()))
        for t in flipped.nonzero().flatten().tolist():
            g = pc["gates"][t]
            kset, pset = set(ks[t].tolist()), set(ps[t].tolist())
            margin = max(float(g[o] - g[k]) for o in pset - kset for k in kset - pset)
            worst_margin = max(worst_margin, margin)
            if margin > 2 * float(delta[t]) + 1e-6:
                raise AssertionError(f"[moe] {what}: a routing flip at call {c}, token {t} has "
                                     f"gate margin {margin:.3e}, more than twice the paths' gate "
                                     f"difference {float(delta[t]):.3e}")
    share = {k: (v[0] / v[1] if v[1] else 0.0) for k, v in flips.items()}
    log(f"[moe] {what}: {gap.numel()} tokens, plain path on the kernel path's routing: the "
        f"maximum minus the token's logit max {float(gap.max()):.5f} (delta {TOKEN_DELTA}); "
        f"the kernel replay's argmax equals {same * 100:.2f}% of the served tokens; routing "
        f"flips by layer (tokens whose expert set differs) {share}, largest flipped gate "
        f"margin {worst_margin:.3e}, largest gate difference {worst_delta:.3e}")
    if float(gap.max()) > TOKEN_DELTA:
        raise AssertionError(f"[moe] {what}: a served token is {float(gap.max()):.4f} below "
                             f"the plain path's maximum")
    return {"tokens": int(gap.numel()), "gap_max": float(gap.max()), "replay_argmax_share": same,
            "flip_share": share, "flips": {k: v[0] for k, v in flips.items()},
            "flip_margin_max": worst_margin, "gate_delta_max": worst_delta}


def moe_serve(torch, dev, smi, counts: dict) -> tuple:
    """The flagship MoE generator through EngineService with the continuous
    switch on: the static lane serves it (no continuous_spec; /stats
    genserver null), B=4 prompts of 128 and 100 tokens, each dispatch's
    launches counted, the tokens held to the plain path, the request wall
    p50, and an MoE FFN's device ms a decode step beside a dense FFN's.
    Returns (the phase's record, the engine's params)."""
    from seldon_core_tpu_torch.models import generate as gm
    from seldon_core_tpu_torch.models.transformer import _ffn
    from seldon_core_tpu_torch.ops import flash_attention as fa, flash_decode as fd
    from seldon_core_tpu_torch.ops import kv_write as kw
    from seldon_core_tpu_torch.parallel import moe

    doc = gen_deployment(params=MOE_PARAMS)
    t0 = time.perf_counter()
    engine = mode_engine(torch, dev, doc, continuous=False,
                         env={"SELDON_TPU_GEN_CONTINUOUS": "1"})
    build_s = time.perf_counter() - t0
    unit = engine.compiled.units["gen"]
    cfg, params = unit.cfg, engine.states()["gen"]["params"]
    if not (unit.batch_coupled and unit.use_flash and engine.batcher is None
            and engine.stats()["genserver"] is None):
        raise AssertionError("[moe] the MoE generator is not served batch-coupled on the "
                             "static lane through the kernels")
    experts = sum(t.numel() * t.element_size() for i in range(cfg.n_layers)
                  if cfg.is_moe_layer(i) for t in params[f"l{i}"]["moe"].values())
    if params["l1"]["moe"]["wg"].dtype != torch.float32:
        raise AssertionError("[moe] the router is not f32 in the bf16 model")
    new = GEN_DIMS["max_new_tokens"]
    rng = np.random.default_rng(SEED + 22)
    served, launches = {}, {}
    server = ServerThread(engine)
    port = server.start()
    try:
        for S in MOE_PROMPTS:
            prompts = rng.integers(0, cfg.vocab, size=(MOE_B, S))
            reset_counts(fa, fd, kw)
            st, raw = request("POST", f"http://127.0.0.1:{port}/api/v0.1/predictions",
                              ndarray(prompts))
            got = read_counts(fa, fd, kw)
            served[S] = (prompts, check_tokens(st, raw, prompts, "ndarray", new, cfg.vocab))
            launches[S] = got
            for name, n in got.items():
                counts[name] = counts.get(name, 0) + n
            want = {"flash_attention": cfg.n_layers if S % 128 == 0 else 0,
                    "flash_decode": cfg.n_layers * (new - 1), "kv_write": 0,
                    "flash_decode_paged": 0, "kv_write_paged": 0}
            if got != want:
                raise AssertionError(f"[moe] a {MOE_B}x{S} dispatch launched {got}, not {want}")
        body = ndarray(served[100][0])
        walls = []
        for _ in range(4):
            t = time.perf_counter()
            st, raw = request("POST", f"http://127.0.0.1:{port}/api/v0.1/predictions", body)
            walls.append(time.perf_counter() - t)
            check_tokens(st, raw, served[100][0], "ndarray", new, cfg.vocab)
    finally:
        server.stop()
    held = {S: moe_held(torch, gm, moe, params, cfg, p, y, dev, f"{MOE_B}x{S} served")
            for S, (p, y) in served.items()}
    # one decode step's FFNs at B = 4: the MoE layer against the dense one
    h = torch.randn(MOE_B, 1, cfg.d_model, generator=torch.Generator().manual_seed(SEED),
                    dtype=torch.float32).to(dev, cfg.dtype)
    moe_lp = params["l1"]
    dense_lp = params["l0"]
    with torch.inference_mode():
        # the MoE layer reads nothing back to the host: a sync would raise
        torch.cuda.set_sync_debug_mode("error")
        try:
            _ffn(moe_lp, h, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        # the kernels' device time from the profiler: the MoE layer's ~70
        # small launches take longer to enqueue than to run, so events
        # around a run of calls would time the host
        ffn = {}
        for name, lp in (("moe", moe_lp), ("dense", dense_lp)):
            prof = device_profile(torch, lambda lp=lp: [_ffn(lp, h, cfg) for _ in range(20)],
                                  f"{name}_ffn")
            ffn[name] = {"device_ms": prof["kernel_ms"] / 20, "host_wall_ms": prof["wall_ms"] / 20,
                         "launches": prof["kernels"] / 20}
        moe_ms, dense_ms = ffn["moe"]["device_ms"], ffn["dense"]["device_ms"]
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    rec = {"build_s": build_s, "expert_bytes": experts, "launches": launches,
           "held": held, "request_wall_p50_ms": float(np.median(walls) * 1e3),
           "request_walls_ms": [w * 1e3 for w in walls],
           "ffn_per_layer": ffn,
           "ffn_device_ms_per_decode_step": {"moe": moe_ms * n_moe, "dense": dense_ms * n_moe},
           "card": smi}
    log(f"[moe] flagship MoE ({n_moe} of {cfg.n_layers} layers, {cfg.n_experts} experts "
        f"top-{cfg.moe_k}, {experts / 1e9:.3f} GB of expert "
        f"stacks) on the static lane with the continuous switch on (genserver null); launches "
        f"{launches}; {MOE_B}x100 request wall p50 {rec['request_wall_p50_ms']:.3f} ms; one "
        f"decode step's FFN at B={MOE_B}, device ms from the profiler: MoE {moe_ms:.5f} a layer "
        f"({moe_ms * n_moe:.5f} a step over {n_moe} layers; {ffn['moe']['launches']:.0f} "
        f"launches and {ffn['moe']['host_wall_ms']:.4f} ms of host wall a layer) against dense "
        f"{dense_ms:.5f} ({ffn['dense']['launches']:.0f} launches, "
        f"{ffn['dense']['host_wall_ms']:.4f} ms) on {smi}")
    engine.close()
    return rec, params, cfg


def moe_example(torch, dev, smi) -> dict:
    """examples/generator_ep_deployment.json's parameters (f32) without its
    mesh_axes on one card, its tokens held to its CPU twin's."""
    doc = example_doc("generator_ep")
    del doc["spec"]["predictors"][0]["components"][0]["mesh_axes"]
    engine = mode_engine(torch, dev, doc, continuous=False, env={"SELDON_TPU_GEN_CONTINUOUS": "1"})
    twin = cpu_twin(torch, engine, doc)
    prompts = np.random.default_rng(SEED + 23).integers(0, 256, size=(3, 9))
    try:
        answers = [asyncio.run(e.predict_json(json.dumps(ndarray(prompts)))) for e in
                   (engine, twin)]
    finally:
        engine.close()
        twin.close()
    card, cpu = (check_tokens(st, raw.encode() if isinstance(raw, str) else raw, prompts,
                              "ndarray", new=12, vocab=256) for raw, st in answers)
    if not np.array_equal(card, cpu):
        raise AssertionError(f"[moe] the ep example's tokens differ from its CPU twin's: "
                             f"{int((card != cpu).sum())} of {card.size}")
    log(f"[moe] examples/generator_ep_deployment.json without mesh_axes (4 experts top-2 in "
        f"every layer, f32): 3x9 prompts -> 3x12 tokens, identical to its CPU twin's on {smi}")
    return {"tokens": int(card.size), "identical": True}


def moe_train(torch, dev, smi, params, cfg) -> dict:
    """5 steps of lm_train_step at B=16, S=512 from the served weights, on
    one batch of the copy task (so the loss falls if the gradients are
    right; fresh batches' losses move more between batches than 5 steps
    learn): launches, a falling finite loss, the router and the experts
    moved, step 0's loss against the plain path; then the checkpoint
    served through weights_path."""
    from seldon_core_tpu_torch.models.generate import generate
    from seldon_core_tpu_torch.models.transformer import (
        lm_loss, lm_train_step, resolve_train_flash, save_lm_weights)
    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.optim import adam
    from seldon_core_tpu_torch.tree import leaves_with_paths, tree_map

    if not resolve_train_flash(cfg, dev):
        raise AssertionError("[moe] training did not take the flash kernels")
    params = tree_map(lambda t: t.detach().clone(), params)  # the served ones stay as they were
    first = {"tokens": torch.as_tensor(copy_batch(np.random.default_rng(SEED + 24), cfg.vocab),
                                       dtype=torch.int32, device=dev)}
    with torch.no_grad():
        loss_k = float(lm_loss(params, first, cfg, use_flash=True))
        loss_p = float(lm_loss(params, first, cfg, use_flash=False))
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    if loss_rel > MOE_LOSS_RTOL:
        raise AssertionError(f"[moe] step 0's loss: kernel path {loss_k}, plain path {loss_p}")
    opt = adam(TRAIN_LR)
    state = opt.init(params)
    start = params
    losses, walls = [], []
    torch.cuda.reset_peak_memory_stats(dev)
    fa.LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
    for _ in range(MOE_TRAIN_STEPS):
        t = time.perf_counter()
        params, state, loss = lm_train_step(params, state, first, opt, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        losses.append(float(loss))
    launches = {"fwd": fa.LAUNCHES, "dq": fa.DQ_LAUNCHES, "dkv": fa.DKV_LAUNCHES}
    peak = torch.cuda.max_memory_allocated(dev)
    want = cfg.n_layers * MOE_TRAIN_STEPS
    if launches != {"fwd": want, "dq": want, "dkv": want}:
        raise AssertionError(f"[moe] {MOE_TRAIN_STEPS} steps launched {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"[moe] training losses {losses}")
    moved = {name: not torch.equal(start["l1"]["moe"][name], params["l1"]["moe"][name])
             for name in ("wg", "w1", "w2")}
    if not all(moved.values()) or params["l1"]["moe"]["wg"].dtype != torch.float32:
        raise AssertionError(f"[moe] training moved {moved}")
    rec = {"step0_loss": {"kernel": loss_k, "plain": loss_p, "rel": loss_rel,
                          "rtol": MOE_LOSS_RTOL},
           "losses": losses, "launches": launches, "step_wall_p50_ms": float(np.median(walls) * 1e3),
           "step_walls_ms": [w * 1e3 for w in walls], "max_memory_allocated": peak, "card": smi}
    log(f"[moe] step 0's loss at B={TRAIN_B}, S={first['tokens'].shape[1] - 1}: kernel path "
        f"{loss_k:.6f}, plain path "
        f"{loss_p:.6f} (relative {loss_rel:.3e}, tolerance {MOE_LOSS_RTOL}); {MOE_TRAIN_STEPS} "
        f"steps of adam({TRAIN_LR}) on that batch: loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches "
        f"{launches}; wg, w1 and w2 moved; step wall p50 {rec['step_wall_p50_ms']:.3f} ms, "
        f"max_memory_allocated {peak / 1e9:.3f} GB on {smi}")
    # the hand-off: the trained checkpoint through weights_path
    path = ROOT / "build" / "chip_smoke_trained_moe.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        save_lm_weights(params, str(path))
        engine = mode_engine(torch, dev, gen_deployment(weights_path=str(path), params=MOE_PARAMS),
                             continuous=False, env={"SELDON_TPU_GEN_CONTINUOUS": "1"})
    finally:
        path.unlink(missing_ok=True)
    try:
        served_params = engine.states()["gen"]["params"]
        for (key, a), (_, b) in zip(leaves_with_paths(served_params), leaves_with_paths(params)):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"[moe] the served weights differ from the trained at {key}")
        prompt = copy_batch(np.random.default_rng(SEED + 25), cfg.vocab)[:2, :100]
        text, st = asyncio.run(engine.predict_json(json.dumps(ndarray(prompt))))
    finally:
        engine.close()
    served = check_tokens(st, text.encode(), prompt, "ndarray", GEN_DIMS["max_new_tokens"],
                          cfg.vocab)
    with torch.inference_mode():
        local = generate(params, torch.as_tensor(prompt, dtype=torch.int32, device=dev), cfg,
                         GEN_DIMS["max_new_tokens"], use_flash=True).cpu().numpy()
    if not np.array_equal(served, local):
        raise AssertionError(f"[moe] the checkpoint's served tokens differ from generate on the "
                             f"trained params: {int((served != local).sum())}")
    log(f"[moe] the trained checkpoint served through weights_path (every leaf bit-identical, "
        f"wg f32): 2x100 -> 2x{served.shape[1]} tokens identical to generate on the trained "
        f"params")
    rec["handoff_identical"] = True
    return rec


def moe_phase(torch, dev, smi) -> dict:
    """10s. MoE layers ([5e]) at the flagship width: served, the ep example
    on one card, trained 5 steps, the checkpoint served."""
    t_phase = time.perf_counter()
    counts: dict = {}
    out = {}
    out["serve"], params, cfg = moe_serve(torch, dev, smi, counts)
    out["example"] = moe_example(torch, dev, smi)
    out["train"] = moe_train(torch, dev, smi, params, cfg)
    del params
    torch.cuda.empty_cache()
    out["launches"] = {**counts, "flash_attention_bwd_dq": out["train"]["launches"]["dq"],
                       "flash_attention_bwd_dkv": out["train"]["launches"]["dkv"],
                       "flash_attention_train": out["train"]["launches"]["fwd"]}
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[moe] phase 10s wall {out['wall_s']:.2f} s")
    return out


# -- 10t. the disaggregated prefill/decode roles ([6d]) on one card ---------------

#: the prefill chunk fixed (floor = ceiling), so every replica prefills a
#: prompt in the same chunks and the greedy tokens can be compared exactly
DISAGG_ENV = {"SELDON_TPU_GEN_CONTINUOUS": "1", "SELDON_TPU_GEN_PREFILL_CHUNK": "128",
              "SELDON_TPU_GEN_PREFILL_CHUNK_MAX": "128"}


def disagg_socket(pid: int) -> str:
    path = ROOT / "build" / f"kv_{pid}.sock"
    return str(path) if len(str(path)) < 100 else f"/tmp/sct_kv_{pid}.sock"


def start_engines(specs: dict, dev) -> dict:
    """engine_main processes started together: ``specs`` maps a name to
    (deployment file, extra argv, env); returns name -> (proc, rest port,
    "engine up" line) once every one is up."""
    procs = {}
    for name, (doc_path, argv, env) in specs.items():
        port = free_port()
        cmd = [sys.executable, "-m", "seldon_core_tpu_torch.runtime.engine_main", "--file",
               str(doc_path), "--device", dev.type, "--host", "127.0.0.1", "--rest-port",
               str(port), *argv]
        procs[name] = (subprocess.Popen(
            cmd, cwd=ROOT, env={**os.environ, **DISAGG_ENV,
                                "ENGINE_SERVER_GRPC_PORT": str(free_port()), **env},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), port)
    up = {}
    try:
        for name, (proc, port) in procs.items():
            start = time.perf_counter()
            while True:
                line = proc.stdout.readline()
                if line.startswith("engine up:"):
                    up[name] = (proc, port, line.strip())
                    break
                if not line or time.perf_counter() - start > 300:
                    raise AssertionError(f"[disagg] {name} did not come up: "
                                         f"{(line + proc.stdout.read())[-1500:]}")
    except BaseException:
        for proc, _ in procs.values():
            proc.kill()
        raise
    return up


def kernel_counts(port: int) -> tuple:
    st, raw = request("GET", f"http://127.0.0.1:{port}/stats")
    if st != 200:
        raise AssertionError(f"[disagg] /stats answered {st}")
    doc = json.loads(raw)
    return ({k: v["launches"] for k, v in doc["kernels"].items()}, doc["genserver"])


def sse_ttft(port: int, prompt) -> tuple:
    """Seconds to the first frame of a 1-token-chunk stream, and its tokens
    once it ends."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    t0 = time.perf_counter()
    conn.request("POST", "/api/v0.1/generate/stream",
                 json.dumps({**ndarray(prompt), "chunk": 1}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        raise AssertionError(f"[disagg] a stream answered {resp.status}")
    first, toks = None, []
    for line in resp:
        if not line.startswith(b"data: "):
            continue
        if first is None:
            first = time.perf_counter() - t0
        ev = json.loads(line[6:])
        if ev.get("done"):
            break
        toks += ev["tokens"][0]
    conn.close()
    return first, toks


def disagg_pair(torch, dev, smi, what: str, doc: dict, procs: dict, prefills: list,
                decode: str, prompts: list) -> dict:
    """Greedy tokens through each prefill replica against an in-process
    unified engine on the same (seeded) weights; each side's launches from
    its /stats (after the traffic minus before it); the hand-off bytes and
    ms a sequence; TTFT and the request wall p50 against the unified
    engine's, in turns."""
    unified = mode_engine(torch, dev, doc, continuous=True, env=DISAGG_ENV)
    server = ServerThread(unified)
    uport = server.start()
    out = {"prefill": {}}
    try:
        want = []
        for p in prompts:
            st, raw = request("POST", f"http://127.0.0.1:{uport}/api/v0.1/predictions",
                              ndarray(p))
            want.append(check_tokens(st, raw, p, "ndarray", new=unified.genserver.max_new_tokens,
                                     vocab=unified.genserver.cfg.vocab))
        n_layers = unified.genserver.cfg.n_layers
        d_port = procs[decode][1]
        d_before, d_gen0 = kernel_counts(d_port)
        for name in prefills:
            port = procs[name][1]
            before, gen0 = kernel_counts(port)
            for p, w in zip(prompts, want):
                st, raw = request("POST", f"http://127.0.0.1:{port}/api/v0.1/predictions",
                                  ndarray(p))
                got = check_tokens(st, raw, p, "ndarray", new=w.shape[1],
                                   vocab=unified.genserver.cfg.vocab)
                if not np.array_equal(got, w):
                    raise AssertionError(f"[disagg] {what} via {name}: tokens differ from the "
                                         f"unified engine's in {int((got != w).sum())} places")
            after, gen1 = kernel_counts(port)
            delta = {k: after[k] - before[k] for k in after}
            ticks = gen1["prefill_dispatches_total"] - gen0["prefill_dispatches_total"]
            disagg = gen1["disagg"]
            if (gen1["role"] != "prefill" or delta["kv_write_paged"] != n_layers * ticks
                    or ticks < len(prompts) or delta["flash_decode_paged"] != 0):
                raise AssertionError(f"[disagg] {what} via {name}: role {gen1['role']}, "
                                     f"launches {delta} over {ticks} prefill ticks")
            ok = disagg["handoffs"].get("ok", 0)
            out["prefill"][name] = {
                "launches": delta, "prefill_ticks": ticks, "handoffs": disagg["handoffs"],
                "bytes_per_sequence": disagg["bytes_total"] / max(ok, 1),
                "handoff_ms_p50": disagg["handoff_ms_p50"], "peers": disagg["peers"]}
        d_after, d_gen1 = kernel_counts(d_port)
        d_delta = {k: d_after[k] - d_before[k] for k in d_after}
        steps = d_gen1["decode_steps_total"] - d_gen0["decode_steps_total"]
        imported = (d_gen1["imports"]["committed_total"]
                    - d_gen0["imports"]["committed_total"])
        if (d_gen1["role"] != "decode" or d_delta["kv_write_paged"] != 0
                or d_delta["flash_decode_paged"] != n_layers * steps or steps == 0
                or imported != len(prompts) * len(prefills)):
            raise AssertionError(f"[disagg] {what} decode side: role {d_gen1['role']}, "
                                 f"launches {d_delta} over {steps} decode steps, {imported} "
                                 f"imports")
        out["decode"] = {"launches": d_delta, "decode_steps": steps, "imports": imported}
        # TTFT and the request wall, the unified engine and the first prefill
        # replica in turns
        port = procs[prefills[0]][1]
        p = prompts[0]
        timing = {"unified": {"ttft": [], "wall": []}, "disagg": {"ttft": [], "wall": []}}
        for lane in ("unified", "disagg", "disagg", "unified", "unified", "disagg"):
            lp = uport if lane == "unified" else port
            ttft, toks = sse_ttft(lp, p)
            if toks != want[0][0].tolist():
                raise AssertionError(f"[disagg] {what}: the {lane} stream's tokens differ")
            t = time.perf_counter()
            st, raw = request("POST", f"http://127.0.0.1:{lp}/api/v0.1/predictions", ndarray(p))
            timing[lane]["wall"].append(time.perf_counter() - t)
            timing[lane]["ttft"].append(ttft)
        out["timing_ms"] = {lane: {k: float(np.median(v) * 1e3) for k, v in d.items()}
                            for lane, d in timing.items()}
        # the chain's ms (export, stream, the remote decode), over every
        # hand-off of that replica: the first (cold) two and the turns' six
        disagg = kernel_counts(port)[1]["disagg"]
        out["prefill"][prefills[0]]["handoff_ms_all"] = {
            "handoffs": disagg["handoffs"], "p50": disagg["handoff_ms_p50"],
            "p99": disagg["handoff_ms_p99"]}
    finally:
        server.stop()
        unified.close()
    first = out["prefill"][prefills[0]]
    log(f"[disagg] {what}: greedy tokens through {prefills} identical to a unified engine's "
        f"({len(prompts)} prompts of {[p.shape[1] for p in prompts]} tokens each); prefill "
        f"side launches {first['launches']} over {first['prefill_ticks']} ticks; decode side "
        f"{out['decode']['launches']} over {out['decode']['decode_steps']} steps; hand-off "
        f"{first['bytes_per_sequence']:.0f} bytes a sequence, chain p50 "
        f"{first['handoff_ms_p50']:.3f} ms over the first two, "
        f"{first['handoff_ms_all']['p50']:.3f} over all {first['handoff_ms_all']['handoffs']}; "
        f"TTFT p50 {out['timing_ms']['disagg']['ttft']:.3f} ms against unified "
        f"{out['timing_ms']['unified']['ttft']:.3f}, request wall p50 "
        f"{out['timing_ms']['disagg']['wall']:.3f} against {out['timing_ms']['unified']['wall']:.3f}"
        f" on {smi}")
    return out


def disagg_kill_switch(torch, dev, doc: dict, peer: str, prompt) -> dict:
    """SELDON_TPU_DISAGG=0: replicas told to take either role serve as
    unified, the unified engine's tokens."""
    from seldon_core_tpu_torch.graph.defaulting import default_and_validate
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.runtime.engine import EngineService

    prev = {k: os.environ.get(k) for k in ("SELDON_TPU_DISAGG", *DISAGG_ENV)}
    os.environ.update({"SELDON_TPU_DISAGG": "0", **DISAGG_ENV})
    try:
        answers = {}
        for role in ("unified", "prefill", "decode"):
            engine = EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(doc)),
                                   device=dev, gen_role=role, decode_peers=[peer])
            try:
                if engine.gen_role != "unified" or engine.genserver.role != "unified":
                    raise AssertionError(f"[disagg] SELDON_TPU_DISAGG=0: role {role} serves "
                                         f"as {engine.gen_role}")
                text, st = asyncio.run(engine.predict_json(json.dumps(ndarray(prompt))))
                answers[role] = check_tokens(st, text.encode(), prompt, "ndarray",
                                             new=engine.genserver.max_new_tokens,
                                             vocab=engine.genserver.cfg.vocab)
            finally:
                engine.close()
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if not all(np.array_equal(a, answers["unified"]) for a in answers.values()):
        raise AssertionError("[disagg] SELDON_TPU_DISAGG=0: the roles' tokens differ")
    log("[disagg] SELDON_TPU_DISAGG=0: engines told to take the prefill and the decode role "
        "serve as unified, the unified engine's tokens")
    return {"unified": True}


def disagg_shed(port: int, prompt) -> dict:
    """The prefill replica at ``port``, its chain mean warm from the
    hand-offs before: a request whose Seldon-Deadline-Ms budget is a
    quarter of that mean answers a typed 503 with the autopilot's prefix
    before any prefill (no tick, no kv_write_paged launch)."""
    from seldon_core_tpu_torch.runtime.autopilot import SHED_INFO_PREFIX

    before, gen0 = kernel_counts(port)
    chain_ms = gen0["disagg"]["chain_ewma_ms"]
    if not chain_ms:
        raise AssertionError("[disagg] the prefill replica's chain mean is not warm")
    budget = max(1, int(chain_ms / 4))
    st, raw = request_headers("POST", f"http://127.0.0.1:{port}/api/v0.1/predictions",
                              ndarray(prompt), {"Seldon-Deadline-Ms": str(budget)})
    after, gen1 = kernel_counts(port)
    info = json.loads(raw).get("status", {}).get("info", "") if raw.startswith(b"{") else ""
    ticks = gen1["prefill_dispatches_total"] - gen0["prefill_dispatches_total"]
    writes = after["kv_write_paged"] - before["kv_write_paged"]
    if st != 503 or not info.startswith(SHED_INFO_PREFIX) or ticks or writes:
        raise AssertionError(f"[disagg] a {budget} ms budget under a {chain_ms} ms chain "
                             f"answered {st} {raw[:200]!r}; {ticks} prefill ticks, {writes} "
                             f"kv_write_paged launches")
    log(f"[disagg] shed: the prefill replica's chain mean {chain_ms:.3f} ms, a request with "
        f"Seldon-Deadline-Ms {budget} answered 503 ({info[:60]}...), 0 prefill ticks and 0 "
        f"kv_write_paged launches")
    return {"chain_ewma_ms": chain_ms, "budget_ms": budget, "status": st, "prefill_ticks": 0,
            "kv_write_paged": 0}


DISAGG_MESH_NEW = 16   # the flagship's decode replica over tp=4: 16 new tokens a prompt


class WireLoopback:
    """A prefill replica's coordinator in process: each export goes to a
    decode ``GenServer`` as the relay carries it (every frame encoded and
    parsed: BEGIN, the KV_BLOCKS chunks, COMMIT), without the socket; the
    frames' bytes are counted."""

    def __init__(self, decode):
        self.decode = decode
        self.bytes = []

    def submit(self, export, done_cb):
        threading.Thread(target=self._run, args=(export, done_cb), daemon=True).start()

    def _run(self, export, done_cb):
        from seldon_core_tpu_torch.runtime import kvstream

        hid = os.urandom(16)
        try:
            begin = kvstream.begin_frame(export, hid)
            _, h, body = kvstream.parse_frame(begin)
            meta = kvstream.parse_begin(body)
            self.decode.kv_reserve(h, meta)
            nbytes = len(begin)
            for frame in kvstream.block_frames(export, hid):
                nbytes += len(frame)
                _, h2, b2 = kvstream.parse_frame(frame)
                first, layers = kvstream.parse_blocks(b2, meta)
                self.decode.kv_receive(h2, first, layers)
            req = self.decode.kv_commit(h)
            self.bytes.append(nbytes + len(kvstream.commit_frame(hid)))
            done_cb(np.asarray(req.future.result(600))[0])
        except BaseException as e:  # noqa: BLE001 - surfaced per request
            done_cb(e)

    def chain_estimate_s(self):
        return None

    def snapshot(self):
        return {}

    def close(self):
        pass


def disagg_mesh(torch, dev, smi) -> dict:
    """Decode replicas over {"tp": 4} (four cards, else four shards of
    cuda:0), each fed by a one-device prefill replica over the wire's
    frames (``WireLoopback``): examples/generator_tp (f32) with tokens
    identical to a one-device unified replica's, and the bf16 flagship
    teacher-forced against the one-device unit.  The launch counters are
    the process's: kv_write_paged comes from the one-device prefill side
    only (n_layers a tick), flash_decode_paged from the decode side only
    (n_layers a step on each of its 4 shards)."""
    from seldon_core_tpu_torch.models import generate as gm
    from seldon_core_tpu_torch.models.transformer import lm_apply
    from seldon_core_tpu_torch.ops import flash_attention as fa, flash_decode as fd
    from seldon_core_tpu_torch.ops import kv_write as kw
    from seldon_core_tpu_torch.parallel.mesh import build_mesh
    from seldon_core_tpu_torch.runtime.genserver import GenServer

    devices = mesh_devices(torch)
    rng = np.random.default_rng(SEED + 37)
    knobs = {"prefill_chunk": 128}
    out = {}
    cases = (("generator_tp", example_kwargs(example_doc("generator_tp")), (3, 9)),
             ("flagship", {**GEN_DIMS, "dtype": "bfloat16", "max_new_tokens": DISAGG_MESH_NEW},
              (2, 128)))
    for name, kwargs, (B, S) in cases:
        one = gm.TransformerGenerator(**kwargs, device=dev)
        state = one.init_state(torch.Generator().manual_seed(SEED))
        tp = gm.TransformerGenerator(**kwargs, mesh=build_mesh({"tp": MESH_SHARDS},
                                                               devices=devices),
                                     device=devices[0])
        sstate = tp.shard_state(state)
        prompts = rng.integers(0, kwargs["vocab"], size=(B, S)).astype(np.float32)
        unified = GenServer(**one.continuous_spec(state), **knobs)
        try:
            want = np.asarray(unified.submit(prompts).future.result(600))
        finally:
            unified.stop()
        decode = GenServer(**tp.continuous_spec(sstate), role="decode", **knobs)
        wire = WireLoopback(decode)
        prefill = GenServer(**one.continuous_spec(state), role="prefill", coordinator=wire,
                            **knobs)
        try:
            reset_counts(fa, fd, kw)
            fd.PAGED_F32_LAUNCHES = 0
            t = time.perf_counter()
            got = np.asarray(prefill.submit(prompts).future.result(600))
            wall = time.perf_counter() - t
            sync_all(torch)
            launches, f32 = read_counts(fa, fd, kw), fd.PAGED_F32_LAUNCHES
            ticks, steps = prefill.prefill_dispatches_total, decode.decode_steps_total
            imported = decode.imports_committed_total
            pools = [s["l0"]["k"].shape[1] for s in decode._pool.shards]
        finally:
            prefill.stop()
            decode.stop()
        L = kwargs["n_layers"]
        paged = launches["flash_decode_paged"]  # the f32 path's launches counted in it too
        local_kv = tp.cfg.tp_local(MESH_SHARDS).kv_heads
        if (paged != L * MESH_SHARDS * steps or f32 != (paged if name == "generator_tp" else 0)
                or not steps
                or launches["kv_write_paged"] != L * ticks or imported != B
                or launches["flash_attention"] or launches["flash_decode"]
                or pools != [local_kv] * MESH_SHARDS):
            raise AssertionError(f"[disagg] {name}: a decode replica over tp=4 launched {launches} "
                                 f"({f32} on the f32 path) over {ticks} prefill ticks and "
                                 f"{steps} decode steps; {imported} imports; pool kv heads by "
                                 f"shard {pools}")
        rec = {"launches": launches, "f32_launches": f32, "prefill_ticks": ticks,
               "decode_steps": steps, "imports": imported, "wall_ms": wall * 1e3,
               "bytes_per_sequence": float(np.mean(wire.bytes)),
               "pool_kv_heads_by_shard": pools, "shards": devices}
        if name == "generator_tp":
            if not np.array_equal(got, want):
                raise AssertionError(f"[disagg] generator_tp via a tp=4 decode replica: tokens "
                                     f"differ from the unified replica's in "
                                     f"{int((got != want).sum())} places")
            rec["identical"] = True
        else:
            rec["held"] = check_gaps(torch, lm_apply, state["params"], one.cfg,
                                     [(prompts.astype(np.int64), got.astype(np.int64))], dev, 1,
                                     "disagg tp=4 decode")
            rec["same_as_unified"] = float((got == want).mean())
        out[name] = rec
        log(f"[disagg] {name}: a decode replica over {{'tp': {MESH_SHARDS}}} on {devices} fed by "
            f"a one-device prefill replica, {B}x{S} prompts: {launches['kv_write_paged']} "
            f"kv_write_paged on the prefill side ({L} x {ticks} ticks), "
            f"{paged} flash_decode_paged{' (float32 path)' if name == 'generator_tp' else ''} "
            f"on the decode side ({L} x {MESH_SHARDS} shards x {steps} steps), none of the "
            f"others; {imported} imports, {rec['bytes_per_sequence']:.0f} wire bytes a sequence; "
            + ("tokens identical to the one-device unified replica's"
               if name == "generator_tp" else
               f"tokens teacher-forced ({rec['same_as_unified'] * 100:.1f}% equal the "
               f"one-device unified replica's)")
            + f"; request wall {wall * 1e3:.3f} ms (recorded, not claimed) on {smi}")
    out["launches"] = {  # the bf16 kernel's row counts the flagship, the f32 row the example
        "flash_decode_paged": out["flagship"]["launches"]["flash_decode_paged"],
        "flash_decode_paged f32": out["generator_tp"]["f32_launches"],
        "kv_write_paged": sum(out[k]["launches"]["kv_write_paged"] for k in ("flagship",
                                                                             "generator_tp"))}
    return out


def disagg_phase(torch, dev, smi) -> dict:
    """10t. [6d] on one card: a decode replica (engine_main --gen-role
    decode, the relay on ENGINE_RELAY_TCP_PORT and a unix socket) and
    prefill replicas handing off to it over tcp: and uds:, for the flagship
    generator, and a short-budget request shed by the tcp: one; a pair for
    examples/generator_int8_deployment.json over tcp:; the kill switch;
    then decode replicas over {"tp": 4} in process (``disagg_mesh``)."""
    t_phase = time.perf_counter()
    pid = os.getpid()
    build = ROOT / "build"
    build.mkdir(parents=True, exist_ok=True)
    flagship, int8 = gen_deployment(), example_doc("generator_int8")
    files = {}
    for name, doc in (("flagship", flagship), ("int8", int8)):
        files[name] = build / f"disagg_{name}_{pid}.json"
        files[name].write_text(json.dumps(doc))
    sock = disagg_socket(pid)
    tcp, tcp8 = free_port(), free_port()
    specs = {
        "decode": (files["flagship"], ["--gen-role", "decode"],
                   {"ENGINE_RELAY_TCP_PORT": str(tcp), "ENGINE_UDS_PATH": sock}),
        "prefill_tcp": (files["flagship"], ["--gen-role", "prefill", "--decode-peers",
                                            f"tcp:127.0.0.1:{tcp}"],
                        {"SELDON_TPU_AUTOPILOT": "1"}),
        "prefill_uds": (files["flagship"], ["--gen-role", "prefill", "--decode-peers",
                                            f"uds:{sock}"], {}),
        "decode_int8": (files["int8"], ["--gen-role", "decode"],
                        {"ENGINE_RELAY_TCP_PORT": str(tcp8)}),
        "prefill_int8": (files["int8"], ["--gen-role", "prefill", "--decode-peers",
                                          f"tcp:127.0.0.1:{tcp8}"], {}),
    }
    t0 = time.perf_counter()
    procs = start_engines(specs, dev)
    out = {"start_s": time.perf_counter() - t0, "up": {k: v[2] for k, v in procs.items()}}
    rng = np.random.default_rng(SEED + 26)
    try:
        out["flagship"] = disagg_pair(
            torch, dev, smi, "flagship", flagship, procs, ["prefill_tcp", "prefill_uds"], "decode",
            [rng.integers(0, GEN_DIMS["vocab"], size=(1, S)) for S in (128, 100)])
        out["shed"] = disagg_shed(procs["prefill_tcp"][1],
                                  rng.integers(0, GEN_DIMS["vocab"], size=(1, 128)))
        out["int8"] = disagg_pair(
            torch, dev, smi, "generator_int8 example", int8, procs, ["prefill_int8"],
            "decode_int8", [rng.integers(0, 256, size=(1, S)) for S in (40, 17)])
        out["kill_switch"] = disagg_kill_switch(torch, dev, int8, f"tcp:127.0.0.1:{tcp8}",
                                                rng.integers(0, 256, size=(1, 12)))
    finally:
        for proc, _, _ in procs.values():
            stop_service(proc, timeout=30)
        for f in files.values():
            f.unlink(missing_ok=True)
        Path(sock).unlink(missing_ok=True)
    out["launches"] = {
        "flash_decode_paged": out["flagship"]["decode"]["launches"]["flash_decode_paged"],
        "kv_write_paged": sum(v["launches"]["kv_write_paged"]
                              for v in out["flagship"]["prefill"].values()),
        "flash_decode_paged int8": out["int8"]["decode"]["launches"]["flash_decode_paged"],
        "kv_write_paged int8": out["int8"]["prefill"]["prefill_int8"]["launches"]["kv_write_paged"],
    }
    out["mesh"] = disagg_mesh(torch, dev, smi)
    out["card"] = smi
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[disagg] phase 10t wall {out['wall_s']:.2f} s")
    return out


# -- 10u. [6a] device meshes held by one process --------------------------------

MESH_SHARDS = 4
MESH_ENS_MEMBERS = 8      # SharedEnsembleUnit members at the MNIST example's widths
MESH_ENS_ROWS = 64
MESH_B = 4                # the flagship over tp=4: B=4 prompts of 128 tokens
MESH_S = 128
MESH_TURNS = 1            # ABBA turns of the request walls, sharded against one device
MESH_NEW = 16             # the flagship over tp=4 (10u (b), 10w (b)): 16 new tokens a request
MESH_PROFILE_NEW = 8      # new tokens of the profiled generations (sharded and one device)
# prefill logits over tp=4 against one device: each shard's wo and w2
# products are rounded to bf16 before the tp sum (the one-device product
# rounds once), so the residual stream moves by bf16 ulps (2^-8 relative)
# a layer and 12 layers compound them; logits of |x| ~ 5 then differ by a
# few bf16 ulps at that magnitude (0.0625 is 4 ulps at 4-8)
MESH_LOGIT_ATOL = 0.25
MESH_NODES = ("m0", "m1", "m2", "m3")


def mesh_devices(torch) -> list:
    """Four cards when the machine has four, else four shards of cuda:0."""
    if torch.cuda.device_count() >= MESH_SHARDS:
        return [f"cuda:{i}" for i in range(MESH_SHARDS)]
    return ["cuda:0"] * MESH_SHARDS


def sync_all(torch) -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def mesh_ensemble(torch, dev, smi, devices) -> dict:
    """(a) SharedEnsembleUnit, 8 MnistClassifier members (784-256-256-10,
    bf16) over {"ens": 4}: 64 rows, the mean held to the plain members'
    mean (each member's fused_mlp_softmax_reference), the kernel's
    launches a dispatch."""
    from seldon_core_tpu_torch.ops import fused_mlp
    from seldon_core_tpu_torch.parallel.ensemble import SharedEnsembleUnit
    from seldon_core_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh({"ens": MESH_SHARDS}, devices=devices)
    unit = SharedEnsembleUnit(member="MnistClassifier", n_members=MESH_ENS_MEMBERS,
                              member_hidden=256, mesh=mesh, device=devices[0])
    if unit.members[0].path != "kernel":
        raise AssertionError(f"[mesh] the ensemble's members serve through "
                             f"{unit.members[0].path}, not the fused-MLP kernel")
    state = unit.init_state(torch.Generator().manual_seed(SEED))
    x = torch.rand(MESH_ENS_ROWS, 784, generator=torch.Generator().manual_seed(SEED + 30)).to(dev)
    with torch.inference_mode():
        fused_mlp.LAUNCHES = 0
        y = unit.predict(state, x)
        sync_all(torch)
        launches = fused_mlp.LAUNCHES
        plain = None
        for shard in state.shards[:MESH_SHARDS]:
            for m in range(MESH_ENS_MEMBERS // MESH_SHARDS):
                member = {k: v[m].to(dev) for k, v in shard.items()}
                p = fused_mlp.fused_mlp_softmax_reference(member, x)
                plain = p if plain is None else plain + p
        plain = plain / MESH_ENS_MEMBERS
        walls = []
        for _ in range(20):
            t = time.perf_counter()
            unit.predict(state, x)
            sync_all(torch)
            walls.append(time.perf_counter() - t)
    err = float((y - plain).abs().max())
    if launches != MESH_ENS_MEMBERS or err > KERNEL_ATOL or y.device != torch.device(devices[0]):
        raise AssertionError(f"[mesh] ensemble: {launches} fused_mlp launches a dispatch (want "
                             f"{MESH_ENS_MEMBERS}), max |mean - plain mean| {err:.3e} (bound "
                             f"{KERNEL_ATOL}), answer on {y.device}")
    rec = {"launches": launches, "max_abs_err": err, "dispatch_p50_ms":
           float(np.median(walls) * 1e3), "shards": [str(d) for d in mesh.device_list]}
    log(f"[mesh] (a) SharedEnsembleUnit of {MESH_ENS_MEMBERS} MnistClassifier members "
        f"(784-256-256-10, bf16) over {mesh.shape} on {rec['shards']}: {MESH_ENS_ROWS} rows, "
        f"{launches} fused_mlp launches a dispatch ({MESH_ENS_MEMBERS // MESH_SHARDS} a shard), "
        f"the mean within {err:.3e} of the plain members' mean (bound {KERNEL_ATOL}); dispatch "
        f"wall p50 {rec['dispatch_p50_ms']:.3f} ms on {smi}")
    return rec


def shard_paths(unit, mesh, what: str) -> list:
    """Which path each shard takes on each lane, decided once at the unit's
    construction at the shard's shape: the static lane by ``use_flash``,
    the continuous lane by ``paged_flash`` (its paged kernels take f32)."""
    from seldon_core_tpu_torch.parallel.mesh import Shard

    cfg = unit.cfg
    static = ("kernels (flash_attention, flash_decode)" if unit.use_flash
              else "plain attention")
    continuous = ("kernels (kv_write_paged, flash_decode_paged)" if unit.paged_flash
                  else "plain attention")
    out = []
    for i, d in enumerate(mesh.device_list):
        local = cfg.for_shard(Shard(mesh, i))
        out.append({"shard": i, "device": str(d), "heads": local.n_heads,
                    "kv_heads": local.kv_heads, "head_dim": local.head_dim,
                    "dtype": str(local.dtype), "static": static, "continuous": continuous})
        log(f"[mesh] {what} shard {i} on {d}: {local.n_heads} heads over {local.kv_heads} kv "
            f"heads, hd {local.head_dim}, {str(local.dtype).replace('torch.', '')}: static lane "
            f"{static}, continuous lane {continuous}")
    return out


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages a tree of tensors holds."""
    seen = {}

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()

    walk(tree)
    return sum(seen.values())


def shard_memory(torch, params, sstate, mesh) -> dict:
    """Each shard's params hold their own blocks and no more: the bytes of
    a shard's distinct storages equal the whole tree's bytes with every
    split leaf divided over its axes (a view of the whole leaf would hold
    it all), and torch.cuda.memory_allocated on every card of the mesh."""
    from seldon_core_tpu_torch.models.transformer import param_shardings

    specs = param_shardings(mesh, params)

    def want(tree, spec):
        if isinstance(tree, dict):
            return sum(want(tree[k], spec[k]) for k in tree)
        n = int(np.prod([mesh.shape[a] for a in spec if a is not None] or [1]))
        return tree.numel() * tree.element_size() // n

    expect = want(params, specs)
    got = [tree_bytes(t) for t in sstate["params"].shards]
    if any(g != expect for g in got):
        raise AssertionError(f"[mesh] the shards' params hold {got} bytes, want {expect} each "
                             f"(the whole tree {tree_bytes(params)})")
    return {"whole_params_bytes": tree_bytes(params), "shard_params_bytes": got,
            "memory_allocated_bytes": {str(d): torch.cuda.memory_allocated(d)
                                       for d in mesh.distinct_devices}}


def mesh_flagship(torch, dev, smi, devices) -> dict:
    """(b) the flagship generator at full width over {"tp": 4} with the
    one-device unit's weights: prefill logits held to the one-device unit's,
    the static lane's and the continuous lane's greedy tokens teacher-forced
    through the plain path, every shard's launches counted, and the request
    walls against the one-device unit's in turns."""
    from seldon_core_tpu_torch.models import generate as gm
    from seldon_core_tpu_torch.models.transformer import lm_apply
    from seldon_core_tpu_torch.ops import flash_attention as fa, flash_decode as fd
    from seldon_core_tpu_torch.ops import kv_write as kw
    from seldon_core_tpu_torch.parallel.mesh import build_mesh
    from seldon_core_tpu_torch.runtime.genserver import GenServer

    kwargs = {**GEN_DIMS, "dtype": "bfloat16", "max_new_tokens": MESH_NEW}
    one = gm.TransformerGenerator(**kwargs, device=dev)
    state = one.init_state(torch.Generator().manual_seed(SEED))
    mesh = build_mesh({"tp": MESH_SHARDS}, devices=devices)
    t0 = time.perf_counter()
    tp = gm.TransformerGenerator(**kwargs, mesh=mesh, device=devices[0])
    sstate = tp.shard_state(state)
    build_s = time.perf_counter() - t0
    if not (tp.use_flash and one.use_flash and tp.paged_flash):
        raise AssertionError("[mesh] the flagship over tp=4 does not take the kernels")
    paths = shard_paths(tp, mesh, "flagship")
    memory = shard_memory(torch, state["params"], sstate, mesh)
    log(f"[mesh] flagship params: {memory['whole_params_bytes']} bytes on one device, "
        f"{memory['shard_params_bytes']} a shard over tp=4 (each its own blocks); "
        f"memory_allocated {memory['memory_allocated_bytes']} (one-device state included)")
    cfg, L, new = one.cfg, GEN_DIMS["n_layers"], MESH_NEW
    rng = np.random.default_rng(SEED + 31)
    prompts = rng.integers(0, cfg.vocab, size=(MESH_B, MESH_S))
    P = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    out = {"build_s": build_s, "paths": paths, "shards": [str(d) for d in mesh.device_list],
           "memory": memory}
    with torch.inference_mode():
        l1, _ = gm.prefill(state["params"], P, gm.init_cache(cfg, MESH_B, MESH_S, dev), cfg, True)
        cache = mesh.map_shards(lambda s: gm.init_cache(cfg.for_shard(s), MESH_B, MESH_S,
                                                        s.device))
        reset_counts(fa, fd, kw)
        lN, _ = gm.prefill(sstate["params"], P, cache, cfg, True)
        sync_all(torch)
        pre = read_counts(fa, fd, kw)
        logit_err = float((lN - l1).abs().max())
        logit_scale = float(l1.abs().max())
        same_argmax = float((lN.argmax(-1) == l1.argmax(-1)).float().mean())
        reset_counts(fa, fd, kw)
        y = tp.predict(sstate, P.float())
        sync_all(torch)
        static = read_counts(fa, fd, kw)
    want_pre = {"flash_attention": L * MESH_SHARDS, "flash_decode": 0, "kv_write": 0,
                "flash_decode_paged": 0, "kv_write_paged": 0}
    want_static = {**want_pre, "flash_decode": L * MESH_SHARDS * (new - 1)}
    if pre != want_pre or static != want_static:
        raise AssertionError(f"[mesh] flagship tp=4: prefill launched {pre} (want {want_pre}), "
                             f"the static request {static} (want {want_static})")
    if logit_err > MESH_LOGIT_ATOL:
        raise AssertionError(f"[mesh] flagship tp=4 prefill logits {logit_err:.4f} from the "
                             f"one-device unit's (bound {MESH_LOGIT_ATOL})")
    toks = y.long().cpu().numpy()
    out["prefill"] = {"launches": pre, "max_abs_logit_err": logit_err,
                      "max_abs_logit": logit_scale, "argmax_share": same_argmax}
    out["static"] = {"launches": static, "held": check_gaps(
        torch, lm_apply, state["params"], cfg, [(prompts, toks)], dev, 1, "mesh static")}
    # the continuous lane over the same mesh: the pool's KV heads over tp
    server = GenServer(**tp.continuous_spec(sstate))
    try:
        reset_counts(fa, fd, kw)
        t = time.perf_counter()
        ctoks = np.asarray(server.submit(prompts.astype(np.float32)).future.result(600))
        cont_wall = time.perf_counter() - t
        sync_all(torch)
        cont = read_counts(fa, fd, kw)
        snap = server.snapshot()
        ticks, steps = server.prefill_dispatches_total, server.decode_steps_total
    finally:
        server.stop()
    want_cont = {"flash_attention": 0, "flash_decode": 0, "kv_write": 0,
                 "flash_decode_paged": L * MESH_SHARDS * steps,
                 "kv_write_paged": L * MESH_SHARDS * ticks}
    if cont != want_cont or snap["mesh"] != {"tp": MESH_SHARDS} or not ticks or not steps:
        raise AssertionError(f"[mesh] flagship tp=4 continuous lane launched {cont} (want "
                             f"{want_cont}: {ticks} prefill ticks, {steps} decode steps); "
                             f"/stats mesh {snap['mesh']}")
    out["continuous"] = {"launches": cont, "prefill_ticks": ticks, "decode_steps": steps,
                         "mesh": snap["mesh"], "wall_ms": cont_wall * 1e3,
                         "held": check_gaps(torch, lm_apply, state["params"], cfg,
                                            [(prompts, ctoks.astype(np.int64))], dev, 1,
                                            "mesh continuous")}
    # the static request's wall, sharded against one device, in turns
    walls = {"tp4": [], "one": []}
    X = P.float()
    with torch.inference_mode():
        for turn in range(MESH_TURNS):
            for name in (("tp4", "one") if turn % 2 == 0 else ("one", "tp4")):
                unit, st = (tp, sstate) if name == "tp4" else (one, state)
                for _ in range(2):
                    t = time.perf_counter()
                    unit.predict(st, X)
                    sync_all(torch)
                    walls[name].append(time.perf_counter() - t)
    out["request_wall_p50_ms"] = {k: float(np.median(v) * 1e3) for k, v in walls.items()}
    out["request_walls_ms"] = {k: [w * 1e3 for w in v] for k, v in walls.items()}
    # where the sharded request's wall goes: its kernels' device time and
    # count against one device's (torch.profiler), and the host cost of one
    # collective round of four shards (the baton passed round the ring and
    # a 4-element sum on the host: no device work)
    with torch.inference_mode():
        out["profile"] = {name: device_profile(
            torch, lambda p=p: gm.generate(p, P, cfg, MESH_PROFILE_NEW, use_flash=True),
            f"mesh_{name}") for name, p in (("tp4", sstate["params"]), ("one", state["params"]))}
    out["ring_round_us"] = ring_round_us(torch, mesh)
    log(f"[mesh] (b) flagship over {mesh.shape} on {out['shards']} (built and probed in "
        f"{build_s:.2f} s): a {MESH_B}x{MESH_S} prefill launched {pre['flash_attention']} "
        f"flash_attention ({L} layers x {MESH_SHARDS} shards), its logits within "
        f"{logit_err:.4f} of the one-device unit's (|logit| <= {logit_scale:.3f}; bound "
        f"{MESH_LOGIT_ATOL}; argmax equal in {same_argmax * 100:.1f}% of rows); the static "
        f"request {static['flash_decode']} flash_decode ({L} x {MESH_SHARDS} x {new - 1} steps); "
        f"the continuous lane {cont['kv_write_paged']} kv_write_paged over {ticks} prefill "
        f"ticks and {cont['flash_decode_paged']} flash_decode_paged over {steps} decode steps "
        f"({L} x {MESH_SHARDS} each), genserver mesh {snap['mesh']}; static request wall p50 "
        f"{out['request_wall_p50_ms']['tp4']:.3f} ms over tp=4 against "
        f"{out['request_wall_p50_ms']['one']:.3f} ms on one device, in turns "
        f"(recorded, not claimed); profiled, a {MESH_B}x{MESH_S} generation of "
        f"{MESH_PROFILE_NEW} tokens over tp=4 ran {out['profile']['tp4']['kernels']} kernels for "
        f"{out['profile']['tp4']['kernel_ms']:.3f} ms of device time in "
        f"{out['profile']['tp4']['wall_ms']:.3f} ms of wall against "
        f"{out['profile']['one']['kernels']} for {out['profile']['one']['kernel_ms']:.3f} ms in "
        f"{out['profile']['one']['wall_ms']:.3f} ms on one device; a collective round of four "
        f"shards costs "
        f"{out['ring_round_us']:.1f} us of host time on {smi}")
    out["launches"] = {k: pre[k] + static[k] + cont[k] for k in pre}
    return out


MESH8_SHARDS = 8
MESH8_NEW = 16            # (b'): B=4 prompts of 128 tokens, 16 new tokens
TP8_HELD_SETS = 4         # input sets on which each kernel is held to its plain version


def mesh8_devices(torch) -> list:
    """Two shards a card on four cards, else eight shards of cuda:0."""
    if torch.cuda.device_count() >= MESH_SHARDS:
        return [f"cuda:{i * MESH_SHARDS // MESH8_SHARDS}" for i in range(MESH8_SHARDS)]
    return ["cuda:0"] * MESH8_SHARDS


def mesh_flagship_tp8(torch, dev, smi, devices) -> dict:
    """(b') the flagship over {"tp": 8}, twice its 4 kv heads: each shard
    holds its 2 query heads and the one kv head they read (kv head t // 2,
    models/transformer.py kv_head_range), so two shards hold each kv
    head.  Prefill logits held to the one-device unit's, both lanes'
    tokens teacher-forced, every shard's launches counted, each shard's
    pool bytes, the request wall against one device in turns (recorded,
    not claimed)."""
    from seldon_core_tpu_torch.models import generate as gm
    from seldon_core_tpu_torch.models.transformer import kv_head_range, lm_apply
    from seldon_core_tpu_torch.ops import flash_attention as fa, flash_decode as fd
    from seldon_core_tpu_torch.ops import kv_write as kw
    from seldon_core_tpu_torch.parallel.mesh import build_mesh
    from seldon_core_tpu_torch.runtime.genserver import GenServer

    kwargs = {**GEN_DIMS, "dtype": "bfloat16", "max_new_tokens": MESH8_NEW}
    one = gm.TransformerGenerator(**kwargs, device=dev)
    state = one.init_state(torch.Generator().manual_seed(SEED))
    mesh = build_mesh({"tp": MESH8_SHARDS}, devices=devices)
    t0 = time.perf_counter()
    tp = gm.TransformerGenerator(**kwargs, mesh=mesh, device=devices[0])
    sstate = tp.shard_state(state)
    build_s = time.perf_counter() - t0
    cfg, L, new, n = one.cfg, GEN_DIMS["n_layers"], MESH8_NEW, MESH8_SHARDS
    if not (tp.use_flash and tp.paged_flash):
        raise AssertionError("[mesh] the flagship over tp=8 does not take the kernels")
    paths = shard_paths(tp, mesh, "flagship tp=8")
    heads = [kv_head_range(cfg.kv_heads, n, t, cfg.n_heads) for t in range(n)]
    if any((p["heads"], p["kv_heads"]) != (cfg.n_heads // n, 1) for p in paths) or \
            heads != [(t // 2, t // 2 + 1) for t in range(n)]:
        raise AssertionError(f"[mesh] flagship tp=8 shards: {paths}, kv heads {heads}")
    rng = np.random.default_rng(SEED + 33)
    prompts = rng.integers(0, cfg.vocab, size=(MESH_B, MESH_S))
    P = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    out = {"build_s": build_s, "paths": paths, "kv_heads_by_shard": heads,
           "shards": [str(d) for d in mesh.device_list]}
    with torch.inference_mode():
        l1, _ = gm.prefill(state["params"], P, gm.init_cache(cfg, MESH_B, MESH_S, dev), cfg, True)
        cache = mesh.map_shards(lambda s: gm.init_cache(cfg.for_shard(s), MESH_B, MESH_S,
                                                        s.device))
        reset_counts(fa, fd, kw)
        lN, cache = gm.prefill(sstate["params"], P, cache, cfg, True)
        sync_all(torch)
        pre = read_counts(fa, fd, kw)
        cache_shapes = {tuple(c["l0"]["k"].shape) for c in cache.shards}
        logit_err = float((lN - l1).abs().max())
        logit_scale = float(l1.abs().max())
        same_argmax = float((lN.argmax(-1) == l1.argmax(-1)).float().mean())
        reset_counts(fa, fd, kw)
        t = time.perf_counter()
        y = tp.predict(sstate, P.float())
        sync_all(torch)
        static_wall = time.perf_counter() - t
        static = read_counts(fa, fd, kw)
    want_pre = {"flash_attention": L * n, "flash_decode": 0, "kv_write": 0,
                "flash_decode_paged": 0, "kv_write_paged": 0}
    want_static = {**want_pre, "flash_decode": L * n * (new - 1)}
    if pre != want_pre or static != want_static or \
            cache_shapes != {(MESH_B, 1, MESH_S, cfg.head_dim)}:
        raise AssertionError(f"[mesh] flagship tp=8: prefill launched {pre} (want {want_pre}), "
                             f"the static request {static} (want {want_static}); shard caches "
                             f"{cache_shapes}")
    if logit_err > MESH_LOGIT_ATOL:
        raise AssertionError(f"[mesh] flagship tp=8 prefill logits {logit_err:.4f} from the "
                             f"one-device unit's (bound {MESH_LOGIT_ATOL})")
    out["prefill"] = {"launches": pre, "max_abs_logit_err": logit_err,
                      "max_abs_logit": logit_scale, "argmax_share": same_argmax,
                      "cache_shape_by_shard": list(cache_shapes)[0]}
    out["static"] = {"launches": static, "held": check_gaps(
        torch, lm_apply, state["params"], cfg, [(prompts, y.long().cpu().numpy())], dev, 1,
        "mesh tp=8 static")}
    server = GenServer(**tp.continuous_spec(sstate))
    try:
        reset_counts(fa, fd, kw)
        t = time.perf_counter()
        ctoks = np.asarray(server.submit(prompts.astype(np.float32)).future.result(600))
        cont_wall = time.perf_counter() - t
        sync_all(torch)
        cont = read_counts(fa, fd, kw)
        ticks, steps = server.prefill_dispatches_total, server.decode_steps_total
        pool_bytes = [tree_bytes(s) for s in server._pool.shards]
        blocks, bs = server.num_blocks, server.block_size
    finally:
        server.stop()
    want_pool = L * 2 * blocks * bs * cfg.head_dim * 2  # k and v, one kv head, bf16
    want_cont = {"flash_attention": 0, "flash_decode": 0, "kv_write": 0,
                 "flash_decode_paged": L * n * steps, "kv_write_paged": L * n * ticks}
    if cont != want_cont or not ticks or not steps or set(pool_bytes) != {want_pool}:
        raise AssertionError(f"[mesh] flagship tp=8 continuous lane launched {cont} (want "
                             f"{want_cont}: {ticks} prefill ticks, {steps} decode steps); pool "
                             f"bytes by shard {pool_bytes} (want {want_pool} each)")
    out["continuous"] = {"launches": cont, "prefill_ticks": ticks, "decode_steps": steps,
                         "wall_ms": cont_wall * 1e3, "pool_bytes_by_shard": pool_bytes,
                         "pool_bytes_whole": want_pool * cfg.kv_heads,
                         "held": check_gaps(torch, lm_apply, state["params"], cfg,
                                            [(prompts, ctoks.astype(np.int64))], dev, 1,
                                            "mesh tp=8 continuous")}
    # in turns, ABBA: the counted static request is the first tp=8 turn
    walls = {"tp8": [static_wall], "one": []}
    X = P.float()
    with torch.inference_mode():
        for name in ("one", "one", "tp8"):
            unit, st = (tp, sstate) if name == "tp8" else (one, state)
            t = time.perf_counter()
            unit.predict(st, X)
            sync_all(torch)
            walls[name].append(time.perf_counter() - t)
    out["request_wall_p50_ms"] = {k: float(np.median(v) * 1e3) for k, v in walls.items()}
    out["request_walls_ms"] = {k: [w * 1e3 for w in v] for k, v in walls.items()}
    log(f"[mesh] (b') flagship over {mesh.shape} on {out['shards']} (built and probed in "
        f"{build_s:.2f} s), kv heads by shard {heads}: a {MESH_B}x{MESH_S} prefill launched "
        f"{pre['flash_attention']} flash_attention ({L} layers x {n} shards, "
        f"({MESH_B}, {cfg.n_heads // n}, 1, {MESH_S}, {cfg.head_dim}) a shard), its logits "
        f"within {logit_err:.4f} of the one-device unit's (|logit| <= {logit_scale:.3f}; bound "
        f"{MESH_LOGIT_ATOL}; argmax equal in {same_argmax * 100:.1f}% of rows); the static "
        f"request {static['flash_decode']} flash_decode ({L} x {n} x {new - 1} steps); the "
        f"continuous lane {cont['kv_write_paged']} kv_write_paged over {ticks} prefill ticks and "
        f"{cont['flash_decode_paged']} flash_decode_paged over {steps} decode steps; each "
        f"shard's pool {pool_bytes[0]} bytes ({blocks} blocks of {bs}, one kv head; the whole "
        f"pool {want_pool * cfg.kv_heads}, the shards together {sum(pool_bytes)}); static "
        f"request wall p50 {out['request_wall_p50_ms']['tp8']:.3f} ms over tp=8 against "
        f"{out['request_wall_p50_ms']['one']:.3f} ms on one device, in turns (recorded, not "
        f"claimed) on {smi}")
    out["launches"] = {k: pre[k] + static[k] + cont[k] for k in pre}
    return out


def tp8_shard_times(torch, fa, fd, kw, dev, smi) -> dict:
    """Each kernel of (b') timed cold (rotating over DECODE_COLD_BYTES of
    inputs) at its shard's shape, 2 query heads on one kv head: the
    forward at (4, 2, 1, 128, 64), the two-tier decode at B=4 over 128
    main and 8 chunk positions, the paged decode at B=4 over 136 positions
    of 16-slot blocks (with and without the step's write fused in), the
    paged write of a 4x128 prefill tick; beside the plain version, a
    library call and the bound.  First each kernel is held to its plain
    version on the first TP8_HELD_SETS of those input sets: o within
    FLASH_O_ATOL (the decode kernels with and without the step's write
    fused in, the write then bit-exact), lse within FLASH_LSE_ATOL, the
    paged write bit-exact; a mismatch fails the run."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(SEED + 34)
    rows = {}

    def o_err(got, want, what):
        err = float((got.float() - want.float()).abs().max())
        if err > FLASH_O_ATOL or not bool(torch.isfinite(got.float()).all()) \
                or got.dtype != want.dtype:
            raise AssertionError(f"[mesh] (b') {what} vs plain at the tp=8 shard shape: o err "
                                 f"{err:.3e} (tolerance {FLASH_O_ATOL}), dtype {got.dtype}")
        return err

    def same_pools(got, want, what):
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"[mesh] (b') {what} at the tp=8 shard shape did not write the "
                                 f"pools or caches as its plain version does")

    def rnd(*dims):
        return torch.randn(*dims, generator=gen, device=dev).to(torch.bfloat16)

    shape = (MESH_B, 2, 1, MESH_S, 64)
    B, H, KV, S, D = shape
    per_set = 2 * (2 * B * H * S * D + 2 * B * KV * S * D)
    sets = [(rnd(B, H, S, D), rnd(B, KV, S, D), rnd(B, KV, S, D))
            for _ in range(max(4, -(-DECODE_COLD_BYTES // per_set)))]
    err = lse_err = 0.0
    for q, k, v in sets[:TP8_HELD_SETS]:
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        ro, rlse = fa.flash_attention_reference(q, k, v, causal=True)
        err = max(err, o_err(o, ro, "flash_attention"))
        lse_err = max(lse_err, float((lse - rlse).abs().max()))
    if lse_err > FLASH_LSE_ATOL:
        raise AssertionError(f"[mesh] (b') flash_attention vs plain at the tp=8 shard shape: "
                             f"lse err {lse_err:.3e} (tolerance {FLASH_LSE_ATOL})")
    b_ms, b_by = flash_bound(shape)
    rows["flash_attention"] = {
        "shape": list(shape), "input_sets": len(sets), "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": err, "lse_err": lse_err,
        "ms": device_ms(torch, rotating(sets, lambda q, k, v: fa.flash_attention_fwd(
            q, k, v, True)), 200),
        "plain_ms": device_ms(torch, rotating(sets, lambda q, k, v: fa.flash_attention_reference(
            q, k, v, True)), 50),
        "library_ms": device_ms(torch, rotating(sets, lambda q, k, v: sdpa(
            q, k, v, is_causal=True, enable_gqa=True)), 200)}
    del sets
    dshape = (MESH_B, 1, 2, 64, MESH_S, MESH_S, MESH8_NEW, MESH8_NEW // 2)
    B, KV, G, hd, _, n_main, _, n_chunk = dshape
    sets = decode_sets(torch, dshape, dev, SEED + 35)
    dense = [(q.reshape(B, KV * G, 1, hd), torch.cat([mk, ck[:, :, :n_chunk]], dim=2),
              torch.cat([mv, cv[:, :, :n_chunk]], dim=2)) for q, mk, mv, ck, cv in sets]
    err = 0.0
    for q, mk, mv, ck, cv in sets[:TP8_HELD_SETS]:
        err = max(err, o_err(fd.flash_decode_two_tier(q, mk, mv, n_main, ck, cv, n_chunk),
                             fd.flash_decode_two_tier_reference(q, mk, mv, n_main, ck, cv,
                                                                n_chunk), "flash_decode"))
        kn, vn = rnd(B, KV, 1, hd), rnd(B, KV, 1, hd)
        got, want = [t.clone() for t in (mk, mv, ck, cv)], [t.clone() for t in (mk, mv, ck, cv)]
        err = max(err, o_err(
            fd.flash_decode_two_tier(q, got[0], got[1], n_main, got[2], got[3], n_chunk, kn, vn),
            fd.flash_decode_two_tier_reference(q, want[0], want[1], n_main, want[2], want[3],
                                               n_chunk, kn, vn), "flash_decode (write fused)"))
        same_pools(got, want, "flash_decode (write fused)")
    b_ms, b_by = decode_bound(dshape)
    rows["flash_decode"] = {
        "shape": list(dshape), "input_sets": len(sets), "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": err,
        "ms": device_ms(torch, rotating(sets, lambda q, mk, mv, ck, cv: fd.flash_decode_two_tier(
            q, mk, mv, n_main, ck, cv, n_chunk)), 200),
        "plain_ms": device_ms(torch, rotating(sets, lambda q, mk, mv, ck, cv:
                                              fd.flash_decode_two_tier_reference(
                                                  q, mk, mv, n_main, ck, cv, n_chunk)), 50),
        "library_ms": device_ms(torch, rotating(dense, lambda q, k, v: sdpa(
            q, k, v, enable_gqa=True)), 200)}
    del sets, dense
    n = MESH_S + MESH8_NEW // 2
    nblk = MESH_S // PAGED_BS + MESH8_NEW // PAGED_BS + 1
    sets = paged_sets(torch, B, KV, G, hd, nblk, [n] * B, dev, SEED + 36)
    attend = [x[:5] for x in sets]

    def gather_sdpa(q, pk, pv, t, _lens):
        k, v = fd.paged_view(pk, pv, t)
        return sdpa(q.reshape(B, KV * G, 1, hd), k[:, :, :n], v[:, :, :n], enable_gqa=True)

    err = 0.0
    for q, pk, pv, t, lens, kn, vn in sets[:TP8_HELD_SETS]:
        err = max(err, o_err(fd.flash_decode_paged(q, pk, pv, t, lens),
                             fd.flash_decode_paged_reference(q, pk, pv, t, lens),
                             "flash_decode_paged"))
        got, want = (pk.clone(), pv.clone()), (pk.clone(), pv.clone())
        err = max(err, o_err(fd.flash_decode_paged(q, *got, t, lens, kn, vn),
                             fd.flash_decode_paged_reference(q, *want, t, lens, kn, vn),
                             "flash_decode_paged (write fused)"))
        same_pools(got, want, "flash_decode_paged (write fused)")
    b_ms, b_by = paged_decode_bound(B, KV, G, hd, nblk, [n] * B)
    fb_ms, _ = paged_decode_bound(B, KV, G, hd, nblk, [n] * B, fused=True)
    rows["flash_decode_paged"] = {
        "shape": [B, KV, G, hd, nblk, n], "input_sets": len(sets), "bound_ms": b_ms,
        "bound_by": b_by, "fused_bound_ms": fb_ms, "max_abs_err": err,
        "ms": device_ms(torch, rotating(attend, fd.flash_decode_paged), 200),
        "fused_ms": device_ms(torch, rotating(sets, fd.flash_decode_paged), 200),
        "plain_ms": device_ms(torch, rotating(attend, fd.flash_decode_paged_reference), 20),
        "library_ms": device_ms(torch, rotating(attend, gather_sdpa), 100)}
    del sets, attend
    W, N = MESH_S, B * nblk + 1
    tables = (torch.randperm(N - 1, generator=gen, device=dev)[: B * nblk] + 1)
    tables = tables.reshape(B, nblk).to(torch.int32)
    per_set = 2 * N * KV * PAGED_BS * hd * 2
    sets = []
    for _ in range(max(4, -(-DECODE_COLD_BYTES // per_set))):
        k, v = head_views(torch, B, W, KV, hd, gen, dev)
        sets.append((rnd(N, KV, PAGED_BS, hd), rnd(N, KV, PAGED_BS, hd), k, v))
    start = torch.zeros(B, dtype=torch.int32, device=dev)
    valid = torch.ones(B, W, dtype=torch.bool, device=dev)
    pos = torch.arange(W, device=dev)
    blk = tables[:, pos // PAGED_BS].long()
    off = (pos % PAGED_BS)[None, :].expand(B, W)

    def index_put(pk, pv, k, v):
        pk[blk, :, off] = k.transpose(1, 2)
        pv[blk, :, off] = v.transpose(1, 2)

    for pk, pv, k, v in sets[:TP8_HELD_SETS]:
        got, want = (pk.clone(), pv.clone()), (pk.clone(), pv.clone())
        kw.kv_write_paged(*got, k, v, tables, start, valid)
        kw.kv_write_paged_reference(*want, k, v, tables, start, valid)
        same_pools(got, want, "kv_write_paged")
    rows["kv_write_paged"] = {
        "shape": [N, KV, PAGED_BS, hd, B, W], "input_sets": len(sets), "bound_by": "bytes",
        "max_abs_err": 0.0,
        "bound_ms": 2 * 2 * B * KV * W * hd * 2 / HBM_BYTES_PER_S * 1e3,
        "ms": device_ms(torch, rotating(sets, lambda pk, pv, k, v: kw.kv_write_paged(
            pk, pv, k, v, tables, start, valid)), 200),
        "plain_ms": device_ms(torch, rotating(sets, lambda pk, pv, k, v:
                                              kw.kv_write_paged_reference(
                                                  pk, pv, k, v, tables, start, valid)), 50),
        "library_ms": device_ms(torch, rotating(sets, index_put), 200)}
    del sets
    for name, r in rows.items():
        log(f"[mesh] (b') {name} at the tp=8 shard shape {r['shape']}: held to its plain "
            f"version on {TP8_HELD_SETS} input sets, max abs err {r['max_abs_err']:.3e}"
            + (" (bit-exact)" if name == "kv_write_paged" else f" (tolerance {FLASH_O_ATOL})")
            + f"; cold L2 ({r['input_sets']} input sets): kernel {r['ms']:.5f} ms"
            + (f" (the step's write fused in {r['fused_ms']:.5f} ms, bound "
               f"{r['fused_bound_ms']:.6f})" if "fused_ms" in r else "")
            + f", plain {r['plain_ms']:.5f} ms, library {r['library_ms']:.5f} ms, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}) on {smi}")
    return rows


# (c) [6b-kv] part 2: a tp that neither divides nor is a multiple of the kv
# heads.  No model of the repo has such a layout, so the flagship's vocab,
# depth, head dim and FFN ratio take Phi-3-medium's head layout (its
# published config.json: num_attention_heads 40, num_key_value_heads 10):
# d_model 2,560, d_ff 10,240, about 0.9 B parameters, over tp=4
UNEVEN_DIMS = {"vocab": 32768, "d_model": 2560, "n_heads": 40, "n_kv_heads": 10,
               "n_layers": 12, "d_ff": 10240, "max_new_tokens": MESH8_NEW}
UNEVEN_SHARDS = 4
UNEVEN_RUNS = [((2, 4), (1, 2)), ((1, 2), (2, 4))] * 2   # (kv heads, group) a run, by shard


def mesh_flagship_uneven(torch, dev, smi, devices) -> dict:
    """(c) UNEVEN_DIMS over {"tp": 4}: each shard's ten query heads read
    three kv heads, kv heads 2 and 7 on two shards each
    (models/transformer.py kv_head_range), in two runs of groups 4 and 2,
    one launch of each attention kernel a run (per_run).  Prefill logits
    held to the one-device unit's, both lanes' tokens teacher-forced, every
    shard's launches counted against the prediction, each shard's pool
    bytes."""
    from seldon_core_tpu_torch.models import generate as gm
    from seldon_core_tpu_torch.models.transformer import kv_head_range, lm_apply, shard_configs
    from seldon_core_tpu_torch.ops import flash_attention as fa, flash_decode as fd
    from seldon_core_tpu_torch.ops import kv_write as kw
    from seldon_core_tpu_torch.parallel.mesh import build_mesh
    from seldon_core_tpu_torch.runtime.genserver import GenServer

    kwargs = {**UNEVEN_DIMS, "dtype": "bfloat16"}
    one = gm.TransformerGenerator(**kwargs, device=dev)
    state = one.init_state(torch.Generator().manual_seed(SEED))
    mesh = build_mesh({"tp": UNEVEN_SHARDS}, devices=devices)
    t0 = time.perf_counter()
    tp = gm.TransformerGenerator(**kwargs, mesh=mesh, device=devices[0])
    sstate = tp.shard_state(state)
    build_s = time.perf_counter() - t0
    cfg, L, n = one.cfg, UNEVEN_DIMS["n_layers"], UNEVEN_SHARDS
    new = UNEVEN_DIMS["max_new_tokens"]
    if not (tp.use_flash and tp.paged_flash):
        raise AssertionError("[mesh] the uneven layout over tp=4 does not take the kernels")
    heads = [kv_head_range(cfg.kv_heads, n, t, cfg.n_heads) for t in range(n)]
    runs = [c.kv_runs for c in shard_configs(cfg, mesh)]
    paths = shard_paths(tp, mesh, "uneven tp=4")
    if heads != [(0, 3), (2, 5), (5, 8), (7, 10)] or runs != UNEVEN_RUNS[:2]:
        raise AssertionError(f"[mesh] uneven tp=4 shards: kv heads {heads}, runs {runs}")
    runs_a_layer = sum(len(r) for r in UNEVEN_RUNS)   # a layer's launches over the shards
    rng = np.random.default_rng(SEED + 37)
    prompts = rng.integers(0, cfg.vocab, size=(MESH_B, MESH_S))
    P = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    out = {"build_s": build_s, "paths": paths, "kv_heads_by_shard": heads,
           "runs_by_shard": UNEVEN_RUNS, "shards": [str(d) for d in mesh.device_list]}
    with torch.inference_mode():
        l1, _ = gm.prefill(state["params"], P, gm.init_cache(cfg, MESH_B, MESH_S, dev), cfg, True)
        cache = mesh.map_shards(lambda s: gm.init_cache(cfg.for_shard(s), MESH_B, MESH_S,
                                                        s.device))
        reset_counts(fa, fd, kw)
        lN, cache = gm.prefill(sstate["params"], P, cache, cfg, True)
        sync_all(torch)
        pre = read_counts(fa, fd, kw)
        cache_heads = [c["l0"]["k"].shape[1] for c in cache.shards]
        logit_err = float((lN - l1).abs().max())
        logit_scale = float(l1.abs().max())
        same_argmax = float((lN.argmax(-1) == l1.argmax(-1)).float().mean())
        del cache, l1, lN
        reset_counts(fa, fd, kw)
        t = time.perf_counter()
        y = tp.predict(sstate, P.float())
        sync_all(torch)
        static_wall = time.perf_counter() - t
        static = read_counts(fa, fd, kw)
    want_pre = {"flash_attention": L * runs_a_layer, "flash_decode": 0, "kv_write": 0,
                "flash_decode_paged": 0, "kv_write_paged": 0}
    want_static = {**want_pre, "flash_decode": L * runs_a_layer * (new - 1)}
    if pre != want_pre or static != want_static or cache_heads != [3] * n:
        raise AssertionError(f"[mesh] uneven tp=4: prefill launched {pre} (want {want_pre}), "
                             f"the static request {static} (want {want_static}); shard caches' "
                             f"kv heads {cache_heads}")
    if logit_err > MESH_LOGIT_ATOL:
        raise AssertionError(f"[mesh] uneven tp=4 prefill logits {logit_err:.4f} from the "
                             f"one-device unit's (bound {MESH_LOGIT_ATOL})")
    out["prefill"] = {"launches": pre, "max_abs_logit_err": logit_err,
                      "max_abs_logit": logit_scale, "argmax_share": same_argmax,
                      "cache_kv_heads_by_shard": cache_heads}
    out["static"] = {"launches": static, "wall_ms": static_wall * 1e3, "held": check_gaps(
        torch, lm_apply, state["params"], cfg, [(prompts, y.long().cpu().numpy())], dev, 1,
        "mesh uneven static")}
    server = GenServer(**tp.continuous_spec(sstate))
    try:
        reset_counts(fa, fd, kw)
        t = time.perf_counter()
        ctoks = np.asarray(server.submit(prompts.astype(np.float32)).future.result(600))
        cont_wall = time.perf_counter() - t
        sync_all(torch)
        cont = read_counts(fa, fd, kw)
        ticks, steps = server.prefill_dispatches_total, server.decode_steps_total
        pool_bytes = [tree_bytes(s) for s in server._pool.shards]
        blocks, bs = server.num_blocks, server.block_size
    finally:
        server.stop()
    want_pool = L * 2 * blocks * 3 * bs * cfg.head_dim * 2  # k and v, three kv heads, bf16
    want_cont = {"flash_attention": 0, "flash_decode": 0, "kv_write": 0,
                 "flash_decode_paged": L * runs_a_layer * steps, "kv_write_paged": L * n * ticks}
    if cont != want_cont or not ticks or not steps or set(pool_bytes) != {want_pool}:
        raise AssertionError(f"[mesh] uneven tp=4 continuous lane launched {cont} (want "
                             f"{want_cont}: {ticks} prefill ticks, {steps} decode steps); pool "
                             f"bytes by shard {pool_bytes} (want {want_pool} each)")
    out["continuous"] = {"launches": cont, "prefill_ticks": ticks, "decode_steps": steps,
                         "wall_ms": cont_wall * 1e3, "pool_bytes_by_shard": pool_bytes,
                         "held": check_gaps(torch, lm_apply, state["params"], cfg,
                                            [(prompts, ctoks.astype(np.int64))], dev, 1,
                                            "mesh uneven continuous")}
    log(f"[mesh] (c) {UNEVEN_DIMS['n_heads']} heads over {UNEVEN_DIMS['n_kv_heads']} kv heads "
        f"(d_model {cfg.d_model}, {L} layers) over {mesh.shape} on {out['shards']} (built and "
        f"probed in {build_s:.2f} s): kv heads by shard {heads}, runs (kv heads, group) by "
        f"shard {UNEVEN_RUNS}; a {MESH_B}x{MESH_S} prefill launched {pre['flash_attention']} "
        f"flash_attention ({L} layers x {runs_a_layer} runs over the shards), its logits within "
        f"{logit_err:.4f} of the one-device unit's (|logit| <= {logit_scale:.3f}; bound "
        f"{MESH_LOGIT_ATOL}; argmax equal in {same_argmax * 100:.1f}% of rows); the static "
        f"request {static['flash_decode']} flash_decode ({L} x {runs_a_layer} x {new - 1} "
        f"steps), wall {static_wall * 1e3:.3f} ms; the continuous lane "
        f"{cont['kv_write_paged']} kv_write_paged ({L} x {n} shards x {ticks} prefill ticks) and "
        f"{cont['flash_decode_paged']} flash_decode_paged ({L} x {runs_a_layer} x {steps} decode "
        f"steps), wall {cont_wall * 1e3:.3f} ms; each shard's pool {pool_bytes[0]} bytes "
        f"({blocks} blocks of {bs}, three kv heads) on {smi}")
    out["launches"] = {k: pre[k] + static[k] + cont[k] for k in pre}
    return out


def uneven_kernel_checks(torch, fa, fd, kw, dev, smi) -> dict:
    """(c)'s kernels held to their plain versions on the views the path
    hands them: a shard's ten query heads and three kv heads as strided
    views of its projection row, narrowed to each run of shard 0 (kv heads
    0-1 at group 4, kv head 2 at group 2) and of shard 1 (the same runs in
    the other order), on TP8_HELD_SETS input sets: the forward (o within
    FLASH_O_ATOL, lse within FLASH_LSE_ATOL) and its backward (each
    gradient within BWD_REL_TOL of its largest element) at (4, 8, 2, 128,
    64) and (4, 2, 1, 128, 64); the two-tier and the paged decode with the
    step's write fused in (o within FLASH_O_ATOL, the written caches and
    pools bit-exact) at q (4, 2, 4, 64) and (4, 1, 2, 64); the paged write
    of a prefill tick at the shard's three heads and at each run's,
    bit-exact."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 38)
    B, S, hd, KV3, H10 = MESH_B, MESH_S, 64, 3, 10
    names = ("flash_attention", "flash_attention_bwd", "flash_decode", "flash_decode_paged",
             "kv_write_paged")
    errs, shapes = dict.fromkeys(names, 0.0), {k: set() for k in names}

    def rnd(*dims):
        return torch.randn(*dims, generator=gen, device=dev).to(torch.bfloat16)

    def held(name, err, tol):
        if not err <= tol:
            raise AssertionError(f"[mesh] (c) {name} vs plain on a run's views: err {err:.3e} "
                                 f"(tolerance {tol})")
        errs[name] = max(errs[name], err)

    def same(got, want, what):
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"[mesh] (c) {what} on a run's views did not write as its plain "
                                 f"version does")

    def o_err(a, b):
        return float((a.float() - b.float()).abs().max())

    orders = [[(0, 2, 4), (2, 1, 2)], [(0, 1, 2), (1, 2, 4)]]  # (first kv head, kv heads, group)
    n_main, C, n_chunk = S, MESH8_NEW, MESH8_NEW // 2
    nblk = S // PAGED_BS + MESH8_NEW // PAGED_BS + 1
    N, n = B * nblk + 1, S + MESH8_NEW // 2
    start = torch.zeros(B, dtype=torch.int32, device=dev)
    valid = torch.ones(B, S, dtype=torch.bool, device=dev)
    for _ in range(TP8_HELD_SETS):
        qkv = rnd(B, S, (H10 + 2 * KV3) * hd)
        q10 = qkv[..., :H10 * hd].reshape(B, S, H10, hd).transpose(1, 2)
        k3 = qkv[..., H10 * hd:(H10 + KV3) * hd].reshape(B, S, KV3, hd).transpose(1, 2)
        v3 = qkv[..., (H10 + KV3) * hd:].reshape(B, S, KV3, hd).transpose(1, 2)
        caches = [rnd(B, KV3, S, hd), rnd(B, KV3, S, hd), rnd(B, KV3, C, hd), rnd(B, KV3, C, hd)]
        fresh = [rnd(B, KV3, 1, hd), rnd(B, KV3, 1, hd)]
        pools = [rnd(N, KV3, PAGED_BS, hd), rnd(N, KV3, PAGED_BS, hd)]
        tables = (torch.randperm(N - 1, generator=gen, device=dev)[: B * nblk] + 1)
        tables = tables.reshape(B, nblk).to(torch.int32)
        lens = torch.full((B,), n, dtype=torch.int32, device=dev)
        for runs in orders:
            qh = 0
            for lo, m, g in runs:
                q = q10.narrow(1, qh, m * g)
                k, v = k3.narrow(1, lo, m), v3.narrow(1, lo, m)
                qh += m * g
                shapes["flash_attention"].add((B, m * g, m, S, hd))
                shapes["flash_attention_bwd"].add((B, m * g, m, S, hd))
                o, lse = fa.flash_attention_fwd(q, k, v, True)
                ro, rlse = fa.flash_attention_reference(q, k, v, causal=True)
                held("flash_attention", o_err(o, ro), FLASH_O_ATOL)
                if float((lse - rlse).abs().max()) > FLASH_LSE_ATOL:
                    raise AssertionError("[mesh] (c) flash_attention lse vs plain on a run's "
                                         f"views: {float((lse - rlse).abs().max()):.3e}")
                do = rnd(B, m * g, S, hd)
                for a, b in zip(fa.flash_attention_bwd(q, k, v, o, lse, do, True),
                                fa.flash_attention_bwd_reference(q, k, v, ro, rlse, do, True)):
                    held("flash_attention_bwd", o_err(a, b) / float(b.float().abs().max()),
                         BWD_REL_TOL)
                qg = rnd(B, m, g, hd)
                kn, vn = (t.narrow(1, lo, m) for t in fresh)
                shapes["flash_decode"].add((B, m, g, hd))
                shapes["flash_decode_paged"].add((B, m, g, hd))
                got, want = ([t.clone() for t in caches] for _ in range(2))
                gv, wv = ([t.narrow(1, lo, m) for t in c] for c in (got, want))
                held("flash_decode", o_err(
                    fd.flash_decode_two_tier(qg, gv[0], gv[1], n_main, gv[2], gv[3], n_chunk,
                                             kn, vn),
                    fd.flash_decode_two_tier_reference(qg, wv[0], wv[1], n_main, wv[2], wv[3],
                                                       n_chunk, kn, vn)), FLASH_O_ATOL)
                same(got, want, "flash_decode (write fused)")
                got, want = ([t.clone() for t in pools] for _ in range(2))
                gv, wv = ([t.narrow(1, lo, m) for t in c] for c in (got, want))
                held("flash_decode_paged", o_err(
                    fd.flash_decode_paged(qg, *gv, tables, lens, kn, vn),
                    fd.flash_decode_paged_reference(qg, *wv, tables, lens, kn, vn)), FLASH_O_ATOL)
                same(got, want, "flash_decode_paged (write fused)")
        for lo, m in ((0, KV3), (0, 2), (2, 1)):
            shapes["kv_write_paged"].add((N, m, PAGED_BS, hd, B, S))
            got, want = ([t.clone() for t in pools] for _ in range(2))
            kw.kv_write_paged(*(t.narrow(1, lo, m) for t in got), k3.narrow(1, lo, m),
                              v3.narrow(1, lo, m), tables, start, valid)
            kw.kv_write_paged_reference(*(t.narrow(1, lo, m) for t in want), k3.narrow(1, lo, m),
                                        v3.narrow(1, lo, m), tables, start, valid)
            same(got, want, "kv_write_paged")
    out = {k: {"max_abs_err": errs[k], "shapes": sorted(shapes[k])} for k in names}
    for k, r in out.items():
        log(f"[mesh] (c) {k} held to its plain version on {TP8_HELD_SETS} input sets at the runs' "
            f"views {r['shapes']}: max {'relative ' if k.endswith('bwd') else 'abs '}err "
            f"{r['max_abs_err']:.3e}" + (" (bit-exact)" if k == "kv_write_paged" else "")
            + f" on {smi}")
    return out


def ring_round_us(torch, mesh, rounds: int = 2000) -> float:
    """Host microseconds a round of ``all_reduce`` over the mesh's first
    axis takes, on a 4-element CPU tensor (the baton's cost and three
    host adds a shard)."""
    from seldon_core_tpu_torch.parallel.mesh import DeviceMesh, all_reduce

    axis = mesh.axis_names[0]
    cpu = DeviceMesh(np.array([torch.device("cpu")] * mesh.size, dtype=object)
                     .reshape(mesh.devices.shape), mesh.axis_names)
    x = torch.ones(4)

    def body(_shard):
        for _ in range(rounds):
            all_reduce(x, axis)

    t = time.perf_counter()
    cpu.run(body)
    return (time.perf_counter() - t) / rounds * 1e6


def example_kwargs(doc: dict) -> dict:
    comp = doc["spec"]["predictors"][0]["components"][0]
    cast = {"INT": int, "FLOAT": float, "STRING": str}
    return {p["name"]: cast[p["type"]](p["value"]) for p in comp["parameters"]}


def mesh_examples(torch, dev, smi, devices) -> dict:
    """(c) examples/generator_tp (both lanes) and generator_ep (static lane)
    through EngineService when four cards exist, else their units over four
    shards of cuda:0: f32 greedy tokens identical to the one-device unit's
    with the same weights.  Both are f32, which the prefill and two-tier
    decode kernels refuse, so their static lanes run the plain attention on
    every shard; generator_tp's continuous lane takes kv_write_paged and the
    paged kernel's float32 path on every shard at its (., 1, 1, 32) shape,
    counted from just before the sharded request to just after it."""
    from seldon_core_tpu_torch.models.generate import TransformerGenerator
    from seldon_core_tpu_torch.ops import flash_attention as fa, flash_decode as fd
    from seldon_core_tpu_torch.ops import kv_write as kw
    from seldon_core_tpu_torch.parallel.mesh import build_mesh
    from seldon_core_tpu_torch.runtime.genserver import GenServer

    four = len(set(devices)) == MESH_SHARDS
    rng = np.random.default_rng(SEED + 32)
    out = {}
    for name, lanes in (("generator_tp", (False, True)), ("generator_ep", (False,))):
        doc = example_doc(name)
        axes = doc["spec"]["predictors"][0]["components"][0]["mesh_axes"]
        kwargs = example_kwargs(doc)
        one = TransformerGenerator(**kwargs, device=dev)
        state = one.init_state(torch.Generator().manual_seed(SEED))
        prompts = rng.integers(0, kwargs["vocab"], size=(3, 9)).astype(np.float32)
        n_layers = kwargs["n_layers"]
        for continuous in lanes:
            lane = "continuous" if continuous else "static"
            if continuous:
                ref = GenServer(**one.continuous_spec(state))
                try:
                    want = np.asarray(ref.submit(prompts).future.result(300))
                finally:
                    ref.stop()
            else:
                with torch.inference_mode():
                    want = one.predict(state, torch.as_tensor(prompts, device=dev)).cpu().numpy()
            if four:
                engine = mode_engine(torch, dev, doc, continuous=continuous)
                try:
                    unit = engine.compiled.units["gen"]
                    if [str(d) for d in unit.mesh.device_list] != devices:
                        raise AssertionError(f"[mesh] {name}'s engine mesh is on "
                                             f"{unit.mesh.device_list}")
                    engine.load_states({"gen": unit.shard_state(state)})
                    g = engine.genserver
                    work0 = (g.prefill_dispatches_total, g.decode_steps_total) if g else (0, 0)
                    reset_counts(fa, fd, kw)
                    fd.PAGED_F32_LAUNCHES = 0
                    text, st = asyncio.run(engine.predict_json(json.dumps(ndarray(prompts))))
                    sync_all(torch)
                    launches, f32 = read_counts(fa, fd, kw), fd.PAGED_F32_LAUNCHES
                    ticks, steps = ((g.prefill_dispatches_total - work0[0],
                                     g.decode_steps_total - work0[1]) if g else (0, 0))
                    got = check_tokens(st, text.encode(), prompts, "ndarray",
                                       kwargs["max_new_tokens"], kwargs["vocab"])
                    mesh_shape = engine.stats()["meshes"]["gen"]["axes"]
                finally:
                    engine.close()
                route = "EngineService"
                mesh = unit.mesh
            else:
                mesh = build_mesh(axes, devices=devices)
                unit = TransformerGenerator(**kwargs, mesh=mesh, device=devices[0])
                sstate = unit.shard_state(state)
                if continuous:
                    server = GenServer(**unit.continuous_spec(sstate))
                    try:
                        reset_counts(fa, fd, kw)
                        fd.PAGED_F32_LAUNCHES = 0
                        got = np.asarray(server.submit(prompts).future.result(300))
                        sync_all(torch)
                        launches, f32 = read_counts(fa, fd, kw), fd.PAGED_F32_LAUNCHES
                        ticks, steps = server.prefill_dispatches_total, server.decode_steps_total
                    finally:
                        server.stop()
                else:
                    with torch.inference_mode():
                        reset_counts(fa, fd, kw)
                        fd.PAGED_F32_LAUNCHES = 0
                        got = unit.predict(sstate, torch.as_tensor(prompts, device=dev))
                        sync_all(torch)
                        launches, f32 = read_counts(fa, fd, kw), fd.PAGED_F32_LAUNCHES
                        ticks = steps = 0
                    got = got.cpu().numpy()
                mesh_shape = dict(mesh.shape)
                route = "the unit over four shards of cuda:0"
            paths = shard_paths(unit, mesh, name)
            shards = mesh.shape.get("tp", 1) * mesh.shape.get("ep", 1) * mesh.shape.get("dp", 1)
            want_launches = {k: 0 for k in COUNTED}
            if continuous:
                if not unit.paged_flash:
                    raise AssertionError(f"[mesh] {name}'s continuous lane does not take the "
                                         f"paged kernels at its shard shape")
                want_launches.update(flash_decode_paged=n_layers * shards * steps,
                                     kv_write_paged=n_layers * shards * ticks)
            same = np.array_equal(np.asarray(got, np.float32), np.asarray(want, np.float32))
            if (not same or mesh_shape != axes or launches != want_launches
                    or f32 != want_launches["flash_decode_paged"]
                    or (continuous and not (ticks and steps))):
                raise AssertionError(f"[mesh] {name} ({lane} lane, {route}): tokens identical "
                                     f"to one device: {same}; mesh {mesh_shape}; launches "
                                     f"{launches} ({f32} on the f32 path; want {want_launches}: "
                                     f"{ticks} prefill ticks, {steps} decode steps)")
            out[f"{name} {lane}"] = {"route": route, "mesh": mesh_shape, "identical": True,
                                     "tokens": int(np.asarray(got).size), "paths": paths,
                                     "launches": launches, "f32_launches": f32,
                                     "prefill_ticks": ticks, "decode_steps": steps}
            log(f"[mesh] (c) examples/{name}_deployment.json over {axes}, {lane} lane through "
                f"{route}: 3x9 prompts -> {np.asarray(got).shape} f32 greedy tokens, identical "
                f"to the one-device unit's; launches {launches} ({f32} on the paged kernel's "
                f"float32 path; {ticks} prefill ticks, {steps} decode steps) on {smi}")
    return out


def mesh_nodes(torch, dev, smi) -> dict:
    """(d) examples/ensemble4_deployment.json as a root engine (host mode,
    shard_predictor) over one engine_main --node process a leaf: answers
    bit-identical to the collapsed engine's, each node's fused_mlp launches
    from its /stats."""
    from seldon_core_tpu_torch.graph.defaulting import default_and_validate
    from seldon_core_tpu_torch.graph.sharding import shard_predictor
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.runtime.engine import EngineService

    path = ROOT / "examples" / "ensemble4_deployment.json"
    spec = default_and_validate(SeldonDeploymentSpec.from_json(path.read_text()))
    t0 = time.perf_counter()
    procs = start_engines({m: (path, ["--node", m], {"SELDON_TPU_UDS": "0"})
                           for m in MESH_NODES}, dev)
    out = {"start_s": time.perf_counter() - t0, "up": {k: v[2] for k, v in procs.items()}}
    root = collapsed = None
    try:
        root = EngineService(shard_predictor(spec, {m: ("127.0.0.1", procs[m][1])
                                                    for m in MESH_NODES}), device=dev)
        collapsed = EngineService(spec, device=dev)
        if root.mode != "host" or collapsed.mode != "fused":
            raise AssertionError(f"[mesh] root mode {root.mode}, collapsed {collapsed.mode}")
        before = {m: kernel_counts(procs[m][1])[0]["fused_mlp_softmax"] for m in MESH_NODES}
        rng = np.random.default_rng(SEED + 33)
        answers = []
        for rows in (1, 64):
            body = json.dumps(ndarray(rng.random((rows, 784))))
            got, want = (asyncio.run(e.predict_json(body)) for e in (root, collapsed))
            if got[1] != 200 or want[1] != 200:
                raise AssertionError(f"[mesh] node engines answered {got[1]}, collapsed {want[1]}")
            g, w = json_rows(got[0]), json_rows(want[0])
            if not np.array_equal(g, w):
                raise AssertionError(f"[mesh] the node engines' {rows}-row answer is not the "
                                     f"collapsed engine's: max |diff| {np.abs(g - w).max():.3e}")
            answers.append(rows)
        after = {m: kernel_counts(procs[m][1])[0]["fused_mlp_softmax"] for m in MESH_NODES}
    finally:
        for e in (root, collapsed):
            if e is not None:
                e.close()
        for proc, _, _ in procs.values():
            stop_service(proc, timeout=30)
    launches = {m: after[m] - before[m] for m in MESH_NODES}
    if any(n != len(answers) for n in launches.values()):
        raise AssertionError(f"[mesh] node engines' fused_mlp launches {launches}, want "
                             f"{len(answers)} each")
    out.update({"launches": launches, "requests": answers, "bit_identical": True})
    log(f"[mesh] (d) examples/ensemble4_deployment.json: a root engine (host mode) over "
        f"{len(MESH_NODES)} engine_main --node processes ({out['start_s']:.2f} s to come up): "
        f"1- and 64-row answers bit-identical to the collapsed (fused) engine's; each node's "
        f"/stats counted {launches} fused_mlp launches on {smi}")
    return out


def mesh_phase(torch, dev, smi) -> dict:
    """10u. [6a]: device meshes held by one process: the sharded ensemble,
    the flagship over tp=4 and over tp=8 (twice its kv heads) through the
    kernels on every shard, the two multi-device examples, and the node
    engines of a sharded graph; then each kernel of the tp=8 shards timed
    at its shard shape; then (c) a tp that neither divides nor is a
    multiple of the kv heads: each kernel held to its plain version on its
    runs' views, and 40 heads over 10 kv heads served over tp=4."""
    t_phase = time.perf_counter()
    devices = mesh_devices(torch)
    cards, shards = len(set(devices)), len(devices)
    log(f"[mesh] phase 10u: {cards} card(s), {shards} shards ({devices}); "
        f"torch.cuda.device_count() {torch.cuda.device_count()}")
    out = {"cards": cards, "shards": shards, "devices": devices}
    out["ensemble"] = mesh_ensemble(torch, dev, smi, devices)
    out["flagship"] = mesh_flagship(torch, dev, smi, devices)
    out["flagship_tp8"] = mesh_flagship_tp8(torch, dev, smi, mesh8_devices(torch))
    out["examples"] = mesh_examples(torch, dev, smi, devices)
    out["nodes"] = mesh_nodes(torch, dev, smi)
    examples = out["examples"].values()
    out["launches"] = {**out["flagship"]["launches"],
                       "fused_mlp_softmax": out["ensemble"]["launches"],
                       "fused_mlp_softmax nodes": sum(out["nodes"]["launches"].values()),
                       "flash_decode_paged f32 examples": sum(e["f32_launches"] for e in examples),
                       "kv_write_paged examples": sum(e["launches"]["kv_write_paged"]
                                                      for e in examples)}
    out["launches_tp8"] = out["flagship_tp8"]["launches"]
    from seldon_core_tpu_torch.ops import flash_attention as fa, flash_decode as fd
    from seldon_core_tpu_torch.ops import kv_write as kw

    out["tp8_shard_times"] = tp8_shard_times(torch, fa, fd, kw, dev, smi)
    torch.cuda.empty_cache()
    out["uneven_kernels"] = uneven_kernel_checks(torch, fa, fd, kw, dev, smi)
    out["flagship_uneven"] = mesh_flagship_uneven(torch, dev, smi, devices)
    out["launches_uneven"] = out["flagship_uneven"]["launches"]
    torch.cuda.empty_cache()
    out["card"] = smi
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[mesh] phase 10u wall {out['wall_s']:.2f} s ({cards} card(s), {shards} shards)")
    return out


# -- 10v. [6b] part 1: ring attention, the sharded train steps, the pipeline ----

SHARDED_SHARDS = 4
RING_SHAPE = (2, 16, 16, 512, 64)   # (B, H, KV, S_local, D): 4 blocks over sp=4, S = 2048
SP_B, SP_S = 2, 2048                # the flagship made MHA over sp=4: tokens [2, 2048]
# the flagship's widths with full heads: the ring takes n_kv_heads == n_heads
SP_DIMS = {**{k: v for k, v in GEN_DIMS.items() if k != "max_new_tokens"}, "n_kv_heads": 16}
SP_SMALL = {"vocab": 256, "d_model": 128, "n_heads": 4, "n_layers": 2, "d_ff": 512}
SP_SMALL_S = 512                    # S_local 128 over sp=4: the ring's kernel path
SHARD_STEPS = 3                     # train steps of each sharded path, on one batch
PIPE_STAGES, PIPE_MICRO = 4, 4
MNIST_DP_B, MNIST_DP_LR = 256, 1e-3
SHARD_TURNS = 1                     # ABBA turns of each path's walls against one device


class GradCapture:
    """An optimizer whose update is zero and keeps the gradients it is
    given: ``optim.grad_update`` with it returns a step's gradients as its
    train step computes them (the copies of a replicated leaf summed)."""

    def __init__(self):
        self.grads = None

    def update(self, grads, state, params=None):
        self.grads = grads
        return grads, state


def step_grads(torch, loss_fn, params, batch):
    from seldon_core_tpu_torch.optim import grad_update
    from seldon_core_tpu_torch.parallel.mesh import ShardedTree

    cap = GradCapture()
    state = (ShardedTree(params.mesh, [None] * params.mesh.size)
             if isinstance(params, ShardedTree) else None)
    _, _, loss = grad_update(loss_fn, params, state, batch, cap)
    return float(loss), cap.grads


def gather_sharded(torch, tree) -> dict:
    """{keystr path: whole leaf} from a ShardedTree: each split leaf
    concatenated along its split dims in coordinate order, a replicated one
    from shard 0."""
    from seldon_core_tpu_torch.tree import leaves_with_paths

    mesh = tree.mesh
    specs = dict(leaves_with_paths(tree.specs))
    shards = [dict(leaves_with_paths(s)) for s in tree.shards]
    out = {}
    for path in shards[0]:
        leaves = [s[path] for s in shards]
        t = leaves[0]
        for dim, axis in enumerate(specs.get(path, ())):
            if axis is None or mesh.shape.get(axis, 1) == 1:
                continue
            parts = {}
            for i, leaf in enumerate(leaves):
                parts.setdefault(mesh.coords(i)[axis], leaf)
            t = torch.cat([parts[c].to(t.device) for c in sorted(parts)], dim=dim)
        out[path] = t
    return out


def copies_identical(torch, tree) -> int:
    """The number of leaf copies checked bit-identical to the first shard
    holding the same block; raises on any that differs."""
    from seldon_core_tpu_torch.tree import leaves_with_paths

    mesh = tree.mesh
    specs = dict(leaves_with_paths(tree.specs))
    shards = [dict(leaves_with_paths(s)) for s in tree.shards]
    checked = 0
    for path in shards[0]:
        axes = [a for a in specs.get(path, ()) if a is not None]
        first = {}
        for i, s in enumerate(shards):
            key = tuple(mesh.coords(i)[a] for a in axes)
            if key in first:
                if not torch.equal(first[key], s[path].to(first[key].device)):
                    raise AssertionError(f"[sharded] copy of {path} on shard {i} differs")
                checked += 1
            else:
                first[key] = s[path]
    return checked


def rel_l2(torch, got: dict, want: dict) -> dict:
    """||got - want|| / ||want|| a leaf, on want's device."""
    return {k: float((got[k].to(want[k].device).float() - want[k].float()).norm()
                     / want[k].float().norm()) for k in want}


def flash_counts(fa) -> dict:
    return {"fwd": fa.LAUNCHES, "dq": fa.DQ_LAUNCHES, "dkv": fa.DKV_LAUNCHES}


def flash_reset(fa) -> None:
    fa.LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0


def turns_p50(torch, fns: dict, turns: int = SHARD_TURNS, runs: int = 2) -> dict:
    """Each named call's wall p50 in ms (ending in a synchronize of every
    card), taken in ABBA turns of ``runs`` calls, after one warm call."""
    walls = {k: [] for k in fns}
    names = list(fns)
    for fn in fns.values():
        fn()
    sync_all(torch)
    for turn in range(turns):
        for name in (names if turn % 2 == 0 else names[::-1]):
            for _ in range(runs):
                t = time.perf_counter()
                fns[name]()
                sync_all(torch)
                walls[name].append(time.perf_counter() - t)
    return {k: float(np.median(v) * 1e3) for k, v in walls.items()}


def ring_alone(torch, dev, smi, devices) -> dict:
    """(a) ring_attention_sharded over {"sp": 4}, 4 causal blocks of
    RING_SHAPE in bf16: the kernel path (RingFlash) against the plain ring's
    arithmetic in f32 on the same bf16 inputs, o within FLASH_O_ATOL and
    dq/dk/dv within BWD_REL_TOL of their largest element, with 1+2+3+4
    launches of each kernel (no block above the diagonal)."""
    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.parallel.mesh import build_mesh
    from seldon_core_tpu_torch.parallel.ring_attention import ring_attention_sharded

    B, H, KV, Sl, D = RING_SHAPE
    n = SHARDED_SHARDS
    mesh = build_mesh({"sp": n}, devices=devices)
    g = torch.Generator().manual_seed(SEED + 40)
    q, k, v, do = (torch.randn(B, H, n * Sl, D, generator=g).to(dev, torch.bfloat16)
                   for _ in range(4))
    kern = ring_attention_sharded(mesh, "sp", True, use_flash=True)
    plain = ring_attention_sharded(mesh, "sp", True, use_flash=False)

    def fwd_bwd(fn, ins, cot):
        ts = [t.detach().requires_grad_() for t in ins]
        o = fn(*ts)
        return o.detach(), torch.autograd.grad(o, ts, cot)

    flash_reset(fa)
    o_k, g_k = fwd_bwd(kern, (q, k, v), do)
    sync_all(torch)
    launches = flash_counts(fa)
    o_p, g_p = fwd_bwd(plain, [t.float() for t in (q, k, v)], do.float())
    o_err = float((o_k.float() - o_p).abs().max())
    rel = {name: float((a.float() - b).abs().max() / b.abs().max())
           for name, a, b in zip(("dq", "dk", "dv"), g_k, g_p)}
    want = n * (n + 1) // 2
    if launches != {"fwd": want, "dq": want, "dkv": want}:
        raise AssertionError(f"[sharded] the ring launched {launches}, want {want} of each "
                             f"(1+2+...+{n} blocks: none above the diagonal)")
    if o_err > FLASH_O_ATOL or max(rel.values()) > BWD_REL_TOL:
        raise AssertionError(f"[sharded] the ring's kernel path: o {o_err:.3e} from the plain "
                             f"ring (bound {FLASH_O_ATOL}), gradients {rel} (bound {BWD_REL_TOL} "
                             f"of the largest element)")
    del g_p, o_p
    walls = turns_p50(torch, {"kernel": lambda: fwd_bwd(kern, (q, k, v), do),
                              "plain_bf16": lambda: fwd_bwd(plain, (q, k, v), do)})
    rec = {"shape": list(RING_SHAPE), "launches": launches, "max_abs_err_o": o_err,
           "bwd_rel_err": rel, "fwd_bwd_wall_p50_ms": walls,
           "shards": [str(d) for d in mesh.device_list]}
    log(f"[sharded] (a) ring over {mesh.shape}, 4 causal blocks of (B, H, S_local, D) = "
        f"({B}, {H}, {Sl}, {D}) bf16: launches {launches} (1+2+3+4 blocks; none above the "
        f"diagonal); o within {o_err:.3e} of the plain ring in f32 (bound {FLASH_O_ATOL}), "
        f"dq/dk/dv within {rel} of their largest element (bound {BWD_REL_TOL}); forward + "
        f"backward wall p50 {walls['kernel']:.3f} ms through the kernels against "
        f"{walls['plain_bf16']:.3f} ms for the plain ring in bf16 (recorded, not claimed) "
        f"on {smi}")
    return rec


def serve_sp(torch, dev, smi, devices) -> dict:
    """(b) TransformerLM at the flagship's widths made MHA over {"sp": 4}:
    a [2, 2048] request's logits held to the one-device unit's (flash at S
    = 2048) within MESH_LOGIT_ATOL, 12 x (1+2+3+4) flash_attention launches
    a request; then a small-width binding with mesh_axes {"sp": 4} (through
    EngineService on four cards, else the unit over four shards of
    cuda:0), 2 x 10 launches, logits against its one-device self."""
    from seldon_core_tpu_torch.models.transformer import TransformerLM
    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.parallel.mesh import build_mesh

    n = SHARDED_SHARDS
    blocks = n * (n + 1) // 2
    kwargs = {**SP_DIMS, "dtype": "bfloat16"}
    one = TransformerLM(**kwargs, device=dev)
    state = one.init_state(torch.Generator().manual_seed(SEED))
    mesh = build_mesh({"sp": n}, devices=devices)
    sp = TransformerLM(**kwargs, mesh=mesh, device=devices[0])
    sstate = sp.shard_state(state)
    if not (sp.use_flash and one.use_flash):
        raise AssertionError("[sharded] the flagship over sp=4 does not take the kernels")
    rng = np.random.default_rng(SEED + 42)
    X = torch.as_tensor(rng.integers(0, SP_DIMS["vocab"], size=(SP_B, SP_S)), device=dev).float()
    with torch.inference_mode():
        want = one.predict(state, X)
        flash_reset(fa)
        got = sp.predict(sstate, X)
        sync_all(torch)
        launches = fa.LAUNCHES
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        argmax = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        del got, want
        walls = turns_p50(torch, {"sp4": lambda: sp.predict(sstate, X),
                                  "one": lambda: one.predict(state, X)})
    L = SP_DIMS["n_layers"]
    if launches != L * blocks or err > MESH_LOGIT_ATOL:
        raise AssertionError(f"[sharded] flagship MHA over sp=4: {launches} flash_attention "
                             f"launches (want {L * blocks}), logits {err:.4f} from one device's "
                             f"(bound {MESH_LOGIT_ATOL})")
    out = {"launches": launches, "max_abs_logit_err": err, "max_abs_logit": scale,
           "argmax_share": argmax, "request_wall_p50_ms": walls,
           "shards": [str(d) for d in mesh.device_list]}
    log(f"[sharded] (b) TransformerLM at the flagship's widths with 16 kv heads over "
        f"{mesh.shape}: a {SP_B}x{SP_S} request launched {launches} flash_attention ({L} layers "
        f"x (1+2+3+4) ring blocks), its logits within {err:.4f} of the one-device unit's "
        f"(|logit| <= {scale:.3f}; bound {MESH_LOGIT_ATOL}; argmax equal at "
        f"{argmax * 100:.1f}% of positions); request wall p50 {walls['sp4']:.3f} ms over sp=4 "
        f"against {walls['one']:.3f} ms on one device, in turns (recorded, not claimed) on {smi}")
    # the small binding
    small = {**SP_SMALL, "dtype": "bfloat16"}
    one_s = TransformerLM(**small, device=dev)
    st_s = one_s.init_state(torch.Generator().manual_seed(SEED + 1))
    Xs = rng.integers(0, SP_SMALL["vocab"], size=(1, SP_SMALL_S)).astype(np.float32)
    with torch.inference_mode():
        want_s = one_s.predict(st_s, torch.as_tensor(Xs, device=dev)).float().cpu().numpy()
    if len(set(devices)) == n:
        from seldon_core_tpu_torch.graph.defaulting import default_and_validate
        from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
        from seldon_core_tpu_torch.runtime.engine import EngineService

        doc = {"spec": {"name": "sp", "predictors": [{"name": "p", "graph": {
            "name": "lm", "type": "MODEL"}, "components": [{
                "name": "lm", "runtime": "inprocess", "class_path": "TransformerLM",
                "mesh_axes": {"sp": n}, "parameters": [
                    {"name": k, "value": str(v), "type": "INT"} for k, v in SP_SMALL.items()]}]}]}}
        engine = EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(doc)),
                               device=dev)
        try:
            unit = engine.compiled.units["lm"]
            engine.load_states({"lm": unit.shard_state(st_s)})
            flash_reset(fa)
            text, status = asyncio.run(engine.predict_json(json.dumps(ndarray(Xs))))
            sync_all(torch)
            small_launches = fa.LAUNCHES
            if status != 200:
                raise AssertionError(f"[sharded] the sp binding answered {status}: {text[:200]}")
            got_s = json_rows(text)
        finally:
            engine.close()
        route = "EngineService"
    else:
        unit = TransformerLM(**small, mesh=build_mesh({"sp": n}, devices=devices),
                             device=devices[0])
        with torch.inference_mode():
            flash_reset(fa)
            got_s = unit.predict(unit.shard_state(st_s), torch.as_tensor(Xs, device=dev))
            sync_all(torch)
            small_launches = fa.LAUNCHES
            got_s = got_s.float().cpu().numpy()
        route = "the unit over four shards of cuda:0"
    err_s = float(np.abs(got_s.reshape(want_s.shape) - want_s).max())
    want_l = SP_SMALL["n_layers"] * blocks
    if small_launches != want_l or err_s > MESH_LOGIT_ATOL:
        raise AssertionError(f"[sharded] the small sp binding through {route}: "
                             f"{small_launches} flash_attention launches (want {want_l}), logits "
                             f"{err_s:.4f} from one device's (bound {MESH_LOGIT_ATOL})")
    out["binding"] = {"route": route, "launches": small_launches, "max_abs_logit_err": err_s}
    log(f"[sharded] (b) a TransformerLM binding ({SP_SMALL}, bf16) with mesh_axes "
        f"{{'sp': {n}}} through {route}: a 1x{SP_SMALL_S} request launched {small_launches} "
        f"flash_attention, logits within {err_s:.4f} of its one-device self's")
    out["total_launches"] = launches + small_launches
    return out


def train_tp_sp(torch, dev, smi, devices) -> dict:
    """(c) lm_train_step over {"tp": 2, "sp": 2} at the flagship's train
    config made MHA on the copy task (B = 16, S = 512: S_local 256, 8 heads
    a shard): step 0's per-leaf gradients against one device's kernel path
    within TRAIN_GRAD_REL_L2, then SHARD_STEPS steps on that batch (a
    falling loss, the replicated copies bit-identical after each step),
    12 x (1+2) x 2 launches of each flash kernel a step."""
    from seldon_core_tpu_torch.models.transformer import (LMConfig, lm_init, lm_loss,
                                                          lm_train_step, shard_params)
    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.optim import adam
    from seldon_core_tpu_torch.parallel.mesh import build_mesh
    from seldon_core_tpu_torch.tree import leaves_with_paths

    cfg = LMConfig(**SP_DIMS, dtype=torch.bfloat16)
    params = lm_init(torch.Generator().manual_seed(SEED), cfg, dev)
    mesh = build_mesh({"tp": 2, "sp": 2}, devices=devices)
    sparams = shard_params(params, mesh)
    rng = np.random.default_rng(SEED + 43)
    batch = {"tokens": torch.as_tensor(copy_batch(rng, cfg.vocab), dtype=torch.int32,
                                       device=dev)}
    loss_1, g1 = step_grads(torch, lambda p, b: lm_loss(p, b, cfg), params, batch)
    loss_n, gn = step_grads(torch, lambda p, b: lm_loss(p, b, cfg), sparams, batch)
    rel = rel_l2(torch, gather_sharded(torch, gn), dict(leaves_with_paths(g1)))
    worst = max(rel, key=rel.get)
    del g1, gn
    if rel[worst] > TRAIN_GRAD_REL_L2 or abs(loss_n - loss_1) / loss_1 > TRAIN_LOSS_RTOL:
        raise AssertionError(f"[sharded] tp x sp step 0: loss {loss_n} against one device's "
                             f"{loss_1}; gradient relative L2 {rel[worst]:.3e} at {worst} "
                             f"(bound {TRAIN_GRAD_REL_L2})")
    opt = adam(TRAIN_LR)
    state = opt.init(sparams)
    losses, copies = [], 0
    flash_reset(fa)
    p = sparams
    for _ in range(SHARD_STEPS):
        p, state, loss = lm_train_step(p, state, batch, opt, cfg)
        losses.append(float(loss))
        copies = copies_identical(torch, p)
    sync_all(torch)
    launches = flash_counts(fa)
    per = cfg.n_layers * 3 * 2
    want = {k: per * SHARD_STEPS for k in launches}
    if launches != want or not losses[-1] < losses[0] or not all(np.isfinite(losses)):
        raise AssertionError(f"[sharded] tp x sp: {SHARD_STEPS} steps launched {launches} (want "
                             f"{want}), losses {losses}")
    one_state = opt.init(params)
    walls = turns_p50(torch, {
        "tp2_sp2": lambda: lm_train_step(p, state, batch, opt, cfg),
        "one": lambda: lm_train_step(params, one_state, batch, opt, cfg)}, runs=1)
    out = {"launches": launches, "launches_a_step": per, "losses": losses,
           "step0": {"loss": loss_n, "loss_one_device": loss_1, "grad_rel_l2_max": rel[worst],
                     "worst_leaf": worst,
                     "grad_rel_l2_median": float(np.median(list(rel.values())))},
           "copies_bit_identical": copies, "step_wall_p50_ms": walls}
    log(f"[sharded] (c) lm_train_step over {mesh.shape} (MHA flagship, bf16, B={TRAIN_B}, "
        f"S={batch['tokens'].shape[1] - 1}): step 0 loss {loss_n:.6f} against one device's "
        f"{loss_1:.6f}, gradients within {rel[worst]:.3e} relative L2 at {worst} (median "
        f"{out['step0']['grad_rel_l2_median']:.3e}; bound {TRAIN_GRAD_REL_L2}); {SHARD_STEPS} "
        f"steps of adam({TRAIN_LR}): loss {losses[0]:.4f} -> {losses[-1]:.4f}, launches "
        f"{launches} ({per} of each a step: {cfg.n_layers} layers x (1+2) blocks x 2 tp shards), "
        f"{copies} replicated copies bit-identical; step wall p50 {walls['tp2_sp2']:.3f} ms "
        f"over tp x sp against {walls['one']:.3f} ms on one device (recorded, not claimed) "
        f"on {smi}")
    return out


def train_pipeline(torch, dev, smi, devices) -> dict:
    """(d) the pipeline over {"pp": 4} at the flagship's GQA train config (3
    layers a stage), tokens [16, 513], 4 microbatches: the forward's logits
    against lm_apply on one device, step 0's gradients against one device's
    kernel path, SHARD_STEPS train steps (a falling loss, the embedding and
    final norm's copies bit-identical); 12 x 4 forward launches a forward,
    48 dQ and 48 dK/dV a step; each stage's parameter bytes and
    memory_allocated on each card."""
    from seldon_core_tpu_torch.models.transformer import (LMConfig, lm_apply, lm_init, lm_loss,
                                                          lm_pipeline_apply, lm_pipeline_loss,
                                                          lm_pipeline_params,
                                                          lm_pipeline_train_step, lm_train_step)
    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.optim import adam
    from seldon_core_tpu_torch.parallel.mesh import build_mesh
    from seldon_core_tpu_torch.tree import leaves_with_paths

    dims = {k: v for k, v in GEN_DIMS.items() if k != "max_new_tokens"}
    cfg = LMConfig(**dims, dtype=torch.bfloat16)
    params = lm_init(torch.Generator().manual_seed(SEED), cfg, dev)
    mesh = build_mesh({"pp": PIPE_STAGES}, devices=devices)
    pp = lm_pipeline_params(params, cfg, PIPE_STAGES, mesh)
    stage_bytes = [tree_bytes(s["stages"]) for s in pp.shards]
    memory = {str(d): torch.cuda.memory_allocated(d) for d in mesh.distinct_devices}
    rng = np.random.default_rng(SEED + 44)
    batch = {"tokens": torch.as_tensor(copy_batch(rng, cfg.vocab), dtype=torch.int32,
                                       device=dev)}
    x = batch["tokens"][:, :-1]
    lps = cfg.n_layers // PIPE_STAGES
    with torch.inference_mode():
        want = lm_apply(params, x, cfg, use_flash=True)
        flash_reset(fa)
        got = lm_pipeline_apply(pp, x, cfg, n_micro=PIPE_MICRO, use_flash=True)
        sync_all(torch)
        fwd_launches = fa.LAUNCHES
        err = float((got - want).abs().max())
        del got, want
    loss_1, g1 = step_grads(torch, lambda p, b: lm_loss(p, b, cfg), params, batch)
    loss_n, gn = step_grads(torch, lambda p, b: lm_pipeline_loss(p, b, cfg, n_micro=PIPE_MICRO),
                            pp, batch)
    whole = {}
    for i, shard in enumerate(gn.shards):
        s = mesh.coords(i)["pp"]
        for key, leaf in leaves_with_paths(shard["stages"]):
            for j in range(lps):
                whole[f"['l{s * lps + j}']{key}"] = leaf[0, j]
    for key in ("embed", "ln_f"):
        whole[f"[{key!r}]"] = gn.shards[0][key]
    rel = rel_l2(torch, whole, dict(leaves_with_paths(g1)))
    worst = max(rel, key=rel.get)
    del g1, gn, whole
    if (fwd_launches != cfg.n_layers * PIPE_MICRO or err > MESH_LOGIT_ATOL
            or rel[worst] > TRAIN_GRAD_REL_L2 or abs(loss_n - loss_1) / loss_1 > TRAIN_LOSS_RTOL):
        raise AssertionError(f"[sharded] pipeline: forward launched {fwd_launches} (want "
                             f"{cfg.n_layers * PIPE_MICRO}), logits {err:.4f} from one device's "
                             f"(bound {MESH_LOGIT_ATOL}); step 0 loss {loss_n} against {loss_1}, "
                             f"gradient relative L2 {rel[worst]:.3e} at {worst}")
    opt = adam(TRAIN_LR)
    state = opt.init(pp)
    losses = []
    flash_reset(fa)
    p = pp
    for _ in range(SHARD_STEPS):
        p, state, loss = lm_pipeline_train_step(p, state, batch, opt, cfg, n_micro=PIPE_MICRO)
        losses.append(float(loss))
        copies = copies_identical(torch, p)
    sync_all(torch)
    launches = flash_counts(fa)
    per = cfg.n_layers * PIPE_MICRO
    want_l = {k: per * SHARD_STEPS for k in launches}
    if launches != want_l or not losses[-1] < losses[0] or not all(np.isfinite(losses)):
        raise AssertionError(f"[sharded] pipeline: {SHARD_STEPS} steps launched {launches} "
                             f"(want {want_l}), losses {losses}")
    one_state = opt.init(params)
    walls = turns_p50(torch, {
        "pp4": lambda: lm_pipeline_train_step(p, state, batch, opt, cfg, n_micro=PIPE_MICRO),
        "one": lambda: lm_train_step(params, one_state, batch, opt, cfg)}, runs=1)
    out = {"forward_launches": fwd_launches, "max_abs_logit_err": err, "launches": launches,
           "launches_a_step": per, "losses": losses, "copies_bit_identical": copies,
           "step0": {"loss": loss_n, "loss_one_device": loss_1, "grad_rel_l2_max": rel[worst],
                     "worst_leaf": worst},
           "stage_param_bytes": stage_bytes, "whole_layer_bytes": tree_bytes(
               {k: v for k, v in params.items() if k.startswith("l")}),
           "memory_allocated_bytes": memory, "step_wall_p50_ms": walls}
    log(f"[sharded] (d) the pipeline over {mesh.shape} (flagship GQA, bf16, {lps} layers a "
        f"stage, {PIPE_MICRO} microbatches of {TRAIN_B // PIPE_MICRO} rows): stage params "
        f"{stage_bytes} bytes (the whole stack {out['whole_layer_bytes']}), memory_allocated "
        f"{memory}; the forward launched {fwd_launches} flash_attention, logits within "
        f"{err:.4f} of lm_apply on one device (bound {MESH_LOGIT_ATOL}); step 0 gradients "
        f"within {rel[worst]:.3e} relative L2 at {worst} (bound {TRAIN_GRAD_REL_L2}); "
        f"{SHARD_STEPS} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}, launches {launches} "
        f"({per} of each a step), {copies} replicated copies bit-identical; step wall p50 "
        f"{walls['pp4']:.3f} ms over pp=4 against {walls['one']:.3f} ms on one device "
        f"(recorded, not claimed) on {smi}")
    return out


def mnist_dp(torch, dev, smi, devices) -> dict:
    """(e) MNIST's train_step over {"dp": 4} at the example's widths
    (784-256-256-10, bf16), B = 256: step 0's per-leaf gradients (the dp
    shards' sum) against one device's within TRAIN_GRAD_REL_L2, then
    SHARD_STEPS steps against the one-device step on the same batches:
    losses within TRAIN_LOSS_RTOL, the copies bit-identical, and, as a
    sanity bound only (Adam moves an element about lr a step whatever its
    gradient), the parameters within 2 lr a step and a bf16 ulp."""
    from seldon_core_tpu_torch.models.mnist import loss_fn, mlp_init, train_step
    from seldon_core_tpu_torch.optim import adam
    from seldon_core_tpu_torch.parallel.mesh import build_mesh, place_tree
    from seldon_core_tpu_torch.tree import leaves_with_paths

    params = mlp_init(torch.Generator().manual_seed(SEED), hidden=256, device=dev)
    mesh = build_mesh({"dp": SHARDED_SHARDS}, devices=devices)
    sp = place_tree(params, mesh)
    opt = adam(MNIST_DP_LR)
    s1, sn = opt.init(params), opt.init(sp)
    rng = np.random.default_rng(SEED + 45)

    def mnist_batch():
        return {"image": torch.as_tensor(rng.random((MNIST_DP_B, 784)), dtype=torch.float32,
                                         device=dev),
                "label": torch.as_tensor(rng.integers(0, 10, MNIST_DP_B), device=dev)}

    batches = [mnist_batch() for _ in range(SHARD_STEPS)]
    _, g1 = step_grads(torch, loss_fn, params, batches[0])
    _, gn = step_grads(torch, loss_fn, sp, batches[0])
    grel = rel_l2(torch, gather_sharded(torch, gn), dict(leaves_with_paths(g1)))
    gworst = max(grel, key=grel.get)
    del g1, gn
    losses = []
    p1, pn = params, sp
    for b in batches:
        p1, s1, l1 = train_step(p1, s1, b, opt)
        pn, sn, ln = train_step(pn, sn, b, opt)
        losses.append((float(l1), float(ln)))
    copies = copies_identical(torch, pn)
    diff = max(float((pn.shards[0][k].float() - p1[k].float()).abs().max()) for k in p1)
    scale = max(float(p1[k].float().abs().max()) for k in p1)
    bound = SHARD_STEPS * 2 * MNIST_DP_LR + bf16_ulp(scale)
    loss_rel = max(abs(b - a) / a for a, b in losses)
    if grel[gworst] > TRAIN_GRAD_REL_L2 or loss_rel > TRAIN_LOSS_RTOL or diff > bound:
        raise AssertionError(f"[sharded] MNIST over dp=4: step 0 gradients {grel[gworst]:.3e} "
                             f"relative L2 at {gworst} (bound {TRAIN_GRAD_REL_L2}), losses "
                             f"{losses} (rtol {TRAIN_LOSS_RTOL}), parameters {diff:.3e} from "
                             f"one device's (bound {bound:.3e})")
    b = mnist_batch()
    walls = turns_p50(torch, {"dp4": lambda: train_step(pn, sn, b, opt),
                              "one": lambda: train_step(p1, s1, b, opt)}, runs=3)
    out = {"losses": losses, "step0_grad_rel_l2_max": grel[gworst], "worst_leaf": gworst,
           "max_param_diff": diff, "bound": bound, "copies_bit_identical": copies,
           "step_wall_p50_ms": walls}
    log(f"[sharded] (e) MNIST train_step over {mesh.shape} (784-256-256-10 bf16, B="
        f"{MNIST_DP_B}, adam({MNIST_DP_LR})): step 0 gradients within {grel[gworst]:.3e} "
        f"relative L2 at {gworst} (bound {TRAIN_GRAD_REL_L2}); losses (one device, dp=4) "
        f"{losses}, parameters "
        f"within {diff:.3e} of one device's after {SHARD_STEPS} steps (bound {bound:.3e}), "
        f"{copies} copies bit-identical; step wall p50 {walls['dp4']:.3f} ms over dp=4 against "
        f"{walls['one']:.3f} ms on one device (recorded, not claimed) on {smi}")
    return out


def sharded_phase(torch, dev, smi) -> dict:
    """10v. [6b] part 1: the ring alone, serving over sp, the train step over
    tp x sp, the pipeline over pp, MNIST over dp, on four cards when the
    machine has four, else four shards of cuda:0."""
    t_phase = time.perf_counter()
    devices = mesh_devices(torch)
    log(f"[sharded] phase 10v: {len(set(devices))} card(s), {len(devices)} shards ({devices})")
    out = {"devices": devices}
    walls = {}
    for name, fn in (("ring", ring_alone), ("serve_sp", serve_sp), ("train_tp_sp", train_tp_sp),
                     ("pipeline", train_pipeline), ("mnist_dp", mnist_dp)):
        t = time.perf_counter()
        out[name] = fn(torch, dev, smi, devices)
        walls[name] = time.perf_counter() - t
    # the main path's launches: each path's counted from 0 just before it
    # and read just after (the ring alone and the step-0 comparisons are
    # checks against the plain versions, not counted)
    out["launches"] = {
        "flash_attention": (out["serve_sp"]["total_launches"]
                            + out["train_tp_sp"]["launches"]["fwd"]
                            + out["pipeline"]["forward_launches"]
                            + out["pipeline"]["launches"]["fwd"]),
        "flash_attention_bwd_dq": (out["train_tp_sp"]["launches"]["dq"]
                                   + out["pipeline"]["launches"]["dq"]),
        "flash_attention_bwd_dkv": (out["train_tp_sp"]["launches"]["dkv"]
                                    + out["pipeline"]["launches"]["dkv"])}
    out["card"] = smi
    out["part_walls_s"] = walls
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[sharded] phase 10v wall {out['wall_s']:.2f} s: {walls}")
    return out


# -- 10w. [6b] part 2: one process a card (multihost) ----------------------------

MH_SHARDS = 4                  # every path's mesh: 4 shards over the processes
MH_WORKER_TIMEOUT_S = 300      # each worker process's own limit
MH_ROUND_CALLS = 200           # collective rounds timed for their host cost
MH_COLL_SHAPE = (64, 256)      # a shard's bf16 input of the collectives check
# the collectives check's meshes: (axes, dcn_axes) of multihost.global_mesh
MH_COLL_MESHES = {"sp4": ({"sp": 4}, None), "tp4": ({"tp": 4}, None),
                  "dp2_tp2": ({"tp": 2}, {"dp": 2})}
MH_FAULT_REQUESTS = 8          # (e): 1-row requests, then one of 64 rows
# (f), (g): a step-0 gradient block across processes against the one-process
# mesh's, as relative L2.  A block whose readers' shares meet in another
# order across processes (each expert output read by every ep shard, summed
# through the exchange's adjoint, and what flows back from it) rounds its
# bf16 sums elsewhere: each element moves by an ulp (2^-8 of itself) at
# most a few times; 2^-6 still catches a wrong or missing share (O(1))
MH_GRAD_REL_L2 = 2.0 ** -6


def mh_layout(torch) -> dict:
    """Four processes with a card each (CUDA_VISIBLE_DEVICES=i, NCCL) when
    the machine has four cards, else two processes sharing cuda:0 (gloo),
    two shards each."""
    if torch.cuda.device_count() >= MH_SHARDS:
        return {"procs": MH_SHARDS, "local": 1, "visible": [str(i) for i in range(MH_SHARDS)]}
    return {"procs": 2, "local": MH_SHARDS // 2, "visible": None}


def mh_collectives(torch, mesh) -> dict:
    """{collective/axis/shard: sha1 of its answer}: all_reduce, all_gather,
    gather_slices and ring_shift over every axis of ``mesh``, each shard's
    bf16 input drawn from its index."""
    import hashlib

    from seldon_core_tpu_torch.parallel import mesh as pm

    def body(shard):
        x = torch.randn(MH_COLL_SHAPE, generator=torch.Generator().manual_seed(
            SEED + 200 + shard.index)).to(shard.device, torch.bfloat16)
        w, out = MH_COLL_SHAPE[1], {}
        for axis in mesh.axis_names:
            n = mesh.shape[axis]
            out[f"all_reduce/{axis}"] = pm.all_reduce(x, axis)
            out[f"all_gather/{axis}"] = pm.all_gather(x, axis, dim=1)
            out[f"gather_slices/{axis}"] = pm.gather_slices(x, axis, 1,
                                                            [(3, w + 5), (n * w - 7, n * w)])
            k, v = pm.ring_shift((x, x * 2), axis)
            out[f"ring_shift/{axis}"] = torch.cat([k, v])
        return out

    outs = mesh.run(body)
    return {f"{k}/{i}": hashlib.sha1(v.float().cpu().numpy().tobytes()).hexdigest()
            for i in mesh.owned for k, v in outs[i].items()}


def mh_flagship_inputs(torch, dev):
    """The flagship generator (10u's weights, seed SEED) and 10u's B=4,
    S=128 prompts."""
    from seldon_core_tpu_torch.models import generate as gm

    one = gm.TransformerGenerator(**{**GEN_DIMS, "max_new_tokens": MESH_NEW}, dtype="bfloat16",
                                  device=dev)
    state = one.init_state(torch.Generator().manual_seed(SEED))
    prompts = np.random.default_rng(SEED + 31).integers(0, one.cfg.vocab, size=(MESH_B, MESH_S))
    return one, state, prompts


def mh_train_inputs(torch, dev):
    """The GQA flagship's train config in bf16 and 10v's copy-task batch."""
    from seldon_core_tpu_torch.models.transformer import LMConfig, lm_init

    cfg = LMConfig(**{k: v for k, v in GEN_DIMS.items() if k != "max_new_tokens"},
                   dtype=torch.bfloat16)
    params = lm_init(torch.Generator().manual_seed(SEED), cfg, dev)
    batch = {"tokens": torch.as_tensor(copy_batch(np.random.default_rng(SEED + 43), cfg.vocab),
                                       dtype=torch.int32, device=dev)}
    return cfg, params, batch


def mh_prefill(torch, gm, params, cfg, mesh, P):
    cache = mesh.map_shards(lambda s: gm.init_cache(cfg.for_shard(s), MESH_B, MESH_S, s.device))
    return gm.prefill(params, P, cache, cfg, True)[0]


def mh_references(torch, dev) -> dict:
    """What 10w holds the processes to, on this process's one-process meshes
    of the same shapes (10u's devices): the collectives' answers, the
    flagship's prefill logits over tp=4 and on one device, step 0's loss
    over dp=2 x tp=2, and (f)'s pipeline over pp=4 and (g)'s MoE over ep=4
    with their step 0 gradient blocks."""
    from seldon_core_tpu_torch.models import generate as gm
    from seldon_core_tpu_torch.models.transformer import lm_loss, shard_params
    from seldon_core_tpu_torch.parallel.mesh import build_mesh

    devices = mesh_devices(torch)
    ref = {"collectives": {}}
    for name, (axes, dcn) in MH_COLL_MESHES.items():
        ref["collectives"].update({f"{name}/{k}": v for k, v in mh_collectives(
            torch, build_mesh({**(dcn or {}), **axes}, devices=devices)).items()})
    one, state, prompts = mh_flagship_inputs(torch, dev)
    mesh = build_mesh({"tp": MH_SHARDS}, devices=devices)
    tp = gm.TransformerGenerator(**GEN_DIMS, dtype="bfloat16", mesh=mesh)
    P = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        ref["l1"] = gm.prefill(state["params"], P, gm.init_cache(one.cfg, MESH_B, MESH_S, dev),
                               one.cfg, True)[0].float().cpu().numpy()
        ref["lN"] = mh_prefill(torch, gm, tp.shard_state(state)["params"], one.cfg, mesh,
                               P).float().cpu().numpy()
    ref["flagship"] = (one, state, prompts)
    cfg, params, batch = mh_train_inputs(torch, dev)
    tmesh = build_mesh({"dp": 2, "tp": 2}, devices=devices)
    ref["train_loss"], _ = step_grads(torch, lambda p, b: lm_loss(p, b, cfg),
                                      shard_params(params, tmesh), batch)
    del params, batch
    torch.cuda.empty_cache()
    ref["pipeline"] = mh_pipeline(torch, lambda a: build_mesh(a, devices=devices), dev)
    torch.cuda.empty_cache()
    ref["moe"] = mh_moe(torch, lambda a: build_mesh(a, devices=devices), dev)
    torch.cuda.empty_cache()
    return ref


def mh_ring(torch, mh, local, dev) -> dict:
    """(a) ring_attention_sharded over a cross-process {"sp": 4}: 10v's 4
    causal blocks through RingFlash against the plain ring in f32 on the
    same mesh; each process's gradients cover its own blocks."""
    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.parallel.ring_attention import ring_attention_sharded

    B, H, KV, Sl, D = RING_SHAPE
    mesh = mh.global_mesh({"sp": MH_SHARDS}, devices=local)
    g = torch.Generator().manual_seed(SEED + 40)
    q, k, v, do = (torch.randn(B, H, MH_SHARDS * Sl, D, generator=g).to(dev, torch.bfloat16)
                   for _ in range(4))
    kern = ring_attention_sharded(mesh, "sp", True, use_flash=True)
    plain = ring_attention_sharded(mesh, "sp", True, use_flash=False)

    def fwd_bwd(fn, ins, cot):
        ts = [t.detach().requires_grad_() for t in ins]
        return mesh.value_and_grad(lambda: fn(*ts), ts, cot)

    flash_reset(fa)
    o_k, g_k = fwd_bwd(kern, (q, k, v), do)
    sync_all(torch)
    launches = flash_counts(fa)
    o_p, g_p = fwd_bwd(plain, [t.float() for t in (q, k, v)], do.float())
    out = {"launches": launches, "o_err": float((o_k.float() - o_p).abs().max()),
           "grad_diff_max": {n: float((a.float() - b).abs().max())
                             for n, a, b in zip(("dq", "dk", "dv"), g_k, g_p)},
           "grad_ref_max": {n: float(b.abs().max()) for n, b in zip(("dq", "dk", "dv"), g_p)}}
    del g_p, o_p
    out["fwd_bwd_wall_p50_ms"] = turns_p50(torch, {
        "kernel": lambda: fwd_bwd(kern, (q, k, v), do),
        "plain_bf16": lambda: fwd_bwd(plain, (q, k, v), do)})
    return out


def mh_round_us(torch, mesh) -> float:
    """Host microseconds a round of ``all_reduce`` over the cross-process
    tp axis takes, on a 4-element tensor on each shard's card."""
    from seldon_core_tpu_torch.parallel.mesh import all_reduce

    def body(shard):
        x = torch.ones(4, device=shard.device)
        for _ in range(10):
            all_reduce(x, "tp")
        torch.cuda.synchronize(shard.device)
        t = time.perf_counter()
        for _ in range(MH_ROUND_CALLS):
            y = all_reduce(x, "tp")
        y.sum().item()
        return (time.perf_counter() - t) / MH_ROUND_CALLS * 1e6

    return float(mesh.run(body)[mesh.owned[0]])


def mh_flagship(torch, mh, local, dev, rank: int, out_dir: Path) -> dict:
    """(b) the flagship generator over a cross-process {"tp": 4}: the
    prefill's logits and the static request's tokens (to the parent), every
    process's launches, the request wall against one device in turns (the
    one-device requests on process 0 only)."""
    from seldon_core_tpu_torch.models import generate as gm
    from seldon_core_tpu_torch.ops import flash_attention as fa, flash_decode as fd
    from seldon_core_tpu_torch.ops import kv_write as kw

    one, state, prompts = mh_flagship_inputs(torch, dev)
    mesh = mh.global_mesh({"tp": MH_SHARDS}, devices=local)
    t0 = time.perf_counter()
    tp = gm.TransformerGenerator(**{**GEN_DIMS, "max_new_tokens": MESH_NEW}, dtype="bfloat16",
                                 mesh=mesh)
    sstate = tp.shard_state(state)
    build_s = time.perf_counter() - t0
    P = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        reset_counts(fa, fd, kw)
        lN = mh_prefill(torch, gm, sstate["params"], one.cfg, mesh, P)
        sync_all(torch)
        pre = read_counts(fa, fd, kw)
        reset_counts(fa, fd, kw)
        y = tp.predict(sstate, P.float())
        sync_all(torch)
        static = read_counts(fa, fd, kw)
        np.savez(out_dir / f"rank{rank}_flagship.npz", lN=lN.float().cpu().numpy(),
                 toks=y.long().cpu().numpy())
        # in turns (ABBA), the request above being the multihost side's warm
        # call; the one-device requests on process 0 only
        X = P.float()
        fns = {"multihost": lambda: tp.predict(sstate, X), "one": lambda: one.predict(state, X)}
        walls = {"multihost": [], "one": []}
        if rank == 0:
            fns["one"]()
        for name in ("multihost", "one", "one", "multihost"):
            if name == "one" and rank != 0:
                continue
            sync_all(torch)
            t = time.perf_counter()
            fns[name]()
            sync_all(torch)
            walls[name].append(time.perf_counter() - t)
        walls = {k: float(np.median(v) * 1e3) if v else None for k, v in walls.items()}
    return {"build_s": build_s, "tp_use_flash": tp.use_flash, "prefill_launches": pre,
            "static_launches": static, "request_wall_p50_ms": walls,
            "round_us": mh_round_us(torch, mesh), "owned": mesh.owned,
            "shard_devices": [str(mesh.device_list[i]) for i in mesh.owned]}


def mh_blocks(torch, tree, whole: dict) -> list:
    """[(leaf, block key, sum of squared differences, sum of squares of the
    one-device block)] for each of this process's shards of ``tree``
    against ``whole`` (one device's leaves)."""
    from seldon_core_tpu_torch.tree import leaves_with_paths

    mesh, specs = tree.mesh, dict(leaves_with_paths(tree.specs))
    rows = []
    for i in mesh.owned:
        for path, t in leaves_with_paths(tree.shards[i]):
            ref, key = whole[path], []
            for dim, axis in enumerate(specs.get(path, ())):
                if axis is None or mesh.shape.get(axis, 1) == 1:
                    continue
                n, c = mesh.shape[axis], mesh.coords(i)[axis]
                ref = ref.narrow(dim, c * (ref.shape[dim] // n), ref.shape[dim] // n)
                key.append(f"{axis}{c}")
            d = t.float() - ref.float().to(t.device)
            rows.append([path, "/".join(key), float((d * d).sum()),
                         float((ref.float() ** 2).sum())])
    return rows


def mh_hashes(torch, tree) -> list:
    """[(leaf, block key, sha1)] of this process's shards of ``tree``."""
    import hashlib

    from seldon_core_tpu_torch.tree import leaves_with_paths

    mesh, specs = tree.mesh, dict(leaves_with_paths(tree.specs or {}))
    rows = []
    for i in mesh.owned:
        for path, t in leaves_with_paths(tree.shards[i]):
            key = "/".join(f"{a}{mesh.coords(i)[a]}" for a in specs.get(path, ())
                           if a is not None and mesh.shape.get(a, 1) > 1)
            rows.append([path, key, hashlib.sha1(
                t.detach().float().cpu().numpy().tobytes()).hexdigest()])
    return rows


def mh_train(torch, mh, local, dev) -> dict:
    """(c) lm_train_step over dp=2 (over processes) x tp=2 at the GQA
    flagship's train config on the copy task: step 0's loss and per-block
    gradients against one device's, SHARD_STEPS steps with their launches,
    the replicated copies' hashes."""
    from seldon_core_tpu_torch.models.transformer import lm_loss, lm_train_step, shard_params
    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.optim import adam
    from seldon_core_tpu_torch.tree import leaves_with_paths

    cfg, params, batch = mh_train_inputs(torch, dev)
    mesh = mh.global_mesh({"tp": 2}, {"dp": 2}, devices=local)
    sparams = shard_params(params, mesh)
    loss_1, g1 = step_grads(torch, lambda p, b: lm_loss(p, b, cfg), params, batch)
    loss_n, gn = step_grads(torch, lambda p, b: lm_loss(p, b, cfg), sparams, batch)
    blocks = mh_blocks(torch, gn, dict(leaves_with_paths(g1)))
    del g1, gn
    opt = adam(TRAIN_LR)
    state = opt.init(sparams)
    losses, p = [], sparams
    flash_reset(fa)
    for _ in range(SHARD_STEPS):
        p, state, loss = lm_train_step(p, state, batch, opt, cfg)
        losses.append(float(loss))
    sync_all(torch)
    launches = flash_counts(fa)
    one_state = opt.init(params)
    walls = turns_p50(torch, {"multihost": lambda: lm_train_step(p, state, batch, opt, cfg),
                              "one": lambda: lm_train_step(params, one_state, batch, opt, cfg)},
                      runs=1)
    return {"loss": loss_n, "loss_one_device": loss_1, "blocks": blocks, "losses": losses,
            "launches": launches, "hashes": mh_hashes(torch, p), "step_wall_p50_ms": walls}


def mh_mnist(torch, mh, local, dev) -> dict:
    """(d) MNIST's train_step over a cross-process {"dp": 4}, 10v's widths
    and batches: step 0's gradients and SHARD_STEPS steps against one
    device's, the copies' hashes."""
    from seldon_core_tpu_torch.models.mnist import loss_fn, mlp_init, train_step
    from seldon_core_tpu_torch.optim import adam
    from seldon_core_tpu_torch.parallel.mesh import place_tree
    from seldon_core_tpu_torch.tree import leaves_with_paths

    params = mlp_init(torch.Generator().manual_seed(SEED), hidden=256, device=dev)
    mesh = mh.global_mesh({"dp": MH_SHARDS}, devices=local)
    sp = place_tree(params, mesh)
    opt = adam(MNIST_DP_LR)
    s1, sn = opt.init(params), opt.init(sp)
    rng = np.random.default_rng(SEED + 45)
    batches = [{"image": torch.as_tensor(rng.random((MNIST_DP_B, 784)), dtype=torch.float32,
                                         device=dev),
                "label": torch.as_tensor(rng.integers(0, 10, MNIST_DP_B), device=dev)}
               for _ in range(SHARD_STEPS)]
    _, g1 = step_grads(torch, loss_fn, params, batches[0])
    _, gn = step_grads(torch, loss_fn, sp, batches[0])
    grel = rel_l2(torch, dict(leaves_with_paths(gn.shards[mesh.owned[0]])),
                  dict(leaves_with_paths(g1)))
    losses, p1, pn = [], params, sp
    for b in batches:
        p1, s1, l1 = train_step(p1, s1, b, opt)
        pn, sn, ln = train_step(pn, sn, b, opt)
        losses.append((float(l1), float(ln)))
    first = pn.shards[mesh.owned[0]]
    diff = max(float((first[k].float() - p1[k].float()).abs().max()) for k in p1)
    scale = max(float(p1[k].float().abs().max()) for k in p1)
    return {"grad_rel_l2": grel, "losses": losses, "max_param_diff": diff,
            "bound": SHARD_STEPS * 2 * MNIST_DP_LR + bf16_ulp(scale),
            "hashes": mh_hashes(torch, pn)}


def tree_blocks(torch, tree) -> dict:
    """{"leaf|block key": tensor} of this process's shards of a ShardedTree,
    each block once (a replicated leaf's first copy)."""
    from seldon_core_tpu_torch.tree import leaves_with_paths

    mesh, specs = tree.mesh, dict(leaves_with_paths(tree.specs or {}))
    out = {}
    for i in mesh.owned:
        for path, t in leaves_with_paths(tree.shards[i]):
            key = "/".join(f"{a}{mesh.coords(i)[a]}" for a in specs.get(path, ())
                           if a is not None and mesh.shape.get(a, 1) > 1)
            out.setdefault(f"{path}|{key}", t.detach())
    return out


def mh_grad_blocks(torch, tree, out_path: Path) -> int:
    """This process's gradient blocks (``tree_blocks``) written to
    ``out_path`` (.npz, each block's bytes) for the parent."""
    blocks = tree_blocks(torch, tree)
    np.savez(out_path, **{k: t.contiguous().view(torch.uint8).cpu().numpy()
                          for k, t in blocks.items()})
    return len(blocks)


def mh_same_blocks(torch, want: dict, paths: list, what: str) -> dict:
    """The workers' gradient blocks (their .npz files) against the
    one-process mesh's ``want``: every block present, the bit-identical
    ones counted, each block's relative L2 difference; fails above
    MH_GRAD_REL_L2."""
    got = {}
    for p in paths:
        with np.load(p) as z:
            for k in z.files:
                got.setdefault(k, z[k])
    if set(got) != set(want):
        raise AssertionError(f"[multihost] {what}: gradient blocks {sorted(set(got) ^ set(want))[:4]} "
                             f"on one side only")
    same, rel = 0, {}
    for k, w in want.items():
        g = torch.from_numpy(got[k]).to(w.device).view(w.dtype)
        if torch.equal(g.view(torch.uint8), w.contiguous().view(torch.uint8)):
            same += 1
            rel[k] = 0.0
            continue
        rel[k] = float((g.float() - w.float()).norm() / w.float().norm())
    worst = max(rel, key=rel.get)
    if rel[worst] > MH_GRAD_REL_L2:
        raise AssertionError(f"[multihost] {what}: step 0 gradient block {worst} {rel[worst]:.3e} "
                             f"relative L2 from the one-process mesh's (bound {MH_GRAD_REL_L2})")
    return {"blocks": len(want), "bit_identical": same, "rel_l2_max": rel[worst],
            "worst_block": worst}


def mh_pipeline(torch, make_mesh, dev, out_dir=None, rank: int = 0) -> dict:
    """(f) the GPipe pipeline over {"pp": 4} at the GQA flagship's train
    config (3 layers a stage): a forward of 10u's B=4, S=128 shape in
    PIPE_MICRO microbatches (its logits' hash, its launches, the bytes a
    hand-off tick received, DeviceMesh.crossed_bytes), then a train step's
    forward and backward on the copy task (optim.grad_update, as
    lm_pipeline_train_step calls it, with a capturing optimizer): step 0's
    loss, gradient blocks and launches.  ``make_mesh(axes)`` is a global mesh in a worker, a
    one-process mesh of the same shape for the reference."""
    import hashlib

    from seldon_core_tpu_torch.models.transformer import (lm_pipeline_apply, lm_pipeline_loss,
                                                          lm_pipeline_params)
    from seldon_core_tpu_torch.ops import flash_attention as fa

    cfg, params, batch = mh_train_inputs(torch, dev)
    mesh = make_mesh({"pp": MH_SHARDS})
    pp = lm_pipeline_params(params, cfg, MH_SHARDS, mesh)
    del params
    x = batch["tokens"][:MESH_B, :MESH_S]
    before = mesh.crossed_bytes.get("pp", 0)
    with torch.inference_mode():
        flash_reset(fa)
        logits = lm_pipeline_apply(pp, x, cfg, n_micro=PIPE_MICRO, use_flash=True)
        sync_all(torch)
        fwd = flash_counts(fa)
        sha = hashlib.sha1(logits.float().cpu().numpy().tobytes()).hexdigest()
        del logits
    ticks = PIPE_MICRO + MH_SHARDS - 2   # the ticks that hand an activation on
    tick_bytes = (mesh.crossed_bytes.get("pp", 0) - before) / ticks
    flash_reset(fa)
    loss, grads = step_grads(torch, lambda p, b: lm_pipeline_loss(p, b, cfg, n_micro=PIPE_MICRO),
                             pp, batch)
    sync_all(torch)
    step = flash_counts(fa)
    if out_dir is not None:
        mh_grad_blocks(torch, grads, out_dir / f"rank{rank}_pipeline_grads.npz")
        grads = None
    out = {"logits_sha": sha, "fwd_launches": fwd, "tick_bytes": tick_bytes, "loss": loss,
           "step_launches": step, "owned": mesh.owned}
    if grads is not None:
        out["grad_blocks"] = tree_blocks(torch, grads)
    return out


def mh_moe(torch, make_mesh, dev, out_dir=None, rank: int = 0) -> dict:
    """(g) the flagship with MoE layers (MOE_PARAMS: every second layer, 8
    experts top 2) over {"ep": 4}, two experts a shard: a 4x128 static
    request of MESH8_NEW tokens (the prefill's logits hashed, the tokens,
    the launches), then at the train config a train step's forward and
    backward on the copy task (grad_update with a capturing optimizer, as
    in (f)): step 0's loss, gradient blocks and launches."""
    import hashlib

    from seldon_core_tpu_torch.models import generate as gm
    from seldon_core_tpu_torch.models.transformer import LMConfig, lm_loss, shard_params
    from seldon_core_tpu_torch.ops import flash_attention as fa, flash_decode as fd
    from seldon_core_tpu_torch.ops import kv_write as kw

    kwargs = {**GEN_DIMS, **MOE_PARAMS, "dtype": "bfloat16", "max_new_tokens": MESH8_NEW}
    one = gm.TransformerGenerator(**kwargs, device=dev)
    state = one.init_state(torch.Generator().manual_seed(SEED))
    mesh = make_mesh({"ep": MH_SHARDS})
    unit = gm.TransformerGenerator(**kwargs, mesh=mesh)
    sstate = unit.shard_state(state)
    prompts = np.random.default_rng(SEED + 39).integers(0, GEN_DIMS["vocab"],
                                                        size=(MESH_B, MESH_S))
    P = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    cfg = unit.cfg
    with torch.inference_mode():
        cache = mesh.map_shards(lambda s: gm.init_cache(cfg.for_shard(s), MESH_B, MESH_S,
                                                        s.device))
        reset_counts(fa, fd, kw)
        lN = gm.prefill(sstate["params"], P, cache, cfg, True)[0]
        sync_all(torch)
        pre = read_counts(fa, fd, kw)
        sha = hashlib.sha1(lN.float().cpu().numpy().tobytes()).hexdigest()
        del cache, lN
        reset_counts(fa, fd, kw)
        y = unit.predict(sstate, P.float())
        sync_all(torch)
        static = read_counts(fa, fd, kw)
    toks = y.long().cpu().numpy().tolist()
    del sstate, unit
    torch.cuda.empty_cache()
    # the train config is the generator's: its seeded weights (seed SEED) train
    tcfg = LMConfig(**{k: v for k, v in GEN_DIMS.items() if k != "max_new_tokens"},
                    **MOE_PARAMS, dtype=torch.bfloat16)
    params = shard_params(state["params"], mesh)
    del state, one
    batch = {"tokens": torch.as_tensor(copy_batch(np.random.default_rng(SEED + 43), tcfg.vocab),
                                       dtype=torch.int32, device=dev)}
    flash_reset(fa)
    loss, grads = step_grads(torch, lambda p, b: lm_loss(p, b, tcfg), params, batch)
    sync_all(torch)
    step = flash_counts(fa)
    if out_dir is not None:
        mh_grad_blocks(torch, grads, out_dir / f"rank{rank}_moe_grads.npz")
        grads = None
    out = {"prefill_sha": sha, "prefill_launches": pre, "static_launches": static,
           "tokens": toks, "loss": loss, "step_launches": step, "owned": mesh.owned}
    if grads is not None:
        out["grad_blocks"] = tree_blocks(torch, grads)
    return out


def mh_new_paths(torch, res: list, ref: dict, out_dir: Path, smi) -> dict:
    """(f) and (g): the pipeline over pp=4 and MoE experts over ep=4 across
    processes, held to the one-process meshes (``ref``): logits' and
    tokens' bits, step 0's loss bits, every gradient block, launches
    against the prediction, the bytes a hand-off tick received."""
    L = GEN_DIMS["n_layers"]
    out = {}
    pipe = [r["pipeline"] for r in res]
    rp = ref["pipeline"]
    fwd = {k: sum(p["fwd_launches"][k] for p in pipe) for k in ("fwd", "dq", "dkv")}
    step = {k: sum(p["step_launches"][k] for p in pipe) for k in ("fwd", "dq", "dkv")}
    want_fwd, want_step = {"fwd": L * PIPE_MICRO, "dq": 0, "dkv": 0}, \
        {k: L * PIPE_MICRO for k in ("fwd", "dq", "dkv")}
    grads = mh_same_blocks(torch, rp["grad_blocks"],
                           [out_dir / f"rank{r['rank']}_pipeline_grads.npz" for r in res],
                           "(f) the pipeline")
    if (any(p["logits_sha"] != rp["logits_sha"] or p["loss"] != rp["loss"] for p in pipe)
            or fwd != want_fwd or step != want_step or fwd != rp["fwd_launches"]):
        raise AssertionError(f"[multihost] (f) the pipeline over pp=4 across processes: logits "
                             f"{[p['logits_sha'][:8] for p in pipe]} against "
                             f"{rp['logits_sha'][:8]}, step 0 losses {[p['loss'] for p in pipe]} "
                             f"against {rp['loss']}; the forward launched {fwd} (want "
                             f"{want_fwd}), the step {step} (want {want_step})")
    ticks = [p["tick_bytes"] for p in pipe]
    out["pipeline"] = {"forward_launches": fwd, "step_launches": step,
                       "forward_launches_by_process": [p["fwd_launches"]["fwd"] for p in pipe],
                       "step_launches_by_process": [p["step_launches"] for p in pipe],
                       "loss": rp["loss"], "grads": grads, "tick_bytes_by_process": ticks}
    log(f"[multihost] (f) the pipeline over a cross-process pp=4 (GQA flagship, bf16, "
        f"{L // MH_SHARDS} layers a stage, stages {[p['owned'] for p in pipe]} by process): a "
        f"{MESH_B}x{MESH_S} forward in {PIPE_MICRO} microbatches launched {fwd['fwd']} "
        f"flash_attention ({[p['fwd_launches']['fwd'] for p in pipe]} by process), its logits on "
        f"every process bit for bit the one-process mesh's; a hand-off tick received "
        f"{[round(t) for t in ticks]} bytes by process (DeviceMesh.crossed_bytes over "
        f"{PIPE_MICRO + MH_SHARDS - 2} ticks: one all_gather of the senders' activations of "
        f"{MESH_B // PIPE_MICRO}x{MESH_S}x{GEN_DIMS['d_model']} bf16); step 0 loss "
        f"{rp['loss']:.6f} on every process bit for bit, {grads['bit_identical']} of "
        f"{grads['blocks']} gradient blocks bit-identical (worst {grads['rel_l2_max']:.3e} "
        f"relative L2, bound {MH_GRAD_REL_L2}); the step launched {step} "
        f"({[p['step_launches'] for p in pipe]} by process) on {smi}")

    moe = [r["moe"] for r in res]
    rm = ref["moe"]
    pre = {k: sum(m["prefill_launches"][k] for m in moe) for k in COUNTED}
    static = {k: sum(m["static_launches"][k] for m in moe) for k in COUNTED}
    mstep = {k: sum(m["step_launches"][k] for m in moe) for k in ("fwd", "dq", "dkv")}
    want_pre = {"flash_attention": L * MH_SHARDS, "flash_decode": 0, "kv_write": 0,
                "flash_decode_paged": 0, "kv_write_paged": 0}
    want_static = {**want_pre, "flash_decode": L * MH_SHARDS * (MESH8_NEW - 1)}
    want_mstep = {k: L * MH_SHARDS for k in ("fwd", "dq", "dkv")}
    mgrads = mh_same_blocks(torch, rm["grad_blocks"],
                            [out_dir / f"rank{r['rank']}_moe_grads.npz" for r in res],
                            "(g) MoE over ep")
    if (any(m["prefill_sha"] != rm["prefill_sha"] or m["tokens"] != rm["tokens"]
            or m["loss"] != rm["loss"] for m in moe)
            or pre != want_pre or static != want_static or mstep != want_mstep):
        raise AssertionError(f"[multihost] (g) MoE over ep=4 across processes: prefill logits "
                             f"{[m['prefill_sha'][:8] for m in moe]} against "
                             f"{rm['prefill_sha'][:8]}, tokens equal "
                             f"{[m['tokens'] == rm['tokens'] for m in moe]}, step 0 losses "
                             f"{[m['loss'] for m in moe]} against {rm['loss']}; launched {pre} "
                             f"(want {want_pre}), {static} (want {want_static}), a step {mstep} "
                             f"(want {want_mstep})")
    out["moe"] = {"prefill_launches": pre, "static_launches": static, "step_launches": mstep,
                  "launches_by_process": [[m["static_launches"]["flash_decode"],
                                           m["step_launches"]] for m in moe],
                  "loss": rm["loss"], "grads": mgrads}
    log(f"[multihost] (g) the flagship with MoE layers ({MOE_PARAMS}) over a cross-process "
        f"ep=4, two experts a shard: a {MESH_B}x{MESH_S} prefill launched "
        f"{pre['flash_attention']} flash_attention, its logits on every process bit for bit the "
        f"one-process mesh's; the static request of {MESH8_NEW} tokens {static['flash_decode']} "
        f"flash_decode ({L} x {MH_SHARDS} x {MESH8_NEW - 1}; "
        f"{[m['static_launches']['flash_decode'] for m in moe]} by process), the tokens on every "
        f"process the one-process mesh's; step 0 loss {rm['loss']:.6f} bit for bit, "
        f"{mgrads['bit_identical']} of {mgrads['blocks']} gradient blocks bit-identical (worst "
        f"{mgrads['rel_l2_max']:.3e} relative L2 at {mgrads['worst_block']}, bound "
        f"{MH_GRAD_REL_L2}); the step launched {mstep} on {smi}")
    out["launches"] = {"flash_attention": fwd["fwd"] + step["fwd"] + pre["flash_attention"]
                       + static["flash_attention"] + mstep["fwd"],
                       "flash_attention_bwd_dq": step["dq"] + mstep["dq"],
                       "flash_attention_bwd_dkv": step["dkv"] + mstep["dkv"],
                       "flash_decode": static["flash_decode"]}
    return out


def multihost_worker(out_dir: str) -> int:
    """One process of phase 10w: joins the others through the SELDON_* env
    contract (parallel/multihost.py) and runs (a)-(d), (f) and (g) over
    global meshes,
    writing its results under ``out_dir`` for the parent."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from seldon_core_tpu_torch.parallel import multihost as mh

    os.environ["SELDON_TPU_GEN_CONTINUOUS"] = "0"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    plan = json.loads((Path(out_dir) / "plan.json").read_text())
    if not mh.initialize():
        raise RuntimeError("multihost worker: no coordinator address in the environment")
    info = mh.process_info()
    rank = info["process_index"]
    dev = torch.device("cuda", 0)
    local = ["cuda:0"] * plan["local"]
    out = {"rank": rank, "backend": mh.backend(), "info": info,
           "card": torch.cuda.get_device_name(0), "join_s": time.perf_counter() - t0,
           "collectives": {}}
    walls = {}
    for name, (axes, dcn) in MH_COLL_MESHES.items():
        out["collectives"].update({f"{name}/{k}": v for k, v in mh_collectives(
            torch, mh.global_mesh(axes, dcn, devices=local)).items()})
    # the parent computes its one-process references while the workers
    # start; the timed parts wait for them to be done (the card is shared)
    t = time.perf_counter()
    while not (Path(out_dir) / "go").exists():
        if time.perf_counter() - t > MH_WORKER_TIMEOUT_S:
            raise RuntimeError("multihost worker: the parent never said go")
        time.sleep(0.05)
    out["waited_s"] = time.perf_counter() - t
    for name, fn in (("ring", lambda: mh_ring(torch, mh, local, dev)),
                     ("flagship", lambda: mh_flagship(torch, mh, local, dev, rank,
                                                      Path(out_dir))),
                     ("train", lambda: mh_train(torch, mh, local, dev)),
                     ("mnist", lambda: mh_mnist(torch, mh, local, dev)),
                     ("pipeline", lambda: mh_pipeline(
                         torch, lambda a: mh.global_mesh(a, devices=local), dev, Path(out_dir),
                         rank)),
                     ("moe", lambda: mh_moe(torch, lambda a: mh.global_mesh(a, devices=local),
                                            dev, Path(out_dir), rank))):
        t = time.perf_counter()
        out[name] = fn()
        walls[name] = time.perf_counter() - t
        torch.cuda.empty_cache()
    mh.barrier("10w")
    out["part_walls_s"] = walls
    out["wall_s"] = time.perf_counter() - t0
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def mh_spawn(torch, lay: dict, out_dir: Path, meanwhile):
    """Start the workers through the env contract, each with its own
    timeout, run ``meanwhile()`` while they start, then tell them to go
    on (the ``go`` file) and wait; a worker that fails or times out fails
    the phase (the others are killed).  Returns ``meanwhile``'s answer and
    the workers' results."""
    port = free_port()
    procs = []
    for pid in range(lay["procs"]):
        env = {**os.environ, "SELDON_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "SELDON_NUM_PROCESSES": str(lay["procs"]), "SELDON_PROCESS_ID": str(pid)}
        if lay["visible"] is not None:
            env["CUDA_VISIBLE_DEVICES"] = lay["visible"][pid]
        log_f = open(out_dir / f"rank{pid}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                        "--multihost-worker", str(out_dir)], env=env,
                                       stdout=log_f, stderr=subprocess.STDOUT), log_f))
    deadline = time.perf_counter() + MH_WORKER_TIMEOUT_S
    try:
        early = meanwhile()
        (out_dir / "go").write_text("")
        while any(p.poll() is None for p, _ in procs):
            for pid, (p, _) in enumerate(procs):
                if p.poll() not in (None, 0):  # the others would wait for it
                    tail = (out_dir / f"rank{pid}.log").read_text()[-3000:]
                    raise AssertionError(f"[multihost] worker {pid} exited {p.poll()}:\n{tail}")
            if time.perf_counter() > deadline:
                raise AssertionError(f"[multihost] the workers ran past {MH_WORKER_TIMEOUT_S} s")
            time.sleep(0.2)
        for pid, (p, _) in enumerate(procs):
            if p.returncode != 0:
                tail = (out_dir / f"rank{pid}.log").read_text()[-3000:]
                raise AssertionError(f"[multihost] worker {pid} exited {p.returncode}:\n{tail}")
    finally:
        for p, f in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    return early, [json.loads((out_dir / f"rank{pid}.json").read_text())
                   for pid in range(lay["procs"])]


def mh_faults(torch, dev, smi) -> dict:
    """(e) examples/ensemble4_deployment.json in host mode, its combiner
    given a quorum of 3 and m3 wrapped in the port's
    FaultyNodeRuntime(FaultSpec(error_rate=1.0), seed=7): every answer equals
    the healthy members' combination (the same graph without m3, the same
    weights), bit for bit; the wrapper's calls and injections as seeded;
    fused_mlp launched by the three healthy members only."""
    from seldon_core_tpu_torch.graph.defaulting import default_and_validate
    from seldon_core_tpu_torch.graph.interpreter import GraphExecutor
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.ops import fused_mlp
    from seldon_core_tpu_torch.runtime.engine import EngineService
    from seldon_core_tpu_torch.testing.faults import FaultSpec, FaultyNodeRuntime

    doc = example_doc("ensemble4")
    doc["spec"]["predictors"][0]["graph"]["quorum"] = 3
    healthy = json.loads(json.dumps(doc))
    healthy["spec"]["predictors"][0]["graph"]["children"] = \
        healthy["spec"]["predictors"][0]["graph"]["children"][:3]
    spec = default_and_validate(SeldonDeploymentSpec.from_json_dict(doc))
    executor = GraphExecutor(spec.predictor(), device=dev)
    faulty = FaultyNodeRuntime(executor.runtimes["m3"], FaultSpec(error_rate=1.0), seed=7)
    executor.runtimes["m3"] = faulty
    engine = EngineService(spec, extra_runtimes=executor.runtimes, force_host=True, device=dev)
    ref = EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(healthy)),
                        force_host=True, device=dev)
    ref.load_states({k: v for k, v in engine.states().items() if k != "m3"})
    rng = np.random.default_rng(SEED + 150)
    xs = [rng.random((1, 784)) for _ in range(MH_FAULT_REQUESTS)] + [rng.random((64, 784))]
    try:
        if engine.mode != "host" or ref.mode != "host":
            raise AssertionError(f"[multihost] (e) modes {engine.mode}, {ref.mode}")
        fused_mlp.LAUNCHES = 0
        got = [json.loads(asyncio.run(engine.predict_json(json.dumps(ndarray(x))))[0])
               for x in xs]
        launches = fused_mlp.LAUNCHES
        want = [json.loads(asyncio.run(ref.predict_json(json.dumps(ndarray(x))))[0])
                for x in xs]
    finally:
        engine.close()
        ref.close()
    n = len(xs)
    same = all(np.array_equal(np.asarray(g["data"]["ndarray"]), np.asarray(w["data"]["ndarray"]))
               for g, w in zip(got, want))
    tags = [g["meta"]["tags"].get("seldon.degraded.ensemble") for g in got]
    if (not same or tags != [["m3"]] * n or faulty.calls != {"predict": n}
            or faulty.injected != {"predict": n} or launches != 3 * n):
        raise AssertionError(f"[multihost] (e) ensemble4 with m3 failing: answers equal to the "
                             f"healthy members' {same}, degraded tags {tags}, calls "
                             f"{faulty.calls}, injected {faulty.injected}, fused_mlp launches "
                             f"{launches} (want {3 * n})")
    log(f"[multihost] (e) ensemble4 in host mode, quorum 3, m3 behind "
        f"FaultyNodeRuntime(FaultSpec(error_rate=1.0), seed=7): {n} requests ({n - 1} of 1 row, "
        f"1 of 64) answered 200, bit for bit the healthy three's combination, each tagged "
        f"seldon.degraded.ensemble=['m3']; calls {faulty.calls}, injected {faulty.injected}; "
        f"{launches} fused_mlp launches (3 healthy members x {n}) on {smi}")
    return {"requests": n, "calls": faulty.calls, "injected": faulty.injected,
            "fused_mlp_launches": launches}


def multihost_phase(torch, dev, smi, mesh_walls: dict) -> dict:
    """10w. [6b] part 2: the paths of 10u and 10v over meshes that span
    processes, one process a card (four processes over NCCL on four cards,
    else two sharing cuda:0 over gloo, two shards each), held to this
    process's one-process meshes and to one device, (f) the pipeline over
    pp=4 and (g) MoE experts over ep=4 among them; then (e) the fault
    harness on ensemble4."""
    import shutil
    import tempfile

    from seldon_core_tpu_torch.models.transformer import lm_apply

    t_phase = time.perf_counter()
    lay = mh_layout(torch)
    out_dir = Path(tempfile.mkdtemp(prefix="sct_multihost_"))
    (out_dir / "plan.json").write_text(json.dumps(lay))
    timed = {}

    def references():
        t = time.perf_counter()
        ref = mh_references(torch, dev)
        torch.cuda.empty_cache()
        timed["ref_s"] = time.perf_counter() - t
        return ref

    t = time.perf_counter()
    ref, res = mh_spawn(torch, lay, out_dir, references)
    spawn_s, ref_s = time.perf_counter() - t, timed["ref_s"]
    one, state, prompts = ref.pop("flagship")
    cfg, L, new = one.cfg, GEN_DIMS["n_layers"], MESH_NEW
    backends = sorted({r["backend"] for r in res})
    want_backend = "nccl" if lay["visible"] else "gloo"
    if backends != [want_backend]:
        raise AssertionError(f"[multihost] backends {backends}, want {want_backend}")
    log(f"[multihost] phase 10w: {lay['procs']} processes over {backends[0]}, "
        f"{lay['local']} shard(s) each "
        f"({'a card each, CUDA_VISIBLE_DEVICES=i' if lay['visible'] else 'all on cuda:0'}); "
        f"joined in {[round(r['join_s'], 2) for r in res]} s; one-process references "
        f"{ref_s:.2f} s while the workers started (they waited "
        f"{[round(r['waited_s'], 2) for r in res]} s for them), workers {spawn_s:.2f} s")
    out = {"layout": lay, "backend": backends[0], "worker_walls_s": [r["wall_s"] for r in res],
           "worker_part_walls_s": [r["part_walls_s"] for r in res]}

    # (a) the collectives, then the ring
    got = {k: v for r in res for k, v in r["collectives"].items()}
    differ = sorted(k for k, v in ref["collectives"].items() if got.get(k) != v)
    if differ or len(got) != len(ref["collectives"]):
        raise AssertionError(f"[multihost] (a) collectives differ from the one-process mesh's "
                             f"at {differ[:8]} ({len(got)} answers, want "
                             f"{len(ref['collectives'])})")
    ring = [r["ring"] for r in res]
    launches = {k: sum(x["launches"][k] for x in ring) for k in ("fwd", "dq", "dkv")}
    o_err = max(x["o_err"] for x in ring)
    rel = {n: max(x["grad_diff_max"][n] for x in ring) / max(x["grad_ref_max"][n] for x in ring)
           for n in ("dq", "dk", "dv")}
    want = MH_SHARDS * (MH_SHARDS + 1) // 2
    if launches != {"fwd": want, "dq": want, "dkv": want} or o_err > FLASH_O_ATOL \
            or max(rel.values()) > BWD_REL_TOL:
        raise AssertionError(f"[multihost] (a) the ring over processes: launches {launches} "
                             f"(want {want} of each), o {o_err:.3e} (bound {FLASH_O_ATOL}), "
                             f"gradients {rel} (bound {BWD_REL_TOL})")
    out["collectives"] = len(got)
    out["ring"] = {"launches": launches, "launches_by_process": [x["launches"] for x in ring],
                   "max_abs_err_o": o_err, "bwd_rel_err": rel,
                   "fwd_bwd_wall_p50_ms": ring[0]["fwd_bwd_wall_p50_ms"]}
    log(f"[multihost] (a) {len(got)} collective answers (all_reduce, all_gather, gather_slices, "
        f"ring_shift over sp=4, tp=4 and dp=2 x tp=2 across processes) bit for bit the "
        f"one-process mesh's; the ring over a cross-process sp=4, 4 causal blocks of "
        f"{RING_SHAPE} bf16: launches {launches} ({[x['launches'] for x in ring]} by process), "
        f"o within {o_err:.3e} of the plain ring in f32 (bound {FLASH_O_ATOL}), dq/dk/dv within "
        f"{rel} of their largest element (bound {BWD_REL_TOL}); forward + backward wall p50 "
        f"{out['ring']['fwd_bwd_wall_p50_ms']} (recorded, not claimed) on {smi}")

    # (b) the flagship over a cross-process tp=4
    fl = [r["flagship"] for r in res]
    arrays = [np.load(out_dir / f"rank{r['rank']}_flagship.npz") for r in res]
    lNs, toks = [a["lN"] for a in arrays], [a["toks"] for a in arrays]
    for a in arrays:
        a.close()
    same_bits = all(np.array_equal(x, ref["lN"]) for x in lNs)
    logit_err = float(np.abs(lNs[0] - ref["l1"]).max())
    pre = {k: sum(f["prefill_launches"][k] for f in fl) for k in COUNTED}
    static = {k: sum(f["static_launches"][k] for f in fl) for k in COUNTED}
    want_pre = {"flash_attention": L * MH_SHARDS, "flash_decode": 0, "kv_write": 0,
                "flash_decode_paged": 0, "kv_write_paged": 0}
    want_static = {**want_pre, "flash_decode": L * MH_SHARDS * (new - 1)}
    per_proc = [(f["prefill_launches"]["flash_attention"], f["static_launches"]["flash_decode"])
                for f in fl]
    if (not same_bits or logit_err > MESH_LOGIT_ATOL or pre != want_pre or static != want_static
            or any(a != L * len(f["owned"]) or b != L * len(f["owned"]) * (new - 1)
                   for (a, b), f in zip(per_proc, fl))
            or not all(f["tp_use_flash"] for f in fl)
            or any(not np.array_equal(t, toks[0]) for t in toks)):
        raise AssertionError(f"[multihost] (b) flagship over tp=4 across processes: logits the "
                             f"one-process mesh's bits {same_bits}, {logit_err:.4f} from one "
                             f"device's (bound {MESH_LOGIT_ATOL}); prefill launched {pre} (want "
                             f"{want_pre}), the request {static} (want {want_static}); by "
                             f"process {per_proc}")
    held = check_gaps(torch, lm_apply, state["params"], cfg, [(prompts, toks[0])], dev, 1,
                      "multihost static")
    walls = fl[0]["request_wall_p50_ms"]
    out["flagship"] = {"prefill": {"launches": pre, "bit_identical_to_one_process_mesh": same_bits,
                                   "max_abs_logit_err_vs_one_device": logit_err},
                       "static": {"launches": static, "held": held},
                       "launches_by_process": per_proc,
                       "request_wall_p50_ms": {**walls, "one_process_mesh_10u":
                                               mesh_walls.get("tp4")},
                       "round_us_by_process": [f["round_us"] for f in fl],
                       "build_s": [f["build_s"] for f in fl]}
    log(f"[multihost] (b) flagship over a cross-process tp=4: a {MESH_B}x{MESH_S} prefill "
        f"launched {pre['flash_attention']} flash_attention ({L} x {MH_SHARDS} shards; by process "
        f"{[a for a, _ in per_proc]}), its logits on every process bit for bit the one-process "
        f"mesh's and {logit_err:.4f} from one device's (bound {MESH_LOGIT_ATOL}); the static "
        f"request {static['flash_decode']} flash_decode ({L} x {MH_SHARDS} x {new - 1} steps; by "
        f"process {[b for _, b in per_proc]}), the same tokens on every process; request wall "
        f"p50 {walls['multihost']:.3f} ms across processes against {walls['one']:.3f} ms on one "
        f"device, in turns, and {mesh_walls.get('tp4')} ms on 10u's one-process mesh in the same "
        f"run (recorded, not claimed); a cross-process all_reduce round on a 4-element tensor "
        f"costs {[round(f['round_us'], 1) for f in fl]} us of host time by process, on {smi}")

    # (c) lm_train_step over dp=2 x tp=2 across processes
    tr = [r["train"] for r in res]
    sums: dict = {}
    for r in tr:
        for path, key, dsq, rsq in r["blocks"]:
            sums.setdefault(path, {})[key] = (dsq, rsq)
    grel = {p: float(np.sqrt(sum(d for d, _ in b.values()) / sum(r for _, r in b.values())))
            for p, b in sums.items()}
    worst = max(grel, key=grel.get)
    copies = {}
    for r in tr:
        for path, key, h in r["hashes"]:
            copies.setdefault((path, key), set()).add(h)
    mixed = sorted(k for k, v in copies.items() if len(v) > 1)
    tl = {k: sum(r["launches"][k] for r in tr) for k in ("fwd", "dq", "dkv")}
    per = L * MH_SHARDS
    losses = tr[0]["losses"]
    if (any(r["loss"] != ref["train_loss"] for r in tr) or grel[worst] > TRAIN_GRAD_REL_L2
            or mixed or tl != {k: per * SHARD_STEPS for k in tl}
            or any(r["losses"] != losses for r in tr) or not losses[-1] < losses[0]):
        raise AssertionError(f"[multihost] (c) dp x tp across processes: step 0 losses "
                             f"{[r['loss'] for r in tr]} against the one-process mesh's "
                             f"{ref['train_loss']}; gradients {grel[worst]:.3e} relative L2 at "
                             f"{worst}; copies that differ {mixed[:4]}; launches {tl} (want "
                             f"{per} of each a step); losses {[r['losses'] for r in tr]}")
    out["train"] = {"loss": tr[0]["loss"], "loss_one_process_mesh": ref["train_loss"],
                    "loss_one_device": tr[0]["loss_one_device"], "grad_rel_l2_max": grel[worst],
                    "worst_leaf": worst,
                    "grad_rel_l2_median": float(np.median(list(grel.values()))),
                    "losses": losses, "launches": tl, "launches_a_step": per,
                    "copies_checked": len(copies),
                    "step_wall_p50_ms": tr[0]["step_wall_p50_ms"]}
    log(f"[multihost] (c) lm_train_step over dp=2 x tp=2 across processes (GQA flagship, bf16, "
        f"B={TRAIN_B}, S={TRAIN_HALF * 3 - 1}): step 0 loss {tr[0]['loss']:.6f} on every process, "
        f"bit for bit the one-process mesh's, against {tr[0]['loss_one_device']:.6f} on one "
        f"device; gradients within {grel[worst]:.3e} relative L2 of one device's at {worst} "
        f"(median {out['train']['grad_rel_l2_median']:.3e}; bound {TRAIN_GRAD_REL_L2}); "
        f"{SHARD_STEPS} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}, launches {tl} ({per} of "
        f"each a step: {L} layers x {MH_SHARDS} shards), {len(copies)} blocks' copies "
        f"bit-identical across processes; step wall p50 {tr[0]['step_wall_p50_ms']} "
        f"(recorded, not claimed) on {smi}")

    # (d) MNIST over a cross-process dp=4
    mn = [r["mnist"] for r in res]
    mcopies = {}
    for r in mn:
        for path, key, h in r["hashes"]:
            mcopies.setdefault(path, set()).add(h)
    mg = max(max(r["grad_rel_l2"].values()) for r in mn)
    loss_rel = max(abs(b - a) / a for r in mn for a, b in r["losses"])
    if (mg > TRAIN_GRAD_REL_L2 or loss_rel > TRAIN_LOSS_RTOL
            or any(len(v) > 1 for v in mcopies.values())
            or any(r["max_param_diff"] > r["bound"] for r in mn)):
        raise AssertionError(f"[multihost] (d) MNIST over dp=4 across processes: gradients "
                             f"{mg:.3e}, losses {[r['losses'] for r in mn]}, parameter "
                             f"differences {[r['max_param_diff'] for r in mn]}, copies "
                             f"{ {k: len(v) for k, v in mcopies.items()} }")
    out["mnist"] = {"grad_rel_l2_max": mg, "losses": mn[0]["losses"],
                    "max_param_diff": max(r["max_param_diff"] for r in mn), "bound": mn[0]["bound"]}
    log(f"[multihost] (d) MNIST train_step over a cross-process dp=4: step 0 gradients within "
        f"{mg:.3e} relative L2 of one device's (bound {TRAIN_GRAD_REL_L2}); losses (one device, "
        f"across processes) {mn[0]['losses']}; parameters within "
        f"{out['mnist']['max_param_diff']:.3e} of one device's (bound {mn[0]['bound']:.3e}); "
        f"copies bit-identical across processes")

    # (f) the pipeline over pp=4, (g) MoE experts over ep=4
    new = mh_new_paths(torch, res, ref, out_dir, smi)
    out["pipeline"], out["moe"] = new["pipeline"], new["moe"]

    # (e) the fault harness
    out["faults"] = mh_faults(torch, dev, smi)
    out["launches"] = {"flash_attention": pre["flash_attention"] + static["flash_attention"]
                       + tl["fwd"] + new["launches"]["flash_attention"],
                       "flash_attention_bwd_dq": tl["dq"] + new["launches"]["flash_attention_bwd_dq"],
                       "flash_attention_bwd_dkv": tl["dkv"]
                       + new["launches"]["flash_attention_bwd_dkv"],
                       "flash_decode": static["flash_decode"] + new["launches"]["flash_decode"],
                       "fused_mlp_softmax": out["faults"]["fused_mlp_launches"]}
    out["card"] = smi
    out["wall_s"] = time.perf_counter() - t_phase
    shutil.rmtree(out_dir, ignore_errors=True)
    log(f"[multihost] phase 10w wall {out['wall_s']:.2f} s")
    return out


# ---------------------------------------------------------------------------
# 10x. the gateway: auth, the canary split, replica sets over every lane, the
# SSE relay, its overhead
# ---------------------------------------------------------------------------

GATEWAY_SEED = 7          # the gateway's seed: its predictor draws
GATEWAY_REQUESTS = 400    # 1-row requests of the canary split
GATEWAY_TURN = 50         # requests a side a turn of the overhead (4 turns: 200 a side)
GATEWAY_STREAM = (128, 16, 8)   # prompt tokens, streamed tokens, tokens a frame
GATEWAY_LANES = ("http+json", "http+wire", "uds+wire", "uds+json")
GATEWAY_LANE_REQUESTS = 8   # 1-row requests a lane, and through the two-endpoint set


def canary_picks(seed: int, weights, n: int, skip: int = 0) -> list:
    """The predictor indices a gateway seeded ``seed`` draws for its next
    ``n`` weighted picks after ``skip`` earlier ones: one
    ``default_rng(seed).choice`` a pick (apife.py ``_pick_engine``)."""
    rng = np.random.default_rng(seed)
    p = np.asarray(weights, dtype=np.float64)
    p = p / p.sum()
    return [int(rng.choice(len(p), p=p)) for _ in range(skip + n)][skip:]


class GatewayThread(ServerThread):
    """The port's gateway routes on their own loop and thread; ``call``
    runs a coroutine on that loop."""

    def __init__(self, gateway):
        from seldon_core_tpu_torch.gateway.apife import serve_gateway

        super().__init__(gateway, serve=serve_gateway)

    def call(self, coro, timeout: float = 120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def stop(self, close_engine: bool = False):
        try:
            self.call(self.engine.close(), 30)
        finally:
            super().stop(close_engine=False)


def gateway_post(conn, path: str, body: bytes, headers: dict):
    conn.request("POST", path, body=body, headers=headers)
    r = conn.getresponse()
    return r.status, r.getheader("Content-Type", ""), r.read()


def gateway_token(conn, key: str, secret: str):
    """POST /oauth/token with HTTP Basic credentials: (status, token)."""
    import base64

    basic = base64.b64encode(f"{key}:{secret}".encode()).decode()
    st, _, raw = gateway_post(conn, "/oauth/token", b"", {"Authorization": "Basic " + basic})
    return st, (json.loads(raw)["access_token"] if st == 200 else None)


def start_mnist_engine(dev, name: str, env: dict) -> dict:
    """examples/mnist_deployment.json on an engine_main subprocess with its
    REST port, gRPC port and relay socket; ``env`` is added to its
    environment."""
    port = free_port()
    uds = f"/tmp/smoke-gw-{name}-{os.getpid()}.sock"
    proc = subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.runtime.engine_main", "--file",
         str(ROOT / "examples" / "mnist_deployment.json"), "--device", dev.type,
         "--host", "127.0.0.1", "--rest-port", str(port)], cwd=ROOT,
        env={**os.environ, "ENGINE_SERVER_GRPC_PORT": str(free_port()),
             "ENGINE_UDS_PATH": uds, **env},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return {"proc": proc, "base": f"http://127.0.0.1:{port}", "uds": uds}


def await_engine_up(remote: dict, timeout: float = 300) -> None:
    start = time.perf_counter()
    while True:
        line = remote["proc"].stdout.readline()
        if line.startswith("engine up:"):
            return
        if not line or time.perf_counter() - start > timeout:
            raise AssertionError(f"[gateway] engine_main did not come up: "
                                 f"{line + remote['proc'].stdout.read()[-1500:]}")


def mnist_engine_counts(remote: dict) -> dict:
    """A remote engine's fused-MLP launches, its REST and relay predicts,
    and the binary-wire predicts among them, from its /stats."""
    d = json.loads(request("GET", remote["base"] + "/stats")[1])
    t = d["telemetry"]
    wire = t["wire"]["requests"]
    return {"launches": d["kernels"]["fused_mlp_softmax"]["launches"],
            "rest": t["replicas"]["lanes"].get("rest", 0),
            "relay": t["replicas"]["lanes"].get("relay", 0),
            "rest_binary": wire.get("fast/binary", 0),
            "relay_binary": wire.get("relay/binary", 0)}


def gateway_phase(torch, dev, smi) -> dict:
    """10x. The port's gateway in front of engines on the card (see the
    module docstring).  Returns the counts of the served paths and what
    was measured."""
    from seldon_core_tpu_torch import protoconv
    from seldon_core_tpu_torch.gateway.apife import ApiGateway, DeploymentStore
    from seldon_core_tpu_torch.graph.defaulting import default_and_validate
    from seldon_core_tpu_torch.graph.spec import SeldonDeploymentSpec
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.ops import flash_decode as fd, fused_mlp, kv_write as kw
    from seldon_core_tpu_torch.runtime.engine import EngineService
    from seldon_core_tpu_torch.runtime.grpcfast import FastGrpcChannel, FastGrpcServer

    t_phase = time.perf_counter()
    counted = dev.type == "cuda"
    out = {"launches": {}}
    # (b)'s engine_mains come up while (a) runs: one with the binary wire,
    # one with it switched off (it answers the wire with 415, and the
    # gateway falls back to JSON on its REST and relay lanes)
    remotes = {"wire": start_mnist_engine(dev, "wire", {}),
               "json": start_mnist_engine(dev, "json", {"SELDON_TPU_WIRE": "0"})}
    gw_thread = engines = twin = gen = None
    try:
        # -- (a) the canary, in process ---------------------------------------
        doc = json.loads((ROOT / "examples" / "canary_deployment.json").read_text())
        spec = default_and_validate(SeldonDeploymentSpec.from_json_dict(doc))
        engines = {p.name: EngineService(spec, p.name, device=dev) for p in spec.predictors}
        if any(e.device.type != dev.type for e in engines.values()):
            raise AssertionError("[gateway] an in-process engine is not on the card")
        # the kernel at the canary's width, before the counted traffic
        state = engines["canary"].states()["mnist"]
        gen_x = torch.Generator(device="cpu").manual_seed(SEED)
        mlp_err = {}
        for B in (1, 8, 64):
            x = torch.rand((B, 784), generator=gen_x).to(dev)
            got = fused_mlp.fused_mlp_softmax(state, x)
            want = fused_mlp.fused_mlp_softmax_reference(state, x)
            mlp_err[B] = float((got - want).abs().max())
        if max(mlp_err.values()) > KERNEL_ATOL:
            raise AssertionError(f"[gateway] fused_mlp at 784-512-512-10 vs plain {mlp_err}")
        store = DeploymentStore()
        store.register(spec, engines)
        main_only = SeldonDeploymentSpec.from_json_dict({"spec": {
            **doc["spec"], "name": "canary-main", "oauth_key": "main-key",
            "oauth_secret": "main-secret", "predictors": [doc["spec"]["predictors"][0]]}})
        store.register(main_only, {"main": engines["main"]})
        gateway = ApiGateway(store=store, seed=GATEWAY_SEED)
        gw_thread = GatewayThread(gateway)
        gw_port = gw_thread.start()
        conn = http.client.HTTPConnection("127.0.0.1", gw_port, timeout=120)
        st_bad, _ = gateway_token(conn, "canary-key", "nope")
        st_tok, token = gateway_token(conn, "canary-key", "canary-secret")
        hdr = {"Content-Type": "application/json", "Authorization": "Bearer " + token}
        rng = np.random.default_rng(SEED + 28)
        xs = rng.random((GATEWAY_REQUESTS, 784))
        body = lambda x: json.dumps({"data": {"ndarray": np.atleast_2d(x).tolist()}}).encode()
        st_noauth, _, _ = gateway_post(conn, "/api/v0.1/predictions", body(xs[0]),
                                       {"Content-Type": "application/json"})
        if (st_bad, st_tok, st_noauth) != (401, 200, 401):
            raise AssertionError(f"[gateway] token flow {(st_bad, st_tok, st_noauth)}")
        fused_mlp.LAUNCHES = 0
        served, answers = [], []
        for x in xs:
            st, _, raw = gateway_post(conn, "/api/v0.1/predictions", body(x), hdr)
            d = json.loads(raw)
            if st != 200 or set(d["meta"]) < {"puid", "requestPath"}:
                raise AssertionError(f"[gateway] predict answered {st}: {raw[:300]!r}")
            served.append(d["meta"]["requestPath"]["predictor"])
            answers.append(np.asarray(d["data"]["ndarray"], dtype=np.float64))
        n_canary = fused_mlp.LAUNCHES
        names = [name for name, _w, _e in store._by_key["canary-key"].engines]
        weights = [w for _n, w, _e in store._by_key["canary-key"].engines]
        want = [names[i] for i in canary_picks(GATEWAY_SEED, weights, GATEWAY_REQUESTS)]
        split = {n: served.count(n) for n in names}
        if served != want or (counted and n_canary != GATEWAY_REQUESTS):
            raise AssertionError(f"[gateway] split {split}, the seed's {want.count('main')}/"
                                 f"{want.count('canary')}; {n_canary} fused-MLP launches for "
                                 f"{GATEWAY_REQUESTS} dispatches")
        # every answer the serving engine's own, bit for bit (these direct
        # calls' launches are not the path's: (d) counts from 0 again)
        for x, pred, y in zip(xs, served, answers):
            resp = gw_thread.call(engines[pred].predict(SeldonMessage.from_array(
                np.atleast_2d(x))))
            if not np.array_equal(np.asarray(resp.array(), dtype=np.float64), y):
                raise AssertionError(f"[gateway] a {pred} answer through the gateway differs "
                                     f"from the engine's direct answer")
        out["canary"] = {"split": split, "split_of_seed": {n: want.count(n) for n in names},
                         "fused_mlp_launches": n_canary, "kernel_vs_plain_784_512": mlp_err}
        out["launches"]["fused_mlp_softmax"] = n_canary
        log(f"[gateway] canary: 401 without a token, 200 with one; {GATEWAY_REQUESTS} 1-row "
            f"requests split {split} (the seed {GATEWAY_SEED}'s draws exactly, the CPU test's "
            f"rule), every answer the serving engine's direct answer bit for bit, "
            f"{n_canary} fused-MLP launches (one a dispatch); the kernel at 784-512-512-10 vs "
            f"plain {max(mlp_err.values()):.2e} at B = 1, 8, 64 (tolerance {KERNEL_ATOL})")

        # -- (b) remote engine_mains behind the gateway, every lane ------------
        # one deployment a lane, each one endpoint; one whose replica set
        # holds the wire engine's REST and relay endpoints (the p2c pick)
        for r in remotes.values():
            await_engine_up(r)
        W, J = remotes["wire"], remotes["json"]
        mdoc = json.loads((ROOT / "examples" / "mnist_deployment.json").read_text())
        targets = {"http+json": [J["base"]], "http+wire": [W["base"]],
                   "uds+wire": [f"uds:{W['uds']}"], "uds+json": [f"uds:{J['uds']}"],
                   "set": [W["base"], f"uds:{W['uds']}"]}
        mtok = {}
        for lane, t in targets.items():
            store.register(default_and_validate(SeldonDeploymentSpec.from_json_dict({"spec": {
                **mdoc["spec"], "name": f"mnist-{lane}", "oauth_key": f"mnist-{lane}",
                "oauth_secret": "mnist-secret"}})), {"main": t})
            st, mtok[lane] = gateway_token(conn, f"mnist-{lane}", "mnist-secret")
            if st != 200:
                raise AssertionError(f"[gateway] no token for mnist-{lane}: {st}")
        twin = EngineService(default_and_validate(SeldonDeploymentSpec.from_json_dict(mdoc)),
                             device=dev)
        before = {k: mnist_engine_counts(r) for k, r in remotes.items()}
        xr = rng.random((GATEWAY_LANE_REQUESTS, 784))
        twin_y = [np.asarray(gw_thread.call(twin.predict(SeldonMessage.from_array(
            xr[i:i + 1]))).array(), dtype=np.float64) for i in range(len(xr))]
        lane_err = {}
        for lane in (*GATEWAY_LANES, "set"):
            h = {"Content-Type": "application/json", "Authorization": "Bearer " + mtok[lane]}
            for x, want_y in zip(xr, twin_y):
                st, _, raw = gateway_post(conn, "/api/v0.1/predictions", body(x), h)
                if st != 200:
                    raise AssertionError(f"[gateway] {lane} answered {st}: {raw[:300]!r}")
                got_y = np.asarray(SeldonMessage.from_json(raw.decode()).array(),
                                   dtype=np.float64)
                lane_err[lane] = max(lane_err.get(lane, 0.0),
                                     float(np.abs(got_y - want_y).max()))
        # one gRPC Predict through the gateway's front, to the replica set
        grpc = FastGrpcServer.for_gateway(gateway)
        gw_thread.call(grpc.start("127.0.0.1", 0))

        async def grpc_predict():
            ch = await FastGrpcChannel().connect("127.0.0.1", grpc.port)
            try:
                return await ch.call(b"/seldon.protos.Seldon/Predict",
                                     protoconv.msg_to_proto(SeldonMessage.from_array(xr[:1])),
                                     ((b"authorization", f"Bearer {mtok['set']}".encode()),))
            finally:
                ch.close_nowait()

        g_resp = protoconv.msg_from_proto(gw_thread.call(grpc_predict()))
        gw_thread.call(grpc.stop())
        lane_err["grpc"] = float(np.abs(np.asarray(g_resp.array(), np.float64)
                                        - twin_y[0]).max())
        # the card's kernel gives a row the same bits in every process; the
        # CPU's plain version (a rehearsal) sums in its threads' order
        if max(lane_err.values()) > (0.0 if counted else 1e-6):
            raise AssertionError(f"[gateway] remote lanes vs the in-process twin {lane_err}")
        after = {k: mnist_engine_counts(r) for k, r in remotes.items()}
        moved = {k: {c: after[k][c] - before[k][c] for c in after[k]} for k in remotes}
        gstats = json.loads(request("GET", f"http://127.0.0.1:{gw_port}/stats")[1])
        set_eps = gstats["replicas"]["mnist-set/main"]["endpoints"]
        picks = {("rest" if ep["uds_path"] is None else "uds"): ep["picks"] for ep in set_eps}
        n = GATEWAY_LANE_REQUESTS
        # each lane reached the engine it names, in the format it names: the
        # wire engine took every binary predict (its REST ones the http+wire
        # lane's and the set's REST picks, its relay ones the uds+wire lane's
        # and the set's relay picks); the other answered JSON only
        want_moved = {"wire": {"launches": 3 * n + 1, "rest_binary": n + picks.get("rest", 0),
                               "relay_binary": n + picks.get("uds", 0)},
                      "json": {"launches": 2 * n, "rest_binary": 0, "relay_binary": 0}}
        got_moved = {k: {c: moved[k][c] for c in want_moved[k]} for k in remotes}
        if (min(picks.get("rest", 0), picks.get("uds", 0)) < 1
                or sum(picks.values()) != n + 1
                or (counted and got_moved != want_moved)
                or min(moved["json"]["rest"], moved["json"]["relay"]) < n):
            raise AssertionError(f"[gateway] lanes reached {moved}, set picks {picks}; "
                                 f"wanted {want_moved}")
        n_remote = moved["wire"]["launches"] + moved["json"]["launches"]
        out["remote"] = {"lanes_vs_twin": lane_err, "launches": n_remote,
                         "engines_moved": moved, "set_picks": picks,
                         "grpc_predictor": g_resp.meta.requestPath.get("predictor")}
        out["launches"]["fused_mlp_softmax remote"] = n_remote
        log(f"[gateway] two remote engine_mains (one with the binary wire off) behind the "
            f"gateway's predictions route with a bearer token: {n} 1-row requests a lane over "
            f"{', '.join(GATEWAY_LANES)} and through a replica set of the wire engine's REST "
            f"and uds: endpoints (p2c picks {picks}), and one gRPC Predict through the "
            f"gateway's front to that set: every answer the in-process twin's bit for bit "
            f"({lane_err}); the engines' /stats moved {moved}: {n_remote} launches")

        # -- (c) the flagship generator's stream through the gateway ------------
        gen = mode_engine(torch, dev, gen_deployment(), continuous=True)
        gspec = default_and_validate(SeldonDeploymentSpec.from_json_dict(
            {"spec": {**gen_deployment()["spec"], "oauth_key": "gen-key",
                      "oauth_secret": "gen-secret"}}))
        store.register(gspec, {"main": gen})
        g = gen.genserver
        cfg = gen.compiled.units["gen"].cfg
        S, NEW, CH = GATEWAY_STREAM
        prompt = rng.integers(0, GEN_DIMS["vocab"], size=(1, S))
        sbody = {"data": {"ndarray": prompt.tolist()}, "chunk": CH, "max_new": NEW}
        gtok = store.issue_token("gen-key", "gen-secret")

        async def direct_stream():
            toks = []
            async for ev in gen.generate_stream(gen.prepare_stream_request(json.dumps(sbody))):
                d = json.loads(ev)
                if "tokens" in d:
                    toks.append(np.asarray(d["tokens"]))
            return np.concatenate(toks, axis=1)

        want_toks = gw_thread.call(direct_stream())
        fd.PAGED_LAUNCHES = kw.PAGED_LAUNCHES = fd.LAUNCHES = kw.LAUNCHES = 0
        snap0 = g.snapshot()
        events = gateway_sse(gw_port, sbody, gtok)
        snap1 = g.snapshot()
        stream_launches = {"flash_decode_paged": fd.PAGED_LAUNCHES,
                           "kv_write_paged": kw.PAGED_LAUNCHES}
        steps = snap1["decode_steps_total"] - snap0["decode_steps_total"]
        ticks = snap1["prefill_dispatches_total"] - snap0["prefill_dispatches_total"]
        got_toks = np.concatenate([np.asarray(e["tokens"]) for e in events if "tokens" in e],
                                  axis=1)
        if not events or events[-1].get("done") is not True or "error" in events[-1]:
            raise AssertionError(f"[gateway] the stream did not end cleanly: {events[-1:]}")
        if got_toks.shape != (1, NEW) or not np.array_equal(got_toks, want_toks):
            raise AssertionError(f"[gateway] streamed tokens {got_toks.shape} differ from the "
                                 f"engine's direct stream")
        want_l = {"flash_decode_paged": cfg.n_layers * steps,
                  "kv_write_paged": cfg.n_layers * ticks}
        if counted and (stream_launches != want_l or steps == 0 or ticks == 0):
            raise AssertionError(f"[gateway] stream launches {stream_launches}, not {want_l}")
        out["stream"] = {"tokens": NEW, "decode_steps": steps, "prefill_ticks": ticks,
                         "launches": stream_launches}
        out["launches"].update(stream_launches)
        log(f"[gateway] a 1-row {S}-token prompt streamed through /api/v0.1/generate/stream "
            f"for {NEW} tokens: the engine's direct stream's tokens; {steps} decode steps and "
            f"{ticks} prefill ticks launched {stream_launches} ({cfg.n_layers} a step and a "
            f"tick)")

        # -- (d) the gateway's overhead, in turns --------------------------------
        # the engine's own REST lane: a second engine of the same predictor
        # (one engine serves one event loop), built before the counts reset
        direct = ServerThread(EngineService(spec, "main", device=dev))
        d_port = direct.start()
        _, mtok2 = gateway_token(conn, "main-key", "main-secret")
        dconn = http.client.HTTPConnection("127.0.0.1", d_port, timeout=120)
        ghdr = {"Content-Type": "application/json", "Authorization": "Bearer " + mtok2}
        x1 = body(xs[0])
        walls = {"gateway": [], "engine": []}
        # each arm's launches counted from 0 just before its requests
        n_turns = {"gateway": 0, "engine": 0}
        try:
            for turn in range(4):
                for arm in (("gateway", "engine") if turn % 2 == 0 else ("engine", "gateway")):
                    c, h = (conn, ghdr) if arm == "gateway" else (
                        dconn, {"Content-Type": "application/json"})
                    fused_mlp.LAUNCHES = 0
                    for _ in range(GATEWAY_TURN):
                        t0 = time.perf_counter()
                        st, _, _ = gateway_post(c, "/api/v0.1/predictions", x1, h)
                        walls[arm].append(time.perf_counter() - t0)
                        if st != 200:
                            raise AssertionError(f"[gateway] {arm} answered {st}")
                    n_turns[arm] += fused_mlp.LAUNCHES
        finally:
            direct.stop()
        if counted and n_turns != {"gateway": 4 * GATEWAY_TURN, "engine": 4 * GATEWAY_TURN}:
            raise AssertionError(f"[gateway] launches in the overhead turns {n_turns}")
        p50 = {k: float(np.percentile(np.asarray(v) * 1e3, 50)) for k, v in walls.items()}
        out["overhead"] = {"gateway_p50_ms": p50["gateway"], "engine_p50_ms": p50["engine"],
                           "overhead_p50_ms": p50["gateway"] - p50["engine"],
                           "requests_a_side": len(walls["gateway"]), "card": smi}
        out["launches"]["fused_mlp_softmax"] += n_turns["gateway"]
        out["launches"]["fused_mlp_softmax direct"] = n_turns["engine"]
        log(f"[gateway] overhead: 1-row p50 through the gateway {p50['gateway']:.3f} ms, the "
            f"engine's own REST lane {p50['engine']:.3f} ms, {len(walls['gateway'])} requests "
            f"a side in 4 turns: the gateway adds {p50['gateway'] - p50['engine']:.3f} ms "
            f"({smi})")
    finally:
        if gw_thread is not None:
            gw_thread.stop()
        for e in [*(engines or {}).values(), twin, gen]:
            if e is not None:
                e.close()
        out_text = ""
        for r in remotes.values():
            out_text += stop_service(r["proc"])[-300:]
            try:
                os.unlink(r["uds"])
            except FileNotFoundError:
                pass
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[gateway] phase 10x wall {out['wall_s']:.2f} s")
    if out["wall_s"] > 40.0:
        log(f"[gateway] the phase took longer than its 40 s wall ({out_text[-300:]!r})")
    return out


def gateway_sse(port: int, body: dict, token: str) -> list:
    """POST the stream route of the gateway with a bearer token; the
    parsed events of its chunked 200."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/api/v0.1/generate/stream", body=json.dumps(body).encode(),
                     headers={"Content-Type": "application/json",
                              "Authorization": "Bearer " + token})
        r = conn.getresponse()
        raw = r.read()
        if r.status != 200 or not r.getheader("Content-Type", "").startswith(
                "text/event-stream"):
            raise AssertionError(f"[gateway] the stream answered {r.status}: {raw[:300]!r}")
    finally:
        conn.close()
    return [json.loads(ev[len(b"data: "):]) for ev in raw.split(b"\n\n")
            if ev.startswith(b"data: ")]



# ---------------------------------------------------------------------------
# 10y. the operator's local half: materializer, rollout and rollback, replay
# vet, reconciler, a spawned unit, the load rig
# ---------------------------------------------------------------------------

OPERATOR_SEED = 29        # the gateway's seed: its predictor draws
OPERATOR_REQUESTS = 80    # 1-row N(0, 1) requests of the canary split
OPERATOR_ROUND = 24       # 1-row N(3, 1) requests a rollout round
OPERATOR_ROUNDS = 6       # rounds before the rollback must have come
OPERATOR_UNIT_REQUESTS = 8
OPERATOR_LOAD = (16, 3.0, 0.5)   # loadgen clients, seconds, warm-up seconds
OPERATOR_MLP_ATOL = 1e-4  # the kernel against its plain version, probabilities


def _sync_call(fn, *args):
    """A coroutine that runs ``fn(*args)`` on the loop it is awaited on."""
    async def run():
        return fn(*args)
    return run()


def operator_phase(torch, dev, smi) -> dict:
    """10y. The operator's local half on the card (see the module docstring).
    Returns the launches of each path and what was measured."""
    import shutil
    import tempfile

    from seldon_core_tpu_torch.gateway.apife import ApiGateway
    from seldon_core_tpu_torch.gateway.firehose import Firehose
    from seldon_core_tpu_torch.graph.spec import Parameter, SeldonDeploymentSpec
    from seldon_core_tpu_torch.messages import SeldonMessage
    from seldon_core_tpu_torch.native import _build as native_build
    from seldon_core_tpu_torch.operator.materializer import Materializer
    from seldon_core_tpu_torch.operator.reconciler import FakeKubeApi, Reconciler, _config_hash
    from seldon_core_tpu_torch.operator.rollouts import (GatewaySignals, RolloutController,
                                                         RolloutGates, RolloutPlan,
                                                         plan_from_annotations)
    from seldon_core_tpu_torch.operator.scaleahead import ScaleAheadPlanner
    from seldon_core_tpu_torch.ops import fused_mlp
    from seldon_core_tpu_torch.runtime.engine import EngineService
    from seldon_core_tpu_torch.runtime.microservice import build_runtime
    from seldon_core_tpu_torch.runtime.replay import load_firehose_events, replay_events, replay_file
    from seldon_core_tpu_torch.testing.contract import Contract
    from seldon_core_tpu_torch.testing.loadtest import run_load_native
    from seldon_core_tpu_torch.utils.perf import OBSERVATORY
    from seldon_core_tpu_torch.utils.quality import QUALITY

    t_phase = time.perf_counter()
    counted = dev.type == "cuda"
    out = {"launches": {}, "card": smi}
    # the observatories as a process starts them (10q leaves the spine and
    # the perf observatory off, 10p a reference window of its own): the
    # drift gate reads the quality folds of the dispatch records, (c) the
    # observatory's dispatch count; tracing stays off
    from seldon_core_tpu_torch.runtime.autopilot import reset_learned_singletons
    from seldon_core_tpu_torch.utils.hotrecord import SPINE
    from seldon_core_tpu_torch.utils.tracing import TRACER

    SPINE.telemetry_enabled = OBSERVATORY.enabled = QUALITY.enabled = True
    TRACER.enabled = False
    QUALITY.sample, QUALITY.ref_target = 1.0, 256
    SPINE.drain()
    QUALITY.reset()
    reset_learned_singletons()
    tmp = Path(tempfile.mkdtemp(prefix="smoke-operator-"))
    # the load rig's generator builds while (a)-(f) run
    loadgen = ThreadPoolExecutor(1).submit(native_build.build, "loadgen")
    mat = gw_thread = direct = twin = None
    try:
        # -- (a) materialize the canary from a spec directory ------------------
        spec_dir = tmp / "specs"
        spec_dir.mkdir()
        doc = json.loads((ROOT / "examples" / "canary_deployment.json").read_text())
        (spec_dir / "canary.json").write_text(json.dumps(doc))
        mat = Materializer(device=dev)
        fh = Firehose(base_dir=str(tmp / "firehose"))
        gateway = ApiGateway(store=mat.store, firehose=fh, seed=OPERATOR_SEED)
        gw_thread = GatewayThread(gateway)
        gw_port = gw_thread.start()
        # the engines are built on the gateway's loop, which serves them
        gw_thread.call(mat.watch_dir(str(spec_dir), once=True), 300)
        status = json.loads((spec_dir / "canary.json.status").read_text())
        engines = mat.deployments["mnist-canary"].engines
        reg = mat.store._by_key["canary-key"]
        if (status["state"] != "Available" or set(engines) != {"main", "canary"}
                or any(e.device.type != dev.type for e in engines.values())
                or {n: e for n, _w, e in reg.engines} != engines):
            raise AssertionError(f"[operator] materialized {status}, engines {sorted(engines)}")
        # the kernel at the main predictor's width, before the counted traffic
        state = engines["main"].states()["mnist"]
        gen_x = torch.Generator(device="cpu").manual_seed(SEED + 29)
        mlp_err = {}
        for B in (1, 8, 64):
            x = torch.rand((B, 784), generator=gen_x).to(dev)
            got = fused_mlp.fused_mlp_softmax(state, x)
            want = fused_mlp.fused_mlp_softmax_reference(state, x)
            mlp_err[B] = float((got - want).abs().max())
        if max(mlp_err.values()) > OPERATOR_MLP_ATOL:
            raise AssertionError(f"[operator] fused_mlp at 784-256-256-10 vs plain {mlp_err}")
        out["materialize"] = {"status": status["state"], "engines": sorted(engines),
                              "kernel_vs_plain_784_256": mlp_err}
        log(f"[operator] (a) the materializer applied examples/canary_deployment.json from a "
            f"spec directory: engines {sorted(engines)} on {dev.type}, registered, status "
            f"{status['state']}; fused_mlp at 784-256-256-10 vs plain "
            f"{max(mlp_err.values()):.2e} at B = 1, 8, 64 (tolerance {OPERATOR_MLP_ATOL})")

        # -- (b) canary traffic through the gateway, firehose on ---------------
        gw_thread.call(_sync_call(fh.start))
        conn = http.client.HTTPConnection("127.0.0.1", gw_port, timeout=120)
        st, token = gateway_token(conn, "canary-key", "canary-secret")
        if st != 200:
            raise AssertionError(f"[operator] token {st}")
        hdr = {"Content-Type": "application/json", "Authorization": "Bearer " + token}
        rng = np.random.default_rng(SEED + 29)
        body = lambda x: json.dumps({"data": {"ndarray": np.atleast_2d(x).tolist()}}).encode()

        def drive(xs):
            """POST each row; (served predictors, answers, failures)."""
            served, answers, failed = [], [], []
            for x in xs:
                st, _, raw = gateway_post(conn, "/api/v0.1/predictions", body(x), hdr)
                d = json.loads(raw)
                if st != 200 or (d.get("status") or {}).get("status") == "FAILURE":
                    failed.append((st, raw[:200]))
                    continue
                served.append(d["meta"]["requestPath"]["predictor"])
                answers.append(np.asarray(d["data"]["ndarray"], dtype=np.float64))
            return served, answers, failed

        xs = rng.normal(0.0, 1.0, (OPERATOR_REQUESTS, 784))
        fused_mlp.LAUNCHES = 0
        served, answers, failed = drive(xs)
        n_canary = fused_mlp.LAUNCHES
        names = [n for n, _w, _e in reg.engines]
        weights = [w for _n, w, _e in reg.engines]
        want = [names[i] for i in canary_picks(OPERATOR_SEED, weights, OPERATOR_REQUESTS)]
        split = {n: served.count(n) for n in names}
        if failed or served != want or (counted and n_canary != OPERATOR_REQUESTS):
            raise AssertionError(f"[operator] split {split} (failed {failed[:2]}), the seed's "
                                 f"{ {n: want.count(n) for n in names} }; {n_canary} launches")
        for x, pred, y in zip(xs, served, answers):
            resp = gw_thread.call(engines[pred].predict(SeldonMessage.from_array(
                np.atleast_2d(x))))
            if np.abs(np.asarray(resp.array(), dtype=np.float64) - y).max() > (
                    0.0 if counted else 1e-6):
                raise AssertionError(f"[operator] a {pred} answer through the gateway differs "
                                     f"from the engine's direct answer")
        QUALITY.reference_control("freeze")
        out["canary"] = {"split": split, "fused_mlp_launches": n_canary}
        out["launches"]["canary"] = n_canary
        log(f"[operator] (b) {OPERATOR_REQUESTS} 1-row N(0,1) requests with a token: split "
            f"{split}, the seed {OPERATOR_SEED}'s draws; every answer the serving engine's "
            f"direct answer bit for bit; {n_canary} fused-MLP launches; drift reference frozen")

        # -- (c) replay vet of the flushed firehose ------------------------------
        gw_thread.call(fh.stop())
        log_path = str(tmp / "firehose" / "mnist-canary.jsonl")
        main_lines = [e for e in load_firehose_events(log_path)
                      if e["response"]["meta"]["requestPath"]["predictor"] == "main"]
        verdicts = {}
        for name, run in (("main", lambda: replay_events(main_lines, engines["main"])),
                          ("canary", lambda: replay_file(log_path, engines["canary"]))):
            fused_mlp.LAUNCHES = 0
            d0 = OBSERVATORY.snapshot()["dispatches"]
            v = gw_thread.call(run())
            v["launches"] = fused_mlp.LAUNCHES
            v["dispatches"] = OBSERVATORY.snapshot()["dispatches"] - d0
            verdicts[name] = v
        vm, vc = verdicts["main"], verdicts["canary"]
        if (vm["verdict"] != "pass" or vm["disagreement"]["mean"] != 0.0
                or vc["verdict"] != "fail" or vm["counts"]["replayed"] != split["main"]
                or vc["counts"]["replayed"] != OPERATOR_REQUESTS
                or (counted and any(v["launches"] != v["dispatches"] or not v["launches"]
                                    for v in verdicts.values()))):
            raise AssertionError(f"[operator] replay {json.dumps(verdicts)[:1500]}")
        out["replay"] = {k: {"verdict": v["verdict"], "reasons": v["reasons"],
                             "disagreement_mean": v["disagreement"]["mean"],
                             "replayed": v["counts"]["replayed"], "launches": v["launches"],
                             "dispatches": v["dispatches"]} for k, v in verdicts.items()}
        out["launches"]["replay"] = vm["launches"] + vc["launches"]
        for k, v in verdicts.items():
            log(f"[operator] (c) replay against {k}: {v['verdict']} {v['reasons']}, "
                f"{v['counts']['replayed']} lines, disagreement mean "
                f"{v['disagreement']['mean']}, {v['launches']} launches for "
                f"{v['dispatches']} dispatches")

        # -- (d) staged rollout, rollback on drift -------------------------------
        gw_thread.call(_sync_call(fh.start))
        ctrl = RolloutController(mat.store, GatewaySignals(gateway), firehose=fh)
        gateway.rollouts = ctrl
        plan = RolloutPlan("mnist-canary", "canary", "main", stages=(5, 25, 100), hold_s=0.0,
                           config_hash="smoke-v2",
                           gates=RolloutGates(max_drift=0.25, max_shadow_disagreement=None,
                                              min_requests=4))
        ctrl.apply(plan)
        fused_mlp.LAUNCHES = 0
        decisions = [gw_thread.call(_sync_call(ctrl.tick))[0]]
        if decisions[0]["decision"] != "advance":
            raise AssertionError(f"[operator] the first tick {decisions[0]}")
        rounds = 0
        for rounds in range(1, OPERATOR_ROUNDS + 1):
            _, _, failed = drive(rng.normal(3.0, 1.0, (OPERATOR_ROUND, 784)))
            if failed:
                raise AssertionError(f"[operator] live requests failed mid-rollout {failed[:2]}")
            ticked = gw_thread.call(_sync_call(ctrl.tick))
            decisions += ticked
            if ticked and ticked[0]["decision"] == "rollback":
                break
        n_rollout = fused_mlp.LAUNCHES
        last = decisions[-1]
        split_after = {n: w for n, w, _e in mat.store._by_key["canary-key"].engines}
        doc_http = json.loads(request("GET", f"http://127.0.0.1:{gw_port}/rollouts")[1])
        prom = request("GET", f"http://127.0.0.1:{gw_port}/prometheus")[1]
        prom = prom.decode() if isinstance(prom, bytes) else prom
        gw_thread.call(fh.stop())
        fire = [json.loads(x) for x in open(log_path) if x.strip()]
        if (last["decision"] != "rollback" or last.get("reason") != "drift"
                or split_after != {"main": 100, "canary": 0}
                or doc_http != json.loads(json.dumps(ctrl.document()))
                or 'seldon_tpu_rollbacks_total{reason="drift"}' not in prom
                or not any(e.get("event") == "rollback" for e in fire)
                or (counted and n_rollout != OPERATOR_ROUND * rounds)):
            raise AssertionError(f"[operator] rollout {[d['decision'] for d in decisions]} "
                                 f"{last}, split {split_after}, {n_rollout} launches")
        out["rollout"] = {"decisions": [(d["decision"], d.get("reason"), d["stage_percent"])
                                        for d in decisions],
                          "rounds": rounds, "observed_drift": last.get("observed"),
                          "split_after": split_after, "launches": n_rollout}
        out["launches"]["rollout"] = n_rollout
        log(f"[operator] (d) staged rollout (5, 25, 100): "
            f"{[d['decision'] for d in decisions]}; rollback on drift "
            f"({last.get('observed')}) after round {rounds} of {OPERATOR_ROUND} N(3,1) "
            f"requests, split {split_after}; GET /rollouts is the controller's document; "
            f"seldon_tpu_rollbacks_total{{reason=\"drift\"}} on /prometheus; a rollback event "
            f"in the firehose; no live request failed; {n_rollout} launches")

        # -- (e) the reconciler over the canary CR ----------------------------------
        cr = json.loads(json.dumps(doc))
        cr["metadata"] = {"name": "mnist-canary", "namespace": "default"}
        cr["spec"]["annotations"] = {
            "seldon.io/canary": "canary", "seldon.io/canary-max-drift": "none",
            "seldon.io/canary-hold-s": "600", "seldon.io/autoscale": "true",
            "seldon.io/autoscale-max": "4"}
        api = FakeKubeApi()
        api.create(cr)
        rec = Reconciler(api, rollouts=ctrl, autoscaler=ScaleAheadPlanner())
        # the controller holds the CR's plan before the first pass: a pass
        # reads the rollout's state for the autoscale gate before it ticks
        # the rollout (the reference's order), so a plan new to the
        # controller would flip the gate, and the status, on the next pass
        ctrl.apply(plan_from_annotations(SeldonDeploymentSpec.from_json_dict(cr),
                                         _config_hash({"spec": cr["spec"]})))
        api.clear_ops()
        first = gw_thread.call(_sync_call(rec.run_once))["mnist-canary"]
        writes1 = len(api.ops)
        api.clear_ops()
        second = gw_thread.call(_sync_call(rec.run_once))["mnist-canary"]
        writes2 = list(api.ops)
        cr_status = api.get("SeldonDeployment", "default", "mnist-canary")["status"]
        gpus = sorted({c["resources"]["limits"].get("nvidia.com/gpu")
                       for (k, _ns, _n), o in api.objects.items() if k == "Deployment"
                       for c in o["spec"]["template"]["spec"]["containers"]})
        if (first.get("failed") or writes2 or gpus != ["1"]
                or not {"rollout", "autoscale"} <= set(cr_status)):
            raise AssertionError(f"[operator] reconciler {first} {second}, second pass "
                                 f"{writes2}, gpus {gpus}, status {sorted(cr_status)}")
        out["reconciler"] = {"first_pass": first, "first_writes": writes1,
                             "second_pass_writes": 0, "rollout": cr_status["rollout"]["state"],
                             "autoscale": cr_status["autoscale"]["decisions"][0]["reason"]}
        log(f"[operator] (e) the reconciler over the annotated canary CR: first pass {first} "
            f"({writes1} writes), engine Deployments ask nvidia.com/gpu {gpus}, status "
            f"rollout {cr_status['rollout']['state']} and autoscale "
            f"'{cr_status['autoscale']['decisions'][0]['reason']}'; second pass 0 writes")

        # -- (f) a spawned unit on the card ------------------------------------------
        unit_port = free_port()
        unit_doc = {"spec": {"name": "mnist-unit", "oauth_key": "unit-key",
                             "oauth_secret": "unit-secret", "predictors": [{
                                 "name": "p", "graph": {"name": "m", "type": "MODEL"},
                                 "components": [{
                                     "name": "m", "runtime": "rest",
                                     "class_path": "MnistClassifier", "port": unit_port,
                                     "parameters": [
                                         {"name": "hidden", "value": "512", "type": "INT"},
                                         {"name": "seed", "value": "1", "type": "INT"}]}]}]}}
        umd = gw_thread.call(_sync_call(mat.apply, SeldonDeploymentSpec.from_json_dict(
            unit_doc)), 300)
        [uproc] = umd.unit_procs
        if uproc.popen.args[-2:] != ["--device", dev.type]:
            raise AssertionError(f"[operator] the unit's argv {uproc.popen.args}")
        params = [Parameter.from_json_dict(p)
                  for p in json.loads(uproc.binding.env["PREDICTIVE_UNIT_PARAMETERS"])]
        twin = build_runtime("MnistClassifier", "MODEL", params, device=dev)
        unit_base = f"http://127.0.0.1:{unit_port}"

        def unit_launches():
            return json.loads(request("GET", unit_base + "/stats")[1])["kernels"][
                "fused_mlp_softmax"]["launches"]

        _, utok = gateway_token(conn, "unit-key", "unit-secret")
        uhdr = {"Content-Type": "application/json", "Authorization": "Bearer " + utok}
        xu = rng.random((OPERATOR_UNIT_REQUESTS + 1, 784))
        l0 = unit_launches()
        unit_err = 0.0
        for x in xu[:-1]:
            st, _, raw = gateway_post(conn, "/api/v0.1/predictions", body(x), uhdr)
            if st != 200:
                raise AssertionError(f"[operator] the unit answered {st}: {raw[:300]!r}")
            y = np.asarray(json.loads(raw)["data"]["ndarray"], dtype=np.float64)
            want_y = gw_thread.call(twin.predict(SeldonMessage.from_array(np.atleast_2d(x))))
            unit_err = max(unit_err, float(np.abs(np.asarray(want_y.array(), np.float64)
                                                  - y).max()))
        n_unit = unit_launches() - l0
        if unit_err > (0.0 if counted else 1e-6) or (counted and n_unit != OPERATOR_UNIT_REQUESTS):
            raise AssertionError(f"[operator] the unit vs its twin {unit_err}, {n_unit} launches")
        uproc.popen.kill()
        uproc.popen.wait()
        degraded = mat.status("mnist-unit")["state"]
        restarts = mat.supervise()
        mat._await_unit(uproc)
        restored = mat.status("mnist-unit")["state"]
        l1 = unit_launches()  # the fresh process's count (its probe's launch among them)
        st, _, raw = gateway_post(conn, "/api/v0.1/predictions", body(xu[-1]), uhdr)
        n_unit_after = unit_launches() - l1
        if (degraded, restarts, restored, st) != ("Degraded", 1, "Available", 200) or (
                counted and n_unit_after != 1):
            raise AssertionError(f"[operator] kill and restart: {degraded}, {restarts} "
                                 f"restarts, {restored}, {st} {raw[:200]!r}, "
                                 f"{n_unit_after} launches")
        out["unit"] = {"vs_twin": unit_err, "launches": n_unit, "after_restart": n_unit_after,
                       "states": [degraded, restored], "restarts": restarts}
        out["launches"]["unit (spawned microservice)"] = n_unit + n_unit_after
        log(f"[operator] (f) a rest MnistClassifier 784-512-512-10 spawned as the port's "
            f"microservice on {dev.type}: {OPERATOR_UNIT_REQUESTS} requests through the gateway "
            f"its twin's bits ({unit_err}), {n_unit} launches on its /stats; killed -> "
            f"{degraded}, supervise() restarted {restarts} -> {restored}, one more request 200 "
            f"({n_unit_after} launch)")

        # -- (g) the native load rig --------------------------------------------------
        loadgen.result(120)
        direct = ServerThread(EngineService(mat.deployments["mnist-canary"].spec, "main",
                                            device=dev))
        d_port = direct.start()
        contract = Contract.from_file(str(ROOT / "examples" / "mnist_contract.json"))
        clients, seconds, warm = OPERATOR_LOAD
        load = {}
        for arm, port, auth in (("gateway", gw_port, ("canary-key", "canary-secret")),
                                ("engine", d_port, (None, None))):
            fused_mlp.LAUNCHES = 0
            rep = asyncio.run(run_load_native(contract, "127.0.0.1", port, clients=clients,
                                              duration_s=seconds, warmup_s=warm,
                                              oauth_key=auth[0], oauth_secret=auth[1]))
            rep["fused_mlp_launches"] = fused_mlp.LAUNCHES
            load[arm] = rep
            if rep["failures"] or not rep["requests"] or (counted and not rep[
                    "fused_mlp_launches"]):
                raise AssertionError(f"[operator] loadgen on the {arm}: {rep}")
        out["load"] = {arm: {k: r.get(k) for k in ("requests", "failures", "qps", "p50_ms",
                                                   "p99_ms", "fused_mlp_launches")}
                       for arm, r in load.items()}
        out["load"]["shape"] = {"clients": clients, "seconds": seconds, "warmup_s": warm,
                                "rows": 1, "card": smi}
        out["launches"]["load (gateway)"] = load["gateway"]["fused_mlp_launches"]
        out["launches"]["load (engine's own REST lane)"] = load["engine"]["fused_mlp_launches"]
        for arm, r in load.items():
            log(f"[operator] (g) loadgen, {clients} clients, {seconds} s, 1-row, "
                f"{'through the gateway' if arm == 'gateway' else 'at the engine'}: "
                f"{r['qps']} req/s, p50 {r.get('p50_ms')} ms, p99 {r.get('p99_ms')} ms, "
                f"{r['failures']} failures, {r['fused_mlp_launches']} launches ({smi})")
    finally:
        if direct is not None:
            direct.stop()
        if mat is not None:
            mat.shutdown()  # stops the spawned unit, closes the engines
        if gw_thread is not None:
            gw_thread.stop()
        if twin is not None and hasattr(twin, "close"):
            twin.close()
        loadgen.cancel()
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[operator] phase 10y wall {out['wall_s']:.2f} s")
    if out["wall_s"] > 40.0:
        log("[operator] the phase took longer than its 40 s wall")
    return out




def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs "
              "an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from seldon_core_tpu_torch.ops import _build, flash_attention, flash_decode, fused_mlp
        from seldon_core_tpu_torch.runtime.engine import EngineService  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script: {e}",
              file=sys.stderr)
        return 1

    # the phases before the continuous lane's (and the hand-off's) serve and
    # measure the static lane, as they did before that lane became the
    # engine's default; continuous_phases lifts the switch for its engine
    os.environ["SELDON_TPU_GEN_CONTINUOUS"] = "0"
    # the engine_mains before 10r (10o's window engine, 10q's MNIST ones, the
    # unix-socket peers of 10n and 10o) serve and measure the Python lane, as
    # they did before the native plane became engine_main's default; 10r
    # lifts the pin
    os.environ["ENGINE_HTTP_IMPL"] = "fast"
    # the plain version's f32 products must be true f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. device ---------------------------------------------------------
    smi = nvidia_smi_line()
    log(smi)
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # -- 2. build ----------------------------------------------------------
    log(f"[device] phase wall {time.perf_counter() - T_START:.2f} s since start")
    t0 = time.perf_counter()
    _build.build_all(KERNEL_SOURCES)  # one nvcc per source, all started together
    log(f"[build] {', '.join(KERNEL_SOURCES)}: {time.perf_counter() - t0:.2f} s wall")
    for name in KERNEL_SOURCES:
        info = _build.BUILD_INFO[name]
        log(f"[build] {name}: nvcc {info['seconds']:.2f} s -> {info['path']}")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build]   {line.strip()}")
    # at the B=1 plan (a cluster of 16, 8 rows a block): the two activation
    # buffers, the rank's weight slices, the last layer whole, three layers'
    # biases, the 8 warps' partial sums, the logits and three mbarriers
    smem, why = fused_mlp._smem_bytes([784, 256, 256, 10], 16, 8)
    if why is not None or smem != (12672 + 4224 + 25088 + 8192 + 5120 + 3 * 128 + 4096 + 384
                                   + 128):
        raise AssertionError(f"shape check at 784-256-256-10: {smem} bytes, {why!r}")
    for hidden in (256, 512):  # mlp_plan reads the Python statement of the layout
        dims = [784, hidden, hidden, 10]
        for C in (1, 2, 4, 8, 16):
            for BM in (8, 16, 32, 64):
                n, why = fused_mlp._smem_bytes(dims, C, BM)
                if fused_mlp._layout_bytes(dims, C, BM) != (n if why is None else None):
                    raise AssertionError(f"the layout's Python statement differs from the "
                                         f"source at {dims}, C={C}, BM={BM}: {n}, {why!r}")
    for dims, dtype, match in (([4096, 4096, 4096, 10], torch.bfloat16, "shared memory"),
                               ([24, 64, 10], torch.bfloat16, "multiple of 16"),
                               ([16] * 10 + [10], torch.bfloat16, "at most 8")):
        why = fused_mlp.kernel_shape_error(dims, [dtype] * (2 * len(dims) - 2))
        if why is None or match not in why:
            raise AssertionError(f"shape check let {dims} through: {why!r}")
    log(f"[build] shape check: 784-256-256-10 takes {smem} bytes of shared memory at a "
        f"cluster of 16 and 8 rows a block (ops/fused_mlp.py's statement of the layout agrees "
        f"at every plan of both served stacks); 4096-wide, 24-wide and 10-layer MLPs refused")
    flash_build_checks(torch, flash_attention)
    decode_build_checks(torch, flash_decode)
    paged_build_checks(torch, flash_decode)
    int8_build_checks(torch, flash_decode)
    log(f"[build] phase wall {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    mlp_row = mnist_phases(torch, dev, smi)
    log(f"[mnist] phases 3-5 wall {time.perf_counter() - t0:.2f} s")
    flash_row, decode_row, kv_row = generation_phases(torch, dev, smi)
    t0 = time.perf_counter()
    paged_row, kv_paged_row = continuous_phases(torch, dev, smi)
    log(f"[continuous] phases wall {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    mode_counts, _modes = serving_modes_phases(torch, dev, smi)
    log(f"[modes] phases 10d-10f wall {time.perf_counter() - t0:.2f} s")
    for row in (flash_row, decode_row, kv_row, paged_row, kv_paged_row):
        # the main path's launches: each served path's, counted from 0 just
        # before it and read just after
        row["launches_by_path"] = {"earlier phases": row["launches"],
                                   "sampled, prefix and speculative": mode_counts[row["name"]]}
        row["launches"] += mode_counts[row["name"]]
    t0 = time.perf_counter()
    spec_ex = spec_example_phase(torch, dev, smi)
    families = family_phases(torch, dev, smi)
    router = router_phase(torch, dev, smi)
    log(f"[families] phases 10g-10i wall {time.perf_counter() - t0:.2f} s")
    host_graphs = host_graph_phases(torch, dev, smi)
    log(json.dumps({"new_paths": {"speculative_example": spec_ex, "families": families,
                                  "router": router, "host_graphs": host_graphs, "card": smi}}))
    int8_rows = int8_phases(torch, dev, smi)
    wire_grpc = wire_grpc_phase(torch, dev, smi)
    log(json.dumps({"new_paths": {"wire_grpc": wire_grpc}}))
    # the f32 example's verifies and prefill ticks write through kv_write_paged
    kv_paged_row["launches_by_path"]["speculative example (float32)"] = \
        spec_ex["launches"]["kv_write_paged"]
    kv_paged_row["launches"] += spec_ex["launches"]["kv_write_paged"]
    # the MNIST behind the outlier TRANSFORMER and both router branches
    mlp_row["launches_by_path"] = {
        "mnist example": mlp_row["launches"],
        "outlier_pipeline": families["outlier_pipeline"]["fused_mlp_launches"],
        "epsilon_greedy": sum(router["fused_mlp_launches_by_branch"]),
        # ensemble4 fused, compiled and host (engine and microservice), the
        # partial-fusion graph up and degraded, and the fallback router
        "host_graphs": sum(host_graphs["launches"].values()),
        # every lane of 10n, its MULTI frame and ensemble4 with a remote m3
        "wire_grpc": sum(wire_grpc["launches"].values())}
    mlp_row["launches"] = sum(mlp_row["launches_by_path"].values())
    top = spec_ex["times"][0]
    f32_row = {
        "name": "flash_decode_paged (float32 path)",
        "route": "cuda",
        "source": "seldon_core_tpu_torch/ops/csrc/flash_decode_paged.cu",
        "replaces": "seldon_core_tpu/ops/flash_decode.py:47",
        "launches": spec_ex["f32_launches"],
        "max_abs_err": spec_ex["max_abs_err"],
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "shape": (f"B=32 KV=2 G=1 hd=32, {PAGED_NBLK} blocks of {PAGED_BS}, n=512 in every row, "
                  f"float32 (the speculative example's draft; the main path's calls also take "
                  f"the step's write)"),
        "design": PAGED_F32_DESIGN,
        "at": spec_ex["times"],
    }
    dq_row, dkv_row = training_phases(torch, dev, smi)
    # 10o: after every phase that opens a torch.profiler session of its own
    obs = observability_phase(torch, dev, smi)
    log(json.dumps({"new_paths": {"observability": obs}}))
    mlp_row["launches_by_path"]["observability"] = obs["launches"]["fused_mlp_softmax"]
    mlp_row["launches"] += obs["launches"]["fused_mlp_softmax"]
    for row, name in ((paged_row, "flash_decode_paged"), (kv_paged_row, "kv_write_paged")):
        row["launches_by_path"]["observability (/genperf)"] = obs["launches"][name]
        row["launches"] += obs["launches"][name]
    # 10p: after 10o, each path's counts set to 0 just before it
    qc = quality_costs_phase(torch, dev, smi)
    log(json.dumps({"new_paths": {"quality_costs": qc}}))
    mlp_row["launches_by_path"]["quality_costs"] = qc["launches"]["fused_mlp_softmax"]
    mlp_row["launches"] += qc["launches"]["fused_mlp_softmax"]
    for row, name in ((paged_row, "flash_decode_paged"), (kv_paged_row, "kv_write_paged")):
        row["launches_by_path"]["quality_costs (/costs, /postmortems)"] = qc["launches"][name]
        row["launches"] += qc["launches"][name]
    # 10q: after 10p, each path's counts set to 0 just before it
    pol = policies_phase(torch, dev, smi)
    log(json.dumps({"new_paths": {"policies": pol}}))
    mlp_row["launches_by_path"]["policies"] = pol["launches"]["fused_mlp_softmax"]
    mlp_row["launches"] += pol["launches"]["fused_mlp_softmax"]
    for row, name in ((paged_row, "flash_decode_paged"), (kv_paged_row, "kv_write_paged")):
        row["launches_by_path"]["policies (brownout, tiers)"] = pol["launches"][name]
        row["launches"] += pol["launches"][name]
    # 10r: after 10q, the fused MLP's count set to 0 just before the plane's
    # requests and read just after
    nat = native_phase(torch, dev, smi)
    log(json.dumps({"new_paths": {"native": nat}}))
    mlp_row["launches_by_path"]["native"] = nat["launches"]["fused_mlp_softmax"]
    mlp_row["launches"] += nat["launches"]["fused_mlp_softmax"]
    # 10s: after 10r, each dispatch's counts set to 0 just before it and read
    # just after; the training steps' set to 0 before the first
    moe_out = moe_phase(torch, dev, smi)
    log(json.dumps({"new_paths": {"moe": moe_out}}))
    for row, n in ((flash_row, moe_out["launches"]["flash_attention"]
                    + moe_out["launches"]["flash_attention_train"]),
                   (decode_row, moe_out["launches"]["flash_decode"]),
                   (dq_row, moe_out["launches"]["flash_attention_bwd_dq"]),
                   (dkv_row, moe_out["launches"]["flash_attention_bwd_dkv"])):
        row["launches_by_path"] = {**row.get("launches_by_path", {"earlier phases":
                                                                  row["launches"]}),
                                   "moe (served, trained)": n}
        row["launches"] += n
    # 10t: after 10s, each replica's counts read from its /stats before and
    # after the traffic
    dis = disagg_phase(torch, dev, smi)
    log(json.dumps({"new_paths": {"disagg": dis}}))
    rows_by_name = {r["name"]: r for r in (paged_row, kv_paged_row, *int8_rows)}
    for name, key in (("flash_decode_paged", "flash_decode_paged"),
                      ("kv_write_paged", "kv_write_paged"),
                      ("flash_decode_paged (int8 K/V)", "flash_decode_paged int8"),
                      ("kv_write_paged (int8)", "kv_write_paged int8")):
        rows_by_name[name]["launches_by_path"]["disagg (prefill/decode replicas)"] = \
            dis["launches"][key]
        rows_by_name[name]["launches"] += dis["launches"][key]
    for row, key in ((paged_row, "flash_decode_paged"), (kv_paged_row, "kv_write_paged")):
        row["launches_by_path"]["disagg (decode replicas over tp=4)"] = \
            dis["mesh"]["launches"][key]
        row["launches"] += dis["mesh"]["launches"][key]

    # 10u: after 10t, each path's counts set to 0 just before it and read
    # just after; the node engines' fused MLP read from their /stats
    mesh = mesh_phase(torch, dev, smi)
    log(json.dumps({"new_paths": {"mesh": mesh}}))
    mlp_row["launches_by_path"]["mesh (ensemble over ens=4)"] = \
        mesh["launches"]["fused_mlp_softmax"]
    mlp_row["launches_by_path"]["mesh (node engines)"] = mesh["launches"]["fused_mlp_softmax nodes"]
    mlp_row["launches"] += (mesh["launches"]["fused_mlp_softmax"]
                            + mesh["launches"]["fused_mlp_softmax nodes"])
    for row in (flash_row, decode_row, paged_row, kv_paged_row):
        n, n8 = mesh["launches"][row["name"]], mesh["launches_tp8"][row["name"]]
        row["launches_by_path"] = {**row.get("launches_by_path", {"earlier phases":
                                                                  row["launches"]}),
                                   "mesh (flagship over tp=4)": n,
                                   "mesh (flagship over tp=8)": n8}
        nu = mesh["launches_uneven"][row["name"]]
        row["launches_by_path"]["mesh (40 heads over 10 kv heads, tp=4)"] = nu
        row["launches"] += n + n8 + nu
        row["at_uneven_runs"] = mesh["uneven_kernels"][row["name"]]
        row["at_tp8_shard"] = mesh["tp8_shard_times"][row["name"]]
        row["max_abs_err"] = max(row["max_abs_err"], row["at_tp8_shard"]["max_abs_err"],
                                 row["at_uneven_runs"]["max_abs_err"])
    for row in (dq_row, dkv_row):  # (c)'s backward at its runs' views, relative to each max
        row["at_uneven_runs"] = mesh["uneven_kernels"]["flash_attention_bwd"]
    # generator_tp's continuous lane: the paged kernel's f32 path and the
    # paged write on every shard
    f32_row["launches_by_path"] = {"speculative example (float32)": f32_row["launches"],
                                   "disagg (generator_tp decode replica over tp=4)":
                                   dis["mesh"]["launches"]["flash_decode_paged f32"],
                                   "mesh (generator_tp over tp=4)":
                                   mesh["launches"]["flash_decode_paged f32 examples"]}
    f32_row["launches"] += (mesh["launches"]["flash_decode_paged f32 examples"]
                            + dis["mesh"]["launches"]["flash_decode_paged f32"])
    kv_paged_row["launches_by_path"]["mesh (generator_tp over tp=4)"] = \
        mesh["launches"]["kv_write_paged examples"]
    kv_paged_row["launches"] += mesh["launches"]["kv_write_paged examples"]

    # 10v: after 10u, each path's counts set to 0 just before it and read
    # just after
    sharded = sharded_phase(torch, dev, smi)
    log(json.dumps({"new_paths": {"sharded_train": sharded}}))
    for row, key in ((flash_row, "flash_attention"), (dq_row, "flash_attention_bwd_dq"),
                     (dkv_row, "flash_attention_bwd_dkv")):
        n = sharded["launches"][key]
        row["launches_by_path"] = {**row.get("launches_by_path", {"earlier phases":
                                                                  row["launches"]}),
                                   "sharded (ring over sp, tp x sp step, pipeline)": n}
        row["launches"] += n

    # 10w: after 10v, each worker's counts set to 0 just before each path and
    # read just after; (e)'s fused MLP likewise in this process
    multihost = multihost_phase(torch, dev, smi, mesh["flagship"]["request_wall_p50_ms"])
    log(json.dumps({"new_paths": {"multihost": multihost}}))
    for row, key in ((flash_row, "flash_attention"), (dq_row, "flash_attention_bwd_dq"),
                     (dkv_row, "flash_attention_bwd_dkv"), (decode_row, "flash_decode"),
                     (mlp_row, "fused_mlp_softmax")):
        n = multihost["launches"][key]
        row["launches_by_path"] = {**row.get("launches_by_path", {"earlier phases":
                                                                  row["launches"]}),
                                   "multihost (processes over tp, dp x tp, pp, ep; "
                                   "ensemble4 faults)": n}
        row["launches"] += n

    # 10x: after 10w, each path's counts set to 0 just before it and read
    # just after; the remote engine's read from its /stats
    gw = gateway_phase(torch, dev, smi)
    log(json.dumps({"new_paths": {"gateway": gw}}))
    mlp_row["launches_by_path"]["gateway (canary in process, the overhead's gateway arm)"] = \
        gw["launches"]["fused_mlp_softmax"]
    mlp_row["launches_by_path"]["gateway (remote engine_mains: HTTP and relay, JSON and "
                                "wire, a replica set, gRPC)"] = \
        gw["launches"]["fused_mlp_softmax remote"]
    mlp_row["launches_by_path"]["engine's own REST lane (the gateway overhead's other arm)"] = \
        gw["launches"]["fused_mlp_softmax direct"]
    mlp_row["launches"] += (gw["launches"]["fused_mlp_softmax"]
                            + gw["launches"]["fused_mlp_softmax remote"]
                            + gw["launches"]["fused_mlp_softmax direct"])
    for row, key in ((paged_row, "flash_decode_paged"), (kv_paged_row, "kv_write_paged")):
        row["launches_by_path"]["gateway (SSE stream, continuous lane)"] = gw["launches"][key]
        row["launches"] += gw["launches"][key]

    # 10y: after 10x, each path's counts set to 0 just before it and read just
    # after; the spawned unit's read from its /stats
    op = operator_phase(torch, dev, smi)
    log(json.dumps({"new_paths": {"operator": op}}))
    for path, n in op["launches"].items():
        mlp_row["launches_by_path"][f"operator ({path})"] = n
        mlp_row["launches"] += n

    alive = sorted(t.name for t in threading.enumerate() if t is not threading.main_thread())
    log(f"[exit] {len(alive)} threads still alive at the end of the run: {alive}")
    log(smi)
    log(json.dumps({"kernels": [mlp_row, flash_row, dq_row, dkv_row, decode_row, kv_row,
                                paged_row, f32_row, kv_paged_row, *int8_rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--multihost-worker"]:
            sys.exit(multihost_worker(sys.argv[2]))
        code = main()
    except Exception:  # noqa: BLE001 - any failed phase fails the run
        traceback.print_exc()
        sys.exit(1)
    # every phase has stopped the processes it started.  Exit without
    # finalizing the interpreter: its teardown has aborted the process
    # (std::terminate) after every phase had passed, with daemon threads
    # of the in-process engines and mesh shards (each idles up to
    # parallel/mesh.py WORKER_IDLE_S) still alive; "[exit]" names them
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
