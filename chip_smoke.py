"""Drive the PyTorch/CUDA port's serving (one engine, the fleet router
over in-process replicas and over child processes), the DataLoader, GPT
decoding (float and weight-only int8), GPT training
(unrolled, scan-over-layers with remat, mixture of experts), BERT
pretraining, Trainer, translation, image-classification, CTR, SSD
detection and sequence (sentiment nets, BiLSTM-CRF tagger) paths, and
a ProgramDesc of GPT's loss run through the op registry, on one NVIDIA
H100.

    python3 chip_smoke.py

(``python3 chip_smoke.py --fleet-worker SPEC`` is the serve_fleet_proc
phase's child replica, and ``--export-worker SPEC`` the export phase's
loader, both started by the script itself.)

Phases, each printing one JSON line:

1. device  — needs a CUDA device (exits non-zero without one); prints the
   card's name and power limit from nvidia-smi; turns TF32 off.
2. build   — compiles the kernels from paddle_tpu_torch/csrc with nvcc.
   Then one reading of time_ms's own floor: a CUDA graph of one empty
   kernel, on a line of its own ("phase": "floor").
3. kernel  — each kernel (K1 layer norm, K2 flash attention, K3 flash
   backward dq and dk/dv, K4 fused MLP, K5 fused cross-entropy statistics,
   K6 its backward dh and dw/db, K7 paged decode attention, K8 fused
   residual add + layer norm) at the serving, training or BERT path's
   shapes and at ragged shapes, against its
   plain PyTorch version on the same inputs, with the stated tolerance
   (the serving kernels' outputs absolutely; the training path's each on
   its own scale max |plain|, bf16 K6 within 2^-8 of it since its second
   product takes the dlogits in bf16); times the kernel, the plain version
   and, where one exists, one PyTorch library call computing the same
   function, beside the least time the card could take (bytes over
   3.35 TB/s or operations over the peak rate of the input type, and for
   K2 and K3 exponentials over the special-function rate; f32 products at
   three TF32 products' 165 TFLOP/s). K5 and K6 timed at GPT's
   [8176, 32000, 768] head in bf16 and in f32 (tf32x3), checked at the
   program path's 4088 rows and ragged shapes. K3 timed at GPT-train's
   [16, 12, 512, 512, 64] causal in bf16 (tc) and f32 (tf32x3), and at
   D = 32 in f32 (its SIMT route); its tf32x3 route also held at
   Tq != Tk, T = 200 with a key mask that masks whole rows, Tq = Tk =
   2048 and on a misaligned view. K2-K5 (their
   tc routes) also at BertConfig.base()'s and .large()'s shapes. K2 and
   K3 (flash_cases) hold each output on its own scale, and again on the
   rows that see few partners (a causal diagonal, the last keys) and on
   those that see none (exactly 0). K1 (layer_norm_cases) also at
   C = 1024, at C off the 16-byte pack and on a misaligned view; K7
   (decode_cases, held_decode) also at lengths on and one past its
   splits' boundaries, 0 and 1, hd 128, 40 and 36 (the simt route), and at
   a long context (32 slots x 2048 tokens, timed), each split-route case
   bitwise equal in two launches. K8 also as the bf16 policy's
   Transformer calls it (transformer_kernel_cases): f32 rows with bf16
   scale and bias at [32 x 256, 1024] (timed) and at 8189 rows, and a bf16
   x beside an f32 h must raise.
4. serve   — GPTConfig.small() at full width (random weights from a
   seed) behind ServingEngine(num_slots=8, page_size=64, max_len=1024,
   prefill_len=512, bf16 cache): 16 prompts uniform in [64, 512] plus one
   of 700 tokens (chunked prefill), 64 new tokens each. The launch counts
   are zeroed just before and read just after; each serving kernel (K1,
   K2, K4, K7) must have run, every K1 launch on its row route and every
   K7 launch on its split route. Every prefill call of every serving run
   must read a prompt chunk staged at submit (staged_prefills ==
   prefill_calls).
5. crosscheck — two of those requests replayed teacher-forced on the
   card and on the CPU (plain path, f32 cache, same weights); logits must
   agree within the stated tolerance.
5a. export — ``torch.library.opcheck`` of the ten kernels' ops (schema,
   fake implementation against the real outputs, autograd registration,
   AOT dispatch) at small shapes on every route each has; then a
   GPTConfig.small() engine at the serve phase's width with 8 running
   requests takes a live decode step and ``export_decode`` writes its
   step; ``python3 chip_smoke.py --export-worker SPEC``, a fresh
   interpreter that imports ``paddle_tpu_torch.io`` and no model code,
   loads it and runs 16 steps (tokens fed back, lengths advanced on the
   host), which must equal the engine's next 16 greedy tokens in every
   slot and launch K1, K4 and K7 as often a step as the engine's steps
   do (``launches_export``); ``compiled_decode()`` must hold one K7 op a
   layer and ``compiled_verify()`` none (nor K2); a QAT-calibrated,
   frozen ConvNet written by ``save_int8_inference_model`` and loaded
   back must match the eager float twin over the frozen weights within
   1e-6; and the op layer's host cost: K1 at [8, 768] a call through
   its op and through its CUDA implementation called directly.
6. serve_shared — the engine as the JAX engine serves by default: 4
   system prompts of 576 tokens (9 pages), each followed by 6 requests
   with unique suffixes of 16-192 tokens and 2 repeating it bare (32
   requests, 64 new tokens each, odd ids sampled at temperature 0.8,
   top-k 50, top-p 0.95 with explicit seeds), through the prefix cache
   at a 30-page pool (below 8 slots x 13 pages). Prefix hits, skipped
   prompt tokens, copy-on-writes, evictions and preemptions must all be
   above 0; a rerun must give the same tokens, sampled ones too; greedy
   requests never preempted must equal a cache-off, full-pool run token
   for token; preempted requests are held by the crosscheck's logit bar;
   a run with one injected serve.step fault must recover once and give
   the clean run's tokens on the greedy requests it neither recovered
   nor preempted (one recovered request held by the crosscheck). Every
   other serving run asserts that no step was recovered, and the serve
   and int8 waves that nothing was shared. Also the host time of one
   call of the sampler.
7. serve_spec — the serve phase's engine and traffic through speculative
   decoding (draft=True, spec_k=3): greedy self-draft, with the launch
   counts zeroed just before and read just after (every serving kernel
   launched, on serve's routes); the same prompts with odd ids sampled,
   spec off then on; and a 2-layer draft cut from the target's weights
   (greedy). Each run's requests must equal a spec-off run's token for
   token or be held by the crosscheck at a near tie (serve_shared's
   rule). Then one draft step (K1 row, K4 SIMT, K7 split) and one verify
   call (K1 row, K4 SIMT, no K2) at the serve shapes: their launches and
   routes checked, their device ms read with torch.profiler. Reports
   each run's tokens/s, p50 step and TTFT, spec_stats() and
   latency_stats() beside the spec-off serve phase.
8. int8    — a short serve with an int8 KV pool; every K7 launch on the
   split route.
8a. serve_fleet — bench.py:717's gpt_serve_fleet row through the
   FleetRouter: GPTConfig.small() (the serve phase's float weights, one
   module shared by every replica), 4 slots a replica, page 64, a
   64-token shared prefix on half the prompts, prefill_len 256, 64 new
   tokens, bf16 pools, prompts from np.random.RandomState(0); 1, 2 and
   4 replicas (4n warm-up, 8n timed requests; a rolling deploy of the
   same weights as v1 in the warm-up at 2, the busiest replica killed
   mid-stream at 4), after a disaggregated run (prefill_replicas=1, half
   the prompts longer than prefill_len) at 2. Every request must be done
   and equal one ServingEngine under the same ServeConfig token for
   token (or part from it at a near tie, crosscheck's reference rule);
   failovers and handoffs >= 1; the launch counts are zeroed after the
   single engine's reference runs, just before the fleet runs, and read
   just after them, before any check launches a kernel; K1, K2, K4 and
   K7 must launch on serve's routes. Records per replica count tokens/s,
   goodput, the prefix hit rate, affinity hits, failovers, the failover
   round's ms, the p50 round and 8 profiled decode rounds of the warm-up
   (device ms, idle share, launches a round). Then bench.py:1004-1039's
   untraced window in ABA order: the 4-replica run, the same run with
   trace_fleet off and the flight ring at 0 (no trace id minted, the
   same bar), and once more traced; the untraced tokens/s,
   trace_overhead (untraced / mean traced tokens/s) and the ratios to
   each traced run (tools/torch_trace_overhead.py repeats the window
   ABBA). The window's launches are not counted.
8a'. serve_fleet_proc — the same model, serve config and prompts behind
   a FleetRouter over 2 SubprocessReplica children on the card, each a
   fresh interpreter (python3 chip_smoke.py --fleet-worker SPEC) loading
   the weights the parent wrote once with torch.save. A kill drill (8
   warm-up requests, 32 timed, the busier child killed -9 after 3
   rounds) and a device-assert drill (8 requests; one child, armed by
   PT_SMOKE_ASSERT_AT, indexes a card tensor out of range at its 12th
   engine step and dies; its handle's timeout is 3 s meanwhile): every
   request done and token-exact against serve_fleet's single engine (or
   at a near tie), each dead child respawned at generation 1, the other
   child at generation 0 and the parent's context alive; one merged
   RunLog timeline in which every re-routed request keeps its trace id
   across the killed child's log and another process's. Records tokens/s,
   the p50 round beside serve_fleet's 2-replica in-process p50, each
   child's start-up split, the failover rounds and the time to detect
   each death; the children's launch counts (each child writes them when
   it stops) must show K1, K2, K4 and K7, on serve's routes, and no
   child may build the kernels.
8a''. loader — DataLoader.from_generator at examples/train_resnet.py:44's
   shapes (20 batches of 32 CIFAR-sized images and labels) on the card,
   bitwise equal to the CPU's batches; an early break leaves no prefetch
   thread.
8b. gpt_decode — bench.py:461's row through GPTDecoder.generate:
   GPTConfig.small() (f32 weights from seed 0), 16 prompts of 128
   tokens, 128 new tokens, bf16 KV cache. One call with the launch
   counts zeroed just before and read just after (K1, K2, K4 launched,
   K7 not), 3 timed calls chained as bench chains them, a profiled call
   (device ms, idle share) and one decode step (launches, device ms,
   bound: parameters and padded cache over 3.35 TB/s); two rows
   teacher-forced on the card (bf16 cache) and the CPU (f32 cache),
   logits within 5e-2 and every token the CPU's argmax or a near tie.
8c. gpt_decode_int8 — the same model after quantize_weights_int8: 2L +
   4L + 2 int8 leaves, the full forward's logits within 5 % of the float
   model's largest, no K4 launch, the same row's numbers and its greedy
   agreement with the float run.
8d. serve_int8 — the serve traffic through ServingEngine over the int8
   weights (K1, K2, K7; no K4): every greedy request equals generate on
   its prompt alone, or parts where generate's logits of the two tokens
   are a near tie (within 5e-2).
9. train   — the GPT training step at full width (GPTConfig.small(),
   dropout 0, weights from a seed): GPT.loss, its backward and
   amp.decorate(Adam(1e-4), bf16_policy()), batch 16 x seq 512 of one
   fixed seeded batch; 2 warm-up steps, then 10 timed steps with the
   launch counts zeroed just before and read just after. Each training
   kernel (K1-K6) must launch its expected count per step, the loss must
   be finite at every step and fall from the first step to the last.
10. train crosscheck — one f32 step (TF32 off) of GPTConfig.small() at
   batch 2 x seq 128 on the card and on the CPU plain path from the same
   weights: loss and every parameter's gradient must agree.
10b. scan_remat — the train step, 2 + 5 steps, by the unrolled model
   and then with scan_layers=True under each remat policy (nothing,
   dots_saveable, full), in turn: per-step launches (the blocks' K1, K2
   and K4 twice under a recomputing policy), losses within 1e-6
   relative of the unrolled run's, tokens/s, and peak memory falling
   from nothing to full.
10c. moe_train — the train step with moe_experts=8, moe_k=2 (GShard's
   top-2 at capacity factor 1.25), 2 + 5 bf16 Adam steps: per-step
   launches (no K4), finite falling losses, a profiled step's device ms
   split (one-hot dispatch/combine and experts timed alone at the
   step's shapes, the rest), and the bf16 slot collisions a layer.
10d. moe_crosscheck — one f32 step of that model at 2 x 128 on the card
   and the CPU: loss within 1e-4, gradients within 1e-3 relative L2.
11. bert_train — bench.py's BERT row on the card: BertConfig.base()
   (dropout 0, weights from a seed), BertForPretraining.loss with 76
   gathered MLM positions per row, its backward and
   amp.decorate(Adam(1e-4), bf16_policy()), batch 64 x seq 512 of one
   fixed seeded batch; 2 warm-up and 10 timed steps with the launch
   counts zeroed just before. Each kernel of the path (K1-K6, K8) must
   launch its expected count per step; the loss must be finite and fall.
12. bert_crosscheck — one f32 step (TF32 off) of BertConfig.base() at
   batch 2 x seq 128 with a padded attention mask (K2/K3 with kv_mask),
   token types and 19 mask positions per row, on the card and on the CPU
   plain path: loss and every parameter's gradient must agree.
13. bert_large — BertConfig.large() (H = 1024, 24 layers) at full width
   and depth, batch 8 x seq 512 (bench.py's 64 cut to 8), 1 warm-up and
   3 timed bf16 Adam steps: every kernel of the path launches its count
   per step (K5/K6 at H = 1024) and every loss is finite.
14. trainer — BertConfig.base() at dropout 0.0 (weights from seed 0)
   trained through Trainer, as examples/pretrain_bert_flash.py sets it
   and trains it: a seekable synthetic stream of 64 x 512 batches
   (each row's attention mask cut at a length
   uniform in [256, 512], 76 masked positions per row, NSP labels),
   decorate(AdamW, bf16) with a warm-up into a polynomial decay, a
   global-norm clip and no decay on layer-norm scales and biases,
   checkpoints every 8 steps in a temporary directory. Runs of 16
   steps: A (guardian armed), A' (no guardian: bitwise repeatability,
   and the gate's cost), R (stopped at 10, resumed from step 8 on zeroed
   weights) and G (the loss made non-finite at steps 10-12 by a
   FaultPlan: the guardian skips, re-reads, rolls back to step 8 and
   replays). R's
   and G's losses and final parameters and slots must equal A's as far
   as A' does; the refused step must leave the state bit-identical; a
   RecomputeOptimizer step from the step-8 checkpoint must equal the
   plain step bitwise, at dropout 0.0 (flash attention) and at the
   published 0.1 (attention dropout takes the dense path, in both
   packages). The launch counts are zeroed just before A and read just
   after: K1-K6 and K8 at bert_train's counts on their routes. Records tokens/s,
   the p50 step, every run's losses, checkpoint bytes, seconds per save
   and restore, and peak memory with and without recompute.
15. transformer_big — bench.py's Transformer row on the card:
   TransformerConfig.big() (d 1024, 16 heads, FFN 4096, 6 + 6 layers,
   vocab 32000; dropout 0, weights from a seed), Transformer.loss (label
   smoothing 0.1, pad 0) under amp.decorate(Adam(1e-4), bf16_policy()),
   one fixed seeded batch of 32 x 256; 2 warm-up and 5 timed steps with
   the launch counts zeroed just before. K8 must launch 30 times a step
   and no other kernel (the reference's attention is dense, its FFN
   unfused and its hv loss chunked XLA); the activations must be f32 (the
   reference promotes them so under the policy); every loss finite and
   falling. Records tokens/s, the p50 step and peak memory.
16. transformer_crosscheck — one f32 step (TF32 off) of
   TransformerConfig.big() at 2 x 64 with a padded source row and pad ids
   in tgt_out, on the card and on the CPU plain path: loss and every
   gradient must agree; then the bf16-policy loss within 1e-3.
17. seq2seq — Seq2SeqConfig() (vocab 1024, embed 64, hidden 128,
   bidirectional GRU encoder): 5 f32 Adam steps teacher-forced on a batch
   of 64 (sources of 8-32 tokens padded to 32, targets of 32), the loss
   finite and falling; greedy_decode and beam_decode (beam 4) to 32
   tokens on the card and on the CPU from the trained weights, each row
   equal or held at a near tie (held_greedy, held_beams), every card
   hypothesis's score the CPU model's for it. No kernel of the port runs
   there, as none of the reference's does. Records the step ms and each
   decoder's tokens/s.
18. resnet50 — bench.py's ResNet row on the card: resnet50(1000)
   (weights from a seed; NHWC compute as channels_last over the
   reference's HWIO kernels, the NCHW batch transposed once at the
   stem; cuDNN convolutions, the reference's batch norm in plain torch),
   mean softmax cross entropy of the bf16 logits under
   amp.decorate(Momentum(0.1, 0.9), bf16_policy()) with f32 velocity and
   the running statistics updated in bf16 and stored in f32, one fixed
   seeded batch of 128 f32 images at 224 x 224; 2 warm-up and 10 timed
   steps with the launch counts zeroed just before (no kernel of the port
   may launch: the reference's convolutions, pools and batch norms are
   XLA's), then untimed steps to 60 in all: every loss finite, the last
   below the first, every running statistic moved. Records images/s, the
   p50 step, peak memory, the share of the bf16 peak by bench.py's count
   ("mfu_bf16_peak") and one profiled step (device ms in convolutions
   and the fc GEMM, in the optimizer, in batch norm and the other
   elementwise work; idle share; launches).
19. resnet_crosscheck — one f32 step (TF32 off) of resnet50(1000) at
   2 x 3 x 224 x 224 on the card and on the CPU plain path from the same
   weights (the CPU taking the card's ReLU branches): loss, every
   gradient and every updated running statistic within their bars.
20. vision_cls — three bf16 Momentum steps of se_resnext50(1000) at 32
   x 224 x 224 and of vgg16(10) at 128 x 32 x 32: finite losses, no
   kernel of the port, the step times.
21. ctr — bench.py's CTR row on the card: DeepFM(sparse_tables=True) at
   CTRConfig(26, 13, 100000, 16, (400, 400, 400)) (493,215 head
   parameters from a seed) under Adam(1e-3), the [2.6 M, 16] embedding
   and [2.6 M, 1] first-order SparseTables on the card, each under its
   own Adagrad(0.05) row update, all f32, through
   make_sparse_deepfm_train_step on one fixed seeded batch of 512; 5
   warm-up and 50 timed steps with the launch counts zeroed just before:
   every loss finite, the last below the first, every touched row of
   both tables and both moments moved, every other row bit-identical,
   no kernel of the port launched (the reference's gathers, scatters,
   MLP and FM terms are XLA's). Records examples/s, the p50 step, peak
   memory, unique rows a step and one profiled step (device ms in
   gathers, scatters and the unique, in GEMMs, in the head's Adam and
   the rest; idle share; launches).
22. ctr_crosscheck — one f32 step (TF32 off) of that model and those
   tables at 512 on the card and on the CPU from the same draws: the
   loss within 1e-6 relative, every head parameter, touched table row
   and (relative to its largest) Adagrad moment within 1e-5, untouched
   rows equal.
23. ctr_host — the same model with both tables as HostTables in host
   RAM, trained through Trainer(sparse_tables=...) over a synthetic_ctr
   stream in batches of 512 for 20 steps: finite losses, touched rows
   moved, the rest bit-identical, no kernel of the port; records
   examples/s, the host ms of each table's pull and push a step, the
   bytes over PCIe a step and the tables' nbytes().
24. ssd — examples/train_ssd.py at its defaults on the card through
   tools/torch_ssd.py: TinySSD(300) (weights from seed 0; 75 x 75 and
   38 x 38 maps, 4 priors a cell, 28,276 priors), the example's batch of
   4 images with 3 ground-truth boxes each, the mean ssd_loss (batched
   matching, hard-negative mining, smooth L1) under Momentum(0.01, 0.9),
   f32, 20 steps with the launch counts zeroed just before: every loss
   finite, the last below the first, no kernel of the port launched (the
   reference wrote none for detection). detection_output of each image
   (score 0.01, NMS 0.45, keep 10, NMS top 400) on the card and on the
   CPU from the same locs, scores and priors: counts, labels and source
   indices (multiclass_nms2) exact, scores and boxes within 1e-5, a row
   differing only at a near tie of scores (within 1e-6, reported);
   DetectionMAP over the four images in both AP versions. The example
   divides the head's priors, already normalized, by the image side
   again, so it matches no prior (recorded); the same run follows with
   the priors as the head returns them ("matched", every image matching
   some prior). Records the p50 step, images/s, one profiled step
   (device ms, idle share, launches), detection_output's wall and device
   ms and launches on image 0 and its NMS loop's alone (and its share of
   the call); then, if the phase is under 25 s in, 1 + 5 steps at batch
   32.
25. ssd_crosscheck — one f32 Momentum step (TF32 off) of TinySSD(300)
   at batch 4 on the card and on the CPU from the same weights, the CPU
   taking the card's ReLU branches and hard negatives (ReluReplay,
   MiningReplay: each differing choice within its tolerance of 0 or of
   its row's cut): loss within 1e-4, every gradient within 1e-3 relative
   L2, no kernel of the port; with the example's loss and again with the
   priors as the head returns them (ssd_crosscheck_matched).
26. tagger — the book's BiLSTM-CRF tagger at TaggerConfig()'s widths
   (vocab 4096, 16 tags, embed 32, hidden 64, 2 bidirectional layers;
   weights from seed 0): batch 64, lengths uniform in 8-64, labels
   tokens % 16, f32 Adam(1e-2), 2 warm-up and 10 timed steps with the
   launch counts zeroed just before (losses finite and falling, no
   kernel of the port: the reference wrote none for the sequence
   family), one profiled step (device ms, idle share, launches); then
   crf_decoding of the trained emissions (wall and device ms, launches,
   token accuracy) against the CPU's from the same weights: each row's
   NLL within 1e-4 relative, every path the CPU's or one the CPU scores
   within 1e-5 (relative) of its own best (near ties, counted).
27. sentiment — TextCNNSentiment and StackedLSTMSentiment(stacked_num=3)
   at SentimentConfig()'s widths (vocab 5149, embed 128, hidden 128, 2
   classes): batch 128, lengths uniform in 32-256, f32 Adam(2e-3), the
   tagger's fields, then a forward pass (wall and device ms, launches)
   with logits within 1e-5 of the CPU's (relative to max(1, max |CPU|)).
28. tagger_crosscheck, sentiment_crosscheck — one f32 Adam step (TF32
   off) of the tagger and of each sentiment net at full width, batch 8,
   on the card and on the CPU from the same weights: loss within 1e-4,
   every gradient within 1e-3 relative L2, no kernel of the port.
29. sequence_ops — every op of the port's ops/sequence.py,
   ops/text_match.py, ops/crf.py, ops/nets.py and ops/metrics_ops.py on
   the card against the CPU on the same inputs (a ragged batch of 64
   rows of up to 64 steps of 128 features, two of them empty; the
   tagger's 16 tags): floats within 1e-5 relative to max(1, max |CPU|),
   integers, lengths and chunk counts exact, Viterbi paths held as the
   tagger's; prints the op count and the worst error and its op.
30. program — GPT-small's training loss spelled out op by op as a
   ProgramDesc (gpt_loss_desc: lookup_table, elementwise_add, per block
   layer_norm, multihead_attention(num_heads=12, causal, use_flash),
   elementwise_add, layer_norm, fc, gelu, fc, elementwise_add; ln_f; the
   shifted fused_xent against the tied table; reduce_mean) at full width,
   12 layers, f32, batch 8 x 512: to_json, parse_from_string,
   to_static_program and Executor("cuda").run on numpy feeds from a seed
   (2 warm-up, 5 timed runs: p50 ms); one forward and its gradient over
   the fed parameters through the parsed build_fn and autograd, with the
   launches asserted (K1 25, K2 12, K5 1; K3 dq and dk/dv 12 each, K6 dh
   and dw/db 1 each) and their routes (K1 row, K2 SIMT, K3/K5/K6 tf32x3:
   f32); a forward and its backward timed (2 warm-up, 5 timed: p50 ms);
   the same desc cut to 2 layers at 2 x 128 on the card and the CPU (loss
   within 1e-4 relative, every gradient within 1e-3 relative L2);
   Program.capture of the parsed function on the card, which must name
   the K1, K2 and K5 ops; one profiled run (device ms, idle share); and a
   one-op desc of paged_decode_attention over the serve configuration's
   bf16 pool (8 slots, 12 heads, hd 64, page 64): K7 once, held against
   its plain version.
31. word2vec — the book path of tools/torch_word2vec.py as a user runs
   it: a seeded Zipf corpus (3000 lines over 2000 words) written to a
   file, build_dict(markers=True), 5-grams (ngram_reader(n=5)), four
   record files (write_record_file over numpy_records), read back through
   FileDataset with 2 native reader threads (every record byte for byte
   the one written; records a second), then Word2Vec(vocab, 32, 4, 256)
   and SkipGramNCE(2048, 64, 16) trained 20 steps each at batch 512 (the
   skip-gram's 2048 (center, target) pairs a batch) under Adam(1e-3) on
   the card, with the negatives drawn on the host; the first 5 losses of
   each within 1e-4 relative of the same models' on the CPU (same
   weights, batches and negatives); one skip-gram step on the model's
   own generator; p50 step ms, launches a step, device ms and idle share
   of each; no kernel of the port launched.
32. op_tail — every name the op surface's last slice registered (the
   rest of ops/tail.py, ops/fused.py's compositions, the sampling grids,
   3-D ops and shuffles of ops/vision.py, ops/graph.py's tree_conv) on
   the card against the CPU on the same inputs (OpHolder: floats within
   1e-5 relative to max(1, max |CPU|), integers and indices exact,
   max_pool2d_with_index's planted ties included), each op's launches
   counted alone: fused_fc_elementwise_layernorm exactly one K8 launch,
   every other op none; the random ops on shape, range and seeded
   determinism on the card's generator; LayerNorm(768, scale=False,
   shift=False) (and with scale or shift alone) on a few rows: K1 once,
   and K8 once with a residual, held against the CPU. Prints the op count
   and the worst error and its op. Then a "timeline" line: the script's
   time (t_s) to its last phase.

K2, K3, K4, K5 and K6 have two routes or more: the tensor cores for
bf16 (K4 and K5 with widths that are multiples of 8, on the TMA + wgmma
mainloop of csrc/gemm.cuh; K2 and K3 with a head dim of 64 or 128, on
their own TMA + wgmma kernels; K6 for every bf16 width), 3xTF32 on the
tensor cores for K5 and K6 in f32 with H a multiple of 4 and for K3 in
f32 with a head dim of 64 ("tf32x3"), the SIMT kernels for f32 and
other widths. Every
such case records the route it took and must have taken the rule's;
every K2-K5 launch of train, bert_train and bert_large must be on the
tensor cores, every K2 and K4 launch of serve on the SIMT kernel. K1 and
K7 have a second route too, chosen by shape (K1's row route for rows of
whole 16-byte packs, at most 8 a lane; K7's split route for head dims
that are multiples of 8 up to 256), which every launch of every path
takes.

Then the {"kernels": [...]} line (each kernel with the launches of its
own path: serve for K1 (its row route), K7 (its split route) and the SIMT
rows of K2 and K4, beside serve_spec's greedy run's,
train_crosscheck (f32) for K3's SIMT rows (timed at D = 32, its route's
launches there: 0, since the f32 crosschecks take tf32x3), train for the
tc rows ("flash_attention.tc", "flash_attention_bwd_dq.tc",
"flash_attention_bwd_dkv.tc", "mlp.tc") and K5's and K6's bf16 rows,
program for the f32 3xTF32 rows ("xent_stats.tf32x3",
"xent_bwd_dh.tf32x3", "xent_bwd_dwb.tf32x3", timed at [8176, 32000,
768] f32; "flash_attention_bwd_dq.tf32x3" and
"flash_attention_bwd_dkv.tf32x3", timed at [16, 12, 512, 512, 64] f32
causal), bert for K8, and
transformer_big for the "add_layer_norm.mixed" row (K8 at f32 rows with
bf16 parameters); "variant" names the route; every row also has each
path's count (LISTED_PATHS), launches_transformer, launches_gpt_decode,
launches_gpt_decode_int8, launches_serve_int8, launches_serve_fleet,
launches_serve_fleet_proc (the children's), launches_moe_train and
launches_scan_<policy> among them, and launches_resnet, launches_ctr,
launches_ssd, launches_tagger, launches_sentiment and launches_word2vec,
which are 0, launches_program, the program phase's measured forward and
backward, and launches_op_tail, K8's and K1's in the op_tail phase), the
nvidia-smi line, and
the contract line
{"ok": true, "device": {...}}.
Any failed phase raises, and the script exits non-zero without the
contract line.
"""

import collections
import contextlib
import dataclasses
import glob
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import torch

PEAK_BYTES = 3.35e12                     # H100 SXM HBM3
#: f32: three TF32 tensor-core products at 495 TFLOP/s (3xTF32, the
#: least time at which this card does f32-accurate products; K5's and
#: K6's f32 routes run so); the CUDA cores' 67 TFLOP/s of f32 FMAs is a
#: limit of the SIMT kernels, not of the card
PEAK_OPS = {torch.float32: 165e12,
            torch.bfloat16: 989e12,      # dense bf16 tensor cores
            torch.int8: 1979e12}         # dense int8 tensor cores
#: exponentials per second of the special-function units (MUFU.EX2) of
#: one H100 SXM, the FlashAttention-3 paper's figure (Shah et al. 2024,
#: section 3.2: 3.9 TFLOPS of special functions against 989 of bf16
#: products); only K2's and K3's bounds count exponentials
PEAK_EXPS = 3.9e12
F32_TOL = 1e-4     # f32 kernels: sums in another order than cuBLAS/torch
BF16_TOL = 3e-2    # bf16 storage: one bf16 rounding of outputs ~ 2^-8 rel
XENT_BF16_TOL = 2.0 ** -8   # bf16 K6: gch rounded to bf16 (2^-9 rel) for
                            # its second product; f32 outputs
FLASH_BF16_TOL = 2.0 ** -6  # bf16 K2/K3: P (and dS) rounded to bf16
                            # (2^-9 rel each) for the products that take
                            # them, and one bf16 rounding of each output;
                            # the tc route reads 2.0e-3 to 7.7e-3 of each
                            # output's largest value (the largest: K3's
                            # dv at BERT-large's shape)
SERVE_LOGIT_TOL = 5e-2   # bf16 KV cache on the card vs f32 cache on CPU
TRAIN_LOSS_TOL = 1e-4    # f32 train step, card vs CPU plain path
TRAIN_GRAD_TOL = 1e-3    # relative L2 of each parameter's gradient: sums
                         # in other orders, embedding gradients by atomics
                         # in an order that changes from run to run
RESNET_STATS_TOL = 5e-5  # ResNet-50's running statistics after one f32
                         # step at batch 2, card vs CPU, relative to each
                         # leaf's max: the reference's batch norm takes its
                         # statistics in f32 whatever x's type, over 98
                         # values a channel in the last stage, so even
                         # the step in f64 on both sides parts them by
                         # about 1e-5 (resnet_crosscheck_f64's line)
RESNET_RELU_FLIP_TOL = 1e-3  # ResNet-50 at batch 2: that batch norm
                             # moves the deep pre-activations by a few
                             # 1e-4 between the card and the CPU in f32
TRANSLATE_BF16_LOSS_TOL = 1e-3  # the Transformer's bf16-policy loss, card
                                # vs CPU: f32 activations, bf16 weights
RELU_FLIP_TOL = 1e-4      # a pre-activation whose sign differs between the
                          # card and the CPU: f32 rounding, about 1e-6
SEQ2SEQ_LOGIT_TOL = 1e-4  # f32 seq2seq, card vs CPU: a near tie of two
                          # tokens' logits (or beam candidates' scores)
SEQ2SEQ_SCORE_TOL = 1e-4  # beam scores: sums of 32 f32 log-probs

#: the kernels each path must launch
SERVE_KERNELS = ("layer_norm", "flash_attention", "mlp", "decode_attention")
TRAIN_KERNELS = ("layer_norm", "flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "mlp", "xent_stats",
                 "xent_bwd_dh", "xent_bwd_dwb")
BERT_KERNELS = TRAIN_KERNELS + ("add_layer_norm",)
#: the kernels with a tensor-core route (bf16) beside their SIMT one:
#: every launch of the training paths takes it
TC_KERNELS = ("mlp", "xent_stats", "flash_attention",
              "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
#: the serve path's kernels of those and the routes their f32 launches
#: take there: K4 the split route (decode, draft and verify rows) and the
#: gemm route (prefill chunks), K2 the SIMT one
SERVE_ROUTES = {"mlp": ("split", "gemm"), "flash_attention": ("simt",)}
SERVE_ROUTED = tuple(SERVE_ROUTES)
#: K1's and K7's second routes, which every launch of every path takes
#: (the kernels line has one row for each, on that route)
PATH_ROUTE = {"layer_norm": "row", "decode_attention": "split"}


_START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line also says when it was printed
    (``t_s``, seconds since the script started)."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - _START)
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, graph=True):
    """Mean device time of ``fn`` over ``iters`` runs. ``fn`` is captured
    once as a CUDA graph, and each replay is bracketed by its own CUDA
    events right after a 256 MiB memset: the memset evicts the 50 MB L2
    (inputs are read cold, as the model reads its weights) and keeps the
    device busy while the host enqueues the replay, so host launch time
    stays out of the reading. ``graph=False`` brackets plain calls
    instead (for autograd backward calls, timed as library yardsticks at
    sizes where a call takes milliseconds)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    run = fn
    if graph:
        cuda_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(cuda_graph):
            fn()
        run = cuda_graph.replay
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    marks = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / iters


def bound_ms(nbytes, ops, dtype, exps=0):
    """The least time the card could take: the largest of the bytes over
    the memory rate, the operations over the input type's peak rate and
    (K2, K3) the exponentials over the special-function rate; and which
    of the three it is."""
    times = {"bytes": nbytes / PEAK_BYTES * 1e3,
             "operations": ops / PEAK_OPS[dtype] * 1e3,
             "exp": exps / PEAK_EXPS * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def route_of(name, fn, *args):
    """``(fn(*args), the route its launch of kernel ``name`` took)``."""
    from paddle_tpu_torch.ops.cuda import core
    before = dict(core.KERNELS[name].route_launches)
    out = fn(*args)
    after = core.KERNELS[name].route_launches
    taken = [r for r in after if after[r] != before[r]]
    if len(taken) != 1:
        raise AssertionError(f"{name}: one launch expected, routes {taken}")
    return out, taken[0]


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check(name, err, tol):
    if not (err <= tol):
        raise AssertionError(f"{name}: max |kernel - plain| = {err} > {tol}")


def scaled_err(got, want):
    """``(max |got - want|, that over max |want|)``; where ``want`` is all
    zero the second is 0 if ``got`` matches it exactly, else inf."""
    if not want.numel():
        return 0.0, 0.0
    err = max_err(got, want)
    top = float(want.float().abs().max())
    return err, (err / top if top > 0 else
                 (0.0 if err == 0 else float("inf")))


def held(name, got, want, dtype, tol=None):
    """Hold each output against its own plain version on its own scale:
    max |kernel - plain| <= tol * max |plain| (tol 1e-4 in f32, 3e-2 in
    bf16, unless given), so the limit is a small fraction of each output's
    largest value whatever its magnitude; an output whose plain version is
    all zero must come out exactly zero. Returns the case's fields: the
    largest absolute error over the outputs, the worst error over its
    output's scale, and tol."""
    if tol is None:
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    errs, rel = [], 0.0
    for a, b in zip(got, want):
        err, r = scaled_err(a, b)
        errs.append(err)
        rel = max(rel, r)
    if not (rel <= tol):
        raise AssertionError(f"{name}: max |kernel - plain| / max |plain| "
                             f"= {rel} > {tol}")
    return dict(max_abs_err=max(errs), rel_err=rel, tol=tol)


def xent_unreached(labels, vocab):
    """``(rows, vocab_rows)`` bool masks: the rows whose label is outside
    ``[0, vocab)`` and the vocab rows that no label hits. Their dlogits
    are the softmax term alone, ``(p - sn) g``; wherever a label hits,
    the label term ``-(sp - sn) g`` outweighs it many times over."""
    lab = labels.long()
    miss = (lab < 0) | (lab >= vocab)
    hit = torch.zeros(vocab, dtype=torch.bool, device=labels.device)
    hit[lab[~miss]] = True
    return miss, ~hit


def held_xent_bwd(name, got, want, labels, vocab, dtype):
    """Hold K6's outputs, ``[dh]`` or ``[dw, db]``, each on its own scale
    (as :func:`held`) and again on the entries no label reaches (dh's
    rows with an out-of-range label, dw's rows and db's entries that no
    label hits) on their own scale: there only the softmax term acts, so
    a fault in it (the bias, logz) shows that the label term hides in
    the whole output. bf16 dh and dw at XENT_BF16_TOL (the second product
    takes gch in bf16); db, summed from the f32 gch, and every f32 output
    at F32_TOL. Every part is measured before any is judged, so a failure
    prints them all. Returns the case's fields: the largest absolute
    error over the whole outputs and each part's reading."""
    miss, unhit = xent_unreached(labels, vocab)
    names = ("dh",) if len(got) == 1 else ("dw", "db")
    parts, failed = {}, []
    for out, a, b in zip(names, got, want):
        tol = (XENT_BF16_TOL if dtype == torch.bfloat16 and out != "db"
               else F32_TOL)
        sel = miss if out == "dh" else unhit
        for part, x, y in ((out, a, b), (f"{out} unreached", a[sel],
                                          b[sel])):
            if not y.numel():
                continue
            err, rel = scaled_err(x, y)
            parts[part] = dict(max_abs_err=err, rel_err=rel, tol=tol)
            if not (rel <= tol):
                failed.append(part)
    if failed:
        raise AssertionError(f"{name}: {', '.join(failed)} over tolerance; "
                             f"parts {json.dumps(parts)}")
    return dict(max_abs_err=max(parts[o]["max_abs_err"] for o in names),
                parts=parts)


def xent_cases(dev, gen, n, vocab, hid, dtype, ls=0.0, oob=False,
               timed=False):
    """K5 and K6 on one vocab head: ``h [n, hid]`` against ``W [vocab,
    hid]`` (the tied vh layout) and an f32 bias, made from ``gen``, logz
    from the plain statistics, label smoothing ``ls``. Every 97th row
    has the ignore label -100, and with ``oob`` every 7th and every 9th
    (from row 1) is out of range too, so that no label reaches some rows
    (:func:`held_xent_bwd`). Returns the three cases by kernel name, each
    with the route its launch took; K5 is held at F32_TOL (f32
    statistics from either storage type).
    ``timed`` adds each kernel's time, its plain version's, one library
    call's (the forward of ``F.cross_entropy(F.linear(h, w, b))`` for
    K5, its autograd backward, all three outputs, for K6) and the
    bound."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import xent as xe

    def randn(*shape, dt=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dt)

    h = randn(n, hid, dt=dtype)
    w = randn(vocab, hid, dt=dtype, scale=0.05)
    bias = randn(vocab, scale=0.1)
    labels = torch.randint(0, vocab, (n,), generator=gen).to(dev)
    labels[3::97] = -100                 # the ignore index: never hits
    if oob:
        labels[::7] = vocab + 3          # out of range: never hits
        labels[1::9] = -2
    inputs = (h, w, bias, labels)
    shape = [n, vocab, hid]
    stats, stats_route = route_of("xent_stats", xe.xent_stats_kernel,
                                  *inputs)
    pstats = xe.xent_stats_plain(*inputs)
    logz = pstats[0] + torch.log(pstats[1])
    gg = randn(n, scale=1.0 / n)
    sn, sp = (ls / (vocab - 1), 1.0 - ls) if ls else (0.0, 1.0)
    bwd_args = (h, w, bias, labels, logz, gg, sn, sp)
    dh, dh_route = route_of("xent_bwd_dh", xe.xent_bwd_dh_kernel, *bwd_args)
    (dw, db), dwb_route = route_of("xent_bwd_dwb", xe.xent_bwd_dwb_kernel,
                                   *bwd_args)
    pdh, pdw, pdb = xe.xent_bwd_plain(*bwd_args)
    base = dict(shape=shape, dtype=str(dtype), label_smoothing=ls,
                out_of_range_labels=oob)
    what = f"{shape} {dtype} ls={ls}"
    cases = {"xent_stats": dict(base, route=stats_route,
                                **held(f"xent_stats {what}", stats, pstats,
                                       torch.float32)),
             "xent_bwd_dh": dict(base, route=dh_route, **held_xent_bwd(
                 f"xent_bwd_dh {what}", [dh], [pdh], labels, vocab,
                 dtype)),
             "xent_bwd_dwb": dict(base, route=dwb_route, **held_xent_bwd(
                 f"xent_bwd_dwb {what}", [dw, db], [pdw, pdb], labels,
                 vocab, dtype))}
    if not timed:
        return cases
    ops = 2.0 * n * vocab * hid
    hl, wl = (t_.detach().requires_grad_(True) for t_ in (h, w))
    bl = bias.to(dtype).requires_grad_(True)
    rows = F.cross_entropy(F.linear(hl, wl, bl), labels, reduction="none",
                           ignore_index=-100)
    cases["xent_stats"].update(
        kernel_ms=time_ms(lambda: xe.xent_stats_kernel(*inputs)),
        plain_ms=time_ms(lambda: xe.xent_stats_plain(*inputs)),
        library_ms=time_ms(lambda: F.cross_entropy(
            F.linear(h, w, bl.detach()), labels, reduction="none")))
    cases["xent_stats"]["bound_ms"], cases["xent_stats"]["bound_by"] = \
        bound_ms(nbytes(*inputs) + 16 * n, ops, dtype)
    plain = time_ms(lambda: xe.xent_bwd_plain(*bwd_args))
    library = time_ms(lambda: torch.autograd.grad(
        rows, (hl, wl, bl), gg, retain_graph=True), graph=False)
    for name, fn, outs in (("xent_bwd_dh", xe.xent_bwd_dh_kernel, (dh,)),
                           ("xent_bwd_dwb", xe.xent_bwd_dwb_kernel,
                            (dw, db))):
        case = cases[name]
        case.update(kernel_ms=time_ms(lambda: fn(*bwd_args)),
                    plain_ms=plain, library_ms=library)
        case["bound_ms"], case["bound_by"] = bound_ms(
            nbytes(*inputs, logz, gg, *outs), 2 * ops, dtype)
    return cases


def attended_pairs(tq, tk, causal):
    """(query, key) pairs a causal (bottom-right) or full attention
    computes per head."""
    if not causal:
        return tq * tk
    return sum(min(tk, max(0, i + (tk - tq) + 1)) for i in range(tq))


#: a row that sees at most this many partners (the keys of a query, the
#: queries of a key) is also held on its own scale (:func:`held_flash`)
FEW = 64


def held_flash(name, outs, tol):
    """Hold K2's or K3's outputs, each a ``(label, got, want, parts)``
    with ``parts`` ``{part: bool [B, H, T] row selection}``: each output
    on its own scale (as :func:`held`), and again on its rows that see
    few partners and on its rows that see none, each on its own scale.
    The rows of a causal diagonal and the keys only the last queries see
    carry few terms, and a fault there (the diagonal moved, a key
    dropped) is small against the whole output's largest value; rows
    that see no partner must come out exactly 0, as the plain version
    gives them. Every part is measured before any is judged. Returns the
    case's fields: the largest absolute error and the worst error over
    scale of the whole outputs, each part's reading, and tol."""
    parts, failed = {}, []
    whole_err, whole_rel = 0.0, 0.0
    for label, got, want, sel in outs:
        for part, x, y in [(label, got, want)] + [
                (f"{label} {p}", got[m], want[m]) for p, m in sel.items()]:
            if not y.numel():
                continue
            err, rel = scaled_err(x, y)
            parts[part] = dict(max_abs_err=err, rel_err=rel)
            if part == label:
                whole_err, whole_rel = max(whole_err, err), max(whole_rel,
                                                                rel)
            if not (rel <= tol):
                failed.append(part)
    if failed:
        raise AssertionError(f"{name}: {', '.join(failed)} over tolerance "
                             f"{tol}; parts {json.dumps(parts)}")
    return dict(max_abs_err=whole_err, rel_err=whole_rel, tol=tol,
                parts=parts)


def sdpa_backward(q, k, v, do, scale, is_causal, mask):
    """The library yardstick of K3: one call of the backward that
    ``scaled_dot_product_attention`` runs on the H100 in bf16 (cuDNN's
    flash backward, ``aten._scaled_dot_product_cudnn_attention_backward``:
    dq, dk and dv from q, k, v, dO and its forward's out and logsumexp),
    as a function of no arguments, and True: time_ms captures it in a
    CUDA graph (the autograd call around it cannot be captured under
    causal, and timed uncaptured it reads the host's launch time at the
    small shapes). In f32, and with a key mask, SDPA takes another
    backend: there its autograd backward, and False (timed uncaptured)."""
    import torch.nn.functional as F
    if q.dtype == torch.bfloat16 and mask is None:
        aten = torch.ops.aten
        res = aten._scaled_dot_product_cudnn_attention(
            q, k, v, None, True, 0.0, is_causal, False, scale=scale)
        o, lse, cq, ck, mq, mk, seed, offset = res[:8]
        return (lambda: aten._scaled_dot_product_cudnn_attention_backward(
            do, q, k, v, o, lse, seed, offset, None, cq, ck, mq, mk, 0.0,
            is_causal, scale=scale)), True
    qg, kg, vg = (t_.detach().requires_grad_(True) for t_ in (q, k, v))
    out = F.scaled_dot_product_attention(
        qg, kg, vg, None if mask is None else mask[:, None, None, :],
        is_causal=is_causal, scale=scale)
    return (lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                        retain_graph=True)), False


def flash_parts(b, h, tq, tk, causal, mask, dev):
    """``(keys, query-row parts, key-row parts)`` of :func:`held_flash`:
    ``keys`` [B, H, Tq] counts the keys each query row sees; the parts
    select the rows that see 1 to FEW partners and those that see none."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    valid = fa._valid(tq, tk, causal, mask, dev).expand(b, 1, tq, tk)
    keys = valid.sum(-1).expand(b, h, tq)        # keys each query sees
    seen = valid.sum(-2).expand(b, h, tk)        # queries each key meets
    return keys, {"few keys": (keys >= 1) & (keys <= FEW),
                  "no keys": keys == 0}, {
        "few queries": (seen >= 1) & (seen <= FEW), "no queries": seen == 0}


def flash_cases(dev, gen, b, h, tq, tk, d, dtype, causal=False,
                lengths=None, timed=False, misaligned=False):
    """K2 and K3 on one attention: q, k, v and dO ``[B, H, T, D]`` drawn
    from ``gen``, scale D^-0.5, and with ``lengths`` a key-padding mask
    (batch row i attends its first ``lengths[i]`` keys; 0 masks every
    key, so its rows must come out exactly 0); ``misaligned`` puts each of
    them one element past a 16-byte boundary (a view the TMA routes
    copy). K2's out and K3's dq, dk
    and dv are each held against the plain versions (K3's from K2's own
    out and lse) by :func:`held_flash` at F32_TOL in f32 and
    FLASH_BF16_TOL in bf16, and K2's out also absolutely, within F32_TOL
    in f32 and BF16_TOL in bf16; K2's lse on the rows that see a key at
    F32_TOL of its scale and within F32_TOL absolutely, and exactly on the
    rows that see none. Each case records the route its launch took,
    which must be :func:`flash_route`'s (K2) or :func:`flash_bwd_route`'s
    (K3). Returns the three cases by
    kernel name. ``timed`` adds each kernel's time, its plain version's,
    one library call's (SDPA forward for K2, its autograd backward, all
    three gradients, for K3) and the bound, with the pairs a causal
    attention or the mask skips left out of the operations and
    exponentials."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    def randn(*shape):
        x = torch.randn(*shape, generator=gen).to(dev, dtype)
        if misaligned:
            buf = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
            x = buf[1:].view_as(x).copy_(x)
        return x

    q, do = randn(b, h, tq, d), randn(b, h, tq, d)
    k, v = randn(b, h, tk, d), randn(b, h, tk, d)
    mask = None
    if lengths is not None:
        mask = (torch.arange(tk, device=dev)[None, :]
                < torch.tensor(lengths, device=dev)[:, None])
    scale = d ** -0.5
    (out, lse), fwd_route = route_of("flash_attention",
                                     fa.flash_attention_kernel, q, k, v,
                                     scale, causal, mask)
    pout, plse = fa.chunked_attention(q, k, v, scale, causal, mask,
                                      return_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, scale, causal, mask)
    dq, dq_route = route_of("flash_attention_bwd_dq",
                            fa.flash_attention_bwd_dq_kernel, *bwd)
    (dk, dv), dkv_route = route_of("flash_attention_bwd_dkv",
                                   fa.flash_attention_bwd_dkv_kernel, *bwd)
    pdq, pdk, pdv = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                 scale, causal, mask)
    shape = [b, h, tq, tk, d]
    what = (f"{shape} {dtype} causal={causal} mask={lengths}"
            + (" misaligned" if misaligned else ""))
    for kernel, route in (("flash_attention", fwd_route),
                          ("flash_attention_bwd_dq", dq_route),
                          ("flash_attention_bwd_dkv", dkv_route)):
        want_route = expected_route(kernel, dict(dtype=str(dtype),
                                                 shape=shape))
        if route != want_route:
            raise AssertionError(f"{kernel} {what}: took the {route} "
                                 f"route, not {want_route}")
    keys, q_parts, k_parts = flash_parts(b, h, tq, tk, causal, mask, dev)
    tol = F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    base = dict(shape=shape, dtype=str(dtype), causal=causal,
                kv_mask=lengths, **({"misaligned": True} if misaligned
                                    else {}))
    cases, failed = {}, []
    for kernel, route, outs in (
            ("flash_attention", fwd_route, [("out", out, pout, q_parts)]),
            ("flash_attention_bwd_dq", dq_route, [("dq", dq, pdq, q_parts)]),
            ("flash_attention_bwd_dkv", dkv_route,
             [("dk", dk, pdk, k_parts), ("dv", dv, pdv, k_parts)])):
        try:                      # measure all three before judging any
            cases[kernel] = dict(base, route=route, **held_flash(
                f"{kernel} {what}", outs, tol))
        except AssertionError as e:
            failed.append(str(e))
    seeing = keys > 0
    try:
        check(f"flash_attention {what}: out",
              max_err(out, pout), F32_TOL if dtype == torch.float32
              else BF16_TOL)
    except AssertionError as e:
        failed.append(str(e))
    try:
        lse_held = held(f"flash lse {what}", [lse[seeing]], [plse[seeing]],
                        torch.float32)
        check(f"flash lse {what}", lse_held["max_abs_err"], F32_TOL)
        lse_err = lse_held["rel_err"]
        if not torch.equal(lse[~seeing], plse[~seeing]):
            raise AssertionError(f"flash lse {what}: rows that see no key "
                                 "differ from the plain version's")
    except AssertionError as e:
        failed.append(str(e))
    if failed:
        raise AssertionError("\n".join(failed))
    cases["flash_attention"]["lse_err"] = lse_err
    if not timed:
        return cases
    pairs = int(keys.sum())
    sdpa_mask = None if mask is None else mask[:, None, None, :]
    is_causal = causal and tq == tk and mask is None
    fwd = cases["flash_attention"]
    fwd.update(
        kernel_ms=time_ms(lambda: fa.flash_attention_kernel(
            q, k, v, scale, causal, mask)),
        plain_ms=time_ms(lambda: fa.chunked_attention(
            q, k, v, scale, causal, mask)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, sdpa_mask, is_causal=is_causal, scale=scale)))
    fwd["bound_ms"], fwd["bound_by"] = bound_ms(
        nbytes(q, k, v, out, lse), 4.0 * pairs * d, dtype, pairs)
    plain = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, lse, do, scale, causal, mask))
    backward, captured = sdpa_backward(q, k, v, do, scale, is_causal, mask)
    library = time_ms(backward, graph=captured)
    for name, fn, products, outs in (
            ("flash_attention_bwd_dq", fa.flash_attention_bwd_dq_kernel, 3,
             (dq,)),
            ("flash_attention_bwd_dkv", fa.flash_attention_bwd_dkv_kernel,
             4, (dk, dv))):
        case = cases[name]
        case.update(kernel_ms=time_ms(lambda: fn(*bwd)), plain_ms=plain,
                    library_ms=library)
        case["bound_ms"], case["bound_by"] = bound_ms(
            nbytes(q, k, v, do, lse, delta, *outs),
            2.0 * products * pairs * d, dtype, pairs)
    return cases


# --------------------------------------------------------------- kernels

def floor_ms(dev):
    """:func:`time_ms` of a CUDA graph of one empty kernel: the floor
    under every kernel time this script reports (graph launch, events,
    the memset's tail)."""
    import ctypes

    from paddle_tpu_torch.ops.cuda import core
    lib = core.library()
    lib.ptt_empty.argtypes = [ctypes.c_void_p]
    lib.ptt_empty.restype = ctypes.c_int
    anchor = torch.empty(1, device=dev)
    # the stream is read at each call: capture runs on a stream of its own
    return time_ms(lambda: lib.ptt_empty(core.stream(anchor)))


def layer_norm_cases(randn):
    """K1 at the serving path's rows (8 decode rows, 32 verify rows of
    serve_spec's window and 512 prefill rows of 768, f32, all timed),
    ragged rows, BertConfig.large()'s C = 1024,
    C of whole packs but not of whole warps of packs, C off the 16-byte
    pack and past the row route's widest (both the simt route), and a
    view that does not start on 16 bytes. Each case records the route it
    took, which must be :func:`ln_route`'s."""
    from paddle_tpu_torch.ops.cuda import layer_norm as ln
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for rows, cols, dtype, offset in (
            (8, 768, f32, 0), (32, 768, f32, 0), (512, 768, f32, 0),
            (13, 768, f32, 0),
            (37, 768, bf16, 0), (8, 1024, f32, 0), (64, 1024, bf16, 0),
            (5, 200, bf16, 0), (13, 770, bf16, 0), (9, 771, f32, 0),
            (7, 4096, f32, 0), (29, 768, bf16, 1)):
        x = randn(rows * cols + offset, dtype=dtype)[offset:].view(rows,
                                                                   cols)
        gam = randn(cols, dtype=dtype) * 0.1 + 1.0
        bet = randn(cols, dtype=dtype) * 0.1
        (y, m, r), route = route_of("layer_norm", ln.layer_norm_kernel, x,
                                    gam, bet, 1e-5)
        py, pm, pr = ln.layer_norm_plain(x, gam, bet, 1e-5)
        tol = F32_TOL if dtype == f32 else BF16_TOL
        err = max(max_err(y, py), max_err(m, pm), max_err(r, pr))
        check(f"layer_norm {rows}x{cols} {dtype}", err, tol)
        case = dict(shape=[rows, cols], dtype=str(dtype), route=route,
                    misaligned=bool(offset), max_abs_err=err, tol=tol)
        if dtype == f32 and cols == 768 and rows in (8, 32, 512):
            case.update(ln_timing(x, gam, bet))
        cases.append(case)
    return cases


def ln_timing(x, gam, bet):
    """K1's times on ``x`` (kernel, plain version, ``F.layer_norm``) and
    its bound: x read and y written once, the scale and bias read once,
    the f32 mean and rstd written, 8 operations an element."""
    from paddle_tpu_torch.ops.cuda import layer_norm as ln
    rows, cols = x.shape
    out = dict(
        kernel_ms=time_ms(lambda: ln.layer_norm_kernel(x, gam, bet, 1e-5)),
        plain_ms=time_ms(lambda: ln.layer_norm_plain(x, gam, bet, 1e-5)),
        library_ms=time_ms(lambda: torch.nn.functional.layer_norm(
            x, (cols,), gam, bet, 1e-5)))
    out["bound_ms"], out["bound_by"] = bound_ms(
        2 * nbytes(x) + nbytes(gam, bet) + 8 * rows, 8 * x.numel(), x.dtype)
    return out


def held_decode(name, got, want, lengths, tol=F32_TOL):
    """K7's check: the output within ``tol`` of the plain version's, and
    exactly 0 on every slot of length 0. Returns the largest error."""
    err = max_err(got, want)
    check(name, err, tol)
    zero = [i for i, v in enumerate(lengths) if v == 0]
    if zero and float(got[zero].abs().max()) != 0.0:
        raise AssertionError(f"{name}: a length-0 slot is not exactly 0")
    return err


def decode_pool(dev, randn, rs, slots, heads, hd, ps, pmax, pool_dtype):
    """A pool of ``slots x pmax`` pages, every row written (int8 rows
    quantised with their scales), and a page table that is a seeded
    permutation of the pages."""
    from paddle_tpu_torch.ops.attention import init_page_pool, paged_write
    n = slots * pmax
    kv_dtype = torch.int8 if pool_dtype == torch.int8 else None
    pool = init_page_pool(n, heads, ps, hd,
                          dtype=torch.float32 if kv_dtype else pool_dtype,
                          kv_dtype=kv_dtype, device=dev)
    perm = torch.from_numpy(rs.permutation(n).astype(np.int32))
    ptab = perm.reshape(slots, pmax).to(dev)
    ids = ptab.reshape(-1).long()
    for lo in range(0, n, 256):          # 256 pages a write
        part = ids[lo:lo + 256]
        rows = part.numel() * ps
        paged_write(pool, randn(rows, heads, hd), randn(rows, heads, hd),
                    part.repeat_interleave(ps),
                    torch.arange(ps, device=dev).repeat(part.numel()))
    return pool, ptab


def decode_cases(dev, randn):
    """K7 at the serve path's shape (8 slots x 12 heads, page size 64,
    hd 64, bf16 pool, lengths from RandomState(0); timed), lengths on and
    one past the split route's boundaries, length 0 and 1, int8 and f32
    pools, hd 128, hd 40 (whole chunks that are not a power of two of
    lanes), hd 36 (the simt route), 4 slots of up to 4096 tokens (32
    splits: a merge of more than 16 partials), and a long context (32
    slots x 2048 tokens, bf16; timed). Each case records its route,
    which must be :func:`decode_route`'s; a split-route case must give
    bitwise equal outputs in two launches."""
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    rs = np.random.RandomState(0)
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    cases = []
    for lengths, pool_dtype, hd, pmax, timed in (
            (list(rs.randint(1, 1025, 8)), bf16, 64, 16, True),
            ([0, 1, 63, 64, 65, 700, 1024, 129], bf16, 64, 16, False),
            ([0, 5, 64, 300, 1000, 17, 128, 1], i8, 64, 16, False),
            ([37, 0, 200, 64, 1, 511, 66, 900], f32, 64, 16, False),
            ([0, 1, 127, 128, 129, 640, 1024, 65], bf16, 128, 16, False),
            ([3, 0, 200, 64, 1, 77, 130, 500], f32, 40, 8, False),
            ([37, 0, 200, 64, 1, 511, 66, 900], f32, 36, 16, False),
            ([4000, 0, 4096, 63], bf16, 64, 64, False),
            ([2048] * 32, bf16, 64, 32, True)):
        s_slots, h, ps = len(lengths), 12, 64
        pool, ptab = decode_pool(dev, randn, rs, s_slots, h, hd, ps, pmax,
                                 pool_dtype)
        lens = torch.tensor([int(v) for v in lengths], dtype=torch.int32,
                            device=dev)
        q = randn(s_slots, h, hd)
        scale = hd ** -0.5
        ks, vs = pool.get("k_scale"), pool.get("v_scale")
        args = (q, pool["k"], pool["v"], ptab, lens, scale, ks, vs)
        out, route = route_of("decode_attention", da.paged_decode_kernel,
                              *args)
        ref = da.paged_attention_plain(*args)
        what = f"decode {s_slots} slots hd {hd} {pool_dtype}"
        err = held_decode(what, out, ref, lengths)
        case = dict(lengths=[int(v) for v in lengths], pool=str(pool_dtype),
                    shape=[s_slots, h, hd, ps, pmax], route=route,
                    max_abs_err=err, tol=F32_TOL)
        if route == "split":
            sms = torch.cuda.get_device_properties(
                dev).multi_processor_count
            case["splits"], case["per"] = da.split_plan(s_slots, h, pmax,
                                                        sms)
            if not torch.equal(out, da.paged_decode_kernel(*args)):
                raise AssertionError(f"{what}: two launches differ")
            case["bitwise_repeatable"] = True
        if timed:
            live = int(lens.sum())
            elem = pool["k"].element_size()
            read = 2 * live * h * hd * elem + nbytes(q, ptab, lens, out)
            case["kernel_ms"] = time_ms(lambda: da.paged_decode_kernel(
                *args))
            case["plain_ms"] = time_ms(lambda: da.paged_attention_plain(
                *args))
            case["library_ms"] = None
            case["bound_ms"], case["bound_by"] = bound_ms(
                read, 4.0 * live * h * hd, pool_dtype)
        cases.append(case)
        del pool, ptab, ref
    return cases


#: K4's f32 cases (rows, I), each taken on the route mlp_route gives:
#: decode (8 rows), verify (32: 8 slots x a window of 4), serve's 512-row
#: and serve_fleet's 256-row prefill chunks at 768/3072, all timed;
#: then ragged rows and I on both sides of the split/gemm threshold
MLP_TIMED = ((8, 3072), (32, 3072), (512, 3072), (256, 3072))
MLP_RAGGED = ((13, 3000), (33, 3000), (300, 3000), (1, 72))


def mlp_cases(randn, timed=True):
    """K4 at :data:`MLP_TIMED` and :data:`MLP_RAGGED` in f32 and at 40
    rows in bf16 (the tc route), each held against the plain version
    (in f32) within F32_TOL in f32 and BF16_TOL in bf16, its route
    recorded; the timed cases (``timed``) with the kernel's, the plain
    version's and ``F.linear`` + gelu + ``F.linear``'s times and the
    bound. ``randn(*shape, dtype=, scale=)`` draws on the card."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import mlp
    cases = []
    for rows, inter, dtype in ([(r, i, torch.float32) for r, i in
                                MLP_TIMED + MLP_RAGGED]
                               + [(40, 3072, torch.bfloat16)]):
        x = randn(rows, 768, dtype=dtype)
        w1 = randn(768, inter, dtype=dtype, scale=0.036)
        b1 = randn(inter, dtype=dtype, scale=0.02)
        w2 = randn(inter, 768, dtype=dtype, scale=0.036)
        b2 = randn(768, dtype=dtype, scale=0.02)
        out, route = route_of("mlp", mlp.mlp_kernel, x, w1, b1, w2, b2)
        ref = mlp.mlp_plain(x.float(), w1.float(), b1.float(), w2.float(),
                            b2.float())
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        err = max_err(out, ref)
        check(f"mlp {rows}x768x{inter} {dtype} ({route})", err, tol)
        case = dict(shape=[rows, 768, inter, 768], dtype=str(dtype),
                    route=route, max_abs_err=err, tol=tol)
        if timed and (rows, inter) in MLP_TIMED and dtype == torch.float32:
            w1t, w2t = w1.t(), w2.t()
            case["kernel_ms"] = time_ms(
                lambda: mlp.mlp_kernel(x, w1, b1, w2, b2))
            case["plain_ms"] = time_ms(
                lambda: mlp.mlp_plain(x, w1, b1, w2, b2))
            case["library_ms"] = time_ms(
                lambda: F.linear(F.gelu(F.linear(x, w1t, b1)), w2t, b2))
            case["bound_ms"], case["bound_by"] = bound_ms(
                nbytes(x, w1, b1, w2, b2, out),
                2.0 * rows * inter * (768 + 768), dtype)
        cases.append(case)
    return cases


def kernel_cases(dev):
    """Per kernel: the serving path's shapes first (the case reported in
    the kernels line), then the ragged set."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    results = {}

    results["layer_norm"] = layer_norm_cases(randn)

    # K2 flash attention: first-chunk prefill [1, 12, 512, 64] causal
    cases = []
    for b, h, tq, tk, dtype, causal, masked in (
            (1, 12, 512, 512, torch.float32, True, False),
            (2, 3, 200, 200, torch.float32, True, False),
            (1, 4, 100, 300, torch.float32, True, False),
            (2, 2, 130, 130, torch.float32, False, True),
            (1, 4, 256, 256, torch.bfloat16, True, False)):
        q, k, v = (randn(b, h, t, 64, dtype=dtype)
                   for t in (tq, tk, tk))
        mask = None
        if masked:
            mask = torch.ones(b, tk, dtype=torch.bool, device=dev)
            mask[0, tk // 2:] = False
            mask[1, :] = False               # fully masked rows -> 0
        scale = 1.0 / 8.0
        (out, lse), route = route_of("flash_attention",
                                     fa.flash_attention_kernel, q, k, v,
                                     scale, causal, mask)
        pout, plse = fa.chunked_attention(q, k, v, scale, causal, mask,
                                          return_lse=True)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        err = max_err(out, pout)
        if masked and float(out[1].abs().max()) != 0.0:
            raise AssertionError("flash: fully masked rows are not 0")
        lse_err = max_err(lse, plse) if not masked else 0.0
        check(f"flash {b}x{h}x{tq}x{tk} {dtype}", max(err, lse_err), tol)
        case = dict(shape=[b, h, tq, tk, 64], dtype=str(dtype),
                    causal=causal, masked=masked, route=route,
                    max_abs_err=err, lse_err=lse_err, tol=tol)
        if len(cases) == 0:
            pairs = b * h * attended_pairs(tq, tk, causal)
            case["kernel_ms"] = time_ms(lambda: fa.flash_attention_kernel(
                q, k, v, scale, causal))
            case["plain_ms"] = time_ms(lambda: fa.chunked_attention(
                q, k, v, scale, causal))
            case["library_ms"] = time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True, scale=scale))
            case["bound_ms"], case["bound_by"] = bound_ms(
                nbytes(q, k, v, out, lse), 4.0 * pairs * 64, dtype, pairs)
        cases.append(case)
    results["flash_attention"] = cases

    results["mlp"] = mlp_cases(randn)

    results["decode_attention"] = decode_cases(dev, randn)
    return results


def train_kernel_cases(dev):
    """The training path's kernels at the train step's shapes (GPTConfig
    .small(), batch 16 x seq 512, bf16 compute) — the case reported in the
    kernels line comes first — then the same shapes in f32 and ragged
    shapes; plus K1, K2 and K4 at the train step's shapes."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import layer_norm as ln, mlp
    g = torch.Generator(device="cpu").manual_seed(1)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    results = {"flash_train": [], "xent_stats": [], "xent_bwd_dh": [],
               "xent_bwd_dwb": [], "train_shapes": []}

    # K1, K2, K4 at the train step's shapes (bf16 rows of 16 x 512)
    x = randn(8192, 768, dtype=bf16)
    gam, bet = randn(768, dtype=bf16) * 0.1 + 1.0, randn(768, dtype=bf16)
    got, route = route_of("layer_norm", ln.layer_norm_kernel, x, gam, bet,
                          1e-5)
    case = dict(kernel="layer_norm", shape=[8192, 768], dtype="bf16",
                route=route,
                **held("layer_norm train shape", got,
                       ln.layer_norm_plain(x, gam, bet, 1e-5), bf16),
                **ln_timing(x, gam, bet))
    results["train_shapes"].append(case)

    w1, b1 = randn(768, 3072, dtype=bf16, scale=0.036), randn(
        3072, dtype=bf16, scale=0.02)
    w2, b2 = randn(3072, 768, dtype=bf16, scale=0.036), randn(
        768, dtype=bf16, scale=0.02)
    out, route = route_of("mlp", mlp.mlp_kernel, x, w1, b1, w2, b2)
    case = dict(kernel="mlp", shape=[8192, 768, 3072, 768], dtype="bf16",
                route=route,
                **held("mlp train shape", [out], [mlp.mlp_plain(
                    x.float(), w1.float(), b1.float(), w2.float(),
                    b2.float())], bf16),
                kernel_ms=time_ms(lambda: mlp.mlp_kernel(x, w1, b1, w2, b2)),
                plain_ms=time_ms(lambda: mlp.mlp_plain(x, w1, b1, w2, b2)),
                library_ms=time_ms(lambda: F.linear(F.gelu(F.linear(
                    x, w1.t(), b1)), w2.t(), b2)))
    case["bound_ms"], case["bound_by"] = bound_ms(
        nbytes(x, w1, b1, w2, b2, out), 2.0 * 8192 * 3072 * 1536, bf16)
    results["train_shapes"].append(case)

    # K2 and K3 (flash_cases): GPT-train's [16, 12, 512, 512, 64] causal
    # in bf16 (the tc routes) and f32 (K2 simt, K3 tf32x3), and at D = 32
    # in f32 (K3's simt route), all timed; then the tc route at Tq != Tk,
    # ragged T with key masks and fully masked rows, T not a multiple of
    # 64, at D = 64 and 128; then K3's tf32x3 route at Tq != Tk, a key
    # mask with fully masked rows, 2048 keys (32 tiles summed on the
    # tensor cores) and a misaligned view; then the simt routes' ragged
    # and narrow head dims
    f32 = torch.float32
    for spec, causal, lengths, timed in (
            ((16, 12, 512, 512, 64, bf16), True, None, True),
            ((16, 12, 512, 512, 64, f32), True, None, True),
            ((16, 12, 512, 512, 32, f32), True, None, True),
            ((1, 4, 100, 300, 64, bf16), True, None, False),
            ((3, 4, 200, 200, 64, bf16), True, (200, 137, 0), False),
            ((3, 4, 200, 200, 128, bf16), False, (190, 61, 0), False),
            ((2, 3, 130, 130, 128, bf16), True, None, False),
            ((2, 3, 70, 70, 64, bf16), False, None, False),
            ((1, 4, 300, 100, 128, bf16), True, (77,), False),
            ((1, 4, 100, 300, 64, f32), True, None, False),
            ((1, 4, 300, 100, 64, f32), True, (77,), False),
            ((3, 4, 200, 200, 64, f32), True, (200, 137, 0), False),
            ((1, 2, 2048, 2048, 64, f32), True, None, False),
            ((2, 3, 200, 200, 64, torch.float32), True, None, False),
            ((1, 4, 100, 300, 32, torch.float32), True, None, False),
            ((2, 2, 130, 130, 128, torch.float32), False, (43, 0), False),
            ((1, 2, 70, 70, 16, bf16), True, (0,), False)):
        for name, case in flash_cases(dev, g, *spec, causal=causal,
                                      lengths=lengths, timed=timed).items():
            results["flash_train"].append(dict(kernel=name, **case))
    for name, case in flash_cases(dev, g, 2, 2, 130, 130, 64, f32,
                                  lengths=(43, 0), misaligned=True).items():
        results["flash_train"].append(dict(kernel=name, **case))

    # K5 and K6: [16 x 511, 768] rows against the tied [32000, 768] table
    # in bf16 (the tc routes) and f32 (tf32x3), both timed; the program
    # path's 8 x 511 rows in f32; then ragged shapes, f32 with H % 4 != 0
    # on the SIMT kernels among them
    for i, spec in enumerate((
            (8176, 32000, 768, bf16, 0.0, False),
            (8176, 32000, 768, torch.float32, 0.0, False),
            (4088, 32000, 768, torch.float32, 0.0, False),
            (37, 300, 96, torch.float32, 0.1, True),
            (45, 700, 66, torch.float32, 0.0, True),
            (78, 300, 128, torch.float32, 0.1, True),
            (130, 1000, 768, torch.float32, 0.0, True),
            (37, 65, 96, bf16, 0.1, True),
            (1000, 5000, 640, bf16, 0.0, False),
            (300, 2000, 1024, bf16, 0.1, True),
            (130, 1000, 1024, torch.float32, 0.0, True),
            (200, 3000, 576, bf16, 0.0, True))):
        for name, case in xent_cases(dev, g, *spec, timed=i < 2).items():
            results[name].append(case)
    return results


def bert_kernel_cases(dev):
    """K8 at the BERT step's shape ([64 x 512, 768] bf16, the case reported
    in the kernels line), in f32 and at ragged shapes; then K1-K6 at the
    BERT step's shapes (bf16; attention not causal, with a padded
    key mask in a ragged case; a 30522 vocab with an f32 bias), each
    timed beside its plain version, its bound and one library call."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import layer_norm as ln, mlp
    g = torch.Generator(device="cpu").manual_seed(2)
    bf16 = torch.bfloat16
    rows, hid, inter, vocab, n_mask = 64 * 512, 768, 3072, 30522, 64 * 76

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    results = {"add_layer_norm": [], "bert_shapes": []}

    # K8: the train shape in bf16 and f32, then R not a multiple of the 8
    # rows per block, C not a multiple of 32, C not a multiple of the
    # 16-byte pack, and a view whose data is not 16-byte aligned
    for r_, c_, dtype, offset in ((rows, hid, bf16, 0),
                                  (rows, hid, torch.float32, 0),
                                  (1000, 200, bf16, 0),
                                  (37, 96, torch.float32, 0),
                                  (13, 770, bf16, 0),
                                  (29, 768, torch.float32, 1)):
        x = randn(r_ * c_ + offset, dtype=dtype)[offset:].view(r_, c_)
        h = randn(r_, c_, dtype=dtype)
        gam = randn(c_, dtype=dtype, scale=0.1) + 1.0
        bet = randn(c_, dtype=dtype, scale=0.1)
        got = ln.add_layer_norm_kernel(x, h, gam, bet, 1e-5)
        case = dict(shape=[r_, c_], dtype=str(dtype), misaligned=bool(offset),
                    **held(f"add_layer_norm {[r_, c_]} {dtype}", got,
                           ln.add_layer_norm_plain(x, h, gam, bet, 1e-5),
                           dtype))
        if not results["add_layer_norm"]:
            case.update(
                kernel_ms=time_ms(lambda: ln.add_layer_norm_kernel(
                    x, h, gam, bet, 1e-5)),
                plain_ms=time_ms(lambda: ln.add_layer_norm_plain(
                    x, h, gam, bet, 1e-5)),
                library_ms=time_ms(lambda: F.layer_norm(
                    x + h, (c_,), gam, bet, 1e-5)),
                library="F.layer_norm(x + h): two library calls")
            case["bound_ms"], case["bound_by"] = bound_ms(
                nbytes(x, h, gam, bet, *got), 10 * x.numel(), dtype)
        results["add_layer_norm"].append(case)

    # K1 (emb_ln) and K4 at the 32768 rows of the step
    x = randn(rows, hid, dtype=bf16)
    gam, bet = randn(hid, dtype=bf16) * 0.1 + 1.0, randn(hid, dtype=bf16)
    got, route = route_of("layer_norm", ln.layer_norm_kernel, x, gam, bet,
                          1e-5)
    case = dict(kernel="layer_norm", shape=[rows, hid], dtype="bf16",
                route=route,
                **held("layer_norm bert shape", got,
                       ln.layer_norm_plain(x, gam, bet, 1e-5), bf16),
                **ln_timing(x, gam, bet))
    results["bert_shapes"].append(case)

    # K4 (the tc route) at BertConfig.base()'s [32768, 768] x [768, 3072]
    # and BertConfig.large()'s bert_large rows (8 x 512) x [1024, 4096]
    del x
    for r_, h_, i_, config in ((rows, hid, inter, "BertConfig.base()"),
                               (8 * 512, 1024, 4096, "BertConfig.large()")):
        x = randn(r_, h_, dtype=bf16)
        w1, b1 = randn(h_, i_, dtype=bf16, scale=h_ ** -0.5), randn(
            i_, dtype=bf16, scale=0.02)
        w2, b2 = randn(i_, h_, dtype=bf16, scale=i_ ** -0.5), randn(
            h_, dtype=bf16, scale=0.02)
        out, route = route_of("mlp", mlp.mlp_kernel, x, w1, b1, w2, b2)
        case = dict(kernel="mlp", config=config, shape=[r_, h_, i_, h_],
                    dtype="bf16", route=route,
                    **held(f"mlp {config}", [out], [mlp.mlp_plain(
                        x.float(), w1.float(), b1.float(), w2.float(),
                        b2.float())], bf16),
                    kernel_ms=time_ms(lambda: mlp.mlp_kernel(
                        x, w1, b1, w2, b2)),
                    plain_ms=time_ms(lambda: mlp.mlp_plain(
                        x, w1, b1, w2, b2)),
                    library_ms=time_ms(lambda: F.linear(F.gelu(F.linear(
                        x, w1.t(), b1)), w2.t(), b2)))
        case["bound_ms"], case["bound_by"] = bound_ms(
            nbytes(x, w1, b1, w2, b2, out), 2.0 * r_ * i_ * 2 * h_, bf16)
        results["bert_shapes"].append(case)
        del x, out, w1, w2

    # K2 and K3 (flash_cases): BertConfig.base()'s [64, 12, 512, 512, 64]
    # and BertConfig.large()'s bert_large [8, 16, 512, 512, 64], bf16 not
    # causal (timed), then ragged batches padded by a key mask
    for spec, lengths, timed, config in (
            ((64, 12, 512, 512, 64, bf16), None, True, "BertConfig.base()"),
            ((8, 16, 512, 512, 64, bf16), None, True, "BertConfig.large()"),
            ((3, 12, 200, 200, 64, bf16), (200, 137, 61), False, None),
            ((2, 4, 90, 90, 64, torch.float32), (90, 33), False, None)):
        for name, case in flash_cases(dev, g, *spec, lengths=lengths,
                                      timed=timed).items():
            results["bert_shapes"].append(dict(kernel=name, config=config,
                                               **case))
        torch.cuda.empty_cache()

    # K5 and K6: 64 x 76 gathered rows against the tied [V, H] table and
    # the f32 MLM bias, at BertConfig.base()'s V = 30522, H = 768 and
    # BertConfig.large()'s H = 1024 (timed), and ErnieConfig.base()'s
    # 18000-token vocabulary at H = 768
    for width, vocab_, config, timed in (
            (hid, vocab, "BertConfig.base()", True),
            (1024, vocab, "BertConfig.large()", True),
            (hid, 18000, "ErnieConfig.base()", False)):
        for name, case in xent_cases(dev, g, n_mask, vocab_, width, bf16,
                                     timed=timed).items():
            results["bert_shapes"].append(dict(kernel=name, config=config,
                                               vocab=vocab_, **case))
    return results


# ------------------------------------------------------------------ serve

def drive(model, cfg_kw, submissions, plan=None):
    """Submit ``[(prompt, max_new, submit kwargs)]`` to a fresh engine and
    drain it step by step, under the faults of ``plan`` if given; returns
    (engine, requests, stats). Every request must finish with its
    ``max_new`` tokens, all in the vocabulary, and no step may have been
    recovered unless ``plan`` injected a fault."""
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    from paddle_tpu_torch.testing import chaos
    eng = ServingEngine(model, ServeConfig(**cfg_kw))
    eng.reset_stats()         # the latency histograms are process-wide
    vocab = model.cfg.vocab_size
    rids = [eng.submit(prompt, max_new=max_new, **kw)
            for prompt, max_new, kw in submissions]
    steps = []
    t0 = time.perf_counter()
    with chaos.active(plan) if plan else contextlib.nullcontext():
        while eng._queue or eng._running:
            s0 = time.perf_counter()
            eng.step()
            steps.append(time.perf_counter() - s0)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reqs = [eng.requests[r] for r in rids]
    for r, (_, max_new, _) in zip(reqs, submissions):
        if r.status != "done" or len(r.tokens) != max_new:
            raise AssertionError(f"request {r.id}: {r.status}, "
                                 f"{len(r.tokens)} tokens")
        if not all(0 <= t < vocab for t in r.tokens):
            raise AssertionError(f"request {r.id}: token out of range")
    if plan is None and eng.recoveries:
        raise AssertionError(f"{eng.recoveries} steps recovered in a run "
                             "without injected faults")
    if not 0 < eng.staged_prefills == eng.prefill_calls:
        raise AssertionError(f"{eng.staged_prefills} of {eng.prefill_calls} "
                             "prefill calls read a staged prompt chunk")
    gen = sum(len(r.tokens) for r in reqs)
    ttft = sorted((r.first_token_t - r.submit_t) * 1e3 for r in reqs)
    stats = dict(requests=len(reqs),
                 prompt_lens=[int(r.prompt.size) for r in reqs],
                 generated_tokens=gen, wall_s=wall,
                 decoded_tokens_per_s=gen / wall,
                 p50_ttft_ms=float(np.median(ttft)),
                 p50_step_ms=float(np.median(steps)) * 1e3,
                 steps=len(steps), decode_steps=eng.decode_steps,
                 prefill_calls=eng.prefill_calls,
                 staged_prefills=eng.staged_prefills,
                 kv_pool_bytes=eng.kv_pool_bytes())
    return eng, reqs, stats


def serve_wave(vocab, num_requests, prompt_range, long_prompt, max_new,
               seed, sampled=False):
    """``num_requests`` random prompts with lengths uniform in
    ``prompt_range`` (no two share a page), then one of ``long_prompt``
    tokens if given, ``max_new`` new tokens each; with ``sampled`` the odd
    ids sample (SAMPLED, explicit seeds). ``[(prompt, max_new, submit
    kwargs)]``."""
    rs = np.random.RandomState(seed)
    lens = list(rs.randint(prompt_range[0], prompt_range[1] + 1,
                           num_requests))
    if long_prompt:
        lens.append(long_prompt)
    return [(rs.randint(0, vocab, n).astype(np.int32), max_new,
             dict(SAMPLED, seed=1000 + i) if sampled and i % 2 else {})
            for i, n in enumerate(lens)]


def serve(model, num_requests, prompt_range, long_prompt, max_new, cfg_kw,
          seed):
    """Submit :func:`serve_wave`'s prompts and drain them; returns
    (engine, request ids, stats). The prefix cache is on, as by default,
    and must find nothing to share."""
    wave = serve_wave(model.cfg.vocab_size, num_requests, prompt_range,
                      long_prompt, max_new, seed)
    eng, reqs, stats = drive(model, cfg_kw, wave)
    if eng.prefix_hits or eng.prefill_tokens_skipped:
        raise AssertionError(f"random prompts hit {eng.prefix_hits} cached "
                             "pages")
    stats["prefix_hits"] = eng.prefix_hits
    return eng, [r.id for r in reqs], stats


@torch.inference_mode()
def teacher_forced_logits(model, prompt, tokens, page_size, prefill_len,
                          cache_dtype, kv_dtype=None):
    """Replay ``prompt`` then ``tokens[:-1]`` through the served path
    (chunked paged prefill, then one paged decode step per token) in one
    slot; returns the logits that chose each of ``tokens``
    ``[len(tokens), V]``."""
    dev = model.device
    total = len(prompt) + len(tokens)
    pages = -(-total // page_size)
    caches = model.init_paged_caches(pages, page_size, dtype=cache_dtype,
                                     kv_dtype=kv_dtype)
    ptab = torch.arange(pages, dtype=torch.int32, device=dev)[None, :]
    out = []
    for start in range(0, len(prompt), prefill_len):
        clen = min(prefill_len, len(prompt) - start)
        window = torch.zeros((1, prefill_len), dtype=torch.int32)
        window[0, :clen] = torch.from_numpy(prompt[start:start + clen])
        logits, caches = model.paged_prefill_chunk(
            window.to(dev), torch.tensor([start], dtype=torch.int32),
            torch.tensor([clen], dtype=torch.int32), caches, ptab)
    out.append(logits[0].float().cpu())
    one = torch.ones(1, dtype=torch.bool, device=dev)
    for i, tok in enumerate(tokens[:-1]):
        length = torch.tensor([len(prompt) + i], dtype=torch.int32,
                              device=dev)
        logits, caches = model.paged_decode_step(
            torch.tensor([tok], dtype=torch.int32, device=dev), caches,
            ptab, length, one)
        out.append(logits[0].float().cpu())
    return torch.stack(out)


def crosscheck(card_model, cpu_model, reqs, page_size, prefill_len,
               reference=None):
    """Teacher-force each request's card tokens through the card (bf16
    cache) and the CPU plain path (f32 cache); the logits must agree
    within SERVE_LOGIT_TOL. A greedy request's every token must also be
    the CPU's argmax there, or within SERVE_LOGIT_TOL of it (a near tie
    the bf16 cache may flip). With ``reference`` (request id -> the
    tokens another run served it), a greedy request must equal them up
    to its end or to a step where the two tokens are such a near tie on
    the CPU (the runs part there, and each goes on by its own argmax)."""
    rows = []
    for req in reqs:
        card = teacher_forced_logits(card_model, req.prompt, req.tokens,
                                     page_size, prefill_len,
                                     torch.bfloat16)
        cpu = teacher_forced_logits(cpu_model, req.prompt, req.tokens,
                                    page_size, prefill_len, torch.float32)
        err = float((card - cpu).abs().max())
        toks = torch.as_tensor(req.tokens)
        served = cpu.gather(1, toks[:, None])[:, 0]
        short = cpu.max(-1).values - served      # 0 where it is the argmax
        check(f"crosscheck request {req.id}", err, SERVE_LOGIT_TOL)
        row = dict(request=req.id, prompt_len=int(req.prompt.size),
                   logits_max_abs_err=err, tol=SERVE_LOGIT_TOL,
                   greedy_agreement=float((short == 0).float().mean()))
        if req.temperature == 0:
            worst = float(short.max())
            if worst > SERVE_LOGIT_TOL:
                raise AssertionError(
                    f"crosscheck request {req.id}: token "
                    f"{int(short.argmax())} is {worst} below the CPU's "
                    f"argmax (tol {SERVE_LOGIT_TOL})")
            row["near_ties"] = int((short > 0).sum())
        if reference is not None and req.temperature == 0:
            ref = list(reference[req.id])
            part = next((i for i, (a, b) in enumerate(zip(req.tokens, ref))
                         if a != b), None)
            row["token_exact_vs_reference"] = part is None
            if part is not None:
                gap = float((cpu[part, req.tokens[part]]
                             - cpu[part, ref[part]]).abs())
                row.update(parts_at=part, gap_there=gap)
                if gap > SERVE_LOGIT_TOL:
                    raise AssertionError(
                        f"crosscheck request {req.id}: parts from its "
                        f"reference at token {part}, where the CPU logits "
                        f"of the two tokens differ by {gap} (tol "
                        f"{SERVE_LOGIT_TOL})")
        rows.append(row)
    return rows


# ----------------------------------------------------------- serve_shared

SHARED_SYSTEM = 576      # system prompt: 9 pages of 64, so a hit skips the
#                          first 512-token chunk and the continuation chunk
#                          reads the shared pages
SHARED_GROUPS = 4
SHARED_NEW = 64
#: the pool of serve_shared's cached run: below 8 slots x 13 pages (the
#: most a request of the wave needs), small enough that the run evicts
#: idle cached pages and preempts
SHARED_PAGES = 30
#: the fault run's serve.step fault: at the first decode step from the
#: SHARED_FAULT_AT-th hook event on (mid-wave, with slots in flight)
SHARED_FAULT_AT = 120
#: the wave's seed: its suffix lengths give the pool above a preemption
SHARED_SEED = 8
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)


def shared_wave(vocab, seed):
    """serve_shared's traffic: SHARED_GROUPS system prompts of
    SHARED_SYSTEM tokens, each followed by 6 requests with unique
    suffixes uniform in [16, 192] tokens and 2 that repeat the bare system
    prompt (their match ends inside its last page: copy-on-write);
    SHARED_NEW new tokens each. Even ids are greedy, odd ids sample
    (SAMPLED) with explicit seeds. ``[(prompt, max_new, submit
    kwargs)]``."""
    rs = np.random.RandomState(seed)
    # lengths first: the schedule (pages, preemptions) depends on them
    # alone, so it is the same for any vocabulary
    suffix_lens = rs.randint(16, 193, (SHARED_GROUPS, 6))
    wave = []
    for g in range(SHARED_GROUPS):
        system = rs.randint(0, vocab, SHARED_SYSTEM).astype(np.int32)
        for j in range(8):
            prompt = system.copy()
            if j < 6:
                suffix = rs.randint(0, vocab, suffix_lens[g, j])
                prompt = np.concatenate([system, suffix.astype(np.int32)])
            i = len(wave)
            wave.append((prompt, SHARED_NEW,
                         dict(SAMPLED, seed=1000 + i) if i % 2 else {}))
    return wave


def sampling_ms(vocab, slots, iters=50):
    """Wall ms a call of the engine's sampler (every row sampled, as a
    decode step with a sampled request runs it) and of the greedy
    ``argmax``, on ``[slots, vocab]`` f32 logits on the card: ``iters``
    calls, then one synchronize. The decode step is host-bound, so this
    is the host time sampling adds to a step."""
    from paddle_tpu_torch.serving.sampling import sample
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    logits = torch.randn(slots, vocab, device=dev, generator=gen)
    knobs = [torch.full((slots,), v, device=dev) for v in
             (SAMPLED["temperature"], SAMPLED["top_k"], SAMPLED["top_p"])]
    seeds = torch.arange(slots, device=dev)
    out = {}
    for name, fn in (("sample", lambda: sample(logits, *knobs, seeds, seeds,
                                               0)),
                     ("argmax", lambda: torch.argmax(logits, dim=-1))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3 / iters
    return out


SHARED_COUNTERS = ("prefix_hits", "prefill_tokens_skipped", "cow_copies",
                   "evictions", "preemptions")


#: the export phase: the loaded decode program's steps held token-exact
#: against the engine's, the kernels whose launches it counts there, and
#: the calls of the op layer's host-cost reading
EXPORT_STEPS = 16
EXPORT_KERNELS = ("layer_norm", "mlp", "decode_attention")
OP_COST_CALLS = 2000


def opcheck_cases(dev):
    """``(op name, route, args)``: each of the ten ops at small shapes on
    every route it has, with the op's own argument order."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import xent
    gen = torch.Generator().manual_seed(11)
    f32, bf16 = torch.float32, torch.bfloat16

    def r(*shape, dtype=f32, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    cases = [
        ("layer_norm", "row", (r(8, 768), r(768), r(768), 1e-5)),
        ("layer_norm", "simt", (r(9, 771), r(771), r(771), 1e-5)),
        ("add_layer_norm", "simt", (r(8, 768), r(8, 768), r(768), r(768),
                                    1e-5)),
        ("mlp", "split", (r(8, 64), r(64, 256, scale=0.1), r(256),
                          r(256, 64, scale=0.1), r(64))),
        ("mlp", "gemm", (r(100, 64), r(64, 256, scale=0.1), r(256),
                         r(256, 64, scale=0.1), r(64))),
        ("mlp", "tc", (r(128, 64, dtype=bf16),
                       r(64, 256, dtype=bf16, scale=0.1), r(256, dtype=bf16),
                       r(256, 64, dtype=bf16, scale=0.1), r(64, dtype=bf16)))]
    # K2's simt route at 200 rows: a split plan, so its merge runs too;
    # K3 there on tf32x3, and on simt at D = 32
    for route, bwd_route, dtype, t, d in (("simt", "tf32x3", f32, 200, 64),
                                          ("simt", "simt", f32, 100, 32),
                                          ("tc", "tc", bf16, 128, 64)):
        q, k, v = (r(1, 2, t, d, dtype=dtype) for _ in range(3))
        mask = (torch.arange(t, device=dev) < t - 5)[None].contiguous()
        cases.append(("flash_attention", route, (q, k, v, mask, 0.125, True)))
        out, lse = fa.flash_attention_kernel(q, k, v, 0.125, True, mask)
        do = r(1, 2, t, d, dtype=dtype)
        delta = (do.float() * out.float()).sum(-1)
        for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            cases.append((name, bwd_route, (q, k, v, do, lse, delta, mask,
                                            0.125, True)))
    # K5 and K6: f32 at H = 66 the SIMT kernels, f32 at 64 3xTF32, bf16
    # the tensor cores
    for route, dtype, n, vocab, hid in (("simt", f32, 16, 1000, 66),
                                        ("tf32x3", f32, 16, 1000, 64),
                                        ("tc", bf16, 128, 1024, 64)):
        h, w = r(n, hid, dtype=dtype), r(vocab, hid, dtype=dtype, scale=0.1)
        b = r(vocab)
        labels = torch.randint(0, vocab, (n,), generator=gen).to(dev)
        cases.append(("xent_stats", route, (h, w, b, labels)))
        m, s, _, _ = xent.xent_stats_kernel(h, w, b, labels)
        logz = m + torch.log(s)
        for name in ("xent_bwd_dh", "xent_bwd_dwb"):
            cases.append((name, route, (h, w, b, labels, logz, r(n), 0.001,
                                        0.9)))
    for route, hd, pool in (("split", 64, f32), ("split", 64, torch.int8),
                            ("simt", 12, f32)):
        n_pages, ps = 24, 16
        kp, vp = (r(n_pages, 2, ps, hd, scale=40.0).to(pool)
                  for _ in range(2))
        scales = ((r(n_pages, ps).abs() * 0.01, r(n_pages, ps).abs() * 0.01)
                  if pool == torch.int8 else (None, None))
        table = torch.randint(0, n_pages, (4, 6), generator=gen).to(
            dev, torch.int32)
        lengths = torch.tensor([1, 0, 50, 96], dtype=torch.int32, device=dev)
        cases.append(("decode_attention", route,
                      (r(4, 2, hd), kp, vp, table, lengths, 0.3, *scales)))
    return cases


def opcheck_ops(dev):
    """``torch.library.opcheck`` (schema, fake implementation against the
    real outputs, autograd registration, AOT dispatch with dynamic
    shapes) of each case of :func:`opcheck_cases`; each must launch on
    its route. Returns ``{op: [routes]}``."""
    from paddle_tpu_torch.ops.cuda import core
    checked = {}
    for name, route, args in opcheck_cases(dev):
        kernel = core.KERNELS[name]
        before = dict(kernel.route_launches)
        torch.library.opcheck(kernel.op, args)
        grown = {r for r, n in kernel.route_launches.items()
                 if n > before[r]}
        if grown != {route}:
            raise AssertionError(f"opcheck of {name}: launched on "
                                 f"{sorted(grown)}, not {route}")
        checked.setdefault(name, []).append(route)
    torch.cuda.synchronize()
    return checked


def op_cost_us(dev):
    """Host wall time per call of K1 at ``[8, 768]`` f32 through its op and
    through its CUDA implementation called directly (the ctypes launch
    the op wraps), in turn, twice: µs per call over
    :data:`OP_COST_CALLS` calls, the card synchronized around each loop
    (the kernel takes a few µs of device time, so the host sets the
    rate)."""
    from paddle_tpu_torch.ops.cuda import layer_norm as ln
    gen = torch.Generator().manual_seed(12)
    x, g, b = (torch.randn(*shape, generator=gen).to(dev)
               for shape in ((8, 768), (768,), (768,)))

    def per_call(fn):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(OP_COST_CALLS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / OP_COST_CALLS * 1e6

    op, direct = [], []
    with torch.inference_mode():
        for _ in range(2):
            op.append(per_call(lambda: ln.layer_norm_kernel(x, g, b, 1e-5)))
            direct.append(per_call(
                lambda: ln._layer_norm_cuda(x, g, b, 1e-5)))
    return dict(shape=[8, 768], dtype="float32", calls=OP_COST_CALLS,
                op_us=op, direct_us=direct)


def op_counts(ep):
    """``{op: nodes}`` of the ``paddle_tpu_torch`` ops in a program's
    graph."""
    return dict(collections.Counter(
        str(n.target).split(".")[1] for n in ep.graph.nodes
        if str(n.target).startswith("paddle_tpu_torch.")))


def int8_artifact(root):
    """A QAT-calibrated, frozen ``ConvNet`` (the MNIST book model) written
    by ``save_int8_inference_model`` and loaded back on the card: its
    outputs against the eager float twin over the frozen weights."""
    from paddle_tpu_torch import quant
    from paddle_tpu_torch.io import load_inference_model, read_params_bin
    from paddle_tpu_torch.models.mnist import ConvNet
    rs = np.random.RandomState(31)
    batches = [torch.from_numpy(rs.rand(64, 1, 28, 28).astype(
        np.float32)).cuda() for _ in range(4)]
    qmodel = quant.quantize_model(ConvNet(device="cuda", seed=0),
                                  quant.QuantConfig())
    quant.freeze(quant.calibrate(qmodel, batches[:3]))
    twin = ConvNet(device="cuda", seed=0)
    twin.load_state_dict({k: v for k, v in qmodel.state_dict().items()
                          if "input_quant" not in k})
    path = quant.save_int8_inference_model(
        os.path.join(root, "int8"), qmodel, (batches[3],), float_model=twin)
    got = load_inference_model(path)(batches[3])
    with torch.inference_mode():
        want = twin(batches[3])
    err = max_err(got, want)
    check("int8 artifact vs the eager frozen model", err, 1e-6)
    leaves = read_params_bin(os.path.join(path, "params.bin"))
    return dict(model="ConvNet", batch=[64, 1, 28, 28], max_abs_err=err,
                int8_leaves=sum(a.dtype == np.int8 for a in leaves),
                params_bin_bytes=os.path.getsize(
                    os.path.join(path, "params.bin")))


def export_worker(spec_path):
    """``python3 chip_smoke.py --export-worker SPEC``: the export phase's
    fresh interpreter. It imports ``paddle_tpu_torch.io`` and no model
    code, loads the exported decode step, its state (``params.bin``, in
    the dtypes of ``signature.json``) and the live batch the parent saved
    beside it, and runs the program for the spec's steps as a C++ loop
    would: each step's tokens fed back, the host adding one to the length
    of each active slot, the state outputs fed back as ``feedback``
    pairs them. Writes the tokens, each step's wall ms and launch counts,
    and the model modules it imported (none)."""
    import paddle_tpu_torch.io as io
    from paddle_tpu_torch.ops.cuda import core
    with open(spec_path) as f:
        spec = json.load(f)
    path = spec["path"]
    with open(os.path.join(path, "signature.json")) as f:
        sig = json.load(f)
    prog = io.load_program(path, device="cuda")
    state = [torch.from_numpy(np.array(a)).to("cuda", getattr(torch,
                                                              s["dtype"]))
             for a, s in zip(io.read_params_bin(
                 os.path.join(path, "params.bin")), sig["params"])]
    batch = np.load(os.path.join(path, "batch.npz"))
    tok = torch.from_numpy(batch["tokens"]).cuda()
    table = torch.from_numpy(batch["table"]).cuda()
    active = torch.from_numpy(batch["active"]).cuda()
    lengths, step_on = batch["lengths"].copy(), batch["active"].astype(
        batch["lengths"].dtype)
    tokens, step_ms, launches = [], [], []
    for _ in range(spec["steps"]):
        core.reset_launches()
        t = time.perf_counter()
        out = prog(*state, tok, table, torch.from_numpy(lengths).cuda(),
                   active)
        tok = out[0]
        tokens.append(tok.cpu().tolist())
        step_ms.append((time.perf_counter() - t) * 1e3)
        launches.append(core.launch_counts())
        for o, i in sig["feedback"]:
            state[i] = out[o]
        lengths = lengths + step_on
    models = sorted(m for m in sys.modules
                    if m.split(".")[:2] in (["paddle_tpu_torch", "models"],
                                            ["paddle_tpu_torch", "nn"],
                                            ["paddle_tpu_torch", "serving"]))
    with open(spec["out"], "w") as f:
        json.dump(dict(tokens=tokens, step_ms=step_ms, launches=launches,
                       model_modules=models), f)
    return 0


def export_phase(model, serve_kw, smi, serve_p50_step_ms):
    """The export phase (see the module docstring): opcheck of the ten
    ops, ``export_decode`` of a live GPTConfig.small() engine loaded and
    run in a fresh interpreter token-exact against the engine's next
    :data:`EXPORT_STEPS` steps, the launches of both, the ops of
    ``compiled_decode()`` and ``compiled_verify()``, the int8 artifact
    and the op layer's host cost. Returns (line, the loaded program's
    launches over its steps)."""
    import tempfile

    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    checked = opcheck_ops(dev)
    opcheck_s = time.perf_counter() - t0
    cfg = model.cfg
    ps = serve_kw["page_size"]
    eng = ServingEngine(model, ServeConfig(**serve_kw))
    rs = np.random.RandomState(21)
    # every slot's next EXPORT_STEPS positions stay inside its last page
    lens = [int(ps * rs.randint(1, 7) + rs.randint(1, ps - EXPORT_STEPS - 3))
            for _ in range(serve_kw["num_slots"])]
    for n in lens:
        eng.submit(rs.randint(0, cfg.vocab_size, n).astype(np.int32),
                   max_new=EXPORT_STEPS + 8)
    while eng._queue:
        eng.step()
    eng.step()                                  # a live decode step
    torch.cuda.synchronize()
    root = tempfile.mkdtemp(prefix="export_phase_")
    snap = dict(tokens=eng._last_tokens.copy(), table=eng._page_table.copy(),
                lengths=eng._lengths.copy(), active=eng._active.copy())
    t1 = time.perf_counter()
    path = eng.export_decode(os.path.join(root, "decode"))
    export_s = time.perf_counter() - t1
    np.savez(os.path.join(path, "batch.npz"), **snap)
    before = {slot: len(req.tokens) for slot, req in eng._running.items()}
    core.reset_launches()
    eng_ms = []
    for _ in range(EXPORT_STEPS):
        s0 = time.perf_counter()
        eng.step()
        eng_ms.append((time.perf_counter() - s0) * 1e3)
    torch.cuda.synchronize()
    eng_launches = core.launch_counts()
    if not np.array_equal(eng._page_table, snap["table"]):
        raise AssertionError("export: the engine took a page in the window")
    reference = {slot: req.tokens[before[slot]:before[slot] + EXPORT_STEPS]
                 for slot, req in eng._running.items()}
    spec_path = os.path.join(root, "worker_spec.json")
    out_path = os.path.join(root, "worker.json")
    with open(spec_path, "w") as f:
        json.dump(dict(path=path, steps=EXPORT_STEPS, out=out_path), f)
    t2 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--export-worker", spec_path],
                          capture_output=True, text=True, timeout=600)
    worker_s = time.perf_counter() - t2
    if proc.returncode != 0:
        raise AssertionError(f"export worker exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    with open(out_path) as f:
        res = json.load(f)
    if res["model_modules"]:
        raise AssertionError(f"export worker imported model code: "
                             f"{res['model_modules']}")
    loaded = np.asarray(res["tokens"])                      # [steps, S]
    for slot, want in reference.items():
        if loaded[:, slot].tolist() != want:
            raise AssertionError(f"export: slot {slot} loaded tokens "
                                 f"{loaded[:, slot].tolist()} != engine "
                                 f"{want}")
    per_step = {k: eng_launches[k] / EXPORT_STEPS for k in EXPORT_KERNELS}
    for i, counts in enumerate(res["launches"]):
        for k in EXPORT_KERNELS:
            if counts[k] == 0 or counts[k] != per_step[k]:
                raise AssertionError(f"export: loaded step {i} launched {k} "
                                     f"{counts[k]} times, the engine "
                                     f"{per_step[k]} a step")
    loaded_launches = {k: sum(c[k] for c in res["launches"])
                       for k in core.KERNELS}
    t3 = time.perf_counter()
    decode_ops = op_counts(eng.compiled_decode())
    spec_eng = ServingEngine(model, ServeConfig(**serve_kw, draft=True,
                                                spec_k=3))
    verify_ops = op_counts(spec_eng.compiled_verify())
    compile_s = time.perf_counter() - t3
    del spec_eng
    if decode_ops.get("decode_attention") != cfg.num_layers:
        raise AssertionError(f"compiled_decode holds {decode_ops}: not one "
                             "decode_attention op a layer")
    if "decode_attention" in verify_ops or "flash_attention" in verify_ops:
        raise AssertionError(f"compiled_verify holds {verify_ops}")
    del eng
    torch.cuda.empty_cache()
    int8 = int8_artifact(root)
    cost = op_cost_us(dev)
    torch.cuda.synchronize()
    line = dict(
        phase="export", config="GPTConfig.small()",
        **{k: v for k, v in serve_kw.items() if k != "cache_dtype"},
        cache_dtype="bfloat16", opcheck=checked, opcheck_s=opcheck_s,
        export_s=export_s, artifact_bytes={
            f: os.path.getsize(os.path.join(path, f))
            for f in sorted(os.listdir(path))},
        steps=EXPORT_STEPS, slots_token_exact=len(reference),
        loaded_step_ms=res["step_ms"],
        loaded_p50_step_ms=float(np.median(res["step_ms"][1:])),
        engine_step_ms=eng_ms,
        engine_p50_step_ms=float(np.median(eng_ms)),
        serve_p50_step_ms=serve_p50_step_ms,
        launches_per_step={"loaded": res["launches"][-1],
                           "engine": per_step},
        worker_s=worker_s, compiled_decode_ops=decode_ops,
        compiled_verify_ops=verify_ops, compile_s=compile_s, int8=int8,
        op_cost=cost, seconds=time.perf_counter() - t0, card=smi)
    shutil.rmtree(root, ignore_errors=True)
    return line, loaded_launches


def serve_shared_phase(model, cpu_model, serve_kw, smi):
    """The serve_shared phase: the wave through the prefix cache at
    SHARED_PAGES pages, with the launch counts zeroed just before and
    read just after; then the checks: every counter of SHARED_COUNTERS
    above 0; a rerun identical token for token (sampled requests too);
    never-preempted greedy requests token-exact against a run with the
    cache off and a full pool; every preempted greedy request held by
    ``crosscheck`` (its tokens the CPU's argmax and the cache-off run's,
    each but for a near tie); a run with one injected serve.step fault
    recovers once, its greedy requests that were neither recovered nor
    preempted equal the clean run's, and every recovered greedy request
    is held by ``crosscheck`` against the clean run as the preempted ones
    are against the cache-off run. Returns (the phase line, launches)."""
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.testing import chaos
    wave = shared_wave(model.cfg.vocab_size, seed=SHARED_SEED)
    kw = dict(serve_kw, num_pages=SHARED_PAGES)
    drive(model, kw, wave[:2])                              # warm-up
    torch.cuda.synchronize()
    core.reset_launches()
    eng, reqs, stats = drive(model, kw, wave)
    launches = core.launch_counts()
    routes = core.route_counts()
    torch.cuda.synchronize()
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"serve_shared: kernels not launched {missing}")
    check_serve_routes("serve_shared", routes)
    check_path_routes("serve_shared", routes, ("layer_norm",
                                               "decode_attention"))
    counters = {k: getattr(eng, k) for k in SHARED_COUNTERS}
    zero = [k for k, n in counters.items() if n <= 0]
    if zero:
        raise AssertionError(f"serve_shared: counters not above 0: {zero} "
                             f"of {counters} at num_pages={SHARED_PAGES}")

    _, again, _ = drive(model, kw, wave)
    rerun_diff = [r.id for r, a in zip(reqs, again) if r.tokens != a.tokens]
    if rerun_diff:
        raise AssertionError(f"serve_shared: a rerun changed requests "
                             f"{rerun_diff}")

    cold_eng, cold, cold_stats = drive(model, dict(serve_kw,
                                                   prefix_cache=False), wave)
    if cold_eng.preemptions or cold_eng.prefix_hits:
        raise AssertionError("serve_shared: the cache-off run preempted or "
                             "hit")
    held_greedy = [r for r in reqs if r.id % 2 == 0 and not r.preemptions]
    diff = [r.id for r in held_greedy if r.tokens != cold[r.id].tokens]
    if diff:
        raise AssertionError(f"serve_shared: greedy requests {diff} differ "
                             "from the cache-off run")
    sampled_same = sum(r.tokens == cold[r.id].tokens for r in reqs
                       if r.id % 2 and not r.preemptions)
    # every preempted greedy request (and one sampled one, by its logits)
    preempted = ([r for r in reqs if r.preemptions and r.id % 2 == 0]
                 + [r for r in reqs if r.preemptions and r.id % 2][:1])
    rows = crosscheck(model, cpu_model, preempted, serve_kw["page_size"],
                      serve_kw["prefill_len"],
                      reference={r.id: r.tokens for r in cold})

    plan = chaos.FaultPlan().fail("fault_point", path=r"^serve\.step$",
                                  nth=SHARED_FAULT_AT)
    f_eng, faulted, _ = drive(model, kw, wave, plan)
    if plan.fired() != 1 or f_eng.recoveries != 1:
        raise AssertionError(f"serve_shared fault run: {plan.fired()} "
                             f"faults, {f_eng.recoveries} recoveries")
    recovered = [f for f in faulted if f.recoveries]
    untouched = [f for f in faulted if f.id % 2 == 0 and not f.recoveries
                 and not f.preemptions and not reqs[f.id].preemptions]
    diff = [f.id for f in untouched if f.tokens != reqs[f.id].tokens]
    if diff or not recovered:
        raise AssertionError(f"serve_shared fault run: greedy requests "
                             f"{diff} differ from the clean run; "
                             f"{len(recovered)} recovered")
    rec_greedy = [f for f in recovered if f.id % 2 == 0]
    # every recovered greedy request, against the clean run; a sampled
    # one by its logits when none was greedy
    rows += crosscheck(model, cpu_model, rec_greedy or recovered[:1],
                       serve_kw["page_size"], serve_kw["prefill_len"],
                       reference={r.id: r.tokens for r in reqs})
    torch.cuda.synchronize()
    line = dict(
        phase="serve_shared", config="GPTConfig.small()",
        **{k: v for k, v in kw.items() if k != "cache_dtype"},
        cache_dtype="bfloat16", nvidia_smi=smi, launches=launches,
        routes={k: routes[k] for k in SERVE_ROUTED + tuple(PATH_ROUTE)},
        counters=dict(counters, recoveries=eng.recoveries,
                      prefix_misses=eng.prefix_misses),
        preempted_requests=[r.id for r in reqs if r.preemptions],
        greedy_token_exact_vs_cache_off=len(held_greedy),
        sampled_equal_to_cache_off=sampled_same,
        rerun_identical=len(reqs),
        cache_off=dict(decoded_tokens_per_s=cold_stats[
            "decoded_tokens_per_s"], p50_ttft_ms=cold_stats["p50_ttft_ms"],
            p50_step_ms=cold_stats["p50_step_ms"],
            prefill_calls=cold_stats["prefill_calls"]),
        fault_run=dict(recoveries=f_eng.recoveries,
                       recovered_requests=[f.id for f in recovered],
                       greedy_token_exact=len(untouched),
                       recovered_greedy_token_exact=sum(
                           f.tokens == reqs[f.id].tokens
                           for f in rec_greedy),
                       recovered_greedy=len(rec_greedy)),
        crosscheck=rows,
        sampling_host=sampling_ms(model.cfg.vocab_size, kw["num_slots"]),
        **{k: v for k, v in stats.items() if k != "prompt_lens"})
    return line, launches


# ------------------------------------------------------------- serve_spec

SPEC_K = 3
#: the kernels a draft step and a verify call must launch, on serve's
#: routes (K1 row, K4 split, K7 split); verify launches no K2
DRAFT_KERNELS = ("layer_norm", "mlp", "decode_attention")
VERIFY_KERNELS = ("layer_norm", "mlp")
SPEC_ROUTES = {"layer_norm": "row", "mlp": "split",
               "decode_attention": "split"}


def device_ms(fn, top=6):
    """The device time of one call of ``fn``: ``(ms, {kernel name: ms})``,
    the sum of the durations of the CUDA kernels it launched (they run on
    one stream and do not overlap) and the ``top`` largest by name, from
    ``torch.profiler`` (:func:`kernel_profile`). Warmed up once first."""
    ms, _, by_name = kernel_profile(fn)
    return ms, {k[:60]: v for k, v in by_name.most_common(top)}


def launched(fn):
    """``(launches, routes)`` of one call of ``fn``: every kernel's count,
    and the routes of the kernels that have more than one."""
    from paddle_tpu_torch.ops.cuda import core
    torch.cuda.synchronize()
    core.reset_launches()
    fn()
    torch.cuda.synchronize()
    return core.launch_counts(), core.route_counts()


def check_spec_call(what, launches, routes, kernels):
    """Each of ``kernels`` launched in the call, every launch on
    SPEC_ROUTES' route; and no flash attention (K2) launch."""
    for k in kernels:
        n = launches[k]
        on = routes[k][SPEC_ROUTES[k]]
        if n == 0 or on != n:
            raise AssertionError(f"{what}: {k} launched {n} times, {on} on "
                                 f"the {SPEC_ROUTES[k]} route")
    if launches["flash_attention"]:
        raise AssertionError(f"{what}: launched flash attention")


def spec_probe(model, serve_kw, wave):
    """One draft step and one verify call at the serve shapes (8 live
    slots of the wave, a window of SPEC_K + 1): launches and routes of
    each, checked by :func:`check_spec_call`, and the device ms of each
    (:func:`device_ms`). The calls write into a throwaway engine's
    pools at the positions the next round would."""
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    eng = ServingEngine(model, ServeConfig(**dict(serve_kw, draft=True,
                                                  spec_k=SPEC_K)))
    for prompt, _, kw in wave[:serve_kw["num_slots"]]:
        eng.submit(prompt, max_new=64, **kw)
    eng.step()                     # admission and one round
    if not eng._active.all():
        raise AssertionError("spec probe: not every slot is live")
    s = serve_kw["num_slots"]
    table = eng._dev(eng._page_table)
    lengths = eng._dev(eng._lengths)
    active = eng._dev(eng._active)
    tok = eng._dev(eng._last_tokens).long()
    win = torch.full((s,), SPEC_K + 1, dtype=torch.int32, device=tok.device)
    starts = eng._host(eng._lengths)
    window = torch.stack([tok] * (SPEC_K + 1), dim=1)
    draft = eng._draft_model

    def draft_step():
        logits, _ = draft.paged_decode_step(tok, eng._draft_caches, table,
                                            lengths, active)
        return torch.argmax(logits, dim=-1)

    def verify():
        hidden, _ = model.paged_verify_chunk(window, starts, win,
                                             eng._caches, table)
        return [torch.argmax(model.verify_head(hidden[:, i]), dim=-1)
                for i in range(SPEC_K + 1)]

    out = {}
    for name, fn, kernels in (("draft_step", draft_step, DRAFT_KERNELS),
                              ("verify", verify, VERIFY_KERNELS)):
        launches, routes = launched(fn)
        check_spec_call(name, launches, routes, kernels)
        ms, by_kernel = device_ms(fn)
        out[name] = dict(
            device_ms=ms, top_kernels_ms=by_kernel,
            launches={k: n for k, n in launches.items() if n},
            routes={k: routes[k] for k in SPEC_ROUTES})
    out["verify"]["rows"] = s * (SPEC_K + 1)
    return out


def cut_draft(model, layers):
    """A draft of ``layers`` blocks cut from the target: its config, and
    its weights (the target's embeddings, first ``layers`` blocks and
    ``ln_f``) as the reference's param tree, exported through the
    bridge."""
    import copy

    from paddle_tpu_torch import bridge
    cfg = copy.deepcopy(model.cfg)
    cfg.num_layers = layers
    tree = bridge.export_params(model)
    tree["blocks"] = {str(i): tree["blocks"][str(i)] for i in range(layers)}
    return cfg, {"params": tree}


def held_tokens(model, cpu_model, reqs, reference, serve_kw):
    """The serve_shared rule: a request equal to ``reference`` (id ->
    tokens) token for token passes; one that is not is held by
    ``crosscheck`` against it (logits within SERVE_LOGIT_TOL of the
    CPU's, and for a greedy request each token the CPU's argmax and the
    reference's but for a near tie). Returns (exact count, crosscheck
    rows)."""
    diff = [r for r in reqs if r.tokens != list(reference[r.id])]
    rows = crosscheck(model, cpu_model, diff, serve_kw["page_size"],
                      serve_kw["prefill_len"], reference=reference)
    return len(reqs) - len(diff), rows


def spec_run_line(eng, stats, exact, rows):
    return dict(spec=eng.spec_stats(), latency=eng.latency_stats(),
                token_exact=exact, crosscheck=rows,
                **{k: v for k, v in stats.items() if k != "prompt_lens"})


def serve_spec_phase(model, cpu_model, serve_kw, smi, off_tokens,
                     off_stats):
    """The serve_spec phase: the serve phase's traffic through
    speculative decoding (SPEC_K proposals a round). Runs, each against a
    spec-off run of the same prompts by :func:`held_tokens`: greedy
    self-draft (against the serve phase's tokens; the launch counts are
    zeroed just before it and read just after, and every serving kernel
    must launch on serve's routes), a sampled wave with odd ids sampled
    (spec off, then self-draft), and a 2-layer draft cut from the target
    (greedy). Then :func:`spec_probe`. Returns (the phase line,
    launches)."""
    from paddle_tpu_torch.ops.cuda import core
    vocab = model.cfg.vocab_size
    greedy = serve_wave(vocab, 16, (64, 512), 700, 64, seed=0)
    sampled = serve_wave(vocab, 16, (64, 512), 700, 64, seed=0,
                         sampled=True)
    spec_kw = dict(serve_kw, draft=True, spec_k=SPEC_K)
    drive(model, spec_kw, greedy[:2])                        # warm-up
    torch.cuda.synchronize()
    core.reset_launches()
    eng, reqs, stats = drive(model, spec_kw, greedy)
    launches = core.launch_counts()
    routes = core.route_counts()
    torch.cuda.synchronize()
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"serve_spec: kernels not launched {missing}")
    check_serve_routes("serve_spec", routes)
    check_path_routes("serve_spec", routes, ("layer_norm",
                                             "decode_attention"))
    if eng.spec_stats()["rounds"] == 0 or eng.decode_steps:
        raise AssertionError("serve_spec: the run did not speculate")
    exact, rows = held_tokens(model, cpu_model, reqs, off_tokens, serve_kw)
    runs = {"greedy_self_draft": spec_run_line(eng, stats, exact, rows)}

    s_off, s_off_reqs, s_off_stats = drive(model, serve_kw, sampled)
    s_eng, s_reqs, s_stats = drive(model, spec_kw, sampled)
    exact, rows = held_tokens(model, cpu_model, s_reqs,
                              {r.id: r.tokens for r in s_off_reqs},
                              serve_kw)
    runs["sampled_self_draft"] = spec_run_line(s_eng, s_stats, exact, rows)
    runs["sampled_self_draft"]["spec_off"] = {
        k: s_off_stats[k] for k in ("decoded_tokens_per_s", "p50_step_ms",
                                    "p50_ttft_ms")}

    dcfg, dvars = cut_draft(model, 2)
    c_eng, c_reqs, c_stats = drive(model, dict(
        serve_kw, spec_k=SPEC_K, draft_spec=dcfg, draft_variables=dvars),
        greedy)
    exact, rows = held_tokens(model, cpu_model, c_reqs, off_tokens,
                              serve_kw)
    runs["greedy_cut_draft"] = spec_run_line(c_eng, c_stats, exact, rows)
    runs["greedy_cut_draft"]["draft_layers"] = dcfg.num_layers
    del eng, s_eng, s_off, c_eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    probe = spec_probe(model, serve_kw, greedy)
    line = dict(
        phase="serve_spec", config="GPTConfig.small()", spec_k=SPEC_K,
        **{k: v for k, v in serve_kw.items() if k != "cache_dtype"},
        cache_dtype="bfloat16", nvidia_smi=smi, launches=launches,
        routes={k: routes[k] for k in SERVE_ROUTED + tuple(PATH_ROUTE)},
        runs=runs, probe=probe,
        per_round_device_ms=SPEC_K * probe["draft_step"]["device_ms"]
        + probe["verify"]["device_ms"],
        spec_off={k: off_stats[k] for k in ("decoded_tokens_per_s",
                                            "p50_step_ms", "p50_ttft_ms",
                                            "steps")})
    return line, launches


# ------------------------------------------------------------------ train

def loss_of(model, ids):
    return model.loss(ids)


def bert_loss_of(model, ids, mlm_labels, nsp_labels, mlm_mask,
                 token_type_ids=None, attention_mask=None,
                 mask_positions=None):
    """BertForPretraining.loss with every input positional, so that
    ``minimize`` carries them all (and casts the float ones)."""
    return model.loss(ids, mlm_labels, nsp_labels, mlm_mask,
                      token_type_ids=token_type_ids,
                      attention_mask=attention_mask,
                      mask_positions=mask_positions)


def train(model, opt, loss_fn, args, warmup, steps):
    """``warmup`` steps, then ``steps`` timed steps of ``opt.minimize`` of
    ``loss_fn`` on the fixed batch ``args``, with the launch counts and
    the peak-memory statistic zeroed just before the timed steps. Each
    step ends by reading its loss on the host, so its wall time covers
    its device work. Returns (losses of every step, timed step seconds,
    launches, launches by route of the kernels that have two)."""
    from paddle_tpu_torch.ops.cuda import core
    losses, times = [], []
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            core.reset_launches()
        t0 = time.perf_counter()
        losses.append(float(opt.minimize(model, loss_fn, *args)))
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    return losses, times, core.launch_counts(), core.route_counts()


def train_launches_per_step(layers):
    """Each GPT training kernel's launches per step: K1 twice per block
    plus ln_f, K2/K3/K4 once per block, K5 and K6 once."""
    return {"layer_norm": 2 * layers + 1, "flash_attention": layers,
            "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers, "mlp": layers,
            "xent_stats": 1, "xent_bwd_dh": 1, "xent_bwd_dwb": 1}


def bert_launches_per_step(layers):
    """Each BERT pretraining kernel's launches per step: K8 twice per
    layer (the post-norm residuals), K1 for emb_ln and mlm_ln, K2/K3/K4
    once per layer, K5 and K6 once (the MLM head)."""
    return {"add_layer_norm": 2 * layers, "layer_norm": 2,
            "flash_attention": layers, "flash_attention_bwd_dq": layers,
            "flash_attention_bwd_dkv": layers, "mlp": layers,
            "xent_stats": 1, "xent_bwd_dh": 1, "xent_bwd_dwb": 1}


def check_routes(what, routes, route, kernels=None):
    """Every launch of ``kernels`` (default :data:`TC_KERNELS`) in a run
    took ``route``, and there was at least one."""
    wrong = {k: routes[k] for k in kernels or TC_KERNELS
             if routes[k][route] == 0 or sum(routes[k].values())
             != routes[k][route]}
    if wrong:
        raise AssertionError(f"{what}: launches not all on the {route} "
                             f"route: {wrong}")


def check_serve_routes(what, routes, kernels=SERVE_ROUTED):
    """Every launch of ``kernels`` (of :data:`SERVE_ROUTES`) in a run took
    one of the routes SERVE_ROUTES names for it, and each of those routes
    launched at least once."""
    wrong = {k: routes[k] for k in kernels
             if any(routes[k][r] == 0 for r in SERVE_ROUTES[k])
             or sum(routes[k].values())
             != sum(routes[k][r] for r in SERVE_ROUTES[k])}
    if wrong:
        raise AssertionError(f"{what}: launches not on the serve routes "
                             f"{SERVE_ROUTES}: {wrong}")


def check_path_routes(what, routes, kernels):
    """Every launch of ``kernels`` in a run took the route
    :data:`PATH_ROUTE` names for it, and there was at least one."""
    for k in kernels:
        check_routes(what, routes, PATH_ROUTE[k], (k,))


def check_launches(what, launches, steps, want):
    wrong = {k: (launches[k] / steps, n) for k, n in want.items()
             if launches[k] != n * steps}
    if wrong:
        raise AssertionError(f"{what} launches per step (got, want): "
                             f"{wrong}")


def train_crosscheck(make_model, loss_fn, args, around=None,
                     make_opt=None, routes=None):
    """One f32 step of ``loss_fn`` (Adam(1e-4), or ``make_opt(params)``)
    on the card and on the CPU plain
    path, each on a model from ``make_model(device)`` (the same weights):
    (loss card, loss CPU, per-parameter gradient errors, per-buffer
    errors, the card run's launches). A parameter whose gradient is 0 in
    exact arithmetic (the key bias, which softmax cancels) carries only
    rounding noise, so each error is relative to the larger of its own
    gradient's norm and 1e-3 of the largest one. A buffer's error (batch
    norm's running statistics, updated by the step) is its largest
    difference over its largest CPU value. ``around(device)``, when
    given, is a context entered around each device's step
    (:class:`ReluReplay`). ``routes``, when given, a dict that receives the
    card run's route counts (``core.route_counts()``)."""
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.optimizer import Adam
    out = {}
    for dev in ("cuda", "cpu"):
        model = make_model(dev)
        opt = (make_opt or (lambda ps: Adam(ps, 1e-4)))(model.parameters())
        core.reset_launches()
        with around(dev) if around else contextlib.nullcontext():
            loss = float(opt.minimize(model, loss_fn,
                                      *(a.to(dev) for a in args)))
        out[dev] = (loss, {n: p.grad.detach().cpu()
                           for n, p in model.named_parameters()},
                    {n: b.detach().cpu() for n, b in model.named_buffers()},
                    core.launch_counts())
        if dev == "cuda" and routes is not None:
            routes.update(core.route_counts())
    (lc, gc, bc, launches), (lp, gp, bp, _) = out["cuda"], out["cpu"]
    top = max(float(g.norm()) for g in gp.values())
    errs = {n: float((gc[n] - gp[n]).norm())
            / max(float(gp[n].norm()), 1e-3 * top) for n in gp}
    stat_errs = {n: float((bc[n] - bp[n]).abs().max())
                 / float(bp[n].abs().max()) for n in bp}
    return lc, lp, errs, stat_errs, launches


# ------------------------------------------------------------------ vision

#: bench.py:1284's count: ResNet-50's forward is 4.089 GMACs an image at
#: 224 x 224, two operations a MAC, and a training step three forwards
RESNET50_STEP_OPS = 3 * 2 * 4.089e9
#: a kernel name that is a convolution's (cuDNN's implicit GEMMs, its
#: wgrad/dgrad kernels and layout transposes) or a GEMM's (the fc)
CONV_KERNEL = re.compile(r"conv|xmma|cudnn|implicit|wgrad|dgrad|fprop|"
                         r"cutlass|gemm|nchwToNhwc|nhwcToNchw", re.I)


#: the resnet50 phase's steps in all: at bench's rate (0.1, momentum 0.9,
#: no warm-up) the loss of one fixed batch first falls, then rises for
#: about ten steps and comes back down, so the timed steps run on to here
#: before the loss is held to have fallen; the line records every step's
#: loss
RESNET50_STEPS = 60


def xent_mean(model, images, labels):
    """bench.py's ResNet loss: ``mean(softmax_with_cross_entropy(out,
    labels))`` on the logits as they come (bf16 under the policy)."""
    from paddle_tpu_torch.ops.loss import softmax_with_cross_entropy
    return softmax_with_cross_entropy(model(images), labels).mean()


def image_batch(rs, batch, size, classes):
    """``bench.py``'s batch: f32 NCHW images uniform in [0, 1), then int32
    labels ``[batch, 1]``."""
    images = rs.rand(batch, 3, size, size).astype(np.float32)
    labels = rs.randint(0, classes, (batch, 1)).astype(np.int32)
    return torch.from_numpy(images), torch.from_numpy(labels)


def check_no_launches(what, launches):
    """No kernel of the port ran: the path's convolutions, pools and batch
    norms (or the CTR path's gathers, scatters, unique and GEMMs) are the
    reference's XLA ops, none of them a Pallas kernel."""
    ran = {k: n for k, n in launches.items() if n}
    if ran:
        raise AssertionError(f"{what}: kernels of the port launched {ran}")


def kernel_profile(fn):
    """One call of ``fn`` (warmed up once first) under torch.profiler:
    ``(device ms, kernel launches, {kernel name: ms})``, the device time
    the sum of the CUDA kernels' durations (one stream: they do not
    overlap); memory copies and sets are counted in the time, not as
    launches."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, launches = collections.Counter(), 0
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
            launches += not e.name.startswith(("Memcpy", "Memset"))
    return sum(by_name.values()), launches, by_name


def train_images(model, opt, args, warmup, steps, smi, what, config):
    """``train`` of :func:`xent_mean` with the image phases' checks: every
    loss finite, no kernel of the port launched. Returns the line's
    statistics and the launches."""
    losses, times, launches, _ = train(model, opt, xent_mean, args, warmup,
                                       steps)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: non-finite loss {losses}")
    check_no_launches(what, launches)
    batch = args[0].shape[0]
    return dict(config=config, batch=batch,
                image=list(args[0].shape[1:]), policy="bf16",
                optimizer="Momentum(0.1, 0.9)", warmup=warmup, steps=steps,
                losses=losses, images_per_s=batch * steps / sum(times),
                p50_step_ms=float(np.median(times)) * 1e3,
                mean_step_ms=float(np.mean(times)) * 1e3,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                card=smi), launches


def resnet50_phase(smi):
    """``bench.py:1228 bench_resnet`` at its defaults on the card:
    resnet50(1000) (weights from seed 0, NHWC compute as channels_last
    with HWIO storage, one transpose of the NCHW batch at the stem),
    ``mean(softmax_with_cross_entropy)``, amp.decorate(Momentum(0.1,
    0.9), bf16_policy()) with f32 velocity, the BN running statistics
    updated in bf16 by every step and stored in f32; one fixed seeded
    batch of 128 f32 NCHW images at 224 x 224. 2 warm-up and 10 timed
    steps with the launch counts zeroed just before (no kernel of the
    port launched), then untimed steps to RESNET50_STEPS: every loss
    finite, the last below the first, every BN buffer moved. Then one
    profiled step: device ms in convolutions (with the fc's GEMM), in the
    optimizer (an update profiled alone),
    in batch norm and the other elementwise work (the rest), the idle
    share against the p50 step, launches per step. Returns (line,
    launches)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import resnet50
    from paddle_tpu_torch.optimizer import Momentum
    batch, warmup, steps = 128, 2, 10
    model = resnet50(1000, device="cuda", seed=0)
    initial = {k: b.clone() for k, b in model.named_buffers()}
    opt = amp.decorate(Momentum(model.parameters(), 0.1, 0.9),
                       amp.bf16_policy())
    args = tuple(a.cuda() for a in image_batch(np.random.RandomState(0),
                                               batch, 224, 1000))
    line, launches = train_images(model, opt, args, warmup, steps, smi,
                                  "resnet50", "resnet50(1000)")
    losses = line["losses"] + [float(opt.minimize(model, xent_mean, *args))
                               for _ in range(RESNET50_STEPS - len(
                                   line["losses"]))]
    line["losses"] = losses
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"resnet50: loss did not fall {losses}")
    still = [k for k, b in model.named_buffers() if torch.equal(b,
                                                                initial[k])]
    if still:
        raise AssertionError(f"resnet50: running statistics not updated "
                             f"{still[:5]}")
    if any(b.dtype != torch.float32 for b in model.buffers()):
        raise AssertionError("resnet50: running statistics not stored f32")
    step_ms, step_launches, by_name = kernel_profile(
        lambda: opt.minimize(model, xent_mean, *args))
    opt_ms, _, _ = kernel_profile(opt.apply_gradients)
    conv_ms = sum(ms for name, ms in by_name.items() if CONV_KERNEL.search(
        name))
    step_s = line["p50_step_ms"] / 1e3
    line.update(
        mfu_bf16_peak=RESNET50_STEP_OPS * batch / step_s
        / PEAK_OPS[torch.bfloat16],
        flops_per_step=RESNET50_STEP_OPS * batch,
        params=sum(p.numel() for p in model.parameters()),
        bn_buffers=len(initial),
        launches=launches,
        profile=dict(
            device_ms=step_ms, conv_gemm_ms=conv_ms, optimizer_ms=opt_ms,
            bn_elementwise_ms=step_ms - conv_ms - opt_ms,
            idle_share=1.0 - step_ms / line["p50_step_ms"],
            launches_per_step=step_launches,
            top_kernels={k[:60]: v for k, v in by_name.most_common(8)}))
    return line, launches


def resnet_crosscheck_phase():
    """One f32 step (TF32 off, cuDNN's too) of resnet50(1000) at 2 x 3 x
    224 x 224 on the card and on the CPU plain path from the same
    weights, the CPU taking the card's ReLU branches
    (:class:`ReluReplay`, each differing pre-activation within
    RESNET_RELU_FLIP_TOL of 0): the loss within TRAIN_LOSS_TOL, every
    gradient within TRAIN_GRAD_TOL relative L2, every updated running
    statistic within RESNET_STATS_TOL of its leaf's largest; no kernel of
    the port launched. Then the same step in f64 on both sides (ReLU
    branches replayed, no bar): its line gives the floor that the
    statistics' f32 rounding sets under those bars. Returns the f32 card
    run's launches."""
    from paddle_tpu_torch.models import resnet50
    launches = crosscheck_phase(
        "resnet_crosscheck", "resnet50(1000)",
        lambda dev: resnet50(1000, device=dev, seed=0), xent_mean,
        image_batch(np.random.RandomState(6), 2, 224, 1000), 2, None, (),
        around=ReluReplay(RESNET_RELU_FLIP_TOL), stats_tol=RESNET_STATS_TOL,
        image=[3, 224, 224])
    check_no_launches("resnet_crosscheck", launches)
    replay = ReluReplay(tol=None)
    images, labels = image_batch(np.random.RandomState(6), 2, 224, 1000)
    loss_card, loss_cpu, errs, stat_errs, _ = train_crosscheck(
        lambda dev: resnet50(1000, device=dev, seed=0).double(), xent_mean,
        (images.double(), labels), replay)
    grad_worst = max(errs, key=errs.get)
    stat_worst = max(stat_errs, key=stat_errs.get)
    emit(dict(phase="resnet_crosscheck_f64", what="the same step in f64 on "
              "both (the statistics still f32, as the formula takes them): "
              "the floor under the f32 bars", **replay.summary(),
              loss_diff=abs(loss_card - loss_cpu),
              grad_rel_err_max=errs[grad_worst], grad_rel_err_worst=grad_worst,
              stats_rel_err_max=stat_errs[stat_worst],
              stats_rel_err_worst=stat_worst))
    return launches


def vision_cls_phase(smi):
    """Three amp.decorate(Momentum(0.1, 0.9), bf16_policy()) steps (one
    warm-up, two timed) of se_resnext50(1000) at 32 x 224 x 224 and of
    vgg16(10) (dropout 0.5 from its generator) at 128 x 32 x 32, each on
    one fixed seeded batch: every loss finite, no kernel of the port
    launched. Returns the line."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import se_resnext50, vgg16
    from paddle_tpu_torch.optimizer import Momentum
    out = {}
    for what, make, batch, size, classes in (
            ("se_resnext50", lambda: se_resnext50(1000, device="cuda"), 32,
             224, 1000),
            ("vgg16", lambda: vgg16(10, device="cuda"), 128, 32, 10)):
        model = make()
        opt = amp.decorate(Momentum(model.parameters(), 0.1, 0.9),
                           amp.bf16_policy())
        args = tuple(a.cuda() for a in image_batch(
            np.random.RandomState(7), batch, size, classes))
        out[what], _ = train_images(model, opt, args, 1, 2, smi, what,
                                    f"{what}({classes})")
        del model, opt
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- ctr

CTR_BATCH = 512          # bench.py's bench_ctr default
CTR_WARMUP = 5
CTR_STEPS = 50
CTR_HOST_STEPS = 20
CTR_LOSS_TOL = 1e-6      # one f32 step, card vs CPU, relative
CTR_PARAM_TOL = 1e-5     # every head parameter, touched table row and
                         # (relative to its table's largest) Adagrad moment
                         # after that step, card vs CPU
#: a kernel name that is a GEMM's (cuBLAS's or CUTLASS's); checked first
GEMM_KERNEL = re.compile(r"gemm|cutlass|xmma|cublas|splitk|gemv", re.I)
#: a kernel name that is a gather, scatter or the unique's sort and scan
#: (torch's index kernels, cub's radix sort and scans)
GATHER_KERNEL = re.compile(r"index|gather|scatter|unique|sort|radix|"
                           r"onesweep|histogram|scan|select|adjacent|"
                           r"compact|cub::|thrust", re.I)


def ctr_config():
    """``bench.py:1309 bench_ctr``'s model: 26 sparse fields of 100,000
    ids each (one shared table of 2.6 M rows), 13 dense, embed 16, DNN
    400-400-400."""
    from paddle_tpu_torch.models.ctr import CTRConfig
    return CTRConfig(num_sparse_fields=26, num_dense_fields=13,
                     vocab_size=100_000, embed_dim=16,
                     hidden=(400, 400, 400))


def ctr_name(cfg):
    return (f"CTRConfig({cfg.num_sparse_fields}, {cfg.num_dense_fields}, "
            f"{cfg.vocab_size}, {cfg.embed_dim}, {tuple(cfg.hidden)})")


def ctr_batch(cfg, batch, rs):
    """bench_ctr's batch, drawn in its order: dense f32 uniform in [0,
    1), per-field int32 ids, 0/1 f32 labels ``[batch, 1]``."""
    dense = rs.rand(batch, cfg.num_dense_fields).astype(np.float32)
    sparse = rs.randint(0, cfg.vocab_size, (batch, cfg.num_sparse_fields),
                        dtype=np.int32)
    labels = rs.randint(0, 2, (batch, 1), dtype=np.int32).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (dense, sparse, labels))


def ctr_setup(cfg, device):
    """bench_ctr's state on ``device``: DeepFM(cfg, sparse_tables=True)
    from seed 0 under Adam(1e-3), and the [2.6 M, 16] and [2.6 M, 1]
    SparseTables from seeds 1 and 2, each under its own Adagrad(0.05).
    Returns (model, opt, tables, states, step)."""
    from paddle_tpu_torch.models.ctr import (DeepFM,
                                             make_sparse_deepfm_train_step)
    from paddle_tpu_torch.optimizer import Adagrad, Adam
    from paddle_tpu_torch.parallel import SparseTable
    model = DeepFM(cfg, sparse_tables=True, device=device, seed=0)
    opt = Adam(model.parameters(), 1e-3)
    tbls = [SparseTable(cfg.total_vocab, dim,
                        lambda ps: Adagrad(ps, 0.05))
            for dim in (cfg.embed_dim, 1)]
    states = [tb.init(seed=1 + i, device=device)
              for i, tb in enumerate(tbls)]
    step = make_sparse_deepfm_train_step(model, opt, *tbls, *states)
    return model, opt, tbls, states, step


def table_leaves(state):
    """A SparseTable state's table and slots, by name."""
    return {"table": state["table"], **state["slots"]}


def check_rows(what, leaves, initial, touched):
    """Every touched row of every leaf (table and moments) moved; every
    other row bit-identical to its initial value."""
    for name, now in leaves.items():
        moved = (now != initial[name]).reshape(now.shape[0], -1).any(dim=1)
        if not bool(moved[touched].all()):
            raise AssertionError(f"{what} {name}: "
                                 f"{int((~moved[touched]).sum())} touched "
                                 "rows did not move")
        if bool(moved[~touched].any()):
            raise AssertionError(f"{what} {name}: {int(moved[~touched].sum())}"
                                 " untouched rows changed")


def ctr_phase(smi):
    """``bench.py:1309 bench_ctr`` at its defaults on the card: the
    sparse-row DeepFM step (unique ids, pull, loss through the pulled
    rows, Adam on the 493,215 head parameters, Adagrad row updates pushed
    into both SparseTables) on one fixed seeded batch of 512, all f32.
    CTR_WARMUP steps, then CTR_STEPS timed steps with the launch counts
    zeroed just before, each ending with a host read of the loss: every
    loss finite, the last below the first, every touched row of both
    tables and both moments moved and every other row bit-identical, no
    kernel of the port launched. Then one profiled step: device ms in the
    MLP's GEMMs (GEMM_KERNEL), in gathers, scatters and the unique's sort
    (GATHER_KERNEL, of the others), in the head's Adam update (profiled
    alone) and the rest (the FM terms, the row updates and other
    elementwise work),
    the idle share against the p50 step, launches per step. Returns
    (line, launches)."""
    from paddle_tpu_torch.models.ctr import _offset_ids
    from paddle_tpu_torch.ops.cuda import core
    cfg = ctr_config()
    model, opt, tbls, states, step = ctr_setup(cfg, "cuda")
    initial = [{k: v.clone() for k, v in table_leaves(s).items()}
               for s in states]
    args = tuple(a.cuda() for a in ctr_batch(cfg, CTR_BATCH,
                                             np.random.RandomState(0)))
    ids = _offset_ids(cfg, args[1])
    touched = torch.zeros(cfg.total_vocab, dtype=torch.bool,
                          device=ids.device)
    touched[ids.reshape(-1)] = True
    losses, times = [], []
    for i in range(CTR_WARMUP + CTR_STEPS):
        if i == CTR_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            core.reset_launches()
        t0 = time.perf_counter()
        losses.append(float(step(*args)))
        if i >= CTR_WARMUP:
            times.append(time.perf_counter() - t0)
    launches = core.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"ctr: loss did not fall {losses}")
    check_no_launches("ctr", launches)
    for what, s, init in zip(("embed", "fm_linear"), states, initial):
        check_rows(f"ctr {what}", table_leaves(s), init, touched)
    step_ms, step_launches, by_name = kernel_profile(lambda: step(*args))
    opt_ms, _, _ = kernel_profile(opt.apply_gradients)
    gemm_ms = sum(ms for k, ms in by_name.items() if GEMM_KERNEL.search(k))
    gather_ms = sum(ms for k, ms in by_name.items()
                    if GATHER_KERNEL.search(k) and not GEMM_KERNEL.search(k))
    p50 = float(np.median(times)) * 1e3
    line = dict(
        config=ctr_name(cfg), model="DeepFM(sparse_tables=True)",
        batch=CTR_BATCH, dtype="float32", allow_tf32=False,
        optimizer="Adam(1e-3)",
        tables=f"2 x SparseTable({cfg.total_vocab}, {cfg.embed_dim} | 1), "
        "Adagrad(0.05) each",
        head_params=sum(p.numel() for p in model.parameters()),
        table_bytes=sum(t.numel() * t.element_size() for s in states
                        for t in table_leaves(s).values()),
        unique_rows_per_step=int(touched.sum()),
        ids_per_step=int(ids.numel()),
        warmup=CTR_WARMUP, steps=CTR_STEPS, losses=losses,
        examples_per_s=CTR_BATCH / float(np.mean(times)),
        p50_step_ms=p50, mean_step_ms=float(np.mean(times)) * 1e3,
        peak_memory_gb=peak, launches=launches,
        profile=dict(
            device_ms=step_ms, gather_scatter_unique_ms=gather_ms,
            gemm_ms=gemm_ms, optimizer_ms=opt_ms,
            other_elementwise_ms=step_ms - gather_ms - gemm_ms - opt_ms,
            idle_share=1.0 - step_ms / p50,
            launches_per_step=step_launches,
            top_kernels={k[:60]: v for k, v in by_name.most_common(10)}),
        card=smi)
    return line, launches


def ctr_crosscheck_phase():
    """One f32 step (TF32 off) of ctr_phase's model and tables from the
    same weights and table draws, on the card and on the CPU plain path,
    on a seeded batch of CTR_BATCH: the loss within CTR_LOSS_TOL
    relative; every head parameter and both tables' touched rows within
    CTR_PARAM_TOL; both Adagrad moments within CTR_PARAM_TOL of their
    largest value; untouched rows equal; no kernel of the port launched
    on the card."""
    from paddle_tpu_torch.models.ctr import _offset_ids
    from paddle_tpu_torch.ops.cuda import core
    cfg = ctr_config()
    out = {}
    for dev in ("cuda", "cpu"):
        model, _, _, states, step = ctr_setup(cfg, dev)
        args = tuple(a.to(dev) for a in ctr_batch(
            cfg, CTR_BATCH, np.random.RandomState(5)))
        core.reset_launches()
        loss = float(step(*args))
        out[dev] = (loss, {k: p.detach().cpu()
                           for k, p in model.named_parameters()},
                    [{k: v.cpu() for k, v in table_leaves(s).items()}
                     for s in states], core.launch_counts())
        del model, states, step
    (lc, pc, tc, launches), (lp, pp, tp, _) = out["cuda"], out["cpu"]
    check_no_launches("ctr_crosscheck", launches)
    sparse = ctr_batch(cfg, CTR_BATCH, np.random.RandomState(5))[1]
    touched = torch.zeros(cfg.total_vocab, dtype=torch.bool)
    touched[_offset_ids(cfg, sparse).reshape(-1)] = True
    param_err = {k: float((pc[k] - pp[k]).abs().max()) for k in pp}
    table_err, moment_err, untouched_equal = {}, {}, True
    for what, c, p in zip(("embed", "fm_linear"), tc, tp):
        table_err[what] = float((c["table"][touched]
                                 - p["table"][touched]).abs().max())
        moment_err[what] = float((c["moment"] - p["moment"]).abs().max()
                                 / p["moment"].abs().max())
        untouched_equal &= all(torch.equal(c[k][~touched], p[k][~touched])
                               for k in c)
    worst = max(param_err, key=param_err.get)
    emit(dict(phase="ctr_crosscheck", config=ctr_name(cfg),
              batch=CTR_BATCH, dtype="float32",
              allow_tf32=False, loss_card=lc, loss_cpu=lp,
              loss_rel_err=abs(lc - lp) / abs(lp), loss_tol=CTR_LOSS_TOL,
              param_err_max=param_err[worst], param_err_worst=worst,
              table_err=table_err, moment_rel_err=moment_err,
              untouched_equal=untouched_equal, tol=CTR_PARAM_TOL))
    check("ctr_crosscheck loss", abs(lc - lp) / abs(lp), CTR_LOSS_TOL)
    check(f"ctr_crosscheck parameter {worst}", param_err[worst],
          CTR_PARAM_TOL)
    for what in table_err:
        check(f"ctr_crosscheck {what} rows", table_err[what], CTR_PARAM_TOL)
        check(f"ctr_crosscheck {what} moment", moment_err[what],
              CTR_PARAM_TOL)
    if not untouched_equal:
        raise AssertionError("ctr_crosscheck: untouched rows differ")


class HostTimer:
    """Wraps a HostTable's pull and push: each call's host ms, rows and
    the bytes it moves over PCIe (the pulled rows to the card, the row
    gradient back)."""

    def __init__(self, table):
        self.pull_ms, self.push_ms, self.rows, self.bytes = [], [], [], []
        pull, push = table.pull, table.push

        def timed_pull(ids, device="cuda"):
            t0 = time.perf_counter()
            rows, uniq = pull(ids, device)
            self.pull_ms.append((time.perf_counter() - t0) * 1e3)
            self.rows.append(len(uniq))
            self.bytes.append(nbytes(rows))
            return rows, uniq

        def timed_push(uniq, row_grad):
            t0 = time.perf_counter()
            push(uniq, row_grad)
            self.push_ms.append((time.perf_counter() - t0) * 1e3)
            self.bytes[-1] += nbytes(row_grad)

        table.pull, table.push = timed_pull, timed_push


def ctr_host_phase(smi):
    """ctr_phase's model with both tables as HostTables (host RAM,
    Adagrad(0.05) each, seeds 1 and 2), driven through
    Trainer(sparse_tables=...) over a synthetic_ctr stream (100,000 ids a
    field) in batches of CTR_BATCH for CTR_HOST_STEPS steps, two
    ingestion threads: every loss finite, every row the stream touched
    moved in both tables, every other row bit-identical, no kernel of
    the port launched. Records examples/s, the host ms of each table's
    pull and push per step, the bytes over PCIe per step (pulled rows,
    the inverse maps and the row gradients) and the tables' nbytes()."""
    from paddle_tpu_torch.data import InMemoryDataset, synthetic_ctr
    from paddle_tpu_torch.models.ctr import DeepFM, ctr_loss
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.optimizer import Adagrad, Adam
    from paddle_tpu_torch.parallel import HostTable
    from paddle_tpu_torch.static import Trainer, TrainerConfig
    cfg = ctr_config()
    F, K = cfg.num_sparse_fields, cfg.embed_dim
    offsets = np.arange(F) * cfg.vocab_size
    model = DeepFM(cfg, sparse_tables=True, device="cuda", seed=0)
    tbls = [HostTable(cfg.total_vocab, dim, lambda ps: Adagrad(ps, 0.05),
                      seed=1 + i) for i, dim in enumerate((K, 1))]
    initial = [tb.table.copy() for tb in tbls]
    timers = [HostTimer(tb) for tb in tbls]

    def loss_fn(m, dense, sparse, labels, erows, einv, lrows, linv):
        b = dense.shape[0]
        return ctr_loss(m.forward_from_emb(
            dense, erows[einv].reshape(b, F, K),
            lrows[linv].reshape(b, F, 1)), labels)
    samples = list(synthetic_ctr(CTR_BATCH * CTR_HOST_STEPS, F,
                                 cfg.num_dense_fields, cfg.vocab_size,
                                 seed=3))
    tr = Trainer(model, Adam(model.parameters(), 1e-3), loss_fn,
                 TrainerConfig(num_ingest_threads=2, log_every=1),
                 sparse_tables=[(tb, lambda b: b[1] + offsets)
                                for tb in tbls], device="cuda")
    torch.cuda.synchronize()
    core.reset_launches()
    stats = tr.train(InMemoryDataset(samples), batch_size=CTR_BATCH)
    launches = core.launch_counts()
    losses = [v for _, v in tr.history]
    if stats["steps"] != CTR_HOST_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"ctr_host: {stats['steps']} steps, losses "
                             f"{losses}")
    check_no_launches("ctr_host", launches)
    touched = np.zeros(cfg.total_vocab, bool)
    touched[(np.stack([s[1] for s in samples]) + offsets).reshape(-1)] = True
    for what, tb, init in zip(("embed", "fm_linear"), tbls, initial):
        moved = (tb.table != init).any(axis=1)
        if not moved[touched].all() or moved[~touched].any():
            raise AssertionError(
                f"ctr_host {what}: {int((~moved[touched]).sum())} touched "
                f"rows still, {int(moved[~touched].sum())} untouched moved")
    inv_bytes = 2 * CTR_BATCH * F * 8
    return dict(
        config=ctr_name(cfg),
        tables=f"2 x HostTable({cfg.total_vocab}, {K} | 1), Adagrad(0.05) "
        "each",
        batch=CTR_BATCH, steps=stats["steps"], ingest_threads=2,
        losses=losses, examples_per_s=CTR_BATCH * stats["steps_per_s"],
        wall_s=stats["wall_s"],
        unique_rows_per_step=float(np.mean(timers[0].rows)),
        pull_ms_per_step={w: float(np.mean(t.pull_ms))
                          for w, t in zip(("embed", "fm_linear"), timers)},
        push_ms_per_step={w: float(np.mean(t.push_ms))
                          for w, t in zip(("embed", "fm_linear"), timers)},
        pcie_bytes_per_step=float(np.mean(
            [a + b for a, b in zip(timers[0].bytes, timers[1].bytes)]))
        + inv_bytes,
        nbytes={w: tb.nbytes() for w, tb in zip(("embed", "fm_linear"),
                                                  tbls)},
        launches=launches, card=smi)


# ------------------------------------------------------------------- main

def train_phase(cfg, smi):
    """The training path at full width; returns (stats, launches)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.optimizer import Adam
    batch, seq, warmup, steps = 16, 512, 2, 10
    model = GPT(cfg, device="cuda", seed=0)
    opt = amp.decorate(Adam(model.parameters(), 1e-4), amp.bf16_policy())
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).cuda()
    losses, times, launches, routes = train(model, opt, loss_of, (ids,),
                                            warmup, steps)
    check_launches("train", launches, steps,
                   train_launches_per_step(cfg.num_layers))
    check_routes("train", routes, "tc")
    check_path_routes("train", routes, ("layer_norm",))
    return dict(step_stats("train", "GPTConfig.small()", batch, seq, losses,
                           times, launches, smi), routes=routes), launches


def step_stats(what, config, batch, seq, losses, times, launches, smi,
               must_fall=True):
    """The training phase's line; raises unless every loss is finite and
    (``must_fall``) the loss fell from the first step to the last."""
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: non-finite loss {losses}")
    if must_fall and not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: loss did not fall {losses}")
    steps = len(times)
    return dict(config=config, batch=batch, seq=seq, policy="bf16",
                optimizer="Adam(1e-4)", warmup=len(losses) - steps,
                steps=steps, losses=losses,
                tokens_per_s=batch * seq * steps / sum(times),
                p50_step_ms=float(np.median(times)) * 1e3,
                mean_step_ms=float(np.mean(times)) * 1e3,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches_per_step={k: n / steps
                                   for k, n in launches.items()},
                card=smi)


def bert_batch(rs, vocab, batch, seq, n_mask, pad_row0=None,
               segment_b=None):
    """A seeded pretraining batch, as ``bench.py``'s ``_bench_mlm`` makes
    it: ids, sorted distinct ``mask_positions`` with their labels,
    ``nsp_labels`` and an ``mlm_mask`` of ones. ``pad_row0`` pads row 0
    after that many tokens (an ``attention_mask``, the positions drawn
    below it); ``segment_b`` starts segment B there (``token_type_ids``).
    Returns the ``bert_loss_of`` arguments after the model, on the
    CPU."""
    ids = rs.randint(0, vocab, (batch, seq))
    att = types = None
    if pad_row0 is not None:
        att = np.ones((batch, seq), np.float32)
        att[0, pad_row0:] = 0.0
    if segment_b is not None:
        types = np.zeros((batch, seq), np.int64)
        types[:, segment_b:] = 1
    pos = np.stack([np.sort(rs.choice(
        pad_row0 if (i == 0 and pad_row0) else seq, n_mask, replace=False))
        for i in range(batch)])
    labels = rs.randint(0, vocab, (batch, n_mask))
    nsp = rs.randint(0, 2, (batch,))
    mlm_mask = np.ones((batch, n_mask), np.float32)
    return tuple(None if a is None else torch.from_numpy(a) for a in (
        ids, labels, nsp, mlm_mask, types, att, pos))


def bert_train_phase(smi):
    """``bench.py``'s BERT row on the card: BertConfig.base() (dropout 0,
    weights from seed 0) under amp.decorate(Adam(1e-4), bf16_policy()) on
    one fixed batch of 64 x 512 with 76 masked positions per row; returns
    (stats, launches)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import Adam
    batch, seq, n_mask, warmup, steps = 64, 512, 76, 2, 10
    cfg = BertConfig.base()
    cfg.dropout = 0.0
    model = BertForPretraining(cfg, device="cuda", seed=0)
    opt = amp.decorate(Adam(model.parameters(), 1e-4), amp.bf16_policy())
    ids, labels, nsp, mlm_mask, _, _, pos = bert_batch(
        np.random.RandomState(0), cfg.vocab_size, batch, seq, n_mask)
    pos = pos.cuda()

    def loss_fn(m, *a):
        return m.loss(*a, mask_positions=pos)

    args = tuple(a.cuda() for a in (ids, labels, nsp, mlm_mask))
    losses, times, launches, routes = train(model, opt, loss_fn, args,
                                            warmup, steps)
    check_launches("bert_train", launches, steps,
                   bert_launches_per_step(cfg.num_layers))
    check_routes("bert_train", routes, "tc")
    check_path_routes("bert_train", routes, ("layer_norm",))
    stats = step_stats("bert_train", "BertConfig.base()", batch, seq,
                       losses, times, launches, smi)
    return dict(stats, masked_positions=n_mask, routes=routes), launches


def bert_large_phase(smi):
    """BertConfig.large() (24 layers, H = 1024, 16 heads, I = 4096, 335 M
    params) at full width and depth on the card: dropout 0, weights from
    seed 0, amp.decorate(Adam(1e-4), bf16_policy()), one fixed seeded
    batch of 8 x 512 with 76 masked positions per row (bench.py's BERT
    batch of 64 cut to 8 to keep the phase short); 1 warm-up and 3 timed
    steps with the launch counts zeroed just before. Every kernel of the
    path must launch its count per step (K5 and K6 once: the width they
    refused before) and every loss must be finite; 4 steps are too few to
    ask the loss to fall. Returns (stats, launches)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import Adam
    batch, seq, n_mask, warmup, steps = 8, 512, 76, 1, 3
    cfg = BertConfig.large()
    cfg.dropout = 0.0
    model = BertForPretraining(cfg, device="cuda", seed=0)
    opt = amp.decorate(Adam(model.parameters(), 1e-4), amp.bf16_policy())
    ids, labels, nsp, mlm_mask, _, _, pos = bert_batch(
        np.random.RandomState(5), cfg.vocab_size, batch, seq, n_mask)
    pos = pos.cuda()

    def loss_fn(m, *a):
        return m.loss(*a, mask_positions=pos)

    args = tuple(a.cuda() for a in (ids, labels, nsp, mlm_mask))
    losses, times, launches, routes = train(model, opt, loss_fn, args,
                                            warmup, steps)
    check_launches("bert_large", launches, steps,
                   bert_launches_per_step(cfg.num_layers))
    check_routes("bert_large", routes, "tc")
    check_path_routes("bert_large", routes, ("layer_norm",))
    stats = step_stats("bert_large", "BertConfig.large()", batch, seq,
                       losses, times, launches, smi, must_fall=False)
    return dict(stats, masked_positions=n_mask, hidden_size=cfg.hidden_size,
                layers=cfg.num_layers, routes=routes), launches


# ---------------------------------------------------------------- trainer

TRAINER_STEPS = 16      # each run's steps
TRAINER_EVERY = 8       # checkpoint interval (saves at 8 and 16); at 4,
                        # saves took 16 s of run A's 20 s (1.32 GB each,
                        # H100 80GB HBM3 at 700 W)
TRAINER_STOP = 10       # R's first run stops here: its last save is 8
TRAINER_POISON = 10     # G's loss is non-finite at steps 10, 11 and 12
TRAINER_WARMUP = 2      # steps left out of the step-time statistics
PUBLISHED_DROPOUT = 0.1  # BertConfig's; the recompute check's second rate
#: the kernels a BERT step launches in its forward (twice under
#: recompute); K3 and K6 launch in the backward only
FORWARD_KERNELS = ("layer_norm", "add_layer_norm", "flash_attention", "mlp",
                   "xent_stats")
FLASH_KERNELS = ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
#: K3's two kernels
K3_KERNELS = FLASH_KERNELS[1:]


class PretrainData:
    """A seekable synthetic pretraining stream at bench's size: batch ``i``
    comes from ``RandomState(seed * 100003 + i)``: ids, each row's
    attention mask cut at a length uniform in [seq/2, seq] (as
    ``examples/pretrain_bert_flash.py`` pads its batches), ``n_mask``
    sorted distinct masked positions per row below that length with their
    labels, NSP labels and an ``mlm_mask`` of ones. ``seek(step)`` makes
    the stream replayable from any step."""

    def __init__(self, vocab, batch=64, seq=512, n_mask=76, seed=0):
        self.vocab, self.b, self.t, self.m = vocab, batch, seq, n_mask
        self.seed = seed
        self.pos = 0

    def seek(self, step):
        self.pos = int(step)

    def batch(self, i):
        rs = np.random.RandomState(self.seed * 100003 + i)
        ids = rs.randint(0, self.vocab, (self.b, self.t))
        lens = rs.randint(self.t // 2, self.t + 1, (self.b,))
        att = (np.arange(self.t)[None, :] < lens[:, None]).astype(np.float32)
        pos = np.stack([np.sort(rs.choice(n, self.m, replace=False))
                        for n in lens])
        labels = rs.randint(0, self.vocab, (self.b, self.m))
        nsp = rs.randint(0, 2, (self.b,))
        return (ids, labels, nsp, np.ones((self.b, self.m), np.float32),
                att, pos)

    def reader(self):
        def feed():
            i = self.pos
            while True:
                yield self.batch(i)
                i += 1
        return feed


def trainer_loss(m, ids, labels, nsp, mlm_mask, att, pos):
    return m.loss(ids, labels, nsp, mlm_mask, attention_mask=att,
                  mask_positions=pos)


def trainer_recipe(model):
    """``decorate(AdamW, bf16_policy())``: warm-up over 4 steps into a
    polynomial decay to 0 at step 16, peak 1e-4, global-norm clip 1.0,
    weight decay 0.01 but for layer-norm scales and biases."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW, ClipByGlobalNorm
    from paddle_tpu_torch.optimizer import lr_scheduler as S
    sched = S.linear_lr_warmup(S.polynomial_decay(1e-4, TRAINER_STEPS, 0.0),
                               4, 0.0, 1e-4)
    return amp.decorate(AdamW(
        model.named_parameters(), sched, weight_decay=0.01,
        decay_mask_fn=lambda name: not name.endswith(("bias", "scale")),
        grad_clip=ClipByGlobalNorm(1.0)), amp.bf16_policy())


def state_bits(model, opt):
    """Copies of every parameter, slot, step count and buffer, by name."""
    named = dict(model.named_parameters())
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[f"{prefix}{k}"] = v.detach().clone()
    with torch.no_grad():
        walk({"params": named, "opt": opt.state_tree(named),
              "buffers": dict(model.named_buffers())}, "")
    return out


def bits_diff(a, b):
    """(all bitwise equal, the largest absolute difference)."""
    equal = sorted(a) == sorted(b) and all(torch.equal(a[k], b[k])
                                           for k in a)
    worst = max(float((a[k].double() - b[k].double()).abs().max())
                for k in a)
    return equal, worst


def trainer_run(model, init, data, ckpt_dir, max_steps, guardian=True,
                poison=None, snap_calls=(), reset=True, runtime=None,
                recipe=trainer_recipe, loss=trainer_loss,
                every=TRAINER_EVERY, warmup=TRAINER_WARMUP):
    """One ``Trainer`` run of ``recipe`` (:func:`trainer_recipe`) over
    ``loss`` on ``data`` (restarted at 0). ``reset`` puts back the
    weights and buffers ``init`` and the dropout generator's seed first.
    The loss function records the host time and the loss of every call,
    copies the whole state at the calls in ``snap_calls`` (before that
    call's step: after the previous step), and makes the loss non-finite
    where the FaultPlan ``poison`` fires. ``runtime``: more TrainerConfig
    fields (telemetry, watchdog, heartbeats); the run then trains as
    worker 0 of 1."""
    from paddle_tpu_torch.static import Trainer, TrainerConfig
    if reset:
        with torch.no_grad():
            for name, t in list(model.named_parameters()) + list(
                    model.named_buffers()):
                t.copy_(init[name])
        if hasattr(model, "dropout_gen"):
            model.dropout_gen.manual_seed(0)
    opt = recipe(model)
    times, losses, snaps = [], [], {}

    def loss_fn(m, *batch):
        if batch[0].is_meta:         # the telemetry's FLOP count: no step
            return loss(m, *batch)
        times.append(time.perf_counter())
        if len(times) in snap_calls:
            snaps[len(times)] = state_bits(model, opt)
        out = loss(m, *batch)
        if poison is not None and poison.check("loss"):
            out = out * float("nan")
        losses.append(out.detach().float())
        return out

    data.seek(0)
    tr = Trainer(model, opt, loss_fn, TrainerConfig(
        max_steps=max_steps, num_ingest_threads=1,
        checkpoint_dir=ckpt_dir, checkpoint_every=every if ckpt_dir else 0,
        guardian=guardian or None, **(runtime or {})), device="cuda")
    tr.train(data, **(dict(num_workers=1, worker_id=0) if runtime else {}))
    torch.cuda.synchronize()
    times.append(time.perf_counter())
    step_ms = np.diff(times) * 1e3
    steps = step_ms[warmup:] / 1e3
    return dict(trainer=tr, opt=opt, snaps=snaps,
                losses=torch.stack(losses).tolist(),
                step_ms=step_ms.tolist(),
                p50_step_ms=float(np.median(steps)) * 1e3,
                mean_step_ms=float(np.mean(steps)) * 1e3)


def set_dropout(model, rate):
    """Every dropout rate of a BERT model: its Dropout layers' and its
    attention's."""
    from paddle_tpu_torch import nn as pnn
    for mod in model.modules():
        if isinstance(mod, pnn.Dropout):
            mod.rate = rate
        elif isinstance(mod, pnn.MultiHeadAttention):
            mod.dropout_rate = rate


def recompute_check(model, data, ckpt_dir):
    """One step from the step-8 checkpoint in ``ckpt_dir``, plain and
    under RecomputeOptimizer, at the model's own dropout rates: (losses,
    whether the loss and every gradient are bitwise equal, the largest
    gradient difference, peak memory of each in GB, launches of
    each)."""
    from paddle_tpu_torch.core import random as R
    from paddle_tpu_torch.io import CheckpointManager
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.optimizer import RecomputeOptimizer
    from paddle_tpu_torch.static import Trainer
    mgr = CheckpointManager(ckpt_dir)
    at = TRAINER_EVERY
    batch = tuple(torch.from_numpy(a).cuda() for a in data.batch(at))
    out = []
    for recompute in (False, True):
        opt = trainer_recipe(model)
        tr = Trainer(model, opt, trainer_loss, device="cuda")
        state, _ = mgr.restore(tr.state(), step=at)
        tr.load_state(state)
        R.set_state(R.step_generators(model, opt),
                    mgr.read_meta(at)["rng"])
        if recompute:
            opt = RecomputeOptimizer(opt)
        del state
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        core.reset_launches()
        loss = opt.minimize(model, trainer_loss, *batch)
        torch.cuda.synchronize()
        out.append((loss, {k: p.grad.clone() for k, p in
                           model.named_parameters() if p.grad is not None},
                    torch.cuda.max_memory_allocated() / 1e9,
                    core.launch_counts()))
    (l0, g0, m0, n0), (l1, g1, m1, n1) = out
    equal, worst = bits_diff(g0, g1)
    return ([float(l0), float(l1)], equal and torch.equal(l0, l1), worst,
            (m0, m1), (n0, n1))


def counter_totals(names):
    from paddle_tpu_torch.observability import metrics as M
    return {n: M.counter(n).total() for n in names}


GUARD_COUNTERS = ("trainer.nonfinite_skips", "trainer.loss_spikes",
                  "trainer.rollbacks")


def runtime_fields(root):
    """Run A's runtime: step telemetry every 4 steps into a RunLog,
    the watchdog (its flight bundles under ``root``) and heartbeats in a
    directory of ``root``."""
    from paddle_tpu_torch.observability import TelemetryConfig
    return dict(telemetry=TelemetryConfig(
        enabled=True, run_log=os.path.join(root, "telemetry.jsonl"),
        every_n_steps=4), watchdog=True, heartbeat=True,
        heartbeat_dir=os.path.join(root, "heartbeat"))


def telemetry_summary(tr, p50_step_ms, tokens):
    """The telemetry's records beside the arithmetic they should match:
    each record's mfu, the counted FLOPs a step, the peak, the MFU that
    tokens/s at the p50 step and the counted FLOPs a token give, the
    last record's device memory, and the span table's top rows."""
    from paddle_tpu_torch.observability import perf, span_summary
    tele = tr.telemetry
    recs = [r for r in tele.records if "step" in r and not r.get("final")]
    flops = tele.flops_per_step
    peak = perf.peak_flops()
    tokens_per_s = tokens / p50_step_ms * 1e3
    return dict(
        records=len(recs), record_steps=[r["step"] for r in recs],
        record_mfu=[r["mfu"] for r in recs],
        record_tokens_per_s=[r["tokens_per_s"] for r in recs],
        record_loss=[r["loss"] for r in recs],
        counted_flops_per_step=flops, peak_flops=peak,
        mfu_from_p50=(tokens_per_s * (flops / tokens) / peak
                      if flops and peak else None),
        memory=recs[-1]["memory"] if recs else None,
        final_record=bool(tele.records and tele.records[-1].get("final")),
        spans_top=[{k: r[k] for k in ("name", "calls", "total_s",
                                      "p50_ms")}
                   for r in span_summary()[:6]],
        watchdog_anomalies=[e["anomaly"] for e in tr.watchdog.anomalies],
        stalled_peers=sorted(tr.stalled_peers))


class SaveClock:
    """Times each ``CheckpointManager.save`` that saves, for the runs
    inside the scope: ``[(step, host seconds the caller was held)]``."""

    def __enter__(self):
        from paddle_tpu_torch.io.checkpoint import CheckpointManager
        self.cls, self.orig, self.saves = (CheckpointManager,
                                           CheckpointManager.save, [])
        orig, saves = self.orig, self.saves

        def timed(mgr, step, *a, **kw):
            t0 = time.perf_counter()
            saved = orig(mgr, step, *a, **kw)
            if saved:
                saves.append((int(step), time.perf_counter() - t0))
            return saved
        self.cls.save = timed
        return self

    def __exit__(self, *exc):
        self.cls.save = self.orig
        return False


def save_timings(tr, root):
    """One save of the whole state: the host time a background ``save()``
    holds the caller, its ``wait()``, and a synchronous save's time."""
    from paddle_tpu_torch.io import CheckpointManager
    out = {}
    for background in (True, False):
        mgr = CheckpointManager(os.path.join(root, f"timing_{background}"),
                                background=background)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(TRAINER_STEPS, tr.state(), force=True)
        t1 = time.perf_counter()
        mgr.wait()
        t2 = time.perf_counter()
        mgr.close()
        if background:
            out.update(save_block_s=t1 - t0, wait_s=t2 - t1)
        else:
            out.update(sync_save_s=t1 - t0)
    t0 = time.perf_counter()
    state, _ = mgr.restore(tr.state(), step=TRAINER_STEPS)
    tr.load_state(state)
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    return out


def trainer_phase(smi, bert_stats):
    """BERT-base pretraining through ``Trainer`` (the JAX package's
    ``examples/pretrain_bert_flash.py`` at bench's size, dropout 0.0 as
    it sets it): run A with the whole runtime (background saves, step
    telemetry, the watchdog, heartbeats, the loop's spans), A0 with none
    of it and synchronous saves (bitwise A), A' (no guardian), R (stop at
    10, resume to 16 from a mirror on a fresh staging directory) and G
    (the loss poisoned at steps 10-12), and a recompute check at dropout
    0.0 and 0.1. The launch counts are zeroed just before A and read just
    after. Returns (line, A's launches)."""
    import shutil
    import tempfile
    from paddle_tpu_torch.io import CheckpointManager, checkpoint, fs
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.observability import flight, perf, reset_spans
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.testing.chaos import FaultPlan
    t_phase = time.perf_counter()
    cfg = BertConfig.base()
    cfg.dropout = 0.0                            # as the example sets it
    model = BertForPretraining(cfg, device="cuda", seed=0)
    init = {k: p.detach().clone() for k, p in model.named_parameters()}
    data = PretrainData(cfg.vocab_size)
    per_step = bert_launches_per_step(cfg.num_layers)
    dense = dict(per_step, **{k: 0 for k in FLASH_KERNELS})
    root = tempfile.mkdtemp(prefix="trainer_phase_")
    flight_before = flight.configure()
    flight.configure(directory=os.path.join(root, "flight"))
    mirror = f"trainerphase{os.getpid()}"
    fs.register_filesystem(mirror, fs.MemFS())
    try:
        reset_spans()
        core.reset_launches()
        with SaveClock() as clock_a:
            a = trainer_run(model, init, data, os.path.join(root, "A"),
                            TRAINER_STEPS, runtime=runtime_fields(root))
        launches_a, routes_a = core.launch_counts(), core.route_counts()
        t0 = time.perf_counter()
        perf.device_memory_stats()
        memory_stats_ms = (time.perf_counter() - t0) * 1e3
        bits_a = state_bits(model, a["opt"])
        ckpt_bytes = os.path.getsize(os.path.join(
            root, "A", str(TRAINER_STEPS), "state.pt"))
        shutil.rmtree(os.path.join(root, "A"))   # each run's 2 steps: 2.6 GB
        check_launches("trainer A", launches_a, TRAINER_STEPS, per_step)
        check_routes("trainer A", routes_a, "tc")
        check_path_routes("trainer A", routes_a, ("layer_norm",))
        runtime = telemetry_summary(a["trainer"], a["p50_step_ms"],
                                    data.b * data.t)
        checkpoint.configure(background=False)
        try:
            with SaveClock() as clock_a0:
                a0 = trainer_run(model, init, data,
                                 os.path.join(root, "A0"), TRAINER_STEPS)
        finally:
            checkpoint.configure(background=True)
        shutil.rmtree(os.path.join(root, "A0"))
        a0_equal, a0_state = bits_diff(bits_a, state_bits(model, a0["opt"]))
        a0_loss_equal = a0["losses"] == a["losses"]
        a2 = trainer_run(model, init, data, None, TRAINER_STEPS,
                         guardian=False)
        rep_equal, rep_state = bits_diff(bits_a, state_bits(model,
                                                            a2["opt"]))
        rep_loss = max(abs(x - y) for x, y in zip(a["losses"],
                                                    a2["losses"]))
        ckpt_r = f"{mirror}://trainer/R"
        r1 = trainer_run(model, init, data, ckpt_r, TRAINER_STOP)
        mirrored = sorted(n for n in fs.listdir(ckpt_r) if n.isdigit()
                          and fs.fs_exists(f"{ckpt_r}/{n}/COMMIT"))
        staging = CheckpointManager(ckpt_r).path
        recompute = {}
        for rate in (cfg.dropout, PUBLISHED_DROPOUT):
            set_dropout(model, rate)
            recompute[rate] = recompute_check(model, data, ckpt_r)
        set_dropout(model, cfg.dropout)
        shutil.rmtree(staging)                   # a fresh host
        with torch.no_grad():                    # the resume must restore
            for p in model.parameters():
                p.zero_()
        r2 = trainer_run(model, init, data, ckpt_r, TRAINER_STEPS,
                         reset=False)
        r_equal, r_state = bits_diff(bits_a, state_bits(model, r2["opt"]))
        fs.remove_tree(ckpt_r)
        shutil.rmtree(staging, ignore_errors=True)
        plan = FaultPlan().poison("loss", nth=TRAINER_POISON, times=3)
        g_before = counter_totals(GUARD_COUNTERS)
        g = trainer_run(model, init, data, os.path.join(root, "G"),
                        TRAINER_STEPS, poison=plan,
                        snap_calls=(TRAINER_POISON, TRAINER_POISON + 1))
        g_counts = {k: v - g_before[k]
                    for k, v in counter_totals(GUARD_COUNTERS).items()}
        g_equal, g_state = bits_diff(bits_a, state_bits(model, g["opt"]))
        skip_equal, _ = bits_diff(g["snaps"][TRAINER_POISON],
                                  g["snaps"][TRAINER_POISON + 1])
        guard = g["trainer"].guardian
        actions = [rec["action"] for rec in guard.log if "action" in rec]
        at = next(rec["step"] for rec in guard.log
                  if rec["guardian"] == "rollback")
        restored = next(rec["restored_step"] for rec in guard.log
                        if rec["guardian"] == "rollback_done")
        g_losses = g["losses"][at:]              # steps restored + 1 ..
        del g, bits_a
        shutil.rmtree(os.path.join(root, "G"))
        tr = r2["trainer"]
        saves = save_timings(tr, root)
        r_losses = r2["losses"]                  # steps 9 .. 16 (from 8)
        del tr, r2
    finally:
        flight._SETTINGS.update(flight_before)
        fs._REGISTRY.pop(mirror, None)
        shutil.rmtree(root, ignore_errors=True)
    a_losses = a["losses"]
    pre = slice(TRAINER_WARMUP, TRAINER_EVERY - 1)     # steps 3 .. 7
    post = slice(TRAINER_EVERY, TRAINER_STEPS - 1)     # steps 9 .. 15
    last_save = TRAINER_STOP // TRAINER_EVERY * TRAINER_EVERY
    r_loss = max(abs(x - y) for x, y in zip(r_losses,
                                              a_losses[last_save:]))
    g_loss = max(abs(x - y) for x, y in zip(g_losses, a_losses[restored:]))
    plain_want = {cfg.dropout: per_step, PUBLISHED_DROPOUT: dense}
    line = dict(
        phase="trainer", config="BertConfig.base()", dropout=cfg.dropout,
        batch=data.b, seq=data.t, masked_positions=data.m,
        attention_mask="each row cut at a length uniform in [256, 512]",
        optimizer="decorate(AdamW(wd 0.01, no decay on LN scales and "
                  "biases), bf16): linear_lr_warmup(4, 0 -> 1e-4) into "
                  "polynomial_decay(1e-4, 16, 0), ClipByGlobalNorm(1.0)",
        steps=TRAINER_STEPS, checkpoint_every=TRAINER_EVERY,
        runtime_a="background saves, telemetry every 4 steps to a RunLog, "
                  "watchdog, heartbeats (worker 0 of 1), spans",
        tokens_per_s=data.b * data.t / a["p50_step_ms"] * 1e3,
        p50_step_ms=a["p50_step_ms"], mean_step_ms=a["mean_step_ms"],
        a0_p50_step_ms=a0["p50_step_ms"], a0_mean_step_ms=a0["mean_step_ms"],
        runtime_ms=float(np.median(a["step_ms"][pre]) - np.median(
            a0["step_ms"][pre])),
        runtime_note="median of steps 3-7 (before the first save), A less "
                     "A0",
        write_window_ms=float(np.sum(np.array(a["step_ms"][post]) - np.median(
            a["step_ms"][pre]))),
        write_window_note="steps 9-15 (the background write of step 8 "
                          "beside them), each less A's median of steps 3-7",
        step_ms_a=a["step_ms"], step_ms_a0=a0["step_ms"],
        save_held_s_a=clock_a.saves, save_held_s_a0=clock_a0.saves,
        memory_stats_ms=memory_stats_ms,
        a0_bitwise=a0_equal and a0_loss_equal, a0_max_state_diff=a0_state,
        unguarded_p50_step_ms=a2["p50_step_ms"],
        unguarded_mean_step_ms=a2["mean_step_ms"],
        gate_ms=a["p50_step_ms"] - a2["p50_step_ms"],
        bert_train_tokens_per_s=bert_stats["tokens_per_s"],
        bert_train_p50_step_ms=bert_stats["p50_step_ms"],
        telemetry=runtime,
        losses_a=a_losses, losses_a0=a0["losses"], losses_a2=a2["losses"],
        losses_r_first=r1["losses"], losses_r_resumed=r_losses,
        losses_g_replayed=g_losses,
        repeatable=rep_equal, repeat_max_loss_diff=rep_loss,
        repeat_max_state_diff=rep_state,
        mirror="MemFS under a scheme of the run; R resumed on an empty "
               "staging directory", mirrored_steps=mirrored,
        resume_equal=r_equal, resume_max_loss_diff=r_loss,
        resume_max_state_diff=r_state,
        rollback_equal=g_equal, rollback_max_loss_diff=g_loss,
        rollback_max_state_diff=g_state,
        skip_bit_identical=skip_equal, guardian_actions=actions,
        guardian_skips=guard.skips, guardian_rollbacks=guard.rollbacks,
        guardian_counters=g_counts,
        rollback_at=at, restored_step=restored, poison_fired=plan.fired(),
        recompute={f"dropout {rate}": dict(
            losses=rc[0], bitwise=rc[1], max_grad_diff=rc[2],
            peak_memory_gb=rc[3][0], recompute_peak_memory_gb=rc[3][1],
            launches={kk: rc[4][1][kk] for kk in per_step})
            for rate, rc in recompute.items()},
        checkpoint_bytes=ckpt_bytes, **saves,
        launches_a_per_step={kk: launches_a[kk] / TRAINER_STEPS
                             for kk in per_step},
        routes_a={kk: routes_a[kk] for kk in TC_KERNELS},
        seconds=time.perf_counter() - t_phase, card=smi)
    emit(line)
    if not all(np.isfinite(a_losses)):
        raise AssertionError("trainer: a non-finite loss in A")
    if not (a0_equal and a0_loss_equal):
        raise AssertionError(f"trainer A0: the runtime changed a number "
                             f"(state differs by {a0_state})")
    if (runtime["records"] != TRAINER_STEPS // 4 or not runtime[
            "final_record"] or not runtime["counted_flops_per_step"]
            or runtime["memory"] is None):
        raise AssertionError(f"trainer A: telemetry incomplete {runtime}")
    if mirrored != [str(TRAINER_EVERY)]:
        raise AssertionError(f"trainer R: mirrored steps {mirrored}")
    # R and G equal A as far as A' (a second uninterrupted run) does:
    # bitwise when A' is bitwise equal, else within A''s differences
    for what, equal, dl, ds in (("resume", r_equal, r_loss, r_state),
                                ("rollback", g_equal, g_loss, g_state)):
        if (rep_equal and not equal) or dl > rep_loss or ds > rep_state:
            raise AssertionError(
                f"trainer {what}: differs from A by {dl} (loss) and {ds} "
                f"(state), beyond A''s {rep_loss} and {rep_state}")
    if not skip_equal:
        raise AssertionError("trainer G: the refused step changed the "
                             "state")
    if (actions != ["skip", "reread", "rollback"] or guard.rollbacks != 1
            or restored != TRAINER_EVERY or plan.fired() != 3
            or g_counts != {"trainer.nonfinite_skips": 3,
                            "trainer.loss_spikes": 0,
                            "trainer.rollbacks": 1}):
        raise AssertionError(f"trainer G: ladder {actions}, rollbacks "
                             f"{guard.rollbacks}, restored {restored}, "
                             f"poison fired {plan.fired()}, counters "
                             f"{g_counts}")
    for rate, (_, rc_equal, rc_worst, _, rc_launches) in recompute.items():
        if not rc_equal:
            raise AssertionError(
                f"trainer: at dropout {rate} the recompute step differs "
                f"from the plain one by {rc_worst}")
        want = plain_want[rate]
        check_launches(f"trainer plain step, dropout {rate}",
                       rc_launches[0], 1, want)
        check_launches(f"trainer recompute step, dropout {rate}",
                       rc_launches[1], 1,
                       {kk: n * (2 if kk in FORWARD_KERNELS else 1)
                        for kk, n in want.items()})
    return line, launches_a


# ------------------------------------------------ the Trainer on ResNet

RESNET_TRAINER_BATCH = 64
RESNET_TRAINER_STEPS = 12
RESNET_TRAINER_EVERY = 4
RESNET_TRAINER_STOP = 6      # R's first run stops here: its last save is 4
RESNET_TRAINER_POISON = 6    # G's loss is non-finite at steps 6, 7 and 8


class ImageData:
    """A seekable stream of :func:`image_batch` batches: batch ``i`` from
    ``RandomState(seed * 100003 + i)``."""

    def __init__(self, batch, size=224, classes=1000, seed=0):
        self.b, self.size, self.classes, self.seed = batch, size, classes, seed
        self.pos = 0

    def seek(self, step):
        self.pos = int(step)

    def batch(self, i):
        images, labels = image_batch(np.random.RandomState(
            self.seed * 100003 + i), self.b, self.size, self.classes)
        return images.numpy(), labels.numpy()

    def reader(self):
        def feed():
            i = self.pos
            while True:
                yield self.batch(i)
                i += 1
        return feed


def resnet_recipe(model):
    """``bench.py:1228``'s optimizer: decorate(Momentum(0.1, 0.9),
    bf16_policy())."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import Momentum
    return amp.decorate(Momentum(model.parameters(), 0.1, 0.9),
                        amp.bf16_policy())


def trainer_resnet_phase(smi):
    """resnet50(1000) through ``Trainer`` at 64 x 224², checkpoints every
    4 steps, the guardian on, 12 steps, cuDNN deterministic: run A; A'
    (no guardian) for the run-to-run difference; R (stop at 6, resume
    from 4 onto zeroed weights and reset buffers) bitwise A; G (the loss
    non-finite at steps 6-8: skip, re-read, roll back to 4) with the BN
    statistics after the refused step bitwise the ones before it, and
    the final state equal to A's as far as A' is. No kernel of the port
    launches. Returns (line, launches)."""
    import shutil
    import tempfile
    from paddle_tpu_torch.models import resnet50
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.testing.chaos import FaultPlan
    t_phase = time.perf_counter()
    model = resnet50(1000, device="cuda", seed=0)
    init = {k: t.detach().clone() for k, t in list(
        model.named_parameters()) + list(model.named_buffers())}
    data = ImageData(RESNET_TRAINER_BATCH)
    kw = dict(recipe=resnet_recipe, loss=xent_mean,
              every=RESNET_TRAINER_EVERY, warmup=2)
    root = tempfile.mkdtemp(prefix="trainer_resnet_")
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    try:
        core.reset_launches()
        with SaveClock() as clock:
            a = trainer_run(model, init, data, os.path.join(root, "A"),
                            RESNET_TRAINER_STEPS, **kw)
        bits_a = state_bits(model, a["opt"])
        a2 = trainer_run(model, init, data, None, RESNET_TRAINER_STEPS,
                         guardian=False, **kw)
        rep_equal, rep_state = bits_diff(bits_a, state_bits(model,
                                                            a2["opt"]))
        ckpt_r = os.path.join(root, "R")
        trainer_run(model, init, data, ckpt_r, RESNET_TRAINER_STOP, **kw)
        with torch.no_grad():                    # the resume must restore
            for p in model.parameters():
                p.zero_()
            for name, b in model.named_buffers():
                b.fill_(1.0 if name.endswith("variance") else 0.0)
        r2 = trainer_run(model, init, data, ckpt_r, RESNET_TRAINER_STEPS,
                         reset=False, **kw)
        r_equal, r_state = bits_diff(bits_a, state_bits(model, r2["opt"]))
        plan = FaultPlan().poison("loss", nth=RESNET_TRAINER_POISON, times=3)
        g_before = counter_totals(GUARD_COUNTERS)
        g = trainer_run(model, init, data, os.path.join(root, "G"),
                        RESNET_TRAINER_STEPS, poison=plan,
                        snap_calls=(RESNET_TRAINER_POISON,
                                    RESNET_TRAINER_POISON + 1), **kw)
        g_counts = {k: v - g_before[k]
                    for k, v in counter_totals(GUARD_COUNTERS).items()}
        launches = core.launch_counts()
        g_equal, g_state = bits_diff(bits_a, state_bits(model, g["opt"]))
        before, after = (g["snaps"][RESNET_TRAINER_POISON],
                         g["snaps"][RESNET_TRAINER_POISON + 1])
        bn_keys = [k for k in before if k.startswith("buffers/")]
        bn_equal = all(torch.equal(before[k], after[k]) for k in bn_keys)
        skip_equal, _ = bits_diff(before, after)
        guard = g["trainer"].guardian
        actions = [rec["action"] for rec in guard.log if "action" in rec]
        restored = next(rec["restored_step"] for rec in guard.log
                        if rec["guardian"] == "rollback_done")
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = bench
        shutil.rmtree(root, ignore_errors=True)
    line = dict(
        phase="trainer_resnet", config="resnet50(1000)",
        batch=RESNET_TRAINER_BATCH, image=[3, 224, 224], policy="bf16",
        optimizer="decorate(Momentum(0.1, 0.9), bf16_policy())",
        steps=RESNET_TRAINER_STEPS, checkpoint_every=RESNET_TRAINER_EVERY,
        cudnn_deterministic=True,
        images_per_s=RESNET_TRAINER_BATCH / a["p50_step_ms"] * 1e3,
        p50_step_ms=a["p50_step_ms"], mean_step_ms=a["mean_step_ms"],
        unguarded_p50_step_ms=a2["p50_step_ms"],
        step_ms_a=a["step_ms"], step_ms_a2=a2["step_ms"],
        save_held_s_a=clock.saves,
        losses_a=a["losses"], losses_a2=a2["losses"],
        repeatable=rep_equal, repeat_max_state_diff=rep_state,
        resume_equal=r_equal, resume_max_state_diff=r_state,
        rollback_equal=g_equal, rollback_max_state_diff=g_state,
        bn_buffers=len(bn_keys), bn_unchanged_by_refused_step=bn_equal,
        skip_bit_identical=skip_equal, guardian_actions=actions,
        guardian_counters=g_counts, restored_step=restored,
        poison_fired=plan.fired(), launches={k: n for k, n in
                                             launches.items() if n},
        seconds=time.perf_counter() - t_phase, card=smi)
    emit(line)
    check_no_launches("trainer_resnet", launches)
    if not all(np.isfinite(a["losses"])):
        raise AssertionError("trainer_resnet: a non-finite loss in A")
    if not r_equal:
        raise AssertionError(f"trainer_resnet R: differs from A by "
                             f"{r_state}")
    if (rep_equal and not g_equal) or g_state > rep_state:
        raise AssertionError(f"trainer_resnet G: differs from A by "
                             f"{g_state}, beyond A''s {rep_state}")
    if not (bn_keys and bn_equal and skip_equal):
        raise AssertionError("trainer_resnet G: the refused step changed "
                             "the state or the BN statistics")
    if (actions != ["skip", "reread", "rollback"]
            or restored != RESNET_TRAINER_EVERY or plan.fired() != 3
            or g_counts != {"trainer.nonfinite_skips": 3,
                            "trainer.loss_spikes": 0,
                            "trainer.rollbacks": 1}):
        raise AssertionError(f"trainer_resnet G: ladder {actions}, "
                             f"restored {restored}, counters {g_counts}")
    return line, launches


# ------------------------------------------------------------ translate

def transformer_launches_per_step(cfg):
    """K8's launches a Transformer step: 2 post-norm residuals per encoder
    layer, 3 per decoder layer. Nothing else of the port launches: the
    attention is dense, the FFN unfused and the loss the hv layout, as in
    the reference."""
    return {"add_layer_norm": 2 * cfg.enc_layers + 3 * cfg.dec_layers}


def transformer_kernel_cases(dev):
    """K8 as the bf16 policy's Transformer calls it: f32 rows with bf16
    scale and bias, at TransformerConfig.big()'s [32 x 256, 1024] (timed
    beside its plain version, F.layer_norm(x + h) and its bound) and at a
    ragged row count; a bf16 x with an f32 h must still raise."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.cuda import layer_norm as ln
    g = torch.Generator(device="cpu").manual_seed(11)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    cases = []
    for r_, c_ in ((32 * 256, 1024), (8189, 1024)):
        x, h = randn(r_, c_, scale=3.0), randn(r_, c_)
        gam = randn(c_, scale=0.1, dtype=torch.bfloat16) + 1.0
        bet = randn(c_, scale=0.1, dtype=torch.bfloat16)
        got = ln.add_layer_norm_kernel(x, h, gam, bet, 1e-5)
        case = dict(kernel="add_layer_norm", variant="mixed",
                    shape=[r_, c_], dtype=str(torch.float32),
                    params_dtype=str(torch.bfloat16),
                    config="TransformerConfig.big()",
                    **held(f"add_layer_norm mixed {[r_, c_]}", got,
                           ln.add_layer_norm_plain(x, h, gam, bet, 1e-5),
                           torch.float32))
        if not cases:
            gf, bf = gam.float(), bet.float()
            case.update(
                kernel_ms=time_ms(lambda: ln.add_layer_norm_kernel(
                    x, h, gam, bet, 1e-5)),
                plain_ms=time_ms(lambda: ln.add_layer_norm_plain(
                    x, h, gam, bet, 1e-5)),
                library_ms=time_ms(lambda: F.layer_norm(
                    x + h, (c_,), gf, bf, 1e-5)),
                library="F.layer_norm(x + h, gamma.float(), beta.float())")
            case["bound_ms"], case["bound_by"] = bound_ms(
                nbytes(x, h, gam, bet, *got), 10 * x.numel(), torch.float32)
        cases.append(case)
    try:
        ln.add_layer_norm_kernel(x.to(torch.bfloat16), h, gam, bet, 1e-5)
    except TypeError as err:
        cases[-1]["x_bf16_h_f32_raises"] = str(err)
    else:
        raise AssertionError("add_layer_norm: bf16 x with f32 h launched")
    return cases


def transformer_batch(rs, vocab, batch, seq):
    """``bench.py``'s Transformer batch: src, tgt_in and tgt_out uniform in
    ``[1, vocab)``, drawn in that order."""
    return tuple(torch.from_numpy(rs.randint(1, vocab, (batch, seq)))
                 for _ in range(3))


def transformer_phase(smi):
    """``bench.py:380 bench_transformer`` on the card:
    TransformerConfig.big() (d 1024, 16 heads, FFN 4096, 6 + 6 layers,
    vocab 32000; dropout 0, weights from seed 0), Transformer.loss
    (label smoothing 0.1, pad 0) under amp.decorate(Adam(1e-4),
    bf16_policy()) on one fixed batch of 32 x 256; 2 warm-up and 5 timed
    steps with the launch counts zeroed just before. K8 launches 30 a
    step and nothing else of the port; the activations are f32 (the
    reference promotes them so); every loss is finite and falls. Returns
    (stats, launches)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig)
    from paddle_tpu_torch.optimizer import Adam
    batch, seq, warmup, steps = 32, 256, 2, 5
    cfg = TransformerConfig.big()
    cfg.dropout = 0.0
    model = Transformer(cfg, device="cuda", seed=0)
    opt = amp.decorate(Adam(model.parameters(), 1e-4), amp.bf16_policy())
    args = tuple(a.cuda() for a in transformer_batch(
        np.random.RandomState(0), cfg.tgt_vocab, batch, seq))
    seen = {}

    def record(name):
        def hook(module, inputs, out):
            seen.setdefault(name, out.dtype)   # returns None: out unchanged
        return hook

    hooks = [layer.register_forward_hook(record(name))
             for name, layer in (("encoder", model.enc_layers[0]),
                                 ("decoder", model.dec_layers[-1]))]
    try:
        losses, times, launches, _ = train(
            model, opt, lambda m, *a: m.loss(*a), args, warmup, steps)
    finally:
        for hook in hooks:
            hook.remove()
    if set(seen.values()) != {torch.float32}:
        raise AssertionError(f"transformer_big: activations {seen}, the "
                             "reference's are float32")
    want = transformer_launches_per_step(cfg)
    check_launches("transformer_big", launches, steps, want)
    others = {k: n for k, n in launches.items() if n and k not in want}
    if others:
        raise AssertionError(f"transformer_big: other kernels launched "
                             f"{others}")
    stats = step_stats("transformer_big", "TransformerConfig.big()", batch,
                       seq, losses, times, launches, smi)
    return dict(stats, label_smoothing=0.1, activations=str(torch.float32),
                params=sum(p.numel() for p in model.parameters())), launches


class ReluReplay:
    """The card's ReLU branches, replayed on the CPU. ReLU's derivative
    jumps at 0, so a pre-activation that rounds to the other side of 0 on
    one device (f32 sums in another order: about 1e-6) gives that unit's
    whole outer product to one device's weight gradient and not to the
    other's: about 1.4e-3 relative L2 of an FFN weight of the
    Transformer's crosscheck per such entry. ``around("cuda")`` records
    each ``ops.activations.relu`` call's mask in order; ``around("cpu")``
    computes ``where(card mask, x, 0)`` instead, so both devices
    differentiate the same piecewise-linear function, and counts the
    entries where the CPU's own sign disagrees: each must lie within
    ``tol`` (RELU_FLIP_TOL unless given; None: no bar) of 0, or the replay
    raises."""

    def __init__(self, tol=RELU_FLIP_TOL):
        self.masks, self.flips, self.worst, self.tol = [], 0, 0.0, tol

    @contextlib.contextmanager
    def __call__(self, dev):
        from paddle_tpu_torch.ops import activations
        real, calls = activations.relu, iter(range(10 ** 9))

        def record(x):
            self.masks.append(x > 0)
            return real(x)

        def replay(x):
            mask = self.masks[next(calls)].to(x.device)
            flipped = mask != (x > 0)
            if bool(flipped.any()):
                self.flips += int(flipped.sum())
                self.worst = max(self.worst,
                                 float(x.detach()[flipped].abs().max()))
            return torch.where(mask, x, torch.zeros_like(x))

        activations.relu = record if dev == "cuda" else replay
        try:
            yield
        finally:
            activations.relu = real
        if dev != "cuda" and self.tol is not None and self.worst > self.tol:
            raise AssertionError(f"relu replay: a pre-activation {self.worst}"
                                 f" from 0 has another sign on the card "
                                 f"(tol {self.tol})")

    def summary(self):
        return dict(relu_calls=len(self.masks), relu_flips=self.flips,
                    relu_flip_worst=self.worst, relu_flip_tol=self.tol)


def transformer_crosscheck_phase():
    """One f32 step (TF32 off) of TransformerConfig.big() at batch 2 x 64
    on the card and on the CPU plain path from the same weights, row 1's
    source padded after 40 tokens (``src_mask``) and pad ids in
    ``tgt_out``: the loss within TRAIN_LOSS_TOL, every gradient within
    TRAIN_GRAD_TOL relative L2, the CPU taking the card's ReLU branches
    (:class:`ReluReplay`: the entries where the two differ, each within
    RELU_FLIP_TOL of 0, are counted in the line). Then the same batch under the bf16 policy
    (f32 activations, bf16 weights): the card's loss within 1e-3 of the
    CPU's. Returns the f32 step's launches."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.transformer import (Transformer,
                                                     TransformerConfig)
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.optimizer import Adam
    cfg = TransformerConfig.big()
    cfg.dropout = 0.0
    src, tgt_in, tgt_out = transformer_batch(np.random.RandomState(6),
                                             cfg.tgt_vocab, 2, 64)
    src_mask = torch.ones(2, 64)
    src_mask[1, 40:] = 0.0
    src[1, 40:] = 0
    tgt_out[0, 50:] = 0
    tgt_out[1, 30:] = 0
    args = (src, tgt_in, tgt_out, src_mask)
    launches = crosscheck_phase(
        "transformer_crosscheck", "TransformerConfig.big()",
        lambda dev: Transformer(cfg, device=dev, seed=0),
        lambda m, *a: m.loss(*a), args, 2, 64, ("add_layer_norm",),
        around=ReluReplay(), src_mask="row 1 padded after 40 tokens",
        tgt_out_pads=int((tgt_out == 0).sum()))
    bf16 = {}
    for dev in ("cuda", "cpu"):
        model = Transformer(cfg, device=dev, seed=0)
        opt = amp.decorate(Adam(model.parameters(), 1e-4), amp.bf16_policy())
        core.reset_launches()
        bf16[dev] = float(opt.minimize(model, lambda m, *a: m.loss(*a),
                                       *(a.to(dev) for a in args)))
        del model, opt
    emit(dict(phase="transformer_crosscheck_bf16", loss_card=bf16["cuda"],
              loss_cpu=bf16["cpu"], tol=TRANSLATE_BF16_LOSS_TOL))
    check("transformer_crosscheck bf16 loss", abs(bf16["cuda"] - bf16["cpu"]),
          TRANSLATE_BF16_LOSS_TOL)
    return launches


class _Margins:
    """Records the CPU beam search's near ties: ``ops.rnn.top_k`` wrapped
    so that each selection step keeps, per batch row, the smallest gap
    between neighbouring candidates among the k + 1 best live ones (a
    gap that decides which hypotheses survive and in what order)."""

    def __init__(self, rnn):
        self.rnn, self.real = rnn, rnn.top_k
        self.rows = None

    def __enter__(self):
        def top_k(x, k):
            vals, _ = self.real(x, min(k + 1, x.shape[-1]))
            live = vals > self.rnn.NEG_INF / 2
            gaps = torch.where(live[:, 1:] & live[:, :-1],
                               vals[:, :-1] - vals[:, 1:],
                               torch.full_like(vals[:, 1:], float("inf")))
            low = gaps.min(dim=1).values
            self.rows = low if self.rows is None else torch.minimum(
                self.rows, low)
            return self.real(x, k)

        self.rnn.top_k = top_k
        return self

    def __exit__(self, *exc):
        self.rnn.top_k = self.real


def seq2seq_batch(rs, vocab, batch, src_len, tgt_len, lo, bos=1):
    """Sources of lengths uniform in ``[lo, src_len]`` padded to
    ``src_len``, targets of ``tgt_len`` (ids in ``[3, vocab)``), the
    BOS-prefixed decoder inputs and the target lengths."""
    lengths = rs.randint(lo, src_len + 1, batch)
    src = rs.randint(3, vocab, (batch, src_len))
    src[np.arange(src_len)[None, :] >= lengths[:, None]] = 0
    tgt = rs.randint(3, vocab, (batch, tgt_len))
    tgt_in = np.concatenate([np.full((batch, 1), bos), tgt[:, :-1]], 1)
    return tuple(torch.from_numpy(a) for a in (
        src, lengths, tgt_in, tgt, np.full(batch, tgt_len)))


def seq2seq_phase(smi):
    """The attention seq2seq at Seq2SeqConfig()'s own widths (vocab 1024,
    embed 64, hidden 128, bidirectional GRU encoder) on the card: 5 f32
    Adam(3e-2) steps teacher-forced with ``seq2seq.nmt_loss`` on one
    batch of 64 (sources of lengths uniform in [8, 32] padded to 32,
    targets of 32), the loss finite and falling; then greedy_decode
    (max_len 32) and beam_decode (beam 4, max_len 32) on the card and on
    the CPU from the trained weights (the large rate makes the trained
    distributions peaked enough that few choices are near ties). Greedy
    rows: equal to the CPU's, or
    each card token (to the row's first eos) within SEQ2SEQ_LOGIT_TOL of
    the CPU's argmax when the card's tokens are teacher-forced through the
    CPU model. Beams: every card hypothesis's score that of the CPU model
    for it; each row equal to the CPU's with scores within
    SEQ2SEQ_SCORE_TOL, or the CPU's search met a near tie (two of the
    k + 1 best live candidates within SEQ2SEQ_LOGIT_TOL) in that row. The
    path launches no kernel of the port (the reference runs none)."""
    from paddle_tpu_torch.models import seq2seq as s2s
    from paddle_tpu_torch.ops import rnn
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.optimizer import Adam
    batch, src_len, tgt_len, steps, beam, max_len = 64, 32, 32, 5, 4, 32
    bos, eos = 1, 2
    cfg = s2s.Seq2SeqConfig()
    model = s2s.AttentionSeq2Seq(cfg, device="cuda", seed=0)
    opt = Adam(model.parameters(), 3e-2)
    src, lengths, tgt_in, tgt, tgt_lengths = (a.cuda() for a in seq2seq_batch(
        np.random.RandomState(9), cfg.tgt_vocab, batch, src_len, tgt_len, 8))

    def loss_fn(m, src, lengths, tgt_in, tgt, tgt_lengths):
        return s2s.nmt_loss(m(src, lengths, tgt_in), tgt, tgt_lengths)

    core.reset_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(opt.minimize(model, loss_fn, src, lengths,
                                         tgt_in, tgt, tgt_lengths)))
        times.append(time.perf_counter() - t0)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"seq2seq: losses {losses}")
    cpu = s2s.AttentionSeq2Seq(cfg, device="cpu", seed=1)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    def timed(fn, *a):
        """``(fn(*a), seconds)``, the card's queue drained before and
        after."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    decoded = {}
    for name, dev_model in (("cuda", model), ("cpu", cpu)):
        a = (src.to(dev_model.device), lengths.to(dev_model.device))
        with torch.no_grad():
            greedy, greedy_s = timed(dev_model.greedy_decode, *a, bos, eos,
                                     max_len)
            with (_Margins(rnn) if name == "cpu"
                  else contextlib.nullcontext()) as margins:
                (seqs, scores), beam_s = timed(dev_model.beam_decode, *a,
                                               bos, eos, beam, max_len)
        decoded[name] = dict(greedy=greedy.cpu(), seqs=seqs.cpu(),
                             scores=scores.cpu(), greedy_s=greedy_s,
                             beam_s=beam_s, margins=margins)
    launches = core.launch_counts()
    if sum(launches.values()):
        raise AssertionError(f"seq2seq: kernels launched {launches}")
    card, host = decoded["cuda"], decoded["cpu"]
    greedy_rows = held_greedy(cpu, src.cpu(), lengths.cpu(), card["greedy"],
                              host["greedy"], bos, eos)
    beam_rows = held_beams(cpu, src.cpu(), lengths.cpu(), card, host, bos,
                           eos)
    return dict(config="Seq2SeqConfig()", batch=batch, src_len=src_len,
                tgt_len=tgt_len, optimizer="Adam(3e-2)", dtype="float32",
                losses=losses, p50_step_ms=float(np.median(times)) * 1e3,
                greedy=dict(max_len=max_len, ms=card["greedy_s"] * 1e3,
                            tokens_per_s=batch * max_len / card["greedy_s"],
                            **greedy_rows),
                beam=dict(beam=beam, max_len=max_len, ms=card["beam_s"] * 1e3,
                          tokens_per_s=batch * max_len / card["beam_s"],
                          **beam_rows),
                tokens_counted="batch x max_len (one output row a source)",
                launches=launches, card=smi)


def held_greedy(cpu, src, lengths, card, host, bos, eos):
    """Greedy rows equal to the CPU's, or held: the card's tokens
    teacher-forced through the CPU model, each (to the row's first eos)
    the CPU's argmax or within SEQ2SEQ_LOGIT_TOL of it."""
    diff = [int(i) for i in torch.nonzero((card != host).any(1))[:, 0]]
    worst = 0.0
    if diff:
        tgt_in = torch.cat([torch.full((card.shape[0], 1), bos,
                                       dtype=card.dtype), card[:, :-1]], 1)
        with torch.no_grad():
            logits = cpu(src, lengths, tgt_in.long())
        picked = logits.gather(2, card.long()[..., None])[..., 0]
        short = logits.max(-1).values - picked
        for row in diff:
            toks = card[row].tolist()
            end = toks.index(eos) + 1 if eos in toks else len(toks)
            worst = max(worst, float(short[row, :end].max()))
        if worst > SEQ2SEQ_LOGIT_TOL:
            raise AssertionError(f"seq2seq greedy: a card token is {worst} "
                                 "below the CPU's argmax (tol "
                                 f"{SEQ2SEQ_LOGIT_TOL})")
    return dict(rows_exact=card.shape[0] - len(diff), rows_held=len(diff),
                worst_short=worst, tol=SEQ2SEQ_LOGIT_TOL)


def beam_scores_on(model, src, lengths, seqs, bos, eos):
    """The score of each hypothesis ``seqs`` ``[B, K, T]`` under
    ``model``, teacher-forced: the sum of the log-probs of its tokens up
    to and including its first eos (a finished beam extends with eos at
    zero cost)."""
    b, k, t = seqs.shape
    flat = seqs.reshape(b * k, t).long()
    tgt_in = torch.cat([torch.full((b * k, 1), bos, dtype=flat.dtype),
                        flat[:, :-1]], 1)
    with torch.no_grad():
        logp = torch.log_softmax(model(
            torch.repeat_interleave(src, k, 0),
            torch.repeat_interleave(lengths, k, 0), tgt_in), -1)
    picked = logp.gather(2, flat[..., None])[..., 0]
    is_eos = (flat == eos).long()
    before = torch.cumsum(is_eos, 1) - is_eos        # eos seen before t
    return (picked * (before == 0)).sum(1).reshape(b, k)


def held_beams(cpu, src, lengths, card, host, bos, eos):
    """Every card hypothesis scored as the card scored it when the CPU
    model rescores it (within SEQ2SEQ_SCORE_TOL and the rounding of a sum
    of T f32 terms); each batch row's
    beams equal to the CPU's (scores within SEQ2SEQ_SCORE_TOL), or held by
    a near tie that the CPU's search met in that row (two of its k + 1
    best live candidates within SEQ2SEQ_LOGIT_TOL at some step)."""
    rescored = beam_scores_on(cpu, src, lengths, card["seqs"], bos, eos)
    own = float((rescored - card["scores"]).abs().max())
    # the two sums take their T terms in other orders: each of the T
    # additions rounds by up to one f32 ulp of the running sum
    steps = card["seqs"].shape[-1]
    own_tol = (SEQ2SEQ_SCORE_TOL + steps * 2.0 ** -23
               * float(card["scores"].abs().max()))
    check("seq2seq beam scores rescored on the CPU", own, own_tol)
    diff = (card["seqs"] != host["seqs"]).flatten(1).any(1)
    same = ~diff
    err = float((card["scores"][same] - host["scores"][same]).abs().max()) \
        if bool(same.any()) else 0.0
    check("seq2seq beam scores", err, SEQ2SEQ_SCORE_TOL)
    margins = host["margins"].rows
    untied = [int(r) for r in torch.nonzero(diff)[:, 0]
              if float(margins[r]) > SEQ2SEQ_LOGIT_TOL]
    if untied:
        raise AssertionError(f"seq2seq beam: rows {untied} differ from the "
                             "CPU's with no near tie there")
    return dict(rows_exact=int(same.sum()), rows_held=int(diff.sum()),
                rows_near_tie=int((margins <= SEQ2SEQ_LOGIT_TOL).sum()),
                score_max_abs_err=err, rescored_max_abs_err=own,
                rescored_tol=own_tol, score_tol=SEQ2SEQ_SCORE_TOL,
                tie_tol=SEQ2SEQ_LOGIT_TOL)


def crosscheck_phase(phase, config, make_model, loss_fn, args, batch, seq,
                     kernels, around=None, stats_tol=None, make_opt=None,
                     routes=None, **extra):
    """One f32 step on the card against the CPU plain path (see
    ``train_crosscheck``); emits the phase line, then raises if the loss
    or a gradient is outside its tolerance (or, for a model with buffers,
    a running statistic outside ``stats_tol``), or if one of ``kernels``
    did not launch on the card. With ``routes`` (a dict, which receives
    the card run's route counts) the line also gives K3's, and every K3
    launch must have taken its f32 route at D = 64, tf32x3. Returns the
    card run's launches."""
    loss_card, loss_cpu, errs, stat_errs, launches = train_crosscheck(
        make_model, loss_fn, args, around, make_opt, routes)
    if routes is not None:
        extra.update(flash_bwd_routes={k: routes[k] for k in K3_KERNELS})
    if around is not None:
        extra.update(around.summary())
    if stat_errs:
        stat_worst = max(stat_errs, key=stat_errs.get)
        extra.update(stats_rel_err_max=stat_errs[stat_worst],
                     stats_rel_err_worst=stat_worst, stats_tol=stats_tol,
                     stats=len(stat_errs))
    worst = max(errs, key=errs.get)
    emit(dict(phase=phase, config=config, batch=batch, seq=seq,
              dtype="float32", allow_tf32=False, **extra,
              loss_card=loss_card, loss_cpu=loss_cpu, loss_tol=TRAIN_LOSS_TOL,
              grad_rel_err_max=errs[worst], grad_rel_err_worst=worst,
              grad_tol=TRAIN_GRAD_TOL, params=len(errs),
              launches={k: launches[k] for k in kernels}))
    check(f"{phase} loss", abs(loss_card - loss_cpu), TRAIN_LOSS_TOL)
    check(f"{phase} gradient of {worst}", errs[worst], TRAIN_GRAD_TOL)
    if stat_errs:
        check(f"{phase} running statistic {stat_worst}",
              stat_errs[stat_worst], stats_tol)
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{phase}: kernels not launched {missing}")
    if routes is not None:
        check_routes(phase, routes, "tf32x3", K3_KERNELS)
    return launches


# ------------------------------------------ decode, int8, MoE and scan

DECODE_BATCH = 16        # bench.py:461's row: batch 16,
DECODE_PROMPT = 128      # prompt seq // 4 at seq 512,
DECODE_NEW = 128         # 128 new tokens a call
DECODE_CALLS = 3         # timed calls, chained as bench chains them
#: the kernels a generate call launches (the prefill's K1, K2, K4 and each
#: decode step's K1, K4; the cache's attention is a dense einsum) and
#: those it must not (K7 reads paged pools only)
DECODE_KERNELS = ("layer_norm", "flash_attention", "mlp")
#: the reference's bar for int8 logits: within 5 % of the float model's
#: largest (tests/test_quant.py:332)
INT8_LOGIT_TOL = 0.05
#: the MoE row: GShard's top-2 over 8 experts at the gating's own
#: capacity factor 1.25, the repo's own choice (no published MoE config)
MOE_EXPERTS, MOE_K = 8, 2
MOE_STEPS = 5
SCAN_STEPS = 5
SCAN_LOSS_TOL = 1e-6     # a scan model's losses against the unrolled
#                          model's: the same kernels in the same order


def decode_bytes(model, batch, total, cache_dtype):
    """bench.py's count of the bytes one decode step reads: every
    parameter once, and the whole padded K/V cache of every layer.
    ``(param bytes, cache bytes)``."""
    cfg = model.cfg
    cache = (cfg.num_layers * 2 * batch * total * cfg.hidden_size
             * torch.empty((), dtype=cache_dtype).element_size())
    return sum(nbytes(p) for p in model.parameters()), cache


@torch.inference_mode()
def decode_teacher_forced(model, prompt, tokens, cache_dtype):
    """The logits generate's path gives each of ``tokens`` ``[B, N]``
    after ``prompt`` ``[B, Tp]`` (on the model's device): the prefill,
    then one decode step a token, fed the given tokens. ``[B, N, V]`` f32
    on the CPU."""
    dev = model.device
    prompt, tokens = prompt.to(dev), tokens.to(dev)
    tp, n = prompt.shape[1], tokens.shape[1]
    logits, caches = model.prefill(prompt, tp + n, cache_dtype)
    out = [logits]
    for i in range(n - 1):
        logits, caches = model.decode_step(tokens[:, i:i + 1], caches,
                                           tp + i)
        out.append(logits)
    return torch.cat(out, 1).float().cpu()


def decode_crosscheck(card_model, cpu_model, prompt, tokens):
    """generate's tokens of the rows of ``prompt`` teacher-forced on the
    card (bf16 cache) and on the CPU plain path (f32 cache): the logits
    within SERVE_LOGIT_TOL, and every token the CPU's argmax or within
    SERVE_LOGIT_TOL of it (a near tie the bf16 cache may flip)."""
    card = decode_teacher_forced(card_model, prompt, tokens, torch.bfloat16)
    cpu = decode_teacher_forced(cpu_model, prompt.cpu(), tokens.cpu(),
                                torch.float32)
    rows = []
    for r in range(prompt.shape[0]):
        err = float((card[r] - cpu[r]).abs().max())
        toks = tokens[r].cpu().long()
        short = cpu[r].max(-1).values - cpu[r].gather(1, toks[:, None])[:, 0]
        check(f"gpt_decode crosscheck row {r}", err, SERVE_LOGIT_TOL)
        worst = float(short.max())
        if worst > SERVE_LOGIT_TOL:
            raise AssertionError(
                f"gpt_decode crosscheck row {r}: token {int(short.argmax())}"
                f" is {worst} below the CPU's argmax (tol "
                f"{SERVE_LOGIT_TOL})")
        rows.append(dict(row=r, logits_max_abs_err=err, tol=SERVE_LOGIT_TOL,
                         tokens=int(toks.numel()),
                         near_ties=int((short > 0).sum())))
    return rows


def check_absent(what, launches, kernels):
    ran = {k: launches[k] for k in kernels if launches[k]}
    if ran:
        raise AssertionError(f"{what}: launched {ran}")


def decode_run(model, what, prompt, smi, kernels, absent):
    """bench.py's gpt_decode row on ``model``: a warm-up generate call
    (whose tokens it returns), one call with the launch counts zeroed
    just before and read just after (each of ``kernels`` launched, none
    of ``absent``), DECODE_CALLS timed calls chained as bench chains them
    (the next prompt is the last output's tail; each ends in a host read),
    a profiled call (device ms, launches, idle share against the p50
    call), and one decode step after the prefill (its launches, its
    device ms and its bound: the parameters and the padded cache over
    PEAK_BYTES). ``(line, launches of the call, tokens)``."""
    cache = torch.bfloat16
    total = DECODE_PROMPT + DECODE_NEW

    def gen(p):
        return model.generate(p, DECODE_NEW, cache_dtype=cache)
    out = gen(prompt)
    torch.cuda.synchronize()
    launches, routes = launched(lambda: gen(prompt))
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{what}: kernels not launched {missing}")
    check_absent(what, launches, absent)
    check_path_routes(what, routes, ("layer_norm",))
    check_serve_routes(what, routes, [k for k in SERVE_ROUTED
                                      if k in kernels])
    times, p = [], prompt
    for _ in range(DECODE_CALLS):
        t0 = time.perf_counter()
        nxt = gen(p)
        int(nxt[0, -1])
        times.append(time.perf_counter() - t0)
        p = nxt[:, -DECODE_PROMPT:]
    call_ms, call_launches, _ = kernel_profile(lambda: gen(prompt))
    p50 = float(np.median(times)) * 1e3
    with torch.inference_mode():
        logits, caches = model.prefill(prompt, total, cache)
        tok = torch.argmax(logits[:, 0], -1).to(prompt.dtype)[:, None]

        def step():
            model.decode_step(tok, caches, DECODE_PROMPT)
        step_launches, _ = launched(step)
        step_ms, step_kernels, by_name = kernel_profile(step)
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    params, cache_bytes = decode_bytes(model, DECODE_BATCH, total, cache)
    mean_s = float(np.mean(times))
    line = dict(
        config="GPTConfig.small()", batch=DECODE_BATCH,
        prompt_len=DECODE_PROMPT, max_new=DECODE_NEW, cache_dtype="bfloat16",
        calls=DECODE_CALLS,
        decoded_tokens_per_s=DECODE_BATCH * DECODE_NEW / mean_s,
        p50_call_ms=p50, call_ms=[t * 1e3 for t in times],
        call_device_ms=call_ms, call_kernel_launches=call_launches,
        idle_share=1.0 - call_ms / p50,
        launches_per_call=launches,
        step_device_ms=step_ms, step_kernel_launches=step_kernels,
        step_wall_p50_ms=float(np.median(walls)) * 1e3,
        step_launches={k: n for k, n in step_launches.items() if n},
        step_top_kernels={k[:60]: v for k, v in by_name.most_common(6)},
        param_bytes=params, cache_bytes=cache_bytes,
        step_bound_ms=(params + cache_bytes) / PEAK_BYTES * 1e3,
        bandwidth_share=(DECODE_NEW * (params + cache_bytes) / mean_s
                         / PEAK_BYTES),
        card=smi)
    return line, launches, out


def decode_prompt(vocab):
    return torch.from_numpy(np.random.RandomState(0).randint(
        0, vocab, (DECODE_BATCH, DECODE_PROMPT)).astype(np.int32)).cuda()


def gpt_decode_phase(model, cpu_model, smi):
    """``gpt_decode``: bench.py:461's row through ``generate`` (f32
    weights, bf16 cache), then two rows teacher-forced against the CPU.
    ``(line, launches, prompt, tokens, float logits of the prompt)``."""
    prompt = decode_prompt(model.cfg.vocab_size)
    line, launches, out = decode_run(model, "gpt_decode", prompt, smi,
                                     DECODE_KERNELS, ("decode_attention",))
    line["crosscheck"] = decode_crosscheck(
        model, cpu_model, prompt[:2], out[:2, DECODE_PROMPT:])
    with torch.inference_mode():
        logits = model(prompt)
    return line, launches, prompt, out, logits


def gpt_decode_int8_phase(model, prompt, float_out, float_logits, smi):
    """``gpt_decode_int8``: the same row after quantize_weights_int8 (in
    place): 2L + 4L + 2 int8 leaves, the full forward's logits within
    INT8_LOGIT_TOL of the float model's largest, no K4 launch (the
    reference's rule: an int8 layer takes the unfused FFN), greedy
    agreement with the float run."""
    from paddle_tpu_torch.quant import quantize_weights_int8
    layers = model.cfg.num_layers
    quantize_weights_int8(model)
    q8 = [p for p in model.parameters() if p.dtype == torch.int8]
    if len(q8) != 2 * layers + 4 * layers + 2:
        raise AssertionError(f"gpt_decode_int8: {len(q8)} int8 leaves, "
                             f"want {6 * layers + 2}")
    with torch.inference_mode():
        logits = model(prompt)
    gap = float((logits - float_logits).abs().max()
                / float_logits.abs().max())
    check("gpt_decode_int8 logits relative gap", gap, INT8_LOGIT_TOL)
    line, launches, out = decode_run(
        model, "gpt_decode_int8", prompt, smi, ("layer_norm",
                                                "flash_attention"),
        ("mlp", "decode_attention"))
    same = out[:, DECODE_PROMPT:] == float_out[:, DECODE_PROMPT:]
    first = [int(r.logical_not().nonzero()[0]) if not bool(r.all())
             else DECODE_NEW for r in same]
    line.update(int8_leaves=len(q8), int8_bytes=nbytes(*q8),
                logits_rel_gap=gap, logits_tol=INT8_LOGIT_TOL,
                greedy_agreement=float(same.float().mean()),
                rows_equal=int(same.all(1).sum()),
                first_parting_step=first)
    return line, launches


def serve_int8_phase(model, serve_kw, smi):
    """``serve_int8``: the serve wave through ServingEngine over the int8
    weights (K1, K2, K7; no K4), each greedy request against generate on
    its prompt alone: token-exact, or parting where generate's own
    logits of the two tokens are a near tie (within SERVE_LOGIT_TOL: the
    engine's K7 over the bf16 pool and generate's dense einsum sum in
    other orders)."""
    from paddle_tpu_torch.ops.cuda import core
    core.reset_launches()
    eng, rids, stats = serve(model, 16, (64, 512), 700, 64, serve_kw, seed=0)
    torch.cuda.synchronize()
    launches, routes = core.launch_counts(), core.route_counts()
    missing = [k for k in ("layer_norm", "flash_attention",
                           "decode_attention") if launches[k] == 0]
    if missing:
        raise AssertionError(f"serve_int8: kernels not launched {missing}")
    check_absent("serve_int8", launches, ("mlp",))
    check_path_routes("serve_int8", routes, ("layer_norm",
                                             "decode_attention"))
    exact, parted = 0, []
    for rid in rids:
        req = eng.requests[rid]
        prompt = torch.from_numpy(req.prompt.astype(np.int32))[None].to(
            model.device)
        want = model.generate(prompt, len(req.tokens),
                              cache_dtype=torch.bfloat16)[0, prompt.shape[1]:]
        got = torch.tensor(req.tokens, dtype=want.dtype, device=want.device)
        if torch.equal(got, want):
            exact += 1
            continue
        part = int((got != want).nonzero()[0])
        logits = decode_teacher_forced(model, prompt, got[None],
                                       torch.bfloat16)[0, part]
        gap = float(logits[int(want[part])] - logits[int(got[part])])
        parted.append(dict(request=rid, parts_at=part, gap_there=gap))
        if gap > SERVE_LOGIT_TOL:
            raise AssertionError(f"serve_int8 request {rid}: parts from "
                                 f"generate at token {part}, gap {gap} "
                                 f"(tol {SERVE_LOGIT_TOL})")
    line = dict(config="GPTConfig.small()", weights="int8",
                **{k: v for k, v in serve_kw.items() if k != "cache_dtype"},
                cache_dtype="bfloat16", launches=launches,
                token_exact_vs_generate=exact, parted_at_near_tie=parted,
                **{k: v for k, v in stats.items() if k != "prompt_lens"},
                card=smi)
    return line, launches


# ------------------------------------------------------------ serve_fleet

# bench.py's gpt_serve_fleet row (bench.py:717) at seq 512: 4 slots a
# replica, page 64, a 64-token shared prefix on half the prompts,
# prefill_len = seq // 2, prompts of [seq // 8, prefill_len] tokens after
# the prefix, 64 new tokens each, bf16 pools, SLOs of 2 s to the first
# token and 0.5 s a token; replica counts 1, 2 and 4, 4n warm-up
# requests each and FLEET_TIMED n timed (bench's row times 16n: cut to
# 8n to keep the script's time)
FLEET_SLOTS = 4
FLEET_PAGE = 64
FLEET_SHARED = 64
FLEET_PREFILL = 256
FLEET_MIN_PROMPT = 64
FLEET_NEW = 64
FLEET_COUNTS = (1, 2, 4)
FLEET_KILL_AT = 4        # the replica count whose run kills a replica
FLEET_DEPLOY_AT = 2      # the replica count whose warm-up deploys v1
FLEET_PROFILE_ROUNDS = 8
FLEET_DISAGG = 12        # requests of the disaggregated run (half long)
FLEET_WARM = 4           # warm-up requests a replica
FLEET_TIMED = 8          # timed requests a replica


def fleet_serve_kw(max_len=None):
    return dict(num_slots=FLEET_SLOTS, page_size=FLEET_PAGE,
                max_len=max_len or FLEET_SHARED + FLEET_PREFILL + FLEET_NEW,
                prefill_len=FLEET_PREFILL, cache_dtype=torch.bfloat16,
                slo_ttft_s=2.0, slo_token_latency_s=0.5)


def fleet_stream(vocab, n):
    """bench.py:921-937's prompts: ``np.random.RandomState(0)`` draws the
    shared prefix, then each prompt's length, tokens and whether it opens
    with the prefix. Every replica count draws from a fresh stream, so a
    shorter run's prompts are the longer run's first ones."""
    rng = np.random.RandomState(0)
    shared = rng.randint(0, vocab, (FLEET_SHARED,), dtype=np.int32)
    out = []
    for _ in range(n):
        plen = int(rng.randint(FLEET_MIN_PROMPT, FLEET_PREFILL + 1))
        ids = rng.randint(0, vocab, (plen,), dtype=np.int32)
        if rng.random_sample() < 0.5:
            ids = np.concatenate([shared, ids])
        out.append(ids)
    return out


def disagg_stream(vocab, n):
    """bench.py's disaggregation stream: odd requests longer than
    prefill_len (a two-chunk admission), even ones of [seq // 8,
    prefill_len]."""
    rng = np.random.RandomState(0)
    out = []
    for j in range(n):
        lo, hi = ((FLEET_PREFILL + 1, 2 * FLEET_PREFILL) if j % 2
                  else (FLEET_MIN_PROMPT, FLEET_PREFILL + 1))
        out.append(rng.randint(0, vocab, (int(rng.randint(lo, hi)),),
                               dtype=np.int32))
    return out


def alone_tokens(model, prompts, serve_kw):
    """Each prompt's greedy tokens from one ServingEngine under the same
    ServeConfig serving the prompts in order."""
    from paddle_tpu_torch.serving import ServeConfig, ServingEngine
    eng = ServingEngine(model, ServeConfig(**serve_kw))
    rids = [eng.submit(p, max_new=FLEET_NEW) for p in prompts]
    eng.drain()
    if any(eng.requests[r].status != "done" for r in rids):
        raise AssertionError("serve_fleet: the single engine left requests")
    return [eng.requests[r].tokens for r in rids]


def settle(router):
    """Step the router (never drain, which would refuse the next
    submissions) until every request is terminal; returns each round's
    wall seconds."""
    from paddle_tpu_torch.serving.fleet import _TERMINAL
    times = []
    while any(r.status not in _TERMINAL for r in router.requests.values()):
        s0 = time.perf_counter()
        router.step()
        times.append(time.perf_counter() - s0)
    return times


def fleet_held(what, model, cpu_model, requests, reference, serve_kw):
    """Every request of a router's ``requests`` is done and equals
    ``reference`` (fid -> the single engine's tokens) token for token, or
    parts from it at a near tie of the CPU's logits (crosscheck's
    reference rule: a failover or handoff replays prompt + tokens through
    a prefill chunk where the single engine ran decode steps). Returns
    (exact, crosscheck rows)."""
    recs = sorted(requests.values(), key=lambda r: r.id)
    bad = [r.id for r in recs if r.status != "done"]
    if bad:
        raise AssertionError(f"{what}: requests not done {bad}")
    diff = [types.SimpleNamespace(id=r.id, prompt=r.prompt,
                                  tokens=list(r.tokens), temperature=0)
            for r in recs if list(r.tokens) != list(reference[r.id])]
    rows = crosscheck(model, cpu_model, diff, serve_kw["page_size"],
                      serve_kw["prefill_len"], reference=reference)
    return len(recs) - len(diff), rows


def prefix_stats(router):
    hits = miss = skipped = 0
    for h in router._replicas:
        eng = h.engine
        hits += eng.prefix_hits
        miss += eng.prefix_misses
        skipped += eng.prefill_tokens_skipped
    return hits, miss, skipped


def fleet_round_profile(router, rounds):
    """``rounds`` router rounds under torch.profiler: the wall ms and
    device ms of a round (the CUDA kernels' durations summed: one stream,
    no overlap), the device's idle share and each port kernel's launches
    a round (its wrapper's counter)."""
    from paddle_tpu_torch.ops.cuda import core
    before = core.launch_counts()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            router.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_ms = 0.0
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            busy_ms += e.time_range.elapsed_us() / 1e3
    after = core.launch_counts()
    return dict(rounds=rounds, round_ms=wall / rounds * 1e3,
                device_ms_per_round=busy_ms / rounds,
                idle_share=1 - busy_ms / 1e3 / wall,
                launches_per_round={k: (after[k] - before[k]) / rounds
                                    for k in after if after[k] > before[k]})


def fleet_run(model, n, stream, serve_kw, kill=False, deploy=False):
    """bench.py's run at ``n`` replicas: a warm-up of FLEET_WARM n requests
    settled, then FLEET_TIMED n timed; with ``kill``, three healthy rounds, the busiest
    replica killed and the failover round timed. FLEET_PROFILE_ROUNDS
    decode rounds of the warm-up (every slot live, after the admission
    round) run under :func:`fleet_round_profile`, outside the timed
    window, whose wall the profiler would stretch. With ``deploy``, a
    rolling deploy of the same weights as v1 follows them, the warm-up's
    requests in flight, and the timed requests must all be served by v1.
    Returns the router and the run's line."""
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.serving import (FleetConfig, FleetRouter,
                                          ServeConfig)
    from paddle_tpu_torch.serving.fleet import _TERMINAL
    router = FleetRouter(model, FleetConfig(num_replicas=n,
                                            heartbeat_s=60.0),
                         serve_config=ServeConfig(**serve_kw))
    warm, timed_n = FLEET_WARM * n, FLEET_TIMED * n
    for p in stream[:warm]:
        router.submit(p, max_new=FLEET_NEW)
    router.step()                         # the warm-up's admissions
    line = dict(replicas=n, requests=timed_n,
                profile=fleet_round_profile(router, FLEET_PROFILE_ROUNDS))
    if deploy:
        s0 = time.perf_counter()
        router.deploy({"params": dict(model.named_parameters())},
                      version="v1")
        line["deploy_s"] = time.perf_counter() - s0
    settle(router)
    hits0, miss0, skip0 = prefix_stats(router)
    aff0 = metrics.counter("fleet.affinity_hits").total()
    for p in stream[warm:warm + timed_n]:
        router.submit(p, max_new=FLEET_NEW)
    rounds, healthy = 0, []
    t0 = time.perf_counter()
    if kill:
        for _ in range(3):
            s0 = time.perf_counter()
            router.step()
            healthy.append(time.perf_counter() - s0)
        victim = max(range(n), key=lambda i: router._replicas[i].load())
        router.kill_replica(victim)
        s0 = time.perf_counter()
        router.step()
        line.update(killed=victim,
                    failover_round_ms=(time.perf_counter() - s0) * 1e3,
                    mean_healthy_round_ms=float(np.mean(healthy)) * 1e3)
        rounds += 4
    times = settle(router)
    rounds += len(times)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timed = [r for r in router.requests.values() if r.id >= warm]
    if any(r.status not in _TERMINAL for r in timed):
        raise AssertionError(f"serve_fleet n={n}: requests left")
    hits1, miss1, skip1 = prefix_stats(router)
    tel = router.telemetry()
    if deploy:
        if tel["versions"] != ["v1"] * n or any(r.version != "v1"
                                                 for r in timed):
            raise AssertionError(f"serve_fleet deploy: {tel['versions']}")
        line.update(ops=[e["event"] for e in tel["ops_log"]],
                    version_stats=tel["version_stats"])
    line.update(
        completed=sum(r.status == "done" for r in timed),
        tokens_per_s=sum(len(r.tokens) for r in timed
                         if r.status == "done") / wall,
        wall_s=wall, rounds=rounds,
        p50_round_ms=float(np.median(times)) * 1e3,
        goodput=router.goodput(),
        prefix_hit_rate=(hits1 - hits0) / max(hits1 - hits0
                                               + miss1 - miss0, 1),
        prefill_tokens_skipped=skip1 - skip0,
        affinity_hits=metrics.counter("fleet.affinity_hits").total()
        - aff0,
        failovers=router.failovers, rerouted=tel["rerouted"],
        states=tel["states"],
        kv_pool_bytes=sum(h.engine.kv_pool_bytes()
                          for h in router._replicas))
    return router, line


def serve_fleet_phase(model, cpu_model, smi):
    """``serve_fleet``: bench.py's gpt_serve_fleet row through the port's
    FleetRouter on one card, every replica a ServingEngine over the one
    GPTConfig.small() module. Replica counts FLEET_COUNTS (the busiest
    replica killed mid-stream at FLEET_KILL_AT, a rolling deploy of the
    same weights as v1 in the warm-up at FLEET_DEPLOY_AT), after a
    disaggregated run (prefill_replicas=1) at 2 replicas with half the
    prompts longer than prefill_len. The launch counts are zeroed after
    the single engine's reference runs and read as the largest count's
    router closes, before the untraced window and before any check
    launches a kernel of its own: they count these fleet runs alone.
    Every request must be done and equal one ServingEngine under the
    same ServeConfig token for token (or part
    from it at a near tie: :func:`fleet_held`); failovers and handoffs
    >= 1; K1, K2, K4 and K7 launched, on serve's routes. Then
    bench.py:1004-1039's untraced window, in ABA order: the largest
    count's run (traced), the same run with ``trace_fleet`` off and the
    flight ring at 0 (no trace id minted), and once more traced, all
    held by the same bar. The line gives the untraced run's tokens/s,
    ``trace_overhead`` (the untraced run's tokens/s over the traced
    runs' mean) and its ratios to the traced run before and after it.
    Returns (the phase line, launches, the single engine's tokens of
    each prompt of the stream)."""
    from paddle_tpu_torch.observability import flight
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.serving import FleetConfig, FleetRouter
    from paddle_tpu_torch.serving import ServeConfig, fleet
    vocab = model.cfg.vocab_size
    kw = fleet_serve_kw()
    stream = fleet_stream(vocab, (FLEET_WARM + FLEET_TIMED)
                          * max(FLEET_COUNTS))
    dkw = fleet_serve_kw(max_len=2 * FLEET_PREFILL + FLEET_NEW)
    dstream = disagg_stream(vocab, FLEET_DISAGG)
    t0 = time.perf_counter()
    reference = alone_tokens(model, stream, kw)
    alone_s = time.perf_counter() - t0
    dref = alone_tokens(model, dstream, dkw)
    torch.cuda.synchronize()
    core.reset_launches()
    runs, served = [], []

    # prefill/decode disaggregation, first: the largest count's traced run
    # then leads the untraced window at once
    router = FleetRouter(model, FleetConfig(num_replicas=2,
                                            heartbeat_s=60.0,
                                            prefill_replicas=1),
                         serve_config=ServeConfig(**dkw))
    s0 = time.perf_counter()
    for p in dstream:
        router.submit(p, max_new=FLEET_NEW)
    settle(router)
    dwall = time.perf_counter() - s0
    tel = router.telemetry()
    disagg_line = dict(replicas=2, roles=tel["roles"], requests=len(dstream),
                       handoffs=tel["handoffs"], wall_s=dwall,
                       tokens_per_s=sum(len(r.tokens) for r in
                                        router.requests.values()) / dwall,
                       goodput=router.goodput())
    served.append(("serve_fleet disagg", router.requests, dref, dkw,
                   disagg_line))
    router.close()

    for n in FLEET_COUNTS:
        router, line = fleet_run(model, n, stream, kw,
                                 kill=n == FLEET_KILL_AT,
                                 deploy=n == FLEET_DEPLOY_AT)
        runs.append(line)
        served.append((f"serve_fleet n={n}", router.requests, reference,
                       kw, line))
        router.close()
    torch.cuda.synchronize()
    launches, routes = core.launch_counts(), core.route_counts()

    # bench.py:1004-1039's untraced window, run ABA at the largest count:
    # the traced run above, one with trace_fleet off and the flight ring
    # at 0, one traced again
    nmax = max(FLEET_COUNTS)
    window = [runs[-1]]
    was_trace = fleet.configure()["trace_fleet"]
    was_ring = flight.configure()["ring"]
    for traced in (False, True):
        if not traced:
            fleet.configure(trace_fleet=False)
            flight.configure(ring=0)
        try:
            router, line = fleet_run(model, nmax, stream, kw,
                                     kill=nmax == FLEET_KILL_AT)
        finally:
            fleet.configure(trace_fleet=was_trace)
            flight.configure(ring=was_ring)
        if not traced and any(r.trace_id is not None
                              for r in router.requests.values()):
            raise AssertionError("serve_fleet untraced: a trace id was "
                                 "minted")
        served.append((f"serve_fleet window {len(window)}", router.requests,
                       reference, kw, line))
        window.append(line)
        router.close()
    torch.cuda.synchronize()

    for what, requests, ref, serve_kw, line in served:
        exact, rows = fleet_held(what, model, cpu_model, requests, ref,
                                 serve_kw)
        line.update(token_exact=exact, crosscheck=rows)
    if not any(r["failovers"] for r in runs):
        raise AssertionError("serve_fleet: no failover happened")
    long = sum(p.size > FLEET_PREFILL for p in dstream)
    if tel["handoffs"] != long:
        raise AssertionError(f"serve_fleet disagg: {tel['handoffs']} "
                             f"handoffs, {long} long prompts")
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"serve_fleet: kernels not launched {missing}")
    check_serve_routes("serve_fleet", routes)
    check_path_routes("serve_fleet", routes, ("layer_norm",
                                              "decode_attention"))
    t1, u, t2 = (r["tokens_per_s"] for r in window)
    line = dict(
        phase="serve_fleet", config="GPTConfig.small()",
        **{k: v for k, v in kw.items() if k != "cache_dtype"},
        cache_dtype="bfloat16", shared_prefix=FLEET_SHARED, max_new=FLEET_NEW,
        card=smi, single_engine_s=alone_s, runs=runs, disagg=disagg_line,
        untraced=window[1], retraced=window[2],
        trace_window_tokens_per_s=[t1, u, t2],
        untraced_tokens_per_s=u,
        trace_overhead=2 * u / (t1 + t2),
        trace_overhead_pairs=[u / t1, u / t2],
        launches=launches,
        routes={k: routes[k] for k in SERVE_ROUTED + tuple(PATH_ROUTE)})
    return line, launches, reference


FLEET_PROC_N = 2          # child replicas
FLEET_PROC_WARM = 8       # warm-up requests (4n), settled before timing
FLEET_PROC_TIMED = 16     # the kill drill's timed requests
FLEET_PROC_KILL_AFTER = 3  # healthy timed rounds before the kill -9
FLEET_PROC_ASSERT = 8     # the device-assert drill's requests
FLEET_PROC_ASSERT_AT = 12  # the asserting child's engine step
FLEET_PROC_TIMEOUT_S = 120.0  # a handle's exchange timeout: it covers a
#                               child's start-up (interpreter, torch, CUDA
#                               context, weights, kernel library)
FLEET_PROC_DETECT_S = 3.0  # the asserting handle's timeout in its drill
FLEET_PROC_IDLE_S = 300.0  # a worker's wait for the router's next command:
#                             the assert drill's children idle through the
#                             kill drill (under 2 minutes)
#: the variable that arms a worker's device-side assert:
#: "<generation>:<engine step>"
ASSERT_ENV = "PT_SMOKE_ASSERT_AT"


def fleet_worker(spec_path):
    """``python3 chip_smoke.py --fleet-worker SPEC``: the child process of
    :func:`serve_fleet_proc_phase` (a fresh interpreter per replica and
    generation). It loads the parent's GPTConfig.small() weights from the
    ``torch.save`` file the spec names (the module is first drawn from
    another seed, so only the file can make its tokens the parent's),
    builds a ServingEngine on the card with a RunLog of its own, writes a
    ready file (start-up split, whether the kernel library was already
    built) and serves through ``replica_worker_loop`` until the router's
    ``stop``; then it writes its kernels' launch and route counts and its
    engine steps' times. With :data:`ASSERT_ENV` naming its generation,
    its engine's step of that number first indexes a card tensor out of
    range: a device-side assert, which loses this process's CUDA context
    and ends it. A worker whose parent dies exits within a second. Its
    stdout goes to stderr: the parent's stdout carries the script's
    result."""
    import threading
    import traceback
    os.dup2(2, 1)
    t_main = time.time()
    parent = os.getppid()

    def orphaned():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(4)

    threading.Thread(target=orphaned, daemon=True).start()
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTDecoder
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.serving import (ServeConfig, ServingEngine,
                                          replica_worker_loop)
    with open(spec_path) as f:
        spec = json.load(f)
    tag = (f"{spec['run']}.r{os.environ['PT_FLEET_REPLICA']}"
           f".g{os.environ['PT_FLEET_GENERATION']}")
    gen = int(os.environ["PT_FLEET_GENERATION"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prebuilt = os.path.exists(os.path.join(core.build_dir(), core.LIB_NAME))
    core.library()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t_cuda = time.time()
    cfg = GPTConfig.small()
    cfg.dropout = 0.0
    model = GPTDecoder(cfg, device="cuda", seed=1)
    model.load_state_dict(torch.load(spec["state"], map_location="cuda",
                                     weights_only=True))
    torch.cuda.synchronize()
    t_weights = time.time()
    kw = dict(spec["serve"], cache_dtype=getattr(torch, spec["cache_dtype"]))
    eng = ServingEngine(model, ServeConfig(
        run_log=os.path.join(spec["out"], f"serve.{tag}.jsonl"), **kw))
    step_s = []
    real_step = eng.step
    armed = os.environ.get(ASSERT_ENV)
    fire_at = (int(armed.split(":")[1])
               if armed and int(armed.split(":")[0]) == gen else None)

    def step():
        if len(step_s) + 1 == fire_at:
            with open(os.path.join(spec["out"], f"fired.{tag}.json"),
                      "w") as f:
                json.dump(dict(wall=time.time()), f)
            bad = torch.tensor([1 << 20], device="cuda")
            torch.zeros(8, device="cuda")[bad]
            torch.cuda.synchronize()
        s0 = time.perf_counter()
        real_step()
        step_s.append(time.perf_counter() - s0)

    eng.step = step
    core.reset_launches()
    with open(os.path.join(spec["out"], f"ready.{tag}.json"), "w") as f:
        json.dump(dict(ready=time.time(), main=t_main, cuda=t_cuda,
                       weights=t_weights, prebuilt=prebuilt), f)
    try:
        replica_worker_loop(eng, timeout_s=spec["idle_s"])
        torch.cuda.synchronize()
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(3)              # no teardown of a context that is lost
    eng.close()
    with open(os.path.join(spec["out"], f"done.{tag}.json"), "w") as f:
        json.dump(dict(launches=core.launch_counts(),
                       routes=core.route_counts(), steps=len(step_s),
                       p50_step_ms=float(np.median(step_s)) * 1e3
                       if step_s else None,
                       staged_prefills=eng.staged_prefills,
                       prefill_calls=eng.prefill_calls), f)
    return 0


def proc_handles(argv, xdir, spawned, env=None):
    """FLEET_PROC_N SubprocessReplica handles, each starting ``argv``
    at once (``env``: replica -> its extra environment); ``spawned`` gets
    each (replica, generation)'s start wall time."""
    from paddle_tpu_torch.serving import SubprocessReplica

    class Timed(SubprocessReplica):
        def respawn(self):
            spawned[(self.replica, self.generation + 1)] = time.time()
            super().respawn()

    return [Timed(argv, xdir, replica=i, env=(env or {}).get(i),
                  timeout_s=FLEET_PROC_TIMEOUT_S)
            for i in range(FLEET_PROC_N)]


def proc_router(handles, kw):
    from paddle_tpu_torch.serving import (FleetConfig, FleetRouter,
                                          ServeConfig)
    return FleetRouter(config=FleetConfig(num_replicas=len(handles),
                                          heartbeat_s=60.0),
                       serve_config=ServeConfig(**kw), replicas=handles)


def timed_rounds(router, after=None):
    """:func:`settle` that also returns the round in which the router
    failed a replica over (its index, end wall time and ms); ``after`` is
    called after every round."""
    from paddle_tpu_torch.serving.fleet import _TERMINAL
    times, failover = [], None
    while any(r.status not in _TERMINAL for r in router.requests.values()):
        before = router.failovers
        s0 = time.perf_counter()
        router.step()
        times.append(time.perf_counter() - s0)
        if router.failovers > before and failover is None:
            failover = dict(round=len(times) - 1, wall=time.time(),
                            ms=times[-1] * 1e3)
        if after is not None:
            after()
    return times, failover


def read_json(root, prefix):
    """{tag: the JSON of each ``<prefix>.<tag>.json`` under ``root``}."""
    out = {}
    for path in sorted(glob.glob(os.path.join(root, f"{prefix}.*.json"))):
        with open(path) as f:
            out[os.path.basename(path)[len(prefix) + 1:-5]] = json.load(f)
    return out


def serve_fleet_proc_phase(model, cpu_model, smi, reference, inproc_p50_ms):
    """``serve_fleet_proc``: serve_fleet's GPTConfig.small() traffic
    (fleet_serve_kw, fleet_stream) through a FleetRouter over
    FLEET_PROC_N SubprocessReplica children on the card, each a fresh
    interpreter running :func:`fleet_worker` on the module's weights,
    written once with ``torch.save``.

    Kill drill: FLEET_PROC_WARM warm-up requests settled (the children's
    start-up inside), then FLEET_PROC_TIMED timed ones; after
    FLEET_PROC_KILL_AFTER rounds the busier child is killed -9. The
    children's RunLogs are merged (``trace.merge_fleet_trace``): every
    re-routed request keeps its trace id across the killed child's log and
    another process's. Device-assert drill: two more children, started
    with the first two and idle until then, the second armed to assert
    on the card at its engine step FLEET_PROC_ASSERT_AT, with
    FLEET_PROC_DETECT_S as its handle's timeout meanwhile: that child
    dies mid-round, the router waits out the timeout, fails its requests
    over and respawns it; the other child stays at generation 0 and the
    parent's own context still computes. Every request of both drills
    must be done and equal serve_fleet's single engine token for token
    (or part from it at a near tie: :func:`fleet_held`); each killed
    handle's generation >= 1; every child loads the kernel library the
    build phase made. The launch counts are the children's, summed from
    the children that stopped cleanly: K1, K2, K4 and K7 above 0, on
    serve's routes. Returns (the phase line, launches)."""
    import shutil
    import tempfile
    from paddle_tpu_torch.observability import trace
    from paddle_tpu_torch.observability.runlog import read_records
    from paddle_tpu_torch.ops.cuda import core
    kw = fleet_serve_kw()
    stream = fleet_stream(model.cfg.vocab_size, FLEET_PROC_WARM
                          + FLEET_PROC_TIMED + FLEET_PROC_ASSERT)
    root = tempfile.mkdtemp(prefix="serve_fleet_proc")
    spawned = {"kill": {}, "assert": {}}
    children = []
    try:
        state = os.path.join(root, "gpt_small.pt")
        s0 = time.perf_counter()
        torch.save(model.state_dict(), state)
        save_s = time.perf_counter() - s0
        argv = {}
        for run in ("kill", "assert"):
            spec = os.path.join(root, f"{run}.json")
            with open(spec, "w") as f:
                json.dump(dict(run=run, state=state, out=root,
                               idle_s=FLEET_PROC_IDLE_S,
                               cache_dtype="bfloat16",
                               serve={k: v for k, v in kw.items()
                                      if k != "cache_dtype"}), f)
            argv[run] = [sys.executable, os.path.abspath(__file__),
                         "--fleet-worker", spec]

        # all four children start together (the assert drill's wait for
        # their router in their first exchange)
        armed = FLEET_PROC_N - 1
        handles = proc_handles(argv["kill"], os.path.join(root, "xk"),
                               spawned["kill"])
        armed_handles = proc_handles(
            argv["assert"], os.path.join(root, "xa"), spawned["assert"],
            env={armed: {ASSERT_ENV: f"0:{FLEET_PROC_ASSERT_AT}"}})
        children += handles + armed_handles

        # kill drill
        router = proc_router(handles, kw)
        warm = FLEET_PROC_WARM
        s0 = time.perf_counter()
        for p in stream[:warm]:
            router.submit(p, max_new=FLEET_NEW)
        settle(router)
        warm_s = time.perf_counter() - s0
        for p in stream[warm:warm + FLEET_PROC_TIMED]:
            router.submit(p, max_new=FLEET_NEW)
        healthy = []
        t0 = time.perf_counter()
        for _ in range(FLEET_PROC_KILL_AFTER):
            s0 = time.perf_counter()
            router.step()
            healthy.append(time.perf_counter() - s0)
        victim = max(range(FLEET_PROC_N), key=lambda i: handles[i].load())
        killed_at = time.time()
        handles[victim].kill()
        times, failover = timed_rounds(router)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if failover is None or failover["round"] != 0:
            raise AssertionError(f"serve_fleet_proc: the kill was not "
                                 f"caught in the next round: {failover}")
        timed = [r for r in router.requests.values() if r.id >= warm]
        tokens = sum(len(r.tokens) for r in timed if r.status == "done")
        kill_line = dict(
            requests=len(timed), killed=victim,
            generations=[h.generation for h in handles],
            failovers=router.failovers,
            rerouted=sum(r.reroutes for r in router.requests.values()),
            tokens_per_s=tokens / wall,
            # less the failover round and the respawned child's first
            # (its start-up)
            tokens_per_s_healthy=tokens / (wall - sum(times[:2])),
            wall_s=wall, warmup_s=warm_s,
            rounds=len(healthy) + len(times),
            p50_round_ms=float(np.median(healthy + times)) * 1e3,
            inproc_p50_round_ms=inproc_p50_ms,
            failover_round_ms=failover["ms"],
            kill_detect_s=failover["wall"] - killed_at,
            respawn_round_ms=times[1] * 1e3 if len(times) > 1 else None,
            goodput=router.goodput())
        crossed = [r for r in router.requests.values() if r.reroutes]
        kill_requests = router.requests
        router.close()
        if handles[victim].generation < 1 or not crossed:
            raise AssertionError(f"serve_fleet_proc: generations "
                                 f"{kill_line['generations']}, "
                                 f"{len(crossed)} re-routed")

        # one timeline across the processes
        logs = {os.path.basename(p)[6:-6]: read_records(p) for p in
                sorted(glob.glob(os.path.join(root, "serve.kill.*.jsonl")))}
        merged = trace.merge_fleet_trace(logs)
        groups = trace.group_by_trace(merged["events"])
        dead_src = f"kill.r{victim}.g0"
        spans = []
        for r in crossed:
            srcs = {e["source"] for e in groups.get(r.trace_id, [])}
            if dead_src not in srcs or len(srcs) < 2:
                raise AssertionError(f"serve_fleet_proc: trace {r.trace_id}"
                                     f" spans {sorted(srcs)}")
            spans.append(len(srcs))
        if not all(s["anchored"] for s in merged["skew"].values()):
            raise AssertionError(f"serve_fleet_proc: {merged['skew']}")
        kill_line.update(merged_events=len(merged["events"]),
                         merged_sources=sorted(logs),
                         crossed_traces=len(spans),
                         max_skew_s=max(abs(s["skew_s"]) for s in
                                        merged["skew"].values()))

        # device-assert drill
        handles = armed_handles
        router = proc_router(handles, kw)
        lo = warm + FLEET_PROC_TIMED
        for p in stream[lo:]:
            router.submit(p, max_new=FLEET_NEW)
        router.step()                     # waits out any start-up left
        handles[armed].timeout_s = FLEET_PROC_DETECT_S

        def restore():
            if handles[armed].generation > 0:
                handles[armed].timeout_s = FLEET_PROC_TIMEOUT_S

        t0 = time.perf_counter()
        times, failover = timed_rounds(router, after=restore)
        wall = time.perf_counter() - t0
        fired = read_json(root, "fired")
        if failover is None or list(fired) != [f"assert.r{armed}.g0"]:
            raise AssertionError(f"serve_fleet_proc: assert {fired}, "
                                 f"failover {failover}")
        alive = torch.arange(1024, device="cuda", dtype=torch.float32)
        if float(alive.sum()) != 1023 * 512:        # the parent's context
            raise AssertionError("serve_fleet_proc: parent context lost")
        if handles[0].generation != 0 or handles[armed].generation < 1:
            raise AssertionError("serve_fleet_proc: generations "
                                 f"{[h.generation for h in handles]}")
        assert_line = dict(
            requests=len(stream) - lo, armed=armed,
            assert_at_step=FLEET_PROC_ASSERT_AT,
            generations=[h.generation for h in handles],
            failovers=router.failovers, wall_s=wall, rounds=len(times),
            failover_round_ms=failover["ms"],
            assert_detect_s=failover["wall"]
            - fired[f"assert.r{armed}.g0"]["wall"],
            detect_timeout_s=FLEET_PROC_DETECT_S,
            tokens_per_s=sum(len(r.tokens) for r in
                             router.requests.values()) / wall)
        assert_requests = router.requests
        router.close()
        torch.cuda.synchronize()

        ready, done = read_json(root, "ready"), read_json(root, "done")
        if not all(r["prebuilt"] for r in ready.values()):
            raise AssertionError(f"serve_fleet_proc: a child built the "
                                 f"kernels: {ready}")
        startup = {}
        for tag, r in ready.items():
            run, rep, gen = tag.split(".")
            t = spawned[run][(int(rep[1:]), int(gen[1:]))]
            startup[tag] = dict(interpreter_s=r["main"] - t,
                                cuda_s=r["cuda"] - r["main"],
                                weights_s=r["weights"] - r["cuda"],
                                engine_s=r["ready"] - r["weights"],
                                ready_s=r["ready"] - t)
        launches = {k: sum(d["launches"][k] for d in done.values())
                    for k in core.KERNELS}
        routes = {k: {rt: sum(d["routes"][k][rt] for d in done.values())
                      for rt in rts} for k, rts in core.route_counts().items()}
        if any(d["staged_prefills"] != d["prefill_calls"]
               for d in done.values()):
            raise AssertionError(f"serve_fleet_proc: unstaged prefills "
                                 f"{done}")
    finally:
        for h in children:                # stop what is still running
            h.close()
        shutil.rmtree(root, ignore_errors=True)

    for what, requests, ref in (("serve_fleet_proc kill", kill_requests,
                                 reference),
                                ("serve_fleet_proc assert", assert_requests,
                                 reference[lo:])):
        exact, rows = fleet_held(what, model, cpu_model, requests, ref, kw)
        (kill_line if "kill" in what else assert_line).update(
            token_exact=exact, crosscheck=rows)
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"serve_fleet_proc: children launched no "
                             f"{missing}")
    check_serve_routes("serve_fleet_proc", routes)
    check_path_routes("serve_fleet_proc", routes, ("layer_norm",
                                                   "decode_attention"))
    step_ms = {tag: d["p50_step_ms"] for tag, d in done.items()}
    kill_steps = [v for t, v in step_ms.items()
                  if t.startswith("kill") and v is not None]
    line = dict(
        phase="serve_fleet_proc", config="GPTConfig.small()",
        replicas=FLEET_PROC_N,
        **{k: v for k, v in kw.items() if k != "cache_dtype"},
        cache_dtype="bfloat16", max_new=FLEET_NEW, card=smi,
        state_save_s=save_s, kill=kill_line, device_assert=assert_line,
        startup=startup, child_p50_step_ms=step_ms,
        wire_ms_per_round=kill_line["p50_round_ms"] - FLEET_PROC_N
        * float(np.median(kill_steps)) if kill_steps else None,
        reporting_children=sorted(done), launches=launches,
        routes={k: routes[k] for k in SERVE_ROUTED + tuple(PATH_ROUTE)})
    return line, launches


LOADER_SAMPLES = 20 * 32   # examples/train_resnet.py: 20 steps of batch 32
LOADER_BATCH = 32


def loader_phase(smi):
    """``loader``: DataLoader.from_generator at examples/train_resnet.py:44's
    shapes (CIFAR-sized [3, 32, 32] f32 images and [1] int64 labels, the
    JAX package's synthetic_images stream, batch 32) on the card: every
    batch arrives on the card bitwise equal to the same loader's batch on
    the CPU, and an early ``break`` leaves no prefetch thread alive."""
    import threading
    from paddle_tpu_torch.data import loader as dl

    def images():
        rng = np.random.RandomState(0)
        for _ in range(LOADER_SAMPLES):
            yield (rng.rand(3, 32, 32).astype(np.float32),
                   rng.randint(10, size=(1,)).astype(np.int64))

    host = list(dl.DataLoader.from_generator(images, LOADER_BATCH,
                                             device="cpu"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = [tuple(t.clone() for t in b) for b in dl.DataLoader.from_generator(
        images, LOADER_BATCH)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not len(card) == len(host) == LOADER_SAMPLES // LOADER_BATCH:
        raise AssertionError(f"loader: {len(card)} batches")
    for i, (c, h) in enumerate(zip(card, host)):
        for a, b in zip(c, h):
            if a.device.type != "cuda" or not torch.equal(a.cpu(), b):
                raise AssertionError(f"loader: batch {i} differs")
    for _ in dl.DataLoader.from_generator(images, LOADER_BATCH):
        break
    left = [t for t in threading.enumerate()
            if t.name == dl.THREAD_NAME and t.is_alive()]
    if left:
        raise AssertionError(f"loader: {len(left)} threads after a break")
    nbytes = sum(t.numel() * t.element_size() for b in host for t in b)
    return dict(phase="loader", batches=len(card), batch=LOADER_BATCH,
                shapes=[list(t.shape) for t in host[0]], bitwise=True,
                bytes=nbytes, wall_s=wall, card=smi,
                prefetch=dl.configure()["reader_queue_size"])


def moe_config(base):
    cfg = dataclasses.replace(base, moe_experts=MOE_EXPERTS, moe_k=MOE_K)
    cfg.dropout = 0.0
    return cfg


def moe_parts_ms(cfg, tokens):
    """The device ms, forward and backward, of one MoE layer's two parts
    at the step's bf16 shapes (``time_ms`` over plain calls): the gating
    with the one-hot dispatch and combine einsums around no experts, and
    the experts' FFN over the ``[E, C, D]`` buffers."""
    from paddle_tpu_torch.nn import moe
    gen = torch.Generator().manual_seed(0)
    layer = moe.MoE(cfg.hidden_size, cfg.intermediate_size, cfg.moe_experts,
                    k=cfg.moe_k, gen=gen).to("cuda", torch.bfloat16)
    cap = layer.capacity(tokens)
    x = torch.randn(tokens, cfg.hidden_size, generator=gen).to(
        "cuda", torch.bfloat16).requires_grad_()
    buf = torch.randn(cfg.moe_experts, cap, cfg.hidden_size,
                      generator=gen).to("cuda", torch.bfloat16
                                        ).requires_grad_()

    def dispatch_combine():
        d, c, _ = moe.top_k_gating(x @ layer.w_gate, layer.k, cap)
        y = moe._einsum("ecd,tec->td", moe._einsum("td,tec->ecd", x, d), c)
        y.backward(torch.ones_like(y))

    def experts():
        h = moe._einsum("ecd,edh->ech", buf, layer.w1) + layer.b1[:, None]
        h = torch.nn.functional.gelu(h, approximate="tanh")
        y = moe._einsum("ech,ehd->ecd", h, layer.w2) + layer.b2[:, None]
        y.backward(torch.ones_like(y))
    return (time_ms(dispatch_combine, iters=5, graph=False),
            time_ms(experts, iters=5, graph=False), cap)


def moe_collisions(model, ids):
    """Per layer, the tokens that share an (expert, slot) with an earlier
    token in the bf16 forward (the cumsum of one-hots rounds past 256 in
    bf16, in both packages): one no-grad forward of bf16 copies of the
    weights, each MoE's gating recomputed from its input."""
    from paddle_tpu_torch.nn import moe
    counts = []

    def hook(mod, args, out):
        x = args[0].reshape(-1, mod.dim)
        d, _, _ = moe.top_k_gating(x @ mod.w_gate, mod.k,
                                   mod.capacity(x.shape[0]))
        per_slot = d.float().sum(0)
        counts.append(int((per_slot - 1).clamp(min=0).sum()))
    hooks = [blk.mlp.register_forward_hook(hook) for blk in model.blocks]
    params = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
    try:
        with torch.no_grad():
            torch.func.functional_call(model, params, (ids,))
    finally:
        for h in hooks:
            h.remove()
    return counts


def moe_train_phase(smi):
    """``moe_train``: bench.py:1155's GPT step (16 x 512, bf16 Adam) with
    MoE FFNs, 2 + 5 steps: per-step launches (no K4), losses finite and
    falling, a profiled step's device ms split into the one-hot dispatch
    and combine, the experts and the rest (the parts timed alone at the
    step's shapes, times the layers), the bf16 slot collisions."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.optimizer import Adam
    cfg = moe_config(GPTConfig.small())
    batch, seq = 16, 512
    model = GPT(cfg, device="cuda", seed=0)
    opt = amp.decorate(Adam(model.parameters(), 1e-4), amp.bf16_policy())
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).cuda()
    losses, times, launches, routes = train(model, opt, loss_of, (ids,), 2,
                                            MOE_STEPS)
    want = dict(train_launches_per_step(cfg.num_layers), mlp=0)
    check_launches("moe_train", launches, MOE_STEPS, want)
    check_routes("moe_train", routes, "tc",
                 tuple(k for k in TC_KERNELS if k != "mlp"))
    check_path_routes("moe_train", routes, ("layer_norm",))
    stats = step_stats("moe_train", "GPTConfig.small() + moe_experts=8, "
                       "moe_k=2", batch, seq, losses, times, launches, smi)
    step_ms, step_launches, by_name = kernel_profile(
        lambda: opt.minimize(model, loss_of, ids))
    collisions = moe_collisions(model, ids)
    del model, opt
    torch.cuda.empty_cache()
    dc, ex, cap = moe_parts_ms(cfg, batch * seq)
    layers = cfg.num_layers
    stats.update(
        experts=MOE_EXPERTS, k=MOE_K, capacity_factor=1.25, capacity=cap,
        routes=routes, step_device_ms=step_ms,
        step_kernel_launches=step_launches,
        step_idle_share=1.0 - step_ms / stats["p50_step_ms"],
        device_ms_split=dict(
            dispatch_combine=layers * dc, experts=layers * ex,
            rest=step_ms - layers * (dc + ex),
            per_layer_dispatch_combine=dc, per_layer_experts=ex,
            how="parts timed alone (time_ms, fwd + bwd) x layers; rest = "
                "profiled step - parts"),
        step_top_kernels={k[:60]: v for k, v in by_name.most_common(6)},
        bf16_slot_collisions=collisions)
    return stats, launches


def scan_remat_phase(smi):
    """``scan_remat``: bench.py:1155's GPT step, 2 + SCAN_STEPS steps, by
    the unrolled model and then with scan_layers=True under each remat
    policy, in turn in one process: the per-step launches (the blocks'
    K1, K2 and K4 twice under a recomputing policy), every scan run's
    losses within SCAN_LOSS_TOL of the unrolled run's (same seed, batch
    and optimizer), tokens/s and peak memory, which must fall from
    ``nothing`` to ``full``. Emits a line per run; returns (peak GB by
    run, launches by policy)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.nn import REMAT_POLICIES
    from paddle_tpu_torch.optimizer import Adam
    batch, seq = 16, 512
    peaks, launches_by, ref = {}, {}, None
    for policy in ("unrolled",) + REMAT_POLICIES:
        cfg = GPTConfig.small()
        cfg.dropout = 0.0
        if policy != "unrolled":
            cfg.scan_layers, cfg.remat = True, policy
        model = GPT(cfg, device="cuda", seed=0)
        opt = amp.decorate(Adam(model.parameters(), 1e-4),
                           amp.bf16_policy())
        ids = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (batch, seq))).cuda()
        losses, times, launches, routes = train(model, opt, loss_of, (ids,),
                                                2, SCAN_STEPS)
        del model, opt
        torch.cuda.empty_cache()
        layers = cfg.num_layers
        want = train_launches_per_step(layers)
        if policy in ("dots_saveable", "full"):  # the blocks' kernels rerun
            want.update(layer_norm=4 * layers + 1, flash_attention=2 * layers,
                        mlp=2 * layers)
        what = f"scan_remat {policy}"
        check_launches(what, launches, SCAN_STEPS, want)
        check_routes(what, routes, "tc")
        check_path_routes(what, routes, ("layer_norm",))
        ref = losses if ref is None else ref
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        stats = step_stats(what, f"GPTConfig.small() {policy}", batch, seq,
                           losses, times, launches, smi)
        stats.update(remat=policy, loss_rel_err_vs_unrolled=rel,
                     loss_tol=SCAN_LOSS_TOL,
                     bitwise_equal_to_unrolled=losses == ref)
        emit(dict(phase="scan_remat", **stats))
        peaks[policy] = stats["peak_memory_gb"]
        if policy != "unrolled":
            launches_by[policy] = launches
        check(f"{what} losses against the unrolled model's", rel,
              SCAN_LOSS_TOL)
    if not peaks["full"] < peaks["nothing"]:
        raise AssertionError(f"scan_remat: peak memory did not fall from "
                             f"nothing to full: {peaks}")
    return peaks, launches_by


# --------------------------------------------------------------------- ssd

SSD_BASE = 300           # examples/train_ssd.py without --tiny: 75 x 75 and
                         # 38 x 38 maps, 4 priors a cell, 28,276 priors
SSD_BATCH = 4            # the example's batch, 3 gt boxes an image
SSD_STEPS = 20           # the example's steps
SSD_BIG_BATCH = 32       # the optional throughput line: 1 warm-up and 5
SSD_BIG_STEPS = 5        # timed steps at batch 32,
SSD_BIG_WITHIN_S = 25.0  # run only if the phase is this far in by then
SSD_VALUE_TOL = 1e-5     # detection_output, card vs CPU: scores and boxes
SSD_TIE_TOL = 1e-6       # two scores this close are a near tie
MINING_FLIP_TOL = 1e-4   # a hard negative chosen on one device only must
                         # lie this close to its row's cut
SSD_DETECT = dict(score_threshold=0.01, nms_threshold=0.45,
                  keep_top_k=10)   # the example's inference settings
SSD_NMS_TOP_K = 400      # detection_output's nms_top_k: the loop's length


def tool_module(name):
    """The module ``tools/<name>.py`` of this checkout."""
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module(name)


def ssd_tools():
    """``tools/torch_ssd.py``: the port's TinySSD, the example's batch,
    loss and inference."""
    return tool_module("torch_ssd")


class MiningReplay:
    """The card's hard-negative selections, replayed on the CPU. The
    mining picks the unmatched priors of largest loss: two losses that
    round apart differently on the two devices (the convolutions sum in
    another order) swap a prior in or out of the loss, and with it that
    prior's whole gradient. ``around("cuda")`` records each
    ``ops.detection.mine_hard_examples`` call's mask in order;
    ``around("cpu")`` computes its own, returns the card's, and counts the
    entries where they differ: each must lie within ``tol`` of its row's
    cut (the smallest loss the CPU selected), or the replay raises."""

    def __init__(self, tol=MINING_FLIP_TOL):
        self.masks, self.flips, self.worst, self.tol = [], 0, 0.0, tol

    @contextlib.contextmanager
    def __call__(self, dev):
        from paddle_tpu_torch.ops import detection
        real, calls = detection.mine_hard_examples, iter(range(10 ** 9))

        def record(neg_loss, match, *args, **kw):
            mask = real(neg_loss, match, *args, **kw)
            self.masks.append(mask)
            return mask

        def replay(neg_loss, match, *args, **kw):
            mine = real(neg_loss, match, *args, **kw)
            card = self.masks[next(calls)].to(mine.device)
            flipped = card != mine
            if bool(flipped.any()):
                loss = neg_loss.detach()
                cut = torch.where(mine, loss, torch.inf).amin(-1,
                                                              keepdim=True)
                self.flips += int(flipped.sum())
                self.worst = max(self.worst, float(
                    (loss - cut).abs()[flipped].max()))
            return card

        detection.mine_hard_examples = record if dev == "cuda" else replay
        try:
            yield
        finally:
            detection.mine_hard_examples = real
        if dev != "cuda" and self.worst > self.tol:
            raise AssertionError(f"mining replay: a negative {self.worst} "
                                 f"from its row's cut chosen on one device "
                                 f"only (tol {self.tol})")

    def summary(self):
        return dict(mining_calls=len(self.masks), mining_flips=self.flips,
                    mining_flip_worst=self.worst, mining_flip_tol=self.tol)


class Replays:
    """Several replays (:class:`ReluReplay`, :class:`MiningReplay`)
    entered together around each device's step."""

    def __init__(self, *replays):
        self.replays = replays

    @contextlib.contextmanager
    def __call__(self, dev):
        with contextlib.ExitStack() as stack:
            for r in self.replays:
                stack.enter_context(r(dev))
            yield

    def summary(self):
        out = {}
        for r in self.replays:
            out.update(r.summary())
        return out


def ssd_detections(args, dev):
    """``detection_output`` of one image's (locs, scores, priors,
    variances) on ``dev`` with the example's settings, beside
    ``multiclass_nms2``'s source indices on the same decoded boxes (the
    two rows must agree): (out ``[10, 6]``, indices, count) on the
    CPU."""
    from paddle_tpu_torch.ops import detection as D
    locs, scores, priors, vars_ = (a.to(dev) for a in args)
    out, count = D.detection_output(locs, scores, priors, vars_,
                                    nms_top_k=SSD_NMS_TOP_K, **SSD_DETECT)
    dec = D.box_coder(priors, vars_, locs[:, None, :], "decode_center_size",
                      axis=1).reshape(-1, 4)
    out2, idx, count2 = D.multiclass_nms2(dec, scores.T,
                                          nms_top_k=SSD_NMS_TOP_K,
                                          background_label=0, **SSD_DETECT)
    if not (torch.equal(out, out2) and int(count) == int(count2)):
        raise AssertionError(f"detection_output and multiclass_nms2 differ "
                             f"on {dev}")
    return out.cpu(), idx.cpu(), int(count)


def held_detections(what, card, cpu):
    """One image's detections on the card against the CPU's from the same
    inputs: the count exact; each kept row's label and source index the
    CPU's, its score and box within SSD_VALUE_TOL; a row whose label or
    index differs only where the two scores at that row lie within
    SSD_TIE_TOL of each other (a near tie, returned); the padding rows
    equal. Returns (near-tie rows, the largest value error)."""
    (co, ci, cc), (po, pi, pc) = card, cpu
    if cc != pc:
        raise AssertionError(f"{what}: {cc} detections on the card, {pc} on "
                             f"the CPU")
    ties, worst = [], 0.0
    for r in range(cc):
        if int(co[r, 0]) == int(po[r, 0]) and int(ci[r]) == int(pi[r]):
            worst = max(worst, float((co[r] - po[r]).abs().max()))
        elif abs(float(co[r, 1]) - float(po[r, 1])) <= SSD_TIE_TOL:
            ties.append(r)
        else:
            raise AssertionError(f"{what}: row {r} is {co[r].tolist()} "
                                 f"(box {int(ci[r])}) on the card, "
                                 f"{po[r].tolist()} (box {int(pi[r])}) on "
                                 f"the CPU")
    check(f"{what} scores and boxes", worst, SSD_VALUE_TOL)
    if not (torch.equal(co[cc:], po[cc:]) and torch.equal(ci[cc:], pi[cc:])):
        raise AssertionError(f"{what}: padding rows differ")
    return ties, worst


def wall_ms(fn, iters=5):
    """Median wall ms of ``fn()`` synchronized, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def ssd_run(ssd, prior_scale, what):
    """SSD_STEPS Momentum(0.01, 0.9) steps of TinySSD(SSD_BASE) (weights
    from seed 0) on the example's batch, the priors divided by
    ``prior_scale`` (None: the image side, as the example divides them),
    with the launch counts zeroed just before: every loss finite, the
    last below the first, no kernel of the port launched. Then
    ``detection_output`` of each image on the card and on the CPU from the
    same locs, scores and priors (:func:`held_detections`) and
    ``DetectionMAP`` over them. Returns (line, launches, model, optimizer,
    data, the loss, image 0's detection_output arguments)."""
    import functools
    from paddle_tpu_torch.metrics import DetectionMAP
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.optimizer import Momentum
    loss_fn = functools.partial(ssd.ssd_loss_fn, prior_scale=prior_scale)
    model = ssd.TinySSD(SSD_BASE, device="cuda", seed=0)
    opt = Momentum(model.parameters(), 0.01, 0.9)
    data = [a.cuda() for a in ssd.ssd_batch(np.random.RandomState(0),
                                            SSD_BATCH, SSD_BASE)]
    matched = ssd.matched_priors(model, data[0], data[1], prior_scale)
    losses, times, launches, _ = train(model, opt, loss_fn, data, 0,
                                       SSD_STEPS)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{what}: loss did not fall {losses}")
    check_no_launches(what, launches)
    with torch.no_grad():
        locs, confs, boxes, vars_ = model(data[0])
        scores = torch.softmax(confs, -1)
        priors = boxes / (SSD_BASE if prior_scale is None else prior_scale)
    dmap = {v: DetectionMAP(ssd.NUM_CLASSES, ap_version=v)
            for v in ("integral", "11point")}
    ties, worst, counts = [], 0.0, []
    core.reset_launches()
    for i in range(SSD_BATCH):
        args = (locs[i], scores[i], priors, vars_)
        card = ssd_detections(args, "cuda")
        img_ties, err = held_detections(f"{what} image {i}", card,
                                        ssd_detections(args, "cpu"))
        ties += [[i, r] for r in img_ties]
        worst = max(worst, err)
        counts.append(card[2])
        for m in dmap.values():
            m.update(card[0][:card[2]], data[2][i], data[1][i])
    check_no_launches(f"{what} detection_output", core.launch_counts())
    p50 = float(np.median(times[1:])) * 1e3
    line = dict(
        prior_scale=SSD_BASE if prior_scale is None else prior_scale,
        matched_priors=matched.tolist(), losses=losses, p50_step_ms=p50,
        images_per_s=SSD_BATCH * (SSD_STEPS - 1) / sum(times[1:]),
        first_step_ms=times[0] * 1e3,
        detection=dict(counts=counts, value_err_max=worst,
                       value_tol=SSD_VALUE_TOL, near_ties=ties,
                       tie_tol=SSD_TIE_TOL,
                       map_integral=dmap["integral"].eval(),
                       map_11point=dmap["11point"].eval()))
    return (line, launches, model, opt, data, loss_fn,
            (locs[0], scores[0], priors, vars_))


def ssd_phase(smi):
    """``examples/train_ssd.py`` at its defaults on the card
    (:func:`ssd_run`): TinySSD(300) (28,276 priors), the example's batch
    of 4 images with 3 gt boxes each, the mean ``ssd_loss`` under
    Momentum(0.01, 0.9), 20 steps, no kernel of the port launched (the
    reference wrote none for detection), ``detection_output`` of each
    image (score 0.01, NMS 0.45, keep 10) held against the CPU's and
    ``DetectionMAP``. The example divides the head's already normalized
    priors by the image side again, so it matches no prior
    (``matched_priors``, recorded); the same run follows with the priors as
    the head returns them (``matched``), where matching, mining and the
    box regression take part. Then one profiled step of the example's
    (device ms, idle share, launches), ``detection_output``'s wall ms,
    device ms and launches on image 0 and its NMS loop's alone; then, if
    the phase is under SSD_BIG_WITHIN_S in, 1 + 5 steps at batch 32.
    Returns (line, the example's launches)."""
    from paddle_tpu_torch.ops import detection as D
    from paddle_tpu_torch.optimizer import Momentum
    ssd = ssd_tools()
    t_start = time.perf_counter()
    line, launches, model, opt, data, loss_fn, args0 = ssd_run(
        ssd, None, "ssd")
    step_ms, step_launches, by_name = kernel_profile(
        lambda: opt.minimize(model, loss_fn, *data))
    call = (lambda: D.detection_output(*args0, nms_top_k=SSD_NMS_TOP_K,
                                       **SSD_DETECT))
    det_ms = wall_ms(call)
    det_dev_ms, det_launches, _ = kernel_profile(call)
    locs0, scores0, priors, vars_ = args0
    dec = D.box_coder(priors, vars_, locs0[:, None, :],
                      "decode_center_size", axis=1).reshape(-1, 4)
    top_s, top_i = D._sort_desc(scores0.T)
    top_s, top_i = top_s[:, :SSD_NMS_TOP_K], top_i[:, :SSD_NMS_TOP_K]
    cls_boxes = dec[top_i]
    loop = (lambda: D._nms_keep_mask(cls_boxes, top_s,
                                     SSD_DETECT["nms_threshold"]))
    nms_ms = wall_ms(loop)
    nms_dev_ms, nms_launches, _ = kernel_profile(loop)
    del model, opt
    line = dict(
        config=f"TinySSD(base {SSD_BASE})", priors=int(priors.shape[0]),
        batch=SSD_BATCH, image=[3, SSD_BASE, SSD_BASE],
        optimizer="Momentum(0.01, 0.9)", dtype="float32", steps=SSD_STEPS,
        **line, launches=launches,
        profile=dict(device_ms=step_ms,
                     idle_share=1.0 - step_ms / line["p50_step_ms"],
                     launches_per_step=step_launches,
                     top_kernels={k[:60]: v for k, v in
                                  by_name.most_common(6)}),
        card=smi)
    line["detection"].update(
        **SSD_DETECT, nms_top_k=SSD_NMS_TOP_K, wall_ms=det_ms,
        device_ms=det_dev_ms, launches=det_launches, nms_loop_wall_ms=nms_ms,
        nms_loop_device_ms=nms_dev_ms, nms_loop_launches=nms_launches,
        nms_share_of_call=nms_ms / det_ms)
    line["matched"] = ssd_run(ssd, 1.0, "ssd matched")[0]
    if min(line["matched"]["matched_priors"]) == 0:
        raise AssertionError(f"ssd matched: an image matched no prior "
                             f"{line['matched']['matched_priors']}")
    torch.cuda.empty_cache()
    if time.perf_counter() - t_start < SSD_BIG_WITHIN_S:
        big = ssd.TinySSD(SSD_BASE, device="cuda", seed=1)
        bopt = Momentum(big.parameters(), 0.01, 0.9)
        bdata = [a.cuda() for a in ssd.ssd_batch(np.random.RandomState(1),
                                                 SSD_BIG_BATCH, SSD_BASE)]
        blosses, btimes, blaunches, _ = train(big, bopt, ssd.ssd_loss_fn,
                                              bdata, 1, SSD_BIG_STEPS)
        if not all(np.isfinite(blosses)):
            raise AssertionError(f"ssd batch 32: non-finite loss {blosses}")
        check_no_launches("ssd batch 32", blaunches)
        line["batch32"] = dict(
            batch=SSD_BIG_BATCH, warmup=1, steps=SSD_BIG_STEPS,
            losses=blosses, p50_step_ms=float(np.median(btimes)) * 1e3,
            images_per_s=SSD_BIG_BATCH * SSD_BIG_STEPS / sum(btimes))
    line["phase_s"] = time.perf_counter() - t_start
    return line, launches


def ssd_crosscheck_phase():
    """One f32 Momentum(0.01, 0.9) step (TF32 off, cuDNN's too) of
    TinySSD(300) at the example's batch of 4 (seed 1) on the card and on
    the CPU from the same weights, the CPU taking the card's ReLU branches
    and hard negatives (:class:`ReluReplay`, :class:`MiningReplay`): the
    loss within TRAIN_LOSS_TOL, every gradient within TRAIN_GRAD_TOL
    relative L2; no kernel of the port launched. Twice: with the example's
    loss (``ssd_crosscheck``) and with the priors as the head returns
    them (``ssd_crosscheck_matched``: matching, mining and the box
    regression carry gradient)."""
    from paddle_tpu_torch.optimizer import Momentum
    ssd = ssd_tools()
    batch = ssd.ssd_batch(np.random.RandomState(1), SSD_BATCH, SSD_BASE)
    for phase, loss_fn in (("ssd_crosscheck", ssd.ssd_loss_fn),
                           ("ssd_crosscheck_matched", ssd.matched_loss_fn)):
        launches = crosscheck_phase(
            phase, f"TinySSD(base {SSD_BASE})",
            lambda dev: ssd.TinySSD(SSD_BASE, device=dev, seed=0), loss_fn,
            batch, SSD_BATCH, None, (),
            around=Replays(ReluReplay(), MiningReplay()),
            make_opt=lambda ps: Momentum(ps, 0.01, 0.9),
            image=[3, SSD_BASE, SSD_BASE], optimizer="Momentum(0.01, 0.9)")
        check_no_launches(phase, launches)


# ------------------------------------------------------- sequence models

TAGGER_BATCH = 64        # the tagger's batch: lengths uniform in 8-64,
TAGGER_LENGTHS = (8, 64)  # labels tokens % 16 (the JAX test's mapping)
SENTIMENT_BATCH = 128    # the sentiment nets' batch: lengths uniform in
SENTIMENT_LENGTHS = (32, 256)  # 32-256 (the repo's own choice)
SEQ_WARMUP = 2
SEQ_STEPS = 10
SEQ_CROSS_BATCH = 8      # the crosschecks' batch (full widths)
TAGGER_LR = 1e-2         # f32 Adam rates of the timed runs
SENTIMENT_LR = 2e-3
CRF_NLL_TOL = 1e-4       # each row's CRF NLL, card vs CPU, relative to
                         # max(1, |CPU's|)
CRF_TIE_TOL = 1e-5       # a card path may differ from the CPU's only
                         # where the CPU scores it within this (relative)
                         # of its own best path
SEQ_OP_TOL = 1e-5        # sequence_ops floats, card vs CPU, relative to
                         # max(1, max |CPU's|)


def tagger_batch(rs, cfg, batch, lengths):
    """``(tokens [B, T], lengths [B], labels [B, T])`` on the CPU: tokens
    uniform over the vocabulary, lengths uniform in ``lengths``, T the
    longest, labels ``tokens % num_tags``."""
    lens = rs.randint(lengths[0], lengths[1] + 1, batch).astype(np.int32)
    toks = rs.randint(0, cfg.vocab_size, (batch, int(lens.max())))
    return (torch.from_numpy(toks.astype(np.int32)), torch.from_numpy(lens),
            torch.from_numpy((toks % cfg.num_tags).astype(np.int32)))


def sentiment_batch(rs, cfg, batch, lengths):
    """``(ids [B, T], lengths [B], labels [B, 1])`` on the CPU: ids in
    ``[1, vocab)``, lengths uniform in ``lengths``, T the longest."""
    lens = rs.randint(lengths[0], lengths[1] + 1, batch).astype(np.int32)
    ids = rs.randint(1, cfg.vocab_size, (batch, int(lens.max())))
    labels = rs.randint(0, cfg.num_classes, (batch, 1))
    return (torch.from_numpy(ids.astype(np.int32)), torch.from_numpy(lens),
            torch.from_numpy(labels.astype(np.int32)))


def tagger_loss(m, toks, lengths, labels):
    return m(toks, lengths, labels=labels)


def sentiment_loss_of(m, ids, lengths, labels):
    from paddle_tpu_torch.models.sentiment import sentiment_loss
    return sentiment_loss(m(ids, lengths), labels)


def seq_train(what, config, model, opt, loss_fn, args, smi, extra):
    """SEQ_WARMUP + SEQ_STEPS f32 steps (:func:`train`), every loss finite
    and the last below the first, no kernel of the port launched, then
    one profiled step: the line's training fields and the launches."""
    losses, times, launches, _ = train(model, opt, loss_fn, args,
                                       SEQ_WARMUP, SEQ_STEPS)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{what}: loss did not fall {losses}")
    check_no_launches(what, launches)
    p50 = float(np.median(times)) * 1e3
    dev_ms, step_launches, by_name = kernel_profile(
        lambda: opt.minimize(model, loss_fn, *args))
    return dict(config=config, dtype="float32", warmup=SEQ_WARMUP,
                steps=SEQ_STEPS, losses=losses, p50_step_ms=p50,
                mean_step_ms=float(np.mean(times)) * 1e3, **extra,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches=launches,
                profile=dict(device_ms=dev_ms, idle_share=1.0 - dev_ms / p50,
                             launches_per_step=step_launches,
                             top_kernels={k[:60]: v for k, v in
                                          by_name.most_common(6)}),
                card=smi), launches


def crf_path_scores(em, transition, paths, lengths):
    """Each row's path score ``[B]`` under emissions ``em [B, T, K]``:
    start + emissions + transitions + stop over the row's length."""
    start, stop, trans = transition[0], transition[1], transition[2:]
    T = em.shape[1]
    p = paths.long()
    mask = (torch.arange(T)[None, :] < lengths[:, None]).to(em.dtype)
    s = (em.gather(2, p[..., None])[..., 0] * mask).sum(1)
    s = s + (trans[p[:, :-1], p[:, 1:]] * mask[:, 1:]).sum(1)
    last = p.gather(1, (lengths.long() - 1).clamp(min=0)[:, None])[:, 0]
    return s + start[p[:, 0]] + stop[last]


def held_paths(what, card, cpu, em_cpu, transition, lengths):
    """Viterbi paths of the card against the CPU's from the same weights:
    equal, or (a near tie) the card's path scored by the CPU within
    CRF_TIE_TOL of the CPU's best, relative to max(1, |best|). Returns
    (rows equal, near-tie rows, the largest near-tie gap)."""
    diff = [int(r) for r in torch.nonzero((card != cpu).any(1))[:, 0]]
    gap = 0.0
    if diff:
        best = crf_path_scores(em_cpu, transition, cpu, lengths)
        got = crf_path_scores(em_cpu, transition, card, lengths)
        rel = (best - got) / torch.clamp(best.abs(), min=1.0)
        gap = float(rel[diff].max())
        if gap > CRF_TIE_TOL:
            raise AssertionError(f"{what}: rows {diff} decode otherwise on "
                                 f"the card, {gap} below the CPU's best "
                                 f"(tie tol {CRF_TIE_TOL})")
    return card.shape[0] - len(diff), len(diff), gap


def tagger_phase(smi):
    """BiLstmCrfTagger(TaggerConfig()) at the repo's widths (vocab 4096,
    16 tags, embed 32, hidden 64, 2 bidirectional layers; weights from
    seed 0) on the card: TAGGER_BATCH rows of lengths in TAGGER_LENGTHS,
    labels tokens % 16, f32 Adam(TAGGER_LR) (:func:`seq_train`). Then
    ``crf_decoding`` of the trained emissions (wall and device ms,
    launches, token accuracy) and the same weights on the CPU: each row's
    NLL within CRF_NLL_TOL, every path the CPU's or held at a near tie
    (:func:`held_paths`). Returns (line, launches)."""
    from paddle_tpu_torch.models.tagging import BiLstmCrfTagger, TaggerConfig
    from paddle_tpu_torch.ops import crf as C
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.optimizer import Adam
    t_start = time.perf_counter()
    cfg = TaggerConfig()
    model = BiLstmCrfTagger(cfg, device="cuda", seed=0)
    opt = Adam(model.parameters(), TAGGER_LR)
    host = tagger_batch(np.random.RandomState(0), cfg, TAGGER_BATCH,
                        TAGGER_LENGTHS)
    args = [a.cuda() for a in host]
    line, launches = seq_train(
        "tagger", "TaggerConfig()", model, opt, tagger_loss, args, smi,
        dict(batch=TAGGER_BATCH, seq=int(host[0].shape[1]),
             lengths=list(TAGGER_LENGTHS), optimizer=f"Adam({TAGGER_LR})",
             tokens_per_step=int(host[1].sum())))
    toks, lengths, labels = args
    core.reset_launches()
    with torch.no_grad():
        em = model.emissions(toks, lengths)
        call = lambda: C.crf_decoding(em, model.transition, lengths)
        path = call()
        dec_ms = wall_ms(call)
        dec_dev_ms, dec_launches, _ = kernel_profile(call)
        nll = C.linear_chain_crf(em, model.transition, labels, lengths)
    check_no_launches("tagger decoding", core.launch_counts())
    valid = (torch.arange(toks.shape[1], device=toks.device)[None]
             < lengths[:, None])
    acc = float((path == labels)[valid].float().mean())
    cpu = BiLstmCrfTagger(cfg, device="cpu", seed=1)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        em_cpu = cpu.emissions(*host[:2])
        path_cpu = C.crf_decoding(em_cpu, cpu.transition, host[1])
        nll_cpu = C.linear_chain_crf(em_cpu, cpu.transition, host[2],
                                     host[1])
    nll_err = float(((nll.cpu() - nll_cpu).abs()
                     / torch.clamp(nll_cpu.abs(), min=1.0)).max())
    check("tagger NLL card vs CPU", nll_err, CRF_NLL_TOL)
    exact, ties, gap = held_paths("tagger decoding", path.cpu(), path_cpu,
                                  em_cpu, cpu.transition, host[1])
    line.update(decode=dict(
        wall_ms=dec_ms, device_ms=dec_dev_ms, launches=dec_launches,
        tokens_per_s=int(host[1].sum()) / (dec_ms / 1e3),
        token_accuracy=acc, nll_rel_err_max=nll_err, nll_tol=CRF_NLL_TOL,
        rows_exact=exact, rows_near_tie=ties, near_tie_gap_max=gap,
        tie_tol=CRF_TIE_TOL))
    line["phase_s"] = time.perf_counter() - t_start
    return line, launches


def sentiment_phase(smi):
    """TextCNNSentiment and StackedLSTMSentiment(stacked_num=3) at
    SentimentConfig()'s widths (vocab 5149, embed 128, hidden 128, 2
    classes; weights from seed 0) on the card: SENTIMENT_BATCH rows of
    lengths in SENTIMENT_LENGTHS, f32 Adam(SENTIMENT_LR)
    (:func:`seq_train`); then a forward pass of the batch (wall and device
    ms, launches, accuracy) held against the CPU's from the same weights
    (logits within SEQ_OP_TOL of max(1, max |CPU's|)). Returns (line, the
    launches of both nets' timed steps)."""
    from paddle_tpu_torch.models.sentiment import (SentimentConfig,
                                                   StackedLSTMSentiment,
                                                   TextCNNSentiment)
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.optimizer import Adam
    t_start = time.perf_counter()
    cfg = SentimentConfig()
    host = sentiment_batch(np.random.RandomState(1), cfg, SENTIMENT_BATCH,
                           SENTIMENT_LENGTHS)
    args = [a.cuda() for a in host]
    nets, total = {}, collections.Counter()
    for name, make in (
            ("text_cnn", lambda dev, seed: TextCNNSentiment(
                cfg, device=dev, seed=seed)),
            ("stacked_lstm", lambda dev, seed: StackedLSTMSentiment(
                cfg, stacked_num=3, device=dev, seed=seed))):
        torch.cuda.reset_peak_memory_stats()
        model = make("cuda", 0)
        opt = Adam(model.parameters(), SENTIMENT_LR)
        line, launches = seq_train(
            f"sentiment {name}", f"{type(model).__name__}(SentimentConfig()"
            + (", stacked_num=3)" if name == "stacked_lstm" else ")"),
            model, opt, sentiment_loss_of, args, smi,
            dict(batch=SENTIMENT_BATCH, seq=int(host[0].shape[1]),
                 lengths=list(SENTIMENT_LENGTHS),
                 optimizer=f"Adam({SENTIMENT_LR})",
                 tokens_per_step=int(host[1].sum())))
        total.update(launches)
        core.reset_launches()
        with torch.no_grad():
            call = lambda: model(args[0], args[1])
            logits = call()
            fwd_ms = wall_ms(call)
            fwd_dev_ms, fwd_launches, _ = kernel_profile(call)
        check_no_launches(f"sentiment {name} forward", core.launch_counts())
        cpu = make("cpu", 1)
        cpu.load_state_dict({k: v.cpu()
                             for k, v in model.state_dict().items()})
        with torch.no_grad():
            want = cpu(host[0], host[1])
        err = float((logits.cpu() - want).abs().max()) / max(
            1.0, float(want.abs().max()))
        check(f"sentiment {name} logits card vs CPU", err, SEQ_OP_TOL)
        acc = float((logits.argmax(-1) == args[2][:, 0]).float().mean())
        line.update(forward=dict(
            wall_ms=fwd_ms, device_ms=fwd_dev_ms, launches=fwd_launches,
            tokens_per_s=int(host[1].sum()) / (fwd_ms / 1e3), accuracy=acc,
            logits_rel_err=err, tol=SEQ_OP_TOL))
        nets[name] = line
        del model, opt, cpu
        torch.cuda.empty_cache()
    return dict(nets=nets, phase_s=time.perf_counter() - t_start,
                card=smi), dict(total)


def seq_crosscheck_phases():
    """One f32 Adam(1e-4) step (TF32 off) of the tagger (TaggerConfig())
    and of each sentiment net (SentimentConfig(), the LSTM net's 3
    stacks) at full width, batch SEQ_CROSS_BATCH, on the card and on the
    CPU from the same weights (``crosscheck_phase``): loss within
    TRAIN_LOSS_TOL, every gradient within TRAIN_GRAD_TOL relative L2, no
    kernel of the port launched."""
    from paddle_tpu_torch.models.sentiment import (SentimentConfig,
                                                   StackedLSTMSentiment,
                                                   TextCNNSentiment)
    from paddle_tpu_torch.models.tagging import BiLstmCrfTagger, TaggerConfig
    tcfg = TaggerConfig()
    batch = tagger_batch(np.random.RandomState(2), tcfg, SEQ_CROSS_BATCH,
                         TAGGER_LENGTHS)
    launches = crosscheck_phase(
        "tagger_crosscheck", "TaggerConfig()",
        lambda dev: BiLstmCrfTagger(tcfg, device=dev, seed=0), tagger_loss,
        batch, SEQ_CROSS_BATCH, int(batch[0].shape[1]), (),
        lengths=list(TAGGER_LENGTHS))
    check_no_launches("tagger_crosscheck", launches)
    scfg = SentimentConfig()
    batch = sentiment_batch(np.random.RandomState(3), scfg, SEQ_CROSS_BATCH,
                            SENTIMENT_LENGTHS)
    for name, make in (
            ("text_cnn", lambda dev: TextCNNSentiment(scfg, device=dev,
                                                      seed=0)),
            ("stacked_lstm", lambda dev: StackedLSTMSentiment(
                scfg, stacked_num=3, device=dev, seed=0))):
        launches = crosscheck_phase(
            "sentiment_crosscheck", f"{name}: SentimentConfig()",
            make, sentiment_loss_of, batch, SEQ_CROSS_BATCH,
            int(batch[0].shape[1]), (), net=name,
            lengths=list(SENTIMENT_LENGTHS))
        check_no_launches(f"sentiment_crosscheck {name}", launches)


class OpHolder:
    """Each op's card result against its CPU result: floats within
    SEQ_OP_TOL of max(1, max |CPU's|), integers exact; keeps the worst.
    ``what`` names the phase in its errors."""

    def __init__(self, what="sequence_ops"):
        self.what = what
        self.ops, self.worst, self.worst_op = [], 0.0, None

    def __call__(self, name, card, cpu):
        if isinstance(card, (tuple, list)):
            for i, (a, b) in enumerate(zip(card, cpu)):
                self(f"{name}[{i}]", a, b)
            return
        if hasattr(card, "row_lengths"):
            self(f"{name}.values", card.values, cpu.values)
            self(f"{name}.row_lengths", card.row_lengths, cpu.row_lengths)
            return
        if hasattr(card, "lengths") and hasattr(card, "values"):
            self(f"{name}.values", card.values, cpu.values)
            self(f"{name}.lengths", card.lengths, cpu.lengths)
            return
        if not isinstance(card, torch.Tensor):
            if card != cpu:
                raise AssertionError(f"{self.what} {name}: {card} on the "
                                     f"card, {cpu} on the CPU")
            self.ops.append(name)
            return
        card = card.cpu()
        if card.shape != cpu.shape or card.dtype != cpu.dtype:
            raise AssertionError(f"{self.what} {name}: {card.shape} "
                                 f"{card.dtype} against {cpu.shape} "
                                 f"{cpu.dtype}")
        if card.dtype.is_floating_point:
            fin = torch.isfinite(cpu)
            if not torch.equal(fin, torch.isfinite(card)) or not torch.equal(
                    card[~fin], cpu[~fin]):
                raise AssertionError(f"{self.what} {name}: non-finite "
                                     "entries differ")
            err = (float((card[fin] - cpu[fin]).abs().max()) / max(
                1.0, float(cpu[fin].abs().max()))) if fin.any() else 0.0
            check(f"{self.what} {name}", err, SEQ_OP_TOL)
            if err >= self.worst:
                self.worst, self.worst_op = err, name
        elif not torch.equal(card, cpu):
            raise AssertionError(f"{self.what} {name}: integers differ")
        self.ops.append(name)


def sequence_op_cases(dev, rs):
    """``{op: result}`` of every ported op of ``ops/sequence.py``,
    ``ops/text_match.py``, ``ops/crf.py``, ``ops/nets.py`` and
    ``ops/metrics_ops.py`` on ``dev``, from inputs drawn on the host by
    ``rs`` (a ragged batch of 64 rows of 1-64 steps of 128 features,
    empty rows among them; the tagger's widths for the CRF ops)."""
    from paddle_tpu_torch.core.ragged import RaggedBatch
    from paddle_tpu_torch.ops import crf as C
    from paddle_tpu_torch.ops import metrics_ops as M
    from paddle_tpu_torch.ops import nets as N
    from paddle_tpu_torch.ops import sequence as S
    from paddle_tpu_torch.ops import text_match as X

    def d(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    lens = rs.randint(1, 65, 64).astype(np.int32)
    lens[[3, 40]] = 0
    total = int(lens.sum())
    rb = RaggedBatch(d(rs.randn(total, 128).astype(np.float32)), d(lens))
    rb1 = RaggedBatch(d(rs.randn(total).astype(np.float32) * 4), d(lens))
    ids = RaggedBatch(d(rs.randint(0, 50, total).astype(np.int32)), d(lens))
    other = RaggedBatch(d(rs.randn(int(lens[::-1].sum()), 128).astype(
        np.float32)), d(lens[::-1].copy()))
    out = {}
    out["sequence_mask"] = S.sequence_mask(d(lens))
    for pool in ("sum", "mean", "sqrt", "max", "min", "first", "last"):
        out[f"sequence_pool.{pool}"] = S.sequence_pool(rb, pool)
    out["sequence_pool.max_int"] = S.sequence_pool(ids, "max")
    out["sequence_softmax"] = S.sequence_softmax(rb1)
    x = d(rs.randn(64, 128).astype(np.float32))
    out["sequence_expand"] = S.sequence_expand(x, rb)
    out["sequence_expand_as"] = S.sequence_expand_as(x, rb)
    out["sequence_reverse"] = S.sequence_reverse(rb)
    dense, plens = S.sequence_pad(rb, -1.0, 64)
    out["sequence_pad"] = (dense, plens)
    out["sequence_unpad"] = S.sequence_unpad(dense, plens)
    out["sequence_concat"] = S.sequence_concat([rb, other])
    out["sequence_first_step"] = S.sequence_first_step(rb)
    out["sequence_last_step"] = S.sequence_last_step(rb)
    out["sequence_slice"] = S.sequence_slice(
        rb, d(np.minimum(lens, 3)), d(np.minimum(lens, 5)))
    out["sequence_enumerate"] = S.sequence_enumerate(ids.values, 4, -1)
    out["sequence_erase"] = S.sequence_erase(ids, [0, 7, 13])
    upd = RaggedBatch(d(rs.randn(total).astype(np.float32)), d(lens))
    out["sequence_scatter"] = S.sequence_scatter(
        d(np.zeros((64, 50), np.float32)), ids, upd)
    w = d(rs.randn(3 * 128, 64).astype(np.float32) * 0.1)
    out["sequence_conv"] = S.sequence_conv(rb, w, bias=d(np.ones(
        64, np.float32)))
    out["row_conv"] = S.row_conv(rb, d(rs.randn(3, 128).astype(np.float32)))
    img = d(rs.randn(8, 3, 32, 32).astype(np.float32))
    out["im2sequence"] = S.im2sequence(img, (3, 3), (2, 2), (1, 1, 1, 1))
    out["add_position_encoding"] = S.add_position_encoding(
        d(rs.randn(8, 64, 128).astype(np.float32)), 1.0, 0.5)
    toks = d(rs.randint(0, 5, (64, 64)).astype(np.int32))
    out["ctc_align"] = S.ctc_align(toks, d(lens), merge_repeated=True)
    xs = d(rs.randn(16, 32, 64).astype(np.float32))
    ys = d(rs.randn(16, 40, 64).astype(np.float32))
    xl = d(rs.randint(1, 33, 16).astype(np.int32))
    yl = d(rs.randint(1, 41, 16).astype(np.int32))
    mm = X.match_matrix_tensor(xs, ys, d(rs.randn(64, 4, 64).astype(
        np.float32) * 0.1), xl, yl, act="tanh")
    out["match_matrix_tensor"] = mm
    out["var_conv_2d"] = X.var_conv_2d(mm, xl, yl, d(rs.randn(
        8, 4, 3, 3).astype(np.float32)), 1)
    out["sequence_topk_avg_pooling"] = X.sequence_topk_avg_pooling(
        mm, xl, yl, (1, 3, 5))
    K = 16
    em = d(rs.randn(64, 64, K).astype(np.float32))
    tr = d(rs.randn(K + 2, K).astype(np.float32))
    tags = d(rs.randint(0, K, (64, 64)).astype(np.int32))
    clens = d(np.maximum(lens, 1))
    out["linear_chain_crf"] = C.linear_chain_crf(em, tr, tags, clens)
    out["crf_decoding"] = C.crf_decoding(em, tr, clens)
    out["crf_decoding.label"] = C.crf_decoding(em, tr, clens, tags)
    hyp = d(rs.randint(0, 6, (64, 48)).astype(np.int32))
    ref = d(rs.randint(0, 6, (64, 40)).astype(np.int32))
    out["edit_distance"] = C.edit_distance(
        hyp, d(rs.randint(0, 49, 64).astype(np.int32)), ref,
        d(rs.randint(1, 41, 64).astype(np.int32)), normalized=True)
    out["glu"] = N.glu(x)
    conv_w = d(rs.randn(16, 3, 3, 3).astype(np.float32) * 0.2)
    out["simple_img_conv_pool"] = N.simple_img_conv_pool(
        img, conv_w, d(np.zeros(16, np.float32)), act="relu")
    out["img_conv_group"] = N.img_conv_group(
        img, [conv_w, d(rs.randn(16, 16, 3, 3).astype(np.float32) * 0.1)])
    out["sequence_conv_pool"] = N.sequence_conv_pool(rb, w)
    scores = d(rs.randn(256, 10).astype(np.float32))
    labels = d(rs.randint(0, 10, (256, 1)).astype(np.int32))
    out["accuracy"] = M.accuracy(scores, labels, 3)
    out["auc"] = M.auc(d(rs.rand(256, 2).astype(np.float32)),
                       d(rs.randint(0, 2, (256, 1)).astype(np.int32)))
    out["precision_recall"] = M.precision_recall(
        scores.argmax(-1), labels, 10)
    chunks = M.chunk_eval(out["crf_decoding"], tags, clens, "IOB", 8)
    out["chunk_eval.counts"] = tuple(chunks[3:])
    out["chunk_eval.f1"] = torch.tensor(chunks[:3], dtype=torch.float64)
    out["crf_inputs"] = (em.cpu(), tr.cpu(), clens.cpu())
    return out


def sequence_ops_phase(smi):
    """Every ported op of the sequence family (:func:`sequence_op_cases`)
    on the card against the CPU on the same inputs (:class:`OpHolder`):
    floats within SEQ_OP_TOL, integers, lengths and ``chunk_eval``'s
    counts exact, the CRF paths held as :func:`held_paths` holds them; no
    kernel of the port launched. Prints the op count and the worst
    error with its op."""
    from paddle_tpu_torch.ops.cuda import core
    core.reset_launches()
    card = sequence_op_cases("cuda", np.random.RandomState(4))
    torch.cuda.synchronize()
    check_no_launches("sequence_ops", core.launch_counts())
    cpu = sequence_op_cases("cpu", np.random.RandomState(4))
    hold = OpHolder()
    crf_in = cpu.pop("crf_inputs")
    card.pop("crf_inputs")
    # the CRF paths, and what is computed from them, held as the tagger's
    derived = ("crf_decoding.label", "chunk_eval.counts", "chunk_eval.f1")
    exact, ties, gap = held_paths("sequence_ops crf_decoding",
                                  card.pop("crf_decoding").cpu(),
                                  cpu.pop("crf_decoding"), *crf_in)
    hold.ops.append("crf_decoding")
    for name in cpu:
        if not (ties and name in derived):
            hold(name, card[name], cpu[name])
    return dict(ops=len(hold.ops), worst_rel_err=hold.worst,
                worst_op=hold.worst_op, tol=SEQ_OP_TOL, held=hold.ops,
                crf_paths=dict(rows_exact=exact, rows_near_tie=ties,
                               near_tie_gap_max=gap, tie_tol=CRF_TIE_TOL),
                card=smi)


# ------------------------------------------------------------ program

#: the program phase's GPT-small ProgramDesc: batch x seq on the card, and
#: the crosscheck's depth and batch x seq on the card and the CPU
PROGRAM_BATCH, PROGRAM_SEQ = 8, 512
PROGRAM_WARMUP, PROGRAM_RUNS = 2, 5
PROGRAM_CHECK_LAYERS, PROGRAM_CHECK_BATCH, PROGRAM_CHECK_SEQ = 2, 2, 128
PROGRAM_LOSS_TOL = 1e-4    # f32 loss, card vs CPU, relative (PERF.md §2)
PROGRAM_GRAD_TOL = 1e-3    # each fed parameter's gradient, relative L2
#: K1 forward a layer twice and once for ln_f; K2 and K3 once a layer;
#: K5 and each K6 kernel once; K3, K5 and K6 on their f32 3xTF32 routes
PROGRAM_FWD = {"layer_norm": lambda n: 2 * n + 1,
               "flash_attention": lambda n: n, "xent_stats": lambda n: 1}
PROGRAM_BWD = {"flash_attention_bwd_dq": lambda n: n,
               "flash_attention_bwd_dkv": lambda n: n,
               "xent_bwd_dh": lambda n: 1, "xent_bwd_dwb": lambda n: 1}
#: the program path's kernels on their SIMT routes, and on 3xTF32 (f32)
PROGRAM_SIMT = ("flash_attention",)
PROGRAM_X3 = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv",
              "xent_stats", "xent_bwd_dh", "xent_bwd_dwb")
#: the kernels' torch.library ops a captured program of the desc names
PROGRAM_OPS = ("paddle_tpu_torch::layer_norm",
               "paddle_tpu_torch::flash_attention",
               "paddle_tpu_torch::xent_stats")


def gpt_param_shapes(layers, hidden, inter, vocab, max_position):
    """The fed parameters of :func:`gpt_loss_desc`, by the port's
    ``models/gpt.py GPT`` parameter names, and their shapes."""
    shapes = {"tok_emb.weight": (vocab, hidden),
              "pos_emb.weight": (max_position, hidden)}
    for i in range(layers):
        p = f"blocks.{i}."
        for ln in ("ln1", "ln2"):
            shapes[p + ln + ".scale"] = (hidden,)
            shapes[p + ln + ".bias"] = (hidden,)
        for w in ("q", "k", "v", "o"):
            shapes[f"{p}attn.w{w}"] = (hidden, hidden)
            shapes[f"{p}attn.b{w}"] = (hidden,)
        shapes[p + "fc1.weight"] = (hidden, inter)
        shapes[p + "fc1.bias"] = (inter,)
        shapes[p + "fc2.weight"] = (inter, hidden)
        shapes[p + "fc2.bias"] = (hidden,)
    shapes["ln_f.scale"] = (hidden,)
    shapes["ln_f.bias"] = (hidden,)
    return shapes


def gpt_loss_desc(layers, heads, seq, param_names):
    """GPT's training loss (``paddle_tpu/models/gpt.py:80-84`` and
    ``GPT.loss``) spelled out op by op as a ProgramDesc: the token and
    position tables' lookups and their sum; per block ``layer_norm``,
    causal flash ``multihead_attention``, the residual add, ``layer_norm``,
    ``fc``, ``gelu``, ``fc`` and the residual add; ``ln_f``; the shifted
    ``fused_xent`` against the tied token table and ``reduce_mean``. Feeds:
    ``ids`` ``[B, seq]``, ``pos`` ``[1, seq]`` and the parameters."""
    from paddle_tpu_torch.static import program_desc
    d = program_desc(["ids", "pos"] + list(param_names), ["loss"])
    d.append_op("lookup_table", ["ids", "tok_emb.weight"], ["tok"])
    d.append_op("lookup_table", ["pos", "pos_emb.weight"], ["posv"])
    d.append_op("elementwise_add", ["tok", "posv"], ["x0"])
    x = "x0"
    for i in range(layers):
        p, v = f"blocks.{i}.", f"b{i}."
        d.append_op("layer_norm", [x, p + "ln1.scale", p + "ln1.bias"],
                    [v + "ln1"], begin_norm_axis=2)
        d.append_op("multihead_attention",
                    [v + "ln1"] + [f"{p}attn.{w}{c}" for w in "wb"
                                   for c in "qkvo"],
                    [v + "att"], num_heads=heads, causal=True,
                    use_flash=True)
        d.append_op("elementwise_add", [x, v + "att"], [v + "mid"])
        d.append_op("layer_norm", [v + "mid", p + "ln2.scale",
                                   p + "ln2.bias"], [v + "ln2"],
                    begin_norm_axis=2)
        d.append_op("fc", [v + "ln2", p + "fc1.weight", p + "fc1.bias"],
                    [v + "fc1"], num_flatten_dims=2)
        d.append_op("gelu", [v + "fc1"], [v + "act"])
        d.append_op("fc", [v + "act", p + "fc2.weight", p + "fc2.bias"],
                    [v + "fc2"], num_flatten_dims=2)
        d.append_op("elementwise_add", [v + "mid", v + "fc2"], [v + "out"])
        x = v + "out"
    d.append_op("layer_norm", [x, "ln_f.scale", "ln_f.bias"], ["h"],
                begin_norm_axis=2)
    d.append_op("slice", ["h"], ["h_in"], axes=[1], starts=[0],
                ends=[seq - 1])
    d.append_op("slice", ["ids"], ["labels"], axes=[1], starts=[1],
                ends=[seq])
    d.append_op("fused_xent", ["h_in", "tok_emb.weight", "labels"], ["ce"],
                weight_layout="vh")
    d.append_op("reduce_mean", ["ce"], ["loss"])
    return d


def gpt_desc_feeds(rs, shapes, vocab, batch, seq):
    """Numpy feeds of :func:`gpt_loss_desc` from ``rs``: weights N(0,
    0.02), biases N(0, 0.01), layer-norm scales 1 + N(0, 0.1), ids
    uniform over the vocab."""
    feeds = {"ids": rs.randint(0, vocab, (batch, seq)).astype(np.int32),
             "pos": np.arange(seq, dtype=np.int32)[None]}
    for name, shape in shapes.items():
        if name.endswith(".scale"):
            a = 1.0 + 0.1 * rs.randn(*shape)
        elif len(shape) == 1:
            a = 0.01 * rs.randn(*shape)
        else:
            a = 0.02 * rs.randn(*shape)
        feeds[name] = a.astype(np.float32)
    return feeds


def desc_loss_and_grads(desc, feeds, device):
    """The parsed desc's loss and its gradient over every float feed, on
    ``device``, through ``build_fn`` and ``torch.autograd``."""
    from paddle_tpu_torch.static import ProgramDesc
    fn = ProgramDesc.parse_from_string(desc.to_json()).build_fn()
    args = [torch.from_numpy(feeds[n]).to(device) for n in desc.feeds]
    params = [a.requires_grad_() for a in args if a.is_floating_point()]
    loss = fn(*args)["loss"]
    grads = torch.autograd.grad(loss, params)
    names = [n for n, a in zip(desc.feeds, args) if a.is_floating_point()]
    return loss.detach(), dict(zip(names, grads))


def program_crosscheck(smi):
    """The desc cut to PROGRAM_CHECK_LAYERS at GPT-small's width, on the
    card and on the CPU (plain versions) on the same feeds: the loss
    within PROGRAM_LOSS_TOL relative, every gradient within
    PROGRAM_GRAD_TOL relative L2. Returns the errors."""
    from paddle_tpu_torch.models.gpt import GPTConfig
    cfg = GPTConfig.small()
    shapes = gpt_param_shapes(PROGRAM_CHECK_LAYERS, cfg.hidden_size,
                              cfg.intermediate_size, cfg.vocab_size,
                              cfg.max_position)
    desc = gpt_loss_desc(PROGRAM_CHECK_LAYERS, cfg.num_heads,
                         PROGRAM_CHECK_SEQ, shapes)
    feeds = gpt_desc_feeds(np.random.RandomState(23), shapes,
                           cfg.vocab_size, PROGRAM_CHECK_BATCH,
                           PROGRAM_CHECK_SEQ)
    card_loss, card_grads = desc_loss_and_grads(desc, feeds, "cuda")
    cpu_loss, cpu_grads = desc_loss_and_grads(desc, feeds, "cpu")
    loss_err = abs(float(card_loss) - float(cpu_loss)) / abs(float(cpu_loss))
    check("program crosscheck loss", loss_err, PROGRAM_LOSS_TOL)
    # relative L2 on a scale of at least 1e-3 of the largest gradient's
    # norm: the key biases' gradients are 0 in exact arithmetic (softmax
    # ignores a shift every key's score gets), rounding noise on both sides
    floor = 1e-3 * max(float(g.norm()) for g in cpu_grads.values())
    grad_err = {n: float((card_grads[n].cpu() - g).norm()
                         / max(float(g.norm()), floor))
                for n, g in cpu_grads.items()}
    worst = max(grad_err, key=grad_err.get)
    check(f"program crosscheck grad {worst}", grad_err[worst],
          PROGRAM_GRAD_TOL)
    return dict(layers=PROGRAM_CHECK_LAYERS, batch=PROGRAM_CHECK_BATCH,
                seq=PROGRAM_CHECK_SEQ, loss_rel_err=loss_err,
                grad_rel_l2_max=grad_err[worst], grad_worst=worst,
                loss_tol=PROGRAM_LOSS_TOL, grad_tol=PROGRAM_GRAD_TOL)


def program_decode_check():
    """A one-op desc, ``paged_decode_attention`` over the serve
    configuration's bf16 pool (8 slots, 12 heads, hd 64, page 64): K7
    launches once, and its output is held against K7's plain version."""
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.ops.cuda.decode_attention import (
        paged_attention_plain)
    from paddle_tpu_torch.static import Executor, ProgramDesc, program_desc
    dev = torch.device("cuda")
    rs = np.random.RandomState(24)
    gen = torch.Generator(device=dev).manual_seed(24)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    slots, heads, hd, ps, pmax = 8, 12, 64, 64, 16
    pool, ptab = decode_pool(dev, randn, rs, slots, heads, hd, ps, pmax,
                             torch.bfloat16)
    lengths = torch.from_numpy(
        np.array([0, 1, 63, 64, 65, 300, 700, 1024], np.int32)).to(dev)
    q = randn(slots, heads, hd)
    desc = program_desc(["q", "k", "v", "table", "lengths"], ["out"])
    desc.append_op("paged_decode_attention",
                   ["q", "k", "v", "table", "lengths"], ["out"])
    prog = ProgramDesc.parse_from_string(desc.to_json()).to_static_program()
    exe = Executor("cuda")
    core.reset_launches()
    (out,) = exe.run(prog, feed={"q": q, "k": pool["k"], "v": pool["v"],
                                 "table": ptab, "lengths": lengths},
                     fetch_list=["out"])
    torch.cuda.synchronize()
    launches = core.launch_counts()["decode_attention"]
    if launches != 1:
        raise AssertionError(f"program decode: K7 launched {launches}x")
    want = paged_attention_plain(q, pool["k"], pool["v"], ptab, lengths,
                                 1.0 / hd ** 0.5)
    err = held_decode("program paged_decode_attention", out, want,
                      lengths.tolist())
    return dict(slots=slots, heads=heads, head_dim=hd, page_size=ps,
                pool="bfloat16", k7_launches=launches, max_abs_err=err,
                tol=F32_TOL)


def program_phase(smi):
    """GPT-small's training loss as a ProgramDesc (:func:`gpt_loss_desc`,
    12 layers at full width, f32, dropout 0) written with the port's
    ``program_desc``, sent through ``to_json`` and
    ``ProgramDesc.parse_from_string``, and run by ``Executor("cuda")`` on
    numpy feeds at PROGRAM_BATCH x PROGRAM_SEQ (PROGRAM_WARMUP runs, then
    PROGRAM_RUNS timed: p50 ms). Then one forward and its gradient over
    the fed parameters through the parsed ``build_fn`` and autograd, the
    launches of each (PROGRAM_FWD, PROGRAM_BWD) asserted and every K1
    launch on the row route, K2 on its SIMT route and K3/K5/K6 on tf32x3
    (f32); a forward and its backward timed (PROGRAM_WARMUP, then
    PROGRAM_RUNS: p50 ms); the crosscheck against the CPU
    (:func:`program_crosscheck`);
    ``Program.capture`` of the parsed function on the card naming the
    kernels' ops (PROGRAM_OPS); one profiled run (device ms, idle share);
    the paged decode desc (:func:`program_decode_check`). Returns the
    phase line and the launch and route counts of the measured forward
    and backward."""
    from paddle_tpu_torch.core.program import Program
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.static import Executor, ProgramDesc
    t0 = time.perf_counter()
    cfg = GPTConfig.small()
    layers = cfg.num_layers
    shapes = gpt_param_shapes(layers, cfg.hidden_size, cfg.intermediate_size,
                              cfg.vocab_size, cfg.max_position)
    desc = gpt_loss_desc(layers, cfg.num_heads, PROGRAM_SEQ, shapes)
    text = desc.to_json()
    parsed = ProgramDesc.parse_from_string(text)
    feeds = gpt_desc_feeds(np.random.RandomState(22), shapes,
                           cfg.vocab_size, PROGRAM_BATCH, PROGRAM_SEQ)
    card = {n: torch.from_numpy(a).to("cuda") for n, a in feeds.items()}
    prog = parsed.to_static_program()
    exe = Executor("cuda")
    times = []
    for i in range(PROGRAM_WARMUP + PROGRAM_RUNS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        (loss,) = exe.run(prog, feed=card, fetch_list=["loss"])
        torch.cuda.synchronize()
        if i >= PROGRAM_WARMUP:
            times.append((time.perf_counter() - t1) * 1e3)
    if exe.cache_hits != PROGRAM_WARMUP + PROGRAM_RUNS - 1:
        raise AssertionError(f"program: {exe.cache_hits} cache hits")
    if not math.isfinite(float(loss)):
        raise AssertionError(f"program: loss {float(loss)}")
    # the measured forward and backward through the parsed build_fn
    fn = parsed.build_fn()
    args = [card[n].clone() for n in parsed.feeds]
    params = [a.requires_grad_() for a in args if a.is_floating_point()]
    core.reset_launches()
    fwd_loss = fn(*args)["loss"]
    torch.cuda.synchronize()
    fwd, fwd_routes = core.launch_counts(), core.route_counts()
    core.reset_launches()
    grads = torch.autograd.grad(fwd_loss, params)
    torch.cuda.synchronize()
    bwd, bwd_routes = core.launch_counts(), core.route_counts()
    want = {**{k: f(layers) for k, f in PROGRAM_FWD.items()}}
    got = {k: fwd[k] for k in want}
    want.update({k: f(layers) for k, f in PROGRAM_BWD.items()})
    got.update({k: bwd[k] for k in PROGRAM_BWD})
    if got != want:
        raise AssertionError(f"program launches {got}, want {want}")
    check_path_routes("program", fwd_routes, ("layer_norm",))
    for what, rts, run in (("program", fwd_routes, PROGRAM_FWD),
                           ("program backward", bwd_routes, PROGRAM_BWD)):
        for route, names in (("simt", PROGRAM_SIMT), ("tf32x3", PROGRAM_X3)):
            ran = [k for k in names if k in run]
            if ran:
                check_routes(what, rts, route, ran)
    routes = {k: {r: fwd_routes[k][r] + bwd_routes[k][r] for r in rts}
              for k, rts in fwd_routes.items()}
    if not all(torch.isfinite(g).all() for g in grads):
        raise AssertionError("program: a gradient is not finite")
    launches = {k: fwd[k] + bwd[k] for k in fwd}
    # a forward and its backward, timed (the backward holds K3 and K6)
    step_times = []
    for i in range(PROGRAM_WARMUP + PROGRAM_RUNS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.autograd.grad(fn(*args)["loss"], params)
        torch.cuda.synchronize()
        if i >= PROGRAM_WARMUP:
            step_times.append((time.perf_counter() - t1) * 1e3)
    crosscheck = program_crosscheck(smi)
    captured = Program.capture(parsed.build_fn(), *[card[n]
                                                    for n in parsed.feeds])
    named = captured.ops()
    missing = [op for op in PROGRAM_OPS if op not in named]
    if missing:
        raise AssertionError(f"program capture lacks {missing}")
    dev_ms, dev_launches, _ = kernel_profile(
        lambda: exe.run(prog, feed=card, fetch_list=["loss"]))
    p50 = float(np.median(times))
    decode = program_decode_check()
    line = dict(config="GPTConfig.small()", layers=layers,
                batch=PROGRAM_BATCH, seq=PROGRAM_SEQ, dtype="float32",
                ops=len(parsed.ops), json_bytes=len(text),
                loss=float(loss), p50_ms=p50, times_ms=times,
                fwd_bwd_p50_ms=float(np.median(step_times)),
                fwd_bwd_times_ms=step_times,
                device_ms=dev_ms, idle_share=1.0 - dev_ms / p50,
                device_launches=dev_launches, launches_checked=got,
                launches=launches, crosscheck=crosscheck,
                captured_ops=len(named),
                captured_kernel_ops={op: named.count(op)
                                     for op in PROGRAM_OPS},
                decode=decode, phase_s=time.perf_counter() - t0, card=smi)
    return line, launches, routes



def expected_route(kernel, case):
    """The route a kernel case must take: K2 by :func:`flash_route` (bf16
    with D = 64 or 128 on the tensor cores) and K3 by
    :func:`flash_bwd_route` (also f32 with D = 64 on 3xTF32);
    K1 by :func:`ln_route` (the row route for C of whole 16-byte packs, at
    most 8 a lane); K7 by :func:`decode_route` (the split route for head
    dims that are multiples of 8 up to 256); K4 by :func:`mlp_route`
    (bf16 here the tensor cores: every case has widths that are multiples
    of 8; f32 the split route up to 32 rows, the gemm route past them);
    K5 by :func:`stats_route` and K6 by :func:`bwd_route` (bf16 the
    tensor cores; f32 3xTF32 where H % 4 == 0, else the SIMT kernels)."""
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import layer_norm as ln
    from paddle_tpu_torch.ops.cuda import mlp
    from paddle_tpu_torch.ops.cuda import xent
    bf16 = case.get("dtype") in ("bf16", str(torch.bfloat16))
    dtype = torch.bfloat16 if bf16 else torch.float32
    if kernel.startswith("flash_attention_bwd"):
        return fa.flash_bwd_route(dtype, case["shape"][-1])
    if kernel.startswith("flash"):
        return fa.flash_route(dtype, case["shape"][-1])
    if kernel == "layer_norm":
        return ln.ln_route(dtype, case["shape"][-1])
    if kernel == "decode_attention":
        return da.decode_route(case["shape"][2])
    if kernel == "mlp":
        rows, hid, inter, hout = case["shape"]
        return mlp.mlp_route(dtype, hid, inter, hout, rows)
    if kernel == "xent_stats":
        return xent.stats_route(dtype, case["shape"][2])
    if kernel.startswith("xent"):
        return xent.bwd_route(dtype, case["shape"][2])
    return "tc" if bf16 else "simt"


#: the paths whose launches every row of the kernels line lists beside
#: its own path's (``launches_<path>``), the scan step under each remat
#: policy among them
# ------------------------------------------------------------ word2vec

#: the word2vec phase: the corpus, the reader, the steps (the JAX
#: defaults' model widths, batch 512, the book's 5-grams)
W2V_LINES, W2V_WORDS = 3000, 2000
W2V_FILES, W2V_THREADS = 4, 2
W2V_BATCH, W2V_STEPS = 512, 20
W2V_CHECK_STEPS = 5
W2V_LOSS_TOL = 1e-4     # card vs CPU, each of the first steps' losses,
                        # relative


def word2vec_phase(smi):
    """The word2vec book path on the card (see the module docstring, 31).
    Returns (line, launches)."""
    import tempfile
    from paddle_tpu_torch.ops.cuda import core
    bk = tool_module("torch_word2vec")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        corpus = bk.zipf_corpus(os.path.join(tmp, "corpus.txt"), W2V_LINES,
                                W2V_WORDS)
        word_idx, grams = bk.book_grams([corpus])
        paths, written = bk.write_grams(grams, tmp, W2V_FILES)
        raw, read, rate = bk.read_grams(paths, W2V_THREADS)
    ingest_s = time.perf_counter() - t0
    if not bk.same_records(written, raw):
        raise AssertionError("word2vec: the records read back are not the "
                             "records written")
    vocab = len(word_idx)
    if vocab > bk.SKIPGRAM["vocab_size"]:
        raise AssertionError(f"word2vec: {vocab} words do not fit the "
                             "skip-gram's vocabulary")
    batches = bk.batches(read, W2V_BATCH, W2V_STEPS)
    negs = bk.negatives(W2V_BATCH * (bk.NGRAM - 1), W2V_STEPS)
    models = bk.make_models(vocab, "cuda")
    torch.cuda.synchronize()
    core.reset_launches()
    w2v, sg, tw, ts = bk.train("cuda", vocab, batches, negs, models=models)
    torch.cuda.synchronize()
    launches = core.launch_counts()
    check_no_launches("word2vec", launches)
    if not (np.isfinite(w2v).all() and np.isfinite(sg).all()):
        raise AssertionError(f"word2vec: non-finite loss {w2v} {sg}")
    n = W2V_CHECK_STEPS
    cw, cs, _, _ = bk.train("cpu", vocab, batches[:n], negs[:n])
    errs = [abs(a - b) / abs(b) for a, b in zip(w2v[:n] + sg[:n], cw + cs)]
    check("word2vec card vs CPU loss", max(errs), W2V_LOSS_TOL)
    w2v_m, w2v_opt, sg_m, sg_opt = models
    a, b = bk.step_args(batches[0], None, "cuda")
    own = float(sg_opt.minimize(sg_m, bk.nce_loss, *b))
    if not math.isfinite(own):
        raise AssertionError("word2vec: the skip-gram's own draw gave a "
                             "non-finite loss")
    profile = {}
    for name, (model, opt, loss_fn, args, times, losses) in {
            "w2v": (w2v_m, w2v_opt, bk.w2v_loss, a, tw, w2v),
            "skipgram": (sg_m, sg_opt, bk.nce_loss,
                         bk.step_args(batches[0], negs[0], "cuda")[1], ts,
                         sg)}.items():
        dev_ms, step_launches, by_name = kernel_profile(
            lambda: opt.minimize(model, loss_fn, *args))
        p50 = float(np.median(times)) * 1e3
        profile[name] = dict(
            p50_step_ms=p50, mean_step_ms=float(np.mean(times)) * 1e3,
            device_ms=dev_ms, idle_share=1.0 - dev_ms / p50,
            launches_per_step=step_launches, losses=losses,
            top_kernels={k[:60]: v for k, v in by_name.most_common(5)})
    line = dict(
        corpus=f"Zipf(1.2) over {W2V_WORDS} words, {W2V_LINES} lines",
        vocab=vocab, grams=len(grams), record_files=W2V_FILES,
        reader_threads=W2V_THREADS, records_per_s=rate, ingest_s=ingest_s,
        w2v=dict(config=dict(vocab_size=vocab, **bk.W2V),
                 batch=W2V_BATCH, **profile["w2v"]),
        skipgram=dict(config=bk.SKIPGRAM, pairs_per_step=W2V_BATCH * (
            bk.NGRAM - 1), **profile["skipgram"]),
        optimizer="Adam(1e-3)", steps=W2V_STEPS, crosscheck_steps=n,
        crosscheck_max_rel_err=max(errs), tol=W2V_LOSS_TOL,
        own_draw_loss=own, launches=launches, card=smi)
    return line, launches


# ------------------------------------------------------------ op_tail

#: every name the op surface's last slice registered
OP_TAIL_NAMES = (
    # ops/tail.py
    "adaptive_pool3d", "assign", "autoincreased_step_counter",
    "bilinear_tensor_product", "continuous_value_model", "conv_shift",
    "create_global_var", "create_parameter", "create_tensor", "crop",
    "crop_tensor", "ctc_greedy_decoder", "cvm", "dynamic_lstmp",
    "filter_by_instag", "gather_tree", "gaussian_random_batch_size_like",
    "get_tensor_from_selected_rows", "has_inf", "has_nan", "hash",
    "image_resize_short", "is_empty", "l1_norm", "label_smooth",
    "lod_append", "lod_reset", "mean_iou", "merge_selected_rows", "minus",
    "modified_huber_loss", "multiplex", "ones", "pad_constant_like",
    "positive_negative_pair", "py_func", "random_crop", "resize_trilinear",
    "sample_logits", "sampling_id", "scatter_nd", "sequence_reshape",
    "similarity_focus", "soft_relu", "spectral_norm", "squared_l2_distance",
    "squared_l2_norm", "sums", "teacher_student_sigmoid_loss",
    "tensor_array_to_tensor", "uniform_random_batch_size_like", "zeros",
    # ops/fused.py
    "conv_fusion", "fused_elemwise_activation", "fused_embedding_fc_lstm",
    "fused_embedding_seq_pool", "fused_fc_elementwise_layernorm",
    "fusion_conv_inception", "fusion_repeated_fc_relu",
    "fusion_seqconv_eltadd_relu", "fusion_seqexpand_concat_fc",
    "fusion_seqpool_concat", "fusion_seqpool_cvm_concat",
    "fusion_squared_mat_sub", "fusion_transpose_flatten_concat",
    # ops/vision.py
    "affine_grid", "conv3d_transpose", "data_norm", "deformable_conv",
    "grid_sampler", "max_pool2d_with_index", "pool3d", "shuffle_channel",
    "space_to_depth", "spp", "temporal_shift", "unpool",
    # ops/graph.py
    "tree_conv")
#: the random ones, held on shape, range and seeded determinism
OP_TAIL_RANDOM = ("sampling_id", "random_crop",
                  "uniform_random_batch_size_like",
                  "gaussian_random_batch_size_like")
#: the one name whose call launches a kernel: K8, once a call
OP_TAIL_KERNEL = {"fused_fc_elementwise_layernorm": {"add_layer_norm": 1}}


def op_tail_cases(dev, rs):
    """``({name: result}, {name: {kernel: launches}})`` of every
    deterministic name of OP_TAIL_NAMES on ``dev`` (each op's launches
    counted alone), from inputs drawn on the host by ``rs``."""
    from paddle_tpu_torch.core.ragged import RaggedBatch
    from paddle_tpu_torch.core.registry import GLOBAL_OP_REGISTRY as REG
    from paddle_tpu_torch.ops.cuda import core
    from paddle_tpu_torch.ops.graph import tree_patch_coefficients
    from paddle_tpu_torch.ops.tail import ShapeDtype

    def d(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def f(*shape, scale=1.0):
        return d(rs.randn(*shape).astype(np.float32) * scale)

    def pos(*shape):
        return d(rs.rand(*shape).astype(np.float32) * 3.0)

    def ints(lo, hi, *shape):
        return d(rs.randint(lo, hi, shape).astype(np.int32))

    out, launched = {}, {}

    def run(name, *args, **kw):
        core.reset_launches()
        out[name] = REG.get(name)(*args, **kw)
        if dev == "cuda":
            torch.cuda.synchronize()
        launched[name] = {k: n for k, n in core.launch_counts().items() if n}

    x = f(512, 64)
    run("label_smooth", torch.softmax(f(256, 100), -1), epsilon=0.1)
    run("multiplex", [f(512, 64), f(512, 64), x], ints(0, 3, 512, 1))
    run("mean_iou", ints(0, 21, 4096), ints(0, 21, 4096), 21)
    vol = f(8, 64, 64)
    run("crop_tensor", vol, [4, 32, 48], [2, 16, 8])
    run("crop", vol, [6, 20, 30], [1, 30, 20])
    run("bilinear_tensor_product", f(256, 32), f(256, 48),
        f(16, 32, 48, scale=0.1), f(16))
    run("gather_tree", ints(0, 1000, 20, 32, 4), ints(0, 4, 20, 32, 4))
    run("hash", d(rs.randint(-2 ** 31, 2 ** 31 - 1, (1024, 4)).astype(
        np.int32)), 100003, 4)
    run("soft_relu", f(4096, scale=50.0), 40.0)
    run("pad_constant_like", vol, f(8, 40, 50), 0.5)
    lens = rs.randint(1, 51, 64).astype(np.int32)
    lens[[5, 9]] = 0
    run("ctc_greedy_decoder", f(64, 50, 20), d(lens))
    rb = RaggedBatch(f(int(lens.sum()), 8), d(lens))
    run("sequence_reshape", rb, 4)
    run("lod_reset", rb, d(lens[::-1].copy()))
    run("teacher_student_sigmoid_loss", f(4096, scale=10.0),
        d(np.where(rs.rand(4096) < 0.5, -rs.rand(4096),
                   rs.randint(0, 2, 4096)).astype(np.float32)))
    cvm_in = pos(1024, 34)
    run("continuous_value_model", cvm_in, True)
    run("cvm", cvm_in, False)
    run("adaptive_pool3d", f(4, 8, 8, 16, 16), (2, 4, 4), "avg")
    outer = np.array([3, 0, 2, 4], np.int32)
    inner = rs.randint(0, 6, int(outer.sum())).astype(np.int32)
    run("lod_append", f(int(inner.sum()), 16), d(outer), d(inner))
    run("image_resize_short", f(4, 3, 60, 80), 32)
    run("spectral_norm", f(64, 32, 3, 3), f(64), f(288), power_iters=3)
    steps = rs.randint(1, 21, 16).astype(np.int32)
    run("dynamic_lstmp", f(16, 20, 32), f(16, 16), f(16, 64),
        f(32, 256, scale=0.2), f(16, 256, scale=0.2), f(64, 16, scale=0.2),
        f(256), lengths=d(steps))
    run("filter_by_instag", f(256, 16), ints(0, 12, 256, 3), [3, 7, 11],
        out_size=300)
    run("conv_shift", f(256, 128), f(256, 7))
    run("squared_l2_distance", x, f(1, 64))
    run("squared_l2_norm", x)
    run("l1_norm", x)
    run("modified_huber_loss", f(4096, scale=2.0),
        d(rs.randint(0, 2, 4096).astype(np.float32)))
    run("positive_negative_pair", d(np.round(rs.rand(512), 2).astype(
        np.float32)), d(rs.randint(0, 3, 512).astype(np.float32)),
        ints(0, 16, 512))
    labels = ints(0, 1000, 256, 1)
    samples = torch.cat([labels, ints(0, 1000, 256, 32)], 1)
    run("sample_logits", f(256, 1000), labels, 32, None,
        use_customized_samples=True, customized_samples=samples,
        customized_probabilities=d(rs.uniform(0.001, 0.01, (256, 33))
                                   .astype(np.float32)))
    run("similarity_focus", f(4, 6, 16, 16), 1, [0, 3])
    run("is_empty", x)
    run("minus", x, f(512, 64))
    run("scatter_nd", ints(0, 64, 1000, 2), f(1000, 16), [64, 64, 16])
    run("autoincreased_step_counter", d(np.array(41, np.int32)))
    run("resize_trilinear", f(2, 4, 8, 16, 16), size=(12, 20, 24))
    ids = ints(0, 500, 2048)
    rows = f(2048, 32)
    run("merge_selected_rows", ids, rows)
    run("get_tensor_from_selected_rows", ids, rows, 500)
    run("py_func", lambda a, b: np.tanh(a) * b.sum(), x, f(3),
        out_shape_dtype=ShapeDtype((512, 64), torch.float32))
    run("assign", x)
    run("sums", [x, f(512, 64), f(512, 64)])
    run("has_inf", d(np.array([1.0, np.inf], np.float32)))
    run("has_nan", x)
    run("tensor_array_to_tensor", f(6, 32, 16), 1, False)
    run("ones", [64, 64], "float32", device=dev)
    run("zeros", [64, 32], "int32", device=dev)
    run("create_tensor", "float32", [8, 8], device=dev)
    run("create_global_var", [8, 8], 1.5, device=dev)
    run("create_parameter", [8, 8], device=dev)
    # ops/fused.py
    img = f(8, 16, 32, 32)
    conv_args = (img, f(32, 16, 3, 3, scale=0.1), f(32),
                 f(8, 32, 32, 32), 1, 1)
    run("conv_fusion", *conv_args)
    run("fusion_conv_inception", *conv_args)
    run("fused_elemwise_activation", x, f(512, 64),
        ["elementwise_add", "relu"])
    run("fused_embedding_fc_lstm", ints(0, 500, 16, 20),
        f(500, 256, scale=0.3), f(16, 64), f(16, 64), f(64, 256, scale=0.1),
        f(256), lengths=d(steps))
    run("fused_embedding_seq_pool", f(1000, 64), ints(0, 1000, 256, 20),
        d(rs.randint(0, 21, 256).astype(np.int32)), "mean")
    run("fused_fc_elementwise_layernorm", f(512, 768),
        f(768, 768, scale=0.05), f(512, 768), f(768), f(768), f(768))
    run("fusion_repeated_fc_relu", f(512, 256),
        [f(256, 512, scale=0.1), f(512, 128, scale=0.1)], [f(512), f(128)])
    seq_lens = d(rs.randint(0, 41, 32).astype(np.int32))
    seq = f(32, 40, 64)
    run("fusion_seqconv_eltadd_relu", seq, f(192, 128, scale=0.1), f(128),
        3, lengths=seq_lens)
    run("fusion_seqexpand_concat_fc", seq, [f(32, 16)],
        f(80, 128, scale=0.1), f(128), "relu")
    pool_lens = d(rs.randint(0, 41, 64).astype(np.int32))
    run("fusion_seqpool_concat", [f(64, 40, 32), f(64, 40, 16)], pool_lens,
        "SQRT")
    run("fusion_seqpool_cvm_concat", [pos(64, 40, 34)], pool_lens, True,
        "SUM")
    run("fusion_squared_mat_sub", f(256, 128), f(128, 64), 0.5)
    run("fusion_transpose_flatten_concat", [f(8, 16, 32), f(8, 16, 24)],
        (0, 2, 1), 1, 1)
    # ops/vision.py
    theta = d(np.tile(np.array([[1.1, 0.1, 0.05], [-0.1, 1.05, -0.1]],
                               np.float32), (8, 1, 1))
              + rs.randn(8, 2, 3).astype(np.float32) * 0.05)
    run("affine_grid", theta, (8, 3, 32, 32))
    run("grid_sampler", f(8, 3, 32, 32), out["affine_grid"])
    run("space_to_depth", img, 2)
    run("shuffle_channel", f(8, 16, 16, 16), 4)
    run("temporal_shift", f(32, 16, 8, 8), 8, 0.25)
    run("pool3d", f(4, 8, 16, 16, 16), 3, "max", 2, 1)
    run("conv3d_transpose", f(2, 8, 8, 8, 8), f(8, 4, 3, 3, 3, scale=0.2),
        2, 1, bias=f(4))
    ties = d(np.floor(rs.randn(8, 16, 32, 32) * 2.0).astype(np.float32))
    run("max_pool2d_with_index", ties, 2, 2)
    vals, idx = out["max_pool2d_with_index"]
    run("unpool", vals, idx, (32, 32))
    run("spp", img, 3, "max")
    run("data_norm", f(1024, 64), d(rs.uniform(100, 200, 64).astype(
        np.float32)), f(64, scale=10.0), d(rs.uniform(50, 500, 64).astype(
            np.float32)))
    run("deformable_conv", f(4, 16, 24, 24), f(4, 18, 24, 24, scale=2.0),
        f(32, 16, 3, 3, scale=0.1), 1, 1,
        mask=d(rs.rand(4, 9, 24, 24).astype(np.float32)))
    # ops/graph.py
    edges = np.zeros((16, 29, 2), np.int64)
    for b in range(16):
        n = rs.randint(2, 31)
        edges[b, :n - 1] = [(rs.randint(1, v), v) for v in range(2, n + 1)]
    run("tree_conv", f(16, 30, 32),
        d(tree_patch_coefficients(edges, 30, 3)), f(32, 3, 16, 8))
    return out, launched


def op_tail_random(gen_seed):
    """The random names on the card: ``{name: (result, again with the
    same seed, with another seed)}``."""
    from paddle_tpu_torch.core.registry import GLOBAL_OP_REGISTRY as REG
    probs = torch.softmax(torch.randn(4096, 8, device="cuda") * 2, -1)
    like = torch.zeros(300, 4, device="cuda")
    vol = torch.arange(6 * 64 * 64, dtype=torch.float32,
                       device="cuda").reshape(6, 64, 64)
    calls = {
        "sampling_id": lambda g: REG.get("sampling_id")(probs, g),
        "random_crop": lambda g: REG.get("random_crop")(vol, g, [6, 32, 40]),
        "uniform_random_batch_size_like": lambda g: REG.get(
            "uniform_random_batch_size_like")(like, g, [-1, 2048],
                                              min=-2.0, max=1.0),
        "gaussian_random_batch_size_like": lambda g: REG.get(
            "gaussian_random_batch_size_like")(like, g, [-1, 2048],
                                               mean=1.0, std=0.5),
        "sample_logits": lambda g: REG.get("sample_logits")(
            torch.randn(256, 1000, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(1)),
            torch.zeros(256, 1, dtype=torch.int32, device="cuda"), 32, g)[0]}

    def gen(seed):
        return torch.Generator("cuda").manual_seed(seed)
    out = {name: (fn(gen(gen_seed)), fn(gen(gen_seed)), fn(gen(gen_seed + 1)))
           for name, fn in calls.items()}
    checks = {}
    for name, (a, b, c) in out.items():
        if not torch.equal(a, b) or torch.equal(a, c):
            raise AssertionError(f"op_tail {name}: not determined by its "
                                 "generator's seed")
        checks[name] = list(a.shape)
    ids = out["sampling_id"][0]
    freq = torch.bincount(ids, minlength=8).float() / ids.numel()
    check("op_tail sampling_id frequencies",
          float((freq - probs.mean(0)).abs().max()), 0.03)
    crop = out["random_crop"][0]
    i0, j0 = int(crop[0, 0, 0]) // 64 % 64, int(crop[0, 0, 0]) % 64
    if not torch.equal(crop, vol[:, i0:i0 + 32, j0:j0 + 40]):
        raise AssertionError("op_tail random_crop: not a crop of its input")
    u = out["uniform_random_batch_size_like"][0]
    if u.shape != (300, 2048) or float(u.min()) < -2.0 or float(
            u.max()) >= 1.0:
        raise AssertionError("op_tail uniform_random_batch_size_like: "
                             "shape or range")
    check("op_tail uniform mean", abs(float(u.mean()) + 0.5), 0.01)
    n = out["gaussian_random_batch_size_like"][0]
    check("op_tail gaussian mean", abs(float(n.mean()) - 1.0), 0.01)
    check("op_tail gaussian std", abs(float(n.std()) - 0.5), 0.01)
    if out["sample_logits"][0].shape != (256, 33):
        raise AssertionError("op_tail sample_logits: shape")
    return checks


def op_tail_phase(smi):
    """Every OP_TAIL_NAMES name on the card against the CPU (see the
    module docstring, 32). Returns (line, launches)."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.core.registry import GLOBAL_OP_REGISTRY as REG
    from paddle_tpu_torch.ops.cuda import core
    t0 = time.perf_counter()
    missing = [n for n in OP_TAIL_NAMES if n not in REG]
    if missing:
        raise AssertionError(f"op_tail: not registered {missing}")
    card, launched = op_tail_cases("cuda", np.random.RandomState(5))
    cpu, _ = op_tail_cases("cpu", np.random.RandomState(5))
    covered = set(card) | set(OP_TAIL_RANDOM)
    if covered != set(OP_TAIL_NAMES):
        raise AssertionError(f"op_tail: names not run "
                             f"{sorted(set(OP_TAIL_NAMES) - covered)}")
    wrong = {n: k for n, k in launched.items()
             if k != OP_TAIL_KERNEL.get(n, {})}
    if wrong:
        raise AssertionError(f"op_tail launches (name: kernels): {wrong}")
    launches = collections.Counter()
    for k in launched.values():
        launches.update(k)
    hold = OpHolder("op_tail")
    for name in cpu:
        hold(name, card[name], cpu[name])
    random_shapes = op_tail_random(7)
    # LayerNorm with scale and shift off: K1 (K8 with a residual)
    g = torch.Generator().manual_seed(8)
    x, r = torch.randn(6, 768, generator=g), torch.randn(6, 768, generator=g)
    ln_launches = {}
    for scale, shift in ((False, False), (True, False), (False, True)):
        ln = pnn.LayerNorm(768, scale=scale, shift=shift)
        with torch.no_grad():
            want = (ln(x), ln(x, r))
            ln.to("cuda")
            core.reset_launches()
            got = (ln(x.cuda()), ln(x.cuda(), r.cuda()))
            torch.cuda.synchronize()
        counts = {k: n for k, n in core.launch_counts().items() if n}
        if counts != {"layer_norm": 1, "add_layer_norm": 1}:
            raise AssertionError(f"op_tail LayerNorm(scale={scale}, "
                                 f"shift={shift}) launched {counts}")
        launches.update(counts)
        ln_launches[f"scale={scale},shift={shift}"] = counts
        hold(f"LayerNorm(scale={scale},shift={shift})", got, want)
    line = dict(names=len(OP_TAIL_NAMES), ops=len(hold.ops),
                worst_rel_err=hold.worst, worst_op=hold.worst_op,
                tol=SEQ_OP_TOL, random=random_shapes,
                kernel_launches=dict(launches),
                fused_fc_elementwise_layernorm=launched[
                    "fused_fc_elementwise_layernorm"],
                layer_norm_switches=ln_launches,
                seconds=time.perf_counter() - t0, held=hold.ops, card=smi)
    return line, collections.Counter(launches)


LISTED_PATHS = ("serve_spec", "train", "bert", "bert_large", "trainer",
                "transformer", "resnet", "trainer_resnet", "ctr", "ssd",
                "tagger", "sentiment", "program", "word2vec", "op_tail",
                "gpt_decode",
                "gpt_decode_int8", "serve_int8", "serve_fleet",
                "serve_fleet_proc", "moe_train", "export",
                "scan_nothing", "scan_dots_saveable", "scan_full")

#: the kernels with a row per route in the kernels line, their routes
#: (the first row under the kernel's name, the others "<name>.<route>")
ROUTED_ROWS = {"flash_attention": ("simt", "tc"),
               "flash_attention_bwd_dq": ("simt", "tc", "tf32x3"),
               "flash_attention_bwd_dkv": ("simt", "tc", "tf32x3"),
               "mlp": ("split", "gemm", "tc"),
               "xent_stats": ("tc", "tf32x3"),
               "xent_bwd_dh": ("tc", "tf32x3"),
               "xent_bwd_dwb": ("tc", "tf32x3")}


def kernel_table(by_kernel, paths, routes):
    """The rows of the {"kernels": [...]} line, each at its kernel's first
    timed case on the row's route. K2, K3 and K4 have a row per route
    (:data:`ROUTED_ROWS`): the SIMT ones (serve's for K2 and K4: K4's
    split route at decode's 8 rows under the kernel's name and its gemm
    route at a 512-row prefill chunk as "mlp.gemm"; train_crosscheck's f32
    step for K3, whose SIMT launches there are 0: its f32 D = 64 takes
    tf32x3) and the tc one (GPT training's) as "<name>.tc"; K5 and K6
    their bf16 tensor-core kernels under the kernel's name (GPT
    training's); K3, K5 and K6 their f32 3xTF32 ones as "<name>.tf32x3"
    (the program path's); the others one SIMT row.
    ``paths`` holds each path's launch counts: serve and train_crosscheck
    (a row's own path only) and :data:`LISTED_PATHS` (resnet and ctr are
    0 for every kernel); ``routes`` the route counts of the paths that
    have them, from which a routed row's ``launches`` are its route's."""
    from paddle_tpu_torch.ops.cuda import core
    table = []
    for name, kernel in core.KERNELS.items():
        if name in ROUTED_ROWS:
            variants = ROUTED_ROWS[name]
        elif name in PATH_ROUTE:
            variants = (PATH_ROUTE[name],)
        else:
            variants = ("simt",)
        for variant in variants:
            case = next(c for c in by_kernel[name] if "kernel_ms" in c
                        and c.get("route", variant) == variant)
            if variant == "tf32x3":
                path = "program"
            elif variant == "tc" or name not in SERVE_KERNELS + BERT_KERNELS:
                path = "train"
            elif name in SERVE_KERNELS:
                path = "serve"
            elif name.startswith("flash"):
                path = "train_crosscheck"
            else:
                path = "bert"
            launches = paths[path][name]
            if name in ROUTED_ROWS and path in routes:
                launches = routes[path][name][variant]
            table.append(dict(
                name=name if variant == variants[0] else f"{name}.{variant}",
                route="cuda", variant=variant,
                source=kernel.route_sources.get(variant, kernel.source),
                replaces=kernel.replaces, launches=launches,
                launches_path=path,
                **{f"launches_{p}": paths[p][name] for p in LISTED_PATHS},
                max_abs_err=case["max_abs_err"],
                ms=case["kernel_ms"], plain_ms=case["plain_ms"],
                bound_ms=case["bound_ms"],
                bound_by=case["bound_by"],
                library_ms=case["library_ms"],
                shape=case.get("shape", case.get("lengths")),
                dtype=case.get("dtype")))
        if name == "add_layer_norm":
            table.append(mixed_row(kernel, by_kernel[name], paths))
    return table


def mixed_row(kernel, cases, paths):
    """K8's row at the Transformer's shape and types (f32 rows, bf16 scale
    and bias), with the transformer_big path's launches."""
    case = next(c for c in cases if c.get("variant") == "mixed"
                and "kernel_ms" in c)
    row = dict(name="add_layer_norm.mixed", route="cuda", variant="mixed",
               source=kernel.source, replaces=kernel.replaces,
               launches=paths["transformer"][kernel.name],
               launches_path="transformer",
               **{f"launches_{p}": paths[p][kernel.name]
                  for p in LISTED_PATHS})
    row.update({k: case[k] for k in (
        "max_abs_err", "bound_ms", "bound_by", "library_ms", "shape",
        "dtype", "params_dtype")}, ms=case["kernel_ms"],
        plain_ms=case["plain_ms"])
    return row


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
    from paddle_tpu_torch.models.ernie import ErnieConfig, ErnieForPretraining
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig, GPTDecoder
    from paddle_tpu_torch.ops.cuda import core

    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase="device", kind=kind, count=torch.cuda.device_count(),
              nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, allow_tf32=False))
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    lib = core.build()
    core.library()
    ptxas = []
    for path in sorted(glob.glob(os.path.join(os.path.dirname(lib),
                                              "*.ptxas.txt"))):
        with open(path) as f:
            ptxas += [ln.strip() for ln in f if "Used" in ln]
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              library=os.path.relpath(lib), ptxas=ptxas))
    torch.cuda.synchronize()

    dev = torch.device("cuda")
    emit(dict(phase="floor", what="time_ms of a CUDA graph of one empty "
              "kernel", ms=floor_ms(dev)))
    results = kernel_cases(dev)
    results.update(train_kernel_cases(dev))
    results.update(bert_kernel_cases(dev))
    results["transformer_shapes"] = transformer_kernel_cases(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    by_kernel = {}
    for key, cases in results.items():
        for case in cases:
            name = case.pop("kernel", key)
            want = expected_route(name, case)
            if case.get("route", want) != want:
                raise AssertionError(f"{name} {case.get('shape')}: took "
                                     f"the {case['route']} route, not "
                                     f"{want}")
            by_kernel.setdefault(name, []).append(case)
            emit(dict(phase="kernel", kernel=name, **case))

    cfg = GPTConfig.small()
    cfg.dropout = 0.0
    model = GPTDecoder(cfg, device="cuda", seed=0)
    serve_kw = dict(num_slots=8, page_size=64, max_len=1024,
                    prefill_len=512, cache_dtype=torch.bfloat16)
    serve(model, 1, (64, 64), None, 4, serve_kw, seed=1)    # warm-up
    torch.cuda.synchronize()
    core.reset_launches()
    eng, rids, stats = serve(model, 16, (64, 512), 700, 64, serve_kw,
                             seed=0)
    launches = core.launch_counts()
    serve_routes = core.route_counts()
    torch.cuda.synchronize()
    missing = [k for k in SERVE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serve path: "
                             f"{missing}")
    check_serve_routes("serve", serve_routes)
    check_path_routes("serve", serve_routes, ("layer_norm",
                                              "decode_attention"))
    emit(dict(phase="serve", config="GPTConfig.small()",
              **{k: v for k, v in serve_kw.items() if k != "cache_dtype"},
              cache_dtype="bfloat16", launches=launches,
              routes={k: serve_routes[k] for k in SERVE_ROUTED
                      + tuple(PATH_ROUTE)}, **stats))

    cpu_model = GPTDecoder(cfg, device="cpu", seed=0)
    pick = [eng.requests[rids[-1]], eng.requests[rids[0]]]
    rows = crosscheck(model, cpu_model, pick, 64, 512)
    torch.cuda.synchronize()
    emit(dict(phase="crosscheck", rows=rows))

    export_line, export_launches = export_phase(model, serve_kw, smi,
                                                stats["p50_step_ms"])
    emit(export_line)

    shared_line, _ = serve_shared_phase(model, cpu_model, serve_kw, smi)
    emit(shared_line)

    spec_line, spec_launches = serve_spec_phase(
        model, cpu_model, serve_kw, smi,
        {r: eng.requests[r].tokens for r in rids}, stats)
    emit(spec_line)

    int8_kw = dict(serve_kw, kv_dtype=torch.int8)
    core.reset_launches()
    _, _, stats8 = serve(model, 4, (64, 512), 600, 16, int8_kw, seed=2)
    torch.cuda.synchronize()
    launches8 = core.launch_counts()
    routes8 = core.route_counts()
    check_path_routes("int8", routes8, ("decode_attention",))
    emit(dict(phase="int8", kv_dtype="int8", launches=launches8,
              routes={"decode_attention": routes8["decode_attention"]},
              **{k: v for k, v in stats8.items() if k != "prompt_lens"}))

    fleet_line, fleet_launches, fleet_reference = serve_fleet_phase(
        model, cpu_model, smi)
    emit(fleet_line)
    torch.cuda.empty_cache()
    proc_line, proc_launches = serve_fleet_proc_phase(
        model, cpu_model, smi, fleet_reference,
        fleet_line["runs"][FLEET_COUNTS.index(FLEET_PROC_N)]["p50_round_ms"])
    emit(proc_line)
    emit(loader_phase(smi))
    torch.cuda.empty_cache()

    decode_line, decode_launches, prompt, float_out, float_logits = \
        gpt_decode_phase(model, cpu_model, smi)
    emit(dict(phase="gpt_decode", **decode_line))
    decode8_line, decode8_launches = gpt_decode_int8_phase(
        model, prompt, float_out, float_logits, smi)
    emit(dict(phase="gpt_decode_int8", **decode8_line))
    del float_logits
    serve8_line, serve8_launches = serve_int8_phase(model, serve_kw, smi)
    emit(dict(phase="serve_int8", **serve8_line))

    del model, eng
    torch.cuda.empty_cache()
    train_stats, train_launches = train_phase(cfg, smi)
    emit(dict(phase="train", **train_stats))

    small = GPTConfig.small()
    small.dropout = 0.0
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, small.vocab_size, (2, 128)))
    crosscheck_routes = {}
    crosscheck_launches = crosscheck_phase(
        "train_crosscheck", "GPTConfig.small()",
        lambda dev: GPT(small, device=dev, seed=0), loss_of, (ids,), 2, 128,
        TRAIN_KERNELS, routes=crosscheck_routes)

    torch.cuda.empty_cache()
    scan_peaks, scan_launches = scan_remat_phase(smi)
    emit(dict(phase="scan_remat", peak_memory_gb=scan_peaks, card=smi))
    torch.cuda.empty_cache()
    moe_line, moe_launches = moe_train_phase(smi)
    emit(dict(phase="moe_train", **moe_line))
    torch.cuda.empty_cache()
    moe_small = moe_config(small)
    crosscheck_phase(
        "moe_crosscheck", "GPTConfig.small() + moe_experts=8, moe_k=2",
        lambda dev: GPT(moe_small, device=dev, seed=0), loss_of, (ids,), 2,
        128, tuple(k for k in TRAIN_KERNELS if k != "mlp"), routes={})

    torch.cuda.empty_cache()
    bert_stats, bert_launches = bert_train_phase(smi)
    emit(dict(phase="bert_train", **bert_stats))

    torch.cuda.empty_cache()
    base = BertConfig.base()
    base.dropout = 0.0
    batch = bert_batch(np.random.RandomState(4), base.vocab_size, 2, 128, 19,
                       pad_row0=90, segment_b=60)
    crosscheck_phase(
        "bert_crosscheck", "BertConfig.base()",
        lambda dev: BertForPretraining(base, device=dev, seed=0),
        bert_loss_of, batch, 2, 128, BERT_KERNELS, routes={},
        attention_mask="row 0 padded after 90 tokens",
        token_type_ids="segment B from position 60", mask_positions=19)

    torch.cuda.empty_cache()
    ernie = ErnieConfig.base()
    ernie.dropout = 0.0
    batch = bert_batch(np.random.RandomState(5), ernie.vocab_size, 2, 128,
                       19, pad_row0=90, segment_b=60)
    crosscheck_phase(
        "ernie_crosscheck", "ErnieConfig.base()",
        lambda dev: ErnieForPretraining(ernie, device=dev, seed=0),
        bert_loss_of, batch, 2, 128, BERT_KERNELS, routes={},
        vocab=ernie.vocab_size,
        attention_mask="row 0 padded after 90 tokens",
        token_type_ids="segment B from position 60", mask_positions=19)

    torch.cuda.empty_cache()
    large_stats, large_launches = bert_large_phase(smi)
    emit(dict(phase="bert_large", **large_stats))

    torch.cuda.empty_cache()
    _, trainer_launches = trainer_phase(smi, bert_stats)

    torch.cuda.empty_cache()
    transformer_stats, transformer_launches = transformer_phase(smi)
    emit(dict(phase="transformer_big", **transformer_stats))
    torch.cuda.empty_cache()
    transformer_crosscheck_phase()
    torch.cuda.empty_cache()
    emit(dict(phase="seq2seq", **seq2seq_phase(smi)))

    torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = True
    resnet_line, resnet_launches = resnet50_phase(smi)
    emit(dict(phase="resnet50", **resnet_line))
    torch.cuda.empty_cache()
    resnet_crosscheck_phase()
    torch.cuda.empty_cache()
    _, trainer_resnet_launches = trainer_resnet_phase(smi)
    torch.cuda.empty_cache()
    emit(dict(phase="vision_cls", **vision_cls_phase(smi)))

    torch.cuda.empty_cache()
    ctr_line, ctr_launches = ctr_phase(smi)
    emit(dict(phase="ctr", **ctr_line))
    torch.cuda.empty_cache()
    ctr_crosscheck_phase()
    torch.cuda.empty_cache()
    emit(dict(phase="ctr_host", **ctr_host_phase(smi)))

    torch.cuda.empty_cache()
    ssd_line, ssd_launches = ssd_phase(smi)
    emit(dict(phase="ssd", **ssd_line))
    torch.cuda.empty_cache()
    ssd_crosscheck_phase()

    torch.cuda.empty_cache()
    tagger_line, tagger_launches = tagger_phase(smi)
    emit(dict(phase="tagger", **tagger_line))
    torch.cuda.empty_cache()
    sentiment_line, sentiment_launches = sentiment_phase(smi)
    emit(dict(phase="sentiment", **sentiment_line))
    torch.cuda.empty_cache()
    seq_crosscheck_phases()
    emit(dict(phase="sequence_ops", **sequence_ops_phase(smi)))
    torch.cuda.empty_cache()
    program_line, program_launches, program_routes = program_phase(smi)
    emit(dict(phase="program", **program_line))
    torch.cuda.empty_cache()
    word2vec_line, word2vec_launches = word2vec_phase(smi)
    emit(dict(phase="word2vec", **word2vec_line))
    torch.cuda.empty_cache()
    op_tail_line, op_tail_launches = op_tail_phase(smi)
    emit(dict(phase="op_tail", **op_tail_line))
    emit(dict(phase="timeline", last_phase="op_tail", limit_s=1200.0))

    table = kernel_table(by_kernel, {
        "serve": launches, "serve_spec": spec_launches,
        "train": train_launches,
        "train_crosscheck": crosscheck_launches, "bert": bert_launches,
        "bert_large": large_launches, "trainer": trainer_launches,
        "transformer": transformer_launches, "resnet": resnet_launches,
        "trainer_resnet": trainer_resnet_launches,
        "ctr": ctr_launches, "ssd": ssd_launches,
        "tagger": tagger_launches, "sentiment": sentiment_launches,
        "program": program_launches, "word2vec": word2vec_launches,
        "op_tail": op_tail_launches, "gpt_decode": decode_launches,
        "gpt_decode_int8": decode8_launches, "serve_int8": serve8_launches,
        "serve_fleet": fleet_launches, "serve_fleet_proc": proc_launches,
        "moe_train": moe_launches, "export": export_launches,
        **{f"scan_{p}": n for p, n in scan_launches.items()}},
        {"serve": serve_routes, "program": program_routes,
         "train_crosscheck": crosscheck_routes})
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fleet-worker"]:
        sys.exit(fleet_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--export-worker"]:
        sys.exit(export_worker(sys.argv[2]))
    sys.exit(main())
