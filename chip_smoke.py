#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dtf_tpu_torch) on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON object per line (the card's
``nvidia-smi`` name and power limit also print as they come):

  1. device   -- the card, torch and CUDA versions; the kernels are
                 built from ``dtf_tpu_torch/csrc`` (one nvcc per source,
                 all started together) and the build time printed.
                 Every Python process the script starts shares one
                 bytecode cache under ``dtf_tpu_torch/_build/pycache``.
  2. kernels  -- each CUDA kernel against its plain PyTorch version on
                 the same inputs on the card: max abs error and
                 tolerance, then kernel, plain and library times (CUDA
                 events, warmed up, median of five, inputs rotated
                 through enough copies to defeat the 50 MB L2) and the
                 least time the card could take (for float32 at the
                 tensor cores' 165 TFLOP/s of f32-accurate work, with
                 the CUDA cores' 67 TFLOP/s beside it).  K1, K2a, K2b
                 and K3 have two routes, reported as separate cases:
                 bfloat16 on tensor cores (wgmma); float32 in split
                 TF32 products on tensor cores (mma.sync).  K1 at
                 serving, ragged, D 64 and training shapes; the backward
                 K2a, K2b and K3 at [2, 200, 6, 128], [1, 2048, 6, 128]
                 and [2, 256, 8, 64], causal and full, f32 and bf16, K3
                 against K2a + K2b, each kernel run twice bit for bit,
                 then all three timed in both dtypes at the training
                 shape [8, 2048, 6, 128] beside the backward of
                 F.scaled_dot_product_attention (K3 with the device time
                 of its two passes from torch.profiler), then K2a and
                 K2b at cross lengths (Sq != Sk: 200 / 320, 320 / 200 at
                 D 128, 64 / 256 at D 64), causal and full, both dtypes,
                 twice bit for bit; K4 (a split pass and a combine: S
                 below 16 decodes on CUDA cores, chunks run on the
                 tensor cores) at decode [8, 1, 6, 128] and [8, 1, 6, 64]
                 and chunks [1, 64, 6, 128] at start 0, 64, 1984 and
                 [1, 16, 6, 128] at 1984, both dtypes, each twice bit
                 for bit, then its keys per split swept, and its f32
                 chunk route at q x 4 against float64; last, peaked
                 attention in float32 (q scaled by 4, [1, 2048, 6, 128],
                 causal and full): K1, K2a, K2b and K3 and their plain
                 versions against the plain versions run in float64,
                 each kernel within its f32 gate of float64.  Then the
                 tensor-parallel shard's shapes (odd head counts no
                 other case launches): K1 and K3 bf16 at
                 [2, 2048, 3, 128] causal and K4 bf16 at decode
                 [8, 1, 3, 128], each against its plain version under
                 the same tolerances, twice bit for bit, timed; and a
                 pipeline stage's (``kernels_pp``): K1 and K3 bf16 at
                 [1, 2048, 8, 64] causal, likewise; and an
                 expert-parallel rank's (``kernels_ep``): K1 and K3 bf16
                 at [2, 2048, 8, 64] causal, likewise.
  3. correct  -- ``transformer_tpu`` at full width in float32, random
                 weights from ``--seed``: greedy tokens from the port's
                 ServeEngine equal the argmax of the port's teacher-
                 forced logits over prompt + generated tokens; sampled
                 requests replay token for token; and the kernels'
                 launches in one first prefill chunk, one continuation
                 chunk and one decode step are counted (one per layer).
  4. serve    -- ``cli.serve_main.main`` in bf16: 16 requests, prompts
                 up to 512 tokens, 64 new tokens each, 8 slots.  The
                 kernels' launch counters are zeroed just before and
                 read just after; K1 and K4 must have run, as many
                 times per first prefill chunk (K1) and per decode step
                 and continuation chunk (K4) as phase 3 counted.
     decode_profile -- ``Decoder.decode_step`` in bf16 on a full batch
                 of 8 rows holding 300-576 tokens: the synced host time
                 of a step, then five steps under torch.profiler --
                 device time by kernel kind, K4's two passes and share,
                 the idle share (a profiler that sees no device time for
                 either of K4's passes fails the run).
  5. train_f32 -- ``transformer_tpu`` in float32, batch 2 x 2048: one
                 step's gradients through K1 + K3 equal those with
                 attention bound to K1 + K2a/K2b and to the plain
                 versions (each within 1e-4 of its largest |value|);
                 launches per step counted for each binding and for
                 remat; each binding's synced step time (forward and
                 backward); three AdamW steps with K3 and with K2a/K2b
                 give the same losses (1e-5 relative).
     train_bf16_parity -- the same model and batch in bf16 compute:
                 gradients through K1 + K3 and through K1 + K2a/K2b
                 (tensor cores) within 1e-2 of each parameter's largest
                 |value| of those through the plain versions, or within
                 twice the gap of a reordered plain binding; three
                 AdamW steps' losses within 5e-3 relative of plain's.
  6. train    -- ``cli.lm_main.main`` in bf16, batch 8 x 2048, 30 steps,
                 the counters zeroed just before and read just after:
                 finite falling losses, tokens/s, synced step-time p50,
                 peak memory, MFU against 989 TFLOP/s, 12 K1 and 12 K3
                 launches a step.
     train_split -- its companion: the same run, 20 steps, with
                 attention bound to ``fused_bwd=False``: 12 K1, 12 K2a
                 and 12 K2b launches a step, step time and tokens/s
                 beside K3's.  Then two steps of a fresh default trainer
                 under torch.profiler: device time by kernel kind and
                 the device's idle share (a profiler that sees no device
                 time for K1 or K3 fails the run).
  7. train_resnet -- the ResNet path, which runs no hand kernel
                 (cuDNN convolutions, BatchNorm in plain torch ops):
     resnet_f32 -- resnet56 in float32, batch 32: one step's loss,
                 logits, gradients and BN buffers on the card against
                 float64 on the CPU (the whole gradient held to three
                 times the CPU float32 step's distance; see
                 ``check_resnet_f32``);
     resnet_determinism -- two fresh resnet56 bf16 runs of 3 steps,
                 bit-identical; step time with cudnn.deterministic on
                 and off (resnet56 b128, resnet50 b256);
     train_cifar / train_imagenet -- ``cli.cifar_main.main`` (resnet56,
                 bf16, batch 128, 50 steps) and ``cli.imagenet_main
                 .main`` (resnet50, bf16, batch 256, 30 steps), then 20
                 steps of ``--use_trivial_model``: finite falling
                 losses, images/s, step-time p50, peak memory, MFU from
                 FlopCounterMode's FLOPs an image;
     resnet_profile -- two steps of each under torch.profiler: device
                 time by kind (convolutions, BatchNorm, optimizer,
                 elementwise, reductions, copies) and idle share (no
                 convolution kernel seen fails the run);
     resnet_stem -- the space-to-depth stem against the plain 7x7/2,
                 forward and backward at [256, 224, 224, 3] bf16;
     train_cifar_files -- ``cifar_main --data_dir`` on CIFAR-10 binary
                 files it writes (uint8 wire), 10 steps and an eval that
                 must count each of the 1000 test examples once.
  8. data parallelism -- each run in processes of its own, every rank
                 printing its per-step losses, step times, kernel
                 launches (counters zeroed just before its run) and a
                 digest of its trained weights:
     dp_world1_cifar / dp_world1_lm -- ``cli.cifar_main`` (resnet56,
                 bf16, batch 128) and ``cli.lm_main`` (transformer_tpu
                 at ``DP_LM_LAYERS`` (6) of its 12 layers, every width
                 kept, bf16, batch 8 x 2048), 20 steps each, with
                 ``--distribution_strategy off`` in a plain process and
                 ``multi_worker_mirrored`` through ``cli/launch.py`` with
                 one rank, so an NCCL group exists and the gradient
                 all-reduce runs, in turns (off, NCCL, NCCL, off):
                 losses and weights bit for bit, both step times (the
                 per-step cost of data parallelism), one K1 and one K3
                 launch a layer and step on the LM's path;
     dp_two_ranks -- resnet20, float32, global batch 32, 3 steps on
                 CIFAR files it writes (each rank its file shard), sync
                 BN off and on: two ranks sharing the card over gloo
                 (``initialize(cfg, backend="gloo")``: CUDA tensors
                 reduced through the host) and the same two ranks on the
                 CPU, the four runs at once; the ranks end
                 bit-identical and the card's losses are within
                 ``DP_LOSS_RTOL`` of the CPU's;
     dp_nccl_multi_card -- with two cards, the same runs over NCCL one
                 card a rank; with one, a line saying it is unmeasured.
  9. recovery -- crash-exact resume through the entry points, each run
                 under ``cli/launch.py`` with sealed checkpoints every 2
                 steps (``--checkpoint_keep 2``) and a trace, its
                 processes printing their losses, launches, a digest of
                 the trained state dict and the checkpoint times (the
                 two uninterrupted runs at once, and resnet56's crash
                 run beside recovery_serve; the LM's faulted run and the
                 preempted one alone):
     recovery_disk -- the free space of the temporary directory;
     recovery_lm -- ``cli.lm_main`` transformer_tpu bf16, batch 8 x
                 2048, one ``multi_worker_mirrored`` rank on NCCL, 8
                 steps; then, from an empty model dir, the same with
                 ``--resume --fault crash@step:4`` and one restart: exit
                 0 after a crash exit 77, resumed at step 4, every
                 step's loss equal as a float, the state dicts' and the
                 final checkpoints' sha256 equal, ``trace_main --check
                 --allow injected_fault`` green, 48 K1 and 48 K3
                 launches in the resumed process (steps 5-8);
     recovery_serve -- ``cli.serve_main.main --model_dir`` on that run's
                 checkpoint (4 requests; K1 and K4 launched), and its
                 engine's greedy tokens equal to those the trained
                 parameters held in memory give;
     recovery_resnet_crash / recovery_resnet_preempt -- ``cli.cifar_main``
                 resnet56 bf16 at batch 128 on CIFAR files it writes,
                 the same way with ``crash@step:4``, and with
                 ``sigterm@step:3``: exit 75 with an emergency checkpoint
                 at step 3, restarted outside the crash budget, the same
                 trajectory (BN buffers, Keras SGD momentum, cuDNN);
     recovery_measure -- save ms (state to host, payload, fsync, sha256),
                 restore ms, bytes a step, the barrier behind a save and
                 the time from the supervisor's restart to the resumed
                 process's first step.
  10. ImageNet input -- no hand kernel on this path either (decode, crop
                 and resize on the host, the mean subtraction on the
                 card through ``data/normalize.py``); it writes its own
                 shards: 8 train files of 256 and 2 validation files of
                 150 smooth 375x500 JPEGs with boxes, in the reference's
                 Example format, from ``--seed``:
     imagenet_input -- the data service's host images/s at batch 256 on
                 the uint8 wire, inline and with one spawned reader a
                 core (capped by the 8 shards), then two epochs through
                 the decode-once cache (fill, then served: hit ratio and
                 rate); the decode path (``native`` libjpeg-turbo, built
                 at first use, or ``pil``);
     train_imagenet_files / imagenet_eval -- ``cli.imagenet_main.main
                 --data_dir`` resnet50 bf16 b256, 20 steps with
                 ``--profile_steps 2,3``: step p50 and images/s beside
                 phase 7's synthetic run, the reader-lag gauge, the
                 profiled steps' device time (none fails the run); the
                 eval must count each of the 300 validation records once;
     imagenet_resume -- resnet50 under the launcher, 8 steps, sealed
                 checkpoints every 2, 4 readers uninterrupted; beside it
                 one reader a core with ``crash@step:4,reader_crash@batch:6``
                 and one restart: every step's loss equal as a float,
                 equal digests, at least one reader respawn;
     train_cifar_fp16 -- ``cli.cifar_main.main`` resnet56 fp16 b128, 40
                 steps, a static loss scale (128) and a dynamic one:
                 finite falling losses, step p50 beside phase 7's bf16.

 11. async_ps -- the async parameter server (``parallel/ps.py``, the
                 native store ``native/ps_store.cpp`` built at first use
                 without libjpeg, ``convert.py``'s wire layout):
     ps_store   -- the store must be the native one; pull and push round
                 trips over loopback at ResNet-50's 25,559,081 floats on
                 the fp32 and bf16 wires, the bytes a step moves (exactly
                 8 or 4 B a float), the bf16 bytes of the client's and
                 the store's conversions equal to the numpy rule, NaNs
                 included;
     ps_one_worker -- resnet56 b128 f32, 10 synthetic steps, an
                 in-process store and one worker, twice: losses equal as
                 floats, the final snapshots' params and velocity equal,
                 version 10; the gap to the sync ``off`` Trainer printed;
     ps_reference -- 1 store + 2 resnet50 workers at the reference's
                 per-worker batch 192 in fp32 through ``cli.launch``, 10
                 steps each, fp32 then bf16 wire: every rank exits 0,
                 version 20, the store's rank touched no card; steps/s,
                 images/s, the pull and push spans' p50 and share, wire
                 bytes, peak memory;
     ps_lm      -- transformer_tpu b8 x 2048 bf16 at ``DP_LM_LAYERS`` of
                 its 12 layers as one worker, 3 steps: one K1 and one K3
                 launch a layer and step, its parameter count;
     ps_faults  -- ``ps_drop@version:3`` (a reconnect, every step done,
                 version 8), and the store's rank SIGTERMed while it
                 serves under ``--ps_snapshot_dir`` (that job's
                 processes run beside ps_one_worker, ps_lm and
                 ps_drop; ps_reference runs alone): the launcher
                 restarts the job, the store restores its snapshot and
                 discards the old attempt's done count, and the re-run
                 workers finish at the restored version plus 40.
 12. serving as the JAX package serves by default -- prefix sharing
                 with refcounted, copy-on-write pages, eviction,
                 cancellation, the drain, /metrics and the MFU ledger, the
                 contiguous cache; transformer_tpu, random weights from
                 ``--seed``, a warm request before each burst:
     prefix_concurrency -- bench_serve.py's shared-prefix arm in bf16: a
                 128-token system prompt, 8 tails of 8 tokens, 24 new
                 tokens, 8 slots, a 25-page pool: with sharing at least
                 twice the peak concurrency, fewer pages a live sequence,
                 greedy tokens identical, K1/K4 launches as counted per
                 request and chunk (a hit's first chunk runs K4);
     prefix_ttft -- a 1024-token system prompt, 16 tails of U[1, 64], 64
                 new tokens, the full pool: TTFT p50 with and without
                 sharing (sharing lower), tokens/s, high-water lower,
                 tokens identical; the decode step's ledger MFU and HBM
                 share against the card's peaks;
     prefix_pressure -- the 25-page pool: a distinct 300-token prompt
                 evicts cached pages and completes; a request cancelled
                 mid-decode comes back cancelled, the pool back to what
                 the registry holds; begin_drain sheds the next submit;
     prefix_f32 -- in float32 (the routes agree to ~1e-6 there): a
                 4-page prompt seen twice is a COW replay with the
                 unshared engine's tokens; 8 requests through the
                 contiguous cache and the paged one, tokens equal,
                 tokens/s side by side;
     serve_cli_drain -- ``cli.serve_main`` as a process, bf16, 16
                 requests of 512 new tokens, ``--metrics_port``: the
                 serve_* and ledger_* series scraped, SIGTERM after 20
                 decode steps, /healthz 503 while it drains, every
                 request finished, exit 0, ``trace_main --ledger --json``
                 rows from its trace.
  The training phase 6 also holds the ledger's train_step MFU within 20%
  of its own formula's.
 13. fleet    -- the serving fleet: two ``cli.replica_main`` processes on
                 the card, forked with ``cli.router_main``'s replica
                 command by a pre-imported spawner (``ReplicaForkServer``,
                 ``multiprocessing``'s forkserver:
                 one process that imports torch and the replica's
                 modules, touches no CUDA and forks each replica, under
                 ``serve.router.replica_spawner``'s contract; it
                 imports while phase 12 runs), behind the
                 port's ``Router`` (affinity); transformer_tpu at 6 of
                 its 12 layers (``FLEET_LAYERS``, every width kept), random
                 weights from ``--seed``, page 16, chunk 64; 16 requests
                 of 4 families (a 256-token system prompt, a tail of
                 U[1, 128]), 32 new tokens, each consumed through its
                 stream.  colocated f32 through ``replica_kill@req:6``:
                 tokens equal one in-process ServeEngine's, each token
                 streamed once, the killed replica respawned and serving
                 cold prompts; disaggregated (``prefill_replicas=1``),
                 f32 then bf16: the family heads prefill on replica 0,
                 their chains migrate to replica 1 and the siblings
                 decode there from prefix hits (f32 tokens equal the
                 colocated run's), each chain's payload digests read
                 back equal on both replicas, the ledger's prefill-chunk
                 calls on replica 0 and decode-step calls on replica 1
                 from their ``/metrics``; tokens/s, TTFT p50, failover
                 resolve and respawn times, ms and bytes a migrated page
                 from the router's trace.  Each replica zeroes its
                 kernels' launch counts as its server starts and writes
                 them at exit (a SIGKILLed one's are lost).
 14. ha_rollout -- the fleet's HA pair and zero-downtime rollout on one
                 tier: two ``cli.replica_main`` processes on the card
                 serving export A (the port's ``export_model`` of the
                 seeded weights; B an identical re-export, C a perturbed
                 copy), phase 13's width and traffic, f32.  Routers come
                 and go in this process; a dead one is frozen in place
                 (loops stopped, connections severed, nothing resolved)
                 on its dispatching thread, which then ends.
                 A baseline burst is the oracle (equal to phase 13's
                 engine); ``router_kill@req:5`` kills the journaling
                 epoch-1 leader mid-burst and a standby takes epoch 2
                 and adopts the tier (no request lost, the dispatched
                 re-adopted and the queued re-dispatched, no replica
                 respawned, every stream exactly once and token-exact);
                 an epoch-3 force-take (its first burst reaching both
                 replicas) fences the epoch-2 router at the replicas;
                 ``lease_stall@4`` lets a standby take epoch 4
                 and fences the stalled leader.  Then, under live
                 traffic (``HA_PUMP_SHARE`` of the baseline's request
                 rate; during A->B also phase 13's cold prompts, with
                 its engine's tokens): A->B ends DONE (token-exact, no
                 mixed stream, prefix hits after), B->C ROLLED_BACK on
                 the canary's divergence, ``rollout_kill@phase:rolling``
                 and ``ckpt_truncate`` (the canary fails to load)
                 ROLLED_BACK, and a ``router_kill`` while ROLLING is
                 resumed to DONE by the standby's ``take_over``.
                 ``trace_main --check`` with each allowlist (a failed
                 migration only in the same event as the loss of an
                 endpoint, no more such losses than kills); takeover
                 times, re-adopted and
                 re-dispatched counts, each replica swap and rollout,
                 tokens/s and TTFT during A->B.  K1 and K4 counted in the
                 replica processes: the tier's first processes at the
                 end of the HA stages (a SIGUSR1 snapshot), then every
                 process at its exit.  The replicas fork from phase
                 13's spawner.
 15. zero_stages -- ZeRO (``train/zero.py``): ``cli.lm_main``,
                 transformer_tpu at full width, bf16 compute on f32
                 parameters, AdamW, S 2048, 6 steps: two ranks sharing
                 the card over gloo at stages 0-3, the four runs at
                 once: losses bit-identical, each rank's bytes in use
                 at its update (the CUDA allocator's count) falling
                 stage by stage, beside the parameter, gradient and
                 optimizer bytes of its tensors and the 16N/12N/10N/8N
                 formula, peak memory, 12 K1 and 12 K3 a step; then at
                 once: stage 3 at world 1 on NCCL against ``off`` bit
                 for bit, a stage-3 two-rank run killed by
                 ``crash@step:4`` and resumed by the launcher under
                 stage 1 from the canonical checkpoint (losses bit for
                 bit), ``--zero_wire bf16`` within 5e-2 of the fp32
                 wire, and a stage-3 two-rank run with ``--zero_probe``
                 (the step and its comm-off twin in turns: exposed
                 communication no more than the serialized collectives
                 plus the timings' spread).
 16. tensor_parallel -- ``--model_parallelism`` / ``--serve_tp``
                 (``runtime/mesh.py``'s grid, ``models/partition.py``,
                 the shard-local transformer, ``TensorParallelLM``):
                 transformer_tpu at full width, 3 of 6 heads, d_ff 1536
                 and (``--shard_lm_head``) 16384 of the vocabulary a
                 shard, its training and f32 serving runs at 6 of its
                 12 layers (``TP_LAYERS``; the bf16 burst at 12).  (a) ``cli.lm_main`` over two gloo
                 ranks sharing
                 the card (data 1 x model 2), S 2048, batch 2, AdamW:
                 f32 3 steps against the ``off`` world-1 run within
                 ``TP_LOSS_RTOL``, ``--shard_lm_head`` against the plain
                 TP run, the TP run's step-2 checkpoint resumed at mp 1
                 against its step 3; bf16 6 steps timed alone beside the
                 world-1 run (step p50, peak memory a rank, 6 K1 and 6
                 K3 a step a rank).  (b) the engine in this process at
                 ``--serve_tp 2``, both shards on the one card: f32
                 greedy, 16 requests token-exact with ``serve_tp 1``;
                 (a)'s f32 checkpoint served at 2 and 1, token-exact;
                 phase 4's bf16 burst at ``serve_tp 2``, its tokens/s,
                 TTFT p50 and decode-step p50 beside phase 4's at
                 ``serve_tp 1`` (K1 and K4 at 3 heads, two shards'
                 launches a layer).  (c) ``cli.serve_main --serve_tp 2``
                 on a one-card machine exits non-zero naming the count.
 17. elastic   -- elastic training (``train/elastic.py``, ``cli/launch.py
                 --elastic``, the ``device_loss`` fault): ``cli.lm_main``
                 transformer_tpu at ``DP_LM_LAYERS`` of its 12 layers,
                 every width kept, bf16 compute on f32 parameters, AdamW,
                 ZeRO-3, global batch ``ZERO_BATCH``, gloo ranks sharing
                 the card, ``--resume --checkpoint_steps 2``, 12 steps.
                 (a) 2 ranks under ``launch_local(elastic=True,
                 min_devices=1)`` with ``host_loss@rank1:step:4``: one
                 shrink (host_loss, 1 device), then, once step 6 is
                 sealed, ``elastic_rejoin.json`` announces 2 devices and
                 the job is drained and grown back; ``elastic_resume``
                 (4, 1) then (>= 6, 2); every step trained once; exit 0.
                 (b) the same 2-rank command with ``crash@step:4``: its
                 steps 1-4 bit-identical to (a)'s.  (c) 1 rank resumed
                 from a copy of (b)'s model dir: steps 5 to (a)'s grow
                 step bit-identical to (a)'s.  (d) ``trace_main --check
                 --allow injected_fault --allow host_loss`` clean on
                 (a)'s trace, a bare ``--check`` not.  (e)
                 ``device_loss@step:2``, 2 ranks, 6 steps: classified,
                 resumed on 1 rank, every step once, its check clean.
                 (f) ``cudaGetErrorString``'s texts on this card for the
                 device-loss statuses the classifier lists classify as
                 device loss; those of an illegal address and an
                 unspecified launch failure, and a caught out-of-memory
                 error, do not.  (b) then (c), and (e), run beside (a).
                 The line: the loss-to-first-shrunken-step and
                 announce-to-first-grown-step seconds, the step p50 at 2
                 ranks and at 1, each seal's seconds, the checkpoint
                 bytes a step; K1 and K3 one a layer and step in the
                 grown attempt's rank and the device arm's resumed one.
 18. sequence_parallel -- ``--seq_parallelism`` (``runtime/mesh.py``'s
                 seq axis, ``parallel/ring_attention.py``,
                 ``parallel/collectives.py ring_shift``):
                 ``cli.lm_main`` over two gloo ranks sharing the card
                 (data 1 x seq 2 x model 1), transformer_tpu at full
                 width and 6 of its 12 layers (``SP_LAYERS``), S 2048
                 (1024 a rank), global batch 2,
                 AdamW; every attention is ring attention over the two
                 ranks (plain torch, f32 carry), K and V and their
                 cotangents rotating through pinned host buffers.  (a)
                 f32 3 steps against the ``off`` world-1 twin within
                 ``SP_LOSS_RTOL``; (b) bf16 6 steps timed alone beside
                 the world-1 run: step p50, peak memory a rank, the
                 ring's calls and bytes a step equal to
                 ``sp_ring_prediction`` (2 tensors x (2 forward + 1
                 backward) rotations x 6 layers), K1 = K2a = K2b = K3
                 = 0 on each seq rank, the two ranks' losses bit-equal.
 19. pipeline_parallel -- ``--model_parallelism`` with the pipeline
                 family (``parallel/pipeline.py``,
                 ``models/pipeline_lm.py``): ``cli.lm_main`` over two
                 gloo ranks sharing the card (data 1 x model 2: the two
                 stages), pipeline_transformer at full width and 8 of
                 its 12 layers (``PP_LAYERS``: 4 a stage, 8 heads of
                 64), S 2048, global
                 batch 8, the auto M = 8 (one sequence a microbatch),
                 AdamW; the activations and their cotangents shift
                 through pinned host buffers, the last stage's output is
                 broadcast by a masked all-reduce.  (a) f32 3 steps
                 against the ``off`` world-1 twin within
                 ``PP_LOSS_RTOL``; (b) bf16 6 steps, GPipe and
                 ``--pipeline_interleave 2``, each timed alone beside
                 the world-1 run: step p50, peak memory a stage, the
                 shifts' calls and bytes, the broadcast and K1 and K3 a
                 step equal to ``pp_prediction`` (GPipe 17 shifts, K1 =
                 K3 = 36; interleaved 33 and 34), K2a = K2b = 0, the
                 stages' losses bit-equal.  The stages share the SMs:
                 the step time says nothing of the bubble.
 20. expert_parallel -- the moe_transformer family (``models/moe.py``,
                 ``parallel/collectives.py all_to_all``, the Trainer's
                 expert leaves): ``cli.lm_main`` over two gloo ranks
                 sharing the card, moe_transformer at full width and
                 6 of its 12 layers (``EP_LAYERS``: 8 experts of d_ff
                 2048 in every second block, top-2, capacity factor
                 1.25, 8 heads of 64), S 2048, AdamW.  (a) f32 3 steps, experts over the
                 data axis (data 2, global batch 4: two sequences a
                 rank, the slot rows exchanged by two all_to_all a MoE
                 block each way), both ranks against the world-1 twin
                 at batch 2 in this process (the synthetic stream gives
                 each rank a copy of one batch) within
                 ``EP_LOSS_RTOL``; (b) f32 3 steps, experts over the
                 model axis (``--model_parallelism 2``, data 1, batch
                 2: no exchange, the partial outputs summed) against
                 the same twin; (c) bf16 6 steps over data, timed alone
                 beside the bf16 twin: step p50, peak memory a rank,
                 the share of routed choices dropped, the exchanges a
                 step equal to ``ep_prediction`` (12 calls, 125,829,120
                 bytes; f32 251,658,240; 0 under the model axis), K1 =
                 K3 = 6 and K2a = K2b = 0 a step a rank, the replicated
                 leaves' digests equal across the ranks; (d) one
                 MoEMLP forward and backward at a rank's shape
                 ([2, 2048, 512] bf16) twice on the card, every output
                 and gradient bit for bit.
 21. planner  -- the parallelism planners (``dtf_tpu_torch/plan``,
                 ``cli/plan_main.py``, ``cli/plan_serve_main.py``): the
                 live mesh on the card (hosts x devices, memory a rank,
                 FLOP/s, the bandwidths marked data sheet and
                 uncalibrated); ``calibrate_device_flops`` on ``cuda``
                 (transformer_small f32, batch 2, S 64: K1 and K3 on
                 their f32 routes); transformer_tpu (bf16, S 2048,
                 AdamW, global batch 256) ranked on ``h100x8`` and
                 ``4xh100x8``, the milliseconds and the top plans;
                 ``lm_main --plan auto`` at full width (bf16, S 2048,
                 batch 8, world 1, 3 steps) against its twin with the
                 plan's flags set by hand: losses and state digest bit
                 for bit; two gloo ranks training from a plan file that
                 names phase 15's ZeRO-3 arm (data 2, zero 3) against
                 that arm's losses and digests, bit for bit;
                 ``plan_main --calibrate`` at the JAX contract's shape
                 (transformer_small, S 64, batch 4, AdamW): the
                 step-time ratio in [0.5, 2] and predicted peak over
                 live bytes in [1, 4]; the same at full width
                 (transformer_tpu bf16 S 2048 batch 8) with
                 ``--calibrate_probe run`` (the probe at the run's own
                 model, shapes and dtype), its ratio printed beside the
                 one the small probe's rate gives, neither gated;
                 ``plan_serve_main --calibrate`` (its defaults:
                 transformer_small bf16, 12 requests of 24 tokens, 4
                 slots): tokens/s and p99 ratios in [0.5, 2]; and
                 ``--measure_tp_comm`` (``serve_tp`` 2, both shards on
                 the card): its ``tp_comm_frac``.
  Phase 6 also trains the ``train`` run with ``--remat_policy dots`` and
  with ``--remat`` (12, 12 and 24 K1 a step; losses within 5e-3 of
  none's; --remat's peak memory below none's); phase 7 trains ResNet-50
  with ``--remat`` beside the plain run.  The host's speed is probed
  first (a Python loop, a numpy sort, and a bare ``import torch`` in a
  child beside the kernels' build) and printed beside every
  ``phase_time`` line.

Then the ``{"kernels": [...]}`` line -- each kernel's main case (every
case is on its own phase-2 line), its design and its launches from the
run of its path: K1 and K3 phase 6 (and, as ``launches_dp``, phase 8's
data-parallel LM run; as ``launches_recovery``, phase 9's resumed
process; as ``launches_async``, phase 11's async worker), K2a and K2b
phase 6's companion, the f32 routes phase 5's f32 AdamW steps, K4
serving (and, as ``launches_recovery_serve``, with K1,
serving phase 9's checkpoint; as ``launches_prefix``, with K1, phase
12's bursts with and without sharing; as ``launches_fleet``, with K1,
phase 13's replica processes; as ``launches_ha`` and
``launches_rollout``, with K1, phase 14's); K1 and K3 also as
``launches_remat`` (phase 6's arms) and ``launches_zero`` (phase 15's
rank 0 of stage 0); K1, K3 and K4 as ``launches_tp`` (phase 16: rank 0
of the bf16 TP run, and the bf16 ``serve_tp 2`` engine's two shards),
with ``tp_case``, phase 2's case at the shard's shape; K1 and K3 as
``launches_elastic`` (phase 17: rank 0 of the grown attempt); K1, K2a,
K2b and K3 as ``launches_sp`` (phase 18: both seq ranks, 0 each: the
attention rides the ring) beside ``launches_sp_twin`` (the world-1
twin's); K1, K2a, K2b and K3 as ``launches_pp`` and
``launches_pp_interleave`` (phase 19: both stages, GPipe and
interleaved) beside ``launches_pp_twin``, K1 and K3 with ``pp_case``,
phase 2's case at the stage's shape; K1 and K3 as ``launches_ep``
(phase 20: both ranks of the bf16 data-axis run) beside
``launches_ep_twin``, with ``ep_case``, phase 2's case at the rank's
shape; K1 and K3 as ``launches_plan`` (phase 21: the FLOP/s probe, the
``--plan auto`` run and the calibration runs, by run) and K1 and K4 as
``launches_plan_serve`` (phase 21's serving calibration) -- and, last,
the device line.
Any failure raises: the script exits non-zero and prints no result.
Without CUDA, or without the ``dtf_tpu_torch`` package beside it, it
exits 2 before doing anything.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
# f32-accurate work on the tensor cores: 495 TFLOP/s of TF32 over the
# three products of a split product; bf16 dense tensor cores
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
CUDA_CORE_F32_FLOPS = 67e12          # f32 FMA on the CUDA cores
L2_BYTES = 50e6
TRAIN_SHAPE = (8, 2048, 6, 128)      # transformer_tpu at batch 8
# a tensor-parallel rank's attention: transformer_tpu's 6 heads over
# model_parallelism 2, at phase 16's batch 2
TP_SHAPE = (2, 2048, 3, 128)
# a pipeline stage's attention: pipeline_transformer (8 heads of 64) at
# one sequence a microbatch, S 2048
PP_SHAPE = (1, 2048, 8, 64)
# moe_transformer's attention on a rank of phase 20 (two sequences a
# rank, 8 heads of 64)
EP_SHAPE = (2, 2048, 8, 64)


def emit(obj) -> None:
    # the process's own stdout: a line emitted on a thread while the
    # main thread runs under ``quiet`` still reaches it
    print(json.dumps(obj), file=sys.__stdout__, flush=True)


def overlapped(fn, *args, **kw):
    """``fn(*args, **kw)`` on a thread of its own, started now; the
    returned future's ``result()`` waits for it and raises what it
    raised.  For a run whose gates are its own and whose times no gate
    or headline reads beside the run it overlaps (a baseline only its
    faulted twin is compared with, a CPU reference, a fault case)."""
    import concurrent.futures
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        return pool.submit(fn, *args, **kw)
    finally:
        pool.shutdown(wait=False)


def gathered(futures):
    """Every future's result, in order, once all have ended (a failure
    is raised only after the others have finished, so no run outlives
    the phase that started it)."""
    import concurrent.futures
    concurrent.futures.wait(futures)
    return [f.result() for f in futures]


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    return 2


class Timer:
    """Device time of a call, from CUDA events.

    A sleep kernel first holds the card while the host queues the timed
    launches, so the events bracket back-to-back device work, not the
    host's Python between launches.  Each launch takes the next of
    ``copies`` input sets, so a working set smaller than the L2 is not
    served from it.  The median of ``trials`` trials, or of three where
    every one of the first three took 10 ms a call or more (a plain
    version: tens of milliseconds, steady from trial to trial)."""

    def __init__(self, torch):
        self.torch = torch
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        torch.cuda._sleep(10**7)
        e.record()
        e.synchronize()
        self.cycles_per_s = 1e7 / (s.elapsed_time(e) / 1e3)

    def ms(self, fn, copies, trials: int = 5) -> float:
        torch = self.torch
        for c in copies[:2]:
            fn(*c)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(*copies[0])
        host = time.perf_counter() - t
        torch.cuda.synchronize()
        reps = max(len(copies), min(50, max(3, int(0.05 / host))))
        sleep = int(min(1.5 * host * reps, 0.25) * self.cycles_per_s)
        out = []
        for _ in range(trials):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(sleep)
            s.record()
            for i in range(reps):
                fn(*copies[i % len(copies)])
            e.record()
            e.synchronize()
            out.append(s.elapsed_time(e) / reps)
            if len(out) == 3 and min(out) >= 10.0:
                break
        return statistics.median(out)


def host_probe():
    """The host's speed, measured once at the start, so that phase times
    of runs on different hosts can be compared: a fixed pure-Python loop
    (5,000,000 additions), a numpy sort of 4,000,000 float64 values from
    a fixed seed, and a bare ``import torch`` in a child process (with
    this run's bytecode cache, as every process the script starts: the
    child writes it).  The child starts here and runs beside the
    kernels' build; the returned function waits for it and gives the
    three readings."""
    import numpy as np
    t = time.perf_counter()
    acc = 0
    for i in range(5_000_000):
        acc += i
    loop_s = time.perf_counter() - t
    values = np.random.default_rng(0).random(4_000_000)
    t = time.perf_counter()
    np.sort(values)
    sort_s = time.perf_counter() - t
    t = time.perf_counter()
    child = subprocess.Popen([sys.executable, "-c", "import torch"])
    ended = overlapped(lambda: (child.wait(timeout=300),
                                time.perf_counter() - t))

    def readings() -> dict:
        rc, import_s = ended.result()
        if rc:
            raise RuntimeError(f"import torch: exit {rc}")
        return {"py_loop_s": loop_s, "np_sort_s": sort_s,
                "import_torch_s": import_s}

    return readings


def card_clocks() -> dict:
    """The card's SM clock (and its maximum), temperature and power draw
    now, as ``nvidia-smi`` reads them: a slow phase on a throttled card
    shows here, not in the host probe."""
    keys = ("clocks.sm", "clocks.max.sm", "temperature.gpu", "power.draw")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=" + ",".join(keys),
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.splitlines()[0]
    def value(v: str):
        try:
            return float(v)
        except ValueError:       # "[N/A]" where the card does not say
            return v.strip()

    return dict(zip(keys, map(value, out.split(","))))


class PhaseClock:
    """Seconds each phase took, one ``phase_time`` line as it ends (with
    the host probe and the card's clocks beside it): the script's time
    limit is shared by every phase."""

    def __init__(self, host: dict):
        self.t = time.perf_counter()
        self.host = host

    def done(self, phase: str) -> None:
        now = time.perf_counter()
        emit({"phase": "phase_time", "of": phase, "s": now - self.t,
              "host": self.host, "card": card_clocks()})
        self.t = now


def rotated(tensors, nbytes: int):
    """Enough copies of ``tensors`` that cycling through them touches
    three times the L2."""
    n = min(16, max(2, math.ceil(3 * L2_BYTES / max(nbytes, 1))))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(n - 1)]


def compare(torch, out, ref, floor: float = 0.0):
    """Kernel output against its plain version, row by row (a row is one
    query and head: the last dim).  float32: 1e-5.  bfloat16: o is
    rounded to 8 significant bits, and the kernel and the plain version
    add their f32 terms in different orders, so a value may round one
    bf16 step apart: each row within two bf16 steps at the larger of its
    own largest |ref| and ``floor``, 2^(e - 6) for that maximum in
    [2^e, 2^(e+1)).

    Returns (max abs error, the tolerance of the row nearest its limit,
    that row's error over its tolerance)."""
    ref = ref.float()
    err = (out.float() - ref).abs().amax(-1)
    if out.dtype == torch.float32:
        tol = torch.full_like(err, 1e-5)
    else:
        top = ref.abs().amax(-1).clamp_min(max(floor, 2.0 ** -126))
        tol = torch.ldexp(torch.ones_like(top),
                          torch.frexp(top).exponent - 7)
    ratio = (err / tol).flatten()
    worst = int(ratio.argmax())
    return (float(err.max()), float(tol.flatten()[worst]),
            float(ratio[worst]))


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def bounds(flops: float, nbytes: float, dtype: str):
    """``bound_ms`` and ``bound_by`` at the dtype's tensor-core peak;
    for float32 also ``bound_cuda_core_ms``, the same work at the CUDA
    cores' f32 rate."""
    ms, by = bound(flops, nbytes, dtype)
    out = {"bound_ms": ms, "bound_by": by}
    if dtype == "float32":
        out["bound_cuda_core_ms"] = max(flops / CUDA_CORE_F32_FLOPS,
                                        nbytes / HBM_BYTES_PER_S) * 1e3
    return out


# the routes of K1, K2a, K2b and K3 inside their C entry points
# (csrc/flash_fwd.cu, csrc/flash_bwd.cu, csrc/flash_bwd_fused.cu), by
# dtype: the same for all four
SPLIT_TF32 = "3xtf32 mma.sync+cp.async"


def route(dtype: str) -> str:
    return "wgmma+cp.async" if dtype == "bfloat16" else SPLIT_TF32


def check_flash(torch, timer, gen):
    """K1 against its plain version: [1, 64, 6, 128] (a first prefill
    chunk), [2, 200, 6, 128] (ragged against any tile), [2, 256, 8, 64]
    (D 64), [1, 2048, 6, 128] (a whole-context chunk) and the training
    shape [8, 2048, 6, 128], causal and full, float32 (split TF32
    products) and bfloat16 (wgmma)."""
    import torch.nn.functional as F

    from dtf_tpu_torch.ops import flash_attention as fa

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for shape in ((1, 64, 6, 128), (2, 200, 6, 128), (2, 256, 8, 64),
                      (1, 2048, 6, 128), TRAIN_SHAPE):
            b, s, h, d = shape
            for causal in (True, False):
                q, k, v = (torch.randn(shape, generator=gen).to("cuda", dtype)
                           for _ in range(3))
                scale = d ** -0.5
                o, lse = fa.flash_forward(q, k, v, causal=causal)
                po, plse = fa.flash_forward_plain(q, k, v, causal=causal,
                                                  scale=scale)
                torch.cuda.synchronize()
                err, tol, ratio = compare(torch, o, po)
                lse_err = float((lse - plse).abs().max())
                lse_tol = 1e-5 * max(1.0, float(plse.abs().max()))
                if not (ratio <= 1.0 and lse_err <= lse_tol):
                    raise AssertionError(
                        f"K1 {dname} {shape} causal={causal}: o err {err}, "
                        f"worst row at {ratio} of its tol {tol}; lse err "
                        f"{lse_err} (tol {lse_tol})")
                elem = q.element_size()
                nbytes = 4 * q.numel() * elem + lse.numel() * 4
                pairs = s * (s + 1) / 2 if causal else s * s
                copies = rotated((q, k, v), 3 * q.numel() * elem)
                tq = [tuple(t.transpose(1, 2).contiguous() for t in c)
                      for c in copies]
                cases.append({
                    "shape": list(shape), "causal": causal, "dtype": dname,
                    "design": route(dname),
                    "max_abs_err": err, "tol": tol, "err_over_tol": ratio,
                    "lse_err": lse_err,
                    "lse_tol": lse_tol,
                    "ms": timer.ms(lambda q_, k_, v_: fa.flash_forward(
                        q_, k_, v_, causal=causal), copies),
                    "plain_ms": timer.ms(
                        lambda q_, k_, v_: fa.flash_forward_plain(
                            q_, k_, v_, causal=causal, scale=scale), copies),
                    "library_ms": timer.ms(
                        lambda q_, k_, v_: F.scaled_dot_product_attention(
                            q_, k_, v_, is_causal=causal), tq),
                    **bounds(4 * b * h * d * pairs, nbytes, dname)})
                emit({"phase": "kernels", "kernel": "K1", **cases[-1]})
    return cases


def grad_tolerance(torch, out, ref):
    """Backward kernel output against its plain version: float32 within
    1e-5 absolute, scaled by the output's largest |ref| where that
    exceeds 1 (dk and dv sum up to S terms); bfloat16 by the per-row rule
    of :func:`compare` with a floor of 2^-8 of the output's largest
    |ref|: a row whose exact value is zero -- causal dq's first row,
    where dS = p (dp - delta) and dp = delta -- comes out as f32 rounding
    noise whose size follows the order of the sums, and is held to the
    tolerance of a row at that floor (2^-14 of the largest |ref|).
    Returns (max abs error, tolerance of the worst row, its error over
    its tolerance)."""
    if out.dtype == torch.float32:
        err = float((out.float() - ref.float()).abs().max())
        tol = 1e-5 * max(1.0, float(ref.float().abs().max()))
        return err, tol, err / tol
    return compare(torch, out, ref,
                   floor=2.0 ** -8 * float(ref.float().abs().max()))


def check_backward(torch, timer, gen):
    """K2a, K2b and K3 against their plain versions on the same inputs:
    [2, 200, 6, 128] (ragged against any tile), [1, 2048, 6, 128] and
    [2, 256, 8, 64], causal and full, float32 (split TF32 products)
    and bfloat16 (wgmma); K3 against K2a + K2b in float32;
    each kernel twice gives the same bits in both.  Then each at the
    training shape, causal, in both dtypes: kernel, plain and library
    times and bounds, the library yardstick being the backward of
    F.scaled_dot_product_attention (autograd.grad of its output), and the
    device time of K3's two passes.  Last, K2a and K2b at cross lengths
    -- Sq 200 / Sk 320 and Sq 320 / Sk 200 at D 128, Sq 64 / Sk 256 at
    D 64, causal and full, both dtypes, twice bit for bit."""
    import torch.nn.functional as F

    from dtf_tpu_torch.ops import _build
    from dtf_tpu_torch.ops import flash_attention as fa

    def inputs(shape, dtype, causal, sk=None):
        b, s, h, d = shape
        kv = (b, s if sk is None else sk, h, d)
        q, k, v, do = (torch.randn(x, generator=gen).to("cuda", dtype)
                       for x in (shape, kv, kv, shape))
        o, lse = fa.flash_forward(q, k, v, causal=causal)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(
            b * h, s).contiguous()
        return q, k, v, do, o, lse, delta

    def held(row, kname, outs, refs):
        res = [grad_tolerance(torch, o_, r_) for o_, r_ in zip(outs, refs)]
        worst = max(res, key=lambda x: x[2])
        row[kname] = {"max_abs_err": max(x[0] for x in res),
                      "tol": worst[1], "err_over_tol": worst[2]}
        if not worst[2] <= 1.0:
            raise AssertionError(f"{kname}: {row}")

    def same_bits(row, kname, first, again):
        row[f"{kname}_bit_identical"] = all(
            torch.equal(a, b_) for a, b_ in zip(first, again))
        if not row[f"{kname}_bit_identical"]:
            raise AssertionError(f"{kname} not deterministic: {row}")

    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for shape in ((2, 200, 6, 128), (1, 2048, 6, 128), (2, 256, 8, 64)):
            for causal in (True, False):
                q, k, v, do, o, lse, delta = inputs(shape, dtype, causal)
                args = (q, k, v, do, lse, delta)
                kw = dict(causal=causal, scale=shape[-1] ** -0.5)
                outs = {"K2a": (fa.flash_bwd_dq(*args, **kw),),
                        "K2b": fa.flash_bwd_dkdv(*args, **kw),
                        "K3": fa.flash_bwd_fused(*args, **kw)}
                again = {"K2a": (fa.flash_bwd_dq(*args, **kw),),
                         "K2b": fa.flash_bwd_dkdv(*args, **kw),
                         "K3": fa.flash_bwd_fused(*args, **kw)}
                plain = fa.flash_bwd_fused_plain(*args, **kw)
                torch.cuda.synchronize()
                row = {"shape": list(shape), "causal": causal,
                       "dtype": dname,
                       "design": {n: route(dname)
                                  for n in ("K2a", "K2b", "K3")}}
                refs = {"K2a": plain[:1], "K2b": plain[1:], "K3": plain}
                for kname in ("K2a", "K2b", "K3"):
                    held(row, kname, outs[kname], refs[kname])
                if dtype == torch.float32:
                    split_gap = max(
                        grad_tolerance(torch, a, b_)[2]
                        for a, b_ in zip(outs["K3"],
                                         outs["K2a"] + outs["K2b"]))
                    row["K3_vs_split_err_over_tol"] = split_gap
                    if not split_gap <= 1.0:
                        raise AssertionError(f"K3 != K2a + K2b: {row}")
                for kname in ("K2a", "K2b", "K3"):
                    same_bits(row, kname, outs[kname], again[kname])
                checks.append(row)
                emit({"phase": "backward", **row})
                del q, k, v, do, o, lse, delta, args, outs, again, plain

    # times at the training shape, causal: the three kernels on both
    # routes
    b, s, h, d = TRAIN_SHAPE
    kw = dict(causal=True, scale=d ** -0.5)
    pairs = b * h * s * (s + 1) / 2
    rows = b * h * s * 8                 # lse and delta, f32
    kernel = {"K2a": fa.flash_bwd_dq, "K2b": fa.flash_bwd_dkdv,
              "K3": fa.flash_bwd_fused}
    plain = {"K2a": fa.flash_bwd_dq_plain, "K2b": fa.flash_bwd_dkdv_plain,
             "K3": fa.flash_bwd_fused_plain}
    # the profiler's names of K3's two passes on each route
    passes = {"bfloat16": ("bwd_fused_tc_kernel", "dq_reduce_tc_kernel"),
              "float32": ("bwd_fused_x3_kernel", "dq_reduce_x3_kernel")}
    timings = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        q, k, v, do, o, lse, delta = inputs(TRAIN_SHAPE, dtype, True)
        args = (q, k, v, do, lse, delta)
        elem = q.element_size()
        copies = rotated(args, 4 * q.numel() * elem)
        qkvo = q.numel() * elem
        # tile products per (query, key) pair: S and dP, then dq (K2a),
        # dk and dv (K2b), all three (K3); 2 D operations each
        work = {"K2a": (3, 4 * qkvo + rows + qkvo),
                "K2b": (4, 4 * qkvo + rows + 2 * qkvo),
                "K3": (5, 4 * qkvo + rows + 3 * qkvo)}
        qt, kt, vt, dot = (t.transpose(1, 2).contiguous().requires_grad_()
                           for t in (q, k, v, do))
        ref_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        library_ms = timer.ms(
            lambda: torch.autograd.grad(ref_o, (qt, kt, vt), dot,
                                        retain_graph=True), [()])
        ref = fa.flash_bwd_fused_plain(*args, **kw)
        refs = {"K2a": ref[:1], "K2b": ref[1:], "K3": ref}
        for name in ("K2a", "K2b", "K3"):
            key = name if dtype == torch.bfloat16 else f"{name} {dname}"
            outs = kernel[name](*args, **kw)
            outs = outs if isinstance(outs, tuple) else (outs,)
            torch.cuda.synchronize()
            res = [grad_tolerance(torch, o_, r_)
                   for o_, r_ in zip(outs, refs[name])]
            del outs
            worst = max(res, key=lambda x: x[2])
            if not worst[2] <= 1.0:
                raise AssertionError(f"{key} at the training shape: {res}")
            products, nbytes = work[name]
            timings[key] = {
                "max_abs_err": max(x[0] for x in res), "tol": worst[1],
                "err_over_tol": worst[2], "shape": list(TRAIN_SHAPE),
                "causal": True, "dtype": dname,
                "design": route(dname),
                "ms": timer.ms(lambda *a, f=kernel[name]: f(*a, **kw),
                               copies),
                "plain_ms": timer.ms(lambda *a, f=plain[name]: f(*a, **kw),
                                     copies[:1]),
                "library_ms": library_ms,
                **bounds(2 * d * products * pairs, nbytes, dname)}
            if name == "K3":
                timings[key]["partial_bytes"] = fa.fused_partial_bytes(q, k)
                # the C side's count agrees with the wrapper's allocation
                c_floats = _build.load("flash_bwd_fused_partial_floats")
                for sk in (s, 200):
                    want = fa.fused_partial_floats(b, h, s, sk, d, dtype)
                    got = c_floats(b, h, s, sk, d, fa.KERNEL_DTYPES[dtype])
                    if got != want:
                        raise AssertionError(f"K3 {dname} partial floats: C "
                                             f"{got}, wrapper {want}")
                timings[key]["passes_ms"] = profile_passes(
                    torch, fa, args, kw, passes[dname])
            emit({"phase": "backward_time", "kernel": key, **timings[key]})
        del q, k, v, do, o, lse, delta, args, copies, qt, kt, vt, dot, \
            ref_o, ref, refs
        torch.cuda.empty_cache()

    # cross-length attention, the split pair's own case under the auto
    # rule: positions count from 0 for queries and keys alike
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for sq, sk, h, d in ((200, 320, 6, 128), (320, 200, 6, 128),
                             (64, 256, 8, 64)):
            for causal in (True, False):
                q, k, v, do, o, lse, delta = inputs((2, sq, h, d), dtype,
                                                    causal, sk)
                args = (q, k, v, do, lse, delta)
                kw = dict(causal=causal, scale=d ** -0.5)
                outs = {"K2a": (fa.flash_bwd_dq(*args, **kw),),
                        "K2b": fa.flash_bwd_dkdv(*args, **kw)}
                again = {"K2a": (fa.flash_bwd_dq(*args, **kw),),
                         "K2b": fa.flash_bwd_dkdv(*args, **kw)}
                plain = fa.flash_bwd_fused_plain(*args, **kw)
                torch.cuda.synchronize()
                row = {"shape": [2, sq, h, d], "sk": sk, "causal": causal,
                       "dtype": dname,
                       "design": {n: route(dname) for n in ("K2a", "K2b")}}
                held(row, "K2a", outs["K2a"], plain[:1])
                held(row, "K2b", outs["K2b"], plain[1:])
                for kname in ("K2a", "K2b"):
                    same_bits(row, kname, outs[kname], again[kname])
                checks.append(row)
                emit({"phase": "backward_cross", **row})
                del q, k, v, do, o, lse, delta, args, outs, again, plain

    return checks, timings


def check_peaked(torch, gen):
    """Peaked attention in float32: q scaled by 4 at [1, 2048, 6, 128],
    causal and full, where a row's weight falls on a few keys and |o|
    nears the largest |v|.  There the f32 gates are a few ulps of the
    outputs, close to the plain version's own rounding, so the reference
    is the plain versions run on float64 copies of the same inputs: each
    kernel's error against it and, beside it, the float32 plain
    version's.  A kernel fails where it is further from float64 than
    its f32 gate allows (o 1e-5; lse 1e-5 of max(1, max |lse|); each
    gradient 1e-5 of max(1, its max |ref|)); the plain version's error
    is reported, not gated.  The backward's inputs are the kernel
    forward's residuals, so each backward kernel is held to the exact
    function of what it was given."""
    from dtf_tpu_torch.ops import flash_attention as fa

    def gap64(outs, refs, tol=None):
        """(max abs error, the worst error over its tolerance)."""
        res = []
        for out, ref in zip(outs, refs):
            err = float((out.double() - ref).abs().max())
            t = tol if tol is not None else 1e-5 * max(
                1.0, float(ref.abs().max()))
            res.append((err, err / t))
        return max(e for e, _ in res), max(r for _, r in res)

    shape = (1, 2048, 6, 128)
    b, s, h, d = shape
    for causal in (True, False):
        q, k, v, do = (torch.randn(shape, generator=gen).to("cuda")
                       for _ in range(4))
        q = q * 4
        kw = dict(causal=causal, scale=d ** -0.5)
        o, lse = fa.flash_forward(q, k, v, causal=causal)
        delta = (do * o).sum(-1).transpose(1, 2).reshape(b * h,
                                                         s).contiguous()
        args = (q, k, v, do, lse, delta)
        grads = {"K2a": (fa.flash_bwd_dq(*args, **kw),),
                 "K2b": fa.flash_bwd_dkdv(*args, **kw),
                 "K3": fa.flash_bwd_fused(*args, **kw)}
        po, plse = fa.flash_forward_plain(q, k, v, **kw)
        plain = fa.flash_bwd_fused_plain(*args, **kw)
        o64, lse64 = fa.flash_forward_plain(
            *(x.double() for x in (q, k, v)), **kw)
        ref = fa.flash_bwd_fused_plain(*(x.double() for x in args), **kw)
        torch.cuda.synchronize()
        lse_tol = 1e-5 * max(1.0, float(lse64.abs().max()))
        row = {"shape": list(shape), "causal": causal, "q_scale": 4,
               "dtype": "float32", "design": route("float32")}
        # name: (kernel outputs, plain f32 outputs, float64 reference,
        # tolerance -- None: the scaled gradient gate)
        held = {"K1": ([o], [po], [o64], 1e-5),
                "K1 lse": ([lse], [plse], [lse64], lse_tol),
                "K2a": (grads["K2a"], plain[:1], ref[:1], None),
                "K2b": (grads["K2b"], plain[1:], ref[1:], None),
                "K3": (grads["K3"], plain, ref, None)}
        for name, (outs, pls, refs, tol) in held.items():
            err, ratio = gap64(outs, refs, tol)
            perr, pratio = gap64(pls, refs, tol)
            row[name] = {"max_abs_err": err, "err_over_tol": ratio,
                         "plain_max_abs_err": perr,
                         "plain_err_over_tol": pratio}
        emit({"phase": "peaked", **row})
        bad = [n for n in held if not row[n]["err_over_tol"] <= 1.0]
        if bad:
            raise AssertionError(f"{bad} further from float64 than the f32 "
                                 f"gate at q x 4: {row}")
        del q, k, v, do, o, lse, delta, args, grads, plain, ref, o64, held


def profile_passes(torch, fa, args, kw, names):
    """Device time a launch of K3's two passes (the key-block walk and
    the dq reduce, the kernels ``names``) from torch.profiler, over the
    launches the profiler recorded (it may drop some); raises where the
    profiler sees no device time for either."""
    from torch.profiler import ProfilerActivity, profile
    fa.flash_bwd_fused(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fa.flash_bwd_fused(*args, **kw)
        torch.cuda.synchronize()
    total, count = {}, {}
    for ev in prof.key_averages():
        for tag in names:
            if tag in ev.key:
                dev_us = getattr(ev, "device_time_total",
                                 getattr(ev, "cuda_time_total", 0.0))
                total[tag] = total.get(tag, 0.0) + dev_us / 1e3
                count[tag] = count.get(tag, 0) + ev.count
    out = {tag: total[tag] / count[tag] for tag in total if count[tag]}
    if not all(out.get(tag, 0.0) > 0 for tag in names):
        raise RuntimeError(f"profiler saw no device time for K3's passes "
                           f"{names}: {out}")
    return out


# K4's routes inside its C entry point (csrc/paged_decode.cu), by S and
# dtype: S below CHUNK_MIN_S there (16) decodes on CUDA cores, chunks run
# on the tensor cores; every route is a split pass and a combine
K4_CHUNK_MIN_S = 16


def k4_route(dtype: str, s: int) -> str:
    if s < K4_CHUNK_MIN_S:
        return "split-kv cuda-core cp.async"
    return ("split-kv wgmma cp.async" if dtype == "bfloat16"
            else "split-kv 3xtf32 mma.sync cp.async")


def paged_oracle64(torch, pa, q, pool_k, pool_v, table, index):
    """K4's function in float64: the gather, the positional mask, a dense
    softmax."""
    s, d = q.shape[1], q.shape[-1]
    k = pa.gather_pages(pool_k, table).double()
    v = pa.gather_pages(pool_v, table).double()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.double(), k) * d ** -0.5
    jpos = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    qpos = (index.long()[:, None, None, None]
            + torch.arange(s, device=q.device)[None, None, :, None])
    scores = torch.where(jpos <= qpos, scores,
                         torch.full_like(scores, -1e300))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)


# K4's keys per split, swept on the main cases (the constant,
# ops/paged_attention.py KEYS_PER_SPLIT, is one of them)
K4_SPLIT_SWEEP = (64, 128, 256, 512)


def sweep_splits(pa, timer, copies):
    """K4's time at each keys-per-split of the sweep, the constant put
    back after."""
    chosen = pa.KEYS_PER_SPLIT
    out = {}
    try:
        for kps in K4_SPLIT_SWEEP:
            pa.KEYS_PER_SPLIT = kps
            out[kps] = timer.ms(pa.paged_flash_decode, copies)
    finally:
        pa.KEYS_PER_SPLIT = chosen
    return out


def check_paged(torch, timer, gen):
    """K4 against its plain version: a decode step [8, 1, 6, 128] over
    rows holding {1, 15, 16, 17, 1000, 2047} tokens plus two idle rows
    (all-zero tables), the same at D 64, continuation chunks
    [1, 64, 6, 128] at start 0, 64 and 1984 and [1, 16, 6, 128] at 1984;
    pools of 1025 pages of 16, 128 pages a row -- the serving engine's
    layout at max_batch 8.  float32 and bfloat16; each case run twice
    bit for bit; the decode and the chunk at 1984 also timed at each
    keys per split of K4_SPLIT_SWEEP.  Then the f32 chunk route at peaked
    attention (q x 4,
    start 1984) against K4's function in float64, within the f32 gate;
    the plain version's distance beside it."""
    from dtf_tpu_torch.ops import paged_attention as pa

    pages, page, m, h = 1025, 16, 128, 6
    lengths = [1, 15, 16, 17, 1000, 2047, 0, 0]
    table = torch.zeros(len(lengths), m, dtype=torch.int32)
    perm = torch.randperm(pages - 1, generator=gen) + 1
    used = 0
    for row, n_tok in enumerate(lengths):
        n = -(-n_tok // page)
        table[row, :n] = perm[used:used + n]
        used += n
    index = torch.tensor([max(n - 1, 0) for n in lengths], dtype=torch.int32)
    full_row = table[5:6].clone()            # 128 pages: 2048 positions
    # (name, table, index, S, D)
    setups = [("decode", table, index, 1, 128),
              ("decode d64", table, index, 1, 64)]
    for start in (0, 64, 1984):
        setups.append((f"chunk@{start}", full_row,
                       torch.tensor([start], dtype=torch.int32), 64, 128))
    setups.append(("chunk16@1984", full_row,
                   torch.tensor([1984], dtype=torch.int32), 16, 128))

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        pools = {d: tuple(torch.randn(pages, page, h, d,
                                      generator=gen).to("cuda", dtype)
                          for _ in range(2)) for d in (64, 128)}
        for name, tab, idx, s, d in setups:
            pool_k, pool_v = pools[d]
            elem = pool_k.element_size()
            tab_c, idx_c = tab.cuda(), idx.cuda()
            q = torch.randn(tab.shape[0], s, h, d,
                            generator=gen).to("cuda", dtype)
            o = pa.paged_flash_decode(q, pool_k, pool_v, tab_c, idx_c)
            again = pa.paged_flash_decode(q, pool_k, pool_v, tab_c, idx_c)
            po = pa.paged_flash_decode_reference(q, pool_k, pool_v, tab_c,
                                                 idx_c)
            torch.cuda.synchronize()
            err, tol, ratio = compare(torch, o, po)
            same = torch.equal(o, again)
            if not (ratio <= 1.0 and same):
                raise AssertionError(f"K4 {dname} {name}: err {err}, worst "
                                     f"row at {ratio} of its tol {tol}; "
                                     f"bit-identical twice: {same}")
            # what this run's data needs: each row's live keys (index +
            # S, within the table) read once from K and V, q read, o
            # written, the table and index read
            keys = [min(int(i) + s, m * page) for i in idx.tolist()]
            nbytes = (2 * sum(keys) * h * d * elem + 2 * q.numel() * elem
                      + tab.numel() * 4 + idx.numel() * 4)
            pairs = sum(min(int(i) + j + 1, m * page)
                        for i in idx.tolist() for j in range(s))
            copies = rotated((q, pool_k, pool_v, tab_c, idx_c),
                             2 * sum(keys) * h * d * elem)
            cases.append({
                "case": name, "shape": list(q.shape), "dtype": dname,
                "design": k4_route(dname, s),
                "keys_per_split": pa.KEYS_PER_SPLIT,
                "row_keys": keys, "max_abs_err": err, "tol": tol,
                "err_over_tol": ratio, "bit_identical": same,
                "ms": timer.ms(pa.paged_flash_decode, copies),
                "plain_ms": timer.ms(pa.paged_flash_decode_reference,
                                     copies[:1]),
                "library_ms": None,
                **bounds(4 * h * d * pairs, nbytes, dname)})
            if name in ("decode", "chunk@1984"):
                cases[-1]["ms_by_keys_per_split"] = sweep_splits(
                    pa, timer, copies)
            emit({"phase": "kernels", "kernel": "K4", **cases[-1]})
            del copies
        del pools

    # the f32 chunk route where a row's weight falls on a few keys
    pool_k, pool_v = (torch.randn(pages, page, h, 128,
                                  generator=gen).to("cuda")
                      for _ in range(2))
    tab_c = full_row.cuda()
    idx_c = torch.tensor([1984], dtype=torch.int32).cuda()
    q = 4 * torch.randn(1, 64, h, 128, generator=gen).to("cuda")
    args = (q, pool_k, pool_v, tab_c, idx_c)
    o = pa.paged_flash_decode(*args)
    po = pa.paged_flash_decode_reference(*args)
    o64 = paged_oracle64(torch, pa, *args)
    torch.cuda.synchronize()
    err = float((o.double() - o64).abs().max())
    row = {"phase": "peaked", "kernel": "K4", "case": "chunk@1984",
           "shape": list(q.shape), "q_scale": 4, "dtype": "float32",
           "design": k4_route("float32", 64), "max_abs_err": err,
           "err_over_tol": err / 1e-5,
           "plain_max_abs_err": float((po.double() - o64).abs().max())}
    emit(row)
    if not err <= 1e-5:
        raise AssertionError(f"K4 f32 chunk further from float64 than the "
                             f"f32 gate at q x 4: {row}")
    del pool_k, pool_v, args
    return cases


def flash_pair(torch, timer, gen, shape, what: str):
    """K1 and K3 bf16 at ``shape`` causal: each against its plain
    version under phase 2's tolerances, run twice bit for bit, timed
    with its bound and its library call (SDPA's forward and backward).
    Returns {"K1": case, "K3": case}."""
    import torch.nn.functional as F

    from dtf_tpu_torch.ops import flash_attention as fa

    dtype, dname = torch.bfloat16, "bfloat16"
    b, s, h, d = shape
    scale = d ** -0.5
    q, k, v, do = (torch.randn(shape, generator=gen).to("cuda", dtype)
                   for _ in range(4))
    o, lse = fa.flash_forward(q, k, v, causal=True)
    again, _ = fa.flash_forward(q, k, v, causal=True)
    po, plse = fa.flash_forward_plain(q, k, v, causal=True, scale=scale)
    torch.cuda.synchronize()
    err, tol, ratio = compare(torch, o, po)
    lse_err = float((lse - plse).abs().max())
    lse_tol = 1e-5 * max(1.0, float(plse.abs().max()))
    same = torch.equal(o, again)
    if not (ratio <= 1.0 and lse_err <= lse_tol and same):
        raise AssertionError(f"K1 {dname} {shape} ({what}): o err {err} "
                             f"({ratio} of tol), lse err {lse_err} (tol "
                             f"{lse_tol}), bit-identical twice: {same}")
    elem = q.element_size()
    qkvo = q.numel() * elem
    pairs = b * h * s * (s + 1) / 2
    copies = rotated((q, k, v), 3 * qkvo)
    tq = [tuple(t.transpose(1, 2).contiguous() for t in c) for c in copies]
    cases = {"K1": {
        "shape": list(shape), "causal": True, "dtype": dname,
        "design": route(dname), "max_abs_err": err, "tol": tol,
        "err_over_tol": ratio, "lse_err": lse_err, "bit_identical": same,
        "ms": timer.ms(lambda q_, k_, v_: fa.flash_forward(
            q_, k_, v_, causal=True), copies),
        "plain_ms": timer.ms(lambda q_, k_, v_: fa.flash_forward_plain(
            q_, k_, v_, causal=True, scale=scale), copies[:1]),
        "library_ms": timer.ms(
            lambda q_, k_, v_: F.scaled_dot_product_attention(
                q_, k_, v_, is_causal=True), tq),
        **bounds(4 * d * pairs, 4 * qkvo + lse.numel() * 4, dname)}}
    del copies, tq

    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(
        b * h, s).contiguous()
    args = (q, k, v, do, lse, delta)
    kw = dict(causal=True, scale=scale)
    outs = fa.flash_bwd_fused(*args, **kw)
    again = fa.flash_bwd_fused(*args, **kw)
    plain = fa.flash_bwd_fused_plain(*args, **kw)
    torch.cuda.synchronize()
    res = [grad_tolerance(torch, a, r) for a, r in zip(outs, plain)]
    worst = max(res, key=lambda x: x[2])
    same = all(torch.equal(a, b_) for a, b_ in zip(outs, again))
    if not (worst[2] <= 1.0 and same):
        raise AssertionError(f"K3 {dname} {shape} ({what}): {res}, "
                             f"bit-identical twice: {same}")
    copies = rotated(args, 4 * qkvo)
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous().requires_grad_()
                       for t in (q, k, v, do))
    ref_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    cases["K3"] = {
        "shape": list(shape), "causal": True, "dtype": dname,
        "design": route(dname), "max_abs_err": max(x[0] for x in res),
        "tol": worst[1], "err_over_tol": worst[2], "bit_identical": same,
        "ms": timer.ms(lambda *a: fa.flash_bwd_fused(*a, **kw), copies),
        "plain_ms": timer.ms(lambda *a: fa.flash_bwd_fused_plain(*a, **kw),
                             copies[:1]),
        "library_ms": timer.ms(
            lambda: torch.autograd.grad(ref_o, (qt, kt, vt), dot,
                                        retain_graph=True), [()]),
        # S and dP, then dq, dk and dv: 2 D operations each a pair
        **bounds(2 * d * 5 * pairs, 4 * qkvo + b * h * s * 8 + 3 * qkvo,
                 dname)}
    del q, k, v, do, o, lse, delta, args, outs, again, plain, copies, \
        qt, kt, vt, dot, ref_o
    return cases


def check_tp_kernels(torch, timer, gen):
    """K1, K3 and K4 at a tensor-parallel shard's shapes, bf16 (the
    route phase 16 times): K1 and K3 at ``TP_SHAPE`` causal
    (:func:`flash_pair`), K4 at a decode step [8, 1, 3, 128] over
    check_paged's rows -- head counts no other case launches.  Each
    against its plain version under the same tolerances, run twice bit
    for bit, timed with its bound and its library call (none for
    K4)."""
    from dtf_tpu_torch.ops import paged_attention as pa

    dtype, dname = torch.bfloat16, "bfloat16"
    h, d = TP_SHAPE[2:]
    cases = flash_pair(torch, timer, gen, TP_SHAPE, "tensor parallel")
    elem = torch.empty((), dtype=dtype).element_size()

    pages, page, m = 1025, 16, 128
    lengths = [1, 15, 16, 17, 1000, 2047, 0, 0]
    table = torch.zeros(len(lengths), m, dtype=torch.int32)
    perm = torch.randperm(pages - 1, generator=gen) + 1
    used = 0
    for row, n_tok in enumerate(lengths):
        n = -(-n_tok // page)
        table[row, :n] = perm[used:used + n]
        used += n
    index = torch.tensor([max(n - 1, 0) for n in lengths], dtype=torch.int32)
    pool_k, pool_v = (torch.randn(pages, page, h, d,
                                  generator=gen).to("cuda", dtype)
                      for _ in range(2))
    tab_c, idx_c = table.cuda(), index.cuda()
    q = torch.randn(len(lengths), 1, h, d, generator=gen).to("cuda", dtype)
    o = pa.paged_flash_decode(q, pool_k, pool_v, tab_c, idx_c)
    again = pa.paged_flash_decode(q, pool_k, pool_v, tab_c, idx_c)
    po = pa.paged_flash_decode_reference(q, pool_k, pool_v, tab_c, idx_c)
    torch.cuda.synchronize()
    err, tol, ratio = compare(torch, o, po)
    same = torch.equal(o, again)
    if not (ratio <= 1.0 and same):
        raise AssertionError(f"K4 {dname} [8, 1, {h}, {d}]: err {err} "
                             f"({ratio} of tol), bit-identical: {same}")
    keys = [min(int(i) + 1, m * page) for i in index.tolist()]
    nbytes = (2 * sum(keys) * h * d * elem + 2 * q.numel() * elem
              + table.numel() * 4 + index.numel() * 4)
    copies = rotated((q, pool_k, pool_v, tab_c, idx_c),
                     2 * sum(keys) * h * d * elem)
    cases["K4"] = {
        "case": "decode", "shape": list(q.shape), "dtype": dname,
        "design": k4_route(dname, 1), "row_keys": keys,
        "max_abs_err": err, "tol": tol, "err_over_tol": ratio,
        "bit_identical": same,
        "ms": timer.ms(pa.paged_flash_decode, copies),
        "plain_ms": timer.ms(pa.paged_flash_decode_reference, copies[:1]),
        "library_ms": None, **bounds(4 * h * d * sum(keys), nbytes, dname)}
    del pool_k, pool_v, copies
    for name, case in cases.items():
        emit({"phase": "kernels_tp", "kernel": name, **case})
    torch.cuda.empty_cache()
    return cases


def check_pp_kernels(torch, timer, gen):
    """K1 and K3 bf16 at a pipeline stage's shape, ``PP_SHAPE`` causal
    (one microbatch of pipeline_transformer: 8 heads of 64) -- the shape
    phase 19 launches at every tick -- as :func:`flash_pair` checks and
    times them."""
    cases = flash_pair(torch, timer, gen, PP_SHAPE, "pipeline stage")
    for name, case in cases.items():
        emit({"phase": "kernels_pp", "kernel": name, **case})
    torch.cuda.empty_cache()
    return cases


def check_ep_kernels(torch, timer, gen):
    """K1 and K3 bf16 at an expert-parallel rank's shape, ``EP_SHAPE``
    causal (moe_transformer: two sequences a rank, 8 heads of 64) --
    the shape phase 20 launches in every block -- as :func:`flash_pair`
    checks and times them."""
    cases = flash_pair(torch, timer, gen, EP_SHAPE, "expert parallel")
    for name, case in cases.items():
        emit({"phase": "kernels_ep", "kernel": name, **case})
    torch.cuda.empty_cache()
    return cases


def check_serving_f32(torch, seed: int):
    """Greedy engine tokens == teacher-forced argmax, full width, f32;
    sampled requests replay token for token; and the kernels' launches
    in one model call of each kind, counted on the same model."""
    import numpy as np

    from dtf_tpu_torch.cli.serve_main import build_serving_engine
    from dtf_tpu_torch.config import Config
    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import paged_attention as pa
    from dtf_tpu_torch.serve.decode import Decoder, teacher_forced_logits

    cfg = Config(model="transformer_tpu", dtype="fp32", seed=seed,
                 device="cuda", serve_max_batch=4)
    model, engine = build_serving_engine(cfg, random_init=True)
    rng = np.random.default_rng(seed)
    n_new = 16
    prompts = [rng.integers(0, model.vocab_size, (n,)).astype(np.int32)
               for n in (1, 17, 64, 300)]
    try:
        handles = [engine.submit(p, max_new_tokens=n_new) for p in prompts]
        results = [hd.result(timeout=600) for hd in handles]
        # sampling draws its noise on the card: the same (seed, position)
        # must give the same tokens, another seed other tokens
        sampled = [engine.submit(prompts[1], max_new_tokens=n_new,
                                 temperature=1.0, rng_seed=s).result(
                                     timeout=600).tokens
                   for s in (seed + 1, seed + 1, seed + 2)]
    finally:
        engine.stop(drain=False)
    if engine.failed is not None:
        raise RuntimeError("engine failed") from engine.failed
    for p, r in zip(prompts, results):
        seq = np.concatenate([p, np.asarray(r.tokens, np.int32)])
        logits = teacher_forced_logits(model, seq[None])[0]
        want = logits[len(p) - 1:len(p) - 1 + n_new]
        if not bool(torch.isfinite(want).all()):
            raise AssertionError(f"prompt {len(p)}: non-finite logits")
        ref = want.argmax(-1).cpu().tolist()
        if r.tokens != ref:
            top2 = want.topk(2, dim=-1).values
            raise AssertionError(
                f"prompt {len(p)}: engine {r.tokens} != teacher-forced "
                f"argmax {ref}; smallest top-2 margin "
                f"{float((top2[:, 0] - top2[:, 1]).min())}")
    if not (sampled[0] == sampled[1] != sampled[2] and all(
            0 <= t < model.vocab_size for t in sampled[0] + sampled[2])):
        raise AssertionError(f"sampled requests do not replay: {sampled}")

    # launches per model call: a first prefill chunk (start 0), a
    # continuation chunk and a decode step, each between a reset and a
    # read of the counters
    page, chunk = 16, 64
    dec = Decoder(model, num_slots=1, max_seq_len=model.max_seq_len,
                  kv_page_size=page)
    cache = dec.fresh_cache()
    row = np.arange(1, dec.pages_per_slot + 1, dtype=np.int32)
    toks = rng.integers(0, model.vocab_size, (2 * chunk,)).astype(np.int32)
    per_call = {}
    for name, call in (
            ("first_chunk", lambda: dec.prefill_chunk(
                cache, toks[:chunk], row, 0, chunk - 1, 0.0)),
            ("continuation_chunk", lambda: dec.prefill_chunk(
                cache, toks[chunk:], row, chunk, chunk - 1, 0.0)),
            ("decode_step", lambda: dec.decode_step(
                cache, toks[-1:], [2 * chunk], [0.0], row[None]))):
        fa.launches = pa.launches = 0
        call()
        torch.cuda.synchronize()
        per_call[name] = {"K1": fa.launches, "K4": pa.launches}
    layers = model.num_layers
    want = {"first_chunk": {"K1": layers, "K4": 0},
            "continuation_chunk": {"K1": 0, "K4": layers},
            "decode_step": {"K1": 0, "K4": layers}}
    if per_call != want:
        raise AssertionError(f"launches per model call {per_call}, "
                             f"expected one per layer: {want}")
    emit({"phase": "correct", "model": "transformer_tpu", "dtype": "fp32",
          "prompts": [len(p) for p in prompts], "new_tokens": n_new,
          "token_exact": True, "sampled_replay": True,
          "launches_per_call": per_call})
    del model, engine, dec, cache
    torch.cuda.empty_cache()
    return per_call


def serve_bf16(torch, seed: int, per_call, serve_tp: int = 1,
               devices=None) -> dict:
    """The main path, through the serving entry point a user runs, in
    bf16 with the counters zeroed just before and read just after: 16
    requests, prompts up to 512 tokens, 64 new, 8 slots.  At
    ``serve_tp`` > 1 (phase 16) the same traffic through ``serve`` on
    the shards' ``devices``, each shard launching what one model does.
    Returns the stats and the launches."""
    from dtf_tpu_torch.cli import serve_main
    from dtf_tpu_torch.config import parse_flags
    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import paged_attention as pa

    n_req, n_new = 16, 64
    argv = ["--serve_random_init", "--device", "cuda",
            "--model", "transformer_tpu", "--dtype", "bf16",
            "--seed", str(seed), "--serve_max_batch", "8",
            "--serve_requests", str(n_req), "--serve_prompt_len", "512",
            "--serve_max_new_tokens", str(n_new),
            "--serve_tp", str(serve_tp)]
    torch.cuda.empty_cache()
    reset_counts(fa, pa)
    if serve_tp == 1:
        out = serve_main.main(argv)
    else:
        # serve_main's CLI puts shard k on cuda:k; two shards sharing
        # one card are named here
        out = quiet(functools.partial(
            serve_main.serve, parse_flags(argv[1:]), random_init=True,
            devices=devices))
    launches = kernel_counts(fa, pa)
    if not (out["requests"] == n_req and out["shed"] == 0
            and out["new_tokens"] == out["streamed_tokens"]
            == n_req * n_new and out["tp"] == serve_tp):
        raise AssertionError(f"serving run incomplete: {out}")
    # every request has one first chunk (K1); every other chunk and
    # every decode step attends over pages (K4), each as many times as
    # phase 3 counted in one such call, on every shard
    want = {"K1": per_call["first_chunk"]["K1"] * n_req * serve_tp,
            "K2a": 0, "K2b": 0, "K3": 0,
            "K4": serve_tp * (
                per_call["decode_step"]["K4"] * out["decode_steps"]
                + per_call["continuation_chunk"]["K4"]
                * (out["prefill_chunks"] - n_req))}
    if launches != want or min(launches["K1"], launches["K4"]) <= 0:
        raise AssertionError(f"serve_tp {serve_tp}: kernel launches "
                             f"{launches}, expected {want}")
    emit({"phase": "serve" if serve_tp == 1 else "serve_tp",
          "model": "transformer_tpu", "dtype": "bf16", **out,
          "launches": launches})
    torch.cuda.empty_cache()
    return {"launches": launches,
            **{k: out[k] for k in ("tokens_per_second", "ttft_p50_s",
                                   "decode_step_p50_s", "latency_p50_s",
                                   "decode_steps")}}


def kernel_counts(fa, pa):
    return {"K1": fa.launches, "K2a": fa.launches_dq,
            "K2b": fa.launches_dkdv, "K3": fa.launches_fused,
            "K4": pa.launches}


def reset_counts(fa, pa):
    fa.launches = fa.launches_dq = fa.launches_dkdv = 0
    fa.launches_fused = pa.launches = 0


def make_plain_attention(torch, fa, block_k: int = 64,
                         block: int = 128):
    """flash attention through the kernels' plain versions, forward and
    backward, on any device: phase 5's reference binding.  ``block_k``
    and ``block`` are the forward's key blocks and the backward's tiles:
    another size is the same function with the f32 sums in another
    order."""

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal):
            scale = q.shape[-1] ** -0.5
            o, lse = fa.flash_forward_plain(q, k, v, causal=causal,
                                            scale=scale, block_k=block_k)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.causal, ctx.scale = causal, scale
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            b, s, h, _ = q.shape
            do = do.contiguous()
            delta = (do.float() * o.float()).sum(-1).transpose(
                1, 2).reshape(b * h, s).contiguous()
            return (*fa.flash_bwd_fused_plain(q, k, v, do, lse, delta,
                                              causal=ctx.causal,
                                              scale=ctx.scale, block=block),
                    None)

    def plain_attention(q, k, v, *, causal=False, **_):
        return PlainFlash.apply(q, k, v, causal)

    return plain_attention


def training_runs(torch, seed: int, dtype, bindings, adamw,
                  remat: bool = False, timed: bool = False):
    """transformer_tpu at full width and depth, compute in ``dtype``,
    batch 2 x 2048, random weights from ``seed``.  For each attention
    binding (name -> function), one step's loss and parameter gradients;
    with ``timed``, then the median of three more such steps' synced
    host time (forward and backward, ms); with ``remat`` one
    default-bound step under remat; for the bindings named in
    ``adamw``, three AdamW steps' losses.  The kernels' launches of each
    run are counted between a reset just before and a read just after.
    Returns (parameter names, grads, losses, launches, step ms)."""
    from dtf_tpu_torch.config import Config
    from dtf_tpu_torch.data import get_dataset_spec, synthetic_input_fn
    from dtf_tpu_torch.models import transformer
    from dtf_tpu_torch.models.registry import build_model
    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import paged_attention as pa
    from dtf_tpu_torch.serve.bridge import random_init
    from dtf_tpu_torch.train.loop import Trainer, cross_entropy

    spec = get_dataset_spec("lm")
    batch = 2
    tokens, labels = (torch.from_numpy(x).cuda() for x in
                      next(synthetic_input_fn(spec, True, batch, seed)))

    def fresh(**kw):
        model, _ = build_model("transformer_tpu", dtype=dtype, **kw)
        return random_init(model, seed).cuda()

    default = transformer.flash_attention
    grads, losses, launches, step_ms = {}, {}, {}, {}
    try:
        for name, attn in bindings.items():
            transformer.flash_attention = attn
            model = fresh()
            reset_counts(fa, pa)
            loss = cross_entropy(model(tokens), labels)
            names, params = zip(*model.named_parameters())
            grads[name] = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
            launches[f"step_{name}"] = kernel_counts(fa, pa)
            losses[f"step_{name}"] = float(loss.detach())
            if timed:
                times = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    torch.autograd.grad(cross_entropy(model(tokens), labels),
                                        params)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                step_ms[name] = statistics.median(times)
            del model, loss, params
        transformer.flash_attention = default
        if remat:
            model = fresh(remat=True)
            reset_counts(fa, pa)
            cross_entropy(model(tokens), labels).backward()
            torch.cuda.synchronize()
            launches["step_K3_remat"] = kernel_counts(fa, pa)
            del model
        cfg = Config(device="cuda", dataset="lm", batch_size=batch,
                     train_steps=3, optimizer="adamw", seed=seed)
        for name in adamw:
            transformer.flash_attention = bindings[name]
            trainer = Trainer(cfg, fresh(), 0.0, spec)
            state = trainer.init_state()
            reset_counts(fa, pa)
            run = []
            for _ in range(3):
                state, metrics = trainer.train_step(state, tokens, labels)
                run.append(float(metrics["loss"]))
            launches[f"adamw_{name}"] = kernel_counts(fa, pa)
            losses[f"adamw_{name}"] = run
            del trainer, state
    finally:
        transformer.flash_attention = default
    return names, grads, losses, launches, step_ms


def grad_gap(names, grads, ref: str, other: str, tol: float):
    """The worst parameter gradient of binding ``other`` against
    ``ref``'s, each held within ``tol`` of its own largest |value|:
    (error over tolerance, parameter name)."""
    ratios = []
    for name, a, b in zip(names, grads[other], grads[ref]):
        top = float(b.float().abs().max())
        ratios.append((float((a.float() - b.float()).abs().max())
                       / (tol * max(top, 1e-30)), name))
    return max(ratios)


def check_launches(launches, want) -> None:
    got = {k: tuple(v[n] for n in ("K1", "K2a", "K2b", "K3"))
           for k, v in launches.items()}
    if got != want:
        raise AssertionError(f"launches per run {got}, expected {want}")


def check_training_f32(torch, seed: int):
    """float32 (the split-product routes of K1, K2a, K2b and K3): one
    step's gradients through K1 + K3 (the
    default) against the same step with attention bound to K1 + K2a/K2b
    and to the plain versions, each gradient within 1e-4 of its own
    largest |value|; each binding's synced step time; the launches of
    each binding and of remat; then three AdamW steps with K3 and with
    K2a/K2b, per-step losses within 1e-5 relative."""
    import functools

    from dtf_tpu_torch.ops import flash_attention as fa

    bindings = {"K3": fa.flash_attention,
                "K2a+K2b": functools.partial(fa.flash_attention,
                                             fused_bwd=False),
                "plain": make_plain_attention(torch, fa)}
    names, grads, losses, launches, step_ms = training_runs(
        torch, seed, torch.float32, bindings, ("K3", "K2a+K2b"), remat=True,
        timed=True)
    worst = {}
    for other in ("K2a+K2b", "plain"):
        worst[other] = grad_gap(names, grads, "K3", other, 1e-4)
        if not worst[other][0] <= 1.0:
            raise AssertionError(f"{other} gradient of {worst[other][1]} "
                                 f"differs from K3's by {worst[other][0]} "
                                 f"of its tolerance")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["adamw_K2a+K2b"],
                                                  losses["adamw_K3"]))
    if not (rel <= 1e-5 and all(math.isfinite(x)
                                for x in losses["adamw_K3"])):
        raise AssertionError(f"AdamW losses K3 vs K2a/K2b: {losses}")
    layers = 12
    check_launches(launches, {
        "step_K3": (layers, 0, 0, layers),
        "step_K2a+K2b": (layers, layers, layers, 0),
        "step_plain": (0, 0, 0, 0),
        "step_K3_remat": (2 * layers, 0, 0, layers),
        "adamw_K3": (3 * layers, 0, 0, 3 * layers),
        "adamw_K2a+K2b": (3 * layers, 3 * layers, 3 * layers, 0)})
    out = {"phase": "train_f32", "model": "transformer_tpu",
           "batch": 2, "seq": 2048, "losses": losses,
           "grad_err_over_tol": {k: v[0] for k, v in worst.items()},
           "grad_worst_param": {k: v[1] for k, v in worst.items()},
           "adamw_loss_rel_gap": rel, "step_ms": step_ms,
           "launches": launches}
    emit(out)
    del grads
    torch.cuda.empty_cache()
    return out


def check_training_bf16(torch, seed: int):
    """bfloat16 compute (the tensor-core routes): one step's gradients
    through K1 + K3 and through K1 + K2a/K2b (``fused_bwd=False``)
    against the same step with attention bound to the plain versions,
    and three AdamW steps with each binding, losses within 5e-3 relative
    of plain's -- the port's bf16 Trainer tolerance against the JAX
    package.  Each parameter's gradient within 1e-2 of its own largest
    |value|, or within twice the gap between two plain bindings that
    differ only in the order of their f32 sums (forward key blocks 128
    for 64, backward tiles 64 for 128): the step rounds to bf16 at every
    matmul and attention of 12 layers, and a gradient that few terms
    feed -- ``pos_embed``, a sum over the batch's two rows -- carries
    that rounding noise at about 1e-2 of its largest value whichever
    binding computes it."""
    import functools

    from dtf_tpu_torch.ops import flash_attention as fa

    kernels = ("K3", "K2a+K2b")
    bindings = {"K3": fa.flash_attention,
                "K2a+K2b": functools.partial(fa.flash_attention,
                                             fused_bwd=False),
                "plain": make_plain_attention(torch, fa),
                "plain_reordered": make_plain_attention(torch, fa,
                                                        block_k=128,
                                                        block=64)}
    names, grads, losses, launches, _ = training_runs(
        torch, seed, torch.bfloat16, bindings, kernels + ("plain",))
    worst, worst_five, rel = {}, {}, {}
    for kname in kernels:
        gaps = []
        for name, a, b, c in zip(names, grads[kname], grads["plain"],
                                 grads["plain_reordered"]):
            top = float(b.float().abs().max())
            err = float((a.float() - b.float()).abs().max())
            noise = float((c.float() - b.float()).abs().max())
            gaps.append((err / max(1e-2 * top, 2 * noise, 1e-30), name,
                         err / max(top, 1e-30), noise / max(top, 1e-30)))
        worst[kname] = max(gaps)
        # the five parameters nearest their tolerance: (name, gap and
        # reordered plain's gap, each over the largest |value|)
        worst_five[kname] = [[n, g, r] for _, n, g, r in
                             sorted(gaps, reverse=True)[:5]]
        rel[kname] = max(abs(a - b) / abs(b) for a, b in zip(
            losses[f"adamw_{kname}"], losses["adamw_plain"]))
        if not (worst[kname][0] <= 1.0 and rel[kname] <= 5e-3
                and all(math.isfinite(x) for x in losses[f"adamw_{kname}"])):
            raise AssertionError(
                f"bf16 K1 + {kname} against plain: gradient of "
                f"{worst[kname][1]} at {worst[kname][0]} of its tolerance "
                f"(gap {worst[kname][2]}, reordered plain "
                f"{worst[kname][3]} of its largest value), AdamW losses "
                f"{losses}")
    layers = 12
    check_launches(launches, {
        "step_K3": (layers, 0, 0, layers),
        "step_K2a+K2b": (layers, layers, layers, 0),
        "step_plain": (0, 0, 0, 0), "step_plain_reordered": (0, 0, 0, 0),
        "adamw_K3": (3 * layers, 0, 0, 3 * layers),
        "adamw_K2a+K2b": (3 * layers, 3 * layers, 3 * layers, 0),
        "adamw_plain": (0, 0, 0, 0)})
    out = {"phase": "train_bf16_parity", "model": "transformer_tpu",
           "batch": 2, "seq": 2048, "losses": losses,
           "grad_err_over_tol": {k: v[0] for k, v in worst.items()},
           "grad_worst_param": {k: v[1] for k, v in worst.items()},
           "grad_worst_five": worst_five,
           "adamw_loss_rel_gap": rel, "launches": launches}
    emit(out)
    del grads
    torch.cuda.empty_cache()
    return out


FLOPS_PER_TOKEN = ("6 * (L * (4 d^2 + 2 d d_ff) + d V) + 6 L S d: the "
                   "weight matmuls forward and backward, plus causal "
                   "attention's QK^T and PV (S/2 keys a query on average)")


def train_bf16(torch, seed: int, split: bool = False, steps: int = 30):
    """The main path of the training slice: ``cli/lm_main.main`` trains
    transformer_tpu in bf16, batch 8 x 2048, ``steps`` steps, with the
    counters zeroed just before and read just after.  Every logged loss
    finite, the last below the first (the synthetic stream repeats one
    batch); 12 K1 and 12 K3 launches a step.  With ``split`` the same
    run has attention bound to ``fused_bwd=False`` -- the split pair's
    path (cross-length attention, long sequences, or that choice) at
    the training shape -- and 12 K2a and 12 K2b launches a step."""
    import functools

    from dtf_tpu_torch.cli import lm_main
    from dtf_tpu_torch.models import transformer
    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import paged_attention as pa

    log_steps = 5
    b, s, h, dh = TRAIN_SHAPE
    argv = ["--use_synthetic_data", "--device", "cuda",
            "--model", "transformer_tpu", "--dtype", "bf16",
            "--batch_size", str(b), "--train_steps", str(steps),
            "--log_steps", str(log_steps), "--seed", str(seed),
            "--skip_checkpoint"]
    default = transformer.flash_attention
    if split:
        transformer.flash_attention = functools.partial(fa.flash_attention,
                                                        fused_bwd=False)
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa, pa)
        t0 = time.perf_counter()
        stats = lm_main.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_counts(fa, pa)
    finally:
        transformer.flash_attention = default
    peak = torch.cuda.max_memory_allocated()
    losses = [loss for _, loss in stats["train_loss_log"]]
    if not (len(losses) == steps // log_steps
            and all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"training losses {stats['train_loss_log']}")
    layers = 12
    bwd = layers * steps
    want = {"K1": layers * steps, "K2a": bwd if split else 0,
            "K2b": bwd if split else 0, "K3": 0 if split else bwd, "K4": 0}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    step_p50 = statistics.median(stats["window_step_s"])
    d, d_ff, vocab = h * dh, 3072, 32768
    flops_per_token = (6 * (layers * (4 * d * d + 2 * d * d_ff) + d * vocab)
                       + 6 * layers * s * d)
    tokens_per_s = b * s / step_p50
    out = {"phase": "train_split" if split else "train",
           "model": "transformer_tpu", "dtype": "bf16",
           "backward": "K2a+K2b" if split else "K3",
           "batch": b, "seq": s, "steps": steps, "log_steps": log_steps,
           "losses": stats["train_loss_log"],
           "step_s_p50": step_p50, "window_step_s": stats["window_step_s"],
           "tokens_per_s": tokens_per_s,
           "avg_tokens_per_s": stats["avg_exp_per_second"] * s,
           "peak_memory_bytes": peak,
           "flops_per_token": flops_per_token,
           "flops_per_token_formula": FLOPS_PER_TOKEN,
           "mfu": tokens_per_s * flops_per_token / PEAK_FLOPS["bfloat16"],
           "wall_s": wall, "launches": launches,
           "launches_per_step": {k: v / steps for k, v in launches.items()}}
    # the MFU ledger's train_step (obs/ledger.py): FlopCounterMode's
    # FLOPs with K1's and K3's own counts, over the synced windows' mean
    # step, against the card's peak by name; the JAX ledger's contract
    # is within 20% of this formula's MFU
    # counted: 6 FLOPs a weight a token, plus K1's 4 D and K3's 10 D a
    # causal pair of each head (K3's reported from autograd's thread)
    ledger = stats["ledger"].get("train_step") or {}
    pairs = b * h * s * (s + 1) // 2
    counted = (6 * b * s * (layers * (4 * d * d + 2 * d * d_ff) + d * vocab)
               + layers * (4 + 10) * dh * pairs)
    out.update(ledger_train_step=ledger, ledger_flops_counted=counted,
               ledger_flops_over_formula=ledger.get("flops", 0.0)
               / (flops_per_token * b * s),
               ledger_mfu_over_mfu=(ledger.get("mfu") or 0.0) / out["mfu"])
    emit(out)
    if not split and (ledger.get("flops") != counted
                      or abs(out["ledger_mfu_over_mfu"] - 1) > 0.2):
        raise AssertionError(f"ledger train_step {ledger}: FLOPs not "
                             f"{counted}, or its MFU not within 20% of the "
                             f"formula's {out['mfu']}")
    torch.cuda.empty_cache()
    return out


REMAT_LOSS_RTOL = 5e-3   # phase 6's bf16 loss gate (train_bf16_parity)


def rel_gap(a, b) -> float:
    """The largest |a - b| / |b| over two loss lists."""
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def train_remat_arms(torch, seed: int, none: dict) -> dict:
    """Phase 6's remat arms: the ``train`` run's ``lm_main`` (bf16,
    8 x 2048, AdamW, the same steps) with ``--remat_policy dots`` and
    with ``--remat``, the counters zeroed just before and read just
    after each.  Gates: 12, 12 and 24 K1 launches a step under none,
    dots and remat, 12 K3; losses within ``REMAT_LOSS_RTOL`` of the
    none arm's (bit-identity printed); --remat's peak memory below
    none's."""
    from dtf_tpu_torch.cli import lm_main
    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import paged_attention as pa

    b = TRAIN_SHAPE[0]
    steps, log_steps = none["steps"], none["log_steps"]
    argv = ["--use_synthetic_data", "--device", "cuda",
            "--model", "transformer_tpu", "--dtype", "bf16",
            "--batch_size", str(b), "--train_steps", str(steps),
            "--log_steps", str(log_steps), "--seed", str(seed),
            "--skip_checkpoint"]

    def brief(run, launches, peak):
        losses = [v for _, v in run["losses"]]
        return {"step_s_p50": run["step_s_p50"],
                "peak_memory_bytes": peak, "losses": losses,
                "launches_per_step": {k: launches[k] / steps
                                      for k in ("K1", "K3")}}

    arms = {"none": brief(none, none["launches"],
                          none["peak_memory_bytes"])}
    launches = {"none": none["launches"]}
    for arm, flags in (("dots", ["--remat_policy", "dots"]),
                       ("remat", ["--remat"])):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa, pa)
        stats = lm_main.main(argv + flags)
        torch.cuda.synchronize()
        launches[arm] = kernel_counts(fa, pa)
        arms[arm] = brief({"losses": stats["train_loss_log"],
                           "step_s_p50": statistics.median(
                               stats["window_step_s"])},
                          launches[arm], torch.cuda.max_memory_allocated())
        torch.cuda.empty_cache()
    ref = arms["none"]["losses"]
    for arm in ("dots", "remat"):
        arms[arm]["loss_rel_gap_to_none"] = rel_gap(arms[arm]["losses"],
                                                   ref)
        arms[arm]["losses_bit_identical_to_none"] = (
            arms[arm]["losses"] == ref)
    line = {"phase": "train_remat", "model": "transformer_tpu",
            "dtype": "bf16", "batch": b, "seq": TRAIN_SHAPE[1],
            "steps": steps, "tol": REMAT_LOSS_RTOL, "arms": arms}
    emit(line)
    want = {"none": 12, "dots": 12, "remat": 24}
    if not (all(arms[a]["launches_per_step"] == {"K1": k1, "K3": 12}
                for a, k1 in want.items())
            and all(arms[a]["loss_rel_gap_to_none"] <= REMAT_LOSS_RTOL
                    for a in ("dots", "remat"))
            and arms["remat"]["peak_memory_bytes"]
            < arms["none"]["peak_memory_bytes"]):
        raise AssertionError(f"train_remat: {line}")
    return {"line": line, "launches": launches,
            "run": f"train with --remat_policy dots and with --remat, "
                   f"{steps} steps each (phase 6)"}


def device_time(prof, kinds, steps: int, wall: float):
    """A profiled window's device time per step: summed by kind (the
    first ``kinds`` entry, (label, tag or tags), whose tag a kernel's name
    holds), by kernel name, busy in all, and the device's idle share of
    the window's wall time (s)."""
    from torch.autograd import DeviceType

    by_kind, by_name, busy = {}, {}, 0.0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        busy += us
        by_name[ev.name] = by_name.get(ev.name, 0.0) + us / 1e3 / steps
        name = ev.name.lower()
        kind = "other (copies, ...)"
        for label, tags in kinds:
            tags = (tags,) if isinstance(tags, str) else tags
            if any(t.lower() in name for t in tags):
                kind = label
                break
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3 / steps
    return {"steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
            "device_busy_ms_per_step": busy / 1e3 / steps,
            "device_idle_share": max(0.0, 1 - busy / 1e6 / wall),
            "device_ms_per_step_by_kind": dict(sorted(
                by_kind.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms_per_step": [
                [n[:90], ms] for n, ms in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:10]]}


def profile_train_step(torch, seed: int):
    """Where one bf16 training step's device time goes: two steps of a
    fresh ``transformer_tpu`` trainer (after the counted run) under
    torch.profiler, kernel time summed by kind, and the device's idle
    share of the steps' wall time.  Raises where the profiler sees no
    device time, or none for K1 and K3's two passes."""
    from torch.profiler import ProfilerActivity, profile

    from dtf_tpu_torch.cli.lm_main import LM_DEFAULTS
    from dtf_tpu_torch.cli.runner import build_training
    from dtf_tpu_torch.config import parse_flags

    b = TRAIN_SHAPE[0]
    cfg = parse_flags(["--use_synthetic_data", "--device", "cuda",
                       "--model", "transformer_tpu", "--batch_size", str(b),
                       "--train_steps", "4", "--seed", str(seed)],
                      defaults=LM_DEFAULTS)
    trainer, state, train_fn, _ = build_training(cfg)
    x, y = (torch.from_numpy(a).cuda() for a in next(train_fn()))
    state, m = trainer.train_step(state, x, y)
    float(m["loss"])
    steps = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = trainer.train_step(state, x, y)
        float(m["loss"])
        wall = time.perf_counter() - t0
    kinds = (("K1 (flash_fwd_tc_kernel)", "flash_fwd_tc_kernel"),
             ("K3 pass 1 (bwd_fused_tc_kernel)", "bwd_fused_tc_kernel"),
             ("K3 pass 2 (dq_reduce_tc_kernel)", "dq_reduce_tc_kernel"),
             ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "nvjet")),
             ("cross-entropy / softmax", ("softmax", "nll", "cross")),
             ("layer norm", "layer_norm"),
             ("reductions", "reduce"),
             ("elementwise (incl. AdamW, casts)", ("elementwise",
                                                   "vectorized")))
    out = device_time(prof, kinds, steps, wall)
    by_kind = out["device_ms_per_step_by_kind"]
    missing = [label for label, _ in kinds[:3] if not by_kind.get(label)]
    if not out["device_busy_ms_per_step"] or missing:
        raise RuntimeError(f"profiler saw no device time for "
                           f"{missing or 'any kernel'}; kernels seen: "
                           f"{out['top_kernels_ms_per_step']}")
    emit({"phase": "train_profile", **out})
    del trainer, state, x, y
    torch.cuda.empty_cache()
    return out


def profile_decode_step(torch, seed: int):
    """Where a serving decode step's device time goes: ``Decoder.
    decode_step`` on ``transformer_tpu`` in bf16 at full width, a full
    batch of 8 rows holding 300-576 tokens (phase 4's lengths: prompts
    up to 512 plus up to 64 new tokens), pages shuffled over the full
    pool.  The synced host time of ten steps (median), then five steps
    under torch.profiler: device time by kernel kind, K4's two passes,
    K4's share of the device time and the idle share.  Raises where the
    profiler sees no device time for either of K4's passes, or K4 did
    not launch 12 times a step."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from dtf_tpu_torch.models.registry import build_model
    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import paged_attention as pa
    from dtf_tpu_torch.serve.bridge import random_init
    from dtf_tpu_torch.serve.decode import Decoder

    model, _ = build_model("transformer_tpu", dtype=torch.bfloat16)
    model = random_init(model, seed).cuda().eval()
    rows, page = 8, 16
    dec = Decoder(model, num_slots=rows, max_seq_len=model.max_seq_len,
                  kv_page_size=page)
    cache = dec.fresh_cache()
    rng = np.random.default_rng(seed)
    lengths = rng.integers(300, 577, rows)
    perm = rng.permutation(np.arange(1, dec.pool_pages)).astype(np.int32)
    pps = dec.pages_per_slot
    tables = perm[:rows * pps].reshape(rows, pps)
    tokens = rng.integers(0, model.vocab_size, rows)
    temps = np.zeros(rows, np.float32)

    def step():
        toks, _, _ = dec.decode_step(cache, tokens, lengths, temps, tables)
        return toks

    for _ in range(3):
        step().cpu()
    host_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        step().cpu()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    steps = 5
    reset_counts(fa, pa)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            toks = step()
        toks.cpu()
        wall = time.perf_counter() - t0
    launches = kernel_counts(fa, pa)
    kinds = (("K4 split pass (paged_split_*)", "paged_split"),
             ("K4 combine (paged_combine_kernel)", "paged_combine"),
             ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "nvjet")),
             ("layer norm", "layer_norm"),
             ("softmax / sampling", ("softmax", "argmax", "topk", "sort")),
             ("reductions", "reduce"),
             ("page writes (index_put / scatter)", ("index", "scatter")),
             ("elementwise (casts, GELU, residuals)", ("elementwise",
                                                       "vectorized")))
    out = device_time(prof, kinds, steps, wall)
    by_kind = out["device_ms_per_step_by_kind"]
    k4_ms = sum(by_kind.get(label, 0.0) for label, _ in kinds[:2])
    missing = [label for label, _ in kinds[:2] if not by_kind.get(label)]
    if missing:
        raise RuntimeError(f"profiler saw no device time for {missing}; "
                           f"kernels seen: {out['top_kernels_ms_per_step']}")
    layers = model.num_layers
    if launches["K4"] != layers * steps:
        raise AssertionError(f"K4 launched {launches['K4']} times in "
                             f"{steps} decode steps, expected "
                             f"{layers * steps}")
    out = {"phase": "decode_profile", "model": "transformer_tpu",
           "dtype": "bf16", "rows": rows, "row_lengths": lengths.tolist(),
           "host_step_ms_p50": statistics.median(host_ms),
           "host_step_ms": host_ms, **out,
           "k4_ms_per_step": k4_ms,
           "k4_share_of_busy": k4_ms / out["device_busy_ms_per_step"],
           "k4_passes_ms_per_call": {
               label: by_kind[label] / layers for label, _ in kinds[:2]},
           "launches": launches}
    emit(out)
    del model, dec, cache
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 7: ResNet training (cli.cifar_main, cli.imagenet_main)
# ---------------------------------------------------------------------------

VISION_FLOPS = ("torch.utils.flop_counter.FlopCounterMode over one "
                "forward and backward on the card (convolutions and "
                "matmuls, 2 per multiply-add), divided by the batch")


def vision_flops_per_image(torch, name: str, image: int,
                           batch: int = 8) -> float:
    """FLOPs of one image's forward and backward through ``name`` in
    bf16, counted by FlopCounterMode on the card."""
    from torch.utils.flop_counter import FlopCounterMode

    from dtf_tpu_torch.models.registry import build_model
    from dtf_tpu_torch.train.loop import cross_entropy

    model, _ = build_model(name, dtype=torch.bfloat16)
    model = model.init_weights(0).cuda().to(memory_format=torch.channels_last)
    x = torch.randn(batch, image, image, 3, device="cuda")
    y = torch.zeros(batch, dtype=torch.long, device="cuda")
    with FlopCounterMode(display=False) as counter:
        cross_entropy(model(x), y).backward()
    del model
    return counter.get_total_flops() / batch


def resnet_step_tensors(torch, model, images, labels, l2):
    """One training forward and backward (cross-entropy + L2): the loss,
    the logits, the parameter gradients and the BN buffers after it."""
    from dtf_tpu_torch.models.registry import l2_weight_penalty
    from dtf_tpu_torch.train.loop import cross_entropy

    model.train()
    logits = model(images)
    loss = cross_entropy(logits, labels) + l2_weight_penalty(model, l2)
    loss.backward()
    return ({"loss": loss.detach(), "logits": logits.detach()},
            {n: p.grad for n, p in model.named_parameters()},
            dict(model.named_buffers()))


def check_resnet_f32(torch, seed: int, card: str):
    """``resnet56`` in float32 (TF32 off), weights from ``seed``, batch
    32 of synthetic CIFAR: one training step's loss, logits, gradients
    and BN buffers on the card against the same model run in float64 on
    the CPU.  Gates: the loss 1e-5 relative; the logits and every
    buffer within 1e-4 of their largest |value|; the whole gradient
    (every parameter's, as one vector) within a relative L2 distance of
    three times that of the same step run in float32 on the CPU.

    A gradient tensor's own largest gap is no gate here: ReLU units
    whose input lies within float32 rounding of 0 switch between any
    float32 evaluation and float64, and a weight gradient that sums a
    few thousand terms of either sign moves by a per cent with each
    such switch.  The CPU's float32 step lands past 1e-4 of the largest
    value on nearly every tensor and at about 4e-3 relative L2 on the
    whole gradient, as does float64 with its input perturbed by 1e-7;
    a TF32 product (1e-3 perturbation) lands near 0.3."""
    from dtf_tpu_torch.data import get_dataset_spec, synthetic_input_fn
    from dtf_tpu_torch.models.registry import build_model

    images, labels = next(synthetic_input_fn(get_dataset_spec("cifar10"),
                                             True, 32, seed))
    model, l2 = build_model("resnet56", dtype=torch.float32)
    model = model.init_weights(seed)
    runs = {}
    for where, dtype in (("float64", torch.float64),
                         ("cpu_float32", torch.float32), ("card", None)):
        if dtype is None:
            m, device, dtype = model.cuda().to(
                memory_format=torch.channels_last), "cuda", torch.float32
        else:
            m, _ = build_model("resnet56", dtype=dtype)
            m.load_state_dict(model.state_dict())
            m, device = m.to(dtype), "cpu"
        runs[where] = resnet_step_tensors(
            torch, m, torch.from_numpy(images).to(device, dtype),
            torch.from_numpy(labels).to(device), l2)

    def gap(got, ref):
        return float((got.cpu().double() - ref.double()).abs().max()) / max(
            float(ref.abs().max()), 1e-30)

    ref_out, ref_grads, ref_bufs = runs["float64"]
    out, grads, bufs = runs["card"]
    loss_rel = abs(float(out["loss"]) - float(ref_out["loss"])) / abs(
        float(ref_out["loss"]))
    logits_gap = gap(out["logits"], ref_out["logits"])
    buf_gap = max((gap(bufs[n], r), n) for n, r in ref_bufs.items())
    def flat(gs):
        return torch.cat([gs[n].detach().cpu().double().flatten()
                          for n in ref_grads])

    ref_flat = flat(ref_grads)
    grad_rel = {where: float((flat(runs[where][1]) - ref_flat).norm()
                             / ref_flat.norm())
                for where in ("card", "cpu_float32")}
    grad_gate = 3 * grad_rel["cpu_float32"]
    per_tensor = [(gap(grads[n], r), gap(runs["cpu_float32"][1][n], r), n)
                  for n, r in ref_grads.items()]
    line = {"phase": "resnet_f32", "card": card, "model": "resnet56",
            "dtype": "float32", "batch": 32, "loss": float(out["loss"]),
            "loss_float64": float(ref_out["loss"]), "loss_rel_err": loss_rel,
            "loss_gate": 1e-5, "logits_gap_over_max": logits_gap,
            "buffer_gap_over_max": buf_gap[0], "buffer_worst": buf_gap[1],
            "gate_over_max": 1e-4,
            "grad_rel_l2": grad_rel["card"],
            "grad_rel_l2_cpu_float32": grad_rel["cpu_float32"],
            "grad_gate": grad_gate,
            "grad_max_gap_over_max": max(per_tensor)[0],
            "grad_max_gap_tensor": max(per_tensor)[2],
            "grad_max_gap_over_max_cpu_float32": max(
                g[1] for g in per_tensor),
            "grads_past_1e-4": sum(g[0] > 1e-4 for g in per_tensor),
            "grads_past_1e-4_cpu_float32": sum(g[1] > 1e-4
                                               for g in per_tensor),
            "grads": len(per_tensor)}
    emit(line)
    if not (loss_rel <= 1e-5 and logits_gap <= 1e-4 and buf_gap[0] <= 1e-4
            and grad_rel["card"] <= grad_gate):
        raise AssertionError(f"resnet56 float32 on the card against "
                             f"float64: {line}")
    del model, runs
    torch.cuda.empty_cache()
    return line


def vision_trainer(torch, seed: int, name: str, batch: int,
                   steps: int = 3):
    """A fresh bf16 Trainer of ``name`` (resnet56 on CIFAR or resnet50
    on ImageNet, the mains' defaults) from ``seed``, built by the runner
    (which sets cudnn.deterministic), and its synthetic batch on the
    card."""
    from dtf_tpu_torch.cli.cifar_main import CIFAR_DEFAULTS
    from dtf_tpu_torch.cli.imagenet_main import IMAGENET_DEFAULTS
    from dtf_tpu_torch.cli.runner import build_training
    from dtf_tpu_torch.config import parse_flags

    defaults = CIFAR_DEFAULTS if name == "resnet56" else IMAGENET_DEFAULTS
    cfg = parse_flags(["--use_synthetic_data", "--device", "cuda",
                       "--model", name, "--dtype", "bf16",
                       "--batch_size", str(batch), "--train_steps",
                       str(steps), "--seed", str(seed)], defaults=defaults)
    trainer, state, train_fn, _ = build_training(cfg)
    x, y = (torch.from_numpy(a).cuda() for a in next(train_fn()))
    return trainer, state, x, y


def synced_step_ms(torch, trainer, state, x, y, steps: int = 10):
    """Median synced host time of ``steps`` training steps (ms), after
    two untimed ones."""
    times = []
    for i in range(steps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = trainer.train_step(state, x, y)
        float(m["loss"])
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), state


def deterministic_cost(torch, trainer, state, x, y, steps: int):
    """Synced step times (ms) with cudnn.deterministic on and off, in
    turns on, off, off, on: the median of each setting's two."""
    ms = {True: [], False: []}
    for det in (True, False, False, True):
        torch.backends.cudnn.deterministic = det
        t, state = synced_step_ms(torch, trainer, state, x, y, steps)
        ms[det].append(t)
    torch.backends.cudnn.deterministic = True
    return {"on": statistics.median(ms[True]),
            "off": statistics.median(ms[False]),
            "on_runs": ms[True], "off_runs": ms[False]}


def check_resnet_determinism(torch, seed: int, card: str):
    """Two fresh ``resnet56`` bf16 runs of three steps from ``seed``
    (batch 128): losses and parameters bit-identical.  Then the synced
    step time with ``torch.backends.cudnn.deterministic`` on (the
    runner's setting) and off, in turns, for resnet56 at batch 128 and
    resnet50 at batch 256."""
    runs = []
    for _ in range(2):
        trainer, state, x, y = vision_trainer(torch, seed, "resnet56", 128)
        losses = []
        for _ in range(3):
            state, m = trainer.train_step(state, x, y)
            losses.append(float(m["loss"]))
        runs.append((losses, [t.detach().clone() for t in
                              trainer.model.state_dict().values()]))
    identical = (runs[0][0] == runs[1][0] and all(
        torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1])))
    cost = {"resnet56_b128": deterministic_cost(torch, trainer, state, x, y,
                                                10)}
    del trainer, state, x, y, runs[1:]
    trainer, state, x, y = vision_trainer(torch, seed, "resnet50", 256)
    cost["resnet50_b256"] = deterministic_cost(torch, trainer, state, x, y,
                                               4)
    line = {"phase": "resnet_determinism", "card": card, "model": "resnet56",
            "dtype": "bf16", "batch": 128, "losses": runs[0][0],
            "bit_identical": identical,
            "step_ms_cudnn_deterministic": cost}
    emit(line)
    if not identical:
        raise AssertionError(f"two resnet56 runs from one seed differ: "
                             f"{line}")
    del trainer, state, runs
    torch.cuda.empty_cache()
    return line


def vision_run(torch, main, argv, phase: str, card: str, batch: int,
               flops_per_image=None, log_steps: int = 5,
               falling: bool = True, **extra):
    """``main(argv)`` on the card: images/s from the synced step-time
    p50 (the first log window dropped), peak memory, and MFU at 989
    TFLOP/s when ``flops_per_image`` is given; with ``falling``, finite
    losses whose last is below the first."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = main(argv + ["--batch_size", str(batch),
                         "--log_steps", str(log_steps), "--skip_checkpoint"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [loss for _, loss in stats["train_loss_log"]]
    step_p50 = statistics.median(stats["window_step_s"])
    line = {"phase": phase, "card": card, "batch": batch, **extra,
            "losses": stats["train_loss_log"], "step_s_p50": step_p50,
            "window_step_s": stats["window_step_s"],
            "images_per_s": batch / step_p50,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "wall_s": wall}
    if flops_per_image is not None:
        line.update(flops_per_image=flops_per_image,
                    flops_per_image_by=VISION_FLOPS,
                    mfu=batch / step_p50 * flops_per_image
                    / PEAK_FLOPS["bfloat16"])
    emit(line)
    if falling and not (losses and all(math.isfinite(v) for v in losses)
                        and losses[-1] < losses[0]):
        raise AssertionError(f"{phase} losses {stats['train_loss_log']}")
    torch.cuda.empty_cache()
    return line, stats


def train_cifar(torch, seed: int, card: str):
    """``cli.cifar_main.main``: resnet56, bf16, batch 128, synthetic
    data, 50 steps."""
    from dtf_tpu_torch.cli import cifar_main

    argv = ["--use_synthetic_data", "--device", "cuda", "--model",
            "resnet56", "--dtype", "bf16", "--train_steps", "50",
            "--skip_eval", "--seed", str(seed)]
    return vision_run(torch, cifar_main.main, argv, "train_cifar", card,
                      128, vision_flops_per_image(torch, "resnet56", 32),
                      model="resnet56", dtype="bf16", steps=50)[0]


def train_imagenet(torch, seed: int, card: str):
    """``cli.imagenet_main.main``: resnet50, bf16, the JAX main's batch
    of 256 (halved while it does not fit), synthetic 224x224, 30 steps;
    then 20 steps of ``--use_trivial_model`` at the same batch, whose
    images/s is the input path's."""
    from dtf_tpu_torch.cli import imagenet_main

    argv = ["--use_synthetic_data", "--device", "cuda", "--dtype", "bf16",
            "--skip_eval", "--seed", str(seed)]
    flops = vision_flops_per_image(torch, "resnet50", 224)
    batch, note = 256, "the JAX main's default batch"
    while True:
        try:
            line, _ = vision_run(
                torch, imagenet_main.main, argv + ["--train_steps", "30"],
                "train_imagenet", card, batch, flops, model="resnet50",
                dtype="bf16", steps=30, batch_note=note)
            break
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            batch //= 2
            note = f"batch halved to {batch}: 2x did not fit"
            if batch < 32:
                raise
    # the selective remat policy (conv outputs and BN statistics saved,
    # the normalize/ReLU chains recomputed) on the same run
    remat, _ = vision_run(
        torch, imagenet_main.main, argv + ["--train_steps", "30", "--remat"],
        "train_imagenet_remat", card, batch, flops, model="resnet50",
        dtype="bf16", steps=30, remat="conv_out + bn_stats saved")
    losses = [[v for _, v in run["losses"]] for run in (remat, line)]
    gate = {"phase": "resnet_remat_gate", "card": card,
            "loss_rel_gap_to_off": rel_gap(*losses),
            "losses_bit_identical_to_off": losses[0] == losses[1],
            "tol": REMAT_LOSS_RTOL,
            "step_s_p50": {"off": line["step_s_p50"],
                           "remat": remat["step_s_p50"]},
            "peak_memory_bytes": {"off": line["peak_memory_bytes"],
                                  "remat": remat["peak_memory_bytes"]}}
    emit(gate)
    if gate["loss_rel_gap_to_off"] > REMAT_LOSS_RTOL:
        raise AssertionError(f"resnet remat: {gate}")
    # the probe's loss runs off to inf/NaN on raw 0-255 pixels, as the
    # JAX model's does: the NaN guard would end the run it times
    trivial, _ = vision_run(
        torch, imagenet_main.main,
        argv + ["--use_trivial_model", "--train_steps", "20",
                "--nan_guard", "false"],
        "train_imagenet_trivial", card, batch, falling=False,
        model="trivial", dtype="bf16", steps=20,
        note="the input probe: images/s of synthetic float32 224x224 "
             "batches through the prefetcher")
    return line, trivial


class VisionProfile:
    """torch.profiler over training steps, the device time of each
    kernel put in a kind by the CPU op that launched it: a range around
    each BatchNorm forward (module hooks) and around the optimizer's
    update and apply, and for the backward the autograd node's sequence
    number, which is its forward op's."""

    KINDS = ("convolution (cuDNN)", "BatchNorm", "optimizer",
             "elementwise", "reductions", "copies")

    def __init__(self, trainer):
        self.trainer = trainer

    def _bn_hooks(self):
        from dtf_tpu_torch.models.resnet import BatchNorm
        from torch.autograd.profiler import record_function

        handles, open_ranges = [], []

        def enter(mod, args):
            rf = record_function("batch_norm")
            rf.__enter__()
            open_ranges.append(rf)

        def leave(mod, args, out):
            open_ranges.pop().__exit__(None, None, None)

        for mod in self.trainer.model.modules():
            if isinstance(mod, BatchNorm):
                handles.append(mod.register_forward_pre_hook(enter))
                handles.append(mod.register_forward_hook(leave))
        return handles

    def run(self, state, x, y, steps: int = 2):
        import functools

        from torch.autograd.profiler import record_function
        from torch.profiler import ProfilerActivity, profile

        from dtf_tpu_torch.train import loop

        def ranged(fn):
            @functools.wraps(fn)
            def wrapped(*a, **kw):
                with record_function("optimizer"):
                    return fn(*a, **kw)
            return wrapped

        tx, apply = self.trainer.tx, loop.apply_updates
        self.trainer.tx = tx._replace(update=ranged(tx.update))
        loop.apply_updates = ranged(apply)
        handles = self._bn_hooks()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(steps):
                    state, m = self.trainer.train_step(state, x, y)
                float(m["loss"])
                wall = time.perf_counter() - t0
        finally:
            self.trainer.tx, loop.apply_updates = tx, apply
            for h in handles:
                h.remove()
        return self.summarize(prof, steps, wall), state

    @staticmethod
    def ancestors(ev):
        while ev is not None:
            yield ev
            ev = ev.cpu_parent

    def bn_sequence(self, events):
        """Sequence numbers of the forward ops inside a BN range: their
        autograd nodes' evaluate_function events carry the same."""
        return {ev.sequence_nr for ev in events
                if ev.sequence_nr >= 0
                and any(a.name == "batch_norm" for a in self.ancestors(ev))}

    def kind_of(self, ev, kernel_name: str, bn_seq) -> str:
        """The kind of a kernel that the CPU op ``ev`` launched."""
        chain = list(self.ancestors(ev))
        names = [a.name for a in chain]
        if "optimizer" in names:
            return "optimizer"
        if "batch_norm" in names or any(
                a.name.startswith("autograd::engine::evaluate_function")
                and a.sequence_nr in bn_seq for a in chain):
            return "BatchNorm"
        if any("convolution" in n for n in names):
            return "convolution (cuDNN)"
        k = kernel_name.lower()
        if "reduce" in k:
            return "reductions"
        if any(t in k for t in ("memcpy", "memset", "copy", "fill")):
            return "copies"
        return "elementwise"

    def summarize(self, prof, steps: int, wall: float):
        from torch.autograd import DeviceType

        events = prof.events()
        # the ranges' own spans on the device timeline are no work
        busy = sum(ev.time_range.elapsed_us() for ev in events
                   if ev.device_type == DeviceType.CUDA
                   and not getattr(ev, "is_user_annotation", False)
                   and ev.name not in ("batch_norm", "optimizer"))
        cpu = [ev for ev in events if ev.device_type == DeviceType.CPU]
        bn_seq = self.bn_sequence(cpu)
        by_kind = dict.fromkeys(self.KINDS, 0.0)
        by_name = {}
        for ev in cpu:
            for k in getattr(ev, "kernels", ()):
                ms = k.duration / 1e3 / steps
                by_kind[self.kind_of(ev, k.name, bn_seq)] += ms
                by_name[k.name] = by_name.get(k.name, 0.0) + ms
        attributed = sum(by_kind.values())
        return {"steps": steps, "wall_ms_per_step": wall * 1e3 / steps,
                "device_busy_ms_per_step": busy / 1e3 / steps,
                "device_idle_share": max(0.0, 1 - busy / 1e6 / wall),
                "device_ms_per_step_by_kind": by_kind,
                "unattributed_ms_per_step": busy / 1e3 / steps - attributed,
                "top_kernels_ms_per_step": [
                    [n[:90], ms] for n, ms in sorted(
                        by_name.items(), key=lambda kv: -kv[1])[:10]]}


def profile_resnets(torch, seed: int, card: str, step_s: dict):
    """Two training steps each of resnet56 at batch 128 and resnet50 at
    batch 256 (bf16) under torch.profiler: device time per step by kind,
    the device's idle share of the profiled steps (the profiler and its
    ranges slow the host) and of the unprofiled step-time p50 in
    ``step_s`` (the main's run).  Raises where the profiler sees no
    convolution kernel."""
    out = {}
    for name, batch in (("resnet56", 128), ("resnet50", 256)):
        trainer, state, x, y = vision_trainer(torch, seed, name, batch)
        state, m = trainer.train_step(state, x, y)
        float(m["loss"])
        summary, state = VisionProfile(trainer).run(state, x, y)
        busy_s = summary["device_busy_ms_per_step"] / 1e3
        line = {"phase": "resnet_profile", "card": card, "model": name,
                "dtype": "bf16", "batch": batch, **summary,
                "step_s_p50_unprofiled": step_s.get(name),
                "device_idle_share_at_p50": (
                    max(0.0, 1 - busy_s / step_s[name]) if name in step_s
                    else None)}
        emit(line)
        if not summary["device_ms_per_step_by_kind"]["convolution (cuDNN)"]:
            raise RuntimeError(f"profiler saw no convolution kernel for "
                               f"{name}: {line}")
        out[name] = line
        del trainer, state, x, y
        torch.cuda.empty_cache()
    return out


def check_resnet_stem(torch, timer, seed: int, card: str):
    """ResNet-50's stem, forward and backward (the weight's gradient) at
    [256, 224, 224, 3] bf16: space-to-depth (the default) against the
    plain 7x7/2 on the same weight.  Outputs within two bf16 steps of
    each row's largest value (``compare``)."""
    from dtf_tpu_torch.models.resnet import Stem

    gen = torch.Generator().manual_seed(seed)
    stems = {}
    for s2d in (True, False):
        stem = Stem(64, space_to_depth=s2d, dtype=torch.bfloat16)
        stems["space_to_depth" if s2d else "plain"] = stem
    w = torch.randn(stems["plain"].weight.shape, generator=gen) * 0.05
    for stem in stems.values():
        with torch.no_grad():
            stem.weight.copy_(w)
        stem.cuda()
    x = torch.randn(256, 224, 224, 3, generator=gen).cuda().bfloat16()
    outs, ms = {}, {}
    for name, stem in stems.items():
        with torch.no_grad():
            outs[name] = stem(x)
        cot = torch.ones_like(outs[name])

        def step(xx, stem=stem, cot=cot):
            stem(xx).backward(cot)

        ms[name] = timer.ms(step, rotated([x], x.numel() * x.element_size()))
    err, tol, ratio = compare(torch, outs["space_to_depth"], outs["plain"])
    line = {"phase": "resnet_stem", "card": card,
            "shape": [256, 224, 224, 3], "dtype": "bf16",
            "fwd_bwd_ms": ms, "max_abs_diff": err,
            "tol_nearest_row": tol, "worst_err_over_tol": ratio}
    emit(line)
    if not ratio <= 1.0:
        raise AssertionError(f"space-to-depth stem against the plain "
                             f"conv: {line}")
    del stems, outs, x
    torch.cuda.empty_cache()
    return line


def train_cifar_files(torch, seed: int, card: str):
    """``cli.cifar_main.main --data_dir`` on the uint8 wire: five train
    files of 256 images and a test file of 1000, written with the port's
    ``write_binary_file`` into a temporary directory; 10 steps of
    resnet56 bf16 at batch 128, then the eval, which must count each of
    the 1000 test examples once (the last of its 8 batches is masked)."""
    import tempfile

    import numpy as np

    from dtf_tpu_torch.cli import cifar_main
    from dtf_tpu_torch.data.cifar import write_binary_file

    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as root:
        d = os.path.join(root, "cifar-10-batches-bin")
        os.makedirs(d)
        for i in range(1, 6):
            write_binary_file(os.path.join(d, f"data_batch_{i}.bin"),
                              rng.integers(0, 256, (256, 32, 32, 3)),
                              rng.integers(0, 10, 256))
        test_n = 1000
        write_binary_file(os.path.join(d, "test_batch.bin"),
                          rng.integers(0, 256, (test_n, 32, 32, 3)),
                          rng.integers(0, 10, test_n))
        t0 = time.perf_counter()
        stats = cifar_main.main(["--data_dir", root, "--device", "cuda",
                                 "--model", "resnet56", "--dtype", "bf16",
                                 "--batch_size", "128", "--train_steps",
                                 "10", "--log_steps", "5", "--seed",
                                 str(seed), "--skip_checkpoint"])
        wall = time.perf_counter() - t0
    losses = [v for _, v in stats["train_loss_log"]]
    line = {"phase": "train_cifar_files", "card": card, "model": "resnet56",
            "dtype": "bf16", "wire": "uint8", "batch": 128, "steps": 10,
            "losses": stats["train_loss_log"],
            "eval_loss": stats.get("eval_loss"),
            "eval_top1": stats.get("accuracy_top_1"),
            "eval_count": stats.get("eval_count"), "test_examples": test_n,
            "wall_s": wall}
    emit(line)
    if not (losses and all(math.isfinite(v) for v in losses)
            and math.isfinite(stats["eval_loss"])
            and stats.get("eval_count") == test_n):
        raise AssertionError(f"cifar_main on written files: {line}")
    torch.cuda.empty_cache()
    return line


def train_resnet(torch, timer, seed: int, card: str):
    """Phase 7, in order: the f32 check, determinism, the two mains,
    the profile (at the mains' step times), the stem, the record
    files; returns the mains' step-time p50s by model."""
    check_resnet_f32(torch, seed, card)
    check_resnet_determinism(torch, seed, card)
    step_s = {"resnet56": train_cifar(torch, seed, card)["step_s_p50"],
              "resnet50": train_imagenet(torch, seed, card)[0]["step_s_p50"]}
    profile_resnets(torch, seed, card, step_s)
    check_resnet_stem(torch, timer, seed, card)
    train_cifar_files(torch, seed, card)
    return step_s


# ---------------------------------------------------------------------------
# phase 8: data parallelism (runtime/mesh.py, cli/launch.py)
# ---------------------------------------------------------------------------

# one rank of a phase-8 run: an entry point's main (or, with a backend
# named, the runner on initialize(cfg, backend=...)), the kernels'
# counters zeroed just before and read just after, then one line of
# results: the per-step losses, the synced step times, the launches and
# a digest of the trained parameters and buffers
DP_RANK = r"""
import hashlib, json, os, sys, time
sys.path.insert(0, @ROOT@)
import torch
from dtf_tpu_torch.cli import runner
from dtf_tpu_torch.config import parse_flags
from dtf_tpu_torch.obs.registry import default_registry
from dtf_tpu_torch.ops import flash_attention as fa
from dtf_tpu_torch.runtime.mesh import initialize

spec = json.loads(sys.argv[1])
if os.environ.get("DTF_RESTART_GENERATION", "0") != "0":
    spec["argv"] = spec["argv"] + spec.get("argv_restart", [])
if spec.get("layers"):
    import functools
    from dtf_tpu_torch.models import registry
    name = spec.get("layers_model", "transformer_tpu")
    ctor, classes, l2 = registry._REGISTRY[name]
    registry._REGISTRY[name] = (
        functools.partial(ctor, num_layers=spec["layers"]), classes, l2)
kept = {}
build = runner.build_training
def keep(cfg, rt=None):
    out = build(cfg, rt)
    kept["trainer"] = out[0]
    if spec.get("go"):
        # started early (the process group joined, the model built and
        # placed); the steps wait for the caller's go, so their times
        # are their own
        open(spec["go"] + ".ready", "w").close()
        while not os.path.exists(spec["go"]):
            time.sleep(0.05)
        kept["t0"] = time.perf_counter()
    return out
runner.build_training = keep
main = __import__("dtf_tpu_torch.cli." + spec["main"], fromlist=["main"])
if spec["backend"]:
    from dtf_tpu_torch.plan import resolve_plan
    # --plan's flags first: the runtime's grid is built from them
    cfg = resolve_plan(parse_flags(spec["argv"],
                                   defaults=getattr(main, spec["defaults"])))
    run = lambda: runner.run(cfg, initialize(cfg, backend=spec["backend"]))
else:
    run = lambda: main.main(spec["argv"])
fa.launches = fa.launches_dq = fa.launches_dkdv = fa.launches_fused = 0
reg = default_registry()
ring0 = [reg.counter(n).value for n in ("ring_shift_calls",
                                        "ring_shift_bytes",
                                        "pipeline_broadcast_calls",
                                        "pipeline_broadcast_bytes",
                                        "all_to_all_calls",
                                        "all_to_all_bytes")]
t0 = time.perf_counter()
stats = run()
if torch.cuda.is_available():
    torch.cuda.synchronize()
wall = time.perf_counter() - kept.get("t0", t0)
trainer = kept["trainer"]
digest = hashlib.sha256()
# the leaves every rank holds whole (a sharded model's split is None)
replicated = hashlib.sha256()
split = getattr(trainer.model, "split", lambda name: None)
for name, t in trainer.model.state_dict().items():
    raw = t.detach().float().cpu().contiguous().numpy().tobytes()
    digest.update(raw)
    if split(name) is None:
        replicated.update(raw)
moe = getattr(trainer.model, "moe_layers", [])
print("DP_RESULT=" + json.dumps({
    "rank": trainer.rt.rank, "replicas": trainer.rt.num_replicas,
    "model_parallelism": trainer.rt.model_parallelism,
    "seq_parallelism": trainer.rt.seq_parallelism,
    "ring_shift": {"calls": reg.counter("ring_shift_calls").value - ring0[0],
                   "bytes": reg.counter("ring_shift_bytes").value - ring0[1]},
    "pipeline_broadcast": {
        "calls": reg.counter("pipeline_broadcast_calls").value - ring0[2],
        "bytes": reg.counter("pipeline_broadcast_bytes").value - ring0[3]},
    "all_to_all": {"calls": reg.counter("all_to_all_calls").value - ring0[4],
                   "bytes": reg.counter("all_to_all_bytes").value - ring0[5]},
    "moe_dropped_share": (sum(float(m.dropped) for m in moe)
                          / sum(m.routed for m in moe) if moe else None),
    "replicated_digest": replicated.hexdigest(),
    "microbatches": getattr(trainer.model, "num_microbatches", None),
    "backend": trainer.rt.backend, "device": str(trainer.rt.device),
    "threads": torch.get_num_threads(),
    "losses": [v for _, v in stats["train_loss_log"]],
    "window_step_s": stats["window_step_s"], "wall_s": wall,
    "launches": {"K1": fa.launches, "K2a": fa.launches_dq,
                 "K2b": fa.launches_dkdv, "K3": fa.launches_fused},
    "zero_stage": trainer.zero_stage,
    "resident": stats.get("resident_bytes"),
    "zero_probe": stats.get("zero_probe"),
    "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                          if torch.cuda.is_available() else 0),
    "digest": digest.hexdigest()}))
""".replace("@ROOT@", repr(ROOT))
DP_TIMEOUT_S = 300
# phase 8's world-1 LM arms and phase 11's LM worker run transformer_tpu
# at 6 of its 12 layers, every width kept, to make room for phase 16
# within the script's budget; none of their gates depends on depth
DP_LM_LAYERS = 6


def dp_results(texts, what: str):
    out = []
    for text in texts:
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("DP_RESULT=")]
        if not lines:
            raise AssertionError(f"{what}: a rank printed no result:\n"
                                 f"{text[-3000:]}")
        out.append(json.loads(lines[-1][len("DP_RESULT="):]))
    return sorted(out, key=lambda r: r["rank"])


def dp_run(spec: dict, world, root: str, what: str):
    """The rank script under ``spec``: through the port's launcher with
    ``world`` ranks (a file rendezvous under ``root``), or, for None,
    one plain process with no topology.  A rank that fails, or a run
    past ``DP_TIMEOUT_S``, fails the phase."""
    from dtf_tpu_torch.cli.launch import launch_local

    cmd = [sys.executable, "-c", DP_RANK, json.dumps(spec)]
    if world is None:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=DP_TIMEOUT_S, cwd=ROOT)
        if proc.returncode:
            raise AssertionError(f"{what}: exit {proc.returncode}\n"
                                 f"{proc.stdout[-3000:]}")
        return dp_results([proc.stdout], what)
    log_dir = os.path.join(root, what.replace(" ", "_"))
    rdv = os.path.join(root, what.replace(" ", "_") + ".rendezvous")
    rc = launch_local(cmd, world, f"file://{rdv}", log_dir,
                      timeout_s=DP_TIMEOUT_S)
    texts = []
    for rank in range(world):
        with open(os.path.join(log_dir, f"log{rank}.log")) as f:
            texts.append(f.read())
    if rc:
        raise AssertionError(f"{what}: launcher exit {rc}\n" + "\n".join(
            t[-3000:] for t in texts))
    return dp_results(texts, what)


DP_TURNS = ("off", "multi_worker_mirrored", "multi_worker_mirrored", "off")


def dp_world_one_start(root: str, main: str, defaults: str, argv,
                       phase: str, layers=None) -> list:
    """The four processes of :func:`dp_world_one`'s turns, started now:
    ``main`` with ``--distribution_strategy off`` in a plain process and
    with ``multi_worker_mirrored`` through the launcher with one rank (a
    real NCCL group).  Each builds its model, then waits for its turn's
    go, so no turn pays a process start and each turn's steps run
    alone."""
    arms = {"off": None, "multi_worker_mirrored": 1}
    started = []
    for turn, strategy in enumerate(DP_TURNS):
        what = f"{phase} {strategy} {turn}"
        go = os.path.join(root, what.replace(" ", "_") + ".go")
        spec = {"main": main, "defaults": defaults, "backend": None,
                "argv": argv + ["--distribution_strategy", strategy],
                "layers": layers, "go": go}
        started.append((strategy, go, overlapped(
            dp_run, spec, arms[strategy], root, what)))
    return started


def dp_wait_ready(started: list) -> None:
    """Until every process of :func:`dp_world_one_start`'s lists has
    built its model and waits for its go (or has ended), so no turn's
    steps share the host with another process's start."""
    while not all(os.path.exists(go + ".ready") or fut.done()
                  for _, go, fut in started):
        time.sleep(0.05)


def dp_world_one(torch, card: str, started: list, phase: str, layers=None,
                 **extra):
    """The turns of :func:`dp_world_one_start`'s processes, one at a
    time: off, NCCL, NCCL, off.  Every run's per-step losses and weights
    bit for bit the first's; each arm's step-time p50 over its two runs'
    windows."""
    import concurrent.futures

    arms = {"off": None, "multi_worker_mirrored": 1}
    try:
        for _, go, fut in started:
            torch.cuda.empty_cache()
            open(go, "w").close()
            concurrent.futures.wait([fut])
    finally:
        # a turn that failed must not leave the others waiting
        for _, go, _ in started:
            open(go, "a").close()
    runs = [(strategy, res[0]) for (strategy, _, _), res in zip(
        started, gathered([fut for _, _, fut in started]))]
    windows = {s: [w for name, r in runs if name == s
                   for w in r["window_step_s"]] for s in arms}
    one = runs[1][1]
    line = {"phase": phase, "card": card, **extra, "layers": layers,
            "backend": one["backend"], "replicas": one["replicas"],
            "turns": [name for name, _ in runs],
            "step_s_p50_off": statistics.median(windows["off"]),
            "step_s_p50_nccl_world1": statistics.median(
                windows["multi_worker_mirrored"]),
            "step_s_p50_by_turn": [statistics.median(r["window_step_s"])
                                   for _, r in runs],
            "losses": one["losses"],
            "losses_bit_identical": all(r["losses"] == one["losses"]
                                        for _, r in runs),
            "params_bit_identical": all(r["digest"] == one["digest"]
                                        for _, r in runs),
            "launches_off": runs[0][1]["launches"],
            "launches_nccl_world1": one["launches"],
            "torch_threads": {name: r["threads"] for name, r in runs}}
    line["dp_cost_ms"] = 1e3 * (line["step_s_p50_nccl_world1"]
                                - line["step_s_p50_off"])
    emit(line)
    if not (one["backend"] == "nccl" and one["replicas"] == 1
            and line["losses_bit_identical"]
            and line["params_bit_identical"]
            and all(math.isfinite(v) for v in one["losses"])):
        raise AssertionError(f"{phase}: {line}")
    return line


DP_LOSS_RTOL = 1e-4   # resnet20 f32, 3 steps: the card against the CPU


def dp_two_ranks(torch, card: str, root: str, data_dir: str, seed: int):
    """resnet20 in float32 on the CIFAR files under ``data_dir`` (each
    rank its file shard), 3 steps at a global batch of 32, sync BN off
    and on: two ranks sharing the card over gloo (CUDA tensors), and
    the same two ranks on the CPU.  The ranks end bit-identical; the
    card's losses are within ``DP_LOSS_RTOL`` of the CPU's.  With two
    cards, the same runs over NCCL, one card a rank.  The runs go at
    once: each is gated on its own ranks and the CPU's losses, and no
    gate reads their step times."""
    lines = []
    cases = [("gloo_cuda", "cuda", "gloo"), ("gloo_cpu", "cpu", None)]
    if torch.cuda.device_count() >= 2:
        cases.append(("nccl_two_cards", "cuda", None))
    torch.cuda.empty_cache()
    started = {}
    for sync_bn in (False, True):
        argv = ["--data_dir", data_dir, "--model", "resnet20", "--dtype",
                "fp32", "--batch_size", "32", "--train_steps", "3",
                "--log_steps", "1", "--skip_eval", "--seed", str(seed),
                "--skip_checkpoint",
                "--distribution_strategy", "multi_worker_mirrored",
                "--sync_bn", str(sync_bn).lower()]
        for name, device, backend in cases:
            spec = {"main": "cifar_main", "defaults": "CIFAR_DEFAULTS",
                    "backend": backend, "argv": argv + ["--device", device]}
            started[sync_bn, name] = overlapped(
                dp_run, spec, 2, root,
                f"dp two ranks {name} sync_bn {sync_bn}")
    done = dict(zip(started, gathered(list(started.values()))))
    for sync_bn in (False, True):
        runs = {name: done[sync_bn, name] for name, *_ in cases}
        cpu = runs["gloo_cpu"][0]["losses"]
        for name, ranks in runs.items():
            gap = max(abs(a - b) / abs(b)
                      for a, b in zip(ranks[0]["losses"], cpu))
            line = {"phase": "dp_two_ranks", "card": card, "run": name,
                    "sync_bn": sync_bn, "model": "resnet20",
                    "dtype": "fp32", "global_batch": 32, "steps": 3,
                    "backend": ranks[0]["backend"],
                    "devices": [r["device"] for r in ranks],
                    "losses": ranks[0]["losses"],
                    "ranks_bit_identical": (
                        ranks[0]["digest"] == ranks[1]["digest"]
                        and ranks[0]["losses"] == ranks[1]["losses"]),
                    "loss_rel_gap_to_cpu": gap, "tol": DP_LOSS_RTOL,
                    "step_s_p50": statistics.median(
                        ranks[0]["window_step_s"])}
            emit(line)
            lines.append(line)
            if not (line["ranks_bit_identical"] and gap <= DP_LOSS_RTOL
                    and [r["replicas"] for r in ranks] == [2, 2]):
                raise AssertionError(f"dp_two_ranks: {line}")
    if torch.cuda.device_count() < 2:
        emit({"phase": "dp_nccl_multi_card", "measured": False,
              "reason": f"{torch.cuda.device_count()} card on this "
                        f"machine; NCCL across cards is unmeasured"})
    return lines


def train_data_parallel(torch, seed: int, card: str):
    """Phase 8: (a) ``cifar_main`` resnet56 and ``lm_main``
    transformer_tpu, bf16, ``multi_worker_mirrored`` at world 1 through
    the launcher (NCCL) against ``off``: losses and parameters bit for
    bit, both step times, K1 and K3 launches on the LM's data-parallel
    path; (b) two ranks sharing the card over gloo, sync BN off and on,
    against the same ranks on the CPU; (c) NCCL across two cards where
    there are two, else a line saying it is unmeasured."""
    import tempfile

    import numpy as np

    from dtf_tpu_torch.data.cifar import write_binary_file

    steps = 20
    b = TRAIN_SHAPE[0]
    with tempfile.TemporaryDirectory() as root:
        # both arms' eight processes start together; their turns run
        # one at a time
        cifar_started = dp_world_one_start(
            root, "cifar_main", "CIFAR_DEFAULTS",
            ["--use_synthetic_data", "--device", "cuda", "--model",
             "resnet56", "--dtype", "bf16", "--batch_size", "128",
             "--train_steps", str(steps), "--log_steps", "1",
             "--skip_eval", "--seed", str(seed), "--skip_checkpoint"],
            "dp_world1_cifar")
        lm_started = dp_world_one_start(
            root, "lm_main", "LM_DEFAULTS",
            ["--use_synthetic_data", "--device", "cuda", "--model",
             "transformer_tpu", "--dtype", "bf16", "--batch_size", str(b),
             "--train_steps", str(steps), "--log_steps", "1", "--seed",
             str(seed), "--skip_checkpoint"],
            "dp_world1_lm", layers=DP_LM_LAYERS)
        dp_wait_ready(cifar_started + lm_started)
        try:
            cifar = dp_world_one(
                torch, card, cifar_started, "dp_world1_cifar",
                model="resnet56", dtype="bf16", batch=128, steps=steps)
        finally:
            # the LM's turns run (and their processes end) whatever the
            # CIFAR arm's verdict
            lm = dp_world_one(
                torch, card, lm_started, "dp_world1_lm",
                layers=DP_LM_LAYERS, model="transformer_tpu", dtype="bf16",
                batch=b, seq=TRAIN_SHAPE[1], steps=steps)
        n = DP_LM_LAYERS * steps
        want = {"K1": n, "K2a": 0, "K2b": 0, "K3": n}
        if lm["launches_nccl_world1"] != want:
            raise AssertionError(f"dp_world1_lm launches "
                                 f"{lm['launches_nccl_world1']}, expected "
                                 f"{want}")
        rng = np.random.default_rng(seed)
        d = os.path.join(root, "cifar-10-batches-bin")
        os.makedirs(d)
        for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
                "test_batch.bin"]:
            write_binary_file(os.path.join(d, name),
                              rng.integers(0, 256, (64, 32, 32, 3)),
                              rng.integers(0, 10, 64))
        two = dp_two_ranks(torch, card, root, root, seed)
    return {"cifar": cifar, "lm": lm, "two_ranks": two}


# phase 9: recovery (train/checkpoint.py, chaos/, cli/launch.py supervision)
# ---------------------------------------------------------------------------

# one process of a phase-9 run under the launcher: the main with the
# kernels' counters zeroed just before, then one line of results -- the
# step it resumed at, its per-step losses, its launches, a digest of the
# trained state dict, its checkpoint save and restore times, and (when
# asked) greedy tokens served from the trained parameters as they are
# held in memory, through serve_main's engine
RECOVERY_RANK = r"""
import hashlib, json, sys, time
T0 = time.time()
sys.path.insert(0, @ROOT@)
import numpy as np
import torch
from dtf_tpu_torch.cli import runner
from dtf_tpu_torch.ops import flash_attention as fa
from dtf_tpu_torch.ops import paged_attention as pa

spec = json.loads(sys.argv[1])
if spec.get("layers"):
    import functools
    from dtf_tpu_torch.models import registry
    ctor, classes, l2 = registry._REGISTRY["transformer_tpu"]
    registry._REGISTRY["transformer_tpu"] = (
        functools.partial(ctor, num_layers=spec["layers"]), classes, l2)
kept = {}
build, checkpointing = runner.build_training, runner._checkpointing
def keep_build(cfg, rt=None):
    out = build(cfg, rt)
    kept["trainer"] = out[0]
    return out
def keep_checkpointing(cfg, trainer, rt, state):
    t = time.perf_counter()
    out = checkpointing(cfg, trainer, rt, state)
    kept.update(cb=out[0], resumed_step=out[2],
                restore_total_s=time.perf_counter() - t)
    return out
runner.build_training, runner._checkpointing = keep_build, keep_checkpointing
main = __import__("dtf_tpu_torch.cli." + spec["main"], fromlist=["main"])
fa.launches = fa.launches_dq = fa.launches_dkdv = fa.launches_fused = 0
pa.launches = 0
stats = main.main(spec["argv"])
if torch.cuda.is_available():
    torch.cuda.synchronize()
launches = {"K1": fa.launches, "K2a": fa.launches_dq,
            "K2b": fa.launches_dkdv, "K3": fa.launches_fused,
            "K4": pa.launches}
trainer = kept["trainer"]
digest = hashlib.sha256()
for t in trainer.model.state_dict().values():
    digest.update(t.detach().float().cpu().contiguous().numpy().tobytes())
out = {"process_start": T0, "resumed_step": kept["resumed_step"],
       "losses": stats["train_loss_log"], "launches": launches,
       "digest": digest.hexdigest(), "timings": kept["cb"].ckpt.timings,
       "restore_total_s": kept["restore_total_s"]}
if spec.get("serve_argv"):
    from dtf_tpu_torch.cli.serve_main import build_serving_engine
    from dtf_tpu_torch.config import parse_flags
    model, engine = build_serving_engine(parse_flags(spec["serve_argv"]),
                                         random_init=True)
    # the trained parameters as they are held in memory
    model.load_state_dict(trainer.model.state_dict())
    try:
        handles = [engine.submit(np.asarray(p, np.int32),
                                 max_new_tokens=spec["serve_new"])
                   for p in spec["serve_prompts"]]
        out["served_tokens"] = [h.result(timeout=600).tokens
                                for h in handles]
    finally:
        engine.stop(drain=False)
print("RECOVERY_RESULT=" + json.dumps(out))
""".replace("@ROOT@", repr(ROOT))
RECOVERY_TIMEOUT_S = 400
RECOVERY_STEPS = 8


def trace_losses(trace_dir: str) -> dict:
    """{step: [the distinct losses logged at it]} over every attempt's
    ``train_loss`` events (``obs/trace.py``)."""
    from dtf_tpu_torch.obs.trace import read_records

    out: dict = {}
    for rec in read_records(os.path.join(trace_dir, "trace_rank0.jsonl")):
        if rec.get("name") == "train_loss":
            out.setdefault(int(rec["step"]), set()).add(rec["loss"])
    return {k: sorted(v) for k, v in sorted(out.items())}


def recovery_run(root: str, what: str, main: str, argv, fault=None,
                 serve=None, strategy: str = "off", layers=None,
                 spawn=None) -> dict:
    """``main`` under the port's launcher, one rank of ``strategy``,
    with sealed checkpoints every 2 steps into a fresh model dir and a
    trace; with ``fault``, ``--resume --fault <fault>`` and one restart.
    Returns the last attempt's result line, the losses of the trace,
    the supervisor's events and the run's directories."""
    from dtf_tpu_torch.cli.launch import launch_local, popen_rank

    base = os.path.join(root, what)
    model_dir, trace_dir = base + "_model", base + "_trace"
    log_dir = base + "_logs"
    flags = ["--model_dir", model_dir, "--trace_dir", trace_dir,
             "--checkpoint_steps", "2", "--checkpoint_keep", "2",
             "--step_time_guard_factor", "0", "--log_steps", "1",
             "--train_steps", str(RECOVERY_STEPS),
             "--distribution_strategy", strategy]
    if fault:
        flags += ["--resume", "--fault", fault]
    spec = {"main": main, "argv": argv + flags, "layers": layers}
    if serve:
        spec.update(serve)
    t0 = time.time()
    rc = launch_local([sys.executable, "-c", RECOVERY_RANK,
                       json.dumps(spec)], 1,
                      f"file://{base}.rendezvous", log_dir,
                      timeout_s=RECOVERY_TIMEOUT_S,
                      max_restarts=1 if fault else 0,
                      restart_backoff_s=0.1, teardown_grace=30,
                      spawn=spawn or popen_rank)
    wall = time.time() - t0
    logs = sorted(n for n in os.listdir(log_dir) if n.startswith("log0"))
    with open(os.path.join(log_dir, logs[-1])) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines()
             if ln.startswith("RECOVERY_RESULT=")]
    if rc or not lines:
        raise AssertionError(f"{what}: launcher exit {rc}, "
                             f"{len(lines)} result line(s):\n"
                             f"{text[-3000:]}")
    with open(os.path.join(log_dir, "supervisor_events.jsonl")) as f:
        events = [json.loads(ln) for ln in f if ln.strip()]
    return {"result": json.loads(lines[-1][len("RECOVERY_RESULT="):]),
            "losses": trace_losses(trace_dir), "events": events,
            "model_dir": model_dir, "trace_dir": trace_dir, "wall_s": wall}


def final_payload_sha(model_dir: str) -> str:
    """The sealed manifest's sha256 of the newest step's payload (the
    bytes of ``torch.save``, which writes the same bytes for the same
    tensors)."""
    from dtf_tpu_torch.train.checkpoint import (PAYLOAD, read_manifest,
                                                step_dirs)

    ckpt = os.path.join(model_dir, "checkpoints")
    return read_manifest(ckpt, step_dirs(ckpt)[-1])["files"][PAYLOAD][
        "sha256"]


def first_step_after_restart(run: dict) -> float:
    """Seconds from the supervisor's restart to the resumed process's
    first logged step (its first ``train_loss`` event: a synced step)."""
    from dtf_tpu_torch.obs.trace import read_records

    restart = next(e["ts"] for e in run["events"]
                   if e["event"] == "restart")
    recs = read_records(os.path.join(run["trace_dir"], "trace_rank0.jsonl"))
    last_start = max(i for i, r in enumerate(recs)
                     if r.get("name") == "trace_start")
    first = next(r["ts"] for r in recs[last_start:]
                 if r.get("name") == "train_loss")
    return first - restart


def quiet(fn, *args):
    """``fn(*args)`` with its standard output and error dropped."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return fn(*args)


def check_recovered(what: str, base: dict, run: dict, fault: str,
                    resumed_at: int, classification: str) -> dict:
    """A faulted run against its uninterrupted twin: exit 0 after one
    restart of ``classification``, resumed at ``resumed_at``, the losses
    at every step equal as floats, the final state dicts' and final
    checkpoints' digests equal, ``trace_main --check --allow
    injected_fault`` green (and red without the allowance)."""
    from dtf_tpu_torch.cli.trace_main import main as trace_main

    restarts = [e for e in run["events"] if e["event"] == "restart"]
    first_exit = next(e["code"] for e in run["events"]
                      if e["event"] == "rank_exit")
    res, want = run["result"], base["result"]
    line = {
        "fault": fault, "first_exit_code": first_exit,
        "restarts": [e["classification"] for e in restarts],
        "crashes_in_window": [e["crashes_in_window"] for e in restarts],
        "resumed_step": res["resumed_step"],
        "losses": base["losses"],
        "losses_bit_identical": (run["losses"] == base["losses"] and all(
            len(v) == 1 for v in run["losses"].values())
            and sorted(run["losses"]) == list(range(1, RECOVERY_STEPS + 1))),
        "state_dict_sha_equal": res["digest"] == want["digest"],
        "final_checkpoint_sha_equal": (final_payload_sha(run["model_dir"])
                                       == final_payload_sha(
                                           base["model_dir"])),
        "trace_check_allowing_fault": quiet(
            trace_main, [run["trace_dir"], "--check", "--allow",
                         "injected_fault"]),
        "trace_check": quiet(trace_main, [run["trace_dir"], "--check"]),
        "launches_resumed_process": res["launches"],
        "wall_s": run["wall_s"], "baseline_wall_s": base["wall_s"]}
    ok = (line["restarts"] == [classification]
          and first_exit == {"crash": 77, "preempted": 75}[classification]
          and line["resumed_step"] == resumed_at
          and line["losses_bit_identical"]
          and line["state_dict_sha_equal"]
          and line["final_checkpoint_sha_equal"]
          and line["trace_check_allowing_fault"] == 0
          and line["trace_check"] == 1
          and (classification != "preempted"
               or line["crashes_in_window"] == [0]))
    if not ok:
        raise AssertionError(f"{what}: {line}")
    return line


def train_recovery(torch, seed: int, card: str, spawn=None):
    """Phase 9: crash-exact recovery through the entry points.

    (a) ``lm_main`` transformer_tpu bf16 at batch 8 x 2048 under the
    launcher, one ``multi_worker_mirrored`` rank on NCCL: 8 steps
    uninterrupted, sealed checkpoints every 2; then
    from an empty model dir the same with ``--fault crash@step:4
    --max_restarts 1``: exit 0, resumed at step 4, losses equal at every
    step, state digests equal, K1 and K3 launched by the resumed
    process (12 each a step).  A crash fires on its exact step in every
    process, so it lands on a checkpoint boundary: a crash at step 5
    resumes at 4 and dies at 5 again.  (b) ``cifar_main`` resnet56 bf16
    at batch 128 on written CIFAR files the same way (BN buffers, Keras
    SGD momentum, cuDNN), and (c) with ``sigterm@step:3``: exit 75 with
    an emergency checkpoint at step 3, restarted outside the crash
    budget, the same trajectory.  (d) ``serve_main --model_dir`` on the
    LM's checkpoint: greedy tokens equal those served from the trained
    parameters held in memory; K1 and K4 launched.  (e) Save, restore
    and restart times and bytes a step.  The uninterrupted runs of (a)
    and (b) go at once, and (b)'s crash run beside (d); the LM's faulted
    run and (c) go alone: (e) reads their times."""
    import shutil
    import tempfile

    import numpy as np

    from dtf_tpu_torch.cli import serve_main
    from dtf_tpu_torch.cli.serve_main import build_serving_engine
    from dtf_tpu_torch.config import parse_flags
    from dtf_tpu_torch.data.cifar import write_binary_file
    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import paged_attention as pa
    from dtf_tpu_torch.runtime.mesh import TIMEOUT_S

    tmp = tempfile.gettempdir()
    usage = shutil.disk_usage(tmp)
    emit({"phase": "recovery_disk", "dir": tmp, "free_bytes": usage.free,
          "total_bytes": usage.total})
    rng = np.random.default_rng(seed + 9)
    n_new = 16
    prompts = [rng.integers(0, 32768, (n,)).tolist() for n in (1, 17, 300)]
    serve_argv = ["--model", "transformer_tpu", "--dtype", "bf16",
                  "--device", "cuda", "--seed", str(seed),
                  "--serve_max_batch", "4"]
    b = TRAIN_SHAPE[0]
    lm_argv = ["--use_synthetic_data", "--device", "cuda", "--model",
               "transformer_tpu", "--dtype", "bf16", "--batch_size", str(b),
               "--seed", str(seed)]
    lines = {}
    with tempfile.TemporaryDirectory() as root:
        torch.cuda.empty_cache()
        # the CIFAR files of (b) and (c), and resnet56's uninterrupted
        # run beside the LM's: the two baselines, each read only beside
        # its faulted twin
        d = os.path.join(root, "cifar-10-batches-bin")
        os.makedirs(d)
        for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
                "test_batch.bin"]:
            write_binary_file(os.path.join(d, name),
                              rng.integers(0, 256, (256, 32, 32, 3)),
                              rng.integers(0, 10, 256))
        rn_argv = ["--data_dir", root, "--device", "cuda", "--model",
                   "resnet56", "--dtype", "bf16", "--batch_size", "128",
                   "--skip_eval", "--seed", str(seed)]
        rn_base_run = overlapped(recovery_run, root, "resnet_base",
                                 "cifar_main", rn_argv, spawn=spawn)
        # one rank of a data-parallel run: the NCCL group, the flat
        # all-reduce, the barrier behind each save, the restore's
        # broadcast of the chosen step
        dp = "multi_worker_mirrored"
        lm_base, rn_base = gathered([
            overlapped(recovery_run, root, "lm_base", "lm_main", lm_argv,
                       strategy=dp, layers=DP_LM_LAYERS, spawn=spawn),
            rn_base_run])
        # the LM's faulted run alone: its save, restore and restart
        # times are the phase's measurements
        lm = recovery_run(root, "lm_crash", "lm_main", lm_argv,
                          fault="crash@step:4", strategy=dp,
                          serve={"serve_argv": serve_argv,
                                 "serve_prompts": prompts,
                                 "serve_new": n_new},
                          layers=DP_LM_LAYERS)
        line = check_recovered("recovery_lm", lm_base, lm, "crash@step:4",
                               4, "crash")
        steps_run = RECOVERY_STEPS - 4
        want = {"K1": DP_LM_LAYERS * steps_run, "K2a": 0, "K2b": 0,
                "K3": DP_LM_LAYERS * steps_run, "K4": 0}
        if line["launches_resumed_process"] != want:
            raise AssertionError(f"recovery_lm: resumed process launched "
                                 f"{line['launches_resumed_process']}, "
                                 f"expected {want}")
        lines["lm"] = {"phase": "recovery_lm", "card": card,
                       "model": "transformer_tpu", "layers": DP_LM_LAYERS,
                       "dtype": "bf16",
                       "batch": b, "seq": TRAIN_SHAPE[1],
                       "distribution_strategy": dp, "ranks": 1, **line}
        emit(lines["lm"])

        # (d) serving the LM's checkpoint through serve_main, while
        # resnet56's crash run goes (no gate reads its times)
        rn_crash_run = overlapped(recovery_run, root, "resnet_crash",
                                  "cifar_main", rn_argv,
                                  fault="crash@step:4", spawn=spawn)
        # the checkpoint's depth, as the runs were cut
        with fleet_depth(DP_LM_LAYERS):
            reset_counts(fa, pa)
            out = serve_main.main(serve_argv + [
                "--model_dir", lm["model_dir"], "--serve_requests", "4",
                "--serve_prompt_len", "64", "--serve_max_new_tokens",
                str(n_new)])
            served_launches = kernel_counts(fa, pa)
            model, engine = build_serving_engine(parse_flags(
                serve_argv + ["--model_dir", lm["model_dir"]]))
        try:
            handles = [engine.submit(np.asarray(p, np.int32),
                                     max_new_tokens=n_new) for p in prompts]
            tokens = [h.result(timeout=600).tokens for h in handles]
        finally:
            engine.stop(drain=False)
        del model, engine
        torch.cuda.empty_cache()
        lines["serve"] = {
            "phase": "recovery_serve", "card": card,
            "model_dir": "lm_crash_model", "requests": out["requests"],
            "new_tokens": out["new_tokens"], "launches": served_launches,
            "prompts": [len(p) for p in prompts], "tokens": tokens,
            "token_exact_to_memory": tokens == lm["result"]["served_tokens"]}
        emit(lines["serve"])
        crashed_run = rn_crash_run.result()
        if not (lines["serve"]["token_exact_to_memory"]
                and out["requests"] == 4 and out["shed"] == 0
                and min(served_launches["K1"], served_launches["K4"]) > 0):
            raise AssertionError(f"recovery_serve: {lines['serve']}, "
                                 f"in memory "
                                 f"{lm['result']['served_tokens']}")
        for run in (lm_base, lm):
            shutil.rmtree(run["model_dir"], ignore_errors=True)

        # (b), (c) resnet56 on the written CIFAR files; the preempted
        # run alone (its restart time is measured)
        for key, fault, at, cls in (
                ("resnet_crash", "crash@step:4", 4, "crash"),
                ("resnet_preempt", "sigterm@step:3", 3, "preempted")):
            run = crashed_run if key == "resnet_crash" else recovery_run(
                root, key, "cifar_main", rn_argv, fault=fault)
            line = check_recovered(f"recovery_{key}", rn_base, run, fault,
                                   at, cls)
            lines[key] = {"phase": f"recovery_{key}", "card": card,
                          "model": "resnet56", "dtype": "bf16",
                          "batch": 128, **line}
            emit(lines[key])

        # (e) the measurements, from the LM run (~1.1 GB a step at
        # DP_LM_LAYERS layers; 1.65 GB at 12)
        save = lm["result"]["timings"]["save"]
        restore = lm["result"]["timings"]["restore"]
        lines["measure"] = {
            "phase": "recovery_measure", "card": card,
            "model": "transformer_tpu", "bytes_per_step": save["bytes"],
            "save_ms": {k[:-2] + "_ms": 1e3 * save[k] for k in (
                "state_to_host_s", "payload_s", "fsync_s", "sha256_s",
                "total_s")},
            "restore_ms": {"verify_and_load_ms": 1e3 * restore["total_s"],
                           "with_state_to_device_ms":
                               1e3 * lm["result"]["restore_total_s"]},
            "restart_to_first_step_s": first_step_after_restart(lm),
            "resnet56_bytes_per_step": run["result"]["timings"]["save"][
                "bytes"],
            "resnet56_preempt_restart_to_first_step_s":
                first_step_after_restart(run),
            # the NCCL barrier every rank passes behind rank 0's save,
            # against the group's collective timeout
            "barrier_behind_save_ms": 1e3 * save["barrier_s"],
            "collective_timeout_s": TIMEOUT_S}
        emit(lines["measure"])

    return lines


# ---------------------------------------------------------------------------
# phase 10: ImageNet input (data/records.py, native/, data/imagenet.py,
# data/service) into ResNet-50, and fp16 on the CIFAR ResNet
# ---------------------------------------------------------------------------

IMAGENET_SIZE = (375, 500)     # ImageNet's typical photograph, H x W
IMAGENET_SHARDS = 8            # train files, one service shard each
IMAGENET_PER_FILE = 256        # 2,048 train images: a batch a shard-epoch
IMAGENET_VAL = (2, 150)        # 300 validation images: 2 batches, masked
IMAGENET_BATCH = 256


def write_imagenet(root: str, seed: int) -> dict:
    """The train and validation shards, one process a file: smooth
    375x500 JPEGs (they compress like photographs, ~10x a noise image's
    ratio) with a box each, from ``seed`` (``testing/imagenet.py``)."""
    import concurrent.futures
    import multiprocessing

    from dtf_tpu_torch.testing.imagenet import shard_files, write_shard_file

    files = shard_files(root, IMAGENET_SHARDS, IMAGENET_PER_FILE,
                        *IMAGENET_VAL)
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(len(files), os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        nbytes = sum(pool.map(
            write_shard_file, [f[0] for f in files], [f[1] for f in files],
            [IMAGENET_SIZE] * len(files), [seed * 1000 + f[3] for f in files],
            [True] * len(files), [f[2] for f in files]))
    train = IMAGENET_SHARDS * IMAGENET_PER_FILE
    return {"train_images": train,
            "validation_images": IMAGENET_VAL[0] * IMAGENET_VAL[1],
            "image_hw": list(IMAGENET_SIZE), "jpeg_bytes": nbytes,
            "mean_jpeg_bytes": nbytes / (train + IMAGENET_VAL[0]
                                         * IMAGENET_VAL[1]),
            "write_s": time.perf_counter() - t0}


def imagenet_input(root: str, seed: int, card: str, shards: dict) -> dict:
    """The data service's host rate on the written shards (batches of
    256 on the uint8 wire): inline, then with one spawned reader a
    core (``os.cpu_count()``, capped by the 8 shards), each after a
    warm-up; then two epochs through the decode-once cache with the
    same readers -- the first decodes and fills it, the second is
    served from it (its hit ratio, and its rate)."""
    import tempfile

    from dtf_tpu_torch import native
    from dtf_tpu_torch.data.service import ServiceStream
    from dtf_tpu_torch.obs.registry import MetricsRegistry

    workers = min(os.cpu_count() or 1, IMAGENET_SHARDS)

    def stream(num_workers, **kw):
        return ServiceStream(root, IMAGENET_BATCH, seed=seed,
                             num_shards=IMAGENET_SHARDS,
                             num_workers=num_workers,
                             registry=MetricsRegistry(), **kw)

    def rate(s, warm: int, batches: int) -> float:
        for _ in range(warm):
            next(s)
        t0 = time.perf_counter()
        for _ in range(batches):
            next(s)
        return batches * IMAGENET_BATCH / (time.perf_counter() - t0)

    s = stream(0)
    try:
        inline = rate(s, 1, 2)
    finally:
        s.close()
    t0 = time.perf_counter()
    s = stream(workers)
    try:
        next(s)
        first_batch_s = time.perf_counter() - t0
        pooled = rate(s, workers, 2 * workers)
    finally:
        s.close()
    epoch = IMAGENET_SHARDS      # one batch a shard an epoch
    with tempfile.TemporaryDirectory() as cache:
        s = stream(workers, cache_dir=cache)
        try:
            fill = rate(s, 0, epoch)
            cached = rate(s, 0, epoch)
            hits, lookups = s.cache_stats()
        finally:
            s.close()
    first_epoch = epoch * IMAGENET_BATCH   # every lookup of it a miss
    line = {"phase": "imagenet_input", "card": card, **shards,
            "decode_path": native.decode_path(),
            "decode_unavailable_reason": native.unavailable_reason or None,
            "batch": IMAGENET_BATCH, "wire": "uint8",
            "num_shards": IMAGENET_SHARDS, "cpu_count": os.cpu_count(),
            "cores_usable": len(os.sched_getaffinity(0)),
            "images_per_s_inline": inline,
            "workers": workers, "images_per_s_workers": pooled,
            "first_batch_s_workers": first_batch_s,
            "images_per_s_cache_fill": fill,
            "images_per_s_cache_epoch2": cached,
            "cache_hit_ratio_epoch2": hits / max(lookups - first_epoch, 1),
            "cache_lookups": lookups, "cache_hits": hits}
    emit(line)
    if not (line["cache_hit_ratio_epoch2"] > 0.99 and inline > 0
            and pooled > 0):
        raise AssertionError(f"imagenet_input: {line}")
    return line


def profile_device_ms(path: str) -> dict:
    """Device time in a ``--profile_steps`` Chrome trace: the kernels'
    durations (``cat`` "kernel") and the copies and sets."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    out = {"kernel_ms": 0.0, "memcpy_ms": 0.0, "kernels": 0}
    for ev in events:
        cat = ev.get("cat", "")
        if cat == "kernel":
            out["kernel_ms"] += ev.get("dur", 0) / 1e3
            out["kernels"] += 1
        elif cat in ("gpu_memcpy", "gpu_memset"):
            out["memcpy_ms"] += ev.get("dur", 0) / 1e3
    return out


def train_imagenet_files(torch, root: str, seed: int, card: str,
                         synthetic_p50) -> dict:
    """``cli.imagenet_main.main --data_dir``: resnet50 bf16 at batch 256
    on the written shards through the data service (default workers),
    20 steps with ``--profile_steps 2,3``, then the eval, which must
    count each validation record once: step p50 and images/s beside
    phase 7's synthetic run, the reader-lag gauge (the consumer's wait
    for the last batch), and the profiled steps' device time (a trace
    without device time fails the run)."""
    import tempfile

    from dtf_tpu_torch.cli import imagenet_main
    from dtf_tpu_torch.obs.registry import default_registry

    default_registry().reset()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as model_dir:
        t0 = time.perf_counter()
        stats = imagenet_main.main([
            "--data_dir", root, "--device", "cuda", "--dtype", "bf16",
            "--batch_size", str(IMAGENET_BATCH), "--train_steps", "20",
            "--log_steps", "5", "--seed", str(seed), "--skip_checkpoint",
            "--input_num_shards", str(IMAGENET_SHARDS),
            "--profile_steps", "2,3", "--model_dir", model_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = profile_device_ms(stats["profile_trace"])
    reg = default_registry()
    lag = reg.get("data_reader_lag_s")
    p50 = statistics.median(stats["window_step_s"])
    line = {"phase": "train_imagenet_files", "card": card,
            "model": "resnet50", "dtype": "bf16", "batch": IMAGENET_BATCH,
            "steps": 20, "wire": "uint8", "decode": stats["input_decode"],
            "losses": stats["train_loss_log"], "step_s_p50": p50,
            "window_step_s": stats["window_step_s"],
            "images_per_s": IMAGENET_BATCH / p50,
            "synthetic_step_s_p50": synthetic_p50,
            "synthetic_images_per_s": (IMAGENET_BATCH / synthetic_p50
                                       if synthetic_p50 else None),
            "step_over_synthetic": (p50 / synthetic_p50 if synthetic_p50
                                    else None),
            "reader_lag_s_last": lag.value if lag is not None else None,
            "profiled_steps": "2,3", "profile_device": prof,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "wall_s": wall}
    emit(line)
    eval_line = {"phase": "imagenet_eval", "card": card,
                 "eval_count": stats.get("eval_count"),
                 "records_written": IMAGENET_VAL[0] * IMAGENET_VAL[1],
                 "eval_loss": stats.get("eval_loss"),
                 "eval_top1": stats.get("accuracy_top_1")}
    emit(eval_line)
    losses = [v for _, v in stats["train_loss_log"]]
    if not (losses and all(math.isfinite(v) for v in losses)
            and prof["kernel_ms"] > 0
            and eval_line["eval_count"] == eval_line["records_written"]
            and math.isfinite(stats["eval_loss"])):
        raise AssertionError(f"train_imagenet_files: {line} {eval_line}")
    torch.cuda.empty_cache()
    return line


def imagenet_resume(torch, root: str, seed: int, card: str) -> dict:
    """resnet50 bf16 b256 on the shards under the launcher, 8 steps,
    sealed checkpoints every 2: uninterrupted with 4 readers; at the
    same time, with one reader a core, ``--fault crash@step:4,reader_crash@batch:6``
    and one restart -- the worker count differs from the uninterrupted
    run's, and the reader owning batch 6 is SIGKILLed and respawned (in
    the first attempt, in the resumed one, or both: the prefetcher may
    have reached batch 6 before the crash).  Every step's loss equal as
    a float, the state and final checkpoint digests equal, and at least
    one reader respawn in the supervisor's events."""
    import tempfile

    argv = ["--data_dir", root, "--device", "cuda", "--dtype", "bf16",
            "--batch_size", str(IMAGENET_BATCH), "--skip_eval",
            "--seed", str(seed), "--input_num_shards", str(IMAGENET_SHARDS)]
    workers = min(os.cpu_count() or 1, IMAGENET_SHARDS)
    fault = "crash@step:4,reader_crash@batch:6"
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.empty_cache()
        # the two runs at once: each is gated on its losses and digests
        # against the other, and no gate reads their times
        base, run = gathered([
            overlapped(recovery_run, tmp, "imagenet_base", "imagenet_main",
                       argv + ["--input_workers", "4"]),
            overlapped(recovery_run, tmp, "imagenet_crash", "imagenet_main",
                       argv + ["--input_workers", str(workers)],
                       fault=fault)])
        line = check_recovered("imagenet_resume", base, run, fault, 4,
                               "crash")
    respawns = [e for e in run["events"] if e["event"] == "reader_crash"]
    line = {"phase": "imagenet_resume", "card": card, "model": "resnet50",
            "dtype": "bf16", "batch": IMAGENET_BATCH,
            "workers_uninterrupted": 4, "workers_resumed": workers,
            "reader_respawns": len(respawns),
            "reader_respawn_positions": [e.get("shard_positions")
                                         for e in respawns], **line}
    emit(line)
    if not respawns:
        raise AssertionError(f"imagenet_resume: no reader respawn: {line}")
    return line


def train_cifar_fp16(torch, seed: int, card: str, bf16_p50) -> list:
    """``cli.cifar_main.main`` resnet56 in fp16 at batch 128, synthetic,
    40 steps: a static loss scale (128, the JAX rule's default) and a
    dynamic one; finite falling losses, step p50 beside phase 7's bf16
    run."""
    from dtf_tpu_torch.cli import cifar_main

    flops = vision_flops_per_image(torch, "resnet56", 32)
    lines = []
    for scale in ("static", "dynamic"):
        argv = ["--use_synthetic_data", "--device", "cuda", "--model",
                "resnet56", "--dtype", "fp16", "--train_steps", "40",
                "--skip_eval", "--seed", str(seed)]
        if scale == "dynamic":
            argv += ["--loss_scale", "dynamic"]
        line, _ = vision_run(torch, cifar_main.main, argv,
                             "train_cifar_fp16", card, 128, flops,
                             model="resnet56", dtype="fp16", steps=40,
                             loss_scale=(128.0 if scale == "static"
                                         else "dynamic"),
                             bf16_step_s_p50=bf16_p50)
        lines.append(line)
    return lines


def train_imagenet_input(torch, seed: int, card: str, step_s: dict):
    """Phase 10: the shards, the service's rates, ResNet-50 on the files
    with its eval and a profiled range, the crash-resume with another
    worker count and a reader crash, then fp16 on resnet56."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        shards = write_imagenet(root, seed)
        imagenet_input(root, seed, card, shards)
        train_imagenet_files(torch, root, seed, card,
                             step_s.get("resnet50"))
        imagenet_resume(torch, root, seed, card)
    train_cifar_fp16(torch, seed, card, step_s.get("resnet56"))


# phase 11: the async parameter server (parallel/ps.py, native/ps.py,
# convert.py's wire layout, cli/launch.py)
# ---------------------------------------------------------------------------

RESNET50_PARAMS = 25_559_081
PS_TIMEOUT_S = 240
PS_HEADER_BYTES = 13         # a push's op, lr and count before its payload

# one rank of a phase-11 launch: the entry point's main, then one line
# with its stats, the TF32 switches it ran under and whether it touched
# CUDA (the store's rank must not)
PS_RANK = r"""
import json, sys
sys.path.insert(0, @ROOT@)
import torch
spec = json.loads(sys.argv[1])
main = __import__("dtf_tpu_torch.cli." + spec["main"], fromlist=["main"])
stats = main.main(spec["argv"])
out = {k: v for k, v in stats.items() if k != "step_timestamp_log"}
out["tf32"] = {"cudnn": torch.backends.cudnn.allow_tf32,
               "matmul": torch.backends.cuda.matmul.allow_tf32}
out["cuda_initialized"] = torch.cuda.is_initialized()
print("PS_RESULT=" + json.dumps(out), flush=True)
""".replace("@ROOT@", repr(ROOT))


def ps_results(log_dir: str, world: int, what: str, suffix: str = ""):
    """Each rank's PS_RESULT line, by rank (0 is the store's)."""
    out = []
    for rank in range(world):
        with open(os.path.join(log_dir, f"log{rank}{suffix}.log")) as f:
            text = f.read()
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("PS_RESULT=")]
        if not lines:
            raise AssertionError(f"{what}: rank {rank} printed no result:\n"
                                 f"{text[-3000:]}")
        out.append(json.loads(lines[-1][len("PS_RESULT="):]))
    return out


def ps_store_case(seed: int, card: str) -> dict:
    """The native store (built here at first use, no libjpeg) at
    ResNet-50's size over loopback: pull and push round trips on both
    wires, the bytes a step moves, and the bf16 wire against the numpy
    rule on the client's and the store's conversions, NaNs included."""
    import numpy as np

    from dtf_tpu_torch.native import ps as native_ps
    from dtf_tpu_torch.parallel import ps

    if native_ps.load() is None:
        raise AssertionError(f"ps_store: the native store did not build: "
                             f"{native_ps.unavailable_reason}")
    n = RESNET50_PARAMS
    rng = np.random.default_rng(seed)
    p0 = rng.standard_normal(n, dtype=np.float32)
    special = np.asarray([0x7F800001, 0xFFFFFFFF, 0x7FC00000, 0xFFC00000,
                          0x7F80FFFF, 0x7F800000, 0x80000000, 0x00000001,
                          0x3F80FFFF, 0x3F818000], np.uint32)
    p0[::n // len(special)][:len(special)] = special.view(np.float32)
    client_plain = ps.f32_to_bf16_plain(p0)
    client_native = ps._f32_to_bf16(p0)
    g = (rng.standard_normal(n, dtype=np.float32) * 1e-3)
    server = ps.PsServer(port=0)
    out = {"phase": "ps_store", "card": card, "store": server.store,
           "build_s": native_ps.build_seconds,
           "library": os.path.basename(native_ps.lib_path()),
           "params": n}
    try:
        client = ps.PsClient(f"127.0.0.1:{server.port}")
        client.init(p0)
        buf = np.empty(n, np.float32)
        for wire in ("fp32", "bf16"):
            bf16 = wire == "bf16"
            pull_ms, push_ms = [], []
            for i in range(7):
                before = client.counters()
                t = time.perf_counter()
                client.pull(bf16=bf16, out=buf)
                pull_ms.append(1e3 * (time.perf_counter() - t))
                t = time.perf_counter()
                client.push(0.0, g, bf16=bf16)  # lr 0: the params stay
                push_ms.append(1e3 * (time.perf_counter() - t))
                after = client.counters()
            step_bytes = (after["ps_client_pull_bytes"]
                          - before["ps_client_pull_bytes"]
                          + after["ps_client_push_bytes"]
                          - before["ps_client_push_bytes"]
                          - PS_HEADER_BYTES)
            out[wire] = {"pull_ms_p50": statistics.median(pull_ms[2:]),
                         "push_ms_p50": statistics.median(push_ms[2:]),
                         "pull_ms": pull_ms, "push_ms": push_ms,
                         "bytes_per_step": step_bytes,
                         # pull plus push payloads: 4 + 4 or 2 + 2 B
                         "expected_bytes": (4 if bf16 else 8) * n}
        _, f32 = client.pull()
        f32 = f32.copy()
        _, wide = client.pull(bf16=True)
        store_plain = ps.f32_to_bf16_plain(f32).astype(np.uint32) << 16
        client.done()
        client.close()
    finally:
        server.stop()
    nan = np.isnan(p0)
    out.update({
        "nan_inputs": int(nan.sum()),
        "client_bf16_equal_plain": bool(np.array_equal(client_native,
                                                       client_plain)),
        "store_bf16_equal_plain": bool(np.array_equal(wide.view(np.uint32),
                                                      store_plain)),
        "nan_kept": bool(np.isnan(wide[np.isnan(f32)]).all())})
    emit(out)
    if not (out["store"] == "native" and out["client_bf16_equal_plain"]
            and out["store_bf16_equal_plain"] and out["nan_kept"]
            and out["nan_inputs"] >= 5
            and all(out[w]["bytes_per_step"] == out[w]["expected_bytes"]
                    for w in ("fp32", "bf16"))):
        raise AssertionError(f"ps_store: {out}")
    return out


def snapshot_state(path: str):
    """(version, sha256 of params and velocity) of a store snapshot."""
    import hashlib
    import struct

    with open(path, "rb") as f:
        data = f.read()
    version, n = struct.unpack("<QQ", data[8:24])
    return version, hashlib.sha256(data[24:24 + 8 * n]).hexdigest()


def ps_one_worker(torch, seed: int, card: str, root: str) -> dict:
    """resnet56 b128 f32, 10 synthetic steps, an in-process store and
    one worker, twice: losses equal as floats and the final store equal
    (cudnn.deterministic); then the largest relative gap per step to the
    sync ``off`` Trainer from the same initial state (printed only)."""
    from dtf_tpu_torch.cli.cifar_main import CIFAR_DEFAULTS
    from dtf_tpu_torch.cli.runner import run
    from dtf_tpu_torch.config import parse_flags

    steps = 10
    argv = ["--use_synthetic_data", "--device", "cuda", "--model",
            "resnet56", "--dtype", "fp32", "--batch_size", "128",
            "--train_steps", str(steps), "--log_steps", "1", "--skip_eval",
            "--skip_checkpoint", "--seed", str(seed)]
    runs = []
    for i in range(2):
        snap_dir = os.path.join(root, f"one_worker_{i}")
        cfg = parse_flags(argv + [
            "--distribution_strategy", "parameter_server", "--ps_mode",
            "async", "--ps_snapshot_dir", snap_dir], defaults=CIFAR_DEFAULTS)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        stats = quiet(run, cfg)
        wall = time.perf_counter() - t0
        version, sha = snapshot_state(os.path.join(snap_dir,
                                                   "ps_store.snap"))
        runs.append({"losses": [v for _, v in stats["train_loss_log"]],
                     "version": version, "sha": sha, "wall_s": wall,
                     "step_wall_s": stats["step_wall_s"],
                     "store": stats["ps_store"]})
    torch.cuda.empty_cache()
    sync = quiet(run, parse_flags(argv + ["--distribution_strategy", "off"],
                                  defaults=CIFAR_DEFAULTS))
    sync_losses = [v for _, v in sync["train_loss_log"]]
    a, b = runs
    line = {"phase": "ps_one_worker", "card": card, "model": "resnet56",
            "dtype": "fp32", "batch": 128, "steps": steps,
            "store": a["store"], "losses": a["losses"],
            "losses_bit_identical": a["losses"] == b["losses"],
            "store_sha_equal": a["sha"] == b["sha"],
            "versions": [a["version"], b["version"]],
            "step_wall_s_p50": statistics.median(a["step_wall_s"][1:]),
            "wall_s": [a["wall_s"], b["wall_s"]],
            "sync_off_losses": sync_losses,
            "sync_off_step_s_p50": statistics.median(
                sync["window_step_s"]) if sync["window_step_s"] else None,
            "max_rel_gap_to_sync_off": max(
                abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                    sync_losses)),
            "gap_note": "printed, not gated: the store's update on the "
                        "host and the Trainer's on the card may differ "
                        "in the last bit, which a ResNet's f32 gradient "
                        "amplifies"}
    emit(line)
    if not (line["losses_bit_identical"] and line["store_sha_equal"]
            and line["versions"] == [steps, steps]
            and len(a["losses"]) == steps
            and all(math.isfinite(v) for v in a["losses"])):
        raise AssertionError(f"ps_one_worker: {line}")
    return line


def ps_launch(argv, root: str, what: str, world: int, main: str,
              spawn=None):
    """``main`` under the port's launcher, 1 store + world - 1 workers
    on a TCP coordinator, each rank started by ``spawn`` (default a
    fresh process); (results by rank, log dir, wall s)."""
    from dtf_tpu_torch.cli.launch import (free_address, launch_local,
                                          popen_rank)

    log_dir = os.path.join(root, what)
    cmd = [sys.executable, "-c", PS_RANK,
           json.dumps({"main": main, "argv": argv})]
    t0 = time.perf_counter()
    rc = launch_local(cmd, world, free_address(), log_dir,
                      timeout_s=PS_TIMEOUT_S, spawn=spawn or popen_rank)
    wall = time.perf_counter() - t0
    if rc:
        texts = []
        for rank in range(world):
            with open(os.path.join(log_dir, f"log{rank}.log")) as f:
                texts.append(f.read()[-3000:])
        raise AssertionError(f"{what}: launcher exit {rc}\n"
                             + "\n".join(texts))
    return ps_results(log_dir, world, what), log_dir, wall


def span_ms(trace_dir: str, ranks) -> dict:
    """{span name: [ms, ...]} of the step, ps_pull and ps_push spans in
    these ranks' traces."""
    from dtf_tpu_torch.obs.trace import read_records

    out: dict = {"step": [], "ps_pull": [], "ps_push": []}
    for rank in ranks:
        path = os.path.join(trace_dir, f"trace_rank{rank}.jsonl")
        for rec in read_records(path):
            if rec.get("kind") == "span" and rec["name"] in out:
                out[rec["name"]].append(1e3 * rec["dur_s"])
    return out


def ps_reference(torch, seed: int, card: str, root: str,
                 spawn=None) -> list:
    """The reference's deployment shape on the one card: 1 store + 2
    resnet50 workers at the reference's per-worker --batch_size 192 in
    its default fp32, 10 synthetic steps each, through the launcher, on
    the fp32 wire and then the bf16 one (the ranks started by
    ``spawn``: forked, their rates are the same after the start)."""
    lines = []
    steps, batch = 10, 192
    for wire in ("fp32", "bf16"):
        what = f"ps_reference_{wire}"
        trace_dir = os.path.join(root, what + "_trace")
        argv = ["--use_synthetic_data", "--device", "cuda", "--model",
                "resnet50", "--dtype", "fp32", "--batch_size", str(batch),
                "--train_steps", str(steps), "--log_steps", "1",
                "--skip_eval", "--skip_checkpoint", "--seed", str(seed),
                "--distribution_strategy", "parameter_server",
                "--ps_mode", "async", "--ps_wire", wire,
                "--trace_dir", trace_dir]
        torch.cuda.empty_cache()
        results, log_dir, wall = ps_launch(argv, root, what, 3,
                                           "imagenet_main", spawn)
        store, workers = results[0], results[1:]
        with open(os.path.join(log_dir, "log0.log")) as f:
            ps_done = "PS rank done" in f.read()
        spans = span_ms(trace_dir, (1, 2))
        rates = [[1.0 / s for s in w["step_wall_s"][1:]] for w in workers]
        med = {k: statistics.median(v) for k, v in spans.items()}
        line = {"phase": "ps_reference", "card": card, "wire": wire,
                "model": "resnet50", "dtype": "fp32",
                "tf32": workers[0]["tf32"], "workers": 2,
                "batch_per_worker": batch, "steps_per_worker": steps,
                "store": store["ps_store"], "version": store["ps_version"],
                "ps_rank_logged_done": ps_done,
                "ps_rank_touched_cuda": store["cuda_initialized"],
                "steps_per_s_per_worker": [
                    {"median": statistics.median(r), "min": min(r),
                     "max": max(r)} for r in rates],
                "images_per_s_sum": sum(batch * statistics.median(r)
                                        for r in rates),
                "step_ms_p50": med["step"], "ps_pull_ms_p50":
                med["ps_pull"], "ps_push_ms_p50": med["ps_push"],
                "wire_share": (sum(spans["ps_pull"]) + sum(spans["ps_push"]))
                / sum(sum(v) for v in spans.values()),
                "wire_bytes_per_step": [
                    (w["ps_client"]["ps_client_pull_bytes"]
                     + w["ps_client"]["ps_client_push_bytes"]
                     - PS_HEADER_BYTES * w["ps_client"]["ps_client_pushes"])
                    / w["ps_client"]["ps_client_pushes"] for w in workers],
                "peak_memory_bytes": [w["peak_memory_bytes"]
                                      for w in workers],
                "losses": [[v for _, v in w["train_loss_log"]]
                           for w in workers],
                "wall_s": wall}
        emit(line)
        lines.append(line)
        if not (line["version"] == 2 * steps and ps_done
                and not line["ps_rank_touched_cuda"]
                and line["store"] == "native"
                and all(len(v) == steps and all(map(math.isfinite, v))
                        for v in line["losses"])):
            raise AssertionError(f"ps_reference: {line}")
    return lines


def ps_lm(torch, seed: int, card: str) -> dict:
    """transformer_tpu b8 x 2048 bf16 at ``DP_LM_LAYERS`` of its layers
    as one async worker, 3 steps: K1 and K3 launch once a layer and step
    (counted as phases 6 and 9 count them); the parameters' exact count
    and the bytes a pull moves."""
    from dtf_tpu_torch.cli.lm_main import LM_DEFAULTS
    from dtf_tpu_torch.cli.runner import run
    from dtf_tpu_torch.config import parse_flags
    from dtf_tpu_torch.ops import flash_attention as fa

    steps = 3
    cfg = parse_flags(
        ["--use_synthetic_data", "--device", "cuda", "--model",
         "transformer_tpu", "--dtype", "bf16", "--batch_size",
         str(TRAIN_SHAPE[0]), "--train_steps", str(steps), "--log_steps",
         "1", "--seed", str(seed), "--skip_eval", "--skip_checkpoint",
         "--distribution_strategy", "parameter_server", "--ps_mode",
         "async"], defaults=LM_DEFAULTS)
    torch.cuda.empty_cache()
    fa.launches = fa.launches_dq = fa.launches_dkdv = fa.launches_fused = 0
    t0 = time.perf_counter()
    with fleet_depth(DP_LM_LAYERS):
        stats = quiet(run, cfg)
    wall = time.perf_counter() - t0
    launches = {"K1": fa.launches, "K2a": fa.launches_dq,
                "K2b": fa.launches_dkdv, "K3": fa.launches_fused}
    wire = stats["ps_client"]
    params = wire["ps_client_pull_bytes"] // wire["ps_client_pulls"] // 4
    line = {"phase": "ps_lm", "card": card, "model": "transformer_tpu",
            "layers": DP_LM_LAYERS,
            "dtype": "bf16", "batch": TRAIN_SHAPE[0], "seq": TRAIN_SHAPE[1],
            "steps": steps, "launches": launches, "params": params,
            "pull_bytes": 4 * params, "version": stats["ps_version"],
            "losses": [v for _, v in stats["train_loss_log"]],
            "step_wall_s": stats["step_wall_s"],
            "peak_memory_bytes": stats["peak_memory_bytes"],
            "wall_s": wall}
    emit(line)
    n = DP_LM_LAYERS * steps
    want = {"K1": n, "K2a": 0, "K2b": 0, "K3": n}
    if not (launches == want and line["version"] == steps
            and all(map(math.isfinite, line["losses"]))):
        raise AssertionError(f"ps_lm: {line}, expected launches {want}")
    return line


def ps_drop_case(torch, seed: int, card: str, root: str) -> dict:
    """One worker under ``--fault ps_drop@version:3``: its client severs
    the connection at version 3, reconnects and finishes every step."""
    from dtf_tpu_torch.cli.cifar_main import CIFAR_DEFAULTS
    from dtf_tpu_torch.cli.runner import run
    from dtf_tpu_torch.config import parse_flags

    steps = 8
    cfg = parse_flags(
        ["--use_synthetic_data", "--device", "cuda", "--model", "resnet56",
         "--dtype", "fp32", "--batch_size", "128", "--train_steps",
         str(steps), "--log_steps", "1", "--skip_eval", "--skip_checkpoint",
         "--seed", str(seed), "--distribution_strategy",
         "parameter_server", "--ps_mode", "async", "--fault",
         "ps_drop@version:3", "--ps_snapshot_dir",
         os.path.join(root, "ps_drop")], defaults=CIFAR_DEFAULTS)
    torch.cuda.empty_cache()
    stats = quiet(run, cfg)
    line = {"phase": "ps_faults", "case": "ps_drop@version:3", "card": card,
            "model": "resnet56", "steps": steps,
            "reconnects": stats["ps_client"]["ps_client_reconnects"],
            "version": stats["ps_version"],
            "losses": [v for _, v in stats["train_loss_log"]]}
    emit(line)
    if not (line["reconnects"] >= 1 and line["version"] == steps
            and len(line["losses"]) == steps
            and all(map(math.isfinite, line["losses"]))):
        raise AssertionError(f"ps_faults ps_drop: {line}")
    return line


def ps_preempt_case(torch, seed: int, card: str, root: str,
                    spawn=None) -> dict:
    """A store's rank preempted by SIGTERM while it serves, under
    ``--ps_snapshot_dir``: the launcher restarts the whole job (a new
    port, restart generation 1), the store restores its final snapshot
    and discards the done count of attempt 0, and the re-run workers
    finish: the final version is the restored one plus their steps.
    The launcher runs on a thread here, its ranks started by ``spawn``
    (default a fresh process)."""
    import re
    import signal

    from dtf_tpu_torch.cli.launch import free_address, launch_local, \
        popen_rank
    from dtf_tpu_torch.obs.watchdog import heartbeat_path, read_heartbeat
    from dtf_tpu_torch.parallel.ps import PsClient

    steps = 20
    log_dir = os.path.join(root, "ps_preempt")
    coordinator = free_address()
    argv = ["--use_synthetic_data", "--device", "cuda", "--model",
            "resnet56", "--dtype", "fp32", "--batch_size", "128",
            "--train_steps", str(steps), "--log_steps", "1", "--skip_eval",
            "--skip_checkpoint", "--seed", str(seed),
            "--distribution_strategy", "parameter_server", "--ps_mode",
            "async", "--ps_snapshot_dir", os.path.join(root, "ps_snaps"),
            "--ps_snapshot_secs", "1", "--ps_reconnect_secs", "60"]
    cmd = [sys.executable, "-c", PS_RANK,
           json.dumps({"main": "cifar_main", "argv": argv})]
    t0 = time.perf_counter()
    launcher = overlapped(launch_local, cmd, 3, coordinator, log_dir,
                          timeout_s=PS_TIMEOUT_S, max_restarts=1,
                          heartbeat_timeout=120, teardown_grace=10,
                          spawn=spawn or popen_rank)
    try:
        # wait for the store to reach version 6, then SIGTERM its rank
        # (the pid in its heartbeat file)
        deadline = time.time() + 120
        version = 0
        while version < 6:
            if time.time() > deadline or launcher.done():
                raise AssertionError("ps_faults preempt: the store never "
                                     "reached version 6")
            try:
                client = PsClient(coordinator, connect_timeout=1.0)
                version = client.info()[2]
                client.close()
            except OSError:
                pass
            time.sleep(0.2)
        hb = read_heartbeat(heartbeat_path(log_dir, 0))
        os.kill(hb["pid"], signal.SIGTERM)
        killed_at = version
    finally:
        # the launcher's own timeout ends its ranks
        rc = launcher.result()
    wall = time.perf_counter() - t0

    def text(name):
        with open(os.path.join(log_dir, name)) as f:
            return f.read()

    with open(os.path.join(log_dir, "supervisor_events.jsonl")) as f:
        events = [json.loads(ln) for ln in f if ln.strip()]
    first = next((e for e in events if e["event"] == "rank_exit"
                  and e["rank"] == 0 and e["attempt"] == 0), {})
    ps1 = text("log0.retry1.log") if os.path.exists(
        os.path.join(log_dir, "log0.retry1.log")) else ""
    restored = re.search(r"restored snapshot \S+ at version (\d+)", ps1)
    done = re.search(r"PS rank done: version (\d+)", ps1)
    losses = []
    for rank in (1, 2):
        name = f"log{rank}.retry1.log"
        found = re.findall(r"Run stats: .*'loss': ([-\d.e+]+)",
                           text(name) if os.path.exists(
                               os.path.join(log_dir, name)) else "")
        losses.append(float(found[-1]) if found else None)
    line = {"phase": "ps_faults", "case": "ps rank sigterm, resumed",
            "card": card, "model": "resnet56", "steps_per_worker": steps,
            "launcher_exit": rc,
            "ps_first_exit": first.get("code"),
            "ps_first_classification": first.get("classification"),
            "sigterm_at_version": killed_at,
            "restarts": [e.get("classification") for e in events
                         if e["event"] == "restart"],
            "restored_version": int(restored.group(1)) if restored else None,
            "done_count_discarded": "discarded" in ps1,
            "final_version": int(done.group(1)) if done else None,
            "worker_losses": losses, "wall_s": wall}
    emit(line)
    if not (line["launcher_exit"] == 0 and line["ps_first_exit"] == 75
            and line["restarts"] == ["preempted"]
            and line["restored_version"]
            and line["restored_version"] >= killed_at
            and line["done_count_discarded"]
            and line["final_version"] == line["restored_version"]
            + 2 * steps
            and all(v is not None and math.isfinite(v) for v in losses)):
        raise AssertionError(f"ps_faults preempt: {line}\n"
                             f"{text('log0.log')[-3000:]}")
    return line


def async_ps(torch, seed: int, card: str, spawn=None) -> dict:
    """Phase 11: the store, the reference's shape through the launcher
    on both wires (its ranks started by ``spawn``), then one worker
    twice, the LM worker's kernels and the two faults, the preempted job
    (the launcher on a thread, its ranks started by ``spawn`` too)
    beside the in-process runs."""
    import concurrent.futures
    import tempfile

    out = {"store": ps_store_case(seed, card)}
    with tempfile.TemporaryDirectory() as root:
        # the reference's shape alone: its rates are the measurement
        out["reference"] = ps_reference(torch, seed, card, root, spawn)
        # the preempted job in its processes while the in-process runs
        # go: each is gated on its own versions, losses and launches,
        # and no gate reads a time
        preempt = overlapped(ps_preempt_case, torch, seed, card, root,
                             spawn)
        try:
            out["one_worker"] = ps_one_worker(torch, seed, card, root)
            out["lm"] = ps_lm(torch, seed, card)
            out["drop"] = ps_drop_case(torch, seed, card, root)
        finally:
            concurrent.futures.wait([preempt])
        out["preempt"] = preempt.result()
    return out


# ---------------------------------------------------------------------------
# phase 12: serving as the JAX package serves by default (prefix sharing,
# copy-on-write, eviction, cancellation, drain, /metrics, the MFU ledger,
# the contiguous cache)
# ---------------------------------------------------------------------------

# bench_serve.py's shared-prefix arm: tokens after the system prompt and
# new tokens a request
PREFIX_TAIL_LEN, PREFIX_BUDGET = 8, 24
PREFIX_PAGE = 16


def prefix_pool_pages(batch: int, sys_pages: int, page_size: int) -> int:
    """bench_serve.py's pool: one full prompt copy plus each request's
    tail pages fit, ``batch`` unshared copies do not."""
    tail_pages = (-(-(sys_pages * page_size + PREFIX_TAIL_LEN
                      + PREFIX_BUDGET) // page_size) - sys_pages)
    return 1 + (sys_pages + tail_pages) + (batch - 1) * tail_pages


def settle(engine, timeout: float = 300.0) -> None:
    """Wait until the engine thread has retired everything it holds."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        with engine._cond:
            if not engine._pending and all(s is None
                                           for s in engine._slots):
                return
        time.sleep(0.01)
    raise AssertionError("serving engine did not go idle")


def prefix_arm(torch, model, *, sharing: bool, sys_prompt, tails,
               budget: int, pool=None, batch: int = 8) -> dict:
    """A warm request (the system prompt alone: it registers the prefix
    when sharing), then a burst of ``sys_prompt + tail`` requests with
    the kernels' counters zeroed just before and read just after: the
    tokens, concurrency, pool high-water, TTFTs, launches and what they
    should be (K1 per request without a hit, K4 per continuation chunk
    and decode step), and the decode step's ledger row."""
    import numpy as np

    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import paged_attention as pa
    from dtf_tpu_torch.serve import ServeEngine, collect_stats

    eng = ServeEngine(model, max_batch=batch, max_seq_len=model.max_seq_len,
                      max_delay_s=0.0, queue_size=64,
                      kv_page_size=PREFIX_PAGE, kv_pool_pages=pool,
                      prefix_sharing=sharing)
    try:
        eng.generate(sys_prompt, max_new_tokens=2)
        settle(eng)
        n_warm = eng.reset_measurement()
        m = eng.metrics
        names = ("serve_prefill_chunks_total", "serve_prefix_hit_pages_total")
        before = [m.get(n).value for n in names]
        steps0 = m.get("serve_decode_step_s").count
        reset_counts(fa, pa)
        t0 = time.time()
        hs = [eng.submit(np.concatenate([sys_prompt, t]).astype(np.int32),
                         max_new_tokens=budget) for t in tails]
        res = [h.result(timeout=600) for h in hs]
        wall = time.time() - t0
        torch.cuda.synchronize()
        launches = kernel_counts(fa, pa)
        chunks, hits = (m.get(n).value - b for n, b in zip(names, before))
        steps = m.get("serve_decode_step_s").count - steps0
        stats = collect_stats(eng.completed[n_warm:], eng.shed_count,
                              wall_time_s=wall)
        out = {"sharing": sharing, "requests": len(tails),
               "pool_pages": eng.pool.num_pages,
               "max_concurrent": eng.max_concurrent,
               "high_water": eng.pool.high_water,
               "hit_pages": hits, "prefill_chunks": chunks,
               "decode_steps": steps, "tokens_per_s": stats.tokens_per_s,
               "ttft_p50_s": stats.ttft_p50_s,
               "ttft_s": sorted(r.time_to_first_token_s for r in res),
               "latency_p50_s": stats.latency_p50_s,
               "launches": launches,
               "ledger_decode_step": eng.ledger.summary().get(
                   "serve_decode_step"),
               "ledger_gauges": {
                   g: m.get(f"ledger_serve_decode_step_{g}").value
                   for g in ("mfu", "hbm_frac", "flops", "bytes")
                   if m.get(f"ledger_serve_decode_step_{g}") is not None},
               "tokens": [r.tokens for r in res]}
    finally:
        eng.stop()
    # requests whose first chunk starts at 0 run K1 once a layer; every
    # other chunk and every decode step runs K4 once a layer
    layers = model.num_layers
    hit_requests = hits // (len(sys_prompt) // PREFIX_PAGE)
    first_chunks = len(tails) - hit_requests
    want = {"K1": layers * first_chunks, "K2a": 0, "K2b": 0, "K3": 0,
            "K4": layers * (chunks - first_chunks + steps)}
    if launches != want:
        raise AssertionError(f"prefix arm (sharing={sharing}): launches "
                             f"{launches}, expected {want}")
    out["hit_requests"] = hit_requests
    return out


def prefix_concurrency(torch, model, rng) -> dict:
    """bench_serve.py's shared-prefix arm at transformer_tpu bf16: a
    128-token system prompt, tails of 8, 24 new tokens, 8 slots, the
    25-page pool.  Sharing must at least double the peak concurrency,
    lower the high-water mark and leave every greedy token unchanged."""
    sys_pages = 8
    sys_prompt = rng.integers(0, model.vocab_size,
                              (sys_pages * PREFIX_PAGE,)).astype("int32")
    tails = [rng.integers(0, model.vocab_size,
                          (PREFIX_TAIL_LEN,)).astype("int32")
             for _ in range(8)]
    pool = prefix_pool_pages(8, sys_pages, PREFIX_PAGE)
    arms = {name: prefix_arm(torch, model, sharing=name == "sharing",
                             sys_prompt=sys_prompt, tails=tails,
                             budget=PREFIX_BUDGET, pool=pool)
            for name in ("sharing", "nosharing")}
    share, plain = arms["sharing"], arms["nosharing"]
    line = {"phase": "prefix_concurrency", "model": "transformer_tpu",
            "dtype": "bf16", "pool_pages": pool, "sys_tokens": 128,
            "tail_tokens": PREFIX_TAIL_LEN, "new_tokens": PREFIX_BUDGET,
            "concurrency_gain": share["max_concurrent"]
            / max(plain["max_concurrent"], 1),
            "tokens_identical": share["tokens"] == plain["tokens"],
            **{f"{k}_{name}": a[k] for name, a in arms.items()
               for k in ("max_concurrent", "high_water", "hit_pages",
                         "hit_requests", "prefill_chunks", "decode_steps",
                         "tokens_per_s", "ttft_p50_s", "launches",
                         "ledger_gauges")}}
    # the shared arm fills the same pool with 4x the sequences, so its
    # high-water mark a live sequence is the comparison that holds
    line["high_water_per_sequence"] = {
        name: a["high_water"] / max(a["max_concurrent"], 1)
        for name, a in arms.items()}
    emit(line)
    per_seq = line["high_water_per_sequence"]
    if not (share["max_concurrent"] >= 2 * plain["max_concurrent"]
            and per_seq["sharing"] < per_seq["nosharing"]
            and line["tokens_identical"] and share["hit_requests"] == 8):
        raise AssertionError(f"prefix concurrency: {line}")
    return arms


def prefix_ttft(torch, model, rng) -> dict:
    """A 1024-token system prompt, 16 requests with tails from U[1, 64]
    and 64 new tokens each, on the full pool: TTFT p50 and tokens/s
    with and without sharing; tokens identical."""
    sys_prompt = rng.integers(0, model.vocab_size, (1024,)).astype("int32")
    tails = [rng.integers(0, model.vocab_size,
                          (int(rng.integers(1, 65)),)).astype("int32")
             for _ in range(16)]
    arms = {name: prefix_arm(torch, model, sharing=name == "sharing",
                             sys_prompt=sys_prompt, tails=tails, budget=64)
            for name in ("sharing", "nosharing")}
    share, plain = arms["sharing"], arms["nosharing"]
    line = {"phase": "prefix_ttft", "model": "transformer_tpu",
            "dtype": "bf16", "sys_tokens": 1024, "requests": 16,
            "new_tokens": 64,
            "tail_tokens": [len(t) for t in tails],
            "ttft_speedup": plain["ttft_p50_s"] / share["ttft_p50_s"],
            "tokens_identical": share["tokens"] == plain["tokens"],
            **{f"{k}_{name}": a[k] for name, a in arms.items()
               for k in ("ttft_p50_s", "ttft_s", "tokens_per_s",
                         "latency_p50_s", "max_concurrent", "high_water",
                         "hit_requests", "prefill_chunks", "launches",
                         "ledger_decode_step", "ledger_gauges")}}
    emit(line)
    gauges = share["ledger_gauges"]
    if not (line["tokens_identical"] and share["hit_requests"] == 16
            and share["ttft_p50_s"] < plain["ttft_p50_s"]
            and share["high_water"] < plain["high_water"]
            and "mfu" in gauges and "hbm_frac" in gauges
            and 0 < gauges["mfu"] < 1 and 0 < gauges["hbm_frac"] < 1):
        raise AssertionError(f"prefix ttft: {line}")
    return arms


def prefix_pressure(torch, model, rng) -> dict:
    """On the 25-page pool with sharing: eviction -- a distinct 300-token
    prompt needs more pages than the cached prefix leaves free, so
    registry-only pages are evicted and it completes (no livelock); a
    cancel -- a request cancelled mid-decode comes back ``cancelled``
    with its pages reclaimed down to what the registry holds; the drain
    -- ``begin_drain`` sheds the next submit with retry_after."""
    import numpy as np

    from dtf_tpu_torch.serve import Backpressure, ServeEngine

    pool = prefix_pool_pages(8, 8, PREFIX_PAGE)
    eng = ServeEngine(model, max_batch=8, max_seq_len=model.max_seq_len,
                      max_delay_s=0.0, kv_page_size=PREFIX_PAGE,
                      kv_pool_pages=pool)
    m = eng.metrics
    try:
        sys_prompt = rng.integers(0, model.vocab_size, (128,)).astype(
            np.int32)
        eng.generate(sys_prompt, max_new_tokens=2)
        settle(eng)
        cached = len(eng.registry)
        big = rng.integers(0, model.vocab_size, (300,)).astype(np.int32)
        t0 = time.time()
        r_big = eng.submit(big, max_new_tokens=20).result(timeout=300)
        evict_s = time.time() - t0
        settle(eng)
        evicted = m.get("serve_prefix_evicted_total").value
        victim = eng.submit(rng.integers(0, model.vocab_size, (64,)).astype(
            np.int32), max_new_tokens=300)
        it = victim.stream(timeout=300)
        streamed = [next(it) for _ in range(3)]
        victim.cancel()
        r_cancel = victim.result(timeout=300)
        settle(eng)
        reclaimed = eng.pool.used_pages == len(eng.registry)
        eng.begin_drain()
        try:
            eng.submit(np.array([1, 2, 3], np.int32), max_new_tokens=2)
            shed_on_drain = False
        except Backpressure as e:
            shed_on_drain = e.retry_after > 0
        line = {"phase": "prefix_pressure", "model": "transformer_tpu",
                "dtype": "bf16", "pool_pages": pool,
                "registry_pages_before": cached,
                "big_prompt_tokens": 300, "big_tokens": len(r_big.tokens),
                "big_s": evict_s, "evicted_pages": evicted,
                "cancelled": r_cancel.cancelled,
                "cancelled_tokens": len(r_cancel.tokens),
                "cancelled_total": m.get("serve_cancelled_total").value,
                "pages_used_after_cancel": eng.pool.used_pages,
                "registry_pages_after_cancel": len(eng.registry),
                "reclaimed_to_registry": reclaimed,
                "shed_on_drain": shed_on_drain,
                "shed_total": eng.shed_count}
    finally:
        eng.stop()
    emit(line)
    if not (evicted > 0 and len(r_big.tokens) == 20 and r_cancel.cancelled
            and 3 <= len(r_cancel.tokens) < 300
            and r_cancel.tokens[:3] == streamed and reclaimed
            and shed_on_drain and eng.failed is None):
        raise AssertionError(f"prefix pressure: {line}")
    return line


def prefix_f32(torch, seed: int, rng) -> dict:
    """transformer_tpu in float32, where the routes agree to ~1e-6 (phase
    3's precision; in bf16 the COW replay's decode route and a prefill
    chunk round differently, so token equality would be chance): COW --
    a 4-page prompt seen twice, the second a full hit replayed into a
    copied page, every token as the unshared engine's; the contiguous
    cache -- 8 requests through kv_page_size 0 and through the paged
    engine, tokens equal, tokens/s side by side."""
    import numpy as np

    from dtf_tpu_torch.models.registry import build_model
    from dtf_tpu_torch.serve import ServeEngine, collect_stats
    from dtf_tpu_torch.serve.bridge import random_init

    model, _ = build_model("transformer_tpu", dtype=torch.float32)
    model = random_init(model, seed).cuda().eval()
    n_new = 16
    prompt = rng.integers(0, model.vocab_size, (4 * PREFIX_PAGE,)).astype(
        np.int32)
    cow = {}
    for sharing in (True, False):
        eng = ServeEngine(model, max_batch=8, max_seq_len=model.max_seq_len,
                          max_delay_s=0.0, kv_page_size=PREFIX_PAGE,
                          prefix_sharing=sharing)
        try:
            runs = []
            for _ in range(2):
                runs.append(eng.generate(prompt, max_new_tokens=n_new).tokens)
                settle(eng)
            cow[sharing] = (runs, eng.metrics.get(
                "serve_prefix_cow_total").value)
        finally:
            eng.stop()
    prompts = [rng.integers(0, model.vocab_size, (int(n),)).astype(np.int32)
               for n in rng.integers(1, 257, 8)]
    layouts = {}
    for name, page in (("paged", PREFIX_PAGE), ("contiguous", 0)):
        eng = ServeEngine(model, max_batch=8, max_seq_len=model.max_seq_len,
                          max_delay_s=0.0, kv_page_size=page)
        try:
            eng.generate(prompts[0], max_new_tokens=2)    # warm
            n0 = eng.reset_measurement()
            t0 = time.time()
            hs = [eng.submit(p, max_new_tokens=32) for p in prompts]
            res = [h.result(timeout=600) for h in hs]
            st = collect_stats(eng.completed[n0:], eng.shed_count,
                               wall_time_s=time.time() - t0)
            layouts[name] = {"tokens": [r.tokens for r in res],
                             "tokens_per_s": st.tokens_per_s,
                             "ttft_p50_s": st.ttft_p50_s,
                             "decode_step_p50_s": eng.metrics.get(
                                 "serve_decode_step_s").percentile(50)}
        finally:
            eng.stop()
    line = {"phase": "prefix_f32", "model": "transformer_tpu",
            "dtype": "fp32", "cow_prompt_tokens": len(prompt),
            "cow_total": cow[True][1],
            "cow_tokens_equal_unshared":
                cow[True][0][1] == cow[True][0][0] == cow[False][0][0]
                == cow[False][0][1],
            "contiguous_tokens_equal_paged":
                layouts["contiguous"]["tokens"] == layouts["paged"]["tokens"],
            "prompt_tokens": [len(p) for p in prompts], "new_tokens": 32,
            **{f"{k}_{name}": v[k] for name, v in layouts.items()
               for k in ("tokens_per_s", "ttft_p50_s", "decode_step_p50_s")}}
    emit(line)
    del model
    torch.cuda.empty_cache()
    if not (line["cow_total"] >= 1 and line["cow_tokens_equal_unshared"]
            and line["contiguous_tokens_equal_paged"]):
        raise AssertionError(f"prefix f32: {line}")
    return line


def scrape(url: str):
    """(status, body) of one GET."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def serve_cli_drain(seed: int, card: str) -> dict:
    """``cli.serve_main`` as its own process on the card, bf16, with
    ``--metrics_port`` and ``--trace_dir``: /metrics carries the serve_*
    and ledger_* series; SIGTERM while it decodes turns /healthz to 503,
    the in-flight requests finish and the process exits 0; ``trace_main
    --ledger --json`` reads its ledger rows."""
    import ast
    import signal
    import socket
    import tempfile
    import urllib.error

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    tdir = tempfile.mkdtemp(prefix="serve_drain_")
    n_req = 16
    argv = [sys.executable, "-m", "dtf_tpu_torch.cli.serve_main",
            "--serve_random_init", "--device", "cuda", "--model",
            "transformer_tpu", "--dtype", "bf16", "--seed", str(seed),
            "--serve_max_batch", "8", "--serve_requests", str(n_req),
            "--serve_prompt_len", "512", "--serve_max_new_tokens", "512",
            "--metrics_port", str(port), "--trace_dir", tdir]
    t0 = time.time()
    proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{port}"
    body, steps_at_signal, healthz = "", 0.0, []
    try:
        deadline = time.time() + 300
        while time.time() < deadline and proc.poll() is None:
            try:
                status, body = scrape(f"{base}/metrics")
            except (urllib.error.URLError, OSError):
                time.sleep(0.2)
                continue
            counts = [ln for ln in body.splitlines()
                      if ln.startswith("serve_decode_step_s_count")]
            if counts and float(counts[0].split()[1]) >= 20:
                steps_at_signal = float(counts[0].split()[1])
                break
            time.sleep(0.1)
        if not steps_at_signal:
            raise AssertionError("serve_main never reached 20 decode steps "
                                 "on /metrics")
        signal_s = time.time() - t0
        proc.send_signal(signal.SIGTERM)
        while proc.poll() is None:
            try:
                status, hz = scrape(f"{base}/healthz")
                healthz.append((status, json.loads(hz).get("draining")))
            except (urllib.error.URLError, OSError, ValueError):
                break
            time.sleep(0.2)
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    stats_lines = [ln for ln in err.splitlines() if "Serve stats:" in ln]
    stats = (ast.literal_eval(stats_lines[-1].split("Serve stats:", 1)[1]
                              .strip()) if stats_lines else {})
    series = sorted({ln.split()[2] for ln in body.splitlines()
                     if ln.startswith("# TYPE ")})
    rows = subprocess.run(
        [sys.executable, "-m", "dtf_tpu_torch.cli.trace_main", tdir,
         "--ledger", "--json"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    ledger_rows = (json.loads(rows.stdout)["ledger"] if rows.returncode == 0
                   else rows.stderr[-500:])
    line = {"phase": "serve_cli_drain", "card": card,
            "model": "transformer_tpu", "dtype": "bf16",
            "returncode": proc.returncode, "requests": n_req,
            "signal_after_s": signal_s,
            "decode_steps_at_signal": steps_at_signal,
            "wall_s": time.time() - t0,
            "healthz_503_while_draining": any(
                s == 503 and d for s, d in healthz),
            "healthz_samples": len(healthz),
            "serve_series": [n for n in series if n.startswith("serve_")],
            "ledger_series": [n for n in series if n.startswith("ledger_")],
            "stats": {k: stats.get(k) for k in (
                "requests", "shed", "new_tokens", "tokens_per_second",
                "ttft_p50_s", "decode_steps", "prefix_sharing", "drained")},
            "ledger_rows": ledger_rows,
            "stderr_tail": err[-1500:] if proc.returncode else ""}
    emit(line)
    want_series = {"serve_prefix_hit_pages_total", "serve_prefix_cow_total",
                   "serve_prefix_evicted_total", "serve_cancelled_total",
                   "serve_kv_pages_shared_refs", "serve_stream_lag_s",
                   "ledger_serve_decode_step_mfu",
                   "ledger_serve_decode_step_hbm_frac"}
    if not (proc.returncode == 0 and line["healthz_503_while_draining"]
            and "SIGTERM - draining" in err
            and stats.get("drained") is True
            and stats.get("requests", 0) + stats.get("shed", 0) == n_req
            and stats.get("requests", 0) > 0
            and stats.get("new_tokens") == stats.get("requests") * 512
            and want_series <= set(series)
            and isinstance(ledger_rows, list) and ledger_rows):
        raise AssertionError(f"serve_main drain: {line}")
    return line


def serve_prefix(torch, seed: int, card: str) -> dict:
    """Phase 12 (see the module docstring)."""
    import numpy as np

    from dtf_tpu_torch.models.registry import build_model
    from dtf_tpu_torch.serve.bridge import random_init

    rng = np.random.default_rng(seed + 12)
    # the bf16 bursts at FLEET_LAYERS of the 12 layers, every width kept
    # (their gates count launches by the model's own depth)
    with fleet_depth():
        model, _ = build_model("transformer_tpu", dtype=torch.bfloat16)
    model = random_init(model, seed).cuda().eval()
    try:
        out = {"concurrency": prefix_concurrency(torch, model, rng),
               "ttft": prefix_ttft(torch, model, rng),
               "pressure": prefix_pressure(torch, model, rng)}
    finally:
        del model
        torch.cuda.empty_cache()
    out["f32"] = prefix_f32(torch, seed, rng)
    out["cli"] = serve_cli_drain(seed, card)
    return out


# ---------------------------------------------------------------------------
# phase 13: the serving fleet (serve/router.py, serve/replica.py,
# serve/migrate.py, cli/replica_main.py) -- replica processes on the card
# ---------------------------------------------------------------------------

FLEET_SYS, FLEET_TAIL, FLEET_NEW = 256, 128, 32
FLEET_FAMILIES, FLEET_REQUESTS = 4, 16

# a replica process as the router spawns it (cli/replica_main.py's main,
# same flags), with the kernels' launch counts zeroed as its server
# starts -- after the warm request, so they count the traffic -- and
# written at its exit into the rendezvous directory
FLEET_REPLICA = r"""
import atexit, json, os, signal, sys
from dtf_tpu_torch.cli import replica_main
from dtf_tpu_torch.ops import flash_attention as fa, paged_attention as pa
from dtf_tpu_torch.serve import replica

_start = replica.ReplicaServer.start


def start(self):
    fa.launches = pa.launches = 0
    return _start(self)


def dump(tag=""):
    name = "launches_rank%s.gen%s%s.json" % (
        os.environ["DTF_PROCESS_ID"], os.environ["DTF_RESTART_GENERATION"],
        tag)
    path = os.path.join(os.environ["DTF_HEARTBEAT_DIR"], name)
    with open(path + ".tmp", "w") as f:
        json.dump({"K1": fa.launches, "K4": pa.launches}, f)
    os.replace(path + ".tmp", path)


replica.ReplicaServer.start = start
atexit.register(dump)
# phase 14 reads a live process's counts so far (its HA stages' share)
signal.signal(signal.SIGUSR1, lambda *_: dump(".snap"))
sys.exit(replica_main.main(sys.argv[1:]))
"""


# the modules the replicas' forkserver imports once, before it forks
REPLICA_PRELOAD = ["numpy", "torch", "dtf_tpu_torch.cli.replica_main",
                   "dtf_tpu_torch.cli.serve_main",
                   "dtf_tpu_torch.serve.replica", "dtf_tpu_torch.serve.engine",
                   "dtf_tpu_torch.ops.flash_attention",
                   "dtf_tpu_torch.ops.paged_attention",
                   "dtf_tpu_torch.models.transformer",
                   "dtf_tpu_torch.obs.prom", "dtf_tpu_torch.chaos",
                   "dtf_tpu_torch.obs.trace"]


# what a launcher rank of phases 9, 11 and 15-20 imports (DP_RANK,
# RECOVERY_RANK, PS_RANK): the forkserver imports it once for every
# such rank
RANK_PRELOAD = ["dtf_tpu_torch.cli.runner", "dtf_tpu_torch.cli.lm_main",
                "dtf_tpu_torch.cli.cifar_main",
                "dtf_tpu_torch.cli.imagenet_main",
                "dtf_tpu_torch.parallel.ps", "dtf_tpu_torch.config",
                "dtf_tpu_torch.runtime.mesh", "dtf_tpu_torch.train.loop",
                "dtf_tpu_torch.train.checkpoint",
                "dtf_tpu_torch.train.elastic", "torch.distributed"]


def forked_main(name: str, script: str, argv, env: dict, cwd: str,
                log: str, layers=None) -> None:
    """A process's body, forked from the forkserver: its log on stdout
    and stderr, the given cwd, environment and argv, transformer_tpu at
    ``layers`` (all 12 for None), torch's threads as ``OMP_NUM_THREADS``
    asks, then ``script`` as ``python -c`` runs it, with its exit
    handlers (a multiprocessing child ends with ``os._exit``)."""
    import atexit
    import traceback

    import torch
    if torch.cuda.is_initialized():
        raise SystemExit(f"{name}: CUDA initialised before the fork")
    fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    os.chdir(cwd)
    os.environ.clear()
    os.environ.update(env)
    if env.get("OMP_NUM_THREADS"):
        torch.set_num_threads(int(env["OMP_NUM_THREADS"]))
    if layers:
        from dtf_tpu_torch.models import registry
        ctor, classes, l2 = registry._REGISTRY["transformer_tpu"]
        registry._REGISTRY["transformer_tpu"] = (
            functools.partial(ctor, num_layers=layers), classes, l2)
    sys.argv = [name] + list(argv)
    code = 0
    try:
        exec(compile(script, f"<{name}>", "exec"), {"__name__": "__main__"})
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (1 if e.code else 0)
    except BaseException:
        traceback.print_exc()
        code = 1
    atexit._run_exitfuncs()
    sys.stdout.flush()
    sys.stderr.flush()
    raise SystemExit(code)


def fleet_replica_child(argv, env: dict, cwd: str, log: str,
                        layers: int) -> None:
    """A replica's body (``FLEET_REPLICA``), forked from the forkserver:
    the tier's cwd, environment and argv, transformer_tpu at
    ``layers``."""
    forked_main("replica", FLEET_REPLICA, argv, env, cwd, log, layers)


def _forkserver_ready() -> None:
    """The first child: it returns once the forkserver has imported."""


class ForkedReplica:
    """A Popen-like handle on a replica forked by the forkserver: the
    pid is the replica's own (its announce names it)."""

    def __init__(self, proc):
        self._proc = proc
        self.pid = proc.pid

    @property
    def returncode(self):
        return self._proc.exitcode

    def poll(self):
        return self._proc.exitcode

    def wait(self, timeout=None):
        self._proc.join(timeout)
        if self._proc.exitcode is None:
            raise subprocess.TimeoutExpired(f"replica {self.pid}", timeout)
        return self._proc.exitcode

    def send_signal(self, sig) -> None:
        if self._proc.exitcode is None:
            try:
                os.kill(self.pid, sig)
            except ProcessLookupError:
                pass

    def terminate(self) -> None:
        import signal
        self.send_signal(signal.SIGTERM)

    def kill(self) -> None:
        import signal
        self.send_signal(signal.SIGKILL)


class ReplicaForkServer:
    """The pre-imported spawner of phases 13 and 14: ``multiprocessing``'s
    forkserver, which imports torch and the replica's modules
    (``REPLICA_PRELOAD``) once, touches no CUDA, and forks each replica
    from there, so a replica's start pays for its card and model, not
    for its imports.  It is a process of its own: no child inherits the
    smoke's threads or sockets.  ``start`` launches it (it imports while
    phase 12 runs); ``spawner(...)`` keeps
    ``serve.router.replica_spawner``'s contract -- the tier's environment
    (``DTF_PROCESS_ID``, ``DTF_HEARTBEAT_DIR``,
    ``DTF_RESTART_GENERATION``, ``DTF_SERVE_CHECKPOINT`` from
    ``checkpoint_map``), the logs ``replica{K}[.retry{G}].log`` -- with
    each replica running :func:`fleet_replica_child`."""

    def __init__(self):
        import multiprocessing
        self.ctx = multiprocessing.get_context("forkserver")
        # the module of the child's body first: run as a script, this
        # one is __main__, imported once there and not again per child
        self.ctx.set_forkserver_preload(
            [fleet_replica_child.__module__] + REPLICA_PRELOAD
            + RANK_PRELOAD)
        self.spawned = 0
        self._ready_s = None

    def start(self) -> "ReplicaForkServer":
        from multiprocessing import forkserver
        self.t0 = time.perf_counter()
        forkserver.ensure_running()
        return self

    def ready(self) -> float:
        """Seconds from the start until a first child ran (the
        forkserver answers once its imports are done)."""
        if self._ready_s is None:
            proc = self.ctx.Process(target=_forkserver_ready, daemon=True)
            proc.start()
            proc.join(300)
            if proc.exitcode != 0:
                raise AssertionError(
                    f"replica forkserver: first child exit {proc.exitcode}")
            self._ready_s = time.perf_counter() - self.t0
        return self._ready_s

    def spawner(self, cmd_args, rendezvous_dir: str, env_extra=None,
                extra_flags=None, checkpoint_map=None):
        rendezvous_dir = os.path.abspath(rendezvous_dir)

        def spawn(replica_id: int, generation: int) -> ForkedReplica:
            env = dict(os.environ)
            env["DTF_PROCESS_ID"] = str(replica_id)
            env["DTF_HEARTBEAT_DIR"] = rendezvous_dir
            env["DTF_RESTART_GENERATION"] = str(generation)
            env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
            env.update(env_extra or {})
            ckpt = (checkpoint_map or {}).get(replica_id, "")
            if ckpt:
                env["DTF_SERVE_CHECKPOINT"] = ckpt
            suffix = f".retry{generation}" if generation else ""
            argv = list(cmd_args) + ["--replica_id", str(replica_id)]
            if extra_flags is not None:
                argv += [str(f) for f in (extra_flags(replica_id) or [])]
            log = os.path.join(rendezvous_dir,
                               f"replica{replica_id}{suffix}.log")
            self.ready()
            # daemonic: one left running when the smoke exits is ended
            proc = self.ctx.Process(
                target=fleet_replica_child, daemon=True,
                args=(argv, env, ROOT, log, FLEET_LAYERS))
            proc.start()
            self.spawned += 1
            return ForkedReplica(proc)

        return spawn

    def rank_spawn(self, cmd, env: dict, log_path: str) -> ForkedReplica:
        """``cli.launch.launch_local``'s ``spawn``: a launcher rank
        (``cmd`` is ``[python, "-c", script, *args]``) forked from here,
        so its start pays for its card and model, not its imports."""
        if cmd[1:2] != ["-c"]:
            raise ValueError(f"a forked rank runs a python -c script, "
                             f"not {cmd[:2]}")
        self.ready()
        proc = self.ctx.Process(
            target=forked_main, daemon=True,
            args=("rank", cmd[2], cmd[3:], env, ROOT, log_path))
        proc.start()
        self.spawned += 1
        return ForkedReplica(proc)

    @staticmethod
    def helper_pids() -> dict:
        """The pids of the forkserver and of the resource tracker that
        ``start`` began (None where not running): this process's
        children."""
        from multiprocessing import forkserver, resource_tracker
        return {"forkserver": forkserver._forkserver._forkserver_pid,
                "resource_tracker": resource_tracker._resource_tracker._pid}

    def stop(self) -> None:
        """End the forkserver, then the resource tracker ``start``
        began, each waited for: a helper left to exit after this process
        would outlive it as a zombie no one reaps.  The forkserver's
        children are the routers' to stop."""
        from multiprocessing import forkserver, resource_tracker
        for helper in (forkserver._forkserver,
                       resource_tracker._resource_tracker):
            stop = getattr(helper, "_stop", None)
            if stop is not None:
                stop()


@contextlib.contextmanager
def fleet_depth(layers=None, model: str = "transformer_tpu"):
    """``model`` (``transformer_tpu``) at ``layers`` (``FLEET_LAYERS``)
    of its 12 layers, every width kept, in this process while phases
    13-14 run (their references and exports; each forked replica
    applies the same, :func:`fleet_replica_child`), phase 11's LM
    worker, or the world-1 twins of phases 16 and 19."""
    from dtf_tpu_torch.models import registry
    kept = registry._REGISTRY[model]
    ctor, classes, l2 = kept
    registry._REGISTRY[model] = (
        functools.partial(ctor, num_layers=layers or FLEET_LAYERS),
        classes, l2)
    try:
        yield
    finally:
        registry._REGISTRY[model] = kept


# phases 13-14 run transformer_tpu at 6 of its 12 layers, every width
# kept, so the whole script ends within 1050 s of its 1200 s limit on a
# slow host (1069 s there at 12 layers, PERF.md); their gates do not
# depend on depth
FLEET_LAYERS = 6


def fleet_prompts(seed: int):
    """16 requests of 4 families (a 256-token system prompt each, then a
    tail of U[1, 128] tokens), the family heads first; then 4 cold
    prompts of 48 tokens that follow a respawn."""
    import numpy as np
    rng = np.random.default_rng(seed + 13)
    fams = [rng.integers(0, 32768, (FLEET_SYS,)).astype(np.int32)
            for _ in range(FLEET_FAMILIES)]
    prompts = [np.concatenate([fams[i % FLEET_FAMILIES], rng.integers(
        0, 32768, (int(rng.integers(1, FLEET_TAIL + 1)),)).astype(np.int32)])
        for i in range(FLEET_REQUESTS)]
    cold = [rng.integers(0, 32768, (48,)).astype(np.int32) for _ in range(4)]
    return prompts, cold


def fleet_argv(seed: int, dtype: str, root: str):
    return ["--serve_random_init", "--device", "cuda", "--model",
            "transformer_tpu", "--dtype", dtype, "--seed", str(seed),
            "--kv_page_size", "16", "--serve_prefill_chunk", "64",
            "--serve_max_batch", "8", "--serve_max_seq_len", "512",
            "--heartbeat_secs", "1", "--router_health_timeout_s", "30",
            "--rendezvous_dir", root]


def fleet_reference(torch, seed: int, prompts) -> list:
    """Greedy tokens of one in-process port ServeEngine, float32, on the
    replicas' weights (the same seed)."""
    from dtf_tpu_torch.cli.serve_main import build_serving_engine
    from dtf_tpu_torch.config import parse_flags
    cfg = parse_flags(fleet_argv(seed, "fp32", "")[1:])
    model, engine = build_serving_engine(cfg, random_init=True)
    try:
        handles = [engine.submit(p, max_new_tokens=FLEET_NEW)
                   for p in prompts]
        tokens = [h.result(timeout=600).tokens for h in handles]
    finally:
        engine.stop(drain=False)
    del model, engine
    torch.cuda.empty_cache()
    return tokens


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def scrape_series(port: int) -> dict:
    """name -> value of every sample line of one /metrics page."""
    _, body = scrape(f"http://127.0.0.1:{port}/metrics")
    out = {}
    for ln in body.splitlines():
        if ln and not ln.startswith("#"):
            name, _, val = ln.rpartition(" ")
            try:
                out[name] = float(val)
            except ValueError:
                pass
    return out


def read_chain(root: str, replica_id: int, prompt):
    """The registered page chain of ``prompt`` on one replica, pulled
    over its wire (``page_fetch``, the migration's own op): each page's
    payload digest, its raw payload bytes and its wire bytes."""
    import socket

    from dtf_tpu_torch.serve import migrate
    from dtf_tpu_torch.serve.replica import read_announce
    ann = read_announce(root, replica_id)
    sock = socket.create_connection((ann["host"], ann["port"]), timeout=60)
    rfile, wfile = sock.makefile("rb"), sock.makefile("wb")
    xfer = f"read{replica_id}"
    try:
        wfile.write((json.dumps({"op": "page_fetch", "xfer": xfer,
                                 "prompt": [int(t) for t in prompt],
                                 "lo": 0, "n": 64}) + "\n").encode())
        wfile.flush()
        digests, raw, wire = [], 0, 0
        while True:
            line = rfile.readline()
            msg = json.loads(line)
            if msg.get("xfer") != xfer:
                continue
            if msg.get("error"):
                raise AssertionError(f"page_fetch: {msg['error']}")
            if msg.get("end"):
                break
            leaves = migrate.decode_page(msg["payload"])
            digests.append(migrate.payload_digest(leaves))
            raw += sum(leaf.nbytes for leaf in leaves)
            wire += len(line)
        wfile.write((json.dumps({"op": "page_fetch", "xfer": xfer,
                                 "release": True}) + "\n").encode())
        wfile.flush()
    finally:
        for c in (rfile, wfile, sock):
            c.close()
    return digests, raw, wire


def fleet_trace(path: str) -> dict:
    """From the router's trace: each migration's ms a page (its command
    to its ack, over its pages); after a replica loss, the seconds to
    the last re-dispatched request's completion (failover resolve) and
    to the respawned replica's registration."""
    recs = []
    with open(path) as f:
        for line in f:
            recs.append(json.loads(line))
    t_start, pages, mig_ms = {}, {}, []
    lost, requeued, done, registered = None, set(), {}, []
    for rec in recs:
        name = rec.get("name")
        if name == "chain_migrate":
            t_start[rec["xfer"]] = rec["ts"]
            pages[rec["xfer"]] = rec["pages"]
        elif name == "chain_migrated" and rec["xfer"] in t_start:
            mig_ms.append(1e3 * (rec["ts"] - t_start[rec["xfer"]])
                          / pages[rec["xfer"]])
        elif name == "replica_lost" and lost is None:
            lost = rec["ts"]
        elif name == "router_requeue":
            requeued.add(rec["request"])
        elif name == "router_complete":
            done[rec["request"]] = rec["ts"]
        elif name == "replica_registered" and lost is not None:
            registered.append(rec["ts"])
    out = {"ms_per_migrated_page": mig_ms}
    if lost is not None:
        out["requeued"] = len(requeued)
        out["failover_resolve_s"] = max(
            (done[r] for r in requeued if r in done), default=lost) - lost
        out["respawn_registered_s"] = (min(registered) - lost
                                       if registered else None)
    return out


def fleet_run(seed: int, card: str, prompts, cold, *, dtype: str,
              prefill: int, kill: bool, forks) -> dict:
    """Two replica_main processes on the card behind an in-process port
    Router, forked by ``forks`` with router_main's replica command;
    affinity placement; every request consumed through
    its token stream.  ``kill``: replica_kill@req:6 mid-burst, then the
    respawned replica serves cold prompts.  ``prefill``: the family
    heads prefill on replica 0, their chains migrate to replica 1, and
    the siblings decode there."""
    import glob
    import tempfile
    import threading

    import numpy as np

    from dtf_tpu_torch import chaos
    from dtf_tpu_torch.cli import router_main
    from dtf_tpu_torch.config import parse_flags
    from dtf_tpu_torch.obs import trace
    from dtf_tpu_torch.serve.router import Router

    root = tempfile.mkdtemp(prefix=f"fleet_{dtype}_{prefill}_")
    cfg = parse_flags(fleet_argv(seed, dtype, root)[1:],
                      defaults=router_main.ROUTER_DEFAULTS)
    cmd = router_main.replica_command(cfg, random_init=True)
    assert cmd[1:3] == ["-m", "dtf_tpu_torch.cli.replica_main"], cmd
    metrics = [free_port(), free_port()]
    spawn = forks.spawner(cmd[3:], root, extra_flags=lambda rid: [
        "--metrics_port", str(metrics[rid])])
    tdir = os.path.join(root, "trace")
    trace.configure(tdir, stream="router")
    router = Router(2, root, spawn=spawn, page_size=16,
                    placement="affinity", deadline_s=600.0,
                    probe_interval_s=0.5, health_timeout_s=30.0,
                    replica_inflight=64, prefill_replicas=prefill,
                    migrate_timeout_s=120.0, seed=seed)
    t0 = time.time()
    router.start(wait_s=300)
    start_s = time.time() - t0
    streams = {}

    def consume(i, handle, t_submit):
        toks, first = [], None
        for tok in handle.stream(timeout=600):
            if first is None:
                first = time.time() - t_submit
            toks.append(tok)
        streams[i] = (toks, first)

    def burst(idx, plist):
        threads, handles = [], {}
        for i, p in zip(idx, plist):
            h = router.submit(p, max_new_tokens=FLEET_NEW)
            handles[i] = h
            th = threading.Thread(target=consume, args=(i, h, time.time()),
                                  daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=900)
        return {i: h.result(timeout=60) for i, h in handles.items()}

    line = {"phase": "fleet", "card": card, "dtype": dtype,
            "arm": "disagg" if prefill else "colocated",
            "model": "transformer_tpu", "replicas": 2,
            "prefill_replicas": prefill, "start_s": start_s}
    try:
        results = {}
        t1 = time.time()
        if prefill:
            heads = list(range(FLEET_FAMILIES))
            results.update(burst(heads, [prompts[i] for i in heads]))
            deadline = time.time() + 120
            while (router.migration_stats()["migrated"] < FLEET_FAMILIES
                   and time.time() < deadline):
                time.sleep(0.05)
            line["migration_wait_s"] = time.time() - t1
            rest = list(range(FLEET_FAMILIES, len(prompts)))
            results.update(burst(rest, [prompts[i] for i in rest]))
        else:
            if kill:
                chaos.configure("replica_kill@req:6", rank=0)
            results.update(burst(range(len(prompts)), prompts))
        wall = time.time() - t1
        chaos.disable()
        line["migrations"] = router.migration_stats()
        line["failovers"] = router.metrics.get("router_failover_total").value
        line["respawns"] = router.metrics.get(
            "router_replica_respawns_total").value
        if kill:
            # the router counts a respawn when its probe sees the killed
            # process gone, which can come after a fast burst has ended:
            # wait for it and for both replicas healthy, then read it
            respawns = router.metrics.get("router_replica_respawns_total")
            deadline = time.time() + 300
            while time.time() < deadline and not (
                    respawns.value >= 1 and all(
                        router.replica_healthy(r) for r in (0, 1))):
                time.sleep(0.2)
            line["respawns"] = respawns.value
            before = [router.replica_completed(r) for r in (0, 1)]
            extra = range(len(prompts), len(prompts) + len(cold))
            results.update(burst(extra, cold))
            line["served_after_respawn"] = [
                router.replica_completed(r) - before[r] for r in (0, 1)]
        tokens = [results[i].tokens for i in sorted(results)]
        line["streams_equal_results"] = all(
            streams[i][0] == results[i].tokens for i in results)
        line["diverged"] = sum(r.diverged for r in results.values())
        line["replica_of"] = [results[i].replica for i in sorted(results)]
        n_tok = sum(len(results[i].tokens) for i in range(len(prompts)))
        line["tokens_per_s"] = n_tok / wall
        ttft = sorted(streams[i][1] for i in range(len(prompts)))
        line["ttft_p50_s"] = statistics.median(ttft)
        line["stats"] = [router.replica_stats(r, timeout=30) for r in (0, 1)]
        line["ledger_calls"] = [
            {k: v for k, v in scrape_series(port).items()
             if k.startswith("ledger_serve_") and k.endswith("_calls")}
            for port in metrics]
        if prefill:
            chains = [[read_chain(root, r, prompts[f]) for r in (0, 1)]
                      for f in range(FLEET_FAMILIES)]
            line["chain_pages"] = [len(c[0][0]) for c in chains]
            line["chain_digests_equal"] = all(
                c[0][0] == c[1][0] and c[0][0] for c in chains)
            line["payload_bytes_per_page"] = chains[0][0][1] / len(
                chains[0][0][0])
            line["wire_bytes_per_page"] = chains[0][0][2] / len(
                chains[0][0][0])
    finally:
        chaos.disable()
        router.stop(drain=True)
        trace.disable()
    launches = {}
    for path in sorted(glob.glob(os.path.join(root, "launches_rank*.json"))):
        with open(path) as f:
            launches[os.path.basename(path)[9:-5]] = json.load(f)
    line["launches"] = launches
    line.update(fleet_trace(os.path.join(tdir, "trace_router.jsonl")))
    line["wall_s"] = time.time() - t0
    emit(line)
    line["tokens"] = tokens
    return line


def serve_fleet(torch, seed: int, card: str, forks) -> dict:
    """Phase 13 (see the module docstring); ``forks`` forks the replica
    processes (:class:`ReplicaForkServer`)."""
    prompts, cold = fleet_prompts(seed)
    ref = fleet_reference(torch, seed, prompts + cold)
    emit({"phase": "replica_forkserver", "ready_s": forks.ready()})
    colo = fleet_run(seed, card, prompts, cold, dtype="fp32", prefill=0,
                     kill=True, forks=forks)
    dis = fleet_run(seed, card, prompts, cold, dtype="fp32", prefill=1,
                    kill=False, forks=forks)
    dis16 = fleet_run(seed, card, prompts, cold, dtype="bf16", prefill=1,
                      kill=False, forks=forks)
    n = len(prompts)

    def k(run, rank, kernel):
        return sum(v[kernel] for name, v in run["launches"].items()
                   if name.startswith(f"rank{rank}."))

    # the SIGKILLed replica: the one whose respawn (generation 1) wrote
    # its counts at exit
    killed = [r for r in (0, 1) if f"rank{r}.gen1" in colo["launches"]]
    gates = {
        "colocated_tokens_equal_engine": colo["tokens"] == ref,
        "colocated_respawned_and_served": (
            colo["respawns"] == 1 and colo["failovers"] >= 1
            and len(killed) == 1
            and colo["served_after_respawn"][killed[0]] > 0),
        "streams_exact": all(r["streams_equal_results"] and not r["diverged"]
                             for r in (colo, dis, dis16)),
        "disagg_tokens_equal_colocated": dis["tokens"] == colo["tokens"][:n],
        "disagg_imported_and_hit": all(
            r["stats"][1]["serve_pages_imported_total"] > 0
            and r["stats"][1]["serve_prefix_hit_pages_total"] > 0
            and r["migrations"]["migrated"] == FLEET_FAMILIES
            for r in (dis, dis16)),
        "chain_digests_equal": dis["chain_digests_equal"]
        and dis16["chain_digests_equal"],
        "ledger_prefill_on_0_decode_on_1": all(
            any(key.startswith("ledger_serve_prefill_chunk_c") and val > 0
                for key, val in r["ledger_calls"][0].items())
            and r["ledger_calls"][1].get("ledger_serve_decode_step_calls",
                                         0) > 0
            for r in (dis, dis16)),
        "kernels_launched": all(
            k(r, 0, "K1") + k(r, 1, "K1") > 0
            and k(r, 0, "K4") + k(r, 1, "K4") > 0 for r in (colo, dis, dis16))
        and k(dis, 1, "K4") > 0 and k(dis, 0, "K1") > 0,
    }
    line = {"phase": "fleet_gates", "card": card, **gates,
            "killed_replica": killed,
            "k1_replica1_disagg": [k(dis, 1, "K1"), k(dis16, 1, "K1")]}
    emit(line)
    if not all(gates.values()):
        raise AssertionError(f"fleet: {line}")
    return {"colocated": colo, "disagg": dis, "disagg_bf16": dis16,
            "prompts": prompts, "reference": ref[:n],
            "cold": cold, "cold_reference": ref[n:],
            "launches": {arm: {kern: k(r, 0, kern) + k(r, 1, kern)
                               for kern in ("K1", "K4")}
                         for arm, r in (("colocated_f32", colo),
                                        ("disagg_f32", dis),
                                        ("disagg_bf16", dis16))}}


# ---------------------------------------------------------------------------
# phase 14: the fleet's HA pair and zero-downtime rollout (serve/ha.py,
# serve/rollout.py, serve/journal.py) -- one tier of replica processes
# on the card, routers coming and going in this process
# ---------------------------------------------------------------------------

HA_TTL = 1.0            # the leader lease's time to live, seconds
HA_PUMP_SHARE = 0.25    # live traffic: this share of the baseline burst's
                        # request rate, offered one request at a time
HA_COLD_EVERY = 3       # A->B: one of phase 13's cold prompts every this
                        # many of the pump's requests, each sent once (all
                        # four inside the rollout: a replica forked by the
                        # pre-imported spawner swaps in seconds)
HA_LOSS_WINDOW_S = 1.0  # a failed migration's replica_lost follows it
HA_ALLOW = ("injected_fault", "stale_epoch", "router_fenced")
# the JAX rollout smoke's allowlist, and migration_failed: a replica the
# chaos kills can take a heal-time prefetch of a hot chain down with it
# (each such record is held to that loss: ha_migration_failures)
ROLLOUT_ALLOW = ("injected_fault", "rollout_rollback", "canary_divergence",
                 "replica_lost", "migration_failed")


def export_fleet_checkpoints(torch, cfg, root: str):
    """Three exports by the port's ``export_model`` of one seeded param
    set (the replicas' ``--serve_random_init`` weights): A, the
    incumbent; B, an identical re-export in its own directory; C, a
    perturbed copy (seeded noise of half each weight matrix's std).
    Returns their paths once A is written and the thread writing B and
    C (the tier starts on A meanwhile)."""
    import threading

    from dtf_tpu_torch.models.registry import build_model
    from dtf_tpu_torch.serve import bridge
    from dtf_tpu_torch.train.checkpoint import export_model
    model, _ = build_model(cfg.model, num_classes=cfg.num_classes,
                           dtype=torch.float32)
    bridge.random_init(model, cfg.seed)
    out = {k: os.path.join(root, f"ckpt_{k.lower()}") for k in "ABC"}
    export_model(out["A"], model)

    def rest():
        export_model(out["B"], model)
        gen = torch.Generator().manual_seed(cfg.seed + 14)
        with torch.no_grad():
            for p in model.parameters():
                if p.dim() == 2:
                    p.add_(torch.randn(p.shape, generator=gen) * 0.5
                           * p.std())
        export_model(out["C"], model)
    writer = threading.Thread(target=rest, daemon=True)
    writer.start()
    return out, writer


class HaClient:
    """The clients of one router: each request consumed through its
    stream on a thread of its own (tokens delivered, time to the first),
    until it resolves or the stream goes silent (the router died)."""

    def __init__(self, router, prompts, silence_s: float = 600.0):
        import threading
        self.router, self.prompts = router, prompts
        self.silence_s = silence_s
        self.reqs = []          # (prompt index, handle, tokens, t0, box)
        self._threads = []
        self._threading = threading

    def submit(self, i: int):
        h = self.router.submit(self.prompts[i], max_new_tokens=FLEET_NEW)
        got, box, t0 = [], {}, time.time()

        def consume():
            try:
                for tok in h.stream(timeout=self.silence_s):
                    if not got:
                        box["ttft"] = time.time() - t0
                    got.append(tok)
            except (TimeoutError, RuntimeError) as e:
                box["error"] = repr(e)
        th = self._threading.Thread(target=consume, daemon=True)
        th.start()
        self._threads.append(th)
        self.reqs.append((i, h, got, t0, box))
        return h

    def join(self, timeout: float = 900.0) -> None:
        for th in self._threads:
            th.join(timeout=timeout)


class HaPump(HaClient):
    """Live traffic through a rollout: one prompt every ``interval_s``
    cycling through the burst's (the first ``n`` of ``prompts``); once
    ``cold`` is set, every ``HA_COLD_EVERY``-th request is the next of
    those prompt indices instead, each sent once.  A shed is counted,
    never retried."""

    def __init__(self, router, prompts, n: int, interval_s: float,
                 silence_s: float = 600.0):
        super().__init__(router, prompts, silence_s)
        self.n, self.interval_s = n, interval_s
        self.cold: list = []
        self.shed = 0
        self._stop = self._threading.Event()
        self._thread = self._threading.Thread(target=self._run, daemon=True)

    def _run(self):
        from dtf_tpu_torch.serve.engine import Backpressure
        i = sent = 0
        while not self._stop.wait(self.interval_s):
            sent += 1
            cold = bool(self.cold) and sent % HA_COLD_EVERY == 0
            try:
                self.submit(self.cold.pop(0) if cold else i % self.n)
            except Backpressure:
                self.shed += 1
            except RuntimeError:      # the router died or stopped
                return
            i += not cold

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)

    def check(self, oracle, stage: str) -> dict:
        """Zero shed, zero lost, every request token-exact against the
        oracle and streamed exactly once."""
        self.join()
        if self.shed or not self.reqs:
            raise AssertionError(f"{stage}: shed {self.shed}, submitted "
                                 f"{len(self.reqs)}")
        for i, h, got, _, box in self.reqs:
            res = h.result(timeout=300)
            if res.tokens != oracle[i] or got != res.tokens:
                raise AssertionError(
                    f"{stage}: prompt {i} replica {res.replica} version "
                    f"{res.version!r}: {res.tokens[:8]} streamed "
                    f"{got[:8]} want {oracle[i][:8]} {box}")
        return {"requests": len(self.reqs), "shed": 0, "lost": 0}


def ha_freeze(router) -> None:
    """What a SIGKILL leaves of a router, in process: loops stopped,
    connections severed mid-stream, nothing resolved, the journal's
    tail as it is (tools/router_ha_smoke.py's freeze)."""
    import socket
    with router._mu:
        router._stopping = True
        router._mu.notify_all()
    for rep in router._replicas:
        conn = rep.conn
        if conn is not None:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        router._close_conn(rep)


def ha_reaper(routers, stop) -> None:
    """Reap the tier's exited processes, whichever router spawned them:
    a frozen router never waits on its children again, so a successor
    that stops one by the pid its announce names sees it gone."""
    while not stop.wait(0.1):
        for router in list(routers):
            for rep in router._replicas:
                proc = rep.proc
                if proc is not None:
                    proc.poll()


def ha_pid_gone(pid) -> bool:
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return True
    return False


def ha_tier_pids(root: str) -> dict:
    from dtf_tpu_torch.serve.replica import read_announce
    return {rid: (read_announce(root, rid) or {}).get("pid")
            for rid in (0, 1)}


def ha_trace_check(tdir: str, allow) -> dict:
    cmd = [sys.executable, "-m", "dtf_tpu_torch.cli.trace_main", tdir,
           "--check"]
    for kind in allow:
        cmd += ["--allow", kind]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                          timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"trace_main --check {tdir}: "
                             f"{proc.stdout[-3000:]} {proc.stderr[-2000:]}")
    return {"dir": os.path.basename(tdir), "allow": list(allow),
            "ok": True}


def ha_migration_failures(path: str) -> int:
    """The router trace's failed migrations, each held to the loss of
    one of its endpoints: its error names the loss's reason, and within
    ``HA_LOSS_WINDOW_S`` after it comes the ``replica_lost`` record of
    its source or target for that reason (the router fails a lost
    replica's migrations, then records the loss: one event, so one
    generation of that replica).  Those losses are no more than the
    kills the trace injected.  Returns the failures' count."""
    with open(path) as f:
        recs = [json.loads(ln) for ln in f]
    lost = [r for r in recs if r.get("name") == "replica_lost"]
    kills = sum(r.get("name") == "injected_fault"
                and r.get("fault_kind") in ("rollout_kill", "replica_kill")
                for r in recs)
    failed = [r for r in recs if r.get("name") == "migration_failed"]
    causes = set()
    for rec in failed:
        cause = [i for i, r in enumerate(lost)
                 if r["replica"] in (rec["source"], rec["target"])
                 and rec.get("error") == f"replica_lost:{r.get('reason')}"
                 and 0 <= r["ts"] - rec["ts"] <= HA_LOSS_WINDOW_S]
        if not cause:
            raise AssertionError(f"ha_rollout: a migration failed with no "
                                 f"replica lost just after it: {rec}")
        causes.add(cause[0])
    if len(causes) > kills:
        raise AssertionError(f"ha_rollout: migrations failed with "
                             f"{len(causes)} replicas lost, {kills} killed")
    return len(failed)


def ha_swaps(path: str) -> list:
    """From a router trace: each planned replica swap, its drain's start
    to the replica's next registration (the truncated canary's failed
    start included in its rollback's swap)."""
    recs = []
    with open(path) as f:
        for line in f:
            recs.append(json.loads(line))
    out, start = [], {}
    for rec in recs:
        name, rid = rec.get("name"), rec.get("replica")
        if name == "replica_drain":
            start.setdefault(rid, rec["ts"])
        elif name == "replica_registered" and rid in start:
            out.append({"replica": rid,
                        "s": rec["ts"] - start.pop(rid)})
    return out


def trace_events(tdir: str, name: str) -> list:
    from dtf_tpu_torch.obs import trace
    trace.flush()
    with open(os.path.join(tdir, "trace_router.jsonl")) as f:
        return [rec for rec in map(json.loads, f) if rec.get("name") == name]


def ha_launches(root: str) -> dict:
    """Per replica process (``rank{K}.gen{G}``): its launches at exit
    and, for the tier's first processes, the snapshot taken when the
    HA stages ended."""
    import glob
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "launches_rank*.json"))):
        key = os.path.basename(path)[9:-5]
        with open(path) as f:
            out[key] = json.load(f)
    return out


def serve_ha_rollout(torch, seed: int, card: str, prompts, ref, cold,
                     cold_ref, forks, argv=None) -> dict:
    """Phase 14 (see the module docstring): phase 13's prompts and cold
    prompts with the engine's tokens for each.  ``argv`` replaces
    ``fleet_argv`` (a small CPU tier for a debugging run); ``forks``
    forks the replica processes (:class:`ReplicaForkServer`)."""
    import concurrent.futures
    import shutil
    import signal
    import tempfile
    import threading

    from dtf_tpu_torch import chaos
    from dtf_tpu_torch.cli import router_main
    from dtf_tpu_torch.config import parse_flags
    from dtf_tpu_torch.obs import trace
    from dtf_tpu_torch.serve import ha
    from dtf_tpu_torch.serve import journal as journal_mod
    from dtf_tpu_torch.serve.rollout import (RolloutController,
                                             RolloutState,
                                             default_state_path)
    from dtf_tpu_torch.serve.router import Router

    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="ha_rollout_")
    argv = list(argv or fleet_argv(seed, "fp32", root))
    argv[argv.index("--rendezvous_dir") + 1] = root
    cfg = parse_flags([a for a in argv if a != "--serve_random_init"],
                      defaults=router_main.ROUTER_DEFAULTS)
    t0 = time.time()
    ckpt, writer = export_fleet_checkpoints(torch, cfg, root)
    export_s = time.time() - t0
    cfg = cfg.replace(export_dir=ckpt["A"])
    cmd = router_main.replica_command(cfg, random_init=False)
    assert cmd[1:3] == ["-m", "dtf_tpu_torch.cli.replica_main"], cmd
    tdirs = {k: os.path.join(root, f"trace_{k}") for k in ("ha", "rollout")}
    state_path = default_state_path(root)
    routers, line = [], {"phase": "ha_rollout", "card": card,
                         "model": cfg.model, "dtype": cfg.dtype,
                         "replicas": 2, "export_s": export_s,
                         "lease_ttl_s": HA_TTL}

    def make_router(epoch, trace_key, journal=True, crashed=None):
        ckpt_map: dict = {}
        box = []

        def crash_hook():
            # router_kill's os._exit, in process: on the dispatching
            # thread, under the router's lock, the router freezes where
            # it stands (what it had queued stays queued) and the
            # thread ends
            ha_freeze(box[0])
            crashed.set()
            raise SystemExit
        spawn = forks.spawner(
            cmd[3:], root, env_extra={"DTF_TRACE_DIR": tdirs[trace_key]},
            checkpoint_map=ckpt_map)
        router = Router(
            2, root, spawn=spawn, checkpoint_map=ckpt_map, page_size=16,
            placement="affinity", deadline_s=600.0, probe_interval_s=0.25,
            health_timeout_s=30.0, replica_inflight=64,
            respawn_backoff_s=0.2, max_respawns=4, seed=seed,
            journal_path=(journal_mod.journal_path(root) if journal
                          else None),
            epoch=epoch, role="leader",
            crash_hook=crash_hook if crashed is not None else None)
        box.append(router)
        routers.append(router)
        return router

    def burst(router, idx):
        client = HaClient(router, prompts)
        t1 = time.time()
        for i in idx:
            client.submit(i)
        results = [h.result(timeout=600) for _, h, _, _, _ in client.reqs]
        client.join()
        wall = time.time() - t1
        return ([r.tokens for r in results],
                {"requests_per_s": len(results) / wall,
                 "tokens_per_s": sum(len(r.tokens) for r in results) / wall,
                 "ttft_p50_s": statistics.median(
                     box["ttft"] for *_, box in client.reqs)})

    def crash_watch(keeper, crashed):
        crashed.wait()
        keeper.stop()           # a dead process renews nothing

    def rollout(router, new, old, **kw):
        args = dict(old_checkpoint=old, canary_requests=3,
                    mirror_fraction=1.0, warm_timeout_s=600.0,
                    drain_timeout_s=120.0, gate_timeout_s=300.0)
        args.update(kw)
        t1 = time.time()
        state = RolloutController(router, new, **args).run()
        return state, time.time() - t1

    n = len(prompts)
    everything = list(range(n))
    reaping = threading.Event()
    threading.Thread(target=ha_reaper, args=(routers, reaping),
                     daemon=True).start()
    try:
        # -- HA 1: a tier and its baseline burst (the token oracle) -----
        trace.configure(tdirs["ha"], stream="router")
        r0 = make_router(0, "ha", journal=False)
        t1 = time.time()
        r0.start(wait_s=600)
        line["tier_start_s"] = time.time() - t1
        oracle, line["baseline"] = burst(r0, everything)
        line["oracle_equals_engine"] = oracle == ref
        if not line["oracle_equals_engine"]:
            raise AssertionError("ha_rollout: export A does not serve the "
                                 "engine's tokens")
        # live traffic's prompts: the burst's, then phase 13's cold ones
        # (no prefix of theirs anywhere in this tier), the engine's
        # tokens for each the oracle
        live, oracle_live = list(prompts) + list(cold), oracle + cold_ref
        pump_s = 1.0 / (HA_PUMP_SHARE * line["baseline"]["requests_per_s"])

        def pump(router, silence_s=600.0):
            return HaPump(router, live, n, pump_s, silence_s)
        # the tier's spawner steps aside as a dead router would: its
        # handles keep the processes for the cleanup
        ha_freeze(r0)

        # -- HA 2: router_kill@req:5 kills the epoch-1 leader mid-burst --
        crashed = threading.Event()
        lease1 = ha.LeaderLease(root, ttl_s=HA_TTL, holder="leader")
        if lease1.acquire() != 1:
            raise AssertionError("ha_rollout: lease epoch 1")
        r1 = make_router(1, "ha", crashed=crashed)
        r1.start(wait_s=120, adopt=True)
        keeper1 = ha.LeaseKeeper(lease1, on_fenced=r1.fence).start()
        watcher = threading.Thread(target=crash_watch,
                                   args=(keeper1, crashed), daemon=True)
        watcher.start()
        pids = ha_tier_pids(root)
        chaos.configure("router_kill@req:5", rank=0)
        client = HaClient(r1, prompts, silence_s=2.0)
        with r1._mu:        # the whole burst queued before dispatch 1
            for i in everything:
                client.submit(i)
        if not crashed.wait(timeout=300):
            raise AssertionError("ha_rollout: router_kill@req:5 never fired")
        t_kill = time.time()
        watcher.join(timeout=60)
        client.join()
        chaos.disable()
        delivered = {h.request.id: list(got)
                     for _, h, got, _, _ in client.reqs}
        resolved_pre = {h.request.id: h.result(timeout=0.001).tokens
                        for _, h, _, _, _ in client.reqs
                        if h.done() and h._exc is None}
        lease2 = ha.LeaderLease(root, ttl_s=HA_TTL, holder="standby")
        epoch2 = ha.wait_for_takeover(lease2, poll_s=0.05, timeout_s=60.0)
        t_acquire = time.time()
        if epoch2 != 2:
            raise AssertionError(f"ha_rollout: standby epoch {epoch2}")
        r2 = make_router(2, "ha")
        r2.start(wait_s=120, adopt=True)
        summary = ha.take_over(r2, delivered=delivered)
        adopted = {h.request.id for _, h, _, _, _ in client.reqs} \
            - set(resolved_pre)
        if set(summary["handles"]) != adopted:
            raise AssertionError(f"ha_rollout: lost requests: adopted "
                                 f"{sorted(summary['handles'])}, want "
                                 f"{sorted(adopted)}")
        exact = True
        for i, h, got, _, _ in client.reqs:
            rid = h.request.id
            if rid in resolved_pre:
                exact &= resolved_pre[rid] == oracle[i]
                continue
            nh = summary["handles"][rid]
            tail = list(nh.stream(timeout=600))
            res = nh.result(timeout=60)
            exact &= (delivered[rid] + tail == oracle[i]
                      and res.tokens == oracle[i] and not res.diverged)
        t_done = time.time()
        takeover = {
            "kill_to_acquire_s": t_acquire - t_kill,
            "kill_to_last_readopted_done_s": t_done - t_kill,
            "readopted": summary["readopted"],
            "redispatched": summary["redispatched"],
            "resolved_before_kill": len(resolved_pre),
            "tokens_delivered_before_kill": sum(map(len, delivered.values())),
            "exactly_once_token_exact": exact,
            "pids_unchanged": ha_tier_pids(root) == pids,
            "respawns": r2.metrics.get("router_replica_respawns_total").value,
            "takeovers": r2.metrics.get("router_takeover_total").value}
        line["takeover"] = takeover
        if not (exact and takeover["pids_unchanged"]
                and takeover["redispatched"] >= 1
                and takeover["respawns"] == 0 and takeover["takeovers"] == 1):
            raise AssertionError(f"ha_rollout: takeover {takeover}")

        # -- HA 3: an epoch-3 force-take fences the epoch-2 router -------
        lease3 = ha.LeaderLease(root, ttl_s=HA_TTL, holder="usurper")
        r3 = make_router(3, "ha")
        if lease3.acquire(force=True) != 3:
            raise AssertionError("ha_rollout: force-take epoch")
        keeper3 = ha.LeaseKeeper(lease3, on_fenced=r3.fence).start()
        r3.start(wait_s=120, adopt=True)
        # a burst queued whole before one dispatch pass, so both
        # replicas take a share and see epoch 3 (a replica learns the
        # epoch from the ops it is sent)
        client3 = HaClient(r3, prompts)
        with r3._mu:
            for i in everything:
                client3.submit(i)
        res3 = [h.result(timeout=600) for _, h, _, _, _ in client3.reqs]
        client3.join()
        ok3 = ([r.tokens for r in res3] == oracle
               and {r.replica for r in res3} == {0, 1})
        try:
            r2.submit(prompts[1], max_new_tokens=FLEET_NEW).result(
                timeout=120)
            rejected = False
        except RuntimeError:
            rejected = True
        deadline = time.time() + 30
        while time.time() < deadline and not r2.health()["fenced"]:
            time.sleep(0.05)
        fencing = {
            "new_leader_exact": ok3
            and r3.generate(prompts[2], max_new_tokens=FLEET_NEW).tokens
            == oracle[2],
            "stale_op_rejected": rejected,
            "stale_epoch_total": r2.metrics.get(
                "router_stale_epoch_total").value,
            "deposed_fenced": r2.health()["fenced"]
            and not r2.health()["ok"]}

        # -- HA 4: lease_stall@4 under the renewing epoch-3 leader -------
        lease4 = ha.LeaderLease(root, ttl_s=HA_TTL, holder="standby2")
        fencing["lease_live_at_stall"] = not lease4.expired()
        t1 = time.time()
        chaos.configure("lease_stall@4", rank=0)
        fencing["stall_takeover_epoch"] = ha.wait_for_takeover(
            lease4, poll_s=0.05, timeout_s=60.0)
        fencing["stall_to_acquire_s"] = time.time() - t1
        deadline = time.time() + 30
        while time.time() < deadline and not r3.health()["fenced"]:
            time.sleep(0.05)
        fencing["stalled_leader_fenced"] = r3.health()["fenced"]
        keeper3.stop()
        chaos.disable()
        for deposed in (r2, r3):    # fenced: they never touch the tier
            deposed.stop(drain=False)
        line["fencing"] = fencing
        if not (fencing["new_leader_exact"] and rejected
                and fencing["stale_epoch_total"] >= 1
                and fencing["deposed_fenced"]
                and fencing["lease_live_at_stall"]
                and fencing["stall_takeover_epoch"] == 4
                and fencing["stalled_leader_fenced"]):
            raise AssertionError(f"ha_rollout: fencing {fencing}")
        # the HA stages' share of the tier's first processes
        for pid in ha_tier_pids(root).values():
            os.kill(pid, signal.SIGUSR1)
        deadline = time.time() + 60
        snaps = [os.path.join(root, f"launches_rank{r}.gen0.snap.json")
                 for r in (0, 1)]
        while time.time() < deadline and not all(map(os.path.exists, snaps)):
            time.sleep(0.05)
        line["ha_s"] = time.time() - t_phase

        # -- rollouts on the epoch-4 leader ------------------------------
        writer.join()
        trace.flush()
        trace.configure(tdirs["rollout"], stream="router")
        crashed4 = threading.Event()
        r4 = make_router(4, "rollout", crashed=crashed4)
        r4.start(wait_s=120, adopt=True)
        keeper4 = ha.LeaseKeeper(lease4, on_fenced=r4.fence).start()
        rollouts = {}

        # A -> B, identical: DONE, token-exact, prefix hits after
        hits0 = r4.metrics.get("router_affinity_hits_total").value
        with pump(r4) as live_pump:
            time.sleep(8 * pump_s)          # steady traffic first
            t_roll = time.time()
            live_pump.cold = list(range(n, len(live)))
            state, wall = rollout(r4, ckpt["B"], ckpt["A"])
        pump_out = live_pump.check(oracle_live, "A->B")
        steady = [box["ttft"]
                  for _, _, _, t, box in live_pump.reqs if t < t_roll]
        during = [(len(got), box["ttft"], i >= n)
                  for i, _, got, t, box in live_pump.reqs if t >= t_roll]
        persisted = RolloutState.load(state_path)
        post, _ = burst(r4, everything)
        hits1 = r4.metrics.get("router_affinity_hits_total").value
        reg_hits = sum((r4.replica_stats(rid, timeout=60) or {}).get(
            "serve_prefix_hit_pages_total", 0) for rid in (0, 1))
        rollouts["A->B"] = {
            "phase": state.phase, "reason": state.reason,
            "compared": state.compared, "diverged": state.diverged,
            "wall_s": wall, **pump_out,
            "mixed": r4.metrics.get("router_mixed_model_total").value,
            "persisted": persisted.phase, "post_burst_exact": post == oracle,
            "affinity_hits_after": hits1 - hits0,
            "replica_prefix_hit_pages": reg_hits,
            "announced": [r4.replica_announced_checkpoint(r) == ckpt["B"]
                          for r in (0, 1)],
            "steady_ttft_p50_s": statistics.median(steady),
            "during_ttft_p50_s": statistics.median(d[1] for d in during),
            "during_tokens_per_s": sum(d[0] for d in during) / wall,
            "during_cold_ttft_s": [d[1] for d in during if d[2]],
            "offered_requests_per_s": 1.0 / pump_s}
        g = rollouts["A->B"]
        if not (state.phase == "DONE" and not state.diverged
                and g["mixed"] == 0 and persisted.phase == "DONE"
                and g["post_burst_exact"] and g["affinity_hits_after"] >= n
                and reg_hits >= 1 and all(g["announced"])
                and len(g["during_cold_ttft_s"]) == len(cold)):
            raise AssertionError(f"ha_rollout: A->B {g}")

        # B -> C, perturbed: the canary gate rolls it back
        with pump(r4) as live_pump:
            state, wall = rollout(r4, ckpt["C"], ckpt["B"])
        rollouts["B->C"] = {
            "phase": state.phase, "reason": state.reason,
            "compared": state.compared, "diverged": state.diverged,
            "first_divergence_pos": state.first_divergence_pos,
            "wall_s": wall, **live_pump.check(oracle, "B->C"),
            "mixed": r4.metrics.get("router_mixed_model_total").value}
        g = rollouts["B->C"]
        if not (state.phase == "ROLLED_BACK"
                and state.reason.startswith("canary_divergence")
                and state.diverged >= 1 and g["mixed"] == 0):
            raise AssertionError(f"ha_rollout: B->C {g}")

        # rollout_kill@phase:rolling: a replica SIGKILLed after the gate
        chaos.configure("rollout_kill@phase:rolling", rank=0)
        with pump(r4) as live_pump:
            state, wall = rollout(r4, ckpt["B"], ckpt["B"])
        chaos.disable()
        rollouts["rollout_kill"] = {
            "phase": state.phase, "reason": state.reason,
            "compared": state.compared, "wall_s": wall,
            **live_pump.check(oracle, "rollout_kill")}
        if state.phase != "ROLLED_BACK":
            raise AssertionError(f"ha_rollout: rollout_kill "
                                 f"{rollouts['rollout_kill']}")

        # ckpt_truncate against the new export: the canary cannot load
        ckpt["D"] = os.path.join(root, "ckpt_d")
        shutil.copytree(ckpt["B"], ckpt["D"])
        chaos.configure("ckpt_truncate@latest", rank=0)
        with pump(r4) as live_pump:
            state, wall = rollout(r4, ckpt["D"], ckpt["B"],
                                  warm_timeout_s=300.0)
        chaos.disable()
        failed = [e for e in trace_events(tdirs["rollout"], "replica_replaced")
                  if e.get("checkpoint") == ckpt["D"]]
        log_path = os.path.join(root, "replica%d.retry%d.log" % (
            failed[0]["replica"], failed[0]["generation"])) if failed else ""
        with open(log_path, errors="replace") as f:
            canary_log = f.read()
        rollouts["ckpt_truncate"] = {
            "phase": state.phase, "reason": state.reason, "wall_s": wall,
            **live_pump.check(oracle, "ckpt_truncate"),
            "canary_failed_to_load": "Traceback" in canary_log
            and "ready on port" not in canary_log}
        g = rollouts["ckpt_truncate"]
        if not (state.phase == "ROLLED_BACK"
                and state.reason == "canary_start_failed"
                and g["canary_failed_to_load"]):
            raise AssertionError(f"ha_rollout: ckpt_truncate {g}")

        # -- router_kill while ROLLING: the standby resumes it to DONE ----
        watcher = threading.Thread(target=crash_watch,
                                   args=(keeper4, crashed4), daemon=True)
        watcher.start()
        box = {}

        def roll_b_to_a():
            try:
                box["state"] = rollout(r4, ckpt["A"], ckpt["B"])[0]
            except Exception as e:  # noqa: BLE001 -- the router's death
                box["error"] = repr(e)
        t_roll = time.time()
        with pump(r4, silence_s=2.0) as pump4:
            roller = threading.Thread(target=roll_b_to_a, daemon=True)
            roller.start()
            armed = None
            deadline = time.time() + 600
            while time.time() < deadline and armed is None:
                try:
                    if RolloutState.load(state_path).phase == "ROLLING":
                        with r4._mu:
                            armed = r4._dispatch_seq + 1
                except (OSError, ValueError):
                    pass
                time.sleep(0.02)
            if armed is None:
                raise AssertionError(f"ha_rollout: never ROLLING {box}")
            chaos.configure(f"router_kill@req:{armed}", rank=0)
            if not crashed4.wait(timeout=300):
                raise AssertionError("ha_rollout: router_kill in ROLLING "
                                     "never fired")
            t_kill = time.time()
            watcher.join(timeout=60)
        chaos.disable()
        roller.join(timeout=120)
        pump4.join()
        killed_state = RolloutState.load(state_path)
        delivered = {h.request.id: list(got)
                     for _, h, got, _, _ in pump4.reqs}
        resolved_pre = {h.request.id for _, h, _, _, _ in pump4.reqs
                        if h.done() and h._exc is None}
        lease5 = ha.LeaderLease(root, ttl_s=HA_TTL, holder="standby3")
        if ha.wait_for_takeover(lease5, poll_s=0.05, timeout_s=60.0) != 5:
            raise AssertionError("ha_rollout: epoch 5")
        t_acquire = time.time()
        r5 = make_router(5, "rollout")
        r5.start(wait_s=0, adopt=True)
        # wait for each replica to register, unless its process is gone
        # (no announce: a replacement may still be starting)
        deadline = time.time() + 60
        while time.time() < deadline and not all(
                r5.replica_healthy(r) or (pid and ha_pid_gone(pid))
                for r, pid in ha_tier_pids(root).items()):
            time.sleep(0.05)
        with pump(r5) as pump5:
            summary = ha.take_over(r5, delivered=delivered,
                                   rollout_state_path=state_path)
            t_resumed = time.time()
            time.sleep(6 * pump_s)          # and traffic after it
        exact = True
        for i, h, got, _, _ in pump4.reqs:
            rid = h.request.id
            if rid in resolved_pre:
                exact &= h.result(timeout=1).tokens == oracle[i]
                continue
            if rid not in summary["handles"]:
                raise AssertionError(f"ha_rollout: request {rid} lost in "
                                     f"the takeover")
            nh = summary["handles"][rid]
            tail = list(nh.stream(timeout=600))
            exact &= delivered[rid] + tail == oracle[i] \
                and nh.result(timeout=60).tokens == oracle[i]
        final = RolloutState.load(state_path)
        rollouts["router_kill_rolling"] = {
            "killed_at_dispatch": armed, "kill_phase": killed_state.phase,
            "kill_rolled": killed_state.rolled,
            "controller_exit": box.get("error", box.get("state")),
            "readopted": summary["readopted"],
            "redispatched": summary["redispatched"],
            "resumed": summary.get("rollout_resumed"),
            "final": final.phase, "rolled": final.rolled,
            "kill_to_acquire_s": t_acquire - t_kill,
            "kill_to_done_s": t_resumed - t_kill,
            "wall_s": t_resumed - t_roll,
            "exactly_once_token_exact": exact,
            **pump5.check(oracle, "after the takeover"),
            "post_burst_exact": burst(r5, everything)[0] == oracle,
            "announced": [r5.replica_announced_checkpoint(r) == ckpt["A"]
                          for r in (0, 1)]}
        g = rollouts["router_kill_rolling"]
        g["announced_checkpoints"] = [r5.replica_announced_checkpoint(r)
                                      for r in (0, 1)]
        if not (killed_state.phase == "ROLLING" and g["resumed"] == "DONE"
                and final.phase == "DONE" and sorted(final.rolled) == [0, 1]
                and exact and g["post_burst_exact"] and all(g["announced"])):
            raise AssertionError(f"ha_rollout: router_kill in ROLLING {g}")
        line["rollouts"] = rollouts
    finally:
        chaos.disable()
        for router in reversed(routers):
            router.stop(drain=False)
        reaping.set()
        trace.disable()
        for pid in ha_tier_pids(root).values():
            try:
                os.kill(pid, signal.SIGKILL)
            except (OSError, TypeError):
                pass
    line["swaps"] = ha_swaps(os.path.join(tdirs["rollout"],
                                          "trace_router.jsonl"))
    line["migrations_failed_with_a_lost_replica"] = ha_migration_failures(
        os.path.join(tdirs["rollout"], "trace_router.jsonl"))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        line["traces"] = list(pool.map(
            ha_trace_check, (tdirs["ha"], tdirs["rollout"]),
            (HA_ALLOW, ROLLOUT_ALLOW)))
    launches = ha_launches(root)
    line["launches_by_process"] = launches
    line["wall_s"] = time.time() - t_phase
    emit(line)
    shutil.rmtree(root, ignore_errors=True)
    ha_k = {k: sum(v[k] for name, v in launches.items()
                   if name.endswith(".snap")) for k in ("K1", "K4")}
    total = {k: sum(v[k] for name, v in launches.items()
                    if not name.endswith(".snap")) for k in ("K1", "K4")}
    rolled = {k: total[k] - ha_k[k] for k in ("K1", "K4")}
    canary = launches.get("rank0.gen1", {})
    gates = {"launched_in_ha": ha_k["K1"] > 0 and ha_k["K4"] > 0,
             "launched_in_rollouts": rolled["K1"] > 0 and rolled["K4"] > 0,
             "canary_launched": canary.get("K1", 0) > 0
             and canary.get("K4", 0) > 0}
    emit({"phase": "ha_rollout_gates", "card": card, **gates,
          "launches_ha": ha_k, "launches_rollout": rolled})
    if not all(gates.values()):
        raise AssertionError(f"ha_rollout: launches {gates}")
    return {"line": line, "launches_ha": ha_k, "launches_rollout": rolled}


# ---------------------------------------------------------------------------
# phase 15: ZeRO stages 1-3 (train/zero.py, the Trainer's stages)
# ---------------------------------------------------------------------------

ZERO_STEPS = 6
ZERO_PROBE_STEPS = 2     # the probe run's training steps; the probe's 8
ZERO_BATCH = 4           # global: 2 a rank, 8 ranks on the card at once
ZERO_WIRE_LOSS_RTOL = 5e-2   # the bf16 scatter wire against fp32's
ZERO_TIMEOUT_S = 600


def zero_launch(spec: dict, world: int, root: str, what: str,
                restarts: int = 0, spawn=None) -> list:
    """The rank script under ``spec`` through the port's launcher:
    ``world`` ranks on a file rendezvous, ``restarts`` restarts; every
    rank's result line of the last attempt."""
    from dtf_tpu_torch.cli.launch import launch_local, popen_rank

    base = os.path.join(root, what.replace(" ", "_"))
    rc = launch_local([sys.executable, "-c", DP_RANK, json.dumps(spec)],
                      world, f"file://{base}.rendezvous", base + "_logs",
                      timeout_s=ZERO_TIMEOUT_S, max_restarts=restarts,
                      restart_backoff_s=0.1, teardown_grace=30,
                      spawn=spawn or popen_rank)
    texts = []
    for rank in range(world):
        names = sorted(n for n in os.listdir(base + "_logs")
                       if n.startswith(f"log{rank}"))
        with open(os.path.join(base + "_logs", names[-1])) as f:
            texts.append(f.read())
    if rc:
        raise AssertionError(f"{what}: launcher exit {rc}\n" + "\n".join(
            t[-3000:] for t in texts))
    return dp_results(texts, what)


def zero_stages(torch, seed: int, card: str, model_argv=None,
                spawn=None) -> dict:
    """Phase 15: ``lm_main`` trains transformer_tpu at full width and
    ``DP_LM_LAYERS`` of its 12 layers, bf16 compute on f32 parameters,
    AdamW, S 2048, ``ZERO_STEPS`` steps:
      (a) two ranks sharing the card over gloo (CUDA tensors) at ZeRO
          stages 0, 1, 2 and 3 -- the four runs at once.  Losses
          bit-identical across the stages; each rank's bytes in use at
          its update (the allocator's count) strictly falling from
          stage 0 to 3; K1 and K3 one a layer and step;
      (b) stage 3 at world 1 over NCCL (``reduce_scatter_tensor``,
          ``all_gather_into_tensor``) against ``off``, bit for bit;
      (c) a stage-3 two-rank run killed by ``crash@step:4`` after its
          step-4 checkpoint, restarted by the launcher under stage 1
          from the canonical checkpoint: losses bit for bit (a);
      (d) ``--zero_wire bf16`` at stage 2: losses within
          ``ZERO_WIRE_LOSS_RTOL`` of the fp32 wire's;
      (e) stage 3 at two ranks with ``--zero_probe``: exposed
          communication no more than the serialized collectives plus
          the probe's spread of timings.
    (b) to (e) go at once after (a).  ``model_argv`` replaces
    the device and model flags (a small CPU run for debugging)."""
    import tempfile

    argv = (model_argv or ["--device", "cuda", "--model",
                           "transformer_tpu", "--dtype", "bf16"]) + [
            "--use_synthetic_data", "--batch_size",
            str(ZERO_BATCH), "--train_steps", str(ZERO_STEPS),
            "--log_steps", "1", "--seed", str(seed), "--skip_checkpoint",
            "--step_time_guard_factor", "0"]
    two = argv + ["--distribution_strategy", "multi_worker_mirrored"]

    def spec(args, backend="gloo", **kw):
        return {"main": "lm_main", "defaults": "LM_DEFAULTS",
                "backend": backend, "argv": args, "layers": DP_LM_LAYERS,
                **kw}

    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        started = {st: overlapped(
            zero_launch, spec(two + ["--zero_stage", str(st)]), 2, root,
            f"zero stage {st}", spawn=spawn) for st in range(4)}
        stages = dict(zip(started, gathered(list(started.values()))))
        stages_s = time.time() - t0
        ckpt = [a for a in two if a != "--skip_checkpoint"]
        ckpt += ["--model_dir", os.path.join(root, "crash_model"),
                 "--trace_dir", os.path.join(root, "crash_trace"),
                 "--checkpoint_steps", "4", "--resume",
                 "--fault", "crash@step:4"]
        t0 = time.time()
        runs = gathered([
            overlapped(dp_run, spec(argv + ["--distribution_strategy",
                                             "off", "--zero_stage", "3"],
                                    backend=None), None, root,
                       "zero off stage3"),
            overlapped(zero_launch, spec(argv + [
                "--distribution_strategy", "multi_worker_mirrored",
                "--zero_stage", "3"], backend=None), 1, root,
                "zero nccl world1", spawn=spawn),
            overlapped(zero_launch, spec(ckpt + ["--zero_stage", "3"],
                                         argv_restart=["--zero_stage",
                                                       "1"]),
                       2, root, "zero crash", restarts=1, spawn=spawn),
            overlapped(zero_launch, spec(two + ["--zero_stage", "2",
                                                "--zero_wire", "bf16"]),
                       2, root, "zero wire bf16", spawn=spawn),
            overlapped(zero_launch, spec(two + [
                "--zero_stage", "3", "--zero_probe", "--train_steps",
                str(ZERO_PROBE_STEPS)]), 2, root, "zero probe",
                spawn=spawn)])
        rest_s = time.time() - t0
        crash_losses = trace_losses(os.path.join(root, "crash_trace"))
    off, nccl, crash, wire, probed = runs
    ref = stages[0][0]["losses"]
    n = stages[0][0]["resident"]["n"]
    # each rank's bytes in use at its update, stage by stage
    at_update = [[stages[st][rank]["resident"]["allocated_at_update"]
                  for st in range(4)] for rank in range(2)]
    lines = []
    for st in range(4):
        r = stages[st]
        lines.append({
            "stage": st, "backend": r[0]["backend"],
            "replicas": r[0]["replicas"], "losses": r[0]["losses"],
            "ranks_bit_identical": (r[0]["digest"] == r[1]["digest"]
                                    and r[0]["losses"] == r[1]["losses"]),
            "losses_bit_identical_to_stage0": r[0]["losses"] == ref,
            "resident": [x["resident"] for x in r],
            "peak_memory_bytes": [x["peak_memory_bytes"] for x in r],
            "step_s_p50": statistics.median(r[0]["window_step_s"]),
            "launches": r[0]["launches"]})
    probe = probed[0]["zero_probe"] or {}
    line = {
        "phase": "zero_stages", "card": card, "model": "transformer_tpu",
        "layers": DP_LM_LAYERS,
        "dtype": "bf16 compute, f32 parameters", "optimizer": "adamw",
        "seq": TRAIN_SHAPE[1], "global_batch": ZERO_BATCH,
        "per_rank_batch": ZERO_BATCH // 2, "steps": ZERO_STEPS, "n": n,
        "formula": "what a rank holds at its update, world 2: params + "
                   "the gradient + AdamW moments = 4N + 4N (the flat "
                   "all-reduced mean) + 8N (16N), 4N + 4N (that mean, "
                   "which the slices view) + 4N (12N), 4N + 2N + 4N "
                   "(10N), 2N + 2N + 4N (8N; the full parameters freed "
                   "before the update); the allocator's count "
                   "(allocated_at_update) adds the batch and whatever "
                   "else is live",
        "formula_bytes": [16 * n, 12 * n, 10 * n, 8 * n],
        "allocated_at_update": at_update,
        "stages": lines, "stages_wall_s": stages_s,
        "zero_probe": probe,
        "exposed_comm_ms_per_step": 1e3 * probe.get("exposed_s", math.nan),
        "nocomm_step_ms": 1e3 * probe.get("nocomm_step_s", math.nan),
        "serialized_comm_ms": 1e3 * probe.get("serialized_s", math.nan),
        "probe_noise_ms": 1e3 * probe.get("noise_s", math.nan),
        "probe_launches": probed[0]["launches"],
        "nccl_world1_stage3": {
            "backend": nccl[0]["backend"], "losses": nccl[0]["losses"],
            "losses_bit_identical_to_off": nccl[0]["losses"]
            == off[0]["losses"],
            "params_bit_identical_to_off": nccl[0]["digest"]
            == off[0]["digest"],
            "step_s_p50_off": statistics.median(off[0]["window_step_s"]),
            "step_s_p50_nccl": statistics.median(nccl[0]["window_step_s"]),
            "peak_memory_bytes": nccl[0]["peak_memory_bytes"],
            "launches": nccl[0]["launches"]},
        "crash_resume": {
            "fault": "crash@step:4 under stage 3, resumed under stage 1",
            "losses": crash_losses,
            "resumed_stage": crash[0]["zero_stage"],
            "losses_bit_identical": crash_losses == {
                i + 1: [v] for i, v in enumerate(ref)},
            "launches_resumed": crash[0]["launches"]},
        "zero_wire_bf16": {
            "losses": wire[0]["losses"], "tol": ZERO_WIRE_LOSS_RTOL,
            "loss_rel_gap_to_fp32": rel_gap(wire[0]["losses"],
                                            stages[2][0]["losses"])},
        "rest_wall_s": rest_s}
    emit(line)
    k = DP_LM_LAYERS * ZERO_STEPS
    # the probe run: its steps, then the step and its twin, a warm-up
    # and three timed of each
    k_probe = DP_LM_LAYERS * (ZERO_PROBE_STEPS + 8)
    gates = {
        "stages_bit_identical": all(
            x["ranks_bit_identical"] and x["losses_bit_identical_to_stage0"]
            and x["replicas"] == 2 for x in lines),
        "resident_falling": all(
            a is not None and b is not None and a > b
            for seq in at_update for a, b in zip(seq, seq[1:])),
        "launches": all(
            x["launches"]["K1"] == x["launches"]["K3"] == k
            for x in lines) and (
            probed[0]["launches"]["K1"] == probed[0]["launches"]["K3"]
            == k_probe),
        "nccl_world1_equals_off": (
            nccl[0]["backend"] == "nccl" and nccl[0]["replicas"] == 1
            and line["nccl_world1_stage3"]["losses_bit_identical_to_off"]
            and line["nccl_world1_stage3"]["params_bit_identical_to_off"]),
        "crash_resume_bit_identical": (
            line["crash_resume"]["losses_bit_identical"]
            and crash[0]["zero_stage"] == 1),
        "zero_wire_bf16": line["zero_wire_bf16"]["loss_rel_gap_to_fp32"]
        <= ZERO_WIRE_LOSS_RTOL,
        "probe_exposed_within_serialized": (
            math.isfinite(line["exposed_comm_ms_per_step"])
            and line["exposed_comm_ms_per_step"]
            <= line["serialized_comm_ms"] + line["probe_noise_ms"]),
        "finite": all(math.isfinite(v) for v in ref)}
    emit({"phase": "zero_gates", "card": card, **gates})
    if not all(gates.values()):
        raise AssertionError(f"zero_stages: {gates}")
    line["launches_zero"] = {kern: stages[0][0]["launches"][kern]
                             for kern in ("K1", "K3")}
    line["launches_zero_run"] = (f"rank 0 of the stage-0 two-rank run, "
                                 f"{ZERO_STEPS} steps (phase 15); each "
                                 f"stage's ranks alike")
    # the stage-3 arm as phase 21's plan file names it
    line["stage3_arm"] = {"argv": two + ["--zero_stage", "3"],
                          "losses": [r["losses"] for r in stages[3]],
                          "digests": [r["digest"] for r in stages[3]]}
    return line


# phase 16: tensor parallelism (runtime/mesh.py's grid, models/partition.py,
# the shard-local transformer, TensorParallelLM)
# ---------------------------------------------------------------------------

TP_BATCH = 2             # global at data 1: TP_SHAPE's batch
# the TP training runs (their world-1 twins, the serving of their
# checkpoint) and the f32 serve_tp 2 / 1 comparison at 6 of
# transformer_tpu's 12 layers, every width kept, as phases 15, 17 and 18
# run: room for phase 20 within the script's budget; none of their
# gates depends on depth (the bf16 burst stays phase 4's, 12 layers)
TP_LAYERS = DP_LM_LAYERS
TP_STEPS_F32 = 3
TP_STEPS_BF16 = 6
# f32 losses: the TP run against world 1, --shard_lm_head against the
# plain TP run, the mp-1 resume against the mp-2 run.  One function with
# each block's sums split over two shards (the row-parallel partials,
# the collective softmax): float32 rounding, ~1e-6 relative after three
# AdamW steps; 20x tighter than the JAX test's rtol 2e-3
TP_LOSS_RTOL = 1e-4
TP_SERVE_REQUESTS = 16
TP_SERVE_NEW = 32
TP_CKPT_REQUESTS = 8
TP_CKPT_NEW = 16


def tp_lm_argv(seed: int, dtype: str, steps: int) -> list:
    return ["--use_synthetic_data", "--device", "cuda", "--model",
            "transformer_tpu", "--dtype", dtype, "--batch_size",
            str(TP_BATCH), "--train_steps", str(steps), "--log_steps", "1",
            "--seed", str(seed), "--step_time_guard_factor", "0"]


def tp_prompts(seed: int, n: int):
    import numpy as np
    rng = np.random.default_rng(seed + 16)
    return [rng.integers(0, 32768, (int(rng.integers(1, 257)),)).astype(
        np.int32) for _ in range(n)]


def tp_serve_tokens(torch, cfg, prompts, n_new: int, devices=None):
    """Greedy tokens of ``prompts`` from the engine serve_main builds
    for ``cfg`` (random weights from its seed unless it names a
    ``model_dir``), on ``devices`` at ``serve_tp`` > 1; and the heads of
    each shard's KV pool."""
    from dtf_tpu_torch.cli.serve_main import build_serving_engine

    model, engine = build_serving_engine(cfg, random_init=not cfg.model_dir,
                                         devices=devices)
    try:
        handles = [engine.submit(p, max_new_tokens=n_new) for p in prompts]
        tokens = [h.result(timeout=600).tokens for h in handles]
    finally:
        engine.stop(drain=False)
    if engine.failed is not None:
        raise RuntimeError("engine failed") from engine.failed
    heads = [int(c[0]["paged_key"].shape[2]) for c in engine._cache]
    del model, engine
    torch.cuda.empty_cache()
    return tokens, heads


def tp_cli_refusal(seed: int) -> dict:
    """``cli.serve_main --serve_tp 2`` as a user runs it on this machine:
    with fewer cards than shards it must exit non-zero, naming the
    count, and never stack the shards on one card."""
    proc = subprocess.run(
        [sys.executable, "-m", "dtf_tpu_torch.cli.serve_main",
         "--serve_random_init", "--model", "transformer_tpu",
         "--serve_tp", "2", "--seed", str(seed), "--serve_requests", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    lines = (proc.stderr or proc.stdout).strip().splitlines()
    return {"exit_code": proc.returncode,
            "message": lines[-1] if lines else ""}


def tp_lm_here(torch, argv) -> dict:
    """``lm_main``'s run of ``argv`` in this process (no process to
    start): its losses and window step times, the kernels' launches
    between a reset just before and a read just after, and the bytes it
    allocated at its peak above what was allocated before it."""
    from dtf_tpu_torch.cli import runner
    from dtf_tpu_torch.cli.lm_main import LM_DEFAULTS
    from dtf_tpu_torch.config import parse_flags
    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import paged_attention as pa

    cfg = parse_flags(argv, defaults=LM_DEFAULTS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts(fa, pa)
    stats = quiet(runner.run, cfg)
    torch.cuda.synchronize()
    out = {"losses": [v for _, v in stats["train_loss_log"]],
           "window_step_s": stats["window_step_s"],
           "launches": kernel_counts(fa, pa),
           "peak_memory_bytes": torch.cuda.max_memory_allocated() - base,
           "replicas": 1, "model_parallelism": 1}
    del stats
    torch.cuda.empty_cache()
    return out


def tensor_parallel(torch, seed: int, card: str, per_call,
                    serve1: dict, spawn=None) -> dict:
    """Phase 16 (see the module's docstring): (a) TP training against
    world 1 and itself, (b) TP serving against serve_tp 1, (c) the
    CLI's refusal on one card.  The correctness runs go at once (their
    gates are their own); the timed runs go alone after them, the TP
    ranks started beforehand and held until then.  The world-1 runs go
    in this process: no process to start.  The bf16 burst at serve_tp
    2 is phase 4's (``per_call`` its launches a model call), held
    beside phase 4's serve_tp 1 numbers (``serve1``)."""
    import tempfile

    from dtf_tpu_torch.config import Config

    def spec(args, backend="gloo", **kw):
        return {"main": "lm_main", "defaults": "LM_DEFAULTS",
                "backend": backend, "argv": args, "layers": TP_LAYERS,
                **kw}

    f32 = tp_lm_argv(seed, "fp32", TP_STEPS_F32)
    bf16 = tp_lm_argv(seed, "bf16", TP_STEPS_BF16)
    grid = ["--distribution_strategy", "multi_worker_mirrored",
            "--model_parallelism", "2"]
    off = ["--distribution_strategy", "off"]
    skip = ["--skip_checkpoint"]
    two = [torch.device("cuda", 0)] * 2
    serve_cfg = dict(model="transformer_tpu", dtype="fp32", seed=seed,
                     device="cuda", serve_max_batch=8,
                     serve_max_seq_len=512, model_dir="")
    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        ckpt = os.path.join(root, "tp_model")
        go = os.path.join(root, "tp_bf16.go")
        try:
            futs = [
                overlapped(zero_launch, spec(f32 + grid + [
                    "--model_dir", ckpt, "--checkpoint_steps", "2"]), 2,
                    root, "tp f32", spawn=spawn),
                overlapped(zero_launch, spec(f32 + grid + skip + [
                    "--shard_lm_head"]), 2, root, "tp f32 vocab",
                    spawn=spawn),
                overlapped(tp_cli_refusal, seed)]
            # (b) meanwhile in this process: f32 greedy, serve_tp 2 and 1
            prompts = tp_prompts(seed, TP_SERVE_REQUESTS)
            with fleet_depth(TP_LAYERS):
                one, heads1 = tp_serve_tokens(torch, Config(**serve_cfg),
                                              prompts, TP_SERVE_NEW)
                tp2, heads2 = tp_serve_tokens(
                    torch, Config(serve_tp=2, **serve_cfg), prompts,
                    TP_SERVE_NEW, two)
            stamps = {"served_f32": time.time() - t0}
            with fleet_depth(TP_LAYERS):
                off32 = [tp_lm_here(torch, f32 + off + skip)]
            stamps["off_f32"] = time.time() - t0
            # the timed TP run's ranks start now (the runs that started
            # with the phase done or past their start), build, and wait
            # for their go
            timed_tp = overlapped(zero_launch, spec(bf16 + grid + skip,
                                                    go=go), 2, root,
                                  "tp bf16", spawn=spawn)
            # the TP run's step-2 checkpoint once it is sealed (hard
            # links, its other steps left out), while the run goes on
            manifest = os.path.join(ckpt, "checkpoints.meta",
                                    "manifest_2.json")
            while not os.path.exists(manifest):
                if futs[0].done():
                    futs[0].result()
                    raise AssertionError("tp f32: no step-2 checkpoint")
                time.sleep(0.2)
            stamps["tp_f32_step2_sealed"] = time.time() - t0
            keep = {"checkpoints": "2", "checkpoints.meta": "manifest_2.json"}
            resume = os.path.join(root, "resume_model")
            shutil.copytree(ckpt, resume, copy_function=os.link,
                            ignore=lambda d, names: [
                                n for n in names
                                if os.path.basename(d) in keep
                                and n != keep[os.path.basename(d)]])
            # that checkpoint served at serve_tp 1 and 2, each on a
            # thread, while this one resumes it at mp 1 with no save of
            # its own
            ck_prompts = prompts[:TP_CKPT_REQUESTS]
            ck_cfg = dict(serve_cfg, model_dir=resume)
            with fleet_depth(TP_LAYERS):
                served = [overlapped(tp_serve_tokens, torch,
                                     Config(serve_tp=n, **ck_cfg),
                                     ck_prompts, TP_CKPT_NEW,
                                     two if n > 1 else None)
                          for n in (1, 2)]
                resumed = [tp_lm_here(torch, f32 + off + skip + [
                    "--model_dir", resume, "--resume"])]
                stamps["resumed"] = time.time() - t0
                (ck1, _), (ck2, ck_heads) = gathered(served)
            stamps["served_checkpoint"] = time.time() - t0
            tp32, vocab, cli = gathered(futs)
        finally:
            # the timed ranks run (and end) whatever happened here
            with open(go, "w"):
                pass
        correct_s = time.time() - t0
        # the timed runs, alone
        t0 = time.time()
        tpbf = timed_tp.result()
        with fleet_depth(TP_LAYERS):
            offbf = [tp_lm_here(torch, bf16 + off + skip)]
        serve2 = serve_bf16(torch, seed, per_call, 2, two)
        timed_s = time.time() - t0

    ref = off32[0]["losses"]
    gap_tp = rel_gap(tp32[0]["losses"], ref)
    gap_vocab = rel_gap(vocab[0]["losses"], tp32[0]["losses"])
    gap_resume = rel_gap(resumed[0]["losses"], tp32[0]["losses"][2:])
    k_f32, k_bf16 = TP_LAYERS * TP_STEPS_F32, TP_LAYERS * TP_STEPS_BF16

    def launches_ok(ranks, k):
        return all(r["launches"]["K1"] == r["launches"]["K3"] == k
                   and r["launches"]["K2a"] == r["launches"]["K2b"] == 0
                   for r in ranks)

    def grid_ok(ranks):
        return ([r["model_parallelism"] for r in ranks] == [2, 2]
                and [r["replicas"] for r in ranks] == [1, 1]
                and ranks[0]["losses"] == ranks[1]["losses"])

    line = {
        "phase": "tensor_parallel", "card": card, "model": "transformer_tpu",
        "layers_trained": TP_LAYERS, "model_parallelism": 2, "heads_per_shard": 3, "d_ff_per_shard":
        1536, "vocab_per_shard": 16384, "seq": TP_SHAPE[1],
        "global_batch": TP_BATCH, "optimizer": "adamw",
        "loss_rtol": TP_LOSS_RTOL,
        "train_f32": {"steps": TP_STEPS_F32, "losses_off": ref,
                      "losses_tp": tp32[0]["losses"],
                      "losses_shard_lm_head": vocab[0]["losses"],
                      "loss_rel_gap_tp_to_off": gap_tp,
                      "loss_rel_gap_shard_lm_head_to_tp": gap_vocab,
                      "launches_tp_rank0": tp32[0]["launches"]},
        "resume_mp1": {"from_step": 2, "losses": resumed[0]["losses"],
                       "tp_losses": tp32[0]["losses"][2:],
                       "loss_rel_gap": gap_resume,
                       "replicas": resumed[0]["replicas"],
                       "model_parallelism": resumed[0]["model_parallelism"]},
        "train_bf16": {
            "steps": TP_STEPS_BF16,
            "step_s_p50_tp": [statistics.median(r["window_step_s"])
                              for r in tpbf],
            "step_s_p50_off": statistics.median(offbf[0]["window_step_s"]),
            "peak_memory_bytes_tp": [r["peak_memory_bytes"] for r in tpbf],
            "peak_memory_bytes_off": offbf[0]["peak_memory_bytes"],
            "losses_tp": tpbf[0]["losses"], "losses_off": offbf[0]["losses"],
            "launches_tp": [r["launches"] for r in tpbf],
            "launches_off": offbf[0]["launches"]},
        "serve_f32": {"requests": len(prompts), "new_tokens": TP_SERVE_NEW,
                      "token_exact_tp2_vs_tp1": tp2 == one,
                      "heads_per_shard": heads2, "heads_tp1": heads1},
        "serve_checkpoint": {"step": 2, "requests": len(ck_prompts),
                             "new_tokens": TP_CKPT_NEW,
                             "token_exact_tp2_vs_tp1": ck2 == ck1,
                             "heads_per_shard": ck_heads},
        "serve_bf16": {"serve_tp_2": serve2, "serve_tp_1_phase4": serve1},
        "cli_serve_tp2": {**cli, "cards": torch.cuda.device_count()},
        "correct_wall_s": correct_s, "timed_wall_s": timed_s,
        "correct_stamps_s": stamps,
        "rank_wall_s": {"tp_f32": tp32[0]["wall_s"],
                        "tp_f32_vocab": vocab[0]["wall_s"],
                        "tp_bf16": tpbf[0]["wall_s"]}}
    emit(line)
    one_card = torch.cuda.device_count() < 2
    gates = {
        "tp_f32_vs_off": gap_tp <= TP_LOSS_RTOL and grid_ok(tp32),
        "shard_lm_head_vs_tp": gap_vocab <= TP_LOSS_RTOL and grid_ok(vocab),
        "resume_at_mp1": (gap_resume <= TP_LOSS_RTOL
                          and len(resumed[0]["losses"]) == 1
                          and resumed[0]["model_parallelism"] == 1),
        "bf16_grid": grid_ok(tpbf),
        "launches": (launches_ok(tp32, k_f32) and launches_ok(vocab, k_f32)
                     and launches_ok(tpbf, k_bf16)
                     and launches_ok(offbf, k_bf16)),
        "serve_f32_token_exact": tp2 == one and heads2 == [3, 3],
        "serve_checkpoint_token_exact": ck2 == ck1 and ck_heads == [3, 3],
        "serve_bf16_launched": min(serve2["launches"]["K1"],
                                   serve2["launches"]["K4"]) > 0,
        "cli_refuses_serve_tp2": (not one_card) or (
            cli["exit_code"] != 0
            and "needs 2 devices, 1 attached" in cli["message"]),
        "finite": all(math.isfinite(v) for v in
                      ref + tpbf[0]["losses"] + vocab[0]["losses"])}
    emit({"phase": "tensor_parallel_gates", "card": card, **gates})
    if not all(gates.values()):
        raise AssertionError(f"tensor_parallel: {gates}")
    line["launches_tp"] = {"K1": tpbf[0]["launches"]["K1"],
                           "K3": tpbf[0]["launches"]["K3"],
                           "K4": serve2["launches"]["K4"]}
    line["launches_tp_serve_K1"] = serve2["launches"]["K1"]
    return line


# ---------------------------------------------------------------------------
# phase 17: elastic training (train/elastic.py, cli/launch.py --elastic,
# the device_loss fault)
# ---------------------------------------------------------------------------

ELASTIC_STEPS = 12       # the supervised run's steps (the JAX smoke's 20)
ELASTIC_LOSS_AT = 4      # the host loss, on a checkpoint boundary: an
                         # exact-match fault a resume below it would fire
                         # again
ELASTIC_GROW_AFTER = 6   # capacity re-announced once this step is sealed
ELASTIC_DEVICE_STEPS = 6     # the device-loss arm's steps, lost at 2
# the launcher's SIGKILL after its teardown SIGTERM: long enough for the
# grow drain's emergency seal of the ~1.1 GB world-1 payload (a seal of
# 1.64 GB took 6.08 s alone, PERF.md), short for a survivor wedged in a
# collective with the lost rank
ELASTIC_TEARDOWN_S = 30.0
ELASTIC_TIMEOUT_S = 600
# the CUDA runtime's device-loss statuses (train/elastic.py's
# vocabulary), and kernel bugs that must stay crashes
CUDA_LOST_STATUSES = {"cudaErrorNoDevice": 100,
                      "cudaErrorDevicesUnavailable": 46,
                      "cudaErrorECCUncorrectable": 214}
CUDA_BUG_STATUSES = {"cudaErrorIllegalAddress": 700,
                     "cudaErrorLaunchFailure": 719}


def cuda_error_strings(torch, codes: dict):
    """({name: cudaGetErrorString(code)} from this card's runtime, the
    binding used): torch's own binding of libcudart, else ctypes on the
    runtime library beside torch or in the toolkit."""
    try:
        rt = torch.cuda.cudart()
        return ({n: str(rt.cudaGetErrorString(rt.cudaError(c)))
                 for n, c in codes.items()}, "torch.cuda.cudart")
    except Exception:  # noqa: BLE001 -- a binding without the call
        import ctypes
        import glob
        here = os.path.dirname(torch.__file__)
        libs = sorted(glob.glob(os.path.join(
            here, "..", "nvidia", "cuda_runtime", "lib", "libcudart.so*"))
            + glob.glob("/usr/local/cuda/lib64/libcudart.so*"))
        if not libs:
            raise
        lib = ctypes.CDLL(libs[0])
        lib.cudaGetErrorString.restype = ctypes.c_char_p
        lib.cudaGetErrorString.argtypes = [ctypes.c_int]
        return ({n: lib.cudaGetErrorString(c).decode()
                 for n, c in codes.items()}, libs[0])


def elastic_classifier(torch) -> dict:
    """(f): the texts this card's runtime gives the statuses the
    classifier lists, wrapped as torch raises a CUDA error, classify as
    device loss; an illegal address, an unspecified launch failure and
    a caught out-of-memory error do not."""
    from dtf_tpu_torch.train import elastic

    texts, source = cuda_error_strings(
        torch, {**CUDA_LOST_STATUSES, **CUDA_BUG_STATUSES})
    cls = getattr(torch, "AcceleratorError", RuntimeError)
    got = {n: elastic.is_device_loss(cls(
        f"CUDA error: {t}\nCUDA kernel errors might be asynchronously "
        f"reported at some other API call, so the stacktrace below might "
        f"be incorrect.\n")) for n, t in texts.items()}
    try:
        torch.empty(1 << 42, dtype=torch.uint8, device="cuda")  # 4 TiB
        oom = None
    except torch.OutOfMemoryError as e:
        oom = e
    got["OutOfMemoryError"] = (None if oom is None
                               else elastic.is_device_loss(oom))
    ok = (all(got[n] for n in CUDA_LOST_STATUSES)
          and not any(got[n] for n in CUDA_BUG_STATUSES)
          and got["OutOfMemoryError"] is False)
    return {"texts": texts, "source": source, "exception": cls.__name__,
            "classified": got, "ok": ok}


def elastic_argv(seed: int, root: str, name: str, steps: int,
                 fault=None, model_argv=None) -> list:
    """``lm_main`` at ``DP_LM_LAYERS`` layers (DP_RANK's hook), bf16 on
    f32 parameters, AdamW, ZeRO-3, global batch ``ZERO_BATCH``, resumed
    from sealed checkpoints every 2 steps."""
    return (model_argv or ["--device", "cuda", "--model", "transformer_tpu",
                           "--dtype", "bf16"]) + [
            "--use_synthetic_data", "--batch_size", str(ZERO_BATCH),
            "--train_steps", str(steps), "--log_steps", "1", "--seed",
            str(seed), "--step_time_guard_factor", "0",
            "--distribution_strategy", "multi_worker_mirrored",
            "--zero_stage", "3", "--resume", "--checkpoint_steps", "2",
            "--model_dir", os.path.join(root, name + "_model"),
            "--trace_dir", os.path.join(root, name + "_trace")] + (
        ["--fault", fault] if fault else [])


def elastic_launch(root: str, name: str, argv, world: int, spawn=None,
                   **kw) -> dict:
    """DP_RANK over ``argv`` (gloo ranks sharing the card) under the
    port's launcher; the exit code, the supervisor's events, the last
    attempt's rank-0 result (None when it printed none) and the run's
    directories."""
    from dtf_tpu_torch.cli.launch import launch_local, popen_rank

    base = os.path.join(root, name)
    spec = {"main": "lm_main", "defaults": "LM_DEFAULTS", "backend": "gloo",
            "argv": argv, "layers": DP_LM_LAYERS}
    t0 = time.time()
    rc = launch_local([sys.executable, "-c", DP_RANK, json.dumps(spec)],
                      world, f"file://{base}.rendezvous", base + "_logs",
                      timeout_s=ELASTIC_TIMEOUT_S, restart_backoff_s=0.1,
                      teardown_grace=ELASTIC_TEARDOWN_S,
                      spawn=spawn or popen_rank, **kw)
    wall = time.time() - t0
    with open(os.path.join(base + "_logs", "supervisor_events.jsonl")) as f:
        events = [json.loads(ln) for ln in f if ln.strip()]
    last = sorted(n for n in os.listdir(base + "_logs")
                  if n.startswith("log0"))[-1]
    with open(os.path.join(base + "_logs", last)) as f:
        text = f.read()
    result = (dp_results([text], name)[0] if "DP_RESULT=" in text
              else None)
    return {"rc": rc, "events": events, "result": result, "wall_s": wall,
            "last_log": last, "tail": text[-3000:],
            "model": base + "_model", "trace": base + "_trace"}


def elastic_records(trace_dir: str, kind: str, name: str) -> list:
    """Every rank's trace records of ``kind`` named ``name``."""
    from dtf_tpu_torch.obs.trace import read_records

    out = []
    for f in sorted(os.listdir(trace_dir)):
        if f.startswith("trace_rank"):
            out += [r for r in read_records(os.path.join(trace_dir, f))
                    if r.get("kind") == kind and r.get("name") == name]
    return out


def elastic_losses(trace_dir: str) -> dict:
    """{step: [the distinct losses logged at it]} over every rank and
    attempt."""
    out: dict = {}
    for r in elastic_records(trace_dir, "event", "train_loss"):
        out.setdefault(int(r["step"]), set()).add(r["loss"])
    return {k: sorted(v) for k, v in sorted(out.items())}


def elastic_training(torch, seed: int, card: str, model_argv=None,
                     spawn=None) -> dict:
    """Phase 17 (see the module's docstring): (a) a host lost at step
    ``ELASTIC_LOSS_AT`` of a 2-rank ZeRO-3 run under ``--elastic``,
    resumed on 1 rank, grown back to 2 once capacity is re-announced;
    (b) its prep twin (``crash@step:4``) and (c) a 1-rank oracle resumed
    from a copy of (b)'s model dir, bit for bit with (a)'s prefix and
    shrunken window; (d) ``trace_main --check``; (e) ``device_loss``;
    (f) the classifier against this card's runtime.  (b) then (c), and
    (e), go beside (a): the phase's critical path is (a).
    ``model_argv`` replaces the device and model flags (a small CPU run
    for debugging: every gate but (f) and the launch counts holds)."""
    import shutil
    import tempfile
    import threading

    from dtf_tpu_torch.chaos import EXIT_INJECTED_CRASH
    from dtf_tpu_torch.cli.trace_main import main as trace_main
    from dtf_tpu_torch.train import elastic
    from dtf_tpu_torch.train.checkpoint import PAYLOAD

    classifier = (elastic_classifier(torch) if model_argv is None
                  else {"ok": None})
    argv = functools.partial(elastic_argv, model_argv=model_argv)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        run_logs = os.path.join(root, "run_logs")
        os.makedirs(run_logs)
        sealed = os.path.join(root, "run_model", "checkpoints.meta",
                              f"manifest_{ELASTIC_GROW_AFTER}.json")
        announced: dict = {}
        stop = threading.Event()

        def announcer():
            # a healed host's agent: once the shrunken run has sealed
            # step 6 (so a world-1 window exists), full capacity again
            while not os.path.exists(sealed) and not stop.is_set():
                time.sleep(0.05)
            if not stop.is_set():
                announced["ts"] = time.time()
                elastic.announce_rejoin(run_logs, 2)

        def prep_then_oracle():
            prep = elastic_launch(root, "prep", argv(
                seed, root, "prep", ELASTIC_STEPS,
                f"crash@step:{ELASTIC_LOSS_AT}"), 2, spawn)
            shutil.copytree(prep["model"], os.path.join(root,
                                                        "oracle_model"))
            oracle = elastic_launch(root, "oracle", argv(
                seed, root, "oracle", ELASTIC_STEPS), 1, spawn)
            return prep, oracle

        th = threading.Thread(target=announcer, daemon=True)
        th.start()
        side = overlapped(prep_then_oracle)
        device = overlapped(elastic_launch, root, "device",
                            argv(seed, root, "device", ELASTIC_DEVICE_STEPS,
                                 "device_loss@step:2"), 2, spawn,
                            elastic=True, min_devices=1, max_restarts=1)
        try:
            run = elastic_launch(root, "run", argv(
                seed, root, "run", ELASTIC_STEPS,
                f"host_loss@rank1:step:{ELASTIC_LOSS_AT}"), 2, spawn,
                elastic=True, min_devices=1, max_restarts=2)
        finally:
            stop.set()
            th.join(timeout=10)
        (prep, oracle), device = gathered([side, device])
        phase_s = time.time() - t0
        got = elastic_losses(run["trace"])
        resumes = sorted({(int(r["step"]), int(r["devices"]))
                          for r in elastic_records(run["trace"], "event",
                                                   "elastic_resume")})
        grow_step = resumes[1][0] if len(resumes) == 2 else None
        windows = [r for r in elastic_records(run["trace"], "span",
                                              "log_window")
                   if r.get("rank") in (0, None)]
        seals = [(int(r["step"]), r["dur_s"]) for r in elastic_records(
            run["trace"], "span", "checkpoint_save")]
        first_ts = {}     # each step's first train_loss, host clock
        for r in elastic_records(run["trace"], "event", "train_loss"):
            step = int(r["step"])
            first_ts[step] = min(first_ts.get(step, r["ts"]), r["ts"])
        lost_at = next((e["ts"] for e in run["events"]
                        if e["event"] == "rank_exit"
                        and e["classification"] == "host_loss"), None)
        payload_bytes = os.path.getsize(os.path.join(
            run["model"], "checkpoints", str(ELASTIC_STEPS), PAYLOAD))
        checks = {
            "run": quiet(trace_main, [run["trace"], "--check", "--allow",
                                      "injected_fault", "--allow",
                                      "host_loss"]),
            "run_bare": quiet(trace_main, [run["trace"], "--check"]),
            "device": quiet(trace_main, [device["trace"], "--check",
                                         "--allow", "injected_fault",
                                         "--allow", "device_loss"])}
        device_losses = elastic_losses(device["trace"])
        prep_losses = elastic_losses(prep["trace"])
        oracle_losses = elastic_losses(oracle["trace"])

    def world_of(step):
        if step <= ELASTIC_LOSS_AT or (grow_step and step > grow_step):
            return 2
        return 1

    def p50(world):
        vals = [r["step_s"] for r in windows
                if world_of(int(r["step"])) == world]
        return statistics.median(vals) if vals else None

    def events(run_, name):
        return [e for e in run_["events"] if e["event"] == name]

    shrinks = events(run, "elastic_shrink")
    grows = events(run, "elastic_grow")
    dev_shrinks = events(device, "elastic_shrink")
    grown_steps = ELASTIC_STEPS - (grow_step or ELASTIC_STEPS)
    want_launches = DP_LM_LAYERS * grown_steps
    launches = (run["result"] or {}).get("launches", {})
    dev_launches = (device["result"] or {}).get("launches", {})
    line = {
        "phase": "elastic", "card": card, "model": "transformer_tpu",
        "layers": DP_LM_LAYERS, "dtype": "bf16 compute, f32 parameters",
        "optimizer": "adamw", "zero_stage": 3, "global_batch": ZERO_BATCH,
        "seq": TRAIN_SHAPE[1], "backend": "gloo, ranks sharing the card",
        "rank_start": ("forked from the pre-imported spawner" if spawn
                       else "a fresh process"),
        "steps": ELASTIC_STEPS, "host_loss_at": ELASTIC_LOSS_AT,
        "grow_after_seal_of": ELASTIC_GROW_AFTER,
        "shrinks": shrinks, "grows": grows, "elastic_resumes": resumes,
        "grow_step": grow_step,
        "steps_after_announce_before_drain": (
            grow_step - ELASTIC_GROW_AFTER if grow_step else None),
        "tail_steps_left_at_drain": grown_steps,
        "loss_to_first_shrunken_step_s": (
            first_ts[ELASTIC_LOSS_AT + 1] - lost_at
            if lost_at and ELASTIC_LOSS_AT + 1 in first_ts else None),
        "announce_to_first_grown_step_s": (
            first_ts[grow_step + 1] - announced["ts"]
            if grow_step and grow_step + 1 in first_ts and announced
            else None),
        "step_s_p50_world2": p50(2), "step_s_p50_world1": p50(1),
        "seal_s_by_step": seals,
        "teardown_grace_s": ELASTIC_TEARDOWN_S,
        "checkpoint_bytes_per_step": payload_bytes,
        "losses": got, "trace_checks": checks,
        "prep_exit": prep["rc"], "oracle_exit": oracle["rc"],
        "prefix_bit_identical_to_prep": all(
            got.get(s) == prep_losses.get(s)
            for s in range(1, ELASTIC_LOSS_AT + 1)),
        "shrunken_window_bit_identical_to_oracle": bool(grow_step) and all(
            got.get(s) == oracle_losses.get(s)
            for s in range(ELASTIC_LOSS_AT + 1, grow_step + 1)),
        "device_loss": {"exit": device["rc"], "shrinks": dev_shrinks,
                        "losses": device_losses,
                        "launches_resumed": dev_launches},
        "classifier": classifier,
        "launches_resumed": launches,
        "walls_s": {"run": run["wall_s"], "prep": prep["wall_s"],
                    "oracle": oracle["wall_s"], "device": device["wall_s"],
                    "phase_runs": phase_s}}
    emit(line)
    once = lambda losses, n: (  # noqa: E731
        sorted(losses) == list(range(1, n + 1))
        and all(len(v) == 1 for v in losses.values()))
    gates = {
        "run_exit_0": run["rc"] == 0,
        "one_host_loss_shrink_to_1": (
            len(shrinks) == 1 and shrinks[0]["classification"] == "host_loss"
            and shrinks[0]["total_devices"] == 1),
        "grew_back": len(grows) == 1 and grows[0]["total_devices"] == 2,
        "resumes": (len(resumes) == 2
                    and resumes[0] == (ELASTIC_LOSS_AT, 1)
                    and resumes[1][0] >= ELASTIC_GROW_AFTER
                    and resumes[1][1] == 2),
        "every_step_once": once(got, ELASTIC_STEPS),
        "prep_crashed_at_4": prep["rc"] == EXIT_INJECTED_CRASH,
        "prefix_bit_identical": line["prefix_bit_identical_to_prep"],
        "oracle_exit_0": oracle["rc"] == 0,
        "shrunken_window_bit_identical":
            line["shrunken_window_bit_identical_to_oracle"],
        "trace_check_allowing_fault": checks["run"] == 0,
        "trace_check_bare_fails": checks["run_bare"] != 0,
        "device_loss_resumed": (
            device["rc"] == 0 and len(dev_shrinks) == 1
            and dev_shrinks[0]["classification"] == "device_loss"
            and dev_shrinks[0]["total_devices"] == 1
            and once(device_losses, ELASTIC_DEVICE_STEPS)
            and checks["device"] == 0),
        "classifier_on_this_runtime": classifier["ok"],
        "launches_resumed": (
            grown_steps > 0 and launches.get("K1") == want_launches
            and launches.get("K3") == want_launches
            and dev_launches.get("K1") == dev_launches.get("K3")
            == DP_LM_LAYERS * (ELASTIC_DEVICE_STEPS - 2)),
        "finite": all(math.isfinite(v[0]) for v in got.values())}
    emit({"phase": "elastic_gates", "card": card, **gates})
    if not all(gates.values()):
        raise AssertionError(f"elastic: {gates}\nrun: {run['tail']}\n"
                             f"prep: {prep['tail']}\noracle: "
                             f"{oracle['tail']}\ndevice: {device['tail']}")
    line["launches_elastic"] = {k: launches[k] for k in ("K1", "K3")}
    line["launches_elastic_run"] = (
        f"rank 0 of the grown attempt (world 2) of the elastic run, steps "
        f"{grow_step + 1}-{ELASTIC_STEPS}, {DP_LM_LAYERS} layers "
        f"(phase 17)")
    return line

# ---------------------------------------------------------------------------
# phase 18: sequence parallelism (runtime/mesh.py's seq axis,
# parallel/ring_attention.py, parallel/collectives.py ring_shift)
# ---------------------------------------------------------------------------

SP_STEPS_F32 = 3
SP_STEPS_BF16 = 6
# phase 18 runs transformer_tpu at 6 of its 12 layers, every width kept,
# to make room for phase 19 within the script's budget; its gates scale
# with the depth
SP_LAYERS = DP_LM_LAYERS
# f32 losses of the ring (blockwise f32, the sequence split over two
# ranks) against world 1 (K1/K3 split TF32): float32 rounding, ~1e-6
# relative after three AdamW steps; the gate TP's phase 16 holds
SP_LOSS_RTOL = 1e-4


def sp_ring_prediction(layers: int, sp: int, batch: int, seq: int,
                       heads: int, head_dim: int, itemsize: int) -> dict:
    """The ring's traffic a training step as ``ring_attention`` makes
    it: per layer K and V rotated ``sp`` times forward (the last result
    unused, so autograd sends nothing back for it) and ``sp - 1`` times
    backward, each rotation this rank's [batch, seq / sp, heads,
    head_dim] shard."""
    calls = layers * 2 * (sp + sp - 1)
    return {"calls": calls, "bytes": calls * batch * (seq // sp) * heads
            * head_dim * itemsize}


def sequence_parallel(torch, seed: int, card: str, spawn=None) -> dict:
    """Phase 18 (see the module's docstring): ``lm_main`` at
    ``--seq_parallelism 2`` on two gloo ranks sharing the card (data 1 x
    seq 2 x model 1), transformer_tpu at full width and ``SP_LAYERS`` of
    its 12 layers, S 2048 (1024 a rank), global batch 2, AdamW: (a)
    f32, 3 steps, against the world-1 twin in this process; (b) bf16, 6
    steps, timed alone beside the world-1 run: step p50, each rank's
    peak memory, the ring's calls and bytes a step against
    :func:`sp_ring_prediction`, and no K1-K3 launch on a seq rank (the
    attention rides the ring)."""
    import tempfile

    def spec(args, **kw):
        return {"main": "lm_main", "defaults": "LM_DEFAULTS",
                "backend": "gloo", "argv": args, "layers": SP_LAYERS, **kw}

    f32 = tp_lm_argv(seed, "fp32", SP_STEPS_F32)
    bf16 = tp_lm_argv(seed, "bf16", SP_STEPS_BF16)
    grid = ["--distribution_strategy", "multi_worker_mirrored",
            "--seq_parallelism", "2", "--skip_checkpoint"]
    off = ["--distribution_strategy", "off", "--skip_checkpoint"]
    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        go = os.path.join(root, "sp_bf16.go")
        try:
            sp32 = overlapped(zero_launch, spec(f32 + grid), 2, root,
                              "sp f32", spawn=spawn)
            with fleet_depth(SP_LAYERS):
                off32 = tp_lm_here(torch, f32 + off)
            # the timed run's ranks start now, build, and wait for their
            # go until the f32 run is done
            timed = overlapped(zero_launch, spec(bf16 + grid, go=go), 2,
                               root, "sp bf16", spawn=spawn)
            sp32 = sp32.result()
        finally:
            # the timed ranks run (and end) whatever happened here
            with open(go, "w"):
                pass
        correct_s = time.time() - t0
        t0 = time.time()
        spbf = timed.result()
        with fleet_depth(SP_LAYERS):
            offbf = tp_lm_here(torch, bf16 + off)
        timed_s = time.time() - t0

    b, s, h, d = TP_BATCH, TRAIN_SHAPE[1], TRAIN_SHAPE[2], TRAIN_SHAPE[3]
    want = sp_ring_prediction(SP_LAYERS, 2, b, s, h, d, 2)
    want32 = sp_ring_prediction(SP_LAYERS, 2, b, s, h, d, 4)
    per_step = [{k: r["ring_shift"][k] / SP_STEPS_BF16
                 for k in ("calls", "bytes")} for r in spbf]
    gap = rel_gap(sp32[0]["losses"], off32["losses"])
    zero = {"K1": 0, "K2a": 0, "K2b": 0, "K3": 0}
    line = {
        "phase": "sequence_parallel", "card": card,
        "model": "transformer_tpu", "layers": SP_LAYERS,
        "seq_parallelism": 2,
        "seq": s, "seq_per_rank": s // 2, "global_batch": b,
        "optimizer": "adamw", "backend": "gloo (two ranks share the card; "
        "the ring's K/V and their cotangents ride pinned host buffers)",
        "loss_rtol": SP_LOSS_RTOL,
        "train_f32": {"steps": SP_STEPS_F32, "losses_sp": sp32[0]["losses"],
                      "losses_off": off32["losses"],
                      "loss_rel_gap_sp_to_off": gap,
                      "ring_shift_per_step": [
                          {k: r["ring_shift"][k] / SP_STEPS_F32
                           for k in ("calls", "bytes")} for r in sp32],
                      "ring_shift_predicted": want32,
                      "launches_sp": [r["launches"] for r in sp32]},
        "train_bf16": {
            "steps": SP_STEPS_BF16,
            "step_s_p50_sp": [statistics.median(r["window_step_s"])
                              for r in spbf],
            "step_s_p50_off": statistics.median(offbf["window_step_s"]),
            "peak_memory_bytes_sp": [r["peak_memory_bytes"] for r in spbf],
            "peak_memory_bytes_off": offbf["peak_memory_bytes"],
            "losses_sp": [r["losses"] for r in spbf],
            "losses_off": offbf["losses"],
            "ring_shift_per_step": per_step,
            "ring_shift_predicted": want,
            "launches_sp": [r["launches"] for r in spbf],
            "launches_off": offbf["launches"]},
        "correct_wall_s": correct_s, "timed_wall_s": timed_s,
        "rank_wall_s": {"sp_f32": sp32[0]["wall_s"],
                        "sp_bf16": spbf[0]["wall_s"]}}
    line["train_bf16"]["slowdown_sp_to_off"] = (
        line["train_bf16"]["step_s_p50_sp"][0]
        / line["train_bf16"]["step_s_p50_off"])
    emit(line)
    k_off = SP_LAYERS * SP_STEPS_BF16
    gates = {
        "sp_f32_vs_off": gap <= SP_LOSS_RTOL,
        "grid": all(r["seq_parallelism"] == 2 and r["replicas"] == 1
                    for r in sp32 + spbf),
        "ranks_bit_equal": (sp32[0]["losses"] == sp32[1]["losses"]
                            and spbf[0]["losses"] == spbf[1]["losses"]),
        "ring_traffic_as_predicted": (
            all(p == want for p in per_step)
            and all({k: r["ring_shift"][k] / SP_STEPS_F32
                     for k in ("calls", "bytes")} == want32 for r in sp32)),
        "no_flash_kernel_on_sp_ranks": all(
            r["launches"] == zero for r in sp32 + spbf),
        "twin_launches": (offbf["launches"]["K1"] == k_off
                          and offbf["launches"]["K3"] == k_off),
        "finite": all(math.isfinite(v) for v in
                      sp32[0]["losses"] + spbf[0]["losses"])}
    emit({"phase": "sequence_parallel_gates", "card": card, **gates})
    if not all(gates.values()):
        raise AssertionError(f"sequence_parallel: {gates}")
    line["launches_sp"] = {k: [r["launches"][k] for r in spbf]
                           for k in zero}
    line["launches_sp_twin"] = offbf["launches"]
    return line


# ---------------------------------------------------------------------------
# phase 19: pipeline parallelism (parallel/pipeline.py,
# models/pipeline_lm.py, the pipeline stages on the model axis)
# ---------------------------------------------------------------------------

PP_STEPS_F32 = 3
PP_STEPS_BF16 = 6
PP_BATCH = 8             # global at data 1: the auto M = 4 pp = 8, mb 1
# pipeline_transformer at 8 of its 12 layers (4 a stage, 2 a chunk
# interleaved), every width kept: PP is no longer the newest path, and
# none of its gates depends on depth (its counts follow PP_LAYERS)
PP_LAYERS = 8
# f32 losses of the two stages (the same function, its sums in another
# order: microbatches of one sequence) against world 1; the gate TP's
# phase 16 and SP's phase 18 hold
PP_LOSS_RTOL = 1e-4


def pp_lm_argv(seed: int, dtype: str, steps: int) -> list:
    return ["--use_synthetic_data", "--device", "cuda", "--model",
            "pipeline_transformer", "--dtype", dtype, "--batch_size",
            str(PP_BATCH), "--train_steps", str(steps), "--log_steps", "1",
            "--seed", str(seed), "--step_time_guard_factor", "0"]


def pp_prediction(pp: int, microbatches: int, layers: int, interleave: int,
                  act_bytes: int) -> dict:
    """A stage's traffic and launches a training step as
    ``parallel/pipeline.py`` makes them: ``ticks`` (M + pp - 1 GPipe,
    2 pp ceil(M / pp) + pp - 1 interleaved) activations of ``act_bytes``
    shifted forward, all but the last tick's cotangent back; each tick
    runs layers / pp (half that interleaved) blocks, one K1 and one K3
    each, bubble ticks included; one last-stage broadcast of the whole
    batch's activations a step."""
    if interleave == 2:
        ticks = 2 * pp * -(-microbatches // pp) + pp - 1
        per_tick = layers // pp // 2
    else:
        ticks = microbatches + pp - 1
        per_tick = layers // pp
    calls = 2 * ticks - 1
    return {"ticks": ticks, "ring_shift": {
                "calls": calls, "bytes": calls * act_bytes},
            "pipeline_broadcast": {"calls": 1,
                                   "bytes": microbatches * act_bytes},
            "K1": ticks * per_tick, "K3": ticks * per_tick}


def pipeline_parallel(torch, seed: int, card: str, spawn=None) -> dict:
    """Phase 19 (see the module's docstring): ``lm_main`` at
    ``--model_parallelism 2`` with pipeline_transformer on two gloo
    ranks sharing the card (data 1 x model 2: the pipeline's two
    stages), full width and depth (12 layers, 6 a stage), S 2048, global
    batch 8, the auto M = 8, AdamW: (a) f32, 3 steps, against the
    world-1 twin in this process; (b) bf16, 6 steps, GPipe and
    ``--pipeline_interleave 2``, each timed alone beside the world-1
    run: step p50, each rank's peak memory, the activations' shifts and
    the last-stage broadcast a step against :func:`pp_prediction`, K1
    and K3 a step against the same, K2a = K2b = 0."""
    import tempfile

    def spec(args, **kw):
        return {"main": "lm_main", "defaults": "LM_DEFAULTS",
                "backend": "gloo", "argv": args, "layers": PP_LAYERS,
                "layers_model": "pipeline_transformer", **kw}

    f32 = pp_lm_argv(seed, "fp32", PP_STEPS_F32)
    bf16 = pp_lm_argv(seed, "bf16", PP_STEPS_BF16)
    grid = ["--distribution_strategy", "multi_worker_mirrored",
            "--model_parallelism", "2", "--skip_checkpoint"]
    interleave = grid + ["--pipeline_interleave", "2"]
    off = ["--distribution_strategy", "off", "--skip_checkpoint"]
    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        gos = {n: os.path.join(root, f"pp_{n}.go")
               for n in ("gpipe", "interleave")}

        def go(name):
            with open(gos[name], "w"):
                pass

        runs = {}
        try:
            pp32 = overlapped(zero_launch, spec(f32 + grid), 2, root,
                              "pp f32", spawn=spawn)
            with fleet_depth(PP_LAYERS, "pipeline_transformer"):
                off32 = tp_lm_here(torch, f32 + off)
            # the timed runs' ranks start now, build, and wait for their
            # go until the f32 run is done
            timed = {n: overlapped(zero_launch, spec(
                         bf16 + argv, go=gos[n]), 2, root, f"pp bf16 {n}",
                         spawn=spawn)
                     for n, argv in (("gpipe", grid),
                                     ("interleave", interleave))}
            pp32 = pp32.result()
            correct_s = time.time() - t0
            # the timed runs, each alone, in turn
            t0 = time.time()
            for n in ("gpipe", "interleave"):
                go(n)
                runs[n] = timed[n].result()
        finally:
            # the timed ranks run (and end) whatever happened here
            for n in gos:
                if n not in runs:
                    go(n)
        with fleet_depth(PP_LAYERS, "pipeline_transformer"):
            offbf = tp_lm_here(torch, bf16 + off)
        timed_s = time.time() - t0

    s, d = TRAIN_SHAPE[1], 512
    mb = PP_BATCH // 8
    want = {n: pp_prediction(2, 8, PP_LAYERS, il, mb * s * d * 2)
            for n, il in (("gpipe", 1), ("interleave", 2))}
    want32 = pp_prediction(2, 8, PP_LAYERS, 1, mb * s * d * 4)

    def per_step(r, steps):
        return {"ring_shift": {k: r["ring_shift"][k] / steps
                               for k in ("calls", "bytes")},
                "pipeline_broadcast": {k: r["pipeline_broadcast"][k] / steps
                                       for k in ("calls", "bytes")},
                "K1": r["launches"]["K1"] / steps,
                "K3": r["launches"]["K3"] / steps,
                "K2a": r["launches"]["K2a"], "K2b": r["launches"]["K2b"]}

    def as_predicted(r, steps, w):
        got = per_step(r, steps)
        return (got["ring_shift"] == w["ring_shift"]
                and got["pipeline_broadcast"] == w["pipeline_broadcast"]
                and got["K1"] == got["K3"] == w["K1"]
                and got["K2a"] == got["K2b"] == 0)

    gap = rel_gap(pp32[0]["losses"], off32["losses"])
    bf = {}
    for n, ranks in runs.items():
        bf[n] = {
            "step_s_p50": [statistics.median(r["window_step_s"])
                           for r in ranks],
            "peak_memory_bytes": [r["peak_memory_bytes"] for r in ranks],
            "losses": [r["losses"] for r in ranks],
            "per_step": [per_step(r, PP_STEPS_BF16) for r in ranks],
            "predicted": want[n],
            "launches": [r["launches"] for r in ranks],
            "microbatches": [r["microbatches"] for r in ranks],
            "wall_s": [r["wall_s"] for r in ranks]}
        bf[n]["slowdown_to_off"] = (
            bf[n]["step_s_p50"][0]
            / statistics.median(offbf["window_step_s"]))
    line = {
        "phase": "pipeline_parallel", "card": card,
        "model": "pipeline_transformer", "layers": PP_LAYERS,
        "layers_per_stage": PP_LAYERS // 2, "model_parallelism": 2,
        "seq": s, "global_batch": PP_BATCH, "microbatches": 8,
        "optimizer": "adamw", "backend": "gloo (two stages share the card; "
        "the activations, their cotangents and the broadcast ride the "
        "host)", "loss_rtol": PP_LOSS_RTOL,
        "note": "both stages share one card's SMs: the step time says "
                "nothing of the bubble or of PP across cards",
        "train_f32": {"steps": PP_STEPS_F32,
                      "losses_pp": pp32[0]["losses"],
                      "losses_off": off32["losses"],
                      "loss_rel_gap_pp_to_off": gap,
                      "per_step": [per_step(r, PP_STEPS_F32) for r in pp32],
                      "predicted": want32},
        "train_bf16": {"steps": PP_STEPS_BF16, **bf,
                       "step_s_p50_off": statistics.median(
                           offbf["window_step_s"]),
                       "peak_memory_bytes_off": offbf["peak_memory_bytes"],
                       "losses_off": offbf["losses"],
                       "launches_off": offbf["launches"]},
        "tp_region_allreduce_bytes_per_step": PP_BATCH * s * d * 2,
        "correct_wall_s": correct_s, "timed_wall_s": timed_s}
    emit(line)
    k_off = PP_LAYERS * PP_STEPS_BF16
    every = pp32 + runs["gpipe"] + runs["interleave"]
    gates = {
        "pp_f32_vs_off": gap <= PP_LOSS_RTOL,
        "grid": all(r["model_parallelism"] == 2 and r["replicas"] == 1
                    and r["microbatches"] == 8 for r in every),
        "ranks_bit_equal": all(r[0]["losses"] == r[1]["losses"]
                               for r in (pp32, runs["gpipe"],
                                         runs["interleave"])),
        "as_predicted": (
            all(as_predicted(r, PP_STEPS_F32, want32) for r in pp32)
            and all(as_predicted(r, PP_STEPS_BF16, want[n])
                    for n in runs for r in runs[n])),
        "twin_launches": (offbf["launches"]["K1"] == k_off
                          and offbf["launches"]["K3"] == k_off),
        "finite": all(math.isfinite(v) for r in every
                      for v in r["losses"])}
    emit({"phase": "pipeline_parallel_gates", "card": card, **gates})
    if not all(gates.values()):
        raise AssertionError(f"pipeline_parallel: {gates}")
    line["launches_pp"] = {k: [r["launches"][k] for r in runs["gpipe"]]
                           for k in ("K1", "K2a", "K2b", "K3")}
    line["launches_pp_interleave"] = {
        k: [r["launches"][k] for r in runs["interleave"]]
        for k in ("K1", "K2a", "K2b", "K3")}
    line["launches_pp_twin"] = offbf["launches"]
    return line


# ---------------------------------------------------------------------------
# phase 20: expert parallelism (models/moe.py, parallel/collectives.py
# all_to_all, the Trainer's expert leaves)
# ---------------------------------------------------------------------------

EP_BATCH = 4             # global at data 2: two sequences a rank
EP_TWIN_BATCH = 2        # the world-1 twin: one rank's batch
EP_STEPS_F32 = 3
EP_STEPS_BF16 = 6
# moe_transformer at 6 of its 12 layers (3 MoE blocks), every width
# kept, to make room for phase 21; no gate depends on depth
EP_LAYERS = 6
# f32 losses of the two ranks (the same function: each rank's copy of
# the synthetic batch, its slot rows exchanged with its peer's) against
# world 1; the gate phases 16, 18 and 19 hold
EP_LOSS_RTOL = 1e-4


def ep_lm_argv(seed: int, dtype: str, steps: int, batch: int) -> list:
    return ["--use_synthetic_data", "--device", "cuda", "--model",
            "moe_transformer", "--dtype", dtype, "--batch_size",
            str(batch), "--train_steps", str(steps), "--log_steps", "1",
            "--seed", str(seed), "--step_time_guard_factor", "0"]


def ep_prediction(experts: int, tokens: int, d: int, top_k: int,
                  cf: float, moe_blocks: int, itemsize: int) -> dict:
    """A data-axis expert rank's exchanges a training step as
    ``models/moe.py`` makes them: two all_to_all a MoE block forward and
    two backward, each the rank's [E, C, d] slot rows, C = max(1, min(n,
    round(cf k n / E))) for its n tokens."""
    cap = max(1, min(tokens, int(round(cf * top_k * tokens / experts))))
    calls = 4 * moe_blocks
    return {"capacity": cap, "calls": calls,
            "bytes": calls * experts * cap * d * itemsize}


def ep_dispatch_twice(torch, seed: int) -> dict:
    """(d): one MoEMLP of moe_transformer (8 experts, d 512, d_ff 2048,
    top-2, capacity factor 1.25) forward and backward on the card at a
    rank's shape, [2, 2048, 512] bf16, twice: the output and every
    gradient bit for bit (the scatter's one writer a row)."""
    from dtf_tpu_torch.models.moe import MoEMLP
    from dtf_tpu_torch.serve.bridge import random_init

    gen = torch.Generator().manual_seed(seed + 20)
    layer = random_init(MoEMLP(512, 8, 2048, dtype=torch.bfloat16),
                        seed + 20).cuda().train()
    x = torch.randn(2, 2048, 512, generator=gen).to("cuda", torch.bfloat16)
    dy = torch.randn(2, 2048, 512, generator=gen).to("cuda", torch.bfloat16)
    runs = []
    for _ in range(2):
        xi = x.clone().requires_grad_()
        layer.zero_grad(set_to_none=True)
        y = layer(xi)
        y.backward(dy)
        runs.append([y.detach(), xi.grad] + [p.grad for p in
                                             layer.parameters()])
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    out = {"shape": [2, 2048, 512], "dtype": "bfloat16",
           "bit_identical": same, "tensors": len(runs[0]),
           "dropped_share": float(layer.dropped) / layer.routed,
           "finite": all(bool(torch.isfinite(t).all()) for t in runs[0])}
    del layer, x, dy, runs
    torch.cuda.empty_cache()
    return out


def expert_parallel(torch, seed: int, card: str, spawn=None) -> dict:
    """Phase 20 (see the module's docstring): ``lm_main --model
    moe_transformer`` at full width and ``EP_LAYERS`` of its 12 layers (8
    experts in every second block, top-2, capacity factor 1.25), S 2048,
    AdamW, two
    gloo ranks sharing the card: (a) f32, 3 steps, experts over the data
    axis (data 2, global batch 4), both ranks against the world-1 twin
    at batch 2 in this process; (b) f32, 3 steps, experts over the model
    axis (``--model_parallelism 2``, data 1, global batch 2) against the
    same twin; (c) bf16, 6 steps, experts over data, timed alone beside
    the bf16 twin: step p50, each rank's peak memory, the exchanges and
    K1/K3 a step, the share of routed tokens dropped, the replicated
    leaves' digests across the ranks; (d) :func:`ep_dispatch_twice`."""
    import tempfile

    def spec(args, **kw):
        return {"main": "lm_main", "defaults": "LM_DEFAULTS",
                "backend": "gloo", "argv": args, "layers": EP_LAYERS,
                "layers_model": "moe_transformer", **kw}

    grid = ["--distribution_strategy", "multi_worker_mirrored",
            "--skip_checkpoint"]
    off = ["--distribution_strategy", "off", "--skip_checkpoint"]
    f32 = ep_lm_argv(seed, "fp32", EP_STEPS_F32, EP_BATCH) + grid
    f32_model = ep_lm_argv(seed, "fp32", EP_STEPS_F32, EP_TWIN_BATCH) + \
        grid + ["--model_parallelism", "2"]
    bf16 = ep_lm_argv(seed, "bf16", EP_STEPS_BF16, EP_BATCH) + grid
    twin32 = ep_lm_argv(seed, "fp32", EP_STEPS_F32, EP_TWIN_BATCH) + off
    twinbf = ep_lm_argv(seed, "bf16", EP_STEPS_BF16, EP_TWIN_BATCH) + off
    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        go = os.path.join(root, "ep_bf16.go")
        bfr = None
        try:
            futs = [overlapped(zero_launch, spec(f32), 2, root, "ep f32",
                               spawn=spawn),
                    overlapped(zero_launch, spec(f32_model), 2, root,
                               "ep f32 model", spawn=spawn)]
            with fleet_depth(EP_LAYERS, "moe_transformer"):
                off32 = tp_lm_here(torch, twin32)
            dispatch = ep_dispatch_twice(torch, seed)
            # the timed run's ranks start now, build, and wait for their
            # go until the correctness runs are done
            timed = overlapped(zero_launch, spec(bf16, go=go), 2, root,
                               "ep bf16", spawn=spawn)
            ep32, model32 = gathered(futs)
            correct_s = time.time() - t0
            t0 = time.time()
            with open(go, "w"):
                pass
            bfr = timed.result()
        finally:
            # the timed ranks run (and end) whatever happened here
            if bfr is None:
                with open(go, "w"):
                    pass
        with fleet_depth(EP_LAYERS, "moe_transformer"):
            offbf = tp_lm_here(torch, twinbf)
        timed_s = time.time() - t0

    d, moe_blocks = 512, EP_LAYERS // 2
    tokens = EP_BATCH // 2 * TRAIN_SHAPE[1]
    want32 = ep_prediction(8, tokens, d, 2, 1.25, moe_blocks, 4)
    wantbf = ep_prediction(8, tokens, d, 2, 1.25, moe_blocks, 2)

    def per_step(r, steps):
        return {"all_to_all": {k: r["all_to_all"][k] / steps
                               for k in ("calls", "bytes")},
                "K1": r["launches"]["K1"] / steps,
                "K3": r["launches"]["K3"] / steps,
                "K2a": r["launches"]["K2a"], "K2b": r["launches"]["K2b"]}

    def as_predicted(r, steps, want):
        got = per_step(r, steps)
        return (got["all_to_all"] == {k: want[k] for k in ("calls", "bytes")}
                and got["K1"] == got["K3"] == EP_LAYERS
                and got["K2a"] == got["K2b"] == 0)

    ref = off32["losses"]
    gaps = [rel_gap(r["losses"], ref) for r in ep32]
    gaps_model = [rel_gap(r["losses"], ref) for r in model32]
    line = {
        "phase": "expert_parallel", "card": card, "model": "moe_transformer",
        "layers": EP_LAYERS, "moe_blocks": moe_blocks, "experts": 8,
        "top_k": 2, "capacity_factor": 1.25, "seq": TRAIN_SHAPE[1],
        "global_batch": EP_BATCH, "twin_batch": EP_TWIN_BATCH,
        "optimizer": "adamw", "loss_rtol": EP_LOSS_RTOL,
        "backend": "gloo (two ranks share the card; the slot rows and the "
                   "gradient all-reduce ride the host)",
        "train_f32_data": {
            "steps": EP_STEPS_F32, "losses": [r["losses"] for r in ep32],
            "losses_off": ref, "loss_rel_gap_to_off": gaps,
            "per_step": [per_step(r, EP_STEPS_F32) for r in ep32],
            "predicted": want32,
            "dropped_share": [r["moe_dropped_share"] for r in ep32]},
        "train_f32_model_axis": {
            "steps": EP_STEPS_F32, "losses": [r["losses"] for r in model32],
            "loss_rel_gap_to_off": gaps_model,
            "per_step": [per_step(r, EP_STEPS_F32) for r in model32]},
        "train_bf16": {
            "steps": EP_STEPS_BF16,
            "step_s_p50": [statistics.median(r["window_step_s"])
                           for r in bfr],
            "step_s_p50_off": statistics.median(offbf["window_step_s"]),
            "peak_memory_bytes": [r["peak_memory_bytes"] for r in bfr],
            "peak_memory_bytes_off": offbf["peak_memory_bytes"],
            "losses": [r["losses"] for r in bfr],
            "losses_off": offbf["losses"],
            "per_step": [per_step(r, EP_STEPS_BF16) for r in bfr],
            "predicted": wantbf,
            "dropped_share": [r["moe_dropped_share"] for r in bfr],
            "replicated_digests": [r["replicated_digest"] for r in bfr],
            "launches": [r["launches"] for r in bfr],
            "launches_off": offbf["launches"],
            "wall_s": [r["wall_s"] for r in bfr]},
        "dispatch_twice": dispatch,
        "correct_wall_s": correct_s, "timed_wall_s": timed_s}
    emit(line)
    k_off = EP_LAYERS * EP_STEPS_BF16
    gates = {
        "ep_f32_vs_off": max(gaps) <= EP_LOSS_RTOL,
        "model_axis_f32_vs_off": max(gaps_model) <= EP_LOSS_RTOL,
        "grid": (all(r["replicas"] == 2 and r["model_parallelism"] == 1
                     for r in ep32 + bfr)
                 and all(r["replicas"] == 1 and r["model_parallelism"] == 2
                         for r in model32)),
        "as_predicted": (
            all(as_predicted(r, EP_STEPS_F32, want32) for r in ep32)
            and all(as_predicted(r, EP_STEPS_BF16, wantbf) for r in bfr)
            and all(as_predicted(r, EP_STEPS_F32, {"calls": 0, "bytes": 0})
                    for r in model32)),
        "ranks_bit_equal": all(r[0]["losses"] == r[1]["losses"]
                               for r in (ep32, model32, bfr)),
        "replicated_digests_equal": all(
            r[0]["replicated_digest"] == r[1]["replicated_digest"]
            for r in (ep32, bfr)),
        "twin_launches": (offbf["launches"]["K1"] == k_off
                          and offbf["launches"]["K3"] == k_off),
        "dispatch_bit_identical": dispatch["bit_identical"]
        and dispatch["finite"],
        "finite": all(math.isfinite(v) for r in ep32 + model32 + bfr
                      for v in r["losses"])}
    emit({"phase": "expert_parallel_gates", "card": card, **gates})
    if not all(gates.values()):
        raise AssertionError(f"expert_parallel: {gates}")
    line["launches_ep"] = {k: [r["launches"][k] for r in bfr]
                           for k in ("K1", "K2a", "K2b", "K3")}
    line["launches_ep_twin"] = offbf["launches"]
    return line


# ---------------------------------------------------------------------------
# phase 21: the parallelism planners (plan/, cli/plan_main.py,
# cli/plan_serve_main.py)
# ---------------------------------------------------------------------------

PLAN_STEPS = 3           # the --plan auto run and its hand-flagged twin
PLAN_BATCH = 256         # the ranked workload's global batch
PLAN_CALIBRATE_STEPS = 8     # plan_main's default
PLAN_FULL_STEPS = 6          # the full-width calibration's steps
PLAN_RATIO = (0.5, 2.0)      # the JAX contracts' step-time / serving band
PLAN_MEM_FACTOR = (1.0, 4.0)  # predicted peak over live bytes


def plan_flags_argv(cfg) -> list:
    """The flags a resolved plan wrote, as a hand-typed argv: every
    plan-owned flag off its default, and ``--num_devices``."""
    from dtf_tpu_torch.plan.compile import PLAN_OWNED_FLAGS

    out = ["--num_devices", str(cfg.num_devices)]
    for name, default in PLAN_OWNED_FLAGS.items():
        value = getattr(cfg, name)
        if value != default:
            out += [f"--{name}", str(value).lower()
                    if isinstance(value, bool) else str(value)]
    return out


def plan_lm_here(torch, argv) -> dict:
    """``lm_main.main(argv)`` in this process, the kernels' counters
    zeroed just before and read just after: the losses, a sha256 of the
    trained state dict and the launches."""
    import hashlib

    from dtf_tpu_torch.cli import lm_main, runner
    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import paged_attention as pa

    kept = {}
    build = runner.build_training

    def keep(cfg, rt=None):
        out = build(cfg, rt)
        kept["trainer"], kept["cfg"] = out[0], cfg
        return out

    runner.build_training = keep
    try:
        torch.cuda.empty_cache()
        reset_counts(fa, pa)
        stats = lm_main.main(argv)
        torch.cuda.synchronize()
        launches = kernel_counts(fa, pa)
    finally:
        runner.build_training = build
    digest = hashlib.sha256()
    for t in kept.pop("trainer").model.state_dict().values():
        digest.update(t.detach().float().cpu().contiguous().numpy()
                      .tobytes())
    return {"losses": [v for _, v in stats["train_loss_log"]],
            "digest": digest.hexdigest(), "launches": launches,
            "cfg": kept["cfg"], "window_step_s": stats["window_step_s"]}


def plan_gauges(names) -> dict:
    from dtf_tpu_torch.obs.registry import default_registry
    reg = default_registry()
    return {n: (float(reg.get(n).value) if reg.get(n) is not None
                else None) for n in names}


def plan_main_calibrate(torch, argv) -> dict:
    """``plan_main --calibrate`` in this process (the FLOP/s probe, then
    the measured run), its output dropped, its gauges and launches
    read."""
    from dtf_tpu_torch.cli import plan_main
    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import paged_attention as pa

    from dtf_tpu_torch.obs.registry import default_registry

    names = ("plan_probe_flops", "plan_predicted_step_s",
             "plan_measured_step_s", "plan_step_time_ratio",
             "plan_predicted_peak_bytes", "plan_measured_live_bytes",
             "plan_live_bytes_ratio")
    for name in names:      # a gauge this run does not set reads NaN
        if default_registry().get(name) is not None:
            default_registry().get(name).set(math.nan)
    reset_counts(fa, pa)
    t0 = time.perf_counter()
    rc = quiet(plan_main.main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = plan_gauges(names)
    return {"rc": rc, **out, "launches": kernel_counts(fa, pa),
            "wall_s": wall}


def plan_serve_run(torch, argv) -> dict:
    """``plan_serve_main`` in this process, its output dropped, the
    kernels' counters zeroed just before and read just after."""
    from dtf_tpu_torch.cli import plan_serve_main
    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import paged_attention as pa

    reset_counts(fa, pa)
    t0 = time.perf_counter()
    rc = quiet(plan_serve_main.main, argv)
    torch.cuda.synchronize()
    return {"rc": rc, "launches": kernel_counts(fa, pa),
            "wall_s": time.perf_counter() - t0}


def planner(torch, seed: int, card: str, zero3: dict, spawn=None) -> dict:
    """Phase 21 (see the module's docstring).  ``zero3``: phase 15's
    stage-3 arm (its argv, both ranks' losses and digests), which the
    plan-file run must reproduce bit for bit."""
    import importlib
    import tempfile

    from dtf_tpu_torch.config import parse_flags
    from dtf_tpu_torch.ops import flash_attention as fa
    from dtf_tpu_torch.ops import paged_attention as pa
    from dtf_tpu_torch.plan import (Plan, characterize, predict,
                                    resolve_plan, search)
    from dtf_tpu_torch.cli.lm_main import LM_DEFAULTS

    ms = importlib.import_module("dtf_tpu_torch.plan.mesh_spec")
    t_phase = time.time()
    b = TRAIN_SHAPE[0]
    base = ["--use_synthetic_data", "--device", "cuda", "--model",
            "transformer_tpu", "--dtype", "bf16", "--batch_size", str(b),
            "--train_steps", str(PLAN_STEPS), "--log_steps", "1",
            "--seed", str(seed), "--skip_checkpoint",
            "--step_time_guard_factor", "0"]
    with tempfile.TemporaryDirectory() as root:
        # (a) two gloo ranks from a plan file naming phase 15's ZeRO-3
        # arm, beside (b)-(f) in this process: no gate of theirs is a
        # time; the gated calibrations (g) wait for the ranks to end
        plan_file = os.path.join(root, "zero3.json")
        with open(plan_file, "w") as f:
            json.dump({"plan": {"data": 2, "zero": 3}}, f)
        arm = list(zero3["argv"])
        i = arm.index("--zero_stage")
        del arm[i:i + 2]
        filed = overlapped(zero_launch, {
            "main": "lm_main", "defaults": "LM_DEFAULTS", "backend": "gloo",
            "argv": arm + ["--plan", plan_file], "layers": DP_LM_LAYERS},
            2, root, "plan file zero3", spawn=spawn)
        # (b) the live mesh of a world-1 run on the card
        live = ms.mesh_spec("", cfg=parse_flags(["--device", "cuda"]))
        total = torch.cuda.get_device_properties(0).total_memory
        mesh_line = {
            "name": live.name, "hosts": live.num_hosts,
            "devices_per_host": live.devices_per_host,
            "hbm_bytes_per_rank": live.hbm_bytes,
            "card_total_memory": total,
            "preset_hbm_bytes": ms.H100_HBM_BYTES,
            "preset_matches_card": ms.H100_HBM_BYTES == total,
            "device_flops": live.device_flops,
            "intra_bw": live.intra_bw, "inter_bw": live.inter_bw,
            "bandwidths": "data sheet, uncalibrated ("
                          + ", ".join(ms.DATASHEET_UNCALIBRATED) + ")"}
        # (c) the FLOP/s probe on the card (beside the ranks: its rate
        # is printed; the gated calibration takes its own, alone)
        reset_counts(fa, pa)
        t0 = time.perf_counter()
        probe_flops = ms.calibrate_device_flops("cuda")
        probe_s = time.perf_counter() - t0
        probe_launches = kernel_counts(fa, pa)
        # (d) the flagship's lattice on the H100 presets
        stats = characterize("transformer_tpu", seq_len=TRAIN_SHAPE[1],
                             dtype_bytes=2)
        ranked = {}
        for name in ("h100x8", "4xh100x8"):
            t0 = time.perf_counter()
            r = search(stats, ms.PRESETS[name], PLAN_BATCH,
                       optimizer="adamw")
            top = r[0]
            ranked[name] = {
                "ms": 1e3 * (time.perf_counter() - t0), "plans": len(r),
                "feasible": sum(1 for x in r if x.feasible),
                "top": top.plan.describe(),
                "predicted_step_ms": 1e3 * top.cost.step_time_s,
                "predicted_peak_gib": top.cost.peak_bytes / 2 ** 30}
        # (e) --plan auto at full width against its hand-flagged twin
        t0 = time.perf_counter()
        auto = plan_lm_here(torch, base + ["--plan", "auto"])
        resolved = resolve_plan(parse_flags(base + ["--plan", "auto"],
                                            defaults=LM_DEFAULTS))
        hand = plan_lm_here(torch, base + plan_flags_argv(resolved))
        auto_s = time.perf_counter() - t0
        # (f) tp_comm_frac: with both shards on one card its tp-2 step
        # is the two shards' in turn, a measurement with no gate
        tp = plan_serve_run(torch, [
            "--measure_tp_comm", "--device", "cuda", "--rate", "8",
            "--duration", "5", "--decode_step_ms", "12",
            "--prefill_chunk_ms", "9"])
        tp.update(plan_gauges(("plan_serve_tp_comm_frac",)))
        plan_run = filed.result()
    plan_desc = auto["cfg"]
    # (g) the training calibration contract (gated), then full width
    # (printed), then the serving calibration contract (gated)
    small = plan_main_calibrate(torch, [
        "--model", "transformer_small", "--dataset", "lm",
        "--use_synthetic_data", "--seq_len", "64", "--batch_size", "4",
        "--optimizer", "adamw", "--calibrate", "--calibrate_tolerance",
        str(PLAN_RATIO[1]), "--top", "0", "--device", "cuda"])
    # full width: the probe at the run's own shapes; its ratio outside
    # the band is a finding (rc 1), printed, not a failure
    full = plan_main_calibrate(torch, [
        "--model", "transformer_tpu", "--dataset", "lm",
        "--use_synthetic_data", "--seq_len", str(TRAIN_SHAPE[1]),
        "--batch_size", str(b), "--dtype", "bf16", "--optimizer", "adamw",
        "--calibrate", "--calibrate_steps", str(PLAN_FULL_STEPS),
        "--calibrate_probe", "run", "--top", "0", "--device", "cuda"])
    # what the small probe's rate (c) predicts for the same run
    full_stats = characterize("transformer_tpu", seq_len=TRAIN_SHAPE[1],
                              dtype_bytes=2)
    small_probe_step = predict(Plan(), full_stats, live, b,
                               optimizer="adamw",
                               device_flops=probe_flops).step_time_s
    full["small_probe_predicted_step_s"] = small_probe_step
    full["small_probe_step_time_ratio"] = (
        small_probe_step / full["plan_measured_step_s"]
        if full["plan_measured_step_s"] else None)
    serve = plan_serve_run(torch, ["--calibrate", "--device", "cuda"])
    serve.update(plan_gauges(("plan_serve_tokens_ratio",
                              "plan_serve_p99_ratio")))
    phase_s = time.time() - t_phase

    layers = 12
    small_layers, small_steps = 4, PLAN_CALIBRATE_STEPS
    # the probe: a warm-up and three timed fwd+bwd of 4 layers
    want_probe = {"K1": 4 * small_layers, "K3": 4 * small_layers}
    want_small = {k: v + small_layers * small_steps
                  for k, v in want_probe.items()}
    # the run-shape probe: a warm-up and three timed fwd+bwd of 12
    want_full = {k: 4 * layers + layers * PLAN_FULL_STEPS
                 for k in ("K1", "K3")}
    want_auto = {"K1": layers * PLAN_STEPS, "K3": layers * PLAN_STEPS}
    # serving: every request's one prefill chunk (its prompt is at most
    # a page) through K1 in each of 4 layers: 2 warm-up + 12 measured
    want_serve_k1 = small_layers * (2 + 12)

    def pick(launches):
        return {k: launches[k] for k in ("K1", "K3")}

    calib_ratio = small["plan_step_time_ratio"]
    mem_factor = small["plan_live_bytes_ratio"]
    line = {
        "phase": "planner", "card": card, "live_mesh": mesh_line,
        "probe": {"device_flops": probe_flops, "seconds": probe_s,
                  "launches": probe_launches,
                  "run": "transformer_small f32, batch 2, S 64: a warm-up "
                         "and 3 timed fwd+bwd"},
        "ranked": ranked,
        "plan_auto": {
            "plan_flags": plan_flags_argv(resolved),
            "num_devices": plan_desc.num_devices,
            "zero_stage": plan_desc.zero_stage_effective,
            "losses": auto["losses"], "losses_hand": hand["losses"],
            "losses_bit_identical": auto["losses"] == hand["losses"],
            "state_bit_identical": auto["digest"] == hand["digest"],
            "launches": auto["launches"], "launches_hand": hand["launches"],
            "wall_s": auto_s},
        "plan_file_zero3": {
            "plan": {"data": 2, "zero": 3},
            "losses": [r["losses"] for r in plan_run],
            "zero_stage": [r["zero_stage"] for r in plan_run],
            "losses_bit_identical": [r["losses"] for r in plan_run]
            == zero3["losses"],
            "digests_bit_identical": [r["digest"] for r in plan_run]
            == zero3["digests"],
            "launches": [r["launches"] for r in plan_run]},
        "calibrate": {k: v for k, v in small.items()},
        "calibrate_full_width": {k: v for k, v in full.items()},
        "serve_calibrate": serve, "measure_tp_comm": tp,
        "phase_s": phase_s}
    emit(line)
    k_plan = DP_LM_LAYERS * ZERO_STEPS
    gates = {
        "live_mesh": (live.hbm_bytes == total and live.num_devices == 1
                      and live.name == "runtime"),
        "probe_flops": math.isfinite(probe_flops) and probe_flops > 0
        and pick(probe_launches) == want_probe,
        "ranked": all(v["feasible"] > 0 for v in ranked.values()),
        "plan_auto_bit_identical": (
            line["plan_auto"]["losses_bit_identical"]
            and line["plan_auto"]["state_bit_identical"]
            and all(math.isfinite(v) for v in auto["losses"])
            and pick(auto["launches"]) == want_auto),
        "plan_file_bit_identical": (
            line["plan_file_zero3"]["losses_bit_identical"]
            and line["plan_file_zero3"]["digests_bit_identical"]
            and all(r["zero_stage"] == 3 and r["replicas"] == 2
                    for r in plan_run)
            and all(r["launches"]["K1"] == r["launches"]["K3"] == k_plan
                    for r in plan_run)),
        "calibrate_ratio": (small["rc"] == 0 and calib_ratio is not None
                            and PLAN_RATIO[0] <= calib_ratio
                            <= PLAN_RATIO[1]),
        "calibrate_memory": (mem_factor is not None
                             and PLAN_MEM_FACTOR[0] <= mem_factor
                             <= PLAN_MEM_FACTOR[1]),
        "calibrate_launches": (pick(small["launches"]) == want_small
                               and pick(full["launches"]) == want_full),
        "calibrate_full_ran": (
            full["rc"] in (0, 1)
            and all(full[k] is not None and math.isfinite(full[k])
                    and full[k] > 0
                    for k in ("plan_probe_flops", "plan_step_time_ratio",
                              "small_probe_step_time_ratio"))),
        "serve_ratios": (serve["rc"] == 0 and all(
            serve[k] is not None and PLAN_RATIO[0] <= serve[k]
            <= PLAN_RATIO[1]
            for k in ("plan_serve_tokens_ratio", "plan_serve_p99_ratio"))),
        "serve_launches": (serve["launches"]["K1"] == want_serve_k1
                           and serve["launches"]["K4"] > 0
                           and serve["launches"]["K4"] % small_layers == 0),
        "tp_comm": (tp["rc"] == 0
                    and tp["plan_serve_tp_comm_frac"] is not None
                    and tp["launches"]["K4"] > 0)}
    emit({"phase": "planner_gates", "card": card, **gates})
    if not all(gates.values()):
        raise AssertionError(f"planner: {gates}")
    line["launches_plan"] = {
        kern: {"probe_f32": probe_launches[kern],
               "plan_auto_bf16": auto["launches"][kern],
               "calibrate_f32": small["launches"][kern],
               "calibrate_full_bf16": full["launches"][kern]}
        for kern in ("K1", "K3")}
    line["launches_plan_run"] = (
        "phase 21: calibrate_device_flops on cuda (transformer_small f32, "
        "a warm-up and 3 fwd+bwd); lm_main --plan auto, transformer_tpu "
        f"bf16, {PLAN_STEPS} steps; plan_main --calibrate at "
        "transformer_small f32 (the probe and 8 steps) and at full width "
        f"bf16 (the run-shape probe and {PLAN_FULL_STEPS} steps)")
    line["launches_plan_serve"] = {
        kern: {"calibrate": serve["launches"][kern],
               "measure_tp_comm": tp["launches"][kern]}
        for kern in ("K1", "K4")}
    line["launches_plan_serve_run"] = (
        "phase 21: plan_serve_main --calibrate (transformer_small bf16, 2 "
        "warm-up and 12 requests of 24 tokens, 4 slots) and "
        "--measure_tp_comm (the same burst at tp 1 and at serve_tp 2, "
        "both shards on the card)")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        return fail("CUDA is not available; this script runs the port on "
                    "an NVIDIA GPU")
    if not os.path.isdir(os.path.join(ROOT, "dtf_tpu_torch")):
        return fail("dtf_tpu_torch/ is not beside this script; run it from "
                    "a checkout of the repository")
    sys.path.insert(0, ROOT)
    # one bytecode cache in the checkout's build directory for this
    # process and every one it starts: where Python runs with
    # PYTHONDONTWRITEBYTECODE, or its packages ship no .pyc, each new
    # process would compile torch's modules from source again
    pycache = os.path.join(ROOT, "dtf_tpu_torch", "_build", "pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = pycache
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix, sys.dont_write_bytecode = pycache, False
    from dtf_tpu_torch.ops import _build
    from dtf_tpu_torch.runtime.device import resolve_device

    # phase 1: the card and the build
    resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    probe = host_probe()
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": time.perf_counter() - t0,
          "build_s_per_source": _build.build_seconds,
          "ptxas": {n: _build.ptxas_report(n) for n in _build.SOURCES}})

    host = probe()
    emit({"phase": "host_probe", **host})

    # phase 2: each kernel against its plain version
    clock = PhaseClock(host)
    gen = torch.Generator().manual_seed(args.seed)
    timer = Timer(torch)
    k1 = check_flash(torch, timer, gen)
    _, bwd = check_backward(torch, timer, gen)
    k4 = check_paged(torch, timer, gen)
    check_peaked(torch, gen)
    tp_cases = check_tp_kernels(torch, timer, gen)
    pp_cases = check_pp_kernels(torch, timer, gen)
    ep_cases = check_ep_kernels(torch, timer, gen)
    clock.done("2")

    # phases 3 and 4: the serving path
    per_call = check_serving_f32(torch, args.seed)
    serve4 = serve_bf16(torch, args.seed, per_call)
    serve_launches = serve4["launches"]
    decode_profile = profile_decode_step(torch, args.seed)
    clock.done("3-4")

    # phases 5 and 6: the training path
    train32 = check_training_f32(torch, args.seed)
    check_training_bf16(torch, args.seed)
    train = train_bf16(torch, args.seed)
    remat = train_remat_arms(torch, args.seed, train)
    # the split pair's path at the training shape, beside K3's
    train_split = train_bf16(torch, args.seed, split=True, steps=20)
    profile_train_step(torch, args.seed)
    clock.done("5-6")

    # phase 7: ResNet training (no TPU kernel lies on this path)
    resnet_step_s = train_resnet(torch, timer, args.seed, card)
    clock.done("7")

    # the launcher ranks of phases 9, 11 and 15-20 and the replicas of
    # phases 13-14 fork from one pre-imported spawner, which imports
    # beside phase 8's processes' own imports (before any timed turn);
    # it ends with this process
    forks = ReplicaForkServer().start()
    atexit.register(forks.stop)
    emit({"phase": "spawner", **forks.helper_pids()})

    # phase 8: data parallelism (K1 and K3 on the LM's path)
    dp = train_data_parallel(torch, args.seed, card)
    dp_run_name = ("lm_main multi_worker_mirrored, one rank on NCCL, "
                   "20 steps (phase 8)")
    clock.done("8")

    # phase 9: recovery (K1 and K3 in the resumed LM run, K1 and K4
    # serving its checkpoint)
    rec = train_recovery(torch, args.seed, card, spawn=forks.rank_spawn)
    rec_run = ("lm_main resumed after crash@step:4, steps 5-8, one "
               "process (phase 9)")
    rec_serve_run = "serve_main --model_dir, 4 requests (phase 9)"
    clock.done("9")

    # phase 10: ImageNet input into ResNet-50 and fp16 (no TPU kernel
    # lies on this path either)
    train_imagenet_input(torch, args.seed, card, resnet_step_s)
    clock.done("10")

    # phase 11: the async parameter server (K1 and K3 in the LM worker;
    # the reference-shape ranks forked from the spawner)
    ps = async_ps(torch, args.seed, card, spawn=forks.rank_spawn)
    ps_lm_run = ("lm_main --ps_mode async, one worker, 3 steps "
                 "(phase 11)")
    clock.done("11")

    # phase 12: serving as the JAX package serves by default (K1 on
    # first chunks without a hit, K4 on everything else)
    prefix = serve_prefix(torch, args.seed, card)
    launches_prefix = {
        f"{arm}_{name}": prefix[arm][name]["launches"]
        for arm in ("concurrency", "ttft")
        for name in ("sharing", "nosharing")}
    prefix_run = ("phase 12 shared-prefix bursts after a warm request, "
                  "bf16: concurrency (128-token system prompt, 8 tails "
                  "of 8, the 25-page pool) and ttft (1024-token system "
                  "prompt, 16 tails of U[1, 64]), with and without "
                  "sharing")
    clock.done("12")

    # phase 13: the serving fleet -- replica processes sharing the card
    # (K1 on each replica's first chunks without a hit, K4 on the rest,
    # the decode replica's over migrated pages)
    with fleet_depth():
        fleet = serve_fleet(torch, args.seed, card, forks)
    fleet_run_name = ("phase 13 fleet, two replica_main processes: "
                      "colocated f32 (16 requests, replica_kill@req:6, 4 "
                      "after the respawn), disaggregated f32 and bf16 (16 "
                      "requests each); counts from the replicas' exits, "
                      "the SIGKILLed one's lost")
    clock.done("13")

    # phase 14: the fleet's HA pair and rollouts on the same replica
    # processes (K1 and K4 in each, the canary and every restarted
    # generation included)
    with fleet_depth():
        ha_roll = serve_ha_rollout(
            torch, args.seed, card, fleet["prompts"], fleet["reference"],
            fleet["cold"], fleet["cold_reference"], forks)
    ha_run = ("phase 14, two replica_main processes on exports A/B/C: "
              "the HA stages (a 16-request baseline, router_kill@req:5 "
              "and the takeover, an epoch-3 force-take, lease_stall@4)")
    rollout_run = ("phase 14 after the HA stages: rollouts A->B, B->C, "
                   "rollout_kill@phase:rolling, ckpt_truncate and a "
                   "router_kill in ROLLING resumed by the standby, under "
                   "live traffic; counts from the processes' exits (a "
                   "SIGKILLed one's lost)")
    clock.done("14")

    # phase 15: ZeRO stages 1-3 (K1 and K3 in every rank process)
    zero = zero_stages(torch, args.seed, card, spawn=forks.rank_spawn)
    clock.done("15")

    # phase 16: tensor parallelism (K1 and K3 at 3 heads in each rank,
    # K1 and K4 at 3 heads in each serving shard)
    tp = tensor_parallel(torch, args.seed, card, per_call, serve4,
                         spawn=forks.rank_spawn)
    tp_run = ("phase 16: K1/K3 rank 0 of lm_main --model_parallelism 2, "
              "bf16, 6 steps; K4 (and launches_tp_serve for K1) the bf16 "
              "serve_tp 2 engine's two shards, 16 requests")
    clock.done("16")

    # phase 17: elastic training (K1 and K3 in every rank of every
    # attempt; counted in the grown attempt's rank 0)
    el = elastic_training(torch, args.seed, card, spawn=forks.rank_spawn)
    clock.done("17")

    # phase 18: sequence parallelism (no flash kernel on a seq rank: the
    # attention rides the ring; K1 and K3 in the world-1 twin)
    sp = sequence_parallel(torch, args.seed, card, spawn=forks.rank_spawn)
    sp_run = ("phase 18: both ranks of lm_main --seq_parallelism 2, bf16, "
              "6 steps, 6 layers (launches_sp), and its world-1 twin "
              "(launches_sp_twin)")
    clock.done("18")

    # phase 19: pipeline parallelism (K1 and K3 at [1, 2048, 8, 64] at
    # every tick of each stage, bubble ticks included)
    pp = pipeline_parallel(torch, args.seed, card, spawn=forks.rank_spawn)
    pp_run = ("phase 19: both stages of lm_main pipeline_transformer "
              "--model_parallelism 2, bf16, 6 steps, GPipe (launches_pp) "
              "and --pipeline_interleave 2 (launches_pp_interleave), and "
              "its world-1 twin (launches_pp_twin)")
    clock.done("19")

    # phase 20: expert parallelism (K1 and K3 at [2, 2048, 8, 64] in
    # every block of each rank; the experts' products, the dispatch and
    # the exchange in plain torch, as XLA computes them)
    ep = expert_parallel(torch, args.seed, card, spawn=forks.rank_spawn)
    ep_run = ("phase 20: both ranks of lm_main moe_transformer, experts "
              "over data 2, bf16, 6 steps (launches_ep), and its world-1 "
              "twin at batch 2 (launches_ep_twin)")
    clock.done("20")

    # phase 21: the planners (K1 and K3 in the FLOP/s probe, the --plan
    # auto run and the calibrations; K1 and K4 in the serving
    # calibration's engines)
    plan = planner(torch, args.seed, card, zero["stage3_arm"],
                   spawn=forks.rank_spawn)
    clock.done("21")

    keys = ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    f32_keys = ("bound_cuda_core_ms",)

    def entry(name, source, replaces, main_case, launches, run, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "design": main_case["design"],
                "launches": launches, "launches_run": run,
                "main_path_case": {k: main_case[k] for k in main_case
                                   if k in ("shape", "causal", "case",
                                            "dtype")},
                **{k: main_case[k] for k in keys},
                **{k: main_case[k] for k in f32_keys if k in main_case},
                **extra}

    # the cases the runs launch most: K1 at the training shape (and a
    # 64-token first chunk when serving), K4 at a decode step over 8 rows;
    # each flash kernel on both routes, a bf16 case with the launches of
    # a bf16 run (phase 6 and its split companion), an f32 case with
    # those of phase 5's f32 AdamW steps
    def k1_case(dname):
        return next(c for c in k1 if c["dtype"] == dname
                    and c["shape"] == list(TRAIN_SHAPE) and c["causal"])

    def k4_case(dname, case):
        return next(c for c in k4 if c["dtype"] == dname
                    and c["case"] == case)

    def k4_brief(c):
        return {k: c[k] for k in ("case", "shape", "dtype", "design",
                                  "max_abs_err", "tol", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}

    split32 = train32["launches"]["adamw_K2a+K2b"]
    fused32 = train32["launches"]["adamw_K3"]
    f32_run = "train f32, 3 AdamW steps bound to K3 (phase 5)"
    split32_run = ("train f32, 3 AdamW steps bound to fused_bwd=False "
                   "(phase 5)")
    split_run = "train bound to fused_bwd=False (phase 6 companion)"
    emit({"kernels": [
        entry("K1", "dtf_tpu_torch/csrc/flash_fwd_tc.cuh",
              "dtf_tpu/ops/flash_attention.py:98", k1_case("bfloat16"),
              train["launches"]["K1"], "train (phase 6)",
              launches_dp=dp["lm"]["launches_nccl_world1"]["K1"],
              launches_dp_run=dp_run_name,
              launches_recovery=rec["lm"]["launches_resumed_process"]["K1"],
              launches_recovery_run=rec_run,
              launches_async=ps["lm"]["launches"]["K1"],
              launches_async_run=ps_lm_run,
              launches_recovery_serve=rec["serve"]["launches"]["K1"],
              launches_recovery_serve_run=rec_serve_run,
              launches_serve=serve_launches["K1"],
              launches_per_serve_call={c: n["K1"]
                                       for c, n in per_call.items()},
              launches_prefix={a: n["K1"]
                               for a, n in launches_prefix.items()},
              launches_prefix_run=prefix_run,
              launches_fleet={a: n["K1"]
                              for a, n in fleet["launches"].items()},
              launches_fleet_run=fleet_run_name,
              launches_ha=ha_roll["launches_ha"]["K1"],
              launches_ha_run=ha_run,
              launches_rollout=ha_roll["launches_rollout"]["K1"],
              launches_rollout_run=rollout_run,
              launches_remat={a: n["K1"]
                              for a, n in remat["launches"].items()},
              launches_remat_run=remat["run"],
              launches_zero=zero["launches_zero"]["K1"],
              launches_zero_run=zero["launches_zero_run"],
              launches_tp=tp["launches_tp"]["K1"],
              launches_tp_serve=tp["launches_tp_serve_K1"],
              launches_tp_run=tp_run, tp_case=tp_cases["K1"],
              launches_elastic=el["launches_elastic"]["K1"],
              launches_elastic_run=el["launches_elastic_run"],
              launches_sp=sp["launches_sp"]["K1"],
              launches_sp_twin=sp["launches_sp_twin"]["K1"],
              launches_sp_run=sp_run,
              launches_pp=pp["launches_pp"]["K1"],
              launches_pp_interleave=pp["launches_pp_interleave"]["K1"],
              launches_pp_twin=pp["launches_pp_twin"]["K1"],
              launches_pp_run=pp_run, pp_case=pp_cases["K1"],
              launches_ep=ep["launches_ep"]["K1"],
              launches_ep_twin=ep["launches_ep_twin"]["K1"],
              launches_ep_run=ep_run, ep_case=ep_cases["K1"],
              launches_plan=plan["launches_plan"]["K1"],
              launches_plan_run=plan["launches_plan_run"],
              launches_plan_serve=plan["launches_plan_serve"]["K1"],
              launches_plan_serve_run=plan["launches_plan_serve_run"]),
        entry("K1 f32", "dtf_tpu_torch/csrc/flash_fwd_x3.cuh",
              "dtf_tpu/ops/flash_attention.py:98", k1_case("float32"),
              fused32["K1"], f32_run,
              serving_chunk_ms=next(
                  c["ms"] for c in k1 if c["dtype"] == "float32"
                  and c["shape"] == [1, 64, 6, 128] and c["causal"]),
              step_ms_f32=train32["step_ms"]),
        entry("K2a", "dtf_tpu_torch/csrc/flash_bwd_dq_tc.cuh",
              "dtf_tpu/ops/flash_attention.py:258", bwd["K2a"],
              train_split["launches"]["K2a"], split_run,
              launches_sp=sp["launches_sp"]["K2a"],
              launches_sp_twin=sp["launches_sp_twin"]["K2a"],
              launches_sp_run=sp_run,
              launches_pp=pp["launches_pp"]["K2a"],
              launches_pp_interleave=pp["launches_pp_interleave"]["K2a"],
              launches_pp_twin=pp["launches_pp_twin"]["K2a"],
              launches_pp_run=pp_run),
        entry("K2a f32", "dtf_tpu_torch/csrc/flash_bwd_dq_x3.cuh",
              "dtf_tpu/ops/flash_attention.py:258", bwd["K2a float32"],
              split32["K2a"], split32_run),
        entry("K2b", "dtf_tpu_torch/csrc/flash_bwd_tc.cuh",
              "dtf_tpu/ops/flash_attention.py:317", bwd["K2b"],
              train_split["launches"]["K2b"], split_run,
              launches_sp=sp["launches_sp"]["K2b"],
              launches_sp_twin=sp["launches_sp_twin"]["K2b"],
              launches_sp_run=sp_run,
              launches_pp=pp["launches_pp"]["K2b"],
              launches_pp_interleave=pp["launches_pp_interleave"]["K2b"],
              launches_pp_twin=pp["launches_pp_twin"]["K2b"],
              launches_pp_run=pp_run),
        entry("K2b f32", "dtf_tpu_torch/csrc/flash_bwd_x3.cuh",
              "dtf_tpu/ops/flash_attention.py:317", bwd["K2b float32"],
              split32["K2b"], split32_run),
        entry("K3", "dtf_tpu_torch/csrc/flash_bwd_tc.cuh",
              "dtf_tpu/ops/flash_attention.py:367", bwd["K3"],
              train["launches"]["K3"], "train (phase 6)",
              launches_dp=dp["lm"]["launches_nccl_world1"]["K3"],
              launches_dp_run=dp_run_name,
              launches_recovery=rec["lm"]["launches_resumed_process"]["K3"],
              launches_recovery_run=rec_run,
              launches_async=ps["lm"]["launches"]["K3"],
              launches_async_run=ps_lm_run,
              launches_remat={a: n["K3"]
                              for a, n in remat["launches"].items()},
              launches_remat_run=remat["run"],
              launches_zero=zero["launches_zero"]["K3"],
              launches_zero_run=zero["launches_zero_run"],
              launches_tp=tp["launches_tp"]["K3"], launches_tp_run=tp_run,
              tp_case=tp_cases["K3"],
              launches_elastic=el["launches_elastic"]["K3"],
              launches_elastic_run=el["launches_elastic_run"],
              launches_sp=sp["launches_sp"]["K3"],
              launches_sp_twin=sp["launches_sp_twin"]["K3"],
              launches_sp_run=sp_run,
              launches_pp=pp["launches_pp"]["K3"],
              launches_pp_interleave=pp["launches_pp_interleave"]["K3"],
              launches_pp_twin=pp["launches_pp_twin"]["K3"],
              launches_pp_run=pp_run, pp_case=pp_cases["K3"],
              launches_ep=ep["launches_ep"]["K3"],
              launches_ep_twin=ep["launches_ep_twin"]["K3"],
              launches_ep_run=ep_run, ep_case=ep_cases["K3"],
              launches_plan=plan["launches_plan"]["K3"],
              launches_plan_run=plan["launches_plan_run"],
              partial_bytes=bwd["K3"]["partial_bytes"],
              passes_ms=bwd["K3"]["passes_ms"]),
        entry("K3 f32", "dtf_tpu_torch/csrc/flash_bwd_x3.cuh",
              "dtf_tpu/ops/flash_attention.py:367", bwd["K3 float32"],
              fused32["K3"], f32_run,
              partial_bytes=bwd["K3 float32"]["partial_bytes"],
              passes_ms=bwd["K3 float32"]["passes_ms"],
              step_ms_f32=train32["step_ms"]),
        entry("K4", "dtf_tpu_torch/csrc/paged_decode.cu",
              "dtf_tpu/ops/paged_attention.py:170",
              k4_case("bfloat16", "decode"), serve_launches["K4"],
              "serve (phase 4)",
              launches_recovery_serve=rec["serve"]["launches"]["K4"],
              launches_recovery_serve_run=rec_serve_run,
              launches_per_serve_call={c: n["K4"]
                                       for c, n in per_call.items()},
              launches_prefix={a: n["K4"]
                               for a, n in launches_prefix.items()},
              launches_prefix_run=prefix_run,
              launches_fleet={a: n["K4"]
                              for a, n in fleet["launches"].items()},
              launches_fleet_run=fleet_run_name,
              launches_ha=ha_roll["launches_ha"]["K4"],
              launches_ha_run=ha_run,
              launches_rollout=ha_roll["launches_rollout"]["K4"],
              launches_rollout_run=rollout_run,
              launches_tp=tp["launches_tp"]["K4"], launches_tp_run=tp_run,
              tp_case=tp_cases["K4"],
              keys_per_split=k4[0]["keys_per_split"],
              chunk_case=k4_brief(k4_case("bfloat16", "chunk@1984")),
              f32_decode_case=k4_brief(k4_case("float32", "decode")),
              launches_plan_serve=plan["launches_plan_serve"]["K4"],
              launches_plan_serve_run=plan["launches_plan_serve_run"],
              passes_ms_per_call=decode_profile["k4_passes_ms_per_call"],
              decode_step_share=decode_profile["k4_share_of_busy"])]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
